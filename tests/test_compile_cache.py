"""Where the persistent compilation cache lives: JAX_COMPILATION_CACHE_DIR
when it is set, else a fixed directory inside the checkout."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is None:
        expected = os.path.join(REPO, ".jax_cache")
    else:
        expected = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = expected
    code = ("import jax, proxmin_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == expected
