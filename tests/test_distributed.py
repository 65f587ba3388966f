"""Multi-process bring-up (proxmin_tpu.parallel.initialize_distributed)
and the driver-facing multi-chip dryrun entry.

The 2-process test is REAL multi-process JAX: two subprocesses form a
distributed group over a localhost coordinator (CPU backend, one device
each), build a global 2-device mesh, run a global psum, a sharded PGM-NMF
training step (pixel-sharded Y/S, replicated A, psum'd grad_A), and
the WHOLE-SOLVE explicit-collective path (nmf_pgm_sharded) checked
against a process-local single-device solve of the reconstructed
global problem — the single-host stand-in for a multi-host job's
per-host bring-up.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_initialize_distributed_single_process_idempotent():
    """No-arg call in an unconfigured environment: single-process
    fallback, callable repeatedly. Run in a subprocess so the
    distributed client (if any) cannot leak into other tests."""
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');\n"
        "from proxmin_tpu.parallel import initialize_distributed\n"
        "a = initialize_distributed(); b = initialize_distributed()\n"
        "assert a == b and a.process_count >= 1, (a, b)\n"
        "print('ok')\n"
    )
    env = dict(os.environ,
               PYTHONPATH="/root/repo:" + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], env=env, timeout=120,
                       capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    assert b"ok" in r.stdout


def test_two_process_group_psum_and_sharded_nmf_step(tmp_path):
    """Two processes -> one global mesh -> collective psum, a sharded
    NMF training step with identical loss on every process, the
    whole-solve path vs a local oracle, and a collective orbax
    checkpoint of the sharded state restored + resumed bit-exactly
    (one bring-up covers all phases; a second full 2-process
    bring-up would double the slowest test for no extra coverage)."""
    worker = os.path.join(os.path.dirname(__file__), "_mp_worker.py")
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ,
               PYTHONPATH="/root/repo:" + os.environ.get("PYTHONPATH", ""))
    # the workers must see exactly one CPU device each (the virtual
    # 8-device flag of this test process would break process-local
    # device accounting)
    env["XLA_FLAGS"] = ""
    procs = [
        subprocess.Popen(
            [sys.executable, worker, addr, "2", str(i), str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i}:\n{out[-1200:]}"
        assert "global sum 12.0 OK" in out
        assert "sharded NMF step" in out
        assert "multi-process orbax checkpoint resume exact OK" in out
    # both processes computed the identical global loss
    l0 = [ln for ln in outs[0].splitlines() if "loss" in ln][0].split()[-2]
    l1 = [ln for ln in outs[1].splitlines() if "loss" in ln][0].split()[-2]
    assert l0 == l1


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_dryrun_multichip_device_counts(n):
    """__graft_entry__.dryrun_multichip handles odd, small and full
    device counts on the virtual 8-device CPU mesh (2-D data x model
    when even and >= 4, 1-D otherwise)."""
    sys.path.insert(0, "/root/repo")
    try:
        import __graft_entry__ as ge
    finally:
        sys.path.pop(0)
    ge.dryrun_multichip(n)


def test_initialize_distributed_reraises_configured_failures(monkeypatch):
    """A bring-up FAILURE on a configured cluster must re-raise — only
    the benign 'nothing configured' case falls back to single-process
    (review finding: swallowing it silently degrades multi-host jobs to
    per-host solves)."""
    import jax
    from proxmin_tpu.parallel import initialize_distributed

    def boom(**kw):
        raise RuntimeError("barrier timed out: coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="unreachable"):
        initialize_distributed()   # env-configured failure, no kwargs
    with pytest.raises(RuntimeError, match="unreachable"):
        initialize_distributed(coordinator_address="10.0.0.1:1234",
                               num_processes=2, process_id=0)

    def not_configured(**kw):
        raise ValueError("coordinator_address should be defined.")

    monkeypatch.setattr(jax.distributed, "initialize", not_configured)
    info = initialize_distributed()    # benign: single-process fallback
    assert info.process_count >= 1
