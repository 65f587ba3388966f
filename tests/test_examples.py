"""Smoke tests: ALL eleven shipped examples run end-to-end in CI (toy
sizes, CPU backend / 8-device virtual mesh) and assert their own
quality metrics (analytic optima, Hungarian component matching, RMSE
drop, cross-engine agreement)."""

import runpy
import sys

import pytest


@pytest.fixture
def argv(monkeypatch):
    def set_argv(*args):
        monkeypatch.setattr(sys, "argv", list(args))
    return set_argv


def test_parabola_example(argv, capsys):
    argv("parabola.py")
    runpy.run_path("/root/repo/examples/parabola.py", run_name="__main__")
    out = capsys.readouterr().out
    # every solver line reports its distance to the analytic optimum
    assert "SDMM" in out and "FISTA" in out


def test_tv_denoise_example(argv, capsys):
    argv("tv_denoise.py", "4096")
    runpy.run_path("/root/repo/examples/tv_denoise.py",
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "RMSE" in out   # the script asserts the denoising itself


def test_batched_solves_example(argv, capsys):
    argv("batched_solves.py", "64")
    runpy.run_path("/root/repo/examples/batched_solves.py",
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "64 solves in one call" in out
    assert "match individual solves" in out


def test_learn_regularizer_example(argv, capsys):
    argv("learn_regularizer.py")
    runpy.run_path("/root/repo/examples/learn_regularizer.py",
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "learned wins" in out


def test_unmixing_example(argv, capsys):
    argv("unmixing.py")
    runpy.run_path("/root/repo/examples/unmixing.py", run_name="__main__")
    out = capsys.readouterr().out
    # every solver reports a Hungarian-matched component correlation
    assert out.count("match = 0.9") >= 3   # recovery, not just running


def test_astro_unmixing_example(argv, capsys):
    argv("astro_unmixing.py")
    runpy.run_path("/root/repo/examples/astro_unmixing.py",
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "weighted (W = 1/sky)" in out
    assert out.count("weighted loss") == 5  # 2 PGM + 3 adaprox


def test_image_tv_example(argv, capsys):
    argv("image_tv.py", "64")   # toy size; the script asserts RMSE drop
    runpy.run_path("/root/repo/examples/image_tv.py", run_name="__main__")
    out = capsys.readouterr().out
    assert "RMSE" in out


def test_sharded_unmixing_example(argv, capsys):
    """Three-way agreement (auto-SPMD / explicit shard_map / single
    device) on the 8-device virtual mesh; the script asserts iterate
    agreement at the short horizon and loss agreement at 300 iters."""
    argv("sharded_unmixing.py", "--cpu")
    runpy.run_path("/root/repo/examples/sharded_unmixing.py",
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "all three paths agree" in out


def test_fused_adam_unmixing_example(argv, capsys):
    argv("fused_adam_unmixing.py", "1024")
    runpy.run_path("/root/repo/examples/fused_adam_unmixing.py",
                   run_name="__main__")
    out = capsys.readouterr().out
    # the script asserts its own loss drops; the continuation line
    # proves the M/V warm start improved on the first segment (on the
    # XLA engine here: the fused one compiles for CUDA GPUs only)
    assert "adam on xla" in out and "continued" in out


def test_preemptible_resume_example(argv, capsys):
    """Checkpoint / kill / resume drill on the virtual mesh: every
    preemption lands mid-stride and the script asserts the resumed
    trajectory equals the uninterrupted one exactly."""
    argv("preemptible_resume.py", "40", "17", "--cpu")
    runpy.run_path("/root/repo/examples/preemptible_resume.py",
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "preempted trajectory == uninterrupted trajectory" in out


def test_pod_serving_example(argv, capsys):
    """Export -> serve -> preempt -> artifact resume on the virtual
    mesh; the script asserts bit-exactness vs the live solve itself."""
    argv("pod_serving.py", "--cpu")
    runpy.run_path("/root/repo/examples/pod_serving.py",
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "bit-exact vs live" in out
