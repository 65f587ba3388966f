"""CI gate for the engine-equivalence contract.

``engine='auto'`` promises: same tolerance => same converged quality,
possibly a different path (the reference's fixed-point stopping rule,
``proxmin/algorithms.py:130-133``). The device-scale study lives in
``benchmarks/engine_equivalence.py``; this test enforces the same ACCEPTANCE bound at CPU scale — real engines,
interpret-mode kernels — on every CI run, so an engine change that
shifts converged quality or iterations-to-tolerance beyond the bound
fails loudly.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "benchmarks"))

from engine_equivalence import (  # noqa: E402
    ACCEPTANCE,
    CPU_CONFIGS,
    check_equivalence,
    run_config,
    summarize,
)

SEEDS = 10


@pytest.mark.parametrize("name", sorted(CPU_CONFIGS))
def test_engines_equivalent_at_convergence(name):
    cfg = CPU_CONFIGS[name]
    rows = run_config(name, cfg, SEEDS, log=lambda *a: None)
    stats = {eng: summarize(r) for eng, r in rows.items()}
    # the study configs are chosen to converge: the bound is about
    # quality parity, so first assert the baseline actually converges
    assert stats["xla"]["conv_rate"] >= 0.9, stats["xla"]
    verdicts = check_equivalence(stats, "xla", ACCEPTANCE)
    bad = {e: v for e, v in verdicts.items() if not v["ok"]}
    assert not bad, (
        f"engine(s) {sorted(bad)} violate the equivalence bound vs xla "
        f"on config {name}: {bad}; stats={stats}"
    )
