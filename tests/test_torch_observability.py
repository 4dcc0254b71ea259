"""The port's tracing, metrics and checkpoint/resume
(``utils/observability.py`` and the runner's ``metrics_logger``,
``checkpoint`` and ``resume``) against the JAX package, on the CPU at
float64.

The checkpointed MMA runs on the 6 x 6 problem of
``models/small_configs.py``; JAX's history of the same run is recorded in
``tests/data/optimizer_small.npz`` by ``tests/jax_optimizer_references.py``
(the slow ``test_optimizer_references_match_jax`` makes it again).
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difflexmm_tpu.utils import observability as jax_observability
from jax_references import record_or_check, stored

from difflexmm_tpu_torch.models import small_configs as sc
from difflexmm_tpu_torch.models.flagship import design_stats
from difflexmm_tpu_torch.utils.observability import (
    MetricsLogger,
    OptimizationCheckpoint,
    trace,
)

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

# Guarded MMA histories at 6 x 6: each iteration a guarded trajectory and
# its adjoint (1e-10 and 1e-9 of their scales against JAX), and the MMA
# step bounded by the move limit, as tests/test_torch_mma.py's 8 x 6 run.
HISTORY_TOL = 1e-10
GROUPS = ("angles", "edge_lengths")


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def test_metrics_logger_writes_jax_keys(tmp_path):
    ours, theirs = MetricsLogger(tmp_path / "a" / "m.jsonl"), \
        jax_observability.MetricsLogger(tmp_path / "b" / "m.jsonl")
    for logger, lib in ((ours, torch), (theirs, jnp)):
        logger.log(1, objective=lib.asarray(1.5), grad_norm=0.1)
        logger.log(2, objective=2.5, note="hello")
    mine, jax_records = ours.read(), theirs.read()
    assert [sorted(r) for r in mine] == [sorted(r) for r in jax_records]
    for a, b in zip(mine, jax_records):
        assert {k: v for k, v in a.items() if k not in ("time", "seconds_since_last")} == \
            {k: v for k, v in b.items() if k not in ("time", "seconds_since_last")}
    assert mine[0]["objective"] == 1.5 and mine[1]["note"] == "hello"


def test_trace_prints_and_writes_a_chrome_trace(tmp_path, capsys):
    with trace("phase"):
        torch.arange(10.0).sum()
    assert "[trace] phase:" in capsys.readouterr().out
    with trace("fwd + grad", trace_dir=tmp_path / "traces"):
        x = torch.linspace(0.0, 1.0, 64, requires_grad=True)
        torch.autograd.grad(torch.sin(x).sum(), x)
    assert "[trace] fwd + grad:" in capsys.readouterr().out
    (path,) = (tmp_path / "traces").glob("*.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("sin" in str(e.get("name", "")) for e in events)


def test_checkpoint_saves_detached_copies_and_restores(tmp_path):
    ckpt = OptimizationCheckpoint(tmp_path / "run.ckpt", every=2)
    design = (torch.arange(3.0, requires_grad=True),)
    assert not ckpt.save(1, design) and not ckpt.exists()  # not due
    assert ckpt.save(2, design, objective_values=[1.0, 2.0], design_values=[design])
    with torch.no_grad():
        design[0].add_(10.0)  # the snapshot holds a copy
    snapshot = ckpt.restore(device="cpu")
    assert snapshot["iteration"] == 2 and snapshot["objective_values"] == [1.0, 2.0]
    assert torch.equal(snapshot["design"][0], torch.arange(3.0))
    assert torch.equal(snapshot["design_values"][0][0], torch.arange(3.0))
    assert ckpt.save(3, design, force=True)
    assert OptimizationCheckpoint(tmp_path / "none.ckpt").restore(device="cpu") is None


def _flat(design):
    return np.concatenate([x.detach().cpu().numpy().reshape(-1) for x in design])


def test_checkpoint_resume_matches_jax(tmp_path):
    # Two iterations with a logger and a snapshot every iteration, then a
    # fresh problem resumes for one more from the snapshot's design with a
    # fresh MMA state (JAX's semantics: not the uninterrupted run).
    ref = stored("optimizer_small")
    ckpt = OptimizationCheckpoint(tmp_path / "opt.ckpt", every=1)
    logger = MetricsLogger(tmp_path / "opt.jsonl")
    first, design = sc.checkpoint_problem(device="cpu")
    first.run_optimization_mma(design, n_iterations=sc.CHECKPOINT_ITERATIONS[0],
                               metrics_logger=logger, checkpoint=ckpt, **sc.CHECKPOINT_MMA)
    assert rel(first.objective_values, ref["ckpt_first_values"]) <= HISTORY_TOL
    records = logger.read()
    assert [r["step"] for r in records] == ref["ckpt_logged_steps"].tolist() == [1, 2]
    assert rel([r["objective"] for r in records], ref["ckpt_logged_objectives"]) <= HISTORY_TOL
    assert np.allclose([r["constraint_violation"] for r in records],
                       ref["ckpt_logged_violations"], rtol=HISTORY_TOL, atol=1e-15)
    assert ckpt.restore(device="cpu")["iteration"] == 2

    second, design = sc.checkpoint_problem(device="cpu")
    final = second.run_optimization_mma(design, n_iterations=sc.CHECKPOINT_ITERATIONS[1],
                                        checkpoint=ckpt, resume=True, **sc.CHECKPOINT_MMA)
    n = len(ref["ckpt_values"])
    assert len(second.objective_values) == len(second.design_values) == n == 3
    assert rel(second.objective_values, ref["ckpt_values"]) <= HISTORY_TOL
    for k, d in enumerate(second.design_values):
        assert all(x.dtype == torch.float64 and x.device.type == "cpu" for x in d)
        for i, x in enumerate(d):
            assert rel(x.numpy(), ref[f"ckpt_design{k}_{i}"]) <= HISTORY_TOL
    for name in GROUPS:
        got = second.constraints_violation[name]
        assert len(got) == n
        assert np.allclose(got, ref[f"ckpt_violation_{name}"], rtol=HISTORY_TOL, atol=1e-15)
    for i, x in enumerate(final):
        assert rel(x.numpy(), ref[f"ckpt_final_{i}"]) <= HISTORY_TOL


def test_checkpoint_constants_match_the_record():
    # main path 13 of chip_smoke.py holds the card's run against these.
    ref = stored("optimizer_small")
    assert sc.JAX_F64_CHECKPOINT_VALUES == tuple(float(v) for v in ref["ckpt_values"])
    start = [ref["ckpt_design0_0"], ref["ckpt_design0_1"]]
    for k, stats in enumerate(sc.JAX_F64_CHECKPOINT_DESIGN_STATS):
        got = design_stats([ref[f"ckpt_design{k}_0"], ref[f"ckpt_design{k}_1"]], start)
        assert got == pytest.approx(stats, rel=1e-14, abs=1e-14)
    for name in GROUPS:
        assert sc.JAX_F64_CHECKPOINT_VIOLATIONS[name] == tuple(
            float(v) for v in ref[f"ckpt_violation_{name}"])


def test_max_seconds_expiry_forces_a_snapshot_and_resume_stays_aligned(tmp_path):
    # The objective sleeps longer than the budget, so the run stops after
    # its first iteration; the snapshot is not due (every=1000), so only
    # the forced one can explain it. Unguarded, to keep the test short.
    ckpt = OptimizationCheckpoint(tmp_path / "opt.ckpt", every=1000)
    settings = dict(sc.CHECKPOINT_MMA, guard=None)
    first, design = sc.checkpoint_problem(device="cpu")
    objective = first.objective_fn

    def slow(d):
        time.sleep(0.4)
        return objective(d)

    first.objective_fn = slow
    first.run_optimization_mma(design, n_iterations=10_000, max_seconds=0.2, checkpoint=ckpt,
                               **settings)
    n_done = len(first.objective_values)
    assert n_done == 1 and ckpt.exists()
    assert ckpt.restore(device="cpu")["iteration"] == n_done

    second, design = sc.checkpoint_problem(device="cpu")
    second.run_optimization_mma(design, n_iterations=1, checkpoint=ckpt, resume=True,
                                **settings)
    assert len(second.objective_values) == len(second.design_values) == n_done + 1
    for name in GROUPS:
        assert len(second.constraints_violation[name]) == n_done + 1, name
    assert second.objective_values[0] == first.objective_values[0]


@pytest.mark.slow
def test_optimizer_references_match_jax():
    """Make ``tests/data/optimizer_small.npz`` again with the JAX package
    (several minutes)."""

    import jax_optimizer_references as refs

    record_or_check("optimizer_small", refs.optimizer_small())
    constants = refs.checkpoint_constants(stored("optimizer_small"))
    assert constants["JAX_F64_CHECKPOINT_VALUES"] == sc.JAX_F64_CHECKPOINT_VALUES
