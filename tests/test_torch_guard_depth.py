"""Guards deeper than one level, on the CPU at float64.

The guarded kernels (1g, 1Kg and guarded 1L) refine to any depth: at
levels > 1 by an iterative depth-first walk (``guarded_walk`` in
``csrc/verlet_common.cuh``). Its CPU mirror, ``kernel_checks.depth_walk``
(the kernel's order, step sizes, table rows and table writes), is held
bit for bit against the plain guarded body (``core.plain_trajectory``,
``core.guarded_interval_body`` per interval) at levels 1, 2 and 3, refine 4
and 3, on the 8 x 6 quads of ``kernel_checks.small_problem`` and the 4 x 3
kagome cells of ``kernel_checks.small_kagome``: outputs, flags and every
depth's decision table, with the tables' shapes from ``spec.n_deep``; with
loads, and on a batch of two designs that decide differently. The plain
body at levels 3 on the 8 x 6 case is held against the JAX package's
``verlet_ckpt`` trajectory, recorded in ``tests/data/guard_depth.npz`` by
``tests/jax_guard_depth_references.py`` (the slow
``test_guard_depth_references_match_jax`` makes it again), and the
flagship's recorded n = 5 rescue values against the constants the card's
smoke test holds its kernels to.
"""

import functools

import numpy as np
import pytest
import torch

import jax_guard_depth_references as refs
from jax_references import record_or_check, stored

from difflexmm_tpu_torch import kernel_checks as kc
from difflexmm_tpu_torch.models import flagship as fl
from difflexmm_tpu_torch.ops.kernels import core, verlet_grid

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


def _guard(levels, refine):
    return dict(refs.LEVELS3_GUARD, levels=levels, refine=refine)


def _pair(lattice, levels, refine, amplitudes, seed=2):
    """One design of each of ``amplitudes`` (the pulse's scale), stacked on
    the batch dimension."""

    make = kc.small_problem if lattice == "quad" else kc.small_kagome
    draw = kc.random_design if lattice == "quad" else kc.random_kagome_design
    rng = np.random.default_rng(seed)
    parts = []
    for amplitude in amplitudes:
        problem = make(n_timepoints=3, device="cpu", guard=_guard(levels, refine),
                       amplitude_scale=amplitude)
        parts.append(kc.batched_args(problem, [draw(problem, rng)]))
    if len(parts) == 1:
        return parts[0]
    cat = lambda xs: torch.cat(xs).contiguous()  # noqa: E731
    return parts[0]._replace(
        **{k: cat([getattr(p, k) for p in parts]) for k in ("U0", "V0", "A0", "drive")},
        fixed=tuple(cat(list(x)) for x in zip(*(p.fixed for p in parts))),
        micro=tuple(cat(list(x)) for x in zip(*(p.micro for p in parts))))


def _levels3_quad():
    """The 8 x 6 case of ``tests/data/guard_depth.npz``: levels 3, refine 4,
    at the generator's design."""

    problem = kc.small_problem(n_timepoints=refs.LEVELS3_TIMEPOINTS, device="cpu",
                               guard=refs.LEVELS3_GUARD,
                               amplitude_scale=refs.LEVELS3_AMPLITUDE)
    design = tuple(torch.as_tensor(x) for x in refs.levels3_design())
    return problem, kc.batched_args(problem, [design])


#: name -> inputs: (lattice, levels, refine, the designs' pulse scales,
#: loaded). The larger scales fire on most substeps and on part of the
#: micro-steps below them; the 0.03 design of a pair fires less.
CASES = {
    "quad levels 1 refine 4": ("quad", 1, 4, (0.3,), False),
    "quad levels 2 refine 3 loads": ("quad", 2, 3, (0.3,), True),
    "quad levels 3 refine 4": None,  # _levels3_quad
    "quad levels 3 refine 3 B=2": ("quad", 3, 3, (0.3, 0.03), False),
    "kagome levels 1 refine 4": ("kagome", 1, 4, (1.0,), False),
    "kagome levels 2 refine 4 loads": ("kagome", 2, 4, (1.0,), True),
    "kagome levels 3 refine 3": ("kagome", 3, 3, (0.5,), False),
    "kagome levels 2 refine 4 B=2": ("kagome", 2, 4, (0.3, 0.03), False),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(inputs, plain body's outputs) of case ``name``."""

    if CASES[name] is None:
        args = _levels3_quad()[1]
    else:
        lattice, levels, refine, amplitudes, loaded = CASES[name]
        args = _pair(lattice, levels, refine, amplitudes)
        if loaded:
            pairs = kc.QUAD_LOAD_PAIRS if lattice == "quad" else kc.KAGOME_LOAD_PAIRS
            args = kc.with_loads(args, pairs)
    return args, core.plain_trajectory(*args[1:7], args.spec, args.micro, args.loads)


@pytest.mark.parametrize("name", sorted(CASES))
def test_depth_walk_matches_the_plain_guarded_body(name):
    args, plain = _case(name)
    spec = args.spec
    levels, refine = spec.guard["levels"], spec.guard["refine"]
    walk = kc.depth_walk(args)
    B, n_int = args.U0.shape[0], args.dts.shape[0]
    n_steps = n_int * spec.n_substeps
    assert len(walk) == len(plain) == 5 + spec.n_deep and spec.n_deep == levels - 1
    assert tuple(walk[3].shape) == (B, n_int)
    for d, table in enumerate(walk[4:]):
        assert table.dtype == torch.bool and tuple(table.shape) == (B, n_steps * refine ** d)
    for w, p in zip(walk, plain):
        assert torch.equal(w, p)
    decisions = walk[4:]
    # The deepest depth that decides fires somewhere, and not everywhere.
    assert bool(decisions[-1].any()) and not bool(decisions[0].all())
    if B == 2:  # the two designs decide differently
        assert int(decisions[-1][1].sum()) < int(decisions[-1][0].sum())
    if spec.load_map is not None:
        assert len(args.loads) == 1 + levels


def test_plain_body_at_three_levels_matches_jax():
    """The plain body's boundary states on the recorded case against JAX's
    solution fields, at every free DOF (the solver writes the drive's
    values over the driven ones)."""

    args, plain = _case("quad levels 3 refine 4")
    assert args.spec.guard["levels"] == 3 and bool(plain[6].any())  # depth 2 fired
    ref = stored("guard_depth")["levels3_fields"]  # (T, 2, blocks, 3)
    n_blocks = ref.shape[2]
    fields = verlet_grid.fields_from_planes(torch.stack(plain[:2], dim=2), n_blocks)[0]
    free = verlet_grid.fields_from_planes(args.fixed[-1][:, None], n_blocks)[0, 0] > 0
    assert fields.shape == ref[1:].shape and bool(free.any())
    got, want = fields.numpy()[:, :, free], ref[1:][:, :, free]
    assert np.isfinite(got).all()
    assert float(np.max(np.abs(got - want))) <= 1e-12 * float(np.max(np.abs(want)))


def test_trajectory_bound_counts_the_steps_of_every_depth():
    """``kernel_checks.trajectory_bound`` takes the (micro-)steps that ran
    at each depth from the guard summary: every substep, and refine - 1
    more for each step that fired at any depth; and a predicate on each
    micro-step of a depth that decides."""

    args, plain = _case("quad levels 2 refine 3 loads")
    outs, summary = kc.guard_terms(args)
    for o, p in zip(outs, plain):
        assert torch.equal(o, p)
    fired = [int(t.sum()) for t in plain[4:]]
    assert summary["fired_by_depth"] == fired and summary["fired"] == fired[0]
    assert len(summary["gaps_by_depth"]) == 2 and fired[1] > 0
    refine = args.spec.guard["refine"]
    bound = kc.trajectory_bound(args, plain[0], summary)
    assert bound["steps"] == plain[4].numel() + (refine - 1) * sum(fired)
    one_level = dict(summary, fired_by_depth=fired[:1], gaps_by_depth=summary["gaps_by_depth"][:1])
    shallow = kc.trajectory_bound(args, plain[0], one_level)
    assert shallow["steps"] == bound["steps"] - (refine - 1) * fired[1]
    assert shallow["ops"] < bound["ops"] and shallow["bytes"] < bound["bytes"]


def test_rescue_values_are_the_recorded_ones():
    """The flagship's n = 5 rescue values the card's smoke test holds its
    kernels to are the recorded JAX ones."""

    ref = stored("guard_depth")
    assert bool(ref["rescue_n5_plain_is_nan"])
    for name in ("levels1", "levels2"):
        value = float(ref[f"rescue_n5_{name}"])
        assert fl.JAX_F64_RESCUE_N5[name] == value
        assert abs(value - fl.ODEINT_F64_ORACLE) <= 1e-3 * fl.ODEINT_F64_ORACLE
    assert fl.RESCUE_N5_GUARDS == {k: v for k, v in refs.RESCUE_GUARDS.items() if v is not None}


@pytest.mark.slow
def test_guard_depth_references_match_jax():
    record_or_check("guard_depth", refs.guard_depth_references())
