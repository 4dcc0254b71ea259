"""The hand-written kernels against their plain PyTorch versions on a CUDA
device: kernels 1 and 1g (quads, unguarded and guarded) and 1K and 1Kg
(kagome, unguarded and guarded), each also with external loads (1L;
float64 within 1e-12 there, as ``chip_smoke.py`` holds it), and kernel 2
(the quad force) with the stepped forward of ``method="verlet_ckpt"``
that launches it. Marked
``cuda``: skipped (with the reason) where there is no CUDA device; on a
machine with one, run
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.

Tolerances as in ``chip_smoke.py``: float64 kernel vs plain body within
1e-9 of the field scale (rounding only), with identical per-substep guard
decisions; at float32 both are held against the float64 plain body on the
same inputs, and the kernel's error may be at most three times the plain
body's (floor 1e-5). Where the guard fires nowhere, the guarded kernel
matches the unguarded one within 1e-12 at float64. A population's launch
equals its designs' single launches bit for bit, and its design gradients
through the adjoint's graph replay equal an eager replay's. The guarded
kernels take another block by the batch (``launch.block_threads``): a
design's outputs, decisions and flags are the same bit for bit in a launch
of 1, 132 or 528 designs, and a NaN stays in its design. So do the
unguarded quad and kagome kernels' blocks (a thread per bond at float32
while the designs do not outnumber the SMs), at B = 1, 128, 132 and 528. Kernel 2 is one launch
over lattice tiles and designs: it matches its plain version on ragged
tiles and keeps a NaN in its design at every tile shape.
"""

import ctypes

import numpy as np
import pytest
import torch

from difflexmm_tpu_torch import kernel_checks as kc
from difflexmm_tpu_torch.models.flagship import build_flagship
from difflexmm_tpu_torch.models import quads_focusing
from difflexmm_tpu_torch.models.kagome_config import build_kagome
from difflexmm_tpu_torch.ops.kernels import build, core, launch, verlet_kagome
from difflexmm_tpu_torch.ops.kernels.verlet_grid import (
    carry_bytes,
    force_tile,
    quad_force,
    quad_grid_force_planes,
    verlet_quad_trajectory,
)
from difflexmm_tpu_torch.ops.kernels.verlet_kagome import verlet_kagome_trajectory

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _plain(args):
    return core.plain_trajectory(*args[1:7], args.spec, args.micro, args.loads)


def _kernel(args):
    counter = launch.counter(args.spec)
    wrapper = verlet_kagome_trajectory if args.U0.shape[1] == 6 else verlet_quad_trajectory
    launches = getattr(wrapper, counter)
    calls = core.plain_trajectory.calls
    outs = core.trajectory_forward(args)
    assert getattr(wrapper, counter) == launches + 1
    assert core.plain_trajectory.calls == calls
    return outs


def _assert_matches(args64, dtype, tol64=1e-9):
    if dtype == torch.float64:
        kernel, plain = _kernel(args64), _plain(args64)
        for k, p in zip(kernel[:3], plain[:3]):
            assert torch.isfinite(k).all()
            assert kc.max_rel_err(k, p) <= tol64
        for k, p in zip(kernel[3:], plain[3:]):  # guarded: flags, decisions
            assert torch.equal(k, p)
        return kernel
    args32 = kc.cast(args64, torch.float32)
    ref = _plain(kc.cast(args32, torch.float64))
    kernel = _kernel(args32)
    for k, p, r in zip(kernel[:3], _plain(args32)[:3], ref[:3]):
        assert torch.isfinite(k).all()
        bound = max(3.0 * kc.max_rel_err(p.double(), r), 1e-5)
        assert kc.max_rel_err(k.double(), r) <= bound
    return kernel


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batch_of_four_designs(device, dtype):
    problem = kc.small_problem(device=device)
    rng = np.random.default_rng(0)
    _assert_matches(kc.batched_args(problem, [kc.random_design(problem, rng) for _ in range(4)]),
                    dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_contact_probe(device, dtype):
    args, _ = kc.contact_probe(device=device)
    U_eff = args.U0 * args.fixed[-1] + core.drive_planes(args.drive[:, 0], args.spec, args.U0)
    assert kc.contact_energy_of(U_eff, args.fixed) > 0
    assert kc.max_rel_err(kc.kernel_force(args), kc.plain_force(args)) <= 1e-12
    _assert_matches(args, dtype)


def test_lattice_beyond_shared_memory(device):
    need, have = carry_bytes(56, 48, torch.float64)
    assert need > have  # the carry lives in the global workspace
    problem = kc.small_problem(n1=56, n2=48, n_timepoints=3, device=device,
                               simulation_time=2.7e-4)
    rng = np.random.default_rng(1)
    _assert_matches(kc.batched_args(problem, [kc.random_design(problem, rng)] * 2),
                    torch.float64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_guarded_contact_probe_fires_both_terms(device, dtype):
    args, _ = kc.contact_probe(device=device, guard="auto")
    _, summary = kc.guard_terms(args)
    assert summary["fired_hard"] > 0 and summary["fired_proximity"] > 0
    _assert_matches(args, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_guarded_batch_decides_per_design(device, dtype):
    # A violent design and a tame one in one launch: each block decides on
    # its own, as the plain body's per-design torch.where does.
    violent = kc.small_problem(device=device, guard="auto")
    rng = np.random.default_rng(2)
    args = kc.batched_args(violent, [kc.random_design(violent, rng) for _ in range(2)])
    tame = kc.batched_args(kc.small_problem(device=device, guard="auto", amplitude_scale=0.01),
                           [kc.random_design(violent, rng)])
    both = core.TrajectoryArgs(
        args.spec, *(torch.cat([getattr(args, f), getattr(tame, f)]) for f in ("U0", "V0", "A0")),
        args.dts, torch.cat([args.drive, tame.drive]),
        tuple(torch.cat([a, b]).contiguous() for a, b in zip(args.fixed, tame.fixed)),
        tuple(torch.cat([a, b]).contiguous() for a, b in zip(args.micro, tame.micro)))
    kernel = _assert_matches(both, dtype)
    if dtype == torch.float64:
        assert kernel[4][:2].any() and not kernel[4][2].any()


def test_guarded_kernel_equals_unguarded_where_nothing_fires(device):
    problem = kc.small_problem(device=device, guard="auto", amplitude_scale=0.01)
    args = kc.batched_args(problem, [kc.random_design(problem, np.random.default_rng(3))])
    guarded = _assert_matches(args, torch.float64)
    assert not guarded[4].any()
    unguarded = _kernel(args._replace(spec=args.spec._replace(guard=None), micro=()))
    for g, u in zip(guarded[:3], unguarded):
        assert kc.max_rel_err(g, u) <= 1e-12


def test_guarded_kernel_refuses_more_than_one_level(device):
    problem = kc.small_problem(n_timepoints=3, device=device, guard=dict(window=0.1, levels=2))
    args = kc.batched_args(problem, [kc.random_design(problem, np.random.default_rng(4))])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        core.trajectory_forward(args)


def test_guarded_objective_runs_the_guarded_kernel(device):
    optimization, design = build_flagship(device=device, guard="auto")
    launches = verlet_quad_trajectory.guarded_launches
    calls = core.plain_trajectory.calls
    d = tuple(x.clone().requires_grad_() for x in design)
    value = optimization.objective_fn(d)
    assert verlet_quad_trajectory.guarded_launches == launches + 1
    assert core.plain_trajectory.calls == calls
    assert torch.isfinite(value)


# ---------------------------------------------------------------------------
# Kagome: kernels 1K and 1Kg
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kagome_batch_of_four_designs(device, dtype):
    problem = kc.small_kagome(device=device)
    rng = np.random.default_rng(0)
    _assert_matches(
        kc.batched_args(problem, [kc.random_kagome_design(problem, rng) for _ in range(4)]), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kagome_contact_probe(device, dtype):
    args, _ = kc.kagome_contact_probe(device=device)
    U_eff = args.U0 * args.fixed[-1] + core.drive_planes(args.drive[:, 0], args.spec, args.U0)
    assert kc.contact_energy_of(U_eff, args.fixed) > 0
    assert kc.max_rel_err(kc.kernel_force(args), kc.plain_force(args)) <= 1e-12
    _assert_matches(args, dtype)


def test_kagome_lattice_beyond_shared_memory(device):
    need, have = verlet_kagome.carry_bytes(30, 28, torch.float64)
    assert need > have  # the carry lives in the global workspace
    problem = kc.small_kagome(n1=30, n2=28, n_timepoints=3, device=device, simulation_time=0.5)
    rng = np.random.default_rng(1)
    _assert_matches(kc.batched_args(problem, [kc.random_kagome_design(problem, rng)] * 2),
                    torch.float64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kagome_guarded_contact_probe_fires_both_terms(device, dtype):
    args, _ = kc.kagome_contact_probe(device=device, guard="auto")
    _, summary = kc.guard_terms(args)
    assert summary["fired_hard"] > 0 and summary["fired_proximity"] > 0
    _assert_matches(args, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kagome_guarded_batch_decides_per_design(device, dtype):
    violent = kc.small_kagome(device=device, guard="auto")
    rng = np.random.default_rng(2)
    args = kc.batched_args(violent, [kc.random_kagome_design(violent, rng) for _ in range(2)])
    tame = kc.batched_args(kc.small_kagome(device=device, guard="auto", amplitude_scale=0.01),
                           [kc.random_kagome_design(violent, rng)])
    both = core.TrajectoryArgs(
        args.spec, *(torch.cat([getattr(args, f), getattr(tame, f)]) for f in ("U0", "V0", "A0")),
        args.dts, torch.cat([args.drive, tame.drive]),
        tuple(torch.cat([a, b]).contiguous() for a, b in zip(args.fixed, tame.fixed)),
        tuple(torch.cat([a, b]).contiguous() for a, b in zip(args.micro, tame.micro)))
    kernel = _assert_matches(both, dtype)
    if dtype == torch.float64:
        assert kernel[4][:2].any() and not kernel[4][2].any()


def test_kagome_guarded_kernel_equals_unguarded_where_nothing_fires(device):
    problem = kc.small_kagome(device=device, guard="auto", amplitude_scale=0.01)
    args = kc.batched_args(problem, [kc.random_kagome_design(problem, np.random.default_rng(3))])
    guarded = _assert_matches(args, torch.float64)
    assert not guarded[4].any()
    unguarded = _kernel(args._replace(spec=args.spec._replace(guard=None), micro=()))
    for g, u in zip(guarded[:3], unguarded):
        assert kc.max_rel_err(g, u) <= 1e-12


def test_kagome_guarded_kernel_refuses_more_than_one_level(device):
    problem = kc.small_kagome(n_timepoints=3, device=device, guard=dict(window=0.1, levels=2))
    args = kc.batched_args(problem, [kc.random_kagome_design(problem,
                                                             np.random.default_rng(4))])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        core.trajectory_forward(args)


def test_kagome_guarded_objective_runs_the_guarded_kernel(device):
    optimization, design = build_kagome(device=device, guard="auto")
    launches = verlet_kagome_trajectory.guarded_launches
    calls = core.plain_trajectory.calls
    d = tuple(x.clone().requires_grad_() for x in design)
    value = optimization.objective_fn(d)
    assert verlet_kagome_trajectory.guarded_launches == launches + 1
    assert core.plain_trajectory.calls == calls
    assert torch.isfinite(value)


# ---------------------------------------------------------------------------
# The adjoint's CUDA-graph replay of an unguarded interval
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lattice", ["quad", "kagome"])
def test_graphed_interval_vjp_equals_the_eager_replay(device, lattice):
    rng = np.random.default_rng(5)
    if lattice == "quad":
        problem = kc.small_problem(device=device)
        args = kc.batched_args(problem, [kc.random_design(problem, rng) for _ in range(2)])
    else:
        problem = kc.small_kagome(device=device)
        args = kc.batched_args(problem, [kc.random_kagome_design(problem, rng)
                                         for _ in range(2)])
    spec, n = args.spec, args.spec.n_substeps
    outU, outV, outA = core.trajectory_forward(args)[:3]
    # The geometry leaves (corners, centroids) take gradients, as in a design
    # gradient; the rest are constants.
    fixed_in = tuple(f.detach().requires_grad_(i < 2) for i, f in enumerate(args.fixed))

    def eager(cin, rows, dt, cot):
        with torch.enable_grad():
            carry = [x.detach().requires_grad_() for x in cin]
            out = core.interval_body(*carry, dt, rows, fixed_in, spec, create_graph=True)
            return torch.autograd.grad(out, carry + list(fixed_in[:2]), cot, allow_unused=True)

    graphed = None
    for k in (5, 2):  # two intervals through one captured graph
        cin = (outU[:, k - 1], outV[:, k - 1], outA[:, k - 1])
        rows, dt = args.drive[:, k * n:(k + 1) * n], args.dts[k]
        cot = tuple(torch.tensor(rng.standard_normal(tuple(x.shape)), device=device)
                    for x in cin)
        if graphed is None:
            graphed = core.GraphedIntervalVJP(spec, cin, rows, dt, fixed_in)
        for g, e in zip(graphed(cin, rows, dt, cot), eager(cin, rows, dt, cot)):
            assert torch.equal(g, e)


# ---------------------------------------------------------------------------
# External loads (1L) in all four instantiations
# ---------------------------------------------------------------------------

# Each case of kc.loaded_cases with its float64 limit (as chip_smoke.py's
# LOAD_CHECKS): 1e-12 for the four instantiations, 1e-9 for the batch of
# stiff 8 x 6 quads.
LOADED = {"loaded contact probe": 1e-12, "loaded contact probe auto": 1e-12,
          "loaded kagome 4x3 tame B=2": 1e-12, "loaded kagome contact probe auto": 1e-12,
          "loaded 8x6 tame B=2": 1e-9}


def _loaded(label, device):
    """One of ``kc.loaded_cases`` and its loaded pairs. Pair (0, 0), a
    clamped corner's DOF, is plane slot 0 on either lattice, and its mask
    is 0 there."""

    args = kc.loaded_cases(device=device)[label]
    assert float(args.fixed[-1].flatten(1)[0, 0]) == 0.0
    return args, [list(p) for p in (kc.KAGOME_LOAD_PAIRS if "kagome" in label
                                    else kc.QUAD_LOAD_PAIRS)]


@pytest.mark.parametrize("label", sorted(LOADED))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_loaded_kernel_matches_plain(device, label, dtype):
    args, pairs = _loaded(label, device)
    kernel = _assert_matches(args, dtype, tol64=LOADED[label])
    if dtype == torch.float64:
        if args.spec.guard is not None:
            assert kernel[4].any()
        # Without the pair on the clamped corner: the same bits.
        keep = [i for i, p in enumerate(pairs) if p != [0, 0]]
        fewer = kc.with_loads(args._replace(loads=()), [pairs[i] for i in keep])
        fewer = fewer._replace(loads=tuple(t[..., keep].contiguous() for t in args.loads))
        for a, b in zip(kernel, _kernel(fewer)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("label", ["loaded 8x6 tame B=2", "loaded kagome 4x3 tame B=2"])
def test_zero_loads_leave_the_kernel_bit_identical(device, label):
    # The load branch adds exactly nothing when every load is zero, so the
    # loaded kernel's outputs equal the unloaded kernel's bit for bit.
    args, _ = _loaded(label, device)
    zero = args._replace(loads=tuple(torch.zeros_like(t) for t in args.loads))
    plain = args._replace(spec=args.spec._replace(load_map=None), loads=())
    for a, b in zip(_kernel(zero), _kernel(plain)):
        assert torch.equal(a, b)


def test_graphed_interval_vjp_with_load_rows_equals_the_eager_replay(device):
    rng = np.random.default_rng(9)
    args, _ = _loaded("loaded 8x6 tame B=2", device)
    spec, n = args.spec, args.spec.n_substeps
    outU, outV, outA = core.trajectory_forward(args)[:3]
    fixed_in = tuple(f.detach().requires_grad_(i < 2) for i, f in enumerate(args.fixed))

    def eager(cin, rows, dt, cot, lrows):
        with torch.enable_grad():
            carry = [x.detach().requires_grad_() for x in cin]
            lr = lrows.detach().requires_grad_()
            out = core.interval_body(*carry, dt, rows, fixed_in, spec, create_graph=True,
                                     load_rows=lr)
            return torch.autograd.grad(out, carry + [lr] + list(fixed_in[:2]), cot,
                                       allow_unused=True)

    graphed = None
    for k in (4, 2):  # two of the five intervals through one captured graph
        cin = (outU[:, k - 1], outV[:, k - 1], outA[:, k - 1])
        rows, dt = args.drive[:, k * n:(k + 1) * n], args.dts[k]
        lrows = args.loads[0][:, k * n:(k + 1) * n]
        cot = tuple(torch.tensor(rng.standard_normal(tuple(x.shape)), device=device)
                    for x in cin)
        if graphed is None:
            graphed = core.GraphedIntervalVJP(spec, cin, rows, dt, fixed_in, lrows,
                                              load_grad=True)
        for g, e in zip(graphed(cin, rows, dt, cot, lrows), eager(cin, rows, dt, cot, lrows)):
            assert torch.equal(g, e)


# ---------------------------------------------------------------------------
# Populations: the design batch on the kernels' grid (the counterparts of
# the TPU's design-tiled kernels)
# ---------------------------------------------------------------------------


def _population(lattice, device, dtype=torch.float64, guard=None, B=4, seed=11):
    """A small problem of ``lattice`` and a population of ``B`` random
    designs (each design tensor with the leading dimension B)."""

    rng = np.random.default_rng(seed)
    if lattice == "quad":
        problem = kc.small_problem(device=device, dtype=dtype, guard=guard)
        designs = [kc.random_design(problem, rng) for _ in range(B)]
    else:
        problem = kc.small_kagome(device=device, dtype=dtype, guard=guard)
        designs = [kc.random_kagome_design(problem, rng) for _ in range(B)]
    return problem, tuple(torch.stack(x) for x in zip(*designs))


@pytest.mark.parametrize("guard", [None, "auto"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lattice", ["quad", "kagome"])
def test_population_launch_equals_single_launches(device, lattice, dtype, guard):
    """One launch of B different designs gives each design's outputs (and,
    guarded, its flags and decisions) bit for bit as its own launch on the
    same inputs: one block per design, nothing shared between blocks."""

    problem, designs = _population(lattice, device, dtype, guard)
    with torch.no_grad():
        args = problem.solve_dynamics.trajectory_args(problem.state0, problem.timepoints,
                                                      problem.control_params(designs))
    batch = _kernel(args)
    B = args.U0.shape[0]
    for b in range(B):
        def one(x, b=b):
            return x[b:b + 1].contiguous()

        single = _kernel(args._replace(
            U0=one(args.U0), V0=one(args.V0), A0=one(args.A0), drive=one(args.drive),
            fixed=tuple(one(f) for f in args.fixed), micro=tuple(one(m) for m in args.micro)))
        for x, y in zip(batch, single):
            assert torch.equal(x[b], y[0])
    if guard is not None:
        assert bool(batch[4].any())  # the guard fired somewhere


@pytest.mark.parametrize("lattice", ["quad", "kagome"])
def test_population_gradient_graph_replay_equals_eager_replay(device, lattice, monkeypatch):
    """The population's design gradients through the adjoint's graph replay
    equal those of an eager replay of every interval, at B = 4."""

    from difflexmm_tpu_torch.models import kagome_focusing, quads_focusing
    from difflexmm_tpu_torch.parallel import population_value_and_grad

    problem, designs = _population(lattice, device)
    module = quads_focusing if lattice == "quad" else kagome_focusing
    optimization = module.OptimizationProblem(problem, target_size=(2, 2))
    optimization.setup_objective()
    captured = []

    class Counting(core.GraphedIntervalVJP):
        def __init__(self, *args, **kwargs):
            captured.append(1)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(core, "GraphedIntervalVJP", Counting)
    values, grads = population_value_and_grad(optimization.population_objective_fn, designs)
    assert captured == [1]  # one graph, replayed for every interval

    class Eager:
        """The interval's vector-Jacobian product, computed eagerly."""

        def __init__(self, spec, carry, rows, dt, fixed_in, load_rows=None, load_grad=False):
            self.spec, self.fixed = spec, fixed_in

        def __call__(self, carry, rows, dt, cot, load_rows=None):
            with torch.enable_grad():
                c = [x.detach().requires_grad_() for x in carry]
                out = core.interval_body(*c, dt, rows, self.fixed, self.spec, create_graph=True)
                inputs = c + [f for f in self.fixed if f.requires_grad]
                return list(torch.autograd.grad(out, inputs, cot, allow_unused=True))

    monkeypatch.setattr(core, "GraphedIntervalVJP", Eager)
    values_e, grads_e = population_value_and_grad(optimization.population_objective_fn, designs)
    assert torch.equal(values, values_e)
    for g, e in zip(grads, grads_e):
        assert torch.isfinite(g).all() and torch.equal(g, e)


# ---------------------------------------------------------------------------
# Kernel 2: the quad force, and the stepped forward of method="verlet_ckpt"
# ---------------------------------------------------------------------------


def _force_case(case, device):
    """``(U_eff, fixed)`` of a force check: the microbenchmark's inputs
    (``kernel_checks.lanes_microbench_inputs``) at B = 1 or 4, the contact
    probe's engaged state, or the 96 x 64 lattice (12,128 bonds)."""

    if case == "contact probe":
        args, _ = kc.contact_probe(device=device)
        U = args.U0 * args.fixed[-1] + core.drive_planes(args.drive[:, 0], args.spec, args.U0)
        assert kc.engaged_bonds(U, args.fixed) > 0
        return U, args.fixed[:13]
    if case == "96x64":
        return kc.lanes_microbench_inputs(B=1, n1=96, n2=64, device=device, dtype=torch.float64)
    return kc.lanes_microbench_inputs(B=int(case[-1]), device=device, dtype=torch.float64)


@pytest.mark.parametrize("linearized", [False, True])
@pytest.mark.parametrize("case", ["microbench B=1", "microbench B=4", "contact probe", "96x64"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_force_kernel_matches_plain(device, dtype, case, linearized):
    """Kernel 2 against its plain version: float64 within 1e-12 of the
    field's largest entry (one energy gradient's rounding); float32 held
    against the float64 plain force, within three times the plain float32
    force's error (floor 1e-5), as chip_smoke.py holds a force."""

    U64, fixed64 = _force_case(case, device)

    def both(U, fixed):
        launches = quad_force.launches
        k = quad_force(U, fixed, linearized=linearized, use_contact=True)
        assert quad_force.launches == launches + 1
        return k, quad_grid_force_planes(U, *fixed, linearized=linearized, use_contact=True)

    if dtype == torch.float64:
        k, p = both(U64, fixed64)
        assert torch.isfinite(k).all() and kc.max_rel_err(k, p) <= 1e-12
        return
    ref = quad_grid_force_planes(U64.float().double(), *(f.float().double() for f in fixed64),
                                 linearized=linearized, use_contact=True)
    k, p = both(U64.float(), tuple(f.float() for f in fixed64))
    bound = max(3.0 * kc.max_rel_err(p.double(), ref), 1e-5)
    assert torch.isfinite(k).all() and kc.max_rel_err(k.double(), ref) <= bound


@pytest.mark.parametrize("case", ["25x17 B=3", "96x64 B=1"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_force_kernel_on_ragged_tiles_matches_plain(device, dtype, case):
    """Kernel 2 where the lattice is no whole number of tiles (25 x 17 at
    B = 3) and on the 96 x 64 lattice at B = 1, which must spread over many
    blocks, against its plain version with the tolerances above."""

    n1, n2, B = {"25x17 B=3": (25, 17, 3), "96x64 B=1": (96, 64, 1)}[case]
    tx, ty, _ = force_tile(n1, n2, B)
    if case.startswith("25"):
        assert n1 % tx and n2 % ty  # ragged both ways
    else:
        assert -(-n1 // tx) * -(-n2 // ty) >= 32  # the design spreads over the card
    U64, fixed64 = kc.lanes_microbench_inputs(B=B, n1=n1, n2=n2, seed=2, device=device,
                                              dtype=torch.float64)
    if dtype == torch.float64:
        k = quad_force(U64, fixed64, linearized=False, use_contact=True)
        p = quad_grid_force_planes(U64, *fixed64)
        assert torch.isfinite(k).all() and kc.max_rel_err(k, p) <= 1e-12
        return
    U, fixed = U64.float(), tuple(f.float() for f in fixed64)
    ref = quad_grid_force_planes(U.double(), *(f.double() for f in fixed))
    bound = max(3.0 * kc.max_rel_err(quad_grid_force_planes(U, *fixed).double(), ref), 1e-5)
    k = quad_force(U, fixed, linearized=False, use_contact=True)
    assert torch.isfinite(k).all() and kc.max_rel_err(k.double(), ref) <= bound


@pytest.mark.parametrize("n1, n2, B", [(25, 17, 3), (24, 16, 300)])
def test_force_kernel_keeps_a_nan_in_its_design_at_every_tile(device, n1, n2, B):
    """A NaN in design 1 reaches only design 1's force, at the small tile
    (few designs, ragged) and at the large one (a batch that fills the
    card): the other designs' forces stay exact."""

    U, fixed = kc.lanes_microbench_inputs(B=B, n1=n1, n2=n2, device=device,
                                          dtype=torch.float64)
    clean = quad_force(U, fixed, linearized=False, use_contact=True)
    U[1, 0, n2 - 1, n1 - 1] = float("nan")
    dirty = quad_force(U, fixed, linearized=False, use_contact=True)
    assert not bool(torch.isfinite(dirty[1]).all())
    others = [b for b in range(B) if b != 1]
    assert torch.equal(dirty[others], clean[others])


def _captured_node_types(fn):
    """The node types (``CUgraphNodeType``; 0 a kernel) of the CUDA graph
    that ``libcuda`` captures from one call of ``fn`` on a side stream."""

    libcuda = ctypes.CDLL("libcuda.so.1")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    handle, graph = ctypes.c_void_p(stream.cuda_stream), ctypes.c_void_p()
    with torch.cuda.stream(stream):
        assert libcuda.cuStreamBeginCapture_v2(handle, 2) == 0  # relaxed capture mode
        try:
            fn()
        finally:
            ended = libcuda.cuStreamEndCapture(handle, ctypes.byref(graph))
    assert ended == 0
    count = ctypes.c_size_t(0)
    assert libcuda.cuGraphGetNodes(graph, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert libcuda.cuGraphGetNodes(graph, nodes, ctypes.byref(count)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int()
        assert libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        types.append(kind.value)
    libcuda.cuGraphDestroy(graph)
    return types


@pytest.mark.parametrize("B", [1, 128])
def test_force_kernel_is_one_launch(device, B):
    """One call of kernel 2, at either tile, is one kernel launch (the
    graph captured from it holds one kernel node and nothing else: no
    second pass, no workspace) and one count on the wrapper."""

    U, fixed = kc.lanes_microbench_inputs(B=B, device=device, dtype=torch.float64)

    def call():
        return quad_force(U, fixed, linearized=False, use_contact=True)

    call()  # build, warm up, and leave the output's block in the allocator's cache
    torch.cuda.synchronize()
    launches = quad_force.launches
    assert _captured_node_types(call) == [0]
    assert quad_force.launches == launches + 1


def test_force_kernel_keeps_a_nan_in_its_design(device):
    U, fixed = kc.lanes_microbench_inputs(B=4, device=device, dtype=torch.float64)
    clean = quad_force(U, fixed, linearized=False, use_contact=True)
    U[1, 2, 5, 7] = float("nan")
    dirty = quad_force(U, fixed, linearized=False, use_contact=True)
    assert not bool(torch.isfinite(dirty[1]).all())
    for b in (0, 2, 3):
        assert torch.equal(dirty[b], clean[b])


# Guard levels = 2 with refine 4 on the violent 8 x 6 problem: micro-steps
# fire at depth 1, so some run at depth 2.
TWO_LEVELS = {"proximity_windows": 2.0, "hard_fraction": 0.1, "levels": 2, "refine": 4}


def _two_levels(device):
    problem = kc.small_problem(n_timepoints=3, device=device, guard=TWO_LEVELS,
                               method="verlet_ckpt")
    return kc.batched_args(problem, [kc.random_design(problem, np.random.default_rng(5))])


def test_stepped_forward_at_two_levels_matches_the_plain_guarded_body(device):
    """``verlet_ckpt`` on the card at guard levels = 2 (kernel 2 a
    (micro-)step) against the plain guarded body on a CPU copy of the same
    inputs: decisions of both depths identical, U, V, A within 1e-10 at
    float64."""

    args = _two_levels(device)
    launches, calls = quad_force.launches, core.plain_trajectory.calls
    stepped = core.trajectory_forward(args)
    assert core.plain_trajectory.calls == calls
    n_steps = stepped[4].numel()
    # Every substep, every micro-step of a fired substep beyond the first,
    # and refine - 1 more for each micro-step of depth 1 that fired.
    fired, deep = int(stepped[4].sum()), int(stepped[5].sum())
    assert deep > 0 and quad_force.launches - launches == n_steps + 3 * fired + 3 * deep
    plain = kc.from_bytes(kc.plain_reference(kc.to_bytes(kc.on_cpu(args))))[0]
    assert len(stepped) == len(plain) == 6
    for s, p in zip(stepped[3:], plain[3:]):
        assert torch.equal(s.cpu(), p)
    for s, p in zip(stepped[:3], plain[:3]):
        assert kc.max_rel_err(s.cpu(), p) <= 1e-10


def test_stepped_gradient_at_two_levels_matches_the_plain_body(device):
    """The card's ``verlet_ckpt`` value and gradient at guard levels = 2
    (the stepped forward, then the adjoint's eager replay of the fired
    intervals with the forward's decisions of both depths) against the
    plain body's on a CPU copy of the same inputs, at float64: the
    gradients with respect to the initial state, the centroid-node vectors
    and the horizontal bonds' stretching stiffness within 1e-9 of their
    scale."""

    args = _two_levels(device)
    rng = np.random.default_rng(7)
    cots = [rng.standard_normal((1, 2) + tuple(args.U0.shape[1:])) for _ in range(3)]

    def value_and_grad(a):
        x = [a.U0.clone().requires_grad_(), a.V0.clone().requires_grad_(),
             a.fixed[0].clone().requires_grad_(), a.fixed[4].clone().requires_grad_()]
        fixed = (x[2],) + a.fixed[1:4] + (x[3],) + a.fixed[5:]
        outs = core.VerletTrajectory.apply(a.spec, x[0], x[1], a.A0, a.dts, a.drive, *a.micro,
                                           *fixed)
        value = sum(torch.sum(o * torch.tensor(c, device=o.device))
                    for o, c in zip(outs[:3], cots))
        grads = torch.autograd.grad(value, x)
        return value.item(), [g.cpu() for g in grads], [d.cpu() for d in outs[4:]]

    calls = core.plain_trajectory.calls
    card = value_and_grad(args)
    assert core.plain_trajectory.calls == calls
    host = value_and_grad(kc.on_cpu(args))
    assert bool(card[2][1].any())  # micro-steps of depth 1 fired
    for c, h in zip(card[2], host[2]):
        assert torch.equal(c, h)
    assert abs(card[0] - host[0]) <= 1e-9 * abs(host[0])
    for c, h in zip(card[1], host[1]):
        assert float(h.abs().max()) > 0 and kc.max_rel_err(c, h) <= 1e-9


def test_verlet_ckpt_objective_runs_the_force_kernel_only(device):
    """The card's ``verlet_ckpt`` value and gradient: one force launch a
    substep in the forward, no plain-body forward (the adjoint replays the
    plain body's intervals, not plain_trajectory)."""

    problem = kc.small_problem(n_timepoints=4, device=device, method="verlet_ckpt")
    optimization = quads_focusing.OptimizationProblem(problem, target_size=(2, 2))
    optimization.setup_objective()
    design = tuple(x.requires_grad_() for x in kc.random_design(problem, np.random.default_rng(6)))
    launches, calls = quad_force.launches, core.plain_trajectory.calls
    value = optimization.objective_fn(design)
    value.backward()
    assert quad_force.launches - launches == 3 * problem.n_substeps
    assert core.plain_trajectory.calls == calls
    assert torch.isfinite(value) and all(torch.isfinite(x.grad).all() for x in design)


# ---------------------------------------------------------------------------
# The guarded kernels' block shapes (1g, 1Kg): one design per block whatever
# the shape launch.block_threads picks by the batch
# ---------------------------------------------------------------------------


def _tiled(args, B):
    """A launch of B designs, design b being design b % B0 of ``args``."""

    def tile(x):
        return x.repeat(B // x.shape[0] + 1, *(1,) * (x.dim() - 1))[:B].contiguous()

    return args._replace(U0=tile(args.U0), V0=tile(args.V0), A0=tile(args.A0),
                         drive=tile(args.drive), fixed=tuple(tile(f) for f in args.fixed),
                         micro=tuple(tile(m) for m in args.micro))


def _guarded_cases(lattice, device, dtype):
    """Four violent small designs, and the configuration's guarded design."""

    rng = np.random.default_rng(13)
    if lattice == "quad":
        small = kc.small_problem(device=device, dtype=dtype, guard="auto")
        designs = [kc.random_design(small, rng) for _ in range(4)]
        config = build_flagship(device=device, dtype=dtype, guard="auto")
    else:
        small = kc.small_kagome(device=device, dtype=dtype, guard="auto")
        designs = [kc.random_kagome_design(small, rng) for _ in range(4)]
        config = build_kagome(device=device, dtype=dtype, guard="auto")
    return (kc.batched_args(small, designs),
            kc.batched_args(config[0].forward_problem, [config[1]]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lattice", ["quad", "kagome"])
def test_guarded_population_of_any_shape_equals_single_launches(device, lattice, dtype):
    """1g and 1Kg: each design of a launch of 132 or 528 designs gives its
    B = 1 launch's outputs, decisions and flags bit for bit, though the
    launches run in blocks of other shapes."""

    prefix = "verlet_quad" if lattice == "quad" else "verlet_kagome"
    lib = launch.type_library(build.load(prefix), prefix)
    shapes = {launch.block_threads(lib, prefix, B, dtype, True) for B in (1, 132, 528)}
    if dtype == torch.float32:
        assert len(shapes) == 2  # the rule changes the block between them
    for args in _guarded_cases(lattice, device, dtype):
        B0 = args.U0.shape[0]
        single = []
        for b in range(B0):
            def one(x, b=b):
                return x[b:b + 1].contiguous()

            single.append(_kernel(args._replace(
                U0=one(args.U0), V0=one(args.V0), A0=one(args.A0), drive=one(args.drive),
                fixed=tuple(one(f) for f in args.fixed),
                micro=tuple(one(m) for m in args.micro))))
        for B in (132, 528):
            batch = _kernel(_tiled(args, B))
            for b in range(B):
                for x, y in zip(batch, single[b % B0]):
                    assert torch.equal(x[b], y[0])
        if B0 > 1:
            assert any(bool(s[4].any()) for s in single)  # the guard fired


def _gap_needed(args):
    """Per substep of the plain guarded body on ``args``: whether its
    predicate needed the gap (travel past the threshold, within the hard
    limit, a gap to read)."""

    trace, guard = [], args.spec.guard
    core.plain_trajectory(*args[1:7], args.spec, args.micro, args.loads, trace=trace)
    travel = torch.stack([t for t, _ in trace], dim=1)[0]
    gap = torch.stack([g for _, g in trace], dim=1)[0]
    return ~(travel <= guard["threshold"]) & (travel <= guard["hard"]) & (gap != float("inf"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lattice", ["quad", "kagome"])
def test_guarded_contact_probe_takes_the_gap_both_ways(device, lattice, dtype):
    """The probes need the gap on runs of substeps: the kernel takes it in
    the travel pass where the substep before needed it too, and in a pass
    of its own where it did not; decisions equal the plain guarded body's
    and U, V, A are within the file's tolerances."""

    probe = kc.contact_probe if lattice == "quad" else kc.kagome_contact_probe
    args, _ = probe(device=device, guard="auto")
    needed = _gap_needed(kc.cast(args, dtype)).cpu()
    assert bool((needed[1:] & needed[:-1]).any())  # taken in the travel pass
    assert bool((needed[1:] & ~needed[:-1]).any()) or bool(needed[0])  # in its own pass
    _assert_matches(args, dtype)


@pytest.mark.parametrize("lattice", ["quad", "kagome"])
def test_guarded_lattice_beyond_shared_memory(device, lattice):
    """1g and 1Kg with the carry on the global workspace (the sizes of the
    unguarded tests above) against the plain guarded body."""

    rng = np.random.default_rng(1)
    if lattice == "quad":
        need, have = carry_bytes(56, 48, torch.float64)
        problem = kc.small_problem(n1=56, n2=48, n_timepoints=3, device=device,
                                   simulation_time=2.7e-4, guard="auto")
        designs = [kc.random_design(problem, rng)] * 2
    else:
        need, have = verlet_kagome.carry_bytes(30, 28, torch.float64)
        problem = kc.small_kagome(n1=30, n2=28, n_timepoints=3, device=device,
                                  simulation_time=0.5, guard="auto")
        designs = [kc.random_kagome_design(problem, rng)] * 2
    assert need > have  # the carry lives in the global workspace
    for dtype in (torch.float64, torch.float32):
        _assert_matches(kc.batched_args(problem, designs), dtype)


@pytest.mark.parametrize("lattice", ["quad", "kagome"])
def test_guarded_nan_stays_in_its_design(device, lattice):
    """A NaN in one design's initial velocity fires its guard's hard term on
    every substep and leaves the other designs' outputs, decisions and
    flags unchanged."""

    args = _guarded_cases(lattice, device, torch.float64)[0]
    clean = _kernel(args)
    V0 = args.V0.clone()
    V0[1, 2, 0, 0] = float("nan")
    dirty = _kernel(args._replace(V0=V0))
    assert bool(dirty[4][1].all())  # NaN travel is past the hard limit
    for x, y in zip(clean, dirty):
        for b in (0, 2, 3):
            assert torch.equal(x[b], y[b])


# ---------------------------------------------------------------------------
# The unguarded kernels' blocks (kernels 1 and 1K and their populations 1T
# and 1K tiled): one design per block whatever the shape
# launch.block_threads picks by the batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_population_of_any_block_equals_single_launches(device, dtype):
    """Kernel 1: each design of a launch of 1, 128, 132 or 528 designs gives
    its B = 1 launch's outputs bit for bit, though the launches beyond the
    SMs run in blocks of another shape (four random 8 x 6 designs with the
    contact barrier, and the flagship's design)."""

    lib = launch.type_library(build.load("verlet_quad"), "verlet_quad")
    shapes = {B: launch.block_threads(lib, "verlet_quad", B, dtype, False)
              for B in (1, 128, 132, 528)}
    assert shapes[1] == shapes[128] == shapes[132] != shapes[528]
    rng = np.random.default_rng(17)
    small = kc.small_problem(device=device, dtype=dtype, amplitude_scale=0.01)
    opt, design = build_flagship(device=device, dtype=dtype)
    cases = (kc.batched_args(small, [kc.random_design(small, rng) for _ in range(4)]),
             kc.batched_args(opt.forward_problem, [design]))
    for args in cases:
        B0 = args.U0.shape[0]
        single = []
        for b in range(B0):
            def one(x, b=b):
                return x[b:b + 1].contiguous()

            single.append(_kernel(args._replace(
                U0=one(args.U0), V0=one(args.V0), A0=one(args.A0), drive=one(args.drive),
                fixed=tuple(one(f) for f in args.fixed))))
        for B in (1, 128, 132, 528):
            batch = _kernel(_tiled(args, B))
            for b in range(B):
                for x, y in zip(batch, single[b % B0]):
                    assert torch.equal(x[b], y[0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kagome_population_of_any_block_equals_single_launches(device, dtype):
    """Kernel 1K: each design of a launch of 1, 128, 132 or 528 designs
    gives its B = 1 launch's outputs bit for bit, though the launches
    beyond the SMs run in blocks of another shape (four random 4 x 3-cell
    designs, the kagome contact probe, and the configuration's design)."""

    lib = launch.type_library(build.load("verlet_kagome"), "verlet_kagome")
    shapes = {B: launch.block_threads(lib, "verlet_kagome", B, dtype, False)
              for B in (1, 128, 132, 528)}
    assert shapes[1] == shapes[128] == shapes[132] != shapes[528]
    rng = np.random.default_rng(19)
    small = kc.small_kagome(device=device, dtype=dtype, amplitude_scale=0.01)
    opt, design = build_kagome(device=device, dtype=dtype)
    cases = (kc.batched_args(small, [kc.random_kagome_design(small, rng) for _ in range(4)]),
             kc.kagome_contact_probe(device=device, dtype=dtype)[0],
             kc.batched_args(opt.forward_problem, [design]))
    for args in cases:
        B0 = args.U0.shape[0]
        single = []
        for b in range(B0):
            def one(x, b=b):
                return x[b:b + 1].contiguous()

            single.append(_kernel(args._replace(
                U0=one(args.U0), V0=one(args.V0), A0=one(args.A0), drive=one(args.drive),
                fixed=tuple(one(f) for f in args.fixed))))
        for B in (1, 128, 132, 528):
            batch = _kernel(_tiled(args, B))
            for b in range(B):
                for x, y in zip(batch, single[b % B0]):
                    assert torch.equal(x[b], y[0])
