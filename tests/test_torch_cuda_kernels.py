"""The hand-written trajectory kernels against their plain PyTorch versions
on a CUDA device: kernels 1 and 1g (quads, unguarded and guarded) and 1K
and 1Kg (kagome, unguarded and guarded), each also with external loads
(1L; float64 within 1e-12 there, as ``chip_smoke.py`` holds it). Marked
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
through the adjoint's graph replay equal an eager replay's.
"""

import numpy as np
import pytest
import torch

from difflexmm_tpu_torch import kernel_checks as kc
from difflexmm_tpu_torch.models.flagship import build_flagship
from difflexmm_tpu_torch.models.kagome_config import build_kagome
from difflexmm_tpu_torch.ops.kernels import core, launch, verlet_kagome
from difflexmm_tpu_torch.ops.kernels.verlet_grid import carry_bytes, verlet_quad_trajectory
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
