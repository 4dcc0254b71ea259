"""The PyTorch port's modules against the JAX package, module by module,
on the CPU at float64 (the trajectory kernel's plain version included).

Inputs are made with numpy from a seed and handed to both packages.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difflexmm_tpu.geometry.quad import QuadGeometry as JaxQuadGeometry
from difflexmm_tpu.geometry.polygon import compute_inertia as jax_compute_inertia
from difflexmm_tpu.ops.contact import contact_energy as jax_contact_energy
from difflexmm_tpu.ops.pallas.verlet_grid import (
    quad_grid_energy_planes as jax_quad_grid_energy_planes,
)
from difflexmm_tpu_torch import kernel_checks as kc
from difflexmm_tpu_torch.geometry.polygon import compute_inertia
from difflexmm_tpu_torch.geometry.quad import QuadGeometry
from difflexmm_tpu_torch.models.flagship import paper_config
from difflexmm_tpu_torch.models.quads_focusing import ForwardProblem
from difflexmm_tpu_torch.ops.contact import contact_energy
from difflexmm_tpu_torch.ops.kernels import core
from difflexmm_tpu_torch.ops.kernels.verlet_grid import (
    quad_grid_energy_planes,
    verlet_quad_trajectory,
)
from difflexmm_tpu_torch.solver import setup_dynamic_solver

# One intra-op thread: the suite runs in several worker processes at once,
# and the port's many small tensor operations slow down several times over
# when each worker also runs a thread per core.
torch.set_num_threads(1)

# Same operations in the same order at float64: only the last bits of
# library functions (sin, cos, atan2, sqrt) and of summation order differ.
TIGHT = 1e-12
# Force with the contact barrier engaged, relative to the force scale: the
# block rotations there feel ligament forces of ~1e4 and barrier forces of
# ~0.5 at once, and the two packages' results differ by 4.5e-12 (measured
# at this state; central differences cannot tell which is closer).
CONTACT_FORCE = 1e-11


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _random_design(n1, n2, seed):
    geo = JaxQuadGeometry(n1, n2, 15.0, 2.25)
    rng = np.random.default_rng(seed)
    base = geo.get_design_from_rotated_square(25 * math.pi / 180)
    return [np.asarray(x) + 0.05 * rng.standard_normal(x.shape) for x in base]


def test_geometry_and_design_gradient_match_jax():
    n1, n2 = 8, 6
    design = _random_design(n1, n2, seed=0)
    rng = np.random.default_rng(1)
    jbc, jcnv, jbonds, jref = JaxQuadGeometry(n1, n2, 15.0, 2.25).get_parametrization()
    tbc, tcnv, tbonds, tref = QuadGeometry(n1, n2, 15.0, 2.25).get_parametrization()
    density = 6.18e-9

    def jax_outputs(h, v):
        cnv = jcnv(h, v)
        return jbc(h, v), cnv, jax_compute_inertia(cnv, density)

    def torch_outputs(h, v):
        cnv = tcnv(h, v)
        return tbc(h, v), cnv, compute_inertia(cnv, density)

    jd = tuple(jnp.asarray(x) for x in design)
    j_out, j_vjp = jax.vjp(jax_outputs, *jd)
    td = tuple(torch.tensor(x, requires_grad=True) for x in design)
    t_out = torch_outputs(*td)
    for a, b in zip(t_out, j_out):
        assert rel(a.detach(), b) <= TIGHT
    cot = [rng.standard_normal(np.shape(x)) for x in j_out]
    j_grads = j_vjp(tuple(jnp.asarray(c) for c in cot))
    t_grads = torch.autograd.grad(t_out, td, [torch.tensor(c) for c in cot])
    for a, b in zip(t_grads, j_grads):
        assert rel(a, b) <= TIGHT
    np.testing.assert_array_equal(tbonds(), np.asarray(jbonds()))
    assert rel(tref(), jref()) == 0.0


def test_rotated_square_design_matches_jax():
    j = JaxQuadGeometry(6, 5, 15.0, 2.25).get_design_from_rotated_square(0.3)
    t = QuadGeometry(6, 5, 15.0, 2.25).get_design_from_rotated_square(0.3)
    for a, b in zip(t, j):
        assert rel(a, b) <= TIGHT


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_contact_energy_and_clamp_match_jax(dtype):
    cmin, ccut, kc_ = -15 * math.pi / 180, -10 * math.pi / 180, 1.5
    span = ccut - cmin
    eps = np.finfo(dtype).eps
    # Across the window, at its edges and inside the 64-eps clamp margin.
    phi = np.concatenate([
        np.linspace(cmin - 0.05, ccut + 0.05, 101),
        [cmin, ccut, cmin + 8 * eps * span, cmin + 128 * eps * span],
    ]).astype(dtype)
    j = jax.vmap(jax.grad(lambda p: jax_contact_energy(p, cmin, ccut, kc_)))(phi)
    jv = jax_contact_energy(jnp.asarray(phi), cmin, ccut, kc_)
    t = torch.tensor(phi, requires_grad=True)
    tv = contact_energy(t, cmin, ccut, kc_)
    (tg,) = torch.autograd.grad(tv.sum(), t)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert np.all(np.isfinite(tg.numpy()))
    assert rel(tv.detach(), jv) <= tol
    assert rel(tg, j) <= tol


def _plane_inputs(contact: bool, seed: int = 0):
    """Fixed leaves (unbatched numpy) and an effective state U of the
    small flagship-physics lattice: a random state on a random design, or
    the contact probe's engaged state with a small random perturbation."""

    rng = np.random.default_rng(seed)
    if contact:
        args, _ = kc.contact_probe(device="cpu")
        U = args.U0 * args.fixed[-1] + core.drive_planes(args.drive[:, 0], args.spec, args.U0)
        U = U[0].numpy() + rng.normal(0, [[[0.01]], [[0.01]], [[0.002]]], size=(3, 6, 8))
    else:
        problem = kc.small_problem(device="cpu")
        args = kc.batched_args(problem, [kc.random_design(problem, rng)])
        U = rng.normal(0, [[[0.3]], [[0.3]], [[0.05]]], size=(3, 6, 8))
    fixed = [x[0].numpy() for x in args.fixed[:10]]
    fixed += [float(x.reshape(())) for x in args.fixed[10:13]]
    return U, fixed


@pytest.mark.parametrize("contact", [False, True], ids=["strain", "contact_engaged"])
@pytest.mark.parametrize("linearized", [False, True])
def test_plane_energy_and_force_match_jax(contact, linearized):
    U, fixed = _plane_inputs(contact)
    jfixed = [jnp.asarray(x) for x in fixed]

    def jax_energy(u):
        return jax_quad_grid_energy_planes(u, *jfixed, linearized=linearized)

    jv, jg = jax.value_and_grad(jax_energy)(jnp.asarray(U))
    tU = torch.tensor(U, requires_grad=True)
    tfixed = [torch.as_tensor(x) for x in fixed]
    tv = quad_grid_energy_planes(tU, *tfixed, linearized=linearized)
    (tg,) = torch.autograd.grad(tv, tU)
    if contact:
        full = jax_energy(jnp.asarray(U))
        strain = jax_quad_grid_energy_planes(jnp.asarray(U), *jfixed, use_contact=False,
                                             linearized=linearized)
        assert float(full - strain) > 0  # the barrier is engaged
    assert abs(float(tv.detach()) - float(jv)) <= TIGHT * abs(float(jv))
    assert rel(tg, jg) <= (CONTACT_FORCE if contact else TIGHT)


def test_stored_state_adjoint_matches_autograd_through_plain_loop():
    problem = kc.small_problem(n_timepoints=6, n_substeps=3, device="cpu")
    rng = np.random.default_rng(3)
    args = kc.batched_args(problem, [kc.random_design(problem, rng) for _ in range(2)])
    spec = args.spec
    leaves = [args.U0, args.V0, args.A0, args.drive, args.fixed[0], args.fixed[13]]
    cots = [torch.as_tensor(rng.standard_normal((2, 5, 3, 6, 8))) for _ in range(3)]

    def inputs():
        return [x.detach().clone().requires_grad_() for x in leaves]

    def fixed_of(x):
        return (x[4],) + args.fixed[1:13] + (x[5],) + args.fixed[14:]

    x = inputs()
    outs = core.VerletTrajectory.apply(spec, x[0], x[1], x[2], args.dts, x[3], *fixed_of(x))
    loss = sum(torch.sum(o * c) for o, c in zip(outs, cots))
    grads_adjoint = torch.autograd.grad(loss, x)

    y = inputs()
    carry, boundary = (y[0], y[1], y[2]), []
    n_sub = spec.n_substeps
    for k in range(args.dts.shape[0]):
        rows = y[3][:, k * n_sub:(k + 1) * n_sub]
        carry = core.interval_body(*carry, args.dts[k], rows, fixed_of(y), spec,
                                   create_graph=True)
        boundary.append(carry)
    plain = [torch.stack(s, dim=1) for s in zip(*boundary)]
    for a, b in zip(outs, plain):
        assert rel(a.detach(), b.detach()) <= TIGHT
    loss = sum(torch.sum(o * c) for o, c in zip(plain, cots))
    grads_plain = torch.autograd.grad(loss, y)
    for a, b in zip(grads_adjoint, grads_plain):
        assert rel(a, b) <= 1e-10


def test_kernel_wrapper_runs_plain_body_only_for_cpu_tensors():
    problem = kc.small_problem(n_timepoints=3, n_substeps=2, device="cpu")
    args = kc.batched_args(problem, [problem.geometry.get_design_from_rotated_square(0.4)])
    calls = core.plain_trajectory.calls
    outs = core.trajectory_forward(args)
    assert core.plain_trajectory.calls == calls + 1
    assert outs[0].shape == (1, 2, 3, 6, 8)
    # A tensor that is neither on the CPU nor on a CUDA device is refused:
    # the wrapper never falls back to the plain body.
    meta = [x.to("meta") for x in (args.U0, args.V0, args.A0, args.dts, args.drive)]
    with pytest.raises(ValueError, match="unsupported device"):
        verlet_quad_trajectory(*meta, tuple(x.to("meta") for x in args.fixed), args.spec,
                               linearized=False, use_contact=True,
                               drive_map=torch.zeros((3, 6, 8), dtype=torch.int32))
    assert core.plain_trajectory.calls == calls + 1


@pytest.mark.parametrize(
    "option, roadmap",
    [
        (dict(method="rk4"), "A12"),
        # The dense "verlet" is ported, but not with a guard.
        (dict(method="verlet", energy_fn=lambda u, cp: u.sum(), guard=dict(window=0.1)), "A4"),
    ],
)
def test_unported_solver_options_raise(option, roadmap):
    kwargs = dict(geometry=QuadGeometry(3, 3), quad_grid=dict(n1=3, n2=3))
    kwargs.update(option)
    with pytest.raises(NotImplementedError, match=roadmap):
        setup_dynamic_solver(**kwargs)


@pytest.mark.parametrize("method", ["auto", "verlet_ckpt"])
def test_solver_takes_a_guard(method):
    # The substep guard is ported: the solver resolves the spec (theta is
    # plane channel 2, translation relative) and hands it to the trajectory
    # with one micro-step drive table per level.
    problem = kc.small_problem(n_timepoints=3, n_substeps=2, device="cpu", method=method,
                               guard=dict(window=0.1, levels=2))
    args = kc.batched_args(problem, [problem.geometry.get_design_from_rotated_square(0.4)])
    guard = args.spec.guard
    assert guard["theta_channels"] == (2,) and guard["translation"] == "relative"
    assert guard["length_scale"] == problem.spacing and guard["levels"] == 2
    assert [m.shape for m in args.micro] == [
        (1, 2 * 2 * 16**level, args.drive.shape[-1]) for level in (1, 2)]
    outs = core.trajectory_forward(args)
    # Flags, the substeps' decisions and the decisions of depth 1's micro-steps.
    assert len(outs) == 5 + args.spec.n_deep == 6 and outs[3].shape == (1, 2)
    assert outs[4].shape == (1, 4) and outs[5].shape == (1, 4 * 16)


def test_model_guard_resolves_to_the_solver_spec():
    problem = ForwardProblem(**{**paper_config(device="cpu"), "guard": "auto"})
    problem.setup()
    args = problem.solve_dynamics.trajectory_args(
        problem.state0, problem.timepoints,
        problem.control_params(problem.geometry.get_design_from_rotated_square(0.4)))
    window = math.radians(5.0)
    guard = args.spec.guard
    assert guard["threshold"] == pytest.approx(0.02 * window)
    assert guard["proximity"] == pytest.approx(2 * window)
    assert guard["hard"] == pytest.approx(0.1 * window)
    assert guard["length_scale"] == 15.0 and guard["refine"] == 16 and guard["levels"] == 1


def test_entry_points_default_to_the_card():
    # With no device named the port asks for CUDA, and without a card it
    # raises instead of running on the CPU.
    assert ForwardProblem(**{k: v for k, v in paper_config().items()
                             if k != "device"}).device == "cuda"
    assert paper_config()["device"] == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            kc.small_problem(n_timepoints=3, n_substeps=2)


@pytest.mark.parametrize("name, by_type", [
    ("verlet_quad", True), ("verlet_kagome", True), ("quad_force", False),
])
def test_build_commands(name, by_type):
    # The trajectory sources compile once per type, at the same time, into
    # objects linked into one library; the force kernel in one nvcc.
    from pathlib import Path

    from difflexmm_tpu_torch.ops.kernels import build

    assert (name in build.BY_TYPE) == by_type
    source, target = build.CSRC_DIR / f"{name}.cu", Path("/out/lib.tmp")
    compiles, link = build.nvcc_commands("nvcc", source, target, by_type)
    for cmd in compiles:
        assert cmd[0] == "nvcc" and cmd[-1] == str(source)
        assert "arch=compute_90a,code=sm_90a" in cmd and "-O3" in cmd
        assert cmd[cmd.index("-I") + 1] == str(build.CSRC_DIR)
    if not by_type:
        assert link is None and len(compiles) == 1
        assert "-shared" in compiles[0] and compiles[0][compiles[0].index("-o") + 1] == str(target)
        return
    types = [next(a for a in cmd if a.startswith("-DVERLET_TYPE=")) for cmd in compiles]
    assert types == ["-DVERLET_TYPE=4", "-DVERLET_TYPE=8"]
    objects = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert all("-c" in cmd and "-shared" not in cmd for cmd in compiles)
    assert len(set(objects)) == 2 and link == ["nvcc", "-shared", "-o", str(target), *objects]


_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118verlet_quad_kernelIfLb0ELb1ELb1ELi512EEEvN6verlet6ParamsIT_Li16EEE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118verlet_quad_kernelIfLb0ELb1ELb1ELi512EEEvN6verlet6ParamsIT_Li16EEE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 1096 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118verlet_quad_kernelIdLb0ELb1ELb1ELi384EEEvN6verlet6ParamsIT_Li16EEE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118verlet_quad_kernelIdLb0ELb1ELb1ELi384EEEvN6verlet6ParamsIT_Li16EEE
    360 bytes stack frame, 542 bytes spill stores, 912 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1096 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118verlet_quad_kernelIdLb1ELb0ELb0ELi256EEEvN6verlet6ParamsIT_Li16EEE' for 'sm_90a'
ptxas info    : Used 96 registers, used 1 barriers, 1096 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115quad_bond_kernelIdLb0ELb1EEEvN6verlet6ParamsIT_Li16EEEPKS2_PS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115quad_bond_kernelIdLb0ELb1EEEvN6verlet6ParamsIT_Li16EEEPKS2_PS2_
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 170 registers, used 0 barriers, 1096 bytes cmem[0]
"""


@pytest.mark.parametrize("name, key, usage", [
    ("verlet_quad", ("float32", 0, 1, 1, 512), (128, 0, 0, 0)),
    ("verlet_quad", ("float64", 0, 1, 1, 384), (168, 360, 542, 912)),
    ("verlet_quad", ("float64", 1, 0, 0, 256), (96, 0, 0, 0)),
    ("quad_bond", ("float64", 0, 1), (170, 8, 4, 4)),
])
def test_ptxas_usage(name, key, usage):
    # Registers, stack frame and spill bytes of each instantiation, read
    # from ptxas' report of the kernel template named; a kernel with no
    # "Function properties" line has no frame.
    from difflexmm_tpu_torch.ops.kernels import build

    used = build.ptxas_usage(_PTXAS_LOG, name)
    assert len(used) == (3 if name == "verlet_quad" else 1)
    assert used[key] == dict(zip(("registers", "stack", "spill_stores", "spill_loads"), usage))


def test_trajectory_bound_has_the_one_sm_floor():
    # One design stays on one SM: its floor is its operations over one SM's
    # share of the peak, 132 times the card's bound at B = 1 (CPU tensors
    # count the H100's 132 SMs), the same for a few designs, and the
    # card's bound once the designs outnumber the SMs. Sixteen substeps an
    # interval keep this small problem bound by its operations (the quad
    # bond's closed form counts fewer than the duals did).
    problem = kc.small_problem(n_timepoints=3, n_substeps=16, device="cpu")
    design = kc.random_design(problem, np.random.default_rng(0))
    args = kc.batched_args(problem, [design])
    outU = core.trajectory_forward(args)[0]
    one = kc.trajectory_bound(args, outU)
    assert one["bound_by"] == "operations"
    assert one["sm_floor_ms"] == pytest.approx(kc.H100_SMS * one["bound_ms"], rel=1e-12)
    for B, floor in ((4, one["sm_floor_ms"]), (2 * kc.H100_SMS, 2 * one["sm_floor_ms"])):
        many = kc.trajectory_bound(kc.batched_args(problem, [design] * B),
                                   outU.expand(B, *outU.shape[1:]))
        assert many["sm_floor_ms"] == pytest.approx(floor, rel=1e-12)
        assert many["sm_floor_ms"] >= many["bound_ms"]
