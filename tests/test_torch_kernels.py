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
    assert len(outs) == 5 and outs[3].shape == (1, 2) and outs[4].shape == (1, 4)


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
