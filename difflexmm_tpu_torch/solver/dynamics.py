"""Dynamic solver (counterpart of ``setup_dynamic_solver`` of
``difflexmm_tpu/solver/dynamics.py``): the quad-grid and kagome-grid fast
paths (``dynamics.py:584-616``, ``:786-868`` and ``:870-964``), with fused
force loading (``:588-632``, ``:740-757``), and the dense velocity-Verlet
``method="verlet"`` (``_integrate_verlet``, ``:177-...``).

The state stays dense, ``(2, n_blocks, 3)`` with a free-DOF mask. Forces on
constrained DOFs are masked, their displacements come from the drive
function, and after the solve the driven DOFs are overwritten with the
drive values and their exact time derivatives (one forward-mode jvp).

A population of designs (the counterpart of the JAX solver under ``vmap``,
``dynamics.py:984-1000``) is one call of the fast path: control parameters
whose geometry carries a leading design dimension B run as one trajectory
of B designs, the batch on the kernel's grid. The JAX package's design
tiling and its crossover routing exist for the TPU's lanes and are not
ported.
"""

from typing import Callable, Optional

import numpy as np
import torch

from difflexmm_tpu_torch.geometry.polygon import compute_inertia
from difflexmm_tpu_torch.ops.assembly import constrain_energy
from difflexmm_tpu_torch.ops.grid import split_grid_bond_data
from difflexmm_tpu_torch.ops.kernels import core, verlet_grid, verlet_kagome
from difflexmm_tpu_torch.ops.kinematics import DOFSet, build_constrained_kinematics
from difflexmm_tpu_torch.ops.loading import build_damping_coefficients, build_loading
from difflexmm_tpu_torch.utils.types import ControlParams, LigamentParams

_EMPTY_PAIRS = np.zeros((0, 2), dtype=np.int64)

#: The methods of the fast path. "verlet_pallas" and "auto" run the
#: hand-written trajectory kernel for CUDA tensors (the plain body for CPU
#: tensors); "verlet_ckpt" steps on the host, one launch of the quad force
#: kernel a (micro-)step for CUDA tensors (kagome: the plain body) and the
#: plain body for CPU tensors, with the same stored-boundary-state adjoint
#: (the JAX package's XLA-forward twin). "auto" without a grid is the dense
#: "verlet", as in JAX.
FAST_METHODS = ("verlet_pallas", "verlet_ckpt", "auto")


def setup_dynamic_solver(
    geometry,
    energy_fn: Optional[Callable] = None,
    loaded_block_DOF_pairs=None,
    loading_fn: Optional[Callable] = None,
    constrained_block_DOF_pairs=_EMPTY_PAIRS,
    constrained_DOFs_fn: Callable = lambda t, **kwargs: 0.0,
    damped_blocks=None,
    method: str = "auto",
    n_substeps: int = 64,
    quad_grid: Optional[dict] = None,
    kagome_grid: Optional[dict] = None,
    guard=None,
):
    """Set up the dynamic solver: the quad-grid or kagome-grid fast path
    (``quad_grid`` / ``kagome_grid``), or the dense ``method="verlet"``.

    Returns ``solve_dynamics(state0, timepoints, control_params)``: an
    initial ``(2, n_blocks, 3)`` state and ``(T,)`` timepoints to the full
    ``(T, 2, n_blocks, 3)`` solution, differentiable with respect to every
    tensor in ``control_params`` and ``state0``. Device and dtype follow
    the centroid-node vectors of ``control_params``. On the fast path a
    population of B designs, whose centroid-node vectors ``(B, n_blocks, V,
    2)`` and block centroids ``(B, n_blocks, 2)`` carry the design
    dimension (``state0`` shared or ``(B, 2, n_blocks, 3)``; every other
    parameter shared), gives ``(B, T, 2, n_blocks, 3)`` from one trajectory
    of B designs (one kernel launch on CUDA tensors). The fast path's
    ``solve_dynamics.specs`` maps each device to the trajectory spec made at
    its first use; setting one there (``spec._replace(forward=...)``) runs
    another forward with the same adjoint.

    ``constrained_DOFs_fn(t, **constraint_params)`` takes a tensor ``t`` of
    any shape and returns values broadcastable to ``t.shape + (k,)`` for
    the k constrained pairs (the JAX version takes scalar times).
    ``loaded_block_DOF_pairs`` with ``loading_fn(state, t,
    **loading_params)``: external forces on those pairs (pairs named twice
    add), evaluated at scalar times ``t`` as in JAX (a scalar or
    ``(n_loaded,)`` result). The fast path calls it with ``state=None``, so
    it must depend on time only there; the dense path passes ``(u, v)``.
    ``energy_fn(block_displacement, control_params)``: the energy of the
    dense path (the fast path has its own plane energy and ignores it).
    ``quad_grid``: dict with n1, n2 (blocks) and optional linearized /
    use_contact. ``kagome_grid``: the same for a kagome lattice, n1 and n2
    counting cells (two triangles each). ``guard``: reactive substep
    escalation, a spec dict as for the JAX solver (``core.resolve_guard``;
    translation "relative" by default; theta is plane channel 2 on quads,
    channels 2 and 5 on kagome). Substeps whose predicted travel is risky
    re-run as ``refine`` micro-steps. CUDA tensors run the guarded kernel
    (one level), or with ``method="verlet_ckpt"`` the stepped guarded body
    (any depth; quads on the force kernel); CPU tensors the plain guarded
    body (any depth).

    Options of the JAX solver that this port does not implement yet raise
    ``NotImplementedError`` naming the ROADMAP item; none is ignored.
    """

    is_kagome = kagome_grid is not None
    grid = kagome_grid if is_kagome else quad_grid
    if method == "auto" and grid is None:
        method = "verlet"
    if method not in FAST_METHODS + ("verlet",):
        raise NotImplementedError(
            f"method={method!r} is not ported yet (ROADMAP A12: 'rk4', 'semi_implicit', "
            f"'odeint'); use 'verlet' or one of {FAST_METHODS}."
        )
    n_blocks = geometry if isinstance(geometry, int) else geometry.n_blocks
    # As in JAX, loads need both the pairs and the function.
    has_loading = loaded_block_DOF_pairs is not None and loading_fn is not None
    load_pairs = (np.asarray(loaded_block_DOF_pairs, dtype=np.int64).reshape(-1, 2)
                  if has_loading else None)
    if method == "verlet":
        return _dense_verlet_solver(
            n_blocks, energy_fn, load_pairs, loading_fn, constrained_block_DOF_pairs,
            constrained_DOFs_fn, damped_blocks, n_substeps, guard,
        )
    if grid is None:
        raise ValueError(
            f"method={method!r} requires quad_grid={{'n1':..., 'n2':...}} or "
            "kagome_grid={'n1':..., 'n2':...}."
        )
    unknown = set(grid) - {"n1", "n2", "linearized", "use_contact"}
    if unknown:
        raise ValueError(f"unknown {'kagome' if is_kagome else 'quad'}_grid keys: "
                         f"{sorted(unknown)}")
    lattice = verlet_kagome if is_kagome else verlet_grid
    guard = core.resolve_guard(guard, theta_channels=(2, 5) if is_kagome else (2,))

    n1, n2 = grid["n1"], grid["n2"]
    if (2 if is_kagome else 1) * n1 * n2 != n_blocks:
        raise ValueError(f"{'kagome' if is_kagome else 'quad'}_grid {n1}x{n2} does not "
                         f"match {n_blocks} blocks")
    linearized = grid.get("linearized", False)
    use_contact = grid.get("use_contact", True)

    dof_set = DOFSet(n_blocks, constrained_block_DOF_pairs)

    # One write per constrained slot; duplicates keep the last pair.
    c_blocks, c_dofs, c_ids = dof_set.last_write_pairs()
    plane_slots = lattice.plane_slots(c_blocks, c_dofs, n1, n2)
    # Every loaded pair keeps its own column: pairs naming one slot add.
    load_slots = (lattice.plane_slots(load_pairs[:, 0], load_pairs[:, 1], n1, n2)
                  if has_loading else None)

    if damped_blocks is not None:
        damping_coeffs = build_damping_coefficients(n_blocks, damped_blocks)
    else:
        def damping_coeffs(damping):
            return damping.new_zeros((n_blocks, 3))

    specs = {}

    def spec_for(device):
        if device not in specs:
            make_spec = (verlet_kagome.kagome_trajectory_spec if is_kagome
                         else verlet_grid.quad_trajectory_spec)
            specs[device] = make_spec(
                n1, n2, n_substeps, plane_slots, c_ids, device,
                linearized=linearized, use_contact=use_contact,
                kernel=method != "verlet_ckpt", guard=guard, load_slots=load_slots,
            )
        return specs[device]

    def contact_scalars(mp, like):
        """(cmin, ccut, kc), each (1, 1); a barrier of zero stiffness where
        contact is off."""

        if use_contact and mp.contact_params is not None:
            values = mp.contact_params
        else:
            values = (0.0, 1.0, 0.0)
        return tuple(torch.as_tensor(x, **like).reshape(1, 1) for x in values)

    def solver_planes(mp, inertia, mask, like):
        """The (inertia, damping, mask) planes."""

        damping = damping_coeffs(torch.as_tensor(mp.damping, **like))
        return tuple(lattice.to_planes(x, n1, n2) for x in (inertia, damping, mask))

    def quad_leaves(control_params: ControlParams, inertia, mask, like):
        """The 16 quad fixed leaves (``verlet_grid.N_FIXED_ARRAYS``)."""

        mp = control_params.mechanical_params
        gp = control_params.geometrical_params
        bp = LigamentParams(*(torch.as_tensor(x, **like) for x in mp.bond_params))
        ref_h, ref_v, ks_h, ks_v, ksh_h, ksh_v, kr_h, kr_v = split_grid_bond_data(bp, n1, n2)

        def ref_planes(ref, shape):
            if ref.ndim == 1:  # one shared (2,) reference vector
                return torch.broadcast_to(ref[:, None, None], (2,) + shape)
            return torch.movedim(ref, -1, 0)

        h, v = (n2, n1 - 1), (n2 - 1, n1)
        return (
            verlet_grid.cnv_to_planes(gp.centroid_node_vectors, n1, n2),
            verlet_grid.to_planes(gp.block_centroids, n1, n2),
            ref_planes(ref_h, h), ref_planes(ref_v, v),
            *(torch.broadcast_to(k, h) for k in (ks_h, ksh_h, kr_h)),
            *(torch.broadcast_to(k, v) for k in (ks_v, ksh_v, kr_v)),
            *contact_scalars(mp, like),
            *solver_planes(mp, inertia, mask, like),
        )

    def kagome_leaves(control_params: ControlParams, inertia, mask, like):
        """The 20 kagome fixed leaves (``verlet_kagome.N_FIXED_ARRAYS``;
        JAX ``_kagome_fixed_core``, the scatter factors replaced by the
        drive map)."""

        mp = control_params.mechanical_params
        gp = control_params.geometrical_params
        bp = LigamentParams(*(torch.as_tensor(x, **like) for x in mp.bond_params))
        shapes = ((n2, n1), (n2 - 1, n1), (n2, n1 - 1))
        families = [verlet_kagome.split_bond_planes(k, n1, n2)
                    for k in (bp.k_stretch, bp.k_shear, bp.k_rot)]
        return (
            verlet_kagome.cnv_to_planes(gp.centroid_node_vectors, n1, n2),
            verlet_kagome.centroids_to_planes(gp.block_centroids, n1, n2),
            *verlet_kagome.split_ref_planes(bp.reference_vector, n1, n2),
            *(torch.broadcast_to(families[k][f], shapes[f]) for f in range(3) for k in range(3)),
            *contact_scalars(mp, like),
            *solver_planes(mp, inertia, mask, like),
        )

    def fixed_leaves(control_params: ControlParams, inertia, mask, like, B):
        """The lattice's fixed leaves, each with the leading design batch B
        (shared leaves broadcast to it), contiguous."""

        leaves = (kagome_leaves if is_kagome else quad_leaves)(control_params, inertia, mask,
                                                               like)
        return tuple(torch.broadcast_to(x, shape).contiguous()
                     for x, shape in zip(leaves, lattice.fixed_shapes(B, n1, n2)))

    def prepare(state0, timepoints, control_params: ControlParams):
        """(trajectory args, masked y0, timepoints, population size or None
        for one design)."""

        mp = control_params.mechanical_params
        cnv = control_params.geometrical_params.centroid_node_vectors
        like = dict(dtype=cnv.dtype, device=cnv.device)
        population = cnv.shape[0] if cnv.dim() == 4 else None
        B = population or 1

        def batched(x):
            """A shared (per-design) tensor on the design batch, contiguous."""

            return torch.broadcast_to(x, (B,) + x.shape).contiguous()

        spec = spec_for(cnv.device)
        inertia = mp.inertia if mp.inertia is not None else compute_inertia(cnv, mp.density)
        mask = torch.as_tensor(dof_set.free_mask, **like)
        y0 = torch.as_tensor(state0, **like) * mask
        if population is None and y0.dim() != 3:
            raise ValueError(f"state0 of one design has shape {tuple(y0.shape)}, want "
                             f"(2, {n_blocks}, 3)")
        ts = torch.as_tensor(timepoints, **like)
        fixed = fixed_leaves(control_params, torch.as_tensor(inertia, **like), mask, like, B)
        cparams = control_params.constraint_params

        def drive_table(t):
            """(..., n_drive) drive values, zero-padded to one column."""

            if dof_set.n_constrained == 0:
                return t.new_zeros(t.shape + (1,))
            values = torch.as_tensor(constrained_DOFs_fn(t, **cparams), **like)
            return torch.broadcast_to(values, t.shape + (dof_set.n_constrained,))

        lparams = control_params.loading_params or {}

        def load_one(t):
            try:
                values = loading_fn(None, t, **lparams)
            except (TypeError, IndexError, AttributeError) as err:
                raise TypeError(
                    "fused force loading calls loading_fn(None, t, **loading_params): it must "
                    "depend on time only (a state-dependent load needs method='verlet')"
                ) from err
            values = values.to(**like) if isinstance(values, torch.Tensor) \
                else torch.as_tensor(values, **like)
            return torch.broadcast_to(values, (len(load_pairs),))

        def load_table(t):
            """(..., n_loaded) loads, ``loading_fn`` evaluated at each scalar
            time of ``t`` (vmapped, so a JAX-style function ports as it is)."""

            return torch.func.vmap(load_one)(t.reshape(-1)).reshape(t.shape + (-1,))

        # Substep end times with JAX's operations and order:
        # dt = (t1 - t0) / n, t_start = t0 + i * dt, t_end = t_start + dt.
        dts = (ts[1:] - ts[:-1]) / n_substeps
        i = torch.arange(n_substeps, **like)
        starts = ts[:-1, None] + i[None, :] * dts[:, None]
        ends = (starts + dts[:, None]).reshape(-1)
        drive = batched(drive_table(ends))
        loads = [batched(load_table(ends))] if has_loading else []
        # Micro-step end times, one table per guard level, as the guarded
        # stepper computes them: ddt = dt / refine, start_j = start + j * ddt,
        # end_j = start_j + ddt.
        micro = []
        step = dts
        for _ in range(0 if guard is None else guard["levels"]):
            step = step / guard["refine"]
            ddt = step.view((-1,) + (1,) * starts.dim())
            starts = starts[..., None] + torch.arange(guard["refine"], **like) * ddt
            ends = (starts + ddt).reshape(-1)
            micro.append(batched(drive_table(ends)))
            if has_loading:
                loads.append(batched(load_table(ends)))

        y0 = torch.broadcast_to(y0, (B,) + y0.shape[-3:])
        U0, V0 = (lattice.to_planes(y0[:, i], n1, n2).contiguous() for i in range(2))
        inertia_p, damping_p, mask_p = fixed[-3:]
        # F0 carries the load at ts[0], as JAX's force_fn does.
        F0 = core.force(
            U0, batched(drive_table(ts[0])), fixed, spec,
            create_graph=torch.is_grad_enabled(),
            load_row=batched(load_table(ts[0])) if has_loading else None,
        )
        A0 = (F0 - damping_p * V0) * (mask_p / inertia_p)
        args = core.TrajectoryArgs(spec, U0, V0, A0, dts, drive, fixed, tuple(micro),
                                   tuple(loads))
        return args, y0, ts, population

    def trajectory_args(state0, timepoints, control_params: ControlParams):
        """The trajectory's inputs (a batch of 1 for one design, of B for a
        population), as :class:`core.TrajectoryArgs`."""

        return prepare(state0, timepoints, control_params)[0]

    def solve_dynamics(state0, timepoints, control_params: ControlParams) -> torch.Tensor:
        """Integrate the dynamics; output (T, 2, n_blocks, 3), or (B, T, 2,
        n_blocks, 3) for a population."""

        args, y0, ts, population = prepare(state0, timepoints, control_params)
        outU, outV = core.apply(args)[:2]
        out = torch.stack([outU, outV], dim=2)  # (B, T-1, 2, C, n2, n1)
        ys = torch.cat([y0[:, None], lattice.fields_from_planes(out, n_blocks)], dim=1)
        if population is None:
            ys = ys[0]
        return _driven_overwrite(ys, ts, dof_set, constrained_DOFs_fn,
                                 control_params.constraint_params,
                                 dict(dtype=ys.dtype, device=ys.device))

    solve_dynamics.trajectory_args = trajectory_args
    solve_dynamics.specs = specs
    solve_dynamics.spec_for = spec_for
    return solve_dynamics


def _any_requires_grad(tree) -> bool:
    """Whether a tensor in a tree of tuples, NamedTuples and dicts requires
    grad."""

    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return False
    return any(_any_requires_grad(x) for x in tree)


def _driven_overwrite(ys, ts, dof_set, constrained_DOFs_fn, cparams, like):
    """``ys`` (..., T, 2, n_blocks, 3) with the driven DOFs set to the drive
    values and their exact time derivatives (one forward-mode jvp)."""

    if dof_set.n_constrained == 0:
        return ys

    def drive_values(t):
        values = torch.as_tensor(constrained_DOFs_fn(t, **cparams), **like)
        return torch.broadcast_to(values, t.shape + (dof_set.n_constrained,))

    c_blocks, c_dofs, c_ids = dof_set.last_write_pairs()
    c_vals, c_rates = torch.func.jvp(drive_values, (ts,), (torch.ones_like(ts),))
    u, v = ys[..., 0, :, :].clone(), ys[..., 1, :, :].clone()
    u[..., c_blocks, c_dofs] = c_vals[:, c_ids]
    v[..., c_blocks, c_dofs] = c_rates[:, c_ids]
    return torch.stack([u, v], dim=-3)


def _dense_verlet_solver(n_blocks, energy_fn, load_pairs, loading_fn,
                         constrained_block_DOF_pairs, constrained_DOFs_fn, damped_blocks,
                         n_substeps, guard):
    """The dense ``method="verlet"`` (JAX ``_integrate_verlet``): velocity
    Verlet with exact implicit diagonal damping on the dense masked state,
    the force ``-dE/du`` of the constrained energy by autograd plus the
    loads (``loading_fn((u, v), t, ...)`` at each step's end time, with the
    step's predicted velocity ``v + dt a``). Plain PyTorch, differentiated
    by ordinary autograd through every step: the port's own cross-check of
    the fast path."""

    if guard is not None:
        raise NotImplementedError(
            "guard with the dense method='verlet' is not ported yet: ROADMAP A4 (use the "
            "quad_grid/kagome_grid fast path)."
        )
    if energy_fn is None:
        raise ValueError("method='verlet' needs energy_fn(block_displacement, control_params)")
    kinematics = build_constrained_kinematics(n_blocks, constrained_block_DOF_pairs,
                                              constrained_DOFs_fn)
    dof_set = kinematics.dof_set
    constrained_energy = constrain_energy(energy_fn, kinematics)
    loading = None if load_pairs is None else build_loading(n_blocks, load_pairs, loading_fn)
    if damped_blocks is not None:
        damping_coeffs = build_damping_coefficients(n_blocks, damped_blocks)
    else:
        def damping_coeffs(damping):
            return damping.new_zeros((n_blocks, 3))

    def solve_dynamics(state0, timepoints, control_params: ControlParams) -> torch.Tensor:
        """Integrate the dynamics; output (T, 2, n_blocks, 3)."""

        mp = control_params.mechanical_params
        cnv = control_params.geometrical_params.centroid_node_vectors
        if cnv.dim() != 3:
            raise ValueError("the dense method='verlet' solves one design; a population of "
                             "designs runs on the quad_grid/kagome_grid fast path")
        like = dict(dtype=cnv.dtype, device=cnv.device)
        inertia = mp.inertia if mp.inertia is not None else compute_inertia(cnv, mp.density)
        inertia = torch.as_tensor(inertia, **like)
        mask = torch.as_tensor(dof_set.free_mask, **like)
        y0 = torch.as_tensor(state0, **like) * mask
        ts = torch.as_tensor(timepoints, **like)
        c = damping_coeffs(torch.as_tensor(mp.damping, **like))
        lparams = control_params.loading_params or {}
        inv_m = mask / inertia
        # Keep the force's graph only where something takes a gradient.
        create_graph = torch.is_grad_enabled() and _any_requires_grad(
            (state0, timepoints, control_params))

        def force(u, v, t):
            with torch.enable_grad():
                uu = u if u.requires_grad else u.detach().requires_grad_()
                (grad,) = torch.autograd.grad(constrained_energy(uu, t, control_params), uu,
                                              create_graph=create_graph)
            f = -grad
            if loading is not None:
                f = f + loading((u, v), t, lparams)
            return f

        u, v = y0[0], y0[1]
        a = (force(u, v, ts[0]) - c * v) * inv_m
        out = [y0]
        steps = torch.arange(n_substeps, **like)
        for k in range(ts.shape[0] - 1):
            dt = (ts[k + 1] - ts[k]) / n_substeps
            starts = ts[k] + dt * steps
            for i in range(n_substeps):
                t1 = starts[i] + dt
                u1 = u + dt * v + (0.5 * dt * dt) * a
                f1 = force(u1, v + dt * a, t1)
                v_hat = v + 0.5 * dt * (a + f1 * inv_m)
                v1 = v_hat / (1.0 + 0.5 * dt * c / inertia)
                v1 = v1 * mask
                a = (f1 - c * v1) * inv_m
                u, v = u1, v1
            out.append(torch.stack([u, v]))
        ys = torch.stack(out)
        return _driven_overwrite(ys, ts, dof_set, constrained_DOFs_fn,
                                 control_params.constraint_params, like)

    return solve_dynamics
