"""Kagome-lattice trajectory: plane layout, plane energy and the kernel
wrapper.

Counterpart of ``difflexmm_tpu/ops/pallas/verlet_kagome.py`` (and the
bond splitters of ``ops/kagome_grid.py``). Kagome cells tile an (n2, n1)
grid with two triangular blocks per cell (block ``2 * cell`` "down",
``2 * cell + 1`` "up"). The state is six planes of shape ``(n2, n1)`` in
the channel order ``(ux_d, uy_d, th_d, ux_u, uy_u, th_u)``; corner geometry
is ``(2, 3, 2, n2, n1)`` [triangle, corner, component] and centroids
``(2, 2, n2, n1)``. The three bond families are shifted slices of the cell
grid:

- internal ``(n2, n1)``: down corner 1 <-> up corner 0 of the same cell;
- boundary-1 ``(n2-1, n1)``: down corner 0 of cell (j+1, i) <-> up corner 2
  of cell (j, i);
- boundary-2 ``(n2, n1-1)``: down corner 2 of cell (j, i+1) <-> up corner 1
  of cell (j, i).

The design batch B leads every tensor; the JAX package puts channels first
and has no batch. The kernel (``csrc/verlet_kagome.cu``) integrates the
whole trajectory for CUDA tensors; :func:`kagome_grid_energy_planes` is its
plain PyTorch version, which the plain body (``core.plain_trajectory``)
differentiates with autograd for CPU tensors and which the adjoint replays.
"""

import functools

import torch

from difflexmm_tpu_torch.ops.contact import contact_energy
from difflexmm_tpu_torch.ops.kernels import build, core, launch
from difflexmm_tpu_torch.ops.kernels.verlet_grid import _angle, _ligament_planes

# Fixed (per-design) leaves, in order, each with the design batch leading:
# cnv (B,2,3,2,n2,n1), centroids (B,2,2,n2,n1), ref_i (B,2,n2,n1), ref_b1
# (B,2,n2-1,n1), ref_b2 (B,2,n2,n1-1), ks_i, ksh_i, kr_i (B,n2,n1), ks_b1,
# ksh_b1, kr_b1 (B,n2-1,n1), ks_b2, ksh_b2, kr_b2 (B,n2,n1-1), cmin, ccut,
# kc (B,1,1), inertia, damping, mask (B,6,n2,n1).
N_FIXED_ARRAYS = 20


# ---------------------------------------------------------------------------
# Layout conversion
# ---------------------------------------------------------------------------


def to_planes(field: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """(..., nb, C) block field -> (..., 2 * C, n2, n1) planes, down channels
    first (leading batch dimensions kept)."""

    lead, C = field.shape[:-2], field.shape[-1]
    planes = torch.movedim(field.reshape(lead + (n2, n1, 2, C)), (-2, -1), (-4, -3))
    return planes.reshape(lead + (2 * C, n2, n1))


def fields_from_planes(out: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """(..., 2, 6, n2, n1) stacked (U, V) planes -> (..., 2, nb, 3)."""

    lead, (n2, n1) = out.shape[:-2], out.shape[-2:]
    out = torch.movedim(out.reshape(lead[:-1] + (2, 3, n2, n1)), (-4, -3), (-2, -1))
    return out.reshape(lead[:-1] + (n_blocks, 3))


def cnv_to_planes(cnv: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """(..., nb, 3, 2) centroid-node vectors -> (..., 2, 3, 2, n2, n1)."""

    return torch.movedim(cnv.reshape(cnv.shape[:-3] + (n2, n1, 2, 3, 2)), (-5, -4), (-2, -1))


def centroids_to_planes(bc: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """(..., nb, 2) block centroids -> (..., 2, 2, n2, n1) [triangle, comp,
    j, i]."""

    return torch.movedim(bc.reshape(bc.shape[:-2] + (n2, n1, 2, 2)), (-4, -3), (-2, -1))


def split_bond_planes(value, n1: int, n2: int):
    """Scalar-or-(n_bonds,) bond quantity -> (internal, b1, b2) planes, in
    the bond order of ``geometry/kagome.py`` (JAX ``kagome_grid._split``)."""

    value = torch.as_tensor(value)
    if value.ndim == 0:
        return value, value, value
    n_int, n_b1 = n1 * n2, n1 * (n2 - 1)
    return (
        value[:n_int].reshape(n2, n1),
        value[n_int:n_int + n_b1].reshape(n2 - 1, n1),
        value[n_int + n_b1:].reshape(n2, n1 - 1),
    )


def split_ref_planes(ref, n1: int, n2: int):
    """(n_bonds, 2) or one shared (2,) reference vector -> three (2, ...)
    plane pairs (JAX ``kagome_grid._split_ref``, components first)."""

    ref = torch.as_tensor(ref)
    shapes = ((n2, n1), (n2 - 1, n1), (n2, n1 - 1))
    if ref.ndim == 1:
        return tuple(torch.broadcast_to(ref[:, None, None], (2,) + s) for s in shapes)
    n_int, n_b1 = n1 * n2, n1 * (n2 - 1)
    parts = (ref[:n_int], ref[n_int:n_int + n_b1], ref[n_int + n_b1:])
    return tuple(torch.movedim(r.reshape(*s, 2), -1, 0) for r, s in zip(parts, shapes))


# ---------------------------------------------------------------------------
# Plane physics (the kernel's plain version)
# ---------------------------------------------------------------------------


def _displacements(U, cnv):
    """d[tri][corner] = (dx, dy): corner displacements of each triangle."""

    d = []
    for tri in range(2):
        ux, uy, th = U[..., 3 * tri, :, :], U[..., 3 * tri + 1, :, :], U[..., 3 * tri + 2, :, :]
        cth, sth = torch.cos(th), torch.sin(th)
        d.append([
            (
                ux + (cth - 1.0) * cnv[..., tri, k, 0, :, :] - sth * cnv[..., tri, k, 1, :, :],
                uy + sth * cnv[..., tri, k, 0, :, :] + (cth - 1.0) * cnv[..., tri, k, 1, :, :],
            )
            for k in range(3)
        ])
    return d


def _positions(d, cnv, centroids):
    """p[tri][corner] = (x, y): absolute corner positions, centroid + r + d."""

    return [
        [
            (
                centroids[..., tri, 0, :, :] + cnv[..., tri, k, 0, :, :] + d[tri][k][0],
                centroids[..., tri, 1, :, :] + cnv[..., tri, k, 1, :, :] + d[tri][k][1],
            )
            for k in range(3)
        ]
        for tri in range(2)
    ]


def _family_voids(p, reduce=None):
    """The two void angles at the bonds of each family, from the corner
    positions ``p[tri][corner] = (x, y)``: internal, boundary-1,
    boundary-2, two each. ``reduce`` (e.g. a minimum over the grid) is
    applied to each."""

    def voids(c1, c2, slice1, slice2):
        """Void angles at bonds joining down corner c1 (slice1) to up corner
        c2 (slice2); _angle is scale-invariant, so edge vectors need no
        normalization."""

        p1, p2 = p[0], p[1]
        n1x = p1[(c1 + 1) % 3][0][slice1] - p1[c1][0][slice1]
        n1y = p1[(c1 + 1) % 3][1][slice1] - p1[c1][1][slice1]
        p1x = p1[(c1 - 1) % 3][0][slice1] - p1[c1][0][slice1]
        p1y = p1[(c1 - 1) % 3][1][slice1] - p1[c1][1][slice1]
        n2x = p2[(c2 + 1) % 3][0][slice2] - p2[c2][0][slice2]
        n2y = p2[(c2 + 1) % 3][1][slice2] - p2[c2][1][slice2]
        p2x = p2[(c2 - 1) % 3][0][slice2] - p2[c2][0][slice2]
        p2y = p2[(c2 - 1) % 3][1][slice2] - p2[c2][1][slice2]
        out = (_angle(p2x, p2y, n1x, n1y), _angle(p1x, p1y, n2x, n2y))
        return out if reduce is None else tuple(reduce(v) for v in out)

    full = (...,)
    return (
        voids(1, 0, full, full)
        + voids(0, 2, (..., slice(1, None), slice(None)), (..., slice(None, -1), slice(None)))
        + voids(2, 1, (..., slice(1, None)), (..., slice(None, -1)))
    )


def kagome_grid_energy_planes(
    U,  # (..., 6, n2, n1)
    cnv,  # (..., 2, 3, 2, n2, n1)
    centroids,  # (..., 2, 2, n2, n1)
    ref_i, ref_b1, ref_b2,  # (..., 2, n2, n1), (..., 2, n2-1, n1), (..., 2, n2, n1-1)
    ks_i, ksh_i, kr_i, ks_b1, ksh_b1, kr_b1, ks_b2, ksh_b2, kr_b2,
    cmin, ccut, kc,
    linearized: bool = False,
    use_contact: bool = True,
):
    """Total strain plus contact energy of the kagome lattice on planes,
    summed over any leading (batch) dimensions.

    Same physics as ``kagome_grid_energy_planes`` of the JAX package
    (``verlet_kagome.py:127-242``), with the true ``atan2``: each bond's
    ligament on ``up - down`` (theta_1 the down triangle's, theta_2 the
    up's), and the contact barrier on its two void angles. A corner's
    position is ``centroid + r + d``.
    """

    d = _displacements(U, cnv)
    thd, thu = U[..., 2, :, :], U[..., 5, :, :]
    down, up = d
    e_i = _ligament_planes(
        up[0][0] - down[1][0], up[0][1] - down[1][1],
        thd, thu, ref_i[..., 0, :, :], ref_i[..., 1, :, :], ks_i, ksh_i, kr_i, linearized,
    )
    e_b1 = _ligament_planes(
        up[2][0][..., :-1, :] - down[0][0][..., 1:, :],
        up[2][1][..., :-1, :] - down[0][1][..., 1:, :],
        thd[..., 1:, :], thu[..., :-1, :], ref_b1[..., 0, :, :], ref_b1[..., 1, :, :],
        ks_b1, ksh_b1, kr_b1, linearized,
    )
    e_b2 = _ligament_planes(
        up[1][0][..., :, :-1] - down[2][0][..., :, 1:],
        up[1][1][..., :, :-1] - down[2][1][..., :, 1:],
        thd[..., :, 1:], thu[..., :, :-1], ref_b2[..., 0, :, :], ref_b2[..., 1, :, :],
        ks_b2, ksh_b2, kr_b2, linearized,
    )
    energy = torch.sum(e_i) + torch.sum(e_b1) + torch.sum(e_b2)
    if not use_contact:
        return energy
    contact = sum(torch.sum(contact_energy(g, cmin, ccut, kc))
                  for g in _family_voids(_positions(d, cnv, centroids)))
    return energy + contact


def kagome_void_angles_planes(U, cnv, centroids):
    """The six void-angle planes (two per family) of a state ``U``, with the
    energy's corner formula."""

    return _family_voids(_positions(_displacements(U, cnv), cnv, centroids))


def _energy_of(U_eff, fixed, linearized, use_contact):
    return kagome_grid_energy_planes(
        U_eff, *fixed[:17], linearized=linearized, use_contact=use_contact
    )


def kagome_min_void_gap_planes(U, cnv, centroids, ccut):
    """Min void angle minus the contact cutoff of each design, ``(B,)`` (the
    guard's proximity term; JAX ``verlet_kagome.py:245-290``). Its corner is
    ``centroid + u + R(theta) r``, on the carry's free ``U``, as JAX writes
    it. ``U`` (B, 6, n2, n1), ``ccut`` (B, 1, 1)."""

    p = []
    for tri in range(2):
        ux, uy, th = U[:, 3 * tri], U[:, 3 * tri + 1], U[:, 3 * tri + 2]
        cth, sth = torch.cos(th), torch.sin(th)
        cx = [cnv[:, tri, k, 0] for k in range(3)]
        cy = [cnv[:, tri, k, 1] for k in range(3)]
        cen_x, cen_y = centroids[:, tri, 0], centroids[:, tri, 1]
        p.append([
            (cen_x + ux + cth * cx[k] - sth * cy[k], cen_y + uy + sth * cx[k] + cth * cy[k])
            for k in range(3)
        ])
    gaps = _family_voids(p, reduce=lambda v: torch.amin(v, dim=(-2, -1)))
    out = gaps[0]
    for g in gaps[1:]:
        out = torch.minimum(out, g)
    return out - torch.amin(ccut, dim=(-2, -1))


def _gap_of(U, fixed, use_contact):
    """The kagome barrier gap (JAX ``_kagome_gap_of``): +inf where contact
    is off or ``k_contact <= 0``, so that the proximity term never fires
    there."""

    inf = U.new_full((U.shape[0],), float("inf"))
    if not use_contact:
        return inf
    gap = kagome_min_void_gap_planes(U, fixed[0], fixed[1], fixed[15])
    return torch.where(torch.amin(fixed[16], dim=(-2, -1)) > 0, gap, inf)


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------


def fixed_shapes(B, n1, n2):
    """Expected shapes of the fixed leaves, in order."""

    i, b1, b2, full = (B, n2, n1), (B, n2 - 1, n1), (B, n2, n1 - 1), (B, 6, n2, n1)
    return (
        (B, 2, 3, 2, n2, n1), (B, 2, 2, n2, n1), (B, 2, n2, n1), (B, 2, n2 - 1, n1),
        (B, 2, n2, n1 - 1), i, i, i, b1, b1, b1, b2, b2, b2, (B, 1, 1), (B, 1, 1), (B, 1, 1),
        full, full, full,
    )


def _load_library():
    return launch.type_library(build.load("verlet_kagome"), "verlet_kagome")


def carry_bytes(n1: int, n2: int, dtype) -> tuple:
    """(bytes of carry one design needs, bytes of shared memory a block of
    the current CUDA device may use); see ``launch.carry_bytes``."""

    return launch.carry_bytes(_load_library(), "verlet_kagome", n1, n2, dtype)


def verlet_kagome_trajectory(
    U0, V0, A0, dts, drive, fixed, spec, micro=(), loads=(), *, linearized, use_contact,
    drive_map
):
    """Whole kagome trajectory: ``(B, 6, n2, n1)`` initial state, ``(T-1,)``
    substep sizes, ``(B, (T-1) * n_sub, k)`` drive table and the
    :data:`N_FIXED_ARRAYS` fixed leaves -> ``(outU, outV, outA)``, each
    ``(B, T-1, 6, n2, n1)``. With ``spec.guard`` (theta channels 2 and 5,
    any ``levels``) it also takes the micro-step table of each depth d,
    ``micro[d - 1]`` ``(B, (T-1) * n_sub * refine**d, k)``, and returns the
    per-interval flags ``(B, T-1)``, the per-substep decisions ``(B, (T-1)
    * n_sub)`` and the ``spec.n_deep`` decision tables of the micro-steps
    of depths 1 ... levels - 1 (bool; ``launch.run``).

    With ``spec.load_map`` it also takes the load tables ``loads`` (the
    substep table ``(B, (T-1) * n_sub, k_load)`` and, guarded, one
    micro-step table a depth), added into the force (``launch.run``).

    CPU tensors go through the plain body (``core.plain_trajectory``).
    CUDA tensors launch ``csrc/verlet_kagome.cu`` or raise: there is no
    fallback. Each launch adds one to ``verlet_kagome_trajectory.launches``
    (unguarded, unloaded), ``.guarded_launches``, ``.loaded_launches`` or
    ``.loaded_guarded_launches`` (``launch.counter``).
    """

    if U0.device.type == "cpu":
        return core.plain_trajectory(U0, V0, A0, dts, drive, fixed, spec, micro, loads)
    if U0.device.type != "cuda":
        raise ValueError(f"verlet_kagome_trajectory: unsupported device {U0.device}")
    B, _, n2, n1 = U0.shape
    return launch.run(
        _load_library(), "verlet_kagome", verlet_kagome_trajectory, U0, V0, A0, dts, drive, fixed, spec, micro,
        loads, linearized=linearized, use_contact=use_contact, drive_map=drive_map,
        fixed_shapes=fixed_shapes(B, n1, n2), theta_channels=(2, 5),
    )


launch.reset_counts(verlet_kagome_trajectory)


def plane_slots(blocks, dofs, n1: int, n2: int):
    """Flat ``(6, n2, n1)`` plane index of each (block, DOF) pair: triangle
    ``block % 2`` of cell ``block // 2`` has its DOF d in channel ``3 *
    (block % 2) + d`` (JAX ``verlet_kagome.py:81-95``)."""

    return ((blocks % 2) * 3 + dofs) * (n2 * n1) + blocks // 2


def kagome_trajectory_spec(
    n1: int,
    n2: int,
    n_substeps: int,
    drive_slots,
    drive_cols,
    device,
    linearized: bool = False,
    use_contact: bool = True,
    kernel: bool = True,
    guard=None,
    load_slots=None,
) -> core.TrajectorySpec:
    """The kagome lattice's :class:`core.TrajectorySpec`.

    ``drive_slots``/``drive_cols``: flat ``(6, n2, n1)`` plane index of each
    driven slot and the drive-table column it takes (one entry per slot).
    ``load_slots``: flat plane index of each loaded pair
    (:func:`plane_slots`), in pair order (duplicates add), or None without
    loads.
    ``kernel=False`` makes the forward the plain body on every device (the
    JAX package's ``verlet_ckpt``). ``guard``: a resolved guard spec
    (``core.resolve_guard`` with ``theta_channels=(2, 5)``) or None.
    """

    slots = torch.as_tensor(drive_slots, dtype=torch.int64, device=device)
    cols = torch.as_tensor(drive_cols, dtype=torch.int64, device=device)
    drive_map = torch.full((6 * n2 * n1,), -1, dtype=torch.int32, device=device)
    drive_map[slots] = cols.to(torch.int32)
    if kernel:
        forward = functools.partial(
            verlet_kagome_trajectory, linearized=linearized, use_contact=use_contact,
            drive_map=drive_map.view(6, n2, n1),
        )
    else:
        forward = core.plain_trajectory
    energy_of = functools.partial(_energy_of, linearized=linearized, use_contact=use_contact)
    return core.TrajectorySpec(
        n_substeps, energy_of, forward, slots, cols,
        guard=guard,
        gap_of=functools.partial(_gap_of, use_contact=use_contact),
        load_map=None if load_slots is None else core.load_map(load_slots, (6, n2, n1),
                                                                device),
    )
