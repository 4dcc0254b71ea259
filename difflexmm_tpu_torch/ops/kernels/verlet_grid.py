"""Quad-lattice trajectory: plane layout, plane energy and the kernel wrapper.

Counterpart of ``difflexmm_tpu/ops/pallas/verlet_grid.py``. Every field is
a stack of component planes of shape ``(n2, n1)``: state ``(B, 3, n2, n1)``
(ux, uy, theta), corner geometry ``(B, 4, 2, n2, n1)``, horizontal bond
data ``(B, ., n2, n1-1)``, vertical ``(B, ., n2-1, n1)``. The design batch B
leads; the JAX package puts channels first and has no batch.

The trajectory kernel (``csrc/verlet_quad.cu``) integrates the whole
trajectory for CUDA tensors; :func:`quad_grid_energy_planes` is its plain
PyTorch version, which the plain body (``core.plain_trajectory``)
differentiates with autograd for CPU tensors and which the adjoint
replays. The force kernel (``csrc/quad_force.cu``, :func:`quad_force`)
computes one energy gradient of B designs; the stepped forward of
``method="verlet_ckpt"`` (``core.stepped_trajectory``) launches it once a
(micro-)step on CUDA tensors, and :func:`quad_grid_force_planes` is its
plain version.
"""

import ctypes
import functools

import torch

from difflexmm_tpu_torch.ops.contact import contact_energy
from difflexmm_tpu_torch.ops.kernels import build, core, launch

# Fixed (per-design) leaves, in order, each with the design batch leading:
# cnv (B,4,2,n2,n1), centroids (B,2,n2,n1), ref_h (B,2,n2,n1-1),
# ref_v (B,2,n2-1,n1), ks_h, ksh_h, kr_h (B,n2,n1-1), ks_v, ksh_v, kr_v
# (B,n2-1,n1), cmin, ccut, kc (B,1,1), inertia, damping, mask (B,3,n2,n1).
N_FIXED_ARRAYS = 16


# ---------------------------------------------------------------------------
# Layout conversion
# ---------------------------------------------------------------------------


def to_planes(field: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """(..., nb, C) block field -> (..., C, n2, n1) planes (leading batch
    dimensions kept)."""

    C = field.shape[-1]
    return torch.movedim(field.reshape(field.shape[:-2] + (n2, n1, C)), -1, -3)


def cnv_to_planes(cnv: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """(..., nb, 4, 2) centroid-node vectors -> (..., 4, 2, n2, n1)."""

    return torch.movedim(cnv.reshape(cnv.shape[:-3] + (n2, n1, 4, 2)), (-2, -1), (-4, -3))


def fields_from_planes(out: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """(..., 2, 3, n2, n1) stacked (U, V) planes -> (..., 2, nb, 3)."""

    return torch.movedim(out, -3, -1).reshape(out.shape[:-3] + (n_blocks, 3))


# ---------------------------------------------------------------------------
# Plane physics (the kernel's plain version)
# ---------------------------------------------------------------------------


def _ligament_planes(dUx, dUy, th1, th2, refx, refy, ks, ksh, kr, linearized):
    """Per-bond ligament energy on planes."""

    l0sq = refx * refx + refy * refy
    dRot = th2 - th1
    if linearized:
        axial = (dUx * refx + dUy * refy) / l0sq
        shear = (refx * dUy - refy * dUx) / l0sq - (th1 + th2) / 2
    else:
        rx = dUx + refx
        ry = dUy + refy
        axial = torch.sqrt((rx * rx + ry * ry) / l0sq) - 1.0
        mean = (th1 + th2) / 2
        c, s = torch.cos(mean), torch.sin(mean)
        px = c * refx - s * refy
        py = s * refx + c * refy
        shear = torch.atan2(px * ry - py * rx, px * rx + py * ry)
    return (ks * axial**2 * l0sq + ksh * shear**2 * l0sq + kr * dRot**2) / 2


def _angle(ax, ay, bx, by):
    """Signed angle from (ax, ay) to (bx, by) planes."""

    return torch.atan2(ax * by - ay * bx, ax * bx + ay * by)


def _corner_displacements(U, cnv):
    """Displacements (dx, dy) of all four corners, (..., 4, n2, n1) each."""

    ux, uy, th = U.unbind(-3)
    cth, sth = torch.cos(th), torch.sin(th)
    cx, cy = cnv.unbind(-3)
    cm1 = (cth - 1.0).unsqueeze(-3)
    s = sth.unsqueeze(-3)
    dx = ux.unsqueeze(-3) + cm1 * cx - s * cy
    dy = uy.unsqueeze(-3) + s * cx + cm1 * cy
    return dx, dy


def _void_angles(dx, dy, cnv, centroids):
    """(vh1, vh2, vv1, vv2): the two void angles at every horizontal and
    every vertical bond."""

    cx, cy = cnv.unbind(-3)
    px = centroids[..., 0, :, :].unsqueeze(-3) + cx + dx
    py = centroids[..., 1, :, :].unsqueeze(-3) + cy + dy
    # Edge vectors from each corner to the next and to the previous corner.
    nx, ny = torch.roll(px, -1, -3) - px, torch.roll(py, -1, -3) - py
    qx, qy = torch.roll(px, 1, -3) - px, torch.roll(py, 1, -3) - py

    def voids(c1, c2, s1, s2):
        """Void angles at bonds joining corner c1 (blocks s1) to corner c2
        (blocks s2)."""

        a = (..., c1) + s1
        b = (..., c2) + s2
        return _angle(qx[b], qy[b], nx[a], ny[a]), _angle(qx[a], qy[a], nx[b], ny[b])

    all_ = slice(None)
    return (
        *voids(0, 2, (all_, slice(None, -1)), (all_, slice(1, None))),
        *voids(1, 3, (slice(None, -1), all_), (slice(1, None), all_)),
    )


def quad_void_angles_planes(U, cnv, centroids):
    """The void-angle planes ``(vh1, vh2, vv1, vv2)`` of a state ``U``."""

    return _void_angles(*_corner_displacements(U, cnv), cnv, centroids)


def quad_grid_energy_planes(
    U,  # (..., 3, n2, n1): ux, uy, theta
    cnv,  # (..., 4, 2, n2, n1)
    centroids,  # (..., 2, n2, n1)
    ref_h, ref_v,  # (..., 2, n2, n1-1), (..., 2, n2-1, n1)
    ks_h, ksh_h, kr_h, ks_v, ksh_v, kr_v,
    cmin, ccut, kc,
    linearized: bool = False,
    use_contact: bool = True,
):
    """Total strain plus contact energy of the quad lattice on planes,
    summed over any leading (batch) dimensions.

    Same physics as ``quad_grid_energy_planes`` of the JAX package, with
    the true ``atan2``. Horizontal bonds join corner 0 of block (j, i) to
    corner 2 of (j, i+1), vertical bonds corner 1 of (j, i) to corner 3 of
    (j+1, i); each bond has two void angles under the contact barrier.
    """

    th = U[..., 2, :, :]
    dx, dy = _corner_displacements(U, cnv)
    e_h = _ligament_planes(
        dx[..., 2, :, 1:] - dx[..., 0, :, :-1],
        dy[..., 2, :, 1:] - dy[..., 0, :, :-1],
        th[..., :-1], th[..., 1:], ref_h[..., 0, :, :], ref_h[..., 1, :, :],
        ks_h, ksh_h, kr_h, linearized,
    )
    e_v = _ligament_planes(
        dx[..., 3, 1:, :] - dx[..., 1, :-1, :],
        dy[..., 3, 1:, :] - dy[..., 1, :-1, :],
        th[..., :-1, :], th[..., 1:, :], ref_v[..., 0, :, :], ref_v[..., 1, :, :],
        ks_v, ksh_v, kr_v, linearized,
    )
    energy = torch.sum(e_h) + torch.sum(e_v)
    if not use_contact:
        return energy
    contact = sum(
        torch.sum(contact_energy(g, cmin, ccut, kc))
        for g in _void_angles(dx, dy, cnv, centroids)
    )
    return energy + contact


def quad_grid_force_planes(U_eff, cnv, centroids, ref_h, ref_v, ks_h, ksh_h, kr_h, ks_v,
                           ksh_v, kr_v, cmin, ccut, kc, linearized: bool = False,
                           use_contact: bool = True):
    """``dE/dU_eff`` of :func:`quad_grid_energy_planes` at ``U_eff`` (..., 3,
    n2, n1), each design's own gradient (designs do not interact): the
    plain PyTorch version of the force kernel (:func:`quad_force`), the
    gradient that ``core.force`` takes, on the calling thread as there."""

    with torch.enable_grad(), torch.autograd.set_multithreading_enabled(False):
        U = U_eff.detach().requires_grad_()
        energy = quad_grid_energy_planes(U, cnv, centroids, ref_h, ref_v, ks_h, ksh_h, kr_h,
                                         ks_v, ksh_v, kr_v, cmin, ccut, kc,
                                         linearized=linearized, use_contact=use_contact)
        (grad,) = torch.autograd.grad(energy, U)
    return grad


def _energy_of(U_eff, fixed, linearized, use_contact):
    return quad_grid_energy_planes(
        U_eff, *fixed[:13], linearized=linearized, use_contact=use_contact
    )


def quad_min_void_gap_planes(U, cnv, centroids, ccut):
    """Min void angle minus the contact cutoff of each design, ``(B,)`` (the
    guard's proximity term; JAX ``verlet_grid.py:201-243``, same corner
    formula and order). ``U`` (B, 3, n2, n1), ``ccut`` (B, 1, 1)."""

    ux, uy, th = U.unbind(-3)
    cth, sth = torch.cos(th), torch.sin(th)
    cx, cy = cnv[..., 0, :, :], cnv[..., 1, :, :]  # (B, 4, n2, n1) each
    cen_x, cen_y = centroids[..., 0, :, :], centroids[..., 1, :, :]
    px = [cen_x + ux + cth * cx[:, k] - sth * cy[:, k] for k in range(4)]
    py = [cen_y + uy + sth * cx[:, k] + cth * cy[:, k] for k in range(4)]

    def voids(c1, c2, s1, s2):
        n1x, n1y = px[(c1 + 1) % 4][s1] - px[c1][s1], py[(c1 + 1) % 4][s1] - py[c1][s1]
        p1x, p1y = px[(c1 - 1) % 4][s1] - px[c1][s1], py[(c1 - 1) % 4][s1] - py[c1][s1]
        n2x, n2y = px[(c2 + 1) % 4][s2] - px[c2][s2], py[(c2 + 1) % 4][s2] - py[c2][s2]
        p2x, p2y = px[(c2 - 1) % 4][s2] - px[c2][s2], py[(c2 - 1) % 4][s2] - py[c2][s2]
        return (torch.amin(_angle(p2x, p2y, n1x, n1y), dim=(-2, -1)),
                torch.amin(_angle(p1x, p1y, n2x, n2y), dim=(-2, -1)))

    all_ = slice(None)
    gaps = voids(0, 2, (all_, all_, slice(None, -1)), (all_, all_, slice(1, None)))
    gaps += voids(1, 3, (all_, slice(None, -1), all_), (all_, slice(1, None), all_))
    out = gaps[0]
    for g in gaps[1:]:
        out = torch.minimum(out, g)
    return out - torch.amin(ccut, dim=(-2, -1))


def _gap_of(U, fixed, use_contact):
    """The quad barrier gap (JAX ``_quad_gap_of``): +inf where contact is off
    or ``k_contact <= 0``, so that the proximity term never fires there."""

    inf = U.new_full((U.shape[0],), float("inf"))
    if not use_contact:
        return inf
    gap = quad_min_void_gap_planes(U, fixed[0], fixed[1], fixed[11])
    return torch.where(torch.amin(fixed[12], dim=(-2, -1)) > 0, gap, inf)


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------


def fixed_shapes(B, n1, n2):
    """Expected shapes of the fixed leaves, in order."""

    h, v, full = (B, n2, n1 - 1), (B, n2 - 1, n1), (B, 3, n2, n1)
    return (
        (B, 4, 2, n2, n1), (B, 2, n2, n1), (B, 2, n2, n1 - 1), (B, 2, n2 - 1, n1),
        h, h, h, v, v, v, (B, 1, 1), (B, 1, 1), (B, 1, 1), full, full, full,
    )


def _load_library():
    return launch.type_library(build.load("verlet_quad"), "verlet_quad")


def carry_bytes(n1: int, n2: int, dtype) -> tuple:
    """(bytes of carry one design needs, bytes of shared memory a block of
    the current CUDA device may use); see ``launch.carry_bytes``."""

    return launch.carry_bytes(_load_library(), "verlet_quad", n1, n2, dtype)


def verlet_quad_trajectory(
    U0, V0, A0, dts, drive, fixed, spec, micro=(), loads=(), *, linearized, use_contact,
    drive_map
):
    """Whole quad trajectory: ``(B, 3, n2, n1)`` initial state, ``(T-1,)``
    substep sizes, ``(B, (T-1) * n_sub, k)`` drive table and the
    :data:`N_FIXED_ARRAYS` fixed leaves -> ``(outU, outV, outA)``, each
    ``(B, T-1, 3, n2, n1)``. With ``spec.guard`` (any ``levels``) it also
    takes the micro-step table of each depth d, ``micro[d - 1]`` ``(B,
    (T-1) * n_sub * refine**d, k)``, and returns the per-interval flags
    ``(B, T-1)``, the per-substep decisions ``(B, (T-1) * n_sub)`` and the
    ``spec.n_deep`` decision tables of the micro-steps of depths 1 ...
    levels - 1 (bool; ``launch.run``).

    With ``spec.load_map`` it also takes the load tables ``loads`` (the
    substep table ``(B, (T-1) * n_sub, k_load)`` and, guarded, one
    micro-step table a depth), added into the force (``launch.run``).

    CPU tensors go through the plain body (``core.plain_trajectory``).
    CUDA tensors launch ``csrc/verlet_quad.cu`` or raise: there is no
    fallback. Each launch adds one to ``verlet_quad_trajectory.launches``
    (unguarded, unloaded), ``.guarded_launches``, ``.loaded_launches`` or
    ``.loaded_guarded_launches`` (``launch.counter``).
    """

    if U0.device.type == "cpu":
        return core.plain_trajectory(U0, V0, A0, dts, drive, fixed, spec, micro, loads)
    if U0.device.type != "cuda":
        raise ValueError(f"verlet_quad_trajectory: unsupported device {U0.device}")
    B, _, n2, n1 = U0.shape
    return launch.run(
        _load_library(), "verlet_quad", verlet_quad_trajectory, U0, V0, A0, dts, drive, fixed, spec, micro,
        loads, linearized=linearized, use_contact=use_contact, drive_map=drive_map,
        fixed_shapes=fixed_shapes(B, n1, n2), theta_channels=(2,),
    )


launch.reset_counts(verlet_quad_trajectory)


def _force_library():
    lib = build.load("quad_force")
    if not getattr(lib, "_typed", False):
        lib.quad_force_launch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.quad_force_launch.restype = ctypes.c_int
        lib.quad_force_error_string.argtypes = [ctypes.c_int]
        lib.quad_force_error_string.restype = ctypes.c_char_p
        lib.quad_force_tile.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        lib.quad_force_tile.restype = ctypes.c_int
        lib._typed = True
    return lib


def force_tile(n1: int, n2: int, B: int) -> tuple:
    """``(blocks along n1, along n2, threads)`` of the lattice tile that a
    launch of :func:`quad_force` on ``B`` designs of ``n1 x n2`` blocks
    takes on the current CUDA device, as the kernel's launch picks it
    (``pick_tile`` in ``csrc/quad_force.cu``)."""

    shape = (ctypes.c_int * 3)()
    if _force_library().quad_force_tile(n1, n2, B, shape) != 0:
        raise RuntimeError("quad_force: cannot query the device's SMs")
    return tuple(shape)


def quad_force(U_eff, fixed, *, linearized, use_contact):
    """``dE/dU_eff`` of the quad plane energy for B designs: ``U_eff`` (B,
    3, n2, n1) and the fixed leaves, of which the first 13 (cnv ... kc,
    :data:`N_FIXED_ARRAYS`' energy leaves) are read -> (B, 3, n2, n1).

    CPU tensors go to the plain version (:func:`quad_grid_force_planes`).
    CUDA tensors launch ``csrc/quad_force.cu`` (one kernel over lattice
    tiles and designs, :func:`force_tile`) or raise: there is no fallback.
    Each launch adds one to ``quad_force.launches``.
    """

    fixed = tuple(fixed[:13])
    if U_eff.device.type == "cpu":
        return quad_grid_force_planes(U_eff, *fixed, linearized=linearized,
                                      use_contact=use_contact)
    if U_eff.device.type != "cuda":
        raise ValueError(f"quad_force: unsupported device {U_eff.device}")
    dtype = U_eff.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"quad_force: dtype {dtype} (float32/float64 only)")
    if U_eff.dim() != 4 or U_eff.shape[1] != 3:
        raise ValueError(f"quad_force: U_eff of shape {tuple(U_eff.shape)}, want (B, 3, n2, n1)")
    B, _, n2, n1 = U_eff.shape
    expected = ((B, 3, n2, n1),) + fixed_shapes(B, n1, n2)[:13]
    if len(fixed) != 13:
        raise ValueError(f"quad_force: {len(fixed)} fixed leaves, want at least 13")
    for i, (t, shape) in enumerate(zip((U_eff,) + fixed, expected)):
        if t.device != U_eff.device or t.dtype != dtype:
            raise ValueError(f"quad_force argument {i}: {t.device}/{t.dtype}, want "
                             f"{U_eff.device}/{dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"quad_force argument {i}: shape {tuple(t.shape)}, want "
                             f"contiguous {shape}")
    lib = _force_library()
    with torch.cuda.device(U_eff.device):
        out = torch.empty_like(U_eff)
        pointers = [t.data_ptr() for t in (U_eff, *fixed, out)]
        ptrs = (ctypes.c_void_p * len(pointers))(*pointers)
        dims = (ctypes.c_int * 3)(B, n1, n2)
        stream = torch.cuda.current_stream(U_eff.device).cuda_stream
        err = lib.quad_force_launch(ptrs, dims, U_eff.element_size(), int(linearized),
                                    int(use_contact), stream)
    if err != 0:
        message = lib.quad_force_error_string(err).decode()
        raise RuntimeError(f"quad_force launch failed: {message} ({err})")
    quad_force.launches += 1
    return out


quad_force.launches = 0


def verlet_ckpt_trajectory(U0, V0, A0, dts, drive, fixed, spec, micro=(), loads=()):
    """The forward of ``method="verlet_ckpt"`` (the JAX solver's stepped
    forward): on CUDA tensors ``core.stepped_trajectory``, one launch of
    the force kernel a (micro-)step, guarded to any depth (as the
    trajectory kernel of the default method is); on CPU tensors the plain
    body (``core.plain_trajectory``)."""

    if U0.device.type == "cpu":
        return core.plain_trajectory(U0, V0, A0, dts, drive, fixed, spec, micro, loads)
    return core.stepped_trajectory(U0, V0, A0, dts, drive, fixed, spec, micro, loads)


def plane_slots(blocks, dofs, n1: int, n2: int):
    """Flat ``(3, n2, n1)`` plane index of each (block, DOF) pair: channel
    DOF, then the block (blocks are numbered row by row, as the planes)."""

    return dofs * (n1 * n2) + blocks


def quad_trajectory_spec(
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
    """The quad lattice's :class:`core.TrajectorySpec`.

    ``drive_slots``/``drive_cols``: flat ``(3, n2, n1)`` plane index of each
    driven slot and the drive-table column it takes (one entry per slot).
    ``load_slots``: flat plane index of each loaded pair
    (:func:`plane_slots`), in pair order (duplicates add), or None without
    loads.
    ``kernel=False`` makes the forward the JAX package's ``verlet_ckpt``
    (:func:`verlet_ckpt_trajectory`: step by step, the force kernel once a
    (micro-)step on CUDA tensors, the plain body on CPU tensors; same math
    and adjoint).
    ``guard``: a resolved guard spec (``core.resolve_guard`` with
    ``theta_channels=(2,)``) or None.
    """

    slots = torch.as_tensor(drive_slots, dtype=torch.int64, device=device)
    cols = torch.as_tensor(drive_cols, dtype=torch.int64, device=device)
    drive_map = torch.full((3 * n2 * n1,), -1, dtype=torch.int32, device=device)
    drive_map[slots] = cols.to(torch.int32)
    if kernel:
        forward = functools.partial(
            verlet_quad_trajectory, linearized=linearized, use_contact=use_contact,
            drive_map=drive_map.view(3, n2, n1),
        )
    else:
        forward = verlet_ckpt_trajectory
    energy_of = functools.partial(_energy_of, linearized=linearized, use_contact=use_contact)
    return core.TrajectorySpec(
        n_substeps, energy_of, forward, slots, cols,
        guard=guard,
        gap_of=functools.partial(_gap_of, use_contact=use_contact),
        load_map=None if load_slots is None else core.load_map(load_slots, (3, n2, n1),
                                                                device),
        force_of=functools.partial(quad_force, linearized=linearized, use_contact=use_contact),
    )
