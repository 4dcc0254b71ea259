"""Bloch band-structure analysis of periodic block-spring metamaterials
(counterpart of ``difflexmm_tpu/solver/bloch.py``).

For a periodic lattice with a unit cell of ``B`` rigid blocks (3 DOFs
each) and bonds that may cross cell boundaries, the Bloch ansatz ``q(R) =
q_hat exp(i k . R)`` reduces the infinite quadratic form to the Hermitian
cell dynamical matrix

    D(k) = sum_bonds  P_i^T H_11 P_i + P_j^T H_22 P_j
           + P_i^T H_12 P_j e^{i k . R_m} + P_j^T H_21 P_i e^{-i k . R_m}

with ``H`` the 6x6 bond Hessian (``torch.func.hessian`` of the bond
energy through the rigid-block node kinematics) and ``R_m`` the Cartesian
offset of the second block's cell. Frequencies solve ``D(k) q = omega^2
M q``, symmetrized with the diagonal inertia; the k-sweep is one batched
complex ``torch.linalg.eigh`` (complex128 at float64). Everything is
differentiable, so band gaps can be designed by gradient descent on the
cell; ``relax_cell`` has an implicit-function-theorem adjoint.

Cells live on a device (``device``, the CUDA device unless the caller
asks for the CPU; a cell function given a design tensor follows its device and
dtype). Their integer bond tables are int64 tensors there.
"""

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from difflexmm_tpu_torch.geometry.polygon import compute_inertia, polygon_centroid
from difflexmm_tpu_torch.ops.bonds import ligament_energy
from difflexmm_tpu_torch.solver.statics import TensorLeaves, default_tol, newton_solve


class BlochCell(NamedTuple):
    """A periodic unit cell: blocks, bonds (with cell offsets), inertia.

    Attrs:
        direct_basis: (2, 2) lattice translation vectors (rows).
        centroid_node_vectors: (B, V, 2) node vectors of the cell blocks.
        inertia: (B, 3) translational and rotational block inertia.
        bond_blocks: (n_bonds, 2) local block ids of each bond's ends.
        bond_nodes: (n_bonds, 2) node index within each block of the ends.
        bond_offsets: (n_bonds, 2) integer cell offset of the second end's
            cell relative to the first end's.
        bond_params: dict of per-bond (or scalar) energy keywords, e.g.
            ``reference_vector (n_bonds, 2)``, ``k_stretch``, ...
    """

    direct_basis: Any
    centroid_node_vectors: Any
    inertia: Any
    bond_blocks: Any
    bond_nodes: Any
    bond_offsets: Any
    bond_params: Dict[str, Any]


def _like(cell: BlochCell) -> dict:
    cnv = cell.centroid_node_vectors
    return dict(dtype=cnv.dtype, device=cnv.device)


def reciprocal_basis(direct_basis: torch.Tensor) -> torch.Tensor:
    """Rows b_i with b_i . a_j = 2 pi delta_ij."""

    return 2.0 * math.pi * torch.linalg.inv(torch.as_tensor(direct_basis)).T


def _node_dof(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Node DOFs (ux, uy, theta) of one node of a rigid block (``q (...,
    3)``, node vector ``r (..., 2)``): ``ops.kinematics``' map."""

    c, s = torch.cos(q[..., 2]), torch.sin(q[..., 2])
    dx = q[..., 0] + (c - 1.0) * r[..., 0] - s * r[..., 1]
    dy = q[..., 1] + s * r[..., 0] + (c - 1.0) * r[..., 1]
    return torch.stack([dx, dy, q[..., 2]], dim=-1)


def _per_bond_params(bond_params: Dict[str, Any], n_bonds: int):
    """Split keywords into per-bond tensors (leading axis n_bonds) and
    shared values (anything else), the JAX package's convention: a shared
    array whose leading dimension happens to be n_bonds must be
    broadcast to an explicit ``(n_bonds, ...)`` array."""

    per_bond, shared = {}, {}
    for name, value in bond_params.items():
        if isinstance(value, (torch.Tensor, np.ndarray)) and value.ndim >= 1 \
                and value.shape[0] == n_bonds:
            per_bond[name] = torch.as_tensor(value)
        else:
            shared[name] = value
    return per_bond, shared


def _bond_geometry(cell: BlochCell, u0: torch.Tensor, F: torch.Tensor):
    """Each bond's end node vectors ``r1, r2 (n_bonds, 2)``, its ends'
    block DOFs ``q1, q2 (n_bonds, 3)`` (the far end translated by the
    affine shift ``(F - I) R_m``) and ``R_m (n_bonds, 2)``."""

    like = dict(dtype=u0.dtype, device=u0.device)
    R_m = cell.bond_offsets.to(**like) @ torch.as_tensor(cell.direct_basis, **like)
    affine_shift = R_m @ (F - torch.eye(2, **like)).T
    cnv = cell.centroid_node_vectors
    b, n = cell.bond_blocks, cell.bond_nodes
    r1 = cnv[b[:, 0], n[:, 0]]
    r2 = cnv[b[:, 1], n[:, 1]]
    q1 = u0[b[:, 0]]
    q2 = u0[b[:, 1]] + torch.cat([affine_shift, affine_shift.new_zeros(affine_shift.shape[0], 1)],
                                 dim=1)
    return r1, r2, q1, q2, R_m


def _state(cell: BlochCell, displacement, affine):
    like = _like(cell)
    B = cell.centroid_node_vectors.shape[0]
    u0 = torch.zeros((B, 3), **like) if displacement is None \
        else torch.as_tensor(displacement, **like)
    F = torch.eye(2, **like) if affine is None else torch.as_tensor(affine, **like)
    return u0, F


def bond_hessians(cell: BlochCell, bond_energy_fn: Callable = ligament_energy,
                  displacement: Optional[torch.Tensor] = None,
                  affine: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(n_bonds, 6, 6)`` Hessians of each bond energy with respect to its
    two blocks' DOFs, about a cell-periodic state: ``displacement (B, 3)``
    (default undeformed) under a homogeneous deformation gradient
    ``affine`` (blocks in cell m translated by ``(F - I) R_m``; the Bloch
    phases keep the reference lattice)."""

    u0, F = _state(cell, displacement, affine)
    n_bonds = int(cell.bond_blocks.shape[0])
    r1, r2, q1_0, q2_0, _ = _bond_geometry(cell, u0, F)
    per_bond, shared = _per_bond_params(cell.bond_params, n_bonds)

    def energy(dq, q1_b, q2_b, r1_b, r2_b, pb):
        d1 = _node_dof(q1_b + dq[:3], r1_b)
        d2 = _node_dof(q2_b + dq[3:], r2_b)
        return bond_energy_fn((d1, d2), **pb, **shared)

    def one(q1_b, q2_b, r1_b, r2_b, pb):
        return torch.func.hessian(energy)(q1_b.new_zeros(6), q1_b, q2_b, r1_b, r2_b, pb)

    return torch.func.vmap(one)(q1_0, q2_0, r1, r2, per_bond)


def cell_strain_energy(cell: BlochCell, displacement: torch.Tensor,
                       affine: Optional[torch.Tensor] = None,
                       bond_energy_fn: Callable = ligament_energy):
    """Total bond energy of one cell for cell-periodic block DOFs
    ``displacement (B, 3)`` under a homogeneous deformation gradient
    ``affine`` (bonds crossing the cell boundary see the affine shift of
    their far end, as in :func:`bond_hessians`)."""

    u, F = _state(cell, displacement, affine)
    n_bonds = int(cell.bond_blocks.shape[0])
    r1, r2, q1, q2, _ = _bond_geometry(cell, u, F)
    per_bond, shared = _per_bond_params(cell.bond_params, n_bonds)
    return torch.sum(bond_energy_fn((_node_dof(q1, r1), _node_dof(q2, r2)), **per_bond,
                                    **shared))


def relax_cell(cell: BlochCell, affine: Optional[torch.Tensor] = None,
               bond_energy_fn: Callable = ligament_energy, u0: Optional[torch.Tensor] = None,
               n_newton_steps: int = 40, tol: Optional[float] = None,
               n_load_steps: int = 4) -> torch.Tensor:
    """Cell-periodic static equilibrium ``(B, 3)`` under a prescribed
    affine prestrain: the micro-displacement that relaxes
    :func:`cell_strain_energy` at fixed ``affine`` (e.g. the alternating
    rotations of a compressed rotated-square lattice).

    Block 0's two translations are pinned (the periodic energy's null
    space). Differentiable with respect to ``affine`` and the cell's tensors
    through an implicit adjoint (one transposed solve). ``n_load_steps``
    ramps the deformation in warm-started increments, only the last of
    which carries gradients. A stalled Newton returns NaN."""

    like = _like(cell)
    B = int(cell.centroid_node_vectors.shape[0])
    n = 3 * B
    mask = torch.ones(n, **like)
    mask[:2] = 0.0

    def residual(u_flat, cell_, F):
        grad_u = torch.func.grad(
            lambda uu: cell_strain_energy(cell_, uu.reshape(B, 3), F, bond_energy_fn))(u_flat)
        return grad_u * mask

    def jac(u_flat, cell_, F):
        J = torch.func.jacfwd(residual)(u_flat, cell_, F)
        return J - torch.diag(1.0 - mask)

    start = torch.zeros(n, **like) if u0 is None \
        else torch.as_tensor(u0, **like).reshape(-1) * mask
    eff_tol = tol if tol is not None else default_tol(start.dtype)

    def newton(cell_, F, u_init):
        u, rnorm, _ = newton_solve(lambda x: residual(x, cell_, F), lambda x: jac(x, cell_, F),
                                   u_init, eff_tol, n_newton_steps, 30)
        ok = rnorm < 10 * eff_tol and bool(torch.isfinite(u).all())
        return u if ok else torch.full_like(u, float("nan"))

    class _Solve(torch.autograd.Function):
        @staticmethod
        def forward(ctx, leaves: TensorLeaves, u_init, *tensors):
            cell_, F = leaves.rebuild(tensors)
            u_star = newton(cell_, F, u_init)
            ctx.leaves = leaves
            ctx.save_for_backward(u_star, *tensors)
            return u_star

        @staticmethod
        def backward(ctx, cotangent):
            u_star, *tensors = ctx.saved_tensors
            leaves = ctx.leaves
            with torch.enable_grad():
                cell_, F = leaves.rebuild(tensors)
                lam = torch.linalg.solve(jac(u_star, cell_, F).T, cotangent.reshape(-1) * mask)
                _, vjp = torch.func.vjp(
                    lambda *xs: residual(u_star, *leaves.rebuild(xs)), *tensors)
                grads = vjp(-lam)
            # The equilibrium does not depend on its warm start.
            return (None, torch.zeros_like(u_star)) + tuple(grads)

    def solve(cell_, F, u_init):
        leaves = TensorLeaves((cell_, F))
        return _Solve.apply(leaves, u_init, *leaves.tensors)

    F = torch.eye(2, **like) if affine is None else torch.as_tensor(affine, **like)
    eye = torch.eye(2, **like)
    u = start
    for s in np.linspace(0.0, 1.0, max(1, int(n_load_steps)) + 1)[1:-1]:
        F_s = eye + float(s) * (F.detach() - eye)
        u = solve(cell, F_s, u).detach()
    return solve(cell, F, u).reshape(B, 3)


def _dynamical_matrices(cell: BlochCell, hessians: torch.Tensor, phase: torch.Tensor,
                        diagonal: bool = True) -> torch.Tensor:
    """``(n_k, 3B, 3B)`` matrices assembled from the bond Hessians with the
    off-diagonal blocks weighted by ``phase (n_k, n_bonds)`` (and its
    conjugate); ``diagonal=False`` leaves out the intra-block terms (a
    derivative in k)."""

    B = cell.centroid_node_vectors.shape[0]
    n_k = phase.shape[0]
    i, j = cell.bond_blocks[:, 0], cell.bond_blocks[:, 1]
    H = hessians.to(phase.dtype)  # (n_bonds, 6, 6)
    parts = [(i * B + j, H[None, :, :3, 3:] * phase[:, :, None, None]),
             (j * B + i, H[None, :, 3:, :3] * torch.conj(phase)[:, :, None, None])]
    if diagonal:
        parts = [(i * B + i, torch.broadcast_to(H[None, :, :3, :3], (n_k,) + H[:, :3, :3].shape)),
                 (j * B + j, torch.broadcast_to(H[None, :, 3:, 3:], (n_k,) + H[:, 3:, 3:].shape))
                 ] + parts
    D = torch.zeros((B * B, n_k, 3, 3), dtype=phase.dtype, device=phase.device)
    for index, values in parts:
        D = D.index_add(0, index, values.transpose(0, 1))
    return D.reshape(B, B, n_k, 3, 3).permute(2, 0, 3, 1, 4).reshape(n_k, 3 * B, 3 * B)


def _phases(cell: BlochCell, ks: torch.Tensor, dtype):
    like = dict(dtype=dtype, device=ks.device)
    R_m = cell.bond_offsets.to(**like) @ torch.as_tensor(cell.direct_basis, **like)
    return torch.exp(1j * (ks.to(dtype) @ R_m.T)), R_m


def _ks(cell: BlochCell, ks) -> torch.Tensor:
    ks = torch.as_tensor(ks, **_like(cell))
    return ks.reshape(1, 2) if ks.dim() == 1 else ks


def dynamical_matrix(cell: BlochCell, hessians: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Hermitian ``(3B, 3B)`` Bloch dynamical matrix at wave vector ``k``."""

    phase, _ = _phases(cell, _ks(cell, k), hessians.dtype)
    return _dynamical_matrices(cell, hessians, phase)[0]


def band_structure(cell: BlochCell, ks: torch.Tensor, bond_energy_fn: Callable = ligament_energy,
                   displacement: Optional[torch.Tensor] = None,
                   affine: Optional[torch.Tensor] = None, with_modes: bool = False):
    """Eigenvalues omega^2 ``(n_k, 3B)``, ascending per k, over Cartesian
    wave vectors ``ks (n_k, 2)``; with ``with_modes`` also the
    mass-orthonormal Bloch modes ``(n_k, 3B, 3B)`` (complex; ``modes[...,
    :, n]`` the n-th eigenvector in block-DOF coordinates)."""

    H = bond_hessians(cell, bond_energy_fn, displacement=displacement, affine=affine)
    ks = _ks(cell, ks)
    inv_sqrt_m = 1.0 / torch.sqrt(torch.as_tensor(cell.inertia).reshape(-1))
    phase, _ = _phases(cell, ks, H.dtype)
    A = _dynamical_matrices(cell, H, phase) * inv_sqrt_m[:, None] * inv_sqrt_m[None, :]
    if with_modes:
        w, Y = torch.linalg.eigh(A)
        return w, Y * inv_sqrt_m[:, None]
    return torch.linalg.eigvalsh(A)


def group_velocity(cell: BlochCell, ks: torch.Tensor, bond_energy_fn: Callable = ligament_energy,
                   displacement: Optional[torch.Tensor] = None,
                   affine: Optional[torch.Tensor] = None,
                   omega_floor: float = 1e-9) -> Tuple[torch.Tensor, torch.Tensor]:
    """Band group velocities ``d omega / d k`` by Hellmann-Feynman: ``d
    omega^2_n / d k_a = y_n^H (dA/dk_a) y_n`` with ``dD/dk_a`` assembled
    analytically. Returns ``(omega (n_k, 3B), v_g (n_k, 3B, 2))``; bands
    below ``omega_floor`` report zero velocity, and per-band velocities are
    ill-defined at degeneracies."""

    H = bond_hessians(cell, bond_energy_fn, displacement=displacement, affine=affine)
    ks = _ks(cell, ks)
    inv_sqrt_m = 1.0 / torch.sqrt(torch.as_tensor(cell.inertia).reshape(-1))
    scale = inv_sqrt_m[:, None] * inv_sqrt_m[None, :]
    phase, R_m = _phases(cell, ks, H.dtype)
    A = _dynamical_matrices(cell, H, phase) * scale
    w, Y = torch.linalg.eigh(A)
    omega = torch.sqrt(torch.clamp(w, min=0.0))
    vg = []
    for alpha in (0, 1):
        dA = _dynamical_matrices(cell, H, 1j * R_m[None, :, alpha] * phase,
                                 diagonal=False) * scale
        dw = torch.real(torch.einsum("kin,kij,kjn->kn", torch.conj(Y), dA, Y))
        vg.append(torch.where(omega > omega_floor,
                              dw / (2.0 * torch.clamp(omega, min=omega_floor)),
                              torch.zeros_like(dw)))
    return omega, torch.stack(vg, dim=-1)


def bz_grid(cell: BlochCell, n1: int, n2: int) -> torch.Tensor:
    """Monkhorst-Pack-style sampling of the first Brillouin zone: ``(n1 *
    n2, 2)`` Cartesian wave vectors at fractional coordinates ``((p +
    1/2)/n1 - 1/2, (q + 1/2)/n2 - 1/2)`` of the reciprocal basis."""

    like = _like(cell)
    b = reciprocal_basis(torch.as_tensor(cell.direct_basis, **like))
    f1 = (torch.arange(n1, **like) + 0.5) / n1 - 0.5
    f2 = (torch.arange(n2, **like) + 0.5) / n2 - 0.5
    F1, F2 = torch.meshgrid(f1, f2, indexing="ij")
    frac = torch.stack([F1.reshape(-1), F2.reshape(-1)], dim=1)
    return frac @ b


def density_of_states(omega_samples: torch.Tensor, omega_grid: torch.Tensor,
                      sigma: float) -> torch.Tensor:
    """Gaussian-smeared density of states of band frequencies sampled over
    the Brillouin zone, normalized per cell (each k-point weighs ``1/n_k``,
    so the integral is the number of bands)."""

    samples = torch.as_tensor(omega_samples)
    om = samples.reshape(-1)
    n_k = samples.shape[0] if samples.dim() > 1 else 1
    grid = torch.as_tensor(omega_grid, dtype=om.dtype, device=om.device)
    z = (grid[:, None] - om[None, :]) / sigma
    g = torch.exp(-0.5 * z * z) / (sigma * math.sqrt(2.0 * math.pi))
    return torch.sum(g, dim=1) / n_k


def frequencies(omega_sq: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """omega from omega^2, the numerically negative zero modes clipped;
    eigenvalues at or below ``eps`` give omega = 0 with a zero gradient
    (sqrt's infinite slope at 0 would otherwise make the gradient NaN)."""

    x = torch.clamp(omega_sq, min=0.0)
    safe = torch.where(x > eps, x, torch.ones_like(x))
    return torch.where(x > eps, torch.sqrt(safe), torch.zeros_like(x))


def high_symmetry_path(corners, n_per_segment: int = 32, device="cuda",
                       dtype=torch.float64):
    """Piecewise-linear k-path through ``corners``: ``(ks (n, 2), cumulative
    arclength (n,), corner arclengths (numpy))`` for band diagrams."""

    corners = np.asarray(corners, dtype=float)
    ks, dist = [], []
    s0 = 0.0
    ticks = [0.0]
    for a, b in zip(corners[:-1], corners[1:]):
        seg = np.linalg.norm(b - a)
        frac = np.linspace(0.0, 1.0, n_per_segment, endpoint=False)
        ks.append(a[None] + frac[:, None] * (b - a)[None])
        dist.append(s0 + frac * seg)
        s0 += seg
        ticks.append(s0)
    ks.append(corners[-1:])
    dist.append(np.array([s0]))
    like = dict(device=device, dtype=dtype)
    return (torch.as_tensor(np.concatenate(ks), **like),
            torch.as_tensor(np.concatenate(dist), **like), np.asarray(ticks))


def supercell(cell: BlochCell, p1: int, p2: int) -> BlochCell:
    """A ``(p1 x p2)`` supercell of ``cell``: its bands at K are the union
    of the primitive bands over the ``p1 * p2`` wave vectors that fold onto
    K. Subcell ``(s1, s2)`` holds blocks ``(s2 * p1 + s1) * B + b``."""

    like = _like(cell)
    B = int(cell.centroid_node_vectors.shape[0])
    blocks = cell.bond_blocks.cpu().numpy()
    nodes = cell.bond_nodes.cpu().numpy()
    offsets = cell.bond_offsets.cpu().numpy().astype(np.int64)
    n_bonds = blocks.shape[0]

    def base(s1, s2):
        return (s2 * p1 + s1) * B

    new_blocks, new_nodes, new_offsets, tile_ids = [], [], [], []
    for s2 in range(p2):
        for s1 in range(p1):
            t1, t2 = s1 + offsets[:, 0], s2 + offsets[:, 1]
            w1, w2 = t1 % p1, t2 % p2
            carry = np.stack([t1 // p1, t2 // p2], axis=1)
            first = base(s1, s2) + blocks[:, 0]
            second = (w2 * p1 + w1) * B + blocks[:, 1]
            new_blocks.append(np.stack([first, second], axis=1))
            new_nodes.append(nodes)
            new_offsets.append(carry)
            tile_ids.append(np.arange(n_bonds))

    tile_ids = torch.as_tensor(np.concatenate(tile_ids), device=like["device"])
    per_bond, shared = _per_bond_params(cell.bond_params, n_bonds)
    new_params = dict(shared)
    for name, arr in per_bond.items():
        new_params[name] = arr[tile_ids]

    reps = p1 * p2
    index = dict(dtype=torch.int64, device=like["device"])
    return BlochCell(
        direct_basis=torch.as_tensor(cell.direct_basis, **like)
        * torch.tensor([[float(p1)], [float(p2)]], **like),
        centroid_node_vectors=cell.centroid_node_vectors.repeat(reps, 1, 1),
        inertia=torch.as_tensor(cell.inertia).repeat(reps, 1),
        bond_blocks=torch.as_tensor(np.concatenate(new_blocks), **index),
        bond_nodes=torch.as_tensor(np.concatenate(new_nodes), **index),
        bond_offsets=torch.as_tensor(np.concatenate(new_offsets), **index),
        bond_params=new_params,
    )


# ---------------------------------------------------------------------------
# Cells of the built-in lattice families
# ---------------------------------------------------------------------------


def _design_like(design, device, dtype) -> dict:
    """The device and dtype of a design tensor, else those asked for."""

    if isinstance(design, torch.Tensor):
        return dict(dtype=design.dtype, device=design.device)
    return dict(dtype=dtype, device=torch.device(device))


def _ligament_params(refs: torch.Tensor, k_stretch, k_shear, k_rot):
    return {"reference_vector": refs, "k_stretch": k_stretch, "k_shear": k_shear,
            "k_rot": k_rot}


def _indices(values, like) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values), dtype=torch.int64, device=like["device"])


def kagome_periodic_cell(shifts: Optional[torch.Tensor] = None,
                         direct_basis: Optional[torch.Tensor] = None, bond_length: float = 0.1,
                         density: float = 1.0, k_stretch=1.0, k_shear=1.0, k_rot=1.0,
                         device="cuda", dtype=torch.float64) -> BlochCell:
    """Unit cell of :class:`KagomePeriodicGeometry` (2 triangular blocks, 3
    bonds a cell); ``shifts (3, 2)`` is the design triple shared by every
    cell (zero by default)."""

    from difflexmm_tpu_torch.geometry.kagome import KagomePeriodicGeometry, _kagome_bond_data

    like = _design_like(shifts, device, dtype)
    kwargs = {} if direct_basis is None else {
        "direct_basis": np.asarray(direct_basis.cpu() if torch.is_tensor(direct_basis)
                                   else direct_basis)}
    geometry = KagomePeriodicGeometry(1, 1, bond_length=bond_length, **kwargs)
    geometry.compute_geometry()
    if shifts is None:
        shifts = torch.zeros((3, 2), **like)
    cnv = geometry.centroid_node_vectors(shifts)  # (2, 3, 2)
    _, _, ref_int, ref_b1, ref_b2 = _kagome_bond_data(1, 1, bond_length)
    # Bonds with the first end in cell (0, 0): internal [b0 n1 -> b1 n0],
    # boundary1 [b0 n0 @ (0,1) -> b1 n2] and boundary2 [b0 n2 @ (1,0) -> b1
    # n1], shifted to the first end's cell.
    return BlochCell(
        direct_basis=torch.as_tensor(geometry.direct_basis, **like),
        centroid_node_vectors=cnv,
        inertia=compute_inertia(cnv, density),
        bond_blocks=_indices([[0, 1], [0, 1], [0, 1]], like),
        bond_nodes=_indices([[1, 0], [0, 2], [2, 1]], like),
        bond_offsets=_indices([[0, 0], [0, -1], [-1, 0]], like),
        bond_params=_ligament_params(torch.as_tensor(np.stack([ref_int, ref_b1, ref_b2]), **like),
                                     k_stretch, k_shear, k_rot),
    )


def rotated_square_cell(angle, spacing: float = 1.0, bond_length: float = 0.1,
                        density: float = 1.0, k_stretch=1.0, k_shear=1.0, k_rot=1.0,
                        device="cuda", dtype=torch.float64) -> BlochCell:
    """Primitive cell of the rotated-square lattice: 2 blocks on the
    oblique basis a1 = s(1, 1), a2 = s(1, -1), 4 bonds a cell; node
    conventions of ``geometry/quad.py`` (0 right, 1 top, 2 left, 3
    bottom)."""

    like = _design_like(angle, device, dtype)
    angle = torch.as_tensor(angle, **like)
    half = (spacing - bond_length) / 2
    quarter_turns = torch.tensor([0.0, 0.5, 1.0, 1.5], **like) * math.pi

    def cnv_for(parity):
        a = parity * angle
        v0 = (half / torch.cos(a)) * torch.stack([torch.cos(a), torch.sin(a)])
        c, s = torch.cos(quarter_turns), torch.sin(quarter_turns)
        return torch.stack([c * v0[0] - s * v0[1], s * v0[0] + c * v0[1]], dim=-1)  # (4, 2)

    cnv = torch.stack([cnv_for(1.0), cnv_for(-1.0)])  # blocks at (0,0), (s,0)
    ref_h = [bond_length, 0.0]
    ref_v = [0.0, bond_length]
    # Right and up neighbours of both blocks on the square grid, indexed on
    # the oblique cell: grid (i+1, j) and (i, j+1) alternate parity.
    return BlochCell(
        direct_basis=spacing * torch.tensor([[1.0, 1.0], [1.0, -1.0]], **like),
        centroid_node_vectors=cnv,
        inertia=compute_inertia(cnv, density),
        bond_blocks=_indices([[0, 1], [1, 0], [0, 1], [1, 0]], like),
        bond_nodes=_indices([[0, 2], [0, 2], [1, 3], [1, 3]], like),
        bond_offsets=_indices([[0, 0], [1, 1], [0, -1], [1, 0]], like),
        bond_params=_ligament_params(torch.tensor([ref_h, ref_h, ref_v, ref_v], **like),
                                     k_stretch, k_shear, k_rot),
    )


def quad_periodic_cell(horizontal_shift: torch.Tensor, vertical_shift: torch.Tensor,
                       spacing: float = 1.0, bond_length: float = 0.1, density: float = 1.0,
                       k_stretch=1.0, k_shear=1.0, k_rot=1.0, device="cuda",
                       dtype=torch.float64) -> BlochCell:
    """Cell of a periodic quad design: ``(p1, p2, 2)`` hinge-shift grids
    read as one period of an infinite design (``QuadGeometry``'s hinge
    conventions; rest bond vectors (l, 0) and (0, l)). ``p1 * p2``
    blocks, 2 bonds a block."""

    like = _design_like(horizontal_shift, device, dtype)
    h = torch.as_tensor(horizontal_shift, **like)
    v = torch.as_tensor(vertical_shift, **like)
    p1, p2 = h.shape[0], h.shape[1]
    if tuple(v.shape[:2]) != (p1, p2):
        raise ValueError("horizontal_shift and vertical_shift must share the same (p1, p2) "
                         f"period, got {tuple(h.shape[:2])} vs {tuple(v.shape[:2])}")

    half = (spacing - bond_length) / 2
    v0s = half * torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]], **like)
    b = np.arange(p1 * p2)
    I, J = b % p1, b // p1  # block id = j * p1 + i

    def at(grid, i, j):
        return grid[_indices(i, like), _indices(j, like)]

    offsets = torch.stack([at(h, (I + 1) % p1, J), at(v, I, (J + 1) % p2), at(h, I, J),
                           at(v, I, J)], dim=1)  # (B, 4, 2)
    ref = v0s[None] + offsets
    cnv = ref - polygon_centroid(ref)[:, None, :]

    right = (J * p1) + (I + 1) % p1
    up = ((J + 1) % p2) * p1 + I
    bond_blocks = np.concatenate([np.stack([b, right], axis=1), np.stack([b, up], axis=1)])
    bond_nodes = np.concatenate([np.tile([[0, 2]], (p1 * p2, 1)),
                                 np.tile([[1, 3]], (p1 * p2, 1))])
    bond_offsets = np.concatenate([np.stack([(I + 1) // p1, np.zeros_like(I)], axis=1),
                                   np.stack([np.zeros_like(J), (J + 1) // p2], axis=1)])
    refs = np.concatenate([np.tile([[bond_length, 0.0]], (p1 * p2, 1)),
                           np.tile([[0.0, bond_length]], (p1 * p2, 1))])
    return BlochCell(
        direct_basis=spacing * torch.tensor([[float(p1), 0.0], [0.0, float(p2)]], **like),
        centroid_node_vectors=cnv,
        inertia=compute_inertia(cnv, density),
        bond_blocks=_indices(bond_blocks, like),
        bond_nodes=_indices(bond_nodes, like),
        bond_offsets=_indices(bond_offsets, like),
        bond_params=_ligament_params(torch.as_tensor(refs, **like), k_stretch, k_shear, k_rot),
    )


def defect_supercell(cell: BlochCell, p1: int, p2: int, defect_cells,
                     **param_overrides) -> BlochCell:
    """``(p1, p2)`` supercell with the bond parameters of chosen subcells
    ``defect_cells`` (``(s1, s2)`` pairs) overridden by ``param_overrides``
    (scalars or per-base-bond arrays): point defects, clusters, patterned
    supercells. Bond ``r * n_bonds + b`` belongs to subcell ``r = s2 * p1 +
    s1``."""

    like = _like(cell)
    n_bonds = int(cell.bond_blocks.shape[0])
    n_sub = p1 * p2
    sc = supercell(cell, p1, p2)
    rows = [(int(s2) % p2) * p1 + (int(s1) % p1) for s1, s2 in defect_cells]
    params = dict(sc.bond_params)
    per_bond_base, shared = _per_bond_params(cell.bond_params, n_bonds)
    for name, value in param_overrides.items():
        current = params.get(name)
        if isinstance(current, torch.Tensor) and current.dim() >= 1 \
                and current.shape[0] == n_sub * n_bonds:
            host = current
        elif name in shared:
            host = torch.broadcast_to(torch.as_tensor(shared[name], **like), (n_sub * n_bonds,))
        elif name in per_bond_base:
            host = per_bond_base[name].repeat((n_sub,) + (1,) * (per_bond_base[name].dim() - 1))
        else:
            raise KeyError(f"unknown bond parameter {name!r}; cell has "
                           f"{sorted(cell.bond_params)}")
        override = torch.broadcast_to(torch.as_tensor(value, dtype=host.dtype,
                                                      device=host.device),
                                      (n_bonds,) + tuple(host.shape[1:]))
        mask = torch.zeros(n_sub * n_bonds, dtype=torch.bool, device=host.device)
        for r in rows:
            mask[r * n_bonds:(r + 1) * n_bonds] = True
        tiled = override.repeat((n_sub,) + (1,) * (override.dim() - 1))
        params[name] = torch.where(mask.reshape((-1,) + (1,) * (host.dim() - 1)), tiled, host)
    return sc._replace(bond_params=params)


def line_defect_cell(cell: BlochCell, period: int, axis: int = 1,
                     defect_index: Optional[int] = None, **param_overrides) -> BlochCell:
    """Supercell with one subcell row's bond parameters overridden: a line
    defect periodic along the other lattice direction. ``supercell(cell, 1,
    period)`` (``axis=1``) or ``supercell(cell, period, 1)`` (``axis=0``),
    the overrides on subcell ``defect_index`` (default: the middle row)."""

    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    mid = period // 2 if defect_index is None else defect_index % period
    if axis == 1:
        return defect_supercell(cell, 1, period, [(0, mid)], **param_overrides)
    return defect_supercell(cell, period, 1, [(mid, 0)], **param_overrides)


def mode_localization(cell: BlochCell, modes: torch.Tensor, period: int) -> torch.Tensor:
    """Per-mode weight fraction on each subcell row of a supercell built by
    :func:`supercell` or :func:`line_defect_cell`: ``(..., period,
    n_modes)`` from mode columns ``(..., 3B*period, n_modes)``; phase
    invariant."""

    m = torch.as_tensor(modes)
    B3 = m.shape[-2] // period
    w = torch.abs(m) ** 2
    w = w / torch.sum(w, dim=-2, keepdim=True)
    shape = w.shape[:-2] + (period, B3) + w.shape[-1:]
    return torch.sum(w.reshape(shape), dim=-2)


def spring_chain_cell(k_stretch: float = 1.0, spacing: float = 1.0, mass: float = 1.0,
                      rot_inertia: float = 1.0, device="cuda",
                      dtype=torch.float64) -> BlochCell:
    """1D monatomic chain of point blocks joined by simple springs, the
    textbook omega^2 = 4 k/m sin^2(k a / 2); use with
    ``bond_energy_fn=ops.bonds.simple_spring_energy``."""

    like = dict(device=torch.device(device), dtype=dtype)
    return BlochCell(
        direct_basis=spacing * torch.eye(2, **like),
        centroid_node_vectors=torch.zeros((1, 1, 2), **like),
        inertia=torch.tensor([[mass, mass, rot_inertia]], **like),
        bond_blocks=_indices([[0, 0]], like),
        bond_nodes=_indices([[0, 0]], like),
        bond_offsets=_indices([[1, 0]], like),
        bond_params={"reference_vector": torch.tensor([[spacing, 0.0]], **like),
                     "k_stretch": k_stretch},
    )
