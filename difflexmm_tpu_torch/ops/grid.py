"""Quad-grid bond data (counterpart of ``split_grid_bond_data`` in
``difflexmm_tpu/ops/grid.py``; the dense grid energy is ROADMAP A3)."""

import torch


def _grid_bond_params(value, n1: int, n2: int):
    """Split scalar-or-(n_bonds,) stiffness into (horizontal, vertical) grids."""

    value = torch.as_tensor(value)
    if value.ndim == 0:
        return value, value
    n_h = (n1 - 1) * n2
    return value[:n_h].reshape(n2, n1 - 1), value[n_h:].reshape(n2 - 1, n1)


def split_grid_bond_data(bond_params, n1: int, n2: int):
    """(ref_h, ref_v, ks_h, ks_v, ksh_h, ksh_v, kr_h, kr_v) grids from a
    LigamentParams whose bond arrays follow the general connectivity order
    (all horizontal bonds n2-major, then all vertical)."""

    n_h = (n1 - 1) * n2
    ref = torch.as_tensor(bond_params.reference_vector)
    if ref.ndim == 1:
        ref_h = ref_v = ref
    else:
        ref_h = ref[:n_h].reshape(n2, n1 - 1, 2)
        ref_v = ref[n_h:].reshape(n2 - 1, n1, 2)
    ks_h, ks_v = _grid_bond_params(bond_params.k_stretch, n1, n2)
    ksh_h, ksh_v = _grid_bond_params(bond_params.k_shear, n1, n2)
    kr_h, kr_v = _grid_bond_params(bond_params.k_rot, n1, n2)
    return ref_h, ref_v, ks_h, ks_v, ksh_h, ksh_v, kr_h, kr_v
