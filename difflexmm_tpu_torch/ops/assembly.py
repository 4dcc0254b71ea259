"""Energy assembly over the static bond list, and energy composition
(counterpart of ``difflexmm_tpu/ops/assembly.py``).

The strain energy is the sum of per-bond energies evaluated on the node
DOFs gathered at the two ends of every bond.
"""

from typing import Callable

import torch

from difflexmm_tpu_torch.ops.bonds import ligament_energy_linearized
from difflexmm_tpu_torch.ops.kinematics import block_to_node_kinematics


def strain_energy_bond(bond_connectivity, bond_energy_fn: Callable = ligament_energy_linearized):
    """Lift a per-bond energy to a total over a set of bonds: ``fn(node_DOFs
    (n_nodes, 3), **bond_params) -> scalar``."""

    bonds = torch.as_tensor(bond_connectivity, dtype=torch.int64)

    def total_bond_energy(node_DOFs: torch.Tensor, **bond_params):
        ends = bonds.to(node_DOFs.device)
        d1 = node_DOFs[ends[:, 0]]
        d2 = node_DOFs[ends[:, 1]]
        return torch.sum(bond_energy_fn((d1, d2), **bond_params))

    return total_bond_energy


def build_strain_energy(bond_connectivity, bond_energy_fn: Callable = ligament_energy_linearized):
    """Total strain energy ``strain_energy_fn(block_displacement (n_blocks,
    3), control_params)``."""

    bond_sum = strain_energy_bond(bond_connectivity, bond_energy_fn)

    def strain_energy_fn(block_displacement: torch.Tensor, control_params):
        cnv = control_params.geometrical_params.centroid_node_vectors
        bond_params = control_params.mechanical_params.bond_params
        n_blocks, n_npb, _ = cnv.shape
        node_DOFs = block_to_node_kinematics(block_displacement, cnv).reshape(
            n_blocks * n_npb, 3
        )
        return bond_sum(node_DOFs, **bond_params._asdict())

    return strain_energy_fn


def combine_block_energies(*energy_fns: Callable):
    """Sum several ``(block_displacement, control_params) -> scalar``
    energies."""

    def combined(block_displacement: torch.Tensor, control_params):
        total = block_displacement.new_zeros(())
        for fn in energy_fns:
            total = total + fn(block_displacement, control_params)
        return total

    return combined


def constrain_energy(energy_fn: Callable, constrained_kinematics: Callable):
    """``E(free_DOFs, t, control_params)``: the energy composed with the
    driven-constraint kinematics, so that its gradient with respect to
    ``free_DOFs`` vanishes on the constrained DOFs (the mask is part of the
    kinematics)."""

    def constrained_energy_fn(free_DOFs, t, control_params):
        return energy_fn(
            constrained_kinematics(free_DOFs, t, control_params.constraint_params),
            control_params,
        )

    return constrained_energy_fn
