"""Shared building blocks of the models layer (counterpart of
``difflexmm_tpu/models/base.py``): boundary-condition index builders, the
model guard, the raised-cosine pulse, the fabrication constraints and
dict (de)serialization.
"""

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from difflexmm_tpu_torch.geometry.edges import compute_block_angles, compute_edge_angles
from difflexmm_tpu_torch.geometry.polygon import compute_edge_lengths
from difflexmm_tpu_torch.ops.assembly import build_strain_energy, combine_block_energies
from difflexmm_tpu_torch.ops.bonds import ligament_energy, ligament_energy_linearized
from difflexmm_tpu_torch.ops.contact import build_contact_energy
from difflexmm_tpu_torch.utils.types import SolutionData


def all_dofs_pairs(block_ids: np.ndarray) -> np.ndarray:
    """[block, DOF] pairs covering all 3 DOFs of the given blocks: all DOF-0
    pairs, then DOF-1, then DOF-2."""

    block_ids = np.asarray(block_ids).reshape(-1)
    return np.stack(
        [np.tile(block_ids, 3), np.repeat(np.arange(3), len(block_ids))], axis=1
    )


def driven_side_pairs(
    n1_blocks: int,
    n2_blocks: int,
    n_excited_blocks: int,
    loaded_side: str,
    input_shift: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Constrained pairs for a driven strip of edge blocks, centred (plus
    ``input_shift``) on the chosen side; all three DOFs are constrained,
    the side-normal translation is driven and the other two are pinned.

    Returns (pairs (3k, 2), drive_mask (3k,)): drive_mask is 1 on the
    driven DOF entries, 0 on the pinned ones.
    """

    k = n_excited_blocks
    if loaded_side in ("left", "right"):
        rows = np.arange((n2_blocks - k) // 2 + input_shift,
                         (n2_blocks + k) // 2 + input_shift)
        col = 0 if loaded_side == "left" else n1_blocks - 1
        blocks = rows * n1_blocks + col
        dof_order = [0, 1, 2]  # drive x
    elif loaded_side in ("bottom", "top"):
        cols = np.arange((n1_blocks - k) // 2 + input_shift,
                         (n1_blocks + k) // 2 + input_shift)
        row = 0 if loaded_side == "bottom" else n2_blocks - 1
        blocks = row * n1_blocks + cols
        dof_order = [1, 0, 2]  # drive y
    else:
        raise ValueError(
            f"Unknown loaded_side: {loaded_side!r}; expected left/right/bottom/top."
        )
    pairs = np.stack([np.tile(blocks, 3), np.repeat(dof_order, k)], axis=1)
    drive_mask = np.zeros(3 * k)
    drive_mask[:k] = 1.0
    return pairs, drive_mask


def corner_block_ids(n1_blocks: int, n2_blocks: int, n_clamped: int) -> np.ndarray:
    """Blocks forming the four L-shaped clamped corners (2n-1 blocks each)."""

    n = n_clamped
    nb = n1_blocks * n2_blocks
    bl = np.concatenate([np.arange(n), np.arange(1, n) * n1_blocks])
    br = np.concatenate(
        [np.arange(n1_blocks - n, n1_blocks), (np.arange(1, n) + 1) * n1_blocks - 1]
    )
    tr = np.concatenate([np.arange(nb - n, nb), nb - 1 - np.arange(1, n) * n1_blocks])
    tl = np.concatenate(
        [np.arange(nb - n1_blocks, nb - n1_blocks + n),
         nb - n1_blocks - np.arange(1, n) * n1_blocks]
    )
    return np.concatenate([bl, br, tr, tl])


def clamped_corner_pairs(n1_blocks: int, n2_blocks: int, n_clamped: int) -> np.ndarray:
    """All-DOF constrained pairs for the four clamped corners."""

    return all_dofs_pairs(corner_block_ids(n1_blocks, n2_blocks, n_clamped))


def check_disjoint_constrained_pairs(**groups: np.ndarray) -> None:
    """Fail loudly when constraint groups claim the same [block, DOF].

    Duplicate constrained pairs resolve last-write-wins, so e.g. a corner
    clamp that overlaps the driven strip would silently zero the drive.
    """

    names = list(groups)
    keysets = {
        name: {(int(b), int(d)) for b, d in np.asarray(pairs).reshape(-1, 2)}
        for name, pairs in groups.items()
    }
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            overlap = keysets[a] & keysets[b]
            if overlap:
                sample = sorted(overlap)[:6]
                raise ValueError(
                    f"Constrained [block, DOF] pairs of '{a}' and '{b}' "
                    f"overlap on {len(overlap)} entries (e.g. {sample}); "
                    "the scatter is last-write-wins, so the earlier group's "
                    "drive would be silently overwritten. Shrink the clamps "
                    "or excited strip (or reduce input_shift) so the groups "
                    "are disjoint."
                )


def target_patch_ids(
    n1_blocks: int,
    n2_blocks: int,
    target_size: Tuple[int, int],
    target_shift: Tuple[int, int],
) -> np.ndarray:
    """Block ids of a centred (shifted) rectangular target patch; i (column)
    outer, j (row) inner."""

    i0 = (n1_blocks - target_size[0]) // 2 + target_shift[0]
    j0 = (n2_blocks - target_size[1]) // 2 + target_shift[1]
    I, J = np.meshgrid(
        np.arange(i0, i0 + target_size[0]),
        np.arange(j0, j0 + target_size[1]),
        indexing="ij",
    )
    return (J * n1_blocks + I).reshape(-1)


def resolve_model_guard(guard, min_angle, cutoff_angle, spacing):
    """A model's ``guard`` field as a solver guard spec (JAX
    ``models/base.py:167-200``).

    ``None`` -> off; ``"auto"`` -> the proximity-gated production spec:
    the travel term fires only within 2 barrier windows of the contact
    cutoff, the hard term at 0.1 window anywhere (force spikes, NaN); the
    window is ``cutoff_angle - min_angle`` and translational travel counts
    at the lattice ``spacing``. A dict passes through with ``window`` and
    ``length_scale`` filled in where absent.
    """

    if guard is None:
        return None
    if guard == "auto":
        guard = {"proximity_windows": 2.0, "hard_fraction": 0.1}
    elif not isinstance(guard, dict):
        raise ValueError(f"guard must be None, 'auto', or a dict; got {guard!r}")
    guard = dict(guard)
    if "threshold" not in guard and "window" not in guard:
        guard["window"] = float(cutoff_angle) - float(min_angle)
    guard.setdefault("length_scale", float(spacing))
    return guard


def dense_energy(build_grid_energy, n1: int, n2: int, bonds, linearized: bool,
                 use_contact: bool, grid_energy: bool):
    """The energy of a model's dense ``method="verlet"`` (JAX
    ``models/quads_focusing.py:149-162``): the lattice's gather-free grid
    energy ``build_grid_energy(n1, n2, bond_energy_fn, use_contact=...)``
    where ``grid_energy``, else the strain energy over the bond list plus,
    with ``use_contact``, the angle-based contact barrier."""

    bond_energy_fn = ligament_energy_linearized if linearized else ligament_energy
    if grid_energy:
        return build_grid_energy(n1, n2, bond_energy_fn, use_contact=use_contact)
    strain_energy = build_strain_energy(bonds, bond_energy_fn)
    if not use_contact:
        return strain_energy
    return combine_block_energies(strain_energy, build_contact_energy(bonds))


def pulse(t, amplitude, loading_rate):
    """Raised-cosine displacement pulse of duration 1/loading_rate."""

    t = torch.as_tensor(t)
    active = (t > 0.0) & (t < 1.0 / loading_rate)
    wave = (1.0 - torch.cos(2.0 * math.pi * loading_rate * t)) / 2.0
    return amplitude * torch.where(active, wave, torch.zeros_like(wave))


# ---------------------------------------------------------------------------
# Fabrication constraints g(design) <= 0
# ---------------------------------------------------------------------------


def quad_boundary_node_ids(n1_blocks: int, n2_blocks: int) -> np.ndarray:
    """Global node ids on the outer boundary of a quad lattice (ccw)."""

    nb = n1_blocks * n2_blocks
    bottom = np.arange(n1_blocks) * 4 + 3
    right = (np.arange(n1_blocks - 1, nb, n1_blocks)) * 4 + 0
    top = (np.arange(nb - 1, nb - n1_blocks - 1, -1)) * 4 + 1
    left = (np.arange(0, nb, n1_blocks)) * 4 + 2
    return np.concatenate([bottom, right, top, left])


def build_angle_constraints(
    centroid_node_vectors_fn,
    bond_connectivity,
    min_void_angle: float,
    min_block_angle: float,
    boundary_node_ids=None,
):
    """Angle constraints on voids and blocks, angles wrapped to [0, 2 pi);
    optionally also on the boundary block wedges."""

    def angle_constraints(design):
        node_vectors = centroid_node_vectors_fn(*design)
        v1, v2, b1, b2 = compute_edge_angles(node_vectors, bond_connectivity)
        parts = [
            min_void_angle - torch.remainder(v1, 2 * math.pi),
            min_void_angle - torch.remainder(v2, 2 * math.pi),
            min_block_angle - torch.remainder(b1, 2 * math.pi),
            min_block_angle - torch.remainder(b2, 2 * math.pi),
        ]
        if boundary_node_ids is not None:
            boundary = compute_block_angles(node_vectors, boundary_node_ids)
            parts.append(min_block_angle - torch.remainder(boundary, 2 * math.pi))
        return torch.cat(parts)

    return angle_constraints


def build_edge_length_constraints(centroid_node_vectors_fn, min_edge_length: float):
    """Edge-length constraints: ``min_edge_length - length`` of every block
    edge, flattened."""

    def edge_length_constraints(design):
        lengths = compute_edge_lengths(centroid_node_vectors_fn(*design))
        return (min_edge_length - lengths).reshape(-1)

    return edge_length_constraints


# ---------------------------------------------------------------------------
# (De)serialization helpers
# ---------------------------------------------------------------------------


def solution_to_dict(solution):
    if solution is None:
        return None
    if isinstance(solution, list):
        return [s._asdict() for s in solution]
    return solution._asdict()


def solution_from_dict(data):
    if data is None:
        return None
    if isinstance(data, list):
        return [SolutionData(**d) for d in data]
    if isinstance(data, dict):
        return SolutionData(**data)
    return data


def problem_to_dict(problem) -> dict:
    """Dataclass -> plain dict with SolutionData converted to dicts."""

    out = dataclasses.asdict(problem)
    if "solution_data" in out:
        out["solution_data"] = solution_to_dict(getattr(problem, "solution_data", None))
    return out


def forward_problem_from_dict(cls, dict_in: dict):
    """Rebuild a ForwardProblem-style dataclass from a dict."""

    data = dict(dict_in)
    if "solution_data" in data:
        data["solution_data"] = solution_from_dict(data["solution_data"])
    problem = cls(**data)
    problem.is_setup = False
    return problem


def problem_to_data(problem):
    """A fresh copy of a problem dataclass, not set up: its fields only
    (lists and dicts copied, nested problems through their own
    ``to_data``), none of the solver state that ``setup`` adds, so that
    :func:`utils.types.save_data` can pickle it."""

    values = {}
    for f in dataclasses.fields(problem):
        if not f.init:
            continue
        value = getattr(problem, f.name)
        if hasattr(value, "to_data"):
            value = value.to_data()
        elif isinstance(value, list):
            value = [x.to_data() if hasattr(x, "to_data") else x for x in value]
        elif isinstance(value, dict):
            value = dict(value)
        values[f.name] = value
    values["is_setup"] = False
    return type(problem)(**values)


def optimization_problem_from_dict(cls, forward_cls, dict_in: dict, **nested):
    """Rebuild an OptimizationProblem-style dataclass from its ``to_dict``:
    ``forward_problem`` (or each of ``forward_problems``) through
    ``forward_cls.from_dict``, and each ``name=dataclass`` of ``nested``
    (e.g. ``forward_input=ForwardInput``) from its dict."""

    data = dict(dict_in)
    if "forward_problem" in data:
        data["forward_problem"] = forward_cls.from_dict(data["forward_problem"])
    if "forward_problems" in data:
        data["forward_problems"] = [forward_cls.from_dict(p) for p in data["forward_problems"]]
    for name, nested_cls in nested.items():
        if isinstance(data.get(name), dict):
            data[name] = nested_cls(**data[name])
    data["is_setup"] = False
    return cls(**data)


def optimization_problem_from_data(problem, forward_cls):
    """An OptimizationProblem-style record (``to_data``, or one loaded with
    ``load_data``) made ready for ``setup_objective``."""

    for fp in getattr(problem, "forward_problems", None) or [problem.forward_problem]:
        forward_cls.from_data(fp)
    problem.is_setup = False
    return problem
