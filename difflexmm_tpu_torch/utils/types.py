"""Parameter containers and the solution container.

Counterpart of ``difflexmm_tpu/utils/types.py``: the same NamedTuples with
the same field names and shapes, holding torch tensors (or Python floats)
instead of jax arrays. Pickle IO is not ported yet (ROADMAP A2).
"""

from typing import Any, Dict, NamedTuple, Optional


class SolutionData(NamedTuple):
    """Dynamic solution bundled with the geometry that produced it.

    Attrs:
        block_centroids: (n_blocks, 2) reference centroids.
        centroid_node_vectors: (n_blocks, n_npb, 2) centroid-to-node vectors.
        bond_connectivity: (n_bonds, 2) node index pairs.
        timepoints: (n_timepoints,) output times.
        fields: (n_timepoints, 2, n_blocks, 3) displacement/velocity history.
    """

    block_centroids: Any
    centroid_node_vectors: Any
    bond_connectivity: Any
    timepoints: Any
    fields: Any


class GeometricalParams(NamedTuple):
    """Differentiable geometry: centroids (n_blocks, 2) and
    centroid-to-node vectors (n_blocks, n_npb, 2)."""

    block_centroids: Any
    centroid_node_vectors: Any


class LigamentParams(NamedTuple):
    """Ligament bonds: scalar or (n_bonds,) stiffnesses and the
    (n_bonds, 2) or shared (2,) reference bond vectors."""

    k_stretch: Any
    k_shear: Any
    k_rot: Any
    reference_vector: Any


class ContactParams(NamedTuple):
    """Parameters of the C^1 angle-based contact barrier."""

    min_angle: Any
    cutoff_angle: Any
    k_contact: Any


class MechanicalParams(NamedTuple):
    """Bond parameters, density, optional inertia (n_blocks, 3), damping
    (scalar or (n_damped_blocks, 3)) and optional contact parameters."""

    bond_params: LigamentParams
    density: Any
    inertia: Optional[Any] = None
    damping: Any = 0.0
    contact_params: Optional[ContactParams] = None


class ControlParams(NamedTuple):
    """Everything the dynamic solver differentiates through."""

    geometrical_params: GeometricalParams
    mechanical_params: MechanicalParams
    loading_params: Dict = dict()
    constraint_params: Dict = dict()
