"""Parameter containers and the solution container.

Counterpart of ``difflexmm_tpu/utils/types.py``: the same NamedTuples with
the same field names and shapes, holding torch tensors (or Python floats)
instead of jax arrays, and the pickle IO ``save_data`` / ``load_data``.
"""

import dataclasses
import importlib
import pickle
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional, Union

import numpy as np
import torch


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


class EigenmodeData(NamedTuple):
    """Modal solution bundled with the geometry that produced it.

    Attrs:
        block_centroids: (n_blocks, 2) reference centroids.
        centroid_node_vectors: (n_blocks, n_npb, 2) centroid-to-node vectors.
        eigenvalues: (n_modes,) squared angular frequencies.
        fields: (n_modes, n_blocks, 3) mode shapes.
    """

    block_centroids: Any
    centroid_node_vectors: Any
    eigenvalues: Any
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


class StretchingTorsionalSpringParams(NamedTuple):
    """Zero-length stretching and torsional spring bonds: scalar or
    (n_bonds,) stiffnesses."""

    k_stretch: Any
    k_rot: Any


BondParams = Union[LigamentParams, StretchingTorsionalSpringParams]


class ContactParams(NamedTuple):
    """Parameters of the C^1 contact barrier: angles for the angle-based
    barrier, distances for the distance-based one."""

    min_angle: Any
    cutoff_angle: Any
    k_contact: Any


class MagneticParams(NamedTuple):
    """Magnetic dipole parameters: per-block dipole angles ``(n_blocks,
    2)`` (in-plane angle, pitch) and scalar or ``(n_blocks,)`` strengths,
    read by ``ops.magnetic.build_magnetic_energy``."""

    dipole_angles: Any
    dipole_strengths: Any


class MechanicalParams(NamedTuple):
    """Bond parameters, density, optional inertia (n_blocks, 3), damping
    (scalar or (n_damped_blocks, 3)) and optional contact parameters."""

    bond_params: BondParams
    density: Any
    inertia: Optional[Any] = None
    damping: Any = 0.0
    contact_params: Optional[ContactParams] = None


class ControlParams(NamedTuple):
    """Everything the dynamic solver differentiates through."""

    geometrical_params: GeometricalParams
    mechanical_params: MechanicalParams
    magnetic_params: Optional[MagneticParams] = None
    loading_params: Dict = dict()
    constraint_params: Dict = dict()


def _map_arrays(obj, fn, kind):
    """``obj`` with every leaf of type ``kind`` replaced by ``fn(leaf)``,
    through NamedTuples, tuples, lists, dicts and dataclass instances (a
    dataclass's fields are replaced on a shallow copy)."""

    if isinstance(obj, kind):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_arrays(x, fn, kind) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_arrays(x, fn, kind) for x in obj)
    if isinstance(obj, dict):
        return {k: _map_arrays(v, fn, kind) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = object.__new__(type(obj))
        out.__dict__.update({k: _map_arrays(v, fn, kind) for k, v in vars(obj).items()})
        return out
    return obj


def save_data(path_or_filename: Union[str, Path], data: object) -> None:
    """Pickle ``data`` (containers, dicts, lists, dataclass records such as
    a model's ``to_data()``), tensors written as numpy arrays so that the
    file loads without torch on the device; parent directories are made."""

    path = Path(path_or_filename)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = _map_arrays(data, lambda x: x.detach().cpu().numpy(), torch.Tensor)
    with open(path, "wb") as f:
        pickle.dump(data, f)


#: Module prefixes of the packages whose pickles load here: the JAX package
#: and the implementation it was modelled on, with the same container names.
_FOREIGN_PACKAGES = ("difflexmm_tpu", "difflexmm")


class _PortUnpickler(pickle.Unpickler):
    """Maps the containers of ``difflexmm_tpu.*`` and ``difflexmm.*`` onto
    this module's same-named ones (other classes onto the same module path
    under ``difflexmm_tpu_torch``) without importing either package, and
    refuses arrays of JAX, whose classes would import it."""

    def find_class(self, module: str, name: str):
        root = module.split(".", 1)[0]
        if root in ("jax", "jaxlib"):
            raise pickle.UnpicklingError(
                f"the pickle holds {module}.{name} (JAX arrays); save it with numpy arrays "
                "(np.asarray of each array) to load it without JAX"
            )
        if root in _FOREIGN_PACKAGES:
            if name in globals() and isinstance(globals()[name], type):
                return globals()[name]
            try:
                mapped = importlib.import_module("difflexmm_tpu_torch" + module[len(root):])
                return getattr(mapped, name)
            except (ImportError, AttributeError) as err:
                raise pickle.UnpicklingError(
                    f"{module}.{name} has no counterpart in difflexmm_tpu_torch") from err
        return super().find_class(module, name)


def load_data(path_or_filename: Union[str, Path], device="cuda"):
    """Load an object saved with :func:`save_data`, or by the JAX package's
    ``save_data`` with numpy arrays (its classes mapped onto this package's
    same-named ones, JAX never imported). Numeric numpy arrays come back as
    tensors on ``device`` (the CUDA device unless the caller asks for the
    CPU)."""

    with open(path_or_filename, "rb") as f:
        data = _PortUnpickler(f).load()

    def to_tensor(x):
        return torch.as_tensor(x, device=device) if x.dtype.kind in "biufc" else x

    return _map_arrays(data, to_tensor, np.ndarray)
