"""Recorded JAX float64 results for the port's parity tests whose JAX side
costs tens of seconds to trace and compile (guarded gradients, the guarded
MMA), so that tier 1 runs only the port against them.

Each set is an ``.npz`` file in ``tests/data/``, made by the JAX package on
the CPU at float64 by a ``slow`` test of the module that uses it: that test
computes the set again and holds it against the file at 1e-12 (or, where
the file is missing, writes it). To make a set again after a change to the
JAX side, delete its file and run the slow test.
"""

import pathlib

import numpy as np

DATA_DIR = pathlib.Path(__file__).resolve().parent / "data"


def stored(name: str) -> dict:
    """The recorded set ``name`` as ``{key: numpy array}``."""

    with np.load(DATA_DIR / f"{name}.npz") as data:
        return {key: data[key] for key in data.files}


def record_or_check(name: str, computed: dict, tol: float = 1e-12) -> None:
    """Hold ``computed`` against the recorded set ``name`` (each key within
    ``tol`` of its scale, the same keys), or record it where there is no
    file yet."""

    computed = {key: np.asarray(value) for key, value in computed.items()}
    path = DATA_DIR / f"{name}.npz"
    if not path.exists():
        DATA_DIR.mkdir(exist_ok=True)
        np.savez_compressed(path, **computed)
    recorded = stored(name)
    assert sorted(recorded) == sorted(computed)
    for key, value in computed.items():
        ref = recorded[key]
        assert value.shape == ref.shape and value.dtype == ref.dtype, key
        if value.dtype == bool:
            assert np.array_equal(value, ref), key
        else:
            scale = max(float(np.max(np.abs(ref))), 1e-300)
            assert float(np.max(np.abs(value - ref))) <= tol * scale, key
