"""difflexmm_tpu_torch: the PyTorch / CUDA port of difflexmm_tpu.

The same rigid-block metamaterial physics (quads joined by elastic
ligaments, angle-based contact barrier, velocity-Verlet dynamics with a
stored-boundary-state adjoint), written in PyTorch for an NVIDIA H100.
Every Pallas kernel of the JAX package becomes a kernel written by hand
for Hopper (``csrc/``); each kernel keeps a plain PyTorch version of the
same math beside it, which runs for tensors on the CPU.

Module paths mirror ``difflexmm_tpu`` so that each counterpart is easy to
find. This package imports ``torch`` and numpy, never ``jax``.
"""

__version__ = "0.1.0"

from difflexmm_tpu_torch.utils.types import (  # noqa: F401
    ContactParams,
    ControlParams,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
    SolutionData,
)
