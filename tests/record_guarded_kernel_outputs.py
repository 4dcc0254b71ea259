"""Outputs of the guarded trajectory kernels at one guard level on a CUDA
device, recorded so that a later build of the kernels can be held against
them bit for bit (``tests/test_torch_cuda_kernels.py``,
``test_one_level_kernels_equal_the_recorded_parent_kernels``).

    python tests/record_guarded_kernel_outputs.py [PACKAGE_DIR] [OUT]

builds the trajectory sources of ``PACKAGE_DIR`` (another commit's
``difflexmm_tpu_torch``, unpacked whole, for instance by ``git archive REV
difflexmm_tpu_torch | tar -x -C build/parent``; default: this repository's),
runs them through this repository's wrappers on :func:`cases` at float64
and float32, and writes every output (U, V, A, flags, decisions) to ``OUT``
(default :data:`DATA`). The file in the repository was recorded from the
kernels of the commit before the guarded kernels walked deeper guards, on
an NVIDIA H100 80GB HBM3.
"""

import ctypes
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from difflexmm_tpu_torch import kernel_checks as kc  # noqa: E402
from difflexmm_tpu_torch.ops.kernels import build, core, launch  # noqa: E402

DATA = REPO / "tests" / "data" / "guarded_levels1_kernels.npz"


def cases(device) -> dict:
    """label -> float64 inputs at one guard level (``guard="auto"``): two
    violent 8 x 6 quad designs in one launch, violent 4 x 3 kagome cells,
    and the quad and kagome contact probes with loads (guarded 1L)."""

    rng = np.random.default_rng(12)
    quads = kc.small_problem(device=device, guard="auto")
    kagome = kc.small_kagome(device=device, guard="auto")
    loaded = kc.loaded_cases(device=device)
    return {
        "quad 8x6 auto B=2": kc.batched_args(quads, [kc.random_design(quads, rng)
                                                     for _ in range(2)]),
        "kagome 4x3 auto": kc.batched_args(kagome, [kc.random_kagome_design(kagome, rng)]),
        "loaded contact probe auto": loaded["loaded contact probe auto"],
        "loaded kagome contact probe auto": loaded["loaded kagome contact probe auto"],
    }


def outputs(device) -> dict:
    """``"<case> <dtype>"`` -> the kernel's outputs on :func:`cases`."""

    out = {}
    for label, args in cases(device).items():
        for dtype in (torch.float64, torch.float32):
            with torch.no_grad():
                out[f"{label} {str(dtype)[6:]}"] = core.trajectory_forward(kc.cast(args, dtype))
    return out


def use_package(package: Path):
    """Build the trajectory sources of ``package`` and route the wrappers to
    them (as ``difflexmm_tpu_torch.kernel_ab`` does)."""

    for src in build.BY_TYPE:
        target = build.BUILD_DIR / "record" / f"lib{src}.so"
        target.parent.mkdir(parents=True, exist_ok=True)
        build.compile_source(package / "csrc" / f"{src}.cu", target, True)
        build._LIBS[src] = launch.type_library(ctypes.CDLL(str(target)), src)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("record_guarded_kernel_outputs: no CUDA device")
    if len(sys.argv) > 1:
        use_package(Path(sys.argv[1]))
    path = Path(sys.argv[2]) if len(sys.argv) > 2 else DATA
    recorded = {f"{label} {i}": x.cpu().numpy()
                for label, outs in outputs(torch.device("cuda")).items()
                for i, x in enumerate(outs)}
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **recorded)
    print(f"{path}: {len(recorded)} arrays")
