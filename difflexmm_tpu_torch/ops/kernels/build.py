"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with nvcc
into ``build/kernels/lib<name>-<hash>.so`` beside the package (the hash is
of the source, the headers of ``csrc/`` and the flags, so an edited source
or header rebuilds), then loaded with ``ctypes``. Building happens at first use, never at import: the CPU tests
import every module on machines without nvcc.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS = {}

#: name -> {"seconds": build seconds (0.0 when the library was already
#: built), "log": nvcc's output (ptxas register and spill report)}.
BUILD_INFO = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of difflexmm_tpu_torch are built from source at first use."
    )


def compile_source(source: Path, target: Path) -> dict:
    """Compile one ``.cu`` file into the shared library ``target`` with
    :data:`NVCC_FLAGS`; returns ``{"seconds", "log"}`` (the log holds
    ptxas' register and spill report)."""

    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    result = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if result.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {source.name} (exit {result.returncode}):\n"
            f"{' '.join(cmd)}\n{result.stdout}\n{result.stderr}"
        )
    os.replace(tmp, target)
    return {"seconds": seconds, "log": result.stdout + result.stderr}


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""

    source = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    target = BUILD_DIR / f"lib{name}-{digest}.so"
    if target.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
        return target
    BUILD_INFO[name] = compile_source(source, target)
    return target


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""

    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]


def ptxas_registers(build_log: str, name: str = "verlet_quad") -> dict:
    """``{(dtype, *flags): registers}`` of the instantiations of the kernel
    template ``<name>_kernel<T, bool...>`` (the trajectory kernels: LIN,
    CONTACT, GUARD; the force kernel's bond pass ``quad_bond``: LIN,
    CONTACT), from ptxas' report in a build log."""

    out, current = {}, None
    kernel = re.compile(name + r"_kernelI([fd])((?:Lb[01]E)+)")
    for line in build_log.splitlines():
        m = kernel.search(line)
        if m and "Compiling entry function" in line:
            current = ({"f": "float32", "d": "float64"}[m.group(1)],) + tuple(
                int(g) for g in re.findall(r"Lb([01])E", m.group(2)))
        r = re.search(r"Used (\d+) registers", line)
        if r and current is not None:
            out[current] = int(r.group(1))
            current = None
    return out
