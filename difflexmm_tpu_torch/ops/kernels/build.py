"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with nvcc
into ``build/kernels/lib<name>-<hash>.so`` beside the package (the hash is
of the source, the headers of ``csrc/`` and the flags, so an edited source
or header rebuilds), then loaded with ``ctypes``. The trajectory sources
(:data:`BY_TYPE`) are compiled once per type, float32 and float64 at the
same time, and linked into one library. Building happens at first use,
never at import: the CPU tests import every module on machines without
nvcc.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: Sources whose C interface (``VERLET_C_INTERFACE`` in
#: ``csrc/verlet_common.cuh``) splits by ``-DVERLET_TYPE``: 4 compiles the
#: float32 kernels and the common functions, 8 the float64 kernels.
BY_TYPE = ("verlet_quad", "verlet_kagome")

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


def nvcc_commands(nvcc: str, source: Path, target: Path, by_type: bool) -> tuple:
    """(compile commands, run at the same time; link command or None) that
    build ``source`` into ``target``: one ``nvcc -shared`` of the whole
    source, or one object per type (``-DVERLET_TYPE``) and a link."""

    include = ("-I", str(source.parent))
    if not by_type:
        return [[nvcc, *NVCC_FLAGS, "-shared", *include, "-o", str(target), str(source)]], None
    objects = [target.with_suffix(f".{size}.o") for size in (4, 8)]
    compiles = [[nvcc, *NVCC_FLAGS, f"-DVERLET_TYPE={size}", "-c", *include, "-o", str(obj),
                 str(source)] for size, obj in zip((4, 8), objects)]
    return compiles, [nvcc, "-shared", "-o", str(target), *map(str, objects)]


def compile_source(source: Path, target: Path, by_type: bool = False) -> dict:
    """Compile one ``.cu`` file (whole, or by type: :func:`nvcc_commands`)
    into the shared library ``target`` with :data:`NVCC_FLAGS`; returns
    ``{"seconds", "log"}`` (the log holds ptxas' register and spill
    report)."""

    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    compiles, link = nvcc_commands(_nvcc(), source, tmp, by_type)

    def run(cmd):
        result = subprocess.run(cmd, capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {source.name} (exit {result.returncode}):\n"
                f"{' '.join(cmd)}\n{result.stdout}\n{result.stderr}"
            )
        return result.stdout + result.stderr

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(compiles)) as pool:
        log = "".join(pool.map(run, compiles))
    if link is not None:
        log += run(link)
        for cmd in compiles:
            os.remove(cmd[cmd.index("-o") + 1])
    seconds = time.perf_counter() - t0
    os.replace(tmp, target)
    return {"seconds": seconds, "log": log}


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
    BUILD_INFO[name] = compile_source(source, target, name in BY_TYPE)
    return target


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""

    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]


def ptxas_usage(build_log: str, name: str = "verlet_quad") -> dict:
    """``{(dtype, *flags): {"registers", "stack", "spill_stores",
    "spill_loads"}}`` (bytes but registers) of the instantiations of the
    kernel template ``<name>_kernel<T, bool..., int...>`` (the trajectory
    kernels: LIN, CONTACT, GUARD, then the block's threads; the force
    kernel's bond pass ``quad_bond``: LIN, CONTACT), from ptxas' report in a
    build log."""

    out, current, frame = {}, None, {}
    kernel = re.compile(name + r"_kernelI([fd])((?:L[bi]\d+E)+)")
    for line in build_log.splitlines():
        m = kernel.search(line)
        if m and "Compiling entry function" in line:
            current = ({"f": "float32", "d": "float64"}[m.group(1)],) + tuple(
                int(g) for g in re.findall(r"L[bi](\d+)E", m.group(2)))
            frame = {"stack": 0, "spill_stores": 0, "spill_loads": 0}
        f = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if f and current is not None:
            frame = dict(zip(("stack", "spill_stores", "spill_loads"), map(int, f.groups())))
        r = re.search(r"Used (\d+) registers", line)
        if r and current is not None:
            out[current] = {"registers": int(r.group(1)), **frame}
            current = None
    return out
