"""The ctypes launch of a hand-written trajectory kernel.

Each lattice's kernel (``csrc/verlet_quad.cu``, ``csrc/verlet_kagome.cu``)
exports the same C interface, ``<prefix>_launch``,
``<prefix>_scratch_bytes``, ``<prefix>_max_smem``,
``<prefix>_block_threads`` and ``<prefix>_error_string``
(``csrc/verlet_common.cuh``). This module checks a launch's arguments,
allocates its outputs and calls it; the lattice's wrapper
(``verlet_grid.verlet_quad_trajectory``,
``verlet_kagome.verlet_kagome_trajectory``) routes CPU tensors to the plain
body; :func:`run` counts its launches on the wrapper.
"""

import ctypes

import torch

from difflexmm_tpu_torch.ops.kernels import core


def type_library(lib, prefix: str):
    """Set the ctypes signatures of a loaded kernel library."""

    if not getattr(lib, "_typed", False):
        launch = getattr(lib, f"{prefix}_launch")
        launch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ctypes.c_void_p,
        ]
        launch.restype = ctypes.c_int
        scratch = getattr(lib, f"{prefix}_scratch_bytes")
        scratch.argtypes = [ctypes.c_int] * 3
        scratch.restype = ctypes.c_longlong
        max_smem = getattr(lib, f"{prefix}_max_smem")
        max_smem.argtypes = []
        max_smem.restype = ctypes.c_longlong
        error_string = getattr(lib, f"{prefix}_error_string")
        error_string.argtypes = [ctypes.c_int]
        error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def carry_bytes(lib, prefix: str, n1: int, n2: int, dtype) -> tuple:
    """(bytes of carry one design needs, bytes of shared memory a block of
    the current CUDA device may use). The kernel keeps the carry in shared
    memory when it fits and in a global workspace otherwise."""

    itemsize = torch.empty((), dtype=dtype).element_size()
    available = getattr(lib, f"{prefix}_max_smem")()
    if available < 0:
        raise RuntimeError(f"{prefix}: cannot query the device's shared memory")
    return getattr(lib, f"{prefix}_scratch_bytes")(n1, n2, itemsize), available


def block_threads(lib, prefix: str, B: int, dtype, guarded: bool) -> int:
    """Threads of a block of the launch of ``B`` designs of ``dtype`` on the
    current CUDA device, as the kernel's launch picks them
    (``block_threads`` in ``csrc/verlet_common.cuh``; one design a block),
    guarded at one level; a deeper guard's kernel takes the guarded block
    for few designs (``GuardThreads<T>::kFew``) at any B."""

    itemsize = torch.empty((), dtype=dtype).element_size()
    query = getattr(lib, f"{prefix}_block_threads")
    query.argtypes = [ctypes.c_int] * 3
    query.restype = ctypes.c_int
    threads = query(B, itemsize, int(guarded))
    if threads < 0:
        raise RuntimeError(f"{prefix}: cannot query the device's SMs")
    return threads


#: A wrapper's launch counters, by (guarded, loaded).
COUNTERS = {(False, False): "launches", (True, False): "guarded_launches",
            (False, True): "loaded_launches", (True, True): "loaded_guarded_launches"}


def counter(spec) -> str:
    """The name of the launch counter a launch with ``spec`` adds to."""

    return COUNTERS[(spec.guard is not None, spec.load_map is not None)]


def reset_counts(wrapper):
    """Set every launch counter of a kernel wrapper to 0."""

    for name in COUNTERS.values():
        setattr(wrapper, name, 0)


#: The deepest guard the kernels take (``kMaxLevels`` in
#: ``csrc/verlet_common.cuh``): at refine >= 2 a micro-step table of that
#: depth would hold more rows than the kernels' 64-bit row indices reach.
MAX_LEVELS = 64


def guard_params(guard, theta_channels, prefix: str):
    """The resolved guard as the kernel's ten doubles: threshold,
    has_proximity, proximity, has_hard, hard, has_length_scale,
    length_scale, refine, relative translation, levels."""

    if tuple(guard["theta_channels"]) != tuple(theta_channels):
        raise ValueError(f"{prefix} guard: theta must be plane channels {tuple(theta_channels)}")
    if not 1 <= guard["levels"] <= MAX_LEVELS:
        raise ValueError(f"{prefix} guard: levels={guard['levels']}, the kernel takes 1 to "
                         f"{MAX_LEVELS}")
    values = []
    for key in ("proximity", "hard", "length_scale"):
        values += [guard[key] is not None, guard[key] or 0.0]
    values = [guard["threshold"], *values, guard["refine"], guard["translation"] == "relative",
              guard["levels"]]
    return (ctypes.c_double * 10)(*(float(v) for v in values))


def run(lib, prefix: str, wrapper, U0, V0, A0, dts, drive, fixed, spec, micro, loads=(), *,
        linearized, use_contact, drive_map, fixed_shapes, theta_channels):
    """Launch the kernel of ``lib`` on CUDA tensors: ``(B, C, n2, n1)``
    initial state, ``(T-1,)`` substep sizes, ``(B, (T-1) * n_sub, k)`` drive
    table, the fixed leaves (``fixed_shapes``, the design batch leading)
    and, guarded, the ``spec.n_micro`` micro-step tables, table ``d``
    ``(B, (T-1) * n_sub * refine**d, k)``; with ``spec.load_map``, the load
    tables ``(B, rows, k_load)`` (the substep table and, guarded, one
    micro-step table a depth), which the kernel gets summed into their
    slots (``core.slot_loads``) with ``spec.load_map.columns``. Returns
    ``(outU, outV, outA)``, each ``(B, T-1, C, n2, n1)``, and guarded also
    the per-interval flags ``(B, T-1)``, the per-substep decisions ``(B,
    (T-1) * n_sub)`` and the ``spec.n_deep`` decision tables of the
    micro-steps of depths 1 ... levels - 1, each indexed as that depth's
    micro-step table's rows and False where a micro-step did not run
    (bool). Raises on what the kernel does not take. ``fixed_shapes`` ends
    with the mask planes' ``(B, C, n2, n1)``, which the state must match. A
    launch adds one to ``wrapper``'s counter (:func:`counter`)."""

    guard = None if spec.guard is None else guard_params(spec.guard, theta_channels, prefix)
    dtype = U0.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{prefix}_trajectory: dtype {dtype} (float32/float64 only)")
    B, C, n2, n1 = fixed_shapes[-1]  # the mask planes: the state's shape
    n_sub = spec.n_substeps
    n_int = dts.shape[0]
    k_drive = drive.shape[-1]
    k_load = 0 if spec.load_map is None else spec.load_map.pairs.shape[0]
    tensors = (U0, V0, A0, dts, drive, *fixed, *micro, *loads)
    expected = ((B, C, n2, n1),) * 3 + ((n_int,), (B, n_int * n_sub, k_drive))
    expected += tuple(fixed_shapes)
    # Rows of the substep tables, then of each depth's micro-step tables.
    refine = 1 if guard is None else spec.guard["refine"]
    rows = tuple(n_int * n_sub * refine ** d for d in range(1 + spec.n_micro))
    expected += tuple((B, r, k_drive) for r in rows[1:])
    expected += tuple((B, r, k_load) for r in rows) if k_load else ()
    if (len(fixed) != len(fixed_shapes) or k_drive < 1 or len(micro) != spec.n_micro
            or len(loads) != spec.n_loads):
        raise ValueError(f"{prefix}_trajectory: malformed arguments")
    for i, (t, shape) in enumerate(zip(tensors, expected)):
        if t.device != U0.device or t.dtype != dtype:
            raise ValueError(f"argument {i}: {t.device}/{t.dtype}, want {U0.device}/{dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"argument {i}: shape {tuple(t.shape)}, want contiguous {shape}")
    for name, index in (("drive_map", drive_map),
                        ("load_map", None if k_load == 0 else spec.load_map.columns)):
        if index is not None and (index.device != U0.device or index.dtype != torch.int32
                                  or tuple(index.shape) != (C, n2, n1)
                                  or not index.is_contiguous()):
            raise ValueError(f"{prefix}_trajectory: {name} must be contiguous int32 "
                             f"({C}, n2, n1)")
    # One column per loaded slot: pairs naming one slot are summed here.
    slot_tables = tuple(core.slot_loads(t, spec.load_map).contiguous() for t in loads)

    itemsize = U0.element_size()
    with torch.cuda.device(U0.device):
        outs = tuple(torch.empty((B, n_int, C, n2, n1), dtype=dtype, device=U0.device)
                     for _ in range(3))
        if guard is not None:
            outs += (torch.empty((B, n_int), dtype=torch.bool, device=U0.device),
                     torch.empty((B, rows[0]), dtype=torch.bool, device=U0.device))
            # The kernel writes the micro-steps that ran; the others stay False.
            outs += tuple(torch.zeros((B, r), dtype=torch.bool, device=U0.device)
                          for r in rows[1:-1])
        scratch, max_smem = carry_bytes(lib, prefix, n1, n2, dtype)
        workspace = None
        if scratch > max_smem:
            workspace = torch.empty(B * scratch // itemsize, dtype=dtype, device=U0.device)
        pointers = [t.data_ptr() for t in (U0, V0, A0, dts, drive, drive_map, *fixed, *outs[:3])]
        pointers.append(workspace.data_ptr() if workspace is not None else None)
        # The guarded and the load pointers of depth 1 have fixed places
        # (None where absent): a library that knows no loads, or one level,
        # reads only the first ones. Those of the deeper levels follow.
        pointers += [micro[0].data_ptr(), outs[4].data_ptr(), outs[3].data_ptr()] \
            if guard is not None else [None] * 3
        pointers += [slot_tables[0].data_ptr(),
                     slot_tables[1].data_ptr() if guard is not None else None,
                     spec.load_map.columns.data_ptr()] if k_load else [None] * 3
        if spec.n_micro > 1:
            pointers += [t.data_ptr() for t in micro[1:]]
            pointers += [t.data_ptr() for t in slot_tables[2:]] if k_load \
                else [None] * (spec.n_micro - 1)
            pointers += [t.data_ptr() for t in outs[5:]]
        ptrs = (ctypes.c_void_p * len(pointers))(*pointers)
        n_slots = spec.load_map.slots.shape[0] if k_load else 0
        dims = (ctypes.c_int * 7)(B, n1, n2, n_int, n_sub, k_drive, n_slots)
        stream = torch.cuda.current_stream(U0.device).cuda_stream
        err = getattr(lib, f"{prefix}_launch")(
            ptrs, dims, itemsize, int(linearized), int(use_contact), guard, stream
        )
    if err != 0:
        message = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{prefix} launch failed: {message} ({err})")
    name = counter(spec)
    setattr(wrapper, name, getattr(wrapper, name) + 1)
    return outs
