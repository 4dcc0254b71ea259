"""Inputs for holding the trajectory kernels against their plain version.

Used by ``chip_smoke.py`` and the CUDA-gated tests. Every input is made
from the flagship physics (``models/flagship.py``) or the kagome
configuration's (``models/kagome_config.py``) and a seed, on the device
and in the dtype asked for.
"""

import io
import math
import time

import numpy as np
import torch

from difflexmm_tpu_torch.models import kagome_focusing
from difflexmm_tpu_torch.models.flagship import paper_config
from difflexmm_tpu_torch.models.kagome_config import kagome_config
from difflexmm_tpu_torch.models.quads_focusing import ForwardProblem
from difflexmm_tpu_torch.ops.kernels import core, verlet_grid, verlet_kagome


def small_problem(n1=8, n2=6, n_timepoints=12, n_substeps=4, device="cuda",
                  dtype=torch.float64, method="auto",
                  simulation_time=1.5e-3, guard=None, amplitude_scale=1.0) -> ForwardProblem:
    """The flagship physics on a small lattice, with the pulse sped up to
    fit its short window: 600 Hz with no delay over 1.5 ms, so a substep
    is about as long as the flagship's (34 us at 12 timepoints and 4
    substeps). 8 x 6 is the smallest lattice whose clamped corners stay
    clear of the driven strip. The pulse is violent at that rate (blocks
    turn up to 0.1 rad a substep), so the substep guard fires on most
    substeps; ``amplitude_scale=0.01`` makes the run tame (no substep
    fires under ``guard="auto"``)."""

    cfg = paper_config(method, n_substeps, device, dtype)
    cfg.update(
        n1_blocks=n1, n2_blocks=n2, n_timepoints=n_timepoints,
        damping=np.broadcast_to(cfg["damping"][0], (n1 * n2, 3)),
        loading_rate=600.0, input_delay=0.0, simulation_time=simulation_time, guard=guard,
        amplitude=amplitude_scale * cfg["amplitude"],
    )
    problem = ForwardProblem(**cfg)
    problem.setup()
    return problem


def random_design(problem: ForwardProblem, rng: np.random.Generator, scale=0.05):
    """The 25-degree rotated-square design with every hinge shifted by
    ``scale * N(0, 1)`` (mm)."""

    base = problem.geometry.get_design_from_rotated_square(25 * math.pi / 180)
    return tuple(
        torch.as_tensor(
            x.numpy() + scale * rng.standard_normal(tuple(x.shape)),
            device=torch.device(problem.device), dtype=problem.dtype,
        )
        for x in base
    )


def small_kagome(n1=4, n2=3, n_timepoints=12, n_substeps=4, device="cuda",
                 dtype=torch.float64, method="auto", simulation_time=3.0, guard=None,
                 amplitude_scale=1.0) -> kagome_focusing.ForwardProblem:
    """The kagome configuration's physics on a small lattice: 4 x 3 cells
    (one triangle of the left column driven, one clamped at each corner),
    substeps of 0.0625 s (the configuration's are 0.01 s) over the pulse's
    2 s and one more. The guard fires on some substeps under
    ``guard="auto"``; ``amplitude_scale=0.01`` makes the run tame (none)."""

    cfg = kagome_config(device, dtype, guard, method)
    cfg.update(n1_cells=n1, n2_cells=n2, n_timepoints=n_timepoints, n_substeps=n_substeps,
               simulation_time=simulation_time, n_excited_blocks=1,
               n_blocks_clamped_corner=1, amplitude=amplitude_scale * cfg["amplitude"])
    problem = kagome_focusing.ForwardProblem(**cfg)
    problem.setup()
    return problem


def random_kagome_design(problem, rng: np.random.Generator, scale=0.02):
    """The zero design (the regular kagome) with every hinge shifted by
    ``scale * N(0, 1)`` cell sizes."""

    return tuple(
        torch.as_tensor(scale * rng.standard_normal(tuple(x.shape)),
                        device=torch.device(problem.device), dtype=problem.dtype)
        for x in problem.geometry.zero_design()
    )


def kagome_multistart_problem(device="cuda", dtype=torch.float64) -> kagome_focusing.ForwardProblem:
    """The kagome population workload of ``tools/bench_kagome_multistart.py``
    (:32-54): 12 x 10 cells, 60 timepoints of 10 substeps over 4 s, a pulse
    of amplitude 0.1 at rate 2 on 3 triangles, one clamped per corner."""

    cfg = kagome_config(device, dtype)
    cfg.update(n1_cells=12, n2_cells=10, amplitude=0.1, loading_rate=2.0, n_excited_blocks=3,
               simulation_time=4.0, n_timepoints=60, n_substeps=10, n_blocks_clamped_corner=1)
    problem = kagome_focusing.ForwardProblem(**cfg)
    problem.setup()
    return problem


def batched_args(problem: ForwardProblem, designs, state0=None) -> core.TrajectoryArgs:
    """Trajectory inputs of several designs of one problem, stacked on the
    batch dimension."""

    state0 = problem.state0 if state0 is None else state0
    with torch.no_grad():
        per = [
            problem.solve_dynamics.trajectory_args(
                state0, problem.timepoints, problem.control_params(d)
            )
            for d in designs
        ]
    cat = lambda xs: torch.cat(xs).contiguous()  # noqa: E731
    return core.TrajectoryArgs(
        per[0].spec,
        cat([a.U0 for a in per]), cat([a.V0 for a in per]), cat([a.A0 for a in per]),
        per[0].dts, cat([a.drive for a in per]),
        tuple(cat(list(leaves)) for leaves in zip(*(a.fixed for a in per))),
        tuple(cat(list(tables)) for tables in zip(*(a.micro for a in per))),
        tuple(cat(list(tables)) for tables in zip(*(a.loads for a in per))),
    )


#: Loaded (block, DOF) pairs of the kernel checks on the 8 x 6-quad and the
#: 4 x 3-cell kagome inputs above: one pair named twice (the two add) and
#: one on DOF 0 of block 0, a clamped corner (no effect), beside plain ones.
QUAD_LOAD_PAIRS = ((47, 0), (21, 1), (47, 0), (0, 0), (30, 2))
KAGOME_LOAD_PAIRS = ((23, 0), (9, 1), (23, 0), (0, 0), (14, 2))


def loaded_cases(device="cuda", dtype=torch.float64, seed=7) -> dict:
    """The inputs of the loaded kernel checks (kernel 1L in each of the four
    instantiations), by name: the quad contact probe unguarded and under
    ``guard="auto"``, tame 4 x 3 kagome cells (B = 2, 20 substeps of the
    small problem's length) and the kagome contact probe under
    ``guard="auto"``; and a batch, tame 8 x 6 quads (B = 2, 20 substeps),
    whose stiff flagship ligaments amplify rounding to about 1e-12 of the
    acceleration's scale. Each with :data:`QUAD_LOAD_PAIRS` or
    :data:`KAGOME_LOAD_PAIRS` loaded (:func:`with_loads`)."""

    rng = np.random.default_rng(seed)
    quad = small_problem(n_timepoints=6, simulation_time=1.5e-3 * 5 / 11, device=device,
                         dtype=dtype, amplitude_scale=0.01)
    kagome = small_kagome(n_timepoints=6, simulation_time=3.0 * 5 / 11, device=device,
                          dtype=dtype, amplitude_scale=0.01)
    return {
        "loaded 8x6 tame B=2": with_loads(
            batched_args(quad, [random_design(quad, rng) for _ in range(2)]), QUAD_LOAD_PAIRS),
        "loaded contact probe": with_loads(
            contact_probe(device=device, dtype=dtype)[0], QUAD_LOAD_PAIRS),
        "loaded contact probe auto": with_loads(
            contact_probe(device=device, dtype=dtype, guard="auto")[0], QUAD_LOAD_PAIRS),
        "loaded kagome 4x3 tame B=2": with_loads(
            batched_args(kagome, [random_kagome_design(kagome, rng) for _ in range(2)]),
            KAGOME_LOAD_PAIRS),
        "loaded kagome contact probe auto": with_loads(
            kagome_contact_probe(device=device, dtype=dtype, guard="auto")[0],
            KAGOME_LOAD_PAIRS),
    }


def with_loads(args: core.TrajectoryArgs, pairs, seed=0, scale=0.02) -> core.TrajectoryArgs:
    """``args`` (kernel forward) with external loads on the (block, DOF)
    ``pairs`` (pairs may repeat and name constrained DOFs): a smooth pulse
    ``a_j sin^2(pi s / S)`` over the S substeps (and micro-steps) with
    amplitudes ``a_j`` drawn from ``seed``, sized so that a load alone
    moves a block by about ``scale`` of its corner radius over the run."""

    spec = args.spec
    B, C, n2, n1 = args.U0.shape
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    lattice = verlet_kagome if _is_kagome(args.U0) else verlet_grid
    slots = lattice.plane_slots(pairs[:, 0], pairs[:, 1], n1, n2)
    spec = spec._replace(load_map=core.load_map(slots, (C, n2, n1), args.U0.device))
    like = dict(dtype=args.U0.dtype, device=args.U0.device)
    horizon = float(args.dts.sum()) * spec.n_substeps
    radius = float(args.fixed[0].abs().max())
    mass = float(args.fixed[-3][:, 0].mean())
    amp = scale * radius * mass / horizon**2 * np.random.default_rng(seed).standard_normal(
        (B, len(pairs)))
    amp = torch.as_tensor(amp, **like)

    def table(n_rows):
        s = (torch.arange(n_rows, **like) + 1) / n_rows
        return (torch.sin(math.pi * s)[None, :, None] ** 2 * amp[:, None, :]).contiguous()

    rows = args.drive.shape[1]
    loads = [table(rows)] + [table(m.shape[1]) for m in args.micro]
    return args._replace(spec=spec, loads=tuple(loads))


def _is_kagome(U) -> bool:
    """Kagome states have six channels, quad states three."""

    return U.shape[-3] == 6


def void_angles_planes(U, fixed):
    """The void-angle planes of a state, two per bond family (quad:
    horizontal, vertical; kagome: internal, boundary-1, boundary-2)."""

    if _is_kagome(U):
        return verlet_kagome.kagome_void_angles_planes(U, fixed[0], fixed[1])
    return verlet_grid.quad_void_angles_planes(U, fixed[0], fixed[1])


def contact_energy_of(U, fixed):
    """Contact part of the plane energy: total minus strain."""

    if _is_kagome(U):
        energy, n = verlet_kagome.kagome_grid_energy_planes, 17
    else:
        energy, n = verlet_grid.quad_grid_energy_planes, 13
    with torch.no_grad():
        total = energy(U, *fixed[:n], use_contact=True)
        strain = energy(U, *fixed[:n], use_contact=False)
    return float(total - strain)


def _closing_void(args):
    """Smallest void angle in (-90, 90) degrees at the driven initial state:
    voids that closed past zero, not the ones that wrapped around."""

    mask = args.fixed[-1]
    U = args.U0 * mask + core.drive_planes(args.drive[:, 0], args.spec, args.U0)
    voids = torch.cat([v.flatten() for v in void_angles_planes(U, args.fixed)])
    return float(voids[voids.abs() < math.pi / 2].min())


def _bisect_probe(args_at, target, hi):
    """The rotation in [0, hi] at which the closing voids of ``args_at``
    reach ``target``: ``(args, mag)``."""

    lo = 0.0  # voids open at lo, overlapping at hi
    for _ in range(50):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if _closing_void(args_at(mid)) > target else (lo, mid)
    mag = (lo + hi) / 2
    return args_at(mag), mag


def contact_probe(device="cuda", dtype=torch.float64, n_timepoints=6, n_substeps=4, guard=None):
    """A small lattice whose contact barrier is engaged from the start,
    integrated over 20 us: the barrier's forces are large, and substeps of
    1 us keep the trajectory smooth enough to compare two codes on it.

    Each free block of the 25-degree rotated-square design is turned by
    ``-parity * mag`` (parity = (-1)^(i+j)), the counter-rotating mode that
    closes the 40-degree voids; ``mag`` is bisected so that the closing
    voids sit in the middle of the barrier window [min_angle, cutoff).
    Returns ``(args, mag)``.
    """

    problem = small_problem(n_timepoints=n_timepoints, n_substeps=n_substeps,
                            device=device, dtype=dtype, simulation_time=2e-5, guard=guard)
    design = problem.geometry.get_design_from_rotated_square(
        25 * math.pi / 180, device=device, dtype=dtype
    )
    n1, n2 = problem.n1_blocks, problem.n2_blocks
    I, J = np.meshgrid(np.arange(n1), np.arange(n2), indexing="xy")
    parity = torch.as_tensor(((-1.0) ** (I + J)).reshape(-1), device=device, dtype=dtype)
    target = (problem.min_angle + problem.cutoff_angle) / 2

    def args_at(mag):
        state0 = torch.zeros_like(problem.state0)
        state0[0, :, 2] = -parity * mag
        return batched_args(problem, [design], state0)

    return _bisect_probe(args_at, target, 35 * math.pi / 180)


def kagome_contact_probe(device="cuda", dtype=torch.float64, n_timepoints=6, n_substeps=4,
                         guard=None):
    """The kagome counterpart of :func:`contact_probe`: the 4 x 3-cell
    lattice of :func:`small_kagome` at the zero design, each free down
    triangle turned by ``+mag`` and each free up triangle by ``-mag``, the
    twisting mode that closes the 120-degree voids at the internal bonds.
    ``mag`` is bisected so that the closing voids sit in the middle of the
    barrier window [min_angle, cutoff). Integrated over 0.05 s in substeps
    of 2.5 ms: under ``guard="auto"`` both guard terms fire. Returns
    ``(args, mag)``."""

    problem = small_kagome(n_timepoints=n_timepoints, n_substeps=n_substeps, device=device,
                           dtype=dtype, simulation_time=0.05, guard=guard)
    design = problem.geometry.zero_design(device=device, dtype=dtype)
    sign = torch.ones(problem.geometry.n_blocks, device=device, dtype=dtype)
    sign[1::2] = -1.0
    target = (problem.min_angle + problem.cutoff_angle) / 2

    def args_at(mag):
        state0 = torch.zeros_like(problem.state0)
        state0[0, :, 2] = sign * mag
        return batched_args(problem, [design], state0)

    return _bisect_probe(args_at, target, 75 * math.pi / 180)


def guard_terms(args: core.TrajectoryArgs):
    """The plain guarded body on ``args`` with its guard traced: ``(outputs
    of core.plain_trajectory, summary)``. The summary counts the substeps
    that fired (decisions), those beyond the hard term, those that fired
    by the proximity term alone and those whose predicate needed the gap,
    and gives the travel/threshold ratio closest to 1 over all substeps and
    the smallest gap/proximity ratio where the gap was needed (how near a
    decision came to flipping).
    """

    guard, trace = args.spec.guard, []
    outs = core.plain_trajectory(args.U0, args.V0, args.A0, args.dts, args.drive, args.fixed,
                                 args.spec, args.micro, args.loads, trace=trace)
    decisions = outs[4]
    travel = torch.stack([t for t, _ in trace], dim=1)
    gap = torch.stack([g for _, g in trace], dim=1)
    beyond = ~(travel <= guard["hard"]) if guard["hard"] is not None \
        else torch.zeros_like(decisions)
    # Substeps whose predicate needed the gap (the kernel reduces it only there).
    needed = ~(travel <= guard["threshold"]) & ~beyond & (gap != float("inf"))
    gaps = int(needed.sum()) if guard["proximity"] is not None else 0
    ratio = (travel / guard["threshold"]).flatten()
    closest = ratio[torch.argmin(ratio.log().abs())]
    gap_ratio = float("nan")
    if gaps:
        gap_ratio = float((gap / guard["proximity"])[needed].min())
    return outs, dict(fired=int(decisions.sum()), substeps=decisions.numel(),
                      fired_hard=int((decisions & beyond).sum()),
                      fired_proximity=int((decisions & ~beyond).sum()), gaps=gaps,
                      closest_ratio=float(closest), closest_gap_ratio=gap_ratio)


# Operations of one trajectory kernel, counted from csrc/verlet_common.cuh
# and the lattice's file: adds, multiplies and divides, and each sqrt, sin,
# cos and atan2 as one. A dual number carries 6 partials, so a dual add
# costs 7, a dual product or quotient 19, a dual sin or cos 8-9 and a dual
# atan2 29. A bond costs the same on both lattices (bond_energy).
OPS_BOND = 36 + 112 + 389 + 94  # block kinematics, 2 corners, ligament, void check
OPS_BOND_CONTACT = 766  # dual void angles and two barrier terms, engaged bonds only
OPS_DOF = 25  # position update, gather of <= 4 partials, velocity update
OPS_TRAVEL_PER_BLOCK = 38  # guard: theta term and two neighbour differences of x, y
OPS_GAP_PER_BOND = 75  # guard: 6 corners, 2 void angles, min
# Kagome: a DOF gathers <= 3 partials; a cell's travel is two theta terms,
# two neighbour differences of each of 4 translation planes and 2
# within-cell differences (6 + 8 each).
OPS_DOF_KAGOME = 24
OPS_TRAVEL_PER_CELL_KAGOME = 2 * 6 + 10 * 8
H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA H100 SXM data sheet
H100_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}  # outside the tensor cores


def trajectory_bound(args: core.TrajectoryArgs, outU, summary=None) -> dict:
    """The least time an H100 could take for the trajectory of ``args``
    (quad or kagome): the larger of its bytes over the memory rate and its
    operations over the peak rate of its type. Each input is read once and
    each output (U, V, A at every interval boundary; guarded, the decisions
    and flags) written once. The data-dependent work counts what this run
    needs: contact bonds engaged at the interval boundaries of ``outU``
    (the kernel's U output, times the substeps of an interval) and,
    guarded (``summary``: :func:`guard_terms`' for these inputs), guard gaps
    only where the predicate needs them and micro-steps and their drive
    rows only where the guard fired."""

    spec = args.spec
    B, C, n2, n1 = args.U0.shape
    itemsize = args.U0.element_size()
    ncell = n1 * n2
    if _is_kagome(args.U0):
        nbond = ncell + (n2 - 1) * n1 + n2 * (n1 - 1)
        ops_dof, ops_travel, cmin_leaf = OPS_DOF_KAGOME, OPS_TRAVEL_PER_CELL_KAGOME, 14
    else:
        nbond = n2 * (n1 - 1) + (n2 - 1) * n1
        ops_dof, ops_travel, cmin_leaf = OPS_DOF, OPS_TRAVEL_PER_BLOCK, 10
    n_int = args.dts.shape[0]
    n_steps = n_int * spec.n_substeps
    steps = n_steps
    inputs = [args.U0, args.V0, args.A0, args.dts, args.drive, *args.fixed]
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    nbytes += 4 * C * ncell  # the int32 drive map
    nbytes += 3 * B * n_int * C * ncell * itemsize  # outputs U, V, A
    ops = 0
    if summary is not None:
        refine = spec.guard["refine"]
        steps += summary["fired"] * (refine - 1)
        nbytes += B * (n_steps + n_int)  # decisions and flags, a byte each
        nbytes += summary["fired"] * refine * args.drive.shape[-1] * itemsize
        ops += B * n_steps * ops_travel * ncell
        ops += summary["gaps"] * OPS_GAP_PER_BOND * nbond
    with torch.no_grad():
        engaged = 0
        cmin = args.fixed[cmin_leaf].flatten()
        ccut = args.fixed[cmin_leaf + 1].flatten()
        for b in range(B):
            voids = void_angles_planes(outU[b], tuple(f[b] for f in args.fixed[:2]))
            on = [(v >= cmin[b]) & (v < ccut[b]) for v in voids]
            bond_on = torch.cat([(on[k] | on[k + 1]).flatten(1) for k in range(0, len(on), 2)], 1)
            engaged += int(bond_on.sum()) * spec.n_substeps
    if spec.load_map is not None:
        k_load = spec.load_map.pairs.shape[0]
        nbytes += args.loads[0].numel() * itemsize  # the substep load table
        nbytes += 4 * C * ncell  # the int32 load map
        if summary is not None:
            nbytes += summary["fired"] * spec.guard["refine"] * k_load * B * itemsize
        # Each loaded pair's value added to its slot, and each loaded slot's
        # sum to the force.
        ops += steps * B * (k_load + spec.load_map.slots.shape[0])
    ops += steps * B * (nbond * OPS_BOND + C * ncell * ops_dof) + engaged * OPS_BOND_CONTACT
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FLOPS[args.U0.dtype] * 1e3
    return dict(bytes=nbytes, ops=ops, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def kernel_force(args: core.TrajectoryArgs):
    """The force ``-mask * dE/dU_eff`` at ``args.U0`` and drive row 0, as the
    trajectory kernel computes it: one substep from rest with unit inertia
    and no damping leaves ``U1 = U0`` and ``A1 = F * mask = F``."""

    spec = args.spec._replace(n_substeps=1)
    fixed = args.fixed[:-3] + (
        torch.ones_like(args.fixed[-3]), torch.zeros_like(args.fixed[-2]), args.fixed[-1]
    )
    zero = torch.zeros_like(args.U0)
    loads = tuple(t[:, :1].contiguous() for t in args.loads[:1])
    _, _, outA = spec.forward(
        args.U0, zero, zero, args.dts[:1].contiguous(),
        args.drive[:, :1].contiguous(), fixed, spec, (), loads,
    )
    return outA[:, 0]


def plain_force(args: core.TrajectoryArgs):
    """The same force through autograd of the plain energy."""

    return core.force(args.U0, args.drive[:, 0], args.fixed, args.spec,
                      load_row=args.loads[0][:, 0] if args.loads else None)


def cast(args: core.TrajectoryArgs, dtype) -> core.TrajectoryArgs:
    """The same trajectory inputs in another floating dtype."""

    return args._replace(
        **{k: getattr(args, k).to(dtype) for k in ("U0", "V0", "A0", "dts", "drive")},
        fixed=tuple(f.to(dtype) for f in args.fixed),
        micro=tuple(m.to(dtype) for m in args.micro),
        loads=tuple(t.to(dtype) for t in args.loads),
    )


def prefix(args: core.TrajectoryArgs, n_intervals: int) -> core.TrajectoryArgs:
    """The first ``n_intervals`` output intervals of an unguarded
    trajectory's inputs."""

    if args.spec.guard is not None:
        raise ValueError("prefix: unguarded trajectories only")
    rows = n_intervals * args.spec.n_substeps
    return args._replace(dts=args.dts[:n_intervals].contiguous(),
                         drive=args.drive[:, :rows].contiguous(),
                         loads=tuple(t[:, :rows].contiguous() for t in args.loads))


def on_cpu(args: core.TrajectoryArgs) -> core.TrajectoryArgs:
    """A CPU copy of ``args`` whose forward is the plain body, so that
    another process can hold a kernel's run against its plain version on
    the same inputs (no CUDA tensor, no kernel wrapper)."""

    loads = args.spec.load_map
    spec = args.spec._replace(forward=core.plain_trajectory,
                              drive_slots=args.spec.drive_slots.cpu(),
                              drive_cols=args.spec.drive_cols.cpu(),
                              load_map=None if loads is None else loads.to("cpu"))
    return core.TrajectoryArgs(
        spec, *(getattr(args, k).detach().cpu() for k in ("U0", "V0", "A0", "dts", "drive")),
        tuple(f.detach().cpu() for f in args.fixed), tuple(m.detach().cpu() for m in args.micro),
        tuple(t.detach().cpu() for t in args.loads))


def to_bytes(obj) -> bytes:
    """``obj`` (tensors, NamedTuples, functions by reference) as bytes,
    for a pipe between processes: no shared memory."""

    buffer = io.BytesIO()
    torch.save(obj, buffer)
    return buffer.getvalue()


def from_bytes(data: bytes):
    """The object that :func:`to_bytes` wrote."""

    return torch.load(io.BytesIO(data), weights_only=False)


def plain_reference(args_bytes: bytes, traced: bool = False) -> bytes:
    """The plain body on ``to_bytes(on_cpu(args))``, in this process on one
    thread: ``to_bytes((outputs of core.plain_trajectory, milliseconds,
    guard summary))``; guarded and ``traced``, through :func:`guard_terms`
    (else the summary is None)."""

    torch.set_num_threads(1)
    args = from_bytes(args_bytes)
    t0 = time.perf_counter()
    if traced:
        outs, summary = guard_terms(args)
    else:
        outs, summary = core.plain_trajectory(*args[1:7], args.spec, args.micro, args.loads), None
    return to_bytes((outs, (time.perf_counter() - t0) * 1e3, summary))


def max_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""

    return float((a - b).abs().max() / b.abs().max())
