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
# cos and atan2 as one.
# The quad lattice (csrc/quad_policy.cuh, Quad::bond_term) takes a bond's
# six partials in closed form: the sines and cosines of the two rotations
# (4), the two corners' displacements (18), the nonlinear ligament's
# gradient (2 + 47) and the chain to the rotations (18 + 2 negations), 91
# operations, and the void check (32: four edges at rest, two angles, the
# rotations and the wrap); an engaged void angle adds the barrier's slope
# and its two signed terms (12).
OPS_BOND_QUAD = 4 + 18 + 2 + 47 + 20 + 32
OPS_VOID_CONTACT_QUAD = 12
# The kagome lattice (csrc/verlet_kagome.cu, Kagome::bond_term) takes a
# bond's six partials by the quad's closed form on triangles: the sines and
# cosines (4), the two corners' displacements (18), the ligament's gradient
# (2 + 47), the chain to the rotations (18 + 2) and the void check on the
# void angles at rest (12: each rest angle plus the rotations' difference,
# wrapped), 103 a bond and substep; an engaged void angle adds 12. The void
# angles at rest (four edges, two angles: 22) are taken once a launch
# (Kagome::rest_angles).
OPS_BOND_KAGOME = 4 + 18 + 2 + 47 + 20 + 12
OPS_VOID_CONTACT_KAGOME = 12
OPS_REST_KAGOME = 22
OPS_GATHER = 4  # the force kernel's gather: <= 4 partials summed onto zero
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
H100_SMS = 132  # SMs of the H100 SXM, whose peak rates these are


def trajectory_bound(args: core.TrajectoryArgs, outU, summary=None) -> dict:
    """The least time an H100 could take for the trajectory of ``args``
    (quad or kagome): the larger of its bytes over the memory rate and its
    operations over the peak rate of its type. Each input is read once and
    each output (U, V, A at every interval boundary; guarded, the decisions
    and flags) written once. The data-dependent work counts what this run
    needs: contact terms engaged at the interval boundaries of ``outU``
    (the kernel's U output, times the substeps of an interval;
    :func:`bond_ops`) and,
    guarded (``summary``: :func:`guard_terms`' for these inputs), guard gaps
    only where the predicate needs them and micro-steps and their drive
    rows only where the guard fired.

    ``sm_floor_ms`` is the least time with one design in one SM's share of
    the peak rate (the kernels keep a design in one thread block): the
    larger of the bound and a design's operations over the peak divided by
    the SMs of ``args``' device (:data:`H100_SMS` for CPU tensors)."""

    spec = args.spec
    B, C, n2, n1 = args.U0.shape
    itemsize = args.U0.element_size()
    ncell = n1 * n2
    if _is_kagome(args.U0):
        nbond = ncell + (n2 - 1) * n1 + n2 * (n1 - 1)
        ops_dof, ops_travel = OPS_DOF_KAGOME, OPS_TRAVEL_PER_CELL_KAGOME
    else:
        nbond = n2 * (n1 - 1) + (n2 - 1) * n1
        ops_dof, ops_travel = OPS_DOF, OPS_TRAVEL_PER_BLOCK
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
    ops_bond, contact = bond_ops(outU, args.fixed)
    contact *= spec.n_substeps
    if _is_kagome(args.U0):
        ops += B * nbond * OPS_REST_KAGOME  # once a launch
    if spec.load_map is not None:
        k_load = spec.load_map.pairs.shape[0]
        nbytes += args.loads[0].numel() * itemsize  # the substep load table
        nbytes += 4 * C * ncell  # the int32 load map
        if summary is not None:
            nbytes += summary["fired"] * spec.guard["refine"] * k_load * B * itemsize
        # Each loaded pair's value added to its slot, and each loaded slot's
        # sum to the force.
        ops += steps * B * (k_load + spec.load_map.slots.shape[0])
    ops += steps * B * (nbond * ops_bond + C * ncell * ops_dof) + contact
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FLOPS[args.U0.dtype] * 1e3
    n_sm = (torch.cuda.get_device_properties(args.U0.device).multi_processor_count
            if args.U0.is_cuda else H100_SMS)
    bound_ms = max(bytes_ms, ops_ms)
    return dict(bytes=nbytes, ops=ops, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                sm_floor_ms=max(bound_ms, ops_ms * n_sm / B))


def engaged_voids(U, fixed) -> tuple:
    """``(bonds, voids)``: the bonds with a void angle in the barrier window
    [cmin, ccut) and the void angles in it, summed over the B designs of
    ``U`` (B, ..., C, n2, n1) and any further leading index (states at
    several times)."""

    cmin_leaf = 14 if _is_kagome(U) else 10
    cmin = fixed[cmin_leaf].flatten()
    ccut = fixed[cmin_leaf + 1].flatten()
    bonds = voids = 0
    with torch.no_grad():
        for b in range(U.shape[0]):
            angles = void_angles_planes(U[b], tuple(f[b] for f in fixed[:2]))
            on = [(v >= cmin[b]) & (v < ccut[b]) for v in angles]
            bonds += sum(int((on[k] | on[k + 1]).sum()) for k in range(0, len(on), 2))
            voids += sum(int(o.sum()) for o in on)
    return bonds, voids


def engaged_bonds(U, fixed) -> int:
    """Bonds with a void angle in the barrier window [cmin, ccut), those
    whose contact term the kernels evaluate, summed over the B designs of
    ``U`` and any further leading index (:func:`engaged_voids`)."""

    return engaged_voids(U, fixed)[0]


def bond_ops(U, fixed) -> tuple:
    """``(operations of one bond, operations of the contact terms at U)``
    as the lattice's kernels count them, both in closed form: the quad
    lattice's (:data:`OPS_BOND_QUAD`, :data:`OPS_VOID_CONTACT_QUAD` an
    engaged void angle) and the kagome lattice's
    (:data:`OPS_BOND_KAGOME`, :data:`OPS_VOID_CONTACT_KAGOME`)."""

    _, voids = engaged_voids(U, fixed)
    if _is_kagome(U):
        return OPS_BOND_KAGOME, voids * OPS_VOID_CONTACT_KAGOME
    return OPS_BOND_QUAD, voids * OPS_VOID_CONTACT_QUAD


def force_bound(U_eff, fixed) -> dict:
    """The least time an H100 could take for one quad force of B designs
    with contact (kernel 2, ``verlet_grid.quad_force``) at ``U_eff`` (B, 3,
    n2, n1): the larger of its bytes over the memory rate (U_eff and the 13
    energy leaves read once, the force written once) and its operations
    over the peak rate of its type, counted as :func:`trajectory_bound`
    counts a substep's force: OPS_BOND_QUAD a bond, OPS_VOID_CONTACT_QUAD an
    engaged void angle, OPS_GATHER a state element."""

    B, C, n2, n1 = U_eff.shape
    nbond = n2 * (n1 - 1) + (n2 - 1) * n1
    nbytes = sum(t.numel() * t.element_size() for t in (U_eff, *fixed[:13]))
    nbytes += U_eff.numel() * U_eff.element_size()
    ops_bond, contact = bond_ops(U_eff, fixed)
    ops = B * (nbond * ops_bond + C * n1 * n2 * OPS_GATHER) + contact
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FLOPS[U_eff.dtype] * 1e3
    return dict(bytes=nbytes, ops=ops, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _bond_partials(a, b, ref, stiffness, barrier, linearized):
    """The six partials of bonds joining a corner of block ``a`` (seeds 0-2)
    to a corner of block ``b`` (3-5), as ``Quad::bond_term`` and
    ``Kagome::bond_term`` take them in closed form, line for line: ``(B, 6,
    ...)``. ``a`` and ``b`` are ``(ux, uy, th, (cx, cy) of the bond's
    corner, (x, y) of the corner after it, (x, y) of the corner before
    it)``, ``ref`` the bonds' reference vectors ``(B, 2, ...)``,
    ``stiffness`` ``(ks, ksh, kr)`` and ``barrier`` ``(cmin, ccut, kc)``
    with contact, else None."""

    uxa, uya, tha, (cxa, cya), nxt_a, prv_a = a
    uxb, uyb, thb, (cxb, cyb), nxt_b, prv_b = b
    ks, ksh, kr = stiffness
    sa, ca, sb, cb = torch.sin(tha), torch.cos(tha), torch.sin(thb), torch.cos(thb)
    dxa = uxa + (ca - 1) * cxa - sa * cya
    dya = uya + sa * cxa + (ca - 1) * cya
    dxb = uxb + (cb - 1) * cxb - sb * cyb
    dyb = uyb + sb * cxb + (cb - 1) * cyb
    # ligament_grad
    dUx, dUy, refx, refy = dxb - dxa, dyb - dya, ref[:, 0], ref[:, 1]
    l0sq = refx * refx + refy * refy
    if linearized:
        axial = (dUx * refx + dUy * refy) / l0sq
        shear = (refx * dUy - refy * dUx) / l0sq - (tha + thb) / 2
        gx = ks * axial * refx - ksh * shear * refy
        gy = ks * axial * refy + ksh * shear * refx
    else:
        rx, ry = dUx + refx, dUy + refy
        rr = rx * rx + ry * ry
        stretch = torch.sqrt(rr / l0sq)
        mean = (tha + thb) / 2
        c, s = torch.cos(mean), torch.sin(mean)
        px, py = c * refx - s * refy, s * refx + c * refy
        shear = torch.atan2(px * ry - py * rx, px * rx + py * ry)
        ka = ks * (stretch - 1) / stretch
        kt = ksh * shear * l0sq / rr
        gx, gy = ka * rx - kt * ry, ka * ry + kt * rx
    hs = 0.5 * ksh * shear * l0sq
    rot = kr * (thb - tha)
    ta = (-hs - rot) - (gx * (-sa * cxa - ca * cya) + gy * (ca * cxa - sa * cya))
    tb = (-hs + rot) + (gx * (-sb * cxb - cb * cyb) + gy * (cb * cxb - sb * cyb))
    if barrier is not None:
        # Each void angle: the angle between two edges at rest plus (tha -
        # thb) or (thb - tha), taken into [-pi, pi] (wrap_angle): void 1
        # from b's previous edge to a's next edge, void 2 from a's previous
        # edge to b's next edge.
        (n1x, n1y), (p1x, p1y) = ((x - cxa, y - cya) for x, y in (nxt_a, prv_a))
        (n2x, n2y), (p2x, p2y) = ((x - cxb, y - cyb) for x, y in (nxt_b, prv_b))
        turn = 2 * math.pi
        voids = []
        for rest, rotation in ((torch.atan2(p2x * n1y - p2y * n1x, p2x * n1x + p2y * n1y),
                                tha - thb),
                               (torch.atan2(p1x * n2y - p1y * n2x, p1x * n2x + p1y * n2y),
                                thb - tha)):
            v = rest + rotation
            voids.append(v - turn * torch.round(v * (1 / turn)))
        # barrier_slope where the void angle lies in [cmin, ccut)
        cmin, ccut, kc = barrier
        span = ccut - cmin
        lo = -1 + 64 * torch.finfo(uxa.dtype).eps
        slopes = []
        for v in voids:
            x = (v - ccut) / span
            d = (x - 1) * (x + 1)
            on = (v >= cmin) & (v < ccut) & (x > lo) & (x < 0)
            slopes.append(torch.where(on, kc * span * x / (d * d), torch.zeros_like(x)))
        ta = ta + slopes[0] - slopes[1]
        tb = tb - slopes[0] + slopes[1]
    return torch.stack([-gx, -gy, ta, gx, gy, tb], 1)


def closed_form_partials(U_eff, fixed, linearized=False, use_contact=True):
    """The six partials of every quad bond at ``U_eff`` (B, 3, n2, n1), as
    the kernels take them in closed form (``Quad::bond_term`` of
    ``csrc/quad_policy.cuh``, line for line): ``(B, 6, nbond)``, horizontal
    bonds then vertical, seeds (ux, uy, theta) of the first block, then of
    the second. A test helper: no path of the program runs it."""

    cnv, _, ref_h, ref_v, ks_h, ksh_h, kr_h, ks_v, ksh_v, kr_v, cmin, ccut, kc = fixed[:13]
    B = U_eff.shape[0]
    every = slice(None)
    barrier = (cmin, ccut, kc) if use_contact else None
    families = (
        ((every, slice(None, -1)), (every, slice(1, None)), 0, 2, ref_h, (ks_h, ksh_h, kr_h)),
        ((slice(None, -1), every), (slice(1, None), every), 1, 3, ref_v, (ks_v, ksh_v, kr_v)),
    )
    partials = []
    for at_a, at_b, c1, c2, ref, stiffness in families:
        def block(at, c):
            """(ux, uy, th, corner c, the corner after it, the one before) of
            the blocks at ``at``."""

            ux, uy, th = (U_eff[:, k][(every,) + at] for k in range(3))
            g = [[cnv[:, k, d][(every,) + at] for d in range(2)] for k in range(4)]
            return ux, uy, th, g[c], g[(c + 1) % 4], g[(c + 3) % 4]

        partials.append(_bond_partials(block(at_a, c1), block(at_b, c2), ref, stiffness,
                                       barrier, linearized).reshape(B, 6, -1))
    return torch.cat(partials, -1)


def closed_form_force(U_eff, fixed, linearized=False, use_contact=True):
    """dE/dU_eff (B, 3, n2, n1) from :func:`closed_form_partials`, each
    state element summing its <= 4 bonds in ``Quad::gather``'s order: the
    bond to its left, to its right, below, above."""

    B, _, n2, n1 = U_eff.shape
    P = closed_form_partials(U_eff, fixed, linearized, use_contact)
    nh = n2 * (n1 - 1)
    h = P[..., :nh].reshape(B, 6, n2, n1 - 1)
    v = P[..., nh:].reshape(B, 6, n2 - 1, n1)
    g = torch.zeros_like(U_eff)
    g[..., :, 1:] += h[:, 3:]
    g[..., :, :-1] += h[:, :3]
    g[..., 1:, :] += v[:, 3:]
    g[..., :-1, :] += v[:, :3]
    return g


def kagome_closed_form_partials(U_eff, fixed, linearized=False, use_contact=True):
    """The six partials of every kagome bond at ``U_eff`` (B, 6, n2, n1), as
    the kernels take them in closed form (``Kagome::bond_term`` of
    ``csrc/verlet_kagome.cu``, line for line; the kernels take the void
    angles at rest once a launch, ``Kagome::rest_angles``, by the same
    operations): ``(B, 6, nbond)``, internal
    bonds, then boundary-1, then boundary-2, each n1-fastest; seeds (ux,
    uy, theta) of the down triangle, then of the up triangle. A test
    helper: no path of the program runs it."""

    cnv, _, ref_i, ref_b1, ref_b2 = fixed[:5]
    cmin, ccut, kc = fixed[14:17]
    B = U_eff.shape[0]
    every = slice(None)
    barrier = (cmin, ccut, kc) if use_contact else None
    below, above = (slice(1, None), every), (slice(None, -1), every)
    right, left = (every, slice(1, None)), (every, slice(None, -1))
    # (cells of the down triangle, of the up one, their corners, reference,
    # stiffness leaves); JAX's verlet_kagome.py:167-187.
    families = (
        ((every, every), (every, every), 1, 0, ref_i, fixed[5:8]),
        (below, above, 0, 2, ref_b1, fixed[8:11]),
        (right, left, 2, 1, ref_b2, fixed[11:14]),
    )
    partials = []
    for at_d, at_u, cd, cu, ref, stiffness in families:
        def triangle(tri, at, c):
            """(ux, uy, th, corner c, the corner after it, the one before) of
            triangle ``tri`` (0 down, 1 up) of the cells at ``at``."""

            ux, uy, th = (U_eff[:, 3 * tri + k][(every,) + at] for k in range(3))
            g = [[cnv[:, tri, k, d][(every,) + at] for d in range(2)] for k in range(3)]
            return ux, uy, th, g[c], g[(c + 1) % 3], g[(c + 2) % 3]

        partials.append(_bond_partials(triangle(0, at_d, cd), triangle(1, at_u, cu), ref,
                                       stiffness, barrier, linearized).reshape(B, 6, -1))
    return torch.cat(partials, -1)


def kagome_closed_form_force(U_eff, fixed, linearized=False, use_contact=True):
    """dE/dU_eff (B, 6, n2, n1) from :func:`kagome_closed_form_partials`,
    each state element summing its <= 3 bonds in ``Kagome::gather``'s
    order: internal, boundary-1, boundary-2."""

    B, _, n2, n1 = U_eff.shape
    P = kagome_closed_form_partials(U_eff, fixed, linearized, use_contact)
    nb, nb1 = n1 * n2, (n2 - 1) * n1
    internal = P[..., :nb].reshape(B, 6, n2, n1)
    b1 = P[..., nb:nb + nb1].reshape(B, 6, n2 - 1, n1)
    b2 = P[..., nb + nb1:].reshape(B, 6, n2, n1 - 1)
    g = internal.clone()
    g[:, :3, 1:, :] += b1[:, :3]  # down triangles: b1 of (j - 1, i), b2 of (j, i - 1)
    g[:, :3, :, 1:] += b2[:, :3]
    g[:, 3:, :-1, :] += b1[:, 3:]  # up triangles: b1 and b2 of (j, i)
    g[:, 3:, :, :-1] += b2[:, 3:]
    return g


def lanes_microbench_inputs(B=128, seed=0, n1=24, n2=16, device="cuda", dtype=torch.float32):
    """The inputs of kernel 2's microbenchmark (``make_args`` and
    ``energy`` of ``tools/microbench_lanes_batch.py:46-59``, ``:62-67``),
    made with numpy from ``seed``: a random state of 0.01 on the flagship's
    plane shape, corner vectors +-5 mm with noise 0.1, centroids on a 15 mm
    grid, reference vectors (2, 0) and (0, 2), stiffnesses (120, 1.19, 1.5)
    on both bond families and the barrier (-0.26, -0.17, 1.5); design b is
    scaled by ``1 + 1e-3 b`` (the tool's per-design jitter, ``:115-116``;
    the stiffnesses and the barrier are the tool's constants).
    Returns ``(U_eff (B, 3, n2, n1), the 13 energy leaves)``, each with the
    design batch leading."""

    rng = np.random.default_rng(seed)
    U = 0.01 * rng.standard_normal((3, n2, n1))
    corners = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], dtype=float).reshape(4, 2, 1, 1)
    cnv = 0.1 * rng.standard_normal((4, 2, n2, n1)) + 5.0 * corners
    centroids = np.stack(np.meshgrid(15.0 * np.arange(n1), 15.0 * np.arange(n2)))
    ref_h = np.broadcast_to(np.array([2.0, 0.0])[:, None, None], (2, n2, n1 - 1))
    ref_v = np.broadcast_to(np.array([0.0, 2.0])[:, None, None], (2, n2 - 1, n1))
    jitter = 1 + 1e-3 * np.arange(B)

    def batch(x):
        x = np.asarray(x, dtype=np.float64)
        return torch.as_tensor(x[None] * jitter.reshape((B,) + (1,) * x.ndim), dtype=dtype,
                               device=device).contiguous()

    def constant(x, shape):
        return torch.full((B,) + shape, x, dtype=dtype, device=device)

    h, v = (n2, n1 - 1), (n2 - 1, n1)
    stiffness = [constant(x, h) for x in (120.0, 1.19, 1.5)]
    stiffness += [constant(x, v) for x in (120.0, 1.19, 1.5)]
    barrier = [constant(x, (1, 1)) for x in (-0.26, -0.17, 1.5)]
    return batch(U), tuple(batch(x) for x in (cnv, centroids, ref_h, ref_v)) + tuple(
        stiffness + barrier)


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
