"""Compare another commit's hand-written quad and kagome kernels with the
repository's on one CUDA device: registers and spills, outputs and times.

    python3 -m difflexmm_tpu_torch.kernel_ab DIR

``DIR`` is the other commit's package directory, unpacked whole so that
its headers sit beside its sources, for instance ``git archive REV
difflexmm_tpu_torch | tar -x -C OUT`` and ``DIR = OUT/difflexmm_tpu_torch``.
The trajectory sources ``csrc/verlet_quad.cu`` and ``csrc/verlet_kagome.cu``
and the force source ``csrc/quad_force.cu`` are built from each side
afresh with the same nvcc flags, at the same time (the trajectory sources
by type where the side's ``verlet_common.cuh`` splits by
``VERLET_TYPE``). The other sources must export the same C interface or
an older form of it (the launch's extra arguments, such as the load
pointers, come after the ones an older source reads).

Each version then runs, through the repository's wrappers: the flagship
and the kagome configuration (``models/kagome_config.build_kagome``),
unguarded and guarded (``guard="auto"``); the quad and the kagome contact
probes, unguarded and guarded; the force pulse (kernel 1L); the guarded
flagship and kagome configurations with loads on a few pairs
(``kernel_checks.with_loads``: guarded 1L); each at float64 and float32,
at B = 1. The largest |other - repo| of U, V and A is
printed with the largest |repo| (the field scale), and for the guarded
kernels whether decisions and flags are identical. Kernel 2 runs on the microbenchmark's inputs ((3, 16, 24) x
128, ``kernel_checks.lanes_microbench_inputs``), on the flagship's state
mid-pulse at B = 1 and on the contact probe's state, and its largest
|other - repo| is printed. Last, kernels 1g, 1Kg, 1 and 1K are timed
with CUDA events at B = 1, one design per SM and four per SM, 1K at the
12 x 10-cell kagome population at B = 128
(``kernel_checks.kagome_multistart_problem``, the population of main path
8), 1L at the pulse and guarded 1L at the guarded configurations with
loads at B = 1, and kernel 2 at the microbenchmark's inputs
and at the
flagship's B = 1, each as the replay of a CUDA graph of 20 calls (over
20: the device's time of a call) and as one eager call;
float32 and float64, the versions alternating (other, repo, repo, other,
other, repo), each turn the median of 3 runs (kernel 2: of 30). The last
line of standard output is a JSON object of the results.
"""

import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from difflexmm_tpu_torch import kernel_checks as kc
from difflexmm_tpu_torch.models import flagship as fl
from difflexmm_tpu_torch.models import kagome_config as kg
from difflexmm_tpu_torch.models import loaded_configs as lc
from difflexmm_tpu_torch.ops.kernels import build, core, launch

#: The sources built on both sides; each one's kernel template is
#: ``<source>_kernel``.
SOURCES = ("verlet_quad", "verlet_kagome", "quad_force")
FORCE_REPS = 30
#: Calls of kernel 2 in the CUDA graph that times one call's device time.
FORCE_CALLS = 20


def _event_ms(fn, reps=3):
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _repeated(args, B):
    """One design's trajectory inputs, B times on the batch dimension."""

    rep = lambda x: x.expand(B, *x.shape[1:]).contiguous()  # noqa: E731
    return args._replace(U0=rep(args.U0), V0=rep(args.V0), A0=rep(args.A0),
                         drive=rep(args.drive), fixed=tuple(rep(f) for f in args.fixed),
                         micro=tuple(rep(m) for m in args.micro))


def _graphed(fn):
    """A CUDA graph of :data:`FORCE_CALLS` calls of ``fn``, captured after a
    warm-up on a side stream; returns its replay."""

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(FORCE_CALLS):
            fn()
    return graph.replay


def _force(lib, U, fixed):
    """Kernel 2 of ``lib`` (nonlinear, with contact) at ``U`` (B, 3, n2, n1)
    and the 13 energy leaves."""

    B, _, n2, n1 = U.shape
    out = torch.empty_like(U)
    pointers = [t.data_ptr() for t in [U, *fixed[:13], out]]
    err = lib.quad_force_launch((ctypes.c_void_p * len(pointers))(*pointers),
                                (ctypes.c_int * 3)(B, n1, n2), U.element_size(), 0, 1,
                                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"quad_force launch failed ({err})")
    return out


def _unguarded(args):
    return args._replace(spec=args.spec._replace(guard=None), micro=())


def cases(device) -> dict:
    """label -> (source, float64 inputs at B = 1)."""

    design = fl.build_flagship(device=device)[1]
    guarded = kc.batched_args(fl.build_flagship(device=device, guard="auto")[0].forward_problem,
                              [design])
    kdesign = kg.build_kagome(device=device)[1]
    kguarded = kc.batched_args(kg.build_kagome(device=device, guard="auto")[0].forward_problem,
                               [kdesign])
    probe = kc.contact_probe(device=device, guard="auto")[0]
    kprobe = kc.kagome_contact_probe(device=device, guard="auto")[0]
    solve, control_params, state0, timepoints = lc.pulse_problem(device)
    with torch.no_grad():
        pulse = solve.trajectory_args(state0, timepoints,
                                      control_params(*lc.pulse_inputs(device)))
    return {
        "flagship": ("verlet_quad", _unguarded(guarded)),
        "flagship guarded": ("verlet_quad", guarded),
        "kagome": ("verlet_kagome", _unguarded(kguarded)),
        "kagome guarded": ("verlet_kagome", kguarded),
        "contact probe": ("verlet_quad", _unguarded(probe)),
        "contact probe guarded": ("verlet_quad", probe),
        "kagome contact probe": ("verlet_kagome", _unguarded(kprobe)),
        "kagome contact probe guarded": ("verlet_kagome", kprobe),
        "pulse": ("verlet_quad", pulse),
        # Guarded 1L: the guarded configurations with loads on a few pairs.
        "flagship guarded loaded": ("verlet_quad", kc.with_loads(guarded, kc.QUAD_LOAD_PAIRS)),
        "kagome guarded loaded": ("verlet_kagome", kc.with_loads(kguarded,
                                                                 kc.KAGOME_LOAD_PAIRS)),
    }


def main(other: str):
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    dirs = {"other": Path(other) / "csrc", "repo": build.CSRC_DIR}
    jobs, targets = {}, {}
    with ThreadPoolExecutor(6) as pool:
        for side, csrc in dirs.items():
            by_type = "VERLET_TYPE" in (csrc / "verlet_common.cuh").read_text()
            for src in SOURCES:
                targets[side, src] = build.BUILD_DIR / "ab" / side / f"lib{src}.so"
                jobs[side, src] = pool.submit(build.compile_source, csrc / f"{src}.cu",
                                              targets[side, src],
                                              by_type and src in build.BY_TYPE)
        logs = {key: job.result()["log"] for key, job in jobs.items()}
    usage = {key: build.ptxas_usage(log, key[1]) for key, log in logs.items()}
    print("registers, stack, spill stores and loads (dtype, linearized, contact, guard[, "
          "threads]; kernel 2: dtype, linearized, contact[, tile, threads]): other / repo")
    for src in SOURCES:
        for key in sorted(set(usage["other", src]) | set(usage["repo", src])):
            print(f"  {src} {key}: " + " / ".join(
                str(tuple(u[key].values())) if key in u else "-"
                for u in (usage["other", src], usage["repo", src])))
    libs = {key: ctypes.CDLL(str(t)) for key, t in targets.items()}
    for key, lib in libs.items():
        if key[1] in build.BY_TYPE:
            launch.type_library(lib, key[1])
        else:
            lib.quad_force_launch.restype = ctypes.c_int

    def use(side):
        for src in build.BY_TYPE:
            build._LIBS[src] = libs[side, src]

    device = torch.device("cuda")
    inputs = {}
    for label, (src, args64) in cases(device).items():
        for dt in (torch.float64, torch.float32):
            inputs[f"{label} {str(dt)[6:]}"] = (src, args64 if dt == torch.float64
                                                else kc.cast(args64, dt))
    differences, scales, decisions = {}, {}, {}
    for label, (src, args) in inputs.items():
        outs = {}
        for side in dirs:
            use(side)
            outs[side] = core.trajectory_forward(args)
        differences[label] = max(float((a.double() - b.double()).abs().max())
                                 for a, b in zip(outs["other"][:3], outs["repo"][:3]))
        scales[label] = max(float(b.double().abs().max()) for b in outs["repo"][:3])
        line = (f"{label}: largest |other - repo| {differences[label]!r} (field scale "
                f"{scales[label]!r})")
        if args.spec.guard is not None:
            same = all(torch.equal(a, b) for a, b in zip(outs["other"][3:], outs["repo"][3:]))
            decisions[label] = dict(identical=same, fired=int(outs["repo"][4].sum()))
            line += (f", decisions and flags {'identical' if same else 'DIFFER'} "
                     f"({decisions[label]['fired']} substeps fired)")
        print(line, flush=True)

    flagship = inputs["flagship float64"][1]
    use("repo")
    U = core.trajectory_forward(flagship)[0][:, 20]
    probe = inputs["contact probe float64"][1]
    forces = {
        "microbench B=128": kc.lanes_microbench_inputs(B=128, device=device,
                                                       dtype=torch.float64),
        "flagship B=1": (U * flagship.fixed[-1] + core.drive_planes(
            flagship.drive[:, 200], flagship.spec, U), flagship.fixed[:13]),
        "contact probe": (probe.U0 * probe.fixed[-1] + core.drive_planes(
            probe.drive[:, 0], probe.spec, probe.U0), probe.fixed[:13]),
    }
    for label, (U64, fixed64) in forces.items():
        for dt in (torch.float64, torch.float32):
            U, fixed = U64.to(dt), tuple(f.to(dt) for f in fixed64)
            a, b = (_force(libs[side, "quad_force"], U, fixed) for side in ("other", "repo"))
            key = f"kernel 2 {label} {str(dt)[6:]}"
            differences[key] = float((a.double() - b.double()).abs().max())
            print(f"{key}: largest |other - repo| {differences[key]!r} (field scale "
                  f"{float(b.abs().max())!r})", flush=True)

    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    times = {}

    def turns(key, run):
        """Time ``run(side)`` (ms) in alternating turns and print the medians."""

        for side in ("other", "repo", "repo", "other", "other", "repo"):
            times.setdefault(key, {}).setdefault(side, []).append(run(side))
        by_side = times[key]
        ratio = statistics.median(by_side["repo"]) / statistics.median(by_side["other"])
        print(f"{key}: " + ", ".join(
            f"{side} {statistics.median(ms):.4f} ms {[round(x, 4) for x in ms]}"
            for side, ms in by_side.items()) + f", repo/other {ratio:.4f}", flush=True)

    def trajectory(args):
        """``run(side)`` for :func:`turns`: one warm-up, then the trajectory
        timed."""

        def run(side):
            use(side)
            core.trajectory_forward(args)  # warm up
            return _event_ms(lambda: core.trajectory_forward(args))

        return run

    for label in ("flagship guarded", "kagome guarded", "flagship", "kagome"):
        for dt in ("float32", "float64"):
            src, args1 = inputs[f"{label} {dt}"]
            for B in (1, n_sm, 4 * n_sm):
                args = _repeated(args1, B)
                turns(f"{label} {dt} B={B}", trajectory(args))
                del args
    population = kc.kagome_multistart_problem(device=device)
    designs = [tuple(x + 1e-3 * b for x in population.geometry.zero_design(device=device,
                                                                        dtype=torch.float64))
               for b in range(128)]
    population = kc.batched_args(population, designs)
    for dt in (torch.float32, torch.float64):
        turns(f"kagome population {str(dt)[6:]} B=128",
              trajectory(kc.cast(population, dt)))
    for dt in ("float32", "float64"):
        turns(f"1L pulse {dt} B=1", trajectory(inputs[f"pulse {dt}"][1]))
        for label in ("flagship guarded loaded", "kagome guarded loaded"):
            turns(f"{label} {dt} B=1", trajectory(inputs[f"{label} {dt}"][1]))
    for label in ("microbench B=128", "flagship B=1"):
        for dt in (torch.float32, torch.float64):
            U, fixed = forces[label][0].to(dt), tuple(f.to(dt) for f in forces[label][1])
            replay = {side: _graphed(lambda side=side: _force(libs[side, "quad_force"], U, fixed))
                      for side in ("other", "repo")}
            key = f"kernel 2 {label} {str(dt)[6:]}"
            turns(f"{key} graph replay", lambda side: _event_ms(replay[side], FORCE_REPS)
                  / FORCE_CALLS)
            turns(f"{key} eager", lambda side: _event_ms(
                lambda: _force(libs[side, "quad_force"], U, fixed), FORCE_REPS))
            del replay
    use("repo")
    print(json.dumps({
        "card": card,
        "ptxas": {f"{side} {src}": {" ".join(map(str, k)): v for k, v in sorted(u.items())}
                  for (side, src), u in usage.items()},
        "max_abs_difference": differences, "field_scale": scales, "decisions": decisions,
        "ms": times}))


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
