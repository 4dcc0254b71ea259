"""Compare another commit's trajectory kernels with the repository's on one
CUDA device: registers and spills, outputs and times.

    python3 -m difflexmm_tpu_torch.kernel_ab DIR

``DIR`` is the other commit's package directory, unpacked whole so that
its headers sit beside its sources, for instance ``git archive REV
difflexmm_tpu_torch | tar -x -C OUT`` and ``DIR = OUT/difflexmm_tpu_torch``.
Both ``csrc/verlet_quad.cu`` and ``csrc/verlet_kagome.cu`` are built from
each side afresh with the same nvcc flags, at the same time (by type where
the side's ``verlet_common.cuh`` splits by ``VERLET_TYPE``). The other
sources must export the same C interface or an older form of it (the
launch's extra arguments, such as the load pointers, come after the ones
an older source reads).

Each version then runs, through the repository's wrappers: the flagship
and the kagome configuration (``models/kagome_config.build_kagome``),
unguarded and guarded (``guard="auto"``); the quad and the kagome contact
probes, unguarded and guarded; the force pulse (kernel 1L); each at
float64 and float32, at B = 1. The largest |other - repo| of U, V and A is
printed, and for the guarded kernels whether decisions and flags are
identical. Last, kernels 1g, 1Kg, 1 and 1K are timed with CUDA events at
B = 1, one design per SM and four per SM, float32 and float64, the
versions alternating (other, repo, repo, other, other, repo), each turn
the median of 3 runs. The last line of standard output is a JSON object
of the results.
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

SOURCES = ("verlet_quad", "verlet_kagome")


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
    with ThreadPoolExecutor(4) as pool:
        for side, csrc in dirs.items():
            by_type = "VERLET_TYPE" in (csrc / "verlet_common.cuh").read_text()
            for src in SOURCES:
                targets[side, src] = build.BUILD_DIR / "ab" / side / f"lib{src}.so"
                jobs[side, src] = pool.submit(build.compile_source, csrc / f"{src}.cu",
                                              targets[side, src], by_type)
        logs = {key: job.result()["log"] for key, job in jobs.items()}
    usage = {key: build.ptxas_usage(log, key[1]) for key, log in logs.items()}
    print("registers, stack, spill stores and loads (dtype, linearized, contact, guard[, "
          "threads]): other / repo")
    for src in SOURCES:
        for key in sorted(set(usage["other", src]) | set(usage["repo", src])):
            print(f"  {src} {key}: " + " / ".join(
                str(tuple(u[key].values())) if key in u else "-"
                for u in (usage["other", src], usage["repo", src])))
    libs = {key: launch.type_library(ctypes.CDLL(str(t)), key[1]) for key, t in targets.items()}

    def use(side):
        for src in SOURCES:
            build._LIBS[src] = libs[side, src]

    device = torch.device("cuda")
    inputs = {}
    for label, (src, args64) in cases(device).items():
        for dt in (torch.float64, torch.float32):
            inputs[f"{label} {str(dt)[6:]}"] = (src, args64 if dt == torch.float64
                                                else kc.cast(args64, dt))
    differences, decisions = {}, {}
    for label, (src, args) in inputs.items():
        outs = {}
        for side in dirs:
            use(side)
            outs[side] = core.trajectory_forward(args)
        differences[label] = max(float((a.double() - b.double()).abs().max())
                                 for a, b in zip(outs["other"][:3], outs["repo"][:3]))
        line = f"{label}: largest |other - repo| {differences[label]!r}"
        if args.spec.guard is not None:
            same = all(torch.equal(a, b) for a, b in zip(outs["other"][3:], outs["repo"][3:]))
            decisions[label] = dict(identical=same, fired=int(outs["repo"][4].sum()))
            line += (f", decisions and flags {'identical' if same else 'DIFFER'} "
                     f"({decisions[label]['fired']} substeps fired)")
        print(line, flush=True)

    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    times = {}
    for label in ("flagship guarded", "kagome guarded", "flagship", "kagome"):
        for dt in ("float32", "float64"):
            src, args1 = inputs[f"{label} {dt}"]
            for B in (1, n_sm, 4 * n_sm):
                args = _repeated(args1, B)
                key = f"{label} {dt} B={B}"
                for side in ("other", "repo", "repo", "other", "other", "repo"):
                    use(side)
                    core.trajectory_forward(args)  # warm up
                    times.setdefault(key, {}).setdefault(side, []).append(
                        _event_ms(lambda: core.trajectory_forward(args)))
                by_side = times[key]
                print(f"{key}: " + ", ".join(
                    f"{side} {statistics.median(ms):.3f} ms {[round(x, 3) for x in ms]}"
                    for side, ms in by_side.items())
                    + f", repo/other {statistics.median(by_side['repo']) / statistics.median(by_side['other']):.4f}",
                    flush=True)
                del args
    use("repo")
    print(json.dumps({
        "card": card,
        "ptxas": {f"{side} {src}": {" ".join(map(str, k)): v for k, v in sorted(u.items())}
                  for (side, src), u in usage.items()},
        "max_abs_difference": differences, "decisions": decisions, "ms": times}))


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
