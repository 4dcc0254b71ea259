"""Compare another source of the trajectory kernel with the repository's
``csrc/verlet_quad.cu`` on one CUDA device: registers, outputs and times.

    python3 -m difflexmm_tpu_torch.kernel_ab OTHER.cu

``OTHER.cu`` must export the same C interface or an older form of it
(the launch's extra arguments, such as the load pointers, come after the
ones an older source reads). Its ``#include "verlet_common.cuh"`` finds the
header beside it first, so unpack the other commit's package whole, for
instance ``git archive REV difflexmm_tpu_torch | tar -x -C DIR`` and pass
``DIR/difflexmm_tpu_torch/csrc/verlet_quad.cu``. Both are built afresh with
the same nvcc flags, at the same time. Each version
then runs the flagship trajectory (unguarded at float32 and float64,
guarded at float64) and the contact probe (guarded and unguarded, float64);
the largest difference between the two versions' outputs is printed.
Last, the unguarded flagship trajectory is timed with CUDA events at
B = 1, one design per SM and four per SM, the versions alternating
(other, repo, repo, other, other, repo), each turn the median of 5 runs.
The last line of standard output is a JSON object of the results.
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
from difflexmm_tpu_torch.ops.kernels import build, core, launch


def _event_ms(fn, reps=5):
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


def main(other: str):
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    paths = {"other": Path(other), "repo": build.CSRC_DIR / "verlet_quad.cu"}
    targets = {name: build.BUILD_DIR / "ab" / f"lib{name}.so" for name in paths}
    with ThreadPoolExecutor(2) as pool:
        jobs = {name: pool.submit(build.compile_source, paths[name], targets[name])
                for name in paths}
        logs = {name: job.result()["log"] for name, job in jobs.items()}
    registers = {name: build.ptxas_registers(log) for name, log in logs.items()}
    print("registers (dtype, linearized, contact, guard): other / repo")
    for key in sorted(registers["repo"]):
        print(f"  {key}: {registers['other'].get(key)} / {registers['repo'][key]}")
    libs = {name: launch.type_library(ctypes.CDLL(str(target)), "verlet_quad")
            for name, target in targets.items()}

    def use(name):
        build._LIBS["verlet_quad"] = libs[name]

    device = torch.device("cuda")
    opt, design = fl.build_flagship(device=device)
    flagship = kc.batched_args(opt.forward_problem, [design])
    guarded = kc.batched_args(fl.build_flagship(device=device, guard="auto")[0].forward_problem,
                              [design])
    probe = kc.contact_probe(device=device, guard="auto")[0]
    cases = {
        "flagship float64": flagship,
        "flagship float32": kc.cast(flagship, torch.float32),
        "flagship guarded float64": guarded,
        "contact probe guarded float64": probe,
        "contact probe float64": probe._replace(spec=probe.spec._replace(guard=None), micro=()),
    }
    differences = {}
    for label, args in cases.items():
        outs = {}
        for name in libs:
            use(name)
            outs[name] = core.trajectory_forward(args)
        differences[label] = max(float((a.double() - b.double()).abs().max())
                                 for a, b in zip(outs["other"], outs["repo"]))
        print(f"{label}: largest |other - repo| {differences[label]!r}", flush=True)

    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    times = {}
    for label in ("flagship float32", "flagship float64"):
        for B in (1, n_sm, 4 * n_sm):
            args = _repeated(cases[label], B)
            for name in ("other", "repo", "repo", "other", "other", "repo"):
                use(name)
                core.trajectory_forward(args)  # warm up
                times.setdefault(f"{label} B={B}", {}).setdefault(name, []).append(
                    _event_ms(lambda: core.trajectory_forward(args)))
    use("repo")
    for key, by_name in times.items():
        print(f"{key}: " + ", ".join(
            f"{name} {statistics.median(ms):.3f} ms {[round(x, 3) for x in ms]}"
            for name, ms in by_name.items()))
    print(json.dumps({"card": card, "registers": {
        name: {" ".join(map(str, k)): v for k, v in sorted(r.items())}
        for name, r in registers.items()}, "max_abs_difference": differences, "ms": times}))


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
