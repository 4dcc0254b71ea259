#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written trajectory kernel from ``difflexmm_tpu_torch/csrc``
into ``build/kernels``, holds it against its plain PyTorch version, drives
the paper flagship's value-and-gradient (24 x 16 quads, 200 timepoints,
10 substeps) through ``OptimizationProblem.objective_fn`` with the kernel,
checks the objective against the JAX package's float64 value, and times
the kernel against the plain body. Fails (non-zero exit, no result line)
without a CUDA device or outside a checkout of the repository. Imports
no JAX.

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it lists the kernels with their launches on the main
path, errors and times.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# Tolerances, each with its reason:
# - float64 kernel vs plain body on the same inputs: the two differ only in
#   rounding (fused multiply-adds, the order in which each DOF sums its
#   bonds' partials), which over the flagship's 1,990 damped substeps stays
#   within 1e-9 of each field's scale.
# - float32: rounding at float32 resolution is amplified by cancellation
#   (the acceleration is a small difference of stiff ligament forces), so
#   the kernel and the plain body are each held against the float64 plain
#   body on the same inputs, and the kernel's error may be at most three
#   times the plain body's (or 1e-5 of the field scale, where both are tiny).
F64_TRAJ_TOL = 1e-9
F32_TRAJ_FACTOR, F32_TRAJ_FLOOR = 3.0, 1e-5
# Force at one state (no integration): rounding of one energy gradient at
# float64; at float32 the same rule as for trajectories.
F64_FORCE_TOL = 1e-12
# Flagship objective against the JAX float64 verlet value.
OBJECTIVE_TOL = {"float64": 1e-8, "float32": 1e-4}
# Float64 design gradient with the kernel forward vs with the plain forward:
# both share the plain adjoint, so they differ by the forwards' rounding.
# At float32 the rule for trajectories holds against the float64 gradient.
GRAD64_TOL = 1e-7


def log(*parts):
    print(*parts, flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def check(name, err, tol):
    ok = err <= tol
    log(f"  {name}: max rel err {err:.3e} (tol {tol:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: error {err:.3e} above tolerance {tol:.1e}")


def kernel_vs_plain(torch, kc, args64, label):
    """The kernel against the plain body on the same inputs, at float64 and
    at float32 (see the tolerances above). Returns the kernel's largest
    difference from the plain body over U, V and A: absolute at float64,
    and relative to each field's scale at float64 and at float32."""

    from difflexmm_tpu_torch.ops.kernels import core

    def run(args, kernel):
        if kernel:
            return args.spec.forward(*args[1:], args.spec)
        return core.plain_trajectory(*args[1:], args.spec)

    def finite(outs, what):
        for name, x in zip("UVA", outs):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{label}: {what} {name} is not finite")

    f64 = torch.float64
    k64, p64 = run(args64, True), run(args64, False)
    finite(k64, "float64 kernel")
    for name, k, p in zip("UVA", k64, p64):
        check(f"{label} float64 {name}", kc.max_rel_err(k, p), F64_TRAJ_TOL)

    args32 = kc.cast(args64, torch.float32)
    ref = run(kc.cast(args32, torch.float64), False)
    k32, p32 = run(args32, True), run(args32, False)
    finite(k32, "float32 kernel")
    for name, k, p, r in zip("UVA", k32, p32, ref):
        e_plain = kc.max_rel_err(p.double(), r)
        log(f"  {label} float32 {name}: plain body vs float64 {e_plain:.3e}, "
            f"kernel vs plain {kc.max_rel_err(k, p):.3e}")
        check(f"{label} float32 {name} kernel vs float64",
              kc.max_rel_err(k.double(), r), max(F32_TRAJ_FACTOR * e_plain, F32_TRAJ_FLOOR))
    torch.cuda.synchronize()
    return {
        "max_abs_err": max(float((k - p).abs().max()) for k, p in zip(k64, p64)),
        "max_rel_err": {dtype_name(dt): max(kc.max_rel_err(k, p) for k, p in zip(ks, ps))
                        for dt, ks, ps in ((f64, k64, p64), (torch.float32, k32, p32))},
    }


def force_vs_plain(torch, kc, args64, label):
    """The kernel's force against autograd of the plain energy at the state
    ``args64.U0`` and drive row 0, at float64 and at float32."""

    check(f"{label} force float64",
          kc.max_rel_err(kc.kernel_force(args64), kc.plain_force(args64)), F64_FORCE_TOL)
    args32 = kc.cast(args64, torch.float32)
    ref = kc.plain_force(kc.cast(args32, torch.float64))
    e_plain = kc.max_rel_err(kc.plain_force(args32).double(), ref)
    check(f"{label} force float32 kernel vs float64 (plain float32 {e_plain:.3e})",
          kc.max_rel_err(kc.kernel_force(args32).double(), ref),
          max(F32_TRAJ_FACTOR * e_plain, F32_TRAJ_FLOOR))


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    device = torch.device("cuda")
    card_line = card()
    log(card_line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from difflexmm_tpu_torch import kernel_checks as kc
    from difflexmm_tpu_torch.models.flagship import JAX_F64_OBJECTIVE, build_flagship
    from difflexmm_tpu_torch.ops.kernels import build, core
    from difflexmm_tpu_torch.ops.kernels.verlet_grid import carry_bytes, verlet_quad_trajectory
    import numpy as np

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    build.load("verlet_quad")
    info = build.BUILD_INFO["verlet_quad"]
    log(f"build: verlet_quad in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {info['seconds']:.1f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # -- kernel against the plain body ----------------------------------------
    rng = np.random.default_rng(0)
    f64 = torch.float64
    small = kc.small_problem(device=device, dtype=f64)
    for B in (1, 4):
        designs = [kc.random_design(small, rng) for _ in range(B)]
        kernel_vs_plain(torch, kc, kc.batched_args(small, designs), f"small 8x6 B={B}")

    # A lattice whose carry does not fit in shared memory: global workspace.
    big = kc.small_problem(n1=56, n2=48, n_timepoints=3, n_substeps=4, device=device, dtype=f64,
                          simulation_time=2.7e-4)
    for dtype in (f64, torch.float32):
        need, have = carry_bytes(56, 48, dtype)
        log(f"  56x48 {dtype_name(dtype)}: carry {need} B per design, shared memory {have} B")
        if need <= have:
            raise AssertionError("56x48 was meant to exercise the workspace path")
    kernel_vs_plain(torch, kc, kc.batched_args(big, [kc.random_design(big, rng)] * 2),
                    "workspace 56x48 B=2")

    probe, mag = kc.contact_probe(device=device, dtype=f64)
    U_eff = probe.U0 * probe.fixed[-1] + core.drive_planes(probe.drive[:, 0], probe.spec, probe.U0)
    energy = kc.contact_energy_of(U_eff, probe.fixed)
    log(f"  contact probe: mag {np.degrees(mag):.3f} deg, contact energy {energy:.6e}")
    if not energy > 0:
        raise AssertionError("contact probe: the barrier is not engaged")
    force_vs_plain(torch, kc, probe, "contact probe")
    kernel_vs_plain(torch, kc, probe, "contact probe")

    optimization, design = build_flagship(device=device, dtype=f64)
    flagship = kc.batched_args(optimization.forward_problem, [design])
    flagship_err = kernel_vs_plain(torch, kc, flagship, "flagship 24x16")
    # The force at a state mid-pulse (the initial state is at rest).
    outU, _, _ = flagship.spec.forward(*flagship[1:], flagship.spec)
    mid = flagship._replace(U0=outU[:, 20].contiguous(),
                            drive=flagship.drive[:, 200:].contiguous())
    force_vs_plain(torch, kc, mid, "flagship mid-pulse")

    # -- main path: flagship value and gradient through the kernel -----------
    def value_and_grad(opt, design):
        d = tuple(x.detach().clone().requires_grad_() for x in design)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = opt.objective_fn(d)
        value.backward()
        torch.cuda.synchronize()
        grad = torch.cat([x.grad.flatten() for x in d])
        return float(value.detach()), grad, time.perf_counter() - t0

    dtypes = (torch.float64, torch.float32)
    kernel_path = {dt: build_flagship(device=device, dtype=dt) for dt in dtypes}
    plain_path = {dt: build_flagship(method="verlet_ckpt", device=device, dtype=dt)[0]
                  for dt in dtypes}
    verlet_quad_trajectory.launches = 0
    core.plain_trajectory.calls = 0
    main = {dt: value_and_grad(*kernel_path[dt]) for dt in dtypes}
    launches = verlet_quad_trajectory.launches
    plain_calls = core.plain_trajectory.calls
    log(f"main path: {launches} kernel launches, {plain_calls} plain-body forwards")
    if launches < len(dtypes) or plain_calls != 0:
        raise AssertionError("the main path did not run through the kernel")

    # The same value and gradient with the plain-body forward (same adjoint).
    plain = {dt: value_and_grad(plain_path[dt], kernel_path[dt][1]) for dt in dtypes}
    for dt in dtypes:
        name = dtype_name(dt)
        value, grad, seconds = main[dt]
        rel = abs(value - JAX_F64_OBJECTIVE) / JAX_F64_OBJECTIVE
        log(f"  flagship {name}: objective {value!r} (JAX f64 {JAX_F64_OBJECTIVE!r}, "
            f"rel {rel:.3e}), fwd+grad {seconds:.2f} s (plain forward {plain[dt][2]:.2f} s)")
        check(f"flagship {name} objective vs JAX float64", rel, OBJECTIVE_TOL[name])
        if not (bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0):
            raise AssertionError(f"flagship {name} gradient is not finite and non-zero")
    ref = plain[torch.float64][1]
    check("flagship float64 gradient, kernel vs plain forward",
          kc.max_rel_err(main[torch.float64][1], ref), GRAD64_TOL)
    e_plain = kc.max_rel_err(plain[torch.float32][1].double(), ref)
    check(f"flagship float32 gradient vs float64 (plain forward float32 {e_plain:.3e})",
          kc.max_rel_err(main[torch.float32][1].double(), ref),
          max(F32_TRAJ_FACTOR * e_plain, F32_TRAJ_FLOOR))

    # -- timing (flagship) -------------------------------------------------
    # The kernel is timed over several runs; the plain body, tens of seconds
    # a run, once. The main path's and the plain check's value-and-gradient
    # runs are the first samples of fwd+grad.
    def event_ms(fn, reps):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    def host_s(fn, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    def trajectory(args, kernel=True):
        forward = args.spec.forward if kernel else core.plain_trajectory
        return lambda: forward(*args[1:], args.spec)

    def repeated(args, B):
        """One design's trajectory inputs, B times on the batch dimension."""

        rep = lambda x: x.expand(B, *x.shape[1:]).contiguous()  # noqa: E731
        return args._replace(U0=rep(args.U0), V0=rep(args.V0), A0=rep(args.A0),
                             drive=rep(args.drive), fixed=tuple(rep(f) for f in args.fixed))

    dtype = torch.float32
    optimization, design = kernel_path[dtype]
    plain_opt = plain_path[dtype]
    args = kc.batched_args(optimization.forward_problem, [design])
    kernel_ms = event_ms(trajectory(args), 5)
    plain_ms = event_ms(trajectory(args, kernel=False), 1)
    kernel_ms_f64 = event_ms(trajectory(flagship), 5)
    # Designs per launch (one thread block each): 1, one per SM, four per SM.
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    batch_ms = {B: event_ms(trajectory(repeated(args, B)), 3) for B in (1, n_sm, 4 * n_sm)}

    def fwd(opt):
        with torch.no_grad():
            return opt.objective_fn(design)

    def fwd_grad(opt):
        value_and_grad(opt, design)

    timings = {
        "fwd_kernel_s": statistics.median(host_s(lambda: fwd(optimization), 3)),
        "fwd_plain_s": statistics.median(host_s(lambda: fwd(plain_opt), 1)),
        "fwd_grad_kernel_s": statistics.median(
            [main[dtype][2]] + host_s(lambda: fwd_grad(optimization), 2)),
        "fwd_grad_plain_s": plain[dtype][2],
    }
    backward_share = 1 - timings["fwd_kernel_s"] / timings["fwd_grad_kernel_s"]
    log(f"timing ({card_line}), flagship float32 unless named; kernel medians of 5 (batch: 3), "
        f"plain body 1 run: trajectory kernel {kernel_ms:.3f} ms (float64 {kernel_ms_f64:.3f} ms) "
        f"vs plain body {plain_ms:.1f} ms")
    for B, ms in batch_ms.items():
        log(f"  kernel batch B={B}: {ms:.3f} ms, {B / ms * 1e3:.1f} designs/s")
    log("  objective (s; kernel median of 3, plain 1 run): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items())
        + f"; backward share of fwd+grad with the kernel {backward_share:.4f}")

    kernels = [{
        "name": "verlet_quad",
        "route": "cuda",
        "source": "difflexmm_tpu_torch/csrc/verlet_quad.cu",
        "replaces": "difflexmm_tpu/ops/pallas/core.py:822",
        "launches": launches,
        **flagship_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "ms_float64": kernel_ms_f64,
        "batch_ms": {str(B): ms for B, ms in batch_ms.items()},
    }]
    print(json.dumps({"kernels": kernels, "card": card_line, **timings,
                      "backward_share": backward_share}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
