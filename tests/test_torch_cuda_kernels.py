"""The hand-written trajectory kernel against its plain PyTorch version on
a CUDA device. Marked ``cuda``: skipped (with the reason) where there is
no CUDA device; on a machine with one, run
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.

Tolerances as in ``chip_smoke.py``: float64 kernel vs plain body within
1e-9 of the field scale (rounding only); at float32 both are held against
the float64 plain body on the same inputs, and the kernel's error may be
at most three times the plain body's (floor 1e-5).
"""

import numpy as np
import pytest
import torch

from difflexmm_tpu_torch import kernel_checks as kc
from difflexmm_tpu_torch.ops.kernels import core
from difflexmm_tpu_torch.ops.kernels.verlet_grid import carry_bytes, verlet_quad_trajectory

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _plain(args):
    return core.plain_trajectory(*args[1:], args.spec)


def _kernel(args):
    launches = verlet_quad_trajectory.launches
    calls = core.plain_trajectory.calls
    outs = args.spec.forward(*args[1:], args.spec)
    assert verlet_quad_trajectory.launches == launches + 1
    assert core.plain_trajectory.calls == calls
    return outs


def _assert_matches(args64, dtype):
    if dtype == torch.float64:
        for k, p in zip(_kernel(args64), _plain(args64)):
            assert torch.isfinite(k).all()
            assert kc.max_rel_err(k, p) <= 1e-9
        return
    args32 = kc.cast(args64, torch.float32)
    ref = _plain(kc.cast(args32, torch.float64))
    for k, p, r in zip(_kernel(args32), _plain(args32), ref):
        assert torch.isfinite(k).all()
        bound = max(3.0 * kc.max_rel_err(p.double(), r), 1e-5)
        assert kc.max_rel_err(k.double(), r) <= bound


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batch_of_four_designs(device, dtype):
    problem = kc.small_problem(device=device)
    rng = np.random.default_rng(0)
    _assert_matches(kc.batched_args(problem, [kc.random_design(problem, rng) for _ in range(4)]),
                    dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_contact_probe(device, dtype):
    args, _ = kc.contact_probe(device=device)
    U_eff = args.U0 * args.fixed[-1] + core.drive_planes(args.drive[:, 0], args.spec, args.U0)
    assert kc.contact_energy_of(U_eff, args.fixed) > 0
    assert kc.max_rel_err(kc.kernel_force(args), kc.plain_force(args)) <= 1e-12
    _assert_matches(args, dtype)


def test_lattice_beyond_shared_memory(device):
    need, have = carry_bytes(56, 48, torch.float64)
    assert need > have  # the carry lives in the global workspace
    problem = kc.small_problem(n1=56, n2=48, n_timepoints=3, device=device,
                               simulation_time=2.7e-4)
    rng = np.random.default_rng(1)
    _assert_matches(kc.batched_args(problem, [kc.random_design(problem, rng)] * 2),
                    torch.float64)
