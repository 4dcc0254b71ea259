"""Optimizers of the port (counterpart of ``difflexmm_tpu/optim``): MMA."""

from difflexmm_tpu_torch.optim.mma import (  # noqa: F401
    MMAState,
    mma_init,
    mma_update,
    run_mma,
    run_mma_fused,
)
