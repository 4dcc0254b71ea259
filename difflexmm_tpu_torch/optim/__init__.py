"""Optimizers of the port (counterpart of ``difflexmm_tpu/optim``): MMA and
the gradient loops."""

from difflexmm_tpu_torch.optim.loops import (  # noqa: F401
    OptLoopResult,
    naive_gd,
    project_box,
    ravel_pytree,
    run_optimization_optax,
)
from difflexmm_tpu_torch.optim.mma import (  # noqa: F401
    MMAState,
    mma_init,
    mma_update,
    run_mma,
    run_mma_fused,
)
