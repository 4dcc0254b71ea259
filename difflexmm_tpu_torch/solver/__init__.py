from difflexmm_tpu_torch.solver.dynamics import (  # noqa: F401
    FAST_METHODS,
    setup_dynamic_solver,
)
