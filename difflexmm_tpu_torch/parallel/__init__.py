"""Populations of designs (counterpart of ``difflexmm_tpu/parallel``: the
multistart drivers; scenarios, meshes and domains are ROADMAP A11)."""

from difflexmm_tpu_torch.parallel.multistart import (  # noqa: F401
    FinalistResult,
    MultistartMMAResult,
    MultistartResult,
    population_value_and_grad,
    random_initial_designs,
    reevaluate_finalists,
    run_multistart_mma,
    run_multistart_optax,
)
