from difflexmm_tpu_torch.utils.types import (  # noqa: F401
    ContactParams,
    ControlParams,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
    SolutionData,
)
