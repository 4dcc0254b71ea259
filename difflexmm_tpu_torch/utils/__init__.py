from difflexmm_tpu_torch.utils.types import (  # noqa: F401
    ContactParams,
    ControlParams,
    EigenmodeData,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
    SolutionData,
    load_data,
    save_data,
)
