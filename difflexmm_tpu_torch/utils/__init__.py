from difflexmm_tpu_torch.utils.types import (  # noqa: F401
    BondParams,
    ContactParams,
    ControlParams,
    EigenmodeData,
    GeometricalParams,
    LigamentParams,
    MagneticParams,
    MechanicalParams,
    SolutionData,
    StretchingTorsionalSpringParams,
    load_data,
    save_data,
)
