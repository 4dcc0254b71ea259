from difflexmm_tpu_torch.ops.magnetic import (  # noqa: F401
    build_magnetic_energy,
    magnetic_dipole_energy,
)
