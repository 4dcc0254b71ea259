from difflexmm_tpu_torch.solver.dynamics import (  # noqa: F401
    FAST_METHODS,
    setup_dynamic_solver,
)
from difflexmm_tpu_torch.solver.diagnose import (  # noqa: F401
    TunnelingReport,
    contact_tunneling_report,
    first_nonfinite_timepoint,
)
from difflexmm_tpu_torch.solver.modal import (  # noqa: F401
    eigenmode_analysis,
    linear_mode_analysis,
)
from difflexmm_tpu_torch.solver.statics import setup_static_solver  # noqa: F401
from difflexmm_tpu_torch.solver.continuation import (  # noqa: F401
    ContinuationPath,
    fold_points,
    setup_arclength_solver,
)
from difflexmm_tpu_torch.solver.frequency import (  # noqa: F401
    harmonic_response,
    transmission,
)
from difflexmm_tpu_torch.solver.homogenize import (  # noqa: F401
    areal_density,
    christoffel_speeds,
    effective_moduli,
    effective_stress,
    engineering_constants,
    voigt,
)
from difflexmm_tpu_torch.solver.bloch import (  # noqa: F401
    BlochCell,
    band_structure,
    bond_hessians,
    bz_grid,
    cell_strain_energy,
    defect_supercell,
    density_of_states,
    dynamical_matrix,
    group_velocity,
    relax_cell,
    frequencies,
    high_symmetry_path,
    kagome_periodic_cell,
    line_defect_cell,
    mode_localization,
    quad_periodic_cell,
    reciprocal_basis,
    rotated_square_cell,
    spring_chain_cell,
    supercell,
)
