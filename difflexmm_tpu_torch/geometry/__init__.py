from difflexmm_tpu_torch.geometry.kagome import KagomeGeometry, KagomePeriodicGeometry  # noqa: F401,E501
from difflexmm_tpu_torch.geometry.polygon import (  # noqa: F401
    compute_inertia,
    polygon_area,
    polygon_centroid,
    polygon_polar_moment,
)
from difflexmm_tpu_torch.geometry.quad import QuadGeometry, RotatedSquareGeometry  # noqa: F401
