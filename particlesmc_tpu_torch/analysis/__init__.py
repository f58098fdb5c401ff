from .structure import (  # noqa: F401
    mean_squared_displacement,
    radial_distribution,
    self_intermediate_scattering,
    unwrap_trajectory,
)
