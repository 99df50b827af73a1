from .gaussians import (
    GaussianModel,
    empty_model,
    from_arrays,
    from_numpy_params,
    from_points,
    random_model,
    scene_extent,
)
