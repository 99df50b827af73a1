from .gaussians import (
    GaussianModel,
    empty_model,
    from_arrays,
    from_numpy_params,
    random_model,
    scene_extent,
)
