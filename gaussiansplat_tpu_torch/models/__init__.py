from .gaussians import (
    GaussianModel,
    empty_model,
    from_arrays,
    from_numpy_params,
    from_points,
    random_model,
    scene_extent,
)
from .splats2d import (
    Splat2DModel,
    project_splats2d,
    random_splats2d,
    render_splats2d,
    splats2d_from_numpy,
)
