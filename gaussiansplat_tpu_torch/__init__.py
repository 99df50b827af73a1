"""gaussiansplat_tpu_torch: the PyTorch/CUDA port of gaussiansplat_tpu.

A second package beside the JAX reference, with the same module names. Plain
tensor code is PyTorch; the TPU's Pallas kernels are rewritten by hand in
CUDA C++ for sm_90a (csrc/) and built at first use. It imports neither JAX
nor the reference package. Entry points: `render.render(model, camera)`,
the training step and loop of `train` (`make_train_step`, `Trainer.fit`),
the scenes of `data`, and the CLI `python -m gaussiansplat_tpu_torch
{train,render,eval}`.
"""

from .config import MeshConfig, RasterConfig, TrainConfig

__all__ = ["MeshConfig", "RasterConfig", "TrainConfig"]
