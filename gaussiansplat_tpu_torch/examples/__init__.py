"""Drivers of the port: `python -m gaussiansplat_tpu_torch.examples.<name>`."""
