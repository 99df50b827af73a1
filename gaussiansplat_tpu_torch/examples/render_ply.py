"""Render frames from a pretrained INRIA-format 3DGS PLY, through the port's
CLI (on the card by default; `--device cpu` runs the plain versions):

    python -m gaussiansplat_tpu_torch.examples.render_ply --ply scene.ply --frames 8 --out renders/
"""

import sys

from gaussiansplat_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main(["render", *sys.argv[1:]]))
