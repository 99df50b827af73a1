"""Train on the procedural synthetic scene and export a PLY, through the
port's CLI (on the card by default; `--device cpu` runs the plain versions):

    python -m gaussiansplat_tpu_torch.examples.train_synthetic --iterations 500 --out runs/demo
"""

import sys

from gaussiansplat_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main(["train", "--scene", "synthetic", *sys.argv[1:]]))
