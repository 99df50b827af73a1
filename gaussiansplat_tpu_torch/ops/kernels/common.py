"""Channel and output-row constants shared by the raster kernels.

Payload channels match ops/projection.py; the forward kernel's per-tile
output block is (NOUT, tile_px) with the rows below.
"""

CH_MX, CH_MY, CH_CA, CH_CB, CH_CC, CH_OP, CH_R, CH_G, CH_B = range(9)
CH_ONE = 9     # constant 1.0 -> accumulates the sum of weights (alpha image)
CH_DEPTH = 10  # camera depth -> accumulates the expected-depth image
NCH = 16

# Rows of the per-tile output block: colour sums, log-transmittance, weight
# sum, depth sum, and the number of chunks composited before the tile
# stopped (read by the backward pass).
OUT_R, OUT_G, OUT_B, OUT_LOGT, OUT_WSUM, OUT_DEPTH, OUT_STOP = range(7)
NOUT = 8
