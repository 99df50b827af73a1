"""Channel and output-row constants shared by the raster kernels, and
their thread layout (csrc/raster_common.cuh).

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

# K1 and K2 stage each pair of a chunk as one 48-byte lane in shared memory.
LANE_BYTES = 48
# A thread renders a 2x2 pixel quad and a warp a 16x8-pixel box, so a tile
# is ceil(ts / 16) x ceil(ts / 8) warps.
WARP_BOX = (16, 8)


def raster_warps(tile_size: int) -> tuple:
    """(warps across, warps down) of one tile's block in K1 and K2."""
    bw, bh = WARP_BOX
    return -(-tile_size // bw), -(-tile_size // bh)
