"""Published peaks of one NVIDIA H100 SXM, the yardstick of every share.

Copied from chip_smoke.py (the per-SM rates, HBM bandwidth and float32
peak it charges K1's and K2's bounds with), with the sources it names:

- NVIDIA H100 Tensor Core GPU data sheet (SXM part, dense rates): 3.35 TB/s
  of HBM3 and 67 TFLOP/s of float32 outside the tensor cores, which counts
  an FMA as two operations: 132 SMs x 128 lanes x 2 x 1.98 GHz. Those rates
  assume the full 700 W power limit; every result prints the card's limit.
- CUDA C++ programming guide, "Arithmetic Instructions" (throughput of
  native arithmetic instructions, results per clock per SM, compute
  capability 9.0): 128 32-bit float adds, multiplies or FMAs, which is also
  the issue rate of any instruction (4 schedulers x 32 lanes); 16
  special-function results (exp2, log2, reciprocal); 32 warp shuffles.
  "Shared Memory": 32 banks x 4 B a clock, one warp-wide load a clock.
"""

SMS = 132
CLOCK_HZ = 1.98e9
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

RATES = {
    "issue": 128 * SMS * CLOCK_HZ,
    "sfu": 16 * SMS * CLOCK_HZ,
    "lds": 32 * SMS * CLOCK_HZ,
    "shfl": 32 * SMS * CLOCK_HZ,
}
