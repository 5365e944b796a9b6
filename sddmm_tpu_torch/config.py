"""Global constants of the BSMR-style pipeline, chosen TPU-first.

Reference counterparts: include/BSMR.hpp:8-10 (ROW_PANEL_SIZE=16,
BLOCK_COL_SIZE=16, BLOCK_SIZE=256) and include/TensorCoreConfig.cuh:10-12
(UIN/NULL_VALUE).  We keep the reference's *logical* 16x16 block granularity
(so the alpha/delta thresholds mean the same thing) but pack the physical
compute into MXU/VPU-aligned shapes:

- the fp32 min tile on TPU is (8, 128); our dense path stacks
  ``DENSE_GROUP_BLOCKS`` 16-col blocks per row panel into lane-dim-128 tiles,
- sentinels are ``-1`` / ``N`` (int32) rather than ``uint32`` 0xFFFFFFFF —
  int32 is the native TPU integer type.
"""

# Logical clustering granularity (same semantics as the reference).
ROW_PANEL_SIZE = 16          # rows per panel
BLOCK_COL_SIZE = 16          # columns per dense block
BLOCK_SIZE = ROW_PANEL_SIZE * BLOCK_COL_SIZE  # cells per dense block (256)

# Physical TPU packing: how many 16-col dense blocks are fused into one
# MXU-friendly (16, 128) tile group in the Pallas dense kernel.
DENSE_GROUP_BLOCKS = 8       # 8 * 16 = 128 = TPU lane width
LANE = 128
SUBLANE_F32 = 8

# Sentinel for "no value" in packed index arrays (int32).
NULL_INDEX = -1

# Default reordering thresholds (reference include/Options.hpp:38-41).
DEFAULT_ALPHA = 0.3
DEFAULT_DELTA = 0.3
DEFAULT_K = 32
DEFAULT_NUM_ITERATIONS = 10

# Numerical tolerance contract (reference include/checkData.hpp:14-29).
ABS_TOL = 1e-5
REL_TOL = 1e-3
