"""NVIDIA H100 SXM5 80 GB constants (the roofline denominators).

Rates are the dense (no sparsity) figures of NVIDIA's H100 Tensor Core
GPU data sheet, SXM5 column; the port's kernel bounds in ``PERF.md`` use
the same numbers.  A card capped below its 700 W limit runs slower under
load, so the bounds are the least time at the published clocks.
"""

PEAK_BF16_FLOPS = 989e12       # bf16 tensor-core FLOP/s, dense
PEAK_FP32_FLOPS = 67e12        # fp32 FLOP/s on the CUDA cores
HBM_BW = 3.35e12               # HBM3 bytes/s
HBM_BYTES = 80e9               # device memory

# NVLink 4 (data sheet: 900 GB/s of bidirectional bandwidth per GPU, so
# 450e9 bytes/s each way): the collective term's denominator.  One card
# moves nothing over it, so that term reads 0 at one device; the
# production meshes' counts divide by it as if every link were NVLink.
NVLINK_BW = 450e9
