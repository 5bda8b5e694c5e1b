"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates).

The operations peak is the dense TF32 tensor-core rate: the fastest the
card runs fp32-input arithmetic, so no implementation held to fp32
results can read above it."""

HBM_BYTES_S = 3.35e12
TF32_FLOP_S = 495e12
