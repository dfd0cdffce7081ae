"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates without sparsity)."""

BF16 = 989e12        # FLOP/s, bf16 and fp16 on the tensor cores
TF32 = 494.7e12      # FLOP/s, TF32 on the tensor cores
FP32 = 67e12         # FLOP/s, fp32 outside the tensor cores
BYTES = 3.35e12      # bytes/s of HBM3
