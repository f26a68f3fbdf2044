"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit): the rates a roofline share or an MFU divides by."""

FP32_FLOPS = 67e12     # float32 outside the tensor cores (and FP64 on them)
HBM_BYTES = 3.35e12    # HBM3 bytes per second
