"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3; NVIDIA's data sheet,
dense rates, at the full 700 W power limit)."""

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,
    "tf32_flops_per_s": 495e12,
    "bf16_flops_per_s": 989e12,
    "fp8_flops_per_s": 1979e12,
    "int8_ops_per_s": 1979e12,
}
