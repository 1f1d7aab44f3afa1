"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W limit).  A share of a roofline is stated against these, with
the card's power limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12  # tensor cores
BF16_FLOPS_PER_S = 989e12  # tensor cores
TF32_FLOPS_PER_S = 495e12  # tensor cores
# a float32 product on the tensor cores as three TF32 products (3xTF32): the
# card's fastest rate for float32-exact products, the attention core's form
TF32X3_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
F32_FLOPS_PER_S = 67e12  # CUDA cores, outside the tensor cores


def least_seconds(nbytes=0.0, int8_ops=0.0, tf32x3_flops=0.0, bf16_flops=0.0, f32_flops=0.0) -> float:
    """The least time the card needs for the work: each input byte read and
    each output byte written once at the memory rate, the tensor-core
    operations at their peaks (one after the other: they share the tensor
    cores), the CUDA-core float32 operations at theirs; the largest of the
    three, since memory, tensor cores and CUDA cores run side by side."""
    tensor = int8_ops / INT8_OPS_PER_S + tf32x3_flops / TF32X3_FLOPS_PER_S + bf16_flops / BF16_FLOPS_PER_S
    return max(nbytes / HBM_BYTES_PER_S, tensor, f32_flops / F32_FLOPS_PER_S)
