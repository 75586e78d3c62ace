"""gemm_ms: device ms a step of cuBLAS's GEMM kernels
(models/clip.py's dense and the augment's resamples) outside the attention
and optimizer operators."""

from portbench import layers


def read(m: layers.Reading):
    return layers.gemm_ms(m)
