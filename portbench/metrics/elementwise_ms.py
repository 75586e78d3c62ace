"""elementwise_ms: device ms a step of the kernels that are
neither cuBLAS GEMMs nor launched by the attention or optimizer operators
(models/clip.py's LayerNorm, GELU and adds, kernels/augment.py)."""

from portbench import layers


def read(m: layers.Reading):
    return layers.elementwise_ms(m)
