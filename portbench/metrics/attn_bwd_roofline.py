"""attn_bwd_roofline: the attention backward's bound
(portbench/flops.py, one call a layer) over the device time of the kernels
launched under ``PackedAttentionBackward`` (csrc/mha_bwd.cu), in %."""

from portbench import layers


def read(m: layers.Reading):
    return layers.attn_bwd_roofline(m)
