"""attn_fwd_roofline: the attention forward's bound
(portbench/flops.py, one call a layer) over the device time of the kernels
launched under the port's ``PackedAttention`` autograd Function
(kernels/flash_attention.py, csrc/mha_fwd.cu), in %."""

from portbench import layers


def read(m: layers.Reading):
    return layers.attn_fwd_roofline(m)
