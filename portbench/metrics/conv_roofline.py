"""conv_roofline: the training step's convolutions at their bound
(``portbench/flops_resnet.py``: each convolution's forward, data and
weight gradient, the larger of bytes over 3.35 TB/s and operations over
the policy's peak) over the device time of the kernels ``conv_ms``
reads, in %."""

from portbench import layers_resnet


def read(m):
    return layers_resnet.conv_roofline(m)
