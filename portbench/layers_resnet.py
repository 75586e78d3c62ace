"""What the readers of the ResNet tower's metrics share: its
convolutions' kernels, found by the host operators that launched them,
their bound, and the kernels launched inside the program's BatchNorm
spans (``resnet.bn`` around each train-mode forward, ``resnet.bn_backward``
over its backward; ``swat_tpu_torch/models/resnet.py``).  Each reads the
operator stretch (``Reading.ops``) and returns None on a trace without
what it reads.
"""

from __future__ import annotations

from typing import List, Optional

from portbench import flops_resnet, layers, spans
from portbench.trace import Op

# the convolution's operators forward (aten::conv2d holds
# aten::convolution, which holds aten::cudnn_convolution) and backward
# (under autograd's ConvolutionBackward0 node)
CONV_OPS = ("aten::convolution", "aten::cudnn_convolution",
            "aten::convolution_backward")
BN_SPANS = ("resnet.bn", "resnet.bn_backward")


def conv_kernels(m: layers.Reading) -> List[Op]:
    return layers.under(m, lambda name: name in CONV_OPS)


def conv_ms(m: layers.Reading) -> Optional[float]:
    return layers.ms_per_unit(m, conv_kernels(m))


def conv_roofline(m: layers.Reading) -> Optional[float]:
    """The convolutions' bound a step (``flops_resnet.conv_train_bound_s``
    at the cell's batch and dtype) over their kernels' device time, in
    %."""
    kernels = conv_kernels(m)
    if not kernels:
        return None
    bound = flops_resnet.conv_train_bound_s(m.config, m.facts["batch"],
                                            m.facts["dtype"])
    return 100.0 * bound * m.ops.steps / (sum(k.dur for k in kernels) / 1e6)


def bn_ms(m: layers.Reading) -> Optional[float]:
    """Device ms a step of the kernels launched, from any thread, inside
    the BatchNorm spans (``spans.phase_kernels``: the spans of one name
    follow each other, as a forward's and a backward's do)."""
    found = [spans.phase_kernels(m.ops.trace, name) for name in BN_SPANS]
    if all(kernels is None for kernels in found):
        return None
    return sum(k.dur for kernels in found if kernels
               for k in kernels) / 1e3 / m.ops.steps
