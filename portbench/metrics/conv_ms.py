"""conv_ms: device ms a step of the kernels launched under the
convolution operators of the ResNet tower (models/resnet.py's
``F.conv2d``, cuDNN): ``aten::convolution`` / ``aten::cudnn_convolution``
forward and ``aten::convolution_backward`` under autograd's node, layout
copies among them (``portbench/layers_resnet.py``)."""

from portbench import layers_resnet


def read(m):
    return layers_resnet.conv_ms(m)
