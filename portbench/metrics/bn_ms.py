"""bn_ms: device ms a step of the kernels launched, from any thread,
inside the program's ``resnet.bn`` spans (each train-mode BatchNorm's
statistics and affine, models/resnet.py) and ``resnet.bn_backward`` spans
(its backward, opened and closed by gradient hooks on autograd's
thread), read in the operator stretch (``portbench/layers_resnet.py``)."""

from portbench import layers_resnet


def read(m):
    return layers_resnet.bn_ms(m)
