"""augment_ms: device ms a step of the kernels launched inside the
program's ``train.augment`` span (train/steps.py: crop, resize, flip,
normalize and the mix; kernels/augment.py), read in the operator stretch
(``portbench/spans.py``)."""

from portbench import spans


def read(m):
    return spans.phase_ms(m, "train.augment")
