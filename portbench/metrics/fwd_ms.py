"""fwd_ms: device ms a step of the kernels launched inside the program's
``train.forward`` span (train/steps.py: the image tower's forward, the
head and the loss; models/clip.py), read in the operator stretch
(``portbench/spans.py``)."""

from portbench import spans


def read(m):
    return spans.phase_ms(m, "train.forward")
