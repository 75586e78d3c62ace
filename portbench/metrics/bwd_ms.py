"""bwd_ms: device ms a step of the kernels launched, from any thread,
while the program's ``train.backward`` span was open (train/steps.py:
autograd launches them from its own device thread), read in the operator
stretch (``portbench/spans.py``)."""

from portbench import spans


def read(m):
    return spans.phase_ms(m, "train.backward")
