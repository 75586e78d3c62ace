"""optimizer_ms: device ms a step of the kernels launched inside
the torch optimizer's step (``Optimizer.step#AdamW.step``; train/optim.py)."""

from portbench import layers


def read(m: layers.Reading):
    return layers.optimizer_ms(m)
