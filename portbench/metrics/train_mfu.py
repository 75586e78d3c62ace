"""train_mfu: the image tower's training FLOPs (portbench/flops.py:
three forwards an image) at the untraced window's images/s, over the
policy's peak (989 TFLOP/s bf16, 67 TFLOP/s fp32: the port turns TF32
off)."""

from portbench import layers


def read(m: layers.Reading):
    return layers.mfu_pct(m)
