"""device_idle_pct: the share of the train steps profiled with CUDA
activity alone in which no operation ran on the device: the union of the
trace's kernel, copy and memset intervals against the stretch's CUDA
events."""

from portbench import layers


def read(m: layers.Reading):
    return layers.idle_pct(m)
