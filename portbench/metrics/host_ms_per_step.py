"""host_ms_per_step: the host's ms a step: the host clock around
each call of the epoch function (train/resident.py; train/steps.py's
draws and launches) in the stretch profiled with CUDA activity alone."""

from portbench import layers


def read(m: layers.Reading):
    return layers.host_ms_per_step(m)
