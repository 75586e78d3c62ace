"""launches_per_step: kernel events a step in the stretch
profiled with CUDA activity alone.  The stretch draws its crops and gates
from a fixed seed."""

from portbench import layers


def read(m: layers.Reading):
    return layers.launches_per_step(m)
