"""host_syncs_per_step: the blocking CUDA calls a step (a stream, device
or event synchronize, a synchronous copy) made on the stepping thread
inside the program's ``train.step`` spans (train/resident.py), read in
the operator stretch, the one that records both those calls and the
program's spans (``portbench/spans.py``)."""

from portbench import spans


def read(m):
    return spans.host_syncs_per_step(m)
