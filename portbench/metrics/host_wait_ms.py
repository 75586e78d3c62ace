"""host_wait_ms: the host ms a step spent inside the blocking CUDA calls
that ``host_syncs_per_step`` counts, summed, read in the operator stretch
(``portbench/spans.py``)."""

from portbench import spans


def read(m):
    return spans.host_wait_ms(m)
