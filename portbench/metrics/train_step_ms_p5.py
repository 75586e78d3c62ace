"""train_step_ms_p5: the 5th percentile of the untraced window's step
times (consecutive step-boundary CUDA events): the pace of the steps that
nothing held back.  Where the host paces the step, the host's speed drifts
over seconds to minutes and moves the rate and the p95 by several %
between runs; this low percentile moves by well under 1 % and still moves
with the host's and the device's work a step."""

from portbench import layers


def read(m: layers.Reading):
    return m.facts["step_ms_p5"]
