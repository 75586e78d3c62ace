"""What the per-layer readers share: the reading of a traced run, and the
arithmetic that turns a profiled stretch into a metric.

A reader (``metrics/<name>.py``) defines ``read(m: Reading)`` and returns
a number, or None when its run has nothing for it to read.  A quantity
that moves two end-to-end metrics is a metric of each name
(``elementwise_ms.train`` and ``.host_paced``); its arithmetic is here,
once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from portbench import flops
from portbench.harness import Stretch
from portbench.trace import Op

# host operators whose kernels are the attention kernels' (the port's
# autograd Function over the packed qkv, and its backward node), the
# optimizer's, and the names of cuBLAS's GEMM kernels
ATTN_FWD = ("PackedAttention",)
ATTN_BWD = ("PackedAttentionBackward",)
OPTIMIZER = ("Optimizer.step#",)
GEMM = ("nvjet", "gemm", "cutlass", "xmma")


@dataclasses.dataclass
class Reading:
    """A traced run as the readers see it: its two profiled stretches
    (``device``: CUDA activity alone; ``ops``: host operators too), the
    entry's facts (the untraced window's images_per_s and 5th percentile
    of its step times step_ms_p5, flops_per_image, dtype, attention shape
    (batch, tokens, heads, head_dim)) and the configuration."""
    device: Stretch
    ops: Stretch
    facts: Dict[str, Any]
    config: dict


def attn_fwd(name: str) -> bool:
    return name in ATTN_FWD


def attn_bwd(name: str) -> bool:
    return any(n in name for n in ATTN_BWD)


def optimizer(name: str) -> bool:
    return name.startswith(OPTIMIZER)


def under(m: Reading, match: Callable[[str], bool]) -> List[Op]:
    """The kernels launched inside host operators ``match`` accepts."""
    return m.ops.trace.launched_under(match)


def gemm_kernels(m: Reading) -> List[Op]:
    """cuBLAS's GEMMs that no attention or optimizer operator launched."""
    skip = {id(k) for k in under(m, lambda n: attn_fwd(n) or attn_bwd(n)
                                 or optimizer(n))}
    return [k for k in m.ops.trace.kernels if id(k) not in skip
            and any(t in k.name.lower() for t in GEMM)]


def elementwise_kernels(m: Reading) -> List[Op]:
    """Every kernel that is neither a GEMM nor launched by an attention or
    optimizer operator."""
    skip = {id(k) for k in under(m, lambda n: attn_fwd(n) or attn_bwd(n)
                                 or optimizer(n))}
    skip |= {id(k) for k in gemm_kernels(m)}
    return [k for k in m.ops.trace.kernels if id(k) not in skip]


def ms_per_unit(m: Reading, kernels: List[Op]) -> Optional[float]:
    """Device ms a step of ``kernels``; None if there are none."""
    if not kernels:
        return None
    return sum(k.dur for k in kernels) / 1e3 / m.ops.steps


def idle_pct(m: Reading) -> float:
    """The device stretch's idle share, in %."""
    return 100.0 * (1.0 - m.device.trace.busy_s() / m.device.window_s)


def roofline_pct(m: Reading, kind: str, kernels: List[Op]) -> Optional[float]:
    """The attention calls' bound over their kernels' device time, in %:
    one call a layer a step."""
    if not kernels:
        return None
    batch, seq, heads, head_dim = m.facts["attention"]
    bound, _ = flops.attention_bound_s(kind, batch, seq, heads, head_dim,
                                       m.facts["dtype"])
    calls = m.config["vision_cfg"]["layers"] * m.ops.steps
    return 100.0 * bound * calls / (sum(k.dur for k in kernels) / 1e6)


def mfu_pct(m: Reading) -> float:
    """Model FLOPs at the untraced window's rate over the policy's peak."""
    return (100.0 * m.facts["flops_per_image"] * m.facts["images_per_s"]
            / flops.PEAK_FLOPS[m.facts["dtype"]])


def host_ms_per_step(m: Reading) -> float:
    """The host clock around each step's call, in the stretch profiled
    with CUDA activity alone, where the profiler adds little."""
    return sum(m.device.host_ms) / len(m.device.host_ms)


def launches_per_step(m: Reading) -> float:
    return len(m.device.trace.kernels) / m.device.steps


def optimizer_ms(m: Reading) -> Optional[float]:
    return ms_per_unit(m, under(m, optimizer))


def elementwise_ms(m: Reading) -> Optional[float]:
    return ms_per_unit(m, elementwise_kernels(m))


def gemm_ms(m: Reading) -> Optional[float]:
    return ms_per_unit(m, gemm_kernels(m))


def attn_fwd_roofline(m: Reading) -> Optional[float]:
    return roofline_pct(m, "fwd", under(m, attn_fwd))


def attn_bwd_roofline(m: Reading) -> Optional[float]:
    return roofline_pct(m, "bwd", under(m, attn_bwd))
