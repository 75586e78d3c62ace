"""A ``torch.profiler`` Chrome trace, read into what the per-layer metrics
need: the device's operations, each kernel's launching host operator, the
benchmark's spans, and the device's idle gaps with what the host was doing.

A kernel belongs to a host operator when the runtime call that launched it
(matched by its correlation id) lies inside that operator's interval on
the same host thread; so a kernel is found by the operator that launched
it, whatever the kernel is named.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
from typing import Callable, Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class Op:
    name: str
    ts: float      # microseconds
    dur: float
    tid: int
    cat: str
    corr: Optional[int] = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


class Trace:
    def __init__(self, events: Iterable[dict]):
        self.device: List[Op] = []
        self.host: List[Op] = []
        self.launch_of: Dict[int, Op] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            args = e.get("args") or {}
            op = Op(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)),
                    e.get("tid", 0), cat, args.get("correlation"))
            if cat in DEVICE_CATS:
                self.device.append(op)
            elif cat in LAUNCH_CATS and op.corr is not None:
                self.launch_of[op.corr] = op
            elif cat in HOST_CATS:
                self.host.append(op)
        self.device.sort(key=lambda o: o.ts)
        self.host.sort(key=lambda o: o.ts)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def kernels(self) -> List[Op]:
        return [o for o in self.device if o.cat == "kernel"]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of every device operation's interval, merged."""
        merged: List[List[float]] = []
        for o in self.device:
            if merged and o.ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], o.end)
            else:
                merged.append([o.ts, o.end])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def spans(self, name: str) -> List[Op]:
        return [o for o in self.host if o.name == name]

    def launched_under(self, match: Callable[[str], bool]) -> List[Op]:
        """The kernels whose launch lies inside a host operator whose name
        ``match`` accepts, on the launching thread."""
        by_tid: Dict[int, List[Op]] = collections.defaultdict(list)
        for o in self.host:
            if match(o.name):
                by_tid[o.tid].append(o)
        starts = {t: [o.ts for o in ops] for t, ops in by_tid.items()}
        out = []
        for k in self.kernels:
            launch = self.launch_of.get(k.corr)
            if launch is None or launch.tid not in by_tid:
                continue
            ops, st = by_tid[launch.tid], starts[launch.tid]
            i = bisect.bisect_right(st, launch.ts) - 1
            # operators of one name may nest (autograd's evaluate_function
            # around the node): look back over the enclosing candidates
            while i >= 0:
                if ops[i].ts <= launch.ts <= ops[i].end:
                    out.append(k)
                    break
                if launch.ts - ops[i].ts > 1e7:
                    break
                i -= 1
        return out

    def host_at(self, t: float, tid: int) -> str:
        """The innermost host operator or span running on thread ``tid`` at
        time ``t``, or 'host (no operator)'."""
        ops, st = self._host_of(tid), self._host_starts(tid)
        # the latest-starting operator that still runs at t is the
        # innermost; an outer one started earlier
        for i in range(bisect.bisect_right(st, t) - 1, -1, -1):
            if ops[i].end >= t:
                return ops[i].name
            if t - ops[i].ts > 1e7:
                break
        return "host (no operator)"

    def _host_of(self, tid: int) -> List[Op]:
        cache = self.__dict__.setdefault("_by_tid", {})
        if tid not in cache:
            cache[tid] = [o for o in self.host if o.tid == tid]
        return cache[tid]

    def _host_starts(self, tid: int) -> List[float]:
        cache = self.__dict__.setdefault("_starts", {})
        if tid not in cache:
            cache[tid] = [o.ts for o in self._host_of(tid)]
        return cache[tid]

    def idle_gaps(self, tid: int, top: int = 10) -> List[List]:
        """The device's idle gaps between merged busy intervals, summed by
        what the host thread ``tid`` was doing at each gap's middle ->
        [[name, seconds], ...], the largest first."""
        sums: Dict[str, float] = collections.defaultdict(float)
        busy = self.busy_intervals()
        for (_, a), (b, _) in zip(busy, busy[1:]):
            sums[self.host_at((a + b) / 2, tid)] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(sums.items(), key=lambda x: -x[1])
                [:top]]

    def top_device_ops(self, top: int = 10) -> List[List]:
        sums: Dict[str, float] = collections.defaultdict(float)
        for o in self.device:
            name = o.name if o.cat == "kernel" else f"{o.cat}: {o.name}"
            sums[name[:160]] += o.dur / 1e6
        return [[n, s] for n, s in sorted(sums.items(), key=lambda x: -x[1])
                [:top]]
