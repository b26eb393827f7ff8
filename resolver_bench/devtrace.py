"""What the device did in a traced window, read from torch.profiler.

Kernels, copies and memsets of the card (a CUDA-only trace holds nothing
else on the device; a copy's name starts "Memcpy", a memset's "Memset"),
each (name, start ns, end ns, kind) on the profiler's clock (Unix epoch
ns, the clock of time.time_ns()), clipped to the traced window. The host's own intervals (the harness's
clocks and the program's spans) are moved onto that clock to say what the
host did while the card idled. Imports nothing of the program.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple


class DeviceTrace:
    """`cards` cards' operations; busy time is each card's, averaged."""

    def __init__(self, events, t0_ns: int, t1_ns: int, cards: int = 1):
        self.t0_ns, self.t1_ns, self.cards = t0_ns, t1_ns, cards
        #: (name, start ns, end ns, kind) of every device operation
        self.ops: List[Tuple[str, int, int, str]] = []
        #: the card of each operation, in the order of `ops`
        self.card: List[int] = []
        for e in sorted(events, key=lambda e: e.start_ns()):
            if str(e.device_type()).rsplit(".", 1)[-1] != "CUDA":
                continue
            name = e.name()
            kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else "kernel")
            start = int(e.start_ns())
            self.ops.append((name, start, start + int(e.duration_ns()), kind))
            self.card.append(int(getattr(e, "device_index", lambda: 0)()))

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy(self, card: Optional[int] = None) -> List[Tuple[int, int]]:
        """The union of the operations in the window, of one card or of
        all, merged."""
        merged: List[Tuple[int, int]] = []
        for (_, s, e, _), c in zip(self.ops, self.card):
            if card is not None and c != card:
                continue
            s, e = max(s, self.t0_ns), min(e, self.t1_ns)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        return merged

    def busy_s(self) -> float:
        """Seconds in which an operation ran, averaged over the cards."""
        return sum(e - s for c in set(self.card) for s, e in self.busy(c)) / 1e9 / self.cards

    def kernel_s(self, name_part: Optional[str] = None, exclude: str = "\0") -> Tuple[float, int]:
        """Summed seconds and count of kernels in the window whose name holds
        `name_part` (every kernel when None) and not `exclude`."""
        total, n = 0, 0
        for name, s, e, kind in self.ops:
            if kind != "kernel" or not (self.t0_ns <= s < self.t1_ns):
                continue
            if name_part is not None and (name_part not in name or exclude in name):
                continue
            total += e - s
            n += 1
        return total / 1e9, n

    def top_ops(self, n: int = 10) -> List[List]:
        """The device operations that took most time, summed by name."""
        by: Dict[str, int] = {}
        for name, s, e, _ in self.ops:
            if self.t0_ns <= s < self.t1_ns:
                by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns / 1e9] for name, ns in top]

    def idle_by_host(self, host: Dict[str, Sequence[Tuple[int, int]]],
                     n: int = 10) -> List[List]:
        """The device's idle time in the window, summed by what the host was
        doing at each gap's middle: the names of the host intervals
        (`host`: name -> sorted, disjoint (start ns, end ns)) that hold it,
        joined by '+', or 'other host work'."""
        starts = {k: [s for s, _ in v] for k, v in host.items()}
        gaps: Dict[str, int] = {}
        prev = self.t0_ns
        for s, e in self.busy() + [(self.t1_ns, self.t1_ns)]:
            if s > prev:
                mid = (prev + s) // 2
                label = "+".join(k for k, v in host.items()
                                 if _holds(v, starts[k], mid)) or "other host work"
                gaps[label] = gaps.get(label, 0) + (s - prev)
            prev = max(prev, e)
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        return [[label, ns / 1e9] for label, ns in top]


def _holds(intervals: Sequence[Tuple[int, int]], starts: Sequence[int], t: int) -> bool:
    i = bisect_right(starts, t) - 1
    return i >= 0 and intervals[i][1] > t
