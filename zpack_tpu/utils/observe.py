"""Observability: per-phase timers/throughput counters and jax profiler
hooks.

The reference's only observability is printf progress lines and the
zpack_result code space (SURVEY.md §5).  Here every codec/pipeline phase
can record bytes+seconds into a process-global registry, and
:func:`trace` wraps a region in a jax.profiler trace for device timelines.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from dataclasses import dataclass


@dataclass
class PhaseStat:
    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0

    @property
    def mbps(self) -> float:
        return self.bytes / self.seconds / 1e6 if self.seconds else 0.0


@dataclass
class PhaseRecord:
    nbytes: int = 0


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._stats: dict[str, PhaseStat] = defaultdict(PhaseStat)

    @contextlib.contextmanager
    def phase(self, name: str, nbytes: int = 0):
        """Time a region; yields a record whose ``nbytes`` the region may
        set once it knows how many bytes it handled."""
        rec = PhaseRecord(nbytes)
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self._stats[name]
                s.calls += 1
                s.seconds += dt
                s.bytes += rec.nbytes

    def count(self, name: str, nbytes: int = 0) -> None:
        """Count one untimed event (e.g. a fallback taken) and its bytes."""
        with self._lock:
            s = self._stats[name]
            s.calls += 1
            s.bytes += nbytes

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {
                k: {"calls": v.calls, "seconds": round(v.seconds, 6),
                    "bytes": v.bytes, "MBps": round(v.mbps, 2)}
                for k, v in self._stats.items()
            }

    def report(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


#: process-global metrics registry
metrics = Metrics()


@contextlib.contextmanager
def trace(dirname: str):
    """jax.profiler trace around a region (device op timeline)."""
    import jax

    jax.profiler.start_trace(dirname)
    try:
        yield dirname
    finally:
        jax.profiler.stop_trace()
