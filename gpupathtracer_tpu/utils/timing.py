"""Wall-clock timers and ray-throughput counters.

Role of src/misc/TimeUtil.{h,cpp} (frame timer, FPS averaging) plus the
Mrays/s accounting the reference lacks (SURVEY.md §5 tracing/profiling).
JAX is async: `block()` forces completion before reading the clock.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

import jax


def block(x):
    return jax.block_until_ready(x)


class Timer:
    """begin/end timer mirroring Timer::Begin/End/DebugTime."""

    def __init__(self) -> None:
        self._t0 = 0.0
        self.delta = 0.0

    def begin(self) -> None:
        self._t0 = time.perf_counter()

    def end(self) -> float:
        self.delta = time.perf_counter() - self._t0
        return self.delta


@dataclass
class FrameStats:
    """Running average FPS + ray counters (Program.cpp:148-150 avg FPS report).

    Ray counts may be recorded as device scalars, so the frame loop never
    waits for a readback. `finalize()` (or any stats property) drains
    pending device counters with one deferred sync."""

    frame_times: List[float] = field(default_factory=list)
    rays_traced: int = 0
    _pending: List = field(default_factory=list)

    def add_frame(self, dt: float, rays=0) -> None:
        self.frame_times.append(dt)
        if isinstance(rays, int):
            self.rays_traced += rays
        else:
            self._pending.append(rays)  # device scalar, drained lazily

    def finalize(self) -> None:
        if self._pending:
            import numpy as np
            self.rays_traced += int(sum(np.asarray(r) for r in self._pending))
            self._pending.clear()

    @property
    def avg_fps(self) -> float:
        if not self.frame_times:
            return 0.0
        return len(self.frame_times) / sum(self.frame_times)

    @property
    def mrays_per_sec(self) -> float:
        self.finalize()
        total = sum(self.frame_times)
        if total <= 0.0:
            return 0.0
        return self.rays_traced / total / 1e6

    def report(self) -> str:
        self.finalize()
        return (f"frames={len(self.frame_times)} avg_fps={self.avg_fps:.3f} "
                f"rays={self.rays_traced} mrays/s={self.mrays_per_sec:.2f}")
