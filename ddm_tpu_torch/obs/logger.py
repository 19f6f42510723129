"""Event timing (observability layer), after ``ddm_tpu/obs/logger.py``.

Families -> events with start/end pairs, a nesting guard that rejects a
double start, scoped timing and a total/mean/min/max report (reference:
dune/ddm/logger.hh ``Logger`` / ``ScopedLog``).  CUDA work is asynchronous,
so a scope given a CUDA device synchronizes it before it stops the clock:
phase times then hold the device work launched inside them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Event:
    family: str
    name: str
    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = 0.0
    _start: float | None = field(default=None, repr=False)

    def record(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)


class Logger:
    """Event-timing registry, mirroring the reference's ``Logger``."""

    _instance: "Logger | None" = None

    def __init__(self) -> None:
        self.events: dict[tuple[str, str], Event] = {}

    @classmethod
    def get(cls) -> "Logger":
        if cls._instance is None:
            cls._instance = Logger()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = Logger()

    def register_or_get_event(self, family: str, name: str) -> Event:
        return self.events.setdefault((family, name), Event(family, name))

    def start_event(self, ev: Event) -> None:
        if ev._start is not None:
            raise RuntimeError(
                f"Event '{ev.family}/{ev.name}' started twice without end"
            )
        ev._start = time.perf_counter()

    def end_event(self, ev: Event) -> None:
        if ev._start is None:
            raise RuntimeError(f"Event '{ev.family}/{ev.name}' ended without start")
        ev.record(time.perf_counter() - ev._start)
        ev._start = None

    def report(self, stream=None) -> str:
        """Table of total/mean/min/max seconds and call counts, grouped by
        family in first-registration order."""
        header = (f"{'event':<42} {'calls':>6} {'total':>10} {'mean':>10} "
                  f"{'min':>10} {'max':>10}")
        lines = [header, "-" * len(header)]
        families = list(dict.fromkeys(fam for fam, _ in self.events))
        for fam in families:
            for (f, name), ev in self.events.items():
                if f != fam or ev.count == 0:
                    continue
                lines.append(
                    f"{fam + ' / ' + name:<42} {ev.count:>6} {ev.total:>10.4f} "
                    f"{ev.total / ev.count:>10.4f} {ev.min:>10.4f} {ev.max:>10.4f}"
                )
        out = "\n".join(lines)
        if stream is not None:
            print(out, file=stream)
        return out


class ScopedLog:
    """Scoped timing (reference: Logger::ScopedLog).  With a CUDA
    ``device`` the scope exit calls ``torch.cuda.synchronize(device)``."""

    def __init__(self, event: Event, device: torch.device | str | None = None):
        self.event = event
        self.device = torch.device(device) if device is not None else None

    def __enter__(self):
        Logger.get().start_event(self.event)
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        Logger.get().end_event(self.event)
        return False


def scoped(family: str, name: str, device=None) -> ScopedLog:
    return ScopedLog(Logger.get().register_or_get_event(family, name), device)
