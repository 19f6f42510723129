"""Logging and event timing (observability layer), after
``ddm_tpu/obs/logger.py``.

The leveled ``logger`` (``trace`` ... ``critical``, ``{}``-formatted
messages; level from the ``LOG_LEVEL`` environment variable or a
``--log-level=<lvl>`` argument consumed by :func:`setup_loggers`,
reference: dune/ddm/logger.hh:57-67, 557-580), a ``warn`` message function
that always prints, and families -> events with start/end pairs, a nesting guard that rejects a
double start, scoped timing and a total/mean/min/max report (reference:
dune/ddm/logger.hh ``Logger`` / ``ScopedLog``).  CUDA work is asynchronous,
so a scope given a CUDA device synchronizes it before it stops the clock:
phase times then hold the device work launched inside them.  Such a scope
also records the peak of allocated device memory while it was open
(``Event.peak_bytes``); ``Logger.peak_bytes`` keeps the peak over everything
since the last ``Logger.reset()``, in and between scopes.
"""

from __future__ import annotations

import enum
import os
import sys
import time
from dataclasses import dataclass, field

import torch


class Level(enum.IntEnum):
    trace = 0
    debug = 1
    info = 2
    warn = 3
    error = 4
    critical = 5
    off = 6


_LEVEL_NAMES = {level.name: level for level in Level}


class _Logger:
    """Leveled messages to stderr; one process, so the reference's
    ``*_all`` (every rank) variants are aliases."""

    def __init__(self) -> None:
        env = os.environ.get("LOG_LEVEL", "info").lower()
        self.level: Level = _LEVEL_NAMES.get(env, Level.info)
        self.stream = sys.stderr

    def set_level(self, level: Level | str) -> None:
        if isinstance(level, str):
            level = _LEVEL_NAMES[level.lower()]
        self.level = level

    def get_level(self) -> Level:
        return self.level

    def _log(self, level: Level, fmt: str, *args) -> None:
        if level < self.level:
            return
        msg = fmt.format(*args) if args else fmt
        print(f"[{level.name}] {msg}", file=self.stream)

    def trace(self, fmt, *a):
        self._log(Level.trace, fmt, *a)

    def debug(self, fmt, *a):
        self._log(Level.debug, fmt, *a)

    def info(self, fmt, *a):
        self._log(Level.info, fmt, *a)

    def warn(self, fmt, *a):
        self._log(Level.warn, fmt, *a)

    def error(self, fmt, *a):
        self._log(Level.error, fmt, *a)

    def critical(self, fmt, *a):
        self._log(Level.critical, fmt, *a)

    trace_all = trace
    debug_all = debug
    info_all = info
    warn_all = warn
    error_all = error


logger = _Logger()


def setup_loggers(argv: list[str] | None = None) -> list[str]:
    """Consume ``--log-level=<lvl>`` from ``argv`` (sets ``logger``'s
    level); returns the other arguments."""
    if argv is None:
        return []
    rest = []
    for a in argv:
        if a.startswith("--log-level="):
            logger.set_level(a.split("=", 1)[1])
        else:
            rest.append(a)
    return rest


@dataclass
class Event:
    family: str
    name: str
    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = 0.0
    peak_bytes: int = 0  # most device memory allocated inside the scope
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
        self.peak_bytes = 0

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

    # the reference's camel-case names, as in the JAX package
    registerOrGetEvent = register_or_get_event
    startEvent = start_event
    endEvent = end_event

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

    def _fold_peak(self) -> int:
        """Fold the allocator's peak since its last reset into the
        logger's running peak, restart the allocator's, return it (0
        before the process's first CUDA work, when there is no allocator
        to read)."""
        if not torch.cuda.is_initialized():
            return 0
        log = Logger.get()
        peak = torch.cuda.max_memory_allocated(self.device)
        log.peak_bytes = max(log.peak_bytes, peak)
        torch.cuda.reset_peak_memory_stats(self.device)
        return peak

    def __enter__(self):
        if self.device is not None and self.device.type == "cuda":
            self._fold_peak()
        Logger.get().start_event(self.event)
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.event.peak_bytes = max(self.event.peak_bytes,
                                        self._fold_peak())
        Logger.get().end_event(self.event)
        return False


def scoped(family: str, name: str, device=None) -> ScopedLog:
    return ScopedLog(Logger.get().register_or_get_event(family, name), device)


class profile_trace:
    """Context manager around ``torch.profiler.profile``: a device-level
    trace beside the host-side event tree.  It records CPU activity, and
    CUDA activity when CUDA is available; on exit it writes the trace as a
    Chrome trace ``trace_<pid>_<ns>.json`` into ``log_dir`` (made if
    missing) and keeps its path in ``path`` and the profiler in ``prof``
    (for ``prof.key_averages()`` or ``prof.events()``).  A profiler that
    does not start raises::

        with profile_trace("build/trace") as tr:
            solve(...)
        print(tr.path)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.prof = None
        self.path = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(
            self.log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        self.prof.export_chrome_trace(self.path)
        return False


def warn(fmt: str, *args) -> None:
    """Print a ``{}``-formatted warning to stderr (the JAX package's
    ``logger.warn``)."""
    print(f"[warn] {fmt.format(*args) if args else fmt}", file=sys.stderr)
