"""Observability: structured logging, phase timing and the profiler hook
(copy of tropical_cyclone_risk_tpu/utils/obs.py; the trace is
``torch.profiler``'s instead of ``jax.profiler``'s)."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

log = logging.getLogger('tc_risk_tpu')
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter('[%(name)s %(levelname).1s] %(message)s'))
    log.addHandler(_h)
    log.setLevel(logging.INFO)


class Metrics:
    """Named counters and timings of one run (seeds, tracks, phases)."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.timings: Dict[str, float] = {}

    def count(self, name: str, value: float = 1.0):
        self.counters[name] = self.counters.get(name, 0.0) + value

    def time(self, name: str, seconds: float):
        self.timings[name] = self.timings.get(name, 0.0) + seconds

    def rate(self, counter: str, timing: str) -> float:
        t = self.timings.get(timing, 0.0)
        return self.counters.get(counter, 0.0) / t if t else 0.0

    def summary(self) -> Dict[str, float]:
        out = dict(self.counters)
        out.update({f'{k}_s': v for k, v in self.timings.items()})
        return out


@contextlib.contextmanager
def phase(name: str, metrics: Optional[Metrics] = None):
    """Timed phase with structured logging."""
    t0 = time.perf_counter()
    log.info('%s: start', name)
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if metrics is not None:
            metrics.time(name, dt)
        log.info('%s: done in %.2f s', name, dt)


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """A torch.profiler trace (CPU and, where present, CUDA activity)
    written as a Chrome trace into ``trace_dir`` when one is given; a no-op
    otherwise."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(trace_dir, 'trace.json')
    prof.export_chrome_trace(path)
    log.info('profiler trace written to %s', path)
