"""Observability: structured logging, phase timing, the program's spans and
the profiler hook (twin of tropical_cyclone_risk_tpu/utils/obs.py; the
trace is ``torch.profiler``'s instead of ``jax.profiler``'s, and only the
port has spans).

Spans (``span``) are ``torch.profiler`` ranges, recorded only while a
profiler runs, into its buffer and on its clock, the clock the card's
kernels are aligned to; whoever holds the profiler writes them out
(``maybe_profile``, ``cli --trace-dir``).  Their names:

- ``tc.driver.dispatch``: the year driver's issue of a batch (a fused
  group's, a year's batch 0, a later batch) and its host transfer;
- ``tc.driver.wait``: one blocking host read of the card's results;
- ``tc.driver.copy``: the host's copy of one batch's delivered tracks
  into a year's own arrays, made only where a year takes several batches
  (a year one batch fills is handed out as views of its transfer);
  never nested in a wait, nor a wait in it;
- ``tc.driver.fallback``: a year the fused driver finishes on the
  per-year loop;
- ``tc.driver.prefix_relaunch``, ``tc.driver.uncapped_relaunch``: a launch
  thrown away and run again, for a quota-prefix miss or a cap overflow;
- ``tc.launch``: one launch, and inside it its stages
  ``tc.launch.propose``, ``.partition``, ``.draw``, ``.stacks``, ``.gate``,
  ``.segment`` (one per segment), ``.vmax`` and ``.compact``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

import torch

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


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a torch.profiler trace is
    recorded; otherwise one shared null context, so that a span costs a
    single check when nothing traces."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
