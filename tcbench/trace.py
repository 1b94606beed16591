"""The traced sub-window: torch.profiler over a few members, its Chrome
trace read back into device intervals, kernel records and host ranges.

Times are microseconds on the profiler's clock, on which the host's
ranges and the card's kernels are aligned.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch

WINDOW = 'tcbench.window'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')
# a gap under no host operation but one of the benchmark's ranges: Python
RANGE_LABELS = {WINDOW: 'python: year driver',
                'tcbench.launch': 'python: launch',
                'tcbench.build_stacks': 'python: build_stacks'}


class Trace(NamedTuple):
    window: tuple          # (start, end) of the traced sub-window
    device: list           # (name, cat, start, dur, correlation)
    launch_at: dict        # correlation -> host time of its launch call
    ranges: dict           # range name -> [(start, end)]
    host: list             # (name, start, end) of host events

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self):
        """The merged intervals in which the card ran anything, clipped
        to the window."""
        w0, w1 = self.window
        iv = sorted((max(s, w0), min(s + d, w1)) for _, c, s, d, _ in
                    self.device if c in DEVICE_CATS and s + d > w0 and s < w1)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernels(self):
        w0, w1 = self.window
        return [k for k in self.device if k[1] == 'kernel' and w0 <= k[2] < w1]

    def launched_under(self, range_name: str):
        """Device records whose launch call lies inside a range."""
        rs = sorted(self.ranges.get(range_name, ()))
        if not rs:
            return []
        starts = np.array([s for s, _ in rs])
        ends = np.array([e for _, e in rs])
        out = []
        for rec in self.device:
            t = self.launch_at.get(rec[4])
            if t is None:
                continue
            i = np.searchsorted(starts, t, side='right') - 1
            if i >= 0 and t <= ends[i]:
                out.append(rec)
        return out

    def idle_gaps(self, top: int = 10, scan: int = 500):
        """The longest idle stretches of the card, summed by what the host
        was doing at each one's middle (its innermost host event)."""
        busy = self.busy_intervals()
        w0, w1 = self.window
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:scan]
        if not self.host:
            return []
        names = [h[0] for h in self.host]
        hs = np.array([h[1] for h in self.host])
        he = np.array([h[2] for h in self.host])
        by = defaultdict(float)
        for s, e in gaps:
            mid = 0.5 * (s + e)
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            label = ('python' if cover.size == 0 else
                     names[cover[np.argmin(he[cover] - hs[cover])]])
            label = RANGE_LABELS.get(label, label)
            by[label] += (e - s) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def device_ops(self, top: int = 10):
        by = defaultdict(float)
        for name, c, s, d, _ in self.kernels():
            by[short(name)] += d * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]


def short(name: str) -> str:
    """A kernel's name without its parameter list."""
    name = name.replace('(anonymous namespace)::', '')
    if name.startswith('void '):
        name = name[5:]
    cut = name.find('(')
    return (name[:cut] if cut > 0 else name)[:160]


def parse(events: list) -> Trace:
    device, launch_at, host = [], {}, []
    ranges = defaultdict(list)
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat = e.get('cat', '')
        s, d = float(e['ts']), float(e.get('dur', 0.0))
        args = e.get('args') or {}
        if cat in DEVICE_CATS:
            device.append((e['name'], cat, s, d, args.get('correlation')))
        elif cat in HOST_CATS:
            host.append((e['name'], s, s + d))
            if cat in ('cuda_runtime', 'cuda_driver') and 'correlation' in args:
                launch_at[args['correlation']] = s
            if cat == 'user_annotation':
                ranges[e['name']].append((s, s + d))
    w = ranges.get(WINDOW)
    window = w[0] if w else (0.0, 0.0)
    return Trace(window, device, launch_at, dict(ranges), host)


def profile(fn):
    """(fn's result, its Trace): fn runs under torch.profiler inside the
    window range, the card synchronised before the range ends."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            result = fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    return result, parse(events)
