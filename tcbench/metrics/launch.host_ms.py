"""Host time inside a launch (the benchmark's range around
pipeline._simulate_batch), averaged over the traced launches, in ms."""


def read(rec):
    if rec.trace is None:
        return None
    rs = rec.trace.ranges.get('tcbench.launch', ())
    if not rs:
        return None
    return sum(e - s for s, e in rs) / len(rs) * 1e-3
