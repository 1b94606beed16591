"""Device time of K1 (the integrator's kernels by name) in the traced
sub-window, per launch (the port's tc.launch spans), in ms; None where the
program has no spans or no K1 kernel ran."""

NAMES = ('integrate_segment_kernel', 'integrate_group_kernel')


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    n = len(tr.ranges.get('tc.launch', ()))
    t = sum(d for name, _, _, d, _ in tr.kernels()
            if any(k in name for k in NAMES))
    if not n or t <= 0:
        return None
    return t / n * 1e-3
