"""K1's share of its roofline over the traced sub-window: the least time
of the work the delivered tracks need (tcbench/roofline/k1.py, counted
from the reference's own tracks of the traced years), over the device
time of the integrator's kernels by name."""

from tcbench import roofline
from tcbench.roofline import k1

NAMES = ('integrate_segment_kernel', 'integrate_group_kernel')


def read(rec):
    if rec.trace is None or not rec.k1_work:
        return None
    t = sum(d for name, _, _, d, _ in rec.trace.kernels()
            if any(n in name for n in NAMES)) * 1e-6
    if t <= 0:
        return None
    least = roofline.least_seconds(k1.flops(rec.W, rec.k1_work),
                                   k1.nbytes(rec.W, rec.k1_work))
    return 100.0 * least / t
