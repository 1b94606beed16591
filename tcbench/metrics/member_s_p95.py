"""The 95th percentile of one member's wall time (the year driver's call
to its return, tracks on the host) over the members completed in the
window (linear interpolation between order statistics)."""

import numpy as np


def read(rec):
    if not rec.members:
        return None
    return float(np.percentile([m['end'] - m['start'] for m in rec.members],
                               95))
