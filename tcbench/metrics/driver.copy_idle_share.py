"""The share of the card's idle time in the traced sub-window that lies
inside the port's tc.driver.copy spans (the host copying delivered
tracks), in %; None where the program has no spans (no tc.launch)."""

import numpy as np


def read(rec):
    tr = rec.trace
    if tr is None or not tr.ranges.get('tc.launch'):
        return None
    w0, w1 = tr.window
    edges = [w0] + [x for iv in tr.busy_intervals() for x in iv] + [w1]
    idle = np.array([(edges[i], edges[i + 1])
                     for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]).reshape(-1, 2)
    total = float((idle[:, 1] - idle[:, 0]).sum())
    if total <= 0:
        return 0.0
    # the copy spans merged, so that no idle time counts twice
    merged = []
    for s, e in sorted(tr.ranges.get('tc.driver.copy', ())):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    inside = sum(np.clip(np.minimum(e, idle[:, 1]) - np.maximum(s, idle[:, 0]),
                         0.0, None).sum() for s, e in merged)
    return 100.0 * float(inside) / total
