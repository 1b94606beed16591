"""Device time of the work launched inside the port's tc.launch.stacks
spans (fields.build_stacks' body) per launch (its tc.launch spans), in
ms: fields.stacks_ms from inside; None where the program has no spans."""


def read(rec):
    if rec.trace is None:
        return None
    n = len(rec.trace.ranges.get('tc.launch', ()))
    if not n:
        return None
    recs = rec.trace.launched_under('tc.launch.stacks')
    return sum(r[3] for r in recs) / n * 1e-3
