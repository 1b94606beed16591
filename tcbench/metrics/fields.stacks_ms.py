"""Device time of the work launched inside fields.build_stacks (the
benchmark's range around it), per launch, in ms."""


def read(rec):
    if rec.trace is None:
        return None
    n = len(rec.trace.ranges.get('tcbench.launch', ()))
    recs = rec.trace.launched_under('tcbench.build_stacks')
    if not n or not recs:
        return None
    return sum(r[3] for r in recs) / n * 1e-3
