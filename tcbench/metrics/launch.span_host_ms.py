"""Host time inside a launch, from the port's own tc.launch spans (opened
inside pipeline._simulate_batch and sharding.simulate_batch_sharded),
averaged over the traced launches, in ms: launch.host_ms from inside;
None where the program has no spans."""


def read(rec):
    if rec.trace is None:
        return None
    rs = rec.trace.ranges.get('tc.launch', ())
    if not rs:
        return None
    return sum(e - s for s, e in rs) / len(rs) * 1e-3
