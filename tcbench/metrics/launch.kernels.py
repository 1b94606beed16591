"""Device kernels of the traced sub-window (torch.profiler's records),
per launch (the benchmark's ranges around pipeline._simulate_batch)."""


def read(rec):
    if rec.trace is None:
        return None
    n = len(rec.trace.ranges.get('tcbench.launch', ()))
    k = len(rec.trace.kernels())
    return k / n if n and k else None
