"""Host time copying delivered tracks into the host's arrays (the port's
tc.driver.copy spans: pipeline.Transfer.get's unpacking and
run_tracks_year's concatenation), per traced year, in ms; None where the
program has no spans (no tc.launch)."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.ranges.get('tc.launch') or not rec.traced_years:
        return None
    spans = tr.ranges.get('tc.driver.copy', ())
    return sum(e - s for s, e in spans) / rec.traced_years * 1e-3
