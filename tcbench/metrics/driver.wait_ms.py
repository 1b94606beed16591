"""Host time waiting on the card in blocking reads (the port's
tc.driver.wait spans: pipeline.Transfer.get's event wait and
run_tracks_year's seed-count read), per traced year, in ms; None where
the program has no spans (no tc.launch)."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.ranges.get('tc.launch') or not rec.traced_years:
        return None
    spans = tr.ranges.get('tc.driver.wait', ())
    return sum(e - s for s, e in spans) / rec.traced_years * 1e-3
