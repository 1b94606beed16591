"""Blocking host reads of the card's results per traced year: the count
of the port's tc.driver.wait spans, one a read; None where the program
has no spans (no tc.launch)."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.ranges.get('tc.launch') or not rec.traced_years:
        return None
    return len(tr.ranges.get('tc.driver.wait', ())) / rec.traced_years
