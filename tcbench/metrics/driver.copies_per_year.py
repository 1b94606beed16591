"""Host copies of delivered tracks per traced year: the count of the
port's tc.driver.copy spans, one a batch whose rows are copied into a
year's own arrays (0: every year handed out as views of its transfer);
None where the program has no spans (no tc.launch)."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.ranges.get('tc.launch') or not rec.traced_years:
        return None
    return len(tr.ranges.get('tc.driver.copy', ())) / rec.traced_years
