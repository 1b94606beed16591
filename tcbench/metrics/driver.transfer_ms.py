"""Device time of the work launched inside the port's tc.driver.transfer
spans (pipeline.Transfer: the concatenation of a batch's or a group's
track rows on the card and their copy into pinned host memory), per
traced year, in ms; None where the program has no such span."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.ranges.get('tc.driver.transfer') \
            or not rec.traced_years:
        return None
    recs = tr.launched_under('tc.driver.transfer')
    return sum(r[3] for r in recs) / rec.traced_years * 1e-3
