"""Launches thrown away and run again per traced year: the count of the
port's tc.driver.prefix_relaunch (a quota-prefix miss) and
tc.driver.uncapped_relaunch (a compaction-cap overflow) spans; None where
the program has no spans (no tc.launch)."""

NAMES = ('tc.driver.prefix_relaunch', 'tc.driver.uncapped_relaunch')


def read(rec):
    tr = rec.trace
    if tr is None or not tr.ranges.get('tc.launch') or not rec.traced_years:
        return None
    return sum(len(tr.ranges.get(n, ())) for n in NAMES) / rec.traced_years
