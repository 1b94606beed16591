"""Launches per simulated year over the traced members: the change in the
port's count of seeding launches (one a launch) over their years."""


def read(rec):
    if rec.launches is None or not rec.traced_years:
        return None
    return rec.launches['seeding'] / rec.traced_years
