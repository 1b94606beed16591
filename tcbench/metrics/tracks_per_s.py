"""Tracks delivered to the host over every member completed in the
window, over the window's wall time from its start to the end of its last
completed member."""


def read(rec):
    if not rec.members:
        return None
    tracks = sum(m['tracks'] for m in rec.members)
    return tracks / (rec.members[-1]['end'] - rec.window_start)
