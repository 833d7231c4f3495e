"""The host's blocking waits in a session call, mean over the traced
window's calls, in ms: the summed durations of each ``session.call``'s
``session.wait_totals`` (the read of the frame totals) and
``session.audio_to_host`` (the audio's copy to the host) spans."""

from __future__ import annotations

import statistics

from .. import session_spans


def read(a):
    calls = session_spans.calls()
    if not calls:
        return None
    return 1e3 * statistics.fmean(wait for _, wait in calls)
