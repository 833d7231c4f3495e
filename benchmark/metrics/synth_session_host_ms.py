"""The host's own work in a session call, mean over the traced window's
calls, in ms: each ``session.call`` span's duration less its blocking
waits (``synth_session_wait_ms``): launching the kernels from Python,
the host's noise draws, padding, bucket picks."""

from __future__ import annotations

import statistics

from .. import session_spans


def read(a):
    calls = session_spans.calls()
    if not calls:
        return None
    return 1e3 * statistics.fmean(call - wait for call, wait in calls)
