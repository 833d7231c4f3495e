"""Share of the server's traced window (its own ``POST /api/profile``
over the load) in which no operation ran on the card: 1 - the union of
the trace's kernel, copy and set intervals over the window."""


def read(a):
    if a.trace is None or not a.trace.device:
        return None
    return 100.0 * (1.0 - a.trace.busy_s() / a.trace.window_s)
