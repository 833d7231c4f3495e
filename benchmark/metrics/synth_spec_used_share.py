"""Calls whose decode was the speculative one, over the calls that
looked for a speculative bucket across the window
(``TorchVitsSession.speculation``: used over used, fell back and
skipped).  A call skips when its estimate lands on a frame bucket that
has never run; it then decodes only after the host has read the
totals.  0 is a reading: no call's speculation held."""


def read(a):
    used = a.counters.get("spec_used", 0)
    looked = (used + a.counters.get("spec_fell_back", 0)
              + a.counters.get("spec_skipped", 0))
    return 100.0 * used / looked if looked else None
