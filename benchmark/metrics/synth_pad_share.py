"""The share of the decoded frames that no real row returned, across the
traced window: 1 - ``frames_returned`` / ``frames_decoded`` of the
session's counters (``SessionStats``).  ``frames_decoded`` counts rows x
frame bucket of every decode dispatched, a speculative one that fell back
included, so this is the padding of the batch and frame buckets plus the
speculation's waste.  A program without the counters gives nothing."""


def read(a):
    decoded = a.counters.get("frames_decoded")
    returned = a.counters.get("frames_returned")
    if not decoded or returned is None:
        return None
    return 100.0 * (1.0 - returned / decoded)
