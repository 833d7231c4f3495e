"""Requests per device batch the server's scheduler formed across the
window: ``/api/stats`` ``scheduler.items`` over ``scheduler.batches``,
each diffed."""


def read(a):
    batches = a.counters.get("batches", 0)
    return a.counters["items"] / batches if batches else None
