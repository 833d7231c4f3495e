"""Signatures the window ran for the first time after the server's
warmup (``/api/stats`` ``hot_path_compiles``, diffed): above 0 the warm
set is stale."""


def read(a):
    return a.counters.get("hot_path_compiles")
