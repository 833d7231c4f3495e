"""The share of the traced window's duration passes replayed from a CUDA
graph, in %: the ``session.duration`` spans whose ``graph`` attribute is
``replay``, over every ``session.duration`` span.  A program whose spans
carry no ``graph`` (none that replays the pass) gives nothing."""

from __future__ import annotations

from .. import session_spans


def read(a):
    graphs = [getattr(s, "attrs", {}).get("graph")
              for s in session_spans.recorded()
              if s.name == "session.duration"]
    if not any(g is not None for g in graphs):
        return None
    return 100.0 * graphs.count("replay") / len(graphs)
