"""The session's calls as the program's own spans give them
(``mimic3_tpu_torch.tracing``): the spans of the latest stretch in which
a profiler ran, which in a traced synth run is the traced window.

A program without that module, or a stretch without a ``session.call``,
gives no calls, and the readers that use this read nothing.
"""

from __future__ import annotations

import collections
import typing

# the host's blocking reads inside a call: the totals, then the audio
WAITS = ("session.wait_totals", "session.audio_to_host")


def recorded() -> typing.List[typing.Any]:
    """The program's spans, or none where it keeps none."""
    try:
        from mimic3_tpu_torch import tracing
    except ImportError:
        return []
    return tracing.spans()


def calls(spans: typing.Optional[typing.Sequence[typing.Any]] = None
          ) -> typing.List[typing.Tuple[float, float]]:
    """(seconds, waited seconds) of each ``session.call``: its duration,
    and the summed durations of its :data:`WAITS` children."""
    if spans is None:
        spans = recorded()
    waited: typing.Dict[int, float] = collections.defaultdict(float)
    for s in spans:
        if s.name in WAITS and s.parent is not None:
            waited[s.parent] += (s.end_ns - s.start_ns) * 1e-9
    return [((s.end_ns - s.start_ns) * 1e-9, waited[s.id])
            for s in spans if s.name == "session.call"]
