"""``synth_duration_graph_share`` on span lists made by hand, as
``mimic3_tpu_torch.tracing.spans()`` gives them."""

from __future__ import annotations

import typing

import pytest

from benchmark import session_spans
from benchmark.harness import Artifacts
from benchmark.metrics import synth_duration_graph_share

MS = 1_000_000  # ns


class Span(typing.NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: typing.Optional[int] = None
    attrs: typing.Dict[str, typing.Any] = {}


def passes(*graphs: typing.Optional[str]) -> typing.List[Span]:
    """A call with one duration pass for each of ``graphs`` (None: the
    span carries no ``graph``), and a span of another step beside it."""
    spans = []
    for i, graph in enumerate(graphs):
        attrs = {} if graph is None else {"graph": graph}
        spans += [
            Span("session.duration", i * MS, (i + 1) * MS, 2 * i + 2,
                 2 * i + 1, attrs),
            Span("session.decode", i * MS, (i + 1) * MS, 2 * i + 3,
                 2 * i + 1, {"window": 0}),
        ]
    return spans


def artifacts() -> Artifacts:
    return Artifacts(model={}, window_s=5.0, device_name="cpu")


@pytest.fixture
def recorded(monkeypatch):
    spans: typing.List[Span] = []
    monkeypatch.setattr(session_spans, "recorded", lambda: spans)
    return spans


@pytest.mark.parametrize("graphs,share", [
    (("replay",) * 4, 100.0),
    (("eager", "capture", "replay", "replay"), 50.0),
    (("eager",) * 3, 0.0),
])
def test_share_of_the_passes_replayed(recorded, graphs, share):
    recorded += passes(*graphs)
    assert synth_duration_graph_share.read(artifacts()) == pytest.approx(
        share)


def test_silent_where_no_span_carries_graph(recorded):
    # no spans at all, then the parent's spans: passes without the
    # attribute, and other steps
    assert synth_duration_graph_share.read(artifacts()) is None
    recorded += passes(None, None)
    assert synth_duration_graph_share.read(artifacts()) is None


def test_spans_without_attrs_are_read(recorded):
    """Spans that carry no ``attrs`` at all read as carrying no
    ``graph``."""
    class Bare(typing.NamedTuple):
        name: str

    recorded += [Bare("session.duration"), Bare("session.call")]
    assert synth_duration_graph_share.read(artifacts()) is None
