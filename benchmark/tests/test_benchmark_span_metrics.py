"""The readers of the program's session spans on span lists made by hand,
as ``mimic3_tpu_torch.tracing.spans()`` gives them."""

from __future__ import annotations

import typing

import pytest

from benchmark import session_spans
from benchmark.harness import Artifacts
from benchmark.metrics import synth_session_host_ms, synth_session_wait_ms

MS = 1_000_000  # ns


class Span(typing.NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: typing.Optional[int] = None


def one_call(first: int, at: int, ms: int, totals: int, audio: int,
             decode: int = 0) -> typing.List[Span]:
    """A call of ``ms`` from ``at`` ms: its steps in order, the totals'
    and the audio's waits among them, and a noise draw under its
    duration pass (not a child of the call)."""
    t = at * MS
    return [
        Span("session.prepare", t, t + MS, first + 1, first),
        Span("session.duration", t + MS, t + 2 * MS, first + 2, first),
        Span("model.noise", t + MS, t + 2 * MS, first + 3, first + 2),
        Span("session.wait_totals", t + 2 * MS, t + (2 + totals) * MS,
             first + 4, first),
        Span("session.decode", t + (2 + totals) * MS,
             t + (2 + totals + decode) * MS, first + 5, first),
        Span("session.audio_to_host", t + (ms - audio) * MS, t + ms * MS,
             first + 6, first),
        Span("session.call", t, t + ms * MS, first),
    ]


def artifacts() -> Artifacts:
    return Artifacts(model={}, window_s=5.0, device_name="cpu")


@pytest.fixture
def recorded(monkeypatch):
    spans: typing.List[Span] = []
    monkeypatch.setattr(session_spans, "recorded", lambda: spans)
    return spans


def test_calls_sum_each_calls_own_waits():
    spans = one_call(10, 0, 100, totals=30, audio=5) + one_call(
        20, 200, 60, totals=4, audio=6, decode=20)
    got = session_spans.calls(spans)
    assert [x for call in got for x in call] == pytest.approx(
        [0.100, 0.035, 0.060, 0.010])


def test_readers_give_the_mean_over_calls(recorded):
    recorded += one_call(10, 0, 100, totals=30, audio=5) + one_call(
        20, 200, 60, totals=4, audio=6)
    assert synth_session_wait_ms.read(artifacts()) == pytest.approx(22.5)
    assert synth_session_host_ms.read(artifacts()) == pytest.approx(57.5)


def test_readers_are_silent_without_a_call(recorded):
    assert synth_session_wait_ms.read(artifacts()) is None
    assert synth_session_host_ms.read(artifacts()) is None
    # spans, but none of a session call (a server's, say)
    recorded.append(Span("scheduler.collect", 0, MS, 1))
    assert synth_session_wait_ms.read(artifacts()) is None
    assert synth_session_host_ms.read(artifacts()) is None


def test_a_program_without_spans_gives_no_calls(monkeypatch):
    """On a program that keeps no spans (no ``tracing`` module) the
    readers read nothing and do not raise."""
    import builtins

    real = builtins.__import__

    def no_tracing(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "mimic3_tpu_torch" and "tracing" in (fromlist or ()):
            raise ImportError("cannot import name 'tracing'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracing)
    assert session_spans.recorded() == []
    assert synth_session_wait_ms.read(artifacts()) is None
