"""Spans of the program's steps, kept in memory on the profiler's clock.

``span(name, **attrs)`` marks one step (the names are listed in
PERF.md §3).  Used as a context manager it becomes the parent of the
spans opened inside it; ``.set(**attrs)`` adds attributes known only
later.  A wait that starts in one thread and ends in another is opened
with ``span(...)`` alone and closed with ``.end()`` from any thread; it
is never a parent.

Off, meaning no ``torch.profiler`` is recording in the process, a span
costs one flag read, records nothing and does not enter
``record_function`` (which costs about 15 us even with profiling off).
The flag is ``torch.autograd.profiler._is_profiler_enabled``, which
every profiler sets for the whole process when it starts and clears when
it stops; ``torch._C._autograd._profiler_enabled()`` is kept per thread
and reads False on every thread under ``profile_all_threads``.

On, a span enters ``torch.profiler.record_function(name)``, so it is a
``user_annotation`` event of the capture's Chrome trace and the kernels
launched inside it carry a ``gpu_user_annotation``; and it appends a
:class:`Span` to the store.  A span ended on another thread than the one
that opened it is in a capture only under ``profile_all_threads`` (the
server's ``POST /api/profile``); the store always holds it.

Clock: ``start_ns`` and ``end_ns`` are ``time.time_ns()``, the host's
real-time clock (``CLOCK_REALTIME``), which the profiler stamps its
events with.  ``torch.profiler``'s Chrome trace gives an event's ``ts``
in microseconds from the ``baseTimeNanoseconds`` of the trace's header,
so a span's ``ts`` there is ``(start_ns - baseTimeNanoseconds) / 1000``,
and the profiler puts the device's kernels and copies on the same clock.

The store holds the spans of the latest stretch during which a profiler
ran: the first span opened after one was seen off empties it.
:func:`spans` returns a copy; past :data:`MAX_SPANS` records are dropped
and counted (:func:`dropped`).

Each record names its parent (the innermost span open in its context, a
``contextvars`` variable, so it follows asyncio tasks and goes into a
worker thread with ``contextvars.copy_context()``), the request it
serves (set with :func:`serving`; the HTTP server numbers its requests),
and the thread that opened it.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
import typing
from dataclasses import dataclass

import torch.autograd.profiler as _profiler

MAX_SPANS = 200_000

_PARENT: contextvars.ContextVar[typing.Optional[int]] = (
    contextvars.ContextVar("mimic3_span_parent", default=None)
)
_REQUEST: contextvars.ContextVar[typing.Any] = contextvars.ContextVar(
    "mimic3_request", default=None
)
_IDS = itertools.count(1)
_LOCK = threading.Lock()
_spans: typing.List["Span"] = []
_dropped = 0
# a span was asked for with no profiler recording: the next one opened
# while one records starts a new store
_stale = False


@dataclass(frozen=True)
class Span:
    """One recorded span."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: typing.Optional[int]
    request: typing.Optional[int]
    thread: str
    attrs: typing.Dict[str, typing.Any]


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "attrs", "id", "parent", "request", "thread",
                 "start_ns", "_rf", "_token")

    def __init__(self, name: str, attrs: typing.Dict[str, typing.Any]):
        self.name, self.attrs = name, attrs
        self.id = next(_IDS)
        self.parent = _PARENT.get()
        request = _REQUEST.get()
        self.request = None if request is None else request.id
        self.thread = threading.current_thread().name
        self._token: typing.Optional[contextvars.Token] = None
        self._rf: typing.Optional[_profiler.record_function] = (
            _profiler.record_function(name)
        )
        # before entering: the profiler stamps the event early in
        # __enter__, whose first call in a process takes milliseconds
        self.start_ns = time.time_ns()
        self._rf.__enter__()

    def set(self, **attrs: typing.Any) -> None:
        self.attrs.update(attrs)

    def end(self, **attrs: typing.Any) -> None:
        if self._rf is None:
            return
        end_ns = time.time_ns()
        self._rf.__exit__(None, None, None)
        self._rf = None
        self.attrs.update(attrs)
        _keep(Span(self.name, self.start_ns, end_ns, self.id, self.parent,
                   self.request, self.thread, self.attrs))

    def __enter__(self) -> "_Open":
        self._token = _PARENT.set(self.id)
        return self

    def __exit__(self, *exc: typing.Any) -> None:
        _PARENT.reset(self._token)
        self.end()


class _Off:
    """A span asked for while no profiler records: does nothing."""

    __slots__ = ()
    id = None

    def set(self, **attrs: typing.Any) -> None:
        pass

    def end(self, **attrs: typing.Any) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc: typing.Any) -> None:
        pass


_OFF = _Off()


def span(name: str, **attrs: typing.Any) -> typing.Union[_Open, _Off]:
    """A span named ``name``, recorded only while a profiler records."""
    global _stale
    if _profiler._is_profiler_enabled:
        if _stale:
            _new_stretch()
        return _Open(name, attrs)
    _stale = True
    return _OFF


def _new_stretch() -> None:
    global _stale, _dropped
    with _LOCK:
        if _stale:
            _spans.clear()
            _dropped = 0
            _stale = False


def _keep(record: Span) -> None:
    global _dropped
    with _LOCK:
        if len(_spans) < MAX_SPANS:
            _spans.append(record)
        else:
            _dropped += 1


def spans() -> typing.List[Span]:
    """The spans of the latest profiling stretch, in the order they
    ended."""
    with _LOCK:
        return list(_spans)


def dropped() -> int:
    """Spans of the latest stretch left out of the store (it was
    full)."""
    return _dropped


def request() -> typing.Any:
    """The request being served in this context, or None."""
    return _REQUEST.get()


@contextlib.contextmanager
def serving(
    req: typing.Any, parent: typing.Any = None
) -> typing.Iterator[None]:
    """Within: spans name ``req`` (an object with an ``id``) as the
    request they serve and ``parent`` (an open span, if any) as their
    parent."""
    request_token = _REQUEST.set(req)
    parent_token = _PARENT.set(getattr(parent, "id", None))
    try:
        yield
    finally:
        _PARENT.reset(parent_token)
        _REQUEST.reset(request_token)
