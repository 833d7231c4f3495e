"""Synthesis session on one torch device: buckets, two-stage flow, streaming.

Counterpart of ``mimic3_tpu/runtime/session.py::VitsSession`` with the
surface the voice layer, the engine, the batching scheduler and the HTTP
server call: ``synthesize_ids``, ``synthesize_ids_batch``,
``synthesize_ids_chunked``, ``stream_start_batch``, ``warmup``,
``jit_executable_count``, ``hot_path_compiles``, ``batcher``, ``dp``,
``allow_bucket_growth``, ``get_shared`` and ``stats``.

Inputs are padded to the same text, batch and frame buckets as the
reference.  Synthesis is a duration pass, one host sync on the frame
totals, then a decode pass over the frame bucket covering the longest
output.  As in the reference, the batch path speculates that decode: it
enqueues it at a frame bucket predicted from a running estimate of frames
per phoneme before it waits for the totals, and keeps it if the bucket
was large enough (the prior noise is frame-indexed, so the bucket never
changes the audio).  On a card the host waits for the totals' own copy
(pinned memory and an event), not for the speculative decode queued
behind it.  Streaming runs one fused pass (encoder once, durations, first
window) and then decodes overlapped windows from the kept encoder
statistics; the frame-indexed prior noise makes the windows seam-exact.

Every device call runs inside the host-side ``_device_call`` tracker, so
``wait_device_idle`` (the server's shutdown) sees it, with autograd off
and float32 convolutions in float32.  The tracker, the kill-safe SIGTERM,
``SessionStats``, ``hit_key``, ``expand_profile_batches`` and
``pick_bucket`` are port copies of those in
``mimic3_tpu/runtime/session.py``.

With ``mesh`` (``parallel.make_mesh``) the batch path runs data
parallel, the counterpart of the reference's dp mesh: each dp replica
holds the params and stage-kernel weights on its device, the duration
pass runs per shard of rows, one host sync reads every shard's totals,
and each shard decodes its rows at the one frame bucket on its own
device (the stage kernel included).  Rows come back in order; on a mesh
over several processes every rank computes its own shards and receives
every row.  Streaming runs on replica 0.  With ``use_tp`` on a mesh whose
tp axis is larger than 1, each dp row splits the tp-ruled weights over
its tp devices (``parallel/mesh.py::shard_params``): the encoder FFNs
Megatron style, the decoder's upsamplers by output channel, the convs
routed through ``parallel/tensor.py`` and the rest on the row's first
device.  Over a mesh whose tp rows span processes every rank of a row
runs the row's program on its device with its own part of each split
leaf, and the collectives run over the row's process group.  As in the
reference, the fused stage kernel is off under any ``tp > 1`` mesh.

Not ported yet: CUDA graphs per warmed signature.
"""

from __future__ import annotations

import bisect
import contextlib
import logging
import queue
import threading
import time
import typing
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import TrainingConfig
from ..models.vits.model import VitsModel, mix_seed
from ..parallel import Mesh, all_gather_rows, batch_sharding, shard_params
from .convert import to_torch_params

_LOGGER = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Device-call tracking and kill-safe shutdown
# ---------------------------------------------------------------------------

_DEVICE_CALLS = 0
_DEVICE_CALLS_COND = threading.Condition()
_SHUTDOWN_EVENT = threading.Event()


class _device_call:
    """Marks one device dispatch in flight."""

    def __enter__(self) -> "_device_call":
        global _DEVICE_CALLS
        with _DEVICE_CALLS_COND:
            _DEVICE_CALLS += 1
        return self

    def __exit__(self, *exc) -> None:
        global _DEVICE_CALLS
        with _DEVICE_CALLS_COND:
            _DEVICE_CALLS -= 1
            if _DEVICE_CALLS == 0:
                _DEVICE_CALLS_COND.notify_all()


def device_calls_in_flight() -> int:
    """Number of device calls currently running."""
    with _DEVICE_CALLS_COND:
        return _DEVICE_CALLS


def wait_device_idle(timeout: typing.Optional[float] = None) -> bool:
    """Block until no device call is in flight; True if idle reached."""
    deadline = None if timeout is None else time.monotonic() + timeout
    with _DEVICE_CALLS_COND:
        while _DEVICE_CALLS > 0:
            remaining = (
                None if deadline is None else deadline - time.monotonic()
            )
            if remaining is not None and remaining <= 0:
                return False
            _DEVICE_CALLS_COND.wait(timeout=remaining)
    return True


def request_graceful_shutdown() -> None:
    """Ask long device loops (warmup grids) to stop at the next safe
    point, between signatures."""
    _SHUTDOWN_EVENT.set()


def graceful_shutdown_requested() -> bool:
    return _SHUTDOWN_EVENT.is_set()


def reset_graceful_shutdown() -> None:
    """Clear the shutdown request (tests / long-lived embedders)."""
    _SHUTDOWN_EVENT.clear()


def install_kill_safe_sigterm() -> None:
    """SIGTERM defers while a device call is in flight.

    First SIGTERM: cancel warmup grids at the next signature boundary,
    wait for in-flight calls to drain, then raise KeyboardInterrupt in
    the main thread.  Second SIGTERM: force immediate KeyboardInterrupt
    (operator escape hatch).  Call from the main thread of any
    device-owning process (server, bench).
    """
    import _thread
    import signal

    # Delivery acknowledgment for the drain thread below.  CPython race:
    # a signal tripped in the window around
    # entry into a blocking call (time.sleep, lock wait) is NOT
    # processed until that call returns on its own — blocking calls
    # only re-check signals on EINTR, and a signal whose C-level
    # handler already ran won't EINTR the syscall again.  One
    # pthread_kill is therefore not enough; the drain thread retries
    # until the Python-level handler actually ran.  Retries are safe:
    # pending deliveries coalesce at the CPython trip-flag level, and
    # we stop as soon as the handler acknowledges.
    sigint_seen = threading.Event()

    def _sigint(signum, frame):
        sigint_seen.set()
        raise KeyboardInterrupt  # same semantics as the default handler

    def _sigterm(signum, frame):
        if graceful_shutdown_requested():
            raise KeyboardInterrupt  # second SIGTERM: force
        request_graceful_shutdown()  # cancel any warmup grid
        if device_calls_in_flight() == 0:
            raise KeyboardInterrupt
        _LOGGER.warning(
            "SIGTERM deferred: %d device call(s) in "
            "flight; exiting when they drain (SIGTERM again to force)",
            device_calls_in_flight(),
        )

        def _exit_when_idle():
            wait_device_idle(timeout=7200)
            main = threading.main_thread()
            sigint_seen.clear()
            for _ in range(600):  # bounded: ~10 min of retries
                try:
                    # pthread_kill targets the main thread directly so
                    # a blocked syscall gets EINTR; interrupt_main()
                    # alone only fires at the next bytecode boundary.
                    signal.pthread_kill(main.ident, signal.SIGINT)
                except (ProcessLookupError, ValueError, RuntimeError):
                    _thread.interrupt_main()
                    return
                if sigint_seen.wait(timeout=1.0) or not main.is_alive():
                    return
            _thread.interrupt_main()  # last resort

        threading.Thread(target=_exit_when_idle, daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    signal.signal(signal.SIGINT, _sigint)


# ---------------------------------------------------------------------------
# Statistics, signatures and buckets
# ---------------------------------------------------------------------------


@dataclass
class SessionStats:
    """Rolling synthesis statistics (RTF = infer_sec / audio_sec).

    Recorded from scheduler and direct-caller threads and read by
    /api/stats; all mutation and history reads go through ``_lock``.
    """

    utterances: int = 0
    infer_sec: float = 0.0
    audio_sec: float = 0.0
    compile_count: int = 0
    last_rtf: float = 0.0
    rtf_history: typing.List[float] = field(default_factory=list)
    latency_history: typing.List[float] = field(default_factory=list)
    executable_hits: typing.Dict[str, int] = field(default_factory=dict)
    bucket_fallbacks: typing.Dict[str, int] = field(default_factory=dict)
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def record_hit(self, key: str) -> None:
        """Count a dispatch of one signature.

        Keys come from :func:`hit_key`.  /api/stats exposes the table so
        a deployment can save its real traffic profile and restart with
        ``--warmup-profile``, warming only the executables its requests
        actually dispatch instead of the full bucket grid.
        """
        with self._lock:
            self.executable_hits[key] = (
                self.executable_hits.get(key, 0) + 1
            )

    def hits_snapshot(self) -> typing.Dict[str, int]:
        """Copy of ``executable_hits`` taken under ``_lock`` — request
        threads mutate the dict through :meth:`record_hit`, and a
        resize during an unlocked ``dict()`` copy raises RuntimeError."""
        with self._lock:
            return dict(self.executable_hits)

    def record_bucket_fallback(self, natural: str, used: str) -> int:
        """Count one warmed-bucket fallback (``natural`` signature was
        not warmed; the request dispatched ``used`` instead).  Returns
        the new count for this mapping so the caller can log first
        occurrences only."""
        key = f"{natural}->{used}"
        with self._lock:
            n = self.bucket_fallbacks.get(key, 0) + 1
            self.bucket_fallbacks[key] = n
            return n

    def fallbacks_snapshot(self) -> typing.Dict[str, int]:
        with self._lock:
            return dict(self.bucket_fallbacks)

    def record(self, infer_sec: float, audio_sec: float) -> None:
        with self._lock:
            self.utterances += 1
            self.infer_sec += infer_sec
            self.audio_sec += audio_sec
            self.last_rtf = (
                infer_sec / audio_sec if audio_sec > 0 else 0.0
            )
            self.rtf_history.append(self.last_rtf)
            self.latency_history.append(infer_sec)
            if len(self.rtf_history) > 1000:
                del self.rtf_history[:-1000]
            if len(self.latency_history) > 1000:
                del self.latency_history[:-1000]

    @property
    def mean_rtf(self) -> float:
        return self.infer_sec / self.audio_sec if self.audio_sec else 0.0

    def latency_percentile(self, pct: float) -> float:
        """Synthesis-call latency percentile over the recent window."""
        with self._lock:
            ordered = sorted(self.latency_history)
        if not ordered:
            return 0.0
        idx = min(
            len(ordered) - 1, int(pct / 100.0 * len(ordered))
        )
        return ordered[idx]


def hit_key(
    kind: str, b: int, t: int, f: typing.Optional[int] = None
) -> str:
    """Stable name of one signature: (kind, batch bucket, text
    bucket[, frame/window bucket]), the static shapes of one device
    call.  Used by SessionStats.record_hit and warmup profiles.
    """
    key = f"{kind}:b{int(b)}:t{int(t)}"
    return key if f is None else f"{key}:f{int(f)}"


def expand_profile_batches(
    profile: typing.Collection[str],
    batch_buckets: typing.Sequence[int],
    frame_buckets: typing.Optional[typing.Sequence[int]] = None,
) -> typing.FrozenSet[str]:
    """Close a captured traffic profile over the batch-bucket ladder.

    A raw /api/stats ``executable_hits`` capture records only the batch
    buckets that request ARRIVAL TIMING happened to realize (the
    scheduler packs whatever is queued); a later run with the same
    traffic content WILL hit other buckets.  Text buckets stay exactly
    as observed — they are functions of the traffic's content.

    Frame buckets are NOT purely content-derived for batched decode:
    the decode executable's frame bucket is ``bucket(max frames in
    batch)``, the stochastic duration predictor jitters per-row totals,
    and the batch max is monotone in batch size — so the same traffic
    near a bucket boundary crosses into the NEXT frame bucket when the
    scheduler packs a bigger batch (observed live: phase-0 saw
    ``decode:*:f128``, the measurement run dispatched
    ``decode:b8:*:f256`` and paid a hot-path compile).  Each f-keyed
    signature is therefore also closed over the next-larger frame
    bucket when ``frame_buckets`` is given.

    ``VitsSession.warmup`` applies this closure itself, so raw
    /api/stats captures are safe to pass to ``--warmup-profile``.
    """
    fb = sorted(int(f) for f in frame_buckets) if frame_buckets else []

    def next_f(f: int) -> typing.Optional[int]:
        for cand in fb:
            if cand > f:
                return cand
        return None

    keys: typing.Set[str] = set()
    for key in profile:
        parts = key.split(":")  # kind : bN : tN [: fN]
        if (
            len(parts) < 3
            or not parts[1][:1] == "b"
            or not parts[1][1:].isdigit()
            or not parts[2][:1] == "t"
            or not parts[2][1:].isdigit()
            or (len(parts) > 3 and not parts[3][1:].isdigit())
        ):
            raise ValueError(
                f"Malformed warmup-profile signature {key!r} — expected "
                "'kind:bN:tN[:fN]' hit keys as recorded in /api/stats "
                "executable_hits"
            )
        frames = (
            [parts[3]] if len(parts) > 3 else [None]
        )
        if len(parts) > 3:
            up = next_f(int(parts[3][1:]))
            if up is not None:
                frames.append(f"f{up}")
        for b in batch_buckets:
            parts[1] = f"b{int(b)}"
            for f_part in frames:
                if f_part is not None:
                    parts[3] = f_part
                keys.add(":".join(parts))
    return frozenset(keys)


def pick_bucket(
    n: int, buckets: typing.Sequence[int], grow: bool = False
) -> int:
    """Smallest bucket >= n.

    By default inputs past the largest bucket are CLAMPED to it (the
    caller truncates), so serving stays on the warmed signatures.  Pass
    ``grow=True`` to instead extend the ladder geometrically (offline
    use).
    """
    idx = bisect.bisect_left(buckets, n)
    if idx < len(buckets):
        return buckets[idx]
    if not grow:
        return buckets[-1]
    cap = buckets[-1]
    while cap < n:
        cap *= 2
    return cap


def resolve_device(
    device: typing.Union[str, torch.device, None] = None,
) -> torch.device:
    """The device named, else ``cuda``.  A CUDA device with no card
    visible raises: the CPU is used only when a caller names it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; name the CPU explicitly "
            "(device='cpu', --device cpu) to synthesize on it"
        )
    return device


# The fused-stage gate on the card by decoder dtype, when the voice's
# tpu.pallas_stage_max_channels does not set it: for each dtype, the
# widest decoder stage at which the kernel is no slower than the plain
# cuDNN path at B=1 and B=4 in the 128- and 256-frame buckets (the sweep
# in chip_smoke.py, which fails when it finds another value; PERF.md).
# Both dtypes run the stage on tensor cores: bf16 on bf16 MMAs, f32 on
# three TF32 passes.  f32 stops at 32: at C = 64 its f32 buffers leave a
# tile of about 100 rows against a 120-row halo, and cuDNN is faster.
STAGE_MAX_CHANNELS = {torch.float32: 32, torch.bfloat16: 64}


class _SharedCudnnFlag:
    """A process-wide ``torch.backends.cudnn`` flag held at one value while
    any user is inside :meth:`held`.  Sessions run on several threads
    (request workers, the scheduler, continuation drivers): the first of
    overlapping users sets the flag and the last restores the previous
    value."""

    def __init__(self, name: str, value: bool):
        self._name = name
        self._value = value
        self._lock = threading.Lock()
        self._users = 0
        self._previous = value

    @contextlib.contextmanager
    def held(self) -> typing.Iterator[None]:
        with self._lock:
            if self._users == 0:
                self._previous = getattr(torch.backends.cudnn, self._name)
                setattr(torch.backends.cudnn, self._name, self._value)
            self._users += 1
        try:
            yield
        finally:
            with self._lock:
                self._users -= 1
                if self._users == 0:
                    setattr(torch.backends.cudnn, self._name, self._previous)


_NO_TF32 = _SharedCudnnFlag("allow_tf32", False)
_DETERMINISTIC_ALGORITHMS = _SharedCudnnFlag("deterministic", True)


def full_f32_convolutions() -> typing.ContextManager[None]:
    """Run float32 convolutions in float32.

    cuDNN computes them in TF32 by default (about three decimal digits),
    which would move the encoder's and duration predictor's outputs away
    from the reference; the decoder's speed path is its bf16 dtype.
    """
    return _NO_TF32.held()


def deterministic_convolutions() -> typing.ContextManager[None]:
    """Let cuDNN pick only algorithms that give the same bits every run.

    Its heuristics otherwise pick, for some transposed-convolution shapes
    (MB-iSTFT's first upsampler), an algorithm that accumulates with
    atomics, so two deterministic calls can differ in their last bits,
    and then in the WAV's bytes.
    """
    return _DETERMINISTIC_ALGORITHMS.held()


@contextlib.contextmanager
def device_work(deterministic: bool = False) -> typing.Iterator[None]:
    """One device call: tracked as in flight, autograd off (per thread),
    float32 convolutions in float32, and with ``deterministic`` only
    deterministic cuDNN algorithms."""
    with _device_call(), torch.inference_mode(), full_f32_convolutions(), (
        deterministic_convolutions() if deterministic
        else contextlib.nullcontext()
    ):
        yield


def _start_host_copy(
    t: torch.Tensor,
) -> typing.Callable[[], np.ndarray]:
    """Start copying a small device tensor to the host; returns a wait
    that blocks for that copy alone and gives the array.

    On a card the copy goes to pinned memory without blocking and an
    event marks its end, so work enqueued after this call (the
    speculative decode) does not delay the wait, as ``.cpu()`` would.
    """
    if t.device.type != "cuda":
        return lambda: t.cpu().numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))

    def wait() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return wait


def _recap(durations: np.ndarray, cap: int) -> np.ndarray:
    """Clamp cumulative durations at ``cap`` frames (truncation)."""
    cum = np.minimum(np.cumsum(durations, axis=1), cap)
    return np.concatenate([cum[:, :1], np.diff(cum, axis=1)], axis=1)


class _LazyHostRows:
    """Device tensors copied to the host once, lazily, shared by the row
    generators of one batched stream start.  The copy happens after the
    first chunks are out (off the first-chunk latency path) and only if
    some stream needs a continuation window."""

    def __init__(self, *tensors: torch.Tensor):
        self._dev: typing.Optional[typing.Tuple[torch.Tensor, ...]] = tensors
        self._np: typing.Optional[typing.Tuple[np.ndarray, ...]] = None
        self._lock = threading.Lock()

    def host(self) -> typing.Tuple[np.ndarray, ...]:
        with self._lock:
            if self._np is None:
                assert self._dev is not None
                self._np = tuple(t.cpu().numpy() for t in self._dev)
                self._dev = None
            return self._np


class _ContinuationDriver:
    """Batched continuation decode for one fused stream start.

    Counterpart of the reference's driver (same contract): streams that
    started together in :meth:`TorchVitsSession.stream_start_batch` share
    a chunk grid, a seed and padded device tensors, so their continuation
    windows run as ONE batched decode per window.  A daemon thread decodes
    window k for the whole padded batch and puts each row's valid samples
    on its queue.  It is demand-paced: at most ``PREFETCH`` windows ahead
    of the fastest row still being consumed, so an idle group stops using
    the device.  The audio equals the per-row path's (the prior noise is
    frame-indexed and shared across batch rows).
    """

    PREFETCH = 2
    # no live row advanced while production was blocked for this long:
    # every consumer is gone or wedged — fail their queues and release
    # the device tensors instead of keeping the thread forever
    STALL_TIMEOUT = 600.0

    def __init__(
        self,
        session: "TorchVitsSession",
        dev_args: typing.Tuple,
        seed: int,
        noise_scale: float,
        totals: typing.Sequence[int],
        first_cf: int,
        chunk_frames: int,
        overlap: int,
    ):
        self._session = session
        self._dev_args = dev_args  # ids, lengths, sid, durations, m_p, logs_p
        self._seed = seed
        self._noise_scale = float(noise_scale)
        self._totals = [int(t) for t in totals]
        self._batch = len(self._totals)
        self._first_cf = first_cf
        self._chunk_frames = chunk_frames
        self._overlap = overlap
        self._queues: typing.List[queue.SimpleQueue] = [
            queue.SimpleQueue() for _ in range(self._batch)
        ]
        # consumed[i]: highest window index row i's consumer has pulled
        # (0 = only the fused first chunk); alive[i] goes False when the
        # row's generator finishes or is closed (client disconnect)
        self._consumed = [0] * self._batch
        self._alive = [True] * self._batch
        self._cond = threading.Condition()
        self.windows_produced = 0  # introspection for tests
        threading.Thread(
            target=self._run, daemon=True, name="tts-continuation-driver"
        ).start()

    # -- producer --------------------------------------------------------------

    def _may_produce(self, k: int) -> typing.Optional[bool]:
        """True = produce window k now; False = wait; None = abort."""
        live = [
            self._consumed[i] for i in range(self._batch) if self._alive[i]
        ]
        if not live:
            return None
        return k <= max(live) + self.PREFETCH

    def _wait_for_demand(self, k: int) -> bool:
        """Block until window k is wanted; False when every consumer is
        gone.  Raises on shutdown or a stall."""
        deadline = time.monotonic() + self.STALL_TIMEOUT
        with self._cond:
            while True:
                state = self._may_produce(k)
                if state is None:
                    return False
                if state:
                    return True
                if graceful_shutdown_requested():
                    raise RuntimeError(
                        "continuation decode cancelled: shutdown requested"
                    )
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RuntimeError(
                        "continuation consumers stalled for "
                        f"{self.STALL_TIMEOUT:.0f}s"
                    )
                self._cond.wait(timeout=min(remaining, 5.0))

    def _run(self) -> None:
        session = self._session
        hop = session.model.hp.hop_length
        cf = self._chunk_frames
        window = cf + 2 * self._overlap
        ids, lengths, sid, durations, m_p, logs_p = self._dev_args
        try:
            start = self._first_cf
            k = 1
            while True:
                rows = [
                    i for i in range(self._batch) if start < self._totals[i]
                ]
                if not rows or not self._wait_for_demand(k):
                    return
                left = min(self._overlap, start)
                session._note_run(
                    hit_key("chunk", ids.shape[0], ids.shape[1], window)
                )
                # inference mode is per thread: device_work enters it here
                with device_work(session.deterministic):
                    audio, _ = session.model.decode_frames(
                        session.params, ids, lengths, durations, window,
                        self._seed, self._noise_scale, sid=sid,
                        frame_offset=start - left, enc_stats=(m_p, logs_p),
                        stage_weights=session.stage_weights,
                    )
                    audio_np = audio.float().cpu().numpy()  # one copy
                self.windows_produced += 1
                for i in rows:
                    valid = min(cf, self._totals[i] - start)
                    self._queues[i].put(
                        audio_np[i, left * hop : (left + valid) * hop].copy()
                    )
                start += cf
                k += 1
        except BaseException as err:  # noqa: BLE001 — forwarded to rows
            for q in self._queues:
                q.put(err)
        finally:
            self._dev_args = None  # release device tensors promptly

    # -- consumers -------------------------------------------------------------

    def row(
        self, i: int, first_chunk: np.ndarray
    ) -> typing.Iterator[np.ndarray]:
        """Yield row ``i``'s chunks (the first one from the fused start)."""
        session = self._session
        hop = session.model.hp.hop_length
        sample_rate = session.config.audio.sample_rate
        t0 = time.perf_counter()
        emitted = 0
        try:
            total = self._totals[i]
            valid0 = min(self._first_cf, total)
            yield np.asarray(first_chunk[: valid0 * hop], dtype=np.float32)
            emitted += valid0
            start = self._first_cf
            k = 1
            while start < total:
                item = self._queues[i].get()
                if isinstance(item, BaseException):
                    raise item
                yield item
                emitted += min(self._chunk_frames, total - start)
                start += self._chunk_frames
                with self._cond:
                    self._consumed[i] = k
                    self._cond.notify_all()
                k += 1
        finally:
            with self._cond:
                self._alive[i] = False
                self._cond.notify_all()
            session.stats.record(
                time.perf_counter() - t0, emitted * hop / sample_rate
            )


@dataclass(frozen=True)
class _Replica:
    """One dp row's params and stage-kernel weights: on its first
    device, and its tp devices' parts of the split leaves."""

    devices: typing.Tuple[torch.device, ...]
    params: typing.Dict[str, typing.Any]
    stage_weights: typing.Dict[int, typing.Any]

    @property
    def device(self) -> torch.device:
        """Where the row's inputs, activations and outputs live."""
        return self.devices[0]


@dataclass
class _ShardCall:
    """One shard's device tensors during a batch call."""

    replica: _Replica
    ids: torch.Tensor
    lengths: torch.Tensor
    sid: typing.Optional[torch.Tensor]
    durations: torch.Tensor


class TorchVitsSession:
    """A voice's synthesis engine on one torch device, or data parallel
    over the dp axis of ``mesh``, each dp row split over its tp devices
    with ``use_tp`` (else held on the row's first device)."""

    _SHARED: typing.Dict[str, "TorchVitsSession"] = {}
    _SHARED_LOCK = threading.Lock()

    def __init__(
        self,
        config: TrainingConfig,
        params: typing.Mapping[str, typing.Any],
        *,
        deterministic: bool = False,
        seed: int = 0,
        device: typing.Union[str, torch.device, None] = None,
        allow_bucket_growth: bool = False,
        mesh: typing.Optional[Mesh] = None,
        use_tp: bool = False,
    ):
        self.config = config
        tp = 1 if mesh is None else mesh.shape["tp"]
        if mesh is not None:
            if device is not None:
                raise ValueError("a mesh names its devices; pass no device")
            # each local dp row's devices: the tp row with use_tp, else
            # its first device alone
            rows = [row.devices if use_tp else row.devices[:1]
                    for row in mesh.local_rows()]
            for row in rows:
                for d in row:
                    resolve_device(d)
        else:
            rows = [(resolve_device(device),)]
        self.device = rows[0][0]
        self.mesh = mesh
        self.deterministic = deterministic
        decoder_dtype = (
            torch.float32
            if deterministic
            else getattr(torch, config.tpu.decoder_dtype)
        )
        stage_max = config.tpu.pallas_stage_max_channels
        if stage_max is None:
            stage_max = (
                STAGE_MAX_CHANNELS.get(decoder_dtype, 32)
                if self.device.type == "cuda"
                else 0
            )
        if tp > 1:
            # the reference's capability gate: the fused stage takes whole
            # weights, so under any tp > 1 mesh it is off, even when the
            # config asks for it (and with use_tp off, as there)
            stage_max = 0
        self.model = VitsModel(
            config.model,
            decoder_dtype=decoder_dtype,
            stage_max_channels=stage_max,
        )
        # one replica per local dp row (one without a mesh): params, and
        # the fused decoder stages' weights laid out for the kernel once
        # per device; rows on one device share them
        if mesh is None:
            replica_params = [to_torch_params(dict(params), self.device)]
        else:
            replica_params = shard_params(
                mesh, to_torch_params(dict(params)), use_tp=use_tp
            )
        packed: typing.Dict[int, _Replica] = {}
        self._replicas: typing.List[_Replica] = []
        for row, p in zip(rows, replica_params):
            if id(p) not in packed:
                packed[id(p)] = _Replica(
                    row, p, self.model.pack_decoder(p["dec"], row[0])
                )
            self._replicas.append(packed[id(p)])
        # replica 0 serves streaming and the continuation driver
        self.params = self._replicas[0].params
        self.stage_weights = self._replicas[0].stage_weights
        self.dp = 1 if mesh is None else mesh.shape["dp"]
        self._multiprocess = mesh is not None and mesh.multiprocess
        self.text_buckets = tuple(config.tpu.text_buckets)
        self.frame_buckets = tuple(config.tpu.frame_buckets)
        # batch buckets round up to multiples of dp: every shard gets the
        # same number of rows
        self.batch_buckets = tuple(sorted({
            -(-b // self.dp) * self.dp for b in config.tpu.batch_buckets
        })) or (self.dp,)
        # False (serving default): inputs past the largest bucket are
        # truncated or split instead of growing a new bucket
        self.allow_bucket_growth = allow_bucket_growth
        self.batcher = None  # optional server-side BatchScheduler
        self.batched_continuations = bool(
            getattr(config.tpu, "batched_continuations", True)
        )
        # speculative decode: running estimate of frames per phoneme at
        # unit length_scale, None until the first observation
        self.speculative_decode = bool(
            getattr(config.tpu, "speculative_decode", True)
        )
        self._ema_frames_per_phoneme: typing.Optional[float] = None
        # decode signatures that have run as a warmup or a mandatory
        # decode; speculation dispatches only these (the reference's
        # compiled-decode set), so it never runs a new shape first
        self._decode_keys_run: typing.Set[str] = set()
        # speculative decodes: dispatched, used, fell back (bucket too
        # small or truncated), skipped (signature never run), and
        # overlapped (the totals reached the host while the speculative
        # decode was still running on the device)
        self.speculation: typing.Dict[str, int] = dict.fromkeys(
            ("dispatched", "used", "fell_back", "skipped", "overlapped"), 0
        )
        self.stats = SessionStats()
        self.seed = seed
        self._call_counter = 0
        self._lock = threading.Lock()
        self._multispeaker = config.model.is_multispeaker
        # signatures (hit keys) dispatched so far, warmup included
        self._run_keys: typing.Set[str] = set()
        # len(_run_keys) when the last warmup finished; None before one
        self._warmup_baseline: typing.Optional[int] = None
        self._hot_path_logged = 0
        # signatures known to have run (warmup, then every dispatch);
        # once set, a request whose natural bucket is not in it rounds up
        # to the nearest warmed bucket (padding only)
        self._warmed_keys: typing.Optional[typing.Set[str]] = None

    @classmethod
    def get_shared(
        cls,
        key: str,
        factory: typing.Callable[[], "TorchVitsSession"],
    ) -> "TorchVitsSession":
        with cls._SHARED_LOCK:
            session = cls._SHARED.get(key)
            if session is None:
                session = factory()
                cls._SHARED[key] = session
            return session

    def _next_seed(self, seed: typing.Optional[int] = None) -> int:
        if seed is not None:
            return int(seed)
        if self.deterministic:
            return self.seed
        with self._lock:
            self._call_counter += 1
            counter = self._call_counter
        return mix_seed(self.seed, counter)

    def _put(
        self, array: np.ndarray, device: typing.Optional[torch.device] = None
    ) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(
            device or self.device
        )

    def _sid(
        self, sid: np.ndarray, device: typing.Optional[torch.device] = None
    ) -> typing.Optional[torch.Tensor]:
        return self._put(sid, device) if self._multispeaker else None

    def _all_rows(self, rows: np.ndarray) -> np.ndarray:
        """This process's shards' rows, or on a mesh over several
        processes every dp row's, in dp order: each row's as its rank at
        tp index 0 computed them, so every rank of a tp row that spans
        processes goes on from the same values (the totals pick the
        frame bucket its collectives run at)."""
        if not self._multiprocess:
            return rows
        ranks = all_gather_rows(torch.from_numpy(rows)).chunk(
            torch.distributed.get_world_size())
        leads = dict.fromkeys(int(r) for r in self.mesh.processes[:, 0])
        return torch.cat([ranks[r] for r in leads]).numpy()

    def _shards(
        self, batch: int
    ) -> typing.List[typing.Tuple[_Replica, slice]]:
        """(replica, rows) of each dp shard this process runs."""
        if self.mesh is None:
            return [(self._replicas[0], slice(0, batch))]
        rows = batch_sharding(self.mesh).slices(batch)
        return [
            (rep, rows[i])
            for rep, (i, _) in zip(self._replicas, self.mesh.local_shards())
        ]

    # -- signatures, warmed set, fallback ------------------------------------------

    def _note_run(self, key: str) -> None:
        """Record one dispatch of signature ``key``: the /api/stats hit
        table, the distinct signatures run, and the warmed set once a
        warmup has made one."""
        self.stats.record_hit(key)
        with self._lock:
            self._run_keys.add(key)
            if self._warmed_keys is not None:
                self._warmed_keys.add(key)

    def jit_executable_count(self) -> int:
        """Distinct signatures (``hit_key`` strings) this session has run,
        warmup included.  PyTorch compiles no executable per shape: the
        name is the reference's, kept because /api/stats reads it, and
        the count is the number of distinct bucket shapes dispatched."""
        with self._lock:
            return len(self._run_keys)

    def hot_path_compiles(self) -> int:
        """Signatures first run AFTER warmup completed (0 before one).

        The reference counts XLA compiles on the serving path; here the
        count means live traffic dispatched a shape outside the warmed
        set (a ``--warmup-profile`` miss).  Logged once per new value.
        """
        with self._lock:
            if self._warmup_baseline is None:
                return 0
            n = max(0, len(self._run_keys) - self._warmup_baseline)
            if n > self._hot_path_logged:
                _LOGGER.warning(
                    "%d signature(s) first run on the serving hot path — "
                    "live traffic left the warmed set; re-capture the "
                    "warmup profile from /api/stats executable_hits",
                    n,
                )
                self._hot_path_logged = n
            return n

    def _round_up_warmed(
        self,
        natural: str,
        candidates: typing.Iterable[typing.Tuple[int, str]],
        current: int,
    ) -> int:
        """First candidate bucket whose signature is warmed, else
        ``current``; a fallback is counted in ``bucket_fallbacks``."""
        with self._lock:
            warmed = self._warmed_keys
            if warmed is None or self.allow_bucket_growth or natural in warmed:
                return current
            warmed = set(warmed)
        for bucket, used in candidates:
            if used in warmed:
                if self.stats.record_bucket_fallback(natural, used) == 1:
                    _LOGGER.warning(
                        "Warmed-bucket fallback: %s never ran, dispatching "
                        "%s (padded) — live traffic escaped the warmup "
                        "profile; re-capture it from /api/stats "
                        "executable_hits",
                        natural, used,
                    )
                return bucket
        return current

    def _fallback_t(
        self,
        kind: str,
        b_bucket: int,
        t_bucket: int,
        f: typing.Optional[int] = None,
    ) -> int:
        """Nearest warmed text bucket >= the natural one for ``kind``
        (``duration`` on the batch path, ``stream_start`` on the streaming
        path).  Engages only after a warmup; padding is masked, so the
        audio stays the same up to the convolution algorithms' rounding."""
        return self._round_up_warmed(
            hit_key(kind, b_bucket, t_bucket, f),
            (
                (t, hit_key(kind, b_bucket, t, f))
                for t in self.text_buckets
                if t > t_bucket
            ),
            t_bucket,
        )

    def _fallback_f(self, b_bucket: int, t_bucket: int, f_bucket: int) -> int:
        """Nearest warmed decode frame bucket >= the natural one (same
        contract as :meth:`_fallback_t`)."""
        return self._round_up_warmed(
            hit_key("decode", b_bucket, t_bucket, f_bucket),
            (
                (f, hit_key("decode", b_bucket, t_bucket, f))
                for f in self.frame_buckets
                if f > f_bucket
            ),
            f_bucket,
        )

    # -- synthesis ---------------------------------------------------------------

    def _split(self, batch: int) -> typing.Optional[typing.List[slice]]:
        """Slices of a batch past the largest batch bucket, else None."""
        max_bb = self.batch_buckets[-1]
        if self.allow_bucket_growth or batch <= max_bb:
            return None
        return [slice(i, i + max_bb) for i in range(0, batch, max_bb)]

    def _truncate(
        self, id_sequences: typing.Sequence[typing.Sequence[int]]
    ) -> typing.Sequence[typing.Sequence[int]]:
        max_text = self.text_buckets[-1]
        n_long = sum(1 for s in id_sequences if len(s) > max_text)
        if self.allow_bucket_growth or not n_long:
            return id_sequences
        _LOGGER.warning(
            "Truncating %d phoneme sequence(s) to the largest text bucket "
            "(%d)",
            n_long, max_text,
        )
        return [list(s)[:max_text] for s in id_sequences]

    def _pad(
        self,
        id_sequences: typing.Sequence[typing.Sequence[int]],
        speaker_ids: typing.Optional[typing.Sequence[typing.Optional[int]]],
        kind: str,
        f: typing.Optional[int] = None,
    ) -> typing.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ids, lengths, sid) padded to the batch and text buckets (the
        text bucket after the warmed-bucket fallback for ``kind``)."""
        batch = len(id_sequences)
        grow = self.allow_bucket_growth
        b_bucket = pick_bucket(batch, self.batch_buckets, grow=grow)
        lengths = np.ones((b_bucket,), np.int64)  # pad rows: 1 phoneme
        lengths[:batch] = [len(s) for s in id_sequences]
        t_bucket = pick_bucket(
            max(1, int(lengths[:batch].max())), self.text_buckets, grow=grow
        )
        t_bucket = self._fallback_t(kind, b_bucket, t_bucket, f)
        ids = np.zeros((b_bucket, t_bucket), np.int64)
        for i, seq in enumerate(id_sequences):
            ids[i, : len(seq)] = np.asarray(seq, np.int64)
        sid = np.zeros((b_bucket,), np.int64)
        if speaker_ids is not None:
            sid[:batch] = [s or 0 for s in speaker_ids]
        return ids, lengths, sid

    def synthesize_ids_batch(
        self,
        id_sequences: typing.Sequence[typing.Sequence[int]],
        *,
        speaker_ids: typing.Optional[typing.Sequence[int]] = None,
        length_scale: float = 1.0,
        noise_scale: float = 0.667,
        noise_w: float = 0.8,
        seed: typing.Optional[int] = None,
        max_frames_cap: int = 32768,
    ) -> typing.List[np.ndarray]:
        """Synthesize a batch of phoneme-id sequences -> float32 waveforms.

        Batches past the largest batch bucket are split, sequences past the
        largest text bucket truncated, and outputs past the largest frame
        bucket cut there (as the reference does when serving).
        """
        start = time.perf_counter()
        parts = self._split(len(id_sequences))
        if parts is not None:
            out: typing.List[np.ndarray] = []
            for part in parts:
                out.extend(
                    self.synthesize_ids_batch(
                        id_sequences[part],
                        speaker_ids=(
                            None if speaker_ids is None else speaker_ids[part]
                        ),
                        length_scale=length_scale,
                        noise_scale=noise_scale,
                        noise_w=noise_w,
                        seed=seed,
                        max_frames_cap=max_frames_cap,
                    )
                )
            return out
        id_sequences = self._truncate(id_sequences)
        batch = len(id_sequences)
        ids, lengths, sid = self._pad(id_sequences, speaker_ids, "duration")
        b_bucket, t_bucket = ids.shape
        call_seed = self._next_seed(seed)
        if not self.allow_bucket_growth:
            max_frames_cap = min(max_frames_cap, self.frame_buckets[-1])

        with device_work(self.deterministic):
            # the duration pass per shard, each on its replica's device
            shards = []
            waits = []
            for rep, rows in self._shards(b_bucket):
                ids_t = self._put(ids[rows], rep.device)
                lengths_t = self._put(lengths[rows], rep.device)
                sid_t = self._sid(sid[rows], rep.device)
                durations, totals = self.model.infer_durations(
                    rep.params, ids_t, lengths_t, call_seed,
                    float(length_scale), float(noise_w), sid=sid_t,
                )
                shards.append(_ShardCall(rep, ids_t, lengths_t, sid_t,
                                         durations))
                waits.append(_start_host_copy(totals))
            self._note_run(hit_key("duration", b_bucket, t_bucket))

            def decode(num_frames: int):
                # every shard at the one frame bucket, on its own device
                return [
                    self.model.decode_frames(
                        sh.replica.params, sh.ids, sh.lengths, sh.durations,
                        num_frames, call_seed, float(noise_scale),
                        sid=sh.sid, stage_weights=sh.replica.stage_weights,
                    )
                    for sh in shards
                ]

            # speculative decode at a predicted bucket, enqueued before
            # the host waits for the totals
            spec_bucket = self._speculative_bucket(
                b_bucket, t_bucket, lengths[:batch], length_scale
            )
            spec_result = None
            spec_done: typing.List[torch.cuda.Event] = []
            if spec_bucket is not None:
                spec_result = decode(spec_bucket)
                for d in {d for sh in shards for d in sh.replica.devices}:
                    if d.type == "cuda":
                        spec_done.append(torch.cuda.Event())
                        spec_done[-1].record(torch.cuda.current_stream(d))

            # the one host sync: every shard's totals
            totals_np = self._all_rows(
                np.concatenate([wait() for wait in waits])
            )
            needed = int(totals_np[:batch].max())
            truncated = needed > max_frames_cap
            if truncated:
                _LOGGER.warning(
                    "Output of %d frames exceeds cap %d; truncating",
                    needed, max_frames_cap,
                )
                needed = max_frames_cap
                # clamp the durations so sample lengths match the audio
                for sh in shards:
                    sh.durations = self._put(
                        _recap(sh.durations.cpu().numpy(), max_frames_cap),
                        sh.replica.device,
                    )
            f_bucket = pick_bucket(
                needed, self.frame_buckets, grow=self.allow_bucket_growth
            )
            self._observe_frames(totals_np[:batch], lengths[:batch],
                                 length_scale)
            used = (
                spec_result is not None
                and spec_bucket >= f_bucket
                and not truncated
            )
            if spec_result is not None:
                with self._lock:
                    self.speculation["used" if used else "fell_back"] += 1
                    if not all(e.query() for e in spec_done):
                        self.speculation["overlapped"] += 1
            if used:
                result = spec_result  # prediction held
                f_bucket = spec_bucket
            else:
                # round up to the nearest warmed decode bucket
                f_bucket = self._fallback_f(b_bucket, t_bucket, f_bucket)
                dec_key = hit_key("decode", b_bucket, t_bucket, f_bucket)
                self._note_run(dec_key)
                result = decode(f_bucket)
                with self._lock:
                    self._decode_keys_run.add(dec_key)
            audio_np = self._all_rows(np.concatenate(
                [audio.float().cpu().numpy() for audio, _ in result]
            ))
            sample_lengths_np = self._all_rows(np.concatenate(
                [lengths_t.cpu().numpy() for _, lengths_t in result]
            ))
        results = [
            audio_np[i, : int(sample_lengths_np[i])] for i in range(batch)
        ]

        elapsed = time.perf_counter() - start
        audio_sec = float(sample_lengths_np[:batch].sum()) / (
            self.config.audio.sample_rate
        )
        self.stats.record(elapsed, audio_sec)
        _LOGGER.debug(
            "RTF: %s (batch=%d, t_bucket=%d, f_bucket=%d)",
            self.stats.last_rtf, batch, t_bucket, f_bucket,
        )
        return results

    def _speculative_bucket(
        self,
        b_bucket: int,
        t_bucket: int,
        lengths: np.ndarray,
        length_scale: float,
    ) -> typing.Optional[int]:
        """The frame bucket to speculate the decode into, or None.

        The estimate is 1.15 x (frames per phoneme) x (longest input) x
        ``length_scale``, picked into a frame bucket; only a decode
        signature that has already run qualifies."""
        with self._lock:
            est_fpp = self._ema_frames_per_phoneme
        if (
            not self.speculative_decode
            or self.allow_bucket_growth
            or est_fpp is None
        ):
            return None
        est = est_fpp * float(lengths.max()) * float(length_scale) * 1.15
        bucket = pick_bucket(
            min(int(est) + 1, self.frame_buckets[-1]), self.frame_buckets
        )
        key = hit_key("decode", b_bucket, t_bucket, bucket)
        with self._lock:
            ran = key in self._decode_keys_run
            self.speculation["dispatched" if ran else "skipped"] += 1
        if not ran:
            return None
        self.stats.record_hit(key)
        return bucket

    def _observe_frames(
        self, totals: np.ndarray, lengths: np.ndarray, length_scale: float
    ) -> None:
        """Update the frames-per-phoneme estimate (normalized to unit
        ``length_scale``) for the next call's speculation."""
        obs = float(totals.sum()) / max(
            1.0, float(lengths.sum()) * float(length_scale)
        )
        obs = min(max(obs, 0.25), 64.0)
        with self._lock:
            prev = self._ema_frames_per_phoneme
            self._ema_frames_per_phoneme = (
                obs if prev is None else 0.9 * prev + 0.1 * obs
            )

    def synthesize_ids(
        self,
        phoneme_ids: typing.Sequence[int],
        *,
        speaker_id: typing.Optional[int] = None,
        length_scale: float = 1.0,
        noise_scale: float = 0.667,
        noise_w: float = 0.8,
        seed: typing.Optional[int] = None,
    ) -> np.ndarray:
        """Single utterance -> float32 waveform; routed through the
        batching scheduler when one is attached (server mode), so
        concurrent callers share device batches."""
        batcher = self.batcher
        if batcher is not None and not batcher.is_scheduler_thread:
            return batcher.submit(
                self,
                phoneme_ids,
                speaker_id=speaker_id or 0,
                length_scale=length_scale,
                noise_scale=noise_scale,
                noise_w=noise_w,
                seed=seed,
            ).result()
        return self.synthesize_ids_batch(
            [phoneme_ids],
            speaker_ids=None if speaker_id is None else [speaker_id],
            length_scale=length_scale,
            noise_scale=noise_scale,
            noise_w=noise_w,
            seed=seed,
        )[0]

    # -- streaming -----------------------------------------------------------------

    def synthesize_ids_chunked(
        self,
        phoneme_ids: typing.Sequence[int],
        *,
        speaker_id: typing.Optional[int] = None,
        length_scale: float = 1.0,
        noise_scale: float = 0.667,
        noise_w: float = 0.8,
        seed: typing.Optional[int] = None,
        chunk_frames: int = 128,
        overlap: int = 64,
        max_frames_cap: int = 32768,
        first_chunk_frames: typing.Optional[int] = None,
    ) -> typing.Iterator[np.ndarray]:
        """Streaming decode: yield float32 audio in ~chunk_frames pieces.

        Windows are decoded with ``overlap`` frames of context on each side
        and the seams trimmed; with overlap >= the decoder's and flow's
        receptive field the chunks match the unchunked output to float
        tolerance.  ``first_chunk_frames`` (< chunk_frames) shrinks only
        the first window.  The audio is not peak-normalized (a stream
        cannot know the final peak).

        With a batching scheduler attached (server mode) the first window
        is computed in one fused call shared with the other streams that
        start at the same time (:meth:`stream_start_batch`); the output
        is the same either way (sampling is batch-invariant).
        """
        batcher = self.batcher
        if batcher is not None and not batcher.is_scheduler_thread:
            gen = batcher.submit_stream(
                self,
                phoneme_ids,
                speaker_id=speaker_id or 0,
                length_scale=length_scale,
                noise_scale=noise_scale,
                noise_w=noise_w,
                seed=seed,
                chunk_frames=chunk_frames,
                overlap=overlap,
                max_frames_cap=max_frames_cap,
                first_chunk_frames=first_chunk_frames,
            ).result()
            yield from gen
            return
        yield from self.stream_start_batch(
            [phoneme_ids],
            speaker_ids=None if speaker_id is None else [speaker_id],
            length_scale=length_scale,
            noise_scale=noise_scale,
            noise_w=noise_w,
            seed=seed,
            chunk_frames=chunk_frames,
            overlap=overlap,
            max_frames_cap=max_frames_cap,
            first_chunk_frames=first_chunk_frames,
        )[0]

    def stream_start_batch(
        self,
        id_sequences: typing.Sequence[typing.Sequence[int]],
        *,
        speaker_ids: typing.Optional[typing.Sequence[int]] = None,
        length_scale: float = 1.0,
        noise_scale: float = 0.667,
        noise_w: float = 0.8,
        seed: typing.Optional[int] = None,
        chunk_frames: int = 128,
        overlap: int = 64,
        max_frames_cap: int = 32768,
        first_chunk_frames: typing.Optional[int] = None,
    ) -> typing.List[typing.Iterator[np.ndarray]]:
        """Batched streaming: one fused call starts every stream.

        :meth:`VitsModel.stream_start` runs the encoder once, the
        durations, and the first window for the whole batch.  Returns one
        generator per sequence, yielding what :meth:`synthesize_ids_chunked`
        yields for it alone.  Continuation windows run as one batched
        decode per window (:class:`_ContinuationDriver`) for groups of two
        or more, else per row.
        """
        parts = self._split(len(id_sequences))
        if parts is not None:
            out: typing.List[typing.Iterator[np.ndarray]] = []
            for part in parts:
                out.extend(
                    self.stream_start_batch(
                        id_sequences[part],
                        speaker_ids=(
                            None if speaker_ids is None else speaker_ids[part]
                        ),
                        length_scale=length_scale,
                        noise_scale=noise_scale,
                        noise_w=noise_w,
                        seed=seed,
                        chunk_frames=chunk_frames,
                        overlap=overlap,
                        max_frames_cap=max_frames_cap,
                        first_chunk_frames=first_chunk_frames,
                    )
                )
            return out
        id_sequences = self._truncate(id_sequences)
        batch = len(id_sequences)
        first_cf = min(first_chunk_frames or chunk_frames, chunk_frames)
        window0 = first_cf + 2 * overlap
        # the text bucket rounds up to a warmed stream start; continuation
        # windows inherit it, so their signatures stay warmed too
        ids, lengths, sid = self._pad(
            id_sequences, speaker_ids, "stream_start", window0
        )
        b_bucket, t_bucket = ids.shape
        call_seed = self._next_seed(seed)
        with device_work(self.deterministic):
            ids_t, lengths_t, sid_t = (
                self._put(ids), self._put(lengths), self._sid(sid)
            )
            self._note_run(
                hit_key("stream_start", b_bucket, t_bucket, window0)
            )
            durations, totals, m_p, logs_p, audio0 = self.model.stream_start(
                self.params, ids_t, lengths_t, call_seed,
                float(length_scale), float(noise_w), float(noise_scale),
                window0, sid=sid_t, stage_weights=self.stage_weights,
            )
            totals_np = totals.cpu().numpy()  # one host sync for the batch
            audio0_np = audio0.float().cpu().numpy()

        if not self.allow_bucket_growth:
            max_frames_cap = min(max_frames_cap, self.frame_buckets[-1])
        totals_list = [int(t) for t in totals_np[:batch]]
        if (
            self.batched_continuations
            and batch >= 2
            and max(totals_list) <= max_frames_cap
            and max(totals_list) > first_cf
        ):
            # truncated rows (total > cap) keep the per-row path: their
            # durations are re-capped per row
            driver = _ContinuationDriver(
                self,
                (ids_t, lengths_t, sid_t, durations, m_p, logs_p),
                call_seed, noise_scale, totals_list, first_cf,
                chunk_frames, overlap,
            )
            return [driver.row(i, audio0_np[i]) for i in range(batch)]

        shared = _LazyHostRows(durations, m_p, logs_p)
        return [
            self._stream_row(
                ids[i : i + 1], int(lengths[i]), int(sid[i]), call_seed,
                totals_list[i], audio0_np[i], shared, i,
                noise_scale=noise_scale,
                chunk_frames=chunk_frames,
                overlap=overlap,
                first_cf=first_cf,
                max_frames_cap=max_frames_cap,
            )
            for i in range(batch)
        ]

    def _stream_row(
        self,
        ids_row: np.ndarray,
        length_row: int,
        sid_row: int,
        seed: int,
        total: int,
        audio0_row: np.ndarray,
        shared: _LazyHostRows,
        row: int,
        *,
        noise_scale: float,
        chunk_frames: int,
        overlap: int,
        first_cf: int,
        max_frames_cap: int,
    ) -> typing.Iterator[np.ndarray]:
        """Yield one stream's chunks from a batched stream start."""
        start_time = time.perf_counter()
        hop = self.model.hp.hop_length
        truncated = total > max_frames_cap
        if truncated:
            _LOGGER.warning(
                "Chunked output of %d frames exceeds cap %d; truncating",
                total, max_frames_cap,
            )
            total = max_frames_cap

        # chunk grid: optional smaller first chunk, then uniform
        sizes = [first_cf]
        grid_end = first_cf
        while grid_end < total:
            sizes.append(chunk_frames)
            grid_end += chunk_frames

        dev: typing.Optional[typing.Tuple] = None

        def row_tensors() -> typing.Tuple:
            # lazy: the host copy and this row's upload happen after the
            # first chunk is out, once per stream
            nonlocal dev
            if dev is None:
                dur_np, m_p_np, logs_p_np = shared.host()
                dur_row = dur_np[row : row + 1]
                if truncated:
                    dur_row = _recap(dur_row, max_frames_cap)
                dev = (
                    self._put(ids_row),
                    self._put(np.array([length_row], np.int64)),
                    self._sid(np.array([sid_row], np.int64)),
                    self._put(dur_row),
                    self._put(m_p_np[row : row + 1]),
                    self._put(logs_p_np[row : row + 1]),
                )
            return dev

        emitted = 0
        start = 0
        for n_chunk, cf in enumerate(sizes):
            valid = min(cf, total - start)
            if valid <= 0:
                break
            window = cf + 2 * overlap
            # never fabricate left context before frame 0
            left = min(overlap, start)
            if n_chunk == 0 and not truncated:
                # decoded in the batched fused pass
                chunk = np.asarray(audio0_row[: valid * hop], np.float32)
            else:
                # (truncation invalidates the batched first window: its
                # durations predate the cap)
                self._note_run(hit_key("chunk", 1, ids_row.shape[1], window))
                with device_work(self.deterministic):
                    i_t, l_t, s_t, d_t, m_t, lg_t = row_tensors()
                    audio, _ = self.model.decode_frames(
                        self.params, i_t, l_t, d_t, window, seed,
                        float(noise_scale), sid=s_t,
                        frame_offset=start - left, enc_stats=(m_t, lg_t),
                        stage_weights=self.stage_weights,
                    )
                    chunk = (
                        audio[0, left * hop : (left + valid) * hop]
                        .float().cpu().numpy()
                    )
            emitted += valid
            start += cf
            yield chunk

        self.stats.record(
            time.perf_counter() - start_time,
            emitted * hop / self.config.audio.sample_rate,
        )

    # -- warmup ----------------------------------------------------------------

    def warmup(
        self,
        text_buckets: typing.Optional[typing.Sequence[int]] = None,
        frame_buckets: typing.Optional[typing.Sequence[int]] = None,
        batch_sizes: typing.Optional[typing.Sequence[int]] = None,
        chunk_windows: typing.Sequence[int] = (),
        parallel: int = 4,
        profile: typing.Optional[typing.Collection[str]] = None,
    ) -> float:
        """Run every wanted signature once; returns the wall seconds.

        The grid and the profile pruning are the reference's: a duration
        pass per (batch, text) bucket and a decode per frame bucket; with
        ``chunk_windows``, the fused stream start per (batch, text)
        bucket, the batch-1 chunk windows and the batched continuation
        window.  PyTorch compiles nothing per shape, so what warmup buys
        here is the warmed set the bucket fallback rounds up to, the
        baseline of :meth:`hot_path_compiles`, and cuDNN's and the
        allocator's first-call work off the request path.  The calls run
        one after another on the one device; ``parallel`` is accepted for
        the reference's signature and not used.
        """
        del parallel
        start = time.perf_counter()
        tb = tuple(text_buckets or self.text_buckets)
        fb = tuple(frame_buckets or self.frame_buckets)
        profile_set = (
            None
            if profile is None
            else expand_profile_batches(
                profile, self.batch_buckets, frame_buckets=fb
            )
        )

        def want(key: str) -> bool:
            return profile_set is None or key in profile_set

        if batch_sizes is None:
            batch_sizes = (self.batch_buckets[0],)
        else:
            batch_sizes = sorted(
                {pick_bucket(b, self.batch_buckets) for b in batch_sizes}
            )
        warmed: typing.Set[str] = set()

        def inputs(
            b: int, t: int, device: typing.Optional[torch.device] = None
        ):
            return (
                self._put(np.zeros((b, t), np.int64), device),
                self._put(np.full((b,), t, np.int64), device),
                self._sid(np.zeros((b,), np.int64), device),
            )

        # the batch path's signatures on every replica (one per device),
        # each at a shard's rows
        replicas = list({id(r): r for r in self._replicas}.values())
        for b in batch_sizes:
            for t in tb:
                fbs = [f for f in fb if want(hit_key("decode", b, t, f))]
                if not (want(hit_key("duration", b, t)) or fbs):
                    continue
                if graceful_shutdown_requested():
                    break
                with device_work(self.deterministic):
                    for rep in replicas:
                        ids, lengths, sid = inputs(b // self.dp, t, rep.device)
                        durations, _ = self.model.infer_durations(
                            rep.params, ids, lengths, 0, 1.0, 0.8, sid=sid
                        )
                        for f in fbs:
                            self.model.decode_frames(
                                rep.params, ids, lengths, durations, f, 0,
                                0.667, sid=sid,
                                stage_weights=rep.stage_weights,
                            )
                    warmed.add(hit_key("duration", b, t))
                    for f in fbs:
                        key = hit_key("decode", b, t, f)
                        warmed.add(key)
                        with self._lock:
                            self._decode_keys_run.add(key)
        if chunk_windows:
            w0, w_cont = min(chunk_windows), max(chunk_windows)
            for b in batch_sizes:
                for t in tb:
                    if b == 1:
                        windows = [
                            w for w in chunk_windows
                            if want(hit_key("chunk", 1, t, w))
                        ]
                    elif self.batched_continuations and w_cont != w0 and want(
                        hit_key("chunk", b, t, w_cont)
                    ):
                        windows = [w_cont]
                    else:
                        windows = []
                    if not (windows or want(hit_key("stream_start", b, t, w0))):
                        continue
                    if graceful_shutdown_requested():
                        break
                    with device_work(self.deterministic):
                        ids, lengths, sid = inputs(b, t)
                        durations, _, m_p, logs_p, _ = self.model.stream_start(
                            self.params, ids, lengths, 0, 1.0, 0.8, 0.667,
                            w0, sid=sid, stage_weights=self.stage_weights,
                        )
                        warmed.add(hit_key("stream_start", b, t, w0))
                        for w in windows:
                            self.model.decode_frames(
                                self.params, ids, lengths, durations, w, 0,
                                0.667, sid=sid, enc_stats=(m_p, logs_p),
                                stage_weights=self.stage_weights,
                            )
                            warmed.add(hit_key("chunk", b, t, w))
        for d in {d for rep in self._replicas for d in rep.devices}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)  # the work is done, not queued
        elapsed = time.perf_counter() - start
        self.stats.compile_count += len(warmed)
        with self._lock:
            self._run_keys |= warmed
            self._warmup_baseline = len(self._run_keys)
            if self._warmed_keys is None:
                self._warmed_keys = set(self._run_keys)
            else:  # repeated warmups extend the known set
                self._warmed_keys |= self._run_keys
        _LOGGER.info(
            "Warmup ran %d signatures in %.1fs", len(warmed), elapsed
        )
        return elapsed
