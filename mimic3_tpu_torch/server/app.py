"""HTTP route handlers (endpoint-compatible with the reference server).

Endpoints (reference: mimic3_http/app.py:157-332):
- ``GET/POST /api/tts``   text/SSML -> WAV (voice, noiseScale, noiseW,
  lengthScale, ssml, textLanguage, cacheId, noCache, audioTarget)
- ``GET /api/voices``     voice catalog with language names + sample text
- ``GET /api/healthcheck``
- ``GET|POST /process``   MaryTTS-compatible synthesis
- ``GET /voices``         MaryTTS-compatible voice list
- ``GET /``               web UI;  ``GET /openapi`` + ``/openapi.json``

Synthesis runs in a thread pool of engines (phonemization is host CPU);
the device is fed by the BatchScheduler attached to every session, so
concurrent requests share device batches.  Each app holds one torch
device for all its engines; ``POST /api/profile`` captures a
``torch.profiler`` trace.

Port copy of ``mimic3_tpu/server/app.py``.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import dataclasses
import functools
import hashlib
import json
import logging
import re
import shlex
import subprocess
import time
import typing
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

from .. import tracing
from ..engine import Mimic3Settings, Mimic3TextToSpeechSystem
from ..voices_registry import DEFAULT_VOICE
from .httpd import HttpResponse, HttpServer, Request
from .lang import language_names, sample_sentence
from .scheduler import BatchScheduler, RequestStats

if typing.TYPE_CHECKING:
    import torch

_LOGGER = logging.getLogger(__name__)

# low-latency streaming decode grid (frames); warmup runs the matching
# windows so the first streaming request runs no signature first
_STREAM_CHUNK_FRAMES = 128
_STREAM_OVERLAP = 64
_STREAM_FIRST_CHUNK_FRAMES = 32
_STREAM_WINDOWS = (
    _STREAM_FIRST_CHUNK_FRAMES + 2 * _STREAM_OVERLAP,
    _STREAM_CHUNK_FRAMES + 2 * _STREAM_OVERLAP,
)

_TEMPLATE_DIR = Path(__file__).parent / "templates"


@dataclasses.dataclass
class TtsParams:
    """Synthesis request parameters; the cache key is their md5
    (reference: mimic3_http/const.py:35-40)."""

    text: str
    voice: str
    noise_scale: typing.Optional[float] = None
    noise_w: typing.Optional[float] = None
    length_scale: typing.Optional[float] = None
    ssml: bool = False
    text_language: typing.Optional[str] = None
    cache_id: typing.Optional[str] = None

    @property
    def cache_key(self) -> str:
        if self.cache_id:
            # client-supplied id: restrict to a safe charset so it can
            # never traverse out of the cache directory (the reference
            # uses it verbatim — mimic3_http/const.py:35-40 — which is a
            # path traversal), plus a hash of the raw id so two distinct
            # ids that sanitize identically never share a cache file
            safe = re.sub(r"[^A-Za-z0-9._-]", "_", self.cache_id)[:96]
            digest = hashlib.sha256(
                self.cache_id.encode("utf-8")
            ).hexdigest()[:16]
            safe = safe.strip("._")
            return f"{safe}_{digest}" if safe else digest
        blob = repr(dataclasses.astuple(self)).encode("utf-8")
        return hashlib.md5(blob).hexdigest()


def _to_bool(s: str) -> bool:
    return (s or "").strip().lower() in {"true", "1", "yes", "on"}


@contextlib.contextmanager
def _timed(name: str, seconds: str) -> typing.Iterator[None]:
    """The span ``name``, and its seconds added to the request's field
    ``seconds`` (when a request is being served)."""
    req = tracing.request()
    start = time.perf_counter()
    with tracing.span(name):
        yield
    if req is not None:
        setattr(req, seconds,
                getattr(req, seconds) + time.perf_counter() - start)


def _streaming_wav_header_bytes(
    rate: int, channels: int, width: int
) -> bytes:
    """Unknown-length WAV header (RIFF/data sizes maxed — the streaming
    convention players accept)."""
    import struct

    byte_rate = rate * channels * width
    return b"".join(
        [
            b"RIFF",
            struct.pack("<I", 0xFFFFFFFF),
            b"WAVEfmt ",
            struct.pack(
                "<IHHIIHH",
                16,
                1,
                channels,
                rate,
                byte_rate,
                channels * width,
                width * 8,
            ),
            b"data",
            struct.pack("<I", 0xFFFFFFFF - 44),
        ]
    )


class TtsApp:
    """Server state: engine pool, scheduler, WAV cache."""

    def __init__(
        self,
        config,
        device: typing.Union[str, "torch.device", None] = None,
    ) -> None:
        from ..runtime.session import resolve_device

        self.config = config
        # resolved before any request: with no card visible a CUDA device
        # fails at startup, not at the first request (read by _new_engine)
        self.device = resolve_device(device)
        self.scheduler = BatchScheduler(
            max_batch=config.max_batch,
            max_delay_ms=config.batch_delay_ms,
            adaptive_delay_ms=getattr(
                config, "batch_delay_max_ms", 25.0
            ),
        )
        self._executor = ThreadPoolExecutor(
            max_workers=config.num_workers,
            thread_name_prefix="tts-worker",
        )
        self.requests = RequestStats()
        import threading

        self._engines: typing.List[Mimic3TextToSpeechSystem] = []
        self._engine_local = threading.local()
        # voice sessions wired to the scheduler, keyed by voice key;
        # guarded by a lock so /api/stats reads a consistent snapshot
        # while worker threads load voices
        self._voices_lock = threading.Lock()
        self._profile_lock = threading.Lock()
        self._voice_sessions: typing.Dict[str, typing.Any] = {}
        self.cache_dir: typing.Optional[Path] = (
            Path(config.cache_dir) if config.cache_dir else None
        )
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

        # catalog engine (get_voices only; no device usage)
        self._catalog = self._new_engine()

    def _new_engine(self) -> Mimic3TextToSpeechSystem:
        engine = Mimic3TextToSpeechSystem(
            Mimic3Settings(
                voices_directories=self.config.voices_dir,
                no_download=self.config.no_download,
                use_deterministic_compute=self.config.deterministic,
            ),
            device=self.device,
        )
        self._engines.append(engine)
        return engine

    def _on_worker(self, fn: typing.Callable, *args) -> Future:
        """``fn(*args)`` on a worker thread, in the caller's context (the
        request it serves and its span); the wait for a free worker is
        the ``server.worker_wait`` span and the request's
        ``worker_wait_s``."""
        req = tracing.request()
        waiting = tracing.span("server.worker_wait")
        submitted = time.perf_counter()

        def work():
            waiting.end()
            if req is not None:
                req.worker_wait_s += time.perf_counter() - submitted
            return fn(*args)

        return self._executor.submit(contextvars.copy_context().run, work)

    def _thread_engine(self) -> Mimic3TextToSpeechSystem:
        engine = getattr(self._engine_local, "engine", None)
        if engine is None:
            engine = self._new_engine()
            self._engine_local.engine = engine
        return engine

    def _wire_session(self, key: str, voice) -> None:
        """Attach the voice's session to the scheduler and register it
        for /api/stats (idempotent, thread-safe)."""
        if voice.session.batcher is None:
            voice.session.batcher = self.scheduler
        base_key = key.split("#", 1)[0]
        with self._voices_lock:
            self._voice_sessions.setdefault(base_key, voice.session)

    def voice_stats_snapshot(self) -> typing.Dict[str, typing.Any]:
        with self._voices_lock:
            return dict(self._voice_sessions)

    def _load_warmup_profile(
        self,
    ) -> typing.Optional[typing.FrozenSet[str]]:
        """Parse --warmup-profile into a set of hit_key strings.

        Accepts a full /api/stats payload (keys unioned across its
        voices' ``executable_hits`` tables), a single voice's stats
        object (``{"executable_hits": {...}, ...}``), or a bare
        ``{hit_key: count}`` mapping — so the capture workflow is just
        ``curl /api/stats > profile.json`` on a representative run.
        Malformed signatures fail loudly at startup (ValueError naming
        the key) rather than crashing mid-warmup.
        """
        path = self.config.warmup_profile
        if not path:
            return None
        import json as _json

        data = _json.loads(Path(path).read_text())
        keys: typing.Set[str] = set()
        if "voices" in data and isinstance(data["voices"], dict):
            for voice in data["voices"].values():
                keys.update(voice.get("executable_hits", {}))
        elif isinstance(data.get("executable_hits"), dict):
            keys.update(data["executable_hits"])
        else:
            keys.update(data)
        for key in keys:
            if not isinstance(key, str) or ":b" not in key:
                raise ValueError(
                    f"--warmup-profile {path}: {key!r} is not an "
                    "executable signature; pass an /api/stats capture "
                    "or a {hit_key: count} mapping"
                )
        _LOGGER.info(
            "Warmup profile: %d executable signatures from %s",
            len(keys), path,
        )
        return frozenset(keys)

    def preload(self) -> None:
        warmup_profile = self._load_warmup_profile()
        for key in self.config.preload_voice or []:
            _LOGGER.info("Preloading voice %s", key)
            voice = self._catalog._get_or_load_voice(key)
            self._wire_session(key, voice)
            if self.config.warmup:
                # warm every batch bucket the scheduler can PRODUCE:
                # a packed batch of up to max_batch (dp-rounded) pads
                # UP to the covering bucket, so that bucket must be
                # warmed too or it compiles on the request path
                from ..runtime.session import pick_bucket

                session = voice.session
                dp = session.dp
                limit = max(dp, (self.config.max_batch // dp) * dp)
                top = pick_bucket(limit, session.batch_buckets)
                bb = [b for b in session.batch_buckets if b <= top]
                voice.session.warmup(
                    batch_sizes=bb,
                    chunk_windows=_STREAM_WINDOWS,
                    profile=warmup_profile,
                    parallel=getattr(
                        self.config, "warmup_parallel", 4
                    ),
                )

    # -- synthesis ----------------------------------------------------------------

    def _set_request_voice(self, engine, requested: str) -> None:
        """Point a (reused) thread engine at this request's voice.

        Engines persist per worker thread, and the engine.voice setter
        keeps the previous speaker when the voice key is unchanged — so
        a request WITHOUT a '#speaker' suffix must reset the speaker
        explicitly, or it inherits the previous request's."""
        engine.voice = requested
        if "#" not in requested:
            engine.speaker = None

    def _results_blocking(self, params: TtsParams):
        """Configure a thread engine and yield BaseResults for params."""
        engine = self._thread_engine()
        self._set_request_voice(
            engine, params.voice or self.config.voice or DEFAULT_VOICE
        )
        if params.length_scale is not None:
            engine.settings.length_scale = params.length_scale
        else:
            engine.settings.length_scale = self.config.length_scale
        if params.noise_scale is not None:
            engine.settings.noise_scale = params.noise_scale
        else:
            engine.settings.noise_scale = self.config.noise_scale
        if params.noise_w is not None:
            engine.settings.noise_w = params.noise_w
        else:
            engine.settings.noise_w = self.config.noise_w
        if self.config.deterministic:
            engine.settings.noise_scale = 0.0
            engine.settings.noise_w = 0.0

        # make sure this voice's session is wired to the scheduler
        voice = engine._get_or_load_voice(engine.voice)
        self._wire_session(engine.voice, voice)

        if params.ssml:
            from ..ssml import SSMLSpeaker

            # parsing and phonemes interleave with synthesis: no
            # server.frontend span
            return SSMLSpeaker(engine).speak(params.text)
        # every sentence's phonemes, queued before any is synthesized;
        # the engine maps each to ids as it synthesizes it
        with _timed("server.frontend", "frontend_s"):
            engine.begin_utterance()
            engine.speak_text(
                params.text, text_language=params.text_language
            )
        return engine.end_utterance()

    def _synthesize_blocking(self, params: TtsParams) -> bytes:
        import io
        import wave

        from ..api import AudioResult

        results = list(self._results_blocking(params))
        with _timed("server.wav_encode", "encode_s"), \
                io.BytesIO() as wav_io:
            wav_file = wave.open(wav_io, "wb")
            params_set = False
            with wav_file:
                for result in results:
                    if isinstance(result, AudioResult):
                        if not params_set:
                            wav_file.setframerate(result.sample_rate_hz)
                            wav_file.setsampwidth(
                                result.sample_width_bytes
                            )
                            wav_file.setnchannels(result.num_channels)
                            params_set = True
                        wav_file.writeframes(result.audio_bytes)
                if not params_set:
                    from ..api import set_default_wav_params

                    set_default_wav_params(wav_file)
            return wav_io.getvalue()

    async def text_to_wav(
        self, params: TtsParams, no_cache: bool = False
    ) -> bytes:
        if self.cache_dir and not no_cache:
            cached = self.cache_dir / f"{params.cache_key}.wav"
            if cached.is_file():
                _LOGGER.debug("Cache hit: %s", cached)
                return cached.read_bytes()

        wav_bytes = await asyncio.wrap_future(
            self._on_worker(self._synthesize_blocking, params)
        )

        if self.cache_dir and not no_cache:
            cached = self.cache_dir / f"{params.cache_key}.wav"
            cached.write_bytes(wav_bytes)
        return wav_bytes

    def _stream_low_latency_blocking(self, params: TtsParams, put):
        """Sub-sentence streaming: windowed chunked decode per sentence.

        Uses a fixed gain instead of per-sentence peak normalization (a
        stream can't know the final peak), so byte output differs from
        the buffered path — that's the documented trade of
        streamingMode=low-latency."""
        import numpy as np

        engine = self._thread_engine()
        self._set_request_voice(
            engine, params.voice or self.config.voice or DEFAULT_VOICE
        )
        voice = engine._get_or_load_voice(engine.voice)
        self._wire_session(engine.voice, voice)
        # the voice setter split any '#speaker' suffix into
        # engine.speaker; resolve it like the buffered path does
        speaker_id = voice.resolve_speaker_id(engine.speaker)
        inference = voice.config.inference

        # same precedence as the buffered path (_results_blocking):
        # request arg > server --noise-scale/--length-scale > voice config
        def _scale(request_value, server_value, voice_value):
            if request_value is not None:
                return request_value
            if server_value is not None:
                return server_value
            return voice_value

        noise_scale = _scale(
            params.noise_scale,
            self.config.noise_scale,
            inference.noise_scale,
        )
        noise_w = _scale(
            params.noise_w, self.config.noise_w, inference.noise_w
        )
        length_scale = _scale(
            params.length_scale,
            self.config.length_scale,
            inference.length_scale,
        )
        if self.config.deterministic:
            noise_scale, noise_w = 0.0, 0.0

        fixed_gain = 32767.0 * 0.7  # headroom in place of peak norm

        first = True
        sentences = voice.text_to_phonemes(
            params.text, text_language=params.text_language
        )
        while True:
            with _timed("server.frontend", "frontend_s"):
                sentence = next(sentences, None)
                ids = (
                    voice.phonemes_to_ids(sentence[0]) if sentence else None
                )
            if sentence is None:
                break
            if not ids:
                continue
            for chunk in voice.session.synthesize_ids_chunked(
                ids,
                speaker_id=speaker_id,
                length_scale=float(length_scale),
                noise_scale=float(noise_scale),
                noise_w=float(noise_w),
                chunk_frames=_STREAM_CHUNK_FRAMES,
                overlap=_STREAM_OVERLAP,
                # small first window: first audio needs a ~32-frame
                # decode (~0.4 s audio) instead of a 128-frame one
                first_chunk_frames=_STREAM_FIRST_CHUNK_FRAMES,
            ):
                if first:
                    rate = voice.config.audio.sample_rate
                    if not put(_streaming_wav_header_bytes(rate, 1, 2)):
                        return
                    first = False
                pcm = np.clip(
                    chunk * fixed_gain, -32767, 32767
                ).astype(np.int16)
                if not put(pcm.tobytes()):
                    return
        if first:
            put(_streaming_wav_header_bytes(22050, 1, 2))

    async def stream_wav(
        self,
        params: TtsParams,
        low_latency: bool = False,
        request: typing.Any = None,
    ) -> typing.AsyncIterator[bytes]:
        """Chunked WAV: the header goes out with the FIRST synthesized
        sentence; later sentences stream as raw PCM.  First-chunk latency
        is one sentence's synthesis, not the whole document's.
        ``low_latency`` streams windowed decode chunks WITHIN sentences
        (fixed gain instead of per-sentence peak normalization).
        ``request`` (its ``RequestTimes``) gets the first chunk's time
        and names the request to the producer's spans."""
        import threading

        from ..api import AudioResult

        loop = asyncio.get_running_loop()
        # bounded: the producer blocks when the client reads slowly
        # instead of buffering a whole document's PCM in memory
        queue: "asyncio.Queue[typing.Optional[bytes]]" = asyncio.Queue(
            maxsize=16
        )
        cancelled = threading.Event()

        def put(chunk: typing.Optional[bytes]) -> bool:
            if cancelled.is_set():
                # consumer already gone: stop the producer immediately
                # instead of filling the queue and blocking on .result
                return False
            if request is not None and request.first_chunk_s is None:
                # the header goes out with the first audio
                request.first_chunk_s = (
                    time.perf_counter() - request.received
                )
            try:
                asyncio.run_coroutine_threadsafe(
                    queue.put(chunk), loop
                ).result(timeout=120)
                return not cancelled.is_set()
            except Exception:
                cancelled.set()
                return False

        def produce() -> None:
            first = True
            try:
                if low_latency:
                    self._stream_low_latency_blocking(params, put)
                    return
                for result in self._results_blocking(params):
                    if cancelled.is_set():
                        return  # client went away: stop synthesizing
                    if not isinstance(result, AudioResult):
                        continue
                    if first:
                        if not put(
                            _streaming_wav_header_bytes(
                                result.sample_rate_hz,
                                result.num_channels,
                                result.sample_width_bytes,
                            )
                        ):
                            return
                        first = False
                    if not put(result.audio_bytes):
                        return
                if first:  # no audio at all: still emit a valid header
                    put(_streaming_wav_header_bytes(22050, 1, 2))
            except Exception:
                _LOGGER.exception("Streaming synthesis failed")
            finally:
                # ALWAYS try to terminate the consumer — even after a
                # put() timeout/cancel, a blocked consumer must see the
                # sentinel or the HTTP response hangs forever
                try:
                    loop.call_soon_threadsafe(_force_sentinel)
                except RuntimeError:
                    pass  # loop already closed

        def _force_sentinel() -> None:
            try:
                queue.put_nowait(None)
            except asyncio.QueueFull:
                # drop one buffered chunk to make room for the sentinel
                try:
                    queue.get_nowait()
                except asyncio.QueueEmpty:
                    pass
                try:
                    queue.put_nowait(None)
                except asyncio.QueueFull:
                    pass

        with tracing.serving(request, getattr(request, "span", None)):
            self._on_worker(produce)
        try:
            while True:
                chunk = await queue.get()
                if chunk is None:
                    return
                yield chunk
        finally:
            # consumer closed (client disconnect): signal the producer
            cancelled.set()
            while not queue.empty():
                queue.get_nowait()

    def shutdown(self) -> None:
        self._executor.shutdown(wait=False)
        self.scheduler.shutdown()
        if (
            getattr(self.config, "cache_dir_is_temp", False)
            and self.cache_dir is not None
        ):
            import shutil

            shutil.rmtree(self.cache_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


def build_server(app: TtsApp) -> HttpServer:
    server = HttpServer()
    config = app.config

    async def served(mode: str, text: str, respond) -> HttpResponse:
        """``await respond(req)`` as one counted request of ``mode``: its
        ``server.request`` span and seconds run from here to its last
        byte handed to the socket."""
        req = app.requests.start(mode, len(text))
        try:
            with tracing.serving(req, req.span):
                response = await respond(req)
        except BaseException:
            app.requests.finish(req, False)
            raise
        response.done = functools.partial(app.requests.finish, req)
        return response

    @server.route("/api/tts", methods=("GET", "POST"))
    async def api_tts(request: Request):
        if request.method == "POST":
            text = request.body.decode("utf-8")
        else:
            text = request.arg("text", "")
        if not text:
            return HttpResponse(body=b"No text provided", status=400)
        if config.max_text_length:
            text = text[: config.max_text_length]
        streaming = _to_bool(request.arg("streaming", ""))
        return await served(
            "stream" if streaming else "wav", text,
            lambda req: tts(request, text, streaming, req),
        )

    async def tts(request: Request, text: str, streaming: bool,
                  req) -> HttpResponse:
        """The ``/api/tts`` response, in the scope of ``req``."""
        ssml = _to_bool(request.arg("ssml", ""))
        if not ssml and request.content_type.startswith(
            "application/ssml+xml"
        ):
            ssml = True

        def float_arg(name):
            value = request.arg(name)
            return float(value) if value else None

        params = TtsParams(
            text=text,
            voice=request.arg("voice")
            or config.voice
            or DEFAULT_VOICE,
            noise_scale=float_arg("noiseScale"),
            noise_w=float_arg("noiseW"),
            length_scale=float_arg("lengthScale"),
            ssml=ssml,
            text_language=request.arg("textLanguage"),
            cache_id=request.arg("cacheId"),
        )

        if streaming:
            # chunked WAV, first sentence out as soon as it's ready;
            # streamingMode=low-latency streams WITHIN sentences too
            low_latency = (
                (request.arg("streamingMode", "") or "").lower()
                == "low-latency"
                and not params.ssml  # SSML needs the full engine path
            )
            return HttpResponse(
                stream=app.stream_wav(params, low_latency=low_latency,
                                      request=req),
                content_type="audio/wav",
            )

        wav_bytes = await app.text_to_wav(
            params, no_cache=_to_bool(request.arg("noCache", ""))
        )

        target = (request.arg("audioTarget", "client") or "").lower()
        if target == "server":
            play_cmd = shlex.split(config.play_program)
            # playback can take the length of the audio: run it off the
            # event loop so other connections (healthcheck, streams)
            # aren't stalled for its duration
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(
                None,
                lambda: subprocess.run(
                    play_cmd, input=wav_bytes, check=True
                ),
            )
            return HttpResponse(body=b"OK")
        return HttpResponse(body=wav_bytes, content_type="audio/wav")

    @server.route("/api/voices")
    async def api_voices(request: Request):
        voices_by_key = {v.key: v for v in app._catalog.get_voices()}
        voice_dicts = []
        for key in sorted(voices_by_key):
            voice = voices_by_key[key]
            d = dataclasses.asdict(voice)
            if d.get("aliases") is not None:
                d["aliases"] = sorted(d["aliases"])
            native, english = language_names(voice.language)
            d["language_native"] = native
            d["language_english"] = english
            d["sample_text"] = sample_sentence(voice.language)
            voice_dicts.append(d)
        return HttpResponse(
            body=json.dumps(voice_dicts).encode(),
            content_type="application/json",
        )

    @server.route("/api/healthcheck")
    async def api_healthcheck(request: Request):
        return "OK"

    @server.route("/api/stats")
    async def api_stats(request: Request):
        """Serving counters (mimic3-tpu extension), cumulative since the
        server started, so a client diffs two reads: ``scheduler``
        (batches, items, adaptive extensions and the sums of seconds
        ``queue_wait_s`` over items, ``collect_s`` and ``device_s`` over
        batches), ``requests`` (per mode, ``wav`` and ``stream``: count,
        items and the sums of seconds of :class:`RequestStats`),
        ``device`` (calls in flight) and ``voices`` (each session's
        utterances, RTF, signatures run, hot-path first runs, bucket
        fallbacks, dispatch counts, ``speculation``, the frame counters
        ``frames_decoded`` and ``frames_returned``, and
        ``duration_graph``: the batch path's duration passes captured as
        a CUDA graph, replayed, issued eagerly, and the graphs that
        failed)."""
        sessions = {}
        for key, session in app.voice_stats_snapshot().items():
            stats = session.stats
            sessions[key] = {
                "utterances": stats.utterances,
                "mean_rtf": stats.mean_rtf,
                "last_rtf": stats.last_rtf,
                "audio_sec": stats.audio_sec,
                # speculative decodes: dispatched, used, fell back,
                # skipped, overlapped
                "speculation": dict(session.speculation),
                # batch calls: rows x frame bucket of every decode
                # dispatched, and the real rows' frames returned
                "frames_decoded": stats.frames_decoded,
                "frames_returned": stats.frames_returned,
                # the batch path's duration passes: captured, replayed,
                # eager, capture_failed
                "duration_graph": stats.duration_graph_snapshot(),
                # load tests diff this across a run to prove the hot
                # path ran no signature first
                "jit_executables": session.jit_executable_count(),
                # first runs observed AFTER warmup completed: a nonzero
                # value means live traffic escaped the warmed set (a
                # --warmup-profile miss) and the profile needs
                # re-capturing; the session logs each occurrence
                "hot_path_compiles": session.hot_path_compiles(),
                # natural->dispatched signature counts for requests
                # that escaped the warmed set and rounded UP to a
                # warmed bucket (paying padding, not a first run); any
                # entries here also mean the profile is stale
                "bucket_fallbacks": stats.fallbacks_snapshot(),
                # per-executable dispatch counts: save this table and
                # restart with --warmup-profile to warm only the
                # executables this deployment's traffic actually hits
                "executable_hits": stats.hits_snapshot(),
            }
        from ..runtime.session import (
            device_calls_in_flight,
            graceful_shutdown_requested,
        )

        scheduler = app.scheduler.stats
        payload = {
            "scheduler": {
                "batches": scheduler.batches,
                "items": scheduler.items,
                "mean_batch_size": scheduler.mean_batch_size,
                "adaptive_extensions": scheduler.adaptive_extensions,
                "current_load": app.scheduler.current_load(),
                "queue_wait_s": scheduler.queue_wait_s,
                "collect_s": scheduler.collect_s,
                "device_s": scheduler.device_s,
            },
            "requests": app.requests.snapshot(),
            # tooling polls this before terminating the server:
            # terminate only at calls_in_flight == 0
            "device": {
                "calls_in_flight": device_calls_in_flight(),
                "draining": graceful_shutdown_requested(),
            },
            "voices": sessions,
        }
        return HttpResponse(
            body=json.dumps(payload).encode(),
            content_type="application/json",
        )

    @server.route("/api/profile", methods=("POST",))
    async def api_profile(request: Request):
        """Capture a ``torch.profiler`` trace (host ops of every thread
        and, on a card, CUDA kernels and copies) for ``?seconds=N``
        (default 3, max 60) into ``--profile-dir`` (or a temporary
        directory) as a Chrome trace JSON; one capture at a time (409
        while one runs)."""
        import asyncio
        import tempfile
        import time

        try:
            seconds = float(request.arg("seconds", "3"))
        except ValueError:
            seconds = 3.0
        if not (0.0 < seconds <= 60.0):  # also rejects nan
            seconds = 3.0
        profile_dir = getattr(app.config, "profile_dir", None) or (
            tempfile.mkdtemp(prefix="mimic3_profile_")
        )
        if not app._profile_lock.acquire(blocking=False):
            return HttpResponse(
                body=b'{"error": "profile capture already running"}',
                status=409,
                content_type="application/json",
            )
        try:
            prof = _profiler()
            prof.start()
            try:
                await asyncio.sleep(seconds)
            finally:
                prof.stop()
            Path(profile_dir).mkdir(parents=True, exist_ok=True)
            trace = Path(profile_dir) / f"trace_{time.time_ns()}.json"
            await asyncio.get_running_loop().run_in_executor(
                None, prof.export_chrome_trace, str(trace)
            )
        finally:
            app._profile_lock.release()
        payload = {"profile_dir": profile_dir, "seconds": seconds}
        return HttpResponse(
            body=json.dumps(payload).encode(),
            content_type="application/json",
        )

    @server.route("/process", methods=("GET", "POST"))
    async def marytts_process(request: Request):
        from urllib.parse import parse_qs

        voice = config.voice
        if request.method == "POST":
            data = parse_qs(request.body.decode("utf-8"))
            text = data.get("INPUT_TEXT", [""])[0]
            if "VOICE" in data:
                voice = str(data.get("VOICE", [voice])[0]).strip()
        else:
            text = request.arg("INPUT_TEXT", "")
            voice = str(request.arg("VOICE", voice) or "").strip()
        if config.max_text_length:
            text = text[: config.max_text_length]
        voice = voice or config.voice or DEFAULT_VOICE
        ssml = text.strip().startswith("<")

        async def wav(req) -> HttpResponse:
            wav_bytes = await app.text_to_wav(
                TtsParams(text=text, voice=voice, ssml=ssml)
            )
            return HttpResponse(body=wav_bytes, content_type="audio/wav")

        return await served("wav", text, wav)

    @server.route("/voices")
    async def marytts_voices(request: Request):
        lines = []
        for voice in sorted(
            app._catalog.get_voices(), key=lambda v: v.key
        ):
            if not Path(voice.location).is_dir():
                continue  # only installed voices
            if voice.is_multispeaker and voice.speakers:
                for speaker in voice.speakers:
                    lines.append(
                        f"{voice.key}#{speaker} {voice.language} NA vits"
                    )
            else:
                lines.append(f"{voice.key} {voice.language} NA vits")
        return "\n".join(lines)

    @server.route("/")
    async def index(request: Request):
        html = (_TEMPLATE_DIR / "index.html").read_text("utf-8")
        html = html.replace(
            "__DEFAULT_VOICE__",
            getattr(config, "default_voice", None)
            or config.voice
            or DEFAULT_VOICE,
        )
        if not getattr(config, "show_openapi", True):
            # --no-show-openapi (reference: mimic3_http/args.py:98-100)
            html = re.sub(
                r"<!--OPENAPI_LINK-->.*?<!--/OPENAPI_LINK-->",
                "",
                html,
                flags=re.S,
            )
        return HttpResponse(
            body=html.encode(), content_type="text/html; charset=utf-8"
        )

    @server.route("/openapi.json")
    async def openapi_json(request: Request):
        return HttpResponse(
            body=json.dumps(_openapi_spec()).encode(),
            content_type="application/json",
        )

    @server.route("/openapi")
    @server.route("/openapi/")
    async def openapi_page(request: Request):
        html = (_TEMPLATE_DIR / "openapi.html").read_text("utf-8")
        return HttpResponse(
            body=html.encode(), content_type="text/html; charset=utf-8"
        )

    return server


def _profiler() -> "torch.profiler.profile":
    """Host ops of every thread (request workers, the scheduler and
    continuation drivers issue the device work, not the event loop) and,
    on a card, its kernels and copies."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True
        ),
    )


def _openapi_spec() -> dict:
    return {
        "openapi": "3.0.0",
        "info": {
            "title": "mimic3-tpu",
            "description": "Text-to-speech HTTP API on PyTorch "
            "(Mimic 3 compatible)",
            "version": "0.1.0",
        },
        "paths": {
            "/api/tts": {
                "get": {
                    "summary": "Synthesize text to WAV",
                    "parameters": [
                        {"name": "text", "in": "query", "required": True,
                         "schema": {"type": "string"}},
                        {"name": "voice", "in": "query",
                         "schema": {"type": "string"}},
                        {"name": "noiseScale", "in": "query",
                         "schema": {"type": "number"}},
                        {"name": "noiseW", "in": "query",
                         "schema": {"type": "number"}},
                        {"name": "lengthScale", "in": "query",
                         "schema": {"type": "number"}},
                        {"name": "ssml", "in": "query",
                         "schema": {"type": "boolean"}},
                        {"name": "textLanguage", "in": "query",
                         "schema": {"type": "string"}},
                        {"name": "cacheId", "in": "query",
                         "schema": {"type": "string"}},
                        {"name": "noCache", "in": "query",
                         "schema": {"type": "boolean"}},
                        {"name": "audioTarget", "in": "query",
                         "schema": {"type": "string",
                                    "enum": ["client", "server"]}},
                        {"name": "streaming", "in": "query",
                         "schema": {"type": "boolean"},
                         "description": "Chunked WAV: sentences stream "
                         "as they are synthesized"},
                    ],
                    "responses": {"200": {"description": "WAV audio"}},
                },
                "post": {
                    "summary": "Synthesize body text/SSML to WAV",
                    "responses": {"200": {"description": "WAV audio"}},
                },
            },
            "/api/voices": {
                "get": {
                    "summary": "List available voices",
                    "responses": {"200": {"description": "JSON list"}},
                }
            },
            "/api/healthcheck": {
                "get": {
                    "summary": "Liveness check",
                    "responses": {"200": {"description": "OK"}},
                }
            },
            "/api/stats": {
                "get": {
                    "summary": "Serving counters, cumulative: batching "
                    "and its seconds, request seconds by mode, RTF, "
                    "signatures, speculation, duration graphs",
                    "responses": {"200": {"description": "JSON"}},
                }
            },
            "/api/profile": {
                "post": {
                    "summary": "Capture a torch.profiler trace",
                    "responses": {"200": {"description": "JSON"}},
                }
            },
            "/process": {
                "get": {"summary": "MaryTTS-compatible synthesis",
                        "responses": {"200": {"description": "WAV"}}},
                "post": {"summary": "MaryTTS-compatible synthesis",
                         "responses": {"200": {"description": "WAV"}}},
            },
            "/voices": {
                "get": {"summary": "MaryTTS-compatible voice list",
                        "responses": {"200": {"description": "text"}}}
            },
        },
    }
