"""Server state and routes on the port's engines.

:class:`TorchTtsApp` is the reference :class:`~mimic3_tpu.server.app.
TtsApp` (engine pool, scheduler, WAV cache, preload and warmup) whose
engines load voices onto torch sessions on one device.  Each app holds its
own device, so no module of the reference is patched: a process may hold
several apps and engines.  :func:`build_server` takes the reference's
route table and replaces ``POST /api/profile`` with a ``torch.profiler``
capture.
"""

from __future__ import annotations

import asyncio
import json
import tempfile
import time
import typing
from pathlib import Path

import torch

from mimic3_tpu.engine import Mimic3Settings
from mimic3_tpu.server.app import TtsApp
from mimic3_tpu.server.app import build_server as _build_reference_server
from mimic3_tpu.server.httpd import HttpResponse, HttpServer, Request

from ..engine import Mimic3TextToSpeechSystem
from ..runtime.session import resolve_device


class TorchTtsApp(TtsApp):
    """The reference app with engines that synthesize on PyTorch."""

    def __init__(
        self,
        config,
        device: typing.Union[str, torch.device, None] = None,
    ) -> None:
        # resolved before any request: with no card visible a CUDA device
        # fails at startup, not at the first request (read by _new_engine)
        self.device = resolve_device(device)
        super().__init__(config)

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


def _profiler() -> torch.profiler.profile:
    """Host ops of every thread (request workers, the scheduler and
    continuation drivers issue the device work, not the event loop) and,
    on a card, its kernels and copies."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True
        ),
    )


def build_server(app: TtsApp) -> HttpServer:
    """The reference routes, with the port's ``POST /api/profile``."""
    server = _build_reference_server(app)

    @server.route("/api/profile", methods=("POST",))
    async def api_profile(request: Request):
        """Capture a ``torch.profiler`` trace (host ops and, on a card,
        CUDA kernels and copies) for ``?seconds=N`` (default 3, max 60)
        into ``--profile-dir`` (or a temporary directory) as a Chrome
        trace JSON; one capture at a time (409 while one runs)."""
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

    return server
