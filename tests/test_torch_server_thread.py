"""The port's HTTP server on a background thread, for a process that reads
the app's state while it serves: the server tests and ``chip_smoke.py``
import :class:`ServerThread` from here.  ``python -m
mimic3_tpu_torch.server`` is the package's one way to serve.
"""

import asyncio
import socket
import threading
import time
import typing
import urllib.request

from mimic3_tpu_torch.server.app import TtsApp, build_server


class ServerThread:
    """An app's HTTP server (the port's routes) on its own event loop in a
    daemon thread.  ``start`` returns once the server answers."""

    def __init__(self, app: TtsApp, host: str = "127.0.0.1"):
        with socket.socket() as sock:  # a free port, released for the server
            sock.bind((host, 0))
            self.port = sock.getsockname()[1]
        self.host = host
        self.base_url = f"http://{host}:{self.port}"
        self._server = build_server(app)
        self._loop = asyncio.new_event_loop()
        self._task: typing.Optional[asyncio.Task] = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tts-http"
        )

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._task = self._loop.create_task(
            self._server.serve(self.host, self.port)
        )
        try:
            self._loop.run_until_complete(self._task)
        except asyncio.CancelledError:
            pass
        finally:
            self._loop.close()

    def start(self, timeout: float = 60.0) -> "ServerThread":
        self._thread.start()
        deadline = time.monotonic() + timeout
        while True:
            try:
                with urllib.request.urlopen(
                    f"{self.base_url}/api/healthcheck", timeout=2
                ):
                    return self
            except OSError:
                if time.monotonic() > deadline or not self._thread.is_alive():
                    raise RuntimeError("the server did not start") from None
                time.sleep(0.1)

    def stop(self, timeout: float = 30.0) -> None:
        if self._task is not None:
            self._loop.call_soon_threadsafe(self._task.cancel)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("the server thread did not stop")


def test_server_thread_serves_then_stops(tmp_path):
    """An app with no voice loaded answers its healthcheck on the thread,
    and ``stop`` ends the thread and frees the port."""
    from mimic3_tpu_torch.server.__main__ import create_app

    app = create_app(["--voices-dir", str(tmp_path), "--device", "cpu"])
    srv = ServerThread(app).start()
    try:
        with urllib.request.urlopen(
            f"{srv.base_url}/api/healthcheck", timeout=10
        ) as r:
            assert r.status == 200
    finally:
        srv.stop()
        app.shutdown()
    assert not srv._thread.is_alive()
    with socket.socket() as sock:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((srv.host, srv.port))
