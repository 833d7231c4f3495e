"""Minimal asyncio HTTP/1.1 server (stdlib only).

The environment provides no async web framework (quart/hypercorn are not
dependencies here), and the surface we need is small: path routing,
query/body parsing, fixed responses.  ~200 lines of stdlib asyncio keeps
the serving tier dependency-free.

Port copy of ``mimic3_tpu/server/httpd.py``.
"""

from __future__ import annotations

import asyncio
import logging
import traceback
import typing
from dataclasses import dataclass, field
from urllib.parse import parse_qs, unquote, urlsplit

_LOGGER = logging.getLogger(__name__)

MAX_BODY_BYTES = 8 * 1024 * 1024
MAX_HEADER_BYTES = 64 * 1024


@dataclass
class Request:
    method: str
    path: str
    query: typing.Dict[str, str]
    headers: typing.Dict[str, str]
    body: bytes = b""

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "")

    def arg(self, name: str, default: typing.Optional[str] = None):
        return self.query.get(name, default)


@dataclass
class HttpResponse:
    body: bytes = b""
    status: int = 200
    content_type: str = "text/plain; charset=utf-8"
    headers: typing.Dict[str, str] = field(default_factory=dict)
    stream: typing.Optional[typing.AsyncIterator[bytes]] = None
    """When set, the response is sent with chunked transfer encoding and
    ``body`` is ignored; the iterator's chunks go out as they arrive."""
    done: typing.Optional[typing.Callable[[bool], None]] = None
    """When set, called once the response's last byte is handed to the
    socket (True) or its sending failed (False)."""


_STATUS_TEXT = {
    200: "OK",
    204: "No Content",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    413: "Payload Too Large",
    500: "Internal Server Error",
}

Handler = typing.Callable[
    [Request], typing.Awaitable[typing.Union[HttpResponse, str, bytes]]
]


class HttpServer:
    """Route table + connection handling."""

    def __init__(self) -> None:
        self._routes: typing.Dict[
            str, typing.Dict[str, Handler]
        ] = {}
        self._prefix_routes: typing.List[typing.Tuple[str, Handler]] = []

    def route(
        self, path: str, methods: typing.Sequence[str] = ("GET",)
    ) -> typing.Callable[[Handler], Handler]:
        def register(handler: Handler) -> Handler:
            if path.endswith("/*"):
                self._prefix_routes.append((path[:-1], handler))
            else:
                table = self._routes.setdefault(path, {})
                for method in methods:
                    table[method.upper()] = handler
            return handler

        return register

    # -- connection handling ---------------------------------------------------

    async def _read_request(
        self, reader: asyncio.StreamReader
    ) -> typing.Optional[Request]:
        try:
            header_blob = await reader.readuntil(b"\r\n\r\n")
        except (
            asyncio.IncompleteReadError,
            asyncio.LimitOverrunError,
            ConnectionResetError,
        ):
            return None
        if len(header_blob) > MAX_HEADER_BYTES:
            return None
        lines = header_blob.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) < 3:
            return None
        method, target = parts[0].upper(), parts[1]
        headers: typing.Dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                name, _, value = line.partition(":")
                headers[name.strip().lower()] = value.strip()
        # internal flag namespace — never client-controlled
        headers.pop("x-body-too-large", None)

        body = b""
        length = int(headers.get("content-length", "0") or 0)
        if length > MAX_BODY_BYTES:
            # mark oversized; the dispatcher answers 413 and the
            # connection is closed (the unread body would desync it)
            headers["x-body-too-large"] = "1"
            headers["connection"] = "close"
        elif length:
            try:
                body = await reader.readexactly(length)
            except (
                asyncio.IncompleteReadError,
                ConnectionResetError,
            ):
                # client aborted mid-body: treat as no request
                return None

        split = urlsplit(target)
        query: typing.Dict[str, str] = {}
        for key, values in parse_qs(
            split.query, keep_blank_values=True
        ).items():
            query[key] = values[0]
        return Request(
            method=method,
            path=unquote(split.path),
            query=query,
            headers=headers,
            body=body,
        )

    def _resolve(
        self, request: Request
    ) -> typing.Tuple[typing.Optional[Handler], int]:
        table = self._routes.get(request.path)
        if table is not None:
            handler = table.get(request.method)
            if handler is None and request.method == "HEAD":
                handler = table.get("GET")
            if handler is None:
                return None, 405
            return handler, 200
        for prefix, handler in self._prefix_routes:
            if request.path.startswith(prefix):
                return handler, 200
        return None, 404

    async def _handle_connection(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
    ) -> None:
        try:
            while True:
                request = await self._read_request(reader)
                if request is None:
                    break
                response = await self._dispatch(request)
                keep_alive = (
                    request.headers.get("connection", "").lower()
                    != "close"
                )
                await self._write_response(
                    writer, response, keep_alive, request.method
                )
                if not keep_alive:
                    break
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _dispatch(self, request: Request) -> HttpResponse:
        if request.headers.get("x-body-too-large"):
            return HttpResponse(
                body=b"413 Payload Too Large", status=413
            )
        handler, status = self._resolve(request)
        if handler is None:
            return HttpResponse(
                body=f"{status} {_STATUS_TEXT[status]}".encode(),
                status=status,
            )
        try:
            result = await handler(request)
        except Exception as err:  # error contract: text + 500
            _LOGGER.exception("Handler error for %s", request.path)
            detail = f"{err.__class__.__name__}: {err}"
            if _LOGGER.isEnabledFor(logging.DEBUG):
                detail += "\n" + traceback.format_exc()
            return HttpResponse(body=detail.encode(), status=500)
        if isinstance(result, HttpResponse):
            return result
        if isinstance(result, bytes):
            return HttpResponse(body=result)
        return HttpResponse(body=str(result).encode())

    async def _write_response(
        self,
        writer: asyncio.StreamWriter,
        response: HttpResponse,
        keep_alive: bool,
        method: str,
    ) -> None:
        sent = False
        try:
            await self._send(writer, response, keep_alive, method)
            sent = True
        finally:
            if response.done is not None:
                response.done(sent)

    async def _send(
        self,
        writer: asyncio.StreamWriter,
        response: HttpResponse,
        keep_alive: bool,
        method: str,
    ) -> None:
        status_text = _STATUS_TEXT.get(response.status, "Unknown")
        headers = {
            "Content-Type": response.content_type,
            "Connection": "keep-alive" if keep_alive else "close",
            "Access-Control-Allow-Origin": "*",
            **response.headers,
        }
        if response.stream is not None:
            headers["Transfer-Encoding"] = "chunked"
        else:
            headers["Content-Length"] = str(len(response.body))
        head = [f"HTTP/1.1 {response.status} {status_text}"]
        head.extend(f"{k}: {v}" for k, v in headers.items())
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        if method == "HEAD":
            await writer.drain()
            return
        if response.stream is not None:
            async for chunk in response.stream:
                if not chunk:
                    continue
                writer.write(f"{len(chunk):x}\r\n".encode())
                writer.write(chunk)
                writer.write(b"\r\n")
                await writer.drain()
            writer.write(b"0\r\n\r\n")
        else:
            writer.write(response.body)
        await writer.drain()

    async def serve(
        self,
        host: str,
        port: int,
        ready_event: typing.Optional[asyncio.Event] = None,
    ) -> None:
        server = await asyncio.start_server(
            self._handle_connection, host, port
        )
        _LOGGER.info("Listening on http://%s:%s", host, port)
        if ready_event is not None:
            ready_event.set()
        async with server:
            await server.serve_forever()
