"""Async HTTP front door for the SNN serving gateway (stdlib asyncio only).

Counterpart of ``repro/launch/gateway_http.py``: a small HTTP/1.1 JSON layer
over ``launch/gateway.py``, asyncio streams and a hand-rolled request parser.
The event loop never blocks on simulation: one pump thread drives
``Gateway.tick`` (replaying the chunk graphs that ``warm_buckets`` captured
on the main thread before the pump started), and request handlers wait on
each request's completion event in the executor, so many connections
multiplex onto one serving loop.  The event loop itself launches nothing on
the card.

Routes:

  POST /v1/simulate
      {"model": "izhikevich", "n_steps": 100, "seed": 7, "priority": 0,
       "deadline_ms": 500, "stim": {"exc": [[...], ...]}}
      -> 200 {"status": "done", "steps_served": 100,
              "spike_counts": {"exc": [...]}, "queue_wait_s": ...}
      -> 200 {"status": "evicted", ...partial counts...}  (deadline hit;
         chunks streamed before eviction are returned, not discarded)
      -> 429 + Retry-After header when the admission queue is full
      -> 400 unknown model / malformed stimulus
  GET /metrics     Prometheus-style text (Gateway.render_metrics)
  GET /healthz     200 "ok"
  GET /v1/trace    Chrome trace_event JSON of the process's build/serve
                   spans so far (a debug endpoint, not a stable API)

Start from the demo CLI (``python -m repro_torch.launch.gateway --http
127.0.0.1:8080``) or embed through ``GatewayHTTP``/``serve_http``.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.launch.gateway import Gateway, GatewayOverloaded
from repro_torch.obs import trace as obs_trace

__all__ = ["GatewayHTTP", "serve_http"]

_MAX_BODY = 64 * 1024 * 1024        # 64 MiB: stim arrays are the payload


def _response(status: int, body: bytes, content_type: str,
              extra_headers: Tuple[Tuple[str, str], ...] = ()) -> bytes:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              405: "Method Not Allowed", 413: "Payload Too Large",
              429: "Too Many Requests",
              500: "Internal Server Error"}.get(status, "OK")
    head = [f"HTTP/1.1 {status} {reason}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
            "Connection: close"]
    head += [f"{k}: {v}" for k, v in extra_headers]
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _json_response(status: int, payload: Dict,
                   extra_headers: Tuple[Tuple[str, str], ...] = ()) -> bytes:
    return _response(status, json.dumps(payload).encode(),
                     "application/json", extra_headers)


class GatewayHTTP:
    """Owns the asyncio server plus the pump thread ticking the gateway.

    The pump is a plain daemon thread (not an asyncio task): `tick` holds
    the gateway lock for a whole chunk, and a thread keeps that
    entirely off the event loop.  It idles at ``idle_sleep_s`` when no
    model has work, so an empty gateway costs ~nothing.
    """

    def __init__(self, gateway: Gateway, host: str = "127.0.0.1",
                 port: int = 0, idle_sleep_s: float = 0.005):
        self.gateway = gateway
        self.host = host
        self.port = port
        self.idle_sleep_s = idle_sleep_s
        self._server: Optional[asyncio.AbstractServer] = None
        self._stop = threading.Event()
        self._pump: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        sock = self._server.sockets[0].getsockname()
        self.host, self.port = sock[0], sock[1]
        self._stop.clear()
        self._pump = threading.Thread(target=self._pump_loop,
                                      name="gateway-pump", daemon=True)
        self._pump.start()
        return self.host, self.port

    async def stop(self) -> None:
        self._stop.set()
        if self._pump is not None:
            self._pump.join(timeout=5)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    def _pump_loop(self) -> None:
        import time
        while not self._stop.is_set():
            if not self.gateway.tick():
                time.sleep(self.idle_sleep_s)

    # -- request handling -----------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            out = await self._dispatch(reader)
        except Exception as e:            # defensive: never kill the server
            out = _json_response(500, {"error": f"{type(e).__name__}: {e}"})
        try:
            writer.write(out)
            await writer.drain()
        finally:
            writer.close()

    async def _dispatch(self, reader: asyncio.StreamReader) -> bytes:
        request_line = (await reader.readline()).decode("latin1").strip()
        parts = request_line.split()
        if len(parts) < 2:
            return _json_response(400, {"error": "malformed request line"})
        method, path = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        while True:
            line = (await reader.readline()).decode("latin1").strip()
            if not line:
                break
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()

        if method == "GET" and path == "/healthz":
            return _response(200, b"ok\n", "text/plain")
        if method == "GET" and path == "/metrics":
            return _response(200, self.gateway.render_metrics().encode(),
                             "text/plain; version=0.0.4")
        if method == "GET" and path == "/v1/trace":
            return _response(200,
                             json.dumps(obs_trace.chrome_trace()).encode(),
                             "application/json")
        if path == "/v1/simulate":
            if method != "POST":
                return _json_response(405, {"error": "POST required"})
            length = int(headers.get("content-length", "0"))
            if length <= 0:
                return _json_response(400, {"error": "missing body"})
            if length > _MAX_BODY:
                return _json_response(413, {"error": "body too large"})
            body = await reader.readexactly(length)
            return await self._simulate(body)
        return _json_response(404, {"error": f"no route {path}"})

    async def _simulate(self, body: bytes) -> bytes:
        try:
            payload = json.loads(body)
            model = payload["model"]
            n_steps = int(payload["n_steps"])
            stim = {p: np.asarray(a, np.float32)
                    for p, a in payload.get("stim", {}).items()}
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            return _json_response(400, {"error": f"bad request: {e}"})
        loop = asyncio.get_running_loop()
        try:
            req = self.gateway.submit(
                model, stim, n_steps,
                seed=int(payload.get("seed", 0)),
                priority=int(payload.get("priority", 0)),
                deadline_ms=payload.get("deadline_ms"))
        except GatewayOverloaded as e:
            return _json_response(
                429, {"error": str(e), "retry_after_s": e.retry_after_s},
                extra_headers=(("Retry-After",
                                f"{max(1, int(e.retry_after_s + 0.5))}"),))
        except (KeyError, ValueError) as e:
            return _json_response(400, {"error": str(e)})
        # wait for completion/eviction off the event loop; the deadline
        # bounds eviction, so cap the wait well past it as a safety net
        timeout = None
        if payload.get("deadline_ms") is not None:
            timeout = payload["deadline_ms"] / 1e3 + 30.0
        finished = await loop.run_in_executor(None, req.wait, timeout)
        if not finished:
            return _json_response(500, {"error": "request stalled"})
        timing = self.gateway.workers[model].sched.timings.get(req.rid)
        out = {
            "rid": req.rid,
            "status": req.status,
            "n_steps": req.n_steps,
            "steps_served": req.steps_served,
            "spike_counts": {k: np.asarray(v).tolist()
                             for k, v in req.spike_counts.items()},
            "queue_wait_s": (timing.queue_wait_s
                             if timing is not None else None),
            "total_s": timing.total_s if timing is not None else None,
        }
        return _json_response(200, out)


def serve_http(gateway: Gateway, host: str = "127.0.0.1",
               port: int = 8080) -> None:
    """Blocking convenience runner (the CLI's --http mode)."""

    async def _main():
        srv = GatewayHTTP(gateway, host, port)
        h, p = await srv.start()
        print(f"[gateway] HTTP front door on http://{h}:{p} "
              f"(POST /v1/simulate, GET /metrics, GET /healthz)")
        try:
            await asyncio.Event().wait()     # until interrupted
        finally:
            await srv.stop()

    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        print("[gateway] shutting down")
