"""JSON/HTTP front end for :class:`BatchingPredictor` — stdlib only.

Endpoints
---------
``POST /v1/predict``
    ``{"instances": [{"x_ts": [[...T×2V...]], "static": [...D...],
    "bin_ends": [...T...]?, "image_id": int? | "pixel_u8_b64": str?}, ...]}``
    → ``{"predictions": [{"probabilities": [...], "labels": [...], ...}]}``.
    ``pixel_u8_b64`` is base64 of raw uint8 bytes, shape ``[S, S, 3]``
    row-major (pixel mode only; S announced by ``/v1/meta``).
``GET /healthz`` → liveness.
``GET /v1/meta`` → model geometry + labels (what a client must send).
``GET /v1/stats`` → batching/latency counters.

Handler threads only enqueue into the predictor (its single batcher thread
owns the device), so ``ThreadingHTTPServer``'s thread-per-connection model
costs no device contention; queue capacity maps to HTTP 503.
"""
from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .predictor import BatchingPredictor, QueueFullError

MAX_BODY_BYTES = 256 * 1024 * 1024


def _decode_pixels(inst: dict, image_size: Optional[int]) -> None:
    """In-place: pixel_u8_b64 → pixel_u8 ndarray (square [S,S,3])."""
    b64 = inst.pop("pixel_u8_b64", None)
    if b64 is None:
        return
    raw = base64.b64decode(b64)
    side = image_size or int(round((len(raw) / 3) ** 0.5))
    arr = np.frombuffer(raw, np.uint8)
    if arr.size != side * side * 3:
        raise ValueError(f"pixel_u8_b64 decodes to {arr.size} bytes, "
                         f"expected {side}x{side}x3={side * side * 3}")
    inst["pixel_u8"] = arr.reshape(side, side, 3)


def make_server(predictor: BatchingPredictor, host: str = "127.0.0.1",
                port: int = 8389, meta: Optional[dict] = None
                ) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; ``port=0`` binds an ephemeral
    port (tests) — read it back from ``server.server_address[1]``."""
    meta = dict(meta or {})
    image_size = meta.get("image_size")

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # quiet; stats endpoint instead
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/v1/stats":
                self._json(200, predictor.stats())
            elif self.path == "/v1/meta":
                self._json(200, {**meta, "labels": predictor.labels,
                                 "buckets": list(predictor.buckets)})
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/v1/predict":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > MAX_BODY_BYTES:
                    self._json(413, {"error": "body too large"})
                    return
                req = json.loads(self.rfile.read(length))
                instances = req["instances"]
                if not isinstance(instances, list) or not instances:
                    raise ValueError("instances must be a non-empty list")
                for inst in instances:
                    _decode_pixels(inst, image_size)
                futures = [predictor.submit(inst) for inst in instances]
                preds = [f.result(timeout=120.0) for f in futures]
                self._json(200, {"predictions": preds})
            except QueueFullError as e:
                self._json(503, {"error": str(e)})
            except (KeyError, ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
            except Exception as e:          # noqa: BLE001
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever(server: ThreadingHTTPServer,
                  background: bool = False) -> Optional[threading.Thread]:
    if background:
        t = threading.Thread(target=server.serve_forever,
                             name="serve-http", daemon=True)
        t.start()
        return t
    server.serve_forever()
    return None
