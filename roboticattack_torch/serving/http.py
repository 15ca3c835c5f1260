"""Minimal HTTP front-end over DynamicBatcher (stdlib-only).

Gives robot clients a process boundary: N controllers POST frames
concurrently; handler threads block on batcher futures, so requests arriving
within the batching window share one decode pass on the device.

Protocol (JSON over HTTP/1.1):
  POST /act
    {"task": "<instruction>",
     "image_b64": "<base64 of raw uint8 H*W*3 bytes>", "shape": [H, W, 3]}
    or {"task": ..., "image": <nested uint8 list [H][W][3]>}
    optionally + "draft_tokens": [7 ints] (the previous reply's "tokens";
    needs a drafts-enabled server: a correct draft runs the decode tail as
    one Jacobi pass)
    -> 200 {"action": [7 floats], "tokens": [7 ints]}   (unnormalized 7-DoF;
       "tokens" on drafts-enabled servers: send it back next step)
    -> 400 {"error": ...} on malformed input (also a draft sent to a server
       without drafts, or one that is not 7 ids of the vocabulary), 500 on
       decode failure
  GET /healthz
    -> 200 {"ok": true, "stats": {...}, "buckets": {...}, "latency": {...},
            "verify_passes": {...}}  (the last on drafts-enabled servers)

Deliberately not here: TLS, auth, schema evolution — this is the in-cluster
data plane; put a real gateway in front for anything public.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from .batcher import DynamicBatcher

MAX_BODY_BYTES = 64 * 1024 * 1024  # a 224x224x3 frame is ~150 KB; be generous


def _decode_image(payload: dict) -> np.ndarray:
    if "image_b64" in payload:
        shape = payload.get("shape")
        if (
            not isinstance(shape, (list, tuple)) or len(shape) != 3
            or shape[2] != 3
        ):
            raise ValueError("image_b64 needs shape=[H, W, 3]")
        raw = base64.b64decode(payload["image_b64"], validate=True)
        expected = int(shape[0]) * int(shape[1]) * 3
        if len(raw) != expected:
            raise ValueError(
                f"image_b64 decodes to {len(raw)} bytes, shape wants {expected}"
            )
        return np.frombuffer(raw, np.uint8).reshape(shape)
    if "image" in payload:
        img = np.asarray(payload["image"], dtype=np.uint8)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"image must be [H, W, 3] uint8, got {img.shape}")
        return img
    raise ValueError("body needs image_b64+shape or image")


class _Handler(BaseHTTPRequestHandler):
    # set by make_server(): the shared batcher + request timeout
    batcher: DynamicBatcher = None
    act_timeout_s: float = 300.0

    def _reply(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # stderr noise off the hot path
        pass

    def do_GET(self):
        if self.path != "/healthz":
            return self._reply(404, {"error": "unknown path"})
        body = {
            "ok": True,
            "stats": dict(self.batcher.stats),
            "buckets": {str(k): v for k, v in self.batcher.bucket_counts().items()},
            "latency": self.batcher.latency_quantiles(),
        }
        if self.batcher.drafts:
            body["verify_passes"] = self.batcher.verify_pass_stats()
        self._reply(200, body)

    def do_POST(self):
        if self.path != "/act":
            return self._reply(404, {"error": "unknown path"})
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0 or n > MAX_BODY_BYTES:
                raise ValueError(f"Content-Length {n} out of range")
            payload = json.loads(self.rfile.read(n))
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            task = payload["task"]
            if not isinstance(task, str) or not task:
                raise ValueError("task must be a non-empty string")
            image = _decode_image(payload)
            draft = payload.get("draft_tokens")
            if draft is not None:
                if not self.batcher.drafts:
                    raise ValueError("this server was not started with drafts enabled (cli.serve --drafts)")
                draft = self.batcher.check_draft(draft)
        # TypeError covers malformed nested payloads (float shape entries,
        # non-subscriptable bodies) — a 400, not a dropped connection
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            return self._reply(400, {"error": str(e)})
        fut = (self.batcher.submit_full(image, task, draft)
               if self.batcher.drafts else self.batcher.submit(image, task))
        try:
            res = fut.result(timeout=self.act_timeout_s)
        except Exception as e:  # decode failure / shutdown / timeout
            # cancel so the worker drops the abandoned request at claim time
            fut.cancel()
            return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
        action, tokens = (res.action, res.tokens) if self.batcher.drafts else (res, None)
        body = {"action": [float(x) for x in action]}
        if tokens is not None:
            body["tokens"] = [int(t) for t in tokens]
        self._reply(200, body)


def make_server(
    batcher: DynamicBatcher,
    host: str = "127.0.0.1",
    port: int = 0,
    act_timeout_s: float = 300.0,
) -> ThreadingHTTPServer:
    """Build (not start) a threaded HTTP server bound to (host, port);
    port=0 picks a free one (server.server_address[1] has it)."""
    handler = type(
        "BoundHandler", (_Handler,),
        {"batcher": batcher, "act_timeout_s": act_timeout_s},
    )
    return ThreadingHTTPServer((host, port), handler)


class ActionServer:
    """Owns a DynamicBatcher + HTTP server; start()/shutdown() lifecycle."""

    def __init__(
        self,
        policy,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        act_timeout_s: float = 300.0,
        drafts: bool = False,
    ) -> None:
        self.batcher = DynamicBatcher(
            policy, max_batch=max_batch, max_wait_ms=max_wait_ms, drafts=drafts,
        )
        self.httpd = make_server(self.batcher, host, port, act_timeout_s)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="vla-http", daemon=True
        )
        self._thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self.batcher.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.shutdown()
