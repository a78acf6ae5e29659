"""HTTP server of the PyTorch port for exported artifacts (stdlib HTTP).

    python -m image_restoration_sde_tpu_torch.serve --artifact m.irsdet [--host 127.0.0.1]
        [--port 0] [--max-batch 8] [--window-ms 5] [--max-wait-ms MS] [--device cuda|cpu]
        [--devices cuda:0,cuda:1]

Counterpart of ``tools/serve.py``, with the same protocol.  The server holds
no model code: ``exporting.load_artifact`` and image IO only.  It runs on
the card unless ``--device cpu`` is given; without a card it raises.
``--devices`` splits each call's batch over several devices
(``exporting.DataParallelSampler``: a symbolic-batch, per-sample-seed
artifact), and ``/health`` lists them under ``serving.devices``.

Endpoints:

- ``GET /``: an upload page (drop an image, see the restoration);
- ``GET /health``: the artifact's header, plus ``serving`` (the batching
  configuration, ``seed_reproducible``, the device calls so far:
  ``batches``, ``requests``, ``mean_batch`` riders a call, and the
  process's ``launches`` of each of the port's kernels);
- ``POST /restore[?seed=N]``: body a PNG or JPEG image, response the
  restored PNG.  An image smaller than the artifact's size is
  reflect-padded and cropped back; a larger one gets 400.  ``seed`` must be
  an integer in [0, 2**32): any other gets 400 before the request joins a
  batch, so it never fails its batch companions.  Only such faults of the
  request get 400; a fault of the device call that served it is the
  server's, and gets 500 (:class:`BatchError`).

Concurrent requests ride one device call (:class:`MicroBatcher`): the
first request opens a ``--window-ms`` collection window, up to
``--max-batch`` requests join it, and while the device is busy the worker
keeps collecting (``--max-wait-ms`` bounds how long a request may wait).  A
fixed-batch artifact's call is padded with copies of the last row; a
symbolic one's batch is rounded up to a power of two, clamped to
``--max-batch``.

Seeds (``serving.seed_reproducible``): a per-sample-seed artifact hands
every rider its own seed; a scalar-seed artifact uses the first rider's
seed for the batch, so a request's noise depends on its batch and position.
The same (image, seed) gives the same bytes only where the device computes
each row the same whatever the batch: at a fixed batch (one program shape),
for ``--max-batch 1``, or where the artifact draws no noise (seed
``ignored``).  A symbolic-batch artifact's rows may run at other batch
sizes, where the libraries may pick other algorithms, so it is not
reproducible even with per-sample seeds.

``--port 0`` binds a free port; the server prints ``serving on
<host>:<port>`` once it is warm and bound.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .data.io_utils import decode_img_bytes, encode_png
from .ops import KERNELS

SEED_LIMIT = 2**32


def to_numpy(out) -> np.ndarray:
    """A call's output on the host (waits for the device)."""
    if hasattr(out, "detach"):
        return out.detach().cpu().numpy()
    return np.asarray(out)


class MicroBatcher:
    """Groups concurrent restore requests into one batched call.

    ``call(batch NHWC float32, seed) -> batch`` is the artifact's entry:
    ``seed`` one int, or with ``per_sample_seed`` a list with one per row.
    ``fixed`` pins the call's only batch; None means a symbolic batch.  A
    worker thread collects and dispatches; a completer thread waits for each
    call's output and hands every caller its row, so one batch's collection
    overlaps the previous batch's run.  A failed call fails its riders only.
    """

    def __init__(self, call, *, fixed=None, max_batch=8, window_s=0.005, max_wait_s=None,
                 per_sample_seed=False):
        self.call = call
        self.fixed = int(fixed) if fixed else None
        self.max_batch = self.fixed or max(1, int(max_batch))
        self.per_sample_seed = bool(per_sample_seed)
        self.window_s = float(window_s)
        self.max_wait_s = float(max_wait_s) if max_wait_s else None
        self.q: "queue.Queue" = queue.Queue()
        # at most two calls queued behind the device
        self._done_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._inflight = 0  # dispatched, not yet completed (under _lock)
        self._lock = threading.Lock()
        self.batches = self.requests = 0  # device calls and their riders (under _lock)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self._completer = threading.Thread(target=self._complete, daemon=True)
        self._completer.start()

    def submit(self, img: np.ndarray, seed: int) -> Future:
        fut: Future = Future()
        self.q.put((img, seed, fut))
        return fut

    def stats(self) -> dict:
        with self._lock:
            return {"batches": self.batches, "requests": self.requests,
                    "mean_batch": self.requests / self.batches if self.batches else None}

    def _target(self, n: int) -> int:
        if self.fixed is not None:
            return self.fixed
        target = 1  # powers of two bound the batch shapes a symbolic call sees
        while target < n:
            target *= 2
        return min(target, self.max_batch)  # the cap is hard

    def _assemble(self, items):
        xs = np.stack([it[0] for it in items])
        n, target = len(items), self._target(len(items))
        if n < target:  # copies of the last row: finite, same dtype and layout
            xs = np.concatenate([xs, np.repeat(xs[-1:], target - n, axis=0)])
        return xs

    def _seeds(self, items, rows: int):
        if not self.per_sample_seed:
            return int(items[0][1])
        seeds = [int(it[1]) for it in items]
        return seeds + [seeds[-1]] * (rows - len(seeds))  # pad rows reuse the last seed

    def _collect(self):
        items = [self.q.get()]
        if self.max_batch == 1:
            return items
        now = time.monotonic()
        hard = None if self.max_wait_s is None else now + self.max_wait_s
        deadline = now + self.window_s if hard is None else min(now + self.window_s, hard)
        while len(items) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                with self._lock:
                    busy = self._inflight > 0
                if not busy or (hard is not None and time.monotonic() >= hard):
                    break
                # the device is still running the previous call: collecting
                # longer costs nothing and keeps the batch full
                left = 0.002
            try:
                items.append(self.q.get(timeout=left))
            except queue.Empty:
                pass
        return items

    def _worker(self):
        while True:
            items = self._collect()
            try:
                xs = self._assemble(items)
                out = self.call(xs, self._seeds(items, len(xs)))
                with self._lock:
                    self._inflight += 1
                    self.batches += 1
                    self.requests += len(items)
                self._done_q.put((items, out))  # not yet synchronised
            except Exception as e:  # noqa: BLE001 -- fail this batch's riders, keep serving
                for _, _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)

    def _complete(self):
        while True:
            items, out = self._done_q.get()
            try:
                out = to_numpy(out)
                for i, (_, _, fut) in enumerate(items):
                    fut.set_result(out[i])
            except Exception as e:  # noqa: BLE001 -- fail this batch's riders, keep serving
                for _, _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
            finally:
                with self._lock:
                    self._inflight -= 1


def seed_reproducible(header: dict, max_batch: int) -> bool:
    """Whether the same (image, seed) gives the same bytes whatever batch it
    rides in: per-sample seeds at a fixed batch, one request a call, or no
    noise at all."""
    fixed = isinstance(header.get("batch"), int)
    seed = header.get("seed", "scalar")
    return (seed == "per_sample" and fixed) or max_batch == 1 or seed == "ignored"


class BatchError(RuntimeError):
    """The device call that carried a request failed: every rider of that
    call gets it, whatever the exception (a ``ValueError`` too)."""


def parse_seed(query: str) -> int:
    """The request's seed: an integer in [0, 2**32), else ValueError."""
    raw = parse_qs(query).get("seed", ["0"])[0]
    try:
        seed = int(raw)
    except ValueError:
        raise ValueError(f"seed must be an integer, not {raw!r}") from None
    if not 0 <= seed < SEED_LIMIT:
        raise ValueError(f"seed {seed} is outside [0, 2**32)")
    return seed


_UI_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>IR-SDE restoration</title><style>
body{font-family:system-ui,sans-serif;max-width:860px;margin:2rem auto;padding:0 1rem;color:#222}
fieldset{border:1px solid #ccc;border-radius:8px;margin-bottom:1rem}
.row{display:flex;gap:1rem;flex-wrap:wrap}figure{margin:0}
img{max-width:400px;border:1px solid #ddd;border-radius:4px;display:block}
#status{color:#666}button{padding:.4rem 1rem}</style></head><body>
<h1>IR-SDE image restoration</h1>
<p>Drop a degraded image; the server runs the full reverse chain of the
exported model and returns the restoration. See <a href="/health">/health</a>
for the artifact header.</p>
<fieldset><legend>Input</legend>
<input type="file" id="file" accept="image/*">
<label>seed <input type="number" id="seed" value="0" min="0" style="width:8em"></label>
<button id="go">Restore</button> <span id="status"></span></fieldset>
<div class="row">
<figure><figcaption>input</figcaption><img id="in" alt=""></figure>
<figure><figcaption>restored</figcaption><img id="out" alt=""></figure></div>
<script>
const $=id=>document.getElementById(id);
$("file").addEventListener("change",()=>{const f=$("file").files[0];
  if(f) $("in").src=URL.createObjectURL(f);});
$("go").addEventListener("click",async()=>{
  const f=$("file").files[0];
  if(!f){$("status").textContent="pick an image first";return;}
  $("status").textContent="restoring\\u2026";$("go").disabled=true;
  try{
    const r=await fetch("/restore?seed="+encodeURIComponent($("seed").value||0),
                        {method:"POST",body:f});
    if(!r.ok){$("status").textContent="error: "+await r.text();return;}
    $("out").src=URL.createObjectURL(await r.blob());
    $("status").textContent="done";
  }catch(e){$("status").textContent="error: "+e;}
  finally{$("go").disabled=false;}
});
</script></body></html>"""


def build_handler(call, header, *, max_batch=8, window_ms=5.0, max_wait_ms=None, devices=None):
    """``(handler class, restore(img uint8 HWC, seed) -> uint8 HWC, batcher)``;
    ``devices``, the devices ``call`` runs on, for ``/health``."""
    H, W = header["size"]
    channels = header.get("channels", 3)
    fixed = header.get("batch")
    fixed = fixed if isinstance(fixed, int) else None
    batcher = MicroBatcher(
        call, fixed=fixed, max_batch=max_batch, window_s=window_ms / 1000.0,
        max_wait_s=None if max_wait_ms is None else max_wait_ms / 1000.0,
        per_sample_seed=header.get("seed") == "per_sample",
    )
    serving = {
        "max_batch": batcher.max_batch,
        "window_ms": float(window_ms),
        "max_wait_ms": None if max_wait_ms is None else float(max_wait_ms),
        "fixed_batch": batcher.fixed,
        "seed_reproducible": seed_reproducible(header, batcher.max_batch),
        "devices": [str(d) for d in devices or []],
    }

    def restore(img: np.ndarray, seed: int) -> np.ndarray:
        h, w = img.shape[:2]
        if h > H or w > W:
            raise ValueError(f"image {h}x{w} exceeds the artifact's size {H}x{W}")
        x = img.astype(np.float32) / 255.0
        if x.ndim == 2:
            x = x[..., None]
        if x.shape[-1] != channels:
            raise ValueError(f"expected {channels} channels, got {x.shape[-1]}")
        x = np.pad(x, ((0, H - h), (0, W - w), (0, 0)), mode="reflect")
        future = batcher.submit(x, seed)
        try:
            out = future.result()[:h, :w]
        except Exception as e:
            raise BatchError(f"{type(e).__name__}: {e}") from e
        return (np.clip(out, 0.0, 1.0) * 255.0).round().astype(np.uint8)

    class Handler(BaseHTTPRequestHandler):
        # keep-alive: concurrent clients keep one connection each
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # stdout carries the "serving on" line only
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path in ("/", "/index.html"):
                return self._send(200, _UI_HTML.encode(), "text/html; charset=utf-8")
            if path != "/health":
                return self._send(404, b"not found", "text/plain")
            launches = {k.symbol: k.launches for k in KERNELS}
            info = {**header, "serving": {**serving, **batcher.stats(), "launches": launches}}
            self._send(200, json.dumps(info, sort_keys=True).encode(), "application/json")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/restore":
                return self._send(404, b"not found", "text/plain")
            try:
                body = self.rfile.read(int(self.headers.get("Content-Length", "0")))
                seed = parse_seed(url.query)
                out = restore(decode_img_bytes(body), seed)
                self._send(200, encode_png(out), "image/png")
            except ValueError as e:  # the request's own fault, found before it joined a batch
                self._send(400, str(e).encode(), "text/plain")
            except Exception as e:  # noqa: BLE001 -- the serve loop must not die
                self._send(500, f"{type(e).__name__}: {e}".encode(), "text/plain")

    return Handler, restore, batcher


class Server(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 128  # the default 5 resets bursty clients


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--artifact", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--max-batch", type=int, default=8,
                        help="requests a call of a symbolic-batch artifact (a fixed-batch one pins its own)")
    parser.add_argument("--window-ms", type=float, default=5.0,
                        help="how long the first request of a batch waits for others")
    parser.add_argument("--max-wait-ms", type=float, default=None,
                        help="the longest a request waits while the device is busy before a partial batch "
                             "is dispatched (default: collect until the device is free)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--devices", default=None,
                        help="comma-separated devices (e.g. cuda:0,cuda:1) to split each call's batch over, in place "
                             "of --device: a symbolic-batch, per-sample-seed artifact")
    args = parser.parse_args(argv)

    from .exporting import load_artifact

    devices = args.devices.split(",") if args.devices else None
    call, header = load_artifact(args.artifact, args.device, devices=devices)
    handler, _, _ = build_handler(call, header, max_batch=args.max_batch, window_ms=args.window_ms,
                                  max_wait_ms=args.max_wait_ms, devices=devices or [args.device])
    # warm the full-batch call before accepting traffic
    H, W = header["size"]
    b = header["batch"] if isinstance(header["batch"], int) else args.max_batch
    seeds = [0] * b if header.get("seed") == "per_sample" else 0
    to_numpy(call(np.zeros((b, H, W, header.get("channels", 3)), np.float32), seeds))

    srv = Server((args.host, args.port), handler)
    print(f"serving on {srv.server_address[0]}:{srv.server_address[1]}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
