"""Benchmark the port's HTTP server end to end: HTTP in, restored PNG out.

    python -m image_restoration_sde_tpu_torch.bench_serve --artifact m.irsdet \\
        [--n 64] [--concurrency 16] [--warmup 16] [--max-batch 8] [--window-ms 5] \\
        [--max-wait-ms MS] [--device cuda|cpu] [--addr HOST:PORT]

Counterpart of ``tools/bench_serve.py``: it spawns ``python -m
image_restoration_sde_tpu_torch.serve`` on the artifact (or, with
``--addr``, benches a running server), fires ``--n`` requests from
``--concurrency`` client threads (each a random PNG at the artifact's size,
request i with seed i), and prints one JSON line: requests/s, latency
percentiles and the mean batch of the device calls, from the server's
``/health`` before and after the timed requests.  The first ``--warmup``
requests are not timed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

import numpy as np

from .data.io_utils import encode_png

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def make_png(size, channels, seed=0) -> bytes:
    rs = np.random.RandomState(seed)
    img = (rs.rand(size[0], size[1], channels) * 255).astype(np.uint8)
    return encode_png(img)


def post(addr: str, body: bytes, seed, timeout: float = 600.0):
    """``(status, response body)`` of one ``POST /restore?seed=...``."""
    req = urllib.request.Request(f"http://{addr}/restore?seed={seed}", data=body, method="POST",
                                 headers={"Content-Type": "image/png"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def health(addr: str) -> dict:
    with urllib.request.urlopen(f"http://{addr}/health", timeout=60) as r:
        return json.loads(r.read())


def fire(addr, body, n, concurrency, timeout=600.0):
    """n POSTs (request i with seed i) from ``concurrency`` threads; returns
    (wall seconds, per-request latencies).  Any request that does not get
    200 raises."""
    lat = [None] * n
    idx = iter(range(n))
    lock = threading.Lock()
    errors = []

    def worker():
        while True:
            with lock:
                i = next(idx, None)
            if i is None:
                return
            t0 = time.perf_counter()
            for attempt in (0, 1):  # one retry: a reset connection is transient
                try:
                    status, out = post(addr, body, i, timeout)
                    if status != 200:
                        errors.append(f"req {i}: HTTP {status}: {out[:200]!r}")
                    lat[i] = time.perf_counter() - t0
                    break
                except ConnectionResetError:
                    if attempt:
                        errors.append(f"req {i}: ConnectionResetError (retried)")
                except Exception as e:  # noqa: BLE001 -- collected, raised below
                    errors.append(f"req {i}: {type(e).__name__}: {e}")
                    break

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError("; ".join(errors[:5]))
    return wall, [x for x in lat if x is not None]


def spawn_server(artifact: str, max_batch: int, window_ms: float, max_wait_ms=None, device: str = "cuda"):
    """Start the port's server on a free port; returns (process, address)
    once it prints its address (warm and bound)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "image_restoration_sde_tpu_torch.serve", "--artifact", artifact, "--port", "0",
           "--max-batch", str(max_batch), "--window-ms", str(window_ms), "--device", device]
    if max_wait_ms is not None:
        cmd += ["--max-wait-ms", str(max_wait_ms)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
    line = proc.stdout.readline()
    if not line.startswith("serving on "):
        proc.kill()
        proc.wait(timeout=30)
        raise RuntimeError(f"the server did not start: {line!r}")
    return proc, line.strip().split()[-1]


def bench(addr: str, n: int, concurrency: int, warmup: int) -> dict:
    header = health(addr)
    body = make_png(header["size"], header.get("channels", 3))
    if warmup:
        fire(addr, body, warmup, concurrency)
    before = health(addr)["serving"]
    wall, lat = fire(addr, body, n, concurrency)
    after = health(addr)["serving"]
    lat_ms = np.asarray(lat) * 1e3
    calls = after["batches"] - before["batches"]
    return {
        "artifact": header.get("config", "?"),
        "kind": header["kind"],
        "size": header["size"],
        "serving": after,
        "n": n,
        "concurrency": concurrency,
        "requests_per_s": n / wall,
        "latency_ms": {q: float(np.percentile(lat_ms, int(q[1:]))) for q in ("p50", "p90", "p99")},
        "device_calls": calls,
        "mean_device_batch": (after["requests"] - before["requests"]) / calls if calls else None,
    }


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--artifact")
    parser.add_argument("--addr", help="bench a running server instead")
    parser.add_argument("--n", type=int, default=64)
    parser.add_argument("--concurrency", type=int, default=16)
    parser.add_argument("--warmup", type=int, default=16)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--window-ms", type=float, default=5.0)
    parser.add_argument("--max-wait-ms", type=float, default=None)
    parser.add_argument("--device", default="cuda", help="the spawned server's device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    if not args.artifact and not args.addr:
        parser.error("--artifact or --addr required")

    proc = None
    try:
        if args.addr:
            addr = args.addr
        else:
            proc, addr = spawn_server(args.artifact, args.max_batch, args.window_ms, args.max_wait_ms, args.device)
        print(json.dumps(bench(addr, args.n, args.concurrency, args.warmup)), flush=True)
    finally:
        if proc is not None:
            proc.kill()
            proc.wait(timeout=30)
    return 0


if __name__ == "__main__":
    sys.exit(main())
