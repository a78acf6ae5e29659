"""PyTorch port, the HTTP server (``serve.py``) and its bench
(``bench_serve.py``) on the CPU, mirroring the JAX package's tests of
``tools/serve.py``: the micro-batcher (fixed-batch padding, power-of-two
buckets, the hard cap, ``max_wait``, failures fanned out to one batch only,
per-sample seeds); ``seed_reproducible`` for each kind of artifact; bad
seeds refused with 400 before they reach a batch, their companions served;
an HTTP round trip with a tiny CPU artifact."""

import threading
import time

import numpy as np
import pytest
import torch

from image_restoration_sde_tpu_torch import bench_serve, exporting, serve
from image_restoration_sde_tpu_torch.data.io_utils import decode_img_bytes
from image_restoration_sde_tpu_torch.models import ConditionalUNet, init_params_
from image_restoration_sde_tpu_torch.sde import IRSDE

HW = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _recording(log):
    def call(xs, seed):
        log.append((np.asarray(xs).shape[0], seed))
        return np.asarray(xs) + 1.0

    return call


def test_micro_batcher_fixed_batch_pads_and_routes():
    """3 concurrent requests against a fixed-batch-4 call ride ONE call,
    padded with a copy of the last row; each caller gets its own row."""
    log = []
    mb = serve.MicroBatcher(_recording(log), fixed=4, window_s=0.25)
    imgs = [np.full((2, 2, 3), i, np.float32) for i in range(3)]
    outs = [f.result(timeout=30) for f in [mb.submit(img, 0) for img in imgs]]
    assert [n for n, _ in log] == [4]
    for img, out in zip(imgs, outs):
        np.testing.assert_array_equal(out, img + 1.0)
    assert mb.stats() == {"batches": 1, "requests": 3, "mean_batch": 3.0}


@pytest.mark.parametrize("max_batch,want", [(8, 8), (6, 6)])
def test_micro_batcher_pow2_buckets_and_hard_cap(max_batch, want):
    """A symbolic batch sees powers of two clamped to the cap: 5 requests
    make one call of 8, or of 6 where the cap is 6."""
    log = []
    mb = serve.MicroBatcher(_recording(log), fixed=None, max_batch=max_batch, window_s=0.25)
    for f in [mb.submit(np.zeros((2, 2, 3), np.float32), 0) for _ in range(5)]:
        f.result(timeout=30)
    assert [n for n, _ in log] == [want]


def test_micro_batcher_max_wait_dispatches_partial_batch():
    """With max_wait set, a request stuck behind a long-running call is
    dispatched as a partial batch at the deadline, not when the device
    frees up."""
    t0 = time.monotonic()
    log = []

    class SlowOut:  # the completer's wait for the device, modelled
        def __init__(self, xs, delay):
            self.xs, self.delay = xs, delay

        def __array__(self, dtype=None, copy=None):
            time.sleep(self.delay)
            return self.xs

    def call(xs, seed):
        log.append((time.monotonic() - t0, xs.shape[0]))
        return SlowOut(xs, 0.8 if len(log) == 1 else 0.0)

    mb = serve.MicroBatcher(call, fixed=None, max_batch=4, window_s=0.01, max_wait_s=0.1)
    f1 = mb.submit(np.zeros((1, 1, 3), np.float32), 0)
    time.sleep(0.05)
    f2 = mb.submit(np.zeros((1, 1, 3), np.float32), 0)
    f1.result(timeout=30)
    f2.result(timeout=30)
    assert len(log) == 2 and log[1][0] - log[0][0] < 0.5 and log[1][1] == 1, log


def test_micro_batcher_fails_one_batch_and_keeps_serving():
    def call(xs, seed):
        if 13 in seed:
            raise RuntimeError("device fell over")
        return np.asarray(xs)

    mb = serve.MicroBatcher(call, fixed=2, window_s=0.25, per_sample_seed=True)
    bad = [mb.submit(np.zeros((1, 1, 3), np.float32), s) for s in (13, 1)]
    for f in bad:
        with pytest.raises(RuntimeError, match="device fell over"):
            f.result(timeout=30)
    assert mb.submit(np.ones((1, 1, 3), np.float32), 2).result(timeout=30).shape == (1, 1, 3)


def test_micro_batcher_per_sample_seeds():
    """Each rider keeps its own seed; pad rows reuse the last rider's.  A
    scalar-seed call takes the first rider's seed."""
    log = []
    mb = serve.MicroBatcher(_recording(log), fixed=4, window_s=0.25, per_sample_seed=True)
    for f in [mb.submit(np.zeros((2, 2, 3), np.float32), 10 + i) for i in range(3)]:
        f.result(timeout=30)
    assert log == [(4, [10, 11, 12, 12])]
    log.clear()
    mb = serve.MicroBatcher(_recording(log), fixed=4, window_s=0.25)
    for f in [mb.submit(np.zeros((2, 2, 3), np.float32), 20 + i) for i in range(2)]:
        f.result(timeout=30)
    assert log == [(4, 20)]


@pytest.mark.parametrize("batch,seed,max_batch,want", [
    (8, "per_sample", 8, True),
    ("symbolic", "per_sample", 8, False),  # the JAX server says True here
    (8, "scalar", 8, False),
    ("symbolic", "scalar", 1, True),
    ("symbolic", "ignored", 8, True),
])
def test_seed_reproducible_follows_the_rule(batch, seed, max_batch, want):
    """True only for per-sample seeds at a fixed batch, one request a call,
    or an artifact that draws no noise."""
    header = {"batch": batch, "seed": seed, "size": [2, 2], "channels": 3}
    assert serve.seed_reproducible(header, max_batch) is want
    _, _, batcher = serve.build_handler(lambda xs, s: xs, header, max_batch=max_batch)
    assert batcher.max_batch == (batch if batch != "symbolic" else max_batch)


@pytest.mark.parametrize("query,ok", [("seed=0", True), ("seed=4294967295", True), ("", True),
                                      ("seed=-1", False), ("seed=4294967296", False), ("seed=1.5", False),
                                      ("seed=abc", False)])
def test_parse_seed_takes_integers_in_uint32_range(query, ok):
    if ok:
        assert 0 <= serve.parse_seed(query) < 2**32
    else:
        with pytest.raises(ValueError):
            serve.parse_seed(query)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """The port's server on a tiny CPU artifact (UNet nf 8, depth 2, one
    posterior step, a fixed batch of 2, per-sample seeds), port 0, in this
    process: (address, batcher)."""
    net = init_params_(ConditionalUNet(in_nc=3, out_nc=3, nf=8, depth=2), torch.Generator().manual_seed(0)).eval()
    sde = IRSDE.create(10.0, 100, "cosine", 0.005, device="cpu")
    path = tmp_path_factory.mktemp("serve") / "m.irsdet"
    path.write_bytes(exporting.export_restoration_sampler(sde, net, (HW, HW), mode="posterior", steps=1, batch=2,
                                                          per_sample_seed=True))
    call, header = exporting.load_artifact(str(path), device="cpu")
    handler, _, batcher = serve.build_handler(call, header, max_batch=2, window_ms=200.0)
    srv = serve.Server(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"127.0.0.1:{srv.server_address[1]}", batcher
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)


def test_http_round_trip(server):
    """/health carries the header and the serving state; two concurrent
    requests share one call; each answer is a PNG of its input's size; the
    same (image, seed) gives the same bytes with another companion at
    another position; an image larger than the artifact gets 400."""
    addr, batcher = server
    health = bench_serve.health(addr)
    assert health["kind"] == "restoration_sampler" and health["serving"]["fixed_batch"] == 2
    assert health["serving"]["seed_reproducible"] is True and "irsde_channel_layernorm" in health["serving"]["launches"]
    pngs = [bench_serve.make_png((HW, HW), 3, seed=i) for i in range(3)]

    def pair(requests):
        out = [None, None]
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, bench_serve.post(addr, *requests[i])))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        return out

    calls = batcher.stats()["batches"]
    a = pair([(pngs[0], 7), (pngs[1], 3)])
    b = pair([(pngs[2], 9), (pngs[0], 7)])
    assert batcher.stats()["batches"] == calls + 2
    for status, body in a + b:
        assert status == 200 and decode_img_bytes(body).shape == (HW, HW, 3)
    assert a[0][1] == b[1][1] and a[0][1] != a[1][1]
    small = bench_serve.make_png((HW - 3, HW - 5), 3, seed=4)
    status, body = bench_serve.post(addr, small, 1)
    assert status == 200 and decode_img_bytes(body).shape == (HW - 3, HW - 5, 3)
    status, _ = bench_serve.post(addr, bench_serve.make_png((HW + 1, HW), 3), 1)
    assert status == 400


def test_bad_seeds_get_400_and_their_companion_is_served(server):
    """Seeds -1 and 2**32 are refused in the handler, before they join a
    batch: their companion alone rides the next call and gets 200."""
    addr, batcher = server
    png = bench_serve.make_png((HW, HW), 3)
    before = batcher.stats()["requests"]
    out = [None] * 3
    threads = [threading.Thread(target=lambda i=i, s=s: out.__setitem__(i, bench_serve.post(addr, png, s)))
               for i, s in enumerate((-1, 2**32, 5))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert [status for status, _ in out] == [400, 400, 200]
    assert batcher.stats()["requests"] == before + 1


def test_bench_serve_reports_rate_latency_and_device_batch(server):
    addr, _ = server
    result = bench_serve.bench(addr, n=4, concurrency=2, warmup=0)
    assert result["requests_per_s"] > 0 and result["device_calls"] >= 2
    assert set(result["latency_ms"]) == {"p50", "p90", "p99"}
    assert 1 <= result["mean_device_batch"] <= 2


def test_a_failed_device_call_is_a_500_not_a_400():
    """A ``ValueError`` raised by the batch's device call (a shape check of
    the loaded sampler, say) is the server's fault: its rider gets 500,
    while a bad seed of the same kind of request still gets 400."""
    def call(xs, seeds):
        raise ValueError(f"{len(seeds) + 1} seeds for a batch of {len(seeds)}")

    header = {"batch": 2, "seed": "per_sample", "size": [HW, HW], "channels": 3}
    handler, _, _ = serve.build_handler(call, header, max_batch=2, window_ms=1.0)
    srv = serve.Server(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        addr = f"127.0.0.1:{srv.server_address[1]}"
        png = bench_serve.make_png((HW, HW), 3)
        status, body = bench_serve.post(addr, png, 1)
        assert status == 500 and b"BatchError: ValueError: 3 seeds for a batch of 2" in body
        assert bench_serve.post(addr, png, -1)[0] == 400
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
