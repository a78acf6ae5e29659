"""PyTorch port, the main path's bench (``bench_cuda.py``) on the CPU: its
metric line at a tiny size, and the bench's own net (ConditionalUNet nf 64,
depth 4, float32) over the bench's whole chain, 100 reverse-SDE steps on
the cosine T = 100 schedule, against the JAX package's flax net and scan
sampler with the same weights and the same injected noise, at 1x32x32: at
16 px the deepest level's maps are 2x2, where XLA's CPU convolutions take
~20 ms each (a 512-channel 3x3) and a flax forward 1.0 s, against 0.085 s
at 32 px."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.models import ConditionalUNet as FlaxUNet
from image_restoration_sde_tpu.sde import IRSDE as JIRSDE
from image_restoration_sde_tpu.sde import samplers as jsamplers
from image_restoration_sde_tpu.utils.torch_import import apply_rules, unet_key_rules
from image_restoration_sde_tpu_torch.models import ConditionalUNet, init_params_
from image_restoration_sde_tpu_torch.sde import IRSDE, rng, samplers

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import bench_cuda  # noqa: E402

# bench.py's configuration: the net, the SDE and its sampling mode
BENCH_NET = dict(in_nc=3, out_nc=3, nf=64, depth=4)
BENCH_SDE = dict(max_sigma=10.0, T=100, schedule="cosine", eps=0.005)
CHAIN_HW = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bench_prints_the_metric_line_on_the_cpu(monkeypatch, capsys):
    """``main(device="cpu")`` at BENCH_STEPS=2, BENCH_SIZE=16, BENCH_BATCH=1:
    one JSON line with bench.py's keys, unit img/s/GPU and the device."""
    for k, v in {"BENCH_STEPS": "2", "BENCH_SIZE": "16", "BENCH_BATCH": "1", "BENCH_REPS": "2"}.items():
        monkeypatch.setenv(k, v)
    line = bench_cuda.main(device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "baseline_kind", "device"}
    assert line["unit"] == "img/s/GPU" and line["device"] == "cpu" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / bench_cuda.BASELINE_IMGS_PER_SEC, 4)
    assert "2-step reverse SDE, 16px" in line["metric"]


def test_bench_chain_matches_jax():
    """The bench's net (nf 64, depth 4, its seeded weights, float32) over all
    100 reverse-SDE steps at 1x32x32: noisy = lq + max_sigma * z0 and the
    same noise sequence on both sides, the weights carried to flax by the
    JAX package's torch importer (the tree's shapes from ``eval_shape``: no
    flax initialisation runs).  Bound 1e-4 of max|ref|,
    test_torch_sampling's bound for the chain: the nets' float32 rounding
    differences (1e-6 of their output) pass through steps whose
    coefficients stay O(1), and the mean-reverting chain does not amplify
    them."""
    net = init_params_(ConditionalUNet(**BENCH_NET), rng.generator(bench_cuda.SEED, "cpu")).eval()
    # one thread streams the 550 MB of weights a forward reads at ~2 GB/s:
    # keep the 4-D weights in the activations' channels_last memory (the
    # CPU convolution otherwise copies each to that layout at every call),
    # and convolve with torch's native kernels, which read them in place
    # (oneDNN reorders each weight at every call).  0.26 s a forward
    # against 0.87 s.
    net.to(memory_format=torch.channels_last)
    fnet = FlaxUNet(**BENCH_NET)
    x = jnp.zeros((1, CHAIN_HW, CHAIN_HW, 3))
    shapes = jax.eval_shape(fnet.init, jax.random.PRNGKey(0), x, x, jnp.array([1.0]))
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    params = apply_rules(shapes, state, unet_key_rules(BENCH_NET["depth"]))
    port, ref = IRSDE.create(**BENCH_SDE, device="cpu"), JIRSDE.create(**BENCH_SDE)
    r = np.random.default_rng(9)
    lq = r.random((1, CHAIN_HW, CHAIN_HW, 3), np.float32)
    noisy = (lq + np.float32(port.max_sigma) * r.standard_normal(lq.shape)).astype(np.float32)
    noise_seq = r.standard_normal((BENCH_SDE["T"], *lq.shape)).astype(np.float32)
    # the weights go in as arguments: as constants, XLA folds them for 13 s
    want = np.asarray(jax.jit(lambda p, xt, mu, ns: jsamplers.reverse_sde(
        ref, lambda x, m, t: fnet.apply(p, x, m, t), xt, mu, noise_seq=ns))(params, noisy, lq, noise_seq))
    mkldnn, torch.backends.mkldnn.enabled = torch.backends.mkldnn.enabled, False
    try:
        with torch.inference_mode():
            got = samplers.reverse_sde(port, net, torch.from_numpy(noisy), torch.from_numpy(lq),
                                       noise_seq=torch.from_numpy(noise_seq)).numpy()
    finally:
        torch.backends.mkldnn.enabled = mkldnn
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
