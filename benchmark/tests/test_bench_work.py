"""The kernels' work files against the bounds of PERF.md's kernel table, at
the table's shapes: K1 over one deraining forward's 18 sites, K2a and K2b
over its 9, all bf16; K3 at (4, 8 x 8 x 512, 28 blocks), whose table bound
of 0.341 ms priced its 1x1 products at the float32 rate, here at the bf16
tensor cores' rate, which leaves it bound by its weights' bytes."""

import json

import pytest
import torch

from benchmark import peaks, spec
from benchmark.reference.precision import Precision

H100 = peaks.H100_SXM


def least_ms(work, sites) -> float:
    return 1e3 * sum(peaks.least_seconds(*work.work(site), H100) for site in sites)


def deraining_forward_sites() -> list:
    """The reference's kernel sites of one UNet forward on 8 x 128 px."""
    config = json.loads((spec.BENCH_DIR / "configs" / "irsde-derain.json").read_text())
    ref = spec.load_module(spec.BENCH_DIR / "reference" / "irsde-derain.py", "ref_derain")
    with torch.device("meta"):
        net = ref.build(config, "meta", Precision())["score"]
    net.ctx.sites = []
    x = torch.zeros((8, 128, 128, 3), device="meta")
    with torch.no_grad():
        net(x, x, torch.zeros(8, device="meta"))
    return net.ctx.sites


def kernel(name):
    return spec.load_module(spec.BENCH_DIR / "work" / f"{name}.py", f"work_{name}")


def test_k1_over_one_deraining_forward():
    sites = [s for s in deraining_forward_sites() if s[0] == "k1"]
    assert len(sites) == 18
    assert least_ms(kernel("k1"), sites) == pytest.approx(0.118, abs=0.0005)


def test_k2_over_one_deraining_forward():
    sites = [s for s in deraining_forward_sites() if s[0] == "k2"]
    assert len(sites) == 9
    # K2a and K2b each 0.054 ms: bound by bytes, half the traffic each
    assert least_ms(kernel("k2"), sites) == pytest.approx(2 * 0.054, abs=0.001)


def test_k3_at_the_latent_sites_shape():
    site = ("k3", 4, 8, 8, 512, 28, 2)
    assert least_ms(kernel("k3"), [site]) == pytest.approx(0.0623, abs=0.0001)
    nbytes, ops = kernel("k3").work(site)
    (products, peak), (elementwise, rest) = ops
    assert (peak, rest) == ("bfloat16", "float32")
    assert products / H100[peak] + elementwise / H100[rest] < nbytes / H100["hbm_bytes_per_s"]  # bound by bytes
    # priced as the kernel table priced it, all at the float32 rate
    assert 1e3 * (products + elementwise) / H100["float32"] == pytest.approx(0.341, abs=0.0005)


def test_k3_at_the_whole_hr_images_latent_is_bound_by_its_products():
    site = ("k3", 1, 32, 47, 512, 28, 2)
    nbytes, ops = kernel("k3").work(site)
    assert sum(n / H100[k] for n, k in ops) > nbytes / H100["hbm_bytes_per_s"]
    assert least_ms(kernel("k3"), [site]) == pytest.approx(0.1552, abs=0.0001)


def test_float32_products_take_tf32s_rate():
    _, ops = kernel("k3").work(("k3", 4, 16, 16, 512, 28, 4))
    assert [k for _, k in ops] == ["tf32", "float32"]


def test_the_work_of_a_latent_step_has_one_k3_and_its_blocks_norms_inside():
    config = json.loads((spec.BENCH_DIR / "configs" / "refusion-dehaze.json").read_text())

    ref = spec.load_module(spec.BENCH_DIR / "reference" / "refusion-dehaze.py", "ref_dehaze")
    with torch.device("meta"):
        net = ref.build(config, "meta", Precision())["score"]
    net.ctx.sites = []
    x = torch.zeros((1, 128, 128, 8), device="meta")
    with torch.no_grad():
        net(x, x, torch.zeros(1, device="meta"))
    kinds = [s[0] for s in net.ctx.sites]
    assert kinds.count("k3") == 1 and kinds.count("k1") == 16 and "k2" not in kinds
    assert ("k3", 1, 16, 16, 512, 28, 2) in net.ctx.sites
