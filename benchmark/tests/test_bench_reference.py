"""The plain reference against the port at a tiny size on the CPU, on the
same weights made by the benchmark: the networks' forwards in float32, and
the chains through the harness (``tiny.py``)."""

import json

import pytest
import torch

from benchmark import spec, weights
from benchmark.reference.precision import Precision


def reference(name: str, config: dict):
    return spec.load_module(spec.BENCH_DIR / "reference" / f"{name}.py", f"ref_{name}").build(
        config, "cpu", Precision())


def config(name: str) -> dict:
    return json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())


def load(net, ref, part):
    state = weights.make_state_dict(weights.shapes_of(ref), 7, part, "cpu")
    ref.load_state_dict(state)
    net.load_state_dict(state)
    return net.eval()


def test_unet_forward_matches_the_port():
    from image_restoration_sde_tpu_torch.models import ConditionalUNet

    cfg = config("irsde-derain")
    cfg["score_net"].update(setting={"in_nc": 3, "out_nc": 3, "nf": 16, "depth": 3}, compute_dtype="float32")
    ref = reference("irsde-derain", cfg)["score"]
    net = load(ConditionalUNet(**cfg["score_net"]["setting"]), ref, 0)
    x, mu = torch.rand(2, 20, 24, 3), torch.rand(2, 20, 24, 3)
    t = torch.tensor([3, 77])
    with torch.no_grad():
        assert torch.allclose(net(x, mu, t), ref(x, mu, t), rtol=1e-4, atol=1e-4)


def test_nafnet_and_compressor_match_the_port():
    from image_restoration_sde_tpu_torch.models import ConditionalNAFNet, UNet

    cfg = config("refusion-dehaze")
    cfg["score_net"]["setting"].update(width=16, enc_blk_nums=[1, 4], dec_blk_nums=[1, 1])
    cfg["score_net"]["compute_dtype"] = "float32"
    cfg["compressor"]["setting"].update(ch_mult=[1, 2])
    ref = reference("refusion-dehaze", cfg)
    net = load(ConditionalNAFNet(**cfg["score_net"]["setting"]), ref["score"], 0)
    comp = load(UNet(**cfg["compressor"]["setting"]), ref["compressor"], 1)
    img = torch.rand(2, 30, 28, 3)
    with torch.no_grad():
        latent, hs = comp.encode(img)
        r_latent, r_hs = ref["compressor"].encode(img)
        assert torch.allclose(latent, r_latent, rtol=1e-4, atol=1e-4)
        out = comp.decode(latent, hs)[:, :30, :28]
        assert torch.allclose(out, ref["compressor"].decode(r_latent, r_hs, (30, 28)), rtol=1e-4, atol=1e-4)
        t = torch.tensor([5, 90])
        assert torch.allclose(net(latent, latent * 0.5, t), ref["score"](latent, latent * 0.5, t),
                              rtol=1e-4, atol=1e-4)


def test_sde_tables_match_the_port():
    from image_restoration_sde_tpu_torch.sde import IRSDE

    from benchmark.reference.sde import IRSDE as RefSDE

    port = IRSDE.create(max_sigma=50, T=100, schedule="cosine", eps=0.005, device="cpu")
    ref = RefSDE(max_sigma=50, T=100, schedule="cosine", eps=0.005, device="cpu")
    assert torch.equal(port.tables.sigma_bars, ref.sigma_bars)
    assert torch.equal(port.tables.thetas_cumsum, ref.cums)
    assert torch.equal(port.dt, ref.dt)


def test_a_configuration_naming_another_network_has_no_reference():
    cfg = config("irsde-derain")
    cfg["score_net"]["which"] = "ConditionalNAFNet"
    with pytest.raises(ValueError, match="ConditionalNAFNet"):
        reference("irsde-derain", cfg)


@pytest.mark.parametrize("cell", ["derain-sample-rain100h", "dehaze-sample-ntire-hr"])
def test_each_cell_at_a_tiny_size_holds_against_the_reference(tmp_path, cell):
    import tiny

    from benchmark import harness

    line = harness.run(tiny.cell(tmp_path, cell), 2**33 + 5, 0.3, False, "cpu", 0.0)
    assert line["correct"], line["checked"]
    assert line["failed"] == 0 and line["attempted"] > 0
