"""PyTorch port, serving artifacts (``exporting.py`` and the export entry
point) on the CPU: the file layout; the header without loading a program,
its shared keys against the JAX package's artifact of the same tiny model
with the weights carried across; the loaded chain against the port's eager
samplers with the same generators (bit for bit), and with injected noise
against the JAX sampler; a symbolic batch; per-sample seeds; the latent,
bokeh (lens values baked in) and denoising artifacts, the last exported
plain; the CLI's ``--check`` and ``--inspect``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu import exporting as jexporting
from image_restoration_sde_tpu.models import ConditionalUNet as FlaxUNet
from image_restoration_sde_tpu.sde import IRSDE as JIRSDE
from image_restoration_sde_tpu.sde import samplers as jsamplers
from image_restoration_sde_tpu.utils.torch_import import apply_rules, unet_key_rules
from image_restoration_sde_tpu_torch import export_model, exporting, sampling
from image_restoration_sde_tpu_torch.models import BokehConditionalNAFNet, ConditionalNAFNet, ConditionalUNet, UNet, \
    init_params_
from image_restoration_sde_tpu_torch.sde import DenoisingSDE, IRSDE, rng
from image_restoration_sde_tpu_torch.training import make_latent_sampler
from test_torch_unet import TINY

SDE_ARGS = dict(max_sigma=10.0, T=100, schedule="cosine", eps=0.005)
STEPS, HW = 3, 16
COMP = dict(in_ch=3, out_ch=3, ch=4, ch_mult=(1, 2), embed_dim=4)
NAF = dict(img_channel=4, width=8, enc_blk_nums=(1, 4), middle_blk_num=1, dec_blk_nums=(1, 1))
BOKEH = dict(img_channel=4, width=8, enc_blk_nums=(1, 2), middle_blk_num=1, dec_blk_nums=(1, 1))
# the JAX header keys an artifact of the port carries with the same meaning
SHARED_KEYS = ("kind", "mode", "steps", "size", "channels", "batch", "seed", "n_params", "config", "model_type")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seeded(net, seed):
    """``net`` in eval mode with seeded weights of variance 1/fan_in, gains 1
    and biases 0 (``init_params_``): the NAFBlocks' residual scales, zeros
    at torch's initialisation, too."""
    return init_params_(net, torch.Generator().manual_seed(seed)).eval()


@pytest.fixture(scope="module")
def unet():
    """The tiny ConditionalUNet with seeded weights, carried to flax by the
    JAX package's torch importer: (port net, flax net, flax params)."""
    net = _seeded(ConditionalUNet(**TINY), 3)
    fnet = FlaxUNet(**TINY)
    x = jnp.zeros((1, HW, HW, 3))
    shapes = jax.eval_shape(fnet.init, jax.random.PRNGKey(0), x, x, jnp.array([1.0]))
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    return net, fnet, apply_rules(shapes, state, unet_key_rules(TINY["depth"]))


@pytest.fixture(scope="module")
def sde():
    return IRSDE.create(**SDE_ARGS, device="cpu")


@pytest.fixture(scope="module")
def derain(unet, sde):
    """A per-sample-seed artifact of the tiny net at a fixed batch of 2 and
    one at a symbolic batch: {batch: bytes}."""
    meta = {"config": "tiny", "model_type": "denoising"}
    return {b: exporting.export_restoration_sampler(sde, unet[0], (HW, HW), mode="posterior", steps=STEPS,
                                                    batch=b, per_sample_seed=True, meta=meta)
            for b in (2, None)}


def _lq(b, seed=0):
    return torch.rand(b, HW, HW, 3, generator=rng.generator(seed, "cpu"))


def test_artifact_layout_round_trip(tmp_path):
    header = {"kind": "x", "steps": 4}
    data = exporting.pack_artifact(header, b"payload-bytes")
    assert data.startswith(b"IRSDET1\n")
    assert exporting.unpack_artifact(data) == (header, b"payload-bytes")
    with pytest.raises(ValueError, match="bad magic"):
        exporting.unpack_artifact(b"NOTMAGIC" + data)
    # the JAX package's file and the port's are not mistaken for each other
    with pytest.raises(ValueError, match="bad magic"):
        exporting.unpack_artifact(jexporting.pack_artifact(header, b""))
    with pytest.raises(ValueError, match="bad magic"):
        jexporting.unpack_artifact(data)
    path = tmp_path / "a.irsdet"
    path.write_bytes(data)
    assert exporting.read_header(str(path)) == header


def test_read_header_loads_no_program(derain, tmp_path, monkeypatch):
    path = tmp_path / "m.irsdet"
    path.write_bytes(derain[2])

    def refuse(*a, **k):
        raise AssertionError("read_header loaded a program")

    monkeypatch.setattr(torch.export, "load", refuse)
    header = exporting.read_header(str(path))
    assert header["format"] == "torch.export" and header["program"] == "step"
    assert set(header["programs"]) == {"step"} and header["devices"] == ["cpu", "cuda"]
    assert header["custom_ops"] == ["irsde::channel_layernorm", "irsde::linear_attention_packed"]
    assert header["torch_version"] == torch.__version__
    assert header["specs"]["step"]["inputs"][0] == {"shape": [2, HW, HW, 3], "dtype": "float32"}


def test_header_shared_keys_equal_the_jax_artifact(unet, derain):
    """The same tiny model, its flax weights carried across: every key the
    two headers share with one meaning is equal, ``n_params`` included (so
    every weight was carried)."""
    _, fnet, params = unet
    jdata = jexporting.export_restoration_sampler(
        JIRSDE.create(**SDE_ARGS), fnet.apply, params, (HW, HW), mode="posterior", steps=STEPS, batch=2,
        platforms=("cpu",), per_sample_seed=True, meta={"config": "tiny", "model_type": "denoising"})
    jheader = jexporting.unpack_artifact(jdata)[0]
    header = exporting.unpack_artifact(derain[2])[0]
    assert {k: header[k] for k in SHARED_KEYS} == {k: jheader[k] for k in SHARED_KEYS}


@pytest.mark.parametrize("batch", [2, None], ids=["fixed", "symbolic"])
def test_loaded_call_is_the_eager_sampler(unet, sde, derain, batch):
    """The loaded artifact against ``make_restoration_sampler`` with the same
    per-sample generators, bit for bit, at its batch (symbolic: 1, 2 and
    3); a wrong batch or size raises."""
    call, header = exporting.load_artifact(derain[batch], device="cpu")
    eager = sampling.make_restoration_sampler(sde, unet[0], mode="posterior", steps=STEPS)
    for b in (2,) if batch else (1, 2, 3):
        lq, seeds = _lq(b, seed=b), [11 * i + 1 for i in range(b)]
        got = call(lq, seeds)
        assert got.shape == lq.shape and torch.isfinite(got).all()
        assert torch.equal(got, eager(lq, rng.generators_for_seeds(seeds, "cpu")))
    if batch:
        with pytest.raises(ValueError, match="batch of 2"):
            call(_lq(3), [1, 2, 3])
    with pytest.raises(ValueError, match="lq must be"):
        call(torch.rand(2, HW, HW + 1, 3), [1, 2])


def test_per_sample_rows_depend_only_on_their_seed(derain):
    """Row i of a per-sample-seed call is a function of (lq[i], seeds[i])
    alone: the same row and seed at another position, with another
    companion, gives the same values; another seed changes it."""
    call, _ = exporting.load_artifact(derain[2], device="cpu")
    a, b = _lq(2, seed=5), _lq(2, seed=6)
    first = call(a, [7, 3])
    other = call(torch.stack([b[0], a[0]]), [9, 7])
    assert torch.equal(first[0], other[1])
    assert not torch.equal(first[0], call(a, [8, 3])[0])


def test_loaded_chain_with_injected_noise_matches_jax(unet, derain):
    """The loaded chain on given noise (the initial state's, then each
    step's) against the JAX reverse posterior sampler with the same weights
    and ``noise_seq``, float32.  Bound 1e-4 of max|ref|, as
    test_torch_sampling's chain through the same tiny net."""
    _, fnet, params = unet
    call, _ = exporting.load_artifact(derain[None], device="cpu")
    r = np.random.default_rng(4)
    lq = r.random((2, HW, HW, 3), np.float32)
    noise = r.standard_normal((1 + STEPS, 2, HW, HW, 3)).astype(np.float32)
    ref = JIRSDE.create(**SDE_ARGS)
    noisy = jnp.asarray(lq) + jnp.asarray(noise[0]) * ref.max_sigma
    want = np.asarray(jax.jit(lambda xt, mu, ns: jsamplers.reverse_posterior(
        ref, lambda x, m, t: fnet.apply(params, x, m, t), xt, mu, steps=STEPS, noise_seq=ns))(
        noisy, jnp.asarray(lq), jnp.asarray(noise[1:])))
    got = call.with_noise(lq, noise).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_latent_artifact_is_the_eager_sampler():
    """Compressor (ch 4, ch_mult (1, 2)) and ConditionalNAFNet (width 8, its
    4-block level through the K3 operator), sde mode, a scalar seed: the
    loaded call equals ``make_latent_sampler`` with the same generator, bit
    for bit, at a symbolic batch of 1 and 2."""
    comp = _seeded(UNet(**COMP), 1)
    net = _seeded(ConditionalNAFNet(**NAF), 2)
    sde = IRSDE.create(50.0, 100, "cosine", 0.005, device="cpu")
    data = exporting.export_latent_sampler(sde, net, comp, (HW, HW), mode="sde", steps=STEPS)
    call, header = exporting.load_artifact(data, device="cpu")
    assert set(header["programs"]) == {"encode", "step", "decode"} and "irsde::naf_stack" in header["custom_ops"]
    assert header["n_params"] == sum(p.numel() for m in (net, comp) for p in m.parameters())
    eager = make_latent_sampler(sde, net, comp, mode="sde", steps=STEPS)
    for b in (1, 2):
        lq = _lq(b, seed=20 + b)
        assert torch.equal(call(lq, 5), eager(lq, rng.generator(5, "cpu")))


def test_bokeh_artifact_bakes_the_lens_values():
    """The bokeh NAFNet with lens values (src, tgt, disparity) baked in as
    per-sample constants: the loaded call equals the eager latent sampler
    given the same values as ``cond``, bit for bit; other values differ."""
    comp = _seeded(UNet(**COMP), 3)
    net = _seeded(BokehConditionalNAFNet(**BOKEH), 4)
    sde = IRSDE.create(50.0, 100, "cosine", 0.005, device="cpu")
    lens = (18.0, 160.0, 35.0)
    data = exporting.export_latent_sampler(sde, net, comp, (HW, HW), mode="posterior", steps=STEPS, batch=2,
                                           cond=lens)
    call, header = exporting.load_artifact(data, device="cpu")
    assert header["cond"] == list(lens)
    eager = make_latent_sampler(sde, net, comp, mode="posterior", steps=STEPS)
    lq = _lq(2, seed=30)
    got = call(lq, 6)
    cond = tuple(torch.full((2,), v) for v in lens)
    assert torch.equal(got, eager(lq, rng.generator(6, "cpu"), cond))
    other = tuple(torch.full((2,), v) for v in (18.0, 100.0, 35.0))
    assert not torch.equal(got, eager(lq, rng.generator(6, "cpu"), other))


def test_plain_denoising_artifact_has_no_kernel_operator():
    """The unconditional UNet under the denoising SDE (sigma 10: the reverse
    ODE from its optimal timestep, 11 steps), exported with ``kernels=False``: the
    program holds no ``irsde::`` operator (the net's plain version, torch's
    operators only), and the loaded call equals ``make_denoising_sampler``'s
    bit for bit, whatever the seed."""
    net = _seeded(ConditionalUNet(**TINY, conditional=False), 5)
    sde = DenoisingSDE.create(70, 100, "cosine", device="cpu")
    data = exporting.export_denoising_sampler(sde, net, (HW, HW), 10.0, batch=None, kernels=False)
    call, header = exporting.load_artifact(data, device="cpu")
    assert header["custom_ops"] == [] and header["kernels"] is False
    assert "irsde" not in str(call.programs["step"].graph)
    eager = sampling.make_denoising_sampler(sde, net, 10.0)
    assert header["seed"] == "ignored" and header["steps"] == eager.t0 == 11 and header["sigma"] == 10.0
    noisy = _lq(2, seed=40)
    assert torch.equal(call(noisy, 1), eager(noisy)) and torch.equal(call(noisy, 2), call(noisy, 1))


def test_load_defaults_to_the_card(derain):
    """Without a card, loading on the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exporting.load_artifact(derain[2])


def test_export_entry_point_check_and_inspect(tmp_path, capsys):
    """The export entry point (``python -m
    image_restoration_sde_tpu_torch.export_model``) on a tiny deraining
    YAML: bf16, a fixed batch, per-sample seeds and ``--check`` on the CPU,
    then ``--inspect`` prints the header."""
    yml = tmp_path / "tiny.yml"
    yml.write_text(f"""name: tiny
model: denoising
distortion: derain
sde: {{max_sigma: 10, T: 100, schedule: cosine, eps: 0.005, sample_T: {STEPS}, sampling_mode: posterior}}
degradation: {{sigma: 25, noise_type: G, scale: 4}}
datasets: {{}}
network_G: {{which_model_G: ConditionalUNet, setting: {{in_nc: 3, out_nc: 3, nf: 8, depth: 2}}}}
path: {{root: {tmp_path}, pretrain_model_G: null}}
""")
    out = str(tmp_path / "m.irsdet")
    assert export_model.main([f"-opt={yml}", "--out", out, "--size", str(HW), "--batch", "2", "--bf16",
                              "--per-sample-seed", "--check", "--device", "cpu"]) == 0
    assert "check OK: (2, 16, 16, 3), 0 of max|live| from the live sampler (bit-equal)" in capsys.readouterr().out
    assert export_model.main(["--inspect", out]) == 0
    header = json.loads(capsys.readouterr().out)
    assert (header["config"], header["batch"], header["seed"], header["steps"]) == ("tiny", 2, "per_sample", STEPS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model.main([f"-opt={yml}", "--out", out])
