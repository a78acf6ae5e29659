"""PyTorch port, latent-space training against the JAX package on the CPU:
one compressor step, one latent NAFNet step (a fused 4-block level), one
DiT step (its attention through K4's Function and the streamed backward)
and one bokeh step (lens values, no EMA) against the JAX package's train
steps with the same flax-made weights and injected ``(timesteps, x_t)``;
the bokeh and stereo datasets against the JAX package's; remat in a latent
task; the three latent runners; a resumed compressor run and a resumed
latent run through the train entry point, bit-equal to uninterrupted ones."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_restoration_sde_tpu.data import datasets as jdatasets
from image_restoration_sde_tpu.models.bokeh_nafnet import BokehConditionalNAFNet as FlaxBokeh
from image_restoration_sde_tpu.models.dit import DiT as FlaxDiT
from image_restoration_sde_tpu.models.latent_unet import UNet as FlaxCompressor
from image_restoration_sde_tpu.models.nafnet import ConditionalNAFNet as FlaxNAFNet
from image_restoration_sde_tpu.sde import IRSDE as JaxIRSDE
from image_restoration_sde_tpu.training import create_train_state as jax_create_train_state
from image_restoration_sde_tpu.training import latent as jlatent
from image_restoration_sde_tpu.training import lr_schedules as jlr
from image_restoration_sde_tpu.training import optimizers as jopt
from image_restoration_sde_tpu_torch import runners
from image_restoration_sde_tpu_torch import train as ptrain
from image_restoration_sde_tpu_torch.data import datasets
from image_restoration_sde_tpu_torch.data.bokeh_datasets import lenstr2float
from image_restoration_sde_tpu_torch.data.synthetic import write_bokeh, write_pairs, write_stereo
from image_restoration_sde_tpu_torch.models import BokehConditionalNAFNet, ConditionalNAFNet, DiT, UNet
from image_restoration_sde_tpu_torch.ops import flash_attention as FA
from image_restoration_sde_tpu_torch.ops import naf_stack as pns
from image_restoration_sde_tpu_torch.sde import IRSDE
from image_restoration_sde_tpu_torch.training import checkpoint, lr_schedules, optimizers, trainer
from image_restoration_sde_tpu_torch.training.latent import make_compressor_train_step, make_latent_train_step
from image_restoration_sde_tpu_torch.utils import bokeh_nafnet_flax_keys, dit_flax_keys, latent_unet_flax_keys, \
    nafnet_flax_keys, options, state_dict_from_flax
from test_torch_nafnet import randomize
from test_torch_training import TRAIN_OPT, Injected, _hold, _keep_grads
from test_torch_unet import flatten, unflatten

COMP = dict(in_ch=3, out_ch=3, ch=4, ch_mult=(1, 2), embed_dim=4)
NAF = dict(img_channel=4, width=8, enc_blk_nums=(1, 4), middle_blk_num=1, dec_blk_nums=(1, 1))
BOKEH = dict(img_channel=4, width=8, enc_blk_nums=(1, 2), middle_blk_num=1, dec_blk_nums=(1, 1))
TINY_DIT = dict(hidden_size=128, depth=2, num_heads=2, patch_size=2, in_channels=4)
SDE_ARGS = dict(max_sigma=50.0, T=100, schedule="cosine", eps=0.005)
HW = 16  # image side; the compressor's latent is HW / 2 with ch_mult (1, 2)


@pytest.fixture(scope="module")
def comp_weights():
    fc = FlaxCompressor(**COMP)
    return randomize(flatten(jax.jit(fc.init)(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))), seed=21)


def _compressor(w) -> UNet:
    net = UNet(**COMP)
    net.load_state_dict(state_dict_from_flax(w, keys=latent_unet_flax_keys(len(COMP["ch_mult"]))))
    return net


def _batch(seed):
    r = np.random.default_rng(seed)
    lq = r.random((2, HW, HW, 3), np.float32)
    return lq, np.clip(lq - 0.3 * r.random(lq.shape, np.float32), 0, 1)


def _states(seed):
    """Injected (timesteps, x_t) on the (2, HW/2, HW/2, 4) latents."""
    r = np.random.default_rng(seed)
    t = np.array([3, 71], np.int32).reshape(2, 1, 1, 1)
    xt = r.standard_normal((2, HW // 2, HW // 2, COMP["embed_dim"])).astype(np.float32)
    return (jnp.asarray(t), jnp.asarray(xt)), (torch.from_numpy(t).long(), torch.from_numpy(xt))


def _jax_run(make_step, params, args, metrics=None):
    """(loss, grads, params after one Adam step, EMA after it) of a JAX
    train step ``make_step(tx)`` on ``args``; its metrics into ``metrics``."""
    tx = optax.chain(_keep_grads(), jopt.build_from_options(TRAIN_OPT, jlr.build_lr_schedule(TRAIN_OPT)))
    state, out = jax.jit(make_step(tx))(jax_create_train_state(params, tx), *args)
    if metrics is not None:
        metrics.update({k: float(v) for k, v in out.items()})
    return (float(out["loss"]), flatten(state.opt_state[0]["g"]), flatten(state.params),
            flatten(state.ema.params))


def _port_run(step, net, args, ema=True):
    """The same of the port's train step on ``args``; None for the EMA
    where the state keeps none."""
    state = trainer.create_train_state(net, optimizers.build_from_options(
        TRAIN_OPT, net.parameters(), lr_schedules.build_lr_schedule(TRAIN_OPT)), ema=ema)
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    state, metrics = step(state, *args)
    assert state.step == 1 and state.optimizer.updates == 1 and (state.ema is None) is not ema
    assert any(not torch.equal(before[k], v) for k, v in net.named_parameters())
    grads = {k: v.grad.clone() for k, v in net.named_parameters()}
    return metrics["loss"].item(), grads, dict(net.named_parameters()), None if state.ema is None else state.ema.params


# ---------------------------------------------------------------- train steps
def test_compressor_step_matches_jax(comp_weights):
    """The compressor UNet (ch 4, ch_mult (1, 2)), batch 2 at 16 px, Adam:
    rec + rep + 0.001 reg with population standard deviations; the loss and
    its three parts, the gradients and the updated parameters held with
    ``_hold``'s bounds.  The port keeps no EMA (the JAX step's is never
    saved)."""
    lq, gt = _batch(1)
    fc = FlaxCompressor(**COMP)

    def make(tx):
        step = jlatent.make_compressor_train_step(lambda p, x: fc.apply(p, x, method=fc.encode),
                                                  lambda p, l, h: fc.apply(p, l, h, method=fc.decode), tx)
        return lambda s, a, b: step(s, a, b, None)

    jm = {}
    want = _jax_run(make, unflatten(comp_weights), (jnp.asarray(lq), jnp.asarray(gt)), jm)
    parts = {}

    def step(state, a, b, gen):
        state, m = make_compressor_train_step()(state, a, b, gen)
        parts.update(m)
        return state, m

    got = _port_run(step, _compressor(comp_weights), (torch.from_numpy(lq), torch.from_numpy(gt), None), ema=False)
    _hold(got, want, latent_unet_flax_keys(len(COMP["ch_mult"])))
    for k in ("loss_rec", "loss_rep", "loss_reg"):
        assert abs(parts[k].item() - jm[k]) <= 1e-4 * abs(jm[k]), k


def _latent_pair(comp_weights, seed):
    """(JAX sde, port sde) with injected states, and the batch."""
    (jt, jxt), (pt, pxt) = _states(seed)
    jsde = Injected(JaxIRSDE.create(**SDE_ARGS), jt, jxt)
    psde = Injected(IRSDE.create(**SDE_ARGS, device="cpu"), pt, pxt)
    return jsde, psde, _batch(seed + 1)


def _jax_latent(jsde, apply, comp_weights, params, lq, gt, cond=None, **kw):
    fc = FlaxCompressor(**COMP)

    def make(tx):
        step = jlatent.make_latent_train_step(jsde, apply, lambda p, x: fc.apply(p, x, method=fc.encode),
                                              unflatten(comp_weights), tx, **kw)
        if cond is None:
            return lambda s, a, b: step(s, a, b, jax.random.PRNGKey(0))
        return lambda s, a, b: step(s, a, b, jax.random.PRNGKey(0), cond)

    return _jax_run(make, params, (jnp.asarray(lq), jnp.asarray(gt)))


def test_latent_nafnet_step_matches_jax(comp_weights, monkeypatch):
    """The frozen compressor encodes LQ and GT in one 2B batch; the
    ConditionalNAFNet (width 8, enc (1, 4): its 4-block level fuses on both
    sides, K3's operator here, flax's Pallas kernel in interpret mode
    there) takes one IR-SDE step on the latents with the injected states.
    The compressor's weights do not move and take no gradient."""
    monkeypatch.setenv("IRSDE_NAF_FUSE_INTERPRET", "1")
    fnet = FlaxNAFNet(**NAF)
    z = jnp.zeros((1, HW // 2, HW // 2, NAF["img_channel"]))
    weights = randomize(flatten(jax.jit(fnet.init)(jax.random.PRNGKey(2), z, z, jnp.array([1.0]))), seed=22)
    jsde, psde, (lq, gt) = _latent_pair(comp_weights, 30)
    want = _jax_latent(jsde, fnet.apply, comp_weights, unflatten(weights), lq, gt)
    keys = nafnet_flax_keys(NAF["enc_blk_nums"], NAF["middle_blk_num"], NAF["dec_blk_nums"])
    net = ConditionalNAFNet(**NAF)
    net.load_state_dict(state_dict_from_flax(weights, keys=keys))
    comp = _compressor(comp_weights)
    comp_before = {k: v.clone() for k, v in comp.state_dict().items()}
    calls = []
    orig = pns.OP
    monkeypatch.setattr(pns, "OP", lambda *a: calls.append(1) or orig(*a))
    got = _port_run(make_latent_train_step(psde, comp), net,
                    (torch.from_numpy(lq), torch.from_numpy(gt), torch.Generator().manual_seed(0)))
    assert calls == [1]
    assert all(torch.equal(v, comp_before[k]) for k, v in comp.state_dict().items())
    assert not comp.training and all(p.grad is None and not p.requires_grad for p in comp.parameters())
    _hold(got, want, keys)


def test_dit_step_matches_jax(comp_weights, monkeypatch):
    """A DiT (hidden 128, depth 2, 2 heads of 64) on the 8x8x4 latents (16
    tokens: flax's einsum branch).  Its attention goes through the
    operator ``irsde::flash_mha`` (the plain forward on the CPU; the kernel
    runs only on the card) and so through the streamed backward, in blocks
    of 4 query rows: the gradient reaches ``qkv.weight`` and ``qkv.bias`` through the
    three strided views of the packed product."""
    z = jnp.zeros((1, HW // 2, HW // 2, TINY_DIT["in_channels"]))
    weights = randomize(flatten(jax.jit(FlaxDiT(**TINY_DIT).init)(jax.random.PRNGKey(3), z, z, jnp.array([1.0]))),
                        seed=23)
    jsde, psde, (lq, gt) = _latent_pair(comp_weights, 40)
    want = _jax_latent(jsde, FlaxDiT(**TINY_DIT).apply, comp_weights, unflatten(weights), lq, gt)
    blocks = []
    backward = FA.flash_mha_backward
    monkeypatch.setattr(FA, "flash_mha_backward",
                        lambda *a: blocks.append(a[0].shape) or backward(*a, block=4))
    net = DiT(**TINY_DIT)
    net.load_state_dict(state_dict_from_flax(weights, keys=dit_flax_keys(TINY_DIT["depth"])))
    got = _port_run(make_latent_train_step(psde, _compressor(comp_weights)), net,
                    (torch.from_numpy(lq), torch.from_numpy(gt), torch.Generator().manual_seed(0)))
    assert blocks == [(2, 16, 2, 64)] * TINY_DIT["depth"]
    for i in range(TINY_DIT["depth"]):
        assert got[1][f"blocks.{i}.attn.qkv.weight"].abs().max() > 0
        assert got[1][f"blocks.{i}.attn.qkv.bias"].abs().max() > 0
    _hold(got, want, dit_flax_keys(TINY_DIT["depth"]))


def test_bokeh_step_with_lens_and_no_ema_matches_jax(comp_weights):
    """The bokeh NAFNet (width 8, enc (1, 2)) with per-sample lens values as
    ``cond``; the JAX step with ``ema_enabled=False``, the port's state
    without an EMA."""
    lens = tuple(np.asarray(v, np.float32) for v in ([160.0, 18.0], [28.0, 160.0], [0.3, 0.9]))
    z = jnp.zeros((1, HW // 2, HW // 2, BOKEH["img_channel"]))
    init = jax.jit(lambda k, x: FlaxBokeh(**BOKEH).init(k, x, x, jnp.array([1.0]),
                                                          lens_info=tuple(jnp.zeros((1,)) for _ in range(3))))
    weights = randomize(flatten(init(jax.random.PRNGKey(4), z)), seed=24)
    jsde, psde, (lq, gt) = _latent_pair(comp_weights, 50)
    fb = FlaxBokeh(**BOKEH)
    want = _jax_latent(jsde, lambda p, x, c, t, ln: fb.apply(p, x, c, t, lens_info=ln), comp_weights,
                       unflatten(weights), lq, gt, cond=tuple(jnp.asarray(v) for v in lens), ema_enabled=False)
    keys = bokeh_nafnet_flax_keys(BOKEH["enc_blk_nums"], BOKEH["middle_blk_num"], BOKEH["dec_blk_nums"])
    net = BokehConditionalNAFNet(**BOKEH)
    net.load_state_dict(state_dict_from_flax(weights, keys=keys))
    got = _port_run(make_latent_train_step(psde, _compressor(comp_weights)), net,
                    (torch.from_numpy(lq), torch.from_numpy(gt), torch.Generator().manual_seed(0),
                     tuple(torch.from_numpy(v) for v in lens)), ema=False)
    _hold(got, want, keys)


# ------------------------------------------------------------------ datasets
@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("latent_data"))
    write_bokeh(os.path.join(root, "bokeh"), 4, seed=5, min_size=24, max_size=40)
    write_stereo(os.path.join(root, "stereo"), 4, seed=6, min_size=24, max_size=40)
    return root


def _bokeh_opt(root, mode, phase, **kw):
    b = os.path.join(root, "bokeh")
    opt = {"mode": mode, "phase": phase, "dataroot_LQ": f"{b}/src", "dataroot_alpha": f"{b}/alpha",
           "dataroot_meta": f"{b}/meta.txt", "scale": 1, "data_type": "img", "use_flip": True, "use_rot": True}
    if mode == "BokehLQGT":
        opt["dataroot_GT"] = f"{b}/tgt"
    return {**opt, **kw}


def _stereo_opt(root, mode, phase, **kw):
    s = os.path.join(root, "stereo")
    opt = {"mode": mode, "phase": phase, "dataroot_LQ": f"{s}/LR_x4", "scale": 4, "data_type": "img",
           "use_flip": True, "use_rot": True}
    if mode == "SteLQGT":
        opt["dataroot_GT"] = f"{s}/HR"
    return {**opt, **kw}


@pytest.mark.parametrize("opt_fn,mode,phase,extra", [
    (_bokeh_opt, "BokehLQGT", "train", {"GT_size": 16, "LR_size": 16, "use_swap": True}),
    (_bokeh_opt, "BokehLQGT", "val", {"GT_size": 16, "LR_size": 16}),
    (_bokeh_opt, "BokehLQ", "val", {}),
    (_stereo_opt, "SteLQGT", "train", {"GT_size": 16, "LR_size": 4}),
    (_stereo_opt, "SteLQGT", "val", {}),
    (_stereo_opt, "SteLQ", "val", {}),
], ids=lambda v: v if isinstance(v, str) else None)
def test_bokeh_and_stereo_datasets_equal_jax(folders, opt_fn, mode, phase, extra):
    """The same synthetic files and (seed, epoch): every array and lens
    value bit for bit, over two epochs (the bokeh swap draws differ)."""
    opt = opt_fn(folders, mode, phase, **extra)
    want, got = jdatasets.create_dataset(opt), datasets.create_dataset(opt)
    assert type(want).__name__ == type(got).__name__ and len(want) == len(got) == 4
    for epoch in (1, 2):
        for ds in (want, got):
            ds.set_epoch_seed((3, epoch) if phase == "train" else None)
        for i in range(len(got)):
            a, b = want[i], got[i]
            assert set(a) == set(b)
            for k, v in a.items():
                if isinstance(v, (np.ndarray, np.floating)):
                    assert np.asarray(v).dtype == np.asarray(b[k]).dtype == np.float32 and np.array_equal(v, b[k]), k
                else:
                    assert v == b[k], k
        if extra.get("use_swap"):  # a wide-aperture pair swapped LQ and GT, and its lens values
            swapped = [i for i in range(4) if float(got[i]["src_lens"]) != lenstr2float("Sony50mmf16BS", 10.0)]
            assert swapped and all(got[i]["LQ_path"].endswith(f"tgt/{i:04d}.png") for i in swapped)


# ------------------------------------------------------ runners and driver
def _latent_yaml(root, name, model, niter, network=None, dataset="pairs", resume="null", path_l="null",
                 extra_train=""):
    data = os.path.join(root, "data")
    if not os.path.isdir(data):
        write_pairs(os.path.join(data, "pairs", "train"), 4, seed=0, min_size=20, max_size=28)
        write_pairs(os.path.join(data, "pairs", "val"), 1, seed=1, min_size=16, max_size=24)
        write_bokeh(os.path.join(data, "bokeh", "train"), 4, seed=2, min_size=20, max_size=28)
        write_bokeh(os.path.join(data, "bokeh", "val"), 1, seed=3, min_size=16, max_size=24)
    if dataset == "bokeh":
        def src(p):
            b = f"{data}/bokeh/{p}"
            return (f"mode: BokehLQGT, dataroot_GT: {b}/tgt, dataroot_LQ: {b}/src, dataroot_alpha: {b}/alpha, "
                    f"dataroot_meta: {b}/meta.txt")
    else:
        def src(p):
            return f"mode: LQGT, dataroot_GT: {data}/pairs/{p}/GT, dataroot_LQ: {data}/pairs/{p}/LQ"
    comp = "{which_model: UNet, setting: {in_ch: 3, out_ch: 3, ch: 4, ch_mult: [1, 2], embed_dim: 4}}"
    network = network or ("{which_model: ConditionalNAFNet, setting: {img_channel: 4, width: 8, "
                          "enc_blk_nums: [1, 4], middle_blk_num: 1, dec_blk_nums: [1, 1]}}")
    path = os.path.join(root, f"{name}.yml")
    with open(path, "w") as f:
        f.write(f"""name: {name}
use_tb_logger: false
model: {model}
distortion: dehazing
sde: {{max_sigma: 50, T: 100, schedule: cosine, eps: 0.005, sample_T: 3}}
degradation: {{sigma: 25, noise_type: G, scale: 4}}
datasets:
  train: {{name: train, {src('train')}, n_workers: 2, batch_size: 2, GT_size: 16, LR_size: 16, use_flip: true,
    use_rot: true, color: RGB}}
  val: {{name: val, {src('val')}, max_images: 1}}
network_G: {comp if model == "latent" else network}
network_L: {comp}
path: {{root: {root}/run, pretrain_model_G: null, pretrain_model_L: {path_l}, strict_load: true,
  resume_state: {resume}}}
train: {{optimizer: Lion, lr_G: 0.0001, lr_scheme: TrueCosineAnnealingLR, beta1: 0.9, beta2: 0.99, niter: {niter},
  eta_min: 1.0e-7, loss_type: l1, weight: 1.0, manual_seed: 0, val_freq: 2{extra_train}}}
logger: {{print_freq: 1, save_checkpoint_freq: 2}}
""")
    return path


def _task(root, name, model, **kw):
    opt = options.dict_to_nonedict(options.parse(_latent_yaml(root, name, model, 2, **kw)))
    return runners.build_task(opt, 0, "cpu")


def test_remat_reaches_torch_checkpoint_in_a_latent_task(tmp_path, monkeypatch):
    """``train.remat: true`` in a latent task's YAML wraps its score net in
    ``torch.utils.checkpoint`` (the JAX runners never pass remat to their
    latent tasks); one step's loss and gradients equal those without it bit
    for bit."""
    seen = []
    orig = torch.utils.checkpoint.checkpoint

    def spy(fn, *args, **kw):
        seen.append(fn)
        return orig(fn, *args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    lq, gt = _batch(60)
    out = {}
    for remat in (False, True):
        task = _task(str(tmp_path), f"r{remat}", "latent_denoising", extra_train=f", remat: {str(remat).lower()}")
        _, m = task.step(task.state, {"LQ": lq, "GT": gt}, torch.Generator().manual_seed(1))
        out[remat] = (m["loss"], [p.grad for p in task.net.parameters()])
    assert len(seen) == 1 and isinstance(seen[0], ConditionalNAFNet)
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))


def _run(root, name, model, niter, **kw):
    return ptrain.train(_latent_yaml(root, name, model, niter, **kw), "cpu")


@pytest.mark.parametrize("model", ["latent", "latent_denoising"])
def test_resume_is_bit_equal_on_the_cpu(tmp_path, model):
    """Train 4 steps, saving at 2 and 4; resume from 2 and train to 4: the
    net, the optimizer's moments, the EMA (latent task) and the generator
    end bit-equal.  ``pretrain_model_L`` names a ``.pth``: the compressor
    task's starting weights, which on resume must give way to the resumed
    ``2_G.pth``; the latent task's frozen compressor, loaded on resume
    too."""
    root = str(tmp_path)
    start = os.path.join(root, "start_L.pth")
    checkpoint.save_params(root, _task(root, "init", "latent", path_l="null").net.state_dict(), "start_L")
    if model == "latent":
        init = checkpoint.load_params(start)
        init = {k: v + 0.01 for k, v in init.items()}  # weights unlike the seeded net's
        torch.save(init, start)
    first = _run(root, "run", model, 4, path_l=start)
    exp = os.path.join(root, "run", "experiments", os.path.basename(os.path.dirname(root)), "run")
    want = {k: v.clone() for k, v in first.net.state_dict().items()}
    want_opt = first.optimizer.state_dict()
    want_gen = torch.load(os.path.join(exp, "training_state", "4.state"), weights_only=True)["generator"]
    assert sorted(os.listdir(os.path.join(exp, "models"))) == (
        ["2_G.pth", "4_G.pth"] if model == "latent" else ["2_G.pth", "4_G.pth", "lastest_EMA.pth"])
    resumed = _run(root, "run", model, 4, path_l=start, resume=os.path.join(exp, "training_state", "2.state"))
    assert resumed.step == 4 and resumed.optimizer.updates == 4
    assert all(torch.equal(v, want[k]) for k, v in resumed.net.state_dict().items())
    got_opt = resumed.optimizer.state_dict()["inner"]["state"]
    for i, st in want_opt["inner"]["state"].items():
        assert all(torch.equal(v, got_opt[i][k]) for k, v in st.items())
    if model == "latent_denoising":
        assert resumed.ema.step == 4
        assert all(torch.equal(v, first.ema.params[k]) for k, v in resumed.ema.params.items())
    else:
        assert resumed.ema is None
    got_gen = torch.load(os.path.join(exp, "training_state", "4.state"), weights_only=True)["generator"]
    assert torch.equal(got_gen, want_gen)


def test_two_stage_run_feeds_the_compressor_to_the_latent_task(tmp_path):
    """Stage 1 trains the compressor; stage 2's ``pretrain_model_L`` at its
    ``{iter}_G.pth`` gives the latent task's frozen compressor exactly those
    weights, and stage 2's steps leave them as they are."""
    root = str(tmp_path)
    _run(root, "stage1", "latent", 2)
    pth = os.path.join(root, "run", "experiments", os.path.basename(os.path.dirname(root)), "stage1", "models",
                       "2_G.pth")
    want = checkpoint.load_params(pth)
    opt = options.dict_to_nonedict(options.parse(_latent_yaml(root, "stage2", "latent_denoising", 2, path_l=pth)))
    task = runners.build_task(opt, 0, "cpu")
    task.maybe_load_pretrained(task.state)
    lq, gt = _batch(70)
    task.step(task.state, {"LQ": lq, "GT": gt}, torch.Generator().manual_seed(2))
    assert all(torch.equal(v, want[k]) for k, v in task.compressor.state_dict().items())
    assert not any(p.requires_grad for p in task.compressor.parameters())
