"""PyTorch port, tensor parallelism of the NAFNet family and the compressor
on the CPU (gloo ranks): each net's tp2 train step (through its task
runner, Lion) against the one-process step; the tiny NAFNet's tp2 step
against the JAX package's step on a CPU mesh under
``shape_based_tp_sharding``; ``CNAFNetLocal`` split, fused on one map and
block by block on another; the NAFNet's checkpoints from tp2 to one
process and back; the full-width plans on the meta device; a width the
model axis does not divide.  One spawn of ranks, one torch thread."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_tp_ranks as ranks
from image_restoration_sde_tpu.models.nafnet import ConditionalNAFNet as FlaxNAFNet
from image_restoration_sde_tpu.parallel import make_mesh as jax_make_mesh
from image_restoration_sde_tpu.parallel.mesh import batch_sharding, shape_based_tp_sharding, shard_tree
from image_restoration_sde_tpu.sde import IRSDE as JaxIRSDE
from image_restoration_sde_tpu.training import create_train_state as jax_create_train_state
from image_restoration_sde_tpu.training import lr_schedules as jlr
from image_restoration_sde_tpu.training import optimizers as jopt
from image_restoration_sde_tpu.training import trainer as jtrainer
from image_restoration_sde_tpu_torch import dryrun, runners
from image_restoration_sde_tpu_torch.models import ConditionalNAFNet, UNet, init_params_
from image_restoration_sde_tpu_torch.models.bokeh_nafnet import BokehConditionalNAFNet
from image_restoration_sde_tpu_torch.models.stereo_nafnet import StereoConditionalNAFNet
from image_restoration_sde_tpu_torch.parallel import dist
from image_restoration_sde_tpu_torch.parallel.mesh import Mesh
from image_restoration_sde_tpu_torch.parallel.tensor import plan_of, split_share
from image_restoration_sde_tpu_torch.training import checkpoint
from image_restoration_sde_tpu_torch.training.trainer import tensor_parallel
from image_restoration_sde_tpu_torch.utils import nafnet_flax_keys, state_dict_from_flax
from test_torch_nafnet import randomize
from test_torch_tensor_parallel import _fresh_state
from test_torch_training import Injected, _keep_grads, _rel
from test_torch_unet import flatten, unflatten

LR = ranks.LION["lr_G"]
# as tests/test_torch_tensor_parallel.py: the loss within LOSS_REL of
# itself, each gradient within GRAD_REL of its max|grad| (float32 partial
# convolutions summed in another order), parameters and EMA within 2 lr
# (Lion moves each by lr, either way where a near-zero gradient's sign
# differs)
LOSS_REL, GRAD_REL = 1e-6, dryrun.GRAD_REL
BATCH = 4
NAF_DIMS = (ranks.NAF["enc_blk_nums"], ranks.NAF["middle_blk_num"], ranks.NAF["dec_blk_nums"])
FUSED = "encoders.2"  # the tiny NAFNet's 4-block level, 64 channels


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


def _hold_step(got, want, loss_rel=LOSS_REL):
    assert abs(got["loss"] - want["loss"]) <= loss_rel * abs(want["loss"])
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, g in got["grads"].items():
        assert g.shape == want["grads"][k].shape and _rel(g.numpy(), want["grads"][k].numpy()) <= GRAD_REL, k
    for part in ("params", "ema"):
        assert sorted(got[part]) == sorted(want[part])
        for k, v in got[part].items():
            assert (v - want[part][k]).abs().max().item() <= 2 * LR, (part, k)


def _flax_naf_weights() -> dict:
    """The tiny flax NAFNet's parameters, seeded (``randomize``: biases,
    beta and gamma off zero, so every parameter shows in the output)."""
    x = jnp.zeros((1, 16, 16, 3))
    shapes = jax.eval_shape(FlaxNAFNet(**ranks.NAF).init, jax.random.PRNGKey(0), x, x, jnp.array([1.0]))
    return randomize(flatten(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)), seed=12)


def _seeded(kind) -> dict:
    task = runners.build_task(ranks.family_opt(kind), ranks.SEED, "cpu")
    return {k: v.clone() for k, v in init_params_(task.net, torch.Generator().manual_seed(13)).state_dict().items()}


def _batches(kind, n) -> list:
    r = np.random.default_rng(ranks.FAMILY.index(kind) + 1)

    def img(hw, c):
        return r.random((BATCH, hw, hw, c), np.float32)

    out = []
    for _ in range(n):
        if kind == "stereo":  # SR x2 on the 6-channel L|R pair; SCAM sees 2 columns at the middle level
            batch = {"LQ": img(32, 6), "GT": img(64, 6)}
        elif kind == "latent":  # 32 px latents: the 4-block level on an 8x8 map
            batch = {"LQ": img(64, 3), "GT": img(64, 3)}
        elif kind == "bokeh":
            batch = {"LQ": img(32, 3), "GT": img(32, 3)}
            batch.update({k: r.uniform(-2, 2, BATCH).astype(np.float32)
                          for k in ("src_lens", "tgt_lens", "disparity")})
        else:
            batch = {"LQ": img(16, 3), "GT": img(16, 3)}
        out.append(batch)
    return out


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """The one-process side and two gloo ranks' (one spawn): each net's
    step, the TLSC forwards, the NAFNet's checkpoint round trips."""
    root = str(tmp_path_factory.mktemp("family"))
    flax_weights = _flax_naf_weights()
    nafnet = state_dict_from_flax(flax_weights, keys=nafnet_flax_keys(*NAF_DIMS))
    weights = {"nafnet": nafnet, "stereo": _seeded("stereo"), "bokeh": _seeded("bokeh"),
               "compressor": _seeded("compressor"), "latent": _seeded("latent"), "tlsc": nafnet}
    batches = {kind: _batches(kind, 2 if kind == "nafnet" else 1) for kind in ranks.FAMILY}
    one = ranks.family_save_then_step(root, "one", nafnet, batches["nafnet"])
    got = dist.spawn(ranks.family_ranks, 2, root, weights, batches, device="cpu")
    want = {kind: ranks.family_one_step(kind, weights[kind], batches[kind][0]) for kind in ranks.FAMILY}
    return {"root": root, "one": one, "got": got, "want": want, "weights": weights, "batches": batches,
            "flax": flax_weights}


@pytest.mark.parametrize("kind", ranks.FAMILY)
def test_nets_without_a_plan_refuse_tensor_parallelism(family, kind):
    """Each net of the NAFNet family and the compressor trains split over
    two gloo ranks (``runners.build_task`` with a model axis of 2, one
    step of a global batch of 4, Lion) and matches the one-process step
    (``_hold_step``); the ranks agree exactly.  The NAFNet's fused level
    runs its plain K3 once a step on each rank on whole weights, gathered
    from its split tensors (the latent task's on an 8x8 map, its frozen
    compressor whole); the convolutions from 64 channels are split."""
    got, want = family["got"], family["want"][kind]
    for r, out in enumerate(got):
        assert out[kind]["loss"] == got[0][kind]["loss"], r
        assert all(torch.equal(v, got[0][kind]["grads"][k]) for k, v in out[kind]["grads"].items()), r
    mine = got[0][kind]
    assert mine["split"] and not want["split"]
    _hold_step(mine, want)
    if kind in ("nafnet", "latent"):
        assert f"{FUSED}.0.conv1.weight" in mine["split"] and f"{FUSED}.3.mlp.1.bias" in mine["split"]
        assert not any(k.endswith(("conv2.weight", ".g", "beta", "gamma")) or k.startswith("intro")
                       for k in mine["split"])
        hw = 4 if kind == "nafnet" else 8
        assert mine["fused"] == want["fused"] == [((BATCH, hw, hw, 64), [(128, 64, 1, 1)] * 4)]


def test_nafnet_tp2_step_matches_the_jax_step(family):
    """The tiny NAFNet's tp2 step (rank 0, gradients assembled) against the
    JAX package's train step on two of its virtual CPU devices as data 1 x
    model 2, the port's layout (``shape_based_tp_sharding``,
    ``shard_tree``), with the same flax-made weights
    (``state_dict_from_flax``), batch and draws (the port's, injected
    through ``Injected``), Lion on both sides.  Bounds of the dp2 x tp2
    UNet test: the loss within 1e-4 of itself, gradients within GRAD_REL of
    max|grad|, parameters and EMA within 2 lr."""
    batch = family["batches"]["nafnet"][0]
    lq, gt = (torch.from_numpy(batch[k]) for k in ("LQ", "GT"))
    task = runners.build_task(ranks.family_opt("nafnet"), ranks.SEED, "cpu")
    t, xt = task.sde.generate_random_states(torch.Generator().manual_seed(ranks.SEED), gt, lq)
    sde = ranks.SDE
    jsde = Injected(JaxIRSDE.create(max_sigma=sde["max_sigma"], T=sde["T"], schedule=sde["schedule"],
                                    eps=sde["eps"]), jnp.asarray(t.numpy().astype(np.int32)), jnp.asarray(xt.numpy()))
    mesh = jax_make_mesh(jax.devices()[:2], model_parallel=2)
    tx = optax.chain(_keep_grads(), jopt.build_from_options(ranks.LION, jlr.build_lr_schedule(ranks.LION)))
    state = jax_create_train_state(unflatten(family["flax"]), tx)
    sh = shape_based_tp_sharding(state, mesh)
    assert any(s.spec for s in jax.tree.leaves(sh))
    state, bs = shard_tree(state, sh), batch_sharding(mesh)
    state, metrics = jax.jit(jtrainer.make_train_step(jsde, FlaxNAFNet(**ranks.NAF).apply, tx))(
        state, jax.device_put(batch["LQ"], bs), jax.device_put(batch["GT"], bs), jax.random.PRNGKey(0))
    keys = nafnet_flax_keys(*NAF_DIMS)
    want = {"loss": float(metrics["loss"]),
            "grads": state_dict_from_flax(flatten(state.opt_state[0]["g"]), keys=keys),
            "params": state_dict_from_flax(flatten(state.params), keys=keys),
            "ema": state_dict_from_flax(flatten(state.ema.params), keys=keys)}
    assert all(v.abs().max() > 0 for v in want["grads"].values())
    _hold_step(family["got"][0]["nafnet"], want, loss_rel=1e-4)


def test_tlsc_net_split_fused_and_block_by_block(family):
    """``CNAFNetLocal`` split over the two ranks against the whole net: on
    a 16 px map its 4-block level fuses, on a 32 px one it runs block by
    block through the split layers (TLSC's window smaller than the map);
    outputs within 1e-5 of max|out| and every gradient within GRAD_REL of
    its max|grad| both ways."""
    want = ranks.tlsc_forwards(family["weights"]["tlsc"])
    for hw, got in family["got"][0]["tlsc"].items():
        w = want[hw]
        assert got["out"].shape == (2, hw, hw, 3)
        assert (got["out"] - w["out"]).abs().max() <= 1e-5 * w["out"].abs().max(), hw
        assert sorted(got["grads"]) == sorted(w["grads"])
        for k, g in got["grads"].items():
            assert _rel(g.numpy(), w["grads"][k].numpy()) <= GRAD_REL, (hw, k)


def test_nafnet_checkpoints_round_trip_between_tp2_and_one_process(family):
    """The one-process save at step 1 (weights, Lion's moment, the EMA, the
    generator) resumed by the two ranks, and the ranks' save (rank 0 writes
    whole tensors in the reference's keys, the fused level's too) resumed
    in one process: each resumed step 2's loss within LOSS_REL of the
    uninterrupted run's, its state after it within the step bounds."""
    root, one, got = family["root"], family["one"], family["got"][0]
    resumed = got["resumed"]
    _hold_step(resumed, {**one, "loss": one["losses"][1]})
    saved = got["saved"]
    assert all(abs(a - b) <= LOSS_REL * abs(b) for a, b in zip(saved["losses"], one["losses"]))
    tp_pth = checkpoint.load_params(os.path.join(root, "tp", "models", "1_G.pth"))
    one_pth = checkpoint.load_params(os.path.join(root, "one", "models", "1_G.pth"))
    assert {k: v.shape for k, v in tp_pth.items()} == {k: v.shape for k, v in one_pth.items()}
    moments = torch.load(os.path.join(root, "tp", "training_state", "1.state"), weights_only=True)
    assert moments["optimizer"]["inner"]["state"][0]["exp_avg"].shape == one_pth["intro.weight"].shape
    back = ranks.family_resume_then_step(root, "tp", family["weights"]["nafnet"], family["batches"]["nafnet"])
    _hold_step(back, {**saved, "loss": saved["losses"][1]})


# ------------------------------------------------------- the full-width plans
REFUSION = dict(width=64, enc_blk_nums=[1, 1, 1, 28], middle_blk_num=1, dec_blk_nums=[1, 1, 1, 1])
FULL = {
    "refusion": (lambda: ConditionalNAFNet(**REFUSION), 0.99),
    "stereo": (lambda: StereoConditionalNAFNet(**REFUSION), 0.99),
    "bokeh": (lambda: BokehConditionalNAFNet(img_channel=4, width=64, enc_blk_nums=[2, 2, 4, 8], middle_blk_num=12,
                                             dec_blk_nums=[2, 2, 2, 2]), 0.99),
    "compressor_haze": (lambda: UNet(ch=8, ch_mult=[4, 8, 8, 16], embed_dim=8), 0.93),
    "compressor_bokeh": (lambda: UNet(ch=64, ch_mult=[1, 2, 4], embed_dim=4), 0.99),
}


@pytest.mark.parametrize("name", FULL)
def test_full_width_plans_on_the_meta_device(name):
    """The train YAMLs' nets at full width (no memory: the meta device)
    under model_parallel 2 split the share of their parameter bytes
    measured here (the flagship Refusion NAFNet 99.31%, the bar of
    ``tests/test_tp_scale.py`` 85%; stereo 99.41%, bokeh 99.53%, the
    compressors 93.79% and 99.93%).  The NAFNets' 28-block level (or
    bokeh's deepest blocks) is split; ``intro``, the depthwise conv2, the
    norms, beta and gamma stay whole."""
    build, least = FULL[name]
    with torch.device("meta"):
        net = build()
    share, names = split_share(net, plan_of(net, 2))
    assert share > max(least, 0.85 if name == "refusion" else 0), share
    if name in ("refusion", "stereo"):
        assert sum(p.numel() for p in net.parameters()) > 70e6
        for k in ("conv1", "sca.1", "conv3", "conv4", "conv5", "mlp.1"):
            assert all(f"encoders.3.{b}.{k}.weight" in names for b in range(28)), k
        assert not any(n.startswith("intro") or "conv2" in n or n.endswith((".g", "beta", "gamma")) for n in names)
    if name == "stereo":
        assert "encoders.3.0.fusion.l_proj1.weight" in names and "encoders.3.0.fusion.norm_l.g" not in names
    if name == "bokeh":
        assert "middle_blks.0.cam_mlp.1.weight" in names and "cam_mlp.0.weight" in names


def test_a_width_the_model_axis_does_not_divide_raises():
    """The NAFNet at width 8 under model_parallel 3: its time MLP (two
    halves of 32 features) does not split three ways, and the plan raises
    before any collective."""
    mesh = Mesh(data_rank=0, data_size=1, model_rank=0, model_size=3)
    net = ConditionalNAFNet(width=8, enc_blk_nums=[1], middle_blk_num=1, dec_blk_nums=[1])
    with pytest.raises(ValueError, match="time_mlp.1: 32 output features per chunk do not divide by model_parallel=3"):
        tensor_parallel(_fresh_state(net), mesh)
