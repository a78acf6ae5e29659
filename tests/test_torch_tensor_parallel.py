"""PyTorch port, tensor parallelism on the CPU (gloo ranks): the split
layers against the whole layers; a tp2 train step of a tiny DiT and of
ConditionalUNet against the one-process step; checkpoints from tp2 to one
process and back; dp2 x tp2 against the JAX package's dp4 x tp2 step; the
train entry point under ``torchrun`` with ``train.model_parallel: 2``;
DiT-L/2's plan on the meta device; the refusals (the NAFNet family's
plans: ``tests/test_torch_tp_nafnet.py``); ConditionalUNet's Fourier
time features against flax.  Three spawns of ranks in all (they dominate
the time), one torch thread."""

import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_tp_ranks as ranks
from image_restoration_sde_tpu.models import ConditionalUNet as FlaxUNet
from image_restoration_sde_tpu.parallel import make_mesh as jax_make_mesh
from image_restoration_sde_tpu.parallel.mesh import batch_sharding, shape_based_tp_sharding, shard_tree
from image_restoration_sde_tpu.sde import IRSDE as JaxIRSDE
from image_restoration_sde_tpu.training import create_train_state as jax_create_train_state
from image_restoration_sde_tpu.training import lr_schedules as jlr
from image_restoration_sde_tpu.training import optimizers as jopt
from image_restoration_sde_tpu.training import trainer as jtrainer
from image_restoration_sde_tpu_torch import dryrun, runners
from image_restoration_sde_tpu_torch import train as ptrain
from image_restoration_sde_tpu_torch.models import ConditionalUNet, DiT, build_network
from image_restoration_sde_tpu_torch.parallel import dist
from image_restoration_sde_tpu_torch.parallel.mesh import Mesh, make_mesh
from image_restoration_sde_tpu_torch.parallel.tensor import plan_of, split_share
from image_restoration_sde_tpu_torch.training import build_from_options, build_lr_schedule, checkpoint, \
    create_train_state
from image_restoration_sde_tpu_torch.training.trainer import tensor_parallel
from image_restoration_sde_tpu_torch.utils import options, state_dict_from_flax, unet_flax_keys
from test_torch_parallel import _flax_weights, _losses, _torchrun
from test_torch_training import Injected, _keep_grads, _rel, _tiny_yaml
from test_torch_unet import flatten, unflatten

LR = dryrun.TRAIN_OPT["lr_G"]
# the split step against the one-process step: the loss within LOSS_REL of
# itself, each gradient within GRAD_REL of its tensor's max|grad| (the dry
# run's bound: float32 sums in another order), parameters and EMA after
# Adam's first step elementwise within 2 lr (it moves each by at most lr)
LOSS_REL, GRAD_REL = 1e-6, dryrun.GRAD_REL


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread here and in the spawned ranks: the suite runs
    several workers on the machine's cores, and the nets are tiny."""
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
        for k, v in got[part].items():
            assert (v - want[part][k]).abs().max().item() <= 2 * LR, (part, k)


# ------------------------------------------------- tp2: one spawn, many checks
def test_tp2_split_layers_train_steps_and_checkpoints_against_one_process(tmp_path):
    """Two gloo ranks, one model group.  (a) Each split layer (a column
    then a row Linear, a 6-chunk column Linear gathered, a row-split
    Conv2d on a channels_last input) against the whole layer: outputs,
    input gradients and the assembled parameter gradients within 1e-5 of
    max (float32 partial sums added in another order).  (b) One train step
    of the tiny DiT (hidden 128, 4 heads, depth 2: 2 heads a rank through
    K4's plain version) and of the UNet (nf 16, depth 2) against the
    one-process step (``_hold_step``).  (d) Checkpoints: the one-process
    save at step 1 resumed by the ranks, and the ranks' save (rank 0 writes
    whole tensors in the reference's keys) resumed in one process: each
    resumed step 2's loss within LOSS_REL of the uninterrupted run's, its
    state after it within the step bounds.  The ranks agree; a world of 2
    refuses model_parallel 3."""
    root = str(tmp_path)
    one = ranks.save_then_step(root, "one")
    want = {"dit": ranks.one_step("dit"), "unet": ranks.one_step("unet")}
    got = dist.spawn(ranks.tp2_ranks, 2, root, device="cpu")
    for r, out in enumerate(got):
        assert out["refused"] == "2 process(es) not divisible by model_parallel=3", r
        for kind in ("dit", "unet", "resumed"):
            assert out[kind]["loss"] == got[0][kind]["loss"], (r, kind)
            assert all(torch.equal(v, got[0][kind]["grads"][k]) for k, v in out[kind]["grads"].items()), (r, kind)

    layers = got[0]["layers"]
    assert layers["split_params"] == ["col.bias", "col.weight", "conv.weight", "mod.bias", "mod.weight",
                                      "row.weight"]
    whole, split = layers["whole"], layers["split"]
    pairs = list(zip(split["outputs"], whole["outputs"])) + [(split["x_grad"], whole["x_grad"]),
                                                              (split["img_grad"], whole["img_grad"])]
    pairs += [(split["grads"][k], v) for k, v in whole["grads"].items()]
    for a, b in pairs:
        assert a.shape == b.shape and (a - b).abs().max() <= 1e-5 * b.abs().max()

    _hold_step(got[0]["dit"], want["dit"])
    _hold_step(got[0]["unet"], want["unet"])

    resumed = got[0]["resumed"]
    assert abs(resumed["loss"] - one["losses"][1]) <= LOSS_REL * abs(one["losses"][1])
    _hold_step(resumed, {**one, "loss": one["losses"][1]})
    saved = got[0]["saved"]
    assert all(abs(a - b) <= LOSS_REL * abs(b) for a, b in zip(saved["losses"], one["losses"]))
    tp_pth = checkpoint.load_params(os.path.join(root, "tp", "models", "1_G.pth"))
    one_pth = checkpoint.load_params(os.path.join(root, "one", "models", "1_G.pth"))
    assert {k: v.shape for k, v in tp_pth.items()} == {k: v.shape for k, v in one_pth.items()}
    back = ranks.resume_then_step(root, "tp")
    assert abs(back["loss"] - saved["losses"][1]) <= LOSS_REL * abs(saved["losses"][1])
    _hold_step(back, {**saved, "loss": saved["losses"][1]})


# -------------------------------------------- dp2 x tp2 against JAX's dp4 x tp2
def test_dp2_tp2_step_matches_the_jax_dp4_tp2_step(capsys):
    """``dryrun_multichip(4, model_parallel=2)``: four gloo ranks as data 2
    x model 2 (each data row holds 4 of the global batch's 8 rows; the UNet
    split over each model group), the dry run's own checks held, then rank
    0's step against the JAX package's train step on its 8 virtual CPU
    devices as data 4 x model 2 (``make_mesh(model_parallel=2)``,
    ``shape_based_tp_sharding``, ``shard_tree``), with the same flax-made
    weights, batch and draws (the port's, through the stub SDE
    ``Injected``).  Bounds of ``test_torch_parallel.py``'s DDP test: the
    loss within 1e-4 of itself, each gradient within 2e-4 of its max|grad|,
    parameters and EMA elementwise within 2 lr."""
    batch = 8
    weights = _flax_weights(11)
    got = dryrun.dryrun_multichip(4, state_dict_from_flax(weights, dryrun.DEPTH), model_parallel=2, device="cpu")
    out = capsys.readouterr().out
    assert "world 4 (gloo, cpu), batch 8 (4 a process)" in out and "mesh {'data': 2, 'model': 2}, tp 2" in out
    assert got["rows"] == 4 and got["layout_kept"] and len(got["split"]) > 0

    lq, gt = dryrun.make_batch(batch)
    t, xt = dryrun.make_sde("cpu").generate_random_states(dryrun.step_generator("cpu"), gt, lq)
    jsde = Injected(JaxIRSDE.create(max_sigma=10, T=dryrun.T, schedule="cosine", eps=0.005),
                    jnp.asarray(t.numpy().astype(np.int32)), jnp.asarray(xt.numpy()))
    mesh = jax_make_mesh(model_parallel=2)
    assert dict(mesh.shape) == {"data": 4, "model": 2}
    tx = optax.chain(_keep_grads(), jopt.build_from_options(dryrun.TRAIN_OPT, jlr.build_lr_schedule(dryrun.TRAIN_OPT)))
    fnet = FlaxUNet(in_nc=3, out_nc=3, nf=dryrun.NF, depth=dryrun.DEPTH)
    state = jax_create_train_state(unflatten(weights), tx)
    sh = shape_based_tp_sharding(state, mesh)
    assert any(s.spec for s in jax.tree.leaves(sh))
    state = shard_tree(state, sh)
    bs = batch_sharding(mesh)
    state, metrics = jax.jit(jtrainer.make_train_step(jsde, fnet.apply, tx))(
        state, jax.device_put(lq.numpy(), bs), jax.device_put(gt.numpy(), bs), jax.random.PRNGKey(0))
    keys = unet_flax_keys(dryrun.DEPTH)
    want = {"loss": float(metrics["loss"]),
            "grads": state_dict_from_flax(flatten(state.opt_state[0]["g"]), keys=keys),
            "params": state_dict_from_flax(flatten(state.params), keys=keys),
            "ema": state_dict_from_flax(flatten(state.ema.params), keys=keys)}
    assert all(v.abs().max() > 0 for v in want["grads"].values())
    _hold_step(got, want, loss_rel=1e-4)


# --------------------------------------------------- the train entry point
def test_train_entry_point_under_torchrun_with_model_parallel_2(tmp_path, monkeypatch):
    """``torchrun --standalone --nproc_per_node 2 -m ...train`` on a YAML
    with ``train.model_parallel: 2`` (the UNet nf 16, depth 2; 3 steps,
    validation and a save at 2, a save at 3): rank 0 logs the mesh and
    every loss, rank 1 nothing; the per-iteration losses within 1e-6 of
    one process's on the same YAML without the key; one validation (rank
    0's model group samples together); the saved ``3_G.pth`` whole, in the
    one-process run's keys and shapes, within 3 lr of its parameters (three
    Adam steps).  ``IRSDE_TP`` sets the width where the YAML does not, and
    overrides it."""
    root = str(tmp_path)
    net = "{which_model_G: ConditionalUNet, setting: {in_nc: 3, out_nc: 3, nf: 16, depth: 2}}"
    one = ptrain.train(_tiny_yaml(root, "one", 3, network=net), "cpu")
    exp = os.path.join(root, "run", "experiments", tmp_path.parent.name)
    with open(glob.glob(os.path.join(exp, "one", "train_one_*.log"))[0]) as f:
        want = _losses(f.read())
    assert len(want) == 3

    yml = _tiny_yaml(root, "tp", 3, network=net, extra_train=", model_parallel: 2")
    outs = _torchrun(yml, tmp_path / "logs", tmp_path)
    assert "Tensor parallel: mesh {'data': 1, 'model': 2} (data 1 x model 2)" in outs[0]
    assert "Data parallel: 2 process(es), global batch 2, per-process batch 2" in outs[0]
    assert "loss:" not in outs[1] and "Tensor parallel" not in outs[1]
    got = _losses(outs[0])
    assert len(got) == 3 and all(abs(g - w) <= 1e-6 * abs(w) for g, w in zip(got, want)), (got, want)
    assert len(re.findall(r"iter: +2, psnr: [0-9.]+", outs[0])) == 1
    final = checkpoint.load_params(os.path.join(exp, "tp", "models", "3_G.pth"))
    whole = one.net.state_dict()
    assert {k: v.shape for k, v in final.items()} == {k: v.shape for k, v in whole.items()}
    assert max((v - whole[k]).abs().max().item() for k, v in final.items()) <= 3 * LR

    opt = {"train": {"model_parallel": 2}}
    monkeypatch.delenv("IRSDE_TP", raising=False)
    assert options.model_parallel(opt) == 2 and options.model_parallel({"train": {}}) == 1
    monkeypatch.setenv("IRSDE_TP", "4")
    assert options.model_parallel(opt) == 4 and options.model_parallel({"train": {}}) == 4


# ------------------------------------------------------------- DiT-L/2's plan
def test_dit_l2_plan_on_the_meta_device_splits_over_90_percent_of_its_bytes():
    """The real DiT-L/2 (no memory: the meta device): more than 90% of its
    parameter bytes split over the model axis, each block's qkv, proj, fc1,
    fc2 and adaLN Linear among them (the bar of ``tests/test_tp_scale.py``);
    the patch embedding and the final linear whole."""
    with torch.device("meta"):
        net = build_network("DiT_L_2", {"in_channels": 8})
    assert 440e6 < sum(p.numel() for p in net.parameters()) < 480e6
    share, names = split_share(net, plan_of(net, 2))
    assert share > 0.90, share
    for i in range(24):
        for layer in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2", "adaLN_modulation.1"):
            assert f"blocks.{i}.{layer}.weight" in names, (i, layer)
    assert not any(n.startswith(("patch_embed", "final_layer.linear")) for n in names)
    assert len([n for n in names if n.startswith("blocks.") and n.endswith("weight")]) == 24 * 5


# ------------------------------------------------------------------ refusals
def _fresh_state(net):
    return create_train_state(net, build_from_options(dryrun.TRAIN_OPT, net.parameters(),
                                                      build_lr_schedule(dryrun.TRAIN_OPT)))


def test_layouts_the_port_cannot_honour_raise(tmp_path):
    """One process cannot be split two ways (the entry point raises before
    it trains), DiT's heads must divide by the width, a state that has
    stepped is not split, a NAFNet width that does not divide by the model
    axis raises through the task runner, and a module without a plan
    raises, naming the nets that have one: nothing is replicated
    quietly."""
    with pytest.raises(ValueError, match="1 process\\(es\\) not divisible by model_parallel=2"):
        make_mesh(2)
    root = str(tmp_path)
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        ptrain.train(_tiny_yaml(root, "alone", 1, extra_train=", model_parallel: 2"), "cpu")
    mesh = Mesh(data_rank=0, data_size=1, model_rank=0, model_size=2)
    with pytest.raises(ValueError, match="3 heads do not divide by model_parallel=2"):
        tensor_parallel(_fresh_state(DiT(in_channels=4, hidden_size=96, depth=1, num_heads=3)), mesh)
    state = ranks.train_state("unet")
    ranks.step(state, "unet", dryrun.step_generator("cpu"))
    with pytest.raises(ValueError, match="has stepped"):
        tensor_parallel(state, mesh)
    opt = options.dict_to_nonedict(options.parse(_tiny_yaml(root, "naf", 1, network=(
        "{which_model_G: ConditionalNAFNet, setting: {width: 66, enc_blk_nums: [1], middle_blk_num: 1, "
        "dec_blk_nums: [1]}}")), is_train=True))
    with pytest.raises(ValueError, match="66 input channels do not divide by model_parallel=4"):
        runners.build_task(opt, 0, "cpu", Mesh(data_rank=0, data_size=1, model_rank=0, model_size=4))
    with pytest.raises(ValueError, match="Sequential has no tensor-parallel plan .*ConditionalNAFNet"):
        tensor_parallel(_fresh_state(torch.nn.Sequential(torch.nn.Linear(4, 4))), mesh)


# ------------------------------------------------------ Fourier time features
TINY = dict(in_nc=3, out_nc=3, nf=8, depth=2)


def test_learned_fourier_time_features_match_flax():
    """``ConditionalUNet(random_or_learned_sinusoidal_cond=True,
    learned_sinusoidal_dim=16)`` with flax's weights (``sinu_pos_emb/
    weights`` to ``time_mlp.0.weights``): the output within 1e-4 of
    max|out| of the flax net's and every gradient, ``weights``' included,
    within 2e-4 of its max|grad| of ``jax.grad``'s (float32 through ~30
    layers in another order)."""
    fourier = dict(random_or_learned_sinusoidal_cond=True, learned_sinusoidal_dim=16)
    fnet = FlaxUNet(**TINY, **fourier)
    r = np.random.default_rng(5)
    xt, cond = r.random((2, 8, 8, 3), np.float32), r.random((2, 8, 8, 3), np.float32)
    tvec, cot = np.array([7.0, 93.0], np.float32), r.standard_normal((2, 8, 8, 3)).astype(np.float32)
    leaves = jax.tree_util.tree_flatten_with_path(jax.eval_shape(fnet.init, jax.random.PRNGKey(0), xt, cond,
                                                                 tvec))[0]
    shapes = {"/".join(str(k.key) for k in path[1:]): leaf.shape for path, leaf in leaves}
    weights = {k: (r.standard_normal(v) * (1.0 if k.endswith("weights") else 0.3)).astype(np.float32)
               if not k.endswith("/g") else (1 + 0.2 * r.standard_normal(v)).astype(np.float32)
               for k, v in shapes.items()}
    assert weights["sinu_pos_emb/weights"].shape == (8,)

    def out_and_grads(params):
        out, vjp = jax.vjp(lambda p: fnet.apply(p, xt, cond, tvec), params)
        return out, vjp(jnp.asarray(cot))[0]

    out, jgrads = jax.jit(out_and_grads)(unflatten(weights))
    out, jgrads = np.asarray(out), flatten(jgrads)
    keys = unet_flax_keys(TINY["depth"], fourier=True)
    net = ConditionalUNet(**TINY, **fourier)
    net.load_state_dict(state_dict_from_flax(weights, keys=keys))
    got = net(torch.from_numpy(xt), torch.from_numpy(cond), torch.from_numpy(tvec))
    assert np.abs(got.detach().numpy() - out).max() <= 1e-4 * np.abs(out).max()
    (got * torch.from_numpy(cot)).sum().backward()
    want = state_dict_from_flax(jgrads, keys=keys)
    assert net.time_mlp[0].weights.grad.abs().max() > 0
    for k, p in net.named_parameters():
        assert _rel(p.grad.numpy(), want[k].numpy()) <= 2e-4, k


def test_random_fourier_features_match_flax_and_stay_frozen():
    """The features alone (``RandomOrLearnedSinusoidalPosEmb``, 16
    frequencies, ``is_random``) against flax's module on the same weights
    and timesteps: ``[t, sin, cos]``, 17 channels, within 1e-6 of max;
    JAX's gradient of its ``weights`` is zero (stop_gradient) and the
    port's ``weights`` takes none, also as the time embedding of a
    ``ConditionalUNet`` whose loss is backpropagated."""
    from image_restoration_sde_tpu.models.modules import RandomOrLearnedSinusoidalPosEmb as FlaxFourier
    from image_restoration_sde_tpu_torch.models.modules import RandomOrLearnedSinusoidalPosEmb

    w = np.random.default_rng(6).standard_normal(8).astype(np.float32)
    t = np.array([0.0, 7.0, 93.0], np.float32)
    fmod = FlaxFourier(16, is_random=True)
    params = {"params": {"weights": jnp.asarray(w)}}
    want = np.asarray(fmod.apply(params, t))
    jgrad = jax.grad(lambda p: jnp.sum(fmod.apply(p, t) ** 2))(params)["params"]["weights"]
    mod = RandomOrLearnedSinusoidalPosEmb(16, is_random=True)
    with torch.no_grad():
        mod.weights.copy_(torch.from_numpy(w))
    got = mod(torch.from_numpy(t))
    assert got.shape == (3, 17) and np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    assert not np.asarray(jgrad).any() and not mod.weights.requires_grad
    net = ConditionalUNet(**TINY, random_or_learned_sinusoidal_cond=True, random_fourier_features=True)
    x = torch.rand(1, 8, 8, 3)
    net(x, x, torch.tensor([5.0])).sum().backward()
    assert net.time_mlp[0].weights.grad is None and net.time_mlp[1].weight.grad.abs().max() > 0
