"""PyTorch port, data parallelism on the CPU (gloo): the loader's rows by
rank; the train entry point under ``torchrun`` over two processes (rank 0
alone logs, validates and writes; losses equal to one process at the global
batch; resumed at world size 2); the DDP step against the JAX package's
step under a data-parallel mesh; the data-parallel artifact loader; the
multi-process dry run."""

import glob
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_restoration_sde_tpu.models import ConditionalUNet as FlaxUNet
from image_restoration_sde_tpu.parallel import make_mesh, replicate, shard_batch
from image_restoration_sde_tpu.sde import IRSDE as JaxIRSDE
from image_restoration_sde_tpu.training import create_train_state as jax_create_train_state
from image_restoration_sde_tpu.training import lr_schedules as jlr
from image_restoration_sde_tpu.training import optimizers as jopt
from image_restoration_sde_tpu.training import trainer as jtrainer
from image_restoration_sde_tpu_torch import dryrun, exporting
from image_restoration_sde_tpu_torch import train as ptrain
from image_restoration_sde_tpu_torch.data.loader import TrainLoader
from image_restoration_sde_tpu_torch.models import ConditionalUNet, init_params_
from image_restoration_sde_tpu_torch.parallel import dist
from image_restoration_sde_tpu_torch.sde import IRSDE, rng
from image_restoration_sde_tpu_torch.training import checkpoint
from image_restoration_sde_tpu_torch.utils import state_dict_from_flax, unet_flax_keys
from test_torch_training import Injected, _keep_grads, _rel, _tiny_yaml
from test_torch_unet import flatten, unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread in this module, and in the ranks it spawns: the
    suite runs several workers on the machine's cores, and the nets are
    tiny."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


# ------------------------------------------------------------------ loader
class Indices:
    """A dataset whose sample is its index."""

    def __len__(self):
        return 6

    def __getitem__(self, i):
        return {"i": np.array([i])}


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_rows_in_rank_order_are_the_global_batch(world):
    """Rank r's batches are rows r*G/N .. (r+1)*G/N of the one-process
    loader's, at every step and from a resumed start; a global batch that
    does not divide by the world size raises."""
    one = TrainLoader(Indices(), 8, seed=3, ratio=5, num_workers=1)
    ranks = [TrainLoader(Indices(), 8, seed=3, ratio=5, num_workers=1, process_index=r, process_count=world)
             for r in range(world)]
    assert all(r.steps_per_epoch() == one.steps_per_epoch() for r in ranks)
    for epoch in (0, 1):
        want = one._epoch_indices(epoch)
        assert np.array_equal(np.concatenate([r._epoch_indices(epoch) for r in ranks], axis=1), want)
    start = one.steps_per_epoch() - 1  # the resumed loader crosses into epoch 1
    iters = [iter(TrainLoader(Indices(), 8, seed=3, ratio=5, num_workers=1, process_index=r, process_count=world,
                              start_step=start)) for r in range(world)]
    whole = iter(TrainLoader(Indices(), 8, seed=3, ratio=5, num_workers=1, start_step=start))
    try:
        for _ in range(3):
            assert np.array_equal(np.concatenate([next(it)["i"] for it in iters]), next(whole)["i"])
    finally:
        for it in (*iters, whole):
            it.close()
    with pytest.raises(ValueError, match="does not divide"):
        TrainLoader(Indices(), 6, process_count=4)


# ------------------------------------------------------- train entry point
def _torchrun(yml, log_dir, cwd, entry="train"):
    """``torchrun --standalone --nproc_per_node 2 -m
    image_restoration_sde_tpu_torch.<entry> -opt=<yml> --device cpu`` (its
    rendezvous on a free port); returns each rank's stderr (its log
    lines)."""
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                           "--log-dir", str(log_dir), "--redirects", "3", "-m",
                           f"image_restoration_sde_tpu_torch.{entry}", f"-opt={yml}", "--device", "cpu"],
                          cwd=str(cwd), env=env, capture_output=True, text=True, timeout=300)
    logs = [sorted(glob.glob(str(log_dir / "*" / "attempt_0" / str(r) / "stderr.log"))) for r in range(2)]
    outs = [open(files[-1]).read() if files else "" for files in logs]
    assert proc.returncode == 0, (proc.stderr[-2000:], outs[0][-3000:], outs[1][-3000:])
    return outs


def _losses(text):
    return [float(m) for m in re.findall(r"> loss: ([0-9.e+-]+)", text)]


def _global_batch_yaml(root, name, resume="null"):
    yml = _tiny_yaml(root, name, 3, extra_train=", remat: true", resume=resume)
    with open(yml) as f:
        text = f.read().replace("batch_size: 2", "batch_size: 4")
    with open(yml, "w") as f:
        f.write(text)
    return yml


def test_two_process_train_entry_point_matches_one_process(tmp_path):
    """Two gloo ranks train 3 steps of a global batch of 4 (2 each), the
    net recomputed in the backward (``train.remat``: DDP must reduce each
    gradient once), validate and save at step 2, save at 3.  Rank 0 logs the data-parallel
    line, the losses and the validation; rank 1 logs nothing; one
    experiments directory holds one ``3_G.pth``.  The losses equal the
    one-process run's at batch 4 within 1e-6 and the saved parameters lie
    within 2 lr of its (Adam's sign-sensitive first steps on gradients
    summed in another order).  Then the run resumed from step 2 at world
    size 2: its step-3 loss and ``3_G.pth`` bit-equal to the uninterrupted
    run's."""
    root = str(tmp_path)
    one = ptrain.train(_global_batch_yaml(root, "one"), "cpu")
    exp = os.path.join(root, "run", "experiments", tmp_path.parent.name)
    with open(glob.glob(os.path.join(exp, "one", "train_one_*.log"))[0]) as f:
        want = _losses(f.read())
    assert len(want) == 3

    outs = _torchrun(_global_batch_yaml(root, "dp"), tmp_path / "logs", tmp_path)
    assert "Data parallel: 2 process(es), global batch 4, per-process batch 2" in outs[0]
    assert "Data parallel" not in outs[1] and "loss:" not in outs[1] and "psnr" not in outs[1]
    got = _losses(outs[0])
    assert len(got) == 3 and all(abs(g - w) <= 1e-6 * abs(w) for g, w in zip(got, want)), (got, want)
    assert len(re.findall(r"iter: +2, psnr: [0-9.]+", outs[0])) == 1
    assert glob.glob(os.path.join(root, "run", "experiments", "*", "dp*")) == [os.path.join(exp, "dp")]
    assert sorted(os.listdir(os.path.join(exp, "dp", "models"))) == ["2_G.pth", "3_G.pth", "lastest_EMA.pth"]
    final = checkpoint.load_params(os.path.join(exp, "dp", "models", "3_G.pth"))
    lr = 1e-4
    assert max((v - one.net.state_dict()[k]).abs().max().item() for k, v in final.items()) <= 2 * lr

    state = os.path.join(exp, "dp", "training_state", "2.state")
    resumed = _torchrun(_global_batch_yaml(root, "dp", resume=state), tmp_path / "logs_resume", tmp_path)
    assert "Resuming training from epoch 0, iter 2" in resumed[0]
    assert _losses(resumed[0]) == got[2:]
    again = checkpoint.load_params(os.path.join(exp, "dp", "models", "3_G.pth"))
    assert all(torch.equal(v, final[k]) for k, v in again.items())


def test_test_entry_point_under_torchrun_matches_one_process(tmp_path):
    """``python -m ...test`` over two gloo ranks on a set of 3 images (2 on
    rank 0, 1 on rank 1): rank 0 alone logs, every output, LQ and GT PNG
    byte-equal to a one-process run's and the per-image and per-set
    metrics equal to its."""
    from image_restoration_sde_tpu_torch import test as test_entry
    from image_restoration_sde_tpu_torch.data.synthetic import write_pairs

    data = write_pairs(str(tmp_path / "data"), 3, seed=5, min_size=17, max_size=23)
    net = init_params_(ConditionalUNet(in_nc=3, out_nc=3, nf=8, depth=2), torch.Generator().manual_seed(4))
    torch.save(net.state_dict(), tmp_path / "net.pth")

    def yaml_named(name):
        path = tmp_path / f"{name}.yml"
        path.write_text(f"""name: {name}
model: denoising
distortion: derain
sde: {{max_sigma: 10, T: 100, schedule: cosine, eps: 0.005, sample_T: 3, sampling_mode: sde}}
degradation: {{sigma: 25, noise_type: G, scale: 4}}
datasets:
  test1: {{name: pairs, mode: LQGT, dataroot_GT: {data}/GT, dataroot_LQ: {data}/LQ}}
network_G: {{which_model_G: ConditionalUNet, setting: {{in_nc: 3, out_nc: 3, nf: 8, depth: 2}}}}
path: {{root: {tmp_path}, pretrain_model_G: {tmp_path}/net.pth}}
""")
        return str(path)

    want = test_entry.evaluate(yaml_named("one"), "cpu")["pairs"]
    outs = _torchrun(yaml_named("dp"), tmp_path / "logs", tmp_path, entry="test")
    assert "2 process(es)" in outs[0] and "PSNR" not in outs[1]
    rows = re.findall(r"- (\S+)\s+\| (PSNR .*) \| \S+s$", outs[0], re.M)
    assert [name for name, _ in rows] == [r["name"] for r in want["images"]]
    for (_, got), r in zip(rows, want["images"]):
        assert got.startswith(f"PSNR {r['psnr']:.4f} SSIM {r['ssim']:.4f} | PSNR-Y {r['psnr_y']:.4f}")
    assert f"avg over 3: PSNR {want['psnr']:.4f} SSIM {want['ssim']:.4f}" in outs[0]
    results = os.path.join(str(tmp_path), "results", tmp_path.parent.name)
    one = sorted(os.listdir(os.path.join(results, "one", "pairs")))
    assert len(one) == 9 and sorted(os.listdir(os.path.join(results, "dp", "pairs"))) == one
    for f in one:
        with open(os.path.join(results, "one", "pairs", f), "rb") as a, \
                open(os.path.join(results, "dp", "pairs", f), "rb") as b:
            assert a.read() == b.read(), f


# ------------------------------------------------- DDP step against JAX
def _flax_weights(seed: int) -> dict:
    """The dry run's flax UNet's parameters (their shapes from
    ``jax.eval_shape``) with seeded values: kernels ~ 1/sqrt(fan_in),
    biases and gains off their defaults (as ``random_flax_params``)."""
    net = FlaxUNet(in_nc=3, out_nc=3, nf=dryrun.NF, depth=dryrun.DEPTH)
    x = jnp.zeros((1, dryrun.SIZE, dryrun.SIZE, 3))
    leaves, _ = jax.tree_util.tree_flatten_with_path(jax.eval_shape(net.init, jax.random.PRNGKey(0), x, x,
                                                                    jnp.array([1.0])))
    r = np.random.default_rng(seed)
    out = {}
    for path, leaf in leaves:
        key = "/".join(str(k.key) for k in path[1:])
        if key.endswith("/g"):
            v = 1 + 0.2 * r.standard_normal(leaf.shape)
        elif key.endswith("bias"):
            v = 0.1 * r.standard_normal(leaf.shape)
        else:
            v = r.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        out[key] = v.astype(np.float32)
    return out


def test_dryrun_and_the_ddp_step_against_the_jax_data_parallel_step(capsys):
    """``dryrun_multichip(2, model_parallel=1)`` on the CPU: two gloo ranks (DDP, each its
    rows of a global batch of 4) give the one-process step's loss; then
    rank 0's step against the JAX package's train step jitted over a
    2-device ``data`` mesh (``make_mesh``, ``shard_batch``), with the same
    flax-made weights (the port's through ``utils/flax_import.py``), batch
    and draws: the port draws the global batch's (timesteps, x_t) on each
    rank from the run's generator, JAX gets those through the stub SDE
    ``Injected``.  Bounds of ``test_train_step_matches_jax`` (``_hold``):
    the loss within 1e-4 of itself; each gradient the optimizer stepped on
    (the port's after DDP's all-reduce, the ranks' mean; JAX's over the
    sharded batch, kept by ``_keep_grads``) within 2e-4 of its tensor's
    max|grad|; the updated parameters and the EMA (a copy on its first call)
    elementwise within 2 lr."""
    batch, lr = 4, dryrun.TRAIN_OPT["lr_G"]
    weights = _flax_weights(11)
    got = dryrun.dryrun_multichip(2, state_dict_from_flax(weights, dryrun.DEPTH), model_parallel=1, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: world 2 (gloo, cpu), batch 4 (2 a process)" in out and "tp 1" in out

    lq, gt = dryrun.make_batch(batch)
    t, xt = dryrun.make_sde("cpu").generate_random_states(dryrun.step_generator("cpu"), gt, lq)
    jsde = Injected(JaxIRSDE.create(max_sigma=10, T=dryrun.T, schedule="cosine", eps=0.005),
                    jnp.asarray(t.numpy().astype(np.int32)), jnp.asarray(xt.numpy()))
    mesh = make_mesh(jax.devices()[:2])
    tx = optax.chain(_keep_grads(), jopt.build_from_options(dryrun.TRAIN_OPT, jlr.build_lr_schedule(dryrun.TRAIN_OPT)))
    fnet = FlaxUNet(in_nc=3, out_nc=3, nf=dryrun.NF, depth=dryrun.DEPTH)
    state = replicate(jax_create_train_state(unflatten(weights), tx), mesh)
    jlq, jgt = shard_batch((lq.numpy(), gt.numpy()), mesh)
    assert jlq.sharding.spec[0] == "data" and jlq.addressable_shards[0].data.shape[0] == batch // 2
    state, metrics = jax.jit(jtrainer.make_train_step(jsde, fnet.apply, tx))(state, jlq, jgt, jax.random.PRNGKey(0))
    keys = unet_flax_keys(dryrun.DEPTH)
    want_grads = state_dict_from_flax(flatten(state.opt_state[0]["g"]), keys=keys)
    want_params = state_dict_from_flax(flatten(state.params), keys=keys)
    want_ema = state_dict_from_flax(flatten(state.ema.params), keys=keys)
    assert abs(got["loss"] - float(metrics["loss"])) <= 1e-4 * abs(float(metrics["loss"]))
    assert sorted(got["grads"]) == sorted(want_grads)
    for k, g in got["grads"].items():
        assert want_grads[k].abs().max() > 0 and _rel(g.numpy(), want_grads[k].numpy()) <= 2e-4, k
    for k, v in got["params"].items():
        assert (v - want_params[k]).abs().max().item() <= 2 * lr, k
        assert (got["ema"][k] - want_ema[k]).abs().max().item() <= 2 * lr, k


@pytest.mark.parametrize("device", [None, "cuda"])
def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch, device):
    """With no card, ``dryrun_multichip`` raises before it starts a rank
    (by default and with ``device="cuda"``); it never falls back to the
    CPU; another device name is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist, "spawn", lambda *a, **k: pytest.fail("a rank was started"))
    kw = {} if device is None else {"device": device}
    with pytest.raises(RuntimeError, match="no CUDA device; pass device='cpu'"):
        dryrun.dryrun_multichip(2, **kw)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        dryrun.dryrun_multichip(2, device="cuda:1")


def test_gathered_in_one_process_is_every_item_in_order():
    assert list(dist.gathered(range(5), lambda i: i * i)) == [(i, i * i) for i in range(5)]
    assert dist.rows(6) == slice(0, 6) and dist.shard() is None and dist.process_is_primary()


# ------------------------------------------------- data-parallel artifacts
HW = 16


@pytest.fixture(scope="module")
def symbolic():
    """A symbolic-batch per-sample-seed artifact of a tiny seeded UNet (two
    posterior steps)."""
    net = init_params_(ConditionalUNet(in_nc=3, out_nc=3, nf=8, depth=1), torch.Generator().manual_seed(3)).eval()
    sde = IRSDE.create(10.0, 100, "cosine", 0.005, device="cpu")
    return exporting.export_restoration_sampler(sde, net, (HW, HW), mode="posterior", steps=2, batch=None,
                                                per_sample_seed=True)


@pytest.fixture(scope="module")
def loaded(symbolic):
    """(the artifact on one device, on ``devices=["cpu", "cpu"]``)."""
    return (exporting.load_artifact(symbolic, device="cpu")[0],
            exporting.load_artifact(symbolic, devices=["cpu", "cpu"])[0])


def _lq(b, seed):
    return torch.rand(b, HW, HW, 3, generator=rng.generator(seed, "cpu"))


def test_data_parallel_artifact_is_one_device_row_for_row(loaded, monkeypatch):
    """The artifact on ``devices=["cpu", "cpu"]`` at batches 3 (blocks of 2
    and 1) and 4 (2 and 2): bit-equal to one device called on the same row
    blocks, each block under ``on_device`` of its device; against one device
    on the whole batch within float32 rounding (1e-6 of max: the CPU's
    convolutions round otherwise at batch 1 than at batch 3).  Each row
    follows its own seed (a row moved to another block with its seed gives
    the same values)."""
    entered = []
    original = exporting.on_device
    monkeypatch.setattr(exporting, "on_device", lambda d: entered.append(str(d)) or original(d))
    one, two = loaded
    assert isinstance(two, exporting.DataParallelSampler) and [str(d) for d in two.devices] == ["cpu", "cpu"]
    for b in (3, 4):
        lq, seeds = _lq(b, seed=20 + b), [5 * i + 2 for i in range(b)]
        entered.clear()
        got = two(lq, seeds)
        blocks = [rows for _, rows in two.blocks(b)]
        assert entered == ["cpu", "cpu"] and blocks == [slice(0, (b + 1) // 2), slice((b + 1) // 2, b)]
        assert torch.equal(got, torch.cat([one(lq[rows], seeds[rows]) for rows in blocks]))
        whole = one(lq, seeds)
        assert (got - whole).abs().max() <= 1e-6 * whole.abs().max()
    lq = _lq(3, seed=30)
    moved = two(torch.stack([lq[1], lq[0], lq[2]]), [8, 7, 9])
    assert torch.equal(moved[0], two(lq, [7, 8, 9])[1])


def test_data_parallel_artifact_refusals(symbolic, loaded):
    """Several devices take neither a fixed-batch artifact nor a scalar
    seed; a per-sample artifact wants one seed a row."""
    header, payload = exporting.unpack_artifact(symbolic)
    with pytest.raises(ValueError, match="symbolic-batch"):
        exporting.load_artifact(exporting.pack_artifact({**header, "batch": 2}, payload), devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="scalar seed"):
        exporting.load_artifact(exporting.pack_artifact({**header, "seed": "scalar"}, payload),
                                devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="2 seeds for a batch of 3"):
        loaded[1](_lq(3, 0), [1, 2])


def test_serve_lists_its_devices(symbolic, loaded):
    """The server over two devices: ``/health`` lists them, a symbolic
    batch is not seed-reproducible, and a request is served."""
    import threading

    from image_restoration_sde_tpu_torch import bench_serve, serve

    header = exporting.unpack_artifact(symbolic)[0]
    handler, _, _ = serve.build_handler(loaded[1], header, max_batch=4, window_ms=1.0, devices=["cpu", "cpu"])
    srv = serve.Server(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        addr = f"127.0.0.1:{srv.server_address[1]}"
        health = bench_serve.health(addr)
        assert health["serving"]["devices"] == ["cpu", "cpu"] and health["serving"]["seed_reproducible"] is False
        status, body = bench_serve.post(addr, bench_serve.make_png((HW, HW), 3), 3)
        assert status == 200 and body[:4] == b"\x89PNG"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
