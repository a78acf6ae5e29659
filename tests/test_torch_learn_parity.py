"""Learning, not one step: the Refusion demo's compressor (``configs/demo/
refusion-two-stage/stage1_compressor.yml``'s net, Adam, TrueCosineAnnealingLR)
trained by the JAX package and by the port on the same batches of
``gen_synth dehaze`` crops, from the same flax-made weights: over the
steps the losses and the cross-decode PSNR stay together (one step is held
in ``test_torch_latent_training.py``).  Beside them the port from its own
initialisation (a net as the train entry point builds it: flax's
``lecun_normal`` kernels, zero biases), which shares the JAX package's
distributions but not its draws.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_learn_parity.py 800
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_learn_parity.py 800 bokeh

print the three runs every eighth of the steps (64 px crops of 128 px
images, batch 8): the figures ``PERF.md`` quotes for the compressor; with
``bokeh``, the bokeh demo's compressor (``configs/demo/bokeh-two-stage/
stage1.yml``) on ``gen_synth bokeh``'s src and tgt, and beside each
run's PSNR how much its decode depends on the latent (the PSNR of the
decode of a zero latent against that of the GT's, both with the LQ skips:
the higher, the less the latent matters).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_learn_parity.py spread 1000 7 jax
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_learn_parity.py spread 1000 7 port

run the Refusion demo's compressor YAML as shipped (batch 8 of 256 px
crops, its schedule over its 1500 iterations) on ``gen_synth dehaze``'s
bytes through one package's train entry point on the CPU, with
``train.manual_seed`` the given seed, up to the given iteration, and print
each validation's PSNR as a JSON line: ``jax`` is ``tools/train.py``;
``port`` starts from the weights the JAX package's task draws for that
seed (flax's init under ``PRNGKey(seed)``), so the two differ in their
data order and arithmetic only.  Three seeds of each give the JAX
package's own spread between draws beside the port's (``PERF.md``)."""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from image_restoration_sde_tpu.models.latent_unet import UNet as FlaxCompressor
from image_restoration_sde_tpu.training import create_train_state as jax_create_train_state
from image_restoration_sde_tpu.training import latent as jlatent
from image_restoration_sde_tpu.training import lr_schedules as jlr
from image_restoration_sde_tpu.training import optimizers as jopt
from image_restoration_sde_tpu_torch import gen_synth
from image_restoration_sde_tpu_torch.models import UNet
from image_restoration_sde_tpu_torch.training import lr_schedules, optimizers, trainer
from image_restoration_sde_tpu_torch.training.latent import make_compressor_train_step
from image_restoration_sde_tpu_torch.utils import latent_unet_flax_keys, metrics, state_dict_from_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_unet import flatten  # noqa: E402

COMP = dict(in_ch=3, out_ch=3, ch=8, ch_mult=(4, 8, 8, 16), embed_dim=8)  # the demo's compressor
BOKEH = dict(in_ch=3, out_ch=3, ch=16, ch_mult=(1, 2, 4), embed_dim=4)  # the bokeh demo's
TINY = dict(in_ch=3, out_ch=3, ch=4, ch_mult=(1, 2), embed_dim=4)


def _opt(steps):
    return {"optimizer": "Adam", "lr_G": 2e-4, "lr_scheme": "TrueCosineAnnealingLR", "beta1": 0.9, "beta2": 0.99,
            "niter": steps, "eta_min": 1e-6, "lr_steps": [], "lr_gamma": 0.5, "warmup_iter": -1}


def _load(root, split, sub):
    d = os.path.join(root, split, sub)
    return np.stack([np.asarray(Image.open(os.path.join(d, f)), np.float32) / 255 for f in sorted(os.listdir(d))])


def _psnr(out, gt):
    return float(np.mean([metrics.calculate_psnr((np.clip(o, 0, 1) * 255).round().astype(np.uint8),
                                                 (g * 255).round().astype(np.uint8)) for o, g in zip(out, gt)]))


def run(root, steps, size=128, crop=64, batch=8, every=None, comp=COMP, bokeh=False):
    """The three runs of the compressor ``comp`` (the demo's by default) for
    ``steps`` steps on ``gen_synth dehaze`` data (``bokeh``: ``gen_synth
    bokeh``'s, src as LQ and tgt as GT) under ``root`` (8 train, 2 val
    images of ``size`` px): each ``every`` steps (an eighth by default) a
    record of the step, the three losses, the three cross-decode PSNRs on
    the validation images (GT latent, LQ skips, as both tasks validate)
    and the three PSNRs of a zero latent's decode against the GT latent's
    (``latent``)."""
    if not os.path.isdir(root):
        write = gen_synth.write_bokeh if bokeh else gen_synth.write_dehaze
        write(root, n_train=8, n_val=2, size=size, seed=0)
    subs = ("src", "tgt") if bokeh else ("LQ", "GT")
    tr_lq, tr_gt, va_lq, va_gt = (_load(root, split, sub) for split in ("train", "val") for sub in subs)
    r = np.random.default_rng(3)
    fc = FlaxCompressor(**comp)
    params = jax.jit(fc.init)(jax.random.PRNGKey(0), jnp.zeros((1, crop, crop, 3)))

    def enc(p, x):
        return fc.apply(p, x, method=fc.encode)

    def dec(p, latent, hs):
        return fc.apply(p, latent, hs, method=fc.decode)

    tx = jopt.build_from_options(_opt(steps), jlr.build_lr_schedule(_opt(steps)))
    jstep = jax.jit(jlatent.make_compressor_train_step(enc, dec, tx))
    jcross = jax.jit(lambda p, lq, gt, zero: dec(p, enc(p, gt)[0] * (1 - zero), enc(p, lq)[1]))
    same = UNet(**comp)
    same.load_state_dict(state_dict_from_flax(flatten(params), keys=latent_unet_flax_keys(len(comp["ch_mult"]))))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(8)
        own = UNet(**comp)
    states = [trainer.create_train_state(net, optimizers.build_from_options(
        _opt(steps), net.parameters(), lr_schedules.build_lr_schedule(_opt(steps))), ema=False) for net in (same, own)]
    step = make_compressor_train_step()

    def cross(net, zero=0.0):
        with torch.no_grad():
            latent, hs = net.encode(torch.from_numpy(va_gt))[0], net.encode(torch.from_numpy(va_lq))[1]
            return net.decode(latent * (1 - zero), hs).numpy()

    js, records = jax_create_train_state(params, tx), []
    for i in range(1, steps + 1):
        idx, ys, xs = (r.integers(0, hi, batch) for hi in (len(tr_gt), size - crop + 1, size - crop + 1))
        lq, gt = (np.stack([img[j, y:y + crop, x:x + crop] for j, y, x in zip(idx, ys, xs)]) for img in (tr_lq, tr_gt))
        js, jm = jstep(js, jnp.asarray(lq), jnp.asarray(gt), None)
        losses = [float(jm["loss"])]
        for k, state in enumerate(states):
            states[k], m = step(state, torch.from_numpy(lq), torch.from_numpy(gt), None)
            losses.append(m["loss"].item())
        if i % (every or max(1, steps // 8)) == 0:
            outs = [(np.asarray(jcross(js.params, va_lq, va_gt, z)), cross(same, z), cross(own, z)) for z in (0.0, 1.0)]
            records.append({"step": i, "loss": losses, "psnr": [_psnr(o, va_gt) for o in outs[0]],
                            "latent": [_psnr(z, np.clip(o, 0, 1)) for o, z in zip(*outs)]})
    return records


def test_compressor_learns_as_jax_from_the_same_weights(tmp_path):
    """A two-level compressor (ch 4), 24 steps at 32 px crops of 64 px
    images: the port's losses within 2% of JAX's at every step recorded and
    its cross-decode PSNR within 0.1 dB (float32 sums in another order
    drift, slowly); the loss falls."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        records = run(str(tmp_path / "data"), 24, size=64, crop=32, batch=4, every=6, comp=TINY)
    finally:
        torch.set_num_threads(threads)
    for rec in records:
        jax_loss, port_loss, _ = rec["loss"]
        assert abs(port_loss - jax_loss) <= 0.02 * jax_loss, rec
        assert abs(rec["psnr"][1] - rec["psnr"][0]) <= 0.1, rec
    assert records[-1]["loss"][0] < records[0]["loss"][0]


def spread(work, iters, seed, package):
    """One ``spread`` run (see the module's docstring) under ``work``: yields
    ``(iteration, val PSNR)`` of each validation up to ``iters``, then
    stops the entry point."""
    import subprocess

    from chip_learn import DEMOS, VAL_LINE, dump_yaml, load_yaml, stage_opt, write_data

    data = os.path.join(work, "data")
    if not os.path.isdir(data):
        write_data("dehaze", data)
    shipped = load_yaml(DEMOS["refusion"][1][0][1])
    opt = stage_opt(shipped, "dehaze", data, os.path.join(work, f"{package}_{seed}"), {})
    opt["train"]["manual_seed"] = seed
    opt["name"] = f"spread_{package}_{seed}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo, "JAX_PLATFORMS": "cpu", "IRSDE_PLATFORM": "cpu"}
    if package == "jax":
        cmd = [sys.executable, os.path.join(repo, "tools", "train.py")]
    else:  # from the JAX task's initial weights (runners._init_params at the train crop)
        setting = opt["network_G"]["setting"]
        comp = {**setting, "ch_mult": tuple(setting["ch_mult"])}
        crop = opt["datasets"]["train"]["GT_size"]
        params = jax.jit(FlaxCompressor(**comp).init)(jax.random.PRNGKey(seed), jnp.zeros((1, crop, crop, 3)))
        pth = os.path.join(work, f"jax_init_{seed}.pth")
        torch.save(state_dict_from_flax(flatten(params), keys=latent_unet_flax_keys(len(comp["ch_mult"]))), pth)
        opt["path"]["pretrain_model_G"] = pth
        cmd = [sys.executable, "-m", "image_restoration_sde_tpu_torch.train", "--device", "cpu"]
    yml = dump_yaml(opt, os.path.join(work, f"{package}_{seed}.yml"))
    with subprocess.Popen([*cmd, f"-opt={yml}"], cwd=repo, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, bufsize=1) as proc:
        try:
            for line in proc.stdout:
                m = VAL_LINE.search(line)
                if m:
                    at = int(m.group(1).replace(",", ""))
                    yield at, float(m.group(2))
                    if at >= iters:
                        break
        finally:
            proc.terminate()


if __name__ == "__main__":
    if sys.argv[1:2] == ["spread"]:
        import json

        iters, seed, package = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
        work = os.path.join(os.environ.get("TMPDIR", "/tmp"), "learn_spread")
        for at, psnr in spread(work, iters, seed, package):
            print(json.dumps({"package": package, "seed": seed, "iter": at, "val_psnr": psnr}), flush=True)
        sys.exit(0)
    bokeh = sys.argv[2:3] == ["bokeh"]
    root = os.path.join(os.environ.get("TMPDIR", "/tmp"), "learn_parity_" + ("bokeh" if bokeh else "dehaze"))
    for rec in run(root, int(sys.argv[1]), comp=BOKEH if bokeh else COMP, bokeh=bokeh):
        print(f"step {rec['step']}: loss JAX {rec['loss'][0]:.5f}, port from its weights {rec['loss'][1]:.5f}, "
              f"port from its own init {rec['loss'][2]:.5f}; cross-decode PSNR {rec['psnr'][0]:.3f} / "
              f"{rec['psnr'][1]:.3f} / {rec['psnr'][2]:.3f} dB; zero latent's decode against the GT's "
              f"{rec['latent'][0]:.3f} / {rec['latent'][1]:.3f} / {rec['latent'][2]:.3f} dB", flush=True)
