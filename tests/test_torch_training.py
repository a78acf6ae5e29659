"""PyTorch port, pixel-space training against the JAX package on the CPU:
K1's and K3's gradients (the autograd Functions whose backward is the plain
composition's) against ``jax.grad`` through the JAX ops; the matching loss;
the LR schedules; Adam, AdamW and Lion against optax; gradient
accumulation; the EMA; one IR-SDE and one denoising-SDE train step against
the JAX package's with the same flax-made weights and the same injected
``(timesteps, x_t)``; remat; checkpoint resume; the train entry point."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_restoration_sde_tpu.models import ConditionalUNet as FlaxUNet
from image_restoration_sde_tpu.models.nafnet import ConditionalNAFNet as FlaxNAFNet
from image_restoration_sde_tpu.ops import layernorm as jln
from image_restoration_sde_tpu.ops import naf_stack as jns
from image_restoration_sde_tpu.sde import IRSDE as JaxIRSDE
from image_restoration_sde_tpu.sde.denoising_sde import DenoisingSDE as JaxDenoisingSDE
from image_restoration_sde_tpu.training import create_train_state as jax_create_train_state
from image_restoration_sde_tpu.training import ema as jema
from image_restoration_sde_tpu.training import losses as jlosses
from image_restoration_sde_tpu.training import lr_schedules as jlr
from image_restoration_sde_tpu.training import optimizers as jopt
from image_restoration_sde_tpu.training import trainer as jtrainer
from image_restoration_sde_tpu_torch import runners
from image_restoration_sde_tpu_torch import train as ptrain
from image_restoration_sde_tpu_torch.data.synthetic import write_pairs
from image_restoration_sde_tpu_torch.models import ConditionalNAFNet, ConditionalUNet, init_params_
from image_restoration_sde_tpu_torch.ops import layernorm as pln
from image_restoration_sde_tpu_torch.ops import naf_stack as pns
from image_restoration_sde_tpu_torch.sde import IRSDE, DenoisingSDE
from image_restoration_sde_tpu_torch.training import checkpoint, ema, losses, lr_schedules, optimizers, trainer
from image_restoration_sde_tpu_torch.utils import nafnet_flax_keys, state_dict_from_flax, unet_flax_keys
from test_torch_nafnet import randomize
from test_torch_nafnet import stack_case  # noqa: F401  (fixture)
from test_torch_nafnet import K as STACK_K
from test_torch_unet import flatten, random_flax_params, unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(got, want) -> float:
    """max|got - want| / max|want|."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


# ------------------------------------------------------- K1 and K3 grads
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_gradient_matches_jax(dtype):
    """x (2, 5, 7, 32), g (32,); cotangent seeded.  The JAX op's custom_vjp
    (its Pallas forward in interpret mode) against the port's Function on
    the CPU.  Bound, each of dx and dg: float32 1e-5 of max|grad| (the same
    composition summed in another order); bfloat16 2e-2 (both sides' bf16
    casts of the f32 gradient; dg sums over 70 rows)."""
    r = np.random.default_rng(0)
    x = (r.standard_normal((2, 5, 7, 32)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.2 * r.standard_normal(32)).astype(np.float32)
    cot = r.standard_normal(x.shape).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    eps = 1e-5 if dtype == "float32" else 1e-3

    def jloss(x_, g_):
        y = jln.channel_layernorm(x_, g_, eps, True, True)
        return jnp.sum(y.astype(jnp.float32) * cot)

    want_dx, want_dg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x, jdt), jnp.asarray(g))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    gt = torch.from_numpy(g).requires_grad_()
    y = pln.channel_layernorm(xt, gt, eps)
    assert y.grad_fn is not None and y.dtype == tdt
    dx, dg = torch.autograd.grad(y, (xt, gt), torch.from_numpy(cot).to(tdt))
    bound = 1e-5 if dtype == "float32" else 2e-2
    assert _rel(dx.float().numpy(), np.asarray(want_dx, np.float32)) <= bound
    assert _rel(dg.numpy(), np.asarray(want_dg)) <= bound


def test_layernorm_gradient_is_the_plain_composition():
    """The Function's gradient equals plain autograd through
    ``channel_layernorm_plain`` bit for bit (its backward is that)."""
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.standard_normal((9, 16)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy((1 + 0.1 * r.standard_normal(16)).astype(np.float32)).requires_grad_()
    cot = torch.from_numpy(r.standard_normal((9, 16)).astype(np.float32))
    got = torch.autograd.grad(pln.channel_layernorm(x, g, 1e-5), (x, g), cot)
    want = torch.autograd.grad(pln.channel_layernorm_plain(x, g, 1e-5), (x, g), cot)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_naf_stack_gradient_matches_jax(stack_case):  # noqa: F811
    """K=4 NAFBlocks, B=2, 8x8, C=32, float32: the gradients of x, temb and
    every block tensor (the time Dense's through ``time_modulation``) of the
    port's Function against ``jax.grad`` through the JAX op (Pallas in
    interpret mode; its custom_vjp's backward is the jnp composition), the
    flax-layout gradients mapped to the torch layout.  Bound, each tensor:
    1e-4 of its max|grad|, float32 sums in another order through 4 blocks."""
    x, temb, params, blocks = stack_case
    cot = np.random.default_rng(11).standard_normal(x.shape).astype(np.float32)

    def jloss(x_, params_, temb_):
        stacked = jns.stack_middle_params(params_, temb_, STACK_K)
        return jnp.sum(jns.naf_stack(x_, stacked, 1e-5, True, True) * cot)

    want_x, want_p, want_t = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jnp.asarray(x), params, jnp.asarray(temb))
    keys = {k: v for k, v in nafnet_flax_keys((), STACK_K, ()).items() if k.startswith("middle_blks.")}
    want_blocks = state_dict_from_flax(flatten(want_p), keys=keys)

    xt = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(temb).requires_grad_()
    leaves = [{k: v.clone().requires_grad_() for k, v in blk.items()} for blk in blocks]
    y = pns.naf_stack(xt, leaves, tt, 1e-5)
    assert y.grad_fn is not None
    names = [f"middle_blks.{i}.{k}" for i, blk in enumerate(leaves) for k in blk]
    tensors = [v for blk in leaves for v in blk.values()]
    got = torch.autograd.grad(y, [xt, tt, *tensors], torch.from_numpy(cot))
    assert _rel(got[0].numpy(), want_x) <= 1e-4
    assert _rel(got[1].numpy(), want_t) <= 1e-4
    for name, grad in zip(names, got[2:]):
        assert _rel(grad.numpy(), want_blocks[name].numpy()) <= 1e-4, name


def test_naf_stack_gradient_is_the_plain_composition(stack_case):  # noqa: F811
    """The Function's gradients equal plain autograd through
    ``naf_stack_plain(x, stack_middle_params(...))`` bit for bit."""
    x, temb, _, blocks = stack_case
    cot = torch.from_numpy(np.random.default_rng(12).standard_normal(x.shape).astype(np.float32))

    def grads(fn):
        xt, tt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(temb).requires_grad_()
        leaves = [{k: v.clone().requires_grad_() for k, v in blk.items()} for blk in blocks]
        y = fn(xt, leaves, tt)
        return torch.autograd.grad(y, [xt, tt, *(v for blk in leaves for v in blk.values())], cot)

    got = grads(lambda a, b, t: pns.naf_stack(a, b, t, 1e-5))
    want = grads(lambda a, b, t: pns.naf_stack_plain(a, pns.stack_middle_params(b, t), 1e-5))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ----------------------------------------------------------------- loss
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_matching_loss_matches_jax(loss_type, weighted):
    """Bound: 1e-6 of the loss (float32 means over 3072 elements)."""
    r = np.random.default_rng(2)
    pred, target = (r.standard_normal((4, 8, 8, 3)).astype(np.float32) for _ in range(2))
    w = r.random(4).astype(np.float32) if weighted else None
    want = float(jlosses.matching_loss(jnp.asarray(pred), jnp.asarray(target), loss_type,
                                       None if w is None else jnp.asarray(w)))
    got = losses.matching_loss(torch.from_numpy(pred), torch.from_numpy(target), loss_type,
                               None if w is None else torch.from_numpy(w)).item()
    assert abs(got - want) <= 1e-6 * abs(want)
    lp = losses.perceptual_matching_loss(torch.from_numpy(pred), torch.from_numpy(target), loss_type,
                                         None if w is None else torch.from_numpy(w),
                                         lpips_weight=0.5, lpips_fn=lambda a, b: torch.tensor(2.0))
    assert abs(lp.item() - (got + 1.0)) <= 1e-6 * abs(got + 1.0)


# ------------------------------------------------------------ schedules
SCHEDULES = {
    "multistep": {"lr_G": 1e-4, "lr_scheme": "MultiStepLR", "lr_steps": [10, 20, 30], "lr_gamma": 0.5},
    "multistep_restarts": {"lr_G": 2e-4, "lr_scheme": "MultiStepLR", "lr_steps": [5, 15, 25], "lr_gamma": 0.5,
                           "restarts": [12, 22], "restart_weights": [0.5, 0.25]},
    "multistep_warmup": {"lr_G": 1e-4, "lr_scheme": "MultiStepLR", "lr_steps": [10], "lr_gamma": 0.5,
                         "warmup_iter": 6},
    "true_cosine": {"lr_G": 3e-5, "lr_scheme": "TrueCosineAnnealingLR", "niter": 40, "eta_min": 1e-7},
    "true_cosine_warmup": {"lr_G": 3e-5, "lr_scheme": "TrueCosineAnnealingLR", "niter": 40, "eta_min": 1e-7,
                           "warmup_iter": 5},
    "cosine_restart": {"lr_G": 4e-4, "lr_scheme": "CosineAnnealingLR_Restart", "T_period": [10, 15, 15],
                       "restarts": [10, 25], "restart_weights": [1.0, 0.5], "eta_min": 1e-7},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_jax(name):
    """Steps 0..44, across milestones, restarts and warmup.  Bound: 1e-6 of
    the value (float32 on both sides; cos rounds differently by an ulp)."""
    opt = SCHEDULES[name]
    jsched, psched = jlr.build_lr_schedule(opt), lr_schedules.build_lr_schedule(opt)
    for step in range(45):
        want, got = float(jsched(jnp.asarray(step))), psched(step)
        assert abs(got - want) <= 1e-6 * abs(want) + 1e-12, (step, got, want)


# ----------------------------------------------------------- optimizers
OPTIMIZERS = {
    "adam": {"optimizer": "Adam", "beta1": 0.9, "beta2": 0.99},
    "adam_l2": {"optimizer": "Adam", "beta1": 0.9, "beta2": 0.99, "weight_decay_G": 0.01},
    "adamw": {"optimizer": "AdamW", "beta1": 0.9, "beta2": 0.999, "weight_decay_G": 0.01},
    "lion": {"optimizer": "Lion", "beta1": 0.9, "beta2": 0.99},
    "lion_decay": {"optimizer": "Lion", "beta1": 0.9, "beta2": 0.99, "weight_decay_G": 0.1},
}


def _optimizer_pair(cfg, params0, grads_seq, sched_opt):
    """The JAX package's optax optimizer and the port's, from the same
    options, over ``grads_seq``; returns (jax params, port params, port
    optimizer) after the last call."""
    jsched, psched = jlr.build_lr_schedule(sched_opt), lr_schedules.build_lr_schedule(sched_opt)
    tx = jopt.build_from_options(cfg, jsched)
    jp = {"w": jnp.asarray(params0)}
    state = tx.init(jp)
    pw = torch.nn.Parameter(torch.from_numpy(params0.copy()))
    popt = optimizers.build_from_options(cfg, [pw], psched)
    for g in grads_seq:
        updates, state = tx.update({"w": jnp.asarray(g)}, state, jp)
        jp = optax.apply_updates(jp, updates)
        pw.grad = torch.from_numpy(g.copy())
        popt.step()
    return np.asarray(jp["w"]), pw.detach().numpy(), popt


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """3 updates of a (64, 33) parameter with seeded gradients, the LR from
    a MultiStepLR schedule with a milestone at 1 (so updates 0 and 1 read
    different LRs: the count starts at 0).  Bound: elementwise 1e-6, float32
    rounding of parameters of size ~1 (the same formulas; no gradient
    element lies near 0, where Adam's and Lion's first steps flip)."""
    r = np.random.default_rng(3)
    p0 = r.standard_normal((64, 33)).astype(np.float32)
    grads = [np.sign(g) * (0.1 + np.abs(g)) for g in (r.standard_normal((64, 33)).astype(np.float32)
                                                      for _ in range(3))]
    sched = {"lr_G": 1e-2, "lr_scheme": "MultiStepLR", "lr_steps": [1], "lr_gamma": 0.5}
    want, got, popt = _optimizer_pair({**OPTIMIZERS[name]}, p0, grads, sched)
    assert popt.updates == 3
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(got - p0).max() > 1e-3  # it moved


def test_lion_first_update_reads_the_warmup_lr_at_zero():
    """Warmup gives lr 0 at count 0: optax's lion leaves the parameters as
    they are on the first update and moves them on the second, and so does
    the port's."""
    r = np.random.default_rng(4)
    p0 = r.standard_normal(50).astype(np.float32)
    grads = [r.standard_normal(50).astype(np.float32) + 3 for _ in range(2)]
    sched = {"lr_G": 1e-2, "lr_scheme": "TrueCosineAnnealingLR", "niter": 100, "warmup_iter": 4}
    want1, got1, _ = _optimizer_pair(OPTIMIZERS["lion"], p0, grads[:1], sched)
    assert np.array_equal(want1, p0) and np.array_equal(got1, p0)
    want2, got2, _ = _optimizer_pair(OPTIMIZERS["lion"], p0, grads, sched)
    assert np.abs(got2 - want2).max() <= 1e-6 and np.abs(got2 - p0).max() > 1e-4


def test_grad_accum_matches_the_big_batch_and_optax_multisteps():
    """``grad_accum: 2``: two calls with the halves of a batch make one Adam
    update with the mean of their gradients, which for a mean loss is the
    whole batch's gradient; the first call leaves the parameters as they
    are.  Held against one update on the whole batch (bound 1e-6: the mean
    of two means against one mean) and against optax.MultiSteps (1e-6)."""
    r = np.random.default_rng(5)
    xs = r.standard_normal((8, 16)).astype(np.float32)
    ys = r.standard_normal(8).astype(np.float32)
    w0 = r.standard_normal(16).astype(np.float32)
    sched = lr_schedules.build_lr_schedule({"lr_G": 1e-2, "lr_scheme": "MultiStepLR", "lr_steps": []})
    cfg = {"optimizer": "Adam", "beta1": 0.9, "beta2": 0.99}

    def grad(w, x, y):
        w = w.detach().requires_grad_()
        loss = ((torch.from_numpy(x) @ w - torch.from_numpy(y)) ** 2).mean()
        return torch.autograd.grad(loss, w)[0]

    acc_w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    acc = optimizers.build_from_options({**cfg, "grad_accum": 2}, [acc_w], sched)
    big_w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    big = optimizers.build_from_options(cfg, [big_w], sched)
    for i in range(2):  # two effective updates
        for half in (slice(0, 4), slice(4, 8)):
            acc_w.grad = grad(acc_w, xs[half], ys[half])
            updated = acc.step()
            assert updated == (half.start == 4)
            if half.start == 0:
                assert acc.updates == i
        big_w.grad = grad(big_w, xs, ys)
        big.step()
        assert torch.allclose(acc_w, big_w, rtol=0, atol=1e-6)

    tx = jopt.build_from_options({**cfg, "grad_accum": 2}, jlr.build_lr_schedule(
        {"lr_G": 1e-2, "lr_scheme": "MultiStepLR", "lr_steps": []}))
    jw = jnp.asarray(w0)
    state = tx.init(jw)
    jgrad = jax.grad(lambda w, x, y: jnp.mean((x @ w - y) ** 2))
    for _ in range(2):
        for half in (slice(0, 4), slice(4, 8)):
            updates, state = tx.update(jgrad(jw, xs[half], ys[half]), state, jw)
            jw = optax.apply_updates(jw, updates)
    assert np.abs(acc_w.detach().numpy() - np.asarray(jw)).max() <= 1e-6


# ------------------------------------------------------------------ EMA
def test_ema_matches_jax_over_250_calls():
    """250 ``update`` calls with the default config (update every 10, plain
    copies through step 100, then the decay ramp), the parameters moving
    between calls.  Bound: elementwise 1e-6 (float32 blends of values of
    size ~1; the decays agree to an ulp)."""
    r = np.random.default_rng(6)
    p = {"a": r.standard_normal((5, 7)).astype(np.float32), "b": r.standard_normal(3).astype(np.float32)}
    jstate = jema.init({k: jnp.asarray(v) for k, v in p.items()})
    pema = ema.EMA({k: torch.from_numpy(v) for k, v in p.items()})
    jupdate = jax.jit(lambda s, params: jema.update(s, params))
    for _ in range(250):
        p = {k: v + 0.05 * r.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
        jstate = jupdate(jstate, {k: jnp.asarray(v) for k, v in p.items()})
        pema.update({k: torch.from_numpy(v) for k, v in p.items()})
    assert pema.step == int(jstate.step) == 250
    for k in p:
        assert np.abs(pema.params[k].numpy() - np.asarray(jstate.params[k])).max() <= 1e-6
    for step in (0, 100, 101, 102, 150, 1000):
        want = float(jema.current_decay(jnp.asarray(step), jema.EmaConfig()))
        assert abs(ema.current_decay(step, ema.EmaConfig()) - want) <= 1e-7


# ------------------------------------------------------ train steps
class Injected:
    """An SDE whose ``generate_random_states`` returns the given
    ``(timesteps, x_t)``; every other attribute is the wrapped SDE's."""

    def __init__(self, sde, timesteps, xt):
        self._sde, self._states = sde, (timesteps, xt)

    def __getattr__(self, name):
        return getattr(self._sde, name)

    def generate_random_states(self, *args):
        return self._states


TRAIN_OPT = {"optimizer": "Adam", "lr_G": 1e-4, "lr_scheme": "MultiStepLR", "lr_steps": [100], "beta1": 0.9,
             "beta2": 0.99}
LR = TRAIN_OPT["lr_G"]


def _keep_grads():
    """An optax transformation that passes the grads on and keeps them."""
    return optax.GradientTransformation(
        lambda params: {"g": jax.tree.map(jnp.zeros_like, params)},
        lambda grads, state, params=None: (grads, {"g": grads}),
    )


def _jax_step(make, jsde, apply, params, args, **kw):
    """(loss, grads, params after one Adam step, EMA after it) of the JAX
    package's train step."""
    tx = optax.chain(_keep_grads(), jopt.build_from_options(TRAIN_OPT, jlr.build_lr_schedule(TRAIN_OPT)))
    state, metrics = jax.jit(make(jsde, apply, tx, **kw))(jax_create_train_state(params, tx), *args,
                                                          jax.random.PRNGKey(0))
    grads = state.opt_state[0]["g"]
    return float(metrics["loss"]), flatten(grads), flatten(state.params), flatten(state.ema.params)


def _port_step(make, psde, net, args, **kw):
    state = trainer.create_train_state(net, optimizers.build_from_options(
        TRAIN_OPT, net.parameters(), lr_schedules.build_lr_schedule(TRAIN_OPT)))
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    state, metrics = make(psde, **kw)(state, *args, torch.Generator().manual_seed(0))
    grads = {k: v.grad.clone() for k, v in net.named_parameters()}
    assert state.step == 1 and state.ema.step == 1 and state.optimizer.updates == 1
    assert any(not torch.equal(before[k], v) for k, v in net.named_parameters())
    return metrics["loss"].item(), grads, dict(net.named_parameters()), state.ema.params


def _hold(port, jax_out, keys):
    """Loss within 1e-4 of itself: the nets agree to ~1e-6, but at small t
    the posterior mean divides by 1 - exp(-2 theta_cumsum dt), which cancels
    in float32, and XLA's fused evaluation of the target rounds otherwise
    (the JAX package's own jitted and eager targets differ by ~3e-5 of their
    max at t = 3).  Each gradient within 2e-4 of its tensor's max|grad|
    (float32 convolutions and sums in another order, forward and backward,
    on top of that); the updated parameters and
    the EMA (a copy on its first call) elementwise within 2 lr (Adam's first
    step is lr g/(|g| + eps): a gradient element near 0 whose sign differs
    between the two moves by up to 2 lr); the EMA only where the port's
    state keeps one (``ema_params`` not None)."""
    loss, grads, params, ema_params = port
    jloss, jgrads, jparams, jema_params = jax_out
    to_torch = {k: state_dict_from_flax(tree, keys=keys) for k, tree in
                (("g", jgrads), ("p", jparams), ("e", jema_params))}
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    for k, g in grads.items():
        want = to_torch["g"][k].numpy()
        if np.abs(want).max() > 0:
            assert _rel(g.numpy(), want) <= 2e-4, k
        assert np.abs(params[k].detach().numpy() - to_torch["p"][k].numpy()).max() <= 2 * LR, k
        if ema_params is not None:
            assert np.abs(ema_params[k].numpy() - to_torch["e"][k].numpy()).max() <= 2 * LR, k


def test_train_step_matches_jax():
    """ConditionalUNet nf=8, depth=2, batch 2 at 16 px, L1, Adam; the same
    flax-made weights, batch and injected states on both sides."""
    weights = random_flax_params(2, 8, seed=7)
    r = np.random.default_rng(8)
    lq, gt = (r.random((2, 16, 16, 3), np.float32) for _ in range(2))
    t = np.array([3, 71], np.int32).reshape(2, 1, 1, 1)
    xt = (gt + 0.3 * r.standard_normal(gt.shape)).astype(np.float32)
    jsde = Injected(JaxIRSDE.create(max_sigma=10, T=100, schedule="cosine", eps=0.005), jnp.asarray(t), jnp.asarray(xt))
    psde = Injected(IRSDE.create(10, 100, "cosine", 0.005, device="cpu"), torch.from_numpy(t).long(),
                    torch.from_numpy(xt))
    fnet = FlaxUNet(in_nc=3, out_nc=3, nf=8, depth=2)
    want = _jax_step(jtrainer.make_train_step, jsde, fnet.apply, unflatten(weights), (jnp.asarray(lq), jnp.asarray(gt)))
    net = ConditionalUNet(in_nc=3, out_nc=3, nf=8, depth=2)
    net.load_state_dict(state_dict_from_flax(weights, 2))
    got = _port_step(trainer.make_train_step, psde, net, (torch.from_numpy(lq), torch.from_numpy(gt)))
    _hold(got, want, unet_flax_keys(2))


NAF = dict(img_channel=3, width=8, enc_blk_nums=(1, 4), middle_blk_num=1, dec_blk_nums=(1, 1))


def test_denoising_train_step_matches_jax(monkeypatch):
    """ConditionalNAFNet(conditional=False), width 8, enc (1, 4): its
    4-block level fuses on both sides (the port's K3 operator; flax's Pallas
    kernel in interpret mode, custom_vjp); DenoisingSDE (max_sigma 70, T
    1000), sigma^2-weighted L1, Adam, batch 2 at 16 px."""
    monkeypatch.setenv("IRSDE_NAF_FUSE_INTERPRET", "1")
    fnet = FlaxNAFNet(**NAF, conditional=False)
    x0 = jnp.zeros((1, 16, 16, 3))
    weights = randomize(flatten(jax.jit(lambda k, x: fnet.init(k, x, None, jnp.array([1.0])))(
        jax.random.PRNGKey(0), x0)), seed=9)
    r = np.random.default_rng(10)
    gt = r.random((2, 16, 16, 3), np.float32)
    t = np.array([40, 800], np.int32).reshape(2, 1, 1, 1)
    xt = (gt + 0.2 * r.standard_normal(gt.shape)).astype(np.float32)
    jsde = Injected(JaxDenoisingSDE.create(max_sigma=70, T=1000, schedule="cosine"), jnp.asarray(t), jnp.asarray(xt))
    psde = Injected(DenoisingSDE.create(70, 1000, "cosine", device="cpu"), torch.from_numpy(t).long(),
                    torch.from_numpy(xt))
    calls = {"jax": 0, "port": 0}
    j_orig, p_orig = jns.naf_stack, pns.OP

    def j_count(*a):
        calls["jax"] += 1
        return j_orig(*a)

    def p_count(*a):
        calls["port"] += 1
        return p_orig(*a)

    monkeypatch.setattr(jns, "naf_stack", j_count)
    monkeypatch.setattr(pns, "OP", p_count)
    want = _jax_step(jtrainer.make_denoising_train_step, jsde, lambda p, x, tv: fnet.apply(p, x, None, tv),
                     unflatten(weights), (jnp.asarray(gt),))
    net = ConditionalNAFNet(**NAF, conditional=False)
    keys = nafnet_flax_keys(NAF["enc_blk_nums"], NAF["middle_blk_num"], NAF["dec_blk_nums"])
    net.load_state_dict(state_dict_from_flax(weights, keys=keys))
    got = _port_step(trainer.make_denoising_train_step, psde, net, (torch.from_numpy(gt),))
    assert calls["jax"] >= 1 and calls["port"] == 1
    _hold(got, want, keys)


def test_remat_reaches_torch_checkpoint(monkeypatch):
    """``remat=True`` (and ``train.remat: true`` through the runner) wraps
    the score net in ``torch.utils.checkpoint``; the step's loss and
    gradients equal the step without it bit for bit."""
    seen = []
    orig = torch.utils.checkpoint.checkpoint

    def spy(fn, *args, **kw):
        seen.append(fn)
        return orig(fn, *args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    r = np.random.default_rng(13)
    lq, gt = (torch.from_numpy(r.random((2, 8, 8, 3), np.float32)) for _ in range(2))
    sde = IRSDE.create(10, 100, "cosine", 0.005, device="cpu")
    out = {}
    for remat in (False, True):
        torch.manual_seed(0)
        net = ConditionalUNet(nf=8, depth=1)
        state = trainer.create_train_state(net, optimizers.build_from_options(
            TRAIN_OPT, net.parameters(), lr_schedules.build_lr_schedule(TRAIN_OPT)))
        _, m = trainer.make_train_step(sde, remat=remat)(state, lq, gt, torch.Generator().manual_seed(1))
        out[remat] = (m["loss"], [p.grad for p in net.parameters()])
    assert len(seen) == 1 and isinstance(seen[0], ConditionalUNet)
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))
    opt = runners.options.dict_to_nonedict({"train": {**TRAIN_OPT, "remat": True, "loss_type": "l1"}})
    assert runners._Base._loss_kwargs(type("T", (), {"train_opt": opt["train"]})())["remat"] is True


def test_in_place_updates_keep_k3_pointers():
    """K3 reads a fused level's weights through a device table of their data
    pointers, cached by those pointers.  An optimizer step, an EMA update
    and ``load_state_dict`` (the EMA's weights swapped in) write into the
    same storage, so the table stays valid."""
    net = init_params_(ConditionalNAFNet(**NAF), torch.Generator().manual_seed(0))  # beta, gamma != 0
    level = net.encoders[1]
    x = torch.zeros(1, 4, 4, 16)

    def pointers():
        return pns._block_tensors([blk.tensors() for blk in level], x)

    before = pointers()
    state = trainer.create_train_state(net, optimizers.build_from_options(
        {**TRAIN_OPT, "optimizer": "Lion"}, net.parameters(), lr_schedules.build_lr_schedule(TRAIN_OPT)))
    r = np.random.default_rng(14)
    lq, gt = (torch.from_numpy(r.random((2, 16, 16, 3), np.float32)) for _ in range(2))
    sde = IRSDE.create(50, 100, "cosine", 0.005, device="cpu")
    weights = level[0].conv1.weight.detach().clone()
    trainer.make_train_step(sde)(state, lq, gt, torch.Generator().manual_seed(2))
    assert not torch.equal(weights, level[0].conv1.weight) and pointers() == before
    net.load_state_dict(checkpoint.ema_state_dict(state))
    assert pointers() == before


# -------------------------------------------------- runners and driver
def _tiny_yaml(root, name, niter, extra_train="", network=None, dataset="LQGT", distortion="derain",
               resume="null"):
    data = os.path.join(root, "data")
    if not os.path.isdir(data):
        write_pairs(os.path.join(data, "train"), 4, seed=0, min_size=20, max_size=28)
        write_pairs(os.path.join(data, "val"), 2, seed=1, min_size=16, max_size=24)
    lq = f", dataroot_LQ: {data}/train/LQ, LR_size: 16" if dataset == "LQGT" else ""
    vlq = f", dataroot_LQ: {data}/val/LQ" if dataset == "LQGT" else ""
    network = network or "{which_model_G: ConditionalUNet, setting: {in_nc: 3, out_nc: 3, nf: 8, depth: 2}}"
    path = os.path.join(root, f"{name}.yml")
    with open(path, "w") as f:
        f.write(f"""name: {name}
use_tb_logger: false
model: denoising
distortion: {distortion}
sde: {{max_sigma: 10, T: 100, schedule: cosine, eps: 0.005, sample_T: 3}}
degradation: {{sigma: 25, noise_type: G, scale: 4}}
datasets:
  train: {{name: train, mode: {dataset}, dataroot_GT: {data}/train/GT{lq}, n_workers: 2, batch_size: 2,
    GT_size: 16, use_flip: true, use_rot: true, color: RGB}}
  val: {{name: val, mode: {dataset}, dataroot_GT: {data}/val/GT{vlq}, max_images: 1}}
network_G: {network}
path: {{root: {root}/run, pretrain_model_G: null, strict_load: true, resume_state: {resume}}}
train: {{optimizer: Adam, lr_G: 0.0001, lr_scheme: MultiStepLR, beta1: 0.9, beta2: 0.99, niter: {niter},
  lr_steps: [2], lr_gamma: 0.5, loss_type: l1, weight: 1.0, manual_seed: 0, val_freq: 2{extra_train}}}
logger: {{print_freq: 1, save_checkpoint_freq: 2}}
""")
    return path


def test_train_entry_point_runs_three_steps_on_the_cpu(tmp_path):
    """``python -m image_restoration_sde_tpu_torch.train -opt=<yml> --device
    cpu``: 3 steps on synthetic folders, validation at step 2, checkpoints at
    2 and 3 in the reference's names, a finite loss in the log."""
    yml = _tiny_yaml(str(tmp_path), "cli", niter=3)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-m", "image_restoration_sde_tpu_torch.train", f"-opt={yml}",
                           "--device", "cpu"], cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    root = tmp_path / "run" / "experiments" / tmp_path.parent.name / "cli"  # task: the YAML's grandparent
    assert sorted(os.listdir(root / "models")) == ["2_G.pth", "3_G.pth", "lastest_EMA.pth"]
    assert sorted(os.listdir(root / "training_state")) == ["2.state", "3.state"]
    assert (root / "val_images" / "2_0.png").is_file()
    losses_logged = [float(line.rsplit("loss: ", 1)[1]) for line in proc.stderr.splitlines() if "loss: " in line]
    assert len(losses_logged) == 3 and all(np.isfinite(losses_logged))
    sd = checkpoint.load_params(str(root / "models" / "3_G.pth"))
    ConditionalUNet(nf=8, depth=2).load_state_dict(sd)


def test_train_entry_point_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.main(["-opt", "unused.yml"])


@pytest.mark.parametrize("kind", ["pixel", "denoising"])
def test_resume_is_bit_equal_on_the_cpu(tmp_path, kind):
    """Train 4 steps, saving at 2 and 4; resume from 2 and train to 4: the
    net, the EMA, the optimizer's moments and the generator end bit-equal
    to the uninterrupted run's (the loader restarts at step 2's batch).
    ``denoising``: the GaussianDenoisingTask on GT-only folders, its net the
    unconditional NAFNet with a fused level (K3's Function)."""
    root = str(tmp_path)
    kw = {}
    if kind == "denoising":
        kw = dict(dataset="GT", distortion="denoising",
                  network="{which_model_G: ConditionalNAFNet, setting: {width: 8, enc_blk_nums: [1, 4], "
                          "middle_blk_num: 1, dec_blk_nums: [1, 1]}}")
    first = ptrain.train(_tiny_yaml(root, "run", 4, **kw), "cpu")
    exp = os.path.join(root, "run", "experiments", tmp_path.parent.name, "run")
    want = {k: v.clone() for k, v in first.net.state_dict().items()}
    want_ema = {k: v.clone() for k, v in first.ema.params.items()}
    want_opt = first.optimizer.state_dict()
    want_gen = torch.load(os.path.join(exp, "training_state", "4.state"), weights_only=True)["generator"]
    resumed = ptrain.train(_tiny_yaml(root, "run", 4, resume=os.path.join(exp, "training_state", "2.state"), **kw),
                           "cpu")
    assert resumed.step == 4 and resumed.ema.step == 4 and resumed.optimizer.updates == 4
    assert all(torch.equal(v, want[k]) for k, v in resumed.net.state_dict().items())
    assert all(torch.equal(v, want_ema[k]) for k, v in resumed.ema.params.items())
    got_opt = resumed.optimizer.state_dict()["inner"]["state"]
    for i, st in want_opt["inner"]["state"].items():
        assert all(torch.equal(st[k], got_opt[i][k]) for k in ("exp_avg", "exp_avg_sq"))
    got_gen = torch.load(os.path.join(exp, "training_state", "4.state"), weights_only=True)["generator"]
    assert torch.equal(got_gen, want_gen)
    if kind == "denoising":
        assert isinstance(resumed.net, ConditionalNAFNet) and not resumed.net.conditional


def test_validation_leaves_no_inference_tensors(tmp_path):
    """Validation runs the sampler under ``torch.inference_mode``; the net's
    parameters stay ordinary tensors, in train mode, and the next step
    trains."""
    opt = runners.options.dict_to_nonedict(runners.options.parse(_tiny_yaml(str(tmp_path), "val", 2)))
    task = runners.build_task(opt, 0, "cpu")
    from image_restoration_sde_tpu_torch.data import create_dataloader, create_dataset

    loader = create_dataloader(create_dataset(opt["datasets"]["val"]), opt["datasets"]["val"])
    vm = task.validate(task.state, loader, torch.Generator().manual_seed(0), str(tmp_path / "v"), 1)
    assert np.isfinite(vm["psnr"]) and task.net.training
    trees = task.params_trees(task.state)
    assert set(trees) == {"G", "EMA"} and set(trees["G"]) == set(trees["EMA"]) == set(task.net.state_dict())
    assert not any(p.is_inference() for p in task.net.parameters())
    train_loader = create_dataloader(create_dataset(opt["datasets"]["train"]), opt["datasets"]["train"])
    batches = iter(train_loader)
    state, m = task.step(task.state, next(batches), torch.Generator().manual_seed(1))
    batches.close()
    assert torch.isfinite(m["loss"]) and state.step == 1


TRAIN_CONFIGS = sorted(
    os.path.join(d, f) for d in (os.path.join(REPO, "configs", t, "train") for t in os.listdir(os.path.join(REPO, "configs")))
    if os.path.isdir(d) for f in os.listdir(d))


@pytest.mark.parametrize("path", TRAIN_CONFIGS, ids=lambda p: "/".join(p.split(os.sep)[-3::2]))
def test_build_task_for_every_train_config(path):
    """Every train YAML of configs/, its nets cut (widths to 8, a
    compressor's ch to 4, the DiT to hidden 64 and depth 1, which
    ``DiT_L_2`` takes from its setting): the pixel tasks build their
    runner, net and SDE (the denoising ones the unconditional net; the
    stereo one the SCAM NAFNet; the sr ones despite the ``upscale`` that
    ``options.parse`` adds); ``model: latent`` the compressor task,
    ``latent_denoising`` the latent task with its frozen compressor (the
    bokeh task and net on a Bokeh dataset)."""
    opt = runners.options.parse(path)
    for key in ("network_G", "network_L"):
        setting = (opt.get(key) or {}).get("setting") or {}
        for name, cut in (("nf", 8), ("width", 8), ("ch", 4)):
            if name in setting:
                setting[name] = cut
        if "DiT" in str(opt.get(key, {}).get("which_model")):
            setting.update(hidden_size=64, depth=1)
    opt = runners.options.dict_to_nonedict(opt)
    task = runners.build_task(opt, 0, "cpu")
    assert task.state.optimizer.inner.__class__.__name__ == opt["train"]["optimizer"]
    which = runners.options.network_setting(opt)[0]
    if opt["model"] == "latent":
        assert isinstance(task, runners.CompressorTask) and type(task.net).__name__ == "UNet"
        return
    if opt["model"] == "latent_denoising":
        bokeh = "bokeh" in path
        assert type(task) is (runners.BokehLatentDiffusionTask if bokeh else runners.LatentDiffusionTask)
        assert type(task.net).__name__ == ("BokehConditionalNAFNet" if bokeh else which.split("_")[0])  # DiT_L_2: DiT
        assert type(task.compressor).__name__ == "UNet"
        return
    denoising = runners.effective_distortion(opt) == "denoising"
    assert isinstance(task, runners.GaussianDenoisingTask if denoising else runners.PixelDiffusionTask)
    assert getattr(task.net, "conditional", True) is not denoising
    assert type(task.net).__name__ == ("StereoConditionalNAFNet" if "stereo" in path else which)


def test_build_task_refuses_latent_tasks():
    """``build_task`` from option dicts: ``model: latent`` gives the
    compressor task (its net the compressor, no EMA), ``latent_denoising``
    the latent task (an EMA; its compressor frozen: no grad, outside the
    optimizer) or, on a Bokeh dataset, the bokeh task (the bokeh NAFNet, no
    EMA, only ``G`` to save); a model type the port does not know raises."""
    comp = {"which_model": "UNet", "setting": {"in_ch": 3, "out_ch": 3, "ch": 4, "ch_mult": [1, 2], "embed_dim": 4}}
    naf = {"which_model": "ConditionalNAFNet", "setting": {"img_channel": 4, "width": 8, "enc_blk_nums": [1],
                                                          "middle_blk_num": 1, "dec_blk_nums": [1]}}

    def opt(model, mode="LQGT"):
        return runners.options.dict_to_nonedict({
            "model": model, "distortion": "dehazing", "degradation": None, "datasets": {"train": {"mode": mode}},
            "network_G": comp if model == "latent" else naf, "network_L": comp, "train": TRAIN_OPT, "path": {},
            "sde": {"max_sigma": 50, "T": 100, "schedule": "cosine", "eps": 0.005}})

    task = runners.build_task(opt("latent"), 0, "cpu")
    assert isinstance(task, runners.CompressorTask) and task.net.__class__.__name__ == "UNet"
    assert task.state.ema is None and set(task.params_trees(task.state)) == {"G"}
    task = runners.build_task(opt("latent_denoising"), 0, "cpu")
    assert type(task) is runners.LatentDiffusionTask and isinstance(task.net, ConditionalNAFNet)
    assert task.state.ema is not None and set(task.params_trees(task.state)) == {"G", "EMA"}
    assert not any(p.requires_grad for p in task.compressor.parameters())
    assert {id(p) for p in task.state.optimizer.params} == {id(p) for p in task.net.parameters()}
    task = runners.build_task(opt("latent_denoising", "BokehLQGT"), 0, "cpu")
    assert isinstance(task, runners.BokehLatentDiffusionTask) and type(task.net).__name__ == "BokehConditionalNAFNet"
    assert task.state.ema is None and set(task.params_trees(task.state)) == {"G"}
    with pytest.raises(NotImplementedError, match="model type"):
        runners.build_task(opt("latent_unknown"), 0, "cpu")
