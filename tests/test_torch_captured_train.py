"""PyTorch port, the captured train step (``training/captured.py``) on the
CPU.

The split draws: ``draw_states`` then ``compose_states`` equal
``generate_random_states`` bit for bit and leave the generator where it
does.  The capture flow through a stand-in backend (its capture runs
nothing that stays, as a real one records and runs nothing; its "graph"
replays by running the recorded step again): each of the five step makers
twelve steps against its eager step, bit for bit (losses, parameters,
optimizer state, EMA, generator), an LR milestone and an EMA round among
them, and gradient accumulation; the guard (a replaced parameter, a loaded
optimizer state), no fallback, the launch accounting; and one step of the
capture flow against the JAX package's jitted step."""

import copy
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_restoration_sde_tpu.sde import IRSDE as JaxIRSDE
from image_restoration_sde_tpu.training import create_train_state as jax_create_train_state
from image_restoration_sde_tpu.training import lr_schedules as jlr
from image_restoration_sde_tpu.training import optimizers as jopt
from image_restoration_sde_tpu.training import trainer as jtrainer
from image_restoration_sde_tpu_torch import kernels
from image_restoration_sde_tpu_torch.models import BokehConditionalNAFNet, ConditionalNAFNet, ConditionalUNet, UNet, \
    init_params_
from image_restoration_sde_tpu_torch.ops import layernorm as pln
from image_restoration_sde_tpu_torch.sde import DenoisingSDE, IRSDE, rng
from image_restoration_sde_tpu_torch.training import lr_schedules, make_compressor_train_step, \
    make_denoising_train_step, make_latent_train_step, make_train_step, optimizers, trainer
from image_restoration_sde_tpu_torch.training.captured import StepGraphs, _Saved
from image_restoration_sde_tpu_torch.utils import unet_flax_keys
from test_torch_training import TRAIN_OPT, Injected, _hold, _keep_grads
from test_torch_captured import pair  # noqa: F401  (fixture)
from test_torch_unet import flatten

HW, B, STEPS = 16, 2, 12
# the LR halves at update 2; the EMA (update_every 10) copies at calls 1 and 11
TRAIN = {"lr_G": 1e-3, "lr_scheme": "MultiStepLR", "lr_steps": [2], "lr_gamma": 0.5, "beta1": 0.9, "beta2": 0.99}
UNET = dict(in_nc=3, out_nc=3, nf=8, depth=2)
COMP = dict(in_ch=3, out_ch=3, ch=4, ch_mult=(1, 2), embed_dim=4)
NAF = dict(img_channel=4, width=8, enc_blk_nums=(1, 4), middle_blk_num=1, dec_blk_nums=(1, 1))
BOKEH = dict(img_channel=4, width=8, enc_blk_nums=(1, 2), middle_blk_num=1, dec_blk_nums=(1, 1))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class StandIn:
    """A train-step capture backend on the CPU.  Its capture runs the step
    and puts back what it wrote (a real capture records the step and runs
    none of it), leaving each ``grad`` at the step's gradient tensors, as a
    captured backward leaves them; its replay runs the step again, writing
    the step's outputs and gradients into the captured ones, its kernel
    calls counting nothing."""

    def __init__(self, state, fail=False):
        self.state, self.fail, self.captures = state, fail, 0

    def pool(self, device):
        return ("pool", str(device))

    def warm(self, device, fn):
        fn()

    def capture(self, device, pool, fn):
        if self.fail:
            raise RuntimeError("capture failed")
        self.captures += 1
        params = self.state.optimizer.params
        saved = _Saved(self.state)
        out = fn()
        grads = [p.grad for p in params]
        saved.restore()
        for p, g in zip(params, grads):
            p.grad = g

        class Graph:
            def replay(self):
                with kernels.recording():
                    new = fn()
                for o, n in zip(out, new):
                    o.copy_(n)
                for p, g in zip(params, grads):
                    g.copy_(p.grad)

        return Graph(), out

    def pool_bytes(self, device, pool):
        return 0


def _seeded(net, seed):
    return init_params_(net, torch.Generator().manual_seed(seed)).train()


def _images(r, channels=3):
    lq = torch.from_numpy(r.random((B, HW, HW, channels), np.float32))
    return lq, (lq - 0.2 * torch.from_numpy(r.random(lq.shape, np.float32))).clamp(0, 1)


def _case(name):
    """(step maker taking ``capture``, fresh net, optimizer, keeps an EMA,
    every_k, batch of step i) of a case."""
    def pixel(i):
        return _images(np.random.default_rng(100 + i))

    def latent(i, lens=False):
        lq, gt = _images(np.random.default_rng(200 + i))
        if not lens:
            return lq, gt
        r = np.random.default_rng(300 + i)
        return lq, gt, tuple(torch.from_numpy((r.random(B) * s).astype(np.float32)) for s in (160.0, 160.0, 1.0))

    sde = IRSDE.create(10, 100, "cosine", 0.005, device="cpu")
    if name in ("irsde", "irsde_accum"):
        return (lambda c: make_train_step(sde, capture=c), lambda: _seeded(ConditionalUNet(**UNET), 1), "Adam", True,
                2 if name == "irsde_accum" else 1, pixel)
    if name == "denoising":
        dsde = DenoisingSDE.create(70, 1000, "cosine", device="cpu")
        return (lambda c: make_denoising_train_step(dsde, capture=c),
                lambda: _seeded(ConditionalUNet(**UNET, conditional=False), 2), "AdamW", True, 1,
                lambda i: pixel(i)[1:])
    if name == "compressor":
        return lambda c: make_compressor_train_step(capture=c), lambda: _seeded(UNet(**COMP), 3), "Lion", False, 1, pixel
    comp = _seeded(UNet(**COMP), 4)
    if name == "latent":
        return (lambda c: make_latent_train_step(sde, comp, capture=c), lambda: _seeded(ConditionalNAFNet(**NAF), 5),
                "Adam", True, 1, latent)
    return (lambda c: make_latent_train_step(sde, comp, capture=c), lambda: _seeded(BokehConditionalNAFNet(**BOKEH), 6),
            "Lion", False, 1, lambda i: latent(i, lens=True))


def _state(net, optimizer, ema, every_k):
    opt = optimizers.build_from_options({**TRAIN, "optimizer": optimizer, "grad_accum": every_k}, net.parameters(),
                                        lr_schedules.build_lr_schedule(TRAIN))
    return trainer.create_train_state(net, opt, ema=ema)


def _run(name, graphs=None, between=None, backend=None):
    """Twelve steps of the case, eager (``graphs`` None) or through a
    :class:`StepGraphs` on ``backend(state)``; ``between(state, i)`` runs
    before step i.  Returns (state, the metrics of each step, the
    generator, the step function)."""
    make, net, optimizer, ema, every_k, batch = _case(name)
    state = _state(net(), optimizer, ema, every_k)
    capture = False if backend is None else StepGraphs(backend=backend(state))
    step = make(capture)
    gen = rng.generator(7, "cpu")
    metrics = []
    for i in range(STEPS):
        if between is not None:
            between(state, i)
        args = batch(i)
        state, m = step(state, *args[:2], gen, *args[2:]) if len(args) > 1 else step(state, args[0], gen)
        metrics.append(m)
    return state, metrics, gen, step


def _same_run(a, b):
    """Bit-equal: every step's metrics, the parameters, the optimizer's
    state, the EMA, the counts and the generator."""
    (sa, ma, ga, _), (sb, mb, gb, _) = a, b
    assert all(x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x) for x, y in zip(ma, mb))
    assert all(torch.equal(p, q) for p, q in zip(sa.net.parameters(), sb.net.parameters()))
    assert all(torch.equal(p.grad, q.grad) for p, q in zip(sa.net.parameters(), sb.net.parameters()))
    oa, ob = sa.optimizer, sb.optimizer
    assert (oa.updates, oa.mini_step, sa.step) == (ob.updates, ob.mini_step, sb.step)
    assert len(oa.state_tensors()) == len(ob.state_tensors())
    assert all(torch.equal(x, y) for x, y in zip(oa.state_tensors(), ob.state_tensors()))
    assert (sa.ema is None) == (sb.ema is None)
    if sa.ema is not None:
        assert sa.ema.step == sb.ema.step == STEPS
        assert all(torch.equal(sa.ema.params[k], sb.ema.params[k]) for k in sa.ema.params)
    assert torch.equal(ga.get_state(), gb.get_state())


# ---------------------------------------------------------------- the draws
@pytest.mark.parametrize("shard", [None, (1, 2)])
@pytest.mark.parametrize("kind", ["irsde", "denoising"])
def test_split_draws_are_generate_random_states(kind, shard):
    """``compose_states(draw_states(...))`` equals ``generate_random_states``
    bit for bit, the global batch's draws with a shard, and the generator
    ends in the same state."""
    sde = IRSDE.create(10, 100, "cosine", 0.005, device="cpu") if kind == "irsde" else \
        DenoisingSDE.create(70, 1000, "cosine", device="cpu")
    lq, gt = _images(np.random.default_rng(1))
    mu = (lq,) if kind == "irsde" else ()
    g_want, g_got = rng.generator(3, "cpu"), rng.generator(3, "cpu")
    want = sde.generate_random_states(g_want, gt, *mu, shard)
    timesteps, noises = sde.draw_states(g_got, gt, shard)
    got = sde.compose_states(gt, *mu, timesteps, noises)
    assert timesteps.shape == (B, 1, 1, 1) and noises.shape == gt.shape
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(g_got.get_state(), g_want.get_state())
    if shard is not None:  # rank 1's rows of the two-rank batch's draws
        whole = sde.draw_states(rng.generator(3, "cpu"), torch.cat([gt, gt]))
        assert all(torch.equal(w[B:], d) for w, d in zip(whole, (timesteps, noises)))


# ------------------------------------------------------------ capture flow
@pytest.mark.parametrize("name", ["irsde", "irsde_accum", "denoising", "compressor", "latent", "bokeh"])
def test_captured_steps_are_the_eager_steps(name):
    """Twelve steps through the stand-in against twelve eager steps, bit for
    bit; a graph a cycle position (two with ``grad_accum: 2``), each
    captured once after one warm-up whose writes were put back."""
    captured = _run(name, backend=StandIn)
    _same_run(_run(name), captured)
    graphs = captured[3].graphs
    positions = 2 if name == "irsde_accum" else 1
    assert len(graphs) == graphs.backend.captures == positions
    if name == "irsde_accum":
        assert captured[0].optimizer.updates == STEPS // 2


@pytest.mark.parametrize("name", ["irsde", "compressor"])
def test_replaced_tensors_drop_the_graphs(name):
    """A parameter's storage replaced and the optimizer's state loaded
    (new tensors; Lion's learning rate stays the tensor its update reads)
    between steps: the graphs are dropped and captured anew, and the run
    stays the eager run."""
    def between(state, i):
        if i == 4:
            p = next(state.net.parameters())
            p.data = p.data.clone()
        if i == 8:  # a copy, as a checkpoint's load brings
            state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))

    captured = _run(name, between=between, backend=StandIn)
    _same_run(_run(name, between=between), captured)
    assert captured[3].graphs.backend.captures == 3
    opt = captured[0].optimizer
    assert all(g["lr"] is opt.lr for g in opt.inner.param_groups) == (name == "compressor")


def test_failed_capture_raises_and_nothing_runs_eagerly():
    make, net, optimizer, ema, every_k, batch = _case("irsde")
    state = _state(net(), optimizer, ema, every_k)
    before = [p.detach().clone() for p in state.net.parameters()]
    step = make(StepGraphs(backend=StandIn(state, fail=True)))
    with pytest.raises(RuntimeError, match="capture failed"):
        step(state, *batch(0), rng.generator(7, "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(before, state.net.parameters()))
    assert (state.step, state.optimizer.updates, state.ema.step, len(step.graphs)) == (0, 0, 0, 0)
    assert not any(t.any() for t in state.optimizer.state_tensors())  # what the warm-up made, zeroed


def test_replays_count_their_recorded_launches(monkeypatch):
    """A stand-in kernel behind K1's operator: the warm-up's launches count
    (and in ``warmups``), the capture's none, each replay its recorded
    nodes (the UNet's LayerNorm sites of one forward; their backward
    recomputes the plain composition)."""
    k = kernels.Kernel("stand_in", [], source="src", replaces="tpu")
    k.__dict__["_fn"] = lambda *args: 0
    op = pln.OP
    monkeypatch.setattr(pln, "OP", lambda *a: (k(), op(*a))[1])
    make, net, optimizer, ema, every_k, batch = _case("irsde")
    state = _state(net(), optimizer, ema, every_k)
    step = make(StepGraphs(backend=StandIn(state)))
    gen = rng.generator(7, "cpu")
    step(state, *batch(0), gen)
    sites = step.graphs.entries()[0][1].recording.tally[k]
    assert sites > 0 and (k.launches, k.warmups) == (2 * sites, sites)
    step(state, *batch(1), gen)
    assert (k.launches, k.warmups) == (3 * sites, sites)


def test_launches_from_other_threads_on_a_capture_stream_count_as_its(monkeypatch):
    """The autograd engine runs a step's backward (and a forward it
    recomputes) on threads of its own, on the forward's stream: a launch
    from another thread on the stream of a warm-up or capture under way
    counts as that warm-up's or capture's, one on another stream as a
    launch."""
    k = kernels.Kernel("stand_in", [], source="src", replaces="tpu")
    k.__dict__["_fn"] = lambda *args: 0
    side, other = SimpleNamespace(cuda_stream=11), SimpleNamespace(cuda_stream=12)
    current = {"stream": side}
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: current["stream"])

    def from_a_thread():
        t = threading.Thread(target=k)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()

    with kernels.warming_up(), kernels.on_stream(side):
        from_a_thread()
    assert (k.launches, k.warmups) == (1, 1)
    with kernels.recording() as rec, kernels.on_stream(side):
        from_a_thread()
        current["stream"] = other
        from_a_thread()
    assert rec.tally == {k: 1} and (k.launches, k.warmups) == (2, 1)
    from_a_thread()  # no capture under way
    assert (k.launches, k.warmups) == (3, 1) and not kernels._ON_STREAM


# ------------------------------------------------------ against JAX's step
class Drawn:
    """An SDE whose ``draw_states`` returns the given ``(timesteps,
    noises)``; every other attribute is the wrapped SDE's."""

    def __init__(self, sde, timesteps, noises):
        self._sde, self._draws = sde, (timesteps, noises)

    def __getattr__(self, name):
        return getattr(self._sde, name)

    def draw_states(self, *args):
        return self._draws


def _jax_step(jsde, apply, params, lq, gt):
    """``test_torch_training._jax_step`` of the JAX package's IR-SDE step,
    compiled at XLA's backend optimisation level 0 (a quarter of the
    compile time; the same HLO)."""
    tx = optax.chain(_keep_grads(), jopt.build_from_options(TRAIN_OPT, jlr.build_lr_schedule(TRAIN_OPT)))
    args = (jax_create_train_state(params, tx), jnp.asarray(lq), jnp.asarray(gt), jax.random.PRNGKey(0))
    step = jax.jit(jtrainer.make_train_step(jsde, apply, tx)).lower(*args)
    state, metrics = step.compile(compiler_options={"xla_backend_optimization_level": 0})(*args)
    return (float(metrics["loss"]), flatten(state.opt_state[0]["g"]), flatten(state.params),
            flatten(state.ema.params))


def test_captured_step_matches_jax(pair):  # noqa: F811
    """ConditionalUNet nf=8, depth=2, batch 2 at 16 px, L1, Adam: one step
    of the capture flow (the stand-in) from draws given to ``draw_states``
    against the JAX package's jitted step from the same seeded weights
    (``test_torch_captured.pair``)
    and the noisy states the port composes of those draws (``Injected``),
    within ``test_torch_training._hold``'s bounds.  The timesteps are 30
    and 71: at 3, a state of the SDE's own noise level puts the target's
    float32 cancellation (``_hold``) past the gradients' bound."""
    net, fnet, params = pair
    net = copy.deepcopy(net).train()
    r = np.random.default_rng(8)
    lq, gt = (r.random((2, 16, 16, 3), np.float32) for _ in range(2))
    t = torch.tensor([30, 71]).reshape(2, 1, 1, 1)
    noises = torch.from_numpy(r.standard_normal(gt.shape).astype(np.float32))
    psde = IRSDE.create(10, 100, "cosine", 0.005, device="cpu")
    _, xt = psde.compose_states(torch.from_numpy(gt), torch.from_numpy(lq), t, noises)
    jsde = Injected(JaxIRSDE.create(max_sigma=10, T=100, schedule="cosine", eps=0.005),
                    jnp.asarray(t.int().numpy()), jnp.asarray(xt.numpy()))
    want = _jax_step(jsde, fnet.apply, params, lq, gt)
    state = trainer.create_train_state(net, optimizers.build_from_options(
        TRAIN_OPT, net.parameters(), lr_schedules.build_lr_schedule(TRAIN_OPT)))
    step = make_train_step(Drawn(psde, t, noises), capture=StepGraphs(backend=StandIn(state)))
    state, metrics = step(state, torch.from_numpy(lq), torch.from_numpy(gt), rng.generator(0, "cpu"))
    assert len(step.graphs) == 1 and state.step == state.ema.step == state.optimizer.updates == 1
    grads = {k: v.grad.clone() for k, v in net.named_parameters()}
    _hold((metrics["loss"].item(), grads, dict(net.named_parameters()), state.ema.params), want, unet_flax_keys(2))
