"""PyTorch port, the captured chain (``sde/captured.py``) on the CPU.

The function a graph records, run eagerly: the reverse chain over a static
noise buffer (``samplers.draw_noise`` + ``samplers.reverse_from_noise``)
against the eager samplers bit for bit, the generators left where they
leave them, and against the JAX package's ``noise_seq`` scans.  The
capture flow itself through a stand-in backend (its "graph" replays by
running the recorded chain again): the samplers and the loaded artifact
bit-equal to their eager forms, the launch accounting (a capture counts
nothing, a replay its recorded nodes, a warm-up apart), the cache (keys,
bound, eviction releasing what a graph holds, a K3 pointer table
included), and no fallback: a failed capture raises."""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.models import ConditionalUNet as FlaxUNet
from image_restoration_sde_tpu.sde import IRSDE as JIRSDE
from image_restoration_sde_tpu.sde import samplers as jsamplers
from image_restoration_sde_tpu_torch import exporting, kernels, sampling
from image_restoration_sde_tpu_torch.models import BokehConditionalNAFNet, ConditionalNAFNet, ConditionalUNet, UNet, \
    init_params_
from image_restoration_sde_tpu_torch.ops import naf_stack
from image_restoration_sde_tpu_torch.sde import DenoisingSDE, IRSDE, rng, samplers
from image_restoration_sde_tpu_torch.sde.captured import ChainGraphs, generator_layout
from image_restoration_sde_tpu_torch.training import make_latent_sampler
from image_restoration_sde_tpu_torch.utils import state_dict_from_flax
from test_torch_sampling import SDE_ARGS, SHAPE
from test_torch_unet import TINY, unflatten

STEPS, HW = 4, 16
MODES = ("sde", "posterior", "ode")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class StandIn:
    """A capture backend on the CPU: the "graph" keeps the chain it was
    captured on and replays by running it again (into the captured
    output), its kernel calls counting nothing."""

    def __init__(self, fail=False):
        self.fail, self.captures = fail, 0

    def pool(self, device):
        return ("pool", str(device))

    def warm(self, device, fn):
        fn()

    def capture(self, device, pool, fn):
        if self.fail:
            raise RuntimeError("capture failed")
        self.captures += 1
        out = fn()

        class Graph:
            def replay(self):
                with kernels.recording():
                    out.copy_(fn())

        return Graph(), out

    def pool_bytes(self, device, pool):
        return 0


def _seeded(net, seed):
    return init_params_(net, torch.Generator().manual_seed(seed)).eval()


@pytest.fixture(scope="module")
def unet():
    return _seeded(ConditionalUNet(**TINY), 3)


@pytest.fixture(scope="module")
def pair():
    """The tiny ConditionalUNet in both packages with the same seeded
    weights (``test_torch_unet.random_flax_params``' rule on the tree's
    shapes, which ``jax.eval_shape`` gives without compiling the init)."""
    fnet = FlaxUNet(**TINY)
    x = jnp.zeros((1, 16, 16, 3))
    tree = jax.eval_shape(fnet.init, jax.random.PRNGKey(0), x, x, jnp.array([1.0]))
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    shapes = {"/".join(str(k.key) for k in path[1:]): leaf for path, leaf in leaves}
    r = np.random.default_rng(1)
    weights = {}
    for path, leaf in shapes.items():
        if path.endswith("/g"):
            v = 1 + 0.2 * r.standard_normal(leaf.shape)
        elif path.endswith("bias"):
            v = 0.1 * r.standard_normal(leaf.shape)
        else:
            v = r.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        weights[path] = v.astype(np.float32)
    net = ConditionalUNet(**TINY)
    net.load_state_dict(state_dict_from_flax(weights, TINY["depth"]))
    return net.eval(), fnet, unflatten(weights)


def _gens(layout, batch, seed=7):
    return rng.generator(seed, "cpu") if layout == "one" else rng.generators_for_seeds(range(seed, seed + batch), "cpu")


def _states(gen):
    return [g.get_state() for g in (gen if isinstance(gen, list) else [gen])]


def _same_states(a, b):
    return all(torch.equal(x, y) for x, y in zip(_states(a), _states(b)))


@pytest.mark.parametrize("layout", ["one", "per_sample"])
@pytest.mark.parametrize("mode", MODES)
def test_chain_over_a_noise_buffer_is_the_eager_chain(unet, mode, layout):
    """What a graph records, run eagerly: the chain over the buffer of
    ``draw_noise`` equals ``noise_state`` + ``reverse_sde`` /
    ``reverse_posterior`` / ``reverse_ode`` drawing from the same
    generators, bit for bit, and leaves them in the same state."""
    sde = IRSDE.create(**SDE_ARGS, device="cpu")
    mu = torch.rand(2, HW, HW, 3, generator=rng.generator(1, "cpu"))
    g_eager, g_buf = _gens(layout, 2), _gens(layout, 2)
    with torch.inference_mode():
        want = sampling.reverse(sde, unet, sde.noise_state(g_eager, mu), mu, g_eager, mode, STEPS)
        noise = samplers.draw_noise(g_buf, mu, samplers.chain_draws(mode, STEPS))
        got = samplers.reverse_from_noise(sde, unet, mu, noise, mode, STEPS)
    assert noise.shape == (1 if mode == "ode" else STEPS + 1, *mu.shape)
    assert torch.equal(got, want) and _same_states(g_buf, g_eager)


def test_denoising_chain_is_the_eager_reverse_ode():
    """The denoising sampler's captured chain (no noise) against
    ``dsde_reverse_ode`` over the optimal timestep's steps."""
    net = _seeded(ConditionalUNet(**TINY, conditional=False), 4)
    sde = DenoisingSDE.create(70.0, 1000, "cosine", device="cpu")
    x = torch.rand(2, HW, HW, 3, generator=rng.generator(2, "cpu"))
    sample = sampling.make_denoising_sampler(sde, net, 1.5, capture=ChainGraphs(backend=StandIn()))
    with torch.inference_mode():
        want = samplers.dsde_reverse_ode(sde, lambda a, t: net(a, None, t), x, steps=sample.t0)
    assert torch.equal(sample(x), want) and torch.equal(sample(x), want) and len(sample.graphs) == 1


@pytest.mark.parametrize("mode", ["sde", "posterior"])
def test_chain_over_numpy_noise_matches_jax(pair, mode):
    """``reverse_from_noise`` fed numpy-made noise (the initial state's,
    then STEPS steps') against the JAX scan's ``noise_seq`` path from
    ``lq + max_sigma z0``.  Bound 1e-4 of max|ref|, as
    ``test_torch_sampling.py::test_chain_with_net_matches_jax``: the net's
    float32 rounding differences (1e-6 of its output) pass through steps
    whose coefficients stay O(1)."""
    net, fnet, params = pair
    port, ref = IRSDE.create(**SDE_ARGS, device="cpu"), JIRSDE.create(**SDE_ARGS)
    r = np.random.default_rng(5)
    lq = r.random(SHAPE, np.float32)
    noise = r.standard_normal((STEPS + 1, *SHAPE)).astype(np.float32)
    noisy = lq + np.float32(float(port.max_sigma)) * noise[0]
    fn = {"sde": jsamplers.reverse_sde, "posterior": jsamplers.reverse_posterior}[mode]
    want = jax.jit(lambda xt, mu, ns: fn(ref, lambda x, m, t: fnet.apply(params, x, m, t), xt, mu, steps=STEPS,
                                         noise_seq=ns))(noisy, lq, noise[1:])
    with torch.inference_mode():
        got = samplers.reverse_from_noise(port, net, torch.from_numpy(lq), torch.from_numpy(noise), mode, STEPS)
    want = np.asarray(want)
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("case", ["restoration", "restoration_cast_chunked", "latent", "bokeh"])
def test_captured_samplers_are_the_eager_samplers(unet, case):
    """Each sampler through the capture flow (the stand-in backend) against
    the same sampler with ``capture=False``, per-sample generators: bit for
    bit, the generators left alike, one graph a signature (the chunked
    one: one chunk shape; a second call replays)."""
    sde = IRSDE.create(**SDE_ARGS, device="cpu")
    lq = torch.rand(2, HW, HW, 3, generator=rng.generator(3, "cpu"))
    cond = ()
    if case.startswith("restoration"):
        kw = dict(cast_params=torch.bfloat16, chunk=1) if case.endswith("chunked") else {}

        def make(capture):
            return sampling.make_restoration_sampler(sde, unet, "posterior", STEPS, capture=capture, **kw)
    else:
        comp = _seeded(UNet(in_ch=3, out_ch=3, ch=4, ch_mult=(1, 2), embed_dim=4), 1)
        cls = BokehConditionalNAFNet if case == "bokeh" else ConditionalNAFNet
        net = _seeded(cls(img_channel=4, width=8, enc_blk_nums=(1, 2), middle_blk_num=1, dec_blk_nums=(1, 1)), 2)
        if case == "bokeh":
            cond = (tuple(torch.tensor(v) for v in ([2.0, 4.0], [16.0, 8.0], [0.5, 0.25])),)

        def make(capture):
            return make_latent_sampler(sde, net, comp, "sde", STEPS, capture=capture)

    eager, captured = make(False), make(ChainGraphs(backend=StandIn()))
    assert eager.graphs is None
    for seed in (7, 9):
        g_eager, g_cap = _gens("per_sample", 2, seed), _gens("per_sample", 2, seed)
        want = eager(lq, g_eager, *cond)
        assert torch.equal(captured(lq, g_cap, *cond), want) and _same_states(g_cap, g_eager)
    assert len(captured.graphs) == 1 and captured.graphs.backend.captures == 1


def test_loaded_artifact_captured_is_eager():
    """A per-sample-seed artifact (a one-level UNet, a fixed batch of 2)
    loaded with the capture flow against the same artifact loaded eagerly:
    bit for bit, one graph for both calls."""
    net = _seeded(ConditionalUNet(in_nc=3, out_nc=3, nf=4, depth=1), 8)
    sde = IRSDE.create(**SDE_ARGS, device="cpu")
    data = exporting.export_restoration_sampler(sde, net, (HW, HW), mode="sde", steps=STEPS, batch=2,
                                                per_sample_seed=True)
    eager, _ = exporting.load_artifact(data, "cpu", capture=False)
    captured, _ = exporting.load_artifact(data, "cpu", capture=ChainGraphs(backend=StandIn()))
    for seeds in ([1, 2], [3, 4]):
        lq = torch.rand(2, HW, HW, 3, generator=rng.generator(seeds[0], "cpu"))
        assert torch.equal(captured(lq, seeds), eager(lq, seeds))
    assert len(captured.graphs) == 1 and captured.graphs.backend.captures == 1


def _stand_in_kernel(name="stand_in"):
    k = kernels.Kernel(name, [], source="src", replaces="tpu")
    k.__dict__["_fn"] = lambda *args: 0  # the launch the runtime accepted
    return k


def test_kernel_counts_under_recording_and_warm_up():
    k = _stand_in_kernel()
    k()
    with kernels.warming_up():
        k()
    with kernels.recording() as rec:
        assert kernels.capturing()
        k()
        k()
    assert not kernels.capturing()
    assert (k.launches, k.warmups, rec.tally) == (2, 1, {k: 2})
    rec.replayed()
    rec.replayed()
    assert (k.launches, k.warmups) == (6, 1)


def test_launch_accounting_of_capture_and_replay():
    """A warm-up's launches count (and in ``warmups``), the capture's none,
    each replay the recorded nodes."""
    k = _stand_in_kernel()

    def chain(x):
        k()
        k()
        return x * 2

    def warmup(x):
        k()
        return x

    graphs = ChainGraphs(backend=StandIn())
    x = torch.ones(3)
    entry = graphs.prepare(("a",), chain, (x,), warmup=warmup)
    assert (k.launches, k.warmups, entry.recording.tally) == (1, 1, {k: 2})
    assert torch.equal(graphs(("a",), chain, (x,), warmup=warmup), x * 2)
    assert (k.launches, k.warmups) == (3, 1)
    out = graphs(("a",), chain, (x + 1,), warmup=warmup)  # new inputs: copied into the static ones
    assert torch.equal(out, (x + 1) * 2) and (k.launches, k.warmups) == (5, 1)
    out.add_(1)  # the caller's copy, not the graph's output
    assert torch.equal(entry.output, (x + 1) * 2)


def test_cache_keys_bound_and_eviction_release_what_graphs_hold():
    """Distinct signatures, distinct graphs; the last ``capacity`` kept;
    evicting one drops the tensors its capture held (a K3 pointer table
    among them, even after the table cache itself let it go)."""
    assert [generator_layout(g) for g in (None, rng.generator(0, "cpu"), [rng.generator(0, "cpu")])] == \
        ["none", "one", "per_sample"]
    cpu = torch.device("cpu")
    blocks = [torch.full((3,), float(i)) for i in range(4)]
    ptrs = tuple(t.data_ptr() for t in blocks)
    naf_stack._TABLES.clear()
    held = {}

    def chain(x):
        kernels.hold(held["t"])
        return naf_stack._pointer_table(cpu, ptrs)[: x.shape[0]].float() + x

    def warmup(x):  # makes the table before the capture, as a K3 warm-up does
        naf_stack._pointer_table(cpu, ptrs)
        return x

    graphs = ChainGraphs(capacity=2, backend=StandIn())
    refs = []
    for key in ("a", "b", "c"):
        held["t"] = torch.zeros(2)
        refs.append(weakref.ref(held["t"]))
        graphs(key, chain, (torch.ones(2),), warmup=warmup)
    del held["t"]
    assert [k for k, _ in graphs.entries()] == ["b", "c"] and len(graphs) == 2
    gc.collect()
    assert refs[0]() is None and refs[1]() is not None and refs[2]() is not None
    table = weakref.ref(naf_stack._pointer_table(cpu, ptrs))
    for i in range(naf_stack.TABLES_KEPT):  # the table cache evicts it
        naf_stack._pointer_table(cpu, (i,))
    gc.collect()
    assert table() is not None  # the graphs still own it
    graphs.clear()
    gc.collect()
    assert table() is None and refs[2]() is None
    naf_stack._TABLES.clear()


def test_k3_table_missing_under_capture_raises():
    """A capture cannot copy a pointer table from the host: without the
    warm-up's table it raises, and nothing is cached."""
    naf_stack._TABLES.clear()
    graphs = ChainGraphs(backend=StandIn())
    with pytest.raises(RuntimeError, match="pointer table"):
        graphs("k", lambda x: naf_stack._pointer_table(torch.device("cpu"), (x.data_ptr(),)).float(), (torch.ones(1),),
               warmup=lambda x: x)
    assert len(graphs) == 0


def test_failed_capture_raises_and_nothing_runs_eagerly(unet):
    sde = IRSDE.create(**SDE_ARGS, device="cpu")
    backend = StandIn(fail=True)
    sample = sampling.make_restoration_sampler(sde, unet, "sde", STEPS, capture=ChainGraphs(backend=backend))
    gen = rng.generator(0, "cpu")
    with pytest.raises(RuntimeError, match="capture failed"):
        sample(torch.rand(1, HW, HW, 3), gen)
    assert len(sample.graphs) == 0


def test_replaced_parameters_drop_the_graphs():
    """A graph reads parameters by address: values changed in place keep
    the graphs (and reach the next replay), a replaced tensor drops them."""
    net = _seeded(ConditionalUNet(**TINY), 5)
    sde = IRSDE.create(**SDE_ARGS, device="cpu")
    sample = sampling.make_restoration_sampler(sde, net, "ode", 2, capture=ChainGraphs(backend=StandIn()))
    eager = sampling.make_restoration_sampler(sde, net, "ode", 2, capture=False)
    lq = torch.rand(1, HW, HW, 3, generator=rng.generator(6, "cpu"))
    sample(lq, rng.generator(0, "cpu"))
    with torch.no_grad():
        net.init_conv.weight.mul_(0.5)
    assert torch.equal(sample(lq, rng.generator(0, "cpu")), eager(lq, rng.generator(0, "cpu")))
    assert sample.graphs.backend.captures == 1
    net.init_conv.weight = torch.nn.Parameter(net.init_conv.weight.detach() * 2)
    assert torch.equal(sample(lq, rng.generator(0, "cpu")), eager(lq, rng.generator(0, "cpu")))
    assert sample.graphs.backend.captures == 2 and len(sample.graphs) == 1


def test_threads_sharing_one_cache_get_their_own_outputs_and_exact_counts():
    """More threads than cores call one cache over keys that evict each
    other (capacity 2 of 3), the interpreter switching threads often: every
    call returns its own input's chain, and the kernel's launches are
    exactly one warm-up launch a capture plus two a replay."""
    import sys
    import threading

    k = _stand_in_kernel()

    def chain(x):
        k()
        k()
        return x * 3 + 1

    graphs = ChainGraphs(capacity=2, backend=StandIn())
    calls, failures = 40, []

    def worker(i):
        for j in range(calls):
            x = torch.full((4,), float(i * calls + j))
            if not torch.equal(graphs(("key", (i + j) % 3), chain, (x,), warmup=lambda x: (k(), x)[1]), x * 3 + 1):
                failures.append((i, j))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not failures
    captures = graphs.backend.captures
    assert (k.launches, k.warmups) == (captures + 2 * 16 * calls, captures) and captures >= 3
