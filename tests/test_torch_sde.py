"""PyTorch port, SDE core: schedules, IRSDE math and the IR-SDE samplers
held against the JAX package on the same seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.sde import IRSDE as JIRSDE
from image_restoration_sde_tpu.sde import samplers as jsamplers
from image_restoration_sde_tpu.sde import schedules as jsched
from image_restoration_sde_tpu_torch.sde import IRSDE, rng, samplers, schedules

SDE_ARGS = dict(max_sigma=10.0, T=100, schedule="cosine", eps=0.005)
SHAPE = (2, 6, 5, 3)
# float32 elementwise math in the same operation order: XLA's and
# PyTorch's CPU exp/log differ by a few ulp, and get_init_state_from_noise
# multiplies by up to 1/eps = 200, so the bound is relative to each value
RTOL, ATOL = 2e-6, 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("T", [20, 100])
def test_theta_schedules_equal_jax(name, T):
    np.testing.assert_array_equal(schedules.make_theta_schedule(name, T), jsched.make_theta_schedule(name, T))


@pytest.mark.parametrize(
    "args",
    [SDE_ARGS, dict(max_sigma=50, T=100, schedule="linear", eps=0.01), dict(max_sigma=0.5, T=30, schedule="constant", eps=0.01)],
)
def test_tables_bitwise_equal_jax(args):
    port = IRSDE.create(**args, device="cpu").tables
    ref = jsched.build_tables(**args)
    assert port.T == ref.T
    for f in ("thetas", "sigmas", "thetas_cumsum", "sigma_bars", "dt", "max_sigma"):
        got = getattr(port, f)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref, f)), err_msg=f)


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    names = ("x", "x0", "mu", "noise", "score")
    return {n: r.standard_normal(SHAPE).astype(np.float32) for n in names}


# method name -> argument names (t is appended last, noise where listed)
METHODS = {
    "mu_bar": ("x0", "mu"),
    "drift": ("x", "mu"),
    "dispersion": ("noise",),
    "score_from_noise": ("noise",),
    "get_real_noise": ("x", "x0", "mu"),
    "get_real_score": ("x", "x0", "mu"),
    "get_init_state_from_noise": ("x", "mu", "noise"),
    "sde_reverse_drift": ("x", "mu", "score"),
    "ode_reverse_drift": ("x", "mu", "score"),
    "reverse_sde_step_mean": ("x", "mu", "score"),
    "reverse_ode_step": ("x", "mu", "score"),
    "reverse_optimum_step": ("x", "x0", "mu"),
    "weights": (),
    "reverse_optimum_std": (),
}
# methods whose noise argument comes after t
METHODS_NOISE_LAST = {
    "forward_step": ("x", "mu"),
    "reverse_sde_step": ("x", "mu", "score"),
    "reverse_posterior_step": ("x", "mu", "score"),
}


@pytest.mark.parametrize("name", sorted(METHODS) + sorted(METHODS_NOISE_LAST))
@pytest.mark.parametrize("t", [1, 37, 100, "per-sample"])
def test_irsde_methods_match_jax(name, t):
    port, ref = IRSDE.create(**SDE_ARGS, device="cpu"), JIRSDE.create(**SDE_ARGS)
    inp = _inputs()
    if t == "per-sample":
        t_np = np.array([3, 91], np.int32).reshape(2, 1, 1, 1)
        t_port, t_jax = _t(t_np).long(), jnp.asarray(t_np)
    else:
        t_port, t_jax = t, t
    if name in METHODS:
        names = METHODS[name]
        got = getattr(port, name)(*[_t(inp[n]) for n in names], t_port)
        want = getattr(ref, name)(*[jnp.asarray(inp[n]) for n in names], t_jax)
    else:
        names = METHODS_NOISE_LAST[name]
        got = getattr(port, name)(*[_t(inp[n]) for n in names], t_port, _t(inp["noise"]))
        want = getattr(ref, name)(*[jnp.asarray(inp[n]) for n in names], t_jax, jnp.asarray(inp["noise"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_generate_random_states_law():
    """Different RNGs by design: check t's range and that the returned state
    is mu_bar + sigma_bar * (standard normal noise), per sample."""
    sde = IRSDE.create(**SDE_ARGS, device="cpu")
    r = np.random.default_rng(1)
    x0 = _t(r.random((64, 8, 8, 3), np.float32))
    mu = _t(r.random((64, 8, 8, 3), np.float32))
    t, xt = sde.generate_random_states(rng.generator(0, "cpu"), x0, mu)
    assert t.shape == (64, 1, 1, 1) and xt.shape == x0.shape and xt.dtype == torch.float32
    assert int(t.min()) >= 1 and int(t.max()) <= sde.T
    z = (xt - sde.mu_bar(x0, mu, t)) / sde.sigma_bar(t)
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1) < 0.05
    t2, xt2 = sde.generate_random_states(rng.generator(0, "cpu"), x0, mu)
    assert torch.equal(t, t2) and torch.equal(xt, xt2)


def test_noise_state_per_sample_generators():
    """Sample i's noise depends only on generator i."""
    sde = IRSDE.create(**SDE_ARGS, device="cpu")
    x = torch.zeros(3, 16, 16, 3)
    batch = sde.noise_state(rng.generators_for_seeds([5, 6, 7], "cpu"), x)
    alone = sde.noise_state(rng.generators_for_seeds([6], "cpu"), x[:1])
    assert torch.equal(batch[1:2], alone)
    z = batch / sde.max_sigma
    assert abs(float(z.mean())) < 0.1 and abs(float(z.std()) - 1) < 0.1


def _stub_pair(port, ref):
    """The same deterministic 'network' in both frameworks: most of the
    true noise (x - mu) / sigma_bar_t plus a nonlinear term, so the chains
    stay O(1) as with a trained net."""

    def port_fn(x, mu, tvec):
        sb = port.sigma_bar(tvec.long()).reshape(-1, 1, 1, 1)
        return 0.8 * (x - mu) / sb + 0.1 * torch.tanh(x)

    def jax_fn(x, mu, tvec):
        sb = ref.sigma_bar(tvec).reshape(-1, 1, 1, 1)
        return 0.8 * (x - mu) / sb + 0.1 * jnp.tanh(x)

    return port_fn, jax_fn


@pytest.mark.parametrize("mode", ["sde", "posterior", "ode"])
def test_samplers_full_chain_match_jax(mode):
    """T=100 reverse chains with a stub noise function and the same
    noise_seq.  Bound: float32, 100 steps of elementwise math whose
    per-step rounding differences (a few ulp) the chain carries along; the
    state stays O(1), so 2e-5 absolute."""
    port, ref = IRSDE.create(**SDE_ARGS, device="cpu"), JIRSDE.create(**SDE_ARGS)
    r = np.random.default_rng(2)
    mu = r.random(SHAPE, np.float32)
    xt = (mu + float(port.max_sigma) * r.standard_normal(SHAPE)).astype(np.float32)
    noise_seq = r.standard_normal((port.T, *SHAPE)).astype(np.float32)
    port_fn, jax_fn = _stub_pair(port, ref)
    if mode == "ode":
        got = samplers.reverse_ode(port, port_fn, _t(xt), _t(mu))
        want = jsamplers.reverse_ode(ref, jax_fn, jnp.asarray(xt), jnp.asarray(mu))
    else:
        fn = {"sde": (samplers.reverse_sde, jsamplers.reverse_sde),
              "posterior": (samplers.reverse_posterior, jsamplers.reverse_posterior)}[mode]
        got = fn[0](port, port_fn, _t(xt), _t(mu), noise_seq=_t(noise_seq))
        want = fn[1](ref, jax_fn, jnp.asarray(xt), jnp.asarray(mu), noise_seq=jnp.asarray(noise_seq))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_sampler_return_all_and_steps():
    port, ref = IRSDE.create(**SDE_ARGS, device="cpu"), JIRSDE.create(**SDE_ARGS)
    r = np.random.default_rng(3)
    mu = r.random(SHAPE, np.float32)
    xt = (mu + 0.04 * r.standard_normal(SHAPE)).astype(np.float32)
    noise_seq = r.standard_normal((10, *SHAPE)).astype(np.float32)
    port_fn, jax_fn = _stub_pair(port, ref)
    x, states = samplers.reverse_posterior(port, port_fn, _t(xt), _t(mu), steps=10, return_all=True,
                                           noise_seq=_t(noise_seq))
    jx, jstates = jsamplers.reverse_posterior(ref, jax_fn, jnp.asarray(xt), jnp.asarray(mu), steps=10,
                                              return_all=True, noise_seq=jnp.asarray(noise_seq))
    assert states.shape == (10, *SHAPE) and torch.equal(states[-1], x)
    np.testing.assert_allclose(states.numpy(), np.asarray(jstates), rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="noise_seq"):
        samplers.reverse_sde(port, port_fn, _t(xt), _t(mu), steps=9, noise_seq=_t(noise_seq))


def test_sampler_generator_path_is_deterministic():
    sde = IRSDE.create(**SDE_ARGS, device="cpu")
    port_fn, _ = _stub_pair(sde, None)
    mu = torch.rand(2, 8, 8, 3, generator=rng.generator(9, "cpu"))
    a = samplers.reverse_sde(sde, port_fn, mu.clone(), mu, rng.generator(1, "cpu"), steps=20)
    b = samplers.reverse_sde(sde, port_fn, mu.clone(), mu, rng.generator(1, "cpu"), steps=20)
    c = samplers.reverse_sde(sde, port_fn, mu.clone(), mu, rng.generator(2, "cpu"), steps=20)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_entry_points_default_to_the_card():
    """IRSDE.create, build_tables and the generators run on the card unless
    the caller asks for the CPU; with no CUDA they raise, never fall back."""
    import inspect

    for fn in (IRSDE.create, schedules.build_tables, rng.generator, rng.generators_for_seeds):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            IRSDE.create(**SDE_ARGS)
        with pytest.raises(RuntimeError):
            rng.generators_for_seeds([1, 2])
