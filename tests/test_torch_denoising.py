"""PyTorch port, the denoising SDE path and the IR-SDE samplers that no
model path calls: ``DenoisingSDE`` tables and the integer
``get_optimal_timestep`` against the JAX package; the ``dsde_*`` samplers
against JAX with a stub net and the same injected noise; a whole
``make_denoising_sampler`` chain through a tiny unconditional UNet with the
same weights; ``forward_sde``, ``optimal_reverse`` and the scipy
``ode_sampler`` against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.models import ConditionalUNet as FlaxUNet
from image_restoration_sde_tpu.sampling import make_denoising_sampler as j_make_denoising_sampler
from image_restoration_sde_tpu.sde import IRSDE as JIRSDE
from image_restoration_sde_tpu.sde import samplers as jsamplers
from image_restoration_sde_tpu.sde.denoising_sde import DenoisingSDE as JDenoisingSDE
from image_restoration_sde_tpu_torch.sampling import make_denoising_sampler
from image_restoration_sde_tpu_torch.sde import IRSDE, DenoisingSDE, samplers
from test_torch_unet import TINY, uncond_port, unflatten

SHAPE = (2, 8, 6, 3)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


# --------------------------------------------------------------- tables
@pytest.mark.parametrize("max_sigma,T,schedule", [(70, 1000, "cosine"), (25, 100, "linear"), (1.0, 50, "other"),
                                                  (0.2, 100, "cosine")])
def test_tables_equal_jax(max_sigma, T, schedule):
    """The same float64 arrays cast to float32 on both sides: equal.  max 1.0
    stays 1.0 (strict > 1 normalisation) and "other" is the linear schedule."""
    j = JDenoisingSDE.create(max_sigma, T, schedule)
    p = DenoisingSDE.create(max_sigma, T, schedule, device="cpu")
    for name in ("thetas", "sigmas", "thetas_cumsum", "sigma_bars", "dt", "max_sigma"):
        assert np.array_equal(_np(getattr(p.tables, name)), np.asarray(getattr(j.tables, name))), name
    assert p.T == j.T


@pytest.mark.parametrize("max_sigma,T", [(70, 1000), (50, 100)])
def test_optimal_timestep_is_the_same_integer_for_every_sigma(max_sigma, T):
    """Every integer sigma 1..70: an off-by-one would change the chain's
    length.  The denoising config (max_sigma 70, T 1000) gives 414 at sigma
    50 and 230 at sigma 25."""
    j = JDenoisingSDE.create(max_sigma, T, "cosine")
    p = DenoisingSDE.create(max_sigma, T, "cosine", device="cpu")
    want = [int(j.get_optimal_timestep(s)) for s in range(1, 71)]
    assert [p.get_optimal_timestep(s) for s in range(1, 71)] == want
    if (max_sigma, T) == (70, 1000):
        assert want[49] == 414 and want[24] == 230


# ------------------------------------------------------------- samplers
def _stub_jax(x, tvec):
    return jnp.tanh(x) * 0.5 + 0.002 * tvec[:, None, None, None]


def _stub_torch(x, tvec):
    return torch.tanh(x) * 0.5 + 0.002 * tvec[:, None, None, None]


@pytest.fixture(scope="module")
def dsde_pair():
    return JDenoisingSDE.create(50, 100, "cosine"), DenoisingSDE.create(50, 100, "cosine", device="cpu")


@pytest.fixture(scope="module")
def chain_inputs():
    r = np.random.default_rng(0)
    x = r.random(SHAPE, np.float32)
    x0 = r.random(SHAPE, np.float32)
    noise = r.standard_normal((30, *SHAPE)).astype(np.float32)
    return x, x0, noise


def _close(got, want, rel=1e-5):
    """float32 step functions in the same operation order: 1e-5 of
    max|ref| over 30 steps."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("analytic", [False, True], ids=["net", "x0"])
def test_dsde_reverse_sde_matches_jax(dsde_pair, chain_inputs, analytic):
    j, p = dsde_pair
    x, x0, noise = chain_inputs
    want, want_all = jsamplers.dsde_reverse_sde(j, _stub_jax, x, x0=x0 if analytic else None, steps=30,
                                                return_all=True, noise_seq=noise)
    got, got_all = samplers.dsde_reverse_sde(p, _stub_torch, torch.from_numpy(x),
                                             x0=torch.from_numpy(x0) if analytic else None, steps=30,
                                             return_all=True, noise_seq=torch.from_numpy(noise))
    _close(got, want)
    _close(got_all, want_all)


def test_dsde_reverse_ode_and_optimal_reverse_match_jax(dsde_pair, chain_inputs):
    j, p = dsde_pair
    x, x0, _ = chain_inputs
    _close(samplers.dsde_reverse_ode(p, _stub_torch, torch.from_numpy(x), steps=30),
           jsamplers.dsde_reverse_ode(j, _stub_jax, x, steps=30))
    _close(samplers.dsde_optimal_reverse(p, torch.from_numpy(x), torch.from_numpy(x0), steps=30),
           jsamplers.dsde_optimal_reverse(j, x, x0, steps=30))


def test_dsde_reverse_sde_draws_from_its_generator(dsde_pair, chain_inputs):
    """With a generator instead of noise_seq: the same as noise_seq drawn
    from a generator of the same seed, step by step."""
    _, p = dsde_pair
    x = torch.from_numpy(chain_inputs[0])
    g = torch.Generator().manual_seed(3)
    ns = torch.stack([torch.randn(x.shape, generator=g) for _ in range(5)])
    got = samplers.dsde_reverse_sde(p, _stub_torch, x, torch.Generator().manual_seed(3), steps=5)
    assert torch.equal(got, samplers.dsde_reverse_sde(p, _stub_torch, x, steps=5, noise_seq=ns))


# ------------------------------------------------------- the whole chain
def test_denoising_sampler_matches_jax(uncond_weights):
    """make_denoising_sampler on both sides: DenoisingSDE(max_sigma 70, T
    100, cosine), sigma 50 -> t0 = 41 reverse ODE steps through the tiny
    unconditional UNet with the same weights, on the same noisy input.
    Deterministic, so nothing is injected.  float32; bound 1e-4 of max|ref|:
    the nets' float32 rounding differences pass through t0 steps whose
    coefficients stay O(1)."""
    j = JDenoisingSDE.create(70, 100, "cosine")
    p = DenoisingSDE.create(70, 100, "cosine", device="cpu")
    r = np.random.default_rng(1)
    clean = r.random((2, 20, 28, 3), np.float32)
    noisy = (clean + 50 / 255 * r.standard_normal(clean.shape)).astype(np.float32)
    fnet = FlaxUNet(**TINY, conditional=False)
    params = unflatten(uncond_weights)
    want = np.asarray(j_make_denoising_sampler(j, lambda pr, x, t: fnet.apply(pr, x, None, t), 50.0)(params, noisy))
    sample = make_denoising_sampler(p, uncond_port(uncond_weights), 50.0)
    assert sample.t0 == int(j.get_optimal_timestep(50.0)) == 41
    got = sample(torch.from_numpy(noisy))
    assert got.shape == noisy.shape and torch.isfinite(got).all()
    _close(got, want, rel=1e-4)


@pytest.fixture(scope="module")
def uncond_weights():
    from test_torch_unet import random_flax_params

    return random_flax_params(TINY["depth"], TINY["nf"], seed=1, conditional=False)


# --------------------------------------------- IR-SDE samplers, no net path
@pytest.fixture(scope="module")
def irsde_pair():
    args = dict(max_sigma=10.0, T=20, schedule="cosine", eps=0.005)
    return JIRSDE.create(**args), IRSDE.create(**args, device="cpu")


def test_forward_sde_and_optimal_reverse_match_jax(irsde_pair, chain_inputs):
    """forward_sde consumes noise_seq t = 1 first; optimal_reverse is the
    closed-form posterior mean from x_T."""
    j, p = irsde_pair
    x, mu, noise = chain_inputs
    noise = noise[:20]
    want, want_all = jsamplers.forward_sde(j, x, mu, return_all=True, noise_seq=noise)
    got, got_all = samplers.forward_sde(p, torch.from_numpy(x), torch.from_numpy(mu), return_all=True,
                                        noise_seq=torch.from_numpy(noise))
    _close(got, want)
    _close(got_all, want_all)
    xT = np.array(want)
    _close(samplers.optimal_reverse(p, torch.from_numpy(xT), torch.from_numpy(x), torch.from_numpy(mu)),
           jsamplers.optimal_reverse(j, xT, x, mu))


def test_ode_sampler_matches_jax(irsde_pair, chain_inputs):
    """scipy's RK45 over the probability-flow ODE on both sides, the drift a
    linear stub net, at rtol = atol = 1e-7.  The drift is piecewise constant
    in t (the timestep is int(t)), so the adaptive steps react to float32
    rounding differences in the drift and the two solutions differ by the
    solver's own error, not by rounding: bound 1e-4 of max|ref| (the state
    grows ~40x along the chain; measured 1.5e-5 here; a wrong drift or
    timestep map moves the result by O(1))."""
    j, p = irsde_pair
    x, mu, _ = chain_inputs
    xt = (mu + 0.5 * x).astype(np.float32)

    def jnet(a, m, t):
        return 0.5 * (a - m) + 0.002 * t[:, None, None, None]

    want = jsamplers.ode_sampler(j, jnet, xt, mu, rtol=1e-7, atol=1e-7)
    got = samplers.ode_sampler(p, jnet, torch.from_numpy(xt), torch.from_numpy(mu), rtol=1e-7, atol=1e-7)
    assert got.dtype == torch.float32
    _close(got, want, rel=1e-4)
