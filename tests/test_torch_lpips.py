"""PyTorch port, LPIPS (``utils/lpips.py``): alex and vgg distances and the
perceptual loss's gradient against the JAX package's ``utils/lpips.py`` on
the same random-weight ``.pth``; the refusal of a ``.pth`` holding only the
linear heads; the metric hook."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.utils import lpips as jlpips
from image_restoration_sde_tpu_torch.utils import lpips


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread in this module: the suite runs several workers on
    the machine's cores, where many threads a worker spin on tiny ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["alex", "vgg"])
def weights(request, tmp_path_factory):
    """(net, .pth path) of random lpips weights (``seeded_state_dict``)."""
    path = tmp_path_factory.mktemp("lpips") / f"lpips_{request.param}.pth"
    torch.save(lpips.seeded_state_dict(request.param, seed=1), str(path))
    return request.param, str(path)


def _pair(hw, seed):
    r = np.random.default_rng(seed)
    return tuple((r.random((2, *hw, 3)) * 2 - 1).astype(np.float32) for _ in range(2))


def test_distance_matches_jax(weights):
    """float32 distances of two pairs of odd sizes within 1e-5 of each
    distance (sums of O(1e5) float32 products in another order)."""
    net, path = weights
    a, b = _pair((37, 53), 0)
    params, jnet = jlpips.load_lpips(path)
    want = np.asarray(jlpips.lpips_distance(params, jnp.asarray(a), jnp.asarray(b), net=jnet))
    module = lpips.load_lpips(path, "cpu")
    assert module.net_name == jnet == net
    with torch.no_grad():
        got = lpips.lpips_distance(module, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_perceptual_loss_gradient_matches_jax(weights):
    """``make_perceptual_loss_fn`` on [0, 1] inputs: the loss within 1e-5 of
    itself and its gradient in the prediction within 1e-4 of max|grad|
    against ``jax.grad`` of the JAX one; the weights take no gradient."""
    _, path = weights
    a, b = (x * 0.5 + 0.5 for x in _pair((40, 36), 1))
    jfn = jlpips.make_perceptual_loss_fn(path)
    want_loss, want_grad = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(a), jnp.asarray(b))
    fn = lpips.make_perceptual_loss_fn(path, "cpu")
    pred = torch.from_numpy(a).requires_grad_(True)
    loss = fn(pred, torch.from_numpy(b))
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    want_grad = np.asarray(want_grad)
    assert np.abs(pred.grad.numpy() - want_grad).max() <= 1e-4 * np.abs(want_grad).max()


def test_metric_hook_matches_jax(weights, tmp_path, monkeypatch):
    """The uint8 metric (``make_lpips_fn``) within 1e-5 of the JAX one; the
    ``.npz`` form of the weights gives the same; ``IRSDE_LPIPS_PTH`` is read
    when no path is given, and neither gives no metric."""
    _, path = weights
    r = np.random.default_rng(2)
    a, b = (r.integers(0, 256, (64, 70, 3), dtype=np.uint8) for _ in range(2))
    want = jlpips.make_lpips_fn(path)(a, b)
    assert lpips.make_lpips_fn(path, "cpu")(a, b) == pytest.approx(want, rel=1e-5)
    npz = tmp_path / "w.npz"
    np.savez(str(npz), **{k: v.numpy() for k, v in torch.load(path).items()})
    assert lpips.make_lpips_fn(str(npz), "cpu")(a, b) == pytest.approx(want, rel=1e-5)
    monkeypatch.delenv("IRSDE_LPIPS_PTH", raising=False)
    assert lpips.lpips_fn_from_env_or_arg(None, "cpu") is None
    monkeypatch.setenv("IRSDE_LPIPS_PTH", path)
    assert lpips.lpips_fn_from_env_or_arg(None, "cpu")(a, a) == 0.0


def test_refuses_a_pth_of_the_linear_heads_only(weights, tmp_path):
    """The official v0.1 ``.pth`` (``lin*`` keys only) is refused, naming
    what to save instead, as the JAX loader refuses it."""
    net, path = weights
    heads = {k: v for k, v in torch.load(path).items() if k.startswith("lin")}
    bad = tmp_path / "heads.pth"
    torch.save(heads, str(bad))
    with pytest.raises(ValueError, match="linear heads"):
        lpips.load_lpips(str(bad), "cpu")
    with pytest.raises(ValueError, match="linear heads"):
        jlpips.load_lpips(str(bad))
