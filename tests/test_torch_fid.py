"""PyTorch port, FID (``utils/fid.py``): InceptionV3 pool3 features against
the JAX package's ``utils/fid.py`` on the same random weights, at two
image sizes (one upsampled to 299, one shrunk); the Fréchet distance and
the streaming statistics against the JAX ones; the batched ``FIDMetric``
against one image at a time."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.utils import fid as jfid
from image_restoration_sde_tpu_torch.utils import fid


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread in this module: the suite runs several workers on
    the machine's cores, where many threads a worker spin on tiny ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A pytorch-fid state dict of random weights, saved as a ``.pth``."""
    path = tmp_path_factory.mktemp("fid") / "inception.pth"
    torch.save(fid.seeded_state_dict(seed=0), str(path))
    return str(path)


def test_layer_table_matches_jax():
    assert list(fid.layer_shapes()) == jfid.conv_layer_names()


def test_pool3_features_match_jax(weights):
    """Two images of different sizes (80x96: upsampled to 299; 350x420:
    antialiased down) in one batched forward, against the JAX features of
    each image alone: within 1e-5 of max|feature| (float32 sums of ~1e4
    products through ~95 layers)."""
    r = np.random.default_rng(0)
    imgs = [r.random((1, 80, 96, 3), np.float32), r.random((1, 350, 420, 3), np.float32)]
    params = jfid.load_inception(weights)
    want = np.concatenate([np.asarray(jfid.inception_pool3_features(params, jnp.asarray(im))) for im in imgs])
    got = fid.inception_pool3_features(fid.load_inception(weights, "cpu"), [torch.from_numpy(im) for im in imgs])
    assert got.shape == (2, 2048)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_frechet_distance_and_feature_stats_match_jax():
    """The streaming mean and covariance (uneven chunks) to 1e-12, and the
    distance of two random 16-d sets to 1e-10 relative, against the JAX
    package's (both float64)."""
    r = np.random.default_rng(1)
    sets = [r.standard_normal((37, 16)), r.standard_normal((29, 16)) * 1.3 + 0.2]
    stats = []
    for feats in sets:
        mine, theirs = fid.FeatureStats(dim=16), jfid.FeatureStats(dim=16)
        for i in range(0, len(feats), 8):
            mine.update(feats[i : i + 8])
            theirs.update(feats[i : i + 8])
        (mu, sigma), (jmu, jsigma) = mine.stats(), theirs.stats()
        np.testing.assert_allclose(mu, jmu, rtol=0, atol=1e-12)
        np.testing.assert_allclose(sigma, jsigma, rtol=0, atol=1e-12)
        stats += [mu, sigma]
    assert fid.frechet_distance(*stats) == pytest.approx(jfid.frechet_distance(*stats), rel=1e-10)
    with pytest.raises(ValueError):
        fid.FeatureStats(dim=16).stats()


def test_batched_metric_matches_one_image_at_a_time(weights, monkeypatch):
    """Three pairs of three sizes: ``FIDMetric`` in batches of 2 (one flush
    on the second pair, one at the end) against batches of 1: the
    statistics (the FID is a function of them, ``frechet_distance``)
    within 1e-6 of their scale; ``reset`` starts over; ``IRSDE_FID_PTH`` is
    read when no path is given."""
    r = np.random.default_rng(2)
    outs = [r.integers(0, 256, (*hw, 3), dtype=np.uint8) for hw in [(40, 40), (52, 36), (61, 47)]]
    gts = [np.clip(o.astype(int) + r.integers(-40, 41, o.shape), 0, 255).astype(np.uint8) for o in outs]
    metrics = {b: fid.FIDMetric(weights, "cpu", batch=b) for b in (1, 2)}
    for m in metrics.values():
        for o, g in zip(outs, gts):
            m.update(o, g)
    assert metrics[2].count() == 3 and metrics[2].out_stats.n == 2 and metrics[1].out_stats.n == 3
    metrics[2].flush()
    for a, b in ((metrics[1].out_stats, metrics[2].out_stats), (metrics[1].ref_stats, metrics[2].ref_stats)):
        (mu1, s1), (mu2, s2) = a.stats(), b.stats()
        assert np.abs(mu1 - mu2).max() <= 1e-6 * np.abs(mu1).max()
        assert np.abs(s1 - s2).max() <= 1e-6 * np.abs(s1).max()
    metrics[2].reset()
    assert metrics[2].count() == 0
    monkeypatch.delenv("IRSDE_FID_PTH", raising=False)
    assert fid.fid_metric_from_env_or_arg(None, "cpu") is None
    monkeypatch.setenv("IRSDE_FID_PTH", weights)
    assert isinstance(fid.fid_metric_from_env_or_arg(None, "cpu"), fid.FIDMetric)


def test_refuses_a_state_dict_without_batchnorm(weights, tmp_path):
    sd = {k: v for k, v in torch.load(weights).items() if "running_var" not in k}
    with pytest.raises(ValueError, match="running_var"):
        fid.from_state_dict(sd)
