"""Elastic augmentation engine tests: identity semantics, resample-path
equivalence (gather vs matmul), Gaussian smoothing parity with an
explicit full-conv reference, clip-margin safety, pflip statistics."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from theanet_tpu.ops.elastic import (
    ElasticConfig,
    elastic_augment,
    gaussian_band_matrices,
    pixel_flip,
    resample,
    sample_warp,
)

KEY = jax.random.PRNGKey(0)


def rand_img(b=3, c=2, h=12, w=12, seed=0):
    return jnp.asarray(
        np.random.RandomState(seed).rand(b, c, h, w).astype(np.float32)
    )


# ------------------------- identity & invert -------------------------------


def test_identity_config_passthrough():
    cfg = ElasticConfig(img_sz=12)
    assert cfg.is_identity
    x = rand_img()
    out, _ = elastic_augment(KEY, x, cfg, train=True)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(x))


def test_invert_applies_even_when_identity_and_in_eval():
    cfg = ElasticConfig(img_sz=12, invert_image=True)
    x = rand_img()
    for train in (True, False):
        out, _ = elastic_augment(KEY, x, cfg, train=train)
        np.testing.assert_allclose(np.asarray(out), 1 - np.asarray(x), rtol=1e-6)


def test_eval_mode_disables_augmentation():
    cfg = ElasticConfig(
        img_sz=12, translation=2, zoom=1.1, magnitude=20, sigma=3, pflip=0.1, angle=5
    )
    x = rand_img()
    out, _ = elastic_augment(KEY, x, cfg, train=False)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(x))


# ------------------------- resample paths ----------------------------------


def identity_target(h, w):
    return jnp.asarray(np.indices((h, w)), dtype=jnp.float32)


def test_resample_identity_grid_is_noop():
    """Interior pixels reproduce exactly; the last row/column blend slightly
    because the warp clips to h-1-.001 (the reference's load-bearing margin,
    inlayers.py:121-122) — so they get atol ~1e-3."""
    x = rand_img()
    t = identity_target(12, 12)
    for nearest in (False, True):
        for method in ("gather", "matmul"):
            out = np.asarray(resample(x, t, nearest=nearest, method=method))
            np.testing.assert_allclose(
                out[:, :, :11, :11], np.asarray(x)[:, :, :11, :11], atol=1e-5
            )
            np.testing.assert_allclose(out, np.asarray(x), atol=2e-3)


def test_resample_integer_shift_matches_roll():
    x = rand_img(b=1, c=1)
    t = identity_target(12, 12) + jnp.array([2.0, 3.0]).reshape(2, 1, 1)
    out = np.asarray(resample(x, t, nearest=False, method="gather"))[0, 0]
    src = np.asarray(x)[0, 0]
    # interior pixels: out[i,j] = src[i+2, j+3]
    np.testing.assert_allclose(out[:9, :8], src[2:11, 3:11], atol=1e-5)


def test_matmul_equals_gather_on_random_warps():
    x = rand_img(b=4, c=3, h=16, w=16, seed=5)
    rng = np.random.RandomState(1)
    t = identity_target(16, 16) + jnp.asarray(
        rng.uniform(-4, 4, size=(2, 16, 16)).astype(np.float32)
    )
    for nearest in (False, True):
        g = np.asarray(resample(x, t, nearest=nearest, method="gather"))
        m = np.asarray(resample(x, t, nearest=nearest, method="matmul"))
        np.testing.assert_allclose(g, m, atol=1e-4)


def test_clip_margin_keeps_bilinear_in_bounds():
    x = rand_img(b=1, c=1)
    t = identity_target(12, 12) + 100.0  # way out of range
    out = resample(x, t, nearest=False, method="gather")
    assert np.isfinite(np.asarray(out)).all()
    # warp clamps to bottom-right pixel
    np.testing.assert_allclose(
        np.asarray(out)[0, 0, 5, 5], np.asarray(x)[0, 0, 11, 11], atol=1e-3
    )


# ------------------------- gaussian smoothing ------------------------------


def explicit_full_conv_reference(field, sigma):
    """The reference's exact construction: explicit (2s+1)^2 kernel, 'full'
    conv, crop [s : n+s] (inlayers.py:87-96), in pure numpy."""
    var = sigma**2
    filt = np.array(
        [
            [np.exp(-0.5 * (i * i + j * j) / var) for i in range(-sigma, sigma + 1)]
            for j in range(-sigma, sigma + 1)
        ],
        dtype=np.float64,
    )
    filt /= 2 * np.pi * var
    c, h, w = field.shape
    kh = kw = 2 * sigma + 1
    out = np.zeros((c, h + kh - 1, w + kw - 1))
    for ci in range(c):
        for i in range(h):
            for j in range(w):
                out[ci, i : i + kh, j : j + kw] += field[ci, i, j] * filt
    return out[:, sigma : h + sigma, sigma : w + sigma]


@pytest.mark.parametrize("sigma", [1, 3, 5])
def test_band_matrices_match_explicit_conv(sigma):
    h = w = 10
    rng = np.random.RandomState(0)
    field = rng.randn(2, h, w)
    gh, gw = gaussian_band_matrices(h, w, sigma)
    ours = np.einsum("ij,cjk,lk->cil", gh, field, gw)
    ref = explicit_full_conv_reference(field, sigma)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)


# ------------------------- warp statistics ---------------------------------


def test_translation_only_warp_is_rigid_shift():
    cfg = ElasticConfig(img_sz=12, translation=3)
    t, _ = sample_warp(KEY, cfg, 12, 12)
    disp = np.asarray(t) - np.indices((12, 12))
    # one shared offset per axis
    assert np.allclose(disp[0], disp[0][0, 0]) and np.allclose(disp[1], disp[1][0, 0])
    assert np.abs(disp).max() <= 3.0


def test_zoom_is_log_symmetric_about_origin():
    cfg = ElasticConfig(img_sz=12, zoom=2.0)
    scales = []
    for i in range(200):
        t, _ = sample_warp(jax.random.PRNGKey(i), cfg, 12, 12)
        d = np.asarray(t)
        # recover per-axis scale from the linear map
        scales.append((d[0, 11, 0] - d[0, 0, 0]) / 11.0)
    scales = np.array(scales)
    assert scales.min() >= 0.5 - 1e-3 and scales.max() <= 2.0 + 1e-3
    # log-symmetric: mean of log-scale ~ 0
    assert abs(np.log(scales).mean()) < 0.15


def test_pflip_flips_expected_fraction():
    x = jnp.zeros((8, 1, 32, 32))
    out = np.asarray(pixel_flip(KEY, x, 0.25))
    frac = out.mean()  # flipped zeros become ones
    assert 0.2 < frac < 0.3


def test_full_pipeline_shapes_and_range():
    cfg = ElasticConfig(
        img_sz=16, translation=2, zoom=1.2, magnitude=30, sigma=4,
        pflip=0.02, angle=10, invert_image=True,
    )
    x = rand_img(b=5, c=1, h=16, w=16)
    out, dbg = elastic_augment(KEY, x, cfg, train=True, with_debug=True)
    assert out.shape == x.shape
    assert np.isfinite(np.asarray(out)).all()
    assert "displacement" in dbg and dbg["displacement"].shape == (2, 16, 16)
