"""Elastic / affine / noise augmentation ops.

Semantics reproduce the reference augmentation engine (reference:
theanet/layer/inlayers.py:29-163):

  * one warp field of shape (2, h, w) is sampled **per batch** and applied
    identically to every image and channel (inlayers.py:124-137) — only the
    pixel-flip noise is per-element (inlayers.py:140-142);
  * pipeline order: translate -> elastic field (Gaussian-smoothed white
    noise) -> zoom & rotate about a random origin -> clip to
    [0, size-1-.001] -> nearest/bilinear resample -> pflip;
  * the 0.001 clip margin is load-bearing: bilinear gathers index +1 past the
    floor and stay in-bounds only because of it (inlayers.py:121-137);
  * zoom is log-symmetric (x in [1/zoom, zoom]); angle is degrees.

Design notes:

  * The Gaussian smoothing of the elastic field is expressed as two small
    banded matmuls (the reference builds an explicit (2s+1)^2 kernel and runs
    a 'full' conv then crops, inlayers.py:87-96 — mathematically identical to
    'same' zero-padded convolution, and the Gaussian is separable, so
    ``G_h @ field @ G_w^T`` is exact).
  * Because the warp is shared across the batch, resampling is a fixed linear
    map of the flattened image: out = x_flat @ S^T with S a (hw, hw) matrix
    holding the <=4 bilinear taps per output pixel (``method='matmul'``).
    ``method='gather'``, the default, indexes the taps with XLA's gather
    instead. Inside the flagship's train step on an H100 (700 W) the gather
    took 147 us per step against the matmul's 155-157 us at 28x28, and
    217-238 us against 297-322 us at 64x64, in both interpolation modes
    (tools/resample_timing.py).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "ElasticConfig",
    "gaussian_band_matrices",
    "sample_warp",
    "resample",
    "pixel_flip",
    "elastic_augment",
]


class ElasticConfig(NamedTuple):
    img_sz: int
    translation: float = 0
    zoom: float = 1
    magnitude: float = 0
    sigma: int = 1
    pflip: float = 0
    angle: float = 0
    invert_image: bool = False
    nearest: bool = False

    @property
    def is_identity(self) -> bool:
        # Reference short-circuit (inlayers.py:67-70): invert still applies.
        return (
            not (self.magnitude or self.translation or self.pflip or self.angle)
            and self.zoom == 1
        )


@functools.lru_cache(maxsize=32)
def gaussian_band_matrices(h: int, w: int, sigma: int):
    """Banded smoothing matrices (G_h, G_w) equal to the reference's 2-D
    Gaussian 'full'-conv-then-crop (inlayers.py:87-96), factored separably.

    filt[i, j] = exp(-(i^2+j^2)/(2 s^2)) / (2 pi s^2)
               = k1[i] * k1[j],  k1[i] = exp(-i^2/(2 s^2)) / sqrt(2 pi s^2)
    """
    var = float(sigma) ** 2
    taps = np.arange(-sigma, sigma + 1, dtype=np.float64)
    k1 = np.exp(-0.5 * taps * taps / var) / math.sqrt(2 * math.pi * var)

    def band(n):
        g = np.zeros((n, n), dtype=np.float32)
        for d, v in zip(range(-sigma, sigma + 1), k1):
            idx = np.arange(max(0, -d), min(n, n - d))
            g[idx, idx + d] = v
        return g

    return band(h), band(w)


def sample_warp(key, cfg: ElasticConfig, h: int, w: int, with_debug: bool = False):
    """Sample the per-batch warp target grid, shape (2, h, w), float32.

    Mirrors the reference pipeline order exactly (inlayers.py:77-118). Returns
    (target, debug_dict) — debug entries feed the augmentation visualizer,
    like the reference's ``debugout`` (inlayers.py:145-155).
    """
    k_sc, k_el = jax.random.split(key)
    # ONE vector draw covers all seven affine scalars (translation y/x,
    # origin y/x, zoom y/x, theta). Each separate RNG call is a distinct
    # rng-bit-generator op — consolidating five draws into one removes four
    # ops per step. Statistically identical to separate draws.
    u = jax.random.uniform(k_sc, (7,), minval=-1.0, maxval=1.0)
    target = jnp.asarray(np.indices((h, w)), dtype=jnp.float32)
    debug = {}

    if cfg.translation:
        transln = cfg.translation * u[0:2].reshape(2, 1, 1)
        target = target + transln
        if with_debug:
            debug["translation"] = transln

    if cfg.magnitude:
        gh, gw = gaussian_band_matrices(h, w, int(cfg.sigma))
        elast = cfg.magnitude * jax.random.normal(k_el, (2, h, w))
        elast = jnp.einsum(
            "ij,cjk,lk->cil", jnp.asarray(gh), elast, jnp.asarray(gw)
        )
        target = target + elast

    if cfg.zoom - 1 or cfg.angle:
        # origin ~ U(.25,.75): map u in (-1,1) -> (.25,.75) (inlayers.py:101-102)
        origin = (0.5 + 0.25 * u[2:4].reshape(2, 1, 1)) * jnp.array(
            [h, w], dtype=jnp.float32
        ).reshape(2, 1, 1)
        target = target - origin

        if cfg.zoom - 1:
            zoomer = jnp.exp(math.log(cfg.zoom) * u[4:6].reshape(2, 1, 1))
            target = target * zoomer
            if with_debug:
                debug["zoom"] = zoomer

        if cfg.angle:
            theta = cfg.angle * math.pi / 180.0 * u[6]
            c, s = jnp.cos(theta), jnp.sin(theta)
            rot = jnp.stack(
                [jnp.stack([c, -s]), jnp.stack([s, c])]
            )  # [[c,-s],[s,c]]
            # Contract the FIRST axis of the rotation matrix with the first
            # axis of the target, matching the reference's
            # tensordot(rotate, target, axes=((0,0))) (inlayers.py:115).
            target = jnp.einsum("ik,ihw->khw", rot, target)
            if with_debug:
                debug["theta_deg"] = theta * 180.0 / math.pi

        target = target + origin
        if with_debug:
            debug["origin"] = origin

    return target, debug


def _clip_warp(target, h, w):
    ty = jnp.clip(target[0], 0.0, h - 1 - 0.001)
    tx = jnp.clip(target[1], 0.0, w - 1 - 0.001)
    return ty, tx


def _resample_gather(x, ty, tx, nearest: bool):
    """Advanced-index gather resample; x is (B, C, H, W), ty/tx are (h, w)."""
    if nearest:
        # iround = round half away from zero; coordinates are non-negative so
        # floor(v + .5) matches (inlayers.py:124-127).
        vert = jnp.floor(ty + 0.5).astype(jnp.int32)
        horz = jnp.floor(tx + 0.5).astype(jnp.int32)
        return x[:, :, vert, horz]

    topp = ty.astype(jnp.int32)  # trunc == floor for non-negative
    left = tx.astype(jnp.int32)
    fy = ty - topp
    fx = tx - left
    return (
        x[:, :, topp, left] * (1 - fy) * (1 - fx)
        + x[:, :, topp, left + 1] * (1 - fy) * fx
        + x[:, :, topp + 1, left] * fy * (1 - fx)
        + x[:, :, topp + 1, left + 1] * fy * fx
    )


def _resample_matrix(ty, tx, h, w, nearest: bool):
    """Dense (hw, hw) sampling matrix S with S[p, q] = tap weight of source
    pixel q for output pixel p. out = x_flat @ S^T. Exact same arithmetic as
    the gather path, done as one matrix product."""
    hw = h * w
    cols = jax.lax.broadcasted_iota(jnp.int32, (hw, hw), 1)

    if nearest:
        vert = jnp.floor(ty + 0.5).astype(jnp.int32)
        horz = jnp.floor(tx + 0.5).astype(jnp.int32)
        q = vert * w + horz
        return (cols == q.reshape(hw, 1)).astype(jnp.float32)

    topp = ty.astype(jnp.int32)
    left = tx.astype(jnp.int32)
    fy = (ty - topp).reshape(hw, 1)
    fx = (tx - left).reshape(hw, 1)
    q00 = (topp * w + left).reshape(hw, 1)
    # One compare + three column rolls instead of four hw^2 compares: the
    # +1/+w/+w+1 taps are column shifts of the q00 one-hot, and the warp
    # clip to size-1-.001 keeps q00+w+1 <= hw-1 so no roll wraps.
    e = (cols == q00).astype(jnp.float32)
    return (e * ((1 - fy) * (1 - fx))
            + jnp.roll(e, 1, axis=1) * ((1 - fy) * fx)
            + jnp.roll(e, w, axis=1) * (fy * (1 - fx))
            + jnp.roll(e, w + 1, axis=1) * (fy * fx))


def resample(x, target, *, nearest: bool = False, method: str = "gather"):
    """Resample batch x (B, C, H, W) at warp ``target`` (2, h, w).

    method: 'gather' | 'matmul' (see the module notes).
    """
    b, c, h, w = x.shape
    # Resample math runs in f32 regardless of the network compute dtype (the
    # tap weights and warp are f32; mixed-dtype dots are not allowed).
    x = x.astype(jnp.float32)
    ty, tx = _clip_warp(target, h, w)
    if method == "gather":
        return _resample_gather(x, ty, tx, nearest)
    if method == "matmul":
        s = _resample_matrix(ty, tx, h, w, nearest)
        flat = x.reshape(b * c, h * w)
        out = jax.lax.dot_general(
            flat,
            s,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return out.reshape(b, c, h, w)
    raise ValueError(f"unknown resample method: {method}")


def pixel_flip(key, x, pflip: float):
    """Per-element Bernoulli(pflip) value flip v -> 1-v (inlayers.py:140-142)."""
    mask = jax.random.bernoulli(key, pflip, x.shape).astype(x.dtype)
    return x + mask * (1.0 - 2.0 * x)


def elastic_augment(
    key,
    x,
    cfg: ElasticConfig,
    *,
    train: bool = True,
    method: str = "gather",
    with_debug: bool = False,
):
    """Full augmentation pipeline. In eval mode (or identity config) only the
    invert flag applies (reference TestVersion, inlayers.py:157-163).

    Returns (output, debug) where debug includes the displacement field when
    ``with_debug`` (parity with the reference's debugout hook)."""
    if cfg.invert_image:
        x = 1.0 - x

    if not train or cfg.is_identity:
        return x, {}

    k_warp, k_flip = jax.random.split(key)
    target, debug = sample_warp(k_warp, cfg, x.shape[2], x.shape[3], with_debug)
    out = resample(x, target, nearest=cfg.nearest, method=method)
    if cfg.pflip:
        out = pixel_flip(k_flip, out, cfg.pflip)
    if with_debug:
        idg = np.indices((x.shape[2], x.shape[3]))
        debug["displacement"] = target - jnp.asarray(idg, dtype=jnp.float32)
    return out, debug
