"""Statistical cross-check of the two warp implementations against the
reference's augmentation formulas (inlayers.py:77-122).

Exact PRNG parity with Theano RandomStreams is impossible by construction
(SURVEY.md §7 hard part (a)), so augmentation parity is defined at the
distribution level: the jax warp (ops/elastic.sample_warp) and the C++ host
warp (native/deformer.cc theanet_make_warp) must both produce displacement
fields
whose probe-pixel moments match an INDEPENDENT numpy Monte-Carlo
implementation of the reference arithmetic:

  target = indices(h,w)
         + translation * U(-1,1) per axis                 (inlayers.py:80-82)
         + magnitude * N(0,1) smoothed by the (2s+1)^2
           gaussian kernel exp(-d^2/2s^2)/(2 pi s^2)      (inlayers.py:87-97)
  then zoom/rotate about origin U(.25,.75)*(h,w):
         exp(ln zoom * U(-1,1)) per axis, angle deg * U(-1,1)
                                                          (inlayers.py:100-118)
  clip to [0, size-1-.001]                                (inlayers.py:121-122)

Each implementation draws its own RNG stream; the comparison is moments at
fixed probe pixels over N independent fields, with 5-sigma mean gates and
a 12% std gate (MC noise of std at N=600 is ~3%/axis on each side).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

H = 28
N_FIELDS = 600
PROBES = [(14, 14), (7, 7), (21, 7)]  # center + off-center (zoom/rot sensitive)

CONFIGS = {
    "translation": dict(translation=2.0),
    "elastic": dict(magnitude=20.0, sigma=3),
    "zoom_rot": dict(zoom=1.1, angle=5.0),
    # the mnist.prms recipe minus pflip (params/mnist.prms:2-13)
    "full": dict(translation=2.0, zoom=1.1, magnitude=20.0, sigma=3, angle=5.0),
}


# ----------------------------------------------------------------- oracle

def _gauss_kernel(sigma):
    taps = np.arange(-sigma, sigma + 1, dtype=np.float64)
    yy, xx = np.meshgrid(taps, taps, indexing="ij")
    return np.exp(-(yy * yy + xx * xx) / (2.0 * sigma * sigma)) / (
        2.0 * math.pi * sigma * sigma
    )


def _smooth_same(field, kern):
    """'full' conv then center crop (inlayers.py:94-96) == 'same' conv."""
    s = kern.shape[0] // 2
    h, w = field.shape
    pad = np.pad(field, s)
    out = np.zeros_like(field)
    for i in range(kern.shape[0]):
        for j in range(kern.shape[1]):
            out += kern[i, j] * pad[i : i + h, j : j + w]
    return out


def oracle_warp(rng, h, w, translation=0.0, zoom=1.0, magnitude=0.0,
                sigma=1, angle=0.0):
    """The reference warp pipeline in plain numpy — independent arithmetic
    (loop-based smoothing, no shared code with the framework)."""
    target = np.indices((h, w)).astype(np.float64)
    if translation:
        target += translation * rng.uniform(-1, 1, (2, 1, 1))
    if magnitude:
        kern = _gauss_kernel(int(sigma))
        elast = magnitude * rng.normal(size=(2, h, w))
        target += np.stack([_smooth_same(elast[0], kern),
                            _smooth_same(elast[1], kern)])
    if zoom != 1.0 or angle:
        origin = rng.uniform(0.25, 0.75, (2, 1, 1)) * np.array(
            [h, w], np.float64).reshape(2, 1, 1)
        target -= origin
        if zoom != 1.0:
            target *= np.exp(math.log(zoom) * rng.uniform(-1, 1, (2, 1, 1)))
        if angle:
            theta = angle * math.pi / 180.0 * rng.uniform(-1, 1)
            c, s = math.cos(theta), math.sin(theta)
            rot = np.array([[c, -s], [s, c]])
            target = np.tensordot(rot, target, axes=((0,), (0,)))
        target += origin
    target[0] = np.clip(target[0], 0, h - 1 - 0.001)
    target[1] = np.clip(target[1], 0, w - 1 - 0.001)
    return target


@pytest.fixture(scope="module")
def oracle_fields():
    out = {}
    for name, cfg in CONFIGS.items():
        rng = np.random.RandomState(99)
        out[name] = np.stack(
            [oracle_warp(rng, H, H, **cfg) for _ in range(N_FIELDS)]
        )
    return out


# ------------------------------------------------------------ comparisons

def _probe_stats(fields):
    """fields (N, 2, H, W) -> (mean, std) arrays over probes x axes."""
    vals = np.stack(
        [fields[:, :, py, px] for (py, px) in PROBES], axis=1
    )  # (N, probes, 2)
    return vals.mean(axis=0), vals.std(axis=0)


def _assert_moments_match(fields, oracle, label, rounded=False,
                          std_tol=0.12):
    if rounded:
        # the impl under test nearest-rounds its gather coordinates
        # (floor(t + .5)); quantize the oracle identically rather than
        # model the non-additive quantization noise
        oracle = np.floor(oracle + 0.5)
    m_i, s_i = _probe_stats(fields)
    m_o, s_o = _probe_stats(oracle)
    # 5-sigma two-sample gate on the means
    se = np.sqrt((s_i ** 2 + s_o ** 2) / N_FIELDS + 1e-12)
    assert np.all(np.abs(m_i - m_o) < 5 * se + 1e-6), (
        label, m_i, m_o, se)
    assert np.all(np.abs(s_i - s_o) <= std_tol * s_o + 0.02), (
        label, s_i, s_o)


# ------------------------------------------------------- implementations

def jax_fields(cfg):
    from theanet_tpu.ops.elastic import ElasticConfig, sample_warp

    ecfg = ElasticConfig(img_sz=H, **cfg)

    def one(key):
        t, _ = sample_warp(key, ecfg, H, H)
        return jnp.stack([jnp.clip(t[0], 0, H - 1 - 0.001),
                          jnp.clip(t[1], 0, H - 1 - 0.001)])

    keys = jax.random.split(jax.random.PRNGKey(123), N_FIELDS)
    return np.asarray(jax.jit(jax.vmap(one))(keys))


def native_fields(cfg):
    from theanet_tpu.io.pipeline import make_warp_host, native_lib

    if native_lib() is None:
        pytest.skip("native library unavailable")
    out = np.stack([
        make_warp_host(H, H, translation=cfg.get("translation", 0),
                       zoom=cfg.get("zoom", 1),
                       magnitude=cfg.get("magnitude", 0),
                       sigma=cfg.get("sigma", 1),
                       angle=cfg.get("angle", 0), seed=1000 + s)
        for s in range(N_FIELDS)
    ])
    out[:, 0] = np.clip(out[:, 0], 0, H - 1 - 0.001)
    out[:, 1] = np.clip(out[:, 1], 0, H - 1 - 0.001)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_warp_matches_reference_moments(name, oracle_fields):
    _assert_moments_match(jax_fields(CONFIGS[name]), oracle_fields[name],
                          f"jax:{name}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_native_warp_matches_reference_moments(name, oracle_fields):
    _assert_moments_match(native_fields(CONFIGS[name]), oracle_fields[name],
                          f"native:{name}")
