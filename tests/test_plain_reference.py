"""The plain reference's own building blocks against explicit loops and the
reference formulas, so that the oracle the trainer is held to is itself
checked: convolution modes and strides, pooling and its tie rule,
activations, losses and the update's max-norm projection."""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import plain_reference as ref


def _x64(fn, *args):
    with jax.enable_x64(True):
        out = fn(*[jnp.asarray(a) for a in args])
        return np.asarray(out)


def _conv_loop(x, w, mode, stride):
    """Theano conv2d by definition: out[b,m,i,j] = sum x[b,c,i+u,j+v] *
    w[m,c,f-1-u,f-1-v] over the (zero-padded for 'full') input."""
    b, c, h, _ = x.shape
    m, _, f, _ = w.shape
    if mode in ("full", "same"):
        x = np.pad(x, ((0, 0), (0, 0), (f - 1, f - 1), (f - 1, f - 1)))
    o = x.shape[2] - f + 1
    out = np.zeros((b, m, o, o))
    for i in range(o):
        for j in range(o):
            for u in range(f):
                for v in range(f):
                    out[:, :, i, j] += np.einsum(
                        "bc,mc->bm", x[:, :, i + u, j + v],
                        w[:, :, f - 1 - u, f - 1 - v])
    if mode == "same":
        s = (f - 1) // 2
        out = out[:, :, s:s + h, s:s + h]
    return out[:, :, ::stride, ::stride]


@pytest.mark.parametrize("mode,stride,f", [
    ("valid", 1, 3), ("valid", 2, 3), ("valid", 1, 2), ("full", 1, 3),
    ("same", 1, 3), ("same", 1, 5),
])
def test_conv_matches_definition(mode, stride, f):
    rng = np.random.RandomState(f + stride)
    x = rng.randn(2, 3, 9, 9)
    w = rng.randn(4, 3, f, f)
    got = _x64(lambda a, b: ref.conv2d(a, b, mode, stride), x, w)
    np.testing.assert_allclose(got, _conv_loop(x, w, mode, stride),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("p,ib", [(2, False), (2, True), (3, False),
                                  (3, True)])
def test_max_pool_matches_windows(p, ib):
    x = np.random.RandomState(p).randn(2, 3, 8, 8)
    o = 8 // p if ib else -(-8 // p)
    want = np.full((2, 3, o, o), -np.inf)
    for i in range(o):
        for j in range(o):
            win = x[:, :, i * p:(i + 1) * p, j * p:(j + 1) * p]
            want[:, :, i, j] = win.max(axis=(2, 3))
    np.testing.assert_array_equal(_x64(lambda a: ref.max_pool(a, p, ib), x),
                                  want)


def test_max_pool_gradient_reaches_every_tied_maximum():
    """Theano's MaxPoolGrad: each element equal to its window's max gets
    the full output gradient, not a share of it."""
    x = np.array([[[[1.0, 1.0, 0.0, 2.0],
                    [0.5, 1.0, 2.0, 2.0],
                    [3.0, 0.0, 0.0, 0.0],
                    [0.0, 0.0, 0.0, 0.0]]]])
    with jax.enable_x64(True):
        g = np.asarray(jax.grad(
            lambda a: jnp.sum(ref.max_pool(a, 2) * jnp.array(
                [[[[1.0, 2.0], [3.0, 4.0]]]])))(jnp.asarray(x)))
    want = np.array([[[[1.0, 1.0, 0.0, 2.0],
                       [0.0, 1.0, 2.0, 2.0],
                       [3.0, 0.0, 4.0, 4.0],
                       [0.0, 0.0, 4.0, 4.0]]]])
    np.testing.assert_array_equal(g, want)


def test_mean_pool_is_the_spatial_mean():
    x = np.random.RandomState(0).randn(2, 3, 5, 5)
    np.testing.assert_allclose(_x64(ref.mean_pool, x), x.mean(axis=(2, 3)),
                               rtol=1e-12)


@pytest.mark.parametrize("name,formula", [
    ("sigmoid", lambda z: 1 / (1 + np.exp(-z))),
    ("softplus", lambda z: np.log(1 + np.exp(z))),
    ("linear", lambda z: z),
    ("scaled_tanh", lambda z: 1.7 * np.tanh(2 * z / 3)),
    ("relu", lambda z: np.maximum(z, 0)),
    ("tanh", np.tanh),
    ("relu37", lambda z: np.where(z > 0, z, 0.37 * z)),
    ("softmax", lambda z: np.exp(z) / np.exp(z).sum(-1, keepdims=True)),
])
def test_activation_formulas(name, formula):
    z = np.linspace(-4, 4, 24).reshape(3, 8)
    np.testing.assert_allclose(_x64(ref.activation(name), z), formula(z),
                               rtol=1e-12, atol=1e-15)


def _hs(out):
    with jax.enable_x64(True):
        out = jnp.asarray(out)
        return {"output": out, "logprob": jax.nn.log_softmax(out, axis=1)}


@pytest.mark.parametrize("loss", ["nll", "nllsq", "nll50", "nllab", "hinge",
                                  "hinge_max", "exp"])
def test_loss_formulas(loss):
    rng = np.random.RandomState(3)
    out = rng.randn(6, 4)
    y = rng.randint(0, 4, 6)
    lp = out - np.log(np.exp(out).sum(1, keepdims=True))
    t = lp[np.arange(6), y]
    true = out[np.arange(6), y]
    others = np.where(np.eye(4)[y] > 0, -np.inf, out)
    want = {
        "nll": -t.mean(),
        "nllab": -t.mean(),
        "nllsq": (t ** 2).mean(),
        "nll50": np.maximum(0, np.log(0.5) - t).mean(),
        "hinge": np.maximum(0, out + 1 - true[:, None]).mean(),
        "hinge_max": np.maximum(0, 1 + others.max(1) - true).mean(),
        "exp": np.exp(-true).mean(),
    }[loss]
    with jax.enable_x64(True):
        got = float(ref.data_cost(loss, _hs(out), jnp.asarray(y)))
    assert abs(got - want) < 1e-12


@pytest.mark.parametrize("shape,axes", [((5,), None), ((4, 3), (0,)),
                                        ((3, 2, 2, 2), (1, 2, 3))])
def test_update_delays_momentum_and_projects_max_norm(shape, axes):
    """p <- p - rate lr a_OLD, a <- m a + (1-m) g, then the max-norm
    projection: 1-D clip, 2-D column norms, 4-D kernel norms."""
    rng = np.random.RandomState(len(shape))
    p, a, g = rng.randn(*shape), rng.randn(*shape), rng.randn(*shape)
    reg = {"momentum": 0.9, "rate": 0.5, "maxnorm": 0.7}
    layers = [["HiddenLayer", {"reg": reg}]]
    with jax.enable_x64(True):
        [[pn]], [[an]] = ref.update(layers, [[jnp.asarray(p)]],
                                    [[jnp.asarray(a)]], [[jnp.asarray(g)]],
                                    0.1)
    step = p - 0.5 * 0.1 * a
    if axes is None:
        want = np.clip(step, -0.7, 0.7)
    else:
        n = np.sqrt((step ** 2).sum(axis=axes, keepdims=True))
        want = step * (1e-7 + np.clip(n, 0, 0.7)) / (1e-7 + n)
    np.testing.assert_allclose(np.asarray(pn), want, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(an), 0.9 * a + 0.1 * g, rtol=1e-12)


@pytest.mark.gpu
def test_flagship_matches_reference_on_card():
    """The flagship at its published widths, 20 steps on the card under
    'highest', within 1e-4 of the float64 reference (chip_smoke.py (d))."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke

    g = chip_smoke.reference_gap()
    assert max(g["highest"]) < chip_smoke.GATE, g
