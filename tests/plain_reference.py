"""Plain float64 reference of the trainer's arithmetic, for tests and the card.

Written straight from the formulas of the Theano reference — not through
``theanet_tpu.layers`` — so that a mistake in the library cannot hide in
its own oracle:

  * true convolution (correlation with the flipped kernel) in 'valid',
    'full' and 'same' modes, stride by subsampling (convpool.py:53-70);
  * max pooling with and without ``ignore_border``, gradient to EVERY
    element equal to its window's max (Theano's MaxPoolGrad), and the mean
    pool (convpool.py:97-144);
  * dense layers and the activation registry (hidden.py:30, layer.py:11-54);
  * every head and loss (outlayers.py:12-224, auxiliary.py:14-160);
  * weight cost and the per-layer momentum / max-norm update with the
    one-step-delayed accumulator (layer.py:70-117).

Gradients are ``jax.grad`` of this module's own forward pass, so they do
not depend on the library's custom VJPs. Everything runs in float64 under
``jax.enable_x64``. Randomness has no reference: augmentation must be the
identity, dropout rates 0 in training, and an aux tensor's two rows equal
(which makes LocationInfo's random convex mix a no-op).

A network is given as the library's layer spec (a list of
``[name, kwargs]``) together with its weights in checkpoint (``allwts``)
order; shapes come from the weights themselves.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

DEFAULT_REG = {"L1": 0, "L2": 0, "momentum": 0.95, "rate": 1, "maxnorm": 0}
_REG_LAYERS = ("ConvLayer", "HiddenLayer", "SoftmaxLayer", "HingeLayer",
               "ExpLossLayer", "CenteredOutLayer", "SoftAuxLayer")
_HEADS = ("SoftmaxLayer", "HingeLayer", "ExpLossLayer", "CenteredOutLayer",
          "SoftAuxLayer")


# ------------------------------------------------------------ activations


def activation(name):
    """layer.py:11-54: sigmoid, softplus, softmax, linear, scaled_tanh,
    relu, tanh and the leaky relus reluNN with negative slope NN/100."""
    if name == "sigmoid":
        return lambda x: 1.0 / (1.0 + jnp.exp(-x))
    if name == "softplus":
        return lambda x: jnp.log1p(jnp.exp(x))
    if name in ("softmax", "Softmax"):
        return lambda x: jnp.exp(x - _logsumexp(x))
    if name == "linear":
        return lambda x: x
    if name == "scaled_tanh":
        return lambda x: 1.7 * jnp.tanh(2.0 * x / 3.0)
    if name == "relu":
        return lambda x: jnp.maximum(0.0, x)
    if name == "tanh":
        return jnp.tanh
    if name.startswith("relu") and len(name) == 6 and name[4:].isdigit():
        slope = int(name[4:]) / 100.0
        return lambda x: jnp.maximum(0.0, x) + jnp.minimum(0.0, x) * slope
    raise NotImplementedError("Unknown Activation Specified: " + name)


def _logsumexp(z):
    m = jax.lax.stop_gradient(jnp.max(z, axis=-1, keepdims=True))
    return m + jnp.log(jnp.sum(jnp.exp(z - m), axis=-1, keepdims=True))


def _log_softmax(z):
    return z - _logsumexp(z)


# ------------------------------------------------------------ conv / pool


def conv2d(x, w, mode="valid", stride=1):
    """True 2-D convolution of x (B, C, H, W) with w (M, C, f, f): each
    output sums x * w with the kernel reversed in both spatial axes.
    'full' pads f-1 zeros on every side, 'same' is the full result cropped
    by (f-1)//2, and a stride keeps every stride-th output of the
    stride-1 result."""
    f = w.shape[2]
    if mode in ("full", "same"):
        x = jnp.pad(x, ((0, 0), (0, 0), (f - 1, f - 1), (f - 1, f - 1)))
    oh, ow = x.shape[2] - f + 1, x.shape[3] - f + 1
    wf = w[:, :, ::-1, ::-1]
    out = 0.0
    for u in range(f):
        for v in range(f):
            out = out + jnp.einsum("bchw,mc->bmhw",
                                   x[:, :, u:u + oh, v:v + ow], wf[:, :, u, v])
    if mode == "same":
        s = (f - 1) // 2
        n = oh - (f - 1)
        out = out[:, :, s:s + n, s:s + n]
    return out[:, :, ::stride, ::stride]


def max_pool(x, p, ignore_border=False):
    """Max over p x p windows. ignore_border drops the partial tail
    (out = in // p); otherwise partial edge windows count (ceil). The
    value is the window max; the gradient goes in full to every element
    equal to it (ties included), written into the forward pass so that
    ``jax.grad`` returns Theano's rule."""
    b, m, h, _ = x.shape
    o = h // p if ignore_border else -(-h // p)
    full = o * p
    if full > h:
        x = jnp.pad(x, ((0, 0), (0, 0), (0, full - h), (0, full - h)),
                    constant_values=-jnp.inf)
    x = x[:, :, :full, :full]
    r = x.reshape(b, m, o, p, o, p)
    mx = jax.lax.stop_gradient(jnp.max(r, axis=(3, 5)))
    hit = r == mx[:, :, :, None, :, None]
    ties = jnp.where(hit, r - jax.lax.stop_gradient(r), 0.0)
    return mx + jnp.sum(ties, axis=(3, 5))


def mean_pool(x):
    return jnp.mean(x, axis=(2, 3))


# ------------------------------------------------------------ the network


def _reg(kw):
    r = dict(DEFAULT_REG)
    r.update(kw.get("reg") or {})
    return r


def trainable(layers, params):
    """Per tensor: is it updated and charged weight cost? Layers without a
    reg dict are frozen (layer.py:70-76); frozen CenteredOut centers ride
    in the weights but are not parameters."""
    out = []
    for (name, kw), lp in zip(layers, params):
        on = name in _REG_LAYERS and bool(_reg(kw)["rate"])
        flags = [on] * len(lp)
        if name == "CenteredOutLayer" and not kw.get("learn_centers", False):
            flags[2:] = [False] * (len(lp) - 2)
        out.append(flags)
    return out


def _location_info(wts, aux, boost, train):
    """auxiliary.py:14-57. In training the two rows are mixed by a random
    convex weight; the reference requires equal rows, so the mix is
    row 0 whatever the weight."""
    w1, b1, w2, b2 = wts
    x2 = aux[:, 0, :] if train else jnp.mean(aux, axis=1)
    x2 = x2 * boost
    hid = activation("relu50")(x2 @ w1 + b1)
    return activation("relu01")(hid @ w2 + b2)


def _check_plain(name, kw, train):
    if not train:
        return
    if name == "ElasticLayer":
        moving = (kw.get("magnitude", 0) or kw.get("translation", 0)
                  or kw.get("pflip", 0) or kw.get("angle", 0)
                  or kw.get("zoom", 1) != 1)
        if moving:
            raise ValueError("the plain reference has no augmentation")
    if name == "ColorLayer" and (kw.get("balance", 1) != 1
                                 or kw.get("gamma", 1) != 1):
        raise ValueError("the plain reference has no colour jitter")
    if kw.get("pdrop", 0):
        raise ValueError("the plain reference trains without dropout")


def forward(layers, params, x, aux=None, *, train):
    """Head state of the net: output, logprob, probs, y_preds (+ bitprob
    for LOGIT heads)."""
    out = x
    for (name, kw), wts in zip(layers, params):
        _check_plain(name, kw, train)
        if name in ("InputLayer", "ColorLayer"):
            continue
        if name == "ElasticLayer":
            if kw.get("invert_image"):
                out = 1.0 - out
        elif name == "ConvLayer":
            w, b = wts
            z = conv2d(out, w, kw.get("mode", "valid"), kw["stride"])
            out = activation(kw.get("actvn", "relu50"))(z + b[None, :, None,
                                                              None])
        elif name == "PoolLayer":
            out = max_pool(out, kw["pool_sz"], kw.get("ignore_border", False))
        elif name == "MeanLayer":
            out = mean_pool(out)
        elif name == "DropOutLayer":
            if not train:
                out = out * (1.0 - kw.get("pdrop", 0))
        elif name == "HiddenLayer":
            w, b = wts
            out = activation(kw.get("actvn", "relu01"))(
                out.reshape(out.shape[0], -1) @ w + b)
            if not train:
                out = out * (1.0 - kw.get("pdrop", 0))
        elif name == "AuxConcatLayer":
            enc = _location_info(wts, aux, kw.get("boost", 1), train)
            out = jnp.concatenate([out.reshape(out.shape[0], -1), enc], 1)
        elif name in _HEADS:
            return _head(name, kw, wts, out.reshape(out.shape[0], -1), aux,
                         train)
        else:
            raise NotImplementedError(name)
    raise ValueError("the net has no output head")


def _head(name, kw, wts, x, aux, train):
    if name == "SoftmaxLayer":
        z = x @ wts[0] + wts[1]
        logp = _log_softmax(z)
        return {"output": jnp.exp(logp), "probs": jnp.exp(logp),
                "logprob": logp, "y_preds": jnp.argmax(z, axis=1)}
    if name == "ExpLossLayer":
        raw = x @ wts[0] + wts[1]
        c = raw - jnp.mean(raw, axis=1, keepdims=True)
        logp = _log_softmax(c)
        return {"output": c, "probs": jnp.exp(logp), "logprob": logp,
                "y_preds": jnp.argmax(raw, axis=1)}
    if name == "HingeLayer":
        out = x @ wts[0] + wts[1]
        return {"output": out, "probs": out, "logprob": out,
                "y_preds": jnp.argmax(out, axis=1)}
    if name == "SoftAuxLayer":
        enc = _location_info(wts[2:6], aux, kw.get("boost", 1), train)
        z = x @ wts[0] + wts[1] + wts[7] + enc @ wts[6]
        logp = _log_softmax(z)
        return {"output": jnp.exp(logp), "probs": jnp.exp(logp),
                "logprob": logp, "y_preds": jnp.argmax(z, axis=1)}
    # CenteredOutLayer (outlayers.py:153-224)
    kind = kw.get("kind", "LOGIT")
    act = "sigmoid" if kind == "LOGIT" else "scaled_tanh"
    feats = activation(act)(x @ wts[0] + wts[1])
    v = feats[:, None, :]
    c = wts[2][None, :, :]
    if kind == "LOGIT":
        eps = 0.001
        v = v * (1 - 2 * eps) + eps
        bitprob = c * v + (1 - c) * (1 - v)
        logp = jnp.sum(jnp.log(bitprob), axis=2)
        return {"output": feats, "bitprob": bitprob, "logprob": logp,
                "probs": jnp.exp(logp), "y_preds": jnp.argmax(logp, axis=1)}
    d = jnp.sum((v - c) ** 2, axis=2)
    junk = jnp.full((d.shape[0], 1), kw.get("junk_dist", np.inf), d.dtype)
    d = jnp.concatenate([d, junk], axis=1)
    logp = _log_softmax(-d)
    return {"output": feats, "logprob": logp, "probs": jnp.exp(logp),
            "y_preds": jnp.argmax(logp, axis=1)}


def head_loss(name, kw):
    if name == "HingeLayer":
        return "hinge"
    if name == "ExpLossLayer":
        return "exp"
    return kw.get("loss", "nll")


def data_cost(loss, hs, y):
    """outlayers.py:12-64."""
    rows = jnp.arange(y.shape[0])
    lp_true = hs["logprob"][rows, y]
    if loss == "nll":
        return -jnp.mean(lp_true)
    if loss == "nllsq":
        return jnp.mean(lp_true ** 2)
    if loss.startswith("nll"):
        try:
            th = float(np.clip(int(loss[-2:]) / 100, 0, 1))
        except ValueError:
            return -jnp.mean(lp_true)
        return jnp.mean(jnp.maximum(0.0, np.log(th) - lp_true))
    out = hs["output"]
    true = out[rows, y]
    if loss == "hinge":
        return jnp.mean(jnp.maximum(0.0, out + 1.0 - true[:, None]))
    if loss == "hinge_max":
        wrong = jnp.where(jnp.arange(out.shape[1])[None, :] == y[:, None],
                          -jnp.inf, out)
        return jnp.mean(jnp.maximum(0.0, 1.0 + jnp.max(wrong, axis=1) - true))
    if loss == "exp":
        return jnp.mean(jnp.exp(-true))
    raise NotImplementedError(loss)


def weight_cost(layers, params):
    """layer.py:109-117: L1 sum|p| + L2 sum p^2 over a layer's trainable
    tensors, biases included."""
    cost = 0.0
    for (name, kw), lp, fl in zip(layers, params, trainable(layers, params)):
        if name not in _REG_LAYERS:
            continue
        r = _reg(kw)
        for p, on in zip(lp, fl):
            if name == "CenteredOutLayer" and not on:
                continue
            cost = cost + r["L1"] * jnp.sum(jnp.abs(p)) \
                + r["L2"] * jnp.sum(p ** 2)
    return cost


def cost(layers, params, x, y, aux=None):
    hs = forward(layers, params, x, aux, train=True)
    name, kw = layers[-1]
    return data_cost(head_loss(name, kw), hs, y) + weight_cost(layers, params)


def _max_norm(p, mn):
    """layer.py:88-103 with its 1e-7 guards."""
    if p.ndim == 1:
        return jnp.clip(p, -mn, mn)
    if p.ndim == 2:
        n = jnp.sqrt(jnp.sum(p ** 2, axis=0))
        return p * ((1e-7 + jnp.clip(n, 0, mn)) / (1e-7 + n))
    if p.ndim == 4:
        n = jnp.sqrt(jnp.sum(p ** 2, axis=(1, 2, 3)))
        return p * ((1e-7 + jnp.clip(n, 0, mn)) / (1e-7 + n))[:, None, None,
                                                              None]
    return p


def update(layers, params, moms, grads, lr):
    """a <- m a + (1-m) g together with p <- p - rate lr a_OLD, then the
    max-norm projection (layer.py:82-103)."""
    new_p, new_m = [], []
    for (name, kw), lp, lm, lg, fl in zip(layers, params, moms, grads,
                                          trainable(layers, params)):
        r = _reg(kw) if name in _REG_LAYERS else None
        ps, ms = [], []
        for p, a, g, on in zip(lp, lm, lg, fl):
            if not on:
                ps.append(p)
                ms.append(a)
                continue
            p_new = p - r["rate"] * lr * a
            if r["maxnorm"]:
                p_new = _max_norm(p_new, r["maxnorm"])
            ps.append(p_new)
            ms.append(r["momentum"] * a + (1 - r["momentum"]) * g)
        new_p.append(ps)
        new_m.append(ms)
    return new_p, new_m


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _step_fn(layers):
    def step(params, moms, x, y, aux, lr):
        c, g = jax.value_and_grad(
            lambda p: cost(layers, p, x, y, aux))(params)
        params, moms = update(layers, params, moms, g, lr)
        return params, moms, c

    return jax.jit(step)


def train(layers, allwts, xs, ys, lr, auxs=None):
    """Train from ``allwts`` over the batches xs[i], ys[i] (and auxs[i])
    at a fixed learning rate. Returns (per-step costs, params, moms) as
    float64 numpy."""
    layers = [[n, dict(kw)] for n, kw in layers]
    with jax.enable_x64(True):
        step = _step_fn(layers)
        params = _f64([list(lp) for lp in allwts])
        moms = jax.tree.map(jnp.zeros_like, params)
        costs = []
        for i in range(len(xs)):
            aux = None if auxs is None else _f64(auxs[i])
            params, moms, c = step(params, moms, _f64(xs[i]),
                                   jnp.asarray(np.asarray(ys[i], np.int32)),
                                   aux, lr)
            costs.append(float(c))
        to_np = functools.partial(jax.tree.map, lambda a: np.asarray(a))
        return np.asarray(costs), to_np(params), to_np(moms)


def grads(layers, allwts, x, y, aux=None):
    """(cost, gradient) of the training cost at ``allwts``, float64."""
    layers = [[n, dict(kw)] for n, kw in layers]
    with jax.enable_x64(True):
        c, g = jax.jit(jax.value_and_grad(
            lambda p, x, y, aux: cost(layers, p, x, y, aux)
        ))(_f64([list(lp) for lp in allwts]), _f64(x), jnp.asarray(y),
           None if aux is None else _f64(aux))
        return float(c), jax.tree.map(np.asarray, g)


def eval_stats(layers, allwts, x, y, aux=None):
    """(error rate, second statistic) of the eval pass (outlayers.py:69-80):
    the second is the mean true-class probability, or for LOGIT heads the
    share of true-class bits below one half."""
    layers = [[n, dict(kw)] for n, kw in layers]
    with jax.enable_x64(True):
        hs = jax.jit(lambda p, x, aux: forward(layers, p, x, aux,
                                               train=False))(
            _f64([list(lp) for lp in allwts]), _f64(x),
            None if aux is None else _f64(aux))
        y = np.asarray(y)
        err = float(np.mean(np.asarray(hs["y_preds"]) != y))
        rows = np.arange(len(y))
        if "bitprob" in hs:
            second = float(np.mean(np.asarray(hs["bitprob"])[rows, y] < 0.5))
        else:
            second = float(np.mean(np.asarray(hs["probs"])[rows, y]))
        return err, second
