"""Independent numpy trajectory oracles for EVERY output head.

tests/test_reference_oracle.py pins the conv->pool->hidden->softmax/nll
trajectory; this file extends the same evidence class to the remaining
heads, each re-derived by hand in float64 numpy (no jax, no shared code
with the framework):

  * CenteredOutLayer LOGIT, frozen centers   (outlayers.py:153-224 LOGIT arm)
  * CenteredOutLayer RBF + learn_centers + finite junk_dist (RBF arm)
  * SoftAuxLayer (additive aux logits, 8-tensor packing, aux MLP chain)
                                              (auxiliary.py:102-160)
  * HingeLayer (whole-matrix hinge mean)      (outlayers.py:62-64,129-147)
  * ExpLossLayer (row-centered, exp loss)     (outlayers.py:38-39,105-126)
  * Softmax with the nllsq and truncated nllNN loss variants
                                              (outlayers.py:41-48)

Each test trains Input -> Hidden(relu10) -> Head for 12 steps (3 epochs,
annealed LR, maxnorms that bite) through the framework's scanned path and
asserts per-step cost and end-state params+momentum against the oracle.

Determinism: dropout off; SoftAux's random convex row-mix is made
deterministic by feeding aux tensors whose two rows are IDENTICAL (the mix
u*r + (1-u)*r = r for every u), so the oracle needs no RNG matching.
"""

import numpy as np

import jax.numpy as jnp

from theanet_tpu.model import NeuralNet

SEED = 4242
BATCH = 8
IMG = 4                      # flat n_in = 16
N_IN = IMG * IMG
N_HID = 12
HID_SLOPE = 0.10             # relu10
EPS = 0.001                  # LOGIT squeeze (outlayers.py:203-204)

HID_REG = {"L1": 1e-4, "momentum": 0.9, "rate": 1, "maxnorm": 0.7, "L2": 0}
HEAD_REG = {"L2": 1e-3, "momentum": 0.95, "rate": 0.5, "maxnorm": 0.8, "L1": 0}
INIT_LR = 0.1
HALF = 2
STEPS_PER_EPOCH = 4
EPOCHS = 3


def _lrelu(z, s):
    return np.maximum(0.0, z) + np.minimum(0.0, z) * s


def _dense_draw(rng, n_in, n_out, actvn):
    """init_wb's dense rule (weights.py:56-65): U(-1,1)*sqrt(6/(2(in+out)))
    with the x4 sigmoid bump and the relu0x-only 0.5 bias."""
    s = np.sqrt(6.0 / (2.0 * (n_in + n_out)))
    w = (rng.uniform(-1, 1, (n_in, n_out)) * s).astype(np.float32)
    b = np.zeros((n_out,), np.float32)
    if actvn == "sigmoid":
        w = w * 4
    if actvn in ("softplus", "relu") or actvn.startswith("relu0"):
        b = b + np.float32(0.5)
    return w.astype(np.float64), b.astype(np.float64)


def _update(params, moms, grads, regs, lr):
    """Old-accumulator momentum + per-ndim max-norm (layer.py:82-103)."""
    new_p, new_m = [], []
    for p, a, g, reg in zip(params, moms, grads, regs):
        if reg["L2"]:
            g = g + 2.0 * reg["L2"] * p
        if reg["L1"]:
            g = g + reg["L1"] * np.sign(p)
        a_new = reg["momentum"] * a + (1 - reg["momentum"]) * g
        p_new = p - reg["rate"] * lr * a
        mn = reg["maxnorm"]
        if mn:
            if p.ndim == 1:
                p_new = np.clip(p_new, -mn, mn)
            else:
                norms = np.sqrt((p_new ** 2).sum(axis=0))
                desired = np.clip(norms, 0, mn)
                p_new = p_new * ((1e-7 + desired) / (1e-7 + norms))
        new_p.append(p_new)
        new_m.append(a_new)
    return new_p, new_m


def _wt_cost(params, reg):
    c = 0.0
    if reg["L1"]:
        c += reg["L1"] * sum(np.abs(p).sum() for p in params)
    if reg["L2"]:
        c += reg["L2"] * sum((p ** 2).sum() for p in params)
    return c


def _data(n_steps=STEPS_PER_EPOCH, n_out=4, seed=99):
    rng = np.random.RandomState(seed)
    xs = rng.rand(n_steps, BATCH, 1, IMG, IMG).astype(np.float32)
    ys = rng.randint(0, n_out, (n_steps, BATCH)).astype(np.int32)
    return xs, ys


def _run_and_compare(net, head_oracle, n_out, aux=None):
    """Drive net.train_step for 12 steps against the oracle. head_oracle is
    an object with .init(rng) -> params, .step(h, y, params) ->
    (cost_data, dh, dparams), .regs (per-param reg dicts)."""
    params, moms = net.init_params()
    xs, ys = _data(n_out=n_out)

    rng = np.random.RandomState(SEED)
    o_wh, o_bh = _dense_draw(rng, N_IN, N_HID, "relu10")
    o_head = head_oracle.init(rng)
    o_params = [o_wh, o_bh] + o_head
    o_moms = [np.zeros_like(p) for p in o_params]
    regs = [HID_REG, HID_REG] + head_oracle.regs

    step = 0
    for epoch in range(EPOCHS):
        lr = net.get_rate()
        for i in range(STEPS_PER_EPOCH):
            aux_b = None if aux is None else jnp.asarray(aux[i])
            params, moms, cost, _, _ = net.train_step(
                params, moms, jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                key=net.base_key, lr=lr, aux=aux_b,
            )
            # ----- oracle step
            x = xs[i].reshape(BATCH, -1).astype(np.float64)
            zh = x @ o_params[0] + o_params[1]
            h = _lrelu(zh, HID_SLOPE)
            o_aux = None if aux is None else aux[i].astype(np.float64)
            cost_data, dh, d_head = head_oracle.step(
                h, ys[i], o_params[2:], o_aux
            )
            dzh = dh * np.where(zh > 0, 1.0, HID_SLOPE)
            dwh = x.T @ dzh
            dbh = dzh.sum(axis=0)
            o_cost = (cost_data
                      + _wt_cost(o_params[:2], HID_REG)
                      + head_oracle.wt_cost(o_params[2:]))
            o_params, o_moms = _update(
                o_params, o_moms, [dwh, dbh] + d_head, regs, lr
            )
            step += 1
            assert abs(float(cost) - o_cost) < 3e-5 * max(1.0, abs(o_cost)), (
                f"{type(head_oracle).__name__}: cost diverged at step "
                f"{step}: {float(cost)} vs {o_cost}"
            )
        net.inc_epoch_set_rate()

    got = [np.asarray(w, np.float64) for lyr in params for w in lyr]
    # frozen extras (e.g. constant centers) ride at the tail of the layer's
    # param list without momentum; compare only the trainable prefix that
    # the oracle tracks — but never let a MISSING trainable param truncate
    # the comparison (zip would silently skip it)
    assert len(got) >= len(o_params), (len(got), len(o_params))
    assert len(got) - len(o_params) <= 1, (
        "more than the one known frozen extra (constant centers) beyond "
        "the oracle's params — extend the oracle instead of skipping"
    )
    for g, w in zip(got, o_params):
        np.testing.assert_allclose(g, w, atol=7e-5, rtol=0)
    got_m = [np.asarray(a, np.float64) for lyr in moms for a in lyr]
    assert len(got_m) >= len(o_moms)
    for g, w in zip(got_m, o_moms):
        np.testing.assert_allclose(g, w, atol=7e-5, rtol=0)


def _mk_net(head_spec, n_out):
    layers = [
        ["InputLayer", {"img_sz": IMG}],
        ["HiddenLayer", {"n_out": N_HID, "pdrop": 0, "actvn": "relu10",
                         "reg": HID_REG}],
        head_spec,
    ]
    tr_prms = {"SEED": SEED, "BATCH_SZ": BATCH, "NUM_EPOCHS": EPOCHS,
               "EPOCHS_TO_TEST": 1, "TEST_SAMP_SZ": BATCH,
               "INIT_LEARNING_RATE": INIT_LR, "EPOCHS_TO_HALF_RATE": HALF}
    return NeuralNet(layers, tr_prms)


# ------------------------------ LOGIT ---------------------------------------


class LogitOracle:
    """CenteredOut LOGIT, frozen binary centers (outlayers.py:173-175,
    203-206): sigmoid feats squeezed to [eps, 1-eps], bitprob
    c*v + (1-c)(1-v), logprob = sum of bit log-probs, loss nll."""

    def __init__(self, nf, nc):
        self.nf, self.nc = nf, nc
        self.regs = [HEAD_REG, HEAD_REG]

    def init(self, rng):
        w, b = _dense_draw(rng, N_HID, self.nf, "sigmoid")
        self.centers = rng.binomial(n=1, p=0.5,
                                    size=(self.nc, self.nf)).astype(np.float64)
        return [w, b]

    def wt_cost(self, params):
        return _wt_cost(params, HEAD_REG)

    def step(self, h, y, params, aux):
        w, b = params
        B = h.shape[0]
        z = h @ w + b
        s = 1.0 / (1.0 + np.exp(-z))
        v = s * (1 - 2 * EPS) + EPS
        cy = self.centers[y]                        # (B, nf)
        bp = cy * v + (1 - cy) * (1 - v)
        cost = -np.mean(np.log(bp).sum(axis=1))
        dv = -(2 * cy - 1) / (B * bp)
        dz = dv * (1 - 2 * EPS) * s * (1 - s)
        dw = h.T @ dz
        db = dz.sum(axis=0)
        dh = dz @ w.T
        return cost, dh, [dw, db]


def test_logit_frozen_centers_trajectory():
    net = _mk_net(
        ["CenteredOutLayer", {"n_features": 6, "n_classes": 4,
                              "kind": "LOGIT", "reg": HEAD_REG}], 4
    )
    _run_and_compare(net, LogitOracle(6, 4), n_out=4)


# ------------------------------ RBF -----------------------------------------


class RbfOracle:
    """CenteredOut RBF with learn_centers and finite junk_dist
    (outlayers.py:167-178, 211-214): scaled_tanh feats, squared distances
    + junk column, probs = softmax(-dists) over nc+1, centers trainable."""

    def __init__(self, nf, nc, junk):
        self.nf, self.nc, self.junk = nf, nc, junk
        self.regs = [HEAD_REG, HEAD_REG, HEAD_REG]

    def init(self, rng):
        w, b = _dense_draw(rng, N_HID, self.nf, "scaled_tanh")
        centers = rng.uniform(0, 1, (self.nc, self.nf)).astype(np.float32)
        return [w, b, centers.astype(np.float64)]

    def wt_cost(self, params):
        return _wt_cost(params, HEAD_REG)

    def step(self, h, y, params, aux):
        w, b, C = params
        B = h.shape[0]
        z = h @ w + b
        t = np.tanh(z * (2.0 / 3.0))
        v = 1.7 * t
        d = ((v[:, None, :] - C[None, :, :]) ** 2).sum(axis=2)  # (B, nc)
        daug = np.concatenate(
            [d, np.full((B, 1), self.junk)], axis=1)
        zc = -daug - (-daug).max(axis=1, keepdims=True)
        p = np.exp(zc) / np.exp(zc).sum(axis=1, keepdims=True)
        logp = zc - np.log(np.exp(zc).sum(axis=1, keepdims=True))
        cost = -np.mean(logp[np.arange(B), y])
        dd = (np.eye(self.nc + 1)[y][:, :self.nc] - p[:, :self.nc]) / B
        dv = 2.0 * (v * dd.sum(axis=1, keepdims=True) - dd @ C)
        dC = 2.0 * (C * dd.sum(axis=0)[:, None] - dd.T @ v)
        dz = dv * 1.7 * (2.0 / 3.0) * (1.0 - t * t)
        dw = h.T @ dz
        db = dz.sum(axis=0)
        dh = dz @ w.T
        return cost, dh, [dw, db, dC]


def test_rbf_learn_centers_trajectory():
    net = _mk_net(
        ["CenteredOutLayer", {"n_features": 8, "n_classes": 4, "kind": "RBF",
                              "learn_centers": True, "junk_dist": 5.0,
                              "reg": HEAD_REG}], 4
    )
    _run_and_compare(net, RbfOracle(8, 4, 5.0), n_out=4)


# ------------------------------ SoftAux -------------------------------------


class SoftAuxOracle:
    """SoftAux head (auxiliary.py:102-160): softmax(hidden_lin + cross_b +
    aux_mlp(aux) @ cross_w), nll; ALL 8 packed tensors trainable under the
    head's reg. Aux rows are identical, so the random convex mix is the
    identity and the trajectory is deterministic."""

    def __init__(self, nc, n_aux=(5, 9)):
        self.nc = nc
        self.nah, self.nao = n_aux
        self.regs = [HEAD_REG] * 8

    def init(self, rng):
        w, b = _dense_draw(rng, N_HID, self.nc, "linear")
        rng.randint(int(1e6))  # LocationInfo RandomStreams seed draw
        w1, b1 = _dense_draw(rng, 2, self.nah, "relu50")
        w2, b2 = _dense_draw(rng, self.nah, self.nao, "relu01")
        cw, cb = _dense_draw(rng, self.nao, self.nc, "softmax")
        return [w, b, w1, b1, w2, b2, cw, cb]

    def wt_cost(self, params):
        return _wt_cost(params, HEAD_REG)

    def step(self, h, y, params, aux):
        w, b, w1, b1, w2, b2, cw, cb = params
        B = h.shape[0]
        x2 = aux[:, 0, :]                 # rows identical -> mix == row 0
        z1 = x2 @ w1 + b1
        a1 = _lrelu(z1, 0.50)
        z2 = a1 @ w2 + b2
        a2 = _lrelu(z2, 0.01)
        logits = h @ w + b + cb + a2 @ cw
        zc = logits - logits.max(axis=1, keepdims=True)
        ez = np.exp(zc)
        p = ez / ez.sum(axis=1, keepdims=True)
        logp = zc - np.log(ez.sum(axis=1, keepdims=True))
        cost = -np.mean(logp[np.arange(B), y])
        dl = (p - np.eye(self.nc)[y]) / B
        dw = h.T @ dl
        db = dl.sum(axis=0)
        dcw = a2.T @ dl
        dcb = dl.sum(axis=0)
        da2 = dl @ cw.T
        dz2 = da2 * np.where(z2 > 0, 1.0, 0.01)
        dw2 = a1.T @ dz2
        db2 = dz2.sum(axis=0)
        da1 = dz2 @ w2.T
        dz1 = da1 * np.where(z1 > 0, 1.0, 0.50)
        dw1 = x2.T @ dz1
        db1 = dz1.sum(axis=0)
        dh = dl @ w.T
        return cost, dh, [dw, db, dw1, db1, dw2, db2, dcw, dcb]


def test_softaux_trajectory():
    net = _mk_net(
        ["SoftAuxLayer", {"n_out": 4, "n_aux": (5, 9),
                          "aux_type": "LocationInfo", "reg": HEAD_REG}], 4
    )
    rng = np.random.RandomState(7)
    row = rng.rand(STEPS_PER_EPOCH, BATCH, 1, 2).astype(np.float32)
    aux = np.concatenate([row, row], axis=2)  # identical rows
    _run_and_compare(net, SoftAuxOracle(4), n_out=4, aux=aux)


# ------------------------------ Hinge / Exp ---------------------------------


class HingeOracle:
    """Whole-matrix hinge mean (outlayers.py:62-64): the true class
    contributes its constant 1 to the mean — reference behavior."""

    def __init__(self, nc):
        self.nc = nc
        self.regs = [HEAD_REG, HEAD_REG]

    def init(self, rng):
        return list(_dense_draw(rng, N_HID, self.nc, "linear"))

    def wt_cost(self, params):
        return _wt_cost(params, HEAD_REG)

    def step(self, h, y, params, aux):
        w, b = params
        B = h.shape[0]
        o = h @ w + b
        o_true = o[np.arange(B), y][:, None]
        m = o + 1.0 - o_true
        cost = np.mean(np.maximum(0.0, m))
        active = (m > 0).astype(np.float64)
        do = active / (B * self.nc)
        do[np.arange(B), y] -= active.sum(axis=1) / (B * self.nc)
        dw = h.T @ do
        db = do.sum(axis=0)
        dh = do @ w.T
        return cost, dh, [dw, db]


def test_hinge_trajectory():
    net = _mk_net(["HingeLayer", {"n_out": 4, "reg": HEAD_REG}], 4)
    _run_and_compare(net, HingeOracle(4), n_out=4)


class ExpOracle:
    """Row-centered linear head with loss mean(exp(-score_true))
    (outlayers.py:38-39, 112)."""

    def __init__(self, nc):
        self.nc = nc
        self.regs = [HEAD_REG, HEAD_REG]

    def init(self, rng):
        return list(_dense_draw(rng, N_HID, self.nc, "linear"))

    def wt_cost(self, params):
        return _wt_cost(params, HEAD_REG)

    def step(self, h, y, params, aux):
        w, b = params
        B = h.shape[0]
        z = h @ w + b
        o = z - z.mean(axis=1, keepdims=True)
        e = np.exp(-o[np.arange(B), y])
        cost = np.mean(e)
        do = np.zeros_like(o)
        do[np.arange(B), y] = -e / B
        dz = do - do.mean(axis=1, keepdims=True)
        dw = h.T @ dz
        db = dz.sum(axis=0)
        dh = dz @ w.T
        return cost, dh, [dw, db]


def test_exp_trajectory():
    net = _mk_net(["ExpLossLayer", {"n_out": 4, "reg": HEAD_REG}], 4)
    _run_and_compare(net, ExpOracle(4), n_out=4)


# --------------------- Softmax loss variants (nllsq / nllNN) ----------------


class SoftmaxLossOracle:
    """Softmax head with the nllsq (squared, NOT negated, outlayers.py:41-42)
    or truncated nllNN (threshold NN/100, outlayers.py:44-48) loss."""

    def __init__(self, nc, loss):
        self.nc = nc
        self.loss = loss
        self.regs = [HEAD_REG, HEAD_REG]

    def init(self, rng):
        return list(_dense_draw(rng, N_HID, self.nc, "softmax"))

    def wt_cost(self, params):
        return _wt_cost(params, HEAD_REG)

    def step(self, h, y, params, aux):
        w, b = params
        B = h.shape[0]
        z = h @ w + b
        zc = z - z.max(axis=1, keepdims=True)
        ez = np.exp(zc)
        p = ez / ez.sum(axis=1, keepdims=True)
        logp = zc - np.log(ez.sum(axis=1, keepdims=True))
        lp_y = logp[np.arange(B), y]
        onehot = np.eye(self.nc)[y]
        if self.loss == "nllsq":
            cost = np.mean(lp_y ** 2)
            dlp_y = 2.0 * lp_y / B
        else:  # nll90
            thr = np.log(0.90)
            cost = np.mean(np.maximum(0.0, thr - lp_y))
            dlp_y = -(lp_y < thr).astype(np.float64) / B
        dz = dlp_y[:, None] * (onehot - p)
        dw = h.T @ dz
        db = dz.sum(axis=0)
        dh = dz @ w.T
        return cost, dh, [dw, db]


def test_nllsq_trajectory():
    net = _mk_net(["SoftmaxLayer", {"n_out": 4, "loss": "nllsq",
                                    "reg": HEAD_REG}], 4)
    _run_and_compare(net, SoftmaxLossOracle(4, "nllsq"), n_out=4)


def test_nll90_trajectory():
    net = _mk_net(["SoftmaxLayer", {"n_out": 4, "loss": "nll90",
                                    "reg": HEAD_REG}], 4)
    _run_and_compare(net, SoftmaxLossOracle(4, "nll90"), n_out=4)
