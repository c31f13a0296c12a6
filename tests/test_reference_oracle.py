"""Reference-trajectory oracle: the reference's exact training arithmetic,
re-implemented independently in numpy, pinned against theanet_tpu for 20 steps.

The reference's defining guarantee is its training math:

  * init          — theanet/layer/weights.py:25-81 (draw order + scaling)
  * conv forward  — theanet/layer/convpool.py:54-72 (nnet.conv2d = TRUE
                    convolution: correlation with the flipped kernel)
  * dense forward — theanet/layer/hidden.py:30, activations layer.py:27-39
  * loss          — outlayers.py:50-51 (nll) + weight cost layer.py:109-117
  * update        — layer.py:82-103: a <- m a + (1-m) g simultaneously with
                    p <- p - reg.rate * lr * a_OLD, then max-norm projection
                    (1-D clip / 2-D column norms / 4-D kernel norms, 1e-7
                    guards)
  * schedule      — neuralnet.py:303-311: lr = INIT/(1 + epoch/HALF)

This file implements all of that in plain numpy (float64) with hand-written
backprop — no jax — and asserts the framework follows the same trajectory.
Any drift in a formula, a draw order, or the update timing fails the test.

Augmentation and dropout are off (their randomness is explicitly NOT
bit-matched across frameworks); every other moving part is on, with max-norm
values chosen so the projections actually bite from step one.
"""

import numpy as np
import jax.numpy as jnp

from theanet_tpu.model import NeuralNet

SEED = 777
BATCH = 8
IMG = 8
MAPS = 3
FILT = 3
N_HID = 16
N_OUT = 4
CONV_REG = {"L2": 1e-3, "momentum": 0.95, "rate": 1, "maxnorm": 0.9, "L1": 0}
HID_REG = {"L1": 1e-4, "momentum": 0.9, "rate": 1, "maxnorm": 0.7, "L2": 0}
SOFT_REG = {"momentum": 0.95, "rate": 0.5, "maxnorm": 0.8, "L1": 0, "L2": 0}
INIT_LR = 0.1
HALF = 2
STEPS_PER_EPOCH = 5
EPOCHS = 12   # 60-step horizon

CONV_ACT_SLOPE = 0.05  # relu05
HID_ACT_SLOPE = 0.10   # relu10


# --------------------- the oracle: pure numpy, float64 ----------------------


def oracle_init(seed):
    """weights.py:25-81 with the constructor draw order."""
    rng = np.random.RandomState(seed)
    # ConvLayer: 4-D -> random signs / sqrt(fan_in); relu05 starts with
    # 'relu0' so bias = 0.5 (weights.py:52-54,64-65)
    fan_in = 1 * FILT * FILT
    w1 = (2.0 * rng.randint(2, size=(MAPS, 1, FILT, FILT)) - 1) / np.sqrt(fan_in)
    w1 = w1.astype(np.float32)
    b1 = np.full((MAPS,), 0.5, np.float32)
    # HiddenLayer: U(-1,1) * sqrt(6/(fan_in+fan_out)) where the reference
    # passes fan_in = fan_out = n_in + n_out (hidden.py:21-27); relu10 does
    # NOT start with 'relu0' -> bias 0
    pool_out = (IMG - FILT + 1) // 2
    n_flat = MAPS * pool_out * pool_out
    s2 = np.sqrt(6.0 / (2 * (n_flat + N_HID)))
    w2 = (rng.uniform(-1, 1, (n_flat, N_HID)) * s2).astype(np.float32)
    b2 = np.zeros((N_HID,), np.float32)
    # SoftmaxLayer: same dense rule, actvn='Softmax' -> no bias bump
    s3 = np.sqrt(6.0 / (2 * (N_HID + N_OUT)))
    w3 = (rng.uniform(-1, 1, (N_HID, N_OUT)) * s3).astype(np.float32)
    b3 = np.zeros((N_OUT,), np.float32)
    return [
        [w1.astype(np.float64), b1.astype(np.float64)],
        [w2.astype(np.float64), b2.astype(np.float64)],
        [w3.astype(np.float64), b3.astype(np.float64)],
    ]


def _lrelu(z, slope):
    return np.maximum(0.0, z) + np.minimum(0.0, z) * slope


def _conv_valid_flipped(x, w):
    """True convolution, 'valid' mode: correlate with the flipped kernel."""
    b, c, h, _ = x.shape
    m = w.shape[0]
    f = w.shape[2]
    o = h - f + 1
    wf = w[:, :, ::-1, ::-1]
    out = np.zeros((b, m, o, o))
    for i in range(o):
        for j in range(o):
            patch = x[:, :, i:i + f, j:j + f]  # (b,c,f,f)
            out[:, :, i, j] = np.einsum("bcuv,mcuv->bm", patch, wf)
    return out


def _corr_xg(x, g, f):
    """d(conv)/d(flipped kernel): correlate input with the output cotangent."""
    b, c, h, _ = x.shape
    m = g.shape[1]
    o = g.shape[2]
    dwf = np.zeros((m, c, f, f))
    for u in range(f):
        for v in range(f):
            patch = x[:, :, u:u + o, v:v + o]
            dwf[:, :, u, v] = np.einsum("bcij,bmij->mc", patch, g)
    return dwf


def _maxpool(h, p):
    b, m, s, _ = h.shape
    o = s // p
    r = h.reshape(b, m, o, p, o, p)
    return r.max(axis=(3, 5)), r


def _maxpool_bwd(r, pooled, g):
    """Route gradient to the max element of each window (ties: measure zero
    with continuous random inputs)."""
    b, m, o, p, _, _ = r.shape
    mask = (r == pooled[:, :, :, None, :, None])
    return (mask * g[:, :, :, None, :, None]).reshape(b, m, o * p, o * p)


def oracle_step(params, moms, x, y, lr):
    """One full reference train step. Returns (params, moms, cost)."""
    (w1, b1), (w2, b2), (w3, b3) = params
    B = x.shape[0]

    # ---- forward
    z1 = _conv_valid_flipped(x, w1) + b1[None, :, None, None]
    h1 = _lrelu(z1, CONV_ACT_SLOPE)
    pooled, r = _maxpool(h1, 2)
    flat = pooled.reshape(B, -1)
    z2 = flat @ w2 + b2
    h2 = _lrelu(z2, HID_ACT_SLOPE)
    z3 = h2 @ w3 + b3
    zc = z3 - z3.max(axis=1, keepdims=True)
    ez = np.exp(zc)
    probs = ez / ez.sum(axis=1, keepdims=True)
    logp = zc - np.log(ez.sum(axis=1, keepdims=True))
    data_cost = -np.mean(logp[np.arange(B), y])
    wt_cost = (
        CONV_REG["L2"] * ((w1 ** 2).sum() + (b1 ** 2).sum())
        + HID_REG["L1"] * (np.abs(w2).sum() + np.abs(b2).sum())
    )
    cost = data_cost + wt_cost

    # ---- backward (hand-rolled)
    dz3 = (probs - np.eye(N_OUT)[y]) / B
    dw3 = h2.T @ dz3
    db3 = dz3.sum(axis=0)
    dh2 = dz3 @ w3.T
    dz2 = dh2 * np.where(z2 > 0, 1.0, HID_ACT_SLOPE)
    dw2 = flat.T @ dz2 + HID_REG["L1"] * np.sign(w2)
    db2 = dz2.sum(axis=0) + HID_REG["L1"] * np.sign(b2)
    dflat = dz2 @ w2.T
    dpool = dflat.reshape(pooled.shape)
    dh1 = _maxpool_bwd(r, pooled, dpool)
    dz1 = dh1 * np.where(z1 > 0, 1.0, CONV_ACT_SLOPE)
    db1 = dz1.sum(axis=(0, 2, 3)) + CONV_REG["L2"] * 2 * b1
    dw1 = _corr_xg(x, dz1, FILT)[:, :, ::-1, ::-1] + CONV_REG["L2"] * 2 * w1

    # ---- simultaneous update from OLD values (layer.py:82-103)
    grads = [[dw1, db1], [dw2, db2], [dw3, db3]]
    regs = [CONV_REG, HID_REG, SOFT_REG]
    new_params, new_moms = [], []
    for (lp, lm, lg, reg) in zip(params, moms, grads, regs):
        ps, ms = [], []
        for p, a, g in zip(lp, lm, lg):
            a_new = reg["momentum"] * a + (1 - reg["momentum"]) * g
            p_new = p - reg["rate"] * lr * a  # OLD accumulator
            mn = reg["maxnorm"]
            if mn:
                if p.ndim == 1:
                    p_new = np.clip(p_new, -mn, mn)
                elif p.ndim == 2:
                    norms = np.sqrt((p_new ** 2).sum(axis=0))
                    desired = np.clip(norms, 0, mn)
                    p_new = p_new * ((1e-7 + desired) / (1e-7 + norms))
                elif p.ndim == 4:
                    norms = np.sqrt((p_new ** 2).sum(axis=(1, 2, 3)))
                    desired = np.clip(norms, 0, mn)
                    p_new = p_new * ((1e-7 + desired) / (1e-7 + norms))[
                        :, None, None, None
                    ]
            ps.append(p_new)
            ms.append(a_new)
        new_params.append(ps)
        new_moms.append(ms)
    return new_params, new_moms, cost


# ------------------------------- the pin -------------------------------------


def _build_net():
    layers = [
        ["InputLayer", {"img_sz": IMG}],
        ["ConvLayer", {"num_maps": MAPS, "filter_sz": FILT, "stride": 1,
                       "mode": "valid", "actvn": "relu05", "reg": CONV_REG}],
        ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": N_HID, "pdrop": 0, "actvn": "relu10",
                         "reg": HID_REG}],
        ["SoftmaxLayer", {"n_out": N_OUT, "reg": SOFT_REG}],
    ]
    tr_prms = {"SEED": SEED, "BATCH_SZ": BATCH, "NUM_EPOCHS": EPOCHS,
               "EPOCHS_TO_TEST": 1, "TEST_SAMP_SZ": BATCH,
               "INIT_LEARNING_RATE": INIT_LR, "EPOCHS_TO_HALF_RATE": HALF}
    return NeuralNet(layers, tr_prms)


def _data():
    rng = np.random.RandomState(4242)
    xs = rng.rand(STEPS_PER_EPOCH, BATCH, 1, IMG, IMG).astype(np.float32)
    ys = rng.randint(0, N_OUT, (STEPS_PER_EPOCH, BATCH)).astype(np.int32)
    return xs, ys


def test_init_bit_exact_vs_oracle():
    net = _build_net()
    oracle = oracle_init(SEED)
    got = [w for lyr in net.allwts0 for w in lyr if len(lyr)]
    want = [w for lyr in oracle for w in lyr]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32))


def test_60_step_trajectory_matches_oracle():
    net = _build_net()
    params, moms = net.init_params()
    xs, ys = _data()

    # oracle state in f64; layer indices 1,3,4 hold the oracle's 3 param layers
    o_params = oracle_init(SEED)
    o_moms = [[np.zeros_like(p) for p in lp] for lp in o_params]

    step = 0
    for epoch in range(EPOCHS):
        lr = net.get_rate()
        assert abs(lr - INIT_LR / (1 + epoch / HALF)) < 1e-12
        for i in range(STEPS_PER_EPOCH):
            x, y = jnp.asarray(xs[i]), jnp.asarray(ys[i])
            params, moms, cost, _, _ = net.train_step(
                params, moms, x, y, key=net.base_key, lr=lr
            )
            o_params, o_moms, o_cost = oracle_step(
                o_params, o_moms, xs[i].astype(np.float64), ys[i], lr
            )
            step += 1
            # f32 framework vs f64 oracle: drift is rounding-only and grows
            # slowly (observed ~1e-6 at 20 steps, ~6e-6 at 60)
            assert abs(float(cost) - o_cost) < 5e-5 * max(1.0, abs(o_cost)), (
                f"cost diverged at step {step}: {float(cost)} vs {o_cost}"
            )
        net.inc_epoch_set_rate()

    got = [np.asarray(w, np.float64) for lyr in params for w in lyr if len(lyr)]
    want = [w for lyr in o_params for w in lyr]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0,
                                   err_msg="params diverged from the "
                                           "reference-arithmetic oracle")
    got_m = [np.asarray(a, np.float64) for lyr in moms for a in lyr if len(lyr)]
    want_m = [a for lyr in o_moms for a in lyr]
    for g, w in zip(got_m, want_m):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


# ------------------- conv + pool + RBF centered head -------------------------
#
# The head oracles
# (tests/test_head_oracles.py) pin every head's arithmetic on FLAT nets;
# this trajectory runs the full conv+pool stack INTO an RBF CenteredOut
# head with learned centers and a finite junk_dist (reference
# outlayers.py:153-224) for 40 steps, with momentum/maxnorm biting on
# every layer — so the conv backward, the head backward, and the update
# rule are pinned in composition, not just separately.

RBF_NF = 6
RBF_NC = 4
RBF_JUNK = 5.0
RBF_REG = {"L2": 5e-4, "momentum": 0.9, "rate": 1, "maxnorm": 0.8, "L1": 0}


def oracle_init_rbf(seed):
    """Draw order: conv sign-init, hidden dense draw, head dense draw
    (scaled_tanh: no x4, no bias bump), then centers ~ U(0,1)."""
    rng = np.random.RandomState(seed)
    fan_in = 1 * FILT * FILT
    w1 = (2.0 * rng.randint(2, size=(MAPS, 1, FILT, FILT)) - 1) / np.sqrt(fan_in)
    w1 = w1.astype(np.float32)
    b1 = np.full((MAPS,), 0.5, np.float32)
    pool_out = (IMG - FILT + 1) // 2
    n_flat = MAPS * pool_out * pool_out
    s2 = np.sqrt(6.0 / (2 * (n_flat + N_HID)))
    w2 = (rng.uniform(-1, 1, (n_flat, N_HID)) * s2).astype(np.float32)
    b2 = np.zeros((N_HID,), np.float32)
    s3 = np.sqrt(6.0 / (2 * (N_HID + RBF_NF)))
    w3 = (rng.uniform(-1, 1, (N_HID, RBF_NF)) * s3).astype(np.float32)
    b3 = np.zeros((RBF_NF,), np.float32)
    centers = rng.uniform(0, 1, (RBF_NC, RBF_NF)).astype(np.float32)
    return [
        [w1.astype(np.float64), b1.astype(np.float64)],
        [w2.astype(np.float64), b2.astype(np.float64)],
        [w3.astype(np.float64), b3.astype(np.float64),
         centers.astype(np.float64)],
    ]


def oracle_step_rbf(params, moms, x, y, lr):
    """Full conv->pool->hidden->RBF step (loss nll over softmax(-dists)
    with the junk column, centers trainable)."""
    (w1, b1), (w2, b2), (w3, b3, C) = params
    B = x.shape[0]

    z1 = _conv_valid_flipped(x, w1) + b1[None, :, None, None]
    h1 = _lrelu(z1, CONV_ACT_SLOPE)
    pooled, r = _maxpool(h1, 2)
    flat = pooled.reshape(B, -1)
    z2 = flat @ w2 + b2
    h2 = _lrelu(z2, HID_ACT_SLOPE)
    z3 = h2 @ w3 + b3
    t = np.tanh(z3 * (2.0 / 3.0))
    v = 1.7 * t                                     # scaled_tanh features
    d = ((v[:, None, :] - C[None, :, :]) ** 2).sum(axis=2)
    daug = np.concatenate([d, np.full((B, 1), RBF_JUNK)], axis=1)
    zc = -daug - (-daug).max(axis=1, keepdims=True)
    p = np.exp(zc) / np.exp(zc).sum(axis=1, keepdims=True)
    logp = zc - np.log(np.exp(zc).sum(axis=1, keepdims=True))
    data_cost = -np.mean(logp[np.arange(B), y])
    wt_cost = (
        CONV_REG["L2"] * ((w1 ** 2).sum() + (b1 ** 2).sum())
        + HID_REG["L1"] * (np.abs(w2).sum() + np.abs(b2).sum())
        + RBF_REG["L2"] * ((w3 ** 2).sum() + (b3 ** 2).sum()
                           + (C ** 2).sum())
    )
    cost = data_cost + wt_cost

    dd = (np.eye(RBF_NC + 1)[y][:, :RBF_NC] - p[:, :RBF_NC]) / B
    dv = 2.0 * (v * dd.sum(axis=1, keepdims=True) - dd @ C)
    dC = 2.0 * (C * dd.sum(axis=0)[:, None] - dd.T @ v) + RBF_REG["L2"] * 2 * C
    dz3 = dv * 1.7 * (2.0 / 3.0) * (1.0 - t * t)
    dw3 = h2.T @ dz3 + RBF_REG["L2"] * 2 * w3
    db3 = dz3.sum(axis=0) + RBF_REG["L2"] * 2 * b3
    dh2 = dz3 @ w3.T
    dz2 = dh2 * np.where(z2 > 0, 1.0, HID_ACT_SLOPE)
    dw2 = flat.T @ dz2 + HID_REG["L1"] * np.sign(w2)
    db2 = dz2.sum(axis=0) + HID_REG["L1"] * np.sign(b2)
    dflat = dz2 @ w2.T
    dpool = dflat.reshape(pooled.shape)
    dh1 = _maxpool_bwd(r, pooled, dpool)
    dz1 = dh1 * np.where(z1 > 0, 1.0, CONV_ACT_SLOPE)
    db1 = dz1.sum(axis=(0, 2, 3)) + CONV_REG["L2"] * 2 * b1
    dw1 = _corr_xg(x, dz1, FILT)[:, :, ::-1, ::-1] + CONV_REG["L2"] * 2 * w1

    grads = [[dw1, db1], [dw2, db2], [dw3, db3, dC]]
    regs = [CONV_REG, HID_REG, RBF_REG]
    new_params, new_moms = [], []
    for (lp, lm, lg, reg) in zip(params, moms, grads, regs):
        ps, ms = [], []
        for pw, a, g in zip(lp, lm, lg):
            a_new = reg["momentum"] * a + (1 - reg["momentum"]) * g
            p_new = pw - reg["rate"] * lr * a  # OLD accumulator
            mn = reg["maxnorm"]
            if mn:
                if pw.ndim == 1:
                    p_new = np.clip(p_new, -mn, mn)
                elif pw.ndim == 2:
                    norms = np.sqrt((p_new ** 2).sum(axis=0))
                    desired = np.clip(norms, 0, mn)
                    p_new = p_new * ((1e-7 + desired) / (1e-7 + norms))
                elif pw.ndim == 4:
                    norms = np.sqrt((p_new ** 2).sum(axis=(1, 2, 3)))
                    desired = np.clip(norms, 0, mn)
                    p_new = p_new * ((1e-7 + desired) / (1e-7 + norms))[
                        :, None, None, None
                    ]
            ps.append(p_new)
            ms.append(a_new)
        new_params.append(ps)
        new_moms.append(ms)
    return new_params, new_moms, cost


def test_40_step_conv_rbf_trajectory_matches_oracle():
    layers = [
        ["InputLayer", {"img_sz": IMG}],
        ["ConvLayer", {"num_maps": MAPS, "filter_sz": FILT, "stride": 1,
                       "mode": "valid", "actvn": "relu05", "reg": CONV_REG}],
        ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": N_HID, "pdrop": 0, "actvn": "relu10",
                         "reg": HID_REG}],
        ["CenteredOutLayer", {"n_features": RBF_NF, "n_classes": RBF_NC,
                              "kind": "RBF", "learn_centers": True,
                              "junk_dist": RBF_JUNK, "reg": RBF_REG}],
    ]
    tr_prms = {"SEED": SEED, "BATCH_SZ": BATCH, "NUM_EPOCHS": 8,
               "EPOCHS_TO_TEST": 1, "TEST_SAMP_SZ": BATCH,
               "INIT_LEARNING_RATE": INIT_LR, "EPOCHS_TO_HALF_RATE": HALF}
    net = NeuralNet(layers, tr_prms)
    params, moms = net.init_params()

    rng = np.random.RandomState(777)
    xs = rng.rand(STEPS_PER_EPOCH, BATCH, 1, IMG, IMG).astype(np.float32)
    ys = rng.randint(0, RBF_NC, (STEPS_PER_EPOCH, BATCH)).astype(np.int32)

    o_params = oracle_init_rbf(SEED)
    o_moms = [[np.zeros_like(p) for p in lp] for lp in o_params]

    step = 0
    for epoch in range(8):
        lr = net.get_rate()
        for i in range(STEPS_PER_EPOCH):
            params, moms, cost, _, _ = net.train_step(
                params, moms, jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                key=net.base_key, lr=lr
            )
            o_params, o_moms, o_cost = oracle_step_rbf(
                o_params, o_moms, xs[i].astype(np.float64), ys[i], lr
            )
            step += 1
            assert abs(float(cost) - o_cost) < 5e-5 * max(1.0, abs(o_cost)), (
                f"cost diverged at step {step}: {float(cost)} vs {o_cost}"
            )
        net.inc_epoch_set_rate()

    got = [np.asarray(w, np.float64) for lyr in params for w in lyr if len(lyr)]
    want = [w for lyr in o_params for w in lyr]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0,
                                   err_msg="conv+RBF params diverged from "
                                           "the reference-arithmetic oracle")
