"""Configurations and checks shared by the scanned-Trainer-vs-plain-reference
tests (tests/test_reference_*.py).

Each case is a small network in the library's spec format. Three checks run
on every case, all against tests/plain_reference.py (float64, gradients by
``jax.grad`` of its own forward pass):

  * ``check_trajectory`` — 5 steps of the scanned Trainer epoch: every
    step's cost and the end-state weights;
  * ``check_grads`` — cost and gradient of the training cost at init;
  * ``check_eval`` — the eval window's error rate and second statistic.

Augmentation and dropout are off (their randomness has no reference) and an
aux tensor's two rows are equal (LocationInfo's random mix is then a no-op).

Tolerances: the library runs float32, the reference float64. Rounding moves
a cost or a weight by ~1e-7 relative per step (measured ~1e-7 over 20 steps
of the flagship), so 2e-5 relative over 5 steps leaves two orders of
headroom, while a wrong formula, tie rule or update timing moves them by
1e-3 or more.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

import plain_reference
from theanet_tpu.model import NeuralNet
from theanet_tpu.trainer import Trainer

STEPS = 5
RTOL = 2e-5


class Case(NamedTuple):
    name: str
    layers: list
    img: int
    nc: int
    batch: int = 4
    ch: int = 1
    lr: float = 0.15
    seed: int = 17
    aux: bool = False

    def net(self):
        tp = {"SEED": self.seed, "BATCH_SZ": self.batch, "NUM_EPOCHS": 1,
              "EPOCHS_TO_TEST": 1, "TEST_SAMP_SZ": self.batch,
              "INIT_LEARNING_RATE": self.lr, "EPOCHS_TO_HALF_RATE": 2}
        return NeuralNet(copy.deepcopy(self.layers), tp)

    def data(self, n, seed=0):
        rng = np.random.RandomState(seed)
        x = rng.rand(n, self.ch, self.img, self.img).astype(np.float32)
        y = rng.randint(0, self.nc, n).astype(np.int32)
        aux = None
        if self.aux:
            row = rng.rand(n, 1, 2).astype(np.float32)
            aux = np.tile(row, (1, 2, 1))
        return x, y, aux


def first(img, ch=1, kind="InputLayer"):
    kw = {"img_sz": img}
    if ch != 1:
        kw["num_maps"] = ch
    if kind == "ElasticLayer":
        kw["invert_image"] = True
    if kind == "ColorLayer":
        kw.update(balance=1, gamma=1, maxval=1)
    return [kind, kw]


def conv(m, f, act="relu07", stride=1, mode="valid", reg=None):
    kw = {"num_maps": m, "filter_sz": f, "stride": stride, "mode": mode,
          "actvn": act}
    if reg is not None:
        kw["reg"] = reg
    return ["ConvLayer", kw]


def pool(p, ib=False):
    return ["PoolLayer", {"pool_sz": p, "ignore_border": ib}]


def hidden(n, act="relu02", reg=None):
    kw = {"n_out": n, "pdrop": 0, "actvn": act}
    if reg is not None:
        kw["reg"] = reg
    return ["HiddenLayer", kw]


def softmax(nc, loss=None, reg=None):
    kw = {"n_out": nc}
    if loss:
        kw["loss"] = loss
    if reg is not None:
        kw["reg"] = reg
    return ["SoftmaxLayer", kw]


def _close(got, want, what, floor=1.0):
    """max |got - want| <= RTOL * max(floor, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(floor, float(np.max(np.abs(want))) if want.size else floor)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= RTOL * scale, f"{what}: max gap {err:.3e} (scale {scale:.3g})"


def check_trajectory(case: Case):
    net = case.net()
    x, y, aux = case.data(STEPS * case.batch)
    kw = {}
    if aux is not None:
        kw = dict(train_aux=aux, test_aux=aux[:case.batch])
    tr = Trainer(net, x, y, x[:case.batch], y[:case.batch], **kw)
    lr = net.get_rate()
    total, costs, _ = tr.run_epoch()
    split = lambda a: None if a is None else a.reshape(  # noqa: E731
        (STEPS, case.batch) + a.shape[1:])
    ref_costs, ref_params, _ = plain_reference.train(
        case.layers, net.allwts0, split(x), split(y), lr, split(aux))
    assert np.isfinite(total)
    for i, (c, r) in enumerate(zip(costs, ref_costs)):
        _close(c, r, f"{case.name}: cost at step {i}")
    for i, (lp, rp) in enumerate(zip(tr.params, ref_params)):
        assert len(lp) == len(rp), (case.name, i)
        for j, (w, r) in enumerate(zip(lp, rp)):
            _close(w, r, f"{case.name}: layer {i} tensor {j} after "
                         f"{STEPS} steps")


def check_grads(case: Case):
    net = case.net()
    x, y, aux = case.data(case.batch, seed=1)
    params, _ = net.init_params()
    aux_d = None if aux is None else jnp.asarray(aux)
    c, g = jax.jit(jax.value_and_grad(
        lambda p: net.cost(p, jnp.asarray(x), jnp.asarray(y),
                           key=net.base_key, aux=aux_d)[0]))(params)
    rc, rg = plain_reference.grads(case.layers, net.allwts0, x, y, aux)
    _close(c, rc, f"{case.name}: cost at init")
    flags = plain_reference.trainable(case.layers, rg)
    for i, (lg, lr, lf) in enumerate(zip(g, rg, flags)):
        for j, (a, b, on) in enumerate(zip(lg, lr, lf)):
            if on:  # frozen tensors (e.g. fixed centres) take no step
                # gradients are judged against their own scale
                _close(a, b, f"{case.name}: gradient of layer {i} "
                             f"tensor {j}", floor=1e-4)


def check_eval(case: Case):
    net = case.net()
    x, y, aux = case.data(2 * case.batch, seed=2)
    kw = {}
    if aux is not None:
        kw = dict(train_aux=aux, test_aux=aux)
    tr = Trainer(net, x, y, x, y, **kw)
    err, second = tr.evaluate("test", [0, 1])
    rerr, rsecond = plain_reference.eval_stats(case.layers, net.allwts0, x,
                                               y, aux)
    # error rates move in steps of 100/n %; float32 rounding is ~1e-5 %
    assert abs(err - 100 * rerr) < 1e-3, (case.name, err, rerr)
    assert abs(second - 100 * rsecond) < 1e-3, (case.name, second, rsecond)


def ids(cases):
    return [c.name for c in cases]
