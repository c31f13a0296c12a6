"""Activations and random geometries through the scanned Trainer against
the plain reference: the smooth activations of the registry in two-conv,
one-conv and flat nets, randomly assembled conv stacks, and the flagship's
layer pattern at a small size. Tolerances and checks:
tests/reference_cases.py."""

import numpy as np
import pytest

from reference_cases import (Case, check_eval, check_grads, check_trajectory,
                             conv, first, hidden, ids, pool, softmax)

SMOOTH = ["tanh", "scaled_tanh", "sigmoid", "softplus"]


def _two_conv(act, img=12, nc=4):
    layers = [first(img), conv(2, 3, act, reg={"L2": 1e-3, "maxnorm": 0.9}),
              pool(2), conv(3, 3, "relu10"), pool(2),
              hidden(16, act, reg={"L1": 1e-4, "momentum": 0.9}), softmax(nc)]
    return Case(f"two-conv-{act}", layers, img, nc, lr=0.1, seed=31)


def _one_conv(act, img=14, nc=3):
    layers = [first(img), conv(3, 3, act, reg={"L2": 1e-3, "maxnorm": 0.8}),
              pool(2), hidden(12, act, reg={"momentum": 0.9}), softmax(nc)]
    return Case(f"one-conv-{act}", layers, img, nc, seed=43)


def _flat(act, img=12, nc=5):
    layers = [first(img),
              hidden(24, act, reg={"L2": 1e-3, "L1": 1e-4, "maxnorm": 0.8}),
              softmax(nc)]
    return Case(f"flat-{act}", layers, img, nc, lr=0.2, seed=23)


ACTS = ([_two_conv(a) for a in SMOOTH] + [_one_conv(a) for a in SMOOTH]
        + [_flat(a) for a in SMOOTH])


def _random_geometry(seed):
    """A randomly assembled 1- or 3-level conv stack (filter 2-5, pool 2-3
    no wider than the filter, either border mode, leaky relus)."""
    rng = np.random.RandomState(100 + seed)
    n = int(rng.choice([1, 3]))
    img = int(rng.choice([14, 18, 22, 26]))
    layers, sz = [first(img)], img
    for _ in range(n):
        f = min(int(rng.choice([2, 3, 4, 5])), max(2, sz - 2))
        p = min(int(rng.choice([2, 3])), f)
        ib = bool(rng.randint(2))
        m = int(rng.choice([1, 2, 3, 4]))
        act = "relu%02d" % rng.randint(0, 30)
        layers += [conv(m, f, act, reg={"L2": 1e-3, "maxnorm": 0.8}),
                   pool(p, ib)]
        c = sz - f + 1
        sz = c // p if ib else -(-c // p)
        if sz < 4:
            break
    batch = int(rng.choice([2, 4, 5]))
    nc = int(rng.choice([3, 5]))
    layers += [hidden(int(rng.choice([6, 12])),
                      reg={"L1": 1e-4, "momentum": 0.9}),
               softmax(nc, reg={"maxnorm": 0.9})]
    return Case(f"random-geometry-{seed}", layers, img, nc, batch=batch,
                lr=0.1, seed=17 + img)


GEOMETRY = [_random_geometry(s) for s in range(6)]

FLAGSHIP = [Case(
    "flagship-pattern-14px",
    [first(14, kind="ElasticLayer"), conv(4, 3, "relu10"), pool(2),
     conv(20, 3, "relu05"), pool(2),
     hidden(50, "relu01", reg={"L2": 0.0, "maxnorm": 0}),
     softmax(10, reg={"L2": 0.0, "maxnorm": 0})],
    14, 10, batch=5, lr=0.1, seed=555)]

CASES = ACTS + GEOMETRY + FLAGSHIP


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_trajectory_matches_reference(case):
    check_trajectory(case)


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_gradient_matches_reference(case):
    check_grads(case)


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_eval_matches_reference(case):
    check_eval(case)
