"""Conv-stack geometries through the scanned Trainer against the plain
reference: depth, pool-less levels, conv modes and strides, mean pooling,
and the fixed fuzz geometries (filter and pool sizes, ignore_border,
partial windows). Tolerances and checks: tests/reference_cases.py."""

import pytest

from reference_cases import (Case, check_eval, check_grads, check_trajectory,
                             conv, first, hidden, ids, pool, softmax)

_L2 = {"L2": 1e-3, "maxnorm": 0.8}


def _stack(img, cfgs, nh=12, nc=4, ch=1, name=None, seed=None, **kw):
    """cfgs: (maps, filter, pool, ignore_border, actvn) per conv level."""
    layers = [first(img, ch)]
    for m, f, p, ib, act in cfgs:
        layers += [conv(m, f, act, reg=_L2), pool(p, ib)]
    layers += [hidden(nh, reg={"L1": 1e-4, "momentum": 0.9}),
               softmax(nc, reg={"maxnorm": 0.9})]
    return Case(name, layers, img, nc, ch=ch, seed=seed or 17 + img, **kw)


DEPTH = [
    _stack(14, [(3, 3, 2, False, "relu07")], name="depth-1"),
    _stack(20, [(2, 3, 2, False, "relu07"), (3, 3, 2, False, "relu15"),
                (4, 3, 2, False, "relu05")], name="depth-3"),
    _stack(26, [(2, 3, 2, False, "relu07"), (3, 3, 3, True, "relu15"),
                (4, 2, 2, False, "relu05")], name="depth-3-pool3-ib"),
    _stack(14, [(2, 3, 2, False, "relu07"), (4, 3, 2, False, "relu15"),
                (2, 2, 2, False, "relu05")], nh=10, ch=3, name="depth-3-rgb"),
]


def _poolless(name, img, stack):
    layers = [first(img)]
    for item in stack:
        layers.append(conv(item[1], item[2], reg={"L2": 1e-3})
                      if item[0] == "c" else pool(item[1]))
    layers += [hidden(12), softmax(3)]
    return Case(name, layers, img, 3, seed=7)


POOLLESS = [
    _poolless("conv-conv-pool", 14, [("c", 2, 3), ("c", 3, 3), ("p", 2)]),
    _poolless("conv-pool-conv", 14, [("c", 2, 3), ("p", 2), ("c", 3, 3)]),
    _poolless("conv-only", 10, [("c", 3, 3)]),
]


def _modes(name, img, cfgs):
    """cfgs: (maps, filter, stride, mode, pool or None) per conv level."""
    layers = [first(img)]
    for m, f, stride, mode, p in cfgs:
        layers.append(conv(m, f, stride=stride, mode=mode, reg=_L2))
        if p is not None:
            layers.append(pool(p))
    layers += [hidden(10, reg={"L1": 1e-4}), softmax(4, reg={})]
    return Case(name, layers, img, 4, seed=23)


MODES = [
    _modes("same-stack", 10, [(3, 3, 1, "same", 2), (4, 3, 1, "same", 2)]),
    _modes("stride2", 14, [(3, 3, 2, "valid", 2)]),
    _modes("stride2-nopool", 14, [(3, 3, 2, "valid", None),
                                  (4, 2, 1, "valid", 2)]),
    _modes("pool-gt-filter", 13, [(3, 3, 1, "valid", 5)]),
    _modes("same-then-stride", 12, [(2, 3, 1, "same", 2),
                                    (3, 3, 2, "valid", 2)]),
    # 'full' convs whose pool washes the reference's in+f+1 size booking
    # back onto the real in+f-1 tensor
    _modes("full-l0", 11, [(3, 3, 1, "full", 3)]),
    _modes("full-l1", 12, [(2, 3, 1, "valid", 2), (3, 2, 1, "full", 4)]),
    _modes("full-full", 13, [(2, 3, 1, "full", 6), (3, 3, 1, "full", 4)]),
]


def _mean(name, img, cfgs):
    layers = [first(img)]
    for m, f, p in cfgs:
        layers.append(conv(m, f, reg=_L2))
        if p:
            layers.append(pool(p))
    layers += [["MeanLayer", {}], hidden(10, reg={"L1": 1e-4}),
               softmax(4, reg={})]
    return Case(name, layers, img, 4, seed=29)


MEAN = [
    _mean("mean-after-conv", 12, [(2, 3, 2), (5, 3, None)]),
    _mean("mean-after-pool", 14, [(3, 3, 2), (4, 3, 2)]),
]


def _fuzz(batch, img, f1, f2, m1, m2, nh, nc):
    layers = [first(img),
              conv(m1, f1, reg={"L2": 1e-3, "maxnorm": 0.8}), pool(2),
              conv(m2, f2, "relu15"), pool(2),
              hidden(nh, reg={"L1": 1e-4, "momentum": 0.9}),
              softmax(nc, reg={"maxnorm": 0.9})]
    return Case(f"fuzz-b{batch}-i{img}-f{f1}{f2}-m{m1}{m2}", layers, img, nc,
                batch=batch, seed=img * 7 + f1)


FUZZ = [_fuzz(*c) for c in [
    (4, 12, 3, 3, 2, 3, 16, 4),   # c1=10,p1=5,c2=3(odd),p2=2 partial
    (6, 14, 5, 5, 1, 2, 8, 3),    # filt=5: c1=10,p1=5,c2=1,p2=1 degenerate
    (8, 16, 3, 3, 3, 4, 24, 5),   # c1=14,p1=7(odd),c2=5(odd),p2=3 partial
    (2, 9, 3, 3, 1, 1, 4, 2),     # tiny odd img: c1=7,p1=4,c2=2,p2=1
    (4, 14, 5, 3, 2, 3, 12, 4),   # 5x5 then 3x3: c1=10,p1=5,c2=3,p2=2
    (4, 13, 3, 4, 2, 2, 10, 3),   # 3x3 then 4x4: c1=11,p1=6,c2=3,p2=2
]]


def _fuzz_pool(img, f1, f2, p1, p2, ib1, ib2):
    layers = [first(img), conv(2, f1, reg={"L2": 1e-3}), pool(p1, ib1),
              conv(3, f2, "relu15"), pool(p2, ib2), hidden(12), softmax(4)]
    return Case(f"pool-i{img}-f{f1}{f2}-p{p1}{p2}-ib{int(ib1)}{int(ib2)}",
                layers, img, 4, seed=img * 3 + p1)


FUZZ_POOL = [_fuzz_pool(*c) for c in [
    (15, 3, 3, 3, 2, False, False),  # c1=13,p1=5(partial),c2=3,p2=2 partial
    (16, 4, 3, 3, 3, False, False),  # pool3 at both levels
    (14, 3, 3, 2, 2, True, True),    # ignore_border: c1=12,p1=6,c2=4,p2=2
    (20, 5, 3, 4, 2, True, False),   # pool4; ib drops the tail
    (16, 4, 3, 2, 2, True, False),   # ib1 non-dividing: c1=13 -> p1=6
    (16, 3, 3, 2, 2, True, True),    # ib2 non-dividing: c2=5 -> p2=2
    (16, 3, 3, 4, 2, False, False),  # pool wider than the filter
]]

CASES = DEPTH + POOLLESS + MODES + MEAN + FUZZ + FUZZ_POOL


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_trajectory_matches_reference(case):
    check_trajectory(case)


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_gradient_matches_reference(case):
    check_grads(case)


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_eval_matches_reference(case):
    check_eval(case)
