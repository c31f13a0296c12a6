"""Heads, losses and dense tails through the scanned Trainer against the
plain reference: every loss, the centred heads (LOGIT/RBF, frozen and
learned centres), the aux-input heads (SoftAux, AuxConcat), hidden stacks,
flat nets, and an identity input stage (inversion, colour, zero dropout).
Tolerances and checks: tests/reference_cases.py."""

import pytest

from reference_cases import (Case, check_eval, check_grads, check_trajectory,
                             conv, first, hidden, ids, pool, softmax)

_CONV = [conv(3, 3, reg={"L2": 1e-3, "maxnorm": 0.8}), pool(2)]


def _loss(name, head, img=14, nc=3):
    layers = [first(img)] + _CONV + [
        hidden(12, reg={"momentum": 0.9}), head]
    return Case(name, layers, img, nc, seed=43)


LOSSES = [
    # nll50: log-threshold -0.69 vs chance logp ~ -1.1 on 3 classes: the
    # clamp is on for some samples and off for others
    _loss("nll50", softmax(3, "nll50")),
    # nll05: log-threshold -3.0, fully clamped (cost 0, zero gradient)
    _loss("nll05", softmax(3, "nll05")),
    _loss("nllsq", softmax(3, "nllsq")),
    _loss("nll-unparsed", softmax(3, "nllxx")),
    _loss("hinge", ["HingeLayer", {"n_out": 3}]),
    _loss("hinge_max", softmax(3, "hinge_max")),
    _loss("exp", ["ExpLossLayer", {"n_out": 3}]),
]


def _centered(kind, learn, junk, n_conv, img=14, nc=5):
    layers = [first(img)]
    for m in [2, 3, 2][:n_conv]:
        layers += [conv(m, 3, reg={"L2": 1e-3}), pool(2)]
    head = {"n_features": 12, "n_classes": nc, "kind": kind,
            "learn_centers": learn, "reg": {"L2": 1e-3, "maxnorm": 0.9}}
    if junk is not None:
        head["junk_dist"] = junk
    layers += [hidden(10), ["CenteredOutLayer", head]]
    name = f"{kind.lower()}-{'learn' if learn else 'frozen'}-junk{junk}-" \
           f"conv{n_conv}"
    return Case(name, layers, img, nc, lr=0.1, seed=41 + img)


CENTERED = [
    _centered("LOGIT", False, None, 1),
    _centered("RBF", False, 50.0, 1),
    _centered("RBF", True, 50.0, 2),
    _centered("RBF", True, None, 1),
]


def _softaux(img=14, nc=5, boost=1):
    layers = [first(img), conv(4, 3, "relu10", reg={"L2": 1e-3}), pool(2),
              ["SoftAuxLayer", {"n_out": nc, "n_aux": (5, 9),
                                "aux_type": "LocationInfo", "boost": boost,
                                "reg": {"L2": 1e-3, "maxnorm": 0.9}}]]
    return Case(f"softaux-boost{boost}", layers, img, nc, lr=0.1, seed=2718,
                aux=True)


def _auxconcat(flat, pre, img=14, nc=5):
    layers = [first(img)]
    if not flat:
        layers += [conv(4, 3, "relu10", reg={"L2": 1e-3}), pool(2)]
    layers.append(["AuxConcatLayer", {"n_aux": (5, 9),
                                      "aux_type": "LocationInfo"}])
    if pre:
        layers.append(hidden(10, "relu05", reg={"L2": 1e-3}))
    layers += [hidden(12, reg={"L2": 1e-3}), softmax(nc, reg={"L2": 1e-3})]
    return Case(f"auxconcat-{'flat' if flat else 'conv'}"
                f"{'-pre' if pre else ''}", layers, img, nc, lr=0.1,
                seed=2718, aux=True)


AUX = [_softaux(), _softaux(boost=1.5), _auxconcat(False, False),
       _auxconcat(False, True), _auxconcat(True, False)]


def _hid_stack(name, hiddens, head, img=14, nc=3):
    layers = [first(img)] + _CONV + [
        hidden(n, act, reg={"momentum": 0.9, "L1": 1e-4})
        for n, act in hiddens] + [head]
    return Case(name, layers, img, nc, seed=11)


HID_STACK = [
    _hid_stack("2-hidden", [(16, "relu02"), (12, "relu05")], softmax(3)),
    _hid_stack("3-hidden-mixed-acts", [(16, "tanh"), (12, "relu05"),
                                       (10, "sigmoid")], softmax(3)),
    _hid_stack("2-hidden-rbf", [(16, "relu02"), (12, "relu05")],
               ["CenteredOutLayer", {"kind": "RBF", "n_features": 6,
                                     "n_classes": 3, "learn_centers": True,
                                     "junk_dist": 10.0}]),
]


def _flat(name, hiddens, head, img=12, nc=5, ch=1, kind="InputLayer"):
    layers = [first(img, ch, kind)] + [
        hidden(n, act, reg={"L1": 1e-4, "momentum": 0.9})
        for n, act in hiddens] + [head]
    return Case(name, layers, img, nc, ch=ch, lr=0.1, seed=7)


FLAT = [
    _flat("flat-2-hidden-softmax", [(24, "tanh"), (16, "relu05")],
          softmax(5)),
    _flat("flat-rbf-learn-centers", [(20, "relu05")],
          ["CenteredOutLayer", {"kind": "RBF", "n_features": 6,
                                "n_classes": 5, "learn_centers": True,
                                "junk_dist": 10.0}]),
    _flat("flat-hinge", [(20, "relu05")], ["HingeLayer", {"n_out": 5}]),
    _flat("flat-nllsq", [(20, "relu05")], softmax(5, "nllsq")),
    _flat("flat-rgb-inverted", [(20, "relu10")], softmax(5), ch=3,
          kind="ElasticLayer"),
]


def _input_stage(name, kind, img=12, ch=3, nc=4):
    """An identity colour or inversion stage and a zero-rate standalone
    dropout in a conv net (the galaxy_rbf.prms layer set)."""
    layers = [first(img, ch, kind)]
    layers += [conv(4, 3, "relu10"), pool(2), hidden(16),
               ["DropOutLayer", {"pdrop": 0}],
               ["CenteredOutLayer", {"n_features": 8, "n_classes": nc,
                                     "kind": "RBF", "learn_centers": True,
                                     "junk_dist": 50.0}]]
    return Case(name, layers, img, nc, ch=ch, lr=0.05, seed=99)


INPUT_STAGES = [
    _input_stage("color-identity", "ColorLayer"),
    _input_stage("elastic-invert", "ElasticLayer"),
]

CASES = LOSSES + CENTERED + AUX + HID_STACK + FLAT + INPUT_STAGES


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_trajectory_matches_reference(case):
    check_trajectory(case)


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_gradient_matches_reference(case):
    check_grads(case)


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_eval_matches_reference(case):
    check_eval(case)
