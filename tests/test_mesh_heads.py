"""GSPMD data-parallel meshes against one device, per head and input stage:
the sharded scanned Trainer must track single-device training step by step
(augmentation and dropout on — one backend, one base_key, identical draws).

Tolerance: GSPMD only reorders the batch-dim reductions (n_data partial
sums), a few-ulp float32 effect; a missing or doubled gradient all-reduce
is an O(1) or O(n_data) error (tests/test_sharding.py gives the argument)."""

import numpy as np
import jax
import pytest

from theanet_tpu.model import NeuralNet
from theanet_tpu.parallel.mesh import make_mesh
from theanet_tpu.trainer import Trainer

HEADS = ["softmax", "softmax-color", "rbf", "softaux", "auxcat", "flat"]


def _layers(head):
    """One conv level (or none for 'flat') under a full elastic stage, with
    dropout in the dense tail and the given head."""
    layers = []
    if head == "softmax-color":
        layers.append(["ColorLayer", {"img_sz": 12, "num_maps": 1,
                                      "balance": 0.5, "gamma": 2.0,
                                      "maxval": 1.5}])
    layers.append(["ElasticLayer", {"img_sz": 12, "translation": 1,
                                    "zoom": 1.05, "magnitude": 5, "sigma": 3,
                                    "pflip": 0.02, "angle": 2}])
    if head != "flat":
        layers += [["ConvLayer", {"num_maps": 4, "filter_sz": 3, "stride": 1,
                                  "actvn": "relu10", "reg": {"L2": 0.001}}],
                   ["PoolLayer", {"pool_sz": 2}]]
    if head == "softaux":
        return layers + [["SoftAuxLayer", {
            "n_out": 10, "n_aux": (5, 9), "aux_type": "LocationInfo",
            "boost": 1.5, "reg": {"L2": 1e-3}}]]
    if head == "auxcat":
        layers.append(["AuxConcatLayer", {"n_aux": (5, 9),
                                          "aux_type": "LocationInfo",
                                          "boost": 1.5}])
    layers.append(["HiddenLayer", {"n_out": 32, "pdrop": 0.4,
                                   "reg": {"maxnorm": 2}}])
    if head == "rbf":
        return layers + [["CenteredOutLayer", {
            "n_features": 12, "n_classes": 10, "kind": "RBF",
            "learn_centers": True, "junk_dist": 50.0, "reg": {"L2": 1e-3}}]]
    return layers + [["SoftmaxLayer", {"n_out": 10}]]


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("n_data", [2, 4, 8])
@pytest.mark.parametrize("head", HEADS)
def test_data_parallel_mesh_matches_one_device(head, n_data):
    batch = 16
    rng = np.random.RandomState(0)
    x = rng.rand(3 * batch, 1, 12, 12).astype(np.float32)
    y = rng.randint(0, 10, 3 * batch).astype(np.int32)
    kw = {}
    if head in ("softaux", "auxcat"):
        aux = np.random.RandomState(7).rand(3 * batch, 2, 2).astype(
            np.float32)
        kw = dict(train_aux=aux, test_aux=aux)

    def trainer(mesh):
        tp = {"SEED": 11, "BATCH_SZ": batch, "NUM_EPOCHS": 1,
              "EPOCHS_TO_TEST": 1, "TEST_SAMP_SZ": batch,
              "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 1}
        return Trainer(NeuralNet(_layers(head), tp), x, y, x, y, mesh=mesh,
                       **kw)

    tr1 = trainer(None)
    tr2 = trainer(make_mesh(n_data=n_data, n_model=1))
    for _ in range(2):
        _, c1, _ = tr1.run_epoch()
        _, c2, _ = tr2.run_epoch()
        rel = np.abs(c1 - c2) / np.maximum(np.abs(c1), 1.0)
        assert rel.max() < 1e-4, (c1, c2)
        tr1.net.inc_epoch_set_rate()
        tr2.net.inc_epoch_set_rate()
    for lp1, lp2 in zip(tr1.params, tr2.params):
        for w1, w2 in zip(lp1, lp2):
            np.testing.assert_allclose(np.asarray(w1), np.asarray(w2),
                                       atol=1e-4)
    e1, e2 = tr1.evaluate_full("test"), tr2.evaluate_full("test")
    assert abs(e1[0] - e2[0]) < 1e-3 and abs(e1[1] - e2[1]) < 1e-3
