"""Mixed-precision (COMPUTE_DTYPE='bfloat16') training: bf16 body, f32
master weights / head math / gradient accumulation."""

import numpy as np
import jax
import jax.numpy as jnp

from theanet_tpu.data import synth
from theanet_tpu.model import NeuralNet
from theanet_tpu.trainer import Trainer


def spec():
    return [
        ["ElasticLayer", {"img_sz": 28, "translation": 1, "zoom": 1.05,
                          "magnitude": 8, "sigma": 4, "pflip": 0.01, "angle": 3}],
        ["ConvLayer", {"num_maps": 4, "filter_sz": 3, "stride": 1, "actvn": "relu10"}],
        ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 64, "pdrop": 0.5}],
        ["SoftmaxLayer", {"n_out": 10}],
    ]


def prms(**kw):
    d = {"SEED": 7, "BATCH_SZ": 20, "NUM_EPOCHS": 1, "EPOCHS_TO_TEST": 1,
         "TEST_SAMP_SZ": 200, "INIT_LEARNING_RATE": 0.1,
         "EPOCHS_TO_HALF_RATE": 1}
    d.update(kw)
    return d


def test_bf16_keeps_f32_masters_and_learns():
    net = NeuralNet(spec(), prms(COMPUTE_DTYPE="bfloat16"))
    tr = Trainer(net, synth.training_x[:2000], synth.training_y[:2000],
                 synth.testing_x[:400], synth.testing_y[:400])
    # master params stay f32
    assert all(p.dtype == jnp.float32 for lp in tr.params for p in lp)
    errs = []
    for _ in range(4):
        tr.run_epoch()
        errs.append(tr.evaluate_full("test")[0])
        net.inc_epoch_set_rate()
    assert errs[-1] < 15.0, errs
    # params still f32 after updates, momentum too
    assert all(p.dtype == jnp.float32 for lp in tr.params for p in lp)
    assert all(m.dtype == jnp.float32 for lm in tr.moms for m in lm)


def test_bf16_forward_produces_f32_head():
    net = NeuralNet(spec(), prms(COMPUTE_DTYPE="bfloat16"))
    params, _ = net.init_params()
    x = jnp.asarray(np.random.RandomState(0).rand(4, 1, 28, 28), jnp.float32)
    hs = net.forward(params, x, key=jax.random.PRNGKey(0), train=True)
    assert hs["probs"].dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(hs["probs"]).sum(axis=1), 1.0, rtol=1e-3)


def test_bf16_close_to_f32_on_first_steps():
    nets = {}
    for name, cd in [("f32", None), ("bf16", "bfloat16")]:
        p = prms()
        if cd:
            p["COMPUTE_DTYPE"] = cd
        net = NeuralNet(spec(), p)
        tr = Trainer(net, synth.training_x[:400], synth.training_y[:400],
                     synth.testing_x[:200], synth.testing_y[:200])
        c, _, _ = tr.run_epoch()
        nets[name] = c
    # same seed, same data: initial-epoch cost within a few percent
    assert abs(nets["f32"] - nets["bf16"]) / nets["f32"] < 0.05, nets


def test_predict_runs_same_body_as_eval_under_bf16():
    """Deployment inference must use the same bf16 network body as eval, so
    checkpointed error figures are reproducible via predict()."""
    net = NeuralNet(spec(), prms(COMPUTE_DTYPE="bfloat16"))
    tr = Trainer(net, synth.training_x[:400], synth.training_y[:400],
                 synth.testing_x[:200], synth.testing_y[:200])
    x = synth.testing_x[:200]
    y = synth.testing_y[:200]
    _, preds = tr.predict(x)
    err_pred = (preds != y).mean() * 100
    err_eval, _ = tr.evaluate_full("test")
    np.testing.assert_allclose(err_pred, err_eval, atol=1e-6)


def test_bf16_through_all_resample_methods():
    """bf16 network inputs must work through the gather and matmul
    resample paths (resample math itself runs f32)."""
    from theanet_tpu.ops.elastic import ElasticConfig, elastic_augment

    cfg = ElasticConfig(img_sz=16, translation=2, zoom=1.1, magnitude=10,
                        sigma=3, pflip=0.02, angle=5)
    x = jnp.asarray(np.random.RandomState(0).rand(4, 1, 16, 16),
                    jnp.bfloat16)
    outs = {}
    for m in ("gather", "matmul"):
        out, _ = elastic_augment(jax.random.PRNGKey(0), x, cfg, train=True,
                                 method=m)
        outs[m] = np.asarray(out, np.float32)
        assert np.isfinite(outs[m]).all(), m
    np.testing.assert_allclose(outs["gather"], outs["matmul"], atol=2e-2)


def test_bf16_cnn_with_all_aug_under_mesh_builds():
    """bf16 + elastic + conv trains (the combination that would hit
    mixed-dtype dot errors without the f32 resample cast)."""
    net = NeuralNet(spec(), prms(COMPUTE_DTYPE="bfloat16"))
    tr = Trainer(net, synth.training_x[:200], synth.training_y[:200],
                 synth.testing_x[:100], synth.testing_y[:100])
    total, _, _ = tr.run_epoch()
    assert np.isfinite(total)
