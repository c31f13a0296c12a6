"""Trainer API parity tests: index-list training, momentum reset, inference
on raw arrays, hinge_max loss."""

import numpy as np
import jax
import jax.numpy as jnp

from theanet_tpu.layers import SoftmaxLayer
from theanet_tpu.model import NeuralNet
from theanet_tpu.trainer import Trainer


def mk_trainer(batch=8, n=64):
    spec = [
        ["InputLayer", {"img_sz": 10}],
        ["HiddenLayer", {"n_out": 16}],
        ["SoftmaxLayer", {"n_out": 4}],
    ]
    prms = {"SEED": 5, "BATCH_SZ": batch, "NUM_EPOCHS": 1, "EPOCHS_TO_TEST": 1,
            "TEST_SAMP_SZ": batch, "INIT_LEARNING_RATE": 0.1,
            "EPOCHS_TO_HALF_RATE": 1}
    rng = np.random.RandomState(0)
    x = rng.rand(n, 1, 10, 10).astype(np.float32)
    y = rng.randint(0, 4, n).astype(np.int32)
    net = NeuralNet(spec, prms)
    return net, Trainer(net, x, y, x, y), x, y


def test_index_list_training_matches_contiguous():
    _, tr1, _, _ = mk_trainer()
    _, tr2, _, _ = mk_trainer()
    c1, f1, _ = tr1.run_batch(0, step=0)
    c2, f2, _ = tr2.run_batch_indices(np.arange(8), step=0)
    np.testing.assert_allclose(c1, c2, rtol=1e-5)
    np.testing.assert_allclose(f1, f2, rtol=1e-5)


def test_index_list_training_arbitrary_ids_runs():
    _, tr, _, _ = mk_trainer()
    idx = np.array([3, 3, 60, 0, 17, 8, 9, 1])
    cost, _, _ = tr.run_batch_indices(idx, step=0)
    assert np.isfinite(cost)


def test_reset_momentum():
    _, tr, _, _ = mk_trainer()
    tr.run_batch(0, step=0)
    tr.run_batch(1, step=1)
    assert any(float(jnp.abs(m).max()) > 0 for lm in tr.moms for m in lm)
    tr.reset_momentum()
    assert all(float(jnp.abs(m).max()) == 0 for lm in tr.moms for m in lm)


def test_predict_on_raw_arrays_with_layer_outputs():
    _, tr, x, _ = mk_trainer()
    feats, preds, h1 = tr.predict(x[:8], get_output_of_layers=(1,))
    assert feats.shape == (8, 4)
    assert preds.shape == (8,)
    assert h1.shape == (8, 16)  # hidden activations exposed
    assert set(preds.tolist()) <= {0, 1, 2, 3}


def test_hinge_max_loss():
    rng = np.random.RandomState(1)
    lyr = SoftmaxLayer(None, rng, n_in=6, n_out=4, loss="hinge_max")
    x = rng.rand(5, 6).astype(np.float32)
    w = [jnp.asarray(p) for p in lyr.params_init]
    hs = lyr.apply_head(w, jnp.asarray(x), key=jax.random.PRNGKey(0), train=True)
    y = np.array([0, 1, 2, 3, 0], np.int32)
    out = np.asarray(hs["output"])
    manual = np.mean([
        max(0.0, 1.0 + max(np.delete(out[i], y[i])) - out[i, y[i]])
        for i in range(5)
    ])
    np.testing.assert_allclose(
        float(lyr.cost(hs, jnp.asarray(y))), manual, rtol=1e-5
    )


def test_predict_different_layer_indices_per_call():
    """Regression: predict must honor get_output_of_layers per call, not
    reuse the first call's compiled closure."""
    _, tr, x, _ = mk_trainer()
    _, _, h1 = tr.predict(x[:8], get_output_of_layers=(1,))
    _, _, h2 = tr.predict(x[:8], get_output_of_layers=(2,))
    assert h1.shape == (8, 16)
    assert h2.shape == (8, 4)


def test_shuffle_option_trains_and_differs_from_sequential():
    """SHUFFLE=True draws a fresh on-device permutation per epoch; default
    remains the reference's fixed sequential batches."""
    import jax.numpy as jnp
    from theanet_tpu.data import synth
    from theanet_tpu.model import NeuralNet
    from theanet_tpu.trainer import Trainer

    spec = [
        ["InputLayer", {"img_sz": 28}],
        ["HiddenLayer", {"n_out": 32}],
        ["SoftmaxLayer", {"n_out": 10}],
    ]
    def mk(shuffle):
        prms = {"SEED": 2, "BATCH_SZ": 20, "NUM_EPOCHS": 1, "EPOCHS_TO_TEST": 1,
                "TEST_SAMP_SZ": 100, "INIT_LEARNING_RATE": 0.1,
                "EPOCHS_TO_HALF_RATE": 1}
        if shuffle:
            prms["SHUFFLE"] = True
        net = NeuralNet([list(l) for l in spec], prms)
        return net, Trainer(net, synth.training_x[:400], synth.training_y[:400],
                            synth.testing_x[:100], synth.testing_y[:100])

    _, tr_seq = mk(False)
    _, tr_shuf = mk(True)
    t1, c1, _ = tr_seq.run_epoch()
    t2, c2, _ = tr_shuf.run_epoch()
    assert np.isfinite(t1) and np.isfinite(t2)
    assert not np.allclose(c1, c2)  # different batch composition
    # shuffled epochs themselves differ epoch-to-epoch
    net, tr = mk(True)
    _, ca, _ = tr.run_epoch()
    net.inc_epoch_set_rate()
    _, cb, _ = tr.run_epoch()
    assert not np.allclose(ca, cb)


def test_evaluate_preds_feats():
    """evaluate(preds_feats=True) appends the head's (features, y_preds)
    over the window — reference get_test_model(preds_feats=True)
    (neuralnet.py:272-273) — and they agree with predict() on the same
    samples."""
    _, tr, x, y = mk_trainer()
    err, second, feats, preds = tr.evaluate("test", [0, 2], preds_feats=True)
    # the stats are unchanged by the extra outputs
    err0, second0 = tr.evaluate("test", [0, 2])
    np.testing.assert_allclose((err, second), (err0, second0), rtol=1e-6)
    assert feats.shape == (16, 4) and preds.shape == (16,)
    # same window through the serving path: identical features/predictions
    idx = np.concatenate([np.arange(0, 8), np.arange(16, 24)])
    pf, pp = tr.predict(x[idx])
    np.testing.assert_allclose(feats, pf, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(preds, pp)


def test_snapshot_restore_replays_identically():
    """snapshot_state/restore_state rewind the trainer (state tensors +
    epoch counter) so re-running reproduces the exact trajectory — the
    machinery the CLI's chained-NaN replay diagnostics rely on."""
    net, tr, _, _ = mk_trainer()
    tr.run_epoch()
    net.inc_epoch_set_rate()
    snap = tr.snapshot_state()
    outs1 = []
    for _ in range(2):
        _, costs, _ = tr.run_epoch()
        net.inc_epoch_set_rate()
        outs1.append(costs)
    tr.restore_state(snap)
    assert net.get_epoch() == snap[1]
    outs2 = []
    for _ in range(2):
        _, costs, _ = tr.run_epoch()
        net.inc_epoch_set_rate()
        outs2.append(costs)
    for c1, c2 in zip(outs1, outs2):
        np.testing.assert_array_equal(c1, c2)
    # the snapshot survives a restore (defensive copies), so a second
    # rewind still works
    tr.restore_state(snap)
    _, costs3, _ = tr.run_epoch()
    np.testing.assert_array_equal(outs1[0], costs3)


def test_snapshot_restore_rewinds_stream_step():
    """The streamed-batch RNG derives from a trainer-level step counter;
    restore_state must rewind it with the state tensors, or a post-restore
    re-run of the same pipeline silently trains a different trajectory."""
    net, tr, x, y = mk_trainer()
    batches = [(x[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8])
               for i in range(4)]
    snap = tr.snapshot_state()
    _, costs1 = tr.run_epoch_streamed(batches)
    assert tr._stream_step == 4
    tr.restore_state(snap)
    assert tr._stream_step == 0
    _, costs2 = tr.run_epoch_streamed(batches)
    np.testing.assert_array_equal(costs1, costs2)


def test_empty_eval_window_is_named_error():
    """TEST_SAMP_SZ < BATCH_SZ gives zero whole batches per rotating eval
    window; the reference's test_wrapper divides by zero there. Fail with
    an error that names the cause instead of a bare concatenate crash."""
    import pytest

    _, tr, _, _ = mk_trainer()
    with pytest.raises(ValueError, match="TEST_SAMP_SZ"):
        tr.evaluate("test", [])


def test_sync_net_reflects_trained_weights():
    """net.get_wts_info()/get_wts() read layer params_init, which only
    sync_net (or checkpointing) refreshes — the watchdog diagnostics in the
    CLI depend on this."""
    net, tr, _, _ = mk_trainer()
    before = [np.copy(w) for w in net.net_layers[1].get_wts()]
    tr.run_epoch()
    # stale until synced
    np.testing.assert_array_equal(net.net_layers[1].get_wts()[0], before[0])
    tr.sync_net()
    after = net.net_layers[1].get_wts()
    assert np.abs(after[0] - before[0]).max() > 0
    np.testing.assert_allclose(after[0], np.asarray(tr.params[1][0]),
                               rtol=1e-6)
