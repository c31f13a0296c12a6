"""Fail-fast validation: mesh/batch divisibility named errors, the streamed
double-augmentation guard, and the reference's compile-time notices
(serving batch-size warning, nllNN threshold print)."""

import numpy as np
import pytest

import jax

from theanet_tpu.model import NeuralNet
from theanet_tpu.parallel.mesh import make_mesh
from theanet_tpu.trainer import Trainer


def _net(batch_sz=8, hidden=16, elastic=False, loss="nll"):
    first = (
        ["ElasticLayer", {"img_sz": 6, "translation": 1, "zoom": 1,
                          "magnitude": 0, "sigma": 1, "pflip": 0, "angle": 0}]
        if elastic else ["InputLayer", {"img_sz": 6}]
    )
    layers = [
        first,
        ["HiddenLayer", {"n_out": hidden, "pdrop": 0}],
        ["SoftmaxLayer", {"n_out": 4, "loss": loss}],
    ]
    tr_prms = {"SEED": 5, "BATCH_SZ": batch_sz, "NUM_EPOCHS": 1,
               "EPOCHS_TO_TEST": 1, "TEST_SAMP_SZ": batch_sz,
               "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 1}
    return NeuralNet(layers, tr_prms)


def _data(n=32):
    rng = np.random.RandomState(0)
    return (rng.rand(n, 1, 6, 6).astype(np.float32),
            rng.randint(0, 4, n).astype(np.int32))


def test_make_mesh_too_many_devices_is_named_error():
    with pytest.raises(ValueError, match="exceeds the"):
        make_mesh(n_data=len(jax.devices()) + 1, n_model=2)


def test_make_mesh_bad_axis_is_named_error():
    with pytest.raises(ValueError, match="must be positive"):
        make_mesh(n_data=0, n_model=1)


def test_nondividing_batch_fails_fast():
    mesh = make_mesh(n_data=4, n_model=2)
    x, y = _data()
    with pytest.raises(ValueError, match="BATCH_SZ=6 does not divide"):
        Trainer(_net(batch_sz=6), x, y, x, y, mesh=mesh)


def test_odd_batch_on_odd_mesh_trains():
    # odd sizes that DO divide must still work: batch 9 on a 3-way data axis
    mesh = make_mesh(n_data=3, n_model=1)
    x, y = _data(27)
    tr = Trainer(_net(batch_sz=9, hidden=10), x, y, x, y, mesh=mesh)
    total, _, _ = tr.run_epoch()
    assert np.isfinite(total)
    err, _ = tr.evaluate_full("test")
    assert 0.0 <= err <= 100.0


def test_nonshardable_hidden_warns_but_trains():
    mesh = make_mesh(n_data=2, n_model=4)
    x, y = _data()
    with pytest.warns(UserWarning, match="model' axis"):
        tr = Trainer(_net(batch_sz=8, hidden=13), x, y, x, y, mesh=mesh)
    total, _, _ = tr.run_epoch()
    assert np.isfinite(total)


def test_unrecognized_megafused_value_is_named_error(capfd):
    """MEGAFUSED once chose a kernel family; a config or checkpoint that
    still carries it (whatever its value) loads and trains, and the key is
    named on stderr as ignored, once per net."""
    from theanet_tpu.model import NeuralNet
    from theanet_tpu.trainer import Trainer

    layers = [["InputLayer", {"img_sz": 8}],
              ["HiddenLayer", {"n_out": 8}],
              ["SoftmaxLayer", {"n_out": 3}]]
    x = np.zeros((8, 1, 8, 8), np.float32)
    y = np.zeros((8,), np.int32)
    for bad in (1, 0, "true", "AUTO"):
        prms = {"SEED": 7, "BATCH_SZ": 4, "NUM_EPOCHS": 1,
                "EPOCHS_TO_TEST": 1, "TEST_SAMP_SZ": 4,
                "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 1,
                "MEGAFUSED": bad}
        total, _, _ = Trainer(NeuralNet(layers, prms), x, y, x, y).run_epoch()
        assert np.isfinite(total)
        err = capfd.readouterr().err
        assert err.count("MEGAFUSED") == 1 and "ignored" in err, err


def test_streamed_double_augmentation_guard():
    x, y = _data()
    tr = Trainer(_net(batch_sz=8, elastic=True), x, y, x, y)

    class FakePipe:
        deform = {"translation": 2}

        def __iter__(self):
            return iter([])

    with pytest.raises(ValueError, match="double augmentation"):
        tr.run_epoch_streamed(FakePipe())
    # without host deform the same net streams fine
    plain = [(x[:8], y[:8])]
    total, _ = tr.run_epoch_streamed(plain)
    assert np.isfinite(total)


def test_serving_batch_warning_printed(capsys):
    x, y = _data()
    tr = Trainer(_net(batch_sz=8), x, y, x, y)
    tr.predict(x[:8])
    assert "BATCH SIZE IS NOT 1" in capsys.readouterr().out


def test_nll_threshold_notice_printed(capsys):
    x, y = _data()
    tr = Trainer(_net(batch_sz=8, loss="nll05"), x, y, x, y)
    tr.run_batch(0, 0)
    assert "Using threshold:  0.05" in capsys.readouterr().out


def test_nll_unparseable_notice_printed(capsys):
    x, y = _data()
    tr = Trainer(_net(batch_sz=8, loss="nllxx"), x, y, x, y)
    tr.run_batch(0, 0)
    assert "Did not understand nllxx, using plain NLL" in capsys.readouterr().out
