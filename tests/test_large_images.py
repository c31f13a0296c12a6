"""Large-image paths: a config that names the old 'auto' resample runs the
gather (the dense tap matrix grows with the square of the pixel count),
the resample takes no other name, and the full pipeline must train on
64x64 3-channel data."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from theanet_tpu.layers import ElasticLayer
from theanet_tpu.model import NeuralNet
from theanet_tpu.ops.elastic import resample
from theanet_tpu.trainer import Trainer


def test_auto_uses_gather_for_large_images():
    kw = dict(img_sz=64, num_maps=3, translation=3, zoom=1.1, magnitude=30,
              sigma=8, angle=5)
    layer = ElasticLayer(method="auto", **kw)
    assert layer.method == "gather"
    x = jnp.asarray(np.random.RandomState(0).rand(2, 3, 64, 64), jnp.float32)
    out = layer.apply(None, x, key=jax.random.PRNGKey(0), train=True)
    assert out.shape == x.shape
    assert np.isfinite(np.asarray(out)).all()
    out2 = ElasticLayer(**kw).apply(None, x, key=jax.random.PRNGKey(0),
                                    train=True)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(out2))


@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_resample_rejects_other_methods(method):
    x = jnp.zeros((1, 1, 8, 8), jnp.float32)
    target = jnp.asarray(np.indices((8, 8)), jnp.float32)
    with pytest.raises(ValueError, match="unknown resample method"):
        resample(x, target, method=method)


def test_full_pipeline_trains_on_64px_3channel():
    spec = [
        ["ColorLayer", {"balance": 1.2, "gamma": 1.2}],
        ["ElasticLayer", {"translation": 2, "zoom": 1.1, "magnitude": 20,
                          "sigma": 6, "angle": 5, "img_sz": 64}],
        ["ConvLayer", {"num_maps": 8, "filter_sz": 5, "stride": 2}],
        ["PoolLayer", {"pool_sz": 2}],
        ["MeanLayer", {}],
        ["SoftmaxLayer", {"n_out": 5}],
    ]
    spec[0][1]["img_sz"] = 64
    spec[0][1]["num_maps"] = 3
    prms = {"SEED": 3, "BATCH_SZ": 8, "NUM_EPOCHS": 1, "EPOCHS_TO_TEST": 1,
            "TEST_SAMP_SZ": 8, "INIT_LEARNING_RATE": 0.1,
            "EPOCHS_TO_HALF_RATE": 1}
    rng = np.random.RandomState(0)
    x = rng.rand(32, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 5, 32).astype(np.int32)
    net = NeuralNet(spec, prms)
    tr = Trainer(net, x, y, x, y)
    total, _, _ = tr.run_epoch()
    assert np.isfinite(total)
