"""The timing tools measure what the package ships: every max-pool candidate
of tools/pool_microbench.py matches the shipped pool, and the two resample
forms that tools/resample_timing.py times train the flagship identically."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import pool_microbench  # noqa: E402
import resample_timing  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,out_sz", [
    ((2, 4, 26, 26), 13),  # even: no tail window
    ((2, 20, 11, 11), 6),  # odd: the tail window is partial
    ((1, 3, 25, 25), 13),
])
def test_pool_candidates_match_the_shipped_pool(shape, out_sz, dtype):
    rows = pool_microbench.run_shape(shape, out_sz, jnp.dtype(dtype),
                                     reps=1, inner=1)
    assert len(rows) == len(pool_microbench.FWDS) + len(pool_microbench.BWDS)
    assert all(ok for _, _, ok, _ in rows), rows


@pytest.mark.parametrize("nearest", [True, False])
def test_resample_forms_train_the_flagship_alike(nearest):
    from theanet_tpu.trainer import Trainer

    rng = np.random.RandomState(0)
    x = rng.rand(60, 1, 16, 16).astype(np.float32)
    y = rng.randint(0, 10, 60).astype(np.int32)
    costs = {}
    for m in resample_timing.METHODS:
        net = bench.flagship_net(20, 16, nearest, m)
        assert net.net_layers[0].method == m
        costs[m] = Trainer(net, x, y, x[:20], y[:20]).run_epoch()[1]
    # Same taps, one as a gather and one as a HIGHEST-precision product:
    # float32 rounding differences only.
    np.testing.assert_allclose(costs["matmul"], costs["gather"], rtol=1e-5)
