"""Trainer: device-resident data + compiled step/epoch functions.

The reference keeps the whole dataset in device memory via theano.shared and
slices batches with ``givens`` so only a batch index crosses the host boundary
per step (train.py:126-129, neuralnet.py:222-226). This version goes one step
further: the *entire epoch* is a single ``lax.scan`` under jit — one device
dispatch per epoch instead of one per batch — with (params, momentum) buffers
donated so XLA updates them in place in device memory. Per-batch cost and the
min true-class feature are returned as scanned outputs so the reference's
watchdogs (NaN abort, Exp-head divergence diagnostics, train.py:214-226) still
fire on the host.

Batch order is the reference's: fixed sequential batches, no shuffling
(train.py:210), with randomness coming from the in-graph augmentation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from .model import NeuralNet

__all__ = ["Trainer", "get_test_indices"]


def get_test_indices(tot_samps, batch_sz, bth_samps):
    """Rotating-window eval batch-id generator (reference train.py:170-176)."""
    n_bths_each = int(bth_samps / batch_sz)
    n_bths_all = int(tot_samps / batch_sz)
    cur = 0
    while True:
        yield [i % n_bths_all for i in range(cur, cur + n_bths_each)]
        cur = (cur + n_bths_each) % n_bths_all


class Trainer:
    def __init__(
        self,
        net: NeuralNet,
        train_x,
        train_y,
        test_x,
        test_y,
        train_aux=None,
        test_aux=None,
        mesh=None,
    ):
        self.net = net
        self.mesh = mesh
        self.batch_sz = net.batch_sz
        self.n_train_batches = train_x.shape[0] // self.batch_sz
        self.n_test_batches = test_x.shape[0] // self.batch_sz

        # Whole-dataset upload to device memory, once.
        self.d_train_x = jnp.asarray(train_x, dtype=jnp.float32)
        self.d_train_y = jnp.asarray(train_y, dtype=jnp.int32)
        self.d_test_x = jnp.asarray(test_x, dtype=jnp.float32)
        self.d_test_y = jnp.asarray(test_y, dtype=jnp.int32)
        if not net.takes_aux():
            # aux tensors are consumed only by aux-head nets (reference
            # train.py:131-135); datasets may still ship them
            train_aux = test_aux = None
        self.d_train_aux = (
            jnp.asarray(train_aux, dtype=jnp.float32) if train_aux is not None else None
        )
        self.d_test_aux = (
            jnp.asarray(test_aux, dtype=jnp.float32) if test_aux is not None else None
        )

        self.params, self.moms = net.init_params()

        if mesh is not None:
            # Fail fast on mesh/shape mismatches — a non-dividing batch would
            # otherwise surface as a raw XLA sharding error deep inside a jit.
            # Every train batch and eval window has length k*BATCH_SZ, so
            # BATCH_SZ % data-axis == 0 covers them all (incl. TEST_SAMP_SZ
            # windows, which get_test_indices builds from whole batches).
            n_data = mesh.shape["data"]
            if self.batch_sz % n_data:
                raise ValueError(
                    f"BATCH_SZ={self.batch_sz} does not divide across the "
                    f"mesh 'data' axis ({n_data} devices); choose a batch "
                    "size that is a multiple of the data-parallel degree."
                )
            n_model = mesh.shape["model"]
            if self.n_train_batches < 1:
                raise ValueError(
                    f"training set ({train_x.shape[0]} samples) is smaller "
                    f"than one batch (BATCH_SZ={self.batch_sz})"
                )

            # Distribute parameters per the DP+TP sharding rules; momentum
            # buffers shard identically to their parameters.
            from jax.sharding import NamedSharding
            from .parallel.mesh import batch_pspec, param_pspecs, shard_params

            self._pspecs = param_pspecs(net, mesh)
            if n_model > 1 and not any(
                s != () and any(ax is not None for ax in s)
                for ls in self._pspecs for s in ls
            ):
                import warnings

                warnings.warn(
                    f"mesh has a {n_model}-way 'model' axis but no parameter "
                    "dimension divides it — everything will replicate and "
                    "the model axis is wasted. Size hidden widths as "
                    "multiples of the tensor-parallel degree.",
                    stacklevel=2,
                )
            self.params = shard_params(self.params, self._pspecs, mesh)
            self.moms = shard_params(
                self.moms,
                [s[: len(m)] for s, m in zip(self._pspecs, self.moms)],
                mesh,
            )

            def constrain(arr):
                if arr is None:
                    return None
                return jax.lax.with_sharding_constraint(
                    arr, NamedSharding(mesh, batch_pspec(arr.ndim))
                )

        else:

            def constrain(arr):
                return arr

        self._constrain_batch = constrain

        bsz = self.batch_sz
        nb = self.n_train_batches

        # base_key AND the device-resident dataset are threaded into every
        # jitted closure as ARGUMENTS (the ``bk`` / ``tx, ty, taux``
        # parameters): closing over them would embed the seed-derived key
        # and the WHOLE training set as HLO literals, so every executable
        # would carry the dataset and compile-cache keys would miss on every
        # new SEED or dataset of identical shape. Values are unchanged
        # either way, so trajectories are bit-identical.

        def slice_batch(arr, ibatch):
            return jax.lax.dynamic_slice_in_dim(arr, ibatch * bsz, bsz, axis=0)

        def train_batch(params, moms, tx, ty, taux, ibatch, step, lr, bk):
            x = constrain(slice_batch(tx, ibatch))
            y = constrain(slice_batch(ty, ibatch))
            aux = (
                constrain(slice_batch(taux, ibatch))
                if taux is not None
                else None
            )
            key = jax.random.fold_in(bk, step)
            return net.train_step(params, moms, x, y, key=key, lr=lr, aux=aux)

        self._train_batch = jax.jit(train_batch, donate_argnums=(0, 1))

        def train_indices(params, moms, tx, ty, taux, idx, step, lr, bk):
            # Index-vector batches — the reference's take_index_list variant
            # (neuralnet.py:228-234): train on an arbitrary set of sample ids.
            x = constrain(tx[idx])
            y = constrain(ty[idx])
            aux = (
                constrain(taux[idx])
                if taux is not None
                else None
            )
            key = jax.random.fold_in(bk, step)
            return net.train_step(params, moms, x, y, key=key, lr=lr, aux=aux)

        self._train_indices = jax.jit(train_indices, donate_argnums=(0, 1))

        def train_raw(params, moms, x, y, aux, step, lr, bk):
            # Streamed batches (host pipeline feed): data arrives as device
            # arrays instead of dataset slices. Streamed steps live in their
            # own key space (offset 2^30) so they never collide with the
            # scanned-epoch step indices.
            key = jax.random.fold_in(bk, step + (1 << 30))
            aux = constrain(aux) if aux is not None else None
            return net.train_step(
                params, moms, constrain(x), constrain(y), key=key, lr=lr,
                aux=aux,
            )

        self._train_raw = jax.jit(train_raw, donate_argnums=(0, 1))
        self._stream_step = 0  # monotonically increasing across epochs

        # Optional per-epoch shuffling (training_params SHUFFLE, default off:
        # the reference trains fixed sequential batches, train.py:210). The
        # permutation is drawn on-device per epoch; batches become gathers.
        self.shuffle = bool(net.tr_prms.get("SHUFFLE", False))

        def train_epoch(params, moms, tx, ty, taux, epoch_no, lr, bk):
            if self.shuffle:
                perm = jax.random.permutation(
                    jax.random.fold_in(bk, epoch_no + (1 << 29)),
                    nb * bsz,
                )

            def body(carry, ibatch):
                params, moms = carry
                step = epoch_no * nb + ibatch
                if self.shuffle:
                    idx = jax.lax.dynamic_slice_in_dim(perm, ibatch * bsz, bsz)
                    x = constrain(tx[idx])
                    y = constrain(ty[idx])
                    aux = (
                        constrain(taux[idx])
                        if taux is not None
                        else None
                    )
                    key = jax.random.fold_in(bk, step)
                    params, moms, cost, feats, _ = net.train_step(
                        params, moms, x, y, key=key, lr=lr, aux=aux
                    )
                else:
                    params, moms, cost, feats, _ = train_batch(
                        params, moms, tx, ty, taux, ibatch, step, lr, bk
                    )
                    y = slice_batch(ty, ibatch)
                true_f = feats[jnp.arange(bsz), y]
                return (params, moms), (cost, jnp.min(true_f))

            (params, moms), (costs, min_true_f) = jax.lax.scan(
                body, (params, moms), jnp.arange(nb)
            )
            return params, moms, costs, min_true_f

        self._train_epoch = jax.jit(train_epoch, donate_argnums=(0, 1))

        def eval_window(params, x_all, y_all, aux_all, idx, preds_feats, bk):
            x = constrain(x_all[idx])
            y = constrain(y_all[idx])
            aux = constrain(aux_all[idx]) if aux_all is not None else None
            return net.eval_step(params, x, y, aux=aux,
                                 preds_feats=preds_feats, key=bk)

        self._eval_window = jax.jit(eval_window, static_argnums=(5,))

    # -- public API ----------------------------------------------------------

    def _dispatch_epoch(self, lr):
        """One epoch program with NO host sync; returns the device-resident
        per-batch cost and min true-class feature streams."""
        self.params, self.moms, costs, min_true_f = self._train_epoch(
            self.params, self.moms,
            self.d_train_x, self.d_train_y, self.d_train_aux,
            jnp.int32(self.net.get_epoch()), jnp.float32(lr),
            self.net.base_key,
        )
        return costs, min_true_f

    def run_epoch(self, lr: Optional[float] = None):
        """Train one full epoch on-device. Returns (total_cost, per-batch
        costs, per-batch min true-class feature) as numpy."""
        lr = self.net.get_rate() if lr is None else lr
        costs, min_true_f = self._dispatch_epoch(lr)
        costs = np.asarray(costs)
        return float(costs.sum()), costs, np.asarray(min_true_f)

    def run_epochs(self, k: int):
        """Train ``k`` consecutive epochs with ONE final device sync.

        The k epoch programs are dispatched back-to-back and the watchdog
        streams are pulled once at the end. The LR schedule advances after
        EVERY epoch, including the last (the caller must not also call
        inc_epoch_set_rate for these epochs); NaN/divergence watchdogs
        consequently fire at k-epoch granularity.

        Returns (totals (k,), costs (k, n_batches), min_true_f
        (k, n_batches)) as numpy."""
        outs = []
        for _ in range(k):
            outs.append(self._dispatch_epoch(self.net.get_rate()))
            self.net.inc_epoch_set_rate()
        costs = np.asarray(jnp.stack([c for c, _ in outs]))
        minf = np.asarray(jnp.stack([m for _, m in outs]))
        return costs.sum(axis=1), costs, minf

    def run_epoch_streamed(self, pipeline, lr: Optional[float] = None):
        """Train one epoch from a host-side batch producer (e.g.
        theanet_tpu.io.HostPipeline, or any iterable of (x, y) or (x, y, aux)
        tuples) — for corpora too large to keep HBM-resident. Upload of batch
        k+1 overlaps the step on batch k via the pipeline's prefetch queue.
        A trainer-level step counter keeps PRNG keys (dropout, augmentation)
        fresh across epochs regardless of the producer type.
        Returns (total_cost, costs array)."""
        # Double-augmentation guard: a host pipeline that warps batches
        # (deform=...) feeding a net whose input layer ALSO warps in-graph
        # would augment twice — almost certainly a config mistake.
        from .layers import ElasticLayer

        first = self.net.net_layers[0]
        if (
            getattr(pipeline, "deform", None)
            and isinstance(first, ElasticLayer)
            and not first.cfg.is_identity
        ):
            raise ValueError(
                "double augmentation: the host pipeline deforms batches "
                "(deform=...) AND the net's first layer is an active "
                "ElasticLayer. Drop one of the two (in-graph ElasticLayer "
                "is the fast path; host deform is for nets without one)."
            )
        lr = self.net.get_rate() if lr is None else lr
        costs = []
        for batch in pipeline:
            if len(batch) == 3:
                x, y, aux = batch
                aux = jnp.asarray(aux, jnp.float32)
            else:
                x, y = batch
                aux = None
                if self.net.takes_aux():
                    raise ValueError(
                        "this net requires auxiliary input; stream "
                        "(x, y, aux) tuples"
                    )
            self.params, self.moms, cost, _, _ = self._train_raw(
                self.params, self.moms,
                jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.int32),
                aux, jnp.int32(self._stream_step), jnp.float32(lr),
                self.net.base_key,
            )
            self._stream_step += 1
            costs.append(cost)
        # Stack the device scalars and cross the host boundary ONCE — a
        # per-batch float() would wait for the device on every step.
        if costs:
            costs = np.asarray(jnp.stack(costs))
        else:
            costs = np.zeros((0,), np.float32)
        return float(costs.sum()), costs

    def run_batch_indices(self, idx, step: int, lr: Optional[float] = None):
        """Train one step on an arbitrary index vector (take_index_list
        parity). ``idx`` must have length BATCH_SZ for shape stability."""
        lr = self.net.get_rate() if lr is None else lr
        idx = jnp.asarray(np.asarray(idx, np.int32))
        self.params, self.moms, cost, feats, logp = self._train_indices(
            self.params, self.moms,
            self.d_train_x, self.d_train_y, self.d_train_aux,
            idx, jnp.int32(step), jnp.float32(lr), self.net.base_key,
        )
        return float(cost), np.asarray(feats), np.asarray(logp)

    def reset_momentum(self):
        """Zero all gradient accumulators (the reference's
        reset_accumulated_gradients, neuralnet.py:243-254)."""
        from .optim import init_momentum

        moms = init_momentum(self.net.net_layers, self.params)
        if self.mesh is not None:
            from .parallel.mesh import shard_params

            moms = shard_params(
                moms,
                [s[: len(m)] for s, m in zip(self._pspecs, moms)],
                self.mesh,
            )
        self.moms = moms

    def predict(self, x, aux=None, get_output_of_layers=()):
        """Inference on raw arrays — the reference's get_data_test_model
        (neuralnet.py:282-296): returns (features, y_preds, *layer outputs)."""
        layer_key = tuple(get_output_of_layers)
        if not hasattr(self, "_predict_jits"):
            self._predict_jits = {}
        if layer_key not in self._predict_jits:
            # Serving-shape notice, printed when the predict function is
            # first built (reference get_data_test_model, neuralnet.py:284-286).
            if self.batch_sz != 1:
                print("\n****WARNING****: BATCH SIZE IS NOT 1. "
                      "WILL BE EXPECTING A BATCH OF INPUT IMAGES AT A TIME.\n")
            self._predict_jits[layer_key] = jax.jit(
                lambda params, x, aux: self.net.predict(
                    params, x, aux=aux, get_output_of_layers=layer_key
                )
            )
        out = self._predict_jits[layer_key](
            self.params,
            jnp.asarray(x, jnp.float32),
            jnp.asarray(aux, jnp.float32) if aux is not None else None,
        )
        return tuple(np.asarray(o) for o in out)

    def run_batch(self, ibatch: int, step: int, lr: Optional[float] = None):
        """Single-batch step (the reference's granularity), for debugging and
        watchdog-exact parity."""
        lr = self.net.get_rate() if lr is None else lr
        self.params, self.moms, cost, feats, logp = self._train_batch(
            self.params, self.moms,
            self.d_train_x, self.d_train_y, self.d_train_aux,
            jnp.int32(ibatch), jnp.int32(step), jnp.float32(lr),
            self.net.base_key,
        )
        return float(cost), np.asarray(feats), np.asarray(logp)

    def _window_sample_idx(self, batch_ids):
        bsz = self.batch_sz
        return jnp.asarray(
            np.concatenate([np.arange(b * bsz, (b + 1) * bsz) for b in batch_ids]),
            dtype=jnp.int32,
        )

    def evaluate(self, which: str, batch_ids, preds_feats: bool = False):
        """Evaluate a window of batches; returns (err%, second_stat%) matching
        the reference's test_wrapper scaling (train.py:155-161). With
        ``preds_feats`` the head's features and predictions over the window
        are appended — the reference's get_test_model(preds_feats=True)
        surface (neuralnet.py:272-273): (err%, second%, features, y_preds)."""
        if len(batch_ids) == 0:
            raise ValueError(
                "empty eval window: TEST_SAMP_SZ smaller than BATCH_SZ "
                "yields zero whole batches per rotating window (the "
                "reference's test_wrapper divides by zero on the same "
                "config, train.py:155-161); raise TEST_SAMP_SZ to at "
                "least one batch"
            )
        idx = self._window_sample_idx(batch_ids)
        # The one-call window statistic equals the reference's mean of
        # per-batch means ONLY because every window batch is whole
        # (equal-size). _window_sample_idx builds from whole batch ids, so
        # this holds for every reachable path; fail loudly if a future
        # caller ever changes that rather than silently shifting the stat
        # (docs/reference_parity.md "get_test_model" row).
        if len(idx) % self.batch_sz != 0:
            # a real error, not an assert: this invariant is load-bearing
            # for the statistic itself and must survive python -O
            raise ValueError(
                "evaluate window must consist of whole batches "
                f"({len(idx)} samples vs BATCH_SZ={self.batch_sz})"
            )
        if which == "test":
            out = self._eval_window(
                self.params, self.d_test_x, self.d_test_y, self.d_test_aux,
                idx, preds_feats, self.net.base_key,
            )
        else:
            out = self._eval_window(
                self.params, self.d_train_x, self.d_train_y, self.d_train_aux,
                idx, preds_feats, self.net.base_key,
            )
        stats = (100.0 * float(out[0]), 100.0 * float(out[1]))
        if preds_feats:
            return stats + (np.asarray(out[2]), np.asarray(out[3]))
        return stats

    def evaluate_full(self, which: str):
        n = self.n_test_batches if which == "test" else self.n_train_batches
        return self.evaluate(which, list(range(n)))

    def checkpoint_dict(self):
        self.sync_net()
        return self.net.get_init_params()

    def sync_net(self):
        """Write the CURRENT device params back into the net's layers so
        net.get_wts_info() / get_init_params() reflect training progress
        (they read layer params_init, which otherwise holds the values from
        init or the last checkpoint)."""
        self.net.snapshot_params(
            [[np.asarray(p) for p in lp] for lp in self.params]
        )

    def snapshot_state(self):
        """Device-side copy of the full training state (params + momentum
        accumulators) plus the epoch counter. One parameter-set copy on
        device, no host transfer — cheap enough to take per chained-epoch
        chunk so NaN diagnostics can replay to the failing epoch
        (restore_state)."""
        st = jax.tree.map(jnp.copy, (self.params, self.moms))
        return (st, self.net.get_epoch(), self._stream_step)

    def restore_state(self, snap):
        """Rewind training to a snapshot_state() point: state tensors, the
        epoch counter (the LR schedule and all per-epoch RNG derive from
        it), and the streamed-step counter (streamed-batch RNG derives
        from that one) — re-running from here reproduces the trajectory."""
        state, epoch, stream_step = snap
        self.params, self.moms = jax.tree.map(jnp.copy, state)
        self.net.tr_prms["CUR_EPOCH"] = epoch
        self._stream_step = stream_step
