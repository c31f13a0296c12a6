"""NeuralNet: dict-spec -> layer stack -> pure jitted train/eval functions.

The JAX re-architecture of the reference's twin-graph builder
(theanet/neuralnet.py:59-333). The spec format is identical — a list of
('LayerName', kwargs) pairs dispatched by name plus a flat training_params
dict — and the inter-layer plumbing rules are reproduced exactly
(neuralnet.py:113-201): shape propagation of num_maps/out_sz skipping
DropOut layers, flattening before dense heads, runtime img_sz injection,
CenteredOut centers unpacking. What changes is the execution model:

  * instead of two symbolic graphs per layer (TestVersion), one pure
    ``forward(params, x, key, train)`` traced twice under jit;
  * instead of theano.function(givens=batch slices), jitted step functions
    that close over device-resident data and take a batch index
    (lax.dynamic_slice keeps everything on-chip; only the index crosses the
    host boundary per step, like the reference's design);
  * instead of shared-variable updates, functional (params, momentum) pytrees
    with donated buffers.
"""

from __future__ import annotations

import sys
from functools import reduce
from operator import mul
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from . import layers as layer_mod
from .layers import (
    AuxConcatLayer,
    CenteredOutLayer,
    ColorLayer,
    ConvLayer,
    DropOutLayer,
    ElasticLayer,
    ExpLossLayer,
    HiddenLayer,
    HingeLayer,
    InputLayer,
    MeanLayer,
    OutputMixin,
    PoolLayer,
    SoftAuxLayer,
    SoftmaxLayer,
)
from .optim import apply_updates, init_momentum, learning_rate, weight_cost

__all__ = [
    "NeuralNet",
    "get_layers_info",
    "get_wts_info",
    "get_training_params_info",
]

# training_params keys this package reads. A config or checkpoint may carry
# others (older ones carry switches among kernels that no longer exist): it
# loads, and each such key is named once on stderr as ignored.
KNOWN_TRAINING_PARAMS = frozenset({
    "SEED", "BATCH_SZ", "NUM_EPOCHS", "EPOCHS_TO_TEST", "TEST_SAMP_SZ",
    "INIT_LEARNING_RATE", "EPOCHS_TO_HALF_RATE", "CUR_EPOCH",
    "COMPUTE_DTYPE", "REMAT", "SHUFFLE",
})


# --------------------------- info helpers (neuralnet.py:20-51) -------------


def get_layers_info(layers):
    """Spec pretty-printer; output text matches neuralnet.py:20-27 line for
    line (logs/checkpoint banners are a compatibility surface)."""
    lines = []
    for name, kwargs in layers:
        lines.append(f"\n{name} : ")
        lines.extend(f"\n\t{key} : \t{val}" for key, val in kwargs.items())
    return "".join(lines)


def _wt_lines(layer_idx, ww, detailed):
    yield f"\nLayer {layer_idx}:"
    for w in ww:
        n_ww = reduce(mul, w.shape, 1)
        line = f"\n\t {w.shape} {w.dtype} ❲{n_ww}❳"
        if detailed:
            line += f" ❲{w.min():.2e}, {w.mean():.2e}, {w.max():.2e}❳"
        yield line


def get_wts_info(wts, detailed=False):
    """Weight-table pretty-printer; same output surface as neuralnet.py:30-43."""
    n_wts = sum(reduce(mul, w.shape, 1) for ww in wts for w in ww)
    body = "".join(
        line
        for l, ww in enumerate(wts)
        for line in _wt_lines(l, ww, detailed)
    )
    return body + f"\n\nTotal Number of Weights : {n_wts:,}"


def get_training_params_info(training_params):
    """Sorted key/value dump; output matches neuralnet.py:46-51."""
    lines = [
        f"\n\t{key} : \t{training_params[key]}"
        for key in sorted(training_params)
    ]
    return "Training Parameters:" + "".join(lines)


# ------------------------------- the net -----------------------------------

_INPUT_TYPES = (InputLayer, ElasticLayer, ColorLayer)
_DENSE_TYPES = (
    AuxConcatLayer,
    HiddenLayer,
    SoftmaxLayer,
    SoftAuxLayer,
    HingeLayer,
    ExpLossLayer,
)


class NeuralNet:
    """Builds the layer stack from the spec and owns the pure step functions.

    Same constructor contract as the reference (neuralnet.py:59-111): with
    ``allwts=None`` a fresh numpy RandomState(SEED) drives initialization
    (draw order matches the reference for bit-exact init parity); with
    ``allwts`` given, weights are restored and no draws happen.
    """

    def __init__(self, layers, training_params, allwts=None):
        if allwts is None:
            self.rand_gen = np.random.RandomState(training_params["SEED"])
        else:
            self.rand_gen = None

        self.tr_prms = training_params
        self.layers = layers
        self.batch_sz = training_params["BATCH_SZ"]
        self.net_layers: List[layer_mod.Layer] = []

        # Input layer (neuralnet.py:87-93)
        input_layer_type = getattr(layer_mod, layers[0][0])
        assert input_layer_type in _INPUT_TYPES, (
            "First layer needs to be Input or Elastic or Color Layer"
        )
        self.net_layers.append(
            input_layer_type(rand_gen=self.rand_gen, **layers[0][1])
        )

        for i in range(1, len(layers)):
            self._append_layer(i, allwts[i] if allwts else None)

        # Auxiliary input discovery (neuralnet.py:100-105)
        self.aux_layer_idx: Optional[int] = None
        for i, lyr in enumerate(self.net_layers):
            if isinstance(lyr, (AuxConcatLayer, SoftAuxLayer)):
                assert self.aux_layer_idx is None, "Multiple Aux Inputs"
                self.aux_layer_idx = i

        head = self.net_layers[-1]
        assert isinstance(head, OutputMixin), "Last layer must be an output head"
        self.head = head

        if "CUR_EPOCH" not in training_params:
            training_params["CUR_EPOCH"] = 0

        for k in sorted(set(training_params) - KNOWN_TRAINING_PARAMS):
            print(f"theanet_tpu: training_params key {k} is not used and is "
                  "ignored", file=sys.stderr)

        # Mixed precision: COMPUTE_DTYPE='bfloat16' runs the network body in
        # bf16 with f32 master weights, f32 gradient accumulation, and f32
        # head/loss math — the analog of the reference's theano floatX knob.
        # Default: full f32.
        cd = training_params.get("COMPUTE_DTYPE")
        self.compute_dtype = jnp.dtype(cd) if cd else None
        # REMAT=True rematerializes each layer's forward in the backward pass
        # (jax.checkpoint), trading FLOPs for device memory on large batches
        # or deep stacks. Default off (these nets are small).
        self.remat = bool(training_params.get("REMAT", False))

        # Initial parameter pytree in checkpoint ('allwts') structure.
        self.allwts0 = [lyr.get_wts() for lyr in self.net_layers]
        # Base PRNG for per-batch randomness (augmentation, dropout), drawn
        # through XLA's RngBitGenerator ('rbg'). Augmentation randomness is
        # statistical (not bit-matched to the reference's Theano
        # RandomStreams), so the generator choice is free.
        # SEED is required on BOTH paths: fresh init reads it above for the
        # weight RandomState, and a restored net must not silently fall
        # back to a fixed augmentation/dropout stream (every checkpoint the
        # framework writes carries its training_params incl. SEED)
        self.base_key = jax.random.key(
            int(training_params["SEED"]), impl="rbg"
        )

    # -- builder (mirrors neuralnet.py:113-201) -----------------------------

    def _append_layer(self, i, wts):
        layer_type, layer_args = self.layers[i]
        layer_args = dict(layer_args)
        prev = self.net_layers[i - 1]
        cls = getattr(layer_mod, layer_type)

        if cls in (ElasticLayer, ColorLayer, ConvLayer, PoolLayer, MeanLayer):
            # DropOut has no num_maps; shape info comes from the layer before
            # it (neuralnet.py:123-130).
            use = self.net_layers[i - 2] if isinstance(prev, DropOutLayer) else prev
            num_prev_maps = use.num_maps
            prev_out_sz = use.out_sz

        if cls in (ElasticLayer, ColorLayer):
            layer_args.pop("num_maps", None)
            layer_args.pop("img_sz", None)
            # the reference del-mutates the spec it stores (neuralnet.py:
            # 133-136), so mid-stack entries lose these keys in banners and
            # checkpoints — match that compatibility surface
            self.layers[i][1].pop("num_maps", None)
            self.layers[i][1].pop("img_sz", None)
            curr = cls(
                num_maps=num_prev_maps,
                img_sz=prev_out_sz,
                rand_gen=self.rand_gen,
                **layer_args,
            )
        elif cls is ConvLayer:
            curr = ConvLayer(
                wts,
                self.rand_gen,
                self.batch_sz,
                num_prev_maps,
                prev_out_sz,
                **layer_args,
            )
        elif cls in (PoolLayer, MeanLayer):
            curr = cls(num_maps=num_prev_maps, in_sz=prev_out_sz, **layer_args)
        elif cls is DropOutLayer:
            curr = DropOutLayer(self.rand_gen, prev.n_out, **layer_args)
        elif cls in _DENSE_TYPES:
            curr = cls(wts, self.rand_gen, prev.n_out, **layer_args)
        elif cls is CenteredOutLayer:
            # Centers travel with the weights. We accept both our format
            # ([w, b, centers]) and the reference's documented unpack index
            # (wts[3], neuralnet.py:184-187).
            centers = None
            if wts:
                if len(wts) >= 4:
                    centers = wts[3]
                elif len(wts) == 3:
                    centers = wts[2]
                else:
                    # a [w, b] entry has no centers to restore; re-drawing
                    # them from the RandomState (at a different stream
                    # position than the original draw) would silently
                    # corrupt the model. The reference cannot round-trip
                    # this format either (wts[3] raises IndexError).
                    raise ValueError(
                        "CenteredOutLayer checkpoint entry has no centers "
                        "(got {} tensors, need [w, b, centers])".format(
                            len(wts))
                    )
                wts = wts[:2]
            curr = CenteredOutLayer(
                wts, centers, self.rand_gen, prev.n_out, **layer_args
            )
        else:
            raise NotImplementedError("Unknown Layer Type" + layer_type)

        self.net_layers.append(curr)

    # -- pure compute --------------------------------------------------------

    def _cast_compute(self, params, x):
        """Apply COMPUTE_DTYPE to the network inputs/weights — shared by the
        train/eval path (forward) and the serving path (predict) so both run
        the identical network body."""
        if self.compute_dtype is None:
            return params, x
        return (
            jax.tree.map(lambda p: p.astype(self.compute_dtype), params),
            x.astype(self.compute_dtype),
        )

    def forward(self, params, x, *, key, train, aux=None):
        """Run the stack; returns the head-state dict of the output layer."""
        params, x = self._cast_compute(params, x)
        out = x
        for i, lyr in enumerate(self.net_layers):
            k = jax.random.fold_in(key, i)
            if lyr is self.head:
                return lyr.apply_head(params[i], out, key=k, train=train, aux=aux)
            apply = lyr.apply
            if self.remat:
                apply = jax.checkpoint(
                    lambda p, o, _k, _lyr=lyr: _lyr.apply(
                        p, o, key=_k, train=train, aux=aux
                    ),
                    static_argnums=(),
                )
                out = apply(params[i], out, k)
            else:
                out = apply(params[i], out, key=k, train=train, aux=aux)
        raise AssertionError("unreachable: head not applied")

    def cost(self, params, x, y, *, key, aux=None):
        """Training cost: head loss + all layers' weight cost
        (neuralnet.py:208-210)."""
        hs = self.forward(params, x, key=key, train=True, aux=aux)
        return self.head.cost(hs, y) + weight_cost(self.net_layers, params), hs

    def train_step(self, params, moms, x, y, *, key, lr, aux=None):
        """One SGD step. Returns (params, moms, cost, features, logprob) —
        the same observables as the reference training fn
        (neuralnet.py:236-241)."""
        (cost_val, hs), grads = jax.value_and_grad(
            lambda p: self.cost(p, x, y, key=key, aux=aux), has_aux=True
        )(params)
        params, moms = apply_updates(self.net_layers, params, moms, grads, lr)
        return params, moms, cost_val, hs["features"], hs["logprob"]

    def eval_step(self, params, x, y, *, aux=None, preds_feats=False,
                  key=None):
        """Eval statistics (sym_err_rate, second_stat) — reference
        sym_and_oth_err_rate (outlayers.py:69-80). With ``preds_feats``
        the head's (features, y_preds) are appended, mirroring
        get_test_model(preds_feats=True) (neuralnet.py:272-273).
        ``key`` lets jitted callers thread base_key as an ARGUMENT —
        closing over it would embed the seed-derived key as an HLO
        literal, making compile-cache keys seed-dependent."""
        if key is None:
            key = self.base_key
        hs = self.forward(params, x, key=key, train=False, aux=aux)
        stats = self.head.sym_and_oth_err_rate(hs, y)
        if preds_feats:
            return stats + self.head.features_and_predictions(hs)
        return stats

    def predict(self, params, x, *, aux=None, get_output_of_layers=()):
        """Deployment entry point: features + predictions on raw arrays, with
        optional intermediate activations (reference get_data_test_model,
        neuralnet.py:282-296)."""
        if not get_output_of_layers:
            # same graph as eval_step so deployment predictions cannot
            # diverge from the eval statistics
            hs = self.forward(params, x, key=self.base_key, train=False,
                              aux=aux)
            return (hs["features"], hs["y_preds"])
        params, x = self._cast_compute(params, x)
        outs = []
        out = x
        hs = None
        for i, lyr in enumerate(self.net_layers):
            if lyr is self.head:
                hs = lyr.apply_head(
                    params[i], out, key=self.base_key, train=False, aux=aux
                )
                out = hs["output"]
            else:
                out = lyr.apply(
                    params[i], out, key=self.base_key, train=False, aux=aux
                )
            outs.append(out)
        result = [hs["features"], hs["y_preds"]]
        for index in get_output_of_layers:
            result.append(outs[index])
        return tuple(result)

    # -- state & schedule ----------------------------------------------------

    def init_params(self):
        """Fresh (params, momentum) pytrees on device."""
        params = [[jnp.asarray(w) for w in lw] for lw in self.allwts0]
        moms = init_momentum(self.net_layers, params)
        return params, moms

    def takes_aux(self):
        return self.aux_layer_idx is not None

    def get_init_params(self):
        """The checkpoint dict — identical structure to the reference
        (neuralnet.py:298-301)."""
        return {
            "layers": self.layers,
            "training_params": self.tr_prms,
            "allwts": [lyr.get_wts() for lyr in self.net_layers],
        }

    def snapshot_params(self, params):
        """Copy current device params back into the layers so get_wts() /
        get_init_params() reflect training progress. Only the layer's
        TRAINABLE tensors write back: the params pytree mirrors get_wts(),
        which for a frozen-centers CenteredOut layer appends the constant
        centers — those must not grow params_init (a write-back of all of
        lp once duplicated centers in checkpoints)."""
        for lyr, lp in zip(self.net_layers, params):
            lyr.params_init = [np.asarray(p)
                               for p in lp[: len(lyr.params_init)]]

    def get_rate(self):
        return learning_rate(self.tr_prms)

    def inc_epoch_set_rate(self):
        self.tr_prms["CUR_EPOCH"] += 1

    def get_epoch(self):
        return self.tr_prms["CUR_EPOCH"]

    # -- info -----------------------------------------------------------------

    def __str__(self):
        return "\nLayers\n\t" + "\n\t".join(str(l) for l in self.net_layers)

    def get_layers_info(self):
        return get_layers_info(self.layers)

    def get_wts_info(self, detailed=False):
        return get_wts_info([l.get_wts() for l in self.net_layers], detailed)

    def get_training_params_info(self):
        return get_training_params_info(self.tr_prms)
