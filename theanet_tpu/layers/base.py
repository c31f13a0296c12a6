"""Layer base class for the layer library.

Design: a layer object is *static build-time metadata* (shapes, activation
names, regularization hyperparameters, initial weights as numpy arrays) plus a
pure ``apply`` function that is traced under ``jax.jit``. Train vs. eval is a
static ``train: bool`` argument on ``apply`` — the JAX replacement for
the reference's dual-graph ``TestVersion`` pattern (reference:
theanet/neuralnet.py:93,200 builds a twin eval graph per layer; here one object
owns both branches and the jit cache holds the two compiled programs).

Per-batch randomness (augmentation, dropout) is driven by an explicit
``jax.random`` key threaded into ``apply``; each stochastic layer folds in a
build-time stream seed that was consumed from the shared numpy RandomState in
the reference's exact draw order (see theanet_tpu.inits).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["Layer", "DEFAULT_REG"]

# Reference per-layer regularization defaults (theanet/layer/convpool.py:80-84,
# theanet/layer/hidden.py:39-43).
DEFAULT_REG = {"L1": 0, "L2": 0, "momentum": 0.95, "rate": 1, "maxnorm": 0}


class Layer:
    """Base layer.

    Attributes every built layer exposes:
      params_init : list[np.ndarray] — initial/current weights, in the
          reference's ``allwts`` order for checkpoint parity.
      reg : dict or None — per-layer optimizer hyperparameters; None means the
          layer's params are never updated and add no weight cost (parity with
          the reference's ``hasattr(self, 'reg')`` guard, layer.py:70-117).
      n_out / out_sz / num_maps : static shape bookkeeping.
      representation : human-readable description string.
    """

    reg: Optional[dict] = None
    params_init: List[np.ndarray]
    n_out: int
    representation: str = ""

    def __init__(self):
        self.params_init = []

    # -- pure compute ------------------------------------------------------
    def apply(self, wts, x, *, key, train: bool, aux=None):
        """Pure forward. ``wts`` is the layer's current parameter list (jnp
        arrays), ``key`` a jax PRNG key (consumed only by stochastic layers in
        train mode), ``train`` a static bool, ``aux`` the auxiliary input
        (only auxiliary layers read it)."""
        raise NotImplementedError

    # -- bookkeeping -------------------------------------------------------
    def get_wts(self):
        """Initial weights as numpy arrays (the reference's get_wts contract,
        theanet/layer/layer.py:67-68)."""
        return [np.asarray(p) for p in self.params_init]

    def make_reg(self, reg):
        full = dict(DEFAULT_REG)
        full.update(dict(reg) if reg else {})
        return full

    def __str__(self):
        return self.representation
