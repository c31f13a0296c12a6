"""Activation registry: string -> callable.

Capability parity with the reference activation registry
(reference: theanet/layer/layer.py:11-54): sigmoid, softplus, softmax,
linear, scaled_tanh (1.7*tanh(2x/3)), relu, tanh, and the hundred leaky
relus ``relu00`` .. ``relu99`` whose negative slope is i/100.

All of these are elementwise ops that XLA fuses into the surrounding
matmul/conv epilogues; the registry resolves names at graph *build* time so
nothing string-shaped ever enters a jitted trace.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["activation_by_name", "ACTIVATIONS"]


def _leaky_relu(slope: float):
    def fn(x):
        return jnp.maximum(0.0, x) + jnp.minimum(0.0, x) * slope

    fn.__name__ = f"relu{int(round(slope * 100)):02d}"
    return fn


def _scaled_tanh(x):
    return 1.7 * jnp.tanh(2.0 * x / 3.0)


def _softmax(x):
    # Row-wise softmax over the trailing axis (reference applies it to
    # (batch, classes) matrices).
    return jax.nn.softmax(x, axis=-1)


ACTIVATIONS = {
    "sigmoid": jax.nn.sigmoid,
    "softplus": jax.nn.softplus,
    "softmax": _softmax,
    "Softmax": _softmax,
    "linear": lambda x: x,
    "scaled_tanh": _scaled_tanh,
    "relu": lambda x: jnp.maximum(0.0, x),
    "tanh": jnp.tanh,
}
for _i in range(100):
    ACTIVATIONS[f"relu{_i:02d}"] = _leaky_relu(_i / 100.0)


def activation_by_name(name: str):
    """Resolve an activation function from its string name.

    Raises NotImplementedError for unknown names (same contract as the
    reference's activation_by_name, theanet/layer/layer.py:41-54).
    """
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise NotImplementedError("Unknown Activation Specified: " + name)
