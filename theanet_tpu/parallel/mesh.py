"""Multi-chip parallelism: device mesh + sharding rules.

The reference is single-process single-device (SURVEY.md §2.4: no DP/TP/PP and
no comm backend — Theano compiles for one device). This design scales the
same training step over a 2-D ``jax.sharding.Mesh``:

  * axis "data"  — batch (data parallel): activations are sharded on the
    batch dimension; XLA inserts the gradient all-reduce automatically
    when the batch-sharded loss meets replicated parameters.
  * axis "model" — tensor parallel over the wide dense layers: a hidden
    layer's W (n_in, n_out) is sharded on n_out and its bias likewise, the
    following head's W on n_in, so the hidden activations stay sharded
    through the pair and XLA inserts exactly one collective at the head
    reduction. Conv filters and small params stay replicated.

Datasets are kept replicated (they are small and live in device memory
once); each step's batch slice gets a sharding constraint so all compute
downstream of the input layer is distributed. This is GSPMD-style: we
annotate, XLA plans the collectives (NCCL on GPUs). The cards of one host
reach each other all to all, so the mesh is a plain reshape of the device
list.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..layers import HiddenLayer, OutputMixin, SoftAuxLayer

__all__ = ["make_mesh", "param_pspecs", "batch_pspec", "shard_params"]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices=None):
    """Create a ("data", "model") mesh. Defaults to all devices on the data
    axis. Fails fast with a named error when the device pool can't fill the
    requested grid (instead of a raw XLA error from deep inside a jit)."""
    if devices is None:
        devices = jax.devices()
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1:
        raise ValueError(
            f"mesh axes must be positive, got data={n_data} model={n_model}"
        )
    if n_data * n_model > len(devices):
        raise ValueError(
            f"mesh ({n_data} data x {n_model} model = {n_data * n_model} "
            f"devices) exceeds the {len(devices)} available JAX devices. "
            "Run under more devices (e.g. "
            "XLA_FLAGS=--xla_force_host_platform_device_count=N for a "
            "virtual CPU mesh) or shrink the mesh."
        )
    grid = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(grid, ("data", "model"))


def _divisible(n: int, mesh: Mesh) -> bool:
    return n % mesh.shape["model"] == 0


def param_pspecs(net, mesh: Mesh) -> List[List[P]]:
    """PartitionSpecs for every parameter, in allwts structure.

    Tensor-parallel rules (applied only when the dimension divides the model
    axis; everything else replicates):
      * hidden (non-head) dense W: shard n_out -> P(None, "model"), b on
        ("model",)
      * head dense W: shard n_in -> P("model", None), b replicated (output
        classes are few)
    """
    specs = []
    tp = mesh.shape["model"] > 1
    for lyr in net.net_layers:
        wts = lyr.get_wts()
        lyr_specs = []
        is_head = isinstance(lyr, OutputMixin)
        is_plain_hidden = isinstance(lyr, HiddenLayer) and not is_head
        for i, w in enumerate(wts):
            spec = P()
            if tp and is_plain_hidden and i == 0 and w.ndim == 2 and _divisible(w.shape[1], mesh):
                spec = P(None, "model")
            elif tp and is_plain_hidden and i == 1 and w.ndim == 1 and _divisible(w.shape[0], mesh):
                spec = P("model")
            elif (
                tp
                and is_head
                # SoftAux's 8-tensor packing (cross weights + frozen aux
                # MLP) replicates whole; AuxConcat is not an OutputMixin so
                # it never reaches this branch
                and not isinstance(lyr, SoftAuxLayer)
                and i == 0
                and w.ndim == 2
                and _divisible(w.shape[0], mesh)
            ):
                spec = P("model", None)
            lyr_specs.append(spec)
        specs.append(lyr_specs)
    return specs


def batch_pspec(ndim: int) -> P:
    """Batch-dim sharding for an activation/batch array of rank ndim."""
    return P("data", *([None] * (ndim - 1)))


def shard_params(params, pspecs, mesh: Mesh):
    """device_put every param with its NamedSharding."""
    out = []
    for lp, ls in zip(params, pspecs):
        out.append(
            [
                jax.device_put(p, NamedSharding(mesh, s))
                for p, s in zip(lp, ls)
            ]
        )
    return out
