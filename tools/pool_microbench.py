#!/usr/bin/env python3
"""Micro-benchmark of max-pool strategies (Theano semantics, pool 2).

    python tools/pool_microbench.py [--f32] [--check]

Shapes: the flagship's two pools (batch 20: 4 maps 26->13 and 20 maps
11->6) and the bench --wide pools (batch 256: 64 maps 54->27 and 128 maps
25->13). For each shape it checks every candidate elementwise against the
shipped implementation (layers/conv.py) and then times it on the default
device: the median over repetitions of ``inner`` back-to-back calls ended
by one host sync.

forward:
  1. reduce_window        (the shipped _maxpool_fwd_impl)
  2. strided-4            max of the four stride-2 slices
  3. reshape-max          (B,M,o,2,o,2).max((3,5))
  4. two-stage            max over W pairs, then over H pairs

all-tied backward (Theano MaxPoolGrad: every tied max gets the full grad):
  A. windowed-broadcast   (the shipped _maxpool_bwd)
  B. quadrant + interior-pad   4x (eq-select -> lax.pad interior=1) summed
  C. quadrant + interleave     stack on minor axes -> reshape

``--check`` runs the checks with one timing call each. Inputs are small
integers, so ties are common and bf16 comparisons stay exact.
"""

import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from theanet_tpu.layers.conv import _maxpool_bwd, _maxpool_fwd_impl  # noqa: E402

SHAPES = [
    ("flagship pool1 26->13", (20, 4, 26, 26), 13),
    ("flagship pool2 11->6", (20, 20, 11, 11), 6),
    ("wide pool1 54->27", (256, 64, 54, 54), 27),
    ("wide pool2 25->13", (256, 128, 25, 25), 13),
]


def timed(fn, args, reps=7, inner=200):
    """Median seconds per call over ``reps`` runs of ``inner`` calls."""
    out = fn(*args)
    jax.block_until_ready(out)
    per = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        per.append((time.perf_counter() - t0) / inner)
    return float(np.median(per))


# ----------------------------- forwards ------------------------------------


def _pad_tail(x, out_sz, p):
    full = out_sz * p
    if full > x.shape[2]:
        pw = (0, full - x.shape[2])
        x = jnp.pad(x, ((0, 0), (0, 0), pw, pw), constant_values=-jnp.inf)
    return x


def fwd_reduce_window(x, out_sz, p=2):
    return _maxpool_fwd_impl(x, p, out_sz, False)


def fwd_strided(x, out_sz, p=2):
    x = _pad_tail(x, out_sz, p)
    q = [x[:, :, i::2, j::2] for i in range(2) for j in range(2)]
    return jnp.maximum(jnp.maximum(q[0], q[1]), jnp.maximum(q[2], q[3]))


def fwd_reshape(x, out_sz, p=2):
    x = _pad_tail(x, out_sz, p)
    b, m = x.shape[:2]
    return x.reshape(b, m, out_sz, p, out_sz, p).max(axis=(3, 5))


def fwd_two_stage(x, out_sz, p=2):
    x = _pad_tail(x, out_sz, p)
    b, m = x.shape[:2]
    full = out_sz * p
    # W pairs first (minor dim), then H pairs
    x = x.reshape(b, m, full, out_sz, p).max(axis=4)
    return x.reshape(b, m, out_sz, p, out_sz).max(axis=3)


# ----------------------------- backwards -----------------------------------


def bwd_shipped(x, pooled, g, out_sz, p=2):
    (dx,) = _maxpool_bwd(p, out_sz, False, (x, pooled), g)
    return dx


def bwd_quadrant_pad(x, pooled, g, out_sz, p=2):
    in_sz = x.shape[2]
    xw = _pad_tail(x, out_sz, p)
    zero = jnp.zeros((), g.dtype)
    dx = None
    for i in range(2):
        for j in range(2):
            q = xw[:, :, i::2, j::2]
            dq = jnp.where(q == pooled, g, zero)
            # interior padding places quadrant (i, j) back at stride 2
            cfg = [(0, 0, 0), (0, 0, 0),
                   (i, 1 - i, 1), (j, 1 - j, 1)]
            piece = jax.lax.pad(dq, zero, cfg)
            dx = piece if dx is None else dx + piece
    return dx[:, :, :in_sz, :in_sz].astype(x.dtype)


def bwd_quadrant_interleave(x, pooled, g, out_sz, p=2):
    in_sz = x.shape[2]
    xw = _pad_tail(x, out_sz, p)
    b, m = x.shape[:2]
    zero = jnp.zeros((), g.dtype)
    rows = []
    for i in range(2):
        cols = []
        for j in range(2):
            q = xw[:, :, i::2, j::2]
            cols.append(jnp.where(q == pooled, g, zero))
        rows.append(jnp.stack(cols, axis=4))  # (b, m, o, o, 2)
    dx = jnp.stack(rows, axis=3)  # (b, m, o, 2, o, 2)
    dx = dx.reshape(b, m, out_sz * p, out_sz * p)
    return dx[:, :, :in_sz, :in_sz].astype(x.dtype)


FWDS = [("reduce_window", fwd_reduce_window), ("strided-4", fwd_strided),
        ("reshape-max", fwd_reshape), ("two-stage", fwd_two_stage)]
BWDS = [("windowed-bcast", bwd_shipped), ("quad+pad", bwd_quadrant_pad),
        ("quad+ilv", bwd_quadrant_interleave)]


def run_shape(shape, out_sz, dt, reps=7, inner=200, seed=0):
    """[(direction, name, matches shipped, us per call)] for one shape."""
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randint(0, 7, shape).astype(np.float32), dt)
    ref_fwd = np.asarray(fwd_reduce_window(x, out_sz), np.float32)
    rows = []
    for name, fn in FWDS:
        f = jax.jit(fn, static_argnums=1)
        ok = np.array_equal(np.asarray(f(x, out_sz), np.float32), ref_fwd)
        rows.append(("fwd", name, ok,
                     timed(f, (x, out_sz), reps, inner) * 1e6))
    pooled = jnp.asarray(ref_fwd, dt)
    g = jnp.asarray(rng.randint(1, 9, pooled.shape).astype(np.float32), dt)
    ref_bwd = np.asarray(bwd_shipped(x, pooled, g, out_sz), np.float32)
    for name, fn in BWDS:
        f = jax.jit(fn, static_argnums=3)
        got = np.asarray(f(x, pooled, g, out_sz), np.float32)
        rows.append(("bwd", name, np.array_equal(got, ref_bwd),
                     timed(f, (x, pooled, g, out_sz), reps, inner) * 1e6))
    return rows


def main():
    dt = jnp.float32 if "--f32" in sys.argv else jnp.bfloat16
    reps, inner = (1, 1) if "--check" in sys.argv else (7, 200)
    dev = jax.devices()[0]
    print(f"device {dev.platform} {dev.device_kind}")
    bad = 0
    for label, shape, out_sz in SHAPES:
        print(f"== {label}  {shape} {jnp.dtype(dt).name}")
        for d, name, ok, us in run_shape(shape, out_sz, dt, reps, inner):
            bad += not ok
            print(f"  {d} {name:15s} {us:8.1f} us   match={ok}")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
