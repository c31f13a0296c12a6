"""Convolution / pooling layers: ConvLayer, PoolLayer, MeanLayer.

Capability parity with reference theanet/layer/convpool.py, built on
``lax.conv_general_dilated`` / ``lax.reduce_window``, which XLA hands to
cuDNN or its own fused kernels.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..activations import activation_by_name
from ..inits import init_wb
from .base import Layer

__all__ = ["ConvLayer", "PoolLayer", "MeanLayer"]


class ConvLayer(Layer):
    """2-D convolution with static shapes (reference convpool.py:14-95).

    Modes: 'valid', 'full', 'same' (same = full conv then center crop; stride
    must be 1). Note the reference's 'full'-mode size bookkeeping is
    out = in + filter + 1 (convpool.py:64) even though the tensor produced is
    in + filter - 1; we reproduce the bookkeeping as-is so configs behave
    identically (a 'full' net that shape-errors there shape-errors here).
    """

    def __init__(
        self,
        wts,
        rand_gen,
        batch_sz,
        num_prev_maps,
        in_sz,
        num_maps,
        filter_sz,
        stride,
        mode="valid",
        actvn="relu50",
        reg=(),
    ):
        super().__init__()
        assert wts is not None or rand_gen is not None
        assert mode in ("valid", "full", "same")

        filter_shape = (num_maps, num_prev_maps, filter_sz, filter_sz)
        fan_in = num_prev_maps * filter_sz * filter_sz
        fan_out = num_maps * filter_sz * filter_sz
        w, b = init_wb(
            wts, rand_gen, filter_shape, (num_maps,), fan_in, fan_out, actvn
        )
        self.params_init = [w, b]

        if mode == "same":
            assert stride == 1, "For Same mode stride should be 1"
            self.out_sz = in_sz
        elif mode == "full":
            self.out_sz = in_sz + filter_sz + 1  # reference convpool.py:64
        else:
            self.out_sz = in_sz - filter_sz + 1
        self.out_sz //= stride

        self.in_sz = in_sz
        self.num_maps = num_maps
        self.num_prev_maps = num_prev_maps
        self.filter_sz = filter_sz
        self.stride = stride
        self.mode = mode
        self.actvn = actvn
        self.n_out = num_maps * self.out_sz**2
        self.reg = self.make_reg(reg)
        self.representation = (
            "Conv Maps:{:2d} Filter:{} Stride:{} Mode:{} Output:{:2d} "
            "Act:{}\n\t  L1:{L1} L2:{L2} Momentum:{momentum} Rate:{rate} "
            "Max Norm:{maxnorm}".format(
                num_maps, filter_sz, stride, mode, self.out_sz, actvn,
                **self.reg,
            )
        )

    def apply(self, wts, x, *, key, train, aux=None):
        w, b = wts
        # Theano's nnet.conv2d is true convolution (filter_flip=True):
        # it correlates with the spatially reversed kernel. Weights are
        # stored in the reference layout (checkpoints trained by either
        # framework transfer bit-for-bit), so reverse here. XLA folds the
        # reverse into the convolution's window; grads flow through it.
        w = w[:, :, ::-1, ::-1]
        f = self.filter_sz
        if self.mode == "valid":
            padding = [(0, 0), (0, 0)]
        else:  # 'full' and 'same' both run a full conv (convpool.py:53-56)
            padding = [(f - 1, f - 1), (f - 1, f - 1)]
        # f32 accumulation hint only in full precision: with bf16 operands the
        # tensor cores accumulate in f32 anyway, and a widened output dtype
        # breaks the conv transpose rule (bf16 operand x f32 cotangent).
        acc = {"preferred_element_type": jnp.float32} if x.dtype == jnp.float32 else {}
        out = jax.lax.conv_general_dilated(
            x,
            w,
            window_strides=(self.stride, self.stride),
            padding=padding,
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            **acc,
        )
        if self.mode == "same":
            shift = (f - 1) // 2
            out = out[:, :, shift : self.in_sz + shift, shift : self.in_sz + shift]
        act = activation_by_name(self.actvn)
        return act(out + b[None, :, None, None]).astype(x.dtype)


import functools


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def _maxpool(x, pool_sz, out_sz, ignore_border):
    return _maxpool_fwd_impl(x, pool_sz, out_sz, ignore_border)


def _maxpool_fwd_impl(x, p, out_sz, ignore_border):
    in_sz = x.shape[2]
    pad = (0, 0) if ignore_border else (0, out_sz * p - in_sz)
    return jax.lax.reduce_window(
        x,
        -jnp.inf,
        jax.lax.max,
        window_dimensions=(1, 1, p, p),
        window_strides=(1, 1, p, p),
        padding=[(0, 0), (0, 0), pad, pad],
    )


def _maxpool_fwd(x, p, out_sz, ignore_border):
    pooled = _maxpool_fwd_impl(x, p, out_sz, ignore_border)
    return pooled, (x, pooled)


def _maxpool_bwd(p, out_sz, ignore_border, res, g):
    # Theano tie semantics (pool.MaxPoolGrad): EVERY element equal to its
    # window max receives the full output gradient — XLA's native
    # select-and-scatter picks a single element, which diverges from the
    # reference on data with exact ties, e.g. MNIST's constant-background
    # patches.
    #
    # Shape choreography: window the input as (B, M, o, p, o, p) and let
    # the pooled/gradient tensors BROADCAST against it — XLA fuses the
    # compare+select into one pass over x, where materializing upsampled
    # copies (jnp.repeat) would cost ~3 extra full-tensor round trips.
    x, pooled = res
    in_sz = x.shape[2]
    full = out_sz * p
    if full > in_sz:
        # partial tail windows (ignore_border=False): pad with -inf, which
        # never equals a window max drawn from real values
        pw = (0, full - in_sz)
        xw = jnp.pad(x, ((0, 0), (0, 0), pw, pw),
                     constant_values=-jnp.inf)
    elif ignore_border and full < in_sz:
        # ignore_border drops the partial tail: those positions get no grad
        xw = x[:, :, :full, :full]
    else:
        xw = x
    b, m = x.shape[0], x.shape[1]
    r = xw.reshape(b, m, out_sz, p, out_sz, p)
    gw = jnp.where(
        r == pooled[:, :, :, None, :, None],
        g[:, :, :, None, :, None],
        jnp.zeros((), g.dtype),
    ).reshape(b, m, full, full)
    if full > in_sz:
        gw = gw[:, :, :in_sz, :in_sz]
    elif full < in_sz:
        gw = jnp.pad(gw, ((0, 0), (0, 0), (0, in_sz - full),
                          (0, in_sz - full)))
    return (gw.astype(x.dtype),)


_maxpool.defvjp(_maxpool_fwd, _maxpool_bwd)


class PoolLayer(Layer):
    """Max pooling (reference convpool.py:97-127). ignore_border=False keeps
    partial edge windows (output size = ceil(in/p)); True floors. The
    gradient routes to ALL tied maxima of a window (Theano semantics)."""

    def __init__(self, num_maps, in_sz, pool_sz, ignore_border=False):
        super().__init__()
        self.pool_sz = pool_sz
        self.ignore_border = ignore_border
        self.num_maps = num_maps
        self.in_sz = in_sz
        if ignore_border:
            self.out_sz = in_sz // pool_sz
        else:
            self.out_sz = math.ceil(in_sz / pool_sz)
        self.n_out = num_maps * self.out_sz**2
        self.representation = "Pool Maps:{:2d} Pool_sz:{} Border:{} Output:{:2d}".format(
            num_maps, pool_sz, "Ignore" if ignore_border else "Keep", self.out_sz
        )

    def apply(self, wts, x, *, key, train, aux=None):
        # Pool the ACTUAL tensor, like Theano's pool_2d, which never sees the
        # builder's size bookkeeping. When an upstream 'full'-mode conv's
        # in+f+1 quirk (ConvLayer, convpool.py:64) makes self.in_sz disagree
        # with x, the reference pools what arrives and fails loudly only if a
        # later layer consumes the bookkept size (e.g. a dense dot). Padding
        # to the bookkept size here instead would inject all--inf windows
        # (silent NaN training) or truncate real rows.
        in_sz = x.shape[2]
        if self.ignore_border:
            out_sz = in_sz // self.pool_sz
        else:
            out_sz = -(-in_sz // self.pool_sz)
        return _maxpool(x, self.pool_sz, out_sz, self.ignore_border)


class MeanLayer(Layer):
    """Global average pool over spatial dims (reference convpool.py:129-144)."""

    def __init__(self, num_maps, in_sz):
        super().__init__()
        self.num_maps = num_maps
        self.in_sz = in_sz
        self.out_sz = 1
        self.n_out = num_maps
        self.representation = "Mean Maps:{:2d} Output:{:2d}".format(
            num_maps, self.out_sz
        )

    def apply(self, wts, x, *, key, train, aux=None):
        return jnp.mean(x, axis=(2, 3))
