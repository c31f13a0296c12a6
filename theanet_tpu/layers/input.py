"""Input-stage layers: InputLayer, ElasticLayer, ColorLayer.

Capability parity with reference theanet/layer/inlayers.py and
theanet/layer/color.py: augmentation is still a layer of the compiled step
(no host round-trip), but randomness comes from explicit jax PRNG keys and the
resample is one matrix product or gather (see theanet_tpu.ops.elastic).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..inits import consume_stream_seed
from ..ops.elastic import ElasticConfig, elastic_augment
from .base import Layer

__all__ = ["InputLayer", "ElasticLayer", "ColorLayer"]


class InputLayer(Layer):
    """Identity pass-through (reference inlayers.py:12-26)."""

    def __init__(self, img_sz, num_maps=1, rand_gen=None):
        super().__init__()
        self.out_sz = img_sz
        self.num_maps = num_maps
        self.n_out = num_maps * img_sz**2
        self.representation = (
            "Input Maps:{} Sizes Input:{:2d} Output:{:2d}".format(
                num_maps, img_sz, img_sz
            )
        )

    def apply(self, wts, x, *, key, train, aux=None):
        return x


class ElasticLayer(Layer):
    """On-device augmentation layer (reference inlayers.py:29-163).

    One warp per batch; eval mode keeps only invert/nearest (TestVersion
    semantics, inlayers.py:157-163).
    """

    def __init__(
        self,
        img_sz,
        num_maps=1,
        translation=0,
        zoom=1,
        magnitude=0,
        sigma=1,
        pflip=0,
        angle=0,
        rand_gen=None,
        invert_image=False,
        nearest=False,
        method="gather",
    ):
        super().__init__()
        assert zoom > 0
        self.cfg = ElasticConfig(
            img_sz=img_sz,
            translation=translation,
            zoom=zoom,
            magnitude=magnitude,
            sigma=sigma,
            pflip=pflip,
            angle=angle,
            invert_image=invert_image,
            nearest=nearest,
        )
        # 'auto' was the default's name in older configs and checkpoints;
        # it chose the gather on the GPU, which is now the default.
        self.method = "gather" if method == "auto" else method
        self.out_sz = img_sz
        self.num_maps = num_maps
        self.n_out = num_maps * img_sz**2
        # Consume the RandomStreams seed draw in reference order
        # (inlayers.py:72-73) — only when augmentation is actually active.
        self.stream_seed = (
            0 if self.cfg.is_identity else consume_stream_seed(rand_gen)
        )
        self.representation = (
            "Elastic Maps:{:d} Size:{:2d} Translation:{} Zoom:{} Mag:{:d} "
            "Sig:{:d} Noise:{} Angle:{} Invert:{} Interpolation:{}".format(
                num_maps,
                img_sz,
                translation,
                zoom,
                magnitude,
                sigma,
                pflip,
                angle,
                invert_image,
                "Nearest" if nearest else "Linear",
            )
        )

    def apply(self, wts, x, *, key, train, aux=None):
        key = jax.random.fold_in(key, self.stream_seed)
        out, _ = elastic_augment(
            key, x, self.cfg, train=train, method=self.method
        )
        return out.astype(x.dtype)

    def debug_apply(self, x, key):
        """Augment with debug outputs (displacement field + sampled randoms),
        the reference's ``debugout`` hook (inlayers.py:145-155) used by the
        augmentation visualizer."""
        key = jax.random.fold_in(key, self.stream_seed)
        return elastic_augment(
            key, x, self.cfg, train=True, method=self.method, with_debug=True
        )


class ColorLayer(Layer):
    """Per-sample per-channel photometric jitter (reference color.py:9-52).

    x -> x/maxval; random white-balance exp(ln b * U(-1,1)); clip to [0,1];
    gamma curve x^g1 then inverse-gamma 1-(1-x)^g2 with independent draws;
    eval mode is the identity.
    """

    def __init__(
        self, img_sz, num_maps=3, rand_gen=None, balance=1, gamma=1, maxval=1
    ):
        super().__init__()
        self.out_sz = img_sz
        self.num_maps = num_maps
        self.n_out = num_maps * img_sz**2
        self.balance = balance
        self.gamma = gamma
        self.maxval = maxval
        self.identity = gamma == 1 and balance == 1
        if not self.identity:
            assert gamma > 0 and balance > 0
            self.stream_seed = consume_stream_seed(rand_gen)
        else:
            self.stream_seed = 0
        self.representation = (
            "Color Maps:{} Size:{:2d} Balance:{:.2f} Gamma:{:.2f} "
            "Maxval:{}".format(num_maps, img_sz, balance, gamma, maxval)
        )

    def apply(self, wts, x, *, key, train, aux=None):
        if self.identity or not train:
            return x
        key = jax.random.fold_in(key, self.stream_seed)
        kb, kg1, kg2 = jax.random.split(key, 3)
        b = x.shape[0]

        def pos_rand(k, a):
            u = jax.random.uniform(
                k, (b, self.num_maps), minval=-1.0, maxval=1.0
            )
            return jnp.exp(jnp.log(a) * u)[:, :, None, None].astype(x.dtype)

        out = x / self.maxval
        out = out * pos_rand(kb, self.balance)
        out = jnp.clip(out, 0.0, 1.0)
        out = out ** pos_rand(kg1, self.gamma)
        out = 1.0 - (1.0 - out) ** pos_rand(kg2, self.gamma)
        return out * self.maxval
