#!/usr/bin/env python3
"""Benchmark: training throughput on the GPU (aug + fwd + bwd + update).

    python bench.py            # the flagship config, batch 20
    python bench.py --wide     # a wide bf16 conv/dense stack
    python bench.py --flat | --deep | --heads | --serve

The flagship is the reference's headline config (params/mnist_cnn.prms
architecture: full elastic augmentation -> conv4@3x3 -> pool2 -> conv20@3x3
-> pool2 -> hidden500(drop .5) -> softmax10, batch 20) on a 60,000-image
epoch, the size of the reference's MNIST epoch.

Everything is measured in this one process: JAX reserves most of the card's
memory for the process that opens it first, so a second process could not
use it. Each rate is the median of its repetitions and is printed beside
the card's name and power limit. The script refuses to run on anything but
a GPU, and takes peak rates from PEAKS by ``device_kind``; a kind missing
there is an error. The last line of standard output is one JSON object.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# Published dense peaks (FLOP/s) by JAX device_kind, and the power limit
# ("watts") they hold at. Source: NVIDIA H100 Tensor Core GPU data sheet,
# SXM part, without sparsity. A card set to a lower limit cannot reach
# them, so every peak share is printed beside both limits.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12,
                              "watts": 700},
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def peaks(kind):
    """Peak rates of a device kind; an unknown kind is an error."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peak rates for device_kind {kind!r}: add them to "
            "bench.PEAKS with their source") from None


def card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def peak_note(pk, tag):
    """Names the limit a peak holds at beside the card's own (``tag`` is
    card()'s line: name, power limit)."""
    return (f"(peak at the {pk['watts']} W limit; this card: "
            f"{tag.split(',')[-1].strip()})")


def require_gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found {dev.platform!r}")
    return dev


def flagship_net(batch_sz, img=28, nearest=True, method="gather"):
    """The flagship net; ``img``, ``nearest`` and the resample ``method``
    vary only for tools/resample_timing.py."""
    from theanet_tpu.model import NeuralNet

    layers = [
        ["ElasticLayer", {"img_sz": img, "translation": 2, "zoom": 1.1,
                          "magnitude": 60, "sigma": 15, "pflip": 0.03,
                          "angle": 5, "nearest": nearest,
                          "invert_image": True, "method": method}],
        ["ConvLayer", {"num_maps": 4, "filter_sz": 3, "stride": 1, "actvn": "relu10"}],
        ["PoolLayer", {"pool_sz": 2}],
        ["ConvLayer", {"num_maps": 20, "filter_sz": 3, "stride": 1, "actvn": "relu05"}],
        ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 500, "pdrop": 0.5, "reg": {"L2": 0.0, "maxnorm": 0}}],
        ["SoftmaxLayer", {"n_out": 10, "reg": {"L2": 0.0, "maxnorm": 0}}],
    ]
    tr_prms = {"SEED": 555, "BATCH_SZ": batch_sz, "NUM_EPOCHS": 1,
               "EPOCHS_TO_TEST": 1, "TEST_SAMP_SZ": 100,
               "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 1}
    return NeuralNet(layers, tr_prms)


def model_mflops_per_image():
    """Model FLOPs per image of the flagship: the conv and dense products,
    forward x3 for forward + backward."""
    fwd = (4 * 9 * 26 * 26        # conv1
           + 20 * 4 * 9 * 11 * 11  # conv2
           + 720 * 500 + 500 * 10)  # dense tail
    return 3 * 2 * fwd / 1e6


def _count_ops(body):
    import re

    n = 0
    for line in body.splitlines():
        mm = re.search(r"=\s+\S+\s+([\w-]+)\(", line)
        if mm and mm.group(1) not in (
            "parameter", "constant", "tuple", "get-tuple-element", "bitcast"
        ):
            n += 1
    return n


def census(compiled_text):
    """(entry_ops, per_step_ops) from optimized HLO: entry = ops per
    program invocation; per_step = ops in the largest loop-body computation
    (the scanned step)."""
    import re

    m = re.search(r"ENTRY [^\{]*\{(.*?)^\}", compiled_text, re.S | re.M)
    entry = _count_ops(m.group(1)) if m else -1
    bodies = re.findall(r"^%?[\w.-]*(?:body|region)[\w.-]* [^\n]*\{(.*?)^\}",
                        compiled_text, re.M | re.S)
    per_step = max((_count_ops(b) for b in bodies), default=0)
    return entry, per_step


def epoch_rates(tr, n_imgs, reps):
    """images/s of ``reps`` single epochs (each ends in a host sync)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        tr.run_epoch()
        out.append(n_imgs / (time.perf_counter() - t0))
    return out


def _compiled_epoch(tr, name, tag):
    t0 = time.perf_counter()
    tr.run_epoch()
    log(f"[{tag}] {name}: compile + first epoch "
        f"{time.perf_counter() - t0:.1f}s")


def measure(batch_sz, n_batches, reps, tag):
    import jax.numpy as jnp
    from theanet_tpu.trainer import Trainer

    rng = np.random.RandomState(0)
    n = n_batches * batch_sz
    x = rng.rand(n, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.int32)
    net = flagship_net(batch_sz)
    tr = Trainer(net, x, y, x[: 5 * batch_sz], y[: 5 * batch_sz])
    np.asarray(tr.d_train_x[0, 0, 0, :1])  # the upload is async: sync it
    _compiled_epoch(tr, f"flagship batch {batch_sz}", tag)
    ips = epoch_rates(tr, n, reps)
    med = float(np.median(ips))
    log(f"[{tag}] flagship batch {batch_sz}: median {med:,.0f} images/s "
        f"over {reps} epochs of {n:,} (reps {[round(v) for v in ips]})")

    # k epochs dispatched back-to-back with ONE final sync
    tr.run_epochs(reps)  # compiles the stacked watchdog pull
    chained = []
    for _ in range(3):
        t0 = time.perf_counter()
        tr.run_epochs(reps)
        chained.append(reps * n / (time.perf_counter() - t0))
    med_chained = float(np.median(chained))
    log(f"[{tag}] flagship batch {batch_sz}, {reps} chained epochs: median "
        f"{med_chained:,.0f} images/s")

    lowered = tr._train_epoch.lower(
        tr.params, tr.moms, tr.d_train_x, tr.d_train_y, tr.d_train_aux,
        jnp.int32(0), jnp.float32(0.1), net.base_key,
    )
    entry_ops, step_ops = census(lowered.compile().as_text())
    log(f"[{tag}] ops per scanned step: {step_ops} ({entry_ops} entry ops)")
    return {"median": med, "reps": ips, "chained": med_chained,
            "ops_per_step": step_ops}


def main():
    import jax

    from theanet_tpu.compile_cache import enable

    dev = require_gpu()
    pk = peaks(dev.device_kind)
    tag = card()
    enable()
    res = measure(20, 3000, 5, tag)
    flops = model_mflops_per_image() * 1e6 * res["median"]
    log(f"[{tag}] model work {model_mflops_per_image():.1f} MFLOP/image -> "
        f"{flops / 1e9:.1f} GFLOP/s, {100 * flops / pk['tf32']:.3f}% of the "
        f"TF32 peak {peak_note(pk, tag)} (float32 products run in TF32 by "
        "default)")
    print(json.dumps({
        "metric": "MNIST-CNN train images/sec/chip "
                  "(elastic aug + fwd + bwd, batch 20)",
        "value": res["median"],
        "unit": "images/sec",
        "reps": res["reps"],
        "value_chained_epochs": res["chained"],
        "ops_per_step": res["ops_per_step"],
        "tf32_peak_share": flops / pk["tf32"],
        "peak_power_limit_w": pk["watts"],
        "card": tag,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


def _row(name, net, channels, n, tag, img=28, nc=10, reps=3):
    from theanet_tpu.trainer import Trainer

    rng = np.random.RandomState(0)
    x = rng.rand(n, channels, img, img).astype(np.float32)
    y = rng.randint(0, nc, n).astype(np.int32)
    tr = Trainer(net, x, y, x[:100], y[:100])
    _compiled_epoch(tr, name, tag)
    med = float(np.median(epoch_rates(tr, n, reps)))
    log(f"[{tag}] {name}: median {med:,.0f} images/s")
    return med


def wide_model_row():
    """A wide conv/dense stack (bf16) where the model, not per-op overhead,
    sets the ceiling, reported against the bf16 peak."""
    from theanet_tpu.model import NeuralNet

    dev = require_gpu()
    tag = card()
    B, IMG = 256, 56
    layers = [
        ["InputLayer", {"img_sz": IMG}],
        ["ConvLayer", {"num_maps": 64, "filter_sz": 3, "stride": 1,
                       "actvn": "relu10"}],
        ["PoolLayer", {"pool_sz": 2}],
        ["ConvLayer", {"num_maps": 128, "filter_sz": 3, "stride": 1,
                       "actvn": "relu05"}],
        ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 2048, "pdrop": 0.5}],
        ["SoftmaxLayer", {"n_out": 1000}],
    ]
    tr_prms = {"SEED": 7, "BATCH_SZ": B, "NUM_EPOCHS": 1,
               "EPOCHS_TO_TEST": 1, "TEST_SAMP_SZ": B,
               "INIT_LEARNING_RATE": 0.05, "EPOCHS_TO_HALF_RATE": 2,
               "COMPUTE_DTYPE": "bfloat16"}
    # model MACs/image (conv1, conv2, dense tail), forward x3 for backward
    c1s, p1s = IMG - 2, (IMG - 2 + 1) // 2
    c2s, p2s = p1s - 2, (p1s - 2 + 1) // 2
    macs = (64 * 9 * c1s ** 2 + 128 * 64 * 9 * c2s ** 2
            + 128 * p2s ** 2 * 2048 + 2048 * 1000)
    med = _row(f"wide conv64+conv128+hidden2048+softmax1000 @ {IMG}x{IMG} "
               f"batch {B} bf16", NeuralNet(layers, tr_prms), 1, 80 * B, tag,
               img=IMG, nc=1000)
    pk = peaks(dev.device_kind)
    share = 2 * macs * 3 * med / pk["bf16"]
    log(f"[{tag}] wide: {100 * share:.2f}% of the bf16 peak "
        f"{peak_note(pk, tag)}")


def _elastic():
    return ["ElasticLayer", {"img_sz": 28, "translation": 2, "zoom": 1.1,
                             "magnitude": 60, "sigma": 15, "pflip": 0.03,
                             "angle": 5, "nearest": True,
                             "invert_image": True}]


def _prms(**kw):
    tp = {"SEED": 555, "BATCH_SZ": 20, "NUM_EPOCHS": 1, "EPOCHS_TO_TEST": 1,
          "TEST_SAMP_SZ": 100, "INIT_LEARNING_RATE": 0.1,
          "EPOCHS_TO_HALF_RATE": 1}
    tp.update(kw)
    return tp


def flat_mlp_row():
    """The reference's params/3flat.prms pattern (elastic -> hidden1000 ->
    softmax, batch 20)."""
    from theanet_tpu.model import NeuralNet

    require_gpu()
    layers = [_elastic(),
              ["HiddenLayer", {"n_out": 1000, "pdrop": 0.5, "actvn": "relu10",
                               "reg": {"L2": 0.001, "maxnorm": 0}}],
              ["SoftmaxLayer", {"n_out": 10}]]
    _row("flat elastic->hidden1000->softmax batch 20",
         NeuralNet(layers, _prms(INIT_LEARNING_RATE=0.3)), 1, 60000, card())


def deep_row():
    """A 3-conv elastic stack at batch 20."""
    from theanet_tpu.model import NeuralNet

    require_gpu()
    layers = [_elastic()]
    for m, act in ((4, "relu10"), (8, "relu05"), (16, "relu05")):
        layers += [["ConvLayer", {"num_maps": m, "filter_sz": 3, "stride": 1,
                                  "actvn": act}],
                   ["PoolLayer", {"pool_sz": 2}]]
    layers += [["HiddenLayer", {"n_out": 200, "pdrop": 0.5}],
               ["SoftmaxLayer", {"n_out": 10}]]
    _row("deep elastic->conv4->conv8->conv16->hidden200->softmax10 batch 20",
         NeuralNet(layers, _prms()), 1, 60000, card())


def heads_row():
    """Centred heads: LOGIT (frozen centres), RBF (learned centres), and the
    shipped galaxy_rbf.prms pipeline (colour + elastic + 2 conv + dropout +
    RBF)."""
    import ast

    from theanet_tpu.model import NeuralNet

    require_gpu()
    tag = card()

    def centered(kind, learn):
        layers = [
            ["InputLayer", {"img_sz": 28}],
            ["ConvLayer", {"num_maps": 6, "filter_sz": 5, "stride": 1,
                           "actvn": "relu10"}],
            ["PoolLayer", {"pool_sz": 2}],
            ["HiddenLayer", {"n_out": 64, "pdrop": 0.25}],
            ["CenteredOutLayer", {"n_features": 24, "n_classes": 10,
                                  "kind": kind, "learn_centers": learn,
                                  "junk_dist": 50.0}],
        ]
        return NeuralNet(layers, _prms(SEED=424242, INIT_LEARNING_RATE=0.05,
                                       EPOCHS_TO_HALF_RATE=2))

    _row("LOGIT frozen centres", centered("LOGIT", False), 1, 60000, tag)
    _row("RBF learned centres", centered("RBF", True), 1, 60000, tag)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "params", "galaxy_rbf.prms")) as f:
        cfg = ast.literal_eval(f.read())
    layers = [list(l) for l in cfg["layers"]]
    layers[0] = [layers[0][0], dict(layers[0][1], img_sz=28, num_maps=3)]
    tp = dict(cfg["training_params"], SEED=99, NUM_EPOCHS=1,
              TEST_SAMP_SZ=100)
    _row("galaxy_rbf.prms", NeuralNet(layers, tp), 3, 60000, tag)


def serve_row():
    """Serving path (reference get_data_test_model, neuralnet.py:282-296):
    jitted batch-1 predict on the flagship net — per-call round-trip
    latency and pipelined throughput (N dispatches, one sync) — and the
    batch-256 bulk-scoring shape."""
    import jax
    import jax.numpy as jnp
    from theanet_tpu.trainer import Trainer

    require_gpu()
    tag = card()
    net = flagship_net(1)
    rng = np.random.RandomState(0)
    x = rng.rand(8, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.int32)
    tr = Trainer(net, x, y, x, y)
    fn = jax.jit(lambda p, xi: net.predict(p, xi))
    xi = jnp.asarray(x[:1])
    np.asarray(fn(tr.params, xi)[1])  # compile
    lats = []
    for _ in range(50):
        t0 = time.perf_counter()
        np.asarray(fn(tr.params, xi)[1])
        lats.append((time.perf_counter() - t0) * 1e3)
    n_pipe = 200
    t0 = time.perf_counter()
    outs = [fn(tr.params, xi)[1] for _ in range(n_pipe)]
    np.asarray(outs[-1])
    pipe = n_pipe / (time.perf_counter() - t0)
    log(f"[{tag}] batch-1 predict: p50 {np.percentile(lats, 50):.3f} ms / "
        f"p90 {np.percentile(lats, 90):.3f} ms round trip; pipelined "
        f"{pipe:,.0f} req/s")

    bserve = 256
    netb = flagship_net(bserve)
    xb = jnp.asarray(rng.rand(bserve, 1, 28, 28).astype(np.float32))
    fnb = jax.jit(lambda p, xi: netb.predict(p, xi))
    np.asarray(fnb(tr.params, xb)[1])  # compile
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [fnb(tr.params, xb)[1] for _ in range(100)]
        np.asarray(outs[-1])
        rates.append(100 * bserve / (time.perf_counter() - t0))
    log(f"[{tag}] batch-{bserve} predict pipelined: median "
        f"{np.median(rates):,.0f} images/s")


ROWS = {"--wide": wide_model_row, "--flat": flat_mlp_row,
        "--deep": deep_row, "--heads": heads_row, "--serve": serve_row}

if __name__ == "__main__":
    if len(sys.argv) > 1:
        if sys.argv[1] not in ROWS:
            sys.exit(f"usage: bench.py [{' | '.join(ROWS)}]")
        from theanet_tpu.compile_cache import enable

        enable()
        ROWS[sys.argv[1]]()
    else:
        main()
