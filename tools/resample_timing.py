#!/usr/bin/env python3
"""Time the elastic resample's matmul and gather forms inside a train step.

    python tools/resample_timing.py [--sizes 28,64] [--epochs 8] [--steps 500]

For each image size and each interpolation mode (nearest, bilinear) it
builds the flagship net (params/mnist_cnn.prms widths: elastic -> conv4 ->
pool2 -> conv20 -> pool2 -> hidden500 -> softmax10, batch 20) with
``ElasticLayer(method='matmul')`` and ``method='gather'``, compiles both,
and then runs scanned epochs of ``--steps`` batches in turns (matmul,
gather, matmul, ...), each epoch ending in a host sync. It prints the us
per step of every epoch and the medians beside the card's name and power
limit; the last line of standard output is one JSON object. The resample's
default form (``ops.elastic.resample``) is chosen from this timing.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402

METHODS = ("matmul", "gather")


def time_methods(img, nearest, epochs, steps, batch_sz=20):
    """{method: [us per step of each epoch]} for one size and mode."""
    from theanet_tpu.trainer import Trainer

    rng = np.random.RandomState(0)
    n = steps * batch_sz
    x = rng.rand(n, 1, img, img).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.int32)
    trainers = {}
    for m in METHODS:
        tr = Trainer(bench.flagship_net(batch_sz, img, nearest, m), x, y,
                     x[:5 * batch_sz], y[:5 * batch_sz])
        tr.run_epoch()  # compile
        trainers[m] = tr
    out = {m: [] for m in METHODS}
    for _ in range(epochs):
        for m in METHODS:
            t0 = time.perf_counter()
            total, _, _ = trainers[m].run_epoch()
            out[m].append((time.perf_counter() - t0) / steps * 1e6)
            if not np.isfinite(total):
                raise SystemExit(f"{m} at {img}x{img}: non-finite cost")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="28,64")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--steps", type=int, default=500)
    args = ap.parse_args(argv)

    from theanet_tpu.compile_cache import enable

    dev = bench.require_gpu()
    tag = bench.card()
    enable()
    rows = []
    for img in (int(s) for s in args.sizes.split(",")):
        for nearest in (True, False):
            us = time_methods(img, nearest, args.epochs, args.steps)
            med = {m: float(np.median(v)) for m, v in us.items()}
            mode = "nearest" if nearest else "bilinear"
            for m in METHODS:
                print(f"[{tag}] {img}x{img} {mode} {m}: median "
                      f"{med[m]:.1f} us/step (epochs "
                      f"{[round(v, 1) for v in us[m]]})", flush=True)
            rows.append({"img": img, "mode": mode, "median_us": med,
                         "us_per_step": us})
    print(json.dumps({"card": tag, "rows": rows,
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind}}))


if __name__ == "__main__":
    main()
