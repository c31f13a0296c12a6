#!/usr/bin/env python3
"""Smoke test of the trainer on the GPU: the quickest proof that the system
still starts on the card.

    python chip_smoke.py           # one card: phases (a)-(d)
    python chip_smoke.py --four    # four cards: phase (a) and the mesh phase

Phases:
  (a) the device is a GPU; print the card's name and power limit;
  (b) the training CLI (``theanet_tpu.train.main``) runs the flagship config
      params/mnist_cnn.prms at its published widths on the offline ``synth``
      corpus for 2 epochs, then resumes from the checkpoint for one more;
      the cost must be finite and fall;
  (c) every other shipped config trains one epoch on its offline dataset,
      with a finite cost and exactly one checkpoint written;
  (d) the scanned train step at the flagship's widths (augmentation and
      dropout off, 20 steps) against the float64 plain reference
      (tests/plain_reference.py): within 1e-4 under
      ``jax.default_matmul_precision("highest")``; the deviation at the
      default precision is printed, not gated;
  (e) with --four only: the GSPMD data-parallel 4x1 and DP x TP 2x2 meshes
      against a single-card trajectory, 1e-4 gate.

Any failed phase exits non-zero before the result line. The last line of
standard output is one JSON object naming the device JAX reports.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import glob
import io
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Offline dataset of each shipped config (MNIST needs a download).
DATASETS = {
    "mnist_cnn": "synth",
    "flat_mlp": "synth",
    "galaxy_rbf": "synth3",
    "logit_centered": "synth",
    "synth_aux": "synth_aux",
    "synth_quick": "synth",
}
GATE = 1e-4
_ROW = re.compile(r"^\s*(\d+)\s+(\S+)\s{4}\s*\d")


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


class _Tee(io.TextIOBase):
    def __init__(self, stream):
        self.stream, self.buf = stream, io.StringIO()

    def write(self, text):
        self.buf.write(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def run_cli(dataset, cfg_path):
    """Run the training CLI in-process; returns (epoch rows as (epoch,
    cost), stderr text). The CLI replaces sys.stdout; it is restored."""
    from theanet_tpu import train as cli

    out, err = _Tee(sys.stdout), _Tee(sys.stderr)
    saved = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = out, err
    try:
        cli.main(["train.py", dataset, cfg_path])
    finally:
        sys.stdout.flush()
        sys.stdout, sys.stderr = saved
    rows = [(int(m.group(1)), float(m.group(2)))
            for m in map(_ROW.match, out.buf.getvalue().splitlines()) if m]
    check(len(rows) >= 2, f"{cfg_path}: no epoch table in the CLI output")
    # the last row is the final full-set eval, whose cost column is 0.00
    return rows[:-1], err.buf.getvalue()


def write_cfg(name, dst, **training_params):
    with open(os.path.join(ROOT, "params", name + ".prms")) as f:
        cfg = ast.literal_eval(f.read())
    cfg["training_params"].update(training_params)
    with open(dst, "w") as f:
        f.write(repr(cfg))


def _rates(err_text):
    return [line.strip() for line in err_text.splitlines()
            if "images/sec" in line]


def phase_cli():
    """(b) flagship through the CLI: 2 epochs, then resume for one more."""
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        write_cfg("mnist_cnn", "mnist_cnn.prms", NUM_EPOCHS=2, SEED=555)
        rows, err = run_cli("synth", "mnist_cnn.prms")
        pkls = glob.glob("*.pkl")
        check(len(pkls) == 1, f"expected one checkpoint, found {pkls}")
        with open(pkls[0], "rb") as f:
            ck = pickle.load(f)
        check(ck["training_params"]["CUR_EPOCH"] == 2,
              f"checkpoint at epoch {ck['training_params']['CUR_EPOCH']}")
        ck["training_params"]["NUM_EPOCHS"] = 1
        with open(pkls[0], "wb") as f:
            pickle.dump(ck, f, -1)
        rows2, err2 = run_cli("synth", pkls[0])
    costs = [c for _, c in rows + rows2]
    check(all(map(_finite, costs)), f"non-finite epoch cost: {costs}")
    check([e for e, _ in rows2] == [2], f"resume rows {rows2}")
    check(costs[-1] < costs[0], f"cost did not fall: {costs}")
    print(f"[b] flagship CLI: epoch costs {costs} (epoch 2 resumed from "
          "the checkpoint)")
    for line in _rates(err) + _rates(err2):
        print(f"[b] {line}")


def phase_configs():
    """(c) every other shipped config: one epoch, one checkpoint."""
    names = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(os.path.join(ROOT, "params", "*.prms")))
    check(set(names) == set(DATASETS),
          f"configs {names} vs dataset table {sorted(DATASETS)}")
    for name in names:
        if name == "mnist_cnn":
            continue
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
            write_cfg(name, name + ".prms", NUM_EPOCHS=1)
            rows, err = run_cli(DATASETS[name], name + ".prms")
            pkls = glob.glob("*.pkl")
        check(len(pkls) == 1, f"{name}: expected one checkpoint, got {pkls}")
        check(all(_finite(c) for _, c in rows), f"{name}: costs {rows}")
        print(f"[c] {name} on {DATASETS[name]}: epoch costs "
              f"{[c for _, c in rows]}; {'; '.join(_rates(err))}")


def _finite(v):
    return v == v and abs(v) != float("inf")


def flagship_plain():
    """params/mnist_cnn.prms at its published widths with augmentation and
    dropout off (the inversion stays: it is part of the eval path too)."""
    with open(os.path.join(ROOT, "params", "mnist_cnn.prms")) as f:
        cfg = ast.literal_eval(f.read())
    layers = [[n, dict(kw)] for n, kw in cfg["layers"]]
    layers[0] = ["ElasticLayer", {"img_sz": 28, "invert_image": True}]
    for _, kw in layers:
        if "pdrop" in kw:
            kw["pdrop"] = 0
    tp = dict(cfg["training_params"], SEED=555)
    return layers, tp


def reference_gap(n_steps=20):
    """Train the flagship (plain variant) n_steps on the card under
    'highest' and under the default precision, and the float64 reference
    from the same weights. Returns the largest relative gaps per precision:
    |a - b| / max(|b|, 1) over step costs and over end-state weights."""
    import copy

    import numpy as np
    import jax

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import plain_reference
    from theanet_tpu.model import NeuralNet
    from theanet_tpu.trainer import Trainer

    layers, tp = flagship_plain()
    bsz = tp["BATCH_SZ"]
    # Uniform random pixels, not the synth corpus: its constant background
    # makes exact ties in the max pools, and which elements tie (each gets
    # the full gradient) then hangs on the last bit of float32 rounding.
    rng = np.random.RandomState(0)
    x = rng.rand(n_steps * bsz, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, n_steps * bsz).astype(np.int32)

    def run():
        net = NeuralNet(copy.deepcopy(layers), dict(tp))
        tr = Trainer(net, x, y, x[:bsz], y[:bsz])
        _, costs, _ = tr.run_epoch()
        return net, costs, [[np.asarray(w) for w in lp] for lp in tr.params]

    with jax.default_matmul_precision("highest"):
        net, costs_hi, params_hi = run()
    _, costs_def, params_def = run()
    ref_costs, ref_params, _ = plain_reference.train(
        layers, net.allwts0, x.reshape(n_steps, bsz, 1, 28, 28),
        y.reshape(n_steps, bsz), net.get_rate())

    def gaps(costs, params):
        c = max(abs(a - b) / max(abs(b), 1.0)
                for a, b in zip(costs, ref_costs))
        w = max(float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                                     1.0)
                for la, lb in zip(params, ref_params)
                for a, b in zip(la, lb) if b.size)
        return c, w

    return {"highest": gaps(costs_hi, params_hi),
            "default": gaps(costs_def, params_def),
            "steps": len(ref_costs)}


def phase_reference():
    """(d) scanned path vs the plain reference at the flagship's widths."""
    g = reference_gap()
    (c_hi, w_hi), (c_def, w_def) = g["highest"], g["default"]
    print(f"[d] flagship vs float64 reference, {g['steps']} steps: "
          f"precision=highest max cost gap {c_hi:.3e}, max weight gap "
          f"{w_hi:.3e} (gate {GATE:g}); default precision max cost gap "
          f"{c_def:.3e}, max weight gap {w_def:.3e} (not gated)")
    check(c_hi < GATE and w_hi < GATE,
          f"scanned path off the plain reference under 'highest': "
          f"cost {c_hi:.3e}, weights {w_hi:.3e}")


def phase_mesh():
    """(e) GSPMD 4x1 and 2x2 meshes against one card."""
    import jax
    import numpy as np

    sys.path.insert(0, ROOT)
    import __graft_entry__ as g

    check(len(jax.devices()) >= 4,
          f"--four needs four cards, JAX sees {len(jax.devices())}")
    # random pixels for the same reason as in (d): no exact pooling ties
    rng = np.random.RandomState(0)
    x = rng.rand(400, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 400).astype(np.int32)
    for n_data, n_model in ((4, 1), (2, 2)):
        t0 = time.time()
        # 'highest' keeps the comparison about the collectives, not about
        # how each side's products were rounded
        with jax.default_matmul_precision("highest"):
            gap = g.mesh_vs_single_device(
                n_data, n_model, x, y, batch_sz=20,
                hidden=512, gate=GATE)
        print(f"[e] mesh {n_data}x{n_model} (data x model) vs one card, 2 "
              f"epochs of {len(x) // 20} steps: max step-cost gap "
              f"{gap['max_rel']:.3e}, max end-weight gap "
              f"{gap['max_w_delta']:.3e} (gate {GATE:g}), "
              f"{time.time() - t0:.1f}s")


def phases(four):
    """The phases after (a): the mesh phase alone with --four, else (b)-(d)."""
    return [phase_mesh] if four else [phase_cli, phase_configs,
                                      phase_reference]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    import jax

    from theanet_tpu.compile_cache import enable

    enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r}); "
              "nothing to report", file=sys.stderr)
        return 1
    print(f"[a] device: {dev.platform} {dev.device_kind} x "
          f"{len(jax.devices())}")
    print(card_line())
    for phase in phases(args.four):
        t0 = time.time()
        try:
            phase()
        except PhaseFailed as e:
            print(f"chip_smoke: {phase.__name__} failed: {e}",
                  file=sys.stderr)
            return 1
        print(f"[{phase.__name__}] OK in {time.time() - t0:.1f}s",
              flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
