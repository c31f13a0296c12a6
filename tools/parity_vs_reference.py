#!/usr/bin/env python3
"""Side-by-side MNIST parity runner: theanet_tpu vs the Theano reference.

Runs the same .prms config (default: the reference's own params/mnist.prms)
through BOTH frameworks' training CLIs on the same SEED, parses each epoch
table, and prints epoch-wise test error side by side (plus a JSON artifact).

Requirements (by design this script runs where they exist — the build
environment has neither):
  * mnist.pkl.gz present (see theanet_tpu/data/mnist.py candidate dirs) —
    without it the theanet_tpu run hard-fails rather than faking MNIST.
  * the reference side additionally needs Theano importable; without it only
    the theanet_tpu column is produced.

Usage:
  python tools/parity_vs_reference.py [--prms PATH] [--epochs N]
      [--seed SEED] [--skip-reference] [--out parity.json]

Reference protocol being compared: train.py prints one row per test interval
'  EPOCH  COST  TR%  (AUX%)  TE%  (AUX%)' (reference train.py:191-206); both
CLIs emit it, so parity is checked at the user-visible surface.
"""

import argparse
import ast
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = "/root/reference"

ROW_RE = re.compile(
    r"^\s*(\d+)\s+([\d.]+)\s+([\d.]+)%\s+\(\s*([\d.]+)%\)\s+([\d.]+)%\s+\(\s*([\d.]+)%\)"
)


def rewrite_prms(src_path, seed, epochs, dst_path):
    """Copy a .prms with SEED pinned and NUM_EPOCHS optionally overridden."""
    with open(src_path) as f:
        spec = ast.literal_eval(f.read())
    spec["training_params"]["SEED"] = seed
    if epochs is not None:
        spec["training_params"]["NUM_EPOCHS"] = epochs
    with open(dst_path, "w") as f:
        f.write(repr(spec))
    return spec


def parse_epoch_table(text):
    rows = []
    for line in text.splitlines():
        m = ROW_RE.match(line)
        if m:
            rows.append({
                "epoch": int(m.group(1)),
                "cost": float(m.group(2)),
                "tr_err": float(m.group(3)),
                "te_err": float(m.group(5)),
            })
    return rows


def run_cli(cmd, cwd, env, label):
    print(f"[{label}] {' '.join(cmd)}", flush=True)
    proc = subprocess.run(cmd, cwd=cwd, env=env, text=True,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    rows = parse_epoch_table(proc.stdout)
    if proc.returncode != 0 or not rows:
        print(proc.stdout[-2000:])
        raise RuntimeError(f"{label} run failed (rc={proc.returncode}, "
                           f"{len(rows)} epoch rows parsed)")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--prms", default=os.path.join(REFERENCE, "params/mnist.prms"))
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--skip-reference", action="store_true")
    ap.add_argument("--out", default="parity.json")
    args = ap.parse_args()

    workdir = tempfile.mkdtemp(prefix="parity_")
    prms = os.path.join(workdir, "parity.prms")
    rewrite_prms(args.prms, args.seed, args.epochs, prms)

    # --- theanet_tpu run (hard-fails if real MNIST is absent)
    env = dict(os.environ)
    # PREPEND, keeping whatever the caller's PYTHONPATH already provides
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("THEANET_ALLOW_SYNTH_FALLBACK", None)
    ours = run_cli([sys.executable, os.path.join(REPO, "train.py"),
                    "mnist", prms], workdir, env, "theanet_tpu")

    # --- reference run (needs Theano)
    theirs = None
    if not args.skip_reference:
        try:
            import importlib.util
            has_theano = importlib.util.find_spec("theano") is not None
        except Exception:
            has_theano = False
        if not has_theano:
            print("Theano not importable here — reference column skipped "
                  "(rerun where Theano exists, or pass --skip-reference to "
                  "silence this).")
        else:
            env_ref = dict(os.environ)
            env_ref["PYTHONPATH"] = (
                REFERENCE + os.pathsep + env_ref.get("PYTHONPATH", ""))
            theirs = run_cli([sys.executable,
                              os.path.join(REFERENCE, "train.py"),
                              "mnist", prms], REFERENCE, env_ref, "reference")

    # --- report
    print(f"\nEpoch-wise test error, SEED {args.seed} ({args.prms}):")
    print(f"{'epoch':>6} {'jax te%':>9} {'theano te%':>11} {'delta':>7}")
    by_epoch = {r["epoch"]: r for r in (theirs or [])}
    for r in ours:
        t = by_epoch.get(r["epoch"])
        t_err = f"{t['te_err']:.2f}" if t else "-"
        delta = f"{r['te_err'] - t['te_err']:+.2f}" if t else "-"
        print(f"{r['epoch']:>6} {r['te_err']:>9.2f} {t_err:>11} {delta:>7}")

    with open(args.out, "w") as f:
        json.dump({"prms": args.prms, "seed": args.seed,
                   "theanet_tpu": ours, "reference": theirs}, f, indent=1)
    print(f"\nwrote {args.out}")


if __name__ == "__main__":
    main()
