"""MNIST data module (contract parity with reference data/mnist.py:21-54).

Exports module-level ``training_x, training_y, testing_x, testing_y`` with
train+valid merged into a 60k (N, 1, 28, 28) training set, loaded on the
first access of one of them (importing the module reads and fetches
nothing). Looks for a local ``mnist.pkl.gz`` (same file the reference
downloads) in several places before attempting a download.

When the file is missing and cannot be downloaded, loading FAILS by default:
a run labeled "mnist" must never silently train on non-MNIST data (accuracy
numbers would be meaningless as parity evidence). Set
``THEANET_ALLOW_SYNTH_FALLBACK=1`` to opt in to the deterministic synthetic
digit fallback for offline smoke runs.
"""

from __future__ import annotations

import gzip
import os
import pickle

import numpy as np

_CANDIDATE_DIRS = [
    os.path.dirname(os.path.abspath(__file__)),
    os.environ.get("THEANET_DATA_DIR", ""),
    os.path.expanduser("~/.cache/theanet_tpu"),
    "/root/reference/data",
]
_ORIGIN = "http://www.iro.umontreal.ca/~lisa/deep/data/mnist/mnist.pkl.gz"


def _find_or_fetch():
    for d in _CANDIDATE_DIRS:
        if not d:
            continue
        path = os.path.join(d, "mnist.pkl.gz")
        if os.path.isfile(path):
            return path
    # Try downloading into a writable cache dir.
    dest_dir = os.path.expanduser("~/.cache/theanet_tpu")
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, "mnist.pkl.gz")
    try:
        import shutil
        import urllib.request as url

        print("Downloading MNIST from:", _ORIGIN)
        # Stream to a temp name and rename only on success: a partial file at
        # the final path would satisfy os.path.isfile() on every later run,
        # permanently bypassing both the download and the synth fallback.
        tmp = dest + ".part"
        try:
            with url.urlopen(_ORIGIN, timeout=60) as r, open(tmp, "wb") as f:
                shutil.copyfileobj(r, f)
            os.replace(tmp, dest)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return dest
    except Exception as e:  # no egress / offline
        if os.environ.get("THEANET_ALLOW_SYNTH_FALLBACK") == "1":
            print("MNIST download failed ({}); THEANET_ALLOW_SYNTH_FALLBACK=1 "
                  "set — falling back to the synthetic digit dataset "
                  "(theanet_tpu.data.synth)".format(e))
            return None
        raise RuntimeError(
            "MNIST is unavailable (no local mnist.pkl.gz in {} and download "
            "failed: {}). Refusing to silently substitute synthetic data for "
            "a run labeled 'mnist'. Place mnist.pkl.gz in one of those "
            "directories (or point THEANET_DATA_DIR at it), or set "
            "THEANET_ALLOW_SYNTH_FALLBACK=1 to opt in to the synthetic "
            "fallback.".format([d for d in _CANDIDATE_DIRS if d], e)
        ) from e


def _load():
    path = _find_or_fetch()
    if path is None:
        from . import synth

        return (
            synth.training_x,
            synth.training_y.astype(np.int32),
            synth.testing_x,
            synth.testing_y.astype(np.int32),
        )

    with gzip.open(path, "rb") as f:
        u = pickle._Unpickler(f)
        u.encoding = "latin1"
        train_set, valid_set, test_set = u.load()

    train_x, train_y = train_set
    valid_x, valid_y = valid_set
    testing_x, testing_y = test_set

    training_x = np.vstack((train_x, valid_x))
    training_y = np.concatenate((train_y, valid_y)).astype(np.int32)

    training_x = training_x.reshape((training_x.shape[0], 1, 28, 28))
    testing_x = testing_x.reshape((testing_x.shape[0], 1, 28, 28))
    return training_x, training_y, testing_x, testing_y.astype(np.int32)


_NAMES = ("training_x", "training_y", "testing_x", "testing_y")
_loaded = {}


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    if not _loaded:
        _loaded.update(zip(_NAMES, _load()))
    return _loaded[name]
