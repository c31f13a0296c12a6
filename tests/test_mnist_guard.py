"""The mnist data module must never silently train on synthetic data:
without mnist.pkl.gz it hard-fails unless THEANET_ALLOW_SYNTH_FALLBACK=1."""

import importlib
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# The download fails without contacting any host: the probes replace
# urlopen with one that raises, as an offline machine's would.
_OFFLINE = (
    "import urllib.request\n"
    "def _offline(*a, **k): raise OSError('no route to host')\n"
    "urllib.request.urlopen = _offline\n"
)


def _probe(extra_env):
    env = {k: v for k, v in os.environ.items()
           if k not in ("THEANET_ALLOW_SYNTH_FALLBACK", "THEANET_DATA_DIR")}
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra_env)
    return subprocess.run(
        [sys.executable, "-c", _OFFLINE +
         "import theanet_tpu.data.mnist as m; print(m.training_x.shape)"],
        env=env, text=True, capture_output=True,
    )


def _mnist_available():
    # Mirrors theanet_tpu/data/mnist.py _CANDIDATE_DIRS without importing the
    # module (importing it triggers the load we are testing).
    dirs = [
        os.path.join(REPO, "theanet_tpu", "data"),
        os.environ.get("THEANET_DATA_DIR", ""),
        os.path.expanduser("~/.cache/theanet_tpu"),
        "/root/reference/data",
    ]
    return any(
        d and os.path.isfile(os.path.join(d, "mnist.pkl.gz")) for d in dirs
    )


def test_hard_fails_without_fallback_optin():
    if _mnist_available():
        return  # real MNIST present: nothing to guard
    proc = _probe({})
    assert proc.returncode != 0
    assert "Refusing to silently substitute" in proc.stderr


def test_fallback_optin_loads_synth():
    if _mnist_available():
        return
    proc = _probe({"THEANET_ALLOW_SYNTH_FALLBACK": "1"})
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "28, 28" in proc.stdout


def test_partial_download_leaves_no_cache_file(tmp_path):
    """A download that dies mid-stream must not leave a truncated
    mnist.pkl.gz behind: os.path.isfile() would pick it up on every later
    run, crash in gzip, and permanently bypass the synth-fallback opt-in."""
    if _mnist_available():
        return  # real MNIST present: the download path is unreachable
    env = {k: v for k, v in os.environ.items()
           if k not in ("THEANET_ALLOW_SYNTH_FALLBACK", "THEANET_DATA_DIR")}
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["HOME"] = str(tmp_path)
    env["THEANET_ALLOW_SYNTH_FALLBACK"] = "1"
    script = (
        "import urllib.request\n"
        "class R:\n"
        "    def __enter__(self): return self\n"
        "    def __exit__(self, *a): return False\n"
        "    def read(self, n=-1): raise OSError('reset mid-stream')\n"
        "urllib.request.urlopen = lambda *a, **k: R()\n"
        "import theanet_tpu.data.mnist as m\n"
        "print(m.training_x.shape)\n"
    )
    proc = subprocess.run([sys.executable, "-c", script],
                          env=env, text=True, capture_output=True)
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "28, 28" in proc.stdout  # synth fallback engaged
    cache = tmp_path / ".cache" / "theanet_tpu"
    leftovers = list(cache.glob("mnist.pkl.gz*")) if cache.exists() else []
    assert leftovers == [], leftovers


def test_parity_tool_parses_epoch_table():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import parity_vs_reference as pv

    text = (
        "Epoch   Cost  Tr_Error Tr_P(MLE)    Te_Error Te_P(MLE)\n"
        "  0   429.58     1.25%  (97.09%)       2.50%  (97.41%)\n"
        "garbage line\n"
        " 10    93.09     0.00%  (99.03%)       0.75%  (99.07%)\n"
    )
    rows = pv.parse_epoch_table(text)
    assert [r["epoch"] for r in rows] == [0, 10]
    assert rows[0]["te_err"] == 2.50 and rows[1]["tr_err"] == 0.0


def test_parity_tool_rewrites_prms(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import parity_vs_reference as pv

    src = tmp_path / "a.prms"
    src.write_text(repr({"layers": [("InputLayer", {"img_sz": 28})],
                         "training_params": {"SEED": 1, "NUM_EPOCHS": 101}}))
    dst = tmp_path / "b.prms"
    spec = pv.rewrite_prms(str(src), seed=9, epochs=3, dst_path=str(dst))
    assert spec["training_params"]["SEED"] == 9
    import ast
    back = ast.literal_eval(dst.read_text())
    assert back["training_params"]["NUM_EPOCHS"] == 3
