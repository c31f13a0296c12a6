"""The GPU entry points on a machine without one: chip_smoke.py and bench.py
refuse to report, chip_smoke.py --four selects only the mesh phase, bench's
peak table rejects unknown devices, the compile-cache rule, and configs that
still carry retired kernel keys."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def _run(args, cwd=REPO, **env):
    e = {k: v for k, v in os.environ.items()
         if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    e.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO if cwd == REPO else "")
    e.update(env)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_report_without_a_gpu(script):
    p = _run([script])
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "GPU" in p.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert p.returncode != 0 and '"ok": true' not in p.stdout


@pytest.mark.parametrize("four", [False, True])
def test_four_selects_only_the_mesh_phase(four):
    got = chip_smoke.phases(four)
    if four:
        assert got == [chip_smoke.phase_mesh]
    else:
        assert chip_smoke.phase_mesh not in got and len(got) == 3


def test_every_shipped_config_has_an_offline_dataset():
    names = {os.path.splitext(f)[0]
             for f in os.listdir(os.path.join(REPO, "params"))
             if f.endswith(".prms")}
    assert names == set(chip_smoke.DATASETS)


def test_peak_table_rejects_an_unknown_kind():
    with pytest.raises(KeyError, match="PEAKS"):
        bench.peaks("Some Accelerator 9000")
    h100 = bench.peaks("NVIDIA H100 80GB HBM3")
    assert (h100["bf16"], h100["tf32"], h100["fp32"]) == (989e12, 495e12,
                                                            67e12)


def test_peak_share_names_both_power_limits():
    note = bench.peak_note(bench.peaks("NVIDIA H100 80GB HBM3"),
                           "NVIDIA H100 80GB HBM3, 400.00 W")
    assert note == "(peak at the 700 W limit; this card: 400.00 W)"


_CACHE_PROBE = ("import jax; from theanet_tpu import compile_cache as c; "
                "d = c.enable(); "
                "print(d); print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_honours_the_environment(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX keeps its cache there and the
    program sets no other directory."""
    want = str(tmp_path / "cache")
    p = _run(["-c", _CACHE_PROBE], JAX_COMPILATION_CACHE_DIR=want)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == [want, want]


def test_compile_cache_default_is_fixed_under_the_checkout():
    p = _run(["-c", _CACHE_PROBE])
    assert p.returncode == 0, p.stderr
    want = os.path.join(REPO, ".jax_compile_cache")
    assert p.stdout.split() == [want, want]


def test_config_with_retired_kernel_keys_loads_and_trains(capfd):
    """tests/golden/retired_keys.prms carries the two kernel switches of
    older configs; it loads and trains, and each is named once on stderr."""
    from theanet_tpu.model import KNOWN_TRAINING_PARAMS, NeuralNet
    from theanet_tpu.prms import load_params
    from theanet_tpu.trainer import Trainer

    layers, tp, allwts = load_params(
        os.path.join(REPO, "tests", "golden", "retired_keys.prms"))
    retired = sorted(set(tp) - KNOWN_TRAINING_PARAMS)
    assert "MEGAFUSED" in retired and len(retired) == 2
    net = NeuralNet(layers, tp, allwts)
    x = np.random.RandomState(0).rand(8, 1, 8, 8).astype(np.float32)
    y = np.zeros((8,), np.int32)
    total, _, _ = Trainer(net, x, y, x, y).run_epoch()
    assert np.isfinite(total)
    err = capfd.readouterr().err
    for key in retired:
        assert err.count(key) == 1 and "ignored" in err, err
