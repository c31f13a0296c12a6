"""Test harness config: force the CPU backend with 8 virtual devices so
sharding tests exercise multi-device meshes (up to 8 devices) without
accelerator hardware.

Tests marked ``gpu`` exercise what only the card can show; they skip here
with a reason, and ``python chip_smoke.py`` runs the same paths on the GPU.

Every test also runs under a faulthandler watchdog (pytest-timeout is not
in this image): a test that exceeds its budget dumps EVERY thread's stack
and hard-exits the pytest process — a hung test becomes a loud, fast,
diagnosable failure instead of a silently wedged run. Override per test
with ``@pytest.mark.timeout_s(seconds)``.
"""

import faulthandler
import os
import sys

import pytest

_DEFAULT_TEST_BUDGET_S = float(os.environ.get("THEANET_TEST_BUDGET", "1200"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "timeout_s(seconds): per-test wall-clock budget for the "
        "faulthandler watchdog (default %ds)" % _DEFAULT_TEST_BUDGET_S,
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs the GPU; skipped on the CPU test backend (chip_smoke.py "
        "runs the same path on the card)",
    )


def pytest_runtest_setup(item):
    marker = item.get_closest_marker("timeout_s")
    budget = float(marker.args[0]) if marker else _DEFAULT_TEST_BUDGET_S
    faulthandler.dump_traceback_later(budget, exit=True, file=sys.stderr)


def pytest_runtest_teardown(item, nextitem):
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs the GPU; chip_smoke.py runs this path on the card")


# APPEND to any pre-existing XLA_FLAGS: a setdefault here would be a no-op
# when the shell exports unrelated flags (e.g. --xla_dump_to), jax.devices()
# would return 1 device, and every skipif(<8 devices) sharding test would
# silently skip — a broken collective would ship with a green run.
_flag = "--xla_force_host_platform_device_count=8"
_prev = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _prev:
    os.environ["XLA_FLAGS"] = (_prev + " " + _flag).strip()

import jax  # noqa: E402  (must follow the XLA_FLAGS edit)

jax.config.update("jax_platforms", "cpu")

assert len(jax.devices()) >= 8, (
    "the virtual 8-device CPU pool failed to initialize (JAX was imported "
    "before conftest set XLA_FLAGS, or the shell forces a smaller device "
    "count?) — sharding tests would silently skip"
)
