"""Suite twin of the multi-chip dryrun: ``__graft_entry__.dryrun_multichip(8)``
runs inline here — the conftest already provides the 8-device virtual CPU
platform, and THEANET_DRYRUN_CHILD=1 short-circuits the re-exec — so the
GSPMD DP+TP phase executes with the very spec the dryrun validates. A red
dryrun is therefore always reproducible as this red test, and vice versa.
"""

import jax
import pytest

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.mark.timeout_s(900)
def test_dryrun_multichip_8_inline(monkeypatch, capfd):
    monkeypatch.setenv("THEANET_DRYRUN_CHILD", "1")
    import __graft_entry__ as g

    g.dryrun_multichip(8)
    out = capfd.readouterr().out
    assert "[dryrun] phase 1" in out and ") OK in" in out, out
    assert "dryrun_multichip OK" in out, out
