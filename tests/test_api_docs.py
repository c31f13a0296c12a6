"""The committed API reference (docs/api/) matches the code.

tools/gen_api_docs.py is the build's stand-in for the reference's Sphinx
autodoc tree (reference docs/modules/*.rst): it renders every public
class/function signature + docstring to markdown. This test regenerates
into a temp dir and diffs against the committed pages, so a public-surface
change that forgets to regenerate fails loudly here.
"""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.timeout_s(600)
def test_api_docs_current(tmp_path):
    env = dict(os.environ)
    env["THEANET_ALLOW_SYNTH_FALLBACK"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "gen_api_docs.py"),
         str(tmp_path)],
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=540)
    assert proc.returncode == 0, proc.stderr[-2000:]

    committed = {p.name: p for p in (REPO / "docs" / "api").glob("*.md")}
    fresh = {p.name: p for p in tmp_path.glob("*.md")}
    assert set(committed) == set(fresh), (
        f"module set drifted: committed-only={sorted(set(committed) - set(fresh))}, "
        f"fresh-only={sorted(set(fresh) - set(committed))} — rerun "
        f"tools/gen_api_docs.py")
    stale = [n for n in sorted(fresh)
             if committed[n].read_text() != fresh[n].read_text()]
    assert not stale, (
        f"stale API docs for {stale} — rerun: JAX_PLATFORMS=cpu "
        f"python tools/gen_api_docs.py")
