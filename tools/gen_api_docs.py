"""Generate the markdown API reference under docs/api/.

The reference ships Sphinx autodoc stubs (reference docs/modules/*.rst:
``.. automodule:: theanet.layer.convpool`` etc.) that expand every public
class/function signature + docstring at build time. This environment has
no Sphinx, so this tool IS the autodoc step: it imports each
``theanet_tpu`` module, walks its public surface with ``inspect``, and
emits one deterministic markdown file per module plus an index. Output
is committed (docs are readable without running anything), and
tests/test_api_docs.py regenerates to a temp dir and diffs, so the
committed pages cannot drift from the code.

Usage:  JAX_PLATFORMS=cpu python tools/gen_api_docs.py [outdir]
"""

import importlib
import inspect
import os
import sys
import textwrap

MODULES = [
    "theanet_tpu",
    "theanet_tpu.activations",
    "theanet_tpu.inits",
    "theanet_tpu.optim",
    "theanet_tpu.model",
    "theanet_tpu.prms",
    "theanet_tpu.trainer",
    "theanet_tpu.train",
    "theanet_tpu.compile_cache",
    "theanet_tpu.layers",
    "theanet_tpu.layers.base",
    "theanet_tpu.layers.input",
    "theanet_tpu.layers.conv",
    "theanet_tpu.layers.dense",
    "theanet_tpu.layers.out",
    "theanet_tpu.layers.aux",
    "theanet_tpu.data",
    "theanet_tpu.data.mnist",
    "theanet_tpu.data.synth",
    "theanet_tpu.data.synth3",
    "theanet_tpu.data.synth_aux",
    "theanet_tpu.io",
    "theanet_tpu.io.pipeline",
    "theanet_tpu.ops",
    "theanet_tpu.ops.elastic",
    "theanet_tpu.parallel",
    "theanet_tpu.parallel.mesh",
]


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent=""):
    d = inspect.getdoc(obj)
    if not d:
        return ""
    return textwrap.indent(d, indent) + "\n"


def _public_members(mod):
    """Module-level public classes and functions DEFINED in the module
    (imports are documented where they live), in source order."""
    names = getattr(mod, "__all__", None)
    members = []
    for name, obj in vars(mod).items():
        if name.startswith("_"):
            continue
        if not (inspect.isclass(obj) or inspect.isfunction(obj)):
            continue
        if getattr(obj, "__module__", None) != mod.__name__:
            if not (names and name in names):
                continue
        members.append((name, obj))

    def order(item):
        try:
            return inspect.getsourcelines(item[1])[1]
        except (OSError, TypeError):
            return 1 << 30

    return sorted(members, key=order)


def _class_md(name, cls):
    out = [f"### class `{name}{_sig(cls)}`\n"]
    bases = [b.__name__ for b in cls.__bases__ if b is not object]
    if bases:
        out.append(f"*Bases:* {', '.join(f'`{b}`' for b in bases)}\n")
    doc = _doc(cls)
    if doc:
        out.append(doc)
    for mname, mobj in sorted(vars(cls).items()):
        if mname.startswith("_"):
            continue
        if isinstance(mobj, property):
            out.append(f"- **property `{mname}`**")
            d = inspect.getdoc(mobj)
            if d:
                out.append(textwrap.indent(d, "  "))
        elif inspect.isfunction(mobj) or isinstance(
                mobj, (staticmethod, classmethod)):
            fn = mobj.__func__ if isinstance(
                mobj, (staticmethod, classmethod)) else mobj
            out.append(f"- **`{mname}{_sig(fn)}`**")
            d = inspect.getdoc(fn)
            if d:
                out.append(textwrap.indent(d, "  "))
    out.append("")
    return "\n".join(out)


def _func_md(name, fn):
    out = [f"### `{name}{_sig(fn)}`\n"]
    doc = _doc(fn)
    if doc:
        out.append(doc)
    out.append("")
    return "\n".join(out)


def render_module(modname):
    mod = importlib.import_module(modname)
    parts = [f"# `{modname}`\n"]
    doc = _doc(mod)
    if doc:
        parts.append(doc + "\n")
    for name, obj in _public_members(mod):
        if inspect.isclass(obj):
            parts.append(_class_md(name, obj))
        else:
            parts.append(_func_md(name, obj))
    return "\n".join(parts).rstrip() + "\n"


def main(outdir):
    os.makedirs(outdir, exist_ok=True)
    index = ["# theanet_tpu API reference\n",
             "Generated by `tools/gen_api_docs.py` (the build's stand-in "
             "for the reference's Sphinx autodoc tree, reference "
             "docs/modules/*.rst). Regenerate after changing any public "
             "surface:\n",
             "```\nPYTHONPATH= JAX_PLATFORMS=cpu python tools/gen_api_docs.py\n```\n"]
    for modname in MODULES:
        fname = modname.replace(".", "_") + ".md"
        text = render_module(modname)
        with open(os.path.join(outdir, fname), "w") as f:
            f.write(text)
        mod = importlib.import_module(modname)
        first = (inspect.getdoc(mod) or "").split("\n", 1)[0]
        index.append(f"- [`{modname}`]({fname}) — {first}")
    with open(os.path.join(outdir, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print(f"wrote {len(MODULES) + 1} files to {outdir}")


if __name__ == "__main__":
    # data modules bind training_x/... at import (the reference's data
    # protocol); docs only need signatures, so opt into the synth stand-in
    os.environ.setdefault("THEANET_ALLOW_SYNTH_FALLBACK", "1")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(sys.argv[1] if len(sys.argv) > 1 else
         os.path.join(os.path.dirname(os.path.dirname(
             os.path.abspath(__file__))), "docs", "api"))
