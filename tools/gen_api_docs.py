"""Generate docs/API.md: the public API reference, extracted from live
docstrings (so it can't drift silently -- regenerate after API changes):

    python tools/gen_api_docs.py            # writes docs/API.md
    python tools/gen_api_docs.py --check    # exit 1 if docs/API.md is stale
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

MODULES = [
    "auditory_tpu",
    "auditory_tpu.config",
    "auditory_tpu.io.wav",
    "auditory_tpu.io.native",
    "auditory_tpu.dsp.design",
    "auditory_tpu.dsp.frame",
    "auditory_tpu.dsp.dft",
    "auditory_tpu.dsp.mel",
    "auditory_tpu.dsp.gabor",
    "auditory_tpu.nn.fffb",
    "auditory_tpu.nn.kwta",
    "auditory_tpu.nn.neigh_inhib",
    "auditory_tpu.pipeline.sndenv",
    "auditory_tpu.pipeline.batch",
    "auditory_tpu.pipeline.segments",
    "auditory_tpu.pipeline.streaming",
    "auditory_tpu.pipeline.online",
    "auditory_tpu.parallel.mesh",
    "auditory_tpu.parallel.distributed",
    "auditory_tpu.speech",
    "auditory_tpu.speech.timit",
    "auditory_tpu.speech.synthcvs",
    "auditory_tpu.speech.grafestes",
    "auditory_tpu.speech.vowels",
    "auditory_tpu.speech.table",
    "auditory_tpu.utils.viz",
    "auditory_tpu.utils.profiling",
    "auditory_tpu.utils.cache",
]

HEADER = """# API reference

Public surface of `auditory_tpu`, generated from live docstrings by
`tools/gen_api_docs.py` (do not edit by hand; regenerate after API changes).
See `docs/MIGRATION.md` for the reference(Go)->here symbol mapping.
"""


def first_para(doc: str | None) -> str:
    if not doc:
        return ""
    para = doc.strip().split("\n\n")[0]
    return " ".join(line.strip() for line in para.splitlines())


def public_names(mod) -> list[str]:
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [
        n for n, o in vars(mod).items()
        if not n.startswith("_")
        and (inspect.isfunction(o) or inspect.isclass(o))
        and getattr(o, "__module__", None) == mod.__name__
    ]


def sig_of(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def render() -> str:
    out = [HEADER]
    for name in MODULES:
        mod = importlib.import_module(name)
        out.append(f"\n## `{name}`\n")
        mp = first_para(mod.__doc__)
        if mp:
            out.append(mp + "\n")
        for sym in public_names(mod):
            obj = getattr(mod, sym, None)
            if obj is None:
                continue
            if inspect.isclass(obj):
                out.append(f"### `{sym}{sig_of(obj)}`\n")
                d = first_para(obj.__doc__)
                if d:
                    out.append(d + "\n")
                for mname, meth in sorted(vars(obj).items()):
                    if mname.startswith("_"):
                        continue
                    if isinstance(meth, property):
                        out.append(
                            f"- `.{mname}` (property) — "
                            f"{first_para(meth.fget.__doc__) or ''}"
                        )
                        continue
                    if isinstance(meth, (classmethod, staticmethod)):
                        fn = meth.__func__
                        out.append(f"- `.{mname}{sig_of(fn)}` — "
                                   f"{first_para(fn.__doc__) or ''}")
                        continue
                    if not callable(meth):
                        continue
                    out.append(f"- `.{mname}{sig_of(meth)}` — "
                               f"{first_para(meth.__doc__) or ''}")
                out.append("")
            elif inspect.isfunction(obj):
                out.append(f"### `{sym}{sig_of(obj)}`\n")
                d = first_para(obj.__doc__)
                if d:
                    out.append(d + "\n")
            else:  # constants / tables
                out.append(f"### `{sym}` (constant)\n")
    return "\n".join(out) + "\n"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "API.md")
    text = render()
    if args.check:
        try:
            with open(path) as f:
                current = f.read()
        except FileNotFoundError:
            current = None
        if current != text:
            print("docs/API.md is stale; run tools/gen_api_docs.py")
            return 1
        print("docs/API.md is current")
        return 0
    with open(path, "w") as f:
        f.write(text)
    print(f"wrote {path} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
