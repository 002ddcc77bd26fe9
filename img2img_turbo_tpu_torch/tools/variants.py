"""What the kernel variant tools (`k6_variants.py`, `k7_variants.py`) share:
each variant is a copy of the package under `img2img_turbo_tpu_torch/build/
<tool>/<name>/` (git-ignored) with one CUDA source changed by text
substitutions, every variant's libraries are built at once (one nvcc each),
and each variant then runs in a process of its own from its copy's root,
so that it imports its own package.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent


def substituted(text: str, subs) -> str:
    """`text` with each (old, new) of `subs` applied; each old must occur
    exactly once."""
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"substitution does not apply once: {old!r}")
        text = text.replace(old, new)
    return text


def make(tool: str, name: str, src: str, patch) -> Path:
    """The variant's checkout root: a copy of the package (less its builds)
    with `src` (a path in the package) replaced by patch(its text)."""
    root = PKG / "build" / tool / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = root / PKG.name / src
    path.write_text(patch(path.read_text()))
    return root


def main(doc: str, script: str, src: str, libs, variants: dict, patch,
         run_cases) -> None:
    """A variant tool's command line: `--only a,b,...` (names may repeat;
    they run in the order given) makes, builds and runs each variant, whose
    source is patch(text, its substitutions); the name `parent` runs
    run_cases in the checkout given by `--parent` (another commit's root,
    built there, unpatched); `--run name`, inside a variant's copy, calls
    run_cases(name)."""
    tool = Path(script).stem
    p = argparse.ArgumentParser(description=doc.split("\n")[0])
    p.add_argument("--only", default=",".join(variants),
                   help="comma-separated variants: " + ", ".join(variants)
                   + ", or parent")
    p.add_argument("--parent", help="root of the checkout that `parent` "
                   "names")
    p.add_argument("--run", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.run:
        sys.path.insert(0, os.getcwd())
        run_cases(args.run)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit(f"{tool}: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    names = args.only.split(",")
    if "parent" in names and not args.parent:
        sys.exit(f"{tool}: `parent` needs --parent <checkout root>")
    roots = {n: Path(args.parent).resolve() if n == "parent" else
             make(tool, n, src, lambda t, n=n: patch(t, variants[n]))
             for n in names}
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
         "from img2img_turbo_tpu_torch.ops import _build; "
         f"_build.build({list(libs)!r})"], cwd=root)
        for root in roots.values()]
    if any(b.wait() for b in builds):
        sys.exit(f"{tool}: a variant did not build")
    failed = [n for n in names if subprocess.run(
        [sys.executable, str(Path(script).resolve()), "--run", n],
        cwd=roots[n]).returncode]
    if failed:
        sys.exit(f"{tool}: {', '.join(failed)} failed")
