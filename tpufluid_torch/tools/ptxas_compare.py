"""The ptxas report of two checkouts' step kernels side by side.

    python3 tpufluid_torch/tools/ptxas_compare.py PARENT_DIR CHANGE_DIR

Builds csrc/stencil.cu, jacobi.cu and advect.cu of each checkout with its
own build.py (into that checkout's _build/), reads each library's
``nvcc -Xptxas=-v`` log and pairs the kernel instances by their demangled
name (parent_names: a parent may name an instance otherwise). Prints one
line per pair that differs in registers, stack frame or spills, one line
per instance that only one side has (the kernels a change adds or
removes), and a summary; exits 1 if a pair differs or if no instance
pairs. Needs nvcc (the CUDA toolkit) and c++filt.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

LIBRARIES = ("stencil", "jacobi", "advect")
FIELDS = ("registers", "stack", "spill_stores", "spill_loads")

_REPORT = f"""
import json, subprocess
from tpufluid_torch.ops.cuda import build
build.build({list(LIBRARIES)!r})
rows = []
for name in {list(LIBRARIES)!r}:
    for f in build.ptxas_report(build.library_path(name).with_suffix(".log").read_text()):
        f["function"] = subprocess.run(["c++filt", f["function"]], capture_output=True,
                                       text=True, timeout=60).stdout.strip()
        rows.append(f)
print(json.dumps(rows))
"""


def report(root: str) -> dict:
    """Demangled name -> ptxas fields of every instance that ``root``'s
    build compiles."""
    out = subprocess.run([sys.executable, "-c", _REPORT], cwd=root, capture_output=True,
                         text=True, check=True, timeout=1200,
                         env={**os.environ, "PYTHONPATH": os.path.abspath(root)})
    return {r["function"]: r for r in json.loads(out.stdout.strip().splitlines()[-1])}


def batched_name(name: str) -> str:
    """The parent's name of a change's batched instance: its trailing
    ``, false`` template argument dropped (the argument list follows it)."""
    return re.sub(r", false>\(", ">(", name, count=1)


def parent_names(name: str):
    """The names a parent may give a change's instance: its own; without
    the trailing field layout (batched_name: a parent before the packed
    layout); and for the velocity's gather, with the source layout planes
    (0) as its third template argument (a parent whose dye gather read a
    prepared source)."""
    yield name
    yield batched_name(name)
    yield re.sub(r"^void advect_kernel<([^,]+), (\d), ", r"void advect_kernel<\1, \2, 0, ",
                 name, count=1)


def main(argv) -> int:
    if len(argv) != 2:
        raise SystemExit(__doc__)
    parent, change = (report(d) for d in argv)
    differ = 0
    matched = set()
    for name, row in sorted(change.items()):
        key = next((n for n in parent_names(name) if n in parent), None)
        if key is None:
            print(f"only in the change: {name[:110]}: " + ", ".join(
                f"{f} {row.get(f)}" for f in FIELDS))
            continue
        matched.add(key)
        old = parent[key]
        if any(old.get(f) != row.get(f) for f in FIELDS):
            differ += 1
            print(f"differs: {name[:110]}: " + ", ".join(
                f"{f} {old.get(f)} -> {row.get(f)}" for f in FIELDS))
    for name in sorted(set(parent) - matched):
        print(f"only in the parent: {name[:110]}")
    print(f"ptxas compare: {len(matched)} instances paired, {differ} differ in registers, "
          f"stack or spills; {len(change) - len(matched)} only in the change, "
          f"{len(parent) - len(matched)} only in the parent")
    return 1 if differ or not matched else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
