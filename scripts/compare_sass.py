#!/usr/bin/env python3
"""Compare the machine code (SASS) of one CUDA library in two checkouts.

    python3 scripts/compare_sass.py --other DIR [--lib bf_relax]
        [--kernel bf_solve_grouped_kernel] [--out FILE]

DIR is the root of another checkout of this repository (for example the
parent commit unpacked with ``git archive`` into ``_checkout/``).  The
script builds the library ``--lib`` of both checkouts (``kernels/_build``
of each), disassembles each with ``cuobjdump -sass`` and, for every
kernel whose name contains ``--kernel``, splits the code at its block
barriers (``BAR``) into regions and prints, per region, the instruction
count in both checkouts and the opcodes whose counts differ (this
checkout minus the other).  Registers and constants are ignored, so two
regions with the same counts differ only in order.  The full listings
go to FILE's directory (default ``chiprun_out/``).  It needs ``nvcc``
and ``cuobjdump`` (``/usr/local/cuda/bin`` or on ``PATH``); no card.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def build(root: Path, lib: str) -> Path:
    """The checkout's built library, built in a process of its own so
    each checkout imports its own ``repro_torch``."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; _build.build_all(); "
            "print(_build.BUILD_DIR)")
    out = subprocess.run([sys.executable, "-c", code, str(root / "src")],
                         capture_output=True, text=True, check=True,
                         timeout=900).stdout.strip().splitlines()[-1]
    libs = sorted(Path(out).glob(f"lib{lib}-*.so"),
                  key=lambda p: p.stat().st_mtime)
    if not libs:
        raise SystemExit(f"no lib{lib}-*.so under {out}")
    return libs[-1]


def disassemble(so: Path, keep: Path) -> dict:
    """{kernel name: [opcode, ...]} of every function in ``so``, with the
    anonymous-namespace hash taken out of the names; the listing is
    written to ``keep``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    keep.write_text(text)
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "",
                         m.group(1))
            funcs[cur] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if cur is not None and m:
            funcs[cur].append(m.group(2))
    return funcs


def regions(ops: list) -> list:
    """The opcodes split at each block barrier (the barrier ends its
    region)."""
    out, cur = [], []
    for op in ops:
        cur.append(op)
        if op.startswith("BAR"):
            out.append(cur)
            cur = []
    return out + [cur]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other checkout")
    ap.add_argument("--lib", default="bf_relax")
    ap.add_argument("--kernel", default="bf_solve_grouped_kernel")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "compare_sass.json")
    args = ap.parse_args()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    this = disassemble(build(ROOT, args.lib),
                       args.out.with_suffix(".this.sass"))
    other = disassemble(build(args.other, args.lib),
                        args.out.with_suffix(".other.sass"))
    report = {}
    for name in sorted(this):
        if args.kernel not in name or name not in other:
            continue
        rows = []
        a, b = regions(this[name]), regions(other[name])
        for i in range(max(len(a), len(b))):
            ra = a[i] if i < len(a) else []
            rb = b[i] if i < len(b) else []
            ca, cb = collections.Counter(ra), collections.Counter(rb)
            diff = {op: ca[op] - cb[op] for op in sorted(set(ca) | set(cb))
                    if ca[op] != cb[op]}
            rows.append({"region": i, "this": len(ra), "other": len(rb),
                         "diff": diff})
        report[name] = rows
        print(name)
        for r in rows:
            print(f"  region {r['region']}: this {r['this']}, other "
                  f"{r['other']}, opcode counts this - other {r['diff']}")
    args.out.write_text(json.dumps(report, indent=1))
    return 0 if report else 1


if __name__ == "__main__":
    sys.exit(main())
