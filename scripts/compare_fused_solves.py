#!/usr/bin/env python3
"""Time the port's fused solves from two checkouts on one CUDA card, in turns.

    python3 scripts/compare_fused_solves.py --other DIR [--out FILE]

DIR is the root of another checkout of this repository, for example the
parent commit unpacked with ``git archive`` into ``_checkout/`` (listed
in ``.gitignore``).  The script runs one process per turn, in the order
other, this, this, other.  Each process builds its checkout's kernels and
times, with CUDA events on the same seeded inputs (``chip_smoke.
road_inputs``):

- ``bf_solve_grouped`` at the serving slab shape (S=64, z=96, J in
  {8, 32}; median of 51 launches) and at the refine_dense shape (S=8192,
  z=256, J=32; median of 5);
- ``ktrop_solve`` at the levels shape (S=8192, z=256, k=10, at most 48
  iterations; median of 5).

It prints one JSON line per turn, checks that both checkouts give the
same bytes (a digest of each output), writes the turns to FILE (default
``chiprun_out/compare_fused_solves.json``) and prints the card's name and
power limit.  It needs one card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SERVING = [(64, 8, 96), (64, 32, 96)]  # (S, J, z) of the serving slabs
DENSE = (8192, 32, 256)
LEVELS_K, LEVELS_ITERS = 10, 48


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_checkout(root: Path) -> dict:
    """One turn: the kernels of the checkout at ``root``, timed."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # inputs and timing; puts this checkout's src first

    sys.path.remove(str(ROOT / "src"))
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import _build, bf_relax, ktrop

    if not torch.cuda.is_available():
        raise SystemExit("compare_fused_solves: no CUDA card")
    check_src = Path(bf_relax.__file__).resolve()
    if root.resolve() not in check_src.parents:
        raise SystemExit(f"imported {check_src}, not from {root}")
    _build.build_all()
    dev = torch.device("cuda", 0)
    out = {"root": str(root), "device": torch.cuda.get_device_name(0),
           "bf_solve_grouped": {}, "digest": {}}
    for S, J, z in SERVING + [DENSE]:
        args = chip_smoke.road_inputs(torch, S, J, z, dev)
        res = bf_relax.solve_grouped(*args)
        name = f"S{S}_J{J}_z{z}"
        out["digest"][f"bf_{name}"] = _digest(res[0], res[1])
        repeats = 51 if S < 1024 else 5
        out["bf_solve_grouped"][name] = chip_smoke.cuda_ms(
            torch, lambda: bf_relax.solve_grouped(*args), repeats)
        del args, res
    S, _, z = DENSE
    adj = chip_smoke.road_inputs(torch, S, 1, z, dev)[0]
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 1)
    src = torch.randint(0, z, (S,), generator=gen, device=dev,
                        dtype=torch.int32)
    res = ktrop.solve(adj, src, LEVELS_K, LEVELS_ITERS)
    out["digest"]["ktrop_levels"] = _digest(res[0], res[1])
    out["ktrop_solve"] = {f"S{S}_k{LEVELS_K}_z{z}": chip_smoke.cuda_ms(
        torch, lambda: ktrop.solve(adj, src, LEVELS_K, LEVELS_ITERS), 5)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="root of the other checkout")
    ap.add_argument("--time", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "compare_fused_solves.json")
    args = ap.parse_args()
    if args.time is not None:
        print(json.dumps(time_checkout(args.time)), flush=True)
        return 0
    if args.other is None:
        ap.error("--other is required")
    turns = []
    for root in (args.other, ROOT, ROOT, args.other):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--time",
             str(root.resolve())], capture_output=True, text=True,
            timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode or 1
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        turn["which"] = "this" if root == ROOT else "other"
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    same = all(t["digest"] == turns[0]["digest"] for t in turns)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "same_bytes": same,
                                    "turns": turns}, indent=1))
    print(smi)
    print(json.dumps({"same_bytes": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
