#!/usr/bin/env python3
"""Time the port's kernels (fused solves, step kernels, bound_dist) from two
checkouts on one CUDA card, in turns.

    python3 scripts/compare_fused_solves.py --other DIR [--rounds N] [--out FILE]

DIR is the root of another checkout of this repository, for example the
parent commit unpacked with ``git archive`` into ``_checkout/`` (listed
in ``.gitignore``).  The script runs one process per turn, in the order
other, this, this, other, and that N times over (``--rounds``, default
1), so a difference of a percent can be told from the drift between
turns.  Each process builds its checkout's kernels and
times, with CUDA events on the same seeded inputs (``chip_smoke.
road_inputs``):

- ``bf_solve_grouped`` at the serving slab shape (S=64, z=96, J in
  {8, 32}; median of 51 launches) and at the refine_dense shape (S=8192,
  z=256, J=32; median of 5);
- ``bf_relax_step`` at the refine_dense shape (one relaxation of the
  solve's inputs; median of 7);
- ``ktrop_solve`` at the levels shape (S=8192, z=256, k=10, at most 48
  iterations; median of 5) and ``ktrop_relax_step`` there (one
  relaxation from the solve's state after 8 iterations; median of 7);
- ``bound_dist`` at the maintain shape (S=122,880, E=2,048, B=4,000,000,
  on ``chip_smoke.maintain_inputs``' profile after the step's sort;
  median of 5).

It prints one JSON line per turn and checks that both checkouts give the
same bytes for the fused solves and the step kernels (a digest of each
output).  ``bound_dist``
sums floats, and two of its versions may add in another order: the
script checks that each checkout gives the same bytes in all of its
turns and that the two checkouts agree within rtol 2e-5 (each turn's
output is kept next to FILE until then).  It writes the turns to FILE
(default ``chiprun_out/compare_fused_solves.json``) and prints the
card's name and power limit.  It needs one card; without one it exits
non-zero.
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
MAINTAIN = (122_880, 2048, 4_000_000)  # (S, E, B)


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_checkout(root: Path, keep: Path) -> dict:
    """One turn: the kernels of the checkout at ``root``, timed;
    ``bound_dist``'s output saved to ``keep``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # inputs and timing; puts this checkout's src first

    sys.path.remove(str(ROOT / "src"))
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.engine import dense
    from repro_torch.kernels import _build, bf_relax, bound_dist, ktrop

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
        if (S, J, z) == DENSE:  # one relaxation of the same inputs
            adj, init, _, so, bn, cap = args
            step = bf_relax.relax_step(init, adj, so, bn, cap)
            out["digest"][f"bf_step_{name}"] = _digest(step)
            out["bf_relax_step"] = {name: chip_smoke.cuda_ms(
                torch, lambda: bf_relax.relax_step(init, adj, so, bn, cap),
                7)}
            del adj, init, so, bn, cap, step
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
    Dm = ktrop.solve(adj, src, LEVELS_K, 8)[0]  # a mid-relaxation state
    out["digest"]["ktrop_step_levels"] = _digest(ktrop.relax_step(Dm, adj))
    out["ktrop_relax_step"] = {f"S{S}_k{LEVELS_K}_z{z}": chip_smoke.cuda_ms(
        torch, lambda: ktrop.relax_step(Dm, adj), 7)}
    del adj, src, res, Dm
    S, E, B = MAINTAIN
    unit_w, unit_n, sub, phi = chip_smoke.maintain_inputs(torch, S, E, B, dev)
    w_s, n_s, cum_n = dense.sort_profile(unit_w, unit_n)
    cb = cum_n.sub_(n_s)
    del unit_w, unit_n
    bd = bound_dist.bound_dist(w_s, n_s, cb, sub, phi)
    out["bound_dist_digest"] = _digest(bd)
    torch.save(bd.cpu(), keep)
    out["bound_dist"] = {f"S{S}_E{E}_B{B}": chip_smoke.cuda_ms(
        torch, lambda: bound_dist.bound_dist(w_s, n_s, cb, sub, phi), 5)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="root of the other checkout")
    ap.add_argument("--time", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--keep", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--rounds", type=int, default=1,
                    help="times to run the turns other, this, this, other")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "compare_fused_solves.json")
    args = ap.parse_args()
    if args.time is not None:
        print(json.dumps(time_checkout(args.time, args.keep)), flush=True)
        return 0
    if args.other is None:
        ap.error("--other is required")
    import torch

    turns = []
    args.out.parent.mkdir(parents=True, exist_ok=True)
    order = (args.other, ROOT, ROOT, args.other) * max(args.rounds, 1)
    kept = [args.out.with_suffix(f".bound_dist{i}.pt")
            for i in range(len(order))]
    for root, keep in zip(order, kept):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--time",
             str(root.resolve()), "--keep", str(keep)], capture_output=True,
            text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode or 1
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        turn["which"] = "this" if root == ROOT else "other"
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    same = all(t["digest"] == turns[0]["digest"] for t in turns)
    # bound_dist: each checkout's bytes in all its turns, and the two
    # checkouts within rtol 2e-5
    outs = [torch.load(keep) for keep in kept[:2]]
    for keep in kept:
        keep.unlink()
    first = {t["which"]: t["bound_dist_digest"] for t in reversed(turns)}
    bd_repeat = all(t["bound_dist_digest"] == first[t["which"]]
                    for t in turns)
    bd_rel = float(((outs[1].double() - outs[0].double()).abs()
                    / outs[0].double().abs().clamp(min=1e-30)).max())
    bd_close = bd_rel <= 2e-5
    same = same and bd_repeat and bd_close
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    args.out.write_text(json.dumps({
        "card": smi, "same": same, "bound_dist_repeatable": bd_repeat,
        "bound_dist_max_rel_diff": bd_rel, "turns": turns}, indent=1))
    print(smi)
    print(json.dumps({"same": same, "bound_dist_repeatable": bd_repeat,
                      "bound_dist_max_rel_diff": bd_rel}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
