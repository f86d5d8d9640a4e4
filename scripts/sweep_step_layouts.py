#!/usr/bin/env python3
"""Time the step kernels under other shared-memory layouts on one CUDA card.

    python3 scripts/sweep_step_layouts.py [--out FILE]

``bf_relax_step`` at the refine_dense shape (S=8192, J=32, z=256) and
``ktrop_relax_step`` at the levels shape (S=8192, k=10, z=256, from the
fused solve's state after 8 iterations), on ``chip_smoke``'s seeded road
inputs, each launched with the list slots and ring stages of every
layout in SLOTS x STAGES that fits a block, besides the one the launcher
chooses (``kernels/_build.py::step_layout``).  For each layout it prints
the blocks one SM holds (the CUDA occupancy query), the median of 9
CUDA-event timings and whether the output is the launcher's, byte for
byte; it writes the rows to FILE (default
``chiprun_out/sweep_step_layouts.json``) with the card's name and power
limit.  It needs one card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SLOTS = (8, 10, 12, 16)
STAGES = (3, 4, 5, 8)
SHAPE = (8192, 32, 256)  # (S, J, z) of refine_dense; levels shares S and z
LEVELS_K = 10


def sweep(torch, name, launch, layout_of, blocks_of, want, smem_of):
    """Rows for one kernel: each layout that fits, the chosen one first."""
    from repro_torch.kernels import _build

    import chip_smoke

    chosen = layout_of()[:2]
    rows = []
    layouts = [chosen] + [(sl, st) for sl in SLOTS for st in STAGES
                          if (sl, st) != chosen]
    for slots, stages in layouts:
        if smem_of(slots, stages) > _build.SMEM_LIMIT:
            continue
        got = launch(slots, stages)
        ms = chip_smoke.cuda_ms(torch, lambda: launch(slots, stages), 9)
        rows.append(dict(kernel=name, slots=slots, stages=stages,
                         chosen=(slots, stages) == chosen,
                         blocks_per_sm=blocks_of(slots, stages),
                         smem=smem_of(slots, stages), ms=ms,
                         same_bytes=bool(torch.equal(got, want))))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "sweep_step_layouts.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke  # inputs and timing; puts this checkout's src first
    from repro_torch.kernels import bf_relax, ktrop, ops

    if not torch.cuda.is_available():
        raise SystemExit("sweep_step_layouts: no CUDA card")
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    S, J, z = SHAPE
    adj, init, _, so, bn, cap = chip_smoke.road_inputs(torch, S, J, z, dev)
    jt = bf_relax.tile_width(J, z, bf_relax.step_smem)
    bf_lib = bf_relax._lib()

    def bf_launch(slots, stages):
        out = torch.empty_like(init)
        path = torch.empty((S, -(-J // jt)), dtype=torch.int32, device=dev)
        err = bf_lib.bf_relax_step(
            init.data_ptr(), adj.data_ptr(), so.data_ptr(), bn.data_ptr(),
            cap.data_ptr(), out.data_ptr(), path.data_ptr(), S, J, z, jt,
            slots, stages, stream)
        if err:
            raise RuntimeError(f"bf_relax_step launch failed: {err}")
        return out

    rows = sweep(
        torch, "bf_relax_step", bf_launch, lambda: bf_relax.step_layout(jt, z),
        lambda sl, st: bf_lib.bf_step_blocks_per_sm(z, jt, sl, st),
        bf_relax.relax_step(init, adj, so, bn, cap),
        lambda sl, st: bf_relax.layout_smem(jt, z, sl, st))
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 1)
    src = torch.randint(0, z, (S,), generator=gen, device=dev,
                        dtype=torch.int32)
    D = ops.ktrop_solve(adj, src, LEVELS_K, 8)
    del init, so, bn, cap
    kt_lib = ktrop._lib()

    def kt_launch(slots, stages):
        out = torch.empty_like(D)
        path = torch.empty((S,), dtype=torch.int32, device=dev)
        err = kt_lib.ktrop_relax_step(
            D.data_ptr(), adj.data_ptr(), out.data_ptr(), path.data_ptr(), S,
            LEVELS_K, z, slots, stages, stream)
        if err:
            raise RuntimeError(f"ktrop_relax_step launch failed: {err}")
        return out

    rows += sweep(
        torch, "ktrop_relax_step", kt_launch,
        lambda: ktrop.step_layout(LEVELS_K, z),
        lambda sl, st: kt_lib.ktrop_step_blocks_per_sm(LEVELS_K, z, sl, st),
        ktrop.relax_step(D, adj),
        lambda sl, st: ktrop.layout_smem(LEVELS_K, z, sl, st))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
    print(smi)
    ok = all(r["same_bytes"] for r in rows)
    print(json.dumps({"same_bytes": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
