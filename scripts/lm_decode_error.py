#!/usr/bin/env python3
"""How far apart the LM's two bf16 evaluations are on one CUDA card.

    python3 scripts/lm_decode_error.py [--layers 2 8 30]

starcoder2-3b at full width (``chip_smoke``'s seeded weights, cut to each
depth in ``--layers`` by taking the first layers of the stack) on a
128-token prompt: the logits of the teacher-forced decode (one token per
step, ``lm_decode_step``) and of the full forward (``lm_backbone`` +
unembed), each also against a float32 forward of the same bf16-rounded
weights (the model's bf16 casts switched off for that one call).  For
each depth it prints the 50th, 99th and 99.99th percentiles (of 2M
sampled logits) and the largest |difference| of each pair, with the
card's name and power limit.  It needs one card; without one it exits
non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROMPT = 128


def forward(torch, T, params, cfg, tokens):
    with torch.no_grad():
        h, _ = T.lm_backbone(params, tokens[None], cfg)
        return (h[0] @ T._unembed(params, cfg).to(h.dtype)).float()


def decode(torch, T, params, cfg, tokens, dev):
    cache = T.init_cache(T.cache_spec(cfg, 1, cfg.window), dev)
    out = []
    for pos in range(len(tokens)):
        lg, cache = T.lm_decode_step(params, cache, tokens[pos].view(1, 1),
                                     pos, cfg)
        out.append(lg[0].float())
    return torch.stack(out)


def float32_forward(torch, T, params, cfg, tokens):
    """The forward in float32 on the same (bf16-rounded) weights."""
    from repro_torch.models.common import tree_map

    saved = T.BF16, T._cast_layer
    T.BF16, T._cast_layer = torch.float32, lambda lp, dtype=None: lp
    try:
        return forward(torch, T, tree_map(lambda a: a.float(), params), cfg,
                       tokens)
    finally:
        T.BF16, T._cast_layer = saved


def spread(torch, x):
    x = x.abs().flatten().double()
    pick = torch.randperm(x.numel(), device=x.device)[:2_000_000]
    qs = torch.quantile(x[pick], torch.tensor([0.5, 0.99, 0.9999],
                                              device=x.device,
                                              dtype=torch.float64))
    return [round(float(v), 5) for v in qs] + [round(float(x.max()), 5)]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("lm_decode_error: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import starcoder2_3b
    from repro_torch.models import transformer as T
    from repro_torch.models.common import DEFAULT_POLICY, tree_map

    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 8, 30])
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    cfg = starcoder2_3b.CFG
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.compute_copy(T.init_lm(gen, cfg, DEFAULT_POLICY, device=dev))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, PROMPT)).to(dev)
    for n in args.layers:
        c = dataclasses.replace(cfg, n_layers=n)
        p = dict(params, layers=tree_map(lambda a: a[:n], params["layers"]))
        fwd = forward(torch, T, p, c, prompt)
        dec = decode(torch, T, p, c, prompt, dev)
        f32 = float32_forward(torch, T, p, c, prompt)
        print(f"{n} layers: |decode - forward| {spread(torch, dec - fwd)}; "
              f"|forward - float32| {spread(torch, fwd - f32)}; "
              f"|decode - float32| {spread(torch, dec - f32)} "
              f"(50th, 99th, 99.99th percentile, max); |logit| <= "
              f"{float(fwd.abs().max()):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
