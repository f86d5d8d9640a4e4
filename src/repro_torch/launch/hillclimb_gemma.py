"""Hill-climb D: gemma3-27b decode — uniform full-length KV caches vs
mixed per-layer ring caches (52/62 local layers hold only 1024 slots).

Napkin math (the reference's): cache reads dominate decode Tm; local
layers drop from 32768 to 1024 slots → Tm_new/Tm_old ≈ (10·32768 +
52·1024)/(62·32768) ≈ 0.186 → ~5.4× predicted.

Traced (``launch.roofline.trace_costs`` on meta tensors): both caches at
the decode_32k and long_500k shapes, fit at L=6 and L=12 (one and two
local:global periods) and extrapolated to 62 layers, as the reference
fits them.  On the card (``--device cuda``, the default; no card fails)
the driver also measures both decode steps at 6 layers, batch
``MEASURE_BATCH`` and ``MEASURE_SEQ`` cache positions (seeded weights,
zeroed caches, the last position), and prints the measured ratio beside
the traced one at that shape.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb_gemma [--device cpu]
"""

import argparse
import dataclasses
import functools
import json
import statistics

import torch

from repro_torch.configs.base import TensorSpec, spec_tree
from repro_torch.configs.gemma3_27b import CFG
from repro_torch.dist.cluster import resolve_device
from repro_torch.launch.roofline import trace_costs
from repro_torch.models import transformer as T
from repro_torch.models.common import DTypePolicy

SHAPES = {"decode_32k": (128, 32_768), "long_500k": (1, 524_288)}
FIT_LAYERS = (6, 12)
MEASURE_LAYERS, MEASURE_BATCH, MEASURE_SEQ = 6, 8, 32_768


def decode_specs(cfg, mixed: bool, batch: int, seq: int):
    p_specs = spec_tree(T.init_lm(0, cfg, DTypePolicy(), device="meta"))
    c_specs = (T.cache_spec_mixed(cfg, batch, seq) if mixed
               else T.cache_spec(cfg, batch, seq))
    return (p_specs, c_specs, TensorSpec((batch, 1), torch.int32),
            TensorSpec((), torch.int32))


def trace_decode(cfg, mixed: bool, batch: int, seq: int):
    step = functools.partial(T.lm_decode_step, cfg=cfg)
    return trace_costs(step, decode_specs(cfg, mixed, batch, seq)).roofline()


def fit_decode(mixed: bool, batch: int, seq: int) -> dict:
    L1, L2 = FIT_LAYERS
    terms = {L: trace_decode(dataclasses.replace(CFG, n_layers=L,
                                                 unroll_layers=True,
                                                 mtp_depth=0),
                             mixed, batch, seq)
             for L in FIT_LAYERS}
    Lf = CFG.n_layers

    def extrap(a, b):
        slope = (b - a) / (L2 - L1)
        return max(0.0, a + slope * (Lf - L1))

    return {
        "t_compute_s": extrap(terms[L1].t_compute, terms[L2].t_compute),
        "t_memory_s": extrap(terms[L1].t_memory, terms[L2].t_memory),
        "t_collective_s": extrap(terms[L1].t_collective,
                                 terms[L2].t_collective),
        "hbm_bytes": extrap(terms[L1].hbm_bytes, terms[L2].hbm_bytes),
    }


def measure_decode(device, mixed: bool, repeats: int = 5) -> dict:
    """Median CUDA-event ms of the 6-layer decode step and the peak
    memory above what was allocated before its weights were made."""
    cfg = dataclasses.replace(CFG, n_layers=MEASURE_LAYERS)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_lm(gen, cfg, DTypePolicy(), device=device)
    _, c_specs, _, _ = decode_specs(cfg, mixed, MEASURE_BATCH, MEASURE_SEQ)
    cache = T.init_cache(c_specs, device)
    tokens = torch.randint(0, cfg.vocab, (MEASURE_BATCH, 1), generator=gen,
                           device=device, dtype=torch.int32)
    pos = torch.tensor(MEASURE_SEQ - 1, dtype=torch.int32, device=device)
    T.lm_decode_step(params, cache, tokens, pos, cfg)  # warm-up
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, _ = T.lm_decode_step(params, cache, tokens, pos, cfg)
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end))
    if not bool(torch.isfinite(logits.float()).all()):
        raise RuntimeError("non-finite decode logits")
    peak = torch.cuda.max_memory_allocated(device) - base
    del params, cache, logits
    torch.cuda.empty_cache()
    return {"ms": statistics.median(times), "peak_bytes": peak}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (default: traces and measures; no card "
                         "fails) or the CPU (traces only)")
    ap.add_argument("--out", default="results/torch_hillclimb_D.jsonl")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    with open(args.out, "a") as out:
        for shape, (batch, seq) in SHAPES.items():
            recs = {}
            for mixed in (False, True):
                rec = dict(shape=shape, mixed=mixed,
                           **fit_decode(mixed, batch, seq))
                print(
                    f"{shape} mixed={mixed}: Tc={rec['t_compute_s']:.3e} "
                    f"Tm={rec['t_memory_s']:.3e} "
                    f"Tcoll={rec['t_collective_s']:.3e}",
                    flush=True,
                )
                out.write(json.dumps(rec) + "\n")
                recs[mixed] = rec
            gain = recs[False]["t_memory_s"] / max(recs[True]["t_memory_s"],
                                                   1e-12)
            print(f"{shape}: mixed-cache Tm gain = {gain:.2f}x (traced, "
                  f"{CFG.n_layers} layers)", flush=True)
        if dev.type != "cuda":
            return
        cfg = dataclasses.replace(CFG, n_layers=MEASURE_LAYERS)
        traced = {m: trace_decode(cfg, m, MEASURE_BATCH, MEASURE_SEQ)
                  for m in (False, True)}
        measured = {m: measure_decode(dev, m) for m in (False, True)}
        for m in (False, True):
            rec = dict(shape=f"B={MEASURE_BATCH} seq={MEASURE_SEQ}",
                       mixed=m, layers=MEASURE_LAYERS,
                       measured_ms=measured[m]["ms"],
                       peak_bytes=measured[m]["peak_bytes"],
                       t_memory_s=traced[m].t_memory,
                       device=torch.cuda.get_device_name(dev))
            out.write(json.dumps(rec) + "\n")
        print(f"measured at {MEASURE_LAYERS} layers, B={MEASURE_BATCH}, "
              f"{MEASURE_SEQ} positions on {torch.cuda.get_device_name(dev)}"
              f": uniform {measured[False]['ms']:.3f} ms (peak "
              f"{measured[False]['peak_bytes'] / 1e9:.2f} GB), mixed "
              f"{measured[True]['ms']:.3f} ms (peak "
              f"{measured[True]['peak_bytes'] / 1e9:.2f} GB): measured gain "
              f"{measured[False]['ms'] / measured[True]['ms']:.2f}x, traced "
              f"Tm gain {traced[False].t_memory / traced[True].t_memory:.2f}x "
              f"({traced[False].t_memory * 1e3:.3f} vs "
              f"{traced[True].t_memory * 1e3:.3f} ms)", flush=True)


if __name__ == "__main__":
    main()
