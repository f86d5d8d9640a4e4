"""Depth fit of the LM cells' roofline terms.

The reference compiles two small unrolled variants of each LM cell
(L1, L2 layers) because XLA's cost analysis counts a scanned layer body
once; it fits

    cost(L) = a + b · L

per roofline term and extrapolates to the real depth.  The port's eager
trace (``launch.roofline.trace_costs``) counts every layer, so the fit
here is exact in FLOPs and bytes: it agrees with a full-depth trace of
the cell and needs only two shallow ones.  gemma3 keeps its local:global
period (L1, L2 = one and two periods).  Records are for one H100 holding
the whole cell (mesh "1").

    PYTHONPATH=src python -m repro_torch.launch.rooffit --out results/torch_rooffit.jsonl
"""

import argparse
import dataclasses
import importlib
import json

from repro_torch.configs.lm_family import lm_cells
from repro_torch.launch.roofline import HBM_BW, NVLINK_BW, RATES, trace_costs
from repro_torch.models import transformer as T
from repro_torch.models.common import DTypePolicy, LARGE_POLICY

LM_ARCHS = {
    "starcoder2-3b": ("repro_torch.configs.starcoder2_3b", DTypePolicy()),
    "deepseek-coder-33b": ("repro_torch.configs.deepseek_coder_33b", DTypePolicy()),
    "gemma3-27b": ("repro_torch.configs.gemma3_27b", DTypePolicy()),
    "deepseek-v3-671b": ("repro_torch.configs.deepseek_v3_671b", LARGE_POLICY),
    "moonshot-v1-16b-a3b": ("repro_torch.configs.moonshot_v1_16b_a3b", DTypePolicy()),
}

SHAPES = {
    "train_4k": dict(kind="train", seq=4_096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768, batch=32),
    "decode_32k": dict(kind="decode", seq=32_768, batch=128),
    "long_500k": dict(kind="decode", seq=524_288, batch=1),
}

SKIP_LONG = {"deepseek-coder-33b", "moonshot-v1-16b-a3b"}


def small_cfg(cfg: T.LMConfig, n_scan: int) -> T.LMConfig:
    """Same arch, n_scan layers after the dense ones, no MTP head;
    global:local pattern preserved modulo depth."""
    n_layers = cfg.n_dense_layers + n_scan
    return dataclasses.replace(
        cfg, n_layers=n_layers, unroll_layers=True, mtp_depth=0
    )


def trace_cell(cfg, policy, shape):
    """The registry's cell at ``shape`` for ``cfg``, traced: its Costs."""
    cell = next(c for c in lm_cells(cfg.name, cfg, policy, None)
                if c.shape == shape)
    return trace_costs(cell.step_fn, cell.arg_specs)


def fit_arch_shape(arch, shape, l1=1, l2=3):
    mod_name, policy = LM_ARCHS[arch]
    cfg0 = importlib.import_module(mod_name).CFG
    # preserve the local:global ratio at small depth (gemma3: 1 global per
    # `global_every`) — use multiples of the period where possible
    if cfg0.global_every is not None:
        l1, l2 = cfg0.global_every, 2 * cfg0.global_every
    r1 = trace_cell(small_cfg(cfg0, l1), policy, shape).roofline()
    r2 = trace_cell(small_cfg(cfg0, l2), policy, shape).roofline()
    L_full = cfg0.n_scan_layers

    def extrap(v1, v2):
        b = (v2 - v1) / (l2 - l1)
        a = v1 - b * l1
        return max(0.0, a + b * L_full)

    classes = sorted(set(r1.flops_by_class) | set(r2.flops_by_class))
    by_class = {c: extrap(r1.flops_by_class.get(c, 0.0),
                          r2.flops_by_class.get(c, 0.0)) for c in classes}
    rec = {
        "arch": arch, "shape": shape, "mesh": "1",
        "l1": l1, "l2": l2, "L_full": L_full,
        "flops": extrap(r1.flops, r2.flops),
        "flops_by_class": by_class,
        "hbm_bytes": extrap(r1.hbm_bytes, r2.hbm_bytes),
        "coll_bytes": extrap(r1.coll_bytes, r2.coll_bytes),
        "n_devices": 1,
        "points": {
            f"L{l1}": r1.as_dict(), f"L{l2}": r2.as_dict(),
        },
        "mtp_note": "MTP head excluded from fit (constant-depth term)",
    }
    rec["t_compute_s"] = sum(n / RATES[c] for c, n in by_class.items())
    rec["t_memory_s"] = rec["hbm_bytes"] / HBM_BW
    rec["t_collective_s"] = rec["coll_bytes"] / NVLINK_BW
    terms = {
        "compute": rec["t_compute_s"],
        "memory": rec["t_memory_s"],
        "collective": rec["t_collective_s"],
    }
    rec["dominant"] = max(terms, key=terms.get)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--out", default="results/torch_rooffit.jsonl")
    args = ap.parse_args()
    archs = args.arch or list(LM_ARCHS)
    with open(args.out, "a") as out:
        for arch in archs:
            for shape in (args.shape or list(SHAPES)):
                if shape == "long_500k" and arch in SKIP_LONG:
                    continue
                try:
                    rec = fit_arch_shape(arch, shape)
                    print(
                        f"FIT {arch}×{shape} {rec['mesh']} "
                        f"Tc={rec['t_compute_s']:.3e} "
                        f"Tm={rec['t_memory_s']:.3e} "
                        f"Tcoll={rec['t_collective_s']:.3e} "
                        f"dom={rec['dominant']}",
                        flush=True,
                    )
                except Exception as e:  # noqa: BLE001
                    rec = {
                        "arch": arch, "shape": shape, "mesh": "1",
                        "error": f"{type(e).__name__}: {e}"[:300],
                    }
                    print(f"ERR {arch}×{shape} {rec['error'][:100]}",
                          flush=True)
                out.write(json.dumps(rec) + "\n")
                out.flush()


if __name__ == "__main__":
    main()
