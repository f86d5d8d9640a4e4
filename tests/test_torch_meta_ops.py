"""The kernel wrappers' shapes-only path (``kernels/ops.py`` on meta
tensors).

A meta tensor is the caller's choice of "shapes only": each wrapper
returns empty meta outputs of its plain version's shapes and dtypes (the
plain versions run here on the CPU at the same ragged shapes), reports
its cost to the active sinks (each input read once, each output written
once, the reference's min-plus count at the iteration budget) and
launches and counts nothing.  The JAX package's wrappers have no meta
path to compare with; the cost convention is the reference's
``model_flops`` (``repro/launch/report.py``)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

S, J, K, Z = 3, 5, 4, 37  # ragged: z % 4 != 0
B, E = 300, 29
W = 7  # level walks


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    adj = rng.uniform(1, 9, (S, Z, Z)).astype(np.float32)
    adj[rng.random((S, Z, Z)) > 0.3] = ops.INF
    for s in range(S):
        np.fill_diagonal(adj[s], 0.0)
    dist = np.full((S, J, Z), ops.INF, np.float32)
    dist[:, :, 0] = 0.0
    masks = [rng.random((S, J, Z)) < 0.1 for _ in range(3)]
    cap = rng.uniform(20, 80, (S, J)).astype(np.float32)
    w = np.sort(rng.uniform(1, 9, (S, E)).astype(np.float32), axis=1)
    n = rng.integers(0, 4, (S, E)).astype(np.float32)
    cb = np.cumsum(n, axis=1) - n
    sub = rng.integers(0, S, B).astype(np.int32)
    phi = rng.uniform(0, 40, B).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in dict(
        adj=adj, dist=dist, bv=masks[0], so=masks[1], bn=masks[2], cap=cap,
        w=w, n=n, cb=cb, sub=sub, phi=phi).items()}
    t["src"] = torch.zeros(S, dtype=torch.int32)
    t["D"] = ops.ktrop_solve(t["adj"], t["src"], K, max_iters=3)
    # one subgraph's in-edges (adj[0]'s finite entries) and W walks
    u, v = np.nonzero((adj[0] < ops.INF) & ~np.eye(Z, dtype=bool))
    order = np.lexsort((u, v))
    u, v = u[order], v[order]
    t.update({k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in dict(
        lw_sub=np.zeros(S, np.int32), lw_max_len=np.full(S, Z, np.int32),
        lw_ptr=np.concatenate([[0], np.cumsum(np.bincount(v, minlength=Z))]
                              ).astype(np.int32)[None],
        lw_src=u.astype(np.int32), lw_w=adj[0][u, v],
        lw_eid=np.arange(u.shape[0], dtype=np.int32),
        lw_walk_ptr=np.array([0, 3, 5, W], np.int32),
        lw_dst=rng.integers(1, Z, W).astype(np.int32),
        lw_level=rng.integers(1, 30, W).astype(np.float32)).items()})
    return t


def _meta(x):
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


def _calls(t):
    """(kernel, call on a dict of inputs, bytes, min-plus operations)."""
    n_sjz, n_adj, n_skz = S * J * Z, S * Z * Z, S * K * Z
    n_in = t["lw_src"].shape[0]
    return [
        ("bf_relax_step",
         lambda a: ops.bf_relax_step(a["dist"], a["adj"], a["so"], a["bn"],
                                     a["cap"]),
         4 * (2 * n_sjz + n_adj + S * J) + 2 * n_sjz,
         2.0 * S * J * Z * Z),
        ("bf_solve_grouped",
         lambda a: ops.bf_solve_grouped(a["adj"], a["dist"], a["bv"],
                                        a["so"], a["bn"], a["cap"],
                                        max_iters=7, with_iters=True),
         4 * (n_adj + n_sjz + S * J) + 3 * n_sjz + 8 * n_sjz + 4 * S,
         2.0 * S * J * Z * Z * 7),
        ("bf_solve_grouped",
         lambda a: ops.bf_solve_grouped(a["adj"], a["dist"], a["bv"],
                                        a["so"], a["bn"], a["cap"]),
         4 * (n_adj + n_sjz + S * J) + 3 * n_sjz + 8 * n_sjz,
         2.0 * S * J * Z * Z * Z),
        ("ktrop_relax_step",
         lambda a: ops.ktrop_relax_step(a["D"], a["adj"]),
         4 * (2 * n_skz + n_adj), 2.0 * S * K * Z * Z),
        ("ktrop_solve",
         lambda a: ops.ktrop_solve(a["adj"], a["src"], K, max_iters=5,
                                   with_iters=True),
         4 * (n_adj + S + n_skz) + 4 * S, 2.0 * S * K * Z * Z * 5),
        ("ktrop_solve",
         lambda a: ops.ktrop_solve(a["adj"], a["src"], K),
         4 * (n_adj + S + n_skz), 2.0 * S * K * Z * Z * (Z * K + 8)),
        ("bound_dist",
         lambda a: ops.bound_dist(a["w"], a["n"], a["cb"], a["sub"],
                                  a["phi"]),
         4 * (3 * S * E + 3 * B), 2.0 * B * E),
        ("level_walks",
         lambda a: ops.level_walks(a["D"], a["lw_sub"], a["src"],
                                   a["lw_max_len"], a["lw_ptr"], a["lw_src"],
                                   a["lw_w"], a["lw_eid"], a["lw_walk_ptr"],
                                   a["lw_dst"], a["lw_level"]),
         4 * (n_skz + 3 * S + (Z + 1) + 3 * n_in + S + 1 + 2 * W)
         + 4 * (2 * W * Z + W), 0.0),
    ]


def _flat(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("i", range(8))
def test_meta_outputs_and_cost(i):
    t = _inputs()
    name, call, n_bytes, n_ops = _calls(t)[i]
    plain = _flat(call(t))
    seen = []
    ops.reset_launches()
    ops.COST_SINKS.append(lambda *c: seen.append(c))
    try:
        got = _flat(call({k: _meta(v) for k, v in t.items()}))
    finally:
        ops.COST_SINKS.pop()
    assert [(g.device.type, g.shape, g.dtype) for g in got] == \
        [("meta", p.shape, p.dtype) for p in plain]
    assert seen == [(name, n_bytes, n_ops)]
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_blocked_bound_dist_on_meta():
    t = _inputs()
    blocks = -(-B // ops.BOUND_DIST_BLOCK)
    sub_b = torch.zeros(blocks, dtype=torch.int32)
    plain = ops.bound_dist_blocked(t["w"], t["n"], t["cb"], sub_b, t["phi"])
    seen = []
    ops.COST_SINKS.append(lambda *c: seen.append(c))
    try:
        got = ops.bound_dist_blocked(_meta(t["w"]), _meta(t["n"]),
                                     _meta(t["cb"]), _meta(sub_b),
                                     _meta(t["phi"]))
    finally:
        ops.COST_SINKS.pop()
    assert (got.device.type, got.shape, got.dtype) == ("meta", plain.shape,
                                                       plain.dtype)
    assert seen == [("bound_dist", 4 * (3 * S * E + 3 * B), 2.0 * B * E)]


def test_meta_without_sinks_reports_nothing_and_runs():
    """Without a trace the meta path still returns its shapes."""
    t = _inputs()
    out = ops.bf_relax_step(_meta(t["dist"]), _meta(t["adj"]),
                            _meta(t["so"]), _meta(t["bn"]))
    assert out.shape == (S, J, Z) and out.device.type == "meta"
