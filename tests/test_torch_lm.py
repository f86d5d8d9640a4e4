"""The port's LM transformer (``repro_torch.models``) against the
reference (``repro.models``) on the same inputs, for the five SMOKE
configurations.

Tolerances, stated once:

- float32 functions (rope, the norms, the loss given bf16 hidden states
  and head): rtol 1e-5 — the same float32 operations, up to the last bits
  of transcendental functions and summation order;
- bf16 logits: atol 5e-2, the reference's own decode bound
  (``tests/test_serve.py``); greedy tokens must agree wherever the
  reference's top-2 margin exceeds twice that;
- bf16 hidden states, attention and FFN outputs, which are not
  normalised (up to ~40 in the MoE stacks): atol 5e-2 plus 2**-6 (two
  bf16 ulps) of the largest magnitude in the row — XLA and PyTorch round
  silu, gelu and the products' sums differently by an ulp, and a sum of
  bf16 terms (the MoE combine) carries the rounding of its largest term;
- whole-model losses of the dense configs: rtol 1e-3.  MoE routing is
  discontinuous: an ulp of the attention output can move a token whose
  top-k scores nearly tie to another expert, and with it other tokens
  over an expert's capacity — on these 128-token batches that happens
  in about every other MoE layer, even fed the reference's layer input.
  So the MoE stacks are held function by function on the same inputs
  (attention, ``moe_ffn``, the decode step), and end to end only through
  their losses: within 5e-2 nats (under 1% of ln V), the aux loss
  (about 0.05) within 1e-3.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import (deepseek_coder_33b, deepseek_v3_671b, gemma3_27b,
                           moonshot_v1_16b_a3b, starcoder2_3b)
from repro.models import common as RC
from repro.models import transformer as RT
from repro_torch.configs import deepseek_coder_33b as p_coder
from repro_torch.configs import deepseek_v3_671b as p_v3
from repro_torch.configs import gemma3_27b as p_gemma
from repro_torch.configs import moonshot_v1_16b_a3b as p_moon
from repro_torch.configs import starcoder2_3b as p_sc2
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from tests._torch_threads import one_torch_thread  # noqa: F401

LOGIT_ATOL = 5e-2
HIDDEN_RTOL = 2.0 ** -6
LOSS_RTOL = 1e-3
MOE_LOSS_ATOL = 5e-2
F32_RTOL = 1e-5

PAIRS = {  # name -> (reference SMOKE, port SMOKE)
    "starcoder2": (starcoder2_3b.SMOKE, p_sc2.SMOKE),
    "gemma3": (gemma3_27b.SMOKE, p_gemma.SMOKE),
    "coder33b": (deepseek_coder_33b.SMOKE, p_coder.SMOKE),
    "moonshot": (moonshot_v1_16b_a3b.SMOKE, p_moon.SMOKE),
    "dsv3": (deepseek_v3_671b.SMOKE, p_v3.SMOKE),
}
DENSE = ["starcoder2", "gemma3", "coder33b"]
MOE = ["moonshot", "dsv3"]
B, S = 2, 64


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def to_t(x):
    return tree_from_numpy(jax.tree.map(np.asarray, x), "cpu")


def assert_hidden_close(got, want):
    g, w = f32(got), f32(want)
    assert g.shape == w.shape
    bound = LOGIT_ATOL + HIDDEN_RTOL * np.abs(w).max(-1, keepdims=True)
    err = np.abs(g - w)
    assert (err <= bound).all(), (
        f"{(err > bound).sum()} of {err.size} over the bound; worst "
        f"{err.max()} where the bound is {bound.min()}..{bound.max()}")


def bf16_inputs(rng, shape, scale=1.0):
    """The same bf16 values for both packages."""
    x = jnp.asarray(rng.normal(size=shape) * scale, jnp.bfloat16)
    return x, to_t(x)


def ref(fn, **static):
    """A reference function, jitted with ``static`` bound (one compile
    is faster than JAX's op-by-op dispatch)."""
    return jax.jit(functools.partial(fn, **static))


def to_j(tree):
    """Port tensors as the reference's arrays (bf16 kept)."""
    return jax.tree.map(jnp.asarray, tree_to_numpy(tree, bf16=jnp.bfloat16))


@functools.lru_cache(maxsize=None)
def model(name):
    """(ref cfg, port cfg, ref params, port params, tokens) per config:
    one set of weights (the port's init from seed 0) in both packages."""
    rcfg, pcfg = PAIRS[name]
    pp = T.init_lm(0, pcfg, C.DEFAULT_POLICY, device="cpu")
    rp = to_j(pp)
    toks = np.random.default_rng(0).integers(0, rcfg.vocab, (B, S)).astype(
        np.int32)
    return rcfg, pcfg, rp, pp, toks


def layer_params(name, i):
    """Layer i's bf16 compute params (reference tree, port tree); the
    float32 → bf16 cast rounds to nearest even in both packages."""
    _, pcfg, _, pp, _ = model(name)
    lpt = T._cast_layer(T._layer_params(pp, pcfg, i))
    return to_j(lpt), lpt


def test_configs_are_copies():
    for rcfg, pcfg in PAIRS.values():
        assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)


def test_float32_functions():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        f32(T.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)),
        f32(RT.rope(x, pos, 1e4)), rtol=F32_RTOL, atol=1e-5)
    g = rng.normal(size=16).astype(np.float32)
    b = rng.normal(size=16).astype(np.float32)
    xt, gt, bt = map(torch.from_numpy, (x, g, b))
    np.testing.assert_allclose(f32(C.rms_norm(xt, gt, 1e-6)),
                               f32(RC.rms_norm(x, g, 1e-6)), rtol=F32_RTOL)
    np.testing.assert_allclose(f32(C.layer_norm(xt, gt, bt)),
                               f32(RC.layer_norm(x, g, b)), rtol=F32_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(f32(C.gelu(xt)), f32(RC.gelu(x)), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["starcoder2", "dsv3"])
def test_ce_loss_given_hidden_and_head(name):
    rcfg, pcfg, rp, pp, toks = model(name)
    rng = np.random.default_rng(2)
    h, ht = bf16_inputs(rng, (B, S, rcfg.d_model))
    head = RT._unembed(rp, rcfg).astype(jnp.bfloat16)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    want = ref(RT.chunked_ce_loss, cfg=rcfg)(h, toks, mask, head)
    got = T.chunked_ce_loss(ht, torch.from_numpy(toks), torch.from_numpy(mask),
                            T._unembed(pp, pcfg).to(torch.bfloat16), pcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=F32_RTOL)


@pytest.mark.parametrize("policy", ["default", "large"])
def test_init_matches_reference_tree(policy):
    """The port's own init: the reference's keys, shapes and dtypes;
    truncated at 2 scales; fan-in scale."""
    rpol = RC.DEFAULT_POLICY if policy == "default" else RC.LARGE_POLICY
    ppol = C.DEFAULT_POLICY if policy == "default" else C.LARGE_POLICY
    rcfg, pcfg = PAIRS["dsv3"]
    want = jax.eval_shape(lambda: RT.init_lm(jax.random.PRNGKey(0), rcfg, rpol))
    got = T.init_lm(torch.Generator().manual_seed(0), pcfg, ppol, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == len(C.tree_leaves(got))
    for (path, spec), leaf in zip(flat_w, C.tree_leaves(got)):
        assert tuple(leaf.shape) == spec.shape, path
        assert str(leaf.dtype).split(".")[-1] == str(spec.dtype), path
    wq = got["layers"]["attn"]["wq_a"].float()
    scale = 1 / np.sqrt(pcfg.d_model)
    assert float(wq.abs().max()) <= 2 * scale * (1 + 2 ** -7)
    assert 0.7 * scale < float(wq.std()) < 1.0 * scale
    assert C.count_params(got) == pcfg.param_count()
    meta = T.init_lm(0, pcfg, ppol, device="meta")
    assert C.count_params(meta) == pcfg.param_count()


@pytest.mark.parametrize("name", list(PAIRS))
def test_attention(name):
    """Layer 0's attention (windowed where the config's layer 0 is
    local) over 40 positions: a full query chunk and a short one; GQA
    also with ``gqa_grouped`` flipped."""
    rcfg, pcfg, _, _, _ = model(name)
    rng = np.random.default_rng(3)
    x, xt = bf16_inputs(rng, (B, 40, rcfg.d_model))
    lp, lpt = layer_params(name, 0)
    window = None if rcfg.layer_is_global()[0] else rcfg.window
    variants = [(rcfg, pcfg)]
    if rcfg.mla is None:
        variants.append(tuple(dataclasses.replace(c, gqa_grouped=True)
                              for c in (rcfg, pcfg)))
    fr, ft = ((RT.mla_attention, T.mla_attention) if rcfg.mla is not None
              else (RT.gqa_attention, T.gqa_attention))
    for rc, pc in variants:
        want = ref(fr, cfg=rc, window=window)(x, lp["attn"],
                                              positions=jnp.arange(40))
        got = ft(xt, lpt["attn"], pc, window=window,
                 positions=torch.arange(40))
        assert_hidden_close(got, want)


@pytest.mark.parametrize("name", list(PAIRS))
def test_ffn(name):
    """dense_ffn on a dense layer; moe_ffn under the config's router at
    its own capacity factor and at 0.5 (capacity drops)."""
    rcfg, pcfg, _, _, _ = model(name)
    rng = np.random.default_rng(4)
    x, xt = bf16_inputs(rng, (B, S, rcfg.d_model))
    lp, lpt = layer_params(name, 0)
    assert_hidden_close(T.dense_ffn(xt, lpt["ffn"]),
                        ref(RT.dense_ffn)(x, lp["ffn"]))
    if rcfg.moe is None:
        return
    lp, lpt = layer_params(name, rcfg.n_layers - 1)
    for cf in (rcfg.moe.capacity_factor, 0.5):
        rc = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=cf))
        pc = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, capacity_factor=cf))
        want, aux_w = ref(RT.moe_ffn, cfg=rc)(x, lp["ffn"])
        got, aux_g = T.moe_ffn(xt, lpt["ffn"], pc)
        assert_hidden_close(got, want)
        np.testing.assert_allclose(float(aux_g), float(aux_w), rtol=F32_RTOL)
    # at 0.5 the busiest expert is over its capacity: some tokens dropped
    logits = f32(x).reshape(-1, rcfg.d_model) @ f32(lp["ffn"]["router"])
    top = np.argsort(-logits, axis=-1)[:, :rcfg.moe.top_k]
    cap = int(np.ceil(B * S * rcfg.moe.top_k * 0.5 / rcfg.moe.n_experts))
    assert np.bincount(top.ravel(), minlength=rcfg.moe.n_experts).max() > cap


@pytest.mark.parametrize("name", list(PAIRS))
def test_layers_on_the_reference_inputs(name):
    """Every layer of the stack, fed the reference's input to it."""
    rcfg, pcfg, rp, pp, toks = model(name)
    x = rp["embed"].astype(jnp.bfloat16)[toks]
    g = rcfg.layer_is_global()
    for i in range(rcfg.n_layers):
        moe = rcfg.moe is not None and i >= rcfg.n_dense_layers
        lp, lpt = layer_params(name, i)
        want, _ = ref(RT._layer_fwd, cfg=rcfg, is_moe=moe,
                      is_global=bool(g[i]))(x, lp, positions=jnp.arange(S))
        if not moe:  # MoE layers: test_attention and test_ffn
            got, _ = T._layer_fwd(to_t(x), lpt, pcfg, is_moe=False,
                                  is_global=bool(g[i]),
                                  positions=torch.arange(S))
            assert_hidden_close(got, want)
        x = want


@pytest.mark.parametrize("name", list(PAIRS))
def test_backbone_logits_and_loss(name):
    rcfg, pcfg, rp, pp, toks = model(name)

    @jax.jit
    def ref(p, t):
        h, _ = RT.lm_backbone(p, t, rcfg)
        logits = h @ RT._unembed(p, rcfg).astype(jnp.bfloat16)
        batch = {"tokens": t, "loss_mask": jnp.ones(t.shape, jnp.float32)}
        return logits, RT.lm_loss(p, batch, rcfg)[1]

    want, want_m = ref(rp, toks)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        h, _ = T.lm_backbone(pp, tt, pcfg)
        got = h @ T._unembed(pp, pcfg).to(torch.bfloat16)
        _, got_m = T.lm_loss(pp, {"tokens": tt,
                                  "loss_mask": torch.ones(B, S)}, pcfg)
        last = T.lm_prefill(pp, tt, pcfg)
    np.testing.assert_array_equal(f32(last), f32(got[:, -1]))
    assert set(got_m) == set(want_m)
    for k in want_m:
        if rcfg.moe is None:
            tol = dict(rtol=LOSS_RTOL, atol=1e-6)
        else:
            tol = dict(atol=1e-3 if k == "aux" else MOE_LOSS_ATOL)
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), **tol)
    if rcfg.moe is None:
        np.testing.assert_allclose(f32(got), f32(want), atol=LOGIT_ATOL)
        _check_greedy(got, want)


def _check_greedy(got, want):
    """Argmax equal wherever the reference's top-2 margin > 2·atol."""
    w = f32(want)
    top2 = np.sort(w, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_ATOL
    assert sure.any()
    np.testing.assert_array_equal(f32(got).argmax(-1)[sure],
                                  w.argmax(-1)[sure])


@pytest.mark.parametrize("name", DENSE)
def test_decode_ring_cache(name):
    """Stacked-cache decode over 24 positions into a 16-slot ring (it
    wraps; windowed configs also mask), per-slot positions staggered."""
    rcfg, pcfg, rp, pp, toks = model(name)
    step_r = jax.jit(functools.partial(RT.lm_decode_step, cfg=rcfg))
    cache_r = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                           RT.cache_spec(rcfg, B, 16))
    cache_p = T.init_cache(T.cache_spec(pcfg, B, 16), "cpu")
    offset = np.array([0, 3])
    got, want = [], []
    for t in range(24):
        pos = (t + offset).astype(np.int32)
        tk = toks[:, t:t + 1]
        lr, cache_r = step_r(rp, cache_r, tk, pos)
        lp_, cache_p = T.lm_decode_step(pp, cache_p, torch.from_numpy(tk),
                                        torch.from_numpy(pos), pcfg)
        want.append(f32(lr))
        got.append(f32(lp_))
    got, want = np.stack(got), np.stack(want)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)
    _check_greedy(got, want)
    for k in cache_r:
        np.testing.assert_allclose(f32(cache_p[k]), f32(cache_r[k]),
                                   rtol=HIDDEN_RTOL, atol=LOGIT_ATOL)


@pytest.mark.parametrize("name", list(PAIRS))
def test_decode_step_per_layer(name):
    """The first and the last layer's decode step on the same inputs (a
    local and a global layer for gemma3, a dense and an MoE layer for the
    MoE configs): a ring cache of random entries, positions past its
    length (the slot wraps), per-slot positions; MoE layers route the
    two tokens with capacity 1."""
    rcfg, pcfg, _, _, _ = model(name)
    rng = np.random.default_rng(5)
    spec = RT.cache_spec(rcfg, B, 8)
    cache = {k: jnp.asarray(rng.normal(size=s.shape[1:]), jnp.bfloat16)
             for k, s in spec.items()}
    x, xt = bf16_inputs(rng, (B, 1, rcfg.d_model))
    pos = np.array([5, 13], np.int32)
    g = rcfg.layer_is_global()
    fr, ft = ((RT.decode_step_mla, T.decode_step_mla)
              if rcfg.mla is not None else
              (RT.decode_step_gqa, T.decode_step_gqa))
    for i in (0, rcfg.n_layers - 1):
        lp, lpt = layer_params(name, i)
        window = None if g[i] else rcfg.window
        want, cw = ref(fr, cfg=rcfg, window=window)(x, lp, cache, pos=pos)
        got, cg = ft(xt, lpt, to_t(cache), pcfg, pos=torch.from_numpy(pos),
                     window=window)
        assert_hidden_close(got, want)
        for k in cw:
            assert_hidden_close(cg[k], cw[k])


def test_remat_gives_the_same_gradients():
    _, pcfg, _, pp, toks = model("gemma3")
    batch = {"tokens": torch.from_numpy(toks), "loss_mask": torch.ones(B, S)}
    grads = []
    for remat in (True, False):
        cfg = dataclasses.replace(pcfg, remat=remat)
        p = C.tree_map(lambda a: a.clone().requires_grad_(True), pp)
        loss, _ = T.lm_loss(p, batch, cfg)
        grads.append(torch.autograd.grad(loss, C.tree_leaves(p)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mixed_cache_specs_match_reference():
    rcfg, pcfg = PAIRS["gemma3"]
    for r, p in zip(RT.cache_spec_mixed(rcfg, 3, 40),
                    T.cache_spec_mixed(pcfg, 3, 40)):
        assert {k: s.shape for k, s in r.items()} == \
            {k: s.shape for k, s in p.items()}
    assert RT.cache_axes_mixed(rcfg) == T.cache_axes_mixed(pcfg)
    assert RT.lm_axes(rcfg) == T.lm_axes(pcfg)
    rcfg, pcfg = PAIRS["dsv3"]
    assert {k: s.shape for k, s in RT.cache_spec(rcfg, 2, 9).items()} == \
        {k: s.shape for k, s in T.cache_spec(pcfg, 2, 9).items()}
    assert RT.cache_axes(rcfg) == T.cache_axes(pcfg)
    assert RT.lm_axes(rcfg) == T.lm_axes(pcfg)
