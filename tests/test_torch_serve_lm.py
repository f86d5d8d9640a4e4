"""LM serving in the port: twins of ``tests/test_serve.py`` (decode-vs-
forward consistency, the continuous-batching server, MLA decode parity,
mixed-window caches) on ``repro_torch``, and the port's ``DecodeServer``
against the reference's on the same weights and requests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as RT
from repro.serve.engine import DecodeServer as RefServer
from repro.serve.engine import Request as RefRequest
from repro_torch.convert import tree_to_numpy
from repro_torch.models import transformer as T
from repro_torch.models.common import DEFAULT_POLICY
from repro_torch.serve.engine import DecodeServer, Request
from tests._torch_threads import one_torch_thread  # noqa: F401

LOGIT_ATOL = 5e-2  # the reference's decode bound (tests/test_serve.py)


@pytest.fixture(scope="module")
def tiny():
    cfg = T.LMConfig(
        name="tiny", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128, q_chunk=16, loss_chunk=16,
    )
    params = T.init_lm(0, cfg, DEFAULT_POLICY, device="cpu")
    return cfg, params


def logits_via_backbone(params, cfg, toks):
    """Every position's logits from one full forward (no cache)."""
    with torch.no_grad():
        h, _ = T.lm_backbone(params, torch.tensor([toks]), cfg)
        return (h[0] @ T._unembed(params, cfg).to(torch.bfloat16)).float()


def greedy_via_backbone(params, cfg, prompt, n_new):
    """Oracle: full forward at every step (no cache)."""
    toks = list(prompt)
    for _ in range(n_new):
        toks.append(int(logits_via_backbone(params, cfg, toks)[-1].argmax()))
    return toks[len(prompt):]


def greedy_via_decode(params, cfg, prompt, n_new, max_len=64):
    cache = T.init_cache(T.cache_spec(cfg, 1, max_len), "cpu")
    out = []
    tok = prompt[0]
    for pos in range(len(prompt) + n_new - 1):
        logits, cache = T.lm_decode_step(params, cache, torch.tensor([[tok]]),
                                         pos, cfg)
        if pos + 1 < len(prompt):
            tok = prompt[pos + 1]
        else:
            tok = int(logits[0].argmax())
            out.append(tok)
    return out


class TestDecodeConsistency:
    def test_cached_decode_equals_full_forward(self, tiny):
        cfg, params = tiny
        prompt = [3, 17, 42, 7]
        want = greedy_via_backbone(params, cfg, prompt, 6)
        got = greedy_via_decode(params, cfg, prompt, 6)
        assert got == want

    def test_windowed_decode_ring_buffer(self):
        """A ring cache of `window` slots decodes identically to a full
        cache when attention is windowed (starcoder2's long context)."""
        cfg = T.LMConfig(
            name="sw", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
            d_ff=64, vocab=64, window=8, q_chunk=8, loss_chunk=8,
        )
        params = T.init_lm(1, cfg, DEFAULT_POLICY, device="cpu")
        prompt = [5, 9, 2, 33, 8, 1, 60, 4, 22, 11]
        full = greedy_via_decode(params, cfg, prompt, 8, max_len=64)
        ring = greedy_via_decode(params, cfg, prompt, 8, max_len=8)  # =window
        assert ring == full


class TestServer:
    def test_continuous_batching(self, tiny):
        cfg, params = tiny
        srv = DecodeServer(params, cfg, batch_slots=3, max_len=48,
                           device="cpu")
        reqs = [
            Request(rid=i, prompt=[int(x) for x in p], max_new=5)
            for i, p in enumerate(
                [[3, 17, 42], [7, 7], [1, 2, 3, 4], [9], [12, 13]]
            )
        ]
        done, steps = srv.run(reqs)
        assert len(done) == 5  # 5 requests through 3 slots
        for r in reqs:
            assert r.done and len(r.out) == 5
        # per-request outputs match the single-sequence oracle
        for r in reqs[:2]:
            want = greedy_via_backbone(params, cfg, r.prompt, 5)
            assert r.out == want, (r.rid, r.out, want)

    def test_slot_reuse(self, tiny):
        cfg, params = tiny
        srv = DecodeServer(params, cfg, batch_slots=1, max_len=32,
                           device="cpu")
        reqs = [Request(rid=i, prompt=[i + 1], max_new=3) for i in range(3)]
        done, _ = srv.run(reqs)
        assert len(done) == 3  # sequential through one slot

    def test_slot_freed_at_max_len(self, tiny):
        cfg, params = tiny
        srv = DecodeServer(params, cfg, batch_slots=2, max_len=8,
                           device="cpu")
        reqs = [Request(rid=0, prompt=[1, 2, 3], max_new=100),
                Request(rid=1, prompt=[4], max_new=2)]
        done, _ = srv.run(reqs)
        assert len(done) == 2
        assert len(reqs[0].out) == 8 - 3  # positions 2..6 generate
        assert srv.active == 0

    def test_compute_copy_gives_the_same_bytes(self, tiny):
        """The server's bf16 copy, made once, decodes as the float32
        master does (which casts each layer on every step)."""
        cfg, params = tiny
        copy = T.compute_copy(params)
        assert copy["final_norm"].dtype == torch.float32
        assert copy["layers"]["attn"]["wq"].dtype == torch.bfloat16
        c1 = T.init_cache(T.cache_spec(cfg, 2, 8), "cpu")
        c2 = T.init_cache(T.cache_spec(cfg, 2, 8), "cpu")
        for pos in range(10):
            tok = torch.tensor([[pos + 1], [2 * pos + 3]])
            l1, c1 = T.lm_decode_step(params, c1, tok, pos, cfg)
            l2, c2 = T.lm_decode_step(copy, c2, tok, pos, cfg)
            assert torch.equal(l1, l2)

    def test_cuda_without_a_card_raises(self, tiny):
        if torch.cuda.is_available():
            pytest.skip("this host has a card: nothing to refuse")
        cfg, params = tiny
        with pytest.raises(RuntimeError, match="cuda"):
            DecodeServer(params, cfg, batch_slots=1, max_len=8)


class TestMLADecodeParity:
    def test_absorbed_decode_equals_expanded_forward(self):
        """The weight-absorbed MLA decode (latent-space scores over the
        compressed cache) must match the expanded-form backbone."""
        cfg = T.LMConfig(
            name="mla-tiny", n_layers=2, d_model=48, n_heads=4, n_kv_heads=4,
            d_ff=96, vocab=96,
            mla=T.MLAConfig(q_lora_rank=24, kv_lora_rank=12,
                            qk_nope_head_dim=12, qk_rope_head_dim=8,
                            v_head_dim=12),
            q_chunk=8, loss_chunk=8,
        )
        params = T.init_lm(3, cfg, DEFAULT_POLICY, device="cpu")
        prompt = [5, 61, 17, 40, 2]
        # absorbed ((q·Wk)·c) vs expanded (q·(Wk·c)) reassociates bf16
        # matmuls — compare logits within bf16 tolerance + argmax equality
        logits_fwd = logits_via_backbone(params, cfg, prompt)
        cache = T.init_cache(T.cache_spec(cfg, 1, 16), "cpu")
        dec = []
        for pos, tok in enumerate(prompt):
            lg, cache = T.lm_decode_step(params, cache, torch.tensor([[tok]]),
                                         pos, cfg)
            dec.append(lg[0].float())
        logits_dec = torch.stack(dec)
        np.testing.assert_allclose(logits_dec.numpy(), logits_fwd.numpy(),
                                   atol=0.08)
        assert torch.equal(logits_fwd.argmax(-1), logits_dec.argmax(-1))


class TestMixedCache:
    def test_mixed_cache_decode_matches_stacked(self):
        """Per-layer mixed-window caches (local ring = window slots) must
        decode identically to the uniform full-length stacked cache."""
        cfg = T.LMConfig(
            name="lg", n_layers=6, d_model=32, n_heads=2, n_kv_heads=2,
            d_ff=64, vocab=64, window=4, global_every=3,
            q_chunk=8, loss_chunk=8,
        )
        params = T.init_lm(7, cfg, DEFAULT_POLICY, device="cpu")
        toks = [3, 9, 33, 60, 12, 5, 48, 20, 7, 41]
        max_len = 16
        cache_s = T.init_cache(T.cache_spec(cfg, 1, max_len), "cpu")
        cache_m = T.init_cache(T.cache_spec_mixed(cfg, 1, max_len), "cpu")
        sizes = [c["k"].shape[1] for c in cache_m]
        assert sizes == [4, 4, 16, 4, 4, 16]  # 2:1 pattern of this config
        # full-length per-layer list: isolates the ring size
        cache_f = [{k: torch.zeros((1, max_len) + tuple(v.shape[2:]),
                                   dtype=v.dtype) for k, v in c.items()}
                   for c in cache_m]
        for pos, tok in enumerate(toks):
            t = torch.tensor([[tok]])
            lg_s, cache_s = T.lm_decode_step(params, cache_s, t, pos, cfg)
            lg_m, cache_m = T.lm_decode_step(params, cache_m, t, pos, cfg)
            lg_f, cache_f = T.lm_decode_step(params, cache_f, t, pos, cfg)
            # ring caches are exactly equivalent to full-length caches
            assert torch.equal(lg_m, lg_f)
            # and the stacked cache runs the same loop: equal too
            assert torch.equal(lg_m, lg_s)


def test_port_server_equals_reference_server(tiny):
    """Both packages' servers on one set of weights and requests (5
    requests through 3 slots): the port's tokens equal the reference's
    up to the first position where the reference's top-2 logit margin is
    within 2 x 5e-2 (a near tie either side of a bf16 rounding may go
    either way; after it the continuations differ)."""
    cfg, params = tiny
    rcfg = RT.LMConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})
    rparams = jax.tree.map(jnp.asarray,
                           tree_to_numpy(params, bf16=jnp.bfloat16))
    prompts = [[3, 17, 42], [7, 7], [1, 2, 3, 4], [9], [12, 13]]
    ref = [RefRequest(rid=i, prompt=p, max_new=6)
           for i, p in enumerate(prompts)]
    RefServer(rparams, rcfg, batch_slots=3, max_len=48).run(ref)
    got = [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    DecodeServer(params, cfg, batch_slots=3, max_len=48,
                 device="cpu").run(got)
    compared = 0
    for r, g in zip(ref, got):
        assert g.done and len(g.out) == len(r.out) == 6
        h, _ = RT.lm_backbone(rparams, jnp.asarray([r.prompt + r.out[:-1]]),
                              rcfg)
        logits = np.asarray((h[0] @ RT._unembed(rparams, rcfg).astype(
            jnp.bfloat16)).astype(jnp.float32))[len(r.prompt) - 1:]
        top2 = np.sort(logits, axis=-1)[:, -2:]
        for j, margin in enumerate(top2[:, 1] - top2[:, 0]):
            if margin <= 2 * LOGIT_ATOL:
                break
            assert g.out[j] == r.out[j], (r.rid, j, g.out, r.out)
            compared += 1
    assert compared >= 15
