"""starcoder2-3b [arXiv:2402.19173]: 30L d=3072 24H (GQA kv=2) d_ff=12288
vocab=49152, RoPE, sliding-window 4096."""

from repro_torch.models.transformer import LMConfig

from .lm_family import make_lm_arch

CFG = LMConfig(
    name="starcoder2-3b",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab=49152,
    rope_theta=100_000.0,
    window=4096,           # sliding-window attention (all layers)
    tie_embeddings=True,   # starcoder2-3b ties embeddings
    gated_mlp=False,       # starcoder2 uses a plain GELU MLP (2 matrices)
)

SMOKE = LMConfig(
    name="starcoder2-3b-smoke",
    n_layers=3,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=512,
    vocab=512,
    window=32,
    tie_embeddings=True,
    gated_mlp=False,
    q_chunk=32,
    loss_chunk=32,
)

ARCH = make_lm_arch(
    "starcoder2-3b",
    CFG,
    SMOKE,
    long_500k_skip=None,  # RUN: sliding window ⇒ bounded ring cache
    describe="dense GQA kv=2, RoPE, SWA-4096; long_500k runs with a "
    "window-sized ring-buffer KV cache",
)
