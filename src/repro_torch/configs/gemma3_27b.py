"""gemma3-27b [hf:google/gemma-3-*]: 62L d=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144, 5:1 local:global (window 1024), 128k context."""

from repro_torch.models.transformer import LMConfig

from .lm_family import make_lm_arch

CFG = LMConfig(
    name="gemma3-27b",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    rope_theta=1_000_000.0,
    window=1024,
    global_every=6,        # layers 6,12,... are global: 5 local : 1 global
    tie_embeddings=True,   # gemma family ties embeddings
)

SMOKE = LMConfig(
    name="gemma3-27b-smoke",
    n_layers=6,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=384,
    vocab=512,
    window=16,
    global_every=3,
    tie_embeddings=True,
    q_chunk=32,
    loss_chunk=32,
)

ARCH = make_lm_arch(
    "gemma3-27b",
    CFG,
    SMOKE,
    long_500k_skip=None,  # RUN: hybrid local:global; decode is O(L)
    describe="5:1 local:global attention; 256k vocab exercises the "
    "vocab-parallel chunked CE path",
)
