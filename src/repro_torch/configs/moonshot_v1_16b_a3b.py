"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 48L d=2048
16H (kv=16) MoE 64e top-6 (d_ff_expert=1408) + 2 shared, vocab=163840,
first layer dense."""

from repro_torch.models.transformer import LMConfig, MoEConfig

from .lm_family import make_lm_arch

CFG = LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=11264,            # the single dense layer (8x expert width)
    vocab=163840,
    rope_theta=50_000.0,
    n_dense_layers=1,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared=2,
        router="softmax",
        capacity_factor=1.25,
    ),
)

SMOKE = LMConfig(
    name="moonshot-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=256,
    vocab=512,
    n_dense_layers=1,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=2),
    q_chunk=32,
    loss_chunk=32,
)

ARCH = make_lm_arch(
    "moonshot-v1-16b-a3b",
    CFG,
    SMOKE,
    long_500k_skip=(
        "pure full attention, 8k-context family, no sub-quadratic or "
        "bounded-cache mechanism (DESIGN.md §6)"
    ),
    describe="kimi/moonlight-style MoE 64e top-6 + 2 shared experts",
)
