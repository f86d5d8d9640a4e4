"""deepseek-v3-671b [arXiv:2412.19437]: 61L d=7168 128H, MLA, MoE
256 routed top-8 + 1 shared (d_ff_expert=2048), first 3 layers dense
(d_ff=18432), vocab=129280, MTP."""

from repro_torch.models.common import LARGE_POLICY
from repro_torch.models.transformer import LMConfig, MLAConfig, MoEConfig

from .lm_family import make_lm_arch

CFG = LMConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,            # the 3 dense layers
    vocab=129280,
    rope_theta=10_000.0,
    n_dense_layers=3,
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_ff_expert=2048,
        n_shared=1,
        router="sigmoid",
        capacity_factor=1.25,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    mtp_depth=1,
)

SMOKE = LMConfig(
    name="deepseek-v3-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab=512,
    n_dense_layers=1,
    moe=MoEConfig(
        n_experts=8, top_k=2, d_ff_expert=32, n_shared=1, router="sigmoid"
    ),
    mla=MLAConfig(
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
    ),
    mtp_depth=1,
    q_chunk=32,
    loss_chunk=32,
)

ARCH = make_lm_arch(
    "deepseek-v3-671b",
    CFG,
    SMOKE,
    policy=LARGE_POLICY,  # bf16 master + bf16 moments: 671B fits 512 chips
    long_500k_skip=None,  # RUN: MLA compressed KV (576 B/token/layer)
    describe="MLA + 256e top-8 MoE + MTP; decode uses weight-absorbed "
    "latent attention over the compressed cache",
)
