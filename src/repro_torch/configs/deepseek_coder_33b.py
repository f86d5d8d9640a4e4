"""deepseek-coder-33b [arXiv:2401.14196]: llama-arch, 62L d=7168 56H
(GQA kv=8) d_ff=19200 vocab=32256."""

from repro_torch.models.transformer import LMConfig

from .lm_family import make_lm_arch

CFG = LMConfig(
    name="deepseek-coder-33b",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab=32256,
    rope_theta=100_000.0,
)

SMOKE = LMConfig(
    name="deepseek-coder-33b-smoke",
    n_layers=3,
    d_model=112,
    n_heads=7,
    n_kv_heads=1,
    head_dim=16,
    d_ff=256,
    vocab=512,
    q_chunk=32,
    loss_chunk=32,
)

ARCH = make_lm_arch(
    "deepseek-coder-33b",
    CFG,
    SMOKE,
    long_500k_skip=(
        "pure full attention, 16k-context family, no sub-quadratic or "
        "bounded-cache mechanism (DESIGN.md §6)"
    ),
    describe="dense llama-arch GQA kv=8",
)
