"""Mixtral 8x7B — MoE (8 experts, top-2) + sliding-window attention.
[arXiv:2401.04088; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, window=4096.  Twin of ``repro.configs.mixtral_8x7b``.

Every layer's experts are the paper's Fig.-7 batched-GEMM regime: eight
4096 x 14336 SwiGLU experts, two per token, through the grouped family.
"""

from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    d_model=4096,
    num_layers=32,
    segments=(Segment(("attn_local", "moe"), 32),),
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    mlp_kind="swiglu",
    num_experts=8,
    top_k=2,
    window=4096,
    rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe", d_model=64, num_layers=2,
        segments=(Segment(("attn_local", "moe"), 2),), vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        mlp_kind="swiglu", num_experts=4, top_k=2, window=16)
