"""DBRX 132B — fine-grained MoE (16 experts, top-4), full attention.
[hf:databricks/dbrx-base] 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352.  Twin of ``repro.configs.dbrx_132b``.
"""

from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    d_model=6144,
    num_layers=40,
    segments=(Segment(("attn", "moe"), 40),),
    vocab_size=100352,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    mlp_kind="swiglu",
    num_experts=16,
    top_k=4,
    rope_theta=500_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke", family="moe", d_model=64, num_layers=2,
        segments=(Segment(("attn", "moe"), 2),), vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        mlp_kind="swiglu", num_experts=4, top_k=2)
