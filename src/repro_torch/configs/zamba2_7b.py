"""Zamba2-7B — Mamba-2 backbone + SHARED attention blocks.
[arXiv:2411.15242] 81L d_model=3584 32H (kv=32) head_dim 112 d_ff=14336
vocab=32000, ssm_state=64.  Twin of ``repro.configs.zamba2_7b``.

Pattern: 13 periods of [5 mamba2 + 1 shared_attn] + 3 trailing mamba2 =
81 mixer layers.  The shared_attn block's params are stored ONCE and
applied at every occurrence; its KV caches stay per occurrence.  The
SSM state is O(1) in the context.
"""

from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    d_model=3584,
    num_layers=81,
    segments=(Segment(("mamba2",) * 5 + ("shared_attn",), 13),
              Segment(("mamba2",), 3)),
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    mlp_kind="swiglu",
    ssm_state=64,
    ssm_head_dim=64,
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid", d_model=64, num_layers=7,
        segments=(Segment(("mamba2",) * 2 + ("shared_attn",), 2),
                  Segment(("mamba2",), 1)),
        vocab_size=256, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, mlp_kind="swiglu", ssm_state=16, ssm_head_dim=16)
