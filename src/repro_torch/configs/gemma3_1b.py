"""Gemma-3 1B — 5:1 local:global attention, 262k vocab.
[hf:google/gemma-3-1b-pt] 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144, sliding window 512.  Twin of ``repro.configs.gemma3_1b``.
"""

from repro_torch.configs.base import ModelConfig, Segment

_PERIOD = ("attn_local", "mlp") * 5 + ("attn", "mlp")

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    d_model=1152,
    num_layers=26,
    segments=(Segment(_PERIOD, 4), Segment(("attn_local", "mlp"), 2)),
    vocab_size=262144,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    mlp_kind="swiglu",
    window=512,
    rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense", d_model=64, num_layers=8,
        segments=(Segment(("attn_local", "mlp") * 2 + ("attn", "mlp"), 2),
                  Segment(("attn_local", "mlp"), 2)),
        vocab_size=512, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, mlp_kind="swiglu", window=16, rope_theta=1_000_000.0)
