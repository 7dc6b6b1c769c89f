"""StarCoder2-15B — dense GQA + RoPE code model.
[arXiv:2402.19173; hf] 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152.  Twin of ``repro.configs.starcoder2_15b``.

Pure full attention.  Non-gated GELU MLP (d_ff=4d),
biased QKV and MLP projections.
"""

from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    d_model=6144,
    num_layers=40,
    segments=(Segment(("attn", "mlp"), 40),),
    vocab_size=49152,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    mlp_kind="gelu",
    qkv_bias=True,
    mlp_bias=True,
    rope_theta=100_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke", family="dense", d_model=64, num_layers=2,
        segments=(Segment(("attn", "mlp"), 2),), vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        mlp_kind="gelu", qkv_bias=True, mlp_bias=True)
