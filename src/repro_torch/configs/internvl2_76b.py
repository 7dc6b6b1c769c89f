"""InternVL2-76B — VLM: stubbed InternViT frontend + dense LM backbone.
[arXiv:2404.16821] 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, 256 image tokens per sample (post pixel-shuffle).  Twin of
``repro.configs.internvl2_76b``.

The ViT tower is a stub: the model takes projected patch embeddings
(B, 256, 8192), prepended to the text stream.  Full attention backbone.
"""

from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    d_model=8192,
    num_layers=80,
    segments=(Segment(("attn", "mlp"), 80),),
    vocab_size=128256,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    mlp_kind="swiglu",
    rope_theta=500_000.0,
    num_image_tokens=256,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm", d_model=64, num_layers=2,
        segments=(Segment(("attn", "mlp"), 2),), vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        mlp_kind="swiglu", num_image_tokens=8)
