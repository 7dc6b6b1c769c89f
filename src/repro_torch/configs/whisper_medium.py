"""Whisper-medium — encoder-decoder audio backbone (conv frontend stub).
[arXiv:2212.04356] 24L enc + 24L dec, d_model=1024 16H (kv=16) d_ff=4096
vocab=51865, encoder_seq=1500 frames.  Twin of
``repro.configs.whisper_medium``.

The conv frontend is a stub: the encoder takes precomputed frame
embeddings (B, 1500, 1024).  Learned positional embeddings
(rope_theta=None), biased projections, GELU MLP, tied embeddings.
"""

from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    d_model=1024,
    num_layers=24,           # decoder mixer layers; encoder counted apart
    segments=(Segment(("attn", "cross_attn", "mlp"), 24),),
    encoder_segments=(Segment(("attn", "mlp"), 24),),
    encoder_layers=24,
    encoder_seq=1500,
    vocab_size=51865,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    mlp_kind="gelu",
    qkv_bias=True,
    mlp_bias=True,
    rope_theta=None,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio", d_model=64, num_layers=2,
        segments=(Segment(("attn", "cross_attn", "mlp"), 2),),
        encoder_segments=(Segment(("attn", "mlp"), 2),),
        encoder_layers=2, encoder_seq=30, vocab_size=256,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        mlp_kind="gelu", qkv_bias=True, mlp_bias=True, rope_theta=None,
        tie_embeddings=True)
