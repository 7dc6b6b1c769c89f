"""Command-R 35B — dense GQA, no biases.
[hf:CohereForAI/c4ai-command-r-v01] 40L d_model=8192 64H (GQA kv=8)
d_ff=22528 vocab=256000.  Twin of ``repro.configs.command_r_35b``.

Pure full attention.
"""

from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    d_model=8192,
    num_layers=40,
    segments=(Segment(("attn", "mlp"), 40),),
    vocab_size=256000,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    mlp_kind="swiglu",
    rope_theta=8_000_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="command-r-smoke", family="dense", d_model=64, num_layers=2,
        segments=(Segment(("attn", "mlp"), 2),), vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        mlp_kind="swiglu")
