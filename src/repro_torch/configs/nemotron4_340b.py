"""Nemotron-4 340B — dense GQA + squared-ReLU MLP.
[arXiv:2402.16819] 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000.  Twin of ``repro.configs.nemotron4_340b``.

Pure full attention.  The 18432-wide GEMMs are the
paper's large-N error-growth regime; head_dim 192 puts the flash kernels
on three 64-column blocks.
"""

from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    d_model=18432,
    num_layers=96,
    segments=(Segment(("attn", "mlp"), 96),),
    vocab_size=256000,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    mlp_kind="squared_relu",
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", family="dense", d_model=64, num_layers=2,
        segments=(Segment(("attn", "mlp"), 2),), vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        mlp_kind="squared_relu")
