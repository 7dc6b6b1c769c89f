"""RWKV-6 "Finch" 7B — attention-free, data-dependent decay.
[arXiv:2404.05892; hf] 32L d_model=4096 d_ff=14336 vocab=65536, 64 heads
of 64.  Twin of ``repro.configs.rwkv6_7b``.

Attention-free, so decode carries an O(1) recurrent state per layer
instead of a KV cache.  The precision policy applies to every projection
and to the chunked WKV form's contractions.
"""

from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    d_model=4096,
    num_layers=32,
    segments=(Segment(("rwkv6",), 32),),
    vocab_size=65536,
    d_ff=14336,
    rwkv_head_dim=64,
    rope_theta=None,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm", d_model=64, num_layers=2,
        segments=(Segment(("rwkv6",), 2),), vocab_size=256, d_ff=128,
        rwkv_head_dim=16, rope_theta=None)
