"""Model/config schema (twin of ``repro.configs.base``).

A model is a sequence of *segments*; each segment is ``count``
repetitions of a sublayer-kind ``pattern``.  The JAX package stacks each
segment's params on a leading ``count`` axis and scans it; the port
keeps one flat list of sublayers in execution order
(``layer_kinds``): ``for seg in segments: for c in range(count): for
kind in pattern``.

Every family of the JAX package is ported: ``dense``, ``moe``, the
``ssm`` family's RWKV-6 stacks, the ``hybrid`` family (zamba2), ``audio``
(whisper: an encoder of ``encoder_segments`` over ``encoder_seq``
embedded frames, a decoder with cross-attention) and ``vlm`` (internvl2:
``num_image_tokens`` embedded patches prepended to the text).  Kinds:
``attn`` (global GQA self-attention), ``attn_local`` (sliding-window
attention with a ring-buffer cache), ``cross_attn`` (attention from the
decoder onto the encoder's keys and values, cached once per request),
``mlp``, ``moe`` (top-k routed experts), ``rwkv6`` (RWKV-6 time-mix +
channel-mix layer), ``mamba2`` (Mamba-2 SSD mixer) and ``shared_attn`` (a
zamba2 transformer block whose params are stored once and applied at
every occurrence).  ``rope_theta=None`` means learned positional tables
in place of RoPE (whisper).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.ops.route import ExecutionPolicy, normalize_backends

__all__ = ["Segment", "ModelConfig", "execution_policy_for", "layer_kinds"]


@dataclasses.dataclass(frozen=True)
class Segment:
    """``count`` repetitions of the layer-kind tuple ``pattern``."""

    pattern: tuple[str, ...]
    count: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    num_layers: int                  # mixer sublayers (bookkeeping)
    segments: tuple[Segment, ...]
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float | None = 10_000.0   # None: learned positional tables
    window: int | None = None        # sliding window of attn_local
    attn_logit_softcap: float | None = None
    qkv_bias: bool = False
    d_ff: int = 0
    mlp_kind: str = "swiglu"         # swiglu | squared_relu | gelu
    mlp_bias: bool = False
    # moe
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 0
    ssm_chunk: int = 256             # SSD chunk of the chunked scan
    conv_width: int = 4
    # rwkv6
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 64             # WKV chunk of the chunked parallel form
    # enc-dec (whisper): the frontend is a stub, frames arrive embedded
    encoder_layers: int = 0
    encoder_seq: int = 0
    encoder_segments: tuple[Segment, ...] = ()
    # vlm (internvl2): embedded image patches prepended to the text
    num_image_tokens: int = 0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    activation_dtype: str = "bfloat16"
    # default {family: impl} routing of this arch over the op registry
    backends: tuple[tuple[str, str], ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "backends",
                           normalize_backends(self.backends))
        # "num_layers" counts mixer sublayers (attn / mamba2 / rwkv6 /
        # shared_attn); mlp / moe sublayers ride along in the same layer
        mixers = sum(
            s.count * sum(k in ("attn", "attn_local", "mamba2", "rwkv6",
                                "shared_attn") for k in s.pattern)
            for s in self.segments)
        if mixers != self.num_layers:
            raise ValueError(
                f"{self.name}: segments define {mixers} mixer layers, "
                f"config says num_layers={self.num_layers}")

    @property
    def qk_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def layer_kinds(cfg: ModelConfig, *, encoder: bool = False) -> list[str]:
    """Every sublayer's kind in execution order (segment-major, then
    period, then pattern position) — the order the JAX scan runs — of the
    decoder stack, or with ``encoder`` of the encoder's segments."""
    segments = cfg.encoder_segments if encoder else cfg.segments
    return [kind for seg in segments for _ in range(seg.count)
            for kind in seg.pattern]


def execution_policy_for(cfg: ModelConfig, *, default: str = "bf16",
                         logits: str | None = None, backends=None,
                         fallback: bool = False,
                         require=None, mesh=None) -> ExecutionPolicy:
    """Precision knobs plus the ``backends`` mapping (CLI overrides
    layered over the arch's defaults) and the ``mesh``, validated at
    build time."""
    merged = dict(cfg.backends)
    merged.update(dict(normalize_backends(backends or ())))
    return ExecutionPolicy(default=default, logits=logits, backends=merged,
                           fallback=fallback,
                           require=require or (), mesh=mesh)
