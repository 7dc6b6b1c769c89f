"""Load the JAX package's parameter tree into the port.

``from_jax_numpy(tree, cfg, device)`` takes the tree that
``repro.models.api.init_params`` returns, as nested dicts of numpy
arrays, and returns the port's params (``models.transformer`` layout) on
``device`` (the card unless the caller asks for the CPU), so both
packages compute the same function in the tests.  An MoE sublayer's
expert stacks, (count, E, D, F) in the JAX tree, become (E, D, F).

The JAX tree stacks each segment's sublayer params on a leading
``count`` axis (``seg{i}/pos{j}/...``) and scans the periods, running
each period's pattern in order; the flat layer order is therefore
``for i in segments: for c in range(count): for j in pattern`` — not
position-major.  A zamba2 ``shared_attn`` position holds ``{}`` in the
JAX tree and in the port; the block it applies (``tree["shared"]``) is
carried across once, unstacked.  An encoder-decoder's ``enc_seg{i}``
become ``enc_layers`` in the same scan order, and its ``enc_final_norm``
and the learned positional tables (``pos_embed``, ``enc_pos_embed``)
come across as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime.device import resolve_device

__all__ = ["from_jax_numpy"]


def _tensors(tree, index, device):
    """Nested dict of numpy arrays -> same dict of tensors, taking
    ``x[index]`` of every leaf when ``index`` is given."""
    if isinstance(tree, dict):
        return {k: _tensors(v, index, device) for k, v in tree.items()}
    x = np.asarray(tree)
    if index is not None:
        x = x[index]
    # a copy: the port's optimizer updates params in place, and must not
    # write through into the caller's arrays
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C", copy=True)).to(device)


def from_jax_numpy(tree: dict, cfg: ModelConfig,
                   device: torch.device | str = "cuda") -> dict:
    """JAX ``api.init_params`` tree (numpy leaves) -> port params."""
    device = resolve_device(device)
    params = {"embed": _tensors(tree["embed"], None, device),
              "final_norm": _tensors(tree["final_norm"], None, device)}
    for key in ("unembed", "shared", "pos_embed", "enc_final_norm", "enc_pos_embed"):
        if key in tree:
            params[key] = _tensors(tree[key], None, device)
    params["layers"] = _flat_layers(tree, cfg.segments, "seg", device)
    if cfg.encoder_segments:
        params["enc_layers"] = _flat_layers(tree, cfg.encoder_segments, "enc_seg", device)
    return params


def _flat_layers(tree: dict, segments, prefix: str, device) -> list:
    """The stacked ``{prefix}{i}/pos{j}`` params as one list in scan order."""
    layers = []
    for i, seg in enumerate(segments):
        seg_tree = tree[f"{prefix}{i}"]
        for c in range(seg.count):
            for j, _ in enumerate(seg.pattern):
                layers.append(_tensors(seg_tree[f"pos{j}"], c, device))
    return layers
