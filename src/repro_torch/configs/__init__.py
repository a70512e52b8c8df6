"""Configurations of the port: the Mez edge testbed (``mez_edge``), the
model architectures of the JAX package (``get_config``) and the shape
cells each runs (``cells_for``; ``long_500k`` only for sub-quadratic
backbones)."""

from __future__ import annotations

from repro_torch.configs import (internlm2_1_8b, llama3_8b,
                                 moonshot_v1_16b_a3b, phi3_5_moe_42b_a6_6b,
                                 phi3_medium_14b, qwen2_vl_72b, qwen3_1_7b,
                                 rwkv6_1_6b, seamless_m4t_large_v2,
                                 zamba2_7b)
from repro_torch.configs.base import (SHAPE_CELLS, ModelConfig, ShapeCell,
                                      dtype_of)

__all__ = ["ARCHS", "get_config", "cells_for", "skipped_cells_for",
           "ModelConfig", "ShapeCell", "SHAPE_CELLS", "dtype_of"]

ARCHS: dict[str, ModelConfig] = {
    "phi3-medium-14b": phi3_medium_14b.CONFIG,
    "qwen3-1.7b": qwen3_1_7b.CONFIG,
    "internlm2-1.8b": internlm2_1_8b.CONFIG,
    "llama3-8b": llama3_8b.CONFIG,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe_42b_a6_6b.CONFIG,
    "rwkv6-1.6b": rwkv6_1_6b.CONFIG,
    "qwen2-vl-72b": qwen2_vl_72b.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "seamless-m4t-large-v2": seamless_m4t_large_v2.CONFIG,
}


def get_config(arch: str) -> ModelConfig:
    """The published configuration of ``arch``; unknown names raise
    ``KeyError``."""
    if arch in ARCHS:
        return ARCHS[arch]
    raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")


def cells_for(arch: str) -> list[str]:
    """The shape cells ``arch`` runs: every kind at 4k / 32k, and
    ``long_500k`` for a sub-quadratic backbone."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if get_config(arch).supports_long_context:
        cells.append("long_500k")
    return cells


def skipped_cells_for(arch: str) -> dict[str, str]:
    """The cells ``arch`` skips, each with its reason."""
    if not get_config(arch).supports_long_context:
        return {"long_500k": "pure full-attention arch: 500k-token context "
                             "needs a sub-quadratic backbone"}
    return {}
