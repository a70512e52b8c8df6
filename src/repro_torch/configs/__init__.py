"""Configurations of the port: the Mez edge testbed (``mez_edge``) and the
model architectures the port serves so far (``get_config``)."""

from __future__ import annotations

from repro_torch.configs import (internlm2_1_8b, llama3_8b,
                                 moonshot_v1_16b_a3b, phi3_5_moe_42b_a6_6b,
                                 phi3_medium_14b, qwen2_vl_72b, qwen3_1_7b,
                                 rwkv6_1_6b, zamba2_7b)
from repro_torch.configs.base import ModelConfig, dtype_of

__all__ = ["ARCHS", "PENDING_ARCHS", "PENDING_FAMILIES", "get_config",
           "ModelConfig", "dtype_of"]

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
}

# The JAX package's other families, each by the title of the ROADMAP Queue 1
# item that ports it, and their architectures.
PENDING_FAMILIES = {"audio": "the audio enc-dec family"}
PENDING_ARCHS = {"seamless-m4t-large-v2": "audio"}


def get_config(arch: str) -> ModelConfig:
    """The published configuration of ``arch``.  Architectures of the JAX
    package that the port does not serve yet raise ``NotImplementedError``;
    unknown names raise ``KeyError``."""
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in PENDING_ARCHS:
        raise NotImplementedError(
            f"{arch!r} is not ported yet (ROADMAP Queue 1, "
            f"{PENDING_FAMILIES[PENDING_ARCHS[arch]]})")
    raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
