"""Configurations of the port: the Mez edge testbed (``mez_edge``) and the
model architectures the port serves so far (``get_config``)."""

from __future__ import annotations

from repro_torch.configs import qwen3_1_7b, rwkv6_1_6b
from repro_torch.configs.base import ModelConfig, dtype_of

__all__ = ["ARCHS", "PENDING_ARCHS", "get_config", "ModelConfig", "dtype_of"]

ARCHS: dict[str, ModelConfig] = {
    "qwen3-1.7b": qwen3_1_7b.CONFIG,
    "rwkv6-1.6b": rwkv6_1_6b.CONFIG,
}

# The JAX package's other architectures: their families are not ported yet.
PENDING_ARCHS = ("zamba2-7b", "phi3-medium-14b", "internlm2-1.8b",
                 "llama3-8b", "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b",
                 "qwen2-vl-72b", "seamless-m4t-large-v2")


def get_config(arch: str) -> ModelConfig:
    """The published configuration of ``arch``.  Architectures of the JAX
    package that the port does not serve yet raise ``NotImplementedError``;
    unknown names raise ``KeyError``."""
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in PENDING_ARCHS:
        raise NotImplementedError(
            f"{arch!r} is not ported yet (ROADMAP Queue 1 item 11: the model "
            f"zoo's other families)")
    raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
