"""Model configuration of the port: the fields the serving paths read.

A copy of ``ModelConfig`` from the JAX package's ``configs/base.py``, cut to
what the ported families and their serving loop read: the dense family
(embedding, GQA attention with RoPE and qk-norm, SwiGLU/GELU FFN, tied or
separate head) and the SSM family (RWKV-6: the two LoRA ranks).  The
fields of the other families (MoE, hybrid, enc-dec) come with their ports
(ROADMAP Queue 1 item 11); ``family`` and ``mrope_sections`` stay so the
model can refuse what it lacks.  ``ShapeCell`` and ``SHAPE_CELLS`` wait for
the dry-run's port.

``attention_impl`` takes ``"naive" | "chunked" | "kernel"``: ``"kernel"``
is the port's hand-written CUDA kernels (attention for the dense family,
the wkv scan for the SSM family), which take the place of the JAX
package's Pallas kernels, so the JAX value ``"pallas"`` converts to it.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig", "dtype_of", "ATTENTION_IMPLS"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

ATTENTION_IMPLS = ("naive", "chunked", "kernel")


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # attention
    qk_norm: bool = False
    rope_theta: float = 1.0e4
    mrope_sections: tuple[int, int, int] | None = None   # qwen2-vl M-RoPE
    attention_impl: str = "chunked"  # naive | chunked | kernel
    attention_chunk: int = 512

    # RWKV6
    rwkv_decay_lora: int = 64        # rank of the data-dependent decay MLP
    rwkv_mix_lora: int = 32          # rank of the token-shift mix MLPs

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    norm_type: str = "rms"           # rms | layer
    act: str = "swiglu"              # swiglu | gelu | relu_sq
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.attention_impl == "pallas":
            object.__setattr__(self, "attention_impl", "kernel")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention impl "
                             f"{self.attention_impl!r}; one of "
                             f"{ATTENTION_IMPLS}")

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the JAX package shards the
        vocab dim over its model axis; the port keeps the padding so both
        packages' tables have one shape).  Padded logit columns are masked
        in the serve path."""
        return ((self.vocab_size + 255) // 256) * 256

    def reduced(self) -> "ModelConfig":
        """Smoke-test configuration: same family and wiring, tiny dims --
        the JAX package's ``reduced()`` for the fields kept here."""
        kv = max(1, min(self.num_kv_heads, 2))
        heads = max(kv * 2, 4)
        mrope = (2, 3, 3) if self.mrope_sections is not None else None
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            mrope_sections=mrope,
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=96,
            vocab_size=512,
            rwkv_decay_lora=8,
            rwkv_mix_lora=4,
            attention_chunk=32,
            param_dtype="float32",
            compute_dtype="float32",
        )
