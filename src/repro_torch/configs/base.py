"""Model configuration of the port: the fields the serving and training
paths read.

A copy of ``ModelConfig`` from the JAX package's ``configs/base.py``, cut to
what the ported families, their serving loop and the training step read:
the dense family (embedding, GQA attention with RoPE and qk-norm,
SwiGLU/GELU FFN, tied or separate head), the MoE family (routed and shared
experts, capacity, the router's auxiliary loss), the SSM family (RWKV-6:
the two LoRA ranks), the VLM family (``mrope_sections``, and
``frontend_tokens`` stub patch embeddings before the text), the hybrid
family (the Mamba2 backbone's ``ssm_*`` fields, ``shared_attn_period``
and ``lora_rank``) and the training fields (``remat``,
``train_microbatches``).  The enc-dec family's fields come with its port
(ROADMAP Queue 1, the audio enc-dec family).  ``ShapeCell`` and
``SHAPE_CELLS`` wait for the dry-run's port (ROADMAP Queue 1, the
dry-run), and the MoE sharding hint ``moe_parallel`` for its first reader
(ROADMAP Queue 1, fleet mesh and sharding).

``attention_impl`` takes ``"naive" | "chunked" | "kernel"``: ``"kernel"``
is the port's hand-written CUDA kernels (attention for the dense, MoE,
VLM and hybrid families, the wkv scan for the SSM family), which take the place of the JAX
package's Pallas kernels, so the JAX value ``"pallas"`` converts to it.

``remat`` takes ``"none" | "full" | "dots"``: ``"full"`` recomputes each
block in the backward pass (``torch.utils.checkpoint``, as ``jax.checkpoint``
does); ``"dots"`` (JAX's policy that saves the matmul outputs) has no
counterpart yet, and the model refuses it.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig", "dtype_of", "ATTENTION_IMPLS", "REMAT_POLICIES"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

ATTENTION_IMPLS = ("naive", "chunked", "kernel")
REMAT_POLICIES = ("none", "full", "dots")


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

    # MoE
    num_experts: int = 0
    num_experts_per_token: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba2 / zamba2 backbone)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4

    # hybrid (zamba2): a SHARED full-attention block applied every
    # ``shared_attn_period`` backbone layers, with per-invocation LoRA
    shared_attn_period: int = 0
    lora_rank: int = 0

    # RWKV6
    rwkv_decay_lora: int = 64        # rank of the data-dependent decay MLP
    rwkv_mix_lora: int = 32          # rank of the token-shift mix MLPs

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    norm_type: str = "rms"           # rms | layer
    act: str = "swiglu"              # swiglu | gelu | relu_sq
    tie_embeddings: bool = False
    remat: str = "none"              # none | full | dots

    # gradient accumulation: split the global batch into this many
    # microbatches per train step (activation memory ~ 1/M)
    train_microbatches: int = 1

    # modality frontend stub (vlm): stub patch-embedding positions
    frontend_tokens: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.attention_impl == "pallas":
            object.__setattr__(self, "attention_impl", "kernel")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention impl "
                             f"{self.attention_impl!r}; one of "
                             f"{ATTENTION_IMPLS}")
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {self.remat!r}; one of "
                             f"{REMAT_POLICIES}")

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the JAX package shards the
        vocab dim over its model axis; the port keeps the padding so both
        packages' tables have one shape).  Padded logit columns are masked
        in the serve path."""
        return ((self.vocab_size + 255) // 256) * 256

    def reduced(self) -> "ModelConfig":
        """Smoke-test configuration: same family and wiring, tiny dims --
        the JAX package's ``reduced()`` for the fields kept here (at most 8
        experts, 2 a token and 1 shared; the hybrid family two
        super-blocks deep, ``ssm_state <= 16``, ``ssm_headdim`` 16 and
        ``lora_rank <= 4``; ``frontend_tokens <= 16``; ``remat`` and
        ``train_microbatches`` are kept, as there)."""
        kv = max(1, min(self.num_kv_heads, 2))
        heads = max(kv * 2, 4)
        mrope = (2, 3, 3) if self.mrope_sections is not None else None
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            mrope_sections=mrope,
            num_layers=min(self.num_layers, 2 * max(1, self.shared_attn_period)
                           if self.shared_attn_period else 2),
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=96,
            vocab_size=512,
            num_experts=min(self.num_experts, 8) if self.num_experts else 0,
            num_experts_per_token=(min(self.num_experts_per_token, 2)
                                   if self.num_experts_per_token else 0),
            num_shared_experts=min(self.num_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else self.ssm_headdim,
            lora_rank=min(self.lora_rank, 4),
            rwkv_decay_lora=8,
            rwkv_mix_lora=4,
            attention_chunk=32,
            frontend_tokens=min(self.frontend_tokens, 16),
            param_dtype="float32",
            compute_dtype="float32",
        )
