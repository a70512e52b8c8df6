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
and ``lora_rank``), the enc-dec family (``is_encoder_decoder`` and
``num_decoder_layers``: ``num_layers`` counts the encoder's layers) and
the training fields (``remat``, ``train_microbatches``), and the JAX
package's sharding hints (``fsdp``, ``moe_parallel``,
``sequence_parallel``, ``zero3``), which ``sharding/partition.py`` reads.

``ShapeCell`` and ``SHAPE_CELLS`` are the JAX package's input shapes, one
cell a (kind, sequence length, global batch); ``param_count`` /
``active_param_count`` are its analytic parameter counts, equal to the JAX
package's integer for integer.

``attention_impl`` takes ``"naive" | "chunked" | "kernel"``: ``"kernel"``
is the port's hand-written CUDA kernels (attention for the dense, MoE,
VLM, hybrid and enc-dec families, the wkv scan for the SSM family), which
take the place of the JAX package's Pallas kernels, so the JAX value
``"pallas"`` converts to it.

``remat`` takes ``"none" | "full" | "dots"``: ``"full"`` recomputes each
block in the backward pass (``torch.utils.checkpoint``, as ``jax.checkpoint``
does); ``"dots"`` recomputes all of a transformer block but the outputs of
its products without batch dimensions (JAX's
``checkpoint_dots_with_no_batch_dims``), and runs as ``"full"`` in the
other families, as in JAX (``models/layers.py::remat_block``).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig", "ShapeCell", "SHAPE_CELLS", "dtype_of",
           "ATTENTION_IMPLS", "REMAT_POLICIES"]

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

    # enc-dec (seamless): num_layers counts the encoder's layers
    is_encoder_decoder: bool = False
    num_decoder_layers: int = 0

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    norm_type: str = "rms"           # rms | layer
    act: str = "swiglu"              # swiglu | gelu | relu_sq
    tie_embeddings: bool = False
    remat: str = "none"              # none | full | dots

    # sharding hints (read by repro_torch.sharding.partition)
    fsdp: bool = True                # shard params over the data axis too
    moe_parallel: str = "ep"         # ep (experts over model) | tp
    # gradient accumulation: split the global batch into this many
    # microbatches per train step (activation memory ~ 1/M)
    train_microbatches: int = 1
    # sequence parallelism; also the escape for archs whose head counts
    # don't divide the model axis (phi3: 40 heads against 16): attention
    # weights then drop the model axis
    sequence_parallel: bool = False
    # ZeRO-3: no tensor parallelism; weights and optimizer state shard over
    # all mesh axes on their d_model dim, and the batch over all axes too
    zero3: bool = False

    # modality frontend stub (vlm): stub patch-embedding positions (the
    # audio family's encoder input is the stub embedding stream itself)
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

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic backbones only (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def reduced(self) -> "ModelConfig":
        """Smoke-test configuration: same family and wiring, tiny dims --
        the JAX package's ``reduced()`` for the fields kept here (at most 8
        experts, 2 a token and 1 shared; the hybrid family two
        super-blocks deep, ``ssm_state <= 16``, ``ssm_headdim`` 16 and
        ``lora_rank <= 4``; ``frontend_tokens <= 16``; at most 2 decoder
        layers; ``remat`` and
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
            num_decoder_layers=min(self.num_decoder_layers, 2),
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

    # -- parameter counting (the JAX package's analytic counts) ---------------
    def param_count(self) -> int:
        """Analytic parameter count, embedding included: the JAX package's
        formula (approximate for rwkv6 and zamba2, whose trees it counts
        by their main matrices; exact for the others)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kh, hd = self.num_heads, self.num_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kh * hd + h * hd * d
        mlp = 3 * d * f if self.act == "swiglu" else 2 * d * f
        per_layer_dense = attn + mlp + 2 * d
        if self.family == "moe":
            moe = (self.num_experts * mlp + d * self.num_experts
                   + self.num_shared_experts * mlp)
            total = self.num_layers * (attn + moe + 2 * d)
        elif self.family == "ssm":       # rwkv6: r, k, v, g, o and the LoRAs
            tm = (5 * d * d + 5 * self.rwkv_mix_lora * 2 * d
                  + self.rwkv_decay_lora * 2 * d)
            total = self.num_layers * (tm + 2 * d * f + 2 * d)
        elif self.family == "hybrid":    # zamba2: mamba2 backbone + shared attn
            d_in = d * self.ssm_expand
            nheads = d_in // self.ssm_headdim
            mamba = (d * (2 * d_in + 2 * self.ssm_state + nheads)  # in_proj
                     + d_in * d                                    # out_proj
                     + self.ssm_conv * (d_in + 2 * self.ssm_state)
                     + 2 * nheads)                                 # A, D
            total = self.num_layers * (mamba + 2 * d)
            n_inv = self.num_layers // max(1, self.shared_attn_period)
            total += per_layer_dense + n_inv * self.lora_rank * 2 * d * 4
        else:
            total = self.num_layers * per_layer_dense
        if self.is_encoder_decoder:      # decoder layers add cross attention
            total += self.num_decoder_layers * (per_layer_dense + attn + d)
        total += v * d                   # embeddings
        if not self.tie_embeddings:
            total += v * d               # lm head
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters a token (MoE: only the routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        expert = 3 * d * f if self.act == "swiglu" else 2 * d * f
        inactive = (self.num_experts - self.num_experts_per_token) * expert
        return int(self.param_count() - self.num_layers * inactive)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One input shape of a step: ``kind`` train | prefill | decode."""
    name: str
    seq_len: int
    global_batch: int
    kind: str

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}
