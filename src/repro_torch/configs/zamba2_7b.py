"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 -- Mamba2 backbone + shared attention blocks.

Source: arXiv:2411.15242 (Zamba2), as the JAX package's
``configs/zamba2_7b.py`` copies it (marked unverified there).  The
backbone is 81 Mamba2 (SSD) layers; one SHARED full-attention + MLP block
(32 heads of 112, d_ff 14336) is invoked after every 6th backbone layer
(13 invocations), each invocation with its own LoRA adapters on the q/k/v
projections.  Training, as there: full remat and 8 microbatches per step.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    shared_attn_period=6,
    lora_rank=64,
    rope_theta=10000.0,
    act="swiglu",
    remat="full",
    train_microbatches=8,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
