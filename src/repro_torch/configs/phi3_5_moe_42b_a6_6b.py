"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8)
head_dim=128 d_ff=6400 vocab=32064, MoE 16 experts top-2.

Source: hf:microsoft/Phi-3.5-MoE-instruct (its published config), as the
JAX package's ``configs/phi3_5_moe_42b_a6_6b.py`` copies it.  Training, as
there: full remat and 8 microbatches per step.  Its bfloat16 weights
(83.7 GB) exceed one 80 GB card; ``chip_smoke.py`` serves it at 24 of its
32 layers, at the published widths.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    num_experts_per_token=2,
    num_shared_experts=0,
    rope_theta=10000.0,
    act="swiglu",
    remat="full",
    train_microbatches=8,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
