"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) head_dim=128
d_ff=1408 vocab=163840, MoE 64 experts top-6 plus 2 shared -- the
kimi/Moonlight fine-grained experts.

Source: hf:moonshotai/Moonlight-16B-A3B (its published config), as the JAX
package's ``configs/moonshot_v1_16b_a3b.py`` copies it.  Moonlight follows
the DeepSeek-V3 recipe: fine-grained experts (d_ff 1408) with 2 shared
experts beside the 64 routed ones.  Training, as there: full remat and 8
microbatches per step.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    num_experts_per_token=6,
    num_shared_experts=2,
    rope_theta=50000.0,
    act="swiglu",
    remat="full",
    train_microbatches=8,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    moe_parallel="ep",      # the default, set as the JAX config sets it
)
