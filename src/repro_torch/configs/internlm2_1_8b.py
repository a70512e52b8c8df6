"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) head_dim=128
d_ff=8192 vocab=92544 -- GQA, RoPE theta 1e6.

Source: arXiv:2403.17297 (InternLM2 Technical Report: the 1.8B model) and
its Hugging Face config, as the JAX package's ``configs/internlm2_1_8b.py``
copies it.  Training, as there: full remat and 4 microbatches per step.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    rope_theta=1000000.0,
    act="swiglu",
    remat="full",
    train_microbatches=4,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
