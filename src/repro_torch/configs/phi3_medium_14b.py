"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) head_dim=128
d_ff=17920 vocab=100352 -- RoPE, SwiGLU, GQA.

Source: arXiv:2404.14219 (Phi-3 Technical Report: phi-3-medium), as the
JAX package's ``configs/phi3_medium_14b.py`` copies it.  Training, as
there: full remat and 8 microbatches per step.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=10000.0,
    act="swiglu",
    remat="full",
    train_microbatches=8,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
