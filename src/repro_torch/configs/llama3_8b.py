"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) head_dim=128
d_ff=14336 vocab=128256 -- GQA, 128k vocab, RoPE theta 5e5.

Source: arXiv:2407.21783 (The Llama 3 Herd of Models: the 8B model), as
the JAX package's ``configs/llama3_8b.py`` copies it.  Training, as there:
full remat and 8 microbatches per step.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    act="swiglu",
    remat="full",
    train_microbatches=8,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
