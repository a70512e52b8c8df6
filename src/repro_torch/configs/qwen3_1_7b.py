"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) head_dim=128
d_ff=6144 vocab=151936 -- qk-norm, RoPE theta 1e6, tied embeddings.

Source: the published ``config.json`` of Qwen/Qwen3-1.7B on the Hugging Face
Hub (num_hidden_layers 28, hidden_size 2048, num_attention_heads 16,
num_key_value_heads 8, head_dim 128, intermediate_size 6144, vocab_size
151936, rope_theta 1000000, tie_word_embeddings true, torch_dtype
bfloat16).  Training, as the JAX package's copy: full remat (each block
recomputed in the backward pass) and 4 microbatches per step.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,          # qwen3 uses head_dim 128 (16*128 = 2048)
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    act="swiglu",
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="full",
    train_microbatches=4,
)
