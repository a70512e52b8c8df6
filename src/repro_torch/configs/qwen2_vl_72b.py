"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 -- M-RoPE, dynamic resolution.

Source: arXiv:2409.12191 (Qwen2-VL) and its published config, as the JAX
package's ``configs/qwen2_vl_72b.py`` copies it.  The vision frontend is a
stub: precomputed patch embeddings ([B, frontend_tokens, d_model]) are
prepended to the text token embeddings, and M-RoPE position ids (three
streams: temporal / height / width) cover the combined sequence.
Training, as there: full remat and 16 microbatches per step.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    mrope_sections=(16, 24, 24),     # t/h/w sections of head_dim/2 = 64
    rope_theta=1000000.0,
    act="swiglu",
    frontend_tokens=1024,            # stub patch embeddings per sample
    remat="full",
    train_microbatches=16,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
