"""seamless-m4t-large-v2 [audio]: 24 encoder + 24 decoder layers
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206 -- enc-dec, multimodal.

Source: arXiv:2308.11596 (SeamlessM4T v2) and its published config, as the
JAX package's ``configs/seamless_m4t_large_v2.py`` copies it.  The
encoder's 24 layers run over stub audio-frame embeddings ([B, S_enc,
d_model], the speech frontend out of scope, as there); the decoder's 24
layers (causal self-attention, then cross-attention over the encoder's
output) over text tokens.  GELU FFN, layer norm, bfloat16; training as
there: full remat and 8 microbatches per step.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,               # encoder layers
    num_decoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    rope_theta=10000.0,
    act="gelu",
    norm_type="layer",
    frontend_tokens=0,           # encoder input IS the stub embedding stream
    remat="full",
    train_microbatches=8,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
