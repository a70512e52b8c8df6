"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) 32 wkv heads of 64
d_ff=7168 vocab=65536 -- RWKV-6 "Finch": data-dependent decay.

Source: the JAX package's ``configs/rwkv6_1_6b.py``, after the RWKV-6
"Finch" 1.6B model of arXiv:2404.05892 (24 layers, d_model 2048, head size
64, channel-mix width 3.5 x d_model = 7168, vocab 65536, decay LoRA rank
64, token-shift mix LoRA rank 32), layer norm, squared-ReLU channel mix,
bfloat16.  The training fields are the JAX package's copy's (full remat,
4 microbatches), read by ``models/rwkv6.py::loss_fn`` and the training
step.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,            # wkv heads: d_model / 64
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    rwkv_decay_lora=64,
    rwkv_mix_lora=32,
    act="relu_sq",           # rwkv channel-mix uses squared relu
    norm_type="layer",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="full",
    train_microbatches=4,
)
