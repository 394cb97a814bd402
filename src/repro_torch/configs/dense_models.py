"""The assigned dense configs, copied from the reference package
(``configs/qwen3_4b.py``, ``configs/qwen2_7b.py``,
``configs/starcoder2_15b.py``, ``configs/deepseek_67b.py``)."""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

# qwen3-4b: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936 — qk_norm,
# GQA [hf:Qwen/Qwen3-8B; hf]. head_dim=128 (explicit in Qwen3).
QWEN3_4B = register(ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    max_seq_len=32768,
    activation="silu",
    ffn_kind="glu",
    norm_kind="rmsnorm",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
))

# qwen2-7b: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 — GQA,
# QKV bias [arXiv:2407.10671; hf].
QWEN2_7B = register(ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    max_seq_len=32768,
    activation="silu",
    ffn_kind="glu",
    norm_kind="rmsnorm",
    qkv_bias=True,
    rope_theta=1_000_000.0,
))

# starcoder2-15b: 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152 —
# GQA, RoPE [arXiv:2402.19173; hf]. GELU MLP, layernorm.
STARCODER2_15B = register(ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    max_seq_len=16384,
    activation="gelu",
    ffn_kind="mlp",
    norm_kind="layernorm",
    qkv_bias=True,  # starcoder2 uses bias on attention & mlp projections
    rope_theta=100_000.0,
))

# deepseek-67b: 95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400 —
# llama-arch [arXiv:2401.02954; hf].
DEEPSEEK_67B = register(ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    max_seq_len=4096,
    activation="silu",
    ffn_kind="glu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
))
