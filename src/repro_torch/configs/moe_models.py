"""The MoE family's configs, copied from the reference package
(``configs/mixtral_8x22b.py``, ``configs/phi35_moe.py``)."""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

# mixtral-8x22b: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
# 8 experts top-2, sliding window [arXiv:2401.04088; hf]
MIXTRAL_8X22B = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    max_seq_len=65536,
    activation="silu",
    ffn_kind="glu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000.0,
    sliding_window=4096,
    n_experts=8,
    top_k=2,
    moe_group_size=1024,
))

# phi3.5-moe-42b-a6.6b: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
# vocab=32064, 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]
PHI35_MOE = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    max_seq_len=131072,
    activation="silu",
    ffn_kind="glu",
    norm_kind="layernorm",
    rope_theta=10000.0,
    n_experts=16,
    top_k=2,
    moe_group_size=1024,
))
