"""Tiny configs for CPU tests (copies of the reference's tiny.py)."""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

TINY = register(ModelConfig(
    name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab_size=256, max_seq_len=256,
    activation="silu", ffn_kind="glu", norm_kind="rmsnorm",
))

TINY_RELU = register(TINY.replace(name="tiny-relu", activation="relu"))

TINY_OPT = register(ModelConfig(
    name="tiny-opt", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=256, vocab_size=256, max_seq_len=256,
    activation="relu", ffn_kind="mlp", norm_kind="layernorm", use_rope=False,
    tie_embeddings=True,
))

# capacity_factor >= n_experts makes routing drop-free (cap >= tokens·top_k),
# the precondition for the serving paths' batch-shape-invariant byte
# exactness (models/moe.py); moe_group_size > any serving batch keeps G = 1
TINY_MOE = register(ModelConfig(
    name="tiny-moe", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab_size=256, max_seq_len=256,
    activation="relu", ffn_kind="mlp", norm_kind="rmsnorm",
    n_experts=4, top_k=2, capacity_factor=8.0, moe_group_size=64,
))
