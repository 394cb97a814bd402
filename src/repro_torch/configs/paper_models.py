"""The paper's own dense models (OPT / Llama-v1 / Falcon), copied from the
reference package. OPT uses ReLU already; Llama/Falcon are the
relufication subjects (stage 1: SiLU/GELU -> ReLU; stage 2: post-norm ReLU).
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

OPT_1_3B = register(ModelConfig(
    name="opt-1.3b", family="dense", n_layers=24, d_model=2048, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab_size=50272, max_seq_len=2048,
    activation="relu", ffn_kind="mlp", norm_kind="layernorm", use_rope=False,
    tie_embeddings=True,
))

OPT_2_7B = register(ModelConfig(
    name="opt-2.7b", family="dense", n_layers=32, d_model=2560, n_heads=32,
    n_kv_heads=32, d_ff=10240, vocab_size=50272, max_seq_len=2048,
    activation="relu", ffn_kind="mlp", norm_kind="layernorm", use_rope=False,
    tie_embeddings=True,
))

OPT_6_7B = register(ModelConfig(
    name="opt-6.7b", family="dense", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=32, d_ff=16384, vocab_size=50272, max_seq_len=2048,
    activation="relu", ffn_kind="mlp", norm_kind="layernorm", use_rope=False,
    tie_embeddings=True,
))

LLAMA_7B = register(ModelConfig(
    name="llama-7b", family="dense", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=32, d_ff=11008, vocab_size=32000, max_seq_len=2048,
    activation="silu", ffn_kind="glu", norm_kind="rmsnorm",
))

FALCON_7B = register(ModelConfig(
    name="falcon-7b", family="dense", n_layers=32, d_model=4544, n_heads=71,
    n_kv_heads=1, d_ff=18176, vocab_size=65024, max_seq_len=2048,
    activation="gelu", ffn_kind="mlp", norm_kind="layernorm",
))
