"""The assigned configs of the other families, copied from the reference
package (``configs/falcon_mamba_7b.py``, ``configs/zamba2_7b.py``,
``configs/whisper_small.py``, ``configs/internvl2_1b.py``)."""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

# falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) d_ff=0
# vocab=65024, ssm_state=16 — the Mamba-1 architecture [arXiv:2410.05355].
FALCON_MAMBA_7B = register(ModelConfig(
    name="falcon-mamba-7b",
    family="mamba",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    max_seq_len=524288,
    activation="silu",  # the mamba gate; relufication swaps it
    norm_kind="rmsnorm",
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    subquadratic=True,
))

# zamba2-7b [hybrid]: 81 Mamba-2 blocks d_model=3584, ssm_state=64, and ONE
# shared attention+FFN block (32H MHA, d_ff=14336) applied every 6 layers
# (13 applications); vocab 32000 [arXiv:2411.15242].
ZAMBA2_7B = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,  # MHA in the shared block
    d_ff=14336,
    vocab_size=32000,
    max_seq_len=524288,
    activation="silu",
    ffn_kind="glu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    attn_every=6,
    subquadratic=True,
))

# whisper-small [audio]: 12 encoder + 12 decoder layers, d_model=768, 12H
# MHA, d_ff=3072, vocab 51865; the conv frontend is a stub: callers pass
# frame embeddings (b, n_audio_frames, d_model) [arXiv:2212.04356].
WHISPER_SMALL = register(ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    n_encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    max_seq_len=32768,  # a 32k decoder cache
    activation="gelu",
    ffn_kind="mlp",
    norm_kind="layernorm",
    use_rope=False,  # learned positions (decoder) + sinusoidal (encoder)
    n_audio_frames=1500,
))

# internvl2-1b [vlm]: the InternLM2-style backbone, 24L d_model=896 14H
# (GQA kv=2) d_ff=4864 vocab=151655; the ViT frontend is a stub: callers
# pass patch embeddings (b, n_vision_tokens, d_model) [arXiv:2404.16821].
INTERNVL2_1B = register(ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    max_seq_len=32768,
    activation="silu",
    ffn_kind="glu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    n_vision_tokens=256,
))
