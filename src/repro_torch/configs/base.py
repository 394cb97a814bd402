"""Config schema of the PyTorch port: a copy of the reference package's
``configs/base.py`` (``ModelConfig``, ``SparsityConfig``, ``ShapeConfig``,
``TrainConfig``), kept apart so the port imports nothing of the JAX package.

Every architecture (assigned pool + the paper's own models) is described by a
single ``ModelConfig``. The relufication surgery (paper Sec. 4) operates on
these configs: stage 1 rewrites ``activation``; stage 2 flips
``post_norm_relu``. Sparse-inference knobs (tile capacity, shift) live here
too so a config is a complete, serializable description of a deployment.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

# ---------------------------------------------------------------------------
# helpers


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SparsityConfig:
    """Knobs for exploiting activation sparsity at inference (paper Sec. 4/5)."""

    enabled: bool = False
    # fraction of d_ff tiles loaded at decode (static capacity). 1.0 == dense.
    ffn_tile_density: float = 1.0
    # stage-2: density for QKV/up-projection *input* (d_model) tiles.
    input_tile_density: float = 1.0
    tile_size: int = 128
    # shifted ReLU (paper Sec. 5.3): activation is relu(x - shift).
    shift: float = 0.0
    # gamma-window weight reuse (paper Sec. 5.1 / Fig. 7c): refresh the active
    # tile set every `reuse_window` decoded tokens; 0 = refresh every token.
    reuse_window: int = 0
    # shard-local grouped tile selection: groups aligned to the TP degree so
    # the weight gather never crosses shards (beyond-paper §Perf opt; 1 = the
    # paper-faithful global top-k)
    n_groups: int = 1
    # activation-sparsity predictor (predictor serving mode, repro.predictor):
    # skip up+down projection weight reads for neurons predicted inactive.
    predictor: str = "none"        # none | sign | lowrank
    predictor_rank: int = 8        # low-rank factor rank (lowrank kind)
    predictor_recall: float = 0.99  # calibration target recall
    probe_dtype: str = "bfloat16"  # sign-probe precision (f32 = exact)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    family: str = "dense"  # dense | moe | mamba | hybrid | encdec | vlm
    # -- core dims ----------------------------------------------------------
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 512
    max_seq_len: int = 2048
    # -- flavor knobs -------------------------------------------------------
    activation: str = "silu"  # see core/activations.py registry
    ffn_kind: str = "glu"  # glu (gate*up) | mlp (single up)
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    post_norm_relu: bool = False  # relufication stage 2
    qk_norm: bool = False  # qwen3
    qkv_bias: bool = False  # qwen2
    rope_theta: float = 10000.0
    use_rope: bool = True  # OPT/whisper use learned/sinusoidal abs positions
    tie_embeddings: bool = False
    sliding_window: int = 0  # 0 = global attention (mixtral SWA supported)
    # -- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_group_size: int = 4096  # tokens per dispatch group (bounds dispatch flops)
    # -- SSM (mamba) --------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64  # mamba2 head dim
    ssm_chunk: int = 128  # chunked-scan chunk length
    # -- hybrid (zamba2) ----------------------------------------------------
    attn_every: int = 0  # insert shared attention block every N layers
    # -- encdec (whisper) ---------------------------------------------------
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500
    # -- vlm (internvl2) ----------------------------------------------------
    n_vision_tokens: int = 0
    # -- sparsity / relufication -------------------------------------------
    sparsity: SparsityConfig = field(default_factory=SparsityConfig)
    # -- numerics ------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # -- long context --------------------------------------------------------
    subquadratic: bool = False  # True for ssm/hybrid: long_500k cells run
    # Megatron-SP-style sharded residuals: block in/outputs (and hence the
    # remat-saved activations) are sharded over the model axis on d_model
    sp_residuals: bool = False

    # ------------------------------------------------------------------ derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def padded_vocab(self, multiple: int = 2048) -> int:
        return round_up(self.vocab_size, multiple)

    def padded_heads(self, tp: int = 16) -> int:
        return round_up(self.n_heads, tp)

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:  # mamba2 heads
        return self.d_inner // self.ssm_head_dim

    # ------------------------------------------------------------------ misc
    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def replace_sparsity(self, **kw) -> "ModelConfig":
        return self.replace(sparsity=dataclasses.replace(self.sparsity, **kw))

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "ModelConfig":
        d = json.loads(s)
        d["sparsity"] = SparsityConfig(**d.get("sparsity", {}))
        return ModelConfig(**d)


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned (input-shape) cell: what gets lowered in the dry-run."""

    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int
    num_microbatches: int = 1


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class TrainConfig:
    """The reference's fields and defaults. As in the reference,
    ``zero_stage`` selects nothing: the builder that is called decides the
    layout (``make_train_step`` on one device, ``train/ddp.py`` replicated
    over "data", ``train/fsdp.py`` by the rules' train mode: params and
    moments split over (data, model), whatever the field holds).
    ``grad_compression`` "none" or "int8_ef" (the DDP step's int8 wire
    with error feedback, ``train/ddp.py``)."""

    learning_rate: float = 1.5e-5  # paper's fine-tuning LR
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"  # constant | cosine | linear
    zero_stage: int = 1  # 0: replicated opt state, 1: sharded over dp, 3: fsdp params
    remat_policy: str = "minimal"  # none | minimal | full | save_ars
    num_microbatches: int = 1
    grad_compression: str = "none"  # none | int8_ef
    skip_nonfinite: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.grad_compression not in ("none", "int8_ef"):
            raise ValueError(f"grad_compression={self.grad_compression!r}: "
                             "'none' or 'int8_ef'")
