"""Meta-tensor input specs and step builders of the dry run (the
reference's ``launch/specs.py``).

Where the reference lowers ``jax.jit`` of each step over
``ShapeDtypeStruct`` stand-ins, the port builds one rank's step and its
arguments on the "meta" device: tensors with shapes and dtypes and no
storage, of the sizes that rank holds. Running the step on them dispatches
every op of the rank (``launch/op_cost.py`` counts them) and issues its
collectives on the world the mesh was made over (the dry run's "fake"
world moves nothing). Nothing is allocated on any device.

Dtypes are the deployed ones: the compute dtype of the config (bf16) for
serving weights, caches and activations; f32 masters and AdamW moments in
training.

Layouts: the train step's state is ``train/fsdp.py``'s (the rules' train
mode); serving weights are the serving engine's (the rules' serve mode on
the mesh's model row: split over "model", whole over the data axes; the
SSM leaves by the family's blocks, ``models/common.py::leaf_sharding``);
the legacy cache is the family's own ``init_cache`` under the mesh, of the
rank's rows of the batch (its K/V sequence-sharded as
``rules.cache_pspec`` lays it out, its SSM states and conv tails the
rank's d_inner units or heads, Whisper's cross K/V its kv heads, as
``model_prefill`` makes them); batches and tokens split over the data
axes by ``rules.batch_pspec``.

Each ``build_*`` returns (step, args): ``step(*args)`` runs the rank's
step. ``device`` (default "meta") puts the rank's arguments on a real
device instead, zero-filled: the same step run for real (the tests hold
a dry run against a gloo run of the same cell).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.sharding import comm, rules

META = torch.device("meta")


def _cdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The whole model inputs of one cell, on "meta": the batch dict of a
    train / prefill cell (tokens, and the VLM's patches or the encoder's
    frames in the compute dtype), or a decode cell's (token, pos)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        out = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}
        if cfg.family == "vlm":
            out["patches"] = torch.empty((B, cfg.n_vision_tokens, cfg.d_model),
                                         dtype=_cdt(cfg), device=META)
        if cfg.family == "encdec":
            out["frames"] = torch.empty((B, cfg.n_audio_frames, cfg.d_model),
                                        dtype=_cdt(cfg), device=META)
        return out
    return {"token": torch.empty((B,), dtype=torch.int32, device=META),
            "pos": torch.empty((B,), dtype=torch.int32, device=META)}


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict:
    """``rules.Sharding`` of each input of ``input_specs``: the batch dim
    over the data axes where it fits (``rules.batch_pspec``)."""
    return {k: rules.Sharding(mesh, rules.batch_pspec(
                shape.global_batch, mesh, v.dim() - 1))
            for k, v in input_specs(cfg, shape).items()}


def params_spec(cfg: ModelConfig) -> Dict:
    """The whole serving parameter tree on "meta", in the compute dtype as
    serving stores it (the train step's f32 masters:
    ``train/fsdp.py::param_shapes``)."""
    return registry.get_family(cfg).init_params(cfg, device="meta",
                                                dtype=_cdt(cfg))


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """The whole legacy cache of a decode cell on "meta"."""
    return registry.get_family(cfg).init_cache(
        cfg, shape.global_batch, shape.seq_len, device="meta")


def local(t: torch.Tensor, sharding: rules.Sharding,
          device=META) -> torch.Tensor:
    """A fresh tensor of this rank's block of ``t`` (its own storage,
    sized to the block) on ``device``: empty on "meta", zeros elsewhere."""
    shape = tuple(sharding.block(t).shape)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=t.dtype, device=META)
    return torch.zeros(shape, dtype=t.dtype, device=device)


def _local_tree(tree, shardings, device=META):
    if isinstance(tree, dict):
        return {k: _local_tree(tree[k], shardings[k], device) for k in tree}
    return local(tree, shardings, device)


def _serving_params(cfg: ModelConfig, mesh, device=META) -> Dict:
    """This rank's serving blocks (the engine's layout: serve rules on
    the model row, the family's SSM blocks)."""
    whole = params_spec(cfg)
    return _local_tree(whole, cm.params_shardings(
        cfg, whole, mesh.model_row(), "serve"), device)


def build_train(cfg: ModelConfig, shape: ShapeConfig, mesh, tc: TrainConfig,
                device=META):
    """The FSDP + TP train step (``train/fsdp.py``) on this rank: args =
    (its f32 param blocks, their AdamW state, the global batch)."""
    from repro_torch.optim import adamw
    from repro_torch.train import fsdp
    whole = fsdp.param_shapes(cfg)
    blocks = _local_tree(whole, fsdp.state_shardings(cfg, mesh)[0], device)
    opt = adamw.init_opt_state(blocks)
    batch = {k: local(v, rules.Sharding(mesh, (None,) * v.dim()), device)
             for k, v in input_specs(cfg, shape).items()}
    return fsdp.make_fsdp_train_step(cfg, tc, mesh), (blocks, opt, batch)


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh, device=META):
    """The legacy whole-prompt prefill on this rank: its rows of the batch
    under the mesh's model axis; returns (logits, its rows of the cache)."""
    params = _serving_params(cfg, mesh, device)
    batch = _local_tree(input_specs(cfg, shape),
                        batch_shardings(cfg, shape, mesh), device)
    fam = registry.get_family(cfg)

    def step(params, batch):
        with torch.inference_mode(), comm.serving(mesh):
            return fam.model_prefill(params, batch, cfg, shape.seq_len)

    return step, (params, batch)


def build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh, device=META):
    """One legacy decode step on this rank: its rows of the batch against
    its block of the cache (the family's ``init_cache`` under the mesh, of
    those rows), written in place."""
    params = _serving_params(cfg, mesh, device)
    inp = _local_tree(input_specs(cfg, shape),
                      batch_shardings(cfg, shape, mesh), device)
    fam = registry.get_family(cfg)
    with comm.serving(mesh):
        cache = fam.init_cache(cfg, inp["token"].shape[0], shape.seq_len,
                               device=device)

    def step(params, cache, token, pos):
        with torch.inference_mode(), comm.serving(mesh):
            return fam.model_decode(params, cache, token, pos, cfg)

    return step, (params, cache, inp["token"], inp["pos"])


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               tc: TrainConfig = None, device=META):
    """The cell's step and args on this rank (``build_train`` with the
    shape's microbatches and the "minimal" remat unless ``tc`` says,
    ``build_prefill`` or ``build_decode``)."""
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, tc or TrainConfig(
            num_microbatches=shape.num_microbatches, remat_policy="minimal"),
            device)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, device)
    return build_decode(cfg, shape, mesh, device)
