"""The training step (the reference's ``train/step.py``): the LM loss,
remat policies, microbatched gradient accumulation, global-norm clipping,
AdamW and non-finite-step skipping.

The step runs eagerly on the params' device and never syncs the host:
the loss, the norm, the learning rate and the skip decision stay device
tensors, and a skipped step is a ``torch.where`` over the params, both
moments and the optimizer step, as the reference's tree-wide
``jnp.where``. Params are f32 masters; the model casts them to the compute
dtype at its entry, so their gradients come back in f32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.optim import adamw, schedules
from repro_torch.tree import flatten, tree_map, unflatten


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            remat_policy: str = "none",
            stats: cm.StatsCollector = cm.NO_STATS) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy on batch["tokens"] (b, s), the mean over
    the (b, s - 1) targets, or over those an optional batch["loss_mask"]
    (b, s) keeps. The log-sum-exp is taken in f32 after the max is
    subtracted in the compute dtype, as in the reference. ``remat_policy``
    wraps each block (``common.wrap_block``). Returns (loss, aux) with aux
    = {"loss": loss} plus an active ``stats``' sites."""
    logits = registry.get_family(cfg).model_forward(
        params, batch, cfg, stats=stats, remat_policy=remat_policy)
    tokens = batch["tokens"]
    tgt = tokens[:, 1:].long()
    lg = logits[:, :-1]
    m = lg.amax(-1)
    shifted = (lg - m[..., None]).float()
    lse = m.float() + torch.log(torch.exp(shifted).sum(-1))
    nll = lse - lg.gather(-1, tgt[..., None])[..., 0].float()
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, 1:].float()
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        loss = nll.mean()
    aux = {"loss": loss}
    if stats.active:
        aux.update(stats.stats)
    return loss, aux


def loss_and_grads(params, batch, cfg: ModelConfig, remat_policy: str = "none"
                   ) -> Tuple[torch.Tensor, Dict]:
    """(loss, grads shaped like params): ``jax.value_and_grad`` of
    ``lm_loss``. The params themselves are not marked: their leaves are
    detached aliases here."""
    leaves = [p.detach().requires_grad_(True) for p in flatten(params)]
    with torch.enable_grad():
        loss, _ = lm_loss(unflatten(params, leaves), batch, cfg,
                          remat_policy=remat_policy)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), unflatten(params, grads)


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), with metrics {"loss", "grad_norm", "lr", "step_ok"} as 0-d
    f32 device tensors.

    batch["tokens"]: (global_batch, seq), cut into tc.num_microbatches
    slices along the batch: their gradients are summed in f32, then
    divided by the count, and the loss is the mean of theirs."""

    def train_step(params, opt_state: adamw.OptState, batch):
        nmb = tc.num_microbatches
        if nmb <= 1:
            loss, grads = loss_and_grads(params, batch, cfg, tc.remat_policy)
        else:
            b = batch["tokens"].shape[0]
            if b % nmb:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"{nmb} microbatches")
            mbs = [{k: v[i * (b // nmb):(i + 1) * (b // nmb)]
                    for k, v in batch.items()} for i in range(nmb)]
            g_sum = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in flatten(params)]
            l_sum = torch.zeros((), dtype=torch.float32,
                                device=batch["tokens"].device)
            for mb in mbs:
                loss_i, g = loss_and_grads(params, mb, cfg, tc.remat_policy)
                for acc, gi in zip(g_sum, flatten(g)):
                    acc.add_(gi)
                l_sum = l_sum + loss_i
                del g
            for g in g_sum:
                g.div_(nmb)
            grads = unflatten(params, g_sum)
            del g_sum
            loss = l_sum / nmb

        grads, gnorm = adamw.clip_by_global_norm(grads, tc.grad_clip)
        lr = schedules.learning_rate(opt_state.step, tc)
        new_params, new_opt = adamw.adamw_update(grads, opt_state, params,
                                                 lr, tc)
        del grads
        if tc.skip_nonfinite:
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)

            def keep(new, old):  # into the new tensor: no second copy
                return torch.where(ok, new, old, out=new)

            new_params = tree_map(keep, new_params, params)
            new_opt = tree_map(keep, new_opt, opt_state)
        else:
            ok = torch.ones((), dtype=torch.bool, device=loss.device)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "step_ok": ok.float()}
        return new_params, new_opt, metrics

    return train_step
