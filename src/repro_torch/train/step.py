"""The LM loss of the reference's ``train/step.py``, forward only: the
legacy ``ServeEngine.score`` reads it. The training step itself (remat,
microbatching, clipping, AdamW) is not ported yet (ROADMAP.md)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import registry


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            stats: cm.StatsCollector = cm.NO_STATS) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy on batch["tokens"] (b, s), the mean over
    the (b, s - 1) targets, or over those an optional batch["loss_mask"]
    (b, s) keeps. The log-sum-exp is taken in f32 after the max is
    subtracted in the compute dtype, as in the reference. Returns (loss,
    aux) with aux = {"loss": loss} plus an active ``stats``' sites."""
    logits = registry.get_family(cfg).model_forward(params, batch, cfg,
                                                    stats=stats)
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
