"""The data-parallel train step with explicit collectives (the reference's
``train/ddp.py``), and optional int8 error-feedback gradient compression
(``optim/compression.py``).

Params, optimizer state and the error-feedback buffers are replicated on
every rank of the data axis; each rank takes its rows of the global batch,
computes its loss and gradients (``train/step.py``), and the gradients'
mean over the axis is explicit: one all-reduce of every leaf (and the
loss) in one f32 buffer, or the compressed mean. The loss is the mean of
the ranks' losses, as the reference's ``pmean``. Then the clip by global
norm, the schedule's learning rate and AdamW, the same on every rank. As
in the reference, the step has no non-finite skip.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.optim import adamw, compression, schedules
from repro_torch.sharding import comm
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import flatten, unflatten


def make_ddp_train_step(cfg: ModelConfig, tc: TrainConfig, mesh,
                        axis: str = "data"):
    """Returns step(params, opt_state, ef, batch) -> (params, opt_state,
    ef, metrics) on this rank of ``mesh`` (``launch.mesh.Mesh``): batch is
    the global batch, whose rows split evenly over the data axis (the
    reference's ``axis``; the port's meshes name no other); metrics are
    {"loss", "grad_norm", "lr"}, 0-d f32 tensors equal on every rank. ef
    (``compression.init_ef_state``) changes only under
    ``grad_compression="int8_ef"``. The collectives are ``comm``'s, timed
    in ``comm.STATS`` on the data axis."""
    if axis != "data":
        raise ValueError(f"the DDP step reduces over 'data', not {axis!r}")
    compress = tc.grad_compression == "int8_ef"
    n, index = mesh.shape["data"], mesh.coords["data"]

    def step(params, opt_state: adamw.OptState, ef, batch):
        b = batch["tokens"].shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split over {n} ranks")
        rows = slice(index * (b // n), (index + 1) * (b // n))
        loss, grads = loss_and_grads(params, {k: v[rows]
                                              for k, v in batch.items()},
                                     cfg, tc.remat_policy)
        if compress:
            grads, ef, losses = compression.compressed_mean(
                grads, ef, mesh, extra=loss)
            loss = losses.sum() / n
        else:
            leaves = flatten(grads)
            buf = torch.cat([g.to(torch.float32).reshape(-1) for g in leaves]
                            + [loss.reshape(1).to(torch.float32)])
            buf = comm.data_sum(buf, mesh) / n
            out, at = [], 0
            for g in leaves:
                out.append(buf[at:at + g.numel()].reshape(g.shape).to(g.dtype))
                at += g.numel()
            grads, loss = unflatten(grads, out), buf[at]
        grads, gnorm = adamw.clip_by_global_norm(grads, tc.grad_clip)
        lr = schedules.learning_rate(opt_state.step, tc)
        params, opt_state = adamw.adamw_update(grads, opt_state, params, lr,
                                               tc)
        return params, opt_state, ef, {"loss": loss, "grad_norm": gnorm,
                                       "lr": lr}

    return step
