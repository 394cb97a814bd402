"""Gradient compression for the data-parallel reduction (the reference's
``optim/compression.py``): int8 quantization with error feedback (EF-SGD
style). The wire format is int8, a quarter of the f32 gradient's bytes;
the quantization error is carried in an error-feedback buffer, so the
error of one step is sent with the next.

Used by the DDP step (``train/ddp.py``). One step of ``compressed_mean``
makes one gather over the data axis, however many leaves the tree has:
every leaf's int8 payload in one flat buffer and their scales in one f32
buffer, packed together as bytes (``comm.data_gather``). ``compress`` and
``decompress_mean`` are its two halves, the collective between them.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.sharding import comm
from repro_torch.tree import flatten, tree_map, unflatten

Tree = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 0-d): scale = max |x| / 127 + 1e-12, q = x /
    scale rounded half to even (as ``jnp.round``) and clipped to ±127."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_ef_state(params: Tree) -> Tree:
    """Zero f32 error-feedback buffers shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress(grads: Tree, ef: Tree):
    """This rank's half before the collective: each leaf's g + e quantized.
    Returns (payload (N,) int8, every leaf's q flattened in leaf order;
    scales (n_leaves,) f32; the new error feedback, g + e - q * scale)."""
    qs, scales, new_e = [], [], []
    for g, e in zip(flatten(grads), flatten(ef)):
        gf = g.to(torch.float32) + e
        q, scale = quantize_int8(gf)
        new_e.append(gf - dequantize_int8(q, scale))
        qs.append(q.reshape(-1))
        scales.append(scale)
    return torch.cat(qs), torch.stack(scales), unflatten(ef, new_e)


def decompress_mean(payloads: torch.Tensor, scales: torch.Tensor,
                    grads: Tree) -> Tree:
    """The half after it: payloads (n, N) int8 and scales (n, n_leaves)
    f32 of the n ranks in rank order -> the mean gradient, each leaf the
    sum over the ranks of q * scale in f32 in rank order, divided by n, in
    its gradient's dtype."""
    n = payloads.shape[0]
    out: List[torch.Tensor] = []
    at = 0
    for i, g in enumerate(flatten(grads)):
        k = g.numel()
        total = torch.zeros(k, dtype=torch.float32, device=payloads.device)
        for r in range(n):
            total = total + payloads[r, at:at + k].to(torch.float32) \
                * scales[r, i]
        out.append((total / n).reshape(g.shape).to(g.dtype))
        at += k
    return unflatten(grads, out)


def compressed_mean(grads: Tree, ef: Tree, mesh, extra: torch.Tensor = None):
    """The mean of ``grads`` over the rows of ``mesh``'s data axis with an
    int8 wire and error feedback: ``compress``, one ``comm.data_gather`` of
    the payload and the scales (with ``extra``, f32 values sent beside
    them, e.g. the loss), ``decompress_mean``. Returns (mean grads, new
    ef, the gathered extras (n, len(extra)) or None)."""
    payload, scales, new_ef = compress(grads, ef)
    f32 = scales if extra is None else torch.cat([scales, extra.reshape(-1)])
    pays, sc = comm.data_gather([payload, f32], mesh)
    L = scales.numel()
    mean = decompress_mean(pays, sc[:, :L], grads)
    return mean, new_ef, (None if extra is None else sc[:, L:])
