"""The contrastive CLAP loss (port of open_musiclm_tpu/train/clip_loss.py).

A symmetric cross-entropy over the audio <-> text similarity logits of a
batch (laion_clap's ``ClipLoss``), optionally in the CLAP paper's
``mlp_loss`` form (audio against the text MLP head and text against the
audio MLP head). With a process group the features of every rank are
gathered first (``gather_features``), so each rank's loss is the loss over
the global batch; the gather passes gradients back to the rank that owns the
rows, as the JAX package's ``all_gather(tiled=True)`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's [n, ...] rows, concatenated in rank order. The
    gradient of the gathered tensor is summed over the ranks (an
    all-reduce: each rank's loss reads every row) and this rank's slice
    returned. Only all_gather and all_reduce, which gloo and NCCL both
    have."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        ctx.rank, ctx.n = dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank * ctx.n: (ctx.rank + 1) * ctx.n], None


def gather_features(features: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of ``features`` along dim 0 with gradients to their
    owners; the identity without a ``group``."""
    if group is None:
        return features
    return _GatherRows.apply(features, group)


def _sym_ce(logits_a: torch.Tensor, logits_t: torch.Tensor) -> torch.Tensor:
    labels = torch.arange(logits_a.shape[0], device=logits_a.device)
    return (F.cross_entropy(logits_a, labels) + F.cross_entropy(logits_t, labels)) / 2.0


def clip_loss(audio_features: torch.Tensor, text_features: torch.Tensor, logit_scale_a: torch.Tensor,
              *, group=None) -> torch.Tensor:
    """audio / text features [N, D] (L2-normalized), ``logit_scale_a`` the
    exponentiated scale: the symmetric contrastive loss (mlp_loss off)."""
    a = gather_features(audio_features, group)
    t = gather_features(text_features, group)
    logits = logit_scale_a * a @ t.T
    return _sym_ce(logits, logits.T)


def clip_loss_mlp(audio_features: torch.Tensor, text_features: torch.Tensor,
                  audio_features_mlp: torch.Tensor, text_features_mlp: torch.Tensor,
                  logit_scale_a: torch.Tensor, logit_scale_t: torch.Tensor, *, group=None) -> torch.Tensor:
    """The mlp_loss form: audio against the text MLP head under scale a, text
    against the audio MLP head under scale t, averaged."""
    a = gather_features(audio_features, group)
    t = gather_features(text_features, group)
    am = gather_features(audio_features_mlp, group)
    tm = gather_features(text_features_mlp, group)
    a_logits = logit_scale_a * a @ tm.T
    t_logits = logit_scale_t * t @ am.T
    return (_sym_ce(a_logits, a_logits.T) + _sym_ce(t_logits, t_logits.T)) / 2.0
