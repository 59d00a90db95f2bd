"""Tensor parallelism over the mesh's ``tp`` axis (port of
open_musiclm_tpu/parallel/sharding.py).

The JAX package places a stage's weights over ``tp`` by name (``RULES``) and
lets GSPMD insert the collectives. The port splits the weights by a rule
table over its own parameter names and runs the layers Megatron-style:

  * column parallel: ``to_q`` (whole heads a rank) and ``proj_in`` (the
    rank's slice of GEGLU's value half and the matching slice of its gate
    half; ``conv_w`` and ``norm_mid`` follow those channels);
  * row parallel: ``to_out`` and ``proj_out``, each followed by an
    all-reduce over ``tp`` (``reduce_from_tp``);
  * vocab parallel: ``embeds.i`` (a lookup masks the ids outside the rank's
    rows and all-reduces) and ``logit_heads.i`` (the logits are gathered
    along C);
  * replicated: everything else. ``to_kv`` stays whole: under MQA it is one
    K/V head, and splitting its 2 x dim_head outputs would give k to one
    rank and v to the other, so every rank computes it (the JAX rules split
    it).

A split happens only where its dimension divides by ``tp`` (whole heads for
attention, whole channel pairs for the feed-forward), as ``spec_for`` there
decides; at the shipped configs the logit heads (1,025 codes) stay
replicated. A block's input passes ``copy_to_tp`` (identity forward,
all-reduce backward), so the residual stream's gradient is whole on every
rank; the replicated parameters inside a split block (its norm's gamma,
``to_kv``, the q/k scales, the rel-pos MLP, whose [h, n, m] bias each rank
reads at its own heads) then hold each rank's share of their gradient,
which ``StageTrainer`` sums over ``tp`` (``partial``).

All-reduces over ``tp`` sum in float32 (a bf16 activation is widened for
the sum and rounded once).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import Mesh


# ---------------------------------------------------------------------------
# collectives with their gradients
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=mesh.tp_group)
    return y.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(mesh.tp)]
        dist.all_gather(parts, x.contiguous(), group=mesh.tp_group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        t, w = ctx.mesh.tp_rank, ctx.width
        return g[..., t * w:(t + 1) * w], None


def copy_to_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Identity forward; the gradient is summed over ``tp`` (a column-parallel
    block's input)."""
    return _CopyToTP.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over ``tp`` forward; identity backward (a row-parallel
    block's output, whose gradient is whole on every rank)."""
    return _ReduceFromTP.apply(x, mesh)


def sum_over_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over ``tp`` both ways: partial sums that every rank reads
    only through its own share (a LayerNorm's statistics over split
    channels)."""
    return _SumOverTP.apply(x, mesh)


def gather_from_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every ``tp`` rank's ``x`` along the last dim in rank order; the
    backward keeps this rank's columns (the gradient of the whole is the same
    on every rank)."""
    return _GatherFromTP.apply(x, mesh)


# ---------------------------------------------------------------------------
# the rule table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Split:
    """A parameter split along ``dim`` into ``tp`` equal parts, rank t taking
    part t; ``paired``: the dim holds two halves ([value | gate]) and rank t
    takes part t of each."""

    dim: int
    paired: bool = False


# (parameter name, split dim, what must divide by tp, paired). "heads": the
# stage's heads; "inner": the feed-forward's channels; "rows": the split dim
RULES: Tuple[Tuple[str, int, str, bool], ...] = (
    (r"^transformer\.attns\.\d+\.to_q\.weight$", 0, "heads", False),
    (r"^transformer\.attns\.\d+\.to_out\.weight$", 1, "heads", False),
    (r"^transformer\.ffs\.\d+\.proj_in\.weight$", 0, "inner", True),
    (r"^transformer\.ffs\.\d+\.conv_w$", 1, "inner", True),
    (r"^transformer\.ffs\.\d+\.norm_mid\.gamma$", 0, "inner", False),
    (r"^transformer\.ffs\.\d+\.proj_out\.weight$", 1, "inner", False),
    (r"^embeds\.\d+\.weight$", 0, "rows", False),
    (r"^logit_heads\.\d+$", 1, "rows", False),
)

# replicated parameters of a split block, whose gradient each rank holds a
# share of
PARTIAL: Tuple[Tuple[str, str], ...] = (
    (r"^transformer\.attns\.\d+\.(norm\.gamma|to_kv\.weight|q_scale|k_scale)$", "heads"),
    (r"^transformer\.rel_pos_bias\.", "heads"),
    (r"^transformer\.ffs\.\d+\.norm_in\.gamma$", "inner"),
)


def spec_for(name: str, shape: Sequence[int], tp: int, heads: int, inner: int) -> Optional[Split]:
    """The split of parameter ``name`` (whole shape ``shape``) over ``tp``
    ranks, or None (replicated)."""
    if tp <= 1:
        return None
    for pattern, dim, unit, paired in RULES:
        if re.search(pattern, name):
            n = {"heads": heads, "inner": inner, "rows": shape[dim]}[unit]
            return Split(dim, paired) if n % tp == 0 else None
    return None


def shard_plan(model: nn.Module, tp: int) -> Tuple[Dict[str, Split], FrozenSet[str]]:
    """(the split parameters, the replicated ones with partial gradients) of
    a whole TokenConditionedTransformer over ``tp`` ranks."""
    tfm = model.transformer
    heads, inner = tfm.heads, tfm.ffs[0].inner_dim
    divides = {"heads": tp > 1 and heads % tp == 0, "inner": tp > 1 and inner % tp == 0}
    splits, partial = {}, set()
    for name, p in model.named_parameters():
        rule = spec_for(name, p.shape, tp, heads, inner)
        if rule is not None:
            splits[name] = rule
        elif any(re.search(pat, name) and divides[unit] for pat, unit in PARTIAL):
            partial.add(name)
    return splits, frozenset(partial)


def take(full: torch.Tensor, rule: Split, t: int, tp: int) -> torch.Tensor:
    """Rank t's part of a whole tensor."""
    if rule.paired:
        return torch.cat([h.chunk(tp, dim=rule.dim)[t] for h in full.chunk(2, dim=rule.dim)], dim=rule.dim)
    return full.chunk(tp, dim=rule.dim)[t]


def put_together(parts: Sequence[torch.Tensor], rule: Split) -> torch.Tensor:
    """The whole tensor from every rank's part, in rank order."""
    if rule.paired:
        halves = [p.chunk(2, dim=rule.dim) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=rule.dim)
    return torch.cat(list(parts), dim=rule.dim)


# ---------------------------------------------------------------------------
# sharding a model, and back
# ---------------------------------------------------------------------------


def shard_module(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Turn a whole TokenConditionedTransformer into this rank's shard, in
    place: each split weight is sliced to rank t's part and the layers learn
    their ``tp`` group. Every rank of a ``tp`` group must hold the same
    whole weights. Returns ``model``; with ``tp`` 1 it is left as it is."""
    if model.tp_mesh is not None:
        raise ValueError("the model is already sharded")
    if mesh.tp <= 1:
        return model
    splits, partial = shard_plan(model, mesh.tp)
    t, tp = mesh.tp_rank, mesh.tp
    with torch.no_grad():
        for name, rule in splits.items():
            prefix, _, leaf = name.rpartition(".")
            owner = model.get_submodule(prefix) if prefix else model
            old = getattr(owner, leaf)
            owner.register_parameter(
                leaf, nn.Parameter(take(old.data, rule, t, tp).clone(), requires_grad=old.requires_grad))
    tfm = model.transformer
    if "transformer.attns.0.to_q.weight" in splits:
        per = tfm.heads // tp
        tfm.head_slice = slice(t * per, (t + 1) * per)
        for attn in tfm.attns:
            attn.tp, attn.heads = mesh, per
            attn.to_q.out_features, attn.to_out.in_features = per * attn.dim_head, per * attn.dim_head
    if "transformer.ffs.0.proj_in.weight" in splits:
        for ff in tfm.ffs:
            per = ff.inner_dim // tp
            ff.tp, ff.inner_full, ff.inner_dim = mesh, ff.inner_dim, per
            ff.proj_in.out_features, ff.proj_out.in_features = 2 * per, per
    n = len(model.specs)
    model.embed_split = tuple(f"embeds.{i}.weight" in splits for i in range(n))
    model.logit_split = tuple(f"logit_heads.{i}" in splits for i in range(n))
    model.tp_mesh, model.tp_splits, model.tp_partial = mesh, splits, partial
    return model


def _gather(local: torch.Tensor, rule: Split, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(local) for _ in range(mesh.tp)]
    dist.all_gather(parts, local.detach().contiguous(), group=mesh.tp_group)
    return put_together(parts, rule)


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole state dict of a sharded model, in the checkpoint layout of
    an unsharded one (every rank of the ``tp`` group must call it; each gets
    it). An unsharded model's own state dict."""
    sd = model.state_dict()
    if model.tp_mesh is None:
        return sd
    return {k: _gather(v, model.tp_splits[k], model.tp_mesh) if k in model.tp_splits else v
            for k, v in sd.items()}


def gather_param_tensors(model: nn.Module, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Tensors shaped as ``model.parameters()`` (optimizer moments), each made
    whole as ``gather_state_dict`` makes its parameter."""
    if model.tp_mesh is None:
        return list(tensors)
    names = [n for n, _ in model.named_parameters()]
    return [_gather(x, model.tp_splits[n], model.tp_mesh) if n in model.tp_splits else x
            for n, x in zip(names, tensors)]


def shard_param_tensors(model: nn.Module, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The inverse of ``gather_param_tensors``: this rank's part of each."""
    if model.tp_mesh is None:
        return list(tensors)
    mesh, names = model.tp_mesh, [n for n, _ in model.named_parameters()]
    return [take(x, model.tp_splits[n], mesh.tp_rank, mesh.tp) if n in model.tp_splits else x
            for n, x in zip(names, tensors)]


def load_whole_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Load a whole (checkpoint-layout) state dict into a model, sharded or
    not: a sharded one takes its rank's part of each split tensor."""
    mesh = model.tp_mesh
    if mesh is not None:
        sd = {k: take(v, model.tp_splits[k], mesh.tp_rank, mesh.tp) if k in model.tp_splits else v
              for k, v in sd.items()}
    model.load_state_dict(sd)
