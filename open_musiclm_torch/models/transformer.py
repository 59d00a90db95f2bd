"""Decoder-only transformer core (port of open_musiclm_tpu/models/transformer.py).

  * bias-free LayerNorm
  * cosine-sim attention with one K/V head shared by all query heads; K and
    V project from the UN-normed residual, Q from the normed one
  * continuous-MLP relative position bias
  * GEGLU conv feed-forward with a causal depthwise 3-tap conv

``forward`` is the full causal pass (training, with an optional key mask
and FF dropout in ``train()`` mode); ``prefill`` is the same pass that also
fills the decode cache (per-layer K, V and the conv-FF tap state);
``decode_step`` is the fp decode step over that cache (the int8 serving
steps live in ``models/quant_decode.py``).

Parameters may be float32 master weights while the pass runs in bfloat16
(the JAX package's ``dtype=bfloat16`` with float32 params): every weight is
cast to the activations' dtype at its use, and LayerNorm returns the
activations' dtype. With weights already in the activations' dtype (the
serving path) the casts are no-ops.

Options no shipped config sets, as the JAX package has them: the plain
``FeedForward`` (``use_conv_ff=False``), the T5 bucketed rel-pos bias
(``ops/relpos.py``) and attention dropout (``Attention``).

``remat`` trades FLOPs for memory, as the JAX package's ``nn.remat`` per
block: ``forward`` runs each attention block and each conv-FF block under
``torch.utils.checkpoint`` (non-reentrant), which keeps a block's input and
recomputes its activations in the backward. The rel-pos bias is computed
once and enters every block as an argument, so its gradient still sums over
the layers. A block's recompute draws its dropout keep mask again from the
generator state its first forward started from, and leaves the generator
where it was, so losses and gradients equal those without remat.

Tensor parallelism (``parallel/sharding.py:shard_module``): a split
attention block holds ``heads / tp`` query heads (``to_q`` columns,
``to_out`` rows, its heads' columns of the rel-pos bias) over the whole
K/V head, a split conv-FF ``inner / tp`` channels (its slice of GEGLU's
value and gate halves, of ``conv_w`` and of ``norm_mid``). A split block's
input passes ``copy_to_tp`` and its output ``reduce_from_tp``; ``norm_mid``
sums its statistics over ``tp`` (``dist_layer_norm``); FF dropout draws the
whole [b, n, inner] mask on every rank of a ``tp`` group and keeps its own
channels, so the ranks of a group, drawing from one generator state, drop
what one process drops.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import l2norm, shared_kv_attention, shared_kv_attention_train, shared_kv_decode_step
from ..ops.relpos import init_linear_, lecun_normal_, linear, make_bias
from ..ops.rows import DECODE_TILE, PREFILL_TILE
from ..parallel.mesh import Mesh
from ..parallel.sharding import copy_to_tp, reduce_from_tp, sum_over_tp


def _aligned_float(x: torch.Tensor) -> torch.Tensor:
    """x in float32 with its rows laid out 16-byte aligned (copied into a
    buffer whose rows are padded to a multiple of 4). A CUDA reduction sums a
    row that starts off a 16-byte boundary in another order, so the conv-FF's
    2730-wide rows (1365-wide a rank at tp 2), which alternate, would round a
    row's statistics by its index, b * n + t, and with an odd n by the batch
    slot the row lies in."""
    d = x.shape[-1]
    if d % 4 == 0:
        return x.float()
    xf = x.new_empty(x.shape[:-1] + (d - d % 4 + 4,), dtype=torch.float32)[..., :d]
    xf.copy_(x)
    return xf


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Bias-free LayerNorm in float32, returned in x's dtype: the JAX
    package's formula on aligned rows. Inference on the card (no autograd)
    takes ``F.layer_norm``, a row a block, whose bits do not depend on how
    many rows there are: the formula's mean and variance of a float32
    tensor's rows, as reductions, take another order at other row counts
    there (``chip_smoke.py --probe``). Training keeps the formula, which
    ``dist_layer_norm`` computes over split channels too."""
    if x.is_cuda and not torch.is_grad_enabled():
        return F.layer_norm(x.float(), x.shape[-1:], gamma.float(), None, eps).to(x.dtype)
    xf = _aligned_float(x)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def dist_layer_norm(x: torch.Tensor, gamma: torch.Tensor, mesh: Mesh, width: int,
                    eps: float = 1e-5) -> torch.Tensor:
    """``layer_norm`` of rows split over ``tp``: x and gamma hold this rank's
    channels of rows ``width`` wide; the mean and the variance are sums over
    every rank's channels, in float32 on aligned rows."""
    xf = _aligned_float(x)
    mean = sum_over_tp(xf.sum(dim=-1, keepdim=True), mesh) / width
    centred = xf - mean
    var = sum_over_tp((centred * centred).sum(dim=-1, keepdim=True), mesh) / width
    return (centred * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.gamma, self.eps)


def grad_shrink(x: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    """Scale gradients by alpha; the value is x * alpha + x * (1 - alpha),
    rounded as the JAX package rounds it."""
    return x * alpha + x.detach() * (1.0 - alpha)


def dropout(u: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            channels: Optional[Tuple[int, slice]] = None, axis: int = -1) -> torch.Tensor:
    """Inverted dropout as the JAX package writes it, ``where(keep, u / keep_prob, 0)``,
    with the keep mask drawn from ``generator`` (None: the default generator
    of u's device). ``channels`` (width, slice): u holds that slice of
    ``axis``, which is ``width`` long in the whole tensor; the whole mask is
    drawn and the slice kept."""
    keep_prob = 1.0 - rate
    shape = list(u.shape)
    if channels is not None:
        shape[axis] = channels[0]
    keep = torch.rand(shape, generator=generator, device=u.device) < keep_prob
    if channels is not None:
        keep = keep.narrow(axis, channels[1].start, channels[1].stop - channels[1].start)
    return torch.where(keep, u / keep_prob, torch.zeros((), dtype=u.dtype, device=u.device))


def _linear(d_in: int, d_out: int, generator: Optional[torch.Generator]) -> nn.Linear:
    layer = nn.Linear(d_in, d_out, bias=False)
    init_linear_(layer, generator)
    return layer


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, scale: float = 8.0,
                 non_causal_prefix: int = 0, generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head, self.scale = heads, dim_head, scale
        self.non_causal_prefix = non_causal_prefix
        self.dropout = dropout
        self.norm = LayerNorm(dim)
        self.to_q = _linear(dim, heads * dim_head, generator)
        self.to_kv = _linear(dim, 2 * dim_head, generator)
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.to_out = _linear(heads * dim_head, dim, generator)
        self.tp: Optional[Mesh] = None  # set with heads / tp heads by shard_module

    def qkv(self, h: torch.Tensor, x_raw: torch.Tensor, tile: Optional[int] = None):
        """h: normed [b, n, dim]; x_raw: the UN-normed input (K/V project from
        it, a reference quirk kept for checkpoint parity). ``tile``: the
        products' rows in calls of that many rows on the card (inference)."""
        b, n, _ = h.shape
        q = linear(h, self.to_q, tile).reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
        k, v = linear(x_raw, self.to_kv, tile).chunk(2, dim=-1)
        q = l2norm(q) * self.q_scale.to(q.dtype)
        k = l2norm(k) * self.k_scale.to(k.dtype)
        return q.contiguous(), k.contiguous(), v.contiguous()

    def forward(self, x: torch.Tensor, *, attn_bias: Optional[torch.Tensor] = None,
                key_mask: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                tile: Optional[int] = None):
        """key_mask: [b, n] bool, True = attend; attn_bias: this block's
        heads' [h, n, n]. Returns (output [b, n, dim], (k, v)).

        Attention dropout (train() mode, ``dropout`` > 0) leaves kernel 1 for
        the plain attention, as the JAX package leaves its Pallas kernel: the
        probabilities, then the output, each through a keep mask drawn from
        ``generator``; a split block draws every head's mask and keeps its
        own heads'."""
        if self.tp is not None:
            x = copy_to_tp(x, self.tp)
        q, k, v = self.qkv(self.norm(x), x, tile)
        if not (self.training and self.dropout > 0.0):
            out = shared_kv_attention_train(
                q, k, v, attn_bias, key_mask, scale=self.scale, causal=True,
                non_causal_prefix=self.non_causal_prefix,
            )
            return self.project_out(out, tile), (k, v)
        heads = None
        if self.tp is not None:
            t = self.tp.tp_rank
            heads = (self.heads * self.tp.tp, slice(t * self.heads, (t + 1) * self.heads))
        out = shared_kv_attention(
            q, k, v, scale=self.scale, attn_bias=attn_bias, key_mask=key_mask, causal=True,
            non_causal_prefix=self.non_causal_prefix,
            dropout=lambda p: dropout(p, self.dropout, generator, heads, axis=1),
        )
        return dropout(self.project_out(out), self.dropout, generator), (k, v)

    def project_out(self, out: torch.Tensor, tile: Optional[int] = None) -> torch.Tensor:
        """``to_out`` of the heads' outputs, summed over ``tp`` when split."""
        y = linear(out, self.to_out, tile)
        return y if self.tp is None else reduce_from_tp(y, self.tp)

    def decode_qkv(self, x_t: torch.Tensor, tile: Optional[int] = None):
        """One-token projections of x_t [b, dim]: (q [b, heads, d], k_t [b, d],
        v_t [b, d]); K/V from the un-normed input, as in ``qkv``."""
        q, k, v = self.qkv(self.norm(x_t[:, None]), x_t[:, None], tile)
        return q[:, :, 0], k[:, 0], v[:, 0]


class ConvFeedForward(nn.Module):
    """LN -> Linear(2*inner) -> causal depthwise conv(k=3) -> GEGLU -> LN ->
    Linear(dim), inner = int(dim * 2 * mult / 3). ``conv_w`` is tap-major
    [3, 2*inner], the JAX layout."""

    def __init__(self, dim: int, mult: int = 4, generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0):
        super().__init__()
        inner = int(dim * 2 * mult / 3)
        self.inner_dim = inner
        self.dropout = dropout
        self.norm_in = LayerNorm(dim)
        self.proj_in = _linear(dim, 2 * inner, generator)
        self.conv_w = nn.Parameter(torch.empty(3, 2 * inner))
        lecun_normal_(self.conv_w, 3, generator)  # flax fan_in of a [3, c] kernel
        self.norm_mid = LayerNorm(inner)
        self.proj_out = _linear(inner, dim, generator)
        # set by shard_module: the tp group, and inner_dim becomes inner / tp
        self.tp: Optional[Mesh] = None
        self.inner_full = inner

    @property
    def state_dim(self) -> int:
        """The width of a decode state row: the two pre-conv rows."""
        return 2 * self.inner_dim

    def mid(self, u: torch.Tensor) -> torch.Tensor:
        """GEGLU then ``norm_mid`` of the conv's output (statistics summed
        over ``tp`` when split)."""
        h = self.geglu(u)
        if self.tp is None:
            return self.norm_mid(h)
        return dist_layer_norm(h, self.norm_mid.gamma, self.tp, self.inner_full, self.norm_mid.eps)

    def project_out(self, h: torch.Tensor, tile: Optional[int] = None) -> torch.Tensor:
        y = linear(h, self.proj_out, tile)
        return y if self.tp is None else reduce_from_tp(y, self.tp)

    def drop(self, h: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """FF dropout of the mid activations in train() mode; a split block
        draws the whole rows' mask and keeps its channels."""
        if not (self.training and self.dropout > 0.0):
            return h
        t = None if self.tp is None else self.tp.tp_rank
        mine = None if t is None else (self.inner_full, slice(t * self.inner_dim, (t + 1) * self.inner_dim))
        return dropout(h, self.dropout, generator, mine)

    def dsconv_full(self, u: torch.Tensor) -> torch.Tensor:
        """Causal depthwise conv over [b, n, c] with left pad 2."""
        w = self.conv_w.to(u.dtype)
        up = F.pad(u, (0, 0, 2, 0))
        return up[:, :-2] * w[0] + up[:, 1:-1] * w[1] + up[:, 2:] * w[2]

    @staticmethod
    def geglu(u: torch.Tensor) -> torch.Tensor:
        val, gate = u.chunk(2, dim=-1)  # first half value, second half gate
        return F.gelu(gate, approximate="none") * val

    def forward_with_state(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None, tile: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence FF plus the last two pre-conv rows [b, 2, 2*inner]
        that seed the decode conv state (zero-padded for n < 2). In train()
        mode the mid activations get dropout drawn from ``generator``."""
        if self.tp is not None:
            x = copy_to_tp(x, self.tp)
        u = linear(self.norm_in(x), self.proj_in, tile)
        n = u.shape[1]
        tail = u[:, -2:] if n >= 2 else F.pad(u, (0, 0, 2 - n, 0))
        h = self.drop(self.mid(self.dsconv_full(u)), generator)
        return self.project_out(h, tile), tail

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.forward_with_state(x, generator)[0]

    def decode(self, x_t: torch.Tensor, state: torch.Tensor,
               tile: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One token: x_t [b, dim], conv state [b, 2, 2*inner] = (u_{t-2},
        u_{t-1}). Returns (out [b, dim], new state)."""
        u_t = linear(self.norm_in(x_t), self.proj_in, tile)
        w = self.conv_w.to(u_t.dtype)
        conv = state[:, 0] * w[0] + state[:, 1] * w[1] + u_t * w[2]
        out = self.project_out(self.mid(conv), tile)
        return out, torch.stack([state[:, 1], u_t], dim=1)


class FeedForward(ConvFeedForward):
    """The plain (non-conv) variant: LN -> Linear(2*inner) -> GEGLU -> LN ->
    Linear(dim), inner = dim * mult, with no decode state: its cache entry
    is [b, 2, 1] zeros that the decode leaves as they are, as in the JAX
    package."""

    def __init__(self, dim: int, mult: int = 4, generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0):
        nn.Module.__init__(self)
        inner = dim * mult
        self.inner_dim = self.inner_full = inner
        self.dropout = dropout
        self.norm_in = LayerNorm(dim)
        self.proj_in = _linear(dim, 2 * inner, generator)
        self.norm_mid = LayerNorm(inner)
        self.proj_out = _linear(inner, dim, generator)
        self.tp: Optional[Mesh] = None

    state_dim = 1

    def forward_with_state(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None, tile: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.tp is not None:
            x = copy_to_tp(x, self.tp)
        h = self.drop(self.mid(linear(self.norm_in(x), self.proj_in, tile)), generator)
        return self.project_out(h, tile), x.new_zeros(x.shape[0], 2, 1)

    def decode(self, x_t: torch.Tensor, state: torch.Tensor,
               tile: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.forward_with_state(x_t, tile=tile)[0], state


def remat_block(fn: Callable[..., torch.Tensor], *args,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``fn(*args)`` under a non-reentrant checkpoint. ``generator`` (FF
    dropout; None: the default generators, which ``checkpoint`` itself saves
    and restores) is set back for the recompute to the state the first
    forward started from, and afterwards to where the backward found it."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False)
    start, recompute = generator.get_state(), [False]

    def run(*xs):
        if not recompute[0]:
            recompute[0] = True
            return fn(*xs)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*xs)
        finally:
            generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False)


class Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int = 8, dim_head: int = 64,
                 grad_shrink_alpha: float = 0.1, non_causal_prefix_size: int = 0,
                 relative_position_bias_type: str = "continuous", attn_scale: float = 8.0,
                 ff_mult: int = 4, ff_dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None, remat: bool = False,
                 attn_dropout: float = 0.0, use_conv_ff: bool = True):
        super().__init__()
        self.dim, self.depth, self.heads, self.dim_head = dim, depth, heads, dim_head
        self.grad_shrink_alpha = grad_shrink_alpha
        self.remat = remat
        self.rel_pos_bias = make_bias(relative_position_bias_type, dim, heads, generator)
        self.attns = nn.ModuleList(
            Attention(dim, heads, dim_head, attn_scale, non_causal_prefix_size, generator, attn_dropout)
            for _ in range(depth)
        )
        ff_cls = ConvFeedForward if use_conv_ff else FeedForward
        self.ffs = nn.ModuleList(ff_cls(dim, ff_mult, generator, dropout=ff_dropout) for _ in range(depth))
        self.final_norm = LayerNorm(dim)
        # set by shard_module when the attention splits: this rank's heads
        # of the rel-pos bias
        self.head_slice: Optional[slice] = None

    @property
    def ff_state_dim(self) -> int:
        return self.ffs[0].state_dim

    def _bias(self, n: int, dtype: torch.dtype) -> Optional[torch.Tensor]:
        """This rank's heads of the rel-pos bias [h, n, n]."""
        if self.rel_pos_bias is None:
            return None
        return self.rel_pos_bias(n, dtype, heads=self.head_slice)

    def forward(self, x: torch.Tensor, *, self_attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [b, n, dim] in the compute dtype; self_attn_mask: [b, n] bool key
        mask, True = attend; generator: FF dropout draws in train() mode."""
        x = grad_shrink(x, self.grad_shrink_alpha)
        bias = self._bias(x.shape[1], x.dtype)
        remat = self.remat and torch.is_grad_enabled()
        for attn, ff in zip(self.attns, self.ffs):
            if remat:
                x = remat_block(lambda h, b, m, attn=attn: attn(h, attn_bias=b, key_mask=m, generator=generator)[0],
                                x, bias, self_attn_mask, generator=generator) + x
                x = remat_block(lambda h, ff=ff: ff(h, generator), x, generator=generator) + x
            else:
                x = attn(x, attn_bias=bias, key_mask=self_attn_mask, generator=generator)[0] + x
                x = ff(x, generator) + x
        return self.final_norm(x)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """Zeroed cache: stacked per-layer K/V and conv-FF tap state. Every
        prompt position is valid (the JAX cache's key mask is all True on the
        ported paths, so the port does not carry it)."""
        p = self.final_norm.gamma
        d, dt, dev = self.dim_head, self.attns[0].to_q.weight.dtype, p.device
        return {
            "k": torch.zeros((self.depth, batch, max_len, d), dtype=dt, device=dev),
            "v": torch.zeros((self.depth, batch, max_len, d), dtype=dt, device=dev),
            "ff": torch.zeros((self.depth, batch, 2, self.ff_state_dim), dtype=dt, device=dev),
        }

    def bias_table(self, max_len: int) -> Optional[torch.Tensor]:
        """Decode-layout rel-pos bias [2N-1, h]: reversed and padded so that
        row (N-1-pos)+j holds the bias at causal distance pos-j; a decode
        step's bias row is then the contiguous slice [N-1-pos, 2N-1-pos)."""
        if self.rel_pos_bias is None:
            return None
        table = self.rel_pos_bias.distance_table(max_len)  # [N, h]
        if self.head_slice is not None:
            table = table[:, self.head_slice]
        pad = table[:1].expand(max_len - 1, table.shape[1])
        return torch.cat([table.flip(0), pad], dim=0)

    def prefill(self, x: torch.Tensor, cache: Dict[str, torch.Tensor]):
        """Causal forward over the prompt that fills cache[:, :, :n] in place.
        Returns (normed outputs [b, n, dim], cache). Its products run in
        ``PREFILL_TILE``-row calls on the card, so that a row's bits do not
        depend on its batch."""
        n = x.shape[1]
        x = grad_shrink(x, self.grad_shrink_alpha)
        bias = self._bias(n, x.dtype)
        for i, (attn, ff) in enumerate(zip(self.attns, self.ffs)):
            out, (k, v) = attn(x, attn_bias=bias, tile=PREFILL_TILE)
            x = out + x
            u, tail = ff.forward_with_state(x, tile=PREFILL_TILE)
            x = u + x
            cache["k"][i, :, :n] = k
            cache["v"][i, :, :n] = v
            cache["ff"][i] = tail
        return self.final_norm(x), cache

    def decode_step(self, x_t: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int,
                    bias_table: Optional[torch.Tensor]) -> torch.Tensor:
        """One fp decode step for the token at ``pos`` (embedding x_t [b, dim]):
        writes each layer's cache row ``pos`` and conv state in place and
        returns the normed output [b, dim]. Its products run in
        ``DECODE_TILE``-row calls on the card."""
        x = grad_shrink(x_t, self.grad_shrink_alpha)
        for i, (attn, ff) in enumerate(zip(self.attns, self.ffs)):
            q, k_t, v_t = attn.decode_qkv(x, DECODE_TILE)
            cache["k"][i, :, pos] = k_t
            cache["v"][i, :, pos] = v_t
            out = shared_kv_decode_step(
                q, cache["k"][i], cache["v"][i], pos, scale=attn.scale, bias_table=bias_table)
            x = attn.project_out(out, DECODE_TILE) + x
            u, cache["ff"][i] = ff.decode(x, cache["ff"][i], DECODE_TILE)
            x = u + x
        return self.final_norm(x)
