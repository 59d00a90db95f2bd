"""Plain float32 reference of one token-conditioned stage (MusicLM's
semantic, coarse or fine transformer), written from the architecture and
independent of the program under test.

One decoder over ``[start_0, ids_0 + EOS, start_1, ids_1 + EOS, ...,
start_last, tokens_last]``: per sequence an embedding table with
per-quantizer offsets ``(t % Q) * codebook``, a start token and Q logit
heads. Each of ``depth`` blocks:

  attention: q from LayerNorm(x), one shared K/V head from the raw x;
      q and k l2-normalised and scaled per channel, logits ``8 q.k`` plus a
      relative-position bias (a SiLU MLP of the signed distance i - j),
      causal softmax, output projection, residual;
  feed-forward: LayerNorm, projection to 2 * inner, a causal depthwise
      3-tap convolution over time, GEGLU (value half times GELU of the gate
      half), LayerNorm, projection back, residual;

then a final LayerNorm. Every LayerNorm is bias-free with eps 1e-5. The
logits at stream position p predict the next token with head ``t % Q`` of
the final sequence.

``precision`` "fp32" computes with the weights as given; "int4" rounds every
matrix of the transformer and the logit heads to 4 bits per output column
(symmetric, absmax / 7), the control of a configuration served with int8
weights; "fp8" rounds both operands of every product that bf16 training
computes on the tensor cores (the projections, the logit heads, the
relative-position MLP, and attention's scores and weighted sum) to float8
e4m3 with a per-tensor scale, gradients passed straight through: the
control of bf16 training. Weights come as a ``{name: tensor}`` dict in the layout
``benchmark/weights.py`` makes; ``train=True`` makes them leaves that
take gradients.

Training (``loss``): the stage's loss as its trainer defines it: EOS
appended to every sequence, the conditioning's EOS hidden from attention
and embedded as id 0, a forgetful causal mask drawn from a generator
(``min(int(n * p), n - 1)`` keys a row, never the first, at the largest of
``randn`` draws), FF dropout after the mid LayerNorm (keep where a
``rand`` draw is below 1 - p, scaled by 1 / (1 - p)), drawn from the same
generator layer by layer, the gradient into the stream's input scaled by
``grad_shrink`` (alpha; the value unchanged), and the mean cross-entropy of the final
sequence's tokens and its EOS.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

EPS = 1e-5
ATTN_SCALE = 8.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (absmax -> 448),
    the gradient passed straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def quantize_columns(w: torch.Tensor, bits: int) -> torch.Tensor:
    """[out, in] weight rounded to ``bits`` per output row (a column of the
    [in, out] product), symmetric, scale absmax / (2**(bits-1) - 1)."""
    top = 2 ** (bits - 1) - 1
    scale = (w.abs().amax(dim=-1, keepdim=True) / top).clamp(min=1e-12)
    return torch.clamp(torch.round(w / scale), -top, top) * scale


def layer_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS) * gamma


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


class StageReference:
    """``specs``: per sequence (codebook_size, num_quantizers); ``heads``,
    ``dim_head`` as configured."""

    def __init__(self, weights: Dict[str, torch.Tensor], specs: Sequence[Sequence[int]], depth: int,
                 heads: int, dim_head: int = 64, precision: str = "fp32", train: bool = False,
                 grad_shrink: float = 1.0, dtype: torch.dtype = torch.float32):
        self.specs = [tuple(s) for s in specs]
        self.depth, self.heads, self.dim_head = depth, heads, dim_head
        self.shrink = grad_shrink
        mat_bits = {"fp32": None, "int4": 4, "fp8": None}[precision]
        self.fp8 = precision == "fp8"
        self.w = {}
        for name, t in weights.items():
            t = t.detach().to(dtype)
            quantize = mat_bits is not None and (
                (name.startswith("transformer.") and t.ndim == 2 and not name.startswith("transformer.rel_pos_bias")
                 and not name.endswith("conv_w")) or name.startswith("logit_heads."))
            if quantize:
                t = torch.stack([quantize_columns(h, mat_bits) for h in t]) if t.ndim == 3 else quantize_columns(t, mat_bits)
            self.w[name] = t.requires_grad_(train)

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w^T, with both operands in float8 e4m3 for the fp8 control."""
        return self._r(x) @ self._r(w).t()

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product: rounded to float8 e4m3 for the fp8 control."""
        return fp8(x) if self.fp8 else x

    # ---- pieces ----

    def _embed(self, i: int, ids: torch.Tensor) -> torch.Tensor:
        """[b, n] ids of sequence i (EOS = codebook) -> [b, n, dim]."""
        codebook, q = self.specs[i]
        offs = (torch.arange(ids.shape[1], device=ids.device) % q) * codebook
        return F.embedding(ids + offs[None], self.w[f"embeds.{i}.weight"])

    def _bias(self, n: int, device) -> torch.Tensor:
        """[heads, n, n] relative-position bias at distance i - j."""
        p = "transformer.rel_pos_bias."
        d = torch.arange(-n + 1, n, dtype=self.w[p + "in_layer.weight"].dtype, device=device)[:, None]
        h = F.silu(self._mm(d, self.w[p + "in_layer.weight"]) + self.w[p + "in_layer.bias"])
        k = 0
        while f"{p}mid_layers.{k}.weight" in self.w:
            h = F.silu(self._mm(h, self.w[f"{p}mid_layers.{k}.weight"]) + self.w[f"{p}mid_layers.{k}.bias"])
            k += 1
        table = self._mm(h, self.w[p + "out_layer.weight"]) + self.w[p + "out_layer.bias"]  # [2n-1, heads]
        i = torch.arange(n, device=device)
        return table[i[:, None] - i[None, :] + n - 1].permute(2, 0, 1)

    def _block(self, l: int, x: torch.Tensor, bias: torch.Tensor, key_mask=None, keep=None,
               keep_prob: float = 1.0) -> torch.Tensor:
        w, a, f = self.w, f"transformer.attns.{l}.", f"transformer.ffs.{l}."
        b, n, _ = x.shape
        h = layer_norm(x, w[a + "norm.gamma"])
        q = self._mm(h, w[a + "to_q.weight"]).reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
        k, v = self._mm(x, w[a + "to_kv.weight"]).chunk(2, dim=-1)
        q = l2norm(q) * w[a + "q_scale"]
        k = l2norm(k) * w[a + "k_scale"]
        sim = ATTN_SCALE * torch.einsum("bhid,bjd->bhij", self._r(q), self._r(k)) + bias[None]
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        allowed = causal[None, None] if key_mask is None else causal[None, None] & key_mask[:, None, None, :]
        sim = sim.masked_fill(~allowed, float("-inf"))
        out = torch.einsum("bhij,bjd->bhid", self._r(sim.softmax(dim=-1)), self._r(v))
        x = x + self._mm(out.transpose(1, 2).reshape(b, n, -1), w[a + "to_out.weight"])
        u = self._mm(layer_norm(x, w[f + "norm_in.gamma"]), w[f + "proj_in.weight"])
        cw = w[f + "conv_w"]  # [3, 2 * inner], tap 2 is the current step
        up = F.pad(u, (0, 0, 2, 0))
        u = up[:, :-2] * cw[0] + up[:, 1:-1] * cw[1] + up[:, 2:] * cw[2]
        val, gate = u.chunk(2, dim=-1)
        g = layer_norm(F.gelu(gate) * val, w[f + "norm_mid.gamma"])
        if keep is not None:
            g = torch.where(keep, g / keep_prob, torch.zeros_like(g))
        return x + self._mm(g, w[f + "proj_out.weight"])

    # ---- the pass ----

    @torch.no_grad()
    def logits(self, cond: List[torch.Tensor], tokens: torch.Tensor, n_init: int) -> torch.Tensor:
        """``cond``: the conditioning sequences [b, n_i] (without EOS);
        ``tokens``: the final sequence's flat tokens [b, T] (prefix and
        served). Returns the float32 logits [b, T - n_init, C + 1] that
        predict tokens[:, n_init:], each from the tokens before it."""
        parts = []
        for i, ids in enumerate(cond):
            codebook = self.specs[i][0]
            ids = torch.cat([ids, torch.full_like(ids[:, :1], codebook)], dim=1)
            parts += [self.w["start_tokens"][i].expand(ids.shape[0], 1, -1), self._embed(i, ids)]
        last = len(self.specs) - 1
        parts.append(self.w["start_tokens"][last].expand(tokens.shape[0], 1, -1))
        if tokens.shape[1] > 1:
            parts.append(self._embed(last, tokens[:, :-1]))
        x = torch.cat(parts, dim=1)
        bias = self._bias(x.shape[1], x.device)
        for l in range(self.depth):
            x = self._block(l, x, bias)
        x = layer_norm(x, self.w["transformer.final_norm.gamma"])
        T = tokens.shape[1]
        h = x[:, x.shape[1] - T + n_init:]  # predicts tokens[:, n_init:]
        q_num = self.specs[last][1]
        heads = self.w[f"logit_heads.{last}"]  # [Q, C + 1, dim]
        out = torch.empty(h.shape[0], h.shape[1], heads.shape[1], device=h.device, dtype=h.dtype)
        for j in range(q_num):
            first = (j - n_init) % q_num
            out[:, first::q_num] = self._mm(h[:, first::q_num], heads[j])
        return out

    def loss(self, seqs: List[torch.Tensor], mask_prob: float, ff_dropout: float,
             gen: torch.Generator) -> torch.Tensor:
        """The training loss of one micro-batch of raw sequences [B, n_i]."""
        ids = [torch.cat([t, torch.full_like(t[:, :1], self.specs[i][0])], dim=1) for i, t in enumerate(seqs)]
        labels = ids[-1]
        B = ids[0].shape[0]
        parts, keys = [], []
        for i, t in enumerate(ids[:-1]):
            keep = t != self.specs[i][0]
            t = torch.where(keep, t, torch.zeros_like(t))
            parts += [self.w["start_tokens"][i].expand(B, 1, -1), self._embed(i, t)]
            keys += [torch.ones_like(keep[:, :1]), keep]
        last = len(self.specs) - 1
        parts += [self.w["start_tokens"][last].expand(B, 1, -1), self._embed(last, ids[-1][:, :-1])]
        keys.append(torch.ones_like(labels, dtype=torch.bool))
        x = torch.cat(parts, dim=1)
        x = x * self.shrink + x.detach() * (1.0 - self.shrink)  # the stream's gradient scaled by alpha
        key_mask = torch.cat(keys, dim=1)
        n = x.shape[1]
        drop = min(int(n * mask_prob), n - 1)
        if drop > 0:
            r = torch.randn((B, n), generator=gen, device=x.device)
            r[:, 0] = -math.inf
            key_mask = key_mask.scatter(1, r.topk(drop, dim=-1).indices, False)
        bias = self._bias(n, x.device)
        for l in range(self.depth):
            keep = None
            if ff_dropout > 0:
                inner = self.w[f"transformer.ffs.{l}.norm_mid.gamma"].shape[0]
                keep = torch.rand((B, n, inner), generator=gen, device=x.device) < 1.0 - ff_dropout
            x = self._block(l, x, bias, key_mask, keep, 1.0 - ff_dropout)
        x = layer_norm(x, self.w["transformer.final_norm.gamma"])
        h = x[:, n - labels.shape[1]:]
        q_num = self.specs[last][1]
        heads = self.w[f"logit_heads.{last}"]
        logits = torch.empty(B, h.shape[1], heads.shape[1], device=x.device)
        for j in range(q_num):
            logits[:, j::q_num] = self._mm(h[:, j::q_num], heads[j])
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def eos_masked(logits: torch.Tensor) -> torch.Tensor:
    """Logits with the EOS column (the last) removed from the choice."""
    return logits.clone().index_fill_(-1, torch.tensor([logits.shape[-1] - 1], device=logits.device), -math.inf)
