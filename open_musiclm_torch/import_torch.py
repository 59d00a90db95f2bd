"""Reference-layout torch checkpoints -> the port's state_dicts (port of
open_musiclm_tpu/import_torch.py, mapping each reference key straight to the
port's key).

Inputs are flat ``{name: np.ndarray}`` state dicts (``load_torch_state_dict``
reads a ``.pt`` / Hugging Face ``.bin`` file):
  * stage transformers (semantic / coarse / fine ``.pt``): the reference's
    ``embeddings.{i}``, ``logit_weights.{i}``, ``transformer.layers.{l}.0``
    (attention) and ``.2`` (conv-FF, its depthwise ``ds_conv`` weight
    [C, 1, 3] -> the port's tap-major ``conv_w`` [3, C]),
    ``transformer.rel_pos_bias.net.{j}`` -> the port's
    ``embeds`` / ``logit_heads`` / ``transformer.attns`` / ``transformer.ffs``
    / ``rel_pos_bias.{in_layer, mid_layers.j, out_layer}``;
  * Encodec 24 kHz (the ``encodec`` package's Sequential indices,
    weight-normed convs folded);
  * HuBERT / MERT (``transformers.HubertModel``; the positional conv's weight
    norm over dim 2, as ``weight_g`` / ``weight_v`` or
    ``parametrizations.weight.original0/1``);
  * RoBERTa (``transformers.RobertaModel``), HTSAT and the laion CLAP bundle
    (keys optionally prefixed ``module.``);
  * the ResidualVQ (``vector_quantize_pytorch``, 2-D or 3-D codebooks) and a
    scikit-learn MiniBatchKMeans joblib dump.
The towers already use the reference key layout; their importers keep the
keys the port's modules hold and fold weight norm. The fusion CLAP's
``mel_conv2d`` / ``fusion_model`` weights are not mapped, as the JAX
package maps none. Values are bit-equal to the JAX importer's params passed
through ``convert.py``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.rvq import RVQState

Array = np.ndarray
StateDict = Dict[str, Array]
TorchStateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> StateDict:
    """A torch file's state dict (or its ``state_dict`` entry) as numpy arrays."""
    return numpy_state_dict(torch.load(path, map_location="cpu", weights_only=False))


def numpy_state_dict(obj: dict) -> StateDict:
    """A loaded state dict (or its ``state_dict`` entry) as numpy arrays."""
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items() if hasattr(v, "numpy")}


def strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def fold_weight_norm(g: Array, v: Array) -> Array:
    """weight = g * v / ||v||, norm over all dims except 0 (torch's default)."""
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v ** 2, axis=axes, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _maybe_fold(sd: StateDict, key: str) -> Array:
    """The (possibly weight-normed) weight of the layer at ``key``."""
    if key + ".weight" in sd:
        return sd[key + ".weight"]
    return fold_weight_norm(sd[key + ".weight_g"], sd[key + ".weight_v"])


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _copy(out: TorchStateDict, sd: StateDict, src: str, dst: str, names=("weight", "bias")) -> None:
    for name in names:
        out[f"{dst}.{name}"] = _t(sd[f"{src}.{name}"])


# ---------------------------------------------------------------------------
# stage transformers
# ---------------------------------------------------------------------------


def import_stage_transformer(sd: StateDict, num_specs: int, depth: int) -> TorchStateDict:
    """A reference TokenConditionedTransformer state dict -> the port's, as
    the JAX package's ``import_stage_transformer`` maps it: the continuous
    rel-pos MLP (``rel_pos_bias.net.*``) or the T5 table
    (``rel_pos_bias.relative_attention_bias.weight``), the conv
    feed-forward (``ds_conv`` at ``.2.2``) or the plain one (its mid norm at
    ``.3``, its out projection at ``.5``), and the absolute position tables
    (``absolute_position_embeddings.{i}``) where the file has them."""
    out: TorchStateDict = {"start_tokens": _t(np.stack([sd[f"start_tokens.{i}"] for i in range(num_specs)]))}
    for i in range(num_specs):
        out[f"embeds.{i}.weight"] = _t(sd[f"embeddings.{i}.weight"])
        out[f"logit_heads.{i}"] = _t(sd[f"logit_weights.{i}"])
        if f"absolute_position_embeddings.{i}.weight" in sd:
            out[f"pos_embeds.{i}.weight"] = _t(sd[f"absolute_position_embeddings.{i}.weight"])
    rp = "transformer.rel_pos_bias."
    if rp + "relative_attention_bias.weight" in sd:
        out[rp + "embedding"] = _t(sd[rp + "relative_attention_bias.weight"])
    elif any(k.startswith(rp + "net.") for k in sd):
        # net.0 = Seq(Linear(1, d), SiLU), net.1..L-1 = Seq(Linear(d, d), SiLU), net.L = Linear(d, heads)
        last = max(int(k.split(".")[3]) for k in sd if k.startswith(rp + "net."))
        _copy(out, sd, rp + "net.0.0", rp + "in_layer")
        for j in range(1, last):
            _copy(out, sd, f"{rp}net.{j}.0", f"{rp}mid_layers.{j - 1}")
        _copy(out, sd, f"{rp}net.{last}", rp + "out_layer")
    conv_ff = "transformer.layers.0.2.2.ds_conv.weight" in sd
    for l in range(depth):
        ap, pa = f"transformer.layers.{l}.0.", f"transformer.attns.{l}."
        for name in ("norm.gamma", "to_q.weight", "to_kv.weight", "q_scale", "k_scale"):
            out[pa + name] = _t(sd[ap + name])
        out[pa + "to_out.weight"] = _t(sd[ap + "to_out.0.weight"])
        fp, pf = f"transformer.layers.{l}.2.", f"transformer.ffs.{l}."
        out[pf + "norm_in.gamma"] = _t(sd[fp + "0.gamma"])
        out[pf + "proj_in.weight"] = _t(sd[fp + "1.weight"])
        if conv_ff:
            out[pf + "conv_w"] = _t(sd[fp + "2.ds_conv.weight"][:, 0, :].T)  # [C, 1, 3] -> [3, C]
            out[pf + "norm_mid.gamma"] = _t(sd[fp + "4.gamma"])
            out[pf + "proj_out.weight"] = _t(sd[fp + "6.weight"])
        else:  # Seq(LayerNorm, Linear, GEGLU, LayerNorm, Dropout, Linear)
            out[pf + "norm_mid.gamma"] = _t(sd[fp + "3.gamma"])
            out[pf + "proj_out.weight"] = _t(sd[fp + "5.weight"])
    out["transformer.final_norm.gamma"] = _t(sd["transformer.norm.gamma"])
    return out


# ---------------------------------------------------------------------------
# Encodec (encodec package layout)
# ---------------------------------------------------------------------------


def _conv(out: TorchStateDict, sd: StateDict, src: str, dst: str) -> None:
    out[dst + ".weight"] = _t(_maybe_fold(sd, src))
    out[dst + ".bias"] = _t(sd[src + ".bias"])


def _resblock(out: TorchStateDict, sd: StateDict, src: str, dst: str) -> None:
    _conv(out, sd, src + "block.1.conv.conv", dst + ".block_conv1.conv")
    _conv(out, sd, src + "block.3.conv.conv", dst + ".block_conv2.conv")
    _conv(out, sd, src + "shortcut.conv.conv", dst + ".shortcut.conv")


def _lstm(out: TorchStateDict, sd: StateDict, src: str, dst: str, num_layers: int = 2) -> None:
    for l in range(num_layers):
        for name in (f"weight_ih_l{l}", f"weight_hh_l{l}", f"bias_ih_l{l}", f"bias_hh_l{l}"):
            out[f"{dst}.lstm.{name}"] = _t(sd[f"{src}lstm.{name}"])


def import_encodec(sd: StateDict, num_stages: int, num_quantizers: int) -> TorchStateDict:
    """encodec_model_24khz state dict -> the port's EncodecModel.

    Encoder Sequential indices: 0 conv_in, per stage s (3s+1) resblock and
    (3s+3) downsampling conv, then the LSTM and conv_out. Decoder: 0
    conv_in, 1 LSTM, per stage (3s+3) transposed conv and (3s+4) resblock,
    then conv_out."""
    out: TorchStateDict = {"codebooks": _t(np.stack(
        [sd[f"quantizer.vq.layers.{q}._codebook.embed"] for q in range(num_quantizers)]))}
    _conv(out, sd, "decoder.model.0.conv.conv", "decoder.conv_in.conv")
    _lstm(out, sd, "decoder.model.1.", "decoder.lstm")
    for s in range(num_stages):
        _conv(out, sd, f"decoder.model.{3 * s + 3}.convtr.convtr", f"decoder.ups.{s}.convtr")
        _resblock(out, sd, f"decoder.model.{3 * s + 4}.", f"decoder.res.{s}")
    _conv(out, sd, f"decoder.model.{3 * num_stages + 2}.conv.conv", "decoder.conv_out.conv")
    _conv(out, sd, "encoder.model.0.conv.conv", "encoder.conv_in.conv")
    for s in range(num_stages):
        _resblock(out, sd, f"encoder.model.{3 * s + 1}.", f"encoder.res.{s}")
        _conv(out, sd, f"encoder.model.{3 * s + 3}.conv.conv", f"encoder.downs.{s}.conv")
    lstm_idx = 3 * num_stages + 1
    _lstm(out, sd, f"encoder.model.{lstm_idx}.", "encoder.lstm")
    _conv(out, sd, f"encoder.model.{lstm_idx + 2}.conv.conv", "encoder.conv_out.conv")
    return out


# ---------------------------------------------------------------------------
# HuBERT and RoBERTa (transformers layouts)
# ---------------------------------------------------------------------------


def import_hubert(sd: StateDict, cfg) -> TorchStateDict:
    """transformers.HubertModel state dict -> the port's HubertModel, the
    positional conv's weight norm (dim=2: a per-tap g) folded."""
    out: TorchStateDict = {}
    for i in range(len(cfg.conv_dim)):
        pre = f"feature_extractor.conv_layers.{i}."
        out[pre + "conv.weight"] = _t(sd[pre + "conv.weight"])
        if pre + "conv.bias" in sd:
            out[pre + "conv.bias"] = _t(sd[pre + "conv.bias"])
        if cfg.feat_extract_norm == "layer" or (cfg.feat_extract_norm == "group" and i == 0):
            _copy(out, sd, pre + "layer_norm", pre + "layer_norm")
    _copy(out, sd, "feature_projection.layer_norm", "feature_projection.layer_norm")
    _copy(out, sd, "feature_projection.projection", "feature_projection.projection")
    pc = "encoder.pos_conv_embed.conv."
    if pc + "weight_g" in sd:
        g, v = sd[pc + "weight_g"], sd[pc + "weight_v"]
    else:  # transformers >= 4.30: parametrized weight norm
        g, v = sd[pc + "parametrizations.weight.original0"], sd[pc + "parametrizations.weight.original1"]
    norm = np.sqrt(np.sum(v ** 2, axis=(0, 1), keepdims=True))
    out[pc + "weight"] = _t(g * v / np.maximum(norm, 1e-12))
    out[pc + "bias"] = _t(sd[pc + "bias"])
    _copy(out, sd, "encoder.layer_norm", "encoder.layer_norm")
    for i in range(cfg.num_hidden_layers):
        pre = f"encoder.layers.{i}."
        for name in ("attention.q_proj", "attention.k_proj", "attention.v_proj", "attention.out_proj",
                     "layer_norm", "feed_forward.intermediate_dense", "feed_forward.output_dense",
                     "final_layer_norm"):
            _copy(out, sd, pre + name, pre + name)
    return out


def import_roberta(sd: StateDict, cfg) -> TorchStateDict:
    """transformers.RobertaModel state dict -> the port's RobertaModel."""
    out: TorchStateDict = {}
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        key = f"embeddings.{name}.weight"
        out[key] = _t(sd[key])
    _copy(out, sd, "embeddings.LayerNorm", "embeddings.LayerNorm")
    for i in range(cfg.num_hidden_layers):
        pre = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense", "attention.output.LayerNorm", "intermediate.dense",
                     "output.dense", "output.LayerNorm"):
            _copy(out, sd, pre + name, pre + name)
    _copy(out, sd, "pooler.dense", "pooler.dense")
    return out


# ---------------------------------------------------------------------------
# HTSAT and the laion CLAP bundle
# ---------------------------------------------------------------------------


def import_htsat(sd: StateDict, cfg) -> TorchStateDict:
    """An HTSAT tower state dict (``audio_branch.`` stripped) -> the port's
    HTSAT without fusion; bn0's running statistics come with it."""
    out: TorchStateDict = {}
    _copy(out, sd, "bn0", "bn0", ("weight", "bias", "running_mean", "running_var"))
    out["bn0.num_batches_tracked"] = torch.tensor(0)
    for name in ("patch_embed.proj", "tscam_conv", "patch_embed.norm", "norm"):
        _copy(out, sd, name, name)
    for si, depth in enumerate(cfg.depths):
        for bi in range(depth):
            pre = f"layers.{si}.blocks.{bi}."
            for name in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2"):
                _copy(out, sd, pre + name, pre + name)
            key = pre + "attn.relative_position_bias_table"
            out[key] = _t(sd[key])
        if si < len(cfg.depths) - 1:
            pre = f"layers.{si}.downsample."
            _copy(out, sd, pre + "norm", pre + "norm")
            out[pre + "reduction.weight"] = _t(sd[pre + "reduction.weight"])
    return out


def import_clap(sd: StateDict, audio_cfg, text_cfg) -> TorchStateDict:
    """A laion CLAP checkpoint (keys optionally prefixed ``module.``) -> the
    port's CLAP: both towers, projections, transforms and logit scales."""
    if any(k.startswith("module.") for k in sd):
        sd = strip_prefix(sd, "module.")
    out: TorchStateDict = {}
    for side, tower in (("audio", import_htsat(strip_prefix(sd, "audio_branch."), audio_cfg)),
                        ("text", import_roberta(strip_prefix(sd, "text_branch."), text_cfg))):
        out.update({f"{side}_branch.{k}": v for k, v in tower.items()})
        for j in (0, 2):
            _copy(out, sd, f"{side}_projection.{j}", f"{side}_projection.{j}")
        for j in (0, 3):
            _copy(out, sd, f"{side}_transform.sequential.{j}", f"{side}_transform.sequential.{j}")
        out[f"logit_scale_{side[0]}"] = _t(sd[f"logit_scale_{side[0]}"])
    return out


# ---------------------------------------------------------------------------
# RVQ and k-means
# ---------------------------------------------------------------------------


def import_rvq(sd: StateDict) -> RVQState:
    """A vector_quantize_pytorch ResidualVQ state dict -> RVQState (the
    codebooks; the EMA statistics are training state)."""
    qs = sorted({int(k.split(".")[1]) for k in sd if k.startswith("layers.") and "._codebook.embed" in k})
    embeds = []
    for q in qs:
        e = sd[f"layers.{q}._codebook.embed"]
        embeds.append(e[0] if e.ndim == 3 else e)  # newer versions: [heads (1), K, D]
    return RVQState(_t(np.stack(embeds)))


def import_kmeans_joblib(path: str) -> torch.Tensor:
    """A scikit-learn MiniBatchKMeans joblib dump -> [K, D] float32 centroids."""
    import joblib

    return _t(np.asarray(joblib.load(path).cluster_centers_, dtype=np.float32))
