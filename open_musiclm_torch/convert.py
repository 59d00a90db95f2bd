"""Weight bridge: the JAX package's parameter pytrees -> the port's state_dicts.

Input is a stage's ``params``, the codec's ``codec_params``, the CLAP's,
RoBERTa's, HTSAT's or HuBERT's params, as nested dicts of numpy arrays
(``jax.device_get`` of the flax variables, with or without the top-level
``"params"`` key; HTSAT's with its ``"batch_stats"``), an ``RVQState``, or
k-means centroids. Layouts:

  * flax Dense kernel [in, out]           -> nn.Linear weight [out, in]
  * flax Conv kernel [k, in, out]         -> nn.Conv1d weight [out, in, k]
    (grouped: [k, in / groups, out] -> [out, in / groups, k]); 2-D
    [kh, kw, in, out] -> nn.Conv2d weight [out, in, kh, kw]
  * flax ConvTranspose kernel [k, in, out] -> nn.ConvTranspose1d weight
    [in, out, k] with the taps flipped (lax.conv_transpose does not flip;
    open_musiclm_tpu/import_torch.py:conv_transpose1d is the inverse map)
  * flax MultiHeadDotProductAttention query/key/value kernels [in, heads,
    head_dim] -> nn.Linear weight [heads * head_dim, in], biases [heads,
    head_dim] -> [heads * head_dim]; the output kernel [heads, head_dim,
    out] -> [out, heads * head_dim] (open_musiclm_tpu/import_torch.py:mha is
    the inverse map)
  * flax LayerNorm / GroupNorm / BatchNorm scale / bias -> weight / bias;
    BatchNorm's batch_stats mean / var -> running_mean / running_var
  * embeddings, logit heads [Q, C, d], start tokens, conv_w [3, 2*inner],
    gammas, q/k scales, the LSTM (already in torch's gate order) and the
    codebooks carry over unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.rvq import RVQState

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _dense(a) -> torch.Tensor:
    return _t(np.asarray(a).T)


def _conv(a) -> torch.Tensor:
    return _t(np.transpose(np.asarray(a), (2, 1, 0)))


def _conv2d(a) -> torch.Tensor:
    return _t(np.transpose(np.asarray(a), (3, 2, 0, 1)))


def _conv_transpose(a) -> torch.Tensor:
    return _t(np.transpose(np.asarray(a)[::-1], (1, 2, 0)))


def _unwrap(params) -> dict:
    return params["params"] if "params" in params else params


def stage_state_dict(params, num_specs: int, depth: int) -> StateDict:
    """A TokenConditionedTransformer's flax params -> the port's state_dict:
    the continuous or T5 rel-pos bias, the conv or plain feed-forward, and
    the absolute position tables where the model has them."""
    p = _unwrap(params)
    t = p["transformer"]
    sd: StateDict = {"start_tokens": _t(p["start_tokens"])}
    for i in range(num_specs):
        sd[f"embeds.{i}.weight"] = _t(p[f"embed_{i}"]["embedding"])
        sd[f"logit_heads.{i}"] = _t(p[f"logits_{i}"])
        if f"abs_pos_embed_{i}" in p:
            sd[f"pos_embeds.{i}.weight"] = _t(p[f"abs_pos_embed_{i}"]["embedding"])
    if "rel_pos_bias" in t and "embedding" in t["rel_pos_bias"]:  # the T5 bucket table
        sd["transformer.rel_pos_bias.embedding"] = _t(t["rel_pos_bias"]["embedding"])
    elif "rel_pos_bias" in t:
        r = t["rel_pos_bias"]
        names = ["in_layer"] + [f"mid_layers.{j}" for j in range(len(r) - 2)] + ["out_layer"]
        flax = ["in_layer"] + [f"mid_layer_{j}" for j in range(len(r) - 2)] + ["out_layer"]
        for name, key in zip(names, flax):
            sd[f"transformer.rel_pos_bias.{name}.weight"] = _dense(r[key]["kernel"])
            sd[f"transformer.rel_pos_bias.{name}.bias"] = _t(r[key]["bias"])
    for l in range(depth):
        a, f = t[f"attn_{l}"], t[f"ff_{l}"]
        pa, pf = f"transformer.attns.{l}.", f"transformer.ffs.{l}."
        sd[pa + "norm.gamma"] = _t(a["norm"]["gamma"])
        for name in ("to_q", "to_kv", "to_out"):
            sd[pa + name + ".weight"] = _dense(a[name]["kernel"])
        sd[pa + "q_scale"] = _t(a["q_scale"])
        sd[pa + "k_scale"] = _t(a["k_scale"])
        sd[pf + "norm_in.gamma"] = _t(f["norm_in"]["gamma"])
        sd[pf + "proj_in.weight"] = _dense(f["proj_in"]["kernel"])
        if "conv_w" in f:  # the conv feed-forward (the plain FeedForward has none)
            sd[pf + "conv_w"] = _t(f["conv_w"])
        sd[pf + "norm_mid.gamma"] = _t(f["norm_mid"]["gamma"])
        sd[pf + "proj_out.weight"] = _dense(f["proj_out"]["kernel"])
    sd["transformer.final_norm.gamma"] = _t(t["final_norm"]["gamma"])
    return sd


def _conv_entry(sd: StateDict, prefix: str, node) -> None:
    sd[prefix + ".weight"] = _conv(node["conv"]["kernel"])
    sd[prefix + ".bias"] = _t(node["conv"]["bias"])


def _lstm_entries(sd: StateDict, prefix: str, node, lstm_layers: int) -> None:
    for layer in range(lstm_layers):
        for kind in ("ih", "hh"):
            sd[f"{prefix}.lstm.weight_{kind}_l{layer}"] = _t(node[f"w_{kind}_{layer}"])
            sd[f"{prefix}.lstm.bias_{kind}_l{layer}"] = _t(node[f"b_{kind}_{layer}"])


def _resblock_entries(sd: StateDict, prefix: str, node) -> None:
    for name in ("block_conv1", "block_conv2", "shortcut"):
        _conv_entry(sd, f"{prefix}.{name}.conv", node[name])


def codec_state_dict(codec_params, num_stages: int, lstm_layers: int = 2) -> StateDict:
    """EncodecModel flax params -> the port's state_dict: the decoder, the
    codebooks, and the encoder when the params hold it (an init through
    ``decode`` alone does not)."""
    p = _unwrap(codec_params)
    d = p["decoder"]
    sd: StateDict = {"codebooks": _t(p["codebooks"])}
    _conv_entry(sd, "decoder.conv_in.conv", d["conv_in"])
    _lstm_entries(sd, "decoder.lstm", d["lstm"], lstm_layers)
    for s in range(num_stages):
        up = d[f"up_{s}"]["convtr"]
        sd[f"decoder.ups.{s}.convtr.weight"] = _conv_transpose(up["kernel"])
        sd[f"decoder.ups.{s}.convtr.bias"] = _t(up["bias"])
        _resblock_entries(sd, f"decoder.res.{s}", d[f"res_{s}_0"])
    _conv_entry(sd, "decoder.conv_out.conv", d["conv_out"])
    if "encoder" in p:
        e = p["encoder"]
        _conv_entry(sd, "encoder.conv_in.conv", e["conv_in"])
        for s in range(num_stages):
            _resblock_entries(sd, f"encoder.res.{s}", e[f"res_{s}_0"])
            _conv_entry(sd, f"encoder.downs.{s}.conv", e[f"down_{s}"])
        _lstm_entries(sd, "encoder.lstm", e["lstm"], lstm_layers)
        _conv_entry(sd, "encoder.conv_out.conv", e["conv_out"])
    return sd


def _linear_entry(sd: StateDict, prefix: str, node) -> None:
    sd[prefix + ".weight"] = _dense(node["kernel"])
    sd[prefix + ".bias"] = _t(node["bias"])


def _layer_norm_entry(sd: StateDict, prefix: str, node) -> None:
    sd[prefix + ".weight"] = _t(node["scale"])
    sd[prefix + ".bias"] = _t(node["bias"])


def _mha_entries(sd: StateDict, prefix: str, attn, names=("query", "key", "value", "out")) -> None:
    """flax MultiHeadDotProductAttention -> four nn.Linear entries under
    ``prefix``, named by ``names``."""
    for src, dst in zip(("query", "key", "value"), names):
        kernel = np.asarray(attn[src]["kernel"])  # [in, heads, head_dim]
        sd[f"{prefix}{dst}.weight"] = _t(kernel.reshape(kernel.shape[0], -1).T)
        sd[f"{prefix}{dst}.bias"] = _t(np.asarray(attn[src]["bias"]).reshape(-1))
    out = np.asarray(attn["out"]["kernel"])  # [heads, head_dim, out]
    sd[f"{prefix}{names[3]}.weight"] = _t(out.reshape(-1, out.shape[-1]).T)
    sd[f"{prefix}{names[3]}.bias"] = _t(attn["out"]["bias"])


def roberta_state_dict(params) -> StateDict:
    """RobertaModel flax params -> the port's (Hugging Face layout) state_dict."""
    p = _unwrap(params)
    sd: StateDict = {}
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"embeddings.{name}.weight"] = _t(p[name]["embedding"])
    _layer_norm_entry(sd, "embeddings.LayerNorm", p["emb_norm"])
    layers = sorted(int(k.split("_")[1]) for k in p if k.startswith("layer_"))
    for i in layers:
        layer, pre = p[f"layer_{i}"], f"encoder.layer.{i}."
        _mha_entries(sd, pre + "attention.", layer["attention"],
                     ("self.query", "self.key", "self.value", "output.dense"))
        _layer_norm_entry(sd, pre + "attention.output.LayerNorm", layer["attn_norm"])
        _linear_entry(sd, pre + "intermediate.dense", layer["intermediate"])
        _linear_entry(sd, pre + "output.dense", layer["output"])
        _layer_norm_entry(sd, pre + "output.LayerNorm", layer["ffn_norm"])
    _linear_entry(sd, "pooler.dense", p["pooler"])
    return sd


def clap_text_state_dict(params) -> StateDict:
    """The text side of CLAP flax params -> the port's CLAP state_dict: the
    text branch, ``text_projection`` and ``logit_scale_t``, and
    ``text_transform`` when the params hold it (an init through
    ``get_text_embedding`` alone does not)."""
    p = _unwrap(params)
    sd: StateDict = {f"text_branch.{k}": v for k, v in roberta_state_dict(p["text_branch"]).items()}
    _linear_entry(sd, "text_projection.0", p["text_projection"]["fc1"])
    _linear_entry(sd, "text_projection.2", p["text_projection"]["fc2"])
    if "text_transform" in p:
        _linear_entry(sd, "text_transform.sequential.0", p["text_transform"]["fc0"])
        _linear_entry(sd, "text_transform.sequential.3", p["text_transform"]["fc1"])
    sd["logit_scale_t"] = _t(p["logit_scale_t"])
    return sd


def hubert_state_dict(params) -> StateDict:
    """HubertModel flax params -> the port's state_dict, in Hugging Face
    ``HubertModel``'s key layout (the positional conv's weight folded)."""
    p = _unwrap(params)
    fe = p["feature_encoder"]
    sd: StateDict = {}
    convs = sorted(int(k.split("_")[1]) for k in fe if k.startswith("conv_"))
    for i in convs:
        pre = f"feature_extractor.conv_layers.{i}."
        sd[pre + "conv.weight"] = _conv(fe[f"conv_{i}"]["kernel"])
        if "bias" in fe[f"conv_{i}"]:
            sd[pre + "conv.bias"] = _t(fe[f"conv_{i}"]["bias"])
        norm = fe.get("group_norm") if i == 0 else None
        norm = fe.get(f"layer_norm_{i}", norm)
        if norm is not None:
            _layer_norm_entry(sd, pre + "layer_norm", norm)
    _layer_norm_entry(sd, "feature_projection.layer_norm", p["fp_norm"])
    _linear_entry(sd, "feature_projection.projection", p["fp_proj"])
    sd["encoder.pos_conv_embed.conv.weight"] = _conv(p["pos_conv"]["conv"]["kernel"])
    sd["encoder.pos_conv_embed.conv.bias"] = _t(p["pos_conv"]["conv"]["bias"])
    _layer_norm_entry(sd, "encoder.layer_norm", p["enc_norm"])
    layers = sorted(int(k.split("_")[1]) for k in p if k.startswith("layer_"))
    for i in layers:
        layer, pre = p[f"layer_{i}"], f"encoder.layers.{i}."
        _mha_entries(sd, pre + "attention.", layer["attention"], ("q_proj", "k_proj", "v_proj", "out_proj"))
        _layer_norm_entry(sd, pre + "layer_norm", layer["layer_norm"])
        _linear_entry(sd, pre + "feed_forward.intermediate_dense", layer["ff_intermediate"])
        _linear_entry(sd, pre + "feed_forward.output_dense", layer["ff_output"])
        _layer_norm_entry(sd, pre + "final_layer_norm", layer["final_layer_norm"])
    return sd


def fusion_state_dict(params, stats, prefix: str = "") -> StateDict:
    """A fusion module's flax params and batch_stats (``DAF`` has none;
    ``AFF``: ``local_att`` and ``global_att``; ``iAFF`` also ``local_att2``
    and ``global_att2``, each conv1, bn1, conv2, bn2) -> the port's entries
    under ``prefix`` in the laion Sequential layout (the global branches'
    entries one on, after their pooling)."""
    sd: StateDict = {}
    for branch, node in params.items():
        off = 1 if branch.startswith("global") else 0
        for name, idx in (("conv1", 0), ("bn1", 1), ("conv2", 3), ("bn2", 4)):
            pre = f"{prefix}{branch}.{idx + off}."
            if name.startswith("conv"):
                sd[pre + "weight"] = _conv2d(node[name]["kernel"])
                sd[pre + "bias"] = _t(node[name]["bias"])
            else:
                st = stats[branch][name]
                sd[pre + "weight"], sd[pre + "bias"] = _t(node[name]["scale"]), _t(node[name]["bias"])
                sd[pre + "running_mean"], sd[pre + "running_var"] = _t(st["mean"]), _t(st["var"])
                sd[pre + "num_batches_tracked"] = torch.tensor(0)
    return sd


def htsat_state_dict(variables) -> StateDict:
    """HTSAT flax variables (``params`` and ``batch_stats``) -> the port's
    state_dict in the laion ``audio_branch`` layout; bn0's running mean and
    variance come from ``batch_stats``. A fusion HTSAT's ``mel_conv2d`` and
    its fusion module (flax's ``AFF_0``) go to ``patch_embed.mel_conv2d`` and
    ``patch_embed.fusion_model``."""
    p, stats = variables["params"], variables["batch_stats"]
    sd: StateDict = {
        "bn0.weight": _t(p["bn0"]["scale"]), "bn0.bias": _t(p["bn0"]["bias"]),
        "bn0.running_mean": _t(stats["bn0"]["mean"]), "bn0.running_var": _t(stats["bn0"]["var"]),
        "bn0.num_batches_tracked": torch.tensor(0),
        "patch_embed.proj.weight": _conv2d(p["patch_embed"]["kernel"]),
        "patch_embed.proj.bias": _t(p["patch_embed"]["bias"]),
        "tscam_conv.weight": _conv2d(p["tscam_conv"]["kernel"]),
        "tscam_conv.bias": _t(p["tscam_conv"]["bias"]),
    }
    _layer_norm_entry(sd, "patch_embed.norm", p["patch_norm"])
    _layer_norm_entry(sd, "norm", p["norm"])
    if "mel_conv2d" in p:
        sd["patch_embed.mel_conv2d.weight"] = _conv2d(p["mel_conv2d"]["kernel"])
        sd["patch_embed.mel_conv2d.bias"] = _t(p["mel_conv2d"]["bias"])
        sd.update(fusion_state_dict(p["AFF_0"], stats["AFF_0"], "patch_embed.fusion_model."))
    for key, node in p.items():
        if key.startswith("stage_"):
            _, si, _, bi = key.split("_")
            pre = f"layers.{si}.blocks.{bi}."
            _layer_norm_entry(sd, pre + "norm1", node["norm1"])
            _linear_entry(sd, pre + "attn.qkv", node["attn"]["qkv"])
            _linear_entry(sd, pre + "attn.proj", node["attn"]["proj"])
            sd[pre + "attn.relative_position_bias_table"] = _t(node["attn"]["rel_pos_bias_table"])
            _layer_norm_entry(sd, pre + "norm2", node["norm2"])
            _linear_entry(sd, pre + "mlp.fc1", node["mlp_fc1"])
            _linear_entry(sd, pre + "mlp.fc2", node["mlp_fc2"])
        elif key.startswith("merge_"):
            pre = f"layers.{key.split('_')[1]}.downsample."
            _layer_norm_entry(sd, pre + "norm", node["norm"])
            sd[pre + "reduction.weight"] = _dense(node["reduction"]["kernel"])
    return sd


def clap_audio_state_dict(params) -> StateDict:
    """The audio side of CLAP flax variables -> the port's CLAP state_dict
    entries: ``audio_branch`` (with bn0's statistics from the variables'
    ``batch_stats``), ``audio_projection``, ``logit_scale_a``, and
    ``audio_transform`` when the params hold it."""
    p = _unwrap(params)
    stats = params["batch_stats"]["audio_branch"]
    sd: StateDict = {f"audio_branch.{k}": v for k, v in htsat_state_dict(
        {"params": p["audio_branch"], "batch_stats": stats}).items()}
    _linear_entry(sd, "audio_projection.0", p["audio_projection"]["fc1"])
    _linear_entry(sd, "audio_projection.2", p["audio_projection"]["fc2"])
    if "audio_transform" in p:
        _linear_entry(sd, "audio_transform.sequential.0", p["audio_transform"]["fc0"])
        _linear_entry(sd, "audio_transform.sequential.3", p["audio_transform"]["fc1"])
    sd["logit_scale_a"] = _t(p["logit_scale_a"])
    return sd


def kmeans_centroids(centroids) -> torch.Tensor:
    """[K, D] k-means centroids (numpy or a JAX array) -> float32 tensor."""
    return _t(np.asarray(centroids, np.float32))


def rvq_state(rvq) -> RVQState:
    """A JAX ``RVQState`` (or anything with ``codebooks`` [Q, K, D]) -> the
    port's RVQState, with the EMA training state where ``rvq`` has one."""
    return RVQState(*(None if a is None else _t(a) for a in (getattr(rvq, f, None) for f in RVQState._fields)))
