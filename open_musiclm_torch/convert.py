"""Weight bridge: the JAX package's parameter pytrees -> the port's state_dicts.

Input is a stage's ``params``, the codec's ``codec_params``, the CLAP's or
RoBERTa's params, as nested dicts of numpy arrays (``jax.device_get`` of
the flax variables, with or without the top-level ``"params"`` key), or an
``RVQState``. Layouts:

  * flax Dense kernel [in, out]           -> nn.Linear weight [out, in]
  * flax Conv kernel [k, in, out]         -> nn.Conv1d weight [out, in, k]
  * flax ConvTranspose kernel [k, in, out] -> nn.ConvTranspose1d weight
    [in, out, k] with the taps flipped (lax.conv_transpose does not flip;
    open_musiclm_tpu/import_torch.py:conv_transpose1d is the inverse map)
  * flax MultiHeadDotProductAttention query/key/value kernels [in, heads,
    head_dim] -> nn.Linear weight [heads * head_dim, in], biases [heads,
    head_dim] -> [heads * head_dim]; the output kernel [heads, head_dim,
    out] -> [out, heads * head_dim] (open_musiclm_tpu/import_torch.py:mha is
    the inverse map)
  * flax LayerNorm scale / bias -> nn.LayerNorm weight / bias
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


def _conv_transpose(a) -> torch.Tensor:
    return _t(np.transpose(np.asarray(a)[::-1], (1, 2, 0)))


def _unwrap(params) -> dict:
    return params["params"] if "params" in params else params


def stage_state_dict(params, num_specs: int, depth: int) -> StateDict:
    """A TokenConditionedTransformer's flax params -> the port's state_dict."""
    p = _unwrap(params)
    t = p["transformer"]
    sd: StateDict = {"start_tokens": _t(p["start_tokens"])}
    for i in range(num_specs):
        sd[f"embeds.{i}.weight"] = _t(p[f"embed_{i}"]["embedding"])
        sd[f"logit_heads.{i}"] = _t(p[f"logits_{i}"])
    if "rel_pos_bias" in t:
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
        sd[pf + "conv_w"] = _t(f["conv_w"])
        sd[pf + "norm_mid.gamma"] = _t(f["norm_mid"]["gamma"])
        sd[pf + "proj_out.weight"] = _dense(f["proj_out"]["kernel"])
    sd["transformer.final_norm.gamma"] = _t(t["final_norm"]["gamma"])
    return sd


def _conv_entry(sd: StateDict, prefix: str, node) -> None:
    sd[prefix + ".weight"] = _conv(node["conv"]["kernel"])
    sd[prefix + ".bias"] = _t(node["conv"]["bias"])


def codec_state_dict(codec_params, num_stages: int, lstm_layers: int = 2) -> StateDict:
    """EncodecModel flax params -> the port's decoder + codebooks state_dict
    (the encoder is not ported)."""
    p = _unwrap(codec_params)
    d = p["decoder"]
    sd: StateDict = {"codebooks": _t(p["codebooks"])}
    _conv_entry(sd, "decoder.conv_in.conv", d["conv_in"])
    for layer in range(lstm_layers):
        for kind in ("ih", "hh"):
            sd[f"decoder.lstm.lstm.weight_{kind}_l{layer}"] = _t(d["lstm"][f"w_{kind}_{layer}"])
            sd[f"decoder.lstm.lstm.bias_{kind}_l{layer}"] = _t(d["lstm"][f"b_{kind}_{layer}"])
    for s in range(num_stages):
        up = d[f"up_{s}"]["convtr"]
        sd[f"decoder.ups.{s}.convtr.weight"] = _conv_transpose(up["kernel"])
        sd[f"decoder.ups.{s}.convtr.bias"] = _t(up["bias"])
        res = d[f"res_{s}_0"]
        for name in ("block_conv1", "block_conv2", "shortcut"):
            _conv_entry(sd, f"decoder.res.{s}.{name}.conv", res[name])
    _conv_entry(sd, "decoder.conv_out.conv", d["conv_out"])
    return sd


def _linear_entry(sd: StateDict, prefix: str, node) -> None:
    sd[prefix + ".weight"] = _dense(node["kernel"])
    sd[prefix + ".bias"] = _t(node["bias"])


def _layer_norm_entry(sd: StateDict, prefix: str, node) -> None:
    sd[prefix + ".weight"] = _t(node["scale"])
    sd[prefix + ".bias"] = _t(node["bias"])


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
        attn = layer["attention"]
        for name in ("query", "key", "value"):
            kernel = np.asarray(attn[name]["kernel"])  # [in, heads, head_dim]
            sd[pre + f"attention.self.{name}.weight"] = _t(kernel.reshape(kernel.shape[0], -1).T)
            sd[pre + f"attention.self.{name}.bias"] = _t(np.asarray(attn[name]["bias"]).reshape(-1))
        out = np.asarray(attn["out"]["kernel"])  # [heads, head_dim, out]
        sd[pre + "attention.output.dense.weight"] = _t(out.reshape(-1, out.shape[-1]).T)
        sd[pre + "attention.output.dense.bias"] = _t(attn["out"]["bias"])
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


def rvq_state(rvq) -> RVQState:
    """A JAX ``RVQState`` (or anything with ``codebooks`` [Q, K, D]) -> the
    port's RVQState; the EMA statistics are training state and stay behind."""
    return RVQState(_t(rvq.codebooks))
