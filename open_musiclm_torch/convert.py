"""Weight bridge: the JAX package's parameter pytrees -> the port's state_dicts.

Input is a stage's ``params`` or the codec's ``codec_params`` as nested
dicts of numpy arrays (``jax.device_get`` of the flax variables, with or
without the top-level ``"params"`` key). Layouts:

  * flax Dense kernel [in, out]           -> nn.Linear weight [out, in]
  * flax Conv kernel [k, in, out]         -> nn.Conv1d weight [out, in, k]
  * flax ConvTranspose kernel [k, in, out] -> nn.ConvTranspose1d weight
    [in, out, k] with the taps flipped (lax.conv_transpose does not flip;
    open_musiclm_tpu/import_torch.py:conv_transpose1d is the inverse map)
  * embeddings, logit heads [Q, C, d], start tokens, conv_w [3, 2*inner],
    gammas, q/k scales, the LSTM (already in torch's gate order) and the
    codebooks carry over unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

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
