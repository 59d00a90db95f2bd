"""Builds the system under test, open_musiclm_torch, from a configuration
file: the three stages (``Stage`` in the configuration's decode mode), the
Encodec codec and, for text prompts, the CLAP text tower with its RVQ and a
tokenizer over the demo vocabulary. Modules are made on the device by the
program's own constructors, then take the seeded weights of
``benchmark/weights.py``; the program's own seeded init (drawn on the host)
is not used.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from . import weights as W

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
STAGES = ("semantic", "coarse", "fine")


def model_config(cfg: Dict[str, Any]):
    from open_musiclm_torch import config as C

    m = cfg["model"]
    return C.MusicLMModelConfig(
        clap_rvq_cfg=C.ClapRVQConfig(**m["clap_rvq_cfg"]),
        hubert_kmeans_cfg=C.HubertKmeansConfig(**m["hubert_kmeans_cfg"]),
        encodec_cfg=C.EncodecConfig(**m["encodec_cfg"]),
        semantic_cfg=C.SemanticConfig(**m["semantic_cfg"]),
        coarse_cfg=C.CoarseConfig(**m["coarse_cfg"]),
        fine_cfg=C.FineConfig(**m["fine_cfg"]),
        global_cfg=C.GlobalConfig(**m["global_cfg"]),
    )


def stage_dims(model) -> Dict[str, Any]:
    """What the reference and the work counts need of a stage's shapes."""
    return {"dim": model.dim, "depth": model.depth, "heads": model.heads, "dim_head": model.dim_head,
            "inner": model.transformer.ffs[0].inner_dim, "vocab": model.specs[-1].vocab_with_eos,
            "grad_shrink": model.transformer.grad_shrink_alpha,
            "specs": [(s.codebook_size, s.num_quantizers) for s in model.specs]}


def build_stage_model(cfg: Dict[str, Any], stage: str, seed: int, device, train: bool = False):
    """A stage's TokenConditionedTransformer with the seeded weights: in the
    served dtype for serving, float32 master weights for training."""
    from open_musiclm_torch import config as C

    factory = {"semantic": C.build_semantic_transformer, "coarse": C.build_coarse_transformer,
               "fine": C.build_fine_transformer}[stage]
    mc = model_config(cfg)
    with torch.device(device):
        model = factory(mc)
    dtype = torch.float32 if train else DTYPES[cfg["stage_dtype"]]
    model = model.to(dtype)
    shapes = W.module_shapes(model)
    W.load_into(model, W.draw(shapes, seed, f"stage:{stage}", device, DTYPES[cfg["stage_dtype"]]))
    return model, shapes


def build_musiclm(cfg: Dict[str, Any], seed: int, device, text: bool, vocab_dir=None):
    """(MusicLM, {component: (param shapes, extra)}) for serving."""
    from open_musiclm_torch.models.encodec import create_encodec_24khz
    from open_musiclm_torch.models.musiclm import MusicLM
    from open_musiclm_torch.models.stages import Stage

    mc = model_config(cfg)
    parts: Dict[str, Any] = {}
    stages = []
    for name in STAGES:
        model, shapes = build_stage_model(cfg, name, seed, device)
        model.eval()
        stages.append(Stage(model, name=name, quantized=cfg["flash_kv"] is not None, flash_kv=cfg["flash_kv"]))
        parts[name] = {"shapes": shapes, "dims": stage_dims(model)}
    with torch.device(device):
        codec = create_encodec_24khz(bandwidth=mc.encodec_cfg.bandwidth, codebook_size=mc.encodec_cfg.codebook_size)
    codec = codec.to(DTYPES[cfg["codec_dtype"]]).eval()
    shapes = W.module_shapes(codec)
    W.load_into(codec, W.draw(shapes, seed, "codec", device, DTYPES[cfg["codec_dtype"]]))
    parts["codec"] = {"shapes": shapes}
    clap = tokenizer = None
    if text:
        clap, tokenizer = build_text(cfg, seed, device, vocab_dir)
        parts["clap"] = {"shapes": W.module_shapes(clap.model),
                         "rvq": tuple(clap.rvq.codebooks.shape)}
    lm = MusicLM(codec=codec, semantic_stage=stages[0], coarse_stage=stages[1], fine_stage=stages[2],
                 clap=clap, tokenizer=tokenizer)
    return lm, parts


def build_text(cfg: Dict[str, Any], seed: int, device, vocab_dir):
    from open_musiclm_torch.models.clap.clap import CLAP, JOINT_EMBED, ClapQuantized
    from open_musiclm_torch.models.clap.roberta import RobertaConfig
    from open_musiclm_torch.models.clap.tokenizer import RobertaTokenizer
    from open_musiclm_torch.models.rvq import RVQState

    rq = cfg["model"]["clap_rvq_cfg"]
    dtype = DTYPES[cfg["clap_dtype"]]
    with torch.device(device):
        model = CLAP(RobertaConfig(), joint_embed_shape=JOINT_EMBED)
    model = model.to(dtype).eval()
    W.load_into(model, W.draw(W.module_shapes(model), seed, "clap", device, dtype))
    books = rvq_codebooks(seed, rq["rq_num_quantizers"], rq["codebook_size"], JOINT_EMBED, device)
    clap = ClapQuantized(model=model, rvq=RVQState(books), num_quantizers=rq["rq_num_quantizers"],
                         codebook_size=rq["codebook_size"])
    return clap, RobertaTokenizer.from_dir(str(vocab_dir))


def rvq_codebooks(seed: int, q: int, k: int, d: int, device) -> torch.Tensor:
    return W.draw([("codebooks", (q, k, d))], seed, "rvq", device, torch.float32)["codebooks"]


def stage_weights(parts: Dict[str, Any], name: str, seed: int, cfg: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The seeded weights of a stage again, as the reference takes them."""
    return W.draw(parts[name]["shapes"], seed, f"stage:{name}", device, DTYPES[cfg["stage_dtype"]])


def codec_weights(parts, seed, cfg, device):
    return W.draw(parts["codec"]["shapes"], seed, "codec", device, DTYPES[cfg["codec_dtype"]])


def clap_weights(parts, seed, cfg, device):
    return W.draw(parts["clap"]["shapes"], seed, "clap", device, DTYPES[cfg["clap_dtype"]])

