"""Port parity, remat and the training roofline: the port's per-block
rematerialization (``Transformer.remat``) against the same model without
it and against the JAX package's ``model.clone(remat=True)``, and
``train/roofline.py`` against ``open_musiclm_tpu/train/roofline.py``, on the
CPU (every kernel wrapper runs its plain version).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu import config as jconfig
from open_musiclm_tpu.models.token_cond import StageLossConfig as JLossConfig
from open_musiclm_tpu.models.token_cond import stage_training_loss as j_stage_training_loss
from open_musiclm_tpu.train import roofline as jroofline

from open_musiclm_torch import config as tconfig
from open_musiclm_torch.convert import stage_state_dict
from open_musiclm_torch.core.sequence import TokenSequenceSpec
from open_musiclm_torch.models import transformer
from open_musiclm_torch.models.token_cond import StageLossConfig, TokenConditionedTransformer, stage_training_loss
from open_musiclm_torch.train import roofline

from tests.test_torch_train import STAGES, TINY, _stage_ids, _t, port_model
from tests.torch_threads import one_torch_thread  # noqa: F401

H100 = "NVIDIA H100 80GB HBM3"
ROOT_CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "model"


def _stage(stage, seed=0, dropout=0.1):
    factory, kw, lens = STAGES[stage]
    jmodel = factory(**TINY, **kw)
    specs = tuple(TokenSequenceSpec(s.codebook_size, s.num_quantizers) for s in jmodel.specs)
    model = TokenConditionedTransformer(specs, TINY["dim"], TINY["depth"], heads=TINY["heads"],
                                        dim_head=TINY["dim_head"], ff_dropout=dropout,
                                        generator=torch.Generator().manual_seed(seed))
    return model.train(), lens


def _steps(model, ids, cfg, remat, accum, generator):
    """``accum`` micro-batches' (loss, gradients), and the generator's state
    after them."""
    model.transformer.remat = remat
    out = []
    for a in range(accum):
        loss, _ = stage_training_loss(model, [t[a] for t in ids], cfg, generator=generator)
        out.append((loss.detach(), torch.autograd.grad(loss, list(model.parameters()))))
    return out, (generator.get_state() if generator is not None else torch.get_rng_state())


@pytest.mark.parametrize("stage", ["semantic", "coarse", "fine"])
@pytest.mark.parametrize("own_generator", [True, False])
def test_remat_equals_no_remat_with_dropout(stage, own_generator):
    """Dropout 0.1 and the forgetful mask on, 2 micro-batches from one
    generator (or the default one): bit-equal losses and gradients with and
    without remat, and the generator left in the same state."""
    model, lens = _stage(stage)
    rng = np.random.default_rng(7)
    micro = [[_t(a).long() for a in _stage_ids(rng, model.specs, lens, 2)] for _ in range(2)]
    ids = [torch.stack([m[i] for m in micro]) for i in range(len(lens))]  # [accum, B, n_i]
    cfg = StageLossConfig(tuple(0.5 + 0.25 * i for i in range(len(lens))), mask_prob=0.15)
    runs = []
    for remat in (False, True):
        if own_generator:
            gen = torch.Generator().manual_seed(11)
        else:
            gen = None
            torch.manual_seed(11)
        runs.append(_steps(model, ids, cfg, remat, 2, gen))
    (plain, plain_state), (remat, remat_state) = runs
    assert torch.equal(plain_state, remat_state)
    for (l0, g0), (l1, g1) in zip(plain, remat):
        assert torch.equal(l0, l1)
        for a, b in zip(g0, g1):
            assert torch.equal(a, b)
    assert plain[0][0] != plain[1][0]  # the two micro-batches drew other masks


def test_remat_recomputes_each_block_in_the_backward(monkeypatch):
    """With remat the attention runs twice a layer and micro-batch (forward,
    then the backward's recompute), without it once; under no_grad remat
    changes nothing."""
    model, lens = _stage("coarse", dropout=0.0)
    calls = [0]
    attention = transformer.shared_kv_attention_train

    def counted(*args, **kw):
        calls[0] += 1
        return attention(*args, **kw)

    monkeypatch.setattr(transformer, "shared_kv_attention_train", counted)
    ids = [_t(a).long() for a in _stage_ids(np.random.default_rng(1), model.specs, lens, 2)]
    cfg = StageLossConfig((0.5, 0.5, 1.0), mask_prob=0.0)
    for remat, want in ((False, 1), (True, 2)):
        model.transformer.remat = remat
        calls[0] = 0
        loss, _ = stage_training_loss(model, ids, cfg)
        torch.autograd.grad(loss, list(model.parameters()))
        assert calls[0] == want * model.depth
    with torch.no_grad():
        outs = []
        for remat in (False, True):
            model.transformer.remat = remat
            calls[0] = 0
            outs.append(stage_training_loss(model, ids, cfg, train=False)[0])
            assert calls[0] == model.depth
    assert torch.equal(*outs)


def test_remat_matches_jax_remat():
    """Dropout 0: the port with remat against the JAX package's
    model.clone(remat=True), float32 on both sides: the loss within 1e-5,
    every gradient within 1e-5 x the model's largest gradient, and each
    within 1e-4 x its own tensor's max|grad|, the limit
    tests/test_torch_train.py holds the path without remat to (the rel-pos
    MLP's input weight, a sum of many cancelling terms, reads ~1.1e-5 of its
    own max in the fine stage). The coarse stage, whose stream holds all
    three kinds of sequence. The rel-pos MLP's output bias has a true
    gradient of 0 (it shifts a whole score row): both sides' rounding noise
    is held to 1e-5 of the output weight's."""
    factory, kw, lens = STAGES["coarse"]  # three sequences: every part of the stream
    jmodel = factory(**TINY, **kw).clone(remat=True)
    rng = np.random.default_rng(9)
    ids = _stage_ids(rng, jmodel.specs, lens, 2)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(5), [jnp.asarray(a) for a in ids])
    weights = tuple(0.5 + 0.25 * i for i in range(len(lens)))

    def jloss(params):
        return j_stage_training_loss(jmodel, params, [jnp.asarray(a) for a in ids], jax.random.PRNGKey(0),
                                     JLossConfig(weights, mask_prob=0.0), train=True)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jparams)
    want = stage_state_dict(jax.device_get(want_grads), len(lens), jmodel.depth)
    model = port_model(jmodel, jparams).train()
    model.transformer.remat = True
    loss, _ = stage_training_loss(model, [_t(a).long() for a in ids], StageLossConfig(weights, mask_prob=0.0))
    grads = dict(zip(dict(model.named_parameters()), torch.autograd.grad(loss, list(model.parameters()))))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    shift = "transformer.rel_pos_bias.out_layer.bias"
    top = max(w.abs().max().item() for w in want.values())
    for name, g in grads.items():
        if name == shift:
            floor = 1e-5 * want["transformer.rel_pos_bias.out_layer.weight"].abs().max().item()
            assert g.abs().max() <= floor and want[name].abs().max() <= floor
            continue
        scale = want[name].abs().max().item()
        err = (g - want[name]).abs().max().item()
        assert err <= 1e-5 * top, f"{name}: {err} > 1e-5 x {top} (the largest gradient)"
        assert err <= 1e-4 * scale, f"{name}: {err} > 1e-4 x {scale}"


# ---------------------------------------------------------------------------
# the training roofline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model_name", ["musiclm_small", "musiclm_large"])
@pytest.mark.parametrize("stage", ["semantic", "coarse", "fine"])
def test_roofline_terms_match_jax(model_name, stage):
    """Every byte term and the FLOPs equal the JAX package's for each of
    remat, pallas_attention and the compute / parameter dtypes; only the
    peaks differ (the H100's data sheet)."""
    path = f"{ROOT_CONFIGS}/{model_name}.json"
    jmc, mc = jconfig.load_model_config(path), tconfig.load_model_config(path)
    jmodel = getattr(jconfig, f"build_{stage}_transformer")(jmc)
    with torch.device("meta"):
        model = getattr(tconfig, f"build_{stage}_transformer")(mc)
    lens = tconfig.stage_example_lengths(mc, stage)
    assert lens == jconfig.stage_example_lengths(jmc, stage)
    for remat in (False, True):
        for pallas in (False, True):
            for a, p in ((2, 4), (2, 2), (4, 4)):
                kw = dict(compute_dtype_bytes=a, param_dtype_bytes=p, pallas_attention=pallas, remat=remat)
                want = jroofline.stage_train_roofline(jmodel, lens, 2, 8, device_kind="TPU v5 lite", **kw)
                got = roofline.stage_train_roofline(model, lens, 2, 8, device_name=H100, **kw)
                assert got.flops == want.flops
                assert got.bytes_by_term == want.bytes_by_term
                assert got.peak_bw == 3.35e12
                assert got.peak_flops == (989e12 if a == 2 else 67e12)
    assert roofline.stage_train_roofline(model, lens, 2, 8, device_name=H100).bytes_by_term["attn_scores"] == 0


def test_roofline_refuses_an_unknown_card():
    model, lens = _stage("coarse", dropout=0.0)
    with pytest.raises(KeyError, match="TPU v5 lite"):
        roofline.stage_train_roofline(model, lens, 2, 8, device_name="TPU v5 lite")
    with pytest.raises(KeyError):
        roofline.peak_hbm_bytes_per_s("NVIDIA A100-SXM4-80GB")


def test_roofline_cli_prints_the_jax_scripts_fields(capsys):
    from open_musiclm_torch.cli import roofline_train

    out = roofline_train.main(["--stage", "coarse", "--batch", "2", "--accum", "8", "--remat", "1",
                               "--device_name", H100, "--measured_ms", "400", "--json"])
    assert set(out) == {"stage", "model", "batch", "accum", "device_kind", "pallas", "remat", "param_dtype",
                        "compute_ms", "memory_ms", "bound", "bound_ms", "mfu_ceiling", "bytes_gb_by_term",
                        "model_tflops", "measured_ms", "roofline_fraction"}
    assert out["device_kind"] == H100 and out["pallas"] and out["remat"]
    assert 0 < out["roofline_fraction"] < 1
    # kept to 5 decimals: a share printed to 0.01 % is no rounding artefact
    assert out["roofline_fraction"] == pytest.approx(out["bound_ms"] / 400, abs=2e-5)
