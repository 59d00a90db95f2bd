"""Port parity, the stage options no shipped config sets: the T5 bucketed
relative position bias (with a bidirectional prefix, which makes the
prefill read the table beyond bucket 0) together with absolute position
embeddings, over the plain (non-conv) FeedForward and over the conv one,
and attention dropout, against the JAX package on the CPU in float32
(weights carried over by open_musiclm_torch.convert; JAX's matmuls at
"highest", tests/conftest.py). The T5 buckets, bias and table and
``unique_consecutive`` are in tests/test_torch_t5.py, which shares this
file's helpers.

Logits within 1e-4 of the largest logit, losses within rtol 1e-5 and
gradients within 1e-4 of each tensor's largest (tests/test_torch_train.py's
limits). Attention dropout draws from a ``torch.Generator`` and JAX's from
its own bits, so it is held by its properties: the rate and the scaling,
identity when deterministic, the plain path it takes, and the same masks
under remat and on two tensor-parallel ranks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu.core.sequence import TokenSequenceSpec as JSpec
from open_musiclm_tpu.models.quant_decode import generate_quantized as j_generate_quantized
from open_musiclm_tpu.models.quant_decode import quantize_stage_params as j_quantize_stage_params
from open_musiclm_tpu.models.token_cond import StageLossConfig as JLossConfig
from open_musiclm_tpu.models.token_cond import TokenConditionedTransformer as JTCT
from open_musiclm_tpu.models.token_cond import generate as j_generate
from open_musiclm_tpu.models.token_cond import stage_training_loss as j_stage_training_loss
from open_musiclm_tpu.testing import CB

from open_musiclm_torch.convert import stage_state_dict
from open_musiclm_torch.core.sequence import TokenSequenceSpec
from open_musiclm_torch.models import quant_decode as tqd
from open_musiclm_torch.models import token_cond as ttc
from open_musiclm_torch.models.token_cond import StageLossConfig, TokenConditionedTransformer, stage_training_loss
from open_musiclm_torch.models.transformer import Attention, dropout
from open_musiclm_torch.ops import attention as tattn

from tests.torch_dp_workers import run_ranks, tp_options_rank
from tests.torch_threads import one_torch_thread  # noqa: F401

# the options together, over the plain FeedForward (whose int8 decodes JAX
# cannot run) and over the conv one
OPTS_CONV = dict(relative_position_bias_type="t5", non_causal_prefix_size=3,
                 use_absolute_position_embeddings=True, max_absolute_position_embeddings=40)
OPTS_PLAIN = dict(OPTS_CONV, use_conv_ff=False)
LENS = (6, 9)  # the conditioning sequence (2 quantizers) and the final one (3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(got, want, rel, what=""):
    want = np.asarray(want)
    err = float(np.max(np.abs(got.detach().float().numpy() - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= rel * max(scale, 1e-30), f"{what}: max abs err {err} > {rel} x {scale}"


@functools.lru_cache(maxsize=None)
def _jax_stage(seed, specs, opts):
    jmodel = JTCT(specs=specs, dim=32, depth=2, heads=2, dim_head=8, **dict(opts))
    ids = [jnp.zeros((1, n), jnp.int32) for n in LENS]
    return jmodel, jax.jit(jmodel.init)(jax.random.PRNGKey(seed), ids)


def _pair(seed=0, specs=(JSpec(CB, 2), JSpec(CB, 3)), **opts):
    """The JAX stage (dim 32, depth 2, 2 heads of 8) with ``opts``, made
    once for the module, and a fresh port model with its weights."""
    jmodel, jparams = _jax_stage(seed, specs, tuple(sorted(opts.items())))
    model = TokenConditionedTransformer(
        tuple(TokenSequenceSpec(s.codebook_size, s.num_quantizers, s.unique_consecutive) for s in specs),
        32, 2, heads=2, dim_head=8, **opts)
    model.load_state_dict(stage_state_dict(jax.device_get(jparams), len(specs), 2))
    return jmodel, jparams, model.eval()


def _loss_grads(jmodel, jparams, model, ids, cfg_kw):
    """Both packages' stage_training_loss (train, no dropout, no forgetful
    mask) and gradients; returns (port loss, JAX loss, port aux, JAX aux,
    port grads, JAX grads in the port's names)."""
    weights = (0.5, 1.0)

    def jloss(p):
        return j_stage_training_loss(jmodel, p, [jnp.asarray(a) for a in ids], jax.random.PRNGKey(0),
                                     JLossConfig(weights, mask_prob=0.0, **cfg_kw), train=True)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    model.train()
    loss, aux = stage_training_loss(model, [_t(a).long() for a in ids],
                                    StageLossConfig(weights, mask_prob=0.0, **cfg_kw), train=True)
    loss.backward()
    want = stage_state_dict(jax.device_get(jg), len(ids), 2)
    return loss, jl, aux, jaux, dict(model.named_parameters()), want


def _check_grads(got, want, rel=1e-4):
    """Every gradient (name -> tensor, both sides) within ``rel`` of its
    tensor's largest. The rel-pos MLP's output bias shifts every score of a
    row alike, which the softmax ignores: its true gradient is 0 and both
    sides hold rounding noise, held to 1e-5 of the output weight's gradient
    (tests/test_torch_train.py). Where JAX's gradient is NaN (a zero row's
    l2norm, whose sqrt has no derivative at 0), the port's is NaN at the
    same entries."""
    assert set(got) == set(want)
    shift = "transformer.rel_pos_bias.out_layer.bias"
    for n, g in got.items():
        w = want[n].numpy()
        if n == shift:
            floor = 1e-5 * float(np.abs(want["transformer.rel_pos_bias.out_layer.weight"].numpy()).max())
            assert g.abs().max() <= floor and np.abs(w).max() <= floor
        elif np.isnan(w).any():
            np.testing.assert_array_equal(torch.isnan(g).numpy(), np.isnan(w), err_msg=n)
        else:
            _rel_close(g, w, rel, n)


def _stage_ids(rng, batch=2):
    cond = rng.integers(0, CB, (batch, LENS[0]))
    cond[0, -1] = -1  # a pad the key mask hides
    return [cond.astype(np.int32), rng.integers(0, CB, (batch, LENS[1])).astype(np.int32)]


# ---------------------------------------------------------------------------
# the T5 bias with absolute positions, over the plain and the conv FeedForward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opts", [OPTS_PLAIN, OPTS_CONV], ids=["plain-ff", "conv-ff"])
def test_stage_options_loss_and_grads_match_jax(opts):
    """The forward logits, the loss and every gradient: the T5 bucket
    table's (JAX buckets every causal distance to bucket 0, so it is the
    prefix rows' keys after the query that reach the other buckets), the
    position tables' and the plain FeedForward's."""
    jmodel, jparams, model = _pair(5, **opts)
    loss, jl, aux, jaux, grads, want = _loss_grads(jmodel, jparams, model, _stage_ids(np.random.default_rng(6)), {})
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for lg, jlg in zip(aux["logits"], jaux["logits"]):
        _rel_close(lg, jlg, 1e-4, "logits")
    assert {"pos_embeds.0.weight", "pos_embeds.1.weight", "transformer.rel_pos_bias.embedding"} <= set(grads)
    table = want["transformer.rel_pos_bias.embedding"].numpy()
    assert (np.abs(table).max(axis=1) > 1e-3 * np.abs(table).max()).sum() >= 3
    _check_grads({n: p.grad for n, p in grads.items()}, want)


@pytest.mark.parametrize("opts,mode", [(OPTS_PLAIN, dict(quantized=False)), (OPTS_CONV, dict(flash_kv="fused"))],
                         ids=["plain-ff-fp", "conv-ff-fused"])
def test_stage_options_decode_logits_match_jax(opts, mode):
    """Teacher-forced decode after a 2-step prefix: the T5 bias through the
    prefill and the steps (the fp decode reads the decode-layout table
    through ``shared_kv_decode_step``, as ``flash_kv=None`` does; "fused"
    its step's bias row, sliced as the flash modes slice it for kernel 2),
    and the position table's row added at each token's flat index (every
    mode embeds its tokens through ``embed_pred_token``). The fp decode is
    the only one JAX runs with the plain FeedForward. ``chip_smoke.py``
    holds every mode with the T5 bias on the card."""
    jmodel, jparams, model = _pair(5, **opts)
    rng = np.random.default_rng(8)
    cond = rng.integers(0, CB, (2, 6)).astype(np.int32)
    teacher = rng.integers(0, CB, (2, 5, 3)).astype(np.int32)
    init = teacher[:, :2]
    kw = dict(max_time_steps=5, return_logits=True)
    if mode.get("quantized", True):
        fused = mode["flash_kv"] == "fused"
        qp = j_quantize_stage_params(jmodel, jparams, fused=fused)
        _, want = jax.jit(lambda p, q, c, i, t: j_generate_quantized(
            jmodel, p, q, [c], jax.random.PRNGKey(0), flash_kv=mode["flash_kv"], use_pallas=False,
            init_pred_ids=i, teacher_ids=t, **kw))(jparams, qp, jnp.asarray(cond), jnp.asarray(init),
                                                   jnp.asarray(teacher))
        _, got = tqd.generate_quantized(model, tqd.quantize_stage_params(model, fused=fused), [_t(cond)],
                                        torch.Generator(), flash_kv=mode["flash_kv"], init_pred_ids=_t(init),
                                        teacher_ids=_t(teacher), **kw)
    else:
        _, want = jax.jit(lambda p, c, i, t: j_generate(jmodel, p, [c], jax.random.PRNGKey(0), init_pred_ids=i,
                                                        teacher_ids=t, **kw))(
            jparams, jnp.asarray(cond), jnp.asarray(init), jnp.asarray(teacher))
        _, got = ttc.generate(model, [_t(cond)], torch.Generator(), init_pred_ids=_t(init),
                              teacher_ids=_t(teacher), **kw)
    assert got.shape == tuple(want.shape) == (2, 9, CB + 1)
    _rel_close(got, want, 1e-4, "logits")


def test_plain_ff_int8_decodes_raise_in_both_packages():
    """The JAX package's quantize_stage_params packs every layer's conv
    weights and fails on the plain FeedForward; the port refuses it too."""
    jmodel, jparams, model = _pair(5, **OPTS_PLAIN)
    with pytest.raises(KeyError):
        j_quantize_stage_params(jmodel, jparams)
    with pytest.raises(ValueError, match="plain FeedForward"):
        tqd.quantize_stage_params(model)
    assert model.transformer.init_cache(2, 8)["ff"].shape == (2, 2, 2, 1)


# ---------------------------------------------------------------------------
# attention dropout
# ---------------------------------------------------------------------------


def test_attention_dropout_rate_and_scaling():
    """The keep mask drops the rate's share of entries (within 4 sigma of a
    binomial over 2**20) and scales the kept ones by 1 / (1 - rate); a split
    draw keeps its slice of the whole mask."""
    u = torch.rand(16, 4, 128, 128, generator=torch.Generator().manual_seed(0)) + 0.5
    for rate in (0.1, 0.5):
        out = dropout(u, rate, torch.Generator().manual_seed(1))
        dropped = (out == 0).float().mean().item()
        assert abs(dropped - rate) <= 4 * (rate * (1 - rate) / u.numel()) ** 0.5
        kept = out != 0
        torch.testing.assert_close(out[kept], u[kept] / (1 - rate), atol=0, rtol=0)
    whole = dropout(u, 0.1, torch.Generator().manual_seed(2))
    part = dropout(u[:, 2:4], 0.1, torch.Generator().manual_seed(2), (4, slice(2, 4)), axis=1)
    torch.testing.assert_close(part, whole[:, 2:4], atol=0, rtol=0)


def test_attention_dropout_identity_when_deterministic():
    """In eval() mode (JAX's deterministic) a stage with attn_dropout 0.3
    gives the JAX package's logits, and those of the same weights at rate 0;
    in train() mode with the rate at 1e-12 (every key kept, the scale 1 in
    float32) it takes the plain attention and gives the kernel path's
    logits."""
    jmodel, jparams, model = _pair(10, attn_dropout=0.3)
    plain = TokenConditionedTransformer(model.specs, 32, 2, heads=2, dim_head=8)
    plain.load_state_dict(model.state_dict())
    plain.eval()
    ids = [np.random.default_rng(11).integers(0, CB, (2, n)).astype(np.int32) for n in LENS]
    want = jax.jit(lambda p, i: jmodel.apply(p, i, deterministic=True))(jparams, [jnp.asarray(a) for a in ids])
    with torch.no_grad():
        got = model([_t(a).long() for a in ids])
        ref = plain([_t(a).long() for a in ids])
    for g, r, w in zip(got, ref, want):
        _rel_close(g, w, 1e-4, "logits")
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    attn = Attention(32, 2, 8, dropout=1e-12, generator=torch.Generator().manual_seed(12)).train()
    x = torch.randn(2, 9, 32, generator=torch.Generator().manual_seed(13))
    with torch.no_grad():
        dropped = attn(x, generator=torch.Generator().manual_seed(0))[0]
        kernel = attn.eval()(x)[0]
    torch.testing.assert_close(dropped, kernel, atol=1e-6, rtol=1e-6)


def test_attention_dropout_plain_path_matches_jax():
    """The plain attention the dropout path takes, with a keep mask handed
    to both packages' formulas (JAX's ``where(keep, p / (1 - rate), 0)``)."""
    rng = np.random.default_rng(14)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((2, 2, 9, 8), (2, 9, 8), (2, 9, 8)))
    keep = rng.random((2, 2, 9, 9)) > 0.25
    want = jnp.einsum("bhnm,bmd->bhnd", jnp.where(keep, jax.nn.softmax(jnp.where(
        np.tril(np.ones((9, 9), bool)), jnp.einsum("bhnd,bmd->bhnm", q, k) * 8.0, -1e9), -1) / 0.75, 0.0), v)
    got = tattn.shared_kv_attention(_t(q), _t(k), _t(v), causal=True,
                                    dropout=lambda p: torch.where(_t(keep), p / 0.75, torch.zeros(())))
    _rel_close(got, np.asarray(want).transpose(0, 2, 1, 3).reshape(2, 9, 16), 1e-5, "out")


# dim 48: the conv-FF's 128 channels split over tp=2 too
DROPOUT_KW = dict(specs=(TokenSequenceSpec(CB, 2), TokenSequenceSpec(CB, 3)), dim=48, depth=2, heads=2,
                  dim_head=8, attn_dropout=0.2, ff_dropout=0.1)


def _dropout_model(remat):
    return TokenConditionedTransformer(**DROPOUT_KW, generator=torch.Generator().manual_seed(15),
                                       remat=remat).train()


def test_attention_dropout_same_masks_under_remat():
    """Remat replays the attention's two masks (probabilities and output)
    and the FF's from the generator: the loss and every gradient are
    bit-equal to the run without remat, and both differ from a run drawn
    from another seed."""
    ids = [_t(a).long() for a in _stage_ids(np.random.default_rng(16))]
    out = []
    for remat, seed in ((False, 17), (True, 17), (False, 18)):
        model = _dropout_model(remat)
        loss, _ = stage_training_loss(model, ids, StageLossConfig((0.5, 1.0), mask_prob=0.0),
                                      generator=torch.Generator().manual_seed(seed), train=True)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()}))
    torch.testing.assert_close(out[1][0], out[0][0], atol=0, rtol=0)
    for n, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][n], g, atol=0, rtol=0)
    assert not torch.equal(out[2][0], out[0][0])


def test_attention_dropout_tp2_draws_one_process_masks(tmp_path):
    """Two gloo ranks at tp=2 (a head a rank) draw every head's mask and
    keep their own: the loss and the gathered gradients equal one process's
    from the same generator seed (1e-5 of each tensor's largest)."""
    ids = [_t(a).long() for a in _stage_ids(np.random.default_rng(19))]
    torch.save({"ids": ids, "state": _dropout_model(False).state_dict(), "model_kw": DROPOUT_KW},
               tmp_path / "inputs.pt")
    run_ranks(tp_options_rank, 2, (str(tmp_path / "store"), str(tmp_path)))
    model = _dropout_model(False)
    loss, _ = stage_training_loss(model, ids, StageLossConfig((0.5, 1.0), mask_prob=0.0),
                                  generator=torch.Generator().manual_seed(20), train=True)
    loss.backward()
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        np.testing.assert_allclose(got["loss"], loss.item(), rtol=1e-6)
        _check_grads(got["grads"], {n: p.grad for n, p in model.named_parameters()}, 1e-5)
