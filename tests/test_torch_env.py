"""The environment settings the JAX package reads, in the port, each held
against the JAX package under ``monkeypatch.setenv``:
``$OPEN_MUSICLM_FLASH_KV`` (Stage's default decode mode; the fp decode
refuses it), ``$OPEN_MUSICLM_MAX_FINE_ROWS`` / ``$OPEN_MUSICLM_MAX_DECODE_FRAMES``
(read at call time: the fine decode and Encodec's head split into chunks,
the output unchanged) and ``$OPEN_MUSICLM_DISABLE_DROPOUT=1`` (the FF and
attention-output dropouts the identity, one warning a process; the attention
probabilities' dropout draws on, in both packages).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu import config as jconfig
from open_musiclm_tpu.config import load_model_config as j_load_model_config
from open_musiclm_tpu.core.sequence import TokenSequenceSpec as JSpec
from open_musiclm_tpu.models import stages as jstages
from open_musiclm_tpu.models import transformer as jtransformer
from open_musiclm_tpu.models.token_cond import StageLossConfig
from open_musiclm_tpu.models.token_cond import TokenConditionedTransformer as JTCT
from open_musiclm_tpu.testing import CB

from open_musiclm_torch import config as tconfig
from open_musiclm_torch.convert import stage_state_dict
from open_musiclm_torch.core.sampling import seed_keys
from open_musiclm_torch.core.sequence import TokenSequenceSpec
from open_musiclm_torch.models import musiclm as tmusiclm
from open_musiclm_torch.models import transformer as ttransformer
from open_musiclm_torch.models.stages import Stage
from open_musiclm_torch.models.token_cond import TokenConditionedTransformer

from tests.test_torch_load import tiny_model_config
from tests.test_torch_slice import port_model
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory) -> str:
    return tiny_model_config(tmp_path_factory.mktemp("tiny"))


def test_flash_kv_env_sets_the_default_in_both_packages(tiny_config, monkeypatch):
    """``$OPEN_MUSICLM_FLASH_KV`` is Stage's default at construction in both
    packages (and the port's init_stage's, an explicit mode winning); the fp decode
    refuses it naming the variable; with quantized=True the stage decodes in
    that mode, its teacher-forced logits JAX's within 1e-2 x max (int8
    rows). Unset, the default is None."""
    jmc = j_load_model_config(tiny_config)
    mc = tconfig.load_model_config(tiny_config)
    monkeypatch.delenv("OPEN_MUSICLM_FLASH_KV", raising=False)
    jmodel = jconfig.build_semantic_transformer(jmc)  # init_stage's model and params, the init under jit
    ids = [jnp.zeros((1, n), jnp.int32) for n in jconfig.stage_example_lengths(jmc, "semantic")]
    unset = jstages.Stage(jmodel, jax.jit(jmodel.init)(jax.random.PRNGKey(1), ids), StageLossConfig((1.0, 1.0)))
    model = port_model(unset.model, unset.params)
    assert unset.flash_kv is None and Stage(model).flash_kv is None
    assert tconfig.init_stage(mc, "semantic", 1, device="cpu").flash_kv is None
    monkeypatch.setenv("OPEN_MUSICLM_FLASH_KV", "int8")
    jstage = jstages.Stage(unset.model, unset.params, unset.loss_cfg)
    stage = Stage(model)
    assert jstage.flash_kv == stage.flash_kv == "int8"
    assert tconfig.init_stage(mc, "semantic", 1, device="cpu").flash_kv == "int8"
    assert tconfig.init_stage(mc, "semantic", 1, device="cpu", flash_kv="bf16").flash_kv == "bf16"
    cond = np.random.default_rng(0).integers(0, CB, (2, 4))
    with pytest.raises(ValueError, match="OPEN_MUSICLM_FLASH_KV"):
        jstage.generate([jnp.asarray(cond, jnp.int32)], jax.random.PRNGKey(0), max_time_steps=3)
    with pytest.raises(ValueError, match="OPEN_MUSICLM_FLASH_KV"):
        stage.generate([torch.as_tensor(cond)], None, max_time_steps=3)

    teacher = np.random.default_rng(1).integers(0, CB, (2, 6, 1))
    served = dataclasses.replace(stage, quantized=True)
    assert served.flash_kv == "int8"
    _, logits = served.generate([torch.as_tensor(cond)], None, max_time_steps=6, per_row_keys=seed_keys(range(2)),
                                teacher_forced_ids=torch.as_tensor(teacher), return_logits=True)
    _, want = dataclasses.replace(jstage, quantized=True).generate(
        [jnp.asarray(cond, jnp.int32)], None, max_time_steps=6,
        per_row_keys=jax.vmap(jax.random.PRNGKey)(jnp.arange(2)), approx_topk=False,
        teacher_forced_ids=jnp.asarray(teacher, jnp.int32), return_logits=True)
    want = np.asarray(want)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=1e-2 * np.abs(want).max(where=want > -1e8, initial=0.0))


def _tiny_musiclm(mc) -> tmusiclm.MusicLM:
    stages = {f"{name}_stage": tconfig.init_stage(mc, name, i, device="cpu")
              for i, name in enumerate(("semantic", "coarse", "fine"), 1)}
    codec = tconfig.build_encodec(mc, generator=torch.Generator().manual_seed(4), device="cpu")
    return tmusiclm.MusicLM(codec=codec, **stages)


def test_chunk_env_splits_the_calls(tiny_config, monkeypatch):
    """A small ``$OPEN_MUSICLM_MAX_FINE_ROWS`` splits the batched fine decode
    (2 prompts x 4 windows, 4 rows a call: 2 calls) and a small
    ``$OPEN_MUSICLM_MAX_DECODE_FRAMES`` Encodec's head (300 frames a row, a
    row a call), read at call time as the JAX package reads them; the codes
    and the waves equal the unchunked call's."""
    mc = tconfig.load_model_config(tiny_config)
    lm = _tiny_musiclm(mc)
    calls = {"fine": 0, "head": 0}
    fine_generate, decode_head = lm.fine_stage.generate, lm.codec.decode_head

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    lm.fine_stage.generate = count("fine", fine_generate)
    lm.codec.decode_head = count("head", decode_head)
    codes = []
    decode = lm._decode
    lm._decode = lambda c: codes.append(c) or decode(c)
    clap = torch.as_tensor(np.random.default_rng(5).integers(0, CB, (2, 4)))
    kw = dict(clap_token_ids=clap, per_row_keys=seed_keys([7, 8]), output_seconds=4.0, semantic_window_seconds=2,
              coarse_window_seconds=1, fine_window_seconds=1)
    whole = lm.generate(**kw)
    assert calls == {"fine": 1, "head": 0}
    monkeypatch.setenv("OPEN_MUSICLM_MAX_FINE_ROWS", "4")
    monkeypatch.setenv("OPEN_MUSICLM_MAX_DECODE_FRAMES", "300")
    assert (tmusiclm.max_fine_rows(), tmusiclm.max_decode_frames()) == (4, 300)
    chunked = lm.generate(**kw)
    assert calls == {"fine": 3, "head": 2}
    assert codes[0].shape == (2, 300, 4)
    torch.testing.assert_close(codes[1], codes[0], rtol=0, atol=0)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)
    monkeypatch.delenv("OPEN_MUSICLM_MAX_FINE_ROWS")
    monkeypatch.delenv("OPEN_MUSICLM_MAX_DECODE_FRAMES")
    assert (tmusiclm.max_fine_rows(), tmusiclm.max_decode_frames()) == (256, 36000)


def _dropout_pair(attn_dropout: float):
    """A JAX doll-house stage with FF dropout 0.5 and the port's copy."""
    jmodel = JTCT(specs=(JSpec(CB, 2), JSpec(CB, 3)), dim=32, depth=2, heads=2, dim_head=8, ff_dropout=0.5,
                  attn_dropout=attn_dropout)
    ids = [np.random.default_rng(0).integers(0, CB, (2, 8)), np.random.default_rng(1).integers(0, CB, (2, 9))]
    jids = [jnp.asarray(i, jnp.int32) for i in ids]
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jids)
    model = TokenConditionedTransformer(tuple(TokenSequenceSpec(CB, q) for q in (2, 3)), 32, 2, heads=2, dim_head=8,
                                        ff_dropout=0.5, attn_dropout=attn_dropout)
    model.load_state_dict(stage_state_dict(jax.device_get(jparams), 2, 2))
    return jmodel, jparams, jids, model, [torch.as_tensor(i) for i in ids]


def test_disable_dropout_env(monkeypatch):
    """``$OPEN_MUSICLM_DISABLE_DROPOUT=1``: a train-mode forward with FF
    dropout 0.5 equals the eval-mode forward in both packages and the port's
    equals JAX's; each package warns once for the process."""
    jmodel, jparams, jids, model, tids = _dropout_pair(0.0)
    model.eval()
    with torch.no_grad():
        eval_out = model(tids)
        model.train()
        dropped = model(tids, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(dropped[-1], eval_out[-1])  # unset: dropout draws

    monkeypatch.setenv("OPEN_MUSICLM_DISABLE_DROPOUT", "1")
    monkeypatch.setattr(ttransformer, "_dropout_warned", False)
    monkeypatch.setattr(jtransformer, "_dropout_warned", False)
    with warnings.catch_warnings(record=True) as caught, torch.no_grad():
        warnings.simplefilter("always")
        train_out = [model(tids, generator=torch.Generator().manual_seed(s)) for s in (0, 1)]
        jtrain = jmodel.apply(jparams, jids, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        jeval = jmodel.apply(jparams, jids)
    texts = [str(w.message) for w in caught if "OPEN_MUSICLM_DISABLE_DROPOUT" in str(w.message)]
    assert len(texts) == 2  # one a package
    for got, again, want, j_train, j_eval in zip(train_out[0], train_out[1], eval_out, jtrain, jeval):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(again, want, rtol=0, atol=0)
        np.testing.assert_array_equal(np.asarray(j_train), np.asarray(j_eval))
        np.testing.assert_allclose(got.numpy(), np.asarray(j_train), rtol=1e-4, atol=1e-4)


def test_disable_dropout_env_keeps_attention_probability_dropout(monkeypatch):
    """With attention dropout the knob leaves the attention probabilities'
    dropout drawing in both packages (the JAX package's shared_kv_attention
    draws its own mask, outside ``_dropout``): a train-mode forward still
    differs from the eval-mode one, in JAX and in the port."""
    jmodel, jparams, jids, model, tids = _dropout_pair(0.5)
    monkeypatch.setenv("OPEN_MUSICLM_DISABLE_DROPOUT", "1")
    with warnings.catch_warnings(), torch.no_grad():
        warnings.simplefilter("ignore")
        model.train()
        got = model(tids, generator=torch.Generator().manual_seed(0))[-1]
        model.eval()
        want = model(tids)[-1]
        jtrain = jmodel.apply(jparams, jids, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})[-1]
        jeval = jmodel.apply(jparams, jids)[-1]
    assert not torch.equal(got, want)
    assert not np.array_equal(np.asarray(jtrain), np.asarray(jeval))
