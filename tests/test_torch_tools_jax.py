"""The teacher-forced logits open_musiclm_torch.cli.serving_deviation
scores (``teacher_forced``) against the JAX package's Stage.generate on
doll-house stages of tests/test_torch_load.py's model config, each stage's
JAX weights carried over by open_musiclm_torch.convert: the fp decode and
the "int8" serving stack, float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu import config as jconfig
from open_musiclm_tpu.config import load_model_config as j_load_model_config
from open_musiclm_tpu.models import stages as jstages
from open_musiclm_tpu.models.token_cond import StageLossConfig

from open_musiclm_torch import config as tconfig
from open_musiclm_torch.cli import serving_deviation
from open_musiclm_torch.core.sampling import seed_keys
from open_musiclm_torch.models.stages import Stage

from tests.test_torch_load import tiny_model_config
from tests.test_torch_slice import port_model
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory) -> str:
    return tiny_model_config(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="module")
def stage_pairs(tiny_config):
    """Each doll-house stage in JAX (seeds 1-3; ``init_stage``'s model and
    params, its init under jit) and the port's copy, built once for both
    modes."""
    jmc = j_load_model_config(tiny_config)
    pairs = {}
    for seed, name in enumerate(("semantic", "coarse", "fine"), 1):
        model = getattr(jconfig, f"build_{name}_transformer")(jmc)
        ids = [jnp.zeros((1, n), jnp.int32) for n in jconfig.stage_example_lengths(jmc, name)]
        params = jax.jit(model.init)(jax.random.PRNGKey(seed), ids)
        jstage = jstages.Stage(model, params, StageLossConfig((1.0,) * len(model.specs)), name=name)
        pairs[name] = jstage, port_model(model, params)
    return pairs


@pytest.mark.parametrize("stage_name", ["semantic", "coarse", "fine"])
@pytest.mark.parametrize("mode", ["fp", "int8"])
def test_teacher_forced_logits_equal_jax(tiny_config, stage_pairs, stage_name, mode):
    """The per-step logits the tool scores (``teacher_forced`` along the fp
    tokens, per-row keys, each stage's temperature) equal JAX's
    Stage.generate(teacher_forced_ids=, return_logits=True) on the same
    doll-house stage, float32: within 1e-4 x max|logit| (fp) and 1e-2 x max
    ("int8": int8 weights and cache rows)."""
    jstage, model = stage_pairs[stage_name]
    mc = tconfig.load_model_config(tiny_config)
    lens, T, temp = serving_deviation.geometry(mc, step_fraction=0.2)[stage_name]
    B = 3
    rng = np.random.default_rng(len(stage_name))
    cond = [rng.integers(0, spec.codebook_size, (B, n)) for spec, n in zip(model.specs, lens)]
    keys = seed_keys(range(B))
    fp = Stage(model, quantized=False, flash_kv=None)
    ref = fp.generate([torch.as_tensor(c) for c in cond], None, max_time_steps=T, per_row_keys=keys,
                      temperature=temp)
    quantized = mode == "int8"
    stage = Stage(model, quantized=quantized, flash_kv="int8" if quantized else None)
    _, logits = serving_deviation.teacher_forced(stage, [torch.as_tensor(c) for c in cond], ref, T, keys, temp,
                                                 return_logits=True)
    jstage = dataclasses.replace(jstage, quantized=quantized, flash_kv="int8" if quantized else None)
    _, want = jstage.generate([jnp.asarray(c, jnp.int32) for c in cond], None, max_time_steps=T,
                              per_row_keys=jax.vmap(jax.random.PRNGKey)(jnp.arange(B)), temperature=temp,
                              approx_topk=False, teacher_forced_ids=jnp.asarray(ref.numpy(), jnp.int32),
                              return_logits=True)
    want = np.asarray(want, np.float32)
    assert logits.shape == want.shape == (B, T * ref.shape[-1], want.shape[-1])
    tol = (1e-2 if quantized else 1e-4) * np.abs(want).max(where=want > -1e8, initial=0.0)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=tol)
