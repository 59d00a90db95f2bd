"""Port parity, the multi-card serving layouts: prompt-parallel serving
(``Stage.generate(mesh=)``, ``MusicLM(serving_mesh=)``) and the stage
pipeline (``MusicLM.to_pipelined``), on the CPU.

Two gloo ranks (tests/torch_dp_workers.py:serving_rank, a ``file://``
store) serve the doll-house MusicLM of tests/test_torch_slice.py (the JAX
package's tiny stages and codec, carried across by convert.py) over
``make_mesh(dp=2)``, two prompts a rank. Every decode mode's rows equal the
port's unsharded run's (which tests/test_torch_decode.py and
test_torch_slice.py hold to JAX); the waves are within atol 1e-5 of the
unsharded port's (tests/test_sharded_generate.py's limit), and greedy codes
equal the JAX package's. The kernels' plain versions run on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu.testing import CB, N_CLAP_Q, TINY_GEN_KW

from open_musiclm_torch.core.sampling import seed_keys
from open_musiclm_torch.models import musiclm as tmusiclm_mod
from open_musiclm_torch.models.stages import Stage
from open_musiclm_torch.parallel.mesh import Mesh

from tests.test_torch_slice import jax_tiny_musiclm, port_codec, port_model
from tests.torch_dp_workers import join_ranks, serving_rank, start_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401

MODES = [(False, None), (True, None), (True, "bf16"), (True, "f32"), (True, "int8"), (True, "fused")]
GREEDY = dict(semantic_temperature=0.0, coarse_temperature=0.0, fine_temperature=0.0)
SAMPLING = dict(semantic_temperature=1.0, coarse_temperature=0.95, fine_temperature=0.7,
                semantic_filter_thres=0.5, coarse_filter_thres=0.5, fine_filter_thres=0.5)
B = 4


def _port_musiclm(jm):
    return tmusiclm_mod.MusicLM(
        codec=port_codec(jm.codec, jm.codec_params),
        **{name: Stage(port_model(st.model, st.params), quantized=True, flash_kv="int8")
           for name, st in (("semantic_stage", jm.semantic_stage), ("coarse_stage", jm.coarse_stage),
                            ("fine_stage", jm.fine_stage))})


def _capture(m, codes):
    """Record the codes reaching Encodec (the last argument of either
    package's ``_decode``)."""
    decode = m._decode

    def wrapped(*args):
        codes.append(args[-1])
        return decode(*args)

    m._decode = wrapped


@pytest.fixture(scope="module")
def pair():
    """The JAX doll-house MusicLM (int8 stages; ~25 s to initialise, so once
    for the module) and the port's, carried across."""
    jm = jax_tiny_musiclm()
    return jm, _port_musiclm(jm)


@pytest.fixture(scope="module")
def served(tmp_path_factory, pair):
    """The two ranks' results, the unsharded port's and JAX's greedy codes."""
    tmp = tmp_path_factory.mktemp("serving")
    jm, musiclm = pair
    jm, musiclm = dataclasses.replace(jm), dataclasses.replace(musiclm)  # _capture patches these
    rng = np.random.default_rng(3)
    clap = torch.from_numpy(rng.integers(0, CB, (B, N_CLAP_Q)).astype(np.int64))
    stage_cond = [clap, torch.from_numpy(rng.integers(0, CB, (B, 9)).astype(np.int64))]
    inputs = dict(musiclm=musiclm, keys=seed_keys(range(40, 40 + B)), clap=clap, modes=MODES,
                  stage_cond=stage_cond, stage_kw=dict(max_time_steps=5, temperature=1.0, filter_thres=0.5),
                  teacher=torch.from_numpy(rng.integers(0, CB, (B, 5, 2)).astype(np.int64)),
                  gen_kw=dict(TINY_GEN_KW, **SAMPLING), greedy=GREEDY)
    torch.save(inputs, tmp / "inputs.pt")
    procs = start_ranks(serving_rank, 2, (str(tmp / "store"), str(tmp)))
    try:
        out = {"inputs": inputs, "stage": {}}
        for quantized, flash_kv in MODES:
            st = dataclasses.replace(musiclm.coarse_stage, quantized=quantized, flash_kv=flash_kv)
            out["stage"][(quantized, flash_kv)] = st.generate(
                stage_cond, per_row_keys=inputs["keys"], teacher_forced_ids=inputs["teacher"],
                return_logits=True, **inputs["stage_kw"])
        out["waves"] = musiclm.generate(clap_token_ids=clap, per_row_keys=inputs["keys"], **inputs["gen_kw"])
        codes = []
        _capture(musiclm, codes)
        out["greedy"] = musiclm.generate(clap_token_ids=clap, per_row_keys=inputs["keys"],
                                         **dict(inputs["gen_kw"], **GREEDY))
        out["codes"] = codes
        jcodes = []
        _capture(jm, jcodes)
        jm.generate(key=jax.random.PRNGKey(0), clap_token_ids=jnp.asarray(clap.numpy().astype(np.int32)),
                    **dict(inputs["gen_kw"], **GREEDY))
        out["jax_codes"] = np.asarray(jcodes[-1])
    finally:
        join_ranks(procs, timeout=180)
    out["ranks"] = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return out


@pytest.mark.parametrize("mode", MODES, ids=[f"{'int8' if q else 'fp'}-{f}" for q, f in MODES])
def test_stage_generate_on_mesh_equals_unsharded(served, mode):
    """Each rank decodes its two rows (teacher-forced, sampling from the
    rows' keys) and gathers all four: the sampled tokens equal to one
    process's, the per-step logits within 1e-6 x max|logit| (the CPU's
    matrix products round a row by the batch's size in some modes)."""
    want, want_logits = served["stage"][mode]
    live = want_logits > -1e8  # EOS, masked
    for rank in served["ranks"]:
        got, got_logits = rank["stage"][mode]
        assert got.shape == want.shape == (B, 5, 2) and torch.equal(got, want)
        assert torch.equal(got_logits > -1e8, live)
        err = (got_logits - want_logits)[live].abs().max().item() / want_logits[live].abs().max().item()
        assert err <= 1e-6, err


def test_stage_generate_on_mesh_refuses_without_keys_or_an_even_split(pair):
    """Both refusals come before any collective (a mesh of two dp ranks
    without a process group is enough to reach them)."""
    stage = pair[1].coarse_stage
    mesh = Mesh(None, 0, 2)
    cond = [torch.zeros((4, N_CLAP_Q), dtype=torch.long), torch.zeros((4, 3), dtype=torch.long)]
    with pytest.raises(ValueError, match="per_row_keys"):
        stage.generate(cond, max_time_steps=2, mesh=mesh)
    odd = [c[:3] for c in cond]
    with pytest.raises(ValueError, match="does not split"):
        stage.generate(odd, max_time_steps=2, mesh=mesh, per_row_keys=seed_keys(range(3)))


def test_musiclm_serving_mesh_waves_equal_unsharded(served):
    """MusicLM(serving_mesh=dp2) with per-row keys, int8 stages: every rank
    gets all four waves, within atol 1e-5 of the unsharded run."""
    want = served["waves"]
    for rank in served["ranks"]:
        assert rank["waves"].shape == want.shape
        np.testing.assert_allclose(rank["waves"].numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_musiclm_serving_mesh_greedy_codes_match_jax(served):
    """Greedy through the whole hierarchy on the mesh: the codes reaching
    Encodec equal the unsharded port's and the JAX package's."""
    want = served["codes"][-1]
    np.testing.assert_array_equal(want.numpy(), served["jax_codes"])
    for rank in served["ranks"]:
        assert torch.equal(rank["codes"][-1], want)
        np.testing.assert_allclose(rank["greedy"].numpy(), served["greedy"].numpy(), atol=1e-5, rtol=0)


def test_to_pipelined_places_each_stage(pair):
    """Over two devices: semantic and fine on the first, coarse and the
    codec on the second (``devices[i % 2]``), each a copy; the original stays
    where it was."""
    m = pair[1]
    pl = m.to_pipelined(["cpu", "meta"])
    cpu, meta = torch.device("cpu"), torch.device("meta")
    assert pl.stage_devices == (cpu, meta, cpu, meta)
    placed = [next(s.model.parameters()).device for s in (pl.semantic_stage, pl.coarse_stage, pl.fine_stage)]
    assert placed == [cpu, meta, cpu] and pl.codec.codebooks.device == meta
    assert pl.semantic_stage.model is m.semantic_stage.model  # already there: not copied
    assert next(m.coarse_stage.model.parameters()).device == cpu and m.codec.codebooks.device == cpu
    assert pl.coarse_stage.quantized and pl.coarse_stage.flash_kv == "int8"


@pytest.mark.parametrize("case", ["generator", "per_row_keys_overlapping_fine"])
def test_to_pipelined_one_device_is_bit_equal(pair, case):
    """One device gives the unpipelined layout: the same waves, bit for bit
    (a generator, several windows; per-row keys with overlapping fine
    windows, as tests/test_pipelined.py runs them)."""
    m = pair[1]
    pl = m.to_pipelined([torch.device("cpu")])
    assert pl.stage_devices == (torch.device("cpu"),) * 4
    clap = torch.from_numpy(np.random.default_rng(8).integers(0, CB, (2, N_CLAP_Q)).astype(np.int64))
    if case == "generator":
        kw = dict(TINY_GEN_KW, output_seconds=4, **SAMPLING)
        w0 = m.generate(clap_token_ids=clap, generator=torch.Generator().manual_seed(7), **kw)
        w1 = pl.generate(clap_token_ids=clap, generator=torch.Generator().manual_seed(7), **kw)
    else:
        kw = dict(TINY_GEN_KW, output_seconds=3, fine_sliding_window_step_percent=0.5, **SAMPLING)
        w0 = m.generate(clap_token_ids=clap, per_row_keys=seed_keys([9, 10]), **kw)
        w1 = pl.generate(clap_token_ids=clap, per_row_keys=seed_keys([9, 10]), **kw)
    assert torch.equal(w0, w1)
