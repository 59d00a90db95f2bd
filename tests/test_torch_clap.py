"""Port parity, conditioning: the text path of open_musiclm_torch (BPE
tokenizer, RoBERTa tower, CLAP text projection, RVQ, ClapQuantized) against
the JAX package on the CPU in float32, with the weights carried over by
open_musiclm_torch.convert; and the slice as a whole, text prompts through
MusicLM.generate to waveforms, against the JAX package's doll-house
MusicLM.

The JAX CLAP is initialised through ``CLAP.get_text_embedding`` only, which
leaves its audio tower (a minute to initialise) out.
"""

import dataclasses
import inspect
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu.models.clap.clap import CLAP as JCLAP
from open_musiclm_tpu.models.clap.clap import ClapQuantized as JClapQuantized
from open_musiclm_tpu.models.clap.roberta import RobertaModel as JRoberta
from open_musiclm_tpu.models.clap.tokenizer import RobertaTokenizer as JRobertaTokenizer
from open_musiclm_tpu.models.clap.tokenizer import bytes_to_unicode
from open_musiclm_tpu.models.rvq import rvq_decode as j_rvq_decode
from open_musiclm_tpu.models.rvq import rvq_encode as j_rvq_encode
from open_musiclm_tpu.models.rvq import rvq_init as j_rvq_init
from open_musiclm_tpu.models.rvq import rvq_quantize as j_rvq_quantize
from open_musiclm_tpu.testing import CB, N_CLAP_Q, TINY_AUDIO, TINY_GEN_KW, TINY_TEXT, FakeTokenizer

from open_musiclm_torch.convert import clap_text_state_dict, roberta_state_dict, rvq_state
from open_musiclm_torch.core.sampling import seed_keys
from open_musiclm_torch.models.clap.clap import CLAP, ClapQuantized
from open_musiclm_torch.models.clap.roberta import RobertaConfig, RobertaModel
from open_musiclm_torch.models.clap.tokenizer import RobertaTokenizer, load_tokenizer
from open_musiclm_torch.models.musiclm import MusicLM
from open_musiclm_torch.models.rvq import rvq_decode, rvq_encode, rvq_quantize
from open_musiclm_torch.models.stages import Stage

from tests.test_torch_slice import _close, _t, jax_tiny_musiclm, port_codec, port_model
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
TEXT_CFG = RobertaConfig(**dataclasses.asdict(TINY_TEXT))

# merges over the byte symbols of bytes_to_unicode ("Ġ" is the space byte);
# "Ġq u" merges into a piece the vocab lacks, which both tokenizers drop
MERGES = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("Ġ", "a"), ("1", "2"),
          ("Ġ", "q"), ("Ġq", "u"), ("e", "r"), ("Ġ", "Ġ"), ("'", "s"), ("!", "!")]
TEXTS = [
    "the theme in the air",
    "It's 120 bpm, 4/4 -- drums & bass!!! (live)",
    "runs   of    spaces\tand\nnewlines  ",
    "café ñandú — ♪ 日本 🎵",
    "quick quack: 12 123 1234 0.5",
    "",
    " ".join(f"word{i}" for i in range(60)),  # > 77 tokens: truncated
]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    """A byte-level demo vocabulary: the special ids, the 256 byte symbols,
    and every merge result but one."""
    d = tmp_path_factory.mktemp("tok")
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in sorted(set(bytes_to_unicode().values())):
        vocab[c] = len(vocab)
    for a, b in MERGES:
        if a + b != "Ġqu":
            vocab[a + b] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: demo\n" + "".join(f"{a} {b}\n" for a, b in MERGES))
    return d


@pytest.mark.parametrize("max_length", [77, 12])
@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_tokenizer_matches_jax(vocab_dir, text, max_length):
    """ids and masks equal to the JAX tokenizer's: punctuation, digits, runs
    of spaces, non-ASCII bytes, the empty prompt and truncation."""
    want = JRobertaTokenizer.from_dir(str(vocab_dir))([text, "the"], max_length=max_length)
    got = load_tokenizer(str(vocab_dir))([text, "the"], max_length=max_length)
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])
    assert got["input_ids"].shape == (2, max_length)
    if text:
        assert got["attention_mask"][0].sum() > 2  # the prompt's pieces are there


def test_tokenizer_merges_and_drops(vocab_dir):
    """The merges apply by rank, and a merged piece outside the vocab is
    dropped (as the JAX tokenizer does)."""
    tok = RobertaTokenizer.from_dir(str(vocab_dir))
    vocab = tok.bpe.vocab
    ids = tok([" the qu"])["input_ids"][0]
    assert list(ids[:3]) == [0, vocab["Ġthe"], 2]  # "Ġqu" is not in the vocab
    ids = tok(["the"])["input_ids"][0]
    assert list(ids[:4]) == [0, vocab["t"], vocab["he"], 2]


def _roberta_pair(seed=0):
    jmodel = JRoberta(cfg=TINY_TEXT)
    ids = jnp.zeros((1, 8), jnp.int32)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), ids, jnp.ones_like(ids))
    model = RobertaModel(TEXT_CFG)
    model.load_state_dict(roberta_state_dict(jax.device_get(jparams)))
    return jmodel, jparams, model.eval()


def _text_batch(seed, b=3, T=10):
    """Random ids with a padded row and a one-token row past <s>."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, TINY_TEXT.vocab_size, (b, T)).astype(np.int32)
    mask = np.ones((b, T), np.int32)
    mask[1, 6:] = 0
    mask[2, 2:] = 0
    ids[mask == 0] = TINY_TEXT.pad_token_id
    return ids, mask


def test_roberta_matches_jax():
    jmodel, jparams, model = _roberta_pair()
    ids, mask = _text_batch(0)
    want = jax.jit(jmodel.apply)(jparams, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = model(_t(ids), _t(mask))
    for key in ("last_hidden_state", "pooler_output"):
        _close(got[key], want[key], **TOL)


def test_roberta_state_dict_is_hf_layout():
    """Every key of the port's state_dict has a counterpart in the JAX
    importer's map from the Hugging Face layout (import_torch.import_roberta)."""
    from open_musiclm_tpu.import_torch import import_roberta

    _, jparams, model = _roberta_pair(1)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = import_roberta(sd, TINY_TEXT)["params"]
    flat = jax.tree_util.tree_leaves_with_path(jax.device_get(jparams)["params"])
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(back_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(back_flat[path]), np.asarray(leaf))


def test_roberta_bf16_compute_runs():
    """The bf16 compute dtype (the JAX bench's long lane runs the tower so)
    stays near the float32 tower."""
    _, _, model = _roberta_pair(2)
    ids, mask = _text_batch(2)
    with torch.no_grad():
        want = model(_t(ids), _t(mask))["pooler_output"]
        model.compute_dtype = torch.bfloat16
        got = model(_t(ids), _t(mask))["pooler_output"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=5e-2)


def _clap_pair(seed=1, joint=16):
    jmodel = JCLAP(audio_cfg=TINY_AUDIO, text_cfg=TINY_TEXT, joint_embed_shape=joint)
    ids = jnp.zeros((1, 8), jnp.int32)
    jparams = jax.jit(lambda k, i, m: jmodel.init(k, i, m, method=JCLAP.get_text_embedding))(
        jax.random.PRNGKey(seed), ids, jnp.ones_like(ids))
    model = CLAP(TEXT_CFG, joint_embed_shape=joint)
    missing, unexpected = model.load_state_dict(
        clap_text_state_dict(jax.device_get(jparams)), strict=False)
    assert not unexpected and all(k.startswith("text_transform.") for k in missing)
    return jmodel, jparams, model.eval()


def test_text_embedding_matches_jax():
    jmodel, jparams, model = _clap_pair()
    ids, mask = _text_batch(3)
    want = jax.jit(lambda p, i, m: jmodel.apply(p, i, m, method=JCLAP.get_text_embedding))(
        jparams, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = model.get_text_embedding(_t(ids), _t(mask))
    _close(got, want, **TOL)
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, atol=1e-6)


def test_rvq_matches_jax():
    jstate = j_rvq_init(6, 64, 32, jax.random.PRNGKey(3))
    state = rvq_state(jax.device_get(jstate))
    x = np.random.default_rng(4).standard_normal((40, 32)).astype(np.float32)
    want_idx = np.asarray(j_rvq_encode(jstate, jnp.asarray(x)))
    idx = rvq_encode(state, _t(x))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    _close(rvq_decode(state, idx), j_rvq_decode(jstate, jnp.asarray(want_idx)), atol=1e-6, rtol=1e-6)
    quant, qidx = rvq_quantize(state, _t(x))
    want_quant, _ = j_rvq_quantize(jstate, jnp.asarray(x))
    np.testing.assert_array_equal(qidx.numpy(), want_idx)
    _close(quant, want_quant, atol=1e-6, rtol=1e-6)


def test_rvq_first_index_wins_ties():
    """Two equal codes: the first index wins, as jnp.argmax picks it."""
    cb = torch.tensor([[[0.0, 1.0], [1.0, 0.0], [1.0, 0.0]]])
    from open_musiclm_torch.models.rvq import RVQState

    assert rvq_encode(RVQState(cb), torch.tensor([[2.0, 0.0]])).tolist() == [[1]]


def _nearest_margins(codebooks, x, q_stop):
    """The JAX nearest-code rule's margin (best less second score) at each
    quantizer up to ``q_stop``, in float64 on the JAX residuals."""
    resid, margins = np.asarray(x, np.float64), []
    for q in range(q_stop + 1):
        cb = np.asarray(codebooks[q], np.float64)
        score = 2.0 * resid @ cb.T - (cb * cb).sum(-1)[None]
        top = np.sort(score, axis=-1)[:, -2:]
        margins.append(top[:, 1] - top[:, 0])
        resid = resid - cb[score.argmax(-1)]
    return margins


def test_tokenize_text_matches_jax():
    """Equal tokens; where a row's tokens differ, the JAX nearest-code margin
    at its first differing quantizer must be a near tie (< 1e-5)."""
    jmodel, jparams, model = _clap_pair(5, joint=16)
    jstate = j_rvq_init(N_CLAP_Q, CB, 16, jax.random.PRNGKey(6))
    jclap = JClapQuantized(model=jmodel, params=jparams, rvq=jstate, num_quantizers=N_CLAP_Q, codebook_size=CB)
    clap = ClapQuantized(model=model, rvq=rvq_state(jax.device_get(jstate)), num_quantizers=N_CLAP_Q,
                         codebook_size=CB)
    ids, mask = _text_batch(6, b=8)
    want = np.asarray(jclap.tokenize_text(jnp.asarray(ids), jnp.asarray(mask)))
    got = clap.tokenize_text(ids, mask)
    assert got.shape == want.shape == (8, N_CLAP_Q, 1)
    emb = np.asarray(jclap.text_embedding(jnp.asarray(ids), jnp.asarray(mask)))
    for row in np.nonzero((got.numpy() != want).any(axis=(1, 2)))[0]:
        q = int(np.nonzero(got.numpy()[row, :, 0] != want[row, :, 0])[0][0])
        margin = _nearest_margins(jstate.codebooks, emb[row:row + 1], q)[q][0]
        assert margin < 1e-5, f"row {row} quantizer {q}: tokens differ at margin {margin}"


def jax_tiny_text_musiclm(**mode):
    """jax_tiny_musiclm's stages and codec with open_musiclm_tpu.testing's
    tiny CLAP (text branch only), RVQ and FakeTokenizer."""
    jm = jax_tiny_musiclm(**mode)
    jmodel = JCLAP(audio_cfg=TINY_AUDIO, text_cfg=TINY_TEXT, joint_embed_shape=16)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.jit(lambda k, i, m: jmodel.init(k, i, m, method=JCLAP.get_text_embedding))(
        jax.random.PRNGKey(1), ids, jnp.ones_like(ids))
    clap = JClapQuantized(model=jmodel, params=params, rvq=j_rvq_init(N_CLAP_Q, CB, 16, jax.random.PRNGKey(2)),
                          num_quantizers=N_CLAP_Q, codebook_size=CB)
    return dataclasses.replace(jm, clap=clap, tokenizer=FakeTokenizer())


def port_musiclm(jm, **mode) -> MusicLM:
    """The port's MusicLM carrying the JAX doll-house's weights and its
    tokenizer object."""
    clap_model = CLAP(TEXT_CFG, joint_embed_shape=16)
    clap_model.load_state_dict(clap_text_state_dict(jax.device_get(jm.clap.params)), strict=False)
    clap = ClapQuantized(model=clap_model.eval(), rvq=rvq_state(jax.device_get(jm.clap.rvq)),
                         num_quantizers=N_CLAP_Q, codebook_size=CB)
    return MusicLM(
        codec=port_codec(jm.codec, jm.codec_params), clap=clap, tokenizer=jm.tokenizer,
        **{name: Stage(port_model(st.model, st.params), **mode)
           for name, st in (("semantic_stage", jm.semantic_stage), ("coarse_stage", jm.coarse_stage),
                            ("fine_stage", jm.fine_stage))},
    )


GREEDY = dict(semantic_temperature=0.0, coarse_temperature=0.0, fine_temperature=0.0)


def test_text_to_wave_matches_jax():
    """The slice: text prompts through MusicLM.generate, greedy, int8
    serving stages: clap_tokens_from_text equal, codes equal and the
    waveform within 1e-4 of JAX; per_row_keys at temperature 0 give the
    same greedy codes."""
    mode = dict(quantized=True, flash_kv="int8")
    jm = jax_tiny_text_musiclm(**mode)
    tm = port_musiclm(jm, **mode)
    texts = ["warm synth chords", "drum loop"]
    np.testing.assert_array_equal(tm.clap_tokens_from_text(texts).numpy(),
                                  np.asarray(jm.clap_tokens_from_text(texts)))

    codes = {}

    def capture(name, decode):
        def wrapped(*args):
            codes.setdefault(name, []).append(np.asarray(args[-1]))
            return decode(*args)
        return wrapped

    jm._decode = capture("jax", jm._decode)
    tm._decode = capture("torch", tm._decode)
    want = jm.generate(key=jax.random.PRNGKey(0), text=texts, **GREEDY, **TINY_GEN_KW)
    got = tm.generate(text=texts, **GREEDY, **TINY_GEN_KW)
    keyed = tm.generate(text=texts, per_row_keys=seed_keys([7, 8]), **GREEDY, **TINY_GEN_KW)
    assert codes["jax"][0].shape == codes["torch"][0].shape == (2, 45, 4)
    np.testing.assert_array_equal(codes["torch"][0], codes["jax"][0])
    np.testing.assert_array_equal(codes["torch"][1], codes["jax"][0])
    assert got.shape == want.shape == keyed.shape
    _close(got, want)


def test_generate_needs_text_or_tokens():
    mode = dict(quantized=True, flash_kv="int8")
    tm = port_musiclm(jax_tiny_text_musiclm(**mode), **mode)
    with pytest.raises(ValueError):
        tm.generate(**TINY_GEN_KW)
    tm.tokenizer = None
    with pytest.raises(ValueError):
        tm.clap_tokens_from_text(["a"])


def test_build_clap(monkeypatch):
    """build_clap: the configured RVQ over the 512-d joint space, seeded, on
    the device asked for; the card by default, refused without one."""
    from open_musiclm_torch import config as tconfig

    mc = tconfig.load_model_config(str(Path(__file__).resolve().parents[1] / "configs/model/musiclm_small.json"))
    monkeypatch.setattr(tconfig, "RobertaConfig", lambda: TEXT_CFG)  # the tiny tower on this CPU
    clap = tconfig.build_clap(mc, torch.Generator().manual_seed(0), device="cpu")
    again = tconfig.build_clap(mc, torch.Generator().manual_seed(0), device="cpu")
    assert clap.rvq.codebooks.shape == (mc.clap_rvq_cfg.rq_num_quantizers, mc.clap_rvq_cfg.codebook_size, 512)
    assert clap.num_quantizers == 12 and not clap.model.training
    torch.testing.assert_close(clap.rvq.codebooks, again.rvq.codebooks, atol=0, rtol=0)
    ids, mask = _text_batch(7)
    toks = clap.tokenize_text(ids, mask)
    assert toks.shape == (3, 12, 1) and toks.dtype == torch.long
    torch.testing.assert_close(toks, again.tokenize_text(ids, mask), atol=0, rtol=0)
    assert inspect.signature(tconfig.build_clap).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconfig.build_clap(mc)


def test_unported_clap_paths_raise():
    """The CLAP paths that refuse: an audio preset name the reference does
    not ship raises KeyError (every shipped one resolves, the PANN and HTSAT
    presets are held to JAX in tests/test_torch_clap_options.py); a CLAP
    built without an audio tower refuses audio; the RVQ's EMA training
    (ported, held to JAX in tests/test_torch_tokenizer_trainers.py) refuses a
    first batch of fewer embeddings than codes. (The fusion CLAP is held to
    JAX in tests/test_torch_fusion.py.)"""
    from open_musiclm_torch.models.clap.model_configs import audio_config_from_name

    _, _, model = _clap_pair()
    clap = ClapQuantized(model=model, rvq=rvq_state(j_rvq_init(N_CLAP_Q, CB, 16, jax.random.PRNGKey(0))))
    assert audio_config_from_name("HTSAT-base").embed_dim == 128
    with pytest.raises(KeyError, match="unknown CLAP audio preset"):
        audio_config_from_name("PANN-22")
    with pytest.raises(ValueError, match="audio tower"):
        clap.audio_embedding(torch.zeros(1, 8))
    with pytest.raises(ValueError, match="at least codebook_size"):
        clap.learn_rvq_step(torch.zeros(CB - 1, 16))


def test_text_path_imports_no_jax():
    """The conditioning modules (the CLAP options and the profiling hooks
    too) and the server import with jax, flax and the JAX package blocked."""
    blocked = ("jax", "jaxlib", "flax", "optax", "orbax", "open_musiclm_tpu")
    code = (
        "import sys\n"
        f"for name in {blocked!r}: sys.modules[name] = None\n"
        "import open_musiclm_torch.serve, open_musiclm_torch.convert, open_musiclm_torch.models.rvq\n"
        "import open_musiclm_torch.models.clap.clap, open_musiclm_torch.models.clap.tokenizer\n"
        "import open_musiclm_torch.models.clap.pann, open_musiclm_torch.models.clap.clip_text\n"
        "import open_musiclm_torch.models.clap.clip_tokenizer, open_musiclm_torch.models.clap.hook\n"
        "import open_musiclm_torch.model_types, open_musiclm_torch.profiling\n"
        f"assert not any(sys.modules.get(n) for n in {blocked!r})\n"
    )
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
