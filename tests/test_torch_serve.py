"""The port's serving layer and per-row sampling keys, on the CPU.

GenerationServer (open_musiclm_torch/serve.py) on a doll-house MusicLM of
the port, with its tiny CLAP text tower, RVQ and a stand-in tokenizer: the
cases of tests/test_serve.py. The scheduling cases use a stand-in model
whose generate sleeps. Then the per-row keys of open_musiclm_torch.core.sampling
in every decode mode: a row's tokens depend on its own key only, other
seeds and other folds give other tokens; the hash matches a pure-Python
reference bit for bit and its uniforms pass a chi-square test.
"""

import threading
import time

import numpy as np
import pytest
import torch

from open_musiclm_torch.core import sampling
from open_musiclm_torch.core.sampling import fold_in_rows, row_uniforms, seed_keys, split_row_keys
from open_musiclm_torch.models.clap.clap import CLAP, ClapQuantized
from open_musiclm_torch.models.clap.roberta import RobertaConfig
from open_musiclm_torch.models.encodec import EncodecModel
from open_musiclm_torch.models.musiclm import MusicLM
from open_musiclm_torch.models.rvq import rvq_init
from open_musiclm_torch.models.stages import (
    Stage,
    create_coarse_transformer,
    create_fine_transformer,
    create_semantic_transformer,
)
from open_musiclm_torch.serve import GenerationServer

from tests.torch_threads import one_torch_thread  # noqa: F401

CB, N_CLAP_Q = 16, 4
TEXT = RobertaConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=64, max_position_embeddings=32)
# open_musiclm_tpu.testing.TINY_GEN_KW: two semantic windows, six coarse
# windows, three batched fine windows
GEN_KW = dict(output_seconds=3, semantic_window_seconds=2, coarse_window_seconds=1,
              fine_window_seconds=1, semantic_steps_per_second=10, acoustic_steps_per_second=15)
# the tiny vocab (17) needs a loose top-k threshold to leave more than one
# candidate: at 0.9, k = max(int(0.1 * 17), 1) = 1 and sampling is argmax
SAMPLING_KW = dict(semantic_filter_thres=0.5, coarse_filter_thres=0.5, fine_filter_thres=0.5)
MODES = [dict(quantized=False), dict(quantized=True, flash_kv=None), dict(quantized=True, flash_kv="bf16"),
         dict(quantized=True, flash_kv="f32"), dict(quantized=True, flash_kv="int8"),
         dict(quantized=True, flash_kv="fused")]
MODE_IDS = ["fp", "None", "bf16", "f32", "int8", "fused"]


class ByteTokenizer:
    """Stand-in for the BPE tokenizer: <s>, one id a byte, </s>, padded."""

    def __call__(self, texts, max_length=8):
        ids = np.ones((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            row = [0] + [4 + b % 60 for b in t.encode()][: max_length - 2] + [2]
            ids[i, :len(row)], mask[i, :len(row)] = row, 1
        return {"input_ids": ids, "attention_mask": mask}


def tiny_stage(factory, seed, mode, **kw):
    model = factory(dim=32, depth=1, heads=2, dim_head=8, clap_codebook_size=CB, num_clap_quantizers=N_CLAP_Q,
                    generator=torch.Generator().manual_seed(seed), **kw)
    return Stage(model.eval(), **mode)


def tiny_musiclm(mode=None) -> MusicLM:
    """A doll-house MusicLM of the port with seeded weights (the JAX
    package's testing.tiny_musiclm geometry)."""
    mode = mode or dict(quantized=True, flash_kv="int8")
    g = torch.Generator().manual_seed(1)
    clap = ClapQuantized(model=CLAP(TEXT, joint_embed_shape=16, generator=g).eval(),
                         rvq=rvq_init(N_CLAP_Q, CB, 16, g), num_quantizers=N_CLAP_Q, codebook_size=CB)
    acoustic = dict(acoustic_codebook_size=CB, num_coarse_quantizers=2)
    return MusicLM(
        codec=EncodecModel(sample_rate=60, ratios=(2, 2), num_quantizers=4, codebook_size=CB, dimension=8,
                           n_filters=2, generator=torch.Generator().manual_seed(3)).eval(),
        semantic_stage=tiny_stage(create_semantic_transformer, 4, mode, semantic_codebook_size=CB),
        coarse_stage=tiny_stage(create_coarse_transformer, 5, mode, semantic_codebook_size=CB, **acoustic),
        fine_stage=tiny_stage(create_fine_transformer, 6, mode, num_fine_quantizers=2, **acoustic),
        clap=clap, tokenizer=ByteTokenizer(),
    )


@pytest.fixture(scope="module")
def musiclm():
    return tiny_musiclm()


class _SlowFakeMusicLM:
    """Stand-in whose generate sleeps: the scheduling (admission, worker
    overlap, lifecycle) apart from any model."""

    def __init__(self, gen_seconds: float):
        self.gen_seconds = gen_seconds
        self.calls = []  # (dispatch time, batch size)
        self._lock = threading.Lock()

    def clap_tokens_from_text(self, texts):
        return torch.zeros((len(texts), 3, 1), dtype=torch.long)

    def generate(self, per_row_keys=None, clap_token_ids=None, **kw):
        with self._lock:
            self.calls.append((time.monotonic(), int(clap_token_ids.shape[0])))
        time.sleep(self.gen_seconds)
        return torch.zeros((clap_token_ids.shape[0], 8))


def test_server_batches_concurrent_requests(musiclm):
    server = GenerationServer(musiclm, batch_size=4, batch_timeout_s=0.2, **GEN_KW).start()
    try:
        futs = [server.submit(f"prompt {i}", seed=i) for i in range(6)]
        waves = [f.result(timeout=600) for f in futs]
    finally:
        server.stop()
    assert len(waves) == 6
    for w in waves:
        assert isinstance(w, np.ndarray) and w.ndim == 1 and np.isfinite(w).all()


def test_server_blocking_api(musiclm):
    server = GenerationServer(musiclm, batch_size=2, **GEN_KW).start()
    try:
        waves = server.generate_blocking(["a", "b"])
    finally:
        server.stop()
    assert len(waves) == 2


def test_identical_prompts_in_one_batch_differ_by_seed(musiclm):
    """Two identical prompts with different seeds in one batch give
    different audio (per-request keys, not one key a batch)."""
    server = GenerationServer(musiclm, batch_size=2, batch_timeout_s=1.0, **GEN_KW, **SAMPLING_KW).start()
    try:
        f1 = server.submit("same prompt", seed=1)
        f2 = server.submit("same prompt", seed=2)
        w1, w2 = f1.result(timeout=600), f2.result(timeout=600)
    finally:
        server.stop()
    assert w1.shape == w2.shape
    assert not np.array_equal(w1, w2)


def test_request_output_independent_of_batch_composition(musiclm):
    """The same (prompt, seed) gives the same codes beside request B or
    request C, in either slot, and the same audio within 1e-6: torch's CPU
    transposed convolution rounds a row by its slot (an ulp, 1.2e-7 seen
    here), where the card's is held to bit-equal rows by chip_smoke.py."""
    codes = []
    decode = musiclm._decode

    def spy(c):
        codes.append(c.clone())
        return decode(c)

    def run(pairs):
        server = GenerationServer(musiclm, batch_size=2, batch_timeout_s=1.0, **GEN_KW, **SAMPLING_KW).start()
        try:
            futs = [server.submit(t, seed=s) for t, s in pairs]
            return [f.result(timeout=600) for f in futs]
        finally:
            server.stop()

    musiclm._decode = spy
    try:
        a1, _ = run([("target", 5), ("other", 6)])
        _, a2 = run([("another", 9), ("target", 5)])
    finally:
        del musiclm._decode
    torch.testing.assert_close(codes[0][0], codes[1][1], atol=0, rtol=0)
    assert not torch.equal(codes[0][1], codes[1][0])
    np.testing.assert_allclose(a1, a2, atol=1e-6, rtol=0)


def test_batch_buckets_low_load_and_result_consistency(musiclm):
    """With buckets [1, 2] a lone request runs at batch 1, and its audio
    equals what it gets inside a full batch (on the card too, bit for bit:
    chip_smoke.py phase 5)."""
    server = GenerationServer(musiclm, batch_size=2, batch_buckets=[1, 2], batch_timeout_s=0.2,
                              **GEN_KW, **SAMPLING_KW).start()
    calls = []
    generate = musiclm.generate

    def spy(**kw):
        calls.append(int(kw["clap_token_ids"].shape[0]))
        return generate(**kw)

    musiclm.generate = spy
    try:
        solo = server.submit("bucket prompt", seed=3).result(timeout=600)
        f1 = server.submit("bucket prompt", seed=3)
        f2 = server.submit("other", seed=4)
        paired = f1.result(timeout=600)
        f2.result(timeout=600)
    finally:
        server.stop()
        del musiclm.generate
    assert calls == [1, 2]
    # equal tokens; the waveform may drift by an ulp, as the Encodec convs
    # reduce in an order that depends on the batch size
    np.testing.assert_allclose(solo, paired, atol=1e-6)


def test_stop_cancels_queued_futures():
    """Requests still queued when the server stops are cancelled, not left
    pending."""
    fake = _SlowFakeMusicLM(gen_seconds=0.5)
    server = GenerationServer(fake, batch_size=1, batch_timeout_s=0.01, num_workers=1).start()
    futs = [server.submit(f"p{i}", seed=i) for i in range(6)]
    time.sleep(0.1)  # the worker picks up the first batch
    server.stop()
    assert all(f.done() for f in futs)
    resolved = sum(1 for f in futs if not f.cancelled())
    cancelled = sum(1 for f in futs if f.cancelled())
    assert resolved >= 1 and cancelled >= 1
    assert resolved + cancelled == 6


def test_late_request_overlaps_inflight_batch():
    """A request that arrives just after a batch dispatches is dispatched
    by the second worker while that batch still runs."""
    fake = _SlowFakeMusicLM(gen_seconds=1.2)
    server = GenerationServer(fake, batch_size=4, batch_buckets=[1, 4], batch_timeout_s=0.05,
                              num_workers=2).start()
    try:
        inflight = server.submit("inflight", seed=0)
        time.sleep(0.3)  # now inside the first generate
        t_submit = time.monotonic()
        late = server.submit("late", seed=99)
        late.result(timeout=20)
        late_latency = time.monotonic() - t_submit
        inflight.result(timeout=20)
    finally:
        server.stop()
    assert len(fake.calls) == 2
    (t_first, _), (t_late, _) = sorted(fake.calls)
    # dispatched with ~0.9 s of the first batch still to run, not after it
    assert t_late - t_first < 0.9, "the late batch waited for the one in flight"
    assert late_latency < 2.0  # its own generate, not the rest of the first one's too


def test_staggered_small_requests_median_latency():
    """Lone requests one after another: the median latency stays well under
    a full batch's wall, each running at bucket 1 at once."""
    full_batch_wall = 2.0  # what a b4 batch takes on the stand-in
    fake = _SlowFakeMusicLM(gen_seconds=0.3)
    server = GenerationServer(fake, batch_size=4, batch_buckets=[1, 4], batch_timeout_s=0.02,
                              num_workers=2).start()
    lat = []
    try:
        for i in range(6):
            t0 = time.monotonic()
            server.submit(f"s{i}", seed=i).result(timeout=20)
            lat.append(time.monotonic() - t0)
            time.sleep(0.05)
    finally:
        server.stop()
    assert float(np.median(lat)) < 0.5 * full_batch_wall, lat
    assert all(b == 1 for _, b in fake.calls)


# ---------------------------------------------------------------------------
# per-row keys
# ---------------------------------------------------------------------------

M32 = 2 ** 32 - 1


def ref_mix32(x: int) -> int:
    """The hash in Python ints, written from its definition."""
    x ^= x >> 16
    x = (x * 0x21F0AAAD) % 2 ** 32
    x ^= x >> 15
    x = (x * 0x735A2D97) % 2 ** 32
    return x ^ (x >> 15)


def ref_seed_key(seed: int) -> int:
    s = seed % 2 ** 64
    return ref_mix32(ref_mix32((s % 2 ** 32) ^ 0x6A09E667) ^ (s >> 32) ^ 0xBB67AE85)


def ref_fold(key: int, d: int) -> int:
    return ref_mix32(key ^ ref_mix32(d ^ 0x3C6EF372))


def ref_split(key: int):
    return ref_mix32(key ^ 0xA54FF53A), ref_mix32(key ^ 0x510E527F)


def ref_uniform(key: int, j: int) -> float:
    m = ref_mix32(key ^ ((j * 0x9E3779B1) % 2 ** 32)) >> 9
    return (m + 0.5) / 2 ** 23


SEEDS = [0, 1, 7, 2 ** 31, 2 ** 32 - 1, 2 ** 40 + 3, -1, -(2 ** 63)]


def test_hash_matches_python_reference():
    """Keys, folds, splits and uniforms bit for bit against Python ints."""
    keys = seed_keys(SEEDS)
    assert keys.dtype == torch.int64
    assert keys.tolist() == [ref_seed_key(s) for s in SEEDS]
    folded = fold_in_rows(keys, 2, M32, 0)
    want = []
    for k in keys.tolist():
        for d in (2, M32, 0):
            k = ref_fold(k, d)
        want.append(k)
    assert folded.tolist() == want
    sub, carry = split_row_keys(folded)
    assert list(zip(sub.tolist(), carry.tolist())) == [ref_split(k) for k in want]
    u = row_uniforms(sub, 1025)
    assert u.dtype == torch.float32
    for i, k in enumerate(sub.tolist()):
        assert u[i].tolist() == [ref_uniform(k, j) for j in range(1025)]
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    assert sampling.mix32(0xDEADBEEF) == ref_mix32(0xDEADBEEF)


def test_fold_in_rows_rejects_out_of_range_data():
    with pytest.raises(ValueError):
        fold_in_rows(seed_keys([0]), -1)
    with pytest.raises(ValueError):
        fold_in_rows(seed_keys([0]), 2 ** 32)


@pytest.mark.parametrize("n_keys", [1, 64])
def test_uniforms_chi_square(n_keys):
    """64 equal bins of 2**16 uniforms (one key's row, or 64 keys' rows):
    the chi-square statistic (63 degrees of freedom) stays below its 0.001
    critical value, 103.4; the keys' rows are not correlated."""
    keys = seed_keys(range(100, 100 + n_keys))
    u = row_uniforms(keys, 2 ** 16 // n_keys)
    counts = torch.bincount((u.reshape(-1) * 64).long(), minlength=64).double()
    expected = u.numel() / 64
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 103.4, chi2
    if n_keys > 1:
        corr = np.corrcoef(u.numpy())[np.triu_indices(n_keys, 1)]
        assert np.abs(corr).max() < 0.2


def _stage_tokens(stage, cond, keys, **kw):
    return stage.generate([cond], max_time_steps=6, temperature=1.0, filter_thres=0.5, per_row_keys=keys, **kw)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_row_tokens_depend_on_own_key_only(mode):
    """A row's tokens are the same alone, beside other rows and in another
    slot; other seeds, and the same seeds with other data folded in, give
    other tokens; the generator is ignored."""
    stage = tiny_stage(create_semantic_transformer, 7, mode, semantic_codebook_size=CB)
    cond = torch.randint(0, CB, (4, N_CLAP_Q), generator=torch.Generator().manual_seed(8))
    keys = seed_keys([11, 12, 13, 14])
    full = _stage_tokens(stage, cond, keys)
    assert full.shape == (4, 6, 1)
    alone = _stage_tokens(stage, cond[2:3], keys[2:3], generator=torch.Generator().manual_seed(99))
    torch.testing.assert_close(alone, full[2:3], atol=0, rtol=0)
    perm = torch.tensor([3, 1, 0, 2])
    swapped = _stage_tokens(stage, cond[perm], keys[perm])
    torch.testing.assert_close(swapped, full[perm], atol=0, rtol=0)
    same_cond = cond[:1].repeat(4, 1)
    by_seed = _stage_tokens(stage, same_cond, seed_keys([1, 2, 3, 4]))
    assert len({tuple(r.reshape(-1).tolist()) for r in by_seed}) > 1
    folded = [_stage_tokens(stage, same_cond, fold_in_rows(seed_keys([1] * 4), d)) for d in (1, 2)]
    assert not torch.equal(folded[0], folded[1])
    assert not torch.equal(folded[0][:1], by_seed[:1])


def test_musiclm_rows_independent_of_batch():
    """MusicLM.generate with per-row keys: each row's waveform alone equals
    its row in the batch, through every stage's window folds and the
    batched fine windows."""
    m = tiny_musiclm()
    texts = ["alpha", "beta", "gamma"]
    keys = seed_keys([21, 22, 23])
    both = m.generate(text=texts, per_row_keys=keys, **GEN_KW, **SAMPLING_KW)
    one = m.generate(text=texts[1:2], per_row_keys=keys[1:2], **GEN_KW, **SAMPLING_KW)
    np.testing.assert_allclose(one.numpy(), both[1:2].numpy(), atol=1e-6)
    other = m.generate(text=texts[1:2], per_row_keys=seed_keys([24]), **GEN_KW, **SAMPLING_KW)
    assert not torch.equal(other, one)


def test_prefill_rows_independent_of_batch():
    """Transformer.prefill runs each row alone: a row's outputs and cache are
    bit-equal in any batch and slot."""
    stage = tiny_stage(create_fine_transformer, 9, dict(quantized=True, flash_kv="int8"),
                       acoustic_codebook_size=CB, num_coarse_quantizers=2, num_fine_quantizers=2)
    tfm = stage.model.transformer
    x = torch.randn(5, 23, 32, generator=torch.Generator().manual_seed(10))
    perm = torch.tensor([3, 0, 4, 1, 2])
    with torch.no_grad():
        h, cache = tfm.prefill(x, tfm.init_cache(5, 30))
        hp, cache_p = tfm.prefill(x[perm], tfm.init_cache(5, 30))
        h1, cache_1 = tfm.prefill(x[2:3], tfm.init_cache(1, 30))
    torch.testing.assert_close(hp, h[perm], atol=0, rtol=0)
    torch.testing.assert_close(h1, h[2:3], atol=0, rtol=0)
    for key in ("k", "v", "ff"):
        torch.testing.assert_close(cache_p[key], cache[key][:, perm], atol=0, rtol=0)
        torch.testing.assert_close(cache_1[key], cache[key][:, 2:3], atol=0, rtol=0)
