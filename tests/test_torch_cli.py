"""The port's inference CLIs (open_musiclm_torch.cli) and audio I/O
(open_musiclm_torch.data.audio_io) on the CPU: each of infer, infer_top_match,
infer_coarse and infer_fine writes a wav with ``--device cpu`` on the
doll-house model config (towers at doll-house widths), infer's samples are
MusicLM.generate's with the same seed, and PCM16 WAV round-trips through the
native library and through the stdlib fallback.
"""

import json
import wave

import numpy as np
import pytest
import torch

from open_musiclm_torch import config as tconfig
from open_musiclm_torch.cli import infer, infer_coarse, infer_fine, infer_top_match
from open_musiclm_torch.cli.common import window_kwargs
from open_musiclm_torch.data import audio_io
from open_musiclm_torch.load import create_musiclm_from_config
from open_musiclm_torch.models.clap.tokenizer import bytes_to_unicode

from tests.test_torch_load import _tiny_towers, tiny_model_config
from tests.torch_threads import one_torch_thread  # noqa: F401


def _pcm16(path) -> np.ndarray:
    with wave.open(str(path), "rb") as w:
        assert w.getsampwidth() == 2
        return np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)


def _as_pcm16(x: np.ndarray, native: bool = True) -> np.ndarray:
    """What the writer stores: clip(x) * 32767, rounded half to even by the
    native library, truncated by the stdlib fallback (as the JAX package's)."""
    y = np.clip(x.astype(np.float32), -1, 1) * np.float32(32767)
    return (np.rint(y) if native else y).astype(np.int16)


@pytest.mark.parametrize("native", [True, False], ids=["native", "stdlib"])
def test_wav_round_trip(tmp_path, monkeypatch, native):
    """write_wav / read_wav round-trip a PCM16 file (mono and stereo, the
    stereo read back mixed to mono), with the native library and with the
    stdlib fallback; resampling keeps the length ratio."""
    if not native:
        monkeypatch.setattr(audio_io, "_lib", False)
    else:
        assert audio_io.have_native()
    rng = np.random.default_rng(0)
    x = (np.sin(np.arange(4000) / 7.0) * 0.6 + rng.normal(0, 0.05, 4000)).astype(np.float32)
    x[:3] = [1.5, -1.5, 0.5 / 32767]  # clipped, and half a step
    path = tmp_path / "mono.wav"
    audio_io.write_wav(str(path), x, 16000)
    np.testing.assert_array_equal(_pcm16(path), _as_pcm16(x, native))
    y, sr = audio_io.read_wav(str(path))
    assert sr == 16000 and y.dtype == np.float32
    np.testing.assert_array_equal(y, _as_pcm16(x, native) / np.float32(32768))
    assert audio_io.wav_info(str(path)) == (16000, 1, 4000)
    stereo = np.stack([x, -0.5 * x])
    audio_io.write_wav(str(tmp_path / "stereo.wav"), stereo, 8000)
    y2, _ = audio_io.read_wav(str(tmp_path / "stereo.wav"))
    want = (_as_pcm16(stereo[0], native).astype(np.float32) + _as_pcm16(stereo[1], native)) / 2 / 32768
    np.testing.assert_allclose(y2, want, atol=1e-7)
    y3, sr3 = audio_io.read_audio(str(path), target_sr=24000)
    assert sr3 == 24000 and abs(len(y3) - 6000) <= 1


def test_native_library_is_built_from_source():
    """The port binds its own build of native/audioio/audioio.cc (no
    -march=native), not the library built on another host."""
    assert audio_io.have_native()
    assert audio_io._lib._name == str(audio_io._BUILT_LIB)


@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    """The doll-house model config, towers at doll-house widths, a byte-level
    demo vocabulary and a 1.5 s input clip at 16 kHz."""
    _tiny_towers(monkeypatch)
    tok = tmp_path / "tok"
    tok.mkdir()
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in sorted(set(bytes_to_unicode().values())):
        vocab[c] = len(vocab)
    (tok / "vocab.json").write_text(json.dumps(vocab))
    (tok / "merges.txt").write_text("#version: demo\n")
    clip = tmp_path / "in.wav"
    t = np.arange(24000) / 16000
    audio_io.write_wav(str(clip), (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 16000)
    out = tmp_path / "out"
    args = ["--model_config", tiny_model_config(tmp_path), "--device", "cpu", "--results_folder", str(out),
            "--seed", "5"]
    return args, str(tok), str(clip), out


@pytest.mark.parametrize("mode", [[], ["--int8", "--flash_kv", "int8"]], ids=["fp", "int8"])
def test_infer_writes_generate_wave(cli_env, mode):
    """infer writes one wav a prompt whose samples are MusicLM.generate's
    with the same seed (at PCM16)."""
    args, tok, _, out = cli_env
    prompts = ["warm synth chords", "drum loop"]
    paths = infer.main(prompts + args + ["--tokenizer_path", tok, "--duration", "1", "--approx_topk"] + mode)
    assert [p.name for p in paths] == ["warm_synth_chords_generated.wav", "drum_loop_generated.wav"]
    mc = tconfig.load_model_config(args[1])
    musiclm = create_musiclm_from_config(mc, tokenizer_path=tok, seed=5, device="cpu")
    if mode:
        for name in ("semantic_stage", "coarse_stage", "fine_stage"):
            st = getattr(musiclm, name)
            st.quantized, st.flash_kv = True, "int8"
    want = musiclm.generate(text=prompts, generator=torch.Generator().manual_seed(5), output_seconds=1.0,
                            **window_kwargs(mc))
    assert want.shape == (2, 24000)
    for path, row in zip(paths, want.numpy()):
        np.testing.assert_array_equal(_pcm16(path), _as_pcm16(row))


def test_infer_top_match_writes_wavs(cli_env, capsys):
    args, tok, _, out = cli_env
    paths = infer_top_match.main(["a prompt"] + args + ["--tokenizer_path", tok, "--duration", "1",
                                                        "--num_samples", "2", "--num_top_matches", "2"])
    assert [p.name for p in paths] == ["a_prompt_top_match_0.wav", "a_prompt_top_match_1.wav"]
    for p in paths:
        assert len(_pcm16(p)) == 24000
    assert capsys.readouterr().out.count("clap similarity") == 2


@pytest.mark.parametrize("cli,name,n", [(infer_coarse, "in_coarse_generated.wav", 24000),
                                        (infer_fine, "in_fine_generated.wav", 24000)])
def test_stage_clis_write_wavs(cli_env, cli, name, n):
    """infer_coarse (HuBERT + k-means ids and the CLAP audio tokens of the
    clip -> coarse codes -> wave) and infer_fine (the clip's Encodec coarse
    codes -> fine codes -> wave) each write a wav of the clip's length."""
    args, _, clip, out = cli_env
    paths = cli.main([clip] + args + ["--duration", "1"])
    assert [p.name for p in paths] == [name]
    pcm = _pcm16(paths[0])
    assert len(pcm) == n and np.abs(pcm).max() > 0
