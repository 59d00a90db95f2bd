"""Audio file I/O through the native audioio library, with a stdlib WAV
fallback (port of open_musiclm_tpu/data/audio_io.py).

``native/audioio/audioio.cc`` decodes WAV (PCM 8/16/24/32, float32/64), MP3
(libmpg123, loaded at run time) and FLAC, mixes to mono and resamples with
the windowed-sinc kernel of ``ops/audio.py``; it writes PCM16 WAV. The
library tracked in ``native/lib`` was built with ``-march=native`` on another
host, and a library built for another CPU can load and then stop on an
illegal instruction. So at first use the port builds its own copy of the
source into ``build/native/`` (no ``-march=native``) and binds that; only
where no C++ compiler is found does it bind the tracked library. Where
neither loads, the stdlib ``wave`` module reads and writes PCM16 WAV and
``ops.audio.resample`` resamples.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import wave as wave_mod
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _REPO_ROOT / "native" / "audioio" / "audioio.cc"
_TRACKED_LIB = _REPO_ROOT / "native" / "lib" / "libaudioio.so"
_BUILT_LIB = _REPO_ROOT / "build" / "native" / "libaudioio.so"

_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "aio_wav_info": ([ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                      ctypes.POINTER(ctypes.c_long)], ctypes.c_int),
    "aio_read_wav": ([ctypes.c_char_p, ctypes.c_int, _F32P, ctypes.c_long, ctypes.POINTER(ctypes.c_int)],
                     ctypes.c_long),
    "aio_read_mp3": ([ctypes.c_char_p, ctypes.c_int, _F32P, ctypes.c_long, ctypes.POINTER(ctypes.c_int)],
                     ctypes.c_long),
    "aio_read_flac": ([ctypes.c_char_p, ctypes.c_int, _F32P, ctypes.c_long, ctypes.POINTER(ctypes.c_int)],
                      ctypes.c_long),
    "aio_resample": ([_F32P, ctypes.c_long, ctypes.c_int, ctypes.c_int, _F32P, ctypes.c_long], ctypes.c_long),
    "aio_write_wav": ([ctypes.c_char_p, _F32P, ctypes.c_long, ctypes.c_int, ctypes.c_int], ctypes.c_int),
    "aio_have_mp3": ([], ctypes.c_int),
}

_lib = None  # the bound library, False where none loads


def _build() -> Optional[Path]:
    """Compile the source into build/native/ (once; the file is replaced
    atomically, so concurrent first uses do not clash). None without a
    compiler or when it fails."""
    if _BUILT_LIB.exists():
        return _BUILT_LIB
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None or not _SOURCE.exists():
        return None
    _BUILT_LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _BUILT_LIB.with_name(f"{_BUILT_LIB.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, "-O3", "-std=c++17", "-shared", "-fPIC", str(_SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, _BUILT_LIB)
    return _BUILT_LIB


def _load_lib():
    global _lib
    if _lib is None:
        _lib = False
        for path in (_build(), _TRACKED_LIB):
            if path is None or not path.exists():
                continue
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                continue
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
            break
    return _lib


def have_native() -> bool:
    return bool(_load_lib())


def have_mp3() -> bool:
    """Whether the native library loads and finds libmpg123 to decode MP3."""
    lib = _load_lib()
    return bool(lib) and hasattr(lib, "aio_have_mp3") and bool(lib.aio_have_mp3())


def wav_info(path: str) -> Tuple[int, int, int]:
    """(sample_rate, channels, frames)."""
    lib = _load_lib()
    if lib:
        sr, ch, fr = ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
        rc = lib.aio_wav_info(str(path).encode(), sr, ch, fr)
        if rc != 0:
            raise IOError(f"failed to parse wav {path} (rc={rc})")
        return sr.value, ch.value, fr.value
    with wave_mod.open(str(path), "rb") as w:
        return w.getframerate(), w.getnchannels(), w.getnframes()


def audio_info(path: str) -> Tuple[int, int]:
    """(frames, sample rate) that ``read_audio(path)`` gives, read without
    decoding the samples: a WAV's header, a FLAC's STREAMINFO (decoded when
    it leaves the count unknown), an MP3's frame headers (libmpg123's scan,
    at the decode's own formats and gapless trim). A FLAC whose frames stop
    before its STREAMINFO count decodes shorter than this says."""
    p = str(path).lower()
    if p.endswith(".mp3"):
        return _mp3_info(path)
    if p.endswith(".flac"):
        frames, sr = _flac_info(path)
        if frames > 0:
            return frames, sr
        data, sr = read_audio(path)
        return data.shape[0], sr
    sr, _, frames = wav_info(path)
    return frames, sr


def _flac_info(path: str) -> Tuple[int, int]:
    """(total samples, sample rate) of a FLAC's STREAMINFO, its first
    metadata block (the total is 0 when the encoder left it unknown)."""
    with open(path, "rb") as f:
        head = f.read(4 + 4 + 18)
    if len(head) < 26 or head[:4] != b"fLaC" or head[4] & 0x7F != 0:
        raise IOError(f"no FLAC STREAMINFO in {path}")
    d = head[8:]
    sr = (d[10] << 12) | (d[11] << 4) | (d[12] >> 4)
    total = ((d[13] & 0x0F) << 32) | (d[14] << 24) | (d[15] << 16) | (d[16] << 8) | d[17]
    if sr == 0:
        raise IOError(f"FLAC STREAMINFO of {path} has no sample rate")
    return total, sr


_MP3_RATES = (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000)  # the native decoder's formats
_mpg123 = None  # the bound libmpg123, False where it does not load


def _mpg123_lib():
    global _mpg123
    if _mpg123 is None:
        try:
            lib = ctypes.CDLL("libmpg123.so.0")
        except OSError:
            _mpg123 = False
            return _mpg123
        lib.mpg123_new.argtypes, lib.mpg123_new.restype = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)], \
            ctypes.c_void_p
        for name in ("mpg123_format_none", "mpg123_scan", "mpg123_close"):
            getattr(lib, name).argtypes, getattr(lib, name).restype = [ctypes.c_void_p], ctypes.c_int
        lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int]
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_getformat.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                                         ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_length.argtypes, lib.mpg123_length.restype = [ctypes.c_void_p], ctypes.c_int64
        lib.mpg123_delete.argtypes, lib.mpg123_delete.restype = [ctypes.c_void_p], None
        lib.mpg123_init()
        _mpg123 = lib
    return _mpg123


def _mp3_info(path: str) -> Tuple[int, int]:
    """(samples a channel, rate) of an MP3 from its frame headers, opened as
    ``aio_read_mp3`` opens it (mono or stereo float32 at its rates)."""
    lib = _mpg123_lib()
    if not lib:
        raise IOError("libmpg123 is unavailable")
    h = lib.mpg123_new(None, ctypes.byref(ctypes.c_int()))
    if not h:
        raise IOError("mpg123_new failed")
    try:
        lib.mpg123_format_none(h)
        for rate in _MP3_RATES:
            lib.mpg123_format(h, rate, 3, 0x200)  # mono | stereo, MPG123_ENC_FLOAT_32
        rate, channels, enc = ctypes.c_long(), ctypes.c_int(), ctypes.c_int()
        if lib.mpg123_open(h, str(path).encode()) != 0 or lib.mpg123_getformat(h, rate, channels, enc) != 0:
            raise IOError(f"failed to open {path}")
        if lib.mpg123_scan(h) != 0:
            raise IOError(f"failed to scan {path}")
        frames = lib.mpg123_length(h)
        if frames < 0:
            raise IOError(f"no length for {path}")
        return int(frames), int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


def read_audio(path: str, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """WAV / MP3 / FLAC -> (mono float32 samples, their rate), resampled to
    ``target_sr`` when given."""
    p = str(path).lower()
    if p.endswith(".mp3"):
        return _read_via(path, "aio_read_mp3", target_sr)
    if p.endswith(".flac"):
        return _read_via(path, "aio_read_flac", target_sr)
    return read_wav(path, target_sr)


def _read_via(path: str, fn_name: str, target_sr: Optional[int]) -> Tuple[np.ndarray, int]:
    lib = _load_lib()
    if not lib or getattr(lib, fn_name, None) is None:
        raise IOError(f"the native decoder {fn_name} is unavailable")
    # room for mp3 at up to ~14x compression of 16-bit audio, flac at ~4x
    cap = max(int(Path(path).stat().st_size * 24), 1 << 20)
    if target_sr:
        cap = int(cap * max(target_sr / 8000, 1.0)) + 64
    buf = np.empty(cap, np.float32)
    native_sr = ctypes.c_int()
    n = getattr(lib, fn_name)(str(path).encode(), int(target_sr or 0), buf.ctypes.data_as(_F32P), cap,
                              native_sr)
    if n < 0:
        raise IOError(f"failed to decode {path} (rc={n})")
    return buf[:n].copy(), (target_sr or native_sr.value)


def read_wav(path: str, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """A WAV -> (mono float32 samples, their rate), resampled to
    ``target_sr`` when given."""
    p = str(path)
    lib = _load_lib()
    if lib:
        sr, _, fr = wav_info(p)
        t = target_sr or 0
        cap = int(fr * (max(t, sr) / sr + 1)) + 64
        buf = np.empty(cap, np.float32)
        native_sr = ctypes.c_int()
        n = lib.aio_read_wav(p.encode(), int(t), buf.ctypes.data_as(_F32P), cap, native_sr)
        if n < 0:
            raise IOError(f"failed to decode {p} (rc={n})")
        return buf[:n].copy(), (target_sr or native_sr.value)
    with wave_mod.open(p, "rb") as w:  # stdlib fallback: PCM16 only
        sr, ch = w.getframerate(), w.getnchannels()
        if w.getsampwidth() != 2:
            raise IOError(f"the stdlib fallback reads PCM16 only: {p}")
        raw = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
    mono = (raw.reshape(-1, ch).mean(axis=1) / 32768.0).astype(np.float32)
    if target_sr and target_sr != sr:
        mono, sr = resample_np(mono, sr, target_sr), target_sr
    return mono, sr


def resample_np(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Host-side resample: the native library's, else ``ops.audio.resample``."""
    lib = _load_lib()
    x = np.ascontiguousarray(x, np.float32)
    if lib:
        cap = int(np.ceil(len(x) * new_sr / orig_sr)) + 16
        out = np.empty(cap, np.float32)
        n = lib.aio_resample(x.ctypes.data_as(_F32P), len(x), int(orig_sr), int(new_sr),
                             out.ctypes.data_as(_F32P), cap)
        return out[:n].copy()
    from ..ops.audio import resample

    return resample(torch.from_numpy(x)[None], orig_sr, new_sr)[0].numpy()


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """[T] or [C, T] float32 in [-1, 1] -> a PCM16 WAV."""
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[None]
    ch, frames = data.shape
    interleaved = np.ascontiguousarray(data.T.reshape(-1))
    lib = _load_lib()
    if lib:
        if lib.aio_write_wav(str(path).encode(), interleaved.ctypes.data_as(_F32P), frames, ch,
                             int(sample_rate)) != 0:
            raise IOError(f"failed to write {path}")
        return
    with wave_mod.open(str(path), "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes((np.clip(interleaved, -1, 1) * 32767.0).astype(np.int16).tobytes())
