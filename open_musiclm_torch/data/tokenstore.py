"""Preprocessed-token store: sqlite with numpy-blob columns (port of
open_musiclm_tpu/data/tokenstore.py).

The same file format as the JAX package's store (and the reference's
``preprocessed.db``): table ``tokens(idx, path, clap, semantic, coarse,
fine)`` with each array an ``np.save`` blob of uint16, one shard per writer
rank (``preprocessed.rank{r}.db``), so either package reads what the other
wrote.

Each thread gets its own sqlite connection: ``batch_iterator`` reads from a
thread pool, and one connection shared across threads can raise
``sqlite3.InterfaceError`` under concurrent reads.
"""

from __future__ import annotations

import io
import sqlite3
import threading
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np


def _adapt_array(arr: np.ndarray) -> sqlite3.Binary:
    out = io.BytesIO()
    np.save(out, arr)
    return sqlite3.Binary(out.getvalue())


def _convert_array(blob: bytes) -> np.ndarray:
    return np.load(io.BytesIO(blob))


sqlite3.register_adapter(np.ndarray, _adapt_array)
sqlite3.register_converter("array", _convert_array)

SCHEMA = (
    "CREATE TABLE IF NOT EXISTS tokens("
    "idx integer primary key, path text, clap array, semantic array, "
    "coarse array, fine array)"
)


class TokenStore:
    """One sqlite shard, with one connection per thread that uses it."""

    def __init__(self, path: str, create: bool = False):
        self.path = str(path)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._conns: List[sqlite3.Connection] = []
        if create:
            self.conn.execute(SCHEMA)
            self.conn.commit()

    @property
    def conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            # check_same_thread=False only so that close() may close every
            # thread's connection; each connection is used by its own thread
            conn = sqlite3.connect(
                self.path, detect_types=sqlite3.PARSE_DECLTYPES, check_same_thread=False)
            self._local.conn = conn
            with self._lock:
                self._conns.append(conn)
        return conn

    def has(self, idx: int) -> bool:
        return self.conn.execute("SELECT idx FROM tokens WHERE idx=?", (idx,)).fetchone() is not None

    def put(self, idx: int, path: str, clap, semantic, coarse, fine) -> None:
        self.conn.execute(
            "INSERT OR REPLACE INTO tokens VALUES (?, ?, ?, ?, ?, ?)",
            (idx, path, *(np.asarray(a).astype(np.uint16) for a in (clap, semantic, coarse, fine))),
        )
        self.conn.commit()

    def ids(self) -> List[int]:
        return [r[0] for r in self.conn.execute("SELECT idx FROM tokens").fetchall()]

    def get(self, idx: int, fields: Sequence[str]) -> Tuple[np.ndarray, ...]:
        cols = ", ".join(fields)
        row = self.conn.execute(f"SELECT {cols} FROM tokens WHERE idx = ?", (idx,)).fetchone()
        return tuple(np.asarray(c) for c in row)

    def close(self):
        with self._lock:
            for conn in self._conns:
                conn.close()
            self._conns.clear()
        self._local = threading.local()


class ShardedTokenStore:
    """Reader over one or many shards (single-file reference DBs included)."""

    def __init__(self, folder: str):
        folder = Path(folder)
        paths = sorted(folder.glob("preprocessed*.db"))
        if not paths and folder.suffix == ".db":
            paths = [folder]
        if not paths:
            raise FileNotFoundError(f"no preprocessed*.db found in {folder}")
        self.shards = [TokenStore(str(p)) for p in paths]
        self.index: List[Tuple[int, int]] = []  # (shard, idx)
        for si, shard in enumerate(self.shards):
            self.index.extend((si, idx) for idx in shard.ids())

    def __len__(self) -> int:
        return len(self.index)

    def get(self, i: int, fields: Sequence[str]) -> Tuple[np.ndarray, ...]:
        si, idx = self.index[i]
        return self.shards[si].get(idx, fields)


def writer_for_rank(results_folder: str, rank: int, world: int) -> TokenStore:
    """Per-rank shard writer (no shared-writer races)."""
    folder = Path(results_folder)
    folder.mkdir(parents=True, exist_ok=True)
    name = "preprocessed.db" if world == 1 else f"preprocessed.rank{rank}.db"
    return TokenStore(str(folder / name), create=True)
