"""The demo BPE vocabulary that stands in for roberta-base's files, which
the repository does not hold: a frozen copy of ``chip_smoke.py:1419-1478``
(``DEMO_MERGES``, ``write_demo_vocab``), with the byte symbols of
``bytes_to_unicode`` spelled out here."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

from .reference.text import _byte_symbols

DEMO_MERGES = (("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("Ġ", "a"), ("e", "r"), ("o", "n"),
               ("Ġ", "s"), ("a", "n"), ("Ġ", "w"), ("r", "o"), ("Ġ", "b"))


def write_demo_vocab(folder: Path) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """Writes vocab.json and merges.txt; returns (vocab, merges)."""
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in sorted(set(_byte_symbols().values())):
        vocab[c] = len(vocab)
    for a, b in DEMO_MERGES:
        vocab[a + b] = len(vocab)
    (folder / "vocab.json").write_text(json.dumps(vocab))
    (folder / "merges.txt").write_text("#version: demo\n" + "".join(f"{a} {b}\n" for a, b in DEMO_MERGES))
    return vocab, list(DEMO_MERGES)
