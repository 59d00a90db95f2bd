"""FMA metadata filtering (port of open_musiclm_tpu/data/fma.py).

Drops the low-engagement experimental tracks of the FMA dataset: a track
whose ``genres_all`` holds genre 38 ("Experimental") and that has at most
1000 listens or at most 5 favorites. Reads FMA's ``tracks.csv`` (two header
rows: the column group, then the field) with the standard library.
"""

from __future__ import annotations

import ast
import csv
from pathlib import Path
from typing import List

EXPERIMENTAL_GENRE = 38


def fma_ignore_files(metadata_folder: str, *, genre: int = EXPERIMENTAL_GENRE, max_listens: int = 1000,
                     max_favorites: int = 5) -> List[str]:
    """File names such as '000123.mp3' to skip."""
    path = Path(metadata_folder) / "tracks.csv"
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        group_row, field_row = next(reader), next(reader)
        filled, cur = [], ""
        for g in group_row:  # the group row names a group at its first column only
            cur = g if g else cur
            filled.append(cur)
        cols = {name: i for i, (g, name) in enumerate(zip(filled, field_row))
                if g == "track" and name in ("genres_all", "listens", "favorites")}
        missing = {"genres_all", "listens", "favorites"} - set(cols)
        if missing:
            raise ValueError(f"tracks.csv missing track columns: {missing}")
        ignore = []
        for row in reader:
            if not row or not row[0].strip().isdigit():
                continue
            try:
                genres = ast.literal_eval(row[cols["genres_all"]] or "[]")
                listens = int(float(row[cols["listens"]] or 0))
                favorites = int(float(row[cols["favorites"]] or 0))
            except (ValueError, SyntaxError):
                continue
            if genre in genres and (listens <= max_listens or favorites <= max_favorites):
                ignore.append(f"{int(row[0]):06d}.mp3")
        return ignore
