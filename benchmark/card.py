"""The card's name and power limit from nvidia-smi, written beside every
run's numbers (a card set below 700 W runs slower under load): a frozen
copy of ``chip_smoke.py:298-306`` ``card_line``, returning a note instead
of failing where nvidia-smi cannot answer."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    if out.returncode != 0:
        return f"nvidia-smi failed: {out.stderr.strip()}"
    return out.stdout.strip().splitlines()[0]
