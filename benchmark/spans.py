"""The benchmark's own spans around the calls it makes into the program.

``Spans.wrap(obj, attr, name, ...)`` replaces a bound method on one object
(the program's code is not edited) by a wrapper that records the call's
host start and end, an optional ``note(args, kwargs, out)`` dict (shapes,
rows, tokens the check reads later), and in a traced run opens a
``record_function("bench:<name>")`` range and synchronises the device at
the end, so that the span's wall covers its device work.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch


class Spans:
    def __init__(self, trace: bool, sync: Callable[[], None]):
        self.trace = trace
        self.sync = sync
        self.records: List[Dict[str, Any]] = []
        self.local = threading.local()  # per-thread sink a traffic kind may set
        self.active = False  # only calls inside the window are recorded

    def wrap(self, obj: Any, attr: str, name: str,
             note: Optional[Callable[[tuple, dict, Any], Dict[str, Any]]] = None) -> None:
        inner = getattr(obj, attr)

        def wrapper(*args, **kwargs):
            if not self.active:
                return inner(*args, **kwargs)
            t0 = time.perf_counter()
            if self.trace:
                with torch.profiler.record_function(f"bench:{name}"):
                    out = inner(*args, **kwargs)
                    self.sync()
            else:
                out = inner(*args, **kwargs)
            rec = {"name": name, "t0": t0, "t1": time.perf_counter()}
            if note is not None:
                rec.update(note(args, kwargs, out))
            self.records.append(rec)
            sink = getattr(self.local, "sink", None)
            if sink is not None:
                sink.append(rec)
            return out

        setattr(obj, attr, wrapper)
