"""Batched text-to-music serving (port of open_musiclm_tpu/serve.py).

A continuous-batching front for ``MusicLM.generate``: concurrent requests
collect into batches padded to one of a few bucket sizes (repeating the
last request), run through the three-stage decode, and resolve
per-request futures with numpy waveforms. Text requests of a batch share
one text-tower call. Each request's seed becomes its row's sampling key,
so its audio does not depend on the batch or slot it lands in, within one
bucket size: across bucket sizes the card's kernels may take other routes
with the row count, and only the CPU's plain versions keep rows equal.

The mesh-sharded decode and the multi-device pipelining of the JAX server
are not ported yet.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import Future
from typing import Any, List, Optional

import numpy as np
import torch

from .core.sampling import seed_keys
from .models.musiclm import MusicLM


@dataclasses.dataclass
class GenerationRequest:
    text: Optional[str]
    clap_token_ids: Optional[Any]
    future: "Future[np.ndarray]"
    seed: int


class GenerationServer:
    """Continuous batching over MusicLM.generate."""

    def __init__(
        self,
        musiclm: MusicLM,
        *,
        batch_size: int = 8,
        batch_timeout_s: float = 0.05,
        batch_buckets: Optional[List[int]] = None,
        num_workers: int = 2,
        **generate_kwargs,
    ):
        """``batch_buckets``: ascending bucket sizes (e.g. [1, 8, 64]); a batch
        pads to the smallest bucket that fits, so a lone request runs at
        batch 1. Defaults to [batch_size]; the largest must equal it.

        ``num_workers``: concurrent batch pipelines (default 2). With one
        worker a request that arrives just after a batch dispatches waits
        for that whole batch before its own forms; a second worker forms and
        dispatches it at once, its launches queued on the card behind the
        first batch's."""
        self.musiclm = musiclm
        self.batch_size = batch_size
        self.batch_timeout_s = batch_timeout_s
        self.batch_buckets = sorted(batch_buckets or [batch_size])
        if self.batch_buckets[-1] != batch_size:
            raise ValueError(f"the largest bucket ({self.batch_buckets[-1]}) must equal batch_size ({batch_size})")
        self.num_workers = max(1, int(num_workers))
        self.generate_kwargs = generate_kwargs
        self._queue: "queue.Queue[Optional[GenerationRequest]]" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._running = False

    # ---- public API ----

    def start(self) -> "GenerationServer":
        self._running = True
        self._threads = [
            threading.Thread(target=self._worker, daemon=True, name=f"gen-worker-{i}")
            for i in range(self.num_workers)
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        """Stop the workers. Batches in flight finish and resolve; requests
        still queued get their futures cancelled."""
        self._running = False
        for _ in self._threads or [None]:
            self._queue.put(None)
        for t in self._threads:
            t.join(timeout=60)
        self._threads = []
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if r is not None and not r.future.done():
                if not r.future.cancel():  # pragma: no cover - already running
                    r.future.set_exception(RuntimeError("server stopped"))

    def submit(self, text: Optional[str] = None, clap_token_ids=None, seed: int = 0) -> "Future[np.ndarray]":
        """A future resolving to the generated waveform [T] (numpy)."""
        fut: "Future[np.ndarray]" = Future()
        self._queue.put(GenerationRequest(text, clap_token_ids, fut, seed))
        return fut

    def generate_blocking(self, texts: List[str], seed: int = 0) -> List[np.ndarray]:
        futs = [self.submit(t, seed=seed + i) for i, t in enumerate(texts)]
        return [f.result() for f in futs]

    # ---- worker ----

    def _collect_batch(self) -> List[GenerationRequest]:
        reqs: List[GenerationRequest] = []
        try:
            first = self._queue.get(timeout=0.25)
        except queue.Empty:
            return reqs
        if first is None:
            return reqs
        reqs.append(first)
        while len(reqs) < self.batch_size:
            try:
                r = self._queue.get(timeout=self.batch_timeout_s)
            except queue.Empty:
                break
            if r is None:
                break
            reqs.append(r)
        return reqs

    def _run_batch(self, reqs: List[GenerationRequest]) -> np.ndarray:
        n = len(reqs)
        bucket = next(b for b in self.batch_buckets if b >= n)
        # the text requests share one text-tower call at the bucket's size,
        # padded by repeating the last text
        texts = [r.text for r in reqs if r.clap_token_ids is None]
        text_toks = None
        if texts:
            texts += [texts[-1]] * (bucket - len(texts))
            text_toks = self.musiclm.clap_tokens_from_text(texts).cpu()
        toks, next_text = [], 0
        for r in reqs:
            if r.clap_token_ids is not None:
                toks.append(torch.as_tensor(np.asarray(r.clap_token_ids)).reshape(-1).long())
            else:
                toks.append(text_toks[next_text].reshape(-1))
                next_text += 1
        toks += [toks[-1]] * (bucket - n)  # padding rows repeat the last request
        # row i's key comes from request i's seed alone; padding rows take
        # throwaway keys of their own
        keys = seed_keys([r.seed for r in reqs] + [-(i + 1) for i in range(bucket - n)])
        waves = self.musiclm.generate(per_row_keys=keys, clap_token_ids=torch.stack(toks),
                                      **self.generate_kwargs)
        return waves.float().cpu().numpy()

    def _worker(self) -> None:
        while self._running:
            reqs = self._collect_batch()
            if not reqs:
                continue
            try:
                waves = self._run_batch(reqs)
            except Exception as exc:  # a failed batch fails its requests, not the server
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(exc)
                continue
            for i, r in enumerate(reqs):
                if not r.future.done():  # a caller may have cancelled it
                    r.future.set_result(waves[i])
