"""Batched text-to-music serving (port of open_musiclm_tpu/serve.py).

A continuous-batching front for ``MusicLM.generate``: concurrent requests
collect into batches padded to one of a few bucket sizes (repeating the
last request), run through the three-stage decode, and resolve
per-request futures with numpy waveforms. Text requests of a batch share
one text-tower call. Each request's seed becomes its row's sampling key,
and a row's bits do not depend on the rows around it (the products in
fixed row tiles, ``ops/rows.py``), so a request's tokens are the same in
any batch, slot or bucket, on the card as on the CPU; its wave too (the
card decodes Encodec a row at a time).

Over a serving mesh (``MusicLM(serving_mesh=make_mesh(dp=...))``) the
server runs on every rank of the mesh, SPMD: rank 0 is the front (the
queue, the buckets, the text tower, the futures); for each batch it
broadcasts one header to every rank (the bucket, each row's seed, the CLAP
token ids and the ``generate`` options), and every rank then calls
``MusicLM.generate`` with it, each decoding its ``dp`` rows. ``stop()`` on
the front broadcasts a stop header, which ends the other ranks' loops.
A batch that fails on a rank other than the front (say, out of memory)
leaves the ranks' collectives out of step, so that rank logs the error
and stops following, and its ``stop()`` raises it: the rank's process
then ends, and the front's pending collective fails (at once under gloo,
at the group's timeout under NCCL) and fails its requests.
A process holds one ``GenerationServer``, a mesh one server.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .core.sampling import seed_keys
from .models.musiclm import MusicLM


@dataclasses.dataclass
class GenerationRequest:
    text: Optional[str]
    clap_token_ids: Optional[Any]
    future: "Future[np.ndarray]"
    seed: int


logger = logging.getLogger(__name__)

# a front with no batch for this long broadcasts an idle header, so that a
# rank waiting for the next batch never reaches its process group's timeout
IDLE_HEADER_S = 60.0


class GenerationServer:
    """Continuous batching over MusicLM.generate, in one process or over the
    MusicLM's serving mesh (the module docstring)."""

    def __init__(
        self,
        musiclm: MusicLM,
        *,
        batch_size: int = 8,
        batch_timeout_s: float = 0.05,
        batch_buckets: Optional[List[int]] = None,
        num_workers: Optional[int] = None,
        **generate_kwargs,
    ):
        """``batch_buckets``: ascending bucket sizes (e.g. [1, 8, 64]); a batch
        pads to the smallest bucket that fits, so a lone request runs at
        batch 1. Defaults to [batch_size]; the largest must equal it. Over a
        serving mesh every bucket must split evenly over its ``dp`` ranks.

        ``num_workers``: concurrent batch pipelines (default 2 in one
        process). With one worker a request that arrives just after a batch
        dispatches waits for that whole batch before its own forms; a second
        worker forms and dispatches it at once, its launches queued on the
        card behind the first batch's. Over a serving mesh it is 1 (the
        default there; another number raises): a batch's collectives must
        reach every rank in the same order, and two workers on the front
        would issue two batches' collectives at once, which the ranks could
        interleave differently; with one worker the header sequence is the
        order every rank follows."""
        self.musiclm = musiclm
        self.batch_size = batch_size
        self.batch_timeout_s = batch_timeout_s
        self.batch_buckets = sorted(batch_buckets or [batch_size])
        if self.batch_buckets[-1] != batch_size:
            raise ValueError(f"the largest bucket ({self.batch_buckets[-1]}) must equal batch_size ({batch_size})")
        mesh = getattr(musiclm, "serving_mesh", None)
        self.mesh = mesh if mesh is not None and mesh.everyone is not None else None
        if self.mesh is not None:
            uneven = [b for b in self.batch_buckets if b % self.mesh.world]
            if uneven:
                raise ValueError(f"buckets {uneven} do not split over the serving mesh's dp={self.mesh.world} ranks")
            if num_workers not in (None, 1):
                raise ValueError(f"num_workers={num_workers}: over a serving mesh one worker runs the batches, "
                                 "so that every rank meets their collectives in one order")
        self.num_workers = max(1, int(num_workers or (1 if self.mesh is not None else 2)))
        self.is_front = self.mesh is None or self.mesh.is_main
        # NCCL's object broadcast stages the header on this rank's card, which
        # a new thread must make current (a thread starts on cuda:0)
        self._card = None
        if self.mesh is not None and dist.get_backend(self.mesh.everyone) == "nccl":
            self._card = musiclm.codec.codebooks.device
        self.generate_kwargs = generate_kwargs
        self._queue: "queue.Queue[Optional[GenerationRequest]]" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._running = False
        self._error: Optional[BaseException] = None  # what ended a follower's loop

    # ---- public API ----

    def start(self) -> "GenerationServer":
        """Start serving: the workers on the front, the loop that follows the
        front's headers on every other rank of a serving mesh (every rank
        calls ``start``)."""
        self._running = True
        if not self.is_front:
            self._threads = [threading.Thread(target=self._follow, daemon=True, name="gen-follower")]
        else:
            self._threads = [
                threading.Thread(target=self._worker, daemon=True, name=f"gen-worker-{i}")
                for i in range(self.num_workers)
            ]
        for t in self._threads:
            t.start()
        return self

    def stop(self, timeout: Optional[float] = 60.0) -> None:
        """Stop the workers. Batches in flight finish and resolve; requests
        still queued get their futures cancelled. Over a serving mesh the
        front's worker then broadcasts the stop header; on another rank
        ``stop`` waits (up to ``timeout`` s, None: for good) for that header,
        so each rank returns once the mesh has stopped serving, and raises
        the error of a batch that failed on this rank."""
        if not self.is_front:
            for t in self._threads:
                t.join(timeout=timeout)
            self._threads = []
            if self._error is not None:
                raise RuntimeError("a batch failed on this rank of the serving mesh") from self._error
            return
        self._running = False
        for _ in self._threads or [None]:
            self._queue.put(None)
        for t in self._threads:
            t.join(timeout=timeout)
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
        """A future resolving to the generated waveform [T] (numpy). Over a
        serving mesh requests go to the front (rank 0)."""
        if not self.is_front:
            raise RuntimeError("requests go to the serving mesh's front, rank 0")
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

    def _batch_header(self, reqs: List[GenerationRequest]) -> dict:
        """What every rank needs to run a batch: the bucket, each row's seed
        (padding rows take throwaway ones), the CLAP token ids [bucket, Q]
        and the ``generate`` options."""
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
        return {"bucket": bucket, "seeds": [r.seed for r in reqs] + [-(i + 1) for i in range(bucket - n)],
                "clap_token_ids": torch.stack(toks).numpy(), "kwargs": self.generate_kwargs}

    def _run_header(self, header: dict) -> np.ndarray:
        """``MusicLM.generate`` of one batch; row i's key comes from its seed
        alone."""
        waves = self.musiclm.generate(per_row_keys=seed_keys(header["seeds"]),
                                      clap_token_ids=torch.from_numpy(header["clap_token_ids"]),
                                      **header["kwargs"])
        return waves.float().cpu().numpy()

    def _broadcast(self, header: Optional[dict]) -> dict:
        """The front's header on every rank of the mesh (the front passes
        it, the others None)."""
        box = [header]
        dist.broadcast_object_list(box, src=0, group=self.mesh.everyone, device=self._card)
        return box[0]

    def _worker(self) -> None:
        if self._card is not None:
            torch.cuda.set_device(self._card)
        last = time.monotonic()
        while self._running:
            reqs = self._collect_batch()
            if not reqs:
                if self.mesh is not None and time.monotonic() - last > IDLE_HEADER_S:
                    self._broadcast({"idle": True})
                    last = time.monotonic()
                continue
            try:
                header = self._batch_header(reqs)
            except Exception as exc:  # a failed batch fails its requests, not the server
                self._fail(reqs, exc)
                continue
            try:
                if self.mesh is not None:
                    self._broadcast(header)
                    last = time.monotonic()
                waves = self._run_header(header)
            except Exception as exc:
                self._fail(reqs, exc)
                continue
            for i, r in enumerate(reqs):
                if not r.future.done():  # a caller may have cancelled it
                    r.future.set_result(waves[i])
        if self.mesh is not None:
            try:
                self._broadcast({"stop": True})
            except Exception:  # a rank has left the mesh (its batch failed there)
                logger.exception("serving mesh: the stop header reached no other rank")

    @staticmethod
    def _fail(reqs: List[GenerationRequest], exc: Exception) -> None:
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(exc)

    def _follow(self) -> None:
        """A rank other than the front: run each batch the front broadcasts,
        until its stop header. A batch that fails here ends the loop (the
        front may be waiting in a collective of that batch, and the next
        header would not line up with it); ``stop()`` raises its error."""
        if self._card is not None:
            torch.cuda.set_device(self._card)
        try:
            while True:
                header = self._broadcast(None)
                if header.get("stop"):
                    return
                if not header.get("idle"):
                    self._run_header(header)
        except Exception as exc:
            logger.exception("serving mesh: rank %d stops following the front", dist.get_rank())
            self._error = exc
