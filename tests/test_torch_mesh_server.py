"""GenerationServer over a serving mesh, on the CPU: two gloo ranks
(tests/torch_dp_workers.py:server_rank, a ``file://`` store) serve the
doll-house MusicLM of tests/test_torch_serve.py over ``make_mesh(dp=2)``
with buckets [2, 4]: rank 0 is the front and broadcasts each batch's
header, both ranks decode their rows. Each request's codes equal one
process's server on the same requests, and its wave within 1e-6
(tests/test_serve.py's limit); ``stop()`` on the front ends the other
rank (the ranks' join is bounded). A bucket that dp does not divide, and
two workers, are refused. A batch that fails on rank 1 alone ends that
rank's loop with its error, and the front's request fails instead of
hanging. No JAX model: the one-process server is the reference, as
tests/test_sharded_generate.py holds the JAX package's.
"""

import numpy as np
import pytest
import torch

from open_musiclm_torch.serve import GenerationServer

from tests.test_torch_serve import GEN_KW, SAMPLING_KW, tiny_musiclm
from tests.torch_dp_workers import run_ranks, server_rank

# five text requests and one of CLAP tokens (the doll-house's 4 quantizers):
# a batch of 4, then a batch of 2
REQUESTS = [("alpha", None, 1), ("beta", None, 2), (None, [3, 1, 4, 1], 3), ("gamma", None, 4),
            ("delta", None, 5), ("alpha", None, 6)]


def _one_process():
    musiclm = tiny_musiclm()
    codes, decode = [], musiclm._decode

    def capture(c):
        codes.append(c.clone())
        return decode(c)

    musiclm._decode = capture
    server = GenerationServer(musiclm, batch_size=4, batch_buckets=[2, 4], batch_timeout_s=0.2, num_workers=1,
                              **GEN_KW, **SAMPLING_KW)
    futs = [server.submit(text, clap_token_ids=toks, seed=seed) for text, toks, seed in REQUESTS]
    server.start()
    try:
        waves = [f.result(timeout=120) for f in futs]
    finally:
        server.stop()
    return waves, codes


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' records (one run for the tests of this file)."""
    tmp_path = tmp_path_factory.mktemp("mesh_server")
    torch.save({"requests": REQUESTS}, tmp_path / "inputs.pt")
    run_ranks(server_rank, 2, (str(tmp_path / "store"), str(tmp_path)), timeout=240)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]


def test_mesh_server_equals_one_process(ranks):
    waves, codes = _one_process()
    assert [r["front"] for r in ranks] == [True, False] and [r["workers"] for r in ranks] == [1, 1]
    assert [c.shape[0] for c in codes] == [4, 2]  # the buckets: 4 requests, then 2
    for rank in ranks:
        assert len(rank["codes"]) == len(codes)
        for got, want in zip(rank["codes"], codes):
            torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert len(ranks[0]["waves"]) == len(REQUESTS)
    for got, want in zip(ranks[0]["waves"], waves):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert not np.allclose(waves[0], waves[5])  # the same text, another seed
    for rank in ranks:
        assert len(rank["refused"]) == 2
        assert "do not split over the serving mesh's dp=2" in rank["refused"][0]
        assert "num_workers=2" in rank["refused"][1]


def test_mesh_server_failure_on_one_rank(ranks):
    """Rank 1's batch fails there alone: its ``stop()`` raises that error,
    and the front's request fails once rank 1's process has ended (gloo
    reports the closed connection), well inside the future's 60 s."""
    assert ranks[1]["fault"].endswith("<- injected fault on rank 1")
    assert ranks[1]["fault"].startswith("a batch failed on this rank of the serving mesh")
    assert ranks[0]["fault"] not in ("resolved", "TimeoutError: ") and ranks[0]["fault_s"] < 30


def test_one_process_server_takes_any_bucket():
    """Without a mesh any bucket goes, and two workers are the default."""
    server = GenerationServer(tiny_musiclm(), batch_size=4, batch_buckets=[1, 3, 4])
    assert server.mesh is None and server.is_front and server.num_workers == 2
