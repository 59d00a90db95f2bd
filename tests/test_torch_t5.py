"""Port parity, the T5 bucketed relative position bias's buckets, bias
matrix, decode table and table gradient, and ``unique_consecutive``'s
labels, loss and gradients (stage options no shipped config sets), against
the JAX package on the CPU in float32, with tests/test_torch_options.py's
helpers and limits; the T5 bias through a stage's loss and decode is there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu.core import sampling as jsampling
from open_musiclm_tpu.core.sequence import TokenSequenceSpec as JSpec
from open_musiclm_tpu.ops import relpos as jrelpos
from open_musiclm_tpu.testing import CB

from open_musiclm_torch.core import sampling as tsampling
from open_musiclm_torch.models.token_cond import StageLossConfig, stage_training_loss
from open_musiclm_torch.ops import relpos as trelpos

from tests.test_torch_options import LENS, _check_grads, _loss_grads, _pair, _rel_close, _t
from tests.torch_threads import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# the T5 bias
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_t5_relative_bucket_matches_jax(causal):
    rel = np.arange(-300, 301)
    want = jrelpos.t5_relative_bucket(jnp.asarray(rel), causal=causal)
    got = trelpos.t5_relative_bucket(torch.from_numpy(rel), causal=causal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_t5_bias_and_decode_table_match_jax():
    """The [h, n, n] training / prefill matrix and the causal distance
    table of the decode (300 rows, past max_distance), from the same bucket
    table; the port's table gradient is a scatter-add over the 2n - 1
    distances into the 32 buckets."""
    jb = jrelpos.T5RelativePositionBias(heads=3)
    jparams = jax.jit(jb.init, static_argnums=1)(jax.random.PRNGKey(0), 4)
    bias = trelpos.T5RelativePositionBias(heads=3)
    with torch.no_grad():
        bias.embedding.copy_(_t(jparams["params"]["embedding"]))
    g = torch.randn(3, 40, 40, generator=torch.Generator().manual_seed(1))

    @jax.jit
    def jax_side(p, g):
        return (jb.apply(p, 40), jb.apply(p, 300, method=jb.distance_table),
                jax.grad(lambda p: jnp.sum(jb.apply(p, 40) * g))(p)["params"]["embedding"])

    want_bias, want_table, want_grad = jax_side(jparams, jnp.asarray(g.numpy()))
    _rel_close(bias(40), want_bias, 0.0, "bias")
    _rel_close(bias.distance_table(300), want_table, 0.0, "table")
    _rel_close(bias(40, heads=slice(1, 3)), want_bias[1:3], 0.0, "heads")
    (bias(40) * g).sum().backward()
    _rel_close(bias.embedding.grad, want_grad, 1e-5, "table gradient")


# ---------------------------------------------------------------------------
# unique_consecutive
# ---------------------------------------------------------------------------


def test_mask_unique_consecutive_matches_jax():
    ids = np.random.default_rng(21).integers(0, 3, (4, 30)).astype(np.int32)
    np.testing.assert_array_equal(tsampling.unique_consecutive_mask(_t(ids)).numpy(),
                                  np.asarray(jsampling.unique_consecutive_mask(jnp.asarray(ids))))
    np.testing.assert_array_equal(tsampling.mask_unique_consecutive(_t(ids)).numpy(),
                                  np.asarray(jsampling.mask_unique_consecutive(jnp.asarray(ids))))


def test_unique_consecutive_loss_labels_and_grads_match_jax():
    """Runs of repeated ids (drawn from 3 codes), both sequences marked
    unique_consecutive: repeats become pad (hidden from attention and zeroed
    in the conditioning, a zero embedding in the final sequence, out of the
    mean), and the labels, the loss and every gradient equal JAX's. A pad in
    the final sequence is a zero row, whose l2normed q and k have no
    derivative: JAX's gradients of the first layer's projections are NaN
    there, and the port's too."""
    specs = (JSpec(CB, 2, True), JSpec(CB, 3, True))
    jmodel, jparams, model = _pair(22, specs=specs)
    rng = np.random.default_rng(23)
    ids = [rng.integers(0, 3, (2, n)).astype(np.int32) for n in LENS]
    loss, jl, aux, jaux, grads, want = _loss_grads(jmodel, jparams, model, ids, dict(unique_consecutive=True))
    for lb, jlb in zip(aux["labels"], jaux["labels"]):
        np.testing.assert_array_equal(lb.numpy(), np.asarray(jlb))
    assert (aux["labels"][0] == -1).any() and (aux["labels"][-1] == -1).any()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _check_grads({n: p.grad for n, p in grads.items()}, want)
    assert any(torch.isnan(p.grad).any() for p in grads.values())
    plain = stage_training_loss(model, [_t(a).long() for a in ids], StageLossConfig((0.5, 1.0), mask_prob=0.0))[0]
    assert abs(plain.item() - loss.item()) > 1e-4  # the option changes the loss
