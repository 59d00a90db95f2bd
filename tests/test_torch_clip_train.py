"""Port parity, the CLAP training surface: train/clip_loss.py
(``clip_loss``, ``clip_loss_mlp``, ``gather_features`` over two gloo
ranks), SpecAugment and HTSAT's training forward (bn0 and the fusion
BatchNorms on batch statistics, their running statistics updated as flax
does) against the JAX package on the CPU in float32.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu.models.clap import htsat as jhtsat
from open_musiclm_tpu.models.clap import mel as jmel
from open_musiclm_tpu.testing import TINY_AUDIO
from open_musiclm_tpu.train import clip_loss as jclip

from open_musiclm_torch.convert import htsat_state_dict
from open_musiclm_torch.models.clap import mel
from open_musiclm_torch.models.clap.htsat import HTSAT
from open_musiclm_torch.train import clip_loss as tclip

from tests.test_torch_fusion import CHUNK, TINY_FUSION, _perturb_bn_stats
from tests.test_torch_htsat import _perturbed_htsat_variables, _wave, port_cfg
from tests.torch_dp_workers import clip_rank, run_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401


def _features(seed, n=6, d=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        x = rng.standard_normal((n, d)).astype(np.float32)
        out.append(x / np.linalg.norm(x, axis=-1, keepdims=True))
    return out


SCALES = (np.float32(1 / 0.07), np.float32(math.exp(1.7)))


# ---------------------------------------------------------------------------
# 1. the contrastive loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mlp", [False, True])
def test_clip_loss_and_grads_match_jax(mlp):
    """The loss and its gradients in every feature and both scales within
    1e-6 of JAX's (float32)."""
    feats = _features(1)
    n_in = 4 if mlp else 2

    def jloss(*args):
        if mlp:
            return jclip.clip_loss_mlp(*args)
        return jclip.clip_loss(*args)

    jargs = [jnp.asarray(f) for f in feats[:n_in]] + [jnp.asarray(s) for s in SCALES[:1 + mlp]]
    want, want_grads = jax.value_and_grad(jloss, argnums=tuple(range(len(jargs))))(*jargs)
    targs = [torch.tensor(np.asarray(a), requires_grad=True) for a in jargs]
    got = (tclip.clip_loss_mlp if mlp else tclip.clip_loss)(*targs)
    grads = torch.autograd.grad(got, targs)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=0)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_gather_features_is_the_identity_without_a_group():
    x = torch.randn(3, 4)
    assert tclip.gather_features(x) is x


def test_two_rank_gather_matches_one_process(tmp_path):
    """Two gloo ranks, 3 rows each: each rank's gathered loss equals the
    one-process loss over the 6 rows (1e-6), and the gradient of a rank's
    own rows, summed over the ranks' losses by the gather's backward and
    divided by the world size (the data-parallel mean that follows), equals
    the one-process gradient of those rows."""
    feats = _features(2)
    scales = tuple(torch.tensor(s) for s in SCALES)
    torch.save({"features": [torch.from_numpy(f) for f in feats], "scales": scales}, tmp_path / "features.pt")
    run_ranks(clip_rank, 2, (str(tmp_path / "store"), str(tmp_path)), timeout=120)
    one = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    want = {"clip": tclip.clip_loss(one[0], one[1], scales[0])}
    want["clip"] = (want["clip"].item(), torch.autograd.grad(want["clip"], one[:2]))
    loss = tclip.clip_loss_mlp(*one, *scales)
    want["mlp"] = (loss.item(), torch.autograd.grad(loss, one))
    for rank in range(2):
        got = torch.load(tmp_path / f"clip{rank}.pt", weights_only=False)
        for kind in ("clip", "mlp"):
            np.testing.assert_allclose(got[kind][0], want[kind][0], atol=1e-6, rtol=0)
            for g, w in zip(got[kind][1], want[kind][1]):
                np.testing.assert_allclose((g / 2).numpy(), w[3 * rank: 3 * rank + 3].numpy(), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# 2. SpecAugment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length,width,num", [(300, 64, 2), (64, 8, 2), (40, 64, 3), (1, 8, 2)])
def test_spec_augment_stripes_properties(length, width, num):
    """Widths in [0, width], starts in [0, max(length - width, 1)), every
    width and the extreme starts drawn, and the mask 0 exactly on the
    union of the stripes."""
    g = torch.Generator().manual_seed(length + width)
    starts, widths = mel.spec_augment_stripes(g, 512, length, width, num)
    assert starts.shape == widths.shape == (512, num)
    assert widths.min() >= 0 and widths.max() <= width
    assert set(widths.flatten().tolist()) == set(range(width + 1))
    high = torch.clamp(length - widths, min=1)
    assert (starts >= 0).all() and (starts < high).all()
    assert starts.min() == 0 and (starts == high - 1).any()
    m = mel.stripe_mask(starts, widths, length)
    pos = np.arange(length)
    for b in range(0, 512, 37):
        hit = np.zeros(length, bool)
        for s, w in zip(starts[b].tolist(), widths[b].tolist()):
            hit |= (pos >= s) & (pos < s + w)  # each stripe one contiguous run
        np.testing.assert_array_equal(m[b].numpy(), (~hit).astype(np.float32))


def test_spec_augment_zeroes_the_stripes_and_is_seeded():
    x = torch.randn(4, 300, 64) + 5.0
    a = mel.spec_augment(torch.Generator().manual_seed(3), x)
    b = mel.spec_augment(torch.Generator().manual_seed(3), x)
    assert torch.equal(a, b)
    zero = a == 0
    # a zero cell lies on a whole zeroed frame or a whole zeroed bin of its row
    rows_t, rows_f = zero.all(dim=2), zero.all(dim=1)
    assert torch.equal(zero, rows_t[:, :, None] | rows_f[:, None, :])
    assert torch.equal(a[~zero], x[~zero])


def test_spec_augment_arithmetic_matches_jax_with_its_masks():
    """JAX's own masks (read off its SpecAugment of ones) injected into the
    port's apply_spec_augment: the output bit-equal to JAX's spec_augment."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 300, 64)).astype(np.float32) * 20 - 40
    key = jax.random.PRNGKey(8)
    want = np.asarray(jmel.spec_augment(key, jnp.asarray(x)))
    ones = np.asarray(jmel.spec_augment(key, jnp.ones_like(jnp.asarray(x))))
    time_mask, freq_mask = ones.max(axis=2), ones.max(axis=1)
    assert set(np.unique(time_mask)) <= {0.0, 1.0} and (freq_mask.max(axis=1) == 1).all()
    np.testing.assert_array_equal(time_mask[:, :, None] * freq_mask[:, None, :], ones)
    got = mel.apply_spec_augment(torch.from_numpy(x), torch.from_numpy(time_mask), torch.from_numpy(freq_mask))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# 3. HTSAT's training forward
# ---------------------------------------------------------------------------


def _stats_close(model, updated):
    want = htsat_state_dict(updated)
    for name, t in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-5, err_msg=name)


def test_htsat_training_forward_matches_jax():
    """train=True without a generator (JAX: rng=None, no SpecAugment): the
    outputs within 1e-5, bn0's updated running mean and variance (the
    biased batch variance, flax's momentum 0.9) within 1e-5, twice in a row;
    with a generator the SpecAugment stripes change the output, and eval
    after training reads the new running statistics."""
    jcfg = TINY_AUDIO  # the training forward differs at bn0 and SpecAugment only
    jmodel, v = _perturbed_htsat_variables(jcfg, 3)
    model = HTSAT(port_cfg(jcfg))
    model.load_state_dict(htsat_state_dict(v))
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))
    for step in range(2):
        x = _wave(10 + step, 3, jcfg.clip_samples)
        want, upd = apply(v, jnp.asarray(x))
        v = {"params": v["params"], "batch_stats": jax.device_get(upd["batch_stats"])}
        with torch.no_grad():
            got = model(torch.from_numpy(x), train=True)
        for key in ("embedding", "clipwise_output", "framewise_output"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=1e-5, err_msg=key)
        _stats_close(model, v)
    assert int(model.bn0.num_batches_tracked) == 2
    x = _wave(20, 3, jcfg.clip_samples)
    want = jax.jit(jmodel.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        evaluated = model(torch.from_numpy(x))["embedding"]
        plain = model(torch.from_numpy(x), train=True)["embedding"]
        augmented = model(torch.from_numpy(x), train=True, generator=torch.Generator().manual_seed(1))["embedding"]
    np.testing.assert_allclose(evaluated.numpy(), np.asarray(want["embedding"]), atol=1e-5, rtol=1e-5)
    assert not torch.equal(plain, augmented)


def test_fusion_htsat_training_forward_matches_jax():
    """The fusion tower in training: bn0 and every fusion BatchNorm on batch
    statistics (no SpecAugment with fusion, a generator or not); outputs and
    every updated running statistic within 1e-5 of JAX's."""
    jmodel = jhtsat.HTSAT(cfg=TINY_FUSION)
    mf = jnp.zeros((1, 4, CHUNK, TINY_FUSION.mel_bins))
    v = jax.device_get(jax.jit(lambda k, m: jmodel.init(k, mel_fusion=m, longer=jnp.ones((1,), bool)))(
        jax.random.PRNGKey(5), mf))
    v = _perturb_bn_stats({"params": dict(v["params"]), "batch_stats": dict(v["batch_stats"])}, 6)
    model = HTSAT(port_cfg(TINY_FUSION))
    model.load_state_dict(htsat_state_dict(v))
    rng = np.random.default_rng(4)
    stack = (rng.standard_normal((3, 4, CHUNK, TINY_FUSION.mel_bins)) * 10 - 30).astype(np.float32)
    longer = np.array([True, False, True])
    want, upd = jax.jit(lambda v, m, l: jmodel.apply(v, mel_fusion=m, longer=l, train=True,
                                                     mutable=["batch_stats"]))(v, jnp.asarray(stack),
                                                                               jnp.asarray(longer))
    with torch.no_grad():
        got = model(mel_fusion=torch.from_numpy(stack), longer=torch.from_numpy(longer), train=True,
                    generator=torch.Generator().manual_seed(0))
    for key in ("embedding", "clipwise_output", "framewise_output"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=1e-5, err_msg=key)
    _stats_close(model, {"params": v["params"], "batch_stats": jax.device_get(upd["batch_stats"])})


def test_clap_audio_embedding_training_mode():
    """CLAP.get_audio_embedding(train=True) is the L2-normed projection of
    HTSAT's training forward (held to JAX above), and moves bn0's running
    statistics; with a generator SpecAugment changes it."""
    from open_musiclm_torch.models.clap.clap import CLAP, l2_normalize

    from tests.test_torch_clap import TEXT_CFG

    model = CLAP(TEXT_CFG, joint_embed_shape=16, audio_cfg=port_cfg(TINY_AUDIO),
                 generator=torch.Generator().manual_seed(3))
    twin = copy.deepcopy(model)
    x = torch.from_numpy(_wave(30, 3, TINY_AUDIO.clip_samples))
    with torch.no_grad():
        got = model.get_audio_embedding(x, train=True)
        want = l2_normalize(twin.audio_projection(twin.audio_branch(x, train=True)["embedding"]))
        assert torch.equal(got, want)
        assert torch.equal(model.audio_branch.bn0.running_mean, twin.audio_branch.bn0.running_mean)
        assert int(model.audio_branch.bn0.num_batches_tracked) == 1
        augmented = model.get_audio_embedding(x, train=True, generator=torch.Generator().manual_seed(4))
        again = twin.get_audio_embedding(x, train=True)
    assert not torch.equal(augmented, again)
