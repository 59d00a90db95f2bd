"""Port parity, training slice: open_musiclm_torch's masks, attention
gradients, stage loss, optimizer, trainer and token data path against the
JAX package, at small sizes in float32 on the CPU.

Inputs come from numpy with a seed and go to both sides. On the JAX side the
Pallas backward runs in interpret mode (``shared_kv_attention_fused(...,
interpret=True)``) and the stage models take the XLA attention, as the JAX
package runs them on the CPU; ``tests/conftest.py`` sets JAX's matmul
precision to "highest". On the port's side every kernel wrapper runs its
plain version, because the tensors lie on the CPU.
"""

import dataclasses
import inspect
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open_musiclm_tpu import config as jconfig
from open_musiclm_tpu.core import masks as jmasks
from open_musiclm_tpu.core.sequence import TokenSequenceSpec as JSpec
from open_musiclm_tpu.data import dataset as jdataset
from open_musiclm_tpu.data import tokenstore as jtokenstore
from open_musiclm_tpu.models import stages as jstages
from open_musiclm_tpu.models.token_cond import StageLossConfig as JLossConfig
from open_musiclm_tpu.models.token_cond import TokenConditionedTransformer as JTCT
from open_musiclm_tpu.models.token_cond import stage_training_loss as j_stage_training_loss
from open_musiclm_tpu.ops import attention as jattn
from open_musiclm_tpu.ops.pallas_attention import shared_kv_attention_fused as j_attention_fused
from open_musiclm_tpu.parallel.mesh import make_mesh
from open_musiclm_tpu.train import flops as jflops
from open_musiclm_tpu.train.optimizer import make_optimizer
from open_musiclm_tpu.train.trainer import StageTrainer as JStageTrainer

from open_musiclm_torch import config as tconfig
from open_musiclm_torch.checkpoint import find_latest_checkpoint
from open_musiclm_torch.convert import stage_state_dict
from open_musiclm_torch.core import masks as tmasks
from open_musiclm_torch.core.sequence import TokenSequenceSpec
from open_musiclm_torch.data.dataset import PreprocessedDataset, batch_iterator
from open_musiclm_torch.data.pipeline import accumulate_token_batches
from open_musiclm_torch.data.tokenstore import writer_for_rank
from open_musiclm_torch.models.token_cond import (
    StageLossConfig,
    TokenConditionedTransformer,
    stage_training_loss,
)
from open_musiclm_torch.ops import attention as tattn
from open_musiclm_torch.train import flops as tflops
from open_musiclm_torch.train.optimizer import StageOptimizer
from open_musiclm_torch.train.trainer import StageTrainer

from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CB = 16
N_CLAP_Q = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _max_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.max(np.abs(got.astype(np.float64) - np.asarray(want, np.float64))))


def _assert_rel_to_max(got, want, rel, name=""):
    """max|got - want| <= rel * max|want|: a tolerance on the tensor's scale."""
    scale = float(np.max(np.abs(np.asarray(want))))
    err = _max_err(got, want)
    assert err <= rel * max(scale, 1e-30), f"{name}: max abs err {err} > {rel} x {scale}"


def port_model(jmodel, jparams) -> TokenConditionedTransformer:
    specs = tuple(TokenSequenceSpec(s.codebook_size, s.num_quantizers) for s in jmodel.specs)
    model = TokenConditionedTransformer(
        specs, jmodel.dim, jmodel.depth, heads=jmodel.heads, dim_head=jmodel.dim_head,
        grad_shrink_alpha=jmodel.grad_shrink_alpha,
        non_causal_prefix_size=jmodel.non_causal_prefix_size,
    )
    model.load_state_dict(stage_state_dict(jax.device_get(jparams), len(specs), jmodel.depth))
    return model


# ---------------------------------------------------------------------------
# 1. masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,ncp", [(7, 0), (9, 3)])
def test_causal_mask_matches_jax(n, ncp):
    np.testing.assert_array_equal(
        tmasks.causal_mask(n, ncp).numpy(), np.asarray(jmasks.causal_mask(n, ncp)))


def test_conditioning_attn_mask_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(-1, CB + 1, (3, 8))  # pad -1 and EOS CB included
    b = rng.integers(-1, 11, (3, 5))
    want = jmasks.conditioning_attn_mask([jnp.asarray(a), jnp.asarray(b)], [CB, 10], -1, 7)
    got = tmasks.conditioning_attn_mask([_t(a), _t(b)], [CB, 10], -1, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seq,p", [(10, 0.15), (40, 0.15), (5, 0.9), (3, 0.0)])
def test_forgetful_causal_mask_structure(seq, p):
    """The draws differ between the frameworks; the structure does not:
    the same number of dropped keys per row, position 0 always kept."""
    got = tmasks.forgetful_causal_mask(6, seq, p, torch.Generator().manual_seed(seq))
    want = np.asarray(jmasks.forgetful_causal_mask(jax.random.PRNGKey(seq), 6, seq, p))
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal((~got).sum(-1).numpy(), (~want).sum(-1))
    assert (~got).sum(-1).eq(min(int(seq * p), seq - 1)).all()
    assert got[:, 0].all()


# ---------------------------------------------------------------------------
# 2. attention gradients: the autograd Function (plain forward +
#    shared_kv_attention_bwd_plain on the CPU) against the Pallas backward in
#    interpret mode, jax.grad of the plain attention, and torch.autograd of
#    the port's plain forward. float32; only the summation order differs.
# ---------------------------------------------------------------------------


def _grad_inputs(seed, b, h, n, m, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, n, d)).astype(np.float32)
    k = rng.standard_normal((b, m, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rng.standard_normal((b, m, d)).astype(np.float32)
    bias = rng.standard_normal((h, n, m)).astype(np.float32)
    key_mask = rng.random((b, m)) > 0.3
    key_mask[:, 0] = True
    dout = rng.standard_normal((b, n, h * d)).astype(np.float32)
    return q, k, v, bias, key_mask, dout


@pytest.mark.parametrize(
    "n,m,with_bias,with_mask,ncp",
    [
        (37, 37, True, True, 0),  # n not a multiple of the block (8)
        (20, 29, True, True, 0),  # queries are the last n of m keys
        (33, 33, True, False, 5),  # bidirectional prefix
        (21, 21, False, True, 3),  # no bias, mask and prefix
    ],
)
def test_attention_grads_match_jax(n, m, with_bias, with_mask, ncp):
    q, k, v, bias, key_mask, dout = _grad_inputs(n * m, 2, 4, n, m, 16)
    mask = key_mask if with_mask else None
    argnums = (0, 1, 2, 3) if with_bias else (0, 1, 2)

    def loss_pallas(q, k, v, bias):
        out = j_attention_fused(q, k, v, bias, mask, 8.0, True, ncp, 8, True)
        return jnp.sum(out * dout)

    def loss_plain(q, k, v, bias):
        out = jattn.shared_kv_attention(q, k, v, scale=8.0, attn_bias=bias, key_mask=mask,
                                        causal=True, non_causal_prefix=ncp)
        return jnp.sum(out * dout)

    args = (q, k, v, bias if with_bias else None)
    refs = [jax.jit(jax.grad(fn, argnums))(*args) for fn in (loss_pallas, loss_plain)]

    def port_grads(fn):
        leaves = [_t(a).requires_grad_() for a in args if a is not None]
        fn(*leaves).backward(_t(dout))
        return [t.grad for t in leaves]

    tmask = _t(mask) if with_mask else None
    got = port_grads(lambda q, k, v, bias=None: tattn.shared_kv_attention_train(
        q, k, v, bias, tmask, scale=8.0, causal=True, non_causal_prefix=ncp))
    refs.append(port_grads(lambda q, k, v, bias=None: tattn.shared_kv_attention(
        q, k, v, scale=8.0, attn_bias=bias, key_mask=tmask, causal=True, non_causal_prefix=ncp)))
    for ref in refs:
        for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
            _assert_rel_to_max(a, np.asarray(r), 1e-5, name)


def test_attention_grads_fully_masked_row():
    """A row with every key masked softmaxes uniformly over all m keys. The
    backward recomputes ds = p * (dp - rowsum(dp * p)) over every key, masked
    ones included, as the Pallas backward does (autodiff of the plain forward
    would pass nothing through the masked scores); the two agree wherever a
    row sees a key."""
    q, k, v, bias, key_mask, dout = _grad_inputs(1, 2, 2, 9, 9, 8)
    key_mask[1] = False

    def loss(q, k, v, bias):
        out = j_attention_fused(q, k, v, bias, key_mask, 8.0, True, 0, 8, True)
        return jnp.sum(out * dout)

    want = jax.jit(jax.grad(loss, (0, 1, 2, 3)))(q, k, v, bias)
    leaves = [_t(a).requires_grad_() for a in (q, k, v, bias)]
    tattn.shared_kv_attention_train(*leaves, _t(key_mask)).backward(_t(dout))
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), leaves, want):
        _assert_rel_to_max(a.grad, np.asarray(r), 1e-5, name)


def test_attention_bwd_keeps_input_dtypes_and_no_mask_grad():
    q, k, v, bias, key_mask, dout = (_t(a) for a in _grad_inputs(2, 1, 2, 6, 6, 8))
    q, k, v = (t.bfloat16().requires_grad_() for t in (q, k, v))
    bias = bias.bfloat16().requires_grad_()
    tattn.shared_kv_attention_train(q, k, v, bias, key_mask).float().backward(dout)
    assert all(t.grad.dtype == torch.bfloat16 for t in (q, k, v, bias))
    assert not key_mask.requires_grad


def test_attention_bwd_wrapper_on_cpu():
    """On CPU tensors the kernels' wrapper returns the plain backward, with
    dbias only when there is a bias and it is asked for, and counts no launch."""
    q, k, v, bias, key_mask, dout = (_t(a) for a in _grad_inputs(4, 2, 4, 10, 10, 16))
    fn = tattn.shared_kv_attention_bwd
    before = (fn.launches, fn.dbias_launches)
    want = tattn.shared_kv_attention_bwd_plain(q, k, v, dout, attn_bias=bias, key_mask=key_mask)
    got = fn(q, k, v, bias, key_mask, None, None, dout)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    assert fn(q, k, v, bias, key_mask, None, None, dout, dbias=False)[3] is None
    assert fn(q, k, v, None, key_mask, None, None, dout)[3] is None
    assert (fn.launches, fn.dbias_launches) == before


# ---------------------------------------------------------------------------
# 3. stage loss and every parameter gradient
# ---------------------------------------------------------------------------

TINY = dict(dim=64, depth=2, heads=4, dim_head=16, clap_codebook_size=CB,
            num_clap_quantizers=N_CLAP_Q)
STAGES = {
    "semantic": (jstages.create_semantic_transformer, dict(semantic_codebook_size=CB), (4, 10)),
    "coarse": (jstages.create_coarse_transformer,
               dict(semantic_codebook_size=CB, acoustic_codebook_size=CB), (4, 6, 12)),
    "fine": (jstages.create_fine_transformer, dict(acoustic_codebook_size=CB), (4, 9, 15)),
}


def _stage_ids(rng, specs, lens, batch):
    """Token ids per sequence; the conditioning ones hold pad (-1) and EOS ids."""
    ids = []
    for i, (spec, n) in enumerate(zip(specs, lens)):
        a = rng.integers(0, spec.codebook_size, (batch, n))
        if i < len(specs) - 1:
            a[0, -1] = -1
            a[1, n // 2] = spec.eos_id
            a[1, -1] = -1
        ids.append(a.astype(np.int32))
    return ids


@pytest.mark.parametrize("stage", ["semantic", "coarse", "fine"])
def test_stage_loss_and_grads_match_jax(stage):
    factory, kw, lens = STAGES[stage]
    jmodel = factory(**TINY, **kw)
    rng = np.random.default_rng(len(stage))
    ids = _stage_ids(rng, jmodel.specs, lens, 2)
    # jit: flax's eager init of the tiny model takes several seconds on the CPU
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(3), [jnp.asarray(a) for a in ids])
    weights = tuple(0.5 + 0.25 * i for i in range(len(lens)))  # every logit head has a loss

    def jloss(params):
        cfg = JLossConfig(weights, mask_prob=0.0)
        return j_stage_training_loss(jmodel, params, [jnp.asarray(a) for a in ids],
                                     jax.random.PRNGKey(0), cfg, train=True)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jparams)
    want = stage_state_dict(jax.device_get(want_grads), len(lens), jmodel.depth)

    model = port_model(jmodel, jparams).train()
    loss, aux = stage_training_loss(model, [_t(a).long() for a in ids],
                                    StageLossConfig(weights, mask_prob=0.0), train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert len(aux["logits"]) == len(lens)
    # float32 on both sides; XLA's autodiff and the port's plain backward sum
    # in another order, and the embedding and start-token gradients collect
    # the backward of both layers: 1e-4 of each tensor's largest gradient.
    # The rel-pos MLP's output bias shifts every score of a row by the same
    # amount, which the softmax ignores: its true gradient is 0 and both
    # sides hold rounding noise, held to 1e-5 of the output weight's gradient.
    grads = dict(model.named_parameters())
    assert set(grads) == set(want)
    shift = "transformer.rel_pos_bias.out_layer.bias"
    for name, p in grads.items():
        assert p.grad is not None, name
        if name == shift:
            floor = 1e-5 * want["transformer.rel_pos_bias.out_layer.weight"].abs().max().item()
            assert p.grad.abs().max() <= floor and want[name].abs().max() <= floor
            continue
        _assert_rel_to_max(p.grad, want[name].numpy(), 1e-4, name)
    for i in range(len(lens)):
        assert grads[f"logit_heads.{i}"].grad.abs().sum() > 0
    with torch.no_grad():
        only = model([_t(a).long().clamp(min=0) for a in ids], return_only_final_seq_logits=True)
        full = model([_t(a).long().clamp(min=0) for a in ids])
    assert only[:-1] == [None] * (len(lens) - 1)
    torch.testing.assert_close(only[-1], full[-1])


# ---------------------------------------------------------------------------
# 4. optimizer against optax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_norm,warmup", [(0.5, 0), (1e3, 0), (0.5, 3), (1e3, 3)])
def test_optimizer_matches_optax(max_norm, warmup):
    """Clip active (0.5 < the gradients' global norm ~4) and inactive (1e3),
    warmup on and off; decay on the 2-D and 3-D parameters only."""
    rng = np.random.default_rng(int(max_norm) + warmup)
    shapes = {"w": (6, 5), "conv": (3, 4, 2), "gamma": (5,), "bias": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (0.5 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    opt = make_optimizer(1e-2, 0.1, warmup_steps=warmup, max_grad_norm=max_norm)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = [_t(params[k]) for k in shapes]
    topt = StageOptimizer(tp, 1e-2, 0.1, warmup_steps=warmup, max_grad_norm=max_norm)
    for g in grads:
        topt.step([_t(g[k]) for k in shapes])
    assert topt.count == 5
    for k, p in zip(shapes, tp):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7, err_msg=k)


def test_optimizer_decays_only_matrices():
    w, g = torch.ones(3, 2), torch.ones(4)
    opt = StageOptimizer([w, g], lr=0.1, wd=0.5, max_grad_norm=None)
    opt.step([torch.zeros(3, 2), torch.zeros(4)])
    torch.testing.assert_close(w, torch.full((3, 2), 1.0 - 0.1 * 0.5))
    torch.testing.assert_close(g, torch.ones(4))


# ---------------------------------------------------------------------------
# 5. the trainer against the JAX StageTrainer
# ---------------------------------------------------------------------------


def _token_batches(seed, accum, batch, cond_len=6, pred_len=8):
    rng = np.random.default_rng(seed)
    cond = rng.integers(0, CB, (accum, batch, cond_len)).astype(np.int32)
    cond[:, 0, -1] = -1
    pred = rng.integers(0, CB, (accum, batch, pred_len)).astype(np.int32)
    return cond, pred


def test_trainer_matches_jax(tmp_path):
    """Three steps at accum 2, the same batches, dropout and the forgetful
    mask off. Adam divides by sqrt(nu) + eps, so on an element whose
    gradient is rounding noise it moves by about +-lr on either side, in
    random directions; the test raises eps to 1e-2 on both sides (never in
    the port) so that an update is at most |g| / eps and a float32 gradient
    difference of ~1e-7 moves a parameter by ~lr x 1e-5: the parameters are
    then held to 1e-6 (lr x 1e-3)."""
    jmodel = JTCT(specs=(JSpec(CB, 2), JSpec(CB, 1)), dim=32, depth=2, heads=2, dim_head=16)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0), [jnp.zeros((1, 6), jnp.int32),
                                                           jnp.zeros((1, 8), jnp.int32)])
    weights = (0.5, 1.0)
    hp = dict(lr=1e-3, wd=1e-2, lr_warmup=2, max_grad_norm=0.5, grad_accum_every=2)
    jtrainer = JStageTrainer(model=jmodel, loss_cfg=JLossConfig(weights, mask_prob=0.0),
                             mesh=make_mesh(dp=1), use_tensorboard=False,
                             results_folder=str(tmp_path / "jax"), **hp)
    jtrainer.optimizer = make_optimizer(1e-3, 1e-2, warmup_steps=2, max_grad_norm=0.5, eps=1e-2)
    jstate = jtrainer.init_state(jparams)

    model = port_model(jmodel, jparams)
    trainer = StageTrainer(model=model, loss_cfg=StageLossConfig(weights, mask_prob=0.0),
                           results_folder=str(tmp_path / "port"), use_tensorboard=False, **hp)
    state = trainer.init_state()
    state.optimizer.eps = 1e-2
    for step in range(3):
        batch = _token_batches(step, 2, 2)
        jstate, jloss = jtrainer.train_step(jstate, tuple(jnp.asarray(b) for b in batch),
                                            jax.random.PRNGKey(step))
        state, loss = trainer.train_step(state, tuple(_t(b) for b in batch))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert state.step == int(jstate.step) == 3

    valid = tuple(b[0] for b in _token_batches(9, 1, 3))
    jvl, jva = jtrainer.eval_step(jstate, tuple(jnp.asarray(b) for b in valid), jax.random.PRNGKey(9))
    vl, va = trainer.eval_step(state, tuple(_t(b) for b in valid))
    np.testing.assert_allclose(vl.item(), float(jvl), rtol=1e-4)
    np.testing.assert_allclose(va.item(), float(jva), atol=1e-6)

    want = stage_state_dict(jax.device_get(jstate.params), 2, jmodel.depth)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# 6. the trainer alone
# ---------------------------------------------------------------------------


def _tiny_port_model(seed=0):
    specs = (TokenSequenceSpec(CB, 2), TokenSequenceSpec(CB, 1))
    return TokenConditionedTransformer(specs, 32, 1, heads=2, dim_head=8,
                                       generator=torch.Generator().manual_seed(seed))


def _learnable_batch(rng, accum, batch):
    """pred tokens = (cond token 0) repeated: a task the model can learn."""
    cond = rng.integers(0, CB, (accum, batch, 6))
    pred = np.broadcast_to(cond[..., :1], (accum, batch, 8)) % CB
    return _t(cond), _t(np.ascontiguousarray(pred))


def test_trainer_loss_falls_and_checkpoint_roundtrip(tmp_path):
    trainer = StageTrainer(model=_tiny_port_model(), loss_cfg=StageLossConfig((0.0, 1.0)),
                           lr=1e-3, lr_warmup=5, grad_accum_every=2, use_tensorboard=False,
                           results_folder=str(tmp_path), stage_name="test")
    state = trainer.init_state()
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(40):
        state, loss = trainer.train_step(state, _learnable_batch(rng, 2, 16), gen)
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8
    assert state.step == 40

    trainer.save(state, state.step)
    path = find_latest_checkpoint(str(tmp_path), "test.transformer")
    assert path is not None and path.endswith("test.transformer.40.ckpt")
    other = StageTrainer(model=_tiny_port_model(seed=7), loss_cfg=trainer.loss_cfg,
                         results_folder=str(tmp_path), stage_name="test", use_tensorboard=False)
    restored = other.load(path)
    assert restored.step == 40 and restored.optimizer.count == state.optimizer.count
    for (name, a), b in zip(state.model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(state.optimizer.mu + state.optimizer.nu,
                    restored.optimizer.mu + restored.optimizer.nu):
        assert torch.equal(a, b)


def test_find_latest_checkpoint(tmp_path):
    for step in (10, 200, 30):
        (tmp_path / f"sem.transformer.{step}.ckpt").write_bytes(b"")
    (tmp_path / "sem.transformer.999.ckpt.tmp").write_bytes(b"")
    assert find_latest_checkpoint(str(tmp_path), "sem.transformer").endswith("sem.transformer.200.ckpt")
    assert find_latest_checkpoint(str(tmp_path), "coarse.transformer") is None


def test_preemption_guard_saves_and_stops(tmp_path):
    trainer = StageTrainer(model=_tiny_port_model(), loss_cfg=StageLossConfig((0.0, 1.0)),
                           results_folder=str(tmp_path), stage_name="test", use_tensorboard=False)
    rng = np.random.default_rng(2)

    def batches():
        for i in range(100):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)  # preempted after two steps
            yield _learnable_batch(rng, 1, 4)

    previous = signal.getsignal(signal.SIGTERM)
    out = trainer.train(trainer.init_state(), batches(), num_steps=10)
    assert signal.getsignal(signal.SIGTERM) is previous
    assert out.step < 10
    assert find_latest_checkpoint(str(tmp_path), "test.transformer") is not None
    logs = (tmp_path / "test.log.jsonl").read_text().splitlines()
    assert '"preempted": 1.0' in logs[-1]


# ---------------------------------------------------------------------------
# 7. data: a store the JAX package wrote, threads, accumulation
# ---------------------------------------------------------------------------


def _write_store(writer, n_tracks, seconds=12, seed=0):
    """A token store with consistent geometry (tests/test_data.py's pattern)."""
    rng = np.random.RandomState(seed)
    sem_hz, ac_hz, win = 50, 75, 10
    for i in range(n_tracks):
        clap = rng.randint(0, 100, (seconds - win + 1, 12, 1)).astype(np.uint16)
        sem = rng.randint(0, 100, (1, seconds * sem_hz - 1)).astype(np.uint16)
        coarse = rng.randint(0, 100, (1, seconds * ac_hz, 3)).astype(np.uint16)
        fine = rng.randint(0, 100, (1, seconds * ac_hz, 5)).astype(np.uint16)
        writer.put(i, f"t{i}.wav", clap, sem, coarse, fine)


@pytest.mark.parametrize("stage", ["semantic", "coarse", "fine"])
def test_dataset_reads_a_jax_written_store(tmp_path, stage):
    _write_store(jtokenstore.writer_for_rank(str(tmp_path), 0, 1), 3)
    want = jdataset.PreprocessedDataset(folder=str(tmp_path), stage=stage, seed=5)
    got = PreprocessedDataset(folder=str(tmp_path), stage=stage, seed=5)
    assert len(got) == len(want) == 3
    for i in (0, 2, 1, 0, 2):
        for a, b in zip(got[i], want[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_batch_iterator_threads_and_accumulation(tmp_path):
    _write_store(writer_for_rank(str(tmp_path), 0, 1), 8)
    ds = PreprocessedDataset(folder=str(tmp_path), stage="coarse")
    it = batch_iterator(ds, batch_size=4, num_workers=6, seed=0)
    for _ in range(300):  # one sqlite connection per thread: no cross-thread errors
        batch = next(it)
    assert [b.shape for b in batch] == [(4, 12), (4, 199), (4, 900)]
    acc = next(accumulate_token_batches(it, 3))
    assert [tuple(t.shape) for t in acc] == [(3, 4, 12), (3, 4, 199), (3, 4, 900)]
    assert all(t.dtype == torch.long for t in acc)


# ---------------------------------------------------------------------------
# 8. config, device defaults, flops, and the package's imports
# ---------------------------------------------------------------------------

SMALL = ROOT / "configs" / "model" / "musiclm_small.json"


def test_training_config_matches_jax():
    path = str(ROOT / "configs" / "training" / "train_musiclm_fma.json")
    assert dataclasses.asdict(tconfig.load_training_config(path)) == dataclasses.asdict(
        jconfig.load_training_config(path))


def test_entry_points_default_to_the_card(monkeypatch):
    for fn in (tconfig.init_stage, tconfig.build_encodec):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mc = tconfig.load_model_config(str(SMALL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconfig.init_stage(mc, "semantic", 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconfig.build_encodec(mc)


def test_stage_kwargs_dropout():
    """Both dropouts reach the modules from the config: the shipped FF rate,
    and an attention rate no shipped config sets."""
    mc = tconfig.load_model_config(str(SMALL))
    assert tconfig._stage_kwargs(mc.coarse_cfg)["ff_dropout"] == 0.1
    kw = tconfig._stage_kwargs(dataclasses.replace(mc.coarse_cfg, attn_dropout=0.1))
    assert kw["attn_dropout"] == 0.1
    model = tconfig.build_coarse_transformer(dataclasses.replace(
        mc, coarse_cfg=dataclasses.replace(mc.coarse_cfg, attn_dropout=0.1, dim=32, depth=1, heads=2)))
    assert [a.dropout for a in model.transformer.attns] == [0.1]


def test_stage_flops_match_jax():
    jmodel = jstages.create_coarse_transformer(**TINY, semantic_codebook_size=CB,
                                               acoustic_codebook_size=CB)
    model = TokenConditionedTransformer(
        tuple(TokenSequenceSpec(s.codebook_size, s.num_quantizers) for s in jmodel.specs),
        64, 2, heads=4, dim_head=16)
    lens = (4, 6, 12)
    assert tflops.stream_positions(lens) == jflops.stream_positions(lens)
    assert tflops.stage_train_flops(model, lens, 2, 8) == jflops.stage_train_flops(jmodel, lens, 2, 8)
    assert tflops.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(KeyError):
        tflops.peak_flops("TPU v5 lite")


def test_port_imports_no_jax():
    """The training modules and chip_smoke.py import with jax, flax, optax,
    orbax and the JAX package blocked."""
    blocked = ("jax", "jaxlib", "flax", "optax", "orbax", "open_musiclm_tpu")
    code = (
        "import sys\n"
        f"for name in {blocked!r}: sys.modules[name] = None\n"
        "import open_musiclm_torch.train.trainer, open_musiclm_torch.train.flops\n"
        "import open_musiclm_torch.data.pipeline, open_musiclm_torch.data.dataset\n"
        "import open_musiclm_torch.config, open_musiclm_torch.models.musiclm\n"
        "import chip_smoke\n"
        f"assert not any(sys.modules.get(n) for n in {blocked!r})\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
