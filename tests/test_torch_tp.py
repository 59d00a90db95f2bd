"""Port parity, tensor parallelism: open_musiclm_torch.parallel.sharding
(the rule table, shard_module, the whole checkpoint), the tensor-parallel
layers of the transformer (column- and row-parallel attention and conv-FF,
the LayerNorm over split channels, vocab-parallel embeddings and logit
heads), StageTrainer on a ``tp`` mesh and the fp decode on a shard, on the
CPU.

The ranks are spawned gloo processes (tests/torch_dp_workers.py:tp_rank)
joining through a ``file://`` store: tp=2 on two ranks and dp=2 x tp=2 on
four, each spawn running several checks. The stage is small (dim 64, so the
conv-FF's 170 channels split into 85, an odd width; 4 heads of 16, 2 a
rank; the final sequence's 15 codes plus EOS, so its logit head splits,
while the first sequence's 17 do not) and starts from JAX-initialised
weights carried across by convert.py. Losses are held to the JAX package's
StageTrainer on ``make_mesh(dp=4, tp=2)`` of the conftest's virtual CPU
devices within rtol 2e-4 (tests/test_tp_sharding.py's limit), parameters to
a one-process port run within 1e-5 x the tensor's max|p|. As in
tests/test_torch_parallel.py Adam's eps is 1e-2 on every side, so that an
element whose gradient is rounding noise moves by ~lr x 1e-5; the rel-pos
MLP's output bias, whose true gradient is 0 (it shifts a whole score row),
is scaled by its output weight, as chip_smoke.py does.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from open_musiclm_tpu.core.sequence import TokenSequenceSpec as JSpec
from open_musiclm_tpu.models.token_cond import StageLossConfig as JLossConfig
from open_musiclm_tpu.models.token_cond import TokenConditionedTransformer as JTCT
from open_musiclm_tpu.models.token_cond import generate as j_generate
from open_musiclm_tpu.parallel.mesh import MODEL_AXIS
from open_musiclm_tpu.parallel.mesh import make_mesh as jmake_mesh
from open_musiclm_tpu.parallel.sharding import param_shardings, shard_params
from open_musiclm_tpu.train.optimizer import make_optimizer
from open_musiclm_tpu.train.trainer import StageTrainer as JStageTrainer

from open_musiclm_torch.convert import stage_state_dict
from open_musiclm_torch.core.sequence import TokenSequenceSpec
from open_musiclm_torch.models.token_cond import StageLossConfig, generate
from open_musiclm_torch.parallel.mesh import Mesh
from open_musiclm_torch.parallel.sharding import put_together, shard_plan, take
from open_musiclm_torch.train.trainer import StageTrainer

from tests.torch_dp_workers import join_ranks, start_ranks, tp_rank, tp_stage
from tests.torch_threads import one_torch_thread  # noqa: F401

CODES = (16, 15)  # the conditioning and final sequences' codebooks
GEOMETRY = dict(specs=(TokenSequenceSpec(CODES[0], 2), TokenSequenceSpec(CODES[1], 1)), dim=64, depth=2,
                heads=4, dim_head=16)
WEIGHTS = (0.5, 1.0)
HP = dict(lr=1e-3, wd=1e-2, lr_warmup=2, max_grad_norm=0.5, grad_accum_every=2,
          loss_cfg=StageLossConfig(WEIGHTS, mask_prob=0.0))
EPS = 1e-2
TOL = 1e-5
# the documented differences from the JAX rules: to_kv stays whole (one
# K/V head); conv_w and norm_mid follow proj_in's channels
DIFFER = {"to_kv.weight": (0, None), "conv_w": (None, 1), "norm_mid.gamma": (None, 0)}


def _jax_stage():
    jmodel = JTCT(specs=(JSpec(CODES[0], 2), JSpec(CODES[1], 1)), dim=64, depth=2, heads=4, dim_head=16)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(3), [jnp.zeros((1, 6), jnp.int32),
                                                           jnp.zeros((1, 8), jnp.int32)])
    return jmodel, jparams


def _batches(seed, steps, accum=2, batch=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        cond = rng.integers(0, CODES[0], (accum, batch, 6)).astype(np.int64)
        cond[:, 0, -1] = -1
        pred = rng.integers(0, CODES[1], (accum, batch, 8)).astype(np.int64)
        out.append((torch.from_numpy(cond), torch.from_numpy(pred)))
    return out


def _one_process(sd, batches, *, dropout=0.0, seed=None, folder):
    model = tp_stage(dropout=dropout, **GEOMETRY)
    model.load_state_dict(sd)
    hp = dict(HP, loss_cfg=StageLossConfig(WEIGHTS, mask_prob=0.15)) if dropout else HP
    trainer = StageTrainer(model=model, results_folder=str(folder), stage_name="one", use_tensorboard=False,
                           save_model_every=0, **hp)
    state = trainer.init_state()
    state.optimizer.eps = EPS
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    losses = []
    for b in batches:
        state, loss = trainer.train_step(state, b, gen)
        losses.append(loss.item())
    return losses, model.state_dict()


def _params_close(got, want, what):
    for name, p in want.items():
        scale = want["transformer.rel_pos_bias.out_layer.weight"] if name.endswith("out_layer.bias") else p
        err = (got[name] - p).abs().max().item() / max(scale.abs().max().item(), 1e-30)
        assert got[name].shape == p.shape and err <= TOL, f"{what}: {name} differs by {err:.2e} x max|p|"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tp=2 and dp=2 x tp=2 ranks, the one-process port runs and the
    JAX package's tp trainer and sharded decode, once for the module."""
    tmp = tmp_path_factory.mktemp("tp")
    jmodel, jparams = _jax_stage()
    host = jax.device_get(jparams)  # the JAX trainer donates its params
    sd = stage_state_dict(host, 2, jmodel.depth)
    rng = np.random.default_rng(11)
    cond = torch.from_numpy(rng.integers(0, CODES[0], (8, 6)).astype(np.int64))
    inputs = dict(geometry=GEOMETRY, state_dict=sd, hp=HP, eps=EPS, tp=2, batches=_batches(0, 3),
                  dropout_batches=_batches(5, 2), dropout_seed=7,
                  dropout_loss_cfg=StageLossConfig(WEIGHTS, mask_prob=0.15), cond=cond, decode_steps=4,
                  teacher=torch.from_numpy(rng.integers(0, CODES[1], (8, 4)).astype(np.int64)))
    procs = []
    for world in (2, 4):
        folder = tmp / f"w{world}"
        folder.mkdir()
        torch.save(inputs, folder / "inputs.pt")
        procs.append(start_ranks(tp_rank, world, (str(folder / "store"), str(folder))))
    try:
        out = {}
        out["one"] = _one_process(sd, inputs["batches"], folder=tmp / "one")
        out["one_step"] = _one_process(sd, inputs["batches"][:1], folder=tmp / "one1")
        out["one_dropout"] = _one_process(sd, inputs["dropout_batches"], dropout=0.1, seed=7, folder=tmp / "oned")
        model = tp_stage(**GEOMETRY)
        model.load_state_dict(sd)
        kw = dict(max_time_steps=4, temperature=0.0)
        out["one_logits"] = generate(model.eval(), [cond], teacher_ids=inputs["teacher"], return_logits=True,
                                     **kw)[1]
        # the JAX package's tp trainer and its decode on tp-sharded params
        jtrainer = JStageTrainer(model=jmodel, loss_cfg=JLossConfig(WEIGHTS, mask_prob=0.0),
                                 mesh=jmake_mesh(dp=4, tp=2), use_tensorboard=False,
                                 results_folder=str(tmp / "jax"),
                                 **{k: v for k, v in HP.items() if k != "loss_cfg"})
        jtrainer.optimizer = make_optimizer(1e-3, 1e-2, warmup_steps=2, max_grad_norm=0.5, eps=EPS)
        jstate = jtrainer.init_state(jparams)
        jlosses = []
        for step, b in enumerate(inputs["batches"]):
            jstate, loss = jtrainer.train_step(jstate, tuple(jnp.asarray(t.numpy().astype(np.int32)) for t in b),
                                               jax.random.PRNGKey(step))
            jlosses.append(float(loss))
        out["jax_losses"] = jlosses
        jtrainer.save(jstate, int(jstate.step))  # an orbax TrainState for the ranks and one process to resume
        jax_dir = jtrainer.checkpoint_path(int(jstate.step))
        (tmp / "jax_saved.tmp").write_text(jax_dir)
        (tmp / "jax_saved.tmp").rename(tmp / "jax_saved")
        model = tp_stage(**GEOMETRY)
        model.load_state_dict(sd)
        state = StageTrainer(model=model, results_folder=str(tmp / "one_jax"), stage_name="tp",
                             use_tensorboard=False, save_model_every=0, **HP).load(jax_dir)
        out["one_jax"] = (state.step, {k: v.clone() for k, v in model.state_dict().items()},
                          [m.clone() for m in state.optimizer.mu])
        mesh = jmake_mesh(dp=4, tp=2)
        fn = jax.jit(lambda p, c, k: j_generate(jmodel, p, [c], k, max_time_steps=4, temperature=0.0))
        out["jax_tokens"] = np.asarray(fn(shard_params(mesh, host),
                                          jax.device_put(jnp.asarray(cond.numpy().astype(np.int32)),
                                                         NamedSharding(mesh, P("dp", None))),
                                          jax.random.PRNGKey(2)))
    finally:
        for world, p in zip((2, 4), procs):
            join_ranks(p, timeout=240)
    for world in (2, 4):
        out[world] = [torch.load(tmp / f"w{world}" / f"rank{r}.pt", weights_only=False) for r in range(world)]
    return out


def test_rule_table_splits_what_jax_shards():
    """For every parameter of the stage, the port's split dim equals the
    dim JAX's param_shardings shards at make_mesh(dp=4, tp=2) (read
    through convert.py: each JAX leaf carries its index along the sharded
    axis), but for the documented differences."""
    jmodel, jparams = _jax_stage()
    shardings = param_shardings(jmake_mesh(dp=4, tp=2), jparams)

    def marked(leaf, sharding):
        axes = [i for i, name in enumerate(sharding.spec) if name == MODEL_AXIS]
        if not axes:
            return np.zeros(leaf.shape, np.float32)
        shape = [1] * leaf.ndim
        shape[axes[0]] = leaf.shape[axes[0]]
        return np.broadcast_to(np.arange(leaf.shape[axes[0]], dtype=np.float32).reshape(shape), leaf.shape).copy()

    sd = stage_state_dict(jax.tree_util.tree_map(marked, jax.device_get(jparams), shardings), 2, jmodel.depth)
    model = tp_stage(**GEOMETRY)
    splits, partial = shard_plan(model, 2)
    seen = set()
    for name, p in model.named_parameters():
        v = sd[name].numpy()
        varies = [a for a in range(v.ndim) if v.shape[a] > 1 and np.ptp(v, axis=a).max() > 0]
        jax_dim = varies[0] if varies else None
        port_dim = splits[name].dim if name in splits else None
        key = next((k for k in DIFFER if name.endswith(k)), None)
        if key is not None:
            assert (jax_dim, port_dim) == DIFFER[key], name
            seen.add(key)
        else:
            assert jax_dim == port_dim, f"{name}: JAX shards dim {jax_dim}, the port {port_dim}"
    assert seen == set(DIFFER)
    assert splits["transformer.ffs.0.proj_in.weight"].paired and splits["transformer.ffs.0.conv_w"].paired
    # 17 codes (16 + EOS) do not split over 2; 34 embedding rows do
    assert "logit_heads.0" not in splits and "logit_heads.1" in splits and "embeds.0.weight" in splits
    assert {n for n in partial if "rel_pos" not in n} == {
        f"transformer.{p}" for l in range(2) for p in (
            f"attns.{l}.norm.gamma", f"attns.{l}.to_kv.weight", f"attns.{l}.q_scale", f"attns.{l}.k_scale",
            f"ffs.{l}.norm_in.gamma")}


@pytest.mark.parametrize("paired", [False, True])
def test_take_and_put_together_invert(paired):
    from open_musiclm_torch.parallel.sharding import Split

    full = torch.arange(3 * 12.0).reshape(3, 12)
    rule = Split(1, paired)
    parts = [take(full, rule, t, 3) for t in range(3)]
    assert torch.equal(put_together(parts, rule), full)
    if paired:  # rank t: its slice of each half
        assert parts[1].tolist()[0] == [2.0, 3.0, 8.0, 9.0]


def test_tp_ranks_know_their_place(runs):
    assert [r["place"] for r in runs[2]] == [(0, 1, 0, 2, True), (0, 1, 1, 2, False)]
    assert [r["place"] for r in runs[4]] == [(0, 2, 0, 2, True), (0, 2, 1, 2, False), (1, 2, 0, 2, False),
                                             (1, 2, 1, 2, False)]
    shapes = runs[2][0]["shapes"]
    assert shapes["transformer.attns.0.to_q.weight"] == (32, 64)
    assert shapes["transformer.attns.0.to_kv.weight"] == (32, 64)
    assert shapes["transformer.attns.0.to_out.weight"] == (64, 32)
    assert shapes["transformer.ffs.0.proj_in.weight"] == (170, 64)
    assert shapes["transformer.ffs.0.norm_mid.gamma"] == (85,)
    assert shapes["embeds.0.weight"] == (17, 64) and shapes["logit_heads.1"] == (1, 8, 64)


@pytest.mark.parametrize("remat", [0, 1])
def test_tp_training_matches_jax_and_one_process(runs, remat):
    """3 steps at b4 x accum 2 on tp=2: the losses within rtol 2e-4 of JAX's
    tp trainer (and 1e-5 of one process), the gathered parameters within
    1e-5 x max|p| of one process, the same on both ranks."""
    one_losses, one_params = runs["one"]
    for r, rank in enumerate(runs[2]):
        losses, params = rank[f"remat{remat}"]
        np.testing.assert_allclose(losses, runs["jax_losses"], rtol=2e-4)
        np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
        _params_close(params, one_params, f"rank {r} remat={remat}")


def test_tp_dropout_equals_one_process(runs):
    """ff_dropout 0.1 and the forgetful mask (0.15) from one generator seed,
    under remat: tp=2 draws what one process draws."""
    one_losses, one_params = runs["one_dropout"]
    for r, rank in enumerate(runs[2]):
        losses, params = rank["dropout"]
        np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
        _params_close(params, one_params, f"rank {r} with dropout")


def test_tp_checkpoint_is_whole_and_resumes(runs):
    """Rank (0, 0) writes the whole checkpoint; both ranks read it back into
    a new shard: the same whole parameters and their own moments."""
    for rank in runs[2]:
        step, params, mu, mu_before = rank["restored"]
        assert step == 3
        for name, p in rank["remat0"][1].items():
            assert torch.equal(params[name], p), name
        assert all(torch.equal(a, b) for a, b in zip(mu, mu_before))


def test_tp_resumes_a_jax_checkpoint(runs):
    """Both tp ranks read the JAX dp=4 x tp=2 trainer's orbax TrainState
    (three steps) into a new shard: the whole parameters and adam's mu,
    gathered, equal one process's StageTrainer.load of the directory."""
    step, params, mu = runs["one_jax"]
    assert step == 3
    for rank in runs[2]:
        got_step, got_params, got_mu = rank["restored_jax"]
        assert got_step == 3
        for name, p in params.items():
            assert torch.equal(got_params[name], p), name
        assert len(got_mu) == len(mu) and all(torch.equal(a, b) for a, b in zip(got_mu, mu))


def test_dp_tp_step_equals_one_process(runs):
    """One step of dp=2 x tp=2 on four ranks (b2 a dp rank) against one
    process on the whole batch."""
    one_losses, one_params = runs["one_step"]
    for r, rank in enumerate(runs[4]):
        losses, params = rank["step"]
        np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
        _params_close(params, one_params, f"rank {r} of dp=2 x tp=2")


def test_tp_decode_tokens_match_jax(runs):
    """Greedy fp decode on the tp=2 shard: the tokens of JAX's generate on
    shard_params params (tests/test_sharded_generate.py's check)."""
    for rank in runs[2]:
        np.testing.assert_array_equal(rank["tokens"].numpy(), runs["jax_tokens"])


def test_tp_decode_logits_equal_one_process(runs):
    """4 teacher-forced fp decode steps on the shard: the gathered logits
    within 1e-5 x max|logit| of one process's."""
    want = runs["one_logits"]
    for rank in runs[2]:
        err = (rank["logits"] - want).abs().max().item() / want.abs().max().item()
        assert rank["logits"].shape == want.shape == (8, 4, CODES[1] + 1) and err <= TOL, err


def test_one_process_mesh_shards_nothing():
    """shard_module on a one-process mesh leaves the model whole."""
    from open_musiclm_torch.parallel.sharding import shard_module

    model = tp_stage(**GEOMETRY)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    shard_module(model, Mesh())
    assert model.tp_mesh is None
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_tensor_parallel_modules_import_no_jax():
    """parallel/sharding.py, the models it splits and the rank processes'
    module import with jax, flax, optax, orbax and the JAX package blocked."""
    import subprocess
    import sys

    blocked = ("jax", "jaxlib", "flax", "optax", "orbax", "open_musiclm_tpu")
    code = (
        "import sys\n"
        f"for name in {blocked!r}: sys.modules[name] = None\n"
        "import open_musiclm_torch.parallel.sharding, open_musiclm_torch.parallel.mesh\n"
        "import open_musiclm_torch.models.stages, open_musiclm_torch.models.musiclm\n"
        "import open_musiclm_torch.train.trainer, tests.torch_dp_workers\n"
        f"assert not any(sys.modules.get(n) for n in {blocked!r})\n"
    )
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
