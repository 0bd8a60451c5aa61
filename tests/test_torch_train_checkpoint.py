"""Copies of ``tests/test_train_checkpoint.py`` on the port (the trainer
learns, grad accumulation, EF compression, checkpoint save / restore /
retention / resume / async), with the port's lockdep and racedep armed,
and checkpoints crossing between the packages leaf for leaf."""
import jax
import numpy as np
import torch

from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401
from _torch_train import one_torch_thread  # noqa: F401
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as jax_init_train_state
from repro.train.checkpoint import restore_checkpoint as jax_restore
from repro.train.checkpoint import save_checkpoint as jax_save
from repro_torch.comms.compress import (ef_compress, int8_dequantize,
                                        int8_quantize)
from repro_torch.configs import get_config
from repro_torch.data import TokenDataset
from repro_torch.models.params import tree_defs, tree_map
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.checkpoint import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro.configs import get_config as jax_get_config


def _cfg():
    return get_config("gemma-2b").reduced()


def _tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _init(cfg, tc, seed=0):
    return init_train_state(cfg, tc, torch.Generator().manual_seed(seed),
                            "cpu")


def _clone(state):
    return tree_map(torch.clone, state)


def test_loss_decreases_over_steps():
    cfg = _cfg()
    tc = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=60, microbatches=1)
    step = make_train_step(cfg, tc)
    state = _init(cfg, tc)
    ds = TokenDataset(cfg.vocab_size, 32, seed=0)
    losses = []
    for i in range(30):
        state, m = step(state, _tb(ds.shard_batch(i % 4, 8)))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_grad_accumulation_matches_full_batch():
    cfg = _cfg()
    b = _tb(TokenDataset(cfg.vocab_size, 32, seed=1).shard_batch(0, 8))
    tc1 = TrainConfig(microbatches=1)
    tc4 = TrainConfig(microbatches=4)
    s1 = _init(cfg, tc1, seed=1)
    s4 = _clone(s1)
    s1n, m1 = make_train_step(cfg, tc1)(s1, b)
    s4n, m4 = make_train_step(cfg, tc4)(s4, b)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 2e-2
    d = [float((a.float() - c.float()).abs().max()) for (_, a), (_, c) in
         zip(tree_defs(s1n["params"]), tree_defs(s4n["params"]))]
    assert max(d) < 2e-2


def test_int8_quantize_roundtrip_error():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 3, size=(64, 64)).astype(np.float32))
    q, s = int8_quantize(x)
    err = (int8_dequantize(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_compensates_bias():
    """Sum of EF-compressed grads tracks the sum of true grads."""
    rng = np.random.default_rng(3)
    g_true = [torch.from_numpy(rng.normal(0, 1, size=(32,)).astype(
        np.float32)) for _ in range(50)]
    ef = {"g": torch.zeros(32)}
    acc_c = torch.zeros(32)
    acc_t = torch.zeros(32)
    for g in g_true:
        cg, ef = ef_compress({"g": g}, ef)
        acc_c = acc_c + cg["g"]
        acc_t = acc_t + g
    # residual is bounded by one quantization step, not O(n) drift
    assert float((acc_c - acc_t).abs().max()) < 0.2


def test_compressed_training_still_learns():
    cfg = _cfg()
    tc = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=60,
                     compress="int8_ef")
    step = make_train_step(cfg, tc)
    state = _init(cfg, tc)
    assert "ef" in state
    ds = TokenDataset(cfg.vocab_size, 32, seed=0)
    losses = []
    for i in range(25):
        state, m = step(state, _tb(ds.shard_batch(i % 4, 8)))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.25


# --------------------------------------------------------------------------
# checkpointing
# --------------------------------------------------------------------------
def _equal(a, b) -> bool:
    pa, pb = dict(tree_defs(a)), dict(tree_defs(b))
    return pa.keys() == pb.keys() and all(
        pa[k].dtype == pb[k].dtype and torch.equal(pa[k], pb[k]) for k in pa)


def test_checkpoint_roundtrip(tmp_path):
    cfg = _cfg()
    tc = TrainConfig()
    state = _init(cfg, tc)
    save_checkpoint(tmp_path, 7, state)
    assert latest_step(tmp_path) == 7
    restored, step = restore_checkpoint(tmp_path, state, device="cpu")
    assert step == 7
    assert _equal(state, restored)


def test_checkpoint_retention_and_latest(tmp_path):
    cfg = _cfg()
    tc = TrainConfig()
    state = _init(cfg, tc)
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, s, state, keep=2)
    dirs = sorted(p.name for p in tmp_path.glob("step_*"))
    assert dirs == ["step_00000004", "step_00000005"]
    assert latest_step(tmp_path) == 5


def test_training_resumes_identically(tmp_path):
    cfg = _cfg()
    tc = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    step = make_train_step(cfg, tc)
    ds = TokenDataset(cfg.vocab_size, 32, seed=0)
    state = _init(cfg, tc)
    for i in range(4):
        state, _ = step(state, _tb(ds.shard_batch(i, 4)))
    save_checkpoint(tmp_path, 4, state)
    state_a = _clone(state)
    for i in range(4, 8):
        state_a, ma = step(state_a, _tb(ds.shard_batch(i, 4)))
    # "crash" and restart from disk
    state_b, _ = restore_checkpoint(tmp_path, state, device="cpu")
    for i in range(4, 8):
        state_b, mb = step(state_b, _tb(ds.shard_batch(i, 4)))
    assert abs(float(ma["loss"]) - float(mb["loss"])) < 1e-5


def test_async_checkpointer(tmp_path):
    cfg = _cfg()
    tc = TrainConfig()
    state = _init(cfg, tc)
    ck = AsyncCheckpointer(tmp_path)
    ck.save(11, state)
    ck.wait()
    assert latest_step(tmp_path) == 11


def test_async_checkpointer_snapshots_at_save(tmp_path):
    """The state written is the one at ``save()``: a step that updates the
    parameters in place while the writer runs does not reach the file."""
    cfg = _cfg()
    tc = TrainConfig()
    state = _init(cfg, tc)
    want = _clone(state)
    ck = AsyncCheckpointer(tmp_path)
    ck.save(3, state)
    tree_map(lambda t: t.add_(1), state["params"])
    ck.wait()
    restored, _ = restore_checkpoint(tmp_path, state, device="cpu")
    assert _equal(restored, want)


# --------------------------------------------------------------------------
# checkpoints across the packages
# --------------------------------------------------------------------------
def _jax_leaves(tree) -> dict:
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> dict:
    return {"/".join(path): t for path, t in tree_defs(tree)}


def _same_leaves(port_tree, jax_tree) -> None:
    got, want = _port_leaves(port_tree), _jax_leaves(jax_tree)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if g.dtype == torch.bfloat16:  # compare the bits
            assert w.dtype.name == "bfloat16", k
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  w.view(np.int16)), k
        else:
            assert g.numpy().dtype == w.dtype, k
            assert np.array_equal(g.numpy(), w), k


def test_port_checkpoint_restores_in_reference(tmp_path):
    cfg = _cfg()
    tc = TrainConfig(compress="int8_ef")
    state = _init(cfg, tc, seed=2)
    state, _ = make_train_step(cfg, tc)(
        state, _tb(TokenDataset(cfg.vocab_size, 16, seed=0).shard_batch(0, 2)))
    save_checkpoint(tmp_path, 1, state)
    jcfg = jax_get_config("gemma-2b").reduced()
    like = jax_init_train_state(jcfg, JTrainConfig(compress="int8_ef"),
                                jax.random.PRNGKey(0))
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), like)
    restored, step = jax_restore(tmp_path, abstract)
    assert step == 1
    _same_leaves(state, restored)


def test_reference_checkpoint_restores_in_port(tmp_path):
    jcfg = jax_get_config("gemma-2b").reduced()
    jstate = jax_init_train_state(jcfg, JTrainConfig(compress="int8_ef"),
                                  jax.random.PRNGKey(3))
    jax_save(tmp_path, 9, jstate)
    cfg = _cfg()
    like = _init(cfg, TrainConfig(compress="int8_ef"))
    restored, step = restore_checkpoint(tmp_path, like, device="cpu")
    assert step == 9
    _same_leaves(restored, jstate)
