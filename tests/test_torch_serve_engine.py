"""The port's continuous-batching engine, ``PubSubFrontend`` and data
pipeline: a copy of tests/test_serve_engine.py on ``repro_torch``, with
the port's lockdep and racedep armed (``tests/_torch_spine.py``).

The engine runs ``gemma-2b`` reduced (2 layers, d_model 64, MQA, tied and
scaled embeddings, geglu; float32) on the CPU. Beyond the reference's
cases: the port engine's tokens equal ``repro``'s engine's on ``repro``'s
parameters carried over, the data pipeline's batches equal ``repro``'s,
and the launcher answers through the bus.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401
from repro.configs import get_config as jax_get_config
from repro.data import TokenDataset as JaxTokenDataset
from repro.data import make_lm_batch as jax_make_lm_batch
from repro.models import model as JM
from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.core import SimScheduler, Subscription, Topic
from repro_torch.data import ShardQueue, TokenDataset, make_lm_batch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as M
from repro_torch.models.weights import params_from_numpy
from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                      PubSubFrontend, Request)


@pytest.fixture(scope="module")
def small_model():
    cfg = get_config("gemma-2b").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params


def _greedy_reference(cfg, params, prompt, n):
    """Token-by-token reference using prefill+decode directly."""
    logits, cache = M.prefill(params, cfg,
                              torch.from_numpy(np.asarray(prompt))[None].long(),
                              max_len=64)
    out = [int(torch.argmax(logits[0]))]
    for i in range(n - 1):
        pos = torch.tensor([len(prompt) + i], dtype=torch.int32)
        logits, cache = M.decode_step(params, cfg, cache,
                                      torch.tensor([[out[-1]]]), pos)
        out.append(int(torch.argmax(logits[0])))
    return out


def test_engine_matches_reference_single(small_model):
    cfg, params = small_model
    eng = ContinuousBatchingEngine(cfg, params, batch_size=2, max_len=64)
    prompt = np.arange(5, dtype=np.int32) % cfg.vocab_size
    results = {}
    eng.submit(Request(prompt=prompt, max_new_tokens=5,
                       done=lambda t: results.update(out=t)))
    eng.run_until_drained()
    assert results["out"] == _greedy_reference(cfg, params, prompt, 5)


def test_engine_continuous_batching_drains_backlog(small_model):
    cfg, params = small_model
    eng = ContinuousBatchingEngine(cfg, params, batch_size=2, max_len=64)
    done = []
    for i in range(5):  # 5 requests > 2 slots
        prompt = (np.arange(3 + i) * 7 + i).astype(np.int32) % cfg.vocab_size
        eng.submit(Request(prompt=prompt, max_new_tokens=3 + i,
                           done=lambda t, i=i: done.append((i, len(t)))))
    eng.run_until_drained()
    assert sorted(i for i, _ in done) == [0, 1, 2, 3, 4]
    assert all(n == 3 + i for i, n in done)


def test_batched_results_match_isolated_runs(small_model):
    """Slot packing must not leak KV between concurrent requests."""
    cfg, params = small_model
    prompts = [(np.arange(4) + s).astype(np.int32) % cfg.vocab_size
               for s in (0, 11, 23)]
    solo = [_greedy_reference(cfg, params, p, 4) for p in prompts]
    eng = ContinuousBatchingEngine(cfg, params, batch_size=3, max_len=64)
    got = {}
    for i, p in enumerate(prompts):
        eng.submit(Request(prompt=p, max_new_tokens=4,
                           done=lambda t, i=i: got.update({i: t})))
    eng.run_until_drained()
    for i in range(3):
        assert got[i] == solo[i], f"request {i} diverged under batching"


def test_pubsub_frontend_round_trip(small_model):
    cfg, params = small_model
    sched = SimScheduler()
    req_topic = Topic("inference-requests", sched)
    resp_topic = Topic("inference-responses", sched)
    responses = []
    Subscription(resp_topic, "sink",
                 lambda m, c: (responses.append(m.data), c.ack()))
    eng = ContinuousBatchingEngine(cfg, params, batch_size=2, max_len=64)
    front = PubSubFrontend(eng, req_topic, resp_topic)
    for i in range(3):
        req_topic.publish({"request_id": i,
                           "prompt": [1 + i, 2, 3],
                           "max_new_tokens": 4})
    sched.run(until=0.0)  # immediate deliveries → engine.submit
    assert len(front.sub.outstanding) == 3  # none acked before it is done
    eng.run_until_drained()  # acks cancel the (virtual-time) deadline timers
    sched.run()  # response publishes
    assert sorted(r["request_id"] for r in responses) == [0, 1, 2]
    assert all(len(r["tokens"]) == 4 for r in responses)
    assert not front.sub.outstanding and len(front.sub.acked) == 3
    assert front.sub.ack_deadline == 300.0
    for r in responses:  # each answer is the request's own greedy run
        i = r["request_id"]
        assert r["tokens"] == _greedy_reference(cfg, params, [1 + i, 2, 3], 4)


def _host(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), tree)


def test_engine_tokens_equal_repro_engine():
    """Five requests over two slots on repro's gemma-2b reduced parameters,
    carried over: the same tokens and the same number of ticks."""
    jcfg = jax_get_config("gemma-2b").reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("gemma-2b").reduced()
    params = params_from_numpy(_host(jparams), cfg, "cpu")
    rng = np.random.default_rng(5)
    lengths, max_new = [5, 11, 3, 20, 7], [4, 6, 3, 4, 5]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    runs = []
    for Engine, Req, p in ((JaxEngine, JaxRequest, jparams),
                           (ContinuousBatchingEngine, Request, params)):
        eng = Engine(cfg if p is params else jcfg, p, batch_size=2,
                     max_len=16)
        got = {}
        for i, (pr, n) in enumerate(zip(prompts, max_new)):
            eng.submit(Req(prompt=pr, max_new_tokens=n,
                           done=lambda t, i=i: got.update({i: t})))
        eng.run_until_drained()
        runs.append((got, eng.steps))
    assert runs[1] == runs[0]
    # the 20-token prompt is longer than max_len: its prefill token alone
    assert len(runs[1][0][3]) == 1


# --------------------------------------------------------------------------
# data pipeline
# --------------------------------------------------------------------------
def test_dataset_shards_are_deterministic_and_distinct():
    ds = TokenDataset(1000, 32, seed=5)
    a1 = ds.shard_batch(3, 4)
    a2 = ds.shard_batch(3, 4)
    b = ds.shard_batch(4, 4)
    assert (a1["tokens"] == a2["tokens"]).all()
    assert not (a1["tokens"] == b["tokens"]).all()
    assert (a1["labels"][:, :-1] == a1["tokens"][:, 1:]).all()
    want = JaxTokenDataset(1000, 32, seed=5).shard_batch(3, 4)
    assert all(np.array_equal(a1[k], want[k]) for k in want)


def test_make_lm_batch_equals_repro():
    cfg, jcfg = get_config("gemma-2b-smoke"), jax_get_config("gemma-2b-smoke")
    got = make_lm_batch(cfg, 2, 16, shard=3, seed=1)
    want = jax_make_lm_batch(jcfg, 2, 16, shard=3, seed=1)
    assert set(got) == set(want) == {"tokens", "labels"}
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_shard_queue_redelivers_on_worker_death():
    sched = SimScheduler()
    topic = Topic("shards", sched)
    q = ShardQueue(topic, ack_deadline=50.0)
    q.publish_epoch(5)
    sched.run()
    trained = []
    # worker processes two shards, dies holding the third (no ack)
    for _ in range(2):
        item, ack = q.poll()
        trained.append(item["shard"])
        ack()
    dead_item, _dead_ack = q.poll()  # never acked
    sched.run()  # deadline expires → redelivery
    while True:
        got = q.poll()
        if got is None:
            break
        item, ack = got
        trained.append(item["shard"])
        ack()
    sched.run()
    assert sorted(set(trained)) == [0, 1, 2, 3, 4]
    # the dead shard was re-trained exactly once after redelivery
    assert trained.count(dead_item["shard"]) >= 1


# --------------------------------------------------------------------------
# the launcher, through the bus
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kv8", [False, True], ids=["bf16_kv", "kv8"])
def test_launch_serve_phi4_smoke_on_cpu(capsys, kv8):
    argv = ["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
            "--requests", "5", "--max-new", "4"] + (["--kv8"] if kv8 else [])
    assert launch_serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "phi4-mini-3.8b-smoke" + ("+kv8" if kv8 else "") + " on cpu" in out
    assert "5/5 responses, 20 tokens" in out
