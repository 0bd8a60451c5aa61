"""Event-driven LM serving on the PyTorch/CUDA port: pub/sub request
intake → continuous batching.

    PYTHONPATH=src python examples/torch_serve_llm.py [--arch gemma-2b]
        [--requests 8] [--slots 4] [--max-new 12] [--kv8] [--device cuda]

The port's ``examples/serve_llm.py``. The serving analogue of the paper's
pipeline: requests land on a topic, the engine (an autoscalable
"container") consumes them with continuous batching over a shared KV
cache, and completions publish to a response topic. The model is the
arch's reduced (``-smoke``) config, with an int8 KV cache under
``--kv8``; its parameters are random, from a ``torch.Generator`` seeded
with 0 on the device. Everything runs on the card unless ``--device cpu``
is passed; without a card the default fails rather than running on the
CPU. Prints each response, the tokens/s and tokens per engine tick, then
"serve_llm OK" once every request has been answered.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import SimScheduler, Subscription, Topic
from repro_torch.core.clock import monotonic
from repro_torch.models import model as M
from repro_torch.serve.engine import ContinuousBatchingEngine, PubSubFrontend
from repro_torch.wsi.jpeg import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--kv8", action="store_true",
                    help="int8-quantized KV cache")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # no card: raise, never the CPU

    arch = args.arch + ("-smoke+kv8" if args.kv8 else "-smoke")
    cfg = get_config(arch)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    print(f"serving {cfg.name} on {dev}: {args.slots} slots, "
          f"kv={cfg.kv_cache_dtype}")

    sched = SimScheduler()
    req_topic = Topic("inference-requests", sched)
    resp_topic = Topic("inference-responses", sched)
    responses = []
    Subscription(resp_topic, "client",
                 lambda m, c: (responses.append(m.data), c.ack()))
    engine = ContinuousBatchingEngine(cfg, params, batch_size=args.slots,
                                      max_len=128)
    PubSubFrontend(engine, req_topic, resp_topic)

    rng = np.random.default_rng(0)
    t0 = monotonic()
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=4 + i % 5).tolist()
        req_topic.publish({"request_id": i, "prompt": prompt,
                           "max_new_tokens": args.max_new})
    sched.run(until=0.0)  # deliver requests into the engine
    engine.run_until_drained()
    sched.run()  # flush responses
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = monotonic() - t0

    total_tokens = sum(len(r["tokens"]) for r in responses)
    for r in sorted(responses, key=lambda r: r["request_id"]):
        print(f"  req {r['request_id']}: {r['tokens']}")
    print(f"{len(responses)} responses, {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens/dt:.1f} tok/s, {engine.steps} engine ticks — "
          f"{total_tokens/max(engine.steps,1):.2f} tokens/tick from batching)")
    if len(responses) != args.requests:
        print(f"serve_llm: {len(responses)} of {args.requests} requests "
              "answered", file=sys.stderr)
        return 1
    print("serve_llm OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
