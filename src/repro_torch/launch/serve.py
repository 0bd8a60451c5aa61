"""Serving launcher: event-driven continuous-batching engine.

    python -m repro_torch.launch.serve --arch <id> [--smoke] [--kv8]
        [--device cuda] [--requests N] [--slots 4] [--max-new 16]
        [--max-len 128]

The production shape, as ``repro.launch.serve`` runs it: a request topic
feeds engine replicas (each the analogue of one autoscaled container);
this launcher runs one replica behind ``PubSubFrontend`` on a
``SimScheduler``, publishes a synthetic request stream (prompts of 4–10
tokens drawn from ``numpy.random.default_rng(0)``) and collects the
answers from the response topic through a client subscription. The
parameters are random, from a ``torch.Generator`` seeded with 0 on the
device. Every arch of ``repro_torch.configs`` resolves, and the vlm and
audio families are conditioned on zeros, as the engine does. Prints
responses, tokens, tokens/s and tokens per decode tick; exits 0 when
every request was answered.
"""
import argparse
import sys

from repro_torch.core.clock import wall_time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--kv8", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import SimScheduler, Subscription, Topic
    from repro_torch.models import model as M
    from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                          PubSubFrontend)
    from repro_torch.wsi.jpeg import resolve_device

    dev = resolve_device(args.device)
    name = args.arch + ("-smoke" if args.smoke else "") + \
        ("+kv8" if args.kv8 else "")
    cfg = get_config(name)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    sched = SimScheduler()
    req, resp = Topic("requests", sched), Topic("responses", sched)
    out = []
    Subscription(resp, "client", lambda m, c: (out.append(m.data), c.ack()))
    engine = ContinuousBatchingEngine(cfg, params, batch_size=args.slots,
                                      max_len=args.max_len)
    PubSubFrontend(engine, req, resp)

    rng = np.random.default_rng(0)
    t0 = wall_time()
    for i in range(args.requests):
        req.publish({"request_id": i,
                     "prompt": rng.integers(0, cfg.vocab_size,
                                            size=4 + i % 7).tolist(),
                     "max_new_tokens": args.max_new})
    sched.run(until=0.0)  # immediate deliveries → engine.submit
    engine.run_until_drained()  # acks cancel the deadline timers
    sched.run()  # response publishes
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = wall_time() - t0
    toks = sum(len(r["tokens"]) for r in out)
    print(f"{cfg.name} on {dev}: {len(out)}/{args.requests} responses, "
          f"{toks} tokens, {toks/dt:.1f} tok/s, "
          f"{toks/max(engine.steps, 1):.2f} tokens/tick")
    return 0 if len(out) == args.requests else 1


if __name__ == "__main__":
    sys.exit(main())
