"""Serving launcher: one continuous-batching engine on a synthetic stream.

    python -m repro_torch.launch.serve --arch rwkv6-3b [--smoke]
        [--device cuda] [--requests N] [--slots 4] [--max-new 16]
        [--max-len 128]

The request stream is ``repro.launch.serve``'s (prompts of 4–10 tokens
drawn from ``numpy.random.default_rng(0)``); the parameters are random,
from a ``torch.Generator`` seeded with 0 on the device. Requests go to the engine
directly, with no event bus, until the spine slice brings
``PubSubFrontend`` (ROADMAP A4). Prints responses, tokens, tokens/s and
tokens per decode tick; exits 0 when every request was answered.
"""
import argparse
import sys

from repro_torch.core.clock import wall_time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request
    from repro_torch.wsi.jpeg import resolve_device

    dev = resolve_device(args.device)
    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen, dev)
    engine = ContinuousBatchingEngine(cfg, params, batch_size=args.slots,
                                      max_len=args.max_len)
    out = []
    rng = np.random.default_rng(0)
    t0 = wall_time()
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=4 + i % 7)
        engine.submit(Request(prompt=prompt.astype(np.int32),
                              max_new_tokens=args.max_new, done=out.append))
    engine.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = wall_time() - t0
    toks = sum(len(t) for t in out)
    print(f"{cfg.name} on {dev}: {len(out)}/{args.requests} responses, "
          f"{toks} tokens, {toks/dt:.1f} tok/s, "
          f"{toks/max(engine.steps, 1):.2f} tokens/tick")
    return 0 if len(out) == args.requests else 1


if __name__ == "__main__":
    sys.exit(main())
