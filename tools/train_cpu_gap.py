"""How far a float32 train step of ``rwkv6-3b`` on the card parts from the
CPU's, by batch.

At 2 layers of the full width (chip_smoke's 13b cut), for one microbatch
of each of ``BATCHES``: ``chip_smoke._train_cpu_gap`` (the card's step, the
wkv kernel through ``WkvChunk``, against the CPU's: the loss, each
gradient leaf as max|Δ| / max|CPU leaf|, the parameters beyond the
per-element rule), then the gradients with the plain wkv on the card
against the CPU's (``plain_vs_cpu``: what the card parts by without the
kernel), the kernel's against the plain wkv's on the card
(``kernel_vs_plain``), and the plain wkv's on the card with every
parameter scaled by 1 + 2^-24·N(0, 1) (``perturbed``: how far a
last-bit change of the inputs moves the gradients), each leaf's
max|Δ| / max|leaf|. Needs one CUDA card; run from the root of a
checkout:

    python3 tools/train_cpu_gap.py

Prints one JSON object and the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCHES = ((1, 512), (2, 512))


def _grads(params, cfg, b, device, impl: str) -> dict:
    import torch

    from repro_torch.models import model as M
    from repro_torch.models.params import tree_defs
    from repro_torch.train.step import _unflatten

    paths, leaves = zip(*((p, t.detach().requires_grad_())
                          for p, t in tree_defs(params)))
    batch = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
    with torch.enable_grad():
        loss = M.lm_loss(_unflatten(paths, leaves), cfg, batch, impl=impl)
        g = torch.autograd.grad(loss, leaves)
    return {"/".join(p): x.to("cuda") for p, x in zip(paths, g)}


def _rel(got: dict, want: dict) -> dict:
    return {k: float((got[k] - w).abs().max() / w.abs().max())
            for k, w in want.items()}


def train_cpu_gap(seed: int = 0) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_defs, tree_map

    full = get_config("rwkv6-3b")
    cfg = dataclasses.replace(full, num_layers=cs.TRAIN_CHECK_LAYERS,
                              dtype=torch.float32)
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    card = tree_map(lambda t: t.float(), M.init_params(cfg, gen, dev))
    host = tree_map(lambda t: t.to(cpu, copy=True), card)
    pert = tree_map(lambda t: t.clone(), card)
    noise = torch.Generator(device=dev).manual_seed(seed + 99)
    for _, t in tree_defs(pert):
        t.mul_(1 + 2.0 ** -24 * torch.randn(t.shape, generator=noise,
                                            device=dev))
    out = {}
    for B, S in BATCHES:
        step = cs._train_cpu_gap(seed, (B, S))
        b = TokenDataset(cfg.vocab_size, S, seed=seed).shard_batch(0, B)
        on_cpu = _grads(host, cfg, b, cpu, "auto")
        plain = _grads(card, cfg, b, dev, "ref")
        kernel = _grads(card, cfg, b, dev, "auto")
        perturbed = _grads(pert, cfg, b, dev, "ref")
        rows = dict(kernel_vs_cpu=step["grad_rel"],
                    plain_vs_cpu=_rel(plain, on_cpu),
                    kernel_vs_plain=_rel(kernel, plain),
                    perturbed=_rel(perturbed, plain))
        out[f"{B}x{S}"] = dict(
            worst=step["worst"], loss=step["loss"],
            grad_norm=float(sum((g.double() ** 2).sum()
                                for g in on_cpu.values()) ** 0.5),
            leaf_max={k: float(g.abs().max()) for k, g in on_cpu.items()},
            **{k: dict(worst=max(v.values()), median=sorted(v.values())[
                len(v) // 2], by_leaf=v) for k, v in rows.items()})
        del on_cpu, plain, kernel, perturbed
        cs._free()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_cpu_gap: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch.kernels import _build
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(train_cpu_gap()))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
