"""The port's engine and launcher on the moe, vlm and audio families, on
the CPU (the hybrid's engine case is in test_torch_hybrid.py).

The engines' greedy tokens on ``repro``'s reduced parameters carried over
must equal ``repro``'s engine's, with the same number of ticks. Near-tie
rule (_torch_families.py): tokens may part only at a step where
``repro``'s logits have a top-2 gap below ``TIE_GAP`` = 1e-4 (5×
``MODEL_BOUND`` = 2e-5 times the largest logit, ~1; a flipped expert
choice in the moe family shows in the logits). None parts at these seeds.
Both engines condition vlm and audio on zeros (the reference's stub
frontend).
"""
import numpy as np
import pytest
import torch

from _torch_families import check_engine_tokens
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as M
from repro_torch.serve.engine import ContinuousBatchingEngine, Request


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama-3.2-vision-11b",
                                  "musicgen-large"])
def test_engine_tokens_equal_repro_engine(arch):
    check_engine_tokens(arch)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-large"])
def test_engine_conditions_on_zeros(arch):
    """The engine's first token is the prefill's argmax with a zero cond
    of (1, n_cross_tokens, d_model); its cross K/V land in the slot."""
    cfg = get_config(arch + "-smoke")
    params = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    prompt = np.arange(6, dtype=np.int32)
    cond = torch.zeros((1, cfg.n_cross_tokens, cfg.d_model))
    logits, cache = M.prefill(params, cfg, torch.from_numpy(prompt)[None]
                              .long(), cond=cond, max_len=32)
    eng = ContinuousBatchingEngine(cfg, params, batch_size=2, max_len=32,
                                   greedy=True)
    got = {}
    eng.submit(Request(prompt=prompt, max_new_tokens=1,
                       done=lambda t: got.update(out=t)))
    assert torch.equal(eng.cache["cross_k"][:, 0], cache["cross_k"][:, 0])
    eng.run_until_drained()
    assert got["out"] == [int(torch.argmax(logits[0]))]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mixtral-8x22b",
                                  "zamba2-1.2b", "llama-3.2-vision-11b",
                                  "musicgen-large"])
def test_launch_serve_smoke_on_cpu(capsys, arch):
    """Every new arch serves through the bus; ``--kv8`` is refused for the
    hybrid family (F12: no scaled int8 cache for its shared block)."""
    assert launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert f"{arch}-smoke on cpu: 3/3 responses, 9 tokens" in out
    if get_config(arch).family == "hybrid":
        with pytest.raises(ValueError, match="int8"):
            launch_serve.main(["--arch", arch, "--smoke", "--kv8",
                               "--device", "cpu"])
