"""The port's hybrid family (zamba2: a Mamba2 backbone with a weight-shared
attention+MLP block before each group of layers) against ``repro``'s, on
the CPU: the checks and bounds of test_torch_families.py
(_torch_families.py) on the reduced ``zamba2-1.2b``, and ``+kv8``'s
refusal (ROADMAP F12).

``repro`` builds the hybrid's shared-block cache as int8 without scales
under ``+kv8`` and casts bf16 K/V to it by truncation; the port refuses
the variant in ``get_config`` and an int8 hybrid config in ``cache_defs``.
"""
import dataclasses

import pytest

from _torch_families import check_engine_tokens, check_model
from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.models import model as M

# (config changes, prompt length): 37 tokens run Mamba2's one-chunk
# fallback, 128 two chunks of 64; 4 layers are groups [2, 2], 5 layers
# [2, 2, 1] (three shared-block applications)
CASES = {
    "one_chunk": ({}, 37),
    "chunks": ({}, 128),
    "5L": ({"num_layers": 5}, 37),
}


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_jax(case):
    check_model("zamba2-1.2b", *CASES[case], kv8=False)


@pytest.mark.parametrize("layers,groups", [(4, [2, 2]), (5, [2, 2, 1]),
                                           (1, [1])])
def test_zamba_groups_equal_repro(layers, groups):
    jcfg = dataclasses.replace(jax_get_config("zamba2-1.2b-smoke"),
                               num_layers=layers)
    cfg = dataclasses.replace(get_config("zamba2-1.2b-smoke"),
                              num_layers=layers)
    assert M.zamba_groups(cfg) == JM.zamba_groups(jcfg) == groups
    assert M.zamba_groups(get_config("zamba2-1.2b")) == [6] * 6 + [2]
    cache, jcache = M.cache_defs(cfg, 2, 16), JM.cache_defs(jcfg, 2, 16)
    assert cache["shared_k"].shape == jcache["shared_k"].shape == \
        (len(groups), 2, 16, cfg.num_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("name", ["zamba2-1.2b-smoke+kv8", "zamba2-1.2b+kv8",
                                  "zamba2-1.2b+ac512+kv8"])
def test_kv8_is_refused(name):
    assert jax_get_config(name).kv_cache_dtype == "int8"  # repro resolves it
    with pytest.raises(ValueError, match="no scaled int8 KV cache"):
        get_config(name)
    with pytest.raises(ValueError, match="F12"):
        M.cache_defs(dataclasses.replace(get_config("zamba2-1.2b-smoke"),
                                         kv_cache_dtype="int8"), 2, 64)


def test_engine_tokens_equal_repro_engine():
    check_engine_tokens("zamba2-1.2b")
