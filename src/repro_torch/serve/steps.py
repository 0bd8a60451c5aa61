"""Serving-step builders (prefill / decode), a copy of
``repro.serve.steps``: the steps the dry run counts
(``launch.dryrun``)."""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.params import ParamDef

__all__ = ["make_prefill_step", "make_decode_step", "decode_input_defs",
           "prefill_input_defs"]


def make_prefill_step(cfg, max_len: int | None = None):
    """step(params, tokens[, cond]) -> (last_logits, cache)."""

    if cfg.family in ("vlm", "audio"):
        def step(params, tokens, cond):
            return M.prefill(params, cfg, tokens, cond=cond, max_len=max_len)
    else:
        def step(params, tokens):
            return M.prefill(params, cfg, tokens, max_len=max_len)
    return step


def make_decode_step(cfg):
    """step(params, cache, token, pos) -> (logits, cache); the cache is
    written in place (``M.decode_step``)."""

    def step(params, cache, token, pos):
        return M.decode_step(params, cfg, cache, token, pos)

    return step


def prefill_input_defs(cfg, batch: int, seq_len: int) -> dict:
    d = {"tokens": ParamDef((batch, seq_len), ("batch", "seq"),
                            dtype=torch.int32)}
    if cfg.family in ("vlm", "audio"):
        d["cond"] = ParamDef(
            (batch, cfg.n_cross_tokens, cfg.d_model), ("batch", "", "embed"),
            dtype=cfg.dtype,
        )
    return d


def decode_input_defs(cfg, batch: int) -> dict:
    return {
        "token": ParamDef((batch, 1), ("batch", ""), dtype=torch.int32),
        "pos": ParamDef((batch,), ("batch",), dtype=torch.int32),
    }
