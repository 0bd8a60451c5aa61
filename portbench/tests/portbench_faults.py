"""The planted faults: each breaks the timed path underneath a run, where
a serving cell can have it (one card: no exchange between cards to leave
out). ``run_cell(..., inject=FAULTS[name])`` plants one."""
import torch


def _state_unchanged(system):
    """The decode step computes its logits and leaves the cache as it was:
    after each tick, every entry the step wrote is put back (a KV cache's
    entries at each slot's position, a recurrent state whole). Only those
    entries are kept aside, so the fault fits beside a cell's full cache."""
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_defs

    eng = system.engine
    defs = dict(tree_defs(M.cache_defs(eng.cfg, eng.B, eng.max_len)))

    def views():
        rows = torch.arange(eng.B, device=eng.device)
        for path, t in tree_defs(eng.cache):
            axes = defs[path].logical
            if "kvseq" in axes:
                v = t.movedim((axes.index("batch"), axes.index("kvseq")),
                              (0, 1))
                at = torch.as_tensor(eng.pos, device=eng.device).long() \
                    % v.shape[1]
                yield v, (rows, at)
            else:
                yield t, (Ellipsis,)

    def wrap(decode):
        def frozen():
            saved = [(v, ix, v[ix].clone()) for v, ix in views()]
            logits = decode()
            for v, ix, old in saved:
                v[ix] = old
            return logits
        return frozen
    system.hook("_decode", wrap)


def _half_batch(system):
    """The second half of the slots gets the first half's logits."""
    def wrap(decode):
        def halved():
            logits = decode().clone()
            half = logits.shape[0] // 2
            logits[half:] = logits[:logits.shape[0] - half]
            return logits
        return halved
    system.hook("_decode", wrap)


def _token_altered(system):
    """Every token is the next id after the one the argmax chose."""
    vocab = system.engine.cfg.vocab_size

    def wrap(greedy):
        return lambda logits: (greedy(logits) + 1) % vocab
    system.hook("_greedy", wrap)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}
