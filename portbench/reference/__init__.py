"""Plain float32 PyTorch forwards, one module a model family.

Each module gives ``layout(model)``: the parameter leaves, in the
serving program's tree layout, with the rule each is drawn by
(``common.Leaf``), and ``logits(params, model, tokens, start, prec=)``:
the float32 logits at positions ``start .. len(tokens) - 1`` of one
sequence. ``model`` is a configuration file's dict. Nothing here imports
the program: the references are written from the published equations and
are what the program's outputs are held to.
"""
