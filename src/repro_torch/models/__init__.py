"""The LLM stack's models: the ``dense`` and ``ssm`` (RWKV6) families.

``params`` (ParamDef trees), ``layers`` (norms, RoPE, attention and the
KV cache, MLPs, embedding, head, chunked cross-entropy), ``rwkv6`` (the
Finch block), ``model`` (assembly, prefill, decode) and ``weights``
(carrying ``repro``'s numpy trees over).
"""
