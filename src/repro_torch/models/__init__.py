"""The LLM stack's models: the ``ssm`` family (RWKV6) so far.

``params`` (ParamDef trees), ``layers`` (norm, embedding, head), ``rwkv6``
(the Finch block), ``model`` (assembly, prefill, decode) and ``weights``
(carrying ``repro``'s numpy trees over).
"""
