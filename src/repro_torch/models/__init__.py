"""The LLM stack's models: the dense, moe, ssm (RWKV6), hybrid (zamba2),
vlm and audio families.

``params`` (ParamDef trees), ``layers`` (norms, RoPE, self- and
cross-attention and the KV cache, MLPs, embedding, head, chunked
cross-entropy), ``moe`` (the top-k expert FFN), ``mamba2`` (the SSD mixer),
``rwkv6`` (the Finch block), ``model`` (assembly, prefill, decode) and
``weights`` (carrying ``repro``'s numpy trees over).
"""
