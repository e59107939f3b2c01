"""qwen2-vl-7b [arXiv:2409.12191; hf] — M-RoPE, dynamic resolution.

Backbone only (assignment): the ViT frontend is a stub — ``input_specs``
feeds precomputed patch/text embeddings (B, S, d_model) plus 3-stream M-RoPE
position ids (3, B, S).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    ffn_kind="swiglu", qkv_bias=True, temporal_pattern=("attn",),
    frontend="embeddings", rope_kind="mrope",
    source="arXiv:2409.12191; M-RoPE, ViT frontend stubbed",
)
