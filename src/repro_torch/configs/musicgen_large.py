"""musicgen-large [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

Backbone only (assignment): the EnCodec frontend is a stub — ``input_specs``
feeds precomputed frame embeddings (B, S, d_model); the LM head predicts the
2048-way codebook tokens.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    ffn_kind="gelu", temporal_pattern=("attn",),
    frontend="embeddings", rope_kind="none",
    source="arXiv:2306.05284; EnCodec-token decoder, frontend stubbed",
)
