"""gemma-7b [arXiv:2403.08295; hf] — GeGLU, head_dim=256."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
    head_dim=256, d_ff=24576, vocab_size=256000,
    ffn_kind="geglu", temporal_pattern=("attn",),
    tie_embeddings=True,
    source="arXiv:2403.08295; GeGLU, head_dim=256",
)
