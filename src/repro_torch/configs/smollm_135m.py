"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M; hf] — llama-arch small."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="dense",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    d_ff=1536, vocab_size=49152,
    ffn_kind="swiglu", temporal_pattern=("attn",),
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
