"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=0, vocab_size=49155,
    num_experts=32, experts_per_token=8, moe_dff=512,
    ffn_kind="swiglu", temporal_pattern=("attn",),
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; 32 experts top-8",
)
