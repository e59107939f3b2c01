"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=33792, vocab_size=256000,
    ffn_kind="swiglu", qkv_bias=False, temporal_pattern=("attn",),
    source="hf:CohereForAI/c4ai-command-r-plus; GQA kv=8, no-bias",
)
