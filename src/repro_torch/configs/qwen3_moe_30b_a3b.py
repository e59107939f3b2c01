"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    head_dim=128,
    d_ff=0, vocab_size=151936,
    num_experts=128, experts_per_token=8, moe_dff=768,
    ffn_kind="swiglu", temporal_pattern=("attn",),
    source="hf:Qwen/Qwen3-30B-A3B; 128 experts top-8",
)
