"""qwen2-7b [arXiv:2407.10671; hf] — GQA kv=4, QKV bias."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    ffn_kind="swiglu", qkv_bias=True, temporal_pattern=("attn",),
    source="arXiv:2407.10671; GQA, QKV bias",
)
