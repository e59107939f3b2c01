"""recurrentgemma-2b [arXiv:2402.19427; hf] — RG-LRU + local attn, 1:2.

Pattern (Griffin): (recurrent, recurrent, local-attention) repeating; MQA
(kv=1) on the attention blocks, GeGLU FFN, local window 2048.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000,
    ffn_kind="geglu",
    temporal_pattern=("rglru", "rglru", "attn_local"),
    local_window=2048, rnn_width=2560,
    tie_embeddings=True,
    source="arXiv:2402.19427; RG-LRU + local attn 1:2, window 2048",
)
