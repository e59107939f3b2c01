"""xlstm-125m [arXiv:2405.04517; unverified] — sLSTM + mLSTM blocks.

xLSTM[7:1]-flavoured 12-layer stack: sLSTM at positions 3 and 9 (0-based),
mLSTM elsewhere; no separate FFN sublayer (d_ff=0 — the blocks carry their
own projections).

Note: our m/sLSTM blocks are the simplified variant without the paper's 2×
up-projection, so the assigned geometry lands at ~74M params (the temporal
recurrences, chunked-parallel forms and state semantics are faithful; see
models/xlstm.py and DESIGN §2.3).
"""
from .base import ArchConfig

_pattern = tuple("slstm" if i in (3, 9) else "mlstm" for i in range(12))

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    temporal_pattern=_pattern, rope_kind="none",
    tie_embeddings=True,
    source="arXiv:2405.04517; sLSTM@{3,9}, mLSTM elsewhere",
)
