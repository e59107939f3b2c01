"""Architecture configs — the JAX package's ``ArchConfig``, copied field for
field, with the JAX package's dry-run shapes and cells.

The field names, order and defaults are the JAX package's: a transformer
artifact stores ``dataclasses.asdict(cfg)`` in its spec, and the spec
enters the fingerprint, so a config that differs by one field would give
another fingerprint.  :func:`get_config` resolves every id of the JAX
package's registry: its ten transformer configs, and the paper's three
CNNs, which resolve to :class:`repro_torch.models.cnn.ConvNet` s of the
zoo; any other id raises.  :class:`ShapeConfig`, :data:`SHAPES`, :data:`LONG_CONTEXT_OK`,
:data:`ARCH_IDS` and :func:`cells` are the JAX package's values.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None     # default d_model // num_heads
    ffn_kind: str = "swiglu"        # swiglu | geglu | gelu
    qkv_bias: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dff: int = 0
    capacity_factor: float = 1.25
    # temporal structure: per-layer kinds, cycled/padded to num_layers
    temporal_pattern: tuple[str, ...] = ("attn",)
    local_window: int = 0           # for 'attn_local'
    rnn_width: int = 0              # for 'rglru' (0 → d_model)
    # embedding / modality frontend
    frontend: str = "tokens"        # tokens | embeddings (stub frontend)
    rope_kind: str = "rope"         # rope | mrope | none
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # runtime
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    decode_flash: bool = False   # flash-decoding LSE combine (sharded)
    source: str = ""                # provenance note

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    # -- derived -------------------------------------------------------------
    def layer_kinds(self) -> tuple[str, ...]:
        pat = self.temporal_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def has_ffn(self) -> bool:
        return self.d_ff > 0 or self.num_experts > 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        """Approximate parameter count."""
        d, hd = self.d_model, self.head_dim
        n = 0
        kinds = self.layer_kinds()
        for kind in kinds:
            if kind in ("attn", "attn_local"):
                n += d * hd * (self.num_heads * 2 + self.num_kv_heads * 2)
            elif kind == "rglru":
                dr = self.rnn_width or d
                n += 2 * d * dr + 2 * dr * dr + 5 * dr
            elif kind in ("mlstm", "slstm"):
                n += 4 * d * d + d * d
            if self.is_moe:
                n += self.num_experts * 3 * d * self.moe_dff + d * self.num_experts
            elif self.d_ff > 0:
                mult = 3 if self.ffn_kind in ("swiglu", "geglu") else 2
                n += mult * d * self.d_ff
            n += 2 * d
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.num_layers * (
            self.num_experts * 3 * d * self.moe_dff)
        return dense + self.num_layers * (
            self.experts_per_token * 3 * d * self.moe_dff)

    def reduced(self) -> "ArchConfig":
        """Structurally identical toy config for CPU tests."""
        pat = self.temporal_pattern
        n_layers = max(len(pat), 2)
        d = 32
        heads = 2
        kv = max(1, min(self.num_kv_heads, heads))
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=n_layers,
            d_model=d, num_heads=heads, num_kv_heads=kv, head_dim=d // heads,
            d_ff=(48 if self.d_ff > 0 else 0),
            vocab_size=64,
            num_experts=(4 if self.is_moe else 0),
            experts_per_token=(2 if self.is_moe else 0),
            moe_dff=(16 if self.is_moe else 0),
            local_window=(8 if self.local_window else 0),
            rnn_width=(32 if self.temporal_pattern.count("rglru") else 0),
            dtype="float32", remat=False, scan_layers=True,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                       # 'train' | 'prefill' | 'decode'


SHAPES: Mapping[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs that may run long_500k (sub-quadratic state): ssm/hybrid only
LONG_CONTEXT_OK = ("recurrentgemma-2b", "xlstm-125m")

ARCH_IDS = (
    "granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "gemma-7b",
    "command-r-plus-104b", "qwen2-7b", "smollm-135m", "recurrentgemma-2b",
    "musicgen-large", "qwen2-vl-7b", "xlstm-125m",
)

#: Every config id of the JAX package's registry: the ten transformer
#: configs and the paper's own networks.
_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "gemma-7b": "gemma_7b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen2-7b": "qwen2_7b",
    "smollm-135m": "smollm_135m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "musicgen-large": "musicgen_large",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "xlstm-125m": "xlstm_125m",
    # the paper's own networks
    "resnet34": "resnet34",
    "mobilenetv2": "mobilenetv2",
    "ddpm-cifar10": "ddpm_cifar10",
}


def get_config(arch: str):
    """The ``CONFIG`` of ``arch``: an :class:`ArchConfig` for a
    transformer id, a :class:`repro_torch.models.cnn.ConvNet` for a CNN
    id."""
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported: the known ids are "
                       f"{sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, honouring the long_500k skip rule."""
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            skipped = (shape.name == "long_500k"
                       and arch not in LONG_CONTEXT_OK)
            if skipped and not include_skipped:
                continue
            out.append((arch, shape.name) if not include_skipped
                       else (arch, shape.name, skipped))
    return out
