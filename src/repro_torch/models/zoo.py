"""Builders for the paper's CNN families (full + reduced variants).

``resnet34`` / ``mobilenetv2`` / ``ddpm_unet`` mirror the paper's networks
at full scale (used by the analytic latency tables and entry-count
benchmarks); the ``tiny_*`` variants keep the same *structure* (skip kinds,
strides, depthwise patterns, norms) at toy width/depth so that the measured
pipeline — importance fine-tuning, wall-clock latency tables, DP, merging —
runs on CPU in seconds.
"""
from __future__ import annotations

from .cnn import ConvNet, ConvSpec, SkipSpec


def _res_block(specs, skips, c, stride=1, cin=None, norm="bn"):
    cin = cin or c
    start = len(specs)
    specs.append(ConvSpec(cin, c, 3, stride, act="relu", norm=norm))
    specs.append(ConvSpec(c, c, 3, 1, act="relu", norm=norm))
    skips.append(SkipSpec("add", start, start + 2,
                          proj=(stride != 1 or cin != c)))


def resnet34(num_classes: int = 1000, in_hw: int = 224,
             width: int = 64, norm: str = "bn") -> ConvNet:
    specs: list[ConvSpec] = []
    skips: list[SkipSpec] = []
    w = width
    specs.append(ConvSpec(3, w, 7, 2, act="relu", norm=norm))      # stem
    specs.append(ConvSpec(w, w, 3, 2, kind="pool", act="none"))    # maxpool→avg
    for n, (c, s) in zip((3, 4, 6, 3),
                         ((w, 1), (2 * w, 2), (4 * w, 2), (8 * w, 2))):
        for b in range(n):
            _res_block(specs, skips, c, s if b == 0 else 1,
                       cin=None if b else specs[-1].cout, norm=norm)
    return ConvNet(tuple(specs), tuple(skips), in_hw=in_hw, in_ch=3,
                   head="classifier", num_classes=num_classes)


def tiny_resnet(num_classes: int = 10, in_hw: int = 16, width: int = 8,
                blocks=(2, 2), norm=None) -> ConvNet:
    specs: list[ConvSpec] = []
    skips: list[SkipSpec] = []
    w = width
    specs.append(ConvSpec(3, w, 3, 1, act="relu", norm=norm))
    for stage, n in enumerate(blocks):
        c = w * (2 ** stage)
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            _res_block(specs, skips, c, stride,
                       cin=specs[-1].cout, norm=norm)
    return ConvNet(tuple(specs), tuple(skips), in_hw=in_hw, in_ch=3,
                   head="classifier", num_classes=num_classes)


def _inverted_residual(specs, skips, cin, cout, stride, expand, norm="bn"):
    mid = cin * expand
    start = len(specs)
    if expand != 1:
        specs.append(ConvSpec(cin, mid, 1, 1, act="relu6", norm=norm))
    specs.append(ConvSpec(mid, mid, 3, stride, depthwise=True, act="relu6",
                          norm=norm))
    specs.append(ConvSpec(mid, cout, 1, 1, act="none", norm=norm))
    if stride == 1 and cin == cout:
        skips.append(SkipSpec("add", start, len(specs)))


def mobilenetv2(num_classes: int = 1000, in_hw: int = 224,
                width_mult: float = 1.0, norm: str = "bn") -> ConvNet:
    def c(ch):
        return max(8, int(ch * width_mult + 4) // 8 * 8)
    cfg = [  # t, c, n, s  (paper table)
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    specs: list[ConvSpec] = []
    skips: list[SkipSpec] = []
    specs.append(ConvSpec(3, c(32), 3, 2, act="relu6", norm=norm))
    cin = c(32)
    for t, ch, n, s in cfg:
        for b in range(n):
            _inverted_residual(specs, skips, cin, c(ch), s if b == 0 else 1,
                               t, norm=norm)
            cin = c(ch)
    specs.append(ConvSpec(cin, c(1280), 1, 1, act="relu6", norm=norm))
    return ConvNet(tuple(specs), tuple(skips), in_hw=in_hw, in_ch=3,
                   head="classifier", num_classes=num_classes,
                   act_after_merge=True)


def tiny_mobilenet(num_classes: int = 10, in_hw: int = 16, width: int = 8,
                   norm=None) -> ConvNet:
    specs: list[ConvSpec] = []
    skips: list[SkipSpec] = []
    specs.append(ConvSpec(3, width, 3, 1, act="relu6", norm=norm))
    cin = width
    for t, ch, n, s in [(2, width, 2, 1), (2, 2 * width, 2, 2)]:
        for b in range(n):
            _inverted_residual(specs, skips, cin, ch, s if b == 0 else 1, t,
                               norm=norm)
            cin = ch
    return ConvNet(tuple(specs), tuple(skips), in_hw=in_hw, in_ch=3,
                   head="classifier", num_classes=num_classes,
                   act_after_merge=True)


def ddpm_unet(in_hw: int = 32, base: int = 128) -> ConvNet:
    """DDPM-shaped UNet chain: down/up with skip-concat, GN, attn barrier."""
    return _unet(in_hw, base, depth=2, blocks=2, norm="gn", attn=True)


def tiny_unet(in_hw: int = 16, base: int = 8, norm="gn", attn=True) -> ConvNet:
    return _unet(in_hw, base, depth=1, blocks=2, norm=norm, attn=attn)


def _unet(in_hw, base, depth, blocks, norm, attn) -> ConvNet:
    specs: list[ConvSpec] = []
    skips: list[SkipSpec] = []
    enc_boundaries: list[tuple[int, int]] = []  # (boundary, channels)
    specs.append(ConvSpec(4, base, 3, 1, act="silu", norm=norm))  # img + t chan
    c = base
    # encoder
    for d in range(depth):
        for _ in range(blocks):
            specs.append(ConvSpec(c, c, 3, 1, act="silu", norm=norm))
        enc_boundaries.append((len(specs), c))
        specs.append(ConvSpec(c, 2 * c, 3, 2, act="silu", norm=norm))
        c = 2 * c
    # middle (+ attention barrier, as in DDPM at 16×16)
    specs.append(ConvSpec(c, c, 3, 1, act="silu", norm=norm))
    if attn:
        specs.append(ConvSpec(c, c, 1, 1, kind="attn", act="none"))
    specs.append(ConvSpec(c, c, 3, 1, act="silu", norm=norm))
    # decoder
    for d in reversed(range(depth)):
        specs.append(ConvSpec(c, c, 2, 2, kind="upsample", act="none"))
        src, src_c = enc_boundaries[d]
        skips.append(SkipSpec("concat", src, len(specs)))
        specs.append(ConvSpec(c + src_c, c // 2, 3, 1, act="silu", norm=norm))
        c = c // 2
        for _ in range(blocks - 1):
            specs.append(ConvSpec(c, c, 3, 1, act="silu", norm=norm))
    specs.append(ConvSpec(c, 3, 3, 1, act="none", norm=None))  # out conv
    return ConvNet(tuple(specs), tuple(skips), in_hw=in_hw, in_ch=4,
                   head="none")
