"""Plan-aware CNNs in PyTorch — the port of the JAX package's ``models/cnn``.

A network is a flat chain of 1-indexed :class:`ConvSpec` units plus skip
annotations, applied two ways:

* original / replaced (pruned, unmerged) — ``apply_replaced(net, params,
  x, plan)``: activations outside ``A`` are dropped, convs outside ``C``
  become the identity, padding moves to the front of every merged group
  (paper Appendix A), group norms move to group ends;
* merged — ``CNNHost.lower_plan(plan, params)`` folds every segment into
  one convolution (:func:`merge_segment`) and lowers the result to a
  :class:`repro_torch.runtime.ir.UnitGraph` for the executor.

The two agree up to fp32 accumulation order — the cornerstone of the
paper's method.  Parameters are the JAX package's nested structure
``{"layers": [...], "skips": [...], "head": {...}}`` of tensors in its
layouts (NHWC activations, HWIO weights); :func:`params_from_numpy` and
:func:`params_to_numpy` carry them across.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import merge as M
from repro_torch.core.plan import (CompressionPlan, LayerDesc, Segment,
                                   identity_plan)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvSpec:
    cin: int
    cout: int
    k: int = 3
    stride: int = 1
    depthwise: bool = False
    act: str = "relu"            # 'relu' | 'relu6' | 'silu' | 'none'
    norm: str | None = None      # None | 'bn' (frozen, foldable) | 'gn'
    gn_groups: int = 8
    bias: bool = True
    kind: str = "conv"           # 'conv' | 'pool' (avg) | 'upsample' | 'attn'

    @property
    def shape_preserving(self) -> bool:
        return (self.kind == "conv" and self.stride == 1
                and self.cin == self.cout)


@dataclasses.dataclass(frozen=True)
class SkipSpec:
    kind: str                    # 'add' | 'concat'
    start: int                   # boundary position (block = layers start+1..end)
    end: int
    proj: bool = False           # 1x1 projection shortcut (stride = block stride)


@dataclasses.dataclass(frozen=True)
class ConvNet:
    specs: tuple[ConvSpec, ...]
    skips: tuple[SkipSpec, ...] = ()
    in_hw: int = 32
    in_ch: int = 3
    head: str = "classifier"     # 'classifier' | 'none'
    num_classes: int = 10
    act_after_merge: bool = False   # paper's MobileNetV2 trick (Appendix A)

    @property
    def L(self) -> int:
        return len(self.specs)

    def spec(self, l: int) -> ConvSpec:
        return self.specs[l - 1]

    def irreducible(self) -> tuple[int, ...]:
        """R — layers whose input/output shapes differ (plus non-convs)."""
        return tuple(l for l in range(1, self.L + 1)
                     if not self.spec(l).shape_preserving)

    def layer_descs(self, params=None) -> list[LayerDesc]:
        """Per-layer descriptors; ``value`` is the fp32 ℓ1 norm of the
        layer's weight (the Eq. 3 objective)."""
        descs = []
        for l in range(1, self.L + 1):
            s = self.spec(l)
            w = params["layers"][l - 1].get("w") if params else None
            val = float(torch.sum(torch.abs(w))) if w is not None else 0.0
            descs.append(LayerDesc(
                index=l, kind="dwconv" if s.depthwise else s.kind,
                growth=(s.k - 1) if s.kind == "conv" else 0,
                value=val,
                prunable=s.shape_preserving,
                linearizable=(s.kind == "conv"),
                meta={"stride": s.stride, "k": s.k},
            ))
        return descs

    def allowed_span(self, i: int, j: int) -> bool:
        """Span predicate: skip-block consistency, and barrier units
        (pool/upsample/attn) never strictly inside a span."""
        if j - i > 1:
            for l in range(i + 1, j + 1):
                if self.spec(l).kind != "conv":
                    return False
        for sk in self.skips:
            inter = max(0, min(j, sk.end) - max(i, sk.start))
            if inter == 0:
                continue
            inside = (sk.start <= i and j <= sk.end)
            whole_block = (i <= sk.start and sk.end <= j)
            if sk.kind == "concat" or sk.proj:
                if not inside:
                    return False
            else:
                if not (whole_block or inside):
                    return False
                if whole_block:
                    for l in range(sk.start + 1, sk.end + 1):
                        sl = self.spec(l)
                        if sl.stride > 1 or sl.k % 2 == 0 or sl.kind != "conv":
                            return False
        return True

    def boundary_shapes(self) -> list[tuple[int, int, int]]:
        """(h, w, c) at every boundary position 0..L (post-concat)."""
        shapes = [(self.in_hw, self.in_hw, self.in_ch)]
        h = w = self.in_hw
        c = self.in_ch
        concat_at = {sk.end: sk.start for sk in self.skips
                     if sk.kind == "concat"}
        for l in range(1, self.L + 1):
            s = self.spec(l)
            if s.kind == "conv":
                h, w = -(-h // s.stride), -(-w // s.stride)
                c = s.cout
            elif s.kind == "pool":
                h, w = -(-h // s.stride), -(-w // s.stride)
            elif s.kind == "upsample":
                h, w = h * s.stride, w * s.stride
            if l in concat_at:
                c += shapes[concat_at[l]][2]
            shapes.append((h, w, c))
        return shapes


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(net: ConvNet, generator: torch.Generator | None = None,
                device="cpu", dtype=torch.float32):
    """He-initialised parameters (identity BN/GN statistics), drawn from
    ``generator`` on the CPU and moved to ``device``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, dtype=dtype)
                * std).to(device)

    def const(shape, val):
        return torch.full(shape, val, dtype=dtype, device=device)

    shapes = net.boundary_shapes()
    layers = []
    for l in range(1, net.L + 1):
        s = net.spec(l)
        p = {}
        if s.kind == "conv":
            cin_eff = shapes[l - 1][2]
            if s.depthwise:
                wshape, fan_in = (s.k, s.k, 1, s.cout), s.k * s.k
            else:
                wshape = (s.k, s.k, cin_eff, s.cout)
                fan_in = s.k * s.k * cin_eff
            p["w"] = normal(wshape, math.sqrt(2.0 / fan_in))
            if s.bias:
                p["b"] = const((s.cout,), 0.0)
            if s.norm == "bn":
                p["bn"] = {"gamma": const((s.cout,), 1.0),
                           "beta": const((s.cout,), 0.0),
                           "mean": const((s.cout,), 0.0),
                           "var": const((s.cout,), 1.0)}
            elif s.norm == "gn":
                p["gn"] = {"gamma": const((s.cout,), 1.0),
                           "beta": const((s.cout,), 0.0)}
        elif s.kind == "attn":
            c = shapes[l - 1][2]
            p = {n: normal((c, c), 1.0 / math.sqrt(c))
                 for n in ("wq", "wk", "wv", "wo")}
        layers.append(p)
    skips = []
    for sk in net.skips:
        if sk.proj:
            cin, cout = shapes[sk.start][2], shapes[sk.end][2]
            skips.append({"w": normal((1, 1, cin, cout), math.sqrt(2.0 / cin)),
                          "b": const((cout,), 0.0)})
        else:
            skips.append({})
    head = {}
    if net.head == "classifier":
        c_final = shapes[-1][2]
        head["w"] = normal((c_final, net.num_classes),
                           math.sqrt(1.0 / c_final))
        head["b"] = const((net.num_classes,), 0.0)
    return {"layers": layers, "skips": skips, "head": head}


def _is_bf16(arr: np.ndarray) -> bool:
    """``ml_dtypes.bfloat16``, what ``np.asarray`` makes of a JAX bf16 leaf
    (numpy has no bf16 of its own)."""
    return arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2


def params_from_numpy(tree, device="cpu"):
    """Tensors on ``device`` from a nested structure of numpy arrays (the
    JAX package's params after ``np.asarray`` on every leaf).  A bf16 leaf
    (``ml_dtypes.bfloat16``) crosses bit for bit through a 16-bit view,
    never through fp32."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    arr = np.array(tree, copy=True)
    if _is_bf16(arr):
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy`: numpy arrays on the host;
    a bf16 tensor comes back as ``ml_dtypes.bfloat16``, bit for bit (the
    ``ml_dtypes`` package, which JAX installs, is imported only then)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# ---------------------------------------------------------------------------
# Primitives (NHWC activations, HWIO weights)
# ---------------------------------------------------------------------------

def _act(x, name):
    if name == "relu":
        return torch.relu(x)
    if name == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if name == "silu":
        return F.silu(x)
    return x


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(lo, hi) padding of a SAME window: asymmetric when the total is odd."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride, depthwise, padding="VALID"):
    """NHWC × HWIO cross-correlation (``groups = Cout`` when depthwise)."""
    if padding == "SAME":
        ph = _same_pads(x.shape[1], w.shape[0], stride)
        pw = _same_pads(x.shape[2], w.shape[1], stride)
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    groups = w.shape[-1] if depthwise else 1
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def _pad_hw(x, lo: int, hi: int):
    return F.pad(x, (0, 0, lo, hi, lo, hi))


def _avg_pool_same(x, k: int, stride: int):
    """SAME-padded window sum divided by k·k (zero padding counts)."""
    ph = _same_pads(x.shape[1], k, stride)
    pw = _same_pads(x.shape[2], k, stride)
    x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), k, stride)
    return y.permute(0, 2, 3, 1)


def _upsample(x, factor: int):
    """Nearest-neighbour upsample by an integer factor."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


def _gn(x, gn, groups, eps=1e-5):
    """Group norm over ``gcd(groups, c)`` groups, population variance."""
    n, h, w, c = x.shape
    g = math.gcd(groups, c)
    xg = x.reshape(n, h, w, g, c // g)
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
    xg = (xg - mu) / torch.sqrt(var + eps)
    return xg.reshape(n, h, w, c) * gn["gamma"] + gn["beta"]


def _folded_wb(spec: ConvSpec, p):
    """Conv weight/bias with frozen BN folded in (exact at inference)."""
    w = p["w"]
    b = p.get("b")
    if "bn" in p:
        bn = p["bn"]
        w, b = M.fold_batchnorm(w, b, bn["gamma"], bn["beta"], bn["mean"],
                                bn["var"])
    if b is None:
        b = torch.zeros((spec.cout,), dtype=w.dtype, device=w.device)
    return w, b


def _center_crop_to(src, like):
    """Center-crop ``src`` spatially to the shape of ``like`` (Dirac tap)."""
    dh = src.shape[1] - like.shape[1]
    dw = src.shape[2] - like.shape[2]
    if dh == 0 and dw == 0:
        return src
    if dh < 0 or dw < 0 or dh % 2 or dw % 2:
        raise ValueError(f"cannot center-crop {tuple(src.shape)} to "
                         f"{tuple(like.shape)}")
    return src[:, dh // 2: src.shape[1] - dh // 2,
               dw // 2: src.shape[2] - dw // 2, :]


def segment_geometry(net: ConvNet, seg: Segment) -> tuple[int, int]:
    """(merged kernel size, merged stride) of a segment under its kept set."""
    K, S = 1, 1
    kept = set(seg.kept)
    for l in seg.layers:
        s = net.spec(l)
        if s.kind != "conv":
            continue
        k_eff = s.k if l in kept else 1
        K = K + (k_eff - 1) * S
        S *= s.stride
    return K, S


def _skip_stride(net: ConvNet, sk: SkipSpec) -> int:
    s = 1
    for l in range(sk.start + 1, sk.end + 1):
        if net.spec(l).kind in ("conv", "pool"):
            s *= net.spec(l).stride
        elif net.spec(l).kind == "upsample":
            s //= net.spec(l).stride
    return s


def _apply_proj(saved, skp, stride):
    return _conv(saved, skp["w"], stride, False, padding="SAME") + skp["b"]


def _segment_gn(net: ConvNet, layers, seg: Segment):
    """GN moved to segment end (paper Appendix A): the last kept conv's GN
    whose channel count matches the segment output; None otherwise."""
    kept = set(seg.kept)
    out_c = None
    for l in reversed(seg.layers):
        s = net.spec(l)
        if l in kept and s.kind == "conv":
            out_c = s.cout
            break
    if out_c is None:
        return None, 8
    for l in reversed(seg.layers):
        s = net.spec(l)
        if l in kept and s.kind == "conv" and "gn" in layers[l - 1] \
                and s.cout == out_c:
            return layers[l - 1]["gn"], s.gn_groups
        if l in kept and s.kind == "conv" and s.cout != out_c:
            break
    return None, 8


# ---------------------------------------------------------------------------
# Replaced (pruned, unmerged) forward
# ---------------------------------------------------------------------------

def apply_replaced(net: ConvNet, params, x, plan: CompressionPlan | None = None):
    """Forward pass of the pruned-but-unmerged network under ``plan``
    (the original network for ``plan=None``); ``x`` NHWC on the params'
    device."""
    if plan is None:
        plan = identity_plan(net.L, net.layer_descs())
    layers = params["layers"]
    add_end = {sk.end: (sk.start, i) for i, sk in enumerate(net.skips)
               if sk.kind == "add"}
    cat_end = {sk.end: sk.start for sk in net.skips if sk.kind == "concat"}
    need_save = {sk.start for sk in net.skips}

    saved: dict[int, torch.Tensor] = {}
    if 0 in need_save:
        saved[0] = x
    for seg in plan.segments:
        Km, _ = segment_geometry(net, seg)
        lo = (Km - 1) // 2
        hi = Km - 1 - lo
        if Km > 1:
            x = _pad_hw(x, lo, hi)
        local: dict[int, torch.Tensor] = {seg.i: x}
        kept = set(seg.kept)
        gn, gn_groups = _segment_gn(net, layers, seg)
        for l in seg.layers:
            s = net.spec(l)
            p = layers[l - 1]
            if s.kind == "conv":
                if l in kept:
                    w, b = _folded_wb(s, p)
                    x = _conv(x, w, s.stride, s.depthwise) + b
            elif s.kind == "pool":
                x = _avg_pool_same(x, s.k, s.stride)
            elif s.kind == "upsample":
                x = _upsample(x, s.stride)
            elif s.kind == "attn":
                x = _tiny_self_attention(x, p)
            if l in add_end:
                src, ski = add_end[l]
                sk = net.skips[ski]
                if sk.proj:
                    base = _apply_proj(saved[src], params["skips"][ski],
                                       _skip_stride(net, sk))
                else:
                    base = local[src] if src >= seg.i else saved[src]
                x = x + _center_crop_to(base, x)
            if l in cat_end:
                x = torch.cat([x, saved[cat_end[l]]], dim=-1)
            local[l] = x
        if gn is not None:
            x = _gn(x, gn, gn_groups)
        if seg.j < net.L:
            bspec = net.spec(seg.j)
            act = bspec.act
            if (net.act_after_merge and not seg.original
                    and bspec.kind == "conv" and act == "none"):
                act = "relu6"
            x = _act(x, act)
        if seg.j in need_save:
            saved[seg.j] = x
    return _apply_head(net, params, x)


def _tiny_self_attention(x, p):
    """Single-head self-attention over spatial positions (DDPM barrier)."""
    n, h, w, c = x.shape
    t = x.reshape(n, h * w, c)
    q = t @ p["wq"]
    k = t @ p["wk"]
    v = t @ p["wv"]
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(c), dim=-1)
    return (t + (a @ v) @ p["wo"]).reshape(n, h, w, c)


def _apply_head(net: ConvNet, params, x):
    if net.head == "classifier":
        x = x.mean(dim=(1, 2))
        return x @ params["head"]["w"] + params["head"]["b"]
    return x


# ---------------------------------------------------------------------------
# Merge (Algorithm 2 final step)
# ---------------------------------------------------------------------------

def merge_segment(net: ConvNet, layers_params, seg: Segment):
    """Fold one segment into a single conv: returns (w, b, stride, dw)."""
    kept = set(seg.kept)
    add_blocks = {sk.start: sk.end for sk in net.skips
                  if sk.kind == "add" and not sk.proj}

    def compose(acc, w, b, stride, dw):
        if acc is None:
            return (w, b, stride, dw)
        w_a, b_a, s_a, dw_a = acc
        w_m, dw_m = M.merge_conv_pair(w_a, w, stride1=s_a, dw1=dw_a, dw2=dw)
        b_m = M.merge_bias_through(w, b_a, b, dw2=dw)
        return (w_m, b_m, s_a * stride, dw_m)

    def chain(lo: int, hi: int, as_branch: bool = False):
        acc = None
        l = lo + 1
        while l <= hi:
            blk_end = add_blocks.get(l - 1)
            # fuse a complete block inside (lo, hi]; when this call IS the
            # block's own branch ((lo,hi) == (start,end)), compose plainly
            if blk_end is not None and blk_end <= hi and l - 1 >= lo \
                    and not (as_branch and l - 1 == lo and blk_end == hi):
                wb, bb, sb, dwb = chain(l - 1, blk_end, as_branch=True)
                if sb != 1:
                    raise ValueError("Dirac fusion requires a stride-1 block")
                wb = M.fuse_skip_add(wb, depthwise=dwb)
                acc = compose(acc, wb, bb, 1, dwb)
                l = blk_end + 1
                continue
            s = net.spec(l)
            if s.kind != "conv":
                raise ValueError(f"cannot merge unit kind {s.kind}")
            if l in kept:
                w, b = _folded_wb(s, layers_params[l - 1])
                acc = compose(acc, w, b, s.stride, s.depthwise)
            l += 1
        if acc is None:   # fully pruned segment — identity conv
            c = net.boundary_shapes()[lo][2]
            dev = layers_params[lo]["w"].device    # layer lo+1, pruned conv
            w0 = M.identity_kernel(c, device=dev)
            return (w0, torch.zeros((c,), dtype=w0.dtype, device=dev), 1, True)
        return acc

    return chain(seg.i, seg.j)
