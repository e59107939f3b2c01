"""The launch plans of the ``flash_attention`` and ``depthwise_conv``
kernels and the attention's precision design, on the CPU (no card, no
``nvcc``).

Each ``launch_plan`` decides which blocks and threads the kernel launches;
the sources derive their grid and index arithmetic from the same numbers,
which the plans mirror (``block_outputs``, ``thread_outputs``), so the
coverage arithmetic is checked here: every output index written by
exactly one block or thread, ragged S, D, Wo and channel counts included.
The fp32 attention multiplies fp32 operands as 3xTF32 with the q·kᵀ depth
split over a row group's warps; a plain PyTorch emulation of those
products is held against float64 for one RecurrentGemma-shaped tile.  The
bf16 attention (``csrc/flash_attention_bf16.cu``) has a plan of its own,
whose constants are read back from the source, and keeps p fp32 in p·v as
three bf16 pieces: emulated here too.  Nothing here imports JAX.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels import depthwise_conv as dw
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn

#: Most shared memory a block may take on an H100.
SMEM_LIMIT = 232_448

#: (B, S, H, KVH, D): the paths' shapes (RecurrentGemma's probe and
#: prefill, SmolLM's), ragged S and D, grouped and multi-query heads.
ATTN_SHAPES = [(8, 128, 10, 1, 256), (8, 16, 10, 1, 256), (8, 128, 9, 3, 64),
               (8, 16, 9, 3, 64), (2, 7, 4, 2, 100), (1, 1, 1, 1, 1),
               (3, 37, 6, 2, 33), (2, 1000, 2, 1, 64), (1, 17, 10, 1, 256),
               (1, 15, 3, 3, 128), (2, 33, 4, 4, 32), (8, 256, 4, 2, 64)]

#: MobileNetV2's depthwise layers at batch 8 (224², width 1.0): (input
#: side, channels, stride), each as the 3×3 unit and as a 1×1 identity
#: unit, so every unit a plan can serve is among them.
MOBILENET_DW = [(112, 32, 1), (112, 96, 2), (56, 144, 1), (56, 144, 2),
                (28, 192, 1), (28, 192, 2), (14, 384, 1), (14, 576, 1),
                (14, 576, 2), (7, 960, 1)]


def _dw_shape(h, c, s, k):
    """(N, H, W, Cin, kh, kw, cin_g, Cout, G, stride) of a unit's padded
    input, as the executor gives it to the kernel."""
    hp = h + k - 1
    return (8, hp, hp, c, k, k, 1, c, c, s)


#: Ragged and grouped cases of the phase-3 sweep and the card tests:
#: channel counts not divisible by 4, Wo ragged against the strip of 4,
#: channel multiplier and general grouped convs, strides 1-3, k up to 11.
DW_SHAPES = [(2, 9, 8, 13, 3, 3, 1, 13, 13, 1),
             (2, 16, 13, 4, 3, 3, 1, 4, 4, 2),
             (2, 12, 11, 6, 5, 5, 1, 18, 6, 1),
             (1, 20, 17, 12, 3, 3, 4, 15, 3, 3),
             (2, 14, 14, 4, 3, 3, 1, 8, 4, 1),
             (1, 21, 22, 960, 11, 11, 1, 960, 960, 2),
             (3, 10, 9, 6, 2, 2, 1, 6, 6, 1),
             (1, 7, 7, 960, 1, 1, 1, 960, 960, 1)]


def _dw_plan(n, h, w, cin, kh, kw, cin_g, cout, groups, stride):
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    return dw.launch_plan(n, ho, wo, cin, kh, kw, cin_g, cout, groups,
                          stride)


# -- flash_attention -----------------------------------------------------------

@pytest.mark.parametrize("b,s,h,kvh,d", ATTN_SHAPES)
def test_attention_plan_covers_each_output_once(b, s, h, kvh, d):
    plan = fa.launch_plan(b, s, h, kvh, d)
    seen = np.zeros((b, s, h, d), dtype=np.int32)
    gx, gy, gz = plan.grid
    for x in range(gx):
        for y in range(gy):
            for z in range(gz):
                bb, heads, pos, (lo, hi) = plan.block_outputs(x, y, z)
                assert len(pos) > 0, f"block {(x, y, z)} holds no row"
                assert len(pos) <= plan.bm
                seen[bb, pos, heads, lo:hi] += 1
    assert (seen == 1).all()
    assert plan.blocks == gx * gy * gz
    assert plan.dp >= d and plan.dv * plan.dsplit == plan.dp


@pytest.mark.parametrize("d", [1, 32, 33, 64, 100, 128, 129, 200, 256])
@pytest.mark.parametrize("s", [1, 16, 128, 4096])
def test_attention_plan_fits_shared_memory(d, s):
    for h, kvh in ((10, 1), (9, 3), (4, 4)):
        plan = fa.launch_plan(8, s, h, kvh, d)
        assert plan.smem_bytes <= SMEM_LIMIT, plan
        assert plan.threads <= 256 and plan.args() == (plan.wr, plan.dsplit)


#: The bf16 body's shapes: the four published configs' attention (SmolLM,
#: RecurrentGemma, gemma-7b, qwen2-7b) at S 16 and 128, SmolLM's training
#: shape, and ragged ones (head dims up to 64 take the tile 64).
BF16_ATTN_SHAPES = [(8, s, h, kvh, d) for h, kvh, d in (
    (9, 3, 64), (10, 1, 256), (16, 16, 256), (28, 4, 128)) for s in (16, 128)
] + [(8, 1024, 9, 3, 64), (2, 7, 4, 2, 36), (1, 130, 2, 1, 100),
     (1, 1, 1, 1, 1)]


BF16_SOURCE = cuda_build.CSRC / "flash_attention_bf16.cu"


def _cu_ints(*names):
    """``constexpr int NAME = value`` of the bf16 attention's source (an
    expression of integers, as ``1024 + 128``, evaluated)."""
    text = BF16_SOURCE.read_text()
    out = []
    for name in names:
        m = re.search(r"\b" + name + r" = ([0-9 +*]+)[;,]", text)
        assert m, name
        out.append(eval(m.group(1)))
    return out


def test_bf16_attention_constants_mirror_the_source():
    """The plan's constants are the source's: kv tile, rows a warpgroup,
    chunk width, the ring's stages, the shared-memory budgets; the block
    shapes (head-dim tile, output columns) the plan can name are the
    instances the source dispatches."""
    assert _cu_ints("BKV", "ROWS", "CHUNK", "MIN_STAGES", "MAX_STAGES",
                    "SMEM_LIMIT", "SMEM_HALF", "SMEM_EXTRA") == [
        fa.BKV, fa.ROWS, fa.CHUNK, fa.MIN_STAGES, fa.MAX_STAGES,
        fa.SMEM_LIMIT, fa.SMEM_HALF, fa.SMEM_EXTRA]
    text = BF16_SOURCE.read_text()
    assert "THREADS = OWN ? 128 : 384" in text
    # two warpgroups are instantiated at 128 output columns only
    assert "if constexpr (DV == 128) {" in text
    dispatched = set(re.findall(r"if \(dp == (\d+) && dv == (\d+)\)", text))
    planned = {(str(dp), str(dv)) for dp in fa.HEAD_DIM_TILES[2]
               for dv in fa.BF16_DV if dv <= dp}
    assert dispatched == planned


@pytest.mark.parametrize("b,s,h,kvh,d", BF16_ATTN_SHAPES)
def test_bf16_attention_plan_covers_each_output_once(b, s, h, kvh, d):
    """The bf16 body's plan: every output written by exactly one block,
    blocks of one or two consumer warpgroups of 64 rows, 64 or 128 output
    columns, at most the card's shared memory, and the instance's
    constants as the source computes them (``Cfg``: stages that fit its
    budget, the threads of its warpgroups)."""
    plan = fa.launch_plan(b, s, h, kvh, d, elem=2)
    assert isinstance(plan, fa.HopperPlan)
    assert plan.dp == max(64, fa.head_dim_tile(d)) and plan.dp >= d
    seen = np.zeros((b, s, h, d), dtype=np.int32)
    gx, gy, gz = plan.grid
    for x in range(gx):
        for y in range(gy):
            for z in range(gz):
                bb, heads, pos, (lo, hi) = plan.block_outputs(x, y, z)
                assert 0 < len(pos) <= plan.bm
                seen[bb, pos, heads, lo:hi] += 1
    assert (seen == 1).all()
    assert plan.bm == 64 * plan.cw and plan.dv in fa.BF16_DV
    assert plan.cw == 1 or plan.dv == 128   # the source's instances
    assert plan.dv * plan.dsplit == plan.dp and plan.bkv == 64
    assert plan.threads == (384 if plan.cw == 2 else 128)
    limit, extra = _cu_ints("SMEM_LIMIT", "SMEM_EXTRA")
    budget = limit if plan.cw == 2 else _cu_ints("SMEM_HALF")[0]
    q_bytes = plan.cw * 64 * plan.dp * 2
    stage = 64 * (plan.dp + plan.dv) * 2
    assert plan.ring_stages == min(4, max(2, (budget - extra - q_bytes)
                                          // stage))
    assert plan.stages == min(plan.ring_stages, -(-s // 64))
    assert plan.smem_bytes == extra + q_bytes + plan.stages * stage
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.args() == (plan.cw, plan.dsplit)


def test_bf16_attention_smem_mirrors_the_source():
    """The source's Cfg at the plans of RecurrentGemma's probe (D 256: two
    warpgroups, 128 columns, 2 stages of 128 keys' worth: q 64 KB, K 32
    KB and V 16 KB a stage, 1 KB of slack) and of SmolLM-135M's training
    shape (D 64: one warpgroup, 4 stages of 16 KB); a single kv tile (S
    16) takes one stage."""
    rg = fa.launch_plan(8, 128, 10, 1, 256, elem=2)
    assert (rg.args(), rg.ring_stages, rg.smem_bytes) == ((2, 2), 3, 164_864)
    train = fa.launch_plan(8, 1024, 9, 3, 64, elem=2)
    assert (train.args(), train.stages, train.smem_bytes) == ((1, 1), 4,
                                                              74_752)
    prefill = fa.launch_plan(8, 16, 16, 16, 256, elem=2)
    assert (prefill.args(), prefill.stages, prefill.smem_bytes) == (
        (1, 2), 1, 82_944)
    assert fa.launch_plan(8, 128, 10, 1, 256).smem_bytes == 108_800


@pytest.mark.parametrize("shape", [(8, 128, 10, 1, 256), (8, 128, 9, 3, 64)])
def test_attention_plan_fills_the_card_at_the_probes(shape):
    assert fa.launch_plan(*shape).blocks >= 132


@pytest.mark.parametrize("shape,args,blocks", [
    ((8, 16, 10, 1, 256), (1, 2), 160), ((8, 16, 9, 3, 64), (4, 1), 24)])
def test_attention_plan_at_prefill(shape, args, blocks):
    """S 16: RecurrentGemma has 1,280 query rows (80 row tiles of 16),
    fewer than SMs, so two blocks of 4 warps share each row tile, each
    writing half of the columns.  SmolLM's 48 rows a kv head take one
    block of 4 warps (64 rows) each: 24 blocks, each K/V tile loaded once
    for its 3 query heads."""
    plan = fa.launch_plan(*shape)
    assert (plan.args(), plan.blocks) == (args, blocks)
    assert plan.threads >= 32 * fa.MIN_WARPS


def test_attention_plan_follows_the_sm_count():
    assert fa.launch_plan(8, 16, 10, 1, 256, sms=64).dsplit == 1
    assert fa.launch_plan(8, 128, 10, 1, 256, sms=16).wr == 2


# -- depthwise_conv ------------------------------------------------------------

def _dw_cover(plan):
    seen = np.zeros((plan.n, plan.ho, plan.wo, plan.cout), dtype=np.int32)
    idx = np.arange(plan.blocks * plan.threads)
    idx = idx[idx < plan.total]
    img, ho, wo0, cols, c0 = plan.thread_outputs(idx)
    assert (cols >= 1).all() and (cols <= plan.ow).all()
    for o in range(plan.ow):
        m = cols > o
        for i in range(plan.vec):
            np.add.at(seen, (img[m], ho[m], wo0[m] + o, c0[m] + i), 1)
    return seen


@pytest.mark.parametrize(
    "shape", [_dw_shape(*u, k) for u in MOBILENET_DW for k in (3, 1)]
    + DW_SHAPES)
def test_dw_plan_covers_each_output_once(shape):
    plan = _dw_plan(*shape)
    assert (_dw_cover(plan) == 1).all()
    assert plan.threads in dw.THREADS and plan.threads % 32 == 0


@pytest.mark.parametrize("unit", MOBILENET_DW)
@pytest.mark.parametrize("k", [3, 1])
def test_dw_plan_fills_the_card_at_mobilenet_units(unit, k):
    plan = _dw_plan(*_dw_shape(*unit, k))
    assert plan.vec == 4 and plan.ow == dw.OW_VEC
    assert plan.blocks >= 132
    assert (plan.k_t, plan.s_t) == (k, unit[2]) \
        or (k, unit[2]) not in dw.FIXED_TAPS


@pytest.mark.parametrize("shape,vec", [
    ((2, 9, 8, 13, 3, 3, 1, 13, 13, 1), 1),      # 13 channels
    ((2, 12, 11, 6, 5, 5, 1, 18, 6, 1), 1),      # multiplier, 18 outputs
    ((1, 20, 17, 12, 3, 3, 4, 15, 3, 3), 1),     # general grouped
    ((2, 14, 14, 4, 3, 3, 1, 8, 4, 1), 4),       # multiplier, 8 outputs
    ((1, 9, 9, 8, 3, 3, 1, 8, 8, 1), 4)])
def test_dw_plan_takes_the_vector_path_where_one_load_serves_four(shape, vec):
    """... and only depthwise convs (one input channel an output channel)
    take a compile-time instance."""
    plan = _dw_plan(*shape)
    assert plan.vec == vec
    assert (plan.k_t > 0) == (vec == 4 and shape[3] == shape[7])
    n, h, w, cin, kh, kw, cin_g, cout, groups, s = shape
    ho, wo = (h - kh) // s + 1, (w - kw) // s + 1
    assert dw.launch_plan(n, ho, wo, cin, kh, kw, cin_g, cout, groups, s,
                          aligned=False).vec == 1


@pytest.mark.parametrize("entry,plan_args", [
    ("flash_attention", 2), ("depthwise_conv", 4), ("depthwise_conv_q", 4),
    ("flash_attention_bf16", 2), ("rmsnorm", 3), ("rmsnorm_bf16", 3)])
def test_c_entry_points_take_the_bound_arguments(entry, plan_args):
    """ctypes passes exactly the C function's parameters, the plan's
    arguments last before the stream."""
    source, c_name, argtypes = cuda_build.SIGNATURES[entry]
    text = (cuda_build.CSRC / f"{source}.cu").read_text()
    decl = re.search(r'extern "C" int ' + c_name + r"\(([^)]*)\)", text)
    params = [p.strip() for p in decl.group(1).split(",")]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert (t is cuda_build.ctypes.c_int) == p.startswith("int "), p
    plan = {"flash_attention": lambda: fa.launch_plan(1, 8, 2, 1, 64),
            "flash_attention_bf16": lambda: fa.launch_plan(1, 8, 2, 1, 64,
                                                           elem=2),
            "rmsnorm": lambda: rn.launch_plan(8, 576),
            "rmsnorm_bf16": lambda: rn.launch_plan(8, 576)}.get(
        entry, lambda: dw.launch_plan(1, 4, 4, 8, 3, 3, 1, 8, 8, 1))()
    assert len(plan.args()) == plan_args
    assert all(p.startswith("int ") for p in params[-1 - plan_args:-1])


# -- the attention's precision design ------------------------------------------

ULP = 2.0 ** -24


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """The source's rounding to TF32: half a TF32 ulp added to the bits,
    the low 13 dropped (nearest, ties away from zero)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(a):
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _mm3(a, b):
    """a @ b as 3xTF32: (lo·hi' + hi·lo') + hi·hi'."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _ulps(y, exact, scale) -> float:
    return float(((y.double() - exact).abs() / scale).max()) / ULP


def test_attention_products_keep_fp32_accuracy():
    """One RecurrentGemma tile (D 256, a block's 32 rows against a kv tile
    of 16 keys): q·kᵀ as 3xTF32 over the four warps' 64-column slices
    (the small terms and hi·hi summed apart, then added), the slices
    summed in order, and p·v as 3xTF32, each within a few ulps of
    Σ|a·b| of the float64 product, as the plain fp32 product; 1xTF32 is
    hundreds of ulps off."""
    plan = fa.launch_plan(8, 128, 10, 1, 256)
    rows, keys, d = plan.bm, plan.bkv, 256
    rng = np.random.default_rng(16)
    q = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((keys, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((keys, d)).astype(np.float32))
    cols = d // plan.wd
    s = sum(_mm3(q[:, c * cols:(c + 1) * cols], k[:, c * cols:(c + 1) * cols].T)
            for c in range(plan.wd))
    exact = q.double() @ k.double().T
    scale = q.double().abs() @ k.double().abs().T
    err, fp32 = _ulps(s, exact, scale), _ulps(q @ k.T, exact, scale)
    one = _ulps(_tf32(q) @ _tf32(k).T, exact, scale)
    assert err <= 4.0 and fp32 <= 4.0, (err, fp32)
    assert one >= 64.0
    p = torch.softmax(exact / np.sqrt(d), dim=1).float()
    o = _mm3(p, v)
    exact = p.double() @ v.double()
    scale = p.double() @ v.double().abs()
    err, fp32 = _ulps(o, exact, scale), _ulps(p @ v, exact, scale)
    one = _ulps(_tf32(p) @ _tf32(v), exact, scale)
    assert err <= 4.0 and fp32 <= 4.0, (err, fp32)
    assert one >= 64.0


def _pieces(p: torch.Tensor):
    """The kernel's split of fp32 p: hi = bf16(p), mid = bf16(p - hi), lo
    = bf16(p - hi - mid), each rounded to nearest even as
    ``__floats2bfloat162_rn``."""
    hi = p.bfloat16().float()
    mid = (p - hi).bfloat16().float()
    lo = (p - hi - mid).bfloat16().float()
    return lo, mid, hi


def test_bf16_attention_keeps_p_fp32_in_three_pieces():
    """One SmolLM-135M training tile (a warpgroup's 64 rows against a kv
    tile of 64 keys, D 64, bf16 v): the three bf16 pieces of p sum to it
    exactly, and p·v as the kernel takes it — three products of bf16
    operands (each exact in fp32), summed in fp32 the small pieces first
    — is within 4 fp32 ulps of Σ p·|v| of the float64 product, as the
    fp32 product is; p rounded to bf16 before p·v (what
    scaled_dot_product_attention does at bf16) is 64 ulps or more off."""
    rng = np.random.default_rng(27)
    rows, keys, d = 64, 64, 64
    q = torch.from_numpy(rng.standard_normal((rows, d))).bfloat16().float()
    k = torch.from_numpy(rng.standard_normal((keys, d))).bfloat16().float()
    v = torch.from_numpy(rng.standard_normal((keys, d))).bfloat16().float()
    s = (q.double() @ k.double().T / np.sqrt(d)).float()
    p = torch.exp(s - s.amax(dim=1, keepdim=True))
    lo, mid, hi = _pieces(p)
    assert torch.equal(lo.double() + mid.double() + hi.double(), p.double())
    for piece in (lo, mid, hi):
        assert torch.equal(piece.bfloat16().float(), piece)
    o = lo @ v
    o = o + mid @ v
    o = o + hi @ v
    exact = p.double() @ v.double()
    scale = p.double() @ v.double().abs()
    err, fp32 = _ulps(o, exact, scale), _ulps(p @ v, exact, scale)
    rounded = _ulps(hi @ v, exact, scale)
    assert err <= 4.0 and fp32 <= 4.0, (err, fp32)
    assert rounded >= 64.0, rounded
