"""The ``merged_conv`` kernel's launch plan and its precision design, on the
CPU (no card, no ``nvcc``).

``launch_plan`` decides which blocks the kernel launches (tile by Cout,
copy widths, the dense 1×1 panel, the int8 mma, splits of the reduction
and their k-chunk); the source derives its grid and index arithmetic from
the same numbers, which ``LaunchPlan.block_outputs`` mirrors, so the
coverage arithmetic is checked here: every output element summed over
every reduction index exactly once, splits included.  The kernel
multiplies fp32 operands as 3xTF32, fp32 × narrow as 2xTF32, int8 × e4m3
as 1xTF32 and int8 × int8 in int32; a plain PyTorch emulation of those
products, split as the plan splits them, is held against the plain
versions (``merged_conv_ref`` / ``merged_conv_qref``).  Nothing here
imports JAX.
"""
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_build
from repro_torch.kernels import merged_conv as mc
from repro_torch.kernels import quant, ref

#: Most shared memory a block may take on an H100, and an SM's in all
#: (each resident block also reserves 1 KB).
SMEM_LIMIT = 232_448
SM_SMEM = 233_472

#: The phase-3 sweep's shapes: (N, H, W, Cin, kh, kw, Cout, stride).
SWEEP = [(2, k + 5 * s + 1, k + 3 * s + 2, cin, k, k, cout, s)
         for s in (1, 2, 3) for k in (1, 2, 3, 5, 7, 11)
         for cin, cout in ((5, 3), (19, 70), (64, 129))]

#: MobileNetV2's 29 dense units at batch 8 (224², width 1.0), as the
#: merged plan of PR 16's last card run gave them (x padded as the executor
#: gives it to the kernel): (N, H, W, Cin, k, Cout, stride).
MOBILENET = [(8, 226, 226, 3, 3, 32, 2), (8, 112, 112, 32, 1, 16, 1),
             (8, 114, 114, 16, 3, 24, 2), (8, 56, 56, 24, 1, 144, 1),
             (8, 56, 56, 144, 1, 24, 1), (8, 28, 28, 144, 1, 32, 1),
             (8, 28, 28, 32, 1, 192, 1), (8, 28, 28, 192, 1, 32, 1),
             (8, 14, 14, 192, 1, 64, 1), (8, 14, 14, 64, 1, 384, 1),
             (8, 14, 14, 384, 1, 64, 1), (8, 14, 14, 384, 1, 96, 1),
             (8, 14, 14, 96, 1, 576, 1), (8, 14, 14, 576, 1, 96, 1),
             (8, 7, 7, 576, 1, 160, 1), (8, 7, 7, 160, 1, 160, 1),
             (8, 7, 7, 160, 1, 1280, 1)]
#: ResNet34's merged_conv units at batch 8 under the analytic oracle's 0.6
#: plan (the smoke run's phase 7): the 7×7 stride-2 stem and 3×3 units.
RESNET34 = [(8, 230, 230, 3, 7, 64, 2), (8, 58, 58, 64, 3, 64, 1),
            (8, 58, 58, 64, 3, 128, 2), (8, 30, 30, 128, 3, 128, 1),
            (8, 30, 30, 128, 3, 256, 2), (8, 16, 16, 256, 3, 256, 1),
            (8, 16, 16, 256, 3, 512, 2)]
UNITS = [(n, h, w, cin, k, k, cout, s)
         for n, h, w, cin, k, cout, s in MOBILENET + RESNET34]


def _plan(shape, x_type=0, w_type=0, aligned=True, sms=132):
    return mc.launch_plan(*shape, x_type, w_type, aligned, sms)


@pytest.mark.parametrize("shape", SWEEP + UNITS)
def test_plan_covers_each_output_and_reduction_index_once(shape):
    n, h, w, cin, kh, kw, cout, s = shape
    plan = _plan(shape)
    m = n * ((h - kh) // s + 1) * ((w - kw) // s + 1)
    assert (plan.m, plan.k, plan.cout) == (m, kh * kw * cin, cout)
    gx, gy = plan.grid
    assert gx % plan.splits == 0 and 1 <= plan.splits <= mc.MAX_SPLITS
    assert plan.k_chunk % mc.BK == 0 and plan.k_chunk > 0
    summed = np.zeros((m, cout), dtype=np.int64)
    hits = {}
    for bx in range(gx):
        for by in range(gy):
            (r0, r1), (c0, c1), (k0, k1) = plan.block_outputs(bx, by)
            assert r0 < r1 and c0 < c1, f"block {(bx, by)} lies off the edge"
            assert k0 < k1, f"block {(bx, by)}: split of no reduction index"
            summed[r0:r1, c0:c1] += k1 - k0
            hits.setdefault((bx // plan.splits, by), []).append((k0, k1))
    assert (summed == plan.k).all()
    for ranges in hits.values():        # the splits of a tile: disjoint
        k_hits = np.zeros(plan.k, dtype=np.int32)
        for k0, k1 in ranges:
            k_hits[k0:k1] += 1
        assert (k_hits == 1).all()


@pytest.mark.parametrize("tile", list(mc.TILES))
@pytest.mark.parametrize("x_bytes,w_bytes", [(4, 4), (4, 1), (1, 1)])
def test_every_instance_fits_shared_memory(tile, x_bytes, w_bytes):
    """Each instance's dynamic shared memory fits a block, and its launch
    bound's resident blocks fit an SM together."""
    smem = mc.smem_bytes(tile, x_bytes, w_bytes)
    threads, _, resident = mc.TILES[tile]
    assert smem <= SMEM_LIMIT
    assert resident * (smem + 1024) <= SM_SMEM
    assert resident * threads <= 2048


@pytest.mark.parametrize("cout", range(1, 33))
def test_narrow_tiles_for_cout_up_to_32(cout):
    """Cout <= 32 never pads to a 64-wide tile: 128 × 16, or 128 × 32
    for Cout >= 24 where its plan gives every SM two blocks."""
    for n, h, k, cin in ((8, 226, 3, 3), (8, 28, 1, 192), (8, 7, 1, 576),
                         (8, 60, 5, 24)):
        plan = _plan((n, h, h, cin, k, k, cout, 1))
        assert (plan.bm, plan.bn) in (mc.N16, mc.N32)
        if cout < 24 or plan.k < mc.NARROW_K:
            assert (plan.bm, plan.bn) == mc.N16


@pytest.mark.parametrize("unit", MOBILENET)
def test_mobilenet_units_take_the_tile_of_their_shape(unit):
    """MobileNetV2's units reduce over K < 512 and wait on memory: the
    dense panels and Cout <= 32 take the 128 × 16 tile, for the most
    blocks in flight."""
    n, h, w, cin, k, cout, s = unit
    plan = _plan((n, h, w, cin, k, k, cout, s))
    if plan.k < mc.NARROW_K and (k == 1 and s == 1 or cout <= 32):
        assert (plan.bm, plan.bn) == mc.N16
    # Cin % 4 == 0 gathers 16-byte runs: every unit but the Cin 3 stem
    assert plan.a_vec == (16 if cin % 4 == 0 else 4)
    assert plan.dense == (k == 1 and s == 1)


@pytest.mark.parametrize("shape,tile", [
    ((8, 60, 60, 24, 5, 5, 32, 2), mc.N32),       # MobileNetV2's merged 5×5
    ((8, 58, 58, 64, 3, 3, 64, 1), mc.N64),       # ResNet34's 3×3 units
    ((8, 16, 16, 256, 3, 3, 256, 1), mc.N64),
    ((8, 58, 58, 256, 3, 3, 256, 1), mc.WIDE),    # K 2304, 392 blocks
    ((8, 30, 30, 512, 3, 3, 512, 1), mc.WIDE),
    ((8, 7, 7, 576, 1, 1, 96, 1), mc.N16)])       # too few wider blocks
def test_deep_shapes_take_the_widest_tile_that_fills_the_card(shape, tile):
    plan = _plan(shape)
    assert (plan.bm, plan.bn) == tile
    if tile != mc.N16:
        assert plan.blocks >= mc.BLOCKS_PER_SM * 132
    assert (tile == mc.WIDE) <= (plan.k >= mc.WIDE_K)


def _most_blocks(plan) -> int:
    """Blocks of the plan's tile at the most splits its reduction allows
    (whole k-slices, at most ``MAX_SPLITS``)."""
    slices = -(-plan.k // mc.BK)
    tiles = plan.blocks // plan.splits
    return tiles * max(-(-slices // c) for c in range(1, slices + 1)
                       if -(-slices // c) <= mc.MAX_SPLITS)


@pytest.mark.parametrize("unit", MOBILENET)
def test_grid_gives_every_sm_a_block_at_mobilenet_units(unit):
    """Where the tiles and the splits allow it, every one of the H100's
    132 SMs gets a block: the 14×14 and 7×7 units split their reduction."""
    n, h, w, cin, k, cout, s = unit
    plan = _plan((n, h, w, cin, k, k, cout, s))
    assert plan.blocks >= min(132, _most_blocks(plan))
    if h <= 14 and cin >= 192:
        assert plan.splits > 1


def test_plan_follows_the_sm_count():
    shape = (8, 14, 14, 384, 1, 1, 64, 1)
    assert _plan(shape, sms=16).splits < _plan(shape).splits
    assert _plan(shape) == _plan(shape)


@pytest.mark.parametrize("cin,k", [(16, 1), (3, 3), (2 ** 14, 2), (2 ** 15, 2),
                                   (2 ** 17 - 1, 1), (2 ** 17, 1),
                                   (14564, 3), (14565, 3)])
@pytest.mark.parametrize("x_type,w_type", [(0, 0), (0, 1), (1, 1), (0, 2),
                                           (1, 2)])
def test_int8_mma_only_within_its_int32_range(cin, k, x_type, w_type):
    """The int8 mma sums |code · code| <= 2^14 per term in int32: only
    int8 × int8 takes it, and only while K · 2^14 < 2^31."""
    plan = _plan((1, k, k, cin, k, k, 8, 1), x_type, w_type)
    K = k * k * cin
    assert plan.s8 == (x_type == 1 and w_type == 1 and K * 2 ** 14 < 2 ** 31)


@pytest.mark.parametrize("cin,itemsize,aligned,width", [
    (3, 4, True, 4), (16, 4, True, 16), (24, 4, True, 16), (19, 4, True, 4),
    (24, 4, False, 4), (3, 1, True, 1), (12, 1, True, 4), (24, 1, True, 8),
    (144, 1, True, 16), (70, 1, True, 1), (32, 1, False, 1)])
def test_copy_widths(cin, itemsize, aligned, width):
    """16-byte runs where a row holds whole ones and the pointer is
    aligned; 8 or 4 bytes for narrow rows; else one element."""
    assert mc.copy_width(cin, itemsize, aligned) == width


@pytest.mark.parametrize("entry", ["merged_conv", "merged_conv_q"])
def test_c_entry_points_take_the_bound_arguments(entry):
    """ctypes passes exactly the C function's parameters, the plan's eight
    arguments last before the stream."""
    source, c_name, argtypes = cuda_build.SIGNATURES[entry]
    text = (cuda_build.CSRC / f"{source}.cu").read_text()
    decl = re.search(r'extern "C" int ' + c_name + r"\(([^)]*)\)", text)
    params = [p.strip() for p in decl.group(1).split(",")]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert (t is cuda_build.ctypes.c_int) == p.startswith("int "), p
    args = _plan((1, 4, 4, 8, 3, 3, 8, 1)).args()
    assert len(args) == 8
    assert all(p.startswith("int ") for p in params[-1 - len(args):-1])


# -- the precision design -----------------------------------------------------

def _tf32(a: torch.Tensor) -> torch.Tensor:
    """The source's rounding to TF32: half a TF32 ulp added to the bits,
    the low 13 dropped (nearest, ties away from zero)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(a):
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _im2col(x, kh, kw, stride):
    """(M, K) rows of the NHWC input in the kernel's (u, v, c) order."""
    n, h, w, c = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), (kh, kw), stride=stride)
    cols = cols.view(n, c, kh * kw, -1).permute(0, 3, 2, 1)
    return cols.reshape(-1, kh * kw * c)


def _emulate(x, w, plan, stride, product):
    """The kernel's sum: per split, the product over its k range, the
    partials summed in split order (the cluster's order)."""
    kh, kw, cin, cout = w.shape
    # unfold takes no integers: codes go through float64, exactly
    a = _im2col(x.double(), kh, kw, stride).to(x.dtype)
    b = w.reshape(-1, cout)
    total = None
    for s in range(plan.splits):
        k0, k1 = plan.k_range(s)
        part = product(a[:, k0:k1], b[k0:k1])
        total = part if total is None else total + part
    n, h, wd, _ = x.shape
    ho, wo = (h - kh) // stride + 1, (wd - kw) // stride + 1
    return total.reshape(n, ho, wo, cout)


#: A split 14×14 MobileNetV2 unit, a 3×3 stride-2 unit and the Cin 3 stem.
EMULATED = [((8, 14, 14, 384), (1, 1, 384, 64), 1),
            ((2, 15, 13, 16), (3, 3, 16, 24), 2),
            ((2, 17, 17, 3), (3, 3, 3, 32), 2)]


def _operands(xs, ws):
    rng = np.random.default_rng(sum(xs) + sum(ws))
    x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal(ws) / np.sqrt(ws[0] * ws[1]
                                                            * ws[2]))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(ws[3]).astype(np.float32))
    return x, w, b


def _held(y, yr, scale):
    """|Δ| <= 1e-4 · scale + 1e-6 per output, the card checks' tolerance."""
    assert y.shape == yr.shape
    assert bool(((y - yr).abs() <= 1e-4 * scale + 1e-6).all()), \
        float(((y - yr).abs() / scale).max())


@pytest.mark.parametrize("xs,ws,stride", EMULATED)
def test_3xtf32_sum_matches_the_plain_version(xs, ws, stride):
    """fp32 × fp32 as lo·hi' + hi·lo' + hi·hi' per split: within the
    tolerance of ``merged_conv_ref``, near fp32's own rounding; 1xTF32
    alone is more than 16 times coarser."""
    x, w, b = _operands(xs, ws)
    plan = mc.launch_plan(*xs, *ws[:2], ws[3], stride)

    def three(a, bb):
        (ah, al), (bh, bl) = _split(a), _split(bb)
        return (al @ bh + ah @ bl) + ah @ bh
    y = _emulate(x, w, plan, stride, three) + b
    yr = ref.merged_conv_ref(x, w, b, stride=stride)
    scale = ref.merged_conv_ref(x.abs(), w.abs(), b.abs(), stride=stride)
    _held(y, yr, scale)
    one = _emulate(x, w, plan, stride, lambda a, bb: _tf32(a) @ _tf32(bb))
    err3 = float(((y - yr).abs() / scale).max())
    err1 = float(((one + b - yr).abs() / scale).max())
    print(f"{xs}x{ws}: 3xTF32 {err3:.3g}, 1xTF32 {err1:.3g} of the scale")
    assert err3 <= 1e-6 and err1 >= 16 * err3


@pytest.mark.parametrize("xs,ws,stride", EMULATED)
@pytest.mark.parametrize("wmode", ["int8", "fp8"])
def test_2xtf32_sum_matches_the_quantized_plain_version(xs, ws, stride,
                                                        wmode):
    """fp32 × narrow (int8 or e4m3 codes, exact in TF32) as lo·b + hi·b,
    scaled per Cout after the sum."""
    x, w, b = _operands(xs, ws)
    wq, wsc = quant.quantize_weight(w, wmode, axis=3)
    assert torch.equal(_tf32(wq.float()), wq.float())
    plan = mc.launch_plan(*xs, *ws[:2], ws[3], stride, 0, 1)

    def two(a, bb):
        ah, al = _split(a)
        return al @ bb + ah @ bb
    y = _emulate(x, wq.float(), plan, stride, two) * wsc + b
    yr = ref.merged_conv_qref(x, wq, b, wsc, stride=stride)
    scale = ref.merged_conv_ref(x.abs(), quant.dequantize(wq, wsc, axis=3)
                                .abs(), b.abs(), stride=stride)
    _held(y, yr, scale)


@pytest.mark.parametrize("xs,ws,stride", EMULATED)
@pytest.mark.parametrize("wmode", ["int8", "fp8"])
def test_w8a8_sum_matches_the_quantized_plain_version(xs, ws, stride, wmode):
    """int8 × int8 summed exactly in int32 per split (the int8 mma), the
    partials summed as int32, then the folded scale; int8 × e4m3 as one
    TF32 product (both exact in TF32)."""
    x, w, b = _operands(xs, ws)
    wq, wsc = quant.quantize_weight(w, wmode, axis=3)
    xq, xsc = quant.quantize_int8(x)
    plan = mc.launch_plan(*xs, *ws[:2], ws[3], stride, 1,
                          1 if wmode == "int8" else 2)
    assert plan.s8 == (wmode == "int8")
    if plan.s8:
        acc = _emulate(xq.to(torch.int64), wq.to(torch.int64), plan, stride,
                       lambda a, bb: a @ bb)
        assert int(acc.abs().max()) < 2 ** 31
        y = acc.float()
    else:
        y = _emulate(xq.float(), wq.float(), plan, stride,
                     lambda a, bb: a @ bb)
    y = y * (wsc * xsc) + b
    yr = ref.merged_conv_qref(x, wq, b, wsc, stride=stride, act_quant="w8a8")
    xd = quant.dequantize(xq, xsc)
    scale = ref.merged_conv_ref(xd.abs(), quant.dequantize(wq, wsc, axis=3)
                                .abs(), b.abs(), stride=stride)
    _held(y, yr, scale)


def test_sweep_and_unit_plans_reach_every_tile():
    """Between them, the sweep's and the units' shapes and a deep 3×3
    unit take every tile, and some split their reduction."""
    shapes = SWEEP + UNITS + [(8, 58, 58, 256, 3, 3, 256, 1),
                              (8, 60, 60, 24, 5, 5, 32, 2)]
    assert {(p.bm, p.bn) for p in map(_plan, shapes)} == set(mc.TILES)
    assert any(_plan(s).splits > 1 for s in UNITS)
