"""The ``merged_ffn`` kernel's launch plan and its precision design, on the
CPU (no card, no ``nvcc``).

``launch_plan`` decides which blocks the two phases launch (tile shape,
splits of the reduction, k-chunk of a split); the source derives its grid
from the same numbers, so the coverage arithmetic is checked here: every
output element in exactly one tile, every reduction index in exactly one
split.  The kernel multiplies fp32 operands as 3xTF32 (and fp32 × narrow
as 2xTF32); a plain PyTorch emulation of those splits (``cvt.rna.tf32``:
round to nearest, ties away from zero, to 10 mantissa bits) is held
against float64 at the widths of RecurrentGemma-2B, beside the plain fp32
product's own error and 1xTF32's.  Nothing here imports JAX.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels import merged_ffn as mf

#: (M, D, R): ragged and the paths' shapes (RecurrentGemma D 2560, its
#: unmerged GeGLU R 7680; SmolLM D 576; decode M 8, prefill M 128, probes
#: M 1024).
SHAPES = [(8, 2560, 2560), (1, 2561, 7680), (1024, 576, 576), (1, 32, 1),
          (63, 2561, 24), (64, 2560, 2560), (65, 2561, 2560),
          (128, 2560, 7680), (129, 96, 1152), (1024, 2560, 2560),
          (1024, 2561, 7680), (37, 2561, 0)]


def _phases(m, d, r):
    plan = mf.launch_plan(m, d, r)
    return (("A", plan.a, (m, r, d)), ("B", plan.b, (m, d, r)))


@pytest.mark.parametrize("m,d,r", SHAPES)
def test_plan_covers_each_output_and_reduction_index_once(m, d, r):
    for name, ph, (rows, cols, depth) in _phases(m, d, r):
        assert (ph.rows, ph.cols, ph.depth) == (rows, cols, depth), name
        splits, ny, nz = ph.grid
        assert ph.blocks == splits * ny * nz
        # output tiles: the (bm, bn) block at (z, y) covers its rows and
        # columns up to the ragged edge; together they cover (rows, cols)
        seen = np.zeros((rows, cols), dtype=np.int32)
        for z in range(nz):
            for y in range(ny):
                seen[z * ph.bm:(z + 1) * ph.bm, y * ph.bn:(y + 1) * ph.bn] += 1
        assert (seen == 1).all()
        assert (nz - 1) * ph.bm < max(rows, 1) and (ny - 1) * ph.bn < \
            max(cols, 1), f"phase {name}: a tile lies wholly off the edge"
        # splits: whole k-slices that cover [0, depth) once, none empty
        assert ph.k_chunk % mf.BK == 0 and ph.k_chunk > 0
        assert 1 <= splits <= (mf.SMALL if rows <= mf.SMALL_M
                               else mf.LARGE)[3]
        hits = np.zeros(depth, dtype=np.int32)
        for s in range(splits):
            lo, hi = ph.k_range(s)
            assert lo < hi or depth == 0, f"phase {name}: split {s} empty"
            hits[lo:hi] += 1
        assert (hits == 1).all()


@pytest.mark.parametrize("m", [1, 8, 63, 64])
@pytest.mark.parametrize("r", [2560, 7680])
def test_decode_launches_two_blocks_per_sm(m, r):
    """At M <= 64 both phases are bound by the bytes of U and V: each
    launches at least 2 blocks on each of the H100's 132 SMs."""
    for name, ph, _ in _phases(m, 2560, r):
        assert (ph.bm, ph.bn) == mf.SMALL[:2], name
        assert ph.blocks >= 2 * 132, f"phase {name}: {ph.blocks} blocks"


@pytest.mark.parametrize("m,d,r", SHAPES)
def test_workspace_is_p(m, d, r):
    plan = mf.launch_plan(m, d, r)
    assert plan.workspace == (m, r)
    assert len(plan.args()) == 8
    assert plan.args()[:4] == (plan.a.bm, plan.a.bn, plan.a.splits,
                               plan.a.k_chunk)


def test_plan_follows_the_sm_count():
    """Fewer SMs, fewer splits needed to fill them; the plan is a pure
    function of its arguments."""
    big, small = mf.launch_plan(8, 2560, 2560), mf.launch_plan(8, 2560, 2560,
                                                               sms=16)
    assert small.a.splits <= big.a.splits
    assert mf.launch_plan(8, 2560, 2560) == big
    assert mf.launch_plan(1024, 2560, 2560).a.bm == mf.LARGE[0]


@pytest.mark.parametrize("entry", ["merged_ffn", "merged_ffn_q",
                                   "merged_ffn_slots"])
def test_c_entry_points_take_the_bound_arguments(entry):
    """ctypes passes exactly the C function's parameters: the argument
    types bound in ``SIGNATURES`` match the source's declaration."""
    source, c_name, argtypes = cuda_build.SIGNATURES[entry]
    text = (cuda_build.CSRC / f"{source}.cu").read_text()
    decl = re.search(r'extern "C" int ' + c_name + r"\(([^)]*)\)", text)
    params = [p.strip() for p in decl.group(1).split(",")]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert (t is cuda_build.ctypes.c_int) == p.startswith("int "), p
    if entry != "merged_ffn_slots":
        # the wrapper's arguments before the stream: the pointers and
        # types, m, d, r, the plan and the residual switch
        fixed = 5 if entry == "merged_ffn" else 10
        assert len(argtypes) - 1 == fixed + 3 + len(
            mf.launch_plan(8, 32, 8).args()) + 1
        assert params[-2] == "int residual"


# -- the precision design -----------------------------------------------------

ULP = 2.0 ** -24


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: 10 mantissa bits, nearest, ties away."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(a):
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _ulps(y, exact, scale) -> float:
    """max |y − exact| over Σ|a·b|, in fp32 ulps (2^-24)."""
    return float(((y.double() - exact).abs() / scale).max()) / ULP


@pytest.mark.parametrize("k,n", [(2560, 7680), (7680, 2560)])
@pytest.mark.parametrize("kind", ["3xTF32", "2xTF32"])
def test_split_products_keep_fp32_accuracy(k, n, kind):
    """fp32 × fp32 as 3xTF32 (lo·hi' + hi·lo' + hi·hi') and fp32 × narrow
    (int8 codes, exact in TF32) as 2xTF32 stay within a few ulps of
    Σ|a·b| of the float64 product, as the plain fp32 product does; 1xTF32
    is hundreds of ulps off."""
    rng = np.random.default_rng(k + n)
    a = torch.from_numpy(rng.standard_normal((16, k)).astype(np.float32))
    if kind == "3xTF32":
        b = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k))
                             .astype(np.float32))
        (ah, al), (bh, bl) = _split(a), _split(b)
        y = al @ bh + ah @ bl + ah @ bh
    else:
        b = torch.from_numpy(rng.integers(-128, 128, (k, n))
                             .astype(np.float32))
        assert torch.equal(_tf32(b), b)
        ah, al = _split(a)
        y = al @ b + ah @ b
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    err, fp32 = _ulps(y, exact, scale), _ulps(a @ b, exact, scale)
    one = _ulps(_tf32(a) @ _tf32(b), exact, scale)
    print(f"{kind} k={k} n={n}: {err:.3f} ulps of sum|a*b| (fp32 "
          f"{fp32:.3f}, 1xTF32 {one:.1f})")
    assert err <= 4.0 and fp32 <= 4.0
    assert one >= 64.0
