"""The launch plan of the ``rmsnorm`` kernel on the CPU (no card, no
``nvcc``).

``launch_plan`` picks the path (a warp a row, a block a row four elements
a load, a block a row element by element), the rows a block and the chunks
a lane; the source (``csrc/rmsnorm.cu``) derives its grid and indexing
from the same numbers.  Both bodies (fp32 and bf16) take the plan of the
shape, never of the dtype, so they sum every row in one order.  Checked
here: every row written by exactly one warp or block, every element of a
row by exactly one lane of its warp, the instances the plan names being
the ones the source dispatches.  Nothing here imports JAX.
"""
import re

import numpy as np
import pytest

from repro_torch.kernels import cuda_build
from repro_torch.kernels import rmsnorm as rn

#: (M, D) of the four published configs' norms (SmolLM-135M,
#: RecurrentGemma-2B, gemma-7b, qwen2-7b) at a decode step, a prefill of
#: 8 × 16 and a probe of 8 × 128, and SmolLM-135M's training rows.
BF16_NORMS = [(m, d) for d in (576, 2560, 3072, 3584)
              for m in (8, 128, 1024)] + [(8192, 576)]
#: Ragged, narrow and wide rows, and the M of one and eight rows.
OTHER_NORMS = [(1, 32), (8, 32), (1, 576), (37, 576), (8, 512), (5, 36),
               (37, 2561), (1, 2561), (8, 640), (8, 644), (1024, 768),
               (8, 1024), (3, 8192), (1, 16384)]

SOURCE = cuda_build.CSRC / "rmsnorm.cu"


def _cover(plan):
    """How often each (row, element) is written under the plan."""
    seen = np.zeros((plan.m, plan.d), dtype=np.int32)
    for x in range(plan.blocks):
        rows = plan.block_rows(x)
        assert 0 < len(rows) <= plan.wr
        for r in rows:
            if plan.path == "warp":
                for lane in range(32):
                    for c in plan.lane_chunks(lane):
                        seen[r, rn.CHUNK * c:rn.CHUNK * (c + 1)] += 1
            else:
                seen[r] += 1
    return seen


@pytest.mark.parametrize("m,d", BF16_NORMS + OTHER_NORMS)
def test_norm_plan_covers_each_row_once(m, d):
    plan = rn.launch_plan(m, d)
    assert (_cover(plan) == 1).all()
    assert plan.threads <= rn.THREADS and plan.threads % 32 == 0
    if plan.path == "warp":
        assert plan.nq in rn.WARP_CHUNKS and 32 * rn.CHUNK * plan.nq >= d
        smaller = [n for n in rn.WARP_CHUNKS if n < plan.nq]
        assert all(32 * rn.CHUNK * n < d for n in smaller)
    assert plan.args() == (rn.PATHS[plan.path], plan.wr, plan.nq)


@pytest.mark.parametrize("m,d", BF16_NORMS + OTHER_NORMS)
def test_norm_plan_path_follows_the_row(m, d):
    """A warp a row for D % 4 == 0 up to ``WARP_MAX_D``, a block a row
    above it; ragged or unaligned rows element by element."""
    plan = rn.launch_plan(m, d)
    if d % 4:
        assert plan.path == "scalar"
    else:
        assert plan.path == ("warp" if d <= rn.WARP_MAX_D else "block")
    assert rn.launch_plan(m, d, aligned=False).path == "scalar"


@pytest.mark.parametrize("m,wr", [(1, 1), (8, 1), (128, 1), (1024, 4),
                                  (8192, 8)])
def test_norm_plan_rows_a_block_by_fill(m, wr):
    """One row a block where M cannot give every SM a block (a decode
    step, a prefill of 8 × 16), the most rows a block that still do
    otherwise; the SM count given."""
    assert rn.launch_plan(m, 576).wr == wr
    assert rn.launch_plan(m, 576, sms=8).wr == min(8, max(1, m // 8))


def test_norm_plan_mirrors_the_source():
    """The warp path's instances are the chunk counts the plan names, the
    block path's threads are ``THREADS``, the path codes are the source's,
    and the C entry points take the plan's three ints before the
    stream."""
    text = SOURCE.read_text()
    cases = sorted(int(n) for n in re.findall(
        r"case (\d+): return launch_warp<T, G, \1>", text))
    assert tuple(cases) == rn.WARP_CHUNKS
    assert f"constexpr int THREADS = {rn.THREADS};" in text
    for path, code in rn.PATHS.items():
        assert f"path == {code}" in text or f"path != {code}" in text, path
    for entry in ("rmsnorm", "rmsnorm_bf16"):
        _, c_name, argtypes = cuda_build.SIGNATURES[entry]
        decl = re.search(r'extern "C" int ' + c_name + r"\(([^)]*)\)", text)
        params = [p.strip() for p in decl.group(1).split(",")]
        assert len(params) == len(argtypes)
        assert [p.split()[-1] for p in params[-4:-1]] == ["path", "wr", "nq"]
