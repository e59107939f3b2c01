"""The port's M-RoPE (Qwen2-VL's three-stream rotary embedding) against
the JAX package's, on the CPU.

* ``apply_mrope`` at head dims 16, 20, 128 and 192 with three distinct
  position streams (at 20 the temporal section, 0.25 · 10 = 2.5, rounds
  to 2 under Python's banker's rounding; both packages use it);
* qwen2-vl-7b reduced to CI size (2 layers, d 32, embeddings frontend,
  QKV bias): prefill logits with a temporal ``arange`` and height / width
  streams of a 2×3 patch grid, and decode logits at every position
  against the JAX package's decode and the port's prefill;
* without position streams an M-RoPE config rotates by plain RoPE, as the
  JAX package does.

Tolerance: max |Δ| ≤ 1e-5 · max |y|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as jL
from repro.models import transformer as jT
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT

from _torch_parity import np_lm_params

RTOL = 1e-5
JC = j_get_config("qwen2-vl-7b").reduced()
TC = t_get_config("qwen2-vl-7b").reduced()


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = float(np.abs(b).max()) + 1e-9
    assert float(np.abs(a - b).max()) <= RTOL * scale, \
        float(np.abs(a - b).max()) / scale


def streams(b, s, grid=(2, 3)):
    """(3, B, S) int32: a temporal ``arange``; height and width of a
    ``grid`` of patches over the first positions, then the text position
    for the rest (all three streams distinct)."""
    n = grid[0] * grid[1]
    t = np.arange(s)
    h = np.where(t < n, t // grid[1], t)
    w = np.where(t < n, t % grid[1], t)
    return np.broadcast_to(np.stack([t, h, w])[:, None, :],
                           (3, b, s)).astype(np.int32).copy()


@pytest.mark.parametrize("d", [16, 20, 128, 192])
def test_apply_mrope_matches(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 9, 3, d)).astype(np.float32)
    pos = streams(2, 9)
    y = tL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    _close(y, jL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    # the streams are distinct: M-RoPE is not plain RoPE here
    plain = tL.apply_rope(torch.from_numpy(x),
                          torch.from_numpy(pos[0]), 1e4)
    assert not torch.allclose(y, plain)


@pytest.fixture(scope="module")
def model():
    params = np_lm_params(JC, seed=3)
    return (tT.params_from_numpy(params),
            jax.tree.map(jnp.asarray, params))


def _batch(b, s, seed=4):
    e = np.random.default_rng(seed).standard_normal(
        (b, s, JC.d_model)).astype(np.float32) * 0.3
    return {"embeds": e, "mrope_positions": streams(b, s)}


def test_config_is_the_vlm_shape():
    assert (TC.frontend, TC.rope_kind, TC.qkv_bias) == \
        ("embeddings", "mrope", True)


def test_forward_and_decode_match(model):
    tp, jp = model
    B, S = 2, 9
    nb = _batch(B, S)
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    y = tT.forward(TC, tp, tb)
    _close(y, jT.forward(JC, jp, {k: jnp.asarray(v) for k, v in nb.items()}))
    tcache = tT.init_cache(TC, B, S, device="cpu")
    jcache = jT.init_cache(JC, B, S)
    jstep = jax.jit(lambda c, b: jT.decode_step(JC, jp, c, b))
    for t in range(S):
        sb = {"embeds": nb["embeds"][:, t:t + 1],
              "mrope_positions": nb["mrope_positions"][:, :, t:t + 1]}
        lt, tcache = tT.decode_step(TC, tp, tcache, {
            k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sb.items()})
        lj, jcache = jstep(jcache, {k: jnp.asarray(v) for k, v in sb.items()})
        _close(lt, lj)
        _close(lt[:, 0], y[:, t])          # decode follows prefill


def test_without_streams_rotates_by_rope(model):
    tp, jp = model
    e = _batch(2, 6)["embeds"]
    y = tT.forward(TC, tp, {"embeds": torch.from_numpy(e)})
    _close(y, jT.forward(JC, jp, {"embeds": jnp.asarray(e)}))
    same = tT.forward(TC, tp, {"embeds": torch.from_numpy(e),
                               "mrope_positions": torch.from_numpy(
                                   np.broadcast_to(np.arange(6), (3, 2, 6))
                                   .copy())})
    _close(same, y)                        # equal streams: plain RoPE
