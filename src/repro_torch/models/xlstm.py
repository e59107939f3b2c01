"""xLSTM blocks (arXiv:2405.04517) — mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, sequential).

The JAX package's ``models/xlstm.py`` in PyTorch, with its parameter
names, layouts and logical axes.  mLSTM per head::

    C_t = f_t C_{t-1} + i_t v_t k_tᵀ ;  n_t = f_t n_{t-1} + i_t k_t
    h_t = C_t q_t / max(|n_tᵀ q_t|, 1)

with log-space stabilization (``m_t``, a running max).  Prefill uses the
chunkwise-parallel form (intra-chunk quadratic, the state carried from
chunk to chunk) where the JAX package scans the chunks with
``lax.scan``; here a Python loop over the chunks.  sLSTM is sequential: a
Python loop over time steps.  Decode is one fused state update, written
into the state's tensors in place (their storage stays, so a captured
step replays against them).  The stabilizer starts at ``m = -1e30``, the
JAX package's constant: a fresh state is not all zeros, so a reset must
copy a fresh state, not zero one (:mod:`repro_torch.runtime.serving`).

Everything is plain PyTorch: the recurrences are plain ``jnp`` in the JAX
package, no Pallas kernel.  LayerMerge: both blocks have input-dependent
gates, so they are prunable and never linearized.

Under a mesh the heads are split over 'model' (the JAX package's
'heads' axes): each rank holds its heads' projections, gates and state
(``(batch, heads, …)``, its rows of the batch and its heads), and ``wo``
is row-parallel: a block's output on its heads is a partial
(:func:`xlstm_partial`).  The sLSTM block returns it and the layer sums
it; the mLSTM block sums it itself, before it adds the skip path, which
every rank computes whole.  The replicated input enters the split heads
through :func:`repro_torch.sharding.collectives.enter_split`, so a loss
differentiates through either block.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import draw_device
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import active_rules, local_shape

#: The stabilizer of a fresh state (the JAX package's constant).
M_INIT = -1e30


def _state_shape(names, shape):
    return local_shape(names, shape)[0]


def xlstm_partial(p, cfg) -> bool:
    """Whether these (local) weights hold a block of the heads: the
    output projection then gives a partial over 'model'."""
    return p["wo"].shape[0] < cfg.num_heads


def _split_in(p, x, cfg):
    """``x`` entering the split heads (its gradient summed over 'model'),
    and the mesh, or ``(x, None)`` where the block holds every head."""
    if not xlstm_partial(p, cfg):
        return x, None
    mesh = active_rules().mesh
    return C.enter_split(x, mesh, "model"), mesh


def _sum_heads(y, mesh):
    if mesh is None:
        return y
    return C.all_reduce(y, mesh, "model")


def mlstm_axes():
    return {"wq": ("embed", "heads", "head"), "wk": ("embed", "heads", "head"),
            "wv": ("embed", "heads", "head"), "wi": ("embed", "heads"),
            "wf": ("embed", "heads"), "bf": ("heads",), "bi": ("heads",),
            "wo": ("heads", "head", "embed"), "skip": ("embed", "embed")}


def _normal(gen, shape, dtype, scale):
    return (torch.randn(shape, generator=gen, device=draw_device(gen))
            * scale).to(dtype)


def init_mlstm(cfg, gen: torch.Generator, dtype):
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    s = 1.0 / math.sqrt(d)
    p = {"wq": _normal(gen, (d, h, hd), dtype, s),
         "wk": _normal(gen, (d, h, hd), dtype, s),
         "wv": _normal(gen, (d, h, hd), dtype, s),
         "wi": _normal(gen, (d, h), dtype, s),
         "wf": _normal(gen, (d, h), dtype, s),
         "bf": torch.full((h,), 3.0, dtype=dtype),   # forget-gate bias (keep)
         "bi": torch.zeros((h,), dtype=dtype),
         "wo": _normal(gen, (h, hd, d), dtype, s),
         "skip": _normal(gen, (d, d), dtype, s)}
    return p, mlstm_axes()


def _mlstm_chunk_scan(q, k, v, log_i, log_f, chunk: int):
    """Chunkwise-parallel mLSTM.  q, k, v: (B, S, H, D); gates: (B, S, H)
    logs; the state carried across the chunks in order."""
    b, s, h, d = q.shape
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    q, k, v = (t.reshape(b, nc, chunk, h, d).float() for t in (q, k, v))
    log_i = log_i.reshape(b, nc, chunk, h).float()
    log_f = log_f.reshape(b, nc, chunk, h).float()
    csum_f = torch.cumsum(log_f, dim=2)                    # within-chunk
    total_f = csum_f[:, :, -1]                             # (B, NC, H)

    # intra-chunk decay matrix: D[t,u] = sum_{u<τ<=t} logf + logi_u (u <= t)
    dmat = csum_f[:, :, :, None, :] - csum_f[:, :, None, :, :] \
        + log_i[:, :, None, :, :]                          # (B, NC, T, U, H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    dmat = torch.where(tri[None, None, :, :, None], dmat, -math.inf)

    scale = math.sqrt(d)
    C = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), M_INIT, dtype=torch.float32, device=q.device)
    outs = []
    for c in range(nc):
        qc, kc, vc = q[:, c], k[:, c], v[:, c]
        d_c, csf, lgi, tot = dmat[:, c], csum_f[:, c], log_i[:, c], \
            total_f[:, c]
        # stabilizer: max over inter (m + csf) and intra (row max of dmat)
        intra_max = d_c.amax(dim=2)                        # (B, T, H) over U
        m_new = torch.maximum(m[:, None] + csf, intra_max)
        inter_w = torch.exp(m[:, None] + csf - m_new)      # (B, T, H)
        intra_w = torch.exp(d_c - m_new[:, :, None])       # (B, T, U, H)
        scores = torch.einsum("bthd,buhd->btuh", qc, kc) / scale
        att = scores * intra_w
        out_intra = torch.einsum("btuh,buhd->bthd", att, vc)
        # C is (value dim d, key dim e): contract q against the key dim
        out_inter = torch.einsum("bthe,bhde->bthd", qc, C) / scale
        out_inter = out_inter * inter_w[..., None]
        den_intra = att.sum(dim=2)                         # Σ_u w·(kᵀq/√d)
        den_inter = torch.einsum("bthd,bhd->bth", qc, n) / scale * inter_w
        den = torch.abs(den_intra + den_inter)
        outs.append((out_intra + out_inter)
                    / torch.clamp(den, min=1.0)[..., None])
        # carry the state to the chunk's end (stabilized by the new max)
        m_end = torch.maximum(m + tot, d_c[:, -1].amax(dim=1))
        decay_old = torch.exp(m + tot - m_end)             # (B, H)
        kw_st = torch.exp(csf[:, -1][:, None] - csf + lgi - m_end[:, None])
        C = C * decay_old[..., None, None] \
            + torch.einsum("buh,buhd,buhe->bhde", kw_st, vc, kc)
        n = n * decay_old[..., None] \
            + torch.einsum("buh,buhd->bhd", kw_st, kc)
        m = m_end
    return torch.stack(outs, dim=1).reshape(b, s, h, d)


def _mlstm_gates(p, x):
    """(log i, log f) in fp32: log-sigmoids of the gate pre-activations."""
    log_i = F.logsigmoid((x @ p["wi"] + p["bi"]).float())
    log_f = F.logsigmoid((x @ p["wf"] + p["bf"]).float())
    return log_i, log_f


def mlstm_block(p, x, cfg, chunk: int = 64):
    """Full temporal block for prefill: (B, S, D) → (B, S, D); chunks of
    ``min(chunk, S)`` positions, which must divide S."""
    s = x.shape[1]
    xs, mesh = _split_in(p, x, cfg)
    q = torch.einsum("bsd,dhk->bshk", xs, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", xs, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xs, p["wv"])
    log_i, log_f = _mlstm_gates(p, xs)
    out = _mlstm_chunk_scan(q, k, v, log_i, log_f, min(chunk, s))
    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    return _sum_heads(y, mesh) + F.silu(x @ p["skip"])


def mlstm_decode(p, x, cfg, state):
    """One-step decode: x (B, 1, D); state ``{"C": (B, H, D, D), "n": (B,
    H, D), "m": (B, H)}`` fp32 → ``(y, state)``, the state written in
    place."""
    xs, mesh = _split_in(p, x, cfg)
    q = torch.einsum("bsd,dhk->bshk", xs, p["wq"])[:, 0].float()
    k = torch.einsum("bsd,dhk->bshk", xs, p["wk"])[:, 0].float()
    v = torch.einsum("bsd,dhk->bshk", xs, p["wv"])[:, 0].float()
    log_i, log_f = (t[:, 0] for t in _mlstm_gates(p, xs))
    m = state["m"]
    m_new = torch.maximum(m + log_f, log_i)
    decay = torch.exp(m + log_f - m_new)
    inw = torch.exp(log_i - m_new)
    C = state["C"] * decay[..., None, None] \
        + inw[..., None, None] * v[..., :, None] * k[..., None, :]
    n = state["n"] * decay[..., None] + inw[..., None] * k
    hd = q.shape[-1]
    num = torch.einsum("bhde,bhe->bhd", C, q) / math.sqrt(hd)
    den = torch.abs(torch.einsum("bhd,bhd->bh", n, q)) / math.sqrt(hd)
    out = (num / torch.clamp(den, min=1.0)[..., None]).to(x.dtype)
    y = _sum_heads(torch.einsum("bhk,hkd->bd", out, p["wo"])[:, None], mesh)
    state["C"].copy_(C)
    state["n"].copy_(n)
    m.copy_(m_new)
    return y + F.silu(x @ p["skip"]), state


def init_mlstm_state(cfg, batch, device=None):
    h = cfg.num_heads
    hd = cfg.d_model // h
    return {"C": torch.zeros(
                _state_shape(MLSTM_STATE_AXES["C"], (batch, h, hd, hd)),
                dtype=torch.float32, device=device),
            "n": torch.zeros(
                _state_shape(MLSTM_STATE_AXES["n"], (batch, h, hd)),
                dtype=torch.float32, device=device),
            "m": torch.full(_state_shape(MLSTM_STATE_AXES["m"], (batch, h)),
                            M_INIT, dtype=torch.float32, device=device)}


MLSTM_STATE_AXES = {"C": ("batch", "heads", None, None),
                    "n": ("batch", "heads", None), "m": ("batch", "heads")}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_axes():
    return {"wz": ("embed", "heads", "head"), "wi": ("embed", "heads", "head"),
            "wf": ("embed", "heads", "head"),
            "wo_gate": ("embed", "heads", "head"), "bf": ("heads", "head"),
            "wo": ("heads", "head", "embed")}


def init_slstm(cfg, gen: torch.Generator, dtype):
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    s = 1.0 / math.sqrt(d)
    p = {"wz": _normal(gen, (d, h, hd), dtype, s),
         "wi": _normal(gen, (d, h, hd), dtype, s),
         "wf": _normal(gen, (d, h, hd), dtype, s),
         "wo_gate": _normal(gen, (d, h, hd), dtype, s),
         "bf": torch.full((h, hd), 3.0, dtype=dtype),
         "wo": _normal(gen, (h, hd, d), dtype, s)}
    return p, slstm_axes()


def _slstm_step(carry, gates):
    c, n, m = carry
    z, i_log, f_log, o = gates
    m_new = torch.maximum(f_log + m, i_log)
    i_w = torch.exp(i_log - m_new)
    f_w = torch.exp(f_log + m - m_new)
    c_new = f_w * c + i_w * torch.tanh(z)
    n_new = f_w * n + i_w
    h = o * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, m_new), h


def _slstm_gates(p, x):
    """(z, log i, log f, o), each (B, S, H, D) fp32."""
    def proj(w):
        return torch.einsum("bsd,dhk->bshk", x, w).float()
    z = proj(p["wz"])
    i_log = proj(p["wi"])
    f_log = F.logsigmoid(proj(p["wf"]) + p["bf"].float())
    o = torch.sigmoid(proj(p["wo_gate"]))
    return z, i_log, f_log, o


def slstm_block(p, x, cfg):
    """Full temporal block for prefill: (B, S, D) → (B, S, D), one step
    of the recurrence per position (a partial over 'model' where the
    heads are split: :func:`xlstm_partial`)."""
    b = x.shape[0]
    gates = _slstm_gates(p, _split_in(p, x, cfg)[0])
    z = gates[0]
    zeros = torch.zeros((b,) + tuple(z.shape[2:]), dtype=torch.float32,
                        device=x.device)
    carry = (zeros, zeros, torch.full_like(zeros, M_INIT))
    hs = []
    for t in range(x.shape[1]):
        carry, h = _slstm_step(carry, tuple(g[:, t] for g in gates))
        hs.append(h)
    h = torch.stack(hs, dim=1).to(x.dtype)                  # (B, S, H, D)
    return torch.einsum("bshk,hkd->bsd", h, p["wo"])


def slstm_decode(p, x, cfg, state):
    """One-step decode: x (B, 1, D); state ``{"c", "n", "m"}`` each (B, H,
    D) fp32 → ``(y, state)``, the state written in place (``y`` a
    partial over 'model' where the heads are split)."""
    gates = tuple(g[:, 0] for g in _slstm_gates(p, x))
    (c, n, m), h = _slstm_step((state["c"], state["n"], state["m"]), gates)
    y = torch.einsum("bhk,hkd->bd", h.to(x.dtype), p["wo"])[:, None]
    state["c"].copy_(c)
    state["n"].copy_(n)
    state["m"].copy_(m)
    return y, state


def init_slstm_state(cfg, batch, device=None):
    h = cfg.num_heads
    hd = cfg.d_model // h
    z = torch.zeros(_state_shape(SLSTM_STATE_AXES["c"], (batch, h, hd)),
                    dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(), "m": torch.full_like(z, M_INIT)}


SLSTM_STATE_AXES = {"c": ("batch", "heads", None),
                    "n": ("batch", "heads", None),
                    "m": ("batch", "heads", None)}
