"""Plain PyTorch versions of the hand-written kernels.

They define each kernel's semantics: the CPU tests hold them against the
JAX package, the kernel wrappers run them for CPU tensors, and
``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _causal_mask(s: int, device):
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()


def flash_attention_ref(q, k, v, causal: bool = True,
                        return_lse: bool = False):
    """q: (B, S, H, D); k/v: (B, S, Hkv, D) with H % Hkv == 0.
    Returns (B, S, H, D) in q's dtype; query head h reads KV head
    h // (H // Hkv).  The softmax weights are rounded to q's dtype before
    the product with V, as the JAX reference does.  With ``return_lse``,
    returns (out, lse): lse (B, H, S) is each row's log-sum-exp of the
    scaled scores, taken in f32 from f32 products of the inputs (as the
    kernel takes them, whatever the inputs' dtype)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) / math.sqrt(d)
    if causal:
        scores = scores.masked_fill(~_causal_mask(s, q.device), float("-inf"))
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v).reshape(b, s, h, d)
    if not return_lse:
        return out
    if q.dtype != torch.float32:
        scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                              k.float()) / math.sqrt(d)
        if causal:
            scores = scores.masked_fill(~_causal_mask(s, q.device),
                                        float("-inf"))
    return out, torch.logsumexp(scores, dim=-1).reshape(b, h, s)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, causal: bool = True):
    """The gradients (dq, dk, dv) of ``flash_attention_ref`` by the explicit
    formulas, in f32 from the inputs' values: P = exp(S·scale − lse),
    dV = Pᵀ dO, dP = dO Vᵀ, Δ = rowsum(dO ⊙ O), dS = P ⊙ (dP − Δ),
    dQ = dS K·scale, dK = dSᵀ Q·scale; dk and dv are summed over the g
    query heads of each KV head.  q/out/dout: (B, S, H, D); k/v:
    (B, S, Hkv, D); lse: (B, H, S) f32.  Returns them in the inputs'
    dtypes."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, s, hkv, g, d)
    dog = dout.float().reshape(b, s, hkv, g, d)
    kf, vf = k.float(), v.float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
    if causal:
        scores = scores.masked_fill(~_causal_mask(s, q.device), float("-inf"))
    p = torch.exp(scores - lse.float().reshape(b, hkv, g, s, 1))
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, vf)
    delta = (dout.float() * out.float()).sum(-1)              # (B, S, H)
    delta = delta.reshape(b, s, hkv, g).permute(0, 2, 3, 1)    # (B,Hkv,g,S)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def paged_attention_ref(q, k_pool, v_pool, page_table, lengths):
    """Decode attention against a paged KV pool.

    q: (B, H, D) one query token per sequence;
    k_pool/v_pool: (P, page_size, Hkv, D);
    page_table: (B, max_pages) int32 (entries < 0 are unmapped);
    lengths: (B,) valid token count per sequence.
    Returns (B, H, D) in q's dtype.  A row with no valid slot
    (lengths == 0) returns zeros.
    """
    b, h, d = q.shape
    p_total, page_size, hkv, _ = k_pool.shape
    max_pages = page_table.shape[1]
    g = h // hkv
    dtype = torch.promote_types(q.dtype, k_pool.dtype)
    safe_table = page_table.clamp(min=0).long()
    k = k_pool[safe_table].to(dtype)           # (B, max_pages, page, Hkv, D)
    v = v_pool[safe_table].to(dtype)
    k = k.reshape(b, max_pages * page_size, hkv, d)
    v = v.reshape(b, max_pages * page_size, hkv, d)
    pos = torch.arange(max_pages * page_size, device=q.device)
    valid = (pos[None] < lengths[:, None]) & \
        (page_table >= 0)[:, pos // page_size]
    qg = q.to(dtype).reshape(b, hkv, g, d)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k) / math.sqrt(d)
    valid = valid[:, None, None]
    scores = scores.float().masked_fill(~valid, float("-inf"))
    # A row with no valid slot would softmax over all -inf (NaN): give it
    # finite scores here and zero weight below.
    scores = scores.masked_fill(~valid.any(-1, keepdim=True), 0.0)
    w = torch.softmax(scores, dim=-1).masked_fill(~valid, 0.0).to(q.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", w.to(dtype), v)
    return out.reshape(b, h, d).to(q.dtype)


def gather_pages_ref(pool, idx):
    """pool: (..., P, page, D); idx: (M,) → (..., M, page, D)."""
    return pool[..., idx.long(), :, :]


def compact_pages_ref(pool, valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference GC compaction: keep pages where valid, packed densely at
    the front (order-preserving).  Returns (new_pool, new_index_of_old)
    where new_index_of_old[i] = destination of page i or -1 if dropped."""
    valid = torch.as_tensor(valid, dtype=torch.bool, device=pool.device)
    dst = torch.cumsum(valid.int(), 0, dtype=torch.int32) - 1
    new_index = torch.where(valid, dst, -1)
    order = torch.argsort((~valid).int(), stable=True)   # valid pages first
    return pool[order], new_index


def ssd_scan_ref(x, dt, a, bmat, cmat, initial_state=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence (the definitional oracle).

    x: (B, S, H, P); dt: (B, S, H); a: (H,) < 0; bmat/cmat: (B, S, N).
    Returns (y: (B, S, H, P), final_state: (B, H, P, N) float32)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)                          # (B,H)
        state = state * decay[..., None, None] + \
            (dt[:, t, :, None] * x[:, t])[..., None] * bmat[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, cmat[:, t]))
    return torch.stack(ys, 1), state


def _segsum_exp(dA_cs):
    """exp(segsum): the lower-triangular decay matrix of each chunk.
    dA_cs: (..., cl) cumulative sums -> (..., cl, cl).  The mask is applied
    before the exp (-inf -> 0): exp over the upper triangle would overflow
    within one chunk (exp(+93) at dA = -0.72 a step and cl = 128)."""
    diff = dA_cs[..., :, None] - dA_cs[..., None, :]
    cl = dA_cs.shape[-1]
    mask = torch.ones((cl, cl), dtype=torch.bool, device=dA_cs.device).tril()
    return torch.exp(diff.masked_fill(~mask, float("-inf")))


def ssd_chunked_ref(x, dt, a, bmat, cmat, chunk: int,
                    initial_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, the plain version of the ``ssd_scan`` kernel: per
    chunk the intra-chunk term ((C.B^T) * L).(x.dt), the carried state's
    term (C.state^T).exp(cumsum dA), and the state update.
    x: (B,S,H,P) dt: (B,S,H) a: (H,) < 0 bmat/cmat: (B,S,N); S % chunk == 0.
    Returns (y: (B,S,H,P), final_state: (B,H,P,N))."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd: seq {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    bc = bmat.reshape(b, nc, chunk, n)
    cc = cmat.reshape(b, nc, chunk, n)

    dA_cs = torch.cumsum(dtc * a, dim=2)                    # (B,nc,cl,H)
    decay = _segsum_exp(dA_cs.movedim(-1, -2))              # (B,nc,H,cl,cl)
    xdt = xc * dtc[..., None]                               # (B,nc,cl,H,P)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)        # (B,nc,cl,cl)
    gated = decay * scores[:, :, None, :, :]                # (B,nc,H,cl,cl)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", gated, xdt)

    # chunk-final states: sum_j exp(dA_sum - dA_cs_j) dt_j B_j x_j
    dA_sum = dA_cs[:, :, -1:, :]                            # (B,nc,1,H)
    state_decay = torch.exp(dA_sum - dA_cs)                 # (B,nc,cl,H)
    chunk_states = torch.einsum("bcjn,bcjh,bcjhp->bchpn",
                                bc, state_decay * dtc, xc)

    # inter-chunk recurrence; prev[c] is the state entering chunk c
    chunk_decay = torch.exp(dA_sum[:, :, 0, :])             # (B,nc,H)
    state = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
             if initial_state is None else initial_state)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, 1)                      # (B,nc,H,P,N)

    in_decay = torch.exp(dA_cs)                             # (B,nc,cl,H)
    y_off = torch.einsum("bcin,bchpn,bcih->bcihp", cc, prev_states, in_decay)
    return (y_diag + y_off).reshape(b, s, h, p), state


def ssd_chunked_bwd_ref(x, dt, a, bmat, cmat, chunk: int,
                        initial_state: Optional[torch.Tensor], dy,
                        dfinal: Optional[torch.Tensor]):
    """The gradients of ``ssd_chunked_ref`` by explicit formulas in the
    chunked form, the plain version of the ``ssd_scan_bwd`` kernel.  Per
    chunk, head and step, with cs the cumsum of dA = dt·a within the chunk,
    L_ij = exp(cs_i − cs_j) (i ≥ j, masked before the exp) and
    w_j = exp(cs_last − cs_j)·dt_j:

    - G_c = Σ_i exp(cs_i) dy_iᵀ C_i, the gradient of the state entering
      chunk c through its own output;
    - the reverse state passing D_c = G_c + exp(cs_last,c)·D_{c+1} from
      D_nc = dfinal; D_{c+1} is the gradient of the state leaving chunk c
      and D_0 that of the initial state;
    - dS_ij = L_ij (dy_i · dt_j x_j), summed over heads, the gradient of
      C_i·B_j; dC gets dS B + exp(cs_i) dy_i·prev_c, dB gets dSᵀ C
      + w_j x_jᵀ D_{c+1};
    - d(cs) through L, exp(cs_i), w_j and exp(cs_last) of the state
      passing; its reverse cumsum within the chunk is d(dA), whence
      ddt += a·d(dA) and da = Σ dt·d(dA).

    ``dfinal`` None is zeros.  Returns (dx, ddt, da, dB, dC, dinit), dinit
    None when ``initial_state`` is None."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    bc = bmat.reshape(b, nc, chunk, n)
    cc = cmat.reshape(b, nc, chunk, n)
    dyc = dy.reshape(b, nc, chunk, h, p)

    dA_cs = torch.cumsum(dtc * a, dim=2)                    # (B,nc,cl,H)
    decay = _segsum_exp(dA_cs.movedim(-1, -2))              # (B,nc,H,i,j)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)
    gated = decay * scores[:, :, None]
    dA_sum = dA_cs[:, :, -1:, :]
    state_decay = torch.exp(dA_sum - dA_cs)                 # exp(cs_last-cs_j)
    w = state_decay * dtc
    in_decay = torch.exp(dA_cs)                             # exp(cs_i)
    chunk_decay = torch.exp(dA_sum[:, :, 0, :])             # (B,nc,H)

    # the forward's states: prev[:, c] enters chunk c
    chunk_states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", bc, w, xc)
    zeros = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    state = zeros if initial_state is None else initial_state
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev = torch.stack(prev, 1)                             # (B,nc,H,P,N)

    # reverse state passing: dnext[:, c] is D_{c+1}
    g = torch.einsum("bcih,bcihp,bcin->bchpn", in_decay, dyc, cc)
    d = zeros if dfinal is None else dfinal
    dnext = [None] * nc
    for c in reversed(range(nc)):
        dnext[c] = d
        d = g[:, c] + chunk_decay[:, c, :, None, None] * d
    dnext = torch.stack(dnext, 1)

    dyx = torch.einsum("bcihp,bcjhp->bchij", dyc, xc * dtc[..., None])
    dscores = (decay * dyx).sum(2)                          # (B,nc,i,j)
    dxdt = torch.einsum("bchij,bcihp->bcjhp", gated, dyc)
    db = torch.einsum("bchpn,bcjn->bcjhp", dnext, bc)       # D_{c+1} B_j
    dw = (xc * db).sum(-1)                                  # (B,nc,cl,H)
    dx = dxdt * dtc[..., None] + w[..., None] * db
    ddt = (xc * dxdt).sum(-1) + state_decay * dw
    dc = (torch.einsum("bcij,bcjn->bcin", dscores, bc)
          + torch.einsum("bcih,bcihp,bchpn->bcin", in_decay, dyc, prev))
    dbm = (torch.einsum("bcij,bcin->bcjn", dscores, cc)
           + torch.einsum("bcjh,bcjhp,bchpn->bcjn", w, xc, dnext))

    q = gated * dyx                                         # L's gradient · L
    dcs = (q.sum(-1) - q.sum(-2)).movedim(2, -1)            # (B,nc,cl,H)
    y_off = torch.einsum("bchpn,bcin->bcihp", prev, cc)     # without exp(cs_i)
    dcs = dcs + in_decay * (dyc * y_off).sum(-1) - w * dw
    last = (w * dw).sum(2) + chunk_decay * (dnext * prev).sum((-2, -1))
    dcs = torch.cat([dcs[:, :, :-1], dcs[:, :, -1:] + last[:, :, None]], 2)
    ddA = dcs.flip(2).cumsum(2).flip(2)
    ddt = ddt + a * ddA
    da = (dtc * ddA).sum((0, 1, 2))
    return (dx.reshape(b, s, h, p), ddt.reshape(b, s, h), da,
            dbm.reshape(b, s, n), dc.reshape(b, s, n),
            None if initial_state is None else d)
