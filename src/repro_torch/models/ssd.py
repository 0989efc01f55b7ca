"""Mamba-2 SSD (state-space duality): the chunked reference, the
single-token recurrence and the router (the port of
``repro.models.ssd``).

The SSD form computes, per head, y = (L ∘ (C Bᵀ)) x with L the causal
decay matrix, block-wise: an intra-chunk "attention-like" term plus an
inter-chunk state recurrence. :func:`ssd_chunked_ref` is the plain torch
oracle; ``kernels/ssd.py`` holds the hand-written CUDA kernel with the
same contract, reached through ``kernels.ops.ssd``.

Shapes: x (B,T,H,P), B/C (B,T,G,N) with G groups shared by H//G heads,
dt (B,T,H) f32 (already softplus'd), A (H,) f32 (negative), D (H,).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

SSD_IMPLS = ("ref", "kernel")


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-tri pairwise segment sums: out[..., i, j] = sum_{j<m<=i} a[..., m].
    a: (..., Q) -> (..., Q, Q), -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, torch.full((), -torch.inf, dtype=out.dtype,
                                             device=a.device))


def ssd_chunked_ref(x, B, C, dt, A, D, chunk: int = 256,
                    init_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,T,H,P), final_state (B,H,P,N)).

    ``init_state`` (B,H,P,N) f32 seeds the inter-chunk recurrence, so a
    long prompt can be processed in several calls (chunked prefill).
    Right-padding is state-neutral (dt=0 ⇒ decay 1, update 0).

    Storage type follows the input (f32 in the model path); decay terms
    stay f32 and every product accumulates in f32, the reference's
    mixed-precision contract."""
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    q = min(chunk, t)
    pad = (-t) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    tt = x.shape[1]
    nc = tt // q
    cdt = x.dtype
    f32 = torch.float32
    a_eff = dt * A[None, None, :]                                # (B,T,H) f32

    xc = x.reshape(b, nc, q, g, hg, p)
    Bc = B.reshape(b, nc, q, g, n)
    Cc = C.reshape(b, nc, q, g, n)
    dtc = dt.reshape(b, nc, q, g, hg)
    ac = a_eff.reshape(b, nc, q, h).permute(0, 3, 1, 2)          # (B,H,nc,Q)
    cums = torch.cumsum(ac, dim=-1)                              # (B,H,nc,Q)

    # --- intra-chunk (attention-like, causal-decayed) ---
    lmat = torch.exp(_segsum(ac))                                # (B,H,nc,Q,Q)
    lg = lmat.reshape(b, g, hg, nc, q, q)
    scores = torch.einsum("bcigN,bcjgN->bgcij", Cc.to(f32), Bc.to(f32))
    xdt = (xc * dtc[..., None].to(cdt)).to(cdt)                  # (B,nc,Q,G,HG,P)
    y_diag = torch.einsum("bgcij,bghcij,bcjghp->bcighp",
                          scores.to(cdt).to(f32), lg.to(cdt).to(f32),
                          xdt.to(f32))

    # --- per-chunk end states ---
    chunk_sum = cums[..., -1]                                    # (B,H,nc)
    decay_states = torch.exp(chunk_sum[..., None] - cums)        # (B,H,nc,Q)
    dsg = decay_states.reshape(b, g, hg, nc, q)
    states = torch.einsum("bcjgN,bghcj,bcjghp->bcghpN", Bc.to(cdt).to(f32),
                          dsg.to(cdt).to(f32), xdt.to(f32))

    # --- inter-chunk recurrence (sequential over chunks) ---
    if init_state is None:
        s = torch.zeros((b, g, hg, p, n), dtype=f32, device=x.device)
    else:
        s = init_state.to(f32).reshape(b, g, hg, p, n)
    s_prevs = []
    for ci in range(nc):
        s_prevs.append(s)                       # state *before* chunk ci
        decay = torch.exp(chunk_sum[:, :, ci]).reshape(b, g, hg)
        s = s * decay[..., None, None] + states[:, ci]
    s_prev = torch.stack(s_prevs, dim=1)                         # (B,nc,G,HG,P,N)

    # --- inter-chunk output ---
    decay_out = torch.exp(cums).reshape(b, g, hg, nc, q)
    y_off = torch.einsum("bcigN,bghci,bcghpN->bcighp", Cc.to(f32),
                         decay_out, s_prev)

    y = (y_diag + y_off).reshape(b, tt, h, p)
    y = y + x.to(f32) * D[None, None, :, None]
    if pad:
        y = y[:, :t]
    return y.to(x.dtype), s.reshape(b, h, p, n)


def ssd_chunked(x, B, C, dt, A, D, chunk: int = 256, impl: str = "ref",
                init_state: Optional[torch.Tensor] = None):
    """``impl="kernel"`` runs ``kernels.ops.ssd`` (the CUDA kernel on the
    card, its plain twin on the CPU), with or without a carried state;
    ``"ref"`` runs :func:`ssd_chunked_ref`. The reference routes a carried
    state to its ref path because its Pallas kernel starts from zero; the
    port's kernel takes ``init_state``, so every call on the card runs
    it."""
    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        return kops.ssd(x, B, C, dt, A, D, chunk=chunk,
                        init_state=init_state)
    if impl != "ref":
        raise ValueError(f"ssd impl {impl!r} not one of {SSD_IMPLS}")
    return ssd_chunked_ref(x, B, C, dt, A, D, chunk=chunk,
                           init_state=init_state)


def ssd_decode_step(x, B, C, dt, A, D, state
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence. x (B,H,P), B/C (B,G,N), dt (B,H),
    state (B,H,P,N) f32 -> (y (B,H,P), state')."""
    b, h, p = x.shape
    g, n = B.shape[1], B.shape[2]
    hg = h // g
    f32 = torch.float32
    xf = x.to(f32).reshape(b, g, hg, p)
    Bf = B.to(f32)
    Cf = C.to(f32)
    dtf = dt.reshape(b, g, hg)
    da = torch.exp(dtf * A.reshape(g, hg)[None])                 # (B,G,HG)
    sg = state.reshape(b, g, hg, p, n)
    upd = torch.einsum("bghp,bgN->bghpN", xf * dtf[..., None], Bf)
    s_new = sg * da[..., None, None] + upd
    y = torch.einsum("bgN,bghpN->bghp", Cf, s_new)
    y = y + xf * D.reshape(g, hg)[None, ..., None]
    return y.reshape(b, h, p).to(x.dtype), s_new.reshape(b, h, p, n)
