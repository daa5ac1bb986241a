"""Mamba-2 (SSD — state-space duality) block. [arXiv:2405.21060]

Prefill uses the *chunked dual form*: intra-chunk attention-like products
plus an inter-chunk state recurrence — O(T * Q) compute and memory instead
of O(T^2). Decode is the O(1) recurrent step: the state (B, H, P, N) is
updated and read out.

On the card the SSD scan of a prefill is the hand-written kernel K6
(``repro_torch.kernels.ops.ssd``, any T), which returns y and the final
state in one launch (the JAX package computes the state on the TPU by a
second pass over x, B and dt, in closed form). On the CPU the
chunked scan below runs, as the JAX package runs it off the TPU (its
``lax.scan`` over chunks is a Python loop here). Under autograd the card's
scan takes K6's gradient kernels and the CPU's loop is differentiated by
autograd; the full-sequence pass then runs its fp32 intermediates out of
place (:func:`_in_place_ok`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import donate
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.params import ParamDef


def ssm_defs(cfg: ModelConfig):
    d, di = cfg.d_model, cfg.d_inner
    h, n, grp = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_groups
    return {
        "in_z": ParamDef((d, di), ("embed_fsdp", "ssm_inner")),
        "in_x": ParamDef((d, di), ("embed_fsdp", "ssm_inner")),
        "in_B": ParamDef((d, grp, n), ("embed_fsdp", None, "ssm_state")),
        "in_C": ParamDef((d, grp, n), ("embed_fsdp", None, "ssm_state")),
        "in_dt": ParamDef((d, h), ("embed_fsdp", "ssm_heads")),
        "conv_x": ParamDef((cfg.conv_kernel, di), ("conv_k", "ssm_inner")),
        "conv_B": ParamDef((cfg.conv_kernel, grp, n), ("conv_k", None, "ssm_state")),
        "conv_C": ParamDef((cfg.conv_kernel, grp, n), ("conv_k", None, "ssm_state")),
        "A_log": ParamDef((h,), ("ssm_heads",), init="zeros", dtype=torch.float32),
        "D": ParamDef((h,), ("ssm_heads",), init="ones", dtype=torch.float32),
        "dt_bias": ParamDef((h,), ("ssm_heads",), init="zeros", dtype=torch.float32),
        "gate_norm": ParamDef((di,), ("ssm_inner",), init="ones"),
        "out": ParamDef((di, d), ("ssm_inner", "embed_fsdp")),
    }


def ssm_cache_shapes(cfg: ModelConfig, batch: int):
    """Decode-state shapes and dtypes for ONE layer (stacked by the caller)."""
    return {
        "ssd": ((batch, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
        "conv_x": ((batch, cfg.conv_kernel - 1, cfg.d_inner), torch.bfloat16),
        "conv_B": ((batch, cfg.conv_kernel - 1, cfg.ssm_groups, cfg.ssm_state), torch.bfloat16),
        "conv_C": ((batch, cfg.conv_kernel - 1, cfg.ssm_groups, cfg.ssm_state), torch.bfloat16),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time. x: (B, T, C...), w: (K, C...)."""
    k = w.shape[0]
    orig = x.shape
    x2 = x.reshape(orig[0], orig[1], -1)
    w2 = w.reshape(k, -1)
    pad = torch.zeros(orig[0], k - 1, x2.shape[-1], dtype=x2.dtype, device=x2.device)
    xp = torch.cat([pad, x2], dim=1)
    out = sum(xp[:, i : i + orig[1]] * w2[i] for i in range(k))
    return out.reshape(orig)


def _project_inputs(params, u: torch.Tensor, cfg: ModelConfig):
    """u: (B, T, d) -> z, x, Bm, Cm, dt (pre-conv x/B/C; post-softplus dt)."""
    z = torch.einsum("btd,de->bte", u, params["in_z"])
    x = torch.einsum("btd,de->bte", u, params["in_x"])
    bm = torch.einsum("btd,dgn->btgn", u, params["in_B"])
    cm = torch.einsum("btd,dgn->btgn", u, params["in_C"])
    dt = torch.einsum("btd,dh->bth", u, params["in_dt"]).float()
    dt = F.softplus(dt + params["dt_bias"])  # (B, T, H) fp32
    return z, x, bm, cm, dt


def _in_place_ok(params, *xs: torch.Tensor) -> bool:
    """Whether a full-sequence pass may update its fp32 intermediates in
    place: not under autograd with an input or a parameter that requires
    grad, where an in-place op overwrites a tensor the backward reads."""
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in (*xs, *params.values()) if isinstance(t, torch.Tensor)))


def _gated_out(params, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig, eps: float = 1e-5):
    """SiLU(z)-gated RMSNorm then output projection. Without autograd the fp32
    (B, T, d_inner) intermediates are updated in place (the same products in
    the same order as ``y.float() * silu(z.float())`` etc.), so a prefill
    holds one at a time beside the square, not three; under autograd the
    same ops run out of place."""
    if _in_place_ok(params, y, z):
        yf = F.silu(z.float(), inplace=True).mul_(y)
        ms = yf.square().mean(dim=-1, keepdim=True)
        yf.mul_(torch.rsqrt(ms + eps)).mul_(params["gate_norm"].float())
    else:
        yf = F.silu(z.float()) * y
        ms = yf.square().mean(dim=-1, keepdim=True)
        yf = yf * torch.rsqrt(ms + eps) * params["gate_norm"].float()
    return torch.einsum("bte,ed->btd", yf.to(y.dtype), params["out"])


def ssd_chunked(x, bm, cm, dt, a_log, d_skip, chunk: int, init_state=None):
    """SSD dual form. x: (B,T,H,P); bm/cm: (B,T,G,N); dt: (B,T,H) fp32.

    Returns (y (B,T,H,P) in the dtype of x, final_state (B,H,P,N) fp32)."""
    if init_state is None and x.device.type in ("cuda", "meta"):
        # K6: y and the final state in one launch (any T)
        return kops.ssd(x.contiguous(), bm.contiguous(), cm.contiguous(), dt.contiguous(), a_log, d_skip,
                        return_state=True)
    b, t, h, p = x.shape
    grp, n = bm.shape[2], bm.shape[3]
    q = min(chunk, t)
    if t % q:
        q = t
    nc = t // q
    heads_per_group = h // grp

    a = -torch.exp(a_log.float())  # (H,) negative
    dta = dt * a  # (B,T,H) log-decay per step
    xc = x.reshape(b, nc, q, h, p)
    bc = bm.reshape(b, nc, q, grp, n)
    cc = cm.reshape(b, nc, q, grp, n)
    dtc = dt.reshape(b, nc, q, h)
    dtac = dta.reshape(b, nc, q, h)

    state = init_state if init_state is not None else torch.zeros(b, h, p, n, dtype=torch.float32,
                                                                 device=x.device)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    ys = []
    for c in range(nc):
        xq, bq, cq, dtq, dtaq = xc[:, c], bc[:, c], cc[:, c], dtc[:, c], dtac[:, c]
        cum = torch.cumsum(dtaq, dim=1)  # (B,Q,H) log-decay prefix
        # intra-chunk: L[i,j] = exp(cum_i - cum_j) * dt_j for i >= j (masked
        # before exp: above the diagonal the difference is positive)
        li = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Qi,Qj,H)
        decay = torch.exp(torch.where(causal, li, torch.full_like(li, float("-inf"))))
        lmat = decay * dtq[:, None, :, :]
        scores = torch.einsum("bigm,bjgm->bijg", cq.float(), bq.float())
        scores = torch.repeat_interleave(scores, heads_per_group, dim=3) * lmat  # (B,Qi,Qj,H)
        y_intra = torch.einsum("bijh,bjhp->bihp", scores, xq.float())
        # inter-chunk: contribution of the carried state
        cqh = torch.repeat_interleave(cq, heads_per_group, dim=2)  # (B,Q,H,N)
        y_inter = torch.einsum("bqhn,bhpn->bqhp", cqh.float(), state) * torch.exp(cum)[..., None]
        # state update: S' = S * exp(sum dta) + sum_j exp(cum_Q - cum_j) dt_j B_j x_j
        total = cum[:, -1, :]  # (B,H)
        w_j = torch.exp(total[:, None, :] - cum) * dtq  # (B,Q,H)
        bqh = torch.repeat_interleave(bq, heads_per_group, dim=2).float()  # (B,Q,H,N)
        ds = torch.einsum("bqhp,bqhn->bhpn", xq.float() * w_j[..., None], bqh)
        state = state * torch.exp(total)[:, :, None, None] + ds
        ys.append((y_intra + y_inter).to(x.dtype))  # kept in the model dtype (memory)
    y = torch.stack(ys, dim=1).reshape(b, t, h, p)
    skip = (x.float() * d_skip.float()[None, None, :, None]).to(x.dtype)
    return y + skip, state


def ssd_inputs(params, u: torch.Tensor, cfg: ModelConfig):
    """The projections and causal convs of a full-sequence pass: (z, x0, bm0,
    cm0 before the convs; xh (B,T,H,P), bm, cm (B,T,G,N) after them; dt (B,T,H)
    fp32) — the SSD scan's inputs and what the decode cache keeps."""
    b, t, _ = u.shape
    z, x0, bm0, cm0, dt = _project_inputs(params, u, cfg)
    inplace = _in_place_ok(params, u)  # the convs' fp32 outputs: in place but under autograd
    x = F.silu(_causal_conv(x0, params["conv_x"]).float(), inplace=inplace).to(x0.dtype)
    bm = F.silu(_causal_conv(bm0, params["conv_B"]).float(), inplace=inplace).to(bm0.dtype)
    cm = F.silu(_causal_conv(cm0, params["conv_C"]).float(), inplace=inplace).to(cm0.dtype)
    xh = x.reshape(b, t, cfg.ssm_nheads, cfg.ssm_head_dim)
    return z, x0, bm0, cm0, xh, bm, cm, dt


def apply_ssm(params, u: torch.Tensor, cfg: ModelConfig, init_state=None, return_cache: bool = False):
    """Full-sequence Mamba-2 mixer. u: (B, T, d) -> (B, T, d).

    With ``return_cache`` also returns the decode-continuation state
    (matches :func:`ssm_cache_shapes`)."""
    b, t, _ = u.shape
    z, x0, bm0, cm0, xh, bm, cm, dt = ssd_inputs(params, u, cfg)
    km1 = cfg.conv_kernel - 1
    # the conv histories the cache keeps, taken before the pre-conv inputs go:
    # each (B, T, d_inner) input is dropped once nothing needs it
    tails = {"conv_x": x0[:, -km1:].to(torch.bfloat16), "conv_B": bm0[:, -km1:].to(torch.bfloat16),
             "conv_C": cm0[:, -km1:].to(torch.bfloat16)} if return_cache else None
    del x0, bm0, cm0
    y, state = ssd_chunked(xh, bm, cm, dt, params["A_log"], params["D"], cfg.ssm_chunk, init_state)
    del xh, bm, cm, dt
    out = _gated_out(params, y.reshape(b, t, -1), z, cfg)
    if return_cache:
        return out, {"ssd": state, **tails}
    return out


# The caching allocator serves a request of at most 1 MiB from 2 MiB
# segments, a larger one from a 20 MiB segment; inside a captured graph such a
# segment stays in the graph's pool for as long as the graph lives.
_SMALL_ALLOC_BYTES = 2**20


def _donated_head_slices(state: torch.Tensor) -> list[slice]:
    """Head slices of a (B, H, P, N) state whose update products take at most
    ``_SMALL_ALLOC_BYTES`` each (zamba2-7b's 1.8 MB state: two slices)."""
    b, h, p, n = state.shape
    step = max(1, _SMALL_ALLOC_BYTES // (b * p * n * state.element_size()))
    return [slice(i, min(i + step, h)) for i in range(0, h, step)]


def ssm_decode_step(params, u: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One-token recurrent step. u: (B, 1, d); cache per ssm_cache_shapes.

    Returns (out (B, 1, d), new_cache) — new tensors, the input cache is not
    written, unless it is donated (:func:`repro_torch.donate.donated`): then
    the SSD state is decayed and updated in place (the same operations, in
    the same order, a slice of heads at a time, so that no product takes a
    large allocator segment into a captured graph's pool) and returned as it
    is."""
    b = u.shape[0]
    h, p = cfg.ssm_nheads, cfg.ssm_head_dim
    grp = cfg.ssm_groups
    z, x, bm, cm, dt = _project_inputs(params, u, cfg)

    def conv_step(state, new, w):
        # state: (B, K-1, C...), new: (B, 1, C...), w: (K, C...)
        dtype = torch.promote_types(state.dtype, new.dtype)
        hist = torch.cat([state.to(dtype), new.to(dtype)], dim=1)  # (B, K, C...)
        k = w.shape[0]
        h2 = hist.reshape(b, k, -1)
        out = torch.einsum("bkc,kc->bc", h2, w.reshape(k, -1).to(dtype))
        return out.reshape(new.shape[0], *new.shape[2:]), hist[:, 1:]

    x1, conv_x = conv_step(cache["conv_x"], x, params["conv_x"])
    b1, conv_b = conv_step(cache["conv_B"], bm, params["conv_B"])
    c1, conv_c = conv_step(cache["conv_C"], cm, params["conv_C"])
    x1 = F.silu(x1.float())  # (B, di)
    b1 = F.silu(b1.float())  # (B, G, N)
    c1 = F.silu(c1.float())

    a = -torch.exp(params["A_log"].float())  # (H,)
    dt1 = dt[:, 0]  # (B, H)
    da = torch.exp(dt1 * a)  # (B, H)
    xh = x1.reshape(b, h, p)
    heads_per_group = h // grp
    bh = torch.repeat_interleave(b1, heads_per_group, dim=1)  # (B, H, N)
    ch = torch.repeat_interleave(c1, heads_per_group, dim=1)
    xdt = xh * dt1[..., None]
    if donate.donated():  # the graph's own state: decay and update it in place
        state = cache["ssd"]
        for hs in _donated_head_slices(state):
            state[:, hs].mul_(da[:, hs, None, None]).add_(torch.einsum("bhp,bhn->bhpn", xdt[:, hs], bh[:, hs]))
    else:
        state = cache["ssd"] * da[..., None, None] + torch.einsum("bhp,bhn->bhpn", xdt, bh)
    y = torch.einsum("bhpn,bhn->bhp", state, ch) + xh * params["D"].float()[None, :, None]
    out = _gated_out(params, y.reshape(b, 1, -1).to(u.dtype), z, cfg)
    new_cache = {"ssd": state, "conv_x": conv_x, "conv_B": conv_b, "conv_C": conv_c}
    return out, new_cache
