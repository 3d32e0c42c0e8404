"""Mamba-1 selective SSM block (falcon-mamba / hymba substrate): the port of
:mod:`repro.models.ssm`.

Full-sequence path: vectorized projections and a time loop carrying the
(B, di, N) state, cut into chunks as the reference's scan is, each chunk
under ``torch.utils.checkpoint`` when gradients are recorded (the
reference's ``jax.checkpoint``): the backward keeps only the chunks'
boundary states.  The steps and their order are the same with or without
the chunks.
Decode path: the O(1) single-token state update.

Under a mesh both run on this rank's ``d_inner/m`` channels (the weights
come as the model's ``_local_params`` gives them): ``in_proj``'s product on
this rank's stored columns is exchanged over ``model`` into its channels of
``xs`` and of ``z`` (``sharding.tp_halves``), ``x_proj``'s partial product
is summed over ``model`` both ways (every rank uses the sum in its own
channels), ``out_proj``'s forward only.

``softplus`` is ``logaddexp(x, 0)``, the reference's ``jax.nn.softplus``
(``torch.nn.functional.softplus`` switches to the identity past 20).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import constrain, tp_enter, tp_exit, tp_halves, tp_sum


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xs: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, di) with kernel (ck, di)."""
    S, ck = xs.shape[1], w.shape[0]
    pad = F.pad(xs, (0, 0, ck - 1, 0))
    out = torch.zeros(xs.shape, dtype=torch.float32, device=xs.device)
    for j in range(ck):
        out = out + pad[:, j: j + S, :].float() * w[j].float()
    return (out + b.float()).to(xs.dtype)


def _scan_chunk(h, u, dt, Bc, Cc, A):
    """The time loop over one chunk: (the state after it, y (B,c,di))."""
    ys = []
    for t in range(u.shape[1]):
        u_t, dt_t, B_t, C_t = u[:, t], dt[:, t], Bc[:, t], Cc[:, t]
        dA = torch.exp(dt_t.float()[..., None] * A[None])      # (B,di,N)
        dBu = (dt_t * u_t).float()[..., None] * B_t.float()[:, None, :]
        h = h * dA + dBu
        ys.append(torch.einsum("bdn,bn->bd", h, C_t.float()).to(u.dtype))
    return h, torch.stack(ys, dim=1)


def _ssm_inner(u, dt, Bc, Cc, A, D, h0, chunk: int = 64):
    """Selective scan.  u/dt: (B,S,di); Bc/Cc: (B,S,N); A: (di,N); h0: (B,di,N)f32.

    Chunked + per-chunk remat: the naive time loop's backward saves the
    (B,di,N) state at *every* step.  Recomputing each chunk keeps only the
    S/chunk boundary states and one chunk's steps at a time."""
    S = u.shape[1]
    c = min(chunk, S)
    while S % c:
        c //= 2
    h, ys = h0, []
    for t0 in range(0, S, c):
        xs = (u[:, t0:t0 + c], dt[:, t0:t0 + c], Bc[:, t0:t0 + c], Cc[:, t0:t0 + c])
        if torch.is_grad_enabled():
            h, y = checkpoint(_scan_chunk, h, *xs, A, use_reentrant=False)
        else:
            h, y = _scan_chunk(h, *xs, A)
        ys.append(y)
    y = torch.cat(ys, dim=1) + u * D.to(u.dtype)[None, None, :]
    return y, h


def mamba_forward(x: torch.Tensor, p: dict, cfg, h0=None, conv_state=None,
                  return_state: bool = False):
    """Full-sequence mamba block. x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    di, N, dtr = p["A_log"].shape[0], cfg.ssm_state, cfg.dt_rank
    x = tp_enter(x)
    xs, z = tp_halves(x @ p["in_proj"])
    xs = constrain(xs, "batch", None, "tp")
    if conv_state is not None:
        xs_ext = torch.cat([conv_state.to(xs.dtype), xs], dim=1)
        conv_full = _causal_conv(xs_ext, p["conv_w"], p["conv_b"])[:, -S:]
    else:
        conv_full = _causal_conv(xs, p["conv_w"], p["conv_b"])
    u = F.silu(conv_full.float()).to(x.dtype)
    xdbl = tp_sum(u @ p["x_proj"])
    dt_in, Bc, Cc = torch.split(xdbl, [dtr, N, N], dim=-1)
    dt = _softplus(
        (dt_in @ p["dt_proj"]).float() + p["dt_bias"].float()
    ).to(x.dtype)
    A = -torch.exp(p["A_log"].float())
    if h0 is None:
        h0 = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    y, h = _ssm_inner(u, dt, Bc, Cc, A, p["D"], h0)
    y = y * F.silu(z.float()).to(x.dtype)
    out = tp_exit(y @ p["out_proj"])
    if return_state:
        ck = cfg.ssm_conv
        new_conv = (xs if conv_state is None else xs_ext)[:, -(ck - 1):, :]
        return out, h, new_conv
    return out


def mamba_decode_step(x_t: torch.Tensor, p: dict, cfg, h: torch.Tensor,
                      conv_state: torch.Tensor):
    """Single-token update. x_t: (B, d); h: (B, di, N) f32; conv_state: (B, ck-1, di)."""
    dtr, N = cfg.dt_rank, cfg.ssm_state
    x_t = tp_enter(x_t)
    xs, z = tp_halves(torch.einsum("bd,de->be", x_t, p["in_proj"]))  # (B, di)
    win = torch.cat([conv_state.to(xs.dtype), xs[:, None, :]], dim=1)  # (B, ck, di)
    conv = torch.einsum("bkd,kd->bd", win.float(), p["conv_w"].float())
    conv = conv + p["conv_b"].float()
    u = F.silu(conv).to(x_t.dtype)  # (B, di)
    xdbl = tp_sum(torch.einsum("bi,ie->be", u, p["x_proj"]))
    dt_in, Bc, Cc = torch.split(xdbl, [dtr, N, N], dim=-1)
    dt = _softplus(
        torch.einsum("br,ri->bi", dt_in, p["dt_proj"]).float() + p["dt_bias"].float()
    )
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt[..., None] * A[None])
    dBu = (dt * u.float())[..., None] * Bc.float()[:, None, :]
    h = h * dA + dBu
    y = torch.einsum("bdn,bn->bd", h, Cc.float()).to(x_t.dtype)
    y = y + u * p["D"].to(x_t.dtype)[None, :]
    y = y * F.silu(z.float()).to(x_t.dtype)
    out = tp_exit(torch.einsum("bi,id->bd", y, p["out_proj"]))
    return out, h, win[:, 1:, :]
