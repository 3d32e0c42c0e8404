"""Transformer building blocks: norms, RoPE, chunked (flash-style) attention
with its FlashAttention backward, decode attention, MLP variants and the
sorted-grouped-GEMM MoE without a mesh.  The port of
:mod:`repro.models.layers`.

Activations flow in bf16 with float32 softmax and norm statistics, as in the
reference.  Where the reference asks its products for a float32 result
(``preferred_element_type=jnp.float32``: attention scores and the PV
product), the operands are bf16 values upcast to float32 and multiplied in
float32: a product of two bf16 values is exact in float32, so the result is
the reference's up to summation order.  The other products stay in bf16,
as the reference's do.  Attention is plain torch that follows the
reference's algorithm step for step (never ``scaled_dot_product_attention``),
so that its arithmetic can be traced against it; its backward is the
reference's custom VJP (``_Flash``), and the JAX package computes neither
in a Pallas kernel.

The products against a weight matrix (the reference's dots with no batch
dimension, ``bsd,de->bse``) are written ``x @ w``, which runs as one
``aten.mm``; the batched ones (attention, the MoE's experts) are einsums,
which run as ``aten.bmm``.  The ``dots`` remat policy
(:mod:`repro_torch.models.transformer`) saves exactly the ``aten.mm``
outputs, as ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
saves the reference's.

With a mesh, ``moe_apply`` is the reference's expert-parallel ``shard_map``
body in explicit collectives over the mesh's process groups
(``distributed/sharding``); ``mlp_apply`` takes this rank's columns of
``wi0``/``wi1`` and rows of ``wo`` and sums its partial output over
``model`` (dense tensor parallelism), and ``decode_attention`` over a window
split across ranks combines their softmax partials.
"""
from __future__ import annotations

import math
import os
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.distributed import sharding

ACT_DTYPE = torch.bfloat16
NEG_INF = -1e30     # the reference's mask value


def quantize_kv(x: torch.Tensor):
    """Per-vector int8 quantization over the last (head) dim: (q, scale)."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype=ACT_DTYPE) -> torch.Tensor:
    return (q.float() * s.float()[..., None]).to(dtype)


def cast_tree(p: dict, dtype=ACT_DTYPE) -> dict:
    """Cast float params to the activation dtype (compute-dtype cast)."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in p.items()}


def sub_params(p: dict, prefix: str) -> dict:
    """The entries ``prefix.name`` of a layer's parameters, keyed ``name``."""
    return {k.split(".", 1)[1]: v for k, v in p.items() if k.startswith(prefix + ".")}


def _f32_product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with a float32 result, as ``preferred_element_type=float32``."""
    return torch.einsum(eq, a.float(), b.float())


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (full / partial a.k.a. chatglm "2d")
# ---------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, dim: int, base: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(base, dtype=torch.float32, device=positions.device), exps)
    return positions.float()[..., None] * freqs  # (..., half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, variant: str = "full") -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,). variant partial rotates hd/2."""
    if variant == "none":
        return x
    B, S, H, hd = x.shape
    rot_dim = hd if variant == "full" else hd // 2
    if positions.dim() == 1:
        positions = positions[None, :].expand(B, S)
    ang = _rope_angles(positions, rot_dim)  # (B, S, rot_dim/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    xr = x[..., :rot_dim]
    x1, x2 = xr[..., : rot_dim // 2], xr[..., rot_dim // 2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rot_dim == hd:
        return rotated
    return torch.cat([rotated, x[..., rot_dim:]], dim=-1)


# ---------------------------------------------------------------------------
# chunked (flash-style) attention — bounded memory at 32k+ sequence lengths
# ---------------------------------------------------------------------------

def _chunk_sizes(S: int, T: int, q_chunk: int, kv_chunk: int):
    Qc = min(q_chunk, S)
    while S % Qc:
        Qc //= 2
    Kc = min(kv_chunk, T)
    while T % Kc:
        Kc //= 2
    return Qc, Kc


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window:
        m &= qpos[:, None] - kpos[None, :] < window
    return m


def _flash_fwd_impl(qg, kk, vv, causal: bool, window: int, q_offset: int, Qc: int, Kc: int):
    """qg: (B,KV,g,S,hd); kk/vv: (B,KV,T,hd) -> (out, lse) with out like qg.

    The reference's two nested scans as two loops: an online softmax over
    the key chunks of each query chunk."""
    B, KV, g, S, hd = qg.shape
    T = kk.shape[2]
    nq, nk = S // Qc, T // Kc
    scale = 1.0 / math.sqrt(hd)
    dev = qg.device
    q_pos0 = torch.arange(Qc, dtype=torch.int32, device=dev)
    k_pos0 = torch.arange(Kc, dtype=torch.int32, device=dev)
    outs, lses = [], []
    for qi in range(nq):
        qc = qg[:, :, :, qi * Qc:(qi + 1) * Qc]
        qpos = q_pos0 + qi * Qc + q_offset
        acc = torch.zeros((B, KV, g, Qc, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, KV, g, Qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, g, Qc), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kc = kk[:, :, ki * Kc:(ki + 1) * Kc]
            vc = vv[:, :, ki * Kc:(ki + 1) * Kc]
            s = _f32_product("bkgqh,bkth->bkgqt", qc, kc) * scale
            msk = _mask(qpos, k_pos0 + ki * Kc, causal, window)
            s = torch.where(msk[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = _f32_product("bkgqt,bkth->bkgqh", p.to(vc.dtype), vc)
            acc = acc * corr[..., None] + pv
            m = m_new
        lsafe = torch.clamp(l, min=1e-30)
        outs.append((acc / lsafe[..., None]).to(qg.dtype))
        lses.append(m + torch.log(lsafe))
    return torch.cat(outs, dim=3), torch.cat(lses, dim=3)


def _flash_bwd(causal: bool, window: int, q_offset: int, Qc: int, Kc: int,
               qg, kk, vv, out, lse, dout):
    """FlashAttention-style backward, the reference's ``_flash_bwd`` loop for
    loop: probability tiles recomputed as ``exp(s - lse)`` from the
    residuals ``(q, k, v, out, lse)``, every product and sum in float32,
    ``dk``/``dv`` accumulated per key chunk, each gradient cast back to its
    input's dtype."""
    B, KV, g, S, hd = qg.shape
    T = kk.shape[2]
    nq, nk = S // Qc, T // Kc
    scale = 1.0 / math.sqrt(hd)
    dev = qg.device
    q_pos0 = torch.arange(Qc, dtype=torch.int32, device=dev)
    k_pos0 = torch.arange(Kc, dtype=torch.int32, device=dev)
    delta = torch.sum(dout.float() * out.float(), dim=-1)  # (B,KV,g,S)
    dk = torch.zeros((B, KV, T, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, KV, T, hd), dtype=torch.float32, device=dev)
    dqs = []
    for qi in range(nq):
        rows = slice(qi * Qc, (qi + 1) * Qc)
        qc = qg[:, :, :, rows]
        doc = dout[:, :, :, rows].float()
        lsec = lse[..., rows]
        dc = delta[..., rows]
        qpos = q_pos0 + qi * Qc + q_offset
        dq_c = torch.zeros((B, KV, g, Qc, hd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            cols = slice(ki * Kc, (ki + 1) * Kc)
            kc = kk[:, :, cols]
            vc = vv[:, :, cols]
            s = _f32_product("bkgqh,bkth->bkgqt", qc, kc) * scale
            msk = _mask(qpos, k_pos0 + ki * Kc, causal, window)
            s = torch.where(msk[None, None, None], s, NEG_INF)
            p = torch.exp(s - lsec[..., None])  # (B,KV,g,Qc,Kc)
            dv_blk = torch.einsum("bkgqt,bkgqh->bkth", p, doc)
            dp = torch.einsum("bkgqh,bkth->bkgqt", doc, vc.float())
            ds = p * (dp - dc[..., None]) * scale
            dq_blk = torch.einsum("bkgqt,bkth->bkgqh", ds, kc.float())
            dk_blk = torch.einsum("bkgqt,bkgqh->bkth", ds, qc.float())
            dk[:, :, cols] += dk_blk
            dv[:, :, cols] += dv_blk
            dq_c = dq_c + dq_blk
        dqs.append(dq_c)
    dq = torch.cat(dqs, dim=3)
    return dq.to(qg.dtype), dk.to(kk.dtype), dv.to(vv.dtype)


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` (a ``jax.custom_vjp``): the forward loop runs
    outside autograd and keeps only ``(qg, kk, vv, out, lse)``; the backward
    is ``_flash_bwd``."""

    @staticmethod
    def forward(ctx, qg, kk, vv, causal, window, q_offset, Qc, Kc):
        out, lse = _flash_fwd_impl(qg, kk, vv, causal, window, q_offset, Qc, Kc)
        ctx.save_for_backward(qg, kk, vv, out, lse)
        ctx.static = (causal, window, q_offset, Qc, Kc)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.static, *ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, T, KV, hd)
    v: torch.Tensor,  # (B, T, KV, hd)
    *,
    causal: bool = True,
    window: int = 0,          # 0 = full; else sliding-window attention
    q_offset: int = 0,        # absolute position of q[0] (prefill continuation)
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention with (Qc × Kc) tiles; GQA via head grouping.

    The (B, H, S, T) score matrix is never materialized in either pass —
    the backward recomputes probability tiles blockwise (FlashAttention
    backward).  Peak extra memory is O(B·H·Qc·Kc) per step."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    Qc, Kc = _chunk_sizes(S, T, q_chunk, kv_chunk)
    qg = q.reshape(B, S, KV, g, hd).permute(0, 2, 3, 1, 4)
    kk = k.permute(0, 2, 1, 3)
    vv = v.permute(0, 2, 1, 3)
    out = _Flash.apply(qg, kk, vv, causal, window, q_offset, Qc, Kc)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def decode_attention(
    q: torch.Tensor,        # (B, H, hd) single new token
    k_cache: torch.Tensor,  # (B, W, KV, hd) (ring buffer when window)
    v_cache: torch.Tensor,
    pos: int,               # absolute position of the new token
    *,
    window: int = 0,
    seq_axes: Sequence[str] = (),
) -> torch.Tensor:
    """Attention of one new token over its cache.  With ``seq_axes`` the
    window is split over those mesh axes, this rank holding its consecutive
    slots: the scores' max and the exponentials' sum are reduced over them,
    each rank weighs its values by its normalised probabilities, and the
    weighted values are summed."""
    B, W, KV, hd = k_cache.shape
    H = q.shape[1]
    g = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, g, hd)
    s = _f32_product("bkgh,bwkh->bkgw", qg, k_cache) * scale
    n, j = sharding.axes_extent(seq_axes)
    slot = j * W + torch.arange(W, dtype=torch.int64, device=q.device)
    if window:
        # slot w holds absolute position p = pos - ((pos - w) mod W), valid if p >= 0
        p = pos - torch.remainder(pos - slot, W * n)
        valid = (p >= 0) & (p <= pos)
    else:
        valid = slot <= pos
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    if n == 1:
        p = torch.softmax(s, dim=-1)
        out = _f32_product("bkgw,bwkh->bkgh", p.to(v_cache.dtype), v_cache)
    else:
        smax = sharding.pmax(s.amax(dim=-1), seq_axes)
        e = torch.exp(s - smax[..., None])
        p = e / sharding.psum(e.sum(dim=-1), seq_axes)[..., None]
        out = sharding.psum(_f32_product("bkgw,bwkh->bkgh", p.to(v_cache.dtype), v_cache),
                            seq_axes)
    return out.reshape(B, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _act(a: torch.Tensor, act: str, dtype) -> torch.Tensor:
    """The MLP's nonlinearity on the first projection ``a`` (swiglu's gate)."""
    if act == "sq_relu":
        r = torch.clamp(a, min=0)
        return r * r
    if act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(a.float(), approximate="tanh").to(dtype)
    return F.silu(a.float()).to(dtype)


def mlp_apply(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """The MLP on this rank's hidden units (all of them without a mesh): its
    partial output summed over ``model``."""
    x = sharding.tp_enter(x)
    a = x @ p["wi0"]
    h = _act(a, act, x.dtype)
    if act == "swiglu":
        h = h * (x @ p["wi1"])
    h = sharding.constrain(h, "batch", None, "tp")
    return sharding.tp_exit(h @ p["wo"])


# ---------------------------------------------------------------------------
# MoE: top-k routing + sort-based grouped GEMM (capacity-dropped)
# ---------------------------------------------------------------------------

def _moe_expert_compute(xe, p_wi0, p_wi1, p_wo, act, dtype):
    a = torch.einsum("ecd,edf->ecf", xe, p_wi0)
    if act == "swiglu":
        h = _act(a, act, dtype) * torch.einsum("ecd,edf->ecf", xe, p_wi1)
    else:
        r = torch.clamp(a, min=0)
        h = r * r
    return torch.einsum("ecf,efd->ecd", h, p_wo)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last dim, the lower index first
    on ties (a stable descending sort)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _moe_dispatch_compute(xt, logits, e0: int, E_loc: int, p_wi0, p_wi1, p_wo, *,
                          top_k: int, capacity_factor: float, act: str,
                          psum_axes: Sequence[str] = ()):
    """Route xt (T,d) to the E_loc local experts [e0, e0+E_loc); returns (T,d)
    partial outputs (zeros for tokens whose experts live elsewhere).

    ``psum_axes`` is the weight-stationary variant (the reference's
    ``_moe_dispatch_compute_fsharded``): the expert matrices are this rank's
    f shards, and the (E_loc, C, d) partial outputs are summed over those
    mesh axes.  Those are the batch axes too, so each rank's slots hold other
    tokens, and the sum mixes them: the reference's, reproduced (ROADMAP
    Queue 3 item 15)."""
    T, d = xt.shape
    E = logits.shape[1]
    dev = xt.device
    gates = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(gates, top_k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    eid = topi.reshape(-1)
    wgt = topv.reshape(-1)
    tok = torch.arange(T, dtype=torch.int64, device=dev).repeat_interleave(top_k)
    C = max(int(capacity_factor * T * top_k / E), 4)
    local = (eid >= e0) & (eid < e0 + E_loc)
    le = torch.where(local, eid - e0, torch.full_like(eid, E_loc))  # E_loc = drop bucket
    order = torch.sort(le, stable=True).indices
    so, ts, ws = le[order], tok[order], wgt[order]
    first = torch.searchsorted(so, so, side="left")
    pos = torch.arange(T * top_k, dtype=torch.int64, device=dev) - first
    keep = (so < E_loc) & (pos < C)
    # gather-only dispatch: (E_loc, C) source-token ids, then one local gather;
    # the reference's out-of-range writes (mode="drop") are exactly ~keep,
    # sent to a spare row and column that are cut off (no boolean indexing,
    # whose output size depends on the data)
    row = torch.where(keep, so, E_loc)
    col = torch.where(keep, pos, C)
    ids = torch.zeros((E_loc + 1, C + 1), dtype=torch.int64, device=dev)
    valid = torch.zeros((E_loc + 1, C + 1), dtype=torch.bool, device=dev)
    ids[row, col] = ts
    valid[row, col] = keep
    ids, valid = ids[:E_loc, :C], valid[:E_loc, :C]
    xe = xt[ids] * valid[..., None].to(xt.dtype)
    ye = _moe_expert_compute(xe, p_wi0, p_wi1, p_wo, act, xt.dtype)
    if psum_axes:
        ye = sharding.all_reduce(ye, psum_axes)
    # the reference's gather clamps out-of-range indices; those rows are
    # multiplied by keep = 0
    back = ye[so.clamp(max=E_loc - 1), pos.clamp(max=C - 1)] \
        * (ws * keep)[:, None].to(xt.dtype)
    return torch.zeros((T, d), dtype=xt.dtype, device=dev).index_add_(0, ts, back)


def _moe_mode_auto(T_local: int, top_k: int, E: int, f: int, cf: float) -> str:
    """ws vs ag by napkin math (§Perf H1): per layer, ws moves ~2 psums of the
    (E_loc, C, d) partials (fwd+bwd) while ag moves the n_mats·(E_loc,d,f)
    expert weights.  Per-expert: ws ∝ 4·C·d·B_act, ag ∝ 3·d·f·B_w —
    choose ws when C < ~0.75·f."""
    forced = os.environ.get("REPRO_MOE_MODE")
    if forced in ("ws", "ag"):
        return forced
    C = max(cf * T_local * top_k / E, 4)
    return "ws" if C < 0.75 * f else "ag"


def _as_dtensor(w: torch.Tensor, mesh) -> DTensor:
    """``w`` as a DTensor on ``mesh``: a plain tensor is every rank's whole
    copy."""
    if isinstance(w, DTensor):
        return w
    return DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _local_experts(w: torch.Tensor, mesh, logical, sum_axes: Sequence[str] = ()):
    """This rank's piece of an expert matrix laid out by ``logical``; its
    gradient goes back summed over the mesh axes ``sum_axes``."""
    place = sharding.placements(sharding.spec(*logical), mesh)
    grad = [Partial() if a in sum_axes else pl for a, pl in zip(mesh.mesh_dim_names, place)]
    return _as_dtensor(w, mesh).redistribute(mesh, place).to_local(grad_placements=grad)


def moe_apply(
    x: torch.Tensor,     # (B, S, d)
    p: dict,             # router (d,E), wi0/wi1 (E,d,f), wo (E,f,d)
    *,
    top_k: int,
    capacity_factor: float,
    act: str,
    mode: str = "auto",  # auto | ag (weight all-gather) | ws (weight stationary)
) -> torch.Tensor:
    """Top-k MoE.  Without a mesh: single local dispatch over all experts.

    With a mesh: **expert parallelism**, the reference's ``shard_map`` body
    on each rank.  ``x`` is this rank's rows (replicated across the
    ``model`` axis); each model column routes its tokens to its E/tp
    resident experts with a *local* gather, its capacity from its own token
    count, computes, and the per-column partial token outputs are summed
    over ``model``.  The weights are DTensors in the parameters' layout (a
    plain tensor counts as every rank's whole copy).

    Two treatments of the FSDP-sharded expert-weight dim (§Perf H1):
      * ``ag`` — all-gather weights over the fsdp axes (ZeRO-3; best when
        tokens ≫ weights, i.e. train/prefill), gradients reduce-scattered,
      * ``ws`` — keep weights f-sharded, sum the small (E_loc, C, d)
        partials over the fsdp axes (best for decode); those axes are the
        batch axes, so at data > 1 this mixes the ranks' tokens, as the
        reference does.
    ``auto`` picks by the local token count (``REPRO_MOE_MODE`` forces one).
    The collectives' gradients are the reference's transposes
    (``sharding.all_reduce``).
    """
    B, S, d = x.shape
    E = p["router"].shape[1]
    mesh = sharding.get_mesh()
    wi1 = p.get("wi1", p["wi0"])  # unused when act != swiglu
    if mesh is None or "model" not in mesh.mesh_dim_names:
        xt = x.reshape(B * S, d)
        logits = (xt @ p["router"]).float()
        out = _moe_dispatch_compute(
            xt, logits, 0, E, p["wi0"], wi1, p["wo"],
            top_k=top_k, capacity_factor=capacity_factor, act=act)
        return out.reshape(B, S, d)

    fsdp = sharding.rules().fsdp
    E_loc = E // sharding.axis_size("model", mesh)
    if mode == "auto":
        mode = _moe_mode_auto(B * S, top_k, E, p["wi0"].shape[-1], capacity_factor)
    # x is replicated over model: its cotangent sums the columns' partials
    x = sharding.all_reduce(x, ("model",), forward=False)
    # every rank's logits feed its own experts: the router's gradient sums all
    router = sharding.gather(_as_dtensor(p["router"], mesh), mesh.mesh_dim_names)
    xt = x.reshape(B * S, d)
    logits = (xt @ router).float()
    e0 = sharding.axis_index("model", mesh) * E_loc
    if mode == "ws":
        # weights stay sharded: E over model, f over the fsdp axes
        wi, wo = ("tp", None, "fsdp"), ("tp", "fsdp", None)
        out = _moe_dispatch_compute(
            xt, logits, e0, E_loc, _local_experts(p["wi0"], mesh, wi),
            _local_experts(wi1, mesh, wi), _local_experts(p["wo"], mesh, wo),
            top_k=top_k, capacity_factor=capacity_factor, act=act, psum_axes=fsdp)
    else:
        # the fsdp shards gathered whole; their gradients summed over those axes
        wi0_f, wi1_f, wo_f = (_local_experts(w, mesh, ("tp", None, None), fsdp)
                              for w in (p["wi0"], wi1, p["wo"]))
        out = _moe_dispatch_compute(
            xt, logits, e0, E_loc, wi0_f, wi1_f, wo_f,
            top_k=top_k, capacity_factor=capacity_factor, act=act)
    # each column's partial summed over model; every column holds the
    # output's whole cotangent already
    out = sharding.all_reduce(out, ("model",), backward=False)
    return out.reshape(B, S, d)
