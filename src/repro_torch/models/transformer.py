"""LM model assembly for all assigned architecture families: the port of
:mod:`repro.models.transformer`, as an ``nn.Module``.

One code path covers: dense GQA (llama-style / squared-ReLU / partial-RoPE /
SWA), MoE (top-k, optional parallel dense residual — arctic), mamba-1 SSM
(attention-free), hybrid parallel attn+mamba (hymba), encoder-only backbones
(hubert) and VLM backbones with stub patch frontends (internvl2).

The parameters keep the reference's table and layout: ``param_dtype``
(float32 by default, bf16 as the reference's large and serving cells take
them, drawn in float32 and cast as the reference's are), the layer
parameters stacked on a leading ``L`` dim under the reference's names
(``blocks["attn.wq"]`` is the ``(L, d, H·hd)`` tensor; the module stores it
as ``blocks["attn__wq"]``, since a module name cannot hold a dot), cast to
bf16 one layer at a time as they are used.  ``LMModel(..., init=False)``
allocates them uninitialised: on the ``meta`` device or under
``FakeTensorMode`` nothing is allocated (the counterpart of the
reference's ``abstract_params``; the dry-run builds arctic-480b so).  The decode cache keeps the
reference's stacked layout and dtypes: ``k``/``v`` ``(L, B, S, KV, hd)`` in
bf16, or int8 with bf16 ``k_scale``/``v_scale``; ``ssm`` float32 and
``conv`` bf16.  ``decode_step`` writes the new token's state into that cache
in place (the reference's ``dynamic_update_slice`` under buffer donation),
so a caller that keeps a per-row state across steps keeps a copy.

Training: ``loss`` is the reference's masked token cross-entropy over
``forward``'s float32 logits; ``forward(remat=True)`` runs each block under
``torch.utils.checkpoint`` (``REPRO_REMAT_POLICY``: ``none``, the default,
recomputes the whole block; ``dots`` saves the weight products, the
``aten.mm`` outputs).  Where a stacked parameter holds a ``.grad`` buffer
(``launch/steps.py`` keeps one), each layer's gradient is summed straight
into its slice of that buffer, as the reference's scan writes a layer's
gradient into its slice: no per-layer gradient of the whole stack.

Under a mesh (``distributed/sharding.set_mesh``) the parameters are
DTensors laid out by ``param_specs`` (``launch/steps.place``), each rank
holding its shards, and every entry point takes this rank's rows of the
batch.  A layer's weights are gathered over the fsdp axes in bf16 as it
runs, their gradients reduce-scattered back (``sharding.tp_piece``), and
split over ``model`` at the reference's ``"tp"`` points (dense tensor
parallelism, ``sharding.tp_enter``/``tp_exit``): each ``model`` rank holds
and computes H/m query heads and their KV heads (a rank takes the KV head
its query heads read where m does not divide KV), f/m MLP units, d_inner/m
mamba channels (``in_proj``'s product exchanged into each rank's channels
of ``xs`` and ``z``) and V/m
vocabulary entries: the embedding lookup is vocabulary-parallel, the logits
stay split by vocabulary and the loss is a vocabulary-parallel log-softmax.
The caches hold each rank's KV heads and channels, as ``cache_shardings``
lays them out; a decode cache whose window is split over the batch axes
(B = 1) combines each rank's softmax partials (``decode_step(seq_axes=)``).
The experts go through ``moe_apply``'s expert-parallel path.  The loss is
the masked sum of every rank's tokens over the global token count, as the
reference's GSPMD step computes it.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (
    axes_extent, constrain, gather, get_mesh, mesh_scope, pmax, psum, rules, tp_enter,
    tp_exit, tp_piece, tp_rank, tp_size)
from repro_torch.distributed.sharding import spec as logical_spec
from repro_torch.kernels._build import resolve_device

from .layers import (
    ACT_DTYPE,
    apply_rope,
    cast_tree,
    decode_attention,
    dequantize_kv,
    flash_attention,
    mlp_apply,
    moe_apply,
    quantize_kv,
    rms_norm,
    sub_params,
)
from .ssm import mamba_decode_step, mamba_forward

DECODE_CAPACITY_FACTOR = 4.0   # the reference's MoE capacity in decode_step
# the ops whose outputs the `dots` remat policy saves: the products against a
# weight matrix (layers.py writes them `x @ w`), the reference's dots with no
# batch dimension
WEIGHT_PRODUCTS = [torch.ops.aten.mm.default]


def _save_weight_products():
    return create_selective_checkpoint_contexts(WEIGHT_PRODUCTS)


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | a_log | dt_bias | ones


def _key(name: str) -> str:
    """The module's name for the reference's parameter ``name``."""
    return name.replace(".", "__")


def _select(stacked: torch.Tensor, l: int) -> torch.Tensor:
    """Layer ``l`` of a stacked parameter: a view, or for a DTensor (whose
    layer dim is never sharded) the DTensor of its local slice ``l``."""
    if not isinstance(stacked, DTensor):
        return stacked[l]
    return _layer_dtensor(stacked, stacked.to_local()[l])


def _layer_dtensor(stacked: DTensor, piece: torch.Tensor) -> DTensor:
    """``piece``, a rank's slice of one layer of ``stacked``, as the DTensor
    of that layer (the stacked placements one dim down)."""
    place = [type(p)(p.dim - 1) if p.is_shard() else p for p in stacked.placements]
    shape = stacked.shape[1:]
    return DTensor.from_local(piece, stacked.device_mesh, place, run_check=False,
                              shape=shape, stride=stacked.stride()[1:])


class LMModel(nn.Module):
    """The model, its parameters of ``param_dtype`` on ``device`` (``cuda``
    unless the caller asks for ``cpu``), initialised from ``generator`` (a
    generator on that device, seeded 0 when none is given), or left
    uninitialised with ``init=False``."""

    def __init__(self, cfg: ArchConfig, device="cuda", param_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, init: bool = True):
        super().__init__()
        self.cfg = cfg
        self.param_dtype = param_dtype
        dev = resolve_device(device)

        def empty(shape):
            return nn.Parameter(torch.empty(shape, dtype=param_dtype, device=dev))

        self.top = nn.ParameterDict({n: empty(pd.shape) for n, pd in self.top_defs().items()})
        self.blocks = nn.ParameterDict({
            _key(n): empty((cfg.n_layers,) + pd.shape) for n, pd in self.layer_defs().items()})
        if init:
            if generator is None:
                generator = torch.Generator(dev).manual_seed(0)
            self.init(generator)

    @property
    def device(self) -> torch.device:
        return self.top["embed"].device

    # ------------------------------------------------------------------
    # parameter table
    # ------------------------------------------------------------------
    def layer_defs(self) -> Dict[str, ParamDef]:
        c = self.cfg
        d, f = c.d_model, c.d_ff
        defs: Dict[str, ParamDef] = {"ln1": ParamDef((d,), (None,), "zeros")}
        if c.has_attn:
            H, KV, hd = c.n_heads_padded, c.n_kv_padded, c.hd
            defs["attn.wq"] = ParamDef((d, H * hd), ("fsdp", "tp"))
            defs["attn.wk"] = ParamDef((d, KV * hd), ("fsdp", "tp"))
            defs["attn.wv"] = ParamDef((d, KV * hd), ("fsdp", "tp"))
            defs["attn.wo"] = ParamDef((H * hd, d), ("tp", "fsdp"))
        if c.has_mamba:
            di, N, dtr = c.d_inner, c.ssm_state, c.dt_rank
            defs["mamba.in_proj"] = ParamDef((d, 2 * di), ("fsdp", "tp"))
            defs["mamba.conv_w"] = ParamDef((c.ssm_conv, di), (None, "tp"))
            defs["mamba.conv_b"] = ParamDef((di,), ("tp",), "zeros")
            defs["mamba.x_proj"] = ParamDef((di, dtr + 2 * N), ("tp", None))
            defs["mamba.dt_proj"] = ParamDef((dtr, di), (None, "tp"))
            defs["mamba.dt_bias"] = ParamDef((di,), ("tp",), "dt_bias")
            defs["mamba.A_log"] = ParamDef((di, N), ("tp", None), "a_log")
            defs["mamba.D"] = ParamDef((di,), ("tp",), "ones")
            defs["mamba.out_proj"] = ParamDef((di, d), ("tp", "fsdp"))
        if c.has_moe:
            E = c.n_experts
            defs["ln2"] = ParamDef((d,), (None,), "zeros")
            # expert weights live in the weight-stationary layout (f over fsdp):
            # decode/prefill psum small activation partials instead of
            # all-gathering expert matrices every step.
            defs["moe.router"] = ParamDef((d, E), ("fsdp", None))
            defs["moe.wi0"] = ParamDef((E, d, f), ("tp", None, "fsdp"))
            if c.mlp_act == "swiglu":
                defs["moe.wi1"] = ParamDef((E, d, f), ("tp", None, "fsdp"))
            defs["moe.wo"] = ParamDef((E, f, d), ("tp", "fsdp", None))
            if c.moe_dense_ff:
                fd = c.moe_dense_ff
                defs["dense.wi0"] = ParamDef((d, fd), ("fsdp", "tp"))
                if c.mlp_act == "swiglu":
                    defs["dense.wi1"] = ParamDef((d, fd), ("fsdp", "tp"))
                defs["dense.wo"] = ParamDef((fd, d), ("tp", "fsdp"))
        elif f:
            defs["ln2"] = ParamDef((d,), (None,), "zeros")
            defs["mlp.wi0"] = ParamDef((d, f), ("fsdp", "tp"))
            if c.mlp_act == "swiglu":
                defs["mlp.wi1"] = ParamDef((d, f), ("fsdp", "tp"))
            defs["mlp.wo"] = ParamDef((f, d), ("tp", "fsdp"))
        if c.family == "hybrid":
            defs["fuse_a"] = ParamDef((d,), (None,), "zeros")
            defs["fuse_m"] = ParamDef((d,), (None,), "zeros")
        return defs

    def top_defs(self) -> Dict[str, ParamDef]:
        c = self.cfg
        d = c.d_model
        defs = {
            "embed": ParamDef((c.vocab_padded, d), ("tp", "fsdp")),
            "final_ln": ParamDef((d,), (None,), "zeros"),
            "lm_head": ParamDef((d, c.vocab_padded), ("fsdp", "tp")),
        }
        if c.frontend != "none":
            defs["frontend_proj"] = ParamDef((c.frontend_dim, d), (None, "fsdp"))
        return defs

    def params(self) -> Dict[str, torch.Tensor]:
        """Every parameter under the reference's name: the top ones and the
        stacked layer ones (``blocks.<name>``)."""
        out = dict(self.top.items())
        out.update({"blocks." + n: self.blocks[_key(n)] for n in self.layer_defs()})
        return out

    def layer(self, l: int) -> Dict[str, torch.Tensor]:
        """Layer ``l``'s parameters under the reference's names (views; under
        a mesh, DTensors of this rank's slices)."""
        return {n: _select(self.blocks[_key(n)], l) for n in self.layer_defs()}

    def param_tree(self) -> dict:
        """The parameters in the reference's tree: the top ones, and the
        stacked layer ones under ``blocks`` (the live tensors)."""
        out = dict(self.top.items())
        out["blocks"] = {n: self.blocks[_key(n)] for n in self.layer_defs()}
        return out

    def abstract_params(self) -> dict:
        """The parameter tree's shapes and dtypes as meta tensors."""
        def meta(shape):
            return torch.empty(shape, dtype=self.param_dtype, device="meta")

        out = {n: meta(pd.shape) for n, pd in self.top_defs().items()}
        out["blocks"] = {n: meta((self.cfg.n_layers,) + pd.shape)
                         for n, pd in self.layer_defs().items()}
        return out

    def param_specs(self) -> dict:
        """The parameter tree's PartitionSpec entries on the active mesh
        (``()`` each without one); a stacked parameter's layer dim is never
        sharded."""
        out = {n: logical_spec(*pd.logical) for n, pd in self.top_defs().items()}
        out["blocks"] = {n: logical_spec(None, *pd.logical)
                         for n, pd in self.layer_defs().items()}
        return out

    def _grad_layer(self, l: int) -> Dict[str, torch.Tensor]:
        """Layer ``l``'s parameters for a pass that records gradients.  Where
        the stacked parameter holds a ``.grad`` buffer, a leaf view of layer
        ``l`` whose ``.grad`` is that buffer's slice ``l``: autograd adds the
        layer's gradient into the slice in place (under a mesh, the local
        slices: the leaf is this rank's piece of the layer).  Otherwise the
        plain view (autograd then builds a gradient of the whole stack per
        layer)."""
        out = {}
        for n in self.layer_defs():
            stacked = self.blocks[_key(n)]
            if stacked.grad is None or not torch.is_grad_enabled():
                out[n] = _select(stacked, l)
                continue
            placed = isinstance(stacked, DTensor)
            local = stacked.to_local() if placed else stacked
            leaf = local.detach()[l].requires_grad_()
            leaf.grad = (stacked.grad.to_local() if placed else stacked.grad)[l]
            out[n] = _layer_dtensor(stacked, leaf) if placed else leaf
        return out

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LMModel":
        """The reference's initialisers, drawn in its order (top parameters,
        then the layers'): normal·1/√fan_in, zeros, ones, dt_bias -4, and
        a_log log(1..N), each computed in float32 and cast to the
        parameters' dtype (so a bf16 model is its float32 twin, cast)."""
        defs = list(self.top_defs().items()) + list(self.layer_defs().items())
        for name, pd in defs:
            p = self.top[name] if name in self.top else self.blocks[_key(name)]
            if pd.init == "zeros":
                p.zero_()
            elif pd.init == "ones":
                p.fill_(1.0)
            elif pd.init == "dt_bias":
                p.fill_(-4.0)
            elif pd.init == "a_log":
                N = pd.shape[-1]
                p.copy_(torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                               device=p.device)).expand(p.shape))
            else:
                fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
                w = p if p.dtype == torch.float32 else torch.empty(
                    p.shape, dtype=torch.float32, device=p.device)
                w.normal_(generator=generator).mul_(1.0 / math.sqrt(max(fan_in, 1)))
                if w is not p:
                    p.copy_(w)
        return self

    # ------------------------------------------------------------------
    # tensor parallelism over ``model``
    # ------------------------------------------------------------------
    def _check_tp(self) -> None:
        """Every dim the reference splits over ``"tp"`` must split evenly
        over the ``model`` axis (the KV heads aside: where m does not divide
        them, each rank takes the one its query heads read)."""
        c, m = self.cfg, tp_size()
        if m == 1:
            return
        dims = {"vocab_padded": c.vocab_padded}
        if c.has_attn:
            dims["n_heads_padded"] = c.n_heads_padded
        if c.has_mamba:
            dims["d_inner"] = c.d_inner
        if c.has_moe and c.moe_dense_ff:
            dims["moe_dense_ff"] = c.moe_dense_ff
        elif not c.has_moe and c.d_ff:
            dims["d_ff"] = c.d_ff
        bad = {k: v for k, v in dims.items() if v % m}
        if c.has_mamba and m % 2:
            bad["an odd model axis (in_proj's halves pair its ranks)"] = m
        if c.has_attn and c.n_kv_padded % m and (
                c.n_heads_padded // c.n_kv_padded) % max(c.n_heads_padded // m, 1):
            bad["query heads a rank across KV groups"] = c.n_heads_padded // m
        if bad:
            raise ValueError(f"{c.name}: {bad} do not split over a model axis of {m}")

    def _kv_whole(self) -> bool:
        """Whether m does not divide the KV heads, so that each rank computes
        them whole and keeps the one its query heads read."""
        return self.cfg.n_kv_padded % tp_size() != 0

    def _local_params(self, p: dict) -> dict:
        """A layer's (cast) parameters as this rank computes with them
        (``sharding.tp_piece``): the fsdp shards gathered, the ``"tp"`` dims
        split over ``model`` as they are stored (``in_proj``'s product is
        then exchanged into this rank's channels of ``xs`` and ``z``:
        ``sharding.tp_halves``).  Where m does not divide the KV heads,
        ``wk``/``wv`` are gathered whole and each rank takes the KV head of
        its query heads.  The experts stay as they are, for ``moe_apply``'s
        expert-parallel path."""
        defs = self.layer_defs()
        m, r = tp_size(), tp_rank()
        out = {}
        for k, v in p.items():
            logical = defs[k].logical
            if k.startswith("moe."):
                out[k] = v
            elif k in ("attn.wk", "attn.wv") and self._kv_whole():
                c = self.cfg
                kv = r * (c.n_heads_padded // m) // (c.n_heads_padded // c.n_kv_padded)
                out[k] = tp_piece(v, logical, whole=True)[:, kv * c.hd:(kv + 1) * c.hd]
            else:
                out[k] = tp_piece(v, logical)
        return out

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------
    def _attn_train(self, p, h, positions, return_kv: bool = False):
        """Attention over this rank's heads (all of them without a mesh):
        its partial output summed over ``model``."""
        c = self.cfg
        B, S, d = h.shape
        hd = c.hd
        H, KV = p["attn.wq"].shape[-1] // hd, p["attn.wk"].shape[-1] // hd
        h = tp_enter(h)
        q = (h @ p["attn.wq"]).reshape(B, S, H, hd)
        k = (h @ p["attn.wk"]).reshape(B, S, KV, hd)
        v = (h @ p["attn.wv"]).reshape(B, S, KV, hd)
        q = constrain(q, "batch", None, "tp", None)
        k = constrain(k, "batch", None, "tp", None)
        q = apply_rope(q, positions, c.rope_variant)
        k = apply_rope(k, positions, c.rope_variant)
        o = flash_attention(q, k, v, causal=c.causal, window=c.swa_window)
        o = constrain(o, "batch", None, "tp", None)
        out = tp_exit(o.reshape(B, S, H * hd) @ p["attn.wo"])
        if not return_kv:
            return out
        if c.swa_window:
            W = c.swa_window
            if S > W:
                # ring-buffer layout: slot j must hold absolute position
                # p ≡ j (mod W); roll the trailing window accordingly.
                shift = (S - W) % W
                k = torch.roll(k[:, -W:], shift, dims=1)
                v = torch.roll(v[:, -W:], shift, dims=1)
            elif S < W:
                k = F.pad(k, (0, 0, 0, 0, 0, W - S))
                v = F.pad(v, (0, 0, 0, 0, 0, W - S))
        return out, (k.to(ACT_DTYPE), v.to(ACT_DTYPE))

    def _ffn(self, p, x, capacity_factor: float):
        """The block's second half: x + MLP or MoE (+ arctic's dense residual)."""
        c = self.cfg
        if c.has_moe:
            h2 = rms_norm(x, p["ln2"], c.norm_eps)
            y = moe_apply(h2, sub_params(p, "moe"), top_k=c.top_k,
                          capacity_factor=capacity_factor, act=c.mlp_act)
            if c.moe_dense_ff:
                y = y + mlp_apply(h2, sub_params(p, "dense"), c.mlp_act)
            return constrain(x + y, "batch", None, None)
        if c.d_ff:
            h2 = rms_norm(x, p["ln2"], c.norm_eps)
            return constrain(x + mlp_apply(h2, sub_params(p, "mlp"), c.mlp_act),
                             "batch", None, None)
        return constrain(x, "batch", None, None)

    def _gates(self, p, dtype):
        ga = torch.sigmoid(p["fuse_a"].float()).to(dtype)
        gm = torch.sigmoid(p["fuse_m"].float()).to(dtype)
        return ga, gm

    def _block(self, p, x, positions, keep_state: bool = False):
        """One layer over the whole sequence: (x, the decode state it leaves)
        where ``keep_state`` (prefill), else (x, None)."""
        c = self.cfg
        p = self._local_params(cast_tree(p))
        h = rms_norm(x, p["ln1"], c.norm_eps)
        state = {}
        if c.has_attn:
            a = self._attn_train(p, h, positions, return_kv=keep_state)
            if keep_state:
                a, (state["k"], state["v"]) = a
        if c.has_mamba:
            m = mamba_forward(h, sub_params(p, "mamba"), c, return_state=keep_state)
            if keep_state:
                m, state["ssm"], conv = m
                state["conv"] = conv.to(ACT_DTYPE)
        if c.family == "hybrid":
            ga, gm = self._gates(p, x.dtype)
            mix = a * ga + m * gm
        else:
            mix = a if c.has_attn else m
        x = constrain(x + mix, "batch", None, None)
        x = self._ffn(p, x, c.capacity_factor)
        return x, (state if keep_state else None)

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------
    def _embed_rows(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of the embedding ``table`` (the parameter, or it
        cast).  Over a ``model`` axis of m > 1 the lookup is
        vocabulary-parallel: each rank gathers the ids in its V/m rows, the
        others masked to zero, and the rows are summed over ``model``."""
        piece = tp_piece(table, self.top_defs()["embed"].logical)
        if tp_size() == 1:
            return piece[ids.long()]
        rows = piece.shape[0]
        local = ids.long() - tp_rank() * rows
        own = (local >= 0) & (local < rows)
        got = piece[local.clamp(0, rows - 1)] * own[..., None].to(piece.dtype)
        return tp_exit(got)

    def _embed_inputs(self, batch) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Returns (x (B,S,d) bf16, positions (B,S), n_prefix_tokens)."""
        c = self.cfg
        if c.frontend == "frame":
            x = torch.einsum("bsf,fd->bsd", batch["frames"].to(ACT_DTYPE),
                             gather(self.top["frontend_proj"].to(ACT_DTYPE)))
            B, S = x.shape[:2]
            pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
            return constrain(x, "batch", None, None), pos, 0
        # the whole table cast, then gathered, as the reference does: the
        # backward sums a repeated token's gradients in bf16
        emb = self._embed_rows(self.top["embed"].to(ACT_DTYPE), batch["tokens"])
        n_prefix = 0
        if c.frontend == "patch" and "patches" in batch:
            pe = torch.einsum("bpf,fd->bpd", batch["patches"].to(ACT_DTYPE),
                              gather(self.top["frontend_proj"].to(ACT_DTYPE)))
            emb = torch.cat([pe, emb], dim=1)
            n_prefix = pe.shape[1]
        B, S = emb.shape[:2]
        pos = torch.arange(S, dtype=torch.int32, device=emb.device)[None].expand(B, S)
        return constrain(emb, "batch", None, None), pos, n_prefix

    def _head(self, x) -> torch.Tensor:
        """float32 logits: bf16 activations against the bf16-cast head,
        multiplied in float32 (the reference's ``preferred_element_type``);
        over a ``model`` axis, this rank's V/m of them."""
        x = tp_enter(rms_norm(x, gather(self.top["final_ln"]), self.cfg.norm_eps))
        head = tp_piece(self.top["lm_head"].to(x.dtype), self.top_defs()["lm_head"].logical)
        logits = torch.einsum("bsd,dv->bsv", x.float(), head.float())
        return constrain(logits, "batch", None, "tp")

    # ------------------------------------------------------------------
    # forward / prefill / decode
    # ------------------------------------------------------------------
    def forward(self, batch, remat: bool = True) -> torch.Tensor:
        """Logits (B, S, vocab_padded) float32.  With ``remat`` and gradients
        recorded, each block runs under ``torch.utils.checkpoint``, its
        policy read from ``REPRO_REMAT_POLICY`` as the reference reads it."""
        self._check_tp()
        x, positions, n_prefix = self._embed_inputs(batch)
        mesh = get_mesh()

        def block(p, x):
            # a checkpointed block recomputes on autograd's thread
            with mesh_scope(mesh):
                return self._block(p, x, positions)[0]

        remat = remat and torch.is_grad_enabled()
        policy = {}
        if remat and os.environ.get("REPRO_REMAT_POLICY", "none") == "dots":
            policy["context_fn"] = _save_weight_products
        for l in range(self.cfg.n_layers):
            p = self._grad_layer(l)
            x = checkpoint(block, p, x, use_reentrant=False, **policy) if remat else block(p, x)
        logits = self._head(x)
        if n_prefix:
            logits = logits[:, n_prefix:]
        return logits

    def loss(self, batch, remat: bool = True) -> Tuple[torch.Tensor, dict]:
        """Mean token cross-entropy over the labels ``>= 0`` (float32
        ``log_softmax`` over ``vocab_padded``, labels clipped into it):
        (loss, {"loss", "tokens"}).  ``remat`` as in ``forward`` (the
        reference's loss always remats).

        Under a mesh ``batch`` is this rank's rows: the loss returned is their
        masked sum over the token count of every rank's rows, so that the
        ranks' losses sum to the reference's, and the metrics are the global
        loss and count.  Over a ``model`` axis of m > 1 the log-softmax is
        vocabulary-parallel (``_vocab_parallel_ll``)."""
        logits = self.forward(batch, remat=remat)
        labels = batch["labels"]
        if tp_size() > 1:
            ll = _vocab_parallel_ll(logits, labels)
        else:
            V = logits.shape[-1]
            logp = torch.log_softmax(logits.float(), dim=-1)
            safe = torch.clamp(labels.long(), 0, V - 1)
            ll = torch.gather(logp, -1, safe[..., None])[..., 0]
        mask = (labels >= 0).float()
        r = rules()
        batch_axes = r.batch if r is not None else ()
        tokens = psum(mask.sum(), batch_axes)
        loss = -(ll * mask).sum() / torch.clamp(tokens, min=1.0)
        return loss, {"loss": psum(loss.detach(), batch_axes), "tokens": tokens}

    @torch.no_grad()
    def prefill(self, batch, max_len: Optional[int] = None) -> Tuple[dict, torch.Tensor]:
        """Forward returning the decode cache + last-position logits.

        ``max_len`` pre-allocates KV headroom for subsequent decode steps
        (full-attention caches append at slot ``pos``; SWA caches are fixed
        window-sized ring buffers and never grow).
        """
        c = self.cfg
        self._check_tp()
        x, positions, _ = self._embed_inputs(batch)
        states = []
        for l in range(c.n_layers):
            x, st = self._block(self.layer(l), x, positions, keep_state=True)
            states.append(st)
        logits = self._head(x[:, -1:, :])[:, 0]
        cache = {}
        if c.has_attn:
            kc = torch.stack([s["k"] for s in states])
            vc = torch.stack([s["v"] for s in states])
            if max_len is not None and not c.swa_window and max_len > kc.shape[2]:
                grow = (0, 0, 0, 0, 0, max_len - kc.shape[2])
                kc, vc = F.pad(kc, grow), F.pad(vc, grow)
            if c.kv_cache_dtype == "int8":
                kc, ks = quantize_kv(kc)
                vc, vs = quantize_kv(vc)
                cache["k_scale"] = constrain(ks, None, "batch", None, "tp")
                cache["v_scale"] = constrain(vs, None, "batch", None, "tp")
            cache["k"] = constrain(kc, None, "batch", None, "tp", None)
            cache["v"] = constrain(vc, None, "batch", None, "tp", None)
        if c.has_mamba:
            cache["ssm"] = torch.stack([s["ssm"] for s in states])
            cache["conv"] = torch.stack([s["conv"] for s in states])
        return cache, logits

    @torch.no_grad()
    def decode_step(self, cache: dict, token: torch.Tensor, pos: int, seq_axes=()):
        """One decode step against a pre-filled cache. token: (B,), pos: the
        new token's absolute position.  Writes the token's state into
        ``cache`` in place and returns (cache, logits (B, vocab_padded), over
        a ``model`` axis this rank's V/m of them).  ``seq_axes`` are the mesh
        axes the cache's window is split over (``cache_shardings`` where the
        batch cannot cover the batch axes): this rank holds its consecutive
        slots of the window, the rank holding the new token's slot writes it,
        and attention combines every rank's softmax partials."""
        c = self.cfg
        self._check_tp()
        pos = int(pos)
        x = self._embed_rows(self.top["embed"], token).to(ACT_DTYPE)  # (B, d)
        x = constrain(x, "batch", None)
        B = x.shape[0]
        hd = c.hd
        int8kv = c.kv_cache_dtype == "int8"
        seq_axes = tuple(seq_axes)
        for l in range(c.n_layers):
            p = self._local_params(cast_tree(self.layer(l)))
            h = rms_norm(x, p["ln1"], c.norm_eps)
            mix = torch.zeros_like(x)
            if c.has_attn:
                kc, vc = cache["k"][l], cache["v"][l]       # views: (B, W, KV, hd)
                W = kc.shape[1]
                H, KV = p["attn.wq"].shape[-1] // hd, p["attn.wk"].shape[-1] // hd
                ha = tp_enter(h)
                q = (ha @ p["attn.wq"]).reshape(B, H, hd)
                kn = (ha @ p["attn.wk"]).reshape(B, KV, hd)
                vn = (ha @ p["attn.wv"]).reshape(B, KV, hd)
                posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
                q = apply_rope(q[:, None], posb, c.rope_variant)[:, 0]
                kn = apply_rope(kn[:, None], posb, c.rope_variant)[:, 0]
                n_seq, j = axes_extent(seq_axes)
                slot = pos % (W * n_seq) if c.swa_window else pos
                mine = slot // W == j
                slot -= j * W
                if int8kv:
                    ksc, vsc = cache["k_scale"][l], cache["v_scale"][l]
                    if mine:
                        kc[:, slot], ksc[:, slot] = quantize_kv(kn)
                        vc[:, slot], vsc[:, slot] = quantize_kv(vn)
                    o = decode_attention(q, dequantize_kv(kc, ksc), dequantize_kv(vc, vsc),
                                         pos, window=c.swa_window, seq_axes=seq_axes)
                else:
                    if mine:
                        kc[:, slot] = kn.to(kc.dtype)
                        vc[:, slot] = vn.to(vc.dtype)
                    o = decode_attention(q, kc, vc, pos, window=c.swa_window,
                                         seq_axes=seq_axes)
                mix = tp_exit(o.reshape(B, H * hd) @ p["attn.wo"])
            if c.has_mamba:
                m, hs, cs = mamba_decode_step(h, sub_params(p, "mamba"), c, cache["ssm"][l],
                                              cache["conv"][l].to(ACT_DTYPE))
                cache["ssm"][l] = hs
                cache["conv"][l] = cs.to(cache["conv"].dtype)
                if c.family == "hybrid":
                    ga, gm = self._gates(p, x.dtype)
                    mix = mix * ga + m * gm
                else:
                    mix = m
            x = self._ffn(p, (x + mix)[:, None], DECODE_CAPACITY_FACTOR)[:, 0]
        logits = self._head(x[:, None, :])[:, 0]
        return cache, logits


def _vocab_parallel_ll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The log-probability of each label under the float32 log-softmax of
    logits split by vocabulary over ``model`` (this rank holds V/m
    columns): the max over every rank's columns (no gradient, as the
    reference's log-softmax stops it), the sum of exponentials and the
    label's logit, which only its owner holds, summed over ``model``.  Every
    rank backpropagates the same loss, so both sums have the identity
    backward (``tp_exit``).  Labels are clipped into ``vocab_padded``, whose
    padded columns count as the reference counts them."""
    z = logits.float()
    rows = z.shape[-1]
    lo = tp_rank() * rows
    safe = torch.clamp(labels.long(), 0, rows * tp_size() - 1)
    zmax = pmax(z.detach().amax(dim=-1), ("model",))
    sumexp = tp_exit(torch.exp(z - zmax[..., None]).sum(dim=-1))
    local = safe - lo
    own = (local >= 0) & (local < rows)
    zl = torch.gather(z, -1, local.clamp(0, rows - 1)[..., None])[..., 0] * own.float()
    return tp_exit(zl) - (zmax + torch.log(sumexp))
