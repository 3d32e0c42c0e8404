"""Architecture configs + input shapes for the assigned public-literature pool,
the port of :mod:`repro.configs.base`.

Every entry in the pool has a ``configs/<id>.py`` with the exact published
configuration; ``reduced()`` derives the CPU smoke-test variant (same
family, tiny dims).  ``cache_specs`` and ``input_specs`` return tensors on
the ``meta`` device (shape and dtype, no storage) where the reference
returns ``jax.ShapeDtypeStruct``.

The reference's ``IndexRuntimeConfig`` is not ported: it picks the
reference's ``jnp``/``pallas`` traversal engine and Pallas execution mode,
which the port does not have.  In the port the index's device decides the
path (``IndexConfig(device=...)``: the CUDA kernels on ``cuda``, their plain
versions on ``cpu``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

# The production mesh fixes the tensor-parallel degree.
TP = 16


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | encoder | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int               # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dense_ff: int = 0      # arctic-style parallel dense residual FFN
    capacity_factor: float = 1.25
    # SSM (mamba1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    # attention flavour
    swa_window: int = 0        # 0 = full attention
    rope_variant: str = "full"  # full | partial | none
    mlp_act: str = "swiglu"     # swiglu | sq_relu | gelu
    causal: bool = True
    decoder: bool = True        # False -> encoder-only (no decode shapes)
    # modality frontend stubs
    frontend: str = "none"      # none | patch | frame
    frontend_dim: int = 0
    n_frontend_tokens: int = 0  # vlm: patches per example
    norm_eps: float = 1e-5
    tp: int = TP               # tensor-parallel degree things are padded for
    kv_cache_dtype: str = "bf16"  # bf16 | int8 (§Perf H1-4: halves decode HBM reads)
    notes: str = ""

    # ---- derived (TP-padded; overheads are visible in the roofline ratio) ----
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def n_heads_padded(self) -> int:
        return _pad_to(self.n_heads, self.tp) if self.n_heads else 0

    @property
    def n_kv_padded(self) -> int:
        return _pad_to(self.n_kv_heads, self.tp) if self.n_kv_heads else 0

    @property
    def vocab_padded(self) -> int:
        return _pad_to(self.vocab, self.tp)

    @property
    def d_inner(self) -> int:  # mamba inner channels
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(_pad_to(math.ceil(self.d_model / 16), self.tp), self.tp)

    @property
    def has_attn(self) -> bool:
        return self.family != "ssm"

    @property
    def has_mamba(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (bounded decode state)."""
        return self.family in ("ssm", "hybrid") or self.swa_window > 0

    # ---- parameter counting (unpadded = MODEL_FLOPS basis) ----
    def param_count(self, padded: bool = False) -> int:
        H = self.n_heads_padded if padded else self.n_heads
        KV = self.n_kv_padded if padded else self.n_kv_heads
        V = self.vocab_padded if padded else self.vocab
        d, f = self.d_model, self.d_ff
        per_layer = 0
        if self.has_attn:
            per_layer += d * H * self.hd + 2 * d * KV * self.hd + H * self.hd * d
        if self.has_mamba:
            di, N, dtr = self.d_inner, self.ssm_state, self.dt_rank
            per_layer += d * 2 * di + self.ssm_conv * di + di * (dtr + 2 * N) \
                + dtr * di + di * N + 2 * di + di * d
        if self.has_moe:
            n_mats = 3 if self.mlp_act == "swiglu" else 2
            per_layer += d * self.n_experts + self.n_experts * n_mats * d * f
            if self.moe_dense_ff:
                per_layer += n_mats * d * self.moe_dense_ff
        elif f:
            n_mats = 3 if self.mlp_act == "swiglu" else 2
            per_layer += n_mats * d * f
        per_layer += 2 * d  # norms
        total = self.n_layers * per_layer + V * d + d * V + d
        if self.frontend_dim:
            total += self.frontend_dim * d
        return total

    def active_param_count(self) -> int:
        """MoE: parameters touched per token (6·N_active·D FLOPs basis)."""
        if not self.has_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        n_mats = 3 if self.mlp_act == "swiglu" else 2
        full_experts = self.n_layers * self.n_experts * n_mats * d * f
        active_experts = self.n_layers * self.top_k * n_mats * d * f
        return self.param_count() - full_experts + active_experts

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=2 if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab=512,
            n_experts=4 if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            # drop-free capacity so smoke tests can assert decode==forward;
            # the FULL configs keep the production factor (1.25)
            capacity_factor=8.0 if self.n_experts else self.capacity_factor,
            moe_dense_ff=64 if self.moe_dense_ff else 0,
            ssm_state=4 if self.ssm_state else 0,
            frontend_dim=32 if self.frontend_dim else 0,
            n_frontend_tokens=4 if self.n_frontend_tokens else 0,
            swa_window=min(self.swa_window, 8) if self.swa_window else 0,
            tp=1,
        )


# ---------------------------------------------------------------------------
# shapes (LM-family: seq_len x global_batch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    """The documented skip matrix (DESIGN.md §6)."""
    if shape.kind == "decode" and not cfg.decoder:
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "pure full-attention arch; 500k decode state out of spec"
    return None


def runnable_cells(cfg: ArchConfig):
    return [s for s in SHAPES.values() if cell_skip_reason(cfg, s) is None]


# ---------------------------------------------------------------------------
# input specs (meta tensors: shape and dtype, no allocation)
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """Decode-state pytree specs. SWA archs keep only a window-sized cache."""
    L = cfg.n_layers
    specs = {}
    if cfg.has_attn:
        s = min(max_seq, cfg.swa_window) if cfg.swa_window else max_seq
        kv_shape = (L, batch, s, cfg.n_kv_padded, cfg.hd)
        if cfg.kv_cache_dtype == "int8":
            specs["k"] = _spec(kv_shape, torch.int8)
            specs["v"] = _spec(kv_shape, torch.int8)
            # one bf16 scale per (layer, batch, pos, kv-head): 1/hd overhead
            specs["k_scale"] = _spec(kv_shape[:-1], torch.bfloat16)
            specs["v_scale"] = _spec(kv_shape[:-1], torch.bfloat16)
        else:
            specs["k"] = _spec(kv_shape, torch.bfloat16)
            specs["v"] = _spec(kv_shape, torch.bfloat16)
    if cfg.has_mamba:
        specs["conv"] = _spec(
            (L, batch, cfg.ssm_conv - 1, cfg.d_inner), torch.bfloat16
        )
        specs["ssm"] = _spec(
            (L, batch, cfg.d_inner, cfg.ssm_state), torch.float32
        )
    return specs


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Model inputs for one dry-run cell (meta tensors only)."""
    B, S = shape.global_batch, shape.seq_len
    tok = _spec((B, S), torch.int32)
    if shape.kind == "train":
        specs = {"tokens": tok, "labels": _spec((B, S), torch.int32)}
        if cfg.frontend == "patch":
            specs["patches"] = _spec(
                (B, cfg.n_frontend_tokens, cfg.frontend_dim), torch.bfloat16
            )
        if cfg.frontend == "frame":
            specs = {
                "frames": _spec((B, S, cfg.frontend_dim), torch.bfloat16),
                "labels": _spec((B, S), torch.int32),
            }
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": tok}
        if cfg.frontend == "patch":
            specs["patches"] = _spec(
                (B, cfg.n_frontend_tokens, cfg.frontend_dim), torch.bfloat16
            )
        if cfg.frontend == "frame":
            specs = {"frames": _spec((B, S, cfg.frontend_dim), torch.bfloat16)}
        return specs
    # decode: one new token against a seq_len-deep cache
    return {
        "cache": cache_specs(cfg, B, S),
        "token": _spec((B,), torch.int32),
        "pos": _spec((), torch.int32),
    }
