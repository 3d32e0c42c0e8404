"""Roofline aggregation over the dry-run's records: the port of
:mod:`repro.launch.roofline`, on the H100's published rates.

Terms per (arch × shape × mesh), per device:

  compute term    = FLOPs / 989 TFLOP/s       (H100 SXM, bf16 dense)
  memory term     = bytes / 3.35 TB/s         (H100 SXM HBM3)
  collective term = collective bytes / 50 GB/s

The first two are NVIDIA's data-sheet peaks for the H100 SXM at its 700 W
power limit (dense rates, no sparsity).  The collective rate is a choice:
an H100 node holds 8 cards on NVLink (450 GB/s each way a card) and one
400 Gb/s NIC a card (50 GB/s each way).  Every group of the (16, 16) and
(2, 16, 16) meshes spans nodes (a ``model`` group of 16 consecutive ranks
spans two nodes, a ``data`` or ``pod`` group one card of each of 16 or 2
nodes), and a ring moves at the rate of its slowest hop, the NIC: so 50 GB/s
a card.  All three are analytic terms for published peaks, not
measurements.

The FLOP and byte terms are the reference's *analytic* model of the padded
configuration (``flops_per_token``, ``analytic_flops``, ``analytic_bytes``,
the same arithmetic), since the reference's XLA cost analysis undercounts
loops; the collective term comes from the dry-run's counted collectives and
the fit from its traced memory.  The LITS query-service cell keeps its own
record's terms.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.configs.registry import get_arch

CARD = "NVIDIA H100 SXM, 700 W power limit (the published rates' setting)"
PEAK_FLOPS = 989e12      # bf16 dense FLOP/s a card
HBM_BW = 3.35e12         # bytes/s a card
LINK_BW = 50e9           # bytes/s a card across nodes: one 400 Gb/s NIC each way


def _attn_ctx(cfg: ArchConfig, S: int, kind: str) -> float:
    """Average attended context length per query."""
    if not cfg.has_attn:
        return 0.0
    if kind == "decode":
        return float(min(cfg.swa_window, S) if cfg.swa_window else S)
    if not cfg.causal:
        return float(S)
    if cfg.swa_window and cfg.swa_window < S:
        return float(cfg.swa_window)  # ~window per query once past warmup
    return S / 2.0


def flops_per_token(cfg: ArchConfig, S: int, kind: str) -> float:
    """Forward matmul FLOPs per token, padded dims (what the card executes)."""
    d, f = cfg.d_model, cfg.d_ff
    n_mats = 3 if cfg.mlp_act == "swiglu" else 2
    per_layer = 0.0
    if cfg.has_attn:
        H, KV, hd = cfg.n_heads_padded, cfg.n_kv_padded, cfg.hd
        per_layer += 2 * d * H * hd + 2 * 2 * d * KV * hd + 2 * H * hd * d
        per_layer += 4 * _attn_ctx(cfg, S, kind) * H * hd
    if cfg.has_mamba:
        di, N, dtr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
        per_layer += (2 * d * 2 * di + 2 * cfg.ssm_conv * di
                      + 2 * di * (dtr + 2 * N) + 2 * dtr * di
                      + 8 * di * N + 2 * di * d)
    if cfg.has_moe:
        per_layer += 2 * d * cfg.n_experts
        per_layer += 2 * d * f * n_mats * cfg.top_k * cfg.capacity_factor
        if cfg.moe_dense_ff:
            per_layer += 2 * d * cfg.moe_dense_ff * n_mats
    elif f:
        per_layer += 2 * d * f * n_mats
    head = 2 * d * cfg.vocab_padded
    return cfg.n_layers * per_layer + head


def analytic_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Total executed FLOPs per step (global, all devices)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        # fwd + 2x bwd + 1x remat recompute
        return 4.0 * B * S * flops_per_token(cfg, S, "train")
    if shape.kind == "prefill":
        return 1.0 * B * S * flops_per_token(cfg, S, "prefill")
    return 1.0 * B * flops_per_token(cfg, S, "decode")


def analytic_bytes(cfg: ArchConfig, shape: ShapeSpec, n_dev: int) -> float:
    """HBM traffic per device per step (analytic, coefficients documented)."""
    B, S = shape.global_batch, shape.seq_len
    P = cfg.param_count(True)
    d = cfg.d_model
    data_shards = 32 if n_dev == 512 else 16
    if shape.kind == "train":
        # fwd read (4B f32) + bwd read + remat read + grads write/read +
        # adam: read m,v(bf16) write p,m,v
        param_traffic = P * (4 * 3 + 4 * 2 + 2 * 2 + 4 + 2 * 2) / n_dev
        tok_dev = B * S / data_shards
        act_traffic = cfg.n_layers * tok_dev * d * 2 * 6  # residual streams, both passes
        return param_traffic + act_traffic
    if shape.kind == "prefill":
        param_traffic = P * 2 / n_dev
        tok_dev = B * S / data_shards
        act_traffic = cfg.n_layers * tok_dev * d * 2 * 3
        cache_write = 0.0
        if cfg.has_attn:
            W = min(cfg.swa_window, S) if cfg.swa_window else S
            cache_write = cfg.n_layers * (B / data_shards) * W * (cfg.n_kv_padded / 16) * cfg.hd * 2 * 2
        return param_traffic + act_traffic + cache_write
    # decode: stream all (active) params + read the whole cache
    act_P = cfg.active_param_count() + (cfg.param_count(True) - cfg.param_count(False))
    param_traffic = min(act_P, P) * 2 / n_dev
    cache_traffic = 0.0
    if cfg.has_attn:
        W = min(cfg.swa_window, S) if cfg.swa_window else S
        kv_b = 1 + 2 / cfg.hd if cfg.kv_cache_dtype == "int8" else 2
        cache_traffic = cfg.n_layers * (B / data_shards) * W * (cfg.n_kv_padded / 16) * cfg.hd * kv_b * 2
    if cfg.has_mamba:
        cache_traffic += cfg.n_layers * (B / data_shards) * (cfg.d_inner / 16) * cfg.ssm_state * 4 * 2
    return param_traffic + cache_traffic


def roofline_terms(flops_per_dev, bytes_per_dev, coll_bytes_per_dev) -> dict:
    """The three analytic terms, in seconds, on the H100's published rates."""
    return {
        "compute_s": flops_per_dev / PEAK_FLOPS,
        "memory_s": bytes_per_dev / HBM_BW,
        "collective_s": coll_bytes_per_dev / LINK_BW,
    }


def enrich(rec: dict) -> dict:
    """Add analytic roofline terms to a dry-run record."""
    if "skip" in rec or "error" in rec:
        return rec
    if rec.get("kind") == "index-serve":
        # the LITS query-service cell: its record's terms are the basis (its
        # bytes are the analytic count of the lookup's reads and writes)
        rec["analytic"] = {
            "flops_per_device": rec["flops_per_device"],
            "bytes_per_device": rec["hlo_bytes_per_device"],
            "roofline": rec["roofline"],
            "dominant": rec["dominant"],
            "step_time_lower_bound_s": max(rec["roofline"].values()),
            "useful_flops_ratio": 1.0,
        }
        return rec
    cfg = get_arch(rec["arch"])
    shape = SHAPES[rec["shape"]]
    n_dev = rec["n_devices"]
    af = analytic_flops(cfg, shape) / n_dev
    ab = analytic_bytes(cfg, shape, n_dev)
    terms = roofline_terms(af, ab, rec["collectives"]["total_bytes"])
    rec["analytic"] = {
        "flops_per_device": af,
        "bytes_per_device": ab,
        "roofline": terms,
        "dominant": max(terms, key=terms.get),
        "step_time_lower_bound_s": max(terms.values()),
        "useful_flops_ratio": rec["model_flops_per_device"] / af if af else None,
    }
    return rec


def load_all(out_dir: str = "experiments/dryrun") -> list:
    recs = []
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            recs.append(enrich(json.load(f)))
    return recs


def table(recs: list) -> str:
    """Markdown roofline table (single-pod rows per the spec; multi-pod fit rows too)."""
    lines = [
        "| arch | shape | mesh | mem/dev GiB | compute_s | memory_s | collective_s | dominant | MODEL/HLO | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if "skip" in r:
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | — | — | — | SKIP: {r['skip']} |"
            )
            continue
        if "error" in r:
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | — | — | — | ERROR |"
            )
            continue
        a = r["analytic"]
        t = a["roofline"]
        mem = r["memory"]["total_per_device"] / 2**30
        ur = a["useful_flops_ratio"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {mem:.2f} "
            f"| {t['compute_s']:.3e} | {t['memory_s']:.3e} | {t['collective_s']:.3e} "
            f"| {a['dominant'].replace('_s','')} | {ur:.2f} | |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--out", default="experiments/roofline.md")
    args = ap.parse_args(argv)
    recs = load_all(args.dir)
    md = table(recs)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("# Roofline table (auto-generated by repro_torch.launch.roofline; analytic terms "
                f"on the published peaks of the {CARD})\n\n" + md + "\n")
    print(md)


if __name__ == "__main__":
    main()
