"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> --requests N``.
The port of :mod:`repro.launch.serve`.

Batched greedy decoding with the LITS exact-prefix prompt cache; repeated
prompts skip prefill entirely (the paper's index on the serving hot path).
The model is initialised from a generator seeded 0 on ``--device``
(``cuda`` by default).  ``--reduced`` (the default) runs the config's tiny
smoke-test variant and ``--no-reduced`` the published config; the
reference's flag cannot be cleared, so it always runs the reduced one.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels._build import resolve_device
from repro_torch.models import LMModel
from repro_torch.serve.engine import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="the config's reduced smoke-test variant (--no-reduced: "
                         "the published config)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--repeat-frac", type=float, default=0.5,
                    help="fraction of repeated prompts (prefix-cache hits)")
    ap.add_argument("--max-len", type=int, default=512,
                    help="KV window bound: prompt + generation + 1 must fit "
                         "(validated per request, never silently clamped)")
    ap.add_argument("--cache-capacity", type=int, default=1024,
                    help="prefix-cache slots; past this, LRU eviction via "
                         "the index DELETE path")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the prompt cache's index run")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.decoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    dev = resolve_device(args.device)
    model = LMModel(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    eng = ServeEngine(model, cache_capacity=args.cache_capacity, max_len=args.max_len)
    try:
        rng = np.random.default_rng(0)
        base = rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)
        t0 = time.time()
        for r in range(args.requests):
            if rng.random() < args.repeat_frac and r > 0:
                prompts = base  # repeated -> LITS cache hit
            else:
                prompts = rng.integers(0, cfg.vocab,
                                       size=(args.batch, args.prompt_len)).astype(np.int32)
            eng.generate(prompts, n_steps=args.gen)
        wall = time.time() - t0
        s = eng.stats
        pc = eng.prefix_cache.stats
        print(f"{args.requests} request batches ({args.batch}x{args.prompt_len}+{args.gen}) "
              f"in {wall:.2f}s on {dev}")
        print(f"prefills={s.prefills} cached_prefills={s.cached_prefills} "
              f"decode_steps={s.decode_steps}")
        print(f"prefix-cache hit_rate={pc.hit_rate:.2f} inserts={pc.inserts} "
              f"evictions={pc.evictions} merges={pc.merges}")
        # the request plane under the cache
        sv = eng.prefix_cache.service.stats()
        print(f"index-service flushes={sv.flushes} "
              f"coalescing={sv.coalescing_factor:.1f} ops/dispatch "
              f"p50={sv.p50_ms:.2f}ms p99={sv.p99_ms:.2f}ms "
              f"shed={sv.shed} maintenance_merges={sv.merges}")
    finally:
        eng.prefix_cache.close()


if __name__ == "__main__":
    main()
