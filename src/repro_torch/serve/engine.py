"""Batched serving engine: LITS prefix-cache -> prefill -> decode loop.  The
port of :mod:`repro.serve.engine`."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models import LMModel
from .prefix_cache import PrefixCache


@dataclasses.dataclass
class ServeStats:
    prefills: int = 0
    cached_prefills: int = 0
    decode_steps: int = 0
    wall_s: float = 0.0


class ServeEngine:
    """Greedy batched decoding with exact-prefix KV reuse via LITS.

    The model holds its own parameters (the reference passes ``params``).
    The prompt cache's index lives on ``index_device`` (the model's device
    when ``None``); ``index_config`` (an ``IndexConfig``) overrides it, and
    ``index_service`` shares one request plane across engines.
    """

    def __init__(self, model: LMModel, cache_capacity: int = 1024,
                 index_device: Optional[str] = None,
                 index_config=None, max_len: int = 512,
                 index_service=None):
        self.model = model
        # max_len bounds prompt + generation + 1 (the KV allocation); it is
        # validated per request in generate() — never silently clamped
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.max_len = int(max_len)
        device = str(model.device) if index_device is None else index_device
        self.prefix_cache = PrefixCache(capacity=cache_capacity, device=device,
                                        config=index_config, service=index_service)
        self.stats = ServeStats()

    @staticmethod
    def _prompt_key(tokens: np.ndarray, need: int) -> bytes:
        # tokenizer-independent exact key: 1-based bytes of the token ids.
        # ``need`` (the KV window the state was prefilled with) is part of
        # the identity: a cached state can only serve requests with the
        # same allocation — reusing a smaller-window state for a longer
        # generation would decode past its KV buffers, and mixing windows
        # in one all-hit batch would stack mismatched shapes.
        return b"p:%d:" % need + \
            tokens.astype(">u4").tobytes().replace(b"\x00", b"\x01")

    @torch.no_grad()
    def generate(self, prompt_tokens: np.ndarray, n_steps: int) -> Dict[str, np.ndarray]:
        """prompt_tokens: (B, S) int32.  Returns generated ids (B, n_steps)."""
        t0 = time.time()
        B, S = prompt_tokens.shape
        need = S + n_steps + 1
        if need > self.max_len:
            raise ValueError(
                f"prompt ({S} tokens) + generation ({n_steps}) needs a KV "
                f"window of {need} > max_len={self.max_len}; raise max_len "
                f"on the engine or shorten the request")
        keys = [self._prompt_key(prompt_tokens[i], need) for i in range(B)]
        hit, slots = self.prefix_cache.lookup(keys)
        if hit.all():
            # whole batch served from the prefix cache (skip prefill entirely);
            # the stack copies, so decoding never writes into a stored state
            states = [self.prefix_cache.get_state(s) for s in slots]
            cache = {k: torch.stack([s["cache"][k] for s in states], dim=1)
                     for k in states[0]["cache"]}
            logits = torch.stack([s["logits"] for s in states], dim=0)
            self.stats.cached_prefills += B
        else:
            tokens = torch.from_numpy(np.ascontiguousarray(prompt_tokens, np.int32))
            cache, logits = self.model.prefill(
                {"tokens": tokens.to(self.model.device)}, max_len=need)
            self.stats.prefills += B
            misses = [i for i in range(B) if not hit[i]]
            # copies: decode_step writes the batch's cache in place, and a
            # row view would also keep the whole batch's cache alive
            states = [
                {"cache": {k: v[:, i].clone() for k, v in cache.items()},
                 "logits": logits[i].clone()}
                for i in misses
            ]
            self.prefix_cache.admit([keys[i] for i in misses], states)
        out = torch.empty((B, n_steps), dtype=torch.int32, device=logits.device)
        vocab = self.model.cfg.vocab
        tok = torch.argmax(logits[:, :vocab], dim=-1).to(torch.int32)
        for t in range(n_steps):
            out[:, t] = tok
            cache, logits = self.model.decode_step(cache, tok, S + t)
            tok = torch.argmax(logits[:, :vocab], dim=-1).to(torch.int32)
            self.stats.decode_steps += 1
        generated = out.cpu().numpy()
        self.stats.wall_s += time.time() - t0
        return {"generated": generated}
