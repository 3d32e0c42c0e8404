"""The port's LM serving path (``repro_torch.serve.prefix_cache``,
``repro_torch.serve.engine``, ``repro_torch.launch.serve``) against the JAX
reference's, on the CPU (``device="cpu"``: the index runs the kernels'
plain versions).

* The prefix-cache and engine cases of tests/test_serve_and_ycsb.py, on the
  port.
* Prompt keys byte for byte, and the cache's over-width refusal at the same
  key lengths as the reference's.
* One request sequence through both engines with the same weights: equal
  hit, miss, insert and eviction counts; teacher-forced per-step logits
  within ``LOGIT_TOL`` (rtol = atol = 6e-2: the reference's prefill and
  decode are compiled, and XLA's float32 excess precision inside fusions
  moves logits by up to ≈0.05 against an op-by-op run); the port's greedy
  tokens equal the reference's on every row whose reference top-1/top-2
  margin exceeds twice that tolerance at every step.
* The launcher on a reduced arch, and the port's import guard.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as R_ARCHS
from repro.models import LMModel as RModel
from repro.serve.engine import ServeEngine as RServeEngine
from repro.serve.prefix_cache import PrefixCache as RPrefixCache
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import lm_params_from_reference
from repro_torch.index import PutRequest, Status
from repro_torch.launch import serve as launch_serve
from repro_torch.models import LMModel
from repro_torch.serve import PrefixCache, ServeEngine

LOGIT_TOL = 6e-2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def closing():
    """Caches and engines a test makes, their services closed after it."""
    made = []
    yield made
    for obj in made:
        (obj.prefix_cache if hasattr(obj, "prefix_cache") else obj).close()


def _cache(closing, **kw):
    pc = PrefixCache(device="cpu", **kw)
    closing.append(pc)
    return pc


def _engine(closing, arch="chatglm3-6b", **kw):
    m = LMModel(ARCHS[arch].reduced(), device="cpu")
    eng = ServeEngine(m, **kw)
    closing.append(eng)
    return eng


# ---------------------------------------------------------------------------
# tests/test_serve_and_ycsb.py's cases, on the port
# ---------------------------------------------------------------------------

def test_prefix_cache_hit_miss_cycle(closing):
    pc = _cache(closing, capacity=256)
    prompts = [b"prompt-%03d" % i for i in range(20)]
    hit, _ = pc.lookup(prompts)
    assert not hit.any()
    pc.admit(prompts, [{"cache": {"x": torch.zeros((2, 2))}, "logits": torch.zeros(4)}] * 20)
    hit2, slots = pc.lookup(prompts)
    assert hit2.all()
    assert pc.get_state(slots[0]) is not None
    assert pc.stats.hit_rate > 0


def test_prefix_cache_capacity_eviction_under_pressure(closing):
    pc = _cache(closing, capacity=32)
    for wave in range(4):
        prompts = [b"w%d-%03d" % (wave, i) for i in range(16)]
        pc.admit(prompts, [{"cache": {}, "logits": torch.zeros(2)}] * 16)
    assert len(pc.store) <= 32
    assert pc.stats.evictions >= 32
    hit, _ = pc.lookup([b"w0-000", b"w3-015"])
    assert not hit[0], "LRU victim must be evicted (store stayed bounded)"
    assert hit[1], "recent admission must survive"
    assert all(pc.get_state(s) is not None for s in pc._lru)
    pc.service.maintenance_step()
    hit2, _ = pc.lookup([b"w3-015", b"w0-000"])
    assert hit2[0] and not hit2[1]


def test_prefix_cache_lru_recency_protects_hot_slots(closing):
    pc = _cache(closing, capacity=8)
    a = [b"a-%02d" % i for i in range(8)]
    pc.admit(a, [{"logits": torch.zeros(2)}] * 8)
    pc.lookup([a[0], a[1]])                    # refresh a0/a1 recency
    pc.admit([b"b-%02d" % i for i in range(4)],
             [{"logits": torch.zeros(2)}] * 4)   # evicts 4 LRU: a2..a5
    hit, _ = pc.lookup(a)
    assert hit[0] and hit[1], "recently-hit slots must survive eviction"
    assert not hit[2:6].any(), "least-recently-hit slots are the victims"


@pytest.mark.parametrize("arch", ["chatglm3-6b", "falcon-mamba-7b", "h2o-danube-3-4b"])
def test_serve_engine_cache_reuse(closing, arch):
    """The second serve of a batch comes from the cache and generates the same
    tokens.  The engine stores copies of the per-row states: a row view of
    the batch's cache would be overwritten by the batch's own decode steps
    (``decode_step`` writes in place), and the second serve would decode
    from a cache that already holds generated tokens.  With a full KV cache
    the slots past the position are masked, so only the SSM state
    (falcon-mamba) and a ring buffer that wraps (danube, window 8) show it
    in the tokens."""
    eng = _engine(closing, arch)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, eng.model.cfg.vocab, size=(2, 8)).astype(np.int32)
    out1 = eng.generate(prompts, n_steps=4)
    assert eng.stats.prefills == 2 and eng.stats.cached_prefills == 0
    out2 = eng.generate(prompts, n_steps=4)
    assert eng.stats.cached_prefills == 2, "second pass must be served from LITS cache"
    assert np.array_equal(out1["generated"], out2["generated"])


def test_serve_engine_stored_state_is_the_prefill_state(closing):
    """After the batch's decode steps, each stored state still equals a fresh
    prefill of its prompt, and owns its storage (not a view of the batch)."""
    eng = _engine(closing)
    prompts = np.random.default_rng(1).integers(0, 512, size=(3, 8)).astype(np.int32)
    eng.generate(prompts, n_steps=5)
    cache, logits = eng.model.prefill({"tokens": torch.from_numpy(prompts)}, max_len=14)
    hit, slots = eng.prefix_cache.lookup(
        [ServeEngine._prompt_key(prompts[i], 14) for i in range(3)])
    assert hit.all()
    for i, s in enumerate(slots):
        st = eng.prefix_cache.get_state(s)
        assert torch.equal(st["logits"], logits[i])
        for k, v in cache.items():
            assert torch.equal(st["cache"][k], v[:, i]), k
            assert st["cache"][k]._base is None, "a stored state must not be a view"


def test_prefix_cache_duplicate_admission_single_slot(closing):
    pc = _cache(closing, capacity=8)
    p = b"dup-prompt"
    slots = pc.admit([p, p], [{"logits": torch.zeros(2)}, {"logits": torch.ones(2)}])
    assert slots[0] == slots[1] and len(pc.store) == 1
    hit, got = pc.lookup([p])
    assert hit[0] and got[0] == slots[0]
    assert float(pc.get_state(slots[0])["logits"][0]) == 1.0


def test_prefix_cache_readmission_reclaims_stale_slot(closing):
    pc = _cache(closing, capacity=8)
    s1 = pc.admit([b"p"], [{"v": 1}])[0]
    s2 = pc.admit([b"p"], [{"v": 2}])[0]
    assert s2 != s1 and len(pc.store) == 1
    assert pc.get_state(s1) is None
    hit, slots = pc.lookup([b"p"])
    assert hit[0] and slots[0] == s2 and pc.get_state(s2)["v"] == 2


def test_prefix_caches_sharing_one_service_are_isolated(closing):
    a = _cache(closing, capacity=8)
    b = PrefixCache(capacity=8, service=a.service)
    a.admit([b"shared-prompt"], [{"who": "a"}])
    hit_b, _ = b.lookup([b"shared-prompt"])
    assert not hit_b[0], "cache B must not see cache A's admission"
    hit_a, slots_a = a.lookup([b"shared-prompt"])
    assert hit_a[0] and a.get_state(slots_a[0])["who"] == "a"
    b.close()          # B doesn't own the shared service: must not stop it
    hit_a2, _ = a.lookup([b"shared-prompt"])
    assert hit_a2[0]


def test_serve_engine_cached_state_window_is_part_of_identity(closing):
    eng = _engine(closing, max_len=64)
    prompts = np.random.default_rng(0).integers(0, 512, size=(2, 8)).astype(np.int32)
    eng.generate(prompts, n_steps=4)
    assert eng.stats.prefills == 2
    out = eng.generate(prompts, n_steps=12)   # larger window: NOT a hit
    assert eng.stats.prefills == 4 and eng.stats.cached_prefills == 0
    assert out["generated"].shape == (2, 12)
    eng.generate(prompts, n_steps=12)         # same window: cache hit
    assert eng.stats.cached_prefills == 2


def test_serve_engine_max_len_validated_not_clamped(closing):
    eng = _engine(closing, max_len=16)
    assert eng.max_len == 16
    rng = np.random.default_rng(0)
    eng.generate(rng.integers(0, 512, size=(1, 8)).astype(np.int32), n_steps=7)  # 16: fits
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(rng.integers(0, 512, size=(1, 12)).astype(np.int32), n_steps=8)
    with pytest.raises(ValueError):
        ServeEngine(eng.model, max_len=0)


# ---------------------------------------------------------------------------
# prompt keys and the cache's width, against the reference
# ---------------------------------------------------------------------------

def test_prompt_key_matches_reference():
    rng = np.random.default_rng(2)
    for S, need in ((1, 2), (8, 13), (48, 81)):
        toks = rng.integers(0, 102400, S).astype(np.int32)
        toks[0] = 0            # a zero token id: its bytes become 0x01
        toks[-1] = 0x01000100
        assert ServeEngine._prompt_key(toks, need) == RServeEngine._prompt_key(toks, need)
        assert len(ServeEngine._prompt_key(toks, need)) == len(b"p:%d:" % need) + 4 * S


def test_over_width_refusal_matches_reference(closing):
    """The cache's index is 256 bytes wide and the tenant prefix
    (``prefix-cache-<n>`` + 0x1f) rides on every key: both packages cache a
    200-byte key, refuse a 250-byte one (``REJECTED_OVER_WIDTH``, the state
    dropped), and refuse exactly the keys whose encoded length passes 256
    (the prefix's length grows with the count of caches made in the
    process, so each package is held to its own tenant's)."""
    lengths = [200] + list(range(236, 246)) + [250]
    keys = [bytes([65 + i % 26]) * n for i, n in enumerate(lengths)]
    port = _cache(closing, capacity=64)
    ref = RPrefixCache(capacity=64)
    try:
        for pc in (port, ref):
            slots = pc.admit(keys, [{"n": n} for n in lengths])
            fits = np.array([len(pc.tenant) + 1 + n <= 256 for n in lengths])
            np.testing.assert_array_equal(slots >= 0, fits)
            assert slots[0] >= 0 and slots[-1] == -1
            hit, _ = pc.lookup(keys)
            np.testing.assert_array_equal(hit, fits)
            assert len(pc.store) == int(fits.sum())
        put = port.service.execute([PutRequest(keys[-1], 1)], tenant=port.tenant)[0]
        assert put.status == Status.REJECTED_OVER_WIDTH
    finally:
        ref.close()


# ---------------------------------------------------------------------------
# one request sequence through both engines
# ---------------------------------------------------------------------------

def _ref_logits(rm, params, prompts, tokens, max_len):
    """The reference's logits at each step, teacher-forced with ``tokens``."""
    prefill = jax.jit(rm.prefill, static_argnames="max_len")
    decode = jax.jit(rm.decode_step)
    cache, logits = prefill(params, {"tokens": jnp.asarray(prompts)}, max_len=max_len)
    out = [np.asarray(logits)]
    for t in range(tokens.shape[1] - 1):
        cache, logits = decode(params, cache, jnp.asarray(tokens[:, t]),
                               jnp.int32(prompts.shape[1] + t))
        out.append(np.asarray(logits))
    return np.stack(out)


def _port_logits(m, prompts, tokens, max_len):
    cache, logits = m.prefill({"tokens": torch.from_numpy(prompts)}, max_len=max_len)
    out = [logits.numpy()]
    for t in range(tokens.shape[1] - 1):
        cache, logits = m.decode_step(cache, torch.from_numpy(tokens[:, t].copy()),
                                      prompts.shape[1] + t)
        out.append(logits.numpy())
    return np.stack(out)


def test_engines_agree_on_a_request_sequence(closing):
    arch = "deepseek-7b"
    rcfg = R_ARCHS[arch].reduced()
    rm = RModel(rcfg)
    params = rm.init(jax.random.PRNGKey(0))
    m = lm_params_from_reference(jax.tree_util.tree_map(np.asarray, params),
                                 LMModel(ARCHS[arch].reduced(), device="cpu"))
    B, S, G, cap = 2, 8, 6, 4
    reng = RServeEngine(rm, params, cache_capacity=cap, max_len=32)
    teng = ServeEngine(m, cache_capacity=cap, max_len=32)
    closing.append(teng)
    rng = np.random.default_rng(5)
    pool = [rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32) for _ in range(4)]
    plan = [0, 1, 0, 2, 0, 3, 1, 1, 0]      # hits, misses and LRU evictions (capacity 4)
    try:
        for i in plan:
            want = reng.generate(pool[i], n_steps=G)["generated"]
            got = teng.generate(pool[i], n_steps=G)["generated"]
            rl = _ref_logits(rm, params, pool[i], want, S + G + 1)
            tl = _port_logits(m, pool[i], want, S + G + 1)
            np.testing.assert_allclose(tl, rl, rtol=LOGIT_TOL, atol=LOGIT_TOL)
            top2 = np.sort(rl[..., : rcfg.vocab], axis=-1)[..., -2:]
            clear = ((top2[..., 1] - top2[..., 0]) > 2 * LOGIT_TOL).all(axis=0)
            np.testing.assert_array_equal(got[clear], want[clear])
            # teacher-forced, the port's greedy pick is the reference's token
            # wherever the reference's margin is clear
            step_clear = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_TOL
            picks = tl[..., : rcfg.vocab].argmax(-1)
            np.testing.assert_array_equal(picks[step_clear], want.T[step_clear])
        for field in ("prefills", "cached_prefills", "decode_steps"):
            assert getattr(teng.stats, field) == getattr(reng.stats, field), field
        for field in ("hits", "misses", "inserts", "evictions"):
            assert getattr(teng.prefix_cache.stats, field) == \
                getattr(reng.prefix_cache.stats, field), field
        assert teng.prefix_cache.stats.evictions > 0 and teng.stats.cached_prefills > 0
    finally:
        reng.prefix_cache.close()


# ---------------------------------------------------------------------------
# the launcher and the import guard
# ---------------------------------------------------------------------------

def test_launch_serve_main_matches_reference(capsys, monkeypatch):
    """The launcher's request plan, counts and printout are the reference's
    (its cache and service counts line for line; the wall time and latency
    figures differ)."""
    from repro.launch import serve as r_launch

    args = ["--arch", "chatglm3-6b", "--requests", "8", "--batch", "2", "--prompt-len", "8",
            "--gen", "3", "--cache-capacity", "16"]
    launch_serve.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    r_launch.main()
    want = capsys.readouterr().out.splitlines()
    assert got[0].startswith("8 request batches (2x8+3) in ") and got[0].endswith(" on cpu")
    assert got[1:3] == want[1:3]
    assert "cached_prefills=4" in got[1] and "evictions=0" in got[2]
    assert got[3].split(" p50=")[0] == want[3].split(" p50=")[0]


def test_launch_serve_reduced_flag_can_be_cleared():
    """``--no-reduced`` selects the published config (the reference's
    ``--reduced`` cannot be cleared): hubert-xlarge is then refused by its
    full name, before any model is built."""
    with pytest.raises(SystemExit, match="hubert-xlarge-smoke is encoder-only"):
        launch_serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])
    with pytest.raises(SystemExit, match="^hubert-xlarge is encoder-only"):
        launch_serve.main(["--arch", "hubert-xlarge", "--no-reduced", "--device", "cpu"])


def test_port_imports_neither_jax_nor_repro():
    """Every module of ``repro_torch`` imports with ``jax`` and ``repro``
    blocked by a ``sys.meta_path`` finder that raises."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=240)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 30
