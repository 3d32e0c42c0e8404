"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/lib<name>-<digest>.so`` at
the repo root, and is loaded with ``ctypes``.  The digest covers the source,
the headers it includes (transitively) and the flags, so an edited source
never loads a stale library and a new header rebuilds only its includers.  Nothing is built when a module is imported: :func:`library` builds
at first use, and :func:`build_all` starts one ``nvcc`` per source at once.

Every C entry point takes its pointers and the CUDA stream as ``void*``,
launches on that stream and returns ``cudaGetLastError()``; :func:`launch`
raises if that is not 0.  The wrapper that calls :func:`launch` adds one to
its entry in :data:`LAUNCHES`, so a run can show which kernels it went
through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import weakref
from pathlib import Path
from typing import Callable, Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("hpt_cdf", "hpt_locate", "cnode_probe", "traverse", "rank", "scan",
           "hpt_cdf_onehot")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# launches of each kernel through its wrapper (not of the plain versions)
LAUNCHES: Dict[str, int] = {name: 0 for name in (
    "hpt_cdf", "hpt_locate", "cnode_probe", "fused_search", "rank", "scan", "hpt_cdf_onehot")}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# (kind, id of the first source) -> (weak refs to the sources, their versions, table)
_DERIVED: Dict[tuple, tuple] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist.  There is
    no fallback to the CPU: pass ``device="cpu"`` to run the plain versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.M)


def _sources_of(name: str):
    """``csrc/<name>.cu`` and every local header it includes, in include order."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        p = todo.pop(0)
        if p not in seen:
            seen.append(p)
            todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(p.read_bytes())]
    return seen


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources_of(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Sequence[str] = SOURCES) -> None:
    """Compile every missing library, one nvcc per source, all at once.

    Each nvcc writes a temporary file beside its library, renamed when the
    build succeeds, so a concurrent process never loads a half-written one.
    Every nvcc started is waited for before a failure is raised."""
    with _lock:
        todo = [(name, _lib_path(name)) for name in names]
        todo = [(name, out) for name, out in todo if not out.exists()]
        if not todo:
            return
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name, out in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
            jobs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for name, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                os.unlink(tmp)
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
        if errors:
            raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        out = _lib_path(name)
        if not out.exists():
            build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(out))
                _libs[name] = lib
    return lib


def launch(lib_name: str, fn_name: str, argtypes, *args) -> None:
    """Call a C entry point and raise on a non-zero ``cudaGetLastError()``."""
    fn = getattr(library(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")


def check_stage_width(W: int, dev: torch.device) -> None:
    """Refuse query rows too wide for K4, K5 and K6 to stage one of them in
    a block's shared memory (``stage_stride(W)`` 32-bit words of
    ``csrc/lits_words.cuh``; past 48 KB the kernels opt in to more, up to
    the device's limit: 227 KB on an H100)."""
    need = 4 * (((W + 3) // 4) | 1)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if need > limit:
        raise ValueError(f"query width {W}: a staged row takes {need} bytes of shared "
                         f"memory, more than the {limit} a block can have")


def derived(kind: str, sources: Sequence[torch.Tensor],
            make: Callable[..., torch.Tensor]) -> torch.Tensor:
    """``make(*sources)``: a table a kernel reads in place of its sources,
    made once per set of source tensors and kept while the first of them
    lives.  It is made again when a source is another tensor or has been
    written in place (a new tensor version), so it is never stale.  It is
    derived state: no field of the index and no part of a snapshot."""
    key = (kind, id(sources[0]))
    versions = tuple(t._version for t in sources)
    hit = _DERIVED.get(key)
    if hit is not None and hit[1] == versions and all(
            ref() is t for ref, t in zip(hit[0], sources)):
        return hit[2]
    table = make(*sources)
    refs = [weakref.ref(sources[0], lambda _ref: _DERIVED.pop(key, None))]
    _DERIVED[key] = (refs + [weakref.ref(t) for t in sources[1:]], versions, table)
    return table


def as_rows(v, B: int, dtype, device) -> torch.Tensor:
    """Scalar or (B,) value -> contiguous (B,) tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(v, dtype=dtype, device=device).expand(B).contiguous()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
