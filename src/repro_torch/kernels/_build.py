"""Build the CUDA sources under ``src/repro_torch/csrc`` and bind them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into ``build/repro_torch/lib<name>.<digest>.so`` at the root of
the checkout, then loaded with :mod:`ctypes`. ``<digest>`` hashes the
source's bytes and the compiler flags, so a library is only ever loaded
for the exact source it was built from: a library built from another
state of the source (an older commit, a copied variant) is never taken,
whatever the files' mtimes say. Nothing here runs at import time: the
first kernel launch builds what it needs, and :func:`build_all` builds
every source at once, one ``nvcc`` process per source, all started
together.

Every entry point takes raw device pointers and PyTorch's current stream
(``c_void_p``) and returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

# source name -> {C entry point: argtypes}
SIGNATURES: dict[str, dict[str, list]] = {
    "consensus_mix": {
        "repro_flat_mix_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "repro_flat_mix_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "repro_flat_consensus": [_P, _P, _P, _I, _I, _I, _I, _P],
        "repro_consensus_mix_f32": [_P, _P, _P, _P, _P, _I, _I, _P],
        "repro_consensus_mix_bf16": [_P, _P, _P, _P, _P, _I, _I, _P],
    },
    "cnd_sketch": {
        "repro_cnd_bitmaps": [_P, _P, _I, _I, _I, _I, _I, _P],
        "repro_cnd_popcount": [_P, _P, _I, _I, _P],
    },
    "sparse_mix": {
        "repro_sparse_mix_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "repro_sparse_mix_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "repro_cluster_mix_f32": [_P] * 12 + [_I] * 6 + [_P],
        "repro_cluster_mix_bf16": [_P] * 12 + [_I] * 6 + [_P],
    },
    "robust_agg": {
        "repro_robust_agg": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
        "repro_robust_agg_scratch_words": [_I],
    },
    "flash_attention": {
        "repro_flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _I, _I, _F, _P],
        "repro_flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _I, _I, _I, _F, _P],
    },
    "rwkv6_scan": {
        "repro_rwkv6_scan_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _P],
        "repro_rwkv6_scan_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _P],
    },
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
# source name -> digest of the library loaded for it in this process
loaded_digests: dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built on a machine with the CUDA toolkit")


def digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu``'s bytes and the ``nvcc`` flags: the key
    of the library built from them."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(b"\0")
    h.update((CSRC / f"{name}.cu").read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the library of today's ``csrc/<name>.cu`` is (or goes)."""
    return BUILD_DIR / f"lib{name}.{digest(name)}.so"


def _stale(name: str) -> bool:
    return not library_path(name).exists()


def build_all(force: bool = False) -> dict[str, str]:
    """Compile every stale source in parallel; returns each compiled
    source's compiler log (``-Xptxas -v`` register and shared-memory
    report). Raises with the log when a compile fails."""
    names = [n for n in SIGNATURES if force or _stale(n)]
    if not names:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for name in names:
        lib = library_path(name)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    key = digest(name)
    path = BUILD_DIR / f"lib{name}.{key}.so"
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    loaded_digests[name] = key
    return lib


def check(name: str, fn: str, code: int) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        msg = library(name).repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {code} ({msg})")

