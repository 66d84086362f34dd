"""Build and load the port's CUDA kernels.

Each source under ``src/repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ctypes. Nothing here runs at import: the first wrapper call (or
:func:`build_all`) builds every missing library, one ``nvcc`` per source,
all started together. Libraries land in ``build/repro_torch/`` at the
repository root, named by a hash of their source and flags, so an edited
source is rebuilt and an unchanged one is reused.

Each C entry returns ``cudaGetLastError()`` after its launch; the
wrapper passes it to :func:`check`, which raises on a failed launch and
otherwise adds one to the kernel's count in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_PTRS = ctypes.POINTER(ctypes.c_uint64)
_STRIDES = ctypes.POINTER(ctypes.c_int64)

# library -> {C entry: argtypes}; every entry returns a cudaError_t as int
LIBRARIES = {
    "halo_pack": {
        # (src, R, nx, ny, nz, element bytes, ptrs, strides, stream)
        "halo_pack_launch": (_PTR, _INT, _INT, _INT, _INT, _INT, _PTRS,
                             _STRIDES, _PTR),
        # (acc, dtype, R, nx, ny, nz, ptrs, strides, rank max or NULL,
        #  stream)
        "halo_unpack_launch": (_PTR, _INT, _INT, _INT, _INT, _INT, _PTRS,
                               _STRIDES, _PTR, _PTR),
        # (src, it, out, it out, dtype, R, cells of a rank, stream)
        "faces_increment_launch": (_PTR, _PTR, _PTR, _PTR, _INT, _INT, _I64,
                                   _PTR),
    },
    # put_signal: (x, x rank stride in bytes, out, row bytes, R, perm, sig,
    #  upd, sig out or NULL, signal slots, stream); put_multicast: the same
    #  with the branch count after R and perm an (nb, R) table
    "counter_bump": {
        "counter_bump_launch": (_PTR, _PTR, _PTR, _I64, _PTR),
        "put_signal_launch": (_PTR, _I64, _PTR, _I64, _INT, _PTR, _PTR, _PTR,
                              _PTR, _I64, _PTR),
        "put_multicast_launch": (_PTR, _I64, _PTR, _I64, _INT, _INT, _PTR,
                                 _PTR, _PTR, _PTR, _I64, _PTR),
    },
    # (dtype, q, k, v, out, q_offset, kv_len, B, Sq, Skv, H, KV, hd, hdv,
    #  strides[12], causal, scale (0: hd^-1/2), stream)
    "flash_attention": {
        "flash_attention_launch": (_INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                                   _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                                   _STRIDES, _INT, ctypes.c_float, _PTR),
    },
    # (dtype, q, k, v, out, workspace, positions, kv_len, B, S, H, KV, hd,
    #  hdv, nsplit, strides[12], stream)
    "decode_attention": {
        "decode_attention_launch": (_INT, _PTR, _PTR, _PTR, _PTR, _PTR,
                                    _PTR, _PTR, _INT, _INT, _INT, _INT, _INT,
                                    _INT, _INT, _STRIDES, _PTR),
    },
    # (dtype, r, k, v, logw, u, s0, sT, y, B, S, H, hd, strides[19],
    #  stream)
    "wkv6": {
        "wkv6_launch": (_INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                        _INT, _INT, _INT, _INT, _STRIDES, _PTR),
    },
    # (dtype, ds, a_log, dt, b, c, x, h0, hT, y, B, S, di, strides[10],
    #  stream)
    "mamba_scan": {
        "mamba_scan_launch": (_INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                              _PTR, _PTR, _INT, _INT, _INT, _STRIDES, _PTR),
    },
    # rmsnorm: (dtype, scale dtype, x, x row stride, delta or NULL, its row
    #  stride, sum or NULL, y, scale, rows, D, eps, stream); rope_cache:
    #  (dtype, cache dtype, q, k, v, q out or NULL, cache k, cache v, cos or
    #  NULL, sin or NULL, cols, strides[19], B, S, H, KV, hd, max_len,
    #  stream)
    "norm_rope": {
        "rmsnorm_launch": (_INT, _INT, _PTR, _I64, _PTR, _I64, _PTR, _PTR,
                           _PTR, _I64, _INT, ctypes.c_float, _PTR),
        "rope_cache_launch": (_INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                              _PTR, _PTR, _PTR, _STRIDES, _INT, _INT, _INT,
                              _INT, _INT, _I64, _PTR),
    },
}

# launches per kernel since the last reset_launches(); a wrapper adds
# one only after its kernel was launched without error
LAUNCHES: Dict[str, int] = {"halo_pack": 0, "halo_unpack": 0,
                            "faces_increment": 0, "counter_bump": 0,
                            "put_signal": 0, "put_multicast": 0,
                            "flash_attention": 0,
                            "decode_attention": 0, "wkv6": 0,
                            "mamba_scan": 0, "rmsnorm": 0, "rope_cache": 0}

_loaded: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry reported a CUDA error, else count the launch."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES[kernel] += 1


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH); "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every missing library of ``names`` (default: all) in
    parallel; returns {name: seconds} of the builds that ran. The
    compiler's report (``-Xptxas -v``: registers, spills) is kept beside
    each library as ``.log``."""
    todo = [n for n in (names or LIBRARIES) if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    secs, failed = {}, []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + out.with_suffix(".log").read_text()[-4000:])
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for entry, argtypes in LIBRARIES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
