"""Build and load the CUDA kernels under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` compiles on its own into ``lib<name>.so`` with a
plain C interface, ``nvcc -gencode arch=compute_90a,code=sm_90a``, all
sources in parallel (one ``nvcc`` each); headers there (``*.cuh``) are
included by the sources and never compiled alone. The libraries go to
``build/repro_torch/<hash>/`` under the repository root, keyed by a hash
of the sources and flags, so an edit rebuilds and an unchanged tree
reuses what it built. Nothing is built at import time: a host without
``nvcc`` can import every module and run the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# library, C entry point and argument types of each kernel entry; pointers
# and the stream go as c_void_p so ctypes never cuts them to 32 bits.
SIGNATURES = {
    "hash_encode": ("hash_encode", "repro_hash_encode",
                    [_P, _P, _P, _P, _P, _LL] + [_I] * 6 + [_P]),
    "hash_encode_tiled": ("hash_encode", "repro_hash_encode_tiled",
                          [_P, _P, _P, _P, _P, _LL] + [_I] * 4 + [_P]),
    "hamming": ("hamming", "repro_hamming", [_P, _P, _P, _I, _LL, _I, _P]),
    "bucket_match": ("hamming", "repro_bucket_match",
                     [_P, _P, _P, _I, _LL, _I, _I, _P]),
    "delta_scan": ("hamming", "repro_delta_scan",
                   [_P, _P, _P, _P, _I, _LL, _I, _I, _P]),
    "bucket_gather": ("bucket_gather", "repro_bucket_gather",
                      [_P, _P, _P, _I, _I, _I, _P]),
    "planned_runs": ("bucket_gather", "repro_planned_runs",
                     [_P] * 6 + [_I, _LL, _I, _P]),
    "fused_query": ("fused_query", "repro_fused_query",
                    [_P, _P, _P, _P, _I] + [_P] * 8 + [_I] * 11 + [_P]),
    "mips_topk": ("mips_topk", "repro_mips_topk",
                  [_P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _LL, _I, _P]),
    # occupancy query, not a launch: blocks per SM at a given k
    "mips_topk_blocks": ("mips_topk", "repro_mips_topk_blocks_per_sm", [_I]),
    "latent_attend": ("latent_attn", "repro_latent_attend",
                      [_P] * 8 + [_I] * 5 + [_LL] * 4
                      + [ctypes.c_float, _I, _P]),
}
LIBRARIES = tuple(dict.fromkeys(lib for lib, _, _ in SIGNATURES.values()))

_functions: Dict[str, ctypes._CFuncPtr] = {}
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built on this host")
    return nvcc


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every kernel library that is not built yet, all at once,
    and return their paths. Raises ``RuntimeError`` with the compiler's
    output when a source does not compile."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in LIBRARIES}
    procs = {}
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return libs


def function(name: str):
    """The C entry point ``name`` of ``SIGNATURES``, building all
    libraries on the first call."""
    fn = _functions.get(name)
    if fn is None:
        libs = {lib: ctypes.CDLL(str(path))
                for lib, path in build_all().items()}
        for entry, (lib, symbol, argtypes) in SIGNATURES.items():
            f = getattr(libs[lib], symbol)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _functions[entry] = f
        fn = _functions[name]
    return fn
