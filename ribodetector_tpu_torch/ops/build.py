"""Build-at-first-use for the port's native code.

Shared libraries with a plain C interface, loaded with ctypes:

- ``csrc/bilstm.cu``: the BiLSTM's CUDA kernels, compiled with nvcc for
  sm_90a (Hopper);
- ``csrc/caduceus_scan.cu``: the Caduceus mixer's kernels, built and loaded
  only where a Caduceus runs on the card (a BiLSTM run never builds it);
- ``native/fastx.cpp``: the FASTQ/FASTA parser, compiled with g++.

Each build lands in ``_build/`` (ignored by git) under a name keyed by a
hash of its source and command, so an edited source rebuilds and an
unchanged one loads at once. Builds are race-safe: every process compiles to
its own tmp file and moves it into place with ``os.replace``. A failed build
raises with the compiler's output; nothing falls back.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
FASTX_SRC = os.path.join(PKG_DIR, "native", "fastx.cpp")
KERNEL_SRC = os.path.join(CSRC_DIR, "bilstm.cu")
CADUCEUS_SRC = os.path.join(CSRC_DIR, "caduceus_scan.cu")

# no --use_fast_math: the exact kernel relies on IEEE expf/tanhf
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_kernels = None
_caduceus = None


def nvcc_path():
    """nvcc from $CUDA_HOME, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.exists(cand):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def build_key(src, compiler, flags):
    """The content hash a build is keyed on: the source's bytes, the
    compiler's name and the flags."""
    with open(src, "rb") as fh:
        key = hashlib.sha256(fh.read())
    key.update(" ".join([os.path.basename(compiler), *flags]).encode())
    return key.hexdigest()[:16]


def kernel_library_key():
    """build_key of the CUDA kernel library (needs no nvcc): what the
    library that build_kernels loads was built from."""
    return build_key(KERNEL_SRC, "nvcc", NVCC_FLAGS)


def build_shared(src, compiler, flags, stem):
    """Compile `src` into _build/<stem>-<build_key>.so unless that file
    exists. Returns (path, compiler log). The log (ptxas register and spill
    report for nvcc) is kept beside the library as <path>.log."""
    out = os.path.join(BUILD_DIR, f"{stem}-{build_key(src, compiler, flags)}.so")
    log_path = out + ".log"
    if os.path.exists(out):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as fh:
                log = fh.read()
        return out, log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        proc = subprocess.run(
            [compiler, *flags, src, "-o", tmp], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {os.path.basename(src)} failed "
                f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        log = proc.stdout + proc.stderr
        with open(f"{log_path}.tmp.{os.getpid()}", "w") as fh:
            fh.write(log)
        os.replace(f"{log_path}.tmp.{os.getpid()}", log_path)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, log


def build_kernels():
    """Compile csrc/bilstm.cu with nvcc; returns (path, ptxas log)."""
    return build_shared(KERNEL_SRC, nvcc_path(), NVCC_FLAGS, "bilstm")


def build_fastx():
    """Compile native/fastx.cpp with g++; returns (path, log)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native parser cannot be built")
    return build_shared(FASTX_SRC, gxx, GXX_FLAGS, "fastx")


def kernel_library():
    """The loaded CUDA kernel library (built on first use), with argtypes."""
    global _kernels
    with _lock:
        if _kernels is None:
            path, _ = build_kernels()
            lib = ctypes.CDLL(path)
            # every array is a device pointer (W_hh goes in as bf16: exact's
            # three limbs in one [3, 2, G, H], high's two [2, G, H], fast's
            # one [2, G, H])
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            for name in ("rd_bilstm_exact", "rd_bilstm_fast", "rd_bilstm_fast_bf16"):
                getattr(lib, name).restype = i32
                getattr(lib, name).argtypes = [vp] * 7 + [i32, i32, i32, vp]
            lib.rd_bilstm_high.restype = i32
            lib.rd_bilstm_high.argtypes = [vp] * 8 + [i32, i32, i32, vp]
            lib.rd_max_active_clusters.restype = i32
            lib.rd_max_active_clusters.argtypes = [i32, ctypes.POINTER(i32)]
            lib.rd_cuda_error_string.restype = ctypes.c_char_p
            lib.rd_cuda_error_string.argtypes = [i32]
            _kernels = lib
        return _kernels


def caduceus_library_key():
    """build_key of the Caduceus kernel library (needs no nvcc)."""
    return build_key(CADUCEUS_SRC, "nvcc", NVCC_FLAGS)


def caduceus_library():
    """The loaded Caduceus kernel library (built on first use), with
    argtypes: every array a device pointer, then the sizes and the
    stream."""
    global _caduceus
    with _lock:
        if _caduceus is None:
            path, _ = build_shared(CADUCEUS_SRC, nvcc_path(), NVCC_FLAGS, "caduceus_scan")
            lib = ctypes.CDLL(path)
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.rd_cad_conv.restype = i32
            lib.rd_cad_conv.argtypes = [vp] * 5 + [i32] * 3 + [vp]
            lib.rd_cad_scan.restype = i32
            lib.rd_cad_scan.argtypes = [vp] * 11 + [i32] * 5 + [vp]
            lib.rd_cad_scan_check.restype = i32
            lib.rd_cad_scan_check.argtypes = [vp, vp]
            lib.rd_cad_scan_info.restype = i32
            lib.rd_cad_scan_info.argtypes = [ctypes.POINTER(i32)]
            lib.rd_cad_add_norm.restype = i32
            lib.rd_cad_add_norm.argtypes = [vp] * 4 + [ctypes.c_longlong, i32, i32,
                                                       ctypes.c_float, vp]
            lib.rd_cad_error_string.restype = ctypes.c_char_p
            lib.rd_cad_error_string.argtypes = [i32]
            _caduceus = lib
        return _caduceus
