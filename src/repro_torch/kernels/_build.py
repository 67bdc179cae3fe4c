"""Build and load the port's CUDA kernels (plain C interface, ``ctypes``).

At first use every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``,
one process per source started together, and linked into one shared
library under ``build/repro_torch_kernels/<hash>/`` at the root of the
checkout (listed in ``.gitignore``). The directory is keyed by a hash of
the sources and flags, so an edited kernel is rebuilt and an unchanged one
is loaded as it is. ``nvcc``'s output (``-Xptxas -v``: registers, shared
memory and spills of every kernel) is kept in ``build.log`` beside the
library.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0. Pointers and the stream are passed
as ``ctypes.c_void_p``: the stream is ``torch.cuda.current_stream().cuda_stream``.

Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    # x, scale, y, rows, d, eps, x_dtype, scale_dtype, vectorised, stream
    "repro_rmsnorm": [_P, _P, _P, _LL, _I, _F, _I, _I, _I, _P],
    # x, delta, scale, s, y, rows, d, eps, x_dtype, scale_dtype, vectorised,
    # stream
    "repro_rmsnorm_residual": [_P, _P, _P, _P, _P, _LL, _I, _F, _I, _I, _I,
                               _P],
    # y, y row stride, z, z row stride, scale, out, rows, d, eps, x_dtype,
    # scale_dtype, vectorised, stream
    "repro_rmsnorm_gated": [_P, _LL, _P, _LL, _P, _P, _LL, _I, _F, _I, _I,
                            _I, _P],
    # x, scale, dy, ds (or null), dx, dscale, partial, counters, rows, d,
    # eps, x_dtype, scale_dtype, stream
    "repro_rmsnorm_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _F, _I,
                          _I, _P],
    # y, y row stride, z, z row stride, scale, dout, dy, dz, dscale, partial,
    # counters, row_ss (or null), row_dot (or null), rows, d, d_norm, eps,
    # x_dtype, scale_dtype, stream
    "repro_rmsnorm_gated_bwd": [_P, _LL, _P, _LL, _P, _P, _P, _P, _P, _P, _P,
                                _P, _P, _LL, _I, _I, _F, _I, _I, _P],
    # the gated form split over a model tier: y, y row stride, z, z row
    # stride, row_ss out, rows, d, x_dtype, vectorised, stream
    "repro_rmsnorm_gated_rowsq": [_P, _LL, _P, _LL, _P, _LL, _I, _I, _I, _P],
    # y, y row stride, z, z row stride, scale, row_ss, out, rows, d, d_norm,
    # eps, x_dtype, scale_dtype, vectorised, stream
    "repro_rmsnorm_gated_finish": [_P, _LL, _P, _LL, _P, _P, _P, _LL, _I, _I,
                                   _F, _I, _I, _I, _P],
    # y, y row stride, z, z row stride, scale, dout, row_dot out, rows, d,
    # x_dtype, scale_dtype, stream
    "repro_rmsnorm_gated_rowdot": [_P, _LL, _P, _LL, _P, _P, _P, _LL, _I, _I,
                                   _I, _P],
    # the grid of the last repro_rmsnorm_bwd launch, and the rows of the
    # partial buffer that a launch takes
    "repro_rmsnorm_bwd_last_blocks": [],
    "repro_rmsnorm_bwd_partial_rows": [],
    # q, k, v, o, lse (or null), B, S, T, H, KV, D, scale, causal, window,
    # chunk, cap, stream
    "repro_flash_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _F, _I, _I, _I, _F, _P],
    "repro_flash_attention_fp32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _F, _I, _I, _I, _F, _P],
    # q, k, v, o, dout, lse, delta, dq, B, S, T, H, KV, D, scale, causal,
    # window, chunk, cap, dtype, stream
    "repro_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _F, _I, _I, _I, _F, _I, _P],
    # q, k, v, dout, lse, delta, dk, dv, B, S, T, H, KV, D, scale, causal,
    # window, chunk, cap, dtype, stream
    "repro_flash_bwd_dkdv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _F, _I, _I, _I, _F, _I, _P],
    # the tensor-core pair (bf16): the same without the dtype
    "repro_flash_bwd_dq_wgmma": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _F, _I, _I, _I, _F, _P],
    "repro_flash_bwd_dkdv_wgmma": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _I, _F, _I, _I, _I, _F, _P],
    # s, m, v, pos, pos_stride, slot_offset, window, chunk, ring, o, l, B,
    # KV, G, L, D, nsplit, v_dtype, stream
    "repro_decode_stats": [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _P, _P, _I,
                           _I, _I, _I, _I, _I, _I, _P],
    # q, k, pos, pos_stride, slot_offset, s, m, B, KV, G, L, D, nsplit,
    # scale, window, chunk, ring, cap, dtype, stream
    "repro_decode_scores": [_P, _P, _P, _I, _LL, _P, _P, _I, _I, _I, _I, _I,
                            _I, _F, _I, _I, _I, _F, _I, _P],
    # x, out, spill, table, sizes, p, R, W, spill slots, max size,
    # block_bytes, vec, stream
    "repro_dma_allgather": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL,
                            _I, _P],
    # stream: an empty launch
    "repro_empty": [_P],
    # x, dt, A, B, C, y, h, Bt, S, H, G, N, P, dtype, stream
    "repro_ssd": [_P] * 7 + [_I] * 7 + [_P],
    # x, dt, A, B, C, dy, dx, ddt, dA, dB, dC, scratch, Bt, S, H, G, N, P,
    # dtype, stream
    "repro_ssd_bwd": [_P] * 12 + [_I] * 7 + [_P],
    # Bt, S, H, N, P: the bytes of repro_ssd_bwd's scratch
    "repro_ssd_bwd_scratch_bytes": [_I] * 5,
}
# what the functions that do not return an error code return
RESTYPES = {"repro_ssd_bwd_scratch_bytes": ctypes.c_longlong}

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float            # 0.0 when the library was already built
    log: str


_lib: ctypes.CDLL | None = None
_info: BuildInfo | None = None


def dtype_code(dtype) -> int:
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"got {dtype}") from None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _run_all(cmds: list[list[str]]) -> list[tuple[list[str], int, str]]:
    """Start every command at once, wait for all; (cmd, rc, output) each."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    outs = [(c, p.communicate()[0], p) for c, p in procs]
    return [(c, p.returncode, out) for c, out, p in outs]


def build() -> BuildInfo:
    """Compile the kernels unless this exact build exists; never loads."""
    global _info
    if _info is not None:
        return _info
    out_dir = BUILD_ROOT / _key()
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib_path.exists():
        _info = BuildInfo(lib_path, 0.0, log_path.read_text()
                          if log_path.exists() else "")
        return _info
    t0 = time.perf_counter()
    nvcc = _nvcc()
    tmp = out_dir / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        objs = [tmp / (src.stem + ".o") for src in _sources()]
        results = _run_all([[nvcc, *CFLAGS, "-I", str(CSRC), "-c", str(src),
                             "-o", str(obj)]
                            for src, obj in zip(_sources(), objs)])
        log = "".join(f"$ {' '.join(c)}\n{out}" for c, _, out in results)
        failed = [c for c, rc, _ in results if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {[c[-3] for c in failed]}:\n"
                               f"{log}")
        (cmd, rc, out), = _run_all([[nvcc, *ARCH_FLAGS, "-shared",
                                     *map(str, objs), "-o",
                                     str(tmp / LIB_NAME)]])
        log += f"$ {' '.join(cmd)}\n{out}"
        if rc != 0:
            raise RuntimeError(f"linking the kernels failed:\n{log}")
        log_path.write_text(log)
        os.replace(tmp / LIB_NAME, lib_path)   # atomic: readers see all or none
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _info = BuildInfo(lib_path, time.perf_counter() - t0, log)
    return _info


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build().path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        handle.repro_error_string.argtypes = [_I]
        handle.repro_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        what = lib().repro_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{err} ({what})")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a launch."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device} but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
