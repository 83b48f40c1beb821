"""Builds the CUDA C++ kernels under ``csrc/`` and loads them with ctypes.

One shared library per ``*.cu`` source, compiled by ``nvcc`` for
``sm_90a`` with a plain C interface (no PyTorch headers, so a build takes
seconds).  The libraries link only the CUDA runtime: the attention kernels'
TMA tensor maps are encoded by the CUDA driver's ``cuTensorMapEncodeTiled``,
which they look up at run time through ``cudaGetDriverEntryPoint``.
Nothing happens at import: the first call of a kernel's wrapper asks
:func:`load` for its library, which compiles it if the build directory holds
no library for the current sources.  :func:`build_all` starts one
``nvcc`` per source at once, for callers that want every kernel up front.

The build directory is ``diffbinaural_tpu_torch/build/`` (git-ignored); a
library's file name carries a hash of its source, the shared headers and the
generated tap table, so an edited source is rebuilt and a stale library is
never loaded.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"

# kernel name -> (source file, {C function: argtypes})
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNELS = {
    "flash_d32": (
        "flash_d32.cu",
        {
            # q, k, v, o, BH, N, scale, stream (bfloat16)
            "flash_d32_forward": [_P, _P, _P, _P, _I, _I, _F, _P],
            # q, k, v, o, lse, BH, N, scale, stream
            "flash_d32_forward_lse": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
        },
    ),
    "flash_d32_bwd": (
        "flash_d32_bwd.cu",
        # q, k, v, o, do, lse, di (scratch), dq, dk, dv, BH, N, scale, stream
        # (bfloat16)
        {"flash_d32_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _F, _P]},
    ),
    "flash_d32_f32": (
        "flash_d32_f32.cu",
        {
            # q, k, v, o, scratch, BH, N, scale, stream (float32)
            "flash_d32_f32_forward": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
            # q, k, v, o, lse, scratch, BH, N, scale, stream
            "flash_d32_f32_forward_lse": [_P, _P, _P, _P, _P, _P, _I, _I, _F,
                                          _P],
        },
    ),
    "flash_d32_f32_bwd": (
        "flash_d32_f32_bwd.cu",
        {
            # q, k, v, o, do, lse, di (scratch), scratch, dq, dk, dv, BH, N,
            # scale, stream (float32)
            "flash_d32_f32_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _I, _I, _F, _P],
        },
    ),
    "alias_free_act": (
        "alias_free_act.cu",
        # x, alpha, inv_beta, out, B, C, T, is_bf16, stream
        {"afa_snake_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _P]},
    ),
    "alias_free_act_bwd": (
        "alias_free_act_bwd.cu",
        # x, dz, alpha, inv_beta, dx, da_part, db_part, B, C, T, n_pieces,
        # is_bf16, stream
        {"afa_snake_backward": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _P]},
    ),
    "snake_conv": (
        "snake_conv.cu",
        # x, alpha, inv_beta, w (the blocked layout of
        # snake_conv.py:blocked_weight), bias, out, B, C, T, k, dilation,
        # stream (bfloat16)
        {"snake_conv_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _P],
         # dy, w (blocked_weight of the flipped, transposed kernel), dz, B,
         # C, T, k, dilation, stream
         "snake_conv_dgrad": [_P, _P, _P, _I, _I, _I, _I, _I, _P]},
    ),
    "snake_conv_f32": (
        "snake_conv_f32.cu",
        # x, alpha, inv_beta, w ((C, C, k)), w_split (scratch), bias, out, B,
        # C, T, k, dilation, stream (float32)
        {"snake_conv_f32_forward": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _P]},
    ),
    "snake_conv_wgrad": (
        "snake_conv_wgrad.cu",
        # z, zt (scratch: z transposed and padded), dy, part, B, C, T, k,
        # dilation, n_split, stream
        {"snake_conv_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
    ),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    exe = os.path.join(home, "bin", "nvcc")
    if os.path.exists(exe):
        return exe
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled at first use and "
        "need the CUDA toolkit (PATH or CUDA_HOME)"
    )


def _taps_header() -> str:
    """``afa_taps.h``: the 12 kaiser-sinc taps of the 2x resamplers as float
    literals, from the port's own filter design."""
    from ..signal.filters import kaiser_sinc_filter1d

    h = kaiser_sinc_filter1d(0.25, 0.3, 12)
    lines = ["// generated by ops/_build.py — kaiser_sinc_filter1d(0.25, 0.3, 12)"]
    lines += [f"#define AFA_H{i} ({float(v)!r}f)" for i, v in enumerate(h)]
    return "\n".join(lines) + "\n"


def write_taps_header() -> str:
    """Write ``afa_taps.h`` into the build directory, where every kernel's
    compile finds it; returns its text."""
    taps = _taps_header()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    (BUILD_DIR / "afa_taps.h").write_text(taps)
    return taps


def _target(name: str) -> tuple[Path, Path, str]:
    """(source path, library path, tap header text) for one kernel."""
    src = CSRC / KERNELS[name][0]
    taps = _taps_header()
    digest = hashlib.sha256()
    digest.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(taps.encode())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"
    return src, lib, taps


def _start(name: str, verbose: bool = False):
    """Start nvcc for one kernel; returns (Popen or None, library path)."""
    src, lib, _ = _target(name)
    if lib.exists():
        return None, lib
    write_taps_header()
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(BUILD_DIR), "-I", str(CSRC)]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc._tmp = tmp  # moved into place once the compile has succeeded
    return proc, lib


def _finish(name: str, proc, lib: Path) -> str:
    if proc is None:
        return ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        proc._tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (rc={proc.returncode}):\n{out}")
    os.replace(proc._tmp, lib)
    return out


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every kernel that is not built yet, all ``nvcc`` processes
    started together.  Returns each kernel's compiler output."""
    started = {name: _start(name, verbose) for name in KERNELS}
    return {name: _finish(name, proc, lib)
            for name, (proc, lib) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if need be."""
    if name not in _loaded:
        proc, lib = _start(name)
        _finish(name, proc, lib)
        _loaded[name] = bind(ctypes.CDLL(str(lib)), name)
    return _loaded[name]


@contextlib.contextmanager
def in_place(names, cdll: ctypes.CDLL):
    """Inside, the wrappers of kernel library ``names`` (one name or several)
    launch ``cdll``'s kernels: a variant or an earlier design built from
    another source that exports the same functions.  What was loaded before
    is put back after."""
    names = [names] if isinstance(names, str) else list(names)
    saved = {name: _loaded.get(name) for name in names}
    try:
        for name in names:
            _loaded[name] = cdll
        yield
    finally:
        for name, before in saved.items():
            if before is None:
                _loaded.pop(name, None)
            else:
                _loaded[name] = before


def bind(cdll: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Set the argument and result types of kernel ``name``'s C functions
    on a loaded library (the shipped one, or a variant built from another
    source that exports the same functions)."""
    for fn, argtypes in KERNELS[name][1].items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = ctypes.c_int
    return cdll


def check_launch(name: str, code: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {code}")
