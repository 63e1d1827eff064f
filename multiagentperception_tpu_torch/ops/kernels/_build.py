"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled alone by
``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so`` under the
package (a directory ``.gitignore`` lists). The hash covers the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or header
is rebuilt and an unchanged one is loaded. A debug build (``VARIANTS``)
compiles a source with extra flags under a name of its own and binds the
source's entry points; ``build()`` builds it only when it is named.
Nothing here runs at import time: this module is imported on hosts that
have no ``nvcc``.

Pointers and the stream cross the C boundary as ``ctypes.c_void_p`` (a
plain ``int`` argument would be cut to 32 bits).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float

_K1_ARGS = [P, I32, I32, I32, I32, P, P, P, P, I32, I32, I32, I32, P, P]
_K2_ARGS = [P, P, P, P, P, P, I32, I32, I32, I64, I32, F32, F32, P]
_K4_QUANTIZE_ARGS = [P, P, I32, I32, I32, I32, P, P]
_K4_ARGS = [P, P, P, P, P, P] + [I32] * 22 + [P]
# C entry points and their signatures, per kernel source
SIGNATURES = {
    "upsample_argmax": {"upsample_argmax_f32": _K1_ARGS, "upsample_argmax_bf16": _K1_ARGS,
                        "upsample_argmax_f16": _K1_ARGS},
    "comm_fusion": {"comm_fusion_f32": _K2_ARGS, "comm_fusion_bf16": _K2_ARGS,
                    "comm_fusion_f16": _K2_ARGS, "comm_fusion_wide_overlap": [I32]},
    "fused_block_wgmma": {"fused_basic_block_wgmma": [P, P, P, P, I32, I32, I32, I32, P]},
    "fused_block_tf32": {"fused_basic_block_tf32x3": [P, P, P, P, I32, I32, I32, I32, P]},
    "fused_block_wgmma_conv": {"fused_basic_block_wgmma_conv":
                               [P, P, P, P, P, P, P, I32, I32, I32, I32, P]},
    "fused_block_tf32_conv": {"fused_basic_block_tf32x3_conv":
                              [P, P, P, P, P, P, P, I32, I32, I32, I32, P]},
    "int8_conv": {"int8_quantize_f32": _K4_QUANTIZE_ARGS, "int8_quantize_bf16": _K4_QUANTIZE_ARGS,
                  "int8_quantize_f16": _K4_QUANTIZE_ARGS,
                  "int8_quantize_s2d_f32": _K4_QUANTIZE_ARGS,
                  "int8_quantize_s2d_bf16": _K4_QUANTIZE_ARGS,
                  "int8_quantize_s2d_f16": _K4_QUANTIZE_ARGS,
                  "int8_conv_f32": _K4_ARGS, "int8_conv_bf16": _K4_ARGS,
                  "int8_conv_f16": _K4_ARGS, "int8_conv_s32": _K4_ARGS},
}

# debug builds: name -> (source, extra nvcc flags). int8_conv_lag: K4 with
# warp 1 of each consumer warpgroup held ~200k cycles after each epilogue
VARIANTS = {"int8_conv_lag": ("int8_conv", ("-DINT8_CONV_LAG_CYCLES=200000",))}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels are built from csrc/ at first use")


def _source(name: str) -> tuple[str, tuple[str, ...]]:
    """(source name, nvcc flags) of kernel ``name``."""
    source, extra = VARIANTS.get(name, (name, ()))
    return source, NVCC_FLAGS + extra


def _target(name: str) -> Path:
    source, flags = _source(name)
    src = (CSRC / f"{source}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str, target: Path) -> tuple[subprocess.Popen, Path]:
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    source, flags = _source(name)
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{source}.cu")]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def build(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every named kernel that is not built yet, all ``nvcc`` runs at
    once. Returns each kernel's compiler output (``-Xptxas -v`` resource
    lines), empty for a kernel that was already built. Raises on a failure."""
    running = {}
    for name in names:
        target = _target(name)
        if not target.exists():
            running[name] = (*_start(name, target), target)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, target) in running.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The bound library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)))
        for fn_name, argtypes in SIGNATURES[_source(name)[0]].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib
