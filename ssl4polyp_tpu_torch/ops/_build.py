"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` source (with the ``csrc/*.cuh`` headers they include)
compiles, at first use, one nvcc process per source and all at once, into
one shared library with a plain C interface::

    build/ssl4polyp_tpu_torch/<sha256 of the sources and flags>/libkernels.so

under the checkout's root (``build/`` is git-ignored).  A library whose
hash matches is loaded as it is.  Nothing here runs at import time, so the
CPU tests import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["library", "library_path"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "ssl4polyp_tpu_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# (name, restype, argtypes) of every C entry point in csrc/.
_ENTRY_POINTS = (
    ("ssl4polyp_qkv_attention_fwd", ctypes.c_int,
     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_qkv_attention_bwd", ctypes.c_int,
     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
     + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_qkv_attention_bwd_probe", ctypes.c_int,
     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
     + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_qkv_attention_bwd_mode", ctypes.c_int,
     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
     + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    ("ssl4polyp_qkv_attention_bwd_plan", ctypes.c_int,
     [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2),
    ("ssl4polyp_qkv_attention_tiles_fwd_probe", ctypes.c_int,
     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
     + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_qkv_attention_tiles_bwd", ctypes.c_int,
     [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
     + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
    ("ssl4polyp_qkv_attention_fwd_f32", ctypes.c_int,
     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]),
    ("ssl4polyp_qkv_attention_bwd_f32", ctypes.c_int,
     [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
     + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_fc1_gelu_fwd", ctypes.c_int,
     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    ("ssl4polyp_fc1_gelu_fwd_f32", ctypes.c_int,
     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    ("ssl4polyp_layernorm_fwd", ctypes.c_int,
     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]),
    ("ssl4polyp_layernorm_fwd_f32", ctypes.c_int,
     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]),
    ("ssl4polyp_layernorm_bwd", ctypes.c_int,
     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_layernorm_bwd_f32", ctypes.c_int,
     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_layernorm_bwd_blocks", ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
    ("ssl4polyp_layernorm_bwd_blocks_f32", ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
    ("ssl4polyp_mlp_fused_fwd", ctypes.c_int,
     [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]),
    ("ssl4polyp_mlp_fused_probe", ctypes.c_int,
     [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_mlp_fused_fwd_f32", ctypes.c_int,
     [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]),
    ("ssl4polyp_ln_linear_fwd_f32", ctypes.c_int,
     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]),
    ("ssl4polyp_ln_linear_fwd", ctypes.c_int,
     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]),
    ("ssl4polyp_ln_linear_probe", ctypes.c_int,
     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_attn_proj_fwd", ctypes.c_int,
     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
     + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_attn_proj_bwd", ctypes.c_int,
     [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
     + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
    ("ssl4polyp_attn_proj_fwd_f32", ctypes.c_int,
     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]),
    ("ssl4polyp_attn_proj_bwd_f32", ctypes.c_int,
     [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
     + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_sgemm_f32_slices", ctypes.c_int, [ctypes.c_int] * 3),
    ("ssl4polyp_matmul_nt", ctypes.c_int,
     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    ("ssl4polyp_matmul_nt_bias", ctypes.c_int,
     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    ("ssl4polyp_attention_fwd", ctypes.c_int,
     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]),
    ("ssl4polyp_attention_fwd_probe", ctypes.c_int,
     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_attention_bwd", ctypes.c_int,
     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]),
    ("ssl4polyp_attention_bwd_probe", ctypes.c_int,
     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_attention_tiles_fwd", ctypes.c_int,
     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]),
    ("ssl4polyp_attention_tiles_bwd", ctypes.c_int,
     [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]),
    ("ssl4polyp_attention_tiles_bwd_plan", ctypes.c_int,
     [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3),
    ("ssl4polyp_attention_fwd_f32", ctypes.c_int,
     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]),
    ("ssl4polyp_attention_bwd_f32", ctypes.c_int,
     [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_qkvproj_attention_fwd", ctypes.c_int,
     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_qkvproj_attention_fwd_probe", ctypes.c_int,
     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
     + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_qkvproj_attention_bwd", ctypes.c_int,
     [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
     + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_qkvproj_attention_bwd_probe", ctypes.c_int,
     [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
     + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    ("ssl4polyp_qkvproj_attention_fwd_f32", ctypes.c_int,
     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]),
    ("ssl4polyp_qkvproj_attention_bwd_f32", ctypes.c_int,
     [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
     + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_dw_product", ctypes.c_int,
     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    ("ssl4polyp_dw_product_slices", ctypes.c_int, [ctypes.c_int] * 3),
    ("ssl4polyp_adamw_step", ctypes.c_int, [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]),
    ("ssl4polyp_adamw_layout", ctypes.c_int, [ctypes.c_int]),
)

_library: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for source in sorted([*_sources(), *_CSRC.glob("*.cuh")]):
        digest.update(source.name.encode())
        digest.update(source.read_bytes())
    return _BUILD_ROOT / digest.hexdigest()[:16] / "libkernels.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: "
                       "the CUDA kernels cannot be built")


def _build(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f".{os.getpid()}.tmp"
    objects = [target.parent / f"{source.stem}{tag}.o" for source in _sources()]
    compiles = [
        subprocess.Popen([nvcc, *_FLAGS, "-c", "-o", str(obj), str(source)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for source, obj in zip(_sources(), objects)
    ]
    # ptxas -v reports registers, shared memory and spills per kernel.
    logs = [f"== {source.name}\n{process.communicate()[0]}"
            for source, process in zip(_sources(), compiles)]
    partial = target.with_suffix(f"{tag}.so")
    failed = [source.name for source, process in zip(_sources(), compiles) if process.returncode]
    if not failed:
        link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(partial), *map(str, objects)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode:
            failed = ["link"]
    (target.parent / "nvcc.log").write_text("\n".join(logs))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        partial.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {failed} ({' '.join(_FLAGS)}):\n" + "\n".join(logs))
    os.replace(partial, target)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _library
    if _library is None:
        target = library_path()
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        for name, restype, argtypes in _ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _library = lib
    return _library
