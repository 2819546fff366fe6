"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` files compile with ``nvcc`` into ONE shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), loaded
with ``ctypes``.  The build happens at the first launch, into
``ir_sgmcmc_tpu_torch/build/`` (git-ignored), keyed by a hash of the
sources; a failed build raises.  Nothing here runs at import time, so the
package imports on hosts without CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every entry returns cudaGetLastError() after its launches
_SIGNATURES = {
    "split_warp_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "split_warp_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "split_warp_fwd_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "split_warp_bwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "split_warp_fwd_zhalo": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "split_warp_bwd_zhalo": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "split_warp_fwd_zhalo_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "split_warp_bwd_zhalo_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "block_warp_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "block_warp_dgrad": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "block_warp_fwd_zhalo": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "block_warp_dgrad_zhalo": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "warp_bounded_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "warp_bounded_dgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "warp_bounded_tblend": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "warp_bounded_tblend_zpad": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "warp_bounded_fwd_zhalo": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "warp_bounded_dgrad_zhalo": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "taylor_square_fwd": [_P, _P, _I, _I, _I, _I, _P],
    "taylor_square_bwd": [_P, _P, _P, _I, _I, _I, _I, _P],
    "lcn_residual_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "lcn_residual_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lib = None
build_seconds = None  # wall time of the build in this process (None: not built)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{CSRC} at first use and need the CUDA toolkit")


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libir_sgmcmc_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not so.exists():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (BUILD_DIR / "nvcc.log").write_text(" ".join(cmd) + "\n" + proc.stdout
                                            + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, so)  # atomic: a concurrent process never loads a torn file
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def build_variants(kernel: str, probe_src: str, variants: dict) -> tuple:
    """Build, in parallel, one library per variant for the chip probes:
    ``probe_src`` (which ``#include``\\ s ``kernel``, a file of ``csrc/``)
    over a copy of ``kernel`` whose lines ``constexpr int NAME = <v>;`` take
    the variant's ``{NAME: value}``.  Returns ``{variant: CDLL}`` and
    ``{variant: nvcc log}``; raises if a constant is not declared or a
    build fails."""
    src = (CSRC / kernel).read_text()
    procs = {}
    for name, consts in variants.items():
        work = BUILD_DIR / f"probe_{Path(kernel).stem}_{name}"
        work.mkdir(parents=True, exist_ok=True)
        text = src
        for const, value in consts.items():
            decl = re.search(rf"constexpr int {const} = (\d+);", text)
            if decl is None:
                raise RuntimeError(f"{kernel} no longer declares constexpr int {const}")
            text = text.replace(decl.group(0), f"constexpr int {const} = {value};")
        (work / kernel).write_text(text)
        (work / "probe.cu").write_text(probe_src)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(work), "-I", str(CSRC), "-o",
               str(work / "libprobe.so"), str(work / "probe.cu")]
        procs[name] = (work, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (work, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        (work / "nvcc.log").write_text(logs[name])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for probe variant {name}:\n{logs[name][-4000:]}")
        libs[name] = ctypes.CDLL(str(work / "libprobe.so"))
    return libs, logs


def ptxas_summary(log: str) -> list:
    """``name<template args>: N registers, S bytes spill stores`` for each
    kernel of an ``nvcc -Xptxas -v`` log (integer, float and bf16 template
    arguments)."""
    rows, name, spill = [], None, "?"
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function .*?\d+([a-z][a-z_]*_kernel)"
                          r"(I(?:L[ib]\d+E|f|13__nv_bfloat16)+E)?", ln)
        if entry:
            args = [a.group(1) or ("float" if a.group(2) else "bf16") for a in
                    re.finditer(r"L[ib](\d+)E|(f)|13__nv_bfloat16", entry.group(2) or "")]
            name = entry.group(1) + (f"<{', '.join(args)}>" if args else "")
        elif name and "spill stores" in ln:
            spill = re.search(r"(\d+) bytes spill stores", ln).group(1)
        elif name and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            rows.append(f"{name}: {regs} registers, {spill} bytes spill stores")
            name, spill = None, "?"
    return rows


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM bandwidth, and the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


class Kernel:
    """One CUDA entry point of the library, with its launch count and the
    least work its function needs.

    ``launches`` goes up by one each time :meth:`launch` starts the kernel
    (one call of the C entry, which may issue several grid launches); no
    other code touches it.

    ``bytes_per_voxel(C)`` and ``flops_per_voxel(C)`` give, per voxel of
    the main operand ``(B, C, D, H, W)``, the bytes the function must move
    (each input read once, each output written once) and the f32
    operations it must do (counted from its formula: the non-zero taps
    only, clamps and selects not counted).  A ``z_halo`` kernel also
    moves ``2 * radius`` planes beyond its output's ``shape`` (a z-haloed
    operand, or B7Z's pad planes): :meth:`bytes` adds those planes at
    ``z_halo(C)`` bytes per voxel of a plane, or ``4·C`` (``C`` f32 words)
    where ``z_halo`` is ``True``.
    """

    def __init__(self, symbol: str, source: str, replaces: str, bytes_per_voxel,
                 flops_per_voxel, z_halo=False):
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.bytes_per_voxel = bytes_per_voxel
        self.flops_per_voxel = flops_per_voxel
        self.halo_bytes = (lambda C: 4 * C) if z_halo is True else (z_halo or None)
        self.z_halo = self.halo_bytes is not None
        self.launches = 0

    def _voxels(self, shape) -> tuple[int, int]:
        B, C, D, H, W = shape
        return B * D * H * W, C

    def bytes(self, shape, radius: int = 0) -> int:
        """Bytes the function must move at main-operand shape ``shape`` (and,
        for a z-halo kernel, radius ``radius``)."""
        n, C = self._voxels(shape)
        halo = 0
        if self.z_halo:
            B, C, D, H, W = shape
            halo = round(B * 2 * int(radius) * H * W * self.halo_bytes(C))
        return round(n * self.bytes_per_voxel(C)) + halo

    def flops(self, shape) -> int:
        n, C = self._voxels(shape)
        return round(n * self.flops_per_voxel(C))

    def bound_ms(self, shape, radius: int = 0) -> tuple[float, str]:
        """The least time an H100 SXM could take, and what bounds it:
        ``("bytes" | "operations")``, the larger of bytes over HBM bandwidth
        and operations over the f32 rate."""
        by_bytes = 1e3 * self.bytes(shape, radius) / HBM_BYTES_PER_S
        by_ops = 1e3 * self.flops(shape) / F32_FLOP_PER_S
        return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")

    def launch(self, device: torch.device, *args) -> None:
        fn = getattr(load_library(), self.symbol)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.symbol} failed to launch: "
                               f"cudaError {err}")
        self.launches += 1


def check_operand(name: str, t: torch.Tensor, shape, dtype=torch.float32,
                  device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape``/``dtype``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
