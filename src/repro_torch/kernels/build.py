"""Build the CUDA sources under ``csrc/`` with nvcc and load them by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library ``build/lib<name>-<hash>.so`` at the root of the checkout, the hash
covering the sources and flags, so a changed source is rebuilt. Building
happens at first use (or all at once, in parallel, through ``build_all``),
never at import. A failed build raises: there is no fallback. Kernels 1 and
2 are cut into several sources (by storage type and T) so that their
instantiations build in parallel.

``check_t`` is the coded kernels' refusal of a code width they have no
case for (T outside 2..16): a ``ValueError`` naming T, raised before any
build or launch. Within it, the codes of the serving paths have tuned
instantiations and every other code takes a generic one (T and r runtime
values); wider codes would need more threads and registers than one block
has.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("cdc_coded_matmul", "cdc_coded_matmul_bf16", "cdc_coded_matmul_t16",
           "cdc_coded_matmul_any", "cdc_coded_matmul_any_bf16",
           "cdc_fused_head", "cdc_fused_head_bf16", "cdc_fused_head_any",
           "cdc_encode", "cdc_decode_merge", "cdc_decode", "rmsnorm",
           "rmsnorm_bwd", "matmul", "tma_probe")
# the code widths T the coded kernels (1-5) take (csrc/scalar.cuh: MAX_T)
KERNEL_T = tuple(range(2, 17))
# devices whose tensors take a kernel's plain version: the CPU, and the meta
# device (shapes only: no launch, no host sync; the dry run's tensors)
PLAIN_DEVICES = ("cpu", "meta")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_loaded: dict[str, ctypes.CDLL] = {}
_occ: dict[tuple, int] = {}       # resident blocks per SM per instantiation
_may_build = True                 # False in a rank of a world: load only


def nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    path = str(cand) if cand.exists() else shutil.which("nvcc")
    if not path:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH); the CUDA "
                           "kernels cannot be built")
    return path


def lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every named source that is not built yet, one nvcc process
    per source, all started together. Returns {name: {"seconds", "ptxas"}}
    for the sources compiled by this call; raises on any failure."""
    BUILD.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        tmp.replace(out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def bf16_flag(dtype: torch.dtype, who: str) -> int:
    """The C interfaces' storage-type argument: 0 for float32, 1 for
    bfloat16; any other dtype is refused."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{who}: dtype {dtype} is neither float32 nor "
                         f"bfloat16")
    return int(dtype == torch.bfloat16)


def refuse_grad(who: str, *tensors) -> None:
    """A kernel with no backward refuses an input that autograd would
    differentiate: its output, written by the kernel into a fresh tensor,
    has no history, and returning it would cut the gradient silently."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{who}: an input requires grad, and the kernel "
                           f"has no backward; call it under torch.no_grad()")


def check_t(who: str, T: int) -> None:
    """Refuse a code width T that the kernel has no case for."""
    if T not in KERNEL_T:
        raise ValueError(f"{who}: no kernel case for T={T}; the kernel is "
                         f"built for T in {KERNEL_T[0]}..{KERNEL_T[-1]}")


def check_r(who: str, T: int, r: int) -> None:
    """Refuse a code width T, or a parity count r outside 1..T, that the
    kernel has no case for."""
    check_t(who, T)
    if not 1 <= r <= T:
        raise ValueError(f"{who}: no kernel case for T={T}, r={r}; r runs "
                         f"1..{T} at T={T}")


def elem_bytes(dtype: torch.dtype) -> int:
    """Bytes of one stored element: 4 for float32, 2 for bfloat16."""
    return 2 if dtype == torch.bfloat16 else 4


def raw_stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device`` (what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def occupancy(name: str, query: str, *args: int) -> int:
    """Resident blocks per SM of one kernel instantiation, from the C
    function ``query`` of ``csrc/<name>.cu`` (its
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, or minus a
    cudaError_t), asked once per instantiation and process."""
    key = (name, query) + args
    occ = _occ.get(key)
    if occ is None:
        fn = getattr(load(name), query)
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = ctypes.c_int
        occ = fn(*args)
        if occ <= 0:
            raise RuntimeError(f"{query}{args} failed: "
                               f"{-occ if occ < 0 else 'no resident block'}")
        _occ[key] = occ
    return occ


def forbid_builds() -> None:
    """Load only what is built: in a process that calls this (a rank of a
    ``dist.spawn_world`` world), ``load`` of a library that is not under
    ``build/`` raises instead of compiling it, so the ranks of a world
    never race to build one. Build first (``build_all``) in the process
    that starts the world."""
    global _may_build
    _may_build = False


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed
    (unless ``forbid_builds``)."""
    lib = _loaded.get(name)
    if lib is None:
        if not _may_build and not lib_path(name).exists():
            raise RuntimeError(f"{lib_path(name).name} is not built, and "
                               f"this process only loads: build_all() "
                               f"before the world starts")
        build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
