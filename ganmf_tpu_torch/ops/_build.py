"""Builds the port's CUDA sources into one shared library at first use.

Every ``ganmf_tpu_torch/csrc/*.cu`` file is compiled by its own ``nvcc``
for Hopper (``sm_90a``), all at once, and the objects are linked into one
library with a plain C interface, loaded with ``ctypes``.
ptxas reports each kernel's registers, shared memory and spills
(``-Xptxas -v``); the report is kept beside the library (``ptxas_report``).
The library lands in ``build/ganmf_tpu_torch/`` at the root of the checkout,
named by a hash of the sources and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. Nothing here runs at import
time. A load is the ``kernels.load`` span; each build by nvcc counts
``kernels.nvcc_builds`` (utils/profiling.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

from ganmf_tpu_torch.utils.profiling import count, span

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ganmf_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB = None


def _nvcc() -> str:
    # PyTorch's own search: $CUDA_HOME, $CUDA_PATH, nvcc on PATH, the default prefix
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else ""
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs, headers


def library_path() -> Path:
    """Where the library for the current sources lives, built or not."""
    srcs, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + headers:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libganmf_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands side by side; raise with the output of the first
    that fails, else return their outputs."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
    return outs


def ptxas_report() -> str:
    """What ptxas said about each kernel of the built library (registers,
    shared memory, spills)."""
    return library_path().with_suffix(".ptxas.txt").read_text()


def build() -> Path:
    """Compile the sources unless a library for them exists; return its
    path. Raises with nvcc's output when a compile fails."""
    out = library_path()
    if out.exists():
        return out
    count("kernels.nvcc_builds")
    srcs, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in srcs]
        outs = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                     for src, obj in zip(srcs, objs)])
        out.with_suffix(".ptxas.txt").write_text("".join(outs))
        lib = os.path.join(tmp, out.name)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)  # atomic: a concurrent loader never sees half a file
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, with every entry point's C signature set."""
    global _LIB
    if _LIB is None:
        with span("kernels.load"):
            lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ganmf_masked_topk.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        lib.ganmf_masked_topk.restype = i32
        lib.ganmf_masked_topk_smem_bytes.argtypes = []
        lib.ganmf_masked_topk_smem_bytes.restype = i32
        lib.ganmf_masked_topk_blocks_per_sm.argtypes = []
        lib.ganmf_masked_topk_blocks_per_sm.restype = i32
        lib.ganmf_masked_topk_wide.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        lib.ganmf_masked_topk_wide.restype = i32
        lib.ganmf_smallest_k_mask.argtypes = [ptr, ptr, i32, ptr, i32, i32, ptr]
        lib.ganmf_smallest_k_mask.restype = i32
        lib.ganmf_smallest_k_mask_blocks_per_sm.argtypes = [i32]
        lib.ganmf_smallest_k_mask_blocks_per_sm.restype = i32
        u32 = ctypes.c_uint
        lib.ganmf_keyed_uniforms.argtypes = [ptr, i32, i32, u32, u32, u32, u32, ptr, ptr]
        lib.ganmf_keyed_uniforms.restype = i32
        lib.ganmf_block_metrics.argtypes = [ptr, ptr, i32, i32] + [ptr] * 10 + [i32, ptr, i32] + [ptr] * 5
        lib.ganmf_block_metrics.restype = i32
        for name in ("ganmf_block_metrics_rows", "ganmf_block_metrics_max_cutoffs"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        lib.ganmf_cuda_error_string.argtypes = [i32]
        lib.ganmf_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.ganmf_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def on_device(device):
    """A guard that makes the CUDA ``device`` current for a launch; none when
    it is current already (the usual case), which saves the host a device
    switch."""
    import torch

    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_handle(device) -> int:
    """The raw handle of the CUDA ``device``'s current stream (what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without making
    a Stream object on every launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)
