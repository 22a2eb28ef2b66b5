"""Build the Hopper kernels with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launcher, so it compiles in seconds
without PyTorch's headers.  One ``nvcc`` runs per source, all started
together.  A library is named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt and
an unchanged one is reused.  Nothing is compiled when a
module is imported: the CPU has no ``nvcc`` and never needs one.
:func:`launch_stream` is the launchers' common device check.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"  # listed in .gitignore
KERNELS = ("vaoi_distance", "fedavg_reduce", "ssd_scan", "swa_attention", "conv_lanes", "mla_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): cannot build the CUDA kernels")


def library_path(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = KERNELS, verbose: bool = False) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    per source, all in parallel.  Returns each build's seconds (0.0 where the
    library was already there); raises with ``nvcc``'s output on failure.
    ``verbose`` prints ``ptxas``' register and shared-memory report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    seconds = {name: 0.0 for name in names}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)  # nvcc's output, ptxas' report included
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        if verbose:
            print(f"[build] {name}: {seconds[name]:.2f} s\n{log.strip()}")
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def ptxas_report(name: str) -> List[dict]:
    """Per kernel function of a built library, what ``ptxas -v`` reported:
    registers, spill stores and loads (bytes), static shared memory (bytes)."""
    rows: List[dict] = []
    for line in library_path(name).with_suffix(".log").read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            rows.append({"function": m.group(1)})
        elif rows and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            rows[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif rows and (m := re.search(r"Used (\d+) registers", line)):
            rows[-1]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return rows


def check_tma_layout(name: str, t) -> None:
    """Raise unless TMA can load the bf16 tensor ``t`` (argument ``name``)
    through its strides, as the tensor-core routes do: a contiguous last
    dim, a 16-byte-aligned base, and the other strides multiples of 16
    bytes (a dim of size 1 is never stepped, so its stride is free)."""
    if t.stride(-1) != 1:
        raise ValueError(f"bf16 route (TMA): {name} needs a contiguous last dim; strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"bf16 route (TMA): {name}'s base address must be a multiple of 16 bytes")
    if any(st % 8 for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1):
        raise ValueError(f"bf16 route (TMA): {name}'s strides {t.stride()} must be multiples of 16 bytes")


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def launch_stream(what: str, index: int) -> int:
    """The current stream's handle for a launch of kernel ``what`` on
    tensors that all sit on device ``index`` (``Tensor.get_device()``: -1
    on the CPU; the caller passes any other negative index for tensors on
    more than one device).  Raises unless that is the current CUDA device:
    the wrappers enter no ``torch.cuda.device`` context."""
    import torch

    if index < 0:
        raise ValueError(
            f"the {what} kernel needs its inputs on one CUDA device; kernels.ops.{what} takes CPU tensors"
        )
    current = torch._C._cuda_getDevice()  # a CUDA tensor exists, so CUDA is initialised
    if index != current:
        raise ValueError(f"the {what} kernel needs its inputs on the current CUDA device, cuda:{current}")
    return torch._C._cuda_getCurrentRawStream(index)
