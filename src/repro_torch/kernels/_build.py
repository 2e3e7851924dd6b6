"""Build the CUDA kernels from ``csrc/`` and load them through ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/repro_torch/lib<name>-<hash>.so`` at the root of the checkout (a
directory ``.gitignore`` lists); the hash covers the source, the
``csrc/*.cuh`` headers it includes (directly or through another header)
and the flags, so an edited source or header rebuilds.  Nothing runs at import: :func:`load` builds
on first use, and :func:`build` starts one ``nvcc`` per source, all at once.
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
from typing import Dict, Iterable, Optional, Tuple, Union

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("wq_matmul", "wq4_matmul", "qdecode_attn", "qchunk_attn", "qpaged_attn",
           "qragged_attn", "qmm", "qconv1d", "fake_quant")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA kernels "
                       "build from source on first use")


def library_path(name: str) -> Path:
    """Where ``name``'s shared library lives for the current source and the
    ``csrc`` headers it includes (``#include "..."``, and theirs)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers, todo = set(), re.findall(rb'#include "([^"]+)"', src)
    while todo:
        h = todo.pop()
        if h not in headers:
            headers.add(h)
            todo += re.findall(rb'#include "([^"]+)"', (CSRC / h.decode()).read_bytes())
    blob = src + b"".join(h + (CSRC / h.decode()).read_bytes() for h in sorted(headers))
    digest = hashlib.sha256(blob + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every missing library of ``names`` in parallel.

    Returns seconds per kernel (0.0 where the library was already built).
    The compiler's output, register and shared-memory use included, is kept
    beside each library as ``.log``.  Raises if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       log, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, log, tmp, out, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n{out.with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def int_arg(v: Union[int, torch.Tensor], device, what: str) -> Tuple[Optional[int], int]:
    """(pointer, value) of an int32 scalar a kernel reads from device memory
    (a one-element int32 tensor on ``device``) or takes by value (an int)."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1 or v.dtype != torch.int32 or v.device != device:
            raise ValueError(f"{what} must be one int32 on {device}")
        return v.data_ptr(), 0
    return None, int(v)
