"""Builds the port's CUDA kernels, loads them through ctypes, and holds
the rule every kernel wrapper dispatches by.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared
library, ``build/kernels/<name>-<hash>.so`` at the root of the checkout
(git-ignored).  The hash covers the source and the flags, so an edited
source rebuilds on its next use.  ``build_all`` compiles every stale
source at once, one ``nvcc`` process each.  Nothing happens at import:
the CPU tests import this module on machines without ``nvcc``.

The dispatch rule (``on_cpu``): tensors that all lie on the CPU run the
wrapper's plain twin; tensors on one CUDA device launch the kernel or
raise.  There is no fallback from the card to the twin.  The kernels
have no backward: on the card a wrapper refuses an input that requires
grad while autograd records (``GradientError``), rather than return a
result with no ``grad_fn``; the plain twins on the CPU are
differentiable.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"     # used when nvcc is not on PATH
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(CUDA_NVCC):
        return CUDA_NVCC
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every stale source (or the ones named), all ``nvcc``
    processes started together.  Returns {name: ptxas report} for what
    was compiled; raises with the compiler's output on a failure."""
    srcs = sources()
    todo = {n: srcs[n] for n in (names or srcs)
            if not _lib_path(srcs[n]).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, src in todo.items():
        tmp = _lib_path(src).with_suffix(f".tmp{os.getpid()}")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, _lib_path(todo[name]))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if stale."""
    if name not in _loaded:
        build_all([name])
        _loaded[name] = ctypes.CDLL(str(_lib_path(sources()[name])))
    return _loaded[name]


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def require(fn: str, cond: bool, msg: str) -> None:
    """A wrapper's input check: ``ValueError`` naming the wrapper."""
    if not cond:
        raise ValueError(f"{fn}: {msg}")


class GradientError(RuntimeError):
    """A kernel was asked for a result that needs a gradient."""


def on_cpu(fn: str, *tensors) -> bool:
    """True when every tensor lies on the CPU (run the plain twin); False
    when all lie on one CUDA device (launch the kernel); raises
    otherwise, and ``GradientError`` when autograd is recording and an
    input requires grad (the kernel has no backward)."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return True
    require(fn, len(devices) == 1 and tensors[0].device.type == "cuda",
            f"all tensors must be on one CUDA device (got {devices})")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise GradientError(
            f"{fn}: an input requires grad, and the CUDA kernel has no "
            "backward; call it under torch.no_grad() or on detached "
            "tensors, or take the plain path (use_pallas=False)")
    return False


def check_launch(fn: str, err: int) -> None:
    """Raise on a refused launch (the C entry points return
    ``cudaGetLastError()``), e.g. more shared memory than a block may
    have."""
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
