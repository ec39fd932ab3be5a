"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with nvcc into its own shared library with a plain
C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/sdrtpu_torch/lib<name>-<hash>.so <name>.cu

Libraries go to ``build/sdrtpu_torch/`` beside the package and are named
by a hash of their source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source is rebuilt and a stale library is never
loaded; nvcc's output (ptxas' register and shared-memory report) is kept
beside each as ``.log``.  Nothing builds at import: the first launch of
a kernel builds it, and `build_all` builds every source at once (one
nvcc process each, started together).

Every hand kernel's wrapper launches through `launch`, the one place
that knows the launch contract a CUDA graph's capture rests on: the C
entry runs on the current stream under the tensor's device guard, a
nonzero ``cudaError_t`` raises, and the launch is counted through
`graph.cuda_graph.count_launches` (so that replays count too).  `bind`
gives a library's C entry its types.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .graph.cuda_graph import count_launches

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "sdrtpu_torch"
SOURCES = ("chunk_poly", "decim_fir", "mix_decimate", "seq_loops",
           "sync_loops", "viterbi")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every missing library of ``names`` in parallel.

    Returns ``{name: {"seconds": float, "log": str, "cached": bool}}``
    (the log holds ptxas' register and shared-memory report; for a
    cached library it is the log of the build that made it).  Raises
    with nvcc's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    report = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            report[name] = {"seconds": 0.0, "cached": True,
                            "log": log.read_text() if log.exists() else ""}
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        report[name] = {"seconds": secs, "log": log, "cached": False}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


@functools.cache
def bind(name: str, entry: str, argtypes: tuple, restype=ctypes.c_int):
    """Library ``name``'s C entry ``entry`` with its C argument and
    result types, built and loaded on first use."""
    fn = getattr(load(name), entry)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def launch(wrapper, entry, device, *args) -> None:
    """Call the bound C entry ``entry`` with ``args`` and the handle of
    ``device``'s current stream, under its device guard; raise on a
    nonzero ``cudaError_t``, else count one launch of ``wrapper``."""
    with torch.cuda.device(device):
        rc = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{wrapper.__name__}: CUDA launch failed (error {rc})")
    count_launches(wrapper)
