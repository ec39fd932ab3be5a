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

A probe build (``probe=True``) adds ``-DSDRTPU_PROBE``: the scan kernels
then read the SM clock around each part of a step (``csrc/probe.cuh``,
`sdrtpu_torch.probe`).  It is a library of its own, never the one the
wrappers load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "sdrtpu_torch"
SOURCES = ("chunk_poly", "mix_decimate", "seq_loops", "sync_loops",
           "viterbi")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PROBE_DEFINE = "-DSDRTPU_PROBE"

_LIBS: dict[tuple[str, bool], ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(probe: bool) -> tuple[str, ...]:
    return NVCC_FLAGS + ((PROBE_DEFINE,) if probe else ())


def lib_path(name: str, probe: bool = False) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(probe)).encode()).hexdigest()
    kind = "-probe" if probe else ""
    return BUILD_DIR / f"lib{name}{kind}-{digest[:12]}.so"


def build_all(names=SOURCES, probes=()) -> dict[str, dict]:
    """Compile every missing library in parallel: each of ``names``, and
    the probe build of each of ``probes`` (reported as ``name+probe``).

    Returns ``{name: {"seconds": float, "log": str, "cached": bool}}``
    (the log holds ptxas' register and shared-memory report; for a
    cached library it is the log of the build that made it).  Raises
    with nvcc's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    report = {}
    targets = [(n, False) for n in names] + [(n, True) for n in probes]
    for name, probe in targets:
        key = f"{name}+probe" if probe else name
        out = lib_path(name, probe)
        if out.exists():
            log = out.with_suffix(".log")
            report[key] = {"seconds": 0.0, "cached": True,
                           "log": log.read_text() if log.exists() else ""}
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(probe), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
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


def load(name: str, probe: bool = False) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (its probe build with
    ``probe``), built on first use."""
    lib = _LIBS.get((name, probe))
    if lib is None:
        path = lib_path(name, probe)
        if not path.exists():
            build_all(() if probe else (name,), (name,) if probe else ())
        lib = ctypes.CDLL(str(path))
        _LIBS[(name, probe)] = lib
    return lib
