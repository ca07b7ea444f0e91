"""Build the port's CUDA sources with ``nvcc`` at first use; bind with ctypes.

Every ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o tpuic_torch/_build/lib<name>-<hash>.so <name>.cu

The file name carries a hash of the flags, the source and every ``*.cuh``
beside it, so an edited source rebuilds and an unchanged one loads from
the build directory.  ``build()`` starts one ``nvcc`` per source, all
together, and waits for them.  A failed build raises with the compiler's
output; nothing falls back.  ``ptxas_log(name)`` returns what ``-Xptxas
-v`` reported (registers, shared memory, spills) for the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names of every kernel source in ``csrc/`` (``<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def ptxas_log(name: str) -> str:
    """The compiler output saved beside the library (empty if none)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def _build_locked(names: Iterable[str]) -> Dict[str, float]:
    todo = [n for n in names if not lib_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        out = lib_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    secs, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):"
                          f"\n{text}")
            continue
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)  # atomic: a racing process sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    # One compile event for the batch: its builds ran side by side.
    from tpuic_torch.telemetry.events import publish_compile
    publish_compile("nvcc:" + ",".join(todo), time.perf_counter() - t0,
                    sources=list(todo))
    return secs


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (all of ``csrc/`` by default) that have no
    up-to-date library yet, one ``nvcc`` each, started together.  Returns
    ``{name: seconds}`` for what was compiled."""
    with _lock:
        return _build_locked(sources() if names is None else list(names))


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib
