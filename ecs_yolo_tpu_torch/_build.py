"""Builds the port's CUDA kernels from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (``_build/lib<name>-<hash>.so``), loaded
with ``ctypes``.  The hash is taken over the source and the ``csrc/``
headers it includes (``#include "..."``, followed into headers), so an
edited source or header builds anew and a stale library is never loaded.  Nothing here runs at
import time; the CPU tests import this module without a compiler present.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per kernel source built by this process: (seconds its nvcc took, nvcc's
#: output incl. -Xptxas -v)
build_info: Dict[str, Tuple[float, str]] = {}


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and every header of ``csrc/`` it includes with
    quotes, directly or through another header, in the order first met."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())]
    return seen


def _target(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in _sources(name))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source that has no current library, one ``nvcc``
    process per source, all started together."""
    todo = [n for n in names if not _target(n).is_file()]
    if not todo:
        return
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = _target(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        build_info[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def nvcc_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v`` included) for the current library of
    ``csrc/<name>.cu``, kept beside it when it was built."""
    if name in build_info:
        return build_info[name][1]
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
