"""Build and load the port's CUDA kernels: ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` under ``repro_torch/kernels`` becomes
``build/repro_torch/lib<name>-<hash>.so`` at the checkout's root, where
``<hash>`` covers the source, every ``csrc/*.cuh`` header of the
package and the flags, so an edited source or header never loads a
stale library.  The build runs at first use (or, for all
kernels at once, in parallel through :func:`build_all`); nothing is
built or imported when a module is imported.

Every pointer and the stream cross the C boundary as ``c_void_p``:
without ``argtypes`` ctypes would pass a Python int as a 32-bit int and
cut the pointer.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"

# every source, by library name
SOURCES = {
    "qmac": _KERNELS / "qmac" / "csrc" / "qmac.cu",
    "qconv": _KERNELS / "qconv" / "csrc" / "qconv.cu",
    "vact": _KERNELS / "vact" / "csrc" / "vact.cu",
    "qlstm": _KERNELS / "qlstm" / "csrc" / "qlstm.cu",
}

# --fmad=false: no a + b*c contraction anywhere, so the fp epilogues
# round exactly like the reference's separate multiply and add
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(f"nvcc not found (looked in {cand} and PATH); "
                           "the CUDA kernels are built on the machine "
                           "with the card")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(_KERNELS.glob("*/csrc/*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one library; None when it is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, cmd = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"building {name} failed ({' '.join(cmd)}):\n"
                           f"{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = tuple(SOURCES)) -> List[Path]:
    """Build every listed library, one nvcc per source, all at once."""
    names = list(names)
    started = [(n, _start(n)) for n in names]
    errors = []
    for n, s in started:
        try:
            _finish(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launcher."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error "
                           f"{code}")
