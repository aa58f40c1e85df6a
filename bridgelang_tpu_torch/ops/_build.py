"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/<name>-<hash>.so csrc/<name>.cu

No PyTorch header is included, so a build takes seconds. The library name
carries a hash of the source and of the shared `csrc/*.cuh` headers, so an
edited kernel or header is rebuilt and a stale library is never loaded.
Nothing is compiled when this module is imported: `load` builds on the first
call, and `build_all` compiles every source at once (one `nvcc` per source,
all started together). `function` hands out a library's C function with its
ctypes signature set once, so a launch pays for neither again.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """build/torch_kernels/<name>-<hash>.so; the hash covers the source, every
    csrc/*.cuh header (a source may include any of them) and the flags."""
    parts = [(CSRC_DIR / f"{name}.cu").read_bytes()]
    parts += [p.name.encode() + p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"\0".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
    """Start nvcc for one source unless its library exists; returns the
    process, the temporary output and the final path."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job: Tuple[subprocess.Popen, Path, Path]) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all() -> Dict[str, str]:
    """Compile every csrc/*.cu in parallel; returns each source's compiler log
    (ptxas register and spill report), empty where the library was built."""
    with _lock:
        jobs = {name: _start(name) for name in sources()}
        return {name: (_finish(name, job) if job else "") for name, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _loaded:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]


def function(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
    """The C function `symbol` of csrc/<name>.cu, its `argtypes` and `restype`
    set on the first call and the function cached: later calls are one dict
    lookup (pointers as ctypes.c_void_p, so that ctypes does not cut them to
    32-bit ints)."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = list(argtypes), restype
        _functions[(name, symbol)] = fn
    return fn
