"""Build the CUDA kernels of ``csrc/`` into shared libraries.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own
content-hashed ``_build/<name>-<digest>.so`` (a plain C interface,
loaded with ``ctypes``), on first use.  The sources build in parallel,
one ``nvcc`` each.  Nothing is downloaded: the build reads only the
sources in this package and the CUDA toolkit's headers.

    python -m cilium_tpu_torch.kernels.build      # build all, print times
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
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("verdict", "conntrack", "lpm", "ring", "l7")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, all at
    once; returns {name: seconds} for the ones compiled.  ``ptxas``
    register and spill reports land in ``_build/<name>.log``."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.monotonic()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out)
    times, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.monotonic() - t0
        (BUILD_DIR / f"{name}.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return times


_LIBS: Dict[str, ctypes.CDLL] = {}
# the serving path's threads (drain, controllers) may ask for one
# library at once: one builds, the others wait for it
_LOAD_LOCK = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                lib.cuda_error_name.restype = ctypes.c_char_p
                lib.cuda_error_name.argtypes = [ctypes.c_int]
                _LIBS[name] = lib
    return lib


if __name__ == "__main__":
    t0 = time.monotonic()
    for n, s in build().items():
        print(f"{n}.cu built in {s:.1f} s")
    print(f"build total {time.monotonic() - t0:.1f} s")
