"""The native (C++) packet parser, loaded with ctypes.

A copy of the loader half of the JAX package's ``native/__init__.py``:
``ingest.cpp`` is compiled by the host's C++ compiler (``g++``) on first
use into ``cilium_tpu_torch/_build/`` (content-addressed, so an edited
source rebuilds), and loaded with ctypes.  Two entry points are bound:
``parse_frames`` (a length-prefixed ethernet frame stream) and
``parse_pcap`` (a classic libpcap file).  Each has a Python copy with
the same semantics, :func:`parse_frames_py` here and the record loop of
``core/pcap.py`` ``read_pcap``: the oracle the native parser is held to
bit for bit, and the path on a host without a compiler.

Which parser ran is counted (:func:`parse_counts`), so a caller can
show that a run went through the native one.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
# parser -> calls that parsed with it ("native" | "python")
_counts: collections.Counter = collections.Counter()

N_COLS = 16


def _so_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"ingest-{digest}.so"


def _compile(so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(so.name + f".tmp{os.getpid()}")
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             "-o", str(tmp), str(_SRC)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    """Compile (once, content-addressed) and dlopen the parser."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = _so_path()
        preexisting = so.exists()
        if not preexisting and not _compile(so):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            # a stale library built for another host must not disable
            # the native path while the compiler can rebuild it
            lib = None
            if preexisting:
                so.unlink(missing_ok=True)
                if _compile(so):
                    try:
                        lib = ctypes.CDLL(str(so))
                    except OSError:
                        lib = None
            if lib is None:
                _build_failed = True
                return None
        for fn in (lib.parse_frames, lib.parse_pcap):
            fn.restype = ctypes.c_long
            fn.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_long,
                ctypes.c_uint32, ctypes.c_uint32,
            ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_counts() -> Dict[str, int]:
    """Calls parsed by each parser since the last reset."""
    with _lock:
        return dict(_counts)


def reset_parse_counts() -> None:
    with _lock:
        _counts.clear()


def count_parse(parser: str) -> None:
    with _lock:
        _counts[parser] += 1


def _call(fn_name: str, buf: bytes, max_rows: int, ep: int,
          direction: int,
          out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    copy = out is None
    if copy:
        out = np.empty((max_rows, N_COLS), dtype=np.uint32)
    n = getattr(lib, fn_name)(
        buf, len(buf),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        max_rows, ep, direction)
    if n < 0:
        raise ValueError("not a pcap buffer")
    count_parse("native")
    return out[:n].copy() if copy else out[:n]


def parse_frames(buf: bytes, ep: int = 0, direction: int = 0,
                 max_rows: Optional[int] = None,
                 out: Optional[np.ndarray] = None
                 ) -> Optional[np.ndarray]:
    """Length-prefixed ethernet frame stream -> [N, N_COLS] rows.

    A reused ``out`` buffer ([max_rows, N_COLS] u32, C-contiguous)
    makes the result ``out[:n]``, a view.  None when the native library
    is unavailable (callers fall back to :func:`parse_frames_py`)."""
    if out is not None:
        if out.dtype != np.uint32 or not out.flags["C_CONTIGUOUS"] \
                or out.ndim != 2 or out.shape[1] != N_COLS:
            raise ValueError("out must be C-contiguous [n, N_COLS] u32")
        max_rows = out.shape[0]
    elif max_rows is None:
        max_rows = max(len(buf) // 24, 1)  # 4B prefix + >=20B IP
    return _call("parse_frames", buf, max_rows, ep, direction, out)


def parse_pcap_bytes(buf: bytes, ep: int = 0, direction: int = 0,
                     max_rows: Optional[int] = None
                     ) -> Optional[np.ndarray]:
    """Classic pcap file bytes -> [N, N_COLS] rows (None: no native)."""
    if max_rows is None:
        max_rows = max((len(buf) - 24) // 36, 1)  # 16B rec hdr + 20B IP
    return _call("parse_pcap", buf, max_rows, ep, direction)


def parse_frames_py(buf: bytes, ep: int = 0, direction: int = 0,
                    related: bool = True) -> np.ndarray:
    """The Python copy of :func:`parse_frames`: the same semantics, the
    path without a compiler and the oracle of the native parser.
    ``related=False`` skips the ICMP-error RELATED transform."""
    from ..core.pcap import _parse_ip, build_row

    count_parse("python")
    rows = []
    off = 0
    while off + 4 <= len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + flen > len(buf):
            break
        frame = buf[off:off + flen]
        off += flen
        if len(frame) < 14:
            continue
        ethertype = struct.unpack_from("!H", frame, 12)[0]
        l3 = 14
        while ethertype in (0x8100, 0x88A8) and len(frame) >= l3 + 4:
            ethertype = struct.unpack_from("!H", frame, l3 + 2)[0]
            l3 += 4
        if ethertype not in (0x0800, 0x86DD):
            continue
        parsed = _parse_ip(frame[l3:])
        if parsed is None:
            continue
        rows.append(build_row(parsed, ep, direction, related=related))
    if not rows:
        return np.zeros((0, N_COLS), dtype=np.uint32)
    return np.stack(rows)
