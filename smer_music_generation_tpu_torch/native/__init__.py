"""Native (C++) tokenizer core with a transparent Python fallback.

Port of ``smer_music_generation_tpu/native/__init__.py``: the per-bar note
gridding, chord grouping and duration snapping of ``bar_notes_to_event``
(``smer_tokenizer.cpp``), compiled at first use with g++ and bound with
ctypes.  Unlike the JAX package, the library is written to
``build/native/libsmer_tokenizer_<hash>.so`` at the repo root (the hash is
over the source, so an edited source builds anew), never into the package,
and ``BUILD_INFO`` says whether the core was loaded, from where, and why not.

``load_library()`` returns the ctypes handle, or None when no toolchain is
available: callers then fall back to the pure-Python implementation, whose
tokens are the same (``tests/test_torch_native.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

_SRC = Path(__file__).resolve().parent / "smer_tokenizer.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# path of the loaded library, seconds to load it (its build included) and
# the reason the core could not be loaded
BUILD_INFO: Dict[str, object] = {"path": None, "seconds": None, "error": None}


def _compile(out: Path) -> None:
    """g++ into a temporary file beside ``out``, then an atomic rename, so
    processes building at once never load a half-written library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, str(_SRC)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.smer_tokenize_bar.restype = c.c_int
    # pointer params are void* so callers pass raw ndarray.ctypes.data
    lib.smer_tokenize_bar.argtypes = [
        c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_int,
        c.c_double, c.c_double,
        c.c_void_p, c.c_int,
        c.c_double, c.c_int, c.c_int,
        c.c_void_p, c.c_int, c.c_int,
        c.c_void_p, c.c_int,
        c.c_void_p, c.c_void_p, c.c_int,
        c.c_void_p,
    ]
    lib.smer_tokenize_track.restype = c.c_int
    lib.smer_tokenize_track.argtypes = [
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_int,   # starts ends pitches n
        c.c_void_p, c.c_int,                            # down_beats n_bars
        c.c_void_p, c.c_void_p,                         # beats dbi
        c.c_int, c.c_int,                               # grid_division do_grid
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, # table times/n/zero/mindiff
        c.c_int, c.c_void_p,                            # stride bar_table
        c.c_void_p, c.c_int, c.c_void_p,                # out max_out offsets
    ]
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """The bound core, built at the first call; None (with
    ``BUILD_INFO["error"]`` set) when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None or BUILD_INFO["error"] is not None:
            return _lib
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        out = _BUILD_DIR / f"libsmer_tokenizer_{digest}.so"
        t = time.perf_counter()
        try:
            if not out.exists():
                _compile(out)
            _lib = _bind(ctypes.CDLL(str(out)))
        except (OSError, subprocess.SubprocessError) as exc:
            BUILD_INFO["error"] = f"{type(exc).__name__}: {exc}"
            return None
        BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t)
        return _lib
