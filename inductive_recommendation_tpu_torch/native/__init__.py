"""Native (C++) graph core for host-side data preparation, with numpy and
Python plain versions (counterpart of ``inductive_recommendation_tpu/native``).

``graph_core.cpp`` is this package's own copy of the source. It is compiled
at first use with ``g++ -O3 -shared -fPIC`` into ``native/build/`` (listed in
``.gitignore``) and loaded through ``ctypes``. The library's file name
carries a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded.

Each entry point runs the native routine when the library loads and its plain
version otherwise: a machine without ``g++`` still works, more slowly. The
plain versions are also callable on their own (``*_reference``), so that a
check can hold the native routine against them. The Yelp and Amazon parsers
may decline an input (return ``None``); the dataset then runs its exact
Python parser.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "graph_core.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_unavailable = False


def library_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libgraph_core-{digest}.so"


def _bind(lib):
    i64, i64p, u8p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8)
    lib.kcore.argtypes = [i64p, i64p, i64, i64, i64, i64, u8p, u8p]
    lib.kcore.restype = None
    lib.parse_gowalla.argtypes = [ctypes.c_char_p, i64, i64p, i64p, i64p]
    lib.parse_gowalla.restype = i64
    lib.parse_adjacency.argtypes = [ctypes.c_char_p, i64, i64, i64p, i64p]
    lib.parse_adjacency.restype = i64
    for fn in (lib.parse_yelp, lib.parse_amazon):
        fn.argtypes = [ctypes.c_char_p, i64, i64p, i64p, i64p, i64p, i64p]
        fn.restype = i64
    return lib


def _load():
    """The loaded library, built first if needed; None when it cannot be
    built or loaded (the plain versions then run)."""
    global _lib, _unavailable
    with _lock:
        if _lib is None and not _unavailable:
            out = library_path()
            try:
                if not out.exists():
                    BUILD_DIR.mkdir(parents=True, exist_ok=True)
                    tmp = out.with_suffix(f".{os.getpid()}.tmp")
                    subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)], check=True, capture_output=True)
                    os.replace(tmp, out)
                _lib = _bind(ctypes.CDLL(str(out)))
            except (OSError, subprocess.CalledProcessError):
                _unavailable = True
    return _lib


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def native_available() -> bool:
    return _load() is not None


def kcore_masks_reference(users, items, n_users, n_items, min_inter):
    """Plain version of :func:`kcore_masks`: masked degree recount to a fixed
    point."""
    users = np.asarray(users, dtype=np.int64)
    items = np.asarray(items, dtype=np.int64)
    ku = np.ones(n_users, dtype=bool)
    ki = np.ones(n_items, dtype=bool)
    while True:
        live = ku[users] & ki[items]
        new_ku = ku & (np.bincount(users[live], minlength=n_users) >= min_inter)
        new_ki = ki & (np.bincount(items[live], minlength=n_items) >= min_inter)
        if new_ku.sum() == ku.sum() and new_ki.sum() == ki.sum():
            return new_ku, new_ki
        ku, ki = new_ku, new_ki


def kcore_masks(users, items, n_users, n_items, min_inter):
    """Keep-flags of the (min_inter)-core over a DEDUPLICATED bipartite edge
    list with dense ids: (keep_users bool[n_users], keep_items bool[n_items]).
    The k-core is unique, so the native peel and the plain fixed point agree."""
    users = np.ascontiguousarray(users, dtype=np.int64)
    items = np.ascontiguousarray(items, dtype=np.int64)
    lib = _load()
    if lib is None:
        return kcore_masks_reference(users, items, n_users, n_items, min_inter)
    ku = np.empty(n_users, dtype=np.uint8)
    ki = np.empty(n_items, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.kcore(_p64(users), _p64(items), len(users), n_users, n_items, min_inter,
              ku.ctypes.data_as(u8p), ki.ctypes.data_as(u8p))
    return ku.astype(bool), ki.astype(bool)


def parse_gowalla_reference(path):
    """Plain version of :func:`parse_gowalla_file`: numpy ``loadtxt`` and
    ``datetime64``, which reads a time without its zone designator as UTC
    (the ``Z`` is stripped first)."""
    raw = np.loadtxt(path, dtype=str, delimiter="\t", ndmin=2)
    users = raw[:, 0].astype(np.int64)
    items = raw[:, 4].astype(np.int64)
    ts = np.char.rstrip(raw[:, 1], "Z").astype("datetime64[s]").astype(np.int64)
    return users, items, ts


def parse_gowalla_file(path):
    """Gowalla_totalCheckins.txt (``user\\tISO-8601 time\\tlat\\tlon\\titem``)
    -> (users, items, ts) int64 arrays, ts in UTC epoch seconds (the
    reference's ``time.mktime`` depended on the host's timezone; only the
    order feeds the chronological split)."""
    lib = _load()
    if lib is not None:
        cap = os.path.getsize(path) // 20 + 16  # >= line count (a line is >= 29 bytes)
        users, items, ts = (np.empty(cap, dtype=np.int64) for _ in range(3))
        n = lib.parse_gowalla(os.fsencode(path), cap, _p64(users), _p64(items), _p64(ts))
        if n >= 0:
            return users[:n].copy(), items[:n].copy(), ts[:n].copy()
    return parse_gowalla_reference(path)


def _parse_interned(fn_name, path, min_line_bytes):
    """(users, items, ts) dense-interned int64 arrays of the KEPT
    interactions, or None when the library is unavailable or declined the
    file."""
    lib = _load()
    if lib is None:
        return None
    cap = os.path.getsize(path) // min_line_bytes + 16
    users, items, ts = (np.empty(cap, dtype=np.int64) for _ in range(3))
    ndu, ndi = np.zeros(1, dtype=np.int64), np.zeros(1, dtype=np.int64)
    n = getattr(lib, fn_name)(os.fsencode(path), cap, _p64(users), _p64(items), _p64(ts), _p64(ndu), _p64(ndi))
    if n < 0:
        return None
    return users[:n].copy(), items[:n].copy(), ts[:n].copy()


def parse_yelp_file(path):
    """yelp_academic_dataset_review.json -> the kept (stars > 3)
    interactions as (users, items, ts), ids interned in first-seen order, or
    None (the caller runs the exact ``json.loads`` path)."""
    return _parse_interned("parse_yelp", path, 80)  # a review line is far above 80 bytes


def parse_amazon_file(path):
    """ratings_Books.csv -> the kept (rating > 3) interactions as
    (users, items, ts), interned as :func:`parse_yelp_file`, or None."""
    return _parse_interned("parse_amazon", path, 8)


def parse_adjacency_reference(path):
    """Plain version of :func:`parse_adjacency_file` (reference semantics)."""
    with open(path, "r") as f:
        lines = f.read().strip().split("\n")
    flat, offs = [], [0]
    for line in lines:
        flat.extend(int(t) for t in line.split(" ")[1:] if t)
        offs.append(len(flat))
    return np.asarray(flat, dtype=np.int64), np.asarray(offs, dtype=np.int64)


def parse_adjacency_file(path):
    """'user item item ...' text (train/val/test.txt, reference
    dataset.py:140-164: the leading user token is discarded, the line number
    is the user id) -> (flat items int64, offsets int64[n_lines + 1])."""
    lib = _load()
    if lib is not None:
        size = os.path.getsize(path)
        flat = np.empty(size // 2 + 16, dtype=np.int64)
        offs = np.empty(size // 2 + 17, dtype=np.int64)
        n = lib.parse_adjacency(os.fsencode(path), len(flat), len(offs) - 1, _p64(flat), _p64(offs))
        if n >= 0:
            return flat[: offs[n]].copy(), offs[: n + 1].copy()
    return parse_adjacency_reference(path)
