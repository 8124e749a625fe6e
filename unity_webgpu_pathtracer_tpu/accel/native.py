"""ctypes binding to the native C++ BVH builder (``native/bvh_builder.cpp``).

The reference builds BVHs in a C plugin called through P/Invoke
(``Assets/Scripts/util/TinyBVH.cs``); here the native builder is optional —
``native_build_or_none`` returns None when the shared library is missing and
the numpy builder takes over.  Build with ``make -C native`` (see
``native/Makefile``); the first load builds the library when it is
missing or older than its source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libuwptbvh.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "bvh_builder.cpp")


def _stale() -> bool:
    """True when the library is missing or older than its source."""
    try:
        return os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH)
    except OSError:
        return True


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if _stale():
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-s"],
                check=True, capture_output=True, timeout=300,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.build_mbvh8.restype = ctypes.c_int
    lib.build_mbvh8.argtypes = [
        ctypes.POINTER(ctypes.c_float),   # positions (F*9)
        ctypes.c_int,                     # tri count
        ctypes.c_int,                     # leaf size
        ctypes.POINTER(ctypes.c_float),   # out bounds (cap*48)
        ctypes.POINTER(ctypes.c_int),     # out child (cap*8)
        ctypes.POINTER(ctypes.c_int),     # out order (F)
        ctypes.c_int,                     # node capacity
    ]
    try:
        lib.build_skip_bvh.restype = ctypes.c_int
        lib.build_skip_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # positions (F*9)
            ctypes.c_int,                     # tri count
            ctypes.c_int,                     # leaf size
            ctypes.POINTER(ctypes.c_float),   # out nodes (8*cap*8)
            ctypes.POINTER(ctypes.c_int),     # out order (F)
            ctypes.c_int,                     # per-octant node capacity
        ]
    except AttributeError:
        pass
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


def native_linearize_or_none(positions: np.ndarray, leaf_size: int = 4):
    """Native skip-pointer build; None if the library lacks the symbol."""
    lib = _load()
    if lib is None:
        return None
    try:
        fn = lib.build_skip_bvh
    except AttributeError:
        return None
    pos = np.ascontiguousarray(np.asarray(positions, np.float32).reshape(-1, 9))
    f = pos.shape[0]
    cap = max(2 * f + 8, 16)
    nodes = np.empty((8, cap, 8), np.float32)
    order = np.empty((f,), np.int32)
    n = fn(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        f, leaf_size,
        nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        cap,
    )
    if n <= 0:
        return None
    return np.ascontiguousarray(nodes[:, :n]), order


def native_wide_or_none(positions: np.ndarray, tri_records: np.ndarray,
                        leaf_size: int = 4, octants: int = 1):
    """Native fat-row 4-ary build; None if the library lacks the symbol."""
    lib = _load()
    if lib is None:
        return None
    try:
        fn = lib.build_wide_bvh
    except AttributeError:
        return None
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),   # tri records (F*9), original order
        ctypes.POINTER(ctypes.c_float),   # out nodes (octants*cap*48)
        ctypes.c_int,                     # per-octant node capacity
        ctypes.c_int,                     # octant count (1 or 8)
    ]
    pos = np.ascontiguousarray(np.asarray(positions, np.float32).reshape(-1, 9))
    recs = np.ascontiguousarray(np.asarray(tri_records, np.float32).reshape(-1, 9))
    f = pos.shape[0]
    cap = max(f + f // 2 + 8, 16)
    nodes = np.empty((octants, cap, 48), np.float32)
    n = fn(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        f, leaf_size,
        recs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap, octants,
    )
    if n <= 0:
        return None
    return np.ascontiguousarray(nodes[:, :n])


def native_build_or_none(positions: np.ndarray, leaf_size: int = 4):
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(np.asarray(positions, np.float32).reshape(-1, 9))
    f = pos.shape[0]
    cap = max(2 * f, 16)
    bounds = np.empty((cap, 48), np.float32)
    child = np.empty((cap, 8), np.int32)
    order = np.empty((f,), np.int32)
    n = lib.build_mbvh8(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        f, leaf_size,
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        child.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        cap,
    )
    if n <= 0:
        return None
    return bounds[:n].copy(), child[:n].copy(), order


def native_wide16_or_none(positions: np.ndarray, tri_records: np.ndarray,
                          leaf_size: int = 4, quality: int = 0,
                          leaf8: bool = False):
    """Native wide16 build; returns (rows (N,96) f32, depth, order) or None.

    ``quality``: 0 = binned SAH, 1 = SBVH spatial splits (the reference's
    vendored-but-unused tinybvh ``BuildHQ`` family).  With SBVH, ``order``
    is a *reference list* — original triangle ids, length >= tri count,
    duplicates allowed — and the host must permute attribute tables by it
    (fancy indexing with repeats does exactly that).

    ``leaf8`` selects the 48-float-row / 8-triangle-leaf variant
    (``build_wide16l8_ex``; accel.wide16 ROW8 layout) and returns
    (N,48) rows.
    """
    lib = _load()
    if lib is None:
        return None
    try:
        fn = lib.build_wide16l8_ex if leaf8 else lib.build_wide16_ex
    except AttributeError:
        return None
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    pos = np.ascontiguousarray(np.asarray(positions, np.float32).reshape(-1, 9))
    recs = np.ascontiguousarray(np.asarray(tri_records, np.float32).reshape(-1, 9))
    f = pos.shape[0]
    # SBVH ref budget is f + f/2 + 64 (bvh_builder.cpp); rows bound follows
    # the refs (transient host memory only).
    order_cap = f + f // 2 + 128
    row_f = 48 if leaf8 else 96
    # leaf8 leaves hold half the triangles -> up to ~2x the rows.
    cap = max(order_cap // 2 + order_cap // 8 + 64, 16) * (2 if leaf8 else 1)
    rows = np.empty((cap, row_f), np.float32)
    order = np.empty((order_cap,), np.int32)
    depth = ctypes.c_int(0)
    nrefs = ctypes.c_int(0)
    n = fn(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        recs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        f, leaf_size, quality,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap, ctypes.byref(depth),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        order_cap, ctypes.byref(nrefs),
    )
    if n <= 0:
        return None
    return (np.ascontiguousarray(rows[:n]), int(depth.value),
            order[: nrefs.value].copy())


def native_wide8_or_none(positions: np.ndarray, tri_records: np.ndarray,
                         leaf_size: int = 4):
    """Native wide8 build; returns (rows (N,48) f32, depth) or None."""
    lib = _load()
    if lib is None:
        return None
    try:
        fn = lib.build_wide8
    except AttributeError:
        return None
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    pos = np.ascontiguousarray(np.asarray(positions, np.float32).reshape(-1, 9))
    recs = np.ascontiguousarray(np.asarray(tri_records, np.float32).reshape(-1, 9))
    f = pos.shape[0]
    cap = max(f // 2 + f // 8 + 64, 16)
    rows = np.empty((cap, 48), np.float32)
    order = np.empty((f,), np.int32)
    depth = ctypes.c_int(0)
    n = fn(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        recs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        f, leaf_size,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap, ctypes.byref(depth),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if n <= 0:
        return None
    return np.ascontiguousarray(rows[:n]), int(depth.value), order


def native_f2h_or_none(vals: np.ndarray) -> np.ndarray | None:
    """Batch f32 -> canonical-f16 bits via the C++ builder's ``f2h``.

    Test hook for the two-implementation invariant: the numpy fallback
    emitters (``accel.wide16._canon_f16`` applied after np.float16 RNE)
    and the native builder's ``f2h`` must stay BIT-IDENTICAL on every
    input class, or tables built by one path silently break the table
    contract (tests/test_native.py::test_f2h_parity_fuzz).
    Returns None when the library (or a stale build without the symbol)
    is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    try:
        fn = lib.f2h_batch
    except AttributeError:
        return None
    fn.restype = None
    fn.argtypes = [ctypes.POINTER(ctypes.c_float),
                   ctypes.POINTER(ctypes.c_uint16), ctypes.c_int]
    x = np.ascontiguousarray(np.asarray(vals, np.float32).ravel())
    out = np.empty(x.size, np.uint16)
    fn(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), x.size)
    return out
