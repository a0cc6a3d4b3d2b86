"""ctypes bindings for the C++ host runtime (built lazily with g++).

Falls back to vectorized NumPy implementations with identical semantics when
no C++ toolchain is available; ``HAVE_NATIVE`` reports which path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "src", "hostsort.cc")
_BUILD_DIR = os.path.join(_HERE, "build")
_SO = os.path.join(_BUILD_DIR, "libgswt_host.so")

_lib = None
HAVE_NATIVE = False


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", _SO, _SRC],
                check=True,
                capture_output=True,
            )
        return True
    except (OSError, subprocess.CalledProcessError) as e:  # pragma: no cover
        sys.stderr.write(f"gswt native build failed, using NumPy fallback: {e}\n")
        return False


def _load():
    global _lib, HAVE_NATIVE
    if _lib is not None or HAVE_NATIVE:
        return
    if os.environ.get("GSWT_NO_NATIVE") == "1":
        return
    if not _build():
        return
    lib = ctypes.CDLL(_SO)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.gswt_depth_keys.argtypes = [f32p, ctypes.c_int64, f32p, i32p]
    lib.gswt_counting_sort.argtypes = [i32p, ctypes.c_int64, u32p]
    lib.gswt_counting_sort_merge.argtypes = [i32p, i64p, ctypes.c_int64, u32p, u32p]
    lib.gswt_gather_offset_u32.argtypes = [u32p, u32p, u32p, u32p, ctypes.c_int64, u32p]
    lib.gswt_lookup_u32.argtypes = [u32p, u32p, ctypes.c_int64, u32p]
    lib.gswt_toposort.argtypes = [
        i32p, i32p, ctypes.c_int64, i32p, ctypes.c_int64, ctypes.c_int32, i32p
    ]
    lib.gswt_toposort.restype = ctypes.c_int64
    _lib = lib
    HAVE_NATIVE = True


_load()

_BUCKETS = 256 * 256


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def depth_keys(f_buffer: np.ndarray, vp_z: np.ndarray) -> np.ndarray:
    """Raw i32 depth keys for packed splat rows (scene.rs:537-552).
    f_buffer: f32 [N, 8] view of the 32-byte packed buffer."""
    n = f_buffer.shape[0]
    out = np.empty(n, np.int32)
    if n == 0:
        return out
    if HAVE_NATIVE:
        fb = np.ascontiguousarray(f_buffer, np.float32)
        vz = np.ascontiguousarray(vp_z, np.float32)
        _lib.gswt_depth_keys(_ptr(fb, ctypes.c_float), n, _ptr(vz, ctypes.c_float),
                             _ptr(out, ctypes.c_int32))
        return out
    d = (f_buffer[:, :3].astype(np.float32) @ vp_z.astype(np.float32)) * np.float32(4096.0)
    d = np.nan_to_num(d.astype(np.float64), nan=0.0)
    return np.clip(np.trunc(d), -(2**31), 2**31 - 1).astype(np.int32)


def _buckets_np(raw_depth: np.ndarray) -> np.ndarray:
    min_d = np.int32(raw_depth.min())
    max_d = np.int32(raw_depth.max())
    if max_d == min_d:
        return np.zeros(raw_depth.shape[0], np.int64)
    inv = np.float32(_BUCKETS - 1) / np.float32(np.int32(max_d - min_d))
    b = np.floor((raw_depth - min_d).astype(np.float32) * inv).astype(np.int64)
    return np.clip(b, 0, _BUCKETS - 1)


def counting_sort(raw_depth: np.ndarray) -> np.ndarray:
    """Back-to-front stable counting sort over 65,536 buckets; returns
    indices (scene.rs:537-583)."""
    n = raw_depth.shape[0]
    out = np.empty(n, np.uint32)
    if n == 0:
        return out
    if HAVE_NATIVE:
        rd = np.ascontiguousarray(raw_depth, np.int32)
        _lib.gswt_counting_sort(_ptr(rd, ctypes.c_int32), n, _ptr(out, ctypes.c_uint32))
        return out
    b = _buckets_np(np.asarray(raw_depth, np.int32))
    return np.argsort(b, kind="stable")[::-1].astype(np.uint32)


def counting_sort_merge(raw_depth_concat: np.ndarray, seg_displ: np.ndarray):
    """k-way merge of concatenated per-segment depth vectors
    (scene.rs:655-698). Returns (seg_id u32[N], idx u32[N]) back-to-front."""
    n = int(seg_displ[-1])
    seg_id = np.empty(n, np.uint32)
    idx = np.empty(n, np.uint32)
    if n == 0:
        return seg_id, idx
    if HAVE_NATIVE:
        rd = np.ascontiguousarray(raw_depth_concat, np.int32)
        sd = np.ascontiguousarray(seg_displ, np.int64)
        _lib.gswt_counting_sort_merge(
            _ptr(rd, ctypes.c_int32), _ptr(sd, ctypes.c_int64),
            len(seg_displ) - 1, _ptr(seg_id, ctypes.c_uint32),
            _ptr(idx, ctypes.c_uint32),
        )
        return seg_id, idx
    b = _buckets_np(np.asarray(raw_depth_concat, np.int32))
    order = np.argsort(b, kind="stable")[::-1]
    seg = np.searchsorted(np.asarray(seg_displ, np.int64), order, side="right") - 1
    return seg.astype(np.uint32), (order - np.asarray(seg_displ)[seg]).astype(np.uint32)


def gather_offset_u32(base, seg_id, idx, offsets):
    """out[i] = base[offsets[seg_id[i]] + idx[i]] (wangtile.rs:651-657)."""
    n = seg_id.shape[0]
    out = np.empty(n, np.uint32)
    if n == 0:
        return out
    if HAVE_NATIVE:
        b = np.ascontiguousarray(base, np.uint32)
        s = np.ascontiguousarray(seg_id, np.uint32)
        i = np.ascontiguousarray(idx, np.uint32)
        o = np.ascontiguousarray(offsets, np.uint32)
        _lib.gswt_gather_offset_u32(
            _ptr(b, ctypes.c_uint32), _ptr(s, ctypes.c_uint32),
            _ptr(i, ctypes.c_uint32), _ptr(o, ctypes.c_uint32), n,
            _ptr(out, ctypes.c_uint32))
        return out
    return np.asarray(base, np.uint32)[
        np.asarray(offsets, np.uint32)[seg_id] + np.asarray(idx, np.uint32)
    ]


def toposort(edge_a, edge_b, nodes, max_index):
    """Kahn toposort with lowest-index cycle removal; returns the FINAL
    painter order (reversed, cycle victims first), only nodes with edges
    (wangtile.rs:1115-1218 semantics). Returns None without the C++ lib
    (caller falls back to the Python implementation)."""
    if not HAVE_NATIVE:
        return None
    ea = np.ascontiguousarray(edge_a, np.int32)
    eb = np.ascontiguousarray(edge_b, np.int32)
    nd = np.ascontiguousarray(nodes, np.int32)
    out = np.empty(len(nd), np.int32)
    n_out = _lib.gswt_toposort(
        _ptr(ea, ctypes.c_int32), _ptr(eb, ctypes.c_int32), len(ea),
        _ptr(nd, ctypes.c_int32), len(nd), np.int32(max_index),
        _ptr(out, ctypes.c_int32),
    )
    return out[:n_out]


def lookup_u32(table, seg_id):
    n = seg_id.shape[0]
    out = np.empty(n, np.uint32)
    if n == 0:
        return out
    if HAVE_NATIVE:
        t = np.ascontiguousarray(table, np.uint32)
        s = np.ascontiguousarray(seg_id, np.uint32)
        _lib.gswt_lookup_u32(_ptr(t, ctypes.c_uint32), _ptr(s, ctypes.c_uint32), n,
                             _ptr(out, ctypes.c_uint32))
        return out
    return np.asarray(table, np.uint32)[seg_id]
