"""Host-side data engine: ctypes bindings for the native C++ kernels, with
numpy fallbacks.

Port of ganmf_tpu/ops/host.py. The source, ganmf_tpu_torch/native/cf_host.cpp,
is a verbatim copy of the JAX package's (C++/OpenMP counterparts of the
reference's Cython module, GANRec/Cython/cython_utils.pyx). It is compiled
with ``g++`` at first use into ``build/ganmf_tpu_torch/`` at the root of the
checkout, named by a hash of the source, never next to the source, and bound
with ctypes. Every function also works without the library (pure numpy), so
a machine without a toolchain still runs; ``get_lib`` returns None there and
``build_error`` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sps

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "native" / "cf_host.cpp"
BUILD_DIR = _PKG.parent / "build" / "ganmf_tpu_torch"
GXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None  # why the library is missing, once a build failed

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def library_path() -> Path:
    """Where the library for the current source and flags lives, built or not."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libcf_host_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, out.name)
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", lib], check=True, capture_output=True, text=True)
        os.replace(lib, out)  # atomic: a concurrent loader never sees half a file


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None when it cannot be built
    or loaded (the callers then take their numpy paths)."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except subprocess.CalledProcessError as err:
            build_error = f"g++ failed ({err.returncode}): {err.stderr[-2000:]}"
            return None
        except (OSError, FileNotFoundError) as err:
            build_error = f"{type(err).__name__}: {err}"
            return None

        lib.csr_gather_dense.argtypes = [_i64p, _i32p, _f32p, ctypes.c_int64, _i64p, ctypes.c_int64, _f32p]
        lib.non_interactions.argtypes = [_i64p, _i32p, ctypes.c_int64, ctypes.c_int64, _i32p, _i64p]
        lib.sample_negative_mask.argtypes = [
            _i64p, _i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_uint64, _u8p,
        ]
        lib.random_choice_cdf.argtypes = [_f32p, ctypes.c_int64, _i32p, ctypes.c_int64, ctypes.c_uint64, _i32p]
        lib.shuffled_interactions.argtypes = [_i64p, _i32p, ctypes.c_int64, ctypes.c_uint64, _i32p, _i32p]
        lib.parse_interactions.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _i64p, _i64p, _f32p,
        ]
        lib.parse_interactions.restype = ctypes.c_int64
        lib.cf_host_version.restype = ctypes.c_int
        _lib = lib
        return _lib


def _csr_arrays(urm: sps.csr_matrix):
    urm = urm.tocsr()
    return (
        np.ascontiguousarray(urm.indptr, dtype=np.int64),
        np.ascontiguousarray(urm.indices, dtype=np.int32),
        np.ascontiguousarray(urm.data, dtype=np.float32),
    )


def csr_gather_dense(urm: sps.csr_matrix, row_ids: np.ndarray) -> np.ndarray:
    """Dense float32 block of CSR rows (native when available)."""
    row_ids = np.ascontiguousarray(row_ids, dtype=np.int64)
    lib = get_lib()
    if lib is None:
        return np.asarray(urm[row_ids].todense(), dtype=np.float32)
    indptr, indices, data = _csr_arrays(urm)
    out = np.empty((len(row_ids), urm.shape[1]), dtype=np.float32)
    lib.csr_gather_dense(indptr, indices, data, urm.shape[1], row_ids, len(row_ids), out)
    return out


def get_non_interactions(urm: sps.csr_matrix) -> Dict[int, np.ndarray]:
    """Per-user zero-column index arrays (cython_utils.pyx:30-38 API)."""
    n_users, n_items = urm.shape
    lib = get_lib()
    if lib is None:
        out = {}
        dense = urm.tocsr()
        for u in range(n_users):
            seen = dense.indices[dense.indptr[u]: dense.indptr[u + 1]]
            mask = np.ones(n_items, dtype=bool)
            mask[seen] = False
            out[u] = np.nonzero(mask)[0].astype(np.int32)
        return out
    indptr, indices, _ = _csr_arrays(urm)
    total = int(n_users * n_items - urm.nnz)
    flat = np.empty(total, dtype=np.int32)
    offsets = np.empty(n_users + 1, dtype=np.int64)
    lib.non_interactions(indptr, indices, n_users, n_items, flat, offsets)
    return {u: flat[offsets[u]: offsets[u + 1]] for u in range(n_users)}


def sample_negative_mask(urm: sps.csr_matrix, ratio: float, seed: int) -> np.ndarray:
    """[U, I] uint8 mask with int(n_zeros(u) * ratio) sampled negatives per
    user (compute_masks equivalent, cython_utils.pyx:48-66)."""
    n_users, n_items = urm.shape
    lib = get_lib()
    if lib is None:
        rng = np.random.RandomState(seed)
        out = np.zeros((n_users, n_items), dtype=np.uint8)
        csr = urm.tocsr()
        for u in range(n_users):
            seen = csr.indices[csr.indptr[u]: csr.indptr[u + 1]]
            mask = np.ones(n_items, dtype=bool)
            mask[seen] = False
            zeros = np.nonzero(mask)[0]
            k = int(len(zeros) * ratio)
            if k:
                out[u, rng.choice(zeros, size=k, replace=False)] = 1
        return out
    indptr, indices, _ = _csr_arrays(urm)
    out = np.empty((n_users, n_items), dtype=np.uint8)
    lib.sample_negative_mask(indptr, indices, n_users, n_items, float(ratio), int(seed), out)
    return out


def random_choice_cdf(cdf: np.ndarray, rows: np.ndarray, seed: int) -> np.ndarray:
    """Inverse-CDF categorical draw per requested row
    (cython_utils.random_choice, :74-104)."""
    cdf = np.ascontiguousarray(cdf, dtype=np.float32)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    lib = get_lib()
    if lib is None:
        rng = np.random.RandomState(seed)
        samples = rng.random_sample(len(rows)).astype(np.float32)
        return np.array(
            [np.searchsorted(cdf[r], s).clip(0, cdf.shape[1] - 1) for r, s in zip(rows, samples)],
            dtype=np.int32,
        )
    out = np.empty(len(rows), dtype=np.int32)
    lib.random_choice_cdf(cdf, cdf.shape[1], rows, len(rows), int(seed), out)
    return out


def parse_interactions_file(
    path: str,
    delimiter: str = ",",
    header: bool = False,
    use_cols: Optional[Dict[str, int]] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Parse a ratings file into (user, item, rating) arrays in file order
    with the native OpenMP parser (reference DataReader.read_interactions,
    datasets/DataReader.py:275-379). Returns None when the native library is
    unavailable, so that the caller takes the Python line loop; the two give
    identical arrays on well-formed files (tests/test_torch_host_ops.py)."""
    lib = get_lib()
    if lib is None:
        return None
    use_cols = use_cols or {"user_id": 0, "item_id": 1, "rating": 2}
    u_col, i_col = use_cols["user_id"], use_cols["item_id"]
    r_col = use_cols.get("rating", None)
    with open(path, "rb") as fh:
        raw = fh.read()
    if header:
        nl = raw.find(b"\n")
        raw = raw[nl + 1:] if nl >= 0 else b""
    if not raw.endswith(b"\n"):
        raw += b"\n"  # the native parser requires a terminated final line
    max_rows = raw.count(b"\n")
    users = np.empty(max_rows, dtype=np.int64)
    items = np.empty(max_rows, dtype=np.int64)
    vals = np.empty(max_rows, dtype=np.float32)
    if max_rows:
        dl = delimiter.encode()
        n = lib.parse_interactions(
            raw, len(raw), dl, len(dl),
            np.int32(u_col), np.int32(i_col),
            np.int32(-1 if r_col is None else r_col),
            users, items, vals,
        )
    else:
        n = 0
    return users[:n], items[:n], vals[:n]


def shuffled_interactions(urm: sps.csr_matrix, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled (user, item) interaction arrays (CAAE epoch prologue)."""
    lib = get_lib()
    if lib is None:
        coo = urm.tocoo()
        rng = np.random.RandomState(seed)
        perm = rng.permutation(urm.nnz)
        return coo.row[perm].astype(np.int32), coo.col[perm].astype(np.int32)
    indptr, indices, _ = _csr_arrays(urm)
    users = np.empty(urm.nnz, dtype=np.int32)
    items = np.empty(urm.nnz, dtype=np.int32)
    lib.shuffled_interactions(indptr, indices, urm.shape[0], int(seed), users, items)
    return users, items
