"""Reference-compatible NDArray binary serialization (numpy only).

The PyTorch package's own copy of ``mxnet_tpu/ndarray/serialization.py``,
so both packages read and write one ``.params`` file:

- list container: uint64 magic 0x112 + uint64 reserved, then a
  vector<NDArray> (uint64 count + per-element record) and a
  vector<string> of names (uint64 count; uint64 len + bytes each)
  (MXNet src/ndarray/ndarray.cc:1010-1044).
- per-NDArray V2 record: uint32 magic 0xF993FAC9, int32 storage type,
  [storage TShape if sparse], TShape, Context(int32 dev_type, int32
  dev_id), int32 type flag, [aux types+shapes if sparse], raw buffer(s)
  (MXNet src/ndarray/ndarray.cc:809-885).
- TShape: uint32 ndim + int64 dims (the V1-era int64 TShape,
  ndarray.cc:808 comment); V1 magic 0xF993FAC8 and the pre-V1 layout
  (magic IS ndim, uint32 dims) are accepted on load
  (ndarray.cc:886-925 LegacyLoad).

Everything is little-endian, matching dmlc::Stream on x86.
"""
from __future__ import annotations

import struct

import numpy as _np

from ..base import atomic_write

NDARRAY_V1_MAGIC = 0xF993FAC8
NDARRAY_V2_MAGIC = 0xF993FAC9
LIST_MAGIC = 0x112

# mshadow type flags (mshadow/base.h)
_TYPE_FLAG_TO_DTYPE = {
    0: _np.float32, 1: _np.float64, 2: _np.float16,
    3: _np.uint8, 4: _np.int32, 5: _np.int8, 6: _np.int64,
}
_DTYPE_TO_TYPE_FLAG = {_np.dtype(v): k for k, v in
                       _TYPE_FLAG_TO_DTYPE.items()}

# NDArrayStorageType (include/mxnet/ndarray.h:83-86)
STYPE_DEFAULT = 0
STYPE_ROW_SPARSE = 1
STYPE_CSR = 2
# aux buffers per storage type (num_aux_data, include/mxnet/ndarray.h:120)
_NUM_AUX = {STYPE_DEFAULT: 0, STYPE_ROW_SPARSE: 1, STYPE_CSR: 2}
_KCPU = 1  # Context::kCPU (include/mxnet/base.h)


class _Reader:
    def __init__(self, data):
        self._d = data
        self._o = 0

    def read(self, n):
        if self._o + n > len(self._d):
            raise ValueError("truncated NDArray file")
        out = self._d[self._o:self._o + n]
        self._o += n
        return out

    def u32(self):
        return struct.unpack("<I", self.read(4))[0]

    def i32(self):
        return struct.unpack("<i", self.read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.read(8))[0]

    def eof(self):
        return self._o >= len(self._d)


def _write_tshape(out, shape):
    out.append(struct.pack("<I", len(shape)))
    out.append(struct.pack("<%dq" % len(shape), *shape))


def _read_tshape(r):
    ndim = r.u32()
    if ndim == 0:
        return ()
    return tuple(struct.unpack("<%dq" % ndim, r.read(8 * ndim)))


def _serialize_dense(out, a):
    a = _np.ascontiguousarray(a)
    if a.ndim == 0:
        # MXNet has no 0-d arrays (TShape ndim 0 means "none", and both
        # loaders stop right after the shape) — store scalars as (1,)
        a = a.reshape(1)
    out.append(struct.pack("<I", NDARRAY_V2_MAGIC))
    out.append(struct.pack("<i", STYPE_DEFAULT))
    _write_tshape(out, a.shape)
    out.append(struct.pack("<ii", _KCPU, 0))       # Context: cpu(0)
    tf = _DTYPE_TO_TYPE_FLAG.get(a.dtype)
    if tf is None:
        a = a.astype(_np.float32)
        tf = 0
    out.append(struct.pack("<i", tf))
    out.append(a.tobytes())


def _serialize_csr(out, data, indptr, indices, shape):
    """data: (nnz,) values; indptr: (rows+1,) int64; indices: (nnz,) int64."""
    data = _np.ascontiguousarray(data)
    indptr = _np.ascontiguousarray(indptr, dtype=_np.int64)
    indices = _np.ascontiguousarray(indices, dtype=_np.int64)
    out.append(struct.pack("<I", NDARRAY_V2_MAGIC))
    out.append(struct.pack("<i", STYPE_CSR))
    _write_tshape(out, data.shape)                  # storage shape
    _write_tshape(out, shape)                       # logical shape
    out.append(struct.pack("<ii", _KCPU, 0))
    tf = _DTYPE_TO_TYPE_FLAG.get(data.dtype, 0)
    out.append(struct.pack("<i", tf))
    out.append(struct.pack("<i", 6))                # indptr: int64
    _write_tshape(out, indptr.shape)
    out.append(struct.pack("<i", 6))                # indices: int64
    _write_tshape(out, indices.shape)
    out.append(data.tobytes())
    out.append(indptr.tobytes())
    out.append(indices.tobytes())


def _serialize_row_sparse(out, data, indices, shape):
    """data: (nnz, *shape[1:]) values; indices: (nnz,) int64 row ids."""
    data = _np.ascontiguousarray(data)
    indices = _np.ascontiguousarray(indices, dtype=_np.int64)
    out.append(struct.pack("<I", NDARRAY_V2_MAGIC))
    out.append(struct.pack("<i", STYPE_ROW_SPARSE))
    _write_tshape(out, data.shape)                  # storage shape
    _write_tshape(out, shape)                       # logical shape
    out.append(struct.pack("<ii", _KCPU, 0))
    tf = _DTYPE_TO_TYPE_FLAG.get(data.dtype, 0)
    out.append(struct.pack("<i", tf))
    out.append(struct.pack("<i", 6))                # aux type: int64
    _write_tshape(out, indices.shape)
    out.append(data.tobytes())
    out.append(indices.tobytes())


def _deserialize_ndarray(r):
    """Read one NDArray record → (numpy_dense_or_tuple).  Sparse records
    return ('row_sparse', data, indices, shape) / ('csr', ...)."""
    magic = r.u32()
    if magic == NDARRAY_V2_MAGIC:
        stype = r.i32()
        nad = _NUM_AUX.get(stype)
        if nad is None:
            raise ValueError("unknown storage type %d" % stype)
        sshape = _read_tshape(r) if nad > 0 else None
        shape = _read_tshape(r)
        if not shape:
            return _np.zeros((), _np.float32)
        r.i32(); r.i32()                            # Context (ignored)
        tf = r.i32()
        aux_types, aux_shapes = [], []
        for i in range(nad):
            aux_types.append(r.i32())
            aux_shapes.append(_read_tshape(r))
        dtype = _TYPE_FLAG_TO_DTYPE[tf]
        dshape = sshape if nad > 0 else shape
        n = int(_np.prod(dshape)) if dshape else 1
        data = _np.frombuffer(r.read(n * _np.dtype(dtype).itemsize),
                              dtype=dtype).reshape(dshape)
        if nad == 0:
            return data
        auxes = []
        for t, s in zip(aux_types, aux_shapes):
            adt = _TYPE_FLAG_TO_DTYPE[t]
            an = int(_np.prod(s)) if s else 1
            auxes.append(_np.frombuffer(
                r.read(an * _np.dtype(adt).itemsize), dtype=adt).reshape(s))
        if stype == STYPE_ROW_SPARSE:
            return ("row_sparse", data, auxes[0], shape)
        return ("csr", data, auxes[0], auxes[1], shape)
    # legacy records (ndarray.cc LegacyLoad)
    if magic == NDARRAY_V1_MAGIC:
        shape = _read_tshape(r)
    else:
        ndim = magic                                # pre-V1: magic is ndim
        shape = tuple(struct.unpack("<%dI" % ndim, r.read(4 * ndim))) \
            if ndim else ()
    if not shape:
        return _np.zeros((), _np.float32)
    r.i32(); r.i32()                                # Context
    tf = r.i32()
    dtype = _TYPE_FLAG_TO_DTYPE[tf]
    n = int(_np.prod(shape))
    return _np.frombuffer(r.read(n * _np.dtype(dtype).itemsize),
                          dtype=dtype).reshape(shape)


def dumps_ndarray_list(arrays, names):
    """Serialize the reference list container to bytes. ``arrays``
    elements are numpy arrays or ('row_sparse', data, indices, shape) /
    ('csr', ...) tuples."""
    out = [struct.pack("<QQ", LIST_MAGIC, 0),
           struct.pack("<Q", len(arrays))]
    for a in arrays:
        if isinstance(a, tuple) and a and a[0] == "row_sparse":
            _serialize_row_sparse(out, a[1], a[2], a[3])
        elif isinstance(a, tuple) and a and a[0] == "csr":
            _serialize_csr(out, a[1], a[2], a[3], a[4])
        else:
            _serialize_dense(out, a)
    out.append(struct.pack("<Q", len(names)))
    for name in names:
        b = name.encode("utf-8")
        out.append(struct.pack("<Q", len(b)))
        out.append(b)
    return b"".join(out)


def save_ndarray_list(fname, arrays, names):
    """Write the list container crash-safely: the bytes go to a temporary
    file beside ``fname``, are fsynced, then renamed over it, so the
    final path never holds a torn file."""
    atomic_write(fname, dumps_ndarray_list(arrays, names))


def load_ndarray_file(fname):
    """Read a ``.params`` file -> (arrays, names)."""
    with open(fname, "rb") as f:
        return load_ndarray_list(f.read())


def load_ndarray_list(data):
    """Parse the reference list container from bytes → (arrays, names)."""
    r = _Reader(data)
    header = r.u64()
    if header != LIST_MAGIC:
        raise ValueError("not an MXNet NDArray file (bad magic 0x%x)"
                         % header)
    r.u64()                                         # reserved
    n = r.u64()
    arrays = [_deserialize_ndarray(r) for _ in range(n)]
    names = []
    if not r.eof():
        k = r.u64()
        for _ in range(k):
            ln = r.u64()
            names.append(r.read(ln).decode("utf-8"))
    if names and len(names) != len(arrays):
        raise ValueError("invalid NDArray file: %d names for %d arrays"
                         % (len(names), len(arrays)))
    return arrays, names
