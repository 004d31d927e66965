"""Minimal NIfTI-1 I/O with gzip and struct, a copy of
``unet_zoo_tpu.utils.nii`` without its nibabel branch (neither host has
nibabel): little-endian single-file ``.nii``/``.nii.gz`` volumes, read with
their pixdim spacing and written back, float or integer."""

from __future__ import annotations

import gzip
import struct
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class NiiHeader:
    """The subset of the NIfTI-1 header the pipelines read."""

    def __init__(self, pixdim, dtype, shape):
        self.pixdim = pixdim  # 8 floats; the voxel sizes at [1..3]
        self.dtype = dtype
        self.shape = shape

    @property
    def structarr(self):
        """nibabel's access, ``header.structarr['pixdim']``."""
        return {"pixdim": np.asarray(self.pixdim)}

    def get_zooms(self):
        return tuple(self.pixdim[1:1 + len(self.shape)])


def _open(path: str, mode: str = "rb"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load_nii(path: str) -> Tuple[np.ndarray, np.ndarray, NiiHeader]:
    """(data, affine, header) of a NIfTI-1 file: data in its stored dtype,
    scaled by ``scl_slope``/``scl_inter`` where they are set, in Fortran order
    as stored; the affine from pixdim."""
    with _open(path) as f:
        hdr = f.read(348)
        if len(hdr) < 348 or struct.unpack("<i", hdr[:4])[0] != 348:
            raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
        dim = struct.unpack("<8h", hdr[40:56])
        datatype = struct.unpack("<h", hdr[70:72])[0]
        pixdim = struct.unpack("<8f", hdr[76:108])
        vox_offset = int(struct.unpack("<f", hdr[108:112])[0])
        scl_slope = struct.unpack("<f", hdr[112:116])[0]
        scl_inter = struct.unpack("<f", hdr[116:120])[0]
        shape = tuple(dim[1:1 + dim[0]])
        np_dtype = _DTYPES.get(datatype)
        if np_dtype is None:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        f.read(max(0, vox_offset - 348))
        count = int(np.prod(shape))
        data = np.frombuffer(f.read(count * np.dtype(np_dtype).itemsize), dtype=np_dtype, count=count)
        data = data.reshape(shape, order="F")
        if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
            data = data * (scl_slope if scl_slope != 0.0 else 1.0) + scl_inter
    affine = np.diag(list(pixdim[1:4]) + [1.0])
    return np.asarray(data), affine, NiiHeader(pixdim, np_dtype, shape)


def save_nii(path: str, data: np.ndarray, affine: Optional[np.ndarray] = None,
             header: Optional[NiiHeader] = None) -> None:
    """Write ``data`` as a little-endian NIfTI-1 single file (gzip for a
    ``.gz`` path); a dtype NIfTI-1 has no code for is written as float32.
    The voxel sizes come from ``header``, else the affine's diagonal, else 1."""
    data = np.asarray(data)
    code = _CODES.get(data.dtype)
    if code is None:
        data = data.astype(np.float32)
        code = 16
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    if header is not None:
        pixdim = list(header.pixdim)
    elif affine is not None:
        pixdim = [1.0] + [float(abs(affine[i, i])) for i in range(3)] + [1.0] * 4
    else:
        pixdim = [1.0] * 8
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    hdr[344:348] = b"n+1\x00"
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(data.tobytes(order="F"))
