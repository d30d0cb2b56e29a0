"""Reader and writer of fV-SRN ``.cvol`` volume files (port of the JAX
package's ``data/cvol.py``; no renderer module needed).

Format:
  char[4]  magic "cvol"
  uint64   sizeX, sizeY, sizeZ
  double   voxelSizeX, voxelSizeY, voxelSizeZ
  uint32   datatype   (0 = uchar, 1 = ushort, 2 = float)
  uint32   flags      (bit 0: LZ4-block compressed slices)
  uint32   reserved
  pad with 0xff up to byte 64
  payload: raw voxels (x-fastest) or, if compressed, per-slice
           [uint32 compressed_size][LZ4 block] chunks.

The LZ4 blocks are decoded by the port's native helper (``native/lib.py``,
built with g++ at first use; a failed build raises); the pure-Python
decoder here, ``_lz4_decompress_block_py``, is its plain version.
"""

from __future__ import annotations

import struct

import numpy as np

from ..native import lib as native

_DTYPES = {0: np.uint8, 1: np.uint16, 2: np.float32}
_HEADER_SIZE = 64
_HISTORY = 65536   # LZ4's streaming window


def _lz4_decompress_block_py(src: bytes, dst_size: int,
                             history: bytes = b'') -> bytes:
    """Decode one LZ4 block of ``dst_size`` bytes.

    ``history`` is the streaming dictionary: the slices decoded before this
    one (cvol slices are compressed in LZ4's streaming mode, so a match may
    reach back into the previous slice's bytes)."""
    dst = bytearray(history[-_HISTORY:])
    base = len(dst)
    dst_size += base
    i, n = 0, len(src)
    while i < n and len(dst) < dst_size:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        dst += src[i:i + lit_len]
        i += lit_len
        if i >= n:
            break  # the last sequence holds literals only
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        match_len = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        start = len(dst) - offset
        if offset >= match_len:
            dst += dst[start:start + match_len]
        else:  # an overlapping copy repeats the last ``offset`` bytes
            for k in range(match_len):
                dst.append(dst[start + k])
    return bytes(dst[base:])


def read_cvol(filepath: str) -> np.ndarray:
    """The (X, Y, Z) volume of a ``.cvol`` file, in its stored type."""
    with open(filepath, 'rb') as f:
        header = f.read(_HEADER_SIZE)
        if header[:4] != b'cvol':
            raise ValueError(f"{filepath}: not a cvol file")
        sx, sy, sz = struct.unpack('<QQQ', header[4:28])
        datatype, flags = struct.unpack('<II', header[52:60])
        if datatype not in _DTYPES:
            raise ValueError(f"{filepath}: unknown cvol datatype {datatype}")
        dtype = _DTYPES[datatype]
        itemsize = np.dtype(dtype).itemsize
        n_bytes = sx * sy * sz * itemsize
        if not flags & 1:
            raw = f.read(n_bytes)
            if len(raw) != n_bytes:
                raise ValueError(f"{filepath}: truncated payload")
        else:
            # one chunk a z-slice of sx * sy voxels
            chunk_bytes = sx * sy * itemsize
            parts = []
            remaining = n_bytes
            history = b''
            while remaining > 0:
                (csize,) = struct.unpack('<I', f.read(4))
                out_size = min(chunk_bytes, remaining)
                part = native.lz4_decompress(f.read(csize), out_size, history)
                if len(part) != out_size:
                    raise ValueError(f"{filepath}: a slice decoded to {len(part)} of "
                                     f"{out_size} bytes")
                parts.append(part)
                history = (history + part)[-_HISTORY:]
                remaining -= out_size
            raw = b''.join(parts)
    vol = np.frombuffer(raw, dtype=dtype)
    # x-fastest: linear index = x + sx * (y + sy * z)
    return np.ascontiguousarray(vol.reshape(sz, sy, sx).transpose(2, 1, 0))


def write_cvol(filepath: str, volume: np.ndarray, voxel_size=None):
    """Write an uncompressed ``.cvol`` file of a uint8, uint16 or float32
    (X, Y, Z) volume."""
    volume = np.asarray(volume)
    dt_map = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1,
              np.dtype(np.float32): 2}
    if volume.dtype not in dt_map:
        raise ValueError(f"unsupported dtype {volume.dtype}")
    sx, sy, sz = volume.shape
    if voxel_size is None:
        voxel_size = (1.0 / max(sx, sy, sz),) * 3
    header = b'cvol'
    header += struct.pack('<QQQ', sx, sy, sz)
    header += struct.pack('<ddd', *voxel_size)
    header += struct.pack('<III', dt_map[volume.dtype], 0, 0)
    header += b'\xff' * (_HEADER_SIZE - len(header))
    with open(filepath, 'wb') as f:
        f.write(header)
        f.write(np.ascontiguousarray(volume.transpose(2, 1, 0)).tobytes())
