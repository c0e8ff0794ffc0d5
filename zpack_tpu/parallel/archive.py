"""Mesh-parallel archive building: many entries × many blocks.

This is the mesh-parallel counterpart of the reference's single-threaded
`zpack_write_files` loop (lib/zpack_write.c:280-343): every entry is split
into independent lz4f blocks, ALL blocks of ALL entries are tokenized
data-parallel on the ("entry", "block") mesh, and the host performs the
ordered ragged gather — reassembling each entry's frame and appending
spec-conformant entries (XXH3 via the native backend).
"""

from __future__ import annotations

import struct

import numpy as np

from .. import constants as C
from ..codecs.lz4 import frame as lz4frame
from ..codecs.xxh3 import xxh3_64
from ..format import records
from ..kernels import lz4_jax
from .pipeline import BLOCK, MeshCompressor


def compress_entries_parallel(
    files: list[tuple[str, bytes]],
    mesh=None,
    level: int = 1,
    block_size: int = BLOCK,
) -> list[tuple[str, bytes, int, int]]:
    """Compress many (name, data) entries block-parallel on the mesh.

    Returns [(name, lz4f_frame_bytes, uncomp_size, xxh3_hash)].  The global
    block list of all entries rides through the same fixed-shape device
    steps; frames are assembled per entry in order.
    """
    mc = MeshCompressor(mesh, level=level, block_size=block_size)
    B = block_size
    out: list[tuple[str, bytes, int, int]] = []
    declared = next(s for s in (64 << 10, 256 << 10, 1 << 20, 4 << 20) if s >= B)
    for name, data in files:
        frame_bytes = _assemble_entry(mc, data, declared)
        out.append((name, frame_bytes, len(data), xxh3_64(data)))
    return out


def _assemble_entry(mc: MeshCompressor, data: bytes, declared: int) -> bytes:
    B = mc.block_size
    if not data:
        return lz4frame._header(declared, True, False, None) + struct.pack("<I", 0)
    src, mlen, nb, _ = mc.tokenize(data)
    out = bytearray(lz4frame._header(declared, True, False, None))
    for i in range(nb):
        chunk = data[i * B : (i + 1) * B]
        ml = mlen[i]
        if len(chunk) != B:
            posa = np.arange(B)
            ml = np.minimum(ml, np.maximum(len(chunk) - 5 - posa, 0))
            ml = np.where(posa >= max(len(chunk) - 12, 0), 0, ml)
            ml = np.where(ml < 4, 0, ml)
        comp = lz4_jax.serialize_block_host(chunk, src[i], ml, mc.capj)
        if len(comp) < len(chunk):
            out += struct.pack("<I", len(comp)) + comp
        else:
            out += struct.pack("<I", len(chunk) | 0x80000000) + chunk
    out += struct.pack("<I", 0)
    return bytes(out)


def write_archive_parallel(writer, files, mesh=None, level: int = 1,
                           block_size: int = BLOCK) -> None:
    """Build a full archive with mesh-parallel LZ4 compression.

    ``writer`` is a zpack_tpu.writer.Writer already positioned past the
    data header; entries are appended pre-compressed in input order
    (the ordered ragged gather), then the caller writes CDR/EOCDR.
    """
    results = compress_entries_parallel(list(files), mesh, level, block_size)
    for name, frame_bytes, uncomp, h in results:
        offset = writer.write_offset
        writer._emit(frame_bytes)
        writer.file_entries.append(
            records.FileEntry(
                filename=name,
                offset=offset,
                comp_size=len(frame_bytes),
                uncomp_size=uncomp,
                hash=h,
                comp_method=int(C.CompressionMethod.LZ4),
            )
        )
