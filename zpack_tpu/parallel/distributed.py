"""Multi-host distributed compression.

The reference has no distributed anything (SURVEY.md §2: "Parallelism /
distributed communication: none").  Here the mesh pipeline spans hosts via
``jax.distributed``: every process contributes its local devices to one
global ("entry" × "block") mesh, each host tokenizes/serializes its own
block range (data-parallel across hosts), and host 0 performs the ordered
ragged gather of the variable-size compressed blocks — assembling a
spec-conformant frame/archive exactly as the single-host path does.
"""

from __future__ import annotations

import struct

import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Wrapper over jax.distributed.initialize (idempotent)."""
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise


def shard_ranges(n_blocks: int, num_processes: int) -> list[tuple[int, int]]:
    """Contiguous block ranges per process (host h owns range h)."""
    per = -(-n_blocks // num_processes)
    return [(min(h * per, n_blocks), min((h + 1) * per, n_blocks))
            for h in range(num_processes)]


def compress_multihost_zstd(data: bytes, level: int = 19,
                            chunk_size: int = 8 << 20) -> bytes | None:
    """BASELINE config-5 shape: zstd blocks sharded data-parallel across
    hosts.  Each host compresses its contiguous chunk range into separate
    zstd frames (native backend, GIL-free threads over local cores), the
    ragged frames allgather, and every host assembles the identical
    concatenated multi-frame stream in chunk order."""
    import jax
    from jax.experimental import multihost_utils

    from .. import native

    nproc = jax.process_count()
    pid = jax.process_index()
    data = bytes(data)
    n_chunks = max(1, -(-len(data) // chunk_size))
    lo, hi = shard_ranges(n_chunks, nproc)[pid]
    local = b"".join(
        native.zstd_compress(data[i * chunk_size : (i + 1) * chunk_size], level) or b""
        for i in range(lo, hi)
    )
    lens = np.asarray(
        multihost_utils.process_allgather(np.array([len(local)], np.int64))
    ).reshape(-1)
    maxlen = int(lens.max()) if len(lens) else 0
    padded = np.zeros(max(maxlen, 1), dtype=np.uint8)
    padded[: len(local)] = np.frombuffer(local, dtype=np.uint8)
    gathered = np.asarray(multihost_utils.process_allgather(padded)).reshape(nproc, -1)
    return b"".join(gathered[h][: lens[h]].tobytes() for h in range(nproc))


def compress_multihost(data: bytes, level: int = 1, block_size: int = 64 << 10) -> bytes | None:
    """Compress ``data`` with each host handling its contiguous block range
    on its local devices, then gather the ragged compressed blocks to every
    host (allgather) and assemble the lz4f frame in block order.

    Every process must call this with identical ``data``; returns the frame
    on every process (only host 0 typically writes it out).
    """
    import jax
    from jax.experimental import multihost_utils

    from ..codecs.lz4 import frame as lz4frame
    from ..kernels import lz4_jax
    from .pipeline import MeshCompressor, make_mesh

    nproc = jax.process_count()
    pid = jax.process_index()
    data = bytes(data)
    B = block_size
    n_blocks = max(1, -(-len(data) // B))
    ranges = shard_ranges(n_blocks, nproc)
    lo, hi = ranges[pid]

    # local tokenize + serialize over this host's local devices only
    local_mesh = make_mesh(jax.local_devices())
    mc = MeshCompressor(local_mesh, level=level, block_size=B)
    local_blocks: list[bytes] = []
    for i in range(lo, hi):
        chunk = data[i * B : (i + 1) * B]
        src, mlen, _nb, _ = mc.tokenize(chunk)
        ml = mlen[0]
        if len(chunk) != B:
            posa = np.arange(B)
            ml = np.minimum(ml, np.maximum(len(chunk) - 5 - posa, 0))
            ml = np.where(posa >= max(len(chunk) - 12, 0), 0, ml)
            ml = np.where(ml < 4, 0, ml)
        comp = lz4_jax.serialize_block_host(chunk, src[0], ml, mc.capj)
        if len(comp) >= len(chunk):
            comp = b"\x01" + chunk  # marker: stored
        else:
            comp = b"\x00" + comp
        local_blocks.append(comp)

    # ragged allgather: pad local payloads to a common max (lengths first)
    local_cat = b"".join(local_blocks)
    lens = np.zeros((nproc,), dtype=np.int64)
    lens[pid] = len(local_cat)
    lens = multihost_utils.process_allgather(np.array([len(local_cat)], np.int64))
    lens = np.asarray(lens).reshape(-1)
    maxlen = int(lens.max()) if len(lens) else 0
    padded = np.zeros(maxlen, dtype=np.uint8)
    padded[: len(local_cat)] = np.frombuffer(local_cat, dtype=np.uint8)
    gathered = multihost_utils.process_allgather(padded)
    gathered = np.asarray(gathered).reshape(nproc, maxlen)

    # per-block lengths allgather for the ragged split
    blk_lens_local = np.array([len(b) for b in local_blocks], dtype=np.int64)
    max_blocks = max((r[1] - r[0]) for r in ranges)
    bl = np.full(max_blocks, -1, dtype=np.int64)
    bl[: len(blk_lens_local)] = blk_lens_local
    blk_lens = np.asarray(multihost_utils.process_allgather(bl)).reshape(nproc, max_blocks)

    # host-side ordered assembly (same on every process)
    out = bytearray(lz4frame._header(max(B, 64 << 10), True, False, None))
    for h in range(nproc):
        payload = gathered[h][: lens[h]].tobytes()
        pos = 0
        for L in blk_lens[h]:
            if L < 0:
                break
            blob = payload[pos : pos + int(L)]
            pos += int(L)
            if blob[:1] == b"\x01":
                out += struct.pack("<I", (len(blob) - 1) | 0x80000000) + blob[1:]
            else:
                out += struct.pack("<I", len(blob) - 1) + blob[1:]
    out += struct.pack("<I", 0)
    return bytes(out)


def _allgather_ragged(local: bytes) -> list[bytes]:
    """Allgather one variable-length byte payload per process."""
    from jax.experimental import multihost_utils

    lens = np.asarray(multihost_utils.process_allgather(
        np.array([len(local)], np.int64))).reshape(-1)
    maxlen = int(lens.max()) if len(lens) else 0
    padded = np.zeros(max(maxlen, 1), dtype=np.uint8)
    padded[: len(local)] = np.frombuffer(local, dtype=np.uint8)
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    gathered = gathered.reshape(len(lens), -1)
    return [gathered[h][: lens[h]].tobytes() for h in range(len(lens))]


def build_archive_multihost(files: list[tuple[str, bytes]], level: int = 3,
                            dict_size: int = 4096) -> bytes:
    """Build one spec-conformant multi-entry .zpk archive across hosts
    (VERDICT r4 item 5 — the reference is single-threaded by design,
    lib/zpack.h:337-341; this is the claimed differentiator):

    1. host 0 trains a shared zstd dictionary on entry samples and
       broadcasts it (allgather — the cross-host analog of the dict
       broadcast in the mesh pipeline),
    2. each host compresses its contiguous entry range against the
       dictionary into a LOCAL archive,
    3. the local archives allgather, and every host assembles the same
       final archive in entry order with the archive-to-archive raw-copy
       primitive (zpack_write_files_from_archive parity,
       lib/zpack_write.c:345-428) — compressed bytes move exactly once.

    Every process must pass identical ``files``; returns the archive
    bytes on every host.
    """
    import jax

    from .. import constants as C
    from ..constants import CompressionMethod
    from ..reader import Reader
    from ..writer import CompressOptions, Writer
    from ..codecs.zstd.dict import train_dictionary

    nproc = jax.process_count()
    pid = jax.process_index()

    # 1. train on host 0, broadcast to all
    if pid == 0:
        samples = []
        for _, data in files:
            for i in range(0, min(len(data), 1 << 16), 1024):
                samples.append(data[i : i + 1024])
        blob = train_dictionary(samples, dict_size)
    else:
        blob = b""
    blob = _allgather_ragged(blob)[0]

    # 2. compress the local entry range into a local archive
    lo, hi = shard_ranges(len(files), nproc)[pid]
    lw = Writer.to_heap()
    lw.write_header()
    lw.write_data_header()
    lw.set_dictionary(blob)
    for name, data in files[lo:hi]:
        lw.add_file(name, data, CompressOptions(CompressionMethod.ZSTD, level))
    lw.write_cdr()
    lw.write_eocdr()

    # 3. allgather local archives; assemble identically on every host
    locals_ = _allgather_ragged(lw.buffer)
    w = Writer.to_heap()
    w.write_header()
    w.write_data_header()
    w.set_dictionary(blob)
    w._ensure_dict_entry()
    for h in range(nproc):
        r = Reader.from_memory(locals_[h], shared=True)
        entries = [e for e in r.file_entries
                   if e.filename != C.DICT_ENTRY_NAME]
        w.write_files_from_archive(r, entries)
    w.write_cdr()
    w.write_eocdr()
    return w.buffer
