"""Mesh-parallel compression pipeline.

The reference is single-threaded by design (no threads/MPI/NCCL anywhere;
lib/zpack.h:337-341 only documents per-context thread rules).  Parallelism
is therefore *our* addition (BASELINE.json north star): archive
entries and intra-entry blocks are sharded over a `jax.sharding.Mesh`
("entry" × "block" axes), each device tokenizes its blocks with the JAX
LZ4 kernel, an XLA collective (psum) aggregates size stats, and the
host performs the ordered ragged gather of variable-size compressed blocks
to assemble a spec-conformant archive (independent lz4f blocks decode with
the reference CLI).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kernels import lz4_jax

#: default mesh block: 64 KiB like the native lz4f path.  Block
#: independence restarts history every block — long-period data (stride
#: ~2 KB records) loses 8x in ratio at 8 KiB blocks while 64 KiB stays at
#: ratio parity, so the robust size is the default.
BLOCK = 64 << 10


def make_mesh(devices=None, entry_axis: int = 1) -> Mesh:
    """2D mesh over the available devices: ("entry", "block").

    Entries (archive files) shard over the outer axis, intra-entry blocks
    over the inner.  Blocks are independent and the devices are joined
    all to all, so by default every device sits on the "block" axis.
    """
    devices = list(devices if devices is not None else jax.devices())
    block_axis = len(devices) // entry_axis
    arr = np.array(devices[: entry_axis * block_axis]).reshape(entry_axis, block_axis)
    return Mesh(arr, ("entry", "block"))


def _step_fn(mesh: Mesh, depth: int, block_size: int, n_words: int = 2,
             dict_pad: int = 0):
    """Build the jitted sharded tokenize step for (entries, blocks, B).

    For B <= 8192 the device re-sorts to position order and ships ONE
    uint16 per byte (kernels/lz4_jax.tokenize_block_u16) — 4x less d2h.
    Larger blocks stay in hash-sorted (pos, packed) i32 pairs with the
    host inverting the permutation (tokenize_block_noscatter).

    ``dict_pad`` > 0 builds the shared-dictionary variant: the step takes a
    second (dict_pad,) operand REPLICATED over the mesh (the broadcast
    shared dictionary of the BASELINE north star), prepends it to every
    block's match window, and ships results for the data positions only."""
    window = dict_pad + block_size
    if window <= 8192 and 4 * n_words <= 10:
        mode = "u16"
    elif window <= 65536 and 4 * n_words <= 10:
        mode = "pair"
    else:
        mode = "noscatter"
    if dict_pad and mode == "noscatter":
        raise ValueError(
            f"dict window {window} too large for the device tokenizer "
            f"(dict + block_size must be <= 65536)")

    def _est(mlen, B):
        matched = jnp.sum(jnp.where(mlen >= 4, mlen, 0), axis=-1)
        n_seq = jnp.sum((mlen >= 4).astype(jnp.int32), axis=-1)
        est_local = jnp.sum(B - matched + 3 * n_seq)
        return jax.lax.psum(jax.lax.psum(est_local, "block"), "entry")

    def local_step(blocks, dict_arr=None):
        # blocks: (e_local, b_local, B); dict_arr: (dict_pad,) replicated
        e, b, B = blocks.shape
        flat = blocks.reshape(e * b, B)
        if dict_arr is not None:
            # broadcast dict rides the window of every block; results for
            # the dict positions are sliced off before leaving the device
            flat = jnp.concatenate(
                [jnp.broadcast_to(dict_arr, (e * b, dict_pad)), flat], axis=1)
        if mode == "u16":
            tok = jax.vmap(
                partial(lz4_jax.tokenize_block_u16, depth=depth, n_words=n_words)
            )(flat)[:, dict_pad:]
            mlen = (tok & jnp.uint16(7)).astype(jnp.int32)
            mlen = jnp.where(mlen > 0, mlen + 3, 0)
            return tok.reshape(e, b, B), _est(mlen, B)
        if mode == "pair":
            src16, code = jax.vmap(
                partial(lz4_jax.tokenize_block_resort, depth=depth, n_words=n_words)
            )(flat)
            src16, code = src16[:, dict_pad:], code[:, dict_pad:]
            mlen = code.astype(jnp.int32)
            mlen = jnp.where(mlen > 0, mlen + 3, 0)
            return src16.reshape(e, b, B), code.reshape(e, b, B), _est(mlen, B)
        pos, packed = jax.vmap(
            partial(lz4_jax.tokenize_block_noscatter, depth=depth, n_words=n_words)
        )(flat)
        # size estimate: literals + per-match overhead, reduced over the mesh
        mlen = packed >> 17
        return (
            pos.reshape(e, b, B).astype(jnp.int32),
            packed.reshape(e, b, B).astype(jnp.int32),
            _est(mlen, B),
        )

    blk = P("entry", "block", None)
    out_specs = (blk, P()) if mode == "u16" else (blk, blk, P())
    in_specs = blk if dict_pad == 0 else (blk, P())
    fn = jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=out_specs,
        )
    )
    return fn, mode


class MeshCompressor:
    """Block-parallel LZ4 compressor over a device mesh.

    One `compress(data)` call: pad data into (entries=1, nb, BLOCK) (nb
    rounded up to the mesh block-axis), tokenize all blocks data-parallel
    on the mesh, then host-assemble an lz4f frame with independent blocks
    (readable by the reference CLI / any lz4 tool).
    """

    #: bytes processed per device per jitted step — one fixed-shape compiled
    #: program reused across however much data flows through
    BYTES_PER_DEVICE_STEP = 1 << 20

    #: u32 window words carried through the device sort; on-device match
    #: lengths cap at 4*n_words and the host makes them exact
    N_WORDS = 2

    def __init__(self, mesh: Mesh | None = None, level: int = 1, block_size: int = BLOCK):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.level = level
        self.block_size = block_size
        self.capj = 4 * self.N_WORDS
        self.blocks_per_device_step = max(1, self.BYTES_PER_DEVICE_STEP // block_size)
        depth = 2 if level <= 2 else 8
        self._step, self._mode = _step_fn(self.mesh, depth, block_size, self.N_WORDS)

    def _pad_factor(self) -> tuple[int, int]:
        e_ax = self.mesh.shape["entry"]
        b_ax = self.mesh.shape["block"]
        return e_ax, b_ax

    def _dict_step(self, dict_len: int):
        """Jitted step variant carrying the mesh-replicated shared
        dictionary (cached per dict length)."""
        cache = getattr(self, "_dict_steps", None)
        if cache is None:
            cache = self._dict_steps = {}
        if dict_len not in cache:
            depth = 2 if self.level <= 2 else 8
            cache[dict_len] = _step_fn(self.mesh, depth, self.block_size,
                                       self.N_WORDS, dict_pad=dict_len)
        return cache[dict_len]

    def _steps_raw(self, data: bytes, step=None, mode=None, extra=()):
        """Dispatch ALL device steps up front (async dispatch queues them),
        then yield per-step results still in the device wire format:
        (first_block, mode, host_arrays_tuple, est).  Consuming step s on
        the host overlaps device compute of steps > s — the whole archive
        is a two-stage pipeline."""
        step = self._step if step is None else step
        mode = self._mode if mode is None else mode
        B = self.block_size
        n = len(data)
        nb = max(1, math.ceil(n / B))
        e_ax, b_ax = self._pad_factor()
        per_step = e_ax * b_ax * self.blocks_per_device_step
        nb_pad = math.ceil(nb / per_step) * per_step
        buf = np.zeros((nb_pad, B), dtype=np.uint8)
        flat = np.frombuffer(data, dtype=np.uint8)
        nfull = n // B
        buf[:nfull] = flat[: nfull * B].reshape(nfull, B)
        if nfull < nb:
            tail = flat[nfull * B :]
            buf[nfull, : len(tail)] = tail
        sharding = NamedSharding(self.mesh, P("entry", "block", None))
        from ..utils.observe import metrics

        results = []
        with metrics.phase("mesh.dispatch", n):
            for s in range(nb_pad // per_step):
                chunk = buf[s * per_step : (s + 1) * per_step]
                batch = chunk.reshape(e_ax, per_step // e_ax, B)
                batch = jax.device_put(batch, sharding)
                results.append(step(batch, *extra))
        for s, res in enumerate(results):
            est = res[-1]
            with metrics.phase("mesh.d2h", per_step * B):
                host = tuple(np.asarray(a).reshape(per_step, B)
                             for a in res[:-1])
            yield s * per_step, mode, host, int(est)

    def _steps(self, data: bytes, step=None, mode=None, extra=()):
        """Like :meth:`_steps_raw` but unpacked to the standard
        (first_block, src, mlen, est) int32 match tables."""
        from ..utils.observe import metrics

        unpack = {"u16": lambda h: lz4_jax.unpack_u16_host(*h),
                  "pair": lambda h: lz4_jax.unpack_resort_host(*h)}
        for lo, mode_s, host, est in self._steps_raw(data, step, mode, extra):
            with metrics.phase("mesh.host_unpack", host[0].size):
                src_s, mlen_s = unpack.get(
                    mode_s, lambda h: lz4_jax.unsort_host(*h))(host)
            yield lo, src_s, mlen_s, est

    def tokenize(self, data: bytes, step=None, mode=None, extra=()) -> tuple[np.ndarray, np.ndarray, int, int]:
        B = self.block_size
        nb = max(1, math.ceil(len(data) / B))
        src = mlen = None
        est_total = 0
        for lo, src_s, mlen_s, est in self._steps(data, step, mode, extra):
            if src is None:
                per_step = len(src_s)
                nb_pad = math.ceil(nb / per_step) * per_step
                src = np.empty((nb_pad, B), dtype=np.int32)
                mlen = np.empty((nb_pad, B), dtype=np.int32)
            src[lo : lo + len(src_s)] = src_s
            mlen[lo : lo + len(mlen_s)] = mlen_s
            est_total += est
        return src, mlen, nb, est_total

    def compress(self, data: bytes) -> bytes:
        """Full lz4f frame via mesh tokenization + pipelined host assembly:
        the native serializer (zn_lz4_serialize_blocks, threaded) packages
        each step's blocks while the device tokenizes the next step."""
        import struct

        from .. import native
        from ..codecs.lz4 import frame as lz4frame

        data = bytes(data)
        B = self.block_size
        n = len(data)
        nb = max(1, math.ceil(n / B))
        # declared frame block-size id must be a standard size ≥ our blocks
        declared = next(s for s in (64 << 10, 256 << 10, 1 << 20, 4 << 20) if s >= B)
        out = bytearray(lz4frame._header(declared, True, False, None))
        from ..utils.observe import metrics

        for lo, mode_s, host, _est in self._steps_raw(data):
            hi = min(nb, lo + len(host[0]))
            if hi <= lo:
                break
            seg = data[lo * B : min(n, hi * B)]
            with metrics.phase("mesh.serialize", len(seg)):
                # fast path: the native serializer consumes the device wire
                # format directly (no int32 unpack pass)
                body = native.lz4_serialize_blocks_packed(seg, mode_s, host, B)
                if body is None:
                    if mode_s == "u16":
                        src_s, mlen_s = lz4_jax.unpack_u16_host(*host)
                    elif mode_s == "pair":
                        src_s, mlen_s = lz4_jax.unpack_resort_host(*host)
                    else:
                        src_s, mlen_s = lz4_jax.unsort_host(*host)
                    body = native.lz4_serialize_blocks(seg, src_s, mlen_s, B)
            if body is not None:
                out += body
                continue
            # pure-python fallback (ZPACK_TPU_NO_NATIVE / build failure)
            for i in range(hi - lo):
                chunk = seg[i * B : (i + 1) * B]
                ml = mlen_s[i]
                if len(chunk) != B:
                    # tail block: clamp device results to the real length
                    posa = np.arange(B)
                    ml = np.minimum(ml, np.maximum(len(chunk) - 5 - posa, 0))
                    ml = np.where(posa >= max(len(chunk) - 12, 0), 0, ml)
                    ml = np.where(ml < 4, 0, ml)
                comp = lz4_jax.serialize_block_host(chunk, src_s[i], ml, self.capj)
                if len(comp) < len(chunk):
                    out += struct.pack("<I", len(comp)) + comp
                else:
                    out += struct.pack("<I", len(chunk) | 0x80000000) + chunk
        out += struct.pack("<I", 0)
        return bytes(out)


    def compress_zstd(self, data: bytes, level: int = 3, dictionary=None,
                      device_entropy: bool | None = None) -> bytes:
        """zstd frame via mesh tokenization: each device-tokenized block
        becomes one zstd block — the BASELINE "zstd blocks sharded
        data-parallel" configuration.  Offsets stay within a block (window =
        block size), a deliberate trade for full block independence across
        the mesh.

        Both compute stages run on the mesh: match-finding (LZ4 tokenizer)
        AND the huffman entropy stage — every block's literal bitstreams are
        built in one batched sharded dispatch (kernels/huffman_jax.py), the
        role of the reference's vendored HUF_* entropy coder
        (lib/zpack_write.c:179).  ``device_entropy=False`` (or env
        ZPACK_TPU_NO_DEVICE_ENTROPY) falls back to host entropy coding.

        With ``dictionary``, the shared dict is broadcast over the mesh
        (a replicated device operand) and rides
        every block's match window; each block becomes an independent
        dict-referencing zstd *frame* so offsets stay window-local."""
        import os
        import struct

        from ..codecs.zstd import encode as zenc
        from ..kernels.lz4_jax import resolve_matches_host

        if dictionary is not None:
            return self._compress_zstd_dict(data, level, dictionary)
        if device_entropy is None:
            device_entropy = not os.environ.get("ZPACK_TPU_NO_DEVICE_ENTROPY")
        data = bytes(data)
        B = self.block_size
        n = len(data)
        if n == 0:
            return zenc.compress(b"", level)
        src, mlen, nb, _est = self.tokenize(data)
        # pass 1: device match tables -> sequence tuples + literal runs
        all_seqs: list[list] = []
        all_lits: list[bytes] = []
        for i in range(nb):
            chunk = data[i * B : (i + 1) * B]
            cl = len(chunk)
            arr = np.frombuffer(chunk, dtype=np.uint8)
            ml = mlen[i]
            if cl != B:
                posa = np.arange(B)
                ml = np.minimum(ml, np.maximum(cl - 5 - posa, 0))
                ml = np.where(posa >= max(cl - 12, 0), 0, ml)
                ml = np.where(ml < 4, 0, ml)
            # sequence tuples in the python encoder's shape; vectorized
            # fixpoint parse + exact extension (zstd has no end-of-block
            # literal rule, so limit = cl)
            mps, mss, mls = resolve_matches_host(arr, src[i], ml, cl, cl, self.capj)
            lit_starts = np.concatenate([[0], mps + mls])
            seqs = [
                (int(ls), int(p - ls), int(p), int(j), int(l))
                for ls, p, j, l in zip(lit_starts[:-1], mps, mss, mls)
            ]
            seqs.append((int(lit_starts[-1]), cl - int(lit_starts[-1]), None, None, None))
            all_seqs.append(seqs)
            all_lits.append(zenc._block_literals(arr, seqs))
        # entropy stage: ONE sharded device dispatch for every block's
        # huffman literal bitstreams
        from ..utils.observe import metrics

        enc = self._device_huffman() if device_entropy else None
        with metrics.phase("mesh.entropy_encode", sum(len(l) for l in all_lits)):
            lit_sections = zenc.encode_literal_sections(all_lits, enc)
        # pass 2a: sequence fields + table choice, host-sequential (the
        # repcode state threads block to block, zstd decoder semantics) —
        # but the compressed-vs-raw decision uses sequence_section_header's
        # bitstream upper bound so the repcode rollback for raw blocks
        # happens BEFORE anything is batched to the device
        plans: list[tuple] = []  # ("dev", header, fields, tables) | ("host", body|None)
        rep = [1, 4, 8]
        for i in range(nb):
            chunk = data[i * B : (i + 1) * B]
            cl = len(chunk)
            arr = np.frombuffer(chunk, dtype=np.uint8)
            rep_backup = list(rep)
            fields = zenc.sequence_fields(arr, all_seqs[i], rep)
            lls, mls, ovs, _n_lits = fields
            if not lls or lit_sections[i] is None:
                rep[:] = rep_backup
                body = zenc._encode_block_body(arr, 0, cl, all_seqs[i], rep,
                                               lit_section=lit_sections[i])
                plans.append(("host", body if body and len(body) < cl else None))
                if not (body and len(body) < cl):
                    rep[:] = rep_backup
                continue
            header, tables, ub_bits = zenc.sequence_section_header(lls, mls, ovs)
            size_ub = len(lit_sections[i]) + len(header) + (ub_bits + 7) // 8
            if device_entropy and size_ub < cl:
                plans.append(("dev", header, (lls, mls, ovs), tables))
            else:
                # marginal (or host-entropy mode): exact host encode decides
                rep[:] = rep_backup
                body = zenc._encode_block_body(arr, 0, cl, all_seqs[i], rep,
                                               lit_section=lit_sections[i])
                plans.append(("host", body if body and len(body) < cl else None))
                if not (body and len(body) < cl):
                    rep[:] = rep_backup
        # pass 2b: ONE sharded device dispatch packs every planned block's
        # FSE sequence bitstream (kernels/fse_jax.py)
        dev_idx = [i for i, p in enumerate(plans) if p[0] == "dev"]
        streams: list[bytes] = []
        if dev_idx:
            with metrics.phase("mesh.fse_encode",
                               sum(len(plans[i][2][0]) for i in dev_idx)):
                streams = self._device_fse().encode_batch(
                    [plans[i][2] for i in dev_idx],
                    [plans[i][3] for i in dev_idx])
        stream_of = dict(zip(dev_idx, streams))
        # pass 2c: frame assembly
        out = bytearray(zenc._frame_header(n, max(17, B.bit_length())))
        for i in range(nb):
            chunk = data[i * B : (i + 1) * B]
            cl = len(chunk)
            last = 1 if i == nb - 1 else 0
            plan = plans[i]
            if plan[0] == "dev":
                body = lit_sections[i] + plan[1] + stream_of[i]
                assert len(body) < cl, "sequence upper bound violated"
            else:
                body = plan[1]
            if body is not None:
                bh = last | (2 << 1) | (len(body) << 3)
                out += struct.pack("<I", bh)[:3]
                out += body
            else:
                bh = last | (0 << 1) | (cl << 3)
                out += struct.pack("<I", bh)[:3]
                out += chunk
        return bytes(out)

    def _device_huffman(self):
        """Cached mesh-sharded huffman entropy encoder."""
        enc = getattr(self, "_huff_enc", None)
        if enc is None:
            from ..kernels.huffman_jax import DeviceHuffmanEncoder

            enc = self._huff_enc = DeviceHuffmanEncoder(mesh=self.mesh)
        return enc

    def _device_fse(self):
        """Cached mesh-sharded FSE sequence-section encoder."""
        enc = getattr(self, "_fse_enc", None)
        if enc is None:
            from ..kernels.fse_jax import DeviceSequenceEncoder

            enc = self._fse_enc = DeviceSequenceEncoder(mesh=self.mesh)
        return enc

    def _compress_zstd_dict(self, data: bytes, level: int, dictionary) -> bytes:
        """Shared-dictionary mesh path: dict replicated over the mesh, one
        dict-referencing frame per 64 KiB block (concatenated frames are
        valid zstd; each decodes against the same dictionary)."""
        import struct

        from ..codecs.zstd import encode as zenc
        from ..codecs.zstd.dict import as_dictionary
        from ..kernels.lz4_jax import resolve_matches_host

        zd = as_dictionary(dictionary)
        d = len(zd.content)
        B = self.block_size
        data = bytes(data)
        n = len(data)
        if n == 0:
            return zenc.compress(b"", level, dictionary=zd)
        step, mode = self._dict_step(d)  # raises if d + B > 65536
        dict_dev = jax.device_put(
            np.frombuffer(zd.content, dtype=np.uint8),
            NamedSharding(self.mesh, P()),  # replicated = broadcast
        )
        src, mlen, nb, _est = self.tokenize(data, step, mode, (dict_dev,))
        wl = max(17, (d + B).bit_length())
        out = bytearray()
        posa = np.arange(B)
        zeros_d = np.zeros(d, dtype=np.int64)
        for i in range(nb):
            chunk = data[i * B : (i + 1) * B]
            cl = len(chunk)
            arr = np.frombuffer(zd.content + chunk, dtype=np.uint8)
            ml = mlen[i]
            # clamp device results (computed over the zero-padded tail
            # block) to the real chunk length; zstd lets matches run to the
            # block end, so the only rule is staying inside [0, cl)
            ml = np.minimum(ml, np.maximum(cl - posa, 0))
            ml = np.where(ml < 4, 0, ml)
            src_full = np.concatenate([zeros_d, src[i].astype(np.int64)])
            ml_full = np.concatenate([zeros_d, ml.astype(np.int64)])
            mps, mss, mls = resolve_matches_host(
                arr, src_full, ml_full, d + cl, d + cl, self.capj)
            lit_starts = np.concatenate([[d], mps + mls])
            seqs = [
                (int(ls), int(p - ls), int(p), int(j), int(l))
                for ls, p, j, l in zip(lit_starts[:-1], mps, mss, mls)
            ]
            seqs.append((int(lit_starts[-1]), d + cl - int(lit_starts[-1]),
                         None, None, None))
            rep = list(zd.rep)
            # fresh per block: each block is its own dict-referencing frame
            enc_tabs = zd.encode_tables()
            ent = zenc.EntropyState(*enc_tabs) if enc_tabs is not None else None
            body = zenc._encode_block_body(arr, d, d + cl, seqs, rep, ent=ent)
            out += zenc._frame_header(cl, wl, dict_id=zd.dict_id,
                                      min_window=d + cl)
            if body is not None and len(body) < cl:
                out += struct.pack("<I", 1 | (2 << 1) | (len(body) << 3))[:3]
                out += body
            else:
                out += struct.pack("<I", 1 | (0 << 1) | (cl << 3))[:3]
                out += chunk
        return bytes(out)
