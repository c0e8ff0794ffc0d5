"""Device-side zstd Huffman entropy coding (encode + decode).

Role parity: the HUF_* entropy stage of the reference's vendored zstd
(behind ``ZSTD_compressCCtx`` at lib/zpack_write.c:179 and
``ZSTD_decompressDCtx`` at lib/zpack_read.c:380), as batched device code:

* **Encode** — symbols are looked up in a per-stream (256,) code table,
  adjacent codes combine into 32-symbol groups, bit offsets come from one
  cumulative sum, and every group is scatter-added into a u32 bit plane.
  Disjoint bits make add == or.  Batched over (streams, L) so many
  64 KiB blocks encode per dispatch.

* **Decode** — all streams walk in lockstep through one ``lax.scan``
  (:func:`decode_streams_scan`); the speculative-decode + pointer-doubling
  formulation (:func:`decode_streams`) stays as an alternative.  All
  shapes static, so the whole thing jits.

Bit-exactness is pinned against codecs/zstd/huffman.py in
tests/test_kernels.py; the streams decode with libzstd.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

MAX_BITS = 11  # zstd huffman code-length limit (RFC 8878 §4.2.1)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def _shift_limbs(limbs, sh):
    """Shift a little-endian u32 limb vector left by sh (0..31) bits.

    Returns len(limbs)+1 limbs (the shift spills one word).  sh == 0 is
    safe: the complement shift is split as (x >> 1) >> (31 - sh).
    """
    sh_r = jnp.uint32(31) - sh
    na = len(limbs)
    out = [limbs[0] << sh]
    for t in range(1, na):
        out.append((limbs[t] << sh) | ((limbs[t - 1] >> jnp.uint32(1)) >> sh_r))
    out.append((limbs[na - 1] >> jnp.uint32(1)) >> sh_r)
    return out


def _combine_round(limbs, lens, n_out: int, kmax: int):
    """One tree-combine round: value A (even groups — earlier symbols,
    higher bits) ORs above value B (odd groups) shifted by B's bit length.

    limbs: list of (Q,) u32 vectors (little-endian), lens: (Q,) int32.
    Returns (out_limbs: n_out vectors over Q//2 groups, lens: (Q//2,)).
    Bit ranges of distinct groups stay disjoint throughout, so OR never
    carries and the final scatter-ADD == scatter-OR.
    """
    A = [v[0::2] for v in limbs]
    B = [v[1::2] for v in limbs]
    lA = lens[0::2]
    lB = lens[1::2]
    lBu = lB.astype(jnp.uint32)
    base = _shift_limbs(A, lBu & jnp.uint32(31))  # len(limbs)+1 entries
    k = (lBu >> jnp.uint32(5)).astype(jnp.int32)  # word offset 0..kmax
    z = jnp.zeros_like(base[0])
    out = []
    for t in range(n_out):
        acc = B[t] if t < len(B) else z
        for kk in range(kmax + 1):
            j = t - kk
            if 0 <= j < len(base):
                acc = acc | jnp.where(k == kk, base[j], z)
        out.append(acc)
    return out, lA + lB


def _lookup_codes(syms, codes_tab, lens_tab):
    """Per-symbol (length, code) from one stream's (256,) tables."""
    s = syms.astype(jnp.int32)
    return jnp.take(lens_tab, s), jnp.take(codes_tab, s)


def _encode_one_stream(syms, n, codes_tab, lens_tab, n_words: int):
    """One backward-read huffman stream from a padded symbol row.

    syms: (L,) uint8 symbols in ORIGINAL order (first n valid).
    Returns (words: (n_words,) uint32 little-endian bit plane,
    total_bits: int32 excluding the sentinel bit).

    The python oracle reverses the symbols then cumsums; here the reversal
    is folded into the offset formula: symbol i starts at
    total_bits - inclusive_cumsum(lens)[i] (symbols after i occupy the low
    bits so the backward reader meets symbol 0 first).

    Adjacent symbols are first combined in FIVE dense tree rounds into
    one <=352-bit (32-symbol) contribution of eleven u32 limbs, so the
    bit plane takes 12 scatter-adds per 32 symbols instead of two per
    symbol.  Bit ranges of distinct groups stay disjoint, so
    scatter-ADD == scatter-OR.
    """
    L = syms.shape[0]
    assert L % 32 == 0, "bucketed stream lengths are multiples of 32"
    idx_r = jnp.arange(L, dtype=jnp.int32)
    valid = idx_r < n
    sym_lens, sym_codes = _lookup_codes(syms, codes_tab, lens_tab)
    lens = jnp.where(valid, sym_lens, 0)
    vals = jnp.where(valid, sym_codes.astype(jnp.uint32), jnp.uint32(0))
    # tree round 1 — pairs: symbol 2i occupies bits ABOVE symbol 2i+1
    # (backward stream: later symbols live at lower bit offsets)
    l0, l1, l2, l3 = lens[0::4], lens[1::4], lens[2::4], lens[3::4]
    v0, v1, v2, v3 = vals[0::4], vals[1::4], vals[2::4], vals[3::4]
    v01 = v1 | (v0 << l1.astype(jnp.uint32))   # <= 22 bits
    v23 = v3 | (v2 << l3.astype(jnp.uint32))
    l01 = l0 + l1
    l23 = l2 + l3
    # tree round 2 — quads: two u32 limbs of a <=44-bit value
    s = l23.astype(jnp.uint32)
    lo4 = v23 | (v01 << s)
    hi4 = (v01 >> jnp.uint32(1)) >> (jnp.uint32(31) - s)  # s=0-safe >>32
    l4 = l01 + l23
    # tree rounds 3-5 — generic multi-limb combines up to 32-symbol
    # groups: octs (<=88 bits, 3 limbs), 16s (<=176, 6), 32s (<=352, 11)
    limbs, glens = _combine_round([lo4, hi4], l4, n_out=3, kmax=1)
    limbs, glens = _combine_round(limbs, glens, n_out=6, kmax=2)
    limbs, glens = _combine_round(limbs, glens, n_out=11, kmax=5)
    csum = jnp.cumsum(glens)  # == csum[31::32] of the per-symbol cumsum
    total_bits = csum[-1]  # lens are 0 past n, so this is the stream total
    off = (total_bits - csum).astype(jnp.uint32)  # start bit of group q
    widx = (off >> 5).astype(jnp.int32)
    words = _shift_limbs(limbs, off & jnp.uint32(31))  # 12 aligned words
    acc = jnp.zeros(n_words, dtype=jnp.uint32)
    # (Limbs past a group's true bit length are zero, so out-of-range
    # indices carry nothing and mode="drop" is safe.)
    for t, w in enumerate(words):
        acc = acc.at[widx + t].add(w, mode="drop")
    # closing sentinel bit (the decoder's start-position marker)
    acc = acc.at[total_bits >> 5].add(
        jnp.uint32(1) << (total_bits.astype(jnp.uint32) & jnp.uint32(31)),
        mode="drop",
    )
    return acc, total_bits


@partial(jax.jit, static_argnames=("n_words",))
def encode_streams(syms, lens, codes_tab, lens_tab, *, n_words: int):
    """Batched stream encode.

    syms: (S, L) uint8, lens: (S,) int32 valid prefix lengths,
    codes_tab/lens_tab: (S, 256) int32 per-stream canonical code tables.
    Returns (words (S, n_words) uint32, total_bits (S,) int32).
    """
    return jax.vmap(
        lambda s, n, c, l: _encode_one_stream(s, n, c, l, n_words)
    )(syms, lens, codes_tab, lens_tab)


def words_needed(max_len: int) -> int:
    """u32 words that always hold max_len symbols of <=11 bits + sentinel
    (+3 slack; group limbs past the payload are zero and scatter with
    mode="drop", so the 32-symbol groups' widx + 11 reach needs no room)."""
    return (max_len * MAX_BITS + 1) // 32 + 3


class DeviceHuffmanEncoder:
    """Host wrapper: pack python-side literal streams into fixed device
    batches, run :func:`encode_streams`, trim the resulting bit planes.

    Stream lengths and batch sizes are bucketed so a long archive reuses a
    handful of fixed-shape executables instead of compiling per shape.
    """

    #: pad stream lengths to the next bucket so compiles stay bounded
    BUCKETS = (256, 1024, 4096, 16384, 65536)

    def __init__(self, mesh=None):
        #: optional jax.sharding.Mesh — the stream batch is sharded over
        #: ALL its devices (data-parallel entropy coding)
        self.mesh = mesh

    def _bucket(self, n: int) -> int:
        for b in self.BUCKETS:
            if n <= b:
                return b
        return int(np.ceil(n / self.BUCKETS[-1])) * self.BUCKETS[-1]

    @staticmethod
    def _bucket_batch(s: int) -> int:
        """Pad the batch dim S to a power of two (min 8) so the number of
        pending blocks — which varies with every archive — does not trigger
        a fresh XLA compile per distinct S."""
        n = 8
        while n < s:
            n <<= 1
        return n

    def _shard(self, *arrays):
        """Pad dim 0 to the mesh size and shard over all mesh axes."""
        return shard_rows(self.mesh, *arrays)

    def encode_batch(self, streams: list[np.ndarray], tables) -> list[bytes]:
        """streams[i]: uint8 symbol array; tables[i]: HuffEncodeTable
        (codecs.zstd.huffman) for stream i.  Returns the encoded byte
        payload of each stream (identical to huffman._encode_stream)."""
        if not streams:
            return []
        L = self._bucket(max(len(s) for s in streams))
        S = len(streams)
        Sp = self._bucket_batch(S)  # pad batch dim: bounded compile count
        syms = np.zeros((Sp, L), dtype=np.uint8)
        lens = np.zeros(Sp, dtype=np.int32)
        codes_tab = np.zeros((Sp, 256), dtype=np.int32)
        lens_tab = np.zeros((Sp, 256), dtype=np.int32)
        for i, (s, t) in enumerate(zip(streams, tables)):
            syms[i, : len(s)] = s
            lens[i] = len(s)
            codes_tab[i, : len(t.codes)] = t.codes.astype(np.int32)
            lens_tab[i, : len(t.lengths)] = t.lengths.astype(np.int32)
            # oracle contract (_encode_stream): a symbol absent from the
            # table is an error, not a silent 0-bit emission
            if len(s) and (lens_tab[i][np.asarray(s)] == 0).any():
                from ..errors import CompressError

                raise CompressError("huffman table misses a packed symbol")
        nw = words_needed(L)
        syms_d, lens_d, ct_d, lt_d = self._shard(syms, lens, codes_tab, lens_tab)
        words, total_bits = encode_streams(syms_d, lens_d, ct_d, lt_d, n_words=nw)
        words = np.asarray(words)[:S].astype("<u4")
        total_bits = np.asarray(total_bits)[:S]
        out = []
        for i in range(S):
            nbytes = (int(total_bits[i]) + 1 + 7) // 8
            out.append(words[i].tobytes()[:nbytes])
        return out

    def encode_4stream_batch(self, lit_blocks: list[np.ndarray], tables) -> list[bytes | None]:
        """Device analog of huffman.encode_4stream for a batch of blocks:
        each block's literals split into 4 sub-streams (host split, device
        encode), jumptable + concatenation assembled host-side."""
        streams, owner = [], []
        plan = []
        for bi, arr in enumerate(lit_blocks):
            n = len(arr)
            per = (n + 3) // 4
            parts = [arr[:per], arr[per:2 * per], arr[2 * per:3 * per], arr[3 * per:]]
            if any(len(p) == 0 for p in parts):
                plan.append(None)
                continue
            plan.append((len(streams), 4))
            for p in parts:
                streams.append(p)
                owner.append(bi)
        encoded = self.encode_batch(streams, [tables[o] for o in owner])
        out: list[bytes | None] = []
        for bi, pl in enumerate(plan):
            if pl is None:
                out.append(None)
                continue
            base, _ = pl
            es = encoded[base:base + 4]
            if any(len(e) > 0xFFFF for e in es[:3]):
                out.append(None)
                continue
            body = bytearray()
            for e in es[:3]:
                body += len(e).to_bytes(2, "little")
            for e in es:
                body += e
            out.append(bytes(body))
        return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("max_bits", "n_out"))
def decode_streams(payloads, starts, symbols_tab, nbits_tab, *, max_bits: int,
                   n_out: int):
    """Batched decode: payloads (S, P) uint8, starts (S,) int32,
    symbols_tab/nbits_tab (S, 2^max_bits) int32.
    Returns (syms (S, n_out) uint8, pos (S, n_out) int32 bit position
    BEFORE each symbol, nb (S, n_out) int32 bits consumed).

    Formulation: SPECULATIVE decode at every bit position + pointer
    doubling.  A (symbol, nbits) is decoded at ALL 8*P bit positions with
    dense bulk gathers, giving a jump table nxt[p] = p - nbits[p]; the
    true decode path is the orbit of `starts`, extracted by prefix
    doubling — positions of the first 2^k symbols are known after k
    rounds, each round one bulk gather plus one jump-table composition.
    """
    S, P = payloads.shape
    # +4 zero bytes in front: bit offset +32 makes k = p - max_bits
    # non-negative for every p >= 0 (positions below max_bits zero-pad,
    # matching huffman._stream_bit_windows);  +4 in back bounds jb+2.
    pad = jnp.zeros((S, 4), dtype=jnp.uint8)
    b = jnp.concatenate([pad, payloads, pad], axis=1).astype(jnp.uint32)
    w24 = b[:, :-2] | (b[:, 1:-1] << jnp.uint32(8)) | (b[:, 2:] << jnp.uint32(16))
    mask = jnp.uint32((1 << max_bits) - 1)
    D = 8 * P + 8  # bit-position domain (starts < 8P; +8 covers windows)
    p_all = jnp.arange(D, dtype=jnp.int32)
    k = p_all + (32 - max_bits)
    jb = k >> 3
    sh = (k & 7).astype(jnp.uint32)
    w = jnp.take(w24, jb, axis=1)  # (S, D) monotone bulk gather
    win = ((w >> sh[None, :]) & mask).astype(jnp.int32)
    # one packed-table gather (sym | nb << 8) instead of two
    combo_tab = symbols_tab | (nbits_tab << jnp.int32(8))
    combo_all = jnp.take_along_axis(combo_tab, win, axis=1)
    sym_all = (combo_all & jnp.int32(0xFF)).astype(jnp.uint8)
    nb_all = combo_all >> jnp.int32(8)
    nxt = jnp.maximum(p_all[None, :] - nb_all, 0)  # clamp like the oracle
    # prefix doubling: after round r, positions of the first 2^r symbols
    # are known and J jumps 2^r symbols at once
    pos = jnp.zeros((S, n_out), dtype=jnp.int32)
    pos = pos.at[:, 0].set(starts.astype(jnp.int32))
    known = 1
    J = nxt
    while known < n_out:
        take = min(known, n_out - known)
        stepped = jnp.take_along_axis(J, pos[:, :take], axis=1)
        pos = jax.lax.dynamic_update_slice(pos, stepped, (0, known))
        known += take
        if known < n_out:
            J = jnp.take_along_axis(J, J, axis=1)
    final = jnp.take_along_axis(combo_all, pos, axis=1)  # one gather, not two
    syms = (final & jnp.int32(0xFF)).astype(jnp.uint8)
    nbs = final >> jnp.int32(8)
    return syms, pos, nbs


@partial(jax.jit, static_argnames=("max_bits", "n_out", "unroll"))
def decode_streams_scan(payloads, starts, combo_tab, *, max_bits: int,
                        n_out: int, unroll: int = 4):
    """Batched lockstep-scan decode.

    The speculative-decode + pointer-doubling formulation
    (:func:`decode_streams`) costs ~18 full (S, 8P) gather passes
    (~95 gather-elements per symbol).  This kernel instead walks all S
    streams in LOCKSTEP with one lax.scan: each
    32-bit window gather covers TWO symbols (codes are <=11 bits and the
    top-aligned window keeps >=14 bits of shift room below the first
    symbol), and ``unroll`` windows per scan step amortize the per-step
    dispatch overhead.  Gather traffic: 1.5 elements per symbol — ~60x
    less than doubling; throughput rides the batch width S.

    payloads (S, P) uint8 backward-read streams, starts (S,) int32
    sentinel bit positions, combo_tab (S, 2^max_bits) int32 packed
    decode tables (sym | nbits << 8), widened to max_bits.
    Returns (syms (S, n_out) uint8, pos (S, n_out) int32 bit position
    BEFORE each symbol, nb (S, n_out) int32 bits consumed).
    """
    S, P = payloads.shape
    span = 2 * unroll
    assert n_out % span == 0, "n_out must be a multiple of 2*unroll"
    pad = jnp.zeros((S, 4), dtype=jnp.uint8)
    b = jnp.concatenate([pad, payloads, pad], axis=1).astype(jnp.uint32)
    # 4-byte LE windows at every byte offset of the padded stream
    w32 = b[:, :-3] | (b[:, 1:-2] << jnp.uint32(8)) \
        | (b[:, 2:-1] << jnp.uint32(16)) | (b[:, 3:] << jnp.uint32(24))
    mask = jnp.uint32((1 << max_bits) - 1)
    mb = jnp.int32(max_bits)

    def one_sym(w, s):
        """Decode one symbol from window w at shift s (>=0 when valid)."""
        win = ((w >> jnp.maximum(s, 0).astype(jnp.uint32)) & mask).astype(jnp.int32)
        c = jnp.take_along_axis(combo_tab, win[:, None], axis=1)[:, 0]
        return (c & jnp.int32(0xFF)).astype(jnp.uint8), c >> jnp.int32(8)

    def step(p, _):
        syms, poss, nbs = [], [], []
        for _u in range(unroll):
            # padded-bit top of the first symbol's window is p+32; the
            # 4-byte window based at its covering byte keeps both symbols
            # of the pair in range (shift room >= 14 - 11 >= 0)
            e = p + jnp.int32(32)
            jb = ((e + jnp.int32(7)) >> jnp.int32(3)) - jnp.int32(4)
            w = jnp.take_along_axis(w32, jb[:, None], axis=1)[:, 0]
            s1 = e - mb - (jb << jnp.int32(3))
            sym1, nb1 = one_sym(w, s1)
            p1 = jnp.maximum(p - nb1, 0)
            s2 = s1 - (p - p1)
            sym2, nb2 = one_sym(w, s2)
            p2 = jnp.maximum(p1 - nb2, 0)
            syms += [sym1, sym2]
            poss += [p, p1]
            nbs += [nb1, nb2]
            p = p2
        return p, (jnp.stack(syms, 1), jnp.stack(poss, 1), jnp.stack(nbs, 1))

    p0 = starts.astype(jnp.int32)
    _, (sy, po, nb) = jax.lax.scan(step, p0, None, length=n_out // span)
    # ys are (T, S, span): step-major -> (S, T*span) symbol order
    sy = jnp.moveaxis(sy, 0, 1).reshape(S, n_out)
    po = jnp.moveaxis(po, 0, 1).reshape(S, n_out)
    nb = jnp.moveaxis(nb, 0, 1).reshape(S, n_out)
    return sy, po, nb


def shard_rows(mesh, *arrays):
    """Pad dim 0 to the mesh size and shard over all mesh axes (the
    data-parallel batch layout used by every batched entropy wrapper);
    passthrough when mesh is None."""
    if mesh is None:
        return [jnp.asarray(a) for a in arrays]
    from jax.sharding import NamedSharding, PartitionSpec as P

    ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    S = arrays[0].shape[0]
    pad = (-S) % ndev
    out = []
    for a in arrays:
        a = np.asarray(a)
        if pad:
            a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
        spec = P(tuple(mesh.axis_names), *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return out


class DeviceHuffmanDecoder:
    """Host wrapper for batched device Huffman decode, bit-exact vs
    huffman._decode_one_stream (tested in tests/test_kernels.py).
    With ``mesh`` the stream batch shards data-parallel over all its
    devices (mesh extraction — the decode mirror of the encoder's
    sharded entropy stage)."""

    BUCKETS = (1024, 4096, 16384, 65536)

    def __init__(self, mesh=None):
        self.mesh = mesh

    def _bucket(self, n: int, buckets) -> int:
        for b in buckets:
            if n <= b:
                return b
        return int(np.ceil(n / buckets[-1])) * buckets[-1]

    def decode_batch_device(self, payloads: list[bytes], tables,
                            n_symbols: list[int]):
        """Device-resident variant: returns (syms (Sp, n_out) uint8 DEVICE
        array, final_bits (S,) np.int32) — the caller composes further
        device stages without a literal round-trip.  final_bits[i] must
        be 0 for stream validity."""
        syms, pos, nb, S, n_out = self._decode_common(payloads, tables,
                                                      n_symbols)
        n = np.asarray(n_symbols, np.int32)
        # index every padded row and slice on the host, so the gather's
        # shape is the padded batch's and not the stream count's
        idx = np.zeros((pos.shape[0], 1), np.int32)
        idx[:S, 0] = np.maximum(n - 1, 0)
        idx = jnp.asarray(idx)
        pos_n = np.asarray(jnp.take_along_axis(pos, idx, axis=1)[:, 0])[:S]
        nb_n = np.asarray(jnp.take_along_axis(nb, idx, axis=1)[:, 0])[:S]
        final = np.where(n > 0, pos_n - nb_n, 0)
        return syms, final.astype(np.int32)

    def _decode_common(self, payloads: list[bytes], tables,
                       n_symbols: list[int]):
        """Build the padded batch, run the kernel; returns DEVICE arrays
        (syms, pos, nb) plus (S, n_out)."""
        max_bits = max(t.max_bits for t in tables)
        P = self._bucket(max(len(p) for p in payloads), self.BUCKETS)
        n_out = self._bucket(max(n_symbols), self.BUCKETS)
        S = len(payloads)
        Sp = DeviceHuffmanEncoder._bucket_batch(S)  # bounded compile count
        pay = np.zeros((Sp, P), dtype=np.uint8)
        starts = np.zeros(Sp, dtype=np.int32)
        combo_t = np.zeros((Sp, 1 << max_bits), dtype=np.int32)
        for i, (p, t) in enumerate(zip(payloads, tables)):
            if not p or p[-1] == 0:
                raise _decode_err("huffman stream missing sentinel")
            pay[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
            starts[i] = (len(p) - 1) * 8 + (p[-1].bit_length() - 1)
            # widen a narrower table to max_bits: the decoder peeks the TOP
            # t.max_bits bits of the max_bits-wide window, so entry(v) =
            # t[v >> d]; the consumed bit count stays the table's own
            d = max_bits - t.max_bits
            idxs = np.arange(1 << max_bits) >> d
            combo_t[i] = t.symbols[idxs].astype(np.int32) | (
                t.nb_bits[idxs].astype(np.int32) << 8)
        import os

        if os.environ.get("ZPACK_TPU_HUFDEC") == "doubling":
            pay_d, starts_d, sym_d, nb_d = shard_rows(
                self.mesh, pay, starts, combo_t & 0xFF, combo_t >> 8)
            out, pos, nb = decode_streams(
                pay_d, starts_d, sym_d, nb_d, max_bits=max_bits, n_out=n_out)
        else:
            pay_d, starts_d, combo_d = shard_rows(self.mesh, pay, starts, combo_t)
            out, pos, nb = decode_streams_scan(
                pay_d, starts_d, combo_d, max_bits=max_bits, n_out=n_out)
        return out, pos, nb, S, n_out

    def decode_batch(self, payloads: list[bytes], tables, n_symbols: list[int]) -> list[np.ndarray]:
        """payloads[i]: one backward-read huffman stream; tables[i]:
        HuffDecodeTable; n_symbols[i]: expected regenerated count."""
        if not payloads:
            return []
        out, pos, nb, S, n_out = self._decode_common(payloads, tables,
                                                     n_symbols)
        out = np.asarray(out)
        pos = np.asarray(pos)
        nb = np.asarray(nb)
        results = []
        for i, n in enumerate(n_symbols):
            if n == 0:
                results.append(np.zeros(0, dtype=np.uint8))
                continue
            final_bits = int(pos[i, n - 1]) - int(nb[i, n - 1])
            if final_bits != 0:
                raise _decode_err("huffman stream not fully consumed")
            results.append(out[i, :n])
        return results


def _decode_err(msg):
    from ..errors import DecompressError

    return DecompressError(msg)
