"""Parallel LZ4 block encoding on the device via JAX.

LZ4 match finding + parsing (role parity: the encode path the reference
delegates to liblz4, lib/zpack_write.c:204-211) as dense vector ops — no
sequential hash-table updates, no data-dependent python control flow:

  1. hash every 4-byte window,
  2. previous-occurrence chains via one stable sort (XLA sort),
  3. match validation + capped length by dense shifted compares of the
     window words carried through the same sort (no gathers),
  4. greedy parse by pointer-jumping: the jump table is produced on
     device; orbit enumeration (16 doubling rounds) and byte
     serialization run vectorized on host where they are micro-cheap.

Works on any padded block size (multiples of 128 recommended).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..codecs.lz4 import block as lz4block

MIN_MATCH = 4
MFLIMIT = 12
LAST_LITERALS = 5
MAX_OFFSET = 65535
CAPJ = 16  # on-device match length cap (payload bytes carried through sort)
_HASH_MUL = jnp.uint32(2654435761)


def _tz_bytes(x):
    """leading equal *bytes* of a little-endian u32 xor (0..3 for x != 0)."""
    return (
        ((x & 0xFF) == 0).astype(jnp.int32)
        + ((x & 0xFFFF) == 0).astype(jnp.int32)
        + ((x & 0xFFFFFF) == 0).astype(jnp.int32)
    )


@partial(jax.jit, static_argnames=("depth", "n_words"))
def tokenize_block_noscatter(data: jax.Array, depth: int = 2, n_words: int = 2):
    """Scatter-free tokenizer: identical match search to
    :func:`tokenize_block` but returns results still in hash-sorted order
    as ``(pos, packed)``; the host inverts the permutation with one
    vectorized numpy scatter (:func:`unsort_host`).

    ``n_words`` u32 window words ride the sort, capping the on-device
    match length at 4*n_words (the host makes lengths exact via
    resolve_matches_host / the native serializer).  The sort is the cost
    center, so fewer payload operands sort faster, while candidate
    selection quality is barely affected."""
    B = data.shape[0]
    capj = 4 * n_words
    b = data.astype(jnp.uint32)
    bp = jnp.pad(b, (0, capj + 4))
    us = []
    for s in range(0, capj, 4):
        us.append(
            bp[s : B + s]
            | (bp[s + 1 : B + s + 1] << 8)
            | (bp[s + 2 : B + s + 2] << 16)
            | (bp[s + 3 : B + s + 3] << 24)
        )

    h = (us[0] * _HASH_MUL) >> jnp.uint32(16)
    pos_u = jnp.arange(B, dtype=jnp.uint32)
    key = (h << jnp.uint32(16)) | pos_u
    srt = jax.lax.sort((key, *us), num_keys=1)
    key_s, us_s = srt[0], srt[1:]
    hs = key_s >> jnp.uint32(16)
    ps = (key_s & jnp.uint32(0xFFFF)).astype(jnp.int32)

    def shift_up(a, d, fill):
        return jnp.concatenate([jnp.full((d,), fill, a.dtype), a[:-d]])

    best_len = jnp.zeros((B,), jnp.int32)
    best_src = jnp.zeros((B,), jnp.int32)
    for d in range(1, max(2, depth + 1)):
        same = hs == shift_up(hs, d, jnp.uint32(0xFFFFFFFF))
        cand_pos = shift_up(ps, d, jnp.int32(0))
        close = same & (ps - cand_pos <= MAX_OFFSET) & (ps > cand_pos)
        xs = [u ^ shift_up(u, d, jnp.uint32(0)) for u in us_s]
        # match length = 4*(leading equal words) + trailing-equal bytes of
        # the first unequal word, capped at capj
        mlen = jnp.full((B,), capj, jnp.int32)
        carry = jnp.ones((B,), bool)
        for wi, x in enumerate(xs):
            eq = x == 0
            mlen = jnp.where(carry & ~eq, 4 * wi + _tz_bytes(x), mlen)
            carry = carry & eq
        mlen = jnp.where(mlen >= MIN_MATCH, mlen, 0)
        mlen = jnp.where(close, mlen, 0)
        better = mlen > best_len
        best_len = jnp.where(better, mlen, best_len)
        best_src = jnp.where(better, cand_pos, best_src)

    # end-of-block parse rules in the sorted domain (pos = ps)
    match_ok = (best_len >= MIN_MATCH) & (ps < B - MFLIMIT) & (ps > 0)
    ml = jnp.minimum(best_len, (B - LAST_LITERALS) - ps)
    match_ok &= ml >= MIN_MATCH
    mlen_sel = jnp.where(match_ok, ml, 0)
    src_sel = jnp.where(match_ok, best_src, -1)
    return ps, (mlen_sel << 17) | (src_sel & 0x1FFFF)


@partial(jax.jit, static_argnames=("depth", "n_words"))
def tokenize_block_u16(data: jax.Array, depth: int = 2, n_words: int = 2):
    """Match search as :func:`tokenize_block_noscatter` + a device-side
    re-sort back to position order, emitting ONE uint16 per byte:
    ``(src << 3) | (mlen - 3)`` (0 = no match) — 4x less d2h than the
    (pos, packed) i32 pair.

    The unsort is a second, single-operand sort of ``(pos << 16) | tok``.
    Requires B <= 8192 (src fits 13 bits) and capj <= 10 (length code
    fits 3 bits)."""
    B = data.shape[0]
    capj = 4 * n_words
    assert B <= 8192 and capj <= 10
    b = data.astype(jnp.uint32)
    bp = jnp.pad(b, (0, capj + 4))
    us = []
    for s in range(0, capj, 4):
        us.append(
            bp[s : B + s]
            | (bp[s + 1 : B + s + 1] << 8)
            | (bp[s + 2 : B + s + 2] << 16)
            | (bp[s + 3 : B + s + 3] << 24)
        )

    h = (us[0] * _HASH_MUL) >> jnp.uint32(16)
    pos_u = jnp.arange(B, dtype=jnp.uint32)
    key = (h << jnp.uint32(16)) | pos_u
    srt = jax.lax.sort((key, *us), num_keys=1)
    key_s, us_s = srt[0], srt[1:]
    hs = key_s >> jnp.uint32(16)
    ps = (key_s & jnp.uint32(0xFFFF)).astype(jnp.int32)

    def shift_up(a, d, fill):
        return jnp.concatenate([jnp.full((d,), fill, a.dtype), a[:-d]])

    best_len = jnp.zeros((B,), jnp.int32)
    best_src = jnp.zeros((B,), jnp.int32)
    for d in range(1, max(2, depth + 1)):
        same = hs == shift_up(hs, d, jnp.uint32(0xFFFFFFFF))
        cand_pos = shift_up(ps, d, jnp.int32(0))
        close = same & (ps - cand_pos <= MAX_OFFSET) & (ps > cand_pos)
        xs = [u ^ shift_up(u, d, jnp.uint32(0)) for u in us_s]
        mlen = jnp.full((B,), capj, jnp.int32)
        carry = jnp.ones((B,), bool)
        for wi, x in enumerate(xs):
            eq = x == 0
            mlen = jnp.where(carry & ~eq, 4 * wi + _tz_bytes(x), mlen)
            carry = carry & eq
        mlen = jnp.where(mlen >= MIN_MATCH, mlen, 0)
        mlen = jnp.where(close, mlen, 0)
        better = mlen > best_len
        best_len = jnp.where(better, mlen, best_len)
        best_src = jnp.where(better, cand_pos, best_src)

    match_ok = (best_len >= MIN_MATCH) & (ps < B - MFLIMIT) & (ps > 0)
    ml = jnp.minimum(best_len, (B - LAST_LITERALS) - ps)
    match_ok &= ml >= MIN_MATCH
    code = jnp.where(match_ok, ml - 3, 0).astype(jnp.uint32)
    tok = (best_src.astype(jnp.uint32) << jnp.uint32(3)) | code
    tok = jnp.where(match_ok, tok, jnp.uint32(0))
    packed = (ps.astype(jnp.uint32) << jnp.uint32(16)) | tok
    ordered = jax.lax.sort(packed)
    return (ordered & jnp.uint32(0xFFFF)).astype(jnp.uint16)


@partial(jax.jit, static_argnames=("depth", "n_words"))
def tokenize_block_resort(data: jax.Array, depth: int = 2, n_words: int = 2):
    """Match search + device-side re-sort to position order for any
    B <= 65536: returns ``(src uint16, code uint8)`` position-ordered
    arrays (code = mlen - 3, 0 = no match) — 3 bytes/byte d2h vs 8 for
    the hash-ordered (pos, packed) i32 pair.  The re-sort key packs
    ``(pos << 16) | src`` into one u32; code rides as a u8 operand."""
    B = data.shape[0]
    capj = 4 * n_words
    assert B <= 65536 and capj <= 10
    b = data.astype(jnp.uint32)
    bp = jnp.pad(b, (0, capj + 4))
    us = []
    for s in range(0, capj, 4):
        us.append(
            bp[s : B + s]
            | (bp[s + 1 : B + s + 1] << 8)
            | (bp[s + 2 : B + s + 2] << 16)
            | (bp[s + 3 : B + s + 3] << 24)
        )

    h = (us[0] * _HASH_MUL) >> jnp.uint32(16)
    pos_u = jnp.arange(B, dtype=jnp.uint32)
    key = (h << jnp.uint32(16)) | pos_u
    srt = jax.lax.sort((key, *us), num_keys=1)
    key_s, us_s = srt[0], srt[1:]
    hs = key_s >> jnp.uint32(16)
    ps = (key_s & jnp.uint32(0xFFFF)).astype(jnp.int32)

    def shift_up(a, d, fill):
        return jnp.concatenate([jnp.full((d,), fill, a.dtype), a[:-d]])

    best_len = jnp.zeros((B,), jnp.int32)
    best_src = jnp.zeros((B,), jnp.int32)
    for d in range(1, max(2, depth + 1)):
        same = hs == shift_up(hs, d, jnp.uint32(0xFFFFFFFF))
        cand_pos = shift_up(ps, d, jnp.int32(0))
        close = same & (ps - cand_pos <= MAX_OFFSET) & (ps > cand_pos)
        xs = [u ^ shift_up(u, d, jnp.uint32(0)) for u in us_s]
        mlen = jnp.full((B,), capj, jnp.int32)
        carry = jnp.ones((B,), bool)
        for wi, x in enumerate(xs):
            eq = x == 0
            mlen = jnp.where(carry & ~eq, 4 * wi + _tz_bytes(x), mlen)
            carry = carry & eq
        mlen = jnp.where(mlen >= MIN_MATCH, mlen, 0)
        mlen = jnp.where(close, mlen, 0)
        better = mlen > best_len
        best_len = jnp.where(better, mlen, best_len)
        best_src = jnp.where(better, cand_pos, best_src)

    match_ok = (best_len >= MIN_MATCH) & (ps < B - MFLIMIT) & (ps > 0)
    ml = jnp.minimum(best_len, (B - LAST_LITERALS) - ps)
    match_ok &= ml >= MIN_MATCH
    code = jnp.where(match_ok, ml - 3, 0).astype(jnp.uint8)
    key2 = (ps.astype(jnp.uint32) << jnp.uint32(16)) | jnp.where(
        match_ok, best_src, 0
    ).astype(jnp.uint32)
    key2_s, code_s = jax.lax.sort((key2, code), num_keys=1)
    return (key2_s & jnp.uint32(0xFFFF)).astype(jnp.uint16), code_s


def unpack_resort_host(src16: np.ndarray, code: np.ndarray):
    """Split (src u16, code u8) from :func:`tokenize_block_resort` into the
    standard (src, mlen) int32 tables (vectorized, any leading shape)."""
    code = np.asarray(code).astype(np.int32)
    mlen = np.where(code > 0, code + 3, 0).astype(np.int32)
    src = np.where(code > 0, np.asarray(src16).astype(np.int32), -1).astype(np.int32)
    return src, mlen


def unpack_u16_host(tok: np.ndarray):
    """Split the u16 token stream from :func:`tokenize_block_u16` into the
    standard (src, mlen) int32 tables (vectorized, any leading shape)."""
    v = np.asarray(tok).astype(np.int32)
    code = v & 7
    mlen = np.where(code > 0, code + 3, 0).astype(np.int32)
    src = np.where(code > 0, v >> 3, -1).astype(np.int32)
    return src, mlen


@partial(jax.jit, static_argnames=("depth",))
def tokenize_block(data: jax.Array, depth: int = 2):
    """Find the best match per position for one B-byte block (B static,
    B <= 65536 so positions fit in the low 16 bits of the sort key).

    Gather-free formulation: pack (hash16 << 16 | pos16) into ONE u32 sort key and carry the first 16
    window bytes as four u32 payload columns through the same sort; a
    hash-chain candidate at depth d is then simply the sorted neighbor d
    rows above, and match validation + capped length are dense shifted
    compares on the payload columns.  One packed scatter unsorts the
    result.  Capped (>= CAPJ) matches are re-extended exactly host-side.

    Returns (src, mlen): int32[B] match source (-1 = none) and capped
    match length (0 = none), clamped to the block-end parse rules.
    """
    B = data.shape[0]
    b = data.astype(jnp.uint32)
    bp = jnp.pad(b, (0, CAPJ + 4))
    u = bp[:B] | (bp[1 : B + 1] << 8) | (bp[2 : B + 2] << 16) | (bp[3 : B + 3] << 24)
    u4 = bp[4 : B + 4] | (bp[5 : B + 5] << 8) | (bp[6 : B + 6] << 16) | (bp[7 : B + 7] << 24)
    u8_ = bp[8 : B + 8] | (bp[9 : B + 9] << 8) | (bp[10 : B + 10] << 16) | (bp[11 : B + 11] << 24)
    u12 = bp[12 : B + 12] | (bp[13 : B + 13] << 8) | (bp[14 : B + 14] << 16) | (bp[15 : B + 15] << 24)

    h = (u * _HASH_MUL) >> jnp.uint32(16)
    pos_u = jnp.arange(B, dtype=jnp.uint32)
    key = (h << jnp.uint32(16)) | pos_u  # stable by construction
    key_s, u_s, u4_s, u8_s, u12_s = jax.lax.sort(
        (key, u, u4, u8_, u12), num_keys=1
    )
    hs = key_s >> jnp.uint32(16)
    ps = (key_s & jnp.uint32(0xFFFF)).astype(jnp.int32)

    def shift_up(a, d, fill):
        return jnp.concatenate([jnp.full((d,), fill, a.dtype), a[:-d]])

    best_len = jnp.zeros((B,), jnp.int32)
    best_src = jnp.zeros((B,), jnp.int32)
    for d in range(1, max(2, depth + 1)):
        same = hs == shift_up(hs, d, jnp.uint32(0xFFFFFFFF))
        cand_pos = shift_up(ps, d, jnp.int32(0))
        close = same & (ps - cand_pos <= MAX_OFFSET) & (ps > cand_pos)
        x0 = u_s ^ shift_up(u_s, d, jnp.uint32(0))
        x1 = u4_s ^ shift_up(u4_s, d, jnp.uint32(0))
        x2 = u8_s ^ shift_up(u8_s, d, jnp.uint32(0))
        x3 = u12_s ^ shift_up(u12_s, d, jnp.uint32(0))
        e0 = x0 == 0
        e1 = x1 == 0
        e2 = x2 == 0
        l3 = jnp.where(e2, jnp.where(x3 == 0, 16, 12 + _tz_bytes(x3)), 8 + _tz_bytes(x2))
        mlen = jnp.where(e0, jnp.where(e1, l3, 4 + _tz_bytes(x1)), 0)
        mlen = jnp.where(close, mlen, 0)
        better = mlen > best_len
        best_len = jnp.where(better, mlen, best_len)
        best_src = jnp.where(better, cand_pos, best_src)

    # unsort via one packed scatter: (len << 17) | src  (len<=16, src<2^17)
    packed = (best_len << 17) | best_src
    out = jnp.zeros((B,), jnp.int32).at[ps].set(packed)
    best_len = out >> 17
    best_src = out & jnp.int32(0x1FFFF)

    # end-of-block parse rules
    pos = jnp.arange(B, dtype=jnp.int32)
    match_ok = (best_len >= MIN_MATCH) & (pos < B - MFLIMIT) & (pos > 0)
    ml = jnp.minimum(best_len, (B - LAST_LITERALS) - pos)
    match_ok &= ml >= MIN_MATCH
    mlen_sel = jnp.where(match_ok, ml, 0)
    src_sel = jnp.where(match_ok, best_src, -1)
    return src_sel, mlen_sel


def parse_events_host(src: np.ndarray, mlen: np.ndarray, n: int):
    """Greedy parse via numpy pointer-doubling over the device jump table.
    Returns sorted match positions (the parse orbit's match events)."""
    B = len(mlen)
    step = np.where(mlen >= MIN_MATCH, mlen, 1).astype(np.int64)
    jump = np.minimum(np.arange(B, dtype=np.int64) + step, B)
    jump = np.concatenate([jump, [B]])
    orbit = np.array([0], dtype=np.int64)
    while len(orbit) <= B:
        orbit = np.concatenate([orbit, jump[orbit]])
        jump = jump[jump]
    orbit = orbit[: B + 1]
    events = orbit[orbit < n]
    events = np.unique(events)  # orbit is sorted+padded; dedupe the fixpoint
    return events[mlen[events] >= MIN_MATCH]


def _extend_capped(arr: np.ndarray, limit: int, p: np.ndarray, j: np.ndarray,
                   ml: np.ndarray) -> np.ndarray:
    """Exact-extend capped match lengths, vectorized: strip-doubling compares
    of (n_active, s) byte blocks; rows retire at their first mismatch or at
    ``limit``.  Total work is O(sum of extensions)."""
    pe = (p + ml).astype(np.int64)
    je = (j + ml).astype(np.int64)
    base = np.int64(len(arr) - 1)
    active = pe < limit
    s = 16
    while active.any():
        a = np.nonzero(active)[0]
        off = np.arange(s, dtype=np.int64)
        pa = pe[a, None] + off
        ja = je[a, None] + off
        eq = (arr[np.minimum(pa, base)] == arr[np.minimum(ja, base)]) & (pa < limit)
        allm = eq.all(axis=1)
        adv = np.where(allm, s, eq.argmin(axis=1))
        pe[a] += adv
        je[a] += adv
        active[a] = allm & (pe[a] < limit)
        if s < 4096:
            s *= 2
    return pe - p


def resolve_matches_host(arr: np.ndarray, src: np.ndarray, mlen: np.ndarray,
                         n: int, limit: int, capj: int = CAPJ):
    """Greedy-parse the device match tables into final non-overlapping
    sequences with exact lengths, fully vectorized.

    Device-capped lengths (>= CAPJ) are made exact BEFORE the parse using
    the same-delta-run identity: within a maximal run of consecutive capped
    positions sharing delta = p - src, L(p) = L(run_end) + (run_end - p),
    so strip-doubling extension runs only at run ends (few), and every
    other capped length follows by arithmetic — O(n) total.  A single
    greedy parse with exact jump lengths then yields the final sequences
    (ratio >= the scalar extend-as-you-go loop, which never re-discovers
    matches inside skipped spans).  Returns (positions, sources, lengths)
    int64 arrays, sorted by position."""
    src64 = src.astype(np.int64)
    mlen = mlen.astype(np.int64)
    capped = mlen >= capj
    if capped.any():
        B = len(mlen)
        pos = np.arange(B, dtype=np.int64)
        delta = np.where(mlen >= MIN_MATCH, pos - src64, np.int64(-1))
        nxt_delta = np.concatenate([delta[1:], np.array([-2], np.int64)])
        nxt_capped = np.concatenate([capped[1:], [False]])
        run_end = capped & ((delta != nxt_delta) | ~nxt_capped)
        ends = np.nonzero(run_end)[0]
        l_end = _extend_capped(arr, limit, ends, src64[ends], mlen[ends])
        # nearest run end at/after p: runs are contiguous, so a reverse
        # min-scan of end positions resolves every capped p to its own end
        end_of = np.minimum.accumulate(np.where(run_end, pos, B)[::-1])[::-1]
        l_at_end = np.zeros(B, np.int64)
        l_at_end[ends] = l_end
        exact_l = l_at_end[np.minimum(end_of, B - 1)] + (end_of - pos)
        mlen = np.where(capped, exact_l, mlen)
    match_ev = parse_events_host(src64, mlen, n)
    return match_ev, src64[match_ev], mlen[match_ev]


def serialize_block_host(data: bytes, src: np.ndarray, mlen: np.ndarray,
                         capj: int = CAPJ) -> bytes:
    """Assemble the LZ4 block from the device match tables: vectorized
    fixpoint parse/extension (resolve_matches_host) + vectorized byte
    serialization — no per-event python loop anywhere."""
    n = len(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    mps, mss, mls = resolve_matches_host(arr, src, mlen, n, n - LAST_LITERALS, capj)
    return lz4block.serialize_sequences_np(data, mps, mss, mls)


# ---------------------------------------------------------------------------
# Decode: sequence replay on device
# ---------------------------------------------------------------------------


def parse_block_sequences(data: bytes):
    """Token-walk one LZ4 block WITHOUT executing it: returns
    (lit_lens, offsets, match_lens) int32 arrays + the concatenated
    literal bytes.  The final literal-only run appears with offset 0 /
    match_len 0.  Mirrors codecs.lz4.block.decompress_block's parse."""
    from ..errors import DecompressError

    src = bytes(data)
    n = len(src)
    pos = 0
    lit_lens, offsets, match_lens = [], [], []
    lits = bytearray()
    while pos < n:
        token = src[pos]
        pos += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if pos >= n:
                    raise DecompressError("truncated literal length")
                c = src[pos]
                pos += 1
                lit_len += c
                if c != 255:
                    break
        if pos + lit_len > n:
            raise DecompressError("literal run overruns input")
        lits += src[pos : pos + lit_len]
        pos += lit_len
        if pos == n:
            lit_lens.append(lit_len)
            offsets.append(0)
            match_lens.append(0)
            break
        if pos + 2 > n:
            raise DecompressError("truncated match offset")
        offset = src[pos] | (src[pos + 1] << 8)
        pos += 2
        if offset == 0:
            raise DecompressError("zero match offset")
        match_len = (token & 0xF) + MIN_MATCH
        if (token & 0xF) == 15:
            while True:
                if pos >= n:
                    raise DecompressError("truncated match length")
                c = src[pos]
                pos += 1
                match_len += c
                if c != 255:
                    break
        lit_lens.append(lit_len)
        offsets.append(offset)
        match_lens.append(match_len)
    return (np.array(lit_lens, np.int32), np.array(offsets, np.int32),
            np.array(match_lens, np.int32), bytes(lits))


@partial(jax.jit, static_argnames=("n_out",))
def _replay_build(lit_bytes, seg_start, lit_start, lit_len, offset, n_seq,
                  *, n_out: int):
    """Stage 1 of the replay: map every output position to (initial
    pointer f, literal index), with overlapping/RLE matches collapsed to
    their FIRST period in closed form (round-5: a match reading its own
    output repeats with period ``offset``, so
    f = match_start - off + (pos - match_start) mod off jumps the whole
    intra-match chain in one step — the old per-hop form needed
    log2(ml/off) doubling rounds, 17 for an RLE block)."""

    def one(lit_b, seg_st, lit_st, ll, off, ns):
        S = seg_st.shape[0]
        sidx = jnp.arange(S, dtype=jnp.int32)
        marks = jnp.where((sidx >= 1) & (sidx < ns), seg_st, n_out)
        seg_of = jnp.zeros(n_out, jnp.int32).at[marks].add(1, mode="drop")
        seg_of = jnp.cumsum(seg_of)
        pos = jnp.arange(n_out, dtype=jnp.int32)
        st = seg_st[seg_of]
        ll_s = ll[seg_of]
        inlit = (pos - st) < ll_s
        lit_idx = lit_st[seg_of] + (pos - st)  # valid where inlit
        m0 = st + ll_s  # match start position of this segment
        off_s = jnp.maximum(off[seg_of], 1)
        f = jnp.where(inlit, pos, m0 - off_s + (pos - m0) % off_s)
        return jnp.maximum(f, 0), lit_idx

    return jax.vmap(one)(lit_bytes, seg_start, lit_start, lit_len, offset,
                         n_seq)


@jax.jit
def _replay_rounds(f):
    """4 doubling rounds + a changed flag (bulk gathers outside any device
    control flow; the host checks the flag between chunks)."""
    for _ in range(3):
        f = jnp.take_along_axis(f, f, axis=1)
    f2 = jnp.take_along_axis(f, f, axis=1)
    changed = jnp.any(f2 != f)
    return f2, changed


@partial(jax.jit, static_argnames=())
def _replay_emit(lit_bytes, lit_idx, f):
    return jax.vmap(lambda lb, li, ff: lb[li[ff]])(lit_bytes, lit_idx, f)


def replay_sequences(lit_bytes, seg_start, lit_start, lit_len, offset, n_seq,
                     *, n_out: int):
    """Batched LZ4/zstd sequence replay (role: the LZ4F_decompress loop at
    lib/zpack_read.c:414-439 and the match-copy half of
    ZSTD_decompressDCtx), the prefix-sum + pointer-jumping recipe:

    1. one scatter + cumsum maps every output position to its sequence,
    2. literal positions resolve into the literal buffer; match positions
       point back ``offset`` bytes with intra-match (RLE) chains collapsed
       in closed form (_replay_build),
    3. pointer doubling collapses INTER-segment copy chains — run in
       4-round chunks with a host-checked convergence flag, so typical
       data stops after ~4-8 rounds instead of the worst-case
       log2(n_out) ~ 21 (the flag costs one scalar d2h per chunk, which
       the saved (B, n_out) gather rounds repay many times over),
    4. one gather pulls the bytes from the literal buffer.

    All arrays are (B, ...) batches: lit_bytes (B, L) uint8,
    seg_start/lit_start/lit_len/offset (B, S) int32 (zero-padded),
    n_seq (B,).  Returns (B, n_out) uint8; valid prefix = caller's total.
    """
    f, lit_idx = _replay_build(lit_bytes, seg_start, lit_start, lit_len,
                               offset, n_seq, n_out=n_out)
    max_rounds = max(1, int(np.ceil(np.log2(max(n_out, 2)))))
    done = 0
    while done < max_rounds:
        f, changed = _replay_rounds(f)
        done += 4
        if not bool(changed):  # scalar d2h sync
            break
    return _replay_emit(lit_bytes, lit_idx, f)


class DeviceLZ4Replayer:
    """Host wrapper: parse blocks' token streams, batch the sequence
    replay on device, trim outputs (bit-exact vs block.decompress_block
    for independent blocks)."""

    BUCKETS = (1024, 4096, 16384, 65536)

    @staticmethod
    def _bucket(n: int, buckets) -> int:
        for b in buckets:
            if n <= b:
                return b
        return int(np.ceil(n / buckets[-1])) * buckets[-1]

    def decompress_blocks(self, blocks: list[bytes], out_sizes: list[int]) -> list[bytes]:
        """blocks: independent LZ4 block payloads; out_sizes: expected
        decoded sizes (frame block-size bound).  Returns decoded bytes."""
        from ..errors import DecompressError

        if not blocks:
            return []
        parsed = [parse_block_sequences(b) for b in blocks]
        B = len(blocks)
        Bp = 8
        while Bp < B:
            Bp <<= 1
        S = self._bucket(max(len(p[0]) for p in parsed), (64, 256, 1024, 4096, 16384))
        L = self._bucket(max(len(p[3]) for p in parsed), self.BUCKETS)
        totals = []
        lit_b = np.zeros((Bp, L), np.uint8)
        seg_st = np.zeros((Bp, S), np.int32)
        lit_st = np.zeros((Bp, S), np.int32)
        ll_a = np.zeros((Bp, S), np.int32)
        off_a = np.zeros((Bp, S), np.int32)
        ns = np.zeros(Bp, np.int32)
        for i, (lls, offs, mls, lits) in enumerate(parsed):
            k = len(lls)
            seg_len = lls + mls
            total = int(seg_len.sum())
            if total > out_sizes[i]:
                raise DecompressError("block output exceeds declared size")
            totals.append(total)
            seg_st[i, :k] = np.cumsum(seg_len) - seg_len
            lit_st[i, :k] = np.cumsum(lls) - lls
            ll_a[i, :k] = lls
            off_a[i, :k] = offs
            ns[i] = k
            lit_b[i, : len(lits)] = np.frombuffer(lits, np.uint8)
        n_out = self._bucket(max(totals) if totals else 1, self.BUCKETS)
        out = np.asarray(replay_sequences(
            jnp.asarray(lit_b), jnp.asarray(seg_st), jnp.asarray(lit_st),
            jnp.asarray(ll_a), jnp.asarray(off_a), jnp.asarray(ns),
            n_out=n_out))
        return [out[i, : totals[i]].tobytes() for i in range(B)]


def unsort_host(pos: np.ndarray, packed: np.ndarray):
    """Invert the hash-sort permutation of :func:`tokenize_block_noscatter`
    on the host (vectorized scatter) and split the packed word: returns
    (src, mlen) int32 arrays shaped like the inputs — identical contract
    to :func:`tokenize_block`."""
    pos = np.asarray(pos)
    packed = np.asarray(packed)
    out = np.empty_like(packed)
    if pos.ndim == 1:
        out[pos] = packed
    else:
        np.put_along_axis(out, pos, packed, axis=-1)
    mlen = out >> 17
    src = out & 0x1FFFF
    src = np.where(mlen == 0, -1, src).astype(np.int32)
    return src, mlen.astype(np.int32)


def compress_block_device(data: bytes, depth: int = 2, n_words: int = 2) -> bytes:
    """One LZ4 block, matcher on device, parse+serialize on host."""
    n = len(data)
    if n < MFLIMIT + 1:
        return lz4block.compress_block(data)
    B = max(256, -(-n // 128) * 128)
    padded = np.zeros(B, dtype=np.uint8)
    padded[:n] = np.frombuffer(data, dtype=np.uint8)
    pos, packed = tokenize_block_noscatter(jnp.asarray(padded), depth, n_words)
    src, mlen = unsort_host(np.asarray(pos), np.asarray(packed))
    if n != B:
        # padding may have created/extended matches past n: re-clamp
        posa = np.arange(B)
        mlen = np.minimum(mlen, np.maximum(n - LAST_LITERALS - posa, 0))
        mlen = np.where(posa >= max(n - MFLIMIT, 0), 0, mlen)
        mlen = np.where(mlen < MIN_MATCH, 0, mlen)
    return serialize_block_host(data, src, mlen, 4 * n_words)
