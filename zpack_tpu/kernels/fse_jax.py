"""Device-side zstd FSE sequence-section encoding.

Role parity: the FSE half of the entropy machinery inside the reference's
vendored zstd (behind ``ZSTD_compressCCtx`` at lib/zpack_write.c:179,
RFC 8878 §3.1.1.3.2) — together with kernels/huffman_jax.py this makes the
mesh zstd entropy stage fully device-resident.

Device formulation: the three FSE state machines (LL/OF/ML) are inherently
sequential per block, but only in the *state* dimension — so a single
``lax.scan`` walks all blocks' state chains in lockstep (3 small
table-gathers of width n_blocks per step), while everything dense (code
mapping, extra-bit values, bit offsets via cumsum, and the bit-plane
scatter) runs vectorized outside the scan.  The final bitstream is packed
exactly like the huffman kernel: disjoint-bit contributions scatter-added
into a u32 plane (add == or because no two items share a bit).

Bit-exactness is pinned against codecs/zstd/seq.encode_sequences in
tests/test_kernels.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..codecs.zstd import seq as zseq

#: max symbols of any sequence-code alphabet (ML has 53) padded to a lane
NSYM = 64
#: max FSE table size: 1 << max(LL_MAX_AL, ML_MAX_AL, OF_MAX_AL) = 1 << 9
TABLE = 512

# dense numpy versions of seq.ll_code / seq.ml_code ------------------------

_LL_SMALL_NP = np.array(zseq._LL_SMALL, dtype=np.int32)
_ML_SMALL_NP = np.array(zseq._ML_SMALL, dtype=np.int32)
_LL_BASE_NP = np.array(zseq.LL_BASELINES, dtype=np.int32)
_LL_BITS_NP = np.array(zseq.LL_BITS, dtype=np.int32)
_ML_BASE_NP = np.array(zseq.ML_BASELINES, dtype=np.int32)
_ML_BITS_NP = np.array(zseq.ML_BITS, dtype=np.int32)


def _bit_length(v: np.ndarray) -> np.ndarray:
    """Exact bit_length for int64 values < 2**53 (frexp is exact there)."""
    m = np.asarray(v, dtype=np.float64)
    return np.where(v > 0, np.frexp(m)[1], 0).astype(np.int32)


def ll_codes_np(lls: np.ndarray) -> np.ndarray:
    lls = np.asarray(lls, dtype=np.int64)
    big = 19 + _bit_length(np.maximum(lls, 1)) - 1
    small = _LL_SMALL_NP[np.minimum(lls, 63)]
    return np.where(lls > 63, big, small).astype(np.int32)


def ml_codes_np(mls: np.ndarray) -> np.ndarray:
    m = np.asarray(mls, dtype=np.int64) - 3
    big = 36 + _bit_length(np.maximum(m, 1)) - 1
    small = _ML_SMALL_NP[np.minimum(m, 127)]
    return np.where(m > 127, big, small).astype(np.int32)


def of_codes_np(ovs: np.ndarray) -> np.ndarray:
    return (_bit_length(np.asarray(ovs, dtype=np.int64)) - 1).astype(np.int32)


# device kernel --------------------------------------------------------------


def _symbol_lookup(codes, tab):
    """tab[b, codes[b, n]] for every block b: (B, N) codes into (B, W)."""
    return jnp.take_along_axis(tab, codes, axis=1)


def _init_state(sym, st, dnb, dfs):
    """Vectorized fse.EncodeTable.init_state over the block batch."""
    d = jnp.take_along_axis(dnb, sym[:, None], axis=1)[:, 0]
    nb = (d + (1 << 15)) >> 16
    val = (nb << 16) - d
    f = jnp.take_along_axis(dfs, sym[:, None], axis=1)[:, 0]
    return jnp.take_along_axis(st, ((val >> nb) + f)[:, None], axis=1)[:, 0]


@partial(jax.jit, static_argnames=("n_words",))
def encode_seq_streams(r_llx, r_llnb, r_mlx, r_mlnb, r_ofx, r_ofnb,
                       r_llc, r_mlc, r_ofc, n_seq,
                       ll_st, ll_dnb, ll_dfs, ll_al,
                       of_st, of_dnb, of_dfs, of_al,
                       ml_st, ml_dnb, ml_dfs, ml_al, *, n_words: int):
    """Batched sequence-bitstream encode.

    All r_* arrays are (B, N) int32 in REVERSED sequence order
    (r[b, k] = sequence n_b-1-k of block b, zero past n_b): extra-bit
    values/counts per field plus the three code streams.  n_seq: (B,)
    valid counts; per-kind FSE tables (B, TABLE)/(B, NSYM)/(B,) int32.
    Returns (words (B, n_words) uint32, total_bits (B,) int32) exactly
    matching seq.encode_sequences + BackwardBitWriter.finish().
    """
    B, N = r_llc.shape

    # states init on the LAST sequence (k = 0)
    ll0 = _init_state(r_llc[:, 0], ll_st, ll_dnb, ll_dfs)
    of0 = _init_state(r_ofc[:, 0], of_st, of_dnb, of_dfs)
    ml0 = _init_state(r_mlc[:, 0], ml_st, ml_dnb, ml_dfs)

    # bulk-gather the symbol-indexed deltas for every step up front (the
    # scan body then only does the state-table gathers)
    ll_d = _symbol_lookup(r_llc, ll_dnb)
    ll_f_ = _symbol_lookup(r_llc, ll_dfs)
    of_d = _symbol_lookup(r_ofc, of_dnb)
    of_f_ = _symbol_lookup(r_ofc, of_dfs)
    ml_d = _symbol_lookup(r_mlc, ml_dnb)
    ml_f_ = _symbol_lookup(r_mlc, ml_dfs)

    # ONE concatenated state table: the scan body's three per-kind gathers
    # fuse into a single (B, 3) take_along_axis, one gather per step
    W_of = of_st.shape[1]
    W_ml = ml_st.shape[1]
    cat_st = jnp.concatenate([of_st, ml_st, ll_st], axis=1)

    def step(carry, k):
        ll_s, of_s, ml_s = carry
        active = k < n_seq
        # emission order per host loop: of state bits, ml, ll
        of_n = jnp.where(active, (of_s + of_d[:, k]) >> 16, 0)
        of_v = of_s & ((jnp.int32(1) << of_n) - 1)
        ml_n = jnp.where(active, (ml_s + ml_d[:, k]) >> 16, 0)
        ml_v = ml_s & ((jnp.int32(1) << ml_n) - 1)
        ll_n = jnp.where(active, (ll_s + ll_d[:, k]) >> 16, 0)
        ll_v = ll_s & ((jnp.int32(1) << ll_n) - 1)
        # inactive lanes gather a junk (possibly cross-segment) entry and
        # discard it below, exactly like the old masked per-kind gathers
        idx = jnp.stack([
            (of_s >> of_n) + of_f_[:, k],
            (ml_s >> ml_n) + ml_f_[:, k] + W_of,
            (ll_s >> ll_n) + ll_f_[:, k] + W_of + W_ml,
        ], axis=1)
        nxt = jnp.take_along_axis(cat_st, idx, axis=1)
        of_s2 = jnp.where(active, nxt[:, 0], of_s)
        ml_s2 = jnp.where(active, nxt[:, 1], ml_s)
        ll_s2 = jnp.where(active, nxt[:, 2], ll_s)
        return (ll_s2, of_s2, ml_s2), (of_v, of_n, ml_v, ml_n, ll_v, ll_n)

    (ll_f, of_f, ml_f), ys = jax.lax.scan(
        step, (ll0, of0, ml0), jnp.arange(1, N, dtype=jnp.int32))
    of_v, of_n, ml_v, ml_n, ll_v, ll_n = [y.T for y in ys]  # (B, N-1)

    # item table in emission order, (B, N, 6):
    #   k = 0:   [ll_x, ml_x, of_x, 0, 0, 0]           (init writes no bits)
    #   k >= 1:  [of_state, ml_state, ll_state, ll_x, ml_x, of_x]
    z = jnp.zeros((B, 1), jnp.int32)
    vals = jnp.stack([
        jnp.concatenate([r_llx[:, :1], of_v], axis=1),
        jnp.concatenate([r_mlx[:, :1], ml_v], axis=1),
        jnp.concatenate([r_ofx[:, :1], ll_v], axis=1),
        jnp.concatenate([z, r_llx[:, 1:]], axis=1),
        jnp.concatenate([z, r_mlx[:, 1:]], axis=1),
        jnp.concatenate([z, r_ofx[:, 1:]], axis=1),
    ], axis=2)  # (B, N, 6)
    nbs = jnp.stack([
        jnp.concatenate([r_llnb[:, :1], of_n], axis=1),
        jnp.concatenate([r_mlnb[:, :1], ml_n], axis=1),
        jnp.concatenate([r_ofnb[:, :1], ll_n], axis=1),
        jnp.concatenate([z, r_llnb[:, 1:]], axis=1),
        jnp.concatenate([z, r_mlnb[:, 1:]], axis=1),
        jnp.concatenate([z, r_ofnb[:, 1:]], axis=1),
    ], axis=2)
    # mask items of padded sequences (k >= n_seq): nb = 0 packs nothing
    k_idx = jnp.arange(N, dtype=jnp.int32)[None, :, None]
    nbs = jnp.where(k_idx < n_seq[:, None, None], nbs, 0)

    flat_v = vals.reshape(B, N * 6)
    flat_n = nbs.reshape(B, N * 6)
    # final state flushes: ml, of, ll at their accuracy logs
    flush_v = jnp.stack([ml_f, of_f, ll_f], axis=1)
    flush_n = jnp.stack([ml_al, of_al, ll_al], axis=1)
    flat_v = jnp.concatenate([flat_v, flush_v], axis=1)
    flat_n = jnp.concatenate([flat_n, flush_n], axis=1)

    def pack_one(v, nb):
        v = v.astype(jnp.uint32) & ((jnp.uint32(1) << nb.astype(jnp.uint32)) - 1)
        csum = jnp.cumsum(nb)
        total = csum[-1]
        off = (csum - nb).astype(jnp.uint32)  # LSB-first append: start bit
        widx = (off >> 5).astype(jnp.int32)
        sh = off & jnp.uint32(31)
        lo = v << sh
        hi = (v >> jnp.uint32(1)) >> (jnp.uint32(31) - sh)
        acc = jnp.zeros(n_words, dtype=jnp.uint32)
        acc = acc.at[widx].add(lo, mode="drop")
        acc = acc.at[widx + 1].add(hi, mode="drop")
        acc = acc.at[total >> 5].add(
            jnp.uint32(1) << (total.astype(jnp.uint32) & jnp.uint32(31)),
            mode="drop")
        return acc, total

    return jax.vmap(pack_one)(flat_v, flat_n)


class DeviceSequenceEncoder:
    """Host wrapper: pack per-block sequence tuples + chosen FSE encode
    tables into fixed device batches, run :func:`encode_seq_streams`,
    trim the byte payloads (bit-exact vs seq.encode_sequences).

    ``mesh`` shards the block batch over all mesh devices, like
    DeviceHuffmanEncoder."""

    BUCKETS = (64, 256, 1024, 4096)

    def __init__(self, mesh=None):
        self.mesh = mesh

    def _bucket(self, n: int) -> int:
        for b in self.BUCKETS:
            if n <= b:
                return b
        return int(np.ceil(n / self.BUCKETS[-1])) * self.BUCKETS[-1]

    @staticmethod
    def _bucket_batch(s: int) -> int:
        n = 8
        while n < s:
            n <<= 1
        return n

    def _shard(self, *arrays):
        if self.mesh is None:
            return [jnp.asarray(a) for a in arrays]
        from jax.sharding import NamedSharding, PartitionSpec as P

        out = []
        for a in arrays:
            spec = P(tuple(self.mesh.axis_names), *([None] * (a.ndim - 1)))
            out.append(jax.device_put(a, NamedSharding(self.mesh, spec)))
        return out

    @staticmethod
    def _table_rows(t, al_cap: int):
        """(state_table, delta_nb, delta_fs, al) int32 rows for one
        EncodeTable or _RleEncodeTable (zero 0-bit machine)."""
        st = np.zeros(TABLE, dtype=np.int32)
        dnb = np.zeros(NSYM, dtype=np.int32)
        dfs = np.zeros(NSYM, dtype=np.int32)
        al = getattr(t, "al", 0)
        if al:
            stt = np.asarray(t.state_table, dtype=np.int32)
            st[: len(stt)] = stt
            d1 = np.asarray(t.delta_nb_bits, dtype=np.int64)
            d2 = np.asarray(t.delta_find_state, dtype=np.int64)
            dnb[: len(d1)] = d1.astype(np.int32)
            dfs[: len(d2)] = d2.astype(np.int32)
        return st, dnb, dfs, al

    def encode_batch(self, blocks: list[tuple], tables: list[tuple]) -> list[bytes]:
        """blocks[i] = (lls, mls, ovs) int arrays (non-empty); tables[i] =
        (ll_table, of_table, ml_table) from _pick_table.  Returns each
        block's sequences bitstream (identical to seq.encode_sequences)."""
        if not blocks:
            return []
        S = len(blocks)
        Sp = self._bucket_batch(S)
        ndev = 1
        if self.mesh is not None:
            ndev = int(np.prod([self.mesh.shape[a] for a in self.mesh.axis_names]))
            Sp = max(Sp, ndev)
            Sp += (-Sp) % ndev
        N = self._bucket(max(len(b[0]) for b in blocks))
        shp = (Sp, N)
        r_llx = np.zeros(shp, np.int32)
        r_llnb = np.zeros(shp, np.int32)
        r_mlx = np.zeros(shp, np.int32)
        r_mlnb = np.zeros(shp, np.int32)
        r_ofx = np.zeros(shp, np.int32)
        r_ofnb = np.zeros(shp, np.int32)
        r_llc = np.zeros(shp, np.int32)
        r_mlc = np.zeros(shp, np.int32)
        r_ofc = np.zeros(shp, np.int32)
        n_seq = np.zeros(Sp, np.int32)
        t_rows = {k: ([], [], [], []) for k in ("ll", "of", "ml")}
        for i, ((lls, mls, ovs), (ll_t, of_t, ml_t)) in enumerate(zip(blocks, tables)):
            lls = np.asarray(lls, np.int64)
            mls = np.asarray(mls, np.int64)
            ovs = np.asarray(ovs, np.int64)
            n = len(lls)
            n_seq[i] = n
            llc = ll_codes_np(lls)
            mlc = ml_codes_np(mls)
            ofc = of_codes_np(ovs)
            rev = slice(None, None, -1)
            r_llc[i, :n] = llc[rev]
            r_mlc[i, :n] = mlc[rev]
            r_ofc[i, :n] = ofc[rev]
            r_llx[i, :n] = (lls - _LL_BASE_NP[llc])[rev]
            r_llnb[i, :n] = _LL_BITS_NP[llc][rev]
            r_mlx[i, :n] = (mls - _ML_BASE_NP[mlc])[rev]
            r_mlnb[i, :n] = _ML_BITS_NP[mlc][rev]
            r_ofx[i, :n] = (ovs - (np.int64(1) << ofc.astype(np.int64)))[rev]
            r_ofnb[i, :n] = ofc[rev]
            for kind, t in (("ll", ll_t), ("of", of_t), ("ml", ml_t)):
                st, dnb, dfs, al = self._table_rows(t, 9)
                rows = t_rows[kind]
                rows[0].append(st)
                rows[1].append(dnb)
                rows[2].append(dfs)
                rows[3].append(al)
        tabs = {}
        for kind, rows in t_rows.items():
            pad = Sp - S
            tabs[kind] = (
                np.stack(rows[0] + [np.zeros(TABLE, np.int32)] * pad),
                np.stack(rows[1] + [np.zeros(NSYM, np.int32)] * pad),
                np.stack(rows[2] + [np.zeros(NSYM, np.int32)] * pad),
                np.array(rows[3] + [0] * pad, np.int32),
            )
        # worst case ~58 bits/seq (17+16+9+9+9... capped) + flush + sentinel
        n_words = (N * 64 + 32) // 32 + 2
        args = self._shard(
            r_llx, r_llnb, r_mlx, r_mlnb, r_ofx, r_ofnb,
            r_llc, r_mlc, r_ofc, n_seq,
            *tabs["ll"], *tabs["of"], *tabs["ml"])
        words, total_bits = encode_seq_streams(*args, n_words=n_words)
        words = np.asarray(words)[:S].astype("<u4")
        total_bits = np.asarray(total_bits)[:S]
        out = []
        for i in range(S):
            nbytes = (int(total_bits[i]) + 1 + 7) // 8
            out.append(words[i].tobytes()[:nbytes])
        return out


# ---------------------------------------------------------------------------
# Decode: batched FSE sequence-section decode + rep resolution
# ---------------------------------------------------------------------------
#
# Role parity: the FSE sequence half of ``ZSTD_decompressDCtx``
# (lib/zpack_read.c:380, RFC 8878 §3.1.1.3.2.1.2).  Mirrors the huffman
# lockstep-scan decode: all B blocks' interleaved LL/OF/ML state machines
# advance together in one lax.scan; each step does three fused backward
# bit-window reads (OF extra bits; ML+LL extra bits share one 64-bit
# window; the three state-update reads share another), three packed
# state-table gathers and two packed constant-table gathers — ~11
# (B,)-wide gathers per sequence instead of a host loop.
#
# Repeat-offset resolution is a SEPARATE bulk stage
# (:func:`rep_transition_maps` + :func:`apply_rep_maps`): each sequence's
# rep-state update is a map of the form out_j = in[sel_j] + val_j (or a
# constant), a family closed under composition, so a frame's whole rep
# chain collapses with one associative_scan (log2(N) elementwise passes,
# no gathers).  Block entry states are stitched host-side from the (B, 6)
# per-block totals — tiny transfers only.

_LL_CONST_NP = (_LL_BASE_NP | (_LL_BITS_NP << 20)).astype(np.int32)  # (36,)
_ML_CONST_NP = (_ML_BASE_NP | (_ML_BITS_NP << 20)).astype(np.int32)  # (53,)


def pack_decode_table(t, max_bits_pad: int = TABLE) -> np.ndarray:
    """Pack an fse.DecodeTable into (TABLE,) int32 rows:
    sym | nb_bits << 6 | new_state << 16 (sym<=52, nb<=9, ns<512)."""
    out = np.zeros(max_bits_pad, np.int32)
    size = 1 << t.al
    out[:size] = (t.symbols.astype(np.int32)
                  | (t.nb_bits.astype(np.int32) << 6)
                  | (t.new_state.astype(np.int32) << 16))
    return out


@partial(jax.jit, static_argnames=("n_steps",))
def decode_seq_streams(payloads, bits_left0, ll_al, of_al, ml_al,
                       ll_tab, of_tab, ml_tab, nb_seq, *, n_steps: int):
    """Batched sequence-section bitstream decode.

    payloads (B, P) uint8: the backward bitstream AFTER the table
    descriptors; bits_left0 (B,) int32 from the sentinel; *_al (B,) int32
    accuracy logs; *_tab (B, TABLE) int32 packed tables
    (:func:`pack_decode_table`); nb_seq (B,) int32.

    Returns (lls, mls, ovs) (B, n_steps) int32 — ovs is the RAW offset
    value (pre rep-resolution) — plus final bit positions (B,) int32
    (must be 0 for a fully-consumed valid stream) and err (B,) bool
    (of_code out of the int32-safe range: caller takes the host path).
    """
    B, P = payloads.shape
    pad = jnp.zeros((B, 4), dtype=jnp.uint8)
    b = jnp.concatenate([pad, payloads, pad], axis=1).astype(jnp.uint32)
    w32 = b[:, :-3] | (b[:, 1:-2] << jnp.uint32(8)) \
        | (b[:, 2:-1] << jnp.uint32(16)) | (b[:, 3:] << jnp.uint32(24))
    ll_const = jnp.asarray(_LL_CONST_NP)
    ml_const = jnp.asarray(_ML_CONST_NP)

    def read_bits(pos, n):
        """Bits [pos, pos+n) of the stream, n in 0..32 (data-dependent).
        pos may be negative (overflow reads zero-fill, matching
        BackwardBitReader); n == 0 reads nothing."""
        k = jnp.maximum(pos + 32, 0)
        jb = k >> 3
        sh = (k & 7).astype(jnp.uint32)
        lo = jnp.take_along_axis(w32, jb[:, None], axis=1)[:, 0]
        hi = jnp.take_along_axis(w32, (jb + 4)[:, None], axis=1)[:, 0]
        w = (lo >> sh) | ((hi << jnp.uint32(1)) << (jnp.uint32(31) - sh))
        nn = n.astype(jnp.uint32)
        mask = jnp.where(nn >= 32, jnp.uint32(0xFFFFFFFF),
                         (jnp.uint32(1) << nn) - jnp.uint32(1))
        return w & mask

    def tab_at(tab, state):
        c = jnp.take_along_axis(tab, state[:, None], axis=1)[:, 0]
        return c & 0x3F, (c >> 6) & 0x3FF, c >> 16  # sym, nb, new_state

    # init states: read order LL, OF, ML (host decode_sequences parity)
    pos = bits_left0.astype(jnp.int32)
    pos = pos - ll_al
    ll_s = read_bits(pos, ll_al).astype(jnp.int32)
    pos = pos - of_al
    of_s = read_bits(pos, of_al).astype(jnp.int32)
    pos = pos - ml_al
    ml_s = read_bits(pos, ml_al).astype(jnp.int32)

    def step(carry, i):
        ll_s, ml_s, of_s, pos, err = carry
        act = i < nb_seq
        # --- value phase (read order OF, ML, LL) ---
        of_sym, of_nb, of_ns = tab_at(of_tab, of_s)
        ofc = jnp.where(act, of_sym, 0)
        err = err | (act & (ofc > 30))
        ofc = jnp.minimum(ofc, 30)
        pos = pos - ofc
        of_extra = read_bits(pos, ofc).astype(jnp.int32)
        ov = jnp.where(ofc > 0, (jnp.int32(1) << ofc) + of_extra, 1)
        ml_sym, ml_nb, ml_ns = tab_at(ml_tab, ml_s)
        mlc = jnp.minimum(ml_sym, 52)
        ml_cb = jnp.take(ml_const, mlc)
        ml_bits = jnp.where(act, ml_cb >> 20, 0)
        ll_sym, ll_nb, ll_ns = tab_at(ll_tab, ll_s)
        llc = jnp.minimum(ll_sym, 35)
        ll_cb = jnp.take(ll_const, llc)
        ll_bits = jnp.where(act, ll_cb >> 20, 0)
        # ML then LL: one window, ML occupies the higher bits
        both = ml_bits + ll_bits
        pos = pos - both
        w = read_bits(pos, both)
        ll_mask = (jnp.uint32(1) << ll_bits.astype(jnp.uint32)) - jnp.uint32(1)
        ml_x = (w >> ll_bits.astype(jnp.uint32)).astype(jnp.int32)
        ll_x = (w & ll_mask).astype(jnp.int32)
        ml_v = (ml_cb & 0xFFFFF) + ml_x
        ll_v = (ll_cb & 0xFFFFF) + ll_x
        # --- state update phase (read order LL, ML, OF), skipped on the
        # last sequence of each block ---
        upd = act & ((i + 1) < nb_seq)
        lln = jnp.where(upd, ll_nb, 0)
        mln = jnp.where(upd, ml_nb, 0)
        ofn = jnp.where(upd, of_nb, 0)
        tot = lln + mln + ofn
        pos = pos - tot
        wu = read_bits(pos, tot)
        of_x = (wu & ((jnp.uint32(1) << ofn.astype(jnp.uint32)) - 1)).astype(jnp.int32)
        wu = wu >> ofn.astype(jnp.uint32)
        ml_xu = (wu & ((jnp.uint32(1) << mln.astype(jnp.uint32)) - 1)).astype(jnp.int32)
        ll_xu = (wu >> mln.astype(jnp.uint32)).astype(jnp.int32)
        ll_s = jnp.where(upd, ll_ns + ll_xu, ll_s)
        ml_s = jnp.where(upd, ml_ns + ml_xu, ml_s)
        of_s = jnp.where(upd, of_ns + of_x, of_s)
        out = (jnp.where(act, ll_v, 0), jnp.where(act, ml_v, 0),
               jnp.where(act, ov, 0))
        return (ll_s, ml_s, of_s, pos, err), out

    init = (ll_s, ml_s, of_s, pos, jnp.zeros((B,), bool))
    (_, _, _, pos_f, err), (lls, mls, ovs) = jax.lax.scan(
        step, init, jnp.arange(n_steps, dtype=jnp.int32))
    return (jnp.moveaxis(lls, 0, 1), jnp.moveaxis(mls, 0, 1),
            jnp.moveaxis(ovs, 0, 1), pos_f, err)


@partial(jax.jit)
def rep_prefix_maps(ovs, lls, nb_seq):
    """Inclusive prefix composition of every sequence's rep-state map.

    A sequence's repeat-offset update (codecs/zstd/seq.execute_sequences)
    is one of seven cases, each a map (r0,r1,r2) -> out with
    out_j = in[sel_j] + val_j (sel_j in 0..2) or out_j = val_j (sel_j=3).
    That family is closed under composition, so the whole chain collapses
    with one associative_scan.  The resolved offset of sequence i is
    r0 of (prefix_map_i applied to the block's ENTRY rep state).

    ovs/lls (B, N) int32 raw offset values / literal lengths; nb_seq (B,).
    Returns sel (B, N, 3) int32 and val (B, N, 3) int32 inclusive-prefix
    maps (identity at steps >= nb_seq).
    """
    B, N = ovs.shape
    act = jnp.arange(N, dtype=jnp.int32)[None, :] < nb_seq[:, None]
    litz = lls == 0
    new = ovs > 3
    # per-case (sel0,val0, sel1,val1, sel2,val2); identity where inactive
    c1 = (~litz) & (ovs == 1)          # identity
    c2 = ((~litz) & (ovs == 2)) | (litz & (ovs == 1))   # (r1, r0, r2)
    c3 = ((~litz) & (ovs == 3)) | (litz & (ovs == 2))   # (r2, r0, r1)
    cd = litz & (ovs == 3)             # (r0-1, r0, r1)
    sel0 = jnp.where(new, 3, jnp.where(c2, 1, jnp.where(c3, 2, 0)))
    val0 = jnp.where(new, ovs - 3, jnp.where(cd, -1, 0))
    sel1 = jnp.where(new | c2 | c3 | cd, 0, 1)
    sel2 = jnp.where(new | c3 | cd, 1, 2)
    sel0 = jnp.where(act, sel0, 0)
    val0 = jnp.where(act, val0, 0)
    sel1 = jnp.where(act, sel1, 1)
    sel2 = jnp.where(act, sel2, 2)
    zero = jnp.zeros_like(val0)
    sel = jnp.stack([sel0, sel1, sel2], axis=-1)
    val = jnp.stack([val0, zero, zero], axis=-1)

    def pick(a, idx):
        """a[..., idx] for idx in 0..3 (3 -> marker), as a where-cascade
        (no gathers inside the scan combinator)."""
        return jnp.where(idx == 0, a[..., 0:1],
                         jnp.where(idx == 1, a[..., 1:2], a[..., 2:3]))

    def comb(a, b):
        """b after a (sequence order: a is the earlier prefix)."""
        a_sel, a_val = a
        b_sel, b_val = b
        const = b_sel == 3
        bs = jnp.minimum(b_sel, 2)
        gs = jnp.take_along_axis(a_sel, bs, axis=-1)
        gv = jnp.take_along_axis(a_val, bs, axis=-1)
        c_sel = jnp.where(const, 3, gs)
        c_val = jnp.where(const, b_val, gv + b_val)
        return c_sel, c_val

    sel_p, val_p = jax.lax.associative_scan(comb, (sel, val), axis=1)
    return sel_p, val_p


@partial(jax.jit)
def apply_rep_maps(sel_p, val_p, entry, ovs, lls, nb_seq):
    """Resolved offsets: r0 of each inclusive prefix map applied to the
    block's entry rep state.  entry (B, 3) int32.  Returns offsets
    (B, N) int32 (0 where inactive) and an underflow-error flag (B,)."""
    B, N, _ = sel_p.shape
    e = entry[:, None, :]  # (B, 1, 3)
    s0 = sel_p[..., 0]
    v0 = val_p[..., 0]
    picked = jnp.take_along_axis(
        jnp.broadcast_to(e, (B, N, 3)), jnp.minimum(s0, 2)[..., None],
        axis=-1)[..., 0]
    off = jnp.where(s0 == 3, v0, picked + v0)
    act = jnp.arange(N, dtype=jnp.int32)[None, :] < nb_seq[:, None]
    err = jnp.any(act & (off <= 0), axis=1)
    return jnp.where(act, off, 0), err


def eval_rep_map(sel, val, entry):
    """Host-side (numpy) apply of one map row (3,) to an entry triple —
    the per-block stitching step."""
    out = []
    for j in range(3):
        s, v = int(sel[j]), int(val[j])
        out.append(v if s == 3 else int(entry[s]) + v)
    return out


class DeviceSequenceDecoder:
    """Host wrapper for the batched sequence decode: parses the (tiny)
    table descriptors host-side, batches the backward bitstreams, runs
    :func:`decode_seq_streams`, and resolves repeat offsets with the
    associative-scan stage.  Bit-exact vs seq.decode_sequences +
    execute_sequences' rep logic (tests/test_kernels.py)."""

    BUCKETS = (128, 512, 2048, 8192, 32768)
    PBUCKETS = (256, 1024, 4096, 16384, 65536)

    def __init__(self, mesh=None):
        #: optional jax.sharding.Mesh — block batch shards over its devices
        self.mesh = mesh

    @staticmethod
    def _bucket(n: int, buckets) -> int:
        for b in buckets:
            if n <= b:
                return b
        return int(np.ceil(n / buckets[-1])) * buckets[-1]

    def parse_headers(self, payload: bytes, pos: int, tables) -> tuple:
        """Parse one block's sequence-section headers (count, modes,
        table descriptors — the few-byte host part), mutating ``tables``
        like the host decoder.  Returns (nb_seq, bitstream bytes)."""
        from ..codecs.zstd import seq as S
        from ..errors import DecompressError

        nb_seq, pos = S.parse_nb_sequences(payload, pos)
        if nb_seq == 0:
            return 0, b""
        if pos >= len(payload):
            raise DecompressError("missing compression modes byte")
        modes = payload[pos]
        pos += 1
        if modes & 0x3:
            raise DecompressError("reserved compression-mode bits set")
        tables.ll, pos = S._read_table(payload, pos, (modes >> 6) & 3, "ll",
                                       S.LL_CODE_MAX, S.LL_MAX_AL, tables.ll)
        tables.of, pos = S._read_table(payload, pos, (modes >> 4) & 3, "of",
                                       S.OF_CODE_MAX, S.OF_MAX_AL, tables.of)
        tables.ml, pos = S._read_table(payload, pos, (modes >> 2) & 3, "ml",
                                       S.ML_CODE_MAX, S.ML_MAX_AL, tables.ml)
        return nb_seq, payload[pos:]

    def decode_batch_device(self, items: list[tuple]):
        """Device-resident variant: validates stream consumption, then
        returns ((ll, ml, ov) DEVICE (Bp, N) int32 arrays, nsq (B,)
        np.int32) for further device stages (rep resolution, segment
        assembly) without a metadata round-trip."""
        lls, mls, ovs, nsq = self._decode_common(items)
        return (lls, mls, ovs), nsq

    def decode_batch(self, items: list[tuple]) -> tuple:
        """items[i] = (bitstream bytes, ll_table, of_table, ml_table,
        nb_seq).  Returns (lls, mls, ovs) each a list of np arrays (raw
        offset values, pre rep-resolution)."""
        if not items:
            return [], [], []
        lls, mls, ovs, _nsq = self._decode_common(items)
        lls = np.asarray(lls)
        mls = np.asarray(mls)
        ovs = np.asarray(ovs)
        return ([lls[i, :it[4]] for i, it in enumerate(items)],
                [mls[i, :it[4]] for i, it in enumerate(items)],
                [ovs[i, :it[4]] for i, it in enumerate(items)])

    def _decode_common(self, items: list[tuple]):
        """Shared batch build + kernel run + validity checks; returns
        DEVICE (Bp, N) arrays (lls, mls, ovs) and nsq (B,) np.int32."""
        from ..errors import DecompressError

        B = len(items)
        Bp = DeviceSequenceEncoder._bucket_batch(B)
        N = self._bucket(max(it[4] for it in items), self.BUCKETS)
        P = self._bucket(max(len(it[0]) for it in items), self.PBUCKETS)
        pay = np.zeros((Bp, P), np.uint8)
        bl0 = np.zeros(Bp, np.int32)
        als = np.zeros((3, Bp), np.int32)
        tabs = np.zeros((3, Bp, TABLE), np.int32)
        nsq = np.zeros(Bp, np.int32)
        for i, (bs, llt, oft, mlt, nb) in enumerate(items):
            if not bs or bs[-1] == 0:
                raise DecompressError("corrupt backward bitstream (no sentinel)")
            pay[i, :len(bs)] = np.frombuffer(bs, np.uint8)
            bl0[i] = (len(bs) - 1) * 8 + (bs[-1].bit_length() - 1)
            for j, t in enumerate((llt, oft, mlt)):
                als[j, i] = t.al
                tabs[j, i] = pack_decode_table(t)
            nsq[i] = nb
        from .huffman_jax import shard_rows

        args = shard_rows(self.mesh, pay, bl0, als[0], als[1], als[2],
                          tabs[0], tabs[1], tabs[2], nsq)
        lls, mls, ovs, pos_f, err = decode_seq_streams(*args, n_steps=N)
        pos_f = np.asarray(pos_f)
        err = np.asarray(err)
        if err[:B].any():
            raise DecompressError("offset code out of device range")
        for i in range(B):
            if items[i][4] and pos_f[i] != 0:
                raise DecompressError(
                    "sequence bitstream not fully consumed"
                    if pos_f[i] > 0 else "sequence bitstream over-read")
        return lls, mls, ovs, nsq[:B]
