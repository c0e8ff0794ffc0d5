"""XXH3-64 on the device via JAX.

Every u64 is a (hi, lo) pair of uint32 lanes; 64-bit adds/multiplies are
built from 16/32-bit limbs, so the kernel needs no 64-bit JAX mode.
Whether native u64 is faster on the GPU is open (ROADMAP S5, D5).  The
stripe accumulation (the bandwidth-bound bulk of XXH3) is fully
vectorized over stripes; the only sequential dependency is the
per-1KiB-block scramble, carried by one lax.scan whose step is 8 lanes
of scalar work.

Role parity: XXH3_64bits (reference usage: lib/zpack_write.c:256,
lib/zpack_read.c:466); bit-exact against zpack_tpu.codecs.xxh3.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..codecs import xxh3 as H

_STRIPE = 64
_SPB = 16  # stripes per block
_BLOCK = 1024

_U32 = jnp.uint32
_MASK16 = jnp.uint32(0xFFFF)


def _split64(vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return (vals >> np.uint64(32)).astype(np.uint32), (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _add64(ah, al, bh, bl):
    lo = al + bl
    carry = (lo < al).astype(_U32)
    hi = ah + bh + carry
    return hi, lo


def _mul32_64(a, b):
    """uint32 × uint32 → (hi, lo) uint32 pair, via 16-bit limbs."""
    a_lo = a & _MASK16
    a_hi = a >> 16
    b_lo = b & _MASK16
    b_hi = b >> 16
    p_ll = a_lo * b_lo
    p_lh = a_lo * b_hi
    p_hl = a_hi * b_lo
    p_hh = a_hi * b_hi
    mid = (p_ll >> 16) + (p_lh & _MASK16) + (p_hl & _MASK16)
    lo = (p_ll & _MASK16) | ((mid & _MASK16) << 16)
    hi = p_hh + (p_lh >> 16) + (p_hl >> 16) + (mid >> 16)
    return hi, lo


def _mul64(ah, al, bh, bl):
    """full 64×64 → low 64 bits as (hi, lo)."""
    hi, lo = _mul32_64(al, bl)
    hi = hi + al * bh + ah * bl
    return hi, lo


def _bytes_to_u32(data: jax.Array) -> jax.Array:
    """uint8[N] → uint32[N/4] little-endian."""
    quads = data.reshape(-1, 4).astype(jnp.uint32)
    return quads[:, 0] | (quads[:, 1] << 8) | (quads[:, 2] << 16) | (quads[:, 3] << 24)


@partial(jax.jit, static_argnames=("length",))
def _accumulate(data: jax.Array, secret_lanes_hi: jax.Array, secret_lanes_lo: jax.Array,
                length: int):
    """Run the XXH3 long-input accumulator over whole stripes.

    data: uint8[(nb_stripes*64)] — the first (length-1)//64 stripes.
    Returns acc as (hi, lo) uint32[8] pairs *before* the last-stripe step.
    """
    u32 = _bytes_to_u32(data)  # [nb_stripes*16]
    nb_stripes = u32.shape[0] // 16
    lanes_lo = u32[0::2].reshape(nb_stripes, 8)  # u64 lane low words
    lanes_hi = u32[1::2].reshape(nb_stripes, 8)

    nb_blocks = nb_stripes // _SPB
    rem = nb_stripes - nb_blocks * _SPB

    acc_hi = jnp.asarray((np.array(H._INIT_ACC, dtype=np.uint64) >> np.uint64(32)).astype(np.uint32))
    acc_lo = jnp.asarray((np.array(H._INIT_ACC, dtype=np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    def stripe_contrib(d_hi, d_lo, s_hi, s_lo):
        """contribution of stripes: (mul_hi, mul_lo, swap_hi, swap_lo).
        acc[i] += (key & 0xffffffff) * (key >> 32); acc[i^1] += data."""
        k_hi = d_hi ^ s_hi
        k_lo = d_lo ^ s_lo
        m_hi, m_lo = _mul32_64(k_lo, k_hi)
        swap = H._SWAP_IDX
        return m_hi, m_lo, d_hi[..., swap], d_lo[..., swap]

    if nb_blocks:
        blk_hi = lanes_hi[: nb_blocks * _SPB].reshape(nb_blocks, _SPB, 8)
        blk_lo = lanes_lo[: nb_blocks * _SPB].reshape(nb_blocks, _SPB, 8)
        m_hi, m_lo, s_hi, s_lo = stripe_contrib(blk_hi, blk_lo,
                                                secret_lanes_hi, secret_lanes_lo)

        def block_sum(h_parts, l_parts):
            # sum 16 u64 per lane with carries: accumulate sequentially in
            # vector form (16 adds of [nb_blocks, 8] — still vectorized)
            hh = h_parts[:, 0]
            ll = l_parts[:, 0]
            for s in range(1, _SPB):
                hh, ll = _add64(hh, ll, h_parts[:, s], l_parts[:, s])
            return hh, ll

        msum_hi, msum_lo = block_sum(m_hi, m_lo)
        ssum_hi, ssum_lo = block_sum(s_hi, s_lo)

        P32_1 = jnp.uint32(H.PRIME32_1)

        def scan_body(carry, xs):
            a_hi, a_lo = carry
            mh, ml, sh, sl = xs
            a_hi, a_lo = _add64(a_hi, a_lo, mh, ml)
            a_hi, a_lo = _add64(a_hi, a_lo, sh, sl)
            # scramble: acc ^= acc >> 47; acc ^= secret_tail; acc *= PRIME32_1
            # (a >> 47) as a pair is (0, hi >> 15)
            a_lo2 = a_lo ^ (a_hi >> 15) ^ _SCRAMBLE_LO
            a_hi2 = a_hi ^ _SCRAMBLE_HI
            n_hi, n_lo = _mul64(a_hi2, a_lo2, jnp.uint32(0), P32_1)
            return (n_hi, n_lo), None

        (acc_hi, acc_lo), _ = jax.lax.scan(
            scan_body, (acc_hi, acc_lo),
            (msum_hi, msum_lo, ssum_hi, ssum_lo),
        )
    if rem:
        r_hi = lanes_hi[nb_blocks * _SPB :]
        r_lo = lanes_lo[nb_blocks * _SPB :]
        m_hi, m_lo, s_hi, s_lo = stripe_contrib(r_hi, r_lo,
                                                secret_lanes_hi[:rem], secret_lanes_lo[:rem])
        for s in range(rem):
            acc_hi, acc_lo = _add64(acc_hi, acc_lo, m_hi[s], m_lo[s])
            acc_hi, acc_lo = _add64(acc_hi, acc_lo, s_hi[s], s_lo[s])
    return acc_hi, acc_lo


_SCRAMBLE_HI = None
_SCRAMBLE_LO = None


def _init_consts():
    global _SCRAMBLE_HI, _SCRAMBLE_LO
    tail = np.frombuffer(H.KSECRET, dtype="<u8", count=8,
                         offset=H.SECRET_SIZE - H.STRIPE_LEN)
    _SCRAMBLE_HI = jnp.asarray((tail >> np.uint64(32)).astype(np.uint32))
    _SCRAMBLE_LO = jnp.asarray((tail & np.uint64(0xFFFFFFFF)).astype(np.uint32))


_init_consts()


def xxh3_64_jax(data: bytes | np.ndarray) -> int:
    """One-shot XXH3-64 with the stripe accumulation on device (seed 0,
    inputs > 240 bytes; shorter inputs fall back to the host path)."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    length = len(buf)
    if length <= H.MIDSIZE_MAX:
        return H.xxh3_64(buf.tobytes())
    nb_stripes = (length - 1) // _STRIPE
    secret_lanes = H._KSECRET_LANES
    sec_hi = jnp.asarray((secret_lanes >> np.uint64(32)).astype(np.uint32))
    sec_lo = jnp.asarray((secret_lanes & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    acc_hi, acc_lo = _accumulate(jnp.asarray(buf[: nb_stripes * _STRIPE]),
                                 sec_hi, sec_lo, length)
    acc = (np.asarray(acc_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(acc_lo).astype(np.uint64)
    # last stripe + merge on host (a handful of scalar u64 ops)
    last = np.frombuffer(buf[length - _STRIPE :].tobytes(), dtype="<u8")
    lsec = np.frombuffer(H.KSECRET, dtype="<u8", count=8,
                         offset=H.SECRET_SIZE - H.STRIPE_LEN - H._SECRET_LASTACC_START)
    key = last ^ lsec
    acc += (key & np.uint64(0xFFFFFFFF)) * (key >> np.uint64(32))
    acc += last[H._SWAP_IDX]
    return H._merge_accs(acc, H.KSECRET, (length * H.PRIME64_1) & H.MASK64)
