"""JAX kernel + mesh pipeline tests (run on the 8-device virtual CPU mesh
set up in conftest; chip_smoke.py runs the same kernels on the GPU)."""

import random

import numpy as np
import pytest

import jax

from zpack_tpu.codecs.lz4 import block as lz4block, frame as lz4frame
from zpack_tpu.codecs.xxh3 import xxh3_64
from zpack_tpu.kernels import lz4_jax
from zpack_tpu.kernels.xxh3_jax import xxh3_64_jax
from zpack_tpu.parallel.pipeline import MeshCompressor, make_mesh


def _mix(n, seed=0):
    rng = random.Random(seed)
    out = bytearray()
    while len(out) < n:
        if rng.random() < 0.7:
            out += b"repeating chunk %d " % (rng.randint(0, 8))
        else:
            out += bytes(rng.getrandbits(8) for _ in range(8))
    return bytes(out[:n])


@pytest.mark.parametrize("n", [241, 1024, 1025, 65536, 200001])
def test_xxh3_jax_bit_exact(n):
    data = _mix(n, seed=n)
    assert xxh3_64_jax(data) == xxh3_64(data)


@pytest.mark.parametrize("n", [240, 241, 255, 256, 1023, 1024, 1025, 1087, 1088,
                               1089, 16 * 1024 + 1, 65536 + 64])
def test_xxh3_jax_batch_crosses_boundaries(n):
    """Lengths around the 240 B short-input cut, the 64 B stripe and the
    1 KiB block: a batch of unlike inputs per length, each bit-exact."""
    rng = np.random.default_rng(n)
    batch = [rng.integers(0, 256, n, dtype=np.uint8).tobytes(), b"\0" * n,
             _mix(n, seed=n + 1)]
    assert [xxh3_64_jax(d) for d in batch] == [xxh3_64(d) for d in batch]


@pytest.mark.parametrize("kind,n,depth", [("mix", 8192, 2), ("text", 8192, 8),
                                          ("rand", 8192, 2), ("zeros", 8192, 2),
                                          ("mix", 65536, 2)])
def test_tokenizer_matches_numpy_reference(kind, n, depth):
    """The device tokenizer reproduces codecs/match.sorted_chain_matches,
    the plain numpy statement of its match search, bit for bit."""
    import jax.numpy as jnp

    from zpack_tpu.codecs.match import sorted_chain_matches

    data = {
        "mix": _mix(n, seed=n + depth),
        "rand": bytes(random.Random(n).getrandbits(8) for _ in range(n)),
        "zeros": b"\0" * n,
        "text": (b"the reference and the kernel agree " * (n // 35 + 1))[:n],
    }[kind]
    arr = np.frombuffer(data, dtype=np.uint8)
    src16, code = lz4_jax.tokenize_block_resort(jnp.asarray(arr), depth=depth, n_words=2)
    got_src, got_mlen = lz4_jax.unpack_resort_host(src16, code)
    want_src, want_mlen = sorted_chain_matches(arr, depth, 2)
    np.testing.assert_array_equal(got_mlen, want_mlen)
    np.testing.assert_array_equal(got_src, want_src)


def test_huffman_gather_lookup_matches_onehot():
    """The gather table lookup of the Huffman encoder equals the int8
    one-hot matrix product it replaced, on random tables."""
    import jax.numpy as jnp

    from zpack_tpu.kernels.huffman_jax import _lookup_codes

    rng = np.random.default_rng(12)
    syms = rng.integers(0, 256, 4096).astype(np.uint8)
    codes = rng.integers(0, 1 << 11, 256).astype(np.int32)
    lens = rng.integers(0, 12, 256).astype(np.int32)
    got_len, got_code = _lookup_codes(jnp.asarray(syms), jnp.asarray(codes),
                                      jnp.asarray(lens))
    tab3 = jnp.stack([lens, codes & 0x7F, codes >> 7], axis=1).astype(jnp.int8)
    lut = jax.lax.dot_general(
        jax.nn.one_hot(jnp.asarray(syms, jnp.int32), 256, dtype=jnp.int8), tab3,
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(np.asarray(got_len), np.asarray(lut[:, 0]))
    np.testing.assert_array_equal(np.asarray(got_code),
                                  np.asarray(lut[:, 1] | (lut[:, 2] << 7)))


def test_fse_gather_lookup_matches_onehot():
    """The gather symbol lookup of the FSE encoder equals the f32 one-hot
    einsum it replaced (exact at HIGHEST precision), on random tables."""
    import jax.numpy as jnp

    from zpack_tpu.kernels.fse_jax import NSYM, _symbol_lookup

    rng = np.random.default_rng(13)
    codes = rng.integers(0, NSYM, (16, 512)).astype(np.int32)
    for tab in (rng.integers(0, 1 << 21, (16, NSYM)).astype(np.int32),
                rng.integers(-511, 512, (16, NSYM)).astype(np.int32)):
        got = _symbol_lookup(jnp.asarray(codes), jnp.asarray(tab))
        oh = jax.nn.one_hot(codes, NSYM, dtype=jnp.float32)
        want = jnp.einsum("bnc,bc->bn", oh, jnp.asarray(tab, jnp.float32),
                          precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("kind", ["mix", "rand", "zeros", "text"])
def test_lz4_tokenize_roundtrip(kind):
    data = {
        "mix": _mix(16384),
        "rand": bytes(random.Random(1).getrandbits(8) for _ in range(16384)),
        "zeros": b"\0" * 16384,
        "text": (b"orbit doubling parse on device " * 600)[:16384],
    }[kind]
    comp = lz4_jax.compress_block_device(data)
    assert lz4block.decompress_block(comp, len(data)) == data


def test_lz4_tokenize_partial_block():
    data = _mix(10000, seed=3)
    comp = lz4_jax.compress_block_device(data)
    assert lz4block.decompress_block(comp, len(data)) == data


@pytest.mark.parametrize("kind", ["mix", "rand", "zeros", "text"])
def test_tokenize_u16_matches_noscatter(kind):
    """The u16 resort tokenizer must agree exactly with the reference
    (pos, packed) formulation after host unpack/unsort."""
    import jax.numpy as jnp

    data = {
        "mix": _mix(8192, seed=5),
        "rand": bytes(random.Random(6).getrandbits(8) for _ in range(8192)),
        "zeros": b"\0" * 8192,
        "text": (b"one u16 per byte over the link! " * 256)[:8192],
    }[kind]
    arr = jnp.asarray(np.frombuffer(data, dtype=np.uint8))
    pos, packed = lz4_jax.tokenize_block_noscatter(arr, depth=2, n_words=2)
    want_src, want_mlen = lz4_jax.unsort_host(np.asarray(pos), np.asarray(packed))
    tok = lz4_jax.tokenize_block_u16(arr, depth=2, n_words=2)
    got_src, got_mlen = lz4_jax.unpack_u16_host(tok)
    np.testing.assert_array_equal(got_mlen, want_mlen)
    np.testing.assert_array_equal(np.where(got_mlen > 0, got_src, -1),
                                  np.where(want_mlen > 0, want_src, -1))


@pytest.mark.parametrize("n", [8192, 65536])
def test_tokenize_resort_pair_matches_noscatter(n):
    """The (src u16, code u8) resort tokenizer must agree with the
    reference formulation at any B <= 65536."""
    import jax.numpy as jnp

    data = _mix(n, seed=n)
    arr = jnp.asarray(np.frombuffer(data, dtype=np.uint8))
    pos, packed = lz4_jax.tokenize_block_noscatter(arr, depth=2, n_words=2)
    want_src, want_mlen = lz4_jax.unsort_host(np.asarray(pos), np.asarray(packed))
    src16, code = lz4_jax.tokenize_block_resort(arr, depth=2, n_words=2)
    got_src, got_mlen = lz4_jax.unpack_resort_host(src16, code)
    np.testing.assert_array_equal(got_mlen, want_mlen)
    np.testing.assert_array_equal(np.where(got_mlen > 0, got_src, -1),
                                  np.where(want_mlen > 0, want_src, -1))


def test_mesh_default_block_ratio_robust():
    """Long-period stride data (the 8 KiB-block failure mode: a full
    period of literals per block restart) must stay near native ratio at
    the default mesh block size."""
    from zpack_tpu.codecs.lz4 import frame as lz4frame

    rec = (np.arange(0, 500_000, dtype=np.uint32) % 977).astype(np.uint16).tobytes()
    mc = MeshCompressor(make_mesh())  # default 64 KiB blocks
    comp = mc.compress(rec)
    assert lz4frame.decompress_frame(comp) == rec
    # the mesh emits independent blocks by design (device parallelism);
    # baseline on the same mode — the linked one-shot plays a different game
    native = lz4frame.compress_frame(rec, 1, block_indep=True)
    assert len(comp) <= int(len(native) * 1.25)


def test_mesh_compressor_roundtrip():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    mesh = make_mesh()
    assert mesh.shape["entry"] * mesh.shape["block"] == 8
    mc = MeshCompressor(mesh, block_size=4096)
    data = _mix(100000, seed=9)
    comp = mc.compress(data)
    assert lz4frame.decompress_frame(comp) == data


def test_mesh_compressor_matches_reference_decoder():
    """Frames from the mesh pipeline decode with the incremental decoder
    too (stand-in for reference CLI conformance)."""
    mc = MeshCompressor(make_mesh(), block_size=4096)
    data = _mix(50000, seed=11)
    comp = mc.compress(data)
    d = lz4frame.FrameDecompressor()
    out = bytearray()
    for i in range(0, len(comp), 997):
        out += d.update(comp[i : i + 997])
    assert d.finished and bytes(out) == data


def test_graft_entry():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert len(out) == 2
    g.dryrun_multichip(8)


def test_mesh_zstd_pipeline():
    """Device-tokenized zstd blocks (BASELINE config-5 shape) decode with both
    our decoder and the libzstd oracle."""
    import zstandard

    from zpack_tpu.codecs.zstd import frame as ZF

    mc = MeshCompressor(make_mesh(), block_size=4096)
    data = _mix(120000, seed=21)
    comp = mc.compress_zstd(data, 3)
    assert ZF.decompress(comp) == data
    assert zstandard.ZstdDecompressor().decompress(comp, max_output_size=len(data)) == data


# ---------------------------------------------------------------------------
# Device huffman entropy kernels (kernels/huffman_jax.py)
# ---------------------------------------------------------------------------


def _huff_table_pair(data):
    """(encode table, matching decode table incl. implied last weight)."""
    from zpack_tpu.codecs.zstd import huffman as H

    hist = np.bincount(np.frombuffer(data, dtype=np.uint8), minlength=256)
    et = H.build_encode_table(hist)
    if et is None:
        return None, None
    total = sum((1 << (w - 1)) for w in et.weights if w > 0)
    np2 = 1 << total.bit_length()
    dt = H.build_decode_table(et.weights + [(np2 - total).bit_length()])
    return et, dt


@pytest.mark.parametrize("n", [64, 333, 1024, 5000, 65536])
def test_device_huffman_encode_bit_exact(n):
    from zpack_tpu.codecs.zstd import huffman as H
    from zpack_tpu.kernels.huffman_jax import DeviceHuffmanEncoder

    rng = np.random.default_rng(n)
    data = rng.choice(
        np.arange(48, dtype=np.uint8), size=n,
        p=rng.dirichlet(np.ones(48) * 0.25)).astype(np.uint8).tobytes()
    et, _dt = _huff_table_pair(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    got = DeviceHuffmanEncoder().encode_batch([arr], [et])[0]
    assert got == H._encode_stream(arr, et)


def test_device_huffman_encode_mixed_batch():
    """One dispatch, many streams with DIFFERENT tables and lengths."""
    from zpack_tpu.codecs.zstd import huffman as H
    from zpack_tpu.kernels.huffman_jax import DeviceHuffmanEncoder

    rng = np.random.default_rng(7)
    streams, tables, refs = [], [], []
    for i, n in enumerate([64, 700, 9000, 2048, 100]):
        nsym = 8 + 16 * i
        data = rng.choice(np.arange(nsym, dtype=np.uint8), size=n,
                          p=rng.dirichlet(np.ones(nsym) * 0.4)).astype(np.uint8)
        et, _ = _huff_table_pair(data.tobytes())
        streams.append(data)
        tables.append(et)
        refs.append(H._encode_stream(data, et))
    got = DeviceHuffmanEncoder().encode_batch(streams, tables)
    assert got == refs


def test_device_huffman_4stream_matches_oracle():
    from zpack_tpu.codecs.zstd import huffman as H
    from zpack_tpu.kernels.huffman_jax import DeviceHuffmanEncoder

    rng = np.random.default_rng(3)
    blocks, tables = [], []
    for n in (1024, 4096, 30000):
        data = rng.choice(np.arange(30, dtype=np.uint8), size=n,
                          p=rng.dirichlet(np.ones(30) * 0.3)).astype(np.uint8)
        et, _ = _huff_table_pair(data.tobytes())
        blocks.append(data)
        tables.append(et)
    got = DeviceHuffmanEncoder().encode_4stream_batch(blocks, tables)
    for data, et, g in zip(blocks, tables, got):
        assert g == H.encode_4stream(data.tobytes(), et)


@pytest.mark.parametrize("n", [64, 1024, 20000])
def test_device_huffman_decode_bit_exact(n):
    from zpack_tpu.codecs.zstd import huffman as H
    from zpack_tpu.kernels.huffman_jax import DeviceHuffmanDecoder

    rng = np.random.default_rng(n + 1)
    data = rng.choice(np.arange(20, dtype=np.uint8), size=n,
                      p=rng.dirichlet(np.ones(20) * 0.5)).astype(np.uint8)
    et, dt = _huff_table_pair(data.tobytes())
    payload = H._encode_stream(data, et)
    out = DeviceHuffmanDecoder().decode_batch([payload], [dt], [n])[0]
    assert (out == data).all()
    assert (np.frombuffer(H.decode_1stream(payload, dt, n), np.uint8) == data).all()


def test_device_huffman_decode_mixed_tables():
    """Batch with different max_bits tables (widening path)."""
    from zpack_tpu.codecs.zstd import huffman as H
    from zpack_tpu.kernels.huffman_jax import DeviceHuffmanDecoder

    rng = np.random.default_rng(11)
    payloads, tables, datas = [], [], []
    for nsym, n in [(4, 500), (100, 4000), (30, 1500)]:
        data = rng.choice(np.arange(nsym, dtype=np.uint8), size=n,
                          p=rng.dirichlet(np.ones(nsym) * 0.4)).astype(np.uint8)
        et, dt = _huff_table_pair(data.tobytes())
        payloads.append(H._encode_stream(data, et))
        tables.append(dt)
        datas.append(data)
    outs = DeviceHuffmanDecoder().decode_batch(payloads, tables, [len(d) for d in datas])
    for o, d in zip(outs, datas):
        assert (o == d).all()


def test_device_huffman_decode_rejects_bad_stream():
    from zpack_tpu.codecs.zstd import huffman as H
    from zpack_tpu.errors import DecompressError
    from zpack_tpu.kernels.huffman_jax import DeviceHuffmanDecoder

    rng = np.random.default_rng(5)
    data = rng.choice(np.arange(16, dtype=np.uint8), size=800,
                      p=rng.dirichlet(np.ones(16) * 0.4)).astype(np.uint8)
    et, dt = _huff_table_pair(data.tobytes())
    payload = H._encode_stream(data, et)
    with pytest.raises(DecompressError):
        DeviceHuffmanDecoder().decode_batch([payload], [dt], [790])
    with pytest.raises(DecompressError):
        DeviceHuffmanDecoder().decode_batch([payload[:-1] + b"\x00"], [dt], [800])


def test_literal_sections_device_matches_host():
    """encode_literal_sections: device batch == per-block host encode,
    including the raw/RLE/short fallbacks."""
    from zpack_tpu.codecs.zstd import encode as zenc
    from zpack_tpu.kernels.huffman_jax import DeviceHuffmanEncoder

    rng = np.random.default_rng(9)
    prose = (b"compression is the art of expectation " * 200)
    cases = [
        b"",                                  # empty
        b"\xaa" * 500,                        # RLE
        b"short",                             # < 64: raw
        rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),  # incompressible
        prose,                                # 4-stream huffman
        prose[:700],                          # 1-stream huffman
    ]
    host = zenc.encode_literal_sections(cases, None)
    dev = zenc.encode_literal_sections(cases, DeviceHuffmanEncoder())
    assert host == dev
    for lits, sec in zip(cases, host):
        assert sec == zenc._encode_literals(lits)


def test_mesh_zstd_device_entropy():
    """The mesh zstd pipeline with the device entropy stage is bit-identical
    to host entropy coding and decodes with libzstd."""
    import zstandard

    from zpack_tpu.codecs.zstd import frame as ZF

    mc = MeshCompressor(make_mesh(), block_size=4096)
    data = _mix(150000, seed=33)
    dev = mc.compress_zstd(data, 3, device_entropy=True)
    host = mc.compress_zstd(data, 3, device_entropy=False)
    assert dev == host
    assert ZF.decompress(dev) == data
    assert zstandard.ZstdDecompressor().decompress(dev, max_output_size=len(data)) == data


def test_mesh_compress_packed_serializer_equivalence(monkeypatch):
    """The native packed-input serializer (zn_lz4_serialize_blocks_u16/
    _pair, consuming the device wire format with no host unpack pass)
    must emit byte-identical frames to the int32 unpack path, at both
    block sizes (u16 mode at 4 KiB, pair mode at 64 KiB), incl. a ragged
    tail block."""
    from zpack_tpu import native

    for bs in (4096, 64 << 10):
        mc = MeshCompressor(make_mesh(), block_size=bs)
        data = _mix(3 * bs + 1234, seed=21)
        fast = mc.compress(data)
        monkeypatch.setattr(native, "lz4_serialize_blocks_packed",
                            lambda *a, **k: None)
        slow = mc.compress(data)
        monkeypatch.undo()
        assert fast == slow
        assert lz4frame.decompress_frame(fast) == data


def test_device_fse_sequence_encode_bit_exact():
    """kernels/fse_jax.DeviceSequenceEncoder vs seq.encode_sequences
    across table modes (predefined / custom FSE / RLE), batch shapes and
    n=1 edge (role: the FSE half behind lib/zpack_write.c:179)."""
    from zpack_tpu.codecs.zstd import encode as zenc, seq as zseq
    from zpack_tpu.kernels.fse_jax import DeviceSequenceEncoder

    rng = np.random.default_rng(4)
    blocks, tables, want = [], [], []
    for _ in range(9):
        n = int(rng.integers(1, 300))
        lls = rng.integers(0, 300, n).astype(np.int64)
        mls = rng.integers(3, 80, n).astype(np.int64)
        ovs = rng.integers(1, 70000, n).astype(np.int64)
        ll_codes = [zseq.ll_code(int(v)) for v in lls]
        ml_codes = [zseq.ml_code(int(v)) for v in mls]
        of_codes = [int(v).bit_length() - 1 for v in ovs]
        _, ll_t, _ = zenc._pick_table(ll_codes, "ll", zseq.LL_CODE_MAX, zseq.LL_MAX_AL)
        _, of_t, _ = zenc._pick_table(of_codes, "of", zseq.OF_CODE_MAX, zseq.OF_MAX_AL)
        _, ml_t, _ = zenc._pick_table(ml_codes, "ml", zseq.ML_CODE_MAX, zseq.ML_MAX_AL)
        blocks.append((lls, mls, ovs))
        tables.append((ll_t, of_t, ml_t))
        want.append(zseq.encode_sequences(lls, mls, ovs, ll_t, of_t, ml_t))
    # all-RLE block (single repeated codes -> 0-bit machines)
    lls = np.full(40, 5, np.int64)
    mls = np.full(40, 4, np.int64)
    ovs = np.full(40, 1, np.int64)
    _, ll_t, _ = zenc._pick_table([zseq.ll_code(5)] * 40, "ll", zseq.LL_CODE_MAX, zseq.LL_MAX_AL)
    _, of_t, _ = zenc._pick_table([0] * 40, "of", zseq.OF_CODE_MAX, zseq.OF_MAX_AL)
    _, ml_t, _ = zenc._pick_table([zseq.ml_code(4)] * 40, "ml", zseq.ML_CODE_MAX, zseq.ML_MAX_AL)
    blocks.append((lls, mls, ovs))
    tables.append((ll_t, of_t, ml_t))
    want.append(zseq.encode_sequences(lls, mls, ovs, ll_t, of_t, ml_t))
    got = DeviceSequenceEncoder().encode_batch(blocks, tables)
    assert got == want


def test_mesh_zstd_device_fse_roundtrip():
    """compress_zstd with the fully device-resident entropy stage (huffman
    literals + FSE sequences) stays bit-exact-decodable and matches the
    host-entropy frame size class."""
    import zstandard

    mc = MeshCompressor(make_mesh(), block_size=4096)
    data = _mix(120000, seed=31)
    fr_dev = mc.compress_zstd(data, device_entropy=True)
    fr_host = mc.compress_zstd(data, device_entropy=False)
    assert zstandard.ZstdDecompressor().decompress(
        fr_dev, max_output_size=len(data)) == data
    # device path must not cost ratio beyond the marginal-block fallbacks
    assert len(fr_dev) <= len(fr_host) * 1.01 + 64


def test_device_lz4_sequence_replay():
    """kernels/lz4_jax.DeviceLZ4Replayer vs block.decompress_block:
    bit-exact batched device replay incl. overlapping (RLE) matches and
    literal-only blocks (role: LZ4F_decompress, lib/zpack_read.c:414)."""
    from zpack_tpu.codecs.lz4 import block as lz4block
    from zpack_tpu.kernels.lz4_jax import DeviceLZ4Replayer

    rng = np.random.default_rng(17)
    raws = [
        _mix(30000, seed=51),
        b"a" * 5000 + b"bc" * 2000,          # deep RLE chains
        bytes(rng.integers(0, 256, 2000).astype(np.uint8)),  # literal-only
        (b"0123456789abcdef" * 700)[:10000],
    ]
    blocks = [lz4block.compress_block(r) for r in raws]
    outs = DeviceLZ4Replayer().decompress_blocks(blocks, [len(r) for r in raws])
    for got, want in zip(outs, raws):
        assert got == want


def test_batched_device_extract_lz4f():
    """parallel/extract.decompress_lz4f_batched: mesh-pipeline frames
    (independent 64 KiB blocks) decode bit-exact via the device replay;
    content checksums verified; linked-block frames raise for the host
    fallback."""
    import pytest

    from zpack_tpu.codecs.lz4 import frame as lz4frame
    from zpack_tpu.errors import DecompressError
    from zpack_tpu.parallel.extract import decompress_lz4f_batched

    data = _mix(200000, seed=61)
    mc = MeshCompressor(make_mesh(), block_size=4096)
    fr = mc.compress(data)
    assert decompress_lz4f_batched(fr) == data
    fr_indep = lz4frame.compress_frame(data, 1, block_indep=True,
                                       content_checksum=True)
    assert decompress_lz4f_batched(fr_indep) == data
    fr_linked = lz4frame.compress_frame(data, 1, block_indep=False)
    with pytest.raises(DecompressError):
        decompress_lz4f_batched(fr_linked)


# ---------------------------------------------------------------------------
# Round 5: device FSE sequence decode + fully device-resident zstd extract
# ---------------------------------------------------------------------------


def _seq_heavy_corpora():
    rng = np.random.default_rng(11)
    words = [rng.integers(65, 90, rng.integers(3, 12)).astype(np.uint8).tobytes()
             for _ in range(300)]
    blob1 = b" ".join(words[rng.integers(0, 300)] for _ in range(40000))[:400000]
    base = rng.integers(0, 256, 1024).astype(np.uint8).tobytes()
    blob2 = b"".join(base[i % 37 : i % 37 + 700]
                     + rng.integers(0, 256, 40).astype(np.uint8).tobytes()
                     for i in range(500))[:300000]
    return [("words", blob1), ("strided", blob2)]


def test_device_fse_sequence_decode_bit_exact():
    """decode_seq_streams + DeviceSequenceDecoder vs seq.decode_sequences
    on libzstd- and own-encoder-produced frames (role: the FSE half of
    ZSTD_decompressDCtx, lib/zpack_read.c:380)."""
    import struct

    import zstandard

    from zpack_tpu.codecs.zstd import frame as zframe, seq as zseq
    from zpack_tpu.kernels.fse_jax import DeviceSequenceDecoder

    dsd = DeviceSequenceDecoder()
    checked = 0
    for name, blob in _seq_heavy_corpora():
        for comp in (zstandard.ZstdCompressor(level=3).compress(blob),
                     zstandard.ZstdCompressor(level=19).compress(blob)):
            pos = 4
            header = zframe.parse_frame_header(comp, pos)
            pos += header.header_size
            tables, tables2 = zseq.SequenceTables(), zseq.SequenceTables()
            lit_state = zframe.LiteralsState()
            items, wants = [], []
            while True:
                bh = comp[pos] | (comp[pos + 1] << 8) | (comp[pos + 2] << 16)
                pos += 3
                last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
                payload = comp[pos : pos + (1 if btype == zframe.BLOCK_RLE else bsize)]
                pos += len(payload)
                if btype == zframe.BLOCK_COMPRESSED:
                    _, lits_end = zframe.parse_literals_section(payload, 0, lit_state)
                    want = zseq.decode_sequences(payload, lits_end, tables)
                    nb, bs = dsd.parse_headers(payload, lits_end, tables2)
                    if nb:
                        items.append((bs, tables2.ll, tables2.of, tables2.ml, nb))
                        wants.append(want)
                if last:
                    break
            lls, mls, ovs = dsd.decode_batch(items)
            for i, (wl, wm, wo, wn) in enumerate(wants):
                assert np.array_equal(lls[i], wl)
                assert np.array_equal(mls[i], wm)
                assert np.array_equal(ovs[i], wo)
                checked += wn
    assert checked > 5000


def test_rep_prefix_maps_match_host_logic():
    """Associative-scan rep resolution vs the reference rep state machine
    (execute_sequences' 7-case update, lib zstd semantics)."""
    import jax.numpy as jnp

    from zpack_tpu.kernels.fse_jax import (apply_rep_maps, eval_rep_map,
                                           rep_prefix_maps)

    def host_rep(ovs, lls, rep):
        offs = []
        for ov, ll in zip(ovs, lls):
            ov, ll = int(ov), int(ll)
            if ov > 3:
                offset = ov - 3
                rep[2], rep[1], rep[0] = rep[1], rep[0], offset
            elif ll != 0:
                if ov == 1:
                    offset = rep[0]
                elif ov == 2:
                    offset = rep[1]
                    rep[1], rep[0] = rep[0], offset
                else:
                    offset = rep[2]
                    rep[2], rep[1], rep[0] = rep[1], rep[0], offset
            else:
                if ov == 1:
                    offset = rep[1]
                    rep[1], rep[0] = rep[0], offset
                elif ov == 2:
                    offset = rep[2]
                    rep[2], rep[1], rep[0] = rep[1], rep[0], offset
                else:
                    offset = rep[0] - 1
                    rep[2], rep[1], rep[0] = rep[1], rep[0], offset
            offs.append(offset)
        return offs, rep

    rng = np.random.default_rng(7)
    B, N = 16, 512
    ovs = np.where(rng.random((B, N)) < 0.55, rng.integers(1, 4, (B, N)),
                   rng.integers(4, 5000, (B, N))).astype(np.int32)
    lls = np.where(rng.random((B, N)) < 0.3, 0,
                   rng.integers(1, 50, (B, N))).astype(np.int32)
    nsq = rng.integers(1, N + 1, B).astype(np.int32)
    sel_p, val_p = rep_prefix_maps(jnp.asarray(ovs), jnp.asarray(lls),
                                   jnp.asarray(nsq))
    entry = np.tile(np.array([100001, 100004, 100008], np.int32), (B, 1))
    offs, err = apply_rep_maps(sel_p, val_p, jnp.asarray(entry),
                               jnp.asarray(ovs), jnp.asarray(lls),
                               jnp.asarray(nsq))
    offs = np.asarray(offs)
    assert not np.asarray(err).any()
    sel_p, val_p = np.asarray(sel_p), np.asarray(val_p)
    for b in range(B):
        want, rep_end = host_rep(ovs[b, : nsq[b]], lls[b, : nsq[b]],
                                 [100001, 100004, 100008])
        assert np.array_equal(offs[b, : nsq[b]], np.array(want))
        tot = eval_rep_map(sel_p[b, nsq[b] - 1], val_p[b, nsq[b] - 1], entry[b])
        assert tot == rep_end


def test_device_extract_zstd_fully_resident():
    """decompress_zstd_device round-trips libzstd and own-encoder frames
    bit-exactly with zero host entropy work (VERDICT r4 missing #1)."""
    import zstandard

    from zpack_tpu import native
    from zpack_tpu.parallel.extract import decompress_zstd_device

    rng = np.random.default_rng(3)
    corpora = _seq_heavy_corpora() + [
        ("rand", rng.integers(0, 256, 150000).astype(np.uint8).tobytes()),
        ("rle", b"\x42" * 200000),
    ]
    blobs = []
    for name, blob in corpora:
        for comp in (zstandard.ZstdCompressor(level=3).compress(blob),
                     zstandard.ZstdCompressor(level=19).compress(blob),
                     native.zstd_compress(blob, 3)):
            assert decompress_zstd_device(comp, len(blob)) == blob, name
        blobs.append(blob)
    multi = b"".join(zstandard.ZstdCompressor(level=3).compress(b)
                     for b in blobs)
    assert decompress_zstd_device(multi) == b"".join(blobs)


def test_device_extract_zstd_detects_corruption():
    import zstandard

    from zpack_tpu.errors import DecompressError
    from zpack_tpu.parallel.extract import decompress_zstd_device

    blob = _seq_heavy_corpora()[0][1]
    comp = bytearray(zstandard.ZstdCompressor(level=3).compress(blob))
    comp[len(comp) // 2] ^= 0xFF
    with pytest.raises(DecompressError):
        decompress_zstd_device(bytes(comp), len(blob))
