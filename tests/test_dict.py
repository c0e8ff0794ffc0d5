"""Shared zstd dictionary support (extension beyond the reference, which
passes no dictionaries to zstd — lib/zpack_write.c:179; BASELINE.json
north-star item "shared zstd dictionaries broadcast over the mesh").

Interop oracle: the python-zstandard binding of libzstd, both directions.
"""

import numpy as np
import pytest

from zpack_tpu import constants as C
from zpack_tpu.codecs.zstd import dict as zdict, encode as zenc, frame as zframe
from zpack_tpu.errors import DecompressError
from zpack_tpu.reader import Reader
from zpack_tpu.writer import CompressOptions, Writer

zstandard = pytest.importorskip("zstandard")


def _samples(n=60, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rec = (b'{"user":"name%d","role":"admin","perm":["read","write"],'
               b'"ts":%d}' % (i, 1000 + i))
        out.append(rec * 3 + bytes(rng.integers(0, 256, 20).astype(np.uint8)))
    return out


@pytest.fixture(scope="module")
def samples():
    return _samples()


@pytest.fixture(scope="module")
def trained(samples):
    return zdict.train_dictionary(samples, 4096)


def test_train_parse_roundtrip(samples, trained):
    d = zdict.parse_dictionary(trained)
    assert d.dict_id != 0
    assert 32767 < d.dict_id < (1 << 31)  # outside reserved ranges
    assert d.huf is not None and d.ll is not None
    assert all(0 < r <= len(d.content) for r in d.rep)


def test_libzstd_loads_our_dict(samples, trained):
    cd = zstandard.ZstdCompressionDict(trained)
    assert cd.dict_id() == zdict.parse_dictionary(trained).dict_id
    fr = zstandard.ZstdCompressor(level=3, dict_data=cd).compress(samples[0])
    nodict = zstandard.ZstdCompressor(level=3).compress(samples[0])
    assert len(fr) < len(nodict)


def test_parse_zstandard_trained_dict(samples):
    td = zstandard.train_dictionary(4096, [bytes(s) for s in samples] * 2)
    d = zdict.parse_dictionary(td.as_bytes())
    assert d.dict_id == td.dict_id()
    assert d.huf is not None and d.of is not None and d.ml is not None


@pytest.mark.parametrize("level", [1, 3, 19])
def test_decode_libzstd_dict_frames(samples, level):
    """Structured-dict frames from libzstd (exercise dict entropy tables,
    dict-content offsets, and dict rep offsets) decode bit-exactly."""
    td = zstandard.train_dictionary(4096, [bytes(s) for s in samples] * 2)
    c = zstandard.ZstdCompressor(level=level, dict_data=td)
    for s in samples[:8]:
        assert zframe.decompress(c.compress(s), dictionary=td.as_bytes()) == s


def test_decode_libzstd_raw_dict_frames(samples):
    raw = bytes(samples[0][:2000])
    cd = zstandard.ZstdCompressionDict(raw, dict_type=zstandard.DICT_TYPE_RAWCONTENT)
    fr = zstandard.ZstdCompressor(level=3, dict_data=cd).compress(samples[1])
    assert zframe.decompress(fr, dictionary=raw) == samples[1]


def test_dict_frame_requires_dict(samples, trained):
    fr = zenc.compress(samples[0], 3, dictionary=trained)
    with pytest.raises(DecompressError):
        zframe.decompress(fr)
    wrong = zdict.train_dictionary(_samples(seed=9), 4096)
    with pytest.raises(DecompressError):
        zframe.decompress(fr, dictionary=wrong)


@pytest.mark.parametrize("level", [1, 3])
def test_encode_with_dict_roundtrip_and_interop(samples, trained, level):
    d = zdict.parse_dictionary(trained)
    cd = zstandard.ZstdCompressionDict(trained)
    dec = zstandard.ZstdDecompressor(dict_data=cd)
    for s in samples[:8]:
        fr = zenc.compress(s, level, dictionary=d)
        assert zframe.decompress(fr, dictionary=d) == s
        assert dec.decompress(fr) == s


def test_encode_dict_beats_nodict(samples, trained):
    d = zdict.parse_dictionary(trained)
    with_d = sum(len(zenc.compress(s, 3, dictionary=d)) for s in samples[:20])
    without = sum(len(zenc.compress(s, 3)) for s in samples[:20])
    assert with_d < 0.8 * without


def test_encode_dict_multiblock(samples, trained):
    d = zdict.parse_dictionary(trained)
    big = b"".join(samples) * 40  # > 128 KiB blocks
    fr = zenc.compress(big, 3, dictionary=d)
    assert zframe.decompress(fr, dictionary=d) == big
    cd = zstandard.ZstdCompressionDict(trained)
    assert zstandard.ZstdDecompressor(dict_data=cd).decompress(fr) == big


def test_encode_dict_empty(trained):
    d = zdict.parse_dictionary(trained)
    fr = zenc.compress(b"", 3, dictionary=d)
    assert zframe.decompress(fr, dictionary=d) == b""


def test_raw_dict_encode_retry_decode(samples):
    """Raw-content dicts leave dict_id = 0; the reader's retry path must
    still find the archive dictionary."""
    raw = bytes(samples[0][:2000])
    fr = zenc.compress(samples[1], 3, dictionary=raw)
    assert zframe.decompress(fr, dictionary=raw) == samples[1]
    with pytest.raises(DecompressError):
        zframe.decompress(fr)


# ---------------------------------------------------------------------------
# Archive-level integration
# ---------------------------------------------------------------------------


def _dict_archive(samples, trained):
    w = Writer.to_heap()
    w.write_header()
    w.write_data_header()
    w.set_dictionary(trained)
    w.write_files([(f"f{i:03}.json", s, CompressOptions(C.CompressionMethod.ZSTD, 3))
                   for i, s in enumerate(samples)])
    w.write_cdr()
    w.write_eocdr()
    return w.buffer


def test_archive_dict_roundtrip(samples, trained):
    buf = _dict_archive(samples, trained)
    r = Reader.from_memory(buf, shared=True)
    names = [e.filename for e in r.file_entries]
    assert C.DICT_ENTRY_NAME in names
    for i, s in enumerate(samples):
        assert r.read_file(f"f{i:03}.json") == s  # XXH3-verified
    # batch path (routes per-entry because of the dict)
    outs = r.read_files([f"f{i:03}.json" for i in range(len(samples))])
    assert outs == samples


def test_archive_dict_beats_nodict(samples, trained):
    with_d = len(_dict_archive(samples, trained))
    w = Writer.to_heap()
    w.write_header()
    w.write_data_header()
    w.write_files([(f"f{i:03}.json", s, CompressOptions(C.CompressionMethod.ZSTD, 3))
                   for i, s in enumerate(samples)])
    w.write_cdr()
    w.write_eocdr()
    without = len(w.buffer)
    assert with_d < without  # incl. the stored dictionary itself


def test_dict_ratio_win_pinned(trained):
    """Pin the property that justifies the feature (VERDICT r2 item 7):
    on a small-files corpus large enough to amortize the stored
    dictionary entry (300 files x ~250 B), the dict-mode archive —
    INCLUDING the stored dictionary — is >=25% smaller than the no-dict
    archive, and our dict frames total <= libzstd's own dict frames at
    the same level (measured 0.984x: FSE repeat-mode + treeless literals
    against the dict's entropy tables plus single-segment headers).  A
    regression past either pin fails CI."""
    corpus = _samples(n=300, seed=3)
    trained = zdict.train_dictionary(corpus[:60], 4096)  # in-domain training
    with_d = len(_dict_archive(corpus, trained))
    w = Writer.to_heap()
    w.write_header()
    w.write_data_header()
    w.write_files([(f"f{i:03}.json", s, CompressOptions(C.CompressionMethod.ZSTD, 3))
                   for i, s in enumerate(corpus)])
    w.write_cdr()
    w.write_eocdr()
    without = len(w.buffer)
    assert with_d <= 0.75 * without, (with_d, without)

    d = zdict.parse_dictionary(trained)
    cd = zstandard.ZstdCompressionDict(trained)
    ours = sum(len(zenc.compress(s, 3, dictionary=d)) for s in corpus)
    libz = sum(len(zstandard.ZstdCompressor(level=3, dict_data=cd).compress(s))
               for s in corpus)
    assert ours <= libz, (ours, libz)


def test_archive_dict_streaming_read(samples, trained):
    from zpack_tpu.stream import init_stream, read_file_stream

    buf = _dict_archive(samples, trained)
    r = Reader.from_memory(buf, shared=True)
    st = init_stream()
    out = bytearray()
    st.avail_in = 16
    st.avail_out = 16
    while read_file_stream(r, "f001.json", st):
        out += st.next_out
    out += st.next_out
    assert bytes(out) == samples[1]


def test_archive_dict_streaming_write(samples, trained):
    w = Writer.to_heap()
    w.write_header()
    w.write_data_header()
    w.set_dictionary(trained)
    big = b"".join(samples)
    w.write_file_stream_begin("big.bin", CompressOptions(C.CompressionMethod.ZSTD, 3))
    for i in range(0, len(big), 777):
        w.write_file_stream(big[i : i + 777])
    w.write_file_stream_end()
    w.write_cdr()
    w.write_eocdr()
    r = Reader.from_memory(w.buffer, shared=True)
    assert r.read_file("big.bin") == big


def test_attach_dictionary_explicit(samples, trained):
    """Frames referencing a dict decode when the dict is attached via the
    API even if the archive doesn't store it."""
    d = zdict.parse_dictionary(trained)
    w = Writer.to_heap()
    w.write_header()
    w.write_data_header()
    w.write_files([("a.json", samples[0],
                    CompressOptions(C.CompressionMethod.ZSTD, 3, dictionary=d))])
    w.write_cdr()
    w.write_eocdr()
    r = Reader.from_memory(w.buffer, shared=True)
    with pytest.raises(Exception):
        r.read_file("a.json")
    r2 = Reader.from_memory(w.buffer, shared=True)
    r2.attach_dictionary(trained)
    assert r2.read_file("a.json") == samples[0]


def test_cli_dict_flow(tmp_path, samples, trained):
    from zpack_tpu.cli.main import main as cli_main

    src = tmp_path / "src"
    src.mkdir()
    for i, s in enumerate(samples[:20]):
        (src / f"f{i:03}.json").write_bytes(s)
    dict_path = tmp_path / "d.dict"
    arc = tmp_path / "a.zpk"
    out = tmp_path / "out"
    assert cli_main(["train-dict", str(dict_path), str(src),
                     "--dict-size", "4096"]) == 0
    assert dict_path.stat().st_size > 0
    assert cli_main(["c", str(arc), str(src), "-m", "zstd:3",
                     "-D", str(dict_path)]) == 0
    assert cli_main(["t", str(arc)]) == 0
    assert cli_main(["x", str(arc), "-o", str(out)]) == 0
    extracted = sorted(p.name for p in out.rglob("*") if p.is_file())
    assert C.DICT_ENTRY_NAME not in extracted
    for i, s in enumerate(samples[:20]):
        got = next(out.rglob(f"f{i:03}.json"))
        assert got.read_bytes() == s


def test_mesh_dict_broadcast(samples, trained):
    """North-star path: dict replicated over the device mesh, one
    dict-referencing frame per block; decodes with us and with libzstd."""
    import io

    import jax

    from zpack_tpu.parallel.pipeline import MeshCompressor, make_mesh

    rng = np.random.default_rng(3)
    zd = zdict.parse_dictionary(trained)
    mc = MeshCompressor(make_mesh(jax.devices()), block_size=8192)
    data = b"".join(samples[:40]) + bytes(rng.integers(0, 256, 3000).astype(np.uint8))
    comp_d = mc.compress_zstd(data, 3, dictionary=zd)
    comp_n = mc.compress_zstd(data, 3)
    assert zframe.decompress(comp_d, dictionary=zd) == data
    assert len(comp_d) < len(comp_n)  # dict must pay for itself here
    dctx = zstandard.ZstdDecompressor(
        dict_data=zstandard.ZstdCompressionDict(trained))
    r = dctx.stream_reader(io.BytesIO(comp_d), read_across_frames=True)
    assert r.read() == data


def test_mesh_dict_window_guard(trained):
    import jax

    from zpack_tpu.parallel.pipeline import MeshCompressor, make_mesh

    zd = zdict.parse_dictionary(trained)
    mc = MeshCompressor(make_mesh(jax.devices()), block_size=64 << 10)
    with pytest.raises(ValueError):
        mc.compress_zstd(b"x" * 100000, 3, dictionary=zd)
