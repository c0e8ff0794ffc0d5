"""The device engine's routing on the virtual CPU mesh: which frames go to
the device, which to the host and how that is counted, errors that must
surface, the CLI round trip, mesh shapes, the compile cache location and
chip_smoke's refusal of a CPU backend."""

import os

import jax
import numpy as np
import pytest

from zpack_tpu.codecs.lz4 import frame as lz4frame
from zpack_tpu.errors import DecompressError
from zpack_tpu.utils.observe import metrics


def _mix(n, seed=0):
    rng = np.random.default_rng(seed)
    text = np.frombuffer(b"device engine routing text " * (n // 27 + 1), np.uint8)[:n]
    return bytes(np.where(rng.random(n) < 0.8, text,
                          rng.integers(0, 256, n)).astype(np.uint8))


def _calls(name):
    return metrics.snapshot().get(name, {}).get("calls", 0)


@pytest.fixture
def device_engine(monkeypatch, tmp_path):
    """ZPACK_TPU_ENGINE=device, small mesh steps, and a compile cache
    directory of the test's own (JAX read the variable at import, so the
    cache stays off in this process)."""
    from zpack_tpu.codecs import lz4 as lz4codec
    from zpack_tpu.parallel.pipeline import MeshCompressor

    monkeypatch.setenv("ZPACK_TPU_ENGINE", "device")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(MeshCompressor, "BYTES_PER_DEVICE_STEP", 64 << 10)
    monkeypatch.setattr(lz4codec, "_MESH_COMPRESSORS", {})
    return tmp_path


def test_linked_lz4_frame_takes_counted_host_path(device_engine):
    from zpack_tpu.codecs.lz4 import LZ4Codec

    data = _mix(200_000, seed=1)
    linked = lz4frame.compress_frame(data, 1, block_indep=False)
    indep = lz4frame.compress_frame(data, 1, block_indep=True)
    assert lz4frame.has_linked_blocks(linked)
    assert not lz4frame.has_linked_blocks(indep)
    assert lz4frame.has_linked_blocks(indep + linked)  # any frame decides
    host0, dev0 = _calls("lz4.decompress.host_linked"), _calls("extract.lz4_device")
    assert LZ4Codec().decompress(linked, len(data)) == data
    assert _calls("lz4.decompress.host_linked") == host0 + 1
    assert _calls("extract.lz4_device") == dev0
    assert LZ4Codec().decompress(indep, len(data)) == data
    assert _calls("extract.lz4_device") == dev0 + 1
    assert _calls("lz4.decompress.host_linked") == host0 + 1


def test_corrupt_independent_lz4_frame_raises_on_device(device_engine, monkeypatch):
    from zpack_tpu.codecs.lz4 import LZ4Codec
    from zpack_tpu.parallel import host

    def no_host(*args, **kwargs):
        raise AssertionError("device engine fell back to the host decoder")

    monkeypatch.setattr(lz4frame, "decompress_frame", no_host)
    monkeypatch.setattr(host, "lz4f_decompress_parallel", no_host)
    data = _mix(150_000, seed=2)
    fr = bytearray(lz4frame.compress_frame(data, 1, block_indep=True,
                                           content_checksum=True))
    fr[len(fr) // 2] ^= 0x5A
    with pytest.raises(DecompressError):
        LZ4Codec().decompress(bytes(fr), len(data))


@pytest.mark.parametrize("method,phase", [("lz4:1", "extract.lz4_device"),
                                          ("zstd:3", "extract.zstd_device")])
def test_cli_device_engine_roundtrip(device_engine, method, phase):
    from zpack_tpu.cli.main import main

    src = device_engine / "src"
    (src / "sub").mkdir(parents=True)
    files = {"big.bin": _mix(300_000, seed=3), "sub/small.txt": _mix(3_000, seed=4),
             "empty": b""}
    for name, blob in files.items():
        (src / name).write_bytes(blob)
    arc = device_engine / "a.zpk"
    dispatch0, dev0 = _calls("mesh.dispatch"), _calls(phase)
    assert main(["c", str(arc), str(src), "-m", method, "--engine", "device"]) == 0
    if method.startswith("lz4"):
        assert _calls("mesh.dispatch") > dispatch0
    assert main(["t", str(arc), "--engine", "device"]) == 0
    out = device_engine / "out"
    assert main(["x", str(arc), "-o", str(out), "--engine", "device"]) == 0
    assert _calls(phase) >= dev0 + 2
    for name, blob in files.items():
        assert (out / "src" / name).read_bytes() == blob


@pytest.mark.parametrize("n,entry_axis,shape", [(1, 1, (1, 1)), (4, 1, (1, 4)),
                                                (4, 2, (2, 2))])
def test_make_mesh_shapes(n, entry_axis, shape):
    from zpack_tpu.parallel.pipeline import make_mesh

    mesh = make_mesh(jax.devices()[:n], entry_axis=entry_axis)
    assert (mesh.shape["entry"], mesh.shape["block"]) == shape


def test_compile_cache_dir_from_environment(monkeypatch, tmp_path):
    from zpack_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX's own to read


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    import zpack_tpu
    from zpack_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(zpack_tpu.__file__)))
    want = os.path.join(checkout, ".jax_cache")
    try:
        assert enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu_backend():
    import chip_smoke

    assert jax.default_backend() == "cpu"
    chip_smoke.require_gpu("gpu")
    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.require_gpu(jax.default_backend())
    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.phase0()
