"""Codec registry.

The reference dispatches on ``comp_method`` at every (de)compress site
(e.g. lib/zpack_read.c:352-443, lib/zpack_write.c:161-239).  Here each method
is a :class:`Codec` with one-shot and streaming entry points; the device
paths (JAX kernels) and the host paths share this interface.
"""

from __future__ import annotations

from typing import Callable

from ..constants import CompressionMethod
from ..errors import CompMethodError


class Codec:
    """Interface for one compression method."""

    method: CompressionMethod

    def compress(self, data: bytes, level: int = 0) -> bytes:
        raise NotImplementedError

    def decompress(self, data: bytes, uncomp_size: int | None = None) -> bytes:
        raise NotImplementedError

    def compress_bound(self, size: int) -> int:
        """Worst-case compressed size for ``size`` input bytes
        (parity: zpack_get_compress_bound, lib/zpack_write.c:125-141)."""
        raise NotImplementedError

    # Streaming: return objects with .update(chunk)->bytes and .finish()->bytes /
    # .decompress(chunk)->(out, consumed) — wired up by zpack_tpu.stream.
    def compressor(self, level: int = 0):
        raise NotImplementedError

    def decompressor(self):
        raise NotImplementedError


_REGISTRY: dict[int, Callable[[], Codec]] = {}
_INSTANCES: dict[int, Codec] = {}


def register(method: CompressionMethod):
    def deco(factory: Callable[[], Codec]):
        _REGISTRY[int(method)] = factory
        return factory

    return deco


def _disabled(method: int) -> bool:
    """Runtime analog of the reference's build-time codec gates
    (ZPACK_DISABLE_{ZSTD,LZ4}, reference: CMakeLists.txt:10-21 →
    ZPACK_ERROR_NOT_AVAILABLE paths e.g. lib/zpack_read.c:371,397).
    Checked per call so tests/users can toggle at runtime; the dict lookup
    is the only overhead on the hot path."""
    import os

    name = _GATE_NAMES.get(int(method))
    return name is not None and name in os.environ


_GATE_NAMES = {1: "ZPACK_TPU_DISABLE_ZSTD", 2: "ZPACK_TPU_DISABLE_LZ4"}


def get_codec(method: int) -> Codec:
    if _disabled(method):
        from ..errors import Result, ZPackError

        raise ZPackError(Result.ERROR_NOT_AVAILABLE, f"method {method} disabled in this build")
    try:
        inst = _INSTANCES.get(int(method))
        if inst is None:
            inst = _REGISTRY[int(method)]()
            _INSTANCES[int(method)] = inst
        return inst
    except KeyError:
        raise CompMethodError(method) from None


class StoreCodec(Codec):
    """Method 0 ("none"): raw bytes (parity: the memcpy branches at
    lib/zpack_read.c:352-366 and lib/zpack_write.c:168-175)."""

    method = CompressionMethod.NONE

    def compress(self, data: bytes, level: int = 0) -> bytes:
        return bytes(data)

    def decompress(self, data: bytes, uncomp_size: int | None = None) -> bytes:
        return bytes(data)

    def compress_bound(self, size: int) -> int:
        return size

    def compressor(self, level: int = 0):
        return _StoreStream()

    def decompressor(self):
        return _StoreStream()


class _StoreStream:
    def update(self, chunk: bytes) -> bytes:
        return bytes(chunk)

    def finish(self) -> bytes:
        return b""

    def decompress(self, chunk: bytes, is_final: bool = False) -> tuple[bytes, int]:
        return bytes(chunk), len(chunk)


register(CompressionMethod.NONE)(StoreCodec)


def _register_builtin():
    # Imported lazily to keep the base format layer importable while codec
    # modules are under construction.
    from . import lz4 as _lz4  # noqa: F401
    from . import zstd as _zstd  # noqa: F401


try:
    _register_builtin()
except ImportError:
    pass
