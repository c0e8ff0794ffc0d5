"""LZ4 codec (method 2): frame format on disk, block codec underneath."""

from __future__ import annotations

from ...constants import CompressionMethod
from .. import Codec, register
from . import block, frame

_MESH_COMPRESSORS: dict[int, object] = {}


@register(CompressionMethod.LZ4)
class LZ4Codec(Codec):
    """ZPack method 2 — LZ4 frame format (docs/specs.md:101).

    compress_bound parity: zpack_get_compress_bound's LZ4F branch
    (lib/zpack_write.c:125-141) — frame header + per-block overhead.
    """

    method = CompressionMethod.LZ4

    def compress(self, data: bytes, level: int = 1) -> bytes:
        import os

        from ...utils.observe import metrics

        with metrics.phase("lz4.compress", len(data)):
            if os.environ.get("ZPACK_TPU_ENGINE") == "device" and len(data) >= (64 << 10):
                # device engine: mesh-parallel tokenization
                from ...parallel.pipeline import MeshCompressor

                mc = _MESH_COMPRESSORS.get(level)
                if mc is None:
                    mc = _MESH_COMPRESSORS[level] = MeshCompressor(level=level)
                return mc.compress(bytes(data))
            if len(data) > (2 << 20):
                # one linked frame per 2 MiB chunk: encode chunks AND
                # decode frames in parallel; the only ratio cost is one
                # 64 KiB window restart per chunk (~0.1% on mixed data)
                from ...parallel import host

                comp = host.lz4f_compress_parallel(bytes(data), level,
                                                   chunk=2 << 20)
                if comp is not None:
                    return comp
            return frame.compress_frame(data, level)

    def decompress(self, data: bytes, uncomp_size: int | None = None) -> bytes:
        import os

        from ...utils.observe import metrics

        with metrics.phase("lz4.decompress", uncomp_size or len(data)):
            if os.environ.get("ZPACK_TPU_ENGINE") == "device":
                if not frame.has_linked_blocks(data):
                    # device engine: batched device sequence replay
                    from ...parallel.extract import decompress_lz4f_batched

                    return decompress_lz4f_batched(bytes(data), uncomp_size)
                # a linked block depends on the previous block's output,
                # so it decodes on the host; counted, never silent
                metrics.count("lz4.decompress.host_linked", len(data))
            if len(data) > (1 << 20):
                # concatenated frames (the chunked encoder's output) decode
                # frame-parallel; returns None for single/foreign frames
                from ...parallel import host

                out = host.lz4f_decompress_parallel(bytes(data), uncomp_size)
                if out is not None:
                    return out
            return frame.decompress_frame(data, uncomp_size)

    def compress_bound(self, size: int) -> int:
        nblocks = max(1, -(-size // frame.DEFAULT_BLOCK_SIZE))
        return 19 + size + 8 * nblocks + 16

    def compressor(self, level: int = 1):
        return frame.FrameCompressor(level)

    def decompressor(self):
        return _LZ4StreamDecompressor()


class _LZ4StreamDecompressor:
    def __init__(self):
        self._d = frame.FrameDecompressor()

    def decompress(self, chunk: bytes, is_final: bool = False) -> tuple[bytes, int]:
        out = self._d.update(chunk)
        return out, len(chunk)

    @property
    def finished(self) -> bool:
        return self._d.finished
