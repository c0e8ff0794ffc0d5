"""zpack-tpu: an archiver/compression framework with the capabilities of
LeadRDRK/ZPack, built from scratch on JAX/XLA with a native C++ host
engine; its device engine runs on JAX's default accelerator.

Public API mirrors the reference's object model (lib/zpack.h): Reader,
Writer, ZPackStream, CompressionMethod, plus the self-contained codecs
(store / LZ4 frame / zstd) and XXH3-64 hashing.
"""

from .constants import ARCHIVE_VERSION, CompressionMethod
from .errors import Result, ZPackError
from .format.records import FileEntry
from .reader import Reader
from .stream import ZPackStream, init_stream, read_file_stream, read_stream_done
from .writer import CompressOptions, Writer, write_archive_to_bytes

__version__ = "0.1.0"

__all__ = [
    "ARCHIVE_VERSION",
    "CompressionMethod",
    "CompressOptions",
    "FileEntry",
    "Reader",
    "Result",
    "Writer",
    "ZPackError",
    "ZPackStream",
    "init_stream",
    "read_file_stream",
    "read_stream_done",
    "write_archive_to_bytes",
    "__version__",
]
