"""Test config: force JAX onto a virtual 8-device CPU mesh so multi-device
sharding tests run anywhere (chip_smoke.py runs the device path on a GPU)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# the tests select the CPU themselves, whatever JAX_PLATFORMS says
import jax

jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

REFERENCE_WORKDIR = pathlib.Path("/root/reference/tests/workdir")


@pytest.fixture(scope="session")
def golden():
    """Golden fixture archives + plaintexts from the reference test suite
    (reference: tests/workdir/*, embedded byte-for-byte in tests/archive.h)."""
    if not REFERENCE_WORKDIR.exists():
        pytest.skip("reference fixtures not available")
    d = {}
    for name in ["archive_none.zpk", "archive_zstd.zpk", "archive_lz4.zpk", "file1.txt", "file2.txt"]:
        d[name] = (REFERENCE_WORKDIR / name).read_bytes()
    return d
