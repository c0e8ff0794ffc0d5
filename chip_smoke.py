#!/usr/bin/env python
"""Run the device engine end to end on one GPU and check every device
kernel against its plain reference at real widths.

    python chip_smoke.py                 # phases 0-3 on one card
    python chip_smoke.py --four-cards    # phase 4 only: the 4-card mesh

Phases:

0. the device: a GPU backend, the card's name and power limit, JAX's
   version, XLA_FLAGS, the compile cache, the native host engine.
1. the main path through the CLI: a >= 64 MiB file tree, ``c``/``t``/``x``
   with ``--engine device`` for lz4:1 and zstd:3, a byte-for-byte compare,
   and non-zero byte counts in every device phase it should reach.
2. each device kernel against its reference, bit-exact, with its
   steady-state time and its compiled memory analysis.
3. the mesh zstd encode with device entropy, decoded on the host and on
   the device.
4. (``--four-cards``) lz4 and zstd mesh encode and mesh zstd decode on a
   4-device mesh, byte-identical to a 1-device mesh in the same process.

Any failed check raises, so the script exits non-zero and prints no
result line.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
MiB = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu(backend: str) -> None:
    """Refuse any backend but a GPU: this script measures nothing on the
    CPU and never carries on there."""
    if backend != "gpu":
        raise RuntimeError(f"chip_smoke needs a GPU backend; JAX's default is {backend!r}")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def steady_seconds(fn, *args, reps: int = 5, **kwargs) -> float:
    """Median wall time of ``fn`` after one warm-up call, each call ended
    by block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def memory_summary(jitted, *args, **kwargs) -> dict:
    """Compiled memory analysis of one jitted call, in bytes."""
    ma = jitted.lower(*args, **kwargs).compile().memory_analysis()
    if ma is None:
        return {}
    return {k: getattr(ma, f"{k}_size_in_bytes") for k in
            ("argument", "output", "temp", "generated_code")
            if hasattr(ma, f"{k}_size_in_bytes")}


@contextlib.contextmanager
def spy(module, name: str):
    """Record the arguments of every call to ``module.name`` while the
    wrappers under test run, so the kernel can be timed alone at the very
    shapes the wrapper built."""
    orig = getattr(module, name)
    calls: list[tuple] = []

    def wrapper(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield orig, calls
    finally:
        setattr(module, name, orig)


def report_kernel(label: str, jitted, call, timed=None, nbytes: int = 0) -> None:
    """Print the steady-state time (and rate over ``nbytes`` input bytes)
    and the compiled memory analysis of one captured kernel call."""
    args, kwargs = call
    secs = steady_seconds(timed or jitted, *args, **kwargs)
    rate = f", {nbytes / secs / 1e9:.4f} GB/s of input" if nbytes else ""
    log(f"  {label}: {secs * 1e3:.3f} ms steady state{rate}; "
        f"memory {memory_summary(jitted, *args, **kwargs)}")


def corpus_bytes(size: int) -> tuple[bytes, dict]:
    sys.path.insert(0, str(REPO / "scripts"))
    import corpus

    return corpus.build(size)


# ---------------------------------------------------------------------------
# phase 0: the device
# ---------------------------------------------------------------------------


def phase0() -> dict:
    import jax

    from zpack_tpu import native
    from zpack_tpu.utils.compile_cache import enable_compile_cache

    require_gpu(jax.default_backend())
    cache = enable_compile_cache()
    devices = jax.devices()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"phase 0: {devices[0].device_kind} x {len(devices)} "
        f"(platform {devices[0].platform})")
    log(f"  jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache {cache}")
    if native.get_lib() is None:
        raise RuntimeError("native host engine did not load")
    log("  native host engine loaded")
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices), "smi": smi}


# ---------------------------------------------------------------------------
# phase 1: the main path through the CLI
# ---------------------------------------------------------------------------


def build_tree(root: pathlib.Path, seed: int, total_min: int = 64 * MiB,
               big: int = 16 * MiB, n_mid: int = 6, n_small: int = 300):
    """A file tree of at least ``total_min`` bytes cut from the corpus
    content mix: one entry of ``big`` bytes or more, ``n_mid`` of 1-4 MiB
    and ``n_small`` under 64 KiB, in a seeded order so each file lands on
    another content class."""
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(MiB, 4 * MiB, n_mid)]
    sizes += [int(s) for s in rng.integers(64, 64 << 10, n_small)]
    sizes.append(max(big, total_min - sum(sizes)))
    order = rng.permutation(len(sizes))
    data, manifest = corpus_bytes(sum(sizes))
    files = {}
    pos = 0
    for k in order:
        name = f"d{k % 7}/f{k:04d}.bin"
        files[name] = data[pos:pos + sizes[k]]
        pos += sizes[k]
    for name, blob in files.items():
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(blob)
    return files, manifest


def run_cli(argv: list[str]) -> float:
    """One in-process CLI command (this process owns the card); returns
    its wall time.  Its per-file listing is kept back unless it fails."""
    from zpack_tpu.cli.main import main as cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    secs = time.perf_counter() - t0
    if rc != 0:
        sys.stdout.write(out.getvalue()[-4000:])
        raise RuntimeError(f"zpack {' '.join(argv)} exited {rc}")
    return secs


#: device phases each step must reach (observe.metrics names)
DEVICE_PHASES = {
    ("lz4:1", "c"): ("mesh.dispatch", "mesh.d2h"),
    ("lz4:1", "t"): ("extract.lz4_device",),
    ("lz4:1", "x"): ("extract.lz4_device",),
    ("zstd:3", "c"): (),  # zstd create stays on the host (ROADMAP R2)
    ("zstd:3", "t"): ("extract.zstd_device",),
    ("zstd:3", "x"): ("extract.zstd_device",),
}
REPORTED = ("mesh.dispatch", "mesh.d2h", "mesh.serialize", "extract.lz4_device",
            "extract.zstd_device", "lz4.decompress.host_linked")


def phase1(work: pathlib.Path, seed: int, **tree_kw) -> None:
    from zpack_tpu.utils.observe import metrics

    src = work / "tree"
    files, manifest = build_tree(src, seed, **tree_kw)
    total = sum(len(b) for b in files.values())
    log(f"phase 1: tree of {len(files)} files, {total} bytes, largest "
        f"{max(len(b) for b in files.values())}; corpus manifest {manifest}")
    for method in ("lz4:1", "zstd:3"):
        arch = work / f"tree_{method.replace(':', '')}.zpk"
        out = work / f"out_{method.replace(':', '')}"
        steps = {
            "c": ["c", str(arch), str(src), "-m", method],
            "t": ["t", str(arch)],
            "x": ["x", str(arch), "-o", str(out)],
        }
        for step, argv in steps.items():
            metrics.reset()
            secs = run_cli(argv + ["--engine", "device"])
            snap = metrics.snapshot()
            asize = arch.stat().st_size
            log(f"  {method} {step}: {secs:.3f} s, {total} bytes, "
                f"{total / secs / 1e6:.2f} MB/s, archive {asize} bytes, "
                f"ratio {total / asize:.4f}")
            for name in REPORTED:
                if name in snap:
                    log(f"    {name}: {snap[name]['bytes']} bytes in "
                        f"{snap[name]['calls']} calls, {snap[name]['seconds']} s")
            for name in DEVICE_PHASES[(method, step)]:
                if snap.get(name, {}).get("bytes", 0) <= 0:
                    raise RuntimeError(f"{method} {step}: device phase {name} "
                                       "handled no bytes")
        for name, blob in files.items():
            got = (out / "tree" / name).read_bytes()
            if got != blob:
                raise RuntimeError(f"{method}: {name} differs after x")
        log(f"  {method}: all {len(files)} files identical after x")


# ---------------------------------------------------------------------------
# phase 2: kernels against their references
# ---------------------------------------------------------------------------


def check_tokenizer(data: bytes) -> None:
    """One full mesh step (16 x 64 KiB blocks) against the numpy
    statement of the same match search; every block's serialized LZ4
    block must also decode to its input."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from zpack_tpu.codecs.lz4 import block as lz4block
    from zpack_tpu.codecs.match import sorted_chain_matches
    from zpack_tpu.kernels import lz4_jax
    from zpack_tpu.parallel import pipeline

    B = pipeline.BLOCK
    nb = pipeline.MeshCompressor.BYTES_PER_DEVICE_STEP // B
    mesh = pipeline.make_mesh(jax.devices()[:1])
    step, mode = pipeline._step_fn(mesh, 2, B, pipeline.MeshCompressor.N_WORDS)
    if mode != "pair":
        raise RuntimeError(f"64 KiB blocks should tokenize in pair mode, not {mode}")
    blocks = np.frombuffer(data[: nb * B], np.uint8).reshape(1, nb, B)
    batch = jax.device_put(blocks, NamedSharding(mesh, P("entry", "block", None)))
    src16, code, _est = step(batch)
    src, mlen = lz4_jax.unpack_resort_host(np.asarray(src16).reshape(nb, B),
                                           np.asarray(code).reshape(nb, B))
    for i in range(nb):
        want_src, want_mlen = sorted_chain_matches(blocks[0, i], 2, 2)
        if not (np.array_equal(mlen[i], want_mlen) and np.array_equal(src[i], want_src)):
            raise RuntimeError(f"tokenizer block {i} differs from the reference")
        chunk = blocks[0, i].tobytes()
        comp = lz4_jax.serialize_block_host(chunk, src[i], mlen[i], 4 * 2)
        if lz4block.decompress_block(comp, B) != chunk:
            raise RuntimeError(f"tokenizer block {i} does not round-trip")
    report_kernel(f"lz4 tokenizer step ({nb}x{B})", step, ((batch,), {}),
                  nbytes=nb * B)


def _huff_tables(arr):
    from zpack_tpu.codecs.zstd import huffman as H

    et = H.build_encode_table(np.bincount(arr, minlength=256))
    if et is None:
        return None, None
    total = sum(1 << (w - 1) for w in et.weights if w > 0)
    np2 = 1 << total.bit_length()
    return et, H.build_decode_table(et.weights + [(np2 - total).bit_length()])


def check_huffman(data: bytes, S: int = 256, L: int = 16384) -> None:
    from zpack_tpu.codecs.zstd import huffman as H
    from zpack_tpu.kernels import huffman_jax as HJ

    streams, ets, dts = [], [], []
    stride = max(L, (len(data) * 3 // 4) // S)
    off = 0
    while len(streams) < S:
        arr = np.frombuffer(data[off:off + L], np.uint8)
        off = (off + stride) % (len(data) - L)
        et, dt = _huff_tables(arr)
        if et is not None:
            streams.append(arr)
            ets.append(et)
            dts.append(dt)
    with spy(HJ, "encode_streams") as (enc_fn, enc_calls):
        got = HJ.DeviceHuffmanEncoder().encode_batch(streams, ets)
    want = [H._encode_stream(s, et) for s, et in zip(streams, ets)]
    if got != want:
        raise RuntimeError("huffman encode differs from codecs/zstd/huffman.py")
    with spy(HJ, "decode_streams_scan") as (dec_fn, dec_calls):
        dec = HJ.DeviceHuffmanDecoder().decode_batch(want, dts, [L] * S)
    for i, (o, s) in enumerate(zip(dec, streams)):
        ref = np.frombuffer(H.decode_1stream(want[i], dts[i], L), np.uint8)
        if not (np.array_equal(o, s) and np.array_equal(ref, s)):
            raise RuntimeError(f"huffman decode of stream {i} differs")
    report_kernel(f"huffman encode ({S}x{L})", enc_fn, enc_calls[0], nbytes=S * L)
    report_kernel(f"huffman decode ({S}x{L})", dec_fn, dec_calls[0], nbytes=S * L)


def _zstd_blocks(comp: bytes):
    """Yield every compressed block's (payload, literals end) of the
    concatenated zstd frames in ``comp``, with the per-frame literal and
    sequence-table state threaded like a decoder."""
    from zpack_tpu.codecs.zstd import frame as ZF, seq as ZS

    pos = 0
    while pos < len(comp):
        pos += 4
        header = ZF.parse_frame_header(comp, pos)
        pos += header.header_size
        lit_state = ZF.LiteralsState()
        tables, tables_dev = ZS.SequenceTables(), ZS.SequenceTables()
        while True:
            bh = comp[pos] | (comp[pos + 1] << 8) | (comp[pos + 2] << 16)
            pos += 3
            last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
            payload = comp[pos:pos + (1 if btype == ZF.BLOCK_RLE else bsize)]
            pos += len(payload)
            if btype == ZF.BLOCK_COMPRESSED:
                _, lits_end = ZF.parse_literals_section(payload, 0, lit_state)
                yield payload, lits_end, tables, tables_dev
            if last:
                break
        pos += 4 if header.has_checksum else 0


def check_fse(data: bytes) -> None:
    """Sequence sections of real zstd:3 blocks: device FSE decode against
    seq.decode_sequences, then device FSE encode of the same sequences
    against seq.encode_sequences."""
    from zpack_tpu import native
    from zpack_tpu.codecs.zstd import encode as zenc, seq as ZS
    from zpack_tpu.kernels import fse_jax as FJ

    comp = native.zstd_compress(data, 3)
    dsd = FJ.DeviceSequenceDecoder()
    items, wants = [], []
    for payload, lits_end, tables, tables_dev in _zstd_blocks(comp):
        want = ZS.decode_sequences(payload, lits_end, tables)[:3]
        nb, bs = dsd.parse_headers(payload, lits_end, tables_dev)
        if nb:
            items.append((bs, tables_dev.ll, tables_dev.of, tables_dev.ml, nb))
            wants.append(want)
    with spy(FJ, "decode_seq_streams") as (dec_fn, dec_calls):
        lls, mls, ovs = dsd.decode_batch(items)
    for i, w in enumerate(wants):
        if not (np.array_equal(lls[i], w[0]) and np.array_equal(mls[i], w[1])
                and np.array_equal(ovs[i], w[2])):
            raise RuntimeError(f"FSE decode of block {i} differs from seq.py")
    n_seq = sum(len(w[0]) for w in wants)
    blocks, tabs, want_streams = [], [], []
    for w in wants:
        lc = FJ.ll_codes_np(w[0]).tolist()
        mc = FJ.ml_codes_np(w[1]).tolist()
        oc = FJ.of_codes_np(w[2]).tolist()
        _, ll_t, _ = zenc._pick_table(lc, "ll", ZS.LL_CODE_MAX, ZS.LL_MAX_AL)
        _, of_t, _ = zenc._pick_table(oc, "of", ZS.OF_CODE_MAX, ZS.OF_MAX_AL)
        _, ml_t, _ = zenc._pick_table(mc, "ml", ZS.ML_CODE_MAX, ZS.ML_MAX_AL)
        blocks.append(w)
        tabs.append((ll_t, of_t, ml_t))
        want_streams.append(ZS.encode_sequences(*w, ll_t, of_t, ml_t))
    with spy(FJ, "encode_seq_streams") as (enc_fn, enc_calls):
        got = FJ.DeviceSequenceEncoder().encode_batch(blocks, tabs)
    if got != want_streams:
        raise RuntimeError("FSE encode differs from seq.encode_sequences")
    log(f"  FSE: {len(blocks)} blocks, {n_seq} sequences of {len(data)} bytes")
    report_kernel(f"FSE decode ({len(blocks)} blocks)", dec_fn, dec_calls[0])
    report_kernel(f"FSE encode ({len(blocks)} blocks)", enc_fn, enc_calls[0])


def check_lz4_replay(data: bytes) -> None:
    from zpack_tpu.codecs.lz4 import block as lz4block
    from zpack_tpu.kernels import lz4_jax

    B = 64 << 10
    chunks = [data[i:i + B] for i in range(0, len(data), B)]
    comp = [lz4block.compress_block(c) for c in chunks]
    with spy(lz4_jax, "replay_sequences") as (replay, calls):
        got = lz4_jax.DeviceLZ4Replayer().decompress_blocks(comp, [B] * len(comp))
    for i, (g, c) in enumerate(zip(got, comp)):
        if g != chunks[i] or lz4block.decompress_block(c, B) != chunks[i]:
            raise RuntimeError(f"lz4 replay of block {i} differs")
    report_kernel(f"lz4 replay ({len(comp)}x{B})", lz4_jax._replay_build, calls[0],
                  timed=replay, nbytes=len(data))


def check_xxh3(data: bytes) -> None:
    from zpack_tpu import native
    from zpack_tpu.codecs import xxh3
    from zpack_tpu.kernels import xxh3_jax

    with spy(xxh3_jax, "_accumulate") as (acc, calls):
        got = xxh3_jax.xxh3_64_jax(data)
    want = xxh3._hash_long(data, xxh3.KSECRET)
    if got != want or native.xxh3_64(data) != want:
        raise RuntimeError("xxh3_jax differs from codecs/xxh3.py")
    report_kernel(f"xxh3 ({len(data)} bytes)", acc, calls[0], nbytes=len(data))


def phase2(data: bytes, fse_bytes: int = 16 * MiB, replay_bytes: int = 16 * MiB) -> None:
    log("phase 2: kernels against their references, bit-exact")
    check_tokenizer(data)
    check_huffman(data)
    check_fse(data[:fse_bytes])
    check_lz4_replay(data[:replay_bytes])
    check_xxh3(data)


# ---------------------------------------------------------------------------
# phase 3: mesh zstd encode with device entropy
# ---------------------------------------------------------------------------


def phase3(data: bytes) -> None:
    import jax

    from zpack_tpu.codecs.zstd import frame as ZF
    from zpack_tpu.parallel.extract import decompress_zstd_device
    from zpack_tpu.parallel.pipeline import MeshCompressor, make_mesh

    mc = MeshCompressor(make_mesh(jax.devices()[:1]))
    t0 = time.perf_counter()
    comp = mc.compress_zstd(data, 3, device_entropy=True)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = ZF.decompress(comp, len(data))
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = decompress_zstd_device(comp, len(data))
    dev_s = time.perf_counter() - t0
    if host != data or dev != data:
        raise RuntimeError("mesh zstd frame does not round-trip")
    log(f"phase 3: mesh zstd:3 encode {enc_s:.3f} s for {len(data)} bytes "
        f"(ratio {len(data) / len(comp):.4f}); host decode {host_s:.3f} s, "
        f"device decode {dev_s:.3f} s; both identical")


# ---------------------------------------------------------------------------
# phase 4: four cards
# ---------------------------------------------------------------------------


def phase4(data: bytes, zstd_bytes: int = 16 * MiB, n: int = 4) -> None:
    import jax

    from zpack_tpu.codecs.lz4 import frame as LF
    from zpack_tpu.codecs.zstd import frame as ZF
    from zpack_tpu.parallel.extract import decompress_zstd_device
    from zpack_tpu.parallel.pipeline import MeshCompressor, make_mesh

    devices = jax.devices()
    if len(devices) < n:
        raise RuntimeError(f"--four-cards needs {n} devices, JAX has {len(devices)}")
    mesh_n, mesh_1 = make_mesh(devices[:n]), make_mesh(devices[:1])
    log(f"phase 4: mesh {dict(mesh_n.shape)} against {dict(mesh_1.shape)}")
    outs = {}
    for label, mesh in (("1", mesh_1), (str(n), mesh_n)):
        mc = MeshCompressor(mesh)
        t0 = time.perf_counter()
        lz4 = mc.compress(data)
        lz4_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        zst = mc.compress_zstd(data[:zstd_bytes], 3)
        zst_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = decompress_zstd_device(zst, zstd_bytes, mesh=mesh)
        dec_s = time.perf_counter() - t0
        outs[label] = (lz4, zst, back)
        log(f"  {label} device(s): lz4 {lz4_s:.3f} s ({len(data)} bytes), "
            f"zstd {zst_s:.3f} s, device zstd decode {dec_s:.3f} s "
            f"({zstd_bytes} bytes)")
    lz4, zst, back = outs[str(n)]
    if (lz4, zst) != outs["1"][:2]:
        raise RuntimeError(f"{n}-device mesh output differs from 1 device")
    if back != data[:zstd_bytes] or outs["1"][2] != back:
        raise RuntimeError("mesh zstd decode differs")
    if LF.decompress_frame(lz4) != data or ZF.decompress(zst) != data[:zstd_bytes]:
        raise RuntimeError("mesh frames do not round-trip")
    log(f"  {n}-device output byte-identical to 1 device; all round trips ok")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only phase 4, on a 4-device mesh")
    ap.add_argument("--seed", type=int, default=0, help="tree layout seed")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))

    t_start = time.perf_counter()
    dev = phase0()
    if args.four_cards:
        data, _ = corpus_bytes(64 * MiB)
        phase4(data)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
            phase1(pathlib.Path(td), args.seed)
        data, _ = corpus_bytes(64 * MiB)
        phase2(data)
        phase3(data)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
