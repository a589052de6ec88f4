"""The port's Zstandard decoder (csrc/zstd_decode.c through
ops/kernels/zstd.py, built with the host compiler) against the
`zstandard` package: every frame decodes to zstandard's bytes exactly,
every truncated frame raises, every corrupt one raises or gives what
zstandard gives, and a bad content checksum raises.

The data runs from empty to 4 MB, from random bytes to float32 weights,
text, runs and zeros, over compression levels -5 to 19, with and without
the checksum and the content size; the frames between them take every
block type (raw, RLE, compressed), every literals type (raw, RLE,
Huffman in one or four streams, treeless) and every sequence table mode
(predefined, RLE, FSE, repeat). Tolerance: none (bytes).
"""
import numpy as np
import pytest
import zstandard

from unet_watermark_tpu_torch.ops.kernels import zstd

LEVELS = (-5, -1, 1, 3, 9, 19)


def _data(kind: str, size: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    if kind == "weights":  # trained-weight-like float32 values
        return (rng.standard_normal(size // 4) * 0.02).astype(
            np.float32).tobytes()
    if kind == "text":
        words = [b"mask", b"repair", b"kernel", b"the", b"watermark",
                 b"image", b"\n", b"of", b"a"]
        idx = rng.integers(0, len(words), size // 4 + 1)
        return b" ".join(words[i] for i in idx)[:size]
    if kind == "runs":  # long runs of few values: RLE blocks and literals
        vals = rng.integers(0, 4, size // 1000 + 1, dtype=np.uint8)
        return np.repeat(vals, 1000)[:size].tobytes()
    if kind == "zeros":
        return bytes(size)
    if kind == "ints":  # int32 counters: long matches, repeat offsets
        return np.arange(size // 4, dtype=np.int32).tobytes()
    if kind == "chunks":  # 12-byte chunks, then picks of them after an
        # "x": past the first block every literal is an "x" (RLE literals)
        chunks = [rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
                  for _ in range(2000)]
        picks = rng.integers(0, 2000, size // 13 + 1)
        return (b"".join(chunks) + b"".join(
            b"x" + chunks[i] for i in picks))[:size]
    raise ValueError(kind)


KINDS = ("random", "weights", "text", "runs", "zeros", "ints", "chunks")


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", KINDS)
def test_frames_match_zstandard(kind, level):
    """Sizes 0 B to 256 KB (more than one 128 KB block) at each level, the
    checksum and the content size on and off."""
    for i, size in enumerate((0, 1, 37, 4096, 70000, 262144)):
        data = _data(kind, size, seed=i)
        for checksum, content in ((True, True), (False, False)):
            frame = zstandard.ZstdCompressor(
                level=level, write_checksum=checksum,
                write_content_size=content).compress(data)
            assert zstd.decompress(frame) == data, (kind, level, size)


@pytest.mark.parametrize("kind", ("weights", "text", "random"))
def test_four_megabytes(kind):
    """4 MB at levels 1 and 3 (a window larger than a block), decoded
    straight into an array of the content's size."""
    data = _data(kind, 4 << 20, seed=7)
    for level in (1, 3):
        frame = zstandard.ZstdCompressor(level=level).compress(data)
        out = np.empty(len(data), np.uint8)
        zstd.decompress_into(frame, out)
        assert out.tobytes() == data
    assert zstd.content_size(frame) == len(data)


def test_window_and_block_parameters():
    """Frames with small windows and small blocks (many blocks, matches
    reaching back across them), long-distance matching and the
    single-segment form."""
    data = _data("text", 600000, seed=3) + _data("ints", 200000)
    for params in (
            dict(window_log=10, chain_log=8, hash_log=8, search_log=2,
                 min_match=3, target_length=0, strategy=zstandard.STRATEGY_FAST),
            dict(window_log=17, strategy=zstandard.STRATEGY_BTULTRA2),
            dict(window_log=20, enable_ldm=True),
            dict(window_log=27, strategy=zstandard.STRATEGY_LAZY2)):
        cp = zstandard.ZstdCompressionParameters.from_level(5, **params)
        frame = zstandard.ZstdCompressor(compression_params=cp).compress(data)
        assert zstd.decompress(frame) == data, params
    small = _data("text", 300)
    frame = zstandard.ZstdCompressor(level=3).compress(small)
    assert frame[4] & 0x20  # single segment: no window descriptor
    assert zstd.decompress(frame) == small


def test_streamed_frames_and_several_frames():
    """A frame written by the streaming API (no content size, blocks as
    the chunks came), several frames one after another, and a skippable
    frame between them: the contents concatenated."""
    parts = [_data(k, 50000, seed=i) for i, k in enumerate(KINDS)]
    cctx = zstandard.ZstdCompressor(level=3)
    chunker = cctx.chunker(chunk_size=8192)
    streamed = b"".join(b"".join(chunker.compress(p)) for p in parts)
    streamed += b"".join(chunker.finish())
    assert zstd.content_size(streamed) is None
    assert zstd.decompress(streamed) == b"".join(parts)
    frames = [zstandard.ZstdCompressor(level=i).compress(p)
              for i, p in enumerate(parts, 1)]
    skip = (0x184D2A5B).to_bytes(4, "little") + (5).to_bytes(4, "little")
    joined = frames[0] + skip + b"12345" + b"".join(frames[1:])
    assert zstd.decompress(joined) == b"".join(parts)
    assert zstd.content_size(joined) == sum(map(len, parts))


def test_truncated_frames_raise():
    """Every prefix of a frame raises: none reads past its end."""
    for kind, level in (("text", 19), ("weights", 3), ("runs", 1)):
        frame = zstandard.ZstdCompressor(level=level, write_checksum=True
                                         ).compress(_data(kind, 20000))
        for cut in range(len(frame)):
            with pytest.raises(zstd.ZstdError):
                zstd.decompress(frame[:cut])


def test_checksum_mismatch_raises():
    data = _data("text", 10000)
    frame = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(data))
    frame[-1] ^= 0x40
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))


@pytest.mark.parametrize("level", (1, 19))
def test_corrupt_frames_raise_or_agree(level):
    """One bit flipped anywhere: with the checksum the frame raises; without
    it the decoder raises exactly where zstandard raises and otherwise
    gives zstandard's bytes."""
    rng = np.random.default_rng(level)
    data = _data("text", 30000) + _data("random", 3000)
    dctx = zstandard.ZstdDecompressor()
    for checksum in (True, False):
        frame = zstandard.ZstdCompressor(
            level=level, write_checksum=checksum).compress(data)
        for _ in range(300):
            bad = bytearray(frame)
            pos = int(rng.integers(0, len(bad)))
            bad[pos] ^= 1 << int(rng.integers(0, 8))
            bad = bytes(bad)
            try:
                ours = zstd.decompress(bad)
            except zstd.ZstdError:
                ours = None
            try:
                ref = dctx.decompress(bad, max_output_size=1 << 22)
            except zstandard.ZstdError:
                ref = None
            if checksum and ours is not None:
                assert ours == data, pos  # a flip the frame cannot see
            else:
                assert ours == ref, pos


def test_not_a_frame_raises():
    for blob in (b"", b"\x00\x01\x02\x03\x04", b"PK\x03\x04" + bytes(20)):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(blob)
    frame = zstandard.ZstdCompressor(level=3).compress(b"abc" * 100)
    with pytest.raises(zstd.ZstdError):  # too small an output array
        zstd.decompress_into(frame, np.empty(10, np.uint8))


def test_crc32c_known_values():
    """CRC-32C's check value (RFC 3720), and OCDBT's own file trailer."""
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0


def _kinds(frame: bytes) -> set:
    """What a frame's blocks take: ("block", type), ("literals", type),
    ("streams", 1 or 4) for Huffman literals, ("mode", table mode) of
    each sequence table."""
    out = set()
    fd = frame[4]
    single, fcs_flag, did = (fd >> 5) & 1, fd >> 6, fd & 3
    at = 5 + (not single) + (0, 1, 2, 4)[did] + (single, 2, 4, 8)[fcs_flag]
    while True:
        bh = int.from_bytes(frame[at:at + 3], "little")
        at += 3
        last, btype, size = bh & 1, (bh >> 1) & 3, bh >> 3
        out.add(("block", btype))
        if btype == 2:
            c = frame[at:at + size]
            lt, sf = c[0] & 3, (c[0] >> 2) & 3
            out.add(("literals", lt))
            if lt < 2:
                hs = {0: 1, 2: 1, 1: 2, 3: 3}[sf]
                v = int.from_bytes(c[:hs], "little")
                regen = v >> 3 if hs == 1 else v >> 4
                ls = hs + (regen if lt == 0 else 1)
            else:
                out.add(("streams", 1 if sf == 0 else 4))
                hs = 3 if sf < 2 else 4 if sf == 2 else 5
                v = int.from_bytes(c[:hs], "little")
                ls = hs + {3: (v >> 14) & 0x3FF, 4: v >> 18,
                           5: (v >> 22) & 0x3FFFF}[hs]
            n = c[ls]
            if n:
                modes = c[ls + (1 if n < 128 else 2 if n < 255 else 3)]
                out |= {("mode", (modes >> s) & 3) for s in (6, 4, 2)}
        at += 1 if btype == 1 else size
        if last:
            return out


def test_every_path_is_taken():
    """The frames of test_frames_match_zstandard (level 19 and the fast
    levels) between them hold every block type, every literals type, one
    and four Huffman streams and every sequence table mode."""
    seen = set()
    for kind in KINDS:
        for level in LEVELS:
            for i, size in enumerate((37, 4096, 70000, 262144)):
                seen |= _kinds(zstandard.ZstdCompressor(level=level).compress(
                    _data(kind, size, seed=i)))
    want = ({("block", t) for t in (0, 1, 2)}
            | {("literals", t) for t in range(4)}
            | {("streams", 1), ("streams", 4)}
            | {("mode", m) for m in range(4)})
    assert want <= seen, want - seen
