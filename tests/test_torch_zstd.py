"""The port's Zstandard decoder (``music2midi_tpu_torch/zstd.py`` over
``csrc/zstd_decode.cpp``) against the ``zstandard`` package.

  * round trips of frames ``zstandard`` writes at levels -5, 1, 3 and 19,
    with and without the content checksum and the content size, over
    random, repetitive, float32 and text payloads;
  * the empty input, frames of raw and of RLE blocks, and compressed
    blocks of RLE literals and of 32600 sequences (written by hand),
    treeless literals, inputs over one block (128 KiB) and over the
    window, several frames and skippable frames back to back;
  * a hypothesis property over random and repetitive bytes;
  * truncated, bit-flipped and checksum-broken frames, a frame naming a
    dictionary and a stream that is not zstd raise ``ValueError`` with
    the byte offset;
  * CRC32C and XXH64 at their published check values.
"""

import struct

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from music2midi_tpu_torch import zstd

MAGIC = struct.pack("<I", 0xFD2FB528)


def _payloads():
    rng = np.random.default_rng(0)
    return {
        "random": rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
        "repetitive": b"the quick brown fox " * 700 + bytes(300),
        "float32": (rng.normal(size=6000) * 0.02).astype(np.float32).tobytes(),
        "small_alphabet": rng.integers(0, 5, 40000, dtype=np.uint8).tobytes(),
        "text": " ".join(str(i * i) for i in range(4000)).encode(),
        "short_text": bytes(np.frombuffer(b"etaoinshrdlucmfw", np.uint8)[
            rng.integers(0, 16, 200)]),  # one Huffman stream
    }


PAYLOADS = _payloads()


@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("level", [-5, 1, 3, 19])
def test_round_trip_matches_zstandard(level, checksum, content_size):
    cctx = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size)
    for name, data in PAYLOADS.items():
        assert zstd.decompress(cctx.compress(data)) == data, name


def _block(kind: int, size: int, last: bool) -> bytes:
    return (int(last) | kind << 1 | size << 3).to_bytes(3, "little")


def test_empty_raw_and_rle_frames():
    assert zstd.decompress(zstandard.ZstdCompressor().compress(b"")) == b""
    # single segment, 1-byte content size: a raw block, then an RLE block
    frame = (MAGIC + bytes([0x20, 9]) + _block(0, 4, False) + b"abcd"
             + _block(1, 5, True) + b"z")
    assert zstd.decompress(frame) == b"abcdzzzzz"
    # window descriptor, no content size, checksum: RLE over 3 blocks
    body = _block(1, 100_000, False) + b"q" + _block(1, 100_000, False) \
        + b"r" + _block(0, 0, True)
    want = b"q" * 100_000 + b"r" * 100_000
    check = struct.pack("<I", zstd.xxh64(want) & 0xFFFFFFFF)
    frame = MAGIC + bytes([0x04, 0x58]) + body + check
    assert zstd.decompress(frame) == want
    with pytest.raises(ValueError, match="checksum mismatch"):
        zstd.decompress(frame[:-1] + bytes([frame[-1] ^ 1]))


def test_hand_built_compressed_blocks():
    # RLE literals and no sequences
    frame = (MAGIC + bytes([0x20, 20]) + _block(2, 3, True)
             + bytes([1 | 20 << 3]) + b"k" + b"\x00")
    assert zstd.decompress(frame) == b"k" * 20
    # 32600 sequences (the 3-byte count): raw literals, RLE tables (one
    # literal, a 3-byte match at repeat offset 1), no bits but the end mark
    n = 32600
    lits = bytes(np.random.default_rng(2).integers(0, 256, n, np.uint8))
    body = (bytes([3 << 2 | (n & 15) << 4, (n >> 4) & 255, n >> 12]) + lits
            + bytes([255]) + (n - 0x7F00).to_bytes(2, "little")
            + bytes([1 << 6 | 1 << 4 | 1 << 2, 1, 0, 0, 1]))
    frame = (MAGIC + bytes([0xA0]) + (4 * n).to_bytes(4, "little")
             + _block(2, len(body), True) + body)
    assert zstd.decompress(frame) == bytes(np.repeat(
        np.frombuffer(lits, np.uint8), 4))


def test_over_a_block_and_over_the_window():
    # 4 blocks of literals with one distribution: the later blocks reuse
    # the first one's Huffman table (treeless literals)
    letters = np.frombuffer(b"etaoinshrdlucmfw", np.uint8)
    data = bytes(letters[np.random.default_rng(3).integers(0, 16, 500_000)])
    assert zstd.decompress(zstandard.ZstdCompressor(level=3).compress(
        data)) == data
    rng = np.random.default_rng(1)
    motif = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    data = b"".join(motif[i % 7:] + bytes([i % 251]) * (i % 13)
                    for i in range(300))  # ~900 KB, long-range repeats
    assert len(data) > 6 * 128 * 1024
    small = zstandard.ZstdCompressionParameters.from_level(
        19, window_log=10)  # a 1 KiB window
    for cctx in (zstandard.ZstdCompressor(level=3),
                 zstandard.ZstdCompressor(compression_params=small),
                 zstandard.ZstdCompressor(level=19, write_content_size=False)):
        assert zstd.decompress(cctx.compress(data)) == data


def test_several_frames_and_skippable_frames():
    parts = [b"first" * 300, b"", bytes(range(256)) * 40, b"last"]
    cctx = zstandard.ZstdCompressor(level=3, write_checksum=True)
    skip = struct.pack("<II", 0x184D2A5E, 6) + b"ignore"
    stream = skip + b"".join(cctx.compress(p) + skip for p in parts)
    assert zstd.decompress(stream) == b"".join(parts)
    assert zstd.decompress(skip) == b""


@settings(max_examples=60, deadline=None)
@given(data=st.one_of(
    st.binary(max_size=3000),
    st.tuples(st.binary(min_size=1, max_size=40),
              st.integers(1, 400)).map(lambda t: t[0] * t[1])),
    level=st.sampled_from([-5, 1, 3, 19]),
    checksum=st.booleans())
def test_random_and_repetitive_bytes(data, level, checksum):
    c = zstandard.ZstdCompressor(level=level,
                                 write_checksum=checksum).compress(data)
    assert zstd.decompress(c) == data


def _frame() -> bytes:
    return zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        PAYLOADS["text"][:2000] + PAYLOADS["random"][:300])


def test_truncated_frames_raise():
    frame = _frame()
    for n in range(len(frame)):
        with pytest.raises(ValueError, match=r"zstd: .* at byte \d+"):
            zstd.decompress(frame[:n])


def test_bit_flips_raise():
    """A flipped bit raises, unless it lies in bits the format leaves
    unread (padding of a table description): then the frame still decodes
    to the original, checksum and all, in ``zstandard`` too."""
    frame = _frame()
    want = zstandard.decompress(frame)
    ignored = []
    for i in range(len(frame)):
        for bit in (0, 3, 7):
            bad = bytearray(frame)
            bad[i] ^= 1 << bit
            try:
                got = zstd.decompress(bytes(bad))
            except ValueError as e:
                assert str(e).startswith("zstd: "), e
                continue
            assert got == want == zstandard.decompress(bytes(bad)), (i, bit)
            ignored.append((i, bit))
    assert len(ignored) <= 0.01 * 3 * len(frame), ignored


def test_dictionary_and_foreign_streams_raise():
    # frame header: dictionary id field of one byte, naming dictionary 7
    frame = MAGIC + bytes([0x21, 7, 4]) + _block(0, 4, True) + b"abcd"
    with pytest.raises(ValueError, match="dictionary at byte 5"):
        zstd.decompress(frame)
    with pytest.raises(ValueError, match="bad magic at byte 0"):
        zstd.decompress(b"PK\x03\x04 not zstd")
    with pytest.raises(ValueError, match="no frame"):
        zstd.decompress(b"")
    good = zstandard.ZstdCompressor().compress(b"x" * 100)
    with pytest.raises(ValueError, match=f"bad magic at byte {len(good)}"):
        zstd.decompress(good + b"junk")


def test_crc32c_and_xxh64_check_values():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    data = PAYLOADS["random"]
    frame = zstandard.ZstdCompressor(write_checksum=True).compress(data)
    assert frame[-4:] == struct.pack("<I", zstd.xxh64(data) & 0xFFFFFFFF)
