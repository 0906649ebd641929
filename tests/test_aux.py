"""Auxiliary subsystems (SURVEY.md §5): failure detection, resume,
config, observability."""

import io

import numpy as np
import pytest

import alacnet_tpu
from alacnet_tpu.batch import DecodeCursor, decode_resumable, decode_streams
from alacnet_tpu.config import DecodeConfig
from alacnet_tpu.container import demux
from alacnet_tpu.errors import UnsupportedFormatError
from alacnet_tpu.utils.observability import GLOBAL_STATS, trace_span

from .corpus import encode_to_bytes, tone


def _corrupt_frame_header(data: bytes, frame: int) -> bytes:
    """Set an unsupported prediction type in one frame's header."""
    info = demux.parse(io.BytesIO(data))
    off = int(info.tables.frame_file_offsets()[frame])
    blob = bytearray(data)
    # Full frame (hassize=0): ptype A at bits 39-42 (test_device_parity).
    blob[off + 4] |= 0b0000_0001
    blob[off + 5] |= 0b1110_0000
    return bytes(blob)


class TestFailureDetection:
    def test_strict_mode_raises(self):
        pcm = tone(4096 * 3, 2, 16)
        data = _corrupt_frame_header(encode_to_bytes(pcm, 44100, 16), 1)
        with pytest.raises(UnsupportedFormatError):
            decode_streams([io.BytesIO(data)], strict=True)

    def test_lenient_mode_poisons_only_bad_lane(self):
        """A malformed frame drops out; every other frame stays bit-exact
        (SURVEY.md §5: per-frame validity mask)."""
        pcm = tone(4096 * 3, 2, 16)
        data = _corrupt_frame_header(encode_to_bytes(pcm, 44100, 16), 1)
        (res,) = decode_streams([io.BytesIO(data)], strict=False)
        np.testing.assert_array_equal(res.bad_frames, [1])
        good = np.concatenate([pcm[:4096], pcm[8192:]])
        np.testing.assert_array_equal(res.pcm, good)

    def test_truncated_mdat_does_not_crash(self):
        """Truncated payloads decode to bounded garbage, no exception."""
        pcm = tone(4096 * 2, 2, 16)
        data = encode_to_bytes(pcm, 44100, 16)
        info = demux.parse(io.BytesIO(data))
        cut = int(info.tables.frame_file_offsets()[-1]) + 10
        (res,) = decode_streams([io.BytesIO(data[:cut])], strict=False)
        # first frame still bit-exact
        np.testing.assert_array_equal(res.pcm[:4096], pcm[:4096])


class TestResume:
    def test_cursor_roundtrip(self, tmp_path):
        pcm = tone(4096 * 3 + 123, 2, 16)
        path = tmp_path / "r.m4a"
        path.write_bytes(encode_to_bytes(pcm, 44100, 16))
        cursor = DecodeCursor(str(path))
        chunks = []
        while not cursor.done:
            part, cursor = decode_resumable(cursor, max_frames=2)
            chunks.append(part.pcm)
        got = np.concatenate(chunks)
        np.testing.assert_array_equal(got, pcm)


class TestConfig:
    def test_defaults_and_validation(self):
        cfg = DecodeConfig()
        assert cfg.validate() is cfg
        with pytest.raises(ValueError):
            DecodeConfig(kernel="gpu").validate()

    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("ALAC_BATCH_LIMIT", "128")
        assert DecodeConfig().batch_limit == 128


class TestObservability:
    def test_stats_accumulate_through_decode(self):
        GLOBAL_STATS.reset()
        pcm = tone(4096, 2, 16)
        data = encode_to_bytes(pcm, 44100, 16)
        alacnet_tpu.decode_streams([io.BytesIO(data)])
        snap = GLOBAL_STATS.snapshot()
        assert snap["frames"] == 1
        assert snap["samples"] == 4096
        assert snap["host_seconds"] > 0

    def test_trace_span(self):
        with trace_span("alac.test"):
            pass


class TestBenchHarness:
    def test_run_benchmark_smoke(self):
        """bench.py's engine produces a sane record (tiny CPU config)."""
        from alacnet_tpu.bench_lib import run_benchmark

        r = run_benchmark(batch=8, frame_samples=128, repeats=1)
        assert r["unit"] == "Msamples/s"
        assert r["value"] > 0
        assert r["parity_ok"] is True
        assert r["batch_frames"] == 8
        assert r["device"]["platform"] == "cpu"

    def test_run_e2e_benchmark_smoke(self):
        """decode_blob end to end on a tiny CPU config: every field
        present and sane, the device named."""
        from alacnet_tpu.bench_lib import run_e2e_benchmark

        r = run_e2e_benchmark(
            total_frames=48, frame_samples=128, batch_limit=24, repeats=1
        )
        assert r["value"] > 0 and r["host_msps"] > 0
        assert r["total_frames"] == 48
        assert r["total_samples"] > 0
        assert r["device"] == {
            "platform": "cpu", "kind": "cpu", "count": r["device"]["count"],
        }


class TestFuzz:
    def test_random_garbage_frames_never_crash(self, rng):
        """Arbitrary bytes as coded frames: lenient decode must terminate
        with bounded output and no exception (clamped gathers, frozen
        lanes past n, masked tails)."""
        from alacnet_tpu.parallel.pipeline import decode_blob
        from alacnet_tpu.codec.cookie import default_cookie

        params = default_cookie(44100, 16, 2, max_samples_per_frame=256)
        sizes = rng.integers(1, 400, size=64).astype(np.int64)
        blob = rng.integers(0, 256, size=int(sizes.sum()), dtype=np.uint8)
        offsets = np.concatenate(([0], np.cumsum(sizes)))[:-1]
        out, n, status = decode_blob(
            blob, offsets, sizes, params, 256, strict=False
        )
        assert out.shape[0] == 64
        assert (n <= 256).all() and (n >= 0).all()

    def test_bit_flip_fuzz_other_frames_intact(self, rng):
        """Flip random bits inside one frame's payload: other frames must
        stay bit-exact (per-lane isolation)."""
        from alacnet_tpu.container import demux

        pcm = tone(4096 * 4, 2, 16)
        data = bytearray(encode_to_bytes(pcm, 44100, 16))
        info = demux.parse(io.BytesIO(bytes(data)))
        offs = info.tables.frame_file_offsets()
        sizes = info.tables.frame_byte_sizes
        # corrupt frame 2's payload body
        for _ in range(20):
            pos = int(offs[2]) + 20 + int(rng.integers(0, sizes[2] - 30))
            data[pos] ^= 1 << int(rng.integers(0, 8))
        (res,) = decode_streams([io.BytesIO(bytes(data))], strict=False)
        got = res.pcm
        np.testing.assert_array_equal(got[: 4096 * 2], pcm[: 4096 * 2])
        np.testing.assert_array_equal(got[-4096:], pcm[-4096:])


class TestDecodeBlobSink:
    """decode-to-device path: sink consumes device arrays (round 2)."""

    def test_sink_matches_materialized(self):
        import numpy as np

        from alacnet_tpu.codec.encoder import AlacEncoder, EncoderConfig
        from alacnet_tpu.codec.cookie import default_cookie
        from alacnet_tpu.parallel.pipeline import decode_blob

        params = default_cookie(44100, 16, 2, max_samples_per_frame=128)
        enc = AlacEncoder(params, EncoderConfig(order=4))
        rng = np.random.default_rng(8)
        payloads = [
            enc.encode_frame(
                rng.integers(-2000, 2000, (128, 2)).astype(np.int32)
            )
            for _ in range(9)
        ]
        sizes = np.array([len(p) for p in payloads], np.int64)
        offsets = np.concatenate(([0], np.cumsum(sizes)))[:-1]
        blob = np.frombuffer(b"".join(payloads), np.uint8)
        out, n, st = decode_blob(blob, offsets, sizes, params, 128, batch_limit=4)
        got = []

        def sink(out_d, n_d, orig_b):
            got.append(
                (np.asarray(out_d[:orig_b]), np.asarray(n_d[:orig_b]))
            )

        empty, empty_n, st2 = decode_blob(
            blob, offsets, sizes, params, 128, batch_limit=4, sink=sink
        )
        assert empty.shape[0] == 0 and empty_n.shape[0] == 0
        np.testing.assert_array_equal(st2, st)
        # sink batches arrive in size-sorted order; frames here are all
        # near-identical size, so stable sort keeps original order
        sunk = np.concatenate([g[0] for g in got])
        sunk_n = np.concatenate([g[1] for g in got])
        perm = np.argsort(sizes, kind="stable")
        np.testing.assert_array_equal(sunk, out[perm])
        np.testing.assert_array_equal(sunk_n, n[perm])


class TestContainerFuzz:
    """Atom-level demux fuzzing: every malformed container must raise
    HeaderError in bounded time — never hang, never leak a raw
    ValueError/OSError/struct.error (SURVEY.md §5 failure detection).

    These cases found real bugs in round 2b: a lying ftyp size spun the
    compat-brand walk for ~size/4 EOF reads, huge stts/stsc/stsz entry
    counts drove unbounded loops/allocations, and sub-8-byte atom sizes
    leaked MyStream's backwards-skip ValueError.
    """

    def _must_reject_or_parse(self, data: bytes):
        import signal

        def boom(sig, frm):
            raise AssertionError("demux.parse hung on malformed input")

        old = signal.signal(signal.SIGALRM, boom)
        signal.setitimer(signal.ITIMER_REAL, 5.0)
        try:
            try:
                demux.parse(io.BytesIO(data))
            except alacnet_tpu.HeaderError:
                pass  # the contract (AlacContext.cs:46-51)
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old)

    def test_hostile_atom_sizes(self):
        import struct

        base = encode_to_bytes(tone(5000, 2, 16), 44100, 16)
        for sz in (0, 1, 2, 7, 9, 2**31, 2**32 - 1):
            data = bytearray(base)
            data[0:4] = struct.pack(">I", sz)
            self._must_reject_or_parse(bytes(data))

    def test_hostile_table_counts(self):
        """stts/stsc/stsz entry counts beyond their atom bodies."""
        import struct

        base = encode_to_bytes(tone(5000, 2, 16), 44100, 16)
        for fourcc in (b"stts", b"stsc", b"stsz"):
            i = bytes(base).find(fourcc)
            assert i > 0
            for count_off, val in ((i + 8, 0xFFFFFFF0), (i + 12, 0x7FFFFFFF)):
                data = bytearray(base)
                data[count_off : count_off + 4] = struct.pack(">I", val)
                self._must_reject_or_parse(bytes(data))

    def test_header_bit_flips(self, rng):
        base = bytearray(encode_to_bytes(tone(5000, 2, 16), 44100, 16))
        for _ in range(300):
            data = bytearray(base)
            pos = int(rng.integers(0, min(700, len(data))))
            data[pos] ^= 1 << int(rng.integers(0, 8))
            self._must_reject_or_parse(bytes(data))

    def test_random_garbage_headers(self, rng):
        for _ in range(100):
            n = int(rng.integers(0, 500))
            self._must_reject_or_parse(
                rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            )

    def test_table_value_corruption_through_decode_apis(self):
        """Parse-OK files with corrupted stts/stsc/stsz/stco VALUES must
        either decode leniently (bad lanes skipped) or raise a documented
        AlacError (HeaderError for structural lies caught at parse —
        oversized stsz entries, implausible cookie frame sizes —
        SampleReadError for inconsistent chunk tables) in bounded time.
        Round-2b fuzz found corrupt stsz entries sizing device buffers
        (and XLA executables) from a lying u32: ~100 s compile per file."""
        import signal

        from alacnet_tpu.codec.encoder import EncoderConfig
        from alacnet_tpu.errors import AlacError

        rng = np.random.default_rng(0x7AB1E)  # own rng: deterministic cases
        pcm = tone(6 * 128, 2, 16)
        base = bytearray(
            encode_to_bytes(
                pcm, 44100, 16, EncoderConfig(order=4),
                max_samples_per_frame=128,
            )
        )
        locs = {
            cc: bytes(base).find(cc.encode())
            for cc in ("stts", "stsc", "stsz", "stco", "alac")
        }

        def boom(sig, frm):
            raise AssertionError("decode API hung on corrupted tables")

        old = signal.signal(signal.SIGALRM, boom)
        try:
            for cc, at in locs.items():
                assert at > 0
                for _ in range(8):
                    data = bytearray(base)
                    pos = at + 4 + int(rng.integers(0, 36))
                    data[pos] = int(rng.integers(0, 256))
                    signal.setitimer(signal.ITIMER_REAL, 120.0)
                    try:
                        try:
                            demux.parse(io.BytesIO(bytes(data)))
                        except alacnet_tpu.HeaderError:
                            continue
                        try:
                            (res,) = decode_streams(
                                [io.BytesIO(bytes(data))], strict=False
                            )
                            assert res.pcm.shape[0] < 10_000_000
                            ctx = alacnet_tpu.AlacContext(io.BytesIO(bytes(data)))
                            assert ctx.read_all().shape[0] < 10_000_000
                        except AlacError:
                            pass
                    finally:
                        signal.setitimer(signal.ITIMER_REAL, 0)
        finally:
            signal.signal(signal.SIGALRM, old)

    def test_huge_stsc_samples_per_chunk(self):
        """A corrupt stsc samples_per_chunk (2.1e9) must not drive
        multi-GB table expansions (round-2b fuzz hit: np.repeat of a
        per-chunk count taken from a raw u32)."""
        import signal
        import struct

        from alacnet_tpu.codec.encoder import EncoderConfig
        from alacnet_tpu.errors import AlacError

        pcm = tone(6 * 128, 2, 16)
        base = bytearray(
            encode_to_bytes(
                pcm, 44100, 16, EncoderConfig(order=4),
                max_samples_per_frame=128,
            )
        )
        at = bytes(base).find(b"stsc")
        # entry0.samples_per_chunk lives at fourcc+12 in this muxer's
        # layout; blast every entry field with a huge value regardless.
        def boom(sig, frm):
            raise AssertionError("hung on huge stsc entry")

        old = signal.signal(signal.SIGALRM, boom)
        try:
            for off in range(8, 36, 4):
                data = bytearray(base)
                data[at + off : at + off + 4] = struct.pack(">I", 0x7F000005)
                signal.setitimer(signal.ITIMER_REAL, 30.0)
                try:
                    try:
                        (res,) = decode_streams(
                            [io.BytesIO(bytes(data))], strict=False
                        )
                        assert res.pcm.shape[0] < 10_000_000
                    except AlacError:
                        pass
                finally:
                    signal.setitimer(signal.ITIMER_REAL, 0)
        finally:
            signal.signal(signal.SIGALRM, old)

    def test_lying_atom_size_chain(self):
        """An inflated atom-SIZE chain (stbl..stsc/stts sizes and entry
        counts lying together) must reject instantly: the entry-count
        guards bound by the physical stream length, not just the claimed
        atom body (round-2b review finding — claimed-size-only guards
        still allowed a multi-minute zero-extended-EOF walk)."""
        import struct
        import time

        from alacnet_tpu.codec.encoder import EncoderConfig

        data = encode_to_bytes(
            tone(6 * 128, 2, 16), 44100, 16, EncoderConfig(order=4),
            max_samples_per_frame=128,
        )
        for leaf, count_off in ((b"stsc", 8), (b"stts", 12)):
            out = bytearray(data)
            for cc in (b"moov", b"trak", b"mdia", b"minf", b"stbl", leaf):
                at = data.find(cc)
                out[at - 4 : at] = struct.pack(">I", 0x40000000)
            at = data.find(leaf)
            out[at + count_off : at + count_off + 4] = struct.pack(
                ">I", 178_000_000
            )
            t0 = time.perf_counter()
            with pytest.raises(alacnet_tpu.HeaderError):
                demux.parse(io.BytesIO(bytes(out)))
            assert time.perf_counter() - t0 < 2.0

    def test_hostile_chunk_table_no_giant_allocation(self):
        """frame_file_offsets must stay bounded-memory for hostile
        stsc/stco combinations (searchsorted, not a sum(per_chunk)-sized
        np.repeat)."""
        from alacnet_tpu.container.tables import SampleTables

        t = SampleTables(
            frame_byte_sizes=np.full(1 << 16, 10, np.int64),
            stts_counts=np.array([1 << 16], np.int64),
            stts_durations=np.array([128], np.int64),
            stsc_first_chunk=np.array([1], np.int64),
            stsc_samples_per_chunk=np.array([1 << 28], np.int64),
            chunk_offsets=np.arange(100_000, dtype=np.int64),
        )
        offs = t.frame_file_offsets()
        assert offs.shape == (1 << 16,)
