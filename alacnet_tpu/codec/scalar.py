"""Reference-exact scalar ALAC frame decoder (the differential oracle).

This module transcribes the *semantics* of the reference codec core
(/root/reference/ALACDecoder/AlacFile.cs) into plain Python with explicit
two's-complement int32 arithmetic.  It is the correctness oracle for the
device decode path (`alacnet_tpu.ops`): every JAX kernel must produce
bit-identical output to this module on the test corpus, and this module is
itself validated by hand-derived golden vectors (tests/test_scalar_golden.py)
covering the reference's quirks: the Unreadbits accumulator handling
(AlacFile.cs:145-152), the Rice escape path (:199-202), zero-run blocks
(:231-249), the order-31 predictor (:268-282) and the adaptive coefficient
walk (:312-332).

It is intentionally slow (per-sample Python); production decode goes
through the batched device pipeline.
"""

from __future__ import annotations

from ..errors import UnsupportedFormatError
from .cookie import RICE_THRESHOLD, CodecParams

_U32 = 0xFFFFFFFF


def i32(x: int) -> int:
    """Wrap to two's-complement int32 (C# unchecked int arithmetic)."""
    x &= _U32
    return x - 0x1_0000_0000 if x & 0x8000_0000 else x


def trunc_div(a: int, b: int) -> int:
    """C# integer division: truncates toward zero (AlacFile.cs:225,234)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def clz32(x: int) -> int:
    """Count leading zeros per the reference's byte ladder.

    Matches CountLeadingZeros/CountLeadingZerosExtra (AlacFile.cs:154-191)
    for every int32 input: negatives (top bit set) give 0, and **zero
    gives 40** — the ladder falls through all four bytes and returns
    ``output + 8`` (AlacFile.cs:190), a quirk that changes the zero-run
    k (16 vs 8) whenever the Rice history is exactly 0.
    """
    x &= _U32
    return 40 if x == 0 else 32 - x.bit_length()


class BitReader:
    """MSB-first bit reader over one frame payload (AlacFile.cs:101-152).

    ``Readbits16`` in the reference unconditionally fetches 3 consecutive
    bytes (AlacFile.cs:103-105), relying on slack past the frame end in its
    80 KB scratch buffer (AlacContext.cs:64).  We zero-pad instead: for any
    read that lies within the payload the returned value is identical, and
    reads past the end (only reachable on malformed frames) see zeros
    rather than stale bytes from the previous frame.
    """

    __slots__ = ("buf", "idx", "acc")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.idx = 0
        self.acc = 0  # bits already consumed within buf[idx]

    def _byte(self, i: int) -> int:
        return self.buf[i] if 0 <= i < len(self.buf) else 0

    def readbits16(self, bits: int) -> int:
        """1..16 bit big-endian read (AlacFile.cs:101-118)."""
        part1 = self._byte(self.idx)
        part2 = self._byte(self.idx + 1)
        part3 = self._byte(self.idx + 2)
        result = (
            (((part1 << 16) | (part2 << 8) | part3) << self.acc) & 0x00FFFFFF
        ) >> (24 - bits)
        new_acc = self.acc + bits
        self.idx += new_acc >> 3
        self.acc = new_acc & 7
        return result

    def readbits(self, bits_param: int) -> int:
        """1..32 bit big-endian read (AlacFile.cs:125-129)."""
        bits = bits_param if bits_param <= 16 else bits_param - 16
        hi = 0 if bits_param <= 16 else i32(self.readbits16(16) << bits)
        return i32(hi | self.readbits16(bits))

    def readbit(self) -> int:
        """Single-bit read (AlacFile.cs:135-143)."""
        part1 = self._byte(self.idx)
        result = ((part1 << self.acc) >> 7) & 1
        new_acc = self.acc + 1
        self.idx += new_acc // 8
        self.acc = new_acc % 8
        return result

    def unreadbits(self, bits: int) -> None:
        """Rewind (AlacFile.cs:145-152).

        The reference's trailing ``if (acc < 0) acc *= -1`` is dead code
        (``newAccumulator & 7`` is always in 0..7); kept out deliberately.
        """
        new_acc = self.acc - bits
        self.idx += new_acc >> 3  # Python floor shift == C# arithmetic shift
        self.acc = new_acc & 7

    @property
    def bitpos(self) -> int:
        return self.idx * 8 + self.acc


def entropy_decode_value(
    reader: BitReader, read_sample_size: int, k: int, rice_kmodifier_mask: int
) -> int:
    """Decode one Rice/adaptive-Golomb value (AlacFile.cs:193-212).

    ``rice_kmodifier_mask`` is applied to the (2^k - 1) multiplier only —
    the main sample loop passes 0xFFFFFFFF (no-op) while the zero-run
    block-size decode passes (1<<kmod)-1 (AlacFile.cs:223-224,236).
    """
    value = 0
    while value <= RICE_THRESHOLD and reader.readbit() != 0:
        value += 1
    if value > RICE_THRESHOLD:
        # Escape: raw read_sample_size-bit value (AlacFile.cs:199-202).
        return i32(
            reader.readbits(read_sample_size)
            & i32(_U32 >> (32 - read_sample_size))
        )
    if k == 1:
        return value
    extra_bits = reader.readbits(k)
    value = i32(value * (((1 << k) - 1) & rice_kmodifier_mask))
    if extra_bits > 1:
        value = i32(value + extra_bits - 1)
    else:
        reader.unreadbits(1)
    return value


def entropy_rice_decode(
    reader: BitReader,
    output: list[int],
    output_size: int,
    read_sample_size: int,
    rice_initial_history: int,
    rice_kmodifier: int,
    rice_history_mult: int,
    rice_kmodifier_mask: int,
) -> None:
    """Rice-decode ``output_size`` prediction errors (AlacFile.cs:214-252)."""
    history = rice_initial_history
    count = 0
    sign_modifier = 0
    while count < output_size:
        # Per-sample k: min(31 - clz((h>>9)+3), kmod) (AlacFile.cs:221-222).
        initial_k = 31 - rice_kmodifier - clz32(i32((history >> 9) + 3))
        k = initial_k + rice_kmodifier if initial_k < 0 else rice_kmodifier
        decoded = i32(
            entropy_decode_value(reader, read_sample_size, k, i32(_U32))
            + sign_modifier
        )
        # Zig-zag with C# truncating division (AlacFile.cs:225-226).
        almost = trunc_div(decoded + 1, 2)
        output[count] = -almost if (decoded & 1) != 0 else almost
        sign_modifier = 0
        # History update (AlacFile.cs:229): signed compare, wrapping mult.
        if decoded > 0xFFFF:
            history = 0xFFFF
        else:
            history = i32(
                history
                + i32(decoded * rice_history_mult)
                - (i32(history * rice_history_mult) >> 9)
            )
        # Zero-run block (AlacFile.cs:231-249).
        if history < 128 and count + 1 < output_size:
            sign_modifier = 1
            k = clz32(history) + trunc_div(history + 16, 64) - 24
            block_size = entropy_decode_value(reader, 16, k, rice_kmodifier_mask)
            if block_size > 0:
                # The reference writes past output_size unchecked
                # (AlacFile.cs:240-243); those bytes are never read, so we
                # clamp the writes with identical visible behavior.
                for j in range(min(block_size, max(0, len(output) - count - 1))):
                    output[count + 1 + j] = 0
                count += block_size
            if block_size > 0xFFFF:
                sign_modifier = 0
            history = 0
        count += 1


def predictor_decompress_fir_adapt(
    error_buffer: list[int],
    output_size: int,
    readsamplesize: int,
    coefs: list[int],
    order: int,
    quant: int,
) -> list[int]:
    """Adaptive FIR/LPC reconstruction (AlacFile.cs:256-336).

    Operates in place over ``error_buffer`` (the reference aliases
    bufferOut = errorBuffer at :260) and mutates ``coefs`` (the adaptive
    update at :312-332 persists for the remainder of the frame).
    """
    out = error_buffer  # in-place, as in the reference
    if order == 0:
        return out  # passthrough copy of an aliased buffer is a no-op
    bitsmove = 32 - readsamplesize

    def signext(v: int) -> int:
        return i32(v << bitsmove) >> bitsmove

    if order == 0x1F:
        # Pure first-order integration (AlacFile.cs:268-282).
        for i in range(output_size - 1):
            out[i + 1] = signext(out[i] + error_buffer[i + 1])
        return out
    # Warm-up: integrate the first `order` deltas (AlacFile.cs:284-293).
    for i in range(min(order, max(0, output_size - 1))):
        out[i + 1] = signext(out[i] + error_buffer[i + 1])
    # General case (AlacFile.cs:297-334).
    base = 0
    for i in range(order + 1, output_size):
        error_val = error_buffer[i]
        total = 0
        for j in range(order):
            total = i32(
                total + i32((out[base + order - j] - out[base]) * coefs[j])
            )
        # C# shift counts are masked & 31 (quant == 0 -> 1 << 31).
        outval = i32((1 << ((quant - 1) & 31)) + total) >> quant
        outval = signext(outval + out[base] + error_val)
        out[base + order + 1] = outval
        # Adaptive coefficient update (AlacFile.cs:312-332).
        if error_val > 0:
            pn = order - 1
            while pn >= 0 and error_val > 0:
                val = i32(out[base] - out[base + order - pn])
                sign = (val > 0) - (val < 0)
                coefs[pn] = i32(coefs[pn] - sign)
                val = i32(val * sign)  # |val|
                error_val = i32(error_val - (val >> quant) * (order - pn))
                pn -= 1
        elif error_val < 0:
            pn = order - 1
            while pn >= 0 and error_val < 0:
                val = i32(out[base] - out[base + order - pn])
                sign = -((val > 0) - (val < 0))
                coefs[pn] = i32(coefs[pn] - sign)
                val = i32(val * sign)  # -|val|
                error_val = i32(error_val - (val >> quant) * (order - pn))
                pn -= 1
        base += 1
    return out


def deinterlace16(
    buf_a: list[int],
    buf_b: list[int],
    out: list[int],
    numchannels: int,
    numsamples: int,
    interlacing_shift: int,
    interlacing_leftweight: int,
) -> None:
    """Stereo decorrelation, 16-bit layout (AlacFile.cs:338-367)."""
    if numsamples <= 0:
        return
    if interlacing_leftweight != 0:
        for i in range(numsamples):
            midright = buf_a[i]
            difference = buf_b[i]
            right = i32(
                midright - (i32(difference * interlacing_leftweight) >> interlacing_shift)
            )
            left = i32(right + difference)
            out[i * numchannels] = left
            out[i * numchannels + 1] = right
    else:
        for i in range(numsamples):
            out[i * numchannels] = buf_a[i]
            out[i * numchannels + 1] = buf_b[i]


def deinterlace24(
    buf_a: list[int],
    buf_b: list[int],
    uncompressed_bytes: int,
    extra_a: list[int],
    extra_b: list[int],
    out: list[int],
    numchannels: int,
    numsamples: int,
    interlacing_shift: int,
    interlacing_leftweight: int,
) -> None:
    """Stereo decorrelation, 24-bit byte layout (AlacFile.cs:369-421)."""
    if numsamples <= 0:
        return
    for i in range(numsamples):
        if interlacing_leftweight != 0:
            midright = buf_a[i]
            difference = buf_b[i]
            right = i32(
                midright - (i32(difference * interlacing_leftweight) >> interlacing_shift)
            )
            left = i32(right + difference)
        else:
            left = buf_a[i]
            right = buf_b[i]
        if uncompressed_bytes != 0:
            mask = i32(~(_U32 << (uncompressed_bytes * 8)))
            left = i32(left << (uncompressed_bytes * 8)) | (extra_a[i] & mask)
            right = i32(right << (uncompressed_bytes * 8)) | (extra_b[i] & mask)
        out[i * numchannels * 3] = left & 0xFF
        out[i * numchannels * 3 + 1] = (left >> 8) & 0xFF
        out[i * numchannels * 3 + 2] = (left >> 16) & 0xFF
        out[i * numchannels * 3 + 3] = right & 0xFF
        out[i * numchannels * 3 + 4] = (right >> 8) & 0xFF
        out[i * numchannels * 3 + 5] = (right >> 16) & 0xFF


BUFFER_SIZE = 16384  # AlacFile.cs:28


class AlacFrameDecoder:
    """Stateful frame decoder, one instance per stream (AlacFile.cs:14-61).

    Holds the persistent scratch buffers and coefficient tables the
    reference keeps as instance fields; persistence is observable (e.g. a
    mono frame with predictionType != 0 silently leaves the *previous*
    frame's outputs in place, AlacFile.cs:488-496).
    """

    def __init__(self, params: CodecParams, numchannels: int):
        self.params = params
        self.numchannels = numchannels
        self.bytespersample = (params.sample_size // 8) * numchannels
        self.pred_error_a = [0] * BUFFER_SIZE
        self.pred_error_b = [0] * BUFFER_SIZE
        self.out_a = [0] * BUFFER_SIZE
        self.out_b = [0] * BUFFER_SIZE
        self.extra_a = [0] * BUFFER_SIZE
        self.extra_b = [0] * BUFFER_SIZE
        self.coefs = [0] * 1024
        self.coefs_a = [0] * 1024
        self.coefs_b = [0] * 1024

    # -- helpers -----------------------------------------------------------

    def _read_coef_table(self, reader: BitReader, table: list[int], n: int) -> None:
        """16-bit signed coefficient reads (AlacFile.cs:466-475)."""
        for i in range(n):
            pred = reader.readbits(16)
            if pred > 32767:
                pred -= 65536
            table[i] = pred

    # -- main entry (AlacFile.cs:428-719) -----------------------------------

    def decode_frame(self, inbuffer: bytes, outbuffer: list[int]) -> int:
        p = self.params
        outputsamples = p.max_samples_per_frame
        reader = BitReader(inbuffer)
        channels = reader.readbits(3)
        outputsize = outputsamples * self.bytespersample
        if channels == 0:
            return self._decode_mono(reader, outbuffer, outputsamples, outputsize)
        if channels == 1:
            return self._decode_stereo(reader, outbuffer, outputsamples, outputsize)
        raise UnsupportedFormatError(
            f"unsupported frame channel tag {channels} (only 0/1 handled, "
            "AlacFile.cs:435-437,577)"
        )

    # -- mono element (AlacFile.cs:437-576) ----------------------------------

    def _decode_mono(
        self, reader: BitReader, outbuffer: list[int], outputsamples: int, outputsize: int
    ) -> int:
        p = self.params
        reader.readbits(4)
        reader.readbits(12)
        hassize = reader.readbits(1)
        uncompressed_bytes = reader.readbits(2)
        isnotcompressed = reader.readbits(1)
        if hassize != 0:
            outputsamples = reader.readbits(32)
            outputsize = outputsamples * self.bytespersample
        readsamplesize = p.sample_size - uncompressed_bytes * 8
        if isnotcompressed == 0:
            reader.readbits(8)
            reader.readbits(8)
            prediction_type = reader.readbits(4)
            quant = reader.readbits(4)
            ricemodifier = reader.readbits(3)
            order = reader.readbits(5)
            self._read_coef_table(reader, self.coefs, order)
            if uncompressed_bytes != 0:
                for i in range(outputsamples):
                    self.extra_a[i] = reader.readbits(uncompressed_bytes * 8)
            entropy_rice_decode(
                reader,
                self.pred_error_a,
                outputsamples,
                readsamplesize,
                p.rice_initial_history,
                p.rice_kmodifier,
                ricemodifier * (p.rice_history_mult // 4),
                (1 << p.rice_kmodifier) - 1,
            )
            if prediction_type == 0:
                self.out_a = predictor_decompress_fir_adapt(
                    self.pred_error_a,
                    outputsamples,
                    readsamplesize,
                    self.coefs,
                    order,
                    quant,
                )
            # else: reference silently no-ops (AlacFile.cs:488-496) —
            # out_a keeps the previous frame's contents.
        else:
            if p.sample_size <= 16:
                bitsmove = 32 - p.sample_size
                for i in range(outputsamples):
                    bits = reader.readbits(p.sample_size)
                    self.out_a[i] = i32(bits << bitsmove) >> bitsmove
            else:
                m = 1 << 23
                for i in range(outputsamples):
                    bits = reader.readbits(16)
                    bits = i32(bits << (p.sample_size - 16))
                    bits = i32(bits | reader.readbits(p.sample_size - 16))
                    x = bits & ((1 << 24) - 1)
                    self.out_a[i] = (x ^ m) - m
            uncompressed_bytes = 0  # AlacFile.cs:525
        if p.sample_size == 16:
            for i in range(outputsamples):
                outbuffer[i * self.numchannels] = self.out_a[i]
                # Mono-in-stereo: silent second channel (AlacFile.cs:536-540).
                outbuffer[i * self.numchannels + 1] = 0
        elif p.sample_size == 24:
            for i in range(outputsamples):
                sample = self.out_a[i]
                if uncompressed_bytes != 0:
                    sample = i32(sample << (uncompressed_bytes * 8))
                    mask = i32(~(_U32 << (uncompressed_bytes * 8)))
                    sample |= self.extra_a[i] & mask
                base = i * self.numchannels * 3
                outbuffer[base] = sample & 0xFF
                outbuffer[base + 1] = (sample >> 8) & 0xFF
                outbuffer[base + 2] = (sample >> 16) & 0xFF
                outbuffer[base + 3] = 0
                outbuffer[base + 4] = 0
                outbuffer[base + 5] = 0
        else:
            raise UnsupportedFormatError(
                f"FIXME: unimplemented sample size {p.sample_size}"
            )
        return outputsize

    # -- stereo element (AlacFile.cs:577-717) ---------------------------------

    def _decode_stereo(
        self, reader: BitReader, outbuffer: list[int], outputsamples: int, outputsize: int
    ) -> int:
        p = self.params
        reader.readbits(4)
        reader.readbits(12)
        hassize = reader.readbits(1)
        uncompressed_bytes = reader.readbits(2)
        isnotcompressed = reader.readbits(1)
        if hassize != 0:
            outputsamples = reader.readbits(32)
            outputsize = outputsamples * self.bytespersample
        readsamplesize = p.sample_size - uncompressed_bytes * 8 + 1
        if isnotcompressed == 0:
            interlacing_shift = reader.readbits(8)
            interlacing_leftweight = reader.readbits(8)
            prediction_type_a = reader.readbits(4)
            quant_a = reader.readbits(4)
            ricemodifier_a = reader.readbits(3)
            order_a = reader.readbits(5)
            self._read_coef_table(reader, self.coefs_a, order_a)
            prediction_type_b = reader.readbits(4)
            quant_b = reader.readbits(4)
            ricemodifier_b = reader.readbits(3)
            order_b = reader.readbits(5)
            self._read_coef_table(reader, self.coefs_b, order_b)
            if uncompressed_bytes != 0:
                # Interleaved A,B extra-bits per sample (AlacFile.cs:634-641).
                for i in range(outputsamples):
                    self.extra_a[i] = reader.readbits(uncompressed_bytes * 8)
                    self.extra_b[i] = reader.readbits(uncompressed_bytes * 8)
            entropy_rice_decode(
                reader,
                self.pred_error_a,
                outputsamples,
                readsamplesize,
                p.rice_initial_history,
                p.rice_kmodifier,
                ricemodifier_a * (p.rice_history_mult // 4),
                (1 << p.rice_kmodifier) - 1,
            )
            if prediction_type_a == 0:
                self.out_a = predictor_decompress_fir_adapt(
                    self.pred_error_a,
                    outputsamples,
                    readsamplesize,
                    self.coefs_a,
                    order_a,
                    quant_a,
                )
            else:
                raise UnsupportedFormatError(
                    f"FIXME: unhandled prediction type: {prediction_type_a}"
                )
            entropy_rice_decode(
                reader,
                self.pred_error_b,
                outputsamples,
                readsamplesize,
                p.rice_initial_history,
                p.rice_kmodifier,
                ricemodifier_b * (p.rice_history_mult // 4),
                (1 << p.rice_kmodifier) - 1,
            )
            if prediction_type_b == 0:
                self.out_b = predictor_decompress_fir_adapt(
                    self.pred_error_b,
                    outputsamples,
                    readsamplesize,
                    self.coefs_b,
                    order_b,
                    quant_b,
                )
            else:
                raise UnsupportedFormatError(
                    f"FIXME: unhandled prediction type: {prediction_type_b}"
                )
        else:
            if p.sample_size <= 16:
                bitsmove = 32 - p.sample_size
                for i in range(outputsamples):
                    a = reader.readbits(p.sample_size)
                    b = reader.readbits(p.sample_size)
                    self.out_a[i] = i32(a << bitsmove) >> bitsmove
                    self.out_b[i] = i32(b << bitsmove) >> bitsmove
            else:
                m = 1 << 23
                for i in range(outputsamples):
                    a = reader.readbits(16)
                    a = i32(a << (p.sample_size - 16))
                    a = i32(a | reader.readbits(p.sample_size - 16))
                    self.out_a[i] = ((a & 0xFFFFFF) ^ m) - m
                    b = reader.readbits(16)
                    b = i32(b << (p.sample_size - 16))
                    b = i32(b | reader.readbits(p.sample_size - 16))
                    self.out_b[i] = ((b & 0xFFFFFF) ^ m) - m
            uncompressed_bytes = 0
            interlacing_shift = 0
            interlacing_leftweight = 0
        if p.sample_size == 16:
            deinterlace16(
                self.out_a,
                self.out_b,
                outbuffer,
                self.numchannels,
                outputsamples,
                interlacing_shift,
                interlacing_leftweight,
            )
        elif p.sample_size == 24:
            deinterlace24(
                self.out_a,
                self.out_b,
                uncompressed_bytes,
                self.extra_a,
                self.extra_b,
                outbuffer,
                self.numchannels,
                outputsamples,
                interlacing_shift,
                interlacing_leftweight,
            )
        else:
            raise UnsupportedFormatError(
                f"FIXME: unimplemented sample size {p.sample_size}"
            )
        return outputsize


def format_samples(bps: int, src: list[int], samcnt: int) -> bytes:
    """int buffer -> little-endian PCM bytes (AlacContext.cs:214-256).

    bps=1: offset-binary (+128); bps=2: 16-bit LE with ``samcnt`` counted
    in *bytes* and decremented by 2 (AlacContext.cs:231-241); bps=3:
    passthrough (ints already hold individual bytes).
    """
    out = bytearray()
    if bps == 1:
        for i in range(samcnt):
            out.append((src[i] + 128) & 0xFF)
    elif bps == 2:
        i = 0
        while samcnt > 0:
            v = src[i] & 0xFFFF
            out.append(v & 0xFF)
            out.append(v >> 8)
            i += 1
            samcnt -= 2
    elif bps == 3:
        for i in range(samcnt):
            out.append(src[i] & 0xFF)
    else:
        raise UnsupportedFormatError(f"unsupported bytes-per-sample {bps}")
    return bytes(out)
