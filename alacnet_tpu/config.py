"""Typed runtime configuration (SURVEY.md §5 "config / flag system").

The reference has zero runtime flags — everything is data-driven from the
bitstream (cookie + frame headers), with hardcoded tunables
(BufferSize=16384 AlacFile.cs:28, 80 KB I/O buffers AlacContext.cs:64-66).
Codec parameters stay bitstream-driven here too; this config holds only
the *execution* knobs: batching, kernel selection, strictness, streaming
window.  Every field has an ``ALAC_*`` environment override.
"""

from __future__ import annotations

import dataclasses
import os


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v not in ("0", "false", "False", "no")


@dataclasses.dataclass
class DecodeConfig:
    """Execution knobs for the decode pipeline."""

    #: Max frames per device dispatch.  The decode kernel runs one
    #: thread per frame and is latency-bound along each frame's serial
    #: bit cursor, so a dispatch of 16384 frames costs about what one of
    #: 4096 does; past 16384, end-to-end decode_blob gained nothing on
    #: an H100 (PERF.md).
    batch_limit: int = dataclasses.field(
        default_factory=lambda: _env_int("ALAC_BATCH_LIMIT", 16384)
    )
    #: Frames decoded per window in the streaming AlacContext.
    stream_window: int = dataclasses.field(
        default_factory=lambda: _env_int("ALAC_STREAM_WINDOW", 64)
    )
    #: Decode route (ops/route.py): "auto" (gpu -> the Triton kernel,
    #: cpu -> the XLA scans), "fused" (the kernel everywhere; the Pallas
    #: interpreter on cpu), "xla" (the scans everywhere).
    kernel: str = dataclasses.field(
        default_factory=lambda: os.environ.get("ALAC_KERNEL", "auto")
    )
    #: strict=True raises on undecodable frames (reference behavior for
    #: stereo, AlacFile.cs:650,660); strict=False poisons only the
    #: offending lanes and reports them (SURVEY.md §5 failure detection).
    strict: bool = dataclasses.field(
        default_factory=lambda: _env_bool("ALAC_STRICT", True)
    )
    #: Emit int16 PCM for all-16-bit batches (halves transfers).
    emit16: bool = dataclasses.field(
        default_factory=lambda: _env_bool("ALAC_EMIT16", True)
    )
    #: Use the native C++ host runtime when available.
    native: bool = dataclasses.field(
        default_factory=lambda: _env_bool("ALAC_NATIVE", True)
    )
    #: Assemble the (B, W) word-row table on the device
    #: (ops/pack_rows.py): the host ships the raw blob once (~half the
    #: H2D bytes) and keeps only header parsing.  Under a mesh the word
    #: blob replicates (one broadcast per corpus) and each shard gathers
    #: its own lanes' rows.
    device_pack: bool = dataclasses.field(
        default_factory=lambda: _env_bool("ALAC_DEVICE_PACK", True)
    )

    def validate(self) -> "DecodeConfig":
        if self.kernel not in ("auto", "fused", "xla"):
            raise ValueError(f"kernel must be auto/fused/xla, got {self.kernel}")
        if self.batch_limit <= 0:
            raise ValueError("batch_limit must be positive")
        return self


#: Process default, constructed from the environment at import.
DEFAULT = DecodeConfig().validate()
