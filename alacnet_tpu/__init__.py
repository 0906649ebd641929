"""alacnet_tpu — batch Apple Lossless (ALAC) codec framework on JAX.

A ground-up JAX/XLA/Pallas rebuild with the full capability surface of the
reference C# decoder (teekay/ALAC.NET, see SURVEY.md): MP4/QuickTime demux
with stsz/stco/stsc/stts sample tables, bit-exact ALAC frame decode
(Rice/adaptive-Golomb entropy, adaptive FIR/LPC, stereo decorrelation,
16/24-bit with extra-bits), an ``AlacContext``-style session API and a
streaming seekable reader — plus what the reference lacks: a lossless
encoder, a batched multi-frame device decode pipeline (a fused Pallas
Triton kernel on NVIDIA GPUs), multi-device sharding and a test pyramid.
"""

from .batch import (
    DecodeCursor,
    DecodedAudio,
    decode_file,
    decode_files,
    decode_resumable,
    decode_streams,
)
from .config import DecodeConfig
from .codec.cookie import CodecParams, default_cookie
from .codec.encoder import (
    AlacEncoder, EncoderConfig, encode_files, encode_m4a,
)
from .codec.encoder_tpu import encode_frames_tpu
from .container.demux import StreamInfo, parse
from .context import AlacContext
from .pcm import format_pcm_bytes, read_wav, write_wav
from .reader import ALACFileReader, WaveFormat
from .errors import (
    AlacError,
    BitstreamError,
    HeaderError,
    MdatPosStatus,
    SampleReadError,
    UnsupportedFormatError,
)

__version__ = "0.1.0"

__all__ = [
    "ALACFileReader",
    "AlacContext",
    "AlacEncoder",
    "AlacError",
    "DecodeConfig",
    "DecodeCursor",
    "DecodedAudio",
    "decode_resumable",
    "WaveFormat",
    "decode_file",
    "decode_files",
    "decode_streams",
    "format_pcm_bytes",
    "read_wav",
    "write_wav",
    "BitstreamError",
    "CodecParams",
    "EncoderConfig",
    "HeaderError",
    "MdatPosStatus",
    "SampleReadError",
    "StreamInfo",
    "UnsupportedFormatError",
    "default_cookie",
    "encode_files",
    "encode_m4a",
    "encode_frames_tpu",
    "parse",
    "__version__",
]
