"""Host-side audio IO: copies of the JAX package's framework-free
modules (PCM conversion, WAV/raw files, ring buffers, sources and sinks,
format negotiation, the serve client) and the streaming session that
feeds the port's engine.
"""

from totton_tpu_torch.io.pcm import (
    PcmFormat,
    parse_format,
    bytes_per_sample,
    pcm_to_float,
    float_to_pcm,
    TpdfDitherer,
    interleave,
    deinterleave,
)
from totton_tpu_torch.io.formats import PcmFormatSet
from totton_tpu_torch.io.ring_buffer import AudioRingBuffer
from totton_tpu_torch.io.wav import read_wav, write_wav

__all__ = [
    "PcmFormat",
    "parse_format",
    "bytes_per_sample",
    "pcm_to_float",
    "float_to_pcm",
    "TpdfDitherer",
    "interleave",
    "deinterleave",
    "PcmFormatSet",
    "AudioRingBuffer",
    "read_wav",
    "write_wav",
]
