"""Streaming upsampler engine on torch: the block-streaming
upsampler, its crossfeed chain and the filter selector.
"""

from totton_tpu_torch.engine.upsampler import StreamingUpsampler, upsample_signal
from totton_tpu_torch.engine.selector import resolve_filter_path

__all__ = ["StreamingUpsampler", "upsample_signal", "resolve_filter_path"]
