"""The port's overlap-save ops: the plain torch block step
(``overlap_save``), its DFT stages (``fft``), the hand-written CUDA frame
kernel's wrapper (``fused_frames``), device PCM quantization
(``device_pcm``) and the nvcc build (``_build``).
"""

from totton_tpu_torch.ops.overlap_save import (
    OverlapSaveConfig,
    filter_spectrum,
    frame_input,
    upsample_blocks,
    upsample_frames,
    make_block_step,
    zero_stuff,
)

__all__ = [
    "OverlapSaveConfig",
    "filter_spectrum",
    "frame_input",
    "upsample_blocks",
    "upsample_frames",
    "make_block_step",
    "zero_stuff",
]
