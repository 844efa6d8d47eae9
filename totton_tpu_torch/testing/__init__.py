"""Test-audio tooling: copies of the JAX package's
``testing/signals.py``, ``testing/validate_output.py`` and
``testing/convert_audio.py``.
"""

from totton_tpu_torch.testing.signals import log_sweep, sine, white_noise
from totton_tpu_torch.testing.validate_output import validate_audio

__all__ = ["sine", "log_sweep", "white_noise", "validate_audio"]
