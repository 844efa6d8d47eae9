"""The frame kernel's CUDA source, run on the CPU: ``csrc/fused_frames.cu``
is compiled with g++ against ``torch_cuda_shim``'s ``cuda_runtime.h``
(each lane of a block a ``std::thread``, ``__syncthreads`` a
``std::barrier``, the dynamic shared memory a NaN-filled buffer a block)
and driven through the wrapper's own launch (``fused_frames._launch``,
the library bound by ``_bind``) on CPU tensors. It is held against the
plain version (``overlap_save.upsample_frames`` on the folded G) with rel
< 1e-5, the kernel-vs-plain limit on the card: on the resident plan at
ratio 1 (129, 1024) and (1025, 4096) with an APO EQ and at every ratio of
the 8k bank, and on three small three-launch geometries (the fused
forward at 16x and at the largest frame it takes, the four-step forward
with P != Q), at 1, 2 and 3 frames."""

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_cuda_shim import build_library
from totton_tpu_torch.control.wiring import resolve_eq_response
from totton_tpu_torch.ops import fused_frames as ff
from totton_tpu_torch.ops import overlap_save as tos

torch.set_num_threads(2)

SOURCE = Path(ff.__file__).resolve().parents[1] / "csrc" / "fused_frames.cu"
REL_TOL = 1e-5
EQ_PROFILE = ("Preamp: -5 dB\n"
              "Filter 1: ON PK Fc 1000 Hz Gain 3 dB Q 1.0\n"
              "Filter 2: ON LSC Fc 105 Hz Gain 4 dB Q 0.7\n"
              "Filter 3: ON HSC Fc 8000 Hz Gain -2 dB Q 0.7\n")
# (taps, fft_size, ratio, the APO EQ baked in, resident): ratio 1 at the
# seeded (129, 1024) and the CLI's identity (1025, 4096) geometries; the
# 8k bank at 16x, 2x (the largest frame), 4x and 8x (fft_resident<2048,
# 8192> and <1024, 8192>); three-launch geometries at a small size: h =
# 16384 with the fused forward (F, I1, I2), m = 16384 with the fused
# forward at its largest (fft_stage<8192>, 64 KB of shared memory, as at
# 8x/80k), and m = 32768 with the four-step forward at P = 256 != Q = 128
# (F1, F2, I1, I2; as at 4x/80k), whose inverse splits 256 x 128 too.
GEOMETRIES = [(129, 1024, 1, False, True), (1025, 4096, 1, True, True),
              (8001, 16384, 16, False, True), (8001, 16384, 2, False, True),
              (8001, 16384, 4, False, True), (8001, 16384, 8, False, True),
              (2049, 32768, 16, False, False), (1025, 32768, 2, False, False),
              (1025, 65536, 2, False, False)]


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    return ff._bind(build_library(SOURCE,
                                  tmp_path_factory.mktemp("frames_source")))


def _bundle(taps, fft, ratio, eq, tmp_path):
    cfg = tos.OverlapSaveConfig(taps, fft, fft - taps + 1, ratio)
    rng = np.random.default_rng(taps + ratio)
    if taps == 1025 and ratio == 1:
        h = np.zeros(taps)
        h[0] = 1.0
    else:
        h = rng.normal(size=taps) * np.exp(-np.arange(taps) / (taps / 8))
    response = None
    if eq:
        path = tmp_path / "eq.txt"
        path.write_text(EQ_PROFILE)
        response = resolve_eq_response(str(path), None, fft, 44100)[0]
    return cfg, tos._folded_g(tos.filter_spectrum(h, fft, response), cfg)


@pytest.mark.parametrize("n_frames", [1, 2, 3])
@pytest.mark.parametrize("taps,fft,ratio,eq,resident", GEOMETRIES)
def test_kernel_source_matches_plain(shim_lib, tmp_path, taps, fft, ratio, eq,
                                     resident, n_frames):
    cfg, bundle = _bundle(taps, fft, ratio, eq, tmp_path)
    assert ff.kernel_plan(cfg)["resident"] == resident
    rng = np.random.default_rng(n_frames)
    frames = torch.from_numpy(
        (rng.normal(size=(n_frames, cfg.frame_in)) * 0.3).astype(np.float32))
    before = ff.LAUNCHES
    y = ff._launch(shim_lib, frames, bundle.weights, cfg, None)
    assert ff.LAUNCHES == before + 1
    ref = tos.upsample_frames(frames, bundle, cfg)
    assert y.shape == ref.shape == (n_frames, cfg.block_size)
    assert torch.isfinite(y).all()
    rel = ((y - ref).abs().max() / ref.abs().max()).item()
    assert rel < REL_TOL


@pytest.mark.parametrize("taps,fft,ratio,eq,resident",
                         [GEOMETRIES[2], GEOMETRIES[4]])
def test_resident_launch_allocates_no_scratch(shim_lib, tmp_path, monkeypatch,
                                              taps, fft, ratio, eq, resident):
    """The resident plan's one tensor is its output; the three-launch plan
    also takes X [n, m] and C [n, h] complex scratch."""
    cfg, bundle = _bundle(taps, fft, ratio, eq, tmp_path)
    frames = torch.zeros((2, cfg.frame_in))
    ff.kernel_consts(cfg, frames.device)  # the tables, cached
    made = []
    real_empty = torch.empty

    def empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        made.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", empty)
    ff._launch(shim_lib, frames, bundle.weights, cfg, None)
    scratch = [] if resident else [(2, cfg.frame_in, 2),
                                   (2, cfg.fft_size // 2, 2)]
    assert made == [(2, cfg.block_size)] + scratch


def test_resident_entry_refuses_what_it_cannot_run(shim_lib):
    """The resident C entry returns an error, and launches nothing, for a
    geometry outside its envelope or arguments that do not agree."""
    fn = shim_lib.totton_resident_frames
    x = torch.zeros(4096)
    out = torch.full((4096,), 7.0)
    p = x.data_ptr()
    for m, h, block, j0, halves in ((1024, 16384, 32000, 384, 0),  # h
                                    (2048, 128, 192, 32, 0),       # h
                                    (64, 8192, 16000, 192, 0),     # ratio
                                    (1024, 512, 960, 32, 0),       # halves
                                    (1024, 8192, 16000, 100, 0)):  # block
        assert fn(p, out.data_ptr(), p, p, p, 1, m, h, block, j0, halves, 0,
                  None) != 0
    assert (out == 7.0).all()
