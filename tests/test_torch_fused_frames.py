"""The port's frame kernel wrapper (totton_tpu_torch.ops.fused_frames).

On the CPU the wrapper runs the plain version: it is checked against the
JAX Pallas kernel in interpret mode on tests/test_pallas.py's geometries.
The CUDA kernel cannot run here, so its four-launch algebra — the operand
layouts, strides and epilogue index maps of csrc/fused_frames.cu — is
replayed in numpy from the wrapper's own plan and constants and held
against the plain version. The kernel itself is compared with the plain
version on the card by the test marked ``cuda`` (and by chip_smoke.py).
"""

import glob
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from totton_tpu.experimental.pallas_kernels import fused_upsample_blocks as jax_fused
from totton_tpu.ops import overlap_save as jos
from totton_tpu_torch.convert import from_jax
from totton_tpu_torch.ops import _build
from totton_tpu_torch.ops import fused_frames as ff
from totton_tpu_torch.ops import overlap_save as tos

torch.set_num_threads(2)

PALLAS_GEOMETRIES = [(257, 2048, 4), (1025, 4096, 2), (1025, 8192, 16),
                     (129, 1024, 1), (1025, 8192, 8)]
KERNEL_GEOMETRIES = PALLAS_GEOMETRIES
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(taps, fft, ratio):
    kw = dict(taps=taps, fft_size=fft, block_size=fft - (taps - 1),
              ratio=ratio)
    return jos.OverlapSaveConfig(**kw), tos.OverlapSaveConfig(**kw)


def _rel(y, ref):
    return np.abs(y - ref).max() / np.abs(ref).max()


def emulate_kernel(frames: np.ndarray, bundle, cfg) -> np.ndarray:
    """numpy replay of csrc/fused_frames.cu's four launches (F1, F2, I1,
    I2) with the layouts and index maps the .cu uses."""
    pl = ff.kernel_plan(cfg)
    consts = {k: v[..., 0].numpy() + 1j * v[..., 1].numpy()
              for k, v in ff.kernel_consts(cfg, "cpu").items()}
    n = frames.shape[0]
    m, p, q = pl["m"], pl["P"], pl["Q"]
    p2, q2, r = pl["P2"], pl["Q2"], pl["r"]
    # F1: rows (n, q), depth p, cols k1; store b[n*m + k1*Q + q] * tw.
    a = frames.reshape(n, p, q).transpose(0, 2, 1).reshape(n * q, p)
    c1 = (a @ consts["w_p"]).reshape(n, q, p) * consts["tw_m"].T[None]
    b = np.empty(n * m, complex)
    ni, qi, ki = np.meshgrid(np.arange(n), np.arange(q), np.arange(p),
                             indexing="ij")
    b[ni * m + ki * q + qi] = c1
    # F2: rows (n, k1), depth q, cols k2; X[n*m + q2*r + s] at bin k.
    c2 = (b.reshape(n * p, q) @ consts["w_q"]).reshape(n, p, q)
    ni, ki, k2 = np.meshgrid(np.arange(n), np.arange(p), np.arange(q),
                             indexing="ij")
    k = k2 * p + ki
    if not pl["absorbed"]:
        # Read as float2 in natural order (ratio 1: G1 then G2).
        w = bundle.weights.numpy().reshape(-1, 2)
        c2 = c2 * (w[:, 0] + 1j * w[:, 1])[k]
    x = np.empty(n * m, complex)
    x[ni * m + (k % q2) * r + k // q2] = c2
    # I1: batch q2, rows n, depth s, cols k1'; C[n, q2, k1']. At ratio 1
    # the loader sums X[n, q2, s] and X[n, q2, s + P2] (bins k and k + h).
    xs = x.reshape(n, q2, r)
    if pl["halves"]:
        xs = xs[..., :p2] + xs[..., p2:]
    assert xs.shape[-1] == pl["depth_i1"]
    if pl["absorbed"]:
        w = bundle.weights.numpy()
        c3 = np.einsum("nqs,qsk->qnk", xs, w[..., 0] + 1j * w[..., 1])
    else:
        c3 = (np.einsum("nqs,sk->qnk", xs, consts["w_p2"])
              * consts["tw_h"].T[:, None, :])
    c = c3.transpose(1, 0, 2).reshape(-1)  # stored [n, q2, k1']
    # I2: rows (n, k1'), depth q2 (read c[(n*Q2 + q2)*P2 + k1']), kept
    # cols; out[n, 2(j - j0) + e].
    ni, ki, qi = np.meshgrid(np.arange(n), np.arange(p2), np.arange(q2),
                             indexing="ij")
    a2 = c[(ni * q2 + qi) * p2 + ki].reshape(n * p2, q2)
    z = (a2 @ consts["w2"]).reshape(n, p2, pl["kept"])
    out = np.full((n, pl["block"]), np.nan)
    ni, ki, col = np.meshgrid(np.arange(n), np.arange(p2),
                              np.arange(pl["kept"]), indexing="ij")
    j = (pl["k2_0"] + col) * p2 + ki - pl["j0"]
    keep = j >= 0
    out[ni[keep], 2 * j[keep]] = z[keep].real
    out[ni[keep], 2 * j[keep] + 1] = z[keep].imag
    return out


@pytest.mark.parametrize("taps,fft,ratio", PALLAS_GEOMETRIES)
def test_cpu_wrapper_matches_pallas_interpret(rng, taps, fft, ratio):
    jcfg, tcfg = _cfgs(taps, fft, ratio)
    h = rng.normal(size=taps)
    x = rng.normal(size=(2, tcfg.halo_in + 3 * tcfg.block_in)).astype(
        np.float32)
    spec = jos.filter_spectrum(h, fft)
    ref = np.asarray(jax_fused(jnp.asarray(x), spec, jcfg, interpret=True))
    bundle, _ = from_jax(spec, tcfg)
    before = ff.LAUNCHES
    y = ff.fused_upsample_blocks(torch.from_numpy(x), bundle, tcfg).numpy()
    assert ff.LAUNCHES == before  # the CPU path launches no kernel
    assert y.shape == ref.shape
    assert _rel(y, ref) < 1e-5


@pytest.mark.parametrize("taps,fft,ratio", KERNEL_GEOMETRIES)
def test_kernel_algebra_replay_matches_plain(rng, taps, fft, ratio):
    _, cfg = _cfgs(taps, fft, ratio)
    bundle = tos.fold_bundle(tos.filter_spectrum(rng.normal(size=taps), fft),
                             cfg)
    frames = rng.normal(size=(3, cfg.frame_in)).astype(np.float32)
    ref = tos.upsample_frames(torch.from_numpy(frames), bundle, cfg).numpy()
    got = emulate_kernel(frames.astype(np.float64), bundle, cfg)
    assert not np.isnan(got).any(), "an output sample was never written"
    assert _rel(got, ref) < 1e-5


def test_kernel_algebra_replay_production_16x(rng):
    """The production geometry's index maps (m = 8192, h = 65536) on one
    frame of the bundled filter's size."""
    _, cfg = _cfgs(80001, 131072, 16)
    h = rng.normal(size=80001) * np.exp(-np.arange(80001) / 8000.0)
    bundle = tos.fold_bundle(tos.filter_spectrum(h, cfg.fft_size), cfg)
    frames = rng.normal(size=(1, cfg.frame_in)).astype(np.float32)
    ref = tos.upsample_frames(torch.from_numpy(frames), bundle, cfg).numpy()
    got = emulate_kernel(frames.astype(np.float64), bundle, cfg)
    assert not np.isnan(got).any()
    assert _rel(got, ref) < 1e-5


def test_every_shipped_sidecar_is_in_the_kernel_envelope():
    paths = sorted(glob.glob(os.path.join(REPO, "data", "coefficients",
                                          "filter_*.json")))
    assert len(paths) == 32
    for path in paths:
        with open(path) as f:
            meta = json.load(f)
        cfg = tos.OverlapSaveConfig(meta["taps"], meta["fft_size"],
                                    meta["block_size"],
                                    meta["upsample_factor"])
        plan = ff.kernel_plan(cfg)
        assert plan["absorbed"] == (cfg.ratio >= 4), path
        assert plan["kept"] * plan["P2"] >= cfg.block_size // 2, path


@pytest.mark.parametrize("taps,fft", [(130, 1024), (1024, 4096)])
def test_kernel_refuses_odd_overlap(taps, fft):
    """An even tap count (odd overlap, ratio 1 only) runs the classic
    program, never the kernel, as in the JAX package."""
    _, cfg = _cfgs(taps, fft, 1)
    with pytest.raises(NotImplementedError, match="odd overlap"):
        ff.kernel_plan(cfg)


def test_ratio_one_plan_reads_both_halves():
    _, cfg = _cfgs(1025, 4096, 1)
    pl = ff.kernel_plan(cfg)
    assert pl["halves"] and not pl["absorbed"]
    assert (pl["P2"], pl["Q2"], pl["r"], pl["depth_i1"]) == (64, 32, 128, 64)
    assert ff.flops_per_launch(cfg)["I1"] == 8 * 2048 * 64


def test_flops_per_output_sample_production_16x():
    _, cfg = _cfgs(80001, 131072, 16)
    per_sample = ff.flops_per_frame(cfg) / cfg.block_size
    assert int(per_sample) == 1334  # the absorbed form's own count


def test_build_targets_sm90a():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert (_build.CSRC / "fused_frames.cu").exists()


def test_build_root_env_override_and_checkout_default(monkeypatch, tmp_path):
    monkeypatch.setenv("TOTTON_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.build_root() == tmp_path
    monkeypatch.delenv("TOTTON_TORCH_BUILD_DIR")
    assert str(_build.build_root()) == os.path.realpath(
        os.path.join(REPO, "build", "totton_tpu_torch"))


def test_flops_per_launch_sum_to_frame():
    _, cfg = _cfgs(80001, 131072, 16)
    per_launch = ff.flops_per_launch(cfg)
    assert sorted(per_launch) == ["F1", "F2", "I1", "I2"]
    assert sum(per_launch.values()) == ff.flops_per_frame(cfg)


# Frame counts the main path hands the kernel: a full 512-block stereo
# dispatch (1024), the ragged 32/8/1-block tail dispatches (64, 16, 2), one
# off every tile edge (18), and a round count (128).
CUDA_FRAME_COUNTS = [2, 16, 18, 64, 128, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("n_frames", CUDA_FRAME_COUNTS)
@pytest.mark.parametrize("name", ["filter_44k_16x_80000_min_phase",
                                  "filter_44k_2x_80000_min_phase",
                                  "filter_44k_16x_8000_min_phase",
                                  "ratio1_1025_4096"])
def test_cuda_kernel_matches_plain(name, n_frames):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    from totton_tpu.filters.sidecar import load_filter

    rng = np.random.default_rng(0)
    if name.startswith("ratio1"):
        # The CLI's ratio-1 geometry with a seeded filter.
        _, cfg = _cfgs(1025, 4096, 1)
        taps = rng.normal(size=1025) * np.exp(-np.arange(1025) / 100.0)
    else:
        lf = load_filter(os.path.join(REPO, "data", "coefficients",
                                      name + ".json"))
        cfg = tos.OverlapSaveConfig.from_sidecar(lf.sidecar)
        taps = lf.taps
    dev = torch.device("cuda")
    bundle = tos.fold_bundle(
        tos.filter_spectrum(taps, cfg.fft_size, device=dev), cfg)
    frames = torch.from_numpy(
        (rng.normal(size=(n_frames, cfg.frame_in)) * 0.3).astype(np.float32)
    ).to(dev)
    before = ff.LAUNCHES
    y = ff.fused_upsample_frames(frames, bundle, cfg)
    ref = tos.upsample_frames(frames, bundle, cfg)
    torch.cuda.synchronize()
    assert ff.LAUNCHES == before + 1
    assert torch.isfinite(y).all().item()
    assert _rel(y.cpu().numpy(), ref.cpu().numpy()) < 1e-5
