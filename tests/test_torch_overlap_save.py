"""Port parity: totton_tpu_torch.ops.overlap_save against the JAX package's
overlap_save and the float64 direct-convolution oracle, on the CPU.

Inputs come from numpy with a seed and go through both packages; the JAX
side runs as tests/test_overlap_save.py runs it."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from totton_tpu.ops import overlap_save as jos
from totton_tpu_torch.convert import from_jax
from totton_tpu_torch.ops import overlap_save as tos

torch.set_num_threads(2)


def oracle_upsample(x: np.ndarray, h: np.ndarray, ratio: int) -> np.ndarray:
    """Direct zero-stuff + convolution oracle in float64."""
    up = np.zeros(len(x) * ratio)
    up[::ratio] = x
    return np.convolve(up, np.asarray(h, dtype=np.float64))[: len(up)]


def rel_err(y, ref):
    return np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30)


def _cfgs(taps, fft, ratio):
    kw = dict(taps=taps, fft_size=fft, block_size=fft - (taps - 1),
              ratio=ratio)
    return jos.OverlapSaveConfig(**kw), tos.OverlapSaveConfig(**kw)


def _both(rng, taps, fft, ratio, blocks=5, decay=False):
    """Same seeded input through JAX upsample_blocks and the port's."""
    jcfg, tcfg = _cfgs(taps, fft, ratio)
    h = rng.normal(size=taps)
    if decay:
        h = h * np.exp(-np.arange(taps) * 4.0 / taps)
    x = rng.normal(size=(2, blocks * tcfg.block_in)).astype(np.float32)
    xin = np.concatenate([np.zeros((2, tcfg.halo_in), np.float32), x], -1)
    jspec = jos.filter_spectrum(h, fft)
    ref_jax = np.asarray(jos.upsample_blocks(jnp.asarray(xin), jspec, jcfg))
    bundle, _ = from_jax(jspec, tcfg)
    y = tos.upsample_blocks(torch.from_numpy(xin), bundle, tcfg).numpy()
    oracle = np.stack([oracle_upsample(x[c], h, ratio) for c in range(2)])
    return y, ref_jax, oracle, tcfg


@pytest.mark.parametrize("kw", [
    dict(taps=100, fft_size=256, block_size=100, ratio=1),
    dict(taps=100, fft_size=300, block_size=201, ratio=1),
    dict(taps=97, fft_size=128, block_size=32, ratio=3),
    dict(taps=97, fft_size=128, block_size=32, ratio=64),
])
def test_config_invariants_match_jax(kw):
    with pytest.raises(ValueError) as jerr:
        jos.OverlapSaveConfig(**kw)
    with pytest.raises(ValueError) as terr:
        tos.OverlapSaveConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_bundled_geometry_properties():
    jcfg, tcfg = _cfgs(80001, 131072, 16)
    for name in ("overlap", "frame_in", "block_in", "halo_in", "n_bins"):
        assert getattr(tcfg, name) == getattr(jcfg, name)
    assert tos.absorbed_plan(tcfg) == (512, 128, 64, 8)


@pytest.mark.parametrize("n_blocks,block_in,halo_in", [(5, 8, 20), (4, 3, 10)])
def test_frame_input_exactly_equal(rng, n_blocks, block_in, halo_in):
    x = rng.normal(size=(3, n_blocks * block_in + halo_in)).astype(np.float32)
    ref = np.asarray(jos.frame_input(jnp.asarray(x), block_in, halo_in))
    got = tos.frame_input(torch.from_numpy(x), block_in, halo_in).numpy()
    np.testing.assert_array_equal(got, ref)


def test_frame_input_bad_length_rejected():
    with pytest.raises(ValueError, match="multiple"):
        tos.frame_input(torch.zeros((1, 25)), block_in=8, halo_in=2)


@pytest.mark.parametrize("with_eq", [False, True])
def test_filter_spectrum_exactly_equal(rng, with_eq):
    h = rng.normal(size=257)
    eq = rng.uniform(0.5, 2.0, size=1025) if with_eq else None
    jr, ji = jos.filter_spectrum(h, 2048, eq)
    tr, ti = tos.filter_spectrum(h, 2048, eq)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_zero_stuff_equal(rng):
    x = rng.normal(size=(2, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tos.zero_stuff(torch.from_numpy(x), 4).numpy(),
        np.asarray(jos.zero_stuff(jnp.asarray(x), 4)))


@pytest.mark.parametrize(
    "taps,fft,ratio",
    [(5, 64, 1), (9, 64, 2), (17, 64, 4), (33, 128, 8), (33, 128, 16),
     (257, 2048, 2)],
)
def test_upsample_blocks_matches_jax_and_oracle(rng, taps, fft, ratio):
    y, ref_jax, oracle, _ = _both(rng, taps, fft, ratio)
    assert y.shape == ref_jax.shape
    assert rel_err(y, ref_jax) < 1e-5
    assert rel_err(y, oracle) < 1e-5


@pytest.mark.parametrize("taps,fft,ratio", [
    (1025, 8192, 4), (2001, 16384, 8), (4097, 16384, 16),
])
def test_absorbed_matches_jax_and_oracle(rng, taps, fft, ratio):
    _, tcfg = _cfgs(taps, fft, ratio)
    assert tos.absorbed_plan(tcfg) is not None
    y, ref_jax, oracle, _ = _both(rng, taps, fft, ratio, decay=True)
    assert rel_err(y, ref_jax) < 1e-4
    assert rel_err(y, oracle) < 1e-4


def test_block_step_streaming_matches_single_shot(rng):
    _, cfg = _cfgs(4097, 16384, 16)
    h = rng.normal(size=cfg.taps) * np.exp(-np.arange(cfg.taps) * 4.0
                                           / cfg.taps)
    bundle = tos.fold_bundle(tos.filter_spectrum(h, cfg.fft_size), cfg)
    x = rng.normal(size=(2, 6 * cfg.block_in)).astype(np.float32)
    xin = np.concatenate([np.zeros((2, cfg.halo_in), np.float32), x], -1)
    whole = tos.upsample_blocks(torch.from_numpy(xin), bundle, cfg).numpy()
    step = tos.make_block_step(cfg)
    tail = torch.zeros((2, cfg.halo_in))
    parts = []
    for lo, hi in [(0, 1), (1, 3), (3, 6)]:
        chunk = torch.from_numpy(x[:, lo * cfg.block_in: hi * cfg.block_in])
        y, tail = step(tail, chunk, bundle)
        parts.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(parts, -1), whole,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tail.numpy(), x[:, -cfg.halo_in:])


def test_odd_overlap_not_ported():
    """Odd overlap is not ported to the frame kernel: its bundle is the
    classic program's (the spectrum itself) and kernel_plan refuses it."""
    from totton_tpu_torch.ops import fused_frames as ff

    _, cfg = _cfgs(130, 1024, 1)
    spec = tos.filter_spectrum(np.arange(130.0), 1024)
    bundle = tos.fold_bundle(spec, cfg)
    assert bundle.classic and not bundle.absorbed
    np.testing.assert_array_equal(bundle.weights[:, 0].numpy(),
                                  spec[0].numpy())
    np.testing.assert_array_equal(bundle.weights[:, 1].numpy(),
                                  spec[1].numpy())
    with pytest.raises(NotImplementedError, match="odd overlap"):
        ff.kernel_plan(cfg)


@pytest.mark.parametrize("taps,fft", [(130, 1024), (6, 64), (1024, 4096)])
def test_classic_program_matches_jax_and_oracle(rng, taps, fft):
    """Odd overlap (even tap count, ratio 1): the classic rfft/irfft
    program against JAX upsample_blocks (which routes there too) and the
    float64 oracle; rel < 1e-5."""
    y, ref_jax, oracle, cfg = _both(rng, taps, fft, 1)
    assert cfg.overlap % 2 == 1
    assert y.shape == ref_jax.shape
    assert rel_err(y, ref_jax) < 1e-5
    assert rel_err(y, oracle) < 1e-5


@pytest.mark.parametrize("ratio", [1, 2, 8])
def test_periodic_rfft_extend_equal(rng, ratio):
    sr = rng.normal(size=(2, 9)).astype(np.float32)
    si = rng.normal(size=(2, 9)).astype(np.float32)
    jr, ji = jos._periodic_rfft_extend(jnp.asarray(sr), jnp.asarray(si),
                                       ratio)
    tr, ti = tos._periodic_rfft_extend(torch.from_numpy(sr),
                                       torch.from_numpy(si), ratio)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_block_step_streams_odd_overlap(rng):
    """make_block_step routes an odd overlap to the classic program:
    streamed steps equal JAX's streaming step on the same chunks and the
    single-shot plain output (rel < 1e-5), and the tail carries on."""
    jcfg, cfg = _cfgs(130, 1024, 1)
    h = rng.normal(size=cfg.taps)
    jspec = jos.filter_spectrum(h, cfg.fft_size)
    bundle, _ = from_jax(jspec, cfg)
    x = rng.normal(size=(2, 5 * cfg.block_in)).astype(np.float32)
    xin = np.concatenate([np.zeros((2, cfg.halo_in), np.float32), x], -1)
    whole = tos.upsample_blocks(torch.from_numpy(xin), bundle, cfg).numpy()
    step, jstep = tos.make_block_step(cfg), jos.make_block_step(jcfg)
    tail = torch.zeros((2, cfg.halo_in))
    jtail = jnp.zeros((2, cfg.halo_in), jnp.float32)
    parts, jparts = [], []
    for lo, hi in [(0, 2), (2, 3), (3, 5)]:
        chunk = x[:, lo * cfg.block_in: hi * cfg.block_in]
        y, tail = step(tail, torch.from_numpy(chunk), bundle)
        jy, jtail = jstep(jtail, jnp.asarray(chunk), jspec)
        parts.append(y.numpy())
        jparts.append(np.asarray(jy))
    got = np.concatenate(parts, -1)
    assert rel_err(got, np.concatenate(jparts, -1)) < 1e-5
    assert rel_err(got, whole) < 1e-5
    np.testing.assert_array_equal(tail.numpy(), x[:, -cfg.halo_in:])


def test_from_jax_carries_tail_and_checks_shapes(rng):
    jcfg, tcfg = _cfgs(257, 2048, 4)
    spec = jos.filter_spectrum(rng.normal(size=257), 2048)
    tail = rng.normal(size=(2, tcfg.halo_in)).astype(np.float32)
    bundle, t = from_jax(spec, tcfg, tail)
    np.testing.assert_array_equal(t.numpy(), tail)
    assert bundle.absorbed
    with pytest.raises(ValueError, match="tail"):
        from_jax(spec, tcfg, tail[:, 1:])
