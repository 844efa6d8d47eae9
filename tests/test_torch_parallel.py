"""The port's sharded engine (totton_tpu_torch.parallel) against the JAX
package's, on the CPU: a case-by-case twin of tests/test_parallel.py. The
JAX side runs on conftest's 8 virtual CPU devices, the port's mesh over
[cpu] * k, both on the same seeded numpy inputs and the same filter
files. Sharded output agrees with JAX's sharded output at the reference
suite's tolerance (rtol 1e-5, atol 1e-6); a 1x1 mesh equals the port's
plain engine bit for bit; device PCM is bit-exact against the host
quantizer on the engine's own float output."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from totton_tpu.filters.sidecar import load_filter as jax_load_filter
from totton_tpu.parallel import ShardedUpsampler as JaxSharded
from totton_tpu.parallel import make_mesh as jax_make_mesh
from totton_tpu.parallel import sharded_upsample as jax_sharded_upsample
from totton_tpu_torch.engine.upsampler import StreamingUpsampler
from totton_tpu_torch.filters.sidecar import FilterSidecar, LoadedFilter
from totton_tpu_torch.filters.sidecar import load_filter
from totton_tpu_torch.io.pcm import PcmFormat, quantize_s16_host
from totton_tpu_torch.parallel import (
    Mesh,
    ShardedUpsampler,
    make_mesh,
    sharded_upsample,
)
from totton_tpu_torch.parallel.sharded import SWAP_MARGIN_STEPS, _check_shapes

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
CPU = torch.device("cpu")


def _mesh(n_channel=None, n_time=None, k=8):
    return make_mesh(n_channel=n_channel, n_time=n_time, devices=[CPU] * k)


@pytest.fixture(scope="module")
def filter_path(tmp_path_factory):
    from totton_tpu.filters.generate import generate_one

    out = tmp_path_factory.mktemp("torch_par_coeff")
    # fft_size 4096 >> taps gives block_in 774 with halo_in 250, a healthy
    # block/halo ratio at test scale (tests/test_parallel.py's filter).
    r = generate_one("44k_4x", 1000, 25.0, 140.0, "minimum", str(out),
                     fft_size=4096)
    return r["json_path"]


@pytest.fixture(scope="module")
def lf(filter_path):
    return load_filter(filter_path)


@pytest.fixture(scope="module")
def jlf(filter_path):
    return jax_load_filter(filter_path)


def _granule(eng, per_shard_cols=4):
    per_step = eng.step_input_frames
    while (per_step // per_shard_cols) < eng.config.halo_in:
        per_step *= 2
    return per_step


def test_mesh_without_cuda_needs_explicit_devices(monkeypatch):
    """The port's counterpart of the reference's device check: the default
    devices are CUDA cards, and without one make_mesh raises instead of
    falling back to the CPU; a CUDA device in an explicit list raises
    too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(devices=["cuda:0"])


class TestMesh:
    def test_default_all_time(self):
        mesh = _mesh()
        assert mesh.shape == dict(jax_make_mesh().shape) == {
            "channel": 1, "time": 8}

    def test_2d(self):
        mesh = _mesh(n_channel=2)
        assert mesh.shape == dict(jax_make_mesh(n_channel=2).shape) == {
            "channel": 2, "time": 4}
        assert mesh.devices() == [CPU] * 8
        assert {mesh.rank(r, t) for r in range(2) for t in range(4)} == {0}

    def test_bad_split(self):
        with pytest.raises(ValueError, match="cover") as e:
            _mesh(n_channel=3, n_time=3)
        with pytest.raises(ValueError) as ej:
            jax_make_mesh(n_channel=3, n_time=3)
        assert str(e.value) == str(ej.value)

    def test_one_card_does_not_cover_two(self, monkeypatch):
        """On a one-card machine the default mesh has one device: a 1x2
        mesh fails with the JAX message for one device; nothing repeats the
        card unless the caller's list does."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError) as e:
            make_mesh(n_channel=1, n_time=2)
        with pytest.raises(ValueError) as ej:
            jax_make_mesh(n_channel=1, n_time=2, devices=jax.devices()[:1])
        assert str(e.value) == str(ej.value) == (
            "mesh 1x2 does not cover 1 devices")
        cuda0 = torch.device("cuda", 0)
        mesh = make_mesh(n_time=2, devices=[cuda0, cuda0])
        assert mesh.devices() == [cuda0, cuda0]

    def test_ragged_grid_rejected(self):
        with pytest.raises(ValueError, match="rectangular"):
            Mesh([[(0, CPU), (0, CPU)], [(0, CPU)]])


class TestShardedUpsample:
    @pytest.mark.parametrize("n_channel,n_time",
                             [(1, 8), (2, 4), (4, 2), (8, 1)])
    def test_matches_single_device(self, lf, jlf, rng, n_channel, n_time):
        channels = 8
        # Enough blocks that every time shard holds >= halo_in samples.
        t = 8 * lf.sidecar.block_input_frames * n_time
        x = (rng.normal(size=(channels, t)) * 0.3).astype(np.float32)

        y = sharded_upsample(x, lf, _mesh(n_channel, n_time))
        y_jax = jax_sharded_upsample(x, jlf, jax_make_mesh(n_channel, n_time))
        np.testing.assert_allclose(y, y_jax, rtol=RTOL, atol=ATOL)
        plain = StreamingUpsampler(lf, channels=channels, device="cpu")
        np.testing.assert_allclose(y, plain.process_block(x), rtol=RTOL,
                                   atol=ATOL)

    def test_shard_too_small_rejected(self):
        # Production 16x geometry: halo_in (5000) > block_in (3192), so one
        # block per time shard must be rejected, with the JAX message.
        from totton_tpu.ops.overlap_save import OverlapSaveConfig as JaxCfg
        from totton_tpu.parallel.sharded import _check_shapes as jax_check
        from totton_tpu_torch.ops.overlap_save import OverlapSaveConfig

        geometry = dict(taps=80001, fft_size=131072, block_size=51072,
                        ratio=16)
        cfg = OverlapSaveConfig(**geometry)
        with pytest.raises(ValueError, match="halo") as e:
            _check_shapes(cfg, _mesh(1, 8), channels=2, t=cfg.block_in * 8)
        with pytest.raises(ValueError) as ej:
            jax_check(JaxCfg(**geometry), jax_make_mesh(1, 8), channels=2,
                      t=cfg.block_in * 8)
        assert str(e.value) == str(ej.value)

    def test_non_divisible_rejected(self, lf, jlf):
        bad_t = lf.sidecar.block_input_frames * 8 + 1
        x = np.zeros((2, bad_t), np.float32)
        with pytest.raises(ValueError, match="shards") as e:
            sharded_upsample(x, lf, _mesh(1, 8))
        with pytest.raises(ValueError) as ej:
            jax_sharded_upsample(x, jlf, jax_make_mesh(1, 8))
        assert str(e.value) == str(ej.value)


class TestShardedStreaming:
    def test_streaming_continuity_across_steps(self, lf, jlf, rng):
        sharded = ShardedUpsampler(lf, _mesh(2, 4), channels=4)
        jsharded = JaxSharded(jlf, jax_make_mesh(2, 4), channels=4)
        per_step = sharded.step_input_frames * 4
        while (per_step // 4) < sharded.config.halo_in:
            per_step *= 2
        steps = 3
        x = (rng.normal(size=(4, steps * per_step)) * 0.3).astype(np.float32)
        chunks = [x[:, i * per_step:(i + 1) * per_step] for i in range(steps)]
        y = np.concatenate([sharded.process_block(c) for c in chunks], -1)
        y_jax = np.concatenate([jsharded.process_block(c) for c in chunks],
                               -1)
        np.testing.assert_allclose(y, y_jax, rtol=RTOL, atol=ATOL)
        plain = StreamingUpsampler(lf, channels=4, device="cpu")
        np.testing.assert_allclose(y, plain.process_block(x), rtol=RTOL,
                                   atol=ATOL)

    def test_rejected_swap_leaves_state_consistent(self, lf, rng):
        """A geometry-mismatched load_filter must not touch ANY state: a
        later set_eq folds from self._filter.taps."""
        sharded = ShardedUpsampler(lf, _mesh(1, 4, k=4), channels=2)
        x = (rng.normal(size=(2, _granule(sharded))) * 0.3).astype(
            np.float32)
        y_before = sharded.process_block(x)
        sharded.reset()
        bad = LoadedFilter(
            taps=np.zeros(501, np.float32),
            sidecar=dataclasses.replace(
                lf.sidecar, taps=501, fft_size=2048, block_size=2048 - 500),
        )
        with pytest.raises(ValueError, match="geometry"):
            sharded.load_filter(bad)
        assert sharded._filter is lf
        sharded.set_eq(np.ones(sharded.config.n_bins, np.float64))
        np.testing.assert_allclose(sharded.process_block(x), y_before,
                                   rtol=1e-6, atol=1e-7)

    def test_reset(self, lf, rng):
        sharded = ShardedUpsampler(lf, _mesh(1, 4, k=4), channels=2)
        x = (rng.normal(size=(2, _granule(sharded))) * 0.3).astype(
            np.float32)
        y1 = sharded.process_block(x)
        y2 = sharded.process_block(x)
        assert not np.array_equal(y1, y2)  # the carried tail mattered
        sharded.reset()
        np.testing.assert_array_equal(sharded.process_block(x), y1)


class TestShardedSwapFade:
    def test_faded_swap_matches_jax_and_single_device(self, lf, jlf, rng):
        fade = 256
        sharded = ShardedUpsampler(lf, _mesh(1, 4, k=4), channels=2,
                                   swap_fade_frames=fade)
        jsharded = JaxSharded(jlf, jax_make_mesh(1, 4, jax.devices()[:4]),
                              channels=2, swap_fade_frames=fade)
        single = StreamingUpsampler(lf, channels=2, swap_fade_frames=fade,
                                    device="cpu")
        step_in = sharded.block_input_frames
        x1 = rng.normal(size=(2, step_in)).astype(np.float32) * 0.3
        x2 = rng.normal(size=(2, step_in)).astype(np.float32) * 0.3
        ys = [sharded.process_block(x1)]
        yj = [jsharded.process_block(x1)]
        single.process_block(x1)
        eq = np.full(sharded.config.n_bins, 0.5, np.float64)
        for eng in (sharded, jsharded, single):
            eng.set_eq(eq)
        ys.append(sharded.process_block(x2))
        yj.append(jsharded.process_block(x2))
        for a, b in zip(ys, yj):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=ATOL)
        np.testing.assert_allclose(ys[1], single.process_block(x2),
                                   rtol=1e-4, atol=ATOL)
        # The fade happened: the first sample is far from the pure
        # new-bundle output.
        fresh = StreamingUpsampler(lf, channels=2, device="cpu")
        fresh.process_block(x1)
        fresh.set_eq(eq)
        y_new = fresh.process_block(x2)
        assert abs(ys[1][0, 0] - y_new[0, 0]) > abs(ys[1][0, 0]
                                                   - 2 * y_new[0, 0])

    def test_reset_clears_fade(self, lf, rng):
        mesh = _mesh(1, 4, k=4)
        sharded = ShardedUpsampler(lf, mesh, channels=2,
                                   swap_fade_frames=128)
        x = rng.normal(size=(2, sharded.block_input_frames)).astype(
            np.float32)
        sharded.process_block(x)
        sharded.set_eq(np.full(sharded.config.n_bins, 0.5))
        sharded.reset()
        ref = ShardedUpsampler(lf, mesh, channels=2)
        ref.set_eq(np.full(ref.config.n_bins, 0.5))
        np.testing.assert_allclose(sharded.process_block(x),
                                   ref.process_block(x), rtol=RTOL,
                                   atol=1e-7)


class TestShardedDevicePcm:
    """Device-PCM mode: each cell's output is quantized on its device and
    equals the host quantizer on the engine's own float output bit for
    bit; against JAX's sharded device PCM within one LSB."""

    def test_quantizes_sharded_stream_bit_exact(self, lf, jlf, rng):
        mesh = _mesh(2, 4)
        sharded = ShardedUpsampler(lf, mesh, channels=4,
                                   device_pcm=PcmFormat.S16_LE)
        sharded_f = ShardedUpsampler(lf, mesh, channels=4)
        x = (rng.normal(size=(4, _granule(sharded))) * 0.4).astype(
            np.float32)
        y = sharded.process_block(x)
        assert y.dtype == np.int16
        np.testing.assert_array_equal(
            y, quantize_s16_host(sharded_f.process_block(x)))
        from totton_tpu.io.pcm import PcmFormat as JaxPcm

        jsharded = JaxSharded(jlf, jax_make_mesh(2, 4), channels=4,
                              device_pcm=JaxPcm.S16_LE)
        diff = y.astype(np.int32) - jsharded.process_block(x).astype(np.int32)
        assert np.abs(diff).max() <= 1

    def test_faded_swap_stays_quantized(self, lf, rng):
        mesh = _mesh(1, 4, k=4)
        q = ShardedUpsampler(lf, mesh, channels=2, swap_fade_frames=128,
                             device_pcm=PcmFormat.S16_LE)
        f = ShardedUpsampler(lf, mesh, channels=2, swap_fade_frames=128)
        x = (rng.normal(size=(2, _granule(q))) * 0.3).astype(np.float32)
        for eng in (q, f):
            eng.process_block(x)
            eng.set_eq(None)  # arm the fade (identical spectrum)
        y_q = q.process_block(x)
        assert y_q.dtype == np.int16
        np.testing.assert_array_equal(y_q, quantize_s16_host(
            f.process_block(x)))

    def test_rejects_non_s16(self, lf):
        with pytest.raises(ValueError, match="S16_LE only"):
            ShardedUpsampler(lf, _mesh(1, 4, k=4), channels=2,
                             device_pcm=PcmFormat.S32_LE)


class TestShardedFadeCarry:
    def test_fade_longer_than_step_carries(self, lf, jlf, rng):
        """A fade longer than one step's output continues its ramp on the
        next step (the plain engine's carry), as in the JAX engine."""
        mesh = _mesh(1, 4, k=4)
        per_step = ShardedUpsampler(lf, mesh, channels=2).step_input_frames
        while (per_step // 4) < lf.sidecar.taps:  # cover halo comfortably
            per_step *= 2
        out_per_step = per_step * 4  # ratio 4
        fade = out_per_step + out_per_step // 2  # spills into step 2
        sharded = ShardedUpsampler(lf, mesh, channels=2,
                                   swap_fade_frames=fade)
        jsharded = JaxSharded(jlf, jax_make_mesh(1, 4, jax.devices()[:4]),
                              channels=2, swap_fade_frames=fade)
        plain = StreamingUpsampler(lf, channels=2, swap_fade_frames=fade,
                                   device="cpu")
        x = (rng.normal(size=(2, 3 * per_step)) * 0.3).astype(np.float32)
        n_bins = lf.sidecar.fft_size // 2 + 1
        eq = np.linspace(1.0, 0.5, n_bins).astype(np.float64)
        outs = []
        for eng in (sharded, jsharded, plain):
            eng.process_block(x[:, :per_step])
            eng.set_eq(eq)
            outs.append(np.concatenate(
                [eng.process_block(x[:, per_step:2 * per_step]),
                 eng.process_block(x[:, 2 * per_step:])], axis=1))
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(outs[0], outs[2], rtol=1e-4, atol=1e-5)
        assert sharded._fade_from is None  # fade completed and cleared


class TestScheduledSwap:
    """Step-synchronized hot swap (schedule_swap): the swap lands at an
    exact step boundary with the crossfade armed there."""

    def test_applies_at_exact_step(self, lf, jlf, rng):
        sharded = ShardedUpsampler(lf, _mesh(2, 2, k=4), channels=2)
        jsharded = JaxSharded(jlf, jax_make_mesh(2, 2, jax.devices()[:4]),
                              channels=2)
        step_in = sharded.block_input_frames
        xs = [rng.normal(size=(2, step_in)).astype(np.float32) * 0.3
              for _ in range(5)]
        eq = np.full(sharded.config.n_bins, 0.5, np.float64)
        assert sharded.schedule_swap(eq_response=eq, apply_at_step=3) == 3
        jsharded.schedule_swap(eq_response=eq, apply_at_step=3)
        got = [sharded.process_block(x) for x in xs]
        want = [jsharded.process_block(x) for x in xs]
        ref_eng = ShardedUpsampler(lf, _mesh(2, 2, k=4), channels=2)
        ref = [ref_eng.process_block(x) for x in xs[:3]]
        ref_eng.set_eq(eq)
        ref += [ref_eng.process_block(x) for x in xs[3:]]
        for g, w, r in zip(got, want, ref):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=1e-7)
        assert sharded.swap_deadline_misses == 0
        assert sharded.step_index == jsharded.step_index == 5

    def test_scheduled_swap_fades_at_boundary(self, lf, rng):
        fade = 256
        sharded = ShardedUpsampler(lf, _mesh(1, 4, k=4), channels=2,
                                   swap_fade_frames=fade)
        single = StreamingUpsampler(lf, channels=2, swap_fade_frames=fade,
                                    device="cpu")
        step_in = sharded.block_input_frames
        xs = [rng.normal(size=(2, step_in)).astype(np.float32) * 0.3
              for _ in range(3)]
        eq = np.full(sharded.config.n_bins, 0.5, np.float64)
        sharded.schedule_swap(eq_response=eq, apply_at_step=2)
        for x in xs[:2]:
            np.testing.assert_allclose(sharded.process_block(x),
                                       single.process_block(x),
                                       rtol=RTOL, atol=1e-7)
        single.set_eq(eq)  # immediate on the single engine = boundary 2
        np.testing.assert_allclose(sharded.process_block(xs[2]),
                                   single.process_block(xs[2]),
                                   rtol=1e-4, atol=ATOL)

    def test_default_margin_stamps_future_step(self, lf, rng):
        from totton_tpu.parallel.sharded import SWAP_MARGIN_STEPS as JAX_M

        sharded = ShardedUpsampler(lf, _mesh(1, 2, k=2), channels=2)
        x = rng.normal(size=(2, sharded.block_input_frames)).astype(
            np.float32)
        sharded.process_block(x)
        at = sharded.schedule_swap(
            eq_response=np.full(sharded.config.n_bins, 0.5))
        assert at == 1 + SWAP_MARGIN_STEPS == 1 + JAX_M

    def test_deadline_miss_applies_late_and_counts(self, lf, rng, capsys):
        mesh = _mesh(1, 2, k=2)
        sharded = ShardedUpsampler(lf, mesh, channels=2)
        x = rng.normal(size=(2, sharded.block_input_frames)).astype(
            np.float32) * 0.3
        for _ in range(4):
            sharded.process_block(x)
        eq = np.full(sharded.config.n_bins, 0.5, np.float64)
        sharded.schedule_swap(eq_response=eq, apply_at_step=2)  # passed
        y = sharded.process_block(x)
        assert sharded.swap_deadline_misses == 1
        assert "missed its step deadline" in capsys.readouterr().err
        ref = ShardedUpsampler(lf, mesh, channels=2, eq_response=eq)
        for _ in range(4):
            ref.process_block(x)
        np.testing.assert_allclose(y, ref.process_block(x), rtol=RTOL,
                                   atol=1e-7)

    def test_deadline_miss_bounded_divergence_across_processes(self, lf,
                                                               rng):
        """A follower whose fan-out arrives one step late diverges for
        exactly one step and re-converges sample-exactly the next."""
        mesh = _mesh(1, 2, k=2)
        leader = ShardedUpsampler(lf, mesh, channels=2)
        follower = ShardedUpsampler(lf, mesh, channels=2)
        xs = [rng.normal(size=(2, leader.block_input_frames)).astype(
            np.float32) * 0.3 for _ in range(5)]
        eq = np.full(leader.config.n_bins, 0.5, np.float64)
        leader_out = [leader.process_block(x) for x in xs[:3]]
        leader.schedule_swap(eq_response=eq, apply_at_step=3)
        leader_out += [leader.process_block(x) for x in xs[3:]]
        follower_out = [follower.process_block(x) for x in xs[:4]]
        follower.schedule_swap(eq_response=eq, apply_at_step=3)
        follower_out += [follower.process_block(x) for x in xs[4:]]
        assert (leader.swap_deadline_misses,
                follower.swap_deadline_misses) == (0, 1)
        for i in (0, 1, 2):
            np.testing.assert_array_equal(leader_out[i], follower_out[i])
        assert not np.allclose(leader_out[3], follower_out[3])
        np.testing.assert_array_equal(leader_out[4], follower_out[4])

    def test_newer_schedule_replaces_pending(self, lf, rng):
        mesh = _mesh(1, 2, k=2)
        sharded = ShardedUpsampler(lf, mesh, channels=2)
        x = rng.normal(size=(2, sharded.block_input_frames)).astype(
            np.float32) * 0.3
        sharded.schedule_swap(
            eq_response=np.full(sharded.config.n_bins, 0.25),
            apply_at_step=1)
        eq = np.full(sharded.config.n_bins, 0.5, np.float64)
        sharded.schedule_swap(eq_response=eq, apply_at_step=1)
        sharded.process_block(x)
        y = sharded.process_block(x)
        ref = ShardedUpsampler(lf, mesh, channels=2)
        ref.process_block(x)
        ref.set_eq(eq)
        np.testing.assert_allclose(y, ref.process_block(x), rtol=RTOL,
                                   atol=1e-7)

    def test_geometry_mismatch_rejected(self, lf):
        sharded = ShardedUpsampler(lf, _mesh(1, 2, k=2), channels=2)
        other = LoadedFilter(
            taps=np.zeros(17, np.float32),
            sidecar=FilterSidecar(coefficients_bin="<x>", taps=17,
                                  fft_size=64, block_size=48,
                                  upsample_factor=4))
        with pytest.raises(ValueError, match="geometry"):
            sharded.schedule_swap(filt=other)


def test_single_device_mesh_exactly_equals_plain_engine(lf, jlf, rng):
    """A 1x1 mesh is one cell running make_block_step on the tail and the
    whole input: bit-identical to the port's StreamingUpsampler, carried
    state and crossfade included; and within the reference tolerance of
    JAX's 1x1 mesh."""
    fade = 128
    sharded = ShardedUpsampler(lf, _mesh(1, 1, k=1), channels=2,
                               swap_fade_frames=fade)
    plain = StreamingUpsampler(lf, channels=2, swap_fade_frames=fade,
                               device="cpu")
    jsharded = JaxSharded(jlf, jax_make_mesh(1, 1, jax.devices()[:1]),
                          channels=2, swap_fade_frames=fade)
    xs = [(rng.normal(size=(2, sharded.block_input_frames)) * 0.3).astype(
        np.float32) for _ in range(3)]
    eq = np.full(sharded.config.n_bins, 0.5, np.float64)
    for i, x in enumerate(xs):
        if i == 1:
            for eng in (sharded, plain, jsharded):
                eng.set_eq(eq)
        y = sharded.process_block(x)
        np.testing.assert_array_equal(y, plain.process_block(x))
        np.testing.assert_allclose(y, jsharded.process_block(x),
                                   rtol=1e-4, atol=ATOL)


def test_local_channel_count_single_process(lf):
    mesh = _mesh(4, 2)
    assert ShardedUpsampler.local_channel_count(mesh, 8) == 8
    with pytest.raises(ValueError, match="not divisible"):
        ShardedUpsampler.local_channel_count(mesh, 6)
    eng = ShardedUpsampler(lf, mesh, channels=8)
    assert eng.local_channels == 8
    assert eng.local_block_input_frames == eng.block_input_frames
    assert eng.set_dither(True) is False


class _DictStore:
    """The two calls of a TCPStore the card check makes."""

    def __init__(self, preset):
        self.values = dict(preset)

    def set(self, key, value):
        self.values[key] = value.encode() if isinstance(value, str) else value

    def get(self, key):
        return self.values[key]


@pytest.mark.parametrize("other_card,refused", [("GPU-b", False),
                                                ("GPU-a", True)])
def test_nccl_ranks_sharing_a_card_are_refused(monkeypatch, other_card,
                                               refused):
    """initialize_distributed compares the NCCL ranks' cards through the
    group's store before NCCL starts: two ranks on one card raise, naming
    backend="gloo"; it never switches backend itself."""
    import socket
    import types

    from totton_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(uuid="GPU-a"))
    store = _DictStore({"totton/cards/1":
                        f"{socket.gethostname()}|{other_card}".encode()})
    if refused:
        with pytest.raises(RuntimeError, match='backend="gloo"'):
            distributed._refuse_shared_cards(store, 2, 0)
    else:
        distributed._refuse_shared_cards(store, 2, 0)


def test_initialize_distributed_without_an_address_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    from totton_tpu_torch.parallel import initialize_distributed

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    initialize_distributed()
    assert not dist.is_initialized()
