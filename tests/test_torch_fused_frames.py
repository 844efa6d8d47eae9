"""The port's frame kernel wrapper (totton_tpu_torch.ops.fused_frames).

On the CPU the wrapper runs the plain version: it is checked against the
JAX Pallas kernel in interpret mode on tests/test_pallas.py's geometries.
The CUDA kernel cannot run on the card here, so its plan — the
kernel_plan splits, the loaders' and stores' index maps, the resident
plan's half spectrum, the twiddle tables, the pruned columns and the
interleaved store of csrc/fused_frames.cu — is replayed in torch (each
short transform by a DFT, the resident plan's whole-frame transforms by
torch.fft in float64) and held against the plain version, and its
Stockham pass sequence is replayed in numpy with the kernel's own twiddle
tables and held against numpy's FFT. The kernel source itself runs on the
CPU in tests/test_torch_fused_frames_source.py; it is compared with the
plain version on the card by tests/test_torch_cuda.py (and by
chip_smoke.py).
"""

import glob
import json
import math
import os

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from totton_tpu.experimental.pallas_kernels import fused_upsample_blocks as jax_fused
from totton_tpu.ops import overlap_save as jos
from totton_tpu_torch.convert import from_jax
from totton_tpu_torch.ops import _build
from totton_tpu_torch.ops import fused_frames as ff
from totton_tpu_torch.ops import overlap_save as tos

torch.set_num_threads(2)

# Every one resident (h <= 8192), the 8k bank's 16x and 2x among them.
PALLAS_GEOMETRIES = [(257, 2048, 4), (1025, 4096, 2), (1025, 8192, 16),
                     (129, 1024, 1), (1025, 8192, 8), (8001, 16384, 16),
                     (8001, 16384, 2)]
# Two three-launch geometries at a small size (h = 16384): the fused
# forward at 16x, the four-step forward with the ratio-1 halves.
KERNEL_GEOMETRIES = PALLAS_GEOMETRIES + [(2049, 32768, 16), (1025, 32768, 1)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Tolerances: the replays run in float64 against the float32 plain
# version, whose rounding (summation order over up to 512-point stages)
# sets rel ~1e-6; 1e-5 is the kernel-vs-plain limit on the card.
REL_TOL = 1e-5


def _cfgs(taps, fft, ratio):
    kw = dict(taps=taps, fft_size=fft, block_size=fft - (taps - 1),
              ratio=ratio)
    return jos.OverlapSaveConfig(**kw), tos.OverlapSaveConfig(**kw)


def _rel(y, ref):
    return np.abs(y - ref).max() / np.abs(ref).max()


def _dft(a: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Unnormalized DFT along the last axis (complex128), as one matrix."""
    n = a.shape[-1]
    k = torch.arange(n, dtype=torch.float64)
    ang = (2.0 if inverse else -2.0) * math.pi * (torch.outer(k, k) % n) / n
    return a @ torch.polar(torch.ones_like(ang), ang)


def _table(v: torch.Tensor) -> torch.Tensor:
    return torch.complex(v[..., 0].double(), v[..., 1].double())


def emulate_resident(frames: np.ndarray, bundle, cfg) -> np.ndarray:
    """torch replay of the resident launch (fft_resident): the m/2-point
    FFT of the packed frame (torch.fft, float64), the pair untangle into
    the M + 1 slots X[0 .. M - 1] and conj(X[M]), Z read from the slots by
    the kernel's index maps, the h-point inverse, and the store of j >= j0
    interleaved. NaN marks an output sample the store never writes."""
    pl = ff.kernel_plan(cfg)
    tabs = {k: _table(v) for k, v in ff.kernel_consts(cfg, "cpu").items()}
    n = frames.shape[0]
    m, h, j0 = pl["m"], pl["h"], pl["j0"]
    half = m // 2
    x = torch.from_numpy(frames).to(torch.complex128)
    zf = torch.fft.fft(x[:, 0::2] + 1j * x[:, 1::2])
    wm = tabs["tw_fwd"][half - 8:]  # after the forward's pass tables

    def untangle(z, zr, w):
        return (1 - 1j * w) / 2 * z + (1 + 1j * w) / 2 * zr.conj()

    k = torch.arange(half)
    slots = torch.cat([untangle(zf, zf[:, (half - k) % half], wm[k]),
                       untangle(zf[:, :1], zf[:, :1], wm[half:]).conj()], -1)
    g = _table(bundle.weights).reshape(-1)
    k = torch.arange(h)
    if pl["halves"]:
        hi = torch.where(k == 0, h, h - k)
        upper = slots[:, hi]
        upper[:, 1:] = upper[:, 1:].conj()
        z = slots[:, k] * g[k] + upper * g[k + h]
    else:
        j = k % m
        z = torch.where(j <= half, slots[:, torch.where(j <= half, j, 0)],
                        slots[:, torch.where(j > half, m - j, 0)].conj())
        z = z * g[k]
    zz = (torch.fft.ifft(z) * h).numpy()
    out = np.full((n, pl["block"]), np.nan)
    out[:, 0::2] = zz[:, j0:].real
    out[:, 1::2] = zz[:, j0:].imag
    return out


def emulate_kernel(frames: np.ndarray, bundle, cfg) -> np.ndarray:
    """torch replay of csrc/fused_frames.cu's launches with the plan's
    splits, the loaders' and stores' index maps and the wrapper's twiddle
    tables; each short transform is a DFT (the resident plan:
    ``emulate_resident``). NaN marks an output sample the stores never
    write."""
    pl = ff.kernel_plan(cfg)
    if pl["resident"]:
        return emulate_resident(frames, bundle, cfg)
    tabs = {k: _table(v) for k, v in ff.kernel_consts(cfg, "cpu").items()}
    n = frames.shape[0]
    m, h, p2, q2 = pl["m"], pl["h"], pl["P2"], pl["Q2"]
    x = torch.from_numpy(frames).to(torch.complex128)
    if pl["fused"]:
        # One M = m/2 point FFT per frame of z[i] = x[2i] + i x[2i+1]; the
        # store untangles with the table's W_m^j (j = 0 .. M): X[k] =
        # A[k] Z[k] + B[k] conj(Z[M - k]) and X[M + k] = conj(X[M - k]).
        half = m // 2
        zf = _dft(x[:, 0::2] + 1j * x[:, 1::2], False)
        wm = tabs["tw_fwd"][half:]
        a, b = (1 - 1j * wm) / 2, (1 + 1j * wm) / 2
        k = torch.arange(half)
        zr = zf[:, (half - k) % half]
        lo = a[k] * zf + b[k] * zr.conj()
        hi = (a[half - k] * zr + b[half - k] * zf.conj()).conj()
        spec = torch.cat([lo, hi], -1)
    else:
        p, q = pl["P"], pl["Q"]
        # F1: transform (n, q), element p = x[n, p*Q + q]; B[n, k1, q]
        # times tw_m[k1, q].
        b = _dft(x.reshape(n, p, q).transpose(1, 2), False)  # [n, q, k1]
        b = b.transpose(1, 2) * tabs["tw_m"].reshape(p, q)   # [n, k1, q]
        # F2: transform (n, k1), element q; X[n, k2*P + k1].
        spec = _dft(b, False).transpose(1, 2).reshape(n, m)
    # I1: transform (n, q2), element s, k = s*Q2 + q2: Z[k] formed from X
    # and G as the loader reads them.
    g = _table(bundle.weights).reshape(-1)
    k = (torch.arange(p2)[:, None] * q2 + torch.arange(q2)[None]).reshape(-1)
    if pl["halves"]:
        z = spec[:, k] * g[k] + spec[:, k + h] * g[k + h]
    else:
        z = spec[:, k % m] * g[k]
    c1 = _dft(z.reshape(n, p2, q2).transpose(1, 2), True)   # [n, q2, k1']
    c = c1 * tabs["tw_h"]                                   # C[n, q2, k1']
    # I2: transform (n, k1'), element q2; j = k2'*P2 + k1' - j0 stored as
    # out[n, 2j + {0, 1}] where j >= 0.
    zz = _dft(c.transpose(1, 2), True).numpy()                # [n, k1', k2']
    out = np.full((n, pl["block"]), np.nan)
    ni, ki, k2 = np.meshgrid(np.arange(n), np.arange(p2), np.arange(q2),
                             indexing="ij")
    j = k2 * p2 + ki - pl["j0"]
    keep = j >= 0
    out[ni[keep], 2 * j[keep]] = zz[keep].real
    out[ni[keep], 2 * j[keep] + 1] = zz[keep].imag
    return out


def _stockham(x: np.ndarray, inverse: bool, per_pass: bool = False,
              v: int = 8) -> np.ndarray:
    """csrc/fused_frames.cu's fft_passes replayed on one transform at
    ``v`` values a thread: radix 8 while N/NS >= 8, then one radix 2 or 4
    (or, at v = 16, a last radix 16); twiddles from the wrapper's forward
    W_N^e table (fft_stage's WholeTable) or, ``per_pass``, from its
    per-pass tables (fft_resident's PassTables), conjugated for the
    inverse."""
    n = len(x)
    re, im = ff._pass_table(n, v) if per_pass else ff._fwd_table(n)
    tw = re.astype(np.float64) + 1j * im.astype(np.float64)
    if inverse:
        tw = tw.conj()
    d = x.astype(np.complex128)
    ns, base = 1, 0
    for r in ff._radices(n, v):
        j = np.arange(n // r)
        k = j % ns
        v = np.stack([d[j + q * (n // r)] for q in range(r)])     # [r, n/r]
        q = np.arange(r)[:, None]
        if per_pass:
            at = base + np.maximum(q - 1, 0) * ns + k[None]
            base += (r - 1) * ns if ns > 1 else 0
        else:
            at = k[None] * q * (n // (ns * r))
        v = v * np.where((q > 0) & (ns > 1), tw[at], 1.0)
        w = np.exp((2j if inverse else -2j) * np.pi
                   * np.outer(np.arange(r), np.arange(r)) / r)
        v = w @ v                                                 # DFT_r
        out = np.empty_like(d)
        dst = (j // ns) * ns * r + k
        for q in range(r):
            out[dst + q * ns] = v[q]
        d = out
        ns *= r
    return d


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
    spec = tos.filter_spectrum(rng.normal(size=taps), fft)
    bundle = tos.fold_bundle(spec, cfg)
    frames = rng.normal(size=(3, cfg.frame_in)).astype(np.float32)
    ref = tos.upsample_frames(torch.from_numpy(frames), bundle, cfg).numpy()
    got = emulate_kernel(frames.astype(np.float64), bundle, cfg)
    assert not np.isnan(got).any(), "an output sample was never written"
    assert _rel(got, ref) < REL_TOL


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
    assert _rel(got, ref) < REL_TOL


def _eq_response(tmp_path, fft):
    from totton_tpu_torch.control.wiring import resolve_eq_response

    path = tmp_path / "eq.txt"
    path.write_text("Preamp: -5 dB\n"
                    "Filter 1: ON PK Fc 1000 Hz Gain 3 dB Q 1.0\n"
                    "Filter 2: ON LSC Fc 105 Hz Gain 4 dB Q 0.7\n"
                    "Filter 3: ON HSC Fc 8000 Hz Gain -2 dB Q 0.7\n")
    return resolve_eq_response(str(path), None, fft, 44100)[0]


# The ten geometries chip_smoke.py holds the kernel to on the card: the
# 80k bank at 16x and 8x (fused forward) and 4x and 2x (two-launch
# forward; P != Q at 4x), and on the resident plan the 8k bank at 16x, 8x,
# 4x and 2x (its largest frame) and ratio 1 at (129, 1024) and the CLI's
# identity (1025, 4096) with an APO EQ.
CHIP_GEOMETRIES = [(80001, 131072, 16, False), (80001, 131072, 2, False),
                   (8001, 16384, 16, False), (129, 1024, 1, False),
                   (1025, 4096, 1, True), (8001, 16384, 2, False),
                   (80001, 131072, 4, False), (80001, 131072, 8, False),
                   (8001, 16384, 4, False), (8001, 16384, 8, False)]


@pytest.mark.parametrize("taps,fft,ratio,eq", CHIP_GEOMETRIES)
def test_kernel_stage_plan_at_chip_geometries(rng, tmp_path, taps, fft,
                                              ratio, eq):
    """The kernel's stage plan replayed at the card's parity geometries
    (the folded G the card's bundle carries) equals the plain version."""
    _, cfg = _cfgs(taps, fft, ratio)
    if taps == 1025:
        h = np.zeros(taps)
        h[0] = 1.0
    else:
        h = rng.normal(size=taps) * np.exp(-np.arange(taps) / (taps / 8))
    response = _eq_response(tmp_path, fft) if eq else None
    bundle = tos.fold_bundle(tos.filter_spectrum(h, fft, response), cfg)
    n = 2 if fft < 100000 else 1
    frames = (rng.normal(size=(n, cfg.frame_in)) * 0.3).astype(np.float32)
    ref = tos.upsample_frames(torch.from_numpy(frames), bundle, cfg).numpy()
    got = emulate_kernel(frames.astype(np.float64), bundle, cfg)
    assert not np.isnan(got).any(), "an output sample was never written"
    assert _rel(got, ref) < REL_TOL


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
                               8192])
@pytest.mark.parametrize("inverse", [False, True])
def test_stockham_passes_match_dft(rng, n, inverse):
    """The kernel's in-shared-memory FFT (pass sequence, butterfly and
    store indices, twiddle table indices) at every length it instantiates
    for the bundled geometries: float64 replay against numpy's FFT (the
    table's float32 rounding bounds the difference)."""
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    ref = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    assert _rel(_stockham(x, inverse), ref) < 1e-6


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
                               8192])
@pytest.mark.parametrize("inverse", [False, True])
def test_stockham_pass_tables_match_dft(rng, n, inverse):
    """The resident kernel's FFT with its per-pass twiddle tables: the
    same floats as the whole table's, so the same result bit for bit, and
    numpy's FFT within the float32 tables' rounding."""
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    ref = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    got = _stockham(x, inverse, per_pass=True)
    assert np.array_equal(got, _stockham(x, inverse))
    assert _rel(got, ref) < 1e-6
    assert len(ff._pass_table(n)[0]) == n - 8


@pytest.mark.parametrize("n,radices", [
    (256, [8, 8, 4]), (512, [8, 8, 8]), (1024, [8, 8, 16]),
    (2048, [8, 8, 8, 4]), (4096, [8, 8, 8, 8]), (8192, [8, 8, 8, 16])])
@pytest.mark.parametrize("inverse", [False, True])
def test_stockham_sixteen_values_a_thread(rng, n, radices, inverse):
    """At 16 values a thread (the resident kernel from h = 4096) a last
    16 points run as one radix-16 pass: its 4 x 4 butterfly, pass plan and
    per-pass tables against numpy's FFT."""
    assert ff._radices(n, 16) == radices
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    ref = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    assert _rel(_stockham(x, inverse, per_pass=True, v=16), ref) < 1e-6
    assert len(ff._pass_table(n, 16)[0]) == n - 8


@pytest.mark.parametrize("taps,fft", [(80001, 131072), (8001, 16384)])
def test_folded_plain_equals_jax(rng, taps, fft):
    """At ratio 16 on the 80k and 8k banks the plain folded program (the G
    bundle the card's kernel takes) equals the JAX package's
    upsample_blocks on the same input."""
    jcfg, cfg = _cfgs(taps, fft, 16)
    h = rng.normal(size=taps) * np.exp(-np.arange(taps) / (taps / 8))
    x = (rng.normal(size=(1, cfg.halo_in + 2 * cfg.block_in)) * 0.3).astype(
        np.float32)
    folded = tos.fold_bundle(tos.filter_spectrum(h, fft), cfg)
    assert tuple(folded.weights.shape) == (fft // 2, 2)
    yf = tos.upsample_blocks(torch.from_numpy(x), folded, cfg).numpy()
    ref = np.asarray(jos.upsample_blocks(
        jnp.asarray(x), jos.filter_spectrum(h, fft), jcfg))
    assert yf.shape == ref.shape
    assert _rel(yf, ref) < REL_TOL


def _resident_smem(plan) -> int:
    """fft_resident's shared memory (its Resident<M, H>::SMEM): TB frames
    a block (below h = 4096), XN >= m/2 + 1 slots of X and h of Z a frame,
    one pad float2 after every 8."""
    tb = max(1, 4096 // plan["h"])
    n = (plan["m"] // 2 + (1 if tb >= 8 else 8 // tb) + plan["h"]) * tb
    return (n + n // 8) * 8


def test_every_shipped_sidecar_is_in_the_kernel_envelope():
    """The 16 sidecars of the 8k bank (fft 16384) take the resident plan,
    one launch with the frame in 227 KB of shared memory; the 16 of the
    80k bank keep the three-launch plan."""
    paths = sorted(glob.glob(os.path.join(REPO, "data", "coefficients",
                                          "filter_*.json")))
    assert len(paths) == 32
    resident = []
    for path in paths:
        with open(path) as f:
            meta = json.load(f)
        cfg = tos.OverlapSaveConfig(meta["taps"], meta["fft_size"],
                                    meta["block_size"],
                                    meta["upsample_factor"])
        plan = ff.kernel_plan(cfg)
        assert plan["resident"] == (meta["fft_size"] <= 16384), path
        if plan["resident"]:
            resident.append(os.path.basename(path))
            assert _resident_smem(plan) <= 227 * 1024, path
            assert plan["block"] == 2 * (plan["h"] - plan["j0"]), path
            continue
        assert plan["fused"] == (plan["m"] <= ff.FUSED_MAX), path
        stages = [plan["P2"], plan["Q2"]]
        if not plan["fused"]:
            stages += [plan["P"], plan["Q"]]
        assert all(ff.STAGE_MIN <= s <= ff.STAGE_MAX for s in stages), path
        assert plan["kept"] * plan["P2"] >= cfg.block_size // 2, path
    assert len(resident) == 16
    assert all("_8000_" in name for name in resident)


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
    assert pl["halves"] and pl["resident"]
    assert (pl["m"], pl["h"], pl["j0"], pl["block"]) == (4096, 2048, 512,
                                                         3072)
    # One launch: the 2048-point forward (three radix-8 passes and one
    # radix-4: 81920 FLOP) and its 2049 untangled bins (14 FLOP each),
    # two complex multiplies and an add per bin (14 FLOP), the 2048-point
    # inverse.
    assert ff.flops_per_launch(cfg) == {
        "R": 81920 + 14 * 2049 + 14 * 2048 + 81920}
    # At h = 16384 ratio 1 keeps three launches, I1 summing the halves:
    # 128 inverse 128-point FFTs (two radix-8 passes and a radix-2).
    _, cfg = _cfgs(1025, 32768, 1)
    pl = ff.kernel_plan(cfg)
    assert pl["halves"] and not pl["resident"]
    assert (pl["P2"], pl["Q2"]) == (128, 128)
    assert ff.flops_per_launch(cfg)["I1"] == 14 * 16384 \
        + 128 * ff._fft_flops(128) + 6 * 16384


def test_flops_per_output_sample_production_16x():
    _, cfg = _cfgs(80001, 131072, 16)
    per_sample = ff.flops_per_frame(cfg) / cfg.block_size
    # FFT stages: 4.66 MFLOP a frame (the dense-GEMM form took 1334 FLOP
    # per output sample): the 4096-point forward and 4097 untangled bins,
    # the filter, 256 + 256 FFTs of 256 points and the twiddle.
    assert ff.flops_per_frame(cfg) == (
        179200 + 14 * 4097 + 6 * 65536 + 512 * 7104 + 6 * 65536)
    assert int(per_sample) == 91


def test_build_targets_sm90a():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert (_build.CSRC / "fused_frames.cu").exists()


def test_build_root_env_override_and_checkout_default(monkeypatch, tmp_path):
    monkeypatch.setenv("TOTTON_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.build_root() == tmp_path
    monkeypatch.delenv("TOTTON_TORCH_BUILD_DIR")
    assert str(_build.build_root()) == os.path.realpath(
        os.path.join(REPO, "build", "totton_tpu_torch"))


@pytest.mark.parametrize("n,flops", [
    (8, 56), (16, 2 * 56 + 8 * (4 + 6)), (64, 8 * 56 + 8 * (56 + 7 * 6)),
    (256, 1232 * 4 + 64 * (16 + 3 * 6)), (4096, 179200)])
def test_fft_flops_follow_the_pass_plan(n, flops):
    """One radix-8 butterfly is 56 FLOP (two 4-point DFTs, two W_8
    products, eight adds), a radix-4 one 16, a radix-2 one 4; every pass
    after the first adds R - 1 complex products a butterfly."""
    assert ff._fft_flops(n) == flops


def test_fft_flops_radix_sixteen():
    """8192 points at 16 values a thread: three radix-8 passes and one
    radix-16 (168 FLOP a butterfly and 15 twiddle products), against five
    passes (the fifth radix 2) at 8."""
    assert ff._fft_flops(8192, 16) == (1024 * 56 + 2 * 1024 * (56 + 42)
                                       + 512 * (168 + 15 * 6))
    assert ff._fft_flops(8192) == (1024 * 56 + 3 * 1024 * (56 + 42)
                                   + 4096 * (4 + 6))


@pytest.mark.parametrize("ratio,launches", [
    (16, ["F", "I1", "I2"]), (2, ["F1", "F2", "I1", "I2"])])
def test_flops_per_launch_sum_to_frame(ratio, launches):
    _, cfg = _cfgs(80001, 131072, ratio)
    per_launch = ff.flops_per_launch(cfg)
    assert sorted(per_launch) == launches
    assert sorted(ff.bytes_per_launch(cfg)) == launches
    assert sum(per_launch.values()) == ff.flops_per_frame(cfg)


@pytest.mark.parametrize("taps,fft,ratio", [(8001, 16384, 16),
                                             (8001, 16384, 2),
                                             (1025, 4096, 1)])
def test_resident_plan_is_one_launch(taps, fft, ratio):
    """The resident plan's one launch R: its FLOPs are the frame's; its
    bytes a frame read once and a block written once, so the bound's
    bytes are the frames' and blocks' plus G and the two tables."""
    _, cfg = _cfgs(taps, fft, ratio)
    pl = ff.kernel_plan(cfg)
    m, h, half = pl["m"], pl["h"], pl["m"] // 2
    assert pl["resident"]
    v = 16 if h >= 4096 else 8  # values a thread a pass
    assert pl["v"] == v
    assert ff.flops_per_launch(cfg) == {"R": ff.flops_per_frame(cfg)}
    assert ff.flops_per_frame(cfg) == (
        ff._fft_flops(half, v) + 14 * (half + 1)
        + (14 if ratio == 1 else 6) * h + ff._fft_flops(h, v))
    assert ff.bytes_per_launch(cfg) == {"R": 4 * m + 4 * cfg.block_size}
    consts = ff.kernel_consts(cfg, "cpu")
    assert sorted(consts) == ["tw_fwd", "tw_inv"]
    assert tuple(consts["tw_fwd"].shape) == (half - 8 + half + 1, 2)
    assert tuple(consts["tw_inv"].shape) == (h - 8, 2)
    assert ff.bound_bytes(cfg, 1024) == (
        1024 * 4 * (m + cfg.block_size) + 8 * h * (2 if ratio == 1 else 1)
        + 8 * (2 * half - 7 + h - 8))


@pytest.mark.parametrize("ratio", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("h", [256, 8192])
def test_resident_envelope(h, ratio):
    """Every ratio of the CLIs at the envelope's edges (h = 256 and 8192)
    is resident, its frame within a block's 227 KB of shared memory;
    h = 16384, and ratio 32, keep three launches."""
    def plan(h, ratio):
        return ff.kernel_plan(_cfgs(h // 2 + 1, 2 * h, ratio)[1])

    pl = plan(h, ratio)
    assert pl["resident"] and pl["m"] == 2 * h // ratio
    assert _resident_smem(pl) <= 227 * 1024
    assert not plan(16384, ratio)["resident"]
    assert not plan(8192, 32)["resident"]


def test_bound_bytes_production_16x():
    """Frames in and blocks out once per frame, G and the tables once."""
    _, cfg = _cfgs(80001, 131072, 16)
    pl = ff.kernel_plan(cfg)
    consts = sum(v.numel() * 4 for v in ff.kernel_consts(cfg, "cpu").values())
    assert ff.bound_bytes(cfg, 1024) == (
        1024 * 4 * (8192 + 51072) + 8 * 65536 + consts)
    assert pl["fused"] and (pl["P2"], pl["Q2"], pl["k2_0"]) == (256, 256, 156)
