"""Port parity: the filter-design toolkit (``totton_tpu_torch/filters/
{design,validate,generate,plots}.py``, copies of the JAX package's)
against the reference on the same small tap counts: the designed taps
bit for bit, the validation reports, the exported .bin and the sidecar
JSON (its generation date aside), the CLI's summary, and the plots."""

import json

import numpy as np
import pytest

from totton_tpu.filters import design as ref_design
from totton_tpu.filters import generate as ref_generate
from totton_tpu.filters import validate as ref_validate

torch = pytest.importorskip("torch")

from totton_tpu_torch.filters import design, generate, validate

#: (config, taps, phase) kept small so design stays fast.
CONFIGS = [("44k_2x", 1000, "minimum"), ("44k_16x", 2000, "minimum"),
           ("48k_4x", 801, "linear"), ("44k_8x", 1200, "linear")]


@pytest.mark.parametrize("key,taps,phase", CONFIGS)
def test_design_and_validation_bit_equal(key, taps, phase):
    out = []
    for d, v in ((design, validate), (ref_design, ref_validate)):
        spec = d.FilterSpec.from_multi_rate(key, n_taps=taps,
                                            kaiser_beta=25.0, phase=phase)
        h, report = d.design_filter(spec)
        val = v.validate_filter(
            h, sample_rate_output=spec.output_rate,
            passband_end_hz=spec.passband_end_hz,
            stopband_start_hz=spec.stopband_start_hz,
            target_stopband_attenuation_db=spec.stopband_attenuation_db,
            target_dc_gain=spec.target_dc_gain, phase=spec.phase)
        out.append((h, report, val, spec.basename(n_taps_label=taps)))
    (h, report, val, name), (rh, rreport, rval, rname) = out
    assert h.dtype == rh.dtype and np.array_equal(h, rh)
    assert json.dumps(report, sort_keys=True, default=str) == json.dumps(
        rreport, sort_keys=True, default=str)
    assert val == rval and name == rname


@pytest.mark.parametrize("n,ratio", [(80000, 16), (80001, 2), (10, 4),
                                     (12345, 1)])
def test_aligned_tap_count_equal(n, ratio):
    assert design.aligned_tap_count(n, ratio) == ref_design.aligned_tap_count(
        n, ratio)


def test_multi_rate_table_and_safe_gain_equal():
    assert design.MULTI_RATE_SPECS == ref_design.MULTI_RATE_SPECS
    rng = np.random.default_rng(3)
    sets = {k: rng.normal(size=64) * 0.1 for k in ("44k_2x", "48k_2x")}
    assert design.calculate_safe_gain(sets) == ref_design.calculate_safe_gain(
        sets)


def _sidecar(path):
    meta = json.loads(open(path).read())
    meta.pop("generation_date", None)
    return meta


@pytest.mark.parametrize("key,taps,phase", CONFIGS[:2])
def test_generate_one_writes_the_same_artifacts(tmp_path, key, taps, phase):
    outs = []
    for name, gen in (("port", generate), ("ref", ref_generate)):
        out_dir = tmp_path / name
        r = gen.generate_one(key, taps, 25.0, 140.0, phase, str(out_dir))
        bin_path = r["json_path"][:-len(".json")] + ".bin"
        outs.append((dict(r, json_path=r["json_path"].split("/")[-1]),
                     _sidecar(r["json_path"]),
                     open(bin_path, "rb").read()))
    assert outs[0] == outs[1]


def test_generate_cli_summary_equal(tmp_path):
    """``--config`` through both CLIs: the same exit code, the same
    generation summary and sidecar."""
    results = []
    for name, gen in (("port", generate), ("ref", ref_generate)):
        out_dir = tmp_path / name
        rc = gen.main(["--config", "44k_2x", "--taps", "1000",
                       "--output-dir", str(out_dir), "--no-parallel"])
        summary = json.loads((out_dir / "generation_summary.json").read_text())
        for f in summary["filters"]:
            f["json_path"] = f["json_path"].split("/")[-1]
        results.append((rc, summary))
    assert results[0] == results[1]


def test_plots_written(tmp_path):
    """plots (Agg backend, as the reference's): the same files from the
    same inputs, each a PNG."""
    from totton_tpu.filters import plots as ref_plots
    from totton_tpu_torch.filters import plots

    spec = design.FilterSpec.from_multi_rate("44k_2x", n_taps=401)
    h, _ = design.design_filter(spec)
    h_lin, _ = design.design_filter(design.FilterSpec.from_multi_rate(
        "44k_2x", n_taps=401, phase="linear"))
    names = []
    for name, mod in (("port", plots), ("ref", ref_plots)):
        out = tmp_path / name
        paths = mod.plot_filter(h, spec.output_rate, spec.passband_end_hz,
                                spec.stopband_start_hz, out, "f")
        paths.append(mod.plot_phase_comparison(h, h_lin, spec.output_rate,
                                               out))
        for p in paths:
            assert open(p, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
        names.append([p.split("/")[-1] for p in paths])
    assert names[0] == names[1]
    assert plots.matplotlib.get_backend().lower() == "agg"
