"""Regression gate between two bench runs (bench.py:regression_report)."""

import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def _load_bench():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_regression_report_flags_beyond_iqr(tmp_path):
    bench = _load_bench()
    prev = {
        "device": DEVICE,
        "headline": {"value": 10000.0},
        "configs": {
            "fft_n65536": {"per_call_s": 6.6e-6, "iqr_s": 0.1e-6},
            "fft_n4096": {"per_call_s": 2.9e-6, "iqr_s": 0.05e-6},
            "gone_config": {"per_call_s": 1e-6, "iqr_s": 0.0},
        },
    }
    p = tmp_path / "prev.json"
    p.write_text(json.dumps(prev))
    details = {
        "device": DEVICE,
        "configs": {
            # 20% slower, far beyond both IQRs and the 3% floor -> regressed
            "fft_n65536": {"per_call_s": 7.9e-6, "iqr_s": 0.1e-6, "melem_per_s": 8295.0},
            # within the 3% floor -> fine
            "fft_n4096": {"per_call_s": 2.95e-6, "iqr_s": 0.05e-6},
            # new config with no baseline -> skipped, not an error
            "fft_new": {"per_call_s": 1e-6, "iqr_s": 0.0},
        }
    }
    rep = bench.regression_report(details, path=str(p))
    assert rep["per_config"]["fft_n65536"]["regressed"]
    assert not rep["per_config"]["fft_n4096"]["regressed"]
    assert "fft_new" not in rep["per_config"]
    assert rep["regressed"] == ["fft_n65536"]
    assert rep["headline_delta_pct"] < 0  # slower headline reads negative


def test_regression_report_missing_baseline(tmp_path):
    bench = _load_bench()
    rep = bench.regression_report({"configs": {}}, path=str(tmp_path / "absent.json"))
    assert rep["baseline"] is None


def test_regression_report_wide_iqr_suppresses_noise(tmp_path):
    bench = _load_bench()
    prev = {"device": DEVICE, "configs": {"cfg": {"per_call_s": 10e-6, "iqr_s": 2e-6}}}
    p = tmp_path / "prev.json"
    p.write_text(json.dumps(prev))
    details = {"device": DEVICE, "configs": {"cfg": {"per_call_s": 11e-6, "iqr_s": 2e-6}}}
    rep = bench.regression_report(details, path=str(p))
    assert not rep["per_config"]["cfg"]["regressed"]  # within the IQR band


def test_regression_report_skips_other_device(tmp_path):
    # A baseline recorded on another device is never compared.
    bench = _load_bench()
    other = dict(DEVICE, kind="NVIDIA A100-SXM4-80GB")
    prev = {"device": other, "configs": {"cfg": {"per_call_s": 1e-6, "iqr_s": 0.0}}}
    p = tmp_path / "prev.json"
    p.write_text(json.dumps(prev))
    details = {"device": DEVICE, "configs": {"cfg": {"per_call_s": 9e-6, "iqr_s": 0.0}}}
    rep = bench.regression_report(details, path=str(p))
    assert "per_config" not in rep and "not compared" in rep["note"]
