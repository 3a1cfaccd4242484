"""AOT export / serving artifacts (utils/serving.py).

The analog of the reference's per-variant startup shader
compiles (reference README.md:87-89; warmup() is the in-process analog):
trace + lower once, serialize, and serve from the artifact with zero
retracing.  These run on the CPU test mesh; the verify recipe exercises
the same surface on the real chip.
"""

import numpy as np
import pytest

from gpu_fft_tpu.utils.serving import (
    EXPORT_KINDS,
    export_transform,
    exported_call,
    load_transform,
    save_transform,
)


@pytest.mark.parametrize("kind", EXPORT_KINDS)
def test_export_roundtrips_through_serialization(kind, tmp_path):
    b, n = 2, 256
    path = str(tmp_path / f"{kind}.bin")
    size = save_transform(path, kind, b, n)
    assert size > 0
    exported = load_transform(path)
    rng = np.random.default_rng(0)
    args = [rng.standard_normal(s.shape).astype(np.float32) for s in exported.in_avals]
    got = exported_call(exported, *args)
    # Oracle: the live (traced) path on the same inputs.
    live = export_transform(kind, b, n)  # fresh trace, same dispatch
    want = live.call(*args)
    flat_g = got if isinstance(got, (tuple, list)) else (got,)
    flat_w = want if isinstance(want, (tuple, list)) else (want,)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-6)


def test_exported_fft_matches_numpy(tmp_path):
    path = str(tmp_path / "fft.bin")
    save_transform(path, "fft", 1, 1024)
    exported = load_transform(path)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 1024)).astype(np.float32)
    yr, yi = exported_call(exported, x)
    ref = np.fft.fft(x.astype(np.float64), axis=-1)
    scale = np.abs(ref).max()
    assert np.abs(yr - ref.real).max() / scale < 5e-6
    assert np.abs(yi - ref.imag).max() / scale < 5e-6


def test_export_validates_inputs():
    with pytest.raises(ValueError):
        export_transform("nope", 1, 256)
    with pytest.raises(ValueError):
        export_transform("fft", 1, 1000)  # non-pow2
    with pytest.raises(ValueError):
        export_transform("fft", 0, 256)


def test_cli_export_and_serve_check(tmp_path, capsys):
    from gpu_fft_tpu.__main__ import main

    art = str(tmp_path / "a.bin")
    assert main(["export", "--kind", "rfft", "--batch", "2", "-n", "256", "-o", art]) == 0
    assert main(["serve-check", art]) == 0
    out = capsys.readouterr().out
    assert "exported rfft" in out and "2 output(s)" in out
