"""EXR codec interop vs the *real* OpenEXR implementation.

The reference writes EXRs through IlmImf (src/libcore/bitmap.cpp); our pure
numpy codec (utils/exr.py) must read files written by standard OpenEXR and
write files standard OpenEXR can read.  Fixtures in tests/data/ were written
by native/exr_tool.cpp (links the system libOpenEXR); the round-trip legs
build it from source first, and skip where the system has no OpenEXR.
"""
import os
import subprocess

import numpy as np
import pytest

from drmlt_mitsuba.utils.exr import read_exr, write_exr

HERE = os.path.dirname(__file__)
TOOL = os.path.join(HERE, "..", "native", "exr_tool")


def _pattern(w, h):
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    return np.stack(
        [x + y / 1000.0, np.sin((x * y).astype(np.float32)), -y.astype(np.float32)],
        -1,
    ).astype(np.float32)


@pytest.mark.parametrize("name", ["openexr_zip_16x8.exr", "openexr_zips_16x8.exr"])
def test_read_openexr_written_fixture(name):
    # Checked-in files written by the system OpenEXR library (exr_tool write).
    img = read_exr(os.path.join(HERE, "data", name))
    assert img.shape == (8, 16, 3)
    np.testing.assert_allclose(img, _pattern(16, 8), atol=1e-6)


@pytest.mark.parametrize("comp", ["none", "zip", "zips"])
def test_roundtrip_self(comp, tmp_path):
    rng = np.random.default_rng(0)
    img = rng.standard_normal((23, 31, 3)).astype(np.float32)
    p = str(tmp_path / "t.exr")
    write_exr(p, img, half=False, compression=comp)
    np.testing.assert_allclose(read_exr(p), img, atol=1e-7)


@pytest.fixture
def exr_tool(native_built):
    if not os.path.exists(TOOL):
        pytest.skip("native/exr_tool did not build (no system OpenEXR)")
    return TOOL


@pytest.mark.parametrize("comp", ["zip", "zips"])
def test_openexr_reads_our_files(comp, tmp_path, exr_tool):
    img = _pattern(33, 17)
    p = str(tmp_path / "ours.exr")
    raw = str(tmp_path / "out.raw")
    write_exr(p, img, half=False, compression=comp)
    out = subprocess.run([TOOL, "read", p, raw], check=True, capture_output=True)
    w, h = map(int, out.stdout.split())
    got = np.fromfile(raw, np.float32).reshape(h, w, 3)
    np.testing.assert_allclose(got, img, atol=1e-6)


def test_read_openexr_large_zip(tmp_path, exr_tool):
    # >16-scanline image exercises multi-block ZIP offsets.
    p = str(tmp_path / "big.exr")
    subprocess.run([TOOL, "write", p, "64", "70", "zip"], check=True)
    np.testing.assert_allclose(read_exr(p), _pattern(64, 70), atol=1e-6)
