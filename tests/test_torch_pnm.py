"""The port's PNM reader (io_compat/ppm.py::read_ppm, which the flow pairs
go through) against Pillow's `Image.open(p).convert("RGB")`, which the JAX
package's FlowPairDataset calls.

Every header of Pillow 12's PpmImagePlugin.MODES at each class of maxval,
a PNG and a JPEG named `.ppm` (read by content), the committed fixtures the
card reads (scripts/make_pnm_fixtures.py) and the refusals, each of which
names the file and what it refuses.
"""

import os
import re

import numpy as np
import pytest
from PIL import Image

from premvos_tpu.data.flow_pairs import FlowPairDataset as JaxFlowPairs
from premvos_tpu_torch.data.flow_pairs import FlowPairDataset
from premvos_tpu_torch.io_compat.flo import write_flo
from premvos_tpu_torch.io_compat.png import read_png
from premvos_tpu_torch.io_compat.ppm import PnmFormatError, read_ppm
from tests import _pnm_cases
from tests._threads import few_threads  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data", "pnm")
CASES = _pnm_cases.pnm_cases()
FIXTURES = sorted(f[:-4] for f in os.listdir(DATA) if f.endswith(".ppm"))


def _pillow(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("name", list(CASES))
def test_every_header_reads_as_pillow(name, tmp_path):
    """P1-P6, Pf, P0CMYK and Pillow's Py* headers; maxval 255, below it,
    above it and 65535 (rescaled, or Pillow's mode I, clipped by the
    conversion); 1 is black in P1 and P4; Pf truncates and clips."""
    path = tmp_path / f"{name}.ppm"
    path.write_bytes(CASES[name])
    got = read_ppm(path)
    assert got.dtype == np.uint8 and got.shape == (_pnm_cases.H, _pnm_cases.W, 3)
    np.testing.assert_array_equal(got, _pillow(path))


@pytest.mark.parametrize("kind", _pnm_cases.OTHER_FORMATS)
def test_other_formats_named_ppm_read_by_content(kind, tmp_path):
    path = tmp_path / f"{kind}.ppm"
    path.write_bytes(_pnm_cases.pillow_bytes(kind))
    np.testing.assert_array_equal(read_ppm(path), _pillow(path))


@pytest.mark.parametrize("name", FIXTURES)
def test_committed_fixtures_read_as_pillow(name):
    """What chip_smoke.py holds on the card: each file equal to Pillow's
    decode and to the committed one."""
    path = os.path.join(DATA, name + ".ppm")
    got = read_ppm(path)
    np.testing.assert_array_equal(got, _pillow(path))
    np.testing.assert_array_equal(got, read_png(os.path.join(DATA, "decoded", name + ".png"))[0])


@pytest.mark.parametrize("name", list(_pnm_cases.REFUSALS))
def test_refusals_name_file_and_feature(name, tmp_path):
    """Files Pillow refuses too (an unknown magic, maxval out of range,
    data that ends early, a sample above maxval, a BMP named .ppm): the
    port raises naming the file and what it refuses."""
    data, what = _pnm_cases.REFUSALS[name]
    path = tmp_path / f"{name}.ppm"
    path.write_bytes(data)
    with pytest.raises((OSError, ValueError)):
        _pillow(path)
    with pytest.raises(PnmFormatError, match=f"{name}.ppm: .*{re.escape(what)}"):
        read_ppm(path)


def test_flow_pairs_of_other_headers_load_as_jax(tmp_path):
    """A FlyingChairs tree whose images are P3 at maxval 1000, P6 at 100,
    P5 at 65535 and a PNG named .ppm: both packages' FlowPairDataset load
    the same arrays."""
    rng = np.random.default_rng(3)
    pairs = (("00001", CASES["P3_max1000"], CASES["P6_max100"]),
             ("00002", CASES["P5_max65535"], _pnm_cases.pillow_bytes("png_rgb")))
    for stem, a, b in pairs:
        (tmp_path / f"{stem}_img1.ppm").write_bytes(a)
        (tmp_path / f"{stem}_img2.ppm").write_bytes(b)
        write_flo(tmp_path / f"{stem}_flow.flo",
                  rng.standard_normal((_pnm_cases.H, _pnm_cases.W, 2)).astype(np.float32))
    jds, tds = JaxFlowPairs(tmp_path), FlowPairDataset(tmp_path)
    assert len(tds) == len(jds) == 2
    for i in range(2):
        for g, w in zip(tds.load(i), jds.load(i)):
            np.testing.assert_array_equal(g, np.asarray(w))
