"""The port's field slices (hpsdf_tpu_torch.viz) against hpsdf_tpu.viz:
byte-identical BMPs and colorings, and function_slice on a carried-across
tree to 1e-12 (both sample with an f64 query; 50 samples per axis keep
every sample but the borders off the dyadic cell faces, where an ulp of
difference between the two linspaces could pick another leaf)."""

import numpy as np
import pytest

import hpsdf_tpu as hp
from hpsdf_tpu import viz as JV
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import viz as TV

from .test_torch_accel import carry
from .test_torch_query import few_torch_threads  # noqa: F401
from .util import sphere_sdf


@pytest.fixture(scope="module")
def trees():
    cfg = hp.Config(target_error=1e-6, continuity=False, max_depth=4,
                    max_degree=4, root_min=(-0.5, -0.6, -0.5),
                    root_max=(0.7, 0.5, 0.5))
    jt = hp.build_octree(cfg, sphere_sdf(radius=0.3))
    return jt, carry(jt, cfg)


@pytest.mark.parametrize("z", [0.0, 0.137])
def test_function_slice(trees, z):
    jt, tt = trees
    want = JV.function_slice(jt, z, resolution=50)
    got = TV.function_slice(tt, z, resolution=50)
    assert got.shape == (50, 50) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_slice_to_rgb_identical(trees):
    jt, _ = trees
    v = JV.function_slice(jt, 0.0, resolution=50)
    np.testing.assert_array_equal(TV.slice_to_rgb(v), JV.slice_to_rgb(v))


@pytest.mark.parametrize("shape", [(7, 5), (16, 16), (3, 10)])
def test_write_bmp_identical(tmp_path, shape):
    rgb = np.random.default_rng(5).integers(0, 256, shape + (3,), np.uint8)
    JV.write_bmp(str(tmp_path / "j.bmp"), rgb)
    TV.write_bmp(str(tmp_path / "t.bmp"), rgb)
    assert (tmp_path / "t.bmp").read_bytes() == \
        (tmp_path / "j.bmp").read_bytes()


def test_output_function_slice_identical(trees, tmp_path):
    jt, tt = trees
    hp.output_function_slice(jt, str(tmp_path / "j.bmp"), z=0.05,
                             resolution=50)
    T.output_function_slice(tt, str(tmp_path / "t.bmp"), z=0.05,
                            resolution=50)
    assert (tmp_path / "t.bmp").read_bytes() == \
        (tmp_path / "j.bmp").read_bytes()
