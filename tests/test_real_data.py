"""Loader checks against the real reference datasets (read-only mount).

Skipped when /root/reference/data is absent, so the suite stays runnable
anywhere; with the mount these catch real-file parsing regressions the
synthetic PLY/TXT fixtures cannot (binary skull PLY with extra
properties, the count-headed bunny TXT format at full scale).
"""
import os

import numpy as np
import pytest

DATA = "/root/reference/data"
pytestmark = pytest.mark.skipif(
    not os.path.isdir(DATA), reason="reference data mount absent")


def test_bunny_txt_counts_and_native_match():
    from fgoicp.io import loader as pyloader
    from fgoicp.native import loader as nloader
    path = f"{DATA}/bunny/model_bunny.txt"
    with open(path) as f:
        declared = int(f.readline().split()[0])
    orig = pyloader._native_loader
    pyloader._native_loader = None
    try:
        py = pyloader.load_cloud_txt(path)
    finally:
        pyloader._native_loader = orig
    assert len(py) == declared == 35947
    native = nloader.load_txt(path)
    if native is not None:  # native lib built
        np.testing.assert_array_equal(native, py)


def test_skull_binary_ply_native_matches_python():
    from fgoicp.io import ply as plymod
    from fgoicp.native import loader as nloader
    path = f"{DATA}/artec3d/data_skull.ply"
    py = plymod.read_ply_vertices(path)
    assert len(py) == 98359  # header count
    assert np.all(np.isfinite(py))
    native = nloader.load_ply(path)
    if native is not None:
        np.testing.assert_array_equal(native, py)


@pytest.mark.parametrize("name,count", [
    ("dragon/dragonClearSpace2_0.ply", 75305),
    ("dragon/dragonToes3_0.ply", 56525),
])
def test_dragon_scans_parse(name, count):
    from fgoicp.io import load_cloud
    pts = load_cloud(f"{DATA}/{name}", 1.0, seed=0)
    assert len(pts) == count
    assert np.all(np.isfinite(pts))


def test_seeded_subsample_deterministic_on_real_data():
    from fgoicp.io import load_cloud
    a = load_cloud(f"{DATA}/bunny/data_bunny.txt", 0.1, seed=3)
    b = load_cloud(f"{DATA}/bunny/data_bunny.txt", 0.1, seed=3)
    c = load_cloud(f"{DATA}/bunny/data_bunny.txt", 0.1, seed=4)
    np.testing.assert_array_equal(a, b)
    assert len(a) != len(c) or not np.array_equal(a, c)
