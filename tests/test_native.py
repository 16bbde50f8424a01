"""Native C++ loader: builds, matches the Python parser exactly, and
degrades gracefully."""
import numpy as np
import pytest

from fgoicp.native import build as nbuild
from fgoicp.native import loader as nloader


@pytest.fixture(scope="module")
def lib():
    path = nbuild.ensure_built(quiet=True)
    if path is None:
        pytest.skip("no native toolchain available")
    return path


def test_txt_exact_match(lib, tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(257, 3)).astype(np.float32)
    p = tmp_path / "cloud.txt"
    with open(p, "w") as f:
        f.write(f"{len(pts)}\n")
        for row in pts:
            f.write(f"{row[0]:.9g} {row[1]:.9g} {row[2]:.9g}\n")
    native = nloader.load_txt(str(p))
    assert native is not None
    from fgoicp.io import loader as pyloader
    orig = pyloader._native_loader
    pyloader._native_loader = None
    try:
        python = pyloader.load_cloud_txt(str(p))
    finally:
        pyloader._native_loader = orig
    np.testing.assert_array_equal(native, python)


def test_txt_extra_columns_ignored(lib, tmp_path):
    p = tmp_path / "cloud.txt"
    p.write_text("2 extra header tokens\n1 2 3 255 255 255\n4 5 6 0 0 0\n")
    pts = nloader.load_txt(str(p))
    np.testing.assert_array_equal(
        pts, np.array([[1, 2, 3], [4, 5, 6]], np.float32))


def test_ply_matches_python_ascii_and_binary(lib, tmp_path):
    from fgoicp.io import ply as plymod
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(123, 3)).astype(np.float32)
    for binary in (True, False):
        p = tmp_path / f"c_{binary}.ply"
        plymod.write_ply(str(p), pts, binary=binary)
        native = nloader.load_ply(str(p))
        assert native is not None
        np.testing.assert_array_equal(
            native, plymod.read_ply_vertices(str(p)))


def test_ply_extra_props_and_skipped_elements(lib, tmp_path):
    from fgoicp.io import ply as plymod
    p = tmp_path / "x.ply"
    p.write_bytes(
        b"ply\nformat ascii 1.0\ncomment hi\n"
        b"element vertex 2\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"property uchar red\n"
        b"end_header\n1 2 3 9\n4 5 6 9\n")
    native = nloader.load_ply(str(p))
    np.testing.assert_array_equal(
        native, np.array([[1, 2, 3], [4, 5, 6]], np.float32))


def test_ply_unsupported_falls_back(lib, tmp_path):
    # big-endian -> native returns None, Python path handles it.
    rec = np.zeros(1, dtype=[("x", ">f4"), ("y", ">f4"), ("z", ">f4")])
    rec["x"], rec["y"], rec["z"] = 1, 2, 3
    p = tmp_path / "be.ply"
    p.write_bytes(
        b"ply\nformat binary_big_endian 1.0\nelement vertex 1\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"end_header\n" + rec.tobytes())
    assert nloader.load_ply(str(p)) is None
    from fgoicp.io import loader as io_loader
    np.testing.assert_allclose(io_loader.load_cloud(str(p)),
                               [[1, 2, 3]])


def test_malformed_returns_none(lib, tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("5\n1 2 3\n")  # claims 5 rows, has 1
    assert nloader.load_txt(str(p)) is None
    p2 = tmp_path / "bad2.txt"
    p2.write_text("not-a-count\n")
    assert nloader.load_txt(str(p2)) is None
    assert nloader.load_txt(str(tmp_path / "missing.txt")) is None


def test_huge_declared_counts_rejected(lib, tmp_path):
    # Counts that cannot fit in the file must be rejected BEFORE any
    # allocation: 3*4*count wraps size_t for adversarial counts and the
    # row loop would overflow the small allocation while data remains.
    for count in (2 ** 62, 2 ** 61 + 7, 10 ** 15):
        p = tmp_path / "huge.txt"
        p.write_text(f"{count}\n" + "1 2 3\n" * 50)
        assert nloader.load_txt(str(p)) is None
    p = tmp_path / "huge.ply"
    p.write_bytes(
        b"ply\nformat binary_little_endian 1.0\n"
        b"element vertex 4611686018427387911\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"end_header\n" + b"\x00" * 120)
    assert nloader.load_ply(str(p)) is None
    # Same guard for a huge non-vertex element before the vertex one.
    p2 = tmp_path / "huge2.ply"
    p2.write_bytes(
        b"ply\nformat binary_little_endian 1.0\n"
        b"element face 4611686018427387911\nproperty float q\n"
        b"element vertex 1\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"end_header\n" + b"\x00" * 120)
    assert nloader.load_ply(str(p2)) is None


def test_mixed_vertex_types_fall_back(lib, tmp_path):
    # Binary PLY with x:float but y:double would be memcpy'd at the wrong
    # width; the native loader must punt to the Python parser.
    import struct
    row = struct.pack("<fdf", 1.0, 2.0, 3.0)
    p = tmp_path / "mixed.ply"
    p.write_bytes(
        b"ply\nformat binary_little_endian 1.0\nelement vertex 1\n"
        b"property float x\nproperty double y\nproperty float z\n"
        b"end_header\n" + row)
    assert nloader.load_ply(str(p)) is None
    # Integer-typed coordinate: same fallback.
    row2 = struct.pack("<fif", 1.0, 2, 3.0)
    p2 = tmp_path / "intprop.ply"
    p2.write_bytes(
        b"ply\nformat binary_little_endian 1.0\nelement vertex 1\n"
        b"property float x\nproperty int y\nproperty float z\n"
        b"end_header\n" + row2)
    assert nloader.load_ply(str(p2)) is None
