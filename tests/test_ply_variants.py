"""PLY parser coverage: format variants, extra properties, error paths
(tinyply-parity surface, /root/reference/src/utilities.hpp:113-179)."""
import numpy as np
import pytest

from fgoicp.io.ply import PlyError, read_ply_vertices, write_ply


def _write(path, text=None, raw=None):
    with open(path, "wb") as f:
        f.write(raw if raw is not None else text.encode())
    return str(path)


def test_ascii_with_extra_props_and_comments(tmp_path):
    p = _write(tmp_path / "a.ply", text=(
        "ply\nformat ascii 1.0\ncomment made by nobody\n"
        "element vertex 3\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
        "1 2 3 255 0 0\n4 5 6 0 255 0\n7 8 9 0 0 255\n"))
    v = read_ply_vertices(p)
    np.testing.assert_allclose(v, [[1, 2, 3], [4, 5, 6], [7, 8, 9]])


def test_binary_little_endian_double_coords(tmp_path):
    pts = np.array([[1.5, -2.25, 3.125], [0, 4, -8]], np.float64)
    rec = np.zeros(2, dtype=[("x", "<f8"), ("y", "<f8"), ("z", "<f8")])
    rec["x"], rec["y"], rec["z"] = pts.T
    p = _write(tmp_path / "b.ply", raw=(
        b"ply\nformat binary_little_endian 1.0\nelement vertex 2\n"
        b"property double x\nproperty double y\nproperty double z\n"
        b"end_header\n" + rec.tobytes()))
    np.testing.assert_allclose(read_ply_vertices(p), pts)


def test_binary_big_endian(tmp_path):
    pts = np.array([[1, 2, 3]], np.float32)
    rec = np.zeros(1, dtype=[("x", ">f4"), ("y", ">f4"), ("z", ">f4")])
    rec["x"], rec["y"], rec["z"] = pts.T
    p = _write(tmp_path / "be.ply", raw=(
        b"ply\nformat binary_big_endian 1.0\nelement vertex 1\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"end_header\n" + rec.tobytes()))
    np.testing.assert_allclose(read_ply_vertices(p), pts)


def test_skips_preceding_face_element(tmp_path):
    # Vertex element after a list-property element must still parse.
    p = _write(tmp_path / "f.ply", text=(
        "ply\nformat ascii 1.0\n"
        "element face 1\nproperty list uchar int vertex_indices\n"
        "element vertex 1\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
        "3 0 1 2\n"
        "9 8 7\n"))
    np.testing.assert_allclose(read_ply_vertices(p), [[9, 8, 7]])


@pytest.mark.parametrize("raw,msg", [
    (b"not a ply\n", "magic"),
    (b"ply\nformat ascii 1.0\nelement vertex 1\nproperty float x\n"
     b"property float y\nproperty float z\nend_header\n", "EOF|could not"),
    (b"ply\nformat weird 1.0\nend_header\n", "format"),
    (b"ply\nformat ascii 1.0\nelement vertex 1\nproperty float a\n"
     b"property float b\nproperty float c\nend_header\n1 2 3\n", "missing"),
])
def test_malformed_raises(tmp_path, raw, msg):
    import re
    p = _write(tmp_path / "bad.ply", raw=raw)
    with pytest.raises(Exception) as ei:
        read_ply_vertices(p)
    assert re.search(msg, str(ei.value), re.IGNORECASE) or \
        isinstance(ei.value, (PlyError, ValueError, IndexError))


def test_roundtrip_ascii_and_binary(tmp_path):
    pts = np.random.default_rng(0).normal(size=(57, 3)).astype(np.float32)
    for binary in (True, False):
        path = str(tmp_path / f"rt_{binary}.ply")
        write_ply(path, pts, binary=binary)
        back = read_ply_vertices(path)
        np.testing.assert_allclose(back, pts, atol=1e-5)
