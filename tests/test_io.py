"""Tests for config parsing and point-cloud IO."""

import os

import numpy as np
import pytest

from fgoicp.config import Config
from fgoicp.io import load_cloud, read_ply_vertices, subsample_cloud, write_ply


class TestConfig:
    def test_reference_schema(self, tmp_path):
        toml = tmp_path / "run.toml"
        toml.write_text(
            """
[info]
version = "0.2"

[io]
target = "a.txt"
source = "b.txt"
output = "out.toml"
visualization = "viz.ply"

[params]
trim = true
target_subsample = 0.5
source_subsample = 0.1
lut_resolution = 0.002
mse_threshold = 1e-3
"""
        )
        cfg = Config.from_toml(str(toml))
        assert cfg.io.target == "a.txt"
        assert cfg.io.source == "b.txt"
        assert cfg.params.trim is True
        assert cfg.params.target_subsample == 0.5
        assert cfg.params.source_subsample == 0.1
        assert cfg.params.lut_resolution == 0.002
        assert cfg.params.mse_threshold == 1e-3

    def test_defaults_and_clamps(self):
        # Reference defaults (utilities.hpp:94-98) and clamps (:101-104).
        cfg = Config.from_dict({"params": {"source_subsample": 0.9,
                                           "target_subsample": 7.0,
                                           "mse_threshold": 0.0}})
        assert cfg.params.source_subsample == 0.5   # clamped to <= 0.5
        assert cfg.params.target_subsample == 1.0   # clamped to <= 1.0
        assert cfg.params.mse_threshold == 1e-12    # clamped to >= 1e-12
        assert cfg.params.lut_resolution == 0.005   # default
        cfg2 = Config.from_dict({})
        assert cfg2.params.trim is False
        assert cfg2.params.mse_threshold == 1e-3

    def test_engine_section(self):
        cfg = Config.from_dict({"engine": {"seed": 7, "rotation_batch": 2,
                                           "ref_compat_gamma": True}})
        assert cfg.engine.seed == 7
        assert cfg.engine.rotation_batch == 2
        assert cfg.engine.ref_compat_gamma is True
        assert cfg.engine.translation_min_span == 0.1

    def test_engine_type_errors(self):
        import pytest
        # Wrong-typed values must raise, not silently coerce
        # (frontier_mode=3 used to become the string "3").
        with pytest.raises(ValueError, match="frontier_mode"):
            Config.from_dict({"engine": {"frontier_mode": 3}})
        with pytest.raises(ValueError, match="rotation_batch"):
            Config.from_dict({"engine": {"rotation_batch": "8"}})
        with pytest.raises(ValueError, match="icp_multi_start"):
            Config.from_dict({"engine": {"icp_multi_start": 1}})
        with pytest.raises(ValueError, match="seed"):
            Config.from_dict({"engine": {"seed": True}})
        with pytest.raises(ValueError, match="Unknown"):
            Config.from_dict({"engine": {"not_a_knob": 1}})
        # Safe widenings are allowed: int -> float, exact-int float -> int.
        cfg = Config.from_dict({"engine": {"icp_trigger_factor": 2,
                                           "pool_lanes": 512.0}})
        assert cfg.engine.icp_trigger_factor == 2.0
        assert cfg.engine.pool_lanes == 512


class TestReferenceConfigs:
    """Parse the reference's OWN shipped run configs byte-for-byte
    (/root/reference/test/*.toml) — schema parity with utilities.hpp:61-106
    proven against the real artifacts, not reconstructions.  Skipped when
    the reference mount is absent."""

    REF = "/root/reference/test"

    @pytest.fixture(autouse=True)
    def _need_ref(self):
        if not os.path.isdir(self.REF):
            pytest.skip("reference configs not mounted")

    def test_bunny_toml(self):
        cfg = Config.from_toml(f"{self.REF}/bunny.toml")
        assert cfg.io.target.endswith("data/bunny/model_bunny.txt")
        assert cfg.io.source.endswith("data/bunny/data_bunny.txt")
        assert cfg.io.output == "output.toml"
        assert cfg.io.visualization == "viz.ply"
        assert cfg.params.trim is True
        assert cfg.params.target_subsample == 0.5
        assert cfg.params.source_subsample == 0.1
        assert cfg.params.lut_resolution == 0.002
        assert cfg.params.mse_threshold == 1e-3

    def test_skull_toml(self):
        # Has keys no parser consumes ([info] version, [params] mode —
        # the reference ignores them too, utilities.hpp:61-106) and must
        # parse cleanly around them.
        cfg = Config.from_toml(f"{self.REF}/skull_goicp.toml")
        assert cfg.io.target.endswith("data/artec3d/model_skull.ply")
        assert cfg.params.target_subsample == 0.03
        assert cfg.params.source_subsample == 0.1
        assert cfg.params.lut_resolution == 0.005
        assert cfg.params.mse_threshold == 1e-3


class TestPly:
    def test_roundtrip_binary(self, tmp_path):
        rng = np.random.default_rng(0)
        pts = rng.normal(size=(100, 3)).astype(np.float32)
        path = tmp_path / "c.ply"
        write_ply(str(path), pts, binary=True)
        back = read_ply_vertices(str(path))
        np.testing.assert_allclose(back, pts, rtol=1e-6)

    def test_roundtrip_ascii(self, tmp_path):
        rng = np.random.default_rng(1)
        pts = rng.normal(size=(17, 3)).astype(np.float32)
        path = tmp_path / "c.ply"
        write_ply(str(path), pts, binary=False)
        back = read_ply_vertices(str(path))
        np.testing.assert_allclose(back, pts, atol=1e-5)

    def test_extra_vertex_properties(self, tmp_path):
        # Vertex with colors: x,y,z extracted, colors skipped.
        path = tmp_path / "c.ply"
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            "element vertex 2\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        row = np.zeros(2, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                  ("r", "u1"), ("g", "u1"), ("b", "u1")])
        row["x"] = [1.0, 4.0]; row["y"] = [2.0, 5.0]; row["z"] = [3.0, 6.0]
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(row.tobytes())
        pts = read_ply_vertices(str(path))
        np.testing.assert_allclose(pts, [[1, 2, 3], [4, 5, 6]])

    def test_missing_xyz_raises(self, tmp_path):
        path = tmp_path / "bad.ply"
        path.write_bytes(
            b"ply\nformat ascii 1.0\nelement vertex 1\n"
            b"property float a\nend_header\n1.0\n")
        with pytest.raises(Exception, match="missing 'x'"):
            read_ply_vertices(str(path))


class TestLoader:
    def test_txt_format(self, tmp_path):
        # Reference txt: first line count, then x y z rows (utilities.hpp:181).
        path = tmp_path / "c.txt"
        path.write_text("3\n0 0 0\n1 1 1\n2 2 2\n")
        pts = load_cloud(str(path))
        np.testing.assert_allclose(pts, [[0, 0, 0], [1, 1, 1], [2, 2, 2]])

    def test_subsample_deterministic_and_capped(self):
        rng = np.random.default_rng(2)
        pts = rng.normal(size=(1000, 3)).astype(np.float32)
        a = subsample_cloud(pts, 0.25, seed=42)
        b = subsample_cloud(pts, 0.25, seed=42)
        c = subsample_cloud(pts, 0.25, seed=43)
        np.testing.assert_array_equal(a, b)
        assert len(a) <= 250          # cap = floor(N * p)
        assert len(a) > 150           # Bernoulli close to p
        assert not (len(a) == len(c) and np.allclose(a, c))

    def test_unsupported_extension(self, tmp_path):
        p = tmp_path / "c.xyz"
        p.write_text("")
        with pytest.raises(RuntimeError, match="Unsupported file extension"):
            load_cloud(str(p))
