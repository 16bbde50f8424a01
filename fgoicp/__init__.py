"""Globally-optimal point-cloud registration (Go-ICP) in JAX.

A from-scratch JAX/XLA/Pallas implementation of the Go-ICP capability set of
the CUDA reference (solemnwind/fast-go-icp): nested branch-and-bound over
SE(3) with distance-field bounds and Procrustes ICP refinement, built
around device frontiers, batched bound kernels and mesh sharding.
"""

__version__ = "0.1.0"

__all__ = [
    "Config", "EngineConfig", "FastGoICP", "GoICP", "icp_register",
    "load_cloud", "read_ply_vertices", "register", "write_ply",
]

import os as _os

import jax as _jax

# Persistent compilation cache: the engine's jitted programs (batched ICP,
# pooled inner BnB) are large, and a warm cache makes repeat runs start in
# seconds.  JAX_COMPILATION_CACHE_DIR, when set, is the only cache
# directory (JAX reads it itself); otherwise the cache lives at a fixed
# path inside the checkout, so every run from it finds the same entries.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


from .config import Config, EngineConfig  # noqa: E402
from .io import load_cloud, read_ply_vertices, write_ply  # noqa: E402
from .models.goicp import GoICP, register  # noqa: E402
from .models.icp import icp_register  # noqa: E402

# Reference-familiar alias (icp::FastGoICP, /root/reference/fgoicp/fgoicp.hpp:10).
FastGoICP = GoICP
