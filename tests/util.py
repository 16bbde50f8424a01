"""Shared test helpers: one standard engine config so every e2e test hits
the same jit cache entries (CPU compiles of the frontier/ICP loops are
the dominant suite cost)."""
from fgoicp.config import EngineConfig

STD_ENGINE = dict(
    rotation_batch=2,
    frontier_capacity=256,
    pool_lanes=64,
    pool_capacity=2048,
    # Coarser span cutoffs than production (0.05/0.1): on the 1-core CPU
    # test host the full-depth certificate costs minutes per search; the
    # coarse tree still discovers the global basin (ICP triggers do the
    # fine alignment) in seconds.
    rotation_min_span=0.1,
    translation_min_span=0.2,
    # Aggressive ICP triggering (reference factor: 1.8): every evaluated
    # child refines, so the global basin is found within the first outer
    # steps and the optimality gap closes immediately afterwards.
    icp_trigger_factor=1e6,
    # Multi-start seeding finds the basin without any BnB on these small
    # problems; disable it so tests actually exercise the search.
    icp_multi_start=False,
)


def std_engine(**overrides) -> EngineConfig:
    kw = dict(STD_ENGINE)
    kw.update(overrides)
    return EngineConfig(**kw)
