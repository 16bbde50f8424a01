"""Dense 3D nearest-neighbor distance field with trilinear lookup.

Capability parity with the reference's NearestNeighborLUT
(/root/reference/fgoicp/registration.cu:180-328): a voxel grid over the
(normalized) target bounding box at `resolution`, dims = ceil(range/res)
per axis, queried by trilinear interpolation with border clamping.

Redesign (conscious differences, all documented):

* **Stored quantity is the distance d, not d^2.**  The reference stores
  squared distances and trilinearly interpolates them (tex3D), which
  overestimates d in cell interiors (d^2 is convex); d itself is
  1-Lipschitz so its interpolation error is O(res).  Bound math consumes
  d directly, saving the per-lookup sqrt (registration.cu:48).

* **Builder is a separable min-plus parabolic transform (generalized
  exact EDT)**, O(cells * dim) per axis, instead of the reference's
  O(cells * nt) brute force (registration.cu:258-278) — orders of
  magnitude cheaper at bunny scale (10^9 cells x 10^4 points).  Each
  target point seeds its nearest grid node with its exact squared
  distance, then three 1D passes compute
  D(u) = min_p [ ||u - v(p)||^2 + ||v(p) - p||^2 ],
  which brackets the true d as
      d - delta <= stored <= sqrt((d + delta)^2 + delta^2)
  where delta = (sqrt(3)/2) * res is the point-to-node assignment radius
  (worst absolute error sqrt(2)*delta = sqrt(3/2)*res, at d=0).  The
  bracket parameters ride in the field (`assign_delta`, `quant_eps`) so
  bounds.distance_estimates can form asymmetric, per-lookup-tight valid
  estimates — a guarantee the reference's LUT does not offer.  A
  brute-force builder (exact, zero slack) is kept for small grids and
  for testing.

* **Lookup is 8-corner gather + manual lerp** on a flat HBM array; the
  reference's half-texel offset (tex3D samples at i+0.5 but queries are
  mapped without the shift, registration.cu:320-328) is deliberately not
  reproduced — grid node i sits exactly at origin + i*res here.

* **Reference-compat mode** (builder="ref" + lookup_ref_compat):
  reproduces the reference LUT bit-for-bit in structure for parity
  debugging — dims = ceil(range/res) with NO +1 (registration.cu:186),
  stored quantity is the SQUARED distance (buildLUTKernel,
  registration.cu:258-278), and lookup applies the half-texel shift the
  reference inherits from tex3D linear filtering (coordinates mapped
  without the +0.5 the hardware subtracts, registration.cu:320-328),
  returning sqrt(interpolated d^2).  These bounds carry no validity
  guarantee (d^2 interpolation overestimates in cell interiors; the
  shift skews lookups by res/2) — exactly like the reference.  A field
  built with builder="ref" must only be read through lookup_ref_compat
  (the LutBackend.ref_compat flag routes this).
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import nn as nn_ops
from ..utils import logging as log

BIG = 1e10


class DistanceField(NamedTuple):
    """Pytree: dense distance grid + affine query mapping.

    Error model (consumed by bounds.distance_estimates): with true NN
    distance d and stored node value s,

        d - assign_delta <= s <= sqrt((d + assign_delta)^2 + assign_delta^2)

    (assign_delta = the point-to-node seeding radius of the EDT builder;
    0 for the exact brute builder), and the dtype-narrowed value qv
    satisfies |qv - s| <= quant_eps * s (relative rounding; 0 for f32).
    Keeping the pieces separate lets the consumer form ASYMMETRIC,
    per-lookup-tight estimates instead of one worst-case absolute slack.
    """

    values: jnp.ndarray       # [X, Y, Z] distances (dtype configurable)
    origin: jnp.ndarray       # [3] world position of grid node (0,0,0)
    inv_res: jnp.ndarray      # scalar 1/resolution
    assign_delta: jnp.ndarray  # scalar: EDT seeding radius (0 = exact)
    quant_eps: jnp.ndarray    # scalar: relative storage rounding bound

    @property
    def dims(self):
        return self.values.shape

    @property
    def slack(self):
        """Absolute node-value error bound |stored - true| (f32 fields):
        the upper bracket sqrt((d+delta)^2+delta^2) - d peaks at
        sqrt(2)*delta (d=0) and dominates the lower side's delta."""
        return math.sqrt(2.0) * self.assign_delta


def grid_dims(bounds, resolution, max_dim=2048, warn_dim=1024,
              inclusive=True):
    """dims = ceil(range / res) + 1 nodes per axis.

    The reference uses ceil(range/res) (registration.cu:186-188), whose
    last node falls short of the bounding-box max corner so boundary
    queries clamp; the +1 here makes coverage inclusive
    (inclusive=False reproduces the reference dims for compat mode).
    Size-limit semantics match the reference (:191-198): hard error
    beyond max_dim, warn beyond warn_dim.
    """
    bounds = np.asarray(bounds, np.float64)
    extra = 1 if inclusive else 0
    dims = tuple(
        int(math.ceil((bounds[a, 1] - bounds[a, 0]) / resolution)) + extra
        for a in range(3))
    dims = tuple(max(d, 2) for d in dims)
    if any(d >= max_dim for d in dims):
        raise ValueError(
            f"Distance-field dims {dims} exceed the limit {max_dim}; "
            f"increase lut_resolution")
    # Flat gather indices (lookup/_trilinear) are int32: a field beyond
    # 2^31 cells would WRAP and silently return wrong distances — with
    # bf16 storage such a field can pass both the dimension cap and a
    # large-device HBM budget, so refuse it explicitly.
    if int(np.prod(dims)) >= 2 ** 31:
        raise ValueError(
            f"Distance-field dims {dims} exceed 2^31 cells (int32 gather "
            f"index range); use a coarser lut_resolution")
    if any(d >= warn_dim for d in dims):
        log.warning(f"Distance-field dims {dims} are large; consider a "
                    "coarser lut_resolution")
    return dims


def device_memory_budget() -> int:
    """Usable bytes on the default device: the allocator's limit on a
    GPU, the host's physical memory on the CPU.  An unknown device is an
    error, not a guess."""
    dev = jax.local_devices()[0]
    if dev.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    limit = int((dev.memory_stats() or {}).get("bytes_limit", 0))
    if limit <= 0:
        raise RuntimeError(
            f"cannot read the memory limit of device {dev.device_kind!r}; "
            f"pass hbm_budget explicitly")
    return limit


def check_memory_budget(dims, dtype, builder: str,
                        hbm_budget: Optional[int] = None):
    """Refuse field builds that cannot fit device memory.

    The reference only warns on grid DIMENSIONS (registration.cu:191-198);
    a dimension cap alone admits fields that exceed device memory outright
    (lut_max_dim=2048 is a 34 GB f32 grid).  The EDT
    builder's peak working set is ~2 live f32 copies of the grid
    (pass input + output; the chunked min-plus intermediate is bounded
    separately) plus the final storage-dtype copy; brute needs one f32
    copy plus storage.
    """
    n_cells = int(np.prod(dims))
    store = n_cells * jnp.dtype(dtype).itemsize
    f32_copies = 1 if builder in ("brute", "ref") else 2
    peak = n_cells * 4 * f32_copies + store
    budget = hbm_budget if hbm_budget is not None else device_memory_budget()
    # Leave headroom for clouds, bound-evaluation buffers, and allocator
    # fragmentation.
    usable = int(budget * 0.85)
    if peak > usable:
        raise ValueError(
            f"Distance field dims {tuple(dims)} needs ~{peak / 1e9:.1f} GB "
            f"to build (budget {usable / 1e9:.1f} GB): use a coarser "
            f"lut_resolution or a narrower lut_dtype (bfloat16 halves "
            f"storage)")
    return peak


def _nearest_node_idx(points, origin, inv_res, dims):
    """Clipped nearest-grid-node index [..., 3] for world points.

    Shared by the EDT seeding and lookup_nearest: the certificate's
    assign_delta bracket assumes both snap points to nodes IDENTICALLY,
    so the rounding/clamping lives in exactly one place.
    """
    x, y, z = dims
    c = (jnp.asarray(points, jnp.float32) - origin) * inv_res
    return jnp.clip(jnp.round(c).astype(jnp.int32),
                    jnp.zeros(3, jnp.int32),
                    jnp.asarray([x - 1, y - 1, z - 1], jnp.int32))


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("dims", "cell_chunk", "squared"))
def _build_brute(points, origin, resolution, dims, cell_chunk=32768,
                 squared=False):
    """Exact min distance from every grid node to the cloud (streamed).

    squared=True keeps d^2 (the reference's stored quantity)."""
    x, y, z = dims
    n_cells = x * y * z
    pad = (-n_cells) % cell_chunk
    lin = jnp.arange(n_cells + pad, dtype=jnp.int32)
    iz = lin % z
    iy = (lin // z) % y
    ix = lin // (z * y)
    coords = jnp.stack([ix, iy, iz], axis=-1).astype(jnp.float32)
    pos = origin[None, :] + coords * resolution
    d2 = jnp.maximum(nn_ops.nearest_sqdist(pos, points, q_chunk=cell_chunk),
                     0.0)
    vals = d2[:n_cells] if squared else jnp.sqrt(d2[:n_cells])
    return vals.reshape(dims)


def _minplus_1d(g, resolution, out_chunk=128, line_chunk=1024):
    """Exact 1D parabolic min-plus transform along the last axis.

    g: [L, n] squared distances; returns out[l, i] = min_j g[l, j] +
    ((i - j) * resolution)^2.  O(L * n^2) elementwise mins.

    Memory is bounded EXPLICITLY: lines are processed in chunks of
    `line_chunk` (lax.map over a reshaped [n_lc, lc, n] view) and outputs
    in chunks of `out_chunk`, so the largest intermediate is
    [line_chunk, n, out_chunk] floats regardless of L — at production
    scale (L = 10^6 lines of n = 10^3 at bunny's res-0.002 grid,
    registration.cu:186-198) relying on XLA to fuse a [L, n, oc]
    broadcast would gamble 0.5 TB of HBM on a fusion heuristic.
    """
    l, n = g.shape
    j_idx = jnp.arange(n, dtype=jnp.float32)
    n_pad = (-n) % out_chunk
    lc = min(line_chunk, l)
    l_pad = (-l) % lc

    def per_lines(gl):  # [lc, n] -> [lc, n + n_pad]
        def per_outchunk(k, acc):
            i0 = k * out_chunk
            i_idx = i0 + jnp.arange(out_chunk, dtype=jnp.float32)
            cost = ((i_idx[None, :] - j_idx[:, None]) * resolution) ** 2
            # [lc, n, 1] + [1, n, oc] -> min over j: one fused
            # reduction, intermediate bounded at lc * n * oc.
            vals = jnp.min(gl[:, :, None] + cost[None, :, :], axis=1)
            return jax.lax.dynamic_update_slice(acc, vals, (0, i0))

        out = jnp.zeros((gl.shape[0], n + n_pad), gl.dtype)
        return jax.lax.fori_loop(0, (n + n_pad) // out_chunk,
                                 per_outchunk, out)

    if l_pad:
        g = jnp.pad(g, [(0, l_pad), (0, 0)])
    out = jax.lax.map(per_lines, g.reshape(-1, lc, n))
    return out.reshape(l + l_pad, n + n_pad)[:l, :n]


@functools.partial(jax.jit, static_argnames=("dims", "out_chunk"))
def _build_edt(points, origin, resolution, dims, out_chunk=128):
    """Generalized exact EDT from point-seeded grid nodes (see module doc)."""
    x, y, z = dims
    # Seed: each point updates its nearest grid node with its exact squared
    # distance to that node (scatter-min).
    idx = _nearest_node_idx(points, origin[None, :], 1.0 / resolution, dims)
    node = origin[None, :] + idx.astype(jnp.float32) * resolution
    d2 = jnp.sum((points - node) ** 2, axis=-1)
    f = jnp.full((x, y, z), BIG, jnp.float32)
    f = f.at[idx[:, 0], idx[:, 1], idx[:, 2]].min(d2)

    # Separable min-plus passes: last axis, then cyclic transposes.
    f = _minplus_1d(f.reshape(x * y, z), resolution, out_chunk).reshape(x, y, z)
    f = jnp.transpose(f, (2, 0, 1))  # [Z, X, Y]
    f = _minplus_1d(f.reshape(z * x, y), resolution, out_chunk).reshape(z, x, y)
    f = jnp.transpose(f, (2, 0, 1))  # [Y, Z, X]
    f = _minplus_1d(f.reshape(y * z, x), resolution, out_chunk).reshape(y, z, x)
    f = jnp.transpose(f, (2, 0, 1))  # [X, Y, Z]
    return jnp.sqrt(jnp.maximum(f, 0.0))


def build(points, bounds, resolution, builder: str = "auto",
          dtype=jnp.float32, max_dim: int = 2048, warn_dim: int = 1024,
          brute_budget: float = 2.0e11,
          hbm_budget: Optional[int] = None) -> DistanceField:
    """Construct the distance field over `bounds` ([3, 2] min/max).

    builder: 'brute' (exact, zero slack), 'edt' (fast, node error <=
    sqrt(3/2) * res), 'auto' (brute iff cells * n_points fits the
    budget), or 'ref' (reference-compat d^2 field, module doc — read it
    only through lookup_ref_compat).

    Narrow storage dtypes record their RELATIVE rounding bound in
    `quant_eps` (NOT folded into any absolute slack): consumers must
    apply it multiplicatively per lookup (bounds.distance_estimates
    does) — the `slack` property covers the builder error only.
    """
    points = jnp.asarray(points, jnp.float32)
    bounds = np.asarray(bounds, np.float64)
    inclusive = builder != "ref"  # ref: ceil(range/res), no +1 node
    dims = grid_dims(bounds, resolution, max_dim=max_dim, warn_dim=warn_dim,
                     inclusive=inclusive)
    origin = jnp.asarray(bounds[:, 0], jnp.float32)
    n_cells = int(np.prod(dims))
    if builder == "auto":
        builder = "brute" if n_cells * points.shape[0] <= brute_budget else "edt"
    check_memory_budget(dims, dtype, builder, hbm_budget=hbm_budget)
    log.debug(f"Building distance field dims={dims} builder={builder}")
    if builder == "brute":
        vals = _build_brute(points, origin, jnp.float32(resolution), dims)
        delta = 0.0
    elif builder == "edt":
        # Each point seeds its NEAREST grid node: assignment radius =
        # half the cell diagonal.
        delta = (math.sqrt(3.0) / 2.0) * resolution
        vals = _build_edt(points, origin, jnp.float32(resolution), dims)
    elif builder == "ref":
        vals = _build_brute(points, origin, jnp.float32(resolution), dims,
                            squared=True)
        delta = 0.0  # no guarantee in compat mode (module doc)
    else:
        raise ValueError(f"Unknown distance-field builder: {builder}")
    vals = vals.astype(dtype)
    quant_eps = {jnp.dtype(jnp.bfloat16): 2.0 ** -8,
                 jnp.dtype(jnp.float16): 2.0 ** -11}.get(jnp.dtype(dtype), 0.0)
    if builder == "ref":
        quant_eps = 0.0  # compat mode carries no guarantee anyway
    return DistanceField(
        values=vals,
        origin=origin,
        inv_res=jnp.float32(1.0 / resolution),
        assign_delta=jnp.float32(delta),
        quant_eps=jnp.float32(quant_eps),
    )


# ---------------------------------------------------------------------------
# Lookup
# ---------------------------------------------------------------------------


def _trilinear(field: DistanceField, c):
    """Trilinear interpolation of stored values at grid coords c [..., 3]
    (already mapped/shifted); coordinates clamp to the border like
    cudaAddressModeClamp (registration.cu:226-228)."""
    x, y, z = field.values.shape
    maxc = jnp.asarray([x - 1, y - 1, z - 1], jnp.float32)
    c = jnp.clip(c, 0.0, maxc)
    i0 = jnp.minimum(c.astype(jnp.int32),
                     jnp.asarray([x - 2, y - 2, z - 2], jnp.int32))
    i0 = jnp.maximum(i0, 0)
    frac = c - i0.astype(jnp.float32)

    flat = field.values.reshape(-1)
    ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]

    def fetch(dx, dy, dz):
        lin = ((ix + dx) * y + (iy + dy)) * z + (iz + dz)
        return jnp.take(flat, lin, mode="clip").astype(jnp.float32)

    # Trilinear: lerp over z, then y, then x.
    c00 = fetch(0, 0, 0) * (1 - fz) + fetch(0, 0, 1) * fz
    c01 = fetch(0, 1, 0) * (1 - fz) + fetch(0, 1, 1) * fz
    c10 = fetch(1, 0, 0) * (1 - fz) + fetch(1, 0, 1) * fz
    c11 = fetch(1, 1, 0) * (1 - fz) + fetch(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def lookup(field: DistanceField, queries):
    """Trilinear distance lookup for queries [..., 3] (world coordinates).

    Out-of-box queries clamp to the border, reproducing the reference's
    cudaAddressModeClamp behavior (registration.cu:226-228).  The clamped
    value estimates d at the CLAMPED point; callers needing valid
    estimates at the query itself must fold in `box_excess` (see
    bounds.distance_estimates).
    """
    q = jnp.asarray(queries, jnp.float32)
    return _trilinear(field, (q - field.origin) * field.inv_res)


def lookup_nearest(field: DistanceField, queries):
    """Nearest-grid-node lookup: ONE gather per query instead of
    trilinear's eight.

    For the 1-Lipschitz stored field the worst-case error bound is
    IDENTICAL to trilinear's: the nearest node sits within
    (sqrt(3)/2) * res of the query (L-inf res/2 per axis), and the
    trilinear bound is the same sqrt(3)/2 * res (bounds.interp_slack —
    both peak at the cell center).  The reference uses trilinear because
    GPU texture hardware gives it for free (registration.cu:214-234); here
    a gather from device memory is the entire cost of a LUT query, so the
    certificate-equivalent single-gather form is ~8x less random
    traffic.  Out-of-box queries clamp like `lookup`.
    """
    x, y, z = field.values.shape
    idx = _nearest_node_idx(queries, field.origin, field.inv_res,
                            field.values.shape)
    lin = (idx[..., 0] * y + idx[..., 1]) * z + idx[..., 2]
    return jnp.take(field.values.reshape(-1), lin,
                    mode="clip").astype(jnp.float32)


def box_excess(field: DistanceField, queries):
    """Euclidean distance from each query to the field's node box.

    0 for in-box queries.  Because the target cloud lies inside the box,
    per-axis clamping toward it never moves away from any target point,
    so with q_c = clamp(q) and any target p:
        |q[a] - p[a]| >= |q_c[a] - p[a]|   per axis, and
        d(q)^2 >= d(q_c)^2 + ||q - q_c||^2  (clamped axes split exactly).
    Consumers use this to keep clamped-border lookups valid at q:
    d(q) <= d(q_c) + excess (1-Lipschitz) and the quadrature form above
    tightens the lower estimate for far-out queries — where the
    reference's texture clamp silently returns the border distance
    (registration.cu:226-228).
    """
    q = jnp.asarray(queries, jnp.float32)
    dims = jnp.asarray(field.values.shape, jnp.float32)
    hi = field.origin + (dims - 1.0) / field.inv_res
    out = jnp.maximum(jnp.maximum(field.origin - q, q - hi), 0.0)
    return jnp.sqrt(jnp.sum(out * out, axis=-1))


def lookup_ref_compat(field: DistanceField, queries):
    """Reference-compat lookup on a builder="ref" d^2 field.

    The reference maps the query by offset/scale and fetches tex3D
    directly (registration.cu:320-328); CUDA linear filtering samples
    texel centers at i+0.5, so the un-shifted mapping lands the query
    half a texel low — reproduced here as an explicit -0.5 shift.  The
    interpolated value is a squared distance (buildLUTKernel stores d^2);
    the bound math consumes sqrt of it (registration.cu:46-48).
    """
    q = jnp.asarray(queries, jnp.float32)
    c = (q - field.origin) * field.inv_res - 0.5
    d2 = _trilinear(field, c)
    return jnp.sqrt(jnp.maximum(d2, 0.0))
