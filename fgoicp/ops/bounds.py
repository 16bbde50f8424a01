"""Batched SE(3) bound evaluation — the hot kernel of Go-ICP.

Parity target: kernComputeBounds (/root/reference/fgoicp/registration.cu:
27-60) + the batched driver compute_sse_error(rnode, tnodes[], fix_rot,
streams) (:88-152).  Per (rotation node g, translation node b, source point
i) with q = R_g p_i + t_b and d an estimate of the distance from q to the
target:

    gamma_r[g,i] = rotation uncertainty radius (0 when rotation is fixed)
    gamma_t[g,b] = sqrt(3) * translation half-span
    ub[g,b] = sum_i relu(d_ub - gamma_r)^2
    lb[g,b] = sum_i relu(d_lb - gamma_r - gamma_t)^2

Design: where the reference launches one CUDA kernel per
translation node on 32 streams and thrust-reduces each, here ALL
(G rotation nodes x B translation nodes x ns points) evaluate in a single
fused XLA computation.  Distance estimates come from a pluggable backend:

* `proxy`  (default): exact NN against a farthest-point coreset by
  direct squared differences and a min-reduce (ops/coreset.py; the fused
  lane kernel ops/pallas_bounds.py on the GPU) — no gathers.
  d_ub = d_S(q) >= d_T(q); d_lb = d_S(q) - eps_cover, both strictly valid.
* `lut`: trilinear distance-field lookup (ops/distance_field.py) —
  the reference's approach; bound by random gathers.  With
  `conservative=True` the field+interpolation slack is folded in so
  bounds stay valid; with False it reproduces the reference's raw-lookup
  behavior (registration.cu:46).
* `exact`: proxy backend with the full target (eps = 0) — bounds tighter
  than any LUT, cost O(ns * nt) per node batch.

Trimming: with trim_keep = K < ns, per-node sums keep only the K smallest
per-point terms — valid bounds for the trimmed registration error (the
reference parses `trim` but never implements it; SURVEY §2 row 2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import jax
import jax.numpy as jnp

from . import coreset as coreset_ops
from . import distance_field as df_ops
from . import geometry as geo
from . import nn as nn_ops
from . import pallas_bounds


def _use_fused_kernel() -> bool:
    """The fused lane kernel (ops/pallas_bounds.py) runs where the NN
    kernels do: on the GPU."""
    return nn_ops.use_pallas()


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ProxyBackend:
    coreset: coreset_ops.ProxyCoreset


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LutBackend:
    field: df_ops.DistanceField
    conservative: bool = dataclasses.field(
        default=True, metadata={"static": True})
    # ref_compat: field was built with builder="ref" (stores d^2, no +1
    # node, half-texel-shifted lookup) — reproduces the reference LUT for
    # parity debugging; carries NO bound-validity guarantee.
    ref_compat: bool = dataclasses.field(
        default=False, metadata={"static": True})
    # lookup: "nearest" (default; 1 gather/query) or "trilinear"
    # (8 gathers, the reference's texture filtering).  The 1-Lipschitz
    # worst-case error bound is sqrt(3)/2 * res for BOTH (interp_slack /
    # distance_field.lookup_nearest docstrings), so the certificate is
    # unchanged; gathers are the whole cost of a LUT query.
    lookup: str = dataclasses.field(
        default="nearest", metadata={"static": True})

    @property
    def interp_slack(self):
        """Trilinear interpolation error bound for a 1-Lipschitz field.

        interp(q) is a convex combination of the 8 cell-corner values;
        each corner value differs from f(q) by at most ||q - c_i||, so
        |interp - f(q)| <= sum_i w_i ||q - c_i||.  By Jensen,
        (sum w_i ||q - c_i||)^2 <= sum w_i ||q - c_i||^2, and the
        right side factorizes per axis as sum_a f_a (1 - f_a) <= 3/4
        (f_a = the fractional coordinate; the 1D weighted second moment
        of {0, 1} about f is exactly f(1-f)).  Hence the bound is
        (sqrt(3)/2) * res — half the naive cell-diagonal bound, attained
        at the cell center.
        """
        return (geo.SQRT3 / 2.0) / self.field.inv_res


Backend = Union[ProxyBackend, LutBackend]


def make_backend(target, kind: str = "proxy", proxy_size: int = 4096,
                 field: Optional[df_ops.DistanceField] = None,
                 conservative: bool = True, ref_compat: bool = False,
                 lookup: str = "auto", seed: int = 0) -> Backend:
    """Build a distance backend over the (normalized) target cloud."""
    if kind == "proxy":
        return ProxyBackend(
            coreset=coreset_ops.build(target, size=proxy_size, seed=seed))
    if kind == "exact":
        cs = coreset_ops.ProxyCoreset(
            points=jnp.asarray(target, jnp.float32), eps=jnp.float32(0.0))
        return ProxyBackend(coreset=cs)
    if kind == "lut":
        assert field is not None, "lut backend requires a built DistanceField"
        cons = conservative and not ref_compat
        if lookup == "auto":
            # Certificate-equivalent single-gather form when the slack
            # is folded anyway; trilinear (the reference's filtering)
            # when reproducing raw-lookup behavior.
            lookup = "nearest" if cons else "trilinear"
        if lookup not in ("nearest", "trilinear"):
            raise ValueError(f"Unknown lut lookup mode: {lookup!r}")
        return LutBackend(field=field, conservative=cons,
                          ref_compat=ref_compat, lookup=lookup)
    raise ValueError(f"Unknown bound backend: {kind}")


def gamma_arrays(norms, rot_spans, fix_rot, ref_compat: bool = False,
                 point_deltas=None):
    """Per-(group, point) radii (gam_ub, gam_lb) subtracted from d in the
    upper/lower bound terms.

    Plain point sources: both equal the rotation uncertainty radius
    (zeroed for fixed-rotation groups).  With weighted source clusters of
    radius delta (coreset.SourceClusters), the true per-member distance
    lies within +-delta of the representative's and the member norm
    within +-delta, so
        gam_ub = gamma(max(|q| - delta, 0)) - delta     (term overestimate)
        gam_lb = gamma(|q| + delta) + delta             (term underestimate)
    keep both bounds valid for the cluster sums.
    """
    spans = jnp.asarray(rot_spans, jnp.float32)[:, None]
    fix = jnp.asarray(fix_rot)[:, None]
    if point_deltas is None:
        g = geo.rotation_uncertainty_radius(norms[None, :], spans,
                                            ref_compat=ref_compat)
        g = jnp.where(fix, 0.0, g)
        return g, g
    d = jnp.asarray(point_deltas, jnp.float32)[None, :]
    g_min = geo.rotation_uncertainty_radius(
        jnp.maximum(norms[None, :] - d, 0.0), spans, ref_compat=ref_compat)
    g_max = geo.rotation_uncertainty_radius(
        norms[None, :] + d, spans, ref_compat=ref_compat)
    gam_ub = jnp.where(fix, 0.0, g_min) - d
    gam_lb = jnp.where(fix, 0.0, g_max) + d
    return gam_ub, gam_lb


def distance_estimates(backend: Backend, queries):
    """(d_ub, d_lb) per query: d_lb <= d_target(q) <= d_ub."""
    if isinstance(backend, ProxyBackend):
        shape = queries.shape[:-1]
        d2 = nn_ops.nearest_sqdist(queries.reshape(-1, 3),
                                   backend.coreset.points)
        d = jnp.sqrt(jnp.maximum(d2, 0.0)).reshape(shape)
        return d, d - backend.coreset.eps
    if isinstance(backend, LutBackend):
        if backend.ref_compat:
            d = df_ops.lookup_ref_compat(backend.field, queries)
            return d, d  # reference behavior: raw lookup, no slack
        d = (df_ops.lookup_nearest(backend.field, queries)
             if backend.lookup == "nearest"
             else df_ops.lookup(backend.field, queries))
        if backend.conservative:
            # Asymmetric per-lookup-tight bracket (DistanceField error
            # model): with stored node value s, interpolated lookup L at
            # the CLAMPED query q_c, quantization |quantized - s| <=
            # qe * s, interpolation |interp - s(q_c)| <= iota, and the
            # EDT seeding bracket
            #   d(q_c) - delta <= s(q_c) <= sqrt((d(q_c)+delta)^2 + delta^2),
            # the true NN distance at q_c satisfies
            #   d(q_c) <= L/(1-qe) + iota + delta
            #   d(q_c) >= relu(sqrt(relu((L/(1+qe) - iota)^2 - delta^2))
            #             - delta).
            # The lower form inverts the upper bracket (monotone in s),
            # asymptotically delta tighter than the symmetric worst case
            # sqrt(2)*delta used before round 3.  Out-of-box queries
            # (exc = box_excess > 0) extend the bracket to q itself:
            #   d(q) <= d(q_c) + exc             (1-Lipschitz)
            #   d(q)^2 >= d(q_c)^2 + exc^2       (per-axis clamp split)
            # — the second line is TIGHTER than the border distance the
            # reference's texture clamp returns (registration.cu:226-228).
            qe = backend.field.quant_eps
            iota = backend.interp_slack
            delta = backend.field.assign_delta
            exc = df_ops.box_excess(backend.field, queries)
            s_up = d / (1.0 - qe) + iota
            s_lo = jnp.maximum(d / (1.0 + qe) - iota, 0.0)
            d_ub = s_up + delta + exc
            lb_c = jnp.maximum(
                jnp.sqrt(jnp.maximum(s_lo ** 2 - delta ** 2, 0.0)) - delta,
                0.0)
            d_lb = jnp.sqrt(lb_c ** 2 + exc ** 2)
            return d_ub, d_lb
        return d, d
    raise TypeError(f"Unknown backend type: {type(backend)}")


def _dropsum_bracket(x, k, mode, points_axis=None, iters=26):
    """Bracket the sum of the k largest entries of x (last axis) by
    threshold bisection — no sort / top-k: 26 counting passes over the
    terms instead of a per-lane sort.

    Entries are weighted squared bound terms (>= 0 on real lanes; padded
    lanes are 0 after weighting or -BIG sentinels), so the threshold
    domain is [0, max].  The loop maintains count(x > hi) < k and, unless
    fewer than k entries are positive (then lo pins at 0 and both forms
    return exactly the sum of the positive entries), count(x > lo) >= k.

    mode="over": returns S >= the exact top-k sum.  S = sum(x > lo) +
      (k - cnt_lo) * lo removes only (cnt_lo - k) * lo from a sum whose
      cnt_lo - k surplus entries each exceed lo.  Subtracting S from a
      lower-bound total keeps the trimmed lb sound.
    mode="under": returns S <= the exact top-k sum.  The true top-k
      contains every entry above hi plus (k - cnt_hi) more entries, each
      > lo, so S = sum(x > hi) + (k - cnt_hi) * lo undercounts it.
      Subtracting S from an upper-bound total keeps the trimmed ub valid.

    After `iters` halvings the [lo, hi] gap is max * 2^-iters — below f32
    resolution at 26 — so both forms are exact up to threshold ties.
    Composes exactly over a sharded points axis: thresholds depend only
    on psum'd global counts, so every shard walks the same bisection and
    the result equals the single-device reduction (up to psum f32 order).
    """
    def _ps(v):
        return jax.lax.psum(v, points_axis) if points_axis else v
    kf = jnp.float32(k)
    lo = jnp.zeros(x.shape[:-1], jnp.float32)
    hi = jnp.max(jnp.maximum(x, 0.0), axis=-1)
    if points_axis:
        hi = jax.lax.pmax(hi, points_axis)

    def body(c, _):
        lo, hi = c
        mid = 0.5 * (lo + hi)
        cnt = _ps(jnp.sum((x > mid[..., None]).astype(jnp.float32), -1))
        ge = cnt >= kf
        return (jnp.where(ge, mid, lo), jnp.where(ge, hi, mid)), None

    (lo, hi), _ = jax.lax.scan(body, (lo, hi), None, length=iters)
    t = lo if mode == "over" else hi
    above = x > t[..., None]
    s = _ps(jnp.sum(jnp.where(above, x, 0.0), -1))
    cnt = _ps(jnp.sum(above.astype(jnp.float32), -1))
    return s + (kf - cnt) * lo


def reduce_point_terms(pt, point_weights, trim_keep, points_axis,
                       trim_ns: Optional[int] = None,
                       drop_mode: str = "exact"):
    """Reduce per-point bound terms [..., ns] to per-node sums.

    Handles, in combination: per-point weights (real-valued for source
    clusters, or a 0/1 padding mask), point-axis sharding (partial sums
    psum'd over `points_axis`), and trimming (`trim_keep` smallest terms
    kept).  Trimming composes with sharding via an exact global top-k of
    the dropped (largest) terms: each shard contributes its local top-k
    candidates, an all-gather + second top-k selects the true global
    largest, and their sum is subtracted from the psum'd total —
    equivalent to a single-device top-k over the full point set.  With
    trimming, the drop candidates are the WEIGHTED terms (pt * w), so
    with a 0/1 padding mask — the only combination the engine produces;
    clusters and trimming are mutually exclusive upstream — the result
    equals exact trimming over the real lanes, and with general weights
    it is still the well-defined "total minus the n_drop largest
    weighted terms" (total and drops use the same quantity, so the
    subtraction can never exceed the weighted total it came from).
    `trim_ns` must give the GLOBAL count of real (weight>0) points.

    drop_mode selects the drop-sum reduction: "exact" (top-k / gathered
    global top-k) or the directional bisection bracket (_dropsum_bracket)
    — "over" for lower-bound terms (drop sum overestimated, lb stays
    sound), "under" for upper-bound terms (drop sum underestimated, ub
    stays valid).  The bracket is exact up to f32 threshold ties.
    """
    ns_local = pt.shape[-1]
    if point_weights is not None:
        w = jnp.asarray(point_weights, jnp.float32)
        w = jnp.broadcast_to(w, pt.shape[-1:])
        pt = pt * w
        total = jnp.sum(pt, axis=-1)
        masked = jnp.where(w > 0, pt, -jnp.float32(nn_ops.BIG))
    else:
        total = jnp.sum(pt, axis=-1)
        masked = pt
    if points_axis is not None:
        total = jax.lax.psum(total, points_axis)
    if trim_keep is None:
        return total
    ns_total = trim_ns if trim_ns is not None else ns_local
    n_drop = ns_total - trim_keep
    if n_drop <= 0:
        return total
    if drop_mode != "exact":
        drop = _dropsum_bracket(masked, n_drop, drop_mode, points_axis)
        return total - jnp.maximum(drop, 0.0)
    k_local = min(n_drop, ns_local)
    top = jax.lax.top_k(masked, k_local)[0]
    if points_axis is not None:
        top = jax.lax.all_gather(top, points_axis,
                                 axis=top.ndim - 1, tiled=True)
        top = jax.lax.top_k(top, n_drop)[0]
    # Squared terms are >= 0, so clamping removes any -BIG mask sentinels
    # that slipped into the candidate set on nearly-all-padding shards.
    return total - jnp.sum(jnp.maximum(top, 0.0), axis=-1)


def _weighted_drop_sum(values, weights, n_drop):
    """Greedy maximum total of n_drop member terms, where cluster j holds
    weights[j] members each contributing values[j] (values [..., K],
    weights [K] or [..., K]).  Sort clusters by value descending and take
    members until the n_drop budget is spent — the exact maximum because
    all members of a cluster share one value."""
    w = jnp.broadcast_to(jnp.asarray(weights, jnp.float32), values.shape)
    order = jnp.argsort(-values, axis=-1)
    v = jnp.take_along_axis(values, order, axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    cum = jnp.cumsum(w, axis=-1)
    take = jnp.clip(jnp.float32(n_drop) - (cum - w), 0.0, w)
    return jnp.sum(v * take, axis=-1)


def reduce_clustered_trimmed(lb_pt, ub_pt, point_weights, trim_keep,
                             trim_ns, points_axis=None):
    """Trimmed bounds over weighted source clusters.

    The trimmed objective drops the n_drop = trim_ns - trim_keep largest
    per-MEMBER terms.  With per-member bracketing lb_j <= true_j <= ub_j
    (gamma_arrays folds the cluster radius into both):

      trimmed_true  =  total_true - drop_true
      total_true   >=  sum_j w_j lb_j,
      drop_true    <=  greedy-top-n_drop of member UB terms,
      drop_true    >=  greedy-top-n_drop of member LB terms
        (the true terms of the members maximizing the lb selection are
         each >= their lb, and drop_true maximizes over all selections),

    so lb = sum w*lb - dropUB and ub = sum w*ub - dropLB are valid
    trimmed lower/upper bounds.  Under point-axis sharding the cluster
    arrays are small ([K] per lane), so the exact reduction all-gathers
    them and runs the identical greedy on every shard.

    Returns (lb, ub) with lb clamped at 0 (squared-term objective).
    """
    w = jnp.asarray(point_weights, jnp.float32)
    total_lb = jnp.sum(lb_pt * w, axis=-1)
    total_ub = jnp.sum(ub_pt * w, axis=-1)
    if points_axis is not None:
        total_lb = jax.lax.psum(total_lb, points_axis)
        total_ub = jax.lax.psum(total_ub, points_axis)
        ax = lb_pt.ndim - 1
        lb_pt = jax.lax.all_gather(lb_pt, points_axis, axis=ax, tiled=True)
        ub_pt = jax.lax.all_gather(ub_pt, points_axis, axis=ax, tiled=True)
        w = jax.lax.all_gather(w, points_axis, axis=0, tiled=True)
    n_drop = trim_ns - trim_keep
    if n_drop <= 0:
        return total_lb, total_ub
    lb = jnp.maximum(total_lb - _weighted_drop_sum(ub_pt, w, n_drop), 0.0)
    ub = total_ub - _weighted_drop_sum(lb_pt, w, n_drop)
    return lb, ub


def evaluate_bounds(backend: Backend, pcs, R, rot_spans, fix_rot, t_centers,
                    t_spans, node_mask=None, ref_compat_gamma: bool = False,
                    trim_keep: Optional[int] = None,
                    points_axis: Optional[str] = None,
                    point_weights=None, point_deltas=None,
                    trim_ns: Optional[int] = None):
    """Evaluate lb/ub for a [G, B] grid of (rotation, translation) nodes.

    pcs:       [ns, 3] normalized source points.
    R:         [G, 3, 3] rotation of each group.
    rot_spans: [G] rotation cube half-spans (gamma_r inputs).
    fix_rot:   [G] bool — True lanes evaluate with gamma_r = 0 (the
               reference's fix_rot=true upper-bound pass).
    t_centers: [G, B, 3]; t_spans: [G, B] translation nodes per group.
    node_mask: [G, B] bool — False lanes return (inf, inf).
    points_axis: mesh axis name when `pcs` holds only this device's shard
               of the source points — per-point partial sums are psum'd
               over that axis (sequence-parallel bound evaluation,
               SURVEY §5).  Composes with trim_keep via an exact global
               top-k of the dropped terms (reduce_point_terms).
    point_weights: [ns] per-point weights multiplying both bound terms
               (0 marks padding lanes added to make ns divisible by the
               points-axis size).  With trim_keep, must be a 0/1 mask
               and trim_ns must give the global real point count.
    trim_ns:   global count of real source points (static) — required
               when trim_keep is combined with points_axis.
    Returns (lb [G, B], ub [G, B]).
    """
    clustered_trim = trim_keep is not None and point_deltas is not None
    if clustered_trim and (point_weights is None or trim_ns is None):
        raise ValueError(
            "clustered trimming needs point_weights (member counts) and "
            "trim_ns (global member count)")
    if trim_keep is not None and points_axis is not None and trim_ns is None:
        raise ValueError(
            "trim_keep with point sharding needs trim_ns (global real "
            "point count)")
    pcs = jnp.asarray(pcs, jnp.float32)
    R = jnp.asarray(R, jnp.float32)
    norms = jnp.linalg.norm(pcs, axis=-1)  # [ns]

    # Per-(group, point) radii; 0 where rotation is fixed
    # (registration.cu:36-44 + SURVEY quirk list for the ref-compat form).
    gam_ub, gam_lb = gamma_arrays(norms, rot_spans, fix_rot,
                                  ref_compat=ref_compat_gamma,
                                  point_deltas=point_deltas)
    gam_t = geo.translation_uncertainty_radius(jnp.asarray(t_spans))  # [G, B]

    base = jnp.einsum("grc,nc->gnr", R, pcs,
                      precision=jax.lax.Precision.HIGHEST)  # [G, ns, 3]

    if (isinstance(backend, ProxyBackend) and trim_keep is None
            and _use_fused_kernel()):
        # The [G, B] grid flattened into G * B lanes of the lane kernel.
        g, b = gam_t.shape
        lb, ub = pallas_bounds.fused_bounds_lanes(
            base, jnp.repeat(jnp.arange(g, dtype=jnp.int32), b),
            jnp.asarray(t_centers, jnp.float32).reshape(g * b, 3),
            backend.coreset.points, gam_ub, gam_t.reshape(g * b),
            backend.coreset.eps, point_weights=point_weights,
            gam_lb=gam_lb)
        lb, ub = lb.reshape(g, b), ub.reshape(g, b)
        if points_axis is not None:
            ub = jax.lax.psum(ub, points_axis)
            lb = jax.lax.psum(lb, points_axis)
    else:
        q = base[:, None, :, :] \
            + jnp.asarray(t_centers, jnp.float32)[:, :, None, :]
        d_ub, d_lb = distance_estimates(backend, q)         # [G, B, ns]

        ub_pt = jnp.square(jnp.maximum(d_ub - gam_ub[:, None, :], 0.0))
        lb_pt = jnp.square(jnp.maximum(
            d_lb - gam_lb[:, None, :] - gam_t[:, :, None], 0.0))
        if clustered_trim:
            lb, ub = reduce_clustered_trimmed(
                lb_pt, ub_pt, point_weights, trim_keep, trim_ns,
                points_axis)
        else:
            ub = reduce_point_terms(ub_pt, point_weights, trim_keep,
                                    points_axis, trim_ns, drop_mode="under")
            lb = reduce_point_terms(lb_pt, point_weights, trim_keep,
                                    points_axis, trim_ns, drop_mode="over")
    if node_mask is not None:
        big = jnp.float32(nn_ops.BIG)
        ub = jnp.where(node_mask, ub, big)
        lb = jnp.where(node_mask, lb, big)
    return lb, ub
