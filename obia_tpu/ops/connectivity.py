"""Connected-component labelling and small-segment merging on the device.

The reference inherits connectivity enforcement from skimage's Cython
``_enforce_label_connectivity_cython`` (called inside ``slic``, reference
segment_boundaries.py:51). A sequential BFS doesn't map to an
accelerator, and the classic parallel substitute (pointer-jumping
union-find) is gather-bound — random access is the slowest operation per
element. The production design here is therefore GATHER-FREE:

* ``scan_connected_components`` / ``scan_ccl_dense_labels``: alternating
  bidirectional SEGMENTED MIN-SCANS along rows and columns
  (Hillis-Steele doubling over shifted copies — shifts, ``min``, ``and``
  only), iterated to an on-device fixpoint. Compact superpixels converge
  in a few alternations.
* ``merge_small_device``: sub-``min_size`` segments adopt their min
  adjacent label over the deduplicated label-adjacency EDGE LIST (the
  region-adjacency graph of connected regions is planar, so E < 3K and
  a static 4·K_pad array holds it) — sweep cost independent of raster
  size; an uncapped final phase guarantees no sub-minimum orphans.

Roots are minimum linear indices, so compacting roots in ascending order
reproduces deterministic raster-order first-occurrence labelling.
``connected_components`` (FastSV pointer-jumping, guaranteed O(log n))
is the exact fallback for label maps whose components out-snake the
scan-CCL alternation cap. The sharded mosaic reuses the scan CCL per
shard and the edge-domain merge LUT loop (``merge_lut_from_edges``) with
cross-shard seam edges (:mod:`obia_tpu.parallel.sharded`).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_NEIGHBOR_OFFSETS_4 = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _shift2d(arr: jnp.ndarray, dr: int, dc: int, fill) -> jnp.ndarray:
    H, W = arr.shape
    pt, pb = max(-dr, 0), max(dr, 0)
    plft, prt = max(-dc, 0), max(dc, 0)
    padded = jnp.pad(arr, ((pt, pb), (plft, prt)), constant_values=fill)
    return jax.lax.dynamic_slice(padded, (pt + dr, plft + dc), (H, W))


def _ccl_iters(n: int) -> int:
    """Fixed sweep count for the FastSV loop: hooking + shortcutting
    converges in O(log n) rounds; a small pad covers the constants. A fixed
    count keeps the whole loop on device — a convergence-checked while_loop
    forces a host sync per iteration, which can cost more than the
    milliseconds of compute it saves."""
    import math
    return max(6, math.ceil(math.log2(max(n, 2)))) + 4


@jax.jit
def connected_components(labels: jnp.ndarray) -> jnp.ndarray:
    """4-connected components of a multi-valued label map via FastSV
    (min-based stochastic + aggressive hooking, then shortcutting) —
    guaranteed O(log n) sweeps, all scatter/gather, fixed trip count.

    Args:
      labels: (H, W) int32; negative = invalid (stays its own root).
    Returns:
      (H, W) int32 component roots (min linear index per component);
      invalid pixels get root -1.
    """
    H, W = labels.shape
    n = H * W
    idx = jnp.arange(n, dtype=jnp.int32)
    lab_flat = labels.reshape(-1)
    valid = lab_flat >= 0

    def neighbor_min_grandparent(f):
        """Per pixel: min of f[f[v]] over 4-neighbours v with the same
        label (and the pixel itself)."""
        safe = jnp.where(valid, f, 0)
        gp = jnp.where(valid, f[safe], n)  # grandparent, n = +inf sentinel
        gp2d = gp.reshape(H, W)
        best = gp2d
        for dr, dc in _NEIGHBOR_OFFSETS_4:
            nl = _shift2d(labels, dr, dc, fill=-2)
            ngp = _shift2d(gp2d, dr, dc, fill=n)
            same = (nl == labels)
            best = jnp.minimum(best, jnp.where(same, ngp, n))
        return best.reshape(-1)

    def body(_, f):
        mngf = neighbor_min_grandparent(f)
        fsafe = jnp.where(valid, f, 0)
        # stochastic hooking: f[f[u]] <- min(f[f[u]], mngf[u])
        f = f.at[jnp.where(valid, fsafe, n)].min(
            jnp.where(valid, mngf, n), mode="drop")
        # aggressive hooking: f[u] <- min(f[u], mngf[u])
        f = jnp.where(valid & (mngf < n), jnp.minimum(f, mngf), f)
        # shortcutting: f[u] <- f[f[u]]
        fsafe = jnp.where(valid, f, 0)
        f = jnp.where(valid, f[fsafe], f)
        return f

    f0 = jnp.where(valid, idx, -1)
    f = jax.lax.fori_loop(0, _ccl_iters(n), body, f0)
    # final path compression
    for _ in range(2):
        fsafe = jnp.where(valid, f, 0)
        f = jnp.where(valid, f[fsafe], f)
    return f.reshape(H, W)


# ---------------------------------------------------------------------------
# Gather-free connected components: alternating bidirectional SEGMENTED
# MIN-SCANS along rows and columns (Hillis-Steele doubling over shifted
# copies — pure shift/min/and ops, no gathers or scatters). The
# pointer-jump formulation pays a full-raster random-access gather per
# hop; the scan formulation is plain memory-bandwidth vector work. Each
# full row+col alternation extends a
# component's min along one more "leg" of any monotone path; a device
# while_loop iterates to the fixpoint. Compact superpixels converge in
# a few alternations at small scale, but the alternation count grows with
# the raster-wide staircase depth — above
# _FUSE_CCL_MAX_PIXELS the TILED variant below bounds both the
# alternation count and the doubling depth by breaking runs at block
# lines and unioning the block-local pieces on the K-sized seam graph.
# ---------------------------------------------------------------------------


def _axis_run_min(comp: jnp.ndarray, same_prev: jnp.ndarray,
                  axis: int, bound: int = 0) -> jnp.ndarray:
    """Min over each equal-label RUN along ``axis``, written to every
    pixel of the run. ``same_prev``: same-label-as-previous mask along
    the axis (position 0 False). log2(L) doubling steps per direction.
    ``bound`` > 0 asserts runs never exceed it (the caller broke them at
    block lines), so the doubling stops at log2(bound) steps."""
    L = comp.shape[axis]
    limit = min(L, bound) if bound else L
    INF = jnp.int32(np.iinfo(np.int32).max)

    def shift_fwd(a, d, fill):
        # a2[i] = a[i - d] along axis
        return jnp.roll(a, d, axis=axis).at[
            (slice(None),) * axis + (slice(0, d),)].set(fill)

    def shift_bwd(a, d, fill):
        return jnp.roll(a, -d, axis=axis).at[
            (slice(None),) * axis + (slice(L - d, L),)].set(fill)

    # forward prefix min within runs
    v = comp
    ok = same_prev
    d = 1
    while d < limit:
        v = jnp.minimum(v, jnp.where(ok, shift_fwd(v, d, INF), INF))
        ok = ok & shift_fwd(ok, d, False)
        d *= 2
    fwd = v
    # backward prefix min within runs (same_next = shifted same_prev)
    same_next = shift_bwd(same_prev, 1, False)
    v = comp
    ok = same_next
    d = 1
    while d < limit:
        v = jnp.minimum(v, jnp.where(ok, shift_bwd(v, d, INF), INF))
        ok = ok & shift_bwd(ok, d, False)
        d *= 2
    return jnp.minimum(fwd, v)


def _same_masks(labels: jnp.ndarray, block: int = 0):
    """(same-as-left, same-as-up) run masks; ``block`` > 0 additionally
    breaks runs at block lines (positions where index % block == 0)."""
    H, W = labels.shape
    same_l = jnp.concatenate(
        [jnp.zeros((H, 1), bool),
         (labels[:, 1:] == labels[:, :-1]) & (labels[:, 1:] >= 0)], axis=1)
    same_u = jnp.concatenate(
        [jnp.zeros((1, W), bool),
         (labels[1:, :] == labels[:-1, :]) & (labels[1:, :] >= 0)], axis=0)
    if block:
        keep_c = (jnp.arange(W, dtype=jnp.int32) % block != 0)[None, :]
        keep_r = (jnp.arange(H, dtype=jnp.int32) % block != 0)[:, None]
        same_l = same_l & keep_c
        same_u = same_u & keep_r
    return same_l, same_u


def _scan_ccl_pass(labels: jnp.ndarray, comp: jnp.ndarray,
                   block: int = 0) -> jnp.ndarray:
    """One full alternation: row-run min then column-run min."""
    same_l, same_u = _same_masks(labels, block)
    comp = _axis_run_min(comp, same_l, axis=1, bound=block)
    return _axis_run_min(comp, same_u, axis=0, bound=block)


def _scan_ccl_max_alternations(H: int, W: int) -> int:
    """Alternation cap for the scan-CCL fixpoint loop. Each alternation
    propagates a component's min across at least one full row run and one
    full column run, so spirals need ~min(H, W) alternations and diagonal
    staircases ~(H+W)/2; H+W covers both with margin. Pathological
    space-filling components (Hilbert-curve snakes) can exceed ANY
    shape-linear cap — callers must check the returned ``converged`` flag
    and fall back to the O(log n) FastSV path (see
    :func:`fastsv_dense_labels`)."""
    return max(129, H + W + 8)


@functools.partial(jax.jit, static_argnames=("block",))
def _scan_ccl(labels: jnp.ndarray, block: int = 0):
    """Scan-CCL fixpoint loop (runs break at ``block`` lines when > 0).
    Returns ((H, W) int32 roots, converged)."""
    H, W = labels.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    valid = labels >= 0
    comp0 = jnp.where(valid, yy * W + xx, jnp.int32(2 ** 31 - 1))  # INF pad
    cap = (max(129, 2 * block + 8) if block
           else _scan_ccl_max_alternations(H, W))

    def cond(carry):
        _, changed, i = carry
        return changed & (i < cap)

    def body(carry):
        comp, _, i = carry
        nxt = _scan_ccl_pass(labels, comp, block=block)
        return nxt, (nxt != comp).any(), i + 1

    # derive the initial flag from comp0 so it inherits any shard_map
    # varying axes (a plain jnp.asarray(True) carry fails the while_loop
    # type check under shard_map)
    true0 = comp0[0, 0] == comp0[0, 0]
    comp, changed, _ = jax.lax.while_loop(
        cond, body, (comp0, true0, jnp.int32(0)))
    return jnp.where(valid, comp, -1), ~changed


def _scan_ccl_exact(labels: jnp.ndarray) -> jnp.ndarray:
    """Scan-CCL roots with the FastSV fallback applied on device when the
    alternation cap is hit — always-correct roots, no host sync. Both
    branches compile; only one executes."""
    comp, converged = _scan_ccl(labels)
    return jax.lax.cond(converged, lambda c: c,
                        lambda _: connected_components(labels), comp)


def scan_connected_components(labels: jnp.ndarray) -> jnp.ndarray:
    """4-connected components of a label map via alternating segmented
    min-scans, iterated to the fixpoint on device; label maps whose
    components out-snake the alternation cap fall back to the exact
    FastSV path on device (no silent splits).

    Args:
      labels: (H, W) int32; negative = invalid (own root, output -1).
    Returns:
      (H, W) int32 component roots (min linear index per component).
    """
    return _scan_ccl_exact(labels)


@jax.jit
def fastsv_dense_labels(labels: jnp.ndarray):
    """Exact-fallback CCL + dense relabel: FastSV pointer-jumping
    (guaranteed O(log n) sweeps, gather-bound but always correct) for the
    rare label maps whose components out-snake the scan-CCL alternation
    cap. Returns ((H, W) int32 dense 0..K-1 / -1, K)."""
    comp = connected_components(labels)
    lab_flat, k_dev = _dense_relabel_device(comp.reshape(-1))
    return lab_flat.reshape(labels.shape), k_dev


@jax.jit
def scan_ccl_dense_labels(labels: jnp.ndarray):
    """Scan-CCL + dense first-occurrence relabel in one program:
    (H, W) labels -> ((H, W) int32 dense 0..K-1 / -1, K, converged).
    When ``converged`` comes back False the labels are SPLIT (a
    snaking component needed more alternations than the cap) — rerun
    via :func:`fastsv_dense_labels`."""
    comp, converged = _scan_ccl(labels)
    lab_flat, k_dev = _dense_relabel_device(comp.reshape(-1))
    return lab_flat.reshape(labels.shape), k_dev, converged


# ---------------------------------------------------------------------------
# Tiled scan-CCL for LARGE rasters. The global scan's alternation count is
# the raster-wide staircase depth and every doubling runs to log2(axis).
# Breaking runs at block lines bounds both: in-block alternations and
# log2(block) doubling steps, at identical full-raster per-step cost. The
# cross-block piece equivalences then resolve on a K-sized graph (pairs =
# the block seam lines only). Final numbering is the SAME rule (ascending
# min linear index per true component): piece ids are first-occurrence
# ordered, so the class-min piece id orders classes identically — the
# result is bitwise-equal to scan_ccl_dense_labels.
# ---------------------------------------------------------------------------

# On a dusty 100 MP x 8-band assignment (millions of raw fragments) the
# in-block alternation count GROWS with block size (dust snakes out-run
# small blocks less) while the per-alternation cost grows with
# log2(block), and the seam union grows as blocks shrink; 32 balanced the
# two on the hardware it was first tuned on. Re-probe on the GPU with
# tools/probe_ccl_merge.py before changing it (ROADMAP A5).
_TILED_CCL_BLOCK = 32


@functools.partial(jax.jit, static_argnames=("block",))
def _tiled_ccl_local(labels: jnp.ndarray, block: int):
    """Block-local scan-CCL + dense piece relabel. Returns
    ((H, W) int32 piece ids / -1 invalid, n_pieces, converged)."""
    comp, converged = _scan_ccl(labels, block=block)
    piece_flat, k = _dense_relabel_device(comp.reshape(-1))
    return piece_flat.reshape(labels.shape), k, converged


@functools.partial(jax.jit, static_argnames=("K_pad", "block"))
def _tiled_ccl_union(piece: jnp.ndarray, labels: jnp.ndarray,
                     k: jnp.ndarray, K_pad: int, block: int):
    """Union block-local pieces across block seam lines (FastSV-style
    min hooking + shortcutting on the K-sized piece graph), then dense
    final relabel. Returns ((H, W) labels, K, converged)."""
    H, W = piece.shape
    SEN = jnp.int32(K_pad)

    def seam_pairs(a_p, b_p, a_l, b_l):
        ok = (a_l == b_l) & (a_l >= 0)
        return (jnp.where(ok, a_p, SEN).reshape(-1),
                jnp.where(ok, b_p, SEN).reshape(-1))

    pa_parts, pb_parts = [], []
    nb_r = (H - 1) // block
    if nb_r:
        p, q = seam_pairs(piece[block - 1::block][:nb_r],
                          piece[block::block][:nb_r],
                          labels[block - 1::block][:nb_r],
                          labels[block::block][:nb_r])
        pa_parts.append(p)
        pb_parts.append(q)
    nb_c = (W - 1) // block
    if nb_c:
        p, q = seam_pairs(piece[:, block - 1::block][:, :nb_c],
                          piece[:, block::block][:, :nb_c],
                          labels[:, block - 1::block][:, :nb_c],
                          labels[:, block::block][:, :nb_c])
        pa_parts.append(p)
        pb_parts.append(q)

    iota = jnp.arange(K_pad, dtype=jnp.int32)
    if not pa_parts:  # single block: pieces are final components
        is_root = iota < k
        rank = jnp.cumsum(is_root.astype(jnp.int32)) - 1
        lab = jnp.where(piece >= 0,
                        rank[jnp.clip(piece, 0, K_pad - 1)], -1)
        return lab, is_root.sum(), piece[0, 0] == piece[0, 0]

    pa = jnp.concatenate(pa_parts)
    pb = jnp.concatenate(pb_parts)
    parent0 = jnp.arange(K_pad + 1, dtype=jnp.int32)  # slot K_pad: sentinel

    def cond(carry):
        _, changed, i = carry
        return changed & (i < 64)

    def body(carry):
        parent, _, i = carry
        ra = parent[pa]
        rb = parent[pb]
        lo = jnp.minimum(ra, rb)  # sentinel pairs: ra = rb = lo = K_pad
        p2 = parent.at[ra].min(lo).at[rb].min(lo)
        # multiple shortcut hops per sweep: each is a K-sized gather,
        # cheaper than a full seam sweep — piece CHAINS (dust snaking
        # across many blocks) otherwise propagate one hop per sweep
        p2 = p2[p2]
        p2 = p2[p2]
        p2 = p2[p2]
        return p2, (p2 != parent).any(), i + 1

    true0 = parent0[0] == parent0[0]
    parent, changed, _ = jax.lax.while_loop(
        cond, body, (parent0, true0, jnp.int32(0)))
    par = parent[:K_pad]
    is_root = (par == iota) & (iota < k)
    rank = jnp.cumsum(is_root.astype(jnp.int32)) - 1
    lut = rank[jnp.clip(par, 0, K_pad - 1)]
    lab = jnp.where(piece >= 0, lut[jnp.clip(piece, 0, K_pad - 1)], -1)
    return lab, is_root.sum(), ~changed


def tiled_scan_ccl_dense_labels(labels: jnp.ndarray,
                                block: int = _TILED_CCL_BLOCK):
    """Big-raster CCL + dense first-occurrence relabel as two device
    programs around one scalar sync (the piece count sizes the static
    union graph). Bitwise-equal to :func:`scan_ccl_dense_labels`.
    Returns ((H, W) int32 dense 0..K-1 / -1, K, converged:int bool)."""
    from .stats import pad_num_segments

    from .. import telemetry
    with telemetry.stage("ccl.local"):
        piece, k_dev, conv_local = _tiled_ccl_local(labels, block)
        K_pieces, conv_l = jax.device_get((k_dev, conv_local))
    if not bool(conv_l):
        return None, 0, False
    K_pad = pad_num_segments(max(int(K_pieces), 1))
    with telemetry.stage("ccl.union"):
        lab, k2, conv_u = _tiled_ccl_union(piece, labels, k_dev, K_pad,
                                           block)
        conv_u = telemetry.sync(conv_u)
    return lab, k2, conv_u


@jax.jit
def _dense_relabel_device(f: jnp.ndarray
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fully-compressed roots -> dense labels 0..K-1 ordered by raster-
    order first occurrence (roots are component-min padded linear ids and
    padded/cropped orders agree, so ascending roots == first occurrence —
    bitwise-identical to the host ``native.relabel_compact``).

    f: (Np,) compressed roots (-1 invalid). Returns ((Np,) labels, K)."""
    Np = f.shape[0]
    idx = jnp.arange(Np, dtype=jnp.int32)
    valid = f >= 0
    is_root = valid & (f == idx)
    rank = jnp.cumsum(is_root.astype(jnp.int32)) - 1
    lab = jnp.where(valid, rank[jnp.where(valid, f, 0)], -1)
    return lab, is_root.sum()


@functools.partial(jax.jit, static_argnames=("K_pad",))
def _merge_final_lut(lut: jnp.ndarray, sizes0: jnp.ndarray, K_pad: int):
    """Merge lut -> (dense final lut, K): dense labels ordered by raster
    first occurrence (== ascending min member old id, matching the host
    path's final ``relabel_compact``)."""
    iota = jnp.arange(K_pad, dtype=jnp.int32)
    sizes = jax.ops.segment_sum(sizes0, lut, num_segments=K_pad)
    used = sizes > 0
    # representative -> min old member id (old ids are first-occurrence
    # ordered, so this reproduces raster-order numbering). Each class has
    # a UNIQUE min member, so ranking by presence-scatter + cumsum gives
    # the same ascending-rep_min numbering as an argsort would — without
    # paying a K_pad-row sort (millions of rows at the 100 MP dust K).
    rep_min = jax.ops.segment_min(iota, lut, num_segments=K_pad)
    present = jnp.zeros((K_pad,), jnp.bool_).at[
        jnp.where(used, rep_min, K_pad)].set(True, mode="drop")
    rank = jnp.cumsum(present.astype(jnp.int32)) - 1
    dense_of_rep = rank[jnp.clip(rep_min, 0, K_pad - 1)]
    return dense_of_rep[lut], used.sum()


@functools.partial(jax.jit, static_argnames=("K_pad",))
def _merge_finalize(raw: jnp.ndarray, lut: jnp.ndarray, sizes0: jnp.ndarray,
                    K_pad: int):
    """Apply the accumulated merge lut and re-compact to dense labels."""
    final_lut, k = _merge_final_lut(lut, sizes0, K_pad)
    lab = jnp.where(raw >= 0, final_lut[jnp.clip(raw, 0, K_pad - 1)], -1)
    return lab, k


@functools.partial(jax.jit, static_argnames=("K_pad",))
def _segment_sizes(raw: jnp.ndarray, K_pad: int) -> jnp.ndarray:
    flat = raw.reshape(-1)
    ok = flat >= 0
    return jax.ops.segment_sum(ok.astype(jnp.float32),
                               jnp.where(ok, flat, 0), num_segments=K_pad)


def merge_small_device(labels: jnp.ndarray, num_labels: int, min_size: int,
                       max_size: int, max_iters: int = 512
                       ) -> Tuple[jnp.ndarray, int]:
    """Device-resident small-segment merge over dense labels (0..K-1, -1
    invalid): capped adoption sweeps until stable, then uncapped sweeps so
    no sub-``min_size`` orphan survives (mirroring the native host path),
    then dense re-compaction. Small K runs as ONE fused program over the
    deduplicated label-adjacency edge list; the dust regime (K_pad above
    ``_MERGE_TWO_PHASE_MIN_K``) runs the two-phase split below — raw
    right-sized edge buffer, head sweeps, compaction to the edges still
    able to drive an adoption, tail sweeps — with identical results.

    Returns ((H, W) int32 device labels, K)."""
    from .stats import pad_num_segments

    K_pad = pad_num_segments(max(num_labels, 1))
    mn = jnp.float32(min_size)
    mx = jnp.float32(max_size)
    if K_pad > _MERGE_TWO_PHASE_MIN_K:
        # dust regime (raw CCL of a noisy SLIC assignment: 5.5 M
        # fragments at 100 MP): the sweep loop pays 4 gather/scatter
        # passes over the full 4*K_pad edge buffer per sweep (~1.1 s
        # each, ~17 sweeps = 20.3 s of the 27.7 s stage). Run a short
        # head at full width, then compact the edges still external
        # under the current lut into a small bucketed buffer and sweep
        # the tail there. Exact: merging is monotone (internal edges
        # never turn external) and sweeps are min-reductions.
        from .. import telemetry
        with telemetry.stage("merge.count"):
            n_valid = int(jax.device_get(_boundary_pair_count(labels)))
        CAP = max(_MERGE_RAW_BUCKET,
                  -(-n_valid // _MERGE_RAW_BUCKET) * _MERGE_RAW_BUCKET)
        with telemetry.stage("merge.phase_a"):
            lut, sizes0, ea2, eb2, n_ext, n_live = _merge_phase_a(
                labels, mn, mx, K_pad, CAP, _MERGE_HEAD_SWEEPS)
            n_ext, n_live = (int(v) for v in
                             jax.device_get((n_ext, n_live)))
        E2 = min(CAP, max(_MERGE_EDGE_BUCKET,
                          -(-n_ext // _MERGE_EDGE_BUCKET)
                          * _MERGE_EDGE_BUCKET))
        K2_pad = min(K_pad, pad_num_segments(max(n_live, 1)))
        with telemetry.stage("merge.phase_b"):
            lab, k_dev = _merge_phase_b(labels, lut, sizes0, ea2, eb2,
                                        mn, mx, K_pad, K2_pad, E2,
                                        max_iters)
            k = int(jax.device_get(k_dev))
        return lab, k
    e_factor = 4
    while True:
        lab, k_dev, n_edges_dev = _merge_small_fused(
            labels, mn, mx, K_pad, max_iters, e_factor=e_factor)
        k, n_edges = (int(v) for v in jax.device_get((k_dev, n_edges_dev)))
        if n_edges <= e_factor * K_pad:
            return lab, k
        # non-CCL-compact labels (one id scattered over many regions) can
        # out-grow the planar edge bound; the overflow dropped edges, so
        # the result is wrong — retry with a buffer sized to the exact
        # distinct-edge count (one recompile, pathological inputs only)
        e_factor = -(-n_edges // K_pad) + 1


# presence-table edge dedup is used while the (K_pad+1)^2 table stays
# small (256 MB int32-equivalent at 2^26); beyond that (e.g. quickshift's
# 50k+ objects) the compact-then-sort path runs instead
_EDGE_TABLE_MAX = 1 << 26
# floor for the compacted boundary-pair buffer (int64 keys); the cap
# scales as n2/8 above this. Overflow falls back to the full 2N sort via
# lax.cond (exactness guard; never taken on real segmentation scenes)
_EDGE_COMPACT_MIN = 1 << 22


@functools.partial(jax.jit,
                   static_argnames=("K_pad", "e_factor", "with_count"))
def _label_edges(labels: jnp.ndarray, K_pad: int, e_factor: int = 4,
                 with_count: bool = False):
    """Deduplicated label-adjacency edge list, entirely on device.

    The region-adjacency graph of a raster partition with CONNECTED
    regions is PLANAR, so its edge count is < 3K — the compacted list
    fits a static (e_factor*K_pad,) bound with room to spare. Built by
    sorting the canonical (lo*K_pad+hi) keys of every differing
    4-neighbour pixel pair and scattering first occurrences to their
    rank. Labels that were never connectivity-compacted (one id forming
    many scattered regions) can exceed the bound; ``with_count=True``
    additionally returns the EXACT distinct-edge count so the caller can
    detect the overflow and retry with a larger ``e_factor``
    (:func:`merge_small_device` does).

    Returns (ea, eb[, n_edges]): (e_factor*K_pad,) int32 endpoint
    arrays, -1 past the end.
    """
    E_cap = e_factor * K_pad
    SENT = jnp.int32(K_pad)  # past any real label; sorts to the end

    def pairs(sl_a, sl_b):
        a = labels[sl_a].reshape(-1)
        b = labels[sl_b].reshape(-1)
        m = (a != b) & (a >= 0) & (b >= 0)
        lo = jnp.where(m, jnp.minimum(a, b), SENT)
        hi = jnp.where(m, jnp.maximum(a, b), SENT)
        return lo, hi

    h_lo, h_hi = pairs((slice(None), slice(None, -1)),
                       (slice(None), slice(1, None)))
    v_lo, v_hi = pairs((slice(None, -1), slice(None)),
                       (slice(1, None), slice(None)))
    lo = jnp.concatenate([h_lo, v_lo])
    hi = jnp.concatenate([h_hi, v_hi])
    stride = K_pad + 1
    if stride * stride <= _EDGE_TABLE_MAX:
        # presence-table dedup: ONE 2N-row scatter into a (K_pad+1)^2
        # table + a K^2-sized compaction, instead of sorting the 2N fused
        # keys (the sort was ~an order of magnitude slower at 100 MP —
        # sorts cost several x scatters at equal N). Compaction walks the
        # table in fused-key order, so ea/eb are IDENTICAL to the
        # sort-dedup result (bitwise — the merge sweeps and the sharded
        # mosaic equality tests depend on edge order only through the
        # final lut, but identical is identical).
        fused = lo * stride + hi  # sentinel pairs land on stride^2-1
        present = jnp.zeros((stride * stride,), jnp.bool_
                            ).at[fused].set(True, mode="drop")
        pk = jnp.arange(stride * stride, dtype=jnp.int32)
        plo = pk // stride
        phi = pk - plo * stride
        real = present & (plo < SENT) & (phi < SENT)
        rank = jnp.cumsum(real.astype(jnp.int32)) - 1
        idx = jnp.where(real, rank, E_cap)
        ea = jnp.full((E_cap,), -1, jnp.int32).at[idx].set(plo, mode="drop")
        eb = jnp.full((E_cap,), -1, jnp.int32).at[idx].set(phi, mode="drop")
        if with_count:
            return ea, eb, real.sum().astype(jnp.int32)
        return ea, eb
    # big-K path: valid-pair COMPACTION before the sort. Boundary pairs
    # are ~1% of the 2N candidates on segmentation rasters, so sorting
    # the compacted (CAP,) buffer replaces the 2N sort that dominated
    # merge_small at 100 MP (~20 s of the 27.6 s stage). A lax.cond
    # falls back to the full 2N sort when the pair count overflows CAP
    # (exactness guard; never taken on real scenes). Every path emits
    # unique pairs in ascending (lo, hi) order — ea/eb are identical.
    # NOTE int64 keys are NOT an option: jax x64 is disabled, so
    # astype(int64) silently truncates and the fused key corrupts for
    # K_pad > 46340 — the wide-K paths sort (lo, hi) lexicographically.
    n2 = lo.shape[0]
    # n2/8 keeps ~8x headroom over observed boundary-pair counts while
    # the sort shrinks 8x; floor at 4M rows
    CAP = min(n2, max(_EDGE_COMPACT_MIN, n2 // 8))
    fits32 = stride * stride < 2 ** 31

    def dedup_sorted_pairs(slo, shi):
        plo = jnp.concatenate([jnp.full((1,), -1, slo.dtype), slo[:-1]])
        phi = jnp.concatenate([jnp.full((1,), -1, shi.dtype), shi[:-1]])
        first = ((slo != plo) | (shi != phi)) & (slo < SENT)
        rank = jnp.cumsum(first.astype(jnp.int32)) - 1
        idx = jnp.where(first, rank, E_cap)
        ea = jnp.full((E_cap,), -1, jnp.int32).at[idx].set(slo, mode="drop")
        eb = jnp.full((E_cap,), -1, jnp.int32).at[idx].set(shi, mode="drop")
        if with_count:
            return ea, eb, first.sum().astype(jnp.int32)
        return ea, eb

    def sorted_pairs_full():
        if fits32:
            # fused single-key sort (markedly faster than the two-key
            # lexicographic sort; identical sorted order)
            f = jnp.sort(lo * stride + hi)
            slo = f // stride
            return slo, f - slo * stride
        return jax.lax.sort((lo, hi), num_keys=2)

    if n2 <= CAP:
        return dedup_sorted_pairs(*sorted_pairs_full())

    valid = lo < SENT
    pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
    n_valid = pos[-1] + 1
    idxc = jnp.where(valid, pos, CAP)

    def compact_path(_):
        if fits32:
            buf = jnp.full((CAP,), jnp.int32(K_pad * stride + K_pad))
            buf = buf.at[idxc].set(lo * stride + hi, mode="drop")
            f = jnp.sort(buf)
            slo = f // stride
            shi = f - slo * stride
        else:
            bl = jnp.full((CAP,), SENT).at[idxc].set(lo, mode="drop")
            bh = jnp.full((CAP,), SENT).at[idxc].set(hi, mode="drop")
            slo, shi = jax.lax.sort((bl, bh), num_keys=2)
        return dedup_sorted_pairs(slo, shi)

    def full_sort_path(_):
        return dedup_sorted_pairs(*sorted_pairs_full())

    return jax.lax.cond(n_valid <= CAP, compact_path, full_sort_path,
                        operand=None)


def _sweep_biased(ea, eb, lut, small, K_pad: int):
    """The per-edge-buffer piece of one adoption sweep: the biased
    candidate-target min-scatter. Separated from the K-domain apply so
    the sharded dust merge can run it per shard over LOCAL edge buffers
    and ``pmin`` the results — min is associative, so the reduction over
    per-shard mins equals the single-buffer scatter bitwise."""
    ok = ea >= 0
    a = jnp.where(ok, lut[jnp.clip(ea, 0, K_pad - 1)], -1)
    b = jnp.where(ok, lut[jnp.clip(eb, 0, K_pad - 1)], -1)
    m = ok & (a != b)
    ac = jnp.clip(a, 0, K_pad - 1)
    bc = jnp.clip(b, 0, K_pad - 1)

    INF = jnp.int32(2 * K_pad)
    biased = jnp.full((K_pad,), INF, jnp.int32)
    # both orientations; non-small neighbours sort first via the +K_pad bias
    for src, dst, dst_c in ((ac, b, bc), (bc, a, ac)):
        use = m & small[src]
        val = dst + jnp.where(small[dst_c], K_pad, 0)
        biased = biased.at[jnp.where(use, src, K_pad)].min(
            jnp.where(use, val, INF), mode="drop")
    return biased


def _sweep_apply(biased, lut, sizes, small, min_size, max_size,
                 K_pad: int, capped: bool):
    """The K-domain tail of one adoption sweep: pick targets from the
    biased candidates, gate, one-hop match, compose into the lut."""
    iota = jnp.arange(K_pad, dtype=jnp.int32)
    INF = jnp.int32(2 * K_pad)
    has_large = biased < K_pad
    tgt = jnp.where(has_large, biased, biased - K_pad)
    tgt_safe = jnp.clip(tgt, 0, K_pad - 1)
    adopt = small & (biased < INF) & ((tgt < iota) | has_large)
    if capped:
        adopt &= (sizes + sizes[tgt_safe]) <= max_size
    # one-hop matching (see _merge_small_sweep)
    adopt &= ~adopt[tgt_safe]
    step = jnp.where(adopt, tgt_safe, iota)
    return step[lut], adopt.any()


def _merge_small_sweep_edges(ea, eb, lut, sizes0, min_size, max_size,
                             K_pad: int, capped: bool):
    """One adoption sweep in the EDGE domain (E ~ 3K entries instead of
    N pixels — the pixel-domain sweep's full-raster table gathers ran at
    ~96 M lookups/s and dominated the merge at 16 MP+).

    The ``max_size`` cap is checked on the CHOSEN target at label level
    (the edge-domain analog of the per-edge check; any stall the coarser
    check introduces is absorbed by the uncapped no-orphans phase)."""
    sizes = jax.ops.segment_sum(sizes0, lut, num_segments=K_pad)
    small = (sizes > 0) & (sizes < min_size)
    biased = _sweep_biased(ea, eb, lut, small, K_pad)
    return _sweep_apply(biased, lut, sizes, small, min_size, max_size,
                        K_pad, capped)


def _merge_lut_loop(ea, eb, sizes0, min_size, max_size, K_pad: int,
                    max_iters: int, lut0=None):
    """Capped + uncapped edge-domain adoption sweeps -> merge lut
    (K-sized compute only; traceable — shared by the single-device fused
    program and the sharded driver, whose edges come from many shards).
    ``lut0`` resumes from a partially-swept lut (the two-phase big-K
    path)."""
    lut = jnp.arange(K_pad, dtype=jnp.int32) if lut0 is None else lut0

    def phase(lut, capped):
        def cond(carry):
            _, changed, i = carry
            return changed & (i < max_iters)

        def body(carry):
            lut, _, i = carry
            lut, ch = _merge_small_sweep_edges(ea, eb, lut, sizes0,
                                               min_size, max_size,
                                               K_pad, capped)
            return lut, ch, i + 1

        lut, _, _ = jax.lax.while_loop(
            cond, body, (lut, jnp.asarray(True), jnp.int32(0)))
        return lut

    lut = phase(lut, True)
    # uncapped pass so no sub-min orphan survives (native-path semantics);
    # skipped on device when nothing small remains
    sizes_now = jax.ops.segment_sum(sizes0, lut, num_segments=K_pad)
    any_small = ((sizes_now > 0) & (sizes_now < min_size)).any()
    return jax.lax.cond(any_small, lambda l: phase(l, False),
                        lambda l: l, lut)


@functools.partial(jax.jit, static_argnames=("K_pad", "max_iters"))
def merge_lut_from_edges(ea, eb, sizes0, min_size, max_size, K_pad: int,
                         max_iters: int = 512):
    """(edge list, sizes) -> (final dense lut, K): the raster-free half of
    the small-segment merge, for callers that build the edge list
    themselves (the sharded mosaic concatenates per-shard edge lists —
    duplicates across shards are harmless, the sweeps are min-reductions)."""
    lut = _merge_lut_loop(ea, eb, sizes0, min_size, max_size, K_pad,
                          max_iters)
    return _merge_final_lut(lut, sizes0, K_pad)


@functools.partial(jax.jit,
                   static_argnames=("K_pad", "max_iters", "e_factor"))
def _merge_small_fused(labels: jnp.ndarray, min_size: jnp.ndarray,
                       max_size: jnp.ndarray, K_pad: int, max_iters: int,
                       e_factor: int = 4):
    """The full small-segment merge as ONE device program: sizes, the
    deduplicated adjacency edge list, capped + uncapped sweep phases
    (edge-domain, on-device early exit), dense re-compaction. Also
    returns the exact distinct-edge count so the caller can detect an
    edge-buffer overflow (non-CCL-compact input labels) and retry."""
    sizes0 = _segment_sizes(labels, K_pad)
    ea, eb, n_edges = _label_edges(labels, K_pad, e_factor=e_factor,
                                   with_count=True)
    lut = _merge_lut_loop(ea, eb, sizes0, min_size, max_size, K_pad,
                          max_iters)
    lab, k = _merge_finalize(labels, lut, sizes0, K_pad)
    return lab, k, n_edges


# big-K merges (dust regime) split into two programs around an edge
# compaction; the threshold keeps small scenes on the single fused
# program (one dispatch, no extra host sync)
_MERGE_TWO_PHASE_MIN_K = 1 << 17
_MERGE_HEAD_SWEEPS = 2
_MERGE_EDGE_BUCKET = 1 << 18
_MERGE_RAW_BUCKET = 1 << 20


@jax.jit
def _boundary_pair_count(labels: jnp.ndarray) -> jnp.ndarray:
    """Number of valid differing 4-neighbour pixel pairs — sizes the raw
    (dedup-free) edge buffer of the two-phase merge."""
    def count(sl_a, sl_b):
        a = labels[sl_a]
        b = labels[sl_b]
        return ((a != b) & (a >= 0) & (b >= 0)).sum()

    return (count((slice(None), slice(None, -1)),
                  (slice(None), slice(1, None)))
            + count((slice(None, -1), slice(None)),
                    (slice(1, None), slice(None)))).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("K_pad", "CAP", "s0"))
def _merge_phase_a(labels: jnp.ndarray, min_size: jnp.ndarray,
                   max_size: jnp.ndarray, K_pad: int, CAP: int, s0: int):
    """Head of the two-phase big-K merge: sizes, RAW boundary-pair edge
    list (no dedup — the sweeps are min-reductions over the edge set,
    indifferent to duplicates and order, and the caller sized ``CAP``
    from :func:`_boundary_pair_count`, so the 2N->CAP compaction replaces
    the dedup SORT that dominated the edge build at 100 MP), then ``s0``
    unconditional capped sweeps at full buffer width (a sweep on a
    converged lut is the identity, so over-sweeping is exact), then
    compaction of the edges still able to drive an adoption to the
    buffer front. Returns (lut, sizes0, ea2, eb2, n_external,
    n_live_reps) — the live-rep count sizes phase_b's COMPACT sweep
    domain (after the head sweeps absorb the dust, live reps are ~10^3-4
    of the 10^6-7 raw fragments, so tail sweeps need not pay K_pad-row
    segment_sums)."""
    sizes0 = _segment_sizes(labels, K_pad)
    SENT = jnp.int32(K_pad)

    def pairs(sl_a, sl_b):
        a = labels[sl_a].reshape(-1)
        b = labels[sl_b].reshape(-1)
        m = (a != b) & (a >= 0) & (b >= 0)
        return jnp.where(m, a, SENT), jnp.where(m, b, SENT)

    h_a, h_b = pairs((slice(None), slice(None, -1)),
                     (slice(None), slice(1, None)))
    v_a, v_b = pairs((slice(None, -1), slice(None)),
                     (slice(1, None), slice(None)))
    lo = jnp.concatenate([h_a, v_a])
    hi = jnp.concatenate([h_b, v_b])
    valid = lo < SENT
    pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
    idxr = jnp.where(valid, pos, CAP)
    ea = jnp.full((CAP,), -1, jnp.int32).at[idxr].set(lo, mode="drop")
    eb = jnp.full((CAP,), -1, jnp.int32).at[idxr].set(hi, mode="drop")
    E_cap = CAP
    lut = jnp.arange(K_pad, dtype=jnp.int32)
    for _ in range(s0):
        lut, _ = _merge_small_sweep_edges(ea, eb, lut, sizes0,
                                          min_size, max_size, K_pad, True)
    ok = ea >= 0
    a = jnp.where(ok, lut[jnp.clip(ea, 0, K_pad - 1)], -1)
    b = jnp.where(ok, lut[jnp.clip(eb, 0, K_pad - 1)], -1)
    # keep only edges that can still enable an adoption: external under
    # the current lut AND touching a sub-min rep. Rep sizes only grow as
    # merges accumulate, so a non-small rep can never become small again
    # and a non-small/non-small edge is dead for every future sweep
    # (capped and uncapped both gate on ``small[src]``) — dropping them
    # is exact and keeps the tail buffer at the small-touching edge
    # count even when large/large boundary edges dominate.
    sizes_now = jax.ops.segment_sum(sizes0, lut, num_segments=K_pad)
    small = (sizes_now > 0) & (sizes_now < min_size)
    ac = jnp.clip(a, 0, K_pad - 1)
    bc = jnp.clip(b, 0, K_pad - 1)
    ext = ok & (a != b) & (small[ac] | small[bc])
    pos = jnp.cumsum(ext.astype(jnp.int32)) - 1
    idx = jnp.where(ext, pos, E_cap)
    # store CURRENT REPS (the lut is idempotent: lut[rep] == rep), which
    # the tail sweeps re-map through the evolving lut exactly as they
    # would the original endpoints
    ea2 = jnp.full((E_cap,), -1, jnp.int32).at[idx].set(a, mode="drop")
    eb2 = jnp.full((E_cap,), -1, jnp.int32).at[idx].set(b, mode="drop")
    n_live = (sizes_now > 0).sum().astype(jnp.int32)
    return lut, sizes0, ea2, eb2, pos[-1] + 1, n_live


def _merge_phase_b_lut(lut: jnp.ndarray, sizes0: jnp.ndarray,
                       ea2: jnp.ndarray, eb2: jnp.ndarray,
                       min_size: jnp.ndarray, max_size: jnp.ndarray,
                       K_pad: int, K2_pad: int, E2: int, max_iters: int):
    """Tail of the two-phase merge WITHOUT the raster finalize: remaining
    capped sweeps to fixpoint + the uncapped no-orphan phase over the
    COMPACTED (E2,) edge buffer. Traceable; shared by the single-device
    program below and the sharded dust merge (whose compacted edges are
    the concatenation of per-shard buckets — the sweeps are
    min-reductions, indifferent to slot order and -1 padding).
    ``E2`` and ``K2_pad`` are bucketed so scenes with
    jittering external edge / live-rep counts reuse the compiled program.

    The sweeps run in a COMPACT rep domain: live reps (post-head-sweep
    classes with mass) rank densely into [0, K2_pad). The rank map is
    monotone in rep id, so every min-reduction tie-break (`tgt < iota`,
    the non-small bias ordering) makes the SAME choices as sweeping the
    full K_pad domain — the final labels are bitwise-identical, but each
    sweep's segment_sum runs over K2_pad (~10^3-5) rows instead of K_pad
    (5.5 M at the 100 MP dust point, where the full-domain sweeps were
    ~4.3 s of the stage)."""
    ea = jax.lax.slice_in_dim(ea2, 0, E2)
    eb = jax.lax.slice_in_dim(eb2, 0, E2)
    iota = jnp.arange(K_pad, dtype=jnp.int32)
    sizes_now = jax.ops.segment_sum(sizes0, lut, num_segments=K_pad)
    live = sizes_now > 0
    rank = jnp.cumsum(live.astype(jnp.int32)) - 1  # monotone on live reps
    slot = jnp.where(live, rank, K2_pad)
    eac = jnp.where(ea >= 0, rank[jnp.clip(ea, 0, K_pad - 1)], -1)
    ebc = jnp.where(eb >= 0, rank[jnp.clip(eb, 0, K_pad - 1)], -1)
    sizes_c = jnp.zeros((K2_pad,), sizes_now.dtype).at[slot].set(
        jnp.where(live, sizes_now, 0), mode="drop")
    lut_c = _merge_lut_loop(eac, ebc, sizes_c, min_size, max_size, K2_pad,
                            max_iters)
    # expand back: orig id -> head rep -> compact -> compact rep -> K_pad rep
    unrank = jnp.zeros((K2_pad,), jnp.int32).at[slot].set(iota, mode="drop")
    return unrank[lut_c[rank[lut]]]


@functools.partial(jax.jit,
                   static_argnames=("K_pad", "K2_pad", "E2", "max_iters"))
def _merge_phase_b(labels: jnp.ndarray, lut: jnp.ndarray,
                   sizes0: jnp.ndarray, ea2: jnp.ndarray, eb2: jnp.ndarray,
                   min_size: jnp.ndarray, max_size: jnp.ndarray,
                   K_pad: int, K2_pad: int, E2: int, max_iters: int):
    """:func:`_merge_phase_b_lut` + the raster finalize, as one program
    (the single-device two-phase caller)."""
    lut_full = _merge_phase_b_lut(lut, sizes0, ea2, eb2, min_size,
                                  max_size, K_pad, K2_pad, E2, max_iters)
    return _merge_finalize(labels, lut_full, sizes0, K_pad)


def relabel_connected(labels: np.ndarray, block: int = 32
                      ) -> Tuple[np.ndarray, int]:
    """Full CCL of a host label raster: device block-local CCL + native
    cross-block union-find + dense first-occurrence relabel.

    Args:
      labels: (H, W) int; negative = invalid.
    Returns:
      ((H, W) int32 labels 0..K-1 / -1 invalid, K).
    """
    del block  # kept for API compatibility; the scan CCL needs no blocks
    labels = np.ascontiguousarray(labels, np.int32)
    lab_dev = jnp.asarray(labels)
    lab, k_dev, conv_dev = scan_ccl_dense_labels(lab_dev)
    k, conv = jax.device_get((k_dev, conv_dev))
    if not bool(conv):
        # component snaked past the alternation cap: exact FastSV fallback
        lab, k_dev = fastsv_dense_labels(lab_dev)
        k = jax.device_get(k_dev)
    return np.asarray(lab), int(k)


def merge_small_labels_host(labels: np.ndarray, min_size: int,
                            max_iters: int = 24,
                            max_size: int = None) -> Tuple[np.ndarray, int]:
    """Host-side small-component merging over COMPACT labels (0..K-1, -1
    invalid): whole-component adoption of an adjacent component (preferring
    non-small ones), vectorised with bincount + minimum.at; ``max_size``
    caps the merged size (skimage's max_size_factor semantics) so heavy
    fragmentation cannot collapse into one blob. Re-compacts labels."""
    from .. import native
    if max_size is None:
        max_size = np.iinfo(np.int64).max // 4
    if native.available():
        return native.merge_small_capped(labels, int(min_size),
                                         int(max_size))
    lab = np.ascontiguousarray(labels, np.int64)
    H, W = lab.shape
    for _ in range(max_iters):
        valid = lab >= 0
        if not valid.any():
            break
        K = int(lab.max()) + 1
        sizes = np.bincount(lab[valid], minlength=K)
        small = sizes < min_size
        if not small[lab[valid]].any():
            break
        pairs_a = []
        pairs_b = []
        for sl_a, sl_b in (((slice(None), slice(None, -1)),
                            (slice(None), slice(1, None))),
                           ((slice(None, -1), slice(None)),
                            (slice(1, None), slice(None)))):
            a = lab[sl_a].reshape(-1)
            b = lab[sl_b].reshape(-1)
            m = (a != b) & (a >= 0) & (b >= 0)
            pairs_a.append(np.concatenate([a[m], b[m]]))
            pairs_b.append(np.concatenate([b[m], a[m]]))
        pa = np.concatenate(pairs_a)
        pb = np.concatenate(pairs_b)
        # prefer adopting a LARGE neighbour; small components with only
        # small neighbours adopt the min small neighbour instead (skimage
        # merges small segments into any adjacent segment — without this,
        # heavily fragmented maps deadlock with every component small)
        fits = sizes[pa] + sizes[pb] <= max_size
        use_large = small[pa] & ~small[pb] & fits
        use_any = small[pa] & fits
        if not use_any.any():
            break
        target = np.full(K, K, np.int64)
        np.minimum.at(target, pa[use_any], pb[use_any])
        target_large = np.full(K, K, np.int64)
        np.minimum.at(target_large, pa[use_large], pb[use_large])
        has_large = target_large < K
        target = np.where(has_large, target_large, target)
        lut = np.arange(K, dtype=np.int64)
        adopt = small & (target < K)
        # avoid two-cycles when both partners are small: only merge
        # into a smaller id (forms a forest toward minima)
        adopt &= (target < np.arange(K)) | has_large
        if not adopt.any():
            break
        lut[adopt] = target[adopt]
        # fully path-compress the lut: partial compression would map
        # chain members to DIFFERENT intermediate nodes and disconnect
        # the merged label
        while True:
            nxt = lut[lut]
            if (nxt == lut).all():
                break
            lut = nxt
        lab = np.where(lab >= 0, lut[np.clip(lab, 0, K - 1)], -1)
    # re-compact (keep first-occurrence order)
    from .. import native
    return native.relabel_compact(lab)


def compact_labels(comp: np.ndarray, start_label: int = 0
                   ) -> Tuple[np.ndarray, int]:
    """Host-side: map component roots to consecutive labels ordered by
    raster-order first occurrence (roots are min linear indices, so sorted
    roots == first-occurrence order). Invalid (-1) pixels map to
    ``start_label - 1``.

    Returns (labels, num_labels).
    """
    comp = np.asarray(comp)
    flat = comp.reshape(-1)
    roots = np.unique(flat[flat >= 0])
    lut = np.full(int(flat.max()) + 2 if flat.size else 1, -1, np.int64)
    lut[roots] = np.arange(len(roots)) + start_label
    out = np.where(flat >= 0, lut[np.clip(flat, 0, lut.size - 1)],
                   start_label - 1)
    return out.reshape(comp.shape).astype(np.int32), len(roots)
