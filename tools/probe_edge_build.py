"""Device probe: merge phase_a edge-build variants at north-star scale.

phase_a's floor is the raw boundary-pair build: two 2N-row compaction
scatters (ea and eb separately) plus a 2N cumsum. If scatter cost is
bound by index ROWS, not payload bytes (tools/probe_scatter.py), packing
both endpoints into ONE int64 scatter should halve the build's scatter
time.
This probe measures, on the REAL production labels (the config-4
north-star SLIC assignment's raw CCL fragments):

  A. current build: two int32 scatters
  B. packed build: one int64 scatter (lo << 32 | hi), unpack after
  C. the head sweep, isolated (context for where the rest of phase_a goes)
  D. full _merge_phase_a as shipped vs with the packed build

Run as the only JAX process on the card:
    python tools/probe_edge_build.py [H] [W]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import functools  # noqa: E402

import numpy as np  # noqa: E402


def timed(fn, *args, n=2, name=""):
    import jax
    out = None
    best = np.inf
    for i in range(n):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        dt = time.perf_counter() - t0
        best = min(best, dt)
        print(f"  {name} run{i}: {dt * 1000:.0f} ms", flush=True)
    return out, best


def main():
    H = int(sys.argv[1]) if len(sys.argv) > 1 else 10000
    W = int(sys.argv[2]) if len(sys.argv) > 2 else 10000

    import jax
    import jax.numpy as jnp

    from bench import build_scene
    from obia_tpu import compile_cache
    from obia_tpu.ops import connectivity as C
    from obia_tpu.ops import slic as S
    from obia_tpu.ops.stats import pad_num_segments

    compile_cache.enable()
    print(f"devices: {jax.devices()}", flush=True)

    base3 = build_scene(h=H, w=W, c=4).astype(np.float32)
    img3 = np.stack([base3[..., 0], base3[..., 3] if base3.shape[-1] > 3
                     else base3[..., 0], base3[..., 2]], axis=-1) / 255.0
    n_segments = 3000
    gh, gw = S._grid_shape(H, W, n_segments)
    img_dev = jnp.asarray(img3)
    valid = jnp.ones((H, W), bool)
    t0 = time.perf_counter()
    assign = jax.block_until_ready(S._slic_iterate(
        img_dev, valid, gh, gw, 10.0, 10,
        grid_step=S._grid_step(H, W, n_segments),
        grid_half=S._grid_half(H, W, n_segments)))
    print(f"slic assignment: {time.perf_counter() - t0:.1f} s", flush=True)
    del img_dev

    labels, k, conv = C.tiled_scan_ccl_dense_labels(assign)
    k = int(jax.device_get(k))
    labels = jax.block_until_ready(labels)
    K_pad = pad_num_segments(k)
    print(f"raw CCL fragments: {k} (K_pad {K_pad})", flush=True)

    n_valid = int(jax.device_get(C._boundary_pair_count(labels)))
    CAP = max(C._MERGE_RAW_BUCKET,
              -(-n_valid // C._MERGE_RAW_BUCKET) * C._MERGE_RAW_BUCKET)
    print(f"boundary pairs: {n_valid} (CAP {CAP})", flush=True)

    SENT = jnp.int32(K_pad)

    def raw_pairs(lab):
        def pairs(sl_a, sl_b):
            a = lab[sl_a].reshape(-1)
            b = lab[sl_b].reshape(-1)
            m = (a != b) & (a >= 0) & (b >= 0)
            return jnp.where(m, a, SENT), jnp.where(m, b, SENT)

        h_a, h_b = pairs((slice(None), slice(None, -1)),
                         (slice(None), slice(1, None)))
        v_a, v_b = pairs((slice(None, -1), slice(None)),
                         (slice(1, None), slice(None)))
        lo = jnp.concatenate([h_a, v_a])
        hi = jnp.concatenate([h_b, v_b])
        return lo, hi

    @functools.partial(jax.jit, static_argnames=("cap",))
    def build_two_scatters(lab, cap: int):
        lo, hi = raw_pairs(lab)
        valid = lo < SENT
        pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
        idxr = jnp.where(valid, pos, cap)
        ea = jnp.full((cap,), -1, jnp.int32).at[idxr].set(lo, mode="drop")
        eb = jnp.full((cap,), -1, jnp.int32).at[idxr].set(hi, mode="drop")
        return ea, eb

    @functools.partial(jax.jit, static_argnames=("cap",))
    def build_packed(lab, cap: int):
        lo, hi = raw_pairs(lab)
        valid = lo < SENT
        pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
        idxr = jnp.where(valid, pos, cap)
        packed = (lo.astype(jnp.int64) << 32) | hi.astype(jnp.int64)
        buf = jnp.full((cap,), -1, jnp.int64).at[idxr].set(packed,
                                                           mode="drop")
        ea = jnp.where(buf >= 0, (buf >> 32).astype(jnp.int32), -1)
        eb = jnp.where(buf >= 0, (buf & 0x7fffffff).astype(jnp.int32), -1)
        return ea, eb

    (ea_a, eb_a), t_two = timed(build_two_scatters, labels, CAP, n=3,
                                name="build two-int32-scatters")
    (ea_b, eb_b), t_pack = timed(build_packed, labels, CAP, n=3,
                                 name="build packed-int64-scatter")
    same = bool(jnp.array_equal(ea_a, ea_b) & jnp.array_equal(eb_a, eb_b))
    print(f"edge build: two-scatter {t_two:.2f} s vs packed {t_pack:.2f} s "
          f"(identical={same})", flush=True)

    # isolated pieces for the census
    @jax.jit
    def sizes_only(lab):
        return C._segment_sizes(lab, K_pad)

    _, t_sizes = timed(sizes_only, labels, n=3, name="sizes0 segment_sum")

    @jax.jit
    def cumsum_only(lab):
        lo, hi = raw_pairs(lab)
        return jnp.cumsum((lo < SENT).astype(jnp.int32))[-1]

    _, t_cum = timed(cumsum_only, labels, n=3, name="pairs+cumsum only")

    sizes0 = sizes_only(labels)
    lut0 = jnp.arange(K_pad, dtype=jnp.int32)

    @jax.jit
    def one_sweep(ea, eb, lut, s0):
        lut2, _ = C._merge_small_sweep_edges(
            ea, eb, lut, s0, jnp.float32(170), jnp.float32(10 ** 9),
            K_pad, True)
        return lut2

    _, t_sweep = timed(one_sweep, ea_a, eb_a, lut0, sizes0, n=3,
                       name="one head sweep @CAP")

    # full phase_a as shipped vs with the packed build patched in
    mn = jnp.float32(170)
    mx = jnp.float32(10 ** 9)
    _, t_full = timed(
        lambda: C._merge_phase_a(labels, mn, mx, K_pad, CAP,
                                 C._MERGE_HEAD_SWEEPS),
        n=3, name="_merge_phase_a shipped")

    # --- ccl.union anatomy: counted while_loop + hop-count variants -------
    # (the union is REPLICATED in the sharded mosaic — every device runs
    # the full K-piece graph — so its wall-clock does not shrink with the
    # mesh)
    piece, kp_dev, _ = C._tiled_ccl_local(labels, C._TILED_CCL_BLOCK)
    K_pieces = int(jax.device_get(kp_dev))
    KP_pad = pad_num_segments(max(K_pieces, 1))
    print(f"\npieces: {K_pieces} (pad {KP_pad})", flush=True)

    @functools.partial(jax.jit, static_argnames=("hops",))
    def union_counted(piece, lab, k, hops: int):
        block = C._TILED_CCL_BLOCK
        pa_parts, pb_parts = [], []

        def seam_pairs(a_p, b_p, a_l, b_l):
            ok = (a_l == b_l) & (a_l >= 0) & (a_p != b_p)
            return (jnp.where(ok, a_p, KP_pad).reshape(-1),
                    jnp.where(ok, b_p, KP_pad).reshape(-1))

        nb_r = (H - 1) // block
        if nb_r:
            p, q = seam_pairs(piece[block - 1::block][:nb_r],
                              piece[block::block][:nb_r],
                              lab[block - 1::block][:nb_r],
                              lab[block::block][:nb_r])
            pa_parts.append(p)
            pb_parts.append(q)
        nb_c = (W - 1) // block
        if nb_c:
            p, q = seam_pairs(piece[:, block - 1::block][:, :nb_c],
                              piece[:, block::block][:, :nb_c],
                              lab[:, block - 1::block][:, :nb_c],
                              lab[:, block::block][:, :nb_c])
            pa_parts.append(p)
            pb_parts.append(q)
        pa = jnp.concatenate(pa_parts)
        pb = jnp.concatenate(pb_parts)
        parent0 = jnp.arange(KP_pad + 1, dtype=jnp.int32)

        def cond(carry):
            _, changed, i = carry
            return changed & (i < 64)

        def body(carry):
            parent, _, i = carry
            ra = parent[pa]
            rb = parent[pb]
            lo = jnp.minimum(ra, rb)
            p2 = parent.at[ra].min(lo).at[rb].min(lo)
            for _ in range(hops):
                p2 = p2[p2]
            return p2, (p2 != parent).any(), i + 1

        true0 = parent0[0] == parent0[0]
        parent, _, iters = jax.lax.while_loop(
            cond, body, (parent0, true0, jnp.int32(0)))
        return parent, iters, pa.shape[0]

    for hops in (3, 6):
        (par, iters, npairs), t_u = timed(
            union_counted, piece, labels, kp_dev, hops, n=3,
            name=f"ccl.union hops={hops}")
        print(f"  union hops={hops}: iters={int(iters)} "
              f"pair-slots={int(npairs)} best={t_u:.2f} s", flush=True)

    print("\nSUMMARY (best of runs)")
    print(f"  sizes0:            {t_sizes:.2f} s")
    print(f"  pairs+cumsum:      {t_cum:.2f} s")
    print(f"  edge build (two):  {t_two:.2f} s")
    print(f"  edge build (pack): {t_pack:.2f} s")
    print(f"  one head sweep:    {t_sweep:.2f} s")
    print(f"  phase_a shipped:   {t_full:.2f} s")


if __name__ == "__main__":
    main()
