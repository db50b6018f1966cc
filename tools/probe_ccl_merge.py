"""Device probes for the connectivity + merge stages at north-star scale.

The OBIA_PROFILE stage timers split the kernel stage into ccl.local,
ccl.union, merge.phase_a and merge.phase_b. This tool measures WHERE
inside those programs the time goes, on the device, over realistic labels
(the actual SLIC assignment of the bench's 100 MP scene):

* scan-CCL alternation counts + wall-clock per block size (the while_loop
  hides its trip count; a counting replica exposes it)
* the dense piece relabel (cumsum + rank gather over 100 MP)
* phase_a split: raw-pair scatter build vs head sweeps vs compaction
* phase_b sweep count (capped + uncapped) via a counting replica

Run as the only JAX process on the card:
    python tools/probe_ccl_merge.py [H] [W]
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

    # --- realistic labels: the bench config-4 segmentation bands ---------
    base3 = build_scene(h=H, w=W, c=4).astype(np.float32)
    img3 = np.stack([base3[..., 0], base3[..., 3] if base3.shape[-1] > 3
                     else base3[..., 0], base3[..., 2]], axis=-1) / 255.0
    n_segments = 3000
    gh, gw = S._grid_shape(H, W, n_segments)
    img_dev = jnp.asarray(img3)
    valid = jnp.ones((H, W), bool)
    t0 = time.perf_counter()
    labels = jax.block_until_ready(S._slic_iterate(
        img_dev, valid, gh, gw, 10.0, 10,
        grid_step=S._grid_step(H, W, n_segments),
        grid_half=S._grid_half(H, W, n_segments)))
    print(f"slic assignment: {time.perf_counter() - t0:.1f} s", flush=True)
    del img_dev

    # --- scan-CCL alternation count + time per block size ----------------
    @functools.partial(jax.jit, static_argnames=("block",))
    def scan_ccl_counted(lab, block):
        yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
        ok = lab >= 0
        comp0 = jnp.where(ok, yy * W + xx, jnp.int32(2 ** 31 - 1))
        cap = max(129, 2 * block + 8)

        def cond(c):
            _, changed, i = c
            return changed & (i < cap)

        def body(c):
            comp, _, i = c
            nxt = C._scan_ccl_pass(lab, comp, block=block)
            return nxt, (nxt != comp).any(), i + 1

        comp, changed, i = jax.lax.while_loop(
            cond, body, (comp0, comp0[0, 0] == comp0[0, 0], jnp.int32(0)))
        return i, ~changed

    for block in (64, 128, 256, 512):
        (it, conv), best = timed(scan_ccl_counted, labels, block,
                                 name=f"scan_ccl block={block}")
        print(f"block={block}: alternations={int(it)} "
              f"converged={bool(conv)} best={best * 1000:.0f} ms",
              flush=True)

    # --- full tiled local + union + relabel per block ---------------------
    for block in (64, 128, 256):
        (piece, k_dev, okc), best = timed(
            C._tiled_ccl_local, labels, block,
            name=f"_tiled_ccl_local block={block}")
        K_pieces = int(k_dev)
        K_pad = pad_num_segments(max(K_pieces, 1))
        print(f"block={block}: local best={best * 1000:.0f} ms "
              f"K_pieces={K_pieces} K_pad={K_pad}", flush=True)
        _, bestu = timed(
            lambda p, l, k: C._tiled_ccl_union(p, l, k, K_pad, block),
            piece, labels, k_dev, name=f"_tiled_ccl_union block={block}")
        print(f"block={block}: union best={bestu * 1000:.0f} ms", flush=True)

    # --- the dense relabel alone (inside _tiled_ccl_local) ----------------
    comp, _ = C._scan_ccl(labels, block=256)
    _, bestr = timed(jax.jit(lambda c: C._dense_relabel_device(c.reshape(-1))),
                     comp, name="dense_relabel 100MP")
    print(f"dense relabel best={bestr * 1000:.0f} ms", flush=True)

    # --- merge phases over the real tiled-CCL labels ----------------------
    lab, k2, _ = C.tiled_scan_ccl_dense_labels(labels)
    K = int(k2)
    K_pad = pad_num_segments(max(K, 1))
    seg_size = H * W / (gh * gw)
    mn = jnp.float32(max(1, int(0.5 * seg_size)))
    mx = jnp.float32(max(1, int(3.0 * seg_size)))
    print(f"CCL K={K} K_pad={K_pad} min={float(mn)} max={float(mx)}",
          flush=True)

    n_valid = int(C._boundary_pair_count(lab))
    CAP = max(C._MERGE_RAW_BUCKET,
              -(-n_valid // C._MERGE_RAW_BUCKET) * C._MERGE_RAW_BUCKET)
    print(f"n_boundary_pairs={n_valid} CAP={CAP}", flush=True)

    (pa_out), besta = timed(
        lambda l: C._merge_phase_a(l, mn, mx, K_pad, CAP,
                                   C._MERGE_HEAD_SWEEPS),
        lab, name="phase_a")
    lut, sizes0, ea2, eb2, n_ext, n_live = pa_out
    n_ext = int(n_ext)
    print(f"phase_a best={besta * 1000:.0f} ms n_ext={n_ext} "
          f"n_live={int(n_live)}", flush=True)

    # phase_a sub-pieces: raw build alone vs head sweeps alone
    @functools.partial(jax.jit, static_argnames=("K_pad", "CAP"))
    def raw_build_only(labels, K_pad, CAP):
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
        return ea, eb

    _, bestrb = timed(lambda l: raw_build_only(l, K_pad, CAP), lab,
                      name="phase_a.raw_build(2 scatters)")
    print(f"raw build (2 scatters) best={bestrb * 1000:.0f} ms", flush=True)

    # packed variant: ONE (2N, 2) scatter — scatter cost is per index row
    @functools.partial(jax.jit, static_argnames=("K_pad", "CAP"))
    def raw_build_packed(labels, K_pad, CAP):
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
        packed = jnp.stack([lo, hi], axis=-1)  # (2N, 2)
        buf = jnp.full((CAP, 2), -1, jnp.int32
                       ).at[idxr].set(packed, mode="drop")
        return buf[:, 0], buf[:, 1]

    (ea_p, eb_p), bestpb = timed(lambda l: raw_build_packed(l, K_pad, CAP),
                                 lab, name="phase_a.raw_build(packed)")
    print(f"raw build (packed) best={bestpb * 1000:.0f} ms", flush=True)
    ea_r, eb_r = raw_build_only(lab, K_pad, CAP)
    same = bool(jnp.array_equal(ea_p, ea_r) & jnp.array_equal(eb_p, eb_r))
    print(f"packed == 2-scatter: {same}", flush=True)

    # head sweeps alone (on the built raw buffer)
    @functools.partial(jax.jit, static_argnames=("K_pad", "s0"))
    def head_sweeps_only(ea, eb, sizes0, K_pad, s0):
        lut = jnp.arange(K_pad, dtype=jnp.int32)
        for _ in range(s0):
            lut, _ = C._merge_small_sweep_edges(ea, eb, lut, sizes0,
                                                mn, mx, K_pad, True)
        return lut

    _, besths = timed(lambda a, b, s: head_sweeps_only(a, b, s, K_pad, 2),
                      ea_r, eb_r, sizes0, name="phase_a.head_sweeps(2)")
    print(f"head sweeps x2 best={besths * 1000:.0f} ms", flush=True)

    # --- phase_b with sweep counting ---------------------------------------
    E2 = min(CAP, max(C._MERGE_EDGE_BUCKET,
                      -(-n_ext // C._MERGE_EDGE_BUCKET)
                      * C._MERGE_EDGE_BUCKET))
    print(f"E2={E2}", flush=True)

    @functools.partial(jax.jit, static_argnames=("K_pad", "E2", "max_iters"))
    def phase_b_counted(labels, lut, sizes0, ea2, eb2, K_pad, E2, max_iters):
        ea = jax.lax.slice_in_dim(ea2, 0, E2)
        eb = jax.lax.slice_in_dim(eb2, 0, E2)

        def phase(lut, capped):
            def cond(c):
                _, ch, i = c
                return ch & (i < max_iters)

            def body(c):
                lut, _, i = c
                lut, ch = C._merge_small_sweep_edges(
                    ea, eb, lut, sizes0, mn, mx, K_pad, capped)
                return lut, ch, i + 1

            return jax.lax.while_loop(
                cond, body, (lut, jnp.asarray(True), jnp.int32(0)))

        lut, _, i_cap = phase(lut, True)
        sizes_now = jax.ops.segment_sum(sizes0, lut, num_segments=K_pad)
        any_small = ((sizes_now > 0) & (sizes_now < mn)).any()
        lut, _, i_unc = jax.lax.cond(
            any_small, lambda l: phase(l, False),
            lambda l: (l, jnp.asarray(False), jnp.int32(0)), lut)
        lab2, k = C._merge_finalize(labels, lut, sizes0, K_pad)
        return lab2, k, i_cap, i_unc

    (lab2, kf, i_cap, i_unc), bestb = timed(
        lambda l, lu, s, a, b: phase_b_counted(l, lu, s, a, b, K_pad, E2, 512),
        lab, lut, sizes0, ea2, eb2, name="phase_b")
    print(f"phase_b best={bestb * 1000:.0f} ms capped_sweeps={int(i_cap)} "
          f"uncapped_sweeps={int(i_unc)} K_final={int(kf)}", flush=True)

    # finalize alone
    _, bestf = timed(lambda l, lu, s: C._merge_finalize(l, lu, s, K_pad),
                     lab, lut, sizes0, name="merge_finalize")
    print(f"finalize best={bestf * 1000:.0f} ms", flush=True)


if __name__ == "__main__":
    main()
