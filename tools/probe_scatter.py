"""Scatter-rate probe: what bounds the GLCM joint-histogram floor?

The 100 MP GLCM stage is N-row scatter-adds into (K, levels²) tables
(obia_tpu/ops/glcm.py). Whether their floor is the index rows issued,
memory bandwidth, or contention on shared bins decides the GLCM design.
This probe separates the hypotheses by measuring scatter-add throughput
across:

  * payload width   (1 -> 128 lanes: is cost per ROW or per element?)
  * table size      (1 MB -> 700 MB: does the random-access span matter?)
  * key locality    (keys confined to 1 MB blocks vs uniform: cache/TLB?)
  * sorted keys     (best case: does XLA exploit monotone indices?)

Interpretation guide:
  - payload ~free + size/locality irrelevant  => issue-bound: only row
    REDUCTION helps (shard over mesh; payload-pack the five non-ASM props)
  - locality matters                          => tile labels into block
    slots ((n_blocks, S, L²) two-level histogram)
  - sorted much faster                        => block-local sort + run
    aggregation before one compact scatter

Usage: python tools/probe_scatter.py [n_rows]  (default 16M)
Prints one JSON line per configuration.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def main(n: int = 1 << 24) -> None:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    print(json.dumps({"probe": "platform", "platform": dev.platform,
                      "device": str(dev), "n_rows": n}))

    rng = np.random.default_rng(0)

    def bench(name, table_rows, width, keys_np, runs=3):
        table = jnp.zeros((table_rows, width), jnp.float32)
        keys = jnp.asarray(keys_np[:, None])
        upd = jnp.ones((n, width), jnp.float32)

        @jax.jit
        def go(t, k, u):
            dnums = jax.lax.ScatterDimensionNumbers(
                update_window_dims=(1,), inserted_window_dims=(0,),
                scatter_dims_to_operand_dims=(0,))
            return jax.lax.scatter_add(
                t, k, u, dnums, indices_are_sorted=False,
                unique_indices=False)

        go(table, keys, upd).block_until_ready()  # compile
        best = float("inf")
        for _ in range(runs):
            t0 = time.perf_counter()
            go(table, keys, upd).block_until_ready()
            best = min(best, time.perf_counter() - t0)
        print(json.dumps({
            "probe": name, "table_rows": table_rows, "payload_width": width,
            "seconds": round(best, 4),
            "mrows_per_s": round(n / best / 1e6, 1)}), flush=True)

    # CPU smoke runs shrink the tables (no device memory to probe)
    shrink = 64 if dev.platform == "cpu" else 1
    big = 4 * (1 << 20) // shrink  # ~ K * levels^2 scale: 4M rows
    uniform_big = rng.integers(0, big, n).astype(np.int32)

    # 1) payload width sweep at fixed table
    for w in (1, 8, 32, 128):
        bench(f"payload_w{w}", 1 << 18, w, rng.integers(0, 1 << 18, n)
              .astype(np.int32))
    # 2) table size sweep at width 1
    for rows in (1 << 14, 1 << 18, big):
        bench(f"table_{rows}", rows, 1,
              rng.integers(0, rows, n).astype(np.int32))
    # 3) locality: same big table, keys confined to 64k-row blocks,
    #    consecutive updates share a block (GLCM label-tiling analogue)
    block = 1 << 16
    n_blocks = big // block
    per_block = n // n_blocks
    local = (np.repeat(np.arange(n_blocks), per_block)[:n] * block
             + rng.integers(0, block, n)).astype(np.int32)
    bench("local_blocks", big, 1, local)
    # 4) fully sorted keys (monotone best case)
    bench("sorted", big, 1, np.sort(uniform_big))
    # 5) the GLCM shape itself: one angle of a 3k-segment 256-level table
    glcm_rows = 3072 * 256 * 256 // shrink  # 805 MB f32 on device
    bench("glcm_shape", glcm_rows, 1,
          rng.integers(0, glcm_rows, n).astype(np.int32))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 24)
