"""End-to-end benchmark: segment + featurize + classify throughput.

Mirrors BASELINE.json config 1 (slic n_segments=3000, compactness=10 +
rf n_estimators=300) on a synthetic multispectral scene, timing the full
user flow — SLIC label raster, connectivity enforcement, polygonisation,
fused per-object statistics (spectral + GLCM), forest inference, and the
GeoDataFrame assembly — and reports megapixels/second.

Runs only on a GPU: anywhere else it exits non-zero and prints no rate.
Prints ONE JSON line: {"metric", "value", "unit", "device", ...extras}.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def build_scene(h=2048, w=2048, c=3, seed=0):
    """Synthetic RGB scene (config 1 is 'one RGB GeoTIFF'): uint8, so the
    device upload ships native bytes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([
        np.sin(yy / 97.0) + np.cos(xx / 131.0),
        np.sin((yy + xx) / 151.0),
        np.cos(yy / 71.0) * np.sin(xx / 113.0),
        ((yy // 256 + xx // 256) % 5).astype(np.float32) / 4.0,
    ], axis=-1)[:, :, :c].astype(np.float32)
    noise = rng.normal(0, 0.05, (h, w, c)).astype(np.float32)
    arr = base + noise
    lo, hi = arr.min(), arr.max()
    return (255.0 * (arr - lo) / (hi - lo)).astype(np.uint8)


def run_pipeline(img_np, n_segments=3000, n_estimators=300, train_frac=0.2,
                 seed=0):
    from obia_tpu.classification.forest import JaxForestClassifier
    from obia_tpu.geometry.affine import Affine
    from obia_tpu.handlers.geotif import image_from_array
    from obia_tpu.segmentation.segment import segment

    h = img_np.shape[0]
    image = image_from_array(img_np, Affine(1.0, 0, 0, 0, -1.0, h),
                             crs="EPSG:32633")
    s = segment(image, method="slic", n_segments=n_segments, compactness=10)
    objs = s.segments
    clf = JaxForestClassifier(n_estimators=n_estimators, random_state=0)
    proba = _featurize_classify(objs, clf, seed=seed, train_frac=train_frac)
    return len(objs), proba


def _featurize_classify(objs, clf, seed=0, train_frac=0.2):
    """The shared classify tail of every config: feature table -> median
    split target -> seeded training subset -> fit -> predict_proba. The rng
    is reseeded PER CALL so steady-state runs fit the identical table
    (reproducible, and the deterministic fit cache can hit)."""
    feats = objs.drop(columns=["geometry", "segment_id"], errors="ignore")
    feats = feats.loc[:, feats.notna().any()]
    X = np.nan_to_num(feats.to_numpy(dtype=np.float64))
    y = (X[:, 0] > np.median(X[:, 0])).astype(int)
    n_train = max(10, int(len(X) * train_frac))
    idx = np.random.default_rng(seed).permutation(len(X))[:n_train]
    clf.fit(X[idx], y[idx])
    return clf.predict_proba(X)


def _device() -> dict:
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _emit(mp, elapsed, warm, n_obj, config, extra=None, emit=True):
    value = mp / elapsed
    out = {
        "metric": "megapixels/sec end-to-end (segment+featurize+classify)",
        "value": round(value, 3),
        "unit": "MP/s",
        "device": _device(),
        "elapsed_s": round(elapsed, 2),
        "first_run_s": round(warm, 2),
        "megapixels": round(mp, 2),
        "n_objects": int(n_obj),
        "config": config,
    }
    out.update(extra or {})
    if emit:
        print(json.dumps(out))
    return out


def _timed(fn, runs=None):
    """first run = compile+cache; steady state = best of the next runs."""
    if runs is None:
        runs = int(os.environ.get("OBIA_BENCH_RUNS", "3"))
    t0 = time.time()
    n = fn()
    warm = time.time() - t0
    # OBIA_BENCH_RUNS=1 means exactly ONE run: the cold time doubles as
    # the steady-state value
    best = warm
    for _ in range(max(0, runs - 1)):
        t0 = time.time()
        n = fn()
        best = min(best, time.time() - t0)
    return n, best, warm


def bench_config1(size, emit=True):
    """slic n_segments=3000 compactness=10 + rf n_estimators=300 (RGB)."""
    img = build_scene(h=size, w=size)
    mp = img.shape[0] * img.shape[1] / 1e6
    n_obj, elapsed, warm = _timed(lambda: run_pipeline(img)[0])
    return _emit(mp, elapsed, warm, n_obj, "1-quickstart-slic-rf", emit=emit)


def bench_config2(size):
    """quickshift segmentation + mlp classifier on the RGB scene."""
    from obia_tpu.classification.mlp import FlaxMLPClassifier
    from obia_tpu.geometry.affine import Affine
    from obia_tpu.handlers.geotif import image_from_array
    from obia_tpu.segmentation.segment import segment

    img_np = build_scene(h=size, w=size)
    mp = size * size / 1e6
    image = image_from_array(img_np, Affine(1.0, 0, 0, 0, -1.0, size),
                             crs="EPSG:32633")

    def go():
        s = segment(image, method="quickshift", ratio=1.0, kernel_size=5,
                    max_dist=10.0)
        clf = FlaxMLPClassifier(hidden_layer_sizes=(64,), max_iter=60,
                                random_state=0)
        _featurize_classify(s.segments, clf)
        return len(s.segments)

    n_obj, elapsed, warm = _timed(go)
    return _emit(mp, elapsed, warm, n_obj, "2-quickshift-mlp")


def bench_config3(size, emit=True):
    """tiled slic via create_tiled_segments (checkerboard seam driver)."""
    import tempfile

    from obia_tpu.geometry.affine import Affine
    from obia_tpu.io.tiff import write_tiff
    from obia_tpu.utils.tiling import create_tiled_segments

    img_np = build_scene(h=size, w=size)
    mp = size * size / 1e6
    tmp = tempfile.mkdtemp(prefix="obia_bench3_")
    raster = os.path.join(tmp, "scene.tif")
    write_tiff(raster, img_np, transform=Affine(1.0, 0, 0, 0, -1.0, size),
               crs="EPSG:32633", compression="none")

    out_dirs = []

    def go():
        out_dir = tempfile.mkdtemp(prefix="obia_bench3_out_")
        out_dirs.append(out_dir)
        gdf = create_tiled_segments(raster, out_dir, tile_size=512,
                                    buffer=64, n_segments=700)
        return len(gdf)

    try:
        n_obj, elapsed, warm = _timed(go)
    finally:
        # the scene tif (~50 MB at 4096^2) and one output dir of GPKGs per
        # timed run would otherwise accumulate in /tmp across driver runs
        import shutil
        for d in out_dirs:
            shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(tmp, ignore_errors=True)
    return _emit(mp, elapsed, warm, n_obj, "3-tiled-slic", emit=emit)


def bench_config4(size, emit=True):
    """multispectral: 8-band scene, segmentation_bands subset, GLCM + rf."""
    from obia_tpu.classification.forest import JaxForestClassifier
    from obia_tpu.geometry.affine import Affine
    from obia_tpu.handlers.geotif import image_from_array
    from obia_tpu.segmentation.segment import segment

    base3 = build_scene(h=size, w=size, c=4).astype(np.float32)
    more = np.stack([np.roll(base3[..., i % 4], 17 * (i + 1), axis=i % 2)
                     for i in range(4)], axis=-1)
    img_np = np.concatenate([base3, more], axis=-1).astype(np.uint8)
    image = image_from_array(img_np, Affine(1.0, 0, 0, 0, -1.0, size),
                             crs="EPSG:32633")
    mp = size * size / 1e6

    def go():
        s = segment(image, segmentation_bands=[0, 3, 6],
                    statistics_bands=list(range(8)), method="slic",
                    n_segments=3000, compactness=10)
        clf = JaxForestClassifier(n_estimators=300, random_state=0)
        _featurize_classify(s.segments, clf)
        return len(s.segments)

    n_obj, elapsed, warm = _timed(go)
    return _emit(mp, elapsed, warm, n_obj, "4-multispectral-glcm-rf",
                 emit=emit)


def bench_config5(size, emit=True):
    """sharded multi-tile mosaic over a mesh of all local devices."""
    from obia_tpu.geometry.affine import Affine
    from obia_tpu.handlers.geotif import image_from_array
    from obia_tpu.parallel.mosaic import mosaic_pipeline
    from obia_tpu.parallel.sharded import make_mesh

    img_np = build_scene(h=size, w=size)
    image = image_from_array(img_np, Affine(1.0, 0, 0, 0, -1.0, size),
                             crs="EPSG:32633")
    mp = size * size / 1e6
    import jax
    mesh = make_mesh(len(jax.devices()))

    def go():
        objs = mosaic_pipeline(image, n_segments=3000, compactness=10.0,
                               mesh=mesh)
        return len(objs)

    n_obj, elapsed, warm = _timed(go)
    return _emit(mp, elapsed, warm, n_obj, "5-sharded-mosaic",
                 {"mesh": list(mesh.devices.shape)}, emit=emit)


def _bench_default(size):
    """Default sweep (no --config): configs 1 and 4, then config 3 (tiled
    driver) and config 5 (sharded mosaic over every local device) once
    each. ONE JSON line goes to stdout: primary = config 4 (the
    multispectral GLCM path), all rows under "rows"."""
    rows = []

    def _try(name, fn):
        try:
            row = fn()
            rows.append(row)
            print(f"bench {name}: {json.dumps(row)}", file=sys.stderr)
        except Exception as e:  # a broken config must not hide the others
            rows.append({"config": name,
                         "error": f"{type(e).__name__}: {e}"[:200]})

    _try("1-quickstart-slic-rf", lambda: bench_config1(size, emit=False))
    _try("4-multispectral-glcm-rf", lambda: bench_config4(size, emit=False))
    if os.environ.get("OBIA_BENCH_DEFAULT_FULL", "1") == "1":
        # config 3 is host-bound (per-tile GPKG writes), so the default
        # sweep runs it and config 5 ONCE each at their tracked sizes
        prev_runs = os.environ.get("OBIA_BENCH_RUNS")
        os.environ["OBIA_BENCH_RUNS"] = "1"
        _try("3-tiled-slic", lambda: bench_config3(min(size, 2048),
                                                   emit=False))
        _try("5-sharded-mosaic", lambda: bench_config5(size, emit=False))
        if prev_runs is None:
            os.environ.pop("OBIA_BENCH_RUNS", None)
        else:
            os.environ["OBIA_BENCH_RUNS"] = prev_runs

    primary = next((r for r in rows if r.get("config") ==
                    "4-multispectral-glcm-rf" and "error" not in r), None)
    if primary is None:  # config 4 failed: fall back to config 1
        primary = next((r for r in rows if "error" not in r), rows[0])
    out = dict(primary)
    out["rows"] = rows
    print(json.dumps(out))


def main():
    argv = sys.argv[1:]
    config = None
    skip = set()
    for i, a in enumerate(argv):
        if a == "--config" or a.startswith("--config="):
            if "=" in a:
                config = int(a.split("=", 1)[1])
            elif i + 1 < len(argv):
                config = int(argv[i + 1])
                skip.add(i + 1)  # the value token is NOT a positional size
            else:
                print("usage: bench.py [size] [--config N]", file=sys.stderr)
                sys.exit(2)
    args = [a for i, a in enumerate(argv)
            if not a.startswith("--") and i not in skip]
    size = int(args[0]) if args else 4096  # peak steady-state MP/s size
    if config == 2 and not args:
        size = 1024  # quickshift is O(kernel^2) per pixel; 1 MP default
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"bench: JAX found no GPU (platform {platform!r})")
    from obia_tpu import compile_cache
    compile_cache.enable()
    if config is None:
        _bench_default(size)
    else:
        {1: bench_config1, 2: bench_config2, 3: bench_config3,
         4: bench_config4, 5: bench_config5}[config](size)


if __name__ == "__main__":
    main()
