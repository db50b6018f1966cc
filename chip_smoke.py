"""Smoke run of the OBIA main path on an NVIDIA GPU.

Drives the path a user calls -- ``write_tiff`` -> ``open_geotiff`` ->
``segment`` (SLIC, connectivity, polygonisation, spectral and GLCM
features) -> ``label_segments`` -> ``classify(method="rf")`` -> GeoPackage
-> ``read_file`` -- on a synthetic WorldView-3-style scene made from
``--seed`` (8 bands, uint16 in the 11-bit range 0..2047), once cold and once
warm, then checks what the card computed against plain references.

    python chip_smoke.py [--size N] [--seed S]   # one card, N x N scene
    python chip_smoke.py --four-cards            # mosaic_pipeline, 2x2 mesh
                                                 # against a 1-device mesh

It runs only on a GPU and exits non-zero anywhere else, or when a check
fails. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_BANDS = 8
N_CLASSES = 5
PARCEL_PX = 40          # side of one land-cover parcel of the synthetic scene
GSD_M = 1.24            # WorldView-3 multispectral ground sample distance
SEGMENTATION_BANDS = [0, 3, 6]
GLCM_PROPS = ("contrast", "dissimilarity", "homogeneity", "ASM", "energy",
              "correlation")

# Tolerances of the reference checks, each with its reason.
# (a) Two independent SLIC implementations of one objective (the device's
#     and the numpy oracle's): the thresholds of tests/test_parity_oracle.py,
#     on that test's smooth scene at 512 x 512 with 150 segments. The
#     compactness, 40 in Lab units, keeps the spatial term comparable to the
#     colour term: where colour dominates, the device's 3 x 3 grid-neighbour
#     search and the oracle's 2-step window per centre settle in different
#     local optima (ARI 0.5-0.9 at compactness 10, on the CPU as well).
SLIC_MIN_ARI = 0.95
SLIC_MIN_BOUNDARY_RECALL = 0.98
SLIC_CHECK_SIZE = 512
SLIC_CHECK_SEGMENTS = 150
SLIC_CHECK_COMPACTNESS = 40.0
# (b) Per-object sums run in float32 and GPU atomics add in no fixed order,
#     so an object of n pixels drifts like sqrt(n) * u (u = 2^-24, measured
#     ~1 * sqrt(n) * u on the CPU and the H100 alike). The mean gets
#     1e-5 relative, or 4 sqrt(n) u for objects above ~4k pixels; the std,
#     whose pass sums squared deviations, gets 1e-4, or 12 sqrt(n) u.
#     Min and max pick input values, so they are exact.
SPECTRAL_RTOL = 1e-5
SPECTRAL_STD_RTOL = 1e-4
_U32 = 2.0 ** -24


def spectral_rtol(n_pixels, stat: str):
    """(b)'s relative tolerance for ``stat`` ("mean" or "std") of objects
    of ``n_pixels`` pixels."""
    floor, k = (SPECTRAL_RTOL, 4) if stat == "mean" else (SPECTRAL_STD_RTOL,
                                                          12)
    return np.maximum(floor, k * np.sqrt(n_pixels) * _U32)
# (c) The joint-histogram counts are integers, so only the float32
#     reductions over the 256 x 256 table differ. Props bounded by 1
#     (homogeneity, ASM, energy, correlation) get 1e-4 absolute; contrast and
#     dissimilarity are in grey-level units (up to 255^2), so the same 1e-4
#     applies relative to the value. Correlation is a ratio of differences
#     of float32 moment sums, (E[ij] - mu^2) / (E[i^2] - mu^2); an object
#     whose levels sit far from their mean loses ~(mu^2 / var) * 1e-6 to
#     cancellation (1.4e-4 measured on the CPU on a 512 x 512 crop), so it
#     gets 1e-3 absolute.
GLCM_TOL = 1e-4
GLCM_CORR_TOL = 1e-3
GLCM_SAMPLE = 200
# (d) The device traversal pins its one float32 product to HIGHEST and
#     compares float32 features with float32 thresholds, exactly as the
#     float64 host traversal does; leaf fractions are float32.
FOREST_ATOL = 1e-6


def require_gpu(devices):
    """Return ``devices``, or exit when JAX's first device is not a GPU: a
    smoke run on any other platform says nothing about the card."""
    platform = devices[0].platform if devices else None
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{platform!r}); refusing to run")
    return devices


def card_info() -> str:
    """Each card's name and power limit, read by nvidia-smi in a child
    process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def versions() -> dict:
    import importlib
    out = {}
    for name in ("jax", "jaxlib", "pandas", "sklearn"):
        try:
            out[name] = importlib.import_module(name).__version__
        except ImportError:
            out[name] = "not installed"
    return out


def make_scene(size: int, seed: int):
    """(size, size, 8) uint16 scene in 0..2047 and its (size, size) class
    map: square parcels of N_CLASSES land covers, each with its own 8-band
    signature, under smooth shading and per-pixel noise."""
    rng = np.random.default_rng(seed)
    g = -(-size // PARCEL_PX)
    coarse = rng.integers(0, N_CLASSES, (g, g), dtype=np.uint8)
    classes = np.repeat(np.repeat(coarse, PARCEL_PX, 0), PARCEL_PX,
                        1)[:size, :size]
    signature = rng.uniform(150, 1700, (N_CLASSES, N_BANDS)).astype(
        np.float32)
    t = np.arange(size, dtype=np.float32)
    scene = np.empty((size, size, N_BANDS), np.uint16)
    for b in range(N_BANDS):
        band = signature[classes, b]
        band += 60 * np.sin(t / (90 + 7 * b))[:, None]
        band += 60 * np.cos(t / (130 + 5 * b))[None, :]
        band += 40 * rng.standard_normal((size, size), dtype=np.float32)
        scene[..., b] = np.clip(np.rint(band), 0, 2047)
    return scene, classes


def _transform(size: int):
    from obia_tpu.geometry import Affine
    return Affine(GSD_M, 0, 500000.0, 0, -GSD_M, 4100000.0 + size * GSD_M)


def labelled_points(classes, seed: int, n_points: int):
    """Seeded points at pixel centres, each with the class under it."""
    from obia_tpu.geometry.geom import Point
    from obia_tpu.vector import GeoDataFrame
    size = classes.shape[0]
    rng = np.random.default_rng(seed + 1)
    r = rng.integers(0, size, n_points)
    c = rng.integers(0, size, n_points)
    t = _transform(size)
    pts = [Point(*(t * (float(ci) + 0.5, float(ri) + 0.5)))
           for ri, ci in zip(r, c)]
    return GeoDataFrame({"class": classes[r, c].astype(np.int64)},
                        geometry=pts)


def run_main_path(tif: str, points, out_gpkg: str, seed: int,
                  n_segments: int, n_estimators: int):
    """One pass of the user's path from the GeoTIFF to the reopened
    GeoPackage, each call under a ``main.*`` telemetry span. Returns
    (segments, training table, reopened table)."""
    from obia_tpu import telemetry
    from obia_tpu.classification.classify import classify
    from obia_tpu.handlers.geotif import open_geotiff
    from obia_tpu.segmentation.segment import segment
    from obia_tpu.utils.utils import label_segments
    from obia_tpu.vector import GeoDataFrame, read_file

    with telemetry.stage("main.open_geotiff"):
        img = open_geotiff(tif)
    with telemetry.stage("main.segment"):
        s = segment(img, segmentation_bands=SEGMENTATION_BANDS,
                    statistics_bands=list(range(N_BANDS)), method="slic",
                    n_segments=n_segments, compactness=10)
    with telemetry.stage("main.label_segments"):
        training, _ = label_segments(s.segments, points)
    with telemetry.stage("main.classify"):
        result = classify(s.segments, training, method="rf",
                          n_estimators=n_estimators, random_state=seed)
    if os.path.exists(out_gpkg):
        os.remove(out_gpkg)
    with telemetry.stage("main.to_file"):
        GeoDataFrame(result.classified).to_file(out_gpkg)
    with telemetry.stage("main.read_file"):
        reopened = read_file(out_gpkg)
    return s, training, reopened


def main_path_phase(size: int, seed: int, workdir: str,
                    n_segments: int = 3000, n_estimators: int = 300,
                    n_points: int = 1500):
    """Cold, warm and per-stage runs of the main path. Returns a dict with
    the timings, the stage split and the warm run's outputs."""
    import jax

    from obia_tpu import telemetry
    from obia_tpu.io.tiff import write_tiff

    t0 = time.perf_counter()
    scene, classes = make_scene(size, seed)
    tif = os.path.join(workdir, "scene.tif")
    write_tiff(tif, scene, transform=_transform(size), crs="EPSG:32633",
               compression="none")
    points = labelled_points(classes, seed, n_points)
    setup_s = time.perf_counter() - t0

    gpkg = os.path.join(workdir, "classified.gpkg")

    def once():
        t = time.perf_counter()
        out = run_main_path(tif, points, gpkg, seed, n_segments,
                            n_estimators)
        return out, time.perf_counter() - t

    telemetry.reset()
    _, cold_s = once()
    telemetry.reset()
    (s, training, reopened), warm_s = once()
    # a third pass with the stage timers blocking on the device, so each
    # stage is charged its own device work (costs the async overlap, so
    # it is not the warm time)
    telemetry.reset()
    telemetry.enable(True)
    try:
        once()
    finally:
        telemetry.enable(False)
    stages = telemetry.report()
    stats = jax.devices()[0].memory_stats() or {}
    return {"scene": scene, "segments": s, "training": training,
            "reopened": reopened, "setup_s": setup_s, "cold_s": cold_s,
            "warm_s": warm_s, "stages": stages,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use")}


# --- reference checks ---------------------------------------------------


def check_slic(size: int = SLIC_CHECK_SIZE,
               n_segments: int = SLIC_CHECK_SEGMENTS):
    """(a) Device SLIC with the Lab conversion against the numpy oracle."""
    from obia_tpu.ops.slic import slic
    from oracle_slic import (adjusted_rand_index, boundary_recall,
                             rgb_to_lab64, slic_oracle)
    from test_parity_oracle import scene
    rgb = scene(size, size)
    got = slic(rgb, n_segments=n_segments,
               compactness=SLIC_CHECK_COMPACTNESS, start_label=0,
               convert2lab=True)
    want = slic_oracle(rgb_to_lab64(rgb), n_segments=n_segments,
                       compactness=SLIC_CHECK_COMPACTNESS)
    ari = adjusted_rand_index(got, want)
    br = boundary_recall(got, want, tolerance_px=2)
    ok = ari >= SLIC_MIN_ARI and br >= SLIC_MIN_BOUNDARY_RECALL
    return ok, (f"{size}x{size}, n_segments={n_segments}, compactness "
                f"{SLIC_CHECK_COMPACTNESS}: ARI={ari!r} (>= {SLIC_MIN_ARI}), "
                f"boundary recall@2px={br!r} "
                f"(>= {SLIC_MIN_BOUNDARY_RECALL})")


def _object_pixels(labels):
    """Pixel indices sorted by label, with each label's start offset."""
    flat = labels.reshape(-1)
    pix = np.flatnonzero(flat >= 0)
    pix = pix[np.argsort(flat[pix], kind="stable")]
    lab = flat[pix]
    starts = np.flatnonzero(np.r_[True, lab[1:] != lab[:-1]])
    return pix, lab[starts], starts


def _rows_by_label(objects):
    return objects["segment_id"].to_numpy().astype(np.int64) - 1


def check_spectral(scene, objects, pix, ids, starts):
    """(b) Per-object mean, std, min and max of every band in float64."""
    row_of = _rows_by_label(objects)
    n_labels = max(ids.max(), row_of.max()) + 1
    counts = np.diff(np.r_[starts, len(pix)])
    worst = {"mean": 0.0, "std": 0.0}
    exact = True
    for b in range(scene.shape[2]):
        v = scene[..., b].reshape(-1)[pix].astype(np.float64)
        mean = np.add.reduceat(v, starts) / counts
        std = np.sqrt(np.add.reduceat((v - np.repeat(mean, counts)) ** 2,
                                      starts) / counts)
        want = {"mean": mean, "std": std,
                "min": np.minimum.reduceat(v, starts),
                "max": np.maximum.reduceat(v, starts)}
        got_rows = {
            "mean": objects[f"b{b}_mean"].to_numpy(),
            "std": np.sqrt(objects[f"b{b}_variance"].to_numpy()),
            "min": objects[f"b{b}_min"].to_numpy(),
            "max": objects[f"b{b}_max"].to_numpy()}
        for name, w in want.items():
            g = np.full(n_labels, np.nan)
            g[row_of] = got_rows[name]
            g = g[ids]
            if name in ("min", "max"):
                exact &= bool(np.array_equal(g, w))
            else:
                rel = (np.abs(g - w) / np.maximum(np.abs(w), 1e-30)
                       / spectral_rtol(counts, name))
                worst[name] = max(worst[name], float(np.nanmax(rel)))
                if np.isnan(g).any():
                    worst[name] = np.inf
    ok = exact and max(worst.values()) <= 1.0
    return ok, (f"{len(ids)} objects (up to {counts.max()} px) x "
                f"{scene.shape[2]} bands: max rel err as a multiple of its "
                f"tolerance (<= 1) mean={worst['mean']!r} "
                f"std={worst['std']!r}; min/max exact={exact}")


def _glcm_err(prop: str, got, want):
    """|got - want| as a multiple of (c)'s tolerance for ``prop``."""
    if prop == "correlation":
        return np.abs(got - want) / GLCM_CORR_TOL
    scale = (np.maximum(1.0, np.abs(want))
             if prop in ("contrast", "dissimilarity") else 1.0)
    return np.abs(got - want) / scale / GLCM_TOL


def check_glcm(scene, labels, objects, pix, ids, starts, seed: int):
    """(c) GLCM props of sampled objects against the naive oracle, each on
    its bounding box with every other object masked out."""
    from test_ops_stats import naive_glcm_props
    W = labels.shape[1]
    labels_of_rows = _rows_by_label(objects)
    row_of = np.full(max(ids.max(), labels_of_rows.max()) + 1, -1)
    row_of[labels_of_rows] = np.arange(len(objects))
    ends = np.r_[starts[1:], len(pix)]
    rng = np.random.default_rng(seed + 2)
    pick = rng.choice(len(ids), min(GLCM_SAMPLE, len(ids)), replace=False)
    worst = dict.fromkeys(GLCM_PROPS, 0.0)
    where = {}
    for i in pick:
        p = pix[starts[i]:ends[i]]
        r, c = p // W, p % W
        r0, r1, c0, c1 = r.min(), r.max() + 1, c.min(), c.max() + 1
        lab = np.where(labels[r0:r1, c0:c1] == ids[i], 0, -1)
        row = row_of[ids[i]]
        for b in range(scene.shape[2]):
            want = naive_glcm_props(
                scene[r0:r1, c0:c1, b].astype(np.float32), lab, 1,
                levels=256, distance=2)
            for prop in GLCM_PROPS:
                w = want[prop][0]
                g = objects[f"b{b}_{prop}"].iloc[row]
                if np.isnan(w) and np.isnan(g):
                    continue
                err = _glcm_err(prop, g, w)
                err = err if np.isfinite(err) else np.inf
                if err > worst[prop]:
                    worst[prop] = err
                    where[prop] = (int(ids[i]), b, len(p), float(g),
                                   float(w))
    return max(worst.values()) <= 1.0, (
        f"{len(pick)} objects x {scene.shape[2]} bands: max err as a "
        f"multiple of its tolerance (<= 1) "
        + ", ".join(f"{p}={float(v)!r}" for p, v in worst.items())
        + "; worst (label, band, pixels, got, want): "
        + ", ".join(f"{p}={where[p]}" for p in where))


def check_forest(objects, training, seed: int, n_estimators: int):
    """(d) The device forest traversal against the float64 host traversal
    of the same fitted forest, on every object of the scene."""
    from obia_tpu.classification.classify import _feature_frame
    from obia_tpu.classification.forest import JaxForestClassifier
    from obia_tpu.classification.trees import predict_proba_host
    x = _feature_frame(training)
    clf = JaxForestClassifier(n_estimators=n_estimators, random_state=seed)
    clf.fit(x.to_numpy(), training["feature_class"].to_numpy())
    table = _feature_frame(objects).reindex(columns=x.columns).to_numpy()
    got = clf.predict_proba(table)
    want = predict_proba_host(clf.trees_, table)
    err = float(np.abs(got - want).max())
    return err <= FOREST_ATOL, (
        f"{table.shape[0]} objects x {table.shape[1]} features, "
        f"{n_estimators} trees: max abs err {err!r} (<= {FOREST_ATOL})")


def check_connectivity(labels):
    """(e) Each label is one 4-connected component (host union-find)."""
    from obia_tpu import native
    n_comp = native.host_ccl(labels)[1]
    n_labels = len(np.unique(labels[labels >= 0]))
    return n_comp == n_labels, (f"{n_labels} labels, {n_comp} 4-connected "
                                "components")


def reference_checks(res: dict, seed: int, n_estimators: int,
                     slic_size: int = SLIC_CHECK_SIZE,
                     slic_segments: int = SLIC_CHECK_SEGMENTS):
    """Run checks (a)-(e) on the warm run's output; [(name, ok, detail)]."""
    scene = res["scene"]
    s = res["segments"]
    objects = s.segments
    labels = np.asarray(s.label_raster)
    pix, ids, starts = _object_pixels(labels)
    return [
        ("a slic-oracle", *check_slic(slic_size, slic_segments)),
        ("b spectral", *check_spectral(scene, objects, pix, ids, starts)),
        ("c glcm", *check_glcm(scene, labels, objects, pix, ids, starts,
                               seed)),
        ("d forest", *check_forest(objects, res["training"], seed,
                                   n_estimators)),
        ("e connectivity", *check_connectivity(labels)),
        ("gpkg round trip", len(res["reopened"]) == len(objects),
         f"{len(res['reopened'])} rows read back of {len(objects)}"),
    ]


# --- four cards ---------------------------------------------------------


def _compare_objects(a, b, n_max: int):
    """Spectral columns within (b)'s tolerances for objects of up to
    ``n_max`` pixels (the variance's is twice the std's) and GLCM columns
    within (c)'s, row by row; (ok, detail)."""
    tol_mean = float(spectral_rtol(n_max, "mean"))
    tol_var = 2 * float(spectral_rtol(n_max, "std"))
    worst_sp = 0.0
    worst_var = 0.0
    worst_gl = 0.0
    for col in a.columns:
        if col in ("geometry", "segment_id") or not col.startswith("b"):
            continue
        x = a[col].to_numpy(float)
        y = b[col].to_numpy(float)
        if not np.array_equal(np.isnan(x), np.isnan(y)):
            return False, f"{col}: NaN pattern differs"
        m = ~np.isnan(x)
        prop = col.split("_", 1)[1]
        if prop in GLCM_PROPS:
            worst_gl = max(worst_gl, float(np.max(
                _glcm_err(prop, x[m], y[m]), initial=0)))
        elif prop in ("mean", "min", "max", "variance"):
            rel = float(np.max(np.abs(x[m] - y[m])
                               / np.maximum(np.abs(y[m]), 1e-30), initial=0))
            if prop == "variance":
                worst_var = max(worst_var, rel)
            else:
                worst_sp = max(worst_sp, rel)
    ok = worst_sp <= tol_mean and worst_var <= tol_var and worst_gl <= 1.0
    return ok, (f"objects up to {n_max} px: max rel err mean/min/max "
                f"{worst_sp!r} (<= {tol_mean!r}), variance {worst_var!r} "
                f"(<= {tol_var!r}), max err GLCM {worst_gl!r} of its "
                f"tolerance (<= 1)")


def four_card_phase(size: int, seed: int, n_segments: int):
    """``mosaic_pipeline`` on a 2x2 mesh of four cards against the same
    call on a one-device mesh. Returns [(name, ok, detail)]."""
    import jax

    from obia_tpu.handlers.geotif import image_from_array
    from obia_tpu.parallel.mosaic import mosaic_pipeline
    from obia_tpu.parallel.sharded import make_mesh

    scene, _ = make_scene(size, seed)
    image = image_from_array(scene, _transform(size), crs="EPSG:32633")
    mesh4 = make_mesh(4)
    mesh1 = make_mesh(1)
    cards = list(mesh4.devices.reshape(-1))
    runs = {}
    # one call per mesh: mosaic_pipeline builds its sharded statistics
    # programs anew on every call, so a second call recompiles them too
    for name, mesh in (("2x2", mesh4), ("1x1", mesh1)):
        t = time.perf_counter()
        runs[name] = mosaic_pipeline(image, n_segments=n_segments,
                                     compactness=10.0, mesh=mesh)
        print(f"mosaic_pipeline {name}: {time.perf_counter() - t!r} s, "
              f"{len(runs[name])} objects")
        if name == "2x2":
            # every card must have held its quarter of the float32
            # raster: a placement that put all shards on one device
            # leaves the others empty
            share = scene.size * 4 / 4
            peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                     for d in cards]
            print(f"2x2 mesh devices {[d.id for d in cards]} "
                  f"peak_bytes_in_use {peaks}")
    devs = {d.id for d in cards}
    spread = len(devs) == 4 and min(peaks) >= share / 2
    same_count = len(runs["2x2"]) == len(runs["1x1"])
    checks = [
        ("mesh spread over 4 cards", spread,
         f"{len(devs)} distinct devices, smallest peak {min(peaks)} bytes "
         f"(>= {share / 2:.0f}, half a quarter-raster)"),
        ("object count", same_count,
         f"2x2 {len(runs['2x2'])} vs 1x1 {len(runs['1x1'])}"),
    ]
    if same_count:
        from obia_tpu.segmentation.segment_boundaries import (
            LABEL_RASTER_ATTR, unwrap_attr)
        lab = np.asarray(unwrap_attr(runs["1x1"].attrs[LABEL_RASTER_ATTR]))
        n_max = int(np.bincount(lab[lab >= 0]).max())
        checks.append(("features 2x2 vs 1x1",
                       *_compare_objects(runs["2x2"], runs["1x1"], n_max)))
    return checks


# --- entry point --------------------------------------------------------


def _report(checks) -> bool:
    for name, ok, detail in checks:
        print(f"check {name}: {'PASS' if ok else 'FAIL'} -- {detail}")
    return all(ok for _, ok, _ in checks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=None,
                   help="scene side in pixels (default 4096; 8192 with "
                        "--four-cards)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--four-cards", action="store_true",
                   help="run only mosaic_pipeline on a 2x2 mesh of four "
                        "cards against a one-device mesh")
    args = p.parse_args(argv)

    import jax
    devices = require_gpu(jax.devices())
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from obia_tpu import compile_cache, native
    print(f"compile cache: {compile_cache.enable()}")
    kind = devices[0].device_kind
    print(f"device: {kind} x {len(devices)}")
    print(f"nvidia-smi: {card_info()}")
    print(f"versions: {json.dumps(versions())}")
    native_ok = native.available()
    print(f"native library loaded: {native_ok}")

    if args.four_cards:
        if len(devices) < 4:
            raise SystemExit(
                f"--four-cards needs 4 GPUs, found {len(devices)}")
        size = args.size or 8192
        checks = four_card_phase(size, args.seed, n_segments=12000)
    else:
        size = args.size or 4096
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            res = main_path_phase(size, args.seed, work)
            print(f"scene: {size}x{size}x{N_BANDS} uint16, set-up "
                  f"{res['setup_s']!r} s")
            print(f"objects: {len(res['segments'].segments)}")
            print(f"main path cold: {res['cold_s']!r} s")
            print(f"main path warm: {res['warm_s']!r} s")
            for name, st in sorted(res["stages"].items(),
                                   key=lambda kv: -kv[1]["total_s"]):
                print(f"stage {name}: {st['total_s']!r} s over "
                      f"{st['count']} call(s)")
            print(f"peak_bytes_in_use: {res['peak_bytes_in_use']}")
            checks = reference_checks(res, args.seed, 300)
    checks.append(("native library", native_ok,
                   "obia_tpu.native built and loaded"))
    if not _report(checks):
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
