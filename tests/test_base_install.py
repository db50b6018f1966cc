"""Base-install smoke test: the core API must work without the [viz] extra.

Round-1 regression: ``handlers/geotif.py`` imported ``utils.image`` which
hard-imported cv2 at module top, so a base install (no opencv) could not even
``open_geotiff``. cv2 is now lazily imported with numpy fallbacks
(reference quirk #15 parity — obia's pyproject omits cv2 too).
"""
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent("""
    import builtins
    real_import = builtins.__import__
    def blocked(name, *a, **k):
        if name == "cv2" or name.startswith("cv2."):
            raise ImportError("No module named 'cv2' (simulated)")
        return real_import(name, *a, **k)
    builtins.__import__ = blocked

    import numpy as np
    from obia_tpu.io.tiff import write_tiff
    from obia_tpu.geometry import Affine
    from obia_tpu.handlers.geotif import open_geotiff

    arr = (np.random.default_rng(3).random((40, 50, 3)) * 255).astype(np.uint8)
    write_tiff("scene.tif", arr, transform=Affine(1, 0, 0, 0, -1, 0),
               crs="EPSG:32610")
    img = open_geotiff("scene.tif")
    assert img.img_data.shape == (40, 50, 3)

    from obia_tpu.utils.image import (apply_clahe,
                                      apply_histogram_equalization,
                                      variance_of_laplacian)
    g = arr[..., 0]
    assert apply_clahe(g).shape == (40, 50)
    assert apply_histogram_equalization(g).shape == (40, 50, 3)
    assert variance_of_laplacian(g.astype(np.float32), 5).shape == (40, 50)

    from obia_tpu.utils.training import _gaussian_blur, _distance_transform_l2
    assert _gaussian_blur(arr, (5, 5)).shape == arr.shape
    assert _distance_transform_l2(g).shape == (40, 50)

    img.to_image(bands=[0, 1, 2], stretch_type="clahe")
    print("BASE_INSTALL_OK")
""")


def test_core_api_without_cv2(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=tmp_path, text=True,
        capture_output=True,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)},
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "BASE_INSTALL_OK" in proc.stdout


def test_fallbacks_match_cv2_when_available():
    cv2 = __import__("cv2")
    import numpy as np

    from obia_tpu.utils.image import _clahe_u8, _equalize_hist_u8

    g = (np.random.default_rng(0).random((123, 217)) * 255).astype(np.uint8)
    assert np.array_equal(_equalize_hist_u8(g), cv2.equalizeHist(g))

    ours = _clahe_u8(g).astype(int)
    ref = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(g)
    assert np.abs(ours - ref.astype(int)).mean() < 4.0


MAIN_PATH_SCRIPT = textwrap.dedent("""
    import builtins
    BLOCKED = ("PIL", "flax", "cv2", "click", "tqdm", "orbax",
               "matplotlib", "sklearn")
    real_import = builtins.__import__
    def blocked(name, *a, **k):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"No module named {name!r} (simulated)")
        return real_import(name, *a, **k)
    builtins.__import__ = blocked

    import numpy as np
    from obia_tpu.classification.classify import classify
    from obia_tpu.geometry import Affine
    from obia_tpu.geometry.geom import Point
    from obia_tpu.handlers.geotif import open_geotiff
    from obia_tpu.io.tiff import write_tiff
    from obia_tpu.segmentation.segment import segment
    from obia_tpu.utils.utils import label_segments
    from obia_tpu.vector import GeoDataFrame, read_file

    rng = np.random.default_rng(0)
    arr = (rng.random((64, 64, 4)) * 2047).astype(np.uint16)
    arr[:, 32:] //= 4
    write_tiff("scene.tif", arr, transform=Affine(1, 0, 0, 0, -1, 64),
               crs="EPSG:32633")
    s = segment(open_geotiff("scene.tif"), segmentation_bands=[0, 1, 2],
                method="slic", n_segments=16, compactness=10)
    pts = [Point(x + 0.5, 63.5 - y) for y in range(2, 64, 8)
           for x in range(2, 64, 8)]
    cls = [int(p.x >= 32) for p in pts]
    training, _ = label_segments(s.segments,
                                 GeoDataFrame({"class": cls}, geometry=pts))
    result = classify(s.segments, training, method="rf", n_estimators=5,
                      random_state=0, compute_reports=True)
    GeoDataFrame(result.classified).to_file("out.gpkg")
    assert len(read_file("out.gpkg")) == len(s.segments)
    print("MAIN_PATH_OK")
""")


def test_main_path_without_optional_packages(tmp_path):
    """open_geotiff -> segment -> label_segments -> classify(rf) ->
    GeoPackage with Pillow, flax, OpenCV, click, tqdm, orbax, matplotlib
    and scikit-learn all unimportable (a GPU host may lack every one)."""
    proc = subprocess.run(
        [sys.executable, "-c", MAIN_PATH_SCRIPT], cwd=tmp_path, text=True,
        capture_output=True,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)},
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "MAIN_PATH_OK" in proc.stdout
