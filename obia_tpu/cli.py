"""Command-line interface.

The reference imports click but defines no CLI (SURVEY.md §5 — no commands,
no entry points). This module provides one: segmentation, tiled
segmentation, seed generation, cost surfaces, and the benchmark, all
runnable as ``obia-tpu <command>``.
"""
from __future__ import annotations

import json

import click


@click.group()
def main():
    """obia-tpu: object-based image analysis on JAX."""


@main.command("segment")
@click.argument("raster", type=click.Path(exists=True))
@click.argument("out_gpkg", type=click.Path())
@click.option("--method", default="slic", type=click.Choice(["slic",
                                                             "quickshift"]))
@click.option("--n-segments", default=3000, show_default=True)
@click.option("--compactness", default=10.0, show_default=True)
@click.option("--kernel-size", default=5.0, show_default=True)
@click.option("--max-dist", default=10.0, show_default=True)
@click.option("--bands", default=None,
              help="comma-separated 0-based segmentation band indices")
def segment_cmd(raster, out_gpkg, method, n_segments, compactness,
                kernel_size, max_dist, bands):
    """Segment RASTER and write objects + features to OUT_GPKG."""
    from .handlers.geotif import open_geotiff
    from .segmentation.segment import segment

    image = open_geotiff(raster)
    seg_bands = ([int(b) for b in bands.split(",")] if bands else None)
    kwargs = ({"n_segments": n_segments, "compactness": compactness}
              if method == "slic"
              else {"kernel_size": kernel_size, "max_dist": max_dist})
    s = segment(image, segmentation_bands=seg_bands, method=method, **kwargs)
    s.write_segments(out_gpkg)
    click.echo(f"wrote {len(s.segments):,} objects -> {out_gpkg}")


@main.command("tiled-segments")
@click.argument("raster", type=click.Path(exists=True))
@click.argument("output_dir", type=click.Path())
@click.option("--mask", default=None, type=click.Path(exists=True))
@click.option("--tile-size", default=200, show_default=True)
@click.option("--buffer", default=30, show_default=True)
@click.option("--crown-radius", default=5.0, show_default=True)
@click.option("--n-segments", default=None, type=int)
@click.option("--resume/--no-resume", default=False)
def tiled_cmd(raster, output_dir, mask, tile_size, buffer, crown_radius,
              n_segments, resume):
    """Checkerboard tiled segmentation with seam handling."""
    from .utils.tiling import create_tiled_segments

    kwargs = {"n_segments": n_segments} if n_segments else {}
    gdf = create_tiled_segments(raster, output_dir, input_mask=mask,
                                tile_size=tile_size, buffer=buffer,
                                crown_radius=crown_radius, resume=resume,
                                **kwargs)
    click.echo(f"wrote {len(gdf):,} segments -> {output_dir}/segments.gpkg")


@main.command("chm-seeds")
@click.argument("chm", type=click.Path(exists=True))
@click.argument("out_gpkg", type=click.Path())
@click.option("--h-min", default=2.5, show_default=True)
@click.option("--min-dist-px", default=3, show_default=True)
@click.option("--sigma", default=1.0, show_default=True)
def chm_seeds_cmd(chm, out_gpkg, h_min, min_dist_px, sigma):
    """Canopy-height-model peak seeds."""
    from .utils.seeds import make_chm_seeds
    make_chm_seeds(chm, out_gpkg, h_min_m=h_min, min_dist_px=min_dist_px,
                   gauss_sigma=sigma)


@main.command("density-seeds")
@click.argument("density", type=click.Path(exists=True))
@click.argument("out_gpkg", type=click.Path())
@click.option("--d-min", default=4.5, show_default=True)
@click.option("--min-dist-px", default=4, show_default=True)
@click.option("--sigma", default=2.0, show_default=True)
def density_seeds_cmd(density, out_gpkg, d_min, min_dist_px, sigma):
    """Density-raster peak seeds."""
    from .utils.seeds import make_density_seeds
    make_density_seeds(density, out_gpkg, d_min=d_min,
                       min_dist_px=min_dist_px, gauss_sigma=sigma)


@main.command("canonical-seeds")
@click.argument("chm_seeds", type=click.Path(exists=True))
@click.argument("den_seeds", type=click.Path(exists=True))
@click.argument("chm", type=click.Path(exists=True))
@click.argument("cost_surface", type=click.Path(exists=True))
@click.argument("out_gpkg", type=click.Path())
@click.option("--merge-radius", default=1.5, show_default=True)
@click.option("--cost-weight", default=0.5, show_default=True)
def canonical_seeds_cmd(chm_seeds, den_seeds, chm, cost_surface, out_gpkg,
                        merge_radius, cost_weight):
    """Merge CHM + density seeds into canonical seed points."""
    from .utils.seeds import make_canonical_seeds
    make_canonical_seeds(chm_seeds, den_seeds, chm, cost_surface, out_gpkg,
                         merge_radius=merge_radius, cost_weight=cost_weight)


@main.command("cost-surface")
@click.argument("wv3", type=click.Path(exists=True))
@click.argument("chm", type=click.Path(exists=True))
@click.argument("out", type=click.Path())
@click.option("--slic", default=None, type=click.Path(exists=True))
@click.option("--weights", default="0.5,0.25,0.25,0", show_default=True)
def cost_cmd(wv3, chm, out, slic, weights):
    """Weighted cost surface from CHM gradient + NDVI gap + entropy."""
    from .utils.cost import make_cost_surface
    w = tuple(float(x) for x in weights.split(","))
    make_cost_surface(wv3, chm, out, slic=slic, weights=w)


@main.command("bench")
@click.option("--size", default=2048, show_default=True)
def bench_cmd(size):
    """End-to-end throughput benchmark (one JSON line)."""
    import subprocess
    import sys
    import os
    # repo checkout: bench.py sits next to the package; installed
    # package: fall back to the working directory
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for cand in (os.path.join(root, "bench.py"),
                 os.path.join(os.getcwd(), "bench.py")):
        if os.path.exists(cand):
            try:
                subprocess.run([sys.executable, cand, str(size)],
                               check=True)
            except subprocess.CalledProcessError as e:
                raise click.ClickException(
                    f"benchmark exited with status {e.returncode} "
                    "(see its output above)")
            return
    raise click.ClickException(
        "bench.py not found (it ships with the repository, not the wheel); "
        "run from a checkout or pass a path to `python bench.py`")


@main.command("info")
def info_cmd():
    """Device / backend / native-library status."""
    import jax
    from . import native
    click.echo(json.dumps({
        "backend": jax.default_backend(),
        "devices": [str(d) for d in jax.devices()],
        "native_library": native.available(),
    }, indent=1))


if __name__ == "__main__":
    main()
