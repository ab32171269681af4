"""Copy of runmat_tpu/plot/__init__.py in the PyTorch port.

Plotting engine: figure/axes scene graph with headless SVG and PNG export.

Reference parity: runmat-plot (crates/runmat-plot — scene graph + per-plot-type
pipelines + headless export) and the 30+ plot commands in
runmat-runtime/src/builtins/plotting. This engine is CPU-side by design —
figures consume *gathered* data (the reference's zero-copy GPU vertex path
maps to jax->numpy transfer at figure build time); rendering is a vector
scene graph serialized to SVG, or rasterized to PNG by a small scanline
renderer with no external dependencies.
"""

from .figure import Axes, Figure, current_figure, close_figure, close_all, \
    figure as make_figure, gca, gcf

__all__ = ["Axes", "Figure", "current_figure", "close_figure", "close_all",
           "make_figure", "gca", "gcf"]
