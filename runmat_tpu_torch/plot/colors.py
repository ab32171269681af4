"""Copy of runmat_tpu/plot/colors.py in the PyTorch port.

Color cycle, named colors, and colormaps (parula-like default, jet, gray,
hot, cool, spring, summer, autumn, winter, bone, copper)."""

from __future__ import annotations

import numpy as np

# MATLAB default line color order (R2014b+)
COLOR_ORDER = [
    (0.0000, 0.4470, 0.7410),
    (0.8500, 0.3250, 0.0980),
    (0.9290, 0.6940, 0.1250),
    (0.4940, 0.1840, 0.5560),
    (0.4660, 0.6740, 0.1880),
    (0.3010, 0.7450, 0.9330),
    (0.6350, 0.0780, 0.1840),
]

NAMED = {
    "r": (1, 0, 0), "g": (0, 1, 0), "b": (0, 0, 1), "c": (0, 1, 1),
    "m": (1, 0, 1), "y": (1, 1, 0), "k": (0, 0, 0), "w": (1, 1, 1),
    "red": (1, 0, 0), "green": (0, 1, 0), "blue": (0, 0, 1),
    "cyan": (0, 1, 1), "magenta": (1, 0, 1), "yellow": (1, 1, 0),
    "black": (0, 0, 0), "white": (1, 1, 1),
}

# parula-like anchor points (not MATLAB's exact table; perceptually similar)
_PARULA_ANCHORS = np.array([
    (0.2422, 0.1504, 0.6603),
    (0.2810, 0.3228, 0.9579),
    (0.1786, 0.5289, 0.9682),
    (0.0689, 0.6948, 0.8394),
    (0.2161, 0.7843, 0.5923),
    (0.6720, 0.7793, 0.2227),
    (0.9970, 0.7659, 0.2199),
    (0.9769, 0.9839, 0.0805),
])


def _interp_map(anchors: np.ndarray, n: int) -> np.ndarray:
    t = np.linspace(0, 1, n)
    ta = np.linspace(0, 1, anchors.shape[0])
    return np.stack([np.interp(t, ta, anchors[:, k]) for k in range(3)], axis=1)


def colormap(name: str, n: int = 256) -> np.ndarray:
    name = name.lower()
    t = np.linspace(0, 1, n)
    if name in ("parula", "default"):
        return _interp_map(_PARULA_ANCHORS, n)
    if name == "jet":
        r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
        g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
        b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
        return np.stack([r, g, b], axis=1)
    if name == "gray":
        return np.stack([t, t, t], axis=1)
    if name == "hot":
        r = np.clip(3 * t, 0, 1)
        g = np.clip(3 * t - 1, 0, 1)
        b = np.clip(3 * t - 2, 0, 1)
        return np.stack([r, g, b], axis=1)
    if name == "cool":
        return np.stack([t, 1 - t, np.ones_like(t)], axis=1)
    if name == "spring":
        return np.stack([np.ones_like(t), t, 1 - t], axis=1)
    if name == "summer":
        return np.stack([t, 0.5 + t / 2, 0.4 * np.ones_like(t)], axis=1)
    if name == "autumn":
        return np.stack([np.ones_like(t), t, np.zeros_like(t)], axis=1)
    if name == "winter":
        return np.stack([np.zeros_like(t), t, 1 - t / 2], axis=1)
    if name == "bone":
        g = np.stack([t, t, t], axis=1)
        g[:, 2] = np.clip(t * 1.15, 0, 1)
        return g
    if name == "copper":
        return np.stack([np.clip(1.25 * t, 0, 1), 0.78 * t, 0.5 * t], axis=1)
    return _interp_map(_PARULA_ANCHORS, n)


def css(rgb) -> str:
    r, g, b = (int(round(255 * float(c))) for c in rgb[:3])
    return f"#{r:02x}{g:02x}{b:02x}"


def parse_linespec(spec: str):
    """'r--o' -> (color, linestyle, marker); any part optional."""
    color = None
    style = None
    marker = None
    i = 0
    while i < len(spec):
        c = spec[i]
        if spec[i:i + 2] in ("--", "-."):
            style = spec[i:i + 2]
            i += 2
            continue
        if c in "-:":
            style = c
            i += 1
            continue
        if c in NAMED:
            color = NAMED[c]
            i += 1
            continue
        if c in "ox+*sd^v<>ph.":
            marker = c
            i += 1
            continue
        i += 1
    return color, style, marker
