"""Visualization dumps (`skyhdr.utils.vis`): the reference's Grad-CAM PNG
grids (grad_cam.show, train_sun.py:329-373) and its multi-panel eval
figure. Matplotlib is imported inside each function, so headless training
never imports it."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def save_image_grid(images: np.ndarray, path: str, nx: int = 8) -> None:
    """Save a grid of single-channel maps as PNG (reference grad_cam.py:6-27)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = np.asarray(images)
    if images.ndim == 4:
        images = images[..., 0]
    n = images.shape[0]
    ny = int(np.ceil(n / nx))
    fig = plt.figure()
    fig.subplots_adjust(left=0, right=1, bottom=0, top=1, hspace=0.05,
                        wspace=0.05)
    for i in range(n):
        ax = fig.add_subplot(ny, nx, i + 1, xticks=[], yticks=[])
        ax.imshow(images[i], interpolation="nearest")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path)
    plt.close(fig)


def save_eval_panel(panels: Sequence, titles: Sequence[str], path: str) -> None:
    """Multi-panel figure, one panel a row (reference train_sun.py:449-471)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(panels)
    fig, axes = plt.subplots(n, 1, figsize=(8, 2 * n))
    if n == 1:
        axes = [axes]
    for ax, img, title in zip(axes, panels, titles):
        img = np.asarray(img)
        if img.ndim == 3 and img.shape[-1] == 1:
            img = img[..., 0]
        ax.imshow(np.clip(img, 0, 1))
        ax.set_title(title, fontsize=8)
        ax.axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    plt.savefig(path)
    plt.close(fig)


def tonemap_for_display(hdr: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    return np.clip(hdr, 0, None) ** (1.0 / gamma)
