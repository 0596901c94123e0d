"""Training pictures: subband and reconstruction images and an HTML
gallery.

Counterpart of learned_pmctf_tpu/utils/visualizer.py (numpy and PIL):
the same file names, the same normalization to 8 bits and the same
index.html. ``pwave_visuals`` runs the port's ``PWave.analysis``.
cli/train_pwave.py draws the first validation picture of every epoch.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict

import numpy as np
import torch
from PIL import Image


def normalize_for_display(im: np.ndarray, signed: bool = True) -> np.ndarray:
    """Map a float plane to uint8 for display.

    Signed (highpass) planes are centered; lowpass/image planes min-max
    normalized (ref: pMCTF/utils/util.py:327-348 normalize_tensor)."""
    im = np.asarray(im, np.float64)
    if signed:
        m = max(abs(im.min()), abs(im.max()), 1e-9)
        im = (im / m + 1.0) / 2.0
    else:
        lo, hi = im.min(), im.max()
        im = (im - lo) / max(hi - lo, 1e-9)
    return np.clip(im * 255.0, 0, 255).astype(np.uint8)


class Visualizer:
    """Saves epoch images and maintains an index.html gallery."""

    def __init__(self, exp_path: str, name: str = "train"):
        self.web_dir = osp.join(exp_path, "web")
        self.img_dir = osp.join(self.web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.name = name
        self._epochs = []

    def display_current_results(self, visuals: Dict[str, np.ndarray],
                                epoch: int, is_eval: bool = False):
        prefix = "eval" if is_eval else "train"
        names = []
        for label, im in visuals.items():
            im = np.asarray(im)
            if im.ndim == 4:
                im = im[0, 0]
            elif im.ndim == 3:
                im = im[0]
            signed = not any(s in label for s in ("x", "ll", "recon"))
            png = normalize_for_display(im, signed=signed)
            fname = f"epoch{epoch:03d}_{prefix}_{label}.png"
            Image.fromarray(png).save(osp.join(self.img_dir, fname))
            names.append((label, fname))
        self._epochs.append((epoch, prefix, names))
        self._write_html()

    def _write_html(self):
        rows = []
        for epoch, prefix, names in reversed(self._epochs):
            cells = "".join(
                f'<td><p>{label}</p><img src="images/{fname}" '
                f'style="max-width:256px"></td>'
                for label, fname in names)
            rows.append(f"<h3>epoch {epoch} [{prefix}]</h3>"
                        f"<table><tr>{cells}</tr></table>")
        html = ("<html><head><title>{}</title></head><body>{}</body></html>"
                .format(self.name, "\n".join(rows)))
        with open(osp.join(self.web_dir, "index.html"), "w") as f:
            f.write(html)


@torch.no_grad()
def pwave_visuals(model, x, x_hat) -> Dict[str, np.ndarray]:
    """Subband decomposition images of `model` (a PWave) on x (B,1,H,W)
    for the gallery, with x and the clipped reconstruction x_hat: each
    level's ll|lh over hl|hh of the first sample."""
    subbands = model.analysis(x)

    def plane(t):
        return t[0, 0].float().cpu().numpy()

    vis = {"x": x.float().cpu().numpy(),
           "x_hat": torch.clamp(x_hat, 0, 255).float().cpu().numpy()}
    for lvl, sb in subbands.items():
        top = np.concatenate([plane(sb["ll"]), plane(sb["lh"])], axis=1)
        bot = np.concatenate([plane(sb["hl"]), plane(sb["hh"])], axis=1)
        vis[f"lvl{lvl}_subbands"] = np.concatenate([top, bot], axis=0)
    return vis
