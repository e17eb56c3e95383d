"""Debug visualization helpers (reference visualize/ca_body/utils/image.py
~421-977: tensor2rgbjet / tensor2rgb / tensor2image / feature2rgb /
kpts2delta / kpts2heatmap / make_image_grid / make_image_grid_batched /
resize_to_match / add_label_centered).

The port's own copy of ``audio2photoreal_tpu/render/viz.py``, which is
numpy and PIL: a 256-entry jet LUT stands in for ``cv2.applyColorMap``, PIL
resizes and draws text.  Inputs may be numpy arrays or torch tensors, on
the CPU or the card (copied to the host as numpy).  PIL is imported only
by the functions that draw text or resize, so importing this module needs
none.  Nothing here is on the training or inference path.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


# --------------------------------------------------------------------- #
# colormaps


def get_color_map(name: str = "COLORMAP_JET") -> np.ndarray:
    """256×3 uint8 RGB LUT (reference image.py:583-587, minus cv2).

    The jet ramp is the classic piecewise-linear blue→cyan→yellow→red map;
    values match matplotlib's "jet" (cv2's COLORMAP_JET is the same map in
    BGR order)."""
    if name not in ("COLORMAP_JET", "jet"):
        raise ValueError(f"unsupported colormap {name!r}")
    x = np.linspace(0.0, 1.0, 256)

    def ramp(v):
        return np.clip(np.minimum(4 * v - 1.5, -4 * v + 4.5), 0.0, 1.0)

    r, g, b = ramp(x), ramp(x + 0.25), ramp(x + 0.5)
    return (np.stack([r, g, b], axis=-1) * 255).round().astype(np.uint8)


_JET = get_color_map()


def tensor2rgb(
    tensor: Array, x_max: Optional[float] = None, x_min: Optional[float] = None
) -> np.ndarray:
    """Normalize to uint8: (x-x_min)/(x_max-x_min)*255 (image.py:438-462)."""
    x = _np(tensor).astype(np.float32)
    if x_min is None:
        x_min = float(x.min())
    if x_max is None:
        x_max = float(x.max())
    gain = 255.0 / np.clip(x_max - x_min, 1e-3, None)
    return np.clip((x - x_min) * gain, 0.0, 255.0).astype(np.uint8)


def tensor2rgbjet(
    tensor: Array, x_max: Optional[float] = None, x_min: Optional[float] = None
) -> np.ndarray:
    """uint8 image with the jet colormap applied (image.py:421-436)."""
    u8 = tensor2rgb(tensor, x_max=x_max, x_min=x_min)
    if u8.ndim == 3 and u8.shape[-1] in (1, 3):  # collapse to intensity
        u8 = u8.mean(axis=-1).round().astype(np.uint8)
    return _JET[u8]


def tensor2image(
    tensor: Array,
    x_max: Optional[float] = 1.0,
    x_min: Optional[float] = 0.0,
    mode: str = "rgb",
    mask: Optional[Array] = None,
    label: Optional[str] = None,
) -> np.ndarray:
    """[C,H,W] or [H,W] tensor → uint8 HWC image (image.py:465-525)."""
    x = _np(tensor).astype(np.float32)
    if mask is not None:
        x = x * _np(mask)
    if x.ndim == 2:
        x = x[None]
    if x.shape[0] == 1:
        x = np.repeat(x, 3, axis=0)
    if x.shape[0] != 3:
        raise ValueError(f"unsupported number of channels {x.shape[0]}")
    img = x.transpose(1, 2, 0)
    if mode == "rgb":
        img = tensor2rgb(img, x_max=x_max, x_min=x_min)
    elif mode == "jet":
        img = tensor2rgbjet(img, x_max=x_max, x_min=x_min)
    else:
        raise ValueError(f"unsupported mode {mode!r}")
    if label is not None:
        img = add_label_centered(img, label)
    return img


def feature2rgb(x: Array, scale: int = -1) -> np.ndarray:
    """Fold a [C,H,W] feature map into an RGB uint8 image by summing every
    3rd channel (image.py:590-601)."""
    x = _np(x).astype(np.float32)
    rgb = np.stack([x[0::3].sum(0), x[1::3].sum(0), x[2::3].sum(0)], axis=-1)
    rgb = (rgb - rgb.min()) / max(rgb.max() - rgb.min(), 1e-12)
    out = (rgb * 255).astype(np.uint8)
    if scale != -1:
        from PIL import Image

        h, w = out.shape[:2]
        out = np.asarray(
            Image.fromarray(out).resize((w * scale, h * scale), Image.BICUBIC)
        )
    return out


# --------------------------------------------------------------------- #
# keypoints


def kpts2delta(kpts: Array, size: Sequence[int]) -> np.ndarray:
    """[B,N,2] keypoints → [B,N,H,W,2] vectors grid→kpt (image.py:603-613)."""
    k = _np(kpts).astype(np.float32)
    h, w = size
    gy, gx = np.meshgrid(np.arange(h, dtype=k.dtype), np.arange(w, dtype=k.dtype), indexing="ij")
    grid = np.stack([gx, gy], axis=-1)  # xy order, as the reference's meshgrid(indexing="xy")
    return k[:, :, None, None, :] - grid[None, None]


def kpts2heatmap(kpts: Array, size: Sequence[int], sigma: int = 7) -> np.ndarray:
    """Gaussian heatmaps at keypoints, [B,N,H,W] (image.py:616-620)."""
    dist = np.square(kpts2delta(kpts, size)).sum(-1)
    return np.exp(-dist / (2.0 * sigma**2))


# --------------------------------------------------------------------- #
# grids & text


def add_label_centered(
    img: np.ndarray,
    text: str,
    font_scale: float = 1.0,
    thickness: int = 2,
    alignment: str = "top",
    color: Tuple[int, int, int] = (0, 255, 0),
) -> np.ndarray:
    """Draw centered text onto a uint8 HWC image (image.py:528-580, PIL
    instead of cv2.putText)."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(np.ascontiguousarray(img))
    draw = ImageDraw.Draw(im)
    try:
        from PIL import ImageFont

        font = ImageFont.load_default(size=int(16 * font_scale))
    except TypeError:  # older PIL: no size kwarg
        font = None
    bbox = draw.textbbox((0, 0), text, font=font)
    tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
    x = (im.width - tw) // 2
    y = 4 if alignment == "top" else im.height - th - 6
    draw.text((x, y), text, fill=tuple(color), font=font)
    return np.asarray(im)


def _area_resize(img4: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[N,C,H,W] float resize (PIL box filter ≈ torch 'area' mode)."""
    from PIL import Image

    n, c, _, _ = img4.shape
    out = np.empty((n, c, size[0], size[1]), dtype=img4.dtype)
    for i in range(n):
        for j in range(c):
            out[i, j] = np.asarray(
                Image.fromarray(img4[i, j].astype(np.float32)).resize(
                    (size[1], size[0]), Image.BOX
                )
            )
    return out


def make_image_grid(
    data: Union[Array, Dict[str, Array]],
    keys_to_draw: Optional[List[str]] = None,
    scale_factor: Optional[float] = None,
    draw_labels: bool = True,
    grid_size: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Arrange [N,{1,3},H,W] images (or a dict of them) into a most-square
    grid; each cell stacks one sample of every key (image.py:623-740)."""
    if not isinstance(data, dict):
        data = {"": data}
        keys_to_draw = [""]
        draw_labels = False
    if keys_to_draw is None:
        keys_to_draw = list(data.keys())
    imgs = {k: _np(data[k]).astype(np.float32) for k in keys_to_draw}
    for k, v in imgs.items():
        if v.shape[1] == 1:
            imgs[k] = np.repeat(v, 3, axis=1)
    n_cells, _, img_h, img_w = imgs[keys_to_draw[0]].shape
    for k in keys_to_draw:  # unify sizes, then optional global scale
        if imgs[k].shape[2:] != (img_h, img_w):
            imgs[k] = _area_resize(imgs[k], (img_h, img_w))
        if scale_factor is not None:
            imgs[k] = _area_resize(
                imgs[k], (int(img_h * scale_factor), int(img_w * scale_factor))
            )

    cells = []
    for i in range(n_cells):
        panes = []
        for k in keys_to_draw:
            pane = np.clip(imgs[k][i].transpose(1, 2, 0), 0, 255).astype(np.uint8)
            if draw_labels and k:
                pane = add_label_centered(pane, k)
            panes.append(pane)
        cells.append(np.concatenate(panes, axis=1))
    ch, cw = cells[0].shape[:2]

    if grid_size is not None:
        gh, gw = grid_size
        if gh * gw < n_cells:
            raise ValueError(
                f"requested grid size ({gh}, {gw}) cannot hold {n_cells} images"
            )
    else:  # most-square layout in CELL pixels (image.py:704-719)
        gw = max(1, round(math.sqrt(n_cells * ch / cw)))
        gh = math.ceil(n_cells / gw)
    grid = np.zeros((gh * ch, gw * cw, 3), dtype=np.uint8)
    for i, cell in enumerate(cells):
        r, c = divmod(i, gw)
        grid[r * ch : (r + 1) * ch, c * cw : (c + 1) * cw] = cell
    return grid


def resize_to_match(
    images: List[np.ndarray], mode: str = "bilinear"
) -> List[np.ndarray]:
    """Resize HWC uint8 images to the largest H,W in the list (image.py:828-865)."""
    from PIL import Image

    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    rs = Image.BILINEAR if mode == "bilinear" else Image.NEAREST
    return [
        im
        if im.shape[:2] == (h, w)
        else np.asarray(Image.fromarray(im).resize((w, h), rs))
        for im in images
    ]


def make_image_grid_batched(
    data: Dict[str, Array],
    max_row_height: Optional[int] = None,
    draw_labels: bool = True,
    input_is_in_0_1: bool = False,
) -> np.ndarray:
    """Whole-batch grid matching the reference layout (image.py:743-825):
    one COLUMN per dict key, one ROW per batch sample.  Every key's panes are
    resized (aspect-preserved, nearest) so all heights match the largest pane,
    capped at ``max_row_height`` — samples are never dropped."""
    from PIL import Image

    keys = list(data.keys())
    arrs = []
    for k in keys:
        v = _np(data[k]).astype(np.float32)
        if v.ndim != 4 or v.shape[1] not in (1, 3):
            raise ValueError(f"image data must be [N,1|3,H,W]; got {v.shape} for {k!r}")
        if v.shape[1] == 1:
            v = np.repeat(v, 3, axis=1)
        if input_is_in_0_1:
            v = v * 255.0
        arrs.append(v)
    if not all(a.shape[0] == arrs[0].shape[0] for a in arrs):
        raise ValueError("batch sizes must be the same")

    target_h = max(a.shape[2] for a in arrs)
    if max_row_height is not None:
        target_h = min(target_h, max_row_height)
    cols = []
    for k, v in zip(keys, arrs):
        panes = [np.clip(im.transpose(1, 2, 0), 0, 255).astype(np.uint8) for im in v]
        if panes[0].shape[0] != target_h:
            w = max(1, round(panes[0].shape[1] * target_h / panes[0].shape[0]))
            panes = [
                np.asarray(Image.fromarray(p).resize((w, target_h), Image.NEAREST))
                for p in panes
            ]
        if draw_labels:
            panes = [add_label_centered(p, k) for p in panes]
        cols.append(np.concatenate(panes, axis=0))
    return np.concatenate(cols, axis=1)
