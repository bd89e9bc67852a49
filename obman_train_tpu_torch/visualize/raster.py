"""Figures without matplotlib: PIL raster versions of the panels that
``displaymano.visualize_batch``, ``displaymano.save_pck_img`` and the demos
draw, used where matplotlib is not installed (some GPU hosts have PIL but
not matplotlib). Orthographic projections drawn as points and segments,
no shading; the layout follows the matplotlib figures.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from obman_train_tpu_torch.visualize.viz2d import LINK_COLORS, LINKS

TILE = 200
RGB = {"b": (0, 0, 255), "g": (0, 160, 0), "r": (230, 0, 0), "y": (200, 180, 0),
       "m": (200, 0, 200), "c": (0, 180, 200), "k": (0, 0, 0)}


def _image():
    from PIL import Image, ImageDraw

    return Image, ImageDraw


def points_tile(layers: Sequence[Tuple[np.ndarray, str]],
                segments: Sequence[Tuple[np.ndarray, np.ndarray, str]] = (),
                size: int = TILE):
    """A white tile with 2D ``layers`` of points and ``segments`` (start and
    end arrays) in one colour each, scaled together to fit; y grows
    downwards, as in the matplotlib panels' inverted y axis."""
    Image, ImageDraw = _image()
    img = Image.new("RGB", (size, size), "white")
    pts = [np.asarray(p, np.float64).reshape(-1, 2) for p, _ in layers]
    pts += [np.asarray(a, np.float64).reshape(-1, 2) for a, b, _ in segments]
    pts += [np.asarray(b, np.float64).reshape(-1, 2) for a, b, _ in segments]
    pts = [p for p in pts if len(p)]
    if not pts:
        return img
    allp = np.concatenate(pts)
    lo, hi = allp.min(0), allp.max(0)
    pad = 6
    scale = (size - 2 * pad) / max(float((hi - lo).max()), 1e-9)

    def px(p):
        return [tuple(q) for q in ((np.asarray(p, np.float64).reshape(-1, 2) - lo) * scale + pad)]

    draw = ImageDraw.Draw(img)
    for a, b, c in segments:
        for p, q in zip(px(a), px(b)):
            draw.line([p, q], fill=RGB[c])
    for p, c in layers:
        draw.point(px(p), fill=RGB[c])
    return img


def image_tile(image: np.ndarray, joints2d: Optional[np.ndarray] = None, size: int = TILE):
    """An input image (float, normalised x/255 - 0.5, or uint8) resized to
    the tile, with the 2D skeleton when given."""
    Image, ImageDraw = _image()
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr + 0.5, 0, 1) * 255).astype(np.uint8)
    h, w = arr.shape[:2]
    img = Image.fromarray(arr).resize((size, size))
    if joints2d is not None:
        j = np.asarray(joints2d, np.float64)[:, :2] * [size / w, size / h]
        draw = ImageDraw.Draw(img)
        for color, link in zip(LINK_COLORS, LINKS):
            draw.line([tuple(j[k]) for k in link], fill=RGB[color], width=2)
    return img


def _grid(tiles, rows: int, cols: int):
    Image, _ = _image()
    size = tiles[0][0].size[0]
    out = Image.new("RGB", (cols * size, rows * size), "white")
    for r, row in enumerate(tiles):
        for c, tile in enumerate(row):
            out.paste(tile, (c * size, r * size))
    return out


def visualize_batch(save_path: str, batch: Dict, results: Dict, max_samples: int = 5) -> str:
    """The grid of ``displaymano.visualize_batch`` (columns = samples): the
    input with the 2D joints; the hand (blue) and object (red) on x-y with
    the repulsion (red) and attraction (blue) segments; the x-y and y-z
    projections of the predicted (blue, red) and GT (green, yellow) points."""
    from obman_train_tpu_torch.visualize.displaymano import create_segments

    images = np.asarray(batch["images"])
    n = min(max_samples, images.shape[0])
    verts = np.asarray(results["verts"]) if "verts" in results else None
    obj = np.asarray(results["objpoints3d"]) if "objpoints3d" in results else None
    info = results.get("contact_info")
    rows = [[], [], [], []]
    for col in range(n):
        j2d = np.asarray(results["joints2d"])[col] if "joints2d" in results else None
        rows[0].append(image_tile(images[col], j2d))
        for row, (i, j) in zip(rows[1:], ((0, 1), (0, 1), (1, 2))):
            layers, segs = [], []
            if verts is not None:
                layers.append((verts[col][:, [i, j]], "b"))
                if info is not None and row is rows[1]:
                    pv, pc, mv, mc = create_segments(info, verts[col], col)
                    segs = [(pv[:, [i, j]], pc[:, [i, j]], "r"),
                            (mv[:, [i, j]], mc[:, [i, j]], "b")]
            if obj is not None:
                layers.append((obj[col][:, [i, j]], "r"))
            if row is not rows[1]:
                for key, color in (("verts3d", "g"), ("objpoints3d", "y")):
                    if key in batch:
                        layers.append((np.asarray(batch[key])[col][:, [i, j]], color))
            row.append(points_tile(layers, segs))
    _grid(rows, 4, n).save(save_path)
    return save_path


def save_pck_img(thresholds, pck_values, auc_all, save_path: str,
                 curves: Optional[Dict] = None) -> str:
    """The PCK curve (red) on [0, max threshold] x [0, 1], with the
    literature ``curves`` ({name: (xs, ys)}) in other colours."""
    Image, ImageDraw = _image()
    W = H = 400
    m = 40
    img = Image.new("RGB", (W, H), "white")
    draw = ImageDraw.Draw(img)
    xmax = max(float(np.max(thresholds)), 1e-9)

    def px(x, y):
        return [(m + (W - 2 * m) * float(a) / xmax, H - m - (H - 2 * m) * float(b))
                for a, b in zip(x, y)]

    draw.line([(m, m), (m, H - m), (W - m, H - m)], fill=RGB["k"])
    for k in range(11):
        y = H - m - (H - 2 * m) * k / 10
        draw.line([(m - 4, y), (m, y)], fill=RGB["k"])
    colors = iter(("b", "c", "g", "m"))
    for name, (xs, ys) in (curves or {}).items():
        draw.line(px(xs, ys), fill=RGB[next(colors)], width=2)
    pts = px(thresholds, pck_values)
    draw.line(pts, fill=RGB["r"], width=2)
    for x, y in pts:
        draw.ellipse([x - 3, y - 3, x + 3, y + 3], fill=RGB["r"])
    draw.text((m, 10), f"auc in [{thresholds[0]},{thresholds[-1]}]: {auc_all:.4f}",
              fill=RGB["k"])
    draw.text((W // 2 - 60, H - m + 12), "Error Thresholds (mm)", fill=RGB["k"])
    img.save(save_path)
    return save_path


def mesh_panel(frame: np.ndarray, joints2d: Optional[np.ndarray],
               meshes: Sequence[Tuple[np.ndarray, str]]) -> np.ndarray:
    """The demos' panel: the frame with its 2D joints beside the meshes'
    points projected on x-y, both at the frame's height; RGB uint8."""
    from obman_train_tpu_torch.visualize.viz2d import draw_joints_on_image

    Image, _ = _image()
    left = frame if joints2d is None else draw_joints_on_image(frame, joints2d)
    h = frame.shape[0]
    right = points_tile([(v[:, :2], c) for v, c in meshes], size=h)
    out = Image.new("RGB", (frame.shape[1] + h, h), "white")
    out.paste(Image.fromarray(np.ascontiguousarray(left)), (0, 0))
    out.paste(right, (frame.shape[1], 0))
    return np.asarray(out)
