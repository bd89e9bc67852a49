"""Host-side (numpy, cv2) geometry and photometric transforms of the
input pipeline: the port's own copy of the JAX package's
``data/transforms.py``.

- affine crop construction with rotation about the image centre and the
  post-rotation intrinsics transform (handutils.py:63-101);
- the inverse-mapped bilinear warp: the host C++ kernel of
  ``native/imageproc.cpp``, with the numpy gather as its plain version
  (``use_native=False``) and as the ``nearest`` path;
- the float colour jitter with random factors in random order, hue
  included (imgtrans.py:5-53, torchvision semantics on [0, 1]); its hue
  takes cv2's uint8 HSV round trip when cv2 imports, as the JAX package's
  does;
- the uint8 chain (JAX :297-403): ``color_jitter_u8`` (LUTs built in
  numpy, ``cv2.addWeighted``, HSV_FULL hue with a wrapping uint8 shift)
  and ``warp_affine_u8`` (``cv2.warpAffine`` with ``WARP_INVERSE_MAP`` on
  the float64 inverse), picked by ``HandDataset`` whenever cv2 imports;
- the PIL-style Gaussian blur: cv2 ``GaussianBlur((0, 0), sigma)`` when
  cv2 imports, else scipy;
- ``points_from_mesh``, area-weighted barycentric surface sampling
  (vertexsample.py:6-29; JAX :411-431), drawing from the caller's
  generator in the JAX package's order (faces, then u, then v);
- ``fast_load_obj``, the reference's Wavefront parser with its quirks
  (JAX :434-510), which the simulation's OBJ dumps round-trip through, and
  ``load_obj_normalized`` (JAX :511-520), an OBJ in the unit cube.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Affine crop math
# ---------------------------------------------------------------------------


def get_annot_scale(annots: np.ndarray, visibility=None, scale_factor: float = 2.2):
    """Square crop size from 2D annotations (handutils.py:8-22)."""
    if visibility is not None:
        annots = annots[visibility]
    min_x, min_y = annots.min(0)
    max_x, max_y = annots.max(0)
    return max(max_x - min_x, max_y - min_y) * scale_factor


def get_annot_center(annots: np.ndarray, visibility=None) -> np.ndarray:
    if visibility is not None:
        annots = annots[visibility]
    min_xy = annots.min(0)
    max_xy = annots.max(0)
    return ((max_xy + min_xy) / 2).astype(int).astype(np.float64)


def get_affine_trans_no_rot(center, scale, res) -> np.ndarray:
    a = np.zeros((3, 3))
    a[0, 0] = float(res[1]) / scale
    a[1, 1] = float(res[0]) / scale
    a[0, 2] = res[1] * (-float(center[0]) / scale + 0.5)
    a[1, 2] = res[0] * (-float(center[1]) / scale + 0.5)
    a[2, 2] = 1
    return a


def get_affine_transform(center, scale, res, rot: float = 0.0):
    """``(affinetrans, post_rot_trans)`` as handutils.py:63-101:
    ``affinetrans`` warps original-image pixels into the crop; the
    ``post_rot_trans`` (no-rotation crop about the rotated centre) is what
    multiplies the camera intrinsics."""
    rot_mat = np.zeros((3, 3))
    sn, cs = np.sin(rot), np.cos(rot)
    rot_mat[0, :2] = [cs, -sn]
    rot_mat[1, :2] = [sn, cs]
    rot_mat[2, 2] = 1
    center_h = np.array([center[0], center[1], 1.0])
    origin_rot_center = rot_mat.dot(center_h)[:2]
    t_mat = np.eye(3)
    t_mat[0, 2] = -res[1] / 2
    t_mat[1, 2] = -res[0] / 2
    t_inv = t_mat.copy()
    t_inv[:2, 2] *= -1
    transformed_center = t_inv.dot(rot_mat).dot(t_mat).dot(center_h)
    post_rot_trans = get_affine_trans_no_rot(origin_rot_center, scale, res)
    total_trans = post_rot_trans.dot(rot_mat)
    affinetrans_post_rot = get_affine_trans_no_rot(transformed_center[:2], scale, res)
    return total_trans.astype(np.float32), affinetrans_post_rot.astype(np.float32)


def transform_coords(pts: np.ndarray, affine_trans, invert: bool = False):
    """2D point transform; int coords like the reference (handutils.py:36-45)."""
    if invert:
        affine_trans = np.linalg.inv(affine_trans)
    hom = np.concatenate([pts, np.ones((np.asarray(pts).shape[0], 1))], axis=1)
    out = affine_trans.dot(hom.T).T[:, :2]
    return out.astype(int)


# ---------------------------------------------------------------------------
# Image warping
# ---------------------------------------------------------------------------


def transform_img(
    img: np.ndarray,
    affine_trans: np.ndarray,
    res: Tuple[int, int],
    resample: str = "bilinear",
    use_native: bool = True,
) -> np.ndarray:
    """Warp ``img`` (H, W[, C]) float or uint8 so that output pixel (x, y)
    samples the input at ``affine_trans^-1 @ (x, y, 1)``, PIL's
    ``Image.transform(AFFINE)`` mapping (handutils.py:48-60); out-of-bounds
    samples are black. Bilinear runs the host C++ kernel
    (``native/imageproc.cpp``), which raises if it cannot be built;
    ``use_native=False`` runs its plain numpy version."""
    inv = np.linalg.inv(affine_trans)
    if resample == "bilinear" and use_native:
        return _native_warp(img, inv, res)
    H_out, W_out = int(res[0]), int(res[1])
    ys, xs = np.meshgrid(
        np.arange(H_out, dtype=np.float64),
        np.arange(W_out, dtype=np.float64),
        indexing="ij",
    )
    if resample == "nearest":
        # PIL convention: sample at inv @ (x + 0.5, y + 0.5), floor
        xs, ys = xs + 0.5, ys + 0.5
    src_x = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    src_y = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]

    img_f = np.asarray(img, np.float32)
    if img_f.ndim == 2:
        img_f = img_f[:, :, None]
    H, W = img_f.shape[:2]

    if resample == "nearest":
        xi = np.floor(src_x).astype(np.int64)
        yi = np.floor(src_y).astype(np.int64)
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        out = np.zeros((H_out, W_out, img_f.shape[2]), np.float32)
        out[valid] = img_f[yi[valid], xi[valid]]
    else:
        x0 = np.floor(src_x).astype(np.int64)
        y0 = np.floor(src_y).astype(np.int64)
        wx = (src_x - x0).astype(np.float32)[..., None]
        wy = (src_y - y0).astype(np.float32)[..., None]

        def sample(yi, xi):
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            v = np.zeros((H_out, W_out, img_f.shape[2]), np.float32)
            v[valid] = img_f[yi[valid], xi[valid]]
            return v

        out = (
            sample(y0, x0) * (1 - wx) * (1 - wy)
            + sample(y0, x0 + 1) * wx * (1 - wy)
            + sample(y0 + 1, x0) * (1 - wx) * wy
            + sample(y0 + 1, x0 + 1) * wx * wy
        )
    if np.issubdtype(np.asarray(img).dtype, np.integer):
        out = np.clip(out, 0, 255)
    return out[:, :, 0] if np.asarray(img).ndim == 2 else out


def _native_warp(img, inv, res):
    """The C++ bilinear warp (float32 out)."""
    from obman_train_tpu_torch.native.build import load_imageproc_lib

    lib = load_imageproc_lib()
    img_f = np.ascontiguousarray(img, np.float32)
    squeeze = img_f.ndim == 2
    if squeeze:
        img_f = img_f[:, :, None]
    H, W, C = img_f.shape
    out = np.empty((int(res[0]), int(res[1]), C), np.float32)
    inv_c = np.ascontiguousarray(inv, np.float64)
    if inv_c.shape != (3, 3):
        raise ValueError(f"inverse affine must be 3x3, got {inv_c.shape}")
    lib.warp_affine_f32(
        img_f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), H, W, C,
        inv_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(res[0]), int(res[1]),
    )
    if np.issubdtype(np.asarray(img).dtype, np.integer):
        out = np.clip(out, 0, 255)
    return out[:, :, 0] if squeeze else out


# ---------------------------------------------------------------------------
# Photometric augmentation (torchvision functional semantics, on float
# images in [0, 1])
# ---------------------------------------------------------------------------


def _rgb_to_gray(img):
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])[..., None]


def adjust_brightness(img, factor):
    return np.clip(img * factor, 0.0, 1.0)


def adjust_contrast(img, factor):
    mean = _rgb_to_gray(img).mean()
    return np.clip(factor * img + (1 - factor) * mean, 0.0, 1.0)


def adjust_saturation(img, factor):
    gray = _rgb_to_gray(img)
    return np.clip(factor * img + (1 - factor) * gray, 0.0, 1.0)


def adjust_hue_u8(img_u8: np.ndarray, factor: float) -> np.ndarray:
    """uint8 hue shift through cv2's HSV_FULL conversion (the H channel
    spans 0..255 and the uint8 addition wraps mod 256)."""
    import cv2

    hsv = cv2.cvtColor(img_u8, cv2.COLOR_RGB2HSV_FULL)
    shift = np.uint8(int(round(factor * 255.0)) % 256)
    hsv[..., 0] = hsv[..., 0] + shift
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB_FULL)


def adjust_hue(img, factor):
    """Shift hue by ``factor`` turns ([-0.5, 0.5]): through cv2 on uint8
    when cv2 imports, else an HSV round trip in numpy (the JAX package's
    two paths)."""
    try:
        u8 = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
        return adjust_hue_u8(u8, factor).astype(np.float32) / 255.0
    except ImportError:
        pass
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    rc = np.where(delta > 0, (maxc - img[..., 0]) / np.maximum(delta, 1e-12), 0)
    gc = np.where(delta > 0, (maxc - img[..., 1]) / np.maximum(delta, 1e-12), 0)
    bc = np.where(delta > 0, (maxc - img[..., 2]) / np.maximum(delta, 1e-12), 0)
    h = np.where(
        img[..., 0] == maxc,
        bc - gc,
        np.where(img[..., 1] == maxc, 2.0 + rc - bc, 4.0 + gc - rc),
    )
    h = (h / 6.0) % 1.0
    h = (h + factor) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    conds = [i == k for k in range(6)]
    r = np.select(conds, [v, q, p, p, t, v])
    g = np.select(conds, [t, v, v, q, p, p])
    b = np.select(conds, [p, p, t, v, v, q])
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def color_jitter(
    img: np.ndarray,
    rng: np.random.Generator,
    brightness: float = 0.0,
    contrast: float = 0.0,
    saturation: float = 0.0,
    hue: float = 0.0,
) -> np.ndarray:
    """Random-factor, random-order jitter (imgtrans.py:30-53)."""
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda im, f=f: adjust_brightness(im, f))
    if saturation > 0:
        f = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        ops.append(lambda im, f=f: adjust_saturation(im, f))
    if hue > 0:
        f = rng.uniform(-hue, hue)
        ops.append(lambda im, f=f: adjust_hue(im, f))
    if contrast > 0:
        f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(lambda im, f=f: adjust_contrast(im, f))
    order = rng.permutation(len(ops))
    for k in order:
        img = ops[k](img)
    return img


# ---------------------------------------------------------------------------
# uint8 chain (cv2): per-op uint8 quantization, as the reference's
# torchvision ops on PIL images (imgtrans.py:30-53)
# ---------------------------------------------------------------------------


def _have_cv2() -> bool:
    try:
        import cv2  # noqa: F401

        return True
    except ImportError:
        return False


def adjust_brightness_u8(img_u8: np.ndarray, factor: float) -> np.ndarray:
    import cv2

    lut = np.clip(np.round(np.arange(256) * factor), 0, 255).astype(np.uint8)
    return cv2.LUT(img_u8, lut)


def adjust_contrast_u8(img_u8: np.ndarray, factor: float) -> np.ndarray:
    import cv2

    mean = float(cv2.mean(cv2.cvtColor(img_u8, cv2.COLOR_RGB2GRAY))[0])
    lut = np.clip(np.round(np.arange(256) * factor + (1 - factor) * mean),
                  0, 255).astype(np.uint8)
    return cv2.LUT(img_u8, lut)


def adjust_saturation_u8(img_u8: np.ndarray, factor: float) -> np.ndarray:
    import cv2

    gray = cv2.cvtColor(cv2.cvtColor(img_u8, cv2.COLOR_RGB2GRAY), cv2.COLOR_GRAY2RGB)
    return cv2.addWeighted(img_u8, factor, gray, 1.0 - factor, 0.0)


def color_jitter_u8(
    img_u8: np.ndarray,
    rng: np.random.Generator,
    brightness: float = 0.0,
    contrast: float = 0.0,
    saturation: float = 0.0,
    hue: float = 0.0,
) -> np.ndarray:
    """uint8 twin of :func:`color_jitter`: the same factor draws and op
    order from ``rng``, each op quantized to uint8."""
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda im, f=f: adjust_brightness_u8(im, f))
    if saturation > 0:
        f = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        ops.append(lambda im, f=f: adjust_saturation_u8(im, f))
    if hue > 0:
        f = rng.uniform(-hue, hue)
        ops.append(lambda im, f=f: adjust_hue_u8(im, f))
    if contrast > 0:
        f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(lambda im, f=f: adjust_contrast_u8(im, f))
    order = rng.permutation(len(ops))
    for k in order:
        img_u8 = ops[k](img_u8)
    return img_u8


def warp_affine_u8(img_u8: np.ndarray, affine_trans: np.ndarray,
                   res: Tuple[int, int]) -> np.ndarray:
    """cv2 bilinear warp of a uint8 image with :func:`transform_img`'s
    mapping (dst(x, y) = src(inv @ (x, y, 1)), black fill). cv2
    interpolates in fixed point, so it may differ from the float warp by
    1-2 LSB."""
    import cv2

    inv = np.linalg.inv(np.asarray(affine_trans, np.float64))
    return cv2.warpAffine(
        img_u8, inv[:2], (int(res[1]), int(res[0])),
        flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        borderMode=cv2.BORDER_CONSTANT, borderValue=0,
    )


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """PIL-style GaussianBlur(radius) (handataset.py:374-375): cv2 when it
    imports (uint8 or float), else scipy."""
    if radius <= 0:
        return img
    try:
        import cv2

        return cv2.GaussianBlur(img, (0, 0), sigmaX=radius, sigmaY=radius)
    except ImportError:
        from scipy.ndimage import gaussian_filter

        return gaussian_filter(img, sigma=(radius, radius, 0))


# ---------------------------------------------------------------------------
# Mesh surface sampling + OBJ IO
# ---------------------------------------------------------------------------


def points_from_mesh(
    faces: np.ndarray,
    vertices: np.ndarray,
    vertex_nb: int = 600,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Area-weighted barycentric surface sampling (vertexsample.py:6-29)."""
    rng = rng or np.random.default_rng()
    tri = vertices[faces]  # (F, 3, 3)
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    areas = 0.5 * np.linalg.norm(cross, axis=1)
    probs = areas / areas.sum()
    face_ids = rng.choice(len(faces), size=vertex_nb, p=probs)
    u = rng.random((vertex_nb, 1))
    v = rng.random((vertex_nb, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    t = tri[face_ids]
    pts = t[:, 0] + u * (t[:, 1] - t[:, 0]) + v * (t[:, 2] - t[:, 0])
    return pts.astype(np.float32)


def fast_load_obj(file_obj) -> list:
    """Wavefront parser -> [{'vertices', 'faces'}], matching the reference
    ``loadutils.fast_load_obj`` (loadutils.py:3-123, itself trimesh-derived)
    exactly — including its quirks, verified by executed-reference goldens:

    - face corners are deduplicated by their FULL ``v/vt/vn`` token, so the
      same position referenced with different normals/uvs becomes multiple
      vertices;
    - output vertices are ordered by the lexicographic sort of those
      tokens (so "10" sorts before "2");
    - quads triangulate as (0,1,2),(2,3,0); 'o' lines split objects.

    Divergence: faces with >4 corners fan-triangulate (0,k,k+1) — the
    reference blindly reshapes the corner list to (-1, 3) there
    (loadutils.py:91-94), which raises or silently misaligns every
    subsequent face on such meshes.
    """
    if isinstance(file_obj, str):
        with open(file_obj) as f:
            text = f.read()
    else:
        text = file_obj.read()
    if hasattr(text, "decode"):
        text = text.decode("utf-8")
    text = text.replace("\r\n", "\n").replace("\r", "\n") + " \n"

    meshes = []
    positions: list = []
    corner_pos: list = []        # position per distinct face token
    face_idx: list = []          # flat face corner indices into corner_pos
    remap: dict = {}

    def flush():
        nonlocal corner_pos, face_idx, remap
        if face_idx:
            vertices = np.asarray(corner_pos, np.float64).reshape(-1, 3)
            faces = np.asarray(face_idx, np.int64).reshape(-1, 3)
            keys = np.asarray(list(remap.keys()))
            values = np.asarray(list(remap.values()))
            vert_order = values[keys.argsort()]
            face_order = np.zeros(len(vertices), np.int64)
            face_order[vert_order] = np.arange(len(vertices), dtype=np.int64)
            meshes.append(
                {"vertices": vertices[vert_order], "faces": face_order[faces]}
            )
        corner_pos, face_idx, remap = [], [], {}

    for line in text.split("\n"):
        parts = line.strip().split()
        if len(parts) < 2:
            continue
        if parts[0] == "v":
            positions.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            ft = parts[1:]
            if len(ft) == 4:
                # the reference's quad quirk: (0,1,2),(2,3,0)
                ft = [ft[0], ft[1], ft[2], ft[2], ft[3], ft[0]]
            elif len(ft) > 4:
                # general n-gons fan-triangulate (loadutils.py polygon fan)
                ft = [
                    t
                    for k in range(1, len(ft) - 1)
                    for t in (ft[0], ft[k], ft[k + 1])
                ]
            for token in ft:
                if token not in remap:
                    remap[token] = len(remap)
                    v_id = int(token.split("/")[0]) - 1
                    corner_pos.append(positions[v_id])
                face_idx.append(remap[token])
        elif parts[0] == "o":
            flush()
    flush()
    return meshes


def load_obj_normalized(path: str):
    """Load an OBJ and normalize into the unit cube, as
    mano_train/objectutils/objectio.py:6-43 does for simulation inputs."""
    mesh = fast_load_obj(path)[0]
    v = mesh["vertices"]
    v = v - v.min(0)
    v = v / np.abs(v).max()
    v = 2 * v - 1
    mesh["vertices"] = v - (v.max(0) + v.min(0)) / 2
    return mesh["vertices"].astype(np.float32), mesh["faces"].astype(np.int32)
