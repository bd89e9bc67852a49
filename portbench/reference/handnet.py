"""Plain float32 reference of the ObMan hand-object network (Hasson et al.,
"Learning joint reconstruction of hands and manipulated objects", CVPR
2019, arXiv:1904.05767, §3): a ResNet-18 encoder, the MANO branch, the
AtlasNet sphere decoder with translation and scale heads, the branch
losses and the contact and collision losses (§3.3).

Written from the paper's equations and the reference release's layer
list in plain ``torch`` (``F.conv2d``, ``F.linear``, ``F.batch_norm`` with
running statistics, the frozen-BN recipe), with TF32 off. It imports
nothing of the program under test and none of its kernels:

- nearest neighbours are exact differences ``|x - y|^2`` over every pair,
  in blocks, the first index reaching the minimum; the loss takes the
  selected pair's distance again, so its gradient is the minimum's
  subgradient through that pair;
- inside or outside is the ray-parity Möller–Trumbore test of every
  (point, triangle) pair along the release's fixed ray
  (contactutils.py:62-159), in blocks;
- MANO is the quaternion Rodrigues form, PCA pose basis, blend shapes,
  the 16-joint chain and linear blend skinning (manopth), in millimetres.

Parameters are a flat dict ``name -> tensor`` whose names are the release
checkpoint's (``base_net.layer1.0.conv1.weight``, ``mano_branch.pose_reg.bias``,
``atlas_branch.decoder.conv1.weight``, ...); :func:`param_specs` lists them
for a configuration.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
ZONES_PATH = os.path.join(HERE, "contact_zones.npz")

RAY = (0.4395064455, 0.617598629942, 0.652231566745)
RAY_TOL = 1e-7
MANO_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
MANO_TIPS = (745, 317, 444, 556, 673)
JOINT_ORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)
BN_EPS = 1e-5
STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))  # ResNet-18: 2 basic blocks each

# the loss terms compared, as the program's loss dict names them: every
# term of the total and ``mean_penetr``, the mean penetration depth over
# all hand vertices, which holds the inside test where the repulsion term,
# a mean over the penetrating vertices alone, jumps by 1/count when a
# vertex within rounding of the surface changes sides
LOSS_TERMS = ("total_loss", "mano_verts3d", "mano_joints3d", "attraction_loss",
              "penetration_loss", "mean_penetr", "atlas_objpoints3d", "final_chamfer_loss",
              "atlas_trans3d", "atlas_scale3d", "atlas_edge_regul")
CONTINUOUS_TERMS = tuple(k for k in LOSS_TERMS if k != "penetration_loss")


# -- parameters -------------------------------------------------------------

def _bn_specs(prefix: str, c: int) -> List[Tuple]:
    return [(f"{prefix}.weight", (c,), "one"), (f"{prefix}.bias", (c,), "zero"),
            (f"{prefix}.running_mean", (c,), "zero"), (f"{prefix}.running_var", (c,), "one"),
            (f"{prefix}.num_batches_tracked", (), "count")]


def param_specs(cfg: Dict) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, init)`` of every tensor of the model's state: init
    ``lecun`` (normal / sqrt(fan_in)), ``zero``, ``one`` or ``count``."""
    specs: List[Tuple] = [("base_net.conv1.weight", (64, 3, 7, 7), "lecun")]
    specs += _bn_specs("base_net.bn1", 64)
    cin = 64
    for s, (width, stride) in enumerate(STAGES, start=1):
        for b in range(2):
            p = f"base_net.layer{s}.{b}"
            specs.append((f"{p}.conv1.weight", (width, cin if b == 0 else width, 3, 3), "lecun"))
            specs += _bn_specs(f"{p}.bn1", width)
            specs.append((f"{p}.conv2.weight", (width, width, 3, 3), "lecun"))
            specs += _bn_specs(f"{p}.bn2", width)
            if b == 0 and (stride != 1 or cin != width):
                specs.append((f"{p}.downsample.0.weight", (width, cin, 1, 1), "lecun"))
                specs += _bn_specs(f"{p}.downsample.1", width)
        cin = width
    mano = cfg["mano"]
    neurons = [512, *mano["base_neurons"]]
    for i, (a, b) in enumerate(zip(neurons[:-1], neurons[1:])):
        specs += [(f"mano_branch.base_layer.{2 * i}.weight", (b, a), "lecun"),
                  (f"mano_branch.base_layer.{2 * i}.bias", (b,), "zero")]
    pose = mano["ncomps"] + 3
    specs += [("mano_branch.pose_reg.weight", (pose, neurons[-1]), "lecun"),
              ("mano_branch.pose_reg.bias", (pose,), "zero")]
    bott = 512 + 3
    widths = [bott, bott, bott // 2, bott // 4, 3]
    for i in range(4):
        specs += [(f"atlas_branch.decoder.conv{i + 1}.weight", (widths[i + 1], widths[i], 1), "lecun"),
                  (f"atlas_branch.decoder.conv{i + 1}.bias", (widths[i + 1],), "zero")]
    for i in range(3):
        specs += _bn_specs(f"atlas_branch.decoder.bn{i + 1}", widths[i + 1])
    atlas = cfg["atlas"]
    for head, out, flag in (("decode_trans", 3, "predict_trans"), ("decode_scale", 1, "predict_scale")):
        if atlas[flag]:
            specs += [(f"atlas_branch.{head}.0.weight", (256, 512), "lecun"),
                      (f"atlas_branch.{head}.0.bias", (256,), "zero"),
                      (f"atlas_branch.{head}.2.weight", (out, 256), "lecun"),
                      # the scale head's last bias starts at 1 (atlasbranch.py:61)
                      (f"atlas_branch.{head}.2.bias", (out,), "one" if head == "decode_scale" else "zero")]
    return specs


def trainable(name: str) -> bool:
    return not (name.endswith("running_mean") or name.endswith("running_var")
                or name.endswith("num_batches_tracked"))


# -- the template meshes ----------------------------------------------------

def icosphere(subdivisions: int) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere (trimesh's vertex order): the icosahedron, each face
    split in four with shared midpoints, projected onto the sphere."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
             (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    verts = np.asarray(verts, np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    for _ in range(subdivisions):
        vlist = [tuple(v) for v in verts]
        cache: Dict[Tuple[int, int], int] = {}

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                vlist.append(tuple((np.asarray(vlist[i]) + np.asarray(vlist[j])) / 2.0))
                cache[key] = len(vlist) - 1
            return cache[key]

        new = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist, np.float64)
        verts /= np.linalg.norm(verts, axis=1, keepdims=True)
        faces = np.asarray(new)
    return verts.astype(np.float32), faces.astype(np.int64)


def zone_masks() -> np.ndarray:
    data = np.load(ZONES_PATH)
    zones = sorted(k for k in data.files if k.startswith("zone_"))
    masks = np.zeros((len(zones), 778), bool)
    for i, k in enumerate(zones):
        masks[i, data[k]] = True
    return masks


class Model:
    """The reference network on ``device``: its tables, made here from the
    raw MANO files and the icosphere, and a forward over a parameter dict."""

    def __init__(self, cfg: Dict, mano_files: Dict[str, str], device: str):
        self.cfg, self.device = cfg, torch.device(device)
        self.mano = {side: self._mano_tables(path) for side, path in mano_files.items()}
        v, f = icosphere(cfg["atlas"]["ico_divisions"])
        self.template = torch.from_numpy(v).to(self.device)
        self.faces = torch.from_numpy(f).to(self.device)
        self.zones = torch.from_numpy(zone_masks()).to(self.device)

    def _mano_tables(self, path: str) -> Dict[str, torch.Tensor]:
        data = np.load(path, allow_pickle=False)
        names = ("v_template", "shapedirs", "posedirs", "J_regressor", "weights",
                 "hands_components", "hands_mean")
        return {k: torch.from_numpy(np.asarray(data[k], np.float32)).to(self.device)
                for k in names}

    # -- layers --
    @staticmethod
    def _bn(p, name, x):
        return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                            p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0, BN_EPS)

    def encode(self, p, x: torch.Tensor) -> torch.Tensor:
        """NCHW float images -> (B, 512) pooled features."""
        x = F.conv2d(x, p["base_net.conv1.weight"], stride=2, padding=3)
        x = F.relu(self._bn(p, "base_net.bn1", x))
        x = F.max_pool2d(x, 3, 2, 1)
        for s, (_, stride) in enumerate(STAGES, start=1):
            for b in range(2):
                q = f"base_net.layer{s}.{b}"
                st = stride if b == 0 else 1
                y = F.relu(self._bn(p, f"{q}.bn1", F.conv2d(x, p[f"{q}.conv1.weight"], stride=st, padding=1)))
                y = self._bn(p, f"{q}.bn2", F.conv2d(y, p[f"{q}.conv2.weight"], padding=1))
                if f"{q}.downsample.0.weight" in p:
                    x = self._bn(p, f"{q}.downsample.1",
                                 F.conv2d(x, p[f"{q}.downsample.0.weight"], stride=st))
                x = F.relu(y + x)
        return x.mean(dim=(2, 3))

    def mano_forward(self, t: Dict[str, torch.Tensor], pose: torch.Tensor):
        """(B, ncomps + 3) PCA pose -> verts (B, 778, 3), joints (B, 21, 3) in mm,
        centred on joint ``center_idx``."""
        ncomps = self.cfg["mano"]["ncomps"]
        B = pose.shape[0]
        full = t["hands_mean"] + pose[:, 3:3 + ncomps] @ t["hands_components"][:ncomps]
        aa = torch.cat([pose[:, :3], full], dim=1).reshape(B, 16, 3)
        angle = torch.sqrt((aa * aa).sum(-1) + 1e-16)
        w = torch.cos(angle * 0.5)
        xyz = aa * (torch.sin(angle * 0.5) / angle)[..., None]
        x, y, z = xyz.unbind(-1)
        rot = torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (w * y + x * z),
                           2 * (w * z + x * y), w * w - x * x + y * y - z * z, 2 * (y * z - w * x),
                           2 * (x * z - w * y), 2 * (w * x + y * z), w * w - x * x - y * y + z * z],
                          dim=-1).reshape(B, 16, 3, 3)
        v_shaped = t["v_template"].expand(B, -1, -1)
        j_rest = torch.einsum("jv,bvd->bjd", t["J_regressor"], v_shaped)
        feat = (rot[:, 1:] - torch.eye(3, device=pose.device)).reshape(B, 135)
        v_posed = v_shaped + torch.einsum("vdp,bp->bvd", t["posedirs"], feat)
        world = []
        for j in range(16):
            par = MANO_PARENTS[j]
            offset = j_rest[:, j] if par < 0 else j_rest[:, j] - j_rest[:, par]
            local = torch.zeros(B, 4, 4, device=pose.device)
            local[:, :3, :3] = rot[:, j]
            local[:, :3, 3] = offset
            local[:, 3, 3] = 1.0
            world.append(local if par < 0 else world[par] @ local)
        G = torch.stack(world, dim=1)
        j_posed = G[:, :, :3, 3]
        A = torch.cat([G[:, :, :3, :3],
                       (j_posed - torch.einsum("bjik,bjk->bji", G[:, :, :3, :3], j_rest))[..., None]], 3)
        T = torch.einsum("vj,bjik->bvik", t["weights"], A)
        verts = torch.einsum("bvij,bvj->bvi", T[..., :3], v_posed) + T[..., 3]
        joints = torch.cat([j_posed, verts[:, list(MANO_TIPS)]], dim=1)[:, list(JOINT_ORDER)]
        c = self.cfg["mano"]["center_idx"]
        centre = joints[:, c:c + 1]
        return (verts - centre) * 1000.0, (joints - centre) * 1000.0

    def forward(self, p: Dict[str, torch.Tensor], images: torch.Tensor, sides: torch.Tensor):
        """NHWC images already normalized (x/255 - 0.5) and sides (0 right,
        1 left) -> the predictions the program returns."""
        feats = self.encode(p, images.permute(0, 3, 1, 2))
        h = feats
        n_layers = len(self.cfg["mano"]["base_neurons"])
        for i in range(n_layers):
            h = F.relu(F.linear(h, p[f"mano_branch.base_layer.{2 * i}.weight"],
                                p[f"mano_branch.base_layer.{2 * i}.bias"]))
        pose = F.linear(h, p["mano_branch.pose_reg.weight"], p["mano_branch.pose_reg.bias"])
        vr, jr = self.mano_forward(self.mano["right"], pose)
        vl, jl = self.mano_forward(self.mano["left"], pose)
        right = (sides == 0)[:, None, None]
        out = {"verts": torch.where(right, vr, vl), "joints": torch.where(right, jr, jl)}

        B, V = feats.shape[0], self.template.shape[0]
        grid = self.template.t().expand(B, 3, V)
        x = torch.cat([grid, feats[:, :, None].expand(B, 512, V)], dim=1)
        for i in range(1, 4):
            x = F.conv1d(x, p[f"atlas_branch.decoder.conv{i}.weight"], p[f"atlas_branch.decoder.conv{i}.bias"])
            x = F.relu(self._bn(p, f"atlas_branch.decoder.bn{i}", x))
        x = F.conv1d(x, p["atlas_branch.decoder.conv4.weight"], p["atlas_branch.decoder.conv4.bias"])
        verts = (self.cfg["atlas"]["out_factor"] * x).transpose(1, 2)

        def head(name):
            z = F.relu(F.linear(feats, p[f"atlas_branch.{name}.0.weight"], p[f"atlas_branch.{name}.0.bias"]))
            return F.linear(z, p[f"atlas_branch.{name}.2.weight"], p[f"atlas_branch.{name}.2.bias"])

        scale = head("decode_scale")
        trans = head("decode_trans")
        out.update(objscale=scale, objtrans=trans, objpointscentered3d=verts,
                   objpoints3d=scale[:, None, :] * verts + trans[:, None, :])
        return out

    # -- losses --
    def losses(self, out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]) -> Dict:
        cfg = self.cfg
        m, a, c = cfg["mano"], cfg["atlas"], cfg["contact"]
        L: Dict[str, torch.Tensor] = {}
        L["mano_verts3d"] = ((out["verts"] - batch["verts3d"]) ** 2).mean()
        L["mano_joints3d"] = ((out["joints"] - batch["joints3d"]) ** 2).mean()
        total = m["lambda_verts"] * L["mano_verts3d"] + m["lambda_joints3d"] * L["mano_joints3d"]
        if c["contact_lambda"] or c["collision_lambda"]:
            attr, pen, depth = self.contact_losses(out["verts"], out["objpoints3d"])
            L["attraction_loss"], L["penetration_loss"], L["mean_penetr"] = attr, pen, depth
            total = total + c["contact_lambda"] * attr + c["collision_lambda"] * pen
        target = batch["objpoints3d"]
        centroid = target.mean(1)
        centred = target - centroid[:, None]
        L["atlas_trans3d"] = ((out["objtrans"] - centroid) ** 2).mean()
        radius = torch.sqrt((centred ** 2).sum(2) + 1e-16).amax(1)
        L["atlas_scale3d"] = ((out["objscale"] - radius[:, None]) ** 2).mean()
        L["atlas_objpoints3d"] = chamfer(out["objpointscentered3d"], centred)
        L["final_chamfer_loss"] = chamfer(out["objpoints3d"], target)
        L["atlas_edge_regul"] = edge_regul(out["objpointscentered3d"], self.faces)
        total = (total + a["lambda_atlas"] * L["atlas_objpoints3d"]
                 + a["final_lambda_atlas"] * L["final_chamfer_loss"]
                 + a["trans_weight"] * L["atlas_trans3d"] + a["scale_weight"] * L["atlas_scale3d"]
                 + a["lambda_regul_edges"] * L["atlas_edge_regul"])
        L["total_loss"] = total
        return L

    def contact_losses(self, hand: torch.Tensor, obj: torch.Tensor):
        """Attraction on the exterior hand vertex of each contact zone
        nearest the object, repulsion on the penetrating hand vertices,
        both ``thresh * tanh(d / thresh)`` of the distance to the nearest
        object point (``dist_tanh``, target ``all``); and the mean
        penetration depth over every hand vertex."""
        c = self.cfg["contact"]
        with torch.no_grad():
            d_min, idx = nearest(hand, obj)
            exterior = outside(hand, obj[:, self.faces])
            masked = torch.where(self.zones[None], d_min[:, None, :],
                                 torch.full_like(d_min[:, None, :], float("inf")))
            win = torch.zeros_like(exterior)
            win.scatter_(1, masked.argmin(2), True)
        close = torch.gather(obj, 1, idx[..., None].expand(-1, -1, 3))
        dist = torch.sqrt(((close - hand) ** 2).sum(2) + 1e-16)
        attract = c["contact_thresh"] * torch.tanh(dist / c["contact_thresh"])
        repulse = c["collision_thresh"] * torch.tanh(dist / c["collision_thresh"])
        depth = (dist.detach() * (~exterior).to(dist.dtype)).mean()
        return masked_mean(attract, exterior & win), masked_mean(repulse, ~exterior), depth


def masked_mean(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(vals.dtype)
    return (vals * m).sum() / m.sum().clamp(min=1.0)


def nearest(x: torch.Tensor, y: torch.Tensor, rows: int = 1 << 24):
    """Per point of ``x`` (B, N, 3) the squared distance to the nearest of
    ``y`` (B, M, 3) and the first index reaching it, by exact differences."""
    B, N, _ = x.shape
    M = y.shape[1]
    step = max(1, rows // max(1, N * M))
    mins, args = [], []
    for b in range(0, B, step):
        d = ((x[b:b + step, :, None, :] - y[b:b + step, None, :, :]) ** 2).sum(-1)
        v, i = d.min(2)
        mins.append(v)
        args.append(i)
    return torch.cat(mins), torch.cat(args)


def chamfer(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """mean over the batch of (mean nearest squared distance pred -> gt
    + mean gt -> pred), each through the selected pairs."""
    with torch.no_grad():
        _, i_pg = nearest(pred.detach(), gt)
        _, i_gp = nearest(gt, pred.detach())
    near_gt = torch.gather(gt, 1, i_pg[..., None].expand(-1, -1, 3))
    near_pred = torch.gather(pred, 1, i_gp[..., None].expand(-1, -1, 3))
    d_pg = ((pred - near_gt) ** 2).sum(2).mean(1)
    d_gp = ((gt - near_pred) ** 2).sum(2).mean(1)
    return (d_pg + d_gp).mean()


def edge_regul(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Mean absolute deviation of the squared edge lengths of every face
    from their mean over the mesh (atlasbranch.py:153-167)."""
    a, b, c = verts[:, faces[:, 0]], verts[:, faces[:, 1]], verts[:, faces[:, 2]]
    edges = torch.cat([((a - c) ** 2).sum(2), ((c - b) ** 2).sum(2), ((b - a) ** 2).sum(2)], 1)
    return (edges - edges.mean(1, keepdim=True)).abs().mean()


def outside(points: torch.Tensor, tris: torch.Tensor, pairs: int = 1 << 23) -> torch.Tensor:
    """True where the ray from a point crosses the mesh an even number of
    times (Möller–Trumbore on every pair; near-parallel triangles skipped)."""
    d = torch.tensor(RAY, dtype=torch.float32, device=points.device)
    B, P, _ = points.shape
    v0 = tris[:, :, 0]
    e1 = tris[:, :, 1] - v0
    e2 = tris[:, :, 2] - v0
    pvec = torch.linalg.cross(d.expand_as(e2), e2)
    det = (e1 * pvec).sum(-1)
    ok = det.abs() >= RAY_TOL
    inv = 1.0 / (det + 0.1 * RAY_TOL)
    step = max(1, pairs // max(1, P * tris.shape[1]))
    counts = []
    for b in range(0, B, step):
        s = slice(b, b + step)
        tv = points[s, :, None, :] - v0[s, None]
        u = (tv * pvec[s, None]).sum(-1) * inv[s, None]
        q = torch.linalg.cross(tv, e1[s, None].expand_as(tv))
        v = (q * d).sum(-1) * inv[s, None]
        t = (q * e2[s, None]).sum(-1) * inv[s, None]
        hit = (u > 0) & (u < 1) & (v > 0) & (u + v < 1) & (t >= RAY_TOL) & ok[s, None]
        counts.append(hit.sum(-1))
    return torch.cat(counts) % 2 == 0


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    return images_u8.to(torch.float32) / 255.0 - 0.5


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of an antialiased bilinear resize: a triangle
    filter stretched by the shrink factor, centred on each output pixel,
    normalized to sum 1 (PIL's resampling)."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    w = np.zeros((n_out, n_in))
    for i in range(n_out):
        centre = scale * (i + 0.5)
        lo = max(int(centre - support + 0.5), 0)
        hi = min(int(centre + support + 0.5), n_in)
        j = np.arange(lo, hi)
        k = np.clip(1.0 - np.abs((j - centre + 0.5) / support), 0.0, None)
        w[i, lo:hi] = k / k.sum()
    return w


def preprocess(frames_u8: torch.Tensor, size: int) -> torch.Tensor:
    """Demo frames (B, H, W, 3) uint8 -> the centre square resized to
    ``size`` and normalized, NHWC float32."""
    H, W = frames_u8.shape[1:3]
    s = min(H, W)
    top, left = (H - s) // 2, (W - s) // 2
    x = frames_u8[:, top:top + s, left:left + s].to(torch.float32)
    if s != size:
        r = torch.from_numpy(resize_weights(s, size)).to(x.device, torch.float32)
        x = torch.einsum("yi,bijc->byjc", r, x)
        x = torch.einsum("xj,byjc->byxc", r, x)
    return x / 255.0 - 0.5
