"""The contact block's constants without a host-to-device copy.

The ray direction and tolerance of the inside test and the abscissae of
``meshiou`` were once tensors built from Python data on the inputs' device
at every call: on a card, a copy from pageable host memory that waits for
the card to drain. They are now Python floats (the direction, the
tolerance) and one cached tensor per (values, dtype, device) (the
abscissae). These tests hold each consumer to that tensor formulation, bit
for bit, on the CPU and (marked ``cuda``) on a card, and on a card run a
train step with the CUDA runtime set to raise at any synchronization.

This file imports no JAX; on a machine without it:

    python3 -m pytest --noconftest tests/test_torch_step_constants.py -q
"""

import numpy as np
import pytest
import torch

from obman_train_tpu_torch import train
from obman_train_tpu_torch.assets import icosphere, synthetic_mano_assets
from obman_train_tpu_torch.config import AtlasConfig, ContactConfig, ModelConfig, TrainConfig
from obman_train_tpu_torch.data.loader import derive_spec
from obman_train_tpu_torch.models import build_handnet
from obman_train_tpu_torch.models import handnet as handnet_mod
from obman_train_tpu_torch.ops import inside, mesh, raytri
from obman_train_tpu_torch.ops.contact import compute_contact_loss
from obman_train_tpu_torch.weights import init_weights

torch.set_num_threads(2)

# the contact terms of the benchmark's obman_contact configuration
CONTACT = ModelConfig(
    atlas=AtlasConfig(predict_trans=True, predict_scale=True),
    contact=ContactConfig(contact_lambda=0.167, collision_lambda=0.167),
)


# ---------------------------------------------------------------------------
# The formulation with the constants as tensors on the inputs' device
# ---------------------------------------------------------------------------

def _tensor_triangle_table(triangles):
    d = torch.tensor(inside.RAY_DIRECTION, dtype=torch.float32, device=triangles.device)
    d0, d1, d2 = d[0], d[1], d[2]
    v0 = triangles[:, :, 0].to(torch.float32)
    e1 = (triangles[:, :, 1] - triangles[:, :, 0]).to(torch.float32)
    e2 = (triangles[:, :, 2] - triangles[:, :, 0]).to(torch.float32)
    e2x, e2y, e2z = e2.unbind(-1)
    pvx = d1 * e2z - d2 * e2y
    pvy = d2 * e2x - d0 * e2z
    pvz = d0 * e2y - d1 * e2x
    dets = e1[..., 0] * pvx + e1[..., 1] * pvy + e1[..., 2] * pvz
    ok = (torch.abs(dets) >= inside.TOL).to(torch.float32)
    invdet = 1.0 / (dets + 0.1 * inside.TOL)
    zero = torch.zeros_like(invdet)
    return torch.stack(
        [v0[..., 0], v0[..., 1], v0[..., 2], invdet,
         e1[..., 0], e1[..., 1], e1[..., 2], ok,
         e2x, e2y, e2z, zero,
         pvx, pvy, pvz, zero],
        dim=-1,
    ).contiguous()


def _tensor_raytri_count_plain(points, table):
    d = torch.tensor(inside.RAY_DIRECTION, dtype=torch.float32, device=points.device)
    d0, d1, d2 = d[0], d[1], d[2]
    tol = torch.tensor(inside.TOL, dtype=torch.float32, device=points.device)
    pts = points[:, :, None, :]
    tb = table[:, None, :, :]
    px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
    invdet = tb[..., 3]
    tx, ty, tz = px - tb[..., 0], py - tb[..., 1], pz - tb[..., 2]
    u = (tx * tb[..., 12] + ty * tb[..., 13] + tz * tb[..., 14]) * invdet
    e1x, e1y, e1z = tb[..., 4], tb[..., 5], tb[..., 6]
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (d0 * qx + d1 * qy + d2 * qz) * invdet
    t = (tb[..., 8] * qx + tb[..., 9] * qy + tb[..., 10] * qz) * invdet
    hit = (u > 0) & (u < 1) & (v > 0) & ((u + v) < 1) & (t >= tol)
    hit = hit & (tb[..., 7] > 0)
    return torch.sum(hit, dim=-1, dtype=torch.int32)


def _tensor_contains(points, triangles):
    d = torch.tensor(inside.RAY_DIRECTION, dtype=points.dtype, device=points.device)
    v0 = triangles[:, :, 0]
    v0v1 = triangles[:, :, 1] - v0
    v0v2 = triangles[:, :, 2] - v0
    pvec = inside._cross(d.expand_as(v0v2), v0v2)
    dets = inside._dot(v0v1, pvec)
    parallel = torch.abs(dets) < inside.TOL
    invdet = 1.0 / (dets + 0.1 * inside.TOL)
    tvec = points[:, :, None, :] - v0[:, None, :, :]
    u = inside._dot(tvec, pvec[:, None]) * invdet[:, None, :]
    qvec = inside._cross(tvec, v0v1[:, None].expand_as(tvec))
    v = inside._dot(qvec, d) * invdet[:, None, :]
    t = inside._dot(qvec, v0v2[:, None]) * invdet[:, None, :]
    hit = (u > 0) & (u < 1) & (v > 0) & ((u + v) < 1) & (t >= inside.TOL)
    hit = hit & ~parallel[:, None, :]
    return (torch.sum(hit, dim=-1, dtype=torch.int32) % 2) == 0


def _tensor_meshiou(gt_dists, pred_dists, threshs=tuple(range(1, 11))):
    ious = torch.stack([mesh.thresh_iou(gt_dists, pred_dists, t) for t in threshs], dim=0)
    xs = torch.tensor(threshs, dtype=ious.dtype, device=ious.device)
    return torch.mean(ious, dim=1), torch.mean(torch.trapezoid(ious, x=xs, dim=0))


@pytest.fixture
def tensor_constants(monkeypatch):
    """Routes the contact block through the tensor formulation."""
    monkeypatch.setattr(raytri, "triangle_table", _tensor_triangle_table)
    monkeypatch.setattr(raytri, "raytri_count_plain", _tensor_raytri_count_plain)
    monkeypatch.setattr(handnet_mod, "meshiou", _tensor_meshiou)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns, so that -0.0, 0.0 and NaNs count."""
    t = t.detach()
    if t.dtype == torch.bool or not t.is_floating_point():
        return t
    view = {torch.float64: torch.int64, torch.float32: torch.int32,
            torch.bfloat16: torch.int16, torch.float16: torch.int16}[t.dtype]
    return t.contiguous().view(view)


def _assert_bitwise(got, want, msg=""):
    assert got.dtype == want.dtype and got.shape == want.shape, msg
    assert torch.equal(_bits(got), _bits(want)), msg


def _scene(seed, B=2, P=300, dtype=torch.float32, scale=1.0):
    """Points around an icosphere(3) per batch element, a third of them
    within 3 % of its surface, so that rounding decides some hits."""
    rng = np.random.default_rng(seed)
    verts, faces = icosphere(3)
    radii = rng.uniform(30, 70, (B, 1, 1))
    centers = rng.normal(0, 5, (B, 1, 3))
    tris = (verts[None] * radii + centers)[:, faces]
    dirs = rng.normal(0, 1, (B, P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    frac = rng.choice([0.3, 0.97, 0.999, 1.0, 1.001, 1.03, 2.0], (B, P, 1))
    pts = centers + dirs * radii * frac
    return (torch.from_numpy(pts * scale).to(dtype),
            torch.from_numpy(tris * scale).to(dtype))


# ---------------------------------------------------------------------------
# CPU: each consumer bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_triangle_table_equals_the_tensor_direction(dtype):
    """``raytri.triangle_table`` on float32 and bf16 triangles."""
    _, tris = _scene(1, dtype=dtype)
    _assert_bitwise(raytri.triangle_table(tris), _tensor_triangle_table(tris))


def test_raytri_count_plain_equals_the_tensor_direction():
    """``raytri.raytri_count_plain``: the K1 counts of the CPU route."""
    pts, tris = _scene(2)
    table = raytri.triangle_table(tris)
    want = _tensor_raytri_count_plain(pts, table)
    assert want.sum() > 0
    _assert_bitwise(raytri.raytri_count_plain(pts, table), want)


@pytest.mark.parametrize("pdt,tdt", [
    (torch.float32, torch.float32), (torch.float64, torch.float64),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float16, torch.float32),
])
def test_batch_mesh_contains_points_equals_the_tensor_direction(pdt, tdt):
    """``inside.batch_mesh_contains_points``, the plain route, with the
    points and the triangles in each dtype and in mixed ones."""
    pts, tris = _scene(3, P=200, scale=0.02)
    pts, tris = pts.to(pdt), tris.to(tdt)
    want = _tensor_contains(pts, tris)
    assert want.any() and not want.all()
    _assert_bitwise(inside.batch_mesh_contains_points(pts, tris), want)


@pytest.mark.parametrize("threshs", [None, (0.5, 2, 3.25, 7, 9.5, 20), [1, 4, 9, 16]])
def test_meshiou_equals_trapezoid_over_a_fresh_tensor(threshs):
    """``mesh.meshiou``: ``batch_ious`` and ``contact_auc`` against
    ``torch.trapezoid(ious, x=torch.tensor(threshs))``, at the default and
    at other abscissae, a list among them."""
    rng = np.random.default_rng(4)
    gt = torch.from_numpy(rng.uniform(0, 25, (3, 778)).astype(np.float32))
    pred = torch.from_numpy(rng.uniform(0, 25, (3, 778)).astype(np.float32))
    kw = {} if threshs is None else {"threshs": threshs}
    got = mesh.meshiou(gt, pred, **kw)
    want = _tensor_meshiou(gt, pred, **({} if threshs is None else {"threshs": tuple(threshs)}))
    for g, w in zip(got, want):
        _assert_bitwise(g, w)
    # the second call reads the cached abscissae
    for g, w in zip(mesh.meshiou(gt, pred, **kw), want):
        _assert_bitwise(g, w)


def _contact_inputs():
    rng = np.random.default_rng(5)
    hand = synthetic_mano_assets("right").v_template * 1000.0
    hand = hand[None] + rng.normal(0, 2.0, (2, 778, 3))
    verts, faces = icosphere(3)
    center = hand.mean(axis=1, keepdims=True)
    obj = np.stack([verts * 50.0 + center[0] + np.array([40.0, 0.0, 0.0]),
                    verts * 45.0 + center[1] + np.array([0.0, 30.0, 10.0])])
    return (torch.from_numpy(hand.astype(np.float32)), torch.from_numpy(obj.astype(np.float32)),
            torch.from_numpy(np.array(faces)))


def _contact_grads():
    hand, obj, faces = _contact_inputs()
    hand.requires_grad_(True)
    obj.requires_grad_(True)
    c = CONTACT.contact
    attr, penetr, info, _ = compute_contact_loss(
        hand, obj, faces, contact_thresh=c.contact_thresh, contact_mode=c.contact_mode,
        collision_thresh=c.collision_thresh, collision_mode=c.collision_mode,
        contact_zones=c.contact_zones)
    (c.contact_lambda * attr + c.collision_lambda * penetr).backward()
    return attr, penetr, info, hand.grad, obj.grad


def test_contact_loss_gradient_equals_the_tensor_direction(monkeypatch):
    """``ops.contact.compute_contact_loss``: both terms, the masks the
    inside test decides through ``triangle_table`` and the K1 counts, and
    the gradients on the hand and the object, against the tensor
    formulation."""
    got = _contact_grads()
    monkeypatch.setattr(raytri, "triangle_table", _tensor_triangle_table)
    monkeypatch.setattr(raytri, "raytri_count_plain", _tensor_raytri_count_plain)
    want = _contact_grads()
    assert want[2]["repulsion_masks"].any() and not want[2]["repulsion_masks"].all()
    for name, g, w in zip(("attraction", "penetration"), got[:2], want[:2]):
        _assert_bitwise(g, w, name)
    for key in ("attraction_masks", "repulsion_masks", "min_dists"):
        _assert_bitwise(got[2][key], want[2][key], key)
    _assert_bitwise(got[3], want[3], "hand grad")
    _assert_bitwise(got[4], want[4], "object grad")


def _gt_batch(B, S, seed):
    rng = np.random.default_rng(seed)
    return {
        "images": rng.integers(0, 256, (B, S, S, 3)).astype(np.uint8),
        "sides": rng.integers(0, 2, (B,)).astype(np.int32),
        "joints3d": rng.normal(0, 30, (B, 21, 3)).astype(np.float32),
        "verts3d": rng.normal(0, 30, (B, 778, 3)).astype(np.float32),
        "center3d": rng.normal(0, 30, (B, 3)).astype(np.float32),
        "objpoints3d": rng.normal(0, 50, (B, 600, 3)).astype(np.float32),
    }


def _step_on(device, batch, steps=1):
    net = init_weights(build_handnet(CONTACT, synthetic_mano_assets("right"),
                                     synthetic_mano_assets("left"), device="cpu"),
                       seed=0).to(device)
    cfg = TrainConfig(optimizer="adam", lr=1e-4)
    opt = train.make_optimizer(cfg, net)
    step = train.make_train_step(net, opt, derive_spec(batch), device=device,
                                 return_joints=True)
    state = train.create_train_state(net, opt, cfg)
    for _ in range(steps):
        state, losses, joints = step(state, batch)
    return net, step, state, losses, joints


def test_train_step_losses_and_gradients_equal_the_tensor_constants(request):
    """``train.make_train_step``'s step on the contact configuration:
    every loss term (``contact_auc`` through ``meshiou``, the contact
    terms through ``triangle_table``), the joints, every gradient and every
    parameter after Adam's update, against the tensor formulation."""
    batch = _gt_batch(2, 64, 0)
    got_net, _, _, got_losses, got_joints = _step_on("cpu", batch)
    request.getfixturevalue("tensor_constants")
    want_net, _, _, want_losses, want_joints = _step_on("cpu", batch)
    assert "contact_auc" in want_losses and "penetration_loss" in want_losses
    assert set(got_losses) == set(want_losses)
    for k, v in want_losses.items():
        _assert_bitwise(got_losses[k], v, k)
    _assert_bitwise(got_joints, want_joints, "joints")
    want = dict(want_net.named_parameters())
    for name, p in got_net.named_parameters():
        if want[name].grad is None:
            assert p.grad is None, name
            continue
        _assert_bitwise(p.grad, want[name].grad, name + " grad")
        _assert_bitwise(p, want[name], name)


def test_cached_abscissae_serve_training_after_inference_mode():
    """``mesh._abscissae`` first filled under ``torch.inference_mode()``
    (a contact forward with its losses, as an evaluation runs it), then a
    training forward and backward in the same process."""
    mesh._abscissae.cache_clear()
    batch = _gt_batch(2, 64, 1)
    net = init_weights(build_handnet(CONTACT, synthetic_mano_assets("right"),
                                     synthetic_mano_assets("left"), device="cpu"), seed=0)
    with torch.inference_mode():
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        _, _, losses = net(tb, derive_spec(batch))
        assert torch.isfinite(losses["contact_auc"])
    xs = mesh._abscissae(tuple(range(1, 11)), torch.float32, torch.device("cpu"))
    assert not xs.is_inference()
    net, _, state, losses, _ = _step_on("cpu", batch)
    assert state.step == 1 and torch.isfinite(losses["total_loss"])
    assert all(p.grad is not None for p in net.base_net.parameters())


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    yield torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_constants_on_cuda_equal_the_tensor_constants(cuda, dtype):
    """On the card: ``triangle_table`` and the K1 kernel's counts on its
    table, and ``meshiou``, bit for bit against the tensor formulation."""
    pts, tris = (t.to(cuda) for t in _scene(6, B=4, P=778))
    tris = tris.to(dtype)
    table = raytri.triangle_table(tris)
    want = _tensor_triangle_table(tris)
    _assert_bitwise(table, want)
    _assert_bitwise(raytri.raytri_count(pts, table), raytri.raytri_count(pts, want))
    rng = np.random.default_rng(7)
    gt = torch.from_numpy(rng.uniform(0, 25, (4, 778)).astype(np.float32)).to(cuda)
    pred = torch.from_numpy(rng.uniform(0, 25, (4, 778)).astype(np.float32)).to(cuda)
    for threshs in (tuple(range(1, 11)), (0.5, 2, 3.25, 7, 9.5, 20)):
        for g, w in zip(mesh.meshiou(gt, pred, threshs), _tensor_meshiou(gt, pred, threshs)):
            _assert_bitwise(g, w)


@pytest.mark.cuda
def test_train_step_on_cuda_makes_no_host_sync(cuda):
    """``train.make_train_step`` on a small batch of the contact
    configuration held on the card, as the benchmark's pool holds it, with
    Adam and the joints returned: after two warm-up steps, a third one with
    the CUDA runtime set to raise at any synchronization."""
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in _gt_batch(8, 128, 2).items()}
    _, step, state, _, _ = _step_on(cuda, batch, steps=2)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, losses, joints = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    assert state.step == 3
    assert torch.isfinite(losses["total_loss"]) and torch.isfinite(joints).all()
