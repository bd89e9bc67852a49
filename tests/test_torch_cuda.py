"""Tests of the port that need an NVIDIA GPU (the CUDA kernels have no CPU
mode). They skip without one. This file imports no JAX, so it also runs on
a machine without it, where tests/conftest.py (which imports JAX) must be
left out:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda*.py -q

The kernels' exactness rows use the scenes of tools/kernel_ab.py, which
times the same rows.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from obman_train_tpu_torch import train
from obman_train_tpu_torch.assets import icosphere, synthetic_mano_assets
from obman_train_tpu_torch.config import AtlasConfig, ContactConfig, ModelConfig, TrainConfig
from obman_train_tpu_torch.infer import make_infer
from obman_train_tpu_torch.models import INFER_SPEC, BatchSpec, build_handnet
from obman_train_tpu_torch.ops import (chamfer, compute_contact_loss,
                                       mesh_contains_points_plain, nnsqdist, raytri,
                                       relu_grad)
from obman_train_tpu_torch.ops.kernels import LAUNCHES
from obman_train_tpu_torch.weights import init_weights

pytestmark = pytest.mark.cuda

CONTACT = ModelConfig(
    atlas=AtlasConfig(predict_trans=True, predict_scale=True),
    contact=ContactConfig(contact_lambda=0.167, collision_lambda=0.167),
)
HAND_OBJECT = ModelConfig(atlas=CONTACT.atlas)
# a contact-config train step: K1 once; two argmin sweeps for each of the
# two atlas Chamfer calls and the contact block; one min-only sweep for
# min_sqdist_to; with its encoder folded (frozen BN, float32) one
# relu_bias_grad per ReLU'd convolution of the ResNet-18 in the backward,
# none unfolded (bf16, unfrozen BN). An eval forward with losses: K1, the
# contact block's two argmin sweeps, two min sweeps for each gradient-free
# Chamfer loss and one for min_sqdist_to
UNFOLDED_TRAIN_LAUNCHES = {raytri.KERNEL: 1, nnsqdist.KERNEL_ARGMIN: 6, nnsqdist.KERNEL_MIN: 1}
TRAIN_LAUNCHES = {**UNFOLDED_TRAIN_LAUNCHES, relu_grad.KERNEL: 17}
EVAL_LAUNCHES = {raytri.KERNEL: 1, nnsqdist.KERNEL_ARGMIN: 2, nnsqdist.KERNEL_MIN: 5}
TRAIN_LOSS_KEYS = {
    "mano_verts3d", "mano_joints3d", "mano_total_loss", "contact_auc",
    "penetration_loss", "attraction_loss", "contact_loss", "max_penetr",
    "mean_penetr", "atlas_trans3d", "atlas_scale3d", "final_chamfer_loss",
    "atlas_objpoints3d", "total_loss",
}

_spec = importlib.util.spec_from_file_location(
    "kernel_ab", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "tools", "kernel_ab.py"))
kernel_ab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kernel_ab)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _scene(seed, B, P, n_tris=None):
    rng = np.random.default_rng(seed)
    verts, faces = icosphere(3)
    radii = rng.uniform(30, 70, (B, 1, 1))
    centers = rng.normal(0, 5, (B, 1, 3))
    tris = (verts[None] * radii + centers)[:, faces][:, :n_tris]
    dirs = rng.normal(0, 1, (B, P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    frac = rng.choice([0.3, 0.97, 0.999, 1.001, 1.03, 2.0], (B, P, 1))
    pts = centers + dirs * radii * frac
    return (torch.from_numpy(pts.astype(np.float32)),
            torch.from_numpy(tris.astype(np.float32)))


# every ragged point tile against every ragged staged chunk, and the shapes
# whose launch plan splits the triangles across blocks (voxel grids, the
# contact forward of one sample and of 32)
_RAGGED = [(2, p, t) for p in (1, 31, 33, 129, 778)
           for t in (1, raytri.CHUNK - 1, raytri.CHUNK + 1, 1280)]
_SPLIT = [(1, 4096, 1280), (1, 20000, 1280), (2, 129, 1280), (1, 778, 1280), (32, 778, 1280)]


@pytest.mark.parametrize("B,P,n_tris",
                         [(8, 778, None), (3, 100, 77), (1, 1, 1), *_RAGGED, *_SPLIT])
def test_raytri_kernel_equals_plain(cuda, B, P, n_tris):
    pts, tris = (t.to(cuda) for t in _scene(B + P, B, P, n_tris))
    table = raytri.triangle_table(tris)
    before = LAUNCHES[raytri.KERNEL]
    got = raytri.raytri_count(pts, table)
    torch.cuda.synchronize()
    assert LAUNCHES[raytri.KERNEL] == before + 1
    assert torch.equal(got, raytri.raytri_count_plain(pts, table))
    # and equal to the CPU's plain counts on the same inputs
    assert torch.equal(got.cpu(), raytri.raytri_count(pts.cpu(), table.cpu()))
    if n_tris is None:
        ext = got % 2 == 0
        assert ext.any() and (~ext).any()


@pytest.mark.parametrize("row", ["raytri_count", "raytri_count_voxel_hand",
                                 "raytri_count_voxel_object"])
def test_raytri_kernel_equals_plain_at_the_table_rows(cuda, row):
    """K1 at the kernel table's rows (tools/kernel_ab.py's scenes): the
    contact block at 256x778x1280, and the voxel grids of ``intersect_vox``
    in one launch each, 1x32768x1538 (a hand) and 1x4096x1280 (an object):
    one launch, bitwise the plain version's, interior and exterior points."""
    if row == "raytri_count":
        pts, tris = kernel_ab.raytri_scene(256, 778, 1280, seed=0)
    else:
        pts, tris = next((p, t) for n, p, t in kernel_ab.voxel_scenes() if n == row)
    table = raytri.triangle_table(tris)
    before = LAUNCHES[raytri.KERNEL]
    got = raytri.raytri_count(pts, table)
    torch.cuda.synchronize()
    assert LAUNCHES[raytri.KERNEL] == before + 1
    assert torch.equal(got, raytri.raytri_count_plain(pts, table))
    assert (got % 2 == 1).any() and (got % 2 == 0).any()


def test_default_device_is_cuda(cuda):
    net = build_handnet(ModelConfig(), synthetic_mano_assets("right"),
                        synthetic_mano_assets("left"))
    assert next(net.parameters()).device.type == "cuda"


def test_slice_on_cuda_matches_cpu_port(cuda):
    """The contact-config forward on the card (TF32 off) agrees with the
    CPU port, whose parity with the JAX package the CPU tests hold."""
    gen = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 256, (2, 64, 64, 3), generator=gen, dtype=torch.uint8)
    sides = torch.tensor([0, 1], dtype=torch.int32)

    def net_on(device):
        net = build_handnet(CONTACT, synthetic_mano_assets("right"),
                            synthetic_mano_assets("left"), device="cpu")
        return init_weights(net, seed=0).to(device)

    gpu_net = net_on(cuda)
    LAUNCHES.clear()
    gpu = make_infer(gpu_net)(frames, sides)
    torch.cuda.synchronize()
    assert LAUNCHES[raytri.KERNEL] == 1
    cpu = make_infer(net_on("cpu"))(frames, sides)
    for key, atol in (("verts", 1e-2), ("joints", 1e-2), ("objpoints3d", 2e-2)):
        torch.testing.assert_close(gpu[key].cpu(), cpu[key], rtol=0, atol=atol)
    # the CPU contact block on the card's own floats gives the same masks
    c = CONTACT.contact
    _, _, info, _ = compute_contact_loss(
        gpu["verts"].cpu(), gpu["objpoints3d"].cpu(), gpu_net.ico_faces.cpu(),
        contact_thresh=c.contact_thresh, contact_mode=c.contact_mode,
        collision_thresh=c.collision_thresh, collision_mode=c.collision_mode,
        contact_target=c.contact_target, contact_sym=c.contact_sym,
        contact_zones=c.contact_zones,
    )
    assert torch.equal(info["repulsion_masks"], gpu["contact_info"]["repulsion_masks"].cpu())
    torch.testing.assert_close(info["min_dists"], gpu["contact_info"]["min_dists"].cpu(),
                               rtol=1e-4, atol=1e-2)


def _frames(B, S, seed, device):
    gen = torch.Generator().manual_seed(seed)
    frames = torch.randint(0, 256, (B, S, S, 3), generator=gen, dtype=torch.uint8)
    sides = torch.randint(0, 2, (B,), generator=gen, dtype=torch.int32)
    return frames.to(device), sides.to(device)


def test_contact_forward_at_full_width(cuda):
    """The contact-config forward through ``make_infer`` at B=256 on 256x256
    uint8 frames: K1 and the argmin sweep launch, the outputs have their
    shapes and finite values, the contact masks are boolean (B, 778) and
    equal to the same forward's with the plain inside test; the
    hand_object config's forward has no contact block."""
    net = _seeded(CONTACT, cuda)
    frames, sides = _frames(256, 256, 1, cuda)
    LAUNCHES.clear()
    out = make_infer(net)(frames, sides)
    torch.cuda.synchronize()
    assert LAUNCHES[raytri.KERNEL] and LAUNCHES[nnsqdist.KERNEL_ARGMIN]
    shapes = {"verts": (256, 778, 3), "joints": (256, 21, 3), "objpoints3d": (256, 642, 3)}
    for key, shape in shapes.items():
        assert tuple(out[key].shape) == shape and torch.isfinite(out[key]).all(), key
    info = out["contact_info"]
    assert torch.isfinite(info["min_dists"]).all()
    with torch.inference_mode():
        _, ref, _ = net({"images": frames, "sides": sides}, INFER_SPEC, no_loss=True,
                        force_hand=True, force_objects=True,
                        contains=mesh_contains_points_plain)
    for key in ("attraction_masks", "repulsion_masks"):
        assert info[key].dtype == torch.bool and tuple(info[key].shape) == (256, 778)
        assert torch.equal(info[key], ref["contact_info"][key]), key
    del net, out, ref
    ho = make_infer(_seeded(HAND_OBJECT, cuda))(frames, sides)
    assert "contact_info" not in ho and all(torch.isfinite(ho[k]).all() for k in shapes)


def _clouds(seed, B, N, M):
    """Seeded clouds with planted exact ties: every 8th search point
    repeats an earlier one, every 16th query point sits on a search point."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 40, (B, N, 3)).astype(np.float32)
    y = rng.normal(0, 40, (B, M, 3)).astype(np.float32)
    dup = np.arange(M)[7::8]
    y[:, dup] = y[:, rng.integers(0, 7, len(dup))]
    x[:, ::16] = y[:, rng.integers(0, M, len(x[0, ::16]))]
    return torch.from_numpy(x), torch.from_numpy(y)


@pytest.mark.parametrize("B,N,M", [(8, 600, 642), (4, 778, 642), (3, 100, 77), (1, 1, 1),
                                   (2, 129, 2049), (1, 4096, 5000), (1, 4097, 20000),
                                   (2, 129, 70000), (1, 1, 50000)])
@pytest.mark.parametrize("with_argmin", [False, True])
def test_nn_kernel_equals_plain(cuda, B, N, M, with_argmin):
    x, y = _clouds(B + N + M, B, N, M)
    # where the plan splits the search set: a minimum first found in a
    # middle slice and repeated in every later one
    nnsqdist.tie_across_slices(x, y, nnsqdist._sms(cuda))
    x, y = x.to(cuda), y.to(cuda)
    name = nnsqdist.KERNEL_ARGMIN if with_argmin else nnsqdist.KERNEL_MIN
    before = LAUNCHES[name]
    got, garg = nnsqdist.nn_dir(x, y, with_argmin)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    want, warg = nnsqdist.nn_dir_plain(x, y, with_argmin)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    cpu, carg = nnsqdist.nn_dir(x.cpu(), y.cpu(), with_argmin)
    assert torch.equal(got.cpu(), cpu)
    if with_argmin:
        assert garg.dtype == torch.int64
        assert torch.equal(garg, warg) and torch.equal(garg.cpu(), carg)


# the training shapes in both directions (the table's K2 256x778x600 and
# K3 256x600x642 among them) and the large clouds (K5 with argmin, K4 min
# only), on tools/kernel_ab.py's scenes
@pytest.mark.parametrize("B,N,M,with_argmin", [
    *((b, n, m, a) for b, n, m in ((256, 600, 642), (256, 642, 600), (256, 778, 642),
                                   (256, 642, 778), (256, 778, 600)) for a in (False, True)),
    (1, 16384, 16384, True), (1, 20000, 20000, False)])
def test_nn_kernel_equals_plain_at_full_width(cuda, B, N, M, with_argmin):
    q, s = kernel_ab.nn_scene(B, N, M, B + N + M, nnsqdist._sms(cuda))
    name = nnsqdist.KERNEL_ARGMIN if with_argmin else nnsqdist.KERNEL_MIN
    before = LAUNCHES[name]
    got, garg = nnsqdist.nn_dir(q, s, with_argmin)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    want, warg = nnsqdist.nn_dir_plain(q, s, with_argmin)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if with_argmin:
        assert torch.equal(garg, warg)


@pytest.mark.parametrize("B,N,M", [(4, 600, 642), (256, 600, 642), (1, 16384, 16384)])
def test_chamfer_loss_kernel_route_grads(cuda, B, N, M):
    """Kernel route on the card against the same VJP on the plain minima
    (index_add_ on CUDA is atomic, so the last bits may differ: rtol 1e-5,
    atol 1e-9), and against the kernel route on the CPU."""
    preds, gts = (t.to(cuda) for t in _clouds(1, B, N, M))

    def route(p, g):
        p = p.clone().requires_grad_(True)
        g = g.clone().requires_grad_(True)
        l1, l2 = chamfer.chamfer_loss(p, g, use_kernel=True)
        loss = torch.mean(l1 + l2)
        loss.backward()
        return loss.detach(), p.grad, g.grad

    before = LAUNCHES[nnsqdist.KERNEL_ARGMIN]
    loss, gp, gg = route(preds, gts)
    assert LAUNCHES[nnsqdist.KERNEL_ARGMIN] == before + 2
    min_g2p, arg_g2p = nnsqdist.nn_dir_plain(gts, preds, True)
    min_p2g, arg_p2g = nnsqdist.nn_dir_plain(preds, gts, True)
    want = torch.mean(torch.mean(min_p2g, 1) + torch.mean(min_g2p, 1))
    wgg, wgp = chamfer._min_sqdists_bwd(gts, preds, arg_g2p, arg_p2g,
                                        torch.full_like(min_g2p, 1 / (B * M)),
                                        torch.full_like(min_p2g, 1 / (B * N)))
    assert torch.equal(loss, want)
    torch.testing.assert_close(gp, wgp, rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(gg, wgg, rtol=1e-5, atol=1e-9)
    closs, cgp, cgg = route(preds.cpu(), gts.cpu())
    torch.testing.assert_close(gp.cpu(), cgp, rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(gg.cpu(), cgg, rtol=1e-5, atol=1e-9)
    with torch.no_grad():
        before = LAUNCHES[nnsqdist.KERNEL_MIN]
        chamfer.chamfer_loss(preds, gts)  # "auto" on CUDA: the kernel, min only
        chamfer.min_sqdist_to(preds, gts)
        assert LAUNCHES[nnsqdist.KERNEL_MIN] == before + 3


@pytest.mark.parametrize("N,grad", [(16384, True), (20000, False)])
def test_large_cloud_chamfer_loss_on_cuda(cuda, N, grad):
    """``chamfer_loss`` with its default dispatch on one large cloud (the
    JAX bench's ``chamfer_large``): forward and gradient at 1x16384x16384
    (two argmin sweeps), forward alone at 1x20000x20000 (two min sweeps);
    the loss bitwise the plain minima's, the gradient finite."""
    preds, gts = (t.to(cuda) for t in _clouds(N + 1, 1, N, N))
    p = preds.clone().requires_grad_(grad)
    LAUNCHES.clear()
    l1, l2 = chamfer.chamfer_loss(p, gts)
    loss = torch.mean(l1 + l2)
    if grad:
        loss.backward()
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {nnsqdist.KERNEL_ARGMIN if grad else nnsqdist.KERNEL_MIN: 2}
    want = torch.mean(torch.mean(nnsqdist.nn_dir_plain(preds, gts)[0], 1)
                      + torch.mean(nnsqdist.nn_dir_plain(gts, preds)[0], 1))
    assert torch.equal(loss.detach(), want)
    assert not grad or torch.isfinite(p.grad).all()


def _gt_batch(B, S, seed):
    rng = np.random.default_rng(seed)
    return {
        "images": rng.integers(0, 256, (B, S, S, 3)).astype(np.float32) / 255.0 - 0.5,
        "sides": rng.integers(0, 2, (B,)).astype(np.int32),
        "joints3d": rng.normal(0, 30, (B, 21, 3)).astype(np.float32),
        "verts3d": rng.normal(0, 30, (B, 778, 3)).astype(np.float32),
        "objpoints3d": rng.normal(0, 50, (B, 600, 3)).astype(np.float32),
    }


def test_train_step_on_cuda_matches_cpu_port(cuda):
    """One contact-config train step on the card: the kernels each launch
    as the path says (K1 once; two argmin sweeps for each of the two atlas
    Chamfer calls and the contact block; one min-only sweep for
    min_sqdist_to), and its gradients agree with the CPU port's, whose
    Chamfer route is the dense plane: each tensor to 1e-2 of its largest
    entry (a near-tie may pick another neighbour)."""
    batch = _gt_batch(2, 64, 0)

    def state_on(device):
        net = init_weights(build_handnet(CONTACT, synthetic_mano_assets("right"),
                                         synthetic_mano_assets("left"), device="cpu"),
                           seed=0).to(device)
        cfg = TrainConfig(optimizer="sgd", lr=0.0, momentum=0.0)
        opt = train.make_optimizer(cfg, net)
        step = train.make_train_step(net, opt, BatchSpec(), device=device)
        return net, step, train.create_train_state(net, opt, cfg)

    gnet, gstep, gstate = state_on(cuda)
    LAUNCHES.clear()
    _, glosses = gstep(gstate, batch)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == TRAIN_LAUNCHES
    assert all(torch.isfinite(v).all() for v in glosses.values())
    cnet, cstep, cstate = state_on("cpu")
    _, closses = cstep(cstate, batch)
    torch.testing.assert_close(glosses["total_loss"].cpu(), closses["total_loss"],
                               rtol=1e-4, atol=0)
    cgrads = dict(cnet.named_parameters())
    for name, p in gnet.named_parameters():
        want = cgrads[name].grad
        scale = float(want.abs().max())
        torch.testing.assert_close(p.grad.cpu(), want, rtol=0, atol=1e-2 * scale + 1e-12,
                                   msg=name)


def test_unfrozen_bn_train_step_on_cuda_matches_cpu_port(cuda):
    """One contact-config train step with unfrozen BN on the card: the
    same launches as the frozen step, the net back in ``eval()``, and its
    gradients and updated running statistics held against the CPU port run
    in float64. Train-mode BN over 16 values a channel makes single tensors
    ill-conditioned (here the card's float32 moved a layer3 conv's gradient
    by 7.1e-2 of its largest entry, the CPU's float32 by 2.2e-3), so: the
    whole gradient within 1e-2 in relative L2, each tensor within 1e-1 of
    its largest entry, each running statistic within 1e-2. The decoder's
    conv biases that feed a BN have an exact gradient of 0: under 1e-4 of
    their weight's."""
    batch = _gt_batch(4, 64, 1)
    zero_grad = ("atlas_branch.decoder.conv1.bias", "atlas_branch.decoder.conv2.bias",
                 "atlas_branch.decoder.conv3.bias")

    def run(device, dtype=torch.float32):
        net = init_weights(build_handnet(CONTACT, synthetic_mano_assets("right"),
                                         synthetic_mano_assets("left"), device="cpu"),
                           seed=0).to(device, dtype)
        cfg = TrainConfig(optimizer="sgd", lr=0.0, momentum=0.0)
        opt = train.make_optimizer(cfg, net)
        step = train.make_train_step(net, opt, BatchSpec(), train_bn=True, device=device)
        b = {k: v.astype(np.float64) if dtype == torch.float64 and v.dtype == np.float32
             else v for k, v in batch.items()}
        LAUNCHES.clear()
        _, losses = step(train.create_train_state(net, opt, cfg), b)
        launches = dict(LAUNCHES)
        assert not net.training and all(torch.isfinite(v).all() for v in losses.values())
        grads = {n: p.grad.cpu().double() for n, p in net.named_parameters()}
        stats = {k: v.cpu().double() for k, v in net.state_dict().items() if "running_" in k}
        return launches, grads, stats

    glaunch, ggrads, gstats = run(cuda)
    assert glaunch == UNFOLDED_TRAIN_LAUNCHES
    _, rgrads, rstats = run("cpu", torch.float64)
    for name in zero_grad:
        layer = float(rgrads[name.replace(".bias", ".weight")].abs().max())
        assert float(ggrads[name].abs().max()) <= 1e-4 * layer, name
    names = [n for n in rgrads if n not in zero_grad]
    num = sum(float(((ggrads[n] - rgrads[n]) ** 2).sum()) for n in names)
    assert (num / sum(float((rgrads[n] ** 2).sum()) for n in names)) ** 0.5 <= 1e-2
    for name in names:
        ref = rgrads[name]
        assert float((ggrads[name] - ref).abs().max()) <= 1e-1 * float(ref.abs().max()), name
    for name, ref in rstats.items():
        assert float((gstats[name] - ref).abs().max()) <= 1e-2 * float(ref.abs().max()), name


@pytest.mark.parametrize("train_bn", [False, True], ids=["frozen", "unfrozen"])
def test_train_step_at_full_width(cuda, train_bn):
    """The contact-config Adam step (lr 1e-4) at B=256 on 256x256 frames:
    the launches of ``TRAIN_LAUNCHES`` a step (``UNFOLDED_TRAIN_LAUNCHES``
    with unfrozen BN), the loss names, finite losses and a total loss that
    falls over 10 steps; with unfrozen BN the net back in ``eval()`` and
    every running statistic moved and finite."""
    net = _seeded(CONTACT, cuda)
    cfg = TrainConfig()
    opt = train.make_optimizer(cfg, net)
    state = train.create_train_state(net, opt, cfg)
    step = train.make_train_step(net, opt, BatchSpec(), train_bn=train_bn, device=cuda)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in _gt_batch(256, 256, 1).items()}
    stats = {k: v.clone() for k, v in net.state_dict().items() if "running_" in k}
    LAUNCHES.clear()
    state, losses = step(state, batch)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == (UNFOLDED_TRAIN_LAUNCHES if train_bn else TRAIN_LAUNCHES)
    assert set(losses) == TRAIN_LOSS_KEYS
    assert all(torch.isfinite(v).all() for v in losses.values())
    first = float(losses["total_loss"])
    for _ in range(9):
        state, losses = step(state, batch)
    assert float(losses["total_loss"]) < first
    if train_bn:
        after = net.state_dict()
        assert not net.training and stats
        for k, v in stats.items():
            assert not torch.equal(after[k], v) and torch.isfinite(after[k]).all(), k


def _loop_state(device, B_steps=2, B=8):
    from obman_train_tpu_torch.data import factory, loader

    ds = factory.get_dataset("synthetic", "train", meta={"size": B * B_steps, "img_res": 64},
                             inp_res=64, device_augment=True)
    train_loader = loader.BatchLoader(ds, batch_size=B, seed=0, num_workers=2)
    net = init_weights(build_handnet(CONTACT, synthetic_mano_assets("right"),
                                     synthetic_mano_assets("left"), device="cpu"),
                       seed=0).to(device)
    cfg = TrainConfig()
    opt = train.make_optimizer(cfg, net)
    return train_loader, train.create_train_state(net, opt, cfg, steps_per_epoch=B_steps)


def test_training_loop_on_cuda_launches_the_kernels(cuda):
    """Two contact-config train steps at B=8 through ``train.loop.epoch_pass``
    with device-side jitter: each step launches K1 once, the argmin sweep 6
    times, the min sweep once and the folded encoder's ``relu_bias_grad``
    17 times, inside the loop."""
    from obman_train_tpu_torch.train.loop import epoch_pass

    train_loader, state = _loop_state(cuda)
    LAUNCHES.clear()
    state, meters, pck = epoch_pass(train_loader, state, 0, train=True)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {k: 2 * n for k, n in TRAIN_LAUNCHES.items()}
    assert state.step == 2
    losses = meters.averages()
    assert np.isfinite(losses["total_loss"]) and "contact_loss" in losses
    assert 0 <= pck["auc"] <= 1


def test_traineval_cli_on_cuda(cuda, tmp_path, monkeypatch):
    """``cli.traineval`` on the card (no OBMAN_PLATFORM): a train epoch, a
    resumed evaluation whose val metrics equal the logged ones."""
    from obman_train_tpu_torch.cli import traineval
    from obman_train_tpu_torch.utils.logging import parse_log_line

    monkeypatch.delenv("OBMAN_PLATFORM", raising=False)
    exp = str(tmp_path / "run")
    argv = ["--train_datasets", "synthetic", "--val_datasets", "synthetic",
            "--mano_assets", "synthetic", "--synthetic_size", "16", "--image_size", "64",
            "--train_batch", "8", "--test_batch", "8", "--workers", "2", "--display_freq",
            "0", "--contact_lambda", "0.167", "--collision_lambda", "0.167",
            "--atlas_predict_trans", "--atlas_predict_scale", "--exp_id", exp]
    state, _ = traineval.main(argv + ["--epochs", "1", "--device_augment"])
    assert next(state.net.parameters()).is_cuda and state.step == 2
    with open(f"{exp}/logs/val.txt") as f:
        logged = parse_log_line(f.readlines()[-1])[1]
    _, val = traineval.main(argv + ["--evaluate", "--resume", exp])
    for k in ("total_loss", "auc", "epe_mean"):
        assert abs(val[k] - logged[k]) <= 1e-5 * max(1.0, abs(logged[k])), k


def _demo_config(size=64):
    from obman_train_tpu_torch.config import ExperimentConfig

    return ExperimentConfig(mano_assets="synthetic",
                            model=CONTACT.replace(image_size=size))


def test_demo_model_on_cuda_matches_cpu_port_without_kernels(cuda):
    """DemoModel (contact config, seeded weights) on the card against the
    CPU port, TF32 off: the same keys, values to the slice test's bounds,
    and not one kernel launch on the demo path."""
    from obman_train_tpu_torch.demo import DemoModel

    frame = np.random.default_rng(0).integers(0, 256, (96, 128, 3)).astype(np.uint8)
    gpu_model = DemoModel(config=_demo_config(), device=cuda)
    LAUNCHES.clear()
    gpu = gpu_model.predict_dual(frame)
    single = gpu_model.predict(frame, hand_side="right", flip=True)
    attention = gpu_model.attention_maps(frame[None])
    torch.cuda.synchronize()
    assert sum(LAUNCHES.values()) == 0, dict(LAUNCHES)
    cpu_model = DemoModel(config=_demo_config(), device="cpu")
    cpu = cpu_model.predict_dual(frame)
    assert sorted(gpu) == sorted(cpu) == ["joints", "objpoints3d", "objscale", "objtrans",
                                          "verts"]
    for key, atol in (("verts", 1e-2), ("joints", 1e-2), ("objpoints3d", 2e-2),
                      ("objtrans", 2e-2), ("objscale", 1e-4)):
        np.testing.assert_allclose(gpu[key], cpu[key], rtol=0, atol=atol, err_msg=key)
    np.testing.assert_allclose(single["verts"][0], cpu_model.predict(
        frame, hand_side="right", flip=True)["verts"][0], rtol=0, atol=1e-2)
    np.testing.assert_allclose(attention, cpu_model.attention_maps(frame[None]),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("H,W,size", [(480, 640, 256), (100, 140, 64), (48, 64, 128)])
def test_preprocessing_on_cuda_matches_cpu(cuda, H, W, size):
    from obman_train_tpu_torch.ops import image

    rng = np.random.default_rng(H)
    frames = torch.from_numpy(rng.integers(0, 256, (3, H, W, 3)).astype(np.uint8))
    flip = torch.tensor([True, False, True])
    cpu = image.preprocess_frames(frames.to(torch.float32), size, flip=flip, bgr=True)
    gpu = image.preprocess_frames(frames.to(cuda).to(torch.float32), size, flip=flip.to(cuda),
                                  bgr=True)
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=0, atol=1e-5)
    imgs = torch.from_numpy(rng.random((2, 80, 72, 3)).astype(np.float32))
    aff = torch.tensor([[[0.8, 0.2, -5.0], [-0.2, 0.8, 3.0], [0, 0, 1]]] * 2,
                       dtype=torch.float32)
    torch.testing.assert_close(image.affine_warp(imgs.to(cuda), aff.to(cuda), 64).cpu(),
                               image.affine_warp(imgs, aff, 64), rtol=0, atol=1e-4)


def test_export_round_trip_on_cuda(cuda, tmp_path):
    """A symbolic-batch artifact for cuda and cpu: the cuda program serves
    batches of 1 and 3 on the card like the live model (rtol 1e-5, atol
    2e-3), the cpu program serves CPU inputs, and no kernel launches."""
    from obman_train_tpu_torch.demo import DemoModel
    from obman_train_tpu_torch.demo.export import ExportedModel, export_model, load_exported

    model = DemoModel(config=_demo_config(), device=cuda)
    path = str(tmp_path / "model.pt2")
    info = export_model(model, path, platforms=["gpu", "cpu"])
    assert info["platforms"] == ["cuda", "cpu"] and info["batch"] == "symbolic"
    serve = load_exported(path)
    rng = np.random.default_rng(1)
    LAUNCHES.clear()
    for B in (1, 3):
        frames = torch.from_numpy(rng.integers(0, 256, (B, 64, 64, 3)).astype(np.uint8))
        sides = torch.from_numpy((np.arange(B) % 2).astype(np.int32))
        flip = torch.from_numpy(np.arange(B) % 2 == 0)
        live = model._infer(model._variables, frames.to(cuda), sides.to(cuda), flip.to(cuda))
        out = serve(frames.to(cuda), sides.to(cuda), flip.to(cuda))
        assert sorted(out) == sorted(live) and out["verts"].is_cuda
        for k in live:
            torch.testing.assert_close(out[k], live[k], rtol=1e-5, atol=2e-3, msg=k)
        on_cpu = serve(frames, sides, flip)
        assert on_cpu["verts"].device.type == "cpu"
    torch.cuda.synchronize()
    assert sum(LAUNCHES.values()) == 0
    frame = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    served = ExportedModel(path)
    assert served.device.type == "cuda"
    np.testing.assert_allclose(served.predict_dual(frame)["verts"],
                               model.predict_dual(frame)["verts"], rtol=1e-5, atol=2e-3)


# --- the precision rungs (bf16 compute_dtype, geometry_dtype planes) ---

CONTACT_BF16 = ModelConfig(atlas=CONTACT.atlas, contact=CONTACT.contact,
                           compute_dtype="bfloat16")


def _rel(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float((a - b).norm() / b.norm())


def _seeded(cfg, device):
    net = build_handnet(cfg, synthetic_mano_assets("right"), synthetic_mano_assets("left"),
                        device="cpu")
    return init_weights(net, seed=0).to(device)


def test_bf16_forward_on_cuda_is_as_close_to_float32_as_the_cpu_port(cuda):
    """The bf16 contact forward on the card: JAX's output dtypes, K1 once
    and two argmin sweeps; its distance from the float32 forward (relative
    L2) no more than 3x the CPU port's bf16 distance on the same input (two
    bf16 programs round differently; tests/test_torch_bf16.py holds the CPU
    port to JAX's)."""
    gen = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 256, (4, 64, 64, 3), generator=gen, dtype=torch.uint8)
    sides = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    LAUNCHES.clear()
    gpu = make_infer(_seeded(CONTACT_BF16, cuda))(frames, sides)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {raytri.KERNEL: 1, nnsqdist.KERNEL_ARGMIN: 2}
    assert gpu["verts"].dtype == torch.float32 and gpu["objpoints3d"].dtype == torch.bfloat16
    cpu16 = make_infer(_seeded(CONTACT_BF16, "cpu"))(frames, sides)
    cpu32 = make_infer(_seeded(CONTACT, "cpu"))(frames, sides)
    for key in ("verts", "joints", "objpoints3d"):
        assert _rel(gpu[key].cpu(), cpu32[key]) <= 3 * _rel(cpu16[key], cpu32[key]), key


def test_bf16_train_step_on_cuda(cuda):
    """One bf16 step on the card, frozen and unfrozen BN: the launches of
    an unfolded step, float32 gradients whose distance from the CPU port's
    float32 ones is no more than 3x the CPU port's bf16 distance, and
    float32 running statistics that move in train mode."""
    batch = _gt_batch(2, 64, 0)

    def grads(cfg, device, train_bn=False):
        net = _seeded(cfg, device)
        opt = train.make_optimizer(TrainConfig(optimizer="sgd", lr=0.0, momentum=0.0), net)
        state = train.create_train_state(net, opt, TrainConfig())
        step = train.make_train_step(net, opt, BatchSpec(), train_bn=train_bn, device=device)
        LAUNCHES.clear()
        _, losses = step(state, batch)
        if device != "cpu":
            torch.cuda.synchronize()
        g = {n: p.grad.cpu() for n, p in net.named_parameters()}
        return net, losses, torch.cat([g[n].flatten() for n in sorted(g)]), dict(LAUNCHES)

    _, _, g32, _ = grads(CONTACT, "cpu")
    _, _, g16, _ = grads(CONTACT_BF16, "cpu")
    net, losses, gg, launches = grads(CONTACT_BF16, cuda)
    assert launches == UNFOLDED_TRAIN_LAUNCHES
    assert gg.dtype == torch.float32 and torch.isfinite(losses["total_loss"])
    assert _rel(gg, g32) <= 3 * _rel(g16, g32)
    before = net.base_net.bn1.running_var.clone()
    net, losses, gu, _ = grads(CONTACT_BF16, cuda, train_bn=True)
    assert torch.isfinite(gu).all() and torch.isfinite(losses["total_loss"])
    stats = net.base_net.bn1.running_var
    assert stats.dtype == torch.float32 and not torch.equal(stats, before.to(stats.device))


@pytest.mark.parametrize("contact", [False, True], ids=["hand_object_bf16", "contact_bf16"])
def test_bf16_forward_at_full_width(cuda, contact):
    """The bf16 rungs' forward through ``make_infer`` at B=256 on 256x256
    frames: no kernel (hand_object_bf16), or K1 once and two argmin sweeps
    (contact_bf16); JAX's output dtypes; finite outputs."""
    cfg = (CONTACT_BF16 if contact
           else ModelConfig(atlas=CONTACT.atlas, compute_dtype="bfloat16"))
    frames, sides = _frames(256, 256, 1, cuda)
    LAUNCHES.clear()
    got = make_infer(_seeded(cfg, cuda))(frames, sides)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == ({raytri.KERNEL: 1, nnsqdist.KERNEL_ARGMIN: 2} if contact else {})
    assert got["verts"].dtype == torch.float32 and got["objpoints3d"].dtype == torch.bfloat16
    assert all(torch.isfinite(got[k]).all() for k in ("verts", "joints", "objpoints3d"))


# the bf16 step's first loss and gradients against the card's float32 step
# on the same weights and batch (TF32 off): about twice the whole-gradient
# gap (relative L2) and three times the loss gap between JAX's own bf16 and
# float32 steps that tests/test_torch_bf16.py computes at B=2, 64 px
BF16_GRAD_REL = 0.15
BF16_LOSS_REL = 1e-2


def _first_step(net, batch):
    net.zero_grad(set_to_none=True)
    total, _, _ = net(batch, BatchSpec())
    total.backward()
    return float(total.detach()), {n: p.grad.detach().clone()
                                   for n, p in net.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("geometry_dtype", ["float32", "float32_select", "bfloat16"],
                         ids=["contact_bf16", "contact_bf16_f32sel", "contact_bf16_bf16sel"])
def test_bf16_rungs_train_at_full_width(cuda, geometry_dtype):
    """The bf16 rungs' train step at B=256 on 256x256 frames (Adam, frozen
    BN): the first step's loss and gradients within ``BF16_LOSS_REL`` and
    ``BF16_GRAD_REL`` of the float32 step's, ``UNFOLDED_TRAIN_LAUNCHES`` a step, a
    total loss that falls over 10 steps; then one unfrozen-BN step of the
    rung: finite gradients and loss, float32 running statistics, finite,
    that move."""
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in _gt_batch(256, 256, 1).items()}
    loss32, g32 = _first_step(_seeded(CONTACT, cuda), batch)
    cfg = CONTACT_BF16.replace(geometry_dtype=geometry_dtype)
    net = _seeded(cfg, cuda)
    loss16, g16 = _first_step(net, batch)
    assert set(g16) == set(g32)
    names = sorted(g32)
    assert _rel(torch.cat([g16[n].flatten() for n in names]),
                torch.cat([g32[n].flatten() for n in names])) <= BF16_GRAD_REL
    assert abs(loss16 - loss32) <= BF16_LOSS_REL * abs(loss32)
    del g16, g32
    for train_bn in (False, True):
        net = _seeded(cfg, cuda)
        stats = {k: v.clone() for k, v in net.state_dict().items() if "running_" in k}
        tcfg = TrainConfig()
        opt = train.make_optimizer(tcfg, net)
        state = train.create_train_state(net, opt, tcfg)
        step = train.make_train_step(net, opt, BatchSpec(), train_bn=train_bn, device=cuda)
        LAUNCHES.clear()
        state, losses = step(state, batch)
        torch.cuda.synchronize()
        assert dict(LAUNCHES) == UNFOLDED_TRAIN_LAUNCHES
        first = float(losses["total_loss"])
        assert np.isfinite(first)
        if train_bn:
            assert all(torch.isfinite(p.grad).all() for p in net.parameters()
                       if p.grad is not None)
            after = net.state_dict()
            assert all(after[k].dtype == torch.float32 and torch.isfinite(after[k]).all()
                       for k in stats)
            assert any(not torch.equal(after[k], v) for k, v in stats.items())
            continue
        for _ in range(9):
            state, losses = step(state, batch)
        assert float(losses["total_loss"]) < first


@pytest.mark.parametrize("N,M", [(778, 642), (600, 642)])
def test_rung_planes_on_cuda(cuda, N, M):
    """The rungs' planes on the card (``use_kernel=False``): the float32
    selection plane picks the kernel's neighbours except at near-ties
    (within 2^-20 of the plane's magnitude), the bf16 plane the CPU
    port's except within the bf16 resolution bound (2^-8, JAX's); values
    are the exact distances of the pairs picked."""
    x, y = (t.to(cuda) for t in _clouds(N + M, 256, N, M))
    mag = float((x.double() ** 2).sum(-1).max() + (y.double() ** 2).sum(-1).max())
    kern = chamfer.chamfer_min_sqdist(x, y, use_kernel=True)
    for dt, bound in ((torch.float32, 2.0 ** -20), (torch.bfloat16, 2.0 ** -8)):
        sel = chamfer.chamfer_min_sqdist(x, y, use_kernel=False, plane_dtype=dt)
        ref = kern if dt == torch.float32 else [
            t.to(cuda) for t in chamfer.chamfer_min_sqdist(x.cpu(), y.cpu(), use_kernel=False,
                                                           plane_dtype=dt)]
        for i, (q, s) in ((1, (x, y)), (3, (y, x))):
            exact = lambda a: ((q.double() - torch.gather(  # noqa: E731
                s.double(), 1, a[..., None].expand(-1, -1, 3))) ** 2).sum(-1)
            differ = sel[i] != ref[i]
            gap = (exact(sel[i]) - exact(ref[i])).abs()[differ]
            assert gap.numel() == 0 or float(gap.max()) <= bound * mag, (dt, int(differ.sum()))
            torch.testing.assert_close(sel[i - 1].double(), exact(sel[i]), rtol=1e-5, atol=1e-3)


def _hand_scenes(B, seed):
    """Hands (B, 778, 3) of the synthetic MANO model at seeded poses (mm),
    icosphere-3 objects (B, 642, 3) placed on a hand vertex, their faces."""
    from obman_train_tpu_torch.models.mano import ManoLayer, mano_forward

    rng = np.random.default_rng(seed)
    layer = ManoLayer(synthetic_mano_assets("right"))
    pose = torch.from_numpy(rng.normal(0, 0.5, (B, 9)).astype(np.float32))
    with torch.no_grad():
        hands = mano_forward(layer, pose)[0].numpy()
    verts, faces = icosphere(3)
    centres = hands[np.arange(B), rng.integers(0, 778, B)] + rng.normal(0, 15, (B, 3))
    objs = verts[None] * rng.uniform(20, 45, (B, 1, 1)) + centres[:, None]
    return hands, objs.astype(np.float32), faces.astype(np.int32)


def test_penetration_depths_on_cuda_equal_plain(cuda):
    """A saved batch's depths at B=256: one K1 launch and one min-only
    sweep, equal bit for bit to the plain route on the card. Against the
    CPU port, whose nearest neighbours come from the dense float32 plane
    ``|x|^2 + |y|^2 - 2 x.y``, the squared depths agree within 4 float32
    ulps of the plane's magnitude (measured on the CPU with the plain
    route in the kernel's place: at most 0.96 of one)."""
    from obman_train_tpu_torch.simulation.savemano import max_penetration_depths

    hands, objs, faces = _hand_scenes(256, seed=0)
    LAUNCHES.clear()
    got = max_penetration_depths(hands, objs, faces, device=cuda)
    assert LAUNCHES[raytri.KERNEL] == 1 and LAUNCHES[nnsqdist.KERNEL_MIN] == 1
    assert sum(LAUNCHES.values()) == 2
    hv, ov = torch.from_numpy(hands).to(cuda), torch.from_numpy(objs).to(cuda)
    exterior = raytri.mesh_contains_points_plain(hv, ov[:, torch.from_numpy(faces).long()])
    min_sq = nnsqdist.nn_dir_plain(hv, ov)[0]
    want = (np.sqrt(np.maximum(min_sq.cpu().numpy(), 0))
            * ~exterior.cpu().numpy()).max(axis=1)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 128  # most scenes overlap
    cpu = max_penetration_depths(hands, objs, faces, device="cpu").astype(np.float64)
    scale = (hands**2).sum(-1).max(1) + (objs**2).sum(-1).max(1)
    gap = np.abs(got.astype(np.float64) ** 2 - cpu**2)
    assert (gap <= 4 * np.finfo(np.float32).eps * scale).all()


def test_voxel_occupancy_on_cuda_equals_plain(cuda):
    """``intersect_vox``'s occupancy on a 5 mm voxel grid around a hand (one
    launch for the whole grid) against the plain inside test, and the
    volumes against the CPU port's."""
    from obman_train_tpu_torch.simulation import intersect
    from obman_train_tpu_torch.simulation.savemano import _hand_faces

    hands, objs, faces = _hand_scenes(4, seed=1)
    for hand, obj in zip(hands.astype(np.float64) * 0.001, objs.astype(np.float64) * 0.001):
        grid = intersect.voxel_grid(hand, hand, 0.005)
        before = LAUNCHES[raytri.KERNEL]
        got = intersect._occupancy(grid, hand, _hand_faces(), cuda)
        assert LAUNCHES[raytri.KERNEL] == before + 1
        pts = torch.from_numpy(grid.astype(np.float32)).to(cuda)[None]
        tri = torch.from_numpy(hand.astype(np.float32)).to(cuda)[
            torch.from_numpy(_hand_faces()).long().to(cuda)][None]
        want = ~raytri.mesh_contains_points_plain(pts, tri)[0].cpu().numpy()
        np.testing.assert_array_equal(got, want)
        assert got.any() and len(grid) > 10000
        vol = intersect.intersect_vox(hand, _hand_faces(), obj, faces, device=cuda)
        assert vol == intersect.intersect_vox(hand, _hand_faces(), obj, faces, device="cpu")


def test_simulate_cli_on_cuda(cuda, tmp_path, monkeypatch):
    """``cli.simulate --intersect`` on the card: the stepper on the host,
    the depths and voxels on the device, the CPU port's summaries."""
    import json
    import pickle

    from obman_train_tpu_torch.cli import simulate
    from obman_train_tpu_torch.simulation import intersect
    from obman_train_tpu_torch.simulation import simulate as sim

    hands, objs, _ = _hand_scenes(4, seed=2)
    with open(tmp_path / "batch_000000.pkl", "wb") as f:
        pickle.dump({"batch": {}, "root": "wrist",
                     "results": {"verts": hands, "objpoints3d": objs}}, f)
    monkeypatch.delenv("OBMAN_PLATFORM", raising=False)
    got = simulate.main(["--exp_id", str(tmp_path), "--intersect", "--workers", "4"])
    with open(tmp_path / "intersect_results" / "results.json") as f:
        got_vol = json.load(f)
    want = sim.full_simul(str(tmp_path), workers=1, device="cpu")
    assert got["backend"] == "native" and got["sample_nb"] == 4
    assert got["mean_dist"] == want["mean_dist"]
    # the mean depth, kernel against the CPU's plane: 4 plane ulps at a
    # 1 mm depth are ~1e-2 mm (see the test above)
    np.testing.assert_allclose(got["max_depths"], want["max_depths"], rtol=0, atol=1e-2)
    assert got_vol == intersect.full_intersect(str(tmp_path), device="cpu")


def _grid_clouds(seed, B, N, M):
    """Clouds on a 1/64 mm grid in a 25 mm cube: every square, product and
    sum of the plane is a multiple of 2**-12 under 2**12, exact in float32,
    so both routes see the same minima bit for bit."""
    rng = np.random.default_rng(seed)
    p1, p2 = (np.round(rng.uniform(-12.5, 12.5, (B, n, 3)) * 64) / 64 for n in (N, M))
    return torch.from_numpy(p1.astype(np.float32)), torch.from_numpy(p2.astype(np.float32))


def _naive_routes(p1, p2, dev):
    """``compute_naive_contact_loss`` forward and backward on the card,
    kernel route (counted) and plane route: ``{route: (loss, g1, g2)}``
    and the kernel route's launches."""
    from obman_train_tpu_torch.ops import compute_naive_contact_loss

    out, launches = {}, None
    for route, uk in (("kernel", "auto"), ("plane", False)):
        a = p1.to(dev).requires_grad_(True)
        b = p2.to(dev).requires_grad_(True)
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        loss = compute_naive_contact_loss(a, b, use_kernel=uk)
        loss.backward()
        torch.cuda.synchronize()
        counted = {k: v - before.get(k, 0) for k, v in LAUNCHES.items() if v != before.get(k, 0)}
        if route == "kernel":
            launches = counted
        else:
            assert counted == {}
        out[route] = (loss.detach().cpu(), a.grad.cpu(), b.grad.cpu())
    return out, launches


def test_naive_contact_loss_kernel_route_on_cuda(cuda):
    """On CUDA tensors ``"auto"`` is the kernel route: one argmin sweep each
    way a forward (two ``nn_dir<true>`` launches), none in the backward,
    no K1; it agrees with the plane route (loss 1e-6 relative, gradients
    1e-6 of each tensor's largest entry: the backward's ``index_add_`` is
    atomic) where no minimum ties."""
    from obman_train_tpu_torch.ops.chamfer import batch_pairwise_sqdist

    p1, p2 = _grid_clouds(0, 4, 64, 48)
    d = batch_pairwise_sqdist(p1, p2)
    for dim in (1, 2):  # no exact tie: the routes select alike
        assert ((d == d.amin(dim, keepdim=True)).sum(dim) == 1).all()
    out, launches = _naive_routes(p1, p2, cuda)
    assert launches == {nnsqdist.KERNEL_ARGMIN: 2}
    (kl, k1, k2), (pl, q1, q2) = out["kernel"], out["plane"]
    torch.testing.assert_close(kl, pl, rtol=1e-6, atol=0)
    for g, w in ((k1, q1), (k2, q2)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6 * float(w.abs().max()))


def test_naive_contact_loss_tie_goes_to_the_first_copy_on_cuda(cuda):
    """A duplicated ``points_2`` point nearest to ``points_1[:, 0]``: the
    kernel route's argmin VJP gives that minimum's gradient to the first
    copy, the plane route (``torch.amin``, as ``jnp.min``) splits it
    evenly; the two copies' sum and every other row agree."""
    p1, p2 = _grid_clouds(4, 2, 16, 8)
    p2[:, 5] = p2[:, 2]
    p1[:, 0] = p2[:, 2] + 0.5
    out, _ = _naive_routes(p1, p2, cuda)
    (kl, k1, k2), (pl, q1, q2) = out["kernel"], out["plane"]
    torch.testing.assert_close(kl, pl, rtol=1e-6, atol=0)
    tol = dict(rtol=0, atol=1e-6 * float(q2.abs().max()))
    own = k2[:, 5]  # the copy's own terms, the same for both copies
    torch.testing.assert_close(q2[:, 2], q2[:, 5], **tol)
    torch.testing.assert_close(k2[:, 2] - own, 2 * (q2[:, 2] - own), **tol)
    assert float((k2[:, 2] - own).abs().max()) > 100 * tol["atol"]
    torch.testing.assert_close(k2[:, 2] + k2[:, 5], q2[:, 2] + q2[:, 5], **tol)
    keep = [j for j in range(p2.shape[1]) if j not in (2, 5)]
    torch.testing.assert_close(k2[:, keep], q2[:, keep], **tol)
    torch.testing.assert_close(k1, q1, rtol=0, atol=1e-6 * float(q1.abs().max()))


def test_rotmat_to_axis_angle_on_cuda(cuda):
    """``rotmat_to_axis_angle`` on the card on 256 x 16 rotations from
    ``rodrigues`` (angles under 3 rad): no kernel launched, within 1e-5 of
    the CPU port, the round trip within 1e-4."""
    from obman_train_tpu_torch.ops import rodrigues, rotmat_to_axis_angle

    rng = np.random.default_rng(21)
    axes = rng.normal(0, 1, (256, 16, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    aa = torch.from_numpy((axes * rng.uniform(0, 3.0, (256, 16, 1))).astype(np.float32))
    rot = rodrigues(aa.to(cuda))
    LAUNCHES.clear()
    got = rotmat_to_axis_angle(rot)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {} and torch.isfinite(got).all()
    assert float((got.cpu() - rotmat_to_axis_angle(rot.cpu())).abs().max()) <= 1e-5
    assert float((got.cpu() - aa).abs().max()) <= 1e-4
