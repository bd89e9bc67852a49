"""Tests of the port that need an NVIDIA GPU (the CUDA kernels have no CPU
mode). They skip without one. This file imports no JAX, so it also runs on
a machine without it, where tests/conftest.py (which imports JAX) must be
left out:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from obman_train_tpu_torch import train
from obman_train_tpu_torch.assets import icosphere, synthetic_mano_assets
from obman_train_tpu_torch.config import AtlasConfig, ContactConfig, ModelConfig, TrainConfig
from obman_train_tpu_torch.infer import make_infer
from obman_train_tpu_torch.models import BatchSpec, build_handnet
from obman_train_tpu_torch.ops import chamfer, compute_contact_loss, nnsqdist, raytri
from obman_train_tpu_torch.ops.kernels import LAUNCHES
from obman_train_tpu_torch.weights import init_weights

pytestmark = pytest.mark.cuda

CONTACT = ModelConfig(
    atlas=AtlasConfig(predict_trans=True, predict_scale=True),
    contact=ContactConfig(contact_lambda=0.167, collision_lambda=0.167),
)


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


@pytest.mark.parametrize("B,P,n_tris", [(8, 778, None), (3, 100, 77), (1, 1, 1)])
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


def test_chamfer_loss_kernel_route_grads(cuda):
    """Kernel route on the card against the same VJP on the plain minima
    (index_add_ on CUDA is atomic, so the last bits may differ: rtol 1e-5,
    atol 1e-9), and against the kernel route on the CPU."""
    preds, gts = (t.to(cuda) for t in _clouds(1, 4, 600, 642))

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
                                        torch.full_like(min_g2p, 1 / (4 * 642)),
                                        torch.full_like(min_p2g, 1 / (4 * 600)))
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
    assert dict(LAUNCHES) == {raytri.KERNEL: 1, nnsqdist.KERNEL_ARGMIN: 6,
                              nnsqdist.KERNEL_MIN: 1}
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
