"""Tests of the port that need an NVIDIA GPU (the CUDA kernels have no CPU
mode). They skip without one. This file imports no JAX, so it also runs on
a machine without it, where tests/conftest.py (which imports JAX) must be
left out:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from obman_train_tpu_torch.assets import icosphere, synthetic_mano_assets
from obman_train_tpu_torch.config import AtlasConfig, ContactConfig, ModelConfig
from obman_train_tpu_torch.infer import make_infer
from obman_train_tpu_torch.models import build_handnet
from obman_train_tpu_torch.ops import compute_contact_loss, raytri
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
