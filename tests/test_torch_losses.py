"""The port's loss path against the JAX package on the CPU: ``ops/mesh.py``,
``assets/laplacian.py``, ``models/losses.py`` and HandNet with
``no_loss=False``.

- Functions: the same seeded numpy inputs through both packages, float32,
  values and gradients to rtol 1e-5 / atol 1e-6 (the Chamfer minima on the
  plane route to atol 1e-3 mm^2, see test_torch_chamfer.py); and in
  float64 against the executed-reference goldens
  (tests/goldens/reference_goldens.npz) where they hold the same
  quantities, to the tolerances the JAX package's own golden tests use.
- HandNet: the contact config (bench.py:110-116), ResNet-18, B=2, 64 px
  float frames, full ``BatchSpec()`` with the synthetic GT of
  bench.py:166-184, on the same weights: every loss key and the total to
  rtol 1e-4 (the encoders' float32 convolutions round differently; MANO
  verts agree to ~1e-4 mm).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obman_train_tpu.assets.icosphere import icosphere as jax_icosphere
from obman_train_tpu.assets.laplacian import cotangent_laplacian as jax_laplacian
from obman_train_tpu.config import AtlasConfig as JAtlas
from obman_train_tpu.config import ManoConfig as JMano
from obman_train_tpu.models import BatchSpec as JSpec
from obman_train_tpu.models import losses as jlosses
from obman_train_tpu.ops import mesh as jmesh
from obman_train_tpu_torch import config as tcfg
from obman_train_tpu_torch.assets import icosphere, synthetic_mano_assets
from obman_train_tpu_torch.assets.laplacian import cotangent_laplacian
from obman_train_tpu_torch.models import BatchSpec, build_handnet, losses
from obman_train_tpu_torch.ops import mesh
from tests.test_torch_handnet import CONTACT, _configs, _randomize_stats

torch.set_num_threads(2)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "reference_goldens.npz")


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDENS)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _faces():
    return np.asarray(icosphere(3)[1])


def test_cotangent_laplacian_matches_jax_and_goldens(g):
    v, f = icosphere(3)
    jv, jf = jax_icosphere(3)
    np.testing.assert_array_equal(cotangent_laplacian(v, f), jax_laplacian(jv, jf))
    L = cotangent_laplacian(g["ico_verts"], g["ico_faces"].astype(np.int32))
    np.testing.assert_allclose(L, g["lap_L_dense"], rtol=1e-6, atol=1e-9)


def test_edge_and_laplacian_loss_values_and_grads():
    rng = np.random.default_rng(0)
    verts = rng.normal(0, 50, (2, 642, 3)).astype(np.float32)
    faces = _faces()
    L = cotangent_laplacian(*icosphere(3))

    for port_fn, jax_fn, arg in (
        (mesh.edge_loss, jmesh.edge_loss, faces),
        (mesh.laplacian_loss, jmesh.laplacian_loss, L),
    ):
        want, jg = jax.value_and_grad(lambda v: jax_fn(v, jnp.asarray(arg)))(jnp.asarray(verts))
        tv = _t(verts, grad=True)
        got = port_fn(tv, torch.from_numpy(np.asarray(arg)))
        got.backward()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


def test_edge_and_laplacian_loss_match_goldens(g):
    el = mesh.edge_loss(_t(g["edge_verts"]), _t(g["ico_faces"]))
    np.testing.assert_allclose(float(el), g["edge_loss"], rtol=1e-9)
    L = cotangent_laplacian(g["ico_verts"], g["ico_faces"].astype(np.int32))
    # the golden loss passed through the reference's float32 cast
    np.testing.assert_allclose(float(mesh.laplacian_loss(_t(g["lap_verts"]), _t(L))),
                               g["lap_loss"], rtol=1e-5)


def test_meshiou_matches_jax_and_goldens(g):
    rng = np.random.default_rng(1)
    gt = rng.uniform(0, 12, (3, 778)).astype(np.float32)
    pred = rng.uniform(0, 12, (3, 778)).astype(np.float32)
    ji, ja = jmesh.meshiou(jnp.asarray(gt), jnp.asarray(pred))
    ti, ta = mesh.meshiou(_t(gt), _t(pred))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    ti, ta = mesh.meshiou(_t(g["meshiou_gt"]), _t(g["meshiou_pred"]))
    np.testing.assert_allclose(ti.numpy(), g["meshiou_batch_ious"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(ta), g["meshiou_auc"], rtol=1e-6)


def _mano_case(rng, B=3):
    preds = {
        "verts": rng.normal(0, 30, (B, 778, 3)),
        "joints": rng.normal(0, 30, (B, 21, 3)),
        "shape": rng.normal(0, 1, (B, 10)),
        "pose": rng.normal(0, 1, (B, 9)),
    }
    batch = {
        "verts3d": rng.normal(0, 30, (B, 778, 3)),
        "joints3d": rng.normal(0, 30, (B, 21, 3)),
        "hand_pcas": rng.normal(0, 1, (B, 9)),
    }
    return ({k: v.astype(np.float32) for k, v in preds.items()},
            {k: v.astype(np.float32) for k, v in batch.items()})


@pytest.mark.parametrize("lambdas", [
    dict(),
    dict(lambda_pose_reg=0.5, lambda_shape=None, lambda_joints3d=0.0),
])
def test_compute_mano_loss_matches_jax(lambdas):
    preds, batch = _mano_case(np.random.default_rng(2))
    kw = dict(has_verts3d=True, has_joints3d=True, has_pcas=True)
    jt, jl = jlosses.compute_mano_loss(
        {k: jnp.asarray(v) for k, v in preds.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, JMano(**lambdas), **kw)
    tp = {k: _t(v, grad=True) for k, v in preds.items()}
    tt, tl = losses.compute_mano_loss(tp, {k: _t(v) for k, v in batch.items()},
                                      tcfg.ManoConfig(**lambdas), **kw)
    assert list(tl) == list(jl)  # the None-vs-0 rule: same keys, same order
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    tt.backward()
    jg = jax.grad(lambda p: jlosses.compute_mano_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, JMano(**lambdas), **kw)[0])(
        {k: jnp.asarray(v) for k, v in preds.items()})
    for k, v in tp.items():
        want = np.asarray(jg[k])
        got = v.grad.numpy() if v.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9, err_msg=k)


def test_compute_mano_loss_matches_goldens(g):
    lv, lj, ls, lp = (float(x) for x in g["manoloss_lambdas"])
    cfg = tcfg.ManoConfig(lambda_verts=lv, lambda_joints3d=lj, lambda_shape=ls,
                          lambda_pose_reg=lp, lambda_pca=None)
    preds = {k: _t(g[f"manoloss_pred_{k}"]) for k in ("verts", "joints", "shape", "pose")}
    batch = {"verts3d": _t(g["manoloss_gt_verts3d"]),
             "joints3d": _t(g["manoloss_gt_joints3d"])}
    total, tl = losses.compute_mano_loss(preds, batch, cfg, has_verts3d=True,
                                         has_joints3d=True, has_pcas=False)
    np.testing.assert_allclose(float(total), g["manoloss_total"], rtol=1e-6)
    for name in ("mano_verts3d", "mano_joints3d", "mano_shape", "pose_reg"):
        np.testing.assert_allclose(float(tl[name]), g[f"manoloss_{name}"], rtol=1e-9)


ATLAS_FULL = dict(lambda_atlas=0.3, final_lambda_atlas=0.25, trans_weight=0.2,
                  scale_weight=0.15, lambda_regul_edges=0.1, lambda_laplacian=0.05,
                  predict_trans=True, predict_scale=True)
ATLAS_KEYS = ("objpointscentered3d", "objtrans", "objscale", "objpoints3d")


def _atlas_total(mod, cfg, preds, batch, faces, lap, regul_scale):
    return mod.compute_atlas_loss(preds, batch, cfg, has_objpoints3d=True,
                                  has_center3d=False, obj_faces=faces, laplacian=lap,
                                  regul_scale=regul_scale)


@pytest.mark.parametrize("cfg_kw,keys", [
    (ATLAS_FULL, ATLAS_KEYS),                                          # trans + scale path
    (dict(lambda_atlas=0.4, final_lambda_atlas=None), ("objpoints3d",)),  # simple path
])
def test_compute_atlas_loss_matches_jax(cfg_kw, keys):
    rng = np.random.default_rng(3)
    shapes = {"objpointscentered3d": (2, 642, 3), "objtrans": (2, 3),
              "objscale": (2, 1), "objpoints3d": (2, 642, 3)}
    preds = {k: (rng.normal(0, 40, shapes[k]) if len(shapes[k]) == 3
                 else rng.normal(1, 0.1, shapes[k])).astype(np.float32) for k in keys}
    target = rng.normal(0, 50, (2, 600, 3)).astype(np.float32)
    faces = _faces()
    lap = cotangent_laplacian(*icosphere(3))

    def jtot(p):
        return _atlas_total(jlosses, JAtlas(**cfg_kw), p, {"objpoints3d": jnp.asarray(target)},
                            jnp.asarray(faces), jnp.asarray(lap), 0.5)

    (jt, jl), jg = jax.value_and_grad(jtot, has_aux=True)(
        {k: jnp.asarray(v) for k, v in preds.items()})
    tp = {k: _t(v, grad=True) for k, v in preds.items()}
    tt, tl = _atlas_total(losses, tcfg.AtlasConfig(**cfg_kw), tp, {"objpoints3d": _t(target)},
                          torch.from_numpy(faces), torch.from_numpy(lap), 0.5)
    assert set(tl) == set(jl)  # JAX's traced dicts come back sorted by key
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    tt.backward()
    for k, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_compute_atlas_loss_matches_goldens(g):
    cfg = tcfg.AtlasConfig(lambda_atlas=0.3, final_lambda_atlas=0.25, trans_weight=0.2,
                           scale_weight=0.15, lambda_regul_edges=0.1, predict_trans=True,
                           predict_scale=True)
    args = [_t(g[k], grad=True) for k in ("atlas_pred_centered", "atlas_pred_trans",
                                          "atlas_pred_scale", "atlas_pred_obj")]
    final, tl = losses.compute_atlas_loss(
        dict(zip(ATLAS_KEYS, args)), {"objpoints3d": _t(g["atlas_target"])}, cfg,
        has_objpoints3d=True, has_center3d=False, obj_faces=_t(g["ico_faces"]),
        laplacian=None)
    np.testing.assert_allclose(float(final), g["atlas_full/final"], rtol=1e-9)
    for k in ("atlas_trans3d", "atlas_scale3d", "final_chamfer_loss", "atlas_edge_regul",
              "atlas_objpoints3d"):
        np.testing.assert_allclose(float(tl[k]), g[f"atlas_full/{k}"], rtol=1e-9, err_msg=k)
    final.backward()
    for a, k in zip(args, ATLAS_KEYS):
        np.testing.assert_allclose(a.grad.numpy(), g[f"atlas_full/grad_{k}"], rtol=1e-7,
                                   atol=1e-12, err_msg=k)


def test_stacked_atlas_option_raises(monkeypatch):
    monkeypatch.setenv("OBMAN_STACK_ATLAS", "1")
    with pytest.raises(NotImplementedError, match="later slice"):
        losses.compute_atlas_loss({"objpoints3d": torch.zeros(1, 4, 3)},
                                  {"objpoints3d": torch.zeros(1, 4, 3)},
                                  tcfg.AtlasConfig(), True, False, None, None)


def gt_batch(B, S, seed, uint8=False):
    """The synthetic all-losses batch of bench.py:166-184, as numpy."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (B, S, S, 3))
    return {
        "images": frames.astype(np.uint8) if uint8
        else frames.astype(np.float32) / 255.0 - 0.5,
        "sides": rng.integers(0, 2, (B,)).astype(np.int32),
        "joints3d": rng.normal(0, 30, (B, 21, 3)).astype(np.float32),
        "verts3d": rng.normal(0, 30, (B, 778, 3)).astype(np.float32),
        "objpoints3d": rng.normal(0, 50, (B, 600, 3)).astype(np.float32),
    }


def loss_pair(spec, B, S, seed, uint8=False):
    """JAX net + variables, the port net on the same weights, and a GT
    batch: the loss-path counterpart of test_torch_handnet._pair."""
    from obman_train_tpu.assets import synthetic_mano_assets as jax_synthetic
    from obman_train_tpu.models import build_handnet as jax_build
    from obman_train_tpu.models import mano_params_from_assets
    from obman_train_tpu_torch.weights import state_dict_from_jax

    jcfg, pcfg = _configs(spec)
    jnet = jax_build(jcfg, mano_params_from_assets(jax_synthetic("right")),
                     mano_params_from_assets(jax_synthetic("left")))
    batch = gt_batch(B, S, seed, uint8)
    init = jax.jit(lambda rngs, b: jnet.init(rngs, b, JSpec()))
    variables = _randomize_stats(
        init({"params": jax.random.PRNGKey(seed), "points": jax.random.PRNGKey(1)}, batch),
        seed)
    pnet = build_handnet(pcfg, synthetic_mano_assets("right"),
                         synthetic_mano_assets("left"), device="cpu")
    pnet.load_state_dict(state_dict_from_jax(variables, dropout=pcfg.fc_dropout), strict=True)
    return jnet, variables, pnet, batch


@pytest.fixture(scope="module")
def handnet_losses():
    jnet, variables, pnet, batch = loss_pair(CONTACT, 2, 64, 0)
    apply = jax.jit(lambda v, b: jnet.apply(v, b, JSpec(), rngs={"points": jax.random.PRNGKey(0)}))
    jtotal, _, jl = apply(variables, batch)
    with torch.no_grad():
        ttotal, _, tl = pnet({k: torch.from_numpy(v) for k, v in batch.items()}, BatchSpec())
    return jtotal, jl, ttotal, tl


def test_handnet_loss_path_matches_jax(handnet_losses):
    jtotal, jl, ttotal, tl = handnet_losses
    assert set(tl) == set(jl)
    assert set(tl) == {
        "mano_verts3d", "mano_joints3d", "mano_total_loss", "contact_auc",
        "penetration_loss", "attraction_loss", "contact_loss", "max_penetr",
        "mean_penetr", "atlas_trans3d", "atlas_scale3d", "final_chamfer_loss",
        "atlas_objpoints3d", "total_loss"}
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert float(ttotal) == float(tl["total_loss"])
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-4)


def test_regul_scale_and_laplacian_buffer():
    """``lambda_laplacian`` builds the template's Laplacian buffer, and
    ``regul_scale`` scales the edge and Laplacian terms only."""
    spec = dict(CONTACT, atlas=dict(CONTACT["atlas"], lambda_laplacian=0.1,
                                    lambda_regul_edges=0.2))
    _, pcfg = _configs(spec)
    net = build_handnet(pcfg, synthetic_mano_assets("right"), synthetic_mano_assets("left"),
                        device="cpu")
    np.testing.assert_array_equal(net.laplacian.numpy(), cotangent_laplacian(*icosphere(3)))
    assert build_handnet(_configs(CONTACT)[1], synthetic_mano_assets("right"),
                         synthetic_mano_assets("left"), device="cpu").laplacian is None
    batch = {k: torch.from_numpy(v) for k, v in gt_batch(1, 32, 3).items()}
    with torch.no_grad():
        t1, _, l1 = net(batch, BatchSpec(), regul_scale=1000.0)
        t0, _, l0 = net(batch, BatchSpec(), regul_scale=0.0)
    assert all(float(l1[k]) == float(l0[k]) for k in l0 if k != "total_loss")
    # a large scale lifts the regul terms above the float32 rounding of the
    # ~1e4 total: rtol 1e-3
    reguls = 1000.0 * (0.2 * l1["atlas_edge_regul"] + 0.1 * l1["atlas_laplac"])
    np.testing.assert_allclose(float(t1 - t0), float(reguls), rtol=1e-3)
