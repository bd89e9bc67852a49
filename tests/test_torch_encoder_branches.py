"""The port's ResNet encoders and model branches against the JAX package,
on the same weights (JAX ``init`` carried over by ``state_dict_from_jax``)
with randomized BN running statistics.

Tolerances: features and head outputs rtol/atol 1e-4; MANO verts/joints
atol 2e-3 mm (the f32 floor of test_torch_mano.py); objpoints (out_factor
200) atol 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obman_train_tpu.assets import icosphere as jax_icosphere
from obman_train_tpu.assets import synthetic_mano_assets as jax_synthetic
from obman_train_tpu.models import resnet as jax_resnet
from obman_train_tpu.models.branches import AtlasBranch as JaxAtlas
from obman_train_tpu.models.branches import ManoBranch as JaxMano
from obman_train_tpu.models.mano import mano_params_from_assets
from obman_train_tpu_torch.assets import icosphere, synthetic_mano_assets
from obman_train_tpu_torch.models import resnet
from obman_train_tpu_torch.models.branches import AtlasBranch, ManoBranch
from obman_train_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(2)


def _randomize_stats(variables, seed):
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (
            rng.normal(0, 0.1, v.shape) if path[-1].key == "mean"
            else rng.uniform(0.5, 1.5, v.shape)
        ).astype(np.float32),
        variables.get("batch_stats", {}),
    )
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return {"params": params, "batch_stats": stats}


def _port_state(variables, top):
    """state_dict_from_jax on a sub-module's variables, prefix stripped."""
    wrapped = {k: {top: v} for k, v in variables.items() if v}
    sd = state_dict_from_jax(wrapped)
    return {k[len(top) + 1:]: v for k, v in sd.items()}


@pytest.fixture(scope="module", params=[18, 50])
def encoders(request):
    depth = request.param
    jnet = {18: jax_resnet.resnet18, 50: jax_resnet.resnet50}[depth]()
    x = np.random.default_rng(depth).normal(0, 0.5, (2, 64, 64, 3)).astype(np.float32)
    variables = _randomize_stats(
        jnet.init(jax.random.PRNGKey(depth), jnp.asarray(x)), depth
    )
    feats, inters = jnet.apply(variables, jnp.asarray(x), return_inter=True)
    tnet = {18: resnet.resnet18, 50: resnet.resnet50}[depth]().eval()
    tnet.load_state_dict(_port_state(variables, "base_net"), strict=True)
    with torch.no_grad():
        tfeats, tinters = tnet(torch.from_numpy(x).permute(0, 3, 1, 2), return_inter=True)
    return (np.asarray(feats), [np.asarray(i) for i in inters]), (tfeats, tinters)


def test_resnet_features_match_jax(encoders):
    (feats, _), (tfeats, _) = encoders
    assert tfeats.shape == feats.shape
    np.testing.assert_allclose(tfeats.numpy(), feats, rtol=1e-4, atol=1e-4)


def test_resnet_return_inter_matches_jax(encoders):
    (_, inters), (_, tinters) = encoders
    assert len(tinters) == len(inters) == 4
    for got, want in zip(tinters, inters):
        np.testing.assert_allclose(
            got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-4, atol=1e-4
        )


def test_resnet_without_inter_returns_none():
    feats, inters = resnet.resnet18().eval()(torch.zeros((1, 3, 32, 32)))
    assert feats.shape == (1, 512) and inters is None


_MANO_CASES = {
    "default": dict(),
    "shape_trans": dict(use_shape=True, use_trans=True),
    "ncomps30_palm": dict(ncomps=30, root_palm=True),
    "skeleton": dict(adapt_skeleton=True),
    "axisangle_rotmat": dict(use_pca=False),
    "stereoshape": dict(use_stereoshape=True),
    "dropout": dict(dropout=0.2),
}


@pytest.mark.parametrize("case", sorted(_MANO_CASES))
def test_mano_branch_matches_jax(case):
    kw = dict(_MANO_CASES[case])
    call_kw = {k: kw.pop(k) for k in ("root_palm", "use_stereoshape") if k in kw}
    rng = np.random.default_rng(len(case))
    B, C = 4, 64
    feats = rng.normal(0, 1.0, (B, C)).astype(np.float32)
    sides = np.array([0, 1, 1, 0], np.int32)
    jbranch = JaxMano(
        mano_right=mano_params_from_assets(jax_synthetic("right")),
        mano_left=mano_params_from_assets(jax_synthetic("left")),
        base_neurons=(128, 32), **kw,
    )
    variables = jbranch.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                             jnp.asarray(sides), **call_kw)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for side in ("left", "right"):
        if f"{side}_skeleton_reg" in params:  # identity at init: perturb
            params[f"{side}_skeleton_reg"] = (
                params[f"{side}_skeleton_reg"]
                + rng.normal(0, 0.05, (21, 21)).astype(np.float32)
            )
    want = jbranch.apply({"params": params}, jnp.asarray(feats), jnp.asarray(sides),
                         **call_kw)

    tbranch = ManoBranch(synthetic_mano_assets("right"), synthetic_mano_assets("left"),
                         in_features=C, base_neurons=(128, 32), **kw).eval()
    sd = state_dict_from_jax({"params": {"mano_branch": params}},
                             dropout=kw.get("dropout", 0.0))
    tbranch.load_state_dict({k[len("mano_branch."):]: v for k, v in sd.items()},
                            strict=True)
    with torch.no_grad():
        got = tbranch(torch.from_numpy(feats), torch.from_numpy(sides), **call_kw)
    assert set(got) == set(want)
    for key in ("pose", "shape", "trans"):
        if want.get(key) is not None:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
    for key in ("verts", "joints"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=2e-3, err_msg=key)


@pytest.mark.parametrize(
    "kw",
    [
        dict(predict_trans=True, predict_scale=True),
        dict(predict_trans=True, predict_scale=True, use_residual=True),
        dict(),
        dict(use_tanh=True),
    ],
    ids=["trans_scale", "trans_scale_residual", "plain", "tanh"],
)
def test_atlas_forward_inference_matches_jax(kw):
    rng = np.random.default_rng(11)
    B, C = 2, 32
    feats = rng.normal(0, 1.0, (B, C)).astype(np.float32)
    jverts, _ = jax_icosphere(2)
    jbranch = JaxAtlas(bottleneck_size=C, test_verts=jverts, **kw)
    variables = jbranch.init(jax.random.PRNGKey(1), jnp.asarray(feats),
                             method=JaxAtlas.forward_inference)
    variables = _randomize_stats(variables, 12)
    want = jbranch.apply(variables, jnp.asarray(feats), method=JaxAtlas.forward_inference)

    tbranch = AtlasBranch(C, icosphere(2)[0], **kw).eval()
    tbranch.load_state_dict(_port_state(variables, "atlas_branch"), strict=True)
    with torch.no_grad():
        got = tbranch.forward_inference(torch.from_numpy(feats))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["objpoints3d"].numpy(), np.asarray(want["objpoints3d"]),
                               atol=2e-2)
    for key in ("objtrans", "objscale"):
        if key in want:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       rtol=1e-4, atol=1e-4, err_msg=key)


def test_scale_head_bias_starts_at_one():
    branch = AtlasBranch(16, icosphere(1)[0], predict_scale=True)
    assert torch.equal(branch.decode_scale[2].bias, torch.ones(1))
