"""The port's ``compute_dtype="bfloat16"`` against the JAX package's bf16 on
the CPU: the contact config (bench.py:118-124, ``contact_bf16``), ResNet-18
at 64 px, B=2 (B=4 for unfrozen BN), seeded uint8 frames and the synthetic
GT batch, the same float32 weights through ``state_dict_from_jax`` (the
JAX test of the path: tests/test_misc.py:4).

**The reference program.** XLA on the CPU keeps float32 between the ops of
a fusion by default (``xla_allow_excess_precision``), so JAX's CPU bf16
rounds fewer times than the program it is given says; the port rounds at
every op, as the program says and as a GPU runs it. The JAX bf16 reference
here is compiled with that option off (``_strict``). Every tolerance below
is taken from JAX's own bf16-vs-float32 gap on the same inputs, measured
as a relative L2 distance (``_rel``), and is named beside the hold.

**Where it is held.** Two bf16 programs that round one op differently by
one ulp drift apart through the encoder's 20 layers, end to end to the
size of the bf16 gap itself. So the parity is held on identical inputs,
layer by layer:

- the ResNet stem on the same image, and each stage on JAX's bf16 input
  to that stage: within ``STAGE_FACTOR`` of that stage's own JAX gap;
- the MANO branch, the atlas decoder and the trans/scale heads on JAX's
  bf16 encoder features: within ``HEADS_FACTOR`` of their own JAX gap
  (measured: 0 for pose, objtrans and objscale, 0.04 of the gap for the
  decoder's points); MANO in float32 on the bf16 heads' pose;
- end to end: ``verts``/``joints`` against JAX's bf16 within JAX's gap;
  the object outputs, where the drift reaches the gap, against the port's
  own float32 net within ``NOISE_FACTOR`` of JAX's gap (the port's bf16
  is no noisier than JAX's), the predicted scales within one bf16 ulp of
  it; the contact masks exactly, by the JAX contact functions on the
  port's own vertices;
- the loss path: the total, MANO and Chamfer terms within JAX's gap, the
  contact terms and ``atlas_scale3d`` (one bf16 ulp of the predicted scale
  is above JAX's gap there) by the JAX functions on the port's own
  predictions to rtol 1e-4;
- the train step (frozen BN): the loss within JAX's gap, the whole
  gradient within JAX's gap and each tensor within ``GRAD_TENSOR_FACTOR``
  of its own gap; one Adam update keeps float32 parameters and moments;
- unfrozen BN: float32 running statistics within JAX's own bf16 gap of
  JAX's, the whole gradient within JAX's gap.

Output dtypes equal JAX's: ``verts``/``joints`` float32, the atlas and
head outputs bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obman_train_tpu.assets import synthetic_mano_assets as jax_synthetic
from obman_train_tpu.models import BatchSpec as JSpec
from obman_train_tpu.models import build_handnet as jax_build
from obman_train_tpu.models import mano_params_from_assets
from obman_train_tpu.models.resnet import BasicBlock as JBlock
from obman_train_tpu.ops.contact import compute_contact_loss as jax_contact
from obman_train_tpu_torch import train
from obman_train_tpu_torch.assets import synthetic_mano_assets
from obman_train_tpu_torch.config import TrainConfig
from obman_train_tpu_torch.infer import make_infer
from obman_train_tpu_torch.models import INFER_SPEC, BatchSpec, build_handnet
from obman_train_tpu_torch.weights import state_dict_from_jax
from tests.test_torch_handnet import CONTACT, INFER_KW, JAX_SPEC, _configs, _pair
from tests.test_torch_losses import loss_pair

torch.set_num_threads(2)

BF16 = dict(CONTACT, compute_dtype="bfloat16")
STAGE_FACTOR = 0.5
HEADS_FACTOR = 0.1
NOISE_FACTOR = 1.5
GRAD_TENSOR_FACTOR = 1.25


def _strict(fn, *args):
    """``fn`` jitted with XLA's excess precision off: bf16 rounded at every
    op, the program's own semantics."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _f(t):
    """A tensor or array as float32 numpy (numpy has no bf16)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.array(jnp.asarray(t, jnp.float32))


def _nets(spec, variables, dropout=0.0):
    jcfg, pcfg = _configs(spec)
    jnet = jax_build(jcfg, mano_params_from_assets(jax_synthetic("right")),
                     mano_params_from_assets(jax_synthetic("left")))
    pnet = build_handnet(pcfg, synthetic_mano_assets("right"), synthetic_mano_assets("left"),
                         device="cpu")
    pnet.load_state_dict(state_dict_from_jax(variables, dropout=dropout), strict=True)
    return jnet, pnet


@pytest.fixture(scope="module")
def fwd():
    jnet32, variables, pnet32, batch = _pair(CONTACT, 2, 64, 0)
    jnet16, pnet16 = _nets(BF16, variables)

    def run(net):
        (_, res, _), st = _strict(lambda v, b: net.apply(
            v, b, JAX_SPEC, **INFER_KW, capture_intermediates=True), variables, batch)
        return res, st["intermediates"]

    r16, i16 = run(jnet16)
    r32, _ = run(jnet32)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        _, p16, _ = pnet16(tb, INFER_SPEC, **INFER_KW)
        _, p32, _ = pnet32(tb, INFER_SPEC, **INFER_KW)
    return dict(variables=variables, batch=batch, jnet16=jnet16, jnet32=jnet32, r16=r16,
                r32=r32, i16=i16, pnet16=pnet16, p16=p16, p32=p32,
                served=make_infer(pnet16)(batch["images"], batch["sides"]))


def test_bf16_outputs_keep_jax_dtypes(fwd):
    r16, p16 = fwd["r16"], fwd["p16"]
    keys = [k for k in r16 if k not in ("contact_info", "objfaces")]
    assert set(keys) <= set(p16)
    for k in keys:
        if r16[k] is not None:
            assert str(p16[k].dtype).split(".")[-1] == r16[k].dtype.name, k
    assert p16["verts"].dtype == p16["joints"].dtype == torch.float32
    assert p16["objpoints3d"].dtype == torch.bfloat16
    for k, v in r16["contact_info"].items():
        assert str(p16["contact_info"][k].dtype).split(".")[-1] == v.dtype.name, k
    served = fwd["served"]  # make_infer: the same outputs, the same dtypes
    assert set(served) == {"verts", "joints", "objpoints3d", "contact_info"}
    for k in ("verts", "joints", "objpoints3d"):
        assert torch.equal(served[k], p16[k]), k
    # the parameters and statistics stay float32
    assert {v.dtype for v in fwd["pnet16"].state_dict().values()
            if v.is_floating_point()} == {torch.float32}


def _jax_stage(stage, width, params, stats, dtype, x):
    """ResNet-18 stage ``stage`` (0-3) of the JAX package on NHWC ``x``."""
    y = x
    for b in range(2):
        name = f"layer{stage + 1}_{b}"
        block = JBlock(features=width, strides=2 if (stage and b == 0) else 1,
                       downsample=bool(stage and b == 0), dtype=dtype)
        y = _strict(lambda v, z: block.apply(v, z),
                    {"params": params[name], "batch_stats": stats[name]}, y)
    return y


def test_bf16_encoder_layers_on_identical_inputs_match_jax(fwd):
    variables, batch, i16 = fwd["variables"], fwd["batch"], fwd["i16"]
    params = variables["params"]["base_net"]
    stats = variables["batch_stats"]["base_net"]
    enc = fwd["pnet16"].base_net
    image = batch["images"].astype(np.float32) / 255.0 - 0.5
    x = torch.from_numpy(image).permute(0, 3, 1, 2)
    base = i16["base_net"]
    # the stem on the same image (the f32 gap: the bf16 vs float32 JAX stem)
    jconv = base["conv1"]["__call__"][0]
    jbn = base["bn1"]["__call__"][0]
    with torch.no_grad():
        conv = enc.conv1(x)
        bn = enc.bn1(conv)
    gap32 = jax.jit(lambda v, z: jax.lax.conv_general_dilated(
        z, v, (2, 2), ((3, 3), (3, 3)), dimension_numbers=("NHWC", "HWIO", "NHWC")))(
        params["conv1"]["kernel"], image)
    nchw = (0, 3, 1, 2)
    gap = _rel(_f(jconv), np.asarray(gap32))
    assert _rel(conv.float().numpy(), _f(jconv).transpose(nchw)) <= STAGE_FACTOR * gap
    assert _rel(bn.float().numpy(), _f(jbn).transpose(nchw)) <= STAGE_FACTOR * gap
    # each stage on JAX's bf16 input to it
    stage_in = torch.nn.functional.max_pool2d(
        torch.relu(torch.from_numpy(_f(jbn)).permute(0, 3, 1, 2)), 3, 2, 1).to(torch.bfloat16)
    for s, width in enumerate((64, 128, 256, 512)):
        xin = jnp.asarray(stage_in.float().permute(0, 2, 3, 1).numpy(), jnp.bfloat16)
        want = _jax_stage(s, width, params, stats, jnp.bfloat16, xin)
        want32 = _jax_stage(s, width, params, stats, jnp.float32, xin.astype(jnp.float32))
        with torch.no_grad():
            got = getattr(enc, f"layer{s + 1}")(stage_in)
        assert got.dtype == torch.bfloat16
        ratio = _rel(got.float().numpy(), _f(want).transpose(nchw)) / _rel(_f(want), want32)
        assert ratio <= STAGE_FACTOR, (s, ratio)
        stage_in = torch.from_numpy(_f(want)).permute(0, 3, 1, 2).to(torch.bfloat16)


def _heads(m, feats, sides):
    return (m.mano_branch(feats, sides), m.atlas_branch.forward_inference(feats))


def test_bf16_heads_and_mano_on_identical_features_match_jax(fwd):
    variables, batch = fwd["variables"], fwd["batch"]
    feats = jnp.asarray(fwd["i16"]["base_net"]["__call__"][0][0], jnp.float32)
    sides = jnp.asarray(batch["sides"])
    j16 = _strict(lambda v, f, s: fwd["jnet16"].apply(v, f, s, method=_heads),
                  variables, feats, sides)
    j32 = _strict(lambda v, f, s: fwd["jnet32"].apply(v, f, s, method=_heads),
                  variables, feats, sides)
    net = fwd["pnet16"]
    with torch.no_grad():
        tf = torch.from_numpy(np.asarray(feats))
        got = (net.mano_branch(tf, torch.from_numpy(batch["sides"])),
               net.atlas_branch.forward_inference(tf))
    for part in range(2):
        for k, want in j16[part].items():
            if want is None:
                continue
            assert str(got[part][k].dtype).split(".")[-1] == want.dtype.name, k
            err = _rel(_f(got[part][k]), _f(want))
            assert err <= HEADS_FACTOR * _rel(_f(want), _f(j32[part][k])), (k, err)


def _jax_contact(pnet, res):
    """The JAX contact block on the port's own vertices, the object's in
    bf16 as the port's are."""
    c = pnet.cfg.contact
    kw = dict(contact_thresh=c.contact_thresh, contact_mode=c.contact_mode,
              collision_thresh=c.collision_thresh, collision_mode=c.collision_mode,
              contact_target=c.contact_target, contact_sym=c.contact_sym,
              contact_zones=c.contact_zones)
    faces = jnp.asarray(pnet.ico_faces_np)
    return _strict(lambda h, o: jax_contact(h, o, faces, **kw), jnp.asarray(_f(res["verts"])),
                   jnp.asarray(_f(res["objpoints3d"]), jnp.bfloat16))


def test_bf16_forward_end_to_end(fwd):
    r16, r32, p16, p32 = fwd["r16"], fwd["r32"], fwd["p16"], fwd["p32"]
    for k in ("verts", "joints"):
        assert _rel(_f(p16[k]), _f(r16[k])) <= _rel(_f(r16[k]), _f(r32[k])), k
    for k in ("objpoints3d", "objpointscentered3d", "objtrans", "pose"):
        noise = _rel(_f(p16[k]), _f(p32[k]))
        assert noise <= NOISE_FACTOR * _rel(_f(r16[k]), _f(r32[k])), (k, noise)
    # two scales near 1, where JAX's bf16 rounds to the f32 value's nearest
    # bf16 (a gap of half an ulp): the port's is one of its two neighbours
    want = _f(p32["objscale"])
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
    assert (np.abs(_f(p16["objscale"]) - want) <= ulp).all()
    # the contact masks exactly: JAX's contact on the port's own geometry
    _, _, info, _ = _jax_contact(fwd["pnet16"], p16)
    for k in ("attraction_masks", "repulsion_masks"):
        np.testing.assert_array_equal(p16["contact_info"][k].numpy(), np.asarray(info[k]),
                                      err_msg=k)
    np.testing.assert_allclose(p16["contact_info"]["min_dists"].numpy(),
                               np.asarray(info["min_dists"]), rtol=1e-5, atol=1e-3)


CONTACT_KEYS = ("attraction_loss", "penetration_loss", "contact_loss", "max_penetr",
                "mean_penetr", "contact_auc")
GAP_KEYS = ("total_loss", "mano_verts3d", "mano_joints3d", "mano_total_loss",
            "atlas_objpoints3d", "final_chamfer_loss", "atlas_trans3d")


def _on_port_predictions(pnet, res, batch):
    """The contact terms and ``atlas_scale3d`` by the JAX functions on the
    port's own predictions (bf16 where the port's are)."""
    from obman_train_tpu.ops.chamfer import min_sqdist_to as jmin
    from obman_train_tpu.ops.mesh import meshiou as jmeshiou

    c = pnet.cfg.contact
    attr, pen, info, metrics = _jax_contact(pnet, res)
    _, auc = jmeshiou(jmin(batch["verts3d"], batch["objpoints3d"]), info["min_dists"])
    target = batch["objpoints3d"]
    centered = target - target.mean(1, keepdims=True)
    scales = np.sqrt((centered ** 2).sum(2) + 1e-16).max(1)
    pred_scale = jnp.asarray(_f(res["objscale"]), jnp.bfloat16)
    return dict(attraction_loss=attr, penetration_loss=pen,
                contact_loss=c.contact_lambda * attr + c.collision_lambda * pen,
                contact_auc=auc, atlas_scale3d=jnp.mean((pred_scale - scales[:, None]) ** 2),
                **metrics)


@pytest.fixture(scope="module")
def losses16():
    jnet32, variables, _, batch = loss_pair(CONTACT, 2, 64, 0)
    jnet16, pnet16 = _nets(BF16, variables)
    key = jax.random.PRNGKey(0)
    apply = lambda net: _strict(lambda v, b: net.apply(v, b, JSpec(), rngs={"points": key}),
                                variables, batch)
    _, _, jl16 = apply(jnet16)
    _, _, jl32 = apply(jnet32)
    with torch.no_grad():
        _, res, tl = pnet16({k: torch.from_numpy(v) for k, v in batch.items()}, BatchSpec())
    return dict(jl16=jl16, jl32=jl32, tl=tl, own=_on_port_predictions(pnet16, res, batch),
                variables=variables, batch=batch, jnet16=jnet16, jnet32=jnet32)


def test_bf16_loss_path_matches_jax(losses16):
    jl16, jl32, tl, own = (losses16[k] for k in ("jl16", "jl32", "tl", "own"))
    assert set(tl) == set(jl16)
    for k in jl16:
        assert str(tl[k].dtype).split(".")[-1] == jl16[k].dtype.name, k
    for k in GAP_KEYS:
        err = abs(float(tl[k]) - float(jl16[k]))
        assert err <= abs(float(jl16[k]) - float(jl32[k])), k
    for k in CONTACT_KEYS + ("atlas_scale3d",):
        np.testing.assert_allclose(float(tl[k]), float(own[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _jax_grads(jnet, variables, batch):
    def total(params):
        return jnet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          batch, JSpec(), rngs={"points": jax.random.PRNGKey(0)})[0]

    return _strict(jax.value_and_grad(total), variables["params"])


def _grad_tree(tree):
    return state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, tree)})


def _whole(d, keys):
    return np.concatenate([d[k].float().numpy().ravel() for k in keys])


@pytest.fixture(scope="module")
def step16(losses16):
    variables, batch = losses16["variables"], losses16["batch"]
    t16, g16 = _jax_grads(losses16["jnet16"], variables, batch)
    t32, g32 = _jax_grads(losses16["jnet32"], variables, batch)
    _, pnet = _nets(BF16, variables)
    cfg = TrainConfig(optimizer="adam", lr=1e-4)
    opt = train.make_optimizer(cfg, pnet)
    state = train.create_train_state(pnet, opt, cfg)
    before = {n: p.detach().clone() for n, p in pnet.named_parameters()}
    state, tl = train.make_train_step(pnet, opt, BatchSpec(), device="cpu")(state, batch)
    got = {n: p.grad.clone() for n, p in pnet.named_parameters() if p.grad is not None}
    return dict(t16=float(t16), t32=float(t32), tl=tl, g16=_grad_tree(g16),
                g32=_grad_tree(g32), got=got, net=pnet, opt=opt, before=before)


def test_bf16_train_step_loss_and_gradients_match_jax(step16):
    s = step16
    assert abs(float(s["tl"]["total_loss"]) - s["t16"]) <= abs(s["t16"] - s["t32"])
    g16, g32, got = s["g16"], s["g32"], s["got"]
    assert set(got) == set(g16)
    keys = sorted(g16)
    assert _rel(_whole(got, keys), _whole(g16, keys)) <= _rel(_whole(g16, keys),
                                                           _whole(g32, keys))
    for k in keys:
        assert got[k].dtype == torch.float32, k
        gap = _rel(g16[k].numpy(), g32[k].numpy())
        if gap == 0.0:  # the same float32 gradient on both (no bf16 in its path)
            torch.testing.assert_close(got[k], g16[k], rtol=1e-4, atol=1e-6, msg=k)
            continue
        assert _rel(got[k].numpy(), g16[k].numpy()) <= GRAD_TENSOR_FACTOR * gap, k


def test_bf16_adam_update_stays_float32(step16):
    """One Adam update (lr 1e-4) on the float32 parameters: the first
    update is lr * g / (|g| + eps) per entry, from float32 moments."""
    net, opt, before, got = step16["net"], step16["opt"], step16["before"], step16["got"]
    for n, p in net.named_parameters():
        assert p.dtype == torch.float32
        st = opt.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
        g = got[n]
        want = before[n] - 1e-4 * g / (g.abs() + 1e-8)
        torch.testing.assert_close(p.detach(), want, rtol=1e-6, atol=1e-9, msg=n)


def test_bf16_unfrozen_bn_step_matches_jax():
    jnet32, variables, _, batch = loss_pair(CONTACT, 4, 64, 3)
    jnet16, pnet = _nets(BF16, variables)
    params, stats = variables["params"], variables["batch_stats"]
    key = jax.random.PRNGKey(0)

    def grads(net):
        def loss_fn(p):
            (total, _, _), upd = net.apply({"params": p, "batch_stats": stats}, batch, JSpec(),
                                           train=True, rngs={"dropout": key, "points": key},
                                           mutable=["batch_stats"])
            return total, upd["batch_stats"]

        (total, new_stats), g = _strict(jax.value_and_grad(loss_fn, has_aux=True), params)
        return float(total), _grad_tree(g), state_dict_from_jax(
            {"params": params, "batch_stats": new_stats})

    t16, g16, s16 = grads(jnet16)
    t32, g32, s32 = grads(jnet32)
    cfg = TrainConfig(optimizer="sgd", lr=0.0, momentum=0.0)
    opt = train.make_optimizer(cfg, pnet)
    state = train.create_train_state(pnet, opt, cfg)
    state, tl = train.make_train_step(pnet, opt, BatchSpec(), train_bn=True,
                                      device="cpu")(state, batch)
    got = {n: p.grad.clone() for n, p in pnet.named_parameters() if p.grad is not None}
    assert abs(float(tl["total_loss"]) - t16) <= abs(t16 - t32)
    keys = sorted(g16)
    assert _rel(_whole(got, keys), _whole(g16, keys)) <= _rel(_whole(g16, keys),
                                                           _whole(g32, keys))
    assert all(torch.isfinite(g).all() for g in got.values())
    sd = pnet.state_dict()
    stat_keys = [k for k in s16 if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 2 * 23
    for k in stat_keys:
        assert sd[k].dtype == torch.float32, k
    assert _rel(_whole(sd, stat_keys), _whole(s16, stat_keys)) <= _rel(
        _whole(s16, stat_keys), _whole(s32, stat_keys))
    assert not pnet.training
