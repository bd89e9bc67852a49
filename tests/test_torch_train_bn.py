"""Unfrozen BN and dropout in the port (``models/resnet.py``,
``models/branches.py``, ``train/steps.py`` ``train_bn=True``) against the
JAX package's ``make_train_step(train_bn=True)`` on the CPU: the contact
config, ResNet-18 at 64 px, B=4, the synthetic GT batch, the same weights
and running statistics, ``fc_dropout=0`` (the ``jax.random`` stream cannot
be reproduced).

- One step (and one with ``accum_steps=2``), against the JAX step:
  every updated ``running_mean`` and ``running_var`` of the encoder and the
  atlas decoder to rtol 1e-4, atol 1e-6 (1e-5 for two microbatches of 2,
  whose batch means differ by up to 5.1e-6 where a running mean is near 0;
  one step: within 0.71 of the 1e-6 bound), through ``state_dict_from_jax``
  (flax folds the biased batch variance into the running one; torch's own
  BatchNorm would fold the unbiased one, n/(n-1) larger); the MANO, atlas
  and total losses to rtol 1e-4; the contact terms to rtol 1e-4 of the JAX
  contact functions run on the port's own hand and object vertices (as
  ``test_torch_handnet.py`` holds the masks): batch statistics over 16
  values a channel at the last stage turn float32 rounding into ~1e-4
  relative differences of the object vertices, which the penetration
  masks amplify to 1.3e-4..5.6e-4 relative on those terms;
- the gradients to rtol 1e-3 with atol ``GRAD_ATOL`` of each tensor's
  largest entry. Measured against a float64 copy of the port (MANO and
  Chamfer included) on these inputs, JAX's float32 gradients are off by
  up to 9.1e-4 (one step) and 4.8e-3 (two microbatches of 2) of a tensor's
  scale and the port's by 1.3e-3 and 2.7e-3; the two packages differ by
  up to 1.25e-3 and 5.0e-3. The bound is twice JAX's own distance from the
  float64 gradients. The decoder's conv biases that feed a BN have an
  exact gradient of 0: both packages' stay under 1e-4 of the layer
  weight's.
- Eval mode is torch's BatchNorm bit for bit (frozen BN is unchanged).
- Dropout: zeroes and rescales by 1/(1-p) in ``train()``, the identity in
  ``eval()``; its masks are a function of the seed, the update count and
  the microbatch.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obman_train_tpu.config import TrainConfig as JTrain
from obman_train_tpu.models import BatchSpec as JSpec
from obman_train_tpu.ops.chamfer import min_sqdist_to as jax_min_sqdist_to
from obman_train_tpu.ops.contact import compute_contact_loss as jax_contact
from obman_train_tpu.ops.mesh import meshiou as jax_meshiou
from obman_train_tpu.train import steps as jsteps
from obman_train_tpu_torch import train
from obman_train_tpu_torch.config import TrainConfig
from obman_train_tpu_torch.models import BatchSpec
from obman_train_tpu_torch.models.branches import Dropout
from obman_train_tpu_torch.models.resnet import BatchNorm1d, BatchNorm2d
from obman_train_tpu_torch.weights import state_dict_from_jax
from tests.test_torch_handnet import CONTACT
from tests.test_torch_losses import loss_pair

torch.set_num_threads(2)

SGD0 = dict(optimizer="sgd", lr=0.0, momentum=0.0)  # the step leaves the weights
GRAD_ATOL = {1: 2e-3, 2: 1e-2}  # of each tensor's largest entry, by accum_steps
STATS_ATOL = {1: 1e-6, 2: 1e-5}
CONTACT_KEYS = ("attraction_loss", "penetration_loss", "contact_loss", "max_penetr",
                "mean_penetr", "contact_auc")


def _jax_grads(jnet, params, stats, batch):
    """Gradients and updated statistics of one train=True forward, as the
    JAX step's ``forward_grads`` computes them."""
    key = jax.random.PRNGKey(0)

    def loss_fn(p):
        (total, _, losses), upd = jnet.apply(
            {"params": p, "batch_stats": stats}, batch, JSpec(), train=True,
            rngs={"dropout": key, "points": key}, mutable=["batch_stats"])
        return total, upd["batch_stats"]

    (_, new_stats), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return g, new_stats


def _contact_terms_on_port_geometry(pnet, batch, accum):
    """The contact terms of the JAX functions on the hand and object
    vertices of the port's own train-mode forward, averaged over the
    microbatches as the step averages its losses."""
    net = copy.deepcopy(pnet).train()  # leaves pnet's running statistics alone
    c = pnet.cfg.contact
    sums = dict.fromkeys(CONTACT_KEYS, 0.0)
    for i in range(accum):
        micro = {k: v[i::accum] for k, v in batch.items()}
        with torch.no_grad():
            _, res, _ = net({k: torch.from_numpy(v) for k, v in micro.items()}, BatchSpec())
        attr, penetr, info, metrics = jax_contact(
            jnp.asarray(res["verts"].numpy()), jnp.asarray(res["objpoints3d"].numpy()),
            jnp.asarray(pnet.ico_faces_np), contact_thresh=c.contact_thresh,
            contact_mode=c.contact_mode, collision_thresh=c.collision_thresh,
            collision_mode=c.collision_mode, contact_target=c.contact_target,
            contact_sym=c.contact_sym, contact_zones=c.contact_zones)
        _, auc = jax_meshiou(jax_min_sqdist_to(micro["verts3d"], micro["objpoints3d"]),
                             info["min_dists"])
        terms = dict(attraction_loss=attr, penetration_loss=penetr,
                     contact_loss=c.contact_lambda * attr + c.collision_lambda * penetr,
                     contact_auc=auc, **metrics)
        for k in CONTACT_KEYS:
            sums[k] += float(terms[k]) / accum
    return sums


def _stats_keys(sd):
    return [k for k in sd if k.endswith(("running_mean", "running_var"))]


@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def unfrozen(request):
    accum = request.param
    jnet, variables, pnet, batch = loss_pair(CONTACT, 4, 64, 3)
    params, stats = variables["params"], variables["batch_stats"]
    tx = jsteps.make_optimizer(JTrain(**SGD0))
    jstate = jsteps.TrainState(params=params, batch_stats=stats, opt_state=tx.init(params),
                               step=np.zeros((), np.int32), regul_scale=np.ones((), np.float32))
    jstep = jsteps.make_train_step(jnet, tx, JSpec(), train_bn=True, donate=False,
                                   accum_steps=accum)
    jnew, jl = jstep(jstate, batch, jax.random.PRNGKey(0))
    # the step's gradients: the mean over its strided microbatches, the
    # statistics carried from one microbatch to the next as the scan does
    grads, carried = None, stats
    for i in range(accum):
        micro = {k: v[i::accum] for k, v in batch.items()}
        g, carried = _jax_grads(jnet, params, carried, micro)
        grads = g if grads is None else jax.tree_util.tree_map(np.add, grads, g)
    grads = jax.tree_util.tree_map(lambda v: np.asarray(v) / accum, grads)
    want_grads = state_dict_from_jax({"params": grads})
    want_stats = state_dict_from_jax({"params": params, "batch_stats": jnew.batch_stats})
    carried_stats = state_dict_from_jax({"params": params, "batch_stats": carried})

    contact = _contact_terms_on_port_geometry(pnet, batch, accum)
    opt = train.make_optimizer(TrainConfig(**SGD0), pnet)
    state = train.create_train_state(pnet, opt, TrainConfig(**SGD0))
    step = train.make_train_step(pnet, opt, BatchSpec(), train_bn=True, accum_steps=accum,
                                 device="cpu")
    state, tl = step(state, batch)
    got_grads = {n: p.grad.clone() for n, p in pnet.named_parameters() if p.grad is not None}
    return dict(accum=accum, jl=jl, tl=tl, contact=contact, want_grads=want_grads, got_grads=got_grads,
                want_stats=want_stats, carried_stats=carried_stats,
                got_stats=pnet.state_dict(), net=pnet, variables=variables)


def test_losses_match_jax(unfrozen):
    jl, tl, contact = unfrozen["jl"], unfrozen["tl"], unfrozen["contact"]
    assert set(tl) == set(jl)
    for k in jl:
        want = contact[k] if k in CONTACT_KEYS else float(jl[k])
        np.testing.assert_allclose(float(tl[k]), want, rtol=1e-4, atol=1e-6, err_msg=k)


# conv biases right before a training-mode BN: the batch mean removes them,
# so their exact gradient is 0 and both packages hold rounding noise there
BEFORE_BN = ("atlas_branch.decoder.conv1.bias", "atlas_branch.decoder.conv2.bias",
             "atlas_branch.decoder.conv3.bias")


def test_gradients_match_jax(unfrozen):
    want, got = unfrozen["want_grads"], unfrozen["got_grads"]
    assert set(got) == set(want)
    for name, w in want.items():
        if name in BEFORE_BN:
            layer = want[name.replace(".bias", ".weight")].abs().max()
            assert w.abs().max() <= 1e-4 * layer and got[name].abs().max() <= 1e-4 * layer
            continue
        scale = float(w.abs().max())
        torch.testing.assert_close(got[name], w, rtol=1e-3,
                                   atol=GRAD_ATOL[unfrozen["accum"]] * scale + 1e-12, msg=name)


def test_updated_running_stats_match_jax(unfrozen):
    want, got = unfrozen["want_stats"], unfrozen["got_stats"]
    keys = _stats_keys(want)
    # ResNet-18 (20 BN layers) and the atlas decoder (3), mean and var each
    assert len(keys) == 2 * 23 and set(keys) == set(_stats_keys(got))
    assert all(k.startswith(("base_net.", "atlas_branch.decoder.")) for k in keys)
    # the scan's carried statistics are the step's
    for k in keys:
        torch.testing.assert_close(unfrozen["carried_stats"][k], want[k], rtol=1e-4, atol=1e-6,
                                   msg=k)
    before = state_dict_from_jax(unfrozen["variables"])
    for k in keys:
        assert not torch.equal(got[k], before[k]), k  # the step moved them
        torch.testing.assert_close(got[k], want[k], rtol=1e-4,
                                   atol=STATS_ATOL[unfrozen["accum"]], msg=k)
    counts = {k: int(v) for k, v in got.items() if k.endswith("num_batches_tracked")}
    assert len(counts) == 23 and set(counts.values()) == {unfrozen["accum"]}
    assert not unfrozen["net"].training  # back in eval() after the step


def test_flax_statistics_not_torch_ones():
    """The biased variance goes into ``running_var``; eval mode is torch's
    BatchNorm bit for bit."""
    torch.manual_seed(0)
    for cls, base, shape in ((BatchNorm2d, torch.nn.BatchNorm2d, (4, 3, 5, 5)),
                             (BatchNorm1d, torch.nn.BatchNorm1d, (2, 3, 7))):
        x = torch.randn(shape) * 2 + 1
        ours, theirs = cls(3, eps=1e-5, momentum=0.1), base(3, eps=1e-5, momentum=0.1)
        with torch.no_grad():
            for m in (ours, theirs):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.5, 0.5)
            theirs.load_state_dict(ours.state_dict())
        y, y_ref = ours.train()(x), theirs.train()(x)
        torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)  # biased for both
        dims = [0, *range(2, x.dim())]
        var = x.var(dim=dims, unbiased=False)
        torch.testing.assert_close(ours.running_var, 0.9 + 0.1 * var)
        torch.testing.assert_close(ours.running_mean, 0.1 * x.mean(dim=dims))
        assert not torch.allclose(theirs.running_var, ours.running_var)  # the n/(n-1) trap
        theirs.load_state_dict(ours.state_dict())
        ours.eval(), theirs.eval()
        assert torch.equal(ours(x), theirs(x))


def test_dropout_behaviour():
    x = torch.full((64, 256), 3.0)
    d = Dropout(0.25)
    gen = torch.Generator().manual_seed(0)
    y = d.train()(x, gen)
    assert set(torch.unique(y).tolist()) == {0.0, 4.0}  # 3 / (1 - 0.25)
    assert abs(float((y == 0).float().mean()) - 0.25) < 0.02
    assert d.eval()(x) is x and Dropout(0.0).train()(x) is x
    with pytest.raises(ValueError, match="Generator"):
        d.train()(x)


def test_dropout_masks_follow_seed_step_and_microbatch():
    def mask(seed, step, micro):
        gen = train.dropout_generator(torch.device("cpu"), seed, step, micro)
        return Dropout(0.5).train()(torch.ones(1000), gen) == 0

    assert torch.equal(mask(0, 7, 0), mask(0, 7, 0))
    for other in ((1, 7, 0), (0, 8, 0), (0, 7, 1)):
        assert not torch.equal(mask(0, 7, 0), mask(*other)), other


def test_dropout_train_step_is_seeded():
    """Two runs from the same weights, seed and update count take the same
    step with dropout on; another seed another one."""
    spec = dict(CONTACT, fc_dropout=0.5)
    _, variables, pnet, batch = loss_pair(spec, 2, 32, 4)
    sd = {k: v.clone() for k, v in pnet.state_dict().items()}

    def run(seed):
        pnet.load_state_dict(sd)
        cfg = TrainConfig(optimizer="sgd", lr=1e-2, manual_seed=seed)
        opt = train.make_optimizer(cfg, pnet)
        state = train.create_train_state(pnet, opt, cfg)
        state.step = 5
        step = train.make_train_step(pnet, opt, BatchSpec(), train_bn=True, device="cpu")
        _, losses = step(state, batch)
        return float(losses["total_loss"]), {k: v.clone() for k, v in pnet.state_dict().items()}

    a, b, c = run(0), run(0), run(1)
    assert a[0] == b[0] and all(torch.equal(v, b[1][k]) for k, v in a[1].items())
    assert a[0] != c[0]
    with torch.no_grad():  # eval() takes no generator: dropout is off
        pnet.eval()
        pnet({k: torch.from_numpy(v) for k, v in batch.items()}, BatchSpec())


def test_float64_port_is_the_float32_one():
    """``net.double()`` runs the whole port in float64 on the CPU (MANO
    keeps the encoder's dtype when it is wider than float32): the reference
    the GPU checks hold unfrozen-BN gradients against. Its losses are the
    float32 port's to float32 rounding."""
    _, _, pnet, batch = loss_pair(CONTACT, 2, 32, 6)
    net64 = copy.deepcopy(pnet).double()
    b32 = {k: torch.from_numpy(v) for k, v in batch.items()}
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in b32.items()}
    with torch.no_grad():
        _, r32, l32 = pnet(b32, BatchSpec())
        _, r64, l64 = net64(b64, BatchSpec())
    assert r64["verts"].dtype == r64["objpoints3d"].dtype == torch.float64
    for k in ("total_loss", "mano_total_loss", "final_chamfer_loss", "atlas_objpoints3d"):
        np.testing.assert_allclose(float(l64[k]), float(l32[k]), rtol=1e-4, err_msg=k)
    opt = train.make_optimizer(TrainConfig(**SGD0), net64)
    step = train.make_train_step(net64, opt, BatchSpec(), train_bn=True, device="cpu")
    step(train.create_train_state(net64, opt, TrainConfig(**SGD0)), b64)
    assert all(p.grad.dtype == torch.float64 for p in net64.parameters() if p.grad is not None)
