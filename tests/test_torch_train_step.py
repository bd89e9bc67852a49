"""The port's train step (``train/steps.py``) against the JAX package's on
the CPU, on the same weights and the same synthetic GT batch
(bench.py:166-184): the contact config, ResNet-18, frozen BN.

- One step's gradients, JAX ``jax.grad`` of the total loss converted with
  ``state_dict_from_jax`` (gradients have the parameters' tree), key by
  key: each tensor to 1e-3 of its largest entry (float32 encoders round
  differently; the chain through ResNet-18 amplifies it), and to rtol 1e-3
  where entries are not small.
- One update of each optimizer from identical gradients against optax's:
  adam, rms (optax's ``rmsprop``, eps inside the root, decay 0.9) and sgd
  with momentum. Adam's first update is about +-lr wherever |g| >> eps, so
  its error is bounded in units of lr: atol 1e-3 lr, rtol 1e-6.
- ``accum_steps=2`` against the JAX scan, with sgd so the parameters
  after the update are linear in the gradients: atol 1e-3 lr per entry
  over the gradient scale.
- A freeze flag, the schedule, the eval step and ``train_bn=True``.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from obman_train_tpu.config import TrainConfig as JTrain
from obman_train_tpu.models import BatchSpec as JSpec
from obman_train_tpu.train import steps as jsteps
from obman_train_tpu_torch import train
from obman_train_tpu_torch.config import TrainConfig
from obman_train_tpu_torch.models import BatchSpec
from obman_train_tpu_torch.weights import state_dict_from_jax
from tests.test_torch_handnet import CONTACT
from tests.test_torch_losses import loss_pair

torch.set_num_threads(2)


def _jax_grads(jnet, variables, batch):
    def total(params):
        return jnet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          batch, JSpec(), rngs={"points": jax.random.PRNGKey(0)})[0]

    return jax.jit(jax.value_and_grad(total))(variables["params"])


def _as_torch(tree):
    """A JAX params-shaped tree (params or gradients) in the port's keys."""
    return state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, tree)})


@pytest.fixture(scope="module")
def pair():
    return loss_pair(CONTACT, 2, 64, 0)


@pytest.fixture(scope="module")
def grads(pair):
    jnet, variables, pnet, batch = pair
    jtotal, jg = _jax_grads(jnet, variables, batch)
    opt = train.make_optimizer(TrainConfig(optimizer="sgd", lr=0.0, momentum=0.0), pnet)
    state = train.create_train_state(pnet, opt, TrainConfig(optimizer="sgd", lr=0.0))
    step = train.make_train_step(pnet, opt, BatchSpec(), device="cpu")
    state, losses = step(state, batch)
    got = {n: p.grad.clone() for n, p in pnet.named_parameters() if p.grad is not None}
    return float(jtotal), _as_torch(jg), float(losses["total_loss"]), got, state


def test_one_step_gradients_match_jax_key_by_key(grads):
    jtotal, want, ttotal, got, state = grads
    assert state.step == 1
    np.testing.assert_allclose(ttotal, jtotal, rtol=1e-4)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3 * scale + 1e-12, msg=name)


def _optax_and_port(tcfg_kw, pair, grads_tree):
    jnet, variables, pnet, batch = pair
    jcfg, pcfg = JTrain(**tcfg_kw), TrainConfig(**tcfg_kw)
    params = variables["params"]
    tx = jsteps.make_optimizer(jcfg, params)
    updates, _ = tx.update(grads_tree, tx.init(params), params)
    want = _as_torch(optax.apply_updates(params, updates))

    before = {n: p.detach().clone() for n, p in pnet.named_parameters()}
    try:
        opt = train.make_optimizer(pcfg, pnet)
        tgrads = _as_torch(grads_tree)
        for n, p in pnet.named_parameters():
            p.grad = tgrads[n].clone()
        opt.step()
        got = {n: p.detach().clone() for n, p in pnet.named_parameters()}
    finally:
        with torch.no_grad():
            for n, p in pnet.named_parameters():
                p.copy_(before[n])
                p.grad = None
    return before, want, got


@pytest.mark.parametrize("tcfg_kw", [
    dict(optimizer="adam", lr=1e-4),
    dict(optimizer="adam", lr=1e-4, weight_decay=1e-2),
    dict(optimizer="rms", lr=1e-4),
    dict(optimizer="sgd", lr=1e-2, momentum=0.9, weight_decay=1e-3),
])
def test_one_update_matches_optax(pair, tcfg_kw):
    jnet, variables, _, batch = pair
    _, jg = _jax_grads(jnet, variables, batch)
    _, want, got = _optax_and_port(tcfg_kw, pair, jg)
    lr = tcfg_kw["lr"]
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, rtol=1e-6, atol=1e-3 * lr, msg=name)


def test_freeze_flag_leaves_the_encoder_out(pair):
    jnet, variables, pnet, batch = pair
    _, jg = _jax_grads(jnet, variables, batch)
    kw = dict(optimizer="sgd", lr=1e-2, freeze_encoder=True)
    before, want, got = _optax_and_port(kw, pair, jg)
    labels = flax.traverse_util.flatten_dict(
        jsteps._freeze_labels(variables["params"], JTrain(**kw)), sep="/")
    n_frozen = sum(v == "frozen" for v in labels.values())
    frozen = [n for n in got if torch.equal(got[n], before[n])]
    assert frozen and all(n.startswith("base_net.") for n in frozen)
    assert len(frozen) == n_frozen
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, rtol=1e-6, atol=1e-5, msg=name)


def test_accum_steps_matches_jax_scan():
    jnet, variables, pnet, batch = loss_pair(CONTACT, 4, 32, 1)
    kw = dict(optimizer="sgd", lr=1e-3, momentum=0.9)
    tx = jsteps.make_optimizer(JTrain(**kw))
    jstate = jsteps.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32),
        regul_scale=jnp.ones((), jnp.float32))
    jstep = jsteps.make_train_step(jnet, tx, JSpec(), donate=False, accum_steps=2)
    jnew, jl = jstep(jstate, batch, jax.random.PRNGKey(0))
    want = _as_torch(jnew.params)
    old = _as_torch(variables["params"])

    opt = train.make_optimizer(TrainConfig(**kw), pnet)
    state = train.create_train_state(pnet, opt, TrainConfig(**kw))
    step = train.make_train_step(pnet, opt, BatchSpec(), accum_steps=2, device="cpu")
    state, tl = step(state, batch)
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    got = dict(pnet.named_parameters())
    for name, w in want.items():
        # the update lr * g, held as the gradients are (1e-3 of its scale)
        upd_scale = float((w - old[name]).abs().max())
        torch.testing.assert_close(got[name].detach(), w, rtol=0,
                                   atol=1e-3 * upd_scale + 1e-7, msg=name)
    with pytest.raises(ValueError, match="divisible"):
        step(state, {k: v[:3] for k, v in batch.items()})


def test_lr_schedule_matches_optax():
    for gamma, period in ((0.5, 300), (1.0, 300), (0.1, 7)):
        kw = dict(lr=1e-3, lr_decay_gamma=gamma, lr_decay_step=period)
        port = train.lr_schedule(TrainConfig(**kw), steps_per_epoch=3)
        jax_fn = jsteps.lr_schedule(JTrain(**kw), steps_per_epoch=3)
        for count in (0, 1, 3 * period - 1, 3 * period, 7 * period + 5):
            np.testing.assert_allclose(port(count), float(jax_fn(count)), rtol=1e-6)


def test_rmsprop_is_optax_rmsprop_over_several_steps():
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    gs = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(4)]
    tx = optax.chain(optax.add_decayed_weights(1e-2), optax.rmsprop(1e-2))
    params, st = jnp.asarray(p0), None
    st = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = train.OptaxRMSprop([p], lr=1e-2, weight_decay=1e-2)
    for g in gs:
        upd, st = tx.update(jnp.asarray(g), st, params)
        params = optax.apply_updates(params, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=1e-5, atol=1e-6)
    # the trap: torch's RMSprop (alpha 0.99, eps outside the root) differs
    q = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = torch.optim.RMSprop([q], lr=1e-2, weight_decay=1e-2)
    for g in gs:
        q.grad = torch.from_numpy(g)
        topt.step()
    assert not np.allclose(q.detach().numpy(), np.asarray(params), rtol=1e-3)


def test_eval_step_and_unported_modes(pair):
    _, _, pnet, batch = pair
    evaluate = train.make_eval_step(pnet, BatchSpec(), device="cpu")
    losses, out = evaluate(batch)
    with torch.no_grad():
        _, _, want = pnet({k: torch.from_numpy(v) for k, v in batch.items()}, BatchSpec())
    assert set(losses) == set(want)
    assert all(torch.equal(losses[k], want[k]) for k in want)
    assert set(out) == {"verts", "joints", "objpoints3d", "objtrans", "objscale"}
    assert not out["verts"].requires_grad

    opt = train.make_optimizer(TrainConfig(), pnet)
    with pytest.raises(NotImplementedError, match="later slice"):
        train.make_train_step(pnet, opt, BatchSpec(), train_bn=True, device="cpu")
    with pytest.raises(ValueError):
        train.make_optimizer(TrainConfig(optimizer="lbfgs"), pnet)
    other = train.create_train_state(pnet, train.make_optimizer(TrainConfig(), pnet),
                                     TrainConfig())
    with pytest.raises(ValueError, match="another net or optimizer"):
        train.make_train_step(pnet, opt, BatchSpec(), device="cpu")(other, batch)


def test_train_step_defaults_to_cuda(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    _, _, pnet, _ = pair
    opt = train.make_optimizer(TrainConfig(), pnet)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.make_train_step(pnet, opt, BatchSpec())
