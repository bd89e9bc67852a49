"""The port's SyncBN step (``train.make_train_step_syncbn``) on 2 gloo ranks
against the JAX package's on a 2-device CPU mesh: the twins of
``tests/test_syncbn.py``, on the same weights (``weights.py``), batch and
config (the contact config with ``sync_bn=True``, ResNet-18 at 64 px, B=4,
dropout 0, sgd at lr 1e-3).

- The BN running means and variances within 1e-5 of JAX's (its test's
  bound); the encoders' also within 1e-5 of the one-process unfrozen
  step's (the definition of SyncBN: the global batch's statistics), while
  the atlas decoder's, which the JAX model builds without the data axis
  (``models/handnet.py:77-80``), are each rank's own, averaged;
- the parameters after the step within 1e-2 of each tensor's update scale
  (``test_torch_train_bn.py``'s gradient bound where each BN normalizes 2
  rows, its two microbatches of 2: here the atlas decoder's BNs normalize
  each rank's 2 rows; measured 2.2e-3, on the decoder's BN biases, where
  flax's E[x^2] - E[x]^2 in float32 and the port's float64 sums part), and
  bit for bit equal on both ranks;
- the losses to rtol 1e-4 of JAX's, the contact terms included: as in the
  JAX ``shard_map`` body, each rank normalizes its masked means by its own
  rows' mask count and the ranks' losses are averaged (measured here
  against JAX: within 3e-5 relative);
- it needs ``ModelConfig(sync_bn=True)``, as the JAX step does.
"""

import numpy as np
import pytest
import torch

import jax
from obman_train_tpu_torch import train
from obman_train_tpu_torch.config import TrainConfig
from obman_train_tpu_torch.models import BatchSpec
from obman_train_tpu_torch.weights import state_dict_from_jax
from tests.test_torch_distributed import (
    SGD,
    assert_updates_match,
    jax_mesh_step,
    run_step_ranks,
)
from tests.test_torch_handnet import CONTACT
from tests.test_torch_losses import loss_pair

torch.set_num_threads(2)

SYNC = dict(CONTACT, sync_bn=True)
SYNCBN_UPDATE_ATOL = 1e-2  # of each tensor's update scale


@pytest.fixture(scope="module")
def syncbn(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("syncbn")
    jnet, variables, pnet, batch = loss_pair(SYNC, 4, 64, 5)
    wait = run_step_ranks(tmp, pnet, batch, [{"name": "syncbn", "syncbn": True}], SGD)
    jnew, jl = jax_mesh_step(jnet, variables, batch, True, syncbn=True)
    # the one-process unfrozen step on the same weights: the global batch's
    # statistics by definition
    old = {k: v.clone() for k, v in pnet.state_dict().items()}
    opt = train.make_optimizer(TrainConfig(**SGD), pnet)
    state = train.create_train_state(pnet, opt, TrainConfig(**SGD))
    train.make_train_step(pnet, opt, BatchSpec(), train_bn=True, device="cpu")(state, batch)
    single = {k: v.clone() for k, v in pnet.state_dict().items()}
    return dict(ranks=wait(), jnew=jnew, jl=jl, variables=variables, old=old, single=single)


def _stats_keys(sd):
    return [k for k in sd if k.endswith(("running_mean", "running_var"))]


def test_syncbn_train_step(syncbn):
    ranks, jnew, jl = syncbn["ranks"], syncbn["jnew"], syncbn["jl"]
    got = ranks[0]["syncbn"]
    # the parameters stay replicated: both ranks bit for bit
    for k, v in got["state_dict"].items():
        assert torch.equal(v, ranks[1]["syncbn"]["state_dict"][k]), k
    assert np.isfinite(got["losses"]["total_loss"])
    assert set(got["losses"]) == set(jl)
    for k in jl:
        np.testing.assert_allclose(got["losses"][k], float(jl[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    old = state_dict_from_jax(syncbn["variables"])
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jnew.params)})
    assert_updates_match(got["state_dict"], want, old, SYNCBN_UPDATE_ATOL, "syncbn")
    # the running means moved away from where they were
    assert not torch.equal(got["state_dict"]["base_net.bn1.running_mean"],
                           old["base_net.bn1.running_mean"])


def test_syncbn_matches_global_batch_stats(syncbn):
    got = syncbn["ranks"][0]["syncbn"]["state_dict"]
    want = state_dict_from_jax({"params": syncbn["jnew"].params,
                                "batch_stats": syncbn["jnew"].batch_stats})
    keys = _stats_keys(want)
    assert len(keys) == 2 * 23
    encoder = [k for k in keys if k.startswith("base_net.")]
    assert len(encoder) == 2 * 20
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    for k in encoder:  # synchronized: the global batch's statistics
        np.testing.assert_allclose(got[k].numpy(), syncbn["single"][k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    # the atlas decoder's BNs carry no data axis (JAX handnet.py:77-80): each
    # rank's own statistics, averaged; another value than the global one
    dec = "atlas_branch.decoder.bn1.running_var"
    assert not np.allclose(got[dec].numpy(), syncbn["single"][dec].numpy(), atol=1e-3)


def test_syncbn_needs_the_config_flag():
    _, _, pnet, _ = loss_pair(CONTACT, 2, 32, 0)
    opt = train.make_optimizer(TrainConfig(**SGD), pnet)
    with pytest.raises(ValueError, match="sync_bn=True"):
        train.make_train_step_syncbn(pnet, opt, BatchSpec(), device="cpu")
