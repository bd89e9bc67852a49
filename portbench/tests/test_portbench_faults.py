"""The comparison that decides ``correct`` fails what it must: the
control (the program's own bfloat16 path in place of float32) and a
timed path broken underneath, each driven through the rest of a run on
the CPU at a tiny size. The limits are the cells' own (workloads/*.json)."""

import numpy as np
import pytest
import torch

from portbench.tests.tiny import run_tiny


@pytest.mark.parametrize("cell", ["contact_train_step", "hand_object_batch_b256"])
def test_control_in_bfloat16_is_not_correct(cell):
    extra = {"model_override": {"compute_dtype": "bfloat16"}}
    if cell == "hand_object_batch_b256":
        extra["model_override"]["image_size"] = 64
    result = run_tiny(cell, **extra)
    assert not result["correct"], result["checks"]


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    assert not run_tiny("contact_train_step")["correct"]


def test_half_the_batch_left_out(monkeypatch):
    from obman_train_tpu_torch.train import steps

    whole = steps._to_device

    def half(batch, device):
        out = whole(batch, device)
        return {k: v[: v.shape[0] // 2] if v.ndim else v for k, v in out.items()}

    monkeypatch.setattr(steps, "_to_device", half)
    assert not run_tiny("contact_train_step")["correct"]


def test_a_loss_altered_where_it_is_made(monkeypatch):
    from obman_train_tpu_torch.models import handnet

    made = handnet.compute_atlas_loss

    def altered(*a, **k):
        total, losses = made(*a, **k)
        return total * 1.01, losses

    monkeypatch.setattr(handnet, "compute_atlas_loss", altered)
    assert not run_tiny("contact_train_step")["correct"]


def test_an_answer_altered_where_it_is_made(monkeypatch):
    from obman_train_tpu_torch.demo import inference

    made = inference.HostCopy.get

    def altered(self):
        out = made(self)
        out["verts"] = out["verts"] * np.float32(1.05)  # a 5 % error in the vertices
        return out

    monkeypatch.setattr(inference.HostCopy, "get", altered)
    assert not run_tiny("hand_object_batch_b256")["correct"]


def test_half_the_frames_left_out(monkeypatch):
    from obman_train_tpu_torch.demo import inference

    made = inference.DemoModel._infer

    def half(self, variables, frames, sides, flip):
        n = frames.shape[0] // 2
        out = made(self, variables, frames[:n], sides[:n], flip[:n])
        return {k: torch.cat([v, v]) for k, v in out.items()}

    monkeypatch.setattr(inference.DemoModel, "_infer", half)
    assert not run_tiny("hand_object_batch_b256")["correct"]


def test_an_inside_test_off_by_one(monkeypatch):
    """The hand-object inside test (K1 on the card) with its crossing count
    one off: every vertex changes sides."""
    from obman_train_tpu_torch.ops import contact

    made = contact.mesh_contains_points
    monkeypatch.setattr(contact, "mesh_contains_points", lambda p, t: ~made(p, t))
    assert not run_tiny("contact_train_step")["correct"]
