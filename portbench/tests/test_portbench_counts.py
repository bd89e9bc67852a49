"""The frozen operation and byte counts against hand counts."""

import math

import pytest

from portbench.counts import flops


def test_resnet18_at_224_is_1_81_gmac():
    assert flops.resnet18_macs(224) / 1e9 == pytest.approx(1.8136, abs=5e-4)


def test_resnet18_scales_with_the_feature_maps():
    # every feature map of a 256 input is (256/224)^2 larger than at 224,
    # the stem and every stage alike (sizes 128, 64, 64, 32, 16, 8)
    assert flops.resnet18_macs(256) == 2_368_733_184


def test_raytri_counts_by_hand():
    # 2 batches, 3 points, 5 triangles: 30 pairs of 36 operations a batch,
    # and each triangle's own 23 once
    assert flops.raytri_ops(2, 3, 5) == 2 * (3 * 5 * 36 + 5 * 23)
    # in: 3 floats a point, 9 a triangle; out: one int32 count a point
    assert flops.raytri_bytes(2, 3, 5) == 2 * (3 * 12 + 5 * 36 + 3 * 4)


def test_nn_counts_by_hand():
    assert flops.nn_ops(2, 3, 4) == 2 * 3 * 4 * 9
    assert flops.nn_bytes(2, 3, 4, argmin=False) == 2 * ((3 + 4) * 12 + 3 * 4)
    assert flops.nn_bytes(2, 3, 4, argmin=True) == 2 * ((3 + 4) * 12 + 3 * 12)


def test_train_geometry_is_the_steps_queries():
    cfg = {"atlas": {"ico_divisions": 3},
           "contact": {"contact_lambda": 0.167, "collision_lambda": 0.167}}
    geo = flops.train_geometry(cfg)
    # Chamfer centred and final, both ways; hand-object both ways; the GT metric
    assert sorted(geo["nn"]) == sorted([(600, 642, True), (642, 600, True)] * 2
                                       + [(778, 642, True), (642, 778, True), (778, 600, False)])
    assert geo["raytri"] == [(778, 1280)]
    no_contact = dict(cfg, contact={"contact_lambda": 0.0, "collision_lambda": 0.0})
    assert flops.train_geometry(no_contact)["raytri"] == []


def test_training_is_three_forwards_and_the_geometry():
    cfg = {"mano": {"ncomps": 30, "base_neurons": [1024, 256]}, "atlas": {"ico_divisions": 3},
           "contact": {"contact_lambda": 0.167, "collision_lambda": 0.167}}
    fwd = flops.forward_flops(cfg, 256)
    assert 5.2e9 < fwd < 5.4e9
    geo = 4 * 600 * 642 * 9 + 2 * 778 * 642 * 9 + 778 * 600 * 9 + 778 * 1280 * 36 + 1280 * 23
    assert math.isclose(flops.train_flops(cfg, 256), 3 * fwd + geo)
