"""The port's figures (``visualize/``) and the training figures of
``cli.traineval``, on the CPU.

- ``visualize_batch`` (with the contact segment panels), ``save_pck_img``,
  ``draw_joints_on_image`` and the HTML mesh export give what the JAX
  package's give on the same inputs: the same pixels, the same scene data
  (the visualisation cases of the JAX ``tests/test_demo_viz.py``).
- ``cli.traineval --display_freq 1`` writes ``img_%06d.png`` for every
  train and val batch and the PCK curve image beside the PCK pickle; a
  train figure shows the weights before that batch's update; a figure that
  fails to draw is reported and the run goes on.
- Without matplotlib (the GPU host has PIL only) the same calls draw the
  PIL raster figures of ``visualize/raster.py``.
"""

import json
import os
import re
import sys

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

matplotlib.use("Agg")

from obman_train_tpu.ops.contact import compute_contact_loss as jax_contact  # noqa: E402
from obman_train_tpu.visualize import displaymano as jdisplay  # noqa: E402
from obman_train_tpu.visualize import html_mesh as jhtml  # noqa: E402
from obman_train_tpu.visualize import viz2d as jviz2d  # noqa: E402
from obman_train_tpu_torch.assets import icosphere, synthetic_mano_assets  # noqa: E402
from obman_train_tpu_torch.cli import traineval as pcli  # noqa: E402
from obman_train_tpu_torch.ops.contact import compute_contact_loss  # noqa: E402
from obman_train_tpu_torch.train import loop  # noqa: E402
from obman_train_tpu_torch.visualize import displaymano, html_mesh, viz2d, viz3d  # noqa: E402

torch.set_num_threads(2)


def _pixels(path):
    return np.asarray(Image.open(path))


def _batch_and_results(rng):
    overts, _ = icosphere(3)
    batch = {
        "images": rng.random((2, 64, 64, 3)).astype(np.float32) - 0.5,
        "verts3d": rng.normal(0, 30, (2, 778, 3)).astype(np.float32),
        "objpoints3d": rng.normal(0, 30, (2, 600, 3)).astype(np.float32),
    }
    results = {
        "verts": rng.normal(0, 30, (2, 778, 3)).astype(np.float32),
        "objpoints3d": np.broadcast_to(overts * 30, (2, 642, 3)).astype(np.float32),
        "joints2d": rng.uniform(0, 64, (2, 21, 2)).astype(np.float32),
    }
    return batch, results


def test_visualize_batch_and_pck_as_jax(tmp_path, rng):
    faces = synthetic_mano_assets("right").faces
    _, ofaces = icosphere(3)
    batch, results = _batch_and_results(rng)
    p = displaymano.visualize_batch(str(tmp_path / "port.png"), batch, results, faces, ofaces)
    j = jdisplay.visualize_batch(str(tmp_path / "jax.png"), batch, results, faces, ofaces)
    assert os.path.getsize(p) > 1000
    np.testing.assert_array_equal(_pixels(p), _pixels(j))
    for overlay in ("stereo_test", "stereo_all", None):
        args = (np.linspace(0, 50, 20), np.linspace(0, 1, 20), 0.5)
        p = displaymano.save_pck_img(*args, str(tmp_path / "pck_port.png"), overlay=overlay)
        j = jdisplay.save_pck_img(*args, str(tmp_path / "pck_jax.png"), overlay=overlay)
        np.testing.assert_array_equal(_pixels(p), _pixels(j))


def test_visualize_batch_contact_segments_as_jax(tmp_path, rng):
    """The attraction and repulsion segment panels (reference
    displaymano.py:21-63, 270-330) from the port's contact block."""
    faces = synthetic_mano_assets("right").faces
    overts, ofaces = icosphere(3)
    verts = rng.normal(0, 25, (2, 778, 3)).astype(np.float32)
    obj = np.broadcast_to(overts * 30, (2, 642, 3)).astype(np.float32)
    _, _, info, _ = compute_contact_loss(
        torch.from_numpy(verts), torch.from_numpy(obj.copy()),
        torch.from_numpy(ofaces.astype(np.int64)), contact_mode="dist_tanh",
        contact_zones="zones")
    info = {k: v.numpy() for k, v in info.items()}
    _, _, jinfo, _ = jax_contact(jnp.asarray(verts), jnp.asarray(obj), jnp.asarray(ofaces),
                                 contact_mode="dist_tanh", contact_zones="zones")
    for key in ("attraction_masks", "repulsion_masks"):
        np.testing.assert_array_equal(info[key], np.asarray(jinfo[key]))
        assert info[key].any()
    batch = {"images": rng.random((2, 64, 64, 3)).astype(np.float32) - 0.5}
    results = {"verts": verts, "objpoints3d": obj, "contact_info": info}
    p = displaymano.visualize_batch(str(tmp_path / "port.png"), batch, results, faces, ofaces)
    plain = displaymano.visualize_batch(str(tmp_path / "plain.png"), batch,
                                        {"verts": verts, "objpoints3d": obj}, faces, ofaces)
    j = jdisplay.visualize_batch(str(tmp_path / "jax.png"), batch, results, faces, ofaces)
    np.testing.assert_array_equal(_pixels(p), _pixels(j))
    assert not np.array_equal(_pixels(p), _pixels(plain))  # the segments are drawn


def test_joints_drawing_and_3d_helpers_as_jax(rng):
    img = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    joints = rng.uniform(0, 64, (21, 2))
    np.testing.assert_array_equal(viz2d.draw_joints_on_image(img, joints),
                                  jviz2d.draw_joints_on_image(img, joints))
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(1, 2, 1)
    viz2d.visualize_joints_2d(ax, joints, joint_idxs=True)
    assert len(ax.lines) == 20  # five chains of four bones
    ax3 = fig.add_subplot(1, 2, 2, projection="3d")
    pts = rng.normal(0, 10, (21, 3))
    viz3d.visualize_joints_3d(ax3, pts)
    viz3d.equal_aspect_3d(ax3, pts)
    spans = [np.diff(lim)[0] for lim in (ax3.get_xlim(), ax3.get_ylim(), ax3.get_zlim())]
    np.testing.assert_allclose(spans, spans[0])
    plt.close(fig)


def test_html_meshes_as_jax(tmp_path, rng):
    a = synthetic_mano_assets("right")
    overts, ofaces = icosphere(1)
    p = html_mesh.export_sample_html(str(tmp_path / "p.html"), a.v_template, a.faces,
                                     overts, ofaces)
    j = jhtml.export_sample_html(str(tmp_path / "j.html"), a.v_template, a.faces,
                                 overts, ofaces)

    def scene(path):
        text = open(path).read()
        return json.loads(re.search(r"const meshes = (\[.*?\]);\n", text, re.S).group(1))

    assert scene(p) == scene(j) and len(scene(p)) == 2
    assert "<title>obman_train_tpu_torch meshes</title>" in open(p).read()


BASE = ["--train_datasets", "synthetic", "--val_datasets", "synthetic", "--mano_assets",
        "synthetic", "--synthetic_size", "8", "--image_size", "64", "--train_batch", "4",
        "--test_batch", "4", "--workers", "2", "--epochs", "1", "--atlas_predict_trans",
        "--contact_lambda", "0.167", "--collision_lambda", "0.167"]


def _images(exp):
    return sorted(os.path.relpath(os.path.join(d, f), exp)
                  for d, _, files in os.walk(os.path.join(exp, "images")) for f in files)


def test_traineval_draws_figures_and_the_pck_image(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OBMAN_PLATFORM", "cpu")
    drawn = []
    draw = loop._draw_figure
    monkeypatch.setattr(loop, "_draw_figure", lambda *a: (drawn.append(a), draw(*a)))
    exp = str(tmp_path / "run")
    fresh = pcli.main(BASE + ["--exp_id", str(tmp_path / "fresh"), "--epochs", "0"])[0].net
    pcli.main(BASE + ["--exp_id", exp, "--display_freq", "1"])
    assert "not ported" not in capsys.readouterr().out
    assert _images(exp) == [f"images/{s}/epoch_0/img_00000{i}.png"
                            for s in ("train", "val") for i in (0, 1)]
    assert os.path.getsize(os.path.join(exp, "pcks", "val", "epoch_0.png")) > 1000
    assert os.path.exists(os.path.join(exp, "pcks", "val", "epoch_0.pkl"))
    # the first train figure is the forward of the weights before any update,
    # the second one's weights have moved; the contact block's outputs ride along
    (_, idx0, batch0, fig0, _), (_, idx1, batch1, fig1, _) = drawn[:2]
    assert (idx0, idx1) == (0, 1)
    assert set(fig0["contact_info"]) == {"attraction_masks", "repulsion_masks",
                                         "contact_points", "min_dists", "batch_ious"}
    from obman_train_tpu_torch.data.loader import derive_spec

    for batch, fig, equal in ((batch0, fig0, True), (batch1, fig1, False)):
        tensors = {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
        with torch.no_grad():
            _, want, _ = fresh(tensors, derive_spec(tensors))
        assert np.array_equal(fig["verts"], want["verts"][:5].numpy()) == equal
        assert fig["verts"].shape == (4, 778, 3)

    # --display_freq 2 draws every other batch
    pcli.main(BASE + ["--exp_id", str(tmp_path / "every2"), "--display_freq", "2"])
    assert _images(str(tmp_path / "every2")) == ["images/train/epoch_0/img_000000.png",
                                                 "images/val/epoch_0/img_000000.png"]


def test_a_figure_that_fails_is_reported(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OBMAN_PLATFORM", "cpu")

    def broken(*a, **k):
        raise RuntimeError("no canvas")

    monkeypatch.setattr(displaymano, "visualize_batch", broken)
    monkeypatch.setattr(displaymano, "save_pck_img", broken)
    state, metrics = pcli.main(BASE + ["--exp_id", str(tmp_path / "run"), "--display_freq", "1"])
    out = capsys.readouterr().out
    assert out.count("visualize_batch skipped: RuntimeError: no canvas") == 4
    assert "pck plot skipped: RuntimeError: no canvas" in out
    assert state.step == 2 and os.path.exists(tmp_path / "run" / "pcks" / "val" / "epoch_0.pkl")


@pytest.fixture
def no_matplotlib(monkeypatch):
    """A host without matplotlib (as the GPU machine the port runs on)."""
    for name in ("matplotlib", "matplotlib.pyplot", "mpl_toolkits", "mpl_toolkits.mplot3d"):
        monkeypatch.setitem(sys.modules, name, None)


def test_figures_without_matplotlib_are_raster(tmp_path, rng, no_matplotlib):
    """Without matplotlib the same calls draw the PIL raster figures: the
    grid of 4 rows by the samples, contact segments, the PCK plot."""
    from obman_train_tpu_torch.visualize import raster

    faces = synthetic_mano_assets("right").faces
    _, ofaces = icosphere(3)
    batch, results = _batch_and_results(rng)
    mask = np.zeros((2, 778), bool)
    mask[:, ::50] = True
    results["contact_info"] = {"attraction_masks": mask, "repulsion_masks": ~mask,
                               "contact_points": results["verts"] + 5.0}
    p = displaymano.visualize_batch(str(tmp_path / "grid.png"), batch, results, faces, ofaces)
    grid = _pixels(p)
    assert grid.shape == (4 * raster.TILE, 2 * raster.TILE, 3)
    plain = _pixels(raster.visualize_batch(str(tmp_path / "plain.png"), batch,
                                           {k: v for k, v in results.items()
                                            if k != "contact_info"}))
    assert not np.array_equal(grid, plain)  # the segments are drawn
    p = displaymano.save_pck_img(np.linspace(0, 50, 20), np.linspace(0, 1, 20), 0.5,
                                 str(tmp_path / "pck.png"), overlay="stereo_test")
    assert _pixels(p).shape == (400, 400, 3) and os.path.getsize(p) > 1000
    panel = raster.mesh_panel(rng.integers(0, 256, (48, 64, 3)).astype(np.uint8),
                              rng.uniform(0, 48, (21, 2)), [(results["verts"][0], "b")])
    assert panel.shape == (48, 64 + 48, 3) and panel.dtype == np.uint8


def test_traineval_figures_without_matplotlib(tmp_path, monkeypatch, capsys, no_matplotlib):
    monkeypatch.setenv("OBMAN_PLATFORM", "cpu")
    exp = str(tmp_path / "run")
    pcli.main(BASE + ["--exp_id", exp, "--display_freq", "1"])
    assert "skipped" not in capsys.readouterr().out
    assert len(_images(exp)) == 4
    assert os.path.getsize(os.path.join(exp, "pcks", "val", "epoch_0.png")) > 1000
