"""The port's entry points on the card (``cuda`` tests; JAX-free, run as
tests/test_torch_cuda.py says): ``cli.traineval`` and its flags, the
serving entry points and demo CLIs on its experiment, the bf16 and
point-cloud runs, and the grasp simulation and evaluation tools. Every
path's kernel launches are counted (``ops.kernels.LAUNCHES``).

The runs train at 64 px and B=8: tests/test_torch_cuda.py holds the same
step and forward at B=256 and 256 px, and the benchmark's ``correct`` gate
the step at B=512 and the served batch at B=256. The simulation's saved
batch is B=256, as the depth pass and ``intersect_vox`` meet it.
"""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from obman_train_tpu_torch.cli import traineval
from obman_train_tpu_torch.ops import nnsqdist, raytri
from obman_train_tpu_torch.ops.kernels import LAUNCHES
from obman_train_tpu_torch.train import loop
from obman_train_tpu_torch.utils.logging import parse_log_line
from tests.test_torch_cuda import (CONTACT, EVAL_LAUNCHES, TRAIN_LAUNCHES,
                                   UNFOLDED_TRAIN_LAUNCHES, _gt_batch, cuda)  # noqa: F401

pytestmark = pytest.mark.cuda

STEPS = 2  # train and val steps an epoch
ARGV = ["--train_datasets", "synthetic", "--val_datasets", "synthetic",
        "--mano_assets", "synthetic", "--synthetic_size", str(8 * STEPS), "--image_size", "64",
        "--train_batch", "8", "--test_batch", "8", "--workers", "2", "--display_freq", "0",
        "--atlas_predict_trans", "--atlas_predict_scale"]
CONTACT_FLAGS = ["--contact_lambda", "0.167", "--collision_lambda", "0.167"]
SIM_B = 256  # the saved batch the simulation reads


def _argv(exp, *extra, contact=True):
    return ARGV + (CONTACT_FLAGS if contact else []) + ["--exp_id", exp, *extra]


def _logged(exp, split):
    with open(os.path.join(exp, "logs", f"{split}.txt")) as f:
        return [parse_log_line(line) for line in f if line.strip()]


def _assert_finite_logs(exp):
    for split in ("train", "val"):
        logged = _logged(exp, split)
        assert logged, (exp, split)
        for epoch, values in logged:
            assert all(np.isfinite(v) for v in values.values()), (exp, split, epoch, values)


def _launched():
    return {k: v for k, v in LAUNCHES.items() if v}


@pytest.fixture(scope="module")
def card():
    """The card, with the CLIs' platform left to their default (cuda)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("OBMAN_PLATFORM", raising=False)
        yield torch.device("cuda")


def counting(passes, run):
    """An ``epoch_pass`` that appends to ``passes`` each pass's run name
    (``run["name"]``), epoch, update count at its start and launches a
    step; ``run["on_train"](state)``, where set, sees a train pass's state
    before it runs."""
    original = loop.epoch_pass

    def counted(loader, state, epoch, train=True, **kw):
        torch.cuda.synchronize()
        before, step0 = dict(LAUNCHES), state.step
        if train and "on_train" in run:
            run["on_train"](state)
        result = original(loader, state, epoch, train=train, **kw)
        torch.cuda.synchronize()
        steps = len(loader)
        passes.append({"run": run["name"], "train": train, "epoch": epoch, "step0": step0,
                       "launches": {k: (LAUNCHES[k] - before.get(k, 0)) / steps
                                    for k in LAUNCHES if LAUNCHES[k] != before.get(k, 0)}})
        return result

    return counted


@pytest.fixture(scope="module")
def runs(card, tmp_path_factory):
    """``cli.traineval.main()`` on the card, contact config, PyTorch's
    default TF32, every epoch pass counted: (a) 2 epochs; (b) ``--resume``
    to a third; (c) ``--resume --evaluate``; (d) 2 epochs with
    ``--device_augment``; (e) 1 epoch with ``--device_augment
    --display_freq 1``; (f) 1 epoch with ``--loader_processes``; (g) 1 epoch
    with ``--no_freeze_batchnorm``."""
    tmp = tmp_path_factory.mktemp("traineval")
    passes, run, out = [], {}, {"dirs": {}}

    def restored(state):
        """Whether a resumed run's optimizer holds the checkpoint's moments."""
        live, saved = state.optimizer.state_dict()["state"], out["checkpoint"]["optimizer"]
        out.setdefault("restored", live.keys() == saved["state"].keys() and all(
            torch.equal(v.cpu(), saved["state"][i][k].cpu()) for i, st in live.items()
            for k, v in st.items()))

    def main(name, exp, *extra, contact=True):
        run["name"] = name
        out["dirs"][name] = exp
        return traineval.main(_argv(exp, *extra, contact=contact))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "epoch_pass", counting(passes, run))
        exp = str(tmp / "run")
        main("a", exp, "--epochs", "2")
        out["checkpoint"] = torch.load(os.path.join(exp, "checkpoint.pth.tar"),
                                       map_location="cpu", weights_only=True)
        run["on_train"] = restored
        main("b", exp, "--epochs", "3", "--resume", exp)
        del run["on_train"]
        out["logged_val"] = _logged(exp, "val")[-1][1]
        _, out["evaluated"] = main("c", exp, "--resume", exp, "--evaluate")
        main("d", str(tmp / "device_augment"), "--epochs", "2", "--device_augment")
        main("e", str(tmp / "figures"), "--epochs", "1", "--device_augment",
             "--display_freq", "1")
        main("f", str(tmp / "loader_processes"), "--epochs", "1", "--loader_processes")
        main("g", str(tmp / "unfrozen"), "--epochs", "1", "--no_freeze_batchnorm")
    out.update(exp=exp, passes=passes, tmp=tmp)
    return out


def test_traineval_writes_resumes_and_evaluates(runs):
    """(a) writes its files and a checkpoint at epoch 2, update 4; (b)
    starts at epoch 2 with the update count and the optimizer's moments
    restored; (c) evaluates the checkpoint to the logged val metrics
    (1e-5 of max(1, |v|)); every run's logged values are finite."""
    exp = runs["exp"]
    for f in ("checkpoint.pth.tar", "model_best.pth.tar", "opt.json", "logs/train.txt",
              "logs/val.txt", "metrics.json", "pcks/val/epoch_1.pkl"):
        assert os.path.exists(os.path.join(exp, f)), f
    assert (runs["checkpoint"]["epoch"], runs["checkpoint"]["step"]) == (2, 2 * STEPS)
    first_b = next(p for p in runs["passes"] if p["run"] == "b" and p["train"])
    assert (first_b["epoch"], first_b["step0"]) == (2, 2 * STEPS)
    assert runs.get("restored") is True
    logged, val = runs["logged_val"], runs["evaluated"]
    for k in val:
        if k not in ("data_time", "batch_time"):
            assert abs(val[k] - logged[k]) <= 1e-5 * max(1.0, abs(logged[k])), k
    for exp in runs["dirs"].values():
        _assert_finite_logs(exp)


def test_traineval_launches_inside_the_loop(runs):
    """Every pass of every run: ``TRAIN_LAUNCHES`` a train step
    (``UNFOLDED_TRAIN_LAUNCHES`` with unfrozen BN, run g) and
    ``EVAL_LAUNCHES`` a val forward; a display step (run e) adds its
    figure's eval forward to the train step."""
    assert {p["run"] for p in runs["passes"]} == set("abcdefg")
    for p in runs["passes"]:
        want = EVAL_LAUNCHES
        if p["train"]:
            train = UNFOLDED_TRAIN_LAUNCHES if p["run"] == "g" else TRAIN_LAUNCHES
            want = {k: n + EVAL_LAUNCHES.get(k, 0) * (p["run"] == "e")
                    for k, n in train.items()}
        assert p["launches"] == want, p


def test_traineval_draws_every_figure(runs):
    exp = runs["dirs"]["e"]
    for split in ("train", "val"):
        for i in range(STEPS):
            assert os.path.exists(os.path.join(exp, f"images/{split}/epoch_0/img_{i:06d}.png"))
    assert os.path.exists(os.path.join(exp, "pcks/val/epoch_0.png"))


def _assert_demo_outputs(out, B, with_trans=False):
    want = {"verts": (B, 778, 3), "joints": (B, 21, 3), "objpoints3d": (B, 642, 3)}
    if with_trans:
        want.update(objtrans=(B, 3), objscale=(B, 1))
    assert {k: tuple(v.shape) for k, v in out.items()} == want
    for v in out.values():
        assert np.isfinite(np.asarray(v.cpu() if torch.is_tensor(v) else v)).all()


def test_streaming_dual_flip_at_full_width(cuda):
    """``DemoModel`` (hand_object, 256 px) on 128 camera frames of 480x640
    uint8 on the card, duplicated and flipped into one B=256 forward (the
    JAX bench's ``streaming_dual_flip``): the outputs' shapes, finite."""
    from obman_train_tpu_torch.config import ExperimentConfig
    from obman_train_tpu_torch.demo import DemoModel

    model = DemoModel(config=ExperimentConfig(mano_assets="synthetic"), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    cam = torch.randint(0, 256, (128, 480, 640, 3), generator=gen, device=cuda,
                        dtype=torch.uint8)
    flip = torch.arange(256, device=cuda) >= 128
    sides = (~flip).to(torch.int32)
    _assert_demo_outputs(model._infer(model._variables, torch.cat([cam, cam]), sides, flip), 256)


def test_demo_model_serves_the_experiment(runs, cuda):
    """The contact experiment reloaded in ``DemoModel`` (epoch 3): no kernel
    launched by ``predict_dual`` or a B=256 demo forward; ``predict_dual``
    equal bit for bit to the full HandNet forward (contact block and all)
    with the served encoder on the same preprocessed frames; that encoder
    the folded one, within 1e-5 of ``ResNet.forward``'s features (of the
    largest magnitude)."""
    from obman_train_tpu_torch.demo import DemoModel
    from obman_train_tpu_torch.models import INFER_SPEC
    from obman_train_tpu_torch.ops.image import preprocess_frames

    model = DemoModel(exp_dir=runs["exp"], device=cuda)
    assert model.cfg.model.need_collisions and model.epoch == 3
    frame = np.random.default_rng(11).integers(0, 256, (480, 640, 3)).astype(np.uint8)
    gen = torch.Generator(device=cuda).manual_seed(12)
    frames = torch.randint(0, 256, (256, 480, 640, 3), generator=gen, device=cuda,
                           dtype=torch.uint8)
    sides = (torch.arange(256, device=cuda) % 2).to(torch.int32)
    flip = torch.arange(256, device=cuda) % 3 == 0
    LAUNCHES.clear()
    dual = model.predict_dual(frame, hand_side="left")
    batch_out = model._infer(model._variables, frames, sides, flip)
    torch.cuda.synchronize()
    assert _launched() == {}
    _assert_demo_outputs(dual, 2, with_trans=True)
    _assert_demo_outputs(batch_out, 256, with_trans=True)
    with torch.inference_mode():
        images = preprocess_frames(torch.from_numpy(np.stack([frame, frame])).to(cuda)
                                   .to(torch.float32), model.image_size,
                                   flip=torch.tensor([False, True], device=cuda))
        _, full, _ = model.net({"images": images,
                                "sides": torch.tensor([1, 0], dtype=torch.int32, device=cuda)},
                               INFER_SPEC, no_loss=True, force_hand=True, force_objects=True,
                               encoder=model._serve.encode)
        nchw = images.permute(0, 3, 1, 2)
        served, _ = model._serve.encode(model.net.base_net, nchw)
        unfolded, _ = model.net.base_net(nchw)
    torch.cuda.synchronize()
    assert model.net.base_net in model._serve._folds
    assert "contact_info" in full and LAUNCHES[raytri.KERNEL] == 1
    for k in dual:
        np.testing.assert_array_equal(dual[k], full[k].cpu().numpy(), err_msg=k)
    assert float((served - unfolded).abs().max() / unfolded.abs().max()) < 1e-5


def test_demo_clis_on_the_experiment(runs, tmp_path):
    """``video_demo`` over 256 480x640 PNGs at ``--batch 64``, then with
    ``--attention --render --max_frames 8``, and ``image_demo``, on the
    contact experiment at PyTorch's default TF32: every frame's files, the
    printed count, the figure, and no kernel launched."""
    from PIL import Image

    from obman_train_tpu_torch.cli import image_demo, video_demo

    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    rng = np.random.default_rng(21)
    for i in range(256):  # smooth seeded frames: quick to encode and decode
        small = rng.integers(0, 256, (30, 40, 3)).astype(np.uint8)
        Image.fromarray(small.repeat(16, 0).repeat(16, 1)).save(
            frames_dir / f"f{i:04d}.png", compress_level=1)
    LAUNCHES.clear()
    for label, extra, n, kinds in (
            ("stream", [], 256, (".npz",)),
            ("render", ["--attention", "--render", "--max_frames", "8"], 8,
             (".npz", ".png.png", "_attention.png"))):
        out_dir = tmp_path / f"video_{label}"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            video_demo.main(["--frames_dir", str(frames_dir), "--resume", runs["exp"],
                             "--out_dir", str(out_dir), "--batch", "64", *extra])
        m = re.search(r"Processed (\d+) frames", buf.getvalue())
        assert m and int(m.group(1)) == n, buf.getvalue()
        files = os.listdir(out_dir)
        assert {k: sum(f.endswith(k) for f in files) for k in kinds} == dict.fromkeys(kinds, n)
    img_out = tmp_path / "image_demo.png"
    image_demo.main(["--image", str(frames_dir / "f0000.png"), "--resume", runs["exp"],
                     "--output", str(img_out)])
    assert img_out.stat().st_size > 0
    assert _launched() == {}


def test_bf16_and_point_cloud_runs_and_the_bf16_export(runs, card):
    """One-epoch runs with ``--compute_dtype bfloat16`` (contact flags) and
    ``--no_atlas_mesh`` (no contact terms: they need the mesh) log finite
    values; the bf16 experiment reloads in ``DemoModel`` and its export for
    the card serves B=256 like the live model: each output's dtype, a bf16
    output to its own resolution (2^-7 relative), float32 to rtol 1e-5,
    atol 2e-3 (TF32 off)."""
    from obman_train_tpu_torch.demo import DemoModel
    from obman_train_tpu_torch.demo.export import export_model, load_exported

    bf16, cloud = str(runs["tmp"] / "bf16"), str(runs["tmp"] / "cloud")
    traineval.main(_argv(bf16, "--epochs", "1", "--compute_dtype", "bfloat16"))
    traineval.main(_argv(cloud, "--epochs", "1", "--no_atlas_mesh", contact=False))
    for exp in (bf16, cloud):
        _assert_finite_logs(exp)
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model = DemoModel(exp_dir=bf16)
        assert model.cfg.model.compute_dtype == "bfloat16" and model.epoch == 1
        path = str(runs["tmp"] / "bf16.pt2")
        export_model(model, path, platforms=[model.device.type])
        serve = load_exported(path)
        gen = torch.Generator().manual_seed(5)
        frames = torch.randint(0, 256, (256, model.image_size, model.image_size, 3),
                               generator=gen, dtype=torch.uint8).to(card)
        sides = (torch.arange(256, device=card) % 2).to(torch.int32)
        flip = torch.arange(256, device=card) % 2 == 1
        live = model._infer(model._variables, frames, sides, flip)
        got = serve(frames, sides, flip)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    assert sorted(got) == sorted(live)
    for k, v in live.items():
        assert got[k].dtype == v.dtype, k
        rtol, atol = (2.0 ** -7, 0.0) if v.dtype == torch.bfloat16 else (1e-5, 2e-3)
        assert not ((got[k].float() - v.float()).abs() > atol + rtol * v.float().abs()).any(), k


# ---------------------------------------------------------------------------
# the grasp simulation and the evaluation tools, on the contact experiment
# ---------------------------------------------------------------------------


def _plain_volume(hv, hf, ov, of, pitch):
    """``intersect_vox`` through the plain inside test on the card."""
    from obman_train_tpu_torch.simulation.intersect import voxel_grid

    def occupancy(points, verts, faces):
        v = torch.from_numpy(np.asarray(verts, np.float32)).cuda()
        tri = v[torch.from_numpy(np.asarray(faces, np.int64)).cuda()][None]
        pts = torch.from_numpy(np.asarray(points, np.float32)).cuda()[None]
        return ~raytri.mesh_contains_points_plain(pts, tri)[0].cpu().numpy()

    grid = voxel_grid(hv, ov, pitch)
    if len(grid) == 0:
        return 0.0
    occ_h = occupancy(grid, hv, hf)
    if not occ_h.any():
        return 0.0
    return float(occupancy(grid[occ_h], ov, of).sum()) * pitch**3


@pytest.fixture(scope="module")
def simulated(runs):
    """``cli.traineval --resume --evaluate --save_results`` on the contact
    experiment with the simulation on, one val batch of ``SIM_B``: the
    depth pass's calls (their launches, inputs and depths) and the
    simulation's directory."""
    from obman_train_tpu_torch.simulation import savemano

    calls = []
    original = savemano.max_penetration_depths

    def depths(hands, objs, faces, device=None):
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        out = original(hands, objs, faces, device=device)
        calls.append({"B": len(hands), "inputs": (np.asarray(hands), np.asarray(objs), faces),
                      "out": out, "launches": {k: LAUNCHES[k] - before.get(k, 0)
                                               for k in LAUNCHES
                                               if LAUNCHES[k] != before.get(k, 0)}})
        return out

    exp = str(runs["tmp"] / "simulate")
    argv = _argv(exp, "--resume", runs["exp"], "--evaluate", "--save_results")
    for flag, value in (("--synthetic_size", SIM_B), ("--test_batch", SIM_B), ("--workers", 8)):
        argv[argv.index(flag) + 1] = str(value)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(savemano, "max_penetration_depths", depths)
        traineval.main(argv)
    sim_dirs = [os.path.join(r, "simulation_results") for r, _, files in
                os.walk(os.path.join(exp, "save_results")) if "batch_000000.pkl" in files]
    assert len(sim_dirs) == 1
    return {"calls": calls, "sim_dir": os.path.dirname(sim_dirs[0]),
            "results": sim_dirs[0]}


def test_evaluate_simulates_the_saved_batch(simulated):
    """The C++ stepper simulates all ``SIM_B`` samples; the depth pass is one
    call at B=``SIM_B`` that launches K1 once and one min-only sweep, and
    its depths equal the plain route's on the card bit for bit."""
    with open(os.path.join(simulated["results"], "results.json")) as f:
        summary = json.load(f)["summary"]
    assert summary["backend"] == "native" and summary["sample_nb"] == SIM_B
    calls = simulated["calls"]
    assert [c["B"] for c in calls] == [SIM_B]
    assert calls[0]["launches"] == {raytri.KERNEL: 1, nnsqdist.KERNEL_MIN: 1}
    hands, objs, faces = calls[0]["inputs"]
    hv, ov = torch.from_numpy(hands.astype(np.float32)).cuda(), \
        torch.from_numpy(objs.astype(np.float32)).cuda()
    exterior = raytri.mesh_contains_points_plain(
        hv, ov[:, torch.from_numpy(np.asarray(faces, np.int64)).cuda()]).cpu().numpy()
    min_sq = nnsqdist.nn_dir_plain(hv, ov)[0].cpu().numpy()
    np.testing.assert_array_equal(calls[0]["out"],
                                  (np.sqrt(np.maximum(min_sq, 0)) * ~exterior).max(axis=1))


def test_simulate_intersect_on_the_saved_batch(simulated):
    """``cli.simulate --intersect`` on the directory: both summaries of
    ``SIM_B`` samples, at most two K1 launches a sample for the voxels
    (besides the depth pass's one), the first 8 samples' volumes equal to
    the plain route's."""
    from obman_train_tpu_torch.cli import simulate as simulate_cli
    from obman_train_tpu_torch.simulation import intersect, savemano

    sim_dir = simulated["sim_dir"]
    LAUNCHES.clear()
    summary = simulate_cli.main(["--exp_id", sim_dir, "--intersect", "--workers", "8"])
    torch.cuda.synchronize()
    with open(os.path.join(sim_dir, "intersect_results", "results.json")) as f:
        inter = json.load(f)
    assert summary["sample_nb"] == inter["sample_nb"] == SIM_B
    assert 0 <= LAUNCHES[raytri.KERNEL] - 1 <= 2 * SIM_B
    samples = savemano.load_batch_info(os.path.join(sim_dir, "batch_000000.pkl"),
                                       compute_depth=False)[:8]
    for s in samples:
        args = (s["hand_verts"] * 0.001, s["hand_faces"], s["obj_verts"] * 0.001, s["obj_faces"])
        assert intersect.intersect_vox(*args) == _plain_volume(*args, 0.005)


def test_triage_on_the_saved_batch(simulated, tmp_path):
    """``triage`` of the directory: its Chamfer scores (one batched call on
    the card) within 1e-6 relative of the plain route's, and its files."""
    from obman_train_tpu_torch.visualize import triage

    sim_dir = simulated["sim_dir"]
    res = triage.triage(sim_dir, out_dir=str(tmp_path), n_show=3)
    samples = triage.load_eval_samples(sim_dir)
    preds = torch.from_numpy(np.stack([s["obj_verts"] for s in samples])).cuda()
    gts = torch.from_numpy(np.stack([s["gt_objpoints3d"] for s in samples])).cuda()
    plain = (nnsqdist.nn_dir_plain(preds, gts)[0].mean(1)
             + nnsqdist.nn_dir_plain(gts, preds)[0].mean(1)).cpu().numpy()
    assert float(np.max(np.abs(res["scores"] - plain) / np.abs(plain))) <= 1e-6
    for group in ("best", "median", "worst"):
        for ext in ("png", "html"):
            assert (tmp_path / f"{group}.{ext}").exists(), (group, ext)


def test_inspect_feature_grads_on_cuda(cuda):
    """``inspect_feature_grads`` at 256 px, B=32, contact flags: finite
    norms; on 2 frames of 64 px the card's norms within 1e-3 relative of
    the CPU port's on the same weights (TF32 off)."""
    import copy

    from obman_train_tpu_torch.models import BatchSpec
    from obman_train_tpu_torch.train.debug import inspect_feature_grads
    from tests.test_torch_cuda import _seeded

    net = _seeded(CONTACT, cuda)
    norms = inspect_feature_grads(net, _gt_batch(32, 256, 6), BatchSpec())
    assert norms and all(np.isfinite(v) for v in norms.values())
    small = _gt_batch(2, 64, 7)
    on_card = inspect_feature_grads(net, small, BatchSpec())
    on_cpu = inspect_feature_grads(copy.deepcopy(net).cpu(), small, BatchSpec(), device="cpu")
    assert on_card.keys() == on_cpu.keys()
    for k, v in on_cpu.items():
        assert abs(on_card[k] - v) <= 1e-3 * max(abs(v), 1e-30), k
