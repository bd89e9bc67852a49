"""``torch.export`` serving artifacts of the port (``demo/export.py``,
``cli/export.py``) on the CPU, 64 px, a contact-config model (the exported
program leaves out the contact block, as the demo path does).

- a symbolic-batch artifact serves batches of 1 and 3 and matches the live
  ``DemoModel._infer`` (rtol 1e-5, atol 2e-3, the JAX package's bound);
- ``cli.export --batch_size 2 --smoke``: a static batch, the smoke check,
  and a rejected batch of 3;
- ``ExportedModel`` serves ``predict``/``predict_dual`` and both demo CLIs
  (``--from_export``) without model code; no sidecar, no model;
- ``load_exported`` runs in a process where ``obman_train_tpu_torch``
  cannot be imported at all.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from obman_train_tpu_torch.config import AtlasConfig, ContactConfig, ExperimentConfig, ModelConfig
from obman_train_tpu_torch.demo import DemoModel
from obman_train_tpu_torch.demo.export import ExportedModel, export_model, load_exported

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
CONFIG = ExperimentConfig(mano_assets="synthetic", model=ModelConfig(
    image_size=SIZE, atlas=AtlasConfig(predict_trans=True, predict_scale=True),
    contact=ContactConfig(contact_lambda=0.167, collision_lambda=0.167)))


@pytest.fixture(scope="module")
def model():
    return DemoModel(config=CONFIG, device="cpu")


@pytest.fixture(scope="module")
def artifact(model, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "model.pt2")
    return path, export_model(model, path)


def _inputs(B, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)),
            torch.from_numpy(rng.integers(0, 2, (B,)).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 2, (B,)).astype(bool)))


def _assert_served(model, out, inputs):
    live = model._infer(model._variables, *inputs)
    assert sorted(out) == sorted(live) == ["joints", "objpoints3d", "objscale", "objtrans",
                                           "verts"]
    for k in live:
        np.testing.assert_allclose(out[k].numpy(), live[k].numpy(), rtol=1e-5, atol=2e-3,
                                   err_msg=k)


def test_symbolic_batch_round_trip(model, artifact):
    path, info = artifact
    assert info["batch"] == "symbolic" and info["platforms"] == ["cpu"]
    assert info["image_size"] == SIZE and info["bytes"] == os.path.getsize(path) > 1000
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    assert set(meta) == {"image_size", "platforms", "batch", "hand_faces", "obj_faces"}
    serve = load_exported(path)
    for B in (1, 3):
        inputs = _inputs(B, B)
        _assert_served(model, serve(*inputs), inputs)
    with pytest.raises(ValueError, match="no program for meta"):
        serve(*(t.to("meta") for t in _inputs(1, 0)))


def test_cli_export_static_batch_smoke(tmp_path, monkeypatch, capsys):
    from obman_train_tpu_torch.cli import export as cli_export

    monkeypatch.setenv("OBMAN_PLATFORM", "cpu")
    exp = tmp_path / "exp"
    exp.mkdir()
    CONFIG.to_json(str(exp / "opt.json"))
    out = str(tmp_path / "static.pt2")
    info = cli_export.main(["--resume", str(exp), "--out", out, "--batch_size", "2",
                            "--smoke", "--platforms", "cpu"])
    assert info["batch"] == 2 and "smoke OK" in capsys.readouterr().out
    serve = load_exported(out)
    model = DemoModel(exp_dir=str(exp), device="cpu")
    inputs = _inputs(2, 5)
    _assert_served(model, serve(*inputs), inputs)
    with pytest.raises(Exception):  # a pinned batch rejects another
        serve(*_inputs(3, 5))
    with pytest.raises(ValueError, match="platform 'tpu'"):
        export_model(model, str(tmp_path / "x.pt2"), platforms=["tpu"])


def test_exported_model_serves_the_demos(model, artifact, tmp_path, monkeypatch):
    path, _ = artifact
    served = ExportedModel(path, device="cpu")
    assert served.image_size == SIZE and served.batch == "symbolic"
    np.testing.assert_array_equal(served.hand_faces, model.hand_faces)
    np.testing.assert_array_equal(served.obj_faces, model.obj_faces)
    # the program takes frames of its own size, as the JAX export does
    frame = np.random.default_rng(0).integers(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
    for got, want in ((served.predict(frame, "right", True), model.predict(frame, "right", True)),
                      (served.predict_dual(frame), model.predict_dual(frame))):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-3, err_msg=k)
    with pytest.raises(ValueError, match="ONE"):  # the misuse guard travels too
        served.predict(frame[None])

    from obman_train_tpu_torch.cli import image_demo, video_demo

    monkeypatch.setenv("OBMAN_PLATFORM", "cpu")
    Image.fromarray(frame).save(tmp_path / "in.png")
    image_demo.main(["--image", str(tmp_path / "in.png"), "--from_export", path,
                     "--output", str(tmp_path / "out.png")])
    assert np.asarray(Image.open(tmp_path / "out.png")).size > 0
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i in range(3):
        Image.fromarray(np.roll(frame, i, axis=1)).save(frames_dir / f"f{i}.png")
    with pytest.warns(UserWarning, match="attention"):
        stats = video_demo.main(["--frames_dir", str(frames_dir), "--from_export", path,
                                 "--out_dir", str(tmp_path / "vid"), "--batch", "2",
                                 "--attention"])
    assert stats["frames"] == 3 and len(list((tmp_path / "vid").glob("*.npz"))) == 3


def test_exported_model_needs_its_sidecar(artifact, tmp_path):
    path, _ = artifact
    bare = str(tmp_path / "bare.pt2")
    with open(path, "rb") as src, open(bare, "wb") as dst:
        dst.write(src.read())
    with pytest.raises(FileNotFoundError, match="meta.json"):
        ExportedModel(bare, device="cpu")


def test_load_exported_needs_only_torch(model, artifact, tmp_path):
    """A fresh process in which every import of the port fails loads the
    artifact through ``demo/export.py`` read by its path, and serves the
    live model's outputs."""
    path, _ = artifact
    inputs = _inputs(3, 9)
    np.savez(tmp_path / "inputs.npz", *[t.numpy() for t in inputs])
    code = "\n".join([
        "import importlib.util, sys",
        "import numpy as np, torch",
        "sys.modules['obman_train_tpu_torch'] = None  # importing the port raises",
        f"spec = importlib.util.spec_from_file_location('artifact_loader', "
        f"{os.path.join(REPO, 'obman_train_tpu_torch', 'demo', 'export.py')!r})",
        "mod = importlib.util.module_from_spec(spec)",
        "spec.loader.exec_module(mod)",
        f"d = np.load({str(tmp_path / 'inputs.npz')!r})",
        f"out = mod.load_exported({path!r})(*(torch.from_numpy(d[f'arr_{{i}}']) for i in range(3)))",
        f"np.savez({str(tmp_path / 'out.npz')!r}, **{{k: v.numpy() for k, v in out.items()}})",
        "bad = [m for m in sys.modules",
        "       if m.startswith('obman_train_tpu') and sys.modules[m] is not None]",
        "assert not bad, bad",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(tmp_path), timeout=300,
                          env=dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr
    got = np.load(tmp_path / "out.npz")
    _assert_served(model, {k: torch.from_numpy(got[k]) for k in got.files}, inputs)
