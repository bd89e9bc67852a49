"""The port's streaming video demo CLI (``cli/video_demo.py``) on the CPU
(``OBMAN_PLATFORM=cpu``): the six cases of the JAX package's
``tests/test_video_demo.py`` (frames-dir path and the ``--show`` window
loop), plus ``--render --attention --max_frames``.

The live-window contract mirrors the reference webcam demo
(webcam_demo.py:100-134): named cv2 windows, waitKey(1), q to quit,
destroyAllWindows on exit. No cv2 GUI here, so the window loop is driven
through a recording stub and the headless degradation through a raising
stub; a stub that raises on any attribute shows that cv2 is never touched
without a reachable display (real cv2 aborts the process there).
"""

import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setenv("OBMAN_PLATFORM", "cpu")


@pytest.fixture()
def frames_dir(tmp_path):
    d = tmp_path / "frames"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(
            rng.integers(0, 255, (48, 64, 3), np.uint8)
        ).save(d / f"f{i}.png")
    return str(d)


def _run(argv):
    from obman_train_tpu_torch.cli.video_demo import main

    return main(argv)


def test_frames_dir_end_to_end(frames_dir, tmp_path):
    out_dir = str(tmp_path / "out")
    _run([
        "--frames_dir", frames_dir, "--out_dir", out_dir,
        "--batch", "2", "--image_size", "64",
    ])
    outs = sorted(os.listdir(out_dir))
    assert [o for o in outs if o.endswith(".npz")] == [
        "f0.png.npz", "f1.png.npz", "f2.png.npz"
    ]
    data = np.load(os.path.join(out_dir, "f0.png.npz"))
    assert data["verts"].shape == (778, 3)
    assert np.isfinite(data["verts"]).all()


class _RecordingCV2(types.ModuleType):
    """cv2 stub that records window activity and quits after 2 frames."""

    def __init__(self):
        super().__init__("cv2")
        self.shown = []
        self.wait_calls = 0
        self.destroyed = False

    def namedWindow(self, name):
        self.shown.append(("named", name))

    def imshow(self, name, img):
        assert img.ndim == 3 and img.shape[2] == 3
        self.shown.append(("imshow", name))

    def circle(self, img, center, radius, color, thickness):
        pass

    def waitKey(self, ms):
        self.wait_calls += 1
        # probe + frame 1 pass, frame 2 presses q
        return ord("q") if self.wait_calls >= 3 else 0

    def destroyAllWindows(self):
        self.destroyed = True


def test_show_window_loop_quits_on_q(frames_dir, tmp_path, monkeypatch):
    from obman_train_tpu_torch.cli import video_demo

    stub = _RecordingCV2()
    monkeypatch.setitem(sys.modules, "cv2", stub)
    monkeypatch.setattr(  # pretend a display server is reachable
        video_demo, "_x11_unreachable_reason", lambda: None
    )
    out_dir = str(tmp_path / "out")
    _run([
        "--frames_dir", frames_dir, "--out_dir", out_dir,
        "--batch", "1", "--image_size", "64", "--show",
    ])
    windows = {n for kind, n in stub.shown if kind == "imshow"}
    assert "pose estimation" in windows and "mesh" in windows
    assert stub.destroyed
    # q on the second displayed frame stops the loop before frame 3
    npz = [o for o in os.listdir(out_dir) if o.endswith(".npz")]
    assert len(npz) == 2


class _HeadlessCV2(types.ModuleType):
    def __init__(self):
        super().__init__("cv2")

    def namedWindow(self, name):
        raise RuntimeError("no display")


def test_show_gui_failure_falls_back_to_disk(frames_dir, tmp_path,
                                             monkeypatch):
    from obman_train_tpu_torch.cli import video_demo

    monkeypatch.setitem(sys.modules, "cv2", _HeadlessCV2())
    monkeypatch.setattr(  # display "reachable" but cv2 GUI build broken
        video_demo, "_x11_unreachable_reason", lambda: None
    )
    out_dir = str(tmp_path / "out")
    with pytest.warns(UserWarning, match="--show disabled"):
        _run([
            "--frames_dir", frames_dir, "--out_dir", out_dir,
            "--batch", "3", "--image_size", "64", "--show",
        ])
    npz = [o for o in os.listdir(out_dir) if o.endswith(".npz")]
    assert len(npz) == 3


class _Abort(types.ModuleType):
    """cv2 stand-in: real cv2 SIGABRTs the PROCESS (uncatchable) on any
    GUI call when the display server is missing or stale, so these tests
    assert cv2 is never even touched on those paths."""

    def __getattr__(self, name):
        raise AssertionError("cv2 touched without a reachable display")


def test_show_no_display_never_touches_cv2(frames_dir, tmp_path,
                                           monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", _Abort("cv2"))
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    out_dir = str(tmp_path / "out")
    with pytest.warns(UserWarning, match="no display"):
        _run([
            "--frames_dir", frames_dir, "--out_dir", out_dir,
            "--batch", "3", "--image_size", "64", "--show",
        ])
    assert len([o for o in os.listdir(out_dir) if o.endswith(".npz")]) == 3


def test_show_stale_display_never_touches_cv2(frames_dir, tmp_path,
                                              monkeypatch):
    # DISPLAY points at a display number with no X socket (e.g. a dead
    # SSH forward): the socket probe must reject it before any cv2 call.
    monkeypatch.setitem(sys.modules, "cv2", _Abort("cv2"))
    monkeypatch.setenv("DISPLAY", ":99")
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    assert not os.path.exists("/tmp/.X11-unix/X99")
    out_dir = str(tmp_path / "out")
    with pytest.warns(UserWarning, match="does not exist"):
        _run([
            "--frames_dir", frames_dir, "--out_dir", out_dir,
            "--batch", "3", "--image_size", "64", "--show",
        ])
    assert len([o for o in os.listdir(out_dir) if o.endswith(".npz")]) == 3


def test_x11_probe_forms(monkeypatch):
    from obman_train_tpu_torch.cli.video_demo import _x11_unreachable_reason

    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    monkeypatch.setenv("DISPLAY", "not-a-display")
    assert "unparseable" in _x11_unreachable_reason()
    # TCP form against a port nothing listens on
    monkeypatch.setenv("DISPLAY", "127.0.0.1:63")  # port 6063
    assert "unreachable" in _x11_unreachable_reason()
    # wayland socket missing
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.setenv("WAYLAND_DISPLAY", "wayland-definitely-absent")
    assert "does not exist" in _x11_unreachable_reason()


def test_render_attention_max_frames(frames_dir, tmp_path):
    """Mesh panels and attention overlays on disk, and --max_frames stops
    the stream (batches of 2 over 3 frames, limit 2)."""
    out_dir = str(tmp_path / "out")
    stats = _run([
        "--frames_dir", frames_dir, "--out_dir", out_dir, "--batch", "2",
        "--image_size", "64", "--render", "--attention", "--max_frames", "2",
    ])
    assert stats["frames"] == 2 and stats["fps"] > 0
    outs = sorted(os.listdir(out_dir))
    assert outs == ["f0.png.npz", "f0.png.png", "f0.png_attention.png", "f1.png.npz",
                    "f1.png.png", "f1.png_attention.png"]
    panel = np.asarray(Image.open(os.path.join(out_dir, "f0.png.png")))
    att = np.asarray(Image.open(os.path.join(out_dir, "f0.png_attention.png")))
    assert panel.ndim == 3 and panel.shape[2] == 3 and att.shape == (64, 64, 3)
    assert set(np.load(os.path.join(out_dir, "f1.png.npz")).files) == {
        "verts", "joints", "objpoints3d"}


def test_render_and_image_demo_without_matplotlib(frames_dir, tmp_path, monkeypatch):
    """The GPU host has PIL but no matplotlib: the panels are PIL rasters."""
    from obman_train_tpu_torch.cli import image_demo

    for name in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    out_dir = str(tmp_path / "out")
    _run(["--frames_dir", frames_dir, "--out_dir", out_dir, "--batch", "2",
          "--image_size", "64", "--render", "--attention"])
    panel = np.asarray(Image.open(os.path.join(out_dir, "f2.png.png")))
    assert panel.shape == (48, 64 + 48, 3)
    assert np.asarray(Image.open(os.path.join(out_dir, "f2.png_attention.png"))).shape == (
        64, 64, 3)
    out = str(tmp_path / "demo.png")
    image_demo.main(["--image", os.path.join(frames_dir, "f0.png"), "--output", out])
    assert np.asarray(Image.open(out)).shape == (2 * 48, 64 + 48, 3)
