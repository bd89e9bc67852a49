"""Streaming video/webcam demo (the JAX package's ``cli/video_demo.py``;
reference webcam_demo.py).

Sources: a webcam (cv2), a video file (cv2), or a directory of frames
(PIL). Frames go to the device in batches (``--batch``) as uint8 and are
preprocessed there with the model; one batch stays in flight, so the host's
reading, writing and drawing for batch N-1 overlaps the device's work on
batch N. Rendering is optional and off the hot path.

  python -m obman_train_tpu_torch.cli.video_demo --frames_dir demo_frames/ \
      --resume checkpoints/exp --out_dir video_out/

On the CPU set ``OBMAN_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def iter_frames(args):
    if args.frames_dir:
        from PIL import Image

        for name in sorted(os.listdir(args.frames_dir)):
            path = os.path.join(args.frames_dir, name)
            yield name, np.asarray(Image.open(path).convert("RGB"))
    else:
        try:
            import cv2
        except ImportError as e:
            raise SystemExit("cv2 unavailable: use --frames_dir with extracted frames") from e
        cap = cv2.VideoCapture(args.video if args.video else 0)
        idx = 0
        while True:
            ret, bgr = cap.read()
            if not ret:
                break
            yield f"frame_{idx:06d}", bgr[:, :, ::-1]
            idx += 1


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames_dir", default=None)
    parser.add_argument("--video", default=None)
    parser.add_argument("--resume", default=None)
    parser.add_argument("--from_export", default=None,
                        help="serve from a cli.export artifact (skips model "
                        "construction and checkpoint restore at startup; "
                        "--attention is unavailable in this mode)")
    parser.add_argument("--mano_assets", default=None)
    parser.add_argument("--hand_side", default="left", choices=["left", "right"])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--out_dir", default="video_demo_out")
    parser.add_argument("--render", action="store_true",
                        help="render mesh overlays (slow, host-side)")
    parser.add_argument("--attention", action="store_true")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--image_size", type=int, default=None,
                        help="model input resolution (default: the "
                        "experiment's)")
    parser.add_argument("--show", action="store_true",
                        help="live cv2 windows (pose estimation / mesh / "
                        "attention) like the reference webcam demo "
                        "(webcam_demo.py:100-134); press q to quit. Falls "
                        "back to disk output when no display is available.")
    args = parser.parse_args(argv)

    from obman_train_tpu_torch.cli import apply_platform_override
    from obman_train_tpu_torch.demo.inference import HostCopy, to_device

    device = apply_platform_override()
    display = _LiveDisplay() if args.show else None

    if args.from_export is not None:
        from obman_train_tpu_torch.demo.export import ExportedModel

        model = ExportedModel(args.from_export, device=device)
        if args.attention:
            import warnings

            warnings.warn("--attention needs encoder intermediates the export "
                          "artifact does not expose; disabling attention output")
            args.attention = False
    else:
        from obman_train_tpu_torch.demo import DemoModel

        # image_size=None: the experiment's own config.model.image_size
        if args.resume is None:
            from obman_train_tpu_torch.config import ExperimentConfig

            model = DemoModel(config=ExperimentConfig(),
                              mano_assets=args.mano_assets or "synthetic",
                              image_size=args.image_size, device=device)
        else:
            model = DemoModel(exp_dir=args.resume, mano_assets=args.mano_assets,
                              image_size=args.image_size, device=device)

    os.makedirs(args.out_dir, exist_ok=True)
    names, frames = [], []
    n_done, t0 = 0, time.perf_counter()
    sides_const = np.full((args.batch,), 0 if args.hand_side == "right" else 1, np.int32)
    flips_const = np.zeros((args.batch,), bool)

    def dispatch():
        """Start a batch on the device and return it in flight: one
        host-to-device copy of its inputs, the forward queued, the copy of
        its outputs to pinned host memory queued behind it with an event
        (never a synchronize here)."""
        if not frames:
            return None
        pad = args.batch - len(frames)  # pad the tail batch: one shape
        stack = np.stack(frames + [frames[-1]] * pad)
        dstack, dsides, dflips = to_device(model.device, stack, sides_const, flips_const)
        copy = HostCopy(model._infer(model._variables, dstack, dsides, dflips))
        batch = (list(names), list(frames), copy)
        names.clear()
        frames.clear()
        return batch

    def collect(batch):
        nonlocal n_done
        if batch is None:
            return
        names, frames, copy = batch
        out = copy.get()  # waits on the batch's copy event
        att = None
        if args.attention:
            pad = args.batch - len(frames)
            att = model.attention_maps(np.stack(frames + [frames[-1]] * pad))
        for i, name in enumerate(names):
            blended = None
            if att is not None:
                from PIL import Image

                from obman_train_tpu_torch.demo.attention import attention_overlay
                from obman_train_tpu_torch.demo.preprocess import preprocess_frame

                small = preprocess_frame(frames[i], model.image_size)
                blended = attention_overlay(small, att[i])
                Image.fromarray(blended).save(
                    os.path.join(args.out_dir, f"{name}_attention.png"))
            np.savez(
                os.path.join(args.out_dir, f"{name}.npz"),
                verts=out["verts"][i], joints=out["joints"][i],
                **({"objpoints3d": out["objpoints3d"][i]} if "objpoints3d" in out else {}),
            )
            panel = None
            if args.render or (display is not None and display.active):
                panel = _render_panel(model, frames[i], out, i)
                if args.render:
                    from PIL import Image

                    Image.fromarray(panel).save(os.path.join(args.out_dir, f"{name}.png"))
            if display is not None and display.active:
                display.update(frames[i], _frame_joints2d(model, frames[i], out, i),
                               mesh_rgb=panel, attention_rgb=blended)
        n_done += len(names)

    in_flight = None  # one dispatched batch whose host work is deferred
    quit_early = False
    for name, frame in iter_frames(args):
        names.append(name)
        frames.append(frame)
        if len(frames) == args.batch:
            prev, in_flight = in_flight, dispatch()
            collect(prev)  # host work for N-1 overlaps device work for N
        if display is not None and display.quit:
            quit_early = True  # q stops now: the in-flight batch is dropped
            break
        if args.max_frames and n_done + len(frames) + (
                len(in_flight[0]) if in_flight else 0) >= args.max_frames:
            break
    if not quit_early:
        prev, in_flight = in_flight, dispatch()
        collect(prev)
        collect(in_flight)
    if display is not None:
        display.close()
    dt = time.perf_counter() - t0
    print(f"Processed {n_done} frames in {dt:.2f}s ({n_done / max(dt, 1e-9):.1f} fps incl. IO)")
    return {"frames": n_done, "seconds": dt, "fps": n_done / max(dt, 1e-9)}


class _LiveDisplay:
    """Live cv2 window loop, mirroring the reference webcam demo's windows
    ("pose estimation" with the input + 2D joints, "mesh" with the rendered
    hand/object, "attention hand" — webcam_demo.py:100-134) and its
    ``waitKey``/q-to-quit protocol.  Construction probes one real window;
    headless environments or a missing cv2 degrade to ``active = False``
    and the caller keeps writing artifacts to disk instead."""

    def __init__(self):
        self.active = False
        self.quit = False
        import sys
        import warnings

        # cv2's GUI backend ABORTS the process (C-level, not a Python
        # exception) when no display server is reachable — both when
        # DISPLAY is unset and when it points at a dead server — so
        # reachability must be established BEFORE any GUI call on Linux.
        if sys.platform.startswith("linux"):
            reason = _x11_unreachable_reason()
            if reason is not None:
                warnings.warn(
                    f"--show disabled, writing to disk only: {reason}"
                )
                return
        try:
            import cv2

            cv2.namedWindow("pose estimation")
            cv2.waitKey(1)
        except Exception as e:  # no cv2 / no GUI build
            warnings.warn(f"--show disabled, writing to disk only: {e}")
            return
        self._cv2 = cv2
        self.active = True

    def update(self, frame_rgb, j2d, mesh_rgb=None, attention_rgb=None):
        # stop repainting the moment q is pressed (the reference's loop
        # breaks immediately, webcam_demo.py:130-134) — without this the
        # rest of the in-flight batch would still be displayed
        if not self.active or self.quit:
            return
        cv2 = self._cv2
        img = np.ascontiguousarray(frame_rgb[:, :, ::-1])
        if j2d is not None:
            for x, y in np.asarray(j2d):
                cv2.circle(img, (int(x), int(y)), 3, (0, 255, 0), -1)
        cv2.imshow("pose estimation", img)
        if mesh_rgb is not None:
            cv2.imshow("mesh", mesh_rgb[:, :, ::-1])
        if attention_rgb is not None:
            cv2.imshow("attention hand", attention_rgb[:, :, ::-1])
        if cv2.waitKey(1) & 0xFF == ord("q"):
            self.quit = True

    def close(self):
        if self.active:
            self._cv2.destroyAllWindows()


def _x11_unreachable_reason():
    """None when an X/Wayland server looks reachable, else a reason string.

    A stale ``DISPLAY`` (e.g. left over from a dropped SSH forward) makes
    cv2 SIGABRT inside ``namedWindow``, which try/except cannot catch, so
    the server socket is probed directly first.
    """
    display = os.environ.get("DISPLAY")
    wayland = os.environ.get("WAYLAND_DISPLAY")
    if not display and not wayland:
        return "no display (DISPLAY/WAYLAND_DISPLAY unset)"
    if wayland and not display:
        sock = os.path.join(
            os.environ.get("XDG_RUNTIME_DIR", "/run/user/0"), wayland
        )
        if os.path.exists(sock):
            return None
        return f"WAYLAND_DISPLAY={wayland} but {sock} does not exist"
    # DISPLAY forms: ":0", ":0.0", "host:0", "localhost:10.0"
    host, _, rest = display.rpartition(":")
    try:
        num = int(rest.split(".")[0])
    except ValueError:
        return f"unparseable DISPLAY={display!r}"
    import socket

    if host in ("", "unix"):
        sock = f"/tmp/.X11-unix/X{num}"
        if os.path.exists(sock):
            return None
        return f"DISPLAY={display} but X socket {sock} does not exist"
    try:
        with socket.create_connection((host, 6000 + num), timeout=1.0):
            return None
    except OSError as e:
        return f"DISPLAY={display} unreachable ({e})"


def _frame_joints2d(model, frame, out, i):
    """Predicted 2D joints mapped from crop coordinates to the raw frame."""
    if "joints2d" not in out:
        return None
    scale = min(frame.shape[:2]) / model.image_size
    off_x = (frame.shape[1] - min(frame.shape[:2])) / 2
    off_y = (frame.shape[0] - min(frame.shape[:2])) / 2
    return out["joints2d"][i] * scale + [off_x, off_y]


def _render_panel(model, frame, out, i) -> np.ndarray:
    """Input+joints / 3D-mesh side-by-side panel as an RGB uint8 array
    (without matplotlib, the PIL raster panel)."""
    try:
        import matplotlib
    except ImportError:
        from obman_train_tpu_torch.visualize.raster import mesh_panel

        meshes = [(out["verts"][i], "b")]
        if "objpoints3d" in out:
            meshes.append((out["objpoints3d"][i], "r"))
        return mesh_panel(frame, _frame_joints2d(model, frame, out, i), meshes)

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from obman_train_tpu_torch.visualize.displaymano import add_mesh

    fig = plt.figure(figsize=(8, 4))
    ax = fig.add_subplot(1, 2, 1)
    ax.imshow(frame)
    j2d = _frame_joints2d(model, frame, out, i)
    if j2d is not None:
        from obman_train_tpu_torch.visualize.viz2d import visualize_joints_2d

        visualize_joints_2d(ax, j2d)
    ax.axis("off")
    ax = fig.add_subplot(1, 2, 2, projection="3d")
    add_mesh(ax, out["verts"][i], model.hand_faces, c="b")
    if "objpoints3d" in out:
        add_mesh(ax, out["objpoints3d"][i], model.obj_faces, c="r")
    ax.axis("off")
    fig.canvas.draw()
    panel = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
    plt.close(fig)
    return panel


if __name__ == "__main__":
    main()
