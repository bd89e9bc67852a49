"""Ahead-of-time export of the demo model for serving (the JAX package's
``demo/export.py:37-176``, there through ``jax.export``).

``export_model`` traces ``DemoModel``'s inference program (uint8 frames ->
preprocessing, encoder, MANO, atlas) with ``torch.export``, weights baked
in, once per platform (``cpu``, ``cuda``), and writes the programs into one
file: a zip archive holding one ``torch.export`` archive per platform
(``cpu.pt2``, ``cuda.pt2``) and a ``serve.json`` of how to call them. By
default the batch dimension is symbolic, so one artifact serves any batch;
``batch_size`` pins a static batch. ``torch.export`` specialises sizes 0
and 1, so the symbolic batch is traced at 2 and ranges over [2, 65535]
(the upper end is the guard that the CUDA trace carries); ``serve`` pads
a batch of 1 to 2 outside the program and returns the first row.

``load_exported`` needs only ``torch``: this module imports nothing of the
port at its top, so a serving host can load the file by its path. A
``<out>.meta.json`` sidecar (image size, platforms, batch, hand and object
faces) lets ``ExportedModel`` stand in for ``DemoModel`` in the demos
(``--from_export``) without a checkpoint, a config or MANO assets.

The demo program runs none of the port's CUDA kernels (``DemoModel`` leaves
out the contact block), so the graph holds no ctypes call; exporting a
graph with one needs the kernels registered as ``torch.library`` custom
ops.

    model = DemoModel(exp_dir="checkpoints/exp")
    export_model(model, "model.pt2", platforms=("cuda", "cpu"))
    serve = load_exported("model.pt2")
    out = serve(frames_u8, sides, flip)  # tensors on one device -> dict
"""

from __future__ import annotations

import copy
import io
import json
import os
import zipfile
from typing import Optional, Sequence

import numpy as np
import torch

# platform names export_model takes; "gpu" is the JAX package's name for cuda
PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}
MIN_BATCH, MAX_BATCH = 2, 65535  # the range of a symbolic batch


def _platforms(model, platforms: Optional[Sequence[str]]):
    if platforms is None:
        return [model.device.type]
    out = []
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"platform {p!r} not in {sorted(PLATFORMS)}")
        if PLATFORMS[p] not in out:
            out.append(PLATFORMS[p])
    return out


def _export(serve: torch.nn.Module, device: torch.device, size: int,
            batch_size: Optional[int]) -> bytes:
    b = MIN_BATCH if batch_size is None else int(batch_size)
    args = (torch.zeros((b, size, size, 3), dtype=torch.uint8, device=device),
            torch.zeros((b,), dtype=torch.int32, device=device),
            torch.zeros((b,), dtype=torch.bool, device=device))
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("batch", min=MIN_BATCH, max=MAX_BATCH)
        dynamic = ({0: batch}, {0: batch}, {0: batch})
    with torch.no_grad():
        program = torch.export.export(serve, args, dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_model(model, out_path: str, platforms: Optional[Sequence[str]] = None,
                 batch_size: Optional[int] = None) -> dict:
    """Write ``model``'s inference program to ``out_path``.

    Args:
      model: a ``DemoModel`` (weights already restored).
      platforms: ``"cpu"``, ``"cuda"`` (or ``"gpu"``); default the model's
        device. Exporting for ``cuda`` needs a GPU.
      batch_size: pin a static batch; ``None`` exports a symbolic one.
    Returns an info dict (platforms, batch, image size, bytes written, path).

    A random-cloud model (``atlas.mesh=False``) draws its sphere points in
    the program (the points of seed 0, as ``DemoModel`` serves it), which
    ``torch.export`` traces only at a concrete batch: pin ``batch_size``.
    """
    if not model.cfg.model.atlas.mesh and batch_size is None:
        raise ValueError("a random-cloud model (atlas.mesh=False) exports with a pinned "
                         "batch_size only: its sphere points are drawn per sample")
    size = model.image_size
    names = _platforms(model, platforms)
    blobs = {}
    for name in names:
        device = torch.device(name)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("exporting for cuda needs a CUDA device")
        serve = model._serve
        if model.device.type != device.type:
            serve = copy.deepcopy(serve).to(device)
        blobs[name] = _export(serve.eval(), device, size, batch_size)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED) as z:
        for name, blob in blobs.items():
            z.writestr(f"{name}.pt2", blob)
        z.writestr("serve.json", json.dumps({"batch": "symbolic" if batch_size is None
                                             else int(batch_size), "min_batch": MIN_BATCH}))
    info = {
        "platforms": names,
        "batch": "symbolic" if batch_size is None else batch_size,
        "image_size": size,
        "bytes": os.path.getsize(out_path),
        "out_path": out_path,
    }
    meta = {
        "image_size": size,
        "platforms": info["platforms"],
        "batch": info["batch"],
        "hand_faces": np.asarray(model.hand_faces).tolist(),
        "obj_faces": np.asarray(model.obj_faces).tolist(),
    }
    with open(out_path + ".meta.json", "w") as f:
        json.dump(meta, f)
    return info


def load_exported(path: str):
    """The artifact as ``serve(frames_u8, sides, flip) -> dict of tensors``.

    Inputs are tensors on one device (numpy arrays count as CPU tensors);
    ``serve`` runs the artifact's program for that device type and raises
    if it holds none. Needs only torch: no model code, config or
    checkpoint."""
    with zipfile.ZipFile(path) as z:
        blobs = {n[:-len(".pt2")]: z.read(n) for n in z.namelist() if n.endswith(".pt2")}
        call = json.loads(z.read("serve.json"))
    programs = {name: torch.export.load(io.BytesIO(blob)).module()
                for name, blob in blobs.items()
                if name == "cpu" or torch.cuda.is_available()}
    pad_to = call["min_batch"] if call["batch"] == "symbolic" else 0

    def serve(frames_u8, sides, flip):
        inputs = [torch.as_tensor(x) for x in (frames_u8, sides, flip)]
        kind = inputs[0].device.type
        if kind not in programs:
            raise ValueError(f"{path} has no program for {kind} inputs (it holds "
                             f"{sorted(blobs)}; loadable here: {sorted(programs)})")
        B = inputs[0].shape[0]
        if 0 < B < pad_to:  # below the symbolic range: repeat the last row
            inputs = [torch.cat([x, x[-1:].expand(pad_to - B, *x.shape[1:])]) for x in inputs]
        with torch.inference_mode():
            out = programs[kind](*inputs)
        return {k: v[:B] for k, v in out.items()} if B < pad_to else out

    return serve


class ExportedModel:
    """A checkpoint-free demo model backed by an exported artifact.

    Stands in for the surface the demos use of ``DemoModel`` (``predict``,
    ``predict_dual``, ``_infer``, ``_variables``, ``image_size``,
    ``hand_faces``, ``obj_faces``), from the artifact and its
    ``.meta.json`` sidecar, so starting up builds no model and restores no
    checkpoint. The program takes frames of the exported ``image_size``
    (the JAX export's input shape). Attention maps need the encoder's stage
    outputs, which the artifact does not expose. ``device``: CUDA unless
    the caller passes ``"cpu"``.
    """

    def __init__(self, path: str, device=None):
        meta_path = path + ".meta.json"
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"{meta_path} not found: --from_export needs the sidecar cli.export "
                "writes next to the artifact (re-export with a current cli.export)")
        from obman_train_tpu_torch.device import resolve_device

        with open(meta_path) as f:
            meta = json.load(f)
        self.device = resolve_device(device)
        self.image_size = int(meta["image_size"])
        self.batch = meta.get("batch", "symbolic")
        self.hand_faces = np.asarray(meta["hand_faces"], np.int32)
        self.obj_faces = np.asarray(meta["obj_faces"], np.int32)
        serve = load_exported(path)
        # a placeholder, so that model._infer(model._variables, ...) works
        # for both classes
        self._variables = None
        self._infer = lambda _variables, frames, sides, flip: serve(frames, sides, flip)

    # predict/predict_dual use only _infer, _variables and device, so
    # DemoModel's apply as they are, the misuse guard included
    def predict(self, frame, hand_side: str = "left", flip: bool = False):
        from obman_train_tpu_torch.demo.inference import DemoModel

        return DemoModel.predict(self, frame, hand_side=hand_side, flip=flip)

    def predict_dual(self, frame, hand_side: str = "left"):
        from obman_train_tpu_torch.demo.inference import DemoModel

        return DemoModel.predict_dual(self, frame, hand_side=hand_side)
