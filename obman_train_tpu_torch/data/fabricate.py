"""Fabricate an ObMan-layout dataset tree on disk (real JPEG/PNG files):
the JAX package's ``data/fabricate.py``, kept as the port's own copy.

The synthetic dataset (data/synthetic.py) generates samples in memory, so
pipeline measurements over it *fake* the image-decode cost. This module
writes an actual mini ObMan tree — per-sample meta pickles, JPEG rgb
frames, PNG segmentation maps, and a shared ShapeNet-style model pickle —
in the exact layout the ObMan adapter reads (data/obman.py; reference
layout: handobjectdatasets/obman.py:61-132), so the real loader path (JPEG
decode -> crop/warp/jitter -> batch) can be measured and tested
hermetically. For the same ``seed`` the files are byte for byte the JAX
package's (the same draws, the same cv2 encoders).

Used by ``tools/torch_data_pipeline.py``'s real-decode stage, by
tests/test_torch_cuda_datasets.py on the card and by the adapter tests. Images are smooth
low-frequency fields + mild noise so JPEG decode cost resembles
photographic content (pure noise both compresses and decodes
unrealistically).
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def _smooth_image(rng: np.random.Generator, size: int) -> np.ndarray:
    """Photographic-ish uint8 RGB: upsampled low-res noise + fine noise."""
    import cv2

    low = rng.integers(0, 255, (16, 16, 3), np.uint8)
    img = cv2.resize(low, (size, size), interpolation=cv2.INTER_CUBIC)
    noise = rng.integers(0, 24, (size, size, 3), np.uint8)
    return cv2.add(img, noise)


def fabricate_obman(
    root_dir: str,
    n_samples: int,
    split: str = "train",
    img_size: int = 256,
    seed: int = 0,
    write_segm: bool = True,
) -> tuple:
    """Write ``n_samples`` ObMan-layout samples under ``root_dir``.

    Returns ``(obman_root, shapenet_root)`` suitable for
    ``get_dataset("obman", split, meta={...})``.
    """
    import cv2

    rng = np.random.default_rng(seed)
    obman_root = os.path.join(root_dir, "obman")
    shapenet_root = os.path.join(root_dir, "shapenet")
    split_dir = os.path.join(obman_root, split)
    meta_dir = os.path.join(split_dir, "meta")
    rgb_dir = os.path.join(split_dir, "rgb")
    segm_dir = os.path.join(split_dir, "segm")
    for d in (meta_dir, rgb_dir) + ((segm_dir,) if write_segm else ()):
        os.makedirs(d, exist_ok=True)

    # One shared ShapeNet-style model (the adapter resolves models by
    # class_id/sample_id, so every sample can point at it).
    class_id, sample_id = "02880940", "fab0001"
    model_dir = os.path.join(shapenet_root, class_id, sample_id, "models")
    os.makedirs(model_dir, exist_ok=True)
    verts = rng.random((60, 3)) - 0.5
    faces = rng.integers(0, 60, (96, 3))
    with open(os.path.join(model_dir, "model_normalized.pkl"), "wb") as f:
        pickle.dump({"vertices": verts, "faces": faces}, f)
    with open(os.path.join(model_dir, "surface_points.pkl"), "wb") as f:
        pickle.dump(rng.random((800, 3)) - 0.5, f)

    for i in range(n_samples):
        prefix = f"{i:08d}"
        meta = {
            "coords_2d": rng.uniform(40, img_size - 56, (21, 2)),
            "coords_3d": rng.normal(0, 0.1, (21, 3)) + [0, 0, 0.5],
            "verts_3d": rng.normal(0, 0.1, (778, 3)) + [0, 0, 0.5],
            "side": "left" if i % 2 else "right",
            "hand_pose": rng.normal(0, 1, 45),
            "pca_pose": rng.normal(0, 1, 30),
            "depth_min": 0.3, "depth_max": 0.9,
            "hand_depth_min": 0.3, "hand_depth_max": 0.8,
            "obj_depth_min": 0.4, "obj_depth_max": 0.9,
            "class_id": class_id,
            "sample_id": sample_id,
            "affine_transform": np.eye(4),
            "obj_scale": 0.2,
        }
        with open(os.path.join(meta_dir, f"{prefix}.pkl"), "wb") as f:
            pickle.dump(meta, f)
        img = _smooth_image(rng, img_size)
        cv2.imwrite(
            os.path.join(rgb_dir, f"{prefix}.jpg"), img[:, :, ::-1],
            [cv2.IMWRITE_JPEG_QUALITY, 90],
        )
        if write_segm:
            segm = np.zeros((img_size, img_size, 3), np.uint8)
            cx, cy = meta["coords_2d"].mean(0).astype(int)
            cv2.circle(segm, (int(cx), int(cy)), img_size // 5, (0, 255, 0), -1)
            cv2.circle(segm, (int(cx) + 20, int(cy)), img_size // 8,
                       (255, 0, 0), -1)
            cv2.imwrite(os.path.join(segm_dir, f"{prefix}.png"),
                        segm[:, :, ::-1])
    return obman_root, shapenet_root


# FHB: the four objects, the action whose name carries each (the adapter
# reads the object's name from the action's, fhbhands.py:151-153), and the
# object models' half extents in metres
FHB_OBJECTS = (("juice_bottle", "pour_juice_bottle", (0.03, 0.03, 0.08)),
               ("liquid_soap", "open_liquid_soap", (0.03, 0.025, 0.07)),
               ("milk", "open_milk", (0.035, 0.035, 0.09)),
               ("salt", "put_salt", (0.02, 0.02, 0.05)))
FHB_SEQUENCES = {"train": 599, "test": 575}
FHB_IMAGE_SIZE = (480, 270)  # (w, h): the quarter-scale videos the adapter reads


def _smooth_frame(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """``_smooth_image`` at another aspect ratio."""
    import cv2

    low = rng.integers(0, 255, (9, 16, 3), np.uint8)
    img = cv2.resize(low, (width, height), interpolation=cv2.INTER_CUBIC)
    return cv2.add(img, rng.integers(0, 24, (height, width, 3), np.uint8))


def _write_ply(path: str, verts: np.ndarray, faces: np.ndarray, binary: bool) -> None:
    header = ("ply\nformat {} 1.0\nelement vertex {}\nproperty float x\n"
              "property float y\nproperty float z\nelement face {}\n"
              "property list uchar int vertex_indices\nend_header\n").format(
                  "binary_little_endian" if binary else "ascii", len(verts), len(faces))
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(np.asarray(verts, "<f4").tobytes())
            for face in faces:
                f.write(np.uint8(3).tobytes() + np.asarray(face, "<i4").tobytes())
        else:
            for v in verts:
                f.write((" ".join(f"{x:.6f}" for x in v) + "\n").encode("ascii"))
            for face in faces:
                f.write(("3 " + " ".join(str(int(i)) for i in face) + "\n").encode("ascii"))


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def fabricate_fhb(
    root_dir: str,
    n_train: int = 8,
    n_test: int = 4,
    frames_per_seq: int = 2,
    seed: int = 0,
) -> str:
    """Write an FHB-layout tree (First-Person Hand Action Benchmark, as
    ``data/fhbhands.py`` reads it) under ``root_dir/fhbhands``; returns
    that root, the ``fhb_root`` of ``get_dataset("fhbhands", ...)``.

    The split file lists the published 599 train and 575 test sequences
    (every subject's ``Subjects_info`` and skeleton file exist, each
    sequence ``frames_per_seq`` frames long), but only the first sequences
    of each split carry object poses and 480x270 JPEG frames (the
    quarter-scale videos): enough for ``n_train`` and ``n_test`` frames. The four object models are ellipsoid icospheres in PLY (ascii
    and binary little-endian in turn); each materialised frame places its
    object, randomly rotated, with one vertex within 5 mm of a hand joint,
    so the adapter's 10 mm contact filter keeps every such frame.
    """
    import cv2

    from obman_train_tpu_torch.assets.icosphere import icosphere

    rng = np.random.default_rng(seed)
    root = os.path.join(root_dir, "fhbhands")
    width, height = FHB_IMAGE_SIZE
    subjects = [f"Subject_{i}" for i in range(1, 7)]
    # per subject: its train then its test sequences, the counts spread as
    # evenly as the published totals allow
    seqs = {}
    for si, subject in enumerate(subjects):
        counts = {s: n // 6 + (1 if si < n % 6 else 0) for s, n in FHB_SEQUENCES.items()}
        entries = [(FHB_OBJECTS[a % 4][1], str(a // 4 + 1))
                   for a in range(counts["train"] + counts["test"])]
        seqs[subject] = {"train": entries[:counts["train"]],
                         "test": entries[counts["train"]:]}
    info_dir = os.path.join(root, "Subjects_info")
    os.makedirs(info_dir, exist_ok=True)
    for subject in subjects:
        with open(os.path.join(info_dir, f"{subject}_info.txt"), "w") as f:
            f.write("Subject info\naction sequence frames\n\n")
            for action, seq_idx in seqs[subject]["train"] + seqs[subject]["test"]:
                f.write(f"{action} {seq_idx} {frames_per_seq}\n")
    action_idx = {action: k + 1 for k, (_, action, _) in enumerate(FHB_OBJECTS)}
    split_lines = {s: [f"{subject}/{action}/{seq_idx} {action_idx[action]}\n"
                       for subject in subjects for action, seq_idx in seqs[subject][s]]
                   for s in FHB_SEQUENCES}
    with open(os.path.join(root, "data_split_action_recognition.txt"), "w") as f:
        f.write(f"Training {FHB_SEQUENCES['train']}\n")
        f.writelines(split_lines["train"])
        f.write(f"Test {FHB_SEQUENCES['test']}\n")
        f.writelines(split_lines["test"])

    sphere_v, sphere_f = icosphere(1)
    models = {}
    for k, (name, _, half) in enumerate(FHB_OBJECTS):
        model_dir = os.path.join(root, "Object_models", f"{name}_model")
        os.makedirs(model_dir, exist_ok=True)
        models[name] = sphere_v * np.asarray(half)
        _write_ply(os.path.join(model_dir, f"{name}_model.ply"), models[name], sphere_f,
                   binary=bool(k % 2))

    # the sequences that carry frames: the first of each split, in the
    # split file's order
    materialised = set()
    for split, n in (("train", n_train), ("test", n_test)):
        listed = [(subject, action, seq_idx) for subject in subjects
                  for action, seq_idx in seqs[subject][split]]
        materialised.update(listed[:-(-n // frames_per_seq)])
    for subject in subjects:
        for action, seq_idx in seqs[subject]["train"] + seqs[subject]["test"]:
            # world coordinates (mm) in front of the camera
            joints = (rng.normal(0, 30, (frames_per_seq, 21, 3))
                      + rng.normal(0, 40, 3) + [0, 0, 450])
            skel_dir = os.path.join(root, "Hand_pose_annotation_v1", subject, action, seq_idx)
            os.makedirs(skel_dir, exist_ok=True)
            rows = np.concatenate([np.arange(frames_per_seq)[:, None],
                                   joints.reshape(frames_per_seq, 63)], axis=1)
            np.savetxt(os.path.join(skel_dir, "skeleton.txt"), rows)
            if (subject, action, seq_idx) not in materialised:
                continue
            name = "_".join(action.split("_")[1:])
            pose_dir = os.path.join(root, "Object_6D_pose_annotation_v1", subject, action,
                                    seq_idx)
            color_dir = os.path.join(root, "process_yana", "videos_480", subject, action,
                                     seq_idx, "color")
            os.makedirs(pose_dir, exist_ok=True)
            os.makedirs(color_dir, exist_ok=True)
            with open(os.path.join(pose_dir, "object_pose.txt"), "w") as f:
                for frame in range(frames_per_seq):
                    rot = _random_rotation(rng)
                    vert = models[name][rng.integers(len(models[name]))] * 1000
                    joint = joints[frame, rng.integers(21)]
                    offset = rng.normal(0, 1, 3)
                    offset *= rng.uniform(0, 5) / np.linalg.norm(offset)
                    trans = np.eye(4)
                    trans[:3, :3] = rot
                    trans[:3, 3] = joint + offset - rot @ vert
                    # the file holds the transpose (fhbhands.py reads .T)
                    f.write(f"{frame} " + " ".join(f"{x:.8f}" for x in trans.T.reshape(-1))
                            + "\n")
            for frame in range(frames_per_seq):
                img = _smooth_frame(rng, height, width)
                cv2.imwrite(os.path.join(color_dir, f"color_{frame:04d}.jpeg"), img[:, :, ::-1],
                            [cv2.IMWRITE_JPEG_QUALITY, 90])
    return root
