"""MANO model tables and the synthetic hand used when the MANO pkl files
are absent (they are user-supplied, reference README.md:48-58).

:func:`synthetic_mano_assets` draws the same numbers as the JAX package's
``assets/mano_assets.py:191-249`` for the same seed: real MANO topology and
rest vertices from the contact-zones asset, the real kinematic tree, random
orthonormal PCA rows and small random blendshapes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from obman_train_tpu_torch.assets.contact_zones import DATA_PATH, load_contact_zones

# MANO kinematic tree: 16 joints, wrist root; fingers in native MANO order
# index(1-3), middle(4-6), pinky(7-9), ring(10-12), thumb(13-15).
MANO_PARENTS = np.array(
    [-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14], dtype=np.int32
)

NUM_VERTS = 778
NUM_JOINTS = 16
NUM_BETAS = 10
NUM_POSE_AA = 45          # 15 articulated joints x 3 axis-angle
NUM_POSE_BLEND = 135      # 15 joints x 9 rotmat entries

# Fingertip vertex ids appended as joints 16-20 before reordering
# (thumb, index, middle, ring, pinky tips).
TIPS = np.array([745, 317, 444, 556, 673], dtype=np.int32)

# [16 chain joints + 5 tips] -> 21-joint output order: wrist, thumb1-3+tip,
# index1-3+tip, middle1-3+tip, ring1-3+tip, pinky1-3+tip.
JOINT_REORDER = np.array(
    [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20],
    dtype=np.int32,
)

# Vertices whose mean replaces the wrist joint in root_palm mode
# (handobjectdatasets/obman.py:398-401).
PALM_VERT_IDS = (95, 218)


@dataclass(frozen=True)
class ManoAssets:
    """Numeric tables for one hand side, all plain numpy."""

    v_template: np.ndarray        # (778, 3)
    shapedirs: np.ndarray         # (778, 3, 10)
    posedirs: np.ndarray          # (778, 3, 135)
    J_regressor: np.ndarray       # (16, 778) dense
    weights: np.ndarray           # (778, 16) LBS skinning weights
    hands_components: np.ndarray  # (45, 45) PCA pose basis (rows = components)
    hands_mean: np.ndarray        # (45,) mean pose offset
    faces: np.ndarray             # (1538, 3) int32
    parents: np.ndarray = None    # (16,) int32
    side: str = "right"

    def __post_init__(self):
        if self.parents is None:
            object.__setattr__(self, "parents", MANO_PARENTS.copy())

    def validate(self) -> "ManoAssets":
        shapes = {
            "v_template": (NUM_VERTS, 3),
            "shapedirs": (NUM_VERTS, 3, NUM_BETAS),
            "posedirs": (NUM_VERTS, 3, NUM_POSE_BLEND),
            "J_regressor": (NUM_JOINTS, NUM_VERTS),
            "weights": (NUM_VERTS, NUM_JOINTS),
            "hands_components": (NUM_POSE_AA, NUM_POSE_AA),
            "hands_mean": (NUM_POSE_AA,),
        }
        for name, shape in shapes.items():
            if getattr(self, name).shape != shape:
                raise ValueError(
                    f"MANO {name}: shape {getattr(self, name).shape}, want {shape}"
                )
        if self.faces.ndim != 2 or self.faces.shape[1] != 3:
            raise ValueError(f"MANO faces: shape {self.faces.shape}, want (F, 3)")
        return self


def synthetic_mano_assets(side: str = "right", seed: int = 0) -> ManoAssets:
    """Structurally faithful synthetic MANO model for hermetic runs.

    Draws in the same order, from the same generator, as the JAX package's
    ``synthetic_mano_assets`` so both give identical tables for one seed.
    """
    rng = np.random.default_rng(seed + (1 if side == "left" else 0))
    rest_verts, _ = load_contact_zones()
    faces = np.load(DATA_PATH)["faces"].astype(np.int32)
    # The stored rest verts are already in metres (a real MANO template).
    v_template = rest_verts.astype(np.float32)
    if side == "left":
        v_template = v_template * np.array([-1.0, 1.0, 1.0], dtype=np.float32)

    # Joint rest positions: anchor vertices spread over the mesh and a
    # smooth J_regressor by inverse-distance weighting.
    anchor_ids = rng.choice(NUM_VERTS, size=NUM_JOINTS, replace=False)
    anchors = v_template[anchor_ids]
    d = np.linalg.norm(v_template[None, :, :] - anchors[:, None, :], axis=-1)
    J_regressor = np.exp(-d / (d.mean() * 0.05))
    J_regressor /= J_regressor.sum(axis=1, keepdims=True)

    # Skinning weights: softmax over joint proximity, sharpened.
    w = np.exp(-(d.T) / (d.mean() * 0.15))  # (778, 16)
    weights = w / w.sum(axis=1, keepdims=True)

    shapedirs = rng.normal(0, 0.002, (NUM_VERTS, 3, NUM_BETAS))
    posedirs = rng.normal(0, 0.0005, (NUM_VERTS, 3, NUM_POSE_BLEND))

    q, _ = np.linalg.qr(rng.normal(0, 1, (NUM_POSE_AA, NUM_POSE_AA)))
    hands_components = q * rng.uniform(0.5, 2.0, (NUM_POSE_AA, 1))
    hands_mean = rng.normal(0, 0.1, (NUM_POSE_AA,))

    return ManoAssets(
        v_template=v_template.astype(np.float32),
        shapedirs=shapedirs.astype(np.float32),
        posedirs=posedirs.astype(np.float32),
        J_regressor=J_regressor.astype(np.float32),
        weights=weights.astype(np.float32),
        hands_components=hands_components.astype(np.float32),
        hands_mean=hands_mean.astype(np.float32),
        faces=faces,
        parents=MANO_PARENTS.copy(),
        side=side,
    ).validate()
