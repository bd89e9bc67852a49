"""Contact-zone vertex tables (reference: contactloss.py:262-274,
handobjectdatasets/contactutils.py:8-13).

The six variable-length MANO-vertex groups (palm + finger zones) become a
fixed-shape boolean membership matrix ``(num_zones, 778)`` so the "closest
vertex per zone" selection is a masked argmin. The data file is the port's
own copy of the JAX package's ``assets/data/contact_zones.npz``.
"""

from __future__ import annotations

import functools
import os

import numpy as np

# Fingertip vertex ids used by the "tips" contact-zone filter
# (reference: contactloss.py:258).
TIP_VERT_IDS = (745, 317, 444, 556, 673)

DATA_PATH = os.path.join(os.path.dirname(__file__), "data", "contact_zones.npz")

NUM_HAND_VERTS = 778


@functools.lru_cache(maxsize=2)
def load_contact_zones(path: str = DATA_PATH):
    """Returns ``(verts (778,3) float32, zones: dict[int, np.ndarray])``."""
    data = np.load(path)
    zones = {}
    i = 0
    while f"zone_{i}" in data:
        zones[i] = data[f"zone_{i}"].astype(np.int32)
        i += 1
    return data["verts"].astype(np.float32), zones


@functools.lru_cache(maxsize=2)
def zone_masks(path: str = DATA_PATH) -> np.ndarray:
    """Fixed-shape zone membership: bool ``(num_zones, 778)``."""
    _, zones = load_contact_zones(path)
    masks = np.zeros((len(zones), NUM_HAND_VERTS), dtype=bool)
    for idx, vert_ids in zones.items():
        masks[idx, vert_ids] = True
    masks.setflags(write=False)
    return masks


def tips_mask() -> np.ndarray:
    """Bool (778,) mask of fingertip vertices."""
    mask = np.zeros((NUM_HAND_VERTS,), dtype=bool)
    mask[list(TIP_VERT_IDS)] = True
    return mask
