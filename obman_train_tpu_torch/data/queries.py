"""Query system: the sample-dict keys that form the dataset<->model API
(the JAX package's ``data/queries.py``, kept as the port's own copy).

Mirrors the reference's enums (handobjectdatasets/queries.py:4-95) as string
enums so samples serialize cleanly; ``get_trans_queries`` derives which
augmented outputs a dataset can produce from its raw annotations.
"""

from __future__ import annotations

from enum import Enum
from typing import Iterable, List


class BaseQueries(str, Enum):
    camintrs = "camintrs"
    depth = "depth"
    hand_poses = "hand_poses"
    hand_pcas = "hand_pcas"
    images = "images"
    joints2d = "joints2d"
    joints3d = "joints3d"
    meta = "meta"
    objpoints2d = "objpoints2d"
    objpoints3d = "objpoints3d"
    objverts3d = "objverts3d"
    objfaces = "objfaces"
    verts3d = "verts3d"
    sides = "sides"
    segms = "segms"
    manoidxs = "manoidxs"


class TransQueries(str, Enum):
    camintrs = "trans_camintrs"
    depth = "trans_depth"
    images = "trans_images"
    joints2d = "trans_joints2d"
    joints3d = "trans_joints3d"
    objfaces = "trans_objfaces"
    objpoints2d = "trans_objpoints2d"
    objpoints3d = "trans_objpoints3d"
    objverts3d = "trans_objverts3d"
    segms = "trans_segms"
    verts3d = "trans_verts3d"
    center3d = "center3d"
    affinetrans = "affinetrans"
    rotmat = "rotmat"


def one_query_in(candidates: Iterable, queries: Iterable) -> bool:
    qs = set(queries)
    return any(c in qs for c in candidates)


def no_query_in(candidates: Iterable, queries: Iterable) -> bool:
    return not one_query_in(candidates, queries)


def get_trans_queries(base_queries: Iterable) -> List[TransQueries]:
    """Derivable TransQueries given raw BaseQueries
    (reference: queries.py:60-95)."""
    base = set(base_queries)
    trans: List[TransQueries] = []
    add_center = False
    if BaseQueries.objverts3d in base:
        trans += [TransQueries.objpoints3d, TransQueries.objverts3d]
        add_center = True
    if BaseQueries.objpoints3d in base:
        trans.append(TransQueries.objpoints3d)
        add_center = True
    if BaseQueries.images in base:
        trans += [
            TransQueries.images,
            TransQueries.affinetrans,
            TransQueries.rotmat,
        ]
    if BaseQueries.depth in base:
        trans.append(TransQueries.depth)
    if BaseQueries.joints2d in base:
        trans.append(TransQueries.joints2d)
    if BaseQueries.joints3d in base:
        trans.append(TransQueries.joints3d)
        add_center = True
    if BaseQueries.verts3d in base:
        trans.append(TransQueries.verts3d)
        add_center = True
    if BaseQueries.segms in base:
        trans.append(TransQueries.segms)
    if add_center:
        trans.append(TransQueries.center3d)
    if BaseQueries.objpoints2d in base:
        trans.append(TransQueries.objpoints2d)
    if BaseQueries.camintrs in base:
        trans.append(TransQueries.camintrs)
    return trans
