"""The real-dataset adapters on the card (``cuda`` tests; JAX-free, run as
tests/test_torch_cuda.py says), on trees that ``data/fabricate.py`` writes
in the module's working directory (where the adapters keep their
annotation caches and the CLI finds FHB at its default root,
``datasymlinks/fhbhands``): ObMan batches of decoded frames, one-epoch
``cli.traineval`` runs on ObMan (threads and ``--loader_processes``) and
on FHB, counted per step, and the FHB tree's contact filter. The trees
are small (2 train steps and 1 val step at B=8 of 64 px crops): the
step's and the forward's widths are held by tests/test_torch_cuda.py and
the benchmark.
"""

import numpy as np
import pytest

from obman_train_tpu_torch.cli import traineval
from obman_train_tpu_torch.ops import nnsqdist
from obman_train_tpu_torch.train import loop
from tests.test_torch_cuda import EVAL_LAUNCHES, TRAIN_LAUNCHES
from tests.test_torch_cuda_cli import ARGV, _assert_finite_logs, card, counting  # noqa: F401

pytestmark = pytest.mark.cuda

B, SIZE = 8, 64
TRAIN, VAL = 2 * B, B  # samples of each split
CONTACT_THRESH_MM = 10.0  # FHB's contact filter (fhbhands.py, filter_thresh)


@pytest.fixture(scope="module")
def trees(card, tmp_path_factory):
    from obman_train_tpu_torch.data.fabricate import fabricate_fhb, fabricate_obman

    work = tmp_path_factory.mktemp("datasets")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        for split, n, seed in (("train", TRAIN, 0), ("val", VAL, 1)):
            obman_root, shapenet_root = fabricate_obman(str(work / "obman_tree"), n,
                                                        split=split, seed=seed)
        fhb_root = fabricate_fhb(str(work / "datasymlinks"), TRAIN, VAL, 8)
        yield {"work": work, "obman": (obman_root, shapenet_root), "fhb": fhb_root}


@pytest.mark.parametrize("device_augment", [False, True], ids=["host_jitter", "device_augment"])
def test_obman_batches_of_decoded_frames(trees, device_augment):
    """A ``BatchLoader`` batch of ``get_dataset("obman")`` on 8 threads:
    uint8 frames of decoded pixels, finite annotations, 600 object points."""
    from obman_train_tpu_torch.data import factory, loader

    obman_root, shapenet_root = trees["obman"]
    ds = factory.get_dataset("obman", "train", inp_res=SIZE, device_augment=device_augment,
                             meta={"obman_root": obman_root, "shapenet_root": shapenet_root})
    batch = next(iter(loader.BatchLoader(ds, batch_size=B, num_workers=8)))
    img = batch["images"]
    assert img.shape == (B, SIZE, SIZE, 3) and img.dtype == np.uint8 and img.std() >= 1
    assert all(np.isfinite(v).all() for v in batch.values() if v.dtype.kind == "f")
    assert batch["objpoints3d"].shape == (B, 600, 3)


@pytest.mark.parametrize("name", ["obman", "obman_loader_processes", "fhbhands"])
def test_traineval_on_a_fabricated_tree(trees, name):
    """One epoch of ``cli.traineval`` on the tree: finite logged values,
    ``TRAIN_LAUNCHES`` a train step and ``EVAL_LAUNCHES`` a val forward;
    FHB has no GT hand vertices, so its steps leave out the GT contact
    distances' one min-only sweep (``min_sqdist_to``)."""
    obman_root, shapenet_root = trees["obman"]
    dataset = "fhbhands" if name == "fhbhands" else "obman"
    argv = ARGV + ["--contact_lambda", "0.167", "--collision_lambda", "0.167",
                   "--epochs", "1", "--exp_id", str(trees["work"] / name)]
    for flag in ("--train_datasets", "--val_datasets"):
        argv[argv.index(flag) + 1] = dataset
    if dataset == "obman":
        argv += ["--obman_root", obman_root, "--shapenet_root", shapenet_root]
        argv += ["--loader_processes"] if name == "obman_loader_processes" else []
    else:
        argv += ["--val_splits", "test"]
    passes = []
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(trees["work"])
        mp.setattr(loop, "epoch_pass", counting(passes, {"name": name}))
        traineval.main(argv)
    _assert_finite_logs(str(trees["work"] / name))
    assert {p["train"] for p in passes} == {True, False}
    for p in passes:
        want = dict(TRAIN_LAUNCHES if p["train"] else EVAL_LAUNCHES)
        if dataset == "fhbhands":
            want[nnsqdist.KERNEL_MIN] -= 1
        assert p["launches"] == {k: v for k, v in want.items() if v}, p


def test_fhb_tree_keeps_every_frame_in_contact(trees):
    """Every fabricated FHB frame passes the contact filter: its object
    within 10 mm of a hand joint; ``points_from_mesh`` samples stay in the
    object's bounding box."""
    from obman_train_tpu_torch.data import transforms as T
    from obman_train_tpu_torch.data.fhbhands import FHBHands

    for split, n in (("train", TRAIN), ("test", VAL)):
        ds = FHBHands(split=split, root=trees["fhb"], use_cache=False)
        assert len(ds) == n
        for idx in range(len(ds)):
            verts, _ = ds.get_obj_verts_faces(idx)
            joints = ds.get_joints3d(idx)
            assert np.linalg.norm(verts[:, None] - joints[None], axis=2).min() \
                <= CONTACT_THRESH_MM, (split, idx)
        verts, faces = ds.get_obj_verts_faces(0)
        pts = T.points_from_mesh(faces, verts, 600, np.random.default_rng(0))
        assert (pts >= verts.min(0) - 1e-3).all() and (pts <= verts.max(0) + 1e-3).all()
