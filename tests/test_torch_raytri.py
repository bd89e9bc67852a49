"""Ray-parity inside test of the port (kernel K1's plain version and the
(B, P, T) plain expression) against the JAX package, on the CPU.

The exterior masks must be exactly equal to the JAX
``ops/inside.batch_mesh_contains_points`` and to the Pallas kernel run in
interpret mode (as tests/test_pallas_kernels.py runs it). The CUDA kernel
itself is held against the plain version on the card by
``chip_smoke.py`` and by tests/test_torch_cuda.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obman_train_tpu.assets import icosphere as jax_icosphere
from obman_train_tpu.ops.inside import batch_mesh_contains_points as jax_contains
from obman_train_tpu.ops.pallas import pallas_mesh_contains_points
from obman_train_tpu_torch.assets import icosphere
from obman_train_tpu_torch.ops import raytri
from obman_train_tpu_torch.ops.inside import batch_mesh_contains_points

torch.set_num_threads(2)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "reference_goldens.npz")


def _scene(seed, B, P, divisions=2, n_tris=None):
    """Icosphere meshes of radius 30-70 mm (one per batch element) and query
    points inside, outside and straddling the surface."""
    rng = np.random.default_rng(seed)
    verts, faces = icosphere(divisions)
    radii = rng.uniform(30, 70, (B, 1, 1))
    centers = rng.normal(0, 5, (B, 1, 3))
    tris = (verts[None] * radii + centers)[:, faces]
    if n_tris is not None:
        tris = tris[:, :n_tris]
    dirs = rng.normal(0, 1, (B, P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    # radius fractions: deep inside, just inside/outside, far outside
    frac = rng.choice([0.3, 0.97, 0.999, 1.001, 1.03, 2.0], (B, P, 1))
    pts = centers + dirs * radii * frac
    return pts.astype(np.float32), tris.astype(np.float32)


def _jax_masks(pts, tris):
    ext_inside = np.asarray(jax_contains(jnp.asarray(pts), jnp.asarray(tris)))
    ext_pallas = np.asarray(
        pallas_mesh_contains_points(
            jnp.asarray(pts), jnp.asarray(tris), tile_p=128, interpret=True
        )
    )
    return ext_inside, ext_pallas


def test_icosphere_matches_jax():
    for div in range(4):
        v, f = icosphere(div)
        jv, jf = jax_icosphere(div)
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)


@pytest.mark.parametrize(
    "B,P,n_tris",
    [
        (2, 150, None),   # full closed icosphere(2), 320 triangles
        (3, 100, 77),     # ragged: P not a multiple of 128, T of the chunk
        (1, 300, 200),
    ],
)
def test_plain_counts_match_jax_exactly(B, P, n_tris):
    pts, tris = _scene(B * 1000 + P, B, P, n_tris=n_tris)
    ext_inside, ext_pallas = _jax_masks(pts, tris)
    got = raytri.mesh_contains_points(torch.from_numpy(pts), torch.from_numpy(tris))
    got_bcast = batch_mesh_contains_points(
        torch.from_numpy(pts), torch.from_numpy(tris)
    )
    assert got.dtype == torch.bool and got.shape == (B, P)
    np.testing.assert_array_equal(got.numpy(), ext_inside)
    np.testing.assert_array_equal(got.numpy(), ext_pallas)
    np.testing.assert_array_equal(got_bcast.numpy(), ext_inside)
    if n_tris is None:  # closed meshes: both classes occur
        assert got.any() and (~got).any()


def test_counts_parity_and_range():
    """Counts are int32 in [0, T] and their parity is the exterior mask."""
    pts, tris = _scene(7, 2, 130, n_tris=None)
    table = raytri.triangle_table(torch.from_numpy(tris))
    counts = raytri.raytri_count(torch.from_numpy(pts), table)
    ext = raytri.mesh_contains_points(torch.from_numpy(pts), torch.from_numpy(tris))
    np.testing.assert_array_equal((counts % 2 == 0).numpy(), ext.numpy())
    assert counts.dtype == torch.int32
    assert int(counts.min()) >= 0 and int(counts.max()) <= tris.shape[1]


def test_inside_outside_semantics():
    rng = np.random.default_rng(0)
    verts, faces = icosphere(2)
    tris = torch.from_numpy((verts * 50)[faces][None].astype(np.float32))
    inner = rng.normal(0, 1, (1, 20, 3))
    inner = 25 * inner / np.linalg.norm(inner, axis=-1, keepdims=True)
    pts = torch.from_numpy(np.concatenate([inner, inner * 4], axis=1).astype(np.float32))
    ext = raytri.mesh_contains_points(pts, tris)[0]
    assert not ext[:20].any()
    assert ext[20:].all()


def test_matches_reference_goldens():
    g = np.load(GOLDENS)
    tris = torch.from_numpy(g["inside_obj_verts"].astype(np.float32))[
        :, torch.from_numpy(g["ico_faces"])
    ]
    pts = torch.from_numpy(g["inside_points"].astype(np.float32))
    np.testing.assert_array_equal(
        raytri.mesh_contains_points(pts, tris).numpy(), g["inside_exterior"]
    )
    tris64 = torch.from_numpy(g["inside_obj_verts"])[:, torch.from_numpy(g["ico_faces"])]
    ext64 = batch_mesh_contains_points(torch.from_numpy(g["inside_points"]), tris64)
    np.testing.assert_array_equal(ext64.numpy(), g["inside_exterior"])


def test_plain_chunking_is_invariant(monkeypatch):
    pts, tris = _scene(3, 5, 40)
    table = raytri.triangle_table(torch.from_numpy(tris))
    whole = raytri.raytri_count_plain(torch.from_numpy(pts), table)
    monkeypatch.setattr(raytri, "_PLAIN_ELEMS", 1)  # one batch element per step
    np.testing.assert_array_equal(
        raytri.raytri_count_plain(torch.from_numpy(pts), table).numpy(), whole.numpy()
    )


def test_wrapper_validates_inputs():
    pts = torch.zeros((2, 5, 3))
    table = torch.zeros((2, 4, raytri.TABLE_WIDTH))
    with pytest.raises(TypeError):
        raytri.raytri_count(pts.double(), table)
    with pytest.raises(ValueError):
        raytri.raytri_count(pts, table[:1])
    with pytest.raises(ValueError):
        raytri.raytri_count(pts, table[..., :14])
    with pytest.raises(ValueError):
        raytri.raytri_count(pts.to("meta"), table.to("meta"))

