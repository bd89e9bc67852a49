"""The ``geometry_dtype`` selection-plane rungs and the two env switches of
the port (``ops/chamfer.py``, ``ops/contact.py``, ``models/losses.py``)
against the JAX package on the CPU, from the same seeded numpy clouds
(the JAX package's own tests are the model: tests/test_geometry_ops.py:91-325,
tests/test_losses.py:49-75).

- ``float32_select``: the argmins equal JAX's exactly and the values (the
  direct difference of the selected pair) agree to rtol 1e-4; against
  the parity path the selections agree for > 99.9 % (JAX's own bound).
- ``bfloat16``: a selection may differ from JAX's only at a near-tie: the
  two selected pairs' exact values then differ by less than the plane's
  resolution, 2^-8 times the plane's largest magnitude (JAX's bound),
  and every value is >= the parity min less 0.5 mm^2; > 80 % of the
  selections agree outright (JAX's bound).
- Gradients flow through the selected pairs while the plane is dead: no
  tensor of the plane's size is saved for the backward.
- The contact terms under each rung: ``float32_select`` equals the parity
  path to rtol 1e-5 and JAX's rung to rtol 1e-5; ``bfloat16`` stays in
  JAX's recorded envelope (rtol/atol 0.05) of the parity path.
- ``OBMAN_SCATTER_BWD=1``: forward values bit for bit the plane's,
  gradients the plane's autograd to atol 1e-6 (JAX's bound) and JAX's
  scatter VJP to rtol 1e-5, atol 1e-6.
- ``OBMAN_STACK_ATLAS=1``: bit for bit the two-call form in values,
  gradients to rtol 1e-6 (JAX's bound), and JAX's stacked form to rtol
  1e-5.
- Both switches are read once, at import, in both packages: the tests
  set the module constants (``_SCATTER_BWD``, ``_STACK_ATLAS_PLANES``) in
  both, and a child process checks the reading of the variables.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obman_train_tpu.assets import icosphere as jax_icosphere
from obman_train_tpu.config import AtlasConfig as JAtlas
from obman_train_tpu.models import losses as jlosses
from obman_train_tpu.ops import chamfer as jchamfer
from obman_train_tpu.ops.contact import compute_contact_loss as jax_contact
from obman_train_tpu_torch import config as tcfg
from obman_train_tpu_torch.models import losses
from obman_train_tpu_torch.ops import chamfer
from obman_train_tpu_torch.ops.contact import compute_contact_loss

torch.set_num_threads(2)

RUNGS = {"float32_select": (torch.float32, jnp.float32),
         "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clouds(seed, b=3, n=778, m=642, scale=60.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, scale, (b, n, 3)).astype(np.float32),
            rng.normal(0, scale, (b, m, 3)).astype(np.float32))


def _exact(x, y, argx):
    """|x_i - y_argx(i)|^2 in float64."""
    sel = np.take_along_axis(y.astype(np.float64), argx[..., None], axis=1)
    return ((x.astype(np.float64) - sel) ** 2).sum(-1)


def test_plane_dtype_for_matches_jax():
    for name in ("float32", "float32_select", "bfloat16"):
        want = jchamfer.plane_dtype_for(name)
        got = chamfer.plane_dtype_for(name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert str(got).split(".")[-1] == jnp.dtype(want).name, name
    with pytest.raises(ValueError, match="geometry_dtype"):
        chamfer.plane_dtype_for("float16_select")


def test_float32_select_matches_jax_and_the_parity_path():
    x, y = _clouds(0)
    got = chamfer.chamfer_min_sqdist(torch.from_numpy(x), torch.from_numpy(y),
                                     use_kernel=False, plane_dtype=torch.float32)
    want = jchamfer.chamfer_min_sqdist(jnp.asarray(x), jnp.asarray(y), use_pallas=False,
                                       plane_dtype=jnp.float32)
    for i in (1, 3):  # argmins exactly
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    for i in (0, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-4)
        assert (got[i] >= 0).all()  # the direct form
    base = chamfer.chamfer_min_sqdist(torch.from_numpy(x), torch.from_numpy(y),
                                      use_kernel=False)
    assert (base[1] == got[1]).float().mean() > 0.999
    assert (base[3] == got[3]).float().mean() > 0.999


@pytest.mark.parametrize("seed", [0, 1])
def test_bfloat16_selection_differs_only_at_near_ties(seed):
    """Seed 0 draws the clouds of JAX's own test (its ``rng`` fixture);
    the plane-resolution bound on the value error is JAX's, held where
    JAX's test holds it: on seed 1 the JAX package's own bf16 selection
    exceeds it (595 mm^2 against 484), and the port's is the same."""
    x, y = _clouds(seed)
    got = chamfer.chamfer_min_sqdist(torch.from_numpy(x), torch.from_numpy(y),
                                     use_kernel=False, plane_dtype=torch.bfloat16)
    want = jchamfer.chamfer_min_sqdist(jnp.asarray(x), jnp.asarray(y), use_pallas=False,
                                       plane_dtype=jnp.bfloat16)
    base = chamfer.chamfer_min_sqdist(torch.from_numpy(x), torch.from_numpy(y),
                                      use_kernel=False)
    mag = float((x ** 2).sum(-1).max() + (y ** 2).sum(-1).max())
    tol = 2.0 ** -8 * mag  # the bf16 plane's resolution (JAX's bound)
    for (q, s), i in (((x, y), 0), ((y, x), 2)):
        arg, jarg = got[i + 1].numpy(), np.asarray(want[i + 1])
        differ = arg != jarg
        # where the two packages select different pairs, the pairs' exact
        # values are within the plane's resolution of each other
        gap = np.abs(_exact(q, s, arg) - _exact(q, s, jarg))
        assert gap[differ].max(initial=0.0) < tol, (int(differ.sum()), gap.max())
        assert (arg == jarg).mean() > 0.8
        vals = got[i].numpy()
        np.testing.assert_allclose(vals, _exact(q, s, arg), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(vals, np.asarray(want[i]), rtol=1e-5, atol=1e-3)
        assert (vals >= base[i].numpy() - 0.5).all()
        excess = float(np.max(vals - base[i].numpy()))
        if seed == 0:
            assert excess < tol
        else:
            assert excess == pytest.approx(float(np.max(np.asarray(want[i]) - base[i].numpy())),
                                           rel=1e-4)


@pytest.mark.parametrize("gd", sorted(RUNGS))
def test_chamfer_loss_and_min_sqdist_to_rungs_match_jax(gd):
    tdt, jdt = RUNGS[gd]
    x, y = _clouds(2, b=2, n=600, m=642)
    l1, l2 = chamfer.chamfer_loss(torch.from_numpy(x), torch.from_numpy(y),
                                  use_kernel=False, plane_dtype=tdt)
    j1, j2 = jchamfer.chamfer_loss(jnp.asarray(x), jnp.asarray(y), use_pallas=False,
                                   plane_dtype=jdt)
    m = chamfer.min_sqdist_to(torch.from_numpy(x), torch.from_numpy(y), use_kernel=False,
                              plane_dtype=tdt)
    jm = jchamfer.min_sqdist_to(jnp.asarray(x), jnp.asarray(y), use_pallas=False,
                                plane_dtype=jdt)
    if gd == "float32_select":
        for a, b in ((l1, j1), (l2, j2), (m, jm)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)
    else:  # per-example means of near-tie-bounded values
        mag = float((x ** 2).sum(-1).max() + (y ** 2).sum(-1).max())
        for a, b in ((l1, j1), (l2, j2)):
            assert np.abs(a.numpy() - np.asarray(b)).max() < 2.0 ** -8 * mag
        assert np.abs(m.numpy() - np.asarray(jm)).max() < 2.0 ** -8 * mag


def _saved_numels(fn):
    """The element counts of every tensor autograd saves while ``fn`` runs."""
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sizes


@pytest.mark.parametrize("gd", sorted(RUNGS))
def test_rung_gradients_flow_and_the_plane_is_dead(gd):
    tdt, jdt = RUNGS[gd]
    x, y = _clouds(3, b=2, n=64, m=48)

    def loss(p, g, dt):
        l1, l2 = chamfer.chamfer_loss(p, g, use_kernel=False, plane_dtype=dt)
        return torch.mean(l1 + l2)

    def grads(dt):
        p = torch.from_numpy(y).requires_grad_()
        g = torch.from_numpy(x).requires_grad_()
        out, sizes = _saved_numels(lambda: loss(p, g, dt))
        out.backward()
        return p.grad.numpy(), g.grad.numpy(), max(sizes)

    plane = 2 * 64 * 48
    gp, gg, biggest = grads(tdt)
    assert biggest < plane  # the selection plane is not saved
    _, _, parity_biggest = grads(None)
    assert parity_biggest >= plane  # the parity path saves it
    jg = jax.grad(lambda p, g: jnp.mean(sum(jchamfer.chamfer_loss(
        p, g, use_pallas=False, plane_dtype=jdt))), argnums=(0, 1))(
        jnp.asarray(y), jnp.asarray(x))
    for a, b in zip((gp, gg), jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    if gd == "float32_select":  # the min subgradient of the parity path
        jb = jax.grad(lambda p, g: jnp.mean(sum(jchamfer.chamfer_loss(p, g))),
                      argnums=(0, 1))(jnp.asarray(y), jnp.asarray(x))
        for a, b in zip((gp, gg), jb):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)


def test_contact_loss_geometry_dtype_rung_matches_jax():
    verts, faces = jax_icosphere(2)
    rng = np.random.default_rng(4)
    b = 2
    hand = rng.normal(0, 30, (b, 778, 3)).astype(np.float32)
    obj = (40.0 * np.asarray(verts)[None] + rng.normal(0, 1, (b, 1, 3))).astype(np.float32)
    kw = dict(contact_mode="dist_tanh", collision_mode="dist_tanh", contact_zones="zones")
    outs, jouts = {}, {}
    for gd in ("float32", "float32_select", "bfloat16"):
        attr, pen, info, _ = compute_contact_loss(
            torch.from_numpy(hand), torch.from_numpy(obj),
            torch.from_numpy(np.asarray(faces, np.int64)), geometry_dtype=gd, **kw)
        jattr, jpen, jinfo, _ = jax_contact(jnp.asarray(hand), jnp.asarray(obj),
                                            jnp.asarray(faces), geometry_dtype=gd, **kw)
        outs[gd] = (float(attr), float(pen))
        jouts[gd] = (float(jattr), float(jpen))
        np.testing.assert_array_equal(info["repulsion_masks"].numpy(),
                                      np.asarray(jinfo["repulsion_masks"]))
    np.testing.assert_allclose(outs["float32"], jouts["float32"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs["float32_select"], outs["float32"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs["float32_select"], jouts["float32_select"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(outs["bfloat16"], outs["float32"], rtol=0.05, atol=0.05)
    np.testing.assert_allclose(outs["bfloat16"], jouts["bfloat16"], rtol=0.05, atol=0.05)


@pytest.fixture
def scatter(monkeypatch):
    """OBMAN_SCATTER_BWD=1 in both packages (each reads it at import)."""
    monkeypatch.setattr(chamfer, "_SCATTER_BWD", True)
    monkeypatch.setattr(jchamfer, "_SCATTER_BWD", True)


def test_scatter_backward_chamfer_loss_matches_plane_and_jax(scatter):
    y, x = _clouds(5, b=2, n=600, m=642)  # preds (600), gts (642)

    def port(fn):
        p = torch.from_numpy(y).requires_grad_()
        g = torch.from_numpy(x).requires_grad_()
        out = fn(p, g)
        out.backward()
        return out.detach(), p.grad, g.grad

    def new_loss(p, g):
        l1, l2 = chamfer.chamfer_loss(p, g, use_kernel=False)
        return torch.mean(l1) + 2.0 * torch.mean(l2)

    def plane_loss(p, g):
        d = chamfer.batch_pairwise_sqdist(g, p)
        return torch.mean(torch.amin(d, 1).mean(1)) + 2.0 * torch.mean(torch.amin(d, 2).mean(1))

    new, old = port(new_loss), port(plane_loss)
    assert torch.equal(new[0], old[0])
    for a, b in zip(new[1:], old[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    jg = jax.grad(lambda p, g: jnp.mean(jchamfer.chamfer_loss(p, g, use_pallas=False)[0])
                  + 2.0 * jnp.mean(jchamfer.chamfer_loss(p, g, use_pallas=False)[1]),
                  argnums=(0, 1))(jnp.asarray(y), jnp.asarray(x))
    for a, b in zip(new[1:], jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_scatter_backward_min_sqdist_matches_plane_and_jax(scatter):
    x, y = _clouds(6, b=2, n=778, m=642)

    def consume(mins):  # thresholded mins both ways, as the contact terms
        minx, _, miny, _ = mins
        return torch.mean(torch.clamp(minx, max=25.0)) + 2.0 * torch.mean(torch.sqrt(miny + 1e-6))

    def port(fn):
        a = torch.from_numpy(x).requires_grad_()
        b = torch.from_numpy(y).requires_grad_()
        mins = fn(a, b)
        consume(mins).backward()
        return mins, a.grad, b.grad

    new = port(lambda a, b: chamfer.chamfer_min_sqdist(a, b, use_kernel=False))
    old = port(chamfer._plane_argmin)
    for i in range(4):
        assert torch.equal(new[0][i], old[0][i])
    for a, b in zip(new[1:], old[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)

    def jconsume(a, b):
        minx, _, miny, _ = jchamfer.chamfer_min_sqdist(a, b, use_pallas=False)
        return jnp.mean(jnp.minimum(minx, 25.0)) + 2.0 * jnp.mean(jnp.sqrt(miny + 1e-6))

    jg = jax.grad(jconsume, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    for a, b in zip(new[1:], jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def _atlas_case(seed=7, B=2):
    rng = np.random.default_rng(seed)
    preds = {
        "objpoints3d": rng.normal(0, 40, (B, 642, 3)).astype(np.float32),
        "objpointscentered3d": rng.normal(0, 40, (B, 642, 3)).astype(np.float32),
        "objtrans": rng.normal(0, 10, (B, 3)).astype(np.float32),
        "objscale": rng.uniform(50, 80, (B, 1)).astype(np.float32),
    }
    batch = {"objpoints3d": rng.normal(0, 40, (B, 600, 3)).astype(np.float32)}
    return preds, batch


def _port_atlas(preds, batch, stacked, monkeypatch, grad_key=None):
    monkeypatch.setattr(losses, "_STACK_ATLAS_PLANES", stacked)
    p = {k: torch.from_numpy(v).requires_grad_(k == grad_key) for k, v in preds.items()}
    total, ls = losses.compute_atlas_loss(
        p, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg.AtlasConfig(),
        has_objpoints3d=True, has_center3d=False, obj_faces=None, laplacian=None)
    if grad_key is None:
        return total.detach(), {k: v.detach() for k, v in ls.items()}
    total.backward()
    return p[grad_key].grad


@pytest.mark.parametrize("gd", ["float32", "float32_select"])
def test_stacked_atlas_matches_two_calls_and_jax(gd, monkeypatch):
    preds, batch = _atlas_case()
    monkeypatch.setattr(jlosses, "_STACK_ATLAS_PLANES", True)
    jtotal, jl = jlosses.compute_atlas_loss(
        {k: jnp.asarray(v) for k, v in preds.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, JAtlas(), has_objpoints3d=True,
        has_center3d=False, obj_faces=None, laplacian=None, geometry_dtype=gd)
    monkeypatch.setattr(losses, "_STACK_ATLAS_PLANES", True)
    p = {k: torch.from_numpy(v) for k, v in preds.items()}
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, ls = losses.compute_atlas_loss(p, b, tcfg.AtlasConfig(), True, False, None, None,
                                          geometry_dtype=gd)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    assert set(ls) == set(jl)
    for k in jl:
        np.testing.assert_allclose(float(ls[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    monkeypatch.setattr(losses, "_STACK_ATLAS_PLANES", False)
    total2, ls2 = losses.compute_atlas_loss(p, b, tcfg.AtlasConfig(), True, False, None,
                                            None, geometry_dtype=gd)
    assert torch.equal(total, total2)
    assert all(torch.equal(ls[k], ls2[k]) for k in ls2)


def test_stacked_atlas_gradients_match_two_calls(monkeypatch):
    preds, batch = _atlas_case(8)
    for key in ("objpointscentered3d", "objpoints3d"):
        g_stack = _port_atlas(preds, batch, True, monkeypatch, grad_key=key)
        g_two = _port_atlas(preds, batch, False, monkeypatch, grad_key=key)
        torch.testing.assert_close(g_stack, g_two, rtol=1e-6, atol=1e-8, msg=key)


@pytest.mark.parametrize("var,module,attr", [
    ("OBMAN_SCATTER_BWD", "ops.chamfer", "_SCATTER_BWD"),
    ("OBMAN_STACK_ATLAS", "models.losses", "_STACK_ATLAS_PLANES"),
])
def test_switches_are_read_at_import_in_both_packages(var, module, attr):
    code = (
        "import importlib, os\n"
        f"a = importlib.import_module('obman_train_tpu_torch.{module}')\n"
        f"b = importlib.import_module('obman_train_tpu.{module}')\n"
        f"os.environ['{var}'] = '0'\n"  # later changes are not read
        f"print(a.{attr}, b.{attr})\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", **{var: "1"})
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.split() == ["True", "True"]
