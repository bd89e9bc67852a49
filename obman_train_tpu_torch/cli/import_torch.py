"""Import a reference (PyTorch) HandNet checkpoint into the port (the JAX
package's ``cli/import_torch.py``).

Takes a ``checkpoint.pth.tar`` produced by hassony2/obman_train (plus its
``opt.pkl`` beside it, or the same settings as flags), builds the port's
HandNet for that configuration and saves a port experiment
(``checkpoint.pth.tar`` + ``opt.json``) that every CLI of the port and
``demo.DemoModel`` read:

  python -m obman_train_tpu_torch.cli.import_torch \
      --torch_checkpoint release_models/obman/checkpoint.pth.tar \
      --mano_assets misc/mano --resnet_version 18 --mano_comps 30 \
      --atlas_predict_trans --atlas_predict_scale --exp_id checkpoints/ported

The port's modules carry the reference state_dict keys, so the weights go
over by name: every tensor of the port's net found in the checkpoint is
copied (a shape that differs raises), the rest keep their seeded init, and
keys the configuration has no module for are left out, as the JAX
importer does (train/checkpoint.py:200-354).
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

def _build_parser(suppress_defaults: bool = False) -> argparse.ArgumentParser:
    """The importer's parser.  ``suppress_defaults=True`` builds a twin
    whose defaults are all ``argparse.SUPPRESS`` — parsing argv with it
    yields ONLY the attributes the user explicitly passed (robust to
    argparse prefix abbreviations and ``--flag=value`` spellings, unlike
    string-matching raw argv)."""
    parser = argparse.ArgumentParser()
    S = argparse.SUPPRESS

    def d(value):
        return S if suppress_defaults else value

    parser.add_argument("--torch_checkpoint", required=True)
    parser.add_argument("--exp_id", required=True)
    parser.add_argument("--mano_assets", default=d("misc/mano"))
    parser.add_argument("--resnet_version", type=int, default=d(18))
    parser.add_argument("--mano_comps", type=int, default=d(30),
                        help="release demo models use 30 (reload.py:93)")
    parser.add_argument("--hidden_neurons", nargs="+", type=int,
                        default=d([1024, 256]))
    parser.add_argument("--mano_use_shape", action="store_true",
                        default=d(False))
    parser.add_argument("--atlas_predict_trans", action="store_true",
                        default=d(False))
    parser.add_argument("--atlas_predict_scale", action="store_true",
                        default=d(False))
    parser.add_argument("--atlas_separate_encoder", action="store_true",
                        default=d(False))
    parser.add_argument("--atlas_resume_remap", action="store_true",
                        default=d(False),
                        help="remap base_net.* to atlas_base_net.*")
    parser.add_argument("--imagenet_encoder", action="store_true",
                        default=d(False),
                        help="the checkpoint is a BARE torchvision ResNet "
                        "state_dict (e.g. resnet18-5c106cde.pth): import it "
                        "into the encoder(s) only, leave every branch at its "
                        "fresh init — the reference's pretrained=True "
                        "bootstrap (mano_train/networks/bases/resnet.py:"
                        "191-224) for training from scratch; resume the "
                        "result with --resume")
    parser.add_argument("--validate", action="store_true", default=d(False),
                        help="after the import, run the reference repo's own "
                        "torch modules (OBMAN_REFERENCE names its root) and "
                        "compare their outputs with the port's forward")
    parser.add_argument("--opt_pkl", default=d(None),
                        help="reference opt.pkl beside the checkpoint; when "
                        "given (or auto-detected next to the checkpoint) the "
                        "model flags above are filled from it with the "
                        "reference's backfill defaults (reload.py:42-100)")
    return parser


def _fill_from_opt(args, opt_pkl: str, argv) -> None:
    """The model flags from a reference ``opt.pkl`` with the reference's
    backfill defaults for old checkpoints (reload.py:42-100); an explicit
    flag wins over the pkl. Explicitness comes from a SUPPRESS-defaults
    re-parse, which resolves abbreviations and ``=`` spellings as argparse
    does."""
    with open(opt_pkl, "rb") as f:
        opts = pickle.load(f)
    if not isinstance(opts, dict):  # argparse.Namespace in old pickles
        opts = vars(opts)
    raw = argv if argv is not None else sys.argv[1:]
    explicit = set(vars(_build_parser(suppress_defaults=True).parse_args(raw)))

    def fill(name, value):
        if name not in explicit:
            setattr(args, name, value)

    fill("resnet_version", int(opts.get("resnet_version", 18)))
    # ncomps is absent from old release pkls; the release models use 30
    # (reload.py:93): honor it when recorded
    fill("mano_comps", int(opts.get("mano_comps", 30)))
    fill("hidden_neurons", list(opts.get("hidden_neurons", [1024, 256])))
    fill("mano_use_shape", bool(opts.get("use_shape", args.mano_use_shape)))
    fill("atlas_predict_trans", bool(opts.get("atlas_predict_trans", False)))
    fill("atlas_predict_scale", bool(opts.get("atlas_predict_scale", False)))
    fill("atlas_separate_encoder", bool(opts.get("atlas_separate_encoder", False)))
    args.mano_lambda_joints2d = opts.get("mano_lambda_joints2d", 0) or None
    args.absolute_lambda = opts.get("absolute_lambda", 0) or None
    print(f"Filled model flags from {opt_pkl}")


def experiment_config(args):
    """The port's ExperimentConfig of the importer's flags (JAX :143-166)."""
    from obman_train_tpu_torch.config import (
        AtlasConfig,
        ExperimentConfig,
        ManoConfig,
        ModelConfig,
    )

    return ExperimentConfig(
        exp_id=args.exp_id,
        mano_assets=args.mano_assets,
        model=ModelConfig(
            resnet_version=args.resnet_version,
            absolute_lambda=args.absolute_lambda,
            mano=ManoConfig(
                ncomps=args.mano_comps,
                base_neurons=tuple(args.hidden_neurons),
                use_shape=args.mano_use_shape,
                lambda_joints2d=args.mano_lambda_joints2d,
            ),
            atlas=AtlasConfig(
                predict_trans=args.atlas_predict_trans,
                predict_scale=args.atlas_predict_scale,
                separate_encoder=args.atlas_separate_encoder,
            ),
        ),
    )


def _copy_by_name(net, state: dict, prefix: str = "") -> int:
    """Copy into ``net`` every tensor of its state_dict whose name, less
    ``prefix``, ``state`` holds (only names under ``prefix``); a shape that
    differs raises. Returns the count."""
    import torch

    copied = 0
    with torch.no_grad():
        for name, target in net.state_dict().items():
            if not name.startswith(prefix) or name[len(prefix):] not in state:
                continue
            value = torch.as_tensor(state[name[len(prefix):]])
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(value.shape)}, "
                                 f"model shape {tuple(target.shape)}")
            target.copy_(value)
            copied += 1
    return copied


def main(argv=None):
    args = _build_parser().parse_args(argv)
    if args.validate and args.imagenet_encoder:
        raise SystemExit(
            "--validate re-runs the reference HandNet torch graph and does "
            "not apply to a bare torchvision encoder import"
        )

    import torch

    from obman_train_tpu_torch.cli import apply_platform_override
    from obman_train_tpu_torch.cli.traineval import load_mano_pair
    from obman_train_tpu_torch.models import build_handnet
    from obman_train_tpu_torch.train import create_train_state, make_optimizer
    from obman_train_tpu_torch.train.checkpoint import (
        remap_atlas_resume,
        save_checkpoint,
        strip_module_prefix,
    )
    from obman_train_tpu_torch.weights import init_weights

    device = apply_platform_override()

    opt_pkl = args.opt_pkl
    if args.imagenet_encoder:
        opt_pkl = None  # a bare torchvision file has no opt.pkl semantics
    elif opt_pkl is None:
        candidate = os.path.join(
            os.path.dirname(os.path.abspath(args.torch_checkpoint)), "opt.pkl")
        if os.path.exists(candidate):
            opt_pkl = candidate
    if opt_pkl:
        _fill_from_opt(args, opt_pkl, argv)
    else:
        args.mano_lambda_joints2d = None
        args.absolute_lambda = None

    cfg = experiment_config(args)
    net = build_handnet(cfg.model, *load_mano_pair(cfg.mano_assets), device="cpu")
    init_weights(net, seed=cfg.train.manual_seed)

    payload = torch.load(args.torch_checkpoint, map_location="cpu", weights_only=False)
    state = strip_module_prefix(dict(payload.get("state_dict", payload)))
    epoch = int(payload.get("epoch", 0))
    if args.imagenet_encoder:
        # Bare torchvision ResNet -> encoder(s) only; branches stay at their
        # fresh init, the reference's pretrained=True bootstrap
        # (bases/resnet.py:191-224 via handnet.py:40-48), which loads the
        # SAME ImageNet weights into every encoder it builds.
        encoders = [e for e in ("base_net", "atlas_base_net")
                    if getattr(net, e, None) is not None]
        n = sum(_copy_by_name(net, state, prefix=f"{e}.") for e in encoders)
        epoch = 0
        message = f"Imported ImageNet encoder ({n} tensors) into {encoders}"
    else:
        if args.atlas_resume_remap:
            state = remap_atlas_resume(state)
        n = _copy_by_name(net, state)
        message = f"Imported {n} of {len(state)} torch tensors from epoch {epoch}"
    net.to(device)
    train_state = create_train_state(net, make_optimizer(cfg.train, net), cfg.train)
    path = save_checkpoint(args.exp_id, train_state, epoch, config=cfg)
    print(f"{message} -> {path}")
    print(f"Use it with: --resume {args.exp_id} or DemoModel('{args.exp_id}')")
    if args.validate:
        _validate_import(args, cfg, net, state)
    return train_state


def _validate_import(args, cfg, net, state):
    """Run the reference's OWN torch modules on the imported weights and
    compare with the port's modules (the JAX :236-406 check): image ->
    features -> {pose, shape, scaletrans, objpoints3d}. Needs the reference
    repo importable from ``$OBMAN_REFERENCE``; its MANO layer needs
    manopth, so the kinematics are not compared."""
    import types

    import numpy as np
    import torch

    ref_root = os.environ.get("OBMAN_REFERENCE")
    if not ref_root or not os.path.isdir(ref_root):
        print("--validate skipped: set OBMAN_REFERENCE to the reference repo's root")
        return
    if ref_root not in sys.path:
        sys.path.insert(0, ref_root)
    # AtlasBranch imports trimesh only for its icosphere template; serve the
    # identical local icosphere when trimesh is absent.
    if "trimesh" not in sys.modules:
        try:
            import trimesh  # noqa: F401
        except ImportError:
            from obman_train_tpu_torch.assets.icosphere import icosphere

            iv, ifc = icosphere(3)
            tm = types.ModuleType("trimesh")
            tm.creation = types.SimpleNamespace(
                icosphere=lambda subdivisions=3: types.SimpleNamespace(
                    vertices=iv.astype(np.float64), faces=ifc))
            tm.proximity = types.SimpleNamespace()
            sys.modules["trimesh"] = tm
    cuda = torch.Tensor.cuda
    torch.Tensor.cuda = lambda self, *a, **k: self
    try:
        from mano_train.networks.bases import resnet as ref_resnet
        from mano_train.networks.branches.absolutebranch import AbsoluteBranch
        from mano_train.networks.branches.atlasbranch import AtlasBranch
    except ImportError as e:
        torch.Tensor.cuda = cuda
        print(f"--validate skipped: cannot import reference modules ({e})")
        return

    try:
        feat = {18: 512, 50: 2048}[args.resnet_version]
        ref = torch.nn.Module()
        ref.base_net = getattr(ref_resnet, f"resnet{args.resnet_version}")(pretrained=False)
        has = lambda p: any(k.startswith(p) for k in state)  # noqa: E731
        if has("atlas_base_net."):
            ref.atlas_base_net = getattr(ref_resnet, f"resnet{args.resnet_version}")(
                pretrained=False)
        if has("scaletrans_branch."):
            ref.scaletrans_branch = AbsoluteBranch(base_neurons=[feat, feat // 2], out_dim=3)
        if has("mano_branch."):
            m = torch.nn.Module()
            neurons = [feat] + list(args.hidden_neurons)
            layers = []
            for inp, out in zip(neurons[:-1], neurons[1:]):
                layers += [torch.nn.Linear(inp, out), torch.nn.ReLU()]
            m.base_layer = torch.nn.Sequential(*layers)
            m.pose_reg = torch.nn.Linear(neurons[-1], args.mano_comps + 3)
            if has("mano_branch.shape_reg."):
                m.shape_reg = torch.nn.Sequential(torch.nn.Linear(neurons[-1], 10))
            ref.mano_branch = m
        if has("atlas_branch."):
            ref.atlas_branch = AtlasBranch(
                use_residual=has("atlas_branch.decoder.residual1"),
                bottleneck_size=feat,
                predict_trans=args.atlas_predict_trans,
                predict_scale=args.atlas_predict_scale,
                separate_encoder=args.atlas_separate_encoder,
            )
        missing, _ = ref.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state.items()
             if not k.startswith("mano_branch.mano_layer")}, strict=False)
        if missing:
            print(f"--validate: {len(missing)} torch keys not rebuilt "
                  f"(e.g. {missing[:3]}): those paths are not compared")
        ref.eval()
        net = net.to("cpu").eval()
        gen = torch.Generator().manual_seed(0)
        img = torch.randn(2, 3, cfg.model.image_size, cfg.model.image_size, generator=gen) * 0.3
        with torch.no_grad():
            want, got = _probe(ref, img), _probe(net, img)
    finally:
        torch.Tensor.cuda = cuda

    ok = True
    for key, w in want.items():
        if key not in got:
            continue
        delta = float(np.max(np.abs(got[key] - w)))
        tol = 2e-2 if key == "objpoints3d" else 1e-4  # atlas is x200-scaled
        ok = ok and delta <= tol
        print(f"--validate {'OK ' if delta <= tol else 'FAIL'} {key}: "
              f"max |port - reference| = {delta:.2e} (tol {tol:g})")
    print("--validate: PASS" if ok else "--validate: FAIL: imported weights do not "
          "reproduce the reference forward; check the flags above")
    if not ok:
        raise SystemExit(2)


def _probe(model, img):
    """features, pose, shape, scaletrans and objpoints3d of an NCHW batch,
    through the reference's module names (which the port's modules carry)."""
    feats, _ = model.base_net(img)
    out = {"features": feats.numpy()}
    mano = getattr(model, "mano_branch", None)
    if mano is not None:
        base = mano.base_layer(feats)
        out["pose"] = mano.pose_reg(base).numpy()
        if getattr(mano, "shape_reg", None) is not None:
            out["shape"] = mano.shape_reg(base).numpy()
    if getattr(model, "scaletrans_branch", None) is not None:
        out["scaletrans"] = model.scaletrans_branch(feats).numpy()
    if getattr(model, "atlas_branch", None) is not None:
        kw = {}
        if getattr(model, "atlas_base_net", None) is not None:
            kw["separate_encoder_features"] = model.atlas_base_net(img)[0]
        out["objpoints3d"] = model.atlas_branch.forward_inference(feats, **kw)[
            "objpoints3d"].numpy()
    return out


if __name__ == "__main__":
    main()
