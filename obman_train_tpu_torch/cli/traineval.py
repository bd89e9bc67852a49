"""Train/eval CLI of the port: the ``traineval.py`` equivalent (the JAX
package's ``cli/traineval.py``), with the same flags, dests and defaults.

Run e.g. (on the GPU; ``OBMAN_PLATFORM=cpu`` for the CPU):

  python -m obman_train_tpu_torch.cli.traineval --train_datasets synthetic \
      --val_datasets synthetic --mano_assets synthetic --epochs 2 \
      --train_batch 8 --atlas_predict_trans

Distributed (one process per card, NCCL; gloo where ranks share a card or
run on the CPU), with torchrun's environment:

  python -m torch.distributed.run --nproc_per_node N \
      -m obman_train_tpu_torch.cli.traineval --distributed ...

``--train_batch`` and ``--test_batch`` stay the global batches; each rank
loads its slice (see ``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MANO training (PyTorch/CUDA)")
    # Dataset options (datasetopts.py)
    d = p.add_argument_group("dataset")
    d.add_argument("--train_datasets", nargs="+", default=["obman"])
    d.add_argument("--train_splits", nargs="+", default=["train"])
    d.add_argument("--val_datasets", nargs="+", default=["obman"])
    d.add_argument("--val_splits", nargs="+", default=["val"])
    d.add_argument("--sides", default="left", choices=["left", "right", "both"])
    d.add_argument("--mini_factor", type=float, default=None)
    d.add_argument("--mode", default="all", choices=["all", "obj", "hand"])
    d.add_argument("--override_scale", action="store_true")
    d.add_argument("--center_idx", type=int, default=9)
    d.add_argument("--atlas_points_nb", type=int, default=600)
    d.add_argument("--controlled_exp", action="store_true")
    d.add_argument("--controlled_size", type=int, default=100000)
    d.add_argument("--workers", type=int, default=None,
                   help="loader workers (default 8, auto-clamped to the "
                        "host's cores; an explicit value is honored "
                        "exactly — oversubscribe for I/O-bound datasets)")
    d.add_argument("--fhbhands_split_type", default="actions")
    d.add_argument("--fhbhands_split_choice", default="1")
    d.add_argument("--fhbhands_topology", default=None)
    d.add_argument("--segment", action="store_true",
                   help="obman: blacken non-hand/object pixels via the segm maps")
    d.add_argument("--synthetic_size", type=int, default=256)
    d.add_argument("--image_size", type=int, default=256,
                   help="input resolution (reference fixes 256; smaller "
                        "values speed up smokes/tests)")
    d.add_argument("--obman_root", default="datasymlinks/obman")
    d.add_argument("--shapenet_root", default="datasymlinks/ShapeNetCore.v2")

    # Model/loss options (nets3dopts.py)
    n = p.add_argument_group("network")
    n.add_argument("--resnet_version", type=int, default=18, choices=[18, 50])
    n.add_argument("--mano_use_shape", action="store_true")
    n.add_argument("--mano_use_pca", action="store_true", default=True)
    n.add_argument("--no_mano_use_pca", dest="mano_use_pca", action="store_false")
    n.add_argument("--mano_comps", type=int, default=30)
    n.add_argument("--mano_adapt_skeleton", action="store_true")
    n.add_argument("--hidden_neurons", nargs="+", type=int, default=[1024, 256])
    n.add_argument("--mano_lambda_joints3d", type=float, default=0.167)
    n.add_argument("--mano_lambda_joints2d", type=float, default=0)
    n.add_argument("--mano_lambda_verts", type=float, default=0.167)
    n.add_argument("--mano_lambda_shape", type=float, default=0.167)
    n.add_argument("--mano_lambda_pca", type=float, default=0.167)
    n.add_argument("--mano_lambda_pose_reg", type=float, default=0)
    n.add_argument("--absolute_lambda", type=float, default=0)
    n.add_argument("--fc_dropout", type=float, default=0)
    n.add_argument("--atlas_lambda", type=float, default=0.167)
    n.add_argument("--atlas_final_lambda", type=float, default=0.167)
    n.add_argument("--atlas_loss", default="chamfer", choices=["chamfer"])
    n.add_argument("--atlas_mesh", dest="atlas_mesh", action="store_true",
                   default=True)
    n.add_argument("--no_atlas_mesh", dest="atlas_mesh", action="store_false")
    n.add_argument("--atlas_residual", action="store_true")
    n.add_argument("--atlas_lambda_regul_edges", type=float, default=0.167)
    n.add_argument("--atlas_lambda_laplacian", type=float, default=0)
    n.add_argument("--atlas_predict_trans", action="store_true")
    n.add_argument("--atlas_predict_scale", action="store_true")
    n.add_argument("--atlas_trans_weight", type=float, default=0.167)
    n.add_argument("--atlas_scale_weight", type=float, default=0.167)
    n.add_argument("--atlas_ico_divisions", type=int, default=3)
    n.add_argument("--atlas_separate_encoder", action="store_true")
    n.add_argument("--contact_target", default="all",
                   choices=["all", "obj", "hand"])
    n.add_argument("--contact_zones", default="zones",
                   choices=["all", "tips", "zones"])
    n.add_argument("--contact_lambda", type=float, default=0)
    n.add_argument("--contact_thresh", type=float, default=10)
    n.add_argument("--contact_mode", default="dist_tanh",
                   choices=["dist_sq", "dist", "dist_tanh"])
    n.add_argument("--collision_lambda", type=float, default=0)
    n.add_argument("--collision_thresh", type=float, default=20)
    n.add_argument("--collision_mode", default="dist_tanh",
                   choices=["dist_sq", "dist", "dist_tanh"])
    n.add_argument("--contact_sym", action="store_true")
    n.add_argument("--regul_decay_gamma", type=float, default=1)
    n.add_argument("--regul_decay_step", type=int, default=300)

    # Training options
    t = p.add_argument_group("training")
    t.add_argument("--epochs", type=int, default=30)
    t.add_argument("--train_batch", type=int, default=32)
    t.add_argument("--test_batch", type=int, default=32)
    t.add_argument("--optimizer", default="adam", choices=["rms", "adam", "sgd"])
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--momentum", type=float, default=0.9)
    t.add_argument("--weight_decay", type=float, default=0)
    t.add_argument("--lr_decay_step", type=int, default=300)
    t.add_argument("--lr_decay_gamma", type=float, default=0.5)
    t.add_argument("--freeze_batchnorm", action="store_true", default=True)
    t.add_argument("--no_freeze_batchnorm", dest="freeze_batchnorm",
                   action="store_false")
    t.add_argument("--freeze_encoder", action="store_true")
    t.add_argument("--atlas_freeze_encoder", action="store_true")
    t.add_argument("--atlas_freeze_decoder", action="store_true")
    t.add_argument("--manual_seed", type=int, default=0)
    t.add_argument("--grad_accum", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer "
                        "update (train_batch must be divisible by it)")
    t.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    t.add_argument("--geometry_dtype", default="float32",
                   choices=["float32", "float32_select", "bfloat16"],
                   help="chamfer/contact selection-plane mode; only float32 "
                        "(the parity path) is ported")
    t.add_argument("--device_augment", action="store_true",
                   help="apply the colour jitter on the device (the host "
                        "only draws the per-sample factors)")

    # Experiment options (expopts.py)
    e = p.add_argument_group("experiment")
    e.add_argument("--exp_id", default="checkpoints/debug")
    e.add_argument("--host_folder", default=None,
                   help="web-hosting folder to mirror metric plots into "
                   "(reference expopts/monitoring.py:40-66)")
    e.add_argument("--loader_processes", action="store_true",
                   help="spawned process workers for augmentation (the "
                   "reference's DataLoader model); threads are the default")
    e.add_argument("--display_freq", type=int, default=500,
                   help="qualitative figure every N batches; 0 disables "
                   "(reference --test_display_freq)")
    e.add_argument("--epoch_display_freq", type=int, default=1,
                   help="render figures only every N epochs")
    e.add_argument("--evaluate", action="store_true")
    e.add_argument("--save_results", action="store_true")
    e.add_argument("--resume", nargs="+", default=None)
    e.add_argument("--atlas_resume", default=None,
                   help="checkpoint whose base_net seeds atlas_base_net "
                        "(reference --atlas_resume, modelio.py:47-55)")
    e.add_argument("--snapshot", type=int, default=5)
    e.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the first train "
                        "epoch to this directory")
    e.add_argument("--compilation_cache", action="store_true",
                   help="accepted for the JAX CLI's sake: eager PyTorch "
                        "compiles nothing, so there is nothing to cache")
    e.add_argument("--mano_assets", default="misc/mano",
                   help="dir with MANO_{LEFT,RIGHT}.{pkl,npz}; 'synthetic' "
                        "uses the test-only synthetic MANO model")
    e.add_argument("--fix_left_shapedirs", action="store_true",
                   help="apply the MANO_LEFT shapedirs mirror fix")
    e.add_argument("--debug", action="store_true")
    e.add_argument("--no_simulate", action="store_true",
                   help="skip the grasp simulation after --evaluate "
                        "(traineval.py:352-364 behaviour)")
    e.add_argument("--vhacd_exe", default=None)
    e.add_argument("--auto_resume", action="store_true",
                   help="resume from <exp_id>/checkpoint when it exists "
                        "(preemption-safe restarts)")
    e.add_argument("--distributed", action="store_true",
                   help="data-parallel training, one process per card, "
                        "launched by torchrun (python -m "
                        "torch.distributed.run); batches stay global")
    return p


def args_to_config(args):
    from obman_train_tpu_torch.config import (
        AtlasConfig,
        ContactConfig,
        DataConfig,
        ExperimentConfig,
        ManoConfig,
        ModelConfig,
        TrainConfig,
    )

    def opt(v):  # 0 -> disabled -> None (reference None/0 lambda semantics)
        return v if v else None

    model = ModelConfig(
        resnet_version=args.resnet_version,
        image_size=args.image_size,
        fc_dropout=args.fc_dropout,
        absolute_lambda=opt(args.absolute_lambda),
        compute_dtype=args.compute_dtype,
        geometry_dtype=args.geometry_dtype,
        mano=ManoConfig(
            ncomps=args.mano_comps,
            base_neurons=tuple(args.hidden_neurons),
            center_idx=args.center_idx,
            use_shape=args.mano_use_shape,
            use_pca=args.mano_use_pca,
            adapt_skeleton=args.mano_adapt_skeleton,
            lambda_verts=opt(args.mano_lambda_verts),
            lambda_joints3d=opt(args.mano_lambda_joints3d),
            lambda_joints2d=opt(args.mano_lambda_joints2d),
            lambda_shape=opt(args.mano_lambda_shape),
            lambda_pose_reg=args.mano_lambda_pose_reg,
            lambda_pca=opt(args.mano_lambda_pca),
        ),
        atlas=AtlasConfig(
            use_residual=args.atlas_residual,
            points_nb=args.atlas_points_nb,
            ico_divisions=args.atlas_ico_divisions,
            predict_trans=args.atlas_predict_trans,
            predict_scale=args.atlas_predict_scale,
            separate_encoder=args.atlas_separate_encoder,
            mesh=args.atlas_mesh,
            lambda_atlas=opt(args.atlas_lambda),
            final_lambda_atlas=opt(args.atlas_final_lambda),
            trans_weight=args.atlas_trans_weight,
            scale_weight=args.atlas_scale_weight,
            lambda_regul_edges=args.atlas_lambda_regul_edges,
            lambda_laplacian=args.atlas_lambda_laplacian,
        ),
        contact=ContactConfig(
            contact_lambda=args.contact_lambda,
            contact_thresh=args.contact_thresh,
            contact_mode=args.contact_mode,
            contact_target=args.contact_target,
            contact_zones=args.contact_zones,
            collision_lambda=args.collision_lambda,
            collision_thresh=args.collision_thresh,
            collision_mode=args.collision_mode,
            contact_sym=args.contact_sym,
        ),
    )
    train = TrainConfig(
        optimizer=args.optimizer,
        lr=args.lr,
        momentum=args.momentum,
        weight_decay=args.weight_decay,
        epochs=args.epochs,
        train_batch=args.train_batch,
        test_batch=args.test_batch,
        lr_decay_step=args.lr_decay_step,
        lr_decay_gamma=args.lr_decay_gamma,
        regul_decay_step=args.regul_decay_step,
        regul_decay_gamma=args.regul_decay_gamma,
        freeze_batchnorm=args.freeze_batchnorm,
        freeze_encoder=args.freeze_encoder,
        atlas_freeze_encoder=args.atlas_freeze_encoder,
        atlas_freeze_decoder=args.atlas_freeze_decoder,
        manual_seed=args.manual_seed,
        snapshot=args.snapshot,
        grad_accum=args.grad_accum,
    )
    data = DataConfig(
        train_datasets=tuple(args.train_datasets),
        train_splits=tuple(args.train_splits),
        val_datasets=tuple(args.val_datasets),
        val_splits=tuple(args.val_splits),
        sides=args.sides,
        mini_factor=args.mini_factor,
        point_nb=args.atlas_points_nb,
        center_idx=args.center_idx,
        mode=args.mode,
        override_scale=args.override_scale,
        workers=8 if args.workers is None else args.workers,
    )
    return ExperimentConfig(
        exp_id=args.exp_id,
        model=model,
        train=train,
        data=data,
        evaluate=args.evaluate,
        save_results=args.save_results,
        mano_assets=args.mano_assets,
        host_folder=args.host_folder,
        display_freq=args.display_freq,
        epoch_display_freq=args.epoch_display_freq,
    )


def load_mano_pair(mano_assets_dir: str, fix_left_shapedirs: bool = False):
    """(right, left) MANO assets: the synthetic model for ``"synthetic"``,
    else ``MANO_{RIGHT,LEFT}.{npz,pkl}`` from the directory (the JAX CLI's
    :297-316)."""
    from obman_train_tpu_torch.assets import load_mano_assets, synthetic_mano_assets

    if mano_assets_dir == "synthetic":
        return synthetic_mano_assets("right"), synthetic_mano_assets("left")
    return (load_mano_assets(mano_assets_dir, "right"),
            load_mano_assets(mano_assets_dir, "left", fix_left_shapedirs=fix_left_shapedirs))


def one_card_notice(device_type: str, cards: int, environ) -> str | None:
    """The line to print when a run without torchrun sees several CUDA
    cards: it trains on one of them. The JAX CLI builds a mesh over every
    local device in one process (its ``cli/traineval.py:483``); the port
    runs one process per card, which torchrun starts. ``None`` otherwise."""
    from obman_train_tpu_torch.parallel.mesh import TORCHRUN_VARS

    if device_type != "cuda" or cards <= 1 or any(v in environ for v in TORCHRUN_VARS):
        return None
    return (f"{cards} CUDA cards are visible and this run trains on one of them; to train "
            f"on all {cards}, launch one rank per card: python -m torch.distributed.run "
            f"--nproc_per_node {cards} -m obman_train_tpu_torch.cli.traineval "
            "--distributed ...")


def _write_opt_txt(exp_id: str, argv) -> None:
    """The command line and git description (argutils.py:35-47)."""
    with open(os.path.join(exp_id, "opt.txt"), "a") as f:
        f.write(" ".join(argv) + "\n")
        try:
            label = subprocess.check_output(
                ["git", "describe", "--always"], stderr=subprocess.DEVNULL).decode().strip()
            commit = subprocess.check_output(
                ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL).decode().strip()
            f.write("=== Git info ====\n")
            f.write(f"{label}\ncommit : {commit}\n")
        except (subprocess.CalledProcessError, FileNotFoundError):
            pass  # not a git checkout


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = args_to_config(args)

    import torch

    from obman_train_tpu_torch.cli import apply_platform_override
    from obman_train_tpu_torch.data.factory import get_dataset
    from obman_train_tpu_torch.data.loader import BatchLoader, ConcatLoader, loader_meta
    from obman_train_tpu_torch.models import build_handnet
    from obman_train_tpu_torch.parallel import barrier, destroy_distributed, init_distributed
    from obman_train_tpu_torch.train import create_train_state, make_optimizer
    from obman_train_tpu_torch.train.checkpoint import (
        CHECKPOINT_NAME,
        load_checkpoint,
        load_checkpoint_lax,
        load_checkpoints_averaged,
        remap_atlas_resume,
    )
    from obman_train_tpu_torch.train.loop import fit
    from obman_train_tpu_torch.weights import init_weights

    device = apply_platform_override()
    rank, world = 0, 1
    if args.distributed:
        # the rank's card (cuda:LOCAL_RANK % cards) and the backend
        info = init_distributed(device="cpu" if device.type == "cpu" else None)
        device, rank, world = info.device, info.rank, info.world
    if args.compilation_cache:
        print("--compilation_cache: eager PyTorch compiles nothing, so there is "
              "nothing to cache")

    if rank == 0:  # rank 0 writes the experiment's files
        os.makedirs(cfg.exp_id, exist_ok=True)
        _write_opt_txt(cfg.exp_id, sys.argv[:1] + list(argv) if argv is not None else sys.argv)
        cfg.to_json(os.path.join(cfg.exp_id, "opt.json"))
    name = f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""
    print(f"Device: {device}{name}")
    notice = one_card_notice(device.type, torch.cuda.device_count(), os.environ)
    if notice:
        print(notice)

    net = build_handnet(cfg.model, *load_mano_pair(cfg.mano_assets, args.fix_left_shapedirs),
                        device=device)
    init_weights(net, seed=cfg.train.manual_seed)
    meta = {
        "mode": cfg.data.mode,
        "segment": args.segment,
        "override_scale": cfg.data.override_scale,
        "size": args.synthetic_size,
        "img_res": args.image_size,
        "obman_root": args.obman_root,
        "shapenet_root": args.shapenet_root,
        "fhbhands_split_type": args.fhbhands_split_type,
        "fhbhands_split_choice": args.fhbhands_split_choice,
        "fhbhands_topology": args.fhbhands_topology,
    }

    def make_loaders(names, splits, train_it, batch_size):
        loaders, metas = [], []
        limit = int(args.controlled_size / len(names)) if args.controlled_exp else None
        for dname, split in zip(names, splits):
            ds = get_dataset(
                dname, split=split, meta=meta, sides=cfg.data.sides,
                train_it=train_it, mini_factor=cfg.data.mini_factor,
                point_nb=cfg.data.point_nb, center_idx=cfg.data.center_idx,
                limit_size=limit, device_augment=args.device_augment,
                inp_res=args.image_size,
            )
            print(f"{dname}/{split}: {len(ds)} samples")
            loaders.append(BatchLoader(
                ds, batch_size=batch_size, shuffle=train_it,
                num_workers=cfg.data.workers, seed=cfg.train.manual_seed,
                use_processes=args.loader_processes,
                process_rank=rank, process_count=world,
                # an explicit --workers is honored; the default is clamped
                # to the host's cores
                clamp_threads=args.workers is None,
            ))
            metas.append(loader_meta(dname, split))
        return ConcatLoader(loaders, metas)

    train_loader = None
    if not cfg.evaluate:
        train_loader = make_loaders(cfg.data.train_datasets, cfg.data.train_splits, True,
                                    cfg.train.train_batch)
    val_loader = make_loaders(cfg.data.val_datasets, cfg.data.val_splits, False,
                              cfg.train.test_batch)

    steps_per_epoch = len(train_loader) if train_loader else 1
    opt = make_optimizer(cfg.train, net)
    state = create_train_state(net, opt, cfg.train, steps_per_epoch=steps_per_epoch)

    start_epoch = 0
    if args.auto_resume and not args.resume and not args.atlas_resume:
        if os.path.exists(os.path.join(cfg.exp_id, CHECKPOINT_NAME)):
            state, start_epoch = load_checkpoint(cfg.exp_id, state)
            print(f"Auto-resumed from epoch {start_epoch}")
    if args.atlas_resume:
        if args.resume:
            raise NotImplementedError("resume and atlas_resume incompatible for now")
        # the separate object encoder starts from the checkpoint's image
        # encoder (modelio.py:47-55)
        remap = remap_atlas_resume if cfg.model.atlas.separate_encoder else None
        state, start_epoch = load_checkpoint_lax(args.atlas_resume, state, remap=remap)
        print(f"Loaded ATLAS checkpoint from epoch {start_epoch}")
    if args.resume:
        if len(args.resume) == 1:
            try:
                state, start_epoch = load_checkpoint(args.resume[0], state)
            except (RuntimeError, ValueError, KeyError) as e:
                # structure mismatch: strict -> lax (reload.py:103-110)
                print(f"Strict restore failed; falling back to lax restore. Cause: {e}")
                state, start_epoch = load_checkpoint_lax(args.resume[0], state)
            print(f"Resumed from epoch {start_epoch}")
        else:
            if not cfg.evaluate:
                raise ValueError("Multiple checkpoint resume only works in evaluate mode")
            state, start_epoch = load_checkpoints_averaged(args.resume, state)

    if cfg.evaluate:
        cfg = cfg.replace(train=cfg.train.replace(epochs=start_epoch + 1))

    try:
        state, metrics = fit(cfg, state, train_loader, val_loader, start_epoch=start_epoch,
                             profile_dir=args.profile_dir)
        # every rank's result pickles are written before rank 0 reads them
        barrier()
    finally:
        if args.distributed:
            destroy_distributed()
    if cfg.evaluate:
        print("Eval metrics:", {k: round(float(v), 4) for k, v in metrics.items()})
        if cfg.save_results and not args.no_simulate and rank == 0:
            from obman_train_tpu_torch.simulation import full_simul

            sim_dir = os.path.join(cfg.exp_id, "save_results", "val", f"epoch_{start_epoch}")
            summary = full_simul(sim_dir, workers=cfg.data.workers,
                                 vhacd_exe=args.vhacd_exe, device=device)
            print("Simulation:", summary)
    print("All done !")
    return state, metrics


if __name__ == "__main__":
    main()
