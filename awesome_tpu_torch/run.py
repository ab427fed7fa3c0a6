"""Run a single experiment from a config; counterpart of
``scripts/run.py``.

    python -m awesome_tpu_torch.run [--config-path my_experiment.yaml] \\
        [--num-epochs 100 ...any config field as a flag...]

A convexity config builds the data (the on-disk convexity dataset, or the
synthetic replica), pretrains the per-image priors, trains seg net and
prior jointly per image, evaluates, checkpoints and writes a run folder.
An FBMS config (its dataset type, or the nested dataset's class, is an
FBMS sequence dataset) runs one of the FBMS experiment families through
``runner/fbms_runner.py`` (:func:`main_fbms`). It runs on the card;
``--device cpu`` runs it on the CPU. A config file may be one this package
or the JAX package wrote, or an unmodified reference YAML.

``--mesh-shape "[2, 2]"`` (``mesh_shape: [data, grid]``) runs the experiment on
a device mesh: this entry point starts one process per mesh position
(``parallel/launch.py``; the ranks take the cards round robin, ``-1``
absorbs the card count) and every rank runs the experiment (SPMD); rank 0
writes the run folder. Under ``torchrun`` the ranks are torchrun's and
``-1`` absorbs its world size.
"""
from __future__ import annotations

import logging
import os
import re
from typing import List, Optional


def config_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")


def get_config(argv: Optional[List[str]] = None):
    from awesome_tpu_torch.runner.config import AwesomeConfig, translate_device

    parser = AwesomeConfig.get_parser()
    parser.add_argument("--config-path", type=str, default=None)
    args = parser.parse_args(argv)
    if args.config_path:
        with open(args.config_path) as f:
            text = f.read()
        if "awesome." in text and "__class__" in text:
            # an UNMODIFIED reference YAML: route through the importer
            from awesome_tpu_torch.runner.reference_import import (
                load_reference_config,
            )

            cfg, _ = load_reference_config(args.config_path)
        else:
            cfg = AwesomeConfig.load(args.config_path,
                                     device=translate_device(args.device))
    else:
        cfg = AwesomeConfig()
    cfg.apply_parsed_args(args)
    cfg.prepare()
    return cfg


def _resolve_resume_folder(cfg) -> None:
    """--resume true without an explicit --output-folder: continue the
    NEWEST run of the same experiment (run folders are timestamped, so a
    preempted job restarted with the identical command + --resume picks
    up where it left off; ``AwesomeRunner._try_resume`` restores the full
    train state bit-identically)."""
    if not getattr(cfg, "resume", False) or cfg.output_folder:
        return
    name = cfg.name_experiment or "run"
    # exact match on <timestamp>_<name_experiment>: a plain suffix glob
    # would let experiment 'unet' resume into a newer 'refit_unet' folder
    pat = re.compile(
        r"^\d{4}-\d{2}-\d{2}_\d{2}-\d{2}-\d{2}_" + re.escape(name) + r"$")
    cands = sorted(
        os.path.join(cfg.runs_path, d)
        for d in (os.listdir(cfg.runs_path)
                  if os.path.isdir(cfg.runs_path) else [])
        if pat.match(d)
        and os.path.isdir(os.path.join(cfg.runs_path, d, "checkpoints")))
    if cands:
        cfg.output_folder = cands[-1]
        logging.info("resume: picked up run folder %s", cands[-1])
    else:
        logging.info("resume: no prior run folder for %r, starting fresh",
                     name)


def _is_fbms(cfg) -> bool:
    """FBMS configs = the dataset TYPE (outer, or the nested wrapped
    dataset's class tag) is an FBMS sequence dataset, never a substring
    match on arbitrary arg values (paths may contain 'fbms')."""
    if "fbms" in (cfg.dataset_type or "").lower():
        return True
    inner = (cfg.dataset_args or {}).get("dataset")
    cls = inner.get("__class__", "") if isinstance(inner, dict) else ""
    return "fbms" in str(cls).lower()


def _joint_state_kind(cfg) -> str:
    """The checkpoint kind this config's joint dispatch produces and
    consumes; delegates to the single source of truth beside the dispatch
    itself (``FBMSRunner.joint_state_kind``)."""
    from awesome_tpu_torch.runner.fbms_runner import FBMSRunner

    return FBMSRunner.joint_state_kind(cfg)


def _skip_pretrain_on_resume(cfg) -> bool:
    """A resumable joint checkpoint supersedes the prior pretrain (the
    restored train state carries the priors): don't redo the prefit on
    every preemption restart. Never skips a pretrain_only run (its
    deliverable is the pretrain); only a checkpoint of the kind THIS config
    dispatches to counts."""
    from awesome_tpu_torch.fit.checkpoint import find_resumable

    if not getattr(cfg, "resume", False) or cfg.pretrain_only:
        return False
    if not cfg.output_folder:
        return False
    ck = os.path.join(cfg.output_folder, "checkpoints")
    return bool(find_resumable(ck, _joint_state_kind(cfg)))


def main_fbms(cfg) -> Optional[str]:
    """FBMS experiment families route through ``FBMSRunner``:
    spatio-temporal (one shared (x, y, t) prior, plain or noisy),
    pretrain_only (sequential / weight-decay) and joint (UNET+...+joint,
    refit-unet, multi-object). Returns the run folder of a joint run
    (its checkpoints), else None."""
    from awesome_tpu_torch.runner.fbms_runner import FBMSRunner

    runner = FBMSRunner.from_awesome_config(cfg)
    if not os.path.isdir(runner.config.dataset_path):
        raise SystemExit(
            f"FBMS sequence directory {runner.config.dataset_path!r} not "
            "found: point dataset_args.dataset.dataset_path at a sequence "
            "directory in the FBMS-59 layout")
    runner.build()
    if (cfg.dataset_args or {}).get("spatio_temporal") or (
            cfg.prior_model_args or {}).get("channels") == 3:
        res = runner.pretrain()
        logging.info("Spatio-temporal fit done: %s", res)
        logging.info("Eval: %s", runner.evaluate())
        return None
    if cfg.do_pretraining:
        if _skip_pretrain_on_resume(cfg):
            logging.info("resume: joint checkpoint found, skipping the "
                         "prior pretrain")
        else:
            res = runner.run_pretrain_only_from_config()
            logging.info("Prior pretrain: %s", res)
        if cfg.pretrain_only:
            return None
    res = runner.train_joint_from_config()
    logging.info("Joint training done (%d losses)", len(res["loss"]))
    if runner.joint_state_kind(cfg) == "multi":
        logging.info("Eval: %s", runner.evaluate_multi_object())
    else:
        logging.info("Eval: %s", runner.evaluate_joint())
    out = cfg.output_folder or os.path.join(cfg.runs_path, cfg.run_name)
    logging.info("Results in %s", out)
    return out


def mesh_world(cfg) -> int:
    """The number of ranks ``cfg.mesh_shape`` asks for: ``-1`` absorbs
    the card count (one on the CPU)."""
    import torch

    from awesome_tpu_torch.parallel.mesh import _resolve_shape

    cards = torch.cuda.device_count() if str(cfg.device).startswith(
        "cuda") else 1
    d, g = _resolve_shape(cfg.mesh_shape, max(cards, 1))
    return d * g


def _rank_main(cfg) -> Optional[str]:
    return main(cfg)


def main(cfg) -> Optional[str]:
    """Run the experiment of ``cfg``; returns the run folder. With
    ``mesh_shape`` and no process group yet, starts the mesh's ranks and
    runs it in each of them."""
    from awesome_tpu_torch.parallel.launch import in_process_group, spawn
    from awesome_tpu_torch.runner.runner import AwesomeRunner
    from awesome_tpu_torch.utils.tensorboard import Tensorboard

    _resolve_resume_folder(cfg)
    if cfg.mesh_shape and not in_process_group():
        world = mesh_world(cfg)
        if world > 1:
            logging.info("mesh_shape %s: starting %d ranks", cfg.mesh_shape,
                         world)
            return spawn(_rank_main, world, (cfg,), device=cfg.device)[0]
    if _is_fbms(cfg):
        return main_fbms(cfg)
    runner = AwesomeRunner(cfg)
    runner.build()
    runner.store_config()
    if cfg.do_pretraining:
        logging.info("Pretraining (prior fit) ...")
        runner.pretrain()
        if cfg.pretrain_only:
            out = runner.save_results()
            logging.info("pretrain_only: results in %s", out)
            return out
    logging.info("Training %s (%d images, %d epochs)",
                 cfg.run_name, len(runner.samples), cfg.num_epochs)
    runner.train()
    metrics = runner.evaluate()
    logging.info("Eval: %s", metrics)
    out = runner.save_results()
    if runner.is_root:
        tb = Tensorboard(os.path.join(out, "tb"))
        tb.attach_to_tracker(runner.tracker)
        tb.log_config_markdown(cfg)
        tb.close()
    logging.info("Results in %s", out)
    return out


def device_arg(argv: Optional[List[str]] = None) -> str:
    """The kind of device a run asks for on its command line (``--device``;
    the card by default), read before the config is."""
    import argparse

    from awesome_tpu_torch.runner.config import translate_device

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", type=str, default="cuda")
    return translate_device(p.parse_known_args(argv)[0].device)


def join_torchrun_world(device: str) -> None:
    """Under ``torchrun`` (its ``WORLD_SIZE`` > 1): join its process group
    with this rank on the card ``LOCAL_RANK`` of its host (or on the CPU).
    Called before the config is read, so that every tensor the config
    builds lands on that card."""
    import torch.distributed as dist

    from awesome_tpu_torch.parallel.launch import init_rank

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return
    init_rank(int(os.environ["RANK"]), world, "env://", device,
              local_rank=int(os.environ["LOCAL_RANK"]),
              local_world=int(os.environ["LOCAL_WORLD_SIZE"]))


def share_timestamp(cfg) -> None:
    """In a process group: rank 0's run timestamp on every rank, so that
    they all name the same run folder."""
    from awesome_tpu_torch.parallel.launch import in_process_group

    if in_process_group():
        import torch.distributed as dist

        stamp = [cfg.timestamp]
        dist.broadcast_object_list(stamp, src=0)
        cfg.timestamp = stamp[0]


if __name__ == "__main__":
    config_logging()
    join_torchrun_world(device_arg())
    config = get_config()
    share_timestamp(config)
    main(config)
