"""Training CLI of the port (counterpart of the repo's train.py; reference
train.py:34-232).

    python -m multiagentperception_tpu_torch.train --config <yml> \\
        [--device cpu] [--run_time N] [--data_parallel D]

Takes any of the ten reference YAMLs under ``configs/multi-request-multi-support/``
and ``configs/single-request-multiple-support/`` and
``configs/extensions/mrms_when2com_topk.yml`` unchanged (all seven
architectures, every backbone) and trains on the card (``--device cpu`` for the CPU; without a card
and without it, the run stops with an error). Each run writes to
``runs/<config name>/<timestamp>``: the config, ``train.log`` and the
``.pkl`` checkpoints ``<arch>_<dataset>_best_model.pkl``, and the TensorBoard
event files where ``torch.utils.tensorboard`` imports (else one logged line
and no writer, as the JAX CLI without ``tensorboardX``). After training it
loads the best checkpoint and evaluates the test split in the config's
eval mode (``model.eval_inference``, e.g. ``topk``; else ``activated`` for
the when2com models and MIMOcomWho, ``argmax_test`` for LearnWho2Com, none
for the baselines), as the reference does.

The data keys of the JAX CLI (train.py:139-182) run here: ``data.noisy_type``
and ``data.cache_decoded`` on every split, ``training.augmentations`` on the
train split alone, and ``training.data_backend: grain``: the train split
through ``data.grain_pipeline.GrainLoader`` (shuffled, ``drop_last``,
``training.grain_workers`` worker processes, its stream position saved in
each checkpoint) and the validation split through an unshuffled one.

Parallel runs (JAX train.py:30, :48-58, :95-101, :182-201), one rank per
card (``parallel``):

- ``--data_parallel D`` (default 0: the largest count of the cards that
  divides ``batch_size``, with a warning when it leaves cards idle; an
  explicit count must divide the batch) spawns D local ranks, each on its
  rows of every global batch; D > 1 needs D cards (with ``--device cpu``, D
  ranks on the CPU). Their backend, picked once, is printed first.
- ``MAP_COORDINATOR=host:port MAP_NUM_PROCESSES=P MAP_PROCESS_ID=i`` runs
  this process as rank i of P; with ``training.shard_data_by_process`` each
  rank's loader reads its own slice and ``batch_size`` is per rank.
- ``model.agent_parallel: A`` trains on A ranks of one ring (it owns its
  ranks: no data parallel beside it), the ring carrying MIMOcom's eval and
  validation fusion, and with ``model.agent_parallel_train`` its training
  forward too.

The ranks share rank 0's run directory (its timestamp is broadcast);
only rank 0 writes the log, TensorBoard and the checkpoints, and the test
split is evaluated after training on the same ranks.

``training.rss_limit_gb``'s restart (``utils.reexec_self``) comes back
through here: a process started with ``MAP_REEXEC_RESUME`` rejoins the run
directory of ``MAP_REEXEC_LOGDIR`` (run ``MAP_REEXEC_RUN_IDX``) and resumes
from that checkpoint (JAX train.py:80-117).
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import random
import shutil

import numpy as np


def _writer(logdir: str, logger: logging.Logger):
    """A TensorBoard ``SummaryWriter`` on ``logdir``, or None (logged) where
    ``torch.utils.tensorboard`` does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as err:
        logger.info("no TensorBoard writer (%s): metrics go to stdout and the log", err)
        return None
    return SummaryWriter(log_dir=logdir)


def _logger(logdir: str) -> logging.Logger:
    logger = logging.getLogger(f"multiagentperception_tpu_torch.train.{logdir}")
    logger.setLevel(logging.INFO)
    handler = logging.FileHandler(os.path.join(logdir, "train.log"))
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(handler)
    return logger


def main(argv=None):
    """Train ``--run_time`` runs; returns each run's test ``(score, class_iou)``
    (this rank's copy; nothing where the ranks were spawned)."""
    parser = argparse.ArgumentParser(description="config")
    parser.add_argument("--config", nargs="?", type=str,
                        default="configs/your_configs.yml",
                        help="Configuration file to use")
    parser.add_argument("--device", nargs="?", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--run_time", nargs="?", type=int, default=1,
                        help="number of repeated runs")
    parser.add_argument("--data_parallel", nargs="?", type=int, default=0,
                        help="shard the batch over this many ranks, one a card "
                        "(0 = the largest card count dividing the batch)")
    args = parser.parse_args(argv)

    import torch

    from multiagentperception_tpu_torch.config import load_config
    from multiagentperception_tpu_torch.device import resolve_device
    from multiagentperception_tpu_torch.parallel import (
        agent_parallel_ranks,
        data_parallel_ranks,
        from_environment,
        spawn,
    )

    cfg = load_config(args.config)
    device = resolve_device(args.device)  # raises first if no card
    if os.environ.get("MAP_COORDINATOR"):
        world = int(os.environ["MAP_NUM_PROCESSES"])
        agent = agent_parallel_ranks(cfg, available=world)
        if agent not in (1, world):
            raise ValueError(f"model.agent_parallel {agent} on {world} ranks: the agent ring "
                             "owns its ranks in training (no data parallel beside it)")
        if agent == 1 and not cfg["training"].get("shard_data_by_process"):
            data_parallel_ranks(cfg["training"]["batch_size"], world, world)
        return run(args, cfg, from_environment(device.type, agent=agent))
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    agent = agent_parallel_ranks(cfg, available=cards or int(cfg["model"].get(
        "agent_parallel") or 1))
    if agent > 1:
        spawn(_rank_main, agent, (args, cfg), device=device.type, agent=agent)
        return []
    ranks = data_parallel_ranks(cfg["training"]["batch_size"], args.data_parallel,
                                cards or max(1, args.data_parallel))
    if ranks > 1:
        spawn(_rank_main, ranks, (args, cfg), device=device.type)
        return []
    return run(args, cfg, None)


def _rank_main(layout, args, cfg) -> None:
    run(args, cfg, layout)


def _run_stamp(layout) -> datetime.datetime:
    """Now, or rank 0's now on every rank (JAX train.py:95-101)."""
    now = datetime.datetime.now()
    if layout is None:
        return now
    import torch

    from multiagentperception_tpu_torch.parallel.collectives import broadcast

    stamp = torch.tensor([int(now.timestamp())], dtype=torch.int64, device=layout.device)
    return datetime.datetime.fromtimestamp(int(broadcast(stamp, layout.world_group)))


def run(args, cfg, layout):
    """The runs of ``main`` as this process's rank of ``layout`` (None: one
    process)."""
    import torch

    from multiagentperception_tpu_torch.data import (
        DataLoader,
        get_composed_augmentations,
        get_loader,
    )
    from multiagentperception_tpu_torch.data.grain_pipeline import GrainLoader
    from multiagentperception_tpu_torch.device import resolve_device
    from multiagentperception_tpu_torch.loss import get_loss_function
    from multiagentperception_tpu_torch.models import init_weights
    from multiagentperception_tpu_torch.schedulers import get_scheduler
    from multiagentperception_tpu_torch.trainer import Trainer

    device = layout.device if layout is not None else resolve_device(args.device)
    primary = layout is None or layout.primary
    # each data rank decodes its rows of every global batch
    shard = None if layout is None or layout.data == 1 else (layout.data_index, layout.data)
    results = []
    reexec_resume = os.environ.pop("MAP_REEXEC_RESUME", None)
    reexec_logdir = os.environ.get("MAP_REEXEC_LOGDIR")
    reexec_run_idx = int(os.environ.get("MAP_REEXEC_RUN_IDX", "0") or 0)
    if reexec_resume and reexec_run_idx > 0:
        print(f"resumed after re-exec: aggregate will cover runs "
              f"{reexec_run_idx}..{args.run_time - 1} only")
    orig_resume = cfg["training"].get("resume")
    for run_idx in range(reexec_run_idx if reexec_resume else 0, args.run_time):
        run_id = _run_stamp(layout).strftime("%Y-%m-%d-%H-%M-%S")
        if args.run_time > 1:  # fast repeats can share a timestamp second
            run_id = f"{run_id}-r{run_idx}"
        if reexec_resume and run_idx == reexec_run_idx and reexec_logdir:
            logdir = reexec_logdir  # rejoin the run directory of the re-exec'd process
            cfg["training"]["resume"] = reexec_resume
        else:
            logdir = os.path.join("runs", os.path.basename(args.config)[:-4], run_id)
            cfg["training"]["resume"] = orig_resume
        # exported so a later rss_limit_gb re-exec rejoins this run
        os.environ["MAP_REEXEC_LOGDIR"] = logdir
        os.environ["MAP_REEXEC_RUN_IDX"] = str(run_idx)
        os.makedirs(logdir, exist_ok=True)
        writer = None
        if primary:
            print(f"RUNDIR: {logdir}")
            if os.path.abspath(args.config) != os.path.abspath(
                    os.path.join(logdir, os.path.basename(args.config))):
                shutil.copy(args.config, logdir)
            logger = _logger(logdir)
            logger.info("Begin")
            writer = _writer(logdir, logger)
        else:
            logger = logging.getLogger(f"multiagentperception_tpu_torch.train.rank{layout.rank}")

        # a seed per repeat, so --run_time N gives N different runs
        seed = int(cfg["training"].get("seed", 1337)) + run_idx
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)

        data_cfg, t_cfg = cfg["data"], cfg["training"]
        common = dict(root=data_cfg["path"],
                      img_size=(data_cfg["img_rows"], data_cfg["img_cols"]),
                      commun_label=data_cfg["commun_label"],
                      target_view=data_cfg["target_view"],
                      raw_images=bool(data_cfg.get("on_device_normalize")),
                      noisy_type=data_cfg.get("noisy_type"),
                      cache_decoded=data_cfg.get("cache_decoded"), seed=seed)
        loader_cls = get_loader(data_cfg["dataset"])
        batch, workers = t_cfg["batch_size"], t_cfg["n_workers"]
        by_process = bool(t_cfg.get("shard_data_by_process"))
        t_dataset = loader_cls(split=data_cfg["train_split"],
                               augmentations=get_composed_augmentations(
                                   t_cfg.get("augmentations")), **common)
        v_dataset = loader_cls(split=data_cfg["val_split"], **common)
        if t_cfg.get("data_backend") == "grain":
            # the checkpointable stream, decoded in worker processes; with
            # shard_data_by_process each rank reads its own slice
            trainloader = GrainLoader(t_dataset, batch, shuffle=True, drop_last=True,
                                      num_workers=int(t_cfg.get("grain_workers") or 0),
                                      seed=seed, shard_by_process=by_process)
            valloader = GrainLoader(v_dataset, batch)
        else:
            trainloader = DataLoader(t_dataset, batch, shuffle=True, drop_last=True,
                                     num_workers=workers, seed=seed,
                                     shard=None if by_process else shard)
            valloader = DataLoader(v_dataset, batch, num_workers=workers, shard=shard)

        schedule = get_scheduler(t_cfg.get("lr_schedule"), t_cfg["optimizer"]["lr"])
        trainer = Trainer(cfg, logger, get_loss_function(cfg), trainloader, valloader,
                          schedule=schedule, device=device, logdir=logdir, seed=seed,
                          writer=writer, layout=layout)
        init_weights(trainer.model, seed)
        try:
            save_path = trainer.train()
        finally:
            for loader in (trainloader, valloader):
                if isinstance(loader, GrainLoader):
                    loader.shutdown()  # its worker processes

        # post-training test-split evaluation (reference train.py:219-232)
        testloader = DataLoader(loader_cls(split=data_cfg["test_split"], **common), batch,
                                num_workers=workers, shard=shard)
        if save_path is not None:
            trainer.load_weight(save_path)
        results.append(trainer.evaluate(testloader))
        if writer is not None:
            writer.close()

    if args.run_time > 1 and primary:
        print(f"=== Aggregate over {args.run_time} runs (mean ± std) ===")
        for key in results[0][0]:
            vals = np.asarray([score[key] for score, _ in results], np.float64)
            print(f"{key}{vals.mean():.4f} ± {vals.std():.4f}")
        for c in sorted(results[0][1]):
            vals = np.asarray([ci[c] for _, ci in results], np.float64)
            print(f"class {c} IoU: \t{np.nanmean(vals):.4f} ± {np.nanstd(vals):.4f}")
    return results


if __name__ == "__main__":
    main()
