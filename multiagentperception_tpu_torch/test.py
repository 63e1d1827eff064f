"""Evaluation CLI of the port (counterpart of the repo's test.py).

    python -m multiagentperception_tpu_torch.test --config <yml> \\
        --model_path <ckpt.pkl> [--inference_mode MODE] [--device cpu] \\
        [--int8 [--calib_split train] [--calib_batches N]] \\
        [--data_parallel D] [--agent_parallel A]

Takes any of the ten reference YAMLs under ``configs/multi-request-multi-support/``
and ``configs/single-request-multiple-support/`` and
``configs/extensions/mrms_when2com_topk.yml`` unchanged (all seven
architectures, every backbone; the topk YAML evaluates in its
``eval_inference: topk``), loads a
reference-format ``.pkl`` and evaluates the config's test split on the
card (``--device cpu`` to run on the CPU; without a card and without it,
the run stops with an error). Every architecture's class map comes from
the upsample+argmax kernel (from the argmax of the full-resolution logits
with ``n_segnet_decoder``, which has no pre-upsample ones). ``--int8`` evaluates the post-training
quantized path (``quantize.py``; the int8 convolution kernel on the card),
its activation scales calibrated on ``--calib_split`` (default ``train``,
held out from the evaluated split; the evaluated split if that one cannot
be loaded, as the repo's test.py does) over ``--calib_batches`` batches
(default ``training.calib_batches`` or 4). ``data.noisy_type`` degrades the
requester's view and ``data.cache_decoded`` memoizes decoded frames on both
the evaluated and the calibration split (JAX test.py:64-90).

``--data_parallel D`` (JAX's policy: 0 picks the largest card count that
divides ``batch_size``) spawns D local ranks, one a card (``--device cpu``:
D ranks on the CPU), each decoding and evaluating its rows of every batch
(a tail that does not divide runs whole on every rank); the scores rank 0
prints equal one process's. ``--agent_parallel A`` (or
``model.agent_parallel``) runs MIMOcom's fusion as a ring over A ranks;
with both, D data groups of A ranks each run their own ring (JAX
test.py:96-116). The ranks' backend, picked once, is printed first.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Run the evaluation; returns its ``runningScore`` (confusion matrices,
    bandwidth and selection counts) after printing the score tables."""
    parser = argparse.ArgumentParser(description="config")
    parser.add_argument("--config", nargs="?", type=str,
                        default="configs/your_configs.yml")
    parser.add_argument("--model_path", nargs="?", type=str, required=True)
    parser.add_argument("--inference_mode", nargs="?", type=str, default=None,
                        help="override the config's eval mode (model.eval_inference, "
                        "else activated for the when2com models and MIMOcomWho, "
                        "argmax_test for LearnWho2Com; topk for MIMOcom alone)")
    parser.add_argument("--device", nargs="?", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--int8", action="store_true",
                        help="post-training-quantized eval: the towers' and the decoder's "
                        "convolutions in int8")
    parser.add_argument("--calib_split", nargs="?", type=str, default="train",
                        help="dataset split the activation scales calibrate on (with "
                        "--int8; default train, held out from the evaluated split)")
    parser.add_argument("--calib_batches", nargs="?", type=int, default=None,
                        help="calibration batches (default training.calib_batches or 4)")
    parser.add_argument("--data_parallel", nargs="?", type=int, default=0,
                        help="shard eval batches over this many ranks, one a card (0 = the "
                        "largest card count dividing the batch)")
    parser.add_argument("--agent_parallel", nargs="?", type=int, default=0,
                        help="run MIMOcom's value fusion as a ring over this many ranks "
                        "(also model.agent_parallel)")
    args = parser.parse_args(argv)

    import torch

    from multiagentperception_tpu_torch.config import load_config
    from multiagentperception_tpu_torch.device import resolve_device
    from multiagentperception_tpu_torch.parallel import (
        agent_parallel_ranks,
        data_parallel_ranks,
        spawn,
    )

    cfg = load_config(args.config)
    device = resolve_device(args.device)  # raises first if no card
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    asked = int(args.agent_parallel or cfg["model"].get("agent_parallel") or 1)
    agent = agent_parallel_ranks(cfg, args.agent_parallel, args.data_parallel,
                                 cards or asked * max(1, args.data_parallel))
    if agent > 1:  # a pure ring owns its ranks; with --data_parallel, D rings
        world = agent * max(1, args.data_parallel)
    else:
        world = data_parallel_ranks(cfg["training"]["batch_size"], args.data_parallel,
                                    cards or max(1, args.data_parallel))
    if world > 1:
        spawn(_rank_main, world, (args, cfg), device=device.type, agent=agent)
        return None
    return run(args, cfg, None)


def _rank_main(layout, args, cfg) -> None:
    run(args, cfg, layout)


def run(args, cfg, layout):
    """The evaluation as this process's rank of ``layout`` (None: one
    process); returns its ``runningScore``."""
    from multiagentperception_tpu_torch.data import DataLoader, get_loader
    from multiagentperception_tpu_torch.evaluate import Evaluator

    evaluator = Evaluator(cfg, device=args.device, layout=layout)
    shard = None if layout is None or layout.data == 1 else (layout.data_index, layout.data)
    data_cfg = cfg["data"]
    loader_cls = get_loader(data_cfg["dataset"])
    common = dict(
        root=data_cfg["path"],
        img_size=(data_cfg["img_rows"], data_cfg["img_cols"]),
        commun_label=data_cfg["commun_label"],
        target_view=data_cfg["target_view"],
        raw_images=bool(data_cfg.get("on_device_normalize")),
        noisy_type=data_cfg.get("noisy_type"),
        cache_decoded=data_cfg.get("cache_decoded"),
    )
    dataset = loader_cls(split=data_cfg["test_split"], **common)
    loader = DataLoader(dataset, cfg["training"]["batch_size"],
                        num_workers=cfg["training"]["n_workers"], shard=shard)
    # int8 calibration frames come from a split held out from the evaluated one
    calib_loader = None
    if args.int8:
        if args.calib_batches:
            cfg["training"]["calib_batches"] = args.calib_batches
        try:
            calib_loader = DataLoader(loader_cls(split=args.calib_split, **common),
                                      cfg["training"]["batch_size"], num_workers=0)
        except (OSError, RuntimeError, KeyError, ValueError) as e:  # no such split on disk
            if evaluator.primary:
                print(f"calibration split '{args.calib_split}' unavailable ({e!r}); "
                      "calibrating on the evaluated split")
    evaluator.load_weight(args.model_path)
    evaluator.evaluate(loader, inference_mode=args.inference_mode, int8=args.int8,
                       calib_loader=calib_loader)
    return evaluator.last_eval_metrics


if __name__ == "__main__":
    main()
