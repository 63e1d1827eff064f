"""Evaluation CLI of the port (counterpart of the repo's test.py).

    python -m multiagentperception_tpu_torch.test --config <yml> \\
        --model_path <ckpt.pkl> [--inference_mode MODE] [--device cpu]

Takes any of the ten reference YAMLs under ``configs/multi-request-multi-support/``
and ``configs/single-request-multiple-support/`` unchanged (all seven
architectures; the ``topk`` extension is refused by name), loads a
reference-format ``.pkl`` and evaluates the config's test split on the
card (``--device cpu`` to run on the CPU; without a card and without it,
the run stops with an error). Every architecture's class map comes from
the upsample+argmax kernel.
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
                        help="override the architecture's eval mode (activated for "
                        "the when2com models and MIMOcomWho, argmax_test for "
                        "LearnWho2Com)")
    parser.add_argument("--device", nargs="?", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from multiagentperception_tpu_torch.config import load_config
    from multiagentperception_tpu_torch.data import DataLoader, get_loader
    from multiagentperception_tpu_torch.evaluate import Evaluator

    cfg = load_config(args.config)
    evaluator = Evaluator(cfg, device=args.device)  # raises first if no card
    data_cfg = cfg["data"]
    dataset = get_loader(data_cfg["dataset"])(
        root=data_cfg["path"], split=data_cfg["test_split"],
        img_size=(data_cfg["img_rows"], data_cfg["img_cols"]),
        commun_label=data_cfg["commun_label"],
        target_view=data_cfg["target_view"],
        raw_images=bool(data_cfg.get("on_device_normalize")),
        noisy_type=data_cfg.get("noisy_type"),
    )
    loader = DataLoader(dataset, cfg["training"]["batch_size"],
                        num_workers=cfg["training"]["n_workers"])
    evaluator.load_weight(args.model_path)
    evaluator.evaluate(loader, inference_mode=args.inference_mode)
    return evaluator.last_eval_metrics


if __name__ == "__main__":
    main()
