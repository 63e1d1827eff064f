"""Visualization CLI of the port (counterpart of scripts/visualize.py):
prediction panels and communication graphs from a checkpoint.

    python -m multiagentperception_tpu_torch.visualize --config <yml> \\
        --model_path <ckpt.pkl> [--out_dir viz] [--split test] [--n_batches 1] \\
        [--inference_mode MODE] [--device cpu]

Loads a reference-format ``.pkl`` into the port's ``Evaluator`` and writes
``visual.save_eval_gallery``'s PNGs. Runs on the card unless ``--device
cpu`` is passed; without a card and without it, the run stops with an
error.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> list[str]:
    """Write the gallery; returns the written paths."""
    parser = argparse.ArgumentParser(description="visualize")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--out_dir", type=str, default="viz")
    parser.add_argument("--split", type=str, default=None,
                        help="data split (default: the config's test_split)")
    parser.add_argument("--n_batches", type=int, default=1)
    parser.add_argument("--inference_mode", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from multiagentperception_tpu_torch.config import load_config
    from multiagentperception_tpu_torch.data import DataLoader, get_loader
    from multiagentperception_tpu_torch.evaluate import Evaluator
    from multiagentperception_tpu_torch.visual import save_eval_gallery

    cfg = load_config(args.config)
    evaluator = Evaluator(cfg, device=args.device)  # raises first if no card
    data_cfg = cfg["data"]
    dataset = get_loader(data_cfg["dataset"])(
        root=data_cfg["path"],
        split=args.split or data_cfg["test_split"],
        img_size=(data_cfg["img_rows"], data_cfg["img_cols"]),
        commun_label=data_cfg["commun_label"],
        target_view=data_cfg["target_view"],
        raw_images=bool(data_cfg.get("on_device_normalize")),
        noisy_type=data_cfg.get("noisy_type"),
    )
    loader = DataLoader(dataset, cfg["training"]["batch_size"],
                        num_workers=cfg["training"]["n_workers"])
    evaluator.load_weight(args.model_path)
    paths = save_eval_gallery(evaluator, loader, args.out_dir, max_batches=args.n_batches,
                              inference_mode=args.inference_mode)
    print(f"wrote {len(paths)} images to {args.out_dir}:")
    for p in paths:
        print(" ", p)
    return paths


if __name__ == "__main__":
    main()
