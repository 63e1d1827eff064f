"""Export CLI of the port (counterpart of scripts/export_serving.py):
serialize a checkpoint's eval step for serving.

    python -m multiagentperception_tpu_torch.export_serving --config <yml> \\
        [--model_path <ckpt.pkl>] --out model.pt2 [--batch 8] \\
        [--inference MODE] [--int8 [--calib_data <root>] [--calib_batches 4]] \\
        [--torch_out <weights.pkl>] [--device cpu]

Writes a ``torch.export`` artifact (``export.export_serving``) that
``python -m multiagentperception_tpu_torch.serve`` runs without the model
code, and beside it ``<out>.meta.json``, what the artifact itself does not
record: the config and the mode it was built from (``--inference``,
default the config's eval mode: ``model.eval_inference``, e.g. ``topk``,
else ``activated``). ``--model_path`` is a
reference-format ``.pkl``, loaded as ``Evaluator.load_weight`` loads it;
without it the weights are ``models.init_weights``' seed 0.
``--torch_out`` also writes the weights as a reference-format ``.pkl``.
``--int8`` exports the post-training-quantized graph (``quantize.py``, K4
on the card) with its int8 weights baked, its static activation scales
calibrated on ``--calib_data`` (default the config's ``data.path``) train
frames, or dynamic ones where there are none. The export runs on the card
unless ``--device cpu`` is passed (an artifact runs where it was exported
unless the server moves it); without a card and without it, it stops with
an error.
"""

from __future__ import annotations

import argparse
import hashlib
import json


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="serving export")
    p.add_argument("--config", required=True)
    p.add_argument("--model_path", default=None,
                   help="reference-format .pkl; omit to export seeded weights")
    p.add_argument("--out", default=None, help="artifact path (torch.export)")
    p.add_argument("--torch_out", default=None,
                   help="also write the weights as a reference-format .pkl")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--inference", default=None,
                   help="eval mode (default model.eval_inference, else activated)")
    p.add_argument("--int8", action="store_true", help="post-training int8 quantized export")
    p.add_argument("--calib_data", default=None,
                   help="dataset root for static activation calibration (with --int8); "
                        "defaults to cfg data.path")
    p.add_argument("--calib_batches", type=int, default=4)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if not (args.out or args.torch_out):
        p.error("need --out and/or --torch_out")

    import torch

    from multiagentperception_tpu_torch.config import load_config
    from multiagentperception_tpu_torch.evaluate import Evaluator
    from multiagentperception_tpu_torch.export import export_serving
    from multiagentperception_tpu_torch.models import init_weights

    cfg = load_config(args.config)
    evaluator = Evaluator(cfg, device=args.device)  # raises first if no card
    args.inference = args.inference or cfg["model"].get("eval_inference") or "activated"
    if args.model_path:
        evaluator.load_weight(args.model_path)
    else:
        init_weights(evaluator.model, 0)
    model = evaluator.model.eval()
    n, img = cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    shape = (args.batch, n, img, cfg["data"]["img_cols"], 3)

    act_scales = None
    if args.int8:
        from multiagentperception_tpu_torch.quantize import calibrate_activations

        batches = _calibration_batches(cfg, args.calib_data or cfg["data"].get("path"),
                                       args.batch, args.calib_batches)
        if batches:
            act_scales = calibrate_activations(
                model, [torch.from_numpy(b).to(evaluator.device) for b in batches],
                inference=args.inference, full_res=False)
            print(f"calibrated {len(act_scales)} convs from {len(batches)} batches")
        else:
            print("no calibration data found; int8 export uses dynamic activation scales")

    if args.out:
        artifact = export_serving(model, shape, inference=args.inference, int8=args.int8,
                                  act_scales=act_scales)
        with open(args.out, "wb") as f:
            f.write(artifact)
        with open(args.config, "rb") as f:
            cfg_sha = hashlib.sha256(f.read()).hexdigest()
        with open(args.out + ".meta.json", "w") as f:
            json.dump({
                "input_shape": list(shape), "input_dtype": "float32",
                "inference": args.inference, "mo_flag": bool(cfg["model"].get("multiple_output")),
                "int8": bool(args.int8), "config": args.config,
                "config_sha256": cfg_sha, "model_path": args.model_path,
                "arch": cfg["model"]["arch"],
            }, f, indent=1)
        print(f"wrote {args.out} ({len(artifact) / 1e6:.1f} MB, input {shape}, "
              f"inference={args.inference}, {evaluator.device}) + .meta.json")
    if args.torch_out:
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        torch.save({"epoch": 0, "model_state": state, "best_iou": 0.0}, args.torch_out)
        print(f"wrote {args.torch_out} (reference torch format)")


def _calibration_batches(cfg, root, batch, n_batches):
    """A few real image batches from the train split for scale calibration;
    [] if the dataset is unavailable."""
    import numpy as np

    try:
        from multiagentperception_tpu_torch.data import AirsimDataset

        ds = AirsimDataset(
            root=root, split=cfg["data"].get("train_split", "train"),
            img_size=(cfg["data"]["img_rows"], cfg["data"]["img_cols"]),
            target_view=cfg["data"].get("target_view", "target"),
        )
    except (OSError, RuntimeError, KeyError, ValueError, TypeError) as e:
        print(f"calibration loader unavailable ({e!r})")
        return []
    batches = []
    idx = 0
    for _ in range(n_batches):
        ims = []
        for _ in range(batch):
            if idx >= len(ds):
                idx = 0
            ims.append(np.asarray(ds[idx][0]))
            idx += 1
        batches.append(np.stack(ims))
        if len(ds) <= batch:
            break  # tiny fixture: one pass is all the data there is
    return batches


if __name__ == "__main__":
    main()
