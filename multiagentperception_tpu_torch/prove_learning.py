"""The learning proof: the flagship learns to communicate.

    python -m multiagentperception_tpu_torch.prove_learning [--iters 400] [--batch 4]
        [--lr 1e-4] [--root DIR] [--frames 32] [--tradeoff] [--device cpu]

The counterpart of the repo's scripts/prove_learning.py. MIMOcom at the
flagship's widths trains on the informative fixture
(``data.synthetic.generate_informative_fixture``, 6 agents, 2 of them
noisy): a noisy agent's own view is occluded while its labels stay whole,
and a normal partner sees the same content, so a high mIoU on the noisy
agents is reached only by routing the partner's features through the
attention graph, and the graph's argmax must match the link labels.

``main`` writes the fixture (under a temporary directory unless ``root``
exists), trains through ``Trainer.train`` (``AirsimDataset`` and
``DataLoader``: shuffled, ``drop_last``, 2 workers, seed 0; Adam at
``lr``; seeded ``models.init_weights``), evaluates the train split in
``activated`` mode and prints the JAX script's four lines (mIoU, mimo
selection accuracy against the always-self baseline, who2com accuracy,
bandwidth), then the mIoU of the int8 path (``int8_miou``: K4
``int8_conv`` on every eligible conv, scales calibrated on the first batch
alone, as the JAX script calibrates). With ``tradeoff`` it also prints the
bandwidth-vs-mIoU table on the trained weights (``tradeoff_curve``). It
returns ``(miou, when_acc, who_acc, miou_int8)``. Each evaluation runs
through ``Evaluator`` (on the card the eval step's CUDA graph: K1
``upsample_argmax`` every batch, K2 ``comm_fusion`` in ``activated`` and
``argmax_test``). Entry points run on the card unless ``--device cpu``;
without a card that raises. The checkpoints the trainer writes go to a
temporary directory that is removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import logging
import os
import shutil
import tempfile

from multiagentperception_tpu_torch.config import normalize_config
from multiagentperception_tpu_torch.data import AirsimDataset, DataLoader
from multiagentperception_tpu_torch.data.synthetic import generate_informative_fixture
from multiagentperception_tpu_torch.device import resolve_device
from multiagentperception_tpu_torch.evaluate import Evaluator
from multiagentperception_tpu_torch.loss import get_loss_function
from multiagentperception_tpu_torch.models import init_weights
from multiagentperception_tpu_torch.trainer import Trainer

N_NOISY = 2
MIOU = "Mean IoU : \t"
TRADEOFF_MODES = ("argmax_test", "activated", "softmax")


def config(iters: int, batch: int, img: int, lr: float, root: str,
           val_interval: int | None = None) -> dict:
    """The JAX script's flagship-shaped config (scripts/prove_learning.py:53-67)."""
    return normalize_config({
        "model": {"arch": "MIMOcom", "agent_num": 6,
                  "shared_img_encoder": "unified", "attention": "general",
                  "sparse": False, "query": True, "query_size": 32,
                  "key_size": 1024, "enc_backbone": "resnet_encoder",
                  "dec_backbone": "simple_decoder", "feat_squeezer": -1,
                  "feat_channel": 512, "multiple_output": True},
        "data": {"dataset": "airsim", "img_rows": img, "img_cols": img,
                 "path": root, "target_view": "6agent",
                 "commun_label": "mimo"},
        "training": {"train_iters": iters, "batch_size": batch,
                     "val_interval": val_interval or iters, "n_workers": 2,
                     "print_interval": max(iters // 8, 1),
                     "optimizer": {"name": "adam", "lr": lr},
                     "loss": {"name": "cross_entropy", "size_average": True}},
    })


def _quiet_evaluate(ev: Evaluator, loader, mode: str, **kw) -> tuple[float, float]:
    """(mIoU, bandwidth) of ``ev.evaluate`` in ``mode``, its tables unprinted."""
    with contextlib.redirect_stdout(io.StringIO()):
        score, _ = ev.evaluate(loader, inference_mode=mode, **kw)
    metrics = ev.last_eval_metrics
    return score[MIOU], metrics.get_avg_bandW() if metrics.count else float("nan")


def int8_miou(trainer: Evaluator, evalloader) -> float:
    """mIoU of the post-training-quantized path (``quantize.py``) on the
    trained weights, in ``activated`` mode, its activation scales
    calibrated on the loader's first batch alone (scripts/prove_learning.py:154-188)."""
    first = next(iter(evalloader))
    miou, _ = _quiet_evaluate(trainer, evalloader, "activated", int8=True,
                              calib_loader=[first])
    return miou


def tradeoff_curve(trainer: Evaluator, cfg: dict, evalloader) -> list[tuple]:
    """Bandwidth against mIoU on the trained weights (scripts/prove_learning.py:101-151):
    the top-k pruned graph for k = 1..N, then hard argmax (``argmax_test``),
    the thresholded graph (``activated``) and the full softmax fusion.
    ``topk_k`` is a model attribute, so each k is a model of its own,
    loaded with the same weights; every point is an ``Evaluator`` pass
    over ``evalloader``. Prints the table and returns its rows
    ``(mode, links/agent, mIoU)``."""
    state = trainer.model.state_dict()
    n = int(cfg["model"]["agent_num"])

    def run(model_cfg: dict, mode: str) -> tuple[float, float]:
        ev = Evaluator({**cfg, "model": model_cfg}, trainer.device)
        ev.model.load_state_dict(state, strict=True)
        return _quiet_evaluate(ev, evalloader, mode)

    rows = []
    for k in range(1, n + 1):
        miou, bw = run({**cfg["model"], "topk_k": k}, "topk")
        rows.append((f"topk k={k}", bw, miou))
    for mode in TRADEOFF_MODES:
        miou, bw = run(cfg["model"], mode)
        rows.append((mode, bw, miou))
    print("\nbandwidth-vs-mIoU tradeoff (trained fixture weights):")
    print(f"{'mode':>14s}  {'links/agent':>11s}  {'mIoU':>7s}")
    for mode, bw, miou in rows:
        print(f"{mode:>14s}  {bw:11.3f}  {miou:7.4f}")
    return rows


def main(iters: int = 400, batch: int = 4, img: int = 128, lr: float = 1e-4, device=None,
         root: str | None = None, val_interval: int | None = None, frames: int = 32,
         tradeoff: bool = False) -> tuple[float, float, float, float]:
    device = resolve_device(device)
    scratch = tempfile.mkdtemp(prefix="learnfx_")
    try:
        root = root or os.path.join(scratch, "data")
        if not os.path.isdir(root):
            generate_informative_fixture(root, target_view="6agent", img_size=img,
                                         frames_per_traj=frames, n_noisy=N_NOISY)
        cfg = config(iters, batch, img, lr, root, val_interval)
        ds = AirsimDataset(root, split="train", target_view="6agent",
                           img_size=(img, img), commun_label="mimo")
        trainloader = DataLoader(ds, batch, shuffle=True, drop_last=True,
                                 num_workers=2, seed=0)
        evalloader = DataLoader(ds, batch, shuffle=False, num_workers=2)
        trainer = Trainer(cfg, logging.getLogger("learn"), get_loss_function(cfg),
                          trainloader, evalloader, device=device,
                          logdir=os.path.join(scratch, "runs"))
        init_weights(trainer.model, int(cfg["training"]["seed"]))
        trainer.train()

        score, _ = trainer.evaluate(evalloader, inference_mode="activated")
        rm = trainer.last_eval_metrics
        miou = score[MIOU]
        when_acc, who_acc = rm.get_selection_accuracy()
        bandwidth = rm.get_avg_bandW() if rm.count else float("nan")
        n = int(cfg["model"]["agent_num"])
        chance = 100.0 * (n - N_NOISY) / n
        print(f"train-set mIoU (activated): {miou:.4f}")
        print(f"mimo when2com selection accuracy: {when_acc:.2f}% "
              f"(always-self baseline {chance:.1f}%)")
        print(f"who2com (noisy-agent link) accuracy: {who_acc:.2f}%")
        print(f"avg bandwidth (links/agent): {bandwidth:.3f}")

        miou_int8 = int8_miou(trainer, evalloader)
        print(f"train-set mIoU, int8-quantized serving path: {miou_int8:.4f} "
              f"(delta {miou_int8 - miou:+.4f})")
        if tradeoff:
            tradeoff_curve(trainer, cfg, evalloader)
        return miou, when_acc, who_acc, miou_int8
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--device", default=None, help="default: the card; cpu for the CPU")
    p.add_argument("--root", default=None)
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--tradeoff", action="store_true",
                   help="after the proof, sweep the bandwidth-vs-mIoU curve")
    a = p.parse_args()
    main(iters=a.iters, batch=a.batch, lr=a.lr, device=a.device, root=a.root,
         frames=a.frames, tradeoff=a.tradeoff)
