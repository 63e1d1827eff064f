"""Training of any of the seven architectures (port of multiagentperception_tpu/trainer.py:
``_train_step_body`` :397-455, ``train``/``_train_loop`` :829-1022,
``_validate``/``_log_val_scores`` :1024-1065 and the checkpoints
:1067-1180).

``Trainer`` extends ``evaluate.Evaluator``: one object trains, validates,
saves and loads checkpoints and evaluates, as the JAX ``Trainer`` does.
One train step is the forward in training mode (the comm models' soft
fusion, the selection baselines' partners drawn on the host; BatchNorm on
batch statistics, updating its running ones), the loss on the prediction
(``out[0]`` of a tuple), the backward and the optimizer update with the lr
``schedule(step)``. Validation runs the ``softmax`` forward in eval mode
with the loss, at full resolution.

Mixed precision (``training.mixed_precision`` or ``model.dtype:
bfloat16``, ``models.compute_dtype``) is the JAX trainer's: the model
computes in bf16, the loss in float32 (``loss.py``), and the optimizer
steps the float32 parameters with their float32 gradients, without loss
scaling (JAX has none). Checkpoints hold float32 tensors either way.

Checkpoints are reference-layout ``.pkl`` files
(``{"epoch", "model_state", "optimizer_state", "best_iou"}``, the layout of
the reference trainer and of ``compat.save_reference_checkpoint``), named
``<arch>_<dataset>_<best_model|latest>.pkl`` in ``logdir``; the JAX package
and the port's ``Evaluator`` both load them. ``training.resume`` reads one
back: model, optimizer, iteration and best mIoU.

Keys of the JAX loop that this port does not carry yet raise
``NotImplementedError`` naming the key (``UNPORTED``); the stall watchdog
and the TensorBoard writer are left out with one logged line each.
"""

from __future__ import annotations

import logging
import os
import time

import torch

from multiagentperception_tpu_torch.evaluate import Evaluator
from multiagentperception_tpu_torch.metrics import averageMeter, runningScore
from multiagentperception_tpu_torch.ops.normalize import normalize_images
from multiagentperception_tpu_torch.optimizers import get_optimizer, set_lr
from multiagentperception_tpu_torch.schedulers import constant_lr


def _off(v) -> bool:
    return not v


# (section, key, whether the port runs the value): anything else is refused
UNPORTED = (
    ("training", "steps_per_call", lambda v: v in (None, 1)),
    ("training", "rss_limit_gb", _off),
    ("training", "nan_guard", _off),
    ("training", "data_backend", lambda v: v != "grain"),
    ("training", "augmentations", _off),
    ("training", "profile_dir", _off),
    ("training", "shard_data_by_process", _off),
    ("training", "device_prefetch", lambda v: v is None),
    ("data", "cache_decoded", _off),
)


def refuse_unported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config key the JAX training loop
    honours and this port does not (ROADMAP.md lists them), or for a
    multi-process launch."""
    for section, key, ported in UNPORTED:
        value = cfg.get(section, {}).get(key)
        if not ported(value):
            raise NotImplementedError(f"{section}.{key}={value!r} is not ported to "
                                      "the PyTorch trainer yet (ROADMAP.md)")
    if os.environ.get("MAP_COORDINATOR"):
        raise NotImplementedError("multi-process training (MAP_COORDINATOR) is not "
                                  "ported to the PyTorch trainer yet (ROADMAP.md)")


class Trainer(Evaluator):
    """Trains, validates and checkpoints the model of ``cfg`` on ``device``
    (default the card). The model starts as ``models.get_model`` builds it;
    initialize or load its weights before ``train``. ``schedule`` maps an
    update's index to its lr (default: the config's constant lr); ``seed``
    (default ``training.seed``) seeds the selection baselines' draws."""

    def __init__(self, cfg, logger: logging.Logger | None, loss_fn, trainloader, valloader,
                 schedule=None, device: str | torch.device | None = None,
                 logdir: str | None = None, seed: int | None = None):
        refuse_unported(cfg)
        super().__init__(cfg, device, loss_fn=loss_fn, seed=seed)
        self.logger = logger or logging.getLogger("multiagentperception_tpu_torch")
        self.trainloader = trainloader
        self.valloader = valloader
        opt_cfg = cfg["training"].get("optimizer")
        self.schedule = schedule or constant_lr(opt_cfg["lr"] if opt_cfg else 0.01)
        self.optimizer = get_optimizer(cfg, self.model.parameters(), self.schedule(0))
        self.logdir = logdir or os.path.join("runs", "default")
        self.freeze_bn = bool(cfg["training"].get("freeze_bn_stats"))
        self.step = 0  # updates done; the lr of the next one is schedule(step)
        self.iter_seconds: list[float] = []  # wall time of each train iteration
        self.running_metrics_val = runningScore(self.n_classes)

    # ------------------------------------------------------------------
    def train_mode(self) -> None:
        """Training mode; with ``freeze_bn_stats`` the BatchNorm modules stay
        in eval mode (running statistics, no update), the rest trains."""
        self.model.train()
        if self.freeze_bn:
            for mod in self.model.modules():
                if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                    mod.eval()

    def _batch(self, images, labels) -> tuple[torch.Tensor, torch.Tensor]:
        """Host batch -> the model's device input (as the loader gives it: raw
        uint8 frames are normalized in ``train_step``) and the uint8 target
        (``_model_inputs``, ``_labels``), copied by ``_put``."""
        return self._put(self._model_inputs(images)), self._put(self._labels(labels))

    def train_step(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """One update on a device batch; returns the loss (not read back).
        The gradients stay in ``.grad`` until the next step. The selection
        baselines draw one set of partners per step."""
        self.train_mode()
        x = normalize_images(images) if self.normalize_on_device else images
        set_lr(self.optimizer, self.schedule(self.step))
        self.optimizer.zero_grad(set_to_none=True)
        out = self.model(x, **self._forward_kwargs("softmax", "train"))
        pred = out[0] if isinstance(out, tuple) else out
        loss = self.loss_fn(input=pred, target=labels)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return loss.detach()

    def _train_batches(self):
        """Endless train-batch stream, one loader epoch after another."""
        while True:
            yield from self.trainloader

    # ------------------------------------------------------------------
    def train(self) -> str | None:
        """The training loop; returns the best checkpoint's path (None if no
        validation ran)."""
        cfg_t = self.cfg["training"]
        self.logger.info("stall watchdog (training.watchdog_secs) not ported; not running")
        self.logger.info("TensorBoard writer not ported; metrics go to stdout and the log")
        best_iou = -100.0
        resume = cfg_t.get("resume")
        if resume is not None and os.path.isfile(str(resume)):
            best_iou = self._restore_full(str(resume))
            self.logger.info("Loaded checkpoint '%s' (iter %d)", resume, self.step)
        elif resume is not None:
            self.logger.info("No checkpoint found at '%s'", resume)

        total, print_interval = int(cfg_t["train_iters"]), int(cfg_t["print_interval"])
        val_interval, save_interval = int(cfg_t["val_interval"]), cfg_t.get("save_interval")
        time_meter, save_path, i = averageMeter(), None, self.step
        if i >= total:
            return None
        for data_list in self._train_batches():
            x, y = self._batch(data_list[0], data_list[1])
            start = time.time()
            loss = self.train_step(x, y)
            # on print iterations the readback waits for the step, so the
            # timed window holds the device's work, not only its launch
            loss_val = float(loss) if (i + 2) % print_interval == 0 else None
            per_iter = time.time() - start
            self.iter_seconds.append(per_iter)
            i += 1
            time_meter.update(per_iter)
            if loss_val is not None:
                line = (f"Iter [{i + 1:d}/{total:d}]  Loss: {loss_val:.4f}  "
                        f"Time/Image: {time_meter.avg / cfg_t['batch_size']:.4f}")
                print(line)
                self.logger.info(line)
                time_meter.reset()

            if i % val_interval == 0 or i == total:
                self._validate()
                score, _ = self.running_metrics_val.get_scores()
                miou = score["Mean IoU : \t"]
                self._log_val_scores(i)
                self.running_metrics_val.reset()
                if miou >= best_iou:
                    best_iou = miou
                    save_path = self._save_ckpt("best_model", i, best_iou)
            if save_interval and i % int(save_interval) == 0:
                self._save_ckpt("latest", i, best_iou)
            if i >= total:
                break
        return save_path

    def _validate(self) -> None:
        """Softmax-mode validation with the loss (trainer.py:1024-1035)."""
        self.model.eval()
        meter = averageMeter()
        for res, commun_label in self._pipelined(self.valloader, with_loss=True):
            host = self._record(self.running_metrics_val, res, commun_label, bandwidth=False)
            meter.update(float(host["loss"]))
        self._val_loss_avg = meter.avg

    def _log_val_scores(self, i: int) -> None:
        self.logger.info("Iter %d Loss: %.4f", i, self._val_loss_avg)
        self._print_scores(self.running_metrics_val, bandwidth=False)

    # ------------------------------------------------------------------
    def _save_ckpt(self, name: str, i: int, best_iou: float) -> str:
        """Write the reference-layout ``.pkl``; a crash mid-write leaves the
        previous file whole (write aside, then rename)."""
        path = os.path.join(self.logdir, f"{self.cfg['model']['arch']}_"
                                         f"{self.cfg['data']['dataset']}_{name}.pkl")
        os.makedirs(self.logdir, exist_ok=True)
        blob = {"epoch": i, "model_state": self.model.state_dict(),
                "optimizer_state": self.optimizer.state_dict(), "best_iou": float(best_iou)}
        torch.save(blob, path + ".tmp")
        os.replace(path + ".tmp", path)
        return path

    def _restore_full(self, path: str) -> float:
        """Model, optimizer and iteration from a ``.pkl``; returns its best mIoU."""
        blob = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(blob["model_state"], strict=True)
        self.optimizer.load_state_dict(blob["optimizer_state"])
        self.step = int(blob["epoch"])
        return float(blob["best_iou"])
