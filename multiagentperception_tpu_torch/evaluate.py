"""Evaluation of a MIMOcom checkpoint (port of the eval part of
multiagentperception_tpu/trainer.py: ``_labels`` :235-246, ``_eval_step_fn``
:457-544, ``_update_selection`` :615-622, ``_pipelined_eval`` :809-824,
``load_weight`` :1182-1221 (the ``.pkl`` branch) and ``evaluate``
:1223-1281). ``trainer.Trainer`` extends it with training.

Per batch the card computes the class map from the decoder's pre-upsample
logits with the upsample+argmax kernel — the full-resolution logits are
never built — and the Normal/Noise/Overall confusion matrices; the host
reads back three (C, C) histograms, the graph's actions and the bandwidth.
With ``with_loss`` (the trainer's validation) the step instead takes the
argmax of the full-resolution logits and also returns the loss.
"""

from __future__ import annotations

import os
from collections import deque

import numpy as np
import torch

from multiagentperception_tpu_torch.device import resolve_device
from multiagentperception_tpu_torch.metrics import runningScore
from multiagentperception_tpu_torch.models import get_model
from multiagentperception_tpu_torch.ops.comm import confusion_matrix
from multiagentperception_tpu_torch.ops.kernels.upsample_argmax import upsample_argmax
from multiagentperception_tpu_torch.ops.normalize import normalize_images

N_CLASSES = 11  # hard-coded in every reference trainer (trainer.py:44, ...)
EVAL_DEFAULT = "activated"  # MIMOcom's eval mode (reference trainer.py:774)
PIPELINE_DEPTH = 2  # batches in flight before the oldest is read back


class Evaluator:
    """Evaluates MIMOcom on ``device`` (default ``cuda``; raises without a
    card unless ``device='cpu'`` is asked for)."""

    def __init__(self, cfg, device: str | torch.device | None = None, loss_fn=None):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.device = resolve_device(device)
        self.n_classes = N_CLASSES
        self.model = get_model(cfg, N_CLASSES).to(self.device).eval()
        self.if_commun_label = cfg["data"].get("commun_label", "None")
        if self.if_commun_label not in ("None", "mimo"):
            raise NotImplementedError(
                f"data.commun_label={self.if_commun_label!r}: MIMOcom evaluates "
                "with 'mimo' labels or none")
        self.eval_default = cfg["model"].get("eval_inference") or EVAL_DEFAULT
        self.normalize_on_device = bool(cfg["data"].get("on_device_normalize"))
        self.last_eval_metrics: runningScore | None = None

    def load_weight(self, model_path: str) -> None:
        """Load a reference-format ``.pkl`` (``{'model_state': state_dict}``,
        the file ``compat.save_reference_checkpoint`` writes), strictly."""
        if not os.path.isfile(model_path):
            raise FileNotFoundError(
                f"{model_path}: the port loads reference-format .pkl files; turn a "
                "JAX checkpoint into one with compat.save_reference_checkpoint")
        blob = torch.load(model_path, map_location="cpu", weights_only=True)
        state = blob.get("model_state", blob) if isinstance(blob, dict) else blob
        self.model.load_state_dict(state, strict=True)

    @staticmethod
    def _labels(labels: np.ndarray) -> np.ndarray:
        """(B, N, H, W) -> (B*N, H, W) uint8, batch-major: class ids 0..10 and
        the ignore index 250 both fit."""
        labels = np.asarray(labels)
        return labels.reshape((-1,) + labels.shape[2:]).astype(np.uint8, copy=False)

    @torch.inference_mode()
    def predict(self, images, inference: str | None = None):
        """(B, N, H, W, 3) images -> ((B*N, H, W) int32 class map, action
        (B, N), num_connect), device tensors. The class map comes from the
        decoder's pre-upsample logits through the upsample+argmax kernel."""
        x = self._images(images)
        pre, _, action, num_connect = self.model(
            x, inference=inference or self.eval_default, full_res=False)
        return upsample_argmax(pre, x.shape[2], x.shape[3]), action, num_connect

    def _images(self, images) -> torch.Tensor:
        """A host batch on the device, normalized there if the loader left it raw."""
        x = torch.as_tensor(np.asarray(images)).to(self.device)
        return normalize_images(x) if self.normalize_on_device else x

    @torch.inference_mode()
    def eval_step(self, images, labels, commun_label=None,
                  inference: str | None = None, with_loss: bool = False) -> dict:
        """One batch on the device; returns device tensors (not read back).
        ``with_loss`` runs ``inference`` (default ``softmax``) at full
        resolution and adds the loss, as the JAX validation step does."""
        y = torch.as_tensor(self._labels(labels)).to(self.device)
        if with_loss:
            logits, _, action, num_connect = self.model(
                self._images(images), inference=inference or "softmax")
            pred = logits.argmax(1)
        else:
            pred, action, num_connect = self.predict(images, inference)
        res = {"hist": confusion_matrix(y, pred, self.n_classes),
               "action": action, "num_connect": num_connect}
        if with_loss:
            res["loss"] = self.loss_fn(input=logits, target=y)
        if commun_label is not None:
            cl = torch.as_tensor(np.asarray(commun_label), device=self.device)
            normal = (cl[:, 0, :] == 0).reshape(-1)  # (B*N,), batch-major
            res["hist_pos"] = confusion_matrix(y, pred, self.n_classes, normal)
            res["hist_neg"] = confusion_matrix(y, pred, self.n_classes, ~normal)
        return res

    def _pipelined(self, loader, **step_kw):
        """Yield ``(eval_step result, commun_label)`` per batch, with up to
        ``PIPELINE_DEPTH`` batches running ahead of the readback."""
        pending: deque = deque()
        for data_list in loader:
            commun_label = data_list[2] if self.if_commun_label != "None" else None
            pending.append((self.eval_step(data_list[0], data_list[1], commun_label,
                                           **step_kw), commun_label))
            if len(pending) > PIPELINE_DEPTH:
                yield pending.popleft()
        while pending:
            yield pending.popleft()

    def _record(self, metrics: runningScore, res: dict, commun_label,
                bandwidth: bool = True) -> dict:
        host = {k: v.cpu().numpy() for k, v in res.items()}
        metrics.update_hist(host["hist"], host.get("hist_pos"), host.get("hist_neg"))
        if bandwidth:
            metrics.update_bandW(float(host["num_connect"]))
        if commun_label is not None:
            metrics.update_selection("mimo", np.asarray(commun_label), host["action"])
        return host

    def _print_scores(self, metrics: runningScore, bandwidth: bool = True) -> None:
        if self.if_commun_label != "None" and metrics.total_agent > 0:
            when_acc, who_acc = metrics.get_selection_accuracy()
            print(f"Validation when2com accuracy:{when_acc}")
            print(f"Validation who2com accuracy:{who_acc}")
        if bandwidth and metrics.count > 0:
            print("Bandwidth: " + str(metrics.get_avg_bandW()))
        sections = []
        if self.if_commun_label != "None":
            sections += [("Normal", metrics.get_only_normal_scores()),
                         ("Noise", metrics.get_only_noise_scores())]
        sections.append(("Overall", metrics.get_scores()))
        for title, (score, class_iou) in sections:
            print(title)
            metrics.print_score(self.n_classes, score, class_iou)

    def evaluate(self, loader, inference_mode: str | None = None):
        """Test-split evaluation with the Normal/Noise/Overall breakdown,
        selection accuracy and bandwidth (reference: trainer.py:774-840)."""
        self.model.eval()
        metrics = runningScore(self.n_classes)
        for res, commun_label in self._pipelined(loader, inference=inference_mode):
            self._record(metrics, res, commun_label)
        self._print_scores(metrics)
        self.last_eval_metrics = metrics
        return metrics.get_scores()
