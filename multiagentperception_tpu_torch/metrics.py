"""Evaluation metrics (reference: ptsemseg/metrics.py).

The port's own copy of ``multiagentperception_tpu/metrics.py`` (numpy only);
keep the two in step.

``runningScore`` keeps three confusion matrices — overall, normal-frames
(``pos``) and noisy-frames (``neg``) split by the communication label — plus
the when2com/who2com selection-accuracy counters and the bandwidth meter.
Semantics match the reference line-for-line (see per-method citations); the
expensive per-pixel histogram can be fed either with raw label arrays (numpy
path, reference API) or with device-computed ``(C, C)`` histograms from
``ops.comm.confusion_matrix`` so eval does a single host readback per batch.

Ordering note: the reference stacks multi-output predictions agent-major
(``cat(labels_list, dim=0)``, trainer.py:654) and transposes the mimo noise
flags to match (metrics.py:80-83). This framework stacks batch-major —
``update_div`` takes flags shaped ``(B, N)`` and flattens them batch-major to
align with its own label stacking. The aggregate statistics are identical.
"""

from __future__ import annotations

import numpy as np


def fast_hist(label_true: np.ndarray, label_pred: np.ndarray, n_class: int) -> np.ndarray:
    """(C, C) histogram, rows=true cols=pred (reference: metrics.py:99-106)."""
    mask = (label_true >= 0) & (label_true < n_class)
    return np.bincount(
        n_class * label_true[mask].astype(int) + label_pred[mask],
        minlength=n_class ** 2,
    ).reshape(n_class, n_class)


def _scores_from_hist(hist: np.ndarray, n_classes: int):
    """Overall/mean/freq-weighted acc + mIoU (reference: metrics.py:113-200)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
        mean_iu = np.nanmean(iu)
        freq = hist.sum(axis=1) / hist.sum()
        fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
    cls_iu = dict(zip(range(n_classes), iu))
    return (
        {
            "Overall Acc: \t": acc,
            "Mean Acc : \t": acc_cls,
            "FreqW Acc : \t": fwavacc,
            "Mean IoU : \t": mean_iu,
        },
        cls_iu,
    )


class runningScore:
    """Confusion-matrix scorer + selection/bandwidth accounting."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.reset()

    def reset(self):
        c = self.n_classes
        self.confusion_matrix = np.zeros((c, c))
        self.confusion_matrix_pos = np.zeros((c, c))
        self.confusion_matrix_neg = np.zeros((c, c))
        self.total_agent = 0
        self.correct_when2com = 0
        self.correct_who2com = 0
        self.total_bandW = 0.0
        self.count = 0

    # ---- confusion-matrix updates -------------------------------------
    def update(self, label_trues, label_preds):
        """Numpy path (reference: metrics.py:108-110)."""
        for lt, lp in zip(label_trues, label_preds):
            self.confusion_matrix += fast_hist(
                lt.flatten(), lp.flatten(), self.n_classes
            )

    def update_hist(self, hist, hist_pos=None, hist_neg=None):
        """Device path: add precomputed (C, C) histograms."""
        self.confusion_matrix += np.asarray(hist)
        if hist_pos is not None:
            self.confusion_matrix_pos += np.asarray(hist_pos)
        if hist_neg is not None:
            self.confusion_matrix_neg += np.asarray(hist_neg)

    def update_div(self, if_commun_label, label_trues, label_preds, commun_label):
        """Normal/noise split (reference: metrics.py:70-97).

        when2com: ``commun_label`` is (B,), -1 == normal frame.
        mimo: ``commun_label`` is (B, 2, N); row 0 holds per-agent noise
        flags (0 == normal); the labels/preds here are stacked batch-major
        (B*N) so the flags flatten batch-major too.
        """
        commun_label = np.asarray(commun_label)
        if if_commun_label == "when2com":
            normal = commun_label == -1
        elif if_commun_label == "mimo":
            normal = (commun_label[:, 0, :] == 0).reshape(-1)
        else:
            raise ValueError(if_commun_label)
        label_trues = np.asarray(label_trues)
        label_preds = np.asarray(label_preds)
        for lt, lp in zip(label_trues[normal], label_preds[normal]):
            self.confusion_matrix_pos += fast_hist(lt.flatten(), lp.flatten(), self.n_classes)
        for lt, lp in zip(label_trues[~normal], label_preds[~normal]):
            self.confusion_matrix_neg += fast_hist(lt.flatten(), lp.flatten(), self.n_classes)

    # ---- selection accuracy -------------------------------------------
    def update_selection(self, if_commun_label, commun_label, action_argmax):
        """when2com/who2com selection accuracy (reference: metrics.py:23-68).

        when2com (SRMS): ``commun_label`` (B,) in {-1..N-2}; -1 means "use
        self". After the reference's +1 shift, 0 == self. ``action_argmax``
        is either (B,) hard indices or a (B, N) activated-weight matrix
        (links where weight > 0.2).

        mimo (MRMS): ``commun_label`` (B, 2, N); ``action_argmax`` (B, N)
        chosen key per agent; gt action = link*noise + self*(1-noise).
        """
        commun_label = np.asarray(commun_label)
        action = np.asarray(action_argmax)
        if if_commun_label == "when2com":
            label = commun_label + 1  # -1..3 -> 0..4 (metrics.py:26)
            action = np.squeeze(action)
            self.total_agent += label.shape[0]
            when_label = label == 0
            if action.ndim == 2:
                links = action > 0.2  # (B, N)
                # who: the gt link is among the active links (metrics.py:32-40)
                self.correct_who2com += int(
                    links[np.arange(label.shape[0]), label].sum()
                )
                # when: any active non-self link (metrics.py:41-45)
                when_pred = links[:, 1:].any(axis=1)
                self.correct_when2com += int((when_pred == when_label).sum())
            else:
                when_pred = action == 0
                self.correct_when2com += int((when_pred == when_label).sum())
                self.correct_who2com += int((action == label).sum())
        elif if_commun_label == "mimo":
            b, _, n = commun_label.shape
            self.total_agent += b * n
            noise = commun_label[:, 0, :]
            link = commun_label[:, 1, :]
            ids = np.arange(n)[None, :]
            when_pred = action != ids
            self.correct_when2com += int((when_pred == noise.astype(bool)).sum())
            gt_action = link * noise + ids * (1 - noise)
            self.correct_who2com += int((action == gt_action).sum())
        else:
            raise ValueError(if_commun_label)

    def update_selection_counts(self, total, correct_when, correct_who):
        """Device path: add precomputed counters."""
        self.total_agent += int(total)
        self.correct_when2com += int(correct_when)
        self.correct_who2com += int(correct_who)

    # ---- bandwidth ----------------------------------------------------
    def update_bandW(self, bandW):
        self.total_bandW += float(bandW)
        self.count += 1.0

    def get_avg_bandW(self):
        return self.total_bandW / self.count

    # ---- scores -------------------------------------------------------
    def get_scores(self):
        return _scores_from_hist(self.confusion_matrix, self.n_classes)

    def get_only_normal_scores(self):
        return _scores_from_hist(self.confusion_matrix_pos, self.n_classes)

    def get_only_noise_scores(self):
        return _scores_from_hist(self.confusion_matrix_neg, self.n_classes)

    def get_selection_accuracy(self):
        when = self.correct_when2com / self.total_agent * 100
        who = self.correct_who2com / self.total_agent * 100
        return when, who

    def print_score(self, n_classes, score, class_iou):
        """Console table (reference: metrics.py:214-228)."""
        metric_string = ""
        class_string = ""
        for i in range(n_classes):
            metric_string += "  " + str(i)
            class_string += " " + str(round(class_iou[i] * 100, 2))
        for k, v in score.items():
            metric_string += "  " + str(k)
            class_string += " " + str(round(v * 100, 2))
        print(metric_string)
        print(class_string)


class averageMeter:
    """Running average (reference: metrics.py:231-247)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
