"""Evaluation of any of the seven architectures (port of the eval part of
multiagentperception_tpu/trainer.py: the arch families and eval defaults
:61-87, ``_model_inputs`` / ``_labels`` / ``_apply_kwargs`` :226-256, the
selection draw :208-211 and :493-498, ``_eval_step_fn`` :457-544,
``_update_selection`` :615-622, ``_pipelined_eval`` :809-824,
``load_weight`` :1182-1221 (the ``.pkl`` branch) and ``evaluate``
:1223-1281). ``trainer.Trainer`` extends it with training.

Per batch the card computes the class map from the decoder's pre-upsample
logits with the upsample+argmax kernel — the full-resolution logits are
never built — for every architecture (a decoder with no pre-upsample
logits, ``n_segnet_decoder``, gives full-resolution ones, whose argmax is
taken instead, as JAX does), and the Normal/Noise/Overall
confusion matrices; the host reads back three (C, C) histograms, the
actions and the bandwidth where the forward returns them. The frames and
labels reach the card from pinned memory without blocking the host
(``_put``, which the trainer shares). With
``with_loss`` (the trainer's validation) the step instead takes the argmax
of the full-resolution logits and also returns the loss.

The ``selection`` baselines (All_agents / MIMO_All_agents with
``shuffle_features: selection``) draw their partners on the host, from a
CPU ``torch.Generator`` seeded from the run's seed: one draw per eval batch
(the stream restarts with each evaluation, as the JAX package folds the
batch index into one key) and one per train step. A card run and a CPU
run with one seed pick the same partners.

A mixed-precision model (``model.dtype: bfloat16`` or
``training.mixed_precision``, or ``model.dtype: float16``) takes the same
float32 frames (its first convolution casts them) and hands the kernel
pre-upsample logits in its type, which it upcasts, as the JAX evaluation
hands its Pallas kernel.

On the card, ``evaluate`` and the trainer's validation run each batch as
a CUDA graph (``graphs.GraphCache``), the counterpart of JAX's one jitted
dispatch a step: keyed by the inference mode, ``with_loss``, the active
int8 swap, the model's dtype, the inputs' shapes and the precision
settings (TF32, cuBLAS's reduced-precision float16 and bf16 reductions),
the first batch of a key runs eagerly, the second is captured, the rest
replay; the frames, labels, ``commun_label`` and the draws are copied into
the graph's static buffers, and its outputs copied out, at each replay. A
batch of another size than the loader's first (a ragged tail) runs
eagerly. ``Evaluator(..., graphs=False)`` keeps the eager step for every
batch; the CPU is always eager.

``evaluate(..., int8=True)`` runs the post-training-quantized path
(``quantize.py``, JAX trainer.py:457-471, :546-610): activation scales
are calibrated first (``_calibrate_int8``), then every eligible
convolution of the towers and the decoder runs as an int8 convolution
(K4 on the card) under ``int8_convs``, an ``quantize.Int8Convs`` kept on
the evaluator; its weights are quantized once and dropped by
``load_weight``. The step still ends in K2 and K1.

With a ``parallel.Layout`` (``layout=``; data parallel, the agent ring or
both, or a data x model grid) each rank evaluates its block of every
batch, and the scores equal the single-process scores:

- Rows: over D data ranks each rank takes its rows of a global batch (a
  ``data.pipeline.ShardBatch`` from a sharded loader holds them already);
  a batch that does not divide over D (a tail) runs whole on every rank,
  as JAX replicates it.
- Agents: MIMOcom's ring (``model.agent_parallel``) predicts the rank's
  agents; the labels and the normal/noise flags follow.
- Channels: on the model axis (``Layout(model=M)``) the ranks of a model
  group evaluate the same rows, each layer computing its shard of the
  output channels and gathering them (``parallel.tensor``), so K1 and K2
  run on every rank on whole tensors; their sums are the data group's
  alone. ``load_weight`` takes a one-process ``.pkl`` and keeps the
  rank's shards.
- int8: the activation scales are max-reduced over the world
  (``calibrate_activations``' ``group``): a ring rank's towers see its
  agents alone, and the maxes over the ring are JAX's global ones; a
  model group's ranks see the same inputs. On the ring ``Int8Convs``
  swaps each rank's towers and decoder; on the model axis it quantizes a
  shard's weight per output channel (a slice of the whole weight's
  scales), runs K4 on it and gathers.
- Per batch the confusion matrices (int64) and a validation loss are summed
  over the ranks whose blocks split the batch (the loss is each rank's
  share of the global mean, ``loss.py``'s ``group``); over the data ranks
  the actions and ``commun_label`` are gathered and the bandwidth is taken
  from every rank's ``num_connect`` and batch share exactly
  (``_bandwidth``), so every rank records the same numbers, and only rank 0
  prints them. K1 (and K2 where the mode runs it) launch on every rank's
  path; the ring does not run K2.
- CUDA graphs hold the collectives under NCCL; under gloo (ranks sharing a
  card) every step is eager: no graph holds a gloo collective.
"""

from __future__ import annotations

import contextlib
import logging
import os
from collections import deque

import numpy as np
import torch

from multiagentperception_tpu_torch.data.pipeline import ShardBatch
from multiagentperception_tpu_torch.device import resolve_device
from multiagentperception_tpu_torch.graphs import GraphCache
from multiagentperception_tpu_torch.metrics import runningScore
from multiagentperception_tpu_torch.models import compute_dtype, get_model
from multiagentperception_tpu_torch.ops.comm import confusion_matrix
from multiagentperception_tpu_torch.ops.kernels.upsample_argmax import class_map
from multiagentperception_tpu_torch.ops.normalize import normalize_images
from multiagentperception_tpu_torch.parallel import tensor
from multiagentperception_tpu_torch.parallel.collectives import all_gather_cat, all_reduce_sum
from multiagentperception_tpu_torch.quantize import Int8Convs, active_swap, calibrate_activations

N_CLASSES = 11  # hard-coded in every reference trainer (trainer.py:44, ...)
PIPELINE_DEPTH = 2  # batches in flight before the oldest is read back
# arch families (JAX trainer.py:61-87)
COMM_ARCHS = {"MIMOcom", "MIMOcomWho", "LearnWho2Com", "LearnWhen2Com"}
SELECTION_ARCHS = {"All_agents", "MIMO_All_agents"}
EVAL_DEFAULT = {"LearnWhen2Com": "activated", "LearnWho2Com": "argmax_test",
                "MIMOcom": "activated", "MIMOcomWho": "activated"}
# draw streams: offsets from the run's seed, as the JAX trainer's keys
DRAW_STREAMS = {"train": 2, "eval": 3}


def _bandwidth(parts: np.ndarray, agent_num: int) -> np.float32:
    """The bandwidth of a batch split over data ranks, from each rank's
    ``(num_connect, rows)``: each ``num_connect`` is a link count over
    ``agent_num * rows`` (or over ``rows``) rounded once to float32, so
    ``round(num_connect * agent_num * rows)`` is an integer count, exact
    below ~8M links; the counts are summed and divided once in float64, and
    the quotient rounded once, as one process's (``ops.comm.num_connect_offdiag``)."""
    scale = max(agent_num, 1)
    links = sum(round(float(value) * scale * int(n)) for value, n in parts)
    rows = sum(int(n) for _, n in parts)
    return np.float32(links / (scale * rows))


class Evaluator:
    """Evaluates the model of ``cfg`` on ``device`` (default ``cuda``;
    raises without a card unless ``device='cpu'`` is asked for). ``seed``
    (default ``training.seed``) seeds the selection baselines' draws.
    ``graphs=False`` keeps the eager eval step on the card (module
    docstring). ``layout`` (a ``parallel.Layout``) evaluates this rank's
    share on the layout's device (module docstring)."""

    def __init__(self, cfg, device: str | torch.device | None = None, loss_fn=None,
                 seed: int | None = None, graphs: bool = True, layout=None):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.layout = layout
        self.primary = layout is None or layout.primary
        self.device = resolve_device(layout.device if layout is not None else device)
        self.n_classes = N_CLASSES
        self.model = get_model(cfg, N_CLASSES, layout).to(self.device).eval()
        m = cfg["model"]
        self.arch = m["arch"]
        self.mo_flag = bool(m.get("multiple_output"))
        self.agent_num = int(m.get("agent_num") or 5)
        self.if_commun_label = cfg["data"].get("commun_label", "None")
        self.eval_default = m.get("eval_inference") or EVAL_DEFAULT.get(self.arch)
        self.normalize_on_device = bool(cfg["data"].get("on_device_normalize"))
        self.seed = int(cfg.get("training", {}).get("seed", 1337) if seed is None else seed)
        self.draws_ids = self.arch in SELECTION_ARCHS and \
            m.get("shuffle_features") == "selection"
        self._draws = {name: torch.Generator().manual_seed(self.seed + off)
                       for name, off in DRAW_STREAMS.items()}
        self.last_eval_metrics: runningScore | None = None
        self.trainloader = None  # the trainer's: int8 calibration frames come from it
        self.int8_convs: Int8Convs | None = None  # the int8 swap of the last int8 evaluate
        self.logger = logging.getLogger("multiagentperception_tpu_torch")
        self.graphs = graphs and self.device.type == "cuda" and (
            layout is None or layout.backend == "nccl")
        self.compute_dtype = compute_dtype(cfg)
        self._eval_graphs: GraphCache | None = None

    def load_weight(self, model_path: str) -> None:
        """Load a reference-format ``.pkl`` (``{'model_state': state_dict}``,
        the file ``compat.save_reference_checkpoint`` writes), strictly. A
        reference LearnWhen2Com file also holds ``argmax_decoder.*``, a
        module eval never uses that the port does not have: those keys are
        dropped with one logged line."""
        if not os.path.isfile(model_path):
            raise FileNotFoundError(
                f"{model_path}: the port loads reference-format .pkl files; turn a "
                "JAX checkpoint into one with compat.save_reference_checkpoint")
        blob = torch.load(model_path, map_location="cpu", weights_only=True)
        state = blob.get("model_state", blob) if isinstance(blob, dict) else blob
        unused = [k for k in state if k.startswith("argmax_decoder.")]
        if unused and self.arch == "LearnWhen2Com":
            logging.getLogger("multiagentperception_tpu_torch").info(
                "%s: dropping %d argmax_decoder.* keys (unused at eval, no port module)",
                model_path, len(unused))
            state = {k: v for k, v in state.items() if k not in set(unused)}
        self.model.load_state_dict(tensor.shard_state_dict(state, self.model), strict=True)
        if self.int8_convs is not None:
            self.int8_convs.clear()  # its graphs' key changes with it

    # ------------------------------------------------------------------
    # per-architecture plumbing
    # ------------------------------------------------------------------
    def _model_inputs(self, images) -> np.ndarray:
        """(B, N, H, W, 3) batch -> the model's input: Single_agent folds
        the views with multiple outputs and takes agent 0 without."""
        images = np.asarray(images)
        if self.arch == "Single_agent":
            if self.mo_flag:
                return images.reshape((-1,) + images.shape[2:])
            return np.ascontiguousarray(images[:, 0])
        return images

    def _labels(self, labels) -> np.ndarray:
        """(B, N, H, W) -> the target as uint8 (class ids 0..10 and the
        ignore index 250 both fit): batch-major ``(B*N, H, W)`` with
        multiple outputs (but for All_agents), else agent 0's ``(B, H, W)``."""
        labels = np.asarray(labels)
        if self.mo_flag and self.arch != "All_agents":
            labels = labels.reshape((-1,) + labels.shape[2:])
        else:
            labels = labels[:, 0]
        return labels.astype(np.uint8, copy=False)

    def draw_ids(self, stream: str) -> torch.Tensor:
        """The selection baselines' partners, on the host: one supporter for
        the batch (All_agents) or one partner per agent (MIMO_All_agents)."""
        n = self.agent_num
        shape = (n,) if self.arch == "MIMO_All_agents" else ()
        return torch.randint(0, n, shape, generator=self._draws[stream])

    def _forward_kwargs(self, inference: str | None, stream: str) -> dict:
        """The forward's arguments (JAX ``_apply_kwargs``): comm models take
        the inference mode, the selection baselines the drawn partners."""
        ids = self.draw_ids(stream).to(self.device) if self._takes_ids() else None
        return self._mode_kwargs(inference, ids)

    def _takes_ids(self) -> bool:
        return self.arch not in COMM_ARCHS and self.draws_ids

    def _mode_kwargs(self, inference: str | None, ids: torch.Tensor | None = None) -> dict:
        if self.arch in COMM_ARCHS:
            return {"inference": inference or "softmax"}
        return {} if ids is None else {"rand_ids": ids}

    @staticmethod
    def _outputs(out) -> tuple:
        """(prediction, action or None, num_connect or None) of any forward's
        output: a bare tensor, ``(pred, rand_action)``, or a 3- or 4-tuple."""
        if not isinstance(out, tuple):
            return out, None, None
        if len(out) == 2:
            return out[0], out[1], None
        return out[0], out[2], out[3] if len(out) > 3 else None

    # ------------------------------------------------------------------
    def _put(self, a) -> torch.Tensor:
        """A host array on the device. On the card the copy leaves from
        pinned memory without blocking the host; on the CPU it is a view."""
        t = torch.as_tensor(np.asarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _images(self, images) -> torch.Tensor:
        """A host batch's model input on the device, normalized there if the
        loader left it raw."""
        x = self._put(self._model_inputs(images))
        return normalize_images(x) if self.normalize_on_device else x

    @torch.inference_mode()
    def predict(self, images, inference: str | None = None):
        """(B, N, H, W, 3) images -> (class map (B', H, W) int32, action or
        None, num_connect or None), device tensors. The class map comes from
        the decoder's pre-upsample logits through the upsample+argmax kernel,
        or, for a decoder with none (``n_segnet_decoder``), from the argmax
        of its full-resolution logits (``class_map``)."""
        x = self._images(images)
        pre, action, num_connect = self._outputs(self.model(
            x, full_res=False, **self._forward_kwargs(inference or self.eval_default, "eval")))
        return class_map(pre, x.shape[-3], x.shape[-2]), action, num_connect

    def _normal(self, cl: torch.Tensor) -> torch.Tensor:
        """Per prediction, whether its frame is a normal one (JAX :529-541),
        from the ``commun_label`` on the device."""
        if self.if_commun_label == "mimo":
            normal = cl[:, 0, :] == 0  # (B, N)
            return normal.reshape(-1) if self.mo_flag and self.arch != "All_agents" \
                else normal[:, 0]
        return cl == -1  # when2com: (B,)

    # ------------------------------------------------------------------
    # a rank's share of a batch (module docstring)
    # ------------------------------------------------------------------
    def _shard_rows(self, data_list) -> tuple[tuple, bool]:
        """(this rank's rows of a host batch, whether they are a share of
        it): a ``ShardBatch`` holds them already, a global batch that
        divides over the data ranks is cut, anything else is whole."""
        lay = self.layout
        if lay is None or lay.data == 1:
            return data_list, False
        if isinstance(data_list, ShardBatch):
            return data_list, not data_list.whole
        size = len(data_list[0])
        if size % lay.data:
            return data_list, False
        share = size // lay.data
        rows = slice(lay.data_index * share, (lay.data_index + 1) * share)
        return tuple(np.asarray(a)[rows] for a in data_list), True

    def _agents(self, inference: str | None) -> slice | None:
        """The agents this rank's forward in ``inference`` predicts, where
        the ring splits them."""
        rings = getattr(self.model, "rings", None)
        if rings is None or not rings(inference or "softmax"):
            return None
        return self.model.local_agents(self.agent_num)

    def _reduce_group(self, rows: bool, agents: bool):
        """The group whose ranks' blocks split the batch, or None."""
        lay = self.layout
        if lay is None or not (rows or agents):
            return None
        if rows and agents:
            return lay.world_group
        return lay.data_group if rows else lay.agent_group

    def _agent_block(self, t: torch.Tensor, agents: slice | None) -> torch.Tensor:
        """A batch-major per-prediction tensor ``(B*N, ...)`` cut to the
        agents ``agents`` of each sample."""
        if agents is None:
            return t
        per_sample = t.reshape((-1, self.agent_num) + tuple(t.shape[1:]))
        return per_sample[:, agents].reshape((-1,) + tuple(t.shape[1:]))

    @torch.inference_mode()
    def eval_step(self, images, labels, commun_label=None, inference: str | None = None,
                  with_loss: bool = False, keep_pred: bool = False, rows: bool = False) -> dict:
        """One batch on the device, eagerly; returns device tensors (not read
        back). ``with_loss`` runs ``inference`` (default ``softmax``) at full
        resolution and adds the loss, as the JAX validation step does;
        ``keep_pred`` adds the class map (``pred``; the rank's block).
        ``rows``: the batch is this rank's share of the data ranks' batch."""
        t = {"x": self._put(self._model_inputs(images)), "y": self._put(self._labels(labels))}
        if commun_label is not None:
            t["cl"] = torch.as_tensor(np.asarray(commun_label), device=self.device)
        if self._takes_ids():
            t["ids"] = self.draw_ids("eval").to(self.device)
        return self._eval_body(t, inference, with_loss, keep_pred, rows)

    def _eval_body(self, t: dict, inference: str | None, with_loss: bool,
                   keep_pred: bool = False, rows: bool = False) -> dict:
        """The eval step on device inputs ``t``: ``x`` (the model's input as
        the loader gives it), ``y`` (uint8 target), and where the batch has
        them ``cl`` (``commun_label``) and ``ids`` (the drawn partners)."""
        x, y = t["x"], t["y"]
        if self.normalize_on_device:
            x = normalize_images(x)
        mode = inference if with_loss else inference or self.eval_default
        agents = self._agents(mode)
        group = self._reduce_group(rows, agents is not None)
        if with_loss:
            logits, action, num_connect = self._outputs(self.model(
                x, **self._mode_kwargs(mode, t.get("ids"))))
            pred = logits.argmax(1)
        else:
            pre, action, num_connect = self._outputs(self.model(
                x, full_res=False, **self._mode_kwargs(mode, t.get("ids"))))
            pred = class_map(pre, x.shape[-3], x.shape[-2])
        y = self._agent_block(y, agents)
        res = {"hist": confusion_matrix(y, pred, self.n_classes)}
        if keep_pred:
            res["pred"] = pred
        if action is not None:
            res["action"] = action
        if num_connect is not None:
            res["num_connect"] = num_connect
        if with_loss:
            kw = {} if group is None else {"group": group}
            res["loss"] = self.loss_fn(input=logits, target=y, **kw)
        if "cl" in t:
            normal = self._agent_block(self._normal(t["cl"]), agents)
            res["hist_pos"] = confusion_matrix(y, pred, self.n_classes, normal)
            res["hist_neg"] = confusion_matrix(y, pred, self.n_classes, ~normal)
        if group is not None:
            for key in ("hist", "hist_pos", "hist_neg", "loss"):
                if key in res:
                    res[key] = all_reduce_sum(res[key], group)
        if rows:
            data = self.layout.data_group
            if "action" in res:
                res["action"] = all_gather_cat(res["action"], data)
            if "num_connect" in res:
                share = torch.stack([res["num_connect"].double(), torch.full(
                    (), float(x.shape[0]), dtype=torch.float64, device=x.device)])
                res["num_connect_parts"] = all_gather_cat(share[None], data)
                del res["num_connect"]
            if "cl" in t:
                res["commun_label"] = all_gather_cat(t["cl"], data)
        return res

    @torch.inference_mode()
    def graph_eval_step(self, images, labels, commun_label=None, inference: str | None = None,
                        with_loss: bool = False, keep_pred: bool = False,
                        rows: bool = False) -> dict:
        """``eval_step`` through the batch's CUDA graph (module docstring);
        the results are equal, bit for bit."""
        host = {"x": torch.as_tensor(np.asarray(self._model_inputs(images))),
                "y": torch.as_tensor(np.asarray(self._labels(labels)))}
        if commun_label is not None:
            host["cl"] = torch.as_tensor(np.asarray(commun_label))
        if self._takes_ids():
            host["ids"] = self.draw_ids("eval")
        swap = active_swap(self.model)
        key = ("eval", inference, with_loss, keep_pred, rows,
               None if swap is None else swap.serial,
               self.compute_dtype, torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction,
               torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
               tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(host.items())))
        if self._eval_graphs is None:
            self._eval_graphs = GraphCache(self.device)
        return self._eval_graphs.run(
            key, host, lambda t: self._eval_body(t, inference, with_loss, keep_pred, rows),
            extra_counters=() if swap is None else (swap,),
            keep=() if swap is None else (swap,))

    def _pipelined(self, loader, depth: int = PIPELINE_DEPTH, **step_kw):
        """Yield ``(eval_step result, commun_label)`` per batch, with up to
        ``depth`` batches running ahead of the readback (JAX
        ``_pipelined_eval``): at 0 each batch is handed over, and read back
        by the caller, before the next one is dispatched. The eval draw
        stream restarts here, so each pass over a loader draws alike."""
        self._draws["eval"].manual_seed(self.seed + DRAW_STREAMS["eval"])
        pending: deque = deque()
        first = None  # the loader's batch size: another one (a ragged tail) runs eagerly
        for data_list in loader:
            data_list, rows = self._shard_rows(data_list)
            commun_label = data_list[2] if self.if_commun_label != "None" else None
            size = len(data_list[0])
            first = size if first is None else first
            step = self.graph_eval_step if self.graphs and size == first else self.eval_step
            pending.append((step(data_list[0], data_list[1], commun_label, rows=rows,
                                 **step_kw), commun_label))
            if len(pending) > depth:
                yield pending.popleft()
        while pending:
            yield pending.popleft()

    def _record(self, metrics: runningScore, res: dict, commun_label,
                bandwidth: bool = True, selection: bool = True) -> dict:
        # numpy has no bfloat16: a bf16 model's thresholded row reads back as
        # float32 (the same values); float16 reads back as it is
        host = {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
                for k, v in res.items()}
        if "num_connect_parts" in host:  # the batch's rows split over data ranks
            host["num_connect"] = _bandwidth(host.pop("num_connect_parts"), self.agent_num)
        commun_label = host.pop("commun_label", commun_label)
        metrics.update_hist(host["hist"], host.get("hist_pos"), host.get("hist_neg"))
        if bandwidth and "num_connect" in host:
            metrics.update_bandW(float(host["num_connect"]))
        if selection and commun_label is not None and "action" in host:
            action = host["action"]
            if self.arch == "LearnWho2Com":
                action = action + 1  # the requester is not a candidate key (:615-622)
            metrics.update_selection(self.if_commun_label, np.asarray(commun_label), action)
        return host

    def _print_scores(self, metrics: runningScore, bandwidth: bool = True) -> None:
        if not self.primary:
            return
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

    def _calibrate_int8(self, loader, inference: str | None, calib_loader=None) -> dict:
        """Static activation scales for the int8 path
        (``quantize.calibrate_activations``), JAX trainer.py:546-610.
        Frames come from ``calib_loader`` if given, else the train loader,
        else ``loader`` itself (with a warning: calibrating on the split
        being evaluated leaks it into the quantization).
        ``training.calib_batches`` (default 4) batches are max-reduced:
        from a dataset, its first frames in batches of the loader's size
        (a ragged tail dropped where whole batches exist); from any other
        iterable, its first batches."""
        src = calib_loader if calib_loader is not None else (
            self.trainloader if self.trainloader is not None else loader)
        if calib_loader is None and self.trainloader is None:
            self.logger.warning(
                "int8 calibration falling back to the evaluation loader itself; pass "
                "calib_loader (test --calib_split) to calibrate on held-out frames")
        n_batches = int(self.cfg["training"].get("calib_batches") or 4)
        ds = getattr(src, "dataset", None)
        bs = int(getattr(src, "batch_size", None) or 1)
        if ds is not None:
            n = min(len(ds), n_batches * bs)
            frames = [np.asarray(ds[i][0]) for i in range(n)]
            batches = [np.stack(frames[i:i + bs]) for i in range(0, n, bs)]
            if len({b.shape[0] for b in batches}) > 1:
                batches = [b for b in batches if b.shape[0] == bs] or batches[:1]
        else:
            batches = []
            for data_list in src:
                if len(batches) == n_batches:
                    break
                batches.append(np.asarray(data_list[0]))
        if not batches:
            raise ValueError("int8 calibration source yielded no frames; pass a non-empty "
                             "calib_loader or train split")
        kw = self._forward_kwargs(inference or self.eval_default, "eval")
        group = None if self.layout is None else self.layout.world_group
        return calibrate_activations(self.model, [self._images(b) for b in batches],
                                     full_res=False, group=group, **kw)

    def evaluate(self, loader, inference_mode: str | None = None, int8: bool = False,
                 calib_loader=None):
        """Test-split evaluation with the Normal/Noise/Overall breakdown,
        selection accuracy (not for LearnWhen2Com, as the reference) and
        bandwidth where the forward reports it (reference: trainer.py:774-840).
        ``int8=True`` calibrates activation scales (``calib_loader``, else
        the train loader, else ``loader``) and evaluates with the towers'
        and the decoder's convolutions in int8 (JAX trainer.py:1223-1241)."""
        self.model.eval()
        metrics = runningScore(self.n_classes)
        swap = contextlib.nullcontext()
        if int8:
            scales = self._calibrate_int8(loader, inference_mode, calib_loader)
            swap = self.int8_convs = Int8Convs(self.model, scales)
        with swap:
            for res, commun_label in self._pipelined(loader, inference=inference_mode):
                self._record(metrics, res, commun_label,
                             selection=self.arch != "LearnWhen2Com")
        self._print_scores(metrics)
        self.last_eval_metrics = metrics
        return metrics.get_scores()
