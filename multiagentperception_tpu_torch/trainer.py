"""Training of any of the seven architectures (port of multiagentperception_tpu/trainer.py:
``chunk_sizes`` :66-80, ``_StallWatchdog`` :90-150, ``_train_step_body``
:397-455, ``_train_multi_step_fn`` :373-395, the input pipeline :639-794,
``train``/``_train_loop`` :829-1022, ``_validate``/``_log_val_scores``
:1024-1065 and the checkpoints :1067-1180; ``nan_guard`` is train.py:198-204).
Each validation also prints the process's memory (``_memory_line``).

``Trainer`` extends ``evaluate.Evaluator``: one object trains, validates,
saves and loads checkpoints and evaluates, as the JAX ``Trainer`` does.
One train step is the forward in training mode (the comm models' soft
fusion, the selection baselines' partners drawn on the host; BatchNorm on
batch statistics, updating its running ones), the loss on the prediction
(``out[0]`` of a tuple), the backward and the optimizer update with the lr
``schedule(n)``, ``n`` the updates applied so far. Validation runs the
``softmax`` forward in eval mode with the loss, at full resolution.

The loop, as JAX's:

- ``training.steps_per_call: K`` runs the iterations in chunks of K that
  never cross ``val_interval``, ``save_interval`` or the end
  (``chunk_sizes``), so validation and checkpoints fire at the configured
  iterations. On the card a chunk is K replays of one CUDA graph of the
  train step (forward, backward, update; ``graphs.capture``), the
  counterpart of JAX's ``lax.scan`` over a stacked chunk: the first update
  runs eagerly on the capture stream (PyTorch's whole-network recipe), the
  optimizer is made capturable (``optimizers.make_capturable``) and reads
  its lr from a device table indexed by the updates applied, and each
  replay copies the chunk's next batch and draw into the graph's inputs.
  On the CPU, and with ``Trainer(..., graphs=False)``, a chunk is K eager
  steps. K = 1 (the default) is the eager step.
- ``device_prefetch`` (default 2; 0: synchronous): a producer thread
  keeps that many chunks on the device ahead of the step. On the card it
  copies from pinned memory on a stream of its own; the step's stream
  waits on the copy's event. A loader error is raised in the loop.
- A train loader with a checkpointable stream (``data_backend: grain``,
  ``data.grain_pipeline.GrainLoader``) is read through its
  ``persistent_iterator``; its position after each chunk's last batch is
  captured with the chunk in the producer, and the position of the last
  chunk the loop consumed rides in each checkpoint (``"data_stream"``), so
  a resumed run, or the ``rss_limit_gb`` re-exec, continues mid-epoch
  exactly, with or without prefetch and chunks. Any other loader restarts
  its epochs, as in JAX.
- ``nan_guard: N`` is ``optax.apply_if_finite(tx, N)`` (``NanGuard``): an
  update whose gradients are not all finite is dropped (parameters and
  optimizer state as they were, the schedule's count too), unless more
  than N came in a row; its counters ride in the checkpoint. BatchNorm's
  running statistics move either way, as in JAX. Eagerly the host decides;
  in a graph the device does (a finite flag and ``torch.where``).
- ``profile_dir`` traces iterations ``profile_range`` (default [10, 15))
  with ``torch.profiler``, from the chunk that crosses the start to the one
  that crosses the end, into a Chrome trace in ``profile_dir``.
- ``watchdog_secs`` (default 600, 0 disables): ``_StallWatchdog`` dumps
  every thread's stack once per stall.
- ``rss_limit_gb``: past the limit the loop checkpoints ``latest``, stops
  the input pipeline and re-execs the process (``utils.reexec_self``),
  which resumes there; a limit below the working RSS is disabled.
- ``writer`` (the train CLI's TensorBoard ``SummaryWriter``, or None):
  ``loss/train_loss`` and ``lr`` on print iterations, ``loss/val_loss``
  and ``val_metrics/*`` at validation, JAX's tags.

Mixed precision (``training.mixed_precision`` or ``model.dtype:
bfloat16``, or ``model.dtype: float16``; ``models.compute_dtype``) is the
JAX trainer's: the model computes in bf16 or float16, the loss in float32
(``loss.py``), and the optimizer steps the float32 parameters with their
float32 gradients, without loss scaling (JAX has none: a float16 gradient
that underflows to zero does so in both). Checkpoints hold float32 tensors
either way.

Checkpoints are reference-layout ``.pkl`` files
(``{"epoch", "model_state", "optimizer_state", "best_iou"}``, the layout of
the reference trainer and of ``compat.save_reference_checkpoint``, plus
``"nan_guard"`` with the guard on and ``"data_stream"`` with a
checkpointable stream), named
``<arch>_<dataset>_<best_model|latest>.pkl`` in ``logdir``; the JAX package
and the port's ``Evaluator`` both load them. ``training.resume`` reads one
back: model, optimizer, iteration, best mIoU, the guard's counters and the
stream's position (a file without it starts the stream at its beginning).

With a ``parallel.Layout`` (``layout=``) the trainer is one rank of a
data-parallel world (JAX's SPMD step over a ('data',) mesh), of a data x
model grid (the ('data', 'model') mesh of ``make_mesh``, the widest
weights' output channels sharded over each model group:
``parallel.tensor``) or of an agent ring (``model.agent_parallel_train``);
the ring owns its ranks and takes no data parallel in training, as in JAX
(train.py:195-201). The step equals the single-process step on the global
batch:

- Each rank takes its rows of every global batch; with
  ``training.shard_data_by_process`` each rank's loader reads its own
  slice and ``batch_size`` is per rank, so the global batch is P x
  ``batch_size`` (JAX trainer.py:322-362).
- BatchNorm's training statistics are the group's (``parallel.sync_bn``),
  the loss is the rank's share of the global mean (``loss.py``'s
  ``group``), and the gradients are summed over the group once a step, as
  one flat bucket; ``nan_guard`` decides on the summed gradients, so every
  rank drops the same step.
- On the grid the rows, BatchNorm statistics, loss count and gradient
  sums are the data group's alone (a model group's ranks hold the same
  rows); a shard's gradient is then whole, and the replicated parameters'
  gradients are averaged over the model group, as a dense ring's replicas
  do below, with the model group's first rank's BatchNorm statistics.
  ``nan_guard`` decides over the model group's shards together.
- Ranks start from rank 0's parameters, buffers, optimizer state and
  counts (broadcast when ``train`` starts); a shard and its Adam moments
  from the first rank of its data group. Adam's moments of a shard live on
  its rank.
- An agent ring without ``agent_parallel_train`` trains dense: every rank
  of the ring runs the whole step, as each device runs JAX's replicated
  program. The card's arithmetic is not reproducible from run to run, so
  each step the replicas average their gradients (one flat bucket) and
  take the ring's first rank's BatchNorm statistics, and stay equal.
- ``steps_per_call`` > 1 on the card captures the chunk with its
  all-reduce in the CUDA graph under NCCL; under gloo, which no graph can
  hold, it raises.
- Only rank 0 writes the ``.pkl``, the others wait for it; every rank
  resumes from it. On the model axis the shards and their Adam moments are
  gathered first, so the file is the one-process file, and a resume
  shards it again. With ``shard_data_by_process`` ``"data_stream"`` holds
  one position per rank, indexed by rank (JAX checkpoint.py:100-154).
- ``rss_limit_gb`` is disabled, with JAX's warning, when the world is larger
  than 1 (trainer.py:891-898); logs, prints and TensorBoard are rank 0's.
- Validation runs as the evaluator's sharded eval (``evaluate.py``).
"""

from __future__ import annotations

import faulthandler
import gc
import logging
import os
import queue
import sys
import threading
import time

import numpy as np
import torch

from multiagentperception_tpu_torch import graphs
from multiagentperception_tpu_torch.evaluate import Evaluator
from multiagentperception_tpu_torch.metrics import averageMeter, runningScore
from multiagentperception_tpu_torch.ops.normalize import normalize_images
from multiagentperception_tpu_torch.optimizers import (
    get_optimizer,
    make_capturable,
    make_eager,
    optimizer_tensors,
    set_lr,
)
from multiagentperception_tpu_torch.parallel import sync_bn, tensor
from multiagentperception_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    barrier,
    broadcast,
    gather_ints,
)
from multiagentperception_tpu_torch.schedulers import constant_lr
from multiagentperception_tpu_torch.utils import host_rss_gb, reexec_self


# (section, key, whether the port runs the value): every key of the JAX loop
# runs today; a key the port cannot run yet would be listed here and refused
UNPORTED: tuple = ()


def refuse_unported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config key the JAX training loop
    honours and this port does not (``UNPORTED``; ROADMAP.md lists them)."""
    for section, key, ported in UNPORTED:
        value = cfg.get(section, {}).get(key)
        if not ported(value):
            raise NotImplementedError(f"{section}.{key}={value!r} is not ported to "
                                      "the PyTorch trainer yet (ROADMAP.md)")


def chunk_sizes(start_iter: int, total: int, steps_per_call: int, *boundaries):
    """Successive steps_per_call chunk sizes from ``start_iter`` to ``total``,
    clipped so no chunk crosses a multiple of any boundary (val_interval,
    save_interval): validation and checkpointing then fire at exactly the
    configured iterations though the device runs K steps a call."""
    i = int(start_iter)
    total = int(total)
    while i < total:
        k = min(int(steps_per_call), total - i)
        for b in boundaries:
            if b:
                k = min(k, int(b) - i % int(b))
        yield k
        i += k


class _StallWatchdog:
    """Background thread that dumps every thread's Python stack to stderr if
    no training progress heartbeat arrives within ``timeout_s``: a hung
    device call or a blocked input pipeline becomes a loud, stack-attributed
    log event; the run can then be killed and resumed from the
    ``training.save_interval`` 'latest' checkpoint. Diagnosis only: it
    never kills or restarts anything.

    Two long silences must not trip it: the first chunk (kernel builds,
    cuDNN's first calls, a graph capture, a checkpoint restore), during
    which the threshold is ``timeout_s * FIRST_GRACE``; and a long
    ``steps_per_call`` chunk: ``beat(expected_secs=...)`` raises the next
    threshold to 3x the expected chunk time when that exceeds the base
    timeout."""

    FIRST_GRACE = 6.0  # pre-first-step multiplier

    def __init__(self, timeout_s: float, logger):
        self._timeout = float(timeout_s)
        self._next = float(timeout_s) * self.FIRST_GRACE
        self._logger = logger
        self._beat = time.time()
        self._dumped = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="stall-watchdog")
        self._thread.start()

    def beat(self, expected_secs: float | None = None) -> None:
        self._beat = time.time()
        self._dumped = False
        self._next = (self._timeout if expected_secs is None
                      else max(self._timeout, 3.0 * float(expected_secs)))

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(min(self._timeout / 4.0, 30.0)):
            silent = time.time() - self._beat
            if silent > self._next and not self._dumped:
                self._dumped = True  # once per stall; beat() re-arms
                self._logger.warning(
                    "no training progress for %.0f s — likely a hung device call or a "
                    "blocked input pipeline; dumping all thread stacks to stderr. If "
                    "hung, kill and resume from the 'latest' checkpoint "
                    "(training.save_interval).", silent)
                faulthandler.dump_traceback(file=sys.stderr, all_threads=True)


class NanGuard:
    """``optax.apply_if_finite(tx, max_consecutive_errors=N)``
    (optax/transforms/_conditionality.py): an update is applied if every
    gradient is finite, or once ``notfinite_count > N``. Its counters are
    0-dim tensors on the device, updated by ``decide`` without a host sync;
    ``state_dict`` holds them as numbers."""

    def __init__(self, max_errors: int, device: torch.device):
        self.max_errors = int(max_errors)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=device)
        self.last_finite = torch.ones((), dtype=torch.bool, device=device)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=device)

    def decide(self, grads, group=None) -> torch.Tensor:
        """Count this step's gradients in; returns whether to apply it (a
        bool tensor on the device). ``group``: the ranks that hold the
        step's gradients between them (a model group's shards), which
        decide together."""
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        if group is not None:
            finite = all_reduce_sum((~finite).to(torch.float32), group) == 0
        self.notfinite_count.copy_(torch.where(finite, 0, self.notfinite_count + 1))
        self.total_notfinite.add_((~finite).to(torch.int32))
        self.last_finite.copy_(finite)
        return finite | (self.notfinite_count > self.max_errors)

    def state_dict(self) -> dict:
        return {"notfinite_count": int(self.notfinite_count),
                "last_finite": bool(self.last_finite),
                "total_notfinite": int(self.total_notfinite)}

    def load_state_dict(self, state: dict) -> None:
        for name in ("notfinite_count", "last_finite", "total_notfinite"):
            getattr(self, name).fill_(state[name])


class Trainer(Evaluator):
    """Trains, validates and checkpoints the model of ``cfg`` on ``device``
    (default the card). The model starts as ``models.get_model`` builds it;
    initialize or load its weights before ``train``. ``schedule`` maps an
    update's index to its lr (default: the config's constant lr); ``seed``
    (default ``training.seed``) seeds the selection baselines' draws;
    ``writer`` takes the TensorBoard scalars; ``graphs=False`` keeps every
    step eager on the card; ``layout`` makes it one rank of a data-parallel
    world or an agent ring (module docstring)."""

    # the rss_limit_gb restart (tests substitute a recorder)
    _reexec_fn = staticmethod(reexec_self)

    def __init__(self, cfg, logger: logging.Logger | None, loss_fn, trainloader, valloader,
                 schedule=None, device: str | torch.device | None = None,
                 logdir: str | None = None, seed: int | None = None, writer=None,
                 graphs: bool = True, layout=None):
        refuse_unported(cfg)
        super().__init__(cfg, device, loss_fn=loss_fn, seed=seed, graphs=graphs, layout=layout)
        self._graphs_asked = graphs
        self.logger = logger or logging.getLogger("multiagentperception_tpu_torch")
        self.trainloader = trainloader
        self.valloader = valloader
        self.writer = writer
        cfg_t = cfg["training"]
        opt_cfg = cfg_t.get("optimizer")
        self.schedule = schedule or constant_lr(opt_cfg["lr"] if opt_cfg else 0.01)
        self.optimizer = get_optimizer(cfg, self.model.parameters(), self.schedule(0))
        self.logdir = logdir or os.path.join("runs", "default")
        self.freeze_bn = bool(cfg_t.get("freeze_bn_stats"))
        guard = cfg_t.get("nan_guard")
        self.guard = NanGuard(int(guard), self.device) if guard else None
        self.profile_dir = cfg_t.get("profile_dir")
        self.profile_range = tuple(cfg_t.get("profile_range") or (10, 15))
        self.step = 0  # train steps done
        self.applied = 0  # updates applied (the schedule's count): step, less nan_guard's drops
        self.iter_seconds: list[float] = []  # wall time of each train iteration
        self.loss_history: dict[int, float] = {}  # iteration -> loss, where read back
        self.running_metrics_val = runningScore(self.n_classes)
        self._train_graph: graphs.Graph | None = None
        self._graph_state: dict = {}
        self._streams: dict = {}
        self._profiler = None
        self._prefetch_stop = self._prefetch_thread = None
        self._consumed_stream_state = None  # the train stream's position after the last chunk run
        # the group whose ranks split each step's work, or whose ranks each run
        # the whole step and average it (module docstring)
        self.train_group = self.replica_group = None
        self.local_stream = False
        # the model group whose ranks hold the step's gradients between them
        self.shard_group = None
        if layout is not None:
            if layout.agent > 1 and layout.data > 1:
                raise ValueError("the agent ring owns its ranks in training: a layout of "
                                 f"data {layout.data} x agent {layout.agent} trains nothing")
            if layout.agent == 1:
                self.train_group = layout.data_group
                sync_bn.attach(self.model, self.train_group)
                self.local_stream = layout.data > 1 and bool(cfg_t.get("shard_data_by_process"))
                if layout.model > 1:  # the replicated parameters' copies stay equal
                    self.replica_group = self.shard_group = layout.model_group
            elif self.model.ring_train:
                self.train_group = layout.agent_group
            else:
                self.replica_group = layout.agent_group

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

    def _applied_count(self) -> int:
        """Updates applied so far (read back from the device after graph
        replays under ``nan_guard``)."""
        if self._train_graph is not None and self.guard is not None:
            self.applied = int(self._graph_state["applied"])
        return self.applied

    def _grads(self) -> list[torch.Tensor]:
        return [p.grad for p in self.model.parameters() if p.grad is not None]

    def _loss(self, x: torch.Tensor, labels: torch.Tensor, ids) -> torch.Tensor:
        """The training forward and its loss (with a train group, the
        rank's share of the group's loss)."""
        self.train_mode()
        if self.normalize_on_device:
            x = normalize_images(x)
        out = self.model(x, **self._mode_kwargs("softmax", ids))
        pred = out[0] if isinstance(out, tuple) else out
        labels = self._agent_block(labels, self._agents("softmax"))
        kw = {} if self.train_group is None else {"group": self.train_group}
        return self.loss_fn(input=pred, target=labels, **kw)

    @staticmethod
    def _reduce_flat(tensors: list[torch.Tensor], group, how: str) -> None:
        """``tensors`` summed (``"sum"``), averaged (``"mean"``) or taken from
        the group's first rank (``"first"``) over ``group``, in place, as one
        flat bucket."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if how == "first":
            flat = broadcast(flat, group)
        else:
            flat = all_reduce_sum(flat, group)
            if how == "mean":
                flat = flat / group.size
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    def _reduce_grads(self) -> None:
        """Sum the gradients over the train group, then average those of
        the replicated parameters over the replicas (module docstring)."""
        grads = self._grads()
        if grads and self.train_group is not None:
            self._reduce_flat(grads, self.train_group, "sum")
        if self.replica_group is not None:
            shards = tensor.shard_ids(self.model)
            replicated = [p.grad for p in self.model.parameters()
                          if p.grad is not None and id(p) not in shards]
            if replicated:
                self._reduce_flat(replicated, self.replica_group, "mean")

    def _sync_replicas(self) -> None:
        """The replica group's first rank's BatchNorm statistics on every
        replica after a step (exact: equal statistics stay as they are)."""
        if self.replica_group is not None:
            with torch.no_grad():
                self._reduce_flat([b for b in self.model.buffers() if b.is_floating_point()],
                                  self.replica_group, "first")

    def _broadcast_state(self) -> None:
        """Rank 0's parameters, buffers, optimizer state and counts on every
        rank; a shard, and its optimizer state, from the first rank of its
        data group (the rank of its model index in the first grid row)."""
        world = self.layout.world_group
        shards = tensor.shard_ids(self.model)
        with torch.no_grad():
            tensors = [(t, world) for t in self.model.buffers()]
            for p in self.model.parameters():
                group = self.layout.data_group if id(p) in shards else world
                tensors += [(p.detach(), group)] + [
                    (v, group if v.shape == p.shape else world)
                    for v in self.optimizer.state.get(p, {}).values()
                    if isinstance(v, torch.Tensor)]
            if self.guard is not None:
                tensors += [(self.guard.notfinite_count, world), (self.guard.last_finite, world),
                            (self.guard.total_notfinite, world)]
            for t, group in tensors:
                if t.device == group.device:
                    broadcast(t, group)
                else:  # Adam's step counts live on the host
                    t.copy_(broadcast(t.to(group.device), group))
            counts = broadcast(torch.tensor([self.step, self.applied], device=world.device),
                               world)
        self.step, self.applied = (int(v) for v in counts.cpu())

    def _train_rows(self, data_list):
        """This rank's rows of a train batch (module docstring)."""
        if self.layout is None or self.layout.data == 1 or self.local_stream:
            return data_list
        rows, sharded = self._shard_rows(data_list)
        if not sharded:
            raise ValueError(f"a train batch of {len(data_list[0])} does not divide over "
                             f"{self.layout.data} data ranks")
        return rows

    def train_step(self, images: torch.Tensor, labels: torch.Tensor,
                   ids: torch.Tensor | None = None) -> torch.Tensor:
        """One eager update on a device batch; returns the loss (not read
        back). The gradients stay in ``.grad`` until the next step. The
        selection baselines draw one set of partners per step (or take
        ``ids``). Under ``nan_guard`` the host reads the guard's decision."""
        if ids is None and self._takes_ids():
            ids = self.draw_ids("train").to(self.device)
        applied = self._applied_count()
        set_lr(self.optimizer, self.schedule(applied))
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(images, labels, ids)
        loss.backward()
        self._reduce_grads()
        if self.guard is None or bool(self.guard.decide(self._grads(), self.shard_group)):
            self.optimizer.step()
            self.applied = applied + 1
        self._sync_replicas()
        self.step += 1
        return loss.detach()

    # ------------------------------------------------------------------
    # the train step as a CUDA graph
    # ------------------------------------------------------------------
    def _graph_body(self, static: dict) -> dict:
        """The captured train step on the static inputs: lr from the table
        at the applied count, forward, backward, the update (kept or put
        back by the guard on the device), the count."""
        st = self._graph_state
        table = st["lr_table"]
        index = st["applied"].clamp(max=table.numel() - 1).reshape(1)
        st["lr"].copy_(table.index_select(0, index).reshape(()))
        loss = self._loss(static["x"], static["y"], static.get("ids"))
        loss.backward()
        self._reduce_grads()
        if self.guard is None:
            self.optimizer.step()
            st["applied"].add_(1)
        else:
            apply = self.guard.decide(self._grads(), self.shard_group)
            with torch.no_grad():
                tensors = optimizer_tensors(self.optimizer)
                saved = [t.clone() for t in tensors]
                self.optimizer.step()
                for t, s in zip(tensors, saved):
                    t.copy_(torch.where(apply, t, s))
            st["applied"].add_(apply.to(torch.int64))
        self._sync_replicas()
        return {"loss": loss.detach()}

    def _capture_train_step(self, static: dict) -> None:
        """Make the optimizer capturable and capture ``_graph_body``."""
        total = int(self.cfg["training"]["train_iters"])
        lr_table = torch.tensor([self.schedule(t) for t in range(total + 1)],
                                dtype=torch.float32, device=self.device)
        lr = torch.zeros((), dtype=torch.float32, device=self.device)
        applied = torch.full((), self.applied, dtype=torch.int64, device=self.device)
        self._graph_state.update(lr_table=lr_table, lr=lr, applied=applied)
        make_capturable(self.optimizer, lr)
        self.optimizer.zero_grad(set_to_none=True)
        key = ("train", tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(static.items())))
        self._train_graph = graphs.capture(key, self._graph_body, static,
                                           torch.cuda.graph_pool_handle(), self._stream("capture"))

    def _stream(self, name: str) -> torch.cuda.Stream:
        """The side stream ``name`` (``capture``: warm-up and capture;
        ``copy``: the prefetch's copies), made once."""
        if name not in self._streams:
            self._streams[name] = torch.cuda.Stream(self.device)
        return self._streams[name]

    def _chunk(self, xs: torch.Tensor, ys: torch.Tensor, k: int, graph: bool) -> torch.Tensor:
        """K train steps on a stacked device chunk; returns their (K,) losses
        on the device. With ``graph``: the train graph's replays (the run's
        first update eager on the capture stream, the next one captured);
        else K eager steps."""
        ids = None
        if self._takes_ids():
            ids = torch.stack([self.draw_ids("train") for _ in range(k)]).to(self.device)
        step_ids = (lambda j: None) if ids is None else (lambda j: ids[j])
        if not graph:
            return torch.stack([self.train_step(xs[j], ys[j], step_ids(j)) for j in range(k)])
        losses, j = [], 0
        while self._train_graph is None and j < k:
            # capture once an eager update ran on the capture stream in this
            # process and the optimizer's state exists (an update was applied)
            if self.step == self._graph_state.get("warm_at") and self.applied > 0:
                static = {"x": xs[j].clone(), "y": ys[j].clone()}
                if ids is not None:
                    static["ids"] = ids[j].clone()
                self._capture_train_step(static)
                break
            losses.append(graphs.on_stream(self._stream("capture"), lambda: {
                "loss": self.train_step(xs[j], ys[j], step_ids(j))})["loss"])
            self._graph_state["warm_at"] = self.step
            j += 1
        if self._train_graph is None:  # the chunk ended before the capture
            return torch.stack(losses)
        static = self._train_graph.inputs
        for j in range(j, k):
            static["x"].copy_(xs[j])
            static["y"].copy_(ys[j])
            if ids is not None:
                static["ids"].copy_(ids[j])
            with torch.profiler.record_function(f"train_replay {self.step + 1}"):
                self._train_graph.replay()
            losses.append(self._train_graph.outputs["loss"].clone())
            self.step += 1
            if self.guard is None:
                self.applied += 1
        return torch.stack(losses)

    # ------------------------------------------------------------------
    # the input pipeline
    # ------------------------------------------------------------------
    def _train_batches(self):
        """Endless train-batch stream: a checkpointable loader's persistent
        iterator (a resumed run continues mid-epoch), else one loader epoch
        after another."""
        if hasattr(self.trainloader, "persistent_iterator"):
            yield from self.trainloader.persistent_iterator()
        else:
            while True:
                yield from self.trainloader

    def _prefetch_depth(self) -> int:
        depth = self.cfg["training"].get("device_prefetch")
        return 2 if depth is None else int(depth)

    def _put_chunk(self, *arrays) -> tuple:
        """Host arrays on the device; on the card a copy from pinned memory
        on the prefetch stream, and the event that marks its end."""
        if self.device.type != "cuda":
            return tuple(torch.as_tensor(a) for a in arrays), None
        stream = self._stream("copy")
        with torch.cuda.stream(stream):
            out = tuple(torch.as_tensor(a).pin_memory().to(self.device, non_blocking=True)
                        for a in arrays)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def _device_train_chunks(self, steps_per_call: int, start_iter: int):
        """Yield (xs, ys, k, stream_state): stacked (k, ...) chunks on the
        device, prefetched ``device_prefetch`` deep, and the train stream's
        position after the chunk's last batch (None for a loader without
        one), read in the producer as it pulls the chunk: the live stream
        runs ahead of the step. Chunks never cross a validation, save or
        end boundary (``chunk_sizes``), so checkpoints fall at chunk ends."""
        cfg_t = self.cfg["training"]
        get_state = getattr(self.trainloader, "get_state", None)

        def prepared():
            batches = self._train_batches()
            for k in chunk_sizes(start_iter, int(cfg_t["train_iters"]), steps_per_call,
                                 cfg_t["val_interval"], cfg_t.get("save_interval")):
                xs, ys = [], []
                for _ in range(k):
                    data_list = self._train_rows(next(batches))
                    xs.append(self._model_inputs(data_list[0]))
                    ys.append(self._labels(data_list[1]))
                state = get_state() if get_state is not None else None
                if k == 1:
                    host = (np.expand_dims(xs[0], 0), np.expand_dims(ys[0], 0))
                else:
                    host = (np.stack(xs), np.stack(ys))
                yield (*self._put_chunk(*host), k, state)

        for (xs, ys), done, k, state in self._prefetched(prepared(), self._prefetch_depth()):
            if done is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(done)
                xs.record_stream(current)
                ys.record_stream(current)
            yield xs, ys, k, state

    def _prefetched(self, gen, depth: int):
        """Drain ``gen`` in a producer thread, keeping up to ``depth`` items
        queued ahead of the consumer; its errors are raised here."""
        if depth <= 0:
            yield from gen
            return
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def _put(item) -> None:
            # stop-checking put: a blocking q.put would pin the producer (and
            # its device batches) forever once the consumer left a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def produce():
            try:
                for item in gen:
                    _put(item)
                    if stop.is_set():
                        return
            except BaseException as exc:  # surface loader errors in the consumer
                _put(exc)

        t = threading.Thread(target=produce, daemon=True, name="train-device-prefetch")
        t.start()
        self._prefetch_stop, self._prefetch_thread = stop, t
        try:
            while True:
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    def _shutdown_input_pipeline(self) -> None:
        """Stop the prefetch thread and the train loader before a re-exec
        (``execv`` skips interpreter shutdown)."""
        if self._prefetch_stop is not None:
            self._prefetch_stop.set()
        t = self._prefetch_thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        shutdown = getattr(self.trainloader, "shutdown", None)
        if callable(shutdown):
            shutdown()
        gc.collect()

    # ------------------------------------------------------------------
    def train(self) -> str | None:
        """The training loop; returns the best checkpoint's path (None if no
        validation ran)."""
        cfg_t = self.cfg["training"]
        if self.writer is None and self.primary:
            self.logger.info("no TensorBoard writer: metrics go to stdout and the log")
        steps_per_call = max(1, int(cfg_t.get("steps_per_call") or 1))
        if (self.layout is not None and self.layout.backend == "gloo" and steps_per_call > 1
                and self._graphs_asked and self.device.type == "cuda"):
            raise RuntimeError(
                f"training.steps_per_call={steps_per_call} on the card captures each chunk "
                "with its all-reduce in a CUDA graph, and no graph holds a collective of "
                "backend gloo (ranks sharing a card): use steps_per_call 1, or one card "
                "per rank (nccl)")
        best_iou = -100.0
        resume = cfg_t.get("resume")
        if resume is not None and os.path.isfile(str(resume)):
            best_iou = self._restore_full(str(resume))
            self.logger.info("Loaded checkpoint '%s' (iter %d)", resume, self.step)
            print(f"Loaded checkpoint '{resume}' (iter {self.step})")
        elif resume is not None:
            self.logger.info("No checkpoint found at '%s'", resume)
        if self.layout is not None:
            self._broadcast_state()
        if self.step >= int(cfg_t["train_iters"]):
            return None
        watchdog_secs = cfg_t.get("watchdog_secs")
        watchdog_secs = 600.0 if watchdog_secs is None else float(watchdog_secs)
        watchdog = _StallWatchdog(watchdog_secs, self.logger) if watchdog_secs > 0 else None
        try:
            return self._train_loop(cfg_t, best_iou, watchdog)
        finally:
            if watchdog is not None:
                watchdog.stop()
            if self._profiler is not None:  # the run ended inside the range
                self._stop_profile()

    def _train_loop(self, cfg_t: dict, best_iou: float, watchdog) -> str | None:
        total, print_interval = int(cfg_t["train_iters"]), int(cfg_t["print_interval"])
        val_interval, save_interval = int(cfg_t["val_interval"]), cfg_t.get("save_interval")
        rss_limit, rss_baseline_logged = float(cfg_t.get("rss_limit_gb") or 0.0), False
        if rss_limit and self.layout is not None and self.layout.world > 1:
            # re-exec'ing one rank would leave the others waiting in a collective
            self.logger.warning("training.rss_limit_gb is single-process only; disabling "
                                "(process_count=%d)", self.layout.world)
            rss_limit = 0.0
        steps_per_call = max(1, int(cfg_t.get("steps_per_call") or 1))
        if steps_per_call > 1:
            for name in ("val_interval", "save_interval"):
                b = cfg_t.get(name)
                if b and int(b) % steps_per_call:
                    self.logger.info("steps_per_call=%d does not divide %s=%d: boundary "
                                     "chunks are shorter", steps_per_call, name, int(b))
        graph = self.graphs and steps_per_call > 1
        time_meter, save_path, i = averageMeter(), None, self.step
        per_iter_est = None  # no beat before the first chunk ends (FIRST_GRACE)
        p0, p1 = self.profile_range
        for xs, ys, k, stream_state in self._device_train_chunks(steps_per_call, i):
            if watchdog is not None and per_iter_est is not None:
                watchdog.beat(expected_secs=k * per_iter_est)
            start = time.time()
            if self.profile_dir and i < p0 <= i + k:
                self._start_profile()
            with torch.profiler.record_function(f"train_iters {i + 1}-{i + k}"):
                losses = self._chunk(xs, ys, k, graph)
            self._consumed_stream_state = stream_state
            if self._profiler is not None and i < p1 <= i + k:
                self._stop_profile()
            # on print iterations the readback waits for the chunk, so the
            # timed window holds the device's work, not only its launch
            loss_host = None
            if any((i + j + 2) % print_interval == 0 for j in range(k)):
                loss_host = losses.float().cpu().numpy()
            per_iter = (time.time() - start) / k
            per_iter_est = per_iter
            for j in range(k):
                i += 1
                self.iter_seconds.append(per_iter)
                time_meter.update(per_iter)
                if loss_host is not None:
                    self.loss_history[i] = float(loss_host[j])
                if (i + 1) % print_interval == 0 and self.primary:
                    loss_val = float(loss_host[j])
                    line = (f"Iter [{i + 1:d}/{total:d}]  Loss: {loss_val:.4f}  "
                            f"Time/Image: {time_meter.avg / cfg_t['batch_size']:.4f}")
                    print(line)
                    self.logger.info(line)
                    if self.writer is not None:
                        self.writer.add_scalar("loss/train_loss", loss_val, i + 1)
                        self.writer.add_scalar("lr", float(self.schedule(i)), i + 1)
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

            if rss_limit and i < total:
                rss = host_rss_gb()
                if not rss_baseline_logged:
                    rss_baseline_logged = True
                    if rss >= rss_limit:  # it would re-exec forever
                        self.logger.warning(
                            "training.rss_limit_gb=%.1f is below this process's working "
                            "RSS %.2f GiB; disabling the restart guard", rss_limit, rss)
                        rss_limit = 0.0
                elif rss > rss_limit:
                    path = self._save_ckpt("latest", i, best_iou)
                    self.logger.warning(
                        "RSS %.2f GiB > training.rss_limit_gb=%.1f at iter %d: "
                        "checkpointed '%s', re-exec'ing", rss, rss_limit, i, path)
                    if self.writer is not None:
                        self.writer.flush()
                    self._shutdown_input_pipeline()
                    self._reexec_fn(path)  # never returns but under a test's recorder
                    return save_path
            if i >= total:
                break
        self._applied_count()
        return save_path

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.start()

    def _stop_profile(self) -> None:
        """Stop the trace and write it as ``train_iters_<start>-<end>.pt.trace.json``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        p0, p1 = self.profile_range
        prof.export_chrome_trace(os.path.join(self.profile_dir,
                                              f"train_iters_{p0}-{p1}.pt.trace.json"))

    def _validate(self) -> None:
        """Softmax-mode validation with the loss (trainer.py:1024-1035)."""
        self.model.eval()
        meter = averageMeter()
        for res, commun_label in self._pipelined(self.valloader, with_loss=True):
            host = self._record(self.running_metrics_val, res, commun_label, bandwidth=False)
            meter.update(float(host["loss"]))
        self._val_loss_avg = meter.avg

    def _log_val_scores(self, i: int) -> None:
        rm, w = self.running_metrics_val, self.writer
        if w is not None:
            if self.if_commun_label != "None" and rm.total_agent > 0:
                when_acc, who_acc = rm.get_selection_accuracy()
                w.add_scalar("val_metrics/when_com_accuacy", when_acc, i)
                w.add_scalar("val_metrics/who_com_accuracy", who_acc, i)
            w.add_scalar("loss/val_loss", self._val_loss_avg, i)
            score, class_iou = rm.get_scores()
            for key, value in score.items():
                w.add_scalar(f"val_metrics/{key.strip()}", value, i)
            for key, value in class_iou.items():
                w.add_scalar(f"val_metrics/cls_{key}", value, i)
        if self.primary:
            self.logger.info("Iter %d Loss: %.4f", i, self._val_loss_avg)
            line = self._memory_line(i)
            print(line)
            self.logger.info(line)
        self._print_scores(rm, bandwidth=False)

    def _memory_line(self, i: int) -> str:
        """The process's host RSS and, on the card, the device memory its
        tensors hold and the most they held: a long run's leak shows as a
        climb from one validation to the next."""
        line = f"Memory at iter {i}: host RSS {host_rss_gb():.3f} GiB"
        if self.device.type == "cuda":
            gib = 1024.0 ** 3
            line += (f", device allocated {torch.cuda.memory_allocated(self.device) / gib:.3f}"
                     f" GiB, peak {torch.cuda.max_memory_allocated(self.device) / gib:.3f} GiB")
        return line

    # ------------------------------------------------------------------
    def _save_ckpt(self, name: str, i: int, best_iou: float) -> str:
        """Write the reference-layout ``.pkl``; a crash mid-write leaves the
        previous file whole (write aside, then rename). Every rank calls it;
        rank 0 writes, the others wait for the file."""
        path = os.path.join(self.logdir, f"{self.cfg['model']['arch']}_"
                                         f"{self.cfg['data']['dataset']}_{name}.pkl")
        stream = self._consumed_stream_state
        if stream is None and hasattr(self.trainloader, "get_state"):
            stream = self.trainloader.get_state()  # a save before any chunk ran
        if stream is not None and self.local_stream:  # one position per rank
            keys = ("seed", "epoch", "consumed")
            stream = [dict(zip(keys, v)) for v in gather_ints(
                [int(stream[k]) for k in keys], self.layout.world_group)]
        # a model group's shards gathered: the one-process file
        model_state = tensor.gather_state_dict(self.model)
        optimizer_state = tensor.gather_optimizer_state(self.optimizer, self.model)
        if not self.primary:
            barrier(self.layout.world_group)
            return path
        os.makedirs(self.logdir, exist_ok=True)
        blob = {"epoch": i, "model_state": model_state,
                "optimizer_state": optimizer_state, "best_iou": float(best_iou)}
        if self.guard is not None:
            blob["nan_guard"] = {**self.guard.state_dict(), "applied": self._applied_count()}
        if stream is not None:
            blob["data_stream"] = stream
        torch.save(blob, path + ".tmp")
        os.replace(path + ".tmp", path)
        if self.layout is not None:
            barrier(self.layout.world_group)
        return path

    def _restore_full(self, path: str) -> float:
        """Model, optimizer, iteration, the guard's counters and the train
        stream's position from a ``.pkl``; returns its best mIoU."""
        blob = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(tensor.shard_state_dict(blob["model_state"], self.model),
                                   strict=True)
        self.optimizer.load_state_dict(tensor.shard_optimizer_state(
            blob["optimizer_state"], self.optimizer, self.model))
        make_eager(self.optimizer)  # a graph run's file: its step counts back on the host
        self.step = self.applied = int(blob["epoch"])
        if self.guard is not None and "nan_guard" in blob:
            self.guard.load_state_dict(blob["nan_guard"])
            self.applied = int(blob["nan_guard"]["applied"])
        stream = blob.get("data_stream")
        if isinstance(stream, list):  # one position per rank
            world = 1 if self.layout is None else self.layout.world
            if len(stream) != world:
                self.logger.warning("%s holds the stream positions of %d ranks, not %d: "
                                    "the stream restarts at its beginning", path,
                                    len(stream), world)
                stream = None
            else:
                stream = stream[self.layout.rank]
        if stream is not None and hasattr(self.trainloader, "set_state"):
            self.trainloader.set_state(stream)
            self._consumed_stream_state = stream
        return float(blob["best_iou"])
