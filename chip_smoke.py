#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of when2com on one NVIDIA card, end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --int8-draws 10   # phase 10's trained int8 check alone, 10 trainings

Imports nothing of JAX or of the JAX package. Phases; any failure raises
and the script exits non-zero:

1. Kernels. Build K1 (``upsample_argmax``), K2 (``comm_fusion``) and K3's
   four routes (``fused_basic_block``, ``fused_block.route``): on Hopper's
   tensor cores ``fused_block_wgmma.cu`` (bfloat16, C = 64/128),
   ``fused_block_tf32.cu`` (float32 with 3xTF32 products, C = 64/128), and
   at C = 256/512, as two implicit-GEMM convolutions,
   ``fused_block_wgmma_conv.cu`` (bfloat16) and ``fused_block_tf32_conv.cu``
   (float32, 3xTF32), from ``multiagentperception_tpu_torch/csrc`` with
   nvcc for sm_90a, all at once; print the ``-Xptxas -v`` register and
   spill lines (and any ptxas warning) of every kernel, and fail unless
   each tensor-core library's SASS (``cuobjdump -sass``) holds HGMMA
   instructions, and K4's (``int8_conv``) IGMMA (wgmma on s8) and
   UTMALDG (TMA loads) ones (the counts are printed). Hold each kernel against its
   plain PyTorch version on the card, and time the kernel, the plain
   version and one PyTorch library call (a yardstick only: the port never
   calls it); K1 and K2 also by CUPTI alone, back to back (``cupti_warm_ms``,
   to set beside their time on the eval path). The checks and their
   tolerances are ``ops/kernels/checks.py``'s: K1 agrees on at least
   99.99% of pixels and every disagreement is a near-tie (the plain
   version's top two upsampled logits within 1e-4); an all-equal input
   gives class 0. K2: fused within rtol/atol 1e-5, graphs
   within 1e-6, masks equal, in all three modes. K3 at the flagship's four
   stride-1 blocks (C=64 at 128x128, C=128 at 64x64, C=256 at 32x32, C=512
   at 16x16), in float32 at the eval's B*N = 12 within rtol/atol 1e-4 (the
   cuDNN yardstick timed with TF32 off, K3's precision, and on, PyTorch's
   default), and in bfloat16 at the bench's B*N = 120: at C = 64/128 within
   ``checks.assert_bf16_close``'s bounds, at C = 256/512 by the rule
   ``checks.assert_bf16_wide`` states (the near-bound share against the
   plain version; and, summed over K3_WIDE_SEEDS, no more elements beyond
   the far bound from the block in float64 than the plain version has).
   Then K3's C = 64/128 tensor-core routes and their plain versions are
   each compared with the block in float64, over 16 seeds at two ragged
   shapes and 64 seeds at six images smaller than one tile (3x3, 5x7, 7x13
   at C = 64 and 128), with the elements beyond the bound split into the
   image's border rows and columns and its interior (printed, not checked).
2. The eval slice at full width. The flagship MIMOcom
   (``configs/multi-request-multi-support/mrms_when2com.yml``, 6 agents at
   512x512, unchanged) from a seeded init is saved as a reference-format
   ``.pkl``, loaded through ``Evaluator.load_weight`` and evaluated in
   ``activated`` mode over seeded in-memory batches of the loader's
   shapes. K1's and K2's launch counts are zeroed just before and read
   just after; each must have launched its float32 route once per batch
   (``_expected_launches``) and its 16-bit routes never, and the logits of
   one batch must be finite. Prints eval frames/s (a frame is
   one agent's view) over the timed window, then traces the same batches
   again under ``torch.profiler``: the device's busy share is the traced
   device time over the untraced window's wall time, and the ``Memcpy
   HtoD`` time per batch (the evaluator copies from pinned memory). Then
   the same batches' copies alone, traced from pageable memory and as the
   evaluator makes them, side by side.
3. Card against CPU, eval. The same slice at 256x256 with TF32 off, from
   one set of weights: actions and bandwidth equal, class maps agree on at
   least 99.9% of pixels.
4. The K3 path: ``bench_fused_block``'s main over layer1-layer4, once in
   bfloat16 at B*N = 120 (the wgmma and wgmma_conv routes) and once in
   float32 at the eval's B*N = 12 (the tf32x3 and tf32x3_conv routes),
   with K3's launch counts per route zeroed just before each run and read
   just after; each route of a run must have launched.
5. Training at full width: the flagship YAML (cut to 12 iterations, one
   validation over 2 batches at the end, a loss readback every iteration)
   from ``models.init_weights`` over seeded in-memory batches, through
   ``Trainer.train``. Prints train frames/s and ms per step over the last
   10 iterations, the losses, the peak device memory and the device's busy
   share over a traced window of steps; requires finite losses and moved
   parameters. Then the best ``.pkl`` is evaluated by ``Evaluator`` in
   ``activated`` mode, and K1 and K2 must launch.
6. Card against CPU, one training step at 256x256 with TF32 off, from one
   set of weights and one batch: loss within rtol 1e-4, BatchNorm running
   statistics within rtol 1e-4 / atol 1e-5, the parameters after the Adam
   step within atol 2*lr; gradients per tensor within relative L2 3e-2
   and cosine 0.9995 (the count within 1e-3 is printed). Chains
   of training-mode BatchNorms make these gradients ill-conditioned: with
   TF32 off, cuDNN's float32 gradients lie up to ~1.5e-2 from the float64
   ones (as the JAX package's do on the CPU), the port's CPU ones up to
   ~5e-3 (tests/test_torch_train_parts.py). Each side's largest distance
   from the CPU's float64 gradient is printed.

7. The zoo: each of the other nine reference YAMLs under
   ``configs/multi-request-multi-support/`` and
   ``configs/single-request-multiple-support/`` at its own size (512x512,
   its agents and batch size, unchanged), one model each from
   ``models.init_weights``, saved as a reference-format ``.pkl`` and loaded
   through ``Evaluator.load_weight``. Two seeded batches (labels of the
   YAML's ``commun_label`` kind) are evaluated in the architecture's
   default mode and in every other inference mode it has, K1's launch
   count zeroed just before each and read just after (each must be >= 1);
   ms per batch, bandwidth and selection accuracy where the architecture
   has them. Then ``Trainer.train`` for 3 iterations with a loss readback
   each (finite losses), ms per step and peak device memory. Then card
   against CPU at 256x256 with TF32 off, one set of weights and one seed:
   actions and bandwidth equal, class maps on at least 99.9% of pixels.
8. Mixed precision (``model.dtype: bfloat16`` / ``training.mixed_precision``).
   K1's and K2's bf16 routes against their plain versions at the
   flagship's shapes (``checks``: K1's near-tie rule; K2's graphs within
   1e-6 and fused within one bf16 ulp + 1e-5), timed as phase 1 times the
   float32 routes. The flagship's bf16 ``activated`` eval as phase 2 runs
   it, at the YAML's batch 2 x 6 and at the bench's 20 x 6 (the JAX
   bench's main(), bench.py:382): each kernel's bf16 route launches once per batch and
   its float32 route never; frames/s, ms per batch, device time, busy
   share, peak memory. Card against CPU in bf16 at 256x256 (TF32 off):
   over 4 seeds the card's bf16 pre-upsample logits lie no further from
   its float32 ones than twice the CPU's bf16 from the CPU's float32
   (relative L2, summed). Training with ``training.mixed_precision`` as
   phase 5 runs it: finite float32 losses, float32 parameters that moved,
   ms per step. Each of the nine other reference YAMLs with
   ``model.dtype: bfloat16``: one evaluation of 2 batches in its default
   mode, K1's bf16 route launched once per batch.
9. The bench (``python -m multiagentperception_tpu_torch.bench``). K1 and
   K2 against their plain versions at the bench's shapes (batch 20 x 6) in
   both types, and K2's graph and its float32 plain version's each against
   float64 over 8 draws (printed: the reason the check reads float64); then ``bench.main`` at its defaults in bfloat16 and in
   float32, each JSON line printed and held: every key present and
   finite, K1 and K2 once per eval step on the dtype's route (counts
   zeroed just before, read just after), MFU in (0, 100], device time per
   step at most 1.05 x the amortized step. Then one bf16 train step of the
   flagship at batch 8 x 6 without and with ``model.remat`` from one set of
   weights: loss and BatchNorm running statistics within rtol 1e-5 / atol
   1e-6, the momentum applied once, remat's peak memory lower (both
   printed).

10. int8 (``quantize.py``, K4 ``int8_conv``). K4 against its plain version
   (``checks.check_int8_conv``: the int8 scratch its GEMM route reads,
   int32 sums and outputs equal, the outputs to the bit) at every conv
   shape of the flagship's eval step at the bench's batch 20 x 6, in
   float32 and bf16 and with a static and a dynamic activation scale, each
   shape timed whole and by launch (the quantize pass, the GEMM on its
   scratch) beside its plain version, its bounds, and two yardsticks:
   cuDNN's bf16 convolution and ``torch._int_mm`` on the GEMM's int8
   matrices (im2col built untimed; its sums must equal K4's).
   The flagship's ``activated`` int8 eval through ``Evaluator.evaluate(...,
   int8=True)`` at the YAML's batch, in float32 and bf16: K4 launches once
   per eligible conv call (48 a batch), K1 once a batch, K2 once a batch
   and once a calibration batch; then timed and traced under the
   evaluator's swap, where cuDNN runs no convolution but the skipped
   11-class head's. Card against CPU at 256x256 from one set of weights
   and scales, TF32 off: in bf16 the confusion matrices within 0.1% of
   the pixels and the bandwidth equal; in float32 within 1%, the bandwidth
   reported (``int8_card_vs_cpu`` says why). Phase 9's bench lines hold
   the int8 keys, and its int8 run's K4 launches. Then the same on trained
   weights: the flagship at 128x128 trained on the card for 400 iterations
   (batch 4, Adam 1e-4) over the informative fixture's frames, as
   scripts/prove_learning.py trains the JAX model, its ``activated`` mIoU,
   selection accuracy and bandwidth printed, and its int8 eval card
   against CPU on the train frames (``trained_int8_card_vs_cpu``): the
   pixels moved and the mean graph difference no larger than int8's own
   against float32 on the CPU, and a link decided differently only where
   int8 itself leaves it undecided.
11. Serving (``export.export_serving`` / ``load_serving``, ``serve``). The
   flagship from ``models.init_weights`` exported on the card at batch 8
   (the JAX export CLI's default), saved to bytes and loaded: in float32,
   in bf16 and in int8 (static scales calibrated on 2 seeded batches,
   weights baked). The loaded graph holds one K1 and one K2 op node, and
   in int8 two K4 op nodes per eligible conv and no ``aten.round`` /
   ``amax`` / ``abs`` node. Over 3 seeded batches, counts zeroed just
   before and read just after, K1 and K2 launch once a batch on the
   network's route and K4 48 times a batch; the class maps agree with the
   eager ``make_eval_fn`` / ``make_int8_eval_fn`` on at least 99.99% of
   the pixels (equal expected), the graphs within 1e-6 and the per-frame
   bandwidth equal. The weight-hotswap artifact (``bake_weights=False``)
   with two seeded weight sets, each against the eager eval of those
   weights. ``serve.serve_dataset`` over 19 in-memory frames (two batches
   and a tail of 3 padded by repetition): 19 x 6 maps written, the
   bandwidth the mean of the eager per-frame bandwidth over the 19 real
   frames. Then ms per batch by CUDA events of the artifact, the eager
   function and both in int8; the host time of each op through the
   dispatcher against its CUDA implementation called directly; and
   phase 10's int8 ``Evaluator`` path at batch 2 timed in turns through
   the ops and with the CUDA implementations called directly.
12. The rest of the model surface, each at its YAML's own size (512x512)
   through phase 7's ``run_zoo_config``: 2 eval batches a mode with K1's
   and K2's launches held exactly (K1 once a batch where the decoder has
   pre-upsample logits, never with ``n_segnet_decoder``; K2 once a batch
   in MIMOcom's ``activated`` / ``argmax_test`` on the full graph, never
   in ``topk`` or with one output), 3 train steps with finite losses,
   card against CPU at 256x256. configs/extensions/mrms_when2com_topk.yml
   in ``topk``, ``activated`` and ``argmax_test``, and its per-frame
   bandwidth (``per_frame_links``) averaging to ``num_connect``, at most
   ``topk_k`` links a query but where keys tie, and the YAML through the
   ``train``, ``test``, ``export_serving`` and ``serve`` CLIs on the card
   over the informative fixture at 512x512 (``topk_clis``); the flagship with the
   SegNet pair, ``FCN_decoder``, ``feat_squeezer`` 2 and 4,
   ``query: false`` and ``multiple_output: false``; srms_when2com with
   ``sparse: true`` (training through sparsemax's backward). K2 against
   its plain version at the squeezed value maps, (2, 6, 512, 8, 8) and
   (2, 6, 512, 4, 4) (``checks.check_comm_fusion_squeezed``). The SegNet
   model's int8 eval at 512x512 (K4 once per swapped conv call, its GEMM
   routes counted) and card against CPU at 256x256; K4 against its plain
   version and timed, as phase 10 times it, at every int8 conv geometry
   of the SegNet and squeezer models that the flagship does not have.
13. CUDA graphs and the trainer's keys (``graphs.py``). The flagship
   trains 24 iterations through ``Trainer.train`` with ``steps_per_call``
   4 (one CUDA graph of the train step, replayed), ``device_prefetch`` 2,
   ``nan_guard`` 2 with iteration 7's loss made non-finite, ``profile_dir``
   over iterations [8, 12) and the watchdog, then with K = 1 eager steps
   from the same weights: ms a step, peak memory, the guard's counters,
   the dropped replay, the trace. In deterministic mode, two chunks by
   graph replays equal K eager steps bit for bit (``graph_training``).
   Then the flagship's ``activated`` eval at batch 2
   through graphs and eagerly (``Evaluator(graphs=False)``) in float32,
   bf16 and int8: class maps, confusion matrices, actions and bandwidth
   equal bit for bit, K1, K2 and K4 counted exactly a batch under replay,
   3 alternated pairs of 16-batch windows (frames/s), one traced window
   each (busy share; K1, K2 and K4 inside the replays). Last, the
   capture-safe confusion matrix against its ``torch.bincount`` form.
14. The loader (``data/``, ``native.py``, ``bench_train_pipeline.py``).
   Prints whether cv2 imports and whether the native decoder builds (g++
   and libpng), and the host's CPU count. On a 512x512 ``generate_fixture``
   (6 agents, 16 train frames) the loader alone in frames decoded/s
   (``bench_train_pipeline.loader_rates``: cv2 through the thread
   ``DataLoader``, the native decoder, the cache cold and warm,
   ``GrainLoader`` with 4 worker processes), then
   ``bench_train_pipeline.main``'s variants A-F on the flagship geometry in
   bf16 at batch 2 (frames/s, ratio to A), and the flagship's ``activated``
   eval at batch 2 over that split read through the thread ``DataLoader``
   against the same batches in memory (``eval_pace``: which of the loader
   and the card sets the pace of a 512x512 ``test``). Then ``Trainer`` on the flagship
   at 128x128 (crops of 160x160 frames) with ``data_backend: grain``, 2
   worker processes, augmentations (hflip, rcrop, brightness),
   ``cache_decoded``, ``device_prefetch`` 2 and ``steps_per_call`` 2 (graph
   replays): 12 iterations in one run, then 6, ``latest`` saved, and a
   fresh ``Trainer`` resumed to 12; the batches the steps consume
   (position-weighted sums of images and labels, taken on the card from
   each chunk) must be equal, and the checkpoint must hold the consumed
   position mid-epoch (``stream_resume``). Last, the ``test`` CLI on the
   flagship YAML at 256x256 with ``noisy_type: occlusion`` and the cache,
   from one seeded ``.pkl``, on the card and on the CPU with TF32 off:
   class maps on at least 99.9% of pixels, bandwidth equal (and above 0),
   K1 and K2 launched exactly as ``_expected_launches`` says
   (``noisy_test_cli``).
15. Data parallel and the agent ring (``parallel/``), on this one card:
   two ``MAP_COORDINATOR`` ranks share it under gloo (each rank
   ``chip_smoke.py --phase15-rank``, its own timeout; a failing rank fails
   the phase). The flagship at full width from seeded weights (the graph's
   projection scaled by P15_SHARPEN so ``activated`` keeps links), in
   deterministic mode. (a) Training: ``shard_data_by_process``, each rank
   a process-sharded ``GrainLoader`` stream of batch 1, 3 ``Trainer.train``
   steps with validation and rank 0's checkpoint, against one process at
   batch 2 on the same frames: losses within relative 3e-2, the first
   step's gradients summed over the ranks within relative L2 3e-2 / cosine
   0.9995 per tensor (those 0 in exact arithmetic below 1e-4), parameters
   within 2 x 3 x lr, BatchNorm statistics after the first step within
   relative L2 3e-2 / cosine 0.9995; the updates after 3 steps against one
   process's are printed. (b) The ``activated`` eval over 2
   ranks with a tail batch (2, 2, 1) against one process: class maps on
   at least 99.99% of pixels, confusion matrices within what the moved
   pixels explain, bandwidth and selection equal, K1 and K2 per rank
   exactly as ``_expected_launches`` says. (c) A ring of 2 (3 agents a
   rank) in ``softmax``, ``argmax_test`` and ``activated`` against the
   dense eval: graphs within 1e-6, class maps 99.99%, actions and bandwidth
   equal. (d) ``agent_parallel_train``: one train step through the ring
   against the dense step, gradients within relative L2 3e-2 / cosine
   0.9995. (e) NCCL with a world of one (``init_distributed``, backend
   ``nccl``): 8 iterations in ``steps_per_call`` 4 chunks, each captured
   with its gradient all-reduce, equal bit for bit to the run with no
   layout. (f) ``phase15_info``: the bytes one train step moves through
   the host under gloo (data parallel, and the ring's
   ``agent_parallel_train`` step alone), ms a step for 2 ranks sharing the
   card and for one process
   (no speed claim), the card's name and power limit.
16. float16 (``model.dtype: float16``) at the flagship's full width. (a)
   K1's, K2's and K4's float16 routes (``upsample_argmax_f16``,
   ``comm_fusion_f16``, ``int8_conv_f16``) against their plain versions and
   timed as phases 1 and 10 time the other types (``checks``: K1's near-tie
   rule; K2's graphs within 1e-6, fused within one float16 ulp + 1e-5 of
   the plain version and of float64; K4's scratch and sums equal, its
   float16 output to the bit and within one float16 ulp of the plain float32
   rescale; K4's yardstick cuDNN's float16 convolution). (b) The
   ``activated`` eval as phase 2 runs it, at the YAML's batch 2 x 6 and at
   the bench's 20 x 6: K1 and K2 once a batch on the f16 route, as
   ``_expected_launches`` says, never on another, and finite logits. (c)
   Card against CPU in float16 at 256x256 (``mixed_card_vs_cpu``, phase 8's
   rule). (d) ``Trainer.train`` in float16 as phase 5 runs it (no loss
   scaling, as JAX): finite float32 losses and gradients, float32
   parameters that moved, the exactly-zero gradients counted; its
   checkpoint's eval launches K1 and K2. (e) The eval CUDA graph against
   eager in float16 (``graph_eval``, as phase 13 times bf16), bit for bit. (f) The
   float16 network's int8 eval (K4 on ``int8_conv_f16``, 48 a batch) and
   card against CPU at 256x256 (0.1% of the pixels, the bandwidth equal, as
   phase 10 holds bf16).
   (g) The float16 serving artifact and its int8 one (float16 output) at
   batch 8, each against the eager function (``serve_float16``).
17. int8 eval on the agent ring and the mesh's ``model`` axis on this one
   card, the flagship at full width from seeded weights (phase 15's
   P15_SHARPEN), in deterministic mode; two ``MAP_COORDINATOR`` ranks
   share the card under gloo (``chip_smoke.py --phase17-rank``, each rank
   its own timeout), as in phase 15. One process first runs the int8 eval
   (P17_CALIB_BATCHES calibration batches, P17_INT8_BATCHES eval batches).
   (a) A ring of 2 (3 agents a rank) calibrates its int8 scales over its
   ranks: each within relative 1e-4 of one process's; with one process's
   scales (phase 10's rule: two int8 evals, one set of scales) its class
   maps within phase 10's seeded 1% of one process's; K1, K2 and K4 per
   rank exactly as ``_expected_launches`` says (K2 never: the ring fuses
   with plain ops) and K4 48 a batch; the bandwidth printed. (b) A data 1
   x model 2 grid: K4 against its plain version at each output-channel
   shard's geometry the flagship's step does not have (``check_int8_conv``),
   3 ``Trainer.train`` steps at batch 2 against one process under phase
   15's rule (losses, the first step's gradients gathered over the shards),
   the ``activated`` eval (class maps 99.99%, bandwidth equal, K1 and K2
   per rank as expected) and the int8 eval as (a) holds it. (c)
   ``python -m multiagentperception_tpu_torch.dryrun_multichip --ranks 4
   --device cuda --img 128`` (4 ranks sharing the card) passes; its
   ``steps_per_call`` leg reports the trainer's refusal under gloo. (a),
   (b) and (c) run at once (each rank pair's rendezvous a file), so (b)'s
   ms a step is taken beside the others. (d)
   ``phase17_info``: the bytes one model-axis train step moves through the
   host, ms a step for the grid and one process (no speed claim), the
   card. Phase 17 takes no CUPTI trace: it runs last, when Kineto drops
   most records; the counters are exact. ``phase17_seconds`` times its
   parts.

18. MIMOcom beyond 16 agents: K2's wide design (``csrc/comm_fusion.cu``:
   a graph kernel on the float64 tensor cores in clusters along D, and a
   fusion kernel launched as its programmatic dependent; any N) and the
   agent-count sweep ``bench_agents``. (a) ``checks.check_comm_fusion_wide``
   at N = 17, 24, 32, 33, 48, 64 and 200 on the sweep's 256x256 value maps
   (512 x 8 x 8) and a ragged M of 1000, and at N = WIDE_BEYOND (1030) with
   D = 37 and M of 13 packs (the graph's logits kept in soft and coef, V
   streamed again per query tile), every type and mode (graphs within 1e-6
   of float64, masks equal with links kept and argmax ties to the lowest
   key, fused within rtol/atol 1e-5 in float32 and the 16-bit rule); two
   calls equal bit for bit (``check_comm_fusion_repeatable``) and a CUDA
   graph's replay on new inputs equal to eager
   (``check_comm_fusion_graph_replay``);
   ``check_comm_fusion_every_n`` at every N from 1 to 200 in every type,
   each call's design counted (``cluster`` up to 16 agents, ``wide``
   above); the wide records timed (float32 at (d)'s shape, 16-bit at the
   sweep's N = 48) beside ``bmm``/``softmax``, by CUPTI each of the two
   kernels alone (the fusion kernel launched after the graph kernel, by
   the library's ``comm_fusion_wide_overlap(0)``) and, overlapped as the
   wrapper launches them, the call's span (``wide_split``), their bound
   counting 16-bit products as three bf16 ones at 989 TF/s
   (``k2_ops_ms``); K1 at wide logits (``checks.check_upsample_argmax_wide``:
   C = 11 at w = 70 and 96, C = 32 at w = 32, 16 rows opted in beyond 48 KB;
   8, 4, 2 and 1 rows at w = 1815 (C = 2) and 1320, 2640, 5282 (C = 11); C
   = 64 at w = 1024, the direct kernel) in every type, and each of those
   routes timed in float32 beside its plain version, ``F.interpolate`` +
   ``argmax`` and its bound (``k1_wide_routes``; K1's record, ``wide_routes``). (b)
   ``bench_agents.sweep`` at its defaults (256x256, B*N = 96, N = 6, 12,
   24, 48, bf16) and at N = 24 in float16: per N, K1 and K2 once a step,
   K2 on ``cluster`` at 6 and 12 and ``wide`` at 24 and 48, finite logits;
   the table printed, no rate gated. (c) Card against CPU: MIMOcom at full
   width, N = 24 and 48 at 128x128, batch 1, float32 with TF32 off, one set
   of seeded weights (its graph peaked at these frames), ``activated`` and
   ``argmax_test``: actions and bandwidth equal, class maps on at least
   99.99% of pixels, a link kept; K2 on the card's own Q', K and V held to
   float64 (``checks.check_comm_fusion_against_float64``); the whole
   model's graph gaps from the CPU's float64 model printed (not gated: its
   logits reach ~250, and the CPU's own float32 graph lies ~2e-5 off). (d)
   ``bench.bench_eval`` at batch 2, 24 agents, 512x512, float32 (K2's wide
   design once a step): eval ms and K2's device ms a call on the path; then
   3 seeded batches through ``Evaluator`` with CUDA graphs (the third a
   replay) against eager, bit for bit, launches exact. Phase 18 runs right
   after phase 9, while traces still hold their records; ``phase18_seconds``
   times its parts.

19. The user runs of scripts/ (``bench_eval_pipeline``, ``prove_learning``,
   ``run_flagship_512``), last. (a) ``bench_eval_pipeline.main`` at batch
   2 and 16 x 6 at 512x512, float32 frames and raw uint8 ones normalized on
   the card: the flagship in bf16 from the seeded init, a warm pass, then
   the best of 3 passes at depth 0 (each batch read back before the next
   is dispatched) and at depth 2, through the eval step's CUDA graph; the
   confusion matrices, bandwidth and selection counts equal across depths,
   K1 and K2 once a batch on the bf16 route in every pass; frames/s
   printed. (b) ``prove_learning.main(tradeoff=True)`` at its defaults
   (the flagship at 128x128, 400 iterations at batch 4 over the informative
   fixture's train split through ``AirsimDataset``, ``DataLoader`` and
   ``Trainer.train``), the counts zeroed before each stage and read after:
   training (its validation in ``softmax`` at full resolution launches
   neither), the ``activated`` eval (K1 and K2 once a batch), the int8 eval
   (K4 48 times a batch, K1 once, K2 once and once on the calibration
   batch) and the tradeoff (K1 every batch of its 9 passes, K2 in
   ``argmax_test`` and ``activated``), all on the float32 route; 9 rows,
   the top-k bandwidth non-decreasing in k, every bandwidth within [0, 5]
   and mIoU within [0, 1], the four metrics finite. (c)
   ``python -m multiagentperception_tpu_torch.run_flagship_512`` at
   512x512 over a fixture of 4 frames a trajectory, in two legs, each in
   its own workdir: leg 1 to 200 iterations (validation and ``latest``
   every 100, ``steps_per_call`` 10, bf16, grain, the decoded cache), leg 2
   resumed from leg 1's ``latest`` to 300. Both exit 0; leg 1's
   ``report`` holds ``Time/Image`` readings, 2 validations with 2
   selection readings and a best checkpoint; each leg prints its
   post-train test with a bandwidth; leg 2's first printed iteration lies
   after 200. The legs start on a thread of their own before phase 15
   and run beside phases 15 and 17 (which take no trace and claim no
   speed); (a) and (b) run in this process after phase 17, then the legs
   are joined (``phase19_seconds``); the sustained frames/s of both legs,
   the host RSS and the device's peak at each validation are printed.

Phase 16 runs right after phase 8, its bf16 counterpart. Kineto files
some of a trace window's kernel records as outside its capture window
("Out-of-range" in its log), more the longer the process has run, and not
as many in every window: after ~1000 s a window of 50 back-to-back K1
launches may hold none. So a trace's launch counts are reported, and a
check asks only that a trace hold some record of a kernel (the launch
counters are held exactly); ``_traced_ms`` takes a window again while it
holds none. ``trace_drops`` prints, after phase 1, before phase 15
and after it, the records each of TRACE_TRIES windows of K1 lacked, and the
smoke fails unless a window after phase 15 holds a record.

``Evaluator.evaluate`` runs through CUDA graphs on the card by default,
so phases 2, 3, 5 (its validation), 7, 8 and 12 evaluate through graphs,
their launch counts held exactly under replay; phase 10's int8 slice and
phase 11's dispatcher A/B time the eager step (``graphs=False``) as they
did before, and training keeps ``steps_per_call: 1``, the eager step.

Prints each phase's seconds, the card's ``nvidia-smi`` name and power
limit, then the ``{"kernels": [...]}`` line (K1's record also holds its
launch counts on phase 7's paths; ``upsample_argmax_bf16`` and
``comm_fusion_bf16`` are the bf16 routes, with their launches on phase 8's
paths; each K1/K2 record also holds its launches and device time per
launch on the bench's eval path at batch 20, ``*_bench_b20``, and K1's,
K2's and ``int8_conv``'s their launches on phase 12's paths,
``phase12_launches`` (``int8_conv``: also ``phase12_shapes``, its times
at the new geometries); K4's two
records, ``int8_conv`` and ``int8_conv_bf16``, sum one eval step's 48
convolutions, with the quantize/GEMM split and ``library_int_mm_ms``;
K1's, K2's and ``int8_conv``'s records hold their launches on phase 11's
serving path of their type, ``serving_launches``, and a batch of phase 13's
eval under replay, ``graph_launches_per_batch`` and
``graph_traced_launches``; K1's and K2's float32 records their launches in
phase 14's noisy ``test``, ``phase14_launches``, and per rank in phase 15's
2-rank eval, ``phase15_launches``; ``upsample_argmax_f16``,
``comm_fusion_f16`` and ``int8_conv_f16`` are the float16 routes with their
launches on phase 16's paths; K1's, K2's and ``int8_conv``'s records hold
their launches per rank on phase 17's ring and grid, ``phase17_launches``,
and ``int8_conv`` its times at the shards' geometries, ``phase17_shapes``;
``comm_fusion_wide``, ``comm_fusion_wide_bf16`` and ``comm_fusion_wide_f16``
are K2's wide design by type, with their launches on phase 18's paths (d),
the bf16 sweep and the float16 sweep, and K1's records and
``comm_fusion_bf16`` their launches there, ``phase18_launches``;
``upsample_argmax_bf16`` and ``comm_fusion_bf16`` their launches a pass of
phase 19 (a), and ``upsample_argmax``, ``comm_fusion`` and ``int8_conv``
theirs in each stage of phase 19 (b), ``phase19_launches``),
and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import copy
import io
import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from multiagentperception_tpu_torch import bench, bench_agents
from multiagentperception_tpu_torch import bench_fused_block as k3_bench
from multiagentperception_tpu_torch.bench_kernels import K4_SHAPES
from multiagentperception_tpu_torch.bench_kernels import time_ms as _time_ms
from multiagentperception_tpu_torch.config import load_config
from multiagentperception_tpu_torch.evaluate import N_CLASSES, Evaluator
from multiagentperception_tpu_torch.loss import get_loss_function
from multiagentperception_tpu_torch.models import get_model, init_weights
from multiagentperception_tpu_torch.ops.kernels import _build, checks
from multiagentperception_tpu_torch.ops.kernels import comm_fusion as k2
from multiagentperception_tpu_torch.ops.kernels import fused_block as k3
from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4
from multiagentperception_tpu_torch.ops.kernels import upsample_argmax as k1
from multiagentperception_tpu_torch.ops.normalize import normalize_images
from multiagentperception_tpu_torch.parallel import tensor
from multiagentperception_tpu_torch.parallel.collectives import all_gather_cat
from multiagentperception_tpu_torch.quantize import Int8Convs, eligible_convs
from multiagentperception_tpu_torch.trainer import Trainer

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "configs" / "multi-request-multi-support" / "mrms_when2com.yml"
WORK = ROOT / "multiagentperception_tpu_torch" / "build" / "smoke"
PROFILE_OUT = WORK / "profile.txt"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s outside
# the tensor cores (K1's FMAs; K2's float32 products and logits; float64 on
# the tensor cores runs at the same 67 TF/s), bf16 on the tensor cores (K2's
# 16-bit fusion: three bf16 products a value)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
K2_SPLIT_TERMS = 3  # bf16 products a 16-bit value of fused takes for float32 accuracy

SEED = 0
EVAL_BATCHES = 10  # timed; two more warm up cuDNN and the caching allocator
TRAIN_WARMUP, TRAIN_STEPS = 2, 10  # train iterations: warm-up, then timed
PROFILE_STEPS = 5  # train steps in the traced window
TRACE_TRIES = 4  # windows ``_traced_ms`` may take to hold a record of its kernel
DIAG_BIAS = 0.001
THRES = 0.2


def _trace_window(fn, kernel: str, iters: int) -> list:
    """The device events of the kernel whose name holds ``kernel`` in one
    ``torch.profiler`` (CUPTI) window of ``iters`` back-to-back runs of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in _device_events(prof) if kernel in e.key]


def _traced_ms(fn, kernel: str, iters: int = 50) -> float:
    """Device time per launch of the kernel whose name holds ``kernel``
    over ``iters`` back-to-back runs of ``fn`` under ``torch.profiler``
    (CUPTI): the kernel alone, its inputs warm in L2, no launch gaps. Set
    beside its time on the eval path, it shows what the path adds. Kineto
    files some of a window's kernel records as outside its capture window,
    more the longer the process has run, and not as many in every window
    (``trace_drops``): a window that holds none of the kernel's records is
    taken again, at most TRACE_TRIES windows, and the time is over the
    records the window holds."""
    fn()
    for _ in range(TRACE_TRIES):
        hits = _trace_window(fn, kernel, iters)
        if hits:
            return sum(e.self_device_time_total for e in hits) / sum(e.count for e in hits) / 1e3
    raise AssertionError(f"{TRACE_TRIES} traces of {iters} launches of {kernel}: no record")


TRACE_PROBE_LAUNCHES = 50


def trace_drops(started: float) -> dict:
    """K1's TRACE_PROBE_LAUNCHES back-to-back launches traced in TRACE_TRIES
    windows, each taken whatever the one before held: the kernel records
    each window lacks, at the process's age (seconds since ``started``).
    Main runs it after phase 1, before phase 15 and after it, and requires
    a window after phase 15 that holds records, as ``_traced_ms`` does."""
    x = torch.randn(12, N_CLASSES, 16, 16, device="cuda")

    def run() -> None:
        k1.upsample_argmax(x, 512, 512)

    run()
    short = [TRACE_PROBE_LAUNCHES - sum(e.count for e in _trace_window(
        run, "upsample_argmax_kernel", TRACE_PROBE_LAUNCHES)) for _ in range(TRACE_TRIES)]
    return {"age_s": time.perf_counter() - started, "launches": TRACE_PROBE_LAUNCHES,
            "missing_per_window": short}


def _device_events(prof) -> list:
    """The trace's device work: kernels and copies, without the ranges that
    ``record_function`` annotations (such as ``Optimizer.step``) draw over
    them on the device timeline, which would count that time twice."""
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False)]


@contextlib.contextmanager
def _no_tf32():
    """Full float32 convolutions and matrix products, restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _bound(bytes_moved: float, flops: float, ops_ms: float | None = None) -> tuple[float, str]:
    """The larger of the bytes' time and the operations' (``flops`` at
    float32's rate, or ``ops_ms`` where the caller times them itself)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3 if ops_ms is None else ops_ms
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_ops_ms(b: int, n: int, d: int, m: int, dtype: torch.dtype) -> float:
    """K2's operations at the rate its type's products reach on the card:
    the logits (2 B N^2 D) at 67 TF/s; the fusion (2 B N^2 M) at 67 TF/s in
    float32, and in 16-bit as K2_SPLIT_TERMS bf16 products a value (float32
    accuracy from exact products) at bf16's 989 TF/s."""
    graph, fuse = 2 * b * n * n * d, 2 * b * n * n * m
    if dtype == torch.float32:
        return (graph + fuse) / F32_FLOP_PER_S * 1e3
    return (graph / F32_FLOP_PER_S + K2_SPLIT_TERMS * fuse / BF16_FLOP_PER_S) * 1e3


# ------------------------------------------------------------------ phase 1

def _route(dtype: torch.dtype | str | None) -> str:
    """A network dtype's route (the kernels' ``route_launches`` keys), by torch
    dtype or by ``model.dtype`` name (None: float32), from K1's route table."""
    if not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, dtype or "float32")
    return k1.ROUTES[dtype][0]


def _suffix(dtype: torch.dtype) -> str:
    """A 16-bit route's record name suffix; the float32 routes keep their names."""
    return "" if dtype == torch.float32 else "_" + _route(dtype)



def k1_times(x: torch.Tensor, out_h: int, out_w: int) -> dict:
    """K1 on logits ``x`` (on the card) timed beside its plain version and
    ``F.interpolate`` + ``argmax`` (a yardstick the port never calls), with
    its bound."""
    n, c, _, w = x.shape

    def library():
        return torch.nn.functional.interpolate(
            x, size=(out_h, out_w), mode="bilinear", align_corners=False).argmax(1)

    taps_bytes = (out_h + out_w) * 2 * 8  # row and column (idx, weight) tables
    bytes_moved = x.numel() * x.element_size() + taps_bytes + n * out_h * out_w * 4
    # vertical taps once per (row, source column, class), horizontal per pixel
    flops = 3 * n * c * (out_h * w + out_h * out_w)
    bound_ms, bound_by = _bound(bytes_moved, flops)
    return {"ms": _time_ms(lambda: k1.upsample_argmax(x, out_h, out_w)),
            "plain_ms": _time_ms(lambda: k1.upsample_argmax_plain(x, out_h, out_w)),
            "library_ms": _time_ms(library), "bound_ms": bound_ms, "bound_by": bound_by}


def check_upsample_argmax(gen, dtype: torch.dtype = torch.float32) -> dict:
    n, c, h, w, out = 12, 11, 16, 16, 512  # B*N decoder logits at 512x512
    x = torch.randn(n, c, h, w, generator=gen).to("cuda", dtype)
    checked = checks.check_upsample_argmax(x, out, out)
    times = k1_times(x, out, out)
    return {
        "name": "upsample_argmax" + _suffix(dtype), "route": "cuda",
        "source": "multiagentperception_tpu_torch/csrc/upsample_argmax.cu",
        "replaces": "multiagentperception_tpu/ops/pallas/upsample_argmax.py:56",
        **checked,
        "ms": times["ms"],
        "cupti_warm_ms": _traced_ms(lambda: k1.upsample_argmax(x, out, out),
                                    "upsample_argmax_kernel"),
        "plain_ms": times["plain_ms"], "library_ms": times["library_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "shape": f"({n}, {c}, {h}, {w}) {_route(dtype)} -> ({n}, {out}, {out}) int32",
    }


def check_comm_fusion(gen, dtype: torch.dtype = torch.float32) -> dict:
    b, n, d, c, h, w = 2, 6, 1024, 512, 16, 16  # flagship value maps, NCHW per agent
    q = torch.randn(b, n, d, generator=gen).to("cuda", dtype)
    # logits with a spread of about 2, so `activated` keeps off-diagonal links
    k = (torch.randn(b, n, d, generator=gen) * 2 / d ** 0.5).to("cuda", dtype)
    v = torch.randn(b, n, c, h, w, generator=gen).to("cuda", dtype)
    max_err = max(checks.check_comm_fusion(q, k, v, mode, DIAG_BIAS, THRES)
                  for mode in ("softmax", "activated", "argmax"))
    return comm_fusion_record("comm_fusion" + _suffix(dtype), q, k, v, max_err)


def comm_fusion_record(name: str, q, k, v, max_err: float, cupti: str = "comm_fusion_kernel"
                       ) -> dict:
    """K2's record at these inputs: the kernel, its plain version and the
    ``bmm``/``softmax`` yardstick timed in ``activated``, the byte and
    operation bounds; ``cupti``: the kernel's name for a CUPTI reading
    alone (None: none; the wide design launches two kernels a call)."""
    b, n, d = k.shape
    dtype = v.dtype
    flat = v.reshape(b, n, -1)
    bias = DIAG_BIAS * torch.eye(n, device="cuda")

    def library():
        soft = torch.softmax(torch.bmm(k, q.transpose(1, 2)).float(), dim=1) + bias
        coef = torch.where(soft > THRES, soft, torch.zeros_like(soft))
        return torch.bmm(coef.transpose(1, 2).to(dtype), flat)

    m = flat.shape[2]
    bytes_moved = ((q.numel() + k.numel() + 2 * v.numel()) * v.element_size()
                   + 2 * b * n * n * 4)  # coef and soft are float32
    bound_ms, bound_by = _bound(bytes_moved, 0, k2_ops_ms(b, n, d, m, dtype))
    run = lambda: k2.comm_fusion(q, k, v, mode="activated", diag_bias=DIAG_BIAS)  # noqa: E731
    plain = lambda: k2.comm_fusion_plain(q, k, v, mode="activated", diag_bias=DIAG_BIAS)  # noqa: E731
    rec = {
        "name": name, "route": "cuda",
        "source": "multiagentperception_tpu_torch/csrc/comm_fusion.cu",
        "replaces": "multiagentperception_tpu/ops/pallas/comm_fusion.py:73",
        "design": k2.plan(b, n, d, m, dtype), "max_abs_err": max_err,
        "ms": _time_ms(run),
        "plain_ms": _time_ms(plain),
        "library_ms": _time_ms(library),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": f"q', k ({b}, {n}, {d}); V {tuple(v.shape)} {_route(dtype)}, activated",
    }
    if cupti:
        rec["cupti_warm_ms"] = _traced_ms(run, cupti)
    else:  # the wide design: each of its two kernels alone, and the call's span
        rec.update(wide_split(run))
    return rec


def _kernel_events(fn, kernel: str, iters: int) -> list:
    """The device kernel events (start and end times) whose name holds
    ``kernel`` in one ``torch.profiler`` window of ``iters`` runs of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sorted((e for e in prof.events() if kernel in e.name
                   and e.device_type.name == "CUDA"), key=lambda e: e.time_range.start)


def wide_split(run, iters: int = 50) -> dict:
    """K2's wide design by CUPTI over ``iters`` back-to-back calls of
    ``run`` (medians, ms): each of its two kernels alone, the fusion kernel
    launched when the graph kernel has ended (``comm_fusion_wide_overlap(0)``,
    a switch of the library that only measurements turn), then, as the
    wrapper launches them, the call's span on the device (the graph kernel's
    start to the fusion kernel's end) and what the fusion kernel adds after
    the graph kernel has ended. A call is a graph kernel and the fusion
    kernel after it; calls whose records the trace lacks are skipped, and
    the window is taken again (at most TRACE_TRIES) while it pairs none."""
    lib = _build.load("comm_fusion")
    out = {}
    for overlap in (0, 1):
        lib.comm_fusion_wide_overlap(overlap)
        try:
            run()
            for _ in range(TRACE_TRIES):
                events = _kernel_events(run, "comm_fusion_wide", iters)
                pairs = [(g, f) for g, f in zip(events, events[1:])
                         if "wide_graph" in g.name and "wide_fuse" in f.name]
                if pairs:
                    break
            else:
                raise AssertionError(f"{TRACE_TRIES} traces of K2's wide design: no call")
        finally:
            lib.comm_fusion_wide_overlap(1)
        med = lambda xs: float(np.median(xs)) / 1e3  # noqa: E731  (us -> ms)
        if overlap:
            out["cupti_warm_span_ms"] = med([f.time_range.end - g.time_range.start
                                             for g, f in pairs])
            out["cupti_warm_fuse_after_graph_ms"] = med([f.time_range.end - g.time_range.end
                                                         for g, f in pairs])
        else:
            out["cupti_warm_ms_by_kernel"] = {
                "comm_fusion_wide_graph": med([g.time_range.elapsed_us() for g, _ in pairs]),
                "comm_fusion_wide_fuse": med([f.time_range.elapsed_us() for _, f in pairs])}
        out["cupti_calls_paired"] = out.get("cupti_calls_paired", []) + [len(pairs)]
    return out


K3_GEOMETRIES = (  # (name, B*N, H=W, C, dtype): the flagship's stride-1 blocks at the
    # eval's B*N in f32 and the bench's in bf16
    ("eval_layer1", 12, 128, 64, torch.float32), ("eval_layer2", 12, 64, 128, torch.float32),
    ("bench_layer1", 120, 128, 64, torch.bfloat16), ("bench_layer2", 120, 64, 128, torch.bfloat16),
    ("eval_layer3", 12, 32, 256, torch.float32), ("eval_layer4", 12, 16, 512, torch.float32),
    ("bench_layer3", 120, 32, 256, torch.bfloat16), ("bench_layer4", 120, 16, 512, torch.bfloat16))
# each route's record: its source, and the geometry whose numbers head it (the
# first call of its path in phase 4)
K3_ROUTES = {"wgmma": ("fused_basic_block", "csrc/fused_block_wgmma.cu", "bench_layer1"),
             "tf32x3": ("fused_basic_block_tf32x3", "csrc/fused_block_tf32.cu", "eval_layer1"),
             "wgmma_conv": ("fused_basic_block_wgmma_conv", "csrc/fused_block_wgmma_conv.cu",
                            "bench_layer3"),
             "tf32x3_conv": ("fused_basic_block_tf32x3_conv", "csrc/fused_block_tf32_conv.cu",
                             "eval_layer3")}
# seeds besides a bfloat16 C >= 256 geometry's own, for the far-bound rule:
# those at which the CUDA-core kernel that these routes replaced lay beyond
# the far bound from the plain version (PERF.md section 6)
K3_WIDE_SEEDS = (0, 6)
# K4 runs wgmma on s8 (IGMMA) fed by TMA (UTMALDG)
K4_SASS = [("int8_conv", "IGMMA"), ("int8_conv", "UTMALDG")]
TENSOR_CORE_LIBS = ("fused_block_wgmma", "fused_block_tf32", "fused_block_wgmma_conv",
                    "fused_block_tf32_conv")
ALL_LAYERS = ["--layers", "layer1,layer2,layer3,layer4"]
# phase 4's bench runs: (routes, bench_fused_block arguments)
K3_PATHS = ((("wgmma", "wgmma_conv"), ALL_LAYERS),
            (("tf32x3", "tf32x3_conv"), ["--dtype", "float32", "--batch", "12", *ALL_LAYERS]))


def check_fused_block() -> list[dict]:
    rows = []
    for i, (name, b, hw, c, dtype) in enumerate(K3_GEOMETRIES):
        x, params = k3_bench.block_inputs(b, hw, hw, c, dtype, "cuda", seed=SEED + i)
        checked = checks.check_fused_block(x, *params)
        if "beyond_far_from_float64" in checked:  # bfloat16 at C >= 256: more seeds
            results = [checked]
            for seed in sorted(set(K3_WIDE_SEEDS) - {SEED + i}):
                xs, ps = k3_bench.block_inputs(b, hw, hw, c, dtype, "cuda", seed=seed)
                results.append(checks.check_fused_block(xs, *ps))
            checked = {**checked, "seeds": sorted({SEED + i, *K3_WIDE_SEEDS}),
                       "beyond_far_from_float64": checks.assert_far_no_worse(results),
                       "beyond_near_share_max": max(r["beyond_near_share"] for r in results)}
        bound_ms, bound_by = k3_bench.bound_ms(x)
        ms = _time_ms(lambda: k3.fused_basic_block(x, *params), iters=20)
        row = {"geometry": name, "shape": list(x.shape), "dtype": str(dtype).split(".")[-1],
               "route": k3.route(dtype, c), **checked, "ms": ms,
               "tflops": k3_bench.block_ops(x) / ms / 1e9,
               "plain_ms": _time_ms(lambda: k3.fused_basic_block_plain(x, *params), iters=20),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "plain_tf32": torch.backends.cudnn.allow_tf32}
        with _no_tf32():  # K3's own precision
            row["library_ms"] = _time_ms(lambda: k3_bench.cudnn_block(x, *params), iters=20)
        if dtype == torch.float32:  # PyTorch's default for float32 convolutions
            saved = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = True
            try:
                row["library_tf32_ms"] = _time_ms(lambda: k3_bench.cudnn_block(x, *params),
                                                  iters=20)
            finally:
                torch.backends.cudnn.allow_tf32 = saved
        row["vs_library"] = row["library_ms"] / ms
        rows.append(row)
        del x, params
    records = []
    for route, (name, source, head) in K3_ROUTES.items():
        main = next(r for r in rows if r["geometry"] == head)
        records.append({
            "name": name, "route": "cuda", "k3_route": route,
            "source": f"multiagentperception_tpu_torch/{source}",
            "replaces": "multiagentperception_tpu/ops/pallas/fused_block.py:201",
            **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                    "bound_by")},
            "shape": f"{main['shape']} {main['dtype']} ({head})",
            "geometries": [r for r in rows if r["route"] == route]})
    return records


K3_F64_SHAPES = ((1, 37, 45, 128), (1, 37, 45, 64))
K3_F64_SEEDS = 16
# images smaller than one tile (16x16 at C=64, 8x16 at C=128), where the
# wgmma route's (1, 5, 7, 128) count stood unsettled: more seeds, and where
# the elements beyond the bound lie
K3_F64_SMALL = tuple((1, h, w, c) for h, w in ((3, 3), (5, 7), (7, 13)) for c in (64, 128))
K3_F64_SMALL_SEEDS = 64


def _border(shape) -> torch.Tensor:
    """(1, H, W, 1) mask of the image's first and last rows and columns."""
    _, h, w, _ = shape
    mask = torch.zeros(1, h, w, 1, dtype=torch.bool, device="cuda")
    mask[:, 0], mask[:, -1], mask[:, :, 0], mask[:, :, -1] = True, True, True, True
    return mask


@_no_tf32()
def k3_against_float64() -> list[dict]:
    """K3's C = 64/128 routes (wgmma in bfloat16, tf32x3 in float32) and
    their plain versions, each against the block in float64: K3_F64_SEEDS
    seeds at the ragged shapes, K3_F64_SMALL_SEEDS at the images smaller
    than a tile. Per side: the elements beyond the dtype's check bound
    against float64 (bf16: its near bound, 1 ulp + 1e-3; float32: rtol/atol
    1e-4), split into the image's border rows and columns and its interior,
    the largest and the mean error. Reported, not checked: checks.py
    decides pass or fail."""
    near_ulps, near_atol = checks.K3_BF16_NEAR
    tol = checks.K3_F32_TOL
    rows = []
    shapes = [(sh, K3_F64_SEEDS) for sh in K3_F64_SHAPES] + \
        [(sh, K3_F64_SMALL_SEEDS) for sh in K3_F64_SMALL]
    for dtype in (torch.bfloat16, torch.float32):
        for shape, seeds in shapes:
            border = _border(shape)
            acc = {side: {"beyond_near": 0, "beyond_border": 0, "beyond_interior": 0,
                          "max_err": 0.0, "mean_err": 0.0}
                   for side in ("kernel", "plain")}
            for seed in range(seeds):
                x, params = k3_bench.block_inputs(*shape, dtype, "cuda", seed=seed)
                ref = checks.block_float64(x, *params)
                if dtype == torch.bfloat16:
                    near = near_ulps * checks.bf16_ulp(ref) + near_atol
                else:
                    near = tol * ref.abs() + tol
                for side, fn in (("kernel", k3.fused_basic_block),
                                 ("plain", k3.fused_basic_block_plain)):
                    err = (fn(x, *params).double() - ref).abs()
                    beyond = err > near
                    on_border = int((beyond & border).sum())
                    acc[side]["beyond_near"] += int(beyond.sum())
                    acc[side]["beyond_border"] += on_border
                    acc[side]["beyond_interior"] += int(beyond.sum()) - on_border
                    acc[side]["max_err"] = max(acc[side]["max_err"], err.max().item())
                    acc[side]["mean_err"] += err.mean().item() / seeds
            h, w = shape[1:3]
            rows.append({"route": k3.route(dtype, shape[-1]), "shape": list(shape),
                         "seeds": seeds,
                         "border_share": (2 * (h + w) - 4) / (h * w) if min(h, w) > 1 else 1.0,
                         **acc})
    return rows


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")


def sass_count(name: str, opcode: str) -> int:
    """``opcode`` instructions (HGMMA, IGMMA: wgmma; UTMALDG: a TMA load) in
    the SASS of the built kernel ``name``."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(_build._target(name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    return sum(opcode in line for line in sass.splitlines())


def resource_lines(log: str) -> list[str]:
    """``-Xptxas -v``'s register and spill lines and ptxas's warnings (such
    as a wgmma it had to serialize), each with its kernel."""
    out, kernel = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif "spill" in line or "Used" in line or "arning" in line:
            out.append(f"{kernel[-70:]}: {line.strip()}")
    return out


# ------------------------------------------------------------------ phase 2

def seeded_batches(count, b, n, size, seed, kind="mimo"):
    """Batches as the AirSim loader yields them: normalized float32
    (B, N, H, W, 3) images, int32 (B, N, H, W) labels with some ignore-index
    pixels, and the ``commun_label`` of ``kind``: mimo (B, 2, N) noise
    flags and links, when2com (B,) in [-1, N-2], or none ("None")."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        raw = rng.integers(0, 256, (b, n, size, size, 3), dtype=np.uint8)
        images = normalize_images(torch.from_numpy(raw)).numpy()
        labels = rng.integers(0, 11, (b, n, size, size)).astype(np.int32)
        labels[rng.random(labels.shape) < 0.01] = 250
        if kind == "mimo":
            noise = rng.integers(0, 2, (b, n))
            link = rng.integers(0, n, (b, n))
            out.append((images, labels, np.stack([noise, link], axis=1).astype(np.int64)))
        elif kind == "when2com":
            out.append((images, labels, rng.integers(-1, n - 1, (b,)).astype(np.int64)))
        else:
            out.append((images, labels))
    return out


def run_slice(kernels, dtype: str | None = None, batch: int | None = None,
              timed: int = EVAL_BATCHES) -> dict:
    """The flagship's ``activated`` eval through ``Evaluator``: ``timed``
    batches after 2 warm-up batches, then the same batches traced. ``dtype``
    sets ``model.dtype`` (phase 8: ``bfloat16``, phase 16: ``float16``),
    ``batch`` the batch size (default the YAML's). Each kernel must launch
    on the route of the model's type once per timed batch (K2: the bf16
    route in bf16), as ``_expected_launches`` says, and never on another."""
    cfg = load_config(str(FLAGSHIP))
    if dtype is not None:
        cfg["model"]["dtype"] = dtype
    if batch is not None:
        cfg["training"]["batch_size"] = batch
    b, n, size = cfg["training"]["batch_size"], cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    route = _route(dtype)
    model = init_weights(get_model(cfg, N_CLASSES), SEED)
    WORK.mkdir(parents=True, exist_ok=True)
    pkl = WORK / "mrms_when2com_seed0.pkl"
    torch.save({"epoch": 0, "model_state": model.state_dict(), "best_iou": 0.0}, pkl)
    del model

    ev = Evaluator(cfg)  # the card: the default device
    ev.load_weight(str(pkl))
    batches = seeded_batches(timed + 2, b, n, size, SEED)
    ev.evaluate(batches[:2])  # warm-up

    for kern in kernels:
        kern.launches = 0
        kern.route_launches.update(dict.fromkeys(kern.route_launches, 0))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score, class_iou = ev.evaluate(batches[2:])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated()
    launches = {kern.__name__: kern.launches for kern in kernels}
    routes = {kern.__name__: dict(kern.route_launches) for kern in kernels}
    for name, counts in routes.items():
        if counts != {**dict.fromkeys(counts, 0), route: timed}:
            raise AssertionError(f"{name} did not launch its {route} route once per "
                                 f"batch ({timed} batches): {counts}")
    if launches != _expected_launches(ev, "activated", timed):
        raise AssertionError(f"eval launches {launches}, want "
                             f"{_expected_launches(ev, 'activated', timed)}")
    if not bool(torch.isfinite(_pre_logits(ev, batches[2][0], "activated")[0]).all()):
        raise AssertionError(f"{dtype or 'float32'} eval: non-finite logits")

    metrics = ev.last_eval_metrics
    labels = np.stack([bt[1] for bt in batches[2:]])
    valid = int(((labels >= 0) & (labels < N_CLASSES)).sum())
    if int(metrics.confusion_matrix.sum()) != valid:
        raise AssertionError("confusion matrix does not count every labelled pixel")
    bandwidth = metrics.get_avg_bandW()
    if not 0.0 <= bandwidth <= n - 1:
        raise AssertionError(f"bandwidth {bandwidth} outside [0, {n - 1}]")
    if not all(np.isfinite(float(x)) for x in list(score.values()) + list(class_iou.values())):
        raise AssertionError("non-finite eval scores")

    frames = timed * b * n
    result = {"config": FLAGSHIP.relative_to(ROOT).as_posix(), "inference": "activated",
              "dtype": dtype or "float32", "batch": b, "agents": n, "size": size,
              "batches": timed, "eval_frames_per_s": frames / seconds,
              "batch_ms": seconds / timed * 1e3, "bandwidth": bandwidth,
              "when2com_acc": metrics.get_selection_accuracy()[0],
              "who2com_acc": metrics.get_selection_accuracy()[1],
              "peak_device_bytes": peak_bytes, "launches": launches,
              "route_launches": routes}
    result.update(profile_window(ev, batches[2:], seconds, kernels,
                                 WORK / f"profile_{result['dtype']}_b{b}.txt"))
    if dtype is None and batch is None:  # phase 2: the copy, pageable against pinned
        result["htod_pageable_vs_pinned"] = htod_pageable_vs_pinned(ev, batches[2:])
    return result


def profile_window(ev, batches, wall_s: float, kernels, out: Path = PROFILE_OUT) -> dict:
    """Trace the timed window's batches again. The device is busy for the
    traced device time (one stream: kernels and copies do not overlap) over
    ``wall_s``, the untraced window's wall time; the tracer's own cost shows
    in the traced wall time. Each kernel's traced device time per launch
    on the path (``<wrapper>_kernel`` in csrc) is free of host gaps, unlike
    an event-timed launch. The full table goes to ``out``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev.evaluate(batches)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    events = _device_events(prof)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    out.write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    per_batch = len(batches)
    path_ms = {kern.__name__: bench.device_ms_per_call(events, kern) for kern in kernels}
    htod_ms = sum(e.self_device_time_total for e in events if "Memcpy HtoD" in e.key) / 1e3
    return {"device_ms_per_batch": device_ms / per_batch,
            "htod_device_ms_per_batch": htod_ms / per_batch,
            "path_kernel_device_ms": path_ms,
            "device_busy_share": device_ms / (wall_s * 1e3),
            "traced_batch_wall_ms": traced_s * 1e3 / per_batch,
            "tracer_wall_inflation": traced_s / wall_s,
            "top_device_kernels_ms_per_batch": {
                e.key[:60]: e.self_device_time_total / 1e3 / per_batch for e in top}}


def htod_pageable_vs_pinned(ev, batches) -> dict:
    """Phase 2's frames and labels copied to the card alone, traced under
    ``torch.profiler``, two ways: from pageable memory (a plain
    ``.to(device)``) and as ``Evaluator._put`` copies them (pinned, without
    blocking). Per batch: the ``Memcpy HtoD`` device time and the host's
    wall time to the last copy's end."""
    from torch.profiler import ProfilerActivity, profile

    ways = {"pageable": lambda a: torch.as_tensor(np.asarray(a)).to("cuda"),
            "pinned": ev._put}
    out = {}
    for name, put in ways.items():
        put(ev._model_inputs(batches[0][0]))  # warm-up: the pinned allocator's blocks
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for bt in batches:
                put(ev._model_inputs(bt[0]))
                put(ev._labels(bt[1]))
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        ms = sum(e.self_device_time_total for e in _device_events(prof)
                 if "Memcpy HtoD" in e.key) / 1e3
        out[name] = {"htod_device_ms_per_batch": ms / len(batches),
                     "host_wall_ms_per_batch": wall_s * 1e3 / len(batches)}
    return out


# ------------------------------------------------------------------ phase 3

def _config(yml: Path, model_keys: dict | None = None) -> dict:
    """The YAML's config with ``model_keys`` over its model section."""
    cfg = load_config(str(yml))
    cfg["model"].update(model_keys or {})
    return cfg


@_no_tf32()
def card_vs_cpu(yml: Path = FLAGSHIP, size: int = 256, model_keys: dict | None = None) -> dict:
    """The YAML (with ``model_keys`` over its model section) at ``size`` with
    TF32 off, one set of weights, one batch and one seed (so the selection
    baselines draw the same partners), in its default eval mode: actions
    and bandwidth equal (LearnWhen2Com's ``activated`` action is its
    thresholded row: the same links, weights within 1e-5), class maps agree
    on at least 99.9% of pixels."""
    cfg = _config(yml, model_keys)
    cfg["data"]["img_rows"] = cfg["data"]["img_cols"] = size
    b, n = cfg["training"]["batch_size"], cfg["model"]["agent_num"]
    state = init_weights(get_model(cfg, N_CLASSES), SEED + 1).state_dict()
    images = seeded_batches(1, b, n, size, SEED + 1, "None")[0][0]
    out = {}
    for dev in ("cuda", "cpu"):
        ev = Evaluator(cfg, device=dev)
        ev.model.load_state_dict(state, strict=True)
        out[dev] = [None if t is None else t.cpu() for t in ev.predict(images)]
    (g_cls, g_act, g_nc), (c_cls, c_act, c_nc) = out["cuda"], out["cpu"]
    if (g_act is None) != (c_act is None) or (g_nc is None) != (c_nc is None):
        raise AssertionError(f"{yml.name}: card and CPU return other outputs")
    if g_act is not None:
        same = torch.equal(g_act, c_act) if not g_act.is_floating_point() else (
            torch.equal(g_act != 0, c_act != 0) and torch.allclose(g_act, c_act, 0, 1e-5))
        if not same:
            raise AssertionError(f"{yml.name}: card and CPU choose other links: "
                                 f"{g_act.tolist()} vs {c_act.tolist()}")
    if g_nc is not None and float(g_nc) != float(c_nc):
        raise AssertionError(f"{yml.name}: bandwidth card {float(g_nc)} cpu {float(c_nc)}")
    agree = (g_cls == c_cls).float().mean().item()
    if agree < 0.999:
        raise AssertionError(f"{yml.name}: card and CPU class maps agree on only {agree:.6f}")
    return {"size": size, "pixel_agreement": agree,
            "num_connect": None if g_nc is None else float(g_nc), "tf32": False}


# ------------------------------------------------------------------ phase 4

def run_bench_path() -> dict:
    """K3's path: the bench's main once for each pair of routes (K3_PATHS)."""
    runs = {}
    for routes, argv in K3_PATHS:
        for r in k3.ROUTES:
            k3.fused_basic_block.route_launches[r] = 0
        records = k3_bench.main(argv)
        launches = dict(k3.fused_basic_block.route_launches)
        for route in routes:
            if launches[route] < 1:
                raise AssertionError(f"bench_fused_block {argv} never launched K3's {route} "
                                     f"route: {launches}")
            runs[route] = {"argv": argv, "launches": launches[route],
                           "records": [r for r in records if r["route"] == route]}
    return runs


# ------------------------------------------------------------------ phase 5

def _recording_loss(cfg):
    """The config's loss, and the list it appends each train step's loss to
    (not validation's: those run without gradients)."""
    loss_fn, recorded = get_loss_function(cfg), []

    def recording_loss(**kw):
        loss = loss_fn(**kw)
        if torch.is_grad_enabled():
            recorded.append(loss.detach())
        return loss

    return recording_loss, recorded


def run_training(eval_kernels, mixed_precision: bool = False, dtype: str | None = None,
                 profile: bool = True) -> dict:
    """The flagship trains TRAIN_WARMUP + TRAIN_STEPS iterations through
    ``Trainer.train`` (phase 8: with ``training.mixed_precision``; phase 16:
    ``model.dtype`` ``dtype``): finite float32 losses, float32 parameters,
    some of them moved, a checkpoint of float32 tensors; the last step's
    gradients float32 and finite (the exactly-zero ones counted: a 16-bit
    gradient that underflows, with no loss scaling, as JAX's). With
    ``profile``, a traced window of steps. Its best checkpoint is then
    evaluated in ``activated`` mode, which runs K1 and K2."""
    cfg = load_config(str(FLAGSHIP))
    total = TRAIN_WARMUP + TRAIN_STEPS
    cfg["training"].update(train_iters=total, val_interval=total, print_interval=1,
                           mixed_precision=mixed_precision)
    if dtype is not None:
        cfg["model"]["dtype"] = dtype
    tag = "_bf16" if mixed_precision else "" if dtype is None else "_" + _route(dtype)
    b, n, size = cfg["training"]["batch_size"], cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    train_batches = seeded_batches(total, b, n, size, SEED + 2)
    val_batches = seeded_batches(2, b, n, size, SEED + 3)
    recording_loss, recorded = _recording_loss(cfg)
    trainer = Trainer(cfg, logging.getLogger("chip_smoke"), recording_loss, train_batches,
                      val_batches, device="cuda", logdir=str(WORK / f"train{tag}"))
    init_weights(trainer.model, SEED)
    start = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    best = trainer.train()
    peak_bytes = torch.cuda.max_memory_allocated()
    if best is None:
        raise AssertionError("training saved no best checkpoint")
    losses = [float(v) for v in recorded]
    if len(losses) != total or not all(np.isfinite(losses)) or \
            any(v.dtype != torch.float32 for v in recorded):
        raise AssertionError(f"train losses {losses}")
    if any(v.dtype != torch.float32 for v in trainer.model.state_dict().values()
           if v.is_floating_point()):
        raise AssertionError("a parameter or BatchNorm statistic left float32")
    grads = [p.grad for p in trainer.model.parameters() if p.grad is not None]
    if not grads or any(g.dtype != torch.float32 or not bool(torch.isfinite(g).all())
                        for g in grads):
        raise AssertionError("the last step's gradients are missing, not float32 or not finite")
    zero_grads = sum(not bool(g.any()) for g in grads)
    if zero_grads == len(grads):
        raise AssertionError("every gradient of the last step is zero")
    saved = torch.load(best, map_location="cpu", weights_only=True)
    moved = sum(not torch.equal(saved["model_state"][k], v) for k, v in start.items()
                if v.is_floating_point())
    if moved == 0 or any(saved["model_state"][k].dtype != v.dtype for k, v in start.items()):
        raise AssertionError(f"training: {moved} tensors moved; the checkpoint's dtypes "
                             f"{sorted({str(v.dtype) for v in saved['model_state'].values()})}")

    timed = trainer.iter_seconds[TRAIN_WARMUP:]
    result = {"config": FLAGSHIP.relative_to(ROOT).as_posix(),
              "mixed_precision": mixed_precision, "dtype": dtype or "float32",
              "gradients": len(grads), "zero_gradients": zero_grads,
              "zero_gradient_elements": sum(int((g == 0).sum()) for g in grads),
              "gradient_elements": sum(g.numel() for g in grads), "batch": b, "agents": n,
              "size": size, "iterations": total, "timed_iterations": len(timed),
              "train_frames_per_s": len(timed) * b * n / sum(timed),
              "ms_per_step": float(np.mean(timed)) * 1e3,
              "ms_per_step_median": float(np.median(timed)) * 1e3,
              "losses": losses, "val_loss": trainer._val_loss_avg,
              "peak_device_bytes": peak_bytes, "tensors_changed": moved,
              "cudnn_tf32": torch.backends.cudnn.allow_tf32,
              "best_checkpoint_iter": int(saved["epoch"])}
    if profile:
        result.update(profile_train_window(trainer, train_batches[:PROFILE_STEPS],
                                           WORK / f"train_profile{tag}.txt"))

    ev = Evaluator(cfg)
    ev.load_weight(best)
    for kern in eval_kernels:
        kern.launches = 0
    ev.evaluate(val_batches)
    result["eval_launches"] = {kern.__name__: kern.launches for kern in eval_kernels}
    if min(result["eval_launches"].values()) < 1:
        raise AssertionError(f"the trained checkpoint's eval skipped a kernel: "
                             f"{result['eval_launches']}")
    result["eval_bandwidth"] = ev.last_eval_metrics.get_avg_bandW()
    return result


def profile_train_window(trainer, batches, out: Path) -> dict:
    """Train steps (host batch to update) untraced, then the same steps under
    ``torch.profiler``: the busy share is the traced device time over the
    untraced wall time, as phase 2 takes it."""
    from torch.profiler import ProfilerActivity, profile

    def steps():
        for bt in batches:
            trainer.train_step(*trainer._batch(bt[0], bt[1]))
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps()
        traced_s = time.perf_counter() - t0
    events = _device_events(prof)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    out.write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    per = len(batches)
    return {"window_ms_per_step": wall_s * 1e3 / per,
            "device_ms_per_step": device_ms / per,
            "device_busy_share": device_ms / (wall_s * 1e3),
            "tracer_wall_inflation": traced_s / wall_s,
            "top_device_kernels_ms_per_step": {
                e.key[:60]: e.self_device_time_total / 1e3 / per for e in top}}


# ------------------------------------------------------------------ phase 6

def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / (b.norm() + 1e-30))


@_no_tf32()
def train_card_vs_cpu() -> dict:
    cfg = load_config(str(FLAGSHIP))
    cfg["data"]["img_rows"] = cfg["data"]["img_cols"] = 256
    b, n = cfg["training"]["batch_size"], cfg["model"]["agent_num"]
    lr = cfg["training"]["optimizer"]["lr"]
    state = init_weights(get_model(cfg, N_CLASSES), SEED + 4).state_dict()
    images, labels, _ = seeded_batches(1, b, n, 256, SEED + 4)[0]
    out = {}
    for dev in ("cuda", "cpu", "cpu64"):
        tr = Trainer(cfg, None, get_loss_function(cfg), None, None,
                     device="cuda" if dev == "cuda" else "cpu")
        tr.model.load_state_dict(state, strict=True)
        x, y = tr._batch(images, labels)
        if dev == "cpu64":  # the float64 gradient of the same step, no update
            tr.model = copy.deepcopy(tr.model).double()
            tr.train_mode()
            tr.loss_fn(input=tr.model(x.double(), inference="softmax")[0], target=y).backward()
            out[dev] = {"grads": {k: p.grad for k, p in tr.model.named_parameters()}}
            continue
        loss = float(tr.train_step(x, y))
        sd = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
        out[dev] = {"loss": loss, "state": sd,
                    "grads": {k: p.grad.detach().cpu() for k, p in tr.model.named_parameters()}}
    card, cpu, f64 = out["cuda"], out["cpu"], out["cpu64"]["grads"]
    if not np.isclose(card["loss"], cpu["loss"], rtol=1e-4, atol=0):
        raise AssertionError(f"loss card {card['loss']} cpu {cpu['loss']}")
    zero = {"key_net.fc.4.bias"} | {k for k in f64 if k.endswith("cbr_unit.0.bias")}
    worst, worst_f64, within = 0.0, {"cuda": 0.0, "cpu": 0.0}, 0
    for k, g in card["grads"].items():
        gc = cpu["grads"][k]
        if k in zero:
            if max(g.norm(), gc.norm()) >= 1e-4:
                raise AssertionError(f"{k}: gradient of an invariant not ~0")
            continue
        err = _rel(g, gc)
        cos = float(torch.nn.functional.cosine_similarity(
            g.double().flatten(), gc.double().flatten(), dim=0))
        if err > 3e-2 or cos < 0.9995:
            raise AssertionError(f"{k}: card vs cpu relative L2 {err:.2e}, cosine {cos:.6f}")
        worst, within = max(worst, err), within + (err <= 1e-3)
        for dev, gd in (("cuda", g), ("cpu", gc)):
            worst_f64[dev] = max(worst_f64[dev], _rel(gd, f64[k]))
    for k, v in card["state"].items():
        want = cpu["state"][k]
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v, want, rtol=1e-4, atol=1e-5, msg=k)
        elif v.is_floating_point():
            torch.testing.assert_close(v, want, rtol=1e-4, atol=2 * lr, msg=k)
    return {"size": 256, "tf32": False, "loss_card": card["loss"], "loss_cpu": cpu["loss"],
            "grad_tensors": len(card["grads"]) - len(zero), "grads_within_1e-3": within,
            "worst_grad_rel_l2": worst, "worst_rel_l2_to_cpu_float64": worst_f64}


# ------------------------------------------------------------------ phase 7

ZOO = tuple(sorted(p for d in ("multi-request-multi-support", "single-request-multiple-support")
                   for p in (ROOT / "configs" / d).glob("*.yml") if p.name != FLAGSHIP.name))
ZOO_EVAL_BATCHES = 2
ZOO_TRAIN_STEPS = 3
# every inference mode of an architecture, its eval default first
ZOO_MODES = {"MIMOcomWho": ("activated", "softmax", "argmax_test"),
             "LearnWhen2Com": ("activated", "softmax", "argmax_test"),
             "LearnWho2Com": ("argmax_test", "softmax")}


def _expected_launches(trainer, mode: str | None, batches: int) -> dict:
    """K1's and K2's launches over ``batches`` eval batches in ``mode``: K1
    once a batch where the decoder has pre-upsample logits (none with
    ``n_segnet_decoder``), K2 once a batch for MIMOcom's ``activated`` and
    ``argmax_test`` on the full N x N graph (not on ``topk``, not with one
    output, and not on the agent ring, which fuses with its own plain ops),
    else never."""
    mode = mode or trainer.eval_default
    rings = getattr(trainer.model, "rings", None)
    k2_on = (trainer.arch == "MIMOcom" and trainer.model.mo_flag
             and mode in ("activated", "argmax_test") and not (rings and rings(mode)))
    return {"upsample_argmax": batches if trainer.model.decoder.has_pre_logits else 0,
            "comm_fusion": batches if k2_on else 0}


def run_zoo_config(yml: Path, name: str | None = None, model_keys: dict | None = None,
                   modes: tuple | None = None) -> dict:
    """One YAML at its own size, with ``model_keys`` over its model section
    (``name`` names the run): a seeded model saved as a reference-format
    ``.pkl`` and loaded through ``load_weight``, evaluated over
    ZOO_EVAL_BATCHES batches in each inference mode (``modes``, default
    every mode of the architecture), K1's and K2's launches counted in each
    (``_expected_launches``), then ZOO_TRAIN_STEPS iterations of
    ``Trainer.train`` with a loss readback each. One model per YAML serves
    both. The score tables and the training log go to WORK/zoo/<name>.log."""
    name = name or yml.stem
    cfg = _config(yml, model_keys)
    cfg["training"].update(train_iters=ZOO_TRAIN_STEPS, val_interval=ZOO_TRAIN_STEPS,
                           print_interval=1)
    arch, kind = cfg["model"]["arch"], cfg["data"]["commun_label"]
    b, n, size = cfg["training"]["batch_size"], cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    batches = seeded_batches(ZOO_EVAL_BATCHES, b, n, size, SEED + 7, kind)
    train_batches = seeded_batches(ZOO_TRAIN_STEPS, b, n, size, SEED + 8, kind)
    recording_loss, recorded = _recording_loss(cfg)
    logdir = WORK / "zoo" / name
    logdir.mkdir(parents=True, exist_ok=True)
    trainer = Trainer(cfg, logging.getLogger("chip_smoke"), recording_loss, train_batches,
                      batches, device="cuda", logdir=str(logdir))
    init_weights(trainer.model, SEED)
    pkl = logdir / "seed0.pkl"
    torch.save({"epoch": 0, "model_state": trainer.model.state_dict(), "best_iou": 0.0}, pkl)
    trainer.load_weight(str(pkl))
    result = {"config": yml.relative_to(ROOT).as_posix(), "model_keys": model_keys or {},
              "arch": arch, "batch": b, "agents": n, "size": size, "commun_label": kind,
              "eval": {}}
    with open(logdir.with_suffix(".log"), "w") as log, contextlib.redirect_stdout(log):
        trainer.evaluate(batches[:1])  # warm-up: cuDNN's and the allocator's first calls
        for mode in modes or ZOO_MODES.get(arch, (None,)):
            k1.upsample_argmax.launches = k2.comm_fusion.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            score, class_iou = trainer.evaluate(batches, inference_mode=mode)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = k1.upsample_argmax.launches
            counted = {"upsample_argmax": launches, "comm_fusion": k2.comm_fusion.launches}
            want = _expected_launches(trainer, mode, len(batches))
            if counted != want:
                raise AssertionError(f"{name} {mode}: launches {counted}, want {want}")
            metrics = trainer.last_eval_metrics
            labels = np.stack([bt[1] for bt in batches])  # (batches, B, N, H, W)
            if not (trainer.mo_flag and arch != "All_agents"):
                labels = labels[:, :, 0]  # the target is agent 0's
            if int(metrics.confusion_matrix.sum()) != int((labels < N_CLASSES).sum()):
                raise AssertionError(f"{name} {mode}: confusion matrix miscounts")
            if not all(np.isfinite(float(v)) for v in score.values()):
                raise AssertionError(f"{name} {mode}: non-finite scores")
            row = {"k1_launches": launches, "k2_launches": counted["comm_fusion"],
                   "batch_ms": seconds / len(batches) * 1e3,
                   "miou": float(score["Mean IoU : \t"])}
            if metrics.count:
                row["bandwidth"] = metrics.get_avg_bandW()
            if metrics.total_agent:
                row["when2com_acc"], row["who2com_acc"] = metrics.get_selection_accuracy()
            result["eval"][mode or "-"] = row

        torch.cuda.reset_peak_memory_stats()
        trainer.train()
        peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in recorded]
    if len(losses) != ZOO_TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: train losses {losses}")
    steps = trainer.iter_seconds
    result.update({"losses": losses, "train_first_step_ms": steps[0] * 1e3,
                   "train_ms_per_step": float(np.mean(steps[1:])) * 1e3,
                   "peak_device_bytes": peak})
    del trainer
    shutil.rmtree(logdir)
    torch.cuda.empty_cache()
    result["card_vs_cpu"] = card_vs_cpu(yml, model_keys=model_keys)
    return result


# ------------------------------------------------------------------ phase 8

BENCH_BATCH = bench.BATCH  # the JAX bench's main() batch, 20 (bench.py:382)
BENCH_EVAL_BATCHES = 5
MP_SEEDS = (0, 1, 2, 3)
MP_RATIO = 2.0  # the card's bf16 distance from float32 over the CPU's, at most


def _pre_logits(ev, images, inference: str):
    """``Evaluator.predict``'s forward without K1: the decoder's pre-upsample
    logits (float32, on the CPU), the action and the bandwidth."""
    with torch.inference_mode():
        x = ev._images(images)
        pre, action, nc = ev._outputs(ev.model(
            x, full_res=False, **ev._forward_kwargs(inference, "eval")))
    return pre.float().cpu(), action.cpu(), float(nc)


@_no_tf32()
def mixed_card_vs_cpu(dtype: str = "bfloat16", size: int = 256) -> dict:
    """The flagship's ``activated`` eval at ``size`` in ``dtype`` (bfloat16,
    phase 8, or float16, phase 16) and in float32 (TF32 off), on the card
    and on the CPU, from one set of weights per seed: over MP_SEEDS, the
    card's ``dtype`` pre-upsample logits lie no further from its float32
    ones than MP_RATIO times the CPU's from the CPU's float32 ones
    (relative L2, summed over the seeds), the rule
    tests/test_torch_mixed_precision_models.py holds the port to against
    JAX. Actions and bandwidth of card and CPU in ``dtype`` are reported."""
    cfg32 = load_config(str(FLAGSHIP))
    cfg32["data"]["img_rows"] = cfg32["data"]["img_cols"] = size
    cfg16 = copy.deepcopy(cfg32)
    cfg16["model"]["dtype"] = dtype
    b, n = cfg32["training"]["batch_size"], cfg32["model"]["agent_num"]
    errs = {"cuda": [], "cpu": []}
    same_actions, same_bandwidth = 0, 0
    for seed in MP_SEEDS:
        state = init_weights(get_model(cfg32, N_CLASSES), SEED + 20 + seed).state_dict()
        images = seeded_batches(1, b, n, size, SEED + 20 + seed, "None")[0][0]
        out = {}
        for dev in ("cuda", "cpu"):
            for name, cfg in (("f32", cfg32), ("mixed", cfg16)):
                ev = Evaluator(cfg, device=dev)
                ev.model.load_state_dict(state, strict=True)
                out[dev, name] = _pre_logits(ev, images, "activated")
            if not bool(torch.isfinite(out[dev, "mixed"][0]).all()):
                raise AssertionError(f"{dtype} on {dev}: non-finite logits (seed {seed})")
            errs[dev].append(_rel(out[dev, "mixed"][0], out[dev, "f32"][0]))
        same_actions += torch.equal(out["cuda", "mixed"][1], out["cpu", "mixed"][1])
        same_bandwidth += out["cuda", "mixed"][2] == out["cpu", "mixed"][2]
    card, cpu = sum(errs["cuda"]), sum(errs["cpu"])
    if not card <= MP_RATIO * cpu:
        raise AssertionError(f"{dtype} card vs float32 card {errs['cuda']} beyond {MP_RATIO} x "
                             f"{dtype} CPU vs float32 CPU {errs['cpu']}")
    return {"dtype": dtype, "size": size, "seeds": len(MP_SEEDS), "tf32": False,
            "rel_l2_to_f32": errs, "ratio": card / cpu,
            "seeds_with_equal_actions": same_actions,
            "seeds_with_equal_bandwidth": same_bandwidth}


def run_zoo_bf16(yml: Path) -> dict:
    """One reference YAML with ``model.dtype: bfloat16`` at its own size: a
    seeded model evaluated over ZOO_EVAL_BATCHES batches in its default
    mode (after a warm-up batch), K1's routes zeroed just before and read
    just after: its bf16 route launches once a batch, its float32 route
    never. The score tables go to WORK/zoo_bf16/<name>.log."""
    cfg = load_config(str(yml))
    cfg["model"]["dtype"] = "bfloat16"
    arch, kind = cfg["model"]["arch"], cfg["data"]["commun_label"]
    b, n, size = cfg["training"]["batch_size"], cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    mode = ZOO_MODES.get(arch, (None,))[0]
    batches = seeded_batches(ZOO_EVAL_BATCHES, b, n, size, SEED + 7, kind)
    ev = Evaluator(cfg)
    init_weights(ev.model, SEED)
    log_path = WORK / "zoo_bf16" / f"{yml.stem}.log"
    log_path.parent.mkdir(parents=True, exist_ok=True)
    with open(log_path, "w") as log, contextlib.redirect_stdout(log):
        ev.evaluate(batches[:1], inference_mode=mode)  # warm-up
        routes = k1.upsample_argmax.route_launches
        routes.update(dict.fromkeys(routes, 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score, _ = ev.evaluate(batches, inference_mode=mode)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = dict(k1.upsample_argmax.route_launches)
    if counts != {**dict.fromkeys(counts, 0), "bf16": ZOO_EVAL_BATCHES}:
        raise AssertionError(f"{yml.name} bf16 {mode}: K1 routes {counts}")
    if not all(np.isfinite(float(v)) for v in score.values()):
        raise AssertionError(f"{yml.name} bf16 {mode}: non-finite scores")
    metrics = ev.last_eval_metrics
    row = {"config": yml.relative_to(ROOT).as_posix(), "arch": arch, "dtype": "bfloat16",
           "mode": mode or "-", "batch": b, "agents": n, "size": size,
           "k1_bf16_launches": counts["bf16"], "batch_ms": seconds / len(batches) * 1e3,
           "miou": float(score["Mean IoU : \t"])}
    if metrics.count:
        row["bandwidth"] = metrics.get_avg_bandW()
    del ev
    torch.cuda.empty_cache()
    return row


# ------------------------------------------------------------------ phase 9

BENCH_DTYPES = ("bfloat16", "float32")
DEVICE_OVER_STEP = 1.05  # eval/train device ms over the amortized step ms, at most
REMAT_BATCH = 8
REMAT_RTOL, REMAT_ATOL = 1e-5, 1e-6  # loss and BatchNorm buffers, remat against plain


def check_kernels_at_bench_batch(gen) -> dict:
    """K1 and K2 against their plain versions (``checks``) at the shapes the
    bench's eval step hands them: (120, 11, 16, 16) logits to 512x512, and
    q', k (20, 6, 1024), V (20, 6, 512, 16, 16) in every mode; both types."""
    b, n = BENCH_BATCH, 6
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(b * n, N_CLASSES, 16, 16, generator=gen).to("cuda", dtype)
        q = torch.randn(b, n, 1024, generator=gen).to("cuda", dtype)
        k = (torch.randn(b, n, 1024, generator=gen) * 2 / 1024 ** 0.5).to("cuda", dtype)
        v = torch.randn(b, n, 512, 16, 16, generator=gen).to("cuda", dtype)
        out[_route(dtype)] = {
            "upsample_argmax": checks.check_upsample_argmax(x, 512, 512),
            "comm_fusion_max_abs_err": max(checks.check_comm_fusion(q, k, v, mode, DIAG_BIAS,
                                                                    THRES)
                                           for mode in k2.MODES)}
    return out


K2_F64_SEEDS = 8


def k2_graph_against_float64(gen) -> dict:
    """K2's graph (``soft``) and its plain version's in float32, each
    against the plain version in float64, at the bench's shapes over
    K2_F64_SEEDS draws: the largest distance and the elements beyond
    ``checks.K2_GRAPH_ATOL``, and the plain float32 logits' largest
    distance. Reported, not checked: ``checks.check_comm_fusion`` holds the
    kernel to float64, since the float32 plain version is no reference to
    that bound at this shape."""
    b, n = BENCH_BATCH, 6
    out = {"kernel": [0.0, 0], "plain": [0.0, 0], "plain_logits": 0.0}
    for _ in range(K2_F64_SEEDS):
        q = torch.randn(b, n, 1024, generator=gen).to("cuda")
        k = (torch.randn(b, n, 1024, generator=gen) * 2 / 1024 ** 0.5).to("cuda")
        v = torch.randn(b, n, 512, 16, 16, generator=gen).to("cuda")
        x_soft = k2.comm_fusion_plain(q.double(), k.double(), v.flatten(2)[..., :1].double(),
                                      diag_bias=DIAG_BIAS)[2]
        for side, fn in (("kernel", k2.comm_fusion), ("plain", k2.comm_fusion_plain)):
            err = (fn(q, k, v, diag_bias=DIAG_BIAS)[2].double() - x_soft).abs()
            out[side] = [max(out[side][0], err.max().item()),
                         out[side][1] + int((err > checks.K2_GRAPH_ATOL).sum())]
        logits = torch.einsum("bkd,bqd->bkq", k, q).double()
        out["plain_logits"] = max(out["plain_logits"], (logits - torch.einsum(
            "bkd,bqd->bkq", k.double(), q.double())).abs().max().item())
    return {"seeds": K2_F64_SEEDS, "graph_elements": K2_F64_SEEDS * b * n * n,
            **{f"{side}_soft_max_err": out[side][0] for side in ("kernel", "plain")},
            **{f"{side}_soft_beyond_atol": out[side][1] for side in ("kernel", "plain")},
            "plain_logits_max_err": out["plain_logits"]}


def run_bench(dtype: str) -> dict:
    """``bench.main`` at its defaults (batch 20) in ``dtype``, the launch
    counts zeroed just before and read just after: every contract key
    present and finite; K1 and K2 once per eval step on the dtype's route
    in the eval run and in the int8 eval run (the bench's own count of
    each run's steps; the counts left are the int8 run's, its last), K4
    once per int8 conv call of the int8 run (48 a step); MFU in (0, 100];
    and the device time per step at most DEVICE_OVER_STEP times the
    amortized step in the eval, int8 eval and train runs (a difference of
    two runs; a larger excess means the two readings measure different
    work). The bench's stderr (device time by kernel) is printed after its
    JSON line."""
    kernels = (k1.upsample_argmax, k2.comm_fusion, k4.int8_conv)
    bench._zero_launches(kernels)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        record = bench.main(["--dtype", dtype])
    for line in err.getvalue().splitlines():
        print(f"bench {dtype} stderr: {line}")
    numbers = ("value", "eval_step_ms", "eval_tflops_per_step", "eval_tflops_per_step_padfree",
               "eval_tflops_per_sec", "eval_mfu_pct", "eval_device_ms", "eval_busy_pct",
               "eval_peak_gb", "eval_dispatch_ms", "eval_int8_frames_per_sec",
               "eval_int8_step_ms", "eval_int8_speedup", "eval_int8_device_ms",
               "eval_int8_busy_pct", "eval_int8_convs_per_step", "train_frames_per_sec",
               "train_step_ms", "train_tflops_per_step", "train_tflops_per_step_padfree",
               "train_tflops_per_sec", "train_mfu_pct", "train_device_ms", "train_busy_pct",
               "train_peak_gb", "peak_tflops", "power_limit_w")
    bad = [k for k in numbers if not np.isfinite(record.get(k, float("nan")))]
    if bad or record["eval_batch"] != BENCH_BATCH or record["train_batch"] != BENCH_BATCH:
        raise AssertionError(f"bench {dtype}: keys missing or not finite {bad}: {record}")
    route = bench.ROUTE[dtype]
    live = {kern.__name__: dict(kern.route_launches) for kern in kernels}
    i8_steps, per_step = record["eval_int8_steps"], record["eval_int8_convs_per_step"]
    for kern in kernels[:2]:
        name = kern.__name__
        for key, steps in (("eval_route_launches", record["eval_steps"]),
                           ("eval_int8_route_launches", i8_steps)):
            counts = record[key][name]
            if counts != {**dict.fromkeys(counts, 0), route: steps}:
                raise AssertionError(f"bench {dtype}: {key} {name} {counts} ({steps} steps)")
        if live[name] != record["eval_int8_route_launches"][name]:
            raise AssertionError(f"bench {dtype}: {name} launched {live[name]}, the bench "
                                 f"counted {record['eval_int8_route_launches'][name]}")
    k4_counts = {**dict.fromkeys(live["int8_conv"], 0), route: per_step * i8_steps}
    if live["int8_conv"] != k4_counts or \
            record["eval_int8_route_launches"]["int8_conv"] != k4_counts:
        raise AssertionError(f"bench {dtype}: int8_conv launched {live['int8_conv']}, want "
                             f"{per_step} a step x {i8_steps} steps")
    for phase in ("eval", "train"):
        mfu = record[f"{phase}_mfu_pct"]
        if not 0 < mfu <= 100:
            raise AssertionError(f"bench {dtype}: {phase}_mfu_pct {mfu}")
    for phase in ("eval", "eval_int8", "train"):
        dev, step = record[f"{phase}_device_ms"], record[f"{phase}_step_ms"]
        if dev > DEVICE_OVER_STEP * step:
            raise AssertionError(f"bench {dtype}: {phase} device {dev} ms over step {step} ms")
    return record


def remat_pair() -> dict:
    """One bf16 ``Trainer`` step of the flagship at batch REMAT_BATCH x 6
    (512x512) without and then with ``model.remat``, from one set of
    weights and one batch: the loss and the BatchNorm running statistics
    equal within REMAT_RTOL / REMAT_ATOL (both come from the first
    forward), ``num_batches_tracked`` 1 (the momentum applied once, not again
    by the recompute), and remat's peak device memory lower. Each step's
    peak is read after ``reset_peak_memory_stats``; the gradients' largest
    relative L2 distance is printed."""
    cfg = load_config(str(FLAGSHIP))
    cfg["training"].update(batch_size=REMAT_BATCH, mixed_precision=True)
    b, n, size = REMAT_BATCH, cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    state = init_weights(get_model(cfg, N_CLASSES), SEED + 9).state_dict()
    images, labels, _ = seeded_batches(1, b, n, size, SEED + 9)[0]
    out = {}
    for remat in (False, True):
        cfg["model"]["remat"] = remat
        trainer = Trainer(cfg, None, get_loss_function(cfg), None, None, device="cuda")
        trainer.model.load_state_dict(state, strict=True)
        x, y = trainer._batch(images, labels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = float(trainer.train_step(x, y))
        torch.cuda.synchronize()
        out[remat] = {"loss": loss, "peak": torch.cuda.max_memory_allocated(),
                      "buffers": {k: v.detach().cpu() for k, v in trainer.model.named_buffers()},
                      "grads": {k: p.grad.detach().cpu()
                                for k, p in trainer.model.named_parameters()}}
        del trainer, x, y
        torch.cuda.empty_cache()
    plain, remat = out[False], out[True]
    if not np.isclose(remat["loss"], plain["loss"], rtol=REMAT_RTOL, atol=0):
        raise AssertionError(f"remat loss {remat['loss']} against {plain['loss']}")
    for name, buf in plain["buffers"].items():
        if name.endswith("num_batches_tracked"):
            if int(buf) != 1 or int(remat["buffers"][name]) != 1:
                raise AssertionError(f"{name}: {int(buf)} / {int(remat['buffers'][name])}")
        else:
            torch.testing.assert_close(remat["buffers"][name], buf, rtol=REMAT_RTOL,
                                       atol=REMAT_ATOL, msg=name)
    if not remat["peak"] < plain["peak"]:
        raise AssertionError(f"remat peak {remat['peak']} not below {plain['peak']}")
    return {"batch": b, "agents": n, "size": size, "dtype": "bfloat16",
            "loss": plain["loss"], "loss_remat": remat["loss"],
            "peak_gb": plain["peak"] / 1e9, "peak_gb_remat": remat["peak"] / 1e9,
            "worst_grad_rel_l2": max(_rel(remat["grads"][k], g)
                                     for k, g in plain["grads"].items() if g.norm() > 0)}


# ------------------------------------------------------------------ phase 10

INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense (NVIDIA data sheet)
K4_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}  # the network dtype: the route
INT8_EVAL_BATCHES = 6
INT8_CALIB_BATCHES = 2


def _im2col_i8(x_i8: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """The (N * OH * OW, Cin * k * k) int8 matrix of a convolution's
    patches, K padded to a multiple of 8 (``torch._int_mm``'s rule). The
    int8 values pass through float16 exactly."""
    cols = torch.nn.functional.unfold(x_i8.half(), k, padding=pad, stride=stride)
    a = cols.transpose(1, 2).reshape(-1, cols.shape[1])
    return torch.nn.functional.pad(a, (0, -a.shape[1] % 8)).to(torch.int8).contiguous()


def int_mm_yardstick(x: torch.Tensor, prep, s_x, k: int, stride: int, pad: int,
                     acc: torch.Tensor) -> dict:
    """``torch._int_mm`` on the same M x K x Cout int8 matrices as K4's GEMM
    (the im2col'd activations built first, not timed): its time; its
    int32 sums must equal K4's ``acc``. A yardstick only: the port never
    calls it."""
    a = _im2col_i8(k4.quantize_input(x, s_x), k, stride, pad)
    cout = prep.w_i8.shape[0]
    b = torch.nn.functional.pad(prep.w_i8.reshape(cout, -1), (0, a.shape[1] - prep.w_i8[0].numel()))
    b = b.t()  # (K, Cout), column-major: cuBLASLt's int8 layout
    try:
        got = torch._int_mm(a, b)
    except RuntimeError as err:  # a yardstick PyTorch refuses is reported, not required
        return {"library_int_mm_ms": None, "library_int_mm_error": str(err)[:200]}
    n, _, oh, ow = acc.shape
    if not torch.equal(got.view(n, oh * ow, cout).permute(0, 2, 1).reshape(acc.shape), acc):
        raise AssertionError("torch._int_mm's int32 sums differ from K4's: the yardstick "
                             "does not compute the GEMM's function")
    ms = _time_ms(lambda: torch._int_mm(a, b), iters=20)
    del a, got
    return {"library_int_mm_ms": ms}


def check_int8_conv(gen, shapes=K4_SHAPES, n: int = BENCH_BATCH * 6,
                    dtypes=K4_DTYPES, per: str = "one eval step's 48 int8 convolutions at "
                    "batch 20 x 6") -> list[dict]:
    """K4 against its plain version (``checks.check_int8_conv``: operands,
    int32 sums and output equal, the output to the bit) at every conv shape
    of the flagship's eval step at the bench's batch 20 x 6 (or at ``shapes``,
    ``n`` images), in both network dtypes (or ``dtypes``) (the bf16 route reads
    float32 frames at the stem and bf16 maps elsewhere), with a static scale
    (0.8 of the input's max / 127, so some values clip) and with the dynamic
    one. Then each shape is timed with its static scale: K4, its two
    launches alone (the quantize pass on the input, the GEMM on its
    scratch), its plain version, cuDNN's bf16
    convolution of the same shape (the speed yardstick of the whole
    function; no PyTorch call computes an int8 convolution, and the port
    never calls this one) and ``torch._int_mm`` on the same int8 matrices
    (the GEMM's yardstick). One record per network dtype; its ms, plain,
    library and bound are sums over one eval step's conv calls."""
    records = []
    geometries = shapes
    for route, dtype in dtypes.items():
        # the yardstick: cuDNN in the float16 network's type, else bf16
        library_dtype = torch.float16 if dtype == torch.float16 else torch.bfloat16
        shapes, err = [], 0.0
        for cin, cout, side, k, stride, pad, has_bias, calls in geometries:
            in_dtype = torch.float32 if cin == 3 else dtype
            x = torch.randn(n, cin, side, side, generator=gen).to("cuda", in_dtype)
            w = (torch.randn(cout, cin, k, k, generator=gen) / (cin * k * k) ** 0.5).to("cuda")
            bias = torch.randn(cout, generator=gen).to("cuda") if has_bias else None
            s_x = torch.tensor(0.8 * float(x.float().abs().amax()) / 127, device="cuda")
            for scale in (s_x, None):
                err = max(err, checks.check_int8_conv(x, w, bias, stride, pad, scale,
                                                      dtype)["max_abs_err"])
            prep = k4.prepare_weight(w)
            geometry = k4.plan(n, cin, side, side, cout, k, k, stride, pad)
            xq = k4.quantize_scratch(x, s_x, geometry)
            acc = k4.conv_nhwc(xq, prep, s_x, None, geometry, torch.int32)
            x16, w16 = x.to(library_dtype), w.to(library_dtype)
            b16 = None if bias is None else bias.to(library_dtype)
            out_side = geometry.out[0]
            macs = n * out_side ** 2 * cout * cin * k * k
            out_bytes = n * cout * out_side ** 2 * torch.finfo(dtype).bits // 8
            bytes_moved = (x.numel() * x.element_size() + prep.w_i8.numel() + 4 * cout
                           + (4 * cout if has_bias else 0) + out_bytes)
            bound_ms, bound_by = max((bytes_moved / HBM_BYTES_PER_S * 1e3, "bytes"),
                                     (2 * macs / INT8_OPS_PER_S * 1e3, "operations"))
            # the quantize pass: one read of x, one write of its scratch; the
            # GEMM: the scratch read once, the weights, the output written once
            quantize_bound_ms = (x.numel() * x.element_size() + xq.numel()) / HBM_BYTES_PER_S * 1e3
            gemm_bound_ms = max((xq.numel() + prep.w_i8.numel() + out_bytes) / HBM_BYTES_PER_S,
                                2 * macs / INT8_OPS_PER_S) * 1e3
            shapes.append({
                "shape": f"({n}, {cin}, {side}, {side}) {k}x{k}/{stride} pad {pad} -> {cout}"
                         + (" +bias" if has_bias else ""),
                "calls_per_step": calls, "gemm_route": geometry.route, "nb": geometry.nb,
                "ms": _time_ms(lambda: k4.int8_conv(x, prep, s_x, bias, stride, pad,
                                                    out_dtype=dtype), iters=20),
                "quantize_ms": _time_ms(lambda: k4.quantize_scratch(x, s_x, geometry), iters=20),
                "gemm_ms": _time_ms(lambda: k4.conv_nhwc(xq, prep, s_x, bias, geometry, dtype),
                                    iters=20),
                "plain_ms": _time_ms(lambda: k4.int8_conv_plain(x, prep, s_x, bias, stride,
                                                                pad, dtype), iters=3),
                "library_ms": _time_ms(lambda: torch.nn.functional.conv2d(
                    x16, w16, b16, stride, pad), iters=20),
                **int_mm_yardstick(x, prep, s_x, k, stride, pad, acc),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "quantize_bound_ms": quantize_bound_ms, "gemm_bound_ms": gemm_bound_ms,
                "tops": 2 * macs / 1e9})
            del x, x16, xq, acc
        step = lambda key: sum(r[key] * r["calls_per_step"] for r in shapes)  # noqa: E731
        # the basis that holds the larger share of the step's bound
        by_basis = {basis: sum(r["bound_ms"] * r["calls_per_step"] for r in shapes
                               if r["bound_by"] == basis) for basis in ("bytes", "operations")}
        int_mm = [r["library_int_mm_ms"] for r in shapes]
        records.append({
            "name": "int8_conv" + _suffix(dtype), "route": "cuda",
            "source": "multiagentperception_tpu_torch/csrc/int8_conv.cu",
            "replaces": "multiagentperception_tpu/quantize.py:106 (XLA's int8 conv; no "
                        "Pallas kernel)",
            "max_abs_err": err, "ms": step("ms"), "plain_ms": step("plain_ms"),
            "library_ms": step("library_ms"), "bound_ms": step("bound_ms"),
            "bound_by": max(by_basis, key=by_basis.get), "bound_ms_by_basis": by_basis,
            "quantize_ms": step("quantize_ms"), "gemm_ms": step("gemm_ms"),
            "quantize_bound_ms": step("quantize_bound_ms"), "gemm_bound_ms": step("gemm_bound_ms"),
            "library_int_mm_ms": None if None in int_mm else step("library_int_mm_ms"),
            "per": f"{per} (sums over 'shapes'); library: cuDNN {_route(library_dtype)}; "
                   "library_int_mm: torch._int_mm on the GEMM's int8 matrices",
            "shapes": shapes})
        torch.cuda.empty_cache()
    return records


def run_int8_slice(dtype: str | None = None, model_keys: dict | None = None,
                   trace: bool = True) -> dict:
    """The flagship's (with ``model_keys`` over its model section)
    ``activated`` int8 eval through ``Evaluator.evaluate(..., int8=True)``
    at the YAML's batch, in float32 or ``dtype``: scales calibrated on
    INT8_CALIB_BATCHES held-out batches, then INT8_EVAL_BATCHES batches
    with K1, K2 and K4's counts zeroed just before and read just after. K1
    launches once a batch (never for a decoder with no pre-upsample
    logits), K2 once a batch and once a calibration batch, K4 once per
    swapped conv call, which is once per eligible conv a batch. Then the
    same batches timed under the evaluator's swap (its weights already
    quantized): frames/s; with ``trace``, also traced: device time, and the
    trace's convolutions: cuDNN runs only the skipped head's, once a batch
    (counted by the ``aten::`` operators the trace records on the host)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _config(FLAGSHIP, model_keys)
    if dtype is not None:
        cfg["model"]["dtype"] = dtype
    b, n, size = cfg["training"]["batch_size"], cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    route = _route(dtype)
    WORK.mkdir(parents=True, exist_ok=True)
    ev = Evaluator(cfg, graphs=False)  # the trace below counts the eager step's host ops
    ev.model.load_state_dict(init_weights(get_model(cfg, N_CLASSES), SEED).state_dict())
    batches = seeded_batches(INT8_EVAL_BATCHES + INT8_CALIB_BATCHES, b, n, size, SEED + 30)
    calib, timed = batches[:INT8_CALIB_BATCHES], batches[INT8_CALIB_BATCHES:]
    kernels = (k1.upsample_argmax, k2.comm_fusion, k4.int8_conv)
    bench._zero_launches(kernels)
    k4.int8_conv.geometry_launches.update(dict.fromkeys(k4.int8_conv.geometry_launches, 0))
    ev.evaluate(timed, int8=True, calib_loader=calib)
    gemm_routes = dict(k4.int8_conv.geometry_launches)
    swap = ev.int8_convs
    eligible = len(swap.convs)
    counts = {kern.__name__: dict(kern.route_launches) for kern in kernels}
    want = {"upsample_argmax": len(timed) if ev.model.decoder.has_pre_logits else 0,
            "comm_fusion": len(timed) + len(calib), "int8_conv": eligible * len(timed)}
    for name, total in want.items():
        if counts[name] != {**dict.fromkeys(counts[name], 0), route: total}:
            raise AssertionError(f"int8 eval {route}: {name} launched {counts[name]}, "
                                 f"want {total} on {route}")
    if swap.calls != eligible * len(timed):
        raise AssertionError(f"int8 eval: {swap.calls} swapped calls, {eligible} eligible "
                             f"convs x {len(timed)} batches")
    int8_scores = ev.last_eval_metrics

    with swap:  # steady state: quantized weights kept, no calibration
        ev.evaluate(timed[:2])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev.evaluate(timed)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        result = {"dtype": dtype or "float32", "model_keys": model_keys or {}, "batch": b,
                  "agents": n, "size": size, "batches": len(timed),
                  "calibration_batches": len(calib), "int8_convs_per_batch": eligible,
                  "launches": counts, "k4_gemm_route_launches": gemm_routes,
                  "eval_frames_per_s": len(timed) * b * n / seconds,
                  "batch_ms": seconds / len(timed) * 1e3,
                  "bandwidth": int8_scores.get_avg_bandW(),
                  "mean_iou": float(int8_scores.get_scores()[0]["Mean IoU : \t"])}
        if not trace:
            return result
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ev.evaluate(timed)
            torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False)]
    convs = sum(e.count for e in events if e.key == "aten::convolution")
    cudnn = sum(e.count for e in events if e.key == "aten::cudnn_convolution")
    head = len([m for m in ev.model.modules() if isinstance(m, torch.nn.Conv2d)]) - eligible
    if convs != head * len(timed) or cudnn != head * len(timed):
        raise AssertionError(f"int8 eval trace: {convs} convolutions, {cudnn} in cuDNN, for "
                             f"{head} skipped conv(s) x {len(timed)} batches")
    # the launch counts above hold K4 to one launch per int8 conv; the trace's
    # own count is reported (CUPTI may drop records late in a long process)
    k4_traced = sum(e.count for e in device if "int8_conv_kernel" in e.key)
    if not k4_traced:
        raise AssertionError("int8 eval trace: no launch of K4's GEMM")
    device_ms = sum(e.self_device_time_total for e in device) / 1e3
    k4_ms = sum(e.self_device_time_total for e in device
                if "int8_conv_kernel" in e.key or "quantize_nhwc" in e.key
                or "quantize_s2d" in e.key) / 1e3
    (WORK / f"profile_int8_{route}.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=40))
    return {**result, "device_ms_per_batch": device_ms / len(timed),
            "k4_device_ms_per_batch": k4_ms / len(timed),
            "device_busy_share": device_ms / (seconds * 1e3),
            "cudnn_convolutions_per_batch": cudnn / len(timed),
            "k4_gemms_traced_per_batch": k4_traced / len(timed)}


# card against CPU, int8: the share of pixels whose class may differ, by network
# dtype; a 16-bit network rounds its BatchNorm outputs before the next quantizer,
# which absorbs most of the float layers' ulps (int8_card_vs_cpu)
INT8_CARD_VS_CPU_MOVED = {"float32": 0.01, "bfloat16": 0.001, "float16": 0.001}


def int8_card_vs_cpu(dtype: str | None = None, size: int = 256,
                     model_keys: dict | None = None) -> dict:
    """The flagship's ``activated`` int8 eval at ``size`` on the card and on
    the CPU from one set of weights and one set of scales (calibrated on the
    card), TF32 off for the float layers: the confusion matrices apart by
    at most INT8_CARD_VS_CPU_MOVED of the pixels, and in bf16 and float16
    the bandwidth equal (in float32 it is reported). Every int8 conv is exact on both
    sides (``check_int8_conv``), but the float layers between them
    (BatchNorm, the residual adds) differ by an ulp between cuDNN/ATen on
    the card and the CPU, and a value within an ulp of a half-step of the
    next conv's int8 grid rounds to neighbouring int8 values on the two
    sides; each such flip moves that conv's outputs by a step, and the
    flips multiply down the towers. In float32 every ulp reaches the
    quantizer (on an NVIDIA H100 80GB HBM3 at 700 W: 0.54% of the pixels
    moved, and one off-diagonal link of one batch crossed the 0.2
    threshold, bandwidth 0.9583 against 0.9167); in bf16 the BatchNorm's output is rounded to bf16
    first, which absorbs most of them (0.019%, the bandwidth equal), and
    in float16 likewise (0.013%, the bandwidth equal).
    ``model_keys`` go over the flagship's model section."""
    cfg = _config(FLAGSHIP, model_keys)
    cfg["data"]["img_rows"] = cfg["data"]["img_cols"] = size
    if dtype is not None:
        cfg["model"]["dtype"] = dtype
    b, n = cfg["training"]["batch_size"], cfg["model"]["agent_num"]
    state = init_weights(get_model(cfg, N_CLASSES), SEED + 31).state_dict()
    batches = seeded_batches(3, b, n, size, SEED + 31)
    result = _int8_card_against_cpu(cfg, state, batches[:1], batches[1:])
    name = dtype or "float32"
    if result["pixels_moved"] > INT8_CARD_VS_CPU_MOVED[name] * result["pixels"] or \
            (dtype is not None and result["bandwidth_card"] != result["bandwidth_cpu"]):
        raise AssertionError(f"int8 {name}: card against CPU {result}")
    return {"model_keys": model_keys or {}, "size": size, **result}


def _int8_card_against_cpu(cfg: dict, state: dict, calib, batches,
                           float_gap: bool = False) -> dict:
    """``cfg``'s ``activated`` int8 eval over ``batches`` on the card and on
    the CPU from ``state`` and one set of scales (calibrated on the card
    over ``calib``), TF32 off: the pixels whose class the two sides' confusion
    matrices move, each side's bandwidth, and the attention graphs that
    ``activated`` thresholds (``_graph_gap``). ``float_gap`` adds the same
    between the CPU's int8 eval and its float32 one (``int8_vs_float32_cpu``:
    how far int8 itself moves the result), and between the card's float32
    eval and the CPU's (``float32_card_vs_cpu``)."""
    out, scales = {}, None
    with _no_tf32():
        for dev in ("cuda", "cpu"):
            ev = Evaluator(cfg, device=dev)
            ev.model.load_state_dict(state, strict=True)
            if scales is None:
                scales = ev._calibrate_int8(batches, "activated", calib_loader=calib)
            if float_gap:
                ev.evaluate(batches)
                out[dev, "float32"] = ev.last_eval_metrics, _activated_graph(ev, batches)
            with Int8Convs(ev.model, scales):
                ev.evaluate(batches)
                out[dev] = ev.last_eval_metrics, _activated_graph(ev, batches)
    (card, card_g), (cpu, cpu_g) = out["cuda"], out["cpu"]
    result = {"dtype": cfg["model"].get("dtype") or "float32", "tf32": False,
              **_moved(card, cpu),
              "bandwidth_card": card.get_avg_bandW(), "bandwidth_cpu": cpu.get_avg_bandW(),
              **_graph_gap(card_g, cpu_g)}
    if float_gap:
        (card32, card32_g), (cpu32, cpu32_g) = out["cuda", "float32"], out["cpu", "float32"]
        result["int8_vs_float32_cpu"] = {**_moved(cpu, cpu32),
                                         "bandwidth_float32": cpu32.get_avg_bandW(),
                                         **_graph_gap(cpu_g, cpu32_g)}
        result["float32_card_vs_cpu"] = {**_moved(card32, cpu32), **_graph_gap(card32_g, cpu32_g)}
    return result


def _moved(a, b) -> dict:
    """The pixels whose class two evals' confusion matrices move."""
    moved = int(np.abs(a.confusion_matrix.astype(np.int64)
                       - b.confusion_matrix.astype(np.int64)).sum()) // 2
    pixels = int(b.confusion_matrix.sum())
    return {"pixels_moved": moved, "pixels": pixels, "moved_share": moved / pixels}


def _graph_gap(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Two (B, K, Q) attention graphs: their largest and mean absolute
    difference, and the links that ``activated`` decides differently (kept
    on one side, pruned on the other), with each such link's distance from
    the threshold on ``b``'s side."""
    diff = (a - b).abs()
    flipped = (a > THRES) != (b > THRES)
    return {"graph_max_abs_diff": float(diff.max()), "graph_mean_abs_diff": float(diff.mean()),
            "links": flipped.numel(), "links_flipped": int(flipped.sum()),
            "flipped_from_thres": (b[flipped] - THRES).abs().tolist()}


def _activated_graph(ev, batches) -> torch.Tensor:
    """The attention graph (B, K, Q) that ``activated`` thresholds, over
    ``batches``, float32 on the CPU."""
    with torch.inference_mode():
        return torch.cat([ev.model(ev._images(b[0]), full_res=False,
                                   **ev._forward_kwargs("activated", "eval"))[1].float().cpu()
                          for b in batches])


# int8 card against CPU on trained weights, held to the CPU's own int8
# against float32: the card's int8 may move at most INT8_TRAINED_RATIO times
# the pixels, and INT8_TRAINED_RATIO times the mean graph difference, that
# int8 moves from float32 (trained_int8_card_vs_cpu says why)
INT8_TRAINED_RATIO = 1.0
# the learning proof's run (scripts/prove_learning.py's defaults): the flagship
# at 128x128 over the informative fixture's train split, batch 4, Adam 1e-4
LEARN_SIZE, LEARN_FRAMES, LEARN_ITERS, LEARN_BATCH, LEARN_LR = 128, 32, 400, 4, 1e-4
LEARN_EVAL_BATCHES = 8


class _ShuffledBatches:
    """A loader over in-memory frames: each pass a new seeded order, the
    ragged tail dropped (``DataLoader(shuffle=True, drop_last=True)``)."""

    def __init__(self, frames: list, batch: int, seed: int):
        self.frames, self.batch = frames, batch
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        order = self.rng.permutation(len(self.frames))
        for i in range(0, len(order) - self.batch + 1, self.batch):
            yield _stack([self.frames[j] for j in order[i:i + self.batch]])


def _stack(frames: list) -> tuple:
    """(images, labels, commun_label) batch of (scene, labels, noise, link) frames,
    the images normalized as the loader normalizes them."""
    raw = np.stack([f[0] for f in frames])
    images = normalize_images(torch.from_numpy(raw)).numpy()
    labels = np.stack([f[1] for f in frames]).astype(np.int32)
    commun = np.stack([np.stack([f[2], f[3]]) for f in frames]).astype(np.int64)
    return images, labels, commun


def trained_int8_card_vs_cpu(seed: int = SEED, check: bool = True) -> dict:
    """int8 card against CPU on trained weights. The flagship at 128x128 is
    trained on the card for LEARN_ITERS iterations over the informative
    fixture's train split (``data.synthetic.informative_frames``, as
    scripts/prove_learning.py trains the JAX model), then evaluated in
    ``activated`` (its mIoU, selection accuracy and bandwidth printed), and
    held in int8 on the card against the CPU on the train frames, from one
    set of scales, against how far int8 moves the CPU's own result from
    float32: the card's int8 moves no more pixels from the CPU's int8, and
    no larger a mean graph difference, than INT8_TRAINED_RATIO times what
    the CPU's int8 moves from its float32; and a link that the card and the
    CPU decide differently lies nearer the threshold than int8's own
    largest graph difference, a link that int8 leaves undecided.

    Why a yardstick and not a fixed share: the float layers between the
    int8 convs differ by an ulp on the two sides (float32 card against CPU
    on these weights: at most 1.3e-6 of the pixels moved, graphs within
    4.4e-6), and an ulp at a half-step of the next conv's int8 grid flips
    an int8 value; the flips multiply down the towers, as far on trained
    weights as int8 rounding reaches. Training on the card is not
    deterministic, so every run holds other weights. Over 10 trainings
    (``--int8-draws 10`` on an NVIDIA H100 80GB HBM3 at 700 W) the card
    moved 0.027-0.167% of the pixels from the CPU and the graph by up to
    0.005-0.040, one diagonal link flipped 0.0115 from the threshold,
    while int8 moved 0.29-0.85% of the pixels from float32 and the graph
    by up to 0.035-0.112: the ratios were 0.06-0.33 (pixels) and 0.06-0.22
    (mean graph difference). A fixed 0.1% of the pixels with an equal
    bandwidth, set from two trainings, failed in 2 of 13 (one of the 10,
    and a full run whose bandwidth moved by one link).

    ``seed`` seeds the weights and the shuffle; ``check=False`` returns the
    result with the verdict under ``within_int8_gap`` instead of raising."""
    from multiagentperception_tpu_torch.data.synthetic import informative_frames

    cfg = load_config(str(FLAGSHIP))
    cfg["data"]["img_rows"] = cfg["data"]["img_cols"] = LEARN_SIZE
    cfg["training"].update(train_iters=LEARN_ITERS, batch_size=LEARN_BATCH,
                           val_interval=LEARN_ITERS, print_interval=max(LEARN_ITERS // 8, 1))
    cfg["training"]["optimizer"] = {"name": "adam", "lr": LEARN_LR}
    frames = [f[2:] for f in informative_frames("6agent", LEARN_SIZE, LEARN_FRAMES,
                                                n_noisy=2)["train"]]
    ordered = [_stack(frames[i:i + LEARN_BATCH])
               for i in range(0, LEARN_EVAL_BATCHES * LEARN_BATCH, LEARN_BATCH)]
    logdir = WORK / "learn"
    logdir.mkdir(parents=True, exist_ok=True)
    trainer = Trainer(cfg, logging.getLogger("chip_smoke"), get_loss_function(cfg),
                      _ShuffledBatches(frames, LEARN_BATCH, seed), ordered[:2],
                      device="cuda", logdir=str(logdir))
    init_weights(trainer.model, seed)
    t0 = time.perf_counter()
    with open(logdir.with_suffix(".log"), "w") as log, contextlib.redirect_stdout(log):
        trainer.train()
        score, _ = trainer.evaluate(ordered, inference_mode="activated")
    seconds = time.perf_counter() - t0
    metrics = trainer.last_eval_metrics
    when_acc, who_acc = metrics.get_selection_accuracy()
    state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    del trainer
    shutil.rmtree(logdir)
    torch.cuda.empty_cache()
    result = _int8_card_against_cpu(cfg, state, ordered[:2], ordered[2:], float_gap=True)
    learned = {"iters": LEARN_ITERS, "size": LEARN_SIZE, "batch": LEARN_BATCH, "lr": LEARN_LR,
               "train_and_eval_s": seconds, "miou_activated": float(score["Mean IoU : \t"]),
               "when2com_acc": when_acc, "who2com_acc": who_acc,
               "bandwidth": metrics.get_avg_bandW()}
    gap = result["int8_vs_float32_cpu"]
    within = result["pixels_moved"] <= INT8_TRAINED_RATIO * gap["pixels_moved"] and \
        result["graph_mean_abs_diff"] <= INT8_TRAINED_RATIO * gap["graph_mean_abs_diff"] and \
        all(d < gap["graph_max_abs_diff"] for d in result["flipped_from_thres"])
    if check and not within:
        raise AssertionError(f"int8 on trained weights: card against CPU {result}")
    return {"trained": learned, "within_int8_gap": within, **result}


def int8_draws(count: int) -> int:
    """``--int8-draws N``: ``trained_int8_card_vs_cpu`` alone, once for each
    seed 0..N-1 (a new training each), one ``int8_draw`` JSON line a draw
    with its verdict: the check's spread over trainings. Exits 1 if a draw
    fell outside int8's gap."""
    _build.build()
    outside = 0
    for seed in range(count):
        result = trained_int8_card_vs_cpu(seed, check=False)
        outside += not result["within_int8_gap"]
        print("int8_draw " + json.dumps({"seed": seed, **result}), flush=True)
    print(bench._card_line())
    return int(outside > 0)


# ------------------------------------------------------------------ phase 12

TOPK_YAML = ROOT / "configs" / "extensions" / "mrms_when2com_topk.yml"
SRMS_WHEN2COM = ROOT / "configs" / "single-request-multiple-support" / "srms_when2com.yml"
TOPK_MODES = ("topk", "activated", "argmax_test")
SEGNET = {"enc_backbone": "n_segnet_encoder", "dec_backbone": "n_segnet_decoder"}
# the flagship with each model option that no YAML sets, at the YAML's own size
OVERRIDES = {"segnet": SEGNET, "fcn": {"dec_backbone": "FCN_decoder"},
             "squeezer2": {"feat_squeezer": 2}, "squeezer4": {"feat_squeezer": 4},
             "no_query": {"query": False}, "one_output": {"multiple_output": False}}


def topk_bandwidth(yml: Path = TOPK_YAML) -> dict:
    """The topk YAML's seeded model over ZOO_EVAL_BATCHES batches in
    ``topk`` on the card: each batch's per-frame bandwidth
    (``per_frame_links`` with ``topk_k``) averages to the forward's
    ``num_connect``, and every query keeps at most ``topk_k`` links, or more
    only where keys tie with its k-th strongest."""
    from multiagentperception_tpu_torch.ops.comm import per_frame_links

    cfg = load_config(str(yml))
    b, n, size = cfg["training"]["batch_size"], cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    k = cfg["model"]["topk_k"]
    ev = Evaluator(cfg)
    init_weights(ev.model, SEED)
    per_frame, ties = [], 0
    for images, _, _ in seeded_batches(ZOO_EVAL_BATCHES, b, n, size, SEED + 7):
        with torch.inference_mode():
            _, prob, _, nc = ev.model(ev._images(images), inference="topk", full_res=False)
        frames = per_frame_links(prob, "topk", n, topk_k=k)
        if abs(float(frames.double().mean()) - float(nc)) > 1e-6 * max(float(nc), 1.0):
            raise AssertionError(f"topk: per-frame bandwidth {frames.tolist()} against "
                                 f"num_connect {float(nc)}")
        top = torch.sort(prob, dim=1, descending=True).values  # (B, K, Q)
        kept = (prob >= top[:, k - 1:k]).sum(dim=1)  # links a query keeps
        tied = top[:, k] == top[:, k - 1]
        if bool(((kept > k) & ~tied).any()):
            raise AssertionError(f"topk: a query keeps {kept.max()} > {k} links without a tie")
        ties += int(tied.sum())
        per_frame += frames.tolist()
    del ev
    torch.cuda.empty_cache()
    return {"topk_k": k, "per_frame_bandwidth": per_frame, "queries_with_ties": ties}


CLI_TIMEOUT_S = 600


def _cli_start(module: str, *args: str, cwd: Path) -> tuple:
    """``python -m multiagentperception_tpu_torch.<module> *args`` in ``cwd``
    (on the card: no ``--device``), started, its output to files in ``cwd``;
    ``_cli_wait`` takes what it returns."""
    out, err = (open(cwd / f"{module}.{kind}", "w+") for kind in ("out", "err"))
    proc = subprocess.Popen([sys.executable, "-m", f"multiagentperception_tpu_torch.{module}",
                             *args], cwd=cwd, stdout=out, stderr=err, text=True,
                            env={**os.environ, "PYTHONPATH": str(ROOT)})
    return proc, module, args, time.perf_counter(), out, err


def _cli_wait(started: tuple) -> tuple[str, float]:
    """A started CLI's stdout and seconds, or an AssertionError with its
    output's end."""
    proc, module, args, t0, out, err = started
    try:
        proc.wait(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"{module}: no exit after {CLI_TIMEOUT_S} s") from None
    finally:
        text = []
        for f in (out, err):
            f.seek(0)
            text.append(f.read())
            f.close()
    if proc.returncode != 0:
        raise AssertionError(f"{module} {' '.join(args)}: rc {proc.returncode}\n"
                             f"{text[0][-2000:]}\n{text[1][-3000:]}")
    return text[0], time.perf_counter() - t0


def topk_clis(yml: Path = TOPK_YAML) -> dict:
    """The topk YAML through the CLIs a user runs, on the card: over the
    informative fixture at the YAML's 512x512 (one trajectory a split, 2
    frames each, written with the port's ``generate_informative_fixture``),
    ``train`` (2 iterations, then its test-split eval in ``topk`` on the
    checkpoint it wrote), and, from a seeded ``.pkl``, ``test``,
    ``export_serving`` (the artifact in the YAML's ``topk``) and ``serve``
    over the test split; ``train``, ``test`` and ``export_serving`` run at
    once, ``serve`` once its artifact exists. Each must exit 0; the
    evaluations print a bandwidth, the export's meta says ``topk``."""
    import yaml

    from multiagentperception_tpu_torch.data.synthetic import generate_informative_fixture

    work = WORK / "topk_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = yaml.safe_load(yml.read_text())
    generate_informative_fixture(str(work / "data"), "6agent", cfg["data"]["img_rows"],
                                 frames_per_traj=2, n_train=1, n_val=1, n_test=1)
    cfg["data"]["path"] = str(work / "data")
    cfg["training"].update(train_iters=2, val_interval=2, print_interval=1, n_workers=2)
    config = work / "mrms_when2com_topk.yml"
    config.write_text(yaml.safe_dump(cfg))
    pkl = work / "seed0.pkl"
    model = init_weights(get_model(load_config(str(config)), N_CLASSES), SEED)
    torch.save({"epoch": 0, "model_state": model.state_dict(), "best_iou": 0.0}, pkl)
    del model
    artifact = work / "topk.pt2"
    started, seconds = [], {}

    def start(*args: str) -> tuple:
        started.append(_cli_start(*args, cwd=work))
        return started[-1]

    try:
        train = start("train", "--config", str(config))
        test = start("test", "--config", str(config), "--model_path", str(pkl))
        export = start("export_serving", "--config", str(config), "--model_path", str(pkl),
                       "--out", str(artifact), "--batch", "1")
        _, seconds["export_serving"] = _cli_wait(export)
        meta = json.loads(Path(str(artifact) + ".meta.json").read_text())
        served, seconds["serve"] = _cli_wait(start(
            "serve", "--config", str(config), "--artifact", str(artifact), "--out",
            str(work / "preds")))
        tested, seconds["test"] = _cli_wait(test)
        trained, seconds["train"] = _cli_wait(train)
    finally:
        for proc, *_ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if "Bandwidth:" not in trained or "Bandwidth:" not in tested or meta["inference"] != "topk":
        raise AssertionError(f"topk CLIs: no bandwidth printed, or the artifact's mode is "
                             f"{meta['inference']}")
    result = {"seconds": seconds, "test_bandwidth": [l for l in tested.splitlines()
                                                     if l.startswith("Bandwidth:")],
              "served": served.strip().splitlines()[-1]}
    shutil.rmtree(work)
    return result


def model_k4_shapes(cfg: dict) -> tuple:
    """The int8 conv geometries of ``cfg``'s ``activated`` eval at the YAML's
    batch, as ``K4_SHAPES`` lists them (Cin, Cout, side, kernel, stride,
    padding, bias, calls a batch), from one forward on the ``meta`` device."""
    from multiagentperception_tpu_torch.quantize import conv_input_shapes, eligible_convs

    b, n, size = cfg["training"]["batch_size"], cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    with torch.device("meta"):
        model = get_model(cfg, N_CLASSES)
    shapes = conv_input_shapes(model, (b, n, size, size, 3), inference="activated",
                               full_res=False)
    calls: dict = {}
    for name, mod in eligible_convs(model):
        _, cin, side, _ = shapes[name]
        key = (cin, mod.out_channels, side, mod.kernel_size[0], mod.stride[0],
               mod.padding[0], mod.bias is not None)
        calls[key] = calls.get(key, 0) + 1
    return tuple((*key, count) for key, count in sorted(calls.items()))


def run_phase12(records: list) -> dict:
    """The rest of the model surface on the card (the module docstring's
    phase 12); adds each run's K1, K2 and K4 launches to their records."""
    out: dict = {"card": bench._card_line()}
    out["topk"] = run_zoo_config(TOPK_YAML, modes=TOPK_MODES)
    out["topk"]["bandwidth_check"] = topk_bandwidth()
    out["topk"]["clis"] = topk_clis()
    print("phase12 topk " + json.dumps(out["topk"]))
    for name, keys in OVERRIDES.items():
        out[name] = run_zoo_config(FLAGSHIP, f"mrms_when2com_{name}", keys)
        print(f"phase12 {name} " + json.dumps(out[name]))
    out["sparse"] = run_zoo_config(SRMS_WHEN2COM, "srms_when2com_sparse", {"sparse": True},
                                   modes=("activated",))
    print("phase12 sparse " + json.dumps(out["sparse"]))
    out["k2_squeezed"] = checks.check_comm_fusion_squeezed(
        torch.Generator().manual_seed(SEED + 12), "cuda")
    print("phase12 k2_squeezed " + json.dumps(out["k2_squeezed"]))
    segnet_cfg = _config(FLAGSHIP, SEGNET)
    out["int8_segnet"] = run_int8_slice(model_keys=SEGNET, trace=False)
    out["int8_segnet_card_vs_cpu"] = int8_card_vs_cpu(model_keys=SEGNET)
    print("phase12 int8_segnet " + json.dumps([out["int8_segnet"],
                                                out["int8_segnet_card_vs_cpu"]]))
    geometries = {model_k4_shapes(segnet_cfg)}
    for name in ("squeezer2", "squeezer4"):
        geometries.add(model_k4_shapes(_config(FLAGSHIP, OVERRIDES[name])))
    flagship = {g[:7] for g in K4_SHAPES}
    new = sorted({g for shapes in geometries for g in shapes if g[:7] not in flagship})
    (k4_new,) = check_int8_conv(
        torch.Generator().manual_seed(SEED + 41), new, segnet_cfg["training"]["batch_size"] * 6,
        {"f32": torch.float32}, "the SegNet and squeezer overrides' int8 convolutions not "
        "among the flagship's, at batch 2 x 6, each call of a step")
    out["k4_new_geometries"] = k4_new
    print("phase12 k4_new_geometries " + json.dumps(k4_new))

    runs = {name: run for name, run in out.items() if isinstance(run, dict) and "eval" in run}
    by_name = {rec["name"]: rec for rec in records}
    by_name["upsample_argmax"]["phase12_launches"] = {
        name: {mode: row["k1_launches"] for mode, row in run["eval"].items()}
        for name, run in runs.items()}
    by_name["comm_fusion"]["phase12_launches"] = {
        name: {mode: row["k2_launches"] for mode, row in run["eval"].items()}
        for name, run in runs.items()}
    by_name["comm_fusion"]["phase12_squeezed_max_abs_err"] = out["k2_squeezed"]
    by_name["int8_conv"]["phase12_launches"] = {
        "segnet_int8_eval": out["int8_segnet"]["launches"]["int8_conv"]["f32"],
        "segnet_gemm_routes": out["int8_segnet"]["k4_gemm_route_launches"]}
    by_name["int8_conv"]["phase12_shapes"] = k4_new["shapes"]
    return out


# ------------------------------------------------------------------ phase 11

SERVE_BATCH = 8  # the JAX export CLI's default batch (scripts/export_serving.py:38)
SERVE_BATCHES = 3
SERVE_FRAMES = 19  # two full batches of 8 and a ragged tail of 3
SERVE_CLASS_AGREEMENT = 0.9999
SERVE_GRAPH_ATOL = 1e-6
SERVE_TIMED = 10  # CUDA-event runs a timing, after the helper's warm-up
QUANTIZE_NODES = ("aten.round.default", "aten.amax.default", "aten.abs.default")
SERVE_TIMED_FRAMES = 240  # a timed pass of the serve loop: 30 batches of 8
SERVE_TIMED_PASSES = 1  # after the 19-frame pass, which warms the loop up
DISPATCH_PAIRS = 3  # alternated pairs of windows (ops, direct / direct, ops)
DISPATCH_CALLS = 20000  # op calls a window of the hot loop (~0.1-0.3 s)
DISPATCH_AB_REPEATS = 17  # the 6 timed batches 17 times: 102 batches a window (~2 s)


def seeded_images(count: int, b: int, n: int, size: int, seed: int) -> list[torch.Tensor]:
    """``count`` normalized float32 (B, N, H, W, 3) batches on the card."""
    rng = np.random.default_rng(seed)
    return [normalize_images(torch.from_numpy(rng.integers(0, 256, (b, n, size, size, 3),
                                                           dtype=np.uint8))).to("cuda")
            for _ in range(count)]


def op_nodes(artifact) -> dict:
    """The loaded program's ``call_function`` nodes, counted by target."""
    counts: dict[str, int] = {}
    for node in artifact.program.graph.nodes:
        if node.op == "call_function":
            counts[str(node.target)] = counts.get(str(node.target), 0) + 1
    return counts


def hold_serving(name: str, got, want) -> dict:
    """An artifact's (class map, graph, per-frame bandwidth) against the
    eager serving function's on the same batch: class maps on at least
    SERVE_CLASS_AGREEMENT of the pixels (equal expected: the same ops on
    the same card), graphs within SERVE_GRAPH_ATOL, bandwidth equal."""
    result = {"class_agreement": (got[0] == want[0]).float().mean().item(),
              "graph_max_abs_err": (got[1].float() - want[1].float()).abs().max().item(),
              "bandwidth_equal": bool(torch.equal(got[2], want[2]))}
    if result["class_agreement"] < SERVE_CLASS_AGREEMENT or \
            result["graph_max_abs_err"] > SERVE_GRAPH_ATOL or not result["bandwidth_equal"]:
        raise AssertionError(f"serving {name}: the artifact against the eager function {result}")
    return result


def serve_variant(name: str, model, batches, eager, route: str, int8: bool = False,
                  **export_kw) -> tuple[dict, object]:
    """Export ``model`` at the batches' shape on the card, save and load it,
    count its op nodes (one K1, one K2, and two K4 per eligible conv with
    ``int8``), run it over ``batches`` with the launch counts zeroed just
    before and read just after (K1 and K2 once a batch on ``route``, K4
    once per eligible conv a batch), and hold each output to ``eager``'s."""
    from multiagentperception_tpu_torch.export import export_serving, load_serving
    from multiagentperception_tpu_torch.quantize import eligible_convs

    t0 = time.perf_counter()
    blob = export_serving(model, tuple(batches[0].shape), int8=int8, **export_kw)
    export_s = time.perf_counter() - t0
    artifact = load_serving(blob)
    load_s = time.perf_counter() - t0 - export_s
    nodes = op_nodes(artifact)
    convs = len(eligible_convs(model)) if int8 else 0
    want_nodes = {"when2com.upsample_argmax.default": 1, "when2com.comm_fusion.default": 1,
                  "when2com.int8_quantize.default": convs, "when2com.int8_gemm.default": convs}
    got_nodes = {k: nodes.get(k, 0) for k in want_nodes}
    quantizing = {k: nodes[k] for k in QUANTIZE_NODES if k in nodes}
    if got_nodes != want_nodes or (int8 and export_kw.get("act_scales") and quantizing):
        raise AssertionError(f"serving {name}: op nodes {got_nodes} (want {want_nodes}), "
                             f"quantizing nodes {quantizing}")
    hot = export_kw.get("bake_weights") is False
    state = {k: v.detach() for k, v in model.state_dict().items()}
    kernels = (k1.upsample_argmax, k2.comm_fusion, k4.int8_conv)
    bench._zero_launches(kernels)
    outs = [artifact(state, x) if hot else artifact(x) for x in batches]
    torch.cuda.synchronize()
    counts = {kern.__name__: dict(kern.route_launches) for kern in kernels}
    want = {"upsample_argmax": {route: len(batches)}, "comm_fusion": {route: len(batches)},
            "int8_conv": {route: convs * len(batches)} if int8 else {}}
    for kname, total in want.items():
        if counts[kname] != {**dict.fromkeys(counts[kname], 0), **total}:
            raise AssertionError(f"serving {name}: {kname} launched {counts[kname]}, "
                                 f"want {total}")
    agreement = [hold_serving(name, got, eager(x)) for got, x in zip(outs, batches)]
    return {"export_s": export_s, "load_s": load_s, "artifact_mb": len(blob) / 1e6,
            "op_nodes": got_nodes, "quantizing_nodes": quantizing, "launches": counts,
            "agreement": agreement}, artifact


def run_serving() -> dict:
    """Phase 11: the serving export of the flagship at batch 8 (float32,
    bf16, int8 with calibrated scales, and the weight-hotswap variant with
    two weight sets), the serve loop over 19 in-memory frames, the times,
    and the ops' dispatch cost."""
    from multiagentperception_tpu_torch import serve
    from multiagentperception_tpu_torch.export import export_serving, load_serving, make_eval_fn
    from multiagentperception_tpu_torch.quantize import calibrate_activations, make_int8_eval_fn

    cfg = load_config(str(FLAGSHIP))
    n, size = cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    batches = seeded_images(SERVE_BATCHES, SERVE_BATCH, n, size, SEED + 50)
    model = init_weights(get_model(cfg, N_CLASSES), SEED).to("cuda").eval()
    out = {"config": FLAGSHIP.relative_to(ROOT).as_posix(), "batch": SERVE_BATCH,
           "agents": n, "size": size}
    eager32 = make_eval_fn(model)
    out["float32"], art32 = serve_variant("float32", model, batches, eager32, "f32")

    cfg16 = copy.deepcopy(cfg)
    cfg16["model"]["dtype"] = "bfloat16"
    model16 = get_model(cfg16, N_CLASSES).to("cuda").eval()
    model16.load_state_dict(model.state_dict())
    out["bfloat16"], _ = serve_variant("bfloat16", model16, batches, make_eval_fn(model16),
                                       "bf16")
    del model16

    calib = seeded_images(2, SERVE_BATCH, n, size, SEED + 51)
    scales = calibrate_activations(model, calib, inference="activated", full_res=False)
    eager8 = make_int8_eval_fn(model, act_scales=scales)
    out["int8"], art8 = serve_variant("int8", model, batches, eager8, "f32", int8=True,
                                      act_scales=scales)

    # the weight-hotswap artifacts, float32 and int8 (the weights quantized
    # in the graph): one program each, two weight sets
    shape = tuple(batches[0].shape)
    hot = {"float32": load_serving(export_serving(model, shape, bake_weights=False)),
           "int8": load_serving(export_serving(model, shape, bake_weights=False, int8=True,
                                               act_scales=scales))}
    swaps = {name: [] for name in hot}
    for seed in (SEED + 52, SEED + 53):
        other = init_weights(get_model(cfg, N_CLASSES), seed).to("cuda").eval()
        state = {k: v.detach() for k, v in other.state_dict().items()}
        eager = {"float32": make_eval_fn(other),
                 "int8": make_int8_eval_fn(other, act_scales=scales)}
        for name, art in hot.items():
            swaps[name].append(hold_serving(f"{name} hotswap seed {seed}",
                                            art(state, batches[0]), eager[name](batches[0])))
        del other
    out["hotswap"] = swaps

    # the serve loop over in-memory frames, the tail padded by repetition
    frames = torch.cat(seeded_images(3, SERVE_BATCH, n, size, SEED + 54))[:SERVE_FRAMES].cpu()
    dataset = [(f.numpy(),) for f in frames]
    serve_dir = WORK / "serve"
    shutil.rmtree(serve_dir, ignore_errors=True)
    stats = serve.serve_dataset(art32, dataset, str(serve_dir), device="cuda", split="smoke")
    per_frame = []
    for i in range(0, SERVE_FRAMES, SERVE_BATCH):
        chunk = frames[i:i + SERVE_BATCH]
        real = len(chunk)
        chunk = torch.cat([chunk, chunk[-1:].expand(SERVE_BATCH - real, *chunk.shape[1:])])
        per_frame.append(eager32(chunk.to("cuda"))[2][:real].cpu())
    per_frame = torch.cat(per_frame)
    want_bw = sum(float(per_frame[i:i + SERVE_BATCH].numpy().sum())  # as serve sums
                  for i in range(0, SERVE_FRAMES, SERVE_BATCH)) / SERVE_FRAMES
    maps = sorted(p.name for p in serve_dir.iterdir() if not p.name.endswith("_rgb.png"))
    if stats["maps"] != SERVE_FRAMES * n or len(maps) != SERVE_FRAMES * n or \
            stats["bandwidth"] != want_bw:
        raise AssertionError(f"serve loop: {stats['maps']} maps ({len(maps)} files), bandwidth "
                             f"{stats['bandwidth']} against the eager {want_bw}")
    out["serve_loop"] = {k: stats[k] for k in ("frames", "maps", "bandwidth")}
    out["serve_loop"].update(eager_bandwidth=want_bw, files=len(maps),
                             file_kind=Path(maps[0]).suffix)
    # the loop's rate: passes over SERVE_TIMED_FRAMES frames (the 19 in turn),
    # after the pass above has warmed it up
    cyclic = [dataset[i % SERVE_FRAMES] for i in range(SERVE_TIMED_FRAMES)]
    out["serve_timed"] = []
    for k in range(SERVE_TIMED_PASSES):
        shutil.rmtree(serve_dir, ignore_errors=True)
        with contextlib.redirect_stdout(io.StringIO()):
            stats = serve.serve_dataset(art32, cyclic, str(serve_dir), device="cuda",
                                        split="smoke")
        out["serve_timed"].append({k: stats[k] for k in ("frames", "maps", "seconds",
                                                        "frames_per_s", "maps_per_s")})
    shutil.rmtree(serve_dir, ignore_errors=True)

    # times at batch 8 by CUDA events: the artifact, the eager function, int8
    x = batches[0]
    times = {"artifact_f32": _time_ms(lambda: art32(x), iters=SERVE_TIMED),
             "eager_f32": _time_ms(lambda: eager32(x), iters=SERVE_TIMED),
             "artifact_int8": _time_ms(lambda: art8(x), iters=SERVE_TIMED),
             "eager_int8": _time_ms(lambda: eager8(x), iters=SERVE_TIMED)}
    out["batch_ms"] = times
    out["frames_per_s"] = {k: SERVE_BATCH / (ms / 1e3) for k, ms in times.items()}
    out["dispatch_us"] = dispatch_cost()
    out["dispatch_ab"] = dispatch_ab()
    return out


@contextlib.contextmanager
def direct_launches():
    """The wrappers call each op's CUDA implementation directly instead of
    through the dispatcher: the other side of ``dispatch_ab`` only."""
    saved = k1.OP, k2.OP, k4.QUANTIZE_OP, k4.GEMM_OP
    k1.OP, k2.OP, k4.QUANTIZE_OP, k4.GEMM_OP = (k1._launch, k2._launch, k4._quantize_launch,
                                                k4._gemm_launch)
    try:
        yield
    finally:
        k1.OP, k2.OP, k4.QUANTIZE_OP, k4.GEMM_OP = saved


def dispatch_ab() -> dict:
    """What the dispatcher costs end to end where the host bounds the
    step: the flagship's int8 eval through ``Evaluator`` at the YAML's batch
    (phase 10's path: 98 op calls a batch), frames/s over windows of 102
    batches, DISPATCH_PAIRS pairs alternated (ops, direct / direct, ops),
    through the ops and with their CUDA implementations called directly."""
    cfg = load_config(str(FLAGSHIP))
    b, n, size = cfg["training"]["batch_size"], cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    ev = Evaluator(cfg, graphs=False)  # the dispatcher runs only in the eager step
    ev.model.load_state_dict(init_weights(get_model(cfg, N_CLASSES), SEED).state_dict())
    batches = seeded_batches(INT8_EVAL_BATCHES + INT8_CALIB_BATCHES, b, n, size, SEED + 55)
    calib, timed = batches[:INT8_CALIB_BATCHES], batches[INT8_CALIB_BATCHES:]
    scales = ev._calibrate_int8(timed, "activated", calib_loader=calib)
    window = timed * DISPATCH_AB_REPEATS
    rates: dict[str, list[float]] = {"ops": [], "direct": []}
    seconds = []
    with Int8Convs(ev.model, scales), contextlib.redirect_stdout(io.StringIO()):
        ev.evaluate(timed)  # warm-up
        for pair in range(DISPATCH_PAIRS):
            for kind in ("ops", "direct") if pair % 2 == 0 else ("direct", "ops"):
                with direct_launches() if kind == "direct" else contextlib.nullcontext():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ev.evaluate(window)
                    torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                rates[kind].append(len(window) * b * n / seconds[-1])
    ratios = [o / d for o, d in zip(rates["ops"], rates["direct"])]
    return {"batch": b, "batches_a_window": len(window), "window_s": [min(seconds), max(seconds)],
            "int8_eval_frames_per_s": rates,
            "median": {k: float(np.median(v)) for k, v in rates.items()},
            "ops_over_direct": {"pairs": ratios, "median": float(np.median(ratios)),
                                "min": min(ratios), "max": max(ratios)}}


def dispatch_cost(calls: int = DISPATCH_CALLS) -> dict:
    """Host time per call, in microseconds, of each op through the
    dispatcher (``torch.ops.when2com.*``, as the wrappers and an artifact
    call it) and of its CUDA implementation called directly, on inputs so
    small that the host bounds the loop, under ``torch.inference_mode`` as
    the evaluator and the artifact run: DISPATCH_PAIRS pairs of windows
    alternated. The median difference is what the dispatcher adds to a
    call; the pairs' differences give its spread."""
    x1 = torch.randn(2, 11, 4, 4, device="cuda")
    q = torch.randn(1, 2, 8, device="cuda")
    v = torch.randn(1, 2, 4, 4, 4, device="cuda")
    x4 = torch.randn(1, 16, 8, 8, device="cuda")
    w4 = k4.prepare_weight(torch.randn(16, 16, 3, 3, device="cuda"))
    s4 = k4.dynamic_scale(x4)
    g4 = k4.plan(1, 16, 8, 8, 16, 3, 3, 1, 1)
    xq = k4.quantize_scratch(x4, s4, g4)
    op, direct = {}, {}
    op["upsample_argmax"] = lambda: torch.ops.when2com.upsample_argmax(x1, 8, 8)
    direct["upsample_argmax"] = lambda: k1._launch(x1, 8, 8)
    op["comm_fusion"] = lambda: torch.ops.when2com.comm_fusion(q, q, v, "activated", 0.0, 0.2)
    direct["comm_fusion"] = lambda: k2._launch(q, q, v, "activated", 0.0, 0.2)
    op["int8_quantize"] = lambda: torch.ops.when2com.int8_quantize(x4, s4, "halo", 16)
    direct["int8_quantize"] = lambda: k4._quantize_launch(x4, s4, "halo", 16)
    gemm = (xq, w4.packed, w4.s_w, s4, None, 16, 3, 3, 8, 8, 1, 1, torch.float32)
    op["int8_gemm"] = lambda: torch.ops.when2com.int8_gemm(*gemm)
    direct["int8_gemm"] = lambda: k4._gemm_launch(*gemm)

    def per_call(fn) -> float:
        with torch.inference_mode():
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    out = {}
    for name in op:
        us = {"op": [], "direct": []}
        for pair in range(DISPATCH_PAIRS):
            for kind in ("op", "direct") if pair % 2 == 0 else ("direct", "op"):
                us[kind].append(per_call(op[name] if kind == "op" else direct[name]))
        diffs = [o - d for o, d in zip(us["op"], us["direct"])]
        out[name] = {"op_us": float(np.median(us["op"])),
                     "direct_us": float(np.median(us["direct"])),
                     "dispatch_us": float(np.median(diffs)),
                     "dispatch_us_range": [min(diffs), max(diffs)]}
    return out


# ------------------------------------------------------------------ phase 13

GRAPH_K = 4  # training.steps_per_call of phase 13's graph run
GRAPH_ITERS = 24
GRAPH_BAD_ITER = 7  # the injected non-finite step: a replay in the second chunk
GRAPH_PROFILE = (8, 12)  # training.profile_range: the chunks 5-8 and 9-12
GRAPH_EVAL_BATCHES = 16  # a timed window
GRAPH_PAIRS = 3  # alternated pairs of windows (graph, eager / eager, graph)
MARK = 249  # a label value that makes its step's loss non-finite (the loss clears it)


def _marked_loss(cfg):
    """The config's loss, times inf where the target holds MARK (which is
    then ignored like 250): a non-finite step for ``nan_guard``."""
    base = get_loss_function(cfg)

    def loss_fn(input, target):
        hit = (target == MARK).any()
        clean = torch.where(target == MARK, 250, target)
        return base(input=input, target=clean) * torch.where(hit, torch.inf, 1.0)

    return loss_fn


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms and PyTorch's deterministic mode
    (TF32 off), restored after."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with _no_tf32():
            yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def _graph_trainer(cfg, batches, val, name: str, k: int, graphs: bool = True,
                   **training) -> Trainer:
    run_cfg = copy.deepcopy(cfg)
    run_cfg["training"].update({"train_iters": GRAPH_ITERS, "val_interval": GRAPH_ITERS,
                                "print_interval": 1, "steps_per_call": k,
                                "device_prefetch": 2, "nan_guard": 2, **training})
    return Trainer(run_cfg, logging.getLogger("chip_smoke"), _marked_loss(run_cfg), batches,
                   val, device="cuda", logdir=str(WORK / f"graph_{name}"), graphs=graphs)


def graph_training() -> dict:
    """The flagship trains GRAPH_ITERS iterations through ``Trainer.train``
    with ``steps_per_call`` GRAPH_K (CUDA graph replays), ``device_prefetch``
    2, ``nan_guard`` 2 with iteration GRAPH_BAD_ITER's loss non-finite,
    ``profile_dir`` over GRAPH_PROFILE and the watchdog on; then the same
    from the same weights with K = 1 eager steps. Both drop the bad step
    (the guard's counters) and the graph's replay of it leaves every
    parameter as it was; the trace holds the profiled chunks' replays and
    their kernels. ms a step over the iterations after the traced range
    (13-24) and the peak device memory of each. Then the correctness
    check, in deterministic mode (training on the card is not reproducible
    without it), both optimizers capturable from the start: the first two
    chunks (8 iterations, the bad step among them) by graph replays against
    K = 4 eager steps (``graphs=False``): losses, parameters, BatchNorm
    statistics and optimizer state bit for bit, so within phase 6's bounds."""
    from multiagentperception_tpu_torch import graphs as graphs_mod
    from multiagentperception_tpu_torch.optimizers import lr_tensor, make_capturable

    cfg = load_config(str(FLAGSHIP))
    b, n, size = cfg["training"]["batch_size"], cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    batches = seeded_batches(GRAPH_ITERS, b, n, size, SEED + 60)
    batches[GRAPH_BAD_ITER - 1][1][0, 0, 0, 0] = MARK
    val = seeded_batches(2, b, n, size, SEED + 61)
    state = init_weights(get_model(cfg, N_CLASSES), SEED).state_dict()
    prof_dir = WORK / "graph_profile"
    shutil.rmtree(prof_dir, ignore_errors=True)
    replay = graphs_mod.Graph.replay
    out = {"config": FLAGSHIP.relative_to(ROOT).as_posix(), "batch": b, "agents": n,
           "size": size, "iterations": GRAPH_ITERS, "steps_per_call": GRAPH_K}
    for name, k in (("graph", GRAPH_K), ("eager", 1)):
        trainer = _graph_trainer(cfg, batches, val, name, k, watchdog_secs=600,
                                 profile_dir=str(prof_dir) if k > 1 else None,
                                 profile_range=list(GRAPH_PROFILE))
        trainer.model.load_state_dict(state)
        dropped = {}

        def watched_replay(graph, trainer=trainer, dropped=dropped):
            if trainer.step + 1 != GRAPH_BAD_ITER:
                return replay(graph)
            before = [p.detach().clone() for p in trainer.model.parameters()]
            replay(graph)
            dropped["unmoved"] = all(torch.equal(a, p) for a, p in
                                     zip(before, trainer.model.parameters()))

        graphs_mod.Graph.replay = watched_replay
        torch.cuda.reset_peak_memory_stats()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                trainer.train()
        finally:
            graphs_mod.Graph.replay = replay
        torch.cuda.synchronize()
        losses = [trainer.loss_history[i] for i in range(1, GRAPH_ITERS + 1)]
        timed = trainer.iter_seconds[GRAPH_PROFILE[1]:]  # after the capture and the trace
        guard = {**trainer.guard.state_dict(), "applied": trainer._applied_count()}
        out[name] = {"ms_per_step": float(np.mean(timed)) * 1e3,
                     "ms_per_step_median": float(np.median(timed)) * 1e3,
                     "first_chunk_ms_per_step": float(np.mean(trainer.iter_seconds[:GRAPH_K]))
                     * 1e3, "peak_device_bytes": torch.cuda.max_memory_allocated(),
                     "losses": losses, "nan_guard": guard}
        others = [v for i, v in enumerate(losses) if i != GRAPH_BAD_ITER - 1]
        if guard != {"notfinite_count": 0, "last_finite": True, "total_notfinite": 1,
                     "applied": GRAPH_ITERS - 1} or trainer.step != GRAPH_ITERS or \
                np.isfinite(losses[GRAPH_BAD_ITER - 1]) or not np.all(np.isfinite(others)):
            raise AssertionError(f"graph training {name}: {guard}, losses {losses}")
        if (trainer._train_graph is not None) != (k > 1):
            raise AssertionError(f"graph training {name}: graph {trainer._train_graph}")
        if k > 1 and dropped.get("unmoved") is not True:
            raise AssertionError(f"graph training: the dropped step's replay {dropped}")
        del trainer
        shutil.rmtree(WORK / f"graph_{name}", ignore_errors=True)
    out["k4_over_k1_ms"] = out["graph"]["ms_per_step"] / out["eager"]["ms_per_step"]

    (trace,) = list(prof_dir.iterdir())
    events = json.loads(trace.read_text())["traceEvents"]
    replays = sorted({int(e["name"].split()[1]) for e in events  # host and device ranges
                      if e.get("name", "").startswith("train_replay ")})
    kernels = [e for e in events if e.get("cat") == "kernel"]
    want = list(range(GRAPH_PROFILE[0] - GRAPH_K + 1, GRAPH_PROFILE[1] + 1))
    if replays != want or not kernels:
        raise AssertionError(f"graph training trace: replays {replays} (want {want}), "
                             f"{len(kernels)} kernels")
    out["trace"] = {"file": trace.name, "replays": replays, "kernels": len(kernels),
                    "bytes": trace.stat().st_size}

    exact = {}
    for graphs in (True, False):
        trainer = _graph_trainer(cfg, batches, val, f"exact_{graphs}", GRAPH_K, graphs=graphs,
                                 train_iters=2 * GRAPH_K, watchdog_secs=0)
        trainer.model.load_state_dict(state)
        make_capturable(trainer.optimizer, lr_tensor(cfg["training"]["optimizer"]["lr"], "cuda"))
        with _deterministic(), contextlib.redirect_stdout(io.StringIO()):
            trainer.train()
        exact[graphs] = {"losses": [trainer.loss_history[i] for i in range(1, 2 * GRAPH_K + 1)],
                         "state": {k_: v.detach().cpu() for k_, v in
                                   trainer.model.state_dict().items()},
                         "opt": [t.detach().cpu() for st in trainer.optimizer.state.values()
                                 for t in st.values() if isinstance(t, torch.Tensor)],
                         "replayed": trainer._train_graph is not None}
        del trainer
        shutil.rmtree(WORK / f"graph_exact_{graphs}", ignore_errors=True)
    g, e = exact[True], exact[False]
    differ = [k_ for k_, v in e["state"].items() if not torch.equal(g["state"][k_], v)]
    opt_equal = len(g["opt"]) == len(e["opt"]) and all(
        torch.equal(x, y) for x, y in zip(g["opt"], e["opt"]))
    if not g["replayed"] or e["replayed"] or g["losses"] != e["losses"] or differ or \
            not opt_equal:
        raise AssertionError(f"graph training, deterministic: losses {g['losses']} / "
                             f"{e['losses']}, {len(differ)} tensors differ ({differ[:3]}), "
                             f"optimizer state equal {opt_equal}")
    out["deterministic_two_chunks"] = {"bitwise_equal": True, "losses": g["losses"],
                                       "tensors": len(e["state"])}
    return out


def confusion_matrix_ms() -> dict:
    """The capture-safe confusion matrix (a scatter-add into per-row bins)
    against the ``torch.bincount`` form it replaced, CUDA-event ms a call
    at the eval's (12 x 512 x 512) and the bench's (120 x 512 x 512) sizes."""
    from multiagentperception_tpu_torch.ops.comm import confusion_matrix

    def bincount_form(t, p, c):
        t, p = t.reshape(t.shape[0], -1).long(), p.reshape(p.shape[0], -1).long()
        valid = (t >= 0) & (t < c)
        idx = torch.where(valid, t * c + p.clamp(0, c - 1), torch.full_like(t, c * c))
        return torch.bincount(idx.reshape(-1), minlength=c * c + 1)[: c * c].reshape(c, c)

    out = {}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for frames in (12, 120):
        y = torch.randint(0, 11, (frames, 512, 512), device="cuda", generator=g,
                          dtype=torch.uint8)
        y[:, ::7] = 250
        pred = torch.randint(0, 11, (frames, 512, 512), device="cuda", generator=g,
                             dtype=torch.int32)
        new = confusion_matrix(y, pred, N_CLASSES)
        if not torch.equal(new, bincount_form(y, pred, N_CLASSES)):
            raise AssertionError("confusion_matrix differs from its bincount form")
        out[f"frames_{frames}"] = {
            "scatter_ms": _time_ms(lambda: confusion_matrix(y, pred, N_CLASSES)),
            "bincount_ms": _time_ms(lambda: bincount_form(y, pred, N_CLASSES))}
    return out


def _graph_eval_runs(evs: dict, batches) -> dict:
    """One pass of each evaluator over ``batches`` keeping the class maps;
    the results on the host and K1, K2 and K4's launches."""
    out = {}
    for graphs, ev in evs.items():
        bench._zero_launches((k1.upsample_argmax, k2.comm_fusion, k4.int8_conv))
        res = [{k: v.cpu() for k, v in r.items()}
               for r, _ in ev._pipelined(batches, keep_pred=True)]
        torch.cuda.synchronize()
        out[graphs] = {"res": res, "launches": {
            kern.__name__: kern.launches
            for kern in (k1.upsample_argmax, k2.comm_fusion, k4.int8_conv)}}
    return out


def graph_eval(kind: str) -> dict:
    """The flagship's ``activated`` eval at the YAML's batch through
    ``Evaluator.evaluate``, with CUDA graphs and eagerly
    (``Evaluator(graphs=False)``), ``kind`` float32, bfloat16, float16 or int8
    (float32 network, static scales from INT8_CALIB_BATCHES held-out
    batches, both evaluators under an ``Int8Convs`` swap). Checks: over the window's
    batches the class maps, confusion matrices, actions and bandwidth
    equal bit for bit, and under replay K1 and K2 launch once a batch and K4
    once per swapped conv (48 a batch). Then GRAPH_PAIRS alternated pairs
    of windows timed (frames/s each), and one window of each traced: the
    busy share (traced device time over the median untraced window), and
    the graph's trace holding K1, K2 (and K4) launches inside its replays."""
    from torch.profiler import ProfilerActivity, profile

    cfg = load_config(str(FLAGSHIP))
    if kind in ("bfloat16", "float16"):
        cfg["model"]["dtype"] = kind
    b, n, size = cfg["training"]["batch_size"], cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    state = init_weights(get_model(cfg, N_CLASSES), SEED).state_dict()
    batches = seeded_batches(GRAPH_EVAL_BATCHES + INT8_CALIB_BATCHES, b, n, size, SEED + 70)
    calib, window = batches[:INT8_CALIB_BATCHES], batches[INT8_CALIB_BATCHES:]
    evs = {True: Evaluator(cfg), False: Evaluator(cfg, graphs=False)}
    for ev in evs.values():
        ev.model.load_state_dict(state)
    swaps = [contextlib.nullcontext()] * 2
    if kind == "int8":
        scales = evs[False]._calibrate_int8(window, "activated", calib_loader=calib)
        swaps = [Int8Convs(ev.model, scales) for ev in evs.values()]
    kernels = (k1.upsample_argmax, k2.comm_fusion, k4.int8_conv)
    with swaps[0], swaps[1], contextlib.redirect_stdout(io.StringIO()):
        torch.cuda.reset_peak_memory_stats()
        runs = _graph_eval_runs(evs, window)
        peak = torch.cuda.max_memory_allocated()
        for r_graph, r_eager in zip(runs[True]["res"], runs[False]["res"]):
            for key, value in r_eager.items():
                if not torch.equal(r_graph[key], value):
                    raise AssertionError(f"graph eval {kind}: {key} differs from eager")
        per_batch = {"upsample_argmax": 1, "comm_fusion": 1,
                     "int8_conv": 48 if kind == "int8" else 0}
        for graphs, run in runs.items():
            want = {k_: v * len(window) for k_, v in per_batch.items()}
            if run["launches"] != want:
                raise AssertionError(f"graph eval {kind} (graphs={graphs}): launches "
                                     f"{run['launches']}, want {want}")
        for ev in evs.values():  # evaluate's own key: its warm-up and capture
            ev.evaluate(window[:2])
        rates: dict[str, list[float]] = {"graph": [], "eager": []}
        seconds: dict[str, list[float]] = {"graph": [], "eager": []}
        for pair in range(GRAPH_PAIRS):
            for name in ("graph", "eager") if pair % 2 == 0 else ("eager", "graph"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                evs[name == "graph"].evaluate(window)
                torch.cuda.synchronize()
                seconds[name].append(time.perf_counter() - t0)
                rates[name].append(len(window) * b * n / seconds[name][-1])
        busy, traced = {}, {}
        for name in ("graph", "eager"):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                evs[name == "graph"].evaluate(window)
                torch.cuda.synchronize()
            events = _device_events(prof)
            device_ms = sum(e.self_device_time_total for e in events) / 1e3
            busy[name] = device_ms / (float(np.median(seconds[name])) * 1e3)
            traced[name] = {kern.__name__: sum(e.count for e in events
                                               if f"{kern.__name__}_kernel" in e.key)
                            for kern in kernels}
            if name == "graph":
                launches = sum(e.count for e in prof.key_averages() if e.key == "cudaGraphLaunch")
                traced[name]["cudaGraphLaunch"] = launches
                (WORK / f"profile_graph_eval_{kind}.txt").write_text(
                    prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    need = [k_ for k_, v in per_batch.items() if v and not traced["graph"][k_]]
    if need or not traced["graph"]["cudaGraphLaunch"]:
        raise AssertionError(f"graph eval {kind}: the trace of the replays lacks {need}: "
                             f"{traced['graph']}")
    ratios = [g / e for g, e in zip(rates["graph"], rates["eager"])]
    return {"kind": kind, "batch": b, "agents": n, "size": size, "batches": len(window),
            "launches_per_batch": per_batch, "frames_per_s": rates,
            "median_frames_per_s": {k_: float(np.median(v)) for k_, v in rates.items()},
            "graph_over_eager": {"pairs": ratios, "median": float(np.median(ratios)),
                                 "min": min(ratios), "max": max(ratios)},
            "busy_share": busy, "traced_launches": traced, "peak_device_bytes": peak,
            "bandwidth": evs[True].last_eval_metrics.get_avg_bandW()}


def run_phase13(records: list) -> dict:
    """Phase 13: the trainer's keys (graph_training) and the eval graphs in
    float32, bf16 and int8 (graph_eval); adds each kernel's launches a batch
    under replay to its record."""
    out = {"train": graph_training()}
    print("graph_train " + json.dumps(out["train"]))
    out["eval"] = {kind: graph_eval(kind) for kind in ("float32", "bfloat16", "int8")}
    print("graph_eval " + json.dumps(out["eval"]))
    out["confusion_matrix_ms"] = confusion_matrix_ms()
    print("confusion_matrix_ms " + json.dumps(out["confusion_matrix_ms"]))
    by_record = {"upsample_argmax": ("float32", "upsample_argmax"),
                 "comm_fusion": ("float32", "comm_fusion"),
                 "upsample_argmax_bf16": ("bfloat16", "upsample_argmax"),
                 "comm_fusion_bf16": ("bfloat16", "comm_fusion"),
                 "int8_conv": ("int8", "int8_conv")}
    for rec in records:
        if rec["name"] in by_record:
            kind, kern = by_record[rec["name"]]
            ev = out["eval"][kind]
            rec["graph_launches_per_batch"] = ev["launches_per_batch"][kern]
            rec["graph_traced_launches"] = ev["traced_launches"]["graph"][kern]
    return out


# ------------------------------------------------------------------ phase 14

LOADER_SIZE = 512  # the flagship's frames
LOADER_FRAMES = 8  # frames in each of the fixture's 2 train trajectories
LOADER_WORKERS = 4
STREAM_FRAME, STREAM_SIZE = 160, 128  # fixture side, and the random crop the model sees
STREAM_ITERS, STREAM_CUT = 12, 6
STREAM_AUGS = {"hflip": 0.5, "rcrop": STREAM_SIZE, "brightness": 0.3}
NOISY_SIZE = 256


def decoders() -> dict:
    """Which PNG decoders this host has, and its CPU count."""
    from multiagentperception_tpu_torch import native

    out = {"cpu_count": os.cpu_count(), "cpus_usable": len(os.sched_getaffinity(0))}
    try:
        import cv2

        out["cv2"] = cv2.__version__
    except ImportError as err:
        out["cv2"] = f"does not import: {err}"
    try:
        native.load()
        out["native"] = f"builds and loads: {native.library_path().relative_to(ROOT)}"
    except native.NativeBuildError as err:
        out["native"] = f"does not build: {str(err)[-600:]}"
    except OSError as err:
        out["native"] = f"builds, does not load: {err}"
    return out


def _fingerprinting_chunks(trainer, prints: list) -> None:
    """Record, on the device, a fingerprint of each batch the train step
    consumes (its images and labels, position-weighted int64 sums), taken
    from the chunk ``_chunk`` is handed, whether it runs eagerly or as
    graph replays."""
    chunk = trainer._chunk

    def fingerprinted(xs, ys, k, graph):
        for j in range(k):
            x, y = xs[j].reshape(-1).long(), ys[j].reshape(-1).long()
            wx = torch.arange(x.numel(), device=x.device) % 1009 + 1
            wy = torch.arange(y.numel(), device=y.device) % 1013 + 1
            prints.append(torch.stack([(x * wx).sum(), (y * wy).sum()]))
        return chunk(xs, ys, k, graph)

    trainer._chunk = fingerprinted


def _stream_trainer(root: str, logdir: Path, cache: str, train_iters: int,
                    resume: str | None = None):
    """The flagship (its widths, ``STREAM_SIZE``²) over a shuffled
    ``GrainLoader`` with 2 worker processes, augmentations and the cache,
    ``device_prefetch`` 2, ``steps_per_call`` 2 (graph replays)."""
    from multiagentperception_tpu_torch.data import AirsimDataset, get_composed_augmentations
    from multiagentperception_tpu_torch.data.grain_pipeline import GrainLoader

    cfg = load_config(str(FLAGSHIP))
    cfg["data"].update(img_rows=STREAM_SIZE, img_cols=STREAM_SIZE, path=root,
                       on_device_normalize=True, cache_decoded=cache)
    cfg["training"].update(train_iters=train_iters, val_interval=STREAM_ITERS,
                           save_interval=STREAM_CUT, print_interval=STREAM_ITERS,
                           device_prefetch=2, steps_per_call=2, data_backend="grain",
                           grain_workers=2, augmentations=STREAM_AUGS, resume=resume)
    common = dict(root=root, target_view="6agent", commun_label="mimo", raw_images=True,
                  cache_decoded=cache, seed=SEED)
    train = GrainLoader(AirsimDataset(split="train", augmentations=get_composed_augmentations(
        STREAM_AUGS), **common), 2, shuffle=True, drop_last=True, num_workers=2, seed=SEED)
    val = GrainLoader(AirsimDataset(split="val", augmentations=get_composed_augmentations(
        {"ccrop": STREAM_SIZE}), **common), 2)
    trainer = Trainer(cfg, logging.getLogger("chip_smoke"), get_loss_function(cfg), train, val,
                      device="cuda", logdir=str(logdir))
    init_weights(trainer.model, SEED)
    prints: list = []
    _fingerprinting_chunks(trainer, prints)
    return trainer, prints


def stream_resume() -> dict:
    """``Trainer`` with the loader's keys at once: 12 iterations in one run,
    then 6, ``latest`` saved, and a fresh ``Trainer`` resumed to 12; the
    batches the steps consume must be equal, and the checkpoint must hold
    the consumed position."""
    from multiagentperception_tpu_torch.data.synthetic import generate_fixture

    work = WORK / "stream"
    shutil.rmtree(work, ignore_errors=True)
    root = str(work / "data")
    # 8 train frames: 4 batches an epoch, so the cut falls inside the second
    generate_fixture(root, target_view="6agent", img_size=STREAM_FRAME, frames_per_traj=4)
    seconds: dict = {}

    def run(name: str, logdir: Path, iters: int, resume: str | None = None) -> tuple:
        t0 = time.perf_counter()
        trainer, prints = _stream_trainer(root, logdir, str(work / "cache"), iters, resume)
        try:
            with open(work / f"{name}.log", "w") as log, contextlib.redirect_stdout(log):
                trainer.train()
        finally:
            trainer.trainloader.shutdown()
        seconds[name] = time.perf_counter() - t0
        return trainer, [p.tolist() for p in prints]

    _, whole = run("whole", work / "whole", STREAM_ITERS)
    _, cut = run("cut", work / "cut", STREAM_CUT)
    (latest,) = (work / "cut").glob("*_latest.pkl")
    stream = torch.load(latest, map_location="cpu", weights_only=True)["data_stream"]
    trainer, after = run("resumed", work / "cut", STREAM_ITERS, str(latest))
    resumed = cut + after
    batches_an_epoch = len(trainer.trainloader)
    epoch = (STREAM_CUT - 1) // batches_an_epoch
    want_stream = {"seed": SEED, "epoch": epoch,
                   "consumed": STREAM_CUT - epoch * batches_an_epoch}
    if resumed != whole or len(resumed) != STREAM_ITERS or stream != want_stream:
        raise AssertionError(f"stream resume: whole {whole}, cut then resumed "
                             f"{resumed}; checkpointed {stream}, want {want_stream}")
    shutil.rmtree(work)
    return {"size": STREAM_SIZE, "iterations": STREAM_ITERS, "cut_at": STREAM_CUT,
            "batches_an_epoch": batches_an_epoch, "checkpointed_stream": stream,
            "equal_batches": True, "distinct_batches": len({tuple(p) for p in resumed}),
            "seconds": seconds}


def _capturing_predictions(sink: dict):
    """A context in which every ``Evaluator._pipelined`` pass also returns
    its class maps (``keep_pred``): they and the evaluator go to ``sink``."""
    original = Evaluator._pipelined

    def pipelined(self, loader, **kw):
        sink["evaluator"] = self
        for res, cl in original(self, loader, keep_pred=True, **kw):
            sink.setdefault("preds", []).append(res["pred"].cpu())
            yield res, cl

    @contextlib.contextmanager
    def patched():
        Evaluator._pipelined = pipelined
        try:
            yield
        finally:
            Evaluator._pipelined = original

    return patched()


@_no_tf32()
def noisy_test_cli() -> dict:
    """The ``test`` CLI on the flagship YAML at ``NOISY_SIZE``² with
    ``noisy_type: occlusion`` and the cache, seeded weights from one
    ``.pkl``, on the card and on the CPU (TF32 off): class maps on at least
    99.9% of pixels, bandwidth equal, K1 and K2 launched exactly as
    ``_expected_launches`` says on the card."""
    import yaml

    from multiagentperception_tpu_torch import test as test_cli
    from multiagentperception_tpu_torch.data.synthetic import generate_fixture

    work = WORK / "noisy"
    shutil.rmtree(work, ignore_errors=True)
    root = str(work / "data")
    generate_fixture(root, target_view="6agent", img_size=NOISY_SIZE, frames_per_traj=4,
                     n_train=1, n_val=1, n_test=1)
    cfg = yaml.safe_load(FLAGSHIP.read_text())
    cfg["data"].update(path=root, img_rows=NOISY_SIZE, img_cols=NOISY_SIZE,
                       noisy_type="occlusion", cache_decoded=str(work / "cache"))
    cfg["training"]["n_workers"] = 2
    yml = work / "noisy.yml"
    yml.write_text(yaml.safe_dump(cfg))
    pkl = work / "seed.pkl"
    model = init_weights(get_model(load_config(str(yml)), N_CLASSES), SEED + 14)
    torch.save({"epoch": 0, "model_state": model.state_dict(), "best_iou": 0.0}, pkl)
    runs = {}
    for dev in ("cuda", "cpu"):
        sink: dict = {}
        k1.upsample_argmax.launches = k2.comm_fusion.launches = 0
        with _capturing_predictions(sink), open(work / f"{dev}.log", "w") as log, \
                contextlib.redirect_stdout(log):
            metrics = test_cli.main(["--config", str(yml), "--model_path", str(pkl),
                                     "--device", dev])
        runs[dev] = {"metrics": metrics, "preds": torch.cat(sink["preds"]),
                     "batches": len(sink["preds"]),
                     "evaluator": sink["evaluator"],
                     "launches": {"upsample_argmax": k1.upsample_argmax.launches,
                                  "comm_fusion": k2.comm_fusion.launches}}
    card, cpu = runs["cuda"], runs["cpu"]
    want = _expected_launches(card["evaluator"], None, card["batches"])
    agree = (card["preds"] == cpu["preds"]).float().mean().item()
    bw = card["metrics"].get_avg_bandW(), cpu["metrics"].get_avg_bandW()
    if card["launches"] != want or agree < 0.999 or bw[0] != bw[1] or \
            cpu["launches"] != {"upsample_argmax": 0, "comm_fusion": 0}:
        raise AssertionError(f"noisy test CLI: launches {card['launches']} (want {want}; "
                             f"CPU {cpu['launches']}), class maps agree on {agree}, "
                             f"bandwidth card {bw[0]} CPU {bw[1]}")
    if not card["metrics"].get_avg_bandW() > 0:
        raise AssertionError("noisy test CLI: no link kept; K2's fusion fused nothing")
    cached = len(list((work / "cache").iterdir()))
    shutil.rmtree(work)
    return {"size": NOISY_SIZE, "batches": card["batches"], "pixel_agreement": agree,
            "bandwidth": bw[0], "launches": card["launches"], "cached_frames": cached,
            "tf32": False}


def eval_pace(root: str) -> dict:
    """Who sets the pace of a 512x512 ``test`` at batch 2: the flagship's
    ``activated`` ``Evaluator.evaluate`` (graphs, seeded weights) over the
    train split read through the thread ``DataLoader`` (cv2, 4 threads, as
    the ``test`` CLI reads it), against the same batches already decoded
    in memory, after a warm-up pass; frames (agent views) per second."""
    from multiagentperception_tpu_torch.data import AirsimDataset, DataLoader

    cfg = load_config(str(FLAGSHIP))
    ev = Evaluator(cfg)
    init_weights(ev.model, SEED)
    ds = AirsimDataset(root, split="train", target_view="6agent", commun_label="mimo")
    loader = DataLoader(ds, cfg["training"]["batch_size"], num_workers=LOADER_WORKERS)
    batches = list(loader)
    frames = sum(b[0].shape[0] * b[0].shape[1] for b in batches)
    seconds = {}
    with open(WORK / "loader" / "eval_pace.log", "w") as log, contextlib.redirect_stdout(log):
        ev.evaluate(batches)  # warm-up: cuDNN, the allocator, the graph's capture
        for name, source in (("loader", loader), ("in_memory", batches)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev.evaluate(source)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
    rates = {k: frames / v for k, v in seconds.items()}
    return {"frames": frames, "seconds": seconds, "frames_per_s": rates,
            "loader_over_in_memory": rates["loader"] / rates["in_memory"]}


def run_phase14(records: list) -> dict:
    """Phase 14: the loader (decoders, frames decoded/s, the train pipeline
    A-F, the checkpointable stream's resume, the noisy ``test`` CLI)."""
    from multiagentperception_tpu_torch import bench_train_pipeline as pipeline
    from multiagentperception_tpu_torch.data.synthetic import generate_fixture

    out = {"decoders": decoders()}
    print("loader_decoders " + json.dumps(out["decoders"]))
    work = WORK / "loader"
    shutil.rmtree(work, ignore_errors=True)
    root = str(work / "data")
    t0 = time.perf_counter()
    generate_fixture(root, target_view="6agent", img_size=LOADER_SIZE,
                     frames_per_traj=LOADER_FRAMES, n_train=2, n_val=0, n_test=0)
    out["fixture_seconds"] = time.perf_counter() - t0
    out["loader_frames_per_s"] = pipeline.loader_rates(root, LOADER_SIZE, 2, LOADER_WORKERS,
                                                       str(work))
    print("loader_rates " + json.dumps(out["loader_frames_per_s"]))
    out["eval_pace"] = eval_pace(root)
    print("eval_pace " + json.dumps(out["eval_pace"]))
    with open(work / "train_pipeline.log", "w") as log, contextlib.redirect_stdout(log):
        out["train_pipeline"] = pipeline.main(["--root", root, "--img", str(LOADER_SIZE),
                                               "--workers", str(LOADER_WORKERS)])["variants"]
    print("train_pipeline " + json.dumps(out["train_pipeline"]))
    shutil.rmtree(work)
    out["stream_resume"] = stream_resume()
    print("stream_resume " + json.dumps(out["stream_resume"]))
    out["noisy_test"] = noisy_test_cli()
    print("noisy_test " + json.dumps(out["noisy_test"]))
    for rec in records:
        if rec["name"] in out["noisy_test"]["launches"]:
            rec["phase14_launches"] = out["noisy_test"]["launches"][rec["name"]]
    return out


# ------------------------------------------------------------------ phase 15

P15_SIZE = 512  # the flagship's frames
P15_FRAMES = 4  # the grain stream's frames: 2 a rank
P15_STEPS = 3
P15_RANK_TIMEOUT_S = 300
P15_EVAL_SIZES = (2, 2, 1)  # the last batch, a tail, does not divide over 2 ranks
P15_RING_MODES = ("softmax", "argmax_test", "activated")
P15_GRAPH_K, P15_GRAPH_ITERS = 4, 8
P15_AGREEMENT = 0.9999
P15_GRAPH_ATOL = 1e-6
P15_SHARPEN = 8.0  # the graph's projection scaled: seeded weights' activated graph keeps no link
P15_REL, P15_COS = 3e-2, 0.9995  # phase 6's bounds on gradients, losses, BatchNorm
# statistics; parameters after K Adam steps: atol 2 * K * lr (phase 6's 2 * lr a step)
P15_ZERO_GRAD = 1e-4  # the norm of a gradient that is 0 in exact arithmetic (phase 6)


class SeededFrames:
    """The flagship's frames (6 agents at 512x512) as the AirSim loader
    yields them, frame ``i`` from its own seed: a dataset ``GrainLoader``
    reads by index on any rank."""

    def __init__(self, count: int, seed: int):
        self.count, self.seed = count, seed

    def __len__(self) -> int:
        return self.count

    def __getitem__(self, i: int):
        images, labels, cl = seeded_batches(1, 1, 6, P15_SIZE, self.seed + int(i))[0]
        return images[0], labels[0], cl[0]


def _p15_cfg(**training) -> dict:
    cfg = load_config(str(FLAGSHIP))
    cfg["training"].update({"train_iters": P15_STEPS, "val_interval": P15_STEPS,
                            "print_interval": 1, "watchdog_secs": 0, **training})
    return cfg


def _p15_weights(work: Path) -> dict:
    return torch.load(work / "weights.pkl", map_location="cpu", weights_only=True)["model_state"]


def _p15_streams() -> list:
    """Per rank, the slice of the frames its process-sharded grain stream
    reads (2 of 4), as one process reads them."""
    from multiagentperception_tpu_torch.data.grain_pipeline import GrainLoader

    return [GrainLoader(SeededFrames(P15_FRAMES, SEED + 150), 1, shuffle=True, drop_last=True,
                        seed=SEED, shard_options=(r, 2)) for r in range(2)]


P15_STATS = ("running_mean", "running_var")


def _p15_train(cfg, stream, work: Path, name: str, layout=None) -> Trainer:
    """``Trainer.train`` from the phase's weights (a model group's shards
    of them on the model axis), in deterministic mode; validation on one
    global batch of 2. ``first_stats`` and ``first_grads``: the BatchNorm
    statistics and the gradients (summed over the ranks, a shard's gathered
    over its model group) of the first step (phase 6 compares those: later
    steps follow parameters Adam moved by ~lr on noise-sized gradients)."""
    val = seeded_batches(1, 2, 6, P15_SIZE, SEED + 155)
    tr = Trainer(cfg, logging.getLogger("chip_smoke"), get_loss_function(cfg), stream, val,
                 logdir=str(work / name), layout=layout)
    tr.model.load_state_dict(tensor.shard_state_dict(_p15_weights(work), tr.model), strict=True)
    tr.first_stats, tr.first_grads = {}, {}
    eager_step = tr.train_step

    def step(*args, **kwargs):
        loss = eager_step(*args, **kwargs)
        if not tr.first_stats:
            tr.first_stats = {k: v.detach().cpu().clone()
                              for k, v in tr.model.state_dict().items() if k.endswith(P15_STATS)}
            tr.first_grads = {n: g.detach().cpu().clone() for n, g in _gathered(
                tr.model, {n: p.grad for n, p in tr.model.named_parameters()}).items()}
        return loss

    tr.train_step = step
    with _deterministic():
        tr.train()
    return tr


def _p15_eval(ev: Evaluator) -> dict:
    """The ``activated`` eval over P15_EVAL_SIZES, eagerly, with the class
    maps and K1's and K2's launches (counted from 0)."""
    from multiagentperception_tpu_torch.metrics import runningScore

    batches = [seeded_batches(1, b, 6, P15_SIZE, SEED + 156 + i)[0]
               for i, b in enumerate(P15_EVAL_SIZES)]
    metrics, maps = runningScore(N_CLASSES), []
    k1.upsample_argmax.launches = k2.comm_fusion.launches = 0
    with _no_tf32():
        for res, cl in ev._pipelined(batches, inference="activated", keep_pred=True):
            maps.append(torch.from_numpy(ev._record(metrics, res, cl)["pred"].astype(np.uint8)))
    return {"maps": maps, "hist": metrics.confusion_matrix, "bandwidth": metrics.get_avg_bandW(),
            "selection": metrics.get_selection_accuracy(),
            "launches": {"upsample_argmax": k1.upsample_argmax.launches,
                         "comm_fusion": k2.comm_fusion.launches},
            "expected": _expected_launches(ev, "activated", len(batches))}


def _p15_ring_eval(ev: Evaluator) -> dict:
    """The ring's (or the dense model's) graphs, class maps and bandwidth in
    each of P15_RING_MODES on one seeded batch of 2."""
    images = seeded_batches(1, 2, 6, P15_SIZE, SEED + 155)[0][0]
    out = {}
    with _deterministic(), torch.inference_mode():
        x = ev._images(images)
        for mode in P15_RING_MODES:
            pre, prob, action, num_connect = ev.model(x, full_res=False, inference=mode)
            maps = k1.class_map(pre, x.shape[-3], x.shape[-2])
            out[mode] = {"prob": prob.cpu(), "action": action.cpu(),
                         "num_connect": float(num_connect), "maps": maps.to(torch.uint8).cpu()}
    return out


def _p15_train_step(tr: Trainer, work: Path) -> dict:
    """One train step on a seeded batch of 2 from the phase's weights: the
    loss (this rank's share) and the gradients (summed over a ring)."""
    images, labels, _ = seeded_batches(1, 2, 6, P15_SIZE, SEED + 155)[0]
    tr.model.load_state_dict(_p15_weights(work), strict=True)
    with _deterministic():
        loss = float(tr.train_step(*tr._batch(images, labels)))
    return {"loss": loss, "grads": {n: p.grad.detach().cpu()
                                    for n, p in tr.model.named_parameters()}}


def phase15_rank(kind: str, work: Path) -> int:
    """One rank of a phase-15 launch (``MAP_*`` environment): ``dp`` runs
    (a) and (b), ``ring`` runs (c) and (d); the results go to
    ``work/<kind>_rank<r>.pt``."""
    from multiagentperception_tpu_torch.parallel import from_environment

    from multiagentperception_tpu_torch.data.grain_pipeline import GrainLoader

    layout = from_environment("cuda", agent=2 if kind == "ring" else 1)
    try:
        if kind == "dp":
            cfg = _p15_cfg(batch_size=1, shard_data_by_process=True)
            stream = GrainLoader(SeededFrames(P15_FRAMES, SEED + 150), 1, shuffle=True,
                                 drop_last=True, seed=SEED, shard_by_process=True)
            tr = _p15_train(cfg, stream, work, "dp_run", layout)
            out = {"losses": [tr.loss_history[i] for i in range(1, P15_STEPS + 1)],
                   "iter_ms": [1e3 * s for s in tr.iter_seconds], "first_stats": tr.first_stats,
                   "first_grads": tr.first_grads,
                   "state": {k: v.cpu() for k, v in tr.model.state_dict().items()}}
            # one more step, its bytes through the host counted alone
            images, labels, _ = SeededFrames(P15_FRAMES, SEED + 150)[layout.rank]
            before = layout.world_group.staged_bytes
            tr.train_step(*tr._batch(images[None], labels[None]))
            out["staged_bytes_per_step"] = layout.world_group.staged_bytes - before
            ev = Evaluator(load_config(str(FLAGSHIP)), layout=layout, graphs=False)
            ev.load_weight(str(work / "weights.pkl"))
            out["eval"] = _p15_eval(ev)
        else:
            ev = Evaluator(load_config(str(FLAGSHIP)), layout=layout, graphs=False)
            ev.load_weight(str(work / "weights.pkl"))
            out = {"eval": _p15_ring_eval(ev)}
            cfg = load_config(str(FLAGSHIP))
            cfg["model"]["agent_parallel_train"] = True
            tr = Trainer(cfg, None, get_loss_function(cfg), None, None, layout=layout)
            before = layout.agent_group.staged_bytes  # (c)'s evals staged bytes too
            out["train"] = _p15_train_step(tr, work)
            out["staged_bytes_train_step"] = layout.agent_group.staged_bytes - before
        out["backend"] = layout.backend
        torch.save(out, work / f"{kind}_rank{layout.rank}.pt")
    finally:
        layout.close()
    return 0


def _ranks_start(kind: str, work: Path, phase: int = 15, coordinator: str | None = None):
    """Two ``MAP_*`` ranks of phase ``phase`` (15 or 17) on this card
    (gloo), started: the coordinator ``localhost:<a free port>`` unless
    ``coordinator`` is given (a ``file://`` rendezvous needs no port, so
    launches may run at once); ``_ranks_wait`` takes what it returns."""
    if coordinator is None:
        import socket

        with socket.socket() as s:
            s.bind(("localhost", 0))
            coordinator = f"localhost:{s.getsockname()[1]}"
    env = {**os.environ, "MAP_COORDINATOR": coordinator, "MAP_NUM_PROCESSES": "2"}
    procs, logs = [], []
    for rank in range(2):
        log = open(work / f"{kind}_rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), f"--phase{phase}-rank", kind,
             f"--phase{phase}-dir", str(work)], env={**env, "MAP_PROCESS_ID": str(rank)},
            stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT)))
    return kind, work, phase, procs, logs, time.monotonic()


def _ranks_wait(started) -> list:
    """The started ranks' results, each rank within the phase's timeout; a
    rank that fails fails the phase with its output's end."""
    kind, work, phase, procs, logs, t0 = started
    timeout = P15_RANK_TIMEOUT_S if phase == 15 else P17_RANK_TIMEOUT_S
    try:
        for rank, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, timeout - (time.monotonic() - t0)))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"phase {phase} {kind} rank {rank}: no exit after "
                                     f"{timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for rank, p in enumerate(procs):
        text = (work / f"{kind}_rank{rank}.log").read_text()
        if p.returncode != 0:
            raise AssertionError(f"phase {phase} {kind} rank {rank} failed (exit code "
                                 f"{p.returncode}):\n{text[-4000:]}")
        if rank == 0:
            print(f"phase{phase} {kind} rank 0: " + next(
                line for line in text.splitlines() if line.startswith("parallel:")))
    return [torch.load(work / f"{kind}_rank{r}.pt", weights_only=False) for r in range(2)]


def _p15_launch(kind: str, work: Path) -> list:
    """Phase 15's two ranks of ``kind``, started and waited for."""
    return _ranks_wait(_ranks_start(kind, work))


def _p15_close(got: dict, want: dict, skip=()) -> dict:
    """Per float tensor, relative L2 and cosine within phase 6's bounds; the
    worst of each."""
    worst_rel, worst_cos = 0.0, 1.0
    for k, w in want.items():
        if k in skip or not w.is_floating_point():
            continue
        g = got[k]
        rel = _rel(g, w)
        cos = float(torch.nn.functional.cosine_similarity(
            g.double().flatten(), w.double().flatten(), dim=0)) if w.norm() > 0 else 1.0
        if rel > P15_REL or cos < P15_COS:
            raise AssertionError(f"{k}: relative L2 {rel:.2e}, cosine {cos:.6f}")
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
    return {"worst_rel_l2": worst_rel, "worst_cosine": worst_cos}


def _p15_zero(names) -> set:
    """The gradients that are 0 in exact arithmetic (phase 6): a conv bias
    before a training-mode BatchNorm, and ``key_net``'s last bias."""
    return {"key_net.fc.4.bias"} | {k for k in names if k.endswith("cbr_unit.0.bias")}


def _p15_grads(got: dict, want: dict) -> dict:
    """Gradients within phase 6's bounds, those that are 0 in exact
    arithmetic below P15_ZERO_GRAD on both sides."""
    zero = _p15_zero(want)
    for k in zero:
        if max(float(got[k].norm()), float(want[k].norm())) >= P15_ZERO_GRAD:
            raise AssertionError(f"{k}: gradient of an invariant not ~0")
    return _p15_close(got, want, zero)


def _p15_agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a == b).double().mean())


def p15_data_parallel(ranks: list, work: Path) -> dict:
    """(a) the 2-rank training against one process at batch 2 on the same
    frames; (b) the 2-rank eval against one process."""
    out = {"backend": ranks[0]["backend"]}
    streams = [iter(s.persistent_iterator()) for s in _p15_streams()]
    batches = []
    for _ in range(P15_STEPS):  # the global batch: rank 0's row, then rank 1's
        rows = [next(s) for s in streams]
        batches.append(tuple(np.concatenate([r[f] for r in rows]) for f in range(3)))
    ref = _p15_train(_p15_cfg(batch_size=2), batches, work, "dp_ref")
    want_losses = [ref.loss_history[i] for i in range(1, P15_STEPS + 1)]
    got_losses = [ranks[0]["losses"][i] + ranks[1]["losses"][i] for i in range(P15_STEPS)]
    for g, w in zip(got_losses, want_losses):
        if abs(g - w) > P15_REL * abs(w):
            raise AssertionError(f"2-rank loss {g} against one process {w}")
    state = {k: v.cpu() for k, v in ref.model.state_dict().items()}
    if any(not torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in state):
        raise AssertionError("the ranks' parameters differ")
    stats = {k for k in state if k.endswith(P15_STATS)}
    grads = _p15_grads(ranks[0]["first_grads"], ref.first_grads)
    start, zero = _p15_weights(work), _p15_zero(ref.first_grads)
    moved = {k: state[k] - start[k] for k in state if k not in stats | zero and
             state[k].is_floating_point() and float((state[k] - start[k]).norm()) > 0}
    lr = float(load_config(str(FLAGSHIP))["training"]["optimizer"]["lr"])
    gap = max(float((ranks[0]["state"][k] - v).abs().max()) for k, v in state.items()
              if k not in stats and v.is_floating_point())
    if gap > 2 * P15_STEPS * lr:
        raise AssertionError(f"2-rank parameters {gap} from one process's (> 2 x "
                             f"{P15_STEPS} x lr)")
    out["train"] = {
        "losses_2_ranks": got_losses, "losses_1_process": want_losses,
        "parameters_max_abs": gap, "parameters_bound": 2 * P15_STEPS * lr,
        "gradients_first_step": grads,
        "bn_statistics_first_step": _p15_close(ranks[0]["first_stats"], ref.first_stats),
        "bn_statistics_last_step_rel_l2_worst": max(_rel(ranks[0]["state"][k], state[k])
                                                    for k in stats),
        "updates_rel_l2_worst": max(_rel(ranks[0]["state"][k] - start[k], d)
                                    for k, d in moved.items()),
        "updates_cosine_worst": min(float(torch.nn.functional.cosine_similarity(
            (ranks[0]["state"][k] - start[k]).double().flatten(), d.double().flatten(), dim=0))
            for k, d in moved.items()),
        "ms_per_step_2_ranks": ranks[0]["iter_ms"][1:], "ms_per_step_1_process":
            [1e3 * s for s in ref.iter_seconds[1:]],
        "staged_bytes_per_step": ranks[0]["staged_bytes_per_step"]}
    del ref
    torch.cuda.empty_cache()
    ev = Evaluator(load_config(str(FLAGSHIP)), graphs=False)
    ev.load_weight(str(work / "weights.pkl"))
    want = _p15_eval(ev)
    maps = [torch.cat([ranks[0]["eval"]["maps"][i], ranks[1]["eval"]["maps"][i]])
            if size % 2 == 0 else ranks[0]["eval"]["maps"][i]
            for i, size in enumerate(P15_EVAL_SIZES)]
    got_maps, want_maps = torch.cat(maps), torch.cat(want["maps"])
    agreement = _p15_agreement(got_maps, want_maps)
    moved_px = int((got_maps != want_maps).sum())
    hist_l1 = [float(np.abs(r["eval"]["hist"] - want["hist"]).sum()) for r in ranks]
    if agreement < P15_AGREEMENT or max(hist_l1) > 2 * moved_px:
        raise AssertionError(f"2-rank eval: class maps {agreement}, confusion L1 {hist_l1}, "
                             f"{moved_px} pixels moved")
    for r in ranks:
        if r["eval"]["bandwidth"] != want["bandwidth"] or \
                r["eval"]["selection"] != want["selection"]:
            raise AssertionError(f"2-rank bandwidth/selection {r['eval']['bandwidth']} "
                                 f"{r['eval']['selection']} against {want['bandwidth']} "
                                 f"{want['selection']}")
        if r["eval"]["launches"] != r["eval"]["expected"]:
            raise AssertionError(f"rank launches {r['eval']['launches']}, expected "
                                 f"{r['eval']['expected']}")
    out["eval"] = {"batches": list(P15_EVAL_SIZES), "class_map_agreement": agreement,
                   "confusion_equal": max(hist_l1) == 0.0, "bandwidth": want["bandwidth"],
                   "launches_per_rank": [r["eval"]["launches"] for r in ranks]}
    return out


def p15_ring(ranks: list, work: Path) -> dict:
    """(c) the ring's eval in P15_RING_MODES and (d) its train step, each
    against the dense model."""
    ev = Evaluator(load_config(str(FLAGSHIP)), graphs=False)
    ev.load_weight(str(work / "weights.pkl"))
    dense = _p15_ring_eval(ev)
    out = {"backend": ranks[0]["backend"], "eval": {}}
    for mode in P15_RING_MODES:
        want = dense[mode]
        maps = torch.cat([r["eval"][mode]["maps"].reshape(2, 3, P15_SIZE, P15_SIZE)
                          for r in ranks], dim=1)
        agreement = _p15_agreement(maps.reshape(-1, P15_SIZE, P15_SIZE), want["maps"])
        gap = max(float((r["eval"][mode]["prob"] - want["prob"]).abs().max()) for r in ranks)
        if gap > P15_GRAPH_ATOL or agreement < P15_AGREEMENT or any(
                r["eval"][mode]["num_connect"] != want["num_connect"]
                or not torch.equal(r["eval"][mode]["action"], want["action"]) for r in ranks):
            raise AssertionError(f"ring {mode}: graph gap {gap}, class maps {agreement}, "
                                 f"bandwidth {[r['eval'][mode]['num_connect'] for r in ranks]}"
                                 f" against {want['num_connect']}")
        out["eval"][mode] = {"graph_max_abs": gap, "class_map_agreement": agreement,
                             "bandwidth": want["num_connect"]}
    del ev
    cfg = load_config(str(FLAGSHIP))
    want = _p15_train_step(Trainer(cfg, None, get_loss_function(cfg), None, None), work)
    loss = ranks[0]["train"]["loss"] + ranks[1]["train"]["loss"]
    if abs(loss - want["loss"]) > P15_REL * abs(want["loss"]):
        raise AssertionError(f"ring train loss {loss} against dense {want['loss']}")
    out["train"] = {"loss_ring": loss, "loss_dense": want["loss"],
                    "gradients": _p15_grads(ranks[0]["train"]["grads"], want["grads"]),
                    "staged_bytes_train_step": ranks[0]["staged_bytes_train_step"]}
    return out


def p15_nccl_graph(work: Path) -> dict:
    """(e) NCCL with a world of one: P15_GRAPH_ITERS iterations in chunks of
    P15_GRAPH_K captured with the gradient all-reduce, against the same run
    with no layout, bit for bit in deterministic mode."""
    from multiagentperception_tpu_torch.parallel import init_distributed

    layout = init_distributed(rank=0, world=1, init_method=f"file://{work / 'nccl_rdv'}",
                              device="cuda", backend="nccl")
    try:
        cfg = _p15_cfg(train_iters=P15_GRAPH_ITERS, val_interval=P15_GRAPH_ITERS,
                       steps_per_call=P15_GRAPH_K, device_prefetch=2)
        batches = seeded_batches(P15_GRAPH_ITERS, 2, 6, P15_SIZE, SEED + 160)
        runs = {}
        for name, lay in (("grouped", layout), ("ungrouped", None)):
            tr = _p15_train(cfg, batches, work, f"nccl_{name}", lay)
            runs[name] = ({k: v.cpu() for k, v in tr.model.state_dict().items()},
                          tr._train_graph is not None, tr.graphs)
            del tr
        grouped, ungrouped = runs["grouped"][0], runs["ungrouped"][0]
        equal = all(torch.equal(grouped[k], ungrouped[k]) for k in grouped)
        if not (equal and runs["grouped"][1] and runs["ungrouped"][1]):
            raise AssertionError(f"NCCL grouped chunk against ungrouped: equal {equal}, "
                                 f"captured {runs['grouped'][1]} / {runs['ungrouped'][1]}")
        return {"backend": layout.backend, "steps_per_call": P15_GRAPH_K,
                "iterations": P15_GRAPH_ITERS, "captured": True, "bit_equal": equal,
                "eval_graphs": runs["grouped"][2]}
    finally:
        layout.close()


def run_phase15(records: list) -> dict:
    """Phase 15: data parallel and the agent ring on this card (module
    docstring)."""
    work = WORK / "phase15"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    model = init_weights(get_model(load_config(str(FLAGSHIP)), N_CLASSES), SEED + 15)
    with torch.no_grad():
        model.attention_net.linear.weight.mul_(P15_SHARPEN)
    torch.save({"epoch": 0, "model_state": model.state_dict(), "best_iou": 0.0},
               work / "weights.pkl")
    del model
    torch.cuda.empty_cache()
    out = {"data_parallel": p15_data_parallel(_p15_launch("dp", work), work)}
    print("phase15_data_parallel " + json.dumps(out["data_parallel"]))
    torch.cuda.empty_cache()
    out["ring"] = p15_ring(_p15_launch("ring", work), work)
    print("phase15_ring " + json.dumps(out["ring"]))
    torch.cuda.empty_cache()
    out["nccl_graph"] = p15_nccl_graph(work)
    print("phase15_nccl " + json.dumps(out["nccl_graph"]))
    train = out["data_parallel"]["train"]
    print("phase15_info " + json.dumps({
        "staged_bytes_per_step_dp": train["staged_bytes_per_step"],
        "staged_bytes_ring_train_step": out["ring"]["train"]["staged_bytes_train_step"],
        "ms_per_step_2_ranks_one_card": train["ms_per_step_2_ranks"],
        "ms_per_step_1_process": train["ms_per_step_1_process"],
        "note": "2 ranks share one card under gloo: no speed claim",
        "card": bench._card_line()}))
    launches = out["data_parallel"]["eval"]["launches_per_rank"]
    for rec in records:
        if rec["name"] in launches[0]:
            rec["phase15_launches"] = [r[rec["name"]] for r in launches]
    shutil.rmtree(work, ignore_errors=True)
    return out


# ------------------------------------------------------------------ phase 17

P17_RANK_TIMEOUT_S = 400
P17_CALIB_BATCHES, P17_INT8_BATCHES = 2, 3
P17_DRYRUN_TIMEOUT_S = 400
P17_DRYRUN_IMG = 128  # JAX's dry run's side (__graft_entry__.py:131)


def _gathered(model, tensors: dict) -> dict:
    """``tensors`` named as ``model``'s parameters, a shard's gathered over
    its model group (the one-process tensors; others as they are)."""
    layers = tensor.sharded(model)
    return {k: all_gather_cat(v, layers[k].group, layers[k].shard_dim) if k in layers else v
            for k, v in tensors.items()}


def _p17_int8(ev: Evaluator, scales: dict | None = None) -> dict:
    """The ``activated`` int8 eval, eagerly, in deterministic mode: scales
    calibrated (over the layout's ranks) on P17_CALIB_BATCHES seeded
    batches, then P17_INT8_BATCHES batches with ``scales`` (one process's:
    phase 10's rule holds two int8 evals to one set of scales), or the
    calibrated ones, K1's, K2's and K4's launches counted from 0; the
    calibrated scales, class maps, confusion matrix, bandwidth."""
    from multiagentperception_tpu_torch.metrics import runningScore

    calib = seeded_batches(P17_CALIB_BATCHES, 2, 6, P15_SIZE, SEED + 171)
    batches = seeded_batches(P17_INT8_BATCHES, 2, 6, P15_SIZE, SEED + 172)
    kernels = (k1.upsample_argmax, k2.comm_fusion, k4.int8_conv)
    metrics, maps = runningScore(N_CLASSES), []
    with _deterministic():
        calibrated = ev._calibrate_int8(None, "activated", calib_loader=calib)
        swap = ev.int8_convs = Int8Convs(ev.model, scales or calibrated)
        bench._zero_launches(kernels)
        with swap:
            for res, cl in ev._pipelined(batches, inference="activated", keep_pred=True):
                maps.append(torch.from_numpy(ev._record(metrics, res, cl)["pred"].astype(
                    np.uint8)))
    launches = {kern.__name__: kern.launches for kern in kernels}
    expected = {**_expected_launches(ev, "activated", len(batches)),
                "int8_conv": 48 * len(batches)}
    if launches != expected or swap.calls != 48 * len(batches):
        raise AssertionError(f"int8 eval launches {launches} ({swap.calls} swapped calls), "
                             f"expected {expected}")
    return {"scales": calibrated, "maps": maps, "hist": metrics.confusion_matrix,
            "bandwidth": metrics.get_avg_bandW(), "launches": launches}


def _p17_staged(layout) -> int:
    groups = {id(g): g for g in (layout.world_group, layout.data_group, layout.model_group,
                                 layout.agent_group)}
    return sum(g.staged_bytes for g in groups.values())


def phase17_rank(kind: str, work: Path) -> int:
    """One rank of a phase-17 launch (``MAP_*`` environment): ``ring`` runs
    (a), ``grid`` (b); the results go to ``work/<kind>_rank<r>.pt``."""
    from multiagentperception_tpu_torch.parallel import from_environment

    layout = from_environment("cuda", agent=2 if kind == "ring" else 1,
                              model=2 if kind == "grid" else 1)
    try:
        out = {"backend": layout.backend}
        if kind == "grid":
            batches = seeded_batches(P15_STEPS, 2, 6, P15_SIZE, SEED + 170)
            tr = _p15_train(_p15_cfg(), batches, work, "grid_run", layout)
            out.update(losses=[tr.loss_history[i] for i in range(1, P15_STEPS + 1)],
                       iter_ms=[1e3 * s for s in tr.iter_seconds], first_grads=tr.first_grads,
                       shards=len(tensor.sharded(tr.model)))
            before = _p17_staged(layout)  # one more step, its bytes through the host alone
            tr.train_step(*tr._batch(*batches[0][:2]))
            out["staged_bytes_per_step"] = _p17_staged(layout) - before
            del tr
            torch.cuda.empty_cache()
        ev = Evaluator(load_config(str(FLAGSHIP)), layout=layout, graphs=False)
        ev.load_weight(str(work / "weights.pkl"))
        if kind == "grid":
            out["eval"] = _p15_eval(ev)
        out["int8"] = _p17_int8(ev, torch.load(work / "scales.pt"))
        torch.save(out, work / f"{kind}_rank{layout.rank}.pt")
    finally:
        layout.close()
    return 0


def _p17_int8_against(ranks: list, want: dict, maps_of) -> dict:
    """Each rank's calibrated int8 scales within relative 1e-4 of one
    process's; with one process's scales (phase 10's rule), its class maps
    (``maps_of``) within phase 10's seeded share of moved pixels."""
    scales_rel = max(abs(r["int8"]["scales"][k] / v - 1.0) for r in ranks
                     for k, v in want["scales"].items())
    if any(set(r["int8"]["scales"]) != set(want["scales"]) for r in ranks) or scales_rel > 1e-4:
        raise AssertionError(f"int8 scales {scales_rel} from one process's")
    got, ref = maps_of(ranks), torch.cat(want["maps"])
    moved = {"pixels_moved": int((got != ref).sum()), "pixels": ref.numel(),
             "moved_share": float((got != ref).double().mean())}
    if moved["moved_share"] > INT8_CARD_VS_CPU_MOVED["float32"]:
        raise AssertionError(f"int8 class maps against one process: {moved}")
    return {"scales_max_rel": scales_rel, "class_maps": moved,
            "bandwidth": [r["int8"]["bandwidth"] for r in ranks],
            "bandwidth_one_process": want["bandwidth"],
            "launches_per_rank": [r["int8"]["launches"] for r in ranks]}


def p17_ring_int8(ranks: list, want: dict) -> dict:
    """(a) the ring's int8 eval against one process's dense int8 eval."""
    def maps_of(ranks):  # each rank's 3 agents of every sample
        return torch.cat([torch.cat([r["int8"]["maps"][i].reshape(2, 3, P15_SIZE, P15_SIZE)
                                     for r in ranks], dim=1).reshape(-1, P15_SIZE, P15_SIZE)
                          for i in range(P17_INT8_BATCHES)])
    return {"backend": ranks[0]["backend"], **_p17_int8_against(ranks, want, maps_of)}


def p17_grid(ranks: list, work: Path, want_int8: dict) -> dict:
    """(b) the D = 1 x M = 2 grid: training, the ``activated`` eval and the
    int8 eval against one process; K4 at the shards' new geometries."""
    out = {"backend": ranks[0]["backend"], "sharded_layers": ranks[0]["shards"]}
    # K4 at each shard geometry the flagship's step does not have
    cfg = load_config(str(FLAGSHIP))
    with torch.device("meta"):
        model = get_model(cfg, N_CLASSES)
    shapes = {g[:7]: g[7] for g in model_k4_shapes(cfg)}
    half = {mod.out_channels for _, mod in eligible_convs(model)
            if tensor.shard_rule(mod, 2) is not None}
    flagship = {g[:7] for g in K4_SHAPES}
    new = sorted((cin, cout // 2, *rest, calls) for (cin, cout, *rest), calls in shapes.items()
                 if cout in half and (cin, cout // 2, *rest) not in flagship)
    (k4_shards,) = check_int8_conv(
        torch.Generator().manual_seed(SEED + 47), new, 2 * 6, {"f32": torch.float32},
        "the model axis's output-channel shards (M = 2) not among the flagship's int8 "
        "convolutions, at batch 2 x 6, each call of a step")
    out["k4_shard_geometries"] = k4_shards
    ref = _p15_train(_p15_cfg(), seeded_batches(P15_STEPS, 2, 6, P15_SIZE, SEED + 170), work,
                     "grid_ref")
    want_losses = [ref.loss_history[i] for i in range(1, P15_STEPS + 1)]
    for r in ranks:
        for g, w in zip(r["losses"], want_losses):
            if abs(g - w) > P15_REL * abs(w):
                raise AssertionError(f"grid loss {g} against one process {w}")
    out["train"] = {"losses_grid": ranks[0]["losses"], "losses_1_process": want_losses,
                    "gradients_first_step": _p15_grads(ranks[0]["first_grads"], ref.first_grads),
                    "ms_per_step_grid": ranks[0]["iter_ms"][1:],
                    "ms_per_step_1_process": [1e3 * s for s in ref.iter_seconds[1:]],
                    "staged_bytes_per_step": ranks[0]["staged_bytes_per_step"]}
    del ref
    torch.cuda.empty_cache()
    ev = Evaluator(load_config(str(FLAGSHIP)), graphs=False)
    ev.load_weight(str(work / "weights.pkl"))
    want = _p15_eval(ev)
    agreement = min(_p15_agreement(torch.cat(r["eval"]["maps"]), torch.cat(want["maps"]))
                    for r in ranks)
    if agreement < P15_AGREEMENT or any(
            r["eval"]["bandwidth"] != want["bandwidth"] or
            r["eval"]["launches"] != r["eval"]["expected"] for r in ranks):
        raise AssertionError(f"grid eval: class maps {agreement}, bandwidth "
                             f"{[r['eval']['bandwidth'] for r in ranks]} against "
                             f"{want['bandwidth']}, launches "
                             f"{[r['eval']['launches'] for r in ranks]}")
    out["eval"] = {"class_map_agreement": agreement, "bandwidth": want["bandwidth"],
                   "launches_per_rank": [r["eval"]["launches"] for r in ranks]}
    out["int8"] = _p17_int8_against(
        ranks, want_int8, lambda ranks: torch.cat(ranks[0]["int8"]["maps"]))
    return out


def p17_dryrun(work: Path) -> tuple:
    """(c) ``dryrun_multichip --ranks 4 --device cuda`` at JAX's 128x128,
    started, its output to files in ``work`` (``p17_dryrun_result`` waits
    for it)."""
    out, err = (open(work / f"dryrun.{kind}", "w+") for kind in ("out", "err"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "multiagentperception_tpu_torch.dryrun_multichip", "--ranks",
         "4", "--device", "cuda", "--img", str(P17_DRYRUN_IMG)], stdout=out, stderr=err,
        text=True, cwd=str(ROOT))
    return proc, out, err


def p17_dryrun_result(started: tuple) -> dict:
    proc, out, err = started
    try:
        proc.wait(timeout=P17_DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"dryrun_multichip: no exit after {P17_DRYRUN_TIMEOUT_S} s") \
            from None
    finally:
        text = []
        for f in (out, err):
            f.seek(0)
            text.append(f.read())
            f.close()
    lines = text[0].strip().splitlines()
    result = json.loads(lines[-1]) if lines else {}
    if proc.returncode != 0 or not result.get("ok"):
        raise AssertionError(f"dryrun_multichip failed (exit code {proc.returncode}): "
                             f"{text[0][-3000:]}{text[1][-3000:]}")
    return result


def run_phase17(records: list) -> dict:
    """Phase 17: int8 eval on the agent ring and the mesh's model axis on
    this card (the module docstring's (a)-(d))."""
    started = time.perf_counter()
    work = WORK / "phase17"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    model = init_weights(get_model(load_config(str(FLAGSHIP)), N_CLASSES), SEED + 17)
    with torch.no_grad():
        model.attention_net.linear.weight.mul_(P15_SHARPEN)
    torch.save({"epoch": 0, "model_state": model.state_dict(), "best_iou": 0.0},
               work / "weights.pkl")
    del model
    torch.cuda.empty_cache()
    ev = Evaluator(load_config(str(FLAGSHIP)), graphs=False)
    ev.load_weight(str(work / "weights.pkl"))
    want_int8 = _p17_int8(ev)
    torch.save(want_int8["scales"], work / "scales.pt")
    del ev
    torch.cuda.empty_cache()
    seconds = {"reference_int8": time.perf_counter() - started}

    def lap(name: str) -> None:
        seconds[name] = time.perf_counter() - started - sum(seconds.values())

    # (a), (b) and (c) at once, each rendezvous a file; the ranks' results wait
    dryrun = p17_dryrun(work)
    launches = {kind: _ranks_start(kind, work, 17, f"file://{work / kind}_rendezvous")
                for kind in ("ring", "grid")}
    try:
        ring = _ranks_wait(launches["ring"])
        out = {"ring_int8": p17_ring_int8(ring, want_int8)}
        print("phase17_ring_int8 " + json.dumps(out["ring_int8"]))
        lap("a_ring_int8")
        out["dryrun"] = p17_dryrun_result(dryrun)
        print("phase17_dryrun " + json.dumps(out["dryrun"]))
        lap("c_dryrun")
        grid = _ranks_wait(launches["grid"])
        lap("b_grid_ranks")
    finally:
        for proc in [dryrun[0], *launches["ring"][3], *launches["grid"][3]]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["grid"] = p17_grid(grid, work, want_int8)
    print("phase17_grid " + json.dumps(out["grid"]))
    lap("b_grid_one_process_and_k4")
    print("phase17_seconds " + json.dumps(seconds))
    train = out["grid"]["train"]
    print("phase17_info " + json.dumps({
        "staged_bytes_per_model_axis_step": train["staged_bytes_per_step"],
        "ms_per_step_grid_one_card": train["ms_per_step_grid"],
        "ms_per_step_1_process": train["ms_per_step_1_process"],
        "note": "2 ranks share one card under gloo, beside (a) and (c): no speed claim",
        "card": bench._card_line()}))
    by_name = {rec["name"]: rec for rec in records}
    for name in ("upsample_argmax", "comm_fusion", "int8_conv"):
        by_name[name]["phase17_launches"] = {
            "ring_int8": [r["int8"]["launches"][name] for r in ring],
            "grid_int8": [r["int8"]["launches"][name] for r in grid]}
        if name != "int8_conv":
            by_name[name]["phase17_launches"]["grid_eval"] = \
                [r["eval"]["launches"][name] for r in grid]
    by_name["int8_conv"]["phase17_shapes"] = out["grid"]["k4_shard_geometries"]["shapes"]
    shutil.rmtree(work, ignore_errors=True)
    return out


# ------------------------------------------------------------------ phase 16

def serve_float16() -> dict:
    """Phase 16 (g): the float16 flagship exported at batch 8 as phase 11
    exports the bf16 one, and its int8 artifact (static scales calibrated on
    the float16 network, int8 weights baked, float16 output), each loaded
    and held to the eager ``make_eval_fn`` / ``make_int8_eval_fn`` over
    SERVE_BATCHES batches, K1, K2 and K4 counted on the f16 route
    (``serve_variant``)."""
    from multiagentperception_tpu_torch.export import make_eval_fn
    from multiagentperception_tpu_torch.quantize import calibrate_activations, make_int8_eval_fn

    cfg = load_config(str(FLAGSHIP))
    cfg["model"]["dtype"] = "float16"
    n, size = cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    batches = seeded_images(SERVE_BATCHES, SERVE_BATCH, n, size, SEED + 160)
    model = init_weights(get_model(cfg, N_CLASSES), SEED).to("cuda").eval()
    out = {"config": FLAGSHIP.relative_to(ROOT).as_posix(), "dtype": "float16",
           "batch": SERVE_BATCH, "agents": n, "size": size}
    out["float16"], _ = serve_variant("float16", model, batches, make_eval_fn(model), "f16")
    calib = seeded_images(2, SERVE_BATCH, n, size, SEED + 161)
    scales = calibrate_activations(model, calib, inference="activated", full_res=False)
    out["int8"], _ = serve_variant("int8 float16", model, batches,
                                   make_int8_eval_fn(model, act_scales=scales), "f16",
                                   int8=True, act_scales=scales)
    del model
    torch.cuda.empty_cache()
    return out


def run_phase16(records: list, lap) -> dict:
    """Phase 16: ``model.dtype: float16`` end to end at the flagship's full
    width (the module docstring's (a)-(g)). Adds the float16 records of K1,
    K2 and K4 to ``records``; ``lap(name)`` books each part's seconds."""
    eval_kernels = (k1.upsample_argmax, k2.comm_fusion)
    out = {}
    gen = torch.Generator().manual_seed(SEED + 16)
    f16 = [check_upsample_argmax(gen, torch.float16), check_comm_fusion(gen, torch.float16),
           *check_int8_conv(torch.Generator().manual_seed(SEED + 41),
                            dtypes={"f16": torch.float16})]
    print("phase16_kernels " + json.dumps(f16))
    lap("16_kernels_f16")

    out["eval"] = {"yaml_batch": run_slice(eval_kernels, dtype="float16"),
                   "bench_batch": run_slice(eval_kernels, dtype="float16", batch=BENCH_BATCH,
                                            timed=BENCH_EVAL_BATCHES)}
    for rec, kern in zip(f16, eval_kernels):
        name = kern.__name__
        rec["launches"] = out["eval"]["yaml_batch"]["route_launches"][name]["f16"]
        rec["path_device_ms"] = out["eval"]["yaml_batch"]["path_kernel_device_ms"][name]
        rec["launches_bench_batch"] = out["eval"]["bench_batch"]["route_launches"][name]["f16"]
        rec["path_device_ms_bench_batch"] = \
            out["eval"]["bench_batch"]["path_kernel_device_ms"][name]
        rec["kernel_ms"] = rec["ms"]
    print("phase16_eval " + json.dumps(out["eval"]))
    lap("16_eval_f16")
    out["card_vs_cpu"] = mixed_card_vs_cpu("float16")
    print("phase16_card_vs_cpu " + json.dumps(out["card_vs_cpu"]))
    lap("16_card_vs_cpu_f16")
    out["train"] = run_training(eval_kernels, dtype="float16", profile=False)
    print("phase16_train " + json.dumps(out["train"]))
    lap("16_train_f16")
    out["graph_eval"] = graph_eval("float16")
    print("phase16_graph_eval " + json.dumps(out["graph_eval"]))
    for rec, kern in zip(f16, eval_kernels):
        rec["graph_launches_per_batch"] = out["graph_eval"]["launches_per_batch"][kern.__name__]
        rec["graph_traced_launches"] = \
            out["graph_eval"]["traced_launches"]["graph"][kern.__name__]
    lap("16_graph_eval_f16")

    out["int8_eval"] = run_int8_slice("float16")
    f16[2]["launches"] = out["int8_eval"]["launches"]["int8_conv"]["f16"]
    f16[2]["path_device_ms_per_batch"] = out["int8_eval"]["k4_device_ms_per_batch"]
    print("phase16_int8_eval " + json.dumps(out["int8_eval"]))
    out["int8_card_vs_cpu"] = int8_card_vs_cpu("float16")
    print("phase16_int8_card_vs_cpu " + json.dumps(out["int8_card_vs_cpu"]))
    lap("16_int8_f16")

    out["serving"] = serve_float16()
    print("phase16_serving " + json.dumps(out["serving"]))
    for rec in f16:
        kern = rec["name"].removesuffix("_f16")
        variant = "int8" if kern == "int8_conv" else "float16"
        rec["serving_launches"] = sum(out["serving"][variant]["launches"][kern].values())
    lap("16_serving_f16")
    records += f16
    return out


# ------------------------------------------------------------------ phase 18

P18_EVERY_N = range(1, 201)  # every agent count K2 takes on the card in (a), all types
P18_F16_AGENTS = (24,)  # the float16 leg of the sweep
P18_CPU_AGENTS, P18_CPU_SIZE = (24, 48), 128  # (c): card against CPU, batch 1
P18_CPU_MODES = ("activated", "argmax_test")
P18_AGREEMENT = 0.9999
P18_FULL = {"batch": 2, "img": 512, "agents": 24, "dtype": "float32"}  # (d)
P18_GRAPH_BATCHES = 3  # (d): warm-up, capture, replay
# the wide records' shapes: float32 at (d)'s, 16-bit at the sweep's N = 48
P18_RECORD_SHAPES = {torch.float32: (2, 24, (512, 16, 16)),
                     torch.bfloat16: (2, 48, (512, 8, 8)), torch.float16: (2, 48, (512, 8, 8))}


def _designs() -> dict:
    return dict(k2.comm_fusion.design_launches)


def _zero_designs() -> None:
    k2.comm_fusion.design_launches.update(dict.fromkeys(k2.comm_fusion.design_launches, 0))


def k1_wide_routes(gen) -> dict:
    """(a): K1 at the first shape of ``checks.K1_WIDE_SHAPES`` for each of
    its routes (``upsample_argmax.plan``: 16 rows opted in past 48 KB, 8, 4,
    2 and 1 rows, and none: the direct kernel), float32 logits, timed as
    phase 1 times the flagship's (``k1_times``)."""
    out = {}
    for n, c, h, w, out_h, out_w in checks.K1_WIDE_SHAPES:
        rows = k1.plan(c, w)
        route = f"rows{rows}" if rows else "direct"
        if route not in out:
            x = torch.randn(n, c, h, w, generator=gen).to("cuda")
            out[route] = {"shape": f"({n}, {c}, {h}, {w}) -> ({n}, {out_h}, {out_w})",
                          **k1_times(x, out_h, out_w)}
    return out


def p18_kernels(gen) -> tuple[list[dict], dict]:
    """(a): K2's wide design against its plain version (``checks``) at
    WIDE_AGENTS x WIDE_MAPS in every type and mode, at WIDE_BEYOND agents
    with D = 37 and a ragged M (its logits kept in soft and coef, V streamed
    again per query tile), every N of P18_EVERY_N in every type (one mode
    each), each call's design counted (the cluster design alone up to 16
    agents), two calls equal bit for bit and a CUDA graph's replay equal to
    eager; the wide records, timed; K1 at the wide logits of
    ``checks.K1_WIDE_SHAPES`` in every type, and each of its routes timed."""
    out = {"wide": {}, "beyond": {}, "repeatable": {}, "graph_replay": {}, "k1_wide": {},
           "seconds": {}}
    t0 = time.perf_counter()

    def lap(name: str) -> None:
        out["seconds"][name] = time.perf_counter() - t0 - sum(out["seconds"].values())

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        route = _route(dtype)
        out["wide"][route] = checks.check_comm_fusion_wide(gen, "cuda", dtype)
        lap(f"wide_{route}")
        out["beyond"][route] = checks.check_comm_fusion_wide(
            gen, "cuda", dtype, agents=(checks.WIDE_BEYOND,),
            maps=((13 * k2.ROUTES[dtype][2],),), d=37)
        lap(f"beyond_{route}")
        out["repeatable"][route] = checks.check_comm_fusion_repeatable(gen, "cuda", dtype)
        out["graph_replay"][route] = checks.check_comm_fusion_graph_replay(gen, dtype)
        lap(f"bits_{route}")
        out["k1_wide"][route] = checks.check_upsample_argmax_wide(gen, "cuda", dtype)
        lap(f"k1_wide_{route}")
    out["every_n"] = {_route(dtype): checks.check_comm_fusion_every_n(gen, "cuda", dtype,
                                                                     P18_EVERY_N)
                      for dtype in (torch.float32, torch.bfloat16, torch.float16)}
    lap("every_n")
    out["k1_wide_routes"] = k1_wide_routes(gen)
    lap("k1_wide_routes")
    records = []
    for dtype, (b, n, rest) in P18_RECORD_SHAPES.items():
        q, k, v = checks.wide_comm_inputs(gen, b, n, checks.WIDE_KEY, rest, dtype, "cuda")
        err = max(checks.check_comm_fusion(q, k, v, mode, DIAG_BIAS, THRES) for mode in k2.MODES)
        records.append(comm_fusion_record("comm_fusion_wide" + _suffix(dtype), q, k, v, err,
                                          cupti=None))
        lap(f"record_{_route(dtype)}")
    return records, out


def p18_sweep(dtype: str, agents) -> dict:
    """(b): ``bench_agents.sweep`` (256x256, B*N = 96) on the card, each N's
    launches held there (K1 and K2 once a step, K2 on its planned design
    alone: ``cluster`` up to 16 agents, ``wide`` above) and its logits
    finite; here also that no N failed and the designs by N. Returns the
    rows and the launches summed over them by kernel, route and design."""
    rows = bench_agents.sweep(dtype=dtype, agents=agents)
    failed = [r for r in rows if not r["ok"]]
    if failed:
        raise AssertionError(f"bench_agents {dtype}: {failed}")
    for r in rows:
        want = "cluster" if r["agents"] <= k2.CLUSTER_AGENTS else "wide"
        if r["design"] != want:
            raise AssertionError(f"bench_agents {dtype} N={r['agents']}: design {r['design']}")
    sums = {"upsample_argmax": sum(r["launches"]["upsample_argmax"] for r in rows),
            "comm_fusion": {design: sum(r["designs"][design] for r in rows)
                            for design in k2.DESIGNS}}
    return {"dtype": dtype, "rows": [{k_: v for k_, v in r.items() if k_ != "step_s"}
                                     for r in rows], "launches": sums}


@_no_tf32()
def p18_card_vs_cpu() -> dict:
    """(c): MIMOcom at full width, P18_CPU_AGENTS agents at 128x128, batch 1,
    float32 with TF32 off, one set of seeded weights (``bench._build``: at
    these frames its graph is peaked, so links survive ``activated``), on
    the card (K2's wide design, counted) and on the CPU: actions and
    bandwidth equal, class maps (K1 on the card, its plain version on the
    CPU) on at least P18_AGREEMENT of the pixels, and a link kept. The
    graph and the fused maps K2 forms on the card from the card's own Q',
    K and V are held to the function in float64 of those values
    (``checks.check_comm_fusion_against_float64``: graph 1e-6, masks equal,
    fused rtol/atol 1e-5; at these logits the plain version's float32
    sums lie beyond 1e-6 from float64's, so it is no reference here). The whole
    model's graph is not held to a bound: its logits reach ~250, so the
    towers' float32 sums move it (the CPU's float32 graph lies ~2e-5 from
    its float64 one); the card's and the CPU's distances from the CPU's
    float64 model are printed."""
    cpu, size = torch.device("cpu"), P18_CPU_SIZE
    out = {}
    for n in P18_CPU_AGENTS:
        model = bench._build(size, n, "float32", cpu)
        card, model64 = copy.deepcopy(model).to("cuda"), copy.deepcopy(model).double()
        x = bench._inputs(1, size, n, torch.float32, cpu)[0]
        for mode in P18_CPU_MODES:
            _zero_designs()
            with torch.inference_mode():
                c_pre, c_prob, c_act, c_nc = model(x, inference=mode, full_res=False)
                g_pre, g_prob, g_act, g_nc = card(x.to("cuda"), inference=mode, full_res=False)
                x_prob = model64(x.double(), inference=mode, full_res=False)[1]
                c_cls = k1.upsample_argmax(c_pre, size, size)
                g_cls = k1.upsample_argmax(g_pre, size, size).cpu()
            if _designs() != {"cluster": 0, "wide": 1}:
                raise AssertionError(f"card vs CPU N={n} {mode}: K2 designs {_designs()}")
            agree = (g_cls == c_cls).float().mean().item()
            row = {"pixel_agreement": agree, "num_connect": float(c_nc),
                   "card_num_connect": float(g_nc),
                   "graph_card_vs_cpu": float((g_prob.cpu() - c_prob).abs().max()),
                   "graph_card_vs_float64": float((g_prob.cpu().double() - x_prob).abs().max()),
                   "graph_cpu_vs_float64": float((c_prob.double() - x_prob).abs().max())}
            if not torch.equal(g_act.cpu(), c_act) or float(g_nc) != float(c_nc) or \
                    agree < P18_AGREEMENT or not float(c_nc) > 0:
                raise AssertionError(f"card vs CPU N={n} {mode}: {row}, actions equal "
                                     f"{torch.equal(g_act.cpu(), c_act)}")
            with torch.inference_mode():
                val, keys, query = card._towers(x.to("cuda"))
                err = checks.check_comm_fusion_against_float64(
                    card.attention_net.project(query), keys, val,
                    "argmax" if mode == "argmax_test" else "activated", DIAG_BIAS, THRES)
            row["k2_on_card_inputs_max_abs_err"] = err
            out[f"{n}_{mode}"] = row
        del model, card, model64
    return out


def p18_full_width() -> dict:
    """(d): ``bench.bench_eval`` at P18_FULL (the flagship's widths, 24
    agents at 512x512, float32: K2's wide design, its launches and designs
    held once a step), eval ms and K2's device ms a call on the path; then
    P18_GRAPH_BATCHES seeded batches through ``Evaluator`` with CUDA graphs
    (``graphs.GraphCache``: the last batch a replay) and eagerly, their
    class maps, graphs, actions and bandwidth equal bit for bit."""
    _zero_designs()
    r = bench.bench_eval(count=False, **P18_FULL)
    if _designs() != {"cluster": 0, "wide": r["steps"]}:
        raise AssertionError(f"bench_eval at {P18_FULL}: K2 designs {_designs()}, "
                             f"{r['steps']} steps")
    out = {"eval_ms": r["step_s"] * 1e3, "frames_per_s": r["fps"], "steps": r["steps"],
           "device_ms": r["device_ms"], "busy": r["busy"],
           "k2_path_device_ms": r["kernel_device_ms"]["comm_fusion"],
           "k1_path_device_ms": r["kernel_device_ms"]["upsample_argmax"],
           "route_launches": r["route_launches"], "designs": _designs()}
    cfg = bench._config(P18_FULL["img"], P18_FULL["agents"], P18_FULL["dtype"])
    cfg["training"]["batch_size"] = P18_FULL["batch"]
    state = bench._build(P18_FULL["img"], P18_FULL["agents"], "float32",
                         torch.device("cpu")).state_dict()
    batches = seeded_batches(P18_GRAPH_BATCHES, P18_FULL["batch"], P18_FULL["agents"],
                             P18_FULL["img"], SEED + 180, "None")
    evs = {True: Evaluator(cfg), False: Evaluator(cfg, graphs=False)}
    for ev in evs.values():
        ev.model.load_state_dict(state)
    with contextlib.redirect_stdout(io.StringIO()):
        runs = _graph_eval_runs(evs, batches)
    for r_graph, r_eager in zip(runs[True]["res"], runs[False]["res"]):
        for key, value in r_eager.items():
            if not torch.equal(r_graph[key], value):
                raise AssertionError(f"N={P18_FULL['agents']}: graph eval {key} differs "
                                     "from eager")
    want = {"upsample_argmax": P18_GRAPH_BATCHES, "comm_fusion": P18_GRAPH_BATCHES,
            "int8_conv": 0}
    if any(run["launches"] != want for run in runs.values()):
        raise AssertionError(f"graph against eager at N={P18_FULL['agents']}: launches "
                             f"{[run['launches'] for run in runs.values()]}, want {want}")
    out["graph_equals_eager"] = {"batches": P18_GRAPH_BATCHES, "launches": want,
                                 "compared": sorted(runs[True]["res"][0])}
    return out


def run_phase18(records: list) -> dict:
    """Phase 18: MIMOcom beyond 16 agents (the module docstring's (a)-(d)).
    Adds the wide design's records to ``records`` and the sweep's launches
    to K1's and K2's; prints ``phase18_seconds``."""
    seconds, t0 = {}, time.perf_counter()

    def lap(name: str) -> None:
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())

    wide, out = p18_kernels(torch.Generator().manual_seed(SEED + 18))
    print("phase18_kernels " + json.dumps(out))
    next(rec for rec in records if rec["name"] == "upsample_argmax")["wide_routes"] = \
        out["k1_wide_routes"]
    lap("a_kernels")
    sweep = {"bf16": p18_sweep("bfloat16", bench_agents.AGENTS),
             "f16": p18_sweep("float16", P18_F16_AGENTS)}
    print("phase18_sweep " + json.dumps(sweep))
    lap("b_sweep")
    print("phase18_card_vs_cpu " + json.dumps(p18_card_vs_cpu()))
    lap("c_card_vs_cpu")
    full = p18_full_width()
    print("phase18_full_width " + json.dumps(full))
    lap("d_full_width")
    wide[0]["launches"] = full["designs"]["wide"]
    wide[0]["path_device_ms"] = full["k2_path_device_ms"]
    for rec, leg in zip(wide[1:], ("bf16", "f16")):
        rec["launches"] = sweep[leg]["launches"]["comm_fusion"]["wide"]
    by_name = {rec["name"]: rec for rec in records}
    for leg in ("bf16", "f16"):
        by_name[f"upsample_argmax_{leg}"]["phase18_launches"] = \
            sweep[leg]["launches"]["upsample_argmax"]
    by_name["comm_fusion_bf16"]["phase18_launches"] = \
        sweep["bf16"]["launches"]["comm_fusion"]["cluster"]  # N = 6 and 12
    by_name["upsample_argmax"]["phase18_launches"] = \
        full["route_launches"]["upsample_argmax"]["f32"]
    records += wide
    print("phase18_seconds " + json.dumps(seconds))
    return {"kernels": out, "sweep": sweep, "full_width": full, "seconds": seconds}


# ------------------------------------------------------------------ phase 19

P19_PIPELINE = ((2, False), (2, True), (16, False), (16, True))  # (batch, raw uint8 frames)
P19_LEG1_ITERS, P19_VAL_INTERVAL, P19_LEG2_ITERS = 200, 100, 300
P19_FRAMES = 4  # frames a trajectory of the 512x512 fixture
P19_AGENTS = 6
P19_KERNELS = (k1.upsample_argmax, k2.comm_fusion, k4.int8_conv)


def _p19_counts() -> dict:
    """K1's, K2's and K4's launches by route since the last call; the
    counts are set to 0."""
    counts = {kern.__name__: dict(kern.route_launches) for kern in P19_KERNELS}
    bench._zero_launches(P19_KERNELS)
    return counts


def _printed(fn, *args, **kwargs) -> tuple:
    """``fn``'s value and its standard output (kept off the smoke's)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        value = fn(*args, **kwargs)
    return value, out.getvalue()


def p19_pipeline() -> dict:
    """(a) ``bench_eval_pipeline.main`` at each of P19_PIPELINE: it raises
    unless the depths record equal metrics and K1 and K2 launch once a batch
    on the bf16 route in every pass; held again here from its JSON line."""
    from multiagentperception_tpu_torch import bench_eval_pipeline as bep

    out = {}
    for batch, raw in P19_PIPELINE:
        (sync, asyn), printed = _printed(bep.main, batch=batch, raw_uint8=raw)
        lines = printed.strip().splitlines()
        r = json.loads(lines[-1])
        want = {"upsample_argmax": r["n_batches"], "comm_fusion": r["n_batches"]}
        if any(v != want for v in r["launches_per_pass"].values()) or \
                (r["sync_s"], r["async_s"]) != (sync, asyn) or len(lines) != 4:
            raise AssertionError(f"bench_eval_pipeline at batch {batch}: {printed}")
        out[f"b{batch}_{r['tag']}"] = {k: r[k] for k in (
            "sync_frames_per_s", "async_frames_per_s", "speedup", "launches_per_pass",
            "bandwidth")}
    return out


def p19_learning() -> dict:
    """(b) ``prove_learning.main(tradeoff=True)`` at its defaults, the
    counts zeroed before each stage and read after: training (its one
    validation runs ``softmax`` at full resolution: no K1, no K2), the
    ``activated`` eval, the int8 eval and the tradeoff. K1 and K2 once a
    batch of each eval where the mode runs them, K2 also on the int8
    calibration batch, K4 48 times an int8 batch; 9 rows, the top-k
    bandwidth non-decreasing in k, every bandwidth within [0, N - 1] and
    mIoU within [0, 1]; the four metrics finite."""
    from multiagentperception_tpu_torch import prove_learning as pl

    batches = 2 * LEARN_FRAMES // LEARN_BATCH  # the train split: 2 trajectories
    counts, rows = {}, []
    real = {"train": Trainer.train, "int8": pl.int8_miou, "tradeoff": pl.tradeoff_curve}

    def train(self):
        _p19_counts()
        value = real["train"](self)
        counts["train"] = _p19_counts()
        return value

    def int8(*args):
        counts["activated"] = _p19_counts()
        value = real["int8"](*args)
        counts["int8"] = _p19_counts()
        return value

    def tradeoff(*args):
        rows.extend(real["tradeoff"](*args))
        counts["tradeoff"] = _p19_counts()
        return rows

    t0 = time.perf_counter()
    Trainer.train, pl.int8_miou, pl.tradeoff_curve = train, int8, tradeoff
    try:
        metrics, printed = _printed(pl.main, tradeoff=True)
    finally:
        Trainer.train, pl.int8_miou, pl.tradeoff_curve = \
            real["train"], real["int8"], real["tradeoff"]
    seconds = time.perf_counter() - t0
    f32 = {name: {k: c[k]["f32"] for k in c} for name, c in counts.items()}
    want = {"train": (0, 0, 0), "activated": (batches, batches, 0),
            "int8": (batches, batches + 1, 48 * batches),
            "tradeoff": (9 * batches, 2 * batches, 0)}
    got = {name: (c["upsample_argmax"], c["comm_fusion"], c["int8_conv"])
           for name, c in f32.items()}
    other = {name: c for name, c in counts.items()
             if any(n for kern in c.values() for r, n in kern.items() if r != "f32")}
    if got != want or other:
        raise AssertionError(f"prove_learning launches {counts}, want (K1, K2, K4) {want}")
    topk = [bw for mode, bw, _ in rows if mode.startswith("topk")]
    if len(rows) != P19_AGENTS + 3 or topk != sorted(topk) or not all(
            0.0 <= bw <= P19_AGENTS - 1 and 0.0 <= miou <= 1.0 for _, bw, miou in rows) or \
            not all(np.isfinite(float(v)) for v in metrics):
        raise AssertionError(f"prove_learning: {metrics} {rows}")
    for label in ("train-set mIoU (activated):", "mimo when2com selection accuracy:",
                  "train-set mIoU, int8-quantized serving path:"):
        if label not in printed:
            raise AssertionError(f"prove_learning printed no {label!r}")
    return {"seconds": seconds, "miou": float(metrics[0]), "when2com_acc": float(metrics[1]),
            "who2com_acc": float(metrics[2]), "miou_int8": float(metrics[3]),
            "tradeoff": [[mode, float(bw), float(miou)] for mode, bw, miou in rows],
            "launches": got}


def _p19_leg(work: Path, name: str, iters: int, resume: str | None = None) -> tuple:
    """A started ``run_flagship_512`` leg at 512x512 over the shared fixture,
    in a workdir of its own."""
    leg = work / name
    leg.mkdir(parents=True)
    args = ["--iters", str(iters), "--val_interval", str(P19_VAL_INTERVAL),
            "--frames", str(P19_FRAMES), "--root", str(work / "data"), "--workdir", str(leg)]
    return _cli_start("run_flagship_512", *args, *(["--resume", resume] if resume else []),
                      cwd=leg)


def _p19_report(leg: Path, printed: str) -> dict:
    """A leg's ``report`` from its CLI log, checked: the post-train test with
    a bandwidth, a memory line at each validation."""
    from multiagentperception_tpu_torch import run_flagship_512 as rf

    r = rf.report((leg / rf.LOG_NAME).read_text())
    if r["test"] is None or not r["memory"] or "post-train test:" not in printed:
        raise AssertionError(f"{leg.name}: no post-train test or memory line: {r}")
    runs = sorted((leg / "runs" / "mrms_when2com_512_run").glob("*"))
    r["checkpoints"] = sorted(p.name for p in runs[-1].glob("*.pkl")) if runs else []
    return r


def p19_flagship_legs(work: Path, procs: list) -> dict:
    """(c) ``run_flagship_512`` in two legs at 512x512 over a fixture of
    P19_FRAMES frames a trajectory: leg 1 to P19_LEG1_ITERS with validation
    and ``latest`` every P19_VAL_INTERVAL, leg 2 in a new workdir resumed
    from leg 1's ``latest`` to P19_LEG2_ITERS; each started process is
    appended to ``procs``. Both exit 0; leg 1 reads Time/Image, 2
    validations with 2 selection readings and a best checkpoint; leg 2
    prints nothing before its resumed iteration."""
    legs, t0 = {}, time.perf_counter()
    procs.append(_p19_leg(work, "leg1", P19_LEG1_ITERS))
    printed, legs["leg1_s"] = _cli_wait(procs[-1])
    leg1 = _p19_report(work / "leg1", printed)
    latest = sorted((work / "leg1" / "runs").rglob("MIMOcom_airsim_latest.pkl"))
    if not latest:
        raise AssertionError("leg 1 wrote no latest checkpoint")
    procs.append(_p19_leg(work, "leg2", P19_LEG2_ITERS, str(latest[-1])))
    printed, legs["leg2_s"] = _cli_wait(procs[-1])
    leg2 = _p19_report(work / "leg2", printed)
    if not leg1["time_image"] or len(leg1["val_overall"]) != 2 or \
            len(leg1["val_when2com"]) != 2 or "MIMOcom_airsim_best_model.pkl" not in \
            leg1["checkpoints"] or not (leg2["first_iter"] or 0) > P19_LEG1_ITERS:
        raise AssertionError(f"run_flagship_512 legs: {leg1} {leg2}")
    memory = leg1["memory"] + leg2["memory"]
    out = {"seconds": {**legs, "both": time.perf_counter() - t0}}
    for name, r in (("leg1", leg1), ("leg2", leg2)):
        out[name] = {k: r[k] for k in ("sustained", "val_overall", "val_when2com", "test",
                                       "first_iter", "memory", "checkpoints")}
    out["max_host_rss_gb"] = max(m[1] for m in memory)
    out["max_device_peak_gb"] = max(m[3] for m in memory)
    return out


def _stop(procs: list) -> None:
    for proc, *_ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def start_phase19_legs() -> dict:
    """Phase 19 (c) started on a thread of its own, its legs' processes
    beside phases 15 and 17 (which take no trace and claim no speed);
    ``run_phase19`` joins it. Its processes are killed at exit."""
    work = WORK / "phase19"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    legs = {"work": work, "procs": [], "started": time.perf_counter()}

    def run() -> None:
        try:
            legs["result"] = p19_flagship_legs(work, legs["procs"])
        except Exception as err:  # raised again where run_phase19 joins
            legs["error"] = err
        legs["seconds"] = time.perf_counter() - legs["started"]

    atexit.register(_stop, legs["procs"])
    legs["thread"] = threading.Thread(target=run, name="phase19-legs", daemon=True)
    legs["thread"].start()
    return legs


def run_phase19(records: list, legs: dict) -> dict:
    """Phase 19: the user runs of scripts/ on the card, (a) and (b) in this
    process, then (c)'s legs (``start_phase19_legs``) joined (the module
    docstring)."""
    started = time.perf_counter()
    out, seconds = {}, {}

    def lap(name: str) -> None:
        seconds[name] = time.perf_counter() - started - sum(seconds.values())

    try:
        out["pipeline"] = p19_pipeline()
        print("phase19_pipeline " + json.dumps(out["pipeline"]))
        lap("a_pipeline")
        out["learning"] = p19_learning()
        print("phase19_learning " + json.dumps(out["learning"]))
        lap("b_learning")
        legs["thread"].join(timeout=2 * CLI_TIMEOUT_S)
        if legs["thread"].is_alive():
            raise AssertionError(f"phase 19 (c): no end after {2 * CLI_TIMEOUT_S} s")
    finally:
        _stop(legs["procs"])
    if "error" in legs:
        raise legs["error"]
    out["flagship"] = legs["result"]
    lap("c_flagship_wait")
    seconds["c_flagship_since_start"] = legs["seconds"]
    print("phase19_flagship " + json.dumps(out["flagship"]))
    print("phase19_seconds " + json.dumps(seconds))
    by_name = {rec["name"]: rec for rec in records}
    for name in ("upsample_argmax_bf16", "comm_fusion_bf16"):
        kern = name.removesuffix("_bf16")
        by_name[name]["phase19_launches"] = {
            key: {depth: n[kern] for depth, n in run["launches_per_pass"].items()}
            for key, run in out["pipeline"].items()}
    for i, name in enumerate(("upsample_argmax", "comm_fusion", "int8_conv")):
        by_name[name]["phase19_launches"] = {stage: counts[i] for stage, counts
                                             in out["learning"]["launches"].items()}
    shutil.rmtree(legs["work"], ignore_errors=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--int8-draws", type=int, default=0, metavar="N",
                        help="run only phase 10's trained int8 check, over N trainings")
    parser.add_argument("--phase15-rank", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--phase15-dir", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--phase17-rank", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--phase17-dir", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    if args.phase15_rank:
        return phase15_rank(args.phase15_rank, Path(args.phase15_dir))
    if args.phase17_rank:
        return phase17_rank(args.phase17_rank, Path(args.phase17_dir))
    if args.int8_draws:
        return int8_draws(args.int8_draws)
    eval_kernels = (k1.upsample_argmax, k2.comm_fusion)

    t0 = time.perf_counter()
    logs = _build.build()
    seconds = {"build": time.perf_counter() - t0}
    print(f"built {sorted(logs)} in {seconds['build']:.1f} s")

    def lap(name: str) -> None:
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())

    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log.strip()}", file=sys.stderr)
    for name in logs:
        for line in resource_lines(logs[name]):
            print(f"ptxas {name}: {line}")
    for name, opcode in [(lib, "HGMMA") for lib in TENSOR_CORE_LIBS] + K4_SASS:
        count = sass_count(name, opcode)
        print(f"{opcode} instructions in {name}'s SASS: {count}")
        if count < 1:
            raise AssertionError(f"{name}'s SASS holds no {opcode} instruction")

    gen = torch.Generator().manual_seed(SEED)
    records = [check_upsample_argmax(gen), check_comm_fusion(gen), *check_fused_block()]
    print("kernel checks passed; K3 " + json.dumps(records[2:]))
    drops = {"after_phase1": trace_drops(t0)}
    lap("1_kernels")
    print("k3_float64 " + json.dumps(k3_against_float64()))
    lap("1_k3_float64")

    slice_result = run_slice(eval_kernels)
    print("slice " + json.dumps(slice_result))
    for rec, kern in zip(records, eval_kernels):
        rec["launches"] = slice_result["launches"][kern.__name__]
        rec["path_device_ms"] = slice_result["path_kernel_device_ms"][kern.__name__]
        rec["kernel_ms"] = rec["ms"]

    lap("2_slice")
    print("card_vs_cpu " + json.dumps(card_vs_cpu()))
    lap("3_card_vs_cpu")

    k3_path = run_bench_path()
    for rec in records[2:]:
        rec["launches"] = k3_path[rec["k3_route"]]["launches"]
    print("k3_path " + json.dumps(k3_path))
    lap("4_k3_path")

    print("train " + json.dumps(run_training(eval_kernels)))
    lap("5_train")
    print("train_card_vs_cpu " + json.dumps(train_card_vs_cpu()))
    lap("6_train_card_vs_cpu")

    zoo = {}
    for yml in ZOO:
        zoo[yml.stem] = run_zoo_config(yml)
        print(f"zoo {yml.stem} " + json.dumps(zoo[yml.stem]))
    records[0]["zoo_launches"] = {name: {mode: row["k1_launches"]
                                         for mode, row in z["eval"].items()}
                                  for name, z in zoo.items()}
    lap("7_zoo")

    gen8 = torch.Generator().manual_seed(SEED + 8)
    bf16_records = [check_upsample_argmax(gen8, torch.bfloat16),
                    check_comm_fusion(gen8, torch.bfloat16)]
    print("kernel checks passed (bf16); " + json.dumps(bf16_records))
    lap("8_kernels_bf16")
    mp_eval = {"yaml_batch": run_slice(eval_kernels, dtype="bfloat16"),
               "bench_batch": run_slice(eval_kernels, dtype="bfloat16", batch=BENCH_BATCH,
                                        timed=BENCH_EVAL_BATCHES)}
    for rec, kern in zip(bf16_records, eval_kernels):
        rec["launches"] = mp_eval["yaml_batch"]["route_launches"][kern.__name__]["bf16"]
        rec["path_device_ms"] = mp_eval["yaml_batch"]["path_kernel_device_ms"][kern.__name__]
        rec["launches_bench_batch"] = \
            mp_eval["bench_batch"]["route_launches"][kern.__name__]["bf16"]
        rec["path_device_ms_bench_batch"] = \
            mp_eval["bench_batch"]["path_kernel_device_ms"][kern.__name__]
        rec["kernel_ms"] = rec["ms"]
    print("mixed_precision_eval " + json.dumps(mp_eval))
    lap("8_eval_bf16")
    print("mixed_precision_card_vs_cpu " + json.dumps(mixed_card_vs_cpu("bfloat16")))
    lap("8_card_vs_cpu_bf16")
    print("mixed_precision_train " + json.dumps(run_training(eval_kernels, True)))
    lap("8_train_bf16")
    zoo16 = {}
    for yml in ZOO:
        zoo16[yml.stem] = run_zoo_bf16(yml)
        print(f"zoo_bf16 {yml.stem} " + json.dumps(zoo16[yml.stem]))
    bf16_records[0]["zoo_launches"] = {name: z["k1_bf16_launches"] for name, z in zoo16.items()}
    records += bf16_records
    lap("8_zoo_bf16")
    run_phase16(records, lap)  # beside its bf16 counterpart (module docstring)

    print("kernel checks passed at the bench's batch " +
          json.dumps(check_kernels_at_bench_batch(torch.Generator().manual_seed(SEED + 10))))
    print("k2_graph_float64 " + json.dumps(k2_graph_against_float64(
        torch.Generator().manual_seed(SEED + 11))))
    bench_runs = {dtype: run_bench(dtype) for dtype in BENCH_DTYPES}
    for rec, kern in zip(records[:2] + bf16_records, eval_kernels * 2):
        run = bench_runs["bfloat16" if rec["name"].endswith("_bf16") else "float32"]
        rec["launches_bench_b20"] = run["eval_route_launches"][kern.__name__][
            bench.ROUTE[run["dtype"]]]
        rec["path_device_ms_bench_b20"] = run["eval_kernel_device_ms"][kern.__name__]
    print("remat " + json.dumps(remat_pair()))
    lap("9_bench")
    run_phase18(records)  # beside the bench, while traces still hold their records
    lap("18_agents")

    k4_records = check_int8_conv(torch.Generator().manual_seed(SEED + 40))
    print("int8 kernel checks passed; " + json.dumps(k4_records))
    lap("10_k4")
    int8_eval = {route: run_int8_slice(None if dtype == torch.float32 else "bfloat16")
                 for route, dtype in K4_DTYPES.items()}
    print("int8_eval " + json.dumps(int8_eval))
    for rec, (route, run) in zip(k4_records, int8_eval.items()):
        rec["launches"] = run["launches"]["int8_conv"][route]
        rec["path_device_ms_per_batch"] = run["k4_device_ms_per_batch"]
        bench_run = bench_runs["bfloat16" if route == "bf16" else "float32"]
        rec["launches_bench_b20"] = bench_run["eval_int8_route_launches"]["int8_conv"][route]
        rec["path_device_ms_bench_b20"] = bench_run["eval_int8_kernel_device_ms"]["int8_conv"]
    records += k4_records
    lap("10_int8_eval")
    print("int8_card_vs_cpu " + json.dumps([int8_card_vs_cpu(), int8_card_vs_cpu("bfloat16")]))
    lap("10_int8_card_vs_cpu")
    print("int8_trained_card_vs_cpu " + json.dumps(trained_int8_card_vs_cpu()))
    lap("10_int8_trained_card_vs_cpu")

    serving = run_serving()
    print("serving " + json.dumps(serving))
    for rec in records:  # each record's launches on the serving path of its type
        run = {"upsample_argmax": "float32", "comm_fusion": "float32", "int8_conv": "int8",
               "upsample_argmax_bf16": "bfloat16", "comm_fusion_bf16": "bfloat16"}.get(rec["name"])
        if run is not None:
            kern = rec["name"].removesuffix("_bf16")
            rec["serving_launches"] = sum(serving[run]["launches"][kern].values())
    lap("11_serving")

    print("phase12 card " + run_phase12(records)["card"])
    lap("12_model_surface")
    run_phase13(records)
    lap("13_graphs")
    run_phase14(records)
    lap("14_loader")
    drops["before_phase15"] = trace_drops(t0)
    legs = start_phase19_legs()  # beside phases 15 and 17 (start_phase19_legs)
    run_phase15(records)
    drops["after_phase15"] = trace_drops(t0)
    print("trace_drops " + json.dumps(drops))
    if min(drops["after_phase15"]["missing_per_window"]) == TRACE_PROBE_LAUNCHES:
        raise AssertionError(f"no trace after phase 15 holds a kernel record: {drops}")
    lap("15_parallel")
    run_phase17(records)  # takes no trace (module docstring)
    lap("17_parallel_model")
    run_phase19(records, legs)
    lap("19_user_runs")
    print("phase_seconds " + json.dumps(seconds))

    print(bench._card_line())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
