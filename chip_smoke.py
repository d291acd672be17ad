#!/usr/bin/env python3
"""Drive the PyTorch port (meme_challenge_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only        # the build and phases 3-3f
    python3 chip_smoke.py --adam-only           # the build and phase 3b
    python3 chip_smoke.py --graph-only          # the build and phase 3c
    python3 chip_smoke.py --gemm-only           # the build and phases 3d, 3f, 3g, 3c
    python3 chip_smoke.py --list-only           # the build and phases 3f, 3g
    python3 chip_smoke.py --expert-only         # the build and phases 3e, 11d
    python3 chip_smoke.py --uniter-large-only   # the build and phase 15
    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 chip_smoke.py --det-determinism

Phases, each of which makes the script exit non-zero if it fails:

1. The card's name and power limit (nvidia-smi).
2. Build every CUDA kernel of the port from the sources in this checkout
   (one nvcc per library, started together).
3. Kernel phase: each kernel at the main path's shapes (UNITER-base
   attention: B 16, H 12, S 160, D 64; the backward also at B 32, as
   --fuse_accum gives it) and at ragged shapes, float32 and bfloat16,
   dropout rate 0 and 0.1, against its plain PyTorch version on the same
   inputs (TF32 off): the forward within atol 1e-5 (float32) / 2e-2
   (bfloat16), the backward's dq, dk, dv within 1e-5 / 2e-2 of each one's
   largest magnitude; under dropout exactly the zero positions of the plain
   version (one-hot v windows reveal the forward's dropped probabilities,
   one-hot dout windows the backward's through dv); two backward calls with
   dropout on give the same bits. Each launch's CUDA body (``mma_bf16`` and
   ``mma_tf32x3`` on the tensor cores, ``cuda_core``) is read from the
   per-route launch counts and must be the one ``attention_route`` names;
   the ragged shapes run both bodies of each dtype, and the rule's
   shared-memory formulas must equal the kernels' own. Times by CUDA events
   at rate 0 and 0.1: the kernel, its plain version, and torch's
   scaled_dot_product_attention (forward, or backward through autograd) as
   a yardstick the port never calls (with its own error against the plain
   version), beside the least time the card could take (the bound; float32
   at three TF32 products a product). ptxas's registers, spills and shared
   memory of every kernel are printed after the build. The seed shard: both
   kernels on a rank's slice of 2 folds (rows 4-12 of 16, heads 6-12 of 12,
   as a data and a model axis of 2 give it), fp32 and bf16, dropout 0.1,
   forward and backward against the plain version with the same shard, with
   the zero positions of the plain version and of one launch on the whole
   batch.
3b. The fused Adam update (``ops/csrc/fused_adam.cu``) at UNITER-base's 212
   and UNITER-large's 404 leaves, the recipe's optimizer (Adam, bf16
   moments, weight decay 1e-3, clip at 5.0), random fp32 leaves: three
   steps through ``Optimizer.step`` (the kernel, one launch a step) and
   through ``Optimizer.chain_step`` (the ``_foreach_*`` chain) from one
   start, the clip engaged, standing aside, engaged; parameters and moments
   equal bit for bit (odd and unaligned leaves: the card tests of
   tests/test_torch_fused_adam.py). Times by CUDA events: the kernel alone
   (with the arguments ``Optimizer.fused_update`` gives the step), the
   fused step (the clip's norm and the kernel), the chain's step, beside
   the bound (20 bytes a parameter at 3.35 TB/s), and the host ms of each
   step. Every later CLI phase that trains (train, crossval, fold-parallel,
   pretrain, handoff, text/Oscar, UNITER-large) holds the update's
   launches to its optimizer steps: ceil(leaves / 512) a step of Adam or
   AdamW over fp32 parameters, none a fold-parallel step (the chain). Those
   launches and 3b's times make the update's line in the kernels' record.
3c. The train step as one CUDA graph (``train/steps.py: make_train_step``;
   run once the synthetic dataset is made): 5 optimizer steps of
   full-width UNITER-base (fp32, per-sample kernel, dropout 0.1, the
   recipe's Adam with bf16 moments and clip, a step size that changes every
   step) eager (``train_step.eager``) and replayed (the first call
   captures), from the same weights, batches and generators, in both
   accumulation modes: every loss, probability, parameter and moment equal
   bit for bit; one capture and 4 replays, and a second batch shape
   captures once more and replays. Prints ms a step (synchronised), host ms
   to issue one, and the peaks of allocated and reserved memory of each.
   The step's encoder products run the 3×TF32 GEMM (3d): its launches
   must grow over the phase.
3d. The encoder's 3×TF32 GEMM (``ops/linear.py``, ``ops/csrc/
   linear_tf32x3.cu``) at UNITER-base's and UNITER-large's six product
   shapes (M 2 560 rows, 16 memes of 160 tokens; (N, K) = (H, H), (FFN, H),
   (H, FFN)), forward with bias, dgrad and wgrad, from random operands:
   each within 2× the plain version's (fp32 ``F.linear`` and the add,
   cuBLAS) error against float64, and the same bits on a second call; the
   launch's CUDA error is checked after every launch by the wrapper. Times
   by CUDA events: the kernel (with its split-K sum where the plan splits),
   the plain version, and ``F.linear(x, W, b)`` (``library_ms``, a yardstick
   the port never calls), beside the bound (2·M·N·K operations at 165
   TFLOP/s, or the operands and output once at 3.35 TB/s), and the host ms
   of a call of each under ``inference_mode`` (the forward as scoring calls
   it, ``ops/linear.py: linear``; ``host_ms``, the median of 7 loops of 50
   calls while the card is busy). Prints the six shapes' sums and their
   ratio, the six forwards' host ms, and the shapes at which the kernel's
   forward costs the host more than the plain version's.
3e. The experts' grouped 3×TF32 GEMM (``ops/expert_linear.py``,
   ``csrc/linear_tf32x3.cu: expert_gemm_tf32x3_kernel``) at the cell
   moonlight_objtext_ft_fp32's shapes: 6 144 tokens (rows for 6 picks
   each), 8 held experts, 1 872 rows drawn multinomially over them with one
   expert emptied, (N, K) = (2 816, 2 048) (gate and up) and (2 048,
   1 408) (down); forward, dgrad and wgrad against float64, each within 2×
   the plain per-expert fp32 products' error (TF32 off) while the same
   products with TF32 on must fail that tolerance; the same bits on a
   second call, the empty expert's weight gradient zero. Times by CUDA
   events: the kernel and the plain per-expert products, beside the bound
   (2·rows·N·K operations at 165 TFLOP/s, or the held experts' weights and
   the rows' inputs and outputs once at 3.35 TB/s).
3f. The 3×TF32 GEMM over a row list (``ops/linear.py: row_list``, the
   encoder's valid tokens): 16 memes of the ``ft_fp32`` traffic's [60 |
   100] slots (text log-normal with a median of 20 tokens over 4-60,
   regions uniform over 10-100; ≈ 49 % valid), 3d's nine (shape, product)
   pairs of UNITER-base and of UNITER-large: the listed rows within 2× the
   plain products' error against float64, the forward's and dgrad's other
   rows zero, the same bits on a second call, and the forward's listed rows
   the no-list launch's bits where the count's plan is the no-list plan.
   Times by CUDA events: the listed launch and the no-list launch, beside
   the bound at the listed rows; each model's sums and their ratio (the
   aim: ≤ 0.65). Then Moonlight-16B-A3B's dense products (no list) at its
   cell's 6 144 rows, forward, dgrad and wgrad.
3g. The row list's counter (``LISTED_ROWS``) over a short captured
   fine-tune of full-width UNITER-base (16 × 2 memes a step, random inputs):
   6 steps of ``ft_fp32``-traffic masks, then 2 all-valid: the rows the
   counter adds are each mask's valid rows and its rows offered, exactly
   (≈ 49 %, then 100 %), one capture and 7 replays.
4. Inference phase: full-width UNITER-base inference through the port's CLI
   (``train_uniter.main`` with ``--max_epoch 0``) on a synthetic dataset,
   each kernel in float32 and bfloat16. Checks the CSVs and metrics JSON,
   the launch counts (12 layers × eval batches, every bfloat16 launch on
   ``mma_bf16`` and every float32 one on ``mma_tf32x3``), and one batch's
   float32 logits on the card against the CPU (plain versions) within 1e-4.
5. Train phase: full-width UNITER-base fine-tunes through the same CLI (the
   README recipe with ``--num_folds 0``, 2 epochs, dropout 0.1): the
   per-sample kernel in float32 and with ``--compute_bf16``, the
   pair-blocked kernel with ``--fuse_accum`` in bfloat16 and float32.
   Checks forward and backward launch counts against the micro-batches
   stepped (and their routes, as in 4), finite losses, the best checkpoint, CSVs, metrics JSON, and
   prints train memes/s per epoch. Then one fp32 micro-batch's loss and
   gradients, card against CPU, within 1e-4; and where one train step's
   time goes (wall against host issue, kernels by torch.profiler).
6. Crossval phase: the README recipe through the same CLI at full width
   (``--num_folds -1 --crossval_use_dev``, dev size 16 on the synthetic
   dataset: one fold per 16 memes of the rarer label, 1 epoch a fold, the
   per-sample kernel in float32): the fold splits, every fold's best
   checkpoint, CSVs and metrics JSON, forward and backward launch counts
   over all folds (every launch on ``mma_tf32x3``), then the ensemble
   search on the card (the brute force and the device EA, which must have
   run) and its dev and test ``*_ensemble.csv`` files. Prints train
   memes/s and wall time per fold, and the ensemble's wall time.
7. Remat check: one float32 micro-batch at full width, dropout 0.1,
   ``remat`` with policy "full" and "dots" against no remat from the same
   generator seed: loss and every gradient within 1e-6 of the gradient's
   largest magnitude; the recompute launches the forward kernel again.
8. Ensemble at the recipe's size: random fold predictions from a seed,
   F 15 folds, N 500 memes (each fold predicts its half, 250; the rest
   −1). Times ``brute_force_finder`` (10 000 candidates) and the device EA
   (512 × 100) on the card, and the host EA beside them; checks 64
   candidates' ``ensemble_scores`` on the card against the host AUROC of
   the card's own mixes (1e-6), and the card's brute-force best score
   against the same search on the CPU (within 2 / (n_pos · n_neg)).
9. Fold-parallel: (a) both kernels at the fold-stacked shapes of F 3 folds
   (per-sample B 48 = 3 × 16, pair-blocked 3 × 32 with the block and the
   seeds of one fold), fp32 and bf16, rate 0 and 0.1, forward and backward
   against the plain versions (the kernel phase's tolerances, the same
   zero positions), the pair-blocked call also against three separate
   launches with the per-fold seeds; (b) the recipe of phase 6 through the
   CLI with ``--mesh_shape 1 --mesh_axes fold``, 1 epoch: every fold's
   checkpoint, CSVs and metrics JSON, the ensemble CSVs, and the attention
   launches, exactly 12 × (fold-stacked micro-batches + eval batches)
   forward and 12 × micro-batches backward, with no factor of F, all on
   ``mma_tf32x3``; train memes/s over all folds and a fold-stacked epoch's
   wall time beside phase 6's; (c) one full-width fold-stacked
   micro-batch at F 3, dropout on, against the three per-fold MemeUniters
   on the card (loss and every gradient within 1e-4 of its largest
   magnitude); (d) one optimizer step at F 1, 3 and 15 (remat "dots",
   fp32): wall and host-issue ms, launches (torch.profiler), memes/s and
   peak memory. Every number beside the card's name and power limit.
10. Pretraining (``UniterForPretraining`` at full UNITER-base width on the
   168-meme corpus, train + dev_seen): (a) one micro-batch of 4 a task
   (mlm, itm with OT 0.1, mrfr, mrc, mrc-kl), fp32, dropout off, card
   against CPU: the loss within 1e-4 relative, every gradient within 1e-4
   of its largest magnitude, 12 forward + 12 backward launches on
   ``mma_tf32x3``; IPOT alone at [16, 60, 100] with padding, card against
   CPU within 1e-4 relative, its device ms and launches; (b)
   ``pretrain_uniter`` through its CLI (mlm:2,itm,mrfr,mrc-kl, OT 0.1,
   16 × 2, 2 epochs): the per-sample kernel in fp32, and the pair-blocked
   kernel with --compute_bf16 --device_resident_data --fuse_accum: exact
   launch counts (12 + 12 a forward), finite losses, the dump and resume
   file, train memes/s by task; (c) that fp32 command in a process of its
   own, killed after its epoch-1 resume file, then a fresh process: it
   resumes at step 6 and ends within 1e-6 of (b)'s weights; the resume
   file's size and write time; (d) the fine-tune CLI from (b)'s dump
   loads it in "pretrain" mode and ends with a finite AUROC; (e) one
   optimizer step a task (16 × 2, Adam, dropout, fp32) measured as 9d.
   The launches of (b) and (d) count in the kernels' record.
11. Text-only and Oscar models at their published widths (every
   ``MODEL_DICT`` entry: bert, bert_large, roberta, roberta_large,
   roberta_mnli, albert, albert_large, electra; Oscar from
   configs/oscar-base.json with the fused kernels): (a) 2 memes of 60
   tokens with padding, fp32, dropout off, random weights from a seed:
   logits card vs CPU within 1e-4 relative, and for bert, albert and Oscar
   the loss and every gradient within 1e-4 of the gradient's largest
   magnitude; Oscar through the kernels on the card (12 + 12 launches on
   ``mma_tf32x3``) and their plain versions on the CPU; the text models
   launch no fused-attention kernel (their attention is the plain branch,
   as in JAX); (b) one optimizer step of each entry at batch 32 (AdamW,
   fp32), measured as 9d; (c) the four CLIs: train_pure_text bert with
   --num_layers_freeze 4 --lr_head 1e-4 (2 epochs; layers 0-3 of the best
   checkpoint bit-equal to their initial weights, the head moved),
   train_pure_text albert --compute_bf16 --device_resident_data,
   train_hatespeech bert (3 classes), train_object_text bert with a
   threshold range and swaps (1 epoch each; zero fused-attention
   launches), train_oscar fp32 per-sample (2 epochs) and bf16 pair-blocked
   --device_resident_data (1 epoch) with exact launch counts on the dtype's
   tensor-core body; every run's checkpoint, CSVs, metrics JSON and train
   memes/s. The Oscar CLI runs' launches count in the kernels' record.
   (d) ``train_object_text --model moonlight`` (Moonlight-16B-A3B, 8 of 64
   experts held, published widths) for 1 epoch without checkpoints: its
   step replays a CUDA graph, and the grouped kernel's launches (counted
   at each replay, in the kernels' record) are 3 forwards, 2 dgrads and 2
   wgrads an MoE layer and train micro-batch, and 2 forwards an MoE layer
   and eval batch.
12. Extraction: the bottom-up-attention detector at ``DetectorConfig()``
   (Caffe ResNet-101, 1601 classes, 401 attributes, shortest side 600,
   longest 1000), random weights from a seed with the decision layers
   rescaled (DET_SCALE), on 8 synthetic 600 × 800 images and one of
   480 × 1000: (a) card vs CPU, fp32 with TF32 off, module by module: the
   res4 map and the RPN outputs of one image, the ROI head on the same 32
   proposals from the same map, each within 1e-4 of its largest magnitude;
   the ROIPool of all proposals bit-equal on the card, the CPU and the
   native op, with its largest intermediate (at most 1 GiB); ``max_conf``
   identical through ``device`` and ``native_batched``; (b)
   ``extract_features`` through its CLI on PNG files: mode 1, 2, 3 (from
   mode 2's boxes) and a resumed mode 1 that writes nothing, every npz's
   keys and shapes; ``convert_feature_export`` → ``load_img_feature`` →
   ``MemeDataset`` → one UNITER-base forward through the fused kernels
   (12 launches, counted in the kernels' record); (c) s/img for each blob
   transfer dtype at lookahead 1 and 2 (equal to per-image ``extract``
   bit for bit), the bf16 and uint8 features
   against fp32 (2e-2), and one image's breakdown (host preprocessing,
   backbone + RPN, proposal stage, ROI stage, ``max_conf`` both ways, idle
   share, launches, top device operations, peak memory); (d) the
   ``visualize_boxes`` CLI on 2 images, where PIL and cv2 import.
13. Detector training at ``DetectorConfig()`` (phase 12's weights and
   images; SGD momentum 0.9 with the global-norm clip at 5, lr
   DET_TRAIN_LR): (a) one train step card vs CPU, fp32 with TF32 off, the
   blob cut to 320 × 448 for the CPU's sake, the same three draws: anchor
   and proposal labels equal, the clip and class-argmax decisions with
   margin, the five loss parts within 1e-5 relative and every gradient
   within 1e-4 of its leaf's largest magnitude on the card's ReLU
   decisions (at most 1e-5 of them may flip; the CPU's own pass printed
   beside it); ROIAlign's gradient card vs CPU at 64 proposals within
   1e-5; (b) ``train_detector`` through its CLI on 8 train and 4 val PNGs
   of 600 × 800: 2 epochs with finite losses at every step, the
   ``detector.pth`` dump before each evaluation, finite mAP and weighted
   mAP, ``--eval-only`` on the dump giving the last epoch's metrics,
   ``evaluate`` alone in s an image, and ``extract_features --weights`` on
   the dump; (c) one step's breakdown on a fixed 600 × 800 batch: wall and
   host-issue ms, device ms behind a sleep, kernels and the top device
   operations, idle share, launches, no host sync inside a step
   (``set_sync_debug_mode``), ROIAlign's forward and backward and their
   peak, the clip + SGD update, peak memory, images/s, the loss
   trajectory; the step's device ms with its determinism repair (cuDNN's
   deterministic algorithms, scoped to the step's gradient pass) and
   without it, in turns; then two identical gradient passes of the step
   must give the same bits (gated). The determinism diagnosis runs alone,
   with ``--det-determinism`` (the leaves that differ between two
   identical gradient passes as the step ran before the repair, with
   ``cudnn.deterministic``, and under
   ``torch.use_deterministic_algorithms``, the operations that raises or
   warns on, the kernels it swaps, ROIAlign's backward alone).
14. Multi-device, run right after 9b: (a) 9b's recipe through the CLI in
   a process of its own under ``torchrun --standalone --nproc_per_node 1``
   with ``--mesh_shape 1,1,1 --mesh_axes fold,data,model`` (an ``nccl``
   group of one rank, the mesh path of ``parallel/``): every fold's CSVs
   equal to 9b's plain ``--mesh_shape 1`` run's (ids, probabilities to the
   last written digit), the ensemble CSVs written, each epoch's ms an
   optimizer step of both runs side by side; (b)
   ``parallel/dryrun.py --spawn 1`` on the card, in a process of its own
   beside (a)'s (the fold-parallel driver of the dry run, content-checked
   CSVs, the ensemble search).
15. UNITER-large (configs/uniter-large.json: 24 layers, hidden 1024, 16
   heads of 64, through the CLI's loader, with the fused kernels), random
   weights from seeds: (a) MemeUniter, 2 memes with padding, fp32,
   dropout off, card against CPU: logits within 1e-4 relative, the loss
   and every gradient within 1e-4 of the gradient's largest magnitude,
   24 + 24 launches on ``mma_tf32x3``; (b) the four kernels at its shapes,
   per-sample [16, 16, 160, 64] and pair-blocked [32, 16, 160, 64] (blocks
   of 16 pairs), fp32 and bf16, rate 0 and 0.1, forward and backward
   against the plain versions (phase 3's tolerances, the same zero
   positions), with ms, bound and the library's ms; (c) the fine-tune CLI
   for 1 epoch, fp32 per-sample and bf16 pair-blocked with --fuse_accum,
   then serving the fp32 run's best checkpoint with --max_epoch 0: exact
   launch counts (24 a forward or backward) on the dtype's tensor-core
   body, finite losses, checkpoint, CSVs, metrics JSON, train and
   inference memes/s; (d) one optimizer step measured as 9d, per-sample
   fp32, bf16 --fuse_accum, fold-stacked at F 3 (remat "dots", fp32), and
   the largest F that fits, reckoned from F 3's peak; (e) the embedding
   repair's gate: two identical gradient passes bit-equal, each over a
   lookup of more than 3 072 ids (UNITER-base MemeUniter with
   --fuse_accum's 32 × 100 image type ids, UniterForPretraining's MRFR
   over 32 × 100 mask ids, bert at 64 × 60 tokens), beside the leaves that
   differ through ``F.embedding`` as before the repair.
   The launches of (c) count in the kernels' record, and each kernel's
   entry carries (b)'s figures under ``uniter_large``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.join(ROOT, "meme_challenge_tpu_torch")

# main-path attention shapes: UNITER-base, batch 16, 60 text + 100 boxes
B, H, S, D = 16, 12, 160, 64
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGIT_TOL = 1e-4
# H100 SXM data sheet (dense): memory bytes/s, and operations/s by type.
# float32 at fp32 accuracy is at best three TF32 products a product (the
# 3×TF32 split of the mma_tf32x3 bodies) at 495 TFLOP/s: the least time any
# body could take for the work, whichever body runs it.
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
REPLACES = {
    "fused_attention": "meme_challenge_tpu/ops/attention.py:96",
    "fused_attention_blocked": "meme_challenge_tpu/ops/attention.py:265",
    "fused_attention_bwd": "meme_challenge_tpu/ops/attention.py:114",
    "fused_attention_blocked_bwd": "meme_challenge_tpu/ops/attention.py:288",
}
SOURCE = {
    "fused_attention": "meme_challenge_tpu_torch/ops/csrc/fused_attention.cu",
    "fused_attention_blocked":
        "meme_challenge_tpu_torch/ops/csrc/fused_attention.cu",
    "fused_attention_bwd":
        "meme_challenge_tpu_torch/ops/csrc/fused_attention_bwd.cu",
    "fused_attention_blocked_bwd":
        "meme_challenge_tpu_torch/ops/csrc/fused_attention_bwd.cu",
    "fused_adam": "meme_challenge_tpu_torch/ops/csrc/fused_adam.cu",
    "linear_tf32x3": "meme_challenge_tpu_torch/ops/csrc/linear_tf32x3.cu",
}
# why the fused Adam update's record has no library time
ADAM_NO_LIBRARY = (
    "torch._fused_adam_ cannot compute this update: it keeps its moments "
    "in the parameters' dtype (the recipe: bf16 over fp32), takes no clip "
    "factors, one weight decay and one learning rate a call (no decay mask, "
    "no update scales), and orders the bias corrections otherwise "
    "(lr/c1 * m / (sqrt(v)/sqrt(c2) + eps))")


def fail(msg: str) -> None:
    print("FAIL: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


_CYCLES_PER_MS = []


def device_ms(fn, iters: int = 20, reps: int = 5) -> tuple:
    """(device ms per call, host ms per call) of ``fn``.

    The device time is taken with CUDA events around ``iters`` calls queued
    behind a ``torch.cuda._sleep`` long enough for the host to enqueue them
    all, so the card runs them back to back and the host's launch cost
    (Python, ctypes) stays out of it; the median of ``reps`` such runs. The
    host time is the wall time of one call while the card is busy."""
    import torch

    if not _CYCLES_PER_MS:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        b.synchronize()
        _CYCLES_PER_MS.append(10 ** 7 / a.elapsed_time(b))
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(_CYCLES_PER_MS[0] * (3 * iters * host + 5)))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times), host


def host_ms(fn, iters: int = 50, reps: int = 7) -> float:
    """Host ms a call of ``fn``: the median over ``reps`` loops of
    ``iters`` calls, each loop queued behind a ``torch.cuda._sleep`` long
    enough that no call waits for the card (the launch cost alone: Python,
    the dispatcher, ctypes, the allocator)."""
    import torch

    device_ms(fn, iters=2, reps=1)  # warms fn, sets _CYCLES_PER_MS
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(_CYCLES_PER_MS[0] * (iters * 0.2 + 5)))
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / iters)
    torch.cuda.synchronize()
    return statistics.median(times)


def attention_bound_ms(dtype: str, batch: int = B, heads: int = H) -> tuple:
    """Least time for one launch: q, k, v read once, out written once, the
    fp32 key bias read once; 2·S·S·D multiply-adds twice per pair."""
    item = 4 if dtype == "float32" else 2
    nbytes = 4 * batch * heads * S * D * item + batch * S * 4
    ops = 4 * batch * heads * S * S * D
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_bwd_bound_ms(dtype: str, batch: int, heads: int = H) -> tuple:
    """Least time for one backward: q, k, v, dout read once, dq, dk, dv
    written once, the fp32 key bias read once; five products (s, dp, dv, dq,
    dk) of 2·S·S·D multiply-adds per pair."""
    item = 4 if dtype == "float32" else 2
    nbytes = 7 * batch * heads * S * D * item + batch * S * 4
    ops = 10 * batch * heads * S * S * D
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_inputs(torch, dtype, gen, batch=B, heads=H):
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(batch, heads, S, D, generator=gen,
                           device="cuda").to(dt) for _ in range(3))
    lens = torch.randint(20, S + 1, (batch,), generator=gen, device="cuda")
    mask = (torch.arange(S, device="cuda")[None] < lens[:, None]).float()
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :].contiguous()
    return q, k, v, bias


# off the main path: S not a multiple of 16 or 32, D not a multiple of 16,
# the largest S and D the kernels take; each dtype's two routes in both
# directions (attention_route): S 24, 100, 17, 150 take the tensor-core body
# everywhere; S 160 at D 80 too in bf16, and in fp32 forward only (the fp32
# backward takes D <= 64); S 160 at D 128 the tensor-core forward and the
# cuda_core backward (bf16: shared memory); S 176 and 256 cuda_core
RAGGED = ((2, 3, 24, 8), (3, 4, 100, 64), (2, 2, 256, 128), (2, 12, 17, 16),
          (2, 4, 150, 64), (1, 2, 160, 80), (2, 4, 160, 128), (2, 3, 176, 64))


def ragged_inputs(torch, shape, dtype, gen, n_seeds, n=3):
    """n random [b, h, s, d] tensors, a key bias masking a random tail of
    each sample, and int32 seeds."""
    b, h, s, d = shape
    dt = getattr(torch, dtype)
    xs = [torch.randn(shape, generator=gen, device="cuda").to(dt)
          for _ in range(n)]
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    bias = ((torch.arange(s, device="cuda")[None] >= lens[:, None])
            .float() * -10000.0)[:, None, None, :].contiguous()
    seeds = torch.randint(0, 2 ** 31 - 1, (n_seeds,), generator=gen,
                          device="cuda", dtype=torch.int32)
    return xs, bias, seeds


def route_taken(A, name, fn):
    """Run fn() and return the route of the one launch of ``name`` it made,
    read from the per-route launch counts."""
    before = {r: A.ROUTE_LAUNCHES[(name, r)] for r in A.ROUTES}
    out = fn()
    taken = [r for r in A.ROUTES if A.ROUTE_LAUNCHES[(name, r)] != before[r]]
    if len(taken) != 1:
        fail("%s: expected one launch, got routes %s" % (name, taken))
    return out, taken[0]


# the two bodies each dtype can take
DTYPE_ROUTES = {"bfloat16": {"mma_bf16", "cuda_core"},
                "float32": {"mma_tf32x3", "cuda_core"}}


def check_routes(torch, A, name, taken, backward) -> None:
    """The routes ``taken`` ({(shape, dtype): route}) match attention_route,
    and each dtype took both of its routes."""
    for (shape, dtype), route in taken.items():
        want = A.attention_route(getattr(torch, dtype), shape[2], shape[3],
                                 backward)
        if route != want:
            fail("%s %s at %s took %s, the rule says %s"
                 % (name, dtype, shape, route, want))
    for dtype, routes in DTYPE_ROUTES.items():
        got = {r for (_, dt), r in taken.items() if dt == dtype}
        if got != routes:
            fail("%s: %s took %s, expected %s" % (name, dtype, got, routes))


def routes_by_shape(taken) -> dict:
    return {"%s %s" % (dt, shape[2:]): r for (shape, dt), r in taken.items()}


def ragged_checks(torch, A, gen) -> None:
    """Both kernels at RAGGED shapes (S not a multiple of 16, the largest S
    and D the kernel takes, both routes in bf16) against their plain
    versions."""
    for name, kernel, plain, n_seeds in (
            ("fused_attention", A.fused_attention, A.fused_attention_plain,
             lambda b, h: b),
            ("fused_attention_blocked", A.fused_attention_blocked,
             A.fused_attention_blocked_plain, A.blocked_seed_count)):
        taken = {}
        for shape in RAGGED:
            b, h, s, d = shape
            for dtype in ("float32", "bfloat16"):
                (q, k, v), bias, seeds = ragged_inputs(torch, shape, dtype,
                                                       gen, n_seeds(b, h))
                for rate in (0.0, 0.1):
                    out, taken[(shape, dtype)] = route_taken(
                        A, name,
                        lambda: kernel(q, k, v, bias, d ** -0.5, rate, seeds))
                    ref = plain(q, k, v, bias, d ** -0.5, rate, seeds)
                    err = (out.float() - ref.float()).abs().max().item()
                    if err > TOL[dtype] or not torch.equal(out == 0,
                                                           ref == 0):
                        fail("kernel %s %s at %s rate %g (%s): max_abs_err "
                             "%.3g" % (name, dtype, shape, rate,
                                       taken[(shape, dtype)], err))
        check_routes(torch, A, name, taken, backward=False)
        log("kernel %s at shapes %s, fp32 and bf16, rate 0 and 0.1: agrees "
            "with its plain version; routes %s"
            % (name, RAGGED, routes_by_shape(taken)))
    torch.cuda.synchronize()


def _rel_err(torch, got, ref) -> tuple:
    """(max |got − ref| over dq, dk, dv, max of that relative to each
    reference's largest magnitude)."""
    abs_err = rel = 0.0
    for a, b in zip(got, ref):
        e = (a.float() - b.float()).abs().max().item()
        abs_err = max(abs_err, e)
        rel = max(rel, e / max(b.float().abs().max().item(), 1e-30))
    return abs_err, rel


def _bwd_kernels(A):
    """(name, forward wrapper, seed_group, seed count) of both backward
    kernels for a [b, h, ...] input."""
    return (("fused_attention_bwd", A.fused_attention, lambda b, h: h,
             lambda b, h: b),
            ("fused_attention_blocked_bwd", A.fused_attention_blocked,
             lambda b, h: A._largest_block(b * h), A.blocked_seed_count))


def kernel_grads(torch, fwd, q, k, v, bias, do, scale, rate, seeds):
    """dq, dk, dv through the wrapper's autograd backward (the kernel)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fwd(*leaves, bias, scale, rate, seeds)
    return torch.autograd.grad(out, leaves, do)


def bwd_ragged_checks(torch, A, gen) -> None:
    """Both backward kernels at RAGGED shapes against the plain backward."""
    for name, fwd, group, n_seeds in _bwd_kernels(A):
        taken = {}
        for shape in RAGGED:
            b, h, s, d = shape
            for dtype in ("float32", "bfloat16"):
                (q, k, v, do), bias, seeds = ragged_inputs(
                    torch, shape, dtype, gen, n_seeds(b, h), n=4)
                for rate in (0.0, 0.1):
                    got, taken[(shape, dtype)] = route_taken(
                        A, name, lambda: kernel_grads(
                            torch, fwd, q, k, v, bias, do, d ** -0.5, rate,
                            seeds))
                    ref = A.fused_attention_bwd_plain(
                        q, k, v, bias, do, d ** -0.5, rate, seeds,
                        group(b, h))
                    _, rel = _rel_err(torch, got, ref)
                    if not rel <= TOL[dtype]:
                        fail("kernel %s %s at %s rate %g (%s): relative "
                             "error %.3g" % (name, dtype, shape, rate,
                                             taken[(shape, dtype)], rel))
        check_routes(torch, A, name, taken, backward=True)
        log("kernel %s at shapes %s, fp32 and bf16, rate 0 and 0.1: agrees "
            "with the plain backward; routes %s"
            % (name, RAGGED, routes_by_shape(taken)))
    torch.cuda.synchronize()


def bwd_kernel_phase(torch, A, gen) -> dict:
    """Both backward kernels at the main path's shapes (B 16, and B 32 as
    --fuse_accum gives them), fp32 and bf16, rate 0 and 0.1 with the same
    seeds: dq, dk, dv within TOL of the plain backward relative to each
    one's largest magnitude, and under dropout exactly the zeros of the
    plain backward's dv for one-hot dout windows (dv[j, d] = pd[c + d, j]).
    Two calls with dropout on give the same bits. Times at B 16: the
    backward kernels (through the autograd backward) at rate 0 and 0.1, the
    plain backward, and torch's scaled_dot_product_attention backward with
    the same mask at rate 0 and 0.1 (a yardstick the port never calls)."""
    bwd_ragged_checks(torch, A, gen)
    scale, rate = 1.0 / D ** 0.5, 0.1
    results = {}
    for name, fwd, group, n_seeds in _bwd_kernels(A):
        for dtype in ("float32", "bfloat16"):
            abs_err, rel_err, repeat_identical = 0.0, 0.0, True
            for batch in (B, 2 * B):
                q, k, v, bias = attention_inputs(torch, dtype, gen, batch)
                do = torch.randn(q.shape, generator=gen,
                                 device="cuda").to(q.dtype)
                seeds = torch.randint(0, 2 ** 31 - 1, (n_seeds(batch, H),),
                                      generator=gen, device="cuda",
                                      dtype=torch.int32)
                sg = group(batch, H)
                for r in (0.0, rate):
                    got = kernel_grads(torch, fwd, q, k, v, bias, do, scale,
                                       r, seeds)
                    ref = A.fused_attention_bwd_plain(q, k, v, bias, do,
                                                      scale, r, seeds, sg)
                    e_abs, e_rel = _rel_err(torch, got, ref)
                    abs_err, rel_err = max(abs_err, e_abs), max(rel_err,
                                                                e_rel)
                # with dropout on, a second call gives the same bits
                again = kernel_grads(torch, fwd, q, k, v, bias, do, scale,
                                     rate, seeds)
                repeat_identical &= all(bool(torch.equal(a, b))
                                        for a, b in zip(got, again))
                zeros_equal, dropped, total = True, 0, 0
                for c in (0, 64, 96):
                    probe = torch.zeros_like(do)
                    d_idx = torch.arange(D, device="cuda")
                    probe[:, :, c + d_idx, d_idx] = 1
                    zk = kernel_grads(torch, fwd, q, k, v, bias, probe,
                                      scale, rate, seeds)[2] == 0
                    zp = A.fused_attention_bwd_plain(
                        q, k, v, bias, probe, scale, rate, seeds, sg)[2] == 0
                    zeros_equal &= bool(torch.equal(zk, zp))
                    kept = A.fused_attention_bwd_plain(
                        q, k, v, bias, probe, scale, 0.0, seeds, sg)[2] != 0
                    dropped += int((zk & kept).sum())
                    total += int(kept.sum())
                torch.cuda.synchronize()
                log("kernel %s %s B %d: relative error %.3g (tol %g), "
                    "zero_positions_equal=%s dropped_share=%.4f "
                    "repeat_identical=%s"
                    % (name, dtype, batch, rel_err, TOL[dtype], zeros_equal,
                       dropped / max(total, 1), repeat_identical))
                if not (rel_err <= TOL[dtype] and zeros_equal
                        and repeat_identical):
                    fail("kernel %s %s disagrees with the plain backward or "
                         "with itself" % (name, dtype))
            # times at B 16, rate 0 and 0.1
            q, k, v, bias = attention_inputs(torch, dtype, gen)
            do = torch.randn(q.shape, generator=gen,
                             device="cuda").to(q.dtype)
            seeds = torch.randint(0, 2 ** 31 - 1, (n_seeds(B, H),),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            ms, ms_drop, host_ms = {}, {}, 0.0
            for r, times in ((0.0, ms), (rate, ms_drop)):
                out = fwd(*leaves, bias, scale, r, seeds)
                _, route = route_taken(A, name, lambda: torch.autograd.grad(
                    out, leaves, do, retain_graph=True))
                times["t"], host_ms = device_ms(lambda: torch.autograd.grad(
                    out, leaves, do, retain_graph=True))
            plain_ms, _ = device_ms(lambda: A.fused_attention_bwd_plain(
                q, k, v, bias, do, scale, 0.0, None, group(B, H)))
            lib = {}
            for r in (0.0, rate):
                lib_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                lib_out = torch.nn.functional.scaled_dot_product_attention(
                    *lib_leaves, attn_mask=bias.to(q.dtype), dropout_p=r,
                    scale=scale)
                lib[r], _ = device_ms(lambda: torch.autograd.grad(
                    lib_out, lib_leaves, do, retain_graph=True))
                if r == 0.0:  # the library's own error at these shapes
                    lib_err, lib_rel = _rel_err(torch, torch.autograd.grad(
                        lib_out, lib_leaves, do, retain_graph=True),
                        A.fused_attention_bwd_plain(q, k, v, bias, do, scale,
                                                    0.0, None, group(B, H)))
            bound_ms, bound_by = attention_bwd_bound_ms(dtype, B)
            log("kernel %s %s (%s): max_abs_err %.3g repeat_identical=%s | "
                "ms=%.4f ms_rate%.1f=%.4f plain_ms=%.4f library_ms=%.4f "
                "library_ms_rate%.1f=%.4f bound_ms=%.4f (%s) "
                "wrapper_host_ms=%.4f | library against the plain backward: "
                "max_abs_err %.3g, relative %.3g"
                % (name, dtype, route, abs_err, repeat_identical, ms["t"],
                   rate, ms_drop["t"], plain_ms, lib[0.0], rate, lib[rate],
                   bound_ms, bound_by, host_ms, lib_err, lib_rel))
            results[(name, dtype)] = dict(
                route=route, max_abs_err=abs_err, ms=ms["t"],
                ms_dropout=ms_drop["t"], plain_ms=plain_ms,
                library_ms=lib[0.0], library_ms_dropout=lib[rate],
                library_max_abs_err=lib_err, bound_ms=bound_ms,
                bound_by=bound_by)
    return results


def smem_rule_check(A) -> None:
    """The route rule's shared-memory formula and limits in Python
    (attention_route) are the CUDA sources' own."""
    fwd, bwd = A._lib(), A._bwd_lib()
    if fwd.fused_attention_mma_max_s() != A.MMA_MAX_S:
        fail("MMA_MAX_S %d, the kernel's %d"
             % (A.MMA_MAX_S, fwd.fused_attention_mma_max_s()))
    for s in (1, 17, 24, 100, 128, 150, 160):
        for d in (4, 8, 16, 20, 64, 80, 128):
            for c_fn, py_fn, backward in (
                    (fwd.fused_attention_mma_smem, A.mma_smem_bytes, False),
                    (bwd.fused_attention_bwd_mma_smem, A.mma_smem_bytes,
                     True),
                    (fwd.fused_attention_tf32_smem, A.tf32_smem_bytes, False),
                    (bwd.fused_attention_bwd_tf32_smem, A.tf32_smem_bytes,
                     True)):
                if c_fn(s, d) != py_fn(s, d, backward):
                    fail("%s(%d, %d, backward=%s) = %d, the kernel's %d"
                         % (py_fn.__name__, s, d, backward,
                            py_fn(s, d, backward), c_fn(s, d)))
    log("route rule: shared-memory formula and limits equal the kernels'")


# a rank's slice of 2 folds at the main path's shapes: rows [4, 12) of 16
# (a data axis of 2) and heads [6, 12) of 12 (a model axis of 2)
SHARD_FOLDS, SHARD_ROWS, SHARD_HEADS = 2, (4, 12), (6, 12)


def shard_kernel_checks(torch, A, gen) -> None:
    """Phase 3, the seed shard (``ops.attention.SeedShard``): both kernels
    on a rank's slice of SHARD_FOLDS folds of the main path's batch
    (SHARD_ROWS of each fold's 16 rows, SHARD_HEADS of its 12 heads), fp32
    and bf16, dropout 0.1: forward and backward against the plain version
    with the same shard (TOL, the backward relative), the same zero
    positions (one-hot v windows), and the slice of one launch on the whole
    batch: the dropped positions of a rank are the whole run's."""
    scale, rate = 1.0 / D ** 0.5, 0.1
    F_ = SHARD_FOLDS
    (r0, r1), (h0, h1) = SHARD_ROWS, SHARD_HEADS
    rows = [f * B + r for f in range(F_) for r in range(r0, r1)]
    shard = A.SeedShard(r0, B, h0, H)
    for name, wrapper, plain in (
            ("fused_attention", A.fused_attention, A.fused_attention_plain),
            ("fused_attention_blocked", A.fused_attention_blocked,
             A.fused_attention_blocked_plain)):
        blocked = name.endswith("blocked")
        n_seeds = A.blocked_seed_count(F_ * B, H, F_) if blocked else F_ * B
        seed_map = A._seed_map(len(rows), h1 - h0, F_, shard, blocked)
        for dtype in ("float32", "bfloat16"):
            q, k, v, bias = attention_inputs(torch, dtype, gen, F_ * B)
            seeds = torch.randint(0, 2 ** 31 - 1, (n_seeds,), generator=gen,
                                  device="cuda", dtype=torch.int32)
            part = [t[rows][:, h0:h1].contiguous() for t in (q, k, v)]
            pbias = bias[rows].contiguous()
            do = torch.randn(part[0].shape, generator=gen,
                             device="cuda").to(q.dtype)
            kw = dict(folds=F_, shard=shard)
            out = wrapper(*part, pbias, scale, rate, seeds, **kw)
            ref = plain(*part, pbias, scale, rate, seeds, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            whole = wrapper(q, k, v, bias, scale, rate, seeds, folds=F_)
            err_whole = (out.float() - whole[rows][:, h0:h1].float()).abs(
            ).max().item()
            got = kernel_grads(torch, lambda *a: wrapper(*a, **kw), *part,
                               pbias, do, scale, rate, seeds)
            ref_g = A.fused_attention_bwd_plain(*part, pbias, do, scale, rate,
                                                seeds, seed_map)
            rel_bwd = _rel_err(torch, got, ref_g)[1]
            zeros_equal, zeros_whole = True, True
            for c in (0, 64, 96):
                probe = torch.zeros_like(v)
                d_idx = torch.arange(D, device="cuda")
                probe[:, :, c + d_idx, d_idx] = 1
                pprobe = probe[rows][:, h0:h1].contiguous()
                zk = wrapper(*part[:2], pprobe, pbias, scale, rate, seeds,
                             **kw) == 0
                zp = plain(*part[:2], pprobe, pbias, scale, rate, seeds,
                           **kw) == 0
                zw = wrapper(q, k, probe, bias, scale, rate, seeds,
                             folds=F_)[rows][:, h0:h1] == 0
                zeros_equal &= bool(torch.equal(zk, zp))
                zeros_whole &= bool(torch.equal(zk, zw))
            torch.cuda.synchronize()
            tol = TOL[dtype]
            log(on_card(
                "kernel %s %s seed shard (rows %d-%d of %d, heads %d-%d of "
                "%d, %d folds): forward max_abs_err %.3g against the plain "
                "version, %.3g against the whole launch's slice; backward "
                "relative error %.3g (tol %g); zero_positions_equal=%s, "
                "equal to the whole launch's=%s" % (
                    name, dtype, r0, r1, B, h0, h1, H, F_, err, err_whole,
                    rel_bwd, tol, zeros_equal, zeros_whole)))
            if not (err <= tol and err_whole <= tol and rel_bwd <= tol
                    and zeros_equal and zeros_whole):
                fail("kernel %s %s with a seed shard disagrees" % (name,
                                                                   dtype))


def kernel_phase(torch) -> dict:
    from meme_challenge_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)
    smem_rule_check(A)
    ragged_checks(torch, A, gen)
    scale = 1.0 / D ** 0.5
    rate = 0.1
    pairs = (("fused_attention", A.fused_attention, A.fused_attention_plain,
              B),
             ("fused_attention_blocked", A.fused_attention_blocked,
              A.fused_attention_blocked_plain, A.blocked_seed_count(B, H)))
    results = {}
    for name, kernel, plain, n_seeds in pairs:
        for dtype in ("float32", "bfloat16"):
            q, k, v, bias = attention_inputs(torch, dtype, gen)
            seeds = torch.randint(0, 2 ** 31 - 1, (n_seeds,), generator=gen,
                                  device="cuda", dtype=torch.int32)
            out, route = route_taken(A, name,
                                     lambda: kernel(q, k, v, bias, scale))
            torch.cuda.synchronize()
            ref = plain(q, k, v, bias, scale)
            err0 = (out.float() - ref.float()).abs().max().item()
            out_d = kernel(q, k, v, bias, scale, rate, seeds)
            ref_d = plain(q, k, v, bias, scale, rate, seeds)
            err_d = (out_d.float() - ref_d.float()).abs().max().item()
            # one-hot v windows reveal every dropped probability p[i, j]
            zeros_equal, dropped, total = True, 0, 0
            for c in (0, 64, 96):
                probe = torch.zeros_like(v)
                d_idx = torch.arange(D, device="cuda")
                probe[:, :, c + d_idx, d_idx] = 1
                zk = kernel(q, k, probe, bias, scale, rate, seeds) == 0
                zp = plain(q, k, probe, bias, scale, rate, seeds) == 0
                zeros_equal &= bool(torch.equal(zk, zp))
                kept = plain(q, k, probe, bias, scale) != 0
                dropped += int((zk & kept).sum())
                total += int(kept.sum())
            torch.cuda.synchronize()
            tol = TOL[dtype]
            ok = err0 <= tol and err_d <= tol and zeros_equal
            ms, host_ms = device_ms(lambda: kernel(q, k, v, bias, scale))
            ms_drop, _ = device_ms(
                lambda: kernel(q, k, v, bias, scale, rate, seeds))
            plain_ms, _ = device_ms(lambda: plain(q, k, v, bias, scale))
            mask = bias.to(q.dtype)
            lib = {r: device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, dropout_p=r, scale=scale))[0]
                for r in (0.0, rate)}
            lib_err = (torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale).float()
                - ref.float()).abs().max().item()
            bound_ms, bound_by = attention_bound_ms(dtype)
            log("kernel %s %s (%s): max_abs_err rate0=%.3g rate%.1f=%.3g "
                "(tol %g) zero_positions_equal=%s dropped_share=%.4f | "
                "ms=%.4f ms_rate%.1f=%.4f plain_ms=%.4f library_ms=%.4f "
                "library_ms_rate%.1f=%.4f bound_ms=%.4f (%s) "
                "wrapper_host_ms=%.4f | library against the plain version: "
                "max_abs_err %.3g"
                % (name, dtype, route, err0, rate, err_d, tol, zeros_equal,
                   dropped / max(total, 1), ms, rate, ms_drop, plain_ms,
                   lib[0.0], rate, lib[rate], bound_ms, bound_by, host_ms,
                   lib_err))
            if not ok:
                fail("kernel %s %s disagrees with its plain version"
                     % (name, dtype))
            results[(name, dtype)] = dict(
                route=route, max_abs_err=max(err0, err_d), ms=ms,
                ms_dropout=ms_drop, plain_ms=plain_ms, library_ms=lib[0.0],
                library_ms_dropout=lib[rate], library_max_abs_err=lib_err,
                bound_ms=bound_ms, bound_by=bound_by)
    results.update(bwd_kernel_phase(torch, A, gen))
    shard_kernel_checks(torch, A, gen)
    for (name, dtype), r in results.items():
        if r["route"] != main_path_route(dtype):
            fail("%s %s took %s at the main path's shape"
                 % (name, dtype, r["route"]))
    return results


class PassLog:
    """Collects the trainer's per-pass inference records (memes, seconds)
    and per-epoch training records (memes, seconds), and the crossval
    driver's fold starts and end (host clock)."""

    def __init__(self):
        import logging

        self.passes, self.epochs, self.folds = [], [], []
        # pretraining: memes/s by task and (GB, s) of each resume file a
        # run wrote; the fine-tune CLI's load modes
        self.pretrain_rates, self.pretrain_saves, self.loads = [], [], []
        # fold-parallel: (steps, micro-batches a step) per epoch, the
        # stacked batches of each pass, and (GB, s) of each resume file
        self.fold_steps, self.fold_passes, self.fold_saves = [], [], []
        parent = self

        class Handler(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if msg.startswith("inference pass"):
                    _, n, secs = record.args[:3]
                    parent.passes.append((int(n), float(secs)))
                elif msg.startswith("train epoch"):
                    _, n, secs = record.args[:3]
                    parent.epochs.append((int(n), float(secs)))
                elif msg.startswith(("Starting fold",
                                     "Cross validation finished")):
                    parent.folds.append(record.created)
                elif str(record.msg).startswith("[fold-parallel] epoch %d: "):
                    _, steps, _, accum = record.args[:4]
                    parent.fold_steps.append((int(steps), int(accum)))
                elif msg.startswith("fold-parallel pass"):
                    parent.fold_passes.append(int(record.args[1]))
                elif msg.startswith("[fold-parallel] resume file"):
                    parent.fold_saves.append(record.args[1:3])
                elif msg.startswith("pretrain train memes/s by task"):
                    args = record.args
                    parent.pretrain_rates.append(
                        args if isinstance(args, dict) else args[0])
                elif msg.startswith("pretrain resume file"):
                    parent.pretrain_saves.append(record.args[1:3])
                elif msg.startswith("Loaded ") and msg.endswith(" dump)"):
                    parent.loads.append(record.args[1])

        self.handler = Handler(level=logging.INFO)
        for name in ("meme_challenge_tpu_torch.train",
                     "meme_challenge_tpu_torch.crossval",
                     "meme_challenge_tpu_torch.fold_parallel",
                     "meme_challenge_tpu_torch.pretrain",
                     "meme_challenge_tpu_torch.train_uniter"):
            logger = logging.getLogger(name)
            logger.setLevel(logging.INFO)
            logger.addHandler(self.handler)

    def clear(self):
        for records in (self.passes, self.epochs, self.folds,
                        self.fold_steps, self.fold_passes, self.fold_saves,
                        self.pretrain_rates, self.pretrain_saves,
                        self.loads):
            records.clear()


ADAM_RECIPE = dict(beta1=0.9, beta2=0.999, weight_decay=1e-3,
                   max_grad_norm=5.0, mu_dtype="bfloat16",
                   nu_dtype="bfloat16")
# the leaf count of every Optimizer.step call, whichever route it took
# (watch_optimizer_steps), and the fused update's launches that each CLI
# phase checked against them (check_adam_launches), by phase
OPT_STEPS = []
ADAM_MAIN_PATH = {}


def watch_optimizer_steps() -> None:
    """Record in OPT_STEPS the number of leaves of every optimizer step: of
    every ``Optimizer.step`` call, taken before the optimizer chooses its
    route, and of every replay of a captured train step (its update is the
    graph's fused Adam launch): the count the fused update's launches are
    held to."""
    from meme_challenge_tpu_torch.train.optim import Optimizer
    from meme_challenge_tpu_torch.train.steps import _StepGraphs

    step, replay = Optimizer.step, _StepGraphs._replay
    if getattr(step, "watched", False):
        return

    def watched(self, params, grads, state):
        OPT_STEPS.append(len(params))
        return step(self, params, grads, state)

    def watched_replay(self, g, state, batch, generator):
        OPT_STEPS.append(len(self.params))
        return replay(self, g, state, batch, generator)

    watched.watched = True
    Optimizer.step = watched
    _StepGraphs._replay = watched_replay


def adam_mark() -> tuple:
    """Where the fused update's launch count and OPT_STEPS stand now."""
    from meme_challenge_tpu_torch.ops import fused_adam

    return fused_adam.ADAM_LAUNCHES, len(OPT_STEPS)


def check_adam_launches(tag: str, mark: tuple, steps=None, leaves=None,
                        fused: bool = True) -> int:
    """The optimizer steps since ``mark`` (``adam_mark``): at least one,
    ``steps`` of them and each over ``leaves`` leaves where given, and the
    fused update's launches: ceil(leaves / max_leaves) a step where
    ``fused`` (Adam or AdamW of one model over fp32 parameters), none
    otherwise (the ``_foreach_*`` chain). Counts them in ADAM_MAIN_PATH;
    returns them."""
    from meme_challenge_tpu_torch.ops import fused_adam

    made = fused_adam.ADAM_LAUNCHES - mark[0]
    calls = OPT_STEPS[mark[1]:]
    want = (sum(_ceil(n, fused_adam.max_leaves()) for n in calls)
            if fused else 0)
    log("%s: %d optimizer steps (expected %s) over %s leaves (expected %s); "
        "fused Adam launches %d (expected %d)"
        % (tag, len(calls), "any" if steps is None else steps,
           sorted(set(calls)), "any" if leaves is None else leaves, made,
           want))
    if not calls or made != want or (
            steps is not None and len(calls) != steps) or (
            leaves is not None and set(calls) != {leaves}):
        fail("%s: %d optimizer steps over %s leaves, %d fused Adam launches; "
             "expected %s steps over %s leaves, %d launches"
             % (tag, len(calls), sorted(set(calls)), made, steps, leaves,
                want))
    if fused:
        ADAM_MAIN_PATH[tag] = made
    return made


def uniter_leaves(cfg) -> int:
    """The parameter leaves of MemeUniter(cfg): the leaves its fine-tune's
    optimizer updates."""
    import torch

    from meme_challenge_tpu_torch.models.uniter import MemeUniter

    with torch.device("meta"):
        return len(list(MemeUniter(cfg).parameters()))


def _adam_bits_equal(torch, tag, fused, chain) -> None:
    """Parameters and moments of two runs, bit for bit; names the first
    leaf that differs, with its count of differing elements."""
    (fp, fs), (cp, cs) = fused, chain
    for what, a, b in (("p", fp, cp), ("mu", fs["mu"], cs["mu"]),
                       ("nu", fs["nu"], cs["nu"])):
        for n in a:
            x, y = a[n], b[n]
            bits = torch.int32 if x.dtype == torch.float32 else torch.int16
            if x.dtype != y.dtype or not torch.equal(x.view(bits),
                                                     y.view(bits)):
                diff = int((x.view(bits) != y.view(bits)).sum())
                fail("fused Adam %s: %s of %s differs from the chain in %d "
                     "of %d elements" % (tag, what, n, diff, x.numel()))


def _adam_run(torch, opt, start, grads) -> tuple:
    """``opt.step`` and ``opt.chain_step`` from copies of ``start`` over
    ``grads`` (a list of steps): both runs' (params, state)."""
    from meme_challenge_tpu_torch.ops import fused_adam

    fused = {n: v.clone() for n, v in start.items()}
    chain = {n: v.clone() for n, v in start.items()}
    fs, cs = opt.init(fused), opt.init(chain)
    mu = dict(fs["mu"])
    before = fused_adam.ADAM_LAUNCHES
    for g in grads:
        opt.step(fused, g, fs)
        opt.chain_step(chain, g, cs)
    torch.cuda.synchronize()
    made = fused_adam.ADAM_LAUNCHES - before
    if made != len(grads):
        fail("fused Adam: %d launches for %d steps" % (made, len(grads)))
    if any(fs["mu"][n] is not mu[n] for n in mu):
        fail("fused Adam: the moments did not keep their tensors")
    return (fused, fs), (chain, cs)


def adam_phase(torch) -> dict:
    """Phase 3b (see the module's notes); returns each model's times."""
    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.models.uniter import MemeUniter
    from meme_challenge_tpu_torch.ops import fused_adam
    from meme_challenge_tpu_torch.train.optim import Optimizer

    gen = torch.Generator(device="cuda").manual_seed(18)
    out = {}
    for tag, cfg in (("uniter-base", UniterConfig()),
                     ("uniter-large", large_config())):
        with torch.device("meta"):
            shapes = {n: tuple(p.shape) for n, p in
                      MemeUniter(cfg).named_parameters()}
        n_params = sum(math.prod(s) for s in shapes.values())

        def leaves(scale):
            return {n: torch.randn(s, generator=gen, device="cuda") * scale
                    for n, s in shapes.items()}

        opt = Optimizer("adam", 3e-5, lambda count: 1.0, **ADAM_RECIPE)
        start = leaves(0.02)
        # global norms ≈ 1e-3·√n ≫ 5 (engaged), ≈ 1e-4·√n (base 1.0, large
        # 1.8: aside), engaged
        grads = [leaves(scale) for scale in (1e-3, 1e-4, 1e-3)]
        norms = [float(torch.linalg.vector_norm(torch.stack(
            [x.norm() for x in g.values()]))) for g in grads]
        if not norms[0] > 5.0 > norms[1]:
            fail("fused Adam %s: gradient norms %s do not straddle the "
                 "clip" % (tag, norms))
        fused, chain = _adam_run(torch, opt, start, grads)
        _adam_bits_equal(torch, tag, fused, chain)
        del chain, start
        grads = grads[:1]
        (params, state), g = fused, grads[0]
        # the kernel alone, with the arguments the fused step passes it
        args, kwargs = opt.fused_update(params, g, state,
                                        opt.prepare(params, state))
        kernel_ms, kernel_host = device_ms(
            lambda: fused_adam.adam_update(*args, **kwargs), iters=10, reps=3)
        step_ms, step_host = device_ms(lambda: opt.step(params, g, state),
                                       iters=5, reps=3)
        chain_p = {n: v.clone() for n, v in params.items()}
        chain_state = opt.init(chain_p)
        chain_ms, chain_host = device_ms(
            lambda: opt.chain_step(chain_p, g, chain_state), iters=2, reps=3)
        bound_ms = 20.0 * n_params / PEAK_BYTES * 1e3
        out[tag] = {"leaves": len(shapes), "params": n_params,
                    "bound_ms": bound_ms, "kernel_ms": kernel_ms,
                    "share": bound_ms / kernel_ms, "step_ms": step_ms,
                    "chain_ms": chain_ms, "kernel_host_ms": kernel_host,
                    "step_host_ms": step_host, "chain_host_ms": chain_host}
        log("fused Adam 3b %s: %d leaves, %d parameters bit for bit the "
            "chain over 3 steps (clip norms %s); kernel %.4f ms (bound %.4f "
            "ms, %.1f %% of it), fused step %.4f ms, chain %.4f ms on the "
            "card; host ms a call: kernel %.3f, fused step %.3f, chain %.3f"
            % (tag, len(shapes), n_params,
               ", ".join("%.3g" % x for x in norms), kernel_ms, bound_ms,
               100 * bound_ms / kernel_ms, step_ms, chain_ms, kernel_host,
               step_host, chain_host))
        del fused, grads, g, chain_p, chain_state, params, state
        del args, kwargs
        torch.cuda.empty_cache()
    log("FUSED_ADAM " + json.dumps(out))
    return out


GEMM_ROWS = 2560  # 16 memes × 160 tokens, the encoder's rows a micro-batch
GEMM_WIDTHS = {"uniter-base": (768, 3072), "uniter-large": (1024, 4096)}


def gemm_phase(torch) -> dict:
    """Phase 3d (see the module's notes); returns each shape's numbers and
    the six shapes' sums."""
    import torch.nn.functional as F

    from meme_challenge_tpu_torch.ops import linear as LIN

    gen = torch.Generator(device="cuda").manual_seed(22)
    out, sums = {}, {"kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                     "bound_ms": 0.0, "forward_host_ms": 0.0,
                     "forward_plain_host_ms": 0.0}
    costlier = []
    M = GEMM_ROWS
    for model, (h, ffn) in GEMM_WIDTHS.items():
        for n, k in ((h, h), (ffn, h), (h, ffn)):
            x = torch.randn(M, k, device="cuda", generator=gen)
            w = torch.randn(n, k, device="cuda", generator=gen) / math.sqrt(k)
            b = torch.randn(n, device="cuda", generator=gen)
            dy = torch.randn(M, n, device="cuda", generator=gen)
            products = {
                "forward": (lambda: LIN.linear(x, w, b),
                            lambda: LIN.linear_plain(x, w, b),
                            lambda: F.linear(x, w, b),
                            lambda: x.double() @ w.double().t()
                            + b.double(), (M, n, k)),
                "dgrad": (lambda: LIN.dgrad(dy, w), lambda: dy @ w,
                          lambda: torch.matmul(dy, w),
                          lambda: dy.double() @ w.double(), (M, k, n)),
                "wgrad": (lambda: LIN.wgrad(dy, x), lambda: dy.t() @ x,
                          lambda: torch.matmul(dy.t(), x),
                          lambda: dy.double().t() @ x.double(), (n, k, M))}
            for name, (kern, plain, lib, ref, (r, c, d)) in products.items():
                tag = "%s %s M%d N%d K%d" % (model, name, r, c, d)
                got, again, want = kern(), kern(), ref()
                torch.cuda.synchronize()
                err = (got.double() - want).abs().max().item()
                plain_err = (plain().double() - want).abs().max().item()
                if not err <= 2.0 * plain_err:
                    fail("gemm 3d %s: error %.3g against float64, more than "
                         "2x the plain version's %.3g" % (tag, err,
                                                          plain_err))
                if not torch.equal(got.view(torch.int32),
                                   again.view(torch.int32)):
                    fail("gemm 3d %s: a second call gives other bits" % tag)
                del got, again, want
                # as scoring calls it: eager, under inference_mode
                with torch.inference_mode():
                    kernel_ms, plain_ms, library_ms = (
                        device_ms(f)[0] for f in (kern, plain, lib))
                    kernel_host, plain_host, library_host = (
                        host_ms(f) for f in (kern, plain, lib))
                ops = 2.0 * r * c * d
                nbytes = 4.0 * (r * d + c * d + r * c)
                bound_ms = max(ops / PEAK_OPS["float32"],
                               nbytes / PEAK_BYTES) * 1e3
                splits = LIN.k_splits(r, c, d)[0]
                out[tag] = {"max_abs_err": err, "plain_max_abs_err": plain_err,
                            "ms": kernel_ms, "plain_ms": plain_ms,
                            "library_ms": library_ms, "bound_ms": bound_ms,
                            "bound_by": "operations" if ops / PEAK_OPS[
                                "float32"] >= nbytes / PEAK_BYTES
                            else "bytes", "splits": splits,
                            "host_ms": kernel_host,
                            "plain_host_ms": plain_host,
                            "library_host_ms": library_host}
                for key, v in (("kernel_ms", kernel_ms),
                               ("plain_ms", plain_ms),
                               ("library_ms", library_ms),
                               ("bound_ms", bound_ms)):
                    sums[key] += v
                if name == "forward":
                    sums["forward_host_ms"] += kernel_host
                    sums["forward_plain_host_ms"] += plain_host
                    if kernel_host > plain_host:
                        costlier.append("%s (%.4f against %.4f)" % (
                            tag, kernel_host, plain_host))
                log("gemm 3d %s: error %.3g (plain %.3g, ratio %.2f), bit "
                    "for bit twice; kernel %.4f ms (%.1f TFLOP/s, %.1f %% of "
                    "the bound %.4f ms; %d split%s), plain %.4f ms, library "
                    "%.4f ms (%.2fx the kernel); host ms a call: kernel "
                    "%.4f, plain %.4f, library %.4f" % (
                        tag, err, plain_err, err / plain_err, kernel_ms,
                        ops / kernel_ms / 1e9, 100 * bound_ms / kernel_ms,
                        bound_ms, splits, "" if splits == 1 else "s",
                        plain_ms, library_ms, library_ms / kernel_ms,
                        kernel_host, plain_host, library_host))
            del x, w, b, dy
    sums["library_over_kernel"] = sums["library_ms"] / sums["kernel_ms"]
    sums["share_of_bound"] = sums["bound_ms"] / sums["kernel_ms"]
    log("gemm 3d: the six shapes' three products, kernel %.3f ms, plain %.3f "
        "ms, library %.3f ms (%.2fx the kernel), bound %.3f ms (%.1f %% of "
        "the kernel's time); launches %s" % (
            sums["kernel_ms"], sums["plain_ms"], sums["library_ms"],
            sums["library_over_kernel"], sums["bound_ms"],
            100 * sums["share_of_bound"], json.dumps(LIN.LAUNCHES)))
    log("gemm 3d: host ms of the six forwards under inference_mode, kernel "
        "%.4f, plain %.4f; the kernel's forward costs the host more than "
        "the plain version at %s" % (
            sums["forward_host_ms"], sums["forward_plain_host_ms"],
            ", ".join(costlier) or "no shape"))
    torch.cuda.empty_cache()
    log("GEMM_TF32X3 " + json.dumps({"shapes": out, "sums": sums}))
    return {"shapes": out, "sums": sums}


# the ft_fp32 traffic's memes (portbench/traffic/ft_fp32.json): [60 text |
# 100 region] slots, text log-normal with a median of 20 tokens (σ 0.5)
# over 4-60, regions uniform over 10-100; ≈ 49 % of the slots valid
def traffic_mask(torch, memes: int, seed: int):
    """A ``[memes, 160]`` int64 key mask on the card."""
    import numpy as np

    rng = np.random.RandomState(seed)
    text = np.clip(np.rint(rng.lognormal(np.log(20), 0.5, memes)), 4, 60)
    regions = rng.randint(10, 101, memes)
    mask = np.zeros((memes, 160), np.int64)
    for i in range(memes):
        mask[i, :int(text[i])] = 1
        mask[i, 60:60 + regions[i]] = 1
    return torch.from_numpy(mask).cuda()


# Moonlight-16B-A3B's dense products through the hand GEMM at the cell
# moonlight_objtext_ft_fp32's 32 × 192 tokens, (N, K): they take no list
MOONLIGHT_ROWS = 32 * 192
MOONLIGHT_DENSE = {"q_proj": (3072, 2048), "kv_a_proj": (576, 2048),
                   "kv_b_proj": (4096, 512), "o_proj": (2048, 2048),
                   "shared gate": (2816, 2048), "shared down": (2048, 2816)}


def gemm_list_phase(torch) -> dict:
    """Phase 3f (see the module's notes); returns each pair's numbers, the
    two models' sums and Moonlight's times."""
    from meme_challenge_tpu_torch.models.uniter import NEG_INF
    from meme_challenge_tpu_torch.ops import linear as LIN

    gen = torch.Generator(device="cuda").manual_seed(24)
    M = GEMM_ROWS
    mask = traffic_mask(torch, M // 160, 24).reshape(1, -1)
    on = mask.reshape(-1).bool()
    rows = LIN.row_list(((1.0 - mask.float()) * NEG_INF)[:, None, None, :])
    count = int(rows[0])
    if count != int(on.sum()):
        fail("gemm 3f: the row list counts %d rows, the mask %d"
             % (count, int(on.sum())))
    out, sums = {}, {}
    for model, (h, ffn) in GEMM_WIDTHS.items():
        s = sums[model] = {"listed_ms": 0.0, "nolist_ms": 0.0,
                           "bound_ms": 0.0}
        for n, k in ((h, h), (ffn, h), (h, ffn)):
            x = torch.randn(M, k, device="cuda", generator=gen)
            w = torch.randn(n, k, device="cuda", generator=gen) / math.sqrt(k)
            b = torch.randn(n, device="cuda", generator=gen)
            dy = torch.randn(M, n, device="cuda", generator=gen)
            xs, dys = x[on], dy[on]
            products = {
                "forward": (lambda: LIN._forward_cuda(x, w, b, rows),
                            lambda: LIN._forward_cuda(x, w, b),
                            lambda: xs @ w.t() + b,
                            lambda: xs.double() @ w.double().t()
                            + b.double(), (count, n, k), (M, n, k)),
                "dgrad": (lambda: LIN.dgrad(dy, w, rows),
                          lambda: LIN.dgrad(dy, w), lambda: dys @ w,
                          lambda: dys.double() @ w.double(), (count, k, n),
                          (M, k, n)),
                "wgrad": (lambda: LIN.wgrad(dy, x, rows),
                          lambda: LIN.wgrad(dy, x), lambda: dys.t() @ xs,
                          lambda: dys.double().t() @ xs.double(),
                          (n, k, count), (n, k, M))}
            for name, (listed, nolist, plain, ref, (r, c, d),
                       whole) in products.items():
                tag = "%s %s M%d N%d K%d" % (model, name, *whole)
                got, again, full, want = listed(), listed(), nolist(), ref()
                torch.cuda.synchronize()
                kept = got if name == "wgrad" else got[on]
                err = (kept.double() - want).abs().max().item()
                plain_err = (plain().double() - want).abs().max().item()
                if not err <= 2.0 * plain_err:
                    fail("gemm 3f %s: the listed rows err by %.3g against "
                         "float64, more than 2x the plain version's %.3g"
                         % (tag, err, plain_err))
                if name != "wgrad" and bool(got[~on].any()):
                    fail("gemm 3f %s: a row outside the list is not zero"
                         % tag)
                if not torch.equal(got.view(torch.int32),
                                   again.view(torch.int32)):
                    fail("gemm 3f %s: a second call gives other bits" % tag)
                plan = LIN.list_plan(*whole, name != "wgrad")[0]
                unit = LIN.BLOCK_K if name == "wgrad" else LIN.BLOCK_M
                splits = plan[-(-count // unit)]
                same = None
                if name == "forward" and splits == LIN.k_splits(*whole):
                    same = torch.equal(got[on].view(torch.int32),
                                       full[on].view(torch.int32))
                    if not same:
                        fail("gemm 3f %s: the listed rows differ from the "
                             "no-list launch's under the same plan" % tag)
                del got, again, full, want, kept
                with torch.inference_mode():
                    listed_ms, nolist_ms = (device_ms(f)[0]
                                            for f in (listed, nolist))
                ops = 2.0 * r * c * d
                nbytes = 4.0 * (r * d + c * d + r * c)
                bound_ms = max(ops / PEAK_OPS["float32"],
                               nbytes / PEAK_BYTES) * 1e3
                out[tag] = {"listed_ms": listed_ms, "nolist_ms": nolist_ms,
                            "bound_ms": bound_ms, "max_abs_err": err,
                            "plain_max_abs_err": plain_err,
                            "plan": list(splits),
                            "nolist_plan": list(LIN.k_splits(*whole)),
                            "bits_as_nolist": same}
                s["listed_ms"] += listed_ms
                s["nolist_ms"] += nolist_ms
                s["bound_ms"] += bound_ms
                log("gemm 3f %s over %d listed rows: error %.3g (plain "
                    "%.3g), rows outside zero, bit for bit twice%s; listed "
                    "%.4f ms (plan %s), no list %.4f ms (plan %s), %.2fx; "
                    "bound at the listed rows %.4f ms (%.1f %%)" % (
                        tag, count, err, plain_err,
                        "" if same is None else ", the no-list bits",
                        listed_ms, splits, nolist_ms, LIN.k_splits(*whole),
                        listed_ms / nolist_ms, bound_ms,
                        100 * bound_ms / listed_ms))
            del x, w, b, dy, xs, dys
        s["ratio"] = s["listed_ms"] / s["nolist_ms"]
        log("gemm 3f %s: the nine pairs at %d of %d rows valid (%.2f %%): "
            "listed %.3f ms, no list %.3f ms, ratio %.3f (%s the aim of "
            "0.65), bound at the listed rows %.3f ms" % (
                model, count, M, 100.0 * count / M, s["listed_ms"],
                s["nolist_ms"], s["ratio"],
                "within" if s["ratio"] <= 0.65 else "above", s["bound_ms"]))
    moon = {}
    for name, (n, k) in MOONLIGHT_DENSE.items():
        x = torch.randn(MOONLIGHT_ROWS, k, device="cuda", generator=gen)
        w = torch.randn(n, k, device="cuda", generator=gen) / math.sqrt(k)
        dy = torch.randn(MOONLIGHT_ROWS, n, device="cuda", generator=gen)
        with torch.inference_mode():
            moon[name] = [device_ms(f)[0] for f in (
                lambda: LIN.linear(x, w, None), lambda: LIN.dgrad(dy, w),
                lambda: LIN.wgrad(dy, x))]
        log("gemm 3f moonlight %s M%d N%d K%d, no list: forward %.4f ms, "
            "dgrad %.4f, wgrad %.4f" % (name, MOONLIGHT_ROWS, n, k,
                                        *moon[name]))
        del x, w, dy
    torch.cuda.empty_cache()
    result = {"count": count, "rows": M, "pairs": out, "sums": sums,
              "moonlight_dense_ms": moon}
    log("GEMM_LIST " + json.dumps(result))
    return result


def list_counter_phase(torch) -> dict:
    """Phase 3g (see the module's notes): the counter's share over a short
    captured fine-tune of full-width UNITER-base."""
    from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
    from meme_challenge_tpu_torch.core.seeding import (
        dropout_generator,
        torch_generator,
    )
    from meme_challenge_tpu_torch.models.uniter import init_meme_uniter
    from meme_challenge_tpu_torch.ops import linear as LIN
    from meme_challenge_tpu_torch.train import steps as S
    from meme_challenge_tpu_torch.train.losses import make_loss_fn
    from meme_challenge_tpu_torch.train.optim import Optimizer

    c = TrainConfig()
    model = init_meme_uniter(UniterConfig(use_pallas_attention=True), 1,
                             "cuda", torch_generator(0, "cuda"))
    opt = Optimizer("adam", 3e-5, lambda count: (count + 1) / 8,
                    beta1=c.beta1, beta2=c.beta2,
                    weight_decay=c.weight_decay,
                    max_grad_norm=c.max_grad_norm, mu_dtype=c.adam_mu_dtype,
                    nu_dtype=c.adam_nu_dtype)
    state = S.create_train_state(model, opt)
    step = S.make_train_step(model, make_loss_fn("bce_logits", 1.8), opt,
                             accum_steps=TRAIN_ACCUM)
    gen = torch.Generator(device="cuda").manual_seed(25)
    A, B = TRAIN_ACCUM, 16

    def batch(mask):
        return {"input_ids": torch.randint(1, 28996, (A, B, 60),
                                           device="cuda", generator=gen).int(),
                "position_ids": torch.arange(60, dtype=torch.int32,
                                             device="cuda")
                .expand(A, B, 60).contiguous(),
                "txt_mask": mask[..., :60].int(),
                "img_feat": torch.randn(A, B, 100, 2048, device="cuda",
                                        generator=gen).half(),
                "img_pos_feat": torch.rand(A, B, 100, 7, device="cuda",
                                           generator=gen),
                "img_mask": mask[..., 60:].int(),
                "labels": torch.randint(0, 2, (A, B), device="cuda",
                                        generator=gen),
                "sample_mask": torch.ones(A, B, dtype=torch.int32,
                                          device="cuda")}

    counter = LIN.listed_rows(torch.device("cuda"))
    out = {}
    marks = S.GRAPH_CAPTURES, S.GRAPH_REPLAYS
    for tag, n_steps in (("traffic", 6), ("all_valid", 2)):
        before = counter.clone()
        valid = 0
        for i in range(n_steps):
            mask = (traffic_mask(torch, A * B, 250 + i) if tag == "traffic"
                    else torch.ones(A * B, 160, dtype=torch.int64,
                                    device="cuda")).view(A, B, 160)
            valid += int(mask.sum())
            state, _ = step(state, batch(mask),
                            dropout_generator(43, state.step, "cuda"))
        torch.cuda.synchronize()
        computed, offered = (counter - before).tolist()
        want = [valid, n_steps * A * B * 160]
        if [computed, offered] != want:
            fail("list 3g %s: the counter added %d of %d rows over %d "
                 "steps, the masks hold %d of %d" % (
                     tag, computed, offered, n_steps, *want))
        out[tag] = {"computed": computed, "offered": offered,
                    "share": computed / offered}
        log("list 3g %s: %d steps of 16 x %d memes, the counter %d of %d "
            "rows computed (%.2f %%)" % (tag, n_steps, A, computed, offered,
                                         100.0 * computed / offered))
    made = (S.GRAPH_CAPTURES - marks[0], S.GRAPH_REPLAYS - marks[1])
    if made != (1, 7):
        fail("list 3g: %d captures and %d replays in 8 steps of one shape"
             % made)
    del model, state, step, opt
    torch.cuda.empty_cache()
    log("LIST_COUNTER " + json.dumps(out))
    return out


# the cell moonlight_objtext_ft_fp32's grouped products: 32 memes of 192
# padded tokens a step, rows for a token's 6 picks, 8 held experts, ≈ 2 500
# valid tokens × 6 picks × 8/64 held ≈ 234 rows a held expert
EXPERT_TOKENS = 32 * 192
EXPERT_PICKS = 6
EXPERT_GROUPS = 8
EXPERT_ROWS = 1872
EXPERT_WIDTHS = {"gate_up": (2816, 2048), "down": (2048, 1408)}


def expert_gemm_phase(torch) -> dict:
    """Phase 3e (see the module's notes); returns each product's numbers
    and their sums."""
    import numpy as np

    from meme_challenge_tpu_torch.ops import expert_linear as E

    rng = np.random.RandomState(23)
    sizes = rng.multinomial(EXPERT_ROWS, [1.0 / EXPERT_GROUPS]
                            * EXPERT_GROUPS)
    sizes[5] = 0  # an expert no token picked
    bounds = [0] + [int(v) for v in np.cumsum(sizes)]
    end, G, T = bounds[-1], EXPERT_GROUPS, EXPERT_TOKENS
    off = torch.tensor(bounds, dtype=torch.int32, device="cuda")
    R = T * EXPERT_PICKS
    gen = torch.Generator(device="cuda").manual_seed(23)
    out, sums = {}, {"kernel_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    mark = dict(E.LAUNCHES)
    for layer, (n, k) in EXPERT_WIDTHS.items():
        x = torch.randn(R, k, device="cuda", generator=gen)
        dy = torch.randn(R, n, device="cuda", generator=gen)
        w = torch.randn(G, n, k, device="cuda", generator=gen) / math.sqrt(k)
        spans = list(zip(bounds, bounds[1:]))

        def rows(f, grouped):
            """The products of the groups' rows, or ``[G, ...]`` of the
            groups' weight gradients (``grouped``)."""
            got = [f(g, a, b) for g, (a, b) in enumerate(spans)]
            return torch.stack(got) if grouped else torch.cat(got)

        products = {
            "forward": (lambda: E.forward(x, w, off, T)[:end],
                        lambda: [x[a:b] @ w[g].t()
                                 for g, (a, b) in enumerate(spans)],
                        lambda d: rows(lambda g, a, b: d(x[a:b])
                                       @ d(w[g]).t(), False)),
            "dgrad": (lambda: E.dgrad(dy, w, off, T)[:end],
                      lambda: [dy[a:b] @ w[g]
                               for g, (a, b) in enumerate(spans)],
                      lambda d: rows(lambda g, a, b: d(dy[a:b]) @ d(w[g]),
                                     False)),
            "wgrad": (lambda: E.wgrad(dy, x, off),
                      lambda: [dy[a:b].t() @ x[a:b]
                               for g, (a, b) in enumerate(spans)],
                      lambda d: rows(lambda g, a, b: d(dy[a:b]).t()
                                     @ d(x[a:b]), True))}
        for name, (kern, plain, ref) in products.items():
            tag = "%s %s" % (layer, name)
            got, again = kern(), kern()
            want = ref(lambda t: t.double())
            plain_out = ref(lambda t: t)
            torch.backends.cuda.matmul.allow_tf32 = True
            tf32_out = ref(lambda t: t)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.cuda.synchronize()
            err, plain_err, tf32_err = (
                (t.double() - want).abs().max().item()
                for t in (got, plain_out, tf32_out))
            if not err <= 2.0 * plain_err:
                fail("expert gemm 3e %s: error %.3g against float64, more "
                     "than 2x the plain products' %.3g" % (tag, err,
                                                           plain_err))
            if tf32_err <= 2.0 * plain_err:
                fail("expert gemm 3e %s: TF32 products (error %.3g) pass "
                     "the tolerance 2x %.3g: it cannot tell fp32 from TF32"
                     % (tag, tf32_err, plain_err))
            if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
                fail("expert gemm 3e %s: a second call gives other bits"
                     % tag)
            if name == "wgrad" and got[5].any():
                fail("expert gemm 3e %s: the empty group's gradient is not "
                     "zero" % tag)
            del got, again, want, plain_out, tf32_out
            kernel_ms = device_ms(kern)[0]
            plain_ms = device_ms(plain)[0]
            ops = 2.0 * end * n * k
            nbytes = 4.0 * (G * n * k + end * (n + k))
            bound_ms = max(ops / PEAK_OPS["float32"],
                           nbytes / PEAK_BYTES) * 1e3
            out[tag] = {"max_abs_err": err, "plain_max_abs_err": plain_err,
                        "tf32_max_abs_err": tf32_err, "ms": kernel_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": "operations" if ops / PEAK_OPS[
                            "float32"] >= nbytes / PEAK_BYTES else "bytes"}
            for key, v in (("kernel_ms", kernel_ms), ("plain_ms", plain_ms),
                           ("bound_ms", bound_ms)):
                sums[key] += v
            log("expert gemm 3e %s N%d K%d: error %.3g (plain %.3g, ratio "
                "%.2f; TF32 %.3g, refused), bit for bit twice; kernel %.4f "
                "ms (%.1f TFLOP/s, %.1f %% of the bound %.4f ms, %s), plain "
                "per-expert products %.4f ms (%.2fx the kernel)" % (
                    tag, n, k, err, plain_err, err / plain_err, tf32_err,
                    kernel_ms, ops / kernel_ms / 1e9,
                    100 * bound_ms / kernel_ms, bound_ms,
                    out[tag]["bound_by"], plain_ms, plain_ms / kernel_ms))
        del x, dy, w
    sums["share_of_bound"] = sums["bound_ms"] / sums["kernel_ms"]
    log("expert gemm 3e: rows by expert %s (%d of %d), kernel %.3f ms, "
        "plain %.3f ms, bound %.3f ms (%.1f %% of the kernel's time); "
        "launches %s" % (
            [int(v) for v in sizes], end, R, sums["kernel_ms"],
            sums["plain_ms"], sums["bound_ms"], 100 * sums["share_of_bound"],
            json.dumps({k: E.LAUNCHES[k] - mark[k] for k in E.LAUNCHES})))
    torch.cuda.empty_cache()
    log("EXPERT_GEMM " + json.dumps({"products": out, "sums": sums}))
    return {"products": out, "sums": sums,
            "rows": [int(v) for v in sizes]}


def expert_entry(expert: dict, launches: dict) -> dict:
    """The grouped expert GEMM's line in the kernels' record: the launches
    by product of phase 11d's CLI run, the times of phase 3e's gate and up
    forward, and the six products' sums beside them."""
    main = expert["products"]["gate_up forward"]
    return {"name": "expert_gemm_tf32x3_kernel[float32]", "route": "cuda",
            "body": "3xTF32 wgmma, grouped", "source": SOURCE["linear_tf32x3"],
            "replaces": None, "launches": launches,
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "rows_by_expert": expert["rows"], "six_products": expert["sums"]}


def moonlight_cli_phase(torch, work: str, synth: dict, passlog) -> dict:
    """Phase 11d: ``train_object_text --model moonlight`` at the published
    widths (8 experts held) on the synthetic dataset, 1 epoch of the CLI's
    defaults (fp32, micro-batch 32) without checkpoints: the step
    replays its CUDA graph and the grouped kernel launches a forward, a
    recomputed forward, two dgrads and two wgrads an MoE layer and train
    micro-batch (counted at each replay) and two forwards an MoE layer and
    eval batch. Returns the run's launches by product."""
    from meme_challenge_tpu_torch.models.moe_mla import MoeMlaConfig
    from meme_challenge_tpu_torch.ops import expert_linear as E
    from meme_challenge_tpu_torch.train import steps, train_object_text

    from meme_challenge_tpu_torch.ops import attention as A

    side = _text_side_files(work, synth)
    run_dir = os.path.join(work, "ot_moonlight")
    os.makedirs(run_dir)
    passlog.clear()
    reset_launches(A)
    for key in E.LAUNCHES:
        E.LAUNCHES[key] = 0
    caps = steps.GRAPH_CAPTURES, steps.GRAPH_REPLAYS
    t0 = time.time()
    train_object_text.main(
        _text_argv(synth, run_dir, 1)
        + ["--model", "moonlight", "--object_file", side["objects"],
           "--object_to_text_file", side["obj2text"],
           "--obj_threshold_min", "0.3", "--obj_threshold_max", "0.7",
           "--obj_swap_prob", "0.1", "--no_model_checkpoints"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(E.LAUNCHES)
    c = MoeMlaConfig()
    per = c.num_hidden_layers - c.first_k_dense_replace
    graphs = (steps.GRAPH_CAPTURES - caps[0], steps.GRAPH_REPLAYS - caps[1])
    log(on_card("moonlight object_text: CLI %.1f s; train %s memes/s by "
                "epoch; graphs captured %d, replayed %d; grouped expert "
                "GEMM launches %s" % (
                    wall, ["%.1f" % (n / s) for n, s in passlog.epochs],
                    graphs[0], graphs[1], json.dumps(counts))))
    count_gemm_launches("moonlight object_text", "float32")
    if not passlog.epochs:
        fail("moonlight object_text: no training epoch")
    if graphs[0] < 1 or graphs[1] < 1:
        fail("moonlight object_text: the step did not replay a graph "
             "(captures %d, replays %d)" % graphs)
    micro = counts["dgrad"] // (2 * per)
    evals = (counts["forward"] - 3 * per * micro) / (2 * per)
    if not (micro >= 1 and counts["dgrad"] == counts["wgrad"]
            == 2 * per * micro and evals == int(evals) and evals >= 0):
        fail("moonlight object_text: grouped launches %s are not 3 + 2 + 2 "
             "an MoE layer (%d) and micro-batch plus 2 forwards an eval "
             "batch" % (json.dumps(counts), per))
    log("moonlight object_text: %d train micro-batches and %d eval batches "
        "by the grouped launches" % (micro, int(evals)))
    return counts


def graph_gate_phase(torch, synth: dict) -> dict:
    """Phase 3c (see the module's notes); returns each mode's numbers."""
    from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
    from meme_challenge_tpu_torch.core.seeding import (
        dropout_generator,
        torch_generator,
    )
    from meme_challenge_tpu_torch.models.uniter import init_meme_uniter
    from meme_challenge_tpu_torch.train import steps as S
    from meme_challenge_tpu_torch.train.losses import make_loss_fn
    from meme_challenge_tpu_torch.train.optim import Optimizer

    ds = _train_dataset(synth)
    n_steps = 5
    batches = _fold_batches(torch, ds, n_steps, TRAIN_ACCUM)
    c = TrainConfig()

    def run(fuse, graphed, steps=range(n_steps), rows=16, state=None):
        """The steps of ``steps`` (rows of each micro-batch), from a fresh
        model of seed 0 or ``state``: (state, step's outputs, wall ms and
        host ms of each step)."""
        if state is None:
            model = init_meme_uniter(UniterConfig(use_pallas_attention=True),
                                     1, "cuda", torch_generator(0, "cuda"))
            opt = Optimizer("adam", 3e-5, lambda count: (count + 1) / 8,
                            beta1=c.beta1, beta2=c.beta2,
                            weight_decay=c.weight_decay,
                            max_grad_norm=c.max_grad_norm,
                            mu_dtype=c.adam_mu_dtype,
                            nu_dtype=c.adam_nu_dtype)
            state = S.create_train_state(model, opt)
            run.step = S.make_train_step(
                model, make_loss_fn("bce_logits", 1.8), opt,
                accum_steps=TRAIN_ACCUM, fuse_accum=fuse)
        step = run.step if graphed else run.step.eager
        outs, wall, host = [], [], []
        for i in steps:
            batch = {k: v[i, :, :rows] for k, v in batches.items()}
            gen = dropout_generator(43, state.step, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = step(state, batch, gen)
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        return state, outs, wall, host

    def snapshot(state):
        return {"p": {n: p.detach().clone() for n, p in
                      state.model.named_parameters()},
                "mu": {n: v.clone() for n, v in state.opt_state["mu"].items()},
                "nu": {n: v.clone() for n, v in state.opt_state["nu"].items()}}

    def same(tag, a, b):
        for what in a:
            for n in a[what]:
                x, y = a[what][n], b[what][n]
                bits = torch.int32 if x.dtype == torch.float32 else torch.int16
                if not torch.equal(x.view(bits), y.view(bits)):
                    fail("graph 3c %s: %s of %s differs between eager and "
                         "replayed steps in %d of %d elements" % (
                             tag, what, n, int((x.view(bits) != y.view(bits))
                                               .sum()), x.numel()))

    def restore(state, snap):
        params = dict(state.model.named_parameters())
        with torch.no_grad():
            for n, v in snap["p"].items():
                params[n].copy_(v)
        for slot in ("mu", "nu"):
            for n, v in snap[slot].items():
                state.opt_state[slot][n].copy_(v)

    from meme_challenge_tpu_torch.ops import linear as LIN

    out = {}
    gemm_mark = LIN.LAUNCHES["forward"]
    for fuse in (False, True):
        tag = "fused accum" if fuse else "scan accum"
        res = {}
        for graphed in (False, True):
            run.step = state = None
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            base_reserved = torch.cuda.memory_reserved()
            torch.cuda.reset_peak_memory_stats()
            marks = S.GRAPH_CAPTURES, S.GRAPH_REPLAYS
            state, outs, wall, host = run(fuse, graphed)
            torch.cuda.synchronize()
            made = (S.GRAPH_CAPTURES - marks[0], S.GRAPH_REPLAYS - marks[1])
            if made != ((1, n_steps - 1) if graphed else (0, 0)):
                fail("graph 3c %s: %d captures and %d replays in %d %s "
                     "steps" % (tag, made[0], made[1], n_steps,
                                "graphed" if graphed else "eager"))
            res[graphed] = {
                "snap": snapshot(state),
                "loss": torch.stack([o["loss"] for o in outs]),
                "probs": torch.stack([o["probs"] for o in outs]),
                "step_ms": statistics.median(wall[1:]),
                "issue_ms": statistics.median(host[1:]),
                "first_ms": wall[0],
                "allocated_gib": (torch.cuda.max_memory_allocated() - base)
                / 2 ** 30,
                "reserved_gib": (torch.cuda.max_memory_reserved()
                                 - base_reserved) / 2 ** 30}
        eager, graph = res[False], res[True]
        for what in ("loss", "probs"):
            if not torch.equal(eager[what], graph[what]):
                fail("graph 3c %s: the %s of %d steps differ between eager "
                     "and replayed steps" % (tag, what, n_steps))
        same(tag, eager["snap"], graph["snap"])
        # a second batch shape: one more capture, then a replay; then the
        # eager body from the same state gives the same numbers
        ref = snapshot(state)
        marks = S.GRAPH_CAPTURES, S.GRAPH_REPLAYS
        state, outs, _, _ = run(fuse, True, range(2), rows=8, state=state)
        made = (S.GRAPH_CAPTURES - marks[0], S.GRAPH_REPLAYS - marks[1])
        if made != (1, 1):
            fail("graph 3c %s: a new batch shape made %d captures and %d "
                 "replays in 2 steps" % (tag, *made))
        after = snapshot(state)
        restore(state, ref)
        state.step -= 2
        state.opt_state["count"] -= 2
        state, eager_outs, _, _ = run(fuse, False, range(2), rows=8,
                                      state=state)
        same(tag + " new shape", after, snapshot(state))
        for o1, o2 in zip(outs, eager_outs):
            if not all(torch.equal(o1[k], o2[k]) for k in o1):
                fail("graph 3c %s: a new shape's outputs differ" % tag)
        keep = ("step_ms", "issue_ms", "first_ms", "allocated_gib",
                "reserved_gib")
        out[tag] = {"eager": {k: eager[k] for k in keep},
                    "replayed": {k: graph[k] for k in keep}}
        log("graph 3c %s: %d steps bit for bit eager vs replayed (losses, "
            "probabilities, %d leaves, both moments); one capture, %d "
            "replays, a second shape one capture; eager %.2f ms a step, host "
            "issue %.2f ms; replayed %.2f ms a step (capture step %.1f ms), "
            "host issue %.2f ms; peaks allocated %.3f / %.3f GiB, reserved "
            "%.3f / %.3f GiB (eager / replayed, above the phase's start)" % (
                tag, n_steps, len(ref["p"]), n_steps - 1, eager["step_ms"],
                eager["issue_ms"], graph["step_ms"], graph["first_ms"],
                graph["issue_ms"], eager["allocated_gib"],
                graph["allocated_gib"], eager["reserved_gib"],
                graph["reserved_gib"]))
        del res, eager, graph, state, outs, eager_outs, ref, after
        run.step = None
        torch.cuda.empty_cache()
    if LIN.LAUNCHES["forward"] == gemm_mark:
        fail("graph 3c: the fp32 steps launched no 3xTF32 GEMM")
    log("STEP_GRAPH " + json.dumps(out))
    return out


def forward_breakdown(torch, model, batch, dtype: str) -> None:
    """Where one batch-16 forward's time goes (informational, after the
    counted runs): device ms (queue-filled events) against the host's ms to
    issue it, and the device time by operator from torch.profiler."""
    def forward():
        with torch.inference_mode():
            model(batch)

    # one forward queues ~700 launches: more than one would overflow the
    # launch queue during the sleep and let the host's pace back in
    dev, host = device_ms(forward, iters=1, reps=5)
    log("breakdown %s: one batch-16 forward: device %.3f ms, host issue "
        "%.3f ms -> %s-bound; device-bound rate %.1f memes/s"
        % (dtype, dev, host, "host" if host > dev else "device",
           16 / dev * 1e3))
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        n = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                forward()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        rows = []
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                t = getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                rows.append((t / n / 1e3, e.key))
        rows.sort(reverse=True)
        busy = sum(t for t, _ in rows)
        log("breakdown %s: profiled forward: wall %.3f ms, kernels %.3f ms, "
            "device idle share %.3f; top kernels (ms): %s"
            % (dtype, wall, busy, 1.0 - busy / wall,
               "; ".join("%s %.3f" % (k[:40], t) for t, k in rows[:6])))
    except Exception as e:  # informational: a missing trace fails nothing
        log("breakdown %s: profiler unavailable (%s)" % (dtype, e))


def reset_launches(A) -> None:
    from meme_challenge_tpu_torch.ops import linear as LIN

    for counts in (A.LAUNCHES, A.ROUTE_LAUNCHES, LIN.LAUNCHES):
        for key in counts:
            counts[key] = 0


# the 3xTF32 GEMM's launches (ops/linear.py: LAUNCHES) by product in the
# main-path CLI runs whose attention launches the kernels record sums, each
# counted since that run's reset_launches, by run
GEMM_MAIN_PATH = {}


def count_gemm_launches(tag: str, dtype=None) -> dict:
    """The GEMM's launches since reset_launches, kept in GEMM_MAIN_PATH
    under ``tag``; a float32 run on the card launched forwards, a bfloat16
    run none (its products stay on F.linear)."""
    from meme_challenge_tpu_torch.ops import linear as LIN

    counts = dict(LIN.LAUNCHES)
    if (dtype == "float32" and not counts["forward"]) or (
            dtype == "bfloat16" and any(counts.values())):
        fail("%s: 3xTF32 GEMM launches %s in a %s run" % (tag, counts,
                                                          dtype))
    log("%s: 3xTF32 GEMM launches %s" % (tag, json.dumps(counts)))
    previous = GEMM_MAIN_PATH.get(tag, {})
    GEMM_MAIN_PATH[tag] = {k: n + previous.get(k, 0)
                           for k, n in counts.items()}
    return counts


def main_path_route(dtype: str) -> str:
    """The route every launch of the UNITER-base main path (S 160, D 64)
    takes: the tensor-core body of its dtype."""
    return "mma_bf16" if dtype == "bfloat16" else "mma_tf32x3"


def check_route_counts(A, tag: str, dtype: str, names) -> dict:
    """Every launch of ``names`` since reset_launches went through the main
    path's route for ``dtype``; returns the per-route counts of ``names``."""
    want = main_path_route(dtype)
    counts = {"%s/%s" % key: n for key, n in A.ROUTE_LAUNCHES.items()
              if key[0] in names and n}
    for name in names:
        if A.ROUTE_LAUNCHES[(name, want)] != A.LAUNCHES[name]:
            fail("%s: launches by route %s, expected all %d of %s on %s"
                 % (tag, counts, A.LAUNCHES[name], name, want))
    return counts


def _n_lines(path: str) -> int:
    with open(path) as f:
        return sum(1 for line in f if line.strip())


def make_dataset(work: str) -> dict:
    """The synthetic dataset of both CLI phases: img_dim 2048, up to 100
    boxes; 128 train memes, which the confounder sampler (repeat 3) turns
    into 144 a epoch, 9 micro-batches of 16: 5 optimizer steps with
    accumulation 2, the last one padded; 40 memes in each dev set and 36 in
    each test set."""
    from meme_challenge_tpu_torch.utils.synthetic import make_synthetic_dataset

    t0 = time.time()
    synth = make_synthetic_dataset(os.path.join(work, "data"), n_train=128,
                                   n_dev=40, n_test=36, img_dim=2048,
                                   max_boxes=100, seed=0)
    log("data: synthetic dataset (img_dim 2048, up to 100 boxes) in %.1f s"
        % (time.time() - t0))
    return synth


def check_outputs(run_dir: str, ckpt_name: str, synth: dict) -> dict:
    """The 4 CSVs with one probability in [0, 1] per meme, and the metrics
    JSON with its dev, train and 4 test entries; returns the metrics."""
    base = ckpt_name.rsplit(".", 1)[0]
    for ds in ("dev_seen", "dev_unseen", "test_seen", "test_unseen"):
        path = os.path.join(run_dir, "%s_%s_preds.csv" % (base, ds))
        if not os.path.isfile(path):
            fail("missing " + path)
        with open(path) as f:
            rows = [r.split(",") for r in f.read().split("\n")[1:] if r]
        probs = [float(r[1]) for r in rows]
        if len(rows) != _n_lines(synth[ds]) or not all(
                0.0 <= p <= 1.0 for p in probs):
            fail("bad predictions in " + path)
    with open(os.path.join(run_dir, base + "_metrics.json")) as f:
        metrics = json.load(f)
    if set(metrics) != {"dev", "train", "test"} or set(
            metrics["test"]) != {"dev_seen", "dev_unseen", "test_seen",
                                 "test_unseen"}:
        fail("unexpected metrics JSON: %s" % sorted(metrics))
    return metrics


def serve_cli_run(torch, run_dir: str, ckpt: str, synth: dict, passlog, A,
                  cfg, name: str, dtype: str, tag: str) -> dict:
    """Inference through the port's CLI (``train_uniter.main`` with
    --max_epoch 0) from the checkpoint ``ckpt`` of the model ``cfg`` (its
    ``pallas_blocked`` picks kernel ``name``) in ``dtype``, into
    ``run_dir``: launch counts (every layer of ``cfg`` once an eval batch)
    and routes, the passes' memes, the CSVs and metrics JSON; returns the
    launches of ``name``."""
    from meme_challenge_tpu_torch.train import train_uniter

    batch_size, layers = 16, cfg.num_hidden_layers
    names = ("dev_seen", "test_seen", "test_unseen", "dev_seen", "dev_unseen")
    n_batches = sum(-(-_n_lines(synth[n]) // batch_size) for n in names)
    n_memes = sum(_n_lines(synth[n]) for n in names)
    ckpt_name = os.path.basename(ckpt)
    os.makedirs(run_dir)
    os.link(ckpt, os.path.join(run_dir, ckpt_name))
    cfg_path = os.path.join(run_dir, "uniter.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg.to_dict(), f)
    argv = ["--data_path", synth["root"],
            "--feature_path", synth["feature_dir"],
            "--vocab_file", synth["vocab"], "--model_path", run_dir,
            "--model_save_name", ckpt_name, "--max_epoch", "0",
            "--num_folds", "0", "--batch_size", str(batch_size),
            "--uniter_config", cfg_path]
    if dtype == "bfloat16":
        argv.append("--compute_bf16")
    passlog.clear()
    reset_launches(A)
    t0 = time.time()
    train_uniter.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(A.LAUNCHES)
    by_route = check_route_counts(A, tag, dtype, (name,))
    count_gemm_launches(tag, dtype)
    expected = layers * n_batches
    others = sum(v for k, v in counts.items() if k != name)
    memes = sum(n for n, _ in passlog.passes)
    secs = sum(s for _, s in passlog.passes)
    warm = passlog.passes[1:]
    log("%s: CLI %.1f s, launches %d (expected %d = %d layers x %d eval "
        "batches; by route %s), inference %d memes in %.4f s = %.1f memes/s "
        "(after the first pass: %.1f memes/s)"
        % (tag, wall, counts[name], expected, layers, n_batches, by_route,
           memes, secs, memes / secs,
           sum(n for n, _ in warm) / sum(s for _, s in warm)))
    if counts[name] != expected or others != 0:
        fail("%s: launch counts %s, expected %d of %s only"
             % (tag, counts, expected, name))
    if memes != n_memes:
        fail("%s: inference passes covered %d memes, expected %d"
             % (tag, memes, n_memes))
    metrics = check_outputs(run_dir, ckpt_name, synth)
    log("%s: 4 CSVs + metrics JSON, dev_seen AUROC %.4f"
        % (tag, metrics["test"]["dev_seen"]["aucroc"]))
    return {name: counts[name]}


def inference_phase(torch, work: str, synth: dict, passlog) -> None:
    """Full-width UNITER-base inference through the port's CLI (--max_epoch
    0 from a saved checkpoint), each kernel in both dtypes: launch counts,
    CSVs, metrics JSON, and one batch's fp32 logits, card against CPU."""
    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.core.seeding import torch_generator
    from meme_challenge_tpu_torch.data.meme_dataset import MemeDataset
    from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
    from meme_challenge_tpu_torch.models.uniter import init_meme_uniter
    from meme_challenge_tpu_torch.ops import attention as A
    from meme_challenge_tpu_torch.train.checkpoint import ModelSaver
    from meme_challenge_tpu_torch.train.steps import to_device

    batch_size = 16
    ckpt_name = "uniter_base.ckpt"
    base_ckpt = os.path.join(work, ckpt_name)
    fused = UniterConfig(use_pallas_attention=True)
    model = init_meme_uniter(fused, 1, "cuda", torch_generator(0, "cuda"))
    ModelSaver(base_ckpt).save(model)
    log("inference: UNITER-base MemeUniter (%.1f M parameters) saved"
        % (sum(p.numel() for p in model.parameters()) / 1e6))

    runs = (("fused_attention", "float32", False),
            ("fused_attention", "bfloat16", False),
            ("fused_attention_blocked", "float32", True),
            ("fused_attention_blocked", "bfloat16", True))
    for name, dtype, blocked in runs:
        serve_cli_run(torch, os.path.join(work, "%s_%s" % (name, dtype)),
                      base_ckpt, synth, passlog, A,
                      UniterConfig(use_pallas_attention=True,
                                   pallas_blocked=blocked),
                      name, dtype, "inference %s %s" % (name, dtype))

    # one batch's float32 logits: card (kernel) against CPU (plain version)
    ds = MemeDataset(synth["dev_seen"], feature_dir=synth["feature_dir"],
                     tokenizer=BertTokenizer(synth["vocab"]), max_txt_len=60,
                     max_bb=100, img_dim=2048)
    batch = ds.batch(list(range(batch_size)))
    logits = {}
    for device in ("cuda", "cpu"):
        m = init_meme_uniter(fused, 1, device, torch_generator(1, device))
        ModelSaver(base_ckpt).load(m)
        with torch.inference_mode():
            logits[device] = m(to_device(batch, device)).float().cpu()
        if device == "cuda":
            forward_breakdown(torch, m, to_device(batch, device), "float32")
            m_bf16 = init_meme_uniter(fused.replace(dtype="bfloat16"), 1,
                                      device, torch_generator(1, device))
            ModelSaver(base_ckpt).load(m_bf16)
            forward_breakdown(torch, m_bf16, to_device(batch, device),
                              "bfloat16")
            del m_bf16
        del m
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    finite = bool(torch.isfinite(logits["cuda"]).all())
    log("inference: float32 logits of one batch of %d, card vs CPU: "
        "max_abs_err %.3g (tol %g), finite=%s" % (batch_size, err, LOGIT_TOL,
                                                 finite))
    if not (err <= LOGIT_TOL and finite):
        fail("card logits disagree with the CPU's")


# (kernel, dtype, pallas_blocked, --fuse_accum): every kernel in both dtypes
TRAIN_RUNS = (("fused_attention", "float32", False, False),
              ("fused_attention", "bfloat16", False, False),
              ("fused_attention_blocked", "bfloat16", True, True),
              ("fused_attention_blocked", "float32", True, True))
TRAIN_ACCUM = 2


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def finetune_cli_run(torch, work: str, synth: dict, passlog, A, cfg,
                     name: str, dtype: str, fuse: bool, epochs: int,
                     tag: str) -> tuple:
    """One fine-tune through the port's CLI (the README recipe with
    --num_folds 0, ``epochs`` epochs, random weights from seed 42) of the
    model ``cfg`` (its ``pallas_blocked`` picks kernel ``name``), in
    ``dtype``, with or without --fuse_accum. Checks the forward and
    backward launch counts against the micro-batches it stepped (every
    layer of ``cfg`` once a forward and a backward) and their routes,
    finite epoch losses, the best checkpoint, the CSVs and the metrics JSON;
    returns ({kernel: launches}, the run's directory)."""
    from meme_challenge_tpu_torch.train import train_uniter

    batch_size, layers = 16, cfg.num_hidden_layers
    run_dir = os.path.join(work, tag.replace(" ", "_"))
    os.makedirs(run_dir)
    cfg_path = os.path.join(run_dir, "uniter.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg.to_dict(), f)
    ckpt_name = "finetune.ckpt"
    vis = os.path.join(run_dir, "vis")
    argv = ["--data_path", synth["root"],
            "--feature_path", synth["feature_dir"],
            "--vocab_file", synth["vocab"], "--model_path", run_dir,
            "--model_save_name", ckpt_name, "--uniter_config", cfg_path,
            "--max_epoch", str(epochs), "--num_folds", "0",
            "--batch_size", str(batch_size),
            "--gradient_accumulation", str(TRAIN_ACCUM),
            "--confounder_repeat", "3", "--pos_wt", "1.8",
            "--scheduler", "warmup_cosine", "--warmup_steps", "2",
            "--lr", "3e-5", "--vis_path", vis]
    if dtype == "bfloat16":
        argv.append("--compute_bf16")
    if fuse:
        argv.append("--fuse_accum")
    passlog.clear()
    reset_launches(A)
    mark = adam_mark()
    t0 = time.time()
    train_uniter.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(A.LAUNCHES)
    bwd = name + "_bwd"
    by_route = check_route_counts(A, tag, dtype, (name, bwd))
    count_gemm_launches(tag, dtype)
    # every micro-batch of an epoch is stepped, the short last group
    # padded to TRAIN_ACCUM; --fuse_accum runs one forward per group
    groups = sum(_ceil(_ceil(n, batch_size), TRAIN_ACCUM)
                 for n, _ in passlog.epochs)
    check_adam_launches(tag, mark, groups, uniter_leaves(cfg))
    train_fwd = groups * (1 if fuse else TRAIN_ACCUM)
    eval_batches = sum(_ceil(n, batch_size) for n, _ in passlog.passes)
    want = {name: layers * (train_fwd + eval_batches),
            bwd: layers * train_fwd}
    log("%s: CLI %.1f s, %d epochs; launches forward %d (expected %d = %d "
        "layers x (%d train + %d eval forwards)), backward %d (expected %d); "
        "by route %s"
        % (tag, wall, len(passlog.epochs), counts[name], want[name], layers,
           train_fwd, eval_batches, counts[bwd], want[bwd], by_route))
    for i, (n, secs) in enumerate(passlog.epochs, 1):
        log("%s: epoch %d, %d memes in %.4f s = %.1f memes/s"
            % (tag, i, n, secs, n / secs))
    if len(passlog.epochs) != epochs or any(
            counts[k] != want.get(k, 0) for k in counts):
        fail("%s: launch counts %s, expected %s, epochs %s"
             % (tag, counts, want, passlog.epochs))
    with open(os.path.join(vis, "finetune", "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    losses = [r["value"] for r in scalars if r["name"] == "Train/Epoch_Loss"]
    if len(losses) != epochs or not all(math.isfinite(x) for x in losses):
        fail("%s: epoch losses %s" % (tag, losses))
    if not os.path.isfile(os.path.join(run_dir, ckpt_name)):
        fail("%s: no best checkpoint" % tag)
    metrics = check_outputs(run_dir, ckpt_name, synth)
    log("%s: epoch losses %s, best checkpoint, 4 CSVs + metrics JSON, dev "
        "AUROC %.4f" % (tag, ["%.4f" % x for x in losses],
                        metrics["dev"]["aucroc"]))
    return {name: counts[name], bwd: counts[bwd]}, run_dir


def train_phase(torch, work: str, synth: dict, passlog) -> dict:
    """Full-width UNITER-base fine-tunes through the port's CLI (the README
    recipe with --num_folds 0, 2 epochs, dropout 0.1 / 0.1 as
    configs/uniter-base.json, random weights from seed 42): the per-sample
    kernel in fp32 and with --compute_bf16, the pair-blocked kernel with
    --fuse_accum in bf16 and fp32 (``finetune_cli_run``); returns the
    launches of each (kernel, dtype)."""
    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.ops import attention as A

    launches = {}
    for name, dtype, blocked, fuse in TRAIN_RUNS:
        tag = "train %s %s%s" % (name, dtype, " fuse_accum" if fuse else "")
        counts, _ = finetune_cli_run(
            torch, work, synth, passlog, A,
            UniterConfig(use_pallas_attention=True, pallas_blocked=blocked),
            name, dtype, fuse, 2, tag)
        for kernel, n in counts.items():
            launches[(kernel, dtype)] = n
    return launches


GRAD_TOL = 1e-4


def grad_worst(g_card: dict, g_cpu: dict) -> tuple:
    """(worst, parameter): the largest |card − CPU| of any gradient over
    that gradient's largest magnitude on the CPU, floored at a thousandth of
    the model's largest gradient (a gradient that is zero up to rounding,
    the key bias: softmax ignores a shift of a whole score row)."""
    if set(g_card) != set(g_cpu):
        fail("gradients reach other parameters on the card and the CPU")
    top = max(float(g.abs().max()) for g in g_cpu.values())
    worst, worst_name = 0.0, ""
    for n, g in g_cpu.items():
        scale = max(float(g.abs().max()), 1e-3 * top)
        rel = float((g_card[n] - g).abs().max()) / scale
        if rel > worst:
            worst, worst_name = rel, n
    return worst, worst_name


def grad_check(torch, synth: dict) -> None:
    """One micro-batch of 16 (the last sample masked out), fp32, dropout
    off, the same weights: the bce_logits loss (pos_wt 1.8) and every
    parameter's gradient on the card (kernels) against the CPU (plain
    versions), within GRAD_TOL of each gradient's largest magnitude. A
    gradient that is zero up to rounding (the key bias: softmax ignores a
    shift of a whole score row) is held to GRAD_TOL of a thousandth of the
    model's largest gradient instead."""
    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.core.seeding import torch_generator
    from meme_challenge_tpu_torch.data.meme_dataset import MemeDataset
    from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
    from meme_challenge_tpu_torch.models.uniter import init_meme_uniter
    from meme_challenge_tpu_torch.train.losses import bce_logits_loss
    from meme_challenge_tpu_torch.train.steps import (
        MODEL_INPUT_KEYS,
        TRAIN_KEYS,
        to_device,
    )

    ds = MemeDataset(synth["train"], feature_dir=synth["feature_dir"],
                     tokenizer=BertTokenizer(synth["vocab"]), max_txt_len=60,
                     max_bb=100, img_dim=2048)
    batch = ds.batch(list(range(16)))
    batch["sample_mask"] = (torch.arange(16) < 15).int().numpy()
    cfg = UniterConfig(use_pallas_attention=True, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    cpu = init_meme_uniter(cfg, 1, "cpu", torch_generator(3, "cpu"))
    card = init_meme_uniter(cfg, 1, "cuda", torch_generator(3, "cuda"))
    card.load_state_dict(cpu.state_dict())
    out = {}
    for device, model in (("cuda", card), ("cpu", cpu)):
        b = to_device(batch, device, keys=MODEL_INPUT_KEYS + TRAIN_KEYS)
        logits = model(b, deterministic=False)
        loss, _ = bce_logits_loss(logits, b["labels"], b["sample_mask"], 1.8)
        loss.backward()
        out[device] = (loss.item(), {n: p.grad.float().cpu()
                                     for n, p in model.named_parameters()
                                     if p.grad is not None})
    (l_card, g_card), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    worst, worst_name = grad_worst(g_card, g_cpu)
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    log("grad: one fp32 micro-batch of 16, dropout off, card vs CPU: loss "
        "%.6f vs %.6f (relative %.3g); %d parameter gradients, worst %.3g of "
        "the largest magnitude (%s; tol %g)"
        % (l_card, l_cpu, loss_rel, len(g_cpu), worst, worst_name, GRAD_TOL))
    if not (loss_rel <= GRAD_TOL and worst <= GRAD_TOL):
        fail("card gradients disagree with the CPU's")


def train_breakdown(torch, synth: dict, dtype: str) -> None:
    """Where one optimizer step's time goes (informational): accumulation 2
    × batch 16, Adam with bf16 moments (the TrainConfig defaults), dropout
    on, per-sample kernel. Wall ms of the step against the host's ms to
    issue it, and the device time by kernel from torch.profiler."""
    from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
    from meme_challenge_tpu_torch.core.seeding import (
        dropout_generator,
        torch_generator,
    )
    from meme_challenge_tpu_torch.data.meme_dataset import MemeDataset
    from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
    from meme_challenge_tpu_torch.models.uniter import init_meme_uniter
    from meme_challenge_tpu_torch.train.losses import make_loss_fn
    from meme_challenge_tpu_torch.train.optim import Optimizer
    from meme_challenge_tpu_torch.train.steps import (
        MODEL_INPUT_KEYS,
        TRAIN_KEYS,
        create_train_state,
        make_train_step,
        stack_for_accum,
        to_device,
    )

    ds = MemeDataset(synth["train"], feature_dir=synth["feature_dir"],
                     tokenizer=BertTokenizer(synth["vocab"]), max_txt_len=60,
                     max_bb=100, img_dim=2048)
    micros = []
    for a in range(TRAIN_ACCUM):
        b = ds.batch(list(range(16 * a, 16 * a + 16)))
        b["sample_mask"] = torch.ones(16, dtype=torch.int32).numpy()
        b.pop("ids")
        micros.append(b)
    batch = to_device(stack_for_accum(micros), "cuda",
                      keys=MODEL_INPUT_KEYS + TRAIN_KEYS)
    cfg = UniterConfig(use_pallas_attention=True)
    if dtype == "bfloat16":
        cfg = cfg.replace(dtype="bfloat16", attention_score_dtype="bfloat16",
                          dropout_bits_dtype="uint8")
    model = init_meme_uniter(cfg, 1, "cuda", torch_generator(0, "cuda"))
    c = TrainConfig()
    opt = Optimizer("adam", 3e-5, lambda step: 1.0, beta1=c.beta1,
                    beta2=c.beta2, weight_decay=c.weight_decay,
                    max_grad_norm=c.max_grad_norm, mu_dtype=c.adam_mu_dtype,
                    nu_dtype=c.adam_nu_dtype)
    state = create_train_state(model, opt)
    step = make_train_step(model, make_loss_fn("bce_logits", 1.8), opt,
                           accum_steps=TRAIN_ACCUM)

    def one():
        step(state, batch, dropout_generator(0, state.step, "cuda"))

    for _ in range(2):
        one()
    torch.cuda.synchronize()
    issue, wall = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        one()
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    wall_ms, issue_ms = statistics.median(wall), statistics.median(issue)
    log("breakdown train %s: one step (2 x 16 memes, forward, backward, "
        "Adam): wall %.3f ms, host issue %.3f ms; %.1f memes/s at this rate"
        % (dtype, wall_ms, issue_ms, 32 / wall_ms * 1e3))
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        n = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                one()
            torch.cuda.synchronize()
            pwall = (time.perf_counter() - t0) * 1e3 / n
        rows, host_rows, n_launch = [], [], 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                t = getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                rows.append((t / n / 1e3, e.key))
            else:
                host_rows.append((e.self_cpu_time_total / n / 1e3,
                                  e.count // n, e.key))
                if "LaunchKernel" in e.key:
                    n_launch += e.count // n
        rows.sort(reverse=True)
        host_rows.sort(reverse=True)
        busy = sum(t for t, _ in rows)
        log("breakdown train %s: profiled step: wall %.3f ms, kernels %.3f "
            "ms, device idle share %.3f, %d kernel launches; top kernels "
            "(ms): %s" % (dtype, pwall, busy, 1.0 - busy / pwall, n_launch,
                          "; ".join("%s %.3f" % (k[:48], t)
                                    for t, k in rows[:8])))
        log("breakdown train %s: host time by operator (self ms, calls per "
            "step): %s" % (dtype, "; ".join(
                "%s %.3f x%d" % (k[:40], t, c) for t, c, k in host_rows[:10])))
    except Exception as e:  # informational: a missing trace fails nothing
        log("breakdown train %s: profiler unavailable (%s)" % (dtype, e))


def _read_csv(path: str) -> list:
    with open(path) as f:
        return [r.split(",") for r in f.read().split("\n")[1:] if r]


def crossval_phase(torch, work: str, synth: dict, passlog) -> dict:
    """The README recipe through the port's CLI at full UNITER-base width:
    --num_folds -1 --crossval_use_dev with dev size 16, 1 epoch a fold, the
    per-sample kernel in float32, dropout 0.1, then the ensemble search on
    the card. Checks the splits, every fold's artifacts, the launch counts
    over all folds and their route, that the device EA ran, and the
    ensemble CSVs; returns the launches of each (kernel, dtype) and the
    folds' (memes, seconds) epochs."""
    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.data.crossval_splits import crossval_dir
    from meme_challenge_tpu_torch.ensemble import ensemble as E
    from meme_challenge_tpu_torch.ops import attention as A
    from meme_challenge_tpu_torch.train import train_uniter

    name, dtype, dev_size = "fused_attention", "float32", 16
    batch_size, layers = 16, UniterConfig().num_hidden_layers
    bwd = name + "_bwd"
    run_dir = os.path.join(work, "crossval")
    os.makedirs(run_dir)
    cfg_path = os.path.join(run_dir, "uniter.json")
    with open(cfg_path, "w") as f:
        json.dump(UniterConfig(use_pallas_attention=True).to_dict(), f)
    argv = ["--data_path", synth["root"],
            "--feature_path", synth["feature_dir"],
            "--vocab_file", synth["vocab"], "--model_path", run_dir,
            "--model_save_name", "cv.ckpt", "--uniter_config", cfg_path,
            "--max_epoch", "1", "--num_folds", "-1", "--crossval_use_dev",
            "--crossval_dev_size", str(dev_size),
            "--batch_size", str(batch_size),
            "--gradient_accumulation", str(TRAIN_ACCUM),
            "--confounder_repeat", "3", "--pos_wt", "1.8",
            "--scheduler", "warmup_cosine", "--warmup_steps", "2",
            "--lr", "3e-5", "--seed", "43"]
    passlog.clear()
    reset_launches(A)
    ea_runs = E.DEVICE_EA_RUNS["count"]
    mark = adam_mark()
    t0 = time.time()
    results = train_uniter.main(argv)
    torch.cuda.synchronize()
    t_end = time.time()
    counts = dict(A.LAUNCHES)
    by_route = check_route_counts(A, "crossval", dtype, (name, bwd))
    count_gemm_launches("crossval", dtype)

    cv_dir = crossval_dir(synth["root"], dev_size, True)
    n_splits = len([f for f in os.listdir(cv_dir) if f.startswith("train_")])
    n_folds = len(results["val_metrics"])
    if not (n_folds == n_splits >= 2 and len(passlog.epochs) == n_folds
            and len(passlog.folds) == n_folds + 1):
        fail("crossval: %d folds ran of %d splits, %d epochs, fold records "
             "%s" % (n_folds, n_splits, len(passlog.epochs), passlog.folds))
    groups = sum(_ceil(_ceil(n, batch_size), TRAIN_ACCUM)
                 for n, _ in passlog.epochs)
    check_adam_launches("crossval", mark, groups,
                        uniter_leaves(UniterConfig()))
    train_fwd = groups * TRAIN_ACCUM
    eval_batches = sum(_ceil(n, batch_size) for n, _ in passlog.passes)
    want = {name: layers * (train_fwd + eval_batches),
            bwd: layers * train_fwd}
    log("crossval: %d folds (dev size %d, use_dev_set) in %.1f s; launches "
        "forward %d (expected %d = %d layers x (%d train + %d eval "
        "forwards)), backward %d (expected %d); by route %s"
        % (n_folds, dev_size, t_end - t0, counts[name], want[name], layers,
           train_fwd, eval_batches, counts[bwd], want[bwd], by_route))
    if any(counts[k] != want.get(k, 0) for k in counts):
        fail("crossval: launch counts %s, expected %s" % (counts, want))

    fold_walls = [b - a for a, b in zip(passlog.folds, passlog.folds[1:])]
    ens_wall = t_end - passlog.folds[-1]
    for i, ((n, secs), wall, m) in enumerate(zip(
            passlog.epochs, fold_walls, results["val_metrics"])):
        base = "cv_fold_%d" % i
        want_files = ["%s.ckpt" % base, "%s_metrics.json" % base] + [
            "%s_%s_preds.csv" % (base, ds) for ds in (
                "dev_%02d" % i, "dev_seen_%02d" % i, "test_seen",
                "test_unseen", "dev_unseen")]
        missing = [f for f in want_files
                   if not os.path.isfile(os.path.join(run_dir, f))]
        if missing or not math.isfinite(m["aucroc"]):
            fail("crossval fold %d: missing %s, metrics %s" % (i, missing, m))
        for f in want_files[2:]:
            probs = [float(r[1]) for r in _read_csv(os.path.join(run_dir, f))]
            if not probs or not all(0.0 <= p <= 1.0 for p in probs):
                fail("crossval: bad predictions in " + f)
        log("crossval fold %d: train %d memes in %.4f s = %.1f memes/s; "
            "fold wall %.2f s (init, epoch, validation, checkpoint, reload, "
            "5 CSVs); dev AUROC %.4f"
            % (i, n, secs, n / secs, wall, m["aucroc"]))

    ens = results.get("ensemble")
    ran = E.DEVICE_EA_RUNS["count"] - ea_runs
    if ens is None or ran != 1:
        fail("crossval: ensemble %s, device EA runs %d" % (ens, ran))
    dev_ids = set()
    for i in range(n_folds):
        with open(os.path.join(cv_dir, "dev_seen_%02d.jsonl" % i)) as f:
            dev_ids |= {json.loads(line)["id"] for line in f if line.strip()}
    rows = {}
    for ds, n_ids in (("dev_seen_00", len(dev_ids)),
                      ("test_seen", _n_lines(synth["test_seen"])),
                      ("test_unseen", _n_lines(synth["test_unseen"])),
                      ("dev_unseen", _n_lines(synth["dev_unseen"]))):
        path = os.path.join(run_dir, "cv_%s_ensemble.csv" % ds)
        if not os.path.isfile(path):
            fail("crossval: missing " + path)
        table = _read_csv(path)
        rows[ds] = len(table)
        if len(table) != n_ids or not all(
                0.0 <= float(r[1]) <= 1.0 for r in table):
            fail("crossval: %s has %d rows, expected %d"
                 % (path, len(table), n_ids))
    log("crossval ensemble on the card: %.2f s (brute force %d candidates, "
        "device EA 512 x 100; device EA runs %d); score %.4f, weights %s "
        "(on_logits %s), threshold %.4f; ensemble CSV rows %s"
        % (ens_wall, min(4 ** n_folds, 10000), ran,
           ens["score"], ["%.3f" % w for w in ens["config"]["weights"]],
           ens["config"]["on_logits"], ens["threshold"], rows))
    return ({(name, dtype): counts[name], (bwd, dtype): counts[bwd]},
            list(passlog.epochs))


REMAT_TOL = 1e-6


def remat_check(torch, synth: dict) -> None:
    """One fp32 micro-batch of 16 at full width, dropout 0.1 / 0.1, the
    per-sample kernel: the loss and every gradient with remat (policy
    "full" and "dots") against no remat, each run from a fresh generator
    of one seed, within REMAT_TOL of each gradient's largest magnitude (a
    gradient zero up to rounding, the key bias's, against a thousandth of
    the model's largest). The recompute launches the forward kernel once
    more a layer."""
    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.core.seeding import torch_generator
    from meme_challenge_tpu_torch.data.meme_dataset import MemeDataset
    from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
    from meme_challenge_tpu_torch.models.uniter import init_meme_uniter
    from meme_challenge_tpu_torch.ops import attention as A
    from meme_challenge_tpu_torch.train.losses import bce_logits_loss
    from meme_challenge_tpu_torch.train.steps import (
        MODEL_INPUT_KEYS,
        TRAIN_KEYS,
        to_device,
    )

    ds = MemeDataset(synth["train"], feature_dir=synth["feature_dir"],
                     tokenizer=BertTokenizer(synth["vocab"]), max_txt_len=60,
                     max_bb=100, img_dim=2048)
    batch = ds.batch(list(range(16, 32)))
    batch["sample_mask"] = (torch.arange(16) < 15).int().numpy()
    b = to_device(batch, "cuda", keys=MODEL_INPUT_KEYS + TRAIN_KEYS)
    layers = UniterConfig().num_hidden_layers
    out = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = UniterConfig(use_pallas_attention=True, remat=remat,
                           remat_policy=policy)
        model = init_meme_uniter(cfg, 1, "cuda", torch_generator(4, "cuda"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        fwd = A.LAUNCHES["fused_attention"]
        t0 = time.perf_counter()
        logits = model(b, deterministic=False,
                       generator=torch_generator(5, "cuda"))
        loss, _ = bce_logits_loss(logits, b["labels"], b["sample_mask"], 1.8)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 20
        fwd = A.LAUNCHES["fused_attention"] - fwd
        tag = "remat %s" % policy if remat else "no remat"
        out[tag] = (loss.item(), {n: p.grad.float().cpu() for n, p in
                                  model.named_parameters()
                                  if p.grad is not None})
        log("remat: %s: forward kernel launches %d, forward+backward %.1f ms "
            "(first call), activation peak %.0f MiB"
            % (tag, fwd, ms, peak))
        if fwd != layers * (2 if remat else 1):
            fail("remat %s: %d forward launches" % (tag, fwd))
        del model, logits, loss
    l_ref, g_ref = out.pop("no remat")
    top = max(float(g.abs().max()) for g in g_ref.values())
    for tag, (loss, grads) in out.items():
        worst, worst_name = 0.0, ""
        for n, g in g_ref.items():
            scale = max(float(g.abs().max()), 1e-3 * top)
            rel = float((grads[n] - g).abs().max()) / scale
            if rel > worst:
                worst, worst_name = rel, n
        log("remat: %s vs no remat, dropout 0.1, same generator seed: loss "
            "%.7f vs %.7f; %d gradients, worst %.3g of the largest magnitude "
            "(%s; tol %g)" % (tag, loss, l_ref, len(grads), worst,
                              worst_name, REMAT_TOL))
        if not (set(grads) == set(g_ref) and worst <= REMAT_TOL
                and abs(loss - l_ref) <= REMAT_TOL * abs(l_ref)):
            fail("remat %s gradients disagree with no remat" % tag)


def ensemble_scale_phase(torch) -> None:
    """The ensemble search at the recipe's size on the card: F 15 folds,
    N 500 memes (dev_seen), each fold predicting its half (250, the rest
    −1), probabilities to 6 decimals from a seed. Wall times of the brute
    force (10 000 candidates, both mixing spaces) and the device EA
    (512 × 100), first and second call, and of the host EA; the scoring
    call alone by CUDA events. Checks as in the module docstring."""
    import numpy as np

    from meme_challenge_tpu_torch.core.metrics import aucroc
    from meme_challenge_tpu_torch.ensemble import ensemble as E
    from meme_challenge_tpu_torch.ops.device_metrics import (
        ensemble_prediction,
        ensemble_scores,
        ensemble_scores_logit,
    )

    F, N = 15, 500
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 2, N)
    signal = (2.0 * labels - 1.0) * 0.8
    preds = np.stack([np.round(1.0 / (1.0 + np.exp(
        -(signal + rng.randn(N) * (0.8 + 0.1 * f)))), 6) for f in range(F)])
    for f in range(F):
        preds[f, rng.permutation(N)[:N // 2]] = -1.0
    indiv = [aucroc(p[p >= 0], labels[p >= 0]) for p in preds]
    n_pos = int(labels.sum())
    n_neg = N - n_pos

    def timed(fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    kw = dict(num_weights=F, individual_scores=indiv, device="cuda")
    times = {}
    for call in ("first", "second"):
        (bf, times["bf_" + call]) = timed(lambda: E.brute_force_finder(
            preds, labels, F, device="cuda"))
        (ea, times["ea_" + call]) = timed(
            lambda: E.ea_ensemble_finder_device(preds, labels, **kw))
    host_ea, times["host_ea"] = timed(
        lambda: E.ea_ensemble_finder(preds, labels, **kw))
    bf_cpu, times["bf_cpu"] = timed(lambda: E.brute_force_finder(
        preds, labels, F, device="cpu"))
    p_dev = torch.as_tensor(preds, dtype=torch.float32, device="cuda")
    l_dev = torch.as_tensor(labels, device="cuda")
    grid = torch.as_tensor(rng.choice([0.0, 0.5, 1.0, 2.0], (10000, F)),
                           dtype=torch.float32, device="cuda")
    pop = torch.as_tensor(rng.uniform(0, 4, (512, F)), dtype=torch.float32,
                          device="cuda")
    score_ms, score_host = device_ms(
        lambda: ensemble_scores(p_dev, grid, l_dev), iters=3, reps=3)
    fit_ms, fit_host = device_ms(
        lambda: ensemble_scores_logit(p_dev, pop, l_dev), iters=5, reps=3)
    log("ensemble F %d, N %d (%d present a fold): brute force 10000 "
        "candidates %.3f s (first call %.3f s; the CPU: %.3f s), device EA "
        "512 x 100 %.3f s (first call %.3f s), host EA 512 x 100 (fitness "
        "on the card) %.3f s | one ensemble_scores call at K 10000: device "
        "%.3f ms, host issue %.3f ms; one EA fitness call at K 512: device "
        "%.3f ms, host issue %.3f ms"
        % (F, N, N // 2, times["bf_second"], times["bf_first"],
           times["bf_cpu"], times["ea_second"], times["ea_first"],
           times["host_ea"], score_ms, score_host, fit_ms, fit_host))
    log("ensemble scores: brute force %.6f (card) vs %.6f (CPU), weights "
        "equal %s; device EA %.6f, host EA %.6f; best single fold %.6f"
        % (bf[0], bf_cpu[0], bf[1] == bf_cpu[1], ea[0], host_ea[0],
           max(indiv)))
    # 64 candidates: the card's scores against the host AUROC of its mixes
    worst = 0.0
    for on_logits, row in ((True, 0), (False, 1)):
        mixes = ensemble_prediction(p_dev, grid[:64], on_logits).cpu()
        got = ensemble_scores(p_dev, grid[:64], l_dev)[row].cpu()
        for k in range(64):
            ref = aucroc(mixes[k].double().numpy(), labels)
            worst = max(worst, abs(float(got[k]) - ref))
    gap = abs(bf[0] - bf_cpu[0])
    log("ensemble checks: 64 candidates x 2 spaces, card scores vs host "
        "AUROC of the card's mixes: max_abs_err %.3g (tol 1e-6); brute-force "
        "best, card vs CPU: %.3g (tol 2/(n_pos n_neg) = %.3g)"
        % (worst, gap, 2.0 / (n_pos * n_neg)))
    if not (worst <= 1e-6 and gap <= 2.0 / (n_pos * n_neg)
            and ea[0] >= max(indiv) - 1e-6
            and all(0.0 <= w <= 4.0 for w in ea[1]["weights"])):
        fail("ensemble at the recipe's size: scores disagree")


# ------------------------------------------------------------------ phase 9

FOLDS = 3
# epochs of phase 9b's recipe and of phase 14a's, which must equal it: one,
# as phase 6 runs a fold (each epoch writes a ≈ 4 GB resume file)
FOLD_CLI_EPOCHS = 1
CARD = [""]  # the nvidia-smi name and power limit, beside every number


def on_card(msg: str) -> str:
    return "%s [%s]" % (msg, CARD[0])


def fold_kernel_checks(torch, A) -> None:
    """Phase 9a: both kernels at the fold-stacked shapes of FOLDS folds,
    fp32 and bf16, rate 0 and 0.1: forward and backward against the plain
    versions (TOL, relative for the backward; the same zero positions under
    dropout, read through one-hot v windows); the pair-blocked call also
    against FOLDS separate launches with the per-fold seeds."""
    import functools

    gen = torch.Generator(device="cuda").manual_seed(9)
    scale, rate = 1.0 / D ** 0.5, 0.1
    for name, wrapper, plain, fold_b in (
            ("fused_attention", A.fused_attention, A.fused_attention_plain,
             B),
            ("fused_attention_blocked", A.fused_attention_blocked,
             A.fused_attention_blocked_plain, 2 * B)):
        blocked = name.endswith("blocked")
        batch = FOLDS * fold_b
        n_seeds = (A.blocked_seed_count(batch, H, FOLDS) if blocked
                   else batch)
        group = A._largest_block(fold_b * H) if blocked else H
        fwd = functools.partial(wrapper, folds=FOLDS)
        for dtype in ("float32", "bfloat16"):
            q, k, v, bias = attention_inputs(torch, dtype, gen, batch)
            do = torch.randn(q.shape, generator=gen,
                             device="cuda").to(q.dtype)
            seeds = torch.randint(0, 2 ** 31 - 1, (n_seeds,), generator=gen,
                                  device="cuda", dtype=torch.int32)
            err_fwd, rel_bwd, sep = 0.0, 0.0, 0.0
            for r in (0.0, rate):
                out = fwd(q, k, v, bias, scale, r, seeds)
                ref = plain(q, k, v, bias, scale, r, seeds, folds=FOLDS)
                err_fwd = max(err_fwd, (out.float() - ref.float()).abs()
                              .max().item())
                got = kernel_grads(torch, fwd, q, k, v, bias, do, scale, r,
                                   seeds)
                ref_g = A.fused_attention_bwd_plain(q, k, v, bias, do, scale,
                                                    r, seeds, group)
                rel_bwd = max(rel_bwd, _rel_err(torch, got, ref_g)[1])
                if blocked:  # FOLDS separate launches, per-fold seeds
                    n = n_seeds // FOLDS
                    for f in range(FOLDS):
                        sl = slice(f * fold_b, (f + 1) * fold_b)
                        args = (q[sl], k[sl], v[sl], bias[sl])
                        one = wrapper(*args, scale, r,
                                      seeds[f * n:(f + 1) * n])
                        one_g = kernel_grads(torch, wrapper, *args, do[sl],
                                             scale, r,
                                             seeds[f * n:(f + 1) * n])
                        for a, b in zip((out[sl],) + tuple(
                                g[sl] for g in got), (one,) + tuple(one_g)):
                            sep = max(sep, (a.float() - b.float()).abs()
                                      .max().item())
            zeros_equal = True
            for c in (0, 64, 96):
                probe = torch.zeros_like(v)
                d_idx = torch.arange(D, device="cuda")
                probe[:, :, c + d_idx, d_idx] = 1
                zeros_equal &= bool(torch.equal(
                    fwd(q, k, probe, bias, scale, rate, seeds) == 0,
                    plain(q, k, probe, bias, scale, rate, seeds,
                          folds=FOLDS) == 0))
            torch.cuda.synchronize()
            tol = TOL[dtype]
            log(on_card(
                "fold-parallel kernel %s %s at F %d x B %d (B %d in the "
                "kernel's batch axis, seeds %d): forward max_abs_err %.3g, "
                "backward relative error %.3g (tol %g), zero_positions_"
                "equal=%s%s" % (name, dtype, FOLDS, fold_b, batch, n_seeds,
                                err_fwd, rel_bwd, tol, zeros_equal,
                                "; against %d separate launches with the "
                                "per-fold seeds: max_abs_err %.3g"
                                % (FOLDS, sep) if blocked else "")))
            if not (err_fwd <= tol and rel_bwd <= tol and zeros_equal
                    and sep <= tol):
                fail("fold-stacked kernel %s %s disagrees" % (name, dtype))


def fold_cli_argv(synth: dict, run_dir: str) -> list:
    """The arguments of phase 9b's fold-parallel recipe (full-width
    UNITER-base, fp32, per-sample kernel, FOLD_CLI_EPOCHS epochs), writing
    into ``run_dir``, without the mesh flags."""
    from meme_challenge_tpu_torch.core.config import UniterConfig

    cfg_path = os.path.join(run_dir, "uniter.json")
    with open(cfg_path, "w") as f:
        json.dump(UniterConfig(use_pallas_attention=True).to_dict(), f)
    return ["--data_path", synth["root"],
            "--feature_path", synth["feature_dir"],
            "--vocab_file", synth["vocab"], "--model_path", run_dir,
            "--model_save_name", "cv.ckpt", "--uniter_config", cfg_path,
            "--max_epoch", str(FOLD_CLI_EPOCHS), "--num_folds", "-1",
            "--crossval_use_dev",
            "--crossval_dev_size", "16", "--batch_size", "16",
            "--gradient_accumulation", str(TRAIN_ACCUM),
            "--confounder_repeat", "3", "--pos_wt", "1.8",
            "--scheduler", "warmup_cosine", "--warmup_steps", "2",
            "--lr", "3e-5", "--seed", "43"]


def _step_ms(epochs: list, steps: list) -> list:
    """ms an optimizer step, epoch by epoch, from (memes, s) and (steps,
    micro-batches) records."""
    return ["%.1f" % (1e3 * secs / n) for (_, secs), (n, _) in zip(epochs,
                                                                  steps)]


def _csv_diff(run_dir: str, ref_dir: str) -> tuple:
    """(fold CSVs compared, the largest probability difference in units of
    the CSVs' last written digit (1e-6), the rows that differ at all) of
    ``run_dir``'s ``*_preds.csv`` against ``ref_dir``'s; the ids must be
    equal, every file present."""
    names = sorted(f for f in os.listdir(ref_dir) if f.endswith("_preds.csv"))
    worst, rows = 0, 0
    for f in names:
        path = os.path.join(run_dir, f)
        if not os.path.isfile(path):
            fail("multi-device 14a: %s is missing" % path)
        a, b = _read_csv(path), _read_csv(os.path.join(ref_dir, f))
        if [r[0] for r in a] != [r[0] for r in b]:
            fail("multi-device 14a: the ids of %s differ" % f)
        diffs = [abs(round(float(x[1]) * 1e6) - round(float(y[1]) * 1e6))
                 for x, y in zip(a, b)]
        worst = max([worst] + diffs)
        rows += sum(d > 0 for d in diffs)
    return len(names), worst, rows


def multidevice_phase(torch, work: str, synth: dict, passlog) -> None:
    """Phase 14, right after 9b: (a) phase 9b's recipe through the CLI in a
    process of its own under ``torchrun --standalone --nproc_per_node 1``
    with ``--mesh_shape 1,1,1 --mesh_axes fold,data,model`` (an ``nccl``
    group of one rank and the mesh path of ``parallel/``: DTensor shards,
    the gathered resume file, the barriers, rank 0's ensemble). Every
    fold's CSVs must equal 9b's plain ``--mesh_shape 1 --mesh_axes fold``
    run's (ids, and the probabilities to their last written digit: the
    recipe repeats bit for bit since the fold-stacked embedding lookups sum
    their gradients in a fixed order). Each epoch's ms an optimizer step of
    the two runs side by side (the collectives' overhead at world size 1).
    (b) The dry run (``parallel/dryrun.py --spawn 1``) on the card, in a
    process of its own beside (a)'s."""
    plain_ms = _step_ms(passlog.epochs, passlog.fold_steps)
    run_dir = os.path.join(work, "multidevice")
    os.makedirs(run_dir)
    env = dict(os.environ, PYTHONPATH=ROOT)
    # (b) starts first and runs beside (a), each in its own process on the
    # card: their start-up overlaps (a's step ms carry its first epoch's
    # warm-up either way)
    dry_log = os.path.join(work, "dryrun.log")
    t0 = time.time()
    with open(dry_log, "w") as out:
        dry = subprocess.Popen(
            [sys.executable, "-m", "meme_challenge_tpu_torch.parallel.dryrun",
             "--spawn", "1"], env=env, cwd=ROOT, stdout=out,
            stderr=subprocess.STDOUT, text=True)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m",
             "meme_challenge_tpu_torch.train.train_uniter",
             *fold_cli_argv(synth, run_dir), "--mesh_shape", "1,1,1",
             "--mesh_axes", "fold,data,model"],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=900)
        wall = time.time() - t0
        dry_rc = dry.wait(timeout=600)
        both = time.time() - t0
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        fail("multi-device 14a: torchrun train_uniter rc %d:\n%s"
             % (proc.returncode, text[-3000:]))
    nccl_ms = _step_ms(
        [(int(m.group(1)), float(m.group(2))) for m in re.finditer(
            r"train epoch \d+: (\d+) memes in ([\d.]+) s", text)],
        [(int(m.group(1)), 0) for m in re.finditer(
            r"\[fold-parallel\] epoch \d+: (\d+) steps", text)])
    group = re.search(r"process group: backend (\w+), world size (\d+), "
                      r"mesh (\S+)", text)
    if not group or group.group(1) != "nccl" or group.group(2) != "1":
        fail("multi-device 14a: no nccl group of one rank in the log: %s"
             % (group.group(0) if group else text[-2000:]))
    n, worst, rows = _csv_diff(run_dir, os.path.join(work, "fold_parallel"))
    ens = sorted(f for f in os.listdir(run_dir)
                 if f.endswith("_ensemble.csv"))
    log(on_card(
        "multi-device 14a: torchrun, 1 process, %s group of %s rank, mesh "
        "%s: %d fold CSVs against 9b's plain --mesh_shape 1 run, worst "
        "probability difference %d units of 1e-6 in %d rows (gate: 0); %d "
        "ensemble CSVs; command %.1f s (beside 14b); ms an optimizer step by "
        "epoch: nccl world size 1 %s, plain (9b, in process) %s" % (
            group.group(1), group.group(2), group.group(3), n, worst, rows,
            len(ens), wall, nccl_ms, plain_ms)))
    if worst > 0 or not n or len(ens) != 4:
        fail("multi-device 14a: the CSVs differ from the plain run's (worst "
             "%d units of 1e-6 in %d rows, ensemble CSVs %s)"
             % (worst, rows, ens))

    with open(dry_log) as f:
        dry_out = f.read()
    ok = [ln for ln in dry_out.splitlines()
          if ln.startswith("dryrun_multichip OK")]
    log(on_card("multi-device 14b: dryrun --spawn 1 on the card beside 14a, "
                "both done in %.1f s: %s" % (both, ok)))
    if dry_rc != 0 or not ok:
        fail("multi-device 14b: the dry run failed (rc %d):\n%s"
             % (dry_rc, dry_out[-3000:]))


def fold_cli_phase(torch, work: str, synth: dict, passlog,
                   seq_epochs: list) -> dict:
    """Phase 9b: the crossval phase's recipe through the CLI with
    --mesh_shape 1 --mesh_axes fold, FOLD_CLI_EPOCHS epochs, at full width,
    fp32, per-sample kernel: every fold's checkpoint, CSVs and metrics JSON, the
    ensemble CSVs (the device EA ran), and the launches: 12 layers x
    (fold-stacked micro-batches + eval batches) forward and 12 x
    micro-batches backward, no factor of F, all on mma_tf32x3. Returns the
    launches of each (kernel, dtype)."""
    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.ensemble import ensemble as E
    from meme_challenge_tpu_torch.ops import attention as A
    from meme_challenge_tpu_torch.train import train_uniter

    name, dtype, bwd = "fused_attention", "float32", "fused_attention_bwd"
    layers = UniterConfig().num_hidden_layers
    run_dir = os.path.join(work, "fold_parallel")
    os.makedirs(run_dir)
    argv = fold_cli_argv(synth, run_dir) + ["--mesh_shape", "1",
                                            "--mesh_axes", "fold"]
    passlog.clear()
    ea_runs = E.DEVICE_EA_RUNS["count"]
    reset_launches(A)
    mark = adam_mark()
    t0 = time.time()
    results = train_uniter.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(A.LAUNCHES)
    by_route = check_route_counts(A, "fold-parallel", dtype, (name, bwd))
    count_gemm_launches("fold-parallel")
    # the fold-stacked optimizer keeps the _foreach_* chain
    check_adam_launches("fold-parallel", mark, fused=False)
    n_folds = len(results["val_metrics"])
    micro = sum(steps * accum for steps, accum in passlog.fold_steps)
    evals = sum(passlog.fold_passes)
    want = {name: layers * (micro + evals), bwd: layers * micro}
    log(on_card(
        "fold-parallel CLI: %d folds, %d epochs in %.1f s; launches forward "
        "%d (expected %d = %d layers x (%d fold-stacked micro-batches + %d "
        "eval batches)), backward %d (expected %d); by route %s"
        % (n_folds, len(passlog.fold_steps), wall, counts[name], want[name],
           layers, micro, evals, counts[bwd], want[bwd], by_route)))
    if not (n_folds >= 2 and len(passlog.fold_steps) == FOLD_CLI_EPOCHS
            and all(counts[k] == want.get(k, 0) for k in counts)):
        fail("fold-parallel: %d folds, epochs %s, launch counts %s, "
             "expected %s" % (n_folds, passlog.fold_steps, counts, want))
    for i, m in enumerate(results["val_metrics"]):
        base = "cv_fold_%d" % i
        files = ["%s.ckpt" % base, "%s_metrics.json" % base] + [
            "%s_%s_preds.csv" % (base, ds) for ds in (
                "dev_%02d" % i, "dev_seen_%02d" % i, "test_seen",
                "test_unseen", "dev_unseen")]
        missing = [f for f in files
                   if not os.path.isfile(os.path.join(run_dir, f))]
        if missing or not math.isfinite(m["aucroc"]):
            fail("fold-parallel fold %d: missing %s, metrics %s"
                 % (i, missing, m))
        for f in files[2:]:
            probs = [float(r[1]) for r in _read_csv(os.path.join(run_dir, f))]
            if not probs or not all(0.0 <= p <= 1.0 for p in probs):
                fail("fold-parallel: bad predictions in " + f)
        with open(os.path.join(run_dir, files[1])) as f:
            if set(json.load(f)) != {"dev", "test"}:
                fail("fold-parallel: metrics JSON of fold %d" % i)
    ran = E.DEVICE_EA_RUNS["count"] - ea_runs
    ens = [f for f in os.listdir(run_dir) if f.endswith("_ensemble.csv")]
    if results.get("ensemble") is None or ran != 1 or len(ens) != 4:
        fail("fold-parallel: ensemble %s, device EA runs %d, CSVs %s"
             % (results.get("ensemble"), ran, ens))
    seq_secs = sum(s for _, s in seq_epochs)
    for e, (n, secs) in enumerate(passlog.epochs, 1):
        log(on_card(
            "fold-parallel epoch %d: %d memes over %d folds in %.4f s = "
            "%.1f memes/s (phase 6, folds one after another: %d memes in "
            "%.4f s = %.1f memes/s)"
            % (e, n, n_folds, secs, n / secs,
               sum(m for m, _ in seq_epochs), seq_secs,
               sum(m for m, _ in seq_epochs) / seq_secs)))
    log(on_card("fold-parallel: %d fold checkpoints, %d CSVs + metrics JSON "
                "a fold, 4 ensemble CSVs (device EA runs %d); dev AUROC %s; "
                "resume file written after each epoch: %s"
                % (n_folds, 5, ran, ["%.4f" % m["aucroc"]
                                     for m in results["val_metrics"]],
                   ", ".join("%.3f GB in %.3f s" % (gb, secs)
                             for gb, secs in passlog.fold_saves))))
    return {(name, dtype): counts[name], (bwd, dtype): counts[bwd]}


def _fold_batches(torch, ds, folds: int, accum: int, start: int = 0):
    """[folds, accum, 16, ...] model inputs, labels and sample masks on the
    card: fold f's micro-batch a is rows start + 16·(accum·f + a) of ``ds``,
    wrapping around."""
    import numpy as np

    from meme_challenge_tpu_torch.train.steps import (
        MODEL_INPUT_KEYS,
        TRAIN_KEYS,
        to_device,
    )

    groups = []
    for f in range(folds):
        micro = []
        for a in range(accum):
            first = start + 16 * (accum * f + a)
            b = ds.batch([(first + i) % len(ds) for i in range(16)])
            b["sample_mask"] = np.ones(16, np.int32)
            b.pop("ids")
            micro.append(b)
        groups.append({k: np.stack([m[k] for m in micro]) for k in micro[0]})
    host = {k: np.stack([g[k] for g in groups]) for k in groups[0]}
    return to_device(host, "cuda", keys=MODEL_INPUT_KEYS + TRAIN_KEYS)


def _train_dataset(synth: dict):
    from meme_challenge_tpu_torch.data.meme_dataset import MemeDataset
    from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer

    return MemeDataset(synth["train"], feature_dir=synth["feature_dir"],
                       tokenizer=BertTokenizer(synth["vocab"]),
                       max_txt_len=60, max_bb=100, img_dim=2048)


def fold_grad_check(torch, synth: dict) -> None:
    """Phase 9c: one full-width fold-stacked micro-batch of FOLDS x 16
    (fp32, dropout 0.1 / 0.1, each fold its own generator) against the
    FOLDS per-fold MemeUniters on the card given the same generators: each
    fold's loss and every gradient within GRAD_TOL of the gradient's
    largest magnitude (a gradient zero up to rounding, the key bias's,
    against a thousandth of the fold's largest)."""
    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.core.seeding import torch_generator
    from meme_challenge_tpu_torch.models.uniter import (
        FoldStack,
        init_meme_uniter,
    )
    from meme_challenge_tpu_torch.train.losses import bce_logits_loss

    batch = {k: v[:, 0] for k, v in _fold_batches(
        torch, _train_dataset(synth), FOLDS, 1).items()}
    cfg = UniterConfig(use_pallas_attention=True)
    models = [init_meme_uniter(cfg, 1, "cuda", torch_generator(20 + f,
                                                               "cuda"))
              for f in range(FOLDS)]
    stack = FoldStack.from_models(iter(models), FOLDS)
    logits = stack(batch, deterministic=False, generators=[
        torch_generator(30 + f, "cuda") for f in range(FOLDS)])
    losses, _ = bce_logits_loss(logits, batch["labels"],
                                batch["sample_mask"], 1.8)
    losses.sum().backward()
    worst, worst_name, loss_rel = 0.0, "", 0.0
    for f, model in enumerate(models):
        b = {k: v[f] for k, v in batch.items()}
        out = model(b, deterministic=False,
                    generator=torch_generator(30 + f, "cuda"))
        loss, _ = bce_logits_loss(out, b["labels"], b["sample_mask"], 1.8)
        loss.backward()
        loss_rel = max(loss_rel, abs(loss.item() - losses[f].item())
                       / abs(loss.item()))
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
        top = max(float(g.abs().max()) for g in grads.values())
        for n, g in grads.items():
            scale = max(float(g.abs().max()), 1e-3 * top)
            rel = float((stack.params[n].grad[f] - g).abs().max()) / scale
            if rel > worst:
                worst, worst_name = rel, "fold %d %s" % (f, n)
    torch.cuda.synchronize()
    log(on_card("fold-parallel grad: F %d x 16 memes, fp32, dropout on, "
                "fold-stacked vs per-fold MemeUniters on the card: loss "
                "relative %.3g; worst gradient %.3g of its largest magnitude "
                "(%s; tol %g)" % (FOLDS, loss_rel, worst, worst_name,
                                   GRAD_TOL)))
    if not (loss_rel <= GRAD_TOL and worst <= GRAD_TOL):
        fail("fold-stacked gradients disagree with the per-fold models'")


def _measure_step(torch, one, memes: int, tag: str, base: int,
                  setting: str = "Adam, remat dots, fp32") -> dict:
    """Wall and host-issue ms (medians of 3 after one warm-up step), the
    peak of allocated memory above ``base``, and one profiled step's
    kernel time, idle share, launches and host time by operator; returns
    the wall ms and the GiB held between steps and at the peak."""
    one()
    torch.cuda.synchronize()
    static = (torch.cuda.memory_allocated() - base) / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    issue, wall = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        one()
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    wall_ms, issue_ms = statistics.median(wall), statistics.median(issue)
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            pwall = (time.perf_counter() - t0) * 1e3
        busy, n_launch, host_rows = 0.0, 0, []
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                busy += getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0)) / 1e3
            else:
                host_rows.append((e.self_cpu_time_total / 1e3, e.count,
                                  e.key))
                if "LaunchKernel" in e.key:
                    n_launch += e.count
        host_rows.sort(reverse=True)
        prof_line = ("profiled step: wall %.1f ms, kernels %.1f ms, device "
                     "idle share %.3f, %d kernel launches; host self ms by "
                     "operator: %s" % (pwall, busy, 1.0 - busy / pwall,
                                       n_launch, "; ".join(
                                           "%s %.1f x%d" % (k[:32], t, c)
                                           for t, c, k in host_rows[:6])))
    except Exception as e:  # informational: a missing trace fails nothing
        prof_line = "profiler unavailable (%s)" % e
    log(on_card(
        "%s (%d memes, %s): wall %.1f ms, host issue "
        "%.1f ms, %.1f memes/s; %s; memory: weights + moments %.2f GiB "
        "between steps, peak %.2f GiB of %.1f"
        % (tag, memes, setting, wall_ms, issue_ms, memes / wall_ms * 1e3,
           prof_line,
           static, peak,
           torch.cuda.get_device_properties(0).total_memory / 2 ** 30)))
    return {"wall_ms": wall_ms, "static_gib": static, "peak_gib": peak}


def fold_step_phase(torch, synth: dict) -> None:
    """Phase 9d: one optimizer step (accumulation 2 x batch 16 a fold, Adam
    with bf16 moments, global-norm clipping, dropout on, remat "dots",
    fp32) of the sequential path (one MemeUniter, make_train_step) and of
    the fold-stacked path at F 1, 3 and 15: wall and host-issue ms,
    launches, the device's idle share and host time by operator from
    torch.profiler, memes/s and the peak of allocated memory (weights,
    gradients, moments and activations)."""
    from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
    from meme_challenge_tpu_torch.core.seeding import (
        dropout_generator,
        fold_dropout_generators,
        torch_generator,
    )
    from meme_challenge_tpu_torch.models.uniter import (
        FoldStack,
        init_meme_uniter,
    )
    from meme_challenge_tpu_torch.train.losses import make_loss_fn
    from meme_challenge_tpu_torch.train.optim import Optimizer
    from meme_challenge_tpu_torch.train.steps import (
        TrainState,
        create_train_state,
        make_fold_train_step,
        make_train_step,
    )

    ds = _train_dataset(synth)
    cfg = UniterConfig(use_pallas_attention=True, remat=True,
                       remat_policy="dots")
    c = TrainConfig()
    loss_fn = make_loss_fn("bce_logits", 1.8)

    def optimizer(folds):
        return Optimizer("adam", 3e-5, lambda step: 1.0, beta1=c.beta1,
                         beta2=c.beta2, weight_decay=c.weight_decay,
                         max_grad_norm=c.max_grad_norm,
                         mu_dtype=c.adam_mu_dtype, nu_dtype=c.adam_nu_dtype,
                         folds=folds)

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = init_meme_uniter(cfg, 1, "cuda", torch_generator(0, "cuda"))
    opt = optimizer(0)
    state = create_train_state(model, opt)
    step = make_train_step(model, loss_fn, opt, accum_steps=TRAIN_ACCUM)
    batch = {k: v[0] for k, v in _fold_batches(torch, ds, 1,
                                               TRAIN_ACCUM).items()}
    _measure_step(torch, lambda: step(state, batch, dropout_generator(
        43, state.step, "cuda")), TRAIN_ACCUM * 16,
        "sequential step (one MemeUniter)", base)
    del model, opt, state, step, batch
    for folds in (1, 3, 15):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        stack = FoldStack.from_models(
            (init_meme_uniter(cfg, 1, "cuda", torch_generator(f, "cuda"))
             for f in range(folds)), folds)
        opt = optimizer(folds)
        state = TrainState(stack, opt.init(stack.params))
        step = make_fold_train_step(stack, loss_fn, opt,
                                    accum_steps=TRAIN_ACCUM)
        batch = _fold_batches(torch, ds, folds, TRAIN_ACCUM)
        _measure_step(torch, lambda: step(
            state, batch, fold_dropout_generators(43, folds, state.step,
                                                  "cuda")),
            folds * TRAIN_ACCUM * 16, "fold-parallel step F %d" % folds, base)
        del stack, opt, state, step, batch


# ------------------------------------------------------------ pretraining

PRETRAIN_TASKS = ("mlm", "itm", "mrfr", "mrc", "mrc-kl")
PRETRAIN_OT = 0.1
# the CLI runs of phase 10b: (kernel, dtype, pallas_blocked, extra flags)
PRETRAIN_RUNS = (
    ("fused_attention", "float32", False, []),
    ("fused_attention_blocked", "bfloat16", True,
     ["--compute_bf16", "--device_resident_data", "--fuse_accum"]))


def _pretrain_corpus(synth: dict):
    """The pretraining corpus of the synthetic dataset: train + dev_seen,
    128 + 40 = 168 memes, at the main path's widths."""
    from meme_challenge_tpu_torch.data.pretrain import pretrain_corpus
    from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer

    tok = BertTokenizer(synth["vocab"])
    return pretrain_corpus(synth["root"], synth["feature_dir"], tok,
                           max_txt_len=60, max_bb=100, img_dim=2048), tok


def _task_batches(ds, tok, batch_size: int, accum: int = 1) -> dict:
    """One host batch ``[accum, B, ...]`` a task from the CLI's own task
    loaders (host mode), drawn from seed 0."""
    import random

    import numpy as np

    from meme_challenge_tpu_torch.core.config import TrainConfig
    from meme_challenge_tpu_torch.train.pretrain_uniter import (
        build_task_loaders,
    )
    from meme_challenge_tpu_torch.train.steps import stack_for_accum

    random.seed(0)
    np.random.seed(0)
    loaders = build_task_loaders(
        TrainConfig(batch_size=batch_size), ds, tok,
        {t: 1 for t in PRETRAIN_TASKS}, 0.15, 0.5, 0.15)
    out = {}
    for task, loader in loaders.items():
        it = iter(loader)
        out[task] = stack_for_accum([next(it) for _ in range(accum)])
    return out


def _count_launches(torch, fn) -> int:
    """Kernel launches of one call of ``fn`` (torch.profiler); -1 where the
    profiler gives no trace."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if "LaunchKernel" in e.key)
    except Exception as e:  # informational: a missing trace fails nothing
        log("profiler unavailable (%s)" % e)
        return -1


def pretrain_heads_check(torch, synth: dict, A) -> None:
    """Phase 10a: UniterForPretraining at full width from seed 5, fp32,
    dropout off, the per-sample kernel: one micro-batch of 4 a task (ITM
    with OT 0.1) on the card against the CPU (plain versions): the reduced
    loss within GRAD_TOL relative, every gradient within GRAD_TOL of its
    largest magnitude (floored at a thousandth of the model's largest, as
    grad_check), and 12 forward + 12 backward launches a micro-batch on
    ``mma_tf32x3``. Then IPOT alone at [16, 60, 100] with padding, card
    against CPU, its device ms and launches."""
    import numpy as np

    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.core.seeding import torch_generator
    from meme_challenge_tpu_torch.models.ot import optimal_transport_dist
    from meme_challenge_tpu_torch.train.pretrain_driver import _task_loss
    from meme_challenge_tpu_torch.train.pretrain_init import (
        init_pretrain_model,
    )
    from meme_challenge_tpu_torch.train.steps import to_device

    ds, tok = _pretrain_corpus(synth)
    batches = _task_batches(ds, tok, 4)
    cfg = UniterConfig(use_pallas_attention=True, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    layers = cfg.num_hidden_layers
    cpu = init_pretrain_model(cfg, 1601, "cpu", torch_generator(5, "cpu"))
    card = init_pretrain_model(cfg, 1601, "cuda", torch_generator(5, "cuda"))
    card.load_state_dict(cpu.state_dict())
    log("pretrain heads: UniterForPretraining (%.1f M parameters), corpus "
        "%d memes" % (sum(p.numel() for p in cpu.parameters()) / 1e6,
                      len(ds)))
    for task in PRETRAIN_TASKS:
        host = {k: v[0] for k, v in batches[task].items()}
        out = {}
        for device, model in (("cuda", card), ("cpu", cpu)):
            reset_launches(A)
            loss = _task_loss(model, to_device(host, device, keys=host),
                              task, None, PRETRAIN_OT)
            loss.backward()
            out[device] = (loss.item(), {
                n: p.grad.float().cpu() for n, p in model.named_parameters()
                if p.grad is not None})
            model.zero_grad(set_to_none=True)
            if device == "cuda":
                torch.cuda.synchronize()
                by_route = check_route_counts(
                    A, "pretrain heads " + task, "float32",
                    ("fused_attention", "fused_attention_bwd"))
                n_fwd = A.LAUNCHES["fused_attention"]
                n_bwd = A.LAUNCHES["fused_attention_bwd"]
                if n_fwd != layers or n_bwd != layers:
                    fail("pretrain heads %s: %d forward and %d backward "
                         "launches, expected %d each" % (task, n_fwd, n_bwd,
                                                        layers))
        (l_card, g_card), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
        if set(g_card) != set(g_cpu):
            fail("pretrain heads %s: gradients reach other parameters" % task)
        top = max(float(g.abs().max()) for g in g_cpu.values())
        worst, worst_name = 0.0, ""
        for n, g in g_cpu.items():
            scale = max(float(g.abs().max()), 1e-3 * top)
            rel = float((g_card[n] - g).abs().max()) / scale
            if rel > worst:
                worst, worst_name = rel, n
        loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
        log(on_card(
            "pretrain heads %s: micro-batch of 4, fp32, card vs CPU: loss "
            "%.6f vs %.6f (relative %.3g); %d gradients, worst %.3g of the "
            "largest magnitude (%s; tol %g); launches %d + %d by route %s"
            % (task, l_card, l_cpu, loss_rel, len(g_cpu), worst, worst_name,
               GRAD_TOL, n_fwd, n_bwd, by_route)))
        if not (loss_rel <= GRAD_TOL and worst <= GRAD_TOL
                and math.isfinite(l_card)):
            fail("pretrain heads %s: the card disagrees with the CPU" % task)
    del cpu, card

    # IPOT alone at the main path's [B 16, 60 text, 100 regions]
    rng = np.random.RandomState(0)
    txt = rng.randn(16, 60, 768).astype(np.float32)
    img = rng.randn(16, 100, 768).astype(np.float32)
    txt_pad = np.arange(60)[None] >= rng.randint(8, 61, 16)[:, None]
    img_pad = np.arange(100)[None] >= rng.randint(10, 101, 16)[:, None]
    dist = {}
    for device in ("cuda", "cpu"):
        args = [torch.from_numpy(a).to(device)
                for a in (txt, img, txt_pad, img_pad)]
        dist[device] = optimal_transport_dist(*args).cpu()
    rel = float(((dist["cuda"] - dist["cpu"]).abs()
                 / dist["cpu"].abs()).max())
    args = [torch.from_numpy(a).cuda() for a in (txt, img, txt_pad, img_pad)]
    ms, host_ms = device_ms(lambda: optimal_transport_dist(*args), iters=5)
    launches = _count_launches(torch, lambda: optimal_transport_dist(*args))
    log(on_card(
        "pretrain IPOT [16, 60, 100] with padding, 50 iterations: card vs "
        "CPU distance, worst relative %.3g (tol %g); device %.3f ms, host "
        "issue %.3f ms, %d kernel launches a call"
        % (rel, GRAD_TOL, ms, host_ms, launches)))
    if not (rel <= GRAD_TOL and bool(torch.isfinite(dist["cuda"]).all())):
        fail("pretrain IPOT: the card disagrees with the CPU")


def _pretrain_argv(synth: dict, run_dir: str, cfg_path: str) -> list:
    return ["--data_path", synth["root"],
            "--feature_path", synth["feature_dir"],
            "--vocab_file", synth["vocab"], "--model_path", run_dir,
            "--model_save_name", "pretrain.ckpt", "--uniter_config", cfg_path,
            "--tasks", "mlm:2,itm,mrfr,mrc-kl",
            "--ot_weight", str(PRETRAIN_OT), "--batch_size", "16",
            "--gradient_accumulation", str(TRAIN_ACCUM), "--max_epoch", "2",
            "--seed", "42"]


def pretrain_cli_phase(torch, work: str, synth: dict, passlog, A) -> tuple:
    """Phase 10b: ``pretrain_uniter`` at full width (uniter-base, dropout
    0.1 / 0.1), tasks mlm:2,itm,mrfr,mrc-kl, OT 0.1, 16 x 2, 2 epochs: the
    per-sample kernel in fp32, then the pair-blocked kernel with
    --compute_bf16 --device_resident_data --fuse_accum. Checks finite losses
    for every task stepped, the dump and resume file, and 12 forward + 12
    backward launches a micro-batch (a fused group: one), all on the main
    path's body; prints train memes/s by task. Returns the launches of each
    (kernel, dtype) and the fp32 run's directory."""
    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.train import pretrain_uniter

    ds, _ = _pretrain_corpus(synth)
    layers = UniterConfig().num_hidden_layers
    steps = 2 * _ceil(len(ds), 16 * TRAIN_ACCUM)
    launches, fp32_dir = {}, None
    for name, dtype, blocked, flags in PRETRAIN_RUNS:
        tag = "%s %s%s" % (name, dtype, " " + " ".join(flags) if flags
                           else "")
        run_dir = os.path.join(work, "pretrain_%s_%s" % (name, dtype))
        os.makedirs(run_dir)
        cfg_path = os.path.join(run_dir, "uniter.json")
        with open(cfg_path, "w") as f:
            json.dump(UniterConfig(use_pallas_attention=True,
                                   pallas_blocked=blocked).to_dict(), f)
        passlog.clear()
        reset_launches(A)
        mark = adam_mark()
        t0 = time.time()
        losses = pretrain_uniter.main(_pretrain_argv(synth, run_dir,
                                                     cfg_path) + flags)
        torch.cuda.synchronize()
        wall = time.time() - t0
        check_adam_launches("pretrain " + tag, mark, steps)
        bwd = name + "_bwd"
        by_route = check_route_counts(A, "pretrain " + tag, dtype,
                                      (name, bwd))
        counts = dict(A.LAUNCHES)
        launches[(name, dtype)], launches[(bwd, dtype)] = (counts[name],
                                                           counts[bwd])
        count_gemm_launches("pretrain " + tag, dtype)
        micro = steps * (1 if "--fuse_accum" in flags else TRAIN_ACCUM)
        want = {name: layers * micro, bwd: layers * micro}
        rates = passlog.pretrain_rates[-1] if passlog.pretrain_rates else {}
        log(on_card(
            "pretrain %s: CLI %.1f s, %d steps; launches forward %d, "
            "backward %d (expected %d each = %d layers x %d forwards); by "
            "route %s; final-epoch losses %s; train memes/s by task %s; "
            "resume files (GB, s) %s"
            % (tag, wall, steps, counts[name], counts[bwd], want[name],
               layers, micro, by_route,
               {t: round(v, 4) for t, v in sorted(losses.items())},
               {t: round(v, 1) for t, v in sorted(rates.items())},
               passlog.pretrain_saves)))
        if any(counts[k] != want.get(k, 0) for k in counts):
            fail("pretrain %s: launch counts %s, expected %s"
                 % (tag, counts, want))
        if not losses or not all(math.isfinite(v) for v in losses.values()) \
                or set(rates) != set(losses):
            fail("pretrain %s: losses %s, rates %s" % (tag, losses, rates))
        for f in ("pretrain.ckpt", "pretrain.ckpt.resume.pt",
                  os.path.join("log", "hps.json")):
            if not os.path.isfile(os.path.join(run_dir, f)):
                fail("pretrain %s: missing %s" % (tag, f))
        if fp32_dir is None:
            fp32_dir = run_dir
    return launches, fp32_dir


def pretrain_resume_phase(torch, work: str, synth: dict,
                          fp32_dir: str) -> None:
    """Phase 10c: the fp32 command of 10b in a process of its own, killed
    (SIGKILL) as soon as its first resume file (epoch 1 of 2) is on disk,
    then a fresh process with the same command: it must resume at step 6
    and end with the uninterrupted 10b run's weights (max abs difference
    at most RESUME_TOL). The first process runs the full 2-epoch command
    because the LR schedule spans steps_per_epoch x max_epoch: a 1-epoch
    command would train another schedule."""
    import signal

    from meme_challenge_tpu_torch.models.convert import load_torch_state_dict

    run_dir = os.path.join(work, "pretrain_resume")
    os.makedirs(run_dir)
    cfg_path = os.path.join(fp32_dir, "uniter.json")
    argv = ([sys.executable, "-m",
             "meme_challenge_tpu_torch.train.pretrain_uniter"]
            + _pretrain_argv(synth, run_dir, cfg_path))
    env = dict(os.environ, PYTHONPATH=ROOT)
    resume = os.path.join(run_dir, "pretrain.ckpt.resume.pt")
    logs = []
    for i in range(2):
        with open(os.path.join(run_dir, "process_%d.log" % i), "w") as out:
            t0 = time.time()
            proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=out,
                                    stderr=subprocess.STDOUT)
            try:
                if i == 0:
                    while proc.poll() is None and not os.path.isfile(resume):
                        time.sleep(0.02)
                    proc.send_signal(signal.SIGKILL)
                proc.wait(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            wall = time.time() - t0
        with open(out.name) as f:
            text = f.read()
        logs.append(text)
        saves = re.findall(r"pretrain resume file \S+: ([\d.]+) GB written "
                           r"in ([\d.]+) s", text)
        log(on_card("pretrain resume: process %d %s after %.1f s (exit %s); "
                    "resume files written (GB, s): %s"
                    % (i, "killed" if i == 0 else "ended", wall,
                       proc.returncode, saves)))
        if i == 1 and proc.returncode != 0:
            fail("pretrain resume: the fresh process failed:\n" + text[-3000:])
    if "resuming pretraining from" not in logs[1] or "at step 6" not in \
            logs[1]:
        fail("pretrain resume: the fresh process did not resume at step 6:\n"
             + logs[1][-3000:])
    got = load_torch_state_dict(os.path.join(run_dir, "pretrain.ckpt"))
    want = load_torch_state_dict(os.path.join(fp32_dir, "pretrain.ckpt"))
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    log(on_card("pretrain resume: killed after epoch 1 and resumed in a "
                "fresh process vs the uninterrupted run: %d tensors, max abs "
                "difference %.3g (tol %g)" % (len(want), worst, RESUME_TOL)))
    if set(got) != set(want) or worst > RESUME_TOL:
        fail("pretrain resume: the resumed weights differ")


RESUME_TOL = 1e-6


def pretrain_handoff_phase(torch, work: str, synth: dict, passlog, A,
                           fp32_dir: str) -> dict:
    """Phase 10d: the port's fine-tune CLI (--num_folds 0, 1 epoch, fp32,
    per-sample kernel) from the 10b fp32 pretraining dump: it must load it
    in "pretrain" mode and end with a finite AUROC. Returns its launches."""
    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.train import train_uniter

    run_dir = os.path.join(work, "pretrain_handoff")
    os.makedirs(run_dir)
    argv = ["--data_path", synth["root"],
            "--feature_path", synth["feature_dir"],
            "--vocab_file", synth["vocab"], "--model_path", run_dir,
            "--model_save_name", "finetune.ckpt",
            "--uniter_config", os.path.join(fp32_dir, "uniter.json"),
            "--max_epoch", "1", "--num_folds", "0", "--batch_size", "16",
            "--gradient_accumulation", str(TRAIN_ACCUM),
            "--confounder_repeat", "3", "--pos_wt", "1.8", "--lr", "3e-5",
            "--warmup_steps", "2",
            "--pretrained_model_file", os.path.join(fp32_dir,
                                                    "pretrain.ckpt")]
    passlog.clear()
    reset_launches(A)
    mark = adam_mark()
    t0 = time.time()
    train_uniter.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    check_route_counts(A, "pretrain handoff", "float32",
                       ("fused_attention", "fused_attention_bwd"))
    count_gemm_launches("pretrain handoff", "float32")
    check_adam_launches("pretrain handoff", mark, sum(
        _ceil(_ceil(n, 16), TRAIN_ACCUM) for n, _ in passlog.epochs),
        uniter_leaves(UniterConfig.from_json_file(
            os.path.join(fp32_dir, "uniter.json"))))
    metrics = check_outputs(run_dir, "finetune.ckpt", synth)
    auc = metrics["dev"]["aucroc"]
    log(on_card("pretrain handoff: fine-tune from the pretraining dump, CLI "
                "%.1f s; load modes %s; dev AUROC %.4f; launches %d + %d"
                % (wall, passlog.loads, auc, A.LAUNCHES["fused_attention"],
                   A.LAUNCHES["fused_attention_bwd"])))
    if passlog.loads != ["pretrain"] or not math.isfinite(auc):
        fail("pretrain handoff: load modes %s, AUROC %s"
             % (passlog.loads, auc))
    return {("fused_attention", "float32"): A.LAUNCHES["fused_attention"],
            ("fused_attention_bwd", "float32"):
                A.LAUNCHES["fused_attention_bwd"]}


def pretrain_step_phase(torch, synth: dict) -> None:
    """Phase 10e: one optimizer step a task (16 x 2, Adam with bf16
    moments, clipping, dropout on, fp32, per-sample kernel, ITM with OT
    0.1) through ``PretrainTrainer.step``: wall and host-issue ms, kernel
    ms, idle share, launches, memes/s and peak memory (``_measure_step``)."""
    from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
    from meme_challenge_tpu_torch.core.seeding import (
        dropout_generator,
        torch_generator,
    )
    from meme_challenge_tpu_torch.train.pretrain_driver import (
        PretrainTrainer,
    )
    from meme_challenge_tpu_torch.train.pretrain_init import (
        init_pretrain_model,
    )
    from meme_challenge_tpu_torch.train.steps import to_device

    ds, tok = _pretrain_corpus(synth)
    batches = _task_batches(ds, tok, 16, TRAIN_ACCUM)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = init_pretrain_model(UniterConfig(use_pallas_attention=True), 1601,
                                "cuda", torch_generator(0, "cuda"))
    trainer = PretrainTrainer(
        TrainConfig(lr=3e-5, gradient_accumulation=TRAIN_ACCUM,
                    batch_size=16), model, None, steps_per_epoch=100,
        ot_weight=PRETRAIN_OT)
    for task in PRETRAIN_TASKS:
        batch = to_device(batches[task], "cuda", keys=batches[task])
        _measure_step(
            torch, lambda: trainer.step(task, batch, dropout_generator(
                42, trainer.state.step, "cuda")), 16 * TRAIN_ACCUM,
            "pretrain step %s" % task, base,
            "Adam, fp32, OT %g" % PRETRAIN_OT if task == "itm"
            else "Adam, fp32")
    del model, trainer


# ----------------------------------------------------- text-only and Oscar

TEXT_MODELS = ("bert", "bert_large", "roberta", "roberta_large",
               "roberta_mnli", "albert", "albert_large", "electra")
TEXT_BATCH = 32  # the text CLIs' batch (PURE_TEXT_DEFAULTS)
# the card-vs-CPU batch of phase 11a: the CPU runs every full-width entry
PARITY_BATCH = 2


def _text_dataset(synth: dict, split: str = "train"):
    """Text-only memes of the synthetic dataset at 60 tokens (padded)."""
    from meme_challenge_tpu_torch.data.meme_dataset import MemeDataset
    from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer

    return MemeDataset(synth[split], tokenizer=BertTokenizer(synth["vocab"]),
                       text_only=True, max_txt_len=60)


def _oscar_config_file(work: str, name: str, **fields) -> str:
    """configs/oscar-base.json (12 layers, hidden 768, img_dim 2054) with
    ``fields`` added, written under ``work``."""
    with open(os.path.join(ROOT, "configs", "oscar-base.json")) as f:
        cfg = json.load(f)
    cfg.update(fields)
    path = os.path.join(work, name)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _oscar_batch(synth: dict, n: int) -> dict:
    """n train memes with the host's 2054-d Oscar features (2048 ⊕ 6)."""
    import numpy as np

    from meme_challenge_tpu_torch.data.meme_dataset import MemeDataset
    from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer

    ds = MemeDataset(synth["train"], feature_dir=synth["feature_dir"],
                     tokenizer=BertTokenizer(synth["vocab"]), max_txt_len=60,
                     max_bb=100, img_dim=2048)
    b = ds.batch(list(range(n)))
    b["img_feat"] = np.concatenate([b["img_feat"],
                                    b["img_pos_feat"][..., :6]], axis=-1)
    del b["img_pos_feat"]
    return b


def _card_vs_cpu(torch, tag: str, card, batch: dict, loss_fn, grads: bool
                 ) -> None:
    """One model's fp32 logits (dropout off) on the card against a copy of
    it on the CPU, relative to the CPU's largest logit; with ``grads`` the
    loss and every gradient as ``grad_check`` holds them."""
    import copy

    from meme_challenge_tpu_torch.train.steps import (
        MODEL_INPUT_KEYS,
        TRAIN_KEYS,
        to_device,
    )

    cpu = copy.deepcopy(card).to("cpu")
    n_params = sum(p.numel() for p in cpu.parameters())
    out = {}
    for device, model in (("cuda", card), ("cpu", cpu)):
        b = to_device(batch, device, keys=MODEL_INPUT_KEYS + TRAIN_KEYS)
        with torch.set_grad_enabled(grads):
            logits = model(b)
            entry = [logits.detach().float().cpu()]
            if grads:
                loss, _ = loss_fn(logits, b["labels"], b["sample_mask"])
                loss.backward()
                entry += [loss.item(), {n: p.grad.float().cpu()
                                        for n, p in model.named_parameters()
                                        if p.grad is not None}]
        out[device] = entry
    lc, lg = out["cuda"][0], out["cpu"][0]
    rel = float((lc - lg).abs().max()) / float(lg.abs().max())
    line = ("%s %.1f M parameters: fp32 logits of %d memes, card vs CPU, "
            "%.3g relative (tol %g)" % (tag, n_params / 1e6, lc.shape[0],
                                        rel, LOGIT_TOL))
    ok = rel <= LOGIT_TOL and bool(torch.isfinite(lc).all())
    if grads:
        worst, where = grad_worst(out["cuda"][2], out["cpu"][2])
        loss_rel = abs(out["cuda"][1] - out["cpu"][1]) / abs(out["cpu"][1])
        line += ("; loss %.6f vs %.6f (relative %.3g), %d gradients, worst "
                 "%.3g of the largest magnitude (%s; tol %g)"
                 % (out["cuda"][1], out["cpu"][1], loss_rel,
                    len(out["cpu"][2]), worst, where, GRAD_TOL))
        ok = ok and loss_rel <= GRAD_TOL and worst <= GRAD_TOL
    log(on_card(line))
    if not ok:
        fail("%s: the card disagrees with the CPU" % tag)
    del cpu


def text_parity_phase(torch, synth: dict, A) -> None:
    """Phase 11a: every MODEL_DICT entry at its published width (random
    weights from seed 11 on the card, copied to the CPU; one head logit),
    2 memes of 60 tokens with padding, fp32 (TF32 off), dropout off: the
    card's logits against the
    CPU's within LOGIT_TOL relative, and for bert and albert the
    bce_logits loss and every gradient within GRAD_TOL (grad_check's gate);
    no fused-attention kernel launches (the text models' attention is the
    plain branch, as in JAX). Then Oscar (configs/oscar-base.json with the
    fused kernels, CE over 2 labels, 60 text + 100 boxes of 2054-d
    features): logits, loss and gradients, the card through the kernels
    (12 forward + 12 backward launches on mma_tf32x3) and the CPU through
    their plain versions."""
    import numpy as np

    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.core.seeding import torch_generator
    from meme_challenge_tpu_torch.models.oscar import init_oscar_model
    from meme_challenge_tpu_torch.models.text_models import init_text_model
    from meme_challenge_tpu_torch.train.losses import make_loss_fn

    batch = _text_dataset(synth).batch(list(range(PARITY_BATCH)))
    batch["sample_mask"] = np.ones(PARITY_BATCH, np.int32)
    reset_launches(A)
    for name in TEXT_MODELS:
        card = init_text_model(name, 1, "cuda", torch_generator(11, "cuda"))
        _card_vs_cpu(torch, "text %s" % name, card, batch,
                     make_loss_fn("bce_logits", 1.0),
                     grads=name in ("bert", "albert"))
        del card
        torch.cuda.empty_cache()
    if any(A.LAUNCHES.values()):
        fail("text models launched fused-attention kernels: %s"
             % dict(A.LAUNCHES))
    cfg = UniterConfig.from_json_file(os.path.join(
        ROOT, "configs", "oscar-base.json")).replace(
            use_pallas_attention=True, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
    batch = _oscar_batch(synth, PARITY_BATCH)
    batch["sample_mask"] = np.ones(PARITY_BATCH, np.int32)
    card = init_oscar_model(cfg, 2, "cuda", torch_generator(11, "cuda"))
    reset_launches(A)
    _card_vs_cpu(torch, "oscar, kernels on the card, plain versions on "
                 "the CPU,", card, batch, make_loss_fn("ce"), grads=True)
    by_route = check_route_counts(A, "oscar 11a", "float32",
                                  ("fused_attention", "fused_attention_bwd"))
    want = cfg.num_hidden_layers
    if (A.LAUNCHES["fused_attention"], A.LAUNCHES["fused_attention_bwd"]) \
            != (want, want):
        fail("oscar 11a: launches %s, expected %d forward + %d backward"
             % (dict(A.LAUNCHES), want, want))
    log("oscar 11a: launches by route %s" % by_route)
    del card


def text_step_phase(torch, synth: dict, A) -> None:
    """Phase 11b: one optimizer step of each MODEL_DICT entry at its
    published width, batch 32 of 60 tokens (the text CLIs' batch), AdamW
    with bf16 moments (the text CLIs' optimizer, TrainConfig's moments),
    fp32, dropout as the entry has it: wall and host-issue ms, kernel ms,
    idle share, launches, memes/s and peak memory (``_measure_step``); no
    fused-attention launches."""
    import numpy as np

    from meme_challenge_tpu_torch.core.config import TrainConfig
    from meme_challenge_tpu_torch.core.seeding import (
        dropout_generator,
        torch_generator,
    )
    from meme_challenge_tpu_torch.models.text_models import init_text_model
    from meme_challenge_tpu_torch.train.losses import make_loss_fn
    from meme_challenge_tpu_torch.train.optim import Optimizer
    from meme_challenge_tpu_torch.train.steps import (
        MODEL_INPUT_KEYS,
        TRAIN_KEYS,
        create_train_state,
        make_train_step,
        stack_for_accum,
        to_device,
    )

    b = _text_dataset(synth).batch(list(range(TEXT_BATCH)))
    b["sample_mask"] = np.ones(TEXT_BATCH, np.int32)
    b.pop("ids")
    batch = to_device(stack_for_accum([b]), "cuda",
                      keys=MODEL_INPUT_KEYS + TRAIN_KEYS)
    c = TrainConfig()
    reset_launches(A)
    for name in TEXT_MODELS:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        model = init_text_model(name, 1, "cuda", torch_generator(0, "cuda"))
        opt = Optimizer("adamw", 5e-5, lambda step: 1.0, beta1=c.beta1,
                        beta2=c.beta2, weight_decay=c.weight_decay,
                        max_grad_norm=c.max_grad_norm,
                        mu_dtype=c.adam_mu_dtype, nu_dtype=c.adam_nu_dtype)
        state = create_train_state(model, opt)
        step = make_train_step(model, make_loss_fn("bce_logits", 1.0), opt)
        _measure_step(torch, lambda: step(state, batch, dropout_generator(
            0, state.step, "cuda")), TEXT_BATCH, "text step %s, %.1f M "
            "parameters," % (name, sum(p.numel() for p in model.parameters())
                             / 1e6), base, "AdamW, fp32")
        del model, opt, state, step
    if any(A.LAUNCHES.values()):
        fail("text steps launched fused-attention kernels: %s"
             % dict(A.LAUNCHES))


def _text_side_files(work: str, synth: dict) -> dict:
    """The hate-speech CSVs (train: the train memes' text, val: dev_seen's,
    labels none / racism / sexism in turn) and the object-text files (10
    detections a meme of every split, classes in [0, 1600) named by
    vocabulary words, confidences uniform in (0, 1)), from seed 0."""
    import csv

    import numpy as np

    rng = np.random.RandomState(0)
    out = {}
    for split, name in (("train", "train.csv"), ("dev_seen", "val.csv")):
        with open(synth[split]) as f:
            texts = [json.loads(line)["text"] for line in f if line.strip()]
        out[split] = os.path.join(work, name)
        with open(out[split], "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "text", "label"])
            for i, t in enumerate(texts):
                w.writerow([i, t, ("none", "racism", "sexism")[i % 3]])
    ids = []
    for split in ("train", "dev_seen", "dev_unseen", "test_seen",
                  "test_unseen"):
        with open(synth[split]) as f:
            ids += [json.loads(line)["id"] for line in f if line.strip()]
    out["objects"] = os.path.join(work, "objects.npz")
    np.savez(out["objects"], ids=np.array(ids),
             objects=rng.randint(0, 1600, (len(ids), 10)),
             probs=rng.rand(len(ids), 10))
    with open(synth["vocab"]) as f:
        words = [w.strip() for w in f if w.strip().isalpha()]
    out["obj2text"] = os.path.join(work, "obj2text.json")
    with open(out["obj2text"], "w") as f:
        json.dump({str(i): words[i % len(words)] for i in range(1600)}, f)
    return out


def _text_argv(synth: dict, run_dir: str, epochs: int) -> list:
    return ["--data_path", synth["root"], "--vocab_file", synth["vocab"],
            "--model_path", run_dir, "--model_save_name", "run.ckpt",
            "--max_epoch", str(epochs), "--num_folds", "0",
            "--max_txt_len", "60"]


def text_cli_phase(torch, work: str, synth: dict, passlog, A) -> dict:
    """Phase 11c: the four CLIs at full width on the synthetic dataset,
    their defaults otherwise (batch 32 for the text CLIs):
    train_pure_text bert with --num_layers_freeze 4 --lr_head 1e-4 (2
    epochs; layers 0-3 of the best checkpoint bit-equal to the initial
    weights, the head moved), train_pure_text albert --compute_bf16
    --device_resident_data, train_hatespeech bert (3 classes),
    train_object_text bert with a threshold range and swaps (1 epoch each):
    zero fused-attention launches; then train_oscar (configs/oscar-base.json
    + the fused kernels, 16 × 2, confounder repeat 3) fp32 per-sample for 2
    epochs and bf16 pair-blocked with --device_resident_data for 1: launch
    counts exact (12 a layer stack, forward per micro-batch and eval batch,
    backward per micro-batch), on the dtype's tensor-core body. Every run:
    checkpoint, CSVs, metrics JSON, train memes/s. Returns the Oscar runs'
    launches by (kernel, dtype)."""
    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.core.seeding import torch_generator
    from meme_challenge_tpu_torch.models.text_models import init_text_model
    from meme_challenge_tpu_torch.train import (
        train_hatespeech,
        train_object_text,
        train_oscar,
        train_pure_text,
    )

    side = _text_side_files(work, synth)

    def run(tag, cli, argv):
        run_dir = argv[argv.index("--model_path") + 1]
        os.makedirs(run_dir)
        passlog.clear()
        reset_launches(A)
        mark = adam_mark()
        t0 = time.time()
        cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = dict(A.LAUNCHES)
        check_adam_launches(tag, mark)
        count_gemm_launches(tag)
        log(on_card("%s: CLI %.1f s; train %s memes/s by epoch; fused-"
                    "attention launches %s" % (
                        tag, wall, ["%.1f" % (n / s) for n, s in
                                    passlog.epochs],
                        {k: v for k, v in counts.items() if v})))
        if not passlog.epochs:
            fail("%s: no training epoch" % tag)
        return run_dir, counts

    def text_run(tag, cli, argv, outputs=True):
        run_dir, counts = run(tag, cli, argv)
        if any(counts.values()):
            fail("%s: the text path launched fused-attention kernels %s"
                 % (tag, counts))
        if outputs:
            m = check_outputs(run_dir, "run.ckpt", synth)
            log("%s: checkpoint, 4 CSVs + metrics JSON, dev %s"
                % (tag, {k: round(v, 4) for k, v in m["dev"].items()}))
        return run_dir

    run_dir = text_run(
        "pure_text bert --num_layers_freeze 4 --lr_head 1e-4",
        train_pure_text, _text_argv(synth, os.path.join(work, "pt_bert"), 2)
        + ["--model", "bert", "--num_layers_freeze", "4", "--lr_head",
           "1e-4", "--seed", "5"])
    init = init_text_model("bert", 1, "cuda", torch_generator(5, "cuda"))
    best = torch.load(os.path.join(run_dir, "run.ckpt"), map_location="cuda",
                      weights_only=True)["model_state_dict"]
    frozen = moved = 0
    for n, p in init.named_parameters():
        layer = re.search(r"\.encoder\.layer\.(\d+)\.", n)
        if layer and int(layer.group(1)) < 4:
            if not torch.equal(best[n], p.detach()):
                fail("pure_text: frozen %s changed" % n)
            frozen += 1
        elif n.startswith("head_") and not torch.equal(best[n], p.detach()):
            moved += 1
    n_head = sum(1 for n, _ in init.named_parameters()
                 if n.startswith("head_"))
    log("pure_text bert: %d parameters of layers 0-3 bit-equal to their "
        "initial weights, %d of %d head parameters moved"
        % (frozen, moved, n_head))
    if frozen != 16 * min(4, init.backbone.config.num_hidden_layers) \
            or moved != n_head:
        fail("pure_text: freezing or the head's update went wrong")
    del init, best
    text_run("pure_text albert --compute_bf16 --device_resident_data",
             train_pure_text,
             _text_argv(synth, os.path.join(work, "pt_albert"), 1)
             + ["--model", "albert", "--compute_bf16",
                "--device_resident_data"])
    run_dir = text_run(
        "hatespeech bert (3 classes)", train_hatespeech,
        ["--vocab_file", synth["vocab"], "--train_csv", side["train"],
         "--val_csv", side["dev_seen"], "--model_path",
         os.path.join(work, "hs_bert"), "--model_save_name", "run.ckpt",
         "--max_epoch", "1", "--max_txt_len", "60", "--model", "bert"],
        outputs=False)
    csv_path = os.path.join(run_dir, "run_val_preds.csv")
    with open(os.path.join(run_dir, "run_metrics.json")) as f:
        metrics = json.load(f)
    if not (os.path.isfile(os.path.join(run_dir, "run.ckpt"))
            and os.path.isfile(csv_path) and set(metrics) == {"dev", "train"}
            and "accuracy" in metrics["dev"]):
        fail("hatespeech: missing checkpoint, CSV or metrics (%s)"
             % sorted(metrics))
    log("hatespeech bert: checkpoint, val CSV (%d rows) + metrics JSON, dev "
        "accuracy %.4f" % (len(_read_csv(csv_path)),
                           metrics["dev"]["accuracy"]))
    text_run("object_text bert --obj_threshold 0.3-0.7 --obj_swap_prob 0.1",
             train_object_text,
             _text_argv(synth, os.path.join(work, "ot_bert"), 1)
             + ["--model", "bert", "--object_file", side["objects"],
                "--object_to_text_file", side["obj2text"],
                "--obj_threshold_min", "0.3", "--obj_threshold_max", "0.7",
                "--obj_swap_prob", "0.1"])

    layers = UniterConfig.from_json_file(os.path.join(
        ROOT, "configs", "oscar-base.json")).num_hidden_layers
    batch_size, launches = 16, {}
    for name, dtype, epochs, extra in (
            ("fused_attention", "float32", 2, {}),
            ("fused_attention_blocked", "bfloat16", 1,
             {"dtype": "bfloat16", "pallas_blocked": True})):
        tag = "oscar %s %s" % (name, dtype)
        run_dir = os.path.join(work, "oscar_%s_%s" % (name, dtype))
        argv = ["--data_path", synth["root"],
                "--feature_path", synth["feature_dir"],
                "--vocab_file", synth["vocab"], "--model_path", run_dir,
                "--model_save_name", "run.ckpt", "--oscar_config",
                _oscar_config_file(work, "oscar_%s.json" % dtype,
                                   use_pallas_attention=True, **extra),
                "--max_epoch", str(epochs), "--num_folds", "0",
                "--batch_size", str(batch_size),
                "--gradient_accumulation", str(TRAIN_ACCUM),
                "--confounder_repeat", "3", "--warmup_steps", "2",
                "--lr", "3e-5"]
        if dtype == "bfloat16":
            argv.append("--device_resident_data")
            tag += " --device_resident_data"
        _, counts = run(tag, train_oscar, argv)
        bwd = name + "_bwd"
        by_route = check_route_counts(A, tag, dtype, (name, bwd))
        groups = sum(_ceil(_ceil(n, batch_size), TRAIN_ACCUM)
                     for n, _ in passlog.epochs)
        train_fwd = groups * TRAIN_ACCUM
        eval_batches = sum(_ceil(n, batch_size) for n, _ in passlog.passes)
        want = {name: layers * (train_fwd + eval_batches),
                bwd: layers * train_fwd}
        log(on_card("%s: launches forward %d (expected %d = %d layers x (%d "
                    "train + %d eval forwards)), backward %d (expected %d); "
                    "by route %s" % (tag, counts[name], want[name], layers,
                                     train_fwd, eval_batches, counts[bwd],
                                     want[bwd], by_route)))
        if len(passlog.epochs) != epochs or any(
                counts[k] != want.get(k, 0) for k in counts):
            fail("%s: launch counts %s, expected %s, epochs %s"
                 % (tag, counts, want, passlog.epochs))
        m = check_outputs(run_dir, "run.ckpt", synth)
        log("%s: checkpoint, 4 CSVs + metrics JSON, dev accuracy %.4f"
            % (tag, m["dev"]["accuracy"]))
        launches[(name, dtype)], launches[(bwd, dtype)] = (counts[name],
                                                           counts[bwd])
    return launches


# ------------------------------------------------------------ 12. extraction

DET_SEED = 9
DET_TOL = 1e-4      # card vs CPU, of each tensor's largest magnitude
DET_LOWP_TOL = 2e-2  # bf16 / uint8 blobs against fp32 (tests/test_detector.py)
# The random stack's outputs are in the hundreds: unscaled, the RPN's
# scores saturate and every anchor decodes to the whole image (one proposal
# after NMS). These factors (the CPU tests' own) spread the scores and keep
# the box deltas small; the class scores stay peaked, so the card and the
# CPU take the same argmax into the attribute head. The benchmark's
# detector configuration scales its weights by the same factors
# (portbench/configs/bua-caffe-r101.json: decision_scale).
DET_SCALE = {"proposal_generator.rpn_head.objectness_logits.weight": 0.02,
             "proposal_generator.rpn_head.anchor_deltas.weight": 0.001,
             "roi_heads.box_predictor.bbox_pred.weight": 0.001,
             "roi_heads.box_predictor.cls_score.weight": 0.02,
             "roi_heads.box_predictor.attr_linear2.weight": 0.02}


def detector_setup(torch):
    """``DetectorConfig()`` (Caffe ResNet-101, 1601 classes, 401
    attributes, 600 / 1000) with random weights from DET_SEED, the decision
    layers rescaled; 8 synthetic 600 × 800 images as bench.py makes them and
    one of 480 × 1000 (the long side's cap)."""
    import numpy as np

    from meme_challenge_tpu_torch.extract.detector import (
        DetectorConfig,
        init_detector,
    )

    cfg = DetectorConfig()
    state = init_detector(cfg, torch.Generator().manual_seed(DET_SEED)
                          ).state_dict()
    for key, factor in DET_SCALE.items():
        state[key] = state[key] * factor
    rng = np.random.RandomState(DET_SEED)
    images = [(rng.rand(600, 800, 3) * 255).astype(np.uint8)
              for _ in range(8)]
    images.append((rng.rand(480, 1000, 3) * 255).astype(np.uint8))
    log("extraction: BUADetector %.1f M parameters (depth %d, %d classes, "
        "%d attributes), %d images" % (
            sum(v.numel() for v in state.values()) / 1e6, cfg.depth,
            cfg.num_classes, cfg.num_attributes, len(images)))
    return cfg, state, images


def _det_rel(got, want) -> float:
    return float((got.float().cpu() - want.float().cpu()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def extract_check_phase(torch, cfg, state, images) -> None:
    """Phase 12a: card vs CPU, module by module, fp32 with TF32 off, on one
    600 × 800 image: the res4 map, the RPN logits and deltas; the ROI head
    on the same 32 proposals from the same map (features, cls_prob,
    bbox_deltas, attr_prob), each within DET_TOL of its largest magnitude;
    the ROIPool of all proposals on the same map tensor bit-equal on the
    card, on the CPU and in native.roi_pool, with its largest intermediate
    (at most 1 GiB); ``max_conf`` through ``device`` and ``native_batched``
    identical on the image's boxes and probabilities."""
    import numpy as np

    from meme_challenge_tpu_torch.extract import native
    from meme_challenge_tpu_torch.extract.detector import (
        FeatureExtractor,
        transfer_blob,
    )
    from meme_challenge_tpu_torch.extract.ops import (
        _levels,
        roi_bin_quantize,
        roi_pool_device,
    )
    from meme_challenge_tpu_torch.ops.nms import max_conf_device

    card = FeatureExtractor(cfg, state, device="cuda")
    cpu = FeatureExtractor(cfg, state, device="cpu")
    blob, scale, (h, w) = transfer_blob(images[0], cfg)
    x = blob.permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        got = card.model.backbone_rpn(x.cuda())
        want = cpu.model.backbone_rpn(x)
    errs = {n: _det_rel(g, wt) for n, g, wt in
            zip(("res4", "rpn logits", "rpn deltas"), got, want)}
    log(on_card("extraction 12a: blob %s, res4 %s; card vs CPU (of the "
                "largest magnitude): %s (tol %g)" % (
                    tuple(blob.shape), tuple(got[0].shape),
                    {k: float("%.3g" % v) for k, v in errs.items()},
                    DET_TOL)))
    if max(errs.values()) > DET_TOL:
        fail("extraction: backbone/RPN card vs CPU %s" % errs)
    feat = want[0]
    props = card._proposals(got[1].permute(0, 2, 3, 1).cpu().numpy(),
                            got[2].permute(0, 2, 3, 1).cpu().numpy(), h, w)
    P = cfg.pooler_resolution

    # ROIPool: the same map on both devices and in the native op
    feat_card = feat.cuda()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pooled = roi_pool_device(feat_card[0], props, 1.0 / cfg.anchor_base,
                             (P, P))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    _, _, bin_h, bin_w = roi_bin_quantize(props, 1.0 / cfg.anchor_base,
                                          (P, P))
    H, W = feat.shape[2:]
    table = (_levels(float(bin_h.max()), H) * _levels(float(bin_w.max()), W)
             * feat.shape[1] * H * W * 4)
    gather = len(props) * P * P * feat.shape[1] * 4
    pooled_cpu = roi_pool_device(feat[0], props, 1.0 / cfg.anchor_base,
                                 (P, P))
    host = native.roi_pool(feat[0].numpy(), props, 1.0 / cfg.anchor_base,
                           (P, P))
    exact = (torch.equal(pooled.cpu(), pooled_cpu)
             and np.array_equal(pooled_cpu.numpy(), host))
    pool_ms = _profiled(torch, lambda: roi_pool_device(
        feat_card[0], props, 1.0 / cfg.anchor_base, (P, P)))[0]
    log(on_card("extraction 12a: %d proposals; ROIPool %s card == CPU == "
                "native: %s; %s ms of kernels; largest intermediate: "
                "range-max table %.1f MiB, a gathered [R, %d, %d, C] %.1f MiB; peak "
                "above the map %.1f MiB (output %.1f MiB included)" % (
                    len(props), tuple(pooled.shape), exact,
                    "%.3f" % pool_ms if pool_ms is not None
                    else "not measured",
                    table / 2 ** 20, P, P, gather / 2 ** 20, peak / 2 ** 20,
                    pooled.numel() * 4 / 2 ** 20)))
    if not exact:
        fail("extraction: ROIPool differs between the card, the CPU and the "
             "native op")
    if max(table, gather, peak - pooled.numel() * 4) > 2 ** 30:
        fail("extraction: ROIPool intermediate above 1 GiB")

    # the ROI head on the same 32 proposals from the same map
    with torch.inference_mode():
        head_card = card._roi_stage(feat_card, props[:32])
        head_cpu = cpu._roi_stage(feat, props[:32])
    cls = head_cpu["cls_prob"][:, 1:].sort(dim=1).values
    margin = float((cls[:, -1] - cls[:, -2]).min())
    errs = {k: _det_rel(head_card[k], head_cpu[k]) for k in head_cpu}
    log(on_card("extraction 12a: ROI head on 32 proposals, card vs CPU: %s "
                "(tol %g); smallest top-2 class gap %.3g" % (
                    {k: float("%.3g" % v) for k, v in errs.items()}, DET_TOL,
                    margin)))
    if max(errs.values()) > DET_TOL:
        fail("extraction: ROI head card vs CPU %s" % errs)

    # max_conf: device and native_batched on the image's boxes and probs
    with torch.inference_mode():
        cls_prob = card._roi_stage(feat_card, props)["cls_prob"].cpu().numpy()
    boxes = props / scale
    t0 = time.perf_counter()
    ref = native.nms_max_conf(boxes, cls_prob, cfg.test_nms_thresh)
    native_ms = (time.perf_counter() - t0) * 1e3
    max_conf_device(boxes, cls_prob, cfg.test_nms_thresh, "cuda")
    t0 = time.perf_counter()
    dev = max_conf_device(boxes, cls_prob, cfg.test_nms_thresh, "cuda")
    dev_ms = (time.perf_counter() - t0) * 1e3
    log(on_card("extraction 12a: max_conf over %d boxes x %d classes: "
                "device == native_batched: %s; native_batched %.1f ms, "
                "device %.1f ms (host clock)" % (
                    cls_prob.shape[0], cls_prob.shape[1] - 1,
                    np.array_equal(dev, ref), native_ms, dev_ms)))
    if not np.array_equal(dev, ref):
        fail("extraction: max_conf differs between device and native")


def _write_pngs(directory: str, images) -> list:
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    stems = []
    for i, img in enumerate(images):
        stem = "%05d" % (i + 1)
        Image.fromarray(img[:, :, ::-1]).save(
            os.path.join(directory, stem + ".png"))   # BGR → RGB file
        stems.append(stem)
    return stems


def extract_cli_phase(torch, work: str, cfg, state, images, synth: dict,
                      A) -> dict:
    """Phase 12b: ``extract_features`` through its CLI on the card (PNG
    files, the weights as a torch file): mode 1, mode 2, mode 3 from mode
    2's boxes (--bbox-dir), then mode 1 again, which writes nothing; each
    npz's keys and shapes. Then the hand-off: ``convert_feature_export`` on
    mode 1's files, ``load_img_feature`` through ``MemeDataset``, and one
    full-width UNITER-base forward through the fused kernels (12 launches,
    counted in the kernels' record). Returns those launches."""
    import numpy as np

    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.core.seeding import torch_generator
    from meme_challenge_tpu_torch.data.meme_dataset import MemeDataset
    from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
    from meme_challenge_tpu_torch.extract import extract_features
    from meme_challenge_tpu_torch.models.uniter import init_meme_uniter
    from meme_challenge_tpu_torch.tools import convert_feature_export
    from meme_challenge_tpu_torch.train.steps import to_device

    root = os.path.join(work, "extraction")
    stems = _write_pngs(os.path.join(root, "img"), images)
    weights = os.path.join(root, "bua_random.pt")
    torch.save(state, weights)
    common = ["--image-dir", os.path.join(root, "img"), "--weights", weights]
    out = {m: os.path.join(root, "mode%d" % m) for m in (1, 2, 3)}

    def run(mode, extra=()):
        t0 = time.time()
        extract_features.main(common + ["--out-dir", out[mode], "--mode",
                                        str(mode), *extra])
        torch.cuda.synchronize()
        return time.time() - t0

    walls = {1: run(1), 2: run(2), 3: run(3, ("--bbox-dir", out[2]))}
    counts = {}
    for mode in (1, 2, 3):
        files = sorted(os.listdir(out[mode]))
        if files != [s + ".npz" for s in stems]:
            fail("extraction mode %d wrote %s" % (mode, files))
        n = []
        for f in files:
            z = np.load(os.path.join(out[mode], f), allow_pickle=True)
            if mode == 2:
                ok = (sorted(z.files) == ["bbox", "cls_prob"]
                      and z["bbox"].shape[0] <= cfg.max_boxes
                      and z["bbox"].shape[1:] == (4,)
                      and z["cls_prob"].shape == (z["bbox"].shape[0],
                                                  cfg.num_classes))
                n.append(z["bbox"].shape[0])
            else:
                k = int(z["num_bbox"])
                info = z["info"].item()
                ok = (sorted(z.files) == ["bbox", "image_h", "image_w",
                                          "info", "num_bbox", "x"]
                      and z["x"].shape == (k, 2048)
                      and z["bbox"].shape == (k, 4)
                      and np.isfinite(z["x"]).all()
                      and info["objects_id"].shape == (k,))
                if mode == 1:
                    ok = ok and cfg.min_boxes <= k <= cfg.max_boxes
                else:
                    gt = np.load(os.path.join(out[2], f))["bbox"]
                    ok = ok and k == gt.shape[0] and np.allclose(
                        z["bbox"], gt, rtol=1e-5, atol=1e-3)
                n.append(k)
            if not ok:
                fail("extraction mode %d: %s has keys %s and shapes %s"
                     % (mode, f, z.files,
                        {k: z[k].shape for k in z.files}))
        counts[mode] = n
    stamps = {f: os.stat(os.path.join(out[1], f)).st_mtime_ns
              for f in os.listdir(out[1])}
    wall_skip = run(1)
    if stamps != {f: os.stat(os.path.join(out[1], f)).st_mtime_ns
                  for f in os.listdir(out[1])}:
        fail("extraction: the resumed mode-1 run rewrote files")
    log(on_card("extraction 12b: CLI mode 1 %.1f s (boxes %s), mode 2 %.1f s "
                "(boxes %s), mode 3 from mode 2's boxes %.1f s (boxes %s), "
                "mode 1 again %.1f s (nothing written)" % (
                    walls[1], counts[1], walls[2], counts[2], walls[3],
                    counts[3], wall_skip)))

    # hand-off: npz → {id}.npy + {id}_info.npy → MemeDataset → UNITER-base
    conv = os.path.join(root, "npy")
    convert_feature_export.main(["--input_dir", out[1], "--output_dir",
                                 conv])
    split = os.path.join(root, "extracted.jsonl")
    with open(split, "w") as f:
        for i, stem in enumerate(stems):
            f.write(json.dumps({"id": int(stem), "label": i % 2,
                                "text": "an extracted meme %d" % i}) + "\n")
    ds = MemeDataset(split, feature_dir=conv,
                     tokenizer=BertTokenizer(synth["vocab"]),
                     max_txt_len=60, max_bb=100, img_dim=2048)
    batch = ds.batch(list(range(len(stems))))
    model = init_meme_uniter(UniterConfig(use_pallas_attention=True), 1,
                             "cuda", torch_generator(0, "cuda"))
    reset_launches(A)
    with torch.inference_mode():
        logits = model(to_device(batch, "cuda")).float().cpu()
    torch.cuda.synchronize()
    layers = UniterConfig().num_hidden_layers
    by_route = check_route_counts(A, "extraction UNITER forward", "float32",
                                  ("fused_attention",))
    count_gemm_launches("extraction UNITER forward", "float32")
    n_boxes = [int(v) for v in batch["img_mask"].sum(1)]
    log(on_card("extraction 12b: converted features of %d images (%s "
                "boxes) through load_img_feature → MemeDataset → UNITER-base "
                "fp32 forward: logits %s finite %s, launches %s" % (
                    len(stems), n_boxes, tuple(logits.shape),
                    bool(torch.isfinite(logits).all()), by_route)))
    if (tuple(logits.shape) != (len(stems), 1)
            or not torch.isfinite(logits).all()
            or A.LAUNCHES["fused_attention"] != layers
            or n_boxes != counts[1]):
        fail("extraction: the UNITER forward on the extracted features went "
             "wrong (launches %s)" % dict(A.LAUNCHES))
    del model
    return {("fused_attention", "float32"): A.LAUNCHES["fused_attention"]}


def extract_time_phase(torch, cfg, state, images) -> None:
    """Phase 12c: s/img through ``extract_batch`` (mode 1) over the 8
    600 × 800 images after 2 warm-up images, for each blob transfer dtype
    and lookahead 1 and 2 (fp32: both equal to per-image ``extract`` bit
    for bit); mode-3 features of the bf16 and uint8 blobs
    within DET_LOWP_TOL of the fp32 ones; and where one image's time goes
    (host preprocessing, backbone + RPN on the card, the host proposal
    stage, the ROI stage on the card, max_conf both ways, the device's idle
    share, launches, the top device operations, peak memory)."""
    import dataclasses

    import numpy as np

    from meme_challenge_tpu_torch.extract.detector import (
        FeatureExtractor,
        transfer_blob,
    )

    gt = None
    feats = {}
    for dt in ("float32", "bfloat16", "uint8"):
        ex = FeatureExtractor(dataclasses.replace(cfg, blob_transfer_dtype=dt),
                              state, device="cuda")
        ex.extract_batch(images[:2])
        rates, batches = {}, {}
        for lookahead in (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batches[lookahead] = ex.extract_batch(images[:8],
                                                  lookahead=lookahead)
            torch.cuda.synchronize()
            rates[lookahead] = (time.perf_counter() - t0) / 8
        if dt == "float32":
            # streaming changes nothing: per-image extract, bit for bit
            for i, img in enumerate(images[:8]):
                one = ex.extract(img)
                for lookahead, outs in batches.items():
                    if not all(np.array_equal(outs[i][k], one[k])
                               for k in ("x", "bbox", "num_bbox")):
                        fail("extraction: extract_batch (lookahead %d) "
                             "differs from extract on image %d"
                             % (lookahead, i))
            log(on_card("extraction 12c: extract_batch at lookahead 1 and "
                        "2 equals per-image extract on the 8 images, bit "
                        "for bit"))
        if gt is None:
            gt = ex.extract(images[0], mode=1)["bbox"]
        feats[dt] = ex.extract(images[0], mode=3, gt_boxes=gt)["x"]
        log(on_card("extraction 12c: blob %s: %.4f s/img at lookahead 1, "
                    "%.4f at lookahead 2 (mode 1, 8 images of 600 x 800)"
                    % (dt, rates[1], rates[2])))
        if dt == "float32":
            ex32 = ex
        else:
            del ex
    ref = torch.from_numpy(feats["float32"])
    errs = {dt: _det_rel(torch.from_numpy(feats[dt]), ref)
            for dt in ("bfloat16", "uint8")}
    log(on_card("extraction 12c: mode-3 features of %d boxes against the "
                "fp32 blob's: %s (tol %g)" % (
                    len(gt), {k: float("%.3g" % v) for k, v in errs.items()},
                    DET_LOWP_TOL)))
    if max(errs.values()) > DET_LOWP_TOL:
        fail("extraction: low-precision blobs %s" % errs)

    # one image, stage by stage (fp32 blob)
    ex, img = ex32, images[0]
    with torch.inference_mode():
        t0 = time.perf_counter()
        blob, scale, (h, w) = transfer_blob(img, cfg)
        pre_ms = (time.perf_counter() - t0) * 1e3
        x = blob.cuda().permute(0, 3, 1, 2).contiguous()
        bb_ms, bb_host = device_ms(lambda: ex.model.backbone_rpn(x),
                                   iters=3, reps=3)
        feat, logits, deltas, event = ex._backbone_rpn(blob)
        event.synchronize()
        t0 = time.perf_counter()
        props = ex._proposals(logits.numpy(), deltas.numpy(), h, w)
        prop_ms = (time.perf_counter() - t0) * 1e3
        roi_kernels_ms = _profiled(torch, lambda: ex._roi_stage(
            feat, props))[0]
        P = cfg.pooler_resolution
        from meme_challenge_tpu_torch.extract.ops import roi_pool_device

        pooled = roi_pool_device(feat[0], props, 1.0 / cfg.anchor_base,
                                 (P, P))
        head_ms, head_host = device_ms(
            lambda: ex.model.roi_forward(pooled), iters=3, reps=3)
        cls_prob = ex._roi_stage(feat, props)["cls_prob"].cpu().numpy()
    boxes = props / scale
    mc = {}
    for impl in ("native_batched", "device"):
        ex.nms_impl = impl
        ex._max_conf(cls_prob, boxes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex._max_conf(cls_prob, boxes)
        mc[impl] = (time.perf_counter() - t0) * 1e3
    ex.nms_impl = "native_batched"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ex.extract(img)
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    prof = _profiled(torch, lambda: ex.extract(img))
    prof_line = ("profiled extract: wall %.1f ms, kernels %.1f ms, device "
                 "idle share %.3f, %d launches; top device operations (ms, "
                 "calls): %s" % (prof[2]["wall"], prof[0],
                                 1.0 - prof[0] / prof[2]["wall"], prof[1],
                                 prof[2]["top"])
                 if prof[0] is not None else "profiler unavailable")
    log(on_card(
        "breakdown extract (one 600 x 800 image, mode 1, fp32 blob, %d "
        "proposals): wall %.1f ms; host preprocessing %.1f ms; backbone + "
        "RPN %.2f ms device (%.1f ms host issue); proposal stage %.1f ms "
        "host; ROI stage: kernels %s ms (ROIPool + heads), heads alone "
        "%.2f ms device (%.1f ms host issue); max_conf native_batched "
        "%.1f ms, device %.1f ms; %s; peak memory %.2f GiB above the "
        "weights" % (
            len(props), wall_ms, pre_ms, bb_ms, bb_host, prop_ms,
            "%.2f" % roi_kernels_ms if roi_kernels_ms is not None
            else "not measured",
            head_ms, head_host, mc["native_batched"], mc["device"],
            prof_line, peak)))


def _profiled(torch, fn):
    """(kernel ms, launches, {"wall", "top"}) of one call of ``fn`` under
    torch.profiler; (None, None, {}) where the profiler gives no trace
    (informational)."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows, n_launch = [], 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                rows.append((getattr(e, "self_device_time_total", getattr(
                    e, "self_cuda_time_total", 0.0)) / 1e3, e.count, e.key))
            elif "LaunchKernel" in e.key:
                n_launch += e.count
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        if not rows:
            raise RuntimeError("no device time in the trace")
        return busy, n_launch, {"wall": wall, "top": "; ".join(
            "%s %.2f x%d" % (k[:48], t, c) for t, c, k in rows[:6])}
    except Exception as e:  # informational: a missing trace fails nothing
        log("profiler unavailable (%s)" % e)
        return None, None, {}


def visualize_phase(torch, work: str, cfg, images) -> None:
    """Phase 12d: ``visualize_boxes`` through its CLI on 2 images, where
    PIL and cv2 import: the ``*_annotated`` files exist and each one's box
    count is the number of labels ``annotate_image`` returns for it."""
    import contextlib
    import dataclasses
    import io

    try:
        import cv2  # noqa: F401
        import PIL  # noqa: F401
    except ImportError as e:
        log("extraction 12d: visualizer not run: %s" % e)
        return
    from meme_challenge_tpu_torch.extract.convert_detector import (
        load_detector_weights,
    )
    from meme_challenge_tpu_torch.extract.detector import FeatureExtractor
    from meme_challenge_tpu_torch.tools import visualize_boxes

    root = os.path.join(work, "extraction")
    img_dir, out_dir = os.path.join(root, "vis_img"), os.path.join(root,
                                                                   "vis")
    stems = _write_pngs(img_dir, images[:2])
    weights = os.path.join(root, "bua_random.pt")
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        visualize_boxes.main(["--image-dir", img_dir, "--out-dir", out_dir,
                              "--weights", weights])
    wall = time.time() - t0
    printed = dict(re.findall(r"(\S+): boxes=(\d+)", buf.getvalue()))
    vcfg = dataclasses.replace(cfg, conf_thresh=0.4, min_boxes=10,
                               max_boxes=20)
    ex = FeatureExtractor(vcfg, load_detector_weights(weights, vcfg),
                          device="cuda")
    labels = {}
    for stem in stems:
        dest = os.path.join(out_dir, stem + "_annotated.png")
        img = cv2.imread(os.path.join(img_dir, stem + ".png"))
        _, out = visualize_boxes.annotate_image(ex, img)
        labels[stem] = visualize_boxes.box_labels(out["info"])
        if not (os.path.isfile(dest) and printed.get(dest) == str(
                len(labels[stem])) == str(out["num_bbox"])):
            fail("extraction 12d: %s missing or its boxes %s differ from "
                 "annotate_image's %d labels" % (dest, printed.get(dest),
                                                 len(labels[stem])))
    log(on_card("extraction 12d: visualize_boxes CLI %.1f s, 2 annotated "
                "images, labels %s" % (
                    wall, {k: v[:3] + ["..."] for k, v in labels.items()})))


# ----------------------------------------------------- 13. detector training

DET_TRAIN_TOL = 1e-5   # the loss parts, card vs CPU, relative
DET_GRAD_TOL = 1e-4    # each gradient, of its leaf's largest magnitude
DET_ALIGN_TOL = 1e-5   # ROIAlign's gradient, of its largest magnitude
# 13a's blob: the CPU side runs a full-width train step, so the image's
# shortest side is cut from 600 to 320 (longest 448); widths are not cut
DET_CHECK_SIZE = (320, 448)
DET_TRAIN_STEPS = (3, 20)   # 13c: warm-up steps, measured steps
# The random stack's pooled features run to the thousands: one clipped SGD
# step at the CLI's default lr 1e-3 moves the box deltas by tens and the
# box losses jump; at 1e-5 they fall from step to step (13c prints them)
DET_TRAIN_LR = 1e-5


def _det_record(cfg, img, seed: int, n_gt: int = 20) -> dict:
    """A VG record of ``img`` with ``n_gt`` random boxes, classes and
    attributes (a third without one) from ``seed``, in image
    coordinates."""
    import numpy as np

    rng = np.random.RandomState(seed)
    h, w = img.shape[:2]
    xy = rng.rand(n_gt, 2) * [w * 0.7, h * 0.7]
    wh = (rng.rand(n_gt, 2) * 0.25 + 0.05) * [w, h]
    attrs = rng.randint(0, cfg.num_attributes - 1, n_gt)
    attrs[rng.rand(n_gt) < 0.33] = -1
    return {"image_id": seed, "file_name": "", "height": h, "width": w,
            "boxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
            "classes": rng.randint(0, cfg.num_classes - 1, n_gt).astype(
                np.int32),
            "attrs": attrs.astype(np.int32)}


def _det_batch(cfg, img, seed: int) -> dict:
    """One training batch of ``img`` through the port's VG loader (no
    flip), max_gt 64."""
    from meme_challenge_tpu_torch.extract.vg_data import VGDetectionLoader

    rec = _det_record(cfg, img, seed)
    loader = VGDetectionLoader([rec], cfg, max_gt=64, is_train=False,
                               image_reader=lambda r: img)
    batch = loader._one(rec)
    del batch["image_id"]
    return batch


def _det_train_step(torch, cfg, state, device: str):
    from meme_challenge_tpu_torch.extract.detector import BUADetector
    from meme_challenge_tpu_torch.extract.detector_train import (
        make_detector_train_step,
    )
    from meme_challenge_tpu_torch.extract.train_detector import (
        detector_optimizer,
    )

    model = BUADetector(cfg)
    model.load_state_dict(state, strict=True)
    model.to(device)
    return make_detector_train_step(model, cfg,
                                    detector_optimizer(DET_TRAIN_LR))


def _n_anchors(step, batch) -> int:
    """The anchors of ``batch``'s res4 map (stride 16, each stride-2 stage
    rounding up)."""
    h, w = batch["images"].shape[1:3]
    return math.ceil(h / 16) * math.ceil(w / 16) * step.num_anchors


class _ReluTape:
    """Stands in for ``torch.nn.functional`` in the detector's modules
    (``extract/resnet.py``, ``extract/detector.py``): it records each
    ReLU's decision (input > 0), in call order, or replays recorded ones
    (the input times the recorded mask, which routes the gradient as that
    mask does), counting the elements whose own decision differs. A forward
    on the CPU replaying the card's decisions takes the card's branch at
    the few pre-activations that the two devices round to opposite signs;
    everything else is unchanged."""

    def __init__(self, functional):
        self._F, self.masks, self.replay = functional, [], False
        self.pos = self.flips = self.seen = 0

    def __getattr__(self, name):
        return getattr(self._F, name)

    def relu(self, x):
        if not self.replay:
            self.masks.append((x > 0).cpu())
            return self._F.relu(x)
        mask = self.masks[self.pos].to(x.device)
        self.pos += 1
        self.flips += int(((x > 0) != mask).sum())
        self.seen += mask.numel()
        return x * mask


def _det_side(torch, step, batch, draws, tape=None):
    """The losses, every gradient and the decisions of one pass of
    ``step`` on ``draws`` (with ``tape`` standing in for the detector's
    functional module, when given)."""
    from meme_challenge_tpu_torch.extract import detector, resnet
    from meme_challenge_tpu_torch.extract.detector_train import loss_values

    saved = detector.F, resnet.F
    if tape is not None:
        detector.F = resnet.F = tape
    try:
        t0 = time.perf_counter()
        dev = step.device
        losses, aux = step.losses(batch, tuple(d.to(dev) for d in draws),
                                  aux=True)
        names = list(step.params)
        grads = torch.autograd.grad(sum(losses.values()),
                                    [step.params[k] for k in names])
        out = {"losses": loss_values(losses),
               "grads": {k: g.cpu() for k, g in zip(names, grads)},
               "aux": {k: v.detach().cpu() for k, v in aux.items()},
               "s": time.perf_counter() - t0}
    finally:
        detector.F, resnet.F = saved
    return out


def det_train_check_phase(torch, cfg, state, images) -> None:
    """Phase 13a: one train step card vs CPU at ``DetectorConfig()``'s
    widths (the blob cut to DET_CHECK_SIZE), fp32 with TF32 off, on the same
    weights and the same three draws. The decisions first: anchor and
    proposal labels equal, the same probabilities below the 1e-9 clip, the
    top-2 gap of ``cls_prob[:, 1:]`` above twice the card-vs-CPU
    difference. Then the five loss parts within DET_TRAIN_TOL relative, and
    every parameter's gradient within DET_GRAD_TOL of its leaf's largest
    magnitude. The ReLUs decide too: activations run to the thousands, and
    a few pre-activations round to opposite signs on the two devices
    (each such element routes its gradient differently), so the CPU pass
    that the gradients are held to replays the card's ReLU decisions
    (``_ReluTape``; at most one element in 10^5 may flip). The CPU's own
    pass is printed beside it. ROIAlign's gradient at the step's 64
    proposals on the card against the CPU within DET_ALIGN_TOL."""
    import dataclasses
    import torch.nn.functional as F

    from meme_challenge_tpu_torch.extract.ops import roi_align

    cut = dataclasses.replace(cfg, min_size=DET_CHECK_SIZE[0],
                              max_size=DET_CHECK_SIZE[1])
    batch = _det_batch(cut, images[0], DET_SEED)
    cpu_step = _det_train_step(torch, cfg, state, "cpu")
    draws = cpu_step.draw(_n_anchors(cpu_step, batch),
                          torch.Generator().manual_seed(DET_SEED))
    tape = _ReluTape(F)
    card = _det_side(torch, _det_train_step(torch, cfg, state, "cuda"),
                     batch, draws, tape)
    torch.cuda.synchronize()
    own = _det_side(torch, cpu_step, batch, draws)
    tape.replay = True
    cpu = _det_side(torch, cpu_step, batch, draws, tape)
    if tape.pos != len(tape.masks):
        fail("detector training 13a: the CPU pass made %d ReLU calls, the "
             "card's %d" % (tape.pos, len(tape.masks)))
    for k in ("anchor_labels", "proposal_labels"):
        if not torch.equal(card["aux"][k], cpu["aux"][k]):
            fail("detector training 13a: %s differ between the card and "
                 "the CPU" % k)
    margins = {}
    for k in ("cls_prob", "attr_prob"):
        a, b = card["aux"][k], cpu["aux"][k]
        if not torch.equal(a < 1e-9, b < 1e-9):
            fail("detector training 13a: %s below the 1e-9 clip differs"
                 % k)
        top = b[:, 1:].sort(dim=1).values
        margins[k] = (float((top[:, -1] - top[:, -2]).min()),
                      float((a - b).abs().max()))
    if margins["cls_prob"][0] <= 2 * margins["cls_prob"][1]:
        fail("detector training 13a: class argmax without margin %s"
             % (margins,))

    def worst(side):
        err = {k: _det_rel(card["grads"][k], g)
               for k, g in side["grads"].items()}
        return max(err.values()), sorted(err.items(),
                                         key=lambda kv: -kv[1])[:3]

    loss_err = {k: abs(card["losses"][k] - v) / max(abs(v), 1e-30)
                for k, v in cpu["losses"].items()}
    grad_max, grad_worst = worst(cpu)
    own_max, own_worst = worst(own)
    fg = int((cpu["aux"]["proposal_labels"] > 0).sum())
    log(on_card(
        "detector training 13a: blob %s, %d anchors (%d positive), %d "
        "proposals (%d foreground); losses %s; card vs CPU: losses %s (tol "
        "%g relative); %d gradients against the CPU on the card's ReLU "
        "decisions (%d of %d elements flipped), worst %s (tol %g of each "
        "leaf's largest); against the CPU's own decisions, worst %s; top-2 "
        "gap / difference cls_prob %.3g / %.3g, attr_prob %.3g / %.3g; step "
        "+ gradients card %.2f s, CPU %.2f s" % (
            tuple(batch["images"].shape), len(cpu["aux"]["anchor_labels"]),
            int((cpu["aux"]["anchor_labels"] == 1).sum()),
            len(cpu["aux"]["proposal_labels"]), fg,
            {k: float("%.6g" % v) for k, v in cpu["losses"].items()},
            {k: float("%.3g" % v) for k, v in loss_err.items()},
            DET_TRAIN_TOL, len(cpu["grads"]), tape.flips, tape.seen,
            [(k, float("%.3g" % v)) for k, v in grad_worst], DET_GRAD_TOL,
            [(k, float("%.3g" % v)) for k, v in own_worst],
            margins["cls_prob"][0], margins["cls_prob"][1],
            margins["attr_prob"][0], margins["attr_prob"][1],
            card["s"], own["s"])))
    if tape.flips > 1e-5 * tape.seen:
        fail("detector training 13a: %d of %d ReLU decisions differ"
             % (tape.flips, tape.seen))
    if max(loss_err.values()) > DET_TRAIN_TOL:
        fail("detector training 13a: losses card vs CPU %s" % loss_err)
    if grad_max > DET_GRAD_TOL:
        fail("detector training 13a: gradients card vs CPU %s" % grad_worst)

    # ROIAlign's gradient at the step's proposals, on one res4 map
    gen = torch.Generator().manual_seed(DET_SEED + 1)
    feat = torch.randn((1024, 20, 28), generator=gen)
    props = cpu["aux"]["proposals"]
    P = cfg.pooler_resolution
    cot = torch.randn((len(props), 1024, P, P), generator=gen)
    got = {}
    for dev in ("cuda", "cpu"):
        f = feat.to(dev).requires_grad_()
        out = roi_align(f, props.to(dev), 1.0 / cfg.anchor_base, (P, P))
        got[dev] = torch.autograd.grad(out, f, cot.to(dev))[0].cpu()
    err = _det_rel(got["cuda"], got["cpu"])
    log(on_card("detector training 13a: ROIAlign gradient at %d proposals "
                "on a [1024, 20, 28] map, card vs CPU %.3g (tol %g)"
                % (len(props), err, DET_ALIGN_TOL)))
    if err > DET_ALIGN_TOL:
        fail("detector training 13a: ROIAlign gradient card vs CPU %g"
             % err)


def _vg_json(path: str, cfg, records, split: str) -> None:
    """A COCO-format VG table of ``records`` (``_det_record``'s fields; the
    PNG files ``split/NNNNN.png`` under the image root, in order), the
    categories and attributes 1-based as the VG json has them."""
    images_t, anns = [], []
    for i, rec in enumerate(records):
        iid = rec["image_id"]
        images_t.append({"id": iid, "file_name": "%s/%05d.png" % (split,
                                                                 i + 1),
                         "height": rec["height"], "width": rec["width"]})
        for j, (box, c, a) in enumerate(zip(rec["boxes"], rec["classes"],
                                            rec["attrs"])):
            x1, y1, x2, y2 = (float(v) for v in box)
            ann = {"id": iid * 1000 + j, "image_id": iid,
                   "bbox": [x1, y1, x2 - x1, y2 - y1],
                   "category_id": int(c) + 1}
            if a >= 0:
                ann["attribute"] = [int(a) + 1]
            anns.append(ann)
    with open(path, "w") as f:
        json.dump({"images": images_t, "annotations": anns,
                   "categories": [{"id": k + 1, "name": str(k)}
                                  for k in range(cfg.num_classes - 1)]}, f)


def det_train_cli_phase(torch, work: str, cfg, state, images) -> None:
    """Phase 13b: ``train_detector`` through its CLI on the card, from the
    rescaled random weights as a torch file: 8 train and 4 val PNGs of
    600 × 800 (the val ground truth is the initial weights' own best
    detections), 2 epochs, ``--eval-images 4``; finite losses at every log,
    ``detector.pth`` written before each epoch's evaluation, finite mAP and
    weighted mAP; ``--eval-only`` on the dump reproducing the last epoch's
    metrics, and ``evaluate`` alone timed in s an image; ``extract_features
    --weights <dump> --mode 1`` on two images (the hand-off to
    extraction)."""
    import logging

    import numpy as np

    from meme_challenge_tpu_torch.extract import (
        extract_features,
        train_detector,
    )
    from meme_challenge_tpu_torch.extract.detector import FeatureExtractor

    root = os.path.join(work, "detector_train")
    _write_pngs(os.path.join(root, "train"), images[:8])
    _write_pngs(os.path.join(root, "val"), images[4:8])
    train_json = os.path.join(root, "train.json")
    val_json = os.path.join(root, "val.json")
    _vg_json(train_json, cfg, [_det_record(cfg, img, i + 1)
                               for i, img in enumerate(images[:8])], "train")
    # the val ground truth: the initial weights' own 10 best mode-2
    # detections an image, so that the mAP is not zero
    ex = FeatureExtractor(cfg, state, device="cuda")
    val = []
    for i, img in enumerate(images[4:8]):
        det = ex.extract(img, mode=2)
        val.append({"image_id": 101 + i, "height": img.shape[0],
                    "width": img.shape[1], "boxes": det["bbox"][:10],
                    "classes": det["cls_prob"][:10, 1:].argmax(1),
                    "attrs": np.full(10, -1)})
    del ex
    _vg_json(val_json, cfg, val, "val")
    init = os.path.join(root, "init.pth")
    torch.save(state, init)
    out = os.path.join(root, "out")
    dump = os.path.join(out, "detector.pth")
    common = ["--val-json", val_json, "--image-root", root, "--out-dir", out,
              "--eval-images", "4"]

    saved = []

    class DumpWatch(logging.Handler):
        """At each epoch's evaluation log: is the epoch's dump there?"""

        def emit(self, record):
            if record.getMessage().startswith("epoch "):
                saved.append(os.path.isfile(dump)
                             and os.stat(dump).st_mtime_ns)

    logger = logging.getLogger(train_detector.__name__)
    watch = DumpWatch()
    logger.addHandler(watch)
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        t0 = time.time()
        history = train_detector.main(common + [
            "--train-json", train_json, "--weights", init, "--epochs", "2",
            "--log-every", "1", "--lr", str(DET_TRAIN_LR)])
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        logger.removeHandler(watch)
        logger.setLevel(level)
    steps = [it for it, _ in history["losses"]]
    finite = all(np.isfinite(v) for _, d in history["losses"]
                 for v in d.values())
    totals = [round(sum(d.values()), 4) for _, d in history["losses"]]
    log(on_card("detector training 13b: train_detector CLI, 2 epochs of 8 "
                "images (600 x 800) at lr %g, eval on 4: %.1f s; %d steps "
                "logged, "
                "finite %s; total loss by step %s; epochs %s; dump before "
                "each evaluation %s" % (
                    DET_TRAIN_LR, wall, len(steps), finite, totals,
                    history["epochs"],
                    [bool(s) for s in saved])))
    if (steps != list(range(1, 17)) or not finite or len(saved) != 2
            or not all(saved) or saved[0] == saved[1]
            or len(history["epochs"]) != 2
            or not all(np.isfinite(e[k]) for e in history["epochs"]
                       for k in ("mAP", "weighted_mAP"))):
        fail("detector training 13b: the CLI run went wrong: steps %s, "
             "epochs %s, dumps %s" % (steps, history["epochs"], saved))
    t0 = time.time()
    metrics = train_detector.main(common + ["--eval-only", "--weights",
                                            dump])
    eval_wall = time.time() - t0
    last = history["epochs"][-1]
    same = all(metrics[k] == last[k] for k in ("mAP", "weighted_mAP"))
    log(on_card("detector training 13b: --eval-only on the dump: mAP %.6g, "
                "weighted %.6g in %.1f s (the last epoch's: %.6g, %.6g; "
                "equal %s)" % (metrics["mAP"], metrics["weighted_mAP"],
                               eval_wall, last["mAP"], last["weighted_mAP"],
                               same)))
    if not same:
        fail("detector training 13b: --eval-only gives %s, the last epoch "
             "%s" % ({k: metrics[k] for k in ("mAP", "weighted_mAP")},
                     last))
    # evaluation alone: the dump's weights in an extractor already made,
    # one image first to warm it up
    from meme_challenge_tpu_torch.extract.convert_detector import (
        load_detector_weights,
    )
    from meme_challenge_tpu_torch.extract.vg_data import load_vg_json

    ex = FeatureExtractor(cfg, load_detector_weights(dump, cfg),
                          device="cuda")
    val_records = load_vg_json(val_json, root)
    train_detector.evaluate(cfg, ex.model, val_records[:1], extractor=ex)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = train_detector.evaluate(cfg, ex.model, val_records, extractor=ex)
    per_image = (time.perf_counter() - t0) / len(val_records)
    del ex
    log(on_card("detector training 13b: evaluate alone (mode-2 detection "
                "and vg_eval) %.4f s an image over %d images; mAP %.6g" % (
                    per_image, len(val_records), again["mAP"])))
    if again["mAP"] != metrics["mAP"]:
        fail("detector training 13b: evaluate gives mAP %g, --eval-only %g"
             % (again["mAP"], metrics["mAP"]))
    img_dir = os.path.join(root, "handoff_img")
    stems = _write_pngs(img_dir, images[:2])
    npz = os.path.join(root, "handoff_npz")
    extract_features.main(["--image-dir", img_dir, "--out-dir", npz,
                           "--weights", dump, "--mode", "1"])
    boxes = []
    for stem in stems:
        path = os.path.join(npz, stem + ".npz")
        if not os.path.isfile(path):
            fail("detector training 13b: extract_features wrote no %s" % path)
        z = np.load(path, allow_pickle=True)
        k = int(z["num_bbox"])
        if z["x"].shape != (k, 2048) or not np.isfinite(z["x"]).all():
            fail("detector training 13b: %s holds x %s for %d boxes"
                 % (path, z["x"].shape, k))
        boxes.append(k)
    log(on_card("detector training 13b: extract_features --weights "
                "detector.pth --mode 1 on 2 images: boxes %s" % boxes))


def det_determinism_diagnosis(torch) -> dict:
    """Which operations of one detector gradient pass do not repeat: run in
    a process of its own (``--det-determinism``, with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``) on 13c's fixed 600 × 800 batch and
    draws, so that the global settings it turns on reach no other phase.
    Two identical passes are compared leaf by leaf (a) as the step runs,
    (b) with cuDNN's deterministic algorithms (``cudnn.deterministic``,
    ``benchmark`` off) and (c) under ``torch.use_deterministic_algorithms``:
    first raising, which names the first operation with no deterministic
    implementation, then warning, which names every such operation. The
    kernels of one pass that (c) swaps for others are named too, as is
    whether ROIAlign's backward alone repeats."""
    import warnings

    from meme_challenge_tpu_torch.core.seeding import dropout_generator
    from meme_challenge_tpu_torch.extract.ops import roi_align

    cfg, state, images = detector_setup(torch)
    batch = _det_batch(cfg, images[0], DET_SEED)
    step = _det_train_step(torch, cfg, state, "cuda")
    draws = step.draw(_n_anchors(step, batch),
                      dropout_generator(DET_SEED, 0, "cuda"))
    names = list(step.params)

    def grads():
        return torch.autograd.grad(sum(step.losses(batch, draws).values()),
                                   [step.params[k] for k in names])

    def differing():
        a, b = grads(), grads()
        return [k for k, x, y in zip(names, a, b) if not torch.equal(x, y)]

    def kernels():
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            grads()
            torch.cuda.synchronize()
        return {e.key[:90] for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}

    def summary(keys):
        return {"n": len(keys), "of": len(names), "first": keys[:6]}

    out = {"default": summary(differing())}
    k_default = kernels()
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out["cudnn_deterministic"] = summary(differing())
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved
    # ROIAlign's backward alone at the step's proposals
    with torch.no_grad():
        feat = step.model.backbone_rpn(
            torch.from_numpy(batch["images"]).cuda().permute(0, 3, 1, 2)
            .float().contiguous())[0][0]
    props = step.losses(batch, draws, aux=True)[1]["proposals"].detach()
    P = cfg.pooler_resolution
    cot = torch.randn((len(props), feat.shape[0], P, P), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(1))
    f = feat.detach().requires_grad_()
    align = [torch.autograd.grad(roi_align(f, props, 1.0 / cfg.anchor_base,
                                           (P, P)), f, cot)[0]
             for _ in range(2)]
    out["roi_align_backward_repeats"] = bool(torch.equal(*align))
    torch.use_deterministic_algorithms(True)
    try:
        grads()
        out["raised"] = None
    except RuntimeError as e:
        out["raised"] = str(e).splitlines()[0][:300]
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["deterministic_algorithms"] = summary(differing())
    out["warned"] = sorted({str(w.message).splitlines()[0][:200]
                            for w in caught})[:8]
    k_det = kernels()
    torch.use_deterministic_algorithms(False)
    out["kernels_swapped_out"] = sorted(k_default - k_det)[:12]
    out["kernels_swapped_in"] = sorted(k_det - k_default)[:12]
    return out


def det_train_time_phase(torch, cfg, state, images) -> None:
    """Phase 13c: where a step's time goes, at ``DetectorConfig()`` on one
    fixed 600 × 800 batch (64 proposals): DET_TRAIN_STEPS warm-up and
    measured steps (wall and host-issue ms, images/s, the loss
    trajectory), one profiled step (kernel ms, top device operations, idle
    share, launches), host syncs inside a step (``set_sync_debug_mode``),
    peak memory above the weights and the optimizer state, ROIAlign's
    forward and backward ms and their peak, and whether two identical
    gradient passes of the step give the same bits (gated; the diagnosis
    of what does not repeat, :func:`det_determinism_diagnosis`, runs alone
    with ``--det-determinism``). The step's device ms with its determinism
    repair (``deterministic_cudnn``) and without it, in turns. One
    ``breakdown detector_train`` line."""
    import warnings

    from meme_challenge_tpu_torch.core.seeding import dropout_generator
    from meme_challenge_tpu_torch.extract.detector_train import loss_values
    from meme_challenge_tpu_torch.extract.ops import roi_align

    batch = _det_batch(cfg, images[0], DET_SEED)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    step = _det_train_step(torch, cfg, state, "cuda")
    n_params = sum(p.numel() for p in step.params.values())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before     # weights + trace
    warm, n = DET_TRAIN_STEPS
    traj = [step(batch, dropout_generator(DET_SEED, i, "cuda"))
            for i in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    host = []
    t0 = time.perf_counter()
    for i in range(warm, warm + n):
        t1 = time.perf_counter()
        traj.append(step(batch, dropout_generator(DET_SEED, i, "cuda")))
        host.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    values = [loss_values(l) for l in traj]
    totals = [round(sum(v.values()), 4) for v in values]
    if not all(math.isfinite(t) for t in totals):
        fail("detector training 13c: non-finite losses %s" % totals)

    # host syncs inside one step
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(batch, dropout_generator(DET_SEED, warm + n, "cuda"))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0][:80] for w in caught
             if "called a synchronizing" in str(w.message)]
    prof = _profiled(torch, lambda: step(
        batch, dropout_generator(DET_SEED, warm + n + 1, "cuda")))
    # the step queued behind a sleep: device ms back to back, and the
    # host's issue time while the card is busy (a hidden sync would hold
    # the host until the sleep ends)
    gen = dropout_generator(DET_SEED, 0, "cuda")
    step_ms, step_host = device_ms(lambda: step(batch, gen), iters=5,
                                   reps=3)

    # the step without its determinism repair (cuDNN's default backward
    # algorithms), in turns with the repaired step
    from meme_challenge_tpu_torch.extract import detector_train

    scoped = detector_train.deterministic_cudnn
    turns = {"repaired": [], "default": []}
    for name in ("repaired", "default", "default", "repaired"):
        detector_train.deterministic_cudnn = (
            scoped if name == "repaired" else contextlib.nullcontext)
        try:
            turns[name].append(device_ms(lambda: step(batch, gen), iters=5,
                                         reps=3)[0])
        finally:
            detector_train.deterministic_cudnn = scoped

    # the determinism of a pass (the gate), and ROIAlign alone at the
    # step's shapes
    draws = step.draw(_n_anchors(step, batch),
                      dropout_generator(DET_SEED, 0, "cuda"))
    losses, aux = step.losses(batch, draws, aux=True)
    grads = [step.gradients(batch, draws)[1] for _ in range(2)]
    differ = [k for k in grads[0] if not torch.equal(grads[0][k],
                                                     grads[1][k])]
    del grads, losses
    with torch.no_grad():
        feat = step.model.backbone_rpn(
            torch.from_numpy(batch["images"]).cuda().permute(0, 3, 1, 2)
            .contiguous())[0][0]
    f = feat.detach().requires_grad_()
    props = aux["proposals"].detach()
    P = cfg.pooler_resolution
    cot = torch.ones((len(props), feat.shape[0], P, P), device="cuda")
    with torch.no_grad():
        fwd_ms = device_ms(lambda: roi_align(f, props, 1.0 / cfg.anchor_base,
                                             (P, P)), iters=10, reps=3)[0]
    both_ms = device_ms(lambda: torch.autograd.grad(
        roi_align(f, props, 1.0 / cfg.anchor_base, (P, P)), f, cot),
        iters=10, reps=3)[0]
    torch.cuda.synchronize()
    align_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.autograd.grad(roi_align(f, props, 1.0 / cfg.anchor_base, (P, P)),
                        f, cot)
    torch.cuda.synchronize()
    align_peak = (torch.cuda.max_memory_allocated() - align_base) / 2 ** 30
    # clip + SGD momentum alone over every parameter (the step's last
    # stage; zero gradients change nothing measured)
    zeros = {k: torch.zeros_like(p) for k, p in step.params.items()}
    opt_ms, opt_host = device_ms(lambda: step.optimizer.step(
        step.params, zeros, step.opt_state), iters=5, reps=3)
    prof_line = ("kernels %.1f ms, device idle share %.3f, %d launches; "
                 "top device operations (ms, calls): %s" % (
                     prof[0], 1.0 - prof[0] / prof[2]["wall"], prof[1],
                     prof[2]["top"])
                 if prof[0] is not None else "profiler unavailable")
    log(on_card("detector training 13c: by step (%d warm-up + %d measured, "
                "lr %g, one fixed batch, a generator a step): total %s; "
                "rpn_box %s; roi_box %s" % (
                    warm, n, DET_TRAIN_LR, totals,
                    [round(v["rpn_box"], 4) for v in values],
                    [round(v["roi_box"], 4) for v in values])))
    log(on_card("detector training 13c: host syncs inside a step: %d %s; "
                "two identical gradient passes of the step bit-equal: %s "
                "(%d of %d leaves differ)" % (
                    len(syncs), syncs[:3], not differ, len(differ),
                    len(step.params))))
    log(on_card(
        "breakdown detector_train (one 600 x 800 image, blob %s, %d "
        "proposals, %.1f M parameters in %d tensors): wall %.1f ms a step "
        "(%.2f images/s), host issue %.1f ms (median of %d); queued behind "
        "a sleep: %.1f ms device a step, %.1f ms host issue while the card "
        "is busy; device ms a step with the determinism repair %s, without "
        "it %s (in turns); profiled step: wall %s ms, %s; ROIAlign forward "
        "%.2f ms, "
        "backward %.2f ms device, peak %.3f GiB for both above the map and "
        "the cotangent; clip + SGD %.2f ms device (%.1f ms host "
        "issue); peak %.2f GiB above the weights and the optimizer state "
        "(%.2f GiB)" % (
            tuple(batch["images"].shape), step.num_proposals, n_params / 1e6,
            len(step.params), wall, 1e3 / wall, statistics.median(host), n,
            step_ms, step_host,
            ["%.2f" % t for t in turns["repaired"]],
            ["%.2f" % t for t in turns["default"]],
            "%.1f" % prof[2]["wall"] if prof[0] is not None else "n/a",
            prof_line, fwd_ms, both_ms - fwd_ms, align_peak, opt_ms, opt_host,
            peak, held / 2 ** 30)))
    if syncs:
        fail("detector training 13c: the step synchronizes with the host: "
             "%s" % syncs[:3])
    if differ:
        fail("detector training 13c: two identical gradient passes differ "
             "in %d leaves: %s" % (len(differ), differ[:4]))


# ------------------------------------------------------------- UNITER-large

LARGE_JSON = os.path.join(ROOT, "configs", "uniter-large.json")
LARGE_H = 16  # UNITER-large's heads: pair blocks of 16 at B 16 and B 32
# phase 15c's CLI runs: (kernel, dtype, pallas_blocked, --fuse_accum), the
# two shapes of the JAX package's UNITER-large step (bench.py:822-856)
LARGE_RUNS = (("fused_attention", "float32", False, False),
              ("fused_attention_blocked", "bfloat16", True, True))
LARGE_FOLDS = 3
# phase 15e: the lookups above PyTorch's 3 072-id threshold of the atomic
# embedding backward
REPEAT_IDS = 3072


def large_config(**fields):
    """configs/uniter-large.json through the CLI's loader, with the fused
    kernels and ``fields``."""
    from meme_challenge_tpu_torch.core.config import UniterConfig

    cfg = UniterConfig.from_json_file(LARGE_JSON).replace(
        use_pallas_attention=True, **fields)
    if (cfg.num_hidden_layers, cfg.hidden_size, cfg.num_attention_heads,
            cfg.head_dim) != (24, 1024, LARGE_H, D):
        fail("%s is not UNITER-large: %s" % (LARGE_JSON, cfg))
    return cfg


def large_parity_phase(torch, synth: dict, A) -> None:
    """Phase 15a: MemeUniter at UNITER-large's full width (random weights
    from seed 15 on the card, copied to the CPU), 2 memes with padding,
    fp32, dropout off: logits within LOGIT_TOL relative, the bce_logits
    loss (pos_wt 1.8) and every gradient within GRAD_TOL, the card through
    the kernels (24 forward + 24 backward launches on mma_tf32x3) and the
    CPU through their plain versions."""
    import numpy as np

    from meme_challenge_tpu_torch.core.seeding import torch_generator
    from meme_challenge_tpu_torch.models.uniter import init_meme_uniter
    from meme_challenge_tpu_torch.train.losses import make_loss_fn

    cfg = large_config(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    batch = _train_dataset(synth).batch([0, 1])
    batch["sample_mask"] = np.ones(2, np.int32)
    card = init_meme_uniter(cfg, 1, "cuda", torch_generator(15, "cuda"))
    reset_launches(A)
    _card_vs_cpu(torch, "uniter-large 15a: MemeUniter, kernels on the card, "
                 "plain versions on the CPU,", card, batch,
                 make_loss_fn("bce_logits", 1.8), grads=True)
    by_route = check_route_counts(A, "uniter-large 15a", "float32",
                                  ("fused_attention", "fused_attention_bwd"))
    want = cfg.num_hidden_layers
    if (A.LAUNCHES["fused_attention"], A.LAUNCHES["fused_attention_bwd"]) \
            != (want, want):
        fail("uniter-large 15a: launches %s, expected %d forward + %d "
             "backward" % (dict(A.LAUNCHES), want, want))
    log("uniter-large 15a: launches by route %s" % by_route)
    del card


def large_kernel_phase(torch, A) -> dict:
    """Phase 15b: the four kernels at UNITER-large's shapes, per-sample
    [16, 16, 160, 64] and pair-blocked [32, 16, 160, 64] (--fuse_accum's
    rows, blocks of 16 pairs), fp32 and bf16, rate 0 and 0.1, forward and
    backward against the plain versions at the kernel phase's tolerances
    (TOL; the backward relative to each gradient's largest magnitude), the
    same zero positions under dropout (one-hot v windows for the forward,
    one-hot dout windows through dv for the backward), each launch on its
    dtype's tensor-core body. Times as the kernel phase takes them: the
    kernel at rate 0 and 0.1, its plain version, torch's
    scaled_dot_product_attention (the yardstick) and the bound at these
    shapes. Returns them by (kernel, dtype)."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    scale, rate = 1.0 / D ** 0.5, 0.1
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    for name, wrapper, plain, batch in (
            ("fused_attention", A.fused_attention, A.fused_attention_plain,
             B),
            ("fused_attention_blocked", A.fused_attention_blocked,
             A.fused_attention_blocked_plain, 2 * B)):
        blocked = name.endswith("blocked")
        n_seeds = (A.blocked_seed_count(batch, LARGE_H) if blocked
                   else batch)
        group = A._largest_block(batch * LARGE_H) if blocked else LARGE_H
        if blocked and group != 16:
            fail("uniter-large 15b: blocks of %d pairs, expected 16" % group)
        bwd = name + "_bwd"
        for dtype in ("float32", "bfloat16"):
            want = main_path_route(dtype)
            q, k, v, bias = attention_inputs(torch, dtype, gen, batch,
                                             LARGE_H)
            do = torch.randn(q.shape, generator=gen,
                             device="cuda").to(q.dtype)
            seeds = torch.randint(0, 2 ** 31 - 1, (n_seeds,), generator=gen,
                                  device="cuda", dtype=torch.int32)
            err_fwd, err_bwd, rel_bwd, routes = 0.0, 0.0, 0.0, set()
            for r in (0.0, rate):
                out, route = route_taken(A, name, lambda: wrapper(
                    q, k, v, bias, scale, r, seeds))
                ref = plain(q, k, v, bias, scale, r, seeds)
                err_fwd = max(err_fwd, (out.float() - ref.float()).abs()
                              .max().item())
                got, bwd_route = route_taken(A, bwd, lambda: kernel_grads(
                    torch, wrapper, q, k, v, bias, do, scale, r, seeds))
                e_abs, e_rel = _rel_err(
                    torch, got, A.fused_attention_bwd_plain(
                        q, k, v, bias, do, scale, r, seeds, group))
                err_bwd, rel_bwd = max(err_bwd, e_abs), max(rel_bwd, e_rel)
                routes |= {route, bwd_route}
            zeros_fwd = zeros_bwd = True
            for c in (0, 64, 96):
                probe = torch.zeros_like(v)
                d_idx = torch.arange(D, device="cuda")
                probe[:, :, c + d_idx, d_idx] = 1
                zeros_fwd &= bool(torch.equal(
                    wrapper(q, k, probe, bias, scale, rate, seeds) == 0,
                    plain(q, k, probe, bias, scale, rate, seeds) == 0))
                zeros_bwd &= bool(torch.equal(
                    kernel_grads(torch, wrapper, q, k, v, bias, probe, scale,
                                 rate, seeds)[2] == 0,
                    A.fused_attention_bwd_plain(q, k, v, bias, probe, scale,
                                                rate, seeds, group)[2] == 0))
            torch.cuda.synchronize()
            tol = TOL[dtype]
            ok = (err_fwd <= tol and rel_bwd <= tol and zeros_fwd
                  and zeros_bwd and routes == {want})
            # times: the forward, then the backward through autograd
            mask = bias.to(q.dtype)
            fwd = dict(
                ms=device_ms(lambda: wrapper(q, k, v, bias, scale))[0],
                ms_dropout=device_ms(lambda: wrapper(q, k, v, bias, scale,
                                                     rate, seeds))[0],
                plain_ms=device_ms(lambda: plain(q, k, v, bias, scale))[0],
                library_ms=device_ms(lambda: sdpa(
                    q, k, v, attn_mask=mask, scale=scale))[0],
                library_ms_dropout=device_ms(lambda: sdpa(
                    q, k, v, attn_mask=mask, dropout_p=rate,
                    scale=scale))[0])
            fwd["bound_ms"], fwd["bound_by"] = attention_bound_ms(
                dtype, batch, LARGE_H)
            back = {}
            for r, key in ((0.0, "ms"), (rate, "ms_dropout")):
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                o = wrapper(*leaves, bias, scale, r, seeds)
                back[key] = device_ms(lambda: torch.autograd.grad(
                    o, leaves, do, retain_graph=True))[0]
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                o = sdpa(*leaves, attn_mask=mask, dropout_p=r, scale=scale)
                back["library_" + key] = device_ms(
                    lambda: torch.autograd.grad(o, leaves, do,
                                                retain_graph=True))[0]
            back["plain_ms"] = device_ms(lambda: A.fused_attention_bwd_plain(
                q, k, v, bias, do, scale, 0.0, None, group))[0]
            back["bound_ms"], back["bound_by"] = attention_bwd_bound_ms(
                dtype, batch, LARGE_H)
            for kernel, t, err in ((name, fwd, err_fwd), (bwd, back,
                                                          err_bwd)):
                results[(kernel, dtype)] = dict(t, max_abs_err=err,
                                                batch=batch, heads=LARGE_H)
                log(on_card(
                    "uniter-large 15b kernel %s %s at [%d, %d, %d, %d] (%s): "
                    "ms=%.4f ms_rate%.1f=%.4f plain_ms=%.4f library_ms=%.4f "
                    "library_ms_rate%.1f=%.4f bound_ms=%.4f (%s)"
                    % (kernel, dtype, batch, LARGE_H, S, D, want, t["ms"],
                       rate, t["ms_dropout"], t["plain_ms"],
                       t["library_ms"], rate, t["library_ms_dropout"],
                       t["bound_ms"], t["bound_by"])))
            log(on_card(
                "uniter-large 15b kernels %s %s at B %d, H %d (seeds %d, "
                "block %d): forward max_abs_err %.3g, backward relative "
                "error %.3g (tol %g); zero positions equal: forward %s, "
                "backward %s; routes %s" % (
                    name, dtype, batch, LARGE_H, n_seeds, group, err_fwd,
                    rel_bwd, tol, zeros_fwd, zeros_bwd, sorted(routes))))
            if not ok:
                fail("uniter-large 15b: kernel %s %s disagrees with its "
                     "plain version" % (name, dtype))
    return results


def large_cli_phase(torch, work: str, synth: dict, passlog, A) -> dict:
    """Phase 15c: UNITER-large fine-tunes through the port's CLI
    (``finetune_cli_run``, 1 epoch: fp32 per-sample, and bf16 pair-blocked
    with --fuse_accum), then serving from the fp32 run's best checkpoint
    (``serve_cli_run``): exact launch counts (24 a forward or backward) on
    the dtype's tensor-core body, finite losses, the best checkpoint, the
    CSVs and metrics JSON, train and inference memes/s. Returns the
    launches by (kernel, dtype)."""
    launches = {}
    fp32_dir = None
    for name, dtype, blocked, fuse in LARGE_RUNS:
        counts, run_dir = finetune_cli_run(
            torch, work, synth, passlog, A, large_config(
                pallas_blocked=blocked), name, dtype, fuse, 1,
            "uniter-large 15c train %s %s%s" % (
                name, dtype, " fuse_accum" if fuse else ""))
        for kernel, n in counts.items():
            launches[(kernel, dtype)] = n
        if dtype == "float32":
            fp32_dir = run_dir
    counts = serve_cli_run(
        torch, os.path.join(work, "uniter_large_serve"),
        os.path.join(fp32_dir, "finetune.ckpt"), synth, passlog, A,
        large_config(), "fused_attention", "float32",
        "uniter-large 15c serve fused_attention float32")
    launches[("fused_attention", "float32")] += counts["fused_attention"]
    return launches


def large_step_phase(torch, synth: dict) -> None:
    """Phase 15d: one UNITER-large optimizer step (accumulation 2 × batch
    16, Adam with bf16 moments, global-norm clipping, dropout on) measured
    as phase 9d: per-sample fp32; bf16 pair-blocked with --fuse_accum; and
    fold-stacked at F 3 (remat "dots", fp32). The largest F that fits is
    reckoned from F 3's peak, a third of it a fold."""
    from meme_challenge_tpu_torch.core.config import TrainConfig
    from meme_challenge_tpu_torch.core.seeding import (
        dropout_generator,
        fold_dropout_generators,
        torch_generator,
    )
    from meme_challenge_tpu_torch.models.uniter import (
        FoldStack,
        init_meme_uniter,
    )
    from meme_challenge_tpu_torch.train.losses import make_loss_fn
    from meme_challenge_tpu_torch.train.optim import Optimizer
    from meme_challenge_tpu_torch.train.steps import (
        TrainState,
        create_train_state,
        make_fold_train_step,
        make_train_step,
    )

    ds = _train_dataset(synth)
    c = TrainConfig()
    loss_fn = make_loss_fn("bce_logits", 1.8)

    def optimizer(folds):
        return Optimizer("adam", 3e-5, lambda step: 1.0, beta1=c.beta1,
                         beta2=c.beta2, weight_decay=c.weight_decay,
                         max_grad_norm=c.max_grad_norm,
                         mu_dtype=c.adam_mu_dtype, nu_dtype=c.adam_nu_dtype,
                         folds=folds)

    bf16 = dict(dtype="bfloat16", attention_score_dtype="bfloat16",
                dropout_bits_dtype="uint8")
    batch = {k: v[0] for k, v in _fold_batches(torch, ds, 1,
                                               TRAIN_ACCUM).items()}
    for tag, cfg, fuse, setting in (
            ("per-sample", large_config(), False, "Adam, fp32"),
            ("pair-blocked --fuse_accum", large_config(
                pallas_blocked=True, **bf16), True, "Adam, bf16")):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        model = init_meme_uniter(cfg, 1, "cuda", torch_generator(0, "cuda"))
        opt = optimizer(0)
        state = create_train_state(model, opt)
        step = make_train_step(model, loss_fn, opt, accum_steps=TRAIN_ACCUM,
                               fuse_accum=fuse)
        _measure_step(torch, lambda: step(state, batch, dropout_generator(
            43, state.step, "cuda")), TRAIN_ACCUM * 16,
            "uniter-large 15d step, %s, %.1f M parameters," % (
                tag, sum(p.numel() for p in model.parameters()) / 1e6),
            base, setting)
        del model, opt, state, step
    del batch
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cfg = large_config(remat=True, remat_policy="dots")
    stack = FoldStack.from_models(
        (init_meme_uniter(cfg, 1, "cuda", torch_generator(f, "cuda"))
         for f in range(LARGE_FOLDS)), LARGE_FOLDS)
    opt = optimizer(LARGE_FOLDS)
    state = TrainState(stack, opt.init(stack.params))
    step = make_fold_train_step(stack, loss_fn, opt, accum_steps=TRAIN_ACCUM)
    batch = _fold_batches(torch, ds, LARGE_FOLDS, TRAIN_ACCUM)
    m = _measure_step(torch, lambda: step(
        state, batch, fold_dropout_generators(43, LARGE_FOLDS, state.step,
                                              "cuda")),
        LARGE_FOLDS * TRAIN_ACCUM * 16,
        "uniter-large 15d fold-parallel step F %d" % LARGE_FOLDS, base)
    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    log(on_card("uniter-large 15d: %.2f GiB a fold at the peak of the F %d "
                "step: the largest F that fits in %.1f GiB, reckoned "
                "linearly, is %d" % (
                    m["peak_gib"] / LARGE_FOLDS, LARGE_FOLDS, total,
                    int(total // (m["peak_gib"] / LARGE_FOLDS)))))
    del stack, opt, state, step, batch


def _repeated_grads(torch, model, loss_of, repaired: bool) -> list:
    """The leaves of ``model`` whose gradients differ between two identical
    gradient passes (``loss_of(model)``, dropout from one seed each time):
    with the lookups indexing their table, or (``repaired`` false) through
    ``F.embedding`` as before the repair."""
    from meme_challenge_tpu_torch.models import text_models, uniter

    lookup = uniter.embedding_lookup
    if not repaired:
        def embedding(weight, ids):
            return torch.nn.functional.embedding(ids.long(), weight)

        uniter.embedding_lookup = text_models.embedding_lookup = embedding
    try:
        grads = []
        for _ in range(2):
            model.zero_grad(set_to_none=True)
            loss_of(model).backward()
            grads.append({n: p.grad.clone() for n, p in
                          model.named_parameters() if p.grad is not None})
    finally:
        uniter.embedding_lookup = text_models.embedding_lookup = lookup
    model.zero_grad(set_to_none=True)
    return [n for n in grads[0] if not torch.equal(grads[0][n], grads[1][n])]


def repeat_gate_phase(torch, synth: dict) -> None:
    """Phase 15e, the gate of the embedding repair: two identical gradient
    passes (dropout on, from one seed) give the same bits, each with a
    lookup of more than 3 072 ids: UNITER-base MemeUniter with
    --fuse_accum's 32 rows (32 × 100 image type ids), fp32 pair-blocked;
    UniterForPretraining's MRFR over 32 × 100 mask ids; bert at 64 × 60
    tokens. Beside each, the leaves that differ when the lookups go through
    ``F.embedding`` as before the repair (not gated)."""
    import numpy as np

    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.core.seeding import (
        dropout_generator,
        torch_generator,
    )
    from meme_challenge_tpu_torch.models.text_models import init_text_model
    from meme_challenge_tpu_torch.models.uniter import init_meme_uniter
    from meme_challenge_tpu_torch.train.losses import bce_logits_loss
    from meme_challenge_tpu_torch.train.pretrain_driver import _task_loss
    from meme_challenge_tpu_torch.train.pretrain_init import (
        init_pretrain_model,
    )
    from meme_challenge_tpu_torch.train.steps import (
        MODEL_INPUT_KEYS,
        TRAIN_KEYS,
        to_device,
    )

    keys = MODEL_INPUT_KEYS + TRAIN_KEYS

    def classifier_loss(b):
        def loss_of(model):
            logits = model(b, deterministic=False,
                           generator=dropout_generator(43, 0, "cuda"))
            return bce_logits_loss(logits, b["labels"], b["sample_mask"],
                                   1.8)[0]
        return loss_of

    cases = []
    stacked = _fold_batches(torch, _train_dataset(synth), 1, TRAIN_ACCUM)
    fused = {k: v.reshape((-1,) + tuple(v.shape[3:]))
             for k, v in stacked.items()}
    cases.append((
        "UNITER-base MemeUniter --fuse_accum (fp32, pair-blocked)",
        "%d image type ids" % fused["img_mask"].numel(),
        fused["img_mask"].numel(),
        lambda: init_meme_uniter(
            UniterConfig(use_pallas_attention=True, pallas_blocked=True), 1,
            "cuda", torch_generator(0, "cuda")), classifier_loss(fused)))
    ds, tok = _pretrain_corpus(synth)
    host = {k: v[0] for k, v in _task_batches(ds, tok, 2 * 16)["mrfr"]
            .items()}
    mrfr = to_device(host, "cuda", keys=host)
    cases.append((
        "UniterForPretraining MRFR (fp32, per-sample)",
        "%d mask ids" % mrfr["img_masks"].numel(), mrfr["img_masks"].numel(),
        lambda: init_pretrain_model(
            UniterConfig(use_pallas_attention=True), 1601, "cuda",
            torch_generator(0, "cuda")),
        lambda model: _task_loss(model, mrfr, "mrfr",
                                 dropout_generator(43, 0, "cuda"))))
    text = _text_dataset(synth).batch(list(range(64)))
    text["sample_mask"] = np.ones(64, np.int32)
    text = to_device(text, "cuda", keys=keys)
    cases.append((
        "bert (fp32)", "%d word, position and token-type ids each"
        % text["input_ids"].numel(), text["input_ids"].numel(),
        lambda: init_text_model("bert", 1, "cuda",
                                torch_generator(0, "cuda")),
        classifier_loss(text)))
    for tag, what, n_ids, build, loss_of in cases:
        model = build()
        differ = _repeated_grads(torch, model, loss_of, repaired=True)
        before = _repeated_grads(torch, model, loss_of, repaired=False)
        n_leaves = sum(1 for p in model.parameters() if p.requires_grad)
        log(on_card(
            "uniter-large 15e repeat %s, %s: two identical gradient passes "
            "bit-equal %s (%d of %d leaves differ); through F.embedding as "
            "before the repair %d differ%s" % (
                tag, what, not differ, len(differ), n_leaves, len(before),
                " (%s)" % before[:3] if before else "")))
        if n_ids <= REPEAT_IDS:
            fail("15e %s: %d ids, not above %d" % (tag, n_ids, REPEAT_IDS))
        if differ:
            fail("15e %s: two identical gradient passes differ in %s"
                 % (tag, differ[:4]))
        del model
        torch.cuda.empty_cache()


def main(argv) -> None:
    if not os.path.isdir(PACKAGE):
        fail("meme_challenge_tpu_torch/ not found beside chip_smoke.py: run "
             "from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--det-determinism" in argv:
        log("DET_DETERMINISM " + json.dumps(det_determinism_diagnosis(torch)))
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail("nvidia-smi failed: " + smi.stderr.strip())
    card = smi.stdout.strip().splitlines()[0]
    CARD[0] = card
    log("card: " + card)
    log("torch %s, CUDA %s, python %s" % (torch.__version__,
                                         torch.version.cuda,
                                         sys.version.split()[0]))

    from meme_challenge_tpu_torch.ops import cuda_build

    t0 = time.time()
    secs = cuda_build.build()
    log("build: %.1f s total, %s" % (time.time() - t0, json.dumps(
        {k: round(v, 1) for k, v in secs.items()})))
    for name in cuda_build.LIBRARIES:
        for line in cuda_build.build_log(name).splitlines():
            entry = re.search(r"entry function '\S*?((?:attn|adam|gemm)_\w+?"
                              r"kernel)(\w*)'", line)
            if entry:  # the kernel and its mangled template arguments
                log("ptxas %s: %s<%s>" % (name, entry.group(1),
                                          entry.group(2)[:12]))
            elif any(w in line for w in ("registers", "spill", "error")):
                log("ptxas %s:   %s" % (name, line.strip()))

    t_start = time.time()

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        log("phase %s: %.1f s (%.1f s since the build ended)"
            % (name, time.time() - t0, time.time() - t_start))
        return out

    def uniter_large(work, synth, passlog):
        from meme_challenge_tpu_torch.ops import attention as A

        timed("uniter-large card vs CPU", large_parity_phase, torch, synth,
              A)
        large = timed("uniter-large kernels", large_kernel_phase, torch, A)
        large_launches = timed("uniter-large CLIs", large_cli_phase, torch,
                               work, synth, passlog, A)
        timed("uniter-large steps", large_step_phase, torch, synth)
        timed("uniter-large repeat gate", repeat_gate_phase, torch, synth)
        return large, large_launches

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    if "--uniter-large-only" in argv:
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "build"), prefix="chip_smoke_") as work:
            uniter_large(work, make_dataset(work), PassLog())
        return
    if "--adam-only" in argv:
        timed("fused adam", adam_phase, torch)
        return
    if "--graph-only" in argv:
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "build"), prefix="chip_smoke_") as work:
            timed("train step graph", graph_gate_phase, torch,
                  make_dataset(work))
        return
    if "--list-only" in argv:
        timed("gemm list", gemm_list_phase, torch)
        timed("list counter", list_counter_phase, torch)
        return
    if "--expert-only" in argv:
        expert = timed("expert gemm", expert_gemm_phase, torch)
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "build"), prefix="chip_smoke_") as work:
            expert_launches = timed("moonlight CLI", moonlight_cli_phase,
                                    torch, work, make_dataset(work),
                                    PassLog())
        log(json.dumps({"kernels": [expert_entry(expert, expert_launches)]}))
        return
    if "--gemm-only" in argv:
        timed("gemm", gemm_phase, torch)
        timed("gemm list", gemm_list_phase, torch)
        timed("list counter", list_counter_phase, torch)
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "build"), prefix="chip_smoke_") as work:
            timed("train step graph", graph_gate_phase, torch,
                  make_dataset(work))
        return
    kernels = timed("kernels", kernel_phase, torch)
    adam = timed("fused adam", adam_phase, torch)
    gemm = timed("gemm", gemm_phase, torch)
    timed("gemm list", gemm_list_phase, torch)
    expert = timed("expert gemm", expert_gemm_phase, torch)
    if "--kernels-only" in argv:
        return
    watch_optimizer_steps()
    passlog = PassLog()
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, "build"), prefix="chip_smoke_") as work:
        synth = make_dataset(work)
        timed("train step graph", graph_gate_phase, torch, synth)
        timed("list counter", list_counter_phase, torch)
        timed("inference", inference_phase, torch, work, synth, passlog)
        launches = timed("train", train_phase, torch, work, synth, passlog)
        cv_launches, cv_epochs = timed("crossval", crossval_phase, torch,
                                       work, synth, passlog)
        timed("grad", grad_check, torch, synth)
        timed("remat", remat_check, torch, synth)
        for dtype in ("float32", "bfloat16"):
            timed("breakdown " + dtype, train_breakdown, torch, synth, dtype)
        from meme_challenge_tpu_torch.ops import attention as A

        timed("fold-parallel kernels", fold_kernel_checks, torch, A)
        fold_launches = timed("fold-parallel CLI", fold_cli_phase, torch,
                              work, synth, passlog, cv_epochs)
        timed("multi-device", multidevice_phase, torch, work, synth,
              passlog)
        timed("fold-parallel grad", fold_grad_check, torch, synth)
        timed("fold-parallel steps", fold_step_phase, torch, synth)
        timed("pretrain heads", pretrain_heads_check, torch, synth, A)
        pre_launches, fp32_dir = timed("pretrain CLI", pretrain_cli_phase,
                                       torch, work, synth, passlog, A)
        timed("pretrain resume", pretrain_resume_phase, torch, work, synth,
              fp32_dir)
        handoff = timed("pretrain handoff", pretrain_handoff_phase, torch,
                        work, synth, passlog, A, fp32_dir)
        timed("pretrain steps", pretrain_step_phase, torch, synth)
        timed("text/oscar card vs CPU", text_parity_phase, torch, synth, A)
        timed("text steps", text_step_phase, torch, synth, A)
        text_launches = timed("text/oscar CLIs", text_cli_phase, torch,
                              work, synth, passlog, A)
        expert_launches = timed("moonlight CLI", moonlight_cli_phase, torch,
                                work, synth, passlog)
        det_cfg, det_state, det_images = detector_setup(torch)
        timed("extraction card vs CPU", extract_check_phase, torch, det_cfg,
              det_state, det_images)
        ext_launches = timed("extraction CLI", extract_cli_phase, torch,
                             work, det_cfg, det_state, det_images, synth, A)
        timed("extraction time", extract_time_phase, torch, det_cfg,
              det_state, det_images)
        timed("extraction visualizer", visualize_phase, torch, work,
              det_cfg, det_images)
        timed("detector training card vs CPU", det_train_check_phase, torch,
              det_cfg, det_state, det_images)
        timed("detector training CLI", det_train_cli_phase, torch, work,
              det_cfg, det_state, det_images)
        timed("detector training time", det_train_time_phase, torch,
              det_cfg, det_state, det_images)
        del det_state
        large, large_launches = uniter_large(work, synth, passlog)
    timed("ensemble", ensemble_scale_phase, torch)
    # the recipe's kernel and dtype also ran the crossval and fold-parallel
    # phases: their launches count with the train phase's
    for key in cv_launches:
        total = launches[key] + cv_launches[key] + fold_launches[key]
        log("launches %s[%s]: train phase %d + crossval phase %d + "
            "fold-parallel phase %d = %d"
            % (key[0], key[1], launches[key], cv_launches[key],
               fold_launches[key], total))
        launches[key] = total
    # phase 10's CLI runs (10b, 10d) count too; 10a compares with the plain
    # versions, 10c runs in processes of its own, 10e measures
    for phase in (pre_launches, handoff):
        for key, n in phase.items():
            log("launches %s[%s]: + pretraining phase %d = %d"
                % (key[0], key[1], n, launches[key] + n))
            launches[key] += n
    # phase 11c's Oscar CLI runs count too; 11a compares with the plain
    # versions
    for key, n in text_launches.items():
        log("launches %s[%s]: + Oscar CLI phase %d = %d"
            % (key[0], key[1], n, launches[key] + n))
        launches[key] += n
    # phase 12b's UNITER forward on the extracted features counts too;
    # 12a and 12c run no attention kernel
    for key, n in ext_launches.items():
        log("launches %s[%s]: + extraction hand-off forward %d = %d"
            % (key[0], key[1], n, launches[key] + n))
        launches[key] += n
    # phase 15c's UNITER-large CLI runs count too; 15a and 15b compare with
    # the plain versions, 15d and 15e measure and gate
    for key, n in large_launches.items():
        log("launches %s[%s]: + UNITER-large CLI phase %d = %d"
            % (key[0], key[1], n, launches[key] + n))
        launches[key] += n

    # "route" is the kind of kernel (hand-written CUDA C++); "body" is the
    # CUDA body the route rule picked at the main path's shape, the one the
    # counted launches went through (check_route_counts)
    entries = []
    for (name, dtype), r in kernels.items():
        entries.append({
            "name": "%s[%s]" % (name, dtype), "route": "cuda",
            "body": r["route"], "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[(name, dtype)],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "ms_dropout": r["ms_dropout"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_ms_dropout": r["library_ms_dropout"],
            "library_max_abs_err": r["library_max_abs_err"],
            # phase 15b: the same kernel at UNITER-large's shapes
            "uniter_large": large[(name, dtype)]})
    # the fused Adam update: launches from the CLI phases that held them to
    # their optimizer steps (check_adam_launches), times from phase 3b at
    # UNITER-base's leaves (UNITER-large's under "uniter_large"); "plain" is
    # the _foreach_* chain the kernel is bit-equal to
    for tag, n in ADAM_MAIN_PATH.items():
        log("launches adam_update_kernel[float32]: %s %d" % (tag, n))
    entries.append({
        "name": "adam_update_kernel[float32]", "route": "cuda",
        "body": "bf16 moments", "source": SOURCE["fused_adam"],
        "replaces": None, "launches": sum(ADAM_MAIN_PATH.values()),
        "max_abs_err": 0.0, "ms": adam["uniter-base"]["kernel_ms"],
        "plain_ms": adam["uniter-base"]["chain_ms"],
        "bound_ms": adam["uniter-base"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "library_none": ADAM_NO_LIBRARY,
        "uniter_large": {k: adam["uniter-large"][k] for k in (
            "kernel_ms", "chain_ms", "bound_ms", "leaves", "params")}})
    # the 3xTF32 GEMM: launches by product of the CLI runs the attention
    # entries count (count_gemm_launches; a replayed step's GEMMs count at
    # each replay, its capture's not), times from phase 3d at UNITER-base's
    # (N, K) = (768, 768) forward, the six shapes' sums beside them
    gemm_launches = {}
    for tag, counts in GEMM_MAIN_PATH.items():
        log("launches gemm_tf32x3_kernel[float32]: %s %s"
            % (tag, json.dumps(counts)))
        for k, n in counts.items():
            gemm_launches[k] = gemm_launches.get(k, 0) + n
    log("launches gemm_tf32x3_kernel[float32]: main-path CLI runs %s"
        % json.dumps(gemm_launches))
    main_gemm = gemm["shapes"]["uniter-base forward M%d N768 K768"
                               % GEMM_ROWS]
    entries.append({
        "name": "gemm_tf32x3_kernel[float32]", "route": "cuda",
        "body": "3xTF32 wgmma", "source": SOURCE["linear_tf32x3"],
        "replaces": None, "launches": gemm_launches,
        "max_abs_err": main_gemm["max_abs_err"], "ms": main_gemm["ms"],
        "plain_ms": main_gemm["plain_ms"], "bound_ms": main_gemm["bound_ms"],
        "bound_by": main_gemm["bound_by"],
        "library_ms": main_gemm["library_ms"], "six_shapes": gemm["sums"]})
    # the grouped expert GEMM: launches by product of phase 11d's CLI run,
    # times from phase 3e
    entries.append(expert_entry(expert, expert_launches))
    # the card again, near the end: long logs are often read from the tail
    log("card: " + card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
