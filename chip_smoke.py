#!/usr/bin/env python3
"""Drive the PyTorch port's eval forward, MAE pretrain step and pretraining
engine, classifier fine-tune step (with and without ``BENCH_ATTN_PROJ=1``),
its two attention functions of ``ops`` that no model route calls, its
standalone eval CLI, its fine-tune engine, exp1's two arms from their
weight files, the dense model, the upstream MAE fine-tune and linear
probe, the pack tools with exp5b's 15,840-row evaluation, exp1's
seed-trio sweep through the port's scripts with its report, the
fine-tune engine as two data-parallel ranks, the native JPEG decoder
under the eval CLI and the pretraining engine on frames of SUN's size, and
the fp32 runs (``amp: false``, ``PretrainSettings.precision = "fp32"``) on
their own kernels, the fusion knobs' and ``BENCH_ATTN_PROJ=1``'s included,
and a ViT-B/16 at 384 px (577 tokens) in bf16 on the key-tile attention
kernels, with and without ``BENCH_ATTN_PROJ=1``, on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

(``--kernels-only`` stops after phase 2, for work on a kernel.)  Phases:

1. Device and build: requires CUDA, prints the card's name and power limit,
   builds the CUDA kernels from ``ssl4polyp_tpu_torch/ops/csrc``.
2. Each kernel against its plain torch version on the card, in bf16, at the
   eval, pretrain and fine-tune paths' shapes, forward and backward: max
   error against the stated tolerance (the AdamW kernel bit for bit, on the
   classifier's and the MAE's parameter lists), the kernel's and the plain
   version's times from CUDA events, beside them the time of the PyTorch
   library call for the same function where there is one (timed only; the
   port never calls it), and the least time the card could take (the larger
   of the bytes over its memory rate and the operations over its peak rate),
   at each shape a kernel is timed at: the classifier's, the MAE decoder's
   and the MAE encoder's.  The summary quotes the classifier's shape.  The
   attention backward prints which of its paths each shape takes, its first
   design's time beside its own, and its time with parts left out (wrong
   results, times only: where its time goes).  The
   LayerNorm backward is also held and timed with a residual's gradient
   folded in, and its two launches (the row kernel, the sum of the blocks'
   partials) are timed apart; the attention+projection backward's four
   phases are timed apart, each beside its bound (its dW phase also on its
   first design, through a phase bit), and its forward is timed
   without its attention arithmetic, without its projection's products and
   without both (wrong results, times only: where its time goes).  The fused
   MLPs (with and without the LayerNorm) print, at the classifier's and the
   MAE decoder's shapes, their first design's time (through the kernel's
   probe, in the same process, held to the plain version too), the unfused
   bf16 chain, and their times with parts left out and with other cluster
   sizes; their reruns and their output without h are bit-identical.  LN+QKV
   prints, at the same two shapes, its first design's time (through its
   probe, held to the plain version), the unfused chain, cuBLAS's
   ``torch.addmm`` alone on a ready normalised row (timed only), and its
   times with parts left out and at the other tile width; its reruns and
   its C entry point for callers without scratch are bit-identical, and
   with W = I its output (the normalised row itself) is bit-equal to the
   first design's.  Attention over separate q, k, v prints, at the
   classifier's and the MAE decoder's shapes, its forward's first design's
   time (through the kernel's probe, held to the plain version too) and its
   times with parts left out; its forward and backward reruns are
   bit-identical.  Where attention.cu's kernels stop, it runs on the key
   tiles in its layout in bf16 past 256 tokens (577: the classifier's and
   the MAE decoder's heads) and on the fp32 kernels in its layout (197 and
   577 tokens, both shapes): each against its plain version (the attention
   limits in bf16, the fp32 fractions in fp32), reruns bit-identical, timed
   beside the plain versions, SDPA in the same dtype and its backward
   (timed only) and the bound, with the key tiles' gradient pass's shared
   memory and resident blocks an SM.  The QKV projection with the attention core prints the
   same at both shapes (its forward's first design, the plain version and
   ``F.linear`` + SDPA beside the bound, then its forward without the
   softmax arithmetic, without the projection's products, without the
   prefetch, and the projection alone; its backward beside its first
   design's, held to the plain version too, and each launch of both designs
   timed alone beside its bound), with both ``softmax_f32`` settings, a
   ``valid_len`` below the token count and an odd head count at hd 32; its
   forward and backward reruns are bit-identical.  Last, the fp32 kernels
   of the default route (attention forward and backward, fc1+GELU,
   LayerNorm forward and backward, with and without a residual's gradient)
   against their plain fp32 versions at the classifier's, the MAE decoder's
   and the MAE encoder's shapes, with ``valid_len`` below N, 1 and 256
   tokens, and a ViT-B/16 at 384 px (577 tokens, ``valid_len`` 500): max
   |kernel - plain| within 2e-5 of max |plain| for outputs and 1e-4 for
   gradients (cuBLAS held to fp32: TF32 off), reruns bit-identical, the
   attention backward from the forward's saved output and log-sum-exp
   bit-equal to its launch from (qkv, dout) alone; their times beside the
   plain versions', the one PyTorch call's in fp32 (SDPA, with the keys'
   mask where ``valid_len`` cuts them, and its backward, ``F.linear`` +
   ``F.gelu``, ``F.layer_norm`` and its backward) and the bound at 67
   TFLOP/s fp32 or 3.35 TB/s.  Then the fusion knobs' fp32 kernels: the
   fused MLP and the fused LN+MLP (h written and not) at ViT-B's and the
   MAE decoder's widths over 12,608 rows and at 37 rows with a last NF
   chunk of 32 and of 96 columns, and LN+QKV at both widths, at 37 rows of
   64 and at K 576, each within 2e-5 of max |plain| and rerun
   bit-identical, timed beside the plain versions, the fp32 chains of
   PyTorch calls (``F.layer_norm``, ``F.linear``, ``F.gelu``; no one call
   computes either function) and the fp32 bound.  Then the attention+
   projection fold in fp32 at the classifier's and the MAE decoder's shapes
   and the QKV projection + attention in fp32 at the classifier's, each
   also with ``valid_len`` below N, at 1 and 300 tokens and at hd 32 with
   an odd head count, forward and backward within 2e-5 and 1e-4 of max
   |plain|, reruns and the backward from the inputs alone bit-identical,
   timed beside the plain versions, fp32 SDPA + ``F.linear`` and that
   pair's autograd backward, and the fp32 bound.  The bf16 attention past
   256 tokens (the key tiles), forward and backward, at a ViT-B/16's shapes
   at 384 px (577 tokens: the classifier's, also with ``valid_len`` 500,
   and the MAE decoder's), at 257 and at 1,025 tokens: within the
   attention limits, reruns bit-identical, timed beside the plain versions,
   bf16 SDPA and its backward and the bound; the key tiles' forward and
   statistics pass timed alone beside their first design (through the
   probe entry point, in the same process) at the classifier's shape with
   and without a bias and at the decoder's: each against its plain version
   (the statistics within STATISTICS_RTOL), reruns bit-identical, beside
   the plain versions, bf16 SDPA and the bound; and the key tiles' backward
   beside the first design at 209 and 256 tokens, where the first design
   runs today (timed only).  Then attention with the output projection and
   the QKV projection with attention past 256 tokens in bf16 (their
   compositions on the key tiles), forward and backward, at a ViT-B/16's
   shapes at 384 px (the classifier's, also with ``valid_len`` 500, and the
   MAE decoder's) and at 300 tokens: within their 197-token limits, launch
   counts exact, reruns bit-identical, timed beside the plain versions,
   SDPA with ``F.linear`` and that pair's autograd backward, and the bound.
3. The eval forward: a full-width ViT-B/16 2-class classifier, weights from
   a numpy-seeded tree in the JAX package's layout, answers 8 requests of 64
   uint8 224x224 images through ``make_forward_fn``.  Per request, attention
   and fc1+GELU must launch exactly 12 times and LayerNorm 25 (no backward
   kernel); the logits must be finite and match the same forward with every
   kernel swapped for its plain version.  Prints images/s for both, median
   and range over 5 repeats of 10 requests (the plain path 1).  Then the
   same classifier built
   under ``BENCH_ATTN_PROJ=1``: 12 launches of the attention+projection
   kernel and none of the attention kernel per request, logits against the
   plain path's and the unfolded forward's.
4. The MAE ViT-B/16 pretrain step at full width, batch 64: weights from a
   numpy-seeded JAX-layout tree through ``mae_state_dict_from_jax``; step 1's
   loss and every parameter's gradient against the plain step's; 3 steps
   run twice from one seed and one state after ``set_determinism``, every
   master, both moments and the compute copy bit for bit (on a difference,
   one more step under torch's deterministic mode names the ops); then 6
   steps through ``make_pretrain_step`` with exact launch counts per step
   (the AdamW kernel's 4 among them), finite losses and parameters and both
   sin-cos tables unchanged; then the same 6 steps from the same state with
   every kernel swapped for its plain version.  Prints images/s for both,
   median and range over 5 repeats of 10 further steps (the plain path 1),
   and the model
   TFLOP/s at the median.  Then the model built under ``BENCH_ATTN_PROJ=1``
   (the decoder folds, the encoder at 50 tokens does not): step 1 against
   the plain step, and 2 steps with exact launch counts.
4b. The pretraining engine at full width through ``cli_main``, on 130 JPEG
   frames (two steps of 64 an epoch): run A for 3 epochs with asynchronous
   saves, saving at its last; run B, the same settings elsewhere, gets
   SIGTERM in epoch 1's last step (a wrapped ``RunLogger.scalar`` raises
   it), saves and returns, then resumes with ``--resume auto``.  A's and
   B's last checkpoints must be equal bit for bit (params, mu, nu, step),
   B's log must hold epochs 0 and 2, and the 12 steps must launch each
   kernel of the step exactly.  Then ``build_classifier`` with
   ``ss_framework: mae`` and A's checkpoint: its encoder equal to the
   checkpoint's masters, one eval batch through the kernels against the
   plain forward.  Prints each save's host snapshot and write seconds and
   each run's time outside the step, beside the card's name and power
   limit.
5. The ViT-B/16 classifier's fine-tune step at full width, batch 64 (on-device
   augmentation, BCE, backward, AdamW with fine-tune scales), weights from a
   numpy-seeded JAX-layout tree, under its four kernel configurations: the
   default (fc1+GELU), ``mlp_fusion="full_ln"`` with ``qkv_ln_fusion`` (the
   LN+MLP and LN+QKV kernels), ``mlp_fusion="full"`` (the fused MLP), and
   the default under ``BENCH_ATTN_PROJ=1`` (the attention+projection kernel
   forward and backward, 12 each per step, and no attention kernel).
   For each: step 1's loss and every gradient against the plain step's; 6
   steps with exact launch counts per step, finite losses and parameters;
   2 steps under the ``head+1`` regime, after which every frozen parameter
   keeps its bits; images/s for the kernels and the plain path, median and
   range over 5 repeats of 10 steps (the plain path 1).
6. The attention functions over a real activation: the eval classifier's
   patch embedding, position table and block 0's first LayerNorm turn one
   batch of 64 images into a (64, 197, 768) activation; block 0's attention
   core then runs three ways on block 0's own QKV weight and bias: the
   model's route (the bare product, then the QKV attention kernel),
   ``fused_qkvproj_attention`` and ``linear`` -> heads -> ``fused_attention``
   -> merge.  Outputs and, for one fixed output gradient, the gradients of
   the activation, the weight and the bias must agree within the stated
   tolerances, each route with its plain version too; each new kernel must
   launch exactly once forward and once backward per pass, and not at all
   while the plain versions run.  Then the three at 384 px (a (64, 577,
   768) activation), each on the key tiles (``fused_attention``'s in its
   own layout), against their plain versions and the model's route, one
   forward and one backward launch a pass; then the three in fp32 on the
   224 px activation and weights, on their fp32 kernels, against their
   plain versions and the model's route within 2e-5 (outputs) and 1e-4
   (gradients) of max |plain|.
7. The standalone eval CLI at full width: a synthetic pack of 224 px JPEG
   frames (128 a split) and a ViT-B/16 checkpoint (numpy-seeded JAX-layout
   tree, ``model_cfg`` and a thresholds block in its meta) are written with
   the port's own writers; ``cli_main([... "--export-outputs"])`` runs in
   process on the card.  Per batch of 64 the launch counts must be the eval
   forward's; ``n_frames`` 128, finite metrics, the stored tau, ``logits.npz``
   equal to ``make_forward_fn`` on the same decoded frames, and every output
   file present.  Prints frames/s end to end (checkpoint read and decode
   included), of the forward alone, and the host's and the card's shares.
8. The fine-tune engine at full width through its CLI (``cli_main``) with
   ``config/exp/exp2.yaml``'s SSL-colon arm, seed 47: a synthetic sun_full
   pack of 224 px JPEG frames (train 256, val 128, test 128) and an MAE
   ViT-B/16 checkpoint (numpy-seeded JAX-layout tree) where
   ``config/model/ssl_colon.yaml`` names it are written with the port's own
   writers.  Run A: 3 epochs of 4 steps of 64, 2 validation batches an
   epoch and 2 test batches; before step 1 the encoder equals the MAE
   checkpoint's masters bit for bit; exact launch counts (phase 5's per step
   times 12, the eval forward's per batch times 8); every artifact written,
   the outputs CSV's SHA-256 the one ``metrics.json`` records, tau in [0, 1]
   and the best checkpoint's.  Run A', the same into another directory:
   every checkpoint bit-equal to A's (params, mu, nu, step) and the outputs
   CSV byte-equal.  Run B: ``--resume`` in a copy of A's output with a
   fourth epoch, from the best checkpoint's masters, moments and step bit for
   bit at its epoch + 1.  Then the eval CLI on A's best checkpoint and test
   split: tau and the test metrics within 1e-6 of A's ``test_primary``.
   Prints each run's wall time, its steps' time and images/s, and the time
   outside the steps (model build with the MAE read, validation, test,
   reload, exports, each save), beside the card's name and power limit.
9. exp1's arms from their weight files and the dense model, on phase 8's
   pack: an upstream-layout MAE ``.pth`` (``torch.save`` of the encoder and
   decoder under timm's MAE names with an ``argparse.Namespace`` as
   ``args``) and a big_vision AugReg ``.npz`` (a 1000-way head), numpy-seeded,
   where ``config/model/ssl_imnet.yaml`` and ``sup_imnet.yaml`` name them
   under a temporary ``--checkpoint-root``.  ``cli_main`` runs
   ``config/exp/exp1.yaml``'s ``sup_imnet`` and ``ssl_imnet`` arms for one
   epoch of 3 steps of 64: the factory builds that scheme, the masters
   before step 1 equal the file's tensors bit for bit, the launch counts
   are exact, and the eval CLI on the run's best checkpoint gives its test
   metrics within 1e-6.  Then the dense classifier (``dense_readout:
   project``) from the ``.pth``: 32 images through its kernels (the tap
   path's 12 attention, 24 LayerNorm and 12 fc1+GELU launches) to (32, 112,
   112, 2) fp32 logits, against the same model with every kernel plain on
   the card (which launches none), with the forward's median time.
10. The upstream MAE fine-tune and linear probe (``training/mae_finetune.py``)
   on phase 8's pack, from one ViT-B/16 classifier that the factory builds
   from an MAE ``.pth`` written where ``config/model/ssl_imnet.yaml`` names
   it.  ``run_mae_finetune`` with the upstream recipe (layer decay 0.75,
   weight decay 0.05, label smoothing 0.1, Mixup 0.8 / CutMix 1.0, erasing
   0.25; 2 epochs of 4 steps of 64): step 1's loss and every gradient
   against the plain step's on one set of draws, one AdamW pass with the
   layer decay's scales bit-equal to the plain update, two runs bit-equal,
   the classifier's own parameters still the file's after both, every
   tensor moved (the position table too), exact launch counts.
   ``run_linear_probe`` (LARS, one epoch of 4 steps): the encoder bit-equal
   to the file's, the head moved, two runs bit-equal, the encoder's forward
   kernels only.  Prints each run's images/s, over its wall and over its
   steps after the first, and the phase's seconds.
11. The pack tools (``ssl4polyp_tpu_torch/polypdb``) and exp5b at the
   study's size: ``build_synthetic_sun_root`` (what ``polypdb synth-root``
   calls) writes a SUN root of 224 px JPEG frames, 45 positive cases of 33
   and 3 negative videos of 495; ``polypdb sun build --cases-per-split 15
   15 15`` and ``polypdb sun perturbations`` run through the port's CLI
   (990 / 990 / 990 rows, then 15,840), each manifest's rows, counts,
   assertions and hashes checked and every row's seed the HMAC rule's.
   ``config/exp/exp1.yaml``'s ``sup_imnet`` arm through ``cli_main`` on the
   built sun_full (hashes verified, an AugReg ``.npz``, one epoch of 4
   steps of 64, the full 990-frame val and test) is the canonical SUN
   parent under a temporary ``classification`` root; ``config/exp/exp5b.yaml``'s
   same arm and seed through ``cli_main`` finds it there and evaluates all
   15,840 rows, perturbations rendered in the loader: all 16 grid tags and
   ``ALL-perturbed`` in ``metrics.json``, the frozen tau bit-equal to the
   parent's sun-val tau, the 990 clean rows' probabilities within 1e-6 of
   the parent's test exports frame by frame, exact launch counts (the
   parent's steps and 32 eval batches, exp5b's 248).  Prints the seconds
   to write the root, to build each pack and to hash, and the exp5b test
   evaluation's rows/s over its wall (host clock), beside the card's name
   and power limit.
12. exp1's seed-trio sweep and report through the port's own scripts, as a
   user runs them, on phase 8's pack: an AugReg ``.npz`` and an MAE
   ``.pth`` from numpy seeds where ``config/model/{sup_imnet,ssl_imnet}.yaml``
   name them; ``bash scripts/torch/run_exp1.sh`` in a subprocess runs
   ``sup_imnet`` and ``ssl_imnet`` over seeds 13, 29 and 47 (one epoch of 2
   steps of 64, 1 val and 1 test batch each), then stages the reporting
   inputs: exit 0, six summaries with the stems
   ``{SupImnet,SslImnet}_SUNFull_s{13,29,47}``, and each run's metrics file,
   test outputs, ROC and PR curves under
   ``reporting_inputs/exp1_sun_baselines_sup_vs_ssl/``.  ``python -m
   ssl4polyp_tpu_torch.analysis.exp_reports exp1`` on the staged tree, seed
   check on: the markdown, CSV and manifest written, ``n_runs`` 6, the
   ``sup_imnet->ssl_imnet`` deltas with ``auroc`` and ``f1``.  Then
   ``SupImnet_SUNFull_s13`` again through ``cli_main`` in this process, under
   torch's own backend flags as the sweep's processes have them: exact
   launch counts (2 steps and 2 eval batches) and its test outputs CSV
   byte-equal to the sweep's, which ties the subprocesses' results to the
   kernels.  Prints the sweep's wall, each run's wall with its parts (build,
   steps, evaluation, saves, reload and exports, the rest), the staging
   and the report's seconds, beside the card's name and power limit.
13. The data-parallel path (``ssl4polyp_tpu_torch/parallel``) on the card's
   one device: ``python -m torch.distributed.run --nproc-per-node 2`` starts
   this script's rank worker (``--rank-worker``) twice under gloo, which
   reduces CUDA tensors through the host (NCCL needs a device a rank), and
   each rank runs the fine-tune CLI on ``config/exp/exp1.yaml``'s
   ``sup_imnet`` arm at full width from phase 12's AugReg ``.npz`` on phase
   8's pack: one epoch of 4 steps at a global batch of 64 (32 a rank), 1 val
   and 2 test batches a rank.  Each rank's launches exact (its own counter,
   from 0 before the run); step 1's all-reduced loss and gradients against
   rank 0's recompute in one process on the gathered 64 rows; rank 1 wrote
   nothing under the run's directories (the interpreter's audit hooks);
   tau, epochs and the best monitor equal on both ranks; the gathered test
   outputs in the frame order of the one-process eval CLI on the saved
   checkpoint, probabilities within 1e-6.  Then one fine-tune step under a
   one-rank nccl group: its all-reduces through NCCL, the updated masters
   bit-equal to the same step without a group.  Prints the two ranks' wall,
   each rank's steps/s and the all-reduce's share of a step, beside the
   card's name and power limit.
14. The native JPEG decoder (``ssl4polyp_tpu_torch/native``), which every
   loader above has read through (their frames are 224 px, where its bytes
   are PIL's).  It prints g++'s version, the machine, the libjpeg that PIL
   maps with its version string and the first build's seconds.  On frames
   written with PIL from numpy seeds (1240x1080, 1920x1080, 1350x1080,
   720x576, 1280x1024, 384x288 and 224x224, each at 4:2:0 and 4:4:4, one
   progressive and one grayscale): ``decode_resize`` at 224 and
   ``decode_crop_resize`` on RandomResizedCrop draws byte for byte against
   ``native/reference.py`` on PIL's ``Image.draft`` decode wherever the scale
   is one ``draft`` reaches (1/8, 2/8, 4/8, 8/8), ``jpeg_dims`` against PIL's
   size, and a CMYK frame refused, then filled by the loader's PIL retry.
   Rates on 256 frames of 1240x1080 (median and range of 5 passes, 8
   threads, warm page cache): ``decode_resize_batch_status``, PIL's
   ``decode_frame`` on a thread pool, ``HostDataLoader`` alone natively and
   under ``SSL4POLYP_NATIVE_DECODE=0``, and ``PretrainLoader``'s crop path
   both ways.  Then the eval CLI (ViT-B/16, batch 64) over a pack of those
   256 frames three times, natively, under ``SSL4POLYP_NATIVE_DECODE=0`` and
   natively again: frames/s from the command to ``eval_results.txt``, the
   two native runs' logits bit-equal, the PIL run's logits other, every
   native frame decoded without a PIL retry.  Then the pretraining engine
   (MAE ViT-B/16, batch 64) for 2 steps on those frames through the crop
   path, every crop native.  The launches of both paths exact.
15. fp32 compute at full width, on the fp32 kernels (cuBLAS's TF32 off,
   asserted): the ViT-B/16 classifier's fine-tune step in fp32 (step 1's
   loss within 1e-5 and every gradient within 1e-4 relative L2 distance of
   the plain step's, two steps twice from one state bit-equal, images/s
   over 10 steps), the AdamW kernel with the compute copy the masters
   themselves (no copy written) bit-equal to its plain version over 3
   steps, the eval forward in fp32 (logits within 1e-4 of max |plain|,
   images/s over 10 requests), the dense ViT-B/16 + DPT forward in fp32 at
   batch 2 bit-equal under torch's default cuDNN TF32 setting and under
   this script's (its convolutions turn TF32 off for their own calls), and
   its gradients bit-equal under both (the convolutions' backward turns
   TF32 off too; cuDNN's deterministic mode on for both runs), the
   MAE ViT-B/16 pretrain step under
   ``PretrainSettings(precision="fp32")`` (the fine-tune step's checks), a
   fine-tune engine run of ``config/exp/exp1.yaml``'s ``sup_imnet`` arm
   with ``amp=false`` (an fp32 classifier from an AugReg ``.npz``, 2 steps,
   1 val and 1 test batch) and the eval CLI's ``evaluate`` on its best
   checkpoint with ``compute_dtype`` fp32 (tau and the test metrics within
   1e-6 of the run's).  Under the fusion knobs, the fine-tune step's checks
   again under ``mlp_fusion="full"``, under ``"full_ln"`` with
   ``qkv_ln_fusion`` and under ``BENCH_ATTN_PROJ=1`` (12 attention+
   projection launches forward and 12 backward a step, no attention
   launch), the eval forward under ``BENCH_ATTN_PROJ=1`` (12 attention+
   projection launches a request, logits against the unfolded fp32
   forward's within 1e-4 of max |unfolded|), the pretrain step's under
   ``"full_ln"`` with ``qkv_ln_fusion`` and under ``BENCH_ATTN_PROJ=1``
   (the decoder's 8 blocks on the fused or the folded kernels, the
   encoder's 50 tokens on the default route) and the engine run again with
   ``mlp_fusion`` "full" given to its ``build_classifier``.  Every path's
   launches exact: the fp32 kernels, the AdamW kernel, and no bf16 kernel.
16. A ViT-B/16 at 384 px in bf16 (577 tokens, past the 256 that
   ``qkv_attention.cu`` holds on chip, so every block's attention runs on
   the key tiles of ``qkv_attention_tiles.cu``), batch 64: the eval forward
   from host uint8 to logits (12 key-tile launches a request; the logits
   held against one fp32 forward of the same weights through the plain
   path, at most LONG_LOGITS_RATIO times as far from it as the plain bf16
   paths, folded or not), the fine-tune step
   under ``fc1``, ``full`` and ``full_ln`` with ``qkv_ln_fusion`` (577
   tokens count as padded to 584, so the knobs apply; step 1 against the
   plain step's within the fine-tune limits, 12 key-tile launches forward
   and 12 backward a step) and the MAE ViT-B/16 pretrain step (encoder 145
   tokens on ``qkv_attention.cu``, decoder 577 on the key tiles; step 1
   within the pretrain limits), each with exact launches and images/s over
   3 repeats of 3; then under ``BENCH_ATTN_PROJ=1``, every classifier block
   and the MAE decoder's 8 folding the projection into attention on the
   composition past 256 tokens: the eval forward (12 fold launches a
   request and no other attention launch, the logits held as above), the
   fine-tune step under ``fc1`` (12 fold
   launches forward and 12 backward a step) and the pretrain step (the
   decoder's 8 and 8 on the fold, the encoder's 145 tokens on the default
   route), each with step 1 or the logits held as above, exact launches
   and images/s.
   The script's own wall time is printed before the two result lines.

The last two lines of standard output are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero,
and without a CUDA device the script exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import platform
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from ssl4polyp_tpu_torch import native, ops
from ssl4polyp_tpu_torch.data.loader import HostDataLoader
from ssl4polyp_tpu_torch.data.packs import create_classification_datasets
from ssl4polyp_tpu_torch.evaluation import eval_classification
from ssl4polyp_tpu_torch.evaluation.evaluate import evaluate_split
from ssl4polyp_tpu_torch.models import layers
from ssl4polyp_tpu_torch.models.factory import get_imagenet_or_random_vit
from ssl4polyp_tpu_torch.models.mae import MAE, MAEConfig
from ssl4polyp_tpu_torch.models.pos_embed import sincos_2d
from ssl4polyp_tpu_torch.models.vit import ViTConfig
from ssl4polyp_tpu_torch.models.weights import mae_state_dict_from_jax
from ssl4polyp_tpu_torch.ops import (_build, adamw, attention, attention_block, attn_proj,
                                     layernorm, ln_linear, mlp, qkv_attention)
from ssl4polyp_tpu_torch.polypdb.synth import build_synthetic_pack
from ssl4polyp_tpu_torch.profiling import (FINETUNE_CONFIGS, REPEAT_CALLS, REPEATS,
                                           projection_fold, rates, spread)
from ssl4polyp_tpu_torch.training import optim
from ssl4polyp_tpu_torch.training.classification import (
    init_train_state,
    loss_and_grads,
    loss_settings,
    make_forward_fn,
    make_train_step,
    step_context,
)
from ssl4polyp_tpu_torch.data import augment
from ssl4polyp_tpu_torch.data.augment import draw_augment_params, normalize_batch
from ssl4polyp_tpu_torch.training.pretrain import loss_and_grads as pretrain_loss_and_grads
from ssl4polyp_tpu_torch.training.pretrain import (
    PretrainSettings,
    init_pretrain_state,
    make_pretrain_step,
    model_config,
)
from ssl4polyp_tpu_torch.training.schedules import warmup_cosine
from ssl4polyp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from ssl4polyp_tpu_torch.utils.determinism import set_determinism

SEED = 0
BATCH = 64
REQUESTS = 8
STEPS = 6
# |kernel - plain| <= atol + rtol * |plain|, elementwise, in bf16.  The plain
# attention makes the same roundings, so only fp32 summation order and expf
# differ: a flipped bf16 rounding of the output is 1 ulp, 2^-8 relative.  The
# plain fc1 rounds h to bf16 twice (product, bias add) and the kernel once,
# so h and y may differ by up to 2 bf16 ulps (2^-7 relative each).
ATTENTION_TOL = (1e-2, 1e-2)
FC1_TOL = (1e-2, 1.6e-2)
# The attention backward: the plain version makes the same roundings (W, dS,
# dqkv), so a rounding of dS that flips on an fp32 order difference moves
# dQ or dK by |k| or |q| times one bf16 ulp of dS, and a flipped output by an
# ulp: 2e-2 covers both at |dqkv| <= 5.  dbias sums B*N rows of each side's
# own dqkv in fp32: those flips, with random signs, against a column scale
# of hundreds, hence an atol relative to max|dbias|.
ATTENTION_BWD_TOL = (2e-2, 2e-2)
DBIAS_TOL = (2e-3, 2e-2)  # (atol as a fraction of max|plain|, rtol)
# LayerNorm: y and dx are rounded once from fp32 on both sides (one ulp);
# dweight and dbias are fp32 sums over up to 12,608 rows in another order,
# of terms up to ~30, whose rounding error grows like sqrt(rows) * 2^-24.
LN_TOL = (1e-2, 1e-2)
LN_PARAM_TOL = (5e-3, 1e-4)
# Logits after 12 blocks of such 1-ulp differences in the residual stream.
LOGITS_TOL = (5e-2, 5e-2)
# The logits at 577 tokens (phase 16) are held against one fp32 forward of
# the same weights through the plain path (TF32 off), not against the plain
# bf16 path: the kernels' worst |diff| from it may be at most
# LONG_LOGITS_RATIO times the larger of the two plain bf16 paths' own
# (unfolded and folded; long_logits_check).  At 577 tokens both sides of a
# kernel-against-plain comparison carry bf16 noise of the size of
# LOGITS_TOL: over seeds 0-7 on an H100 (scripts/torch/logits_margin_384.py)
# the plain bf16 paths sat 0.044-0.088 from the fp32 forward (0.59-1.28 of
# LOGITS_TOL), the kernels 0.042-0.071, folded or not, and kernels against
# plain took up to 1.034 of LOGITS_TOL (seed 7, folded).  The kernels' ratio
# read 0.71-1.07 (before and after the key tiles' redesign), so 1.5 sits
# 40 % above the worst reading.  What it catches is a fault that moves the
# logits past the network's own bf16 noise: the plain path with keys 512 ..
# 576 left out read 3.7-5.5.  What it cannot see overlaps the kernels'
# readings, so no limit separates them: one key left out read 0.99-1.20
# (phase 2's check against plain catches it, at 36 times ATTENTION_TOL),
# bf16 scores or the weights rounded before normalising, faults of one bf16
# ulp in attention's output, 0.82-1.04 (within ATTENTION_TOL at the kernel
# too; PERF.md §6).  LOGITS_TOL keeps serving 197 tokens.
LONG_LOGITS_RATIO = 1.5
# Step 1 of the pretrain step, kernels against plain: the loss after 20
# blocks of 1-ulp differences, relative; each parameter's gradient as the
# relative L2 distance ||g - g_plain|| / ||g_plain||.  On an H100 the loss
# differed by 4.0e-6 relative and the worst gradient by 3.3e-3 (a decoder
# fc2 weight), so the limits sit 25 and 4.5 times above those readings: a
# glue fault that moves a gradient by a few percent fails.  The K slice of
# each qkv bias is left out: its exact gradient is zero (softmax is
# invariant to a shift of the scores along k), so both sides hold rounding
# noise there.
LOSS_RTOL = 1e-4
GRAD_RTOL = 1.5e-2
# The fused kernels' plain versions make the same roundings (m, h, g, the
# output), so only fp32 summation order differs: one bf16 ulp where a
# rounding flips.
FUSED_TOL = (1e-2, 1e-2)
# The key tiles' statistics pass, each row's (max * log2(e), 1/sum, tmp),
# against its plain fp32 version: the sums run in another order and exp2 on
# the special function unit (2^-22 relative), so each column sits within
# STATISTICS_RTOL of its largest magnitude; with bf16 scores (False) a score
# whose rounding flips on that order moves by one bf16 ulp (2^-8 relative),
# and with it the max and a weight, hence the wider limit.
STATISTICS_RTOL = {True: 1e-4, False: 1e-2}
# Step 1 of the fine-tune step, kernels against plain, as for the pretrain
# step.  The classifier's loss is BCE on 64 logit pairs after 12 blocks of
# 1-ulp differences (the eval forward's logits differ by up to 6e-2), so it
# moves far more than the pretrain step's mean over 9,408 patches.  Over
# two runs on an H100 the loss differed by up to 5.2e-3 (fc1), 2.3e-3
# (full_ln+qkv_ln) and 8.8e-4 (full) relative, and the worst gradient by up
# to 1.4e-2, 1.8e-2 and 1.2e-2 (the cls token, which sums every row's): the
# limits sit 4.8 and 2.8 times above the worst readings.
# The attention+projection kernel: y is the attention output (one flipped
# bf16 ulp, times a row of W) through two more roundings on both sides; dqkv
# as the attention backward's.  dW and db are fp32 sums over all 12,608 rows
# in another order than the plain version's, of each side's own bf16 O, then
# rounded to bf16: an atol relative to max|plain|, as for dbias.
ATTN_PROJ_TOL = (1e-2, 1e-2)
ATTN_PROJ_PARAM_TOL = (5e-3, 2e-2)  # (atol as a fraction of max|plain|, rtol)
# Attention over separate q, k, v: the plain forward rounds where the kernel
# does (one flipped bf16 ulp); the plain backward keeps W and dS in fp32
# where the kernel carries them as two bf16 terms (2^-17 relative a term),
# far inside the one bf16 ulp of each rounded gradient: the attention limits.
# Projection + attention: qkv carries a flipped ulp (fp32 summation order of
# the projection) into the core on each side's own roundings, hence twice
# the attention limit on the output; dx, dw and db are sums of each side's
# own rounded dqkv over 3D columns or over all 12,608 rows: an atol relative
# to max|plain|, as for the other parameter sums.
QKVPROJ_TOL = (2e-2, 2e-2)
QKVPROJ_GRAD_TOL = (1e-2, 2e-2)  # (atol as a fraction of max|plain|, rtol)
# The three routes of block 0's attention core on a real activation.  The
# fused projection differs from the model's route by fp32 summation order in
# qkv alone: the same limits as kernel against plain.  The route through
# fused_attention also keeps W and dS unrounded in its backward (at hd 64 the
# scale 1/8 is a power of two, so the forward's scale placement rounds
# nothing): a bf16 ulp of dS per key, summed with random signs.  Gradients
# are held by their relative L2 distance to the model route's; the K slice of
# the bias gradient is left out (its exact value is zero).
ROUTE_OUT_TOL = (2e-2, 2e-2)
ROUTE_GRAD_RTOL = 2e-2
# The fp32 kernels against their plain fp32 versions: max |kernel - plain| as
# a fraction of max |plain|.  The plain versions make the same arithmetic in
# another summation order (cuBLAS, torch's softmax and reductions), about
# 1e-6 of the largest value a product or sum of a few hundred terms; a TF32
# product (10-bit mantissa, ~5e-4 a term) or a bf16 one misses by more than
# an order of magnitude.  Gradients carry two or three such sums in a row.
FP32_FWD_FRAC = 2e-5
FP32_GRAD_FRAC = 1e-4
# The card's published peaks (NVIDIA H100 SXM data sheet, dense): the bound
# of a kernel is the larger of its bytes over the memory rate and its
# operations over the rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
# Cycles the card spins before a timed batch (about 2 ms at 1.7 GHz): longer
# than the host takes to queue 20 launches of one kernel.
SPIN_CYCLES = 3_500_000
FT_LOSS_RTOL = 2.5e-2
FT_GRAD_RTOL = 5e-2
# Repeats of REPEAT_CALLS steps or requests for the plain paths' images/s
# (phases 3-5), a yardstick only: the script keeps its wall within its limit.
PLAIN_REPEATS = 1
FT_LR = 1e-4
FT_WEIGHT_DECAY = 0.05
CARD = ""  # the card's name and power limit, as nvidia-smi gives them
# torch's backend flags as the process started (matmul TF32, cuDNN TF32,
# bf16 reduced-precision reductions), before main() sets its own.
TORCH_DEFAULTS: tuple[bool, bool, bool] = (False, True, True)
NATIVE_BUILD_S = float("nan")  # the JPEG decoder's first build, load and check, s


def fail(message: str) -> None:
    raise SystemExit(f"chip_smoke: {message}")


def max_error(out: torch.Tensor, ref: torch.Tensor, tol: tuple[float, float], what: str) -> float:
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        fail(f"{what}: non-finite output")
    diff = (out - ref).abs()
    atol, rtol = tol
    if (diff > atol + rtol * ref.abs()).any():
        fail(f"{what}: max |diff| {diff.max().item()} exceeds atol {atol} + rtol {rtol}*|ref|")
    return diff.max().item()


def limit_share(out: torch.Tensor, ref: torch.Tensor, tol: tuple[float, float]) -> float:
    """The largest share of its limit ``atol + rtol * |ref|`` that an
    element's |out - ref| takes (1 is the limit)."""
    out, ref = out.float(), ref.float()
    atol, rtol = tol
    return ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()


def plain_fp32_logits(seed: int, tree: dict, requests: list[np.ndarray],
                      img_size: int) -> list[np.ndarray]:
    """The logits of one fp32 eval forward of the JAX-layout ``tree``'s
    classifier through the plain path, TF32 off for products and
    convolutions (each flag restored after)."""
    flags = (torch.backends.cuda.matmul, "allow_tf32"), (torch.backends.cudnn, "allow_tf32")
    saved = [getattr(module, name) for module, name in flags]
    for module, name in flags:
        setattr(module, name, False)
    try:
        clf = get_imagenet_or_random_vit(
            torch.Generator().manual_seed(seed), jax_params=tree, num_classes=2, device="cuda",
            img_size=img_size, compute_dtype=torch.float32)
        forward = make_forward_fn(clf, "cuda")()
        with plain_kernels():
            return [forward(images) for images in requests]
    finally:
        for (module, name), value in zip(flags, saved):
            setattr(module, name, value)
        torch.cuda.empty_cache()


def long_logits_check(got: np.ndarray, plain: np.ndarray, plain_fold: np.ndarray,
                      ref32: np.ndarray) -> dict:
    """Phase 16's check of bf16 logits at 577 tokens (LONG_LOGITS_RATIO):
    the worst |diff| of ``got`` from the fp32 forward's ``ref32``, that of
    the two plain bf16 paths, their ratio, each one's share of LOGITS_TOL
    against ``ref32``, and whether the ratio is within the limit."""
    def dist(x):
        return float(np.abs(x.astype(np.float64) - ref32).max())

    def share(x):
        return limit_share(torch.from_numpy(x), torch.from_numpy(ref32), LOGITS_TOL)

    plain_dist, got_dist = max(dist(plain), dist(plain_fold)), dist(got)
    ratio = got_dist / plain_dist if plain_dist > 0 else 0.0 if got_dist == 0 else float("inf")
    return {"max_abs_diff": got_dist, "plain_max_abs_diff": plain_dist, "ratio": ratio,
            "limit_share": share(got), "plain_limit_share": max(share(plain), share(plain_fold)),
            "ok": bool(ratio <= LONG_LOGITS_RATIO)}


def time_ms(fn, iters: int = 20, batches: int = 5) -> float:
    """The median over ``batches`` of the device time of one call in ms.

    Each batch is ``iters`` calls between two CUDA events, after 3 calls to
    warm up.  The card first spins for about 2 ms (``torch.cuda._sleep``), so
    that the host has queued the whole batch before the first call starts:
    the events then bracket the calls running back to back, and a kernel
    shorter than its wrapper's host time is not timed by the wrapper.
    """
    for _ in range(3):
        fn()
    times = []
    for _ in range(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel of the models' paths, forward and backward, for its
    plain torch version."""
    plain = [
        (layers, "fused_qkv_attention", qkv_attention.fused_qkv_attention_plain),
        (layers, "fused_attention_proj", attn_proj.fused_attention_proj_plain),
        (layers, "fc1_gelu", mlp.fc1_gelu_plain),
        (layers, "layernorm", layernorm.layernorm_reference),
        (layers, "ln_linear", ln_linear.ln_linear_plain),
        (layers, "mlp_fused", mlp.mlp_fused_plain),
        (layers, "mlp_ln_fused", mlp.mlp_ln_fused_plain),
        (optim, "adamw_update_fused", optim.adamw_update_fused_plain),
    ]
    saved = [(module, name, getattr(module, name)) for module, name, _ in plain]
    for module, name, fn in plain:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def bound(bytes_moved: float, flops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    """The least time in ms the card could take, and what sets it: the larger
    of ``bytes_moved`` (each input read once, each output written once) over
    the memory rate and ``flops`` over ``peak``, the rate of their type."""
    by_bytes, by_flops = 1e3 * bytes_moved / HBM_BYTES_PER_S, 1e3 * flops / peak
    return max(by_bytes, by_flops), "bytes" if by_bytes >= by_flops else "operations"


def entry(source: str, replaces: str, err: float, ms: float, plain_ms: float, *,
          bytes_moved: float, flops: float, peak: float = BF16_FLOPS,
          library_ms: float | None = None) -> dict:
    """A kernel's line of the summary, with its bound at the timed shape."""
    bound_ms, bound_by = bound(bytes_moved, flops, peak)
    return {"route": "cuda", "source": f"ssl4polyp_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def bound_text(bytes_moved: float, flops: float, peak: float = BF16_FLOPS) -> str:
    return "bound {:.4f} ms ({})".format(*bound(bytes_moved, flops, peak))


def heads_of(qkv: torch.Tensor, h: int):
    """q, k, v as (B, H, N, hd) views of a (B, N, 3*H*hd) tensor."""
    b, n, three_d = qkv.shape
    return qkv.reshape(b, n, 3, h, three_d // 3 // h).permute(2, 0, 3, 1, 4)


def phase_kernels(gen: torch.Generator) -> dict[str, dict]:
    """Each kernel against its plain version at the paths' shapes."""
    dev = "cuda"

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    report = {}
    # Attention forward: (batch, tokens, heads, head dim, fp32 scores,
    # valid_len, bias).  The third case is the eval path's call, the last two
    # the pretrain encoder's and decoder's.
    cases = [
        (BATCH, 197, 12, 64, True, None, False),
        (BATCH, 197, 12, 64, True, 150, False),
        (BATCH, 197, 12, 64, True, None, True),
        (BATCH, 197, 12, 64, True, 150, True),
        (BATCH, 197, 16, 32, False, None, False),
        (BATCH, 50, 12, 64, False, None, True),
        (BATCH, 197, 16, 32, False, None, True),
    ]
    errors, times = [], {}
    shape_names = {2: "classifier", 5: "MAE encoder", 6: "MAE decoder"}

    def attention_cost(b, n, h, hd):  # qkv and the bias in, the output out; two products
        return dict(bytes_moved=2 * (b * n * 4 * h * hd + 3 * h * hd), flops=4 * b * h * n * n * hd)

    for i, (b, n, h, hd, f32, valid_len, with_bias) in enumerate(cases):
        qkv = randn(b, n, 3 * h * hd)
        bias = randn(3 * h * hd, scale=0.5) if with_bias else None
        run = lambda: qkv_attention.fused_qkv_attention(qkv, h, f32, valid_len, bias)  # noqa: E731
        plain = lambda: qkv_attention.fused_qkv_attention_reference(qkv, h, f32, valid_len, bias)  # noqa: E731
        out, again = run(), run()
        torch.cuda.synchronize()
        what = f"attention B={b} N={n} H={h} hd={hd} f32={f32} valid_len={valid_len} bias={with_bias}"
        errors.append(max_error(out, plain(), ATTENTION_TOL, what))
        if not torch.equal(out, again):
            fail(f"{what}: two runs gave different bits")
        print(f"{what}: max |diff| {errors[-1]:.3e} (atol {ATTENTION_TOL[0]}, rtol "
              f"{ATTENTION_TOL[1]}); rerun bit-identical")
        if i in shape_names:
            q, k, v = heads_of(qkv + bias, h)
            library = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
            times[i] = time_ms(run), time_ms(plain), time_ms(library)
            print(f"  {shape_names[i]}'s shape: kernel {times[i][0]:.4f} ms, plain {times[i][1]:.4f} "
                  f"ms, scaled_dot_product_attention {times[i][2]:.4f} ms, "
                  f"{bound_text(**attention_cost(b, n, h, hd))}")
    report["fused_qkv_attention"] = entry(
        "qkv_attention.cu", "ssl4polyp_tpu/ops/qkv_attention.py:91", max(errors), *times[2][:2],
        **attention_cost(*cases[2][:4]), library_ms=times[2][2])

    # Attention backward against the plain version with the JAX kernel's
    # roundings.  The first two cases are the pretrain path's calls, the
    # last the fine-tune step's (fp32 scores, with bias).
    cases = [
        (BATCH, 50, 12, 64, False, None, True),
        (BATCH, 197, 16, 32, False, None, True),
        (BATCH, 197, 16, 32, False, 150, True),
        (BATCH, 50, 12, 64, False, 40, False),
        (BATCH, 197, 12, 64, False, None, True),
        (8, 197, 16, 32, True, None, False),
        (BATCH, 197, 12, 64, True, None, True),
    ]
    errors, times = [], {}
    bwd_names = {0: "MAE encoder", 1: "MAE decoder", 6: "classifier"}

    def attention_bwd_cost(b, n, h, hd):  # qkv, dout and the bias in, dqkv and dbias out
        return dict(bytes_moved=2 * (b * n * 7 * h * hd + 6 * h * hd),
                    flops=10 * b * h * n * n * hd)

    def backward_probe(qkv, dout, h, f32, valid_len, bias, probe):
        return lambda: qkv_attention._backward_kernel(qkv, dout, h, f32, valid_len, bias, probe)

    for i, (b, n, h, hd, f32, valid_len, with_bias) in enumerate(cases):
        qkv, dout = randn(b, n, 3 * h * hd), randn(b, n, h * hd)
        bias = randn(3 * h * hd, scale=0.5) if with_bias else None
        run = backward_probe(qkv, dout, h, f32, valid_len, bias, 0)
        plain = lambda: qkv_attention.fused_qkv_attention_backward_reference(  # noqa: E731
            qkv, dout, h, f32, valid_len, bias)
        (dqkv, dbias), again = run(), run()
        torch.cuda.synchronize()
        ref_dqkv, ref_dbias = plain()
        plan = qkv_attention.backward_plan(n, hd)
        what = (f"attention backward B={b} N={n} H={h} hd={hd} f32={f32} valid_len={valid_len} "
                f"bias={with_bias}")
        errors.append(max_error(dqkv, ref_dqkv, ATTENTION_BWD_TOL, f"{what}: dqkv"))
        line = f"{what}: dqkv max |diff| {errors[-1]:.3e} (atol {ATTENTION_BWD_TOL[0]}, rtol {ATTENTION_BWD_TOL[1]})"
        if with_bias:
            tol = (DBIAS_TOL[0] * ref_dbias.float().abs().max().item(), DBIAS_TOL[1])
            err = max_error(dbias, ref_dbias, tol, f"{what}: dbias")
            line += f", dbias {err:.3e} (atol {tol[0]:.3e}, rtol {tol[1]})"
        if not torch.equal(dqkv, again[0]) or (with_bias and not torch.equal(dbias, again[1])):
            fail(f"{what}: two runs gave different bits")
        print(line + f"; rerun bit-identical; path: {plan['path']}, {plan['warps']} warps a "
              f"block, {plan['smem_bytes']} bytes of shared memory")
        if i in bwd_names:
            leaf = (qkv + bias).requires_grad_()
            out = F.scaled_dot_product_attention(*heads_of(leaf, h)).transpose(1, 2).reshape(
                dout.shape)
            library = lambda: torch.autograd.grad(out, leaf, dout, retain_graph=True)  # noqa: E731
            first = backward_probe(qkv, dout, h, f32, valid_len, bias,
                                   qkv_attention.PROBE_FIRST_DESIGN)
            first_err = max_error(first()[0], ref_dqkv, ATTENTION_BWD_TOL, f"{what}: first design")
            times[i] = time_ms(run), time_ms(plain), time_ms(library), time_ms(first)
            print(f"  {bwd_names[i]}'s shape: kernel {times[i][0]:.4f} ms, first design "
                  f"{times[i][3]:.4f} ms (dqkv {first_err:.3e}), plain {times[i][1]:.4f} "
                  f"ms, scaled_dot_product_attention's backward {times[i][2]:.4f} ms, "
                  f"{bound_text(**attention_bwd_cost(b, n, h, hd))}")
            # Where the time goes: the kernel with parts left out (wrong
            # results, timed only).
            ablations = {
                "without phase B": qkv_attention.PROBE_NO_PHASE_B,
                "phase A stopped after the softmax": qkv_attention.PROBE_NO_PHASE_A_BACKWARD,
                "staging and the softmax alone": (qkv_attention.PROBE_NO_PHASE_B
                                                  | qkv_attention.PROBE_NO_PHASE_A_BACKWARD),
                "phase B's weights without the exponential": qkv_attention.PROBE_NO_EXP_B,
            }
            print(f"  {bwd_names[i]}'s shape, ablations (wrong results, timed only): " + ", ".join(
                f"{name} {time_ms(backward_probe(qkv, dout, h, f32, valid_len, bias, probe)):.4f} ms"
                for name, probe in ablations.items()))
            del leaf, out
    report["fused_qkv_attention_backward"] = entry(
        "qkv_attention.cu", "ssl4polyp_tpu/ops/qkv_attention.py:108", max(errors), *times[6][:2],
        **attention_bwd_cost(*cases[6][:4]), library_ms=times[6][2])

    # LayerNorm forward and backward: the pretrain encoder's and decoder's
    # rows, then the eval forward's.  The plain backward is autograd's of the
    # plain forward, timed alone.
    fwd_errors, bwd_errors, fwd_times, bwd_times = [], [], {}, {}
    ln_shapes = [(BATCH * 50, 768), (BATCH * 197, 512), (BATCH * 197, 768)]
    ln_names = ["MAE encoder", "MAE decoder", "classifier"]

    def ln_cost(m, d):  # x in and y out in bf16, the fp32 affine in
        return dict(bytes_moved=4 * m * d + 8 * d, flops=8 * m * d, peak=FP32_FLOPS)

    # x, dy (and dres) in, dx out in bf16; the weight in, both gradients out
    def ln_bwd_cost(m, d, dres=False):
        return dict(bytes_moved=(8 if dres else 6) * m * d + 12 * d,
                    flops=(13 if dres else 12) * m * d, peak=FP32_FLOPS)

    for i, (m, d) in enumerate(ln_shapes):
        x, dy = randn(m, d), randn(m, d)
        w = 1.0 + 0.1 * randn(d, dtype=torch.float32)
        bias = 0.1 * randn(d, dtype=torch.float32)
        run = lambda: layernorm._forward_kernel(x, w, bias, 1e-6)  # noqa: E731
        plain = lambda: layernorm.layernorm_reference(x, w, bias, 1e-6)  # noqa: E731
        run_bwd = lambda: layernorm._backward_kernel(x, dy, w, 1e-6)  # noqa: E731
        y, (dx, dw, db), again = run(), run_bwd(), run_bwd()
        torch.cuda.synchronize()
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        ref = layernorm.layernorm_reference(*leaves, 1e-6)
        plain_bwd = lambda: torch.autograd.grad(ref, leaves, dy, retain_graph=True)  # noqa: E731
        ref_dx, ref_dw, ref_db = plain_bwd()
        what = f"layernorm ({m}, {d})"
        fwd_errors.append(max_error(y, plain(), LN_TOL, f"{what}: y"))
        bwd_errors.append(max_error(dx, ref_dx, LN_TOL, f"{what}: dx"))
        param_err = max(max_error(dw, ref_dw, LN_PARAM_TOL, f"{what}: dweight"),
                        max_error(db, ref_db, LN_PARAM_TOL, f"{what}: dbias"))
        if not all(torch.equal(a, b) for a, b in zip((dx, dw, db), again)):
            fail(f"{what}: two backward runs gave different bits")
        # The variant the LN+MLP kernel's backward calls: a residual's
        # gradient added to dx in fp32 before its one rounding.
        dres = randn(m, d)
        run_dres = lambda: layernorm._backward_kernel(x, dy, w, 1e-6, dres)  # noqa: E731
        with_dres, dres_again = run_dres(), run_dres()
        ref_dres = ln_linear.layernorm_backward(x, w, dy, 1e-6, True, dres)
        bwd_errors.append(max_error(with_dres[0], ref_dres[0], LN_TOL, f"{what}: dx + dres"))
        dres_param_err = max(
            max_error(with_dres[1], ref_dres[1], LN_PARAM_TOL, f"{what}: dweight (dres)"),
            max_error(with_dres[2], ref_dres[2], LN_PARAM_TOL, f"{what}: dbias (dres)"))
        if not all(torch.equal(a, b) for a, b in zip(with_dres, dres_again)):
            fail(f"{what}: two backward runs with dres gave different bits")
        print(f"{what}: y max |diff| {fwd_errors[-1]:.3e}, dx {bwd_errors[-2]:.3e}, with dres "
              f"{bwd_errors[-1]:.3e} (atol {LN_TOL[0]}, rtol {LN_TOL[1]}); dweight, dbias "
              f"{param_err:.3e}, with dres {dres_param_err:.3e} (atol {LN_PARAM_TOL[0]}, rtol "
              f"{LN_PARAM_TOL[1]}); reruns bit-identical")
        # The library call takes its affine in the input's dtype.
        lib_leaves = [x.clone().requires_grad_(), w.bfloat16().requires_grad_(),
                      bias.bfloat16().requires_grad_()]
        library = lambda: F.layer_norm(lib_leaves[0], (d,), lib_leaves[1], lib_leaves[2], 1e-6)  # noqa: E731
        lib_y = library()
        library_bwd = lambda: torch.autograd.grad(lib_y, lib_leaves, dy, retain_graph=True)  # noqa: E731
        fwd_times[i] = time_ms(run), time_ms(plain), time_ms(library)
        bwd_times[i] = time_ms(run_bwd), time_ms(plain_bwd), time_ms(library_bwd)
        print(f"  {ln_names[i]}'s shape: forward kernel {fwd_times[i][0]:.4f} ms, plain "
              f"{fwd_times[i][1]:.4f} ms, F.layer_norm {fwd_times[i][2]:.4f} ms, "
              f"{bound_text(**ln_cost(m, d))}; backward kernel {bwd_times[i][0]:.4f} ms, plain "
              f"{bwd_times[i][1]:.4f} ms, F.layer_norm's {bwd_times[i][2]:.4f} ms, "
              f"{bound_text(**ln_bwd_cost(m, d))}")
        # The backward's two launches apart (one plan: the same buffers), then
        # the dres variant, whole.
        launch, _ = layernorm._backward_plan(x, dy, w, 1e-6)
        rows_ms, sum_ms = (time_ms(lambda: launch(layernorm.BACKWARD_PARTS[part]))  # noqa: B023
                           for part in ("rows", "sum"))
        blocks = _build.library().ssl4polyp_layernorm_bwd_blocks(m, d)
        part_bytes = 8 * blocks * d  # (blocks, 2, D) fp32
        plain_dres = lambda: ln_linear.layernorm_backward(x, w, dy, 1e-6, True, dres)  # noqa: E731
        rows_bound = bound_text(6 * m * d + 4 * d + part_bytes, 12 * m * d, FP32_FLOPS)
        sum_bound = bound_text(part_bytes + 8 * d, 2 * blocks * d, FP32_FLOPS)
        print(f"    backward's row kernel {rows_ms:.4f} ms, {rows_bound}; the sum of its "
              f"{blocks} partial rows {sum_ms:.4f} ms, {sum_bound}; with dres, whole "
              f"{time_ms(run_dres):.4f} ms, plain {time_ms(plain_dres):.4f} ms, "
              f"{bound_text(**ln_bwd_cost(m, d, True))}")
    m, d = ln_shapes[2]  # the classifier's
    report["layernorm"] = entry(
        "layernorm.cu", "ssl4polyp_tpu/ops/layernorm.py:32", max(fwd_errors), *fwd_times[2][:2],
        **ln_cost(m, d), library_ms=fwd_times[2][2])
    report["layernorm_backward"] = entry(
        "layernorm.cu", "ssl4polyp_tpu/ops/layernorm.py:69", max(bwd_errors), *bwd_times[2][:2],
        **ln_bwd_cost(m, d), library_ms=bwd_times[2][2])

    # fc1+GELU: the pretrain calls and the fine-tune step's write h for the
    # backward; the eval call writes y only.
    errors, times = [], {}
    fc1_shapes = [("MAE encoder", BATCH * 50, 768, 3072, True),
                  ("MAE decoder", BATCH * 197, 512, 2048, True),
                  ("classifier", BATCH * 197, 768, 3072, False),
                  ("classifier (fine-tune)", BATCH * 197, 768, 3072, True)]

    def fc1_cost(m, k, nf, write_h):  # x, w and the bias in; y, and h when asked, out
        return dict(bytes_moved=2 * (m * k + nf * k + nf + (2 if write_h else 1) * m * nf),
                    flops=2 * m * k * nf)

    for i, (name, m, k, nf, write_h) in enumerate(fc1_shapes):
        x, w, bias = randn(m, k), randn(nf, k, scale=k ** -0.5), randn(nf, scale=0.5)
        run = lambda: mlp._kernel(x, w, bias, write_h)  # noqa: E731
        plain = lambda: mlp.fc1_gelu_reference(x, w, bias)  # noqa: E731
        (h, y), (h2, y2) = run(), run()
        torch.cuda.synchronize()
        what = f"fc1_gelu ({m}, {k}) -> {nf}, h written: {write_h}"
        errors.append(max_error(y, plain(), FC1_TOL, f"{what}: y"))
        if write_h:
            errors.append(max_error(h, torch.matmul(x, w.t()) + bias, FC1_TOL, f"{what}: h"))
        if not torch.equal(y, y2) or (write_h and not torch.equal(h, h2)):
            fail(f"{what}: two runs gave different bits")
        library = lambda: F.gelu(F.linear(x, w, bias))  # noqa: E731
        times[i] = time_ms(run), time_ms(plain), time_ms(library)
        print(f"{what}: max |diff| {max(errors[-2:]):.3e} (atol {FC1_TOL[0]}, rtol {FC1_TOL[1]}); "
              f"rerun bit-identical")
        print(f"  {name}'s shape: kernel {times[i][0]:.4f} ms, plain {times[i][1]:.4f} ms, "
              f"F.linear + F.gelu {times[i][2]:.4f} ms, {bound_text(**fc1_cost(m, k, nf, write_h))}")
    report["fc1_gelu"] = entry(
        "mlp.cu", "ssl4polyp_tpu/ops/mlp.py:73", max(errors), *times[2][:2],
        **fc1_cost(*fc1_shapes[2][1:]), library_ms=times[2][2])

    # The same kernel with a bare epilogue (ssl4polyp_matmul_nt): the dx product
    # of fused_qkvproj_attention's backward, then fc1's shape without its
    # bias and GELU, which prices the epilogue.
    lib = _build.library()
    for what, m, k, nf in (("dx of fused_qkvproj_attention", BATCH * 197, 2304, 768),
                           ("fc1's shape, bare epilogue", BATCH * 197, 768, 3072)):
        x, w = randn(m, k), randn(nf, k, scale=k ** -0.5)
        outs = [torch.empty((m, nf), dtype=x.dtype, device=dev) for _ in range(2)]

        def run(y=outs[0]):
            err = lib.ssl4polyp_matmul_nt(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, k, nf,
                                          torch.cuda.current_stream().cuda_stream)
            if err:
                fail(f"matmul_nt launch failed: CUDA error {err}")

        run()
        run(outs[1])
        torch.cuda.synchronize()
        library = lambda: torch.matmul(x, w.t())  # noqa: E731
        err = max_error(outs[0], library(), FUSED_TOL, f"matmul_nt ({m}, {k}) -> {nf}")
        if not torch.equal(*outs):
            fail(f"matmul_nt ({m}, {k}) -> {nf}: two runs gave different bits")
        cost = dict(bytes_moved=2 * (m * k + nf * k + m * nf), flops=2 * m * k * nf)
        print(f"matmul_nt ({m}, {k}) -> {nf} ({what}): max |diff| {err:.3e} (atol {FUSED_TOL[0]}, "
              f"rtol {FUSED_TOL[1]}); rerun bit-identical; kernel {time_ms(run):.4f} ms, "
              f"torch.matmul {time_ms(library):.4f} ms, {bound_text(**cost)}")

    # The fine-tune path's fused kernels at its shapes, then the MAE
    # decoder's.  Beside the plain version (fp32 products of the rounded
    # operands, the kernels' roundings) is timed the fastest unfused bf16
    # chain: the LayerNorm kernel, cuBLAS products, bias adds and GELU; for
    # LN+QKV also cuBLAS's addmm alone on a normalised row made beforehand.
    def affine(d):
        return 1.0 + 0.1 * randn(d, dtype=torch.float32), 0.1 * randn(d, dtype=torch.float32)

    def ln_linear_cost(m, k, n):  # x, w, b and the affine in, out out
        return dict(bytes_moved=2 * (m * k + n * k + n + m * n) + 8 * k, flops=2 * m * k * n)

    ln_ablations = {"without the normalisation": ln_linear.PROBE_NO_NORMALISE,
                    "without the statistics launch": ln_linear.PROBE_NO_STATS,
                    "bare epilogue": ln_linear.PROBE_BARE_EPILOGUE,
                    "the other tile width": ln_linear.PROBE_OTHER_WIDTH}
    errors, times = [], {}
    for i, (shape, m, k, n) in enumerate([("classifier", BATCH * 197, 768, 2304),
                                          ("MAE decoder", BATCH * 197, 512, 1536)]):
        x, (s, t) = randn(m, k), affine(k)
        w, bias = randn(n, k, scale=k ** -0.5), randn(n, scale=0.5)

        def probe_run(probe, w=w, bias=bias):
            return lambda: ln_linear._kernel(x, s, t, w, bias, 1e-6, probe)

        run, first = probe_run(0), probe_run(ln_linear.PROBE_FIRST_DESIGN)
        plain = lambda: ln_linear.ln_linear_reference(x, s, t, w, bias, 1e-6)  # noqa: E731
        unfused = lambda: layers.linear(layernorm._forward_kernel(x, s, t, 1e-6), w, bias)  # noqa: E731
        m_ready = layernorm._forward_kernel(x, s, t, 1e-6)
        addmm = lambda: torch.addmm(bias, m_ready, w.t())  # noqa: E731
        out, again, first_out = run(), run(), first()
        other_out = probe_run(ln_linear.PROBE_OTHER_WIDTH)()
        # The C entry point for a caller without scratch (the stream's pool).
        entry_out = torch.empty_like(out)
        rc = lib.ssl4polyp_ln_linear_fwd(x.data_ptr(), s.data_ptr(), t.data_ptr(), w.data_ptr(),
                                         bias.data_ptr(), entry_out.data_ptr(), m, k, n, 1e-6,
                                         torch.cuda.current_stream().cuda_stream)
        # With W = I and b = 0 the output is m itself: bit-equal to the first
        # design's, the statistics, the formula and its rounding are unchanged.
        eye = torch.eye(k, dtype=torch.bfloat16, device=dev)
        zero = torch.zeros(k, dtype=torch.bfloat16, device=dev)
        m_new = probe_run(0, eye, zero)()
        m_first = probe_run(ln_linear.PROBE_FIRST_DESIGN, eye, zero)()
        torch.cuda.synchronize()
        what = f"ln_linear ({m}, {k}) -> {n}"
        ref = plain()
        errors.append(max_error(out, ref, FUSED_TOL, what))
        first_err = max_error(first_out, ref, FUSED_TOL, f"{what}: first design")
        max_error(other_out, ref, FUSED_TOL, f"{what}: the other tile width")
        if not torch.equal(out, again):
            fail(f"{what}: two runs gave different bits")
        if rc or not torch.equal(out, entry_out):
            fail(f"{what}: ssl4polyp_ln_linear_fwd (rc {rc}) differs from the wrapper's launch")
        if not torch.equal(m_new, m_first):
            fail(f"{what}, W = I: m differs from the first design's")
        times[i] = time_ms(run), time_ms(plain), time_ms(unfused), time_ms(first), time_ms(addmm)
        print(f"{what}: max |diff| {errors[-1]:.3e} (atol {FUSED_TOL[0]}, rtol {FUSED_TOL[1]}); "
              f"rerun and ssl4polyp_ln_linear_fwd bit-identical; W = I: m bit-equal to the "
              f"first design's")
        print(f"  {shape}'s shape: kernel {times[i][0]:.4f} ms, first design {times[i][3]:.4f} ms "
              f"(max |diff| {first_err:.3e}), plain {times[i][1]:.4f} ms, unfused bf16 chain "
              f"{times[i][2]:.4f} ms, torch.addmm on a ready m {times[i][4]:.4f} ms, "
              f"{bound_text(**ln_linear_cost(m, k, n))}")
        print(f"  {shape}'s shape, ablations (wrong results but the other width's, timed only): "
              + ", ".join(f"{label} {time_ms(probe_run(probe)):.4f} ms"
                          for label, probe in ln_ablations.items()))
    report["ln_linear"] = entry(
        "ln_linear.cu", "ssl4polyp_tpu/ops/ln_linear.py:28", max(errors), *times[0][:2],
        **ln_linear_cost(BATCH * 197, 768, 2304))

    report.update(tiles_kernels(randn))
    report.update(fused_mlp_kernels(randn))
    report.update(attn_proj_kernels(randn))
    report.update(attention_ops_kernels(randn))
    report.update(adamw_kernel(gen))
    report.update(fp32_kernels(gen))
    return report


def tiles_backward(qkv, dout, h, f32, valid_len, bias):
    """The key tiles' backward through the library's entry point for them,
    at any N (the wrapper sends them only N > 256): for timing beside the
    first design at 209-256 tokens.  Launch counts do not see it."""
    b, n, three_d = qkv.shape
    hd = three_d // 3 // h
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((b, h, n, 4), dtype=torch.float32, device=qkv.device)
    acc = torch.empty((b, h, n, hd), dtype=torch.float32, device=qkv.device)
    part = torch.empty((b, three_d), dtype=torch.float32, device=qkv.device)
    dbias = torch.empty((three_d,), dtype=torch.float32, device=qkv.device)
    err = _build.library().ssl4polyp_qkv_attention_tiles_bwd(
        qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        acc.data_ptr(), part.data_ptr(), dbias.data_ptr(), b, n, h, hd,
        n if valid_len is None else valid_len, qkv_attention._scale(hd, qkv.dtype),
        hd ** -0.5, int(f32), 0, torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"key tiles' backward at N={n}: CUDA error {err}")
    return dqkv, dbias.to(bias.dtype)


def tiles_kernels(randn) -> dict[str, dict]:
    """bf16 attention past 256 tokens (the key tiles of
    ``qkv_attention_tiles.cu``), forward and backward, against the plain
    versions at a ViT-B/16's shapes at 384 px (577 tokens: the classifier's,
    also with ``valid_len`` 500, and the MAE decoder's 16 heads of 32 with
    bf16 scores) and at 257 and 1,025 tokens: max error, reruns
    bit-identical, times beside the plain versions', bf16 SDPA's and its
    backward's (timed only; with the keys' mask where ``valid_len`` cuts
    them) and the bound.  Then the key tiles' backward beside the first
    design, which takes 209-256 tokens, at 209 and 256 (timed only)."""
    def cost(b, n, h, hd, nv):  # qkv and the bias in, the output out; two products
        # over the nv weighted keys of each row
        return dict(bytes_moved=2 * (b * n * 4 * h * hd + 3 * h * hd),
                    flops=4 * b * h * n * nv * hd)

    def bwd_cost(b, n, h, hd, nv):  # qkv, dout, bias in; dqkv, dbias out; five products
        return dict(bytes_moved=2 * (b * n * 7 * h * hd + 6 * h * hd),
                    flops=10 * b * h * n * nv * hd)

    cases = [
        (BATCH, 577, 12, 64, True, None, "classifier at 384 px"),
        (BATCH, 577, 12, 64, True, 500, "classifier at 384 px, valid_len 500"),
        (BATCH, 577, 16, 32, False, None, "MAE decoder at 384 px"),
        (4, 257, 12, 64, True, None, "257 tokens"),
        (4, 1025, 12, 64, True, None, "1,025 tokens"),
    ]
    fwd_errors, bwd_errors, fwd_times, bwd_times = [], [], {}, {}
    for b, n, h, hd, f32, valid_len, name in cases:
        nv = n if valid_len is None else valid_len
        qkv, dout = randn(b, n, 3 * h * hd), randn(b, n, h * hd)
        bias = randn(3 * h * hd, scale=0.5)
        run = lambda: qkv_attention.fused_qkv_attention(qkv, h, f32, valid_len, bias)  # noqa: E731
        plain = lambda: qkv_attention.fused_qkv_attention_reference(qkv, h, f32, valid_len, bias)  # noqa: E731
        run_bwd = lambda: qkv_attention._backward_kernel(qkv, dout, h, f32, valid_len, bias)  # noqa: E731
        plain_bwd = lambda: qkv_attention.fused_qkv_attention_backward_reference(  # noqa: E731
            qkv, dout, h, f32, valid_len, bias)
        out, again = run(), run()
        (dqkv, dbias), bwd_again = run_bwd(), run_bwd()
        torch.cuda.synchronize()
        what = (f"attention past 256 tokens B={b} N={n} H={h} hd={hd} f32={f32} "
                f"valid_len={valid_len}")
        fwd_errors.append(max_error(out, plain(), ATTENTION_TOL, what))
        ref_dqkv, ref_dbias = plain_bwd()
        bwd_errors.append(max_error(dqkv, ref_dqkv, ATTENTION_BWD_TOL, f"{what}: dqkv"))
        tol = (DBIAS_TOL[0] * ref_dbias.float().abs().max().item(), DBIAS_TOL[1])
        db_err = max_error(dbias, ref_dbias, tol, f"{what}: dbias")
        if not torch.equal(out, again) or not torch.equal(dqkv, bwd_again[0]) or not torch.equal(
                dbias, bwd_again[1]):
            fail(f"{what}: two runs gave different bits")
        plan = qkv_attention.backward_plan(n, hd)
        print(f"{what}: out max |diff| {fwd_errors[-1]:.3e} (atol {ATTENTION_TOL[0]}, rtol "
              f"{ATTENTION_TOL[1]}), dqkv {bwd_errors[-1]:.3e} (atol {ATTENTION_BWD_TOL[0]}, "
              f"rtol {ATTENTION_BWD_TOL[1]}), dbias {db_err:.3e} (atol {tol[0]:.3e}, rtol "
              f"{tol[1]}); reruns bit-identical; backward path: {plan['path']}, "
              f"{plan['warps']} warps a block, {plan['smem_bytes']} bytes of shared memory")
        biased = qkv + bias
        mask = None if valid_len is None else (torch.arange(n, device="cuda") < valid_len).view(
            1, 1, 1, n)  # the keys' mask, broadcast over (B, H, queries)
        library = lambda: F.scaled_dot_product_attention(*heads_of(biased, h), attn_mask=mask)  # noqa: E731
        leaf = biased.clone().requires_grad_()
        lib_out = F.scaled_dot_product_attention(*heads_of(leaf, h), attn_mask=mask).transpose(
            1, 2).reshape(dout.shape)
        library_bwd = lambda: torch.autograd.grad(lib_out, leaf, dout, retain_graph=True)  # noqa: E731
        fwd_times[name] = time_ms(run), time_ms(plain), time_ms(library)
        bwd_times[name] = time_ms(run_bwd), time_ms(plain_bwd), time_ms(library_bwd)
        print(f"  {name}: forward kernel {fwd_times[name][0]:.4f} ms, plain "
              f"{fwd_times[name][1]:.4f} ms, bf16 scaled_dot_product_attention "
              f"{fwd_times[name][2]:.4f} ms, {bound_text(**cost(b, n, h, hd, nv))}; backward "
              f"kernel {bwd_times[name][0]:.4f} ms, plain {bwd_times[name][1]:.4f} ms, its "
              f"backward {bwd_times[name][2]:.4f} ms, {bound_text(**bwd_cost(b, n, h, hd, nv))}; "
              f"{CARD}")
        del leaf, lib_out, ref_dqkv
    # The first design (the path from 209 to 256 tokens) beside the key tiles
    # there: timed only; the wrapper keeps its paths.
    for n in (209, 256):
        qkv, dout = randn(BATCH, n, 3 * 768), randn(BATCH, n, 768)
        bias = randn(3 * 768, scale=0.5)
        first = lambda: qkv_attention._backward_kernel(qkv, dout, 12, True, None, bias)  # noqa: E731
        tiles = lambda: tiles_backward(qkv, dout, 12, True, None, bias)  # noqa: E731
        ref = qkv_attention.fused_qkv_attention_backward_reference(qkv, dout, 12, True, None, bias)
        err = max_error(tiles()[0], ref[0], ATTENTION_BWD_TOL, f"key tiles' backward at N={n}")
        path = qkv_attention.backward_plan(n, 64)["path"]
        print(f"attention backward B={BATCH} N={n} H=12 hd=64 ({path} today): first design "
              f"{time_ms(first):.4f} ms, key tiles {time_ms(tiles):.4f} ms (dqkv {err:.3e}), "
              f"{bound_text(**bwd_cost(BATCH, n, 12, 64, n))}; {CARD}")
    stats_entry = tiles_designs(randn)
    shape = BATCH, 577, 12, 64, 577
    return {
        "qkv_attention_tiles_statistics": stats_entry,
        "fused_qkv_attention_tiles": entry(
            "qkv_attention_tiles.cu", "ssl4polyp_tpu/ops/qkv_attention.py:208", max(fwd_errors),
            *fwd_times["classifier at 384 px"][:2], **cost(*shape),
            library_ms=fwd_times["classifier at 384 px"][2]),
        "fused_qkv_attention_tiles_backward": entry(
            "qkv_attention_tiles.cu", "ssl4polyp_tpu/ops/qkv_attention.py:237", max(bwd_errors),
            *bwd_times["classifier at 384 px"][:2], **bwd_cost(*shape),
            library_ms=bwd_times["classifier at 384 px"][2]),
    }


def statistics_error(got: torch.Tensor, want: torch.Tensor, softmax_f32: bool,
                     what: str) -> tuple[float, float]:
    """The key tiles' statistics (B, H, N, 4) against the plain ones: each
    column's (max * log2(e), 1/sum, tmp) max |diff| as a share of its
    largest magnitude, held to STATISTICS_RTOL; returns the worst share and
    the worst |diff|."""
    shares = [((got[..., c] - want[..., c]).abs().max() / want[..., c].abs().max()).item()
              for c in range(3)]
    if max(shares) > STATISTICS_RTOL[softmax_f32] or not (got[..., 3] == 0).all():
        fail(f"{what}: statistics off by {shares} of each column's largest value (limit "
             f"{STATISTICS_RTOL[softmax_f32]})")
    return max(shares), (got[..., :3] - want[..., :3]).abs().max().item()


def tiles_designs(randn) -> dict:
    """The key tiles' forward and statistics pass timed alone beside their
    first design (through ssl4polyp_qkv_attention_tiles_fwd_probe, in this
    process) at a ViT-B/16's shapes at 384 px (the classifier's 12 heads of
    64 with and without a bias, the MAE decoder's 16 heads of 32 with bf16
    scores): each against its plain version, a rerun bit-identical, ms
    beside the plain version's, bf16 SDPA's (timed only; no PyTorch call
    computes the statistics) and the bound.  Returns the statistics pass's
    summary entry, at the classifier's shape with a bias."""
    def cost(b, n, h, hd):  # qkv and the bias in, the output out; two products
        return dict(bytes_moved=2 * (b * n * 4 * h * hd + 3 * h * hd), flops=4 * b * h * n * n * hd)

    def stats_cost(b, n, h, hd):  # qkv, the bias and dO in, the float4 rows out; two products
        return dict(bytes_moved=2 * (b * n * 4 * h * hd + 3 * h * hd) + 16 * b * h * n,
                    flops=4 * b * h * n * n * hd)

    first = qkv_attention.TILES_PROBE_FIRST_DESIGN
    statistics = qkv_attention.TILES_PROBE_STATISTICS
    result = None
    for b, n, h, hd, f32, with_bias, name in (
            (BATCH, 577, 12, 64, True, True, "classifier at 384 px"),
            (BATCH, 577, 12, 64, True, False, "classifier at 384 px, no bias"),
            (BATCH, 577, 16, 32, False, True, "MAE decoder at 384 px")):
        qkv, dout = randn(b, n, 3 * h * hd), randn(b, n, h * hd)
        bias = randn(3 * h * hd, scale=0.5) if with_bias else None
        fwd = lambda: qkv_attention._forward_kernel(qkv, h, f32, None, bias)  # noqa: E731
        fwd_first = lambda: qkv_attention.tiles_probe(qkv, h, f32, None, bias, first)  # noqa: E731
        plain = lambda: qkv_attention.fused_qkv_attention_reference(qkv, h, f32, None, bias)  # noqa: E731
        stats = lambda probe=0: qkv_attention.tiles_probe(  # noqa: E731
            qkv, h, f32, None, bias, statistics | probe, dout=dout)
        stats_plain = lambda: qkv_attention.tiles_statistics_reference(  # noqa: E731
            qkv, dout, h, f32, None, bias)
        out, again, out_first = fwd(), fwd(), fwd_first()
        st, st_again, st_first = stats(), stats(), stats(first)
        torch.cuda.synchronize()
        what = f"key tiles B={b} N={n} H={h} hd={hd} f32={f32} bias={with_bias}"
        ref, st_ref = plain(), stats_plain()
        fwd_err = max_error(out, ref, ATTENTION_TOL, f"{what}: forward")
        first_err = max_error(out_first, ref, ATTENTION_TOL, f"{what}: the first design's forward")
        st_share, st_err = statistics_error(st, st_ref, f32, f"{what}: statistics pass")
        first_share, _ = statistics_error(st_first, st_ref, f32,
                                          f"{what}: the first design's statistics pass")
        if not torch.equal(out, again) or not torch.equal(st, st_again):
            fail(f"{what}: two runs gave different bits")
        biased = qkv if bias is None else qkv + bias
        library = lambda: F.scaled_dot_product_attention(*heads_of(biased, h))  # noqa: E731
        ms = {"fwd": time_ms(fwd), "fwd_first": time_ms(fwd_first), "fwd_plain": time_ms(plain),
              "sdpa": time_ms(library), "stats": time_ms(stats),
              "stats_first": time_ms(lambda: stats(first)), "stats_plain": time_ms(stats_plain)}
        print(f"{what}: forward max |diff| {fwd_err:.3e} (first design {first_err:.3e}; atol "
              f"{ATTENTION_TOL[0]}, rtol {ATTENTION_TOL[1]}), statistics {st_share:.3e} of each "
              f"column's largest value (first design {first_share:.3e}; limit "
              f"{STATISTICS_RTOL[f32]}); reruns bit-identical")
        print(f"  {name}: forward {ms['fwd']:.4f} ms, first design {ms['fwd_first']:.4f} ms, "
              f"plain {ms['fwd_plain']:.4f} ms, bf16 scaled_dot_product_attention "
              f"{ms['sdpa']:.4f} ms, {bound_text(**cost(b, n, h, hd))}; statistics pass "
              f"{ms['stats']:.4f} ms, first design {ms['stats_first']:.4f} ms, plain "
              f"{ms['stats_plain']:.4f} ms, {bound_text(**stats_cost(b, n, h, hd))}; {CARD}")
        if result is None:
            result = entry("qkv_attention_tiles.cu", "ssl4polyp_tpu/ops/qkv_attention.py:425",
                           st_err, ms["stats"], ms["stats_plain"], **stats_cost(b, n, h, hd))
        del ref, st_ref
    return result


def fused_mlp_kernels(randn) -> dict[str, dict]:
    """The fused MLPs: the kernel, its first design (through the probe, in this
    process), the plain version, the unfused chain and the bound at the
    classifier's and the MAE decoder's shapes, and the kernel with parts left
    out (wrong results, timed only)."""
    def affine(d):
        return 1.0 + 0.1 * randn(d, dtype=torch.float32), 0.1 * randn(d, dtype=torch.float32)

    def fused_cost(m, k, nf, with_ln):  # x, W1, b1, W2, b2 (and the affine) in; h and out out
        return dict(bytes_moved=2 * (2 * m * k + 2 * nf * k + nf + k + m * nf)
                    + (8 * k if with_ln else 0), flops=4 * m * k * nf)

    report = {}
    ablations = {"without fc2's products": mlp.FUSED_PROBE_NO_FC2,
                 "without fc1's epilogue": mlp.FUSED_PROBE_NO_EPILOGUE,
                 "without fc1's products": mlp.FUSED_PROBE_NO_FC1,
                 "the products alone (no loads, no epilogue)": (mlp.FUSED_PROBE_NO_LOADS
                                                                | mlp.FUSED_PROBE_NO_EPILOGUE),
                 "the loads alone": (mlp.FUSED_PROBE_NO_FC1 | mlp.FUSED_PROBE_NO_FC2
                                     | mlp.FUSED_PROBE_NO_EPILOGUE),
                 "clusters of 4": mlp.FUSED_PROBE_CLUSTER_4,
                 "clusters of 1 (no multicast)": mlp.FUSED_PROBE_CLUSTER_1}
    for name, with_ln, line in (("mlp_fused", False, 188), ("mlp_ln_fused", True, 332)):
        errors, times = [], {}
        for i, (shape, m, k, nf) in enumerate([("classifier", BATCH * 197, 768, 3072),
                                               ("MAE decoder", BATCH * 197, 512, 2048)]):
            x = randn(m, k)
            s, t = affine(k) if with_ln else (None, None)
            w1, b1 = randn(nf, k, scale=k ** -0.5), randn(nf, scale=0.5)
            w2, b2 = randn(k, nf, scale=nf ** -0.5), randn(k, scale=0.5)

            def probe_run(probe, write_h=True):
                return lambda: mlp._fused_kernel(x, s, t, w1, b1, w2, b2, 1e-6, write_h, probe)

            run, first = probe_run(0), probe_run(mlp.FUSED_PROBE_FIRST_DESIGN)
            plain = lambda: mlp._mlp_forward_plain(x, s, t, w1, b1, w2, b2, 1e-6)  # noqa: E731

            def unfused():
                a = x if s is None else layernorm._forward_kernel(x, s, t, 1e-6)
                out = layers.linear(mlp.fc1_gelu_reference(a, w1, b1), w2, b2)
                return out if s is None else x + out

            (h, out), (h2, out2), (_, out3) = run(), run(), probe_run(0, False)()
            first_h, first_out = first()
            torch.cuda.synchronize()
            what = f"{name} ({m}, {k}) -> {nf} -> {k}, h written"
            ref_h, ref_out = plain()
            errors.append(max(max_error(h, ref_h, FUSED_TOL, f"{what}: h"),
                              max_error(out, ref_out, FUSED_TOL, f"{what}: out")))
            first_err = max(max_error(first_h, ref_h, FUSED_TOL, f"{what}: first design's h"),
                            max_error(first_out, ref_out, FUSED_TOL, f"{what}: first design's out"))
            if not (torch.equal(h, h2) and torch.equal(out, out2)):
                fail(f"{what}: two runs gave different bits")
            if not torch.equal(out, out3):
                fail(f"{what}: out differs without h")
            times[i] = time_ms(run), time_ms(plain), time_ms(unfused), time_ms(first)
            print(f"{what}: max |diff| {errors[-1]:.3e} (atol {FUSED_TOL[0]}, rtol "
                  f"{FUSED_TOL[1]}); rerun and without h bit-identical")
            print(f"  {shape}'s shape: kernel {times[i][0]:.4f} ms, without h "
                  f"{time_ms(probe_run(0, False)):.4f} ms, first design {times[i][3]:.4f} ms "
                  f"(max |diff| {first_err:.3e}), plain {times[i][1]:.4f} ms, unfused bf16 chain "
                  f"{times[i][2]:.4f} ms, {bound_text(**fused_cost(m, k, nf, with_ln))}")
            print(f"  {shape}'s shape, ablations (wrong results but the clusters', timed only): "
                  + ", ".join(f"{label} {time_ms(probe_run(probe)):.4f} ms"
                              for label, probe in ablations.items()))
        m, k, nf = BATCH * 197, 768, 3072
        report[name] = entry(
            "mlp.cu", f"ssl4polyp_tpu/ops/mlp.py:{line}", max(errors), *times[0][:2],
            **fused_cost(m, k, nf, with_ln))
    return report


def attn_proj_cost(b, n, h, hd):
    """The attention+projection kernel's bytes and operations, forward and
    backward: qkv, W, b (and dy) in, y (and dqkv, dW, db) out once."""
    d = h * hd
    core, proj = b * h * n * n * hd, b * n * d * d
    return (dict(bytes_moved=2 * (4 * b * n * d + d * d + d), flops=4 * core + 2 * proj),
            dict(bytes_moved=2 * (7 * b * n * d + 2 * d * d + d), flops=12 * core + 4 * proj))


def qkvproj_cost(b, n, d_in, h, hd):
    """The projection + attention kernel's bytes and operations, forward and
    backward: x, W, b (and dout) in, out (and dx, dW, db) out once."""
    d = h * hd
    core, proj = b * h * n * n * hd, b * n * d_in * 3 * d
    return (dict(bytes_moved=2 * (b * n * (d_in + d) + d_in * 3 * d + 3 * d),
                 flops=2 * proj + 4 * core),
            dict(bytes_moved=2 * (b * n * (2 * d_in + d) + 2 * (d_in * 3 * d + 3 * d)),
                 flops=6 * proj + 10 * core))


def qkvproj_backward_split(x, w, bias, dout, h, f32, first_design: bool) -> dict[str, tuple]:
    """The projection + attention backward's launches, each timed alone on one
    plan's buffers (each finds what the earlier ones left there), of the
    first design or the second: {step: (ms, bound text)}.  The first design
    has no transpose or projection launch: its attention kernel recomputes qkv
    per head."""
    b, n, d_in = x.shape
    three_d = w.shape[1]
    m, hd = b * n, three_d // 3 // h
    run, _ = attention_block._backward_plan(x, w, bias, dout, h, f32, None, first_design)
    run(0)
    slices = (attention_block._FIRST_DESIGN_DW_SLICES if first_design
              else _build.library().ssl4polyp_dw_product_slices(m, d_in, three_d))
    product = dict(flops=2 * m * d_in * three_d)
    act = 2 * m * three_d  # a (B, N, 3D) bf16 tensor's bytes
    cost = {  # what each reads and writes once, and its operations
        "transpose": dict(bytes_moved=4 * d_in * three_d, flops=0),
        "projection": dict(bytes_moved=2 * m * d_in + 2 * d_in * three_d + act, **product),
        "attention": dict(bytes_moved=2 * act + 2 * m * three_d // 3 + 2 * three_d
                          + 4 * b * three_d + (2 * m * d_in + 2 * d_in * three_d
                                               if first_design else 0),
                          flops=10 * b * h * n * n * hd
                          + (2 * m * d_in * three_d if first_design else 0)),
        "db sum": dict(bytes_moved=4 * (b + 1) * three_d, flops=b * three_d, peak=FP32_FLOPS),
        "dx": dict(bytes_moved=act + 2 * d_in * three_d + 2 * m * d_in, **product),
        "dw": dict(bytes_moved=2 * m * d_in + act + 4 * slices * d_in * three_d, **product),
        "dw sum": dict(bytes_moved=4 * (slices + 1) * d_in * three_d if slices > 1 else 0,
                       flops=slices * d_in * three_d, peak=FP32_FLOPS),
    }
    skip = ("transpose", "projection") if first_design else ()
    return {step: (time_ms(lambda: run(bit)), bound_text(**cost[step]))  # noqa: B023
            for step, bit in attention_block.BACKWARD_STEPS.items() if step not in skip}


def attn_proj_kernels(randn) -> dict[str, dict]:
    """The attention+projection kernel, forward and backward, against its
    plain version: the classifier's call (fp32 scores), the MAE decoder's
    (16 heads of 32, bf16 scores) and a padded one (keys past ``valid_len``
    masked, the pad rows' upstream gradient zero).  Beside each, the library
    route for the same function: scaled_dot_product_attention and F.linear,
    and their autograd backward."""
    fwd_errors, bwd_errors, fwd_times, bwd_times = [], [], {}, {}
    cases = [(BATCH, 197, 12, 64, True, None), (BATCH, 197, 16, 32, False, None),
             (BATCH, 197, 12, 64, True, 150)]
    for i, (b, n, h, hd, f32, valid_len) in enumerate(cases):
        d = h * hd
        qkv, dy = randn(b, n, 3 * d), randn(b, n, d)
        w, bias = randn(d, d, scale=d ** -0.5), randn(d, scale=0.5)
        rows = n if valid_len is None else valid_len
        dy[:, rows:] = 0
        run = lambda: attn_proj._forward_kernel(qkv, w, bias, h, f32, valid_len)  # noqa: E731
        plain = lambda: attn_proj.fused_attention_proj_reference(qkv, w, bias, h, f32, valid_len)  # noqa: E731
        run_bwd = lambda: attn_proj._backward_kernel(qkv, w, bias, dy, h, f32, valid_len)  # noqa: E731
        plain_bwd = lambda: attn_proj.fused_attention_proj_backward_reference(  # noqa: E731
            qkv, w, bias, dy, h, f32, valid_len)
        y, grads, again = run(), run_bwd(), run_bwd()
        torch.cuda.synchronize()
        what = f"attn_proj B={b} N={n} H={h} hd={hd} f32={f32} valid_len={valid_len}"
        fwd_errors.append(max_error(y[:, :rows], plain()[:, :rows], ATTN_PROJ_TOL, f"{what}: y"))
        ref = plain_bwd()
        bwd_errors.append(max_error(grads[0], ref[0], ATTENTION_BWD_TOL, f"{what}: dqkv"))
        line = (f"{what}: y max |diff| {fwd_errors[-1]:.3e} (atol {ATTN_PROJ_TOL[0]}, rtol "
                f"{ATTN_PROJ_TOL[1]}), dqkv {bwd_errors[-1]:.3e} (atol {ATTENTION_BWD_TOL[0]}, "
                f"rtol {ATTENTION_BWD_TOL[1]})")
        for name, got, want in (("dw", grads[1], ref[1]), ("db", grads[2], ref[2])):
            tol = (ATTN_PROJ_PARAM_TOL[0] * want.float().abs().max().item(), ATTN_PROJ_PARAM_TOL[1])
            err = max_error(got, want, tol, f"{what}: {name}")
            line += f", {name} {err:.3e} (atol {tol[0]:.3e}, rtol {tol[1]})"
        if not all(torch.equal(a, g) for a, g in zip(again, grads)):
            fail(f"{what}: two backward runs gave different bits")
        print(line + "; rerun bit-identical")
        if valid_len is not None:
            continue
        leaves = [t.clone().requires_grad_() for t in (qkv, w, bias)]

        def library(leaves=leaves):
            out = F.scaled_dot_product_attention(*heads_of(leaves[0], h))
            return F.linear(out.transpose(1, 2).reshape(b, n, d), leaves[1], leaves[2])

        lib_y = library()
        library_bwd = lambda: torch.autograd.grad(lib_y, leaves, dy, retain_graph=True)  # noqa: E731
        with torch.no_grad():
            fwd_times[i] = time_ms(run), time_ms(plain), time_ms(library)
        bwd_times[i] = time_ms(run_bwd), time_ms(plain_bwd), time_ms(library_bwd)
        fwd_cost, bwd_cost = attn_proj_cost(b, n, h, hd)
        print(f"  forward kernel {fwd_times[i][0]:.4f} ms, plain {fwd_times[i][1]:.4f} ms, "
              f"scaled_dot_product_attention + F.linear {fwd_times[i][2]:.4f} ms, "
              f"{bound_text(**fwd_cost)}; backward kernels {bwd_times[i][0]:.4f} ms, plain "
              f"{bwd_times[i][1]:.4f} ms, the library pair's {bwd_times[i][2]:.4f} ms, "
              f"{bound_text(**bwd_cost)}")
        # The backward's four phases apart, on one plan's buffers (each phase
        # finds what the earlier ones left there), each beside its bound.
        core, proj, act = b * h * n * n * hd, b * n * d * d, 2 * b * n * d
        launch, _ = attn_proj._backward_plan(qkv, w, bias, dy, h, f32, valid_len)
        launch(sum(attn_proj.BACKWARD_PHASES.values()))
        phase_cost = {  # (what it reads and writes once, its operations, their peak rate)
            "prep": (3 * act + act + 2 * act + 4 * d * d, 4 * core + 2 * proj, BF16_FLOPS),
            "dw": (2 * act + 4 * d * d, 2 * proj, BF16_FLOPS),
            "db": (act + 4 * d, b * n * d, FP32_FLOPS),
            "attention": (3 * act + act + 3 * act, 10 * core, BF16_FLOPS),
        }
        phase_ms = {phase: time_ms(lambda: launch(bit))  # noqa: B023
                    for phase, bit in attn_proj.BACKWARD_PHASES.items()}
        dw_first_ms = time_ms(lambda: launch(attn_proj.DW_FIRST_DESIGN_PHASE))  # noqa: B023
        print("    backward's phases: " + "; ".join(
            f"{phase} {ms:.4f} ms, {bound_text(*phase_cost[phase])}"
            for phase, ms in phase_ms.items())
            + f"; dw on its first design (mma.sync) {dw_first_ms:.4f} ms")
        # Where the forward's time goes: the kernel without its attention
        # arithmetic, without its projection's products, without both (wrong
        # results; the copies, barriers, W ring and stores stay).
        with torch.no_grad():
            ablated = [time_ms(lambda: attn_proj._forward_kernel(  # noqa: B023
                qkv, w, bias, h, f32, valid_len, ablate)) for ablate in (1, 2, 3)]
        print("    forward without the attention arithmetic {:.4f} ms, without the wgmma "
              "{:.4f} ms, without both {:.4f} ms".format(*ablated))
        del leaves, lib_y
    fwd_cost, bwd_cost = attn_proj_cost(*cases[0][:4])
    return {
        "attn_proj": entry(
            "attn_proj.cu", "ssl4polyp_tpu/ops/attn_proj.py:77", max(fwd_errors),
            *fwd_times[0][:2], **fwd_cost, library_ms=fwd_times[0][2]),
        "attn_proj_backward": entry(
            "attn_proj.cu", "ssl4polyp_tpu/ops/attn_proj.py:90", max(bwd_errors),
            *bwd_times[0][:2], **bwd_cost, library_ms=bwd_times[0][2]),
        **long_projection_kernels(randn, fold=True),
    }


def attention_ops_kernels(randn) -> dict[str, dict]:
    """The two attention functions of ``ops`` that no model route calls,
    forward and backward, against their plain versions at the classifier's
    shape and the MAE decoder's: attention over separate q, k, v (each
    direction also through its first design, held to the plain version, and
    timed with parts left out, through the kernels' probes), and the QKV
    projection with the attention core (both ``softmax_f32`` settings and a
    ``valid_len`` below the token count).  Beside each, the library route
    for the same function, timed only, and the bound."""
    report = {}
    fwd_errors, bwd_errors, fwd_times, bwd_times = [], [], {}, {}
    fwd_ablations = {"without the softmax arithmetic": attention.PROBE_NO_SOFTMAX,
                     "without P.V": attention.PROBE_NO_VALUES,
                     "without the prefetch": attention.PROBE_NO_PREFETCH,
                     "without the exponential": attention.PROBE_NO_EXP}
    bwd_ablations = {"without phase B": attention.BACKWARD_PROBE_NO_PHASE_B,
                     "phase A stopped after the softmax": attention.BACKWARD_PROBE_SOFTMAX_ONLY,
                     "phase A's softmax alone": (attention.BACKWARD_PROBE_SOFTMAX_ONLY
                                                 | attention.BACKWARD_PROBE_NO_PHASE_B),
                     "without the second terms": attention.BACKWARD_PROBE_ONE_TERM,
                     "without the prefetch": attention.BACKWARD_PROBE_NO_PREFETCH}
    for i, (b, h, n, hd) in enumerate([(BATCH, 12, 197, 64), (BATCH, 16, 197, 32)]):
        q, k, v, dout = (randn(b, h, n, hd) for _ in range(4))

        def probe_run(probe, q=q, k=k, v=v):
            return lambda: attention._forward_kernel(q, k, v, probe)

        run, first = probe_run(0), probe_run(attention.PROBE_FIRST_DESIGN)
        plain = lambda: attention.fused_attention_reference(q, k, v)  # noqa: E731

        def probe_bwd(probe, q=q, k=k, v=v, dout=dout):
            return lambda: attention._backward_kernel(q, k, v, dout, probe)

        run_bwd, first_bwd = probe_bwd(0), probe_bwd(attention.BACKWARD_PROBE_FIRST_DESIGN)
        plain_bwd = lambda: attention.fused_attention_backward_reference(q, k, v, dout)  # noqa: E731
        out, again, first_out = run(), run(), first()
        grads, grads_again, first_grads = run_bwd(), run_bwd(), first_bwd()
        torch.cuda.synchronize()
        what = f"fused_attention B={b} H={h} N={n} hd={hd}"
        ref, ref_grads = plain(), plain_bwd()
        fwd_errors.append(max_error(out, ref, ATTENTION_TOL, f"{what}: out"))
        first_err = max_error(first_out, ref, ATTENTION_TOL, f"{what}: first design")
        bwd_errors.append(max(max_error(got, want, ATTENTION_BWD_TOL, f"{what}: {name}")
                              for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads)))
        first_bwd_err = max(
            max_error(got, want, ATTENTION_BWD_TOL, f"{what}: backward first design, {name}")
            for name, got, want in zip(("dq", "dk", "dv"), first_grads, ref_grads))
        del ref_grads, first_grads
        if not torch.equal(out, again):
            fail(f"{what}: two forward runs gave different bits")
        if not all(torch.equal(a, g) for a, g in zip(grads_again, grads)):
            fail(f"{what}: two backward runs gave different bits")
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        library = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        lib_out = F.scaled_dot_product_attention(*leaves)
        library_bwd = lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True)  # noqa: E731
        fwd_times[i] = time_ms(run), time_ms(plain), time_ms(library), time_ms(first)
        bwd_times[i] = (time_ms(run_bwd), time_ms(plain_bwd), time_ms(library_bwd),
                        time_ms(first_bwd))
        elements, core = b * h * n * hd, b * h * n * n * hd
        print(f"{what}: out max |diff| {fwd_errors[-1]:.3e}, first design {first_err:.3e} (atol "
              f"{ATTENTION_TOL[0]}, rtol {ATTENTION_TOL[1]}), dq, dk, dv {bwd_errors[-1]:.3e}, "
              f"first design {first_bwd_err:.3e} (atol {ATTENTION_BWD_TOL[0]}, rtol "
              f"{ATTENTION_BWD_TOL[1]}); forward and backward reruns bit-identical")
        print(f"  forward kernel {fwd_times[i][0]:.4f} ms, first design {fwd_times[i][3]:.4f} ms, "
              f"plain {fwd_times[i][1]:.4f} ms, scaled_dot_product_attention {fwd_times[i][2]:.4f} "
              f"ms, {bound_text(2 * 4 * elements, 4 * core)}; backward kernel "
              f"{bwd_times[i][0]:.4f} ms, first design {bwd_times[i][3]:.4f} ms, plain "
              f"{bwd_times[i][1]:.4f} ms, scaled_dot_product_attention's backward "
              f"{bwd_times[i][2]:.4f} ms, {bound_text(2 * 7 * elements, 10 * core)}")
        print("  forward ablations (wrong results, timed only): "
              + ", ".join(f"{label} {time_ms(probe_run(probe)):.4f} ms"
                          for label, probe in fwd_ablations.items()))
        print("  backward ablations (timed only; all but the last give wrong results): "
              + ", ".join(f"{label} {time_ms(probe_bwd(probe)):.4f} ms"
                          for label, probe in bwd_ablations.items()))
        del leaves, lib_out
    b, h, n, hd = BATCH, 12, 197, 64
    elements, core = b * h * n * hd, b * h * n * n * hd
    report["fused_attention"] = entry(
        "attention.cu", "ssl4polyp_tpu/ops/attention.py:118", max(fwd_errors), *fwd_times[0][:2],
        bytes_moved=2 * 4 * elements, flops=4 * core, library_ms=fwd_times[0][2])
    report["fused_attention_backward"] = entry(
        "attention.cu", "ssl4polyp_tpu/ops/attention.py:142", max(bwd_errors), *bwd_times[0][:2],
        bytes_moved=2 * 7 * elements, flops=10 * core, library_ms=bwd_times[0][2])
    report.update(wide_separate_attention_kernels(randn))

    fwd_errors, bwd_errors, fwd_times, bwd_times = [], [], {}, {}
    cases = [(BATCH, 197, 768, 12, 64, True, None), (BATCH, 197, 512, 16, 32, False, None),
             (BATCH, 197, 768, 12, 64, False, 150), (BATCH, 197, 512, 16, 32, True, 150),
             (2, 50, 64, 3, 32, False, 40)]  # an odd head count at hd 32: 3D = 288
    qkvproj_ablations = {"without the softmax arithmetic": attention_block.PROBE_NO_SOFTMAX,
                         "without the projection's products": attention_block.PROBE_NO_PROJECTION,
                         "without the prefetch": attention_block.PROBE_NO_PREFETCH,
                         "the projection alone": attention_block.PROBE_PROJECTION_ONLY}
    for i, (b, n, d_in, h, hd, f32, valid_len) in enumerate(cases):
        d = h * hd
        x, dout = randn(b, n, d_in), randn(b, n, d)
        w, bias = randn(d_in, 3 * d, scale=d_in ** -0.5), randn(3 * d, scale=0.5)
        rows = n if valid_len is None else valid_len
        dout[:, rows:] = 0  # the pad rows' upstream gradient is zero

        def probe_run(probe, x=x, w=w, bias=bias, h=h, f32=f32, valid_len=valid_len):
            return lambda: attention_block._forward_kernel(x, w, bias, h, f32, valid_len, probe)

        run, first = probe_run(0), probe_run(attention_block.PROBE_FIRST_DESIGN)
        plain = lambda: attention_block.fused_qkvproj_attention_reference(  # noqa: E731
            x, w, bias, h, f32, valid_len)
        run_bwd = lambda: attention_block._backward_kernel(x, w, bias, dout, h, f32, valid_len)  # noqa: E731
        plain_bwd = lambda: attention_block.fused_qkvproj_attention_backward_reference(  # noqa: E731
            x, w, bias, dout, h, f32, valid_len)
        out, out_again, first_out = run(), run(), first()
        grads, again = run_bwd(), run_bwd()
        torch.cuda.synchronize()
        what = (f"fused_qkvproj_attention B={b} N={n} Din={d_in} H={h} hd={hd} f32={f32} "
                f"valid_len={valid_len}")
        ref = plain()[:, :rows]
        fwd_errors.append(max_error(out[:, :rows], ref, QKVPROJ_TOL, f"{what}: out"))
        first_err = max_error(first_out[:, :rows], ref, QKVPROJ_TOL, f"{what}: first design")
        if not torch.equal(out, out_again):
            fail(f"{what}: two forward runs gave different bits")
        line = (f"{what}: out max |diff| {fwd_errors[-1]:.3e}, first design {first_err:.3e} (atol "
                f"{QKVPROJ_TOL[0]}, rtol {QKVPROJ_TOL[1]})")
        worst = 0.0
        for name, got, want in zip(("dx", "dw", "db"), grads, plain_bwd()):
            tol = (QKVPROJ_GRAD_TOL[0] * want.float().abs().max().item(), QKVPROJ_GRAD_TOL[1])
            err = max_error(got, want, tol, f"{what}: {name}")
            worst = max(worst, err)
            line += f", {name} {err:.3e} (atol {tol[0]:.3e}, rtol {tol[1]})"
        bwd_errors.append(worst)
        if not all(torch.equal(a, g) for a, g in zip(again, grads)):
            fail(f"{what}: two backward runs gave different bits")
        print(line + "; forward and backward reruns bit-identical")
        if valid_len is not None:
            continue
        leaves = [t.clone().requires_grad_() for t in (x, w.t().contiguous(), bias)]

        def library(leaves=leaves):
            qkv = F.linear(leaves[0], leaves[1], leaves[2])
            out = F.scaled_dot_product_attention(*heads_of(qkv, h))
            return out.transpose(1, 2).reshape(b, n, d)

        lib_out = library()
        library_bwd = lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True)  # noqa: E731
        first_bwd = lambda: attention_block._backward_kernel(  # noqa: E731
            x, w, bias, dout, h, f32, valid_len, attention_block.BACKWARD_PROBE_FIRST_DESIGN)
        first_grads = first_bwd()
        first_bwd_err = max(
            max_error(got, want, (QKVPROJ_GRAD_TOL[0] * want.float().abs().max().item(),
                                  QKVPROJ_GRAD_TOL[1]), f"{what}: first design's {name}")
            for name, got, want in zip(("dx", "dw", "db"), first_grads, plain_bwd()))
        with torch.no_grad():
            fwd_times[i] = time_ms(run), time_ms(plain), time_ms(library), time_ms(first)
        bwd_times[i] = (time_ms(run_bwd), time_ms(plain_bwd), time_ms(library_bwd),
                        time_ms(first_bwd))
        fwd_cost, bwd_cost = qkvproj_cost(b, n, d_in, h, hd)
        print(f"  forward kernel {fwd_times[i][0]:.4f} ms, first design {fwd_times[i][3]:.4f} ms, "
              f"plain {fwd_times[i][1]:.4f} ms, F.linear + scaled_dot_product_attention "
              f"{fwd_times[i][2]:.4f} ms, {bound_text(**fwd_cost)}; backward kernels "
              f"{bwd_times[i][0]:.4f} ms, first design {bwd_times[i][3]:.4f} ms (max |diff| "
              f"{first_bwd_err:.3e}), plain {bwd_times[i][1]:.4f} ms, the library pair's "
              f"{bwd_times[i][2]:.4f} ms, {bound_text(**bwd_cost)}")
        for label, first_design in (("launches alone", False), ("first design's launches alone",
                                                                  True)):
            split = qkvproj_backward_split(x, w, bias, dout, h, f32, first_design)
            print(f"    backward's {label}: " + "; ".join(
                f"{step} {ms:.4f} ms, {text}" for step, (ms, text) in split.items()))
        print("  forward ablations (timed only; the projection alone is right, the rest "
              "wrong): " + ", ".join(f"{label} {time_ms(probe_run(probe)):.4f} ms"
                                     for label, probe in qkvproj_ablations.items()))
        del leaves, lib_out
    fwd_cost, bwd_cost = qkvproj_cost(*cases[0][:5])
    report["fused_qkvproj_attention"] = entry(
        "attention_block.cu", "ssl4polyp_tpu/ops/attention_block.py:187", max(fwd_errors),
        *fwd_times[0][:2], **fwd_cost, library_ms=fwd_times[0][2])
    report["fused_qkvproj_attention_backward"] = entry(
        "attention_block.cu", "ssl4polyp_tpu/ops/attention_block.py:224", max(bwd_errors),
        *bwd_times[0][:2], **bwd_cost, library_ms=bwd_times[0][2])
    report.update(long_projection_kernels(randn, fold=False))
    return report


def wide_separate_attention_kernels(randn) -> dict[str, dict]:
    """Attention over separate q, k, v where ``attention.cu``'s kernels stop:
    bf16 past 256 tokens (the key tiles in its layout, W and dS as two bf16
    terms) and fp32 at any N (the fp32 kernels in its layout, the scale
    inside dS), forward and backward, against the plain versions at the
    classifier's heads (12 of 64) and the MAE decoder's (16 of 32): bf16 at
    577 tokens, fp32 at 197 and 577.  Max error, reruns bit-identical (the
    fp32 backward also from (q, k, v, dout) alone), times beside the plain
    versions', SDPA's and its backward's in the same dtype (timed only) and
    the bound; the key tiles' gradient pass's plan at both head dims."""
    def cost(b, h, n, hd, size, peak):  # q, k, v in and out out; two products
        return dict(bytes_moved=size * 4 * b * h * n * hd, flops=4 * b * h * n * n * hd,
                    peak=peak)

    def bwd_cost(b, h, n, hd, size, peak):  # q, k, v, dout in; dq, dk, dv out; five products
        return dict(bytes_moved=size * 7 * b * h * n * hd, flops=10 * b * h * n * n * hd,
                    peak=peak)

    for hd in (64, 32):
        plan = attention.tiles_backward_plan(hd)
        print(f"fused_attention key tiles' gradient pass at hd {hd}: {plan['warps']} warps a "
              f"block, {plan['smem_bytes']} bytes of shared memory, {plan['blocks_per_sm']} "
              f"blocks an SM (occupancy API)")
    cases = [(torch.bfloat16, BATCH, 12, 577, 64, "classifier at 384 px"),
             (torch.bfloat16, BATCH, 16, 577, 32, "MAE decoder at 384 px"),
             (torch.float32, BATCH, 12, 197, 64, "classifier"),
             (torch.float32, BATCH, 16, 197, 32, "MAE decoder"),
             (torch.float32, BATCH, 12, 577, 64, "classifier at 384 px"),
             (torch.float32, BATCH, 16, 577, 32, "MAE decoder at 384 px")]
    errors, times = {}, {}
    for dtype, b, h, n, hd, name in cases:
        f32 = dtype == torch.float32
        q, k, v, dout = (randn(b, h, n, hd, dtype=dtype) for _ in range(4))
        run = lambda: attention._forward_kernel(q, k, v)  # noqa: E731
        plain = lambda: attention.fused_attention_reference(q, k, v)  # noqa: E731
        if f32:  # the backward as the autograd path runs it: from the output and lse
            saved, lse = attention._forward_kernel(q, k, v, lse=True)
        else:
            saved = lse = None
        run_bwd = lambda: attention._backward_kernel(q, k, v, dout, out=saved, lse=lse)  # noqa: B023, E731
        plain_bwd = lambda: attention.fused_attention_backward_reference(q, k, v, dout)  # noqa: E731
        out, again = run(), run()
        grads, grads_again = run_bwd(), run_bwd()
        alone = attention._backward_kernel(q, k, v, dout) if f32 else grads
        torch.cuda.synchronize()
        label = "fp32" if f32 else "bf16"
        what = f"fused_attention {label} B={b} H={h} N={n} hd={hd}"
        ref, ref_grads = plain(), plain_bwd()
        if f32:
            fwd_err = max_relative_error(out, ref, FP32_FWD_FRAC, f"{what}: out")
            bwd_err = max((max_relative_error(got, want, FP32_GRAD_FRAC, f"{what}: {part}")
                           for part, got, want in zip(("dq", "dk", "dv"), grads, ref_grads)),
                          key=lambda e: e[0])
            line = (f"{what}: out {fwd_err[0]:.3e}, worst of dq, dk, dv {bwd_err[0]:.3e} of max "
                    f"|plain| (limits {FP32_FWD_FRAC}, {FP32_GRAD_FRAC})")
            fwd_err, bwd_err = fwd_err[1], bwd_err[1]
        else:
            fwd_err = max_error(out, ref, ATTENTION_TOL, f"{what}: out")
            bwd_err = max(max_error(got, want, ATTENTION_BWD_TOL, f"{what}: {part}")
                          for part, got, want in zip(("dq", "dk", "dv"), grads, ref_grads))
            line = (f"{what}: out max |diff| {fwd_err:.3e} (atol {ATTENTION_TOL[0]}, rtol "
                    f"{ATTENTION_TOL[1]}), dq, dk, dv {bwd_err:.3e} (atol "
                    f"{ATTENTION_BWD_TOL[0]}, rtol {ATTENTION_BWD_TOL[1]})")
        if f32 and not torch.equal(out, saved):
            fail(f"{what}: the forward with and without the log-sum-exp gave different bits")
        if not torch.equal(out, again) or not all(
                torch.equal(a, g) for other in (grads_again, alone) for a, g in zip(other, grads)):
            fail(f"{what}: two runs gave different bits")
        print(line + "; reruns bit-identical" + (", and the backward from (q, k, v, dout) alone"
                                                 if f32 else ""))
        del ref, ref_grads, alone
        errors.setdefault(label, []).append((fwd_err, bwd_err))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        library = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        lib_out = F.scaled_dot_product_attention(*leaves)
        library_bwd = lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True)  # noqa: E731
        key = (label, n, name)
        times[key] = (time_ms(run), time_ms(plain), time_ms(library), time_ms(run_bwd),
                      time_ms(plain_bwd), time_ms(library_bwd))
        size, peak = (4, FP32_FLOPS) if f32 else (2, BF16_FLOPS)
        print(f"  {name}'s shape: forward kernel {times[key][0]:.4f} ms, plain "
              f"{times[key][1]:.4f} ms, {label} scaled_dot_product_attention "
              f"{times[key][2]:.4f} ms, {bound_text(**cost(b, h, n, hd, size, peak))}; backward "
              f"kernel {times[key][3]:.4f} ms, plain {times[key][4]:.4f} ms, its backward "
              f"{times[key][5]:.4f} ms, {bound_text(**bwd_cost(b, h, n, hd, size, peak))}; "
              f"{CARD}")
        del leaves, lib_out, saved, lse
    report = {}
    for names, label, source, n, shape_name, size, peak in (
            (("fused_attention_tiles", "fused_attention_tiles_backward"), "bf16",
             "qkv_attention_tiles.cu", 577, "classifier at 384 px", 2, BF16_FLOPS),
            (("fused_attention_f32", "fused_attention_backward_f32"), "fp32",
             "qkv_attention_f32.cu", 197, "classifier", 4, FP32_FLOPS)):
        t = times[(label, n, shape_name)]
        shape = (BATCH, 12, n, 64, size, peak)
        report[names[0]] = entry(source, "ssl4polyp_tpu/ops/attention.py:118",
                                 max(e[0] for e in errors[label]), t[0], t[1], **cost(*shape),
                                 library_ms=t[2])
        report[names[1]] = entry(source, "ssl4polyp_tpu/ops/attention.py:142",
                                 max(e[1] for e in errors[label]), t[3], t[4], **bwd_cost(*shape),
                                 library_ms=t[5])
    return report


def long_projection_kernels(randn, fold: bool) -> dict[str, dict]:
    """Attention with the output projection (``fold``) or the QKV
    projection with attention past 256 tokens in bf16 (their compositions
    on the key tiles), forward and backward, against the plain versions at
    a ViT-B/16's shapes at 384 px: the classifier's (12 heads of 64, fp32
    scores; also with ``valid_len`` 500, its pad rows' upstream gradient
    zero) and the MAE decoder's (16 heads of 32, D 512, bf16 scores); and
    at 300 tokens with an odd head count where the width allows it.  Max
    error, reruns bit-identical, the launches counted, and at the two model
    shapes the times beside the plain versions', the library route's
    (scaled_dot_product_attention and F.linear, and their autograd
    backward; timed only) and the bound.  The plain versions at 577 tokens
    form fp32 score tensors of 1 GB: they are timed over 3 batches of 5."""
    name = "fused_attention_proj_tiles" if fold else "fused_qkvproj_attention_tiles"
    cases = [(BATCH, 577, 768, 12, 64, True, None, "classifier at 384 px"),
             (BATCH, 577, 768, 12, 64, True, 500, "classifier at 384 px, valid_len 500"),
             (BATCH, 577, 512, 16, 32, False, None, "MAE decoder at 384 px"),
             (4, 300, 128 if fold else 192, 4 if fold else 3, 32, True, 299, "300 tokens")]
    fwd_errors, bwd_errors, times = [], [], {}
    for b, n, d_in, h, hd, f32, valid_len, label in cases:
        d = h * hd
        rows = n if valid_len is None else valid_len
        dout = randn(b, n, d)
        dout[:, rows:] = 0
        if fold:
            inputs = (randn(b, n, 3 * d), randn(d, d, scale=d ** -0.5), randn(d, scale=0.5))
            module, tol, grad_tol = attn_proj, ATTN_PROJ_TOL, ATTN_PROJ_PARAM_TOL
            plain = lambda: attn_proj.fused_attention_proj_reference(*inputs, h, f32, valid_len)  # noqa: B023, E731
            plain_bwd = lambda: attn_proj.fused_attention_proj_backward_reference(  # noqa: E731
                *inputs, dout, h, f32, valid_len)  # noqa: B023
            grad_names = ("dqkv", "dw", "db")
        else:
            inputs = (randn(b, n, d_in), randn(d_in, 3 * d, scale=d_in ** -0.5),
                      randn(3 * d, scale=0.5))
            module, tol, grad_tol = attention_block, QKVPROJ_TOL, QKVPROJ_GRAD_TOL
            plain = lambda: attention_block.fused_qkvproj_attention_reference(  # noqa: E731
                *inputs, h, f32, valid_len)  # noqa: B023
            plain_bwd = lambda: attention_block.fused_qkvproj_attention_backward_reference(  # noqa: E731
                *inputs, dout, h, f32, valid_len)  # noqa: B023
            grad_names = ("dx", "dw", "db")
        run = lambda: module._forward_kernel(*inputs, h, f32, valid_len)  # noqa: B023, E731
        run_bwd = lambda: module._backward_kernel(*inputs, dout, h, f32, valid_len)  # noqa: B023, E731
        ops.reset_launch_counts()
        out, out_again, grads, grads_again = run(), run(), run_bwd(), run_bwd()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check_counts(counts, {name: 1, f"{name}_backward": 1, "qkv_attention_tiles_statistics": 1},
                     2, f"{name}, {label}")
        what = (f"{name} B={b} N={n}{'' if fold else f' Din={d_in}'} H={h} hd={hd} f32={f32} "
                f"valid_len={valid_len}")
        fwd_errors.append(max_error(out[:, :rows], plain()[:, :rows], tol, f"{what}: out"))
        line = (f"{what}: out max |diff| {fwd_errors[-1]:.3e} (atol {tol[0]}, rtol {tol[1]})")
        worst = 0.0
        for grad_name, got, want in zip(grad_names, grads, plain_bwd()):
            if grad_name == "dqkv":
                err_tol = ATTENTION_BWD_TOL
            else:  # sums over every row of the batch (dx over 3D columns)
                err_tol = (grad_tol[0] * want.float().abs().max().item(), grad_tol[1])
            err = max_error(got, want, err_tol, f"{what}: {grad_name}")
            worst = max(worst, err)
            line += f", {grad_name} {err:.3e} (atol {err_tol[0]:.3e}, rtol {err_tol[1]})"
        bwd_errors.append(worst)
        if not torch.equal(out, out_again) or not all(
                torch.equal(a, g) for a, g in zip(grads, grads_again)):
            fail(f"{what}: two runs gave different bits")
        print(line + "; forward and backward reruns bit-identical")
        if valid_len is not None:
            continue
        if fold:
            leaves = [t.clone().requires_grad_() for t in inputs]

            def library(leaves=leaves, b=b, n=n, d=d, h=h):
                core = F.scaled_dot_product_attention(*heads_of(leaves[0], h))
                return F.linear(core.transpose(1, 2).reshape(b, n, d), leaves[1], leaves[2])
            fwd_cost, bwd_cost = attn_proj_cost(b, n, h, hd)
        else:
            leaves = [t.clone().requires_grad_()
                      for t in (inputs[0], inputs[1].t().contiguous(), inputs[2])]

            def library(leaves=leaves, b=b, n=n, d=d, h=h):
                core = F.scaled_dot_product_attention(*heads_of(
                    F.linear(leaves[0], leaves[1], leaves[2]), h))
                return core.transpose(1, 2).reshape(b, n, d)
            fwd_cost, bwd_cost = qkvproj_cost(b, n, d_in, h, hd)
        lib_out = library()
        library_bwd = lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True)  # noqa: B023, E731
        with torch.no_grad():
            fwd = time_ms(run), time_ms(plain, 5, 3), time_ms(library)
        bwd = time_ms(run_bwd), time_ms(plain_bwd, 5, 3), time_ms(library_bwd)
        times[label] = fwd, bwd
        library_name = ("scaled_dot_product_attention + F.linear" if fold
                        else "F.linear + scaled_dot_product_attention")
        print(f"  {label}: forward {fwd[0]:.4f} ms, plain {fwd[1]:.4f} ms, {library_name} "
              f"{fwd[2]:.4f} ms, {bound_text(**fwd_cost)}; backward {bwd[0]:.4f} ms, plain "
              f"{bwd[1]:.4f} ms, the library pair's {bwd[2]:.4f} ms, {bound_text(**bwd_cost)}; "
              f"{CARD}")
        del leaves, lib_out
    b, n, d_in, h, hd = cases[0][:5]
    fwd_cost, bwd_cost = attn_proj_cost(b, n, h, hd) if fold else qkvproj_cost(b, n, d_in, h, hd)
    (fwd, bwd), source = times[cases[0][-1]], "attn_proj.cu" if fold else "attention_block.cu"
    replaces = (("ssl4polyp_tpu/ops/attn_proj.py:212", "ssl4polyp_tpu/ops/attn_proj.py:250")
                if fold else ("ssl4polyp_tpu/ops/attention_block.py:187",
                              "ssl4polyp_tpu/ops/attention_block.py:224"))
    return {
        name: entry(source, replaces[0], max(fwd_errors), *fwd[:2], **fwd_cost,
                    library_ms=fwd[2]),
        f"{name}_backward": entry(source, replaces[1], max(bwd_errors), *bwd[:2], **bwd_cost,
                                  library_ms=bwd[2]),
    }


def adamw_kernel(gen: torch.Generator) -> dict[str, dict]:
    """The one-pass AdamW kernel against its plain version on the MAE's and
    the classifier's parameter lists, three steps each: per-tensor scales, a
    frozen tensor, bf16 copies of the matrices.  The parameters, moments and
    copies must be equal bit for bit after every step.  Beside it the library
    route: torch.optim.AdamW(fused=True) and the casts to bf16."""
    report = {}
    mae = MAE(model_config(PretrainSettings(batch_size=BATCH)), torch.Generator().manual_seed(SEED))
    mae_params = {n: p.detach() for n, p in mae.cuda().named_parameters()}
    vit = get_imagenet_or_random_vit(torch.Generator().manual_seed(SEED), num_classes=2,
                                     device="cuda")
    vit_params = {n: p.detach() for n, p in vit.model.named_parameters()}
    lists = [
        ("MAE ViT-B/16", mae_params, optim.pretrain_lr_scales(mae_params), 0.95),
        ("ViT-B/16 classifier", vit_params,
         optim.finetune_lr_scales(vit_params, "full", vit.cfg.depth, head_scale=2.5,
                                  freeze_pos_embed=True), 0.999),
    ]
    for label, params, lr_scale, b2 in lists:
        wd_scale = optim.no_weight_decay_scales(params)
        sides = []
        for _ in range(2):  # the kernel's tensors, then the plain version's
            own = {n: p.clone() for n, p in params.items()}
            sides.append((own, layers.compute_copy(own, torch.bfloat16), optim.adamw_init(own)))
        kwargs = dict(b1=0.9, b2=b2, weight_decay=0.05, lr_scale=lr_scale, wd_scale=wd_scale)
        launches = -(-len(params) // adamw.TENSORS_PER_LAUNCH)
        worst = 0.0
        for step in range(3):
            grads = {n: 0.01 * torch.randn(p.shape, generator=gen, device="cuda")
                     for n, p in params.items()}
            ops.reset_launch_counts()
            optim.adamw_update_fused(*sides[0][:2], grads, sides[0][2], lr=1e-3 * (step + 1), **kwargs)
            if ops.launch_counts()["adamw"] != launches:
                fail(f"adamw {label}: {ops.launch_counts()['adamw']} launches, expected {launches}")
            optim.adamw_update_fused_plain(*sides[1][:2], grads, sides[1][2], lr=1e-3 * (step + 1),
                                           **kwargs)
            torch.cuda.synchronize()
            groups = [(sides[0][0], sides[1][0]), (sides[0][1], sides[1][1]),
                      (sides[0][2].mu, sides[1][2].mu), (sides[0][2].nu, sides[1][2].nu)]
            for what, (got, want) in zip(("parameter", "copy", "mu", "nu"), groups):
                for name in params:
                    if not torch.equal(got[name], want[name]):
                        worst = (got[name].float() - want[name].float()).abs().max().item()
                        fail(f"adamw {label} step {step + 1}: {what} of {name} differs from the "
                             f"plain version's bits (max |diff| {worst})")
        frozen = [n for n, scale in lr_scale.items() if scale == 0.0]
        if not frozen or not all(torch.equal(sides[0][0][n], params[n]) for n in frozen):
            fail(f"adamw {label}: a frozen tensor moved")
        if not all(sides[0][2].mu[n].abs().sum() > 0 for n in frozen):
            fail(f"adamw {label}: a frozen tensor's moments did not move")
        grads = {n: 0.01 * torch.randn(p.shape, generator=gen, device="cuda")
                 for n, p in params.items()}
        run = lambda: optim.adamw_update_fused(*sides[0][:2], grads, sides[0][2], lr=1e-3, **kwargs)  # noqa: E731
        plain = lambda: optim.adamw_update_fused_plain(  # noqa: E731
            *sides[1][:2], grads, sides[1][2], lr=1e-3, **kwargs)
        # The library route, timed only: one fused AdamW step over the same
        # tensors (one learning rate) and the casts of the matrices to bf16.
        lib_params = [p.clone().requires_grad_() for p in params.values()]
        for p, g in zip(lib_params, grads.values()):
            p.grad = g
        lib_opt = torch.optim.AdamW(lib_params, lr=1e-3, betas=(0.9, b2), weight_decay=0.05,
                                    fused=True)
        masters = [p.detach() for p in lib_params if p.dim() >= 2]
        lib_copies = [p.to(torch.bfloat16) for p in masters]

        def library():
            lib_opt.step()
            torch._foreach_copy_(lib_copies, masters)

        ms, plain_ms, library_ms = time_ms(run), time_ms(plain), time_ms(library)
        n_all = sum(p.numel() for p in params.values())
        n_frozen = sum(params[n].numel() for n in frozen)
        n_copy = sum(p.numel() for n, p in params.items() if p.dim() >= 2 and n not in frozen)
        # Read p, g, mu, nu and write p, mu, nu in fp32 (a frozen tensor's p
        # is neither read nor written), and write the bf16 copies.
        moved = 28 * n_all - 8 * n_frozen + 2 * n_copy
        print(f"adamw {label}: {len(params)} tensors, {n_all / 1e6:.1f} M elements, {launches} "
              f"launches a step; parameters, copies and moments equal the plain version's bit "
              f"for bit over 3 steps; {len(frozen)} frozen kept their bits; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, torch.optim.AdamW(fused=True) + casts {library_ms:.4f} "
              f"ms; {moved / 1e9:.2f} GB is {1e3 * moved / HBM_BYTES_PER_S:.4f} ms at the "
              f"card's memory rate")
        report.setdefault("adamw", entry(
            "adamw.cu", "ssl4polyp_tpu/ops/adamw.py:29", worst, ms, plain_ms,
            bytes_moved=moved, flops=15 * n_all, peak=FP32_FLOPS, library_ms=library_ms))
        del sides, grads, lib_params, lib_opt, masters, lib_copies
    return report


def max_relative_error(out: torch.Tensor, ref: torch.Tensor, frac: float,
                       what: str) -> tuple[float, float]:
    """max |out - ref| against ``frac`` times max |ref|, both finite: the fp32
    kernels' check.  Returns (max |out - ref| / max |ref|, max |out - ref|)."""
    if not torch.isfinite(out).all() or not torch.isfinite(ref).all():
        fail(f"{what}: non-finite values")
    diff = (out - ref).abs().max().item()
    err = diff / max(ref.abs().max().item(), 1e-30)
    if err > frac:
        fail(f"{what}: max |kernel - plain| is {err:.3e} of max |plain|, above {frac}")
    return err, diff


def fp32_kernels(gen: torch.Generator) -> dict[str, dict]:
    """The fp32 kernels of the default route (attention forward and backward,
    fc1+GELU, LayerNorm forward and backward) against their plain fp32
    versions at the classifier's, the MAE decoder's (D) and the MAE encoder's
    (E) shapes and at the token counts' edges, each rerun bit-identical; their
    times beside the plain versions', the one PyTorch call's in fp32 and the
    bound at the fp32 rate.  Errors are relative to max |plain|."""
    dev = "cuda"
    if torch.backends.cuda.matmul.allow_tf32:
        fail("fp32 kernels: cuBLAS is allowed TF32, so the plain fp32 versions would not be fp32")

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    report = {}

    def attention_cost(b, n, h, hd, nv):  # qkv and the bias in, the output out; two products
        # over the nv weighted keys of each row
        return dict(bytes_moved=4 * (b * n * 4 * h * hd + 3 * h * hd),
                    flops=4 * b * h * n * nv * hd, peak=FP32_FLOPS)

    def attention_bwd_cost(b, n, h, hd, nv):  # qkv, dout, bias in; dqkv, dbias out; five products
        return dict(bytes_moved=4 * (b * n * 7 * h * hd + 6 * h * hd),
                    flops=10 * b * h * n * nv * hd, peak=FP32_FLOPS)

    # (batch, tokens, heads, head dim, fp32 scores, valid_len, bias, name):
    # the classifier's call (timed), the MAE decoder's and encoder's (timed),
    # valid_len below N, one token, 256 tokens, a ViT-B/16 at 384 px (timed;
    # past the bf16 kernels' 256 tokens).
    cases = [
        (BATCH, 197, 12, 64, True, None, True, "classifier"),
        (BATCH, 197, 12, 64, True, 150, False, None),
        (BATCH, 197, 16, 32, True, None, True, "MAE decoder"),
        (BATCH, 50, 12, 64, True, None, True, "MAE encoder"),
        (8, 197, 16, 32, False, 100, True, None),
        (4, 1, 12, 64, True, None, True, None),
        (4, 256, 12, 64, True, 255, True, None),
        (4, 256, 16, 32, True, None, False, None),
        (BATCH, 577, 12, 64, True, 500, True, "N 577"),
    ]
    fwd_errors, bwd_errors, fwd_times, bwd_times = [], [], {}, {}
    for b, n, h, hd, f32, valid_len, with_bias, name in cases:
        nv = n if valid_len is None else valid_len
        qkv, dout = randn(b, n, 3 * h * hd), randn(b, n, h * hd)
        bias = randn(3 * h * hd, scale=0.5) if with_bias else None
        run = lambda: qkv_attention._forward_kernel(qkv, h, f32, valid_len, bias)  # noqa: E731
        plain = lambda: qkv_attention.fused_qkv_attention_reference(qkv, h, f32, valid_len, bias)  # noqa: E731
        # The backward as the autograd path runs it: from the forward's output
        # and log-sum-exp.
        saved, lse = qkv_attention._forward_kernel(qkv, h, f32, valid_len, bias, lse=True)
        run_bwd = lambda: qkv_attention._backward_kernel(  # noqa: E731
            qkv, dout, h, f32, valid_len, bias, out=saved, lse=lse)
        plain_bwd = lambda: qkv_attention.fused_qkv_attention_backward_reference(  # noqa: E731
            qkv, dout, h, f32, valid_len, bias)
        out, again = run(), run()
        (dqkv, dbias), bwd_again = run_bwd(), run_bwd()
        # Called from (qkv, dout) alone, the launch runs the forward first.
        alone = qkv_attention._backward_kernel(qkv, dout, h, f32, valid_len, bias)
        torch.cuda.synchronize()
        what = f"fp32 attention B={b} N={n} H={h} hd={hd} valid_len={valid_len} bias={with_bias}"
        fwd_errors.append(max_relative_error(out, plain(), FP32_FWD_FRAC, what))
        ref_dqkv, ref_dbias = plain_bwd()
        bwd_errors.append(max_relative_error(dqkv, ref_dqkv, FP32_GRAD_FRAC, f"{what}: dqkv"))
        line = (f"{what}: out {fwd_errors[-1][0]:.3e}, dqkv {bwd_errors[-1][0]:.3e} of max |plain| "
                f"(limits {FP32_FWD_FRAC}, {FP32_GRAD_FRAC})")
        if with_bias:
            bwd_errors.append(max_relative_error(dbias, ref_dbias, FP32_GRAD_FRAC,
                                                 f"{what}: dbias"))
            line += f", dbias {bwd_errors[-1][0]:.3e}"
        if not torch.equal(out, again) or not torch.equal(out, saved) or any(
                not torch.equal(dqkv, other[0]) or (with_bias and not torch.equal(dbias, other[1]))
                for other in (bwd_again, alone)):
            fail(f"{what}: two runs gave different bits")
        print(line + "; reruns and the backward from (qkv, dout) alone bit-identical")
        del alone
        if name is None:
            continue
        biased = qkv if bias is None else qkv + bias
        q, k, v = heads_of(biased, h)
        # The keys' mask, where valid_len cuts them: SDPA then computes the
        # same function as the kernel.
        mask = None if valid_len is None else torch.arange(n, device=dev) < valid_len
        library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)  # noqa: E731
        leaf = biased.clone().requires_grad_()
        lib_out = F.scaled_dot_product_attention(*heads_of(leaf, h), attn_mask=mask).transpose(
            1, 2).reshape(dout.shape)
        library_bwd = lambda: torch.autograd.grad(lib_out, leaf, dout, retain_graph=True)  # noqa: E731
        fwd_times[name] = time_ms(run), time_ms(plain), time_ms(library)
        bwd_times[name] = time_ms(run_bwd), time_ms(plain_bwd), time_ms(library_bwd)
        print(f"  {name}'s shape: forward kernel {fwd_times[name][0]:.4f} ms, plain "
              f"{fwd_times[name][1]:.4f} ms, fp32 scaled_dot_product_attention "
              f"{fwd_times[name][2]:.4f} ms, {bound_text(**attention_cost(b, n, h, hd, nv))}; "
              f"backward kernel {bwd_times[name][0]:.4f} ms, plain {bwd_times[name][1]:.4f} ms, "
              f"its backward {bwd_times[name][2]:.4f} ms, "
              f"{bound_text(**attention_bwd_cost(b, n, h, hd, nv))}; {CARD}")
        del leaf, lib_out
    report["fused_qkv_attention_f32"] = entry(
        "qkv_attention_f32.cu", "ssl4polyp_tpu/ops/qkv_attention.py:208",
        max(e[1] for e in fwd_errors),
        *fwd_times["classifier"][:2], **attention_cost(BATCH, 197, 12, 64, 197),
        library_ms=fwd_times["classifier"][2])
    report["fused_qkv_attention_backward_f32"] = entry(
        "qkv_attention_f32.cu", "ssl4polyp_tpu/ops/qkv_attention.py:237",
        max(e[1] for e in bwd_errors),
        *bwd_times["classifier"][:2], **attention_bwd_cost(BATCH, 197, 12, 64, 197),
        library_ms=bwd_times["classifier"][2])

    # fc1+GELU: the eval call writes y only, the train steps h too.
    def fc1_cost(m, k, nf, write_h):  # x, w and the bias in; y, and h when asked, out
        return dict(bytes_moved=4 * (m * k + nf * k + nf + (2 if write_h else 1) * m * nf),
                    flops=2 * m * k * nf, peak=FP32_FLOPS)

    errors, times = [], {}
    for name, m, k, nf, write_h in [("classifier", BATCH * 197, 768, 3072, False),
                                    ("classifier (train)", BATCH * 197, 768, 3072, True),
                                    ("MAE decoder", BATCH * 197, 512, 2048, True),
                                    ("MAE encoder", BATCH * 50, 768, 3072, True),
                                    (None, 37, 64, 24, True)]:
        x, w, bias = randn(m, k), randn(nf, k, scale=k ** -0.5), randn(nf, scale=0.5)
        run = lambda: mlp._kernel(x, w, bias, write_h)  # noqa: E731
        plain = lambda: mlp.fc1_gelu_reference(x, w, bias)  # noqa: E731
        (h, y), (h2, y2) = run(), run()
        torch.cuda.synchronize()
        what = f"fp32 fc1_gelu ({m}, {k}) -> {nf}, h written: {write_h}"
        errors.append(max_relative_error(y, plain(), FP32_FWD_FRAC, f"{what}: y"))
        line = f"{what}: y {errors[-1][0]:.3e}"
        if write_h:
            errors.append(max_relative_error(h, torch.matmul(x, w.t()) + bias, FP32_FWD_FRAC,
                                             f"{what}: h"))
            line += f", h {errors[-1][0]:.3e}"
        if not torch.equal(y, y2) or (write_h and not torch.equal(h, h2)):
            fail(f"{what}: two runs gave different bits")
        print(line + f" of max |plain| (limit {FP32_FWD_FRAC}); rerun bit-identical")
        if name is None:
            continue
        library = lambda: F.gelu(F.linear(x, w, bias))  # noqa: E731
        times[name] = time_ms(run), time_ms(plain), time_ms(library)
        print(f"  {name}'s shape: kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, "
              f"fp32 F.linear + F.gelu {times[name][2]:.4f} ms, "
              f"{bound_text(**fc1_cost(m, k, nf, write_h))}")
    report["fc1_gelu_f32"] = entry(
        "fc1_gelu_f32.cu", "ssl4polyp_tpu/ops/mlp.py:111", max(e[1] for e in errors),
        *times["classifier"][:2],
        **fc1_cost(BATCH * 197, 768, 3072, False), library_ms=times["classifier"][2])

    # LayerNorm forward and backward, with and without a residual's gradient.
    def ln_cost(m, d):  # x in and y out in fp32, the affine in
        return dict(bytes_moved=8 * m * d + 8 * d, flops=8 * m * d, peak=FP32_FLOPS)

    def ln_bwd_cost(m, d, dres=False):  # x, dy (and dres) in, dx out; the weight in, dw, db out
        return dict(bytes_moved=(16 if dres else 12) * m * d + 12 * d,
                    flops=(13 if dres else 12) * m * d, peak=FP32_FLOPS)

    fwd_errors, bwd_errors, fwd_times, bwd_times = [], [], {}, {}
    for name, m, d in [("MAE encoder", BATCH * 50, 768), ("MAE decoder", BATCH * 197, 512),
                       ("classifier", BATCH * 197, 768), (None, 5, 1536)]:
        x, dy, dres = randn(m, d), randn(m, d), randn(m, d)
        w, bias = 1.0 + 0.1 * randn(d), 0.1 * randn(d)
        run = lambda: layernorm._forward_kernel(x, w, bias, 1e-6)  # noqa: E731
        plain = lambda: layernorm.layernorm_reference(x, w, bias, 1e-6)  # noqa: E731
        run_bwd = lambda: layernorm._backward_kernel(x, dy, w, 1e-6)  # noqa: E731
        run_dres = lambda: layernorm._backward_kernel(x, dy, w, 1e-6, dres)  # noqa: E731
        y, y2 = run(), run()
        grads, grads2 = run_bwd(), run_bwd()
        with_dres, with_dres2 = run_dres(), run_dres()
        torch.cuda.synchronize()
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        ref = layernorm.layernorm_reference(*leaves, 1e-6)
        plain_bwd = lambda: torch.autograd.grad(ref, leaves, dy, retain_graph=True)  # noqa: E731
        ref_grads = plain_bwd()
        ref_dres = ln_linear.layernorm_backward(x, w, dy, 1e-6, True, dres)
        what = f"fp32 layernorm ({m}, {d})"
        fwd_errors.append(max_relative_error(y, plain(), FP32_FWD_FRAC, f"{what}: y"))
        for label, got, want in (("", grads, ref_grads), (" with dres", with_dres, ref_dres)):
            for part, a, r in zip(("dx", "dweight", "dbias"), got, want):
                bwd_errors.append(max_relative_error(a, r, FP32_GRAD_FRAC,
                                                     f"{what}: {part}{label}"))
        worst = max(e[0] for e in bwd_errors[-6:])
        if not torch.equal(y, y2) or not all(torch.equal(a, b) for a, b in zip(
                (*grads, *with_dres), (*grads2, *with_dres2))):
            fail(f"{what}: two runs gave different bits")
        print(f"{what}: y {fwd_errors[-1][0]:.3e}, worst of dx, dweight, dbias with and "
              f"without dres {worst:.3e} of max |plain| (limits {FP32_FWD_FRAC}, "
              f"{FP32_GRAD_FRAC}); reruns bit-identical")
        if name is None:
            continue
        lib_leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        library = lambda: F.layer_norm(lib_leaves[0], (d,), lib_leaves[1], lib_leaves[2], 1e-6)  # noqa: E731
        lib_y = library()
        library_bwd = lambda: torch.autograd.grad(lib_y, lib_leaves, dy, retain_graph=True)  # noqa: E731
        plain_dres = lambda: ln_linear.layernorm_backward(x, w, dy, 1e-6, True, dres)  # noqa: E731
        fwd_times[name] = time_ms(run), time_ms(plain), time_ms(library)
        bwd_times[name] = time_ms(run_bwd), time_ms(plain_bwd), time_ms(library_bwd)
        print(f"  {name}'s shape: forward kernel {fwd_times[name][0]:.4f} ms, plain "
              f"{fwd_times[name][1]:.4f} ms, F.layer_norm {fwd_times[name][2]:.4f} ms, "
              f"{bound_text(**ln_cost(m, d))}; backward kernel {bwd_times[name][0]:.4f} ms, "
              f"plain {bwd_times[name][1]:.4f} ms, F.layer_norm's {bwd_times[name][2]:.4f} ms, "
              f"{bound_text(**ln_bwd_cost(m, d))}; with dres {time_ms(run_dres):.4f} ms, plain "
              f"{time_ms(plain_dres):.4f} ms, {bound_text(**ln_bwd_cost(m, d, True))}; "
              f"{_build.library().ssl4polyp_layernorm_bwd_blocks_f32(m, d)} blocks")
    m, d = BATCH * 197, 768
    report["layernorm_f32"] = entry(
        "layernorm.cu", "ssl4polyp_tpu/ops/layernorm.py:50", max(e[1] for e in fwd_errors),
        *fwd_times["classifier"][:2], **ln_cost(m, d), library_ms=fwd_times["classifier"][2])
    report["layernorm_backward_f32"] = entry(
        "layernorm.cu", "ssl4polyp_tpu/ops/layernorm.py:226", max(e[1] for e in bwd_errors),
        *bwd_times["classifier"][:2], **ln_bwd_cost(m, d), library_ms=bwd_times["classifier"][2])
    report.update(fp32_fusion_kernels(randn))
    report.update(fp32_projection_kernels(randn))
    return report


def fp32_fusion_kernels(randn) -> dict[str, dict]:
    """The fusion knobs' fp32 kernels: the fused MLP and the fused LN+MLP (h
    written, as under a backward, and not, as in an eval forward) and LN+QKV,
    against their plain fp32 versions at the classifier's and the MAE
    decoder's widths over 12,608 rows and at ragged edges, each rerun
    bit-identical; their times beside the plain versions', their unfused
    fp32 chains of PyTorch calls (no one call computes either function) and
    the bound at the fp32 rate.  Errors are relative to max |plain|."""
    eps = 1e-6
    report = {}

    def fused_cost(m, k, nf, write_h, with_ln):  # x, W1, b1, W2, b2 (s, t) in; out (h) out
        return dict(bytes_moved=4 * (2 * m * k + 2 * nf * k + nf + k + (2 * k if with_ln else 0)
                                     + (m * nf if write_h else 0)),
                    flops=4 * m * k * nf, peak=FP32_FLOPS)

    for name, with_ln, line in (("mlp_fused_f32", False, 243), ("mlp_ln_fused_f32", True, 375)):
        errors, times = [], {}
        for shape, m, k, nf, write_h in [("classifier", BATCH * 197, 768, 3072, True),
                                         ("classifier, no h", BATCH * 197, 768, 3072, False),
                                         ("MAE decoder", BATCH * 197, 512, 2048, True),
                                         (None, 37, 768, 160, True), (None, 37, 512, 96, False)]:
            x = randn(m, k)
            s, t = (1.0 + 0.1 * randn(k), 0.1 * randn(k)) if with_ln else (None, None)
            w1, b1 = randn(nf, k, scale=k ** -0.5), randn(nf, scale=0.5)
            w2, b2 = randn(k, nf, scale=nf ** -0.5), randn(k, scale=0.5)
            run = lambda: mlp._fused_kernel(x, s, t, w1, b1, w2, b2, eps, write_h)  # noqa: E731
            plain = lambda: mlp._mlp_forward_plain(x, s, t, w1, b1, w2, b2, eps)  # noqa: E731

            def chain():
                a = x if s is None else F.layer_norm(x, (k,), s, t, eps)
                out = F.linear(F.gelu(F.linear(a, w1, b1)), w2, b2)
                return out if s is None else x + out

            (h, out), (h2, out2) = run(), run()
            torch.cuda.synchronize()
            what = f"fp32 {name[:-4]} ({m}, {k}) -> {nf} -> {k}, h written: {write_h}"
            ref_h, ref_out = plain()
            errors.append(max_relative_error(out, ref_out, FP32_FWD_FRAC, f"{what}: out"))
            text = f"{what}: out {errors[-1][0]:.3e}"
            if write_h:
                errors.append(max_relative_error(h, ref_h, FP32_FWD_FRAC, f"{what}: h"))
                text += f", h {errors[-1][0]:.3e}"
            if not torch.equal(out, out2) or (write_h and not torch.equal(h, h2)):
                fail(f"{what}: two runs gave different bits")
            print(text + f" of max |plain| (limit {FP32_FWD_FRAC}); rerun bit-identical")
            if shape is None:
                continue
            times[shape] = time_ms(run), time_ms(plain), time_ms(chain)
            print(f"  {shape}'s shape: kernel {times[shape][0]:.4f} ms, plain "
                  f"{times[shape][1]:.4f} ms, fp32 chain ({'F.layer_norm + ' if with_ln else ''}"
                  f"F.linear + F.gelu + F.linear{' + x' if with_ln else ''}) "
                  f"{times[shape][2]:.4f} ms, "
                  f"{bound_text(**fused_cost(m, k, nf, write_h, with_ln))}; {CARD}")
        report[name] = entry(
            "mlp_fused_f32.cu", f"ssl4polyp_tpu/ops/mlp.py:{line}", max(e[1] for e in errors),
            *times["classifier"][:2], **fused_cost(BATCH * 197, 768, 3072, True, with_ln))

    def ln_linear_cost(m, k, n):  # x, s, t, W, b in; out out
        return dict(bytes_moved=4 * (m * k + 2 * k + n * k + n + m * n), flops=2 * m * k * n,
                    peak=FP32_FLOPS)

    errors, times = [], {}
    for shape, m, k, n in [("classifier", BATCH * 197, 768, 2304),
                           ("MAE decoder", BATCH * 197, 512, 1536), (None, 37, 64, 24),
                           (None, 130, 576, 136)]:
        x = 2.0 * randn(m, k) + 0.5
        s, t = 1.0 + 0.1 * randn(k), 0.1 * randn(k)
        w, b = randn(n, k, scale=k ** -0.5), randn(n, scale=0.5)
        run = lambda: ln_linear._kernel(x, s, t, w, b, eps)  # noqa: E731
        plain = lambda: ln_linear.ln_linear_reference(x, s, t, w, b, eps)  # noqa: E731
        chain = lambda: F.linear(F.layer_norm(x, (k,), s, t, eps), w, b)  # noqa: E731
        out, out2 = run(), run()
        torch.cuda.synchronize()
        what = f"fp32 ln_linear ({m}, {k}) -> {n}"
        errors.append(max_relative_error(out, plain(), FP32_FWD_FRAC, what))
        if not torch.equal(out, out2):
            fail(f"{what}: two runs gave different bits")
        print(f"{what}: {errors[-1][0]:.3e} of max |plain| (limit {FP32_FWD_FRAC}); rerun "
              f"bit-identical")
        if shape is None:
            continue
        times[shape] = time_ms(run), time_ms(plain), time_ms(chain)
        print(f"  {shape}'s shape: kernel {times[shape][0]:.4f} ms, plain {times[shape][1]:.4f} "
              f"ms, fp32 chain (F.layer_norm + F.linear) {times[shape][2]:.4f} ms, "
              f"{bound_text(**ln_linear_cost(m, k, n))}; {CARD}")
    report["ln_linear_f32"] = entry(
        "ln_linear_f32.cu", "ssl4polyp_tpu/ops/ln_linear.py:63", max(e[1] for e in errors),
        *times["classifier"][:2], **ln_linear_cost(BATCH * 197, 768, 2304))
    return report


def fp32_fold_cost(b, n, h, hd, nv):
    """The fp32 attention+projection kernels' bytes and operations, forward
    and backward, over the nv weighted keys of each row: qkv, W, b in and y
    out; qkv, W, dy and the forward's saved core output and log-sum-exp in,
    dqkv, dW and db out."""
    d = h * hd
    core, proj = b * h * n * nv * hd, b * n * d * d
    return (dict(bytes_moved=4 * (4 * b * n * d + d * d + d), flops=4 * core + 2 * proj,
                 peak=FP32_FLOPS),
            dict(bytes_moved=4 * (8 * b * n * d + b * h * n + 2 * d * d + d),
                 flops=10 * core + 4 * proj, peak=FP32_FLOPS))


def fp32_block_cost(b, n, d_in, h, hd, nv):
    """The fp32 projection + attention kernels' bytes and operations,
    forward and backward: x, W, b in and the output out; x, W, b, dout and
    the forward's saved output and log-sum-exp in, dx, dW and db out.  The
    backward's three products include the projection it recomputes."""
    d = h * hd
    core, proj = b * h * n * nv * hd, b * n * d_in * 3 * d
    return (dict(bytes_moved=4 * (b * n * (d_in + d) + d_in * 3 * d + 3 * d),
                 flops=2 * proj + 4 * core, peak=FP32_FLOPS),
            dict(bytes_moved=4 * (2 * b * n * (d_in + d) + b * h * n + 2 * (d_in * 3 * d + 3 * d)),
                 flops=6 * proj + 10 * core, peak=FP32_FLOPS))


def fp32_projection_kernels(randn) -> dict[str, dict]:
    """The attention+projection fold (rows 9, 9b) and the QKV projection with
    the attention core (rows 10, 10b) in fp32, against their plain fp32
    versions: the fold at the classifier's and the MAE decoder's shapes, the
    projection + attention at the classifier's, each also with ``valid_len``
    below N (the pad rows' upstream gradient zero), at 1 and 300 tokens and
    at hd 32 with an odd head count.  Each forward and backward rerun
    bit-identical, the backward from the forward's saved output and
    log-sum-exp bit-equal to its launch from the inputs alone.  Their times
    beside the plain versions', fp32 SDPA + ``F.linear`` and that pair's
    autograd backward (TF32 off), and the bound at the fp32 rate.  Errors are
    relative to max |plain|."""

    def fold_library(x, w, bias, h):  # w (out, in)
        core = F.scaled_dot_product_attention(*heads_of(x, h))
        return F.linear(core.transpose(1, 2).flatten(2), w, bias)

    def block_library(x, w_t, bias, h):  # w_t (3D, Din): torch's layout of w
        core = F.scaled_dot_product_attention(*heads_of(F.linear(x, w_t, bias), h))
        return core.transpose(1, 2).flatten(2)

    # Cases: (batch, tokens, Din, heads, head dim, valid_len, timed as).
    kernels = [
        (attn_proj, ("attn_proj_f32", "attn_proj_backward_f32"), "attn_proj_f32.cu",
         ("ssl4polyp_tpu/ops/attn_proj.py:212", "ssl4polyp_tpu/ops/attn_proj.py:250"),
         [(BATCH, 197, None, 12, 64, None, "classifier"),
          (BATCH, 197, None, 16, 32, None, "MAE decoder"), (BATCH, 197, None, 12, 64, 150, None),
          (4, 1, None, 12, 64, None, None), (4, 300, None, 8, 32, 280, None),
          (8, 61, None, 5, 32, None, None)],
         (attn_proj.fused_attention_proj_reference,
          attn_proj.fused_attention_proj_backward_reference), ("dqkv", "dw", "db"),
         fold_library, "SDPA + F.linear"),
        (attention_block, ("fused_qkvproj_attention_f32", "fused_qkvproj_attention_backward_f32"),
         "attention_block_f32.cu",
         ("ssl4polyp_tpu/ops/attention_block.py:187", "ssl4polyp_tpu/ops/attention_block.py:224"),
         [(BATCH, 197, 768, 12, 64, None, "classifier"), (BATCH, 197, 768, 12, 64, 150, None),
          (4, 1, 768, 12, 64, None, None), (4, 300, 512, 16, 32, 280, None),
          (8, 61, 192, 5, 32, None, None)],
         (attention_block.fused_qkvproj_attention_reference,
          attention_block.fused_qkvproj_attention_backward_reference), ("dx", "dw", "db"),
         block_library, "F.linear + SDPA"),
    ]
    report = {}
    for module, names, source, replaces, cases, (reference, backward_reference), parts, \
            library_fn, pair in kernels:
        fold = module is attn_proj
        fwd_errors, bwd_errors, times = [], [], {}
        for b, n, d_in, h, hd, valid_len, name in cases:
            d, nv = h * hd, n if valid_len is None else valid_len
            if fold:
                x, w, bias = randn(b, n, 3 * d), randn(d, d, scale=d ** -0.5), randn(d, scale=0.5)
                costs = fp32_fold_cost(b, n, h, hd, nv)
            else:
                x, w = randn(b, n, d_in), randn(d_in, 3 * d, scale=d_in ** -0.5)
                bias, costs = randn(3 * d, scale=0.5), fp32_block_cost(b, n, d_in, h, hd, nv)
            dy = randn(b, n, d)
            dy[:, nv:] = 0
            args = (x, w, bias, h, True, valid_len)
            what = (f"fp32 {names[0][:-len('_f32')]} B={b} N={n}" + (f" Din={d_in}" if d_in else "")
                    + f" H={h} hd={hd} valid_len={valid_len}")
            run = lambda: module._forward_kernel(*args)  # noqa: E731
            plain = lambda: reference(*args)  # noqa: E731
            plain_bwd = lambda: backward_reference(x, w, bias, dy, h, True, valid_len)  # noqa: E731
            # The backward as the autograd path runs it: from the forward's
            # saved output (the fold's core output) and log-sum-exp.
            kept = module._forward_kernel(*args, keep=True)
            y, saved = kept[0], kept[-2:]
            run_bwd = lambda: module._backward_kernel(  # noqa: E731
                x, w, bias, dy, h, True, valid_len, out=saved[0], lse=saved[1])
            again, grads, grads_again = run(), run_bwd(), run_bwd()
            alone = module._backward_kernel(x, w, bias, dy, h, True, valid_len)
            torch.cuda.synchronize()
            fwd_errors.append(max_relative_error(y, plain(), FP32_FWD_FRAC, f"{what}: y"))
            line = f"{what}: y {fwd_errors[-1][0]:.3e}"
            for part, got, want in zip(parts, grads, plain_bwd()):
                bwd_errors.append(max_relative_error(got, want, FP32_GRAD_FRAC,
                                                     f"{what}: {part}"))
                line += f", {part} {bwd_errors[-1][0]:.3e}"
            if not torch.equal(y, again) or not all(
                    torch.equal(a, g) for other in (grads_again, alone)
                    for a, g in zip(other, grads)):
                fail(f"{what}: two runs gave different bits")
            print(line + f" of max |plain| (limits {FP32_FWD_FRAC}, {FP32_GRAD_FRAC}); reruns and "
                         f"the backward from the inputs alone bit-identical")
            del alone, grads_again, kept
            if name is None:
                continue
            leaves = [t.clone().requires_grad_() for t in (x, w if fold else w.t().contiguous(),
                                                           bias)]
            library = lambda: library_fn(*leaves, h)  # noqa: E731
            lib_y = library()
            library_bwd = lambda: torch.autograd.grad(lib_y, leaves, dy, retain_graph=True)  # noqa: E731
            with torch.no_grad():
                fwd = time_ms(run), time_ms(plain), time_ms(library)
            times[name] = fwd, (time_ms(run_bwd), time_ms(plain_bwd), time_ms(library_bwd))
            print(f"  {name}'s shape: forward kernel {fwd[0]:.4f} ms, plain {fwd[1]:.4f} ms, fp32 "
                  f"{pair} {fwd[2]:.4f} ms, {bound_text(**costs[0])}; backward kernels "
                  f"{times[name][1][0]:.4f} ms, plain {times[name][1][1]:.4f} ms, the pair's "
                  f"backward {times[name][1][2]:.4f} ms, {bound_text(**costs[1])}; {CARD}")
            del leaves, lib_y
        costs = (fp32_fold_cost(BATCH, 197, 12, 64, 197) if fold
                 else fp32_block_cost(BATCH, 197, 768, 12, 64, 197))
        for k, errors in enumerate((fwd_errors, bwd_errors)):
            ms, plain_ms, library_ms = times["classifier"][k]
            report[names[k]] = entry(source, replaces[k], max(e[1] for e in errors), ms, plain_ms,
                                     **costs[k], library_ms=library_ms)
    return report


def _linear(rng, d_in, d_out, stack=None):
    lead = () if stack is None else (stack,)
    limit = np.sqrt(6.0 / (d_in + d_out))
    return {"kernel": rng.uniform(-limit, limit, lead + (d_in, d_out)).astype(np.float32),
            "bias": (0.02 * rng.standard_normal(lead + (d_out,))).astype(np.float32)}


def _norm(rng, dim, stack=None):
    shape = (dim,) if stack is None else (stack, dim)
    return {"scale": (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32),
            "bias": (0.02 * rng.standard_normal(shape)).astype(np.float32)}


def _blocks(rng, depth, dim, hidden):
    return {
        "ln1": _norm(rng, dim, depth),
        "attn": {"qkv": _linear(rng, dim, 3 * dim, depth), "proj": _linear(rng, dim, dim, depth)},
        "ln2": _norm(rng, dim, depth),
        "mlp": {"fc1": _linear(rng, dim, hidden, depth), "fc2": _linear(rng, hidden, dim, depth)},
    }


def jax_layout_tree(cfg: ViTConfig, rng: np.random.Generator) -> dict:
    """Random ViT classifier weights in the JAX package's pytree layout, as numpy."""
    D = cfg.embed_dim
    return {
        "patch_embed": _linear(rng, cfg.patch_dim, D),
        "cls_token": (0.02 * rng.standard_normal((1, 1, D))).astype(np.float32),
        "pos_embed": (0.02 * rng.standard_normal((1, cfg.num_patches + 1, D))).astype(np.float32),
        "blocks": _blocks(rng, cfg.depth, D, int(D * cfg.mlp_ratio)),
        "norm": _norm(rng, D),
        "head": _linear(rng, D, cfg.num_classes),
    }


def jax_layout_mae_tree(cfg: MAEConfig, rng: np.random.Generator) -> dict:
    """Random MAE weights, encoder and decoder, in the JAX package's layout,
    with the fixed sin-cos position tables, as numpy."""
    enc = cfg.encoder
    D, Dd = enc.embed_dim, cfg.decoder_embed_dim
    return {
        "patch_embed": _linear(rng, enc.patch_dim, D),
        "cls_token": (0.02 * rng.standard_normal((1, 1, D))).astype(np.float32),
        "pos_embed": sincos_2d(D, enc.grid_size, cls_token=True)[None],
        "blocks": _blocks(rng, enc.depth, D, int(D * enc.mlp_ratio)),
        "norm": _norm(rng, D),
        "decoder": {
            "embed": _linear(rng, D, Dd),
            "mask_token": (0.02 * rng.standard_normal((1, 1, Dd))).astype(np.float32),
            "pos_embed": sincos_2d(Dd, enc.grid_size, cls_token=True)[None],
            "blocks": _blocks(rng, cfg.decoder_depth, Dd, int(Dd * enc.mlp_ratio)),
            "norm": _norm(rng, Dd),
            "pred": _linear(rng, Dd, enc.patch_dim),
        },
    }


def write_mae_pth(path: Path, cfg: MAEConfig, rng: np.random.Generator) -> dict:
    """An MAE checkpoint in the upstream layout: ``torch.save`` of
    ``{"model": <encoder and decoder under timm's MAE names>, "args":
    argparse.Namespace(...), "epoch": ...}``, the weights a numpy-seeded
    JAX-layout tree (:func:`jax_layout_mae_tree`), which is returned."""
    tree = jax_layout_mae_tree(cfg, rng)
    args = argparse.Namespace(model="mae_vit_base_patch16", mask_ratio=0.75, norm_pix_loss=True,
                              epochs=800, batch_size=64, blr=1.5e-4, weight_decay=0.05)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": mae_state_dict_from_jax(tree, cfg), "args": args, "epoch": 799}, path)
    return tree


def write_augreg_npz(path: Path, cfg: ViTConfig, rng: np.random.Generator,
                     head_classes: int = 1000) -> dict:
    """A big_vision AugReg export: the encoder of a numpy-seeded JAX-layout
    tree (:func:`jax_layout_tree`, returned without its head) under
    big_vision's keys (q, k, v kernels (D, heads, hd), the output kernel
    (heads, hd, D), the patch kernel (P, P, C, D)), with a
    ``head_classes``-way head as the ImageNet-1k file has."""
    D, heads = cfg.embed_dim, cfg.num_heads
    hd = D // heads
    tree = jax_layout_tree(cfg, rng)
    head = _linear(rng, D, head_classes)
    tree.pop("head")
    p = cfg.patch_size
    arrays = {
        "embedding/kernel": tree["patch_embed"]["kernel"].reshape(p, p, cfg.in_chans, D),
        "embedding/bias": tree["patch_embed"]["bias"],
        "cls": tree["cls_token"],
        "Transformer/posembed_input/pos_embedding": tree["pos_embed"],
        "Transformer/encoder_norm/scale": tree["norm"]["scale"],
        "Transformer/encoder_norm/bias": tree["norm"]["bias"],
        "head/kernel": head["kernel"],
        "head/bias": head["bias"],
    }
    blocks = tree["blocks"]
    for i in range(cfg.depth):
        base = f"Transformer/encoderblock_{i}"
        attn = f"{base}/MultiHeadDotProductAttention_1"
        qkv = blocks["attn"]["qkv"]
        for j, name in enumerate(("query", "key", "value")):
            arrays[f"{attn}/{name}/kernel"] = qkv["kernel"][i][:, j * D:(j + 1) * D].reshape(
                D, heads, hd)
            arrays[f"{attn}/{name}/bias"] = qkv["bias"][i][j * D:(j + 1) * D].reshape(heads, hd)
        arrays[f"{attn}/out/kernel"] = blocks["attn"]["proj"]["kernel"][i].reshape(heads, hd, D)
        arrays[f"{attn}/out/bias"] = blocks["attn"]["proj"]["bias"][i]
        for norm, key in (("LayerNorm_0", "ln1"), ("LayerNorm_2", "ln2")):
            arrays[f"{base}/{norm}/scale"] = blocks[key]["scale"][i]
            arrays[f"{base}/{norm}/bias"] = blocks[key]["bias"][i]
        for dense, key in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
            arrays[f"{base}/MlpBlock_3/{dense}/kernel"] = blocks["mlp"][key]["kernel"][i]
            arrays[f"{base}/MlpBlock_3/{dense}/bias"] = blocks["mlp"][key]["bias"][i]
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)
    return tree


def check_counts(counts: dict[str, int], per_call: dict[str, int], calls: int, what: str) -> None:
    """Exactly ``calls`` times ``per_call`` launches of each kernel named
    there, and none of the others."""
    expected = {name: calls * per_call.get(name, 0) for name in ops.launch_counts()}
    print(f"kernel launches over {what}: {counts}")
    if counts != expected:
        fail(f"{what}: launch counts {counts}, expected {expected}")


def phase_eval(gen: torch.Generator) -> dict[str, int]:
    rng = np.random.default_rng(SEED)
    cfg = ViTConfig(pos_embed="learned", num_classes=2)  # ViT-B/16 at 224 px
    tree = jax_layout_tree(cfg, rng)
    requests = [rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
                for _ in range(REQUESTS)]
    total: dict[str, int] = {}
    unfolded = None
    for fold in (False, True):
        what = "eval forward under BENCH_ATTN_PROJ=1" if fold else "eval forward"
        with projection_fold(fold):
            classifier = get_imagenet_or_random_vit(gen, jax_params=tree, num_classes=2,
                                                    device="cuda")
        if any(block.attn.proj_fold != fold for block in classifier.model.blocks):
            fail(f"{what}: the blocks' projection fold is not {fold}")
        forward = make_forward_fn(classifier, "cuda")()
        if any(p.dtype != torch.float32 for p in classifier.model.parameters()):
            fail(f"{what}: make_forward_fn cast the classifier's own parameters")

        forward(requests[0])  # warm-up
        ops.reset_launch_counts()
        logits = [forward(images) for images in requests]
        counts = ops.launch_counts()
        per_request = {"attn_proj" if fold else "fused_qkv_attention": cfg.depth,
                       "layernorm": 2 * cfg.depth + 1, "fc1_gelu": cfg.depth}
        check_counts(counts, per_request, REQUESTS, f"{REQUESTS} requests of the {what}")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

        rate = rates(lambda: forward(requests[0]), BATCH, REPEATS, REPEAT_CALLS)
        ops.reset_launch_counts()
        with plain_kernels():
            plain_logits = [forward(images) for images in requests]
            plain_rate = rates(lambda: forward(requests[0]), BATCH, PLAIN_REPEATS, REPEAT_CALLS)
        if any(ops.launch_counts().values()):
            fail(f"{what}: the plain forward launched a kernel")
        errors = []
        for got, ref in zip(logits, plain_logits):
            if got.shape != (BATCH, 2) or got.dtype != np.float32:
                fail(f"logits {got.shape} {got.dtype}, expected ({BATCH}, 2) float32")
            errors.append(max_error(torch.from_numpy(got), torch.from_numpy(ref), LOGITS_TOL,
                                    f"{what}: logits"))
        print(f"{what}: logits vs plain forward: max |diff| {max(errors):.3e} "
              f"(atol {LOGITS_TOL[0]}, rtol {LOGITS_TOL[1]}); logit range "
              f"[{min(l.min() for l in logits):.3f}, {max(l.max() for l in logits):.3f}]")
        if fold:  # the same function as the unfolded forward, other kernels
            err = max(max_error(torch.from_numpy(got), torch.from_numpy(ref), LOGITS_TOL,
                                f"{what}: logits against the unfolded forward's")
                      for got, ref in zip(logits, unfolded))
            print(f"{what}: logits vs the unfolded forward's: max |diff| {err:.3e}")
        unfolded = logits
        print(f"{what} ViT-B/16, batch {BATCH}, images/s over {REPEATS} (plain {PLAIN_REPEATS}) "
              f"repeats of {REPEAT_CALLS} requests: kernels {spread(rate)}; plain "
              f"{spread(plain_rate)}")
        del classifier, forward
    return total


def check_step_one(loss, grads, plain_loss, plain_grads, loss_rtol: float, grad_rtol: float,
                   what: str) -> None:
    """Step 1's loss (relative) and each gradient (relative L2 distance)
    against the plain step's.  The K slice of each qkv bias is left out: its
    exact gradient is zero (softmax is invariant to a shift of the scores
    along k), so both sides hold rounding noise there."""
    loss_err = abs(loss.item() - plain_loss.item()) / abs(plain_loss.item())
    print(f"{what} step 1 loss: kernels {loss.item():.6f}, plain {plain_loss.item():.6f} "
          f"(relative diff {loss_err:.3e}, limit {loss_rtol})")
    if not (np.isfinite(loss.item()) and loss_err <= loss_rtol):
        fail(f"{what}: step 1 loss disagrees with the plain step")
    worst = (0.0, "")
    for name, g in grads.items():
        ref = plain_grads[name]
        if name.endswith("attn.qkv.bias"):
            d = g.shape[0] // 3
            g, ref = torch.cat([g[:d], g[2 * d:]]), torch.cat([ref[:d], ref[2 * d:]])
        if not torch.isfinite(g).all():
            fail(f"{what}: gradient of {name} is not finite")
        rel = ((g - ref).norm() / ref.norm().clamp_min(1e-30)).item()
        worst = max(worst, (rel, name))
        if rel > grad_rtol:
            fail(f"{what}: gradient of {name}: relative L2 distance {rel:.3e} to the plain "
                 f"step's exceeds {grad_rtol}")
    print(f"{what} step 1 gradients of {len(grads)} parameters: worst relative L2 distance "
          f"{worst[0]:.3e} ({worst[1]}), limit {grad_rtol}")


def mae_train_flops_per_image(cfg: MAEConfig) -> float:
    """Matmul FLOPs of one image's MAE train step, forward and backward (the
    count of ``bench.py::_mae_train_flops_per_image``, without padding):
    24 N D^2 + 4 N^2 D per block forward, the embeddings and the pixel head,
    and twice the forward for the backward."""
    enc = cfg.encoder
    n_enc, n_dec = 1 + cfg.len_keep, 1 + enc.num_patches
    d_enc, d_dec = enc.embed_dim, cfg.decoder_embed_dim
    fwd = enc.depth * (24.0 * n_enc * d_enc ** 2 + 4.0 * n_enc ** 2 * d_enc)
    fwd += cfg.decoder_depth * (24.0 * n_dec * d_dec ** 2 + 4.0 * n_dec ** 2 * d_dec)
    fwd += 2.0 * enc.num_patches * enc.patch_dim * d_enc
    fwd += 2.0 * n_enc * d_enc * d_dec
    fwd += 2.0 * n_dec * d_dec * enc.patch_dim
    return 3.0 * fwd


def differing(a: dict[str, torch.Tensor], b: dict[str, torch.Tensor]) -> list[str]:
    """The names whose tensors differ in a bit (NaN payloads included)."""
    def bits(t):
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
        return t.contiguous().view(ints[t.element_size()])
    return [name for name in a if not torch.equal(bits(a[name]), bits(b[name]))]


def check_run_to_run_bits(fresh_state, run_step, compute_dtype: torch.dtype, steps: int = 3,
                          what: str = "pretrain") -> None:
    """``steps`` train steps (``run_step(state, i)`` runs step i) twice from
    one seed and one state, after ``set_determinism``: every master, both
    moments and the compute copy must agree bit for bit, and the compute copy
    the AdamW kernel left must be the plain cast of the masters to
    ``compute_dtype`` (what a resume writes)."""
    states = []
    for _ in range(2):
        set_determinism(SEED)
        with projection_fold(False):
            state = fresh_state()
        for i in range(steps):
            run_step(state, i)
        states.append(state)
    torch.cuda.synchronize()
    a, b = states
    diffs = {what: differing(x, y) for what, x, y in (
        ("masters", a.params, b.params), ("mu", a.opt.mu, b.opt.mu), ("nu", a.opt.nu, b.opt.nu),
        ("compute copy", a.params_c, b.params_c))}
    recast = layers.compute_copy(a.params, compute_dtype)
    diffs["compute copy against the cast of the masters"] = differing(a.params_c, recast)
    if any(diffs.values()):
        # Name the ops that have no deterministic CUDA implementation: one
        # step more under torch's deterministic mode.
        ops_named = nondeterministic_ops(run_step, a, 0)
        fail(f"{what}: {steps} steps twice from one state differ in "
             f"{ {k: v[:5] for k, v in diffs.items() if v} }; torch's deterministic mode "
             f"names {ops_named}")
    print(f"{what}: {steps} steps run twice from one seed and one state agree bit for bit in "
          f"all {len(a.params)} masters, both moments and the compute copy; the compute copy "
          "equals the cast of the masters")


def nondeterministic_ops(fn, *args) -> list[str]:
    """The ops of ``fn(*args)`` that have no deterministic CUDA
    implementation, as torch's deterministic mode names them (warnings
    only)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn(*args)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split("\n")[0] for w in caught
                   if "deterministic" in str(w.message)})


def phase_pretrain() -> dict[str, int]:
    settings = PretrainSettings(batch_size=BATCH)
    cfg = model_config(settings)  # MAE ViT-B/16, bf16, bf16 scores
    rng = np.random.default_rng(SEED)
    tree = jax_layout_mae_tree(cfg, rng)
    batches = [torch.from_numpy(rng.integers(0, 256, (1, BATCH, 224, 224, 3), dtype=np.uint8)).cuda()
               for _ in range(STEPS)]
    noise_gen = torch.Generator(device="cuda").manual_seed(SEED)
    noise = [torch.rand((1, BATCH, cfg.encoder.num_patches), generator=noise_gen, device="cuda")
             for _ in range(STEPS)]
    schedule = warmup_cosine(settings.absolute_lr, STEPS, 2)
    train_step = make_pretrain_step(cfg, 1, settings.weight_decay)

    def fresh_state():
        model = MAE(cfg, torch.Generator().manual_seed(SEED))
        model.load_state_dict(mae_state_dict_from_jax(tree, cfg))
        return init_pretrain_state(model.cuda())

    # Step 1's loss and gradients, kernels against plain, from one state.
    with projection_fold(False):
        state = fresh_state()
    loss, grads = pretrain_loss_and_grads(state, batches[0], noise[0])
    with plain_kernels():
        plain_loss, plain_grads = pretrain_loss_and_grads(state, batches[0], noise[0])
    check_step_one(loss, grads, plain_loss, plain_grads, LOSS_RTOL, GRAD_RTOL, "pretrain")
    del grads, plain_grads
    check_run_to_run_bits(fresh_state,
                          lambda state, i: train_step(state, batches[i], noise[i], schedule(i)),
                          cfg.encoder.compute_dtype)

    def train(state) -> list[float]:
        losses = [train_step(state, batches[i], noise[i], schedule(i))["loss"]
                  for i in range(STEPS)]
        return [x.item() for x in losses]

    def rate(state, repeats: int = REPEATS) -> list[float]:  # after train(state)
        calls = iter(range(repeats * REPEAT_CALLS))

        def run():
            i = next(calls) % STEPS
            train_step(state, batches[i], noise[i], schedule(i))
        return rates(run, BATCH, repeats, REPEAT_CALLS)

    frozen = {n: state.params[n].clone() for n in ("pos_embed", "decoder_pos_embed")}
    ops.reset_launch_counts()
    losses = train(state)
    counts = ops.launch_counts()
    enc_depth, dec_depth = cfg.encoder.depth, cfg.decoder_depth
    per_step = {
        "fused_qkv_attention": enc_depth + dec_depth,
        "fused_qkv_attention_backward": enc_depth + dec_depth,
        "layernorm": 2 * (enc_depth + dec_depth) + 2,
        "layernorm_backward": 2 * (enc_depth + dec_depth) + 2,
        "fc1_gelu": enc_depth + dec_depth,
        "adamw": -(-len(state.params) // adamw.TENSORS_PER_LAUNCH),
    }
    check_counts(counts, per_step, STEPS, f"{STEPS} pretrain steps")
    if not all(np.isfinite(losses)):
        fail(f"non-finite pretrain loss: {losses}")
    if not all(torch.isfinite(p).all() for p in state.params.values()):
        fail("non-finite parameters after the pretrain steps")
    for name, table in frozen.items():
        if not torch.equal(table, state.params[name]):
            fail(f"{name} moved: it is frozen (learning rate 0)")
    print(f"pretrain losses, kernels: {[round(x, 6) for x in losses]}; sin-cos tables unchanged")

    kernel_rate = rate(state)
    del state
    with projection_fold(False):
        plain_state = fresh_state()
    ops.reset_launch_counts()
    with plain_kernels():
        plain_losses = train(plain_state)
        plain_rate = rate(plain_state, PLAIN_REPEATS)
    if any(ops.launch_counts().values()):
        fail("the plain pretrain step launched a kernel")
    print(f"pretrain losses, plain:   {[round(x, 6) for x in plain_losses]}")
    flops = mae_train_flops_per_image(cfg)
    print(f"pretrain step MAE ViT-B/16, batch {BATCH}, images/s over {REPEATS} (plain "
          f"{PLAIN_REPEATS}) repeats of {REPEAT_CALLS} steps: kernels {spread(kernel_rate)} "
          f"({statistics.median(kernel_rate) * flops / 1e12:.1f} model TFLOP/s at the median); plain "
          f"{spread(plain_rate)} ({statistics.median(plain_rate) * flops / 1e12:.1f}); "
          f"{flops / 1e9:.2f} GFLOP per image; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del plain_state

    # Under BENCH_ATTN_PROJ=1 the decoder (197 tokens, padded by the recipe)
    # folds its projection into the attention kernel; the encoder at 50
    # tokens keeps the attention kernel and the separate projection.
    with projection_fold(True):
        state = fresh_state()
    folds = [[b.attn.proj_fold for b in blocks]
             for blocks in (state.model.blocks, state.model.decoder_blocks)]
    if any(folds[0]) or not all(folds[1]):
        fail(f"pretrain under BENCH_ATTN_PROJ=1: encoder folds {folds[0]}, decoder {folds[1]}")
    loss, grads = pretrain_loss_and_grads(state, batches[0], noise[0])
    with plain_kernels():
        plain_loss, plain_grads = pretrain_loss_and_grads(state, batches[0], noise[0])
    check_step_one(loss, grads, plain_loss, plain_grads, LOSS_RTOL, GRAD_RTOL,
                   "pretrain under BENCH_ATTN_PROJ=1")
    del grads, plain_grads
    fold_steps = 2
    ops.reset_launch_counts()
    losses = [train_step(state, batches[i], noise[i], schedule(i))["loss"].item()
              for i in range(fold_steps)]
    fold_counts = ops.launch_counts()
    per_step = dict(per_step, fused_qkv_attention=enc_depth, fused_qkv_attention_backward=enc_depth,
                    attn_proj=dec_depth, attn_proj_backward=dec_depth)
    check_counts(fold_counts, per_step, fold_steps,
                 f"{fold_steps} pretrain steps under BENCH_ATTN_PROJ=1")
    if not all(np.isfinite(losses)):
        fail(f"non-finite pretrain loss under BENCH_ATTN_PROJ=1: {losses}")
    print(f"pretrain losses under BENCH_ATTN_PROJ=1: {[round(x, 6) for x in losses]}")
    return {name: counts[name] + fold_counts[name] for name in counts}


ENGINE_FRAMES = 130  # two steps of 64 an epoch, the short batch dropped
ENGINE_EPOCHS = 3


def write_jpeg_frames(root: Path, n: int) -> None:
    """``n`` JPEG frames of random pixels, 240-272 x 300, under ``root``."""
    from PIL import Image

    root.mkdir(parents=True)
    rng = np.random.default_rng(SEED)
    for i in range(n):
        pixels = rng.integers(0, 256, (240 + i % 3 * 16, 300, 3), dtype=np.uint8)
        Image.fromarray(pixels).save(root / f"{i:03d}.jpg", quality=90)


def tree_differences(a, b, prefix: str = "") -> list[str]:
    """The leaves of two checkpoint payloads that differ in a bit."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{prefix}: keys {sorted(set(a) ^ set(b))}"]
        return [d for key in a for d in tree_differences(a[key], b[key], f"{prefix}/{key}")]
    a, b = np.asarray(a), np.asarray(b)
    same = a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()
    return [] if same else [prefix]


def phase_pretrain_engine() -> dict[str, int]:
    """The pretraining engine at full width through ``cli_main``: run A
    uninterrupted, run B signalled in epoch 1's last step and auto-resumed,
    A's and B's last checkpoints bit for bit, then the classifier built
    from A's checkpoint and one eval batch through the kernels."""
    import signal
    from unittest import mock

    from ssl4polyp_tpu_torch.models.factory import build_classifier
    from ssl4polyp_tpu_torch.models.mae import encoder_only
    from ssl4polyp_tpu_torch.models.weights import state_dict_from_jax
    from ssl4polyp_tpu_torch.training import pretrain as engine
    from ssl4polyp_tpu_torch.utils.checkpoint import AsyncCheckpointer
    from ssl4polyp_tpu_torch.utils.logging import RunLogger

    steps_per_epoch = ENGINE_FRAMES // BATCH
    saves: list[dict] = []  # one record a save, in order
    step_seconds: list[float] = []

    class TimedCheckpointer(AsyncCheckpointer):
        """Records each save's host snapshot and, once joined, its write."""

        def save(self, path, payload, meta=None, **kwargs):
            out = super().save(path, payload, meta, **kwargs)
            saves[-1].update(path=Path(path).name, copy_s=self.last_snapshot_seconds)
            self.writing = saves[-1]
            return out

        def wait(self):
            super().wait()
            if getattr(self, "writing", None) is not None:
                self.writing["write_s"] = self.last_write_seconds
                self.writing = None

    def timed_payload(state):
        start = time.perf_counter()
        torch.cuda.synchronize()
        payload = checkpoint_payload(state)
        saves.append({"layout_s": time.perf_counter() - start})
        return payload

    def timed_step_builder(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def timed_step(*step_args):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = step(*step_args)
            torch.cuda.synchronize()
            step_seconds.append(time.perf_counter() - start)
            return out
        return timed_step

    resume_seconds: dict[str, float] = {}

    def timed(name: str, fn):
        def run(*args, **kwargs):
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            resume_seconds[name] = time.perf_counter() - start
            return out
        return run

    checkpoint_payload, make_step = engine.checkpoint_payload, engine.make_pretrain_step
    scalar = RunLogger.scalar
    signal_at = {"step": None}

    def scalar_then_signal(self, tag, value, step):
        scalar(self, tag, value, step)
        if tag == "train/loss" and step == signal_at["step"]:
            signal.raise_signal(signal.SIGTERM)  # the engine's handler saves and returns

    walls = {}
    with tempfile.TemporaryDirectory() as tmp, projection_fold(False), \
            mock.patch.object(engine, "AsyncCheckpointer", TimedCheckpointer), \
            mock.patch.object(engine, "checkpoint_payload", timed_payload), \
            mock.patch.object(engine, "make_pretrain_step", timed_step_builder), \
            mock.patch.object(engine, "load_checkpoint", timed("read", engine.load_checkpoint)), \
            mock.patch.object(engine, "restore_state", timed("restore", engine.restore_state)), \
            mock.patch.object(RunLogger, "scalar", scalar_then_signal):
        tmp = Path(tmp)
        write_jpeg_frames(tmp / "frames" / "train" / "unlabelled", ENGINE_FRAMES)

        def argv(run: str) -> list[str]:  # MAE ViT-B/16, bf16, batch 64, async saves
            return ["--data-root", str(tmp / "frames"), "--output-dir", str(tmp / run),
                    "--epochs", str(ENGINE_EPOCHS), "--warmup-epochs", "1",
                    "--batch-size", str(BATCH), "--num-workers", "8", "--log-interval", "1",
                    "--save-freq-epochs", "1000", "--keep-last", "2", "--seed", str(SEED)]

        def run(name: str, args: list[str]) -> dict:
            steps_before = len(step_seconds)
            start = time.perf_counter()
            summary = engine.cli_main(args)
            torch.cuda.synchronize()
            walls[name] = (time.perf_counter() - start, sum(step_seconds[steps_before:]),
                           len(step_seconds) - steps_before)
            return summary

        ops.reset_launch_counts()
        summary_a = run("A", argv("A"))
        signal_at["step"] = 2 * steps_per_epoch  # epoch 1's last step
        summary_b = run("B", argv("B"))
        signal_at["step"] = None
        resumed = run("B resumed", argv("B") + ["--resume", "auto"])
        counts = ops.launch_counts()
        if summary_b != {"interrupted": True, "epoch": 1}:
            fail(f"pretrain engine: run B returned {summary_b}, expected the signal's return")
        for name, summary in (("A", summary_a), ("B resumed", resumed)):
            if summary.get("epoch") != ENGINE_EPOCHS - 1 or not np.isfinite(summary["train_loss"]):
                fail(f"pretrain engine: run {name} returned {summary}")
        epochs_logged = {run_dir: [json.loads(line)["epoch"] for line in
                                   (tmp / run_dir / "pretrain.jsonl").read_text().splitlines()]
                         for run_dir in ("A", "B")}
        if epochs_logged != {"A": [0, 1, 2], "B": [0, 2]}:
            fail(f"pretrain engine: epochs logged {epochs_logged}")
        if "Signal received" not in (tmp / "B" / "pretrain.log").read_text():
            fail("pretrain engine: run B logged no signal")
        enc, dec = 12, 8  # MAE ViT-B/16's encoder and decoder depths
        per_step = {"fused_qkv_attention": enc + dec, "fused_qkv_attention_backward": enc + dec,
                    "layernorm": 2 * (enc + dec) + 2, "layernorm_backward": 2 * (enc + dec) + 2,
                    "fc1_gelu": enc + dec, "adamw": 4}
        steps = steps_per_epoch * (2 * ENGINE_EPOCHS)  # A's 6 steps, B's 4 and 2 resumed
        check_counts(counts, per_step, steps, f"the pretrain engine's {steps} steps")

        final = f"checkpoint-{ENGINE_EPOCHS - 1}.ckpt"
        kept = {run_dir: sorted(p.name for p in (tmp / run_dir / "ckpts").glob("checkpoint-*.ckpt"))
                for run_dir in ("A", "B")}
        if kept != {"A": [final], "B": ["checkpoint-1.ckpt", final]}:
            fail(f"pretrain engine: checkpoints kept {kept}")
        a = load_checkpoint(tmp / "A" / "ckpts" / final)
        b = load_checkpoint(tmp / "B" / "ckpts" / "last.ckpt")
        diffs = tree_differences(a["payload"], b["payload"])
        if diffs or int(a["payload"]["opt"]["step"]) != steps_per_epoch * ENGINE_EPOCHS:
            fail(f"pretrain engine: run B's {final} differs from run A's in {diffs[:8]} "
                 f"(step {a['payload']['opt']['step']} and {b['payload']['opt']['step']})")
        print(f"pretrain engine: run B (SIGTERM in epoch 1's last step, then resume='auto') ends "
              f"with {final} bit-equal to run A's in params, mu, nu and step "
              f"({int(a['payload']['opt']['step'])}); pretrain.jsonl epochs {epochs_logged}")

        # The SSL-colon chain: the classifier from A's checkpoint.
        classifier = build_classifier(torch.Generator().manual_seed(SEED),
                                      {"ss_framework": "mae", "key": "ssl_colon",
                                       "checkpoint": str(tmp / "A" / "ckpts" / final)},
                                      device="cuda")
        want = state_dict_from_jax(encoder_only(a["payload"]["params"]), classifier.cfg)
        got = {n: t.detach().cpu() for n, t in classifier.model.state_dict().items()}
        wrong = [n for n, t in want.items() if not torch.equal(got[n], t)]
        if wrong or sorted(set(got) - set(want)) != ["head.bias", "head.weight"]:
            fail(f"pretrain engine: the classifier's encoder differs from the checkpoint's "
                 f"masters in {wrong[:8]}")
        images = np.random.default_rng(SEED).integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
        forward = make_forward_fn(classifier, "cuda")()
        ops.reset_launch_counts()
        logits = forward(images)
        chain_counts = ops.launch_counts()
        check_counts(chain_counts, {"fused_qkv_attention": 12, "layernorm": 25, "fc1_gelu": 12},
                     1, "one eval batch of the classifier built from run A's checkpoint")
        with plain_kernels():
            plain_logits = forward(images)
        if logits.shape != (BATCH, 2) or not np.isfinite(logits).all():
            fail(f"pretrain engine chain: logits {logits.shape}, finite {np.isfinite(logits).all()}")
        err = max_error(torch.from_numpy(logits), torch.from_numpy(plain_logits), LOGITS_TOL,
                        "pretrain engine chain: logits against the plain forward")
        print(f"pretrain engine chain: build_classifier(ss_framework mae, run A's {final}) gives "
              f"an encoder bit-equal to the checkpoint's masters; one eval batch of {BATCH} "
              f"through the kernels against the plain forward: max |diff| {err:.3e} "
              f"(atol {LOGITS_TOL[0]}, rtol {LOGITS_TOL[1]})")

    for record in saves:
        snapshot = record["layout_s"] + record["copy_s"]
        print(f"pretrain engine save {record['path']}: host snapshot {snapshot:.3f} s "
              f"(device to host and JAX layout {record['layout_s']:.3f} s, the checkpointer's "
              f"copy {record['copy_s']:.3f} s), write {record.get('write_s', float('nan')):.3f} s "
              f"on the writer thread; {CARD}")
    print(f"pretrain engine resume: checkpoint read {resume_seconds['read']:.3f} s, restore into "
          f"the state (JAX layout to the masters and moments on the card) "
          f"{resume_seconds['restore']:.3f} s; {CARD}")
    for name, (wall, in_steps, n) in walls.items():
        print(f"pretrain engine run {name}: {n} steps, {wall:.2f} s wall, {in_steps:.2f} s in the "
              f"step (synchronised), {wall - in_steps:.2f} s outside it (model build, loader, "
              f"resume, saves, logging); {CARD}")
    return {name: counts[name] + chain_counts[name] for name in counts}


def one_scatter_blur_matrices(kernels: torch.Tensor, size: int) -> torch.Tensor:
    """The blur's matrices as ``data/augment.py`` first built them: one
    ``scatter_add_`` of every tap, whose clamped edge taps CUDA sums by
    atomics in no fixed order (F8).  For timing only."""
    batch, taps = kernels.shape
    offsets = torch.arange(taps, device=kernels.device) - taps // 2
    columns = torch.clamp(torch.arange(size, device=kernels.device)[:, None] + offsets, 0, size - 1)
    matrices = torch.zeros((batch, size, size), dtype=kernels.dtype, device=kernels.device)
    return matrices.scatter_add_(2, columns.expand(batch, size, taps),
                                 kernels[:, None, :].expand(batch, size, taps))


def tap_scatter_blur_matrices(kernels: torch.Tensor, size: int) -> torch.Tensor:
    """F8's first repair: one ``scatter_add_`` a tap, in tap order, so that no
    two additions of one launch meet.  The reference and the timing of the
    segmented sum that replaced it."""
    batch, taps = kernels.shape
    offsets = torch.arange(taps, device=kernels.device) - taps // 2
    columns = torch.clamp(torch.arange(size, device=kernels.device)[:, None] + offsets, 0, size - 1)
    matrices = torch.zeros((batch, size, size), dtype=kernels.dtype, device=kernels.device)
    for t in range(taps):
        matrices.scatter_add_(2, columns[None, :, t:t + 1].expand(batch, size, 1),
                              kernels[:, None, t:t + 1].expand(batch, size, 1))
    return matrices


def blur_cost(rate, state) -> None:
    """The blur's matrices on the card: the segmented sum bit-stable over
    repeated calls and against one scatter a tap; each of the three builders
    of one 224 axis on the host clock (200 calls, then one synchronisation)
    and in device time; and the fine-tune step's images/s with each,
    interleaved A B C C B A."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sigma = torch.rand(BATCH, device="cuda", generator=gen) * 2.0 + 1e-3
    positions = torch.arange(25, dtype=torch.float32, device="cuda") - 12.0
    kernels = torch.exp(-0.5 * torch.square(positions[None, :] / sigma[:, None]))
    kernels = kernels / kernels.sum(dim=1, keepdim=True)  # the step's taps
    first = augment._blur_matrices(kernels, 224)
    taps_ref = tap_scatter_blur_matrices(kernels, 224)
    for i in range(20):
        filler = torch.rand(i + 1, 2**20, device="cuda")  # moves the allocator's blocks
        if not torch.equal(augment._blur_matrices(kernels, 224), first):
            fail(f"the blur's segmented sum changed its bits on call {i + 2}")
        del filler
    err = (first - taps_ref).abs().max().item()
    if err > 1e-6:
        fail(f"the blur's segmented sum differs from one scatter a tap by {err}")
    print(f"fine-tune [fc1]: the blur's segmented sum kept its bits over 21 calls; against one "
          f"scatter a tap {'bit-equal' if torch.equal(first, taps_ref) else f'max |diff| {err:.3e}'}")
    builders = {"segmented sum": augment._blur_matrices,
                "one scatter a tap": tap_scatter_blur_matrices,
                "one scatter (before F8)": one_scatter_blur_matrices}
    for name, build in builders.items():
        def one_axis():
            build(kernels, 224)
        one_axis()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(200):
            one_axis()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - start) * 1e3 / 200
        print(f"fine-tune [fc1]: the blur's matrices for one axis of 224, batch {BATCH}, {name}: "
              f"host {host_ms:.4f} ms, device {time_ms(one_axis):.4f} ms; {CARD}")
    samples: dict[str, list[float]] = {name: [] for name in builders}
    order = list(builders) + list(builders)[::-1]
    for name in order:
        with mock.patch.object(augment, "_blur_matrices", builders[name]):
            samples[name] += rate(state)
    for name, values in samples.items():
        print(f"fine-tune [fc1] ViT-B/16, batch {BATCH}, the blur's matrices by {name}: images/s "
              f"over {len(values)} repeats of {REPEAT_CALLS} steps, {spread(values)}; {CARD}")


def phase_finetune() -> dict[str, int]:
    """The classifier's fine-tune step under each kernel configuration."""
    rng = np.random.default_rng(SEED)
    base = ViTConfig(pos_embed="learned", num_classes=2)
    tree = jax_layout_tree(base, rng)
    batches = [torch.from_numpy(rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)).cuda()
               for _ in range(STEPS)]
    labels = [torch.from_numpy(rng.integers(0, 2, BATCH)).cuda() for _ in range(STEPS)]
    valid = torch.arange(BATCH, device="cuda") < BATCH - 4  # the last rows are padding
    loss_mode, pos_weight, class_weights = loss_settings([3000, 1000])
    depth = base.depth
    total: dict[str, int] = {}
    for label, overrides, fold in FINETUNE_CONFIGS:
        def fresh_state():
            with projection_fold(fold):
                classifier = get_imagenet_or_random_vit(
                    torch.Generator().manual_seed(SEED), jax_params=tree, num_classes=2,
                    device="cuda", **overrides)
            return classifier, init_train_state(
                classifier, torch.Generator(device="cuda").manual_seed(SEED))

        classifier, state = fresh_state()
        ctx = step_context(classifier, loss_mode, pos_weight, class_weights, FT_WEIGHT_DECAY)
        step = make_train_step(ctx)
        full = optim.finetune_lr_scales(state.params, "full", depth)
        wd = optim.no_weight_decay_scales(state.params)
        what = f"fine-tune [{label}]"

        aug = draw_augment_params(BATCH, torch.Generator(device="cuda").manual_seed(SEED + 1))
        loss, grads = loss_and_grads(ctx, state, batches[0], labels[0], valid, aug)
        with plain_kernels():
            plain_loss, plain_grads = loss_and_grads(ctx, state, batches[0], labels[0], valid, aug)
        check_step_one(loss, grads, plain_loss, plain_grads, FT_LOSS_RTOL, FT_GRAD_RTOL, what)
        del grads, plain_grads

        def train(state) -> list[float]:
            return [step(state, batches[i], labels[i], valid, FT_LR, full, wd)["loss"].item()
                    for i in range(STEPS)]

        def rate(state, repeats: int = REPEATS) -> list[float]:  # after train(state)
            calls = iter(range(repeats * REPEAT_CALLS))

            def run():
                i = next(calls) % STEPS
                step(state, batches[i], labels[i], valid, FT_LR, full, wd)
            return rates(run, BATCH, repeats, REPEAT_CALLS)

        # An eval forward bound to the state's compute copy before training
        # must read the trained weights after it.
        bound_forward = make_forward_fn(classifier, "cuda")(state.params_c)
        probe = batches[0].cpu().numpy()
        untrained = bound_forward(probe)
        ops.reset_launch_counts()
        losses = train(state)
        counts = ops.launch_counts()
        trained = bound_forward(probe)
        fresh = make_forward_fn(classifier, "cuda")()(probe)  # a new copy of the masters
        err = max_error(torch.from_numpy(trained), torch.from_numpy(fresh), LOGITS_TOL,
                        f"{what}: the forward bound to the train state, after training")
        if np.array_equal(trained, untrained):
            fail(f"{what}: the forward bound to the train state did not follow training")
        print(f"{what}: the eval forward bound before training against one bound after it: max "
              f"|diff| {err:.3e} (atol {LOGITS_TOL[0]}, rtol {LOGITS_TOL[1]}); training moved "
              f"the logits by up to {np.abs(trained - untrained).max():.3e}")
        mlp_route, qkv_ln = classifier.model.blocks[0].mlp_route, classifier.model.blocks[0].qkv_ln
        if any(block.attn.proj_fold != fold for block in classifier.model.blocks):
            fail(f"{what}: the blocks' projection fold is not {fold}")
        # The final norm and each block's two: where a fused kernel folds a
        # LayerNorm in, its backward recomputes the normalised row and takes
        # the LayerNorm backward on the LayerNorm kernels, once each.
        # Under the fold the attention+projection kernel takes the attention
        # kernel's place, forward and backward (proj.weight's and proj.bias's
        # gradients come from it).  One AdamW pass over the 152 tensors.
        per_step = {
            "attn_proj" if fold else "fused_qkv_attention": depth,
            "attn_proj_backward" if fold else "fused_qkv_attention_backward": depth,
            "layernorm": 2 * depth + 1,
            "layernorm_backward": 2 * depth + 1,
            "ln_linear": depth if qkv_ln else 0,
            {"fc1": "fc1_gelu", "full": "mlp_fused", "full_ln": "mlp_ln_fused"}[mlp_route]: depth,
            "adamw": -(-len(state.params) // adamw.TENSORS_PER_LAUNCH),
        }
        check_counts(counts, per_step, STEPS, f"{STEPS} {what} steps")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        if not all(np.isfinite(losses)):
            fail(f"{what}: non-finite loss: {losses}")
        if not all(torch.isfinite(p).all() for p in state.params.values()):
            fail(f"{what}: non-finite parameters after the steps")
        print(f"{what} losses, kernels: {[round(x, 6) for x in losses]}")

        # head+1: the last block and the head train, everything else keeps its bits.
        head1 = optim.finetune_lr_scales(state.params, "head+1", depth)
        before = {n: p.clone() for n, p in state.params.items()}
        for i in range(2):
            step(state, batches[i], labels[i], valid, FT_LR, head1, wd)
        moved = {n for n, p in state.params.items() if not torch.equal(p, before[n])}
        trained = {n for n, scale in head1.items() if scale > 0}
        if not moved <= trained or not any(n.startswith("head.") for n in moved) or not any(
                n.startswith(f"blocks.{depth - 1}.") for n in moved):
            fail(f"{what}: head+1 moved {sorted(moved - trained)} (frozen) or left the head "
                 f"or block {depth - 1} in place")
        print(f"{what}: head+1 moved {len(moved)} of {len(trained)} trained parameters; the "
              f"{len(before) - len(trained)} frozen ones kept their bits")
        del before

        kernel_rate = rate(state)
        if label == "fc1":
            blur_cost(rate, state)
        del state, classifier
        _, plain_state = fresh_state()
        ops.reset_launch_counts()
        with plain_kernels():
            plain_losses = train(plain_state)
            plain_rate = rate(plain_state, PLAIN_REPEATS)
        if any(ops.launch_counts().values()):
            fail(f"{what}: the plain step launched a kernel")
        del plain_state
        print(f"{what} losses, plain:   {[round(x, 6) for x in plain_losses]}")
        print(f"{what} ViT-B/16, batch {BATCH}, images/s over {REPEATS} (plain {PLAIN_REPEATS}) "
              f"repeats of {REPEAT_CALLS} steps: kernels {spread(kernel_rate)}; plain "
              f"{spread(plain_rate)}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return total


def _route_gradients(route, a, weight, bias, dout):
    """(out, da, dweight, dbias) of one route of block 0's attention core."""
    leaves = [t.detach().clone().requires_grad_() for t in (a, weight, bias)]
    out = route(*leaves)
    out.backward(dout)
    return (out.detach(), *[leaf.grad for leaf in leaves])


def phase_attention_ops(gen: torch.Generator) -> dict[str, int]:
    """Block 0's attention core of the eval classifier, three ways, on a real
    activation: the path that launches ``fused_qkvproj_attention`` and
    ``fused_attention``, forward and backward; then the three at 384 px
    (577 tokens), each on the key tiles, and in fp32, each on the fp32
    kernels."""
    rng = np.random.default_rng(SEED)

    def activation(image_size: int, tokens: int):
        """Block 0's input activation, its QKV weight and bias, and an
        upstream gradient, of the ViT-B/16 classifier at ``image_size``."""
        cfg = ViTConfig(pos_embed="learned", num_classes=2, img_size=image_size)
        tree = jax_layout_tree(cfg, rng)
        images = rng.integers(0, 256, (BATCH, image_size, image_size, 3), dtype=np.uint8)
        with projection_fold(False):
            classifier = get_imagenet_or_random_vit(gen, jax_params=tree, num_classes=2,
                                                    device="cuda", img_size=image_size)
        model = layers.cast_params_for_compute(classifier.model, cfg.compute_dtype).eval()
        block = model.blocks[0]
        with torch.no_grad():
            x = model.patch_embed(normalize_batch(torch.from_numpy(images).cuda(),
                                                  cfg.compute_dtype))
            pos = model.pos_embed.to(cfg.compute_dtype)
            cls = (model.cls_token.to(cfg.compute_dtype) + pos[:, :1]).expand(BATCH, -1, -1)
            a = block.norm1(torch.cat([cls, x + pos[:, 1:]], dim=1))
        weight = block.attn.qkv.weight.detach()            # (3D, D): torch's (out, in)
        bias = block.attn.qkv.bias.detach().to(cfg.compute_dtype)
        dout = (torch.randn(a.shape, generator=torch.Generator(device="cuda").manual_seed(SEED),
                            device="cuda") * 0.1).to(cfg.compute_dtype)
        if a.shape != (BATCH, tokens, 768) or not torch.isfinite(a.float()).all():
            fail(f"attention ops: activation {tuple(a.shape)} is not a finite "
                 f"({BATCH}, {tokens}, 768) tensor")
        return a, weight, bias, dout, cfg.num_heads

    a, weight, bias, dout, heads = activation(224, 197)

    def split_heads(qkv):
        return [t.contiguous() for t in heads_of(qkv, heads)]

    def merge_heads(out):
        return out.transpose(1, 2).reshape(BATCH, out.shape[2], 768)

    def routes(core_qkv, core_proj, core_sep):
        return {
            # The model's route: the JAX package's bare dot, then the QKV kernel.
            "model": lambda a, w, b: core_qkv(torch.matmul(a, w.t()), heads, True, None, b),
            "fused_qkvproj_attention": lambda a, w, b: core_proj(
                a, w.t().contiguous(), b, heads, True),
            "fused_attention": lambda a, w, b: merge_heads(
                core_sep(*split_heads(layers.linear(a, w, b)))),
        }

    kernel_routes = routes(qkv_attention.fused_qkv_attention,
                           attention_block.fused_qkvproj_attention, attention.fused_attention)
    plain_routes = routes(qkv_attention.fused_qkv_attention_plain,
                          attention_block.fused_qkvproj_attention_plain,
                          attention.fused_attention_plain)
    launched = {"model": ("fused_qkv_attention", "fused_qkv_attention_backward"),
                "fused_qkvproj_attention": ("fused_qkvproj_attention",
                                            "fused_qkvproj_attention_backward"),
                "fused_attention": ("fused_attention", "fused_attention_backward")}
    total = {name: 0 for name in ops.launch_counts()}
    results = {}
    for name, route in kernel_routes.items():
        ops.reset_launch_counts()
        results[name] = _route_gradients(route, a, weight, bias, dout)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check_counts(counts, dict.fromkeys(launched[name], 1), 1,
                     f"one forward and backward pass of the {name} route")
        for kernel, n in counts.items():
            total[kernel] += n
    ops.reset_launch_counts()
    plain_results = {name: _route_gradients(route, a, weight, bias, dout)
                     for name, route in plain_routes.items()}
    torch.cuda.synchronize()
    if any(ops.launch_counts().values()):
        fail("attention ops: a plain route launched a kernel")

    d = 768

    def compare(got, want, what):
        err = max_error(got[0], want[0], ROUTE_OUT_TOL, f"{what}: out")
        line = f"{what}: out max |diff| {err:.3e} (atol {ROUTE_OUT_TOL[0]}, rtol {ROUTE_OUT_TOL[1]})"
        for label, g, ref in zip(("da", "dweight", "dbias"), got[1:], want[1:]):
            g, ref = g.float(), ref.float()
            if label == "dbias":  # the K slice is zero up to rounding on every route
                g, ref = torch.cat([g[:d], g[2 * d:]]), torch.cat([ref[:d], ref[2 * d:]])
            if not torch.isfinite(g).all():
                fail(f"{what}: {label} is not finite")
            rel = ((g - ref).norm() / ref.norm().clamp_min(1e-30)).item()
            if rel > ROUTE_GRAD_RTOL:
                fail(f"{what}: {label}: relative L2 distance {rel:.3e} exceeds {ROUTE_GRAD_RTOL}")
            line += f", {label} relative L2 distance {rel:.3e}"
        print(line + f" (limit {ROUTE_GRAD_RTOL})")

    for name in kernel_routes:
        compare(results[name], plain_results[name], f"attention ops [{name}] kernels vs plain")
    for name in ("fused_qkvproj_attention", "fused_attention"):
        compare(results[name], results["model"], f"attention ops [{name}] vs the model's route")

    # At 384 px (577 tokens): the three routes past 256 tokens, each on the
    # key tiles (fused_attention's in its layout, with its roundings).
    long_args = activation(384, 577)[:4]
    long_launched = {"model": ("fused_qkv_attention_tiles", "fused_qkv_attention_tiles_backward"),
                     "fused_qkvproj_attention": ("fused_qkvproj_attention_tiles",
                                                 "fused_qkvproj_attention_tiles_backward"),
                     "fused_attention": ("fused_attention_tiles",
                                         "fused_attention_tiles_backward")}
    long_results = {}
    for name, kernels in long_launched.items():
        ops.reset_launch_counts()
        long_results[name] = _route_gradients(kernel_routes[name], *long_args)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check_counts(counts, dict.fromkeys(kernels + ("qkv_attention_tiles_statistics",), 1), 1,
                     f"one forward and backward pass of the {name} route at 577 tokens")
        for kernel, n in counts.items():
            total[kernel] += n
    ops.reset_launch_counts()
    for name in long_launched:
        compare(long_results[name], _route_gradients(plain_routes[name], *long_args),
                f"attention ops at 577 tokens [{name}] kernels vs plain")
    if any(ops.launch_counts().values()):
        fail("attention ops: a plain route at 577 tokens launched a kernel")
    for name in ("fused_qkvproj_attention", "fused_attention"):
        compare(long_results[name], long_results["model"],
                f"attention ops at 577 tokens [{name}] vs the model's route")
    del long_args, long_results

    # In fp32, on the same activation and weights: the three routes on their
    # fp32 kernels, each against its plain version and against the model's
    # route, max |diff| within the fp32 fractions of max |plain|.
    f32_args = [t.float() for t in (a, weight, bias, dout)]
    fp32_routes = kernel_routes
    fp32_launched = {"model": ("fused_qkv_attention_f32", "fused_qkv_attention_backward_f32"),
                     "fused_qkvproj_attention": ("fused_qkvproj_attention_f32",
                                                 "fused_qkvproj_attention_backward_f32"),
                     "fused_attention": ("fused_attention_f32", "fused_attention_backward_f32")}
    results = {}
    for name, route in fp32_routes.items():
        ops.reset_launch_counts()
        results[name] = _route_gradients(route, *f32_args)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check_counts(counts, dict.fromkeys(fp32_launched[name], 1), 1,
                     f"one fp32 forward and backward pass of the {name} route")
        for kernel, n in counts.items():
            total[kernel] += n
    ops.reset_launch_counts()
    plain_results = {name: _route_gradients(plain_routes[name], *f32_args) for name in fp32_routes}
    torch.cuda.synchronize()
    if any(ops.launch_counts().values()):
        fail("attention ops: a plain fp32 route launched a kernel")
    checks = [(name, plain_results[name], "kernels vs plain") for name in fp32_routes]
    checks += [(name, results["model"], "vs the model's route")
               for name in ("fused_qkvproj_attention", "fused_attention")]
    for name, want, label in checks:
        got = results[name]
        errors = [max_relative_error(got[0], want[0], FP32_FWD_FRAC,
                                     f"fp32 attention ops [{name}] {label}: out")[0]]
        errors += [max_relative_error(g, r, FP32_GRAD_FRAC,
                                      f"fp32 attention ops [{name}] {label}: {part}")[0]
                   for part, g, r in zip(("da", "dweight", "dbias"), got[1:], want[1:])]
        print(f"fp32 attention ops [{name}] {label}: out, da, dweight, dbias "
              + ", ".join(f"{e:.3e}" for e in errors)
              + f" of max |reference| (limits {FP32_FWD_FRAC}, {FP32_GRAD_FRAC})")
    return total


def eval_checkpoint_meta(cfg: ViTConfig, tau: float) -> dict:
    """A fine-tune checkpoint's meta as the engine writes it: the model's
    config and a stored sun_full/val threshold ``tau``."""
    model_cfg = {"img_size": cfg.img_size, "patch_size": cfg.patch_size,
                 "embed_dim": cfg.embed_dim, "depth": cfg.depth, "num_heads": cfg.num_heads,
                 "pos_embed": cfg.pos_embed, "out_token": cfg.out_token, "num_classes": 2,
                 "pad_tokens_to": 0}
    return {"epoch": 7, "model_cfg": model_cfg,
            "thresholds": {"primary": {"tau": tau, "policy": "f1_opt_on_val",
                                       "split": "sun_full/val"},
                           "values": {"sun_full_val_f1_opt_on_val": tau}}}


def phase_eval_cli() -> dict[str, int]:
    """The standalone eval CLI at full width, from files it reads itself."""
    rng = np.random.default_rng(SEED)
    cfg = ViTConfig(pos_embed="learned", num_classes=2)
    frames, tau = 128, 0.4375
    meta = eval_checkpoint_meta(cfg, tau)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        start = time.perf_counter()
        build_synthetic_pack(tmp / "data_packs", name="sun_full", frames_per_split=frames,
                             image_size=224, seed=SEED)
        checkpoint = save_checkpoint(tmp / "run" / "SupImnet_SUNFull_s13_e07_valLoss.ckpt",
                                     {"params": jax_layout_tree(cfg, rng)}, meta)
        print(f"eval CLI: wrote a pack of 3 x {frames} JPEG frames of 224 px and a "
              f"{checkpoint.stat().st_size / 2**20:.0f} MiB checkpoint in "
              f"{time.perf_counter() - start:.1f} s")
        argv = ["--checkpoint-root", str(tmp / "run"), "--model-tag", "SupImnet", "--seed", "13",
                "--test-pack", "sun_full", "--pack-root", str(tmp / "data_packs"),
                "--batch-size", str(BATCH), "--output-dir", str(tmp / "eval"), "--export-outputs"]

        walls = []
        for _ in range(2):  # the second run finds the files in the page cache
            ops.reset_launch_counts()
            printed = io.StringIO()
            start = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                eval_classification.cli_main(argv)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
            counts = ops.launch_counts()
        summary = json.loads(printed.getvalue())
        batches = frames // BATCH
        check_counts(counts, {"fused_qkv_attention": cfg.depth, "layernorm": 2 * cfg.depth + 1,
                              "fc1_gelu": cfg.depth}, batches, f"the eval CLI's {batches} batches")
        numbers = {k: v for k, v in summary.items() if isinstance(v, (int, float))}
        if summary["n_frames"] != frames or summary["tau"] != tau or summary["checkpoint"] != str(
                checkpoint) or not all(np.isfinite(v) for v in numbers.values()):
            fail(f"eval CLI: summary {summary}")
        missing = [name for name in ("eval_results.txt", "logits.npz", "logits.pt",
                                     "metadata.jsonl", "tau.json")
                   if not (tmp / "eval" / name).exists()]
        if missing:
            fail(f"eval CLI: {missing} not written")
        stored = np.load(tmp / "eval" / "logits.npz")
        loaded = torch.load(tmp / "eval" / "logits.pt", weights_only=True)
        if not np.array_equal(loaded.numpy(), stored["logits"]) or json.loads(
                (tmp / "eval" / "tau.json").read_text())["tau"] != tau:
            fail("eval CLI: logits.pt or tau.json disagree with logits.npz and the stored tau")

        # The same frames through make_forward_fn, stage by stage on the clock.
        clock = {}
        start = time.perf_counter()
        restored = load_checkpoint(checkpoint)
        clock["checkpoint read"] = time.perf_counter() - start
        start = time.perf_counter()
        classifier = get_imagenet_or_random_vit(
            torch.Generator().manual_seed(0), jax_params=restored["payload"]["params"],
            num_classes=2, device="cuda", pad_tokens_to=0)
        forward = make_forward_fn(classifier, "cuda")()
        torch.cuda.synchronize()
        clock["model build"] = time.perf_counter() - start
        index = create_classification_datasets(test_spec="sun_full", pack_root=tmp / "data_packs",
                                               image_size=224)["test"]
        loader = HostDataLoader(index, batch_size=BATCH, shuffle=False, drop_last=False)
        start = time.perf_counter()
        decoded = list(loader)
        clock["decode"] = time.perf_counter() - start
        start = time.perf_counter()
        for batch in decoded:
            torch.from_numpy(batch["image"]).cuda()
        torch.cuda.synchronize()
        clock["host to device copy"] = time.perf_counter() - start
        forward(decoded[0]["image"])  # warm-up
        start = time.perf_counter()
        logits = np.concatenate([forward(batch["image"]) for batch in decoded])
        clock["forward (copies included)"] = time.perf_counter() - start
        start = time.perf_counter()
        again = evaluate_split(lambda part: part,
                               [dict(batch, image=part)
                                for batch, part in zip(decoded, np.split(logits, batches))],
                               index, split_name="test", tau=tau)
        clock["metrics"] = time.perf_counter() - start
        err = max_error(torch.from_numpy(stored["logits"]), torch.from_numpy(logits), LOGITS_TOL,
                        "eval CLI: logits.npz against make_forward_fn on the same frames")
        if again["auroc"] != summary["auroc"] and err == 0.0:
            fail("eval CLI: the same logits gave another AUROC")
        forward_s = clock["forward (copies included)"]
        print(f"eval CLI: n_frames {summary['n_frames']}, tau {summary['tau']}, auroc "
              f"{summary['auroc']:.4f}, loss {summary['loss']:.4f}; logits.npz vs make_forward_fn "
              f"on the same decoded frames: max |diff| {err:.3e} (atol {LOGITS_TOL[0]}, rtol "
              f"{LOGITS_TOL[1]}); eval_results.txt, logits.pt, metadata.jsonl, tau.json written")
        print(f"eval CLI ViT-B/16, {frames} frames in {batches} batches of {BATCH}: end to end "
              f"{frames / walls[0]:.1f} frames/s cold, {frames / walls[1]:.1f} frames/s with the "
              f"files cached ({walls[1]:.3f} s); forward alone {frames / forward_s:.1f} frames/s; "
              "stages alone, s: " + ", ".join(f"{k} {v:.3f}" for k, v in clock.items()))
    return counts


FT_ENGINE_FRAMES = {"train": 256, "val": 128, "test": 128}
FT_ENGINE_EPOCHS = 3
FT_ENGINE_LIMIT = {"train": 4, "val": 2, "test": 2}  # batches of 64 a split


def write_engine_pack(root: Path) -> Path:
    """The synthetic sun_full pack of 224 px JPEG frames that the engine
    phases train and test on, under ``root / "data_packs"``."""
    start = time.perf_counter()
    packs = root / "data_packs"
    build_synthetic_pack(packs, name="sun_full", frames_per_split=FT_ENGINE_FRAMES,
                         image_size=224, seed=SEED)
    print(f"wrote a sun_full pack of {FT_ENGINE_FRAMES} JPEG frames of 224 px in "
          f"{time.perf_counter() - start:.1f} s")
    return packs


def phase_finetune_engine(packs: Path) -> dict[str, int]:
    """The fine-tune engine at full width through ``cli_main`` with
    ``config/exp/exp2.yaml``'s SSL-colon arm on the pack at ``packs``: run A
    from an MAE checkpoint, run A' the same, bit for bit, run B resumed in a
    copy of A's output, and the eval CLI on A's best checkpoint against A's
    test."""
    import shutil

    from ssl4polyp_tpu_torch.models.mae import MAE_VIT_B16, encoder_only
    from ssl4polyp_tpu_torch.models.weights import state_dict_from_jax
    from ssl4polyp_tpu_torch.training import classification as engine

    cfg = ViTConfig(num_classes=2)
    depth = cfg.depth
    stem = "SslColon_SUNFull_s47"
    per_step = {"fused_qkv_attention": depth, "fused_qkv_attention_backward": depth,
                "layernorm": 2 * depth + 1, "layernorm_backward": 2 * depth + 1,
                "fc1_gelu": depth, "adamw": 3}  # 152 tensors, 64 an AdamW launch
    per_eval = {"fused_qkv_attention": depth, "layernorm": 2 * depth + 1, "fc1_gelu": depth}

    def expected(steps: int, eval_batches: int) -> dict[str, int]:
        return {name: steps * per_step.get(name, 0) + eval_batches * per_eval.get(name, 0)
                for name in ops.launch_counts()}

    # What the first step of the next run must see, and what it saw.  Runs A
    # and B time each step between two synchronisations, which take the
    # overlap of the host's launches with the card's work away; run A' does
    # not, so that its train loop runs as a user's does.
    expect: dict[str, dict] = {}
    starts: list[list[str]] = []
    step_seconds: list[float] = []
    sync_steps = [True]
    make_step = engine.make_train_step

    def timed_make_step(ctx):
        step = make_step(ctx)
        first = [True]

        def timed_step(state, *args):
            if first[0]:
                first[0] = False
                wrong = []
                for key, tensors in (("params", state.params), ("mu", state.opt.mu),
                                     ("nu", state.opt.nu)):
                    for name, want in expect.get(key, {}).items():
                        if not torch.equal(tensors[name], want.to(tensors[name].device)):
                            wrong.append(f"{key}/{name}")
                if "step" in expect and state.opt.step != expect["step"]:
                    wrong.append(f"step {state.opt.step}")
                starts.append(wrong)
            if not sync_steps[0]:
                return step(state, *args)
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = step(state, *args)
            torch.cuda.synchronize()
            step_seconds.append(time.perf_counter() - start)
            return out
        return timed_step

    with tempfile.TemporaryDirectory() as tmp, projection_fold(False), \
            mock.patch.object(engine, "make_train_step", timed_make_step):
        tmp = Path(tmp)
        root = tmp / "checkpoint_root"
        start = time.perf_counter()
        mae_tree = jax_layout_mae_tree(MAE_VIT_B16, np.random.default_rng(SEED))
        mae_path = save_checkpoint(
            root / "checkpoints/pretrained/vit_b/mae_hyperkvasir.ckpt", {"params": mae_tree},
            {"epoch": 399, "model": "mae_vit_base_patch16"})
        print(f"fine-tune engine: wrote a {mae_path.stat().st_size / 2**20:.0f} MiB MAE "
              f"checkpoint at config/model/ssl_colon.yaml's path in "
              f"{time.perf_counter() - start:.1f} s")
        encoder = state_dict_from_jax(encoder_only(mae_tree), cfg)

        def argv(out: str, epochs: int) -> list[str]:
            return ["--exp-config", "config/exp/exp2.yaml", "--model-key", "ssl_colon",
                    "--seed", "47", "--pack-root", str(packs), "--checkpoint-root", str(root),
                    "--thresholds-root", str(tmp / f"th_{out}"), "--output-dir", str(tmp / out),
                    "--override", f"epochs={epochs}", "--override", f"batch_size={BATCH}",
                    "--limit-train-batches", str(FT_ENGINE_LIMIT["train"]),
                    "--limit-val-batches", str(FT_ENGINE_LIMIT["val"]),
                    "--limit-test-batches", str(FT_ENGINE_LIMIT["test"])]

        walls: dict[str, tuple] = {}

        def run(name: str, args: list[str], steps: int, eval_batches: int) -> dict:
            steps_before = len(step_seconds)
            ops.reset_launch_counts()
            start = time.perf_counter()
            summary = engine.cli_main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            counts = ops.launch_counts()
            check_counts(counts, expected(steps, eval_batches), 1,
                         f"fine-tune engine run {name}: {steps} steps and {eval_batches} eval "
                         f"batches")
            if starts[-1]:
                fail(f"fine-tune engine run {name}: before step 1 the state differs from what "
                     f"it starts from in {starts[-1][:8]}")
            in_steps = sum(step_seconds[steps_before:]) if sync_steps[0] else None
            walls[name] = (wall, in_steps, steps, summary["timings"])
            return summary | {"counts": counts}

        def run_dir(out: str) -> Path:
            return tmp / out / "sun_baselines"

        # Run A, then A' into another directory: the encoder before step 1
        # is the MAE checkpoint's, and every file of the two runs agrees.
        epoch_steps, epoch_evals = FT_ENGINE_LIMIT["train"], FT_ENGINE_LIMIT["val"]
        n_steps = FT_ENGINE_EPOCHS * epoch_steps
        n_evals = FT_ENGINE_EPOCHS * epoch_evals + FT_ENGINE_LIMIT["test"]
        expect.clear()
        expect["params"] = encoder
        summary_a = run("A", argv("A", FT_ENGINE_EPOCHS), n_steps, n_evals)
        sync_steps[0] = False
        summary_a2 = run("A'", argv("A2", FT_ENGINE_EPOCHS), n_steps, n_evals)
        sync_steps[0] = True
        a_dir = run_dir("A")
        payload = summary_a["payload"]
        # The engine reads every step's loss back and raises on a non-finite one.
        if summary_a["epochs_run"] != FT_ENGINE_EPOCHS or not np.isfinite(payload["train_loss"]):
            fail(f"fine-tune engine run A: {summary_a['epochs_run']} epochs, last epoch's mean "
                 f"loss {payload['train_loss']}")
        best = (a_dir / f"{stem}.ckpt").resolve()
        files = [f"{stem}.config.yaml", f"{stem}.log", f"{stem}.ckpt", best.name,
                 f"{stem}.metrics.json", f"{stem}_last.metrics.json", f"{stem}_test_outputs.csv"]
        missing = [f for f in files if not (a_dir / f).exists()]
        stores = list((tmp / "th_A").rglob("policy-f1_opt_on_val.json"))
        if missing or not stores:
            fail(f"fine-tune engine run A: {missing} not written, thresholds files {stores}")
        csv_sha = hashlib.sha256((a_dir / f"{stem}_test_outputs.csv").read_bytes()).hexdigest()
        best_meta = load_checkpoint(best)["meta"]
        tau = summary_a["tau"]
        blocks = {"val", "test_primary", "test_sensitivity", "run", "provenance", "data",
                  "thresholds"}
        if (csv_sha != payload["provenance"]["test_outputs_csv_sha256"]
                or not (tau is not None and 0.0 <= tau <= 1.0)
                or best_meta["thresholds"]["primary"]["tau"] != tau
                or not blocks <= set(payload)):
            fail(f"fine-tune engine run A: outputs CSV sha256 {csv_sha} against "
                 f"{payload['provenance']['test_outputs_csv_sha256']}, tau {tau} against the best "
                 f"checkpoint's {best_meta['thresholds']['primary']['tau']}, blocks "
                 f"{sorted(blocks - set(payload))} missing")
        a2_dir = run_dir("A2")
        names = sorted(p.name for p in a_dir.glob(f"{stem}_*e*_*.ckpt"))
        diffs = {name: tree_differences(load_checkpoint(a_dir / name)["payload"],
                                        load_checkpoint(a2_dir / name)["payload"])
                 for name in names}
        if (names != sorted(p.name for p in a2_dir.glob(f"{stem}_*e*_*.ckpt"))
                or any(diffs.values())
                or (a_dir / f"{stem}_test_outputs.csv").read_bytes()
                != (a2_dir / f"{stem}_test_outputs.csv").read_bytes()):
            fail(f"fine-tune engine: run A' differs from run A: {names}, "
                 f"{ {k: v[:4] for k, v in diffs.items() if v} } or the outputs CSV; torch's "
                 f"deterministic mode names {nondeterministic_ops(engine.cli_main, argv('C', 1))}")
        print(f"fine-tune engine: runs A and A' (exp2, ssl_colon, ViT-B/16, batch {BATCH}, "
              f"{FT_ENGINE_EPOCHS} epochs of {epoch_steps} steps) start from the MAE "
              f"checkpoint's encoder bit for bit; their checkpoints {names} are bit-equal in "
              f"params, mu, nu and step, their outputs CSVs byte-equal; best {best.name}, tau "
              f"{tau}, test AUROC {payload['test_primary']['auroc']:.4f}; losses finite")
        shutil.rmtree(tmp / "A2")

        # Run B: --resume in a copy of A's output, one more epoch.
        shutil.copytree(tmp / "A", tmp / "B", symlinks=True)
        restored = load_checkpoint(best)
        expect.clear()
        expect.update(
            params=state_dict_from_jax(restored["payload"]["params"], cfg),
            mu=state_dict_from_jax(restored["payload"]["opt"]["mu"], cfg),
            nu=state_dict_from_jax(restored["payload"]["opt"]["nu"], cfg),
            step=int(restored["payload"]["opt"]["step"]))
        del restored
        resumed_epochs = FT_ENGINE_EPOCHS + 1 - (best_meta["epoch"] + 1)
        summary_b = run("B", argv("B", FT_ENGINE_EPOCHS + 1) + ["--resume"],
                        resumed_epochs * epoch_steps,
                        resumed_epochs * epoch_evals + FT_ENGINE_LIMIT["test"])
        line = f"resumed from {stem}.ckpt at epoch {best_meta['epoch'] + 1}"
        if line not in (run_dir("B") / f"{stem}.log").read_text() or \
                summary_b["epochs_run"] != FT_ENGINE_EPOCHS + 1:
            fail(f"fine-tune engine run B: no '{line}' in its log, or {summary_b['epochs_run']} "
                 f"epochs run")
        print(f"fine-tune engine: run B logged '{line}' (the pointer to {best.name}), started "
              f"from its masters, moments and step ({expect['step']}) bit for bit and ran to "
              f"epoch {summary_b['epochs_run'] - 1}")
        expect.clear()

        # The eval CLI on A's best checkpoint and A's test split.
        printed = io.StringIO()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(printed):
            eval_classification.cli_main([
                "--checkpoint", str(best), "--test-pack", "sun_full", "--pack-root",
                str(packs), "--batch-size", str(BATCH), "--output-dir", str(tmp / "eval")])
        cli_counts = ops.launch_counts()
        check_counts(cli_counts, per_eval, FT_ENGINE_LIMIT["test"],
                     "the eval CLI on run A's best checkpoint")
        cli = json.loads(printed.getvalue())
        test_block = payload["test_primary"]
        shared = sorted(k for k, v in test_block.items()
                        if isinstance(v, (int, float)) and isinstance(cli.get(k), (int, float)))
        off = {k: (cli[k], test_block[k]) for k in shared
               if not abs(cli[k] - test_block[k]) <= 1e-6}
        if cli["tau"] != tau or cli["n_frames"] != FT_ENGINE_FRAMES["test"] or off or \
                len(shared) < 10:
            fail(f"eval CLI on run A's best checkpoint: tau {cli['tau']} against {tau}, "
                 f"{cli['n_frames']} frames, off {off}, {len(shared)} metrics compared")
        print(f"fine-tune engine: the eval CLI on {best.name} gives tau {cli['tau']} and "
              f"{len(shared)} test metrics within 1e-6 of run A's test_primary")

    for name, (wall, in_steps, steps, timings) in walls.items():
        saves = ", ".join(f"{path} {snapshot:.3f} + {write:.3f} s"
                          for path, snapshot, write in timings["saves"])
        rest = wall - timings["build_s"] - timings["train_s"] - sum(
            timings[k] for k in ("val_s", "test_s", "reload_s", "export_s")) - sum(
            snapshot + write for _, snapshot, write in timings["saves"])
        loop = (f"train loop {timings['train_s']:.2f} s for {timings['train_images']} images "
                f"({timings['train_images'] / timings['train_s']:.1f} images/s")
        if in_steps is None:
            loop += ", no synchronisation beyond the engine's own)"
        else:
            loop += (f" with a synchronisation on each side of every step; the {steps} steps "
                     f"inside them {in_steps:.2f} s, the loop beyond them "
                     f"{timings['train_s'] - in_steps:.2f} s)")
        print(f"fine-tune engine run {name}: {wall:.2f} s wall; {loop}; outside the train loop "
              f"{wall - timings['train_s']:.2f} s: model build with the MAE read "
              f"{timings['build_s']:.2f} s, val "
              f"{timings['val_s']:.2f} s, test {timings['test_s']:.2f} s, best reload "
              f"{timings['reload_s']:.2f} s, exports {timings['export_s']:.3f} s, saves (host "
              f"snapshot + write) [{saves}], the rest (configs, logger, thresholds) "
              f"{rest:.2f} s; {CARD}")
    total = {}
    for counts in (summary_a["counts"], summary_a2["counts"], summary_b["counts"], cli_counts):
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    return total


WF_LIMIT = {"train": 3, "val": 1, "test": 2}  # batches of 64, one epoch
DENSE_BATCH = 32
# The dense model's logits through the kernels against its plain forward on
# the card, both bf16: the encoder's kernels round where the plain versions
# round differently, and the decoder's 14 convs carry that through.  (atol
# as a fraction of max|plain|, rtol.)
DENSE_LOGITS_TOL = (5e-2, 5e-2)


def phase_weight_files(packs: Path) -> dict[str, int]:
    """exp1's two arms from the weight files their model configs name, and
    the dense model, at full width (ViT-B/16, 224 px).

    (a) An upstream-layout MAE ``.pth`` and a big_vision AugReg ``.npz``,
    written from numpy seeds under a temporary ``--checkpoint-root`` at the
    paths of ``config/model/ssl_imnet.yaml`` and ``sup_imnet.yaml``.  (b)
    ``cli_main`` on ``config/exp/exp1.yaml``'s ``sup_imnet`` and
    ``ssl_imnet`` arms on the card: the scheme the factory built, the
    masters before step 1 equal to the file's tensors bit for bit, exact
    launch counts (the step's kernels and the eval forward's), and the eval
    CLI on the run's best checkpoint within 1e-6 of the run's test.  (c) The
    dense classifier (``dense_readout: project``) from the ``.pth``: a batch
    of 32 through its kernels (the tap path's attention, LayerNorm and
    fc1+GELU) against the same model with every kernel plain, and the
    forward's median time."""
    from ssl4polyp_tpu_torch.models.factory import DenseClassifier, build_classifier
    from ssl4polyp_tpu_torch.models.mae import MAE_VIT_B16, encoder_only
    from ssl4polyp_tpu_torch.models.weights import state_dict_from_jax
    from ssl4polyp_tpu_torch.training import classification as engine

    cfg = ViTConfig(num_classes=2)
    depth = cfg.depth
    per_step = {"fused_qkv_attention": depth, "fused_qkv_attention_backward": depth,
                "layernorm": 2 * depth + 1, "layernorm_backward": 2 * depth + 1,
                "fc1_gelu": depth, "adamw": 3}
    per_eval = {"fused_qkv_attention": depth, "layernorm": 2 * depth + 1, "fc1_gelu": depth}
    models = {name: config_model(name) for name in ("sup_imnet", "ssl_imnet")}
    built: list = []
    first_masters: list[dict] = []
    make_step, build = engine.make_train_step, engine.build_classifier

    def recording_build(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    def recording_make_step(ctx):
        step = make_step(ctx)

        def first(state, *args):
            if len(first_masters) < len(built):
                first_masters.append({n: t.clone() for n, t in state.params.items()})
            return step(state, *args)
        return first

    total: dict[str, int] = {}

    def add(counts: dict[str, int]) -> None:
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

    with tempfile.TemporaryDirectory() as tmp, projection_fold(False), \
            mock.patch.object(engine, "make_train_step", recording_make_step), \
            mock.patch.object(engine, "build_classifier", recording_build):
        tmp = Path(tmp)
        root = tmp / "checkpoint_root"
        start = time.perf_counter()
        encoders = {
            "ssl_imnet": encoder_only(write_mae_pth(root / models["ssl_imnet"]["checkpoint"],
                                                    MAE_VIT_B16, np.random.default_rng(SEED))),
            "sup_imnet": write_augreg_npz(root / models["sup_imnet"]["checkpoint"], cfg,
                                          np.random.default_rng(SEED + 1)),
        }
        sizes = {name: (root / m["checkpoint"]).stat().st_size / 2**20 for name, m in models.items()}
        print(f"weight files: wrote an MAE .pth ({sizes['ssl_imnet']:.0f} MiB, encoder and "
              f"decoder under timm's MAE names, an argparse.Namespace as args) and an AugReg "
              f".npz ({sizes['sup_imnet']:.0f} MiB, big_vision keys, a 1000-way head) in "
              f"{time.perf_counter() - start:.1f} s")

        for arm in ("sup_imnet", "ssl_imnet"):
            out = tmp / arm
            ops.reset_launch_counts()
            start = time.perf_counter()
            summary = engine.cli_main([
                "--exp-config", "config/exp/exp1.yaml", "--model-key", arm, "--seed", "13",
                "--pack-root", str(packs), "--checkpoint-root", str(root),
                "--thresholds-root", str(tmp / f"th_{arm}"), "--output-dir", str(out),
                "--device", "cuda", "--override", "epochs=1",
                "--override", f"batch_size={BATCH}",
                "--limit-train-batches", str(WF_LIMIT["train"]),
                "--limit-val-batches", str(WF_LIMIT["val"]),
                "--limit-test-batches", str(WF_LIMIT["test"])])
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            counts = ops.launch_counts()
            add(counts)
            evals = WF_LIMIT["val"] + WF_LIMIT["test"]
            check_counts(counts, {name: WF_LIMIT["train"] * per_step.get(name, 0)
                                  + evals * per_eval.get(name, 0) for name in counts}, 1,
                         f"exp1 {arm}: {WF_LIMIT['train']} steps and {evals} eval batches")
            classifier = built[-1]
            if classifier.scheme != arm or len(first_masters) != len(built):
                fail(f"exp1 {arm}: the factory built scheme {classifier.scheme!r}; "
                     f"{len(first_masters)} first steps seen for {len(built)} builds")
            want = state_dict_from_jax(encoders[arm], classifier.cfg)
            masters = first_masters[-1]
            wrong = [n for n, t in want.items() if not torch.equal(masters[n].cpu(), t)]
            if wrong or set(masters) - set(want) != {"head.weight", "head.bias"}:
                fail(f"exp1 {arm}: before step 1 the masters differ from the file's tensors in "
                     f"{wrong[:8]}, or hold {sorted(set(masters) - set(want))} beyond them")
            payload = summary["payload"]
            if summary["epochs_run"] != 1 or not np.isfinite(payload["train_loss"]):
                fail(f"exp1 {arm}: {summary['epochs_run']} epochs, loss {payload['train_loss']}")
            best = (Path(summary["metrics_path"]).parent / f"{summary['stem']}.ckpt").resolve()
            printed = io.StringIO()
            ops.reset_launch_counts()
            with contextlib.redirect_stdout(printed):
                eval_classification.cli_main([
                    "--checkpoint", str(best), "--test-pack", "sun_full", "--pack-root",
                    str(packs), "--batch-size", str(BATCH), "--output-dir", str(tmp / f"ev_{arm}")])
            cli_counts = ops.launch_counts()
            add(cli_counts)
            check_counts(cli_counts, per_eval, WF_LIMIT["test"],
                         f"the eval CLI on exp1 {arm}'s best checkpoint")
            cli = json.loads(printed.getvalue())
            test_block = payload["test_primary"]
            shared = sorted(k for k, v in test_block.items()
                            if isinstance(v, (int, float)) and isinstance(cli.get(k), (int, float)))
            off = {k: (cli[k], test_block[k]) for k in shared
                   if not abs(cli[k] - test_block[k]) <= 1e-6}
            if cli["tau"] != summary["tau"] or off or len(shared) < 10:
                fail(f"eval CLI on exp1 {arm}'s best checkpoint: tau {cli['tau']} against "
                     f"{summary['tau']}, off {off}, {len(shared)} metrics compared")
            print(f"exp1 {arm} (ViT-B/16, batch {BATCH}, {WF_LIMIT['train']} steps): the factory "
                  f"built scheme {arm} from {models[arm]['checkpoint']}; before step 1 the "
                  f"{len(want)} encoder masters equal the file's tensors bit for bit; test AUROC "
                  f"{test_block['auroc']:.4f}, tau {summary['tau']}; the eval CLI on {best.name} "
                  f"gives {len(shared)} test metrics within 1e-6; {wall:.1f} s wall (model build "
                  f"with the file's read {summary['timings']['build_s']:.2f} s); {CARD}")
            del classifier
            built.clear()
            first_masters.clear()

        # (c) The dense model from the .pth, through its kernels and plain.
        start = time.perf_counter()
        dense = build_classifier(torch.Generator().manual_seed(SEED),
                                 {**models["ssl_imnet"], "dense": True, "dense_readout": "project"},
                                 checkpoint_root=root, device="cuda")
        build_s = time.perf_counter() - start
        if not isinstance(dense, DenseClassifier) or dense.scheme != "ssl_imnet":
            fail(f"dense build: {type(dense).__name__}, scheme {dense.scheme!r}")
        want = state_dict_from_jax(encoders["ssl_imnet"], dense.cfg)
        encoder = dict(dense.model.encoder.named_parameters())
        if set(encoder) != set(want) or any(not torch.equal(encoder[n].cpu(), t)
                                            for n, t in want.items()):
            fail("dense build: the encoder is not the .pth's")
        images = np.random.default_rng(SEED).integers(0, 256, (DENSE_BATCH, 224, 224, 3),
                                                      dtype=np.uint8)
        forward = make_forward_fn(dense, "cuda")()
        forward(images)  # warm-up
        ops.reset_launch_counts()
        logits = forward(images)
        counts = ops.launch_counts()
        add(counts)
        check_counts(counts, {"fused_qkv_attention": depth, "layernorm": 2 * depth,
                              "fc1_gelu": depth}, 1, "the dense forward")

        def median_ms(fn, n: int = 10) -> list[float]:
            times = []
            for _ in range(n):
                torch.cuda.synchronize()
                begin = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - begin))
            return [statistics.median(times), min(times), max(times)]

        kernel_ms = median_ms(lambda: forward(images))
        ops.reset_launch_counts()
        with plain_kernels():
            plain = forward(images)
            plain_ms = median_ms(lambda: forward(images), 3)
        if any(ops.launch_counts().values()):
            fail("the dense forward with plain kernels launched a kernel")
        if logits.shape != (DENSE_BATCH, 112, 112, 2) or logits.dtype != np.float32:
            fail(f"dense logits {logits.shape} {logits.dtype}, expected ({DENSE_BATCH}, 112, 112, "
                 f"2) float32")
        scale = float(np.abs(plain).max())
        tol = (DENSE_LOGITS_TOL[0] * scale, DENSE_LOGITS_TOL[1])
        err = max_error(torch.from_numpy(logits), torch.from_numpy(plain), tol,
                        "dense logits against the plain forward")
        print(f"dense classifier (ViT-B/16 taps {{2, 5, 8, 11}} -> DPT, readout project, from "
              f"the .pth, built in {build_s:.2f} s): logits ({DENSE_BATCH}, 112, 112, 2) fp32, "
              f"max |diff| against the plain forward {err:.3e} (atol {DENSE_LOGITS_TOL[0]} x "
              f"max|plain| = {tol[0]:.3e}, rtol {tol[1]}), logit range "
              f"[{logits.min():.3f}, {logits.max():.3f}]; forward of {DENSE_BATCH} images "
              f"(uint8 on the host to fp32 logits on the host), median [min, max] of 10: kernels "
              f"{kernel_ms[0]:.2f} [{kernel_ms[1]:.2f}, {kernel_ms[2]:.2f}] ms, plain of 3 "
              f"{plain_ms[0]:.2f} [{plain_ms[1]:.2f}, {plain_ms[2]:.2f}] ms; {CARD}")
    return total


MF_EPOCHS, MF_STEPS = 2, 4  # the fine-tune's run: epochs of 4 steps of 64 (256 frames)
PROBE_EPOCHS = 1


def phase_mae_finetune(packs: Path) -> dict[str, int]:
    """The upstream MAE fine-tune and linear probe (``training/mae_finetune.py``)
    at full width, on the pack at ``packs``, from one ViT-B/16 classifier the
    factory builds from an MAE ``.pth`` (``config/model/ssl_imnet.yaml``'s
    path under a temporary checkpoint root).

    ``run_mae_finetune`` with the upstream recipe (layer decay 0.75, weight
    decay 0.05, smoothing 0.1, Mixup 0.8 and CutMix 1.0 switched at 0.5,
    erasing 0.25 with one box; batch 64, 2 epochs of 4 steps, warm-up 1
    epoch): (a) step 1's loss and every gradient against the plain step's
    on one set of draws, and one AdamW pass with the layer decay's 14 scales
    through the kernel bit-equal to the plain version's; (b) two runs from
    the classifier agree bit for bit; (c) after both, the classifier's own
    parameters are the file's; (d) every tensor moved, the position table
    among them; (e) exact launch counts.  ``run_linear_probe`` (LARS, lr 0.1,
    one epoch of 4 steps): the encoder bit-equal to the file's and the head
    moved, two runs bit-equal, the encoder's forward kernels only."""
    from ssl4polyp_tpu_torch.models.factory import build_classifier
    from ssl4polyp_tpu_torch.models.mae import MAE_VIT_B16, encoder_only
    from ssl4polyp_tpu_torch.models.weights import state_dict_from_jax
    from ssl4polyp_tpu_torch.training import mae_finetune as mf
    from ssl4polyp_tpu_torch.utils.determinism import step_seed

    phase_start = time.perf_counter()
    model_cfg = config_model("ssl_imnet")
    with tempfile.TemporaryDirectory() as tmp, projection_fold(False):
        root = Path(tmp)
        encoder = encoder_only(write_mae_pth(root / model_cfg["checkpoint"], MAE_VIT_B16,
                                             np.random.default_rng(SEED)))
        start = time.perf_counter()
        classifier = build_classifier(torch.Generator().manual_seed(SEED), model_cfg,
                                      checkpoint_root=root, device="cuda")
        build_s = time.perf_counter() - start
    depth = classifier.cfg.depth
    file_tensors = state_dict_from_jax(encoder, classifier.cfg)
    initial = {n: p.detach().clone() for n, p in classifier.model.named_parameters()}
    if classifier.scheme != "ssl_imnet" or any(
            not torch.equal(initial[n].cpu(), t) for n, t in file_tensors.items()):
        fail(f"mae fine-tune: the factory built scheme {classifier.scheme!r}, or the encoder "
             "is not the .pth's")
    train = create_classification_datasets(train_spec="sun_full", pack_root=packs,
                                           image_size=224)["train"]
    settings = mf.MAEFinetuneSettings(
        epochs=MF_EPOCHS, warmup_epochs=1, base_lr=1e-3, layer_decay=0.75, weight_decay=0.05,
        batch_size=BATCH, seed=SEED, smoothing=0.1, mixup_alpha=0.8, cutmix_alpha=1.0,
        reprob=0.25, recount=1)
    probe_settings = mf.MAEFinetuneSettings(
        epochs=PROBE_EPOCHS, warmup_epochs=0, base_lr=0.1, weight_decay=0.0, smoothing=0.0,
        batch_size=BATCH, seed=SEED)
    what = "mae fine-tune"

    # (a) Step 1 on the run's first batch and draws, kernels against plain;
    # then one AdamW pass with the layer decay's scales, kernel against plain.
    loader = HostDataLoader(train, batch_size=BATCH, seed=SEED, num_workers=8)
    if len(loader) != MF_STEPS:
        fail(f"{what}: {len(loader)} steps an epoch, expected {MF_STEPS}")
    loader.set_epoch(0)
    batch = next(iter(loader))
    images = torch.from_numpy(batch["image"]).cuda()
    labels = torch.from_numpy(batch["label"]).long().cuda()
    valid = torch.from_numpy(batch["valid"]).cuda()
    seed = step_seed(SEED, 0, 0)
    draws = mf.draw_step(tuple(images.shape), settings,
                         torch.Generator(device="cuda").manual_seed(seed),
                         np.random.default_rng(seed), augment=True,
                         dtype=classifier.cfg.compute_dtype)
    state = mf.finetune_state(classifier, initial, optim.adamw_init)
    loss, grads = mf.loss_and_grads(classifier, state.params_c, images, labels, valid, draws,
                                    settings)
    with plain_kernels():
        plain_loss, plain_grads = mf.loss_and_grads(classifier, state.params_c, images, labels,
                                                    valid, draws, settings)
    print(f"{what} step 1 draws: erasing on {int(draws.erasing.do.sum())} of {BATCH} images, "
          f"{draws.mixup}")
    check_step_one(loss, grads, plain_loss, plain_grads, FT_LOSS_RTOL, FT_GRAD_RTOL, what)
    lr_scale = optim.layerwise_lr_decay_scales(state.params, depth, settings.layer_decay)
    wd_scale = optim.no_weight_decay_scales(state.params)
    sides = []
    for update in (optim.adamw_update_fused, optim.adamw_update_fused_plain):
        side = mf.finetune_state(classifier, initial, optim.adamw_init)
        update(side.params, side.params_c, grads, side.opt, lr=1e-3, weight_decay=0.05,
               lr_scale=lr_scale, wd_scale=wd_scale)
        sides.append(side)
    wrong = differing(sides[0].params, sides[1].params) + differing(sides[0].params_c,
                                                                    sides[1].params_c)
    if wrong:
        fail(f"{what}: the AdamW kernel with the layer decay's scales differs from the plain "
             f"update in {wrong[:8]}")
    print(f"{what}: one AdamW pass with the layer decay's {len(set(lr_scale.values()))} "
          f"learning-rate scales over {len(lr_scale)} tensors, kernel against plain: masters "
          "and compute copy bit-equal")
    del state, grads, plain_grads, sides

    per_step = {"fused_qkv_attention": depth, "fused_qkv_attention_backward": depth,
                "layernorm": 2 * depth + 1, "layernorm_backward": 2 * depth + 1,
                "fc1_gelu": depth, "adamw": -(-len(initial) // adamw.TENSORS_PER_LAUNCH)}
    per_probe_step = {"fused_qkv_attention": depth, "layernorm": 2 * depth + 1,
                      "fc1_gelu": depth}
    total: dict[str, int] = {}

    def run(engine, run_settings, steps: int, expected: dict, label: str) -> tuple[dict, float]:
        """One engine run; its rate over the whole wall, and over the steps
        after the first: the device is synchronised once, as step 2 starts,
        which leaves out the loader's start, the first batch's decode and
        the step's first launches."""
        step_starts: list[float] = []
        loss_and_grads = mf.loss_and_grads

        def marked(*args, **kwargs):
            if len(step_starts) == 1:
                torch.cuda.synchronize()
            step_starts.append(time.perf_counter())
            return loss_and_grads(*args, **kwargs)

        ops.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        with mock.patch.object(mf, "loss_and_grads", marked):
            result = engine(classifier, train, run_settings, device="cuda")
        torch.cuda.synchronize()
        end = time.perf_counter()
        wall = end - start
        counts = ops.launch_counts()
        check_counts(counts, expected, steps, f"{steps} steps of the {label}")
        if len(step_starts) != steps:
            fail(f"{label}: {len(step_starts)} steps, expected {steps}")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        print(f"{label} (ViT-B/16, batch {BATCH}, {steps} steps): train_loss "
              f"{result['train_loss']:.6f}, {wall:.2f} s wall, {steps * BATCH / wall:.1f} "
              f"images/s over it (loader start included); steps 2-{steps} "
              f"{(steps - 1) * BATCH / (end - step_starts[1]):.1f} images/s; {CARD}")
        return result, wall

    steps = MF_EPOCHS * MF_STEPS
    tuned = [run(mf.run_mae_finetune, settings, steps, per_step, f"{what} run {i}")[0]
             for i in ("A", "B")]
    a, b = tuned
    diffs = differing(a["params"], b["params"])
    if diffs or a["train_loss"] != b["train_loss"] or not np.isfinite(a["train_loss"]):
        fail(f"{what}: two runs differ in {diffs[:8]}, or train_loss {a['train_loss']} against "
             f"{b['train_loss']}")
    still = [n for n, t in a["params"].items() if torch.equal(t, initial[n])]
    if still or "pos_embed" not in a["params"]:
        fail(f"{what}: {still[:8]} did not move")
    mf_changed = differing(dict(classifier.model.named_parameters()), initial)
    if mf_changed:
        fail(f"{what}: the runs changed the classifier's own {mf_changed[:8]}")
    print(f"{what}: runs A and B bit-equal in all {len(a['params'])} tensors and train_loss; "
          f"every tensor moved (pos_embed by up to "
          f"{(a['params']['pos_embed'] - initial['pos_embed']).abs().max().item():.3e}); the "
          "classifier's own parameters are still the file's")
    del tuned, a, b

    label = "linear probe"
    probes = [run(mf.run_linear_probe, probe_settings, PROBE_EPOCHS * MF_STEPS, per_probe_step,
                  f"{label} run {i}")[0] for i in ("A", "B")]
    a, b = probes
    diffs = differing(a["params"], b["params"])
    if diffs or a["train_loss"] != b["train_loss"] or not np.isfinite(a["train_loss"]):
        fail(f"{label}: two runs differ in {diffs[:8]}, or train_loss {a['train_loss']} against "
             f"{b['train_loss']}")
    moved = sorted(n for n, t in a["params"].items() if not torch.equal(t, initial[n]))
    if moved != ["head.bias", "head.weight"]:
        fail(f"{label}: moved {moved}, expected the head alone")
    if differing(dict(classifier.model.named_parameters()), initial):
        fail(f"{label}: the runs changed the classifier's own parameters")
    print(f"{label}: runs A and B bit-equal; the {len(a['params']) - 2} encoder tensors "
          f"bit-equal to the file's, the head moved; model build with the .pth's read "
          f"{build_s:.2f} s; the phase {time.perf_counter() - phase_start:.1f} s; {CARD}")
    del probes, a, b, classifier
    return total


# The synthetic SUN root of phase 11: 45 positive cases of 33 frames and 3
# negative source videos of 495 frames (15 chunks of 33 each), which `sun
# build --cases-per-split 15 15 15` turns into the study's 990-frame test
# split (15 cases a side) and as many train and val frames.
PT_POS_CASES, PT_FRAMES_PER_CASE = 45, 33
PT_NEG_SOURCES, PT_FRAMES_PER_SOURCE = 3, 495
PT_CASES_PER_SPLIT = (15, 15, 15)
PT_IMAGE = 224
PT_SPLIT_FRAMES = 2 * PT_CASES_PER_SPLIT[2] * PT_FRAMES_PER_CASE  # 990 a split
PT_GRID_ROWS = 16 * PT_SPLIT_FRAMES  # 15,840
PT_TRAIN_STEPS = 4
PT_LOADER_BATCHES = 15  # batches of the loader timed alone, a pack
# The exp5b run's clean rows against the parent's test exports: the same
# 990 frames through the same forward in batches of other rows.
PT_PROB_ATOL = 1e-6


def _csv_rows(path: Path) -> list[dict]:
    import csv

    with open(path, newline="", encoding="utf-8") as handle:
        return list(csv.DictReader(handle))


def phase_pack_tools() -> dict[str, int]:
    """The pack tools (``ssl4polyp_tpu_torch/polypdb``) and exp5b at the
    study's size: a synthetic SUN root of 224 px JPEG frames
    (``build_synthetic_sun_root``, the function ``polypdb synth-root``
    calls), ``polypdb sun build --cases-per-split 15 15 15`` (990 / 990 /
    990 rows) and ``polypdb sun perturbations`` (15,840 rows, per-row HMAC
    seeds, rendered in the pipeline) through the port's CLI, each
    manifest's rows, counts, assertions and hashes checked.  Then
    ``config/exp/exp1.yaml``'s ``sup_imnet`` arm through ``cli_main`` on the
    built sun_full (hashes verified, weights from an AugReg ``.npz``, one
    epoch of 4 steps of 64, full val and test) as the canonical SUN parent
    under ``<tmp>/classification``, and ``config/exp/exp5b.yaml``'s same arm
    and seed through ``cli_main``, which finds that parent as a user's run
    does and evaluates all 15,840 rows at full width: all 16 grid tags and
    ``ALL-perturbed`` in ``metrics.json``, the frozen tau bit-equal to the
    parent's sun-val tau, the clean rows' probabilities within PT_PROB_ATOL
    of the parent's test exports frame by frame, exact launch counts."""
    import hmac

    from ssl4polyp_tpu_torch.polypdb import cli as polypdb_cli
    from ssl4polyp_tpu_torch.polypdb.builders import PERTURBATION_GRID
    from ssl4polyp_tpu_torch.polypdb.synth import build_synthetic_sun_root
    from ssl4polyp_tpu_torch.training import classification as engine

    cfg = ViTConfig(num_classes=2)
    depth = cfg.depth
    per_step = {"fused_qkv_attention": depth, "fused_qkv_attention_backward": depth,
                "layernorm": 2 * depth + 1, "layernorm_backward": 2 * depth + 1,
                "fc1_gelu": depth, "adamw": 3}
    per_eval = {"fused_qkv_attention": depth, "layernorm": 2 * depth + 1, "fc1_gelu": depth}
    split_batches = -(-PT_SPLIT_FRAMES // BATCH)
    grid_batches = -(-PT_GRID_ROWS // BATCH)
    total: dict[str, int] = {}
    phase_start = time.perf_counter()

    def add(counts: dict[str, int]) -> None:
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

    def polypdb(argv: list[str]) -> tuple[str, float]:
        printed = io.StringIO()
        start = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            polypdb_cli.main(argv)
        return printed.getvalue().strip(), time.perf_counter() - start

    with tempfile.TemporaryDirectory() as tmp, projection_fold(False):
        tmp = Path(tmp)
        start = time.perf_counter()
        root = build_synthetic_sun_root(
            tmp / "sun_root", pos_cases=PT_POS_CASES, frames_per_case=PT_FRAMES_PER_CASE,
            neg_sources=PT_NEG_SOURCES, frames_per_source=PT_FRAMES_PER_SOURCE,
            image_size=PT_IMAGE, seed=SEED)
        root_s = time.perf_counter() - start
        n_frames = len(list(root.rglob("*.jpg")))
        packs = tmp / "data_packs"
        full, grid = packs / "sun_full", packs / "sun_test_perturbations"
        said, build_s = polypdb(["sun", "build", "--root", str(root), "--out", str(full),
                                 "--frames-per-case", str(PT_FRAMES_PER_CASE),
                                 "--cases-per-split", *map(str, PT_CASES_PER_SPLIT)])
        said_grid, grid_s = polypdb(["sun", "perturbations", "--pack", str(full), "--out",
                                     str(grid)])
        if said != f"wrote pack to {full}" or said_grid != f"wrote perturbation grid to {grid}":
            fail(f"polypdb printed {said!r}, {said_grid!r}")

        # Each manifest's rows, counts, assertions and hashes.
        start = time.perf_counter()
        digests = {(pack, split): hashlib.sha256((pack / f"{split}.csv").read_bytes()).hexdigest()
                   for pack, split in [(full, s) for s in ("train", "val", "test")]
                   + [(grid, "test")]}
        hash_s = time.perf_counter() - start
        import yaml

        manifest = yaml.safe_load((full / "manifest.yaml").read_text())
        grid_manifest = yaml.safe_load((grid / "manifest.yaml").read_text())
        full_rows = {s: _csv_rows(full / f"{s}.csv") for s in ("train", "val", "test")}
        grid_rows = _csv_rows(grid / "test.csv")
        problems = []
        for split, cases in zip(full_rows, PT_CASES_PER_SPLIT):
            rows = full_rows[split]
            want = {"pos_cases": cases, "neg_cases": cases,
                    "frames": 2 * cases * PT_FRAMES_PER_CASE}
            if (len(rows) != want["frames"] or manifest["hashes"][split] != digests[full, split]
                    or manifest["counts"][split]["frames"] != want["frames"]
                    or manifest["assertions"]["split_targets_met"][split] != want):
                problems.append(f"sun_full {split}: {len(rows)} rows, {manifest['counts'][split]}")
        if manifest["assertions"].get(f"all_cases_have_{PT_FRAMES_PER_CASE}_frames") is not True:
            problems.append(f"sun_full: case lengths {manifest['case_lengths']}")
        ids = [str(spec["id"]) for spec in PERTURBATION_GRID]
        seeds_wrong = sum(
            row["render_in_pipeline"] != "True" or int(row["rng_seed"]) != int.from_bytes(
                hmac.new(b"47", f"{row['orig_frame_id']}:{row['perturbation_id']}".encode(),
                         hashlib.sha256).digest()[:4], "big")
            for row in grid_rows)
        if (len(grid_rows) != PT_GRID_ROWS or grid_manifest["hashes"]["test"] != digests[grid, "test"]
                or grid_manifest["assertions"] != {"rows": PT_GRID_ROWS, "rows_per_clean_frame": 16,
                                                   "clean_frames": PT_SPLIT_FRAMES}
                or [row["perturbation_id"] for row in grid_rows[:16]] != ids or seeds_wrong):
            problems.append(f"sun_test_perturbations: {len(grid_rows)} rows, assertions "
                            f"{grid_manifest['assertions']}, {seeds_wrong} rows off the seed rule")
        if problems:
            fail(f"pack tools: {problems}")
        print(f"pack tools: a SUN root of {n_frames} JPEG frames of {PT_IMAGE} px ({PT_POS_CASES} "
              f"cases of {PT_FRAMES_PER_CASE}, {PT_NEG_SOURCES} negative videos of "
              f"{PT_FRAMES_PER_SOURCE}) written in {root_s:.2f} s; `polypdb sun build "
              f"--cases-per-split {' '.join(map(str, PT_CASES_PER_SPLIT))}` {build_s:.2f} s "
              f"({' / '.join(str(len(r)) for r in full_rows.values())} rows); `polypdb sun "
              f"perturbations` {grid_s:.2f} s ({len(grid_rows)} rows, every seed the HMAC rule's); "
              f"the 4 CSVs hashed against their manifests in {hash_s:.3f} s; {CARD}")
        print(f"pack tools: cuts from the study's SUN: train {PT_CASES_PER_SPLIT[0]} cases a "
              f"side where SUN has 70 (val and test keep its 15); frames {PT_IMAGE} px where "
              "SUN's are 1240x1080")

        # The parent: exp1's sup_imnet arm from an AugReg .npz, on the built pack.
        weights = tmp / "checkpoint_root"
        model = config_model("sup_imnet")
        write_augreg_npz(weights / model["checkpoint"], cfg, np.random.default_rng(SEED + 2))
        classification = tmp / "classification"
        ops.reset_launch_counts()
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            parent = engine.cli_main([
                "--exp-config", "config/exp/exp1.yaml", "--model-key", "sup_imnet",
                "--seed", "13", "--pack-root", str(packs), "--checkpoint-root", str(weights),
                "--thresholds-root", str(tmp / "thresholds"),
                "--output-dir", str(classification / "exp1_sup_imnet_seed13"),
                "--device", "cuda", "--override", "epochs=1", "--override", f"batch_size={BATCH}",
                "--limit-train-batches", str(PT_TRAIN_STEPS)])
        torch.cuda.synchronize()
        parent_wall = time.perf_counter() - start
        counts = ops.launch_counts()
        add(counts)
        check_counts(counts, {name: PT_TRAIN_STEPS * per_step.get(name, 0)
                              + 2 * split_batches * per_eval.get(name, 0) for name in counts}, 1,
                     f"the exp1 parent: {PT_TRAIN_STEPS} steps, {split_batches} val and "
                     f"{split_batches} test batches")
        parent_dir = Path(parent["metrics_path"]).parent
        parent_payload = parent["payload"]
        if parent["epochs_run"] != 1 or not 0.0 <= parent["tau"] <= 1.0:
            fail(f"exp1 parent: {parent['epochs_run']} epochs, tau {parent['tau']}")
        print(f"exp1 sup_imnet parent (ViT-B/16, batch {BATCH}, {PT_TRAIN_STEPS} steps, "
              f"{PT_SPLIT_FRAMES} val and test frames): sun-val tau {parent['tau']!r}, test AUROC "
              f"{parent_payload['test_primary']['auroc']:.4f}; {parent_wall:.1f} s wall (build "
              f"{parent['timings']['build_s']:.2f} s, test {parent['timings']['test_s']:.2f} s); "
              f"{CARD}")

        # exp5b: the same arm and seed, the canonical parent found under
        # <tmp>/classification, all 15,840 rows on the card.
        ops.reset_launch_counts()
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = engine.cli_main([
                "--exp-config", "config/exp/exp5b.yaml", "--model-key", "sup_imnet",
                "--seed", "13", "--pack-root", str(packs),
                "--thresholds-root", str(tmp / "thresholds"),
                "--output-dir", str(classification / "exp5b"), "--device", "cuda",
                "--override", f"batch_size={BATCH}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = ops.launch_counts()
        add(counts)
        check_counts(counts, per_eval, grid_batches,
                     f"exp5b: {grid_batches} eval batches of the {PT_GRID_ROWS} rows")
        payload = json.loads(Path(summary["metrics_path"]).read_text())
        parent_ckpt = payload.get("provenance", {}).get("parent_run", {}).get("checkpoint", "")
        per_tag = payload.get("test_perturbations", {}).get("per_tag", {})
        tau = payload["thresholds"]["primary"]["tau"]
        if Path(parent_ckpt).name != f"{parent['stem']}.ckpt":
            fail(f"exp5b: the parent run is {parent_ckpt!r}, not the exp1 run's checkpoint")
        if set(per_tag) != set(ids) | {"ALL-perturbed"}:
            fail(f"exp5b: per_tag holds {sorted(per_tag)}")
        if payload.get("eval_only") is not True or tau != parent["tau"] or (
                payload["thresholds"]["primary"]["policy"] != "sun_val_frozen"):
            fail(f"exp5b: eval_only {payload.get('eval_only')}, tau {tau!r} against the "
                 f"parent's sun-val {parent['tau']!r}, policy "
                 f"{payload['thresholds']['primary']['policy']}")
        if sum(block["count"] for tag, block in per_tag.items() if tag != "ALL-perturbed") \
                != PT_GRID_ROWS:
            fail(f"exp5b: per_tag counts {[(t, b['count']) for t, b in per_tag.items()]}")
        theirs = {row["frame_id"]: float(row["prob"]) for row in
                  _csv_rows(parent_dir / f"{parent['stem']}_test_outputs.csv")}
        ours = [row for row in _csv_rows(Path(summary["metrics_path"]).parent
                                         / f"{summary['stem']}_test_outputs.csv")
                if row["perturbation_tag"] == "clean"]
        if len(ours) != PT_SPLIT_FRAMES or set(r["frame_id"] for r in ours) != set(theirs):
            fail(f"exp5b: {len(ours)} clean rows against the parent's {len(theirs)} test frames")
        diffs = [abs(float(row["prob"]) - theirs[row["frame_id"]]) for row in ours]
        off = sum(d > PT_PROB_ATOL for d in diffs)
        if off:
            fail(f"exp5b: {off} clean frames' probabilities off the parent's test exports by more "
                 f"than {PT_PROB_ATOL} (max {max(diffs):.3e})")
        test_s = summary["timings"]["test_s"]
        print(f"exp5b sup_imnet (ViT-B/16, batch {BATCH}, {PT_GRID_ROWS} rows, perturbations "
              f"rendered in the loader's 8 threads): the canonical parent "
              f"{Path(parent_ckpt).name}, tau {tau!r} bit-equal to its sun-val tau; "
              f"{len(per_tag)} per_tag blocks (ALL-perturbed AUROC "
              f"{per_tag['ALL-perturbed']['auroc']:.4f}, clean {per_tag['clean']['auroc']:.4f}); "
              f"the {len(ours)} clean rows' probabilities against the parent's test exports: max "
              f"|diff| {max(diffs):.3e} ({sum(d == 0.0 for d in diffs)} bit-equal; atol "
              f"{PT_PROB_ATOL}); test evaluation {test_s:.2f} s, {PT_GRID_ROWS / test_s:.1f} rows/s "
              f"(host clock); the run {wall:.2f} s wall, {PT_GRID_ROWS / wall:.1f} rows/s over it "
              f"(build {summary['timings']['build_s']:.2f} s); {CARD}")
        # The loader alone (no forward), as the engine builds it: the first
        # PT_LOADER_BATCHES batches of the grid (perturbations rendered) and
        # of sun_full's test (decode only), host clock.
        loader_rates = {}
        for what, spec, splits in (("grid", "sun_test_perturbations", ["test"]),
                                   ("clean", "sun_full", [])):
            index = create_classification_datasets(test_spec=spec, pack_root=packs,
                                                   perturbation_splits=splits,
                                                   image_size=PT_IMAGE)["test"]
            loader = HostDataLoader(index, batch_size=BATCH, shuffle=False, num_workers=8,
                                    drop_last=False)
            start = time.perf_counter()
            rows = 0
            for i, batch in zip(range(PT_LOADER_BATCHES), loader):
                rows += int(batch["valid"].sum())
            loader_rates[what] = (rows, time.perf_counter() - start)
        print(f"the loader alone (8 threads, batch {BATCH}, no forward; host clock): " + "; ".join(
            f"{what} {rows} rows in {secs:.2f} s, {rows / secs:.1f} rows/s"
            for what, (rows, secs) in loader_rates.items()) + f"; {CARD}")
    print(f"pack tools phase: {time.perf_counter() - phase_start:.1f} s; {CARD}")
    return total


SWEEP_ARMS = ("sup_imnet", "ssl_imnet")
SWEEP_SEEDS = (13, 29, 47)  # the study's seed trio (config/base.yaml)
SWEEP_STEMS = [f"{tag}_SUNFull_s{seed}" for tag in ("SupImnet", "SslImnet")
               for seed in SWEEP_SEEDS]
SWEEP_SUBDIR = "exp1_sun_baselines_sup_vs_ssl"  # config/exp/exp1.yaml's reporting.inputs_subdir
SWEEP_TIMEOUT_S = 600
# Batches of 64 a run, one epoch: fewer than phase 9's, since a sweep run's
# wall is mostly its process start, its model build and its saves.
SWEEP_LIMIT = {"train": 2, "val": 1, "test": 1}


def phase_study_sweep(packs: Path, weights: Path) -> dict[str, int]:
    """exp1's seed-trio sweep and report through the port's own scripts, as
    a user runs them, at full width (ViT-B/16, 224 px, batch 64) on the
    engine pack at ``packs``: the AugReg ``.npz`` and the MAE ``.pth``
    written from numpy seeds where ``config/model/{sup_imnet,ssl_imnet}.yaml``
    name them under ``weights`` (the ``--checkpoint-root``, which phase 13
    reads again); ``bash
    scripts/torch/run_exp1.sh`` in a subprocess (six runs of the fine-tune
    CLI, then the reporting inputs staged); ``python -m
    ssl4polyp_tpu_torch.analysis.exp_reports exp1`` on the staged tree, seed
    check on.  The launch counter cannot see a subprocess, so one run
    (sup_imnet, seed 13) is repeated in this process through ``cli_main``
    under torch's own backend settings, as a fresh process has them: its
    launches exactly the step's and the eval forward's, and its test outputs
    byte-equal to the sweep's run of the same stem."""
    from ssl4polyp_tpu_torch.models.mae import MAE_VIT_B16
    from ssl4polyp_tpu_torch.training import classification as engine

    cfg = ViTConfig(num_classes=2)
    depth = cfg.depth
    per_step = {"fused_qkv_attention": depth, "fused_qkv_attention_backward": depth,
                "layernorm": 2 * depth + 1, "layernorm_backward": 2 * depth + 1,
                "fc1_gelu": depth, "adamw": 3}
    per_eval = {"fused_qkv_attention": depth, "layernorm": 2 * depth + 1, "fc1_gelu": depth}
    repo = Path(__file__).resolve().parent
    phase_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, projection_fold(False):
        tmp = Path(tmp)
        start = time.perf_counter()
        write_augreg_npz(weights / config_model("sup_imnet")["checkpoint"], cfg,
                         np.random.default_rng(SEED + 1))
        write_mae_pth(weights / config_model("ssl_imnet")["checkpoint"], MAE_VIT_B16,
                      np.random.default_rng(SEED))
        weights_s = time.perf_counter() - start
        # A user's shell: ``python`` is this interpreter, the checkout importable.
        bin_dir = tmp / "bin"
        bin_dir.mkdir()
        (bin_dir / "python").write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        (bin_dir / "python").chmod(0o755)
        env = {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}",
               "PYTHONPATH": os.pathsep.join(filter(None, [str(repo),
                                                            os.environ.get("PYTHONPATH")])),
               "OUTPUT_DIR": str(tmp / "out"), "RESULTS_DIR": str(tmp / "results")}
        run_args = ["--pack-root", str(packs), "--checkpoint-root", str(weights),
                    "--override", "epochs=1", "--override", f"batch_size={BATCH}",
                    "--limit-train-batches", str(SWEEP_LIMIT["train"]),
                    "--limit-val-batches", str(SWEEP_LIMIT["val"]),
                    "--limit-test-batches", str(SWEEP_LIMIT["test"])]

        # The sweep, its stdout read line by line: a run's wall is from the
        # script's "=== ... ===" line to the run's summary line, which the
        # CLI prints last and flushes as its process ends.
        start = time.perf_counter()
        marks: list[tuple[str, float]] = []
        with open(tmp / "sweep.err", "w") as err:
            sweep = subprocess.Popen(
                ["bash", "scripts/torch/run_exp1.sh", *run_args,
                 "--thresholds-root", str(tmp / "thresholds")],
                cwd=repo, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
            for line in sweep.stdout:
                marks.append((line.rstrip("\n"), time.perf_counter()))
            try:
                rc = sweep.wait(timeout=SWEEP_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                sweep.kill()
                sweep.wait()
                rc = "killed at its time limit"
        sweep_s = time.perf_counter() - start
        if rc != 0:
            fail(f"scripts/torch/run_exp1.sh: exit {rc}; its errors end with:\n"
                 + (tmp / "sweep.err").read_text()[-4000:])
        lines = [line for line, _ in marks]
        heads = [i for i, line in enumerate(lines) if line.startswith("=== ")]
        want_heads = [f"=== exp/exp1 model={arm} seed={seed} ===" for arm in SWEEP_ARMS
                      for seed in SWEEP_SEEDS]
        if [lines[i] for i in heads] != want_heads:
            fail(f"the sweep ran {[lines[i] for i in heads]}, not {want_heads}")
        runs = []
        for head in heads:
            at = next((i for i in range(head + 1, len(lines)) if lines[i].startswith("{")), None)
            if at is None:
                fail(f"no summary line after {lines[head]!r}")
            runs.append((json.loads(lines[at]), marks[at][1] - marks[head][1], marks[at][1]))
        if [summary["stem"] for summary, _, _ in runs] != SWEEP_STEMS or any(
                summary["epochs_run"] != 1 or not 0.0 <= summary["tau"] <= 1.0
                for summary, _, _ in runs):
            fail("the sweep's summaries: "
                 f"{[(s['stem'], s['epochs_run'], s['tau']) for s, _, _ in runs]}")
        staged_line = f"staged 24 files into reporting_inputs/{SWEEP_SUBDIR}"
        if lines[-1] != staged_line:
            fail(f"the sweep ended with {lines[-1]!r}, not {staged_line!r}")
        stage_s = marks[-1][1] - runs[-1][2]
        staged = tmp / "results" / "reporting_inputs" / SWEEP_SUBDIR
        want = sorted(stem + suffix for stem in SWEEP_STEMS for suffix in (
            "_last.metrics.json", "_test_outputs.csv", "_test_roc_curve.csv",
            "_test_pr_curve.csv"))
        got = sorted(p.name for p in staged.rglob("*") if p.is_file())
        if got != want:
            fail(f"reporting inputs: {got}, not {want}")
        for summary, wall, _ in runs:
            clock = summary["timings"]
            parts = {"build": clock["build_s"], "train": clock["train_s"],
                     "val and test": clock["val_s"] + clock["test_s"],
                     "saves": sum(snapshot + write for _, snapshot, write in clock["saves"]),
                     "reload and exports": clock["reload_s"] + clock["export_s"]}
            print(f"sweep run {summary['stem']} (ViT-B/16, batch {BATCH}, "
                  f"{SWEEP_LIMIT['train']} steps, {SWEEP_LIMIT['val']} val and "
                  f"{SWEEP_LIMIT['test']} test batches): {wall:.1f} s wall, of it "
                  + ", ".join(f"{k} {v:.2f} s" for k, v in parts.items())
                  + f", the rest (process start and end, imports) {wall - sum(parts.values()):.2f} "
                  f"s; test AUROC {summary['test_auroc']:.4f}, tau {summary['tau']!r}; {CARD}")

        # The report, seed check on, as a user runs it.
        report_dir = tmp / "report"
        start = time.perf_counter()
        report = subprocess.run(
            ["python", "-m", "ssl4polyp_tpu_torch.analysis.exp_reports", "exp1", "--runs-root",
             str(staged), "--output-dir", str(report_dir)],
            cwd=repo, env=env, capture_output=True, text=True, timeout=SWEEP_TIMEOUT_S)
        report_s = time.perf_counter() - start
        if report.returncode != 0:
            fail(f"exp_reports exp1: exit {report.returncode}; {report.stderr[-4000:]}")
        written = sorted(p.name for p in report_dir.iterdir())
        if written != ["exp1_manifest.json", "exp1_metrics.csv", "exp1_report.md"]:
            fail(f"exp_reports exp1 wrote {written}")
        manifest = json.loads((report_dir / "exp1_manifest.json").read_text())
        deltas = manifest.get("deltas", {}).get("sup_imnet->ssl_imnet", {})
        if manifest["n_runs"] != 6 or not {"auroc", "f1"} <= set(deltas):
            fail(f"exp1 report: {manifest['n_runs']} runs, deltas {manifest.get('deltas')}")
        auroc = deltas["auroc"]
        print(f"exp1 report (seed check on, {auroc['n_samples']} bootstrap draws): 6 runs, "
              f"sup_imnet->ssl_imnet AUROC delta {auroc['mean']:+.4f} [{auroc['ci_lower']:+.4f}, "
              f"{auroc['ci_upper']:+.4f}], F1 delta {deltas['f1']['mean']:+.4f}; "
              f"{report_s:.2f} s, process start included; {CARD}")

        # One run again, in this process, where the launch counts are seen.
        repeat = tmp / "repeat"
        ops.reset_launch_counts()
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), torch_defaults():
            summary = engine.cli_main([
                "--exp-config", "exp/exp1", "--model-key", "sup_imnet", "--seed", "13",
                "--output-dir", str(repeat), *run_args,
                "--thresholds-root", str(tmp / "thresholds_repeat")])
        torch.cuda.synchronize()
        repeat_s = time.perf_counter() - start
        counts = ops.launch_counts()
        evals = SWEEP_LIMIT["val"] + SWEEP_LIMIT["test"]
        check_counts(counts, {name: SWEEP_LIMIT["train"] * per_step.get(name, 0)
                              + evals * per_eval.get(name, 0) for name in counts}, 1,
                     f"the in-process repeat of {SWEEP_STEMS[0]}: {SWEEP_LIMIT['train']} steps and "
                     f"{evals} eval batches")
        name = f"{SWEEP_STEMS[0]}_test_outputs.csv"
        ours = (Path(summary["metrics_path"]).parent / name).read_bytes()
        theirs = next((tmp / "out").rglob(name)).read_bytes()
        if ours != theirs:
            fail(f"{name}: the in-process repeat's {len(ours)} bytes differ from the sweep's "
                 f"{len(theirs)} (a determinism fault between processes)")
    print(f"study sweep: exp1's 2 arms x seeds {list(SWEEP_SEEDS)} through "
          f"scripts/torch/run_exp1.sh in {sweep_s:.1f} s (the six runs "
          f"{sum(wall for _, wall, _ in runs):.1f} s, staging {stage_s:.2f} s, process start "
          f"included); the report {report_s:.2f} s; the weight files written in "
          f"{weights_s:.1f} s; the in-process repeat of {SWEEP_STEMS[0]} {repeat_s:.1f} s, its "
          f"launches exact and its {len(ours)}-byte test outputs byte-equal to the sweep's; the "
          f"phase {time.perf_counter() - phase_start:.1f} s; {CARD}")
    return counts


# Phase 13: two ranks of the fine-tune engine on the card's one device.
DP_RANKS = 2
DP_LIMIT = {"train": 4, "val": 1, "test": 2}  # batches of 32 a rank, one epoch
DP_RANK_BATCH = BATCH // DP_RANKS
DP_TIMEOUT_S = 300
# Step 1 of two ranks against one process on the gathered global batch,
# both through the kernels.  Each row's forward is the same arithmetic at 32
# rows a rank as at 64 in one batch, so the loss differs by the order of its
# sums alone, unless a library product picks another algorithm at the other
# row count (one bf16 ulp of a logit, as in phase 5's readings); the matrix
# gradients are each rank's bf16 rounding of its partial sum, summed in
# fp32, against one rounding of the whole sum: within a bf16 ulp (2^-8
# relative) an element.  The K slice of each qkv bias is left out, as in
# ``check_step_one``.
DP_LOSS_RTOL = 5e-3
DP_GRAD_RTOL = 1.5e-2
DP_PROB_ATOL = 1e-6  # the gathered test outputs against the one-process eval CLI


def watch_writes(roots) -> list[str]:
    """Record, from here on in this process, every write under ``roots``
    (an open for writing, a rename, a removal, a link, a new directory, a
    copy) through the interpreter's audit hooks; returns the list the hook
    fills."""
    roots = [os.path.realpath(root) for root in roots]
    seen: list[str] = []
    write_flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND | os.O_TRUNC

    def under(path) -> bool:
        if not isinstance(path, (str, bytes, os.PathLike)):
            return False
        real = os.path.realpath(os.fsdecode(path))
        return any(real == root or real.startswith(root + os.sep) for root in roots)

    def hook(event: str, args: tuple) -> None:
        if event == "open":
            path, mode, flags = args
            writes = (any(c in mode for c in "wax+") if isinstance(mode, str)
                      else isinstance(flags, int) and bool(flags & write_flags))
            if writes and under(path):
                seen.append(f"{event} {path}")
        elif event in ("os.rename", "os.symlink", "os.link", "shutil.copyfile"):
            if under(args[1]):
                seen.append(f"{event} {args[1]}")
        elif event in ("os.remove", "os.rmdir", "os.mkdir", "os.truncate"):
            if under(args[0]):
                seen.append(f"{event} {args[0]}")

    sys.addaudithook(hook)
    return seen


class StepCapture:
    """The fine-tune engine's steps on this rank, through its module's
    ``make_train_step`` and ``cross_replica_sum`` (patched while the
    context is open): each step's seconds and its all-reduces' seconds,
    between synchronisations of ``device``; and for the first ``steps``
    steps what one process needs to recompute them (this rank's batch and
    augmentation draws, the masters before the step) and what they gave
    (the all-reduced loss and gradients)."""

    def __init__(self, engine, steps: int, device: torch.device) -> None:
        self.engine, self.steps, self.device = engine, steps, device
        self.records: list[dict] = []
        self.step_s: list[float] = []
        self.reduce_s: list[float] = []
        self.ctx = None
        self._current = None
        self._patches = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self) -> "StepCapture":
        make_step, reduce = self.engine.make_train_step, self.engine.cross_replica_sum

        def timed_reduce(tensors):
            tensors = list(tensors)
            self._sync()
            start = time.perf_counter()
            reduce(tensors)
            self._sync()
            self.reduce_s[-1] += time.perf_counter() - start
            if self._current is not None and len(tensors) > 1:  # the loss, then the gradients
                self._current["loss"] = tensors[0].clone()
                self._current["grads"] = dict(zip(self._current["masters"],
                                                  (t.clone() for t in tensors[1:])))

        def capturing_make_step(ctx):
            step = make_step(ctx)
            self.ctx = ctx

            def captured(state, images, labels, valid, *rest):
                self._current = None
                if len(self.records) < self.steps:
                    replay = torch.Generator(device=state.generator.device)
                    replay.set_state(state.generator.get_state())
                    draws = draw_augment_params(images.shape[0], replay)
                    self._current = {
                        "batch": {"images": images.cpu().numpy(), "labels": labels.cpu().numpy(),
                                  "valid": valid.cpu().numpy(),
                                  **{f"draw_{k}": v.cpu().numpy()
                                     for k, v in draws._asdict().items()}},
                        "masters": {n: t.clone() for n, t in state.params.items()},
                        "model": state.model}
                    self.records.append(self._current)
                self.reduce_s.append(0.0)
                self._sync()
                start = time.perf_counter()
                out = step(state, images, labels, valid, *rest)
                self._sync()
                self.step_s.append(time.perf_counter() - start)
                self._current = None
                return out
            return captured

        self._patches = [mock.patch.object(self.engine, "make_train_step", capturing_make_step),
                         mock.patch.object(self.engine, "cross_replica_sum", timed_reduce)]
        for patch in self._patches:
            patch.start()
        return self

    def __exit__(self, *exc) -> None:
        for patch in self._patches:
            patch.stop()

    def gathered_errors(self) -> list[dict] | None:
        """Every rank's captured batches gathered to rank 0, which recomputes
        each captured step in one process on the global batch (rank 0's rows,
        then rank 1's, ...; ``loss_and_grads`` normalising by the global
        batch's own count) from the masters before it.  Rank 0 returns, a
        step, the loss's relative difference and each gradient's relative
        L2 distance to the all-reduced ones (the K slice of each qkv bias
        left out); the other ranks None.  A collective: every rank calls it."""
        import torch.distributed as dist

        from ssl4polyp_tpu_torch.data.augment import AugmentParams
        from ssl4polyp_tpu_torch.models.layers import compute_copy

        parts: list = [None] * dist.get_world_size()
        dist.all_gather_object(parts, [record["batch"] for record in self.records])
        if dist.get_rank() != 0:
            return None
        ctx, device = self.ctx, self.ctx.device
        errors = []
        for k, record in enumerate(self.records):
            batch = {key: torch.from_numpy(np.concatenate([part[k][key] for part in parts]))
                     .to(device) for key in record["batch"]}
            draws = AugmentParams(**{key[len("draw_"):]: value for key, value in batch.items()
                                     if key.startswith("draw_")})
            masters = record["masters"]
            state = self.engine.TrainState(
                model=record["model"], params=masters,
                params_c=compute_copy(masters, ctx.classifier.cfg.compute_dtype), opt=None,
                generator=None)
            loss, grads = self.engine.loss_and_grads(ctx, state, batch["images"], batch["labels"],
                                                     batch["valid"], draws)
            worst = (0.0, "")
            for name, want in grads.items():
                got = record["grads"][name]
                if name.endswith("attn.qkv.bias"):
                    d = got.shape[0] // 3
                    got, want = (torch.cat([t[:d], t[2 * d:]]) for t in (got, want))
                worst = max(worst, (((got - want).norm() / want.norm().clamp_min(1e-30)).item(),
                                    name))
            errors.append({"rows": int(batch["valid"].numel()),
                           "loss": record["loss"].item(), "one_process_loss": loss.item(),
                           "loss_rel": abs(record["loss"].item() - loss.item()) / abs(loss.item()),
                           "grad_rel": worst[0], "grad_worst": worst[1], "grads": len(grads)})
        return errors


def rank_worker(spec_path: str) -> None:
    """One rank of phase 13, as ``torchrun`` starts it: the fine-tune CLI
    (``cli_main``) with the phase's arguments, this rank's launches counted
    from 0, the first step captured and timed (``StepCapture``), and on
    ranks past 0 every write under the run's directories recorded
    (``watch_writes``).  Writes ``rank<r>.json`` beside the spec."""
    import torch.distributed as dist

    from ssl4polyp_tpu_torch.training import classification as engine

    spec = json.loads(Path(spec_path).read_text())
    rank = int(os.environ["RANK"])
    writes = watch_writes(spec["roots"]) if rank else []
    ops.reset_launch_counts()
    start = time.perf_counter()
    with StepCapture(engine, 1, torch.device("cuda")) as capture, \
            contextlib.redirect_stdout(io.StringIO()):
        summary = engine.cli_main(spec["argv"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = ops.launch_counts()  # before rank 0's recompute launches more
    errors = capture.gathered_errors()
    report = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend(),
              "device": str(capture.ctx.device), "counts": counts, "tau": summary["tau"],
              "epochs_run": summary["epochs_run"], "best_monitor": summary["best_monitor"],
              "stem": summary["stem"], "metrics_path": summary["metrics_path"],
              "timings": summary["timings"], "wall": wall, "step_s": capture.step_s,
              "reduce_s": capture.reduce_s, "writes": list(writes), "step_errors": errors}
    (Path(spec_path).parent / f"rank{rank}.json").write_text(json.dumps(report, default=str))
    dist.destroy_process_group()


def phase_data_parallel(packs: Path, weights: Path) -> dict[str, int]:
    """Two ranks of the fine-tune engine on the card's one device under
    gloo: ``python -m torch.distributed.run --nproc-per-node 2`` runs this
    script's rank worker over ``config/exp/exp1.yaml``'s ``sup_imnet`` arm
    at full width (the AugReg ``.npz`` under ``weights``, phase 8's pack):
    one epoch of 4 steps at a global batch of 64, 1 val and 2 test batches
    of 32 a rank.  Each rank's launches exact, step 1's all-reduced loss and
    gradients against one process on the gathered batch, rank 1 silent, tau
    equal on both ranks, and the gathered test outputs in the frame order of
    the one-process eval CLI on the saved checkpoint, within
    ``DP_PROB_ATOL``.  Then one step under a one-rank nccl group, bit-equal
    to the same step without a group.  Returns both ranks' launches."""
    from ssl4polyp_tpu_torch.metrics.performance import as_binary_scores
    from ssl4polyp_tpu_torch.parallel.multihost import BACKEND_ENV

    cfg = ViTConfig(num_classes=2)
    depth = cfg.depth
    per_step = {"fused_qkv_attention": depth, "fused_qkv_attention_backward": depth,
                "layernorm": 2 * depth + 1, "layernorm_backward": 2 * depth + 1,
                "fc1_gelu": depth, "adamw": 3}
    per_eval = {"fused_qkv_attention": depth, "layernorm": 2 * depth + 1, "fc1_gelu": depth}
    evals = DP_LIMIT["val"] + DP_LIMIT["test"]
    repo = Path(__file__).resolve().parent
    phase_start = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks' processes share the card with this one
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        run_dir, thresholds = tmp / "run", tmp / "thresholds"
        spec = tmp / "spec.json"
        spec.write_text(json.dumps({"roots": [str(run_dir), str(thresholds)], "argv": [
            "--exp-config", "exp/exp1", "--model-key", "sup_imnet", "--seed", "13",
            "--pack-root", str(packs), "--checkpoint-root", str(weights),
            "--output-dir", str(run_dir), "--thresholds-root", str(thresholds),
            "--override", "epochs=1", "--override", f"batch_size={BATCH}",
            "--limit-train-batches", str(DP_LIMIT["train"]),
            "--limit-val-batches", str(DP_LIMIT["val"]),
            "--limit-test-batches", str(DP_LIMIT["test"])]}))
        env = {key: value for key, value in os.environ.items() if key != "BENCH_ATTN_PROJ"}
        env.update({BACKEND_ENV: "gloo", "PYTHONPATH": os.pathsep.join(
            filter(None, [str(repo), os.environ.get("PYTHONPATH")]))})
        start = time.perf_counter()
        with open(tmp / "ranks.log", "w") as log:
            ranks = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(DP_RANKS), str(repo / "chip_smoke.py"),
                 "--rank-worker", str(spec)],
                cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT, timeout=DP_TIMEOUT_S)
        wall = time.perf_counter() - start
        if ranks.returncode != 0:
            fail(f"two ranks of the fine-tune engine: exit {ranks.returncode}; the log ends "
                 f"with:\n{(tmp / 'ranks.log').read_text()[-6000:]}")
        reports = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(DP_RANKS)]
        for report in reports:
            if (report["world"], report["backend"], report["device"]) != (DP_RANKS, "gloo",
                                                                            "cuda:0"):
                fail(f"rank {report['rank']}: world {report['world']}, backend "
                     f"{report['backend']}, device {report['device']}")
            check_counts(report["counts"], {name: DP_LIMIT["train"] * per_step.get(name, 0)
                                            + evals * per_eval.get(name, 0)
                                            for name in report["counts"]}, 1,
                         f"rank {report['rank']} of {DP_RANKS}: {DP_LIMIT['train']} steps and "
                         f"{evals} eval batches of {DP_RANK_BATCH}")
        if reports[1]["writes"]:
            fail(f"rank 1 wrote {reports[1]['writes'][:10]}")
        taus = [report["tau"] for report in reports]
        if taus[0] is None or len(set(taus)) != 1 or len(
                {(r["epochs_run"], r["best_monitor"]) for r in reports}) != 1:
            fail(f"the ranks disagree: tau {taus}, epochs and best "
                 f"{[(r['epochs_run'], r['best_monitor']) for r in reports]}")
        (error,) = reports[0]["step_errors"]
        print(f"two ranks, step 1 against one process on the gathered {error['rows']} rows: loss "
              f"{error['loss']:.6f} all-reduced, {error['one_process_loss']:.6f} in one process "
              f"(relative diff {error['loss_rel']:.3e}, limit {DP_LOSS_RTOL}); gradients of "
              f"{error['grads']} parameters: worst relative L2 distance {error['grad_rel']:.3e} "
              f"({error['grad_worst']}), limit {DP_GRAD_RTOL}")
        if not error["loss_rel"] <= DP_LOSS_RTOL or not error["grad_rel"] <= DP_GRAD_RTOL:
            fail("two ranks: step 1 disagrees with one process on the gathered batch")

        # The gathered test outputs against the one-process eval CLI on the
        # checkpoint rank 0 saved, at the ranks' batch of 32.
        stem = reports[0]["stem"]
        with contextlib.redirect_stdout(io.StringIO()):
            eval_classification.cli_main([
                "--checkpoint", str(Path(reports[0]["metrics_path"]).parent / f"{stem}.ckpt"),
                "--test-pack", "sun_full", "--pack-root", str(packs),
                "--batch-size", str(DP_RANK_BATCH), "--output-dir", str(tmp / "eval"),
                "--export-outputs"])
        rows = _csv_rows(Path(reports[0]["metrics_path"]).parent / f"{stem}_test_outputs.csv")
        frames = [json.loads(line)["frame_id"]
                  for line in (tmp / "eval" / "metadata.jsonl").read_text().splitlines()]
        probs = as_binary_scores(np.load(tmp / "eval" / "logits.npz")["logits"])
        if [row["frame_id"] for row in rows] != frames:
            fail("two ranks: the gathered test outputs are not in the one-process frame order")
        prob_err = float(np.abs(np.array([float(row["prob"]) for row in rows]) - probs).max())
        if not prob_err <= DP_PROB_ATOL:
            fail(f"two ranks: test probabilities {prob_err:.3e} from the one-process eval CLI's")
        step_s = [sum(r["step_s"]) for r in reports]
        rates = ", ".join(f"{len(r['step_s']) / t:.3f}" for r, t in zip(reports, step_s))
        shares = ", ".join(f"{sum(r['reduce_s']) / t:.3f}" for r, t in zip(reports, step_s))
        print(f"two ranks of the fine-tune engine on one card under gloo (exp1 sup_imnet, "
              f"ViT-B/16, global batch {BATCH}, {DP_LIMIT['train']} steps, {evals} eval batches "
              f"a rank): {wall:.1f} s wall (process start, build and kernels' load included); "
              f"steps/s a rank {rates} (each step between two synchronisations); the "
              f"all-reduce's share of a step {shares}; {len(rows)} test frames in the "
              f"one-process order, probabilities within {prob_err:.1e}; tau {taus[0]!r} on both "
              f"ranks; rank 1 wrote nothing; {CARD}")
    nccl_one_rank_step()
    print(f"data-parallel phase {time.perf_counter() - phase_start:.1f} s; {CARD}")
    return {name: sum(r["counts"][name] for r in reports) for name in reports[0]["counts"]}


def nccl_one_rank_step() -> None:
    """One fine-tune step at full width under a one-rank nccl group: the
    step's two all-reduces run through NCCL, and the updated masters are
    bit-equal to the same step without a group."""
    import socket

    import torch.distributed as dist

    from ssl4polyp_tpu_torch.parallel import initialize_multihost, process_info
    from ssl4polyp_tpu_torch.training import classification as engine

    rng = np.random.default_rng(SEED + 13)
    cfg = ViTConfig(num_classes=2)
    tree = jax_layout_tree(cfg, rng)
    images = torch.from_numpy(rng.integers(0, 256, (DP_RANK_BATCH, 224, 224, 3),
                                           dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, 2, DP_RANK_BATCH)).cuda()
    valid = torch.arange(DP_RANK_BATCH, device="cuda") < DP_RANK_BATCH - 1
    loss_args = loss_settings([3000, 1000])

    def one_step() -> tuple[dict, float]:
        classifier = get_imagenet_or_random_vit(torch.Generator().manual_seed(SEED),
                                                jax_params=tree, num_classes=2, device="cuda")
        state = init_train_state(classifier, torch.Generator(device="cuda").manual_seed(SEED))
        full = optim.finetune_lr_scales(state.params, "full", cfg.depth)
        metrics = make_train_step(step_context(classifier, *loss_args, FT_WEIGHT_DECAY))(
            state, images, labels, valid, FT_LR, full, optim.no_weight_decay_scales(state.params))
        return state.params, metrics["loss"].item()

    alone, loss_alone = one_step()
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    reduces = []
    reduce = engine.cross_replica_sum
    initialize_multihost(f"tcp://127.0.0.1:{port}", world_size=1, rank=0, backend="nccl")
    try:
        info = process_info()
        with mock.patch.object(engine, "cross_replica_sum",
                               lambda tensors: reduces.append(reduce(tensors))):
            grouped, loss_grouped = one_step()
    finally:
        dist.destroy_process_group()
    if info["backend"] != "nccl" or len(reduces) != 2:
        fail(f"the one-rank nccl step: backend {info['backend']}, {len(reduces)} all-reduces")
    wrong = differing(alone, grouped)
    if wrong or loss_alone != loss_grouped:
        fail(f"the one-rank nccl step differs from the step without a group: {wrong[:5]}, loss "
             f"{loss_grouped} against {loss_alone}")
    print(f"one fine-tune step (ViT-B/16, batch {DP_RANK_BATCH}) under a one-rank nccl group: "
          f"its {len(reduces)} all-reduces through NCCL, all {len(grouped)} updated masters and "
          f"the loss bit-equal to the same step without a group")


# Phase 14: the native JPEG decoder on frames of the study's sizes.
NATIVE_SIZES = ((1240, 1080), (1920, 1080), (1350, 1080), (720, 576), (1280, 1024), (384, 288),
                (224, 224))  # SUN; PolypGen; Hyperkvasir-like; scale 7/8 at 224; the model's
NATIVE_SUBSAMPLINGS = {"4:4:4": 0, "4:2:0": 2}  # PIL's codes
NATIVE_FRAMES = 256  # SUN-size frames for the rates, the eval CLI and pretraining
NATIVE_THREADS = 8
NATIVE_REPEATS = 5
NATIVE_PRETRAIN_STEPS = 2
DRAFT_SCALES = (1, 2, 4, 8)  # the N of N/8 that PIL's Image.draft decodes at


def sun_like_pixels(rng: np.random.Generator, width: int, height: int) -> np.ndarray:
    """A smooth colour field with noise (about 300 KiB a 1240x1080 frame at
    quality 90)."""
    from PIL import Image

    coarse = Image.fromarray(rng.integers(0, 256, (height // 32 + 2, width // 32 + 2, 3),
                                          dtype=np.uint8))
    smooth = np.asarray(coarse.resize((width, height), Image.BILINEAR), dtype=np.int16)
    return np.clip(smooth + rng.integers(-12, 13, (height, width, 3)), 0, 255).astype(np.uint8)


def draft_decode(path: Path, num: int) -> np.ndarray:
    """PIL's decode of a JPEG at scale num/8 (``Image.draft``), as RGB."""
    from PIL import Image

    with Image.open(path) as img:
        width, height = img.size
        img.draft(img.mode, (width // (8 // num), height // (8 // num)))
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def native_byte_checks(root: Path) -> Path:
    """The library against ``native/reference.py`` on PIL's ``draft``
    decode, byte for byte, at the scales ``draft`` reaches; ``jpeg_dims``
    against PIL's size; a CMYK frame refused.  Returns the CMYK frame's
    path."""
    from PIL import Image

    from ssl4polyp_tpu_torch.data.folder import sample_crop_box
    from ssl4polyp_tpu_torch.native import reference

    rng = np.random.default_rng(SEED)
    root.mkdir(parents=True)
    frames = {}
    for width, height in NATIVE_SIZES:
        pixels = sun_like_pixels(rng, width, height)
        for tag, code in NATIVE_SUBSAMPLINGS.items():
            frames[f"{width}x{height} {tag}"] = root / f"{width}x{height}_{code}.jpg"
            Image.fromarray(pixels).save(frames[f"{width}x{height} {tag}"], quality=90,
                                         subsampling=code)
    pixels = sun_like_pixels(rng, 1240, 1080)
    frames["1240x1080 progressive"] = root / "progressive.jpg"
    Image.fromarray(pixels).save(frames["1240x1080 progressive"], quality=90, progressive=True)
    frames["1240x1080 grayscale"] = root / "grayscale.jpg"
    Image.fromarray(pixels).convert("L").save(frames["1240x1080 grayscale"], quality=90)
    cmyk = root / "cmyk.jpg"
    Image.fromarray(pixels).convert("CMYK").save(cmyk, quality=90)

    checked = {"decode_resize": {}, "decode_crop_resize": {}}
    skipped = []
    out = 224
    for name, path in frames.items():
        with Image.open(path) as img:
            width, height = img.size
        if native.jpeg_dims(path) != (width, height):
            fail(f"native decode: jpeg_dims {native.jpeg_dims(path)} of {name}, PIL "
                 f"{(width, height)}")
        num = reference.resize_scale(width, height, out, out)
        if num in DRAFT_SCALES:
            got = native.decode_resize(path, out, out)
            want = reference.resize_decoded(draft_decode(path, num), out, out)
            if got is None or not np.array_equal(got, want):
                fail(f"native decode: decode_resize of {name} at {num}/8 differs from the "
                     f"reference on PIL's draft decode")
            checked["decode_resize"][num] = checked["decode_resize"].get(num, 0) + 1
        else:
            skipped.append(f"decode_resize {name} ({num}/8)")
        # Crops as the pretraining loader draws them, then one a draft scale
        # (the crop's height so that scale num covers 224 and num - 1 not).
        crops = []
        for _ in range(12):
            y0, x0, h, w = sample_crop_box(width, height, rng)
            crops.append((y0 / height, x0 / width, h / height, w / width))
        for num in DRAFT_SCALES[1:]:
            fh = out * 8 / (height * (num - 0.5))
            if fh <= 1:
                fw = min(1.0, fh * width / height)
                crops.append((rng.uniform(0, 1 - fh), rng.uniform(0, 1 - fw), fh, fw))
        for frac in crops:
            num = reference.crop_scale(width, height, out, out, frac[2], frac[3])
            if num not in DRAFT_SCALES:
                continue
            flip = bool(rng.integers(0, 2))
            got = native.decode_crop_resize(path, out, out, frac, flip)
            want = reference.crop_decoded(draft_decode(path, num), frac, out, out, flip)
            if got is None or not np.array_equal(got, want):
                fail(f"native decode: decode_crop_resize of {name}, crop {frac}, flip {flip}, "
                     f"at {num}/8 differs from the reference on PIL's draft decode")
            checked["decode_crop_resize"][num] = checked["decode_crop_resize"].get(num, 0) + 1
    images, ok = native.decode_resize_batch_status([cmyk], out, out)
    if ok[0] or images.any():
        fail("native decode: the CMYK frame was not refused with a zero-filled slot")
    print(f"native decode byte for byte against native/reference.py on PIL's draft decode, "
          f"{len(frames)} frames ({', '.join(frames)}): checks by N of N/8 "
          f"{json.dumps({k: dict(sorted(v.items())) for k, v in checked.items()})}, every one "
          f"equal; not reachable by draft: {skipped}; jpeg_dims equal to PIL's size on all; "
          f"the CMYK frame refused (status 0, zero-filled)")
    return cmyk


def write_sun_frames(paths: list[Path]) -> None:
    """SUN-size (1240x1080) 4:2:0 JPEGs at ``paths``, from numpy seeds."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def write(i: int) -> None:
        pixels = sun_like_pixels(np.random.default_rng(SEED + i), 1240, 1080)
        Image.fromarray(pixels).save(paths[i], quality=90)

    with ThreadPoolExecutor(NATIVE_THREADS) as pool:
        list(pool.map(write, range(len(paths))))


def median_rate(frames: int, fn) -> tuple[float, float, float]:
    """frames/s of ``fn`` over ``NATIVE_REPEATS`` calls: median, min, max."""
    rates = []
    for _ in range(NATIVE_REPEATS):
        start = time.perf_counter()
        fn()
        rates.append(frames / (time.perf_counter() - start))
    return statistics.median(rates), min(rates), max(rates)


def phase_native_decode() -> dict[str, int]:
    """Phase 14: the native JPEG decoder (``ssl4polyp_tpu_torch/native``)
    on frames of the study's sizes, byte for byte against its reference, its
    rates beside PIL's, then the eval CLI and the pretraining engine at full
    width on SUN-size frames through it.  Returns the launches of its paths."""
    from concurrent.futures import ThreadPoolExecutor

    import PIL

    from ssl4polyp_tpu_torch.data.folder import ImageFolderIndex, PretrainLoader
    from ssl4polyp_tpu_torch.data.transforms import decode_frame
    from ssl4polyp_tpu_torch.training import pretrain as engine

    phase_start = time.perf_counter()
    libjpeg = native.libjpeg_path()
    version = re.search(rb"libjpeg-turbo version [ -~]+", libjpeg.read_bytes())
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout
    print(f"native decode: {native.build_library()} built by {gxx.splitlines()[0]} on "
          f"{platform.machine()} against {libjpeg} "
          f"({version.group(0).decode() if version else 'no libjpeg-turbo version string'}), "
          f"which PIL {PIL.__version__} maps; first build, load and check {NATIVE_BUILD_S:.2f} s")
    cfg = ViTConfig(pos_embed="learned", num_classes=2)
    tau = 0.4375
    depth, enc, dec = cfg.depth, 12, 8
    per_eval = {"fused_qkv_attention": depth, "layernorm": 2 * depth + 1, "fc1_gelu": depth}
    per_step = {"fused_qkv_attention": enc + dec, "fused_qkv_attention_backward": enc + dec,
                "layernorm": 2 * (enc + dec) + 2, "layernorm_backward": 2 * (enc + dec) + 2,
                "fc1_gelu": enc + dec, "adamw": 4}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cmyk = native_byte_checks(tmp / "matrix")

        # A test pack of SUN-size frames: the synthetic pack's CSVs and
        # manifest, its frames written over at 1240x1080.
        start = time.perf_counter()
        pack = build_synthetic_pack(tmp / "data_packs", name="sun_full", splits=("test",),
                                    frames_per_split=NATIVE_FRAMES, image_size=16, seed=SEED)
        index = create_classification_datasets(test_spec="sun_full", pack_root=tmp / "data_packs",
                                               image_size=224)["test"]
        paths = [Path(p) for p in index.paths]
        write_sun_frames(paths)
        checkpoint = save_checkpoint(tmp / "run" / "SupImnet_SUNFull_s13_e07_valLoss.ckpt",
                                     {"params": jax_layout_tree(cfg, np.random.default_rng(SEED))},
                                     eval_checkpoint_meta(cfg, tau))
        print(f"native decode: wrote {NATIVE_FRAMES} JPEGs of 1240x1080 (4:2:0, quality 90, "
              f"{sum(p.stat().st_size for p in paths) / NATIVE_FRAMES / 1024:.0f} KiB a frame) "
              f"into {pack.name} and a ViT-B/16 checkpoint in "
              f"{time.perf_counter() - start:.1f} s")

        # Rates, 8 threads, the files in the page cache (warm reads).
        native_rate = median_rate(NATIVE_FRAMES, lambda: native.decode_resize_batch_status(
            paths, 224, 224, n_threads=NATIVE_THREADS))
        with ThreadPoolExecutor(NATIVE_THREADS) as pool:
            pil_rate = median_rate(NATIVE_FRAMES, lambda: list(pool.map(
                lambda p: decode_frame(p, 224), paths)))
        loader_rates = {}
        for label, switch in (("native", "1"), ("PIL", "0")):
            with mock.patch.dict(os.environ, {"SSL4POLYP_NATIVE_DECODE": switch}):
                host = HostDataLoader(index, batch_size=BATCH, shuffle=False, drop_last=False,
                                      num_workers=NATIVE_THREADS)
                if host._use_native != (switch == "1"):
                    fail(f"native decode: SSL4POLYP_NATIVE_DECODE={switch} left the loader's "
                         f"native path {host._use_native}")
                loader_rates[label] = median_rate(NATIVE_FRAMES, lambda: list(host))
        folder_index = ImageFolderIndex(paths[0].parent, no_train_dir=True)
        crop_rates = {label: median_rate(NATIVE_FRAMES, lambda: list(PretrainLoader(
            folder_index, BATCH, num_workers=NATIVE_THREADS, use_native=use)))
            for label, use in (("native", None), ("PIL", False))}
        rate = lambda r: f"{r[0]:.1f} [{r[1]:.1f}-{r[2]:.1f}]"  # noqa: E731
        print(f"native decode rates, frames/s of 1240x1080 JPEGs to 224 px, median [range] of "
              f"{NATIVE_REPEATS} passes over {NATIVE_FRAMES} frames, {NATIVE_THREADS} threads, "
              f"warm page cache: decode_resize_batch_status {rate(native_rate)}; PIL's "
              f"decode_frame on a thread pool {rate(pil_rate)}; HostDataLoader alone (batches of "
              f"{BATCH}) native {rate(loader_rates['native'])}, under SSL4POLYP_NATIVE_DECODE=0 "
              f"{rate(loader_rates['PIL'])}; PretrainLoader's crop path native "
              f"{rate(crop_rates['native'])}, use_native=False {rate(crop_rates['PIL'])}; "
              f"{os.cpu_count()} host cores; {CARD}")

        # A frame the decoder refuses is filled by the loader's PIL retry.
        retry_index = create_classification_datasets(
            test_spec="sun_full", pack_root=tmp / "data_packs", image_size=224)["test"]
        retry_index.paths = [str(cmyk), *index.paths[1:BATCH]]
        native.reset_decode_counts()
        batch = next(iter(HostDataLoader(retry_index, batch_size=BATCH, shuffle=False,
                                         num_workers=NATIVE_THREADS)))
        retried = native.decode_counts()
        if retried["failed"] != 1 or not batch["valid"].all() or not np.array_equal(
                batch["image"][0], decode_frame(cmyk, 224)):
            fail(f"native decode: the loader did not fill the CMYK frame through PIL "
                 f"({retried}, valid {batch['valid'].sum()})")

        # The main path: the eval CLI (native, PIL, native), then pretraining.
        argv = ["--checkpoint", str(checkpoint), "--test-pack", "sun_full", "--pack-root",
                str(tmp / "data_packs"), "--batch-size", str(BATCH), "--export-outputs"]
        walls, logits, decoded = {}, {}, {}
        ops.reset_launch_counts()
        for run, switch in (("native", "1"), ("PIL", "0"), ("native again", "1")):
            native.reset_decode_counts()
            with mock.patch.dict(os.environ, {"SSL4POLYP_NATIVE_DECODE": switch}), \
                    contextlib.redirect_stdout(io.StringIO()) as printed:
                start = time.perf_counter()
                eval_classification.cli_main(argv + ["--output-dir", str(tmp / run)])
                torch.cuda.synchronize()
                walls[run] = time.perf_counter() - start
            summary = json.loads(printed.getvalue())
            decoded[run] = native.decode_counts()
            logits[run] = np.load(tmp / run / "logits.npz")["logits"]
            if summary["n_frames"] != NATIVE_FRAMES or summary["tau"] != tau or not (
                    tmp / run / "eval_results.txt").exists() or not np.isfinite(logits[run]).all():
                fail(f"native decode: eval CLI run {run}: {summary}")
        want = {"native": NATIVE_FRAMES, "PIL": 0, "native again": NATIVE_FRAMES}
        if any(decoded[run] != {"decoded": n, "failed": 0} for run, n in want.items()):
            fail(f"native decode: frames through the native decoder by eval CLI run {decoded}, "
                 f"expected {want} and no PIL retry")
        if not np.array_equal(logits["native"], logits["native again"]):
            fail("native decode: two native runs of the eval CLI gave other logits")
        delta = float(np.abs(logits["native"] - logits["PIL"]).max())
        if delta == 0.0:
            fail("native decode: the native and PIL runs gave the same logits on resized frames")
        print(f"native decode, eval CLI ViT-B/16 on {NATIVE_FRAMES} frames of 1240x1080 in "
              f"batches of {BATCH}, frames/s from the command to eval_results.txt: native "
              f"{NATIVE_FRAMES / walls['native']:.1f}, under SSL4POLYP_NATIVE_DECODE=0 "
              f"{NATIVE_FRAMES / walls['PIL']:.1f}, native again "
              f"{NATIVE_FRAMES / walls['native again']:.1f}; native logits bit-equal over two "
              f"runs; max |logit native - logit PIL| {delta:.4e}; native decodes "
              f"{decoded['native']}, PIL retries 0; {CARD}")

        native.reset_decode_counts()
        start = time.perf_counter()
        summary = engine.cli_main([
            "--data-root", str(paths[0].parent), "--no-train-dir", "--output-dir",
            str(tmp / "pretrain"), "--epochs", "1", "--warmup-epochs", "1",
            "--limit-steps-per-epoch", str(NATIVE_PRETRAIN_STEPS), "--batch-size", str(BATCH),
            "--num-workers", str(NATIVE_THREADS), "--log-interval", "1", "--seed", str(SEED)])
        torch.cuda.synchronize()
        pretrain_wall = time.perf_counter() - start
        counts = ops.launch_counts()
        cropped = native.decode_counts()
        if summary.get("epoch") != 0 or not np.isfinite(summary["train_loss"]):
            fail(f"native decode: the pretraining engine returned {summary}")
        if cropped["decoded"] < NATIVE_PRETRAIN_STEPS * BATCH or cropped["failed"]:
            fail(f"native decode: the pretraining loader's crops {cropped}: expected at least "
                 f"{NATIVE_PRETRAIN_STEPS * BATCH} through the native decoder and no PIL retry")
        check_counts(counts, {name: 3 * (NATIVE_FRAMES // BATCH) * per_eval.get(name, 0)
                              + NATIVE_PRETRAIN_STEPS * per_step.get(name, 0)
                              for name in counts}, 1,
                     f"three eval CLI runs of {NATIVE_FRAMES // BATCH} batches and "
                     f"{NATIVE_PRETRAIN_STEPS} pretraining steps")
        print(f"native decode, the pretraining engine (MAE ViT-B/16, batch {BATCH}) on the "
              f"{NATIVE_FRAMES} frames of 1240x1080 through the crop path: "
              f"{NATIVE_PRETRAIN_STEPS} steps, loss {summary['train_loss']:.4f}, "
              f"{pretrain_wall:.1f} s wall (model build and the 1.34 GB save included); native "
              f"crops {cropped}, PIL retries 0; {CARD}")
    print(f"native decode phase {time.perf_counter() - phase_start:.1f} s; {CARD}")
    return counts


# Phase 15: fp32 compute (`amp: false`, PretrainSettings.precision "fp32").
FP32_TIMED_STEPS = (2, 5)  # images/s: 2 repeats of 5 steps or requests
FP32_ENGINE_FRAMES = {"train": 128, "val": 64, "test": 64}
FP32_ENGINE_LIMIT = {"train": 2, "val": 1, "test": 1}  # batches of 64, one epoch
# Step 1 of each fp32 train step, kernels against plain: the kernels make
# the plain versions' arithmetic in fp32, in other summation orders (phase
# 2: up to 5e-7 of max |plain| a kernel, several of them bit-equal), so the
# loss may move by a few fp32 ulps through the blocks and each gradient, two
# or three sums deep, by a few 1e-6 of its norm: the limits sit at 1e-5 and
# 1e-4.  The logits of the eval forward, 12 blocks of such differences deep,
# as a fraction of max |plain|, with the gradients' limit.
FP32_LOSS_RTOL = 1e-5
FP32_STEP_GRAD_RTOL = 1e-4
FP32_LOGITS_FRAC = 1e-4
# The fine-tune step's kernel configurations in fp32 beside the default
# route: (label, model overrides, whether the model is built under
# BENCH_ATTN_PROJ=1, the default route's fp32 kernels they take the place
# of, the fp32 kernels that take it, one launch a block and step).
FP32_KNOB_CONFIGS = (
    ("full", {"mlp_fusion": "full"}, False, ("fc1_gelu_f32",), ("mlp_fused_f32",)),
    ("full_ln+qkv_ln", {"mlp_fusion": "full_ln", "qkv_ln_fusion": True}, False,
     ("fc1_gelu_f32",), ("mlp_ln_fused_f32", "ln_linear_f32")),
    ("fc1+attn_proj", {}, True, ("fused_qkv_attention_f32", "fused_qkv_attention_backward_f32"),
     ("attn_proj_f32", "attn_proj_backward_f32")),
)


def fp32_adamw(gen: torch.Generator, params: dict[str, torch.Tensor]) -> None:
    """The AdamW kernel in an fp32 run: the compute copy is the masters
    themselves, so the kernel writes no copy.  Three steps against its plain
    version, every parameter and moment bit for bit."""
    lr_scale = optim.finetune_lr_scales(params, "full", 12, head_scale=2.5, freeze_pos_embed=True)
    kwargs = dict(b1=0.9, b2=0.999, weight_decay=0.05, lr_scale=lr_scale,
                  wd_scale=optim.no_weight_decay_scales(params))
    sides = []
    for _ in range(2):
        own = {n: p.clone() for n, p in params.items()}
        sides.append((own, layers.compute_copy(own, torch.float32), optim.adamw_init(own)))
    if any(sides[0][1][n].data_ptr() != p.data_ptr() for n, p in sides[0][0].items()):
        fail("fp32 adamw: the fp32 compute copy does not alias the masters")
    for step in range(3):
        grads = {n: 0.01 * torch.randn(p.shape, generator=gen, device="cuda")
                 for n, p in params.items()}
        optim.adamw_update_fused(*sides[0][:2], grads, sides[0][2], lr=1e-3 * (step + 1), **kwargs)
        optim.adamw_update_fused_plain(*sides[1][:2], grads, sides[1][2], lr=1e-3 * (step + 1),
                                       **kwargs)
        torch.cuda.synchronize()
        for what, got, want in (("parameter", sides[0][0], sides[1][0]),
                                ("mu", sides[0][2].mu, sides[1][2].mu),
                                ("nu", sides[0][2].nu, sides[1][2].nu)):
            wrong = differing(got, want)
            if wrong:
                fail(f"fp32 adamw step {step + 1}: {what} of {wrong[:4]} differs from the plain "
                     f"version's bits")
    print(f"fp32 adamw: {len(params)} tensors, the compute copy the masters themselves (no copy "
          f"written); parameters and moments equal the plain version's bit for bit over 3 steps")


def phase_fp32() -> dict[str, int]:
    """Phase 15: the fine-tune step, the pretrain step, the eval forward, a
    fine-tune engine run with ``amp: false`` and the eval CLI on its
    checkpoint, all in fp32 through the default route's fp32 kernels."""
    from ssl4polyp_tpu_torch.training import classification as engine

    phase_start = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("fp32 phase: cuBLAS is allowed TF32; the fp32 runs' products must be fp32")
    f32 = torch.float32
    depth, enc_depth, dec_depth = 12, 12, 8
    per_eval = {"fused_qkv_attention_f32": depth, "layernorm_f32": 2 * depth + 1,
                "fc1_gelu_f32": depth}
    per_ft_step = dict(per_eval, fused_qkv_attention_backward_f32=depth,
                       layernorm_backward_f32=2 * depth + 1, adamw=3)  # 152 tensors
    total: dict[str, int] = {}

    def add(counts: dict[str, int]) -> None:
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

    def timed(run, what: str, per_call: dict[str, int]) -> list[float]:
        """Images/s of FP32_TIMED_STEPS calls, their launches exact."""
        ops.reset_launch_counts()
        rate = rates(run, BATCH, *FP32_TIMED_STEPS)
        counts = ops.launch_counts()
        calls = FP32_TIMED_STEPS[0] * FP32_TIMED_STEPS[1]
        check_counts(counts, per_call, calls, f"{calls} {what}")
        add(counts)
        print(f"{what}, batch {BATCH}, images/s over {FP32_TIMED_STEPS[0]} repeats of "
              f"{FP32_TIMED_STEPS[1]}: {spread(rate)}; {CARD}")
        return rate

    # The fine-tune step.
    rng = np.random.default_rng(SEED)
    base = ViTConfig(pos_embed="learned", num_classes=2)
    tree = jax_layout_tree(base, rng)
    batches = [torch.from_numpy(rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)).cuda()
               for _ in range(2)]
    labels = [torch.from_numpy(rng.integers(0, 2, BATCH)).cuda() for _ in range(2)]
    valid = torch.arange(BATCH, device="cuda") < BATCH - 4
    loss_mode, pos_weight, class_weights = loss_settings([3000, 1000])

    def fresh_classifier():
        return get_imagenet_or_random_vit(torch.Generator().manual_seed(SEED), jax_params=tree,
                                          num_classes=2, device="cuda", compute_dtype=f32)

    classifier = fresh_classifier()
    if classifier.cfg.compute_dtype != f32:
        fail(f"fp32 fine-tune: the classifier computes in {classifier.cfg.compute_dtype}")
    ctx = step_context(classifier, loss_mode, pos_weight, class_weights, FT_WEIGHT_DECAY)
    step = make_train_step(ctx)
    state = init_train_state(classifier, torch.Generator(device="cuda").manual_seed(SEED))
    full = optim.finetune_lr_scales(state.params, "full", depth)
    wd = optim.no_weight_decay_scales(state.params)
    aug = draw_augment_params(BATCH, torch.Generator(device="cuda").manual_seed(SEED + 1))
    loss, grads = loss_and_grads(ctx, state, batches[0], labels[0], valid, aug)
    with plain_kernels():
        plain_loss, plain_grads = loss_and_grads(ctx, state, batches[0], labels[0], valid, aug)
    if any(g.dtype != f32 for g in grads.values()):
        fail("fp32 fine-tune: a gradient is not fp32")
    check_step_one(loss, grads, plain_loss, plain_grads, FP32_LOSS_RTOL, FP32_STEP_GRAD_RTOL,
                   "fp32 fine-tune")
    del grads, plain_grads

    def ft_state():
        return init_train_state(fresh_classifier(),
                                torch.Generator(device="cuda").manual_seed(SEED))

    check_run_to_run_bits(
        ft_state, lambda st, i: step(st, batches[i], labels[i], valid, FT_LR, full, wd), f32,
        steps=2, what="fp32 fine-tune")
    calls = iter(range(10 ** 6))
    timed(lambda: step(state, batches[next(calls) % 2], labels[0], valid, FT_LR, full, wd),
          "fp32 fine-tune steps (ViT-B/16)", per_ft_step)
    if not all(torch.isfinite(p).all() for p in state.params.values()):
        fail("fp32 fine-tune: non-finite parameters after the steps")
    fp32_adamw(torch.Generator(device="cuda").manual_seed(SEED), state.params)
    del state, ctx, step

    # The fine-tune step under the fusion knobs, on their fp32 kernels: the
    # fused MLP, or the fused LN+MLP with LN+QKV (whose backwards recompute
    # the normalised row and take the LayerNorm backward on the LayerNorm
    # kernels, so the LayerNorm counts stay), or under BENCH_ATTN_PROJ=1 the
    # attention+projection kernels in the attention kernels' place.
    for label, overrides, fold, replaced, fused in FP32_KNOB_CONFIGS:
        what = f"fp32 fine-tune [{label}]"

        def knob_classifier():
            with projection_fold(fold):  # noqa: B023
                return get_imagenet_or_random_vit(
                    torch.Generator().manual_seed(SEED), jax_params=tree, num_classes=2,
                    device="cuda", compute_dtype=f32, **overrides)  # noqa: B023

        def knob_state():
            return init_train_state(knob_classifier(),
                                    torch.Generator(device="cuda").manual_seed(SEED))

        knob = knob_classifier()
        routes = {(b.mlp_route, b.qkv_ln, b.attn.proj_fold) for b in knob.model.blocks}
        if routes != {(overrides.get("mlp_fusion", "fc1"), overrides.get("qkv_ln_fusion", False),
                       fold)}:
            fail(f"{what}: the blocks' routes are {routes}")
        ctx = step_context(knob, loss_mode, pos_weight, class_weights, FT_WEIGHT_DECAY)
        step = make_train_step(ctx)
        state = init_train_state(knob, torch.Generator(device="cuda").manual_seed(SEED))
        loss, grads = loss_and_grads(ctx, state, batches[0], labels[0], valid, aug)
        with plain_kernels():
            plain_loss, plain_grads = loss_and_grads(ctx, state, batches[0], labels[0], valid,
                                                     aug)
        check_step_one(loss, grads, plain_loss, plain_grads, FP32_LOSS_RTOL, FP32_STEP_GRAD_RTOL,
                       what)
        del grads, plain_grads
        check_run_to_run_bits(
            knob_state, lambda st, i: step(st, batches[i], labels[i], valid, FT_LR, full, wd), f32,
            steps=2, what=what)
        calls = iter(range(10 ** 6))
        unfused = {name: n for name, n in per_ft_step.items() if name not in replaced}
        timed(lambda: step(state, batches[next(calls) % 2], labels[0], valid, FT_LR, full, wd),
              f"{what} steps (ViT-B/16)", {**unfused, **{n: depth for n in fused}})
        if not all(torch.isfinite(p).all() for p in state.params.values()):
            fail(f"{what}: non-finite parameters after the steps")
        del state, ctx, step, knob

    # The eval forward.
    forward = make_forward_fn(classifier, "cuda")()
    requests = [rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8) for _ in range(2)]
    ops.reset_launch_counts()
    logits = [forward(images) for images in requests]
    counts = ops.launch_counts()
    check_counts(counts, per_eval, len(requests), f"{len(requests)} fp32 eval requests")
    add(counts)
    with plain_kernels():
        plain_logits = [forward(images) for images in requests]
    err = max(max_relative_error(torch.from_numpy(got), torch.from_numpy(ref), FP32_LOGITS_FRAC,
                                 "fp32 eval forward: logits")[0]
              for got, ref in zip(logits, plain_logits))
    if any(got.shape != (BATCH, 2) or got.dtype != np.float32 for got in logits):
        fail(f"fp32 eval forward: logits {[(l.shape, l.dtype) for l in logits]}")
    print(f"fp32 eval forward: logits against the plain forward's {err:.3e} of max |plain| "
          f"(limit {FP32_LOGITS_FRAC})")
    timed(lambda: forward(requests[0]), "fp32 eval requests (ViT-B/16)", per_eval)
    # The eval forward under BENCH_ATTN_PROJ=1, on the same (trained)
    # parameters: the attention+projection kernel in every block.
    with projection_fold(True):
        folded = fresh_classifier()
    folded.model.load_state_dict(classifier.model.state_dict())
    if not all(b.attn.proj_fold for b in folded.model.blocks):
        fail("fp32 eval forward under the fold: a block does not fold")
    fold_forward = make_forward_fn(folded, "cuda")()
    per_fold_eval = {**{n: c for n, c in per_eval.items() if n != "fused_qkv_attention_f32"},
                     "attn_proj_f32": depth}
    ops.reset_launch_counts()
    fold_logits = [fold_forward(images) for images in requests]
    counts = ops.launch_counts()
    check_counts(counts, per_fold_eval, len(requests),
                 f"{len(requests)} fp32 eval requests under the fold")
    add(counts)
    err = max(max_relative_error(torch.from_numpy(got), torch.from_numpy(ref), FP32_LOGITS_FRAC,
                                 "fp32 eval forward under the fold: logits")[0]
              for got, ref in zip(fold_logits, logits))
    print(f"fp32 eval forward under the fold: logits against the unfolded fp32 forward's "
          f"{err:.3e} of max |unfolded| (limit {FP32_LOGITS_FRAC})")
    timed(lambda: fold_forward(requests[0]), "fp32 eval requests under the fold (ViT-B/16)",
          per_fold_eval)
    del forward, classifier, fold_forward, folded

    # The dense model in fp32: its convolutions stay fp32 under torch's own
    # cuDNN setting (TF32 allowed in a fresh process), bit for bit as under
    # this script's flags.
    from ssl4polyp_tpu_torch.models.factory import build_classifier

    if TORCH_DEFAULTS[1] is not True:
        fail(f"fp32 dense: torch's default cudnn.allow_tf32 is {TORCH_DEFAULTS[1]}, so the "
             f"comparison would not test the convolutions' TF32")
    dense = build_classifier(torch.Generator().manual_seed(SEED),
                             {"dense": True, "dense_readout": "project"}, device="cuda",
                             compute_dtype=f32)
    dense_forward = make_forward_fn(dense, "cuda")()
    dense_images = rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    ops.reset_launch_counts()
    ours = dense_forward(dense_images)
    with torch_defaults():
        defaults = dense_forward(dense_images)
        flag_kept = torch.backends.cudnn.allow_tf32
    counts = ops.launch_counts()
    check_counts(counts, {"fused_qkv_attention_f32": depth, "layernorm_f32": 2 * depth,
                          "fc1_gelu_f32": depth}, 2, "two fp32 dense forwards")
    add(counts)
    if ours.shape != (2, 112, 112, 2) or ours.dtype != np.float32 or not np.isfinite(ours).all():
        fail(f"fp32 dense: logits {ours.shape} {ours.dtype}")
    if not flag_kept or not np.array_equal(ours, defaults):
        fail(f"fp32 dense: under torch's default flags the logits differ (max |diff| "
             f"{np.abs(ours - defaults).max():.3e}) or the forward left cudnn.allow_tf32 "
             f"{flag_kept}")
    print("fp32 dense forward (ViT-B/16 taps -> DPT, batch 2): logits bit-equal under torch's "
          "default cudnn.allow_tf32 (True) and under this script's (False)")
    # Its gradients too: autograd runs each convolution's backward after the
    # forward has returned, under whatever the flag says then.  cuDNN's
    # deterministic mode holds for both runs, so that only TF32 could part
    # them.
    params = dict(dense.model.named_parameters())
    dense_input = torch.from_numpy(dense_images).cuda().float() / 255.0
    runs, flags = [], []
    deterministic = torch.backends.cudnn.deterministic
    ops.reset_launch_counts()
    try:
        torch.backends.cudnn.deterministic = True
        for defaults in (True, False):
            with torch_defaults() if defaults else contextlib.nullcontext():
                dense.model.zero_grad(set_to_none=True)
                dense.model(dense_input).square().mean().backward()
                torch.cuda.synchronize()
                flags.append(torch.backends.cudnn.allow_tf32)
            runs.append({n: p.grad.clone() for n, p in params.items() if p.grad is not None})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    counts = ops.launch_counts()
    check_counts(counts, {"fused_qkv_attention_f32": depth, "layernorm_f32": 2 * depth,
                          "fc1_gelu_f32": depth, "fused_qkv_attention_backward_f32": depth,
                          "layernorm_backward_f32": 2 * depth}, 2,
                 "two fp32 dense forwards and backwards")
    add(counts)
    wrong = [n for n in runs[0] if not torch.equal(runs[0][n], runs[1][n])]
    if flags != [True, False] or wrong or runs[0].keys() != runs[1].keys() or not any(
            n.startswith("dpt.") for n in runs[0]):
        fail(f"fp32 dense: the gradients of {wrong[:5]} differ under torch's default "
             f"cudnn.allow_tf32 and under this script's, or the backward changed the flag "
             f"({flags})")
    print(f"fp32 dense backward (batch 2): all {len(runs[0])} gradients bit-equal under torch's "
          f"default cudnn.allow_tf32 (True) and under this script's (False); the backward left "
          f"the flag as it found it")
    del dense, dense_forward, runs

    # The pretrain step.
    settings = PretrainSettings(batch_size=BATCH, precision="fp32")
    cfg = model_config(settings)
    if cfg.encoder.compute_dtype != f32 or not cfg.encoder.attention_softmax_f32:
        fail(f"fp32 pretrain: model_config gave {cfg.encoder.compute_dtype}")
    mae_tree = jax_layout_mae_tree(cfg, rng)
    images = [torch.from_numpy(rng.integers(0, 256, (1, BATCH, 224, 224, 3), dtype=np.uint8)).cuda()
              for _ in range(2)]
    noise_gen = torch.Generator(device="cuda").manual_seed(SEED)
    noise = [torch.rand((1, BATCH, cfg.encoder.num_patches), generator=noise_gen, device="cuda")
             for _ in range(2)]
    schedule = warmup_cosine(settings.absolute_lr, 20, 2)
    train_step = make_pretrain_step(cfg, 1, settings.weight_decay)

    def mae_state():
        model = MAE(cfg, torch.Generator().manual_seed(SEED))
        model.load_state_dict(mae_state_dict_from_jax(mae_tree, cfg))
        return init_pretrain_state(model.cuda())

    with projection_fold(False):
        state = mae_state()
    loss, grads = pretrain_loss_and_grads(state, images[0], noise[0])
    with plain_kernels():
        plain_loss, plain_grads = pretrain_loss_and_grads(state, images[0], noise[0])
    check_step_one(loss, grads, plain_loss, plain_grads, FP32_LOSS_RTOL, FP32_STEP_GRAD_RTOL,
                   "fp32 pretrain")
    del grads, plain_grads
    check_run_to_run_bits(mae_state, lambda st, i: train_step(st, images[i], noise[i], schedule(i)),
                          f32, steps=2, what="fp32 pretrain")
    calls = iter(range(10 ** 6))

    def pretrain_call():
        i = next(calls)
        train_step(state, images[i % 2], noise[i % 2], schedule(i % 20))

    timed(pretrain_call, "fp32 pretrain steps (MAE ViT-B/16)", {
        "fused_qkv_attention_f32": enc_depth + dec_depth,
        "fused_qkv_attention_backward_f32": enc_depth + dec_depth,
        "layernorm_f32": 2 * (enc_depth + dec_depth) + 2,
        "layernorm_backward_f32": 2 * (enc_depth + dec_depth) + 2,
        "fc1_gelu_f32": enc_depth + dec_depth,
        "adamw": -(-len(state.params) // adamw.TENSORS_PER_LAUNCH)})
    if not all(torch.isfinite(p).all() for p in state.params.values()):
        fail("fp32 pretrain: non-finite parameters after the steps")
    del state

    # The pretrain step under full_ln + qkv_ln_fusion: the decoder's 8 blocks
    # (197 tokens, counted as padded to 200, width 512) on the fused LN+MLP
    # and LN+QKV kernels; the encoder's 50 tokens keep the default route, as
    # in the JAX package.
    what = "fp32 pretrain [full_ln+qkv_ln]"
    knob_cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, mlp_fusion="full_ln", qkv_ln_fusion=True))
    knob_step = make_pretrain_step(knob_cfg, 1, settings.weight_decay)

    def knob_mae_state():
        model = MAE(knob_cfg, torch.Generator().manual_seed(SEED))
        model.load_state_dict(mae_state_dict_from_jax(mae_tree, knob_cfg))
        return init_pretrain_state(model.cuda())

    with projection_fold(False):
        state = knob_mae_state()
    routes = ({(b.mlp_route, b.qkv_ln) for b in state.model.blocks},
              {(b.mlp_route, b.qkv_ln) for b in state.model.decoder_blocks})
    if routes != ({("fc1", False)}, {("full_ln", True)}):
        fail(f"{what}: the encoder's and the decoder's routes are {routes}")
    loss, grads = pretrain_loss_and_grads(state, images[0], noise[0])
    with plain_kernels():
        plain_loss, plain_grads = pretrain_loss_and_grads(state, images[0], noise[0])
    check_step_one(loss, grads, plain_loss, plain_grads, FP32_LOSS_RTOL, FP32_STEP_GRAD_RTOL,
                   what)
    del grads, plain_grads
    check_run_to_run_bits(knob_mae_state,
                          lambda st, i: knob_step(st, images[i], noise[i], schedule(i)), f32,
                          steps=2, what=what)
    calls = iter(range(10 ** 6))

    def knob_pretrain_call():
        i = next(calls)
        knob_step(state, images[i % 2], noise[i % 2], schedule(i % 20))

    timed(knob_pretrain_call, f"{what} steps (MAE ViT-B/16)", {
        "fused_qkv_attention_f32": enc_depth + dec_depth,
        "fused_qkv_attention_backward_f32": enc_depth + dec_depth,
        "layernorm_f32": 2 * (enc_depth + dec_depth) + 2,
        "layernorm_backward_f32": 2 * (enc_depth + dec_depth) + 2,
        "fc1_gelu_f32": enc_depth, "ln_linear_f32": dec_depth, "mlp_ln_fused_f32": dec_depth,
        "adamw": -(-len(state.params) // adamw.TENSORS_PER_LAUNCH)})
    if not all(torch.isfinite(p).all() for p in state.params.values()):
        fail(f"{what}: non-finite parameters after the steps")
    del state

    # The pretrain step under BENCH_ATTN_PROJ=1: the decoder's 8 blocks on
    # the attention+projection kernels; the encoder's 50 tokens keep the
    # attention kernels, as in the JAX package.
    what = "fp32 pretrain [attn_proj]"

    def fold_mae_state():
        with projection_fold(True):
            model = MAE(cfg, torch.Generator().manual_seed(SEED))
        model.load_state_dict(mae_state_dict_from_jax(mae_tree, cfg))
        return init_pretrain_state(model.cuda())

    state = fold_mae_state()
    folds = ({b.attn.proj_fold for b in state.model.blocks},
             {b.attn.proj_fold for b in state.model.decoder_blocks})
    if folds != ({False}, {True}):
        fail(f"{what}: the encoder's and the decoder's folds are {folds}")
    loss, grads = pretrain_loss_and_grads(state, images[0], noise[0])
    with plain_kernels():
        plain_loss, plain_grads = pretrain_loss_and_grads(state, images[0], noise[0])
    check_step_one(loss, grads, plain_loss, plain_grads, FP32_LOSS_RTOL, FP32_STEP_GRAD_RTOL,
                   what)
    del grads, plain_grads
    check_run_to_run_bits(fold_mae_state,
                          lambda st, i: train_step(st, images[i], noise[i], schedule(i)), f32,
                          steps=2, what=what)
    calls = iter(range(10 ** 6))

    def fold_pretrain_call():
        i = next(calls)
        train_step(state, images[i % 2], noise[i % 2], schedule(i % 20))

    timed(fold_pretrain_call, f"{what} steps (MAE ViT-B/16)", {
        "fused_qkv_attention_f32": enc_depth, "fused_qkv_attention_backward_f32": enc_depth,
        "attn_proj_f32": dec_depth, "attn_proj_backward_f32": dec_depth,
        "layernorm_f32": 2 * (enc_depth + dec_depth) + 2,
        "layernorm_backward_f32": 2 * (enc_depth + dec_depth) + 2,
        "fc1_gelu_f32": enc_depth + dec_depth,
        "adamw": -(-len(state.params) // adamw.TENSORS_PER_LAUNCH)})
    if not all(torch.isfinite(p).all() for p in state.params.values()):
        fail(f"{what}: non-finite parameters after the steps")
    del state

    # The fine-tune engine with amp: false, then the eval CLI in fp32.
    built: list = []
    build = engine.build_classifier
    knobs: dict = {}  # model overrides the engine's build takes on (the second run's)

    def recording_build(*args, **kwargs):
        built.append(build(*args, **kwargs, **knobs))
        return built[-1]

    with tempfile.TemporaryDirectory() as tmp, projection_fold(False), \
            mock.patch.object(engine, "build_classifier", recording_build):
        tmp = Path(tmp)
        start = time.perf_counter()
        packs = tmp / "data_packs"
        build_synthetic_pack(packs, name="sun_full", frames_per_split=FP32_ENGINE_FRAMES,
                             image_size=224, seed=SEED)
        root = tmp / "checkpoint_root"
        write_augreg_npz(root / config_model("sup_imnet")["checkpoint"], base,
                         np.random.default_rng(SEED + 1))
        print(f"fp32 engine: wrote a sun_full pack of {FP32_ENGINE_FRAMES} frames and an AugReg "
              f".npz in {time.perf_counter() - start:.1f} s")

        def engine_run(name: str) -> dict:
            return engine.cli_main([
                "--exp-config", "config/exp/exp1.yaml", "--model-key", "sup_imnet", "--seed",
                "13", "--pack-root", str(packs), "--checkpoint-root", str(root),
                "--thresholds-root", str(tmp / f"th_{name}"), "--output-dir", str(tmp / name),
                "--device", "cuda", "--override", "amp=false", "--override", "epochs=1",
                "--override", f"batch_size={BATCH}",
                "--limit-train-batches", str(FP32_ENGINE_LIMIT["train"]),
                "--limit-val-batches", str(FP32_ENGINE_LIMIT["val"]),
                "--limit-test-batches", str(FP32_ENGINE_LIMIT["test"])])

        ops.reset_launch_counts()
        start = time.perf_counter()
        summary = engine_run("run")
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = ops.launch_counts()
        add(counts)
        steps = FP32_ENGINE_LIMIT["train"]
        evals = FP32_ENGINE_LIMIT["val"] + FP32_ENGINE_LIMIT["test"]
        check_counts(counts, {name: steps * per_ft_step.get(name, 0) + evals * per_eval.get(name, 0)
                              for name in counts}, 1,
                     f"the fp32 engine run's {steps} steps and {evals} eval batches")
        if len(built) != 1 or built[0].cfg.compute_dtype != f32:
            fail(f"fp32 engine: built {[c.cfg.compute_dtype for c in built]}, expected one fp32 "
                 f"classifier")
        payload = summary["payload"]
        if summary["epochs_run"] != 1 or not np.isfinite(payload["train_loss"]):
            fail(f"fp32 engine: {summary['epochs_run']} epochs, loss {payload['train_loss']}")
        best = (Path(summary["metrics_path"]).parent / f"{summary['stem']}.ckpt").resolve()
        ops.reset_launch_counts()
        cli = eval_classification.evaluate(
            best, "sun_full", pack_root=packs, batch_size=BATCH, output_dir=tmp / "eval",
            model_overrides={"compute_dtype": f32})
        cli_counts = ops.launch_counts()
        add(cli_counts)
        check_counts(cli_counts, per_eval, FP32_ENGINE_LIMIT["test"],
                     "the fp32 eval CLI on the run's best checkpoint")
        test_block = payload["test_primary"]
        shared = sorted(k for k, v in test_block.items()
                        if isinstance(v, (int, float)) and isinstance(cli.get(k), (int, float)))
        off = {k: (cli[k], test_block[k]) for k in shared
               if not abs(cli[k] - test_block[k]) <= 1e-6}
        if cli["tau"] != summary["tau"] or off or len(shared) < 10:
            fail(f"fp32 eval CLI on {best.name}: tau {cli['tau']} against {summary['tau']}, off "
                 f"{off}, {len(shared)} metrics compared")
        print(f"fp32 engine: exp1 sup_imnet with amp: false, {steps} steps and {evals} eval "
              f"batches in {wall:.1f} s (build {summary['timings']['build_s']:.1f} s), loss "
              f"{payload['train_loss']:.6f}; the eval CLI in fp32 on {best.name}: tau "
              f"{cli['tau']} and {len(shared)} test metrics within 1e-6 of the run's")

        # The same run under mlp_fusion "full" (the engine's build_classifier
        # given the model override, as the JAX engine has no flag for it).
        knobs["mlp_fusion"] = "full"
        ops.reset_launch_counts()
        start = time.perf_counter()
        summary = engine_run("run_full")
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = ops.launch_counts()
        add(counts)
        fused = {"mlp_fused_f32": depth}
        per_step = {**{n: c for n, c in per_ft_step.items() if n != "fc1_gelu_f32"}, **fused}
        per_batch = {**{n: c for n, c in per_eval.items() if n != "fc1_gelu_f32"}, **fused}
        check_counts(counts, {name: steps * per_step.get(name, 0) + evals * per_batch.get(name, 0)
                              for name in counts}, 1,
                     f"the fp32 engine run's {steps} steps and {evals} eval batches under "
                     f"mlp_fusion full")
        if len(built) != 2 or built[1].cfg.compute_dtype != f32 or {
                b.mlp_route for b in built[1].model.blocks} != {"full"}:
            fail("fp32 engine under mlp_fusion full: the classifier is not fp32 on the fused MLP")
        payload = summary["payload"]
        if summary["epochs_run"] != 1 or not np.isfinite(payload["train_loss"]):
            fail(f"fp32 engine under mlp_fusion full: {summary['epochs_run']} epochs, loss "
                 f"{payload['train_loss']}")
        print(f"fp32 engine under mlp_fusion full: {steps} steps and {evals} eval batches in "
              f"{wall:.1f} s, loss {payload['train_loss']:.6f}")
    print(f"fp32 phase {time.perf_counter() - phase_start:.1f} s; {CARD}")
    return total


# Phase 16: a ViT-B/16 at 384 px (577 tokens) in bf16, the resolution at
# which the public ViT-B/16 releases fine-tune: past the 256 tokens of
# qkv_attention.cu, so every block's attention runs on the key tiles.
LONG_IMAGE = 384
LONG_TIMED = (3, 3)  # images/s: 3 repeats of 3 steps or requests
# The fine-tune step's kernel configurations at 577 tokens (counted as
# padded to 584, D 768: the JAX package honours the fusion knobs and the
# projection fold there): (label, model overrides, BENCH_ATTN_PROJ=1).
LONG_FT_CONFIGS = (
    ("fc1", {}, False),
    ("full", {"mlp_fusion": "full"}, False),
    ("full_ln+qkv_ln", {"mlp_fusion": "full_ln", "qkv_ln_fusion": True}, False),
    ("fc1 under BENCH_ATTN_PROJ=1", {}, True),
)


def phase_long_tokens() -> dict[str, int]:
    """Phase 16: the eval forward, the fine-tune step under each kernel
    configuration and the MAE pretrain step of a ViT-B/16 at 384 px in
    bf16, whose 577 tokens (the MAE decoder's too) take the key tiles: step 1
    and the logits against the plain path's, launches exact, images/s; each
    of the three also under BENCH_ATTN_PROJ=1, the projection folded into
    attention on the compositions past 256 tokens."""
    phase_start = time.perf_counter()
    depth, enc_depth, dec_depth = 12, 12, 8
    # Every key-tile backward launches the key tiles' statistics pass.
    tiles = {"fused_qkv_attention_tiles": depth, "fused_qkv_attention_tiles_backward": depth,
             "qkv_attention_tiles_statistics": depth}
    fold_tiles = {"fused_attention_proj_tiles": depth,
                  "fused_attention_proj_tiles_backward": depth,
                  "qkv_attention_tiles_statistics": depth}
    total: dict[str, int] = {}

    def add(counts: dict[str, int]) -> None:
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

    def timed(run, what: str, per_call: dict[str, int]) -> None:
        ops.reset_launch_counts()
        rate = rates(run, BATCH, *LONG_TIMED)
        counts = ops.launch_counts()
        calls = LONG_TIMED[0] * LONG_TIMED[1]
        check_counts(counts, per_call, calls, f"{calls} {what}")
        add(counts)
        print(f"{what}, batch {BATCH}, images/s over {LONG_TIMED[0]} repeats of "
              f"{LONG_TIMED[1]}: {spread(rate)}; {CARD}")

    rng = np.random.default_rng(SEED)
    base = ViTConfig(pos_embed="learned", num_classes=2, img_size=LONG_IMAGE)
    tree = jax_layout_tree(base, rng)

    def classifier(fold: bool = False, **overrides):
        with projection_fold(fold):
            return get_imagenet_or_random_vit(
                torch.Generator().manual_seed(SEED), jax_params=tree, num_classes=2,
                device="cuda", img_size=LONG_IMAGE, **overrides)

    # The eval forward, host uint8 to logits.
    clf = classifier()
    if (clf.cfg.num_patches + 1, clf.cfg.pad_tokens_to) != (577, 584):
        fail(f"384 px: {clf.cfg.num_patches + 1} tokens counted as padded to "
             f"{clf.cfg.pad_tokens_to}, expected 577 and 584")
    forward = make_forward_fn(clf, "cuda")()
    requests = [rng.integers(0, 256, (BATCH, LONG_IMAGE, LONG_IMAGE, 3), dtype=np.uint8)
                for _ in range(2)]
    per_eval = {"fused_qkv_attention_tiles": depth, "layernorm": 2 * depth + 1,
                "fc1_gelu": depth}
    ops.reset_launch_counts()
    logits = [forward(images) for images in requests]
    counts = ops.launch_counts()
    check_counts(counts, per_eval, len(requests), f"{len(requests)} eval requests at 384 px")
    add(counts)
    with plain_kernels():
        plain_logits = [forward(images) for images in requests]
    if any(got.shape != (BATCH, 2) or got.dtype != np.float32 for got in logits):
        fail(f"eval at 384 px: logits {[(l.shape, l.dtype) for l in logits]}")
    timed(lambda: forward(requests[0]), "eval requests at 384 px (ViT-B/16)", per_eval)

    # BENCH_ATTN_PROJ=1 at 577 tokens: every block folds the output
    # projection into attention, past 256 tokens the composition on the key
    # tiles, and no other attention launch.
    folded = classifier(fold=True)
    if not all(b.attn.proj_fold for b in folded.model.blocks):
        fail("384 px under BENCH_ATTN_PROJ=1: a block does not fold")
    fold_forward = make_forward_fn(folded, "cuda")()
    per_fold_eval = {"fused_attention_proj_tiles": depth, "layernorm": 2 * depth + 1,
                     "fc1_gelu": depth}
    ops.reset_launch_counts()
    fold_logits = [fold_forward(images) for images in requests]
    counts = ops.launch_counts()
    check_counts(counts, per_fold_eval, len(requests),
                 f"{len(requests)} eval requests at 384 px under BENCH_ATTN_PROJ=1")
    add(counts)
    with plain_kernels():
        plain_fold_logits = [fold_forward(images) for images in requests]
    if any(got.shape != (BATCH, 2) or got.dtype != np.float32 for got in fold_logits):
        fail(f"eval at 384 px under BENCH_ATTN_PROJ=1: logits "
             f"{[(l.shape, l.dtype) for l in fold_logits]}")
    # Both bf16 paths' logits against one fp32 forward of the same weights
    # (LONG_LOGITS_RATIO); their share of LOGITS_TOL against the plain bf16
    # path is printed, not held, at 577 tokens.
    ref32 = np.concatenate(plain_fp32_logits(SEED, tree, requests, LONG_IMAGE))
    plains = np.concatenate(plain_logits), np.concatenate(plain_fold_logits)
    for what, got, plain in (("eval forward at 384 px (577 tokens)", logits, plain_logits),
                             ("eval forward at 384 px under BENCH_ATTN_PROJ=1", fold_logits,
                              plain_fold_logits)):
        check = long_logits_check(np.concatenate(got), *plains, ref32)
        share = limit_share(torch.from_numpy(np.concatenate(got)),
                            torch.from_numpy(np.concatenate(plain)), LOGITS_TOL)
        print(f"{what}: logits vs the fp32 forward: max |diff| {check['max_abs_diff']:.3e}, the "
              f"plain bf16 paths' {check['plain_max_abs_diff']:.3e}, ratio {check['ratio']:.3f} "
              f"(limit {LONG_LOGITS_RATIO}); share of LOGITS_TOL vs fp32 "
              f"{check['limit_share']:.3f} (plain {check['plain_limit_share']:.3f}); vs the plain "
              f"bf16 forward {share:.3f} of LOGITS_TOL (not held at 577 tokens); max |logit| "
              f"{float(np.abs(ref32).max()):.3f}")
        if not check["ok"]:
            fail(f"{what}: the logits are {check['ratio']:.3f} times as far from the fp32 "
                 f"forward as the plain bf16 paths' (limit {LONG_LOGITS_RATIO})")
    unfolded = max(float(np.abs(got - ref).max()) for got, ref in zip(fold_logits, logits))
    print(f"eval forward at 384 px under BENCH_ATTN_PROJ=1: vs the unfolded kernels' logits "
          f"{unfolded:.3e}")
    timed(lambda: fold_forward(requests[0]),
          "eval requests at 384 px under BENCH_ATTN_PROJ=1 (ViT-B/16)", per_fold_eval)
    del folded, forward, fold_forward

    # The fine-tune step under each kernel configuration.
    batches = [torch.from_numpy(rng.integers(0, 256, (BATCH, LONG_IMAGE, LONG_IMAGE, 3),
                                             dtype=np.uint8)).cuda() for _ in range(2)]
    labels = torch.from_numpy(rng.integers(0, 2, BATCH)).cuda()
    valid = torch.arange(BATCH, device="cuda") < BATCH - 4
    loss_mode, pos_weight, class_weights = loss_settings([3000, 1000])
    aug = draw_augment_params(BATCH, torch.Generator(device="cuda").manual_seed(SEED + 1))
    for label, overrides, fold in LONG_FT_CONFIGS:
        what = f"fine-tune at 384 px [{label}]"
        clf = classifier(fold, **overrides)
        mlp_route = overrides.get("mlp_fusion", "fc1")
        qkv_ln = overrides.get("qkv_ln_fusion", False)
        routes = {(b.mlp_route, b.qkv_ln, b.attn.proj_fold) for b in clf.model.blocks}
        if routes != {(mlp_route, qkv_ln, fold)}:
            fail(f"{what}: the blocks' routes are {routes}")
        ctx = step_context(clf, loss_mode, pos_weight, class_weights, FT_WEIGHT_DECAY)
        step = make_train_step(ctx)
        state = init_train_state(clf, torch.Generator(device="cuda").manual_seed(SEED))
        full = optim.finetune_lr_scales(state.params, "full", depth)
        wd = optim.no_weight_decay_scales(state.params)
        loss, grads = loss_and_grads(ctx, state, batches[0], labels, valid, aug)
        with plain_kernels():
            plain_loss, plain_grads = loss_and_grads(ctx, state, batches[0], labels, valid, aug)
        check_step_one(loss, grads, plain_loss, plain_grads, FT_LOSS_RTOL, FT_GRAD_RTOL, what)
        del grads, plain_grads
        per_step = {**(fold_tiles if fold else tiles), "layernorm": 2 * depth + 1,
                    "layernorm_backward": 2 * depth + 1,
                    "ln_linear": depth if qkv_ln else 0,
                    {"fc1": "fc1_gelu", "full": "mlp_fused", "full_ln": "mlp_ln_fused"}[
                        mlp_route]: depth,
                    "adamw": -(-len(state.params) // adamw.TENSORS_PER_LAUNCH)}
        calls = iter(range(10 ** 6))
        timed(lambda: step(state, batches[next(calls) % 2], labels, valid, FT_LR, full, wd),  # noqa: B023
              f"{what} steps (ViT-B/16)", per_step)
        if not all(torch.isfinite(p).all() for p in state.params.values()):
            fail(f"{what}: non-finite parameters after the steps")
        del state, ctx, step, clf

    # The MAE pretrain step: the encoder's 145 tokens on qkv_attention.cu,
    # the decoder's 577 (16 heads of 32, bf16 scores) on the key tiles.
    settings = PretrainSettings(batch_size=BATCH, image_size=LONG_IMAGE)
    cfg = model_config(settings)
    if (1 + cfg.len_keep, 1 + cfg.encoder.num_patches) != (145, 577):
        fail(f"pretrain at 384 px: {1 + cfg.len_keep} and {1 + cfg.encoder.num_patches} tokens")
    mae_tree = jax_layout_mae_tree(cfg, rng)
    images = [torch.from_numpy(rng.integers(0, 256, (1, BATCH, LONG_IMAGE, LONG_IMAGE, 3),
                                            dtype=np.uint8)).cuda() for _ in range(2)]
    noise_gen = torch.Generator(device="cuda").manual_seed(SEED)
    noise = [torch.rand((1, BATCH, cfg.encoder.num_patches), generator=noise_gen, device="cuda")
             for _ in range(2)]
    schedule = warmup_cosine(settings.absolute_lr, 20, 2)
    train_step = make_pretrain_step(cfg, 1, settings.weight_decay)
    with projection_fold(False):
        model = MAE(cfg, torch.Generator().manual_seed(SEED))
    model.load_state_dict(mae_state_dict_from_jax(mae_tree, cfg))
    state = init_pretrain_state(model.cuda())
    what = "pretrain at 384 px"
    loss, grads = pretrain_loss_and_grads(state, images[0], noise[0])
    with plain_kernels():
        plain_loss, plain_grads = pretrain_loss_and_grads(state, images[0], noise[0])
    check_step_one(loss, grads, plain_loss, plain_grads, LOSS_RTOL, GRAD_RTOL, what)
    del grads, plain_grads
    calls = iter(range(10 ** 6))

    def pretrain_call():
        i = next(calls)
        train_step(state, images[i % 2], noise[i % 2], schedule(i % 20))

    per_step = {
        "fused_qkv_attention": enc_depth, "fused_qkv_attention_backward": enc_depth,
        "fused_qkv_attention_tiles": dec_depth, "fused_qkv_attention_tiles_backward": dec_depth,
        "qkv_attention_tiles_statistics": dec_depth,
        "layernorm": 2 * (enc_depth + dec_depth) + 2,
        "layernorm_backward": 2 * (enc_depth + dec_depth) + 2,
        "fc1_gelu": enc_depth + dec_depth,
        "adamw": -(-len(state.params) // adamw.TENSORS_PER_LAUNCH)}
    timed(pretrain_call, f"{what} steps (MAE ViT-B/16)", per_step)
    if not all(torch.isfinite(p).all() for p in state.params.values()):
        fail(f"{what}: non-finite parameters after the steps")
    del state, model

    # The same step under BENCH_ATTN_PROJ=1: the decoder's 577 tokens
    # (padded to 584) fold the projection, on the composition past 256
    # tokens; the encoder's 145 stay on the default route.
    with projection_fold(True):
        model = MAE(cfg, torch.Generator().manual_seed(SEED))
    if any(b.attn.proj_fold for b in model.blocks) or not all(
            b.attn.proj_fold for b in model.decoder_blocks):
        fail("pretrain at 384 px under BENCH_ATTN_PROJ=1: the decoder alone should fold")
    model.load_state_dict(mae_state_dict_from_jax(mae_tree, cfg))
    state = init_pretrain_state(model.cuda())
    what = "pretrain at 384 px under BENCH_ATTN_PROJ=1"
    loss, grads = pretrain_loss_and_grads(state, images[0], noise[0])
    with plain_kernels():
        plain_loss, plain_grads = pretrain_loss_and_grads(state, images[0], noise[0])
    check_step_one(loss, grads, plain_loss, plain_grads, LOSS_RTOL, GRAD_RTOL, what)
    del grads, plain_grads
    per_step = {**per_step, "fused_qkv_attention_tiles": 0,
                "fused_qkv_attention_tiles_backward": 0,
                "fused_attention_proj_tiles": dec_depth,
                "fused_attention_proj_tiles_backward": dec_depth}
    timed(pretrain_call, f"{what} steps (MAE ViT-B/16)", per_step)
    if not all(torch.isfinite(p).all() for p in state.params.values()):
        fail(f"{what}: non-finite parameters after the steps")
    del state, model
    print(f"384 px phase {time.perf_counter() - phase_start:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; {CARD}")
    return total


@contextlib.contextmanager
def torch_defaults():
    """torch's own backend settings, as a fresh process (the sweep's) has
    them, in place of this script's (no TF32, no reduced-precision
    reductions), for the duration."""
    flags = (torch.backends.cuda.matmul, "allow_tf32"), (torch.backends.cudnn, "allow_tf32"), \
        (torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction")
    ours = [getattr(owner, name) for owner, name in flags]
    try:
        for (owner, name), value in zip(flags, TORCH_DEFAULTS):
            setattr(owner, name, value)
        yield
    finally:
        for (owner, name), value in zip(flags, ours):
            setattr(owner, name, value)


def config_model(name: str) -> dict:
    """The ``model:`` section of ``config/model/<name>.yaml``."""
    import yaml

    path = Path(__file__).resolve().parent / "config" / "model" / f"{name}.yaml"
    return yaml.safe_load(path.read_text())["model"]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after phase 2 (each kernel against its plain version, with "
                             "its times): no path is driven and no result line is printed")
    parser.add_argument("--rank-worker", metavar="SPEC",
                        help="run as one rank of phase 13, as torch.distributed.run starts it "
                             "(SPEC: the phase's JSON file of arguments)")
    args = parser.parse_args()
    script_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    global TORCH_DEFAULTS
    TORCH_DEFAULTS = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if args.rank_worker:
        rank_worker(args.rank_worker)
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    start = time.perf_counter()
    _build.library()
    print(f"kernels built and loaded in {time.perf_counter() - start:.1f} s "
          f"({_build.library_path()})")

    report = phase_kernels(torch.Generator(device="cuda").manual_seed(SEED))
    if args.kernels_only:
        print(json.dumps({"kernels": [{"name": name, **fields} for name, fields in report.items()]}))
        return
    global NATIVE_BUILD_S
    start = time.perf_counter()
    native.native_available()  # g++ against PIL's libjpeg, then its first-use check
    NATIVE_BUILD_S = time.perf_counter() - start
    # Each path's launches, counted from 0 before it and read after it.
    runs = [phase_eval(torch.Generator().manual_seed(SEED)), phase_pretrain(),
            phase_pretrain_engine(), phase_finetune(),
            phase_attention_ops(torch.Generator().manual_seed(SEED)), phase_eval_cli()]
    with tempfile.TemporaryDirectory() as tmp:
        packs = write_engine_pack(Path(tmp))
        weights = Path(tmp) / "checkpoint_root"
        runs += [phase_finetune_engine(packs), phase_weight_files(packs),
                 phase_mae_finetune(packs)]
        runs.append(phase_pack_tools())
        runs.append(phase_study_sweep(packs, weights))
        runs.append(phase_data_parallel(packs, weights))
    runs.append(phase_native_decode())
    runs.append(phase_fp32())
    runs.append(phase_long_tokens())
    counts = {name: sum(run.get(name, 0) for run in runs) for name in report}
    missing = [name for name, n in counts.items() if n == 0]
    if missing:
        fail(f"no path launched {missing}")
    kernels = [{"name": name, **fields, "launches": counts[name]}
               for name, fields in report.items()]
    print(f"chip_smoke.py wall {time.perf_counter() - script_start:.1f} s, the kernels' build "
          f"included; {CARD}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
