"""Drive the port's few-shot test and train paths (the CLIP-FSAR head, and the classic HyRSM++ and MoLo
heads, on pixels and off frame banks, with no process group and as data-parallel ranks; every shipped project
signature, every CLIP tower and every few-shot head and trunk a config key selects), its classification task
(every video backbone preset), its localization task and MoSI pretraining, its layer_norm op and its clip_mha
stage-ablation tool once on an NVIDIA GPU and check them, and check that every train path repeats bit for bit.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them.  Each path is driven
through the port's CLI with every kernel launch count set to 0 just before it
and read just after.  Phases:

1. device: the card's name and power limit, torch / CUDA versions, and
   whether the host packages the data path needs (yaml, regex, cv2) import;
2. build: compile the CUDA kernels from ``clip_fsar_torch/csrc``, one nvcc
   per source, all started together;
3. K1 vs plain: ``clip_mha_cuda`` against ``clip_mha_reference`` at the ViT
   shapes, which cover both branches of the bf16 tensor-core kernel by name
   (one block of scores up to 256 keys, key tiles above), at ragged lengths
   on each branch, at a length whose K and V stream through shared memory in
   stages, and at the slices' shapes [320, 197, 2304] and [480, 197, 2304]
   bf16; o and lse finite, the same bits on a second launch; at the two
   slice shapes the kernel is timed with CUDA events beside its plain
   version, ``scaled_dot_product_attention``, its bound and the time of the
   scalar kernel it replaced;
4. K2 vs plain: ``clip_mha_bwd_cuda`` against ``clip_mha_bwd_reference`` at
   the same shapes (so ragged lengths, N = 577 with 16 heads, Dh = 32), at
   the last length whose operands stay in shared memory and the first that
   is staged, both branches of the bf16 tensor-core kernel by name, and at
   the train slice's shape [480, 197, 2304] bf16; dqkv finite everywhere,
   the same bits on a second launch; timed at the train shape beside its
   plain version, the backward of ``scaled_dot_product_attention``, its bound
   and the time of the scalar kernel it replaced; and the two kernels'
   gradient in fp32 against torch autograd of plain float64 softmax
   attention at two shapes;
5. K3 vs plain: ``flash_mha_cuda`` against ``flash_mha_reference`` (o and
   lse) at the same ViT shapes as head-split views of a packed projection and
   at cross-attention shapes (Nq 128, Nk 256; Nq 100, Nk 300; Nq 300, Nk 100),
   fp32 and bf16,
   causal and not (so rows that see one key and query blocks whose tiles are
   skipped past the diagonal), o and lse finite, the same bits on a second
   launch; timed at [320, 12, 197, 64] and [480, 12, 197, 64] bf16 like K1;
   then K1 and K3 timed on their tiled branch at the ViT-L/14 shapes
   [320, 257, 3072] and [320, 577, 3072] beside the library call and the bound;
6. K4 / K5 vs plain: ``flash_mha_bwd_dq_cuda`` (dq and delta) and
   ``flash_mha_bwd_dkv_cuda`` against their plain versions at the same
   shapes, causal and not, and in bf16 also on both sides of the length up
   to which the streamed operands stay in shared memory (832 / 833 rows, for
   the keys of the dQ pass and the queries of the dK/dV pass, together and
   one at a time), both branches of the tensor-core kernel by name; dq, dk,
   dv and delta finite, the same bits on a second launch; timed at the train
   chunk's [480, 12, 197, 64] bf16 beside their plain versions, the backward
   of ``scaled_dot_product_attention``, their bounds and the times of the
   scalar kernels they replaced (the script fails unless each is faster);
   and K3 + K4 + K5 in fp32 against torch autograd of float64 softmax
   attention, causal and not;
6a. K6 / K7 vs plain: ``layer_norm_cuda`` and ``layer_norm_bwd_cuda`` against
   their plain versions at the slices' [63040, 768] and [94560, 768] bf16
   (timed at the latter) and at small ragged shapes in fp32 and bf16 with a
   constant row; and K6 + K7 through autograd against float64 autograd of
   the formula;
6b. the LayerNorm replay, the path that runs K6 and K7: the ViT-B/16 few-shot
   model at full width with every LayerNorm module hooked, one eval step
   (320 frames) and one forward and backward of the tower on a 480-frame
   chunk; at every hooked site ``layer_norm`` on the module's own input,
   weight and bias against the module's output (and, for the train shape,
   dx, dg, db against autograd through the module from the same upstream
   gradient); launches counted from 0 against the number of sites; the
   summed time of K6 / K7 against the module's chain;
6c. K8: the three ablated clip_mha kernels against their plain versions at
   small shapes in fp32 and bf16 and at the table's own [320, 197, 2304]
   bf16, the tolerance a share of the reference's largest value (the modes'
   outputs are small on the tool's scaled inputs); then the tool's stage
   table at that shape, launches counted from 0;
6d. the loaders' resize: the native C++ pass must build where g++ exists, and
   one test batch is byte-identical with it and with the numpy replica;
7. test slice: the port's CLI ``main`` on the HMDB51 1-shot config with a
   ViT-B/16 tower at full width (fresh weights from the seed, synthetic
   decoder), 16 episodes in 4 steps of 4, three times: the fused path (K1 in
   every ViT layer of every step), the plain attention path, and
   ``TPU.PALLAS_ATTENTION True`` (K3 in every layer of every step); checks the
   episode count, finite logits, the launches, and both kernel paths' logits
   against the plain path's;
8. train slices: the CLI with TRAIN.ENABLE True on the same config and tower,
   on the fused path and then on the flash path: E = 4 episodes per step in 2
   chunks, BATCH_SIZE_PER_TASK 4, 8 steps (2 Adam updates), validation every
   4 steps, then the test protocol on 16 episodes from the step-8
   checkpoint; checks finite losses, the update count, every kernel's
   launches (every ViT layer of every chunk of every step, and of every eval
   step; none of the other path's kernels) and which checkpoint was tested;
9. the kernels inside the train step: one step's loss and gradients on each
   kernel path against the plain attention path, same weights, batch and
   random draws;
10. the RN50 test slice: the flagship config as shipped, with no backbone
   override (RN50 at 224 px, 8 frames, 5-way 1-shot), 16 episodes in 4 steps
   of 4 (320 frames), in bf16 and again at TPU.COMPUTE_DTYPE float32 on the
   same weights and episodes; the bf16 logits against the fp32 ones;
11. the RN50 train slice: the same config trained as the ViT slices are (E = 4
   in 2 chunks, BATCH_SIZE_PER_TASK 4, 8 steps, validation, checkpoint, test of
   the step-8 checkpoint) with BatchNorm on per-episode batch statistics;
   checks finite losses, 2 updates, and that the checkpoints hold finite
   running stats that moved from their fresh values and between steps 4 and 8.
   Neither RN50 phase launches any kernel: the RN towers' convs, BatchNorm and
   attention pooling are cuDNN and plain torch, as they are XLA in the JAX
   package (no Pallas kernel lies on that path);
12. remat against none at ViT-B/16: one train step (E = 4 in 2 chunks) with
   TPU.REMAT False, True with policy nothing and True with policy dots, on
   the fused and on the flash path, same weights, batch and generator; loss
   and gradients against the step without remat, whether the bits are equal,
   the forward kernel's launches (once more per layer under remat), and each
   step's ms and peak memory;
13. the kernels at the ViT-L/14@336px slice's shapes: K1 and K2 at the frame
   chunk's [120, 577, 3072] bf16, K3, K4 and K5 at its head-split views
   [120, 16, 577, 64], each against its plain version and timed beside it,
   the library call (backward included) and the bound;
14. the ViT-L/14@336px train slice through the CLI: the HMDB51 1-shot config
   at 336 px with 16-frame clips (``VIT_L336_OPTS``: 24 layers of width 1024,
   16 heads, N = 577), TPU.REMAT left at base.yaml's auto and 4 frame chunks;
   E = 2 episodes per step in 2 chunks, BATCH_SIZE_PER_TASK 4, 4 steps (1 Adam
   update), validation at step 4 on 2 episodes, the test protocol on 4
   episodes from the step-4 checkpoint; checks finite losses, the update,
   the tested checkpoint and K1 / K2 launches against the remat schedule
   (three forwards per block per frame chunk per episode chunk per step, one
   per block per frame chunk per eval step, one backward);
15. frame chunks against none at that configuration: one train step at E = 1
   with 4 frame chunks and with none (remat on in both), same weights,
   batch and generator; loss, gradients, whether the bits are equal, ms and
   peak memory of each;
16-17. the classic heads' slices: the shipped HyRSM++ HMDB51 5-shot and MoLo
   HMDB51 1-shot configs as written (torchvision ResNet-50 at 224 px, fresh
   weights, synthetic decoder) through the CLI: E = 4 in 2 chunks, 8 steps (2
   Adam updates), validation at step 8, the test protocol on 8 episodes of the
   step-8 checkpoint, then again in fp32 (bf16 logits against fp32 ones), one
   train step in bf16 against fp32 (loss, picked gradients), the step timed
   with its batch resident beside the host's time to queue it; checks finite
   losses, 2 updates, no kernel launched anywhere (the classic heads reach no
   Pallas kernel in the JAX package either), and the step-8 checkpoint's
   running stats: the trunk's as fresh, MoLo's decoder's moved; and two train
   steps of each run twice from one seed: the same loss bits and parameters;
18. the frame banks against the pixel path, bit for bit, at ViT-B/16's widths:
   12 cv2-written videos through ``cached_opencv`` with the bank grid equal to
   its cache grid; the test protocol on 8 episodes through the CLI with and
   without TPU.EVAL_FRAME_BANK (logits and metrics equal), 2 train steps on
   pixels and off the train bank (loss bits and parameters equal), each step
   also timed with its batch resident, the card's ms beside the host's;
19. the eval bank at full size: the HMDB51 test split (1292 videos x 64 grid
   frames at 224 px, 12.45 GB) built on the card (build and upload seconds);
   the ViT-B/16 test slice over 48 episodes on pixels and off the bank in turn
   (pixel, bank, bank, pixel), the bytes a step copies to the card, the card's
   idle share under the profiler, the peak, the eval step resident, K1's
   launches off the bank; then the shipped HyRSM++ 5-shot config's test loop
   off the same bank (the same split and transform) the same way;
20. the train bank: the ViT-B/16 train slice of phase 8 through the CLI off a
   train bank of the HMDB51 train split (4280 videos x 8 grid frames at 256
   px, 6.73 GB), validating and testing off eval banks; losses, updates, train
   episodes/s against phase 8's fused reading, the peak beside both banks;
21. a reference-framework ``.pyth`` (``model_state``, ``module.head.`` keys)
   written from the fresh ViT-B/16 CLIP-FSAR head and tested through
   TEST.CHECKPOINT_FILE_PATH: the same logits, bit for bit, as that head;
22. data parallel, world 1 over NCCL: the ViT-B/16 train slice of phase 8
   cut to 4 steps (dropout off), validation, the test protocol on 8 episodes,
   through the CLI with no process group and then as the one rank of an NCCL
   group: the same loss bits, trained weights, step-4 checkpoint and test
   logits; the train step with its batch resident timed in the group and
   without, and the gradient all-reduce of one step alone; K1 / K2 launches;
23. data parallel, world 2 over gloo on the one card: the same slice as two
   processes (``chip_smoke.py --dp-worker``), both ranks on card 0, 2 episodes
   a rank: losses, the first step's gradient, the step-4 weights and the test
   logits against phase 22's run without a group at the bf16 tolerances, the
   two ranks' weights bit for bit; each rank under a timeout;
24. classification through the CLI at full width: TAda2D-R50 on Kinetics-400
   (``configs/classification/TAda2D_K400.yaml``, 16 frames at 224 px, global batch
   8, 400 classes, fresh weights, synthetic videos): one epoch of 8 steps on 64
   videos, validation, the checkpoint, the test of that checkpoint on 16 videos
   and the automatic multi-scale re-test at 10 views x 3 crops (480 clips);
   finite losses, 8 updates, top-1 / top-5, 30 clips a video, no kernel
   launched; then on one batch bf16 against fp32 (train-mode logits, one step's
   loss and gradients) and the bf16 train step with its batch resident: CUDA-event
   ms, the host's ms to queue it, the card's busy ms, any synchronisation with the
   device inside it (the script fails on one), train and test clips/s, peak;
25. every other backbone preset at full width (R2D3D, R(2+1)D, irCSN-152, S3D-G,
   SlowFast 4x16 and 8x8 at their 32 frames, TimeSformer, ViViT, the ViViT
   factorized encoder; 16 frames at 224 px otherwise): batch 2, the eval forward's
   logits in bf16 against fp32, one bf16 train step timed, its peak;
26. classification under a process group: the TAda2D run cut to 2 steps and an 8-video
   test through the CLI with no group and as the one rank of an NCCL group: the
   same loss bits, checkpoint and test scores;
27. localization through the CLI at full width: BMN on EPIC-Kitchens-100 features
   (``configs/localization/BMN_EPIC100.yaml``: T = D = 200 windows of 2304 channels,
   N = 32 samples a proposal, the regression and the 97 verb / 300 noun maps; fresh
   weights, synthetic features), one epoch at 8 windows a step, the sliding-window
   test of its checkpoint (mAP of the action, verb and noun streams) and the EPIC
   submission JSON; the mask's build time on the host, finite losses, moved
   parameters, no kernel launched; the card's fp32 forward and loss against the
   CPU's on 2 windows; the train step with its batch resident (CUDA-event ms, the
   host's ms, the card's busy ms, any synchronisation: the script fails on one),
   train and test windows/s, peak;
28. MoSI pretraining through the CLI at full width: R-2D3D-18 on HMDB51
   (``configs/pretrain/MoSI_R2D3D_HMDB51.yaml``: 9 pseudo-motion clips of 16 frames at
   112 px a video, 10 videos a step, bf16), one epoch of 4 steps and the SSL
   validation; on one batch bf16 against fp32 (logits, loss, picked gradients); the
   resident bf16 step as in phase 27, clips/s, peak; one step under LARS; the run
   again without a group and as the one rank of an NCCL group: the three runs' losses,
   trained weights and SSL validation bit for bit (the stem's max-pool backward is the
   gather kernel of ops/pool3d.py, phase 31), and the SSL validation of the same
   weights under the group bit for bit;
29. tensor parallelism at TPU.MESH {DATA: 1, MODEL: 2}: K1 and K2 at one model
   rank's heads of the flagship's train chunk, [480, 197, 1152] bf16, against their
   plain versions, timed beside the library call and the bound; then the ViT-B/16
   test slice (16 episodes, fresh weights), one flash test step, the train cut (E = 2
   a step in 2 chunks, 2 steps, dropout and jitter on, the test of its checkpoint)
   through the CLI, and one fp32 step of one episode (under TPU.REMAT), with no process
   group, and as two gloo processes on card 0 (``chip_smoke.py --tp-worker``):
   bf16 logits and losses at 2e-2, the fp32 loss and picked gradients at 1e-4, the two
   ranks the same bits, K1 / K2 / K3 launched at the local shapes on each rank; per rank
   the peak and the step times (gloo reduces through the host: no tensor-parallel speed);
30. the determinism probe: one train step of every train path above (ViT-B/16 fused
   and flash, RN50, HyRSM++ 5-shot, MoLo 1-shot at one episode; TAda2D-R50 at its
   batch of 8 and the nine other presets at 2; BMN at 2 windows; MoSI at its 10
   videos) at full width under torch.use_deterministic_algorithms(True, warn_only=True):
   the operations torch names as having no deterministic CUDA implementation, by path;
31. the pools' backward kernel (``csrc/pool3d.cu``: max-pool and count-include-pad
   average-pool backward as gathers, no atomics) at every shape phase 30's steps launched
   it at (MoSI's stem, S3D-G's, the SlowFast and R2D3D stems, TAdaConv's pooled
   branches), in the path's dtype and channels_last_3d, from the forward's argmax on
   tied inputs, against its plain version (fp32 1e-6, bf16 1e-2 relative), finite, the
   same bits on a second launch, timed beside its plain version, torch's own atomic
   backward of the same pool (no path runs it) and its bound;
32. the signatures, towers and heads no earlier phase runs, at full width with fresh
   weights: (a) the shipped CLIP-FSAR 5-shot (the test at SHOT_TEST 5, Q 1,
   MERGE_BEFORE), MoLo 5-shot (the test at SHOT_TEST 5), HyRSM++ 1-shot and 2-shot
   (standing for SHOT 2-4) configs through the CLI: 2 train steps of E = 2 in 2 chunks
   (MoLo 5-shot: none), the test protocol on 8 episodes, train and test episodes/s,
   peak, no kernel launched; then on one batch of its loaders bf16 against fp32 (eval
   logits, loss, picked gradients), the resident bf16 step's card ms beside the host's;
   K1-K5 at the train step of one episode of ViT-B/32 (N = 50) and ViT-L/14 at 224 px
   (N = 257) against their plain versions, timed beside the library call and the bound;
   (b) every other CLIP tower under the CLIP-FSAR head (ViT-B/32, ViT-L/14 on the fused
   and the flash path, RN101, RN50x4, RN50x16, RN50x64 at the config's 224 px): one eval
   and one train step of one episode in bf16 against fp32, the launches against the
   blocks' forwards and backwards, the peak (a tower that does not fit at one episode
   is reported with the peak it reached); (c) the heads CNN_HyRSM_1shot, CNN_HyRSM_5shot,
   CNN_HyRSM_plusplus_semi, CNN_TRX, CNN_OTAM, CNN_TSN, CNN_CrossTransformer on the
   HyRSM++ 5-shot config's ResNet-50, and resnet18 / resnet34 under CNN_OTAM: the same;
   each of these paths' train steps also under the determinism probe;
33. the determinism check: every train path was probed and no probe named an
   operation (fails otherwise).

Beside each kernel's time the phases time its plain version and, where one
PyTorch call computes the same function (``scaled_dot_product_attention``
and its backward, ``F.layer_norm`` and its backward, the CUDA backward of
``F.max_pool3d`` / ``F.avg_pool3d``), that call on the same inputs: a
yardstick that no path of the port runs.  ``bound_ms`` is the least
time the card could take: the larger of the bytes the function must move
(each input read once, each output written once) over 3.35 TB/s and its
operations over the card's peak for their type.

The second-to-last line is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises before it.

``python3 chip_smoke.py --cudnn-determinism`` runs none of the phases: it measures what cuDNN's deterministic
convolution algorithms (``runtime.deterministic_convolutions``, under which the few-shot and classification
train steps run) cost each conv-heavy train step, and whether small fp32 MoSI steps repeat without them.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# the test slice: HMDB51 1-shot config, ViT-B/16, synthetic decoder, 16 episodes in steps of 4
from clip_fsar_torch.tools.profile_eval import CONFIG, PLAIN_OPTS, SLICE_OPTS, VIT_L336_OPTS, card

REPO = os.path.dirname(os.path.abspath(__file__))
# (B, N, H, Dh): the ViT-B/32, B/16, L/14, L/14@336px sequence lengths at
# 12 and 16 heads, plus the tiny test tower's Dh = 32, H = 2
KERNEL_SHAPES = [(4, n, h, 64) for n in (50, 197, 257, 577) for h in (12, 16)] + [(4, 17, 2, 32)]
# the text tower's N = 77 at H = 8 (flash_mha also runs it causal); lengths that are no multiple of 8 or 16 on
# the single-block branch (203: 13 sub-tiles of 16 keys, 251: 16) and on the tiled branch (333); and 1100
# keys, which stream through shared memory in two stages
KERNEL_SHAPES += [(4, 77, 8, 64), (2, 203, 4, 64), (2, 251, 4, 32), (2, 333, 3, 32), (1, 1100, 2, 64)]
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # atol = rtol: summation order (fp32); rounding of p, dS and the outputs (bf16)
SLICE_SHAPE = (320, 197, 2304)  # test slice: E=4 episodes x 10 clips x 8 frames, N=197, 3*768
# (B, H, Nq, Nk, Dh) for flash_mha: the same ViT shapes, and cross-attention shapes with Nq < Nk and Nq > Nk
FLASH_SHAPES = [(b, h, n, n, dh) for b, n, h, dh in KERNEL_SHAPES] + [(2, 12, 128, 256, 64), (2, 3, 100, 300, 64), (2, 3, 300, 100, 32)]
FLASH_OPTS = ["TPU.PALLAS_ATTENTION", "True"]

# the train slice: the flagship's E = 4 and BATCH_SIZE_PER_TASK 4; 2 episode chunks so that the
# eager activations (about 26 GB per episode of 240 frames) fit the card's 80 GB
EPISODES, CHUNKS, ACCUM, TRAIN_STEPS, VAL_EVERY, TEST_EPISODES = 4, 2, 4, 8, 4, 16
LAYERS = 12
TRAIN_SHAPE = (EPISODES // CHUNKS * 30 * 8, 197, 2304)  # one chunk: 2 episodes x 30 clips x 8 frames
TRAIN_OPTS = [
    "VIDEO.HEAD.BACKBONE_NAME", "ViT-B/16",
    "TRAIN.ENABLE", "True",
    "DATA.DECODER", "synthetic",
    "TPU.EPISODES_PER_STEP", str(EPISODES),
    "TPU.EPISODE_CHUNKS", str(CHUNKS),
    "TRAIN.BATCH_SIZE_PER_TASK", str(ACCUM),
    "TRAIN.NUM_TRAIN_TASKS", str(TRAIN_STEPS),
    "TRAIN.VAL_FRE_ITER", str(VAL_EVERY),
    "TRAIN.NUM_VAL_TASKS", "4",
    "TPU.EVAL_EPISODES_PER_STEP", "4",
    "TRAIN.NUM_TEST_TASKS", str(TEST_EPISODES),
    "TEST.BATCH_SIZE", "4",
    "LOG_PERIOD", "1",
]
# the RN50 slices: the flagship config as shipped (its BACKBONE_NAME is RN50), fresh weights, synthetic decoder
RN_TEST_OPTS = ["TRAIN.ENABLE", "False", "DATA.DECODER", "synthetic", "TRAIN.NUM_TEST_TASKS", "16", "TEST.BATCH_SIZE", "4"]
RN_TRAIN_OPTS = TRAIN_OPTS[2:]  # the ViT train slice's options less its backbone override
RN_BATCH_NORMS = 3 + 3 * (3 + 4 + 6 + 3) + 4  # stem, three per bottleneck, one per stage's shortcut
# bf16 test logits against fp32 ones on the same weights and episodes, absolute: this script read a largest
# difference of 1.68e-2 on logits up to 7.87 in size (NVIDIA H100 80GB HBM3, 700.00 W)
RN_LOGIT_TOL = 5e-2

# the classic heads' slices: two shipped configs as written (a torchvision ResNet-50 trunk at 224 px, 8 frames,
# 5-way), fresh weights from the seed, the synthetic decoder; E = 4 episodes a step in 2 episode chunks (HyRSM++
# 5-shot: 4 x 40 clips x 8 frames = 1280 frames a step; MoLo 1-shot: 4 x 35 x 8 = 1120), BATCH_SIZE_PER_TASK 4 as
# shipped, 8 steps (2 Adam updates), one validation at step 8, the test protocol on 8 episodes of the step-8 checkpoint
CLASSIC_CONFIGS = {"hyrsm_pp_5shot": os.path.join("configs", "projects", "hyrsmplusplus", "hmdb51", "HyRSMplusplus_HMDB51_5shot_v1.yaml"),
                   "molo_1shot": os.path.join("configs", "projects", "MoLo", "hmdb51", "MoLo_HMDB51_1shot_v1.yaml")}
CLASSIC_STEPS, CLASSIC_TEST_EPISODES = 8, 8
CLASSIC_OPTS = [
    "DATA.DECODER", "synthetic",
    "TPU.EPISODES_PER_STEP", str(EPISODES),
    "TPU.EPISODE_CHUNKS", str(CHUNKS),
    "TRAIN.BATCH_SIZE_PER_TASK", str(ACCUM),
    "TRAIN.NUM_TRAIN_TASKS", str(CLASSIC_STEPS),
    "TRAIN.VAL_FRE_ITER", str(CLASSIC_STEPS),
    "TRAIN.NUM_VAL_TASKS", "4",
    "TPU.EVAL_EPISODES_PER_STEP", "4",
    "TRAIN.NUM_TEST_TASKS", str(CLASSIC_TEST_EPISODES),
    "TEST.BATCH_SIZE", "4",
    "LOG_PERIOD", "1",
]
# bf16 against fp32 on the same weights and episodes, stated before the first run on the card: the test logits
# (negated Bi-MHM distances; near 0 on fresh weights, whose frame features are nearly parallel) to 5e-2 of the
# largest fp32 logit; one train step's loss at 2e-2 and the trunk's last convolution's gradient at GRAD_REL_TOL by
# norm, the tolerances of PERF.md section 2.  The other picked gradients at 2e-1: the head's layers see the
# distances 1 - cos of those nearly parallel features, whose bf16 rounding their gradients magnify, and the trunk's
# first convolution's comes back through all 16 bf16 blocks (a CPU rehearsal at 64 px, 4 frames read 8.4e-2 and
# 7.5e-2).  The step runs in 4 episode chunks so that the fp32 activations of one chunk (280-320 frames of
# ResNet-50) fit beside the weights
CLASSIC_LOGIT_SHARE = 5e-2
CLASSIC_HEAD_GRAD_TOL = 2e-1
CLASSIC_GRAD_CHUNKS = 4
# the gradients held against fp32: the trunk's first and last convolution, and the head's own layers
CLASSIC_PICKED = {"hyrsm_pp_5shot": ("backbone.conv1.weight", "backbone.layer4.2.conv3.weight", "features.layer2.weight",
                                     "features.temporal_atte.w_qs.weight", "features.classification_layer.weight"),
                  "molo_1shot": ("backbone.conv1.weight", "backbone.layer4.2.conv3.weight", "motion_reduce.weight", "up3.conv.weight",
                                 "temporal_atte_before.ff_fc1.weight", "class_token")}

# ms per launch of the scalar-FMA kernels that the tensor-core kernels replaced, by kernel and frames: what this
# script read on an NVIDIA H100 80GB HBM3 at 700.00 W (bf16, N = 197, 12 heads of 64) at commit 8f41df3 (the
# forwards), at commit c522b25 (the clip_mha backward) and at commit 74417cb (the flash_mha backward, K4 with its delta pass)
EARLIER_MS = {"clip_mha_fwd": {320: 3.7873, 480: 5.6240}, "flash_mha_fwd": {320: 2.6949, 480: 4.0259}, "clip_mha_bwd": {480: 13.5792},
              "flash_mha_bwd_dq": {480: 6.1392}, "flash_mha_bwd_dkv": {480: 7.6857},
              "clip_mha_decomp_matmul": {320: 2.5272}, "clip_mha_decomp_exp": {320: 2.6027}, "clip_mha_decomp_nomax": {320: 2.6050}}
# norm-relative gradient error allowed between the kernel and the plain attention path in one bf16 train
# step: each bf16 rounding is ~4e-3 relative, and the two paths round attention at different points
# through 12 layers of backward
GRAD_REL_TOL = 5e-2

# the ViT-L/14@336px train slice: 24 layers, N = 577 (24 x 24 patches of 14 px and the class token), 16 heads of
# 64; E = 2 episodes of 30 clips x 16 frames per step in 2 episode chunks of 480 frames, each in 4 frame chunks
L336_LAYERS, L336_N, L336_HEADS, L336_FRAME_CHUNKS = 24, 577, 16, 4
L336_EPISODES, L336_EP_CHUNKS, L336_STEPS, L336_VAL_EPISODES, L336_TEST_EPISODES = 2, 2, 4, 2, 4
L336_CHUNK_FRAMES = L336_EPISODES // L336_EP_CHUNKS * 30 * 16 // L336_FRAME_CHUNKS  # 120 frames per frame chunk
L336_TRAIN_OPTS = VIT_L336_OPTS + [
    "TRAIN.ENABLE", "True",
    "DATA.DECODER", "synthetic",
    "TPU.EPISODES_PER_STEP", str(L336_EPISODES),
    "TPU.EPISODE_CHUNKS", str(L336_EP_CHUNKS),
    "TRAIN.BATCH_SIZE_PER_TASK", str(ACCUM),
    "TRAIN.NUM_TRAIN_TASKS", str(L336_STEPS),
    "TRAIN.VAL_FRE_ITER", str(L336_STEPS),
    "TRAIN.NUM_VAL_TASKS", str(L336_VAL_EPISODES),
    "TPU.EVAL_EPISODES_PER_STEP", str(L336_VAL_EPISODES),
    "TRAIN.NUM_TEST_TASKS", str(L336_TEST_EPISODES),
    "TEST.BATCH_SIZE", "2",
    "LOG_PERIOD", "1",
]

# published peaks of one H100 SXM (dense): device memory, bf16 tensor cores, fp32 outside them
PEAK_BYTES_PER_S, PEAK_BF16_FLOPS, PEAK_FP32_FLOPS = 3.35e12, 989e12, 67e12
LN_EVAL_SHAPE, LN_TRAIN_SHAPE = (SLICE_SHAPE[0] * 197, 768), (TRAIN_SHAPE[0] * 197, 768)  # every token of a tower call
LN_SMALL_SHAPES = [(197, 256), (1300, 512), (3, 70, 128), (577, 1024), (130, 64)]
# y and dx: summation order (fp32, tests/test_fused_layernorm.py's 1e-5 forward and 2e-4 gradients); one rounding
# of an output of size <= 8 (bf16: half an ulp of 2^-8 relative)
LN_TOLERANCE = {torch.float32: (1e-5, 2e-4), torch.bfloat16: (2e-2, 2e-2)}
DECOMP_SHAPES = [(4, 197, 2304, 12), (4, 50, 1536, 8)]  # (B, N, 3*H*Dh, H): Dh = 64 at two sequence lengths and head counts


def _bound(bytes_moved: float, operations: float, peak_ops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time (ms) the card could take for this many bytes and operations, and which binds."""
    by_bytes, by_ops = bytes_moved / PEAK_BYTES_PER_S * 1e3, operations / peak_ops * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _attention_bound(b: int, n: int, h: int, dh: int, tensors_in: float, tensors_out: float, rows_fp32: int, products: int) -> dict:
    """Bound of an attention kernel on bf16 [b, n, h*dh] tensors: ``tensors_in`` read and ``tensors_out``
    written (in units of one such tensor), ``rows_fp32`` [b, h, n] fp32 vectors (lse, delta) moved, and
    ``products`` [n x n x dh] matrix products per head."""
    bytes_moved = (tensors_in + tensors_out) * b * n * h * dh * 2 + rows_fp32 * b * h * n * 4
    return _bound(bytes_moved, products * 2 * b * h * n * n * dh)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; this script runs on the GPU only")
    smi = card()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    for mod in ("yaml", "regex", "cv2"):
        try:
            importlib.import_module(mod)
            print(f"host package {mod}: ok")
        except ImportError as e:
            print(f"host package {mod}: MISSING ({e})")
    return smi


def phase_build() -> float:
    from clip_fsar_torch.ops import _build
    from clip_fsar_torch.ops.fused_attention import BWD_RESIDENT_MAX, SINGLE_BLOCK_MAX

    t0 = time.perf_counter()
    path = _build.build()
    lib = _build.library()
    seconds = time.perf_counter() - t0
    if lib.attn_fwd_single_block_max() != SINGLE_BLOCK_MAX:
        raise AssertionError(f"the kernels take {lib.attn_fwd_single_block_max()} keys as one block, forward_branch says {SINGLE_BLOCK_MAX}")
    if lib.attn_bwd_resident_max() != BWD_RESIDENT_MAX:
        raise AssertionError(f"the backward keeps {lib.attn_bwd_resident_max()} rows in shared memory, backward_branch says {BWD_RESIDENT_MAX}")
    print(f"build: {seconds:.2f} s -> {os.path.relpath(path, REPO)}")
    with open(os.path.join(os.path.dirname(path), "nvcc.log")) as f:
        for line in f:
            if "Compiling entry function" in line:
                print("  ptxas:", _entry_name(line.split("'")[1]))
            elif "registers" in line or "spill" in line or line.startswith("=="):
                print("  ptxas:", line.strip())
    return seconds


def _entry_name(mangled: str) -> str:
    """A kernel's mangled name cut to what tells it apart: the tensor-core forward's and backward's template
    arguments by name, else the name's start."""
    import re

    if "backward_kernel" in mangled:
        dh, kt, dkv, causal, threads, min_blocks = re.findall(r"EL[ib](\d+)", mangled)[-6:]
        tag = next((t for t in ("clip_mha_bwd", "flash_mha_bwd_dq", "flash_mha_bwd_dkv") if f"{t}_bf16" in mangled), "?")
        return (f"attn_mma::backward_kernel<{tag}> Dh={dh} tile={16 * int(kt)} rows pass={'dK/dV' if int(dkv) else 'dQ'}"
                f"{' causal' if int(causal) else ''} threads={threads} min blocks per SM={min_blocks}")
    if "forward_kernel" in mangled:
        dh, kt, mode, stage, threads, min_blocks = re.findall(r"ELi(\d+)", mangled)[-6:]
        return (f"attn_mma::forward_kernel Dh={dh} sub-tiles={kt} mode={('single', 'online', 'two-pass')[int(mode)]} "
                f"stage={('full', 'matmul', 'exp', 'nomax')[int(stage)]} threads={threads} min blocks per SM={min_blocks}")
    return mangled[:80]


def _time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _alternate(kernel, plain, iters: int = 20) -> tuple:
    """Kernel and plain times (ms), taken kernel, plain, kernel, plain; the better of each pair."""
    k1, p1, k2, p2 = _time_ms(kernel, iters), _time_ms(plain, iters), _time_ms(kernel, iters), _time_ms(plain, iters)
    return min(k1, k2), min(p1, p2), (k1, k2, p1, p2)


def _reset_launches() -> None:
    from clip_fsar_torch.ops import flash_attention, fused_layernorm, pool3d
    from clip_fsar_torch.ops.fused_attention import clip_mha_bwd_cuda, clip_mha_cuda
    from clip_fsar_torch.tools import fa_decomp

    clip_mha_cuda.launches = clip_mha_bwd_cuda.launches = 0
    for counts in (flash_attention.LAUNCHES, fused_layernorm.LAUNCHES, fa_decomp.LAUNCHES, pool3d.LAUNCHES):
        for name in counts:
            counts[name] = 0


def _launches() -> dict:
    """Every kernel's launches since the last reset, by kernel name."""
    from clip_fsar_torch.ops import flash_attention, fused_layernorm, pool3d
    from clip_fsar_torch.ops.fused_attention import clip_mha_bwd_cuda, clip_mha_cuda
    from clip_fsar_torch.tools import fa_decomp

    return {"clip_mha_fwd": clip_mha_cuda.launches, "clip_mha_bwd": clip_mha_bwd_cuda.launches, **flash_attention.LAUNCHES,
            **fused_layernorm.LAUNCHES, **{f"clip_mha_decomp_{mode}": n for mode, n in fa_decomp.LAUNCHES.items()}, **pool3d.LAUNCHES}


def _expect_launches(what: str, got: dict = None, **want: int) -> dict:
    """The launches since the last reset (or ``got``, read earlier); raises unless the named kernels launched ``want``
    times and every other kernel never."""
    got = _launches() if got is None else got
    expected = {name: want.get(name, 0) for name in got}
    if got != expected:
        raise AssertionError(f"{what} launched {got}, expected {expected}")
    return got


def _sdpa_ms(q, k, v) -> float:
    """ms of PyTorch's own fused attention on the same head-split views: the library yardstick of the
    forward kernels, timed here and called nowhere in the port."""
    with torch.no_grad():
        return _time_ms(lambda: F.scaled_dot_product_attention(q, k, v))


def _sdpa_bwd_ms(leaves, do, wrt=None) -> float:
    """ms of the backward of PyTorch's fused attention through autograd, from the output gradient
    ``do`` [B, H, N, Dh] to the gradients of ``wrt`` (default: the q, k, v leaves themselves)."""
    out = F.scaled_dot_product_attention(*leaves)
    return _time_ms(lambda: torch.autograd.grad(out, wrt if wrt is not None else leaves, do, retain_graph=True))


def _check_forward(what: str, run, ref, tol: float) -> float:
    """One forward kernel launch ``run() -> (o, lse)`` against its plain version ``ref()``: o within ``tol``
    (atol = rtol), lse within 1e-4, both finite (rows that see one key, the ragged last query block), and the
    same bits on a second launch (no atomics, a fixed order of sums).  Returns max|o - ref|."""
    o, lse = run()
    torch.cuda.synchronize()
    ref_o, ref_lse = ref()
    err = (o.float() - ref_o.float()).abs().max().item()
    print(f"{what}: max|o-ref| {err:.3e} max|lse-ref| {(lse - ref_lse).abs().max().item():.3e} (tol {tol})")
    if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
        raise AssertionError(f"{what}: o or lse is not finite")
    torch.testing.assert_close(o.float(), ref_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    again_o, again_lse = run()
    if not (torch.equal(again_o, o) and torch.equal(again_lse, lse)):
        raise AssertionError(f"{what}: a second launch gave other bits")
    return err


def _time_forward(name: str, shape_text: str, frames: int, kernel, plain, sdpa_inputs) -> dict:
    """A forward kernel at a slice's shape: kernel and plain version in turn, the library call, and the time
    of the scalar kernel it replaced; fails unless the kernel is the faster of those two."""
    ms, plain_ms, all_ms = _alternate(kernel, plain)
    library_ms = _sdpa_ms(*sdpa_inputs)
    bound = _attention_bound(frames, 197, 12, 64, tensors_in=3, tensors_out=1, rows_fp32=1, products=2)
    earlier = EARLIER_MS[name][frames]
    print(f"{name} {shape_text} bf16: kernel {all_ms[0]:.4f} / {all_ms[1]:.4f} ms (the scalar kernel it replaced: {earlier:.4f} ms, "
          f"{earlier / ms:.1f}x), plain {all_ms[2]:.4f} / {all_ms[3]:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms "
          f"(kernel / library = {ms / library_ms:.2f}), bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; {100 * bound['bound_ms'] / ms:.1f} % of it reached)")
    if not ms < earlier:
        raise AssertionError(f"{name} {shape_text}: {ms:.4f} ms is no faster than the kernel it replaced ({earlier:.4f} ms)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound}


def _forward_record(worst: float, timed: dict) -> dict:
    """The ``kernels`` record of a forward kernel: the test slice's shape under the record's own keys, the
    train chunk's under ``at_480_frames``; every number in it is measured or computed in this run."""
    return {"max_abs_err": worst, **timed[SLICE_SHAPE[0]], "at_480_frames": timed[TRAIN_SHAPE[0]]}


def phase_fwd_vs_plain() -> dict:
    from clip_fsar_torch.ops.fused_attention import _heads_split, clip_mha_cuda, clip_mha_reference, forward_branch

    g = torch.Generator().manual_seed(0)
    worst = 0.0
    timed = {}
    for b, n, h, dh in KERNEL_SHAPES + [(SLICE_SHAPE[0], 197, 12, 64), (TRAIN_SHAPE[0], 197, 12, 64)]:
        for dtype, tol in TOLERANCE.items():
            if b >= SLICE_SHAPE[0] and dtype != torch.bfloat16:
                continue
            qkv = torch.randn(b, n, 3 * h * dh, generator=g).to("cuda", dtype)
            branch = f"{forward_branch(n)} branch" if dtype == torch.bfloat16 else "scalar kernel"
            err = _check_forward(f"K1 clip_mha_fwd [{b},{n},{3 * h * dh}] H={h} Dh={dh} {str(dtype)[6:]} ({branch})",
                                 lambda: clip_mha_cuda(qkv, h), lambda: clip_mha_reference(qkv, h), tol)
            worst = max(worst, err)
        if b >= SLICE_SHAPE[0]:
            timed[b] = _time_forward("clip_mha_fwd", f"[{b}, 197, 2304]", b, lambda: clip_mha_cuda(qkv, 12), lambda: clip_mha_reference(qkv, 12),
                                     _heads_split(qkv, 12))
    return _forward_record(worst, timed)


def phase_bwd_vs_plain() -> dict:
    from clip_fsar_torch.ops.fused_attention import (
        BWD_RESIDENT_MAX,
        _heads_split,
        backward_branch,
        clip_mha,
        clip_mha_bwd_cuda,
        clip_mha_bwd_reference,
        clip_mha_cuda,
    )

    g = torch.Generator().manual_seed(1)
    worst = 0.0
    # KERNEL_SHAPES, the last length whose operands stay in shared memory and the first that is staged, the train chunk
    edge = [(1, BWD_RESIDENT_MAX, 2, 64), (1, BWD_RESIDENT_MAX + 1, 2, 64)]
    for b, n, h, dh in KERNEL_SHAPES + edge + [(TRAIN_SHAPE[0], TRAIN_SHAPE[1], 12, 64)]:
        for dtype, tol in TOLERANCE.items():
            if b == TRAIN_SHAPE[0] and dtype != torch.bfloat16:
                continue
            qkv = torch.randn(b, n, 3 * h * dh, generator=g).to("cuda", dtype)
            do = torch.randn(b, n, h * dh, generator=g).to("cuda", dtype)
            o, lse = clip_mha_cuda(qkv, h)
            dqkv = clip_mha_bwd_cuda(qkv, o, lse, do, h)
            torch.cuda.synchronize()
            ref = clip_mha_bwd_reference(qkv, o, lse, do, h)
            err = (dqkv.float() - ref.float()).abs().max().item()
            branch = f"{backward_branch(n)} branch" if dtype == torch.bfloat16 else "scalar kernels"
            what = f"K2 clip_mha_bwd [{b},{n},{3 * h * dh}] H={h} Dh={dh} {str(dtype)[6:]} ({branch})"
            print(f"{what}: max|dqkv-ref| {err:.3e} (tol {tol})")
            if not torch.isfinite(dqkv.float()).all():
                raise AssertionError(f"{what}: dqkv is not finite")
            torch.testing.assert_close(dqkv.float(), ref.float(), atol=tol, rtol=tol)
            if not torch.equal(clip_mha_bwd_cuda(qkv, o, lse, do, h), dqkv):
                raise AssertionError(f"{what}: a second launch gave other bits")
            worst = max(worst, err)
    ms, plain_ms, all_ms = _alternate(lambda: clip_mha_bwd_cuda(qkv, o, lse, do, 12), lambda: clip_mha_bwd_reference(qkv, o, lse, do, 12))
    # the library yardstick: autograd through fused attention on views of a packed leaf, down to the packed dqkv
    leaf = qkv.detach().requires_grad_(True)
    b, n, _ = TRAIN_SHAPE
    library_ms = _sdpa_bwd_ms(_heads_split(leaf, 12), do.reshape(b, n, 12, 64).transpose(1, 2), wrt=leaf)
    bound = _attention_bound(b, n, 12, 64, tensors_in=5, tensors_out=3, rows_fp32=1, products=5)  # qkv, o, do, lse -> dqkv
    earlier = EARLIER_MS["clip_mha_bwd"][b]
    print(f"K2 clip_mha_bwd {list(TRAIN_SHAPE)} bf16: kernel {all_ms[0]:.4f} / {all_ms[1]:.4f} ms (the scalar kernels it replaced: {earlier:.4f} ms, "
          f"{earlier / ms:.1f}x), plain {all_ms[2]:.4f} / {all_ms[3]:.4f} ms, scaled_dot_product_attention backward {library_ms:.4f} ms "
          f"(kernel / library = {ms / library_ms:.2f}), bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; {100 * bound['bound_ms'] / ms:.1f} % of it reached)")
    if not ms < earlier:
        raise AssertionError(f"clip_mha_bwd {list(TRAIN_SHAPE)}: {ms:.4f} ms is no faster than the kernels it replaced ({earlier:.4f} ms)")
    del leaf

    # the math, independently of the rounding replica: fp32 kernels vs autograd of float64 softmax attention
    for b, n, h, dh in ((4, 197, 12, 64), (2, 577, 16, 64)):
        qkv = torch.randn(b, n, 3 * h * dh, generator=g).to("cuda")
        do = torch.randn(b, n, h * dh, generator=g).to("cuda")
        x = qkv.clone().requires_grad_(True)
        clip_mha(x, h).backward(do)
        y = qkv.double().requires_grad_(True)
        q, k, v = y.reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0)
        out = torch.softmax(q @ k.transpose(-1, -2) * dh**-0.5, dim=-1) @ v
        out.transpose(1, 2).reshape(b, n, h * dh).backward(do.double())
        err = (x.grad.double() - y.grad).abs().max().item()
        print(f"K1+K2 grad vs float64 autograd [{b},{n},{3 * h * dh}] fp32: max abs {err:.3e} (tol 1e-4)")
        torch.testing.assert_close(x.grad.double(), y.grad, atol=1e-4, rtol=1e-4)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound}


def _flash_inputs(b, h, nq, nk, dh, dtype, g) -> tuple:
    """q, k, v on the card: head-split views of one packed [B, N, 3*H*Dh] projection when Nq == Nk (as
    the ViT layers pass them), else contiguous [B, H, N, Dh] tensors."""
    from clip_fsar_torch.ops.attention import split_heads

    if nq == nk:
        qkv = torch.randn(b, nq, 3 * h * dh, generator=g).to("cuda", dtype)
        return tuple(split_heads(t, h) for t in qkv.chunk(3, dim=-1))
    return tuple(torch.randn(b, h, n, dh, generator=g).to("cuda", dtype) for n in (nq, nk, nk))


def _flash_cases():
    """(shape, dtype, tol, causal) at every FLASH_SHAPES entry, fp32 and bf16, causal and not."""
    for shape in FLASH_SHAPES:
        for dtype, tol in TOLERANCE.items():
            for causal in (False, True):
                yield shape, dtype, tol, causal


def phase_flash_fwd_vs_plain() -> dict:
    from clip_fsar_torch.ops.flash_attention import flash_mha_cuda, flash_mha_reference
    from clip_fsar_torch.ops.fused_attention import forward_branch

    g = torch.Generator().manual_seed(2)
    worst = 0.0
    for (b, h, nq, nk, dh), dtype, tol, causal in _flash_cases():
        q, k, v = _flash_inputs(b, h, nq, nk, dh, dtype, g)
        branch = f"{forward_branch(nk)} branch" if dtype == torch.bfloat16 else "scalar kernel"
        err = _check_forward(f"K3 flash_mha_fwd [{b},{h},{nq},{nk},{dh}] {str(dtype)[6:]}{' causal' if causal else ''} ({branch})",
                             lambda: flash_mha_cuda(q, k, v, causal), lambda: flash_mha_reference(q, k, v, causal), tol)
        worst = max(worst, err)
    timed = {}
    for b in (SLICE_SHAPE[0], TRAIN_SHAPE[0]):
        q, k, v = _flash_inputs(b, 12, 197, 197, 64, torch.bfloat16, g)
        timed[b] = _time_forward("flash_mha_fwd", f"[{b}, 12, 197, 64] (views of [{b}, 197, 2304])", b, lambda: flash_mha_cuda(q, k, v),
                                 lambda: flash_mha_reference(q, k, v), (q, k, v))
    return _forward_record(worst, timed)


def phase_tiled_branch_times() -> None:
    """The bf16 forwards on their tiled branch at the ViT-L/14 towers' shapes (N = 257 at 224 px, 577 at
    336 px; 16 heads of 64) for a test step's 320 frames: K1 (two tensor-core passes) and K3 (the online
    recurrence) beside ``scaled_dot_product_attention`` and the bound.  No slice runs these shapes: the
    times are printed and go into no record."""
    from clip_fsar_torch.ops.attention import split_heads
    from clip_fsar_torch.ops.flash_attention import flash_mha_cuda
    from clip_fsar_torch.ops.fused_attention import clip_mha_cuda, forward_branch

    g = torch.Generator().manual_seed(5)
    b, h, dh = SLICE_SHAPE[0], 16, 64
    for n in (257, 577):
        qkv = torch.randn(b, n, 3 * h * dh, generator=g).to("cuda", torch.bfloat16)
        q, k, v = (split_heads(t, h) for t in qkv.chunk(3, dim=-1))
        k1_ms, k3_ms, _ = _alternate(lambda: clip_mha_cuda(qkv, h), lambda: flash_mha_cuda(q, k, v))
        library_ms = _sdpa_ms(q, k, v)
        bound = _attention_bound(b, n, h, dh, tensors_in=3, tensors_out=1, rows_fp32=1, products=2)
        print(f"{forward_branch(n)} branch [{b}, {n}, {3 * h * dh}] H={h} bf16: clip_mha_fwd {k1_ms:.4f} ms, flash_mha_fwd {k3_ms:.4f} ms, "
              f"scaled_dot_product_attention {library_ms:.4f} ms (kernel / library = {k1_ms / library_ms:.2f}, {k3_ms / library_ms:.2f}), "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")


def phase_flash_bwd_vs_plain() -> tuple:
    """K4 (dq and delta) and K5 (dk, dv) against their plain versions; returns the records of both."""
    from clip_fsar_torch.ops.flash_attention import (
        flash_mha,
        flash_mha_bwd_dkv_cuda,
        flash_mha_bwd_dkv_reference,
        flash_mha_bwd_dq_cuda,
        flash_mha_bwd_dq_reference,
        flash_mha_cuda,
    )
    from clip_fsar_torch.ops.fused_attention import BWD_RESIDENT_MAX, backward_branch

    g = torch.Generator().manual_seed(3)
    worst_dq = worst_dkv = 0.0

    def inputs(b, h, nq, nk, dh, dtype, causal):
        q, k, v = _flash_inputs(b, h, nq, nk, dh, dtype, g)
        o, lse = flash_mha_cuda(q, k, v, causal)
        do = torch.empty_like(o).copy_(torch.randn(o.shape, generator=g))  # o's layout, as autograd hands it over
        return q, k, v, o, lse, do

    cases = list(_flash_cases())
    # bf16: the last length the streamed side keeps in shared memory and the first it stages, for both passes
    # at once, for the dQ pass alone (it streams the keys) and for the dK/dV pass alone (the queries)
    m = BWD_RESIDENT_MAX
    edge = [(1, 2, m, m, 64), (1, 2, m + 1, m + 1, 64), (1, 2, 100, m + 1, 64), (1, 2, m + 1, 100, 32)]
    cases += [(shape, torch.bfloat16, TOLERANCE[torch.bfloat16], causal) for shape in edge for causal in (False, True)]
    # the train chunk's own shape, the grid the flash train slice launches: causal first, then as the ViT layers
    # run it, which is also what is timed below on the same tensors
    b, n, _ = TRAIN_SHAPE
    cases += [((b, 12, n, n, 64), torch.bfloat16, TOLERANCE[torch.bfloat16], causal) for causal in (True, False)]
    for (b, h, nq, nk, dh), dtype, tol, causal in cases:
        q, k, v, o, lse, do = inputs(b, h, nq, nk, dh, dtype, causal)
        dq, delta = flash_mha_bwd_dq_cuda(q, k, v, o, lse, do, causal)
        dk, dv = flash_mha_bwd_dkv_cuda(q, k, v, lse, delta, do, causal)
        torch.cuda.synchronize()
        ref_dq, ref_delta = flash_mha_bwd_dq_reference(q, k, v, o, lse, do, causal)
        ref_dk, ref_dv = flash_mha_bwd_dkv_reference(q, k, v, lse, ref_delta, do, causal)
        errs = [(got.float() - want.float()).abs().max().item() for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv))]
        # the dQ pass streams the keys, the dK/dV pass the queries
        branch = f"dQ {backward_branch(nk)}, dK/dV {backward_branch(nq)}" if dtype == torch.bfloat16 else "scalar kernels"
        what = f"K4/K5 flash_mha_bwd [{b},{h},{nq},{nk},{dh}] {str(dtype)[6:]}{' causal' if causal else ''} ({branch})"
        print(f"{what}: max|dq-ref| {errs[0]:.3e} max|dk-ref| {errs[1]:.3e} max|dv-ref| {errs[2]:.3e} "
              f"max|delta-ref| {(delta - ref_delta).abs().max().item():.3e} (tol {tol})")
        if not all(torch.isfinite(t.float()).all() for t in (dq, dk, dv, delta)):
            raise AssertionError(f"{what}: dq, dk, dv or delta is not finite")
        torch.testing.assert_close(delta, ref_delta, atol=1e-4, rtol=1e-4)
        for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        again_dq, again_delta = flash_mha_bwd_dq_cuda(q, k, v, o, lse, do, causal)
        again = (again_dq, again_delta, *flash_mha_bwd_dkv_cuda(q, k, v, lse, again_delta, do, causal))
        if not all(torch.equal(x, y) for x, y in zip(again, (dq, delta, dk, dv))):
            raise AssertionError(f"{what}: a second launch gave other bits")
        worst_dq, worst_dkv = max(worst_dq, errs[0]), max(worst_dkv, *errs[1:])

    del ref_dq, ref_dk, ref_dv, again, again_dq
    b, n, _ = TRAIN_SHAPE  # q, k, v, o, lse, do and delta are the last case's, just held against the plain versions
    dq_ms, dq_plain_ms, dq_all = _alternate(lambda: flash_mha_bwd_dq_cuda(q, k, v, o, lse, do),
                                            lambda: flash_mha_bwd_dq_reference(q, k, v, o, lse, do))
    dkv_ms, dkv_plain_ms, dkv_all = _alternate(lambda: flash_mha_bwd_dkv_cuda(q, k, v, lse, delta, do),
                                               lambda: flash_mha_bwd_dkv_reference(q, k, v, lse, delta, do))
    fwd_ms = _time_ms(lambda: flash_mha_cuda(q, k, v))
    shape = f"[{b},12,{n},64] bf16 (views of {list(TRAIN_SHAPE)})"
    # one library call computes dq, dk and dv together: its time stands beside K4 and beside K5, and is to be
    # held against their sum
    library_ms = _sdpa_bwd_ms([t.detach().requires_grad_(True) for t in (q, k, v)], do)
    dq_bound = _attention_bound(b, n, 12, 64, tensors_in=5, tensors_out=1, rows_fp32=2, products=3)  # q, k, v, o, do, lse -> dq, delta
    dkv_bound = _attention_bound(b, n, 12, 64, tensors_in=4, tensors_out=2, rows_fp32=2, products=4)  # q, k, v, do, lse, delta -> dk, dv
    for name, what, ms, all_ms, bound in (("flash_mha_bwd_dq", "K4 flash_mha_bwd_dq (dq and delta)", dq_ms, dq_all, dq_bound),
                                          ("flash_mha_bwd_dkv", "K5 flash_mha_bwd_dkv", dkv_ms, dkv_all, dkv_bound)):
        earlier = EARLIER_MS[name][b]
        print(f"{what} {shape}: kernel {all_ms[0]:.4f} / {all_ms[1]:.4f} ms (the scalar kernel it replaced: {earlier:.4f} ms, {earlier / ms:.1f}x), "
              f"plain {all_ms[2]:.4f} / {all_ms[3]:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
              f"{100 * bound['bound_ms'] / ms:.1f} % of it reached)")
        if not ms < earlier:
            raise AssertionError(f"{name} {shape}: {ms:.4f} ms is no faster than the kernel it replaced ({earlier:.4f} ms)")
    print(f"K3 flash_mha_fwd {shape}: kernel {fwd_ms:.4f} ms ((K4 + K5) / K3 = {(dq_ms + dkv_ms) / fwd_ms:.2f})")
    print(f"K4 + K5 {shape}: kernels {dq_ms + dkv_ms:.4f} ms, scaled_dot_product_attention backward (dq, dk, dv) {library_ms:.4f} ms "
          f"(kernels / library = {(dq_ms + dkv_ms) / library_ms:.2f})")
    # the causal mask at the text tower's length: one CTA owns a (clip, head), so its late query blocks carry most of the work
    both = {}
    for causal in (True, False):
        qc, kc, vc, oc, lsec, doc = inputs(b, 8, 77, 77, 64, torch.bfloat16, causal)
        _, dc = flash_mha_bwd_dq_cuda(qc, kc, vc, oc, lsec, doc, causal)
        both[causal] = _time_ms(lambda: (flash_mha_bwd_dq_cuda(qc, kc, vc, oc, lsec, doc, causal), flash_mha_bwd_dkv_cuda(qc, kc, vc, lsec, dc, doc, causal)))
    print(f"K4 + K5 [{b},8,77,64] bf16: causal {both[True]:.4f} ms, not causal {both[False]:.4f} ms (causal / not = {both[True] / both[False]:.2f}; "
          f"half the products are masked)")

    # the math, independently of the rounding replica: fp32 kernels vs autograd of float64 softmax attention
    for b, h, nq, nk, dh in ((4, 12, 197, 197, 64), (2, 12, 128, 256, 64)):
        for causal in (False, True):
            q, k, v = _flash_inputs(b, h, nq, nk, dh, torch.float32, g)
            do = torch.randn(b, h, nq, dh, generator=g).to("cuda")
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            flash_mha(*leaves, causal=causal).backward(do)
            ref = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
            s = ref[0] @ ref[1].transpose(-1, -2) * dh**-0.5
            if causal:
                s = s.masked_fill(torch.ones(nq, nk, dtype=torch.bool, device="cuda").triu(1), float("-inf"))
            (torch.softmax(s, dim=-1) @ ref[2]).backward(do.double())
            err = max((x.grad.double() - y.grad).abs().max().item() for x, y in zip(leaves, ref))
            print(f"K3+K4+K5 grad vs float64 autograd [{b},{h},{nq},{nk},{dh}] fp32{' causal' if causal else ''}: max abs {err:.3e} (tol 1e-4)")
            for x, y in zip(leaves, ref):
                torch.testing.assert_close(x.grad.double(), y.grad, atol=1e-4, rtol=1e-4)
    covers = "flash_mha_bwd_dq + flash_mha_bwd_dkv"
    return ({"max_abs_err": worst_dq, "ms": dq_ms, "plain_ms": dq_plain_ms, "library_ms": library_ms, "library_covers": covers, **dq_bound},
            {"max_abs_err": worst_dkv, "ms": dkv_ms, "plain_ms": dkv_plain_ms, "library_ms": library_ms, "library_covers": covers, **dkv_bound})


def _ln_inputs(shape, dtype, g, constant_row: bool = False) -> tuple:
    """x, dy in ``dtype`` and fp32 weight and bias on the card, from the generator; optionally row 1
    of x holds one value (its variance is 0 up to rounding and is clamped)."""
    d = shape[-1]
    x = torch.randn(*shape, generator=g) * 2.0 + 0.5
    if constant_row:
        x.reshape(-1, d)[1] = 2.5
    return (x.to("cuda", dtype), (torch.rand(d, generator=g) + 0.5).cuda(), torch.randn(d, generator=g).cuda(),
            torch.randn(*shape, generator=g).to("cuda", dtype))


def phase_layer_norm_vs_plain() -> tuple:
    """K6 and K7 against their plain versions; returns the records of both."""
    from clip_fsar_torch.ops.fused_layernorm import layer_norm, layer_norm_bwd_cuda, layer_norm_bwd_reference, layer_norm_cuda, layer_norm_reference

    g = torch.Generator().manual_seed(4)
    worst_fwd = worst_bwd = 0.0
    cases = [(shape, dtype) for shape in LN_SMALL_SHAPES for dtype in LN_TOLERANCE] + [(LN_EVAL_SHAPE, torch.bfloat16), (LN_TRAIN_SHAPE, torch.bfloat16)]
    for shape, dtype in cases:
        y_tol, dx_tol = LN_TOLERANCE[dtype]
        x, w, b, dy = _ln_inputs(shape, dtype, g, constant_row=True)
        y = layer_norm_cuda(x, w, b)
        dx, dg, db = layer_norm_bwd_cuda(x, w, dy)
        torch.cuda.synchronize()
        ref_y = layer_norm_reference(x, w, b)
        ref_dx, ref_dg, ref_db = layer_norm_bwd_reference(x, w, dy)
        rows = x.numel() // shape[-1]
        # dg, db: fp32 sums of `rows` terms of size ~1 taken in another order than torch's; the error grows as
        # sqrt(rows) roundings of the running sum (~sqrt(rows) * |sum| * 6e-8), far below this
        sum_tol = 1e-4 * max(1.0, rows**0.5)
        errs = [(a.float() - r.float()).abs().max().item() for a, r in ((y, ref_y), (dx, ref_dx), (dg, ref_dg), (db, ref_db))]
        print(f"K6/K7 layer_norm {list(shape)} {str(dtype)[6:]}: max|y-ref| {errs[0]:.3e} (atol = rtol = {y_tol}) max|dx-ref| {errs[1]:.3e} "
              f"(atol = rtol = {dx_tol}) max|dg-ref| {errs[2]:.3e} max|db-ref| {errs[3]:.3e} (atol {sum_tol:.1e}, rtol 1e-4)")
        torch.testing.assert_close(y.float(), ref_y.float(), atol=y_tol, rtol=y_tol)
        torch.testing.assert_close(dx.float(), ref_dx.float(), atol=dx_tol, rtol=dx_tol)
        torch.testing.assert_close(dg, ref_dg, atol=sum_tol, rtol=1e-4)
        torch.testing.assert_close(db, ref_db, atol=sum_tol, rtol=1e-4)
        if not (y.reshape(-1, shape[-1])[1].float() - b).abs().max().item() <= y_tol * (1 + b.abs().max().item()):
            raise AssertionError("the constant row did not normalise to the bias")
        worst_fwd, worst_bwd = max(worst_fwd, errs[0]), max(worst_bwd, errs[1])
        # the same result on every run: fixed-order sums, no atomics
        again = layer_norm_bwd_cuda(x, w, dy)
        if not all(torch.equal(a, r) for a, r in zip(again, (dx, dg, db))):
            raise AssertionError(f"layer_norm_bwd_cuda {list(shape)} is not deterministic")

    # x, w, b, dy are now the train chunk's [94560, 768] bf16
    rows, d = LN_TRAIN_SHAPE
    fwd_ms, fwd_plain_ms, fwd_all = _alternate(lambda: layer_norm_cuda(x, w, b), lambda: layer_norm_reference(x, w, b))
    bwd_ms, bwd_plain_ms, bwd_all = _alternate(lambda: layer_norm_bwd_cuda(x, w, dy), lambda: layer_norm_bwd_reference(x, w, dy))
    # the library yardstick, timed and used nowhere else: F.layer_norm (two-pass variance) and its backward
    with torch.no_grad():
        fwd_library_ms = _time_ms(lambda: F.layer_norm(x, (d,), w.to(x.dtype), b.to(x.dtype), 1e-5))
    leaves = [x.detach().requires_grad_(True), w.to(x.dtype).requires_grad_(True), b.to(x.dtype).requires_grad_(True)]
    out = F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], 1e-5)
    bwd_library_ms = _time_ms(lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True))
    del out, leaves
    fwd_bound = _bound(2 * rows * d * 2 + 2 * d * 4, 8 * rows * d, PEAK_FP32_FLOPS)  # x in, y out, g and b in; ~8 fp32 operations an element
    bwd_bound = _bound(3 * rows * d * 2 + 3 * d * 4, 20 * rows * d, PEAK_FP32_FLOPS)  # x, dy in, dx out, g in, dg and db out
    print(f"K6 layer_norm_fwd {list(LN_TRAIN_SHAPE)} bf16: kernel {fwd_all[0]:.4f} / {fwd_all[1]:.4f} ms, plain {fwd_all[2]:.4f} / {fwd_all[3]:.4f} ms, "
          f"F.layer_norm {fwd_library_ms:.4f} ms, bound {fwd_bound['bound_ms']:.4f} ms ({fwd_bound['bound_by']})")
    print(f"K7 layer_norm_bwd {list(LN_TRAIN_SHAPE)} bf16: kernel {bwd_all[0]:.4f} / {bwd_all[1]:.4f} ms, plain {bwd_all[2]:.4f} / {bwd_all[3]:.4f} ms, "
          f"F.layer_norm backward {bwd_library_ms:.4f} ms, bound {bwd_bound['bound_ms']:.4f} ms ({bwd_bound['bound_by']})")

    # the math, independently of the rounding replica: fp32 K6 + K7 through autograd vs float64 autograd of the
    # two-pass formula, with a dy that autograd hands over non-contiguous (a transposed view)
    for shape in ((197, 768), (3, 70, 128), (577, 1024)):
        x, w, b, dy = _ln_inputs(shape, torch.float32, g)
        dy = dy.repeat_interleave(2, dim=-1)[..., ::2]  # the same values behind a stride of 2
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        layer_norm(*leaves).backward(dy)
        ref = [t.double().requires_grad_(True) for t in (x, w, b)]
        mu = ref[0].mean(-1, keepdim=True)
        ((ref[0] - mu) / torch.sqrt(ref[0].var(-1, unbiased=False, keepdim=True) + 1e-5) * ref[1] + ref[2]).backward(dy.double())
        err = max((a.grad.double() - r.grad).abs().max().item() for a, r in zip(leaves, ref))
        print(f"K6+K7 grad vs float64 autograd {list(shape)} fp32 (dy contiguous: {dy.is_contiguous()}): max abs {err:.3e} (tol 1e-4)")
        for a, r in zip(leaves, ref):
            torch.testing.assert_close(a.grad.double(), r.grad, atol=1e-4, rtol=1e-4)
    return ({"max_abs_err": worst_fwd, "ms": fwd_ms, "plain_ms": fwd_plain_ms, "library_ms": fwd_library_ms, **fwd_bound},
            {"max_abs_err": worst_bwd, "ms": bwd_ms, "plain_ms": bwd_plain_ms, "library_ms": bwd_library_ms, **bwd_bound})


class _Span:
    """CUDA-event time of a ``with`` block, added to ``totals[key]`` when read after a synchronise."""

    pending: list = []

    def __init__(self, key: str):
        self.key, self.start, self.end = key, torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        self.start.record()

    def __exit__(self, *exc):
        self.end.record()
        _Span.pending.append(self)

    @classmethod
    def collect(cls) -> dict:
        torch.cuda.synchronize()
        totals: dict = {}
        for span in cls.pending:
            totals[span.key] = totals.get(span.key, 0.0) + span.start.elapsed_time(span.end)
        cls.pending = []
        return totals


def _replay_sites(sites: list, what: str, backward: bool) -> dict:
    """At every recorded LayerNorm site (module, x, y[, dy]): ``layer_norm`` on the module's own input and
    parameters against the module's output and, with ``backward``, its dx, dg, db against autograd through
    the module's chain from the same upstream gradient.  Launches are counted from 0 against the sites.
    Returns the launches and the summed CUDA-event times of the kernels and of the module's chain."""
    from clip_fsar_torch.ops.fused_layernorm import layer_norm

    worst = {"y": 0.0, "dx": 0.0, "dx_rel": 0.0, "dx_norm": 0.0, "dg": 0.0, "db": 0.0}
    dx_sizes = []  # per site: (median |dx|, the absolute tolerance its elements were held to)
    _reset_launches()
    for name, module, x, y, dy in sites:
        y_tol, dx_tol = LN_TOLERANCE[x.dtype]
        chain_leaves = [x.detach().requires_grad_(backward), module.weight, module.bias]
        kernel_leaves = [x.detach().requires_grad_(backward), module.weight.detach().requires_grad_(backward),
                         module.bias.detach().requires_grad_(backward)]
        with torch.set_grad_enabled(backward):
            with _Span("chain_fwd"):
                chain_y = module.forward(chain_leaves[0])  # the module's chain, past its hooks
            with _Span("kernel_fwd"):
                kernel_y = layer_norm(*kernel_leaves, module.eps)
        if not torch.equal(chain_y, y):
            raise AssertionError(f"{what} {name}: the module's chain does not reproduce its own output")
        worst["y"] = max(worst["y"], (kernel_y.float() - y.float()).abs().max().item())
        torch.testing.assert_close(kernel_y.float(), y.float(), atol=y_tol, rtol=y_tol, msg=lambda m, name=name: f"{what} {name} y: {m}")
        if not backward:
            continue
        with _Span("chain_bwd"):
            want = torch.autograd.grad(chain_y, chain_leaves, dy)
        with _Span("kernel_bwd"):
            got = torch.autograd.grad(kernel_y, kernel_leaves, dy)
        rows = x.numel() // x.shape[-1]
        # dg, db sum `rows` bf16-rounded dy terms in fp32 in another order; scale the tolerance to the sums' size
        scale = max(1.0, want[1].abs().max().item(), want[2].abs().max().item())
        dx_size = max(1.0, want[0].float().abs().max().item())  # dx is not of size 1 here: the tolerance follows its size
        dx_atol = dx_tol * dx_size
        worst["dx_rel"] = max(worst["dx_rel"], (got[0].float() - want[0].float()).abs().max().item() / dx_size)
        # the elementwise tolerance follows the site's largest |dx| and may exceed its typical |dx|, so dx is
        # also held as a whole: the error's norm within dx_tol of dx's norm, which a mis-scaled dx cannot meet
        dx_norm = ((got[0].float() - want[0].float()).norm() / want[0].float().norm()).item()
        worst["dx_norm"] = max(worst["dx_norm"], dx_norm)
        dx_sizes.append((want[0].float().abs().median().item(), dx_atol))
        if not dx_norm <= dx_tol:
            raise AssertionError(f"{what} {name} dx: |dx - autograd| / |autograd| = {dx_norm:.3e} over the site, above {dx_tol}")
        for key, a, r, atol, rtol in (("dx", got[0], want[0], dx_atol, dx_tol), ("dg", got[1], want[1], 1e-3 * scale, 1e-3),
                                      ("db", got[2], want[2], 1e-3 * scale, 1e-3)):
            worst[key] = max(worst[key], (a.float() - r.float()).abs().max().item())
            torch.testing.assert_close(a.float(), r.float(), atol=atol, rtol=rtol, msg=lambda m, name=name, key=key: f"{what} {name} {key} ({rows} rows): {m}")
    times = _Span.collect()
    want_launches = {"layer_norm_fwd": len(sites), **({"layer_norm_bwd": len(sites)} if backward else {})}
    launches = _expect_launches(f"the LayerNorm replay, {what} ({len(sites)} sites)", **want_launches)
    print(f"LayerNorm replay, {what}: {len(sites)} sites, launches {want_launches}; max|y - module| {worst['y']:.3e}"
          + (f", max|dx - autograd| {worst['dx']:.3e} ({worst['dx_rel']:.3e} of the site's largest |dx|; tol {LN_TOLERANCE[torch.bfloat16][1]}), "
             f"norm of the error over the norm of dx at most {worst['dx_norm']:.3e} (tol {LN_TOLERANCE[torch.bfloat16][1]}), "
             f"median |dx| per site {min(m for m, _ in dx_sizes):.3e} to {max(m for m, _ in dx_sizes):.3e} "
             f"beside elementwise tolerances of {min(a for _, a in dx_sizes):.3e} to {max(a for _, a in dx_sizes):.3e}, "
             f"max|dg - autograd| {worst['dg']:.3e}, max|db - autograd| {worst['db']:.3e}" if backward else "")
          + f"; summed over the sites: K6 {times['kernel_fwd']:.3f} ms vs the module's chain {times['chain_fwd']:.3f} ms"
          + (f", K7 {times['kernel_bwd']:.3f} ms vs the chain's backward {times['chain_bwd']:.3f} ms" if backward else ""))
    return {"launches": launches, "times": times}


def phase_layer_norm_replay() -> dict:
    """The path that runs K6 and K7: every LayerNorm site of the ViT-B/16 few-shot model, in one eval step
    (320 frames) and in one forward and backward of the tower on a 480-frame chunk.  The model's own
    forward is untouched: the hooks only record.  Returns the launches of both shapes together."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.models.clip.model import LayerNorm
    from clip_fsar_torch.tools.profile_eval import slice_cfg
    from clip_fsar_torch.train.step import make_eval_step

    dev = runtime.device("cuda")
    cfg = slice_cfg()
    model = build_few_shot_model(cfg, flow="test", device=dev)
    norms = {name: m for name, m in model.head.named_modules() if isinstance(m, LayerNorm)}
    tower = [name for name in norms if name.startswith("backbone.")]
    if len(tower) != 2 * LAYERS + 2:
        raise AssertionError(f"expected ln_pre, {LAYERS} x (ln_1, ln_2) and ln_post in the tower, found {tower}")
    sites: list = []

    def record(name):
        def hook(module, inputs, output):
            site = [name, module, inputs[0].detach(), output.detach(), None]
            if output.requires_grad:
                output.register_hook(lambda grad, site=site: site.__setitem__(4, grad.detach()))
            sites.append(site)
        return hook

    handles = [m.register_forward_hook(record(name)) for name, m in norms.items()]
    with build_few_shot_loader(cfg, "test", num_steps=1, episodes_per_step=4) as loader:
        batch = next(iter(loader)).to(dev)
    make_eval_step(model.head, cfg, model.text_train, model.text_test)(batch)
    fired = {site[0] for site in sites}
    print(f"LayerNorm replay: {len(norms)} LayerNorm modules, {len(fired)} reached by the eval step in {len(sites)} calls; "
          f"not reached: {sorted(set(norms) - fired)}")
    if not set(tower) <= fired or not any(not name.startswith(("backbone.", "text.")) for name in fired):
        raise AssertionError(f"the eval step did not reach every tower LayerNorm and the head's: {sorted(fired)}")
    if max(site[2].numel() for site in sites) != LN_EVAL_SHAPE[0] * LN_EVAL_SHAPE[1]:
        raise AssertionError("no LayerNorm site saw the whole [320 x 197, 768] batch")
    eval_run = _replay_sites(sites, "eval step of 320 frames", backward=False)
    del batch
    sites.clear()

    g = torch.Generator().manual_seed(5)
    frames = torch.randn(TRAIN_SHAPE[0], 224, 224, 3, generator=g).to(dev, torch.bfloat16)
    out = model.head.backbone(frames)
    out.backward(torch.randn(out.shape, generator=g).to(dev, out.dtype))
    for h in handles:
        h.remove()
    if [site[0] for site in sites] != tower or any(site[4] is None for site in sites):
        raise AssertionError(f"the tower's forward and backward did not reach its {len(tower)} LayerNorm sites once each with a gradient")
    model.head.zero_grad(set_to_none=True)
    train_run = _replay_sites(sites, "tower forward and backward of 480 frames", backward=True)
    sites.clear()
    del model, out, frames
    torch.cuda.empty_cache()
    launches = {name: eval_run["launches"][name] + train_run["launches"][name] for name in ("layer_norm_fwd", "layer_norm_bwd")}
    return {"launches": launches, "eval": eval_run["times"], "train": train_run["times"]}


def phase_fa_decomp(card_line: str) -> dict:
    """K8: the ablated clip_mha kernels against their plain versions, then the tool's table at the test
    slice's shape with the launches counted from 0.  Returns one record per ablated mode."""
    from clip_fsar_torch.tools import fa_decomp

    worst = {mode: 0.0 for mode in fa_decomp.ABLATED}

    def compare(qkv, h, mode, tol) -> None:
        o = fa_decomp.fa_decomp_cuda(qkv, h, mode)
        torch.cuda.synchronize()
        ref = fa_decomp.fa_decomp_reference(qkv, h, mode)
        what = f"K8 clip_mha_decomp[{mode}] {list(qkv.shape)} H={h} {str(qkv.dtype)[6:]}"
        err = (o.float() - ref.float()).abs().max().item()
        rel = fa_decomp.assert_close_to_scale(o, ref, tol, what)
        print(f"{what}: max|o-ref| {err:.3e} = {rel:.3e} of max|ref| {ref.float().abs().max().item():.3e} (tol {tol} of max|ref|)")
        worst[mode] = max(worst[mode], err)

    for b, n, d3, h in DECOMP_SHAPES:
        for dtype, tol in TOLERANCE.items():
            qkv = fa_decomp.make_qkv((b, n, d3), dtype, seed=n)
            for mode in fa_decomp.ABLATED:
                compare(qkv, h, mode, tol)
    qkv = fa_decomp.make_qkv(SLICE_SHAPE)  # the shape and input of the table below
    for mode in fa_decomp.ABLATED:
        compare(qkv, 12, mode, TOLERANCE[torch.bfloat16])
    _reset_launches()
    ms = fa_decomp.report(SLICE_SHAPE, print, card_line)
    per_mode = 1 + 10 * 3  # the tool's warm-up launch, then 10 launches in each of 3 rounds
    launches = _expect_launches("the fa_decomp table", clip_mha_fwd=per_mode, **{f"clip_mha_decomp_{mode}": per_mode for mode in fa_decomp.ABLATED})
    b, n, _ = SLICE_SHAPE
    bound = _attention_bound(b, n, 12, 64, tensors_in=3, tensors_out=1, rows_fp32=0, products=2)  # K1's work less the lse
    print("fa_decomp: the scalar kernels these modes replaced took " + ", ".join(
        f"{mode} {EARLIER_MS[f'clip_mha_decomp_{mode}'][b]:.4f} ms" for mode in fa_decomp.ABLATED) + f", full {EARLIER_MS['clip_mha_fwd'][b]:.4f} ms")
    return {mode: {"max_abs_err": worst[mode], "ms": ms[mode], "plain_ms": _time_ms(lambda m=mode: fa_decomp.fa_decomp_reference(qkv, 12, m), iters=5),
                   "library_ms": None, "launches": launches[f"clip_mha_decomp_{mode}"], **bound} for mode in fa_decomp.ABLATED}


def phase_loader_resize() -> None:
    """The loaders' resize: with g++ on the machine the native C++ pass must have built and loaded; one
    test batch of 4 episodes is byte-identical with it and with the numpy replica."""
    from clip_fsar_torch.data import transforms
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.native import frameops
    from clip_fsar_torch.tools.profile_eval import slice_cfg

    have_gxx = shutil.which("g++") is not None
    if have_gxx and not frameops.available():
        raise AssertionError(f"g++ is on this machine but the native frameops library is not loaded: {frameops.failure()}")
    print(f"loader resize: g++ {'found' if have_gxx else 'not found'}; native frameops "
          + (f"loaded ({frameops.num_threads()} OpenMP threads per clip, {os.cpu_count()} cores)" if frameops.available()
             else f"unavailable ({frameops.failure()}): the transforms run the numpy replica"))

    def one_batch():
        with build_few_shot_loader(slice_cfg(), "test", num_steps=1, episodes_per_step=4) as loader:
            return next(iter(loader))

    before = dict(transforms.RESIZE_CALLS)
    first = one_batch()
    frameops.set_enabled(False)
    try:
        second = one_batch()
    finally:
        frameops.set_enabled(True)
    took = {k: transforms.RESIZE_CALLS[k] - before[k] for k in before}
    if took["numpy"] == 0 or (frameops.available() and took["native"] == 0):
        raise AssertionError(f"the two batches did not go through both resize implementations: {took}")
    fields = [name for name, a in vars(first).items() if a is not None]
    for name in fields:
        if not np.array_equal(np.asarray(getattr(first, name)), np.asarray(getattr(second, name))):
            raise AssertionError(f"episode field {name} differs between the native resize and the numpy replica")
    print(f"loader resize: one batch of 4 episodes with each implementation ({took} clips), fields {fields} identical")


def run_test_slice(extra_opts, out_dir: str, base_opts=SLICE_OPTS) -> dict:
    from clip_fsar_torch.runs.run import main

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = main(["--cfg", CONFIG, *base_opts, "OUTPUT_DIR", out_dir, *extra_opts])["test_few_shot"]
    torch.cuda.synchronize()
    stats["wall_seconds"] = time.perf_counter() - t0
    stats["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    _check_test_stats(stats)
    frames = 16 * 10 * 8
    print(f"test slice {extra_opts or 'default'}: top1 {stats['top1_acc']:.2f} loss {stats['loss']:.5f}; "
          f"{16 / stats['seconds']:.3f} episodes/s, {frames / stats['seconds']:.1f} frames/s over the {stats['seconds']:.2f} s "
          f"episode loop ({stats['wall_seconds']:.2f} s with the model build); "
          f"peak memory {stats['max_memory_allocated'] / 2**30:.3f} GiB")
    return stats


def _check_test_stats(stats: dict, episodes: int = 16) -> None:
    logits = stats["episode_logits"]
    if logits.shape != (episodes, 5, 5):
        raise AssertionError(f"expected logits for {episodes} episodes of 5 queries x 5 ways, got {logits.shape}")
    if stats["episodes"] != episodes:
        raise AssertionError(f"expected metrics for {episodes} episodes, got {stats['episodes']}")
    if not torch.isfinite(torch.from_numpy(logits)).all():
        raise AssertionError("non-finite logits")


def phase_test_slice(out_dir: str) -> None:
    """The test slice on the fused path (K1), the plain path and the flash path (K3), each path's
    launches counted from 0; both kernel paths' logits against the plain path's."""
    runs = {}
    # same weights and episodes on every path; the plain path launches no kernel
    for path, opts, want in (("fused", [], {"clip_mha_fwd": LAYERS * 4}), ("plain", PLAIN_OPTS, {}),
                             ("flash", FLASH_OPTS, {"flash_mha_fwd": LAYERS * 4})):
        _reset_launches()
        runs[path] = run_test_slice(opts, os.path.join(out_dir, path))
        _expect_launches(f"the {path}-path test slice ({LAYERS} layers x 4 steps)", **want)
    plain = runs["plain"]
    for path in ("fused", "flash"):
        diff = abs(runs[path]["episode_logits"] - plain["episode_logits"]).max()
        print(f"test slice logits, {path} kernel path vs plain attention: max abs diff {diff:.3e} (bf16 tol 2e-2); "
              f"{16 / runs[path]['seconds']:.3f} episodes/s {path}, {16 / plain['seconds']:.3f} plain")
        torch.testing.assert_close(torch.from_numpy(runs[path]["episode_logits"]), torch.from_numpy(plain["episode_logits"]),
                                   atol=2e-2, rtol=2e-2)


# the options of each train path and the kernels it launches: (options, forward kernels, backward kernels)
TRAIN_PATHS = {"fused": (TRAIN_OPTS, ("clip_mha_fwd",), ("clip_mha_bwd",)),
               "flash": (TRAIN_OPTS + FLASH_OPTS, ("flash_mha_fwd",), ("flash_mha_bwd_dq", "flash_mha_bwd_dkv")),
               "rn50": (RN_TRAIN_OPTS, (), ())}


def phase_train_slice(out_dir: str, path: str) -> dict:
    """A main path: train then test through the CLI, on the ViT's fused or flash attention path or on the
    RN50 tower."""
    from clip_fsar_torch.runs.run import main

    opts, fwd_kernels, bwd_kernels = TRAIN_PATHS[path]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    results = main(["--cfg", CONFIG, *opts, "OUTPUT_DIR", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want_bwd = LAYERS * TRAIN_STEPS * CHUNKS
    # every chunk's forward, then one eval step of 4 episodes per validation and 4 test steps
    want_fwd = want_bwd + LAYERS * (TRAIN_STEPS // VAL_EVERY + TEST_EPISODES // 4)
    launches = _expect_launches(f"the {path} train slice ({LAYERS} layers x {TRAIN_STEPS} steps x {CHUNKS} chunks, then eval)",
                                **{name: want_fwd for name in fwd_kernels}, **{name: want_bwd for name in bwd_kernels})
    peak = torch.cuda.max_memory_allocated()

    train, test = results["train_few_shot"], results["test_few_shot"]
    losses = train["losses"]
    print(f"train slice [{path}]: losses per step {[round(x, 5) for x in losses]}; {train['updates']} optimizer updates; "
          f"best val top1 {train['best_val_top1']:.2f}")
    if len(losses) != TRAIN_STEPS or not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"expected {TRAIN_STEPS} finite losses, got {losses}")
    if train["updates"] != TRAIN_STEPS // ACCUM:
        raise AssertionError(f"expected {TRAIN_STEPS // ACCUM} optimizer updates, got {train['updates']}")
    if not test["weights"].endswith(os.path.join("checkpoints", f"{TRAIN_STEPS}.pt")):
        raise AssertionError(f"test_few_shot tested {test['weights']}, not the step-{TRAIN_STEPS} checkpoint")
    _check_test_stats(test)
    step_seconds = train["seconds"] - train["val_seconds"]
    eps = TRAIN_STEPS * EPISODES / step_seconds
    print(f"train slice [{path}]: {eps:.3f} train episodes/s ({TRAIN_STEPS * EPISODES} episodes, {TRAIN_STEPS * EPISODES * 240} frames, "
          f"in {step_seconds:.2f} s of steps; the loop took {train['seconds']:.2f} s with {train['val_seconds']:.2f} s of "
          f"validation and checkpoints); CLI wall {wall:.2f} s with the builds and the test of {test['weights']} "
          f"({TEST_EPISODES / test['seconds']:.3f} episodes/s, top1 {test['top1_acc']:.2f}); peak memory {peak / 2**30:.3f} GiB; "
          f"launches {launches}")
    if path == "rn50":
        _check_running_stats(out_dir)
    return {"launches": launches, "episodes_per_s": eps, "peak_gib": peak / 2**30, "step_ms": step_seconds / TRAIN_STEPS * 1e3}


def _check_running_stats(out_dir: str) -> None:
    """The RN50 train slice's checkpoints at steps 4 and 8 (the latter is the one the test protocol
    loaded): every BatchNorm's running stats are there, finite, moved from the fresh mean 0 and
    var 1, and moved again between the two checkpoints (live BatchNorm updates them every step)."""
    stats = {}
    for step in (VAL_EVERY, TRAIN_STEPS):
        head = torch.load(os.path.join(out_dir, "checkpoints", f"{step}.pt"), map_location="cpu", weights_only=True)["head"]
        stats[step] = {k: v for k, v in head.items() if k.endswith(("running_mean", "running_var"))}
    final = stats[TRAIN_STEPS]
    if len(final) != 2 * RN_BATCH_NORMS:
        raise AssertionError(f"the step-{TRAIN_STEPS} checkpoint holds {len(final)} running stats, expected {2 * RN_BATCH_NORMS}")
    if not all(torch.isfinite(v).all() for v in final.values()):
        raise AssertionError("non-finite running stats in the checkpoint")
    fresh = {k: torch.zeros_like(v) if k.endswith("mean") else torch.ones_like(v) for k, v in final.items()}
    moved = [k for k, v in final.items() if not torch.equal(v, fresh[k]) and not torch.equal(v, stats[VAL_EVERY][k])]
    if len(moved) != len(final):
        raise AssertionError(f"running stats that did not move: {sorted(set(final) - set(moved))[:5]}")
    shift = max((v - fresh[k]).abs().max().item() for k, v in final.items())
    print(f"train slice [rn50]: {len(final)} running stats in the step-{TRAIN_STEPS} checkpoint, all finite, all moved from "
          f"the fresh (0, 1) and since step {VAL_EVERY}; largest move from fresh {shift:.4e}")


def _rn50_work() -> dict:
    """RN50 at 224 px per frame, from shapes on the meta device: convolution FLOP (2 x MACs) and the
    outputs of its BatchNorms, with how many of each."""
    from clip_fsar_torch.models.clip.arch import ARCHS
    from clip_fsar_torch.models.clip.model import BatchNorm, Conv2d, build_vision_tower

    with torch.device("meta"):
        tower = build_vision_tower(ARCHS["RN50"], dtype=torch.bfloat16)
    work = {"conv_flop": 0, "convs": 0, "bn_outputs": 0, "bns": 0}

    def count(module, inputs, out):
        if isinstance(module, Conv2d):
            work["conv_flop"] += 2 * out.numel() * module.weight[0].numel()
            work["convs"] += 1
        else:
            work["bn_outputs"] += out.numel()
            work["bns"] += 1

    for m in tower.modules():
        if isinstance(m, (Conv2d, BatchNorm)):
            m.register_forward_hook(count)
    tower(torch.empty(1, 224, 224, 3, device="meta"))
    return work


def phase_rn_test_slice(out_dir: str, card_line: str) -> dict:
    """The RN50 test slice in bf16 and in fp32 (same fresh weights, same episodes), no kernel launched in
    either; the bf16 logits against the fp32 ones."""
    from clip_fsar_torch.runs.run import load_config

    backbone = load_config(CONFIG, RN_TEST_OPTS).VIDEO.HEAD.BACKBONE_NAME
    if backbone != "RN50":
        raise AssertionError(f"the flagship config runs {backbone}, not RN50")
    work = _rn50_work()
    if work["bns"] != RN_BATCH_NORMS:
        raise AssertionError(f"RN50 has {work['bns']} BatchNorms, expected {RN_BATCH_NORMS}")
    print(f"RN50 at 224 px per frame: {work['conv_flop'] / 1e9:.3f} GFLOP in {work['convs']} convolutions, "
          f"{work['bn_outputs'] / 1e6:.3f} M BatchNorm outputs in {work['bns']} BatchNorms")
    runs, launches = {}, {}
    for dtype in ("bfloat16", "float32"):
        _reset_launches()
        runs[dtype] = run_test_slice(["TPU.COMPUTE_DTYPE", dtype], os.path.join(out_dir, f"rn50_{dtype}"), RN_TEST_OPTS)
        got = _expect_launches(f"the RN50 test slice ({dtype})")  # no kernel: K1-K8 lie on no RN50 path
        launches = {name: launches.get(name, 0) + n for name, n in got.items()}
    got, want = (torch.from_numpy(runs[d]["episode_logits"]) for d in ("bfloat16", "float32"))
    diff = (got - want).abs().max().item()
    eps = 16 / runs["bfloat16"]["seconds"]
    print(f"RN50 test slice on {card_line}: bf16 {eps:.3f} episodes/s ({16 * 80 / runs['bfloat16']['seconds']:.1f} frames/s), "
          f"fp32 {16 / runs['float32']['seconds']:.3f} episodes/s; peak {runs['bfloat16']['max_memory_allocated'] / 2**30:.3f} GiB bf16, "
          f"{runs['float32']['max_memory_allocated'] / 2**30:.3f} GiB fp32; bf16 vs fp32 logits max abs diff {diff:.4e} "
          f"(max |logit| {want.abs().max().item():.4f}; atol {RN_LOGIT_TOL})")
    torch.testing.assert_close(got, want, atol=RN_LOGIT_TOL, rtol=0)
    return {"episodes_per_s": eps, "peak_gib": runs["bfloat16"]["max_memory_allocated"] / 2**30, "launches": launches}


def phase_train_step_paths() -> None:
    """One train step's loss and gradients, each kernel path (fused, flash) against the plain
    attention path (fp32 logits), same fresh weights, batch and generator."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.runs.run import load_config
    from clip_fsar_torch.train.loop import step_generator
    from clip_fsar_torch.train.step import make_grad_fn

    dev = runtime.device("cuda")
    picked = ("backbone.transformer.resblocks.0.attn.in_proj_weight", f"backbone.transformer.resblocks.{LAYERS - 1}.attn.in_proj_weight")
    runs = {}
    paths = (("fused", ["TPU.ATTENTION_LAYOUT", "fused"], {"clip_mha_fwd": LAYERS * CHUNKS, "clip_mha_bwd": LAYERS * CHUNKS}),
             ("flash", FLASH_OPTS, {name: LAYERS * CHUNKS for name in ("flash_mha_fwd", "flash_mha_bwd_dq", "flash_mha_bwd_dkv")}),
             ("plain", PLAIN_OPTS, {}))
    for path, extra, want in paths:
        cfg = load_config(CONFIG, TRAIN_OPTS + extra)
        if not runs:
            with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=EPISODES) as loader:
                batch = next(iter(loader)).to(dev)
        model = build_few_shot_model(cfg, flow="train", device=dev)
        _reset_launches()
        metrics = make_grad_fn(model.head, cfg, model.text_train, model.text_test)(batch, step_generator(cfg, 0, dev))
        _expect_launches(f"one train step on the {path} path ({LAYERS} layers x {CHUNKS} chunks)", **want)
        named = dict(model.head.named_parameters())
        grads = {n: named[n].grad.float().clone() for n in picked}
        grads["context2"] = torch.cat([p.grad.float().flatten() for n, p in named.items() if n.startswith("context2.")])
        runs[path] = (metrics["loss"].item(), grads)  # the one read, after the step's work is queued
        del model, named
        torch.cuda.empty_cache()
    loss_p, g_p = runs["plain"]
    for path in ("fused", "flash"):
        loss_k, g_k = runs[path]
        print(f"train step, {path} kernel path vs plain attention: loss {loss_k:.6f} vs {loss_p:.6f} (tol 2e-2)")
        torch.testing.assert_close(torch.tensor(loss_k), torch.tensor(loss_p), atol=2e-2, rtol=2e-2)
        for name in g_k:
            rel = ((g_k[name] - g_p[name]).norm() / g_p[name].norm()).item()
            print(f"train step grad [{path}] {name}: |kernel - plain| / |plain| = {rel:.3e} (tol {GRAD_REL_TOL}); "
                  f"|plain| = {g_p[name].norm().item():.4e}")
            if not rel <= GRAD_REL_TOL:
                raise AssertionError(f"gradient of {name} differs between the {path} and the plain path by {rel:.3e} (norm-relative)")


def _timed_grad_step(model, cfg, batch, what: str, **want_launches) -> dict:
    """One ``make_grad_fn`` step after a warm-up step, with the launches counted from 0 and held to
    ``want_launches``: its loss, picked gradients (the first and last block's in-projection, the patch
    embedding, the head's context transformer), CUDA-event ms and peak memory (GiB)."""
    from clip_fsar_torch.train.loop import step_generator
    from clip_fsar_torch.train.step import make_grad_fn

    dev = batch.support_images.device
    grad_fn = make_grad_fn(model.head, cfg, model.text_train, model.text_test)
    grad_fn(batch, step_generator(cfg, 0, dev))  # warm-up: the allocator, the constants, the kernels' first launch
    layers = model.head.arch.vision_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = grad_fn(batch, step_generator(cfg, 0, dev))
    end.record()
    torch.cuda.synchronize()
    launches = _expect_launches(what, **want_launches)
    named = dict(model.head.named_parameters())
    picked = ("backbone.conv1.weight", "backbone.transformer.resblocks.0.attn.in_proj_weight",
              f"backbone.transformer.resblocks.{layers - 1}.attn.in_proj_weight")
    grads = {n: named[n].grad.float().clone() for n in picked}
    grads["context2"] = torch.cat([p.grad.float().flatten() for n, p in named.items() if n.startswith("context2.")])
    model.head.zero_grad(set_to_none=True)
    return {"loss": metrics["loss"].item(), "grads": grads, "ms": start.elapsed_time(end), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches}


def _compare_steps(what: str, got: dict, want: dict) -> None:
    """Loss at 2e-2 and every picked gradient at GRAD_REL_TOL (norm-relative) against ``want``; prints both
    steps' ms and peak memory and whether the gradients are the same bits."""
    same = all(torch.equal(got["grads"][n], want["grads"][n]) for n in want["grads"])
    print(f"{what}: loss {got['loss']:.6f} vs {want['loss']:.6f} (tol 2e-2); gradients bit-identical: {same}; "
          f"{got['ms']:.1f} ms vs {want['ms']:.1f} ms per step, peak {got['peak_gib']:.3f} GiB vs {want['peak_gib']:.3f} GiB")
    torch.testing.assert_close(torch.tensor(got["loss"]), torch.tensor(want["loss"]), atol=2e-2, rtol=2e-2)
    for name, g in want["grads"].items():
        rel = ((got["grads"][name] - g).norm() / g.norm()).item()
        print(f"{what}: grad {name}: norm-relative difference {rel:.3e} (tol {GRAD_REL_TOL}); |grad| = {g.norm().item():.4e}")
        if not rel <= GRAD_REL_TOL:
            raise AssertionError(f"{what}: gradient of {name} differs by {rel:.3e} (norm-relative)")


def phase_remat_vs_none() -> None:
    """One ViT-B/16 train step (E = 4 in 2 chunks) with TPU.REMAT False, True (policy nothing) and True
    (policy dots) on the fused and the flash path, same fresh weights, batch and generator: each remat
    step against the step without remat."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.runs.run import load_config

    dev = runtime.device("cuda")
    batch = None
    for path, path_opts, fwd, bwd in (("fused", ["TPU.ATTENTION_LAYOUT", "fused"], ("clip_mha_fwd",), ("clip_mha_bwd",)),
                                      ("flash", FLASH_OPTS, ("flash_mha_fwd",), ("flash_mha_bwd_dq", "flash_mha_bwd_dkv"))):
        runs = {}
        for name, opts in (("off", ["TPU.REMAT", "False"]), ("nothing", ["TPU.REMAT", "True"]), ("dots", ["TPU.REMAT", "True", "TPU.REMAT_POLICY", "dots"])):
            cfg = load_config(CONFIG, TRAIN_OPTS + path_opts + opts)
            if batch is None:
                with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=EPISODES) as loader:
                    batch = next(iter(loader)).to(dev)
            model = build_few_shot_model(cfg, flow="train", device=dev)
            forwards = LAYERS * CHUNKS * (1 if name == "off" else 2)  # the recompute launches the forward again
            runs[name] = _timed_grad_step(model, cfg, batch, f"a ViT-B/16 train step on the {path} path, remat {name}",
                                          **{k: forwards for k in fwd}, **{k: LAYERS * CHUNKS for k in bwd})
            del model
            torch.cuda.empty_cache()
        for name in ("nothing", "dots"):
            _compare_steps(f"ViT-B/16 train step [{path}] remat {name} vs off", runs[name], runs["off"])


def _vit_kernels(where: str, b: int, n: int, h: int, seed: int) -> dict:
    """K1-K5 at one tower's frame batch: K1 and K2 on [b, n, 3 * h * 64] bf16, K3-K5 on its head-split views
    [b, h, n, 64]; each against its plain version, then timed beside it, the library call
    (``scaled_dot_product_attention`` and its backward) and the bound.  Returns the timings by kernel."""
    from clip_fsar_torch.ops.attention import split_heads
    from clip_fsar_torch.ops.flash_attention import (
        flash_mha_bwd_dkv_cuda,
        flash_mha_bwd_dkv_reference,
        flash_mha_bwd_dq_cuda,
        flash_mha_bwd_dq_reference,
        flash_mha_cuda,
        flash_mha_reference,
    )
    from clip_fsar_torch.ops.fused_attention import _heads_split, clip_mha_bwd_cuda, clip_mha_bwd_reference, clip_mha_cuda, clip_mha_reference

    dh = 64
    tol = TOLERANCE[torch.bfloat16]
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, n, 3 * h * dh, generator=g).to("cuda", torch.bfloat16)
    q, k, v = (split_heads(t, h) for t in qkv.chunk(3, dim=-1))
    shape = f"[{b}, {n}, {3 * h * dh}]"
    _check_forward(f"K1 clip_mha_fwd {shape} H={h} bf16", lambda: clip_mha_cuda(qkv, h), lambda: clip_mha_reference(qkv, h), tol)
    _check_forward(f"K3 flash_mha_fwd [{b}, {h}, {n}, {dh}] bf16", lambda: flash_mha_cuda(q, k, v), lambda: flash_mha_reference(q, k, v), tol)
    o, lse = clip_mha_cuda(qkv, h)
    do = torch.randn(b, n, h * dh, generator=g).to("cuda", torch.bfloat16)
    o3, lse3 = flash_mha_cuda(q, k, v)
    do3 = torch.empty_like(o3).copy_(do.reshape(b, n, h, dh).transpose(1, 2))  # o's layout, as autograd hands it over
    dq, delta = flash_mha_bwd_dq_cuda(q, k, v, o3, lse3, do3)
    checks = (("K2 clip_mha_bwd", (clip_mha_bwd_cuda(qkv, o, lse, do, h),), (clip_mha_bwd_reference(qkv, o, lse, do, h),)),
              ("K4 flash_mha_bwd_dq (dq, delta)", (dq, delta), flash_mha_bwd_dq_reference(q, k, v, o3, lse3, do3)),
              ("K5 flash_mha_bwd_dkv (dk, dv)", flash_mha_bwd_dkv_cuda(q, k, v, lse3, delta, do3), flash_mha_bwd_dkv_reference(q, k, v, lse3, delta, do3)))
    for what, got, want in checks:
        errs = [(x.float() - y.float()).abs().max().item() for x, y in zip(got, want)]
        print(f"{what} at {where} {shape} bf16: max|out-ref| {', '.join(f'{e:.3e}' for e in errs)} (tol {tol})")
        for x, y in zip(got, want):
            if not torch.isfinite(x.float()).all():
                raise AssertionError(f"{what}: not finite")
            torch.testing.assert_close(x.float(), y.float(), atol=tol, rtol=tol)
    del checks, dq

    timed = {}
    leaf = qkv.detach().requires_grad_(True)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    bwd_library_ms = _sdpa_bwd_ms(leaves, do3)  # dq, dk and dv in one call: beside K4 and beside K5, to be held against their sum
    cases = (("clip_mha_fwd", lambda: clip_mha_cuda(qkv, h), lambda: clip_mha_reference(qkv, h), _sdpa_ms(q, k, v), (3, 1, 1, 2)),
             ("clip_mha_bwd", lambda: clip_mha_bwd_cuda(qkv, o, lse, do, h), lambda: clip_mha_bwd_reference(qkv, o, lse, do, h),
              _sdpa_bwd_ms(_heads_split(leaf, h), do3, wrt=leaf), (5, 3, 1, 5)),
             ("flash_mha_fwd", lambda: flash_mha_cuda(q, k, v), lambda: flash_mha_reference(q, k, v), _sdpa_ms(q, k, v), (3, 1, 1, 2)),
             ("flash_mha_bwd_dq", lambda: flash_mha_bwd_dq_cuda(q, k, v, o3, lse3, do3), lambda: flash_mha_bwd_dq_reference(q, k, v, o3, lse3, do3),
              bwd_library_ms, (5, 1, 2, 3)),
             ("flash_mha_bwd_dkv", lambda: flash_mha_bwd_dkv_cuda(q, k, v, lse3, delta, do3),
              lambda: flash_mha_bwd_dkv_reference(q, k, v, lse3, delta, do3), bwd_library_ms, (4, 2, 2, 4)))
    for name, kernel, plain, library_ms, (t_in, t_out, rows, products) in cases:
        ms, plain_ms, all_ms = _alternate(kernel, plain, iters=10)
        bound = _attention_bound(b, n, h, dh, tensors_in=t_in, tensors_out=t_out, rows_fp32=rows, products=products)
        print(f"{name} at {where} {shape} H={h} bf16: kernel {all_ms[0]:.4f} / {all_ms[1]:.4f} ms, "
              f"plain {all_ms[2]:.4f} / {all_ms[3]:.4f} ms, library {library_ms:.4f} ms (kernel / library = {ms / library_ms:.2f}), "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; {100 * bound['bound_ms'] / ms:.1f} % of it reached)")
        timed[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound}
    return timed


def phase_vit_l336_kernels() -> dict:
    """K1-K5 at the ViT-L/14@336px slice's frame chunk: K1 and K2 on [120, 577, 3072] bf16, K3-K5 on its
    head-split views [120, 16, 577, 64]."""
    return _vit_kernels("the ViT-L/14@336px frame chunk", L336_CHUNK_FRAMES, L336_N, L336_HEADS, seed=6)


# one episode of the flagship's train step: 5 support and 25 query clips of 8 frames
ONE_EPISODE_FRAMES = 30 * 8


def phase_tower_kernels() -> dict:
    """K1-K5 at the train step of one episode (240 frames at 224 px) of the ViT-B/32 tower (N = 50, 12 heads) and of
    the ViT-L/14 tower (N = 257, 16 heads), the shapes phase 32b's tower steps give them."""
    return {"at_vit_b32": _vit_kernels("ViT-B/32's one-episode train step", ONE_EPISODE_FRAMES, 50, 12, seed=8),
            "at_vit_l14_224": _vit_kernels("ViT-L/14's one-episode train step", ONE_EPISODE_FRAMES, 257, 16, seed=9)}


def phase_vit_l336_train_slice(out_dir: str) -> dict:
    """The ViT-L/14@336px train slice through the CLI on the fused path, launches counted from 0 against
    the remat schedule."""
    from clip_fsar_torch.models.builder import tower_execution
    from clip_fsar_torch.runs.run import load_config, main

    cfg = load_config(CONFIG, L336_TRAIN_OPTS)
    if tower_execution(cfg) != (True, True) or cfg.TPU.REMAT != "auto":
        raise AssertionError(f"TPU.REMAT {cfg.TPU.REMAT!r} and TPU.SCAN_LAYERS {cfg.TPU.SCAN_LAYERS!r} resolve to {tower_execution(cfg)}, "
                             "not base.yaml's auto resolving to on for a 24-layer tower")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    results = main(["--cfg", CONFIG, *L336_TRAIN_OPTS, "OUTPUT_DIR", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_pass = L336_LAYERS * L336_FRAME_CHUNKS  # one launch per block per frame chunk
    train_passes = L336_STEPS * L336_EP_CHUNKS
    eval_steps = 1 + L336_TEST_EPISODES // 2  # one validation step of 2 episodes, two test steps of 2
    # the forward, the whole chunk's recompute and the block's recompute in training; one forward per eval step
    want_fwd, want_bwd = per_pass * (3 * train_passes + eval_steps), per_pass * train_passes
    launches = _expect_launches(f"the ViT-L/14@336px train slice ({L336_LAYERS} layers x {L336_FRAME_CHUNKS} frame chunks x "
                                f"{L336_EP_CHUNKS} episode chunks x {L336_STEPS} steps, then {eval_steps} eval steps)",
                                clip_mha_fwd=want_fwd, clip_mha_bwd=want_bwd)
    peak = torch.cuda.max_memory_allocated()
    train, test = results["train_few_shot"], results["test_few_shot"]
    losses = train["losses"]
    print(f"ViT-L/14@336px train slice: losses per step {[round(x, 5) for x in losses]}; {train['updates']} optimizer update(s); "
          f"best val top1 {train['best_val_top1']:.2f}")
    if len(losses) != L336_STEPS or not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"expected {L336_STEPS} finite losses, got {losses}")
    if train["updates"] != L336_STEPS // ACCUM:
        raise AssertionError(f"expected {L336_STEPS // ACCUM} optimizer update, got {train['updates']}")
    if not test["weights"].endswith(os.path.join("checkpoints", f"{L336_STEPS}.pt")):
        raise AssertionError(f"test_few_shot tested {test['weights']}, not the step-{L336_STEPS} checkpoint")
    _check_test_stats(test, L336_TEST_EPISODES)
    step_seconds = train["seconds"] - train["val_seconds"]
    eps = L336_STEPS * L336_EPISODES / step_seconds
    print(f"ViT-L/14@336px train slice: {eps:.4f} train episodes/s ({L336_STEPS * L336_EPISODES} episodes, "
          f"{L336_STEPS * L336_EPISODES * 480} frames of 336 px, in {step_seconds:.2f} s of steps, {step_seconds / L336_STEPS * 1e3:.1f} ms per step; "
          f"the loop took {train['seconds']:.2f} s with {train['val_seconds']:.2f} s of validation and checkpoints); CLI wall {wall:.2f} s "
          f"with the builds and the test of {test['weights']} ({L336_TEST_EPISODES / test['seconds']:.4f} episodes/s, top1 {test['top1_acc']:.2f}); "
          f"peak memory {peak / 2**30:.3f} GiB; launches {launches}")
    return {"launches": launches, "episodes_per_s": eps, "peak_gib": peak / 2**30, "step_ms": step_seconds / L336_STEPS * 1e3}


def phase_frame_chunks_vs_none() -> None:
    """One train step at the ViT-L/14@336px configuration with E = 1 (480 frames), the tower in 4 frame
    chunks and in one call (remat on in both), same weights, batch and generator."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.runs.run import load_config

    dev = runtime.device("cuda")
    cfg = load_config(CONFIG, L336_TRAIN_OPTS + ["TPU.EPISODES_PER_STEP", "1", "TPU.EPISODE_CHUNKS", "1"])
    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=1) as loader:
        batch = next(iter(loader)).to(dev)
    model = build_few_shot_model(cfg, flow="train", device=dev)
    runs = {}
    for chunks in (L336_FRAME_CHUNKS, 1):
        model.head.frame_chunks = chunks  # the same weights, the tower's frames in 4 parts or in one
        per_pass = L336_LAYERS * chunks
        runs[chunks] = _timed_grad_step(model, cfg, batch, f"a ViT-L/14@336px train step in {chunks} frame chunk(s)",
                                        clip_mha_fwd=per_pass * (3 if chunks > 1 else 2), clip_mha_bwd=per_pass)
    del model, batch
    torch.cuda.empty_cache()
    _compare_steps(f"ViT-L/14@336px train step (480 frames), {L336_FRAME_CHUNKS} frame chunks vs 1", runs[L336_FRAME_CHUNKS], runs[1])


def _classic_opts(name: str) -> list:
    """The classic slice's options: the config read from this checkout (its ANNO_DIR made absolute), then CLASSIC_OPTS."""
    from clip_fsar_torch.tools.profile_eval import config_opts

    return config_opts(os.path.join(REPO, CLASSIC_CONFIGS[name])) + CLASSIC_OPTS


def _classic_step(name: str, dtype: str, batch, picked) -> dict:
    """One ``make_grad_fn`` step of the classic slice's fresh model (the same weights in either dtype) in
    CLASSIC_GRAD_CHUNKS episode chunks: loss, the picked gradients (float32), launches (all 0)."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.runs.run import load_config
    from clip_fsar_torch.train.loop import step_generator
    from clip_fsar_torch.train.step import make_grad_fn

    dev = runtime.device("cuda")
    cfg = load_config(os.path.join(REPO, CLASSIC_CONFIGS[name]), _classic_opts(name) + [
        "TPU.COMPUTE_DTYPE", dtype, "TPU.EPISODE_CHUNKS", str(CLASSIC_GRAD_CHUNKS)])
    model = build_few_shot_model(cfg, flow="train", device=dev)
    _reset_launches()
    metrics = make_grad_fn(model.head, cfg, model.text_train, model.text_test)(batch, step_generator(cfg, 0, dev))
    _expect_launches(f"one {name} train step ({dtype})")
    named = dict(model.head.named_parameters())
    out = {"loss": metrics["loss"].item(), "grads": {n: named[n].grad.float().clone() for n in picked}}
    del model, named
    torch.cuda.empty_cache()
    return out


def _resident_steps(name: str, batch, steps: int = 4) -> dict:
    """The slice's bf16 train step with its batch resident on the card (``make_train_step``: augmentation,
    forward and backward of both chunks, the optimizer's micro-step), timed by ``profile_train.resident_step_ms``."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.runs.run import load_config

    cfg = load_config(os.path.join(REPO, CLASSIC_CONFIGS[name]), _classic_opts(name))
    model = build_few_shot_model(cfg, flow="train", device=runtime.device("cuda"))
    from clip_fsar_torch.tools.profile_train import resident_step_ms

    out = resident_step_ms(model, cfg, batch, steps=steps)
    del model
    torch.cuda.empty_cache()
    return out


def phase_classic_slice(out_dir: str, name: str, card_line: str) -> dict:
    """A classic head's shipped config through the CLI at full width: train (8 steps, validation, checkpoint)
    then test (8 episodes) in bf16, the test again in fp32 on the step-8 checkpoint, one train step in bf16
    against fp32, and the step timed with its batch resident; no kernel launched anywhere.  MoLo's checkpoint
    holds decoder running stats that moved and trunk running stats that did not."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.runs.run import load_config, main

    path = os.path.join(REPO, CLASSIC_CONFIGS[name])
    cfg = load_config(path, _classic_opts(name))
    if cfg.VIDEO.HEAD.BACKBONE_NAME != "resnet50":
        raise AssertionError(f"{path} runs {cfg.VIDEO.HEAD.BACKBONE_NAME}, not resnet50")
    frames = EPISODES * int(cfg.TRAIN.WAY) * (int(cfg.TRAIN.SHOT) + int(cfg.TRAIN.QUERY_PER_CLASS)) * int(cfg.DATA.NUM_INPUT_FRAMES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    results = main(["--cfg", path, *_classic_opts(name), "OUTPUT_DIR", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _expect_launches(f"the {name} slice (train, validation, test)")
    peak = torch.cuda.max_memory_allocated()
    train, test = results["train_few_shot"], results["test_few_shot"]
    losses = train["losses"]
    print(f"{name} slice: {cfg.VIDEO.HEAD.NAME} on resnet50; losses per step {[round(x, 5) for x in losses]}; {train['updates']} optimizer "
          f"updates; best val top1 {train['best_val_top1']:.2f}")
    if len(losses) != CLASSIC_STEPS or not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"expected {CLASSIC_STEPS} finite losses, got {losses}")
    if train["updates"] != CLASSIC_STEPS // ACCUM:
        raise AssertionError(f"expected {CLASSIC_STEPS // ACCUM} optimizer updates, got {train['updates']}")
    if not test["weights"].endswith(os.path.join("checkpoints", f"{CLASSIC_STEPS}.pt")):
        raise AssertionError(f"test_few_shot tested {test['weights']}, not the step-{CLASSIC_STEPS} checkpoint")
    _check_test_stats(test, CLASSIC_TEST_EPISODES)
    step_seconds = train["seconds"] - train["val_seconds"]
    eps = CLASSIC_STEPS * EPISODES / step_seconds
    test_eps = CLASSIC_TEST_EPISODES / test["seconds"]
    print(f"{name} slice on {card_line}: {eps:.4f} train episodes/s ({frames} frames a step, {step_seconds / CLASSIC_STEPS * 1e3:.1f} ms a "
          f"step over {CLASSIC_STEPS} steps with the loader; the loop took {train['seconds']:.2f} s with {train['val_seconds']:.2f} s of "
          f"validation and checkpoints); test protocol {test_eps:.3f} episodes/s (top1 {test['top1_acc']:.2f}); CLI wall {wall:.2f} s; "
          f"peak memory {peak / 2**30:.3f} GiB; launches {launches}")
    _check_classic_running_stats(out_dir, name)

    # the test protocol again in fp32 on the same checkpoint and episodes
    _reset_launches()
    fp32 = main(["--cfg", path, *_classic_opts(name), "TRAIN.ENABLE", "False", "TPU.COMPUTE_DTYPE", "float32", "OUTPUT_DIR", out_dir])["test_few_shot"]
    _expect_launches(f"the {name} test protocol in fp32")
    if fp32["weights"] != test["weights"]:
        raise AssertionError(f"the fp32 test read {fp32['weights']}, the bf16 test {test['weights']}")
    got, want = torch.from_numpy(test["episode_logits"]), torch.from_numpy(fp32["episode_logits"])
    diff, scale = (got - want).abs().max().item(), want.abs().max().item()
    print(f"{name} test logits bf16 vs fp32 (the step-{CLASSIC_STEPS} checkpoint, the same {CLASSIC_TEST_EPISODES} episodes): max abs diff "
          f"{diff:.4e}, {diff / scale:.3e} of the largest fp32 logit {scale:.4f} (tol {CLASSIC_LOGIT_SHARE}); fp32 "
          f"{CLASSIC_TEST_EPISODES / fp32['seconds']:.3f} episodes/s")
    if not diff <= CLASSIC_LOGIT_SHARE * scale:
        raise AssertionError(f"{name}: bf16 test logits differ from fp32 by {diff:.4e}, more than {CLASSIC_LOGIT_SHARE} of {scale:.4f}")

    # one train step in bf16 against fp32, and the bf16 step timed with its batch resident
    dev = runtime.device("cuda")
    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=EPISODES) as loader:
        batch = next(iter(loader)).to(dev)
    got, want = (_classic_step(name, dtype, batch, CLASSIC_PICKED[name]) for dtype in ("bfloat16", "float32"))
    what = f"{name} train step bf16 vs fp32 ({CLASSIC_GRAD_CHUNKS} episode chunks)"
    print(f"{what}: loss {got['loss']:.6f} vs {want['loss']:.6f} (tol 2e-2)")
    torch.testing.assert_close(torch.tensor(got["loss"]), torch.tensor(want["loss"]), atol=2e-2, rtol=2e-2)
    for pname, g in want["grads"].items():
        rel = ((got["grads"][pname] - g).norm() / g.norm()).item()
        tol = GRAD_REL_TOL if pname == "backbone.layer4.2.conv3.weight" else CLASSIC_HEAD_GRAD_TOL
        print(f"{what}: grad {pname}: norm-relative difference {rel:.3e} (tol {tol}); |grad| = {g.norm().item():.4e}")
        if not rel <= tol:
            raise AssertionError(f"{what}: gradient of {pname} differs by {rel:.3e} (norm-relative)")
    _repeat_classic_steps(name, batch)
    timed = _resident_steps(name, batch)
    print(f"{name} train step on {card_line}, batch resident ({frames} frames in {CHUNKS} chunks): {timed['step_ms']:.1f} ms a step "
          f"(CUDA events, 4 steps); the host queued a step in {timed['host_ms']:.1f} ms")
    del batch
    torch.cuda.empty_cache()
    return {"launches": launches, "episodes_per_s": eps, "test_episodes_per_s": test_eps, "peak_gib": peak / 2**30,
            "step_ms": step_seconds / CLASSIC_STEPS * 1e3, "resident_step_ms": timed["step_ms"], "host_ms": timed["host_ms"]}


def _check_classic_running_stats(out_dir: str, name: str) -> None:
    """The step-8 checkpoint: every running stat finite; the trunk's as fresh (mean 0, var 1: it runs on its
    running statistics, as the JAX heads build it); MoLo's three decoder BatchNorms' moved."""
    head = torch.load(os.path.join(out_dir, "checkpoints", f"{CLASSIC_STEPS}.pt"), map_location="cpu", weights_only=True)["head"]
    stats = {k: v for k, v in head.items() if k.endswith(("running_mean", "running_var"))}
    if not all(torch.isfinite(v).all() for v in stats.values()):
        raise AssertionError("non-finite running stats in the checkpoint")
    fresh = {k: torch.zeros_like(v) if k.endswith("mean") else torch.ones_like(v) for k, v in stats.items()}
    moved = sorted(k for k, v in stats.items() if not torch.equal(v, fresh[k]))
    want = sorted(f"up{i}.bn.{k}" for i in (1, 2, 3) for k in ("running_mean", "running_var")) if name == "molo_1shot" else []
    trunk = [k for k in stats if k.startswith("backbone.")]
    if moved != want or len(trunk) != 2 * 53:
        raise AssertionError(f"{name}: running stats that moved {moved}, expected {want}; {len(trunk)} trunk stats, expected 106")
    print(f"{name} slice: step-{CLASSIC_STEPS} checkpoint holds {len(stats)} running stats, all finite; the trunk's 106 as fresh; moved: "
          f"{moved or 'none'}")


# the frame-bank phases.  Bit identity: cv2-written videos through the cached_opencv decoder, the bank grid equal to
# its cache grid, at the ViT-B/16 slices' widths; 6 classes of 2 videos each (5-way episodes), 40 frames of 320 x 240
BANK_CLASSES, BANK_VIDEOS_PER_CLASS, BANK_GRID = 6, 2, 16
BANK_BITS_OPTS = ["DATA.DECODER", "cached_opencv", "DATA.FRAME_CACHE_FRAMES", str(BANK_GRID), "TRAIN.DATASET_FEW", "HMDB_few_shot",
                  "TPU.EVAL_FRAME_BANK_FRAMES", "0", "TPU.TRAIN_FRAME_BANK_FRAMES", "0"]
# the full-size banks: the HMDB51 splits of the shipped configs, 64 grid frames a video for the eval bank (the shipped
# FRAME_CACHE_FRAMES), 8 for the train bank; the episodes of each timed test loop, in steps of 4
BANK_EVAL_FRAMES, BANK_TRAIN_FRAMES, BANK_LOOP_EPISODES = 64, 8, 48
HYRSM = "hyrsm_pp_5shot"


def _write_bank_videos(root: str) -> None:
    """The bit-identity phase's split: BANK_CLASSES x BANK_VIDEOS_PER_CLASS mp4 videos of moving noise, listed as the
    train and the test split."""
    import cv2

    rels = []
    for c in range(BANK_CLASSES):
        for v in range(BANK_VIDEOS_PER_CLASS):
            rel = f"videos/c{c}_v{v}.mp4"
            os.makedirs(os.path.join(root, "videos"), exist_ok=True)
            base = np.random.RandomState(c * 31 + v).randint(0, 255, (240, 320, 3)).astype(np.uint8)
            writer = cv2.VideoWriter(os.path.join(root, rel), cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (320, 240))
            if not writer.isOpened():
                raise AssertionError("cv2 cannot write mp4v videos on this machine")
            for i in range(36 + 4 * v):
                writer.write(np.roll(base, (i * 5, i * 3), axis=(0, 1)))
            writer.release()
            rels.append((c, rel))
    for split in ("train", "test"):  # the class id follows the split's name: train0//..., test0//...
        with open(os.path.join(root, f"{split}_few_shot.txt"), "w") as f:
            f.write("".join(f"{split}{c}//{rel}\n" for c, rel in rels))


def _bank_bits_opts(root: str) -> list:
    return BANK_BITS_OPTS + ["DATA.ANNO_DIR", root, "DATA.DATA_ROOT_DIR", root, "DATA.FRAME_CACHE_DIR", os.path.join(root, "cache")]


def phase_bank_bits(out_dir: str, card_line: str) -> dict:
    """The frame banks against the pixel path, bit for bit, at the ViT-B/16 slices' widths: the test protocol on 8
    episodes through the CLI with and without TPU.EVAL_FRAME_BANK (equal logits and metrics), then 2 train steps (E = 4
    in 2 chunks, jitter and dropout on, one Adam update each) on pixels and off the train bank (equal loss bits and
    parameters), each step also timed with its batch resident, host against card.  K1 runs in every layer of every
    eval step and every chunk, with or without a bank."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data import frame_bank
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.runs.run import load_config, main
    from clip_fsar_torch.train.loop import step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState
    from clip_fsar_torch.train.step import make_train_step
    from clip_fsar_torch.tools.profile_train import resident_step_ms

    root = os.path.join(out_dir, "bank_videos")
    _write_bank_videos(root)
    opts = _bank_bits_opts(root)
    runs, launches = {}, {}
    for mode, extra in (("pixel", []), ("bank", ["TPU.EVAL_FRAME_BANK", "True"])):
        _reset_launches()
        runs[mode] = main(["--cfg", CONFIG, *SLICE_OPTS, *opts, "TRAIN.NUM_TEST_TASKS", "8", *extra,
                           "OUTPUT_DIR", os.path.join(out_dir, f"bank_bits_{mode}")])["test_few_shot"]
        launches[f"eval_{mode}"] = _expect_launches(f"the {mode} test protocol (8 episodes, {LAYERS} layers x 2 steps)", clip_mha_fwd=LAYERS * 2)
        _check_test_stats(runs[mode], 8)
    pixel, bank = runs["pixel"], runs["bank"]
    same = np.array_equal(pixel["episode_logits"], bank["episode_logits"]) and all(
        pixel[k] == bank[k] for k in ("top1_acc", "top5_acc", "loss", "episodes"))
    print(f"bank bits: test protocol on 8 episodes (cached_opencv, {BANK_GRID}-frame grid): top1 {pixel['top1_acc']:.2f} / "
          f"{bank['top1_acc']:.2f}, loss {pixel['loss']!r} / {bank['loss']!r}; logits and metrics bit-identical: {same}; "
          f"{bank['h2d_bytes_per_step']} bytes a step to the card against {pixel['h2d_bytes_per_step']}")
    if not same:
        raise AssertionError("the bank-mode test protocol differs from the pixel path")

    dev = runtime.device("cuda")
    cfg = load_config(CONFIG, TRAIN_OPTS + opts + ["TPU.TRAIN_FRAME_BANK", "True"])
    bank = frame_bank.build_train_frame_bank(cfg, dev)
    batches = {}
    for mode, wrap in (("pixel", None), ("bank", lambda s: frame_bank.TrainIndexEpisodeSampler(s, bank.table))):
        with build_few_shot_loader(cfg, "train", num_steps=2, episodes_per_step=EPISODES, sampler_wrap=wrap) as loader:
            batches[mode] = [b.to(dev) for b in loader]
    steps = {}
    for mode in ("pixel", "bank"):
        model = build_few_shot_model(cfg, flow="train", device=dev)
        state = TrainState.create(cfg, model.head, Optimizer(cfg, model.head))
        step = make_train_step(model.head, cfg, model.text_train, model.text_test, bank.pixels if mode == "bank" else None)
        _reset_launches()
        losses = torch.stack([step(state, b, 1e-3, step_generator(cfg, i, dev))["loss"] for i, b in enumerate(batches[mode])])
        launches[f"train_{mode}"] = _expect_launches(f"2 {mode} train steps ({LAYERS} layers x {CHUNKS} chunks)",
                                                     clip_mha_fwd=2 * LAYERS * CHUNKS, clip_mha_bwd=2 * LAYERS * CHUNKS)
        steps[mode] = (losses.cpu(), {k: v.detach().clone() for k, v in model.head.state_dict().items()})
        del model, state, step
        torch.cuda.empty_cache()
    (lp, sp), (lb, sb) = steps["pixel"], steps["bank"]
    differ = sorted(k for k in sp if not torch.equal(sp[k], sb[k]))
    print(f"bank bits: 2 train steps (E = {EPISODES} in {CHUNKS} chunks, jitter and dropout on): losses pixel {lp.tolist()} bank "
          f"{lb.tolist()}; loss bits equal: {torch.equal(lp, lb)}; parameters that differ: {differ[:5] or 'none'}")
    if not (torch.isfinite(lp).all() and torch.equal(lp, lb)) or differ:
        raise AssertionError("the bank train steps differ from the pixel path's")

    model = build_few_shot_model(cfg, flow="train", device=dev)
    timed = {}
    for mode in ("pixel", "bank", "bank", "pixel"):
        got = resident_step_ms(model, cfg, batches[mode][0], bank.pixels if mode == "bank" else None)
        timed.setdefault(mode, []).append(got)
    del model
    torch.cuda.empty_cache()
    for mode, readings in timed.items():
        print(f"bank bits: ViT-B/16 train step on {card_line}, batch resident ({mode}; {EPISODES * 30 * 8} frames in {CHUNKS} chunks): "
              + " / ".join(f"{t['step_ms']:.1f} ms on the card, queued by the host in {t['host_ms']:.1f} ms" for t in readings))
    return {"launches": launches, "resident": timed}


def _bank_loop(cfg, model, bank, what: str, card_line: str, episodes: int = BANK_LOOP_EPISODES) -> dict:
    """``evaluate`` over ``episodes`` in steps of 4 on pixels and off ``bank`` in turn (pixel, bank, bank, pixel),
    then each once under the profiler for the card's idle share; K1 launches counted from 0 over the bank runs."""
    from torch.profiler import ProfilerActivity, profile

    from clip_fsar_torch.tools.profile_eval import _busy_us, _device_events
    from clip_fsar_torch.train.loop import evaluate

    dev = torch.device("cuda")
    evaluate(cfg, model, 4, 4, device=dev)  # warm-up: the kernels' first launch, the allocator
    readings, peak, k1 = {"pixel": [], "bank": []}, {}, 0
    for mode in ("pixel", "bank", "bank", "pixel"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        stats = evaluate(cfg, model, episodes, 4, device=dev, bank=bank if mode == "bank" else None)
        if mode == "bank":
            k1 += _launches()["clip_mha_fwd"]
        readings[mode].append(stats)
        peak[mode] = max(peak.get(mode, 0.0), torch.cuda.max_memory_allocated() / 2**30)
        _check_test_stats(stats, episodes)
    idle = {}
    for mode in ("pixel", "bank"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced = evaluate(cfg, model, episodes // 2, 4, device=dev, bank=bank if mode == "bank" else None)
            torch.cuda.synchronize()
        idle[mode] = 1.0 - _busy_us(_device_events(prof)) / 1e6 / traced["seconds"]
    eps = {mode: [episodes / r["seconds"] for r in rs] for mode, rs in readings.items()}
    h2d = {mode: rs[0]["h2d_bytes_per_step"] for mode, rs in readings.items()}
    resident = _resident_eval_ms(cfg, model, bank)
    print(f"{what} on {card_line}: test episodes/s pixel {eps['pixel'][0]:.3f} / {eps['pixel'][1]:.3f}, bank {eps['bank'][0]:.3f} / "
          f"{eps['bank'][1]:.3f} (pixel, bank, bank, pixel; {episodes} episodes each); host-to-device bytes a step: pixel {h2d['pixel']}, "
          f"bank {h2d['bank']}; the card idle {100 * idle['pixel']:.1f} % pixel, {100 * idle['bank']:.1f} % bank "
          f"(under the profiler, {episodes // 2} episodes); peak {peak['pixel']:.3f} GiB pixel, {peak['bank']:.3f} GiB with the bank; "
          f"the eval step with its batch resident: " + ", ".join(f"{mode} {t['step_ms']:.2f} ms on the card, queued by the host in {t['host_ms']:.2f} ms"
                                                              for mode, t in resident.items()))
    return {"episodes_per_s": eps, "h2d_bytes": h2d, "idle": idle, "peak_gib": peak, "k1_launches": k1, "resident": resident}


def _resident_eval_ms(cfg, model, bank, steps: int = 8) -> dict:
    """The eval step with one batch resident on the card, pixels and bank rows: ``steps`` steps timed with CUDA events
    beside the host's ms to queue them (the step reads nothing back)."""
    from clip_fsar_torch.data.frame_bank import IndexEpisodeSampler
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.train.step import make_eval_step

    dev = bank.pixels.device
    out = {}
    for mode, wrap in (("pixel", None), ("bank", lambda s: IndexEpisodeSampler(s, bank.table))):
        with build_few_shot_loader(cfg, "test", num_steps=1, episodes_per_step=4, sampler_wrap=wrap) as loader:
            batch = next(iter(loader)).to(dev)
        step = make_eval_step(model.head, cfg, model.text_train, model.text_test, bank.pixels if mode == "bank" else None)
        step(batch)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch)
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        end.record()
        torch.cuda.synchronize()
        out[mode] = {"step_ms": start.elapsed_time(end) / steps, "host_ms": host_ms}
    return out


def phase_eval_bank_full(card_line: str) -> dict:
    """The eval bank at full size: the HMDB51 test split (1292 videos, 64 grid frames, 224 px: 12.45 GB) built once on
    the card for the ViT-B/16 test slice, whose test loop runs on pixels and off the bank in turn; then the shipped
    HyRSM++ 5-shot config's test loop off the same bank (the same split file, TEST_SCALE and crop)."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data import frame_bank
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.runs.run import load_config
    from clip_fsar_torch.tools.profile_eval import slice_cfg

    dev = runtime.device("cuda")
    cfg = slice_cfg("TPU.EVAL_FRAME_BANK_FRAMES", str(BANK_EVAL_FRAMES))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = frame_bank.build_eval_frame_bank(cfg, "test", dev)
    wall = time.perf_counter() - t0
    videos = len(bank.table.row_of_path)
    print(f"eval bank on {card_line}: {videos} videos x {BANK_EVAL_FRAMES} grid frames x {bank.pixels.shape[1]}x{bank.pixels.shape[2]} px = "
          f"{bank.nbytes / 1e9:.2f} GB; host build {bank.build_seconds:.2f} s, upload {bank.upload_seconds:.2f} s "
          f"({bank.nbytes / 1e9 / max(bank.upload_seconds, 1e-9):.2f} GB/s), {wall:.2f} s in all")
    crop = int(cfg.DATA.TEST_CROP_SIZE)
    if videos != 1292 or bank.pixels.shape != (1292 * BANK_EVAL_FRAMES, crop, crop, 3):
        raise AssertionError(f"the HMDB51 test bank has {videos} videos and shape {tuple(bank.pixels.shape)}")
    out = {"build_seconds": bank.build_seconds, "upload_seconds": bank.upload_seconds, "gb": bank.nbytes / 1e9}
    model = build_few_shot_model(cfg, flow="test", device=dev)
    out["vit"] = _bank_loop(cfg, model, bank, "ViT-B/16 test slice, eval bank", card_line)
    if out["vit"]["k1_launches"] != 2 * LAYERS * BANK_LOOP_EPISODES // 4:
        raise AssertionError(f"K1 launched {out['vit']['k1_launches']} times in the two bank loops")
    del model
    torch.cuda.empty_cache()
    path = os.path.join(REPO, CLASSIC_CONFIGS[HYRSM])
    hcfg = load_config(path, _classic_opts(HYRSM) + ["TRAIN.ENABLE", "False", "TPU.EVAL_FRAME_BANK_FRAMES", str(BANK_EVAL_FRAMES)])
    model = build_few_shot_model(hcfg, flow="test", device=dev)
    out["hyrsm"] = _bank_loop(hcfg, model, bank, "HyRSM++ 5-shot test slice, eval bank", card_line)
    del model, bank
    torch.cuda.empty_cache()
    return out


def phase_train_bank_full(out_dir: str, card_line: str, pixel: dict) -> dict:
    """The ViT-B/16 train slice through the CLI off a train bank of the HMDB51 train split (4280 videos, 8 grid frames,
    256 px: 6.73 GB), its validations off one val bank (the val split reads test_few_shot.txt, as in the JAX package:
    1292 videos, 64 grid frames, 12.45 GB) and its test off a test bank: losses, updates, train episodes/s against the
    pixel path's (``pixel``, the fused train slice of this run), the peak with the train and val banks beside the
    train step, the banks' build and upload seconds."""
    from clip_fsar_torch.runs.run import main

    banks = ["TPU.TRAIN_FRAME_BANK", "True", "TPU.TRAIN_FRAME_BANK_FRAMES", str(BANK_TRAIN_FRAMES), "TPU.EVAL_FRAME_BANK", "True",
             "TPU.EVAL_FRAME_BANK_FRAMES", str(BANK_EVAL_FRAMES)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    results = main(["--cfg", CONFIG, *TRAIN_OPTS, *banks, "OUTPUT_DIR", out_dir])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want_bwd = LAYERS * TRAIN_STEPS * CHUNKS
    launches = _expect_launches("the train slice off the banks", clip_mha_fwd=want_bwd + LAYERS * (TRAIN_STEPS // VAL_EVERY + TEST_EPISODES // 4),
                                clip_mha_bwd=want_bwd)
    train, test = results["train_few_shot"], results["test_few_shot"]
    losses = train["losses"]
    if len(losses) != TRAIN_STEPS or not all(torch.isfinite(torch.tensor(losses))) or train["updates"] != TRAIN_STEPS // ACCUM:
        raise AssertionError(f"the bank train slice: losses {losses}, {train['updates']} updates")
    _check_test_stats(test)
    eps = TRAIN_STEPS * EPISODES / (train["seconds"] - train["val_seconds"])
    b = {**train["frame_banks"], "test": test["frame_bank"]}
    print(f"train bank on {card_line}: losses {[round(x, 5) for x in losses]}; {eps:.4f} train episodes/s off the banks against "
          f"{pixel['episodes_per_s']:.4f} on pixels (the fused train slice above); peak {peak:.3f} GiB with the train and val banks "
          f"({pixel['peak_gib']:.3f} GiB on pixels); banks: "
          + "; ".join(f"{name} {v['gb']:.2f} GB built in {v['build_seconds']:.2f} s, uploaded in {v['upload_seconds']:.2f} s" for name, v in b.items())
          + f"; test off the bank {TEST_EPISODES / test['seconds']:.3f} episodes/s; launches {launches}")
    if train["frame_banks"]["train"]["gb"] < 6.7:
        raise AssertionError(f"the train bank is {train['frame_banks']['train']['gb']:.2f} GB, not the HMDB51 train split's 6.73")
    return {"launches": launches, "episodes_per_s": eps, "peak_gib": peak, "banks": b}


def phase_reference_checkpoint(out_dir: str) -> dict:
    """A reference-format ``.pyth`` (``model_state``, ``module.head.`` keys, the reference's context2 names) written from
    the fresh ViT-B/16 CLIP-FSAR head, tested through TEST.CHECKPOINT_FILE_PATH: its test logits equal those of the head
    it was written from (fresh weights, no checkpoint) bit for bit."""
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.models.convert_reference import reference_state_dict
    from clip_fsar_torch.runs.run import main
    from clip_fsar_torch.tools.profile_eval import slice_cfg

    head = build_few_shot_model(slice_cfg(), flow="test", device="cpu").head
    path = os.path.join(out_dir, "checkpoint_epoch_00010.pyth")
    torch.save({"epoch": 10, "model_state": reference_state_dict(head.state_dict())}, path)
    runs = {}
    for name, extra in (("fresh", []), ("pyth", ["TEST.CHECKPOINT_FILE_PATH", path])):
        _reset_launches()
        runs[name] = main(["--cfg", CONFIG, *SLICE_OPTS, "TRAIN.NUM_TEST_TASKS", "8", *extra, "OUTPUT_DIR", os.path.join(out_dir, f"ref_{name}")])["test_few_shot"]
        launches = _expect_launches(f"the test protocol ({name})", clip_mha_fwd=LAYERS * 2)
        _check_test_stats(runs[name], 8)
    same = np.array_equal(runs["fresh"]["episode_logits"], runs["pyth"]["episode_logits"])
    print(f"reference checkpoint: {os.path.basename(path)} ({os.path.getsize(path) / 1e6:.1f} MB) tested as {runs['pyth']['weights']!r}; logits "
          f"bit-identical to the head it was written from ({runs['fresh']['weights']}): {same}")
    if runs["pyth"]["weights"] != path or not same:
        raise AssertionError("the .pyth checkpoint did not give its head's logits")
    return {"launches": launches}


# the data-parallel phases: the ViT-B/16 train slice of phase 8 (E = 4 episodes a step in 2 chunks, the fused path)
# cut to 4 steps (one Adam update), validation at step 4 on 4 episodes, the test protocol on 8 episodes of the step-4
# checkpoint; dropout off in every run (each rank draws its own masks, as each chunk does)
DP_STEPS, DP_TEST_EPISODES = 4, 8
DP_OPTS = TRAIN_OPTS + ["TRAIN.NUM_TRAIN_TASKS", str(DP_STEPS), "TRAIN.VAL_FRE_ITER", str(DP_STEPS), "TRAIN.NUM_TEST_TASKS", str(DP_TEST_EPISODES)]
DP_PICKED = ("backbone.transformer.resblocks.0.attn.in_proj_weight", f"backbone.transformer.resblocks.{LAYERS - 1}.attn.in_proj_weight")
DP_TIMEOUT_S = 600  # each rank of the world-2 phase, and its process group's collectives
# per rank and run: every chunk of every step, then one validation step and the test's steps, at E / world episodes
DP_LAUNCHES = {"clip_mha_fwd": LAYERS * (DP_STEPS * CHUNKS + 1 + DP_TEST_EPISODES // 4), "clip_mha_bwd": LAYERS * DP_STEPS * CHUNKS}


def _dp_run(out_dir: str) -> dict:
    """The data-parallel phases' slice through the CLI in this process, under its process group if it is in one,
    with dropout off: losses, the test's stats and logits, the gradient the optimizer saw at the first step (picked:
    the first and last block's in-projection, the head's context transformer), a digest of the trained head's
    weights, its step-4 checkpoint's path, K1 / K2 launches counted from 0 and the loop's step seconds."""
    import hashlib

    from clip_fsar_torch.models.heads import common
    from clip_fsar_torch.runs.run import main
    from clip_fsar_torch.train import loop
    from clip_fsar_torch.train.optimizer import Optimizer

    built, grads = [], {}
    build, opt_step, dropout = loop.build_few_shot_model, Optimizer.step, common.dropout

    def capture_build(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    def capture_step(self, lr, ok=None):
        if not grads:
            named = dict(built[0].head.named_parameters())
            grads.update({n: named[n].grad.float().cpu() for n in DP_PICKED})
            grads["context2"] = torch.cat([p.grad.float().flatten() for n, p in named.items() if n.startswith("context2.")]).cpu()
        return opt_step(self, lr, ok)

    loop.build_few_shot_model, Optimizer.step, common.dropout = capture_build, capture_step, (lambda x, *_args: x)
    try:
        _reset_launches()
        results = main(["--cfg", CONFIG, *DP_OPTS, "OUTPUT_DIR", out_dir])
        torch.cuda.synchronize()
        launches = _launches()
    finally:
        loop.build_few_shot_model, Optimizer.step, common.dropout = build, opt_step, dropout
    train, test = results["train_few_shot"], results["test_few_shot"]
    digest = hashlib.sha256()
    for v in built[0].head.state_dict().values():
        digest.update(v.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return {"losses": train["losses"], "updates": train["updates"], "step_seconds": train["seconds"] - train["val_seconds"],
            "logits": test["episode_logits"], "episodes": test["episodes"], "top1_acc": test["top1_acc"], "weights": test["weights"],
            "grads": grads, "digest": digest.hexdigest(), "checkpoint": os.path.join(out_dir, "checkpoints", f"{DP_STEPS}.pt"),
            "launches": {name: launches[name] for name in DP_LAUNCHES}}


def _check_dp_run(what: str, run: dict) -> None:
    """A data-parallel phase's run: finite losses of every step, the update, the step-4 checkpoint tested, the test's
    episodes, K1 / K2 launched on every chunk, validation and test step of this process's episodes."""
    if len(run["losses"]) != DP_STEPS or not all(np.isfinite(run["losses"])) or run["updates"] != DP_STEPS // ACCUM:
        raise AssertionError(f"{what}: expected {DP_STEPS} finite losses and {DP_STEPS // ACCUM} update, got {run['losses']}, {run['updates']}")
    if run["weights"] != run["checkpoint"]:
        raise AssertionError(f"{what}: the test protocol tested {run['weights']}, not {run['checkpoint']}")
    _check_test_stats({"episode_logits": run["logits"], "episodes": run["episodes"]}, DP_TEST_EPISODES)
    if run["launches"] != DP_LAUNCHES:
        raise AssertionError(f"{what}: launched {run['launches']}, expected {DP_LAUNCHES} per rank")


def _nccl_world1(store: str) -> None:
    import datetime

    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1, timeout=datetime.timedelta(seconds=DP_TIMEOUT_S),
                            device_id=torch.device("cuda", 0))


def phase_dp_world1(out_dir: str, card_line: str) -> dict:
    """World 1 over NCCL: the slice through the CLI without a process group and then as the one rank of an NCCL group
    (gradient, metric and running-stat all-reduces, the eval gathers, rank-0 checkpoints and their barriers all run):
    the same loss bits, the same trained weights and step-4 checkpoint bit for bit, the same test logits.  Then the
    train step with its batch resident, timed without the group and in it, and the gradient all-reduce of one step alone."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.parallel import mesh
    from clip_fsar_torch.runs.run import load_config
    from clip_fsar_torch.tools.profile_train import resident_step_ms

    alone = _dp_run(os.path.join(out_dir, "alone"))
    _check_dp_run("the slice without a process group", alone)
    dev = runtime.device("cuda")
    cfg = load_config(CONFIG, DP_OPTS)
    model = build_few_shot_model(cfg, flow="train", device=dev)
    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=EPISODES) as loader:
        batch = next(iter(loader)).to(dev)
    timed = {"alone": resident_step_ms(model, cfg, batch)}
    _nccl_world1(os.path.join(out_dir, "nccl_store"))
    try:
        timed["nccl"] = resident_step_ms(model, cfg, batch)
        del model, batch
        torch.cuda.empty_cache()
        grouped = _dp_run(os.path.join(out_dir, "nccl"))
    finally:
        mesh.destroy()
    _check_dp_run("the slice as the one rank of an NCCL group", grouped)
    want, got = torch.load(alone["checkpoint"], weights_only=True)["head"], torch.load(grouped["checkpoint"], weights_only=True)["head"]
    same = {"losses": grouped["losses"] == alone["losses"], "weights": grouped["digest"] == alone["digest"],
            "checkpoint": all(torch.equal(got[k], v) for k, v in want.items()), "logits": np.array_equal(grouped["logits"], alone["logits"])}
    a, g = timed["alone"], timed["nccl"]
    print(f"data parallel, world 1 over NCCL on {card_line}: the same bits as without a process group: {same}; losses {grouped['losses']}; "
          f"resident train step {g['step_ms']:.3f} ms in the group (host {g['host_ms']:.3f} ms) against {a['step_ms']:.3f} ms without "
          f"(host {a['host_ms']:.3f} ms); the gradient all-reduce alone {g['all_reduce_ms']:.3f} ms a step for {g['all_reduce_mb']:.1f} MB; "
          f"the CLI's loop {DP_STEPS * EPISODES / grouped['step_seconds']:.4f} train episodes/s in the group, "
          f"{DP_STEPS * EPISODES / alone['step_seconds']:.4f} without; launches {grouped['launches']}")
    if not all(same.values()):
        raise AssertionError(f"world 1 over NCCL differs from the run without a process group: {same}")
    return {"alone": alone, "launches": grouped["launches"], "step_ms": g["step_ms"], "alone_step_ms": a["step_ms"], "all_reduce_ms": g["all_reduce_ms"]}


def dp_worker(rank: int, store: str, out_dir: str) -> None:
    """One rank of the world-2 phase: joins a two-rank gloo group on card 0 and runs ``_dp_run`` in ``out_dir`` (the
    ranks share it: rank 0 writes the checkpoints both test), then saves what it saw to ``out_dir/rank<r>.pt``."""
    import datetime

    import torch.distributed as dist

    from clip_fsar_torch.parallel import mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2, timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    try:
        run = _dp_run(out_dir)
    finally:
        mesh.destroy()
    torch.save(run, os.path.join(out_dir, f"rank{rank}.pt"))


def phase_dp_world2(out_dir: str, card_line: str, world1: dict) -> dict:
    """World 2 over gloo on the one card: two processes, both ranks on card 0 (NCCL refuses two ranks on one card;
    gloo reduces and gathers CUDA tensors through the host), the same slice at the same global E = 4 (2 episodes a
    rank, in 2 chunks of 1) and eval E = 4.  Against world 1 without a group: losses at 2e-2 (the bf16 reduction-order
    tolerance of tests/test_multihost.py:141), the first step's gradient at GRAD_REL_TOL by norm and the step-4
    weights at atol = rtol 2e-2 (PERF.md section 2's train tolerances), the test's episode count exact and its logits at
    2e-2; the two ranks' weights bit-identical.  Each rank has DP_TIMEOUT_S; one that fails fails the phase."""
    import subprocess
    import sys

    run_dir = os.path.join(out_dir, "gloo")
    os.makedirs(run_dir)
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    logs = [open(os.path.join(out_dir, f"gloo_rank{r}.log"), "w") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker", str(r), os.path.join(out_dir, "gloo_store"), run_dir],
                              cwd=REPO, env=env, stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    try:
        while any(p.poll() is None for p in procs) and time.perf_counter() - t0 < DP_TIMEOUT_S:
            if any(p.poll() not in (None, 0) for p in procs):
                break  # a rank failed: its peer would wait for it until the group's timeout
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out_dir, f"gloo_rank{r}.log")) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"world 2 over gloo: rank {r} exited with {p.returncode} after {wall:.0f} s:\n{tail}")
    ranks = [torch.load(os.path.join(run_dir, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    for r, run in enumerate(ranks):
        _check_dp_run(f"world 2 over gloo, rank {r}", run)
    one = world1["alone"]
    got, want = torch.load(ranks[0]["checkpoint"], weights_only=True)["head"], torch.load(one["checkpoint"], weights_only=True)["head"]
    weight_err = max((got[k].float() - v.float()).abs().max().item() for k, v in want.items())
    loss_err = max(abs(a - b) for a, b in zip(ranks[0]["losses"], one["losses"]))
    logit_err = float(np.abs(ranks[0]["logits"] - one["logits"]).max())
    grad_rel = {n: ((ranks[0]["grads"][n] - g).norm() / g.norm()).item() for n, g in one["grads"].items()}
    print(f"data parallel, world 2 over gloo on one card ({card_line}): ranks bit-identical: {ranks[0]['digest'] == ranks[1]['digest']}; "
          f"losses {ranks[0]['losses']} against world 1's {one['losses']} (max diff {loss_err:.3e}, tol 2e-2); first step's gradient "
          f"by norm {', '.join(f'{n} {e:.3e}' for n, e in grad_rel.items())} (tol {GRAD_REL_TOL}); step-4 weights max diff {weight_err:.3e} "
          f"(tol 2e-2); test logits max diff {logit_err:.3e} (tol 2e-2), {ranks[0]['episodes']} episodes; the ranks' loops "
          f"{DP_STEPS * EPISODES / max(r['step_seconds'] for r in ranks):.4f} train episodes/s; {wall:.1f} s with the processes' start; "
          f"launches per rank {ranks[0]['launches']}")
    if ranks[0]["digest"] != ranks[1]["digest"] or ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError("world 2 over gloo: the two ranks hold different weights")
    torch.testing.assert_close(torch.tensor(ranks[0]["losses"]), torch.tensor(one["losses"]), atol=2e-2, rtol=2e-2)
    for n, e in grad_rel.items():
        if not e <= GRAD_REL_TOL:
            raise AssertionError(f"world 2 over gloo: the first step's gradient of {n} differs from world 1's by {e:.3e} (norm-relative)")
    for k, v in want.items():
        torch.testing.assert_close(got[k].float(), v.float(), atol=2e-2, rtol=2e-2, msg=lambda m, k=k: f"world 2 weights {k}: {m}")
    if ranks[0]["episodes"] != one["episodes"]:
        raise AssertionError(f"world 2 tested {ranks[0]['episodes']} episodes, world 1 {one['episodes']}")
    torch.testing.assert_close(torch.from_numpy(ranks[0]["logits"]), torch.from_numpy(one["logits"]), atol=2e-2, rtol=2e-2)
    return {"launches": {name: sum(r["launches"][name] for r in ranks) for name in DP_LAUNCHES}, "seconds": wall}


# the tensor-parallel phase: TPU.MESH {DATA: 1, MODEL: 2} as two gloo processes sharing card 0 (NCCL refuses two ranks
# on one card), each rank holding 6 of every ViT-B/16 block's 12 heads, half of its MLP and half of the prototype
# transformer's, against the same runs with no process group in this process; dropout and jitter on (the masks of a
# sharded activation are slices of the full draw, so both worlds draw the same ones)
TP_OPTS = ["TPU.MESH", "{DATA: 1, MODEL: 2}"]
TP_HEADS = 6
TP_SHAPE = (TRAIN_SHAPE[0], 197, 3 * TP_HEADS * 64)  # the flagship's train chunk (480 frames) on one rank's heads
TP_STEPS, TP_EPISODES, TP_TEST_EPISODES = 2, 2, 4
# E = 2 a step in 2 chunks of one episode, an Adam update every step, no validation, the test of the step-2 checkpoint on
# 4 episodes (one step)
TP_TRAIN_OPTS = TRAIN_OPTS + ["TPU.EPISODES_PER_STEP", str(TP_EPISODES), "TRAIN.BATCH_SIZE_PER_TASK", "1", "TRAIN.NUM_TRAIN_TASKS",
                              str(TP_STEPS), "TRAIN.VAL_FRE_ITER", "0", "TRAIN.NUM_TEST_TASKS", str(TP_TEST_EPISODES)]
# one fp32 step of one episode under TPU.REMAT (so that two fp32 ranks fit the card; the same numbers as without it)
TP_FP32_OPTS = TP_TRAIN_OPTS + ["TPU.COMPUTE_DTYPE", "float32", "TPU.REMAT", "True", "TPU.EPISODES_PER_STEP", "1"]
TP_FP32_PICKED = ("backbone.transformer.resblocks.0.attn.in_proj_weight", "backbone.transformer.resblocks.0.mlp.c_fc.weight",
                  f"backbone.transformer.resblocks.{LAYERS - 1}.attn.out_proj.weight", "backbone.ln_pre.weight", "context2.attn_0.to_q.weight")
TP_FP32_TOL = 1e-4  # the fp32 step's loss (relative) and gradients (norm-relative): reduction order only, TF32 off
TP_TIMEOUT_S = 600  # each rank of the phase, and its process group's collectives
# per rank: the fused test slice (4 steps), the flash test step, the train cut (each chunk of each step) and its test step
TP_LAUNCHES = {"clip_mha_fwd": LAYERS * (4 + TP_STEPS * CHUNKS + 1), "clip_mha_bwd": LAYERS * TP_STEPS * CHUNKS, "flash_mha_fwd": LAYERS}


def _tp_runs(out_dir: str, mesh_opts: list) -> dict:
    """The tensor-parallel phase's runs in this process, on ``mesh_opts``'s mesh (under the caller's process group, if
    any): the fused test slice and one flash test step on fresh weights, the train cut through the CLI (its losses,
    seconds a step, peak), one fp32 step's loss and picked full gradients, and the launches of every kernel counted
    from 0 over the CLI runs."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.parallel import mesh, tensor
    from clip_fsar_torch.runs.run import load_config, main
    from clip_fsar_torch.train.step import make_grad_fn

    dev = runtime.device("cuda")
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    test = main(["--cfg", CONFIG, *SLICE_OPTS, *mesh_opts, "OUTPUT_DIR", os.path.join(out_dir, "test")])["test_few_shot"]
    test_peak = torch.cuda.max_memory_allocated()
    flash = main(["--cfg", CONFIG, *SLICE_OPTS, *FLASH_OPTS, *mesh_opts, "TRAIN.NUM_TEST_TASKS", "4", "OUTPUT_DIR",
                  os.path.join(out_dir, "flash")])["test_few_shot"]
    torch.cuda.reset_peak_memory_stats()
    train = main(["--cfg", CONFIG, *TP_TRAIN_OPTS, *mesh_opts, "OUTPUT_DIR", os.path.join(out_dir, "train")])
    train_peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    launches = _launches()

    cfg = load_config(CONFIG, TP_FP32_OPTS + mesh_opts)
    grid = mesh.build_mesh(cfg, dev)
    model = build_few_shot_model(cfg, flow="train", device=dev)
    mesh.broadcast_module(model.head)
    tensor.shard_module(model.head, grid.model_shard)
    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=1) as loader:
        batch = next(iter(loader)).to(dev)
    metrics = make_grad_fn(model.head, cfg, model.text_train, model.text_test)(batch, None)
    named = dict(model.head.named_parameters())
    full = lambda p: tensor.spec(p).gather(p.grad) if tensor.spec(p) is not None else p.grad  # noqa: E731
    fp32 = {"loss": float(metrics["loss"]), "grads": {n: full(named[n]).float().cpu() for n in TP_FP32_PICKED}}
    del model, batch, named
    torch.cuda.empty_cache()
    t = train["train_few_shot"]
    return {"test_logits": test["episode_logits"], "test_episodes": test["episodes"], "test_seconds": test["seconds"], "test_peak": test_peak,
            "flash_logits": flash["episode_logits"], "losses": t["losses"], "updates": t["updates"], "step_seconds": t["seconds"] / TP_STEPS,
            "train_peak": train_peak, "after_logits": train["test_few_shot"]["episode_logits"], "fp32": fp32, "launches": launches}


def tp_worker(rank: int, store: str, out_dir: str) -> None:
    """One rank of the tensor-parallel phase: joins a two-rank gloo group on card 0 and runs ``_tp_runs`` at MODEL 2 in
    ``out_dir`` (the ranks share it: rank 0 writes the checkpoints), then saves what it saw to ``out_dir/rank<r>.pt``."""
    import datetime

    import torch.distributed as dist

    from clip_fsar_torch.parallel import mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2, timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    try:
        run = _tp_runs(out_dir, TP_OPTS)
    finally:
        mesh.destroy()
    torch.save(run, os.path.join(out_dir, f"rank{rank}.pt"))


def _tp_kernels() -> dict:
    """K1 and K2 at one rank's shape of the flagship's train chunk, [480, 197, 1152] bf16 (6 heads of 64), against their
    plain versions: the error, both times taken in turn, the library call and the bound (a ``kernels`` record each)."""
    from clip_fsar_torch.ops.fused_attention import _heads_split, clip_mha_bwd_cuda, clip_mha_bwd_reference, clip_mha_cuda, clip_mha_reference

    g = torch.Generator().manual_seed(7)
    b, n, d3 = TP_SHAPE
    h = TP_HEADS
    qkv = torch.randn(b, n, d3, generator=g).to("cuda", torch.bfloat16)
    do = torch.randn(b, n, d3 // 3, generator=g).to("cuda", torch.bfloat16)
    err = _check_forward(f"K1 clip_mha_fwd {list(TP_SHAPE)} H={h} bf16 (one model rank's heads)", lambda: clip_mha_cuda(qkv, h),
                         lambda: clip_mha_reference(qkv, h), TOLERANCE[torch.bfloat16])
    ms, plain_ms, _ = _alternate(lambda: clip_mha_cuda(qkv, h), lambda: clip_mha_reference(qkv, h))
    fwd = {"shape": list(TP_SHAPE), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": _sdpa_ms(*_heads_split(qkv, h)),
           **_attention_bound(b, n, h, 64, tensors_in=3, tensors_out=1, rows_fp32=1, products=2)}
    o, lse = clip_mha_cuda(qkv, h)
    dqkv = clip_mha_bwd_cuda(qkv, o, lse, do, h)
    torch.cuda.synchronize()
    ref = clip_mha_bwd_reference(qkv, o, lse, do, h)
    berr = (dqkv.float() - ref.float()).abs().max().item()
    print(f"K2 clip_mha_bwd {list(TP_SHAPE)} H={h} bf16 (one model rank's heads): max|dqkv-ref| {berr:.3e} (tol {TOLERANCE[torch.bfloat16]})")
    if not torch.isfinite(dqkv.float()).all():
        raise AssertionError("K2 at the tensor-parallel shape: dqkv is not finite")
    torch.testing.assert_close(dqkv.float(), ref.float(), atol=TOLERANCE[torch.bfloat16], rtol=TOLERANCE[torch.bfloat16])
    bms, bplain_ms, _ = _alternate(lambda: clip_mha_bwd_cuda(qkv, o, lse, do, h), lambda: clip_mha_bwd_reference(qkv, o, lse, do, h))
    leaf = qkv.detach().requires_grad_(True)
    bwd = {"shape": list(TP_SHAPE), "max_abs_err": berr, "ms": bms, "plain_ms": bplain_ms,
           "library_ms": _sdpa_bwd_ms(_heads_split(leaf, h), do.reshape(b, n, h, 64).transpose(1, 2), wrt=leaf),
           **_attention_bound(b, n, h, 64, tensors_in=5, tensors_out=3, rows_fp32=1, products=5)}
    for name, r in (("clip_mha_fwd", fwd), ("clip_mha_bwd", bwd)):
        print(f"{name} {list(TP_SHAPE)} bf16 at one model rank's heads: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; {100 * r['bound_ms'] / r['ms']:.1f} % of it reached)")
    return {"clip_mha_fwd": fwd, "clip_mha_bwd": bwd}


def phase_tensor_parallel(out_dir: str, card_line: str) -> dict:
    """TPU.MESH {DATA: 1, MODEL: 2}: K1 and K2 at one rank's heads against their plain versions; the phase's runs
    with no process group here, then as two gloo processes on card 0 (``chip_smoke.py --tp-worker``; gloo reduces
    CUDA tensors through the host, so its step times are no tensor-parallel speed): the bf16 test slice's logits, the
    flash step's and the train cut's losses at PERF.md section 2's 2e-2, the fp32 step's loss and picked gradients at
    TP_FP32_TOL, the two ranks' losses and logits the same bits, K1 / K2 launched at the local shapes as TP_LAUNCHES
    says on each rank.  Each rank has TP_TIMEOUT_S; one that fails fails the phase."""
    import subprocess
    import sys

    kernels = _tp_kernels()
    one = _tp_runs(os.path.join(out_dir, "alone"), [])
    torch.cuda.empty_cache()
    run_dir = os.path.join(out_dir, "tp")
    os.makedirs(run_dir)
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    logs = [open(os.path.join(out_dir, f"tp_rank{r}.log"), "w") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-worker", str(r), os.path.join(out_dir, "tp_store"), run_dir],
                              cwd=REPO, env=env, stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    try:
        while any(p.poll() is None for p in procs) and time.perf_counter() - t0 < TP_TIMEOUT_S:
            if any(p.poll() not in (None, 0) for p in procs):
                break  # a rank failed: its peer would wait for it until the group's timeout
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out_dir, f"tp_rank{r}.log")) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"tensor parallel: rank {r} exited with {p.returncode} after {wall:.0f} s:\n{tail}")
    ranks = [torch.load(os.path.join(run_dir, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    r0 = ranks[0]
    errs = {"test logits": float(np.abs(r0["test_logits"] - one["test_logits"]).max()),
            "flash logits (against the fused run's)": float(np.abs(r0["flash_logits"] - one["test_logits"][:4]).max()),
            "losses": max(abs(a - b) for a, b in zip(r0["losses"], one["losses"])),
            "logits after training": float(np.abs(r0["after_logits"] - one["after_logits"]).max())}
    fp32 = {"loss": abs(r0["fp32"]["loss"] - one["fp32"]["loss"]) / abs(one["fp32"]["loss"]),
            **{n: ((g - one["fp32"]["grads"][n]).norm() / one["fp32"]["grads"][n].norm()).item() for n, g in r0["fp32"]["grads"].items()}}
    gib = 2**30
    print(f"tensor parallel, MODEL 2 over gloo on one card ({card_line}; both ranks share the card and reduce through the host: no "
          f"tensor-parallel speed): bf16 against no process group: " + ", ".join(f"{k} max diff {v:.3e}" for k, v in errs.items())
          + f" (tol 2e-2); fp32 step: " + ", ".join(f"{k} {v:.3e}" for k, v in fp32.items()) + f" (relative, tol {TP_FP32_TOL}); losses "
          f"{r0['losses']} against {one['losses']}; per rank: the CLI's train step "
          + ", ".join(f"rank {i} {r['step_seconds']:.2f} s" for i, r in enumerate(ranks)) + f" against {one['step_seconds']:.2f} s; peak train "
          + ", ".join(f"rank {i} {r['train_peak'] / gib:.2f} GiB" for i, r in enumerate(ranks)) + f" against {one['train_peak'] / gib:.2f} GiB, test "
          + ", ".join(f"rank {i} {r['test_peak'] / gib:.2f} GiB" for i, r in enumerate(ranks)) + f" against {one['test_peak'] / gib:.2f} GiB; "
          f"{wall:.1f} s with the processes' start; launches per rank {[r['launches'] for r in ranks]}")
    for key, got in errs.items():
        if not got <= 2e-2:
            raise AssertionError(f"tensor parallel: {key} differ from the run without a process group by {got:.3e}")
    for key, got in fp32.items():
        if not got <= TP_FP32_TOL:
            raise AssertionError(f"tensor parallel: the fp32 step's {key} differs from the run without a process group by {got:.3e}")
    if ranks[0]["losses"] != ranks[1]["losses"] or not np.array_equal(ranks[0]["test_logits"], ranks[1]["test_logits"]):
        raise AssertionError("tensor parallel: the two model ranks disagree")
    if r0["updates"] != TP_STEPS or len(r0["losses"]) != TP_STEPS or r0["test_episodes"] != 16:
        raise AssertionError(f"tensor parallel: {r0['updates']} updates of {len(r0['losses'])} steps, {r0['test_episodes']} test episodes")
    for i, r in enumerate(ranks):
        got = {name: r["launches"][name] for name in TP_LAUNCHES}
        if got != TP_LAUNCHES or any(n for name, n in r["launches"].items() if name not in TP_LAUNCHES):
            raise AssertionError(f"tensor parallel: rank {i} launched {r['launches']}, expected {TP_LAUNCHES}")
    return {"kernels": kernels, "launches": {name: {f"rank{i}": r["launches"][name] for i, r in enumerate(ranks)} for name in _launches()},
            "seconds": wall, "step_s": [r["step_seconds"] for r in ranks], "alone_step_s": one["step_seconds"],
            "peak_gib": [r["train_peak"] / gib for r in ranks]}


def _repeat_classic_steps(name: str, batch) -> None:
    """Two train steps of the classic slice's fresh model, run twice from one seed: the same loss bits and the same
    parameters and running stats (F5: MoLo's decoder upsampling once added its gradient with atomics)."""
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.runs.run import load_config
    from clip_fsar_torch.train.loop import step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState
    from clip_fsar_torch.train.step import make_train_step

    dev = batch.support_images.device
    cfg = load_config(os.path.join(REPO, CLASSIC_CONFIGS[name]), _classic_opts(name) + ["TRAIN.BATCH_SIZE_PER_TASK", "1"])
    runs = []
    for _ in range(2):
        model = build_few_shot_model(cfg, flow="train", device=dev)
        state = TrainState.create(cfg, model.head, Optimizer(cfg, model.head))
        step = make_train_step(model.head, cfg, model.text_train, model.text_test)
        losses = torch.stack([step(state, batch, 1e-3, step_generator(cfg, i, dev))["loss"] for i in range(2)]).cpu()
        runs.append((losses, {k: v.detach().clone() for k, v in model.head.state_dict().items()}))
        del model, state, step
        torch.cuda.empty_cache()
    (la, sa), (lb, sb) = runs
    differ = sorted(k for k in sa if not torch.equal(sa[k], sb[k]))
    print(f"{name}: 2 train steps (2 Adam updates) run twice from one seed: losses {la.tolist()} / {lb.tolist()}; loss bits equal: "
          f"{torch.equal(la, lb)}; entries that differ: {differ[:5] or 'none'}")
    if not torch.equal(la, lb) or differ:
        raise AssertionError(f"{name}: two runs of the same train steps differ")


# --- the classification task (phases 24-26) ---------------------------------------------------------------------------
CLS_CONFIG = os.path.join("configs", "classification", "TAda2D_K400.yaml")
CLS_TRAIN_VIDEOS, CLS_TEST_VIDEOS = 64, 16  # one epoch of 8 steps at the preset's global batch of 8; 16 test videos
CLS_VIEWS = 30  # the multi-scale re-test on Kinetics: 10 views x 3 spatial crops
# bf16 against fp32 on the same weights and clips (fresh TAda2D-R50: logits of a few hundredths, fc init std 0.01):
# train-mode logits within CLS_LOGIT_SHARE of the largest fp32 logit, as the classic heads' (PERF.md 2); the step's loss
# at 2e-2 and the gradients by norm-relative error, the last conv at GRAD_REL_TOL and the stem conv and the classifier,
# whose inputs carry the rounding of every layer before them, at CLASSIC_HEAD_GRAD_TOL
CLS_LOGIT_SHARE = 5e-2
CLS_PICKED = {"backbone.conv5.res_3.conv_branch.c.weight": GRAD_REL_TOL, "backbone.conv1.a.weight": CLASSIC_HEAD_GRAD_TOL,
              "head.out.weight": CLASSIC_HEAD_GRAD_TOL}
CLS_PRESETS = ["r2d3ds", "r2p1d", "csn", "s3dg", "slowfast_4x16", "slowfast_8x8", "timesformer", "vivit", "vivit_fac_enc"]
# bf16 eval logits (before the softmax, which fresh SlowFast weights saturate: logits in the hundreds) against fp32, a
# share of the largest fp32 logit, as the classic heads' test logits (PERF.md 2)
CLS_PRESET_EVAL_SHARE = 5e-2
CLS_DP_OPTS = ["TEST.AUTOMATIC_MULTI_SCALE_TEST", "False"]


def _pool_sites(model) -> dict:
    """The pools one forward of a video model runs, by the backward kernel each one's gradient launches
    (ops/pool3d.py): a max-pool for each DownSampleStem and Inception block and four for Inception3D itself (two after
    the stem, two between stages), an average pool for each TAdaConv pooled branch."""
    from clip_fsar_torch.models.video.blocks import DownSampleStem
    from clip_fsar_torch.models.video.branches import TAdaConvBlockAvgPool
    from clip_fsar_torch.models.video.meta import Inception3D, InceptionBlock3D

    sites = {"max_pool3d_bwd": 0, "avg_pool3d_bwd": 0}
    for m in model.modules():
        if isinstance(m, (DownSampleStem, InceptionBlock3D)):
            sites["max_pool3d_bwd"] += 1
        elif isinstance(m, Inception3D):
            sites["max_pool3d_bwd"] += 2 + sum(isinstance(item, tuple) for item in m.layout)
        elif isinstance(m, TAdaConvBlockAvgPool):
            sites["avg_pool3d_bwd"] += 1
    return sites


def _pool_launches(model, steps: int) -> dict:
    """The pools' backward launches of ``steps`` train steps of ``model`` (one backward each), by kernel."""
    return {name: n * steps for name, n in _pool_sites(model).items() if n}


def _cls_lists(root: str, train: int = CLS_TRAIN_VIDEOS, test: int = CLS_TEST_VIDEOS) -> str:
    """Kinetics-400 list files of synthetic videos (the synthetic decoder keys its frames off the path)."""
    os.makedirs(root, exist_ok=True)
    for split, n in (("train", train), ("test", test)):
        with open(os.path.join(root, f"kinetics400_{split}_list.txt"), "w") as f:
            for i in range(n):
                f.write(f"{split}/video_{i:04d}.mp4 {(i * 37) % 400}\n")
    return root


def _cls_opts(out_dir: str, lists: str) -> list:
    return ["DATA.DECODER", "synthetic", "DATA.ANNO_DIR", lists, "SOLVER.MAX_EPOCH", "1", "TRAIN.EVAL_PERIOD", "1", "OUTPUT_DIR", out_dir]


def _with_dtype(model, dtype: torch.dtype):
    """A copy of a video model (the same weights) that computes in ``dtype``: its modules' compute dtypes replaced."""
    import copy

    twin = copy.deepcopy(model)
    for m in twin.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype
    return twin


def _cls_batch(cfg, dev, seed: int = 0) -> tuple:
    g = torch.Generator(device=dev).manual_seed(seed)
    b, t, crop = int(cfg.TRAIN.BATCH_SIZE), int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TRAIN_CROP_SIZE)
    videos = torch.randint(0, 256, (b, t, crop, crop, 3), generator=g, device=dev, dtype=torch.uint8)
    return videos, torch.randint(0, int(cfg.VIDEO.HEAD.NUM_CLASSES), (b,), generator=g, device=dev, dtype=torch.int32)


def _cls_loss_and_grads(model, cfg, videos, labels) -> tuple:
    """One train-mode forward and backward without the optimizer: the loss (softmax cross-entropy) and the picked
    gradients in float32."""
    from clip_fsar_torch.data.transforms import normalize_images

    logits = model(normalize_images(videos, cfg.DATA.MEAN, cfg.DATA.STD), train=True)[0]
    loss = F.cross_entropy(logits.float(), labels.long())
    model.zero_grad(set_to_none=True)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters() if n in CLS_PICKED}
    model.zero_grad(set_to_none=True)
    return logits.detach().float(), loss.item(), grads


def _resident(run, steps: int = 4) -> dict:
    """``run(i)`` (one train step with its batch resident on the card, returning its loss) after a warm-up step: CUDA-event
    ms a step over ``steps``, the host's ms to queue one, the card's busy ms a step under the profiler, any synchronisation
    with the device inside the timed steps (torch's sync debug mode), and whether every loss was finite."""
    import warnings

    from clip_fsar_torch.tools.profile_eval import _busy_us, _device_events

    run(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            start.record()
            t0 = time.perf_counter()
            losses = [run(i) for i in range(1, steps + 1)]
            host_ms = (time.perf_counter() - t0) * 1e3 / steps
            end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    waits = sorted({f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)})
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(2):
            run(steps + 1 + i)
        torch.cuda.synchronize()
    return {"step_ms": start.elapsed_time(end) / steps, "host_ms": host_ms, "busy_ms": _busy_us(_device_events(prof)) / 1e3 / 2, "waits": waits,
            "finite": all(bool(torch.isfinite(v)) for v in losses)}


def _cls_resident(model, cfg, videos, labels, steps: int = 6) -> dict:
    """The bf16 train step (``make_classification_train_step``: jitter and erasing off as the preset has them, the
    optimizer's update) with its batch resident, timed by ``_resident``."""
    from clip_fsar_torch.train.classification import make_classification_train_step, step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    dev = videos.device
    state = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
    step = make_classification_train_step(model, cfg)
    return _resident(lambda i: step(state, videos, labels, 1e-6, step_generator(cfg, 0, i, dev))["loss"], steps)


def phase_classification(out_dir: str, card_line: str) -> dict:
    """Phase 24: TAda2D-R50 on Kinetics-400 (configs/classification/TAda2D_K400.yaml: the reference framework's
    tada2d backbone preset and from_scratch_large run preset, 16 frames at 224 px, global batch 8, 400 classes) through
    the CLI at full width: one epoch of 8 steps on 64 synthetic videos, validation, the checkpoint, the test of that
    checkpoint on 16 videos and the automatic multi-scale re-test (10 views x 3 crops, 480 clips); no kernel launched.
    Then bf16 against fp32 on one batch (train-mode logits, one step's loss and gradients) and the resident bf16 step."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.models.video.model import build_video_model
    from clip_fsar_torch.runs.run import load_config, main

    lists = _cls_lists(os.path.join(out_dir, "lists"))
    opts = _cls_opts(os.path.join(out_dir, "run"), lists)
    cfg = load_config(os.path.join(REPO, CLS_CONFIG), opts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    results = main(["--cfg", os.path.join(REPO, CLS_CONFIG), *opts])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()  # held below to the model's pools, once it is built
    peak = torch.cuda.max_memory_allocated()
    train, (single, multi) = results["train"], results["test"]
    batch = int(cfg.TRAIN.BATCH_SIZE)
    print(f"classification TAda2D-R50 K400 through the CLI: losses per step {[round(x, 5) for x in train['losses']]}; {train['updates']} updates; "
          f"val top1 {train['best_top1']:.3f}; test top1 {single['top1_acc']:.3f} top5 {single['top5_acc']:.3f} ({single['clips_per_video']} clip a "
          f"video); multi-scale re-test top1 {multi['top1_acc']:.3f} top5 {multi['top5_acc']:.3f} ({multi['clips_per_video']} clips a video)")
    steps = CLS_TRAIN_VIDEOS // batch
    if len(train["losses"]) != steps or not np.isfinite(train["losses"]).all() or train["updates"] != steps:
        raise AssertionError(f"expected {steps} finite losses and updates, got {train['losses']}, {train['updates']} updates")
    if not single["weights"].endswith(os.path.join("checkpoints", "1.pt")) or multi["weights"] != single["weights"]:
        raise AssertionError(f"the tests read {single['weights']} and {multi['weights']}, not the epoch-1 checkpoint")
    if single["clips_per_video"] != 1 or multi["clips_per_video"] != CLS_VIEWS or multi["clips"] != CLS_TEST_VIDEOS * CLS_VIEWS:
        raise AssertionError(f"the tests saw {single['clips_per_video']} and {multi['clips_per_video']} clips a video ({multi['clips']} clips)")
    for r in (single, multi):
        if not all(np.isfinite(r[k]) for k in ("top1_acc", "top5_acc")):
            raise AssertionError(f"non-finite test result {r}")
    print(f"classification on {card_line}: train {train['clips_per_s']:.3f} clips/s ({steps} steps of {batch} clips x 16 frames, loader "
          f"included); test {single['clips_per_s']:.3f} clips/s ({single['clips']} clips), multi-scale re-test {multi['clips_per_s']:.3f} clips/s "
          f"({multi['clips']} clips); CLI wall {wall:.2f} s; peak {peak / 2**30:.3f} GiB; launches {launches}")

    dev = runtime.device("cuda")
    videos, labels = _cls_batch(cfg, dev)
    fp32 = build_video_model(cfg, dtype=torch.float32, device=dev)
    # the pools' backward kernel once per pool of each train step (the tests run no backward)
    _expect_launches("the TAda2D classification run (train, validation, test, multi-scale re-test)", launches, **_pool_launches(fp32, steps))
    bf16 = _with_dtype(fp32, torch.bfloat16)
    want, got = _cls_loss_and_grads(fp32, cfg, videos, labels), _cls_loss_and_grads(bf16, cfg, videos, labels)
    diff, scale = (got[0] - want[0]).abs().max().item(), want[0].abs().max().item()
    print(f"TAda2D-R50 bf16 vs fp32 (one batch of {batch} x 16 frames at 224 px): train-mode logits max abs diff {diff:.4e}, {diff / scale:.3e} of "
          f"the largest fp32 logit {scale:.4e} (tol {CLS_LOGIT_SHARE}); loss {got[1]:.6f} vs {want[1]:.6f} (tol 2e-2)")
    if not diff <= CLS_LOGIT_SHARE * scale:
        raise AssertionError(f"TAda2D bf16 logits differ from fp32 by {diff:.4e}, more than {CLS_LOGIT_SHARE} of {scale:.4e}")
    torch.testing.assert_close(torch.tensor(got[1]), torch.tensor(want[1]), atol=2e-2, rtol=2e-2)
    for name, tol in CLS_PICKED.items():
        g = want[2][name]
        rel = ((got[2][name] - g).norm() / g.norm()).item()
        print(f"TAda2D-R50 bf16 vs fp32: grad {name}: norm-relative difference {rel:.3e} (tol {tol}); |grad| = {g.norm().item():.4e}")
        if not rel <= tol:
            raise AssertionError(f"TAda2D: the gradient of {name} differs by {rel:.3e} (norm-relative)")
    del fp32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timed = _cls_resident(bf16, cfg, videos, labels)
    step_peak = torch.cuda.max_memory_allocated()
    print(f"TAda2D-R50 train step on {card_line}, batch resident ({batch} clips x 16 frames at 224 px, bf16): {timed['step_ms']:.1f} ms a step "
          f"(CUDA events, 6 steps); the host queued a step in {timed['host_ms']:.1f} ms; the card busy {timed['busy_ms']:.1f} ms a step "
          f"(profiler); {batch / timed['step_ms'] * 1e3:.2f} clips/s; peak {step_peak / 2**30:.3f} GiB; synchronisations inside the steps: "
          f"{timed['waits'] or 'none'}")
    if timed["waits"] or not timed["finite"]:
        raise AssertionError(f"the classification train step waited for the card at {timed['waits']} or lost its loss")
    del bf16, videos, labels
    torch.cuda.empty_cache()
    return {"launches": launches, "train_clips_per_s": train["clips_per_s"], "test_clips_per_s": single["clips_per_s"],
            "retest_clips_per_s": multi["clips_per_s"], "peak_gib": peak / 2**30, **timed}


def _preset_cfg(preset: str, out_dir: str):
    """The preset at full width over from_scratch_large.yaml, with the preset's own DATA where it has one."""
    import yaml

    from clip_fsar_torch.runs.run import load_config

    path = os.path.join(out_dir, f"{preset}.yaml")
    with open(path, "w") as f:
        f.write(f"_BASE_RUN: {os.path.join(REPO, 'configs', 'pool', 'run', 'training', 'from_scratch_large.yaml')}\n"
                f"_BASE_MODEL: {os.path.join(REPO, 'configs', 'pool', 'backbone', preset + '.yaml')}\n"
                "TASK_TYPE: classification\nTRAIN:\n  BATCH_SIZE: 2\nVIDEO:\n  HEAD:\n    NUM_CLASSES: 400\n")
    with open(os.path.join(REPO, "configs", "pool", "backbone", f"{preset}.yaml")) as f:
        data = yaml.safe_load(f).get("DATA", {})
    return load_config(path, [x for k, v in data.items() for x in (f"DATA.{k}", str(v))])


def phase_presets(out_dir: str, card_line: str) -> dict:
    """Phase 25: every other backbone preset at full width on the card: batch 2, one eval forward in bf16 against fp32
    on the same weights and clips (its logits; its softmax finite), one bf16 train step (draws from its generator)
    timed after a warm-up, its peak."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data.transforms import normalize_images
    from clip_fsar_torch.models.video.model import build_video_model
    from clip_fsar_torch.train.classification import make_classification_train_step, step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    dev = runtime.device("cuda")
    _reset_launches()
    out, want_launches = {}, {}
    for preset in CLS_PRESETS:
        cfg = _preset_cfg(preset, out_dir)
        videos, labels = _cls_batch(cfg, dev, seed=1)
        fp32 = build_video_model(cfg, dtype=torch.float32, device=dev)
        bf16 = _with_dtype(fp32, torch.bfloat16)
        x = normalize_images(videos, cfg.DATA.MEAN, cfg.DATA.STD)
        with torch.no_grad():  # the eval forward before its softmax: BatchNorm never trains, dropout needs a generator
            want, got = fp32(x, train=True)[0], bf16(x, train=True)[0].float()
            eval_ok = bool(torch.isfinite(bf16(x, train=False)[0]).all())
        del fp32
        torch.cuda.empty_cache()
        diff, scale = (got - want).abs().max().item(), want.abs().max().item()
        torch.cuda.reset_peak_memory_stats()
        state = TrainState.create(cfg, bf16, Optimizer(cfg, bf16, name_prefix=""))
        step = make_classification_train_step(bf16, cfg)
        step(state, videos, labels, 1e-6, step_generator(cfg, 0, 0, dev))
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = [step(state, videos, labels, 1e-6, step_generator(cfg, 0, i, dev)) for i in (1, 2)]
        end.record()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = start.elapsed_time(end) / 2
        finite = all(bool(torch.isfinite(m["loss"])) for m in metrics) and bool(torch.isfinite(got).all()) and eval_ok
        print(f"preset {preset} ({cfg.VIDEO.BACKBONE.META_ARCH}, {cfg.DATA.NUM_INPUT_FRAMES} frames at {cfg.DATA.TRAIN_CROP_SIZE} px, batch 2) on "
              f"{card_line}: bf16 eval logits vs fp32 max abs diff {diff:.4e}, {diff / scale:.3e} of the largest {scale:.4e} (tol "
              f"{CLS_PRESET_EVAL_SHARE}); bf16 train step {ms:.1f} ms (CUDA events, 2 steps), loss {float(metrics[-1]['loss']):.5f}; peak "
              f"{peak / 2**30:.3f} GiB")
        if not finite or not diff <= CLS_PRESET_EVAL_SHARE * scale:
            raise AssertionError(f"preset {preset}: finite {finite}, bf16 eval logits differ from fp32 by {diff:.4e} of {scale:.4e}")
        out[preset] = {"step_ms": ms, "peak_gib": peak / 2**30, "eval_share": diff / scale}
        for name, n in _pool_launches(bf16, 3).items():  # three train steps
            want_launches[name] = want_launches.get(name, 0) + n
        del bf16, state, step, videos, labels, x
        torch.cuda.empty_cache()
    return {"launches": _expect_launches("the backbone presets", **want_launches), "presets": out}


def _cls_dp_run(out_dir: str, lists: str) -> dict:
    from clip_fsar_torch.runs.run import main

    opts = _cls_opts(out_dir, lists) + CLS_DP_OPTS
    results = main(["--cfg", os.path.join(REPO, CLS_CONFIG), *opts])
    ckpt = torch.load(os.path.join(out_dir, "checkpoints", "1.pt"), map_location="cpu", weights_only=True)["head"]
    return {"losses": results["train"]["losses"], "state": ckpt, "preds": results["test"]["meter"].video_preds}


def phase_classification_dp(out_dir: str, card_line: str) -> dict:
    """Phase 26: the TAda2D classification run (2 steps on 16 videos, validation, checkpoint, the test on 8 videos)
    through the CLI with no process group and then as the one rank of an NCCL group (its gradient and metric
    all-reduces, the eval gathers and the rank-0 checkpoint all run): the same loss bits, checkpoint and test scores."""
    from clip_fsar_torch.parallel import mesh

    lists = _cls_lists(os.path.join(out_dir, "lists"), train=16, test=8)
    _reset_launches()
    alone = _cls_dp_run(os.path.join(out_dir, "alone"), lists)
    _nccl_world1(os.path.join(out_dir, "nccl_store"))
    try:
        grouped = _cls_dp_run(os.path.join(out_dir, "nccl"), lists)
    finally:
        mesh.destroy()
    from clip_fsar_torch import runtime
    from clip_fsar_torch.models.video.model import build_video_model
    from clip_fsar_torch.runs.run import load_config

    launches = _launches()
    model = build_video_model(load_config(os.path.join(REPO, CLS_CONFIG), _cls_opts(out_dir, lists)), device=runtime.device("cuda"))
    launches = _expect_launches("the classification runs with and without a process group", launches, **_pool_launches(model, 2 * len(alone["losses"])))
    del model
    same = {"losses": grouped["losses"] == alone["losses"], "checkpoint": all(torch.equal(grouped["state"][k], v) for k, v in alone["state"].items()),
            "test_scores": np.array_equal(grouped["preds"], alone["preds"])}
    print(f"classification data parallel, world 1 over NCCL on {card_line}: the same bits as without a process group: {same}; losses {grouped['losses']}")
    if not all(same.values()):
        raise AssertionError(f"classification under a one-rank NCCL group differs from the run without one: {same}")
    return {"launches": launches}


# --- the localization task and MoSI pretraining (phases 27-28) ---------------------------------------------------------
BMN_CONFIG = os.path.join("configs", "localization", "BMN_EPIC100.yaml")
# the preset's TRAIN.BATCH_SIZE 64 and TEST.BATCH_SIZE 128 are over its NUM_GPUS 8: 8 windows a step on the one card
BMN_BATCH = 8
BMN_OPTS = ["DATA.DECODER", "synthetic", "TRAIN.BATCH_SIZE", str(BMN_BATCH), "TEST.BATCH_SIZE", str(BMN_BATCH), "SOLVER.MAX_EPOCH", "1",
            "LOG_PERIOD", "1"]
# the card's float32 forward (TF32 off) against the same model's on the CPU, on the first BMN_CPU_WINDOWS windows (a
# full-width CPU forward of 8 windows would take the CPU most of a minute): the maps at 1e-4 absolute (sigmoid outputs
# and logits of fresh weights, sums of up to 8192 products in another order), the loss at 1e-4 relative
BMN_CPU_WINDOWS, BMN_MAP_ATOL, BMN_LOSS_RTOL = 2, 1e-4, 1e-4
MOSI_CONFIG = os.path.join("configs", "pretrain", "MoSI_R2D3D_HMDB51.yaml")
MOSI_TRAIN_VIDEOS, MOSI_TEST_VIDEOS = 40, 20  # one epoch of 4 steps of 10 videos (90 clips each); a validation of 2 batches
MOSI_CLIPS = 9  # 5 speeds per axis, decoupled: 4 x-speeds, 4 y-speeds and the static clip
MOSI_OPTS: list = []  # overrides of the preset (none: full width)
# bf16 against fp32 on the same weights and clips, as the classification phase holds TAda2D: the logits to a share of the
# largest fp32 logit, the loss at 2e-2, the last conv's gradient at GRAD_REL_TOL and the first conv's and the head's at
# CLASSIC_HEAD_GRAD_TOL (norm-relative)
MOSI_LOGIT_SHARE = 5e-2


def phase_localization(out_dir: str, card_line: str) -> dict:
    """Phase 27: BMN on EPIC-Kitchens-100 features at full width (configs/localization/BMN_EPIC100.yaml: T = D = 200,
    2304 channels, N = 32 samples, the regression and 97 / 300 verb / noun maps; synthetic features, fresh weights) through
    the CLI: one epoch at 8 windows a step, the test of its checkpoint (mAP of three streams) and the submission of it;
    no kernel launched.  Then the card's fp32 forward and loss against the CPU's on the same windows, and the train step
    with its batch resident."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data.tal_features import TalFeatureDataset, duration_scale
    from clip_fsar_torch.models.heads import bmn
    from clip_fsar_torch.runs.run import load_config, main
    from clip_fsar_torch.train import localization as loc
    from clip_fsar_torch.train.localization_losses import pem_reg_draws
    from clip_fsar_torch.train.losses import calculate_loss
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    path = os.path.join(REPO, BMN_CONFIG)
    opts = BMN_OPTS + ["OUTPUT_DIR", os.path.join(out_dir, "bmn")]
    cfg = load_config(path, opts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    results = main(["--cfg", path, *opts])
    sub = main(["--cfg", path, *opts, "TASK_TYPE", "submission"])["submission_test"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _expect_launches("the BMN runs (train, test, submission)")
    peak = torch.cuda.max_memory_allocated()
    train, test = results["train_localization"], results["test_epic_localization"]
    h = cfg.VIDEO.HEAD
    key = (int(cfg.DATA.TEMPORAL_SCALE), duration_scale(cfg), int(h.NUM_SAMPLE), int(h.NUM_SAMPLE_PERBIN), float(h.BOUNDARY_RATIO))
    ds = TalFeatureDataset(cfg, "train")
    steps = -(-len(ds) // BMN_BATCH)
    stats = {k: v for k, v in test.items() if "/mAP" in k}
    with open(sub["path"]) as f:
        sub_json = json.load(f)
    ckpt = torch.load(train["checkpoint"], map_location="cpu", weights_only=True)["head"]
    fresh = loc.build_bmn_model(cfg).state_dict()
    moved = {n: float((ckpt[n] - fresh[n]).abs().max()) for n in ("backbone.conv_0.weight", "head.x_3d_p.weight", "head.x_2d_p_conv4.weight")}
    print(f"BMN EPIC-100 through the CLI: mask [{key[0]}, {key[2]} x {key[1]} x {key[0]}] built in {bmn.MASK_BUILD_SECONDS[key]:.3f} s on the host; "
          f"{len(ds)} train "
          f"windows, losses per step {[round(x, 5) for x in train['losses']]}; parameters moved by {moved}; test of {test['weights']} on "
          f"{test['windows']} windows: {', '.join(f'{k} {v:.4f}' for k, v in stats.items() if k.endswith('mAP_avg'))}; submission "
          f"{len(sub_json['results'])} videos, {sum(len(v) for v in sub_json['results'].values())} detections")
    if len(train["losses"]) != steps or not np.isfinite(train["losses"]).all() or not all(v > 0 for v in moved.values()):
        raise AssertionError(f"expected {steps} finite losses and moved parameters, got {train['losses']}, {moved}")
    if not test["weights"].endswith(os.path.join("checkpoints", "1.pt")) or sub["weights"] != test["weights"]:
        raise AssertionError(f"the test and the submission read {test['weights']} and {sub['weights']}, not the epoch-1 checkpoint")
    if len(stats) != 18 or not all(0.0 <= v <= 1.0 for v in stats.values()):
        raise AssertionError(f"malformed mAP dict {stats}")
    if sub_json.get("version") != "0.2" or set(sub_json["results"]) != set(TalFeatureDataset(cfg, "val").annotations):
        raise AssertionError(f"malformed submission JSON: {sorted(sub_json)}, videos {sorted(sub_json.get('results', {}))}")
    print(f"BMN on {card_line}: train {train['windows_per_s']:.3f} windows/s (loader included), test {test['windows_per_s']:.3f} windows/s "
          f"(proposal parsing, soft-NMS and mAP on the host included); CLI wall {wall:.2f} s; peak {peak / 2**30:.3f} GiB; launches {launches}")

    dev = runtime.device("cuda")
    feats, maps, _ = next(loc._batches(ds, BMN_CPU_WINDOWS, False, 0))
    draws = pem_reg_draws(maps["iou_map"].shape, torch.Generator().manual_seed(0))
    outs, losses = [], []
    for device in (dev, torch.device("cpu")):
        model = loc.build_bmn_model(cfg, device)
        model.load_state_dict(ckpt)
        with torch.no_grad():
            preds = model(torch.from_numpy(feats).to(device))
            loss, _ = calculate_loss(cfg, preds, None, {"supervised": {k: torch.from_numpy(v).to(device) for k, v in maps.items()}},
                                     draws=tuple(d.to(device) for d in draws))
        outs.append({k: v.cpu() for k, v in preds.items()})
        losses.append(float(loss))
        del model, preds
    diffs = {k: float((outs[0][k] - outs[1][k]).abs().max()) for k in outs[0]}
    print(f"BMN fp32 on the card against the CPU ({BMN_CPU_WINDOWS} windows, the epoch-1 weights): max abs diff by map {diffs} (tol "
          f"{BMN_MAP_ATOL}); loss {losses[0]:.7f} vs {losses[1]:.7f} (rtol {BMN_LOSS_RTOL})")
    if not all(d <= BMN_MAP_ATOL for d in diffs.values()) or not abs(losses[0] - losses[1]) <= BMN_LOSS_RTOL * abs(losses[1]):
        raise AssertionError(f"BMN on the card differs from the CPU: {diffs}, losses {losses}")
    torch.cuda.empty_cache()
    feats, maps, _ = next(loc._batches(ds, BMN_BATCH, False, 0))
    x, y = torch.from_numpy(feats).to(dev), {k: torch.from_numpy(v).to(dev) for k, v in maps.items()}
    model = loc.build_bmn_model(cfg, dev)
    state = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
    step = loc.make_localization_train_step(model, cfg)
    torch.cuda.reset_peak_memory_stats()
    timed = _resident(lambda i: step(state, x, y, 1e-4, loc.step_generator(cfg, 0, i, dev))[0])
    step_peak = torch.cuda.max_memory_allocated()
    print(f"BMN train step on {card_line}, batch resident ({BMN_BATCH} windows, fp32): {timed['step_ms']:.1f} ms a step (CUDA events, 4 steps); "
          f"the host queued a step in {timed['host_ms']:.1f} ms; the card busy {timed['busy_ms']:.1f} ms a step (profiler); "
          f"{BMN_BATCH / timed['step_ms'] * 1e3:.2f} windows/s; peak {step_peak / 2**30:.3f} GiB; synchronisations inside the steps: "
          f"{timed['waits'] or 'none'}")
    if timed["waits"] or not timed["finite"]:
        raise AssertionError(f"the BMN train step waited for the card at {timed['waits']} or lost its loss")
    del model, state, step, x, y
    torch.cuda.empty_cache()
    return {"launches": launches, "mask_s": bmn.MASK_BUILD_SECONDS[key], "train_windows_per_s": train["windows_per_s"],
            "test_windows_per_s": test["windows_per_s"], "peak_gib": peak / 2**30, "step_peak_gib": step_peak / 2**30, **timed}


def _mosi_lists(root: str) -> str:
    """HMDB51 list files of synthetic videos (the synthetic decoder keys its frames off the path)."""
    os.makedirs(root, exist_ok=True)
    for split, n in (("train", MOSI_TRAIN_VIDEOS), ("test", MOSI_TEST_VIDEOS)):
        with open(os.path.join(root, f"hmdb51_{split}_list.txt"), "w") as f:
            for i in range(n):
                f.write(f"{split}/video_{i:04d}.avi {i % 51}\n")
    return root


def _mosi_run(out_dir: str, lists: str) -> dict:
    from clip_fsar_torch.runs.run import main

    opts = ["DATA.DECODER", "synthetic", "DATA.ANNO_DIR", lists, "SOLVER.MAX_EPOCH", "1", "TRAIN.EVAL_PERIOD", "1", "LOG_PERIOD", "1",
            "OUTPUT_DIR", out_dir] + MOSI_OPTS
    train = main(["--cfg", os.path.join(REPO, MOSI_CONFIG), *opts])["train"]
    return {**train, "state": torch.load(os.path.join(out_dir, "checkpoints", "1.pt"), map_location="cpu", weights_only=True)["head"]}


def phase_pretrain(out_dir: str, card_line: str) -> dict:
    """Phase 28: MoSI pretraining of R-2D3D-18 at full width (configs/pretrain/MoSI_R2D3D_HMDB51.yaml: 9 pseudo-motion
    clips of 16 frames at 112 px a video, 10 videos a step, the preset's colour jitter and dropout, bf16) through the CLI:
    one epoch of 4 steps and the SSL validation; no kernel launched.  Then bf16 against fp32 on one batch, the resident
    bf16 step, one step under SOLVER.OPTIM_METHOD lars, and the run again without a group and as the one rank of an NCCL
    group."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data.classification import build_classification_loader
    from clip_fsar_torch.data.transforms import normalize_images
    from clip_fsar_torch.models.video.model import build_video_model
    from clip_fsar_torch.parallel import mesh
    from clip_fsar_torch.runs.run import load_config
    from clip_fsar_torch.train.classification import _eval_epoch_ssl, _to_device, make_classification_train_step, step_generator
    from clip_fsar_torch.train.losses import calculate_loss
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    lists = _mosi_lists(os.path.join(out_dir, "lists"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    alone = _mosi_run(os.path.join(out_dir, "alone"), lists)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _expect_launches("the MoSI pretraining run (train, SSL validation)", max_pool3d_bwd=MOSI_TRAIN_VIDEOS // 10)
    peak = torch.cuda.max_memory_allocated()
    steps = MOSI_TRAIN_VIDEOS // 10
    print(f"MoSI R-2D3D-18 HMDB51 through the CLI: losses per step {[round(x, 5) for x in alone['losses']]}; {alone['updates']} updates; "
          f"SSL validation {alone['ssl_val']}")
    if len(alone["losses"]) != steps or not np.isfinite(alone["losses"]).all() or alone["updates"] != steps:
        raise AssertionError(f"expected {steps} finite losses and updates, got {alone['losses']}, {alone['updates']} updates")
    if not np.isfinite(alone["ssl_val"]["loss"]) or "acc_move_joint" not in alone["ssl_val"]:
        raise AssertionError(f"malformed SSL validation {alone['ssl_val']}")
    print(f"MoSI on {card_line}: train {alone['clips_per_s'] * MOSI_CLIPS:.3f} clips/s ({alone['clips_per_s']:.3f} videos/s, loader and "
          f"generator included); CLI wall {wall:.2f} s; peak {peak / 2**30:.3f} GiB; launches {launches}")

    dev = runtime.device("cuda")
    opts = ["DATA.DECODER", "synthetic", "DATA.ANNO_DIR", lists] + MOSI_OPTS
    cfg = load_config(os.path.join(REPO, MOSI_CONFIG), opts)
    videos_host, labels_host, _ = next(iter(build_classification_loader(cfg, "train")))
    videos, labels = _to_device(videos_host, dev), _to_device(labels_host, dev)
    want_shape = (int(cfg.TRAIN.BATCH_SIZE), MOSI_CLIPS, int(cfg.PRETRAIN.NUM_FRAMES), int(cfg.DATA.TRAIN_CROP_SIZE), int(cfg.DATA.TRAIN_CROP_SIZE), 3)
    if tuple(videos.shape) != want_shape:
        raise AssertionError(f"the MoSI batch is {tuple(videos.shape)}")
    fp32 = build_video_model(cfg, dtype=torch.float32, device=dev)
    bf16 = _with_dtype(fp32, torch.bfloat16)
    convs = [n for n, p in fp32.named_parameters() if p.dim() == 5]
    picked = {convs[-1]: GRAD_REL_TOL, convs[0]: CLASSIC_HEAD_GRAD_TOL, "net.head.out_move_joint.weight": CLASSIC_HEAD_GRAD_TOL}

    def loss_and_grads(model):
        preds, logits = model(normalize_images(videos, cfg.DATA.MEAN, cfg.DATA.STD), train=True)
        loss, _ = calculate_loss(cfg, preds, logits, {"self-supervised": labels})
        model.zero_grad(set_to_none=True)
        loss.backward()
        grads = {n: p.grad.float().clone() for n, p in model.named_parameters() if n in picked}
        model.zero_grad(set_to_none=True)
        return preds["move_joint"].detach().float(), loss.item(), grads

    want, got = loss_and_grads(fp32), loss_and_grads(bf16)
    diff, scale = (got[0] - want[0]).abs().max().item(), want[0].abs().max().item()
    print(f"MoSI R-2D3D-18 bf16 vs fp32 (one batch of 10 x {MOSI_CLIPS} clips x 16 frames at 112 px): train-mode logits max abs diff "
          f"{diff:.4e}, {diff / scale:.3e} of the largest fp32 logit {scale:.4e} (tol {MOSI_LOGIT_SHARE}); loss {got[1]:.6f} vs {want[1]:.6f} (tol 2e-2)")
    if not diff <= MOSI_LOGIT_SHARE * scale or not abs(got[1] - want[1]) <= 2e-2 * (1 + abs(want[1])):
        raise AssertionError(f"MoSI bf16 differs from fp32: logits {diff:.4e} of {scale:.4e}, losses {got[1]} vs {want[1]}")
    for name, tol in picked.items():
        g = want[2][name]
        rel = ((got[2][name] - g).norm() / g.norm()).item()
        print(f"MoSI bf16 vs fp32: grad {name}: norm-relative difference {rel:.3e} (tol {tol}); |grad| = {g.norm().item():.4e}")
        if not rel <= tol:
            raise AssertionError(f"MoSI: the gradient of {name} differs by {rel:.3e} (norm-relative)")
    del fp32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timed = _cls_resident(bf16, cfg, videos, labels, steps=4)
    step_peak = torch.cuda.max_memory_allocated()
    print(f"MoSI train step on {card_line}, batch resident (10 x {MOSI_CLIPS} clips x 16 frames at 112 px, bf16): {timed['step_ms']:.1f} ms a "
          f"step (CUDA events, 4 steps); the host queued a step in {timed['host_ms']:.1f} ms; the card busy {timed['busy_ms']:.1f} ms a step "
          f"(profiler); {10 * MOSI_CLIPS / timed['step_ms'] * 1e3:.2f} clips/s; peak {step_peak / 2**30:.3f} GiB; synchronisations inside "
          f"the steps: {timed['waits'] or 'none'}")
    if timed["waits"] or not timed["finite"]:
        raise AssertionError(f"the MoSI train step waited for the card at {timed['waits']} or lost its loss")
    del bf16
    torch.cuda.empty_cache()

    lars_cfg = load_config(os.path.join(REPO, MOSI_CONFIG), opts + ["SOLVER.OPTIM_METHOD", "lars"])
    model = build_video_model(lars_cfg, dtype=torch.bfloat16, device=dev)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState.create(lars_cfg, model, Optimizer(lars_cfg, model, name_prefix=""))
    metrics = make_classification_train_step(model, lars_cfg)(state, videos, labels, 0.1, step_generator(lars_cfg, 0, 0, dev))
    moved = max(float((p.detach() - before[n]).abs().max()) for n, p in model.named_parameters())
    print(f"MoSI one LARS step (lr 0.1): loss {float(metrics['loss']):.5f}, updated {bool(metrics['updated'])}, largest parameter change {moved:.4e}")
    if not (bool(torch.isfinite(metrics["loss"])) and bool(metrics["updated"]) and moved > 0):
        raise AssertionError("the LARS step did not update the parameters")
    del model, state, before, videos, labels
    torch.cuda.empty_cache()

    # two runs without a group, and the run as the one rank of an NCCL group, the same bits: the losses, the trained
    # weights and the SSL validation (the stem's max-pool backward writes each input gradient once, ops/pool3d.py)
    again = _mosi_run(os.path.join(out_dir, "again"), lists)
    model = build_video_model(cfg, device=dev)
    model.load_state_dict(alone["state"])
    val_alone = _eval_epoch_ssl(cfg, model, mesh.build_mesh(cfg, "cuda"))
    _reset_launches()
    _nccl_world1(os.path.join(out_dir, "nccl_store"))
    try:
        grouped = _mosi_run(os.path.join(out_dir, "nccl"), lists)
        val_grouped = _eval_epoch_ssl(cfg, model, mesh.build_mesh(cfg, "cuda"))
    finally:
        mesh.destroy()
    _expect_launches("the MoSI pretraining run under a process group", max_pool3d_bwd=steps)
    del model
    torch.cuda.empty_cache()

    def same_bits(a: dict, b: dict) -> dict:
        return {"losses": a["losses"] == b["losses"], "weights": all(torch.equal(a["state"][k], v) for k, v in b["state"].items()),
                "ssl_validation": a["ssl_val"] == b["ssl_val"]}

    runs, group = same_bits(again, alone), {**same_bits(grouped, alone), "ssl_validation_same_weights": val_grouped == val_alone}
    print(f"MoSI pretraining on {card_line}: two runs without a group the same bits {runs}; world 1 over NCCL against the run without a "
          f"group the same bits {group}; losses {alone['losses']} / {again['losses']} / {grouped['losses']}")
    if not all(runs.values()) or not all(group.values()):
        raise AssertionError(f"MoSI pretraining does not repeat bit for bit: two runs without a group {runs}, under a one-rank NCCL group {group}")
    return {"launches": launches, "train_clips_per_s": alone["clips_per_s"] * MOSI_CLIPS, "peak_gib": peak / 2**30, "step_peak_gib": step_peak / 2**30,
            **timed}


# --- determinism of the train paths, and the pools' backward kernel (phases 30-31) -----------------------------------
# every train path of the port, each probed by one train step under torch.use_deterministic_algorithms(True, warn_only=True)
PROBE_PATHS = ["vit_b16_fused", "vit_b16_flash", "rn50", "hyrsm_pp_5shot", "molo_1shot", "tada2d"] + CLS_PRESETS + ["bmn", "mosi"]
# operations a train path may reach that have no deterministic CUDA implementation, each with the ROADMAP entry that
# files it (none: every such operation a train path reached has been replaced)
DETERMINISM_ALLOWED: dict = {}
PROBED: dict = {}  # train path -> the operations torch named in its probed step
POOL_CASES: list = []  # the pools' backward launches of the probed steps: (path, mode, x shape, kernel, stride, padding, dtype, channels_last)
# one episode a step in one chunk, an optimizer update every step
PROBE_FEW_SHOT_OPTS = ["TPU.EPISODES_PER_STEP", "1", "TPU.EPISODE_CHUNKS", "1", "TRAIN.BATCH_SIZE_PER_TASK", "1"]
# the pools' backward kernel against its plain version: fp32 leaves room for the last bit only (the plain version adds in
# the kernel's order), bf16 for one rounding of the same fp32 sum
POOL_TOLERANCE = {torch.float32: 1e-6, torch.bfloat16: 1e-2}


@contextlib.contextmanager
def _probe(path: str):
    """Run the block, one train step of ``path``, under torch.use_deterministic_algorithms(True, warn_only=True) and
    record in PROBED the operations torch names as having no deterministic CUDA implementation (and any other warning
    about determinism, whole), and in POOL_CASES the shapes the pools' backward kernel was launched at."""
    import warnings

    from clip_fsar_torch.ops import pool3d

    launch = pool3d.pool3d_bwd_cuda

    def recorded(mode, dy, argmax, in_shape, kernel, stride, padding, channels_last):
        POOL_CASES.append((path, mode, tuple(in_shape), tuple(kernel), tuple(stride), tuple(padding), dy.dtype, channels_last))
        return launch(mode, dy, argmax, in_shape, kernel, stride, padding, channels_last)

    torch.cuda.synchronize()
    pool3d.pool3d_bwd_cuda = recorded
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        pool3d.pool3d_bwd_cuda = launch
    named = set()
    for w in caught:
        text = str(w.message)
        if "does not have a deterministic implementation" in text:
            named.add(text.split(" does not have")[0])
        elif "determinis" in text.lower():
            named.add(text[:300])
    PROBED[path] = sorted(named)


def _few_shot_train_step(cfg, dev):
    """A fresh few-shot model of ``cfg`` on the card and its full train step (``make_train_step``: augmentation, forward,
    backward, the optimizer) on one batch of the train loader: ``run(i)`` steps with step i's generator."""
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.train.loop import step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState
    from clip_fsar_torch.train.step import make_train_step

    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=int(cfg.TPU.EPISODES_PER_STEP)) as loader:
        batch = next(iter(loader)).to(dev)
    model = build_few_shot_model(cfg, flow="train", device=dev)
    state = TrainState.create(cfg, model.head, Optimizer(cfg, model.head))
    step = make_train_step(model.head, cfg, model.text_train, model.text_test)
    return lambda i: step(state, batch, 1e-5, step_generator(cfg, i, dev))


def _cls_train_step(cfg, model, videos, labels):
    """The classification train step (``make_classification_train_step``, the optimizer's update included) of ``model``
    on a resident batch: ``run(i)`` steps with step i's generator."""
    from clip_fsar_torch.train.classification import make_classification_train_step, step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    state = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
    step = make_classification_train_step(model, cfg)
    return lambda i: step(state, videos, labels, 1e-6, step_generator(cfg, 0, i, videos.device))


def phase_determinism_probe(out_dir: str, card_line: str) -> None:
    """Phase 30: one train step of every train path that an earlier phase drives (ViT-B/16 on the fused and the flash
    path, RN50, HyRSM++ 5-shot, MoLo 1-shot at one episode a step; TAda2D-R50 at its batch of 8 and the nine other
    presets at 2; BMN at 2 windows; MoSI at its 10 videos) at full width under torch.use_deterministic_algorithms(True,
    warn_only=True): the operations torch names as having no deterministic CUDA implementation, by path.  The shapes of
    the pools' backward launches are kept for phase 31.  The check of what was named comes last (phase 33), after the
    new paths' own probes."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data.classification import build_classification_loader
    from clip_fsar_torch.data.tal_features import TalFeatureDataset
    from clip_fsar_torch.models.video.model import build_video_model
    from clip_fsar_torch.runs.run import load_config
    from clip_fsar_torch.train import localization as loc
    from clip_fsar_torch.train.classification import _to_device
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    dev = runtime.device("cuda")
    few_shot = {"vit_b16_fused": (CONFIG, TRAIN_OPTS), "vit_b16_flash": (CONFIG, TRAIN_OPTS + FLASH_OPTS), "rn50": (CONFIG, RN_TRAIN_OPTS),
                **{name: (os.path.join(REPO, CLASSIC_CONFIGS[name]), _classic_opts(name)) for name in CLASSIC_CONFIGS}}
    for path, (config, opts) in few_shot.items():
        run = _few_shot_train_step(load_config(config, opts + PROBE_FEW_SHOT_OPTS), dev)
        with _probe(path):
            run(0)
        del run
        torch.cuda.empty_cache()
    lists = _cls_lists(os.path.join(out_dir, "probe_lists"))
    video_cfgs = {"tada2d": load_config(os.path.join(REPO, CLS_CONFIG), _cls_opts(out_dir, lists)),
                  **{preset: _preset_cfg(preset, out_dir) for preset in CLS_PRESETS}}
    for path, cfg in video_cfgs.items():
        model = build_video_model(cfg, dtype=torch.bfloat16, device=dev)
        run = _cls_train_step(cfg, model, *_cls_batch(cfg, dev, seed=2))
        with _probe(path):
            run(0)
        del model, run
        torch.cuda.empty_cache()
    cfg = load_config(os.path.join(REPO, BMN_CONFIG), BMN_OPTS)
    feats, maps, _ = next(loc._batches(TalFeatureDataset(cfg, "train"), 2, False, 0))
    x, y = torch.from_numpy(feats).to(dev), {k: torch.from_numpy(v).to(dev) for k, v in maps.items()}
    model = loc.build_bmn_model(cfg, dev)
    state = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
    with _probe("bmn"):
        loc.make_localization_train_step(model, cfg)(state, x, y, 1e-4, loc.step_generator(cfg, 0, 0, dev))
    del model, state, x, y
    torch.cuda.empty_cache()
    cfg = load_config(os.path.join(REPO, MOSI_CONFIG), ["DATA.DECODER", "synthetic", "DATA.ANNO_DIR", _mosi_lists(os.path.join(out_dir, "probe_mosi"))])
    videos, labels, _ = next(iter(build_classification_loader(cfg, "train")))
    model = build_video_model(cfg, dtype=torch.bfloat16, device=dev)
    run = _cls_train_step(cfg, model, _to_device(videos, dev), _to_device(labels, dev))
    with _probe("mosi"):
        run(0)
    del model, run
    torch.cuda.empty_cache()
    for path in PROBE_PATHS:
        print(f"determinism probe on {card_line}: one {path} train step: operations without a deterministic CUDA implementation "
              f"{PROBED[path] or 'none'}")


def _pool_bound(mode: str, x_numel: int, y_numel: int, esize: int) -> dict:
    """dy and (max) the int64 argmax read once, dx written once."""
    return _bound(y_numel * esize + (8 * y_numel if mode == "max" else 0) + x_numel * esize, 0)


def phase_pool3d(card_line: str) -> dict:
    """Phase 31: the pools' backward kernel at every shape the probed train steps launched it at (MoSI's stem pool,
    S3D-G's stem, branch and stage pools, TAdaConv's pooled branches), in the path's own dtype and memory format, from
    the forward's own argmax on tied inputs (values from {0, 1, 2}), against its plain version; finite, the same bits on
    a second launch; each shape timed beside its plain version, torch's own CUDA backward of the same pool (atomics: no
    path of the port runs it) and the bound.  Returns the records of the max and the average backward, each at the
    first shape of the path that launches it in the CLI runs (MoSI, TAda2D), the other shapes under ``at_shapes``."""
    from clip_fsar_torch.ops import pool3d

    cases = []
    for case in POOL_CASES:
        if case[1:] not in [c[1:] for c in cases]:
            cases.append(case)
    want = {("mosi", "max"), ("s3dg", "max"), ("tada2d", "avg")}
    if not want <= {(c[0], c[1]) for c in cases}:
        raise AssertionError(f"the probed steps launched the pools' backward at {cases}, expected {sorted(want)} among them")
    g = torch.Generator().manual_seed(7)
    records = {}
    for path, mode, shape, kernel, stride, padding, dtype, channels_last in cases:
        x = torch.randint(0, 3, shape, generator=g).to("cuda", dtype)
        x = x.contiguous(memory_format=torch.channels_last_3d) if channels_last else x.contiguous()
        if mode == "max":
            y, argmax = F.max_pool3d(x, kernel, stride, padding, return_indices=True)
        else:
            y, argmax = F.avg_pool3d(x, kernel, stride, padding), None
        dy = torch.randn(y.shape, generator=g).to("cuda", dtype).contiguous(memory_format=torch.channels_last_3d)
        run = lambda: pool3d.pool3d_bwd_cuda(mode, dy, argmax, shape, kernel, stride, padding, channels_last)  # noqa: E731
        if mode == "max":
            plain = lambda: pool3d.max_pool3d_bwd_reference(dy, argmax, shape, kernel, stride, padding)  # noqa: E731
            library = lambda: torch.ops.aten.max_pool3d_with_indices_backward(dy, x, kernel, stride, padding, [1, 1, 1], False, argmax)  # noqa: E731
        else:
            plain = lambda: pool3d.avg_pool3d_bwd_reference(dy, shape, kernel, stride, padding)  # noqa: E731
            library = lambda: torch.ops.aten.avg_pool3d_backward(dy, x, kernel, stride, padding, False, True, None)  # noqa: E731
        dx = run()
        torch.cuda.synchronize()
        ref = plain()
        err = (dx.float() - ref.float()).abs().max().item()
        tol = POOL_TOLERANCE[dtype]
        what = f"pool3d_bwd {mode} ({path}) x {list(shape)} kernel {kernel} stride {stride} padding {padding} {str(dtype)[6:]}"
        print(f"{what}: max|dx-ref| {err:.3e} (tol {tol}, relative); dx in x's memory format: "
              f"{dx.is_contiguous(memory_format=torch.channels_last_3d if channels_last else torch.contiguous_format)}")
        if not torch.isfinite(dx.float()).all():
            raise AssertionError(f"{what}: dx is not finite")
        torch.testing.assert_close(dx.float(), ref.float(), rtol=tol, atol=tol)
        if not torch.equal(run(), dx):
            raise AssertionError(f"{what}: a second launch gave other bits")
        ms, plain_ms, all_ms = _alternate(run, plain, iters=10)
        library_ms = _time_ms(library, iters=10)
        bound = _pool_bound(mode, x.numel(), y.numel(), x.element_size())
        print(f"{what} on {card_line}: kernel {all_ms[0]:.4f} / {all_ms[1]:.4f} ms, plain {all_ms[2]:.4f} / {all_ms[3]:.4f} ms, torch's "
              f"atomic backward {library_ms:.4f} ms (kernel / library = {ms / library_ms:.2f}), bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}; {100 * bound['bound_ms'] / ms:.1f} % of it reached)")
        entry = {"path": path, "shape": list(shape), "kernel": list(kernel), "stride": list(stride), "padding": list(padding),
                 "dtype": str(dtype)[6:], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound}
        name = f"{mode}_pool3d_bwd"
        if name not in records:
            records[name] = {**{k: entry[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}, "at_shapes": []}
        records[name]["at_shapes"].append(entry)
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
        del x, y, argmax, dy, dx, ref
        torch.cuda.empty_cache()
    for name, path in (("max_pool3d_bwd", "mosi"), ("avg_pool3d_bwd", "tada2d")):  # the main record: the CLI path's first shape
        first = next(e for e in records[name]["at_shapes"] if e["path"] == path)
        records[name].update({k: first[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    return records


def phase_determinism_check(card_line: str) -> dict:
    """Phase 33: every train path was probed, and no probe named an operation without a deterministic CUDA
    implementation (DETERMINISM_ALLOWED lists the ones filed as open faults: none)."""
    missing = [path for path in PROBE_PATHS + NEW_PROBE_PATHS if path not in PROBED and path not in SKIPPED_PROBES]
    named = {path: [op for op in ops if op not in DETERMINISM_ALLOWED] for path, ops in PROBED.items()}
    named = {path: ops for path, ops in named.items() if ops}
    print(f"determinism check on {card_line}: {len(PROBED)} train paths probed; operations without a deterministic CUDA implementation: "
          f"{named or 'none'}; allowed exceptions {DETERMINISM_ALLOWED or 'none'}; not run {SKIPPED_PROBES or 'none'}")
    if missing or named:
        raise AssertionError(f"the determinism probe missed the train paths {missing} or named {named}")
    return dict(PROBED)


# --- the shipped variants, towers and heads that no earlier phase runs (phase 32) ----------------------------------------
# the four shipped signatures of configs/projects that no earlier phase runs, each standing for its family: (config,
# train steps through the CLI; 0 runs the test protocol alone).  HyRSM++ 2-shot stands for SHOT 2-4, which run the head
# code of SHOT 5 (phase 16)
SIGNATURE_CONFIGS = {
    "clipfsar_5shot": (os.path.join("configs", "projects", "CLIPFSAR", "hmdb51", "CLIPFSAR_HMDB51_5shot_v1.yaml"), 2),
    "molo_5shot": (os.path.join("configs", "projects", "MoLo", "hmdb51", "MoLo_HMDB51_5shot_v1.yaml"), 0),
    "hyrsm_pp_1shot": (os.path.join("configs", "projects", "hyrsmplusplus", "hmdb51", "HyRSMplusplus_HMDB51_1shot_v1.yaml"), 2),
    "hyrsm_pp_2shot": (os.path.join("configs", "projects", "hyrsmplusplus", "hmdb51", "HyRSMplusplus_HMDB51_2shot_v1.yaml"), 2),
}
SIGNATURE_EPISODES, SIGNATURE_TEST_EPISODES = 2, 8  # E a train step (in 2 chunks); the test protocol's episodes, 4 a step
SIGNATURE_OPTS = ["DATA.DECODER", "synthetic", "TPU.EPISODES_PER_STEP", str(SIGNATURE_EPISODES), "TPU.EPISODE_CHUNKS", "2",
                  "TRAIN.BATCH_SIZE_PER_TASK", "1", "TRAIN.NUM_VAL_TASKS", "4", "TPU.EVAL_EPISODES_PER_STEP", "4", "TRAIN.NUM_TEST_TASKS",
                  str(SIGNATURE_TEST_EPISODES), "TEST.BATCH_SIZE", "4", "LOG_PERIOD", "1"]
# the CLIP towers VIDEO.HEAD.BACKBONE_NAME selects that no earlier phase runs, under the CLIP-FSAR head of the flagship
# config at its 224 px crop (the RN towers' attention pooling resized to it, as the JAX builder does)
TOWERS = ["ViT-B/32", "ViT-L/14", "RN101", "RN50x4", "RN50x16", "RN50x64"]
# may stop at the card's memory at one episode: it is then reported with the peak it reached, not shrunk
TOWER_MAY_NOT_FIT = {"RN50x64"}
# the heads VIDEO.HEAD.NAME selects that no earlier phase runs, on the shipped HyRSM++ 5-shot config's ResNet-50 trunk;
# then the two other trunks under one of them
HEADS = ["CNN_HyRSM_1shot", "CNN_HyRSM_5shot", "CNN_HyRSM_plusplus_semi", "CNN_TRX", "CNN_OTAM", "CNN_TSN", "CNN_CrossTransformer"]
TRUNKS_HEAD, TRUNKS = "CNN_OTAM", ["resnet18", "resnet34"]
# heads that give no class logits: trained with TRAIN.USE_CLASSIFICATION False, the key their users set (the JAX train
# step, like the port's, reads the class logits whenever it is on)
NO_CLASS_LOGITS = {"CNN_TSN", "CNN_OTAM", "CNN_TRX", "CNN_CrossTransformer"}
# the gradients of a model behind a CLIP RN tower on per-episode batch statistics, at fresh weights, bf16 against fp32:
# reported, not held.  Rounding in bf16 flips ReLUs and moves the batch statistics, and the BatchNorm backward's mean
# subtractions cancel most of the gradient, so the stem's gradient differs by norm by about its own size and the error
# grows with the tower: this script read the stem's at 1.12 (RN50), 1.37 (RN101), 1.40 (RN50x4), 1.36 (RN50x16), the
# last convolution's at 0.17 to 0.75 and the head's at 0.05 to 0.24 (NVIDIA H100 80GB HBM3, 700.00 W).  The loss and
# the eval logits are held; the RN towers' fp32 gradients are held to JAX's on the CPU (tests/test_torch_rn.py).  The
# other trunks' gradients are held at CLASSIC_HEAD_GRAD_TOL, the tolerance of gradients that see the distances of nearly
# parallel fresh features (OTAM's and TSN's logits are nothing else)
LIVE_BN_GRADS = None
ONE_EPISODE_OPTS = ["DATA.DECODER", "synthetic", "TPU.EPISODES_PER_STEP", "1", "TPU.EPISODE_CHUNKS", "1", "TRAIN.BATCH_SIZE_PER_TASK", "1",
                    "TPU.EVAL_EPISODES_PER_STEP", "1"]
NEW_PROBE_PATHS = ([name for name in SIGNATURE_CONFIGS] + [f"{t}_{p}" for t in ("ViT-B/32", "ViT-L/14") for p in ("fused", "flash")]
                   + TOWERS[2:] + HEADS + TRUNKS)
SKIPPED_PROBES: dict = {}  # train path -> why its step could not run (a tower that does not fit the card at one episode)


def _picked_grads(head) -> dict:
    """The gradients held bf16 against fp32 with their tolerances: the trunk's first convolution, its last convolution
    (a ViT's last block's in-projection) and the head's own parameters together ("head"), each at
    CLASSIC_HEAD_GRAD_TOL.  Behind a CLIP RN tower on per-episode batch statistics (the CLIP-FSAR head's live
    BatchNorm) they are reported, not held (LIVE_BN_GRADS)."""
    named = [(n, p) for n, p in head.named_parameters() if p.requires_grad]
    convs = [n for n, p in named if n.startswith("backbone.") and p.dim() == 4]
    last = convs[-1] if len(convs) > 1 else [n for n, _ in named if n.startswith("backbone.") and n.endswith("attn.in_proj_weight")][-1]
    tol = LIVE_BN_GRADS if getattr(head, "train_backbone_bn", False) and not head.arch.is_vit else CLASSIC_HEAD_GRAD_TOL
    picked = {convs[0]: tol, last: tol}
    if any(not n.startswith("backbone.") for n, _ in named):  # OTAM and TSN have no parameters of their own
        picked["head"] = tol
    return picked


def _grads(head, picked) -> dict:
    named = dict(head.named_parameters())
    out = {n: named[n].grad.float().clone() for n in picked if n != "head"}
    if "head" in picked:
        out["head"] = torch.cat([p.grad.float().flatten() for n, p in named.items() if not n.startswith("backbone.") and p.grad is not None])
    return out


def _few_shot_run(what: str, cfg, dev, train_batch, test_batch, probe: str = None) -> dict:
    """A fresh model of ``cfg`` on the card: one eval step's logits on ``test_batch``, one ``make_grad_fn`` step's loss and
    picked gradients on ``train_batch`` with its peak, the launches of both counted from 0; then, under ``probe``'s name,
    one full train step (optimizer included) under the determinism probe."""
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.train.loop import step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState
    from clip_fsar_torch.train.step import make_eval_step, make_grad_fn, make_train_step

    model = build_few_shot_model(cfg, flow="train", device=dev)
    picked = _picked_grads(model.head)
    torch.cuda.synchronize()
    _reset_launches()
    logits = make_eval_step(model.head, cfg, model.text_train, model.text_test)(test_batch)["logits"].float()
    torch.cuda.reset_peak_memory_stats()
    metrics = make_grad_fn(model.head, cfg, model.text_train, model.text_test)(train_batch, step_generator(cfg, 0, dev))
    torch.cuda.synchronize()
    out = {"logits": logits, "loss": metrics["loss"].item(), "grads": _grads(model.head, picked), "picked": picked, "launches": _launches(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if probe:
        model.head.zero_grad(set_to_none=True)
        state = TrainState.create(cfg, model.head, Optimizer(cfg, model.head))
        step = make_train_step(model.head, cfg, model.text_train, model.text_test)
        with _probe(probe):
            step(state, train_batch, 1e-5, step_generator(cfg, 1, dev))
        del state, step
    del model
    torch.cuda.empty_cache()
    return out


def _compare_dtypes(what: str, got: dict, want: dict) -> dict:
    """bf16 (``got``) against fp32 (``want``): the eval logits to CLASSIC_LOGIT_SHARE of the largest fp32 logit, the loss at
    2e-2, the picked gradients norm-relative at their tolerances (PERF.md 2)."""
    diff, scale = (got["logits"] - want["logits"]).abs().max().item(), want["logits"].abs().max().item()
    rels = {n: ((got["grads"][n] - g).norm() / g.norm()).item() for n, g in want["grads"].items()}
    print(f"{what} bf16 vs fp32: eval logits max abs diff {diff:.4e}, {diff / scale:.3e} of the largest fp32 logit {scale:.4e} (tol "
          f"{CLASSIC_LOGIT_SHARE}); loss {got['loss']:.6f} vs {want['loss']:.6f} (tol 2e-2); gradients norm-relative "
          + ", ".join(f"{n} {r:.3e} (tol {want['picked'][n] or 'none: reported, LIVE_BN_GRADS'})" for n, r in rels.items()))
    bad = [n for n, r in rels.items() if not (r <= want["picked"][n] if want["picked"][n] else np.isfinite(r) and got["grads"][n].norm() > 0)]
    if not (torch.isfinite(got["logits"]).all() and diff <= CLASSIC_LOGIT_SHARE * scale) or bad:
        raise AssertionError(f"{what}: bf16 differs from fp32: logits {diff:.4e} of {scale:.4e}, gradients {bad}")
    torch.testing.assert_close(torch.tensor(got["loss"]), torch.tensor(want["loss"]), atol=2e-2, rtol=2e-2)
    return {"eval_share": diff / scale, "loss": (got["loss"], want["loss"]), "grad_rel": rels}


def _batches(cfg, dev) -> tuple:
    """One train batch and one test batch of the config's loaders (TPU.EPISODES_PER_STEP / TPU.EVAL_EPISODES_PER_STEP
    episodes), on the card."""
    from clip_fsar_torch.data.loader import build_few_shot_loader

    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=int(cfg.TPU.EPISODES_PER_STEP)) as loader:
        train = next(iter(loader)).to(dev)
    with build_few_shot_loader(cfg, "test", num_steps=1, episodes_per_step=int(cfg.TPU.EVAL_EPISODES_PER_STEP)) as loader:
        test = next(iter(loader)).to(dev)
    return train, test


def phase_signatures(out_dir: str, card_line: str) -> dict:
    """Phase 32a: the four shipped signatures that no earlier phase runs, as written (RN50 or ResNet-50 at 224 px, 8
    frames, 5-way; fresh weights, the synthetic decoder) through the CLI: 2 train steps of E = 2 in 2 chunks and the test
    protocol on 8 episodes of their checkpoint (MoLo 5-shot: the test protocol alone, on fresh weights), no kernel
    launched; then bf16 against fp32 on one train and one test batch of its loaders (eval logits, loss, picked
    gradients), the bf16 train step with its batch resident, and one train step under the determinism probe."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.runs.run import load_config, main
    from clip_fsar_torch.tools.profile_eval import config_opts
    from clip_fsar_torch.tools.profile_train import resident_step_ms

    dev = runtime.device("cuda")
    out = {}
    for name, (config, steps) in SIGNATURE_CONFIGS.items():
        path = os.path.join(REPO, config)
        opts = config_opts(path) + SIGNATURE_OPTS + (["TRAIN.NUM_TRAIN_TASKS", str(steps), "TRAIN.VAL_FRE_ITER", str(steps)] if steps
                                                     else ["TRAIN.ENABLE", "False"])
        cfg = load_config(path, opts)
        t = cfg.TRAIN
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        results = main(["--cfg", path, *opts, "OUTPUT_DIR", os.path.join(out_dir, name)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _expect_launches(f"the {name} CLI run")  # RN50 and the torchvision trunks reach no kernel, as in JAX
        peak = torch.cuda.max_memory_allocated()
        test = results["test_few_shot"]
        _check_test_stats(test, SIGNATURE_TEST_EPISODES)
        record = {"launches": launches, "test_episodes_per_s": SIGNATURE_TEST_EPISODES / test["seconds"], "peak_gib": peak / 2**30}
        line = (f"{name} ({cfg.VIDEO.HEAD.NAME} on {cfg.VIDEO.HEAD.BACKBONE_NAME}, train SHOT {t.SHOT} Q {t.QUERY_PER_CLASS}, test SHOT "
                f"{t.get('SHOT_TEST', t.SHOT)} Q {t.QUERY_PER_CLASS_TEST}, MERGE_BEFORE {bool(t.get('MERGE_BEFORE', False))}) through the CLI on "
                f"{card_line}: ")
        if steps:
            train = results["train_few_shot"]
            if len(train["losses"]) != steps or not np.isfinite(train["losses"]).all() or train["updates"] != steps:
                raise AssertionError(f"{name}: expected {steps} finite losses and updates, got {train['losses']}, {train['updates']}")
            if not test["weights"].endswith(os.path.join("checkpoints", f"{steps}.pt")):
                raise AssertionError(f"{name}: the test read {test['weights']}, not the step-{steps} checkpoint")
            record["episodes_per_s"] = steps * SIGNATURE_EPISODES / (train["seconds"] - train["val_seconds"])
            line += f"losses {[round(x, 5) for x in train['losses']]}, {record['episodes_per_s']:.4f} train episodes/s (loader included); "
        print(line + f"test protocol {record['test_episodes_per_s']:.3f} episodes/s ({SIGNATURE_TEST_EPISODES} episodes of "
              f"{test['weights'] or 'fresh weights'}), CLI wall {wall:.2f} s, peak {record['peak_gib']:.3f} GiB; launches {launches}")

        one = load_config(path, config_opts(path) + SIGNATURE_OPTS)
        train_batch, test_batch = _batches(one, dev)
        want = _few_shot_run(name, load_config(path, config_opts(path) + SIGNATURE_OPTS + ["TPU.COMPUTE_DTYPE", "float32"]), dev,
                             train_batch, test_batch)
        got = _few_shot_run(name, one, dev, train_batch, test_batch, probe=name)
        record.update(_compare_dtypes(f"{name} (one batch of E = {SIGNATURE_EPISODES})", got, want))
        _expect_launches(f"the {name} steps", got["launches"])
        model = build_few_shot_model(one, flow="train", device=dev)
        timed = resident_step_ms(model, one, train_batch, steps=3)
        del model
        torch.cuda.empty_cache()
        print(f"{name} train step on {card_line}, batch resident (E = {SIGNATURE_EPISODES} in 2 chunks, bf16): {timed['step_ms']:.1f} ms a "
              f"step (CUDA events, 3 steps); the host queued a step in {timed['host_ms']:.1f} ms; peak of one step {got['peak_gib']:.3f} GiB")
        out[name] = {**record, "resident_step_ms": timed["step_ms"], "host_ms": timed["host_ms"], "step_peak_gib": got["peak_gib"]}
        del train_batch, test_batch, want, got
        torch.cuda.empty_cache()
    return out


def phase_towers(card_line: str) -> dict:
    """Phase 32b: every CLIP tower VIDEO.HEAD.BACKBONE_NAME selects that no earlier phase runs (ViT-B/32 and ViT-L/14 at
    224 px: N = 50 and 257; RN101, RN50x4, RN50x16, RN50x64 at the config's 224 px crop) under the flagship's CLIP-FSAR head
    at full width, fresh weights from the seed: one eval step and one train step of one episode in fp32 and in bf16 (eval
    logits, loss, picked gradients), the bf16 train step's peak, its launches counted from 0 (the ViTs: K1 / K2 on the
    fused path, then K3-K5 on the flash path, against the blocks' forwards and backwards; the RN towers: none), and one
    train step under the determinism probe.  A tower in TOWER_MAY_NOT_FIT that runs out of the card's memory is
    reported with the peak it reached."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.models.builder import tower_execution
    from clip_fsar_torch.models.clip.arch import ARCHS
    from clip_fsar_torch.runs.run import load_config

    dev = runtime.device("cuda")
    out = {}
    for tower in TOWERS:
        opts = TRAIN_OPTS[2:] + ["VIDEO.HEAD.BACKBONE_NAME", tower] + ONE_EPISODE_OPTS
        cfg = load_config(CONFIG, opts)
        vit = isinstance(ARCHS[tower].vision_layers, int)
        train_batch, test_batch = _batches(cfg, dev)
        runs = {}
        for dtype, extra, probe in (("bfloat16", [], f"{tower}_fused" if vit else tower), ("float32", ["TPU.COMPUTE_DTYPE", "float32"], None)):
            try:
                runs[dtype] = _few_shot_run(tower, load_config(CONFIG, opts + extra), dev, train_batch, test_batch, probe=probe)
            except torch.cuda.OutOfMemoryError as e:
                if tower not in TOWER_MAY_NOT_FIT:
                    raise
                runs[dtype] = f"out of the card's memory at one episode in {dtype} ({str(e).splitlines()[0][:120]})"
                gc.collect()
                torch.cuda.empty_cache()
        if isinstance(runs["bfloat16"], str) or isinstance(runs["float32"], str):
            peak = torch.cuda.max_memory_allocated() / 2**30
            fit = {d: not isinstance(r, str) for d, r in runs.items()}
            if not fit["bfloat16"]:
                SKIPPED_PROBES[tower] = runs["bfloat16"]
            print(f"tower {tower} under the CLIP-FSAR head on {card_line}: one episode of {cfg.DATA.NUM_INPUT_FRAMES} frames at "
                  f"{cfg.DATA.TRAIN_CROP_SIZE} px fits in {[d for d, ok in fit.items() if ok] or 'neither dtype'}: "
                  f"{[r for r in runs.values() if isinstance(r, str)]}; peak reached {peak:.3f} GiB"
                  + ("" if isinstance(runs["bfloat16"], str) else f"; the bf16 train step's peak {runs['bfloat16']['peak_gib']:.3f} GiB"))
            out[tower] = {"fits": False, "peak_gib": peak if isinstance(runs["bfloat16"], str) else runs["bfloat16"]["peak_gib"], **fit}
            del runs, train_batch, test_batch
            torch.cuda.empty_cache()
            continue
        got, want = runs["bfloat16"], runs["float32"]
        record = {}
        record.update(_compare_dtypes(f"tower {tower} (one episode)", got, want), fits=True, peak_gib=got["peak_gib"])
        launches = {"fused": got["launches"]}
        if vit:
            layers = ARCHS[tower].vision_layers
            remat = tower_execution(cfg)[0]
            fwd, bwd = layers + layers * (1 + remat), layers  # one eval step, one train step (twice a block under remat)
            _expect_launches(f"tower {tower}, fused path", got["launches"], clip_mha_fwd=fwd, clip_mha_bwd=bwd)
            flash = _few_shot_run(tower, load_config(CONFIG, opts + FLASH_OPTS), dev, train_batch, test_batch, probe=f"{tower}_flash")
            launches["flash"] = _expect_launches(f"tower {tower}, flash path", flash["launches"], flash_mha_fwd=fwd, flash_mha_bwd_dq=bwd,
                                                 flash_mha_bwd_dkv=bwd)
            diff = (flash["logits"] - got["logits"]).abs().max().item()
            print(f"tower {tower}: flash path against the fused path (bf16): eval logits max abs diff {diff:.4e}, loss {flash['loss']:.6f} "
                  f"vs {got['loss']:.6f} (tol 2e-2 each)")
            torch.testing.assert_close(flash["logits"], got["logits"], atol=2e-2, rtol=2e-2)
            torch.testing.assert_close(torch.tensor(flash["loss"]), torch.tensor(got["loss"]), atol=2e-2, rtol=2e-2)
        else:
            _expect_launches(f"tower {tower}", got["launches"])
        print(f"tower {tower} under the CLIP-FSAR head on {card_line} ({ARCHS[tower].vision_width} wide, one episode of "
              f"{cfg.DATA.NUM_INPUT_FRAMES} frames at {cfg.DATA.TRAIN_CROP_SIZE} px): the bf16 train step's peak {got['peak_gib']:.3f} GiB; "
              f"launches {launches}")
        out[tower] = {**record, "launches": launches}
        del train_batch, test_batch, want, got
        torch.cuda.empty_cache()
    return out


def phase_heads(card_line: str) -> dict:
    """Phase 32c: every few-shot head VIDEO.HEAD.NAME selects that no earlier phase runs, on the shipped HyRSM++ 5-shot
    config's ResNet-50 trunk as written (224 px, 8 frames, 5-way 5-shot; the loader gives the semi head no unlabeled
    clips, as it gives none to a user's run), and the resnet18 and resnet34 trunks under CNN_OTAM: one eval step and
    one train step of one episode in fp32 and bf16 (eval logits, loss, picked gradients), no kernel launched, the bf16
    step's peak, and one train step under the determinism probe."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.runs.run import load_config
    from clip_fsar_torch.tools.profile_eval import config_opts

    dev = runtime.device("cuda")
    path = os.path.join(REPO, CLASSIC_CONFIGS["hyrsm_pp_5shot"])
    cases = {head: ["VIDEO.HEAD.NAME", head] for head in HEADS}
    cases.update({trunk: ["VIDEO.HEAD.NAME", TRUNKS_HEAD, "VIDEO.HEAD.BACKBONE_NAME", trunk] for trunk in TRUNKS})
    cases = {case: extra + (["TRAIN.USE_CLASSIFICATION", "False"] if extra[1] in NO_CLASS_LOGITS else []) for case, extra in cases.items()}
    out = {}
    batches = None
    for case, extra in cases.items():
        opts = config_opts(path) + ONE_EPISODE_OPTS + extra
        cfg = load_config(path, opts)
        if batches is None:  # the heads share the config's loaders
            batches = _batches(cfg, dev)
        want = _few_shot_run(case, load_config(path, opts + ["TPU.COMPUTE_DTYPE", "float32"]), dev, *batches)
        got = _few_shot_run(case, cfg, dev, *batches, probe=case)
        record = _compare_dtypes(f"{cfg.VIDEO.HEAD.NAME} on {cfg.VIDEO.HEAD.BACKBONE_NAME} (one episode)", got, want)
        _expect_launches(f"{case}", got["launches"])
        print(f"{cfg.VIDEO.HEAD.NAME} on {cfg.VIDEO.HEAD.BACKBONE_NAME} on {card_line}: the bf16 train step's peak {got['peak_gib']:.3f} GiB; "
              "no kernel launched")
        out[case] = {**record, "peak_gib": got["peak_gib"], "launches": got["launches"]}
    return out


# --- what cuDNN's deterministic convolution algorithms cost (not run by default: python3 chip_smoke.py --cudnn-determinism)
def _step_ms(run, steps: int = 3) -> float:
    """CUDA-event ms a step of ``run(i)`` over ``steps`` steps after a warm-up step."""
    run(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(1, steps + 1):
        run(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def phase_cudnn_determinism(card_line: str) -> None:
    """The train steps with and without ``runtime.deterministic_convolutions`` (cuDNN's deterministic algorithms; the
    few-shot and classification steps run under it): three fp32 MoSI runs of 3 steps at 4 frames under each, whether
    their losses are the same bits; then the resident step of each conv-heavy path built each way, timed in turn
    (without, with, with, without).  BMN's step, which runs without it (ROADMAP F9), with the flag set around it."""
    from unittest import mock

    from clip_fsar_torch import runtime
    from clip_fsar_torch.data.classification import build_classification_loader
    from clip_fsar_torch.data.tal_features import TalFeatureDataset
    from clip_fsar_torch.models.video.model import build_video_model
    from clip_fsar_torch.runs.run import load_config
    from clip_fsar_torch.train import localization as loc
    from clip_fsar_torch.train.classification import _to_device
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    dev = runtime.device("cuda")

    @contextlib.contextmanager
    def default_pick():
        yield

    def plain_cudnn(on: bool):
        """The steps built under this context run with cuDNN's deterministic algorithms (on) or its default pick."""
        return contextlib.nullcontext() if on else mock.patch.object(runtime, "deterministic_convolutions", default_pick)

    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as d:
        lists = _mosi_lists(os.path.join(d, "mosi"))
        small = load_config(os.path.join(REPO, MOSI_CONFIG), ["DATA.DECODER", "synthetic", "DATA.ANNO_DIR", lists, "PRETRAIN.NUM_FRAMES", "4",
                                                              "TRAIN.BATCH_SIZE", "4"])
        videos, labels, _ = next(iter(build_classification_loader(small, "train")))
        x, y = _to_device(videos, dev), _to_device(labels, dev)
        for on in (False, True):
            runs = []
            for _ in range(3):
                with plain_cudnn(on):
                    run = _cls_train_step(small, build_video_model(small, device=dev), x, y)
                runs.append(torch.stack([run(i)["loss"] for i in range(3)]).cpu())
            print(f"MoSI fp32 at 4 frames, 3 runs of 3 steps, deterministic convolutions {on}: losses {[r.tolist() for r in runs]}; "
                  f"the same bits: {all(torch.equal(r, runs[0]) for r in runs)}")
        del x, y
        torch.cuda.empty_cache()

        def video(cfg, batch=None):
            def make():
                model = build_video_model(cfg, dtype=torch.bfloat16, device=dev)
                run = _cls_train_step(cfg, model, *(batch or _cls_batch(cfg, dev, seed=3)))
                return lambda i: run(i)["loss"]
            return make

        def few_shot(cfg):
            return lambda: (lambda run: lambda i: run(i)["loss"])(_few_shot_train_step(cfg, dev))

        mosi = load_config(os.path.join(REPO, MOSI_CONFIG), ["DATA.DECODER", "synthetic", "DATA.ANNO_DIR", lists])
        mosi_batch = tuple(_to_device(t, dev) for t in next(iter(build_classification_loader(mosi, "train")))[:2])
        paths = {"TAda2D-R50, batch 8": video(load_config(os.path.join(REPO, CLS_CONFIG), _cls_opts(d, _cls_lists(os.path.join(d, "cls"))))),
                 "MoSI R-2D3D-18, 10 videos": video(mosi, mosi_batch),
                 **{f"preset {p}, batch 2": video(_preset_cfg(p, d)) for p in ("r2d3ds", "csn", "s3dg", "slowfast_8x8")},
                 "RN50 CLIP-FSAR, E = 4 in 2 chunks": few_shot(load_config(CONFIG, RN_TRAIN_OPTS)),
                 **{f"{name}, E = 4 in 2 chunks": few_shot(load_config(os.path.join(REPO, CLASSIC_CONFIGS[name]), _classic_opts(name)))
                    for name in CLASSIC_CONFIGS}}
        for name, make in paths.items():
            ms = {False: [], True: []}
            for on in (False, True, True, False):
                with plain_cudnn(on):
                    run = make()
                ms[on].append(_step_ms(run))
                del run
                torch.cuda.empty_cache()
            print(f"{name} on {card_line}: the bf16 train step {ms[False]} ms with cuDNN's default pick, {ms[True]} ms with its "
                  "deterministic algorithms (CUDA events, 3 steps)")
        cfg = load_config(os.path.join(REPO, BMN_CONFIG), BMN_OPTS)
        feats, maps, _ = next(loc._batches(TalFeatureDataset(cfg, "train"), BMN_BATCH, False, 0))
        x, y = torch.from_numpy(feats).to(dev), {k: torch.from_numpy(v).to(dev) for k, v in maps.items()}
        model = loc.build_bmn_model(cfg, dev)
        state = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
        step = loc.make_localization_train_step(model, cfg)
        ms = {False: [], True: []}
        for on in (False, True, True, False):
            torch.backends.cudnn.deterministic = on
            ms[on].append(_step_ms(lambda i: step(state, x, y, 1e-4, loc.step_generator(cfg, 0, i, dev))[0]))
        torch.backends.cudnn.deterministic = False
        print(f"BMN, {BMN_BATCH} windows, fp32, on {card_line}: the train step {ms[False]} ms with cuDNN's default pick, {ms[True]} ms with "
              "its deterministic algorithms (CUDA events, 3 steps)")


START = time.perf_counter()


def _elapsed(after: str) -> float:
    """Print and return the seconds since the script started, labelled with the phases just done."""
    seconds = time.perf_counter() - START
    print(f"chip_smoke elapsed after {after}: {seconds:.1f} s")
    return seconds


def main() -> None:
    import sys

    if sys.argv[1:2] == ["--dp-worker"]:  # one rank of the world-2 phase, started by phase_dp_world2
        dp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return
    if sys.argv[1:2] == ["--tp-worker"]:  # one model rank of the tensor-parallel phase, started by phase_tensor_parallel
        tp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return
    if sys.argv[1:2] == ["--cudnn-determinism"]:  # what cuDNN's deterministic algorithms cost the train steps (ROADMAP F9)
        smi = phase_device()
        phase_build()
        phase_cudnn_determinism(smi)
        return
    smi = phase_device()
    build_seconds = phase_build()
    timings = {"clip_mha_fwd": phase_fwd_vs_plain(), "clip_mha_bwd": phase_bwd_vs_plain(), "flash_mha_fwd": phase_flash_fwd_vs_plain()}
    phase_tiled_branch_times()
    timings["flash_mha_bwd_dq"], timings["flash_mha_bwd_dkv"] = phase_flash_bwd_vs_plain()
    timings["layer_norm_fwd"], timings["layer_norm_bwd"] = phase_layer_norm_vs_plain()
    replay = phase_layer_norm_replay()
    decomp = phase_fa_decomp(smi)
    timings.update({f"clip_mha_decomp_{mode}": record for mode, record in decomp.items()})
    phase_loader_resize()
    _elapsed("phases 1-6d (build, kernels, replay, resize)")
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out_dir:
        phase_test_slice(out_dir)
        train = {path: phase_train_slice(os.path.join(out_dir, f"train_{path}"), path) for path in TRAIN_PATHS}
        rn_test = phase_rn_test_slice(out_dir, smi)
    phase_train_step_paths()
    phase_remat_vs_none()
    l336_kernels = phase_vit_l336_kernels()
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out_dir:
        train["vit_l336"] = phase_vit_l336_train_slice(os.path.join(out_dir, "train_vit_l336"))
    phase_frame_chunks_vs_none()
    _elapsed("phases 7-15 (ViT-B/16, RN50 and ViT-L/14@336px slices)")
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out_dir:
        classic = {name: phase_classic_slice(os.path.join(out_dir, name), name, smi) for name in CLASSIC_CONFIGS}
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out_dir:
        bank_bits = phase_bank_bits(out_dir, smi)
        eval_bank = phase_eval_bank_full(smi)
        train_bank = phase_train_bank_full(os.path.join(out_dir, "train_bank"), smi, train["fused"])
        reference = phase_reference_checkpoint(out_dir)
    _elapsed("phases 16-21 (classic slices, frame banks, .pyth)")
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out_dir:
        torch.cuda.empty_cache()
        dp1 = phase_dp_world1(out_dir, smi)
        torch.cuda.empty_cache()
        dp2 = phase_dp_world2(out_dir, smi, dp1)
    dp_launches = {name: {"nccl_world1": dp1["launches"].get(name, 0), "gloo_world2": dp2["launches"].get(name, 0)} for name in _launches()}
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out_dir:
        torch.cuda.empty_cache()
        tp = phase_tensor_parallel(out_dir, smi)
    _elapsed("phases 22-23 and 29 (data and tensor parallel)")
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out_dir:
        torch.cuda.empty_cache()
        cls = phase_classification(out_dir, smi)
        presets = phase_presets(out_dir, smi)
        cls_dp = phase_classification_dp(out_dir, smi)
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out_dir:
        torch.cuda.empty_cache()
        bmn = phase_localization(out_dir, smi)
        mosi = phase_pretrain(out_dir, smi)
    _elapsed("phases 24-28 (classification, localization, pretraining)")
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out_dir:
        torch.cuda.empty_cache()
        phase_determinism_probe(out_dir, smi)
    timings.update(phase_pool3d(smi))
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out_dir:
        torch.cuda.empty_cache()
        signatures = phase_signatures(out_dir, smi)
    tower_kernels = phase_tower_kernels()
    towers = phase_towers(smi)
    heads = phase_heads(smi)
    phase_determinism_check(smi)
    _elapsed("phases 30-33 (determinism, pools, signatures, towers, heads)")
    classification_launches = {name: {"tada2d_k400_cli": cls["launches"][name], "presets": presets["launches"][name],
                                      "nccl_world1": cls_dp["launches"][name]} for name in _launches()}
    # each kernel's launches in the bank phases' bank runs, counted from 0 in each
    bank_runs = [bank_bits["launches"]["eval_bank"], bank_bits["launches"]["train_bank"], train_bank["launches"],
                 {"clip_mha_fwd": eval_bank["vit"]["k1_launches"]}]
    bank_launches = {name: sum(run.get(name, 0) for run in bank_runs) for name in _launches()}
    from clip_fsar_torch.data.transforms import RESIZE_CALLS

    print(f"loader resize: clips resized in this run by each implementation: {RESIZE_CALLS}")
    print(f"summary on {smi}: build {build_seconds:.2f} s; "
          + "; ".join(f"{path} train slice {t['episodes_per_s']:.4f} episodes/s, {t['step_ms']:.1f} ms per step, peak {t['peak_gib']:.3f} GiB"
                      for path, t in train.items())
          + f"; rn50 test slice {rn_test['episodes_per_s']:.3f} episodes/s, peak {rn_test['peak_gib']:.3f} GiB; "
          + "; ".join(f"{name} slice {t['episodes_per_s']:.4f} train episodes/s, {t['resident_step_ms']:.1f} ms a resident step "
                      f"(host {t['host_ms']:.1f} ms), test {t['test_episodes_per_s']:.3f} episodes/s, peak {t['peak_gib']:.3f} GiB"
                      for name, t in classic.items())
          + f"; eval bank {eval_bank['gb']:.2f} GB built in {eval_bank['build_seconds']:.2f} s, uploaded in {eval_bank['upload_seconds']:.2f} s: "
          + "; ".join(f"{what} test episodes/s {min(r['episodes_per_s']['pixel']):.3f}-{max(r['episodes_per_s']['pixel']):.3f} pixel, "
                      f"{min(r['episodes_per_s']['bank']):.3f}-{max(r['episodes_per_s']['bank']):.3f} bank, idle {100 * r['idle']['pixel']:.1f} / "
                      f"{100 * r['idle']['bank']:.1f} %, peak {r['peak_gib']['bank']:.3f} GiB" for what, r in (("ViT-B/16", eval_bank["vit"]), ("HyRSM++", eval_bank["hyrsm"])))
          + f"; train bank slice {train_bank['episodes_per_s']:.4f} train episodes/s (pixel {train['fused']['episodes_per_s']:.4f}), "
          f"peak {train_bank['peak_gib']:.3f} GiB"
          + f"; data parallel: the resident train step {dp1['step_ms']:.1f} ms as one NCCL rank against {dp1['alone_step_ms']:.1f} ms "
          f"without a group, its gradient all-reduce {dp1['all_reduce_ms']:.3f} ms; two gloo ranks on the card {dp2['seconds']:.1f} s"
          f"; tensor parallel (MODEL 2, gloo through the host on one card): the CLI's train step {', '.join(f'{t:.2f}' for t in tp['step_s'])} s "
          f"on the two ranks against {tp['alone_step_s']:.2f} s without a group, peak {', '.join(f'{g:.2f}' for g in tp['peak_gib'])} GiB, "
          f"{tp['seconds']:.1f} s"
          f"; classification TAda2D-R50: train {cls['train_clips_per_s']:.3f} clips/s, test {cls['test_clips_per_s']:.3f} and re-test "
          f"{cls['retest_clips_per_s']:.3f} clips/s, resident step {cls['step_ms']:.1f} ms (host {cls['host_ms']:.1f} ms, card busy "
          f"{cls['busy_ms']:.1f} ms), peak {cls['peak_gib']:.3f} GiB; presets: "
          + ", ".join(f"{p} {r['step_ms']:.1f} ms / {r['peak_gib']:.2f} GiB" for p, r in presets["presets"].items())
          + f"; BMN EPIC-100: mask {bmn['mask_s']:.2f} s, train {bmn['train_windows_per_s']:.3f} and test {bmn['test_windows_per_s']:.3f} "
          f"windows/s, resident step {bmn['step_ms']:.1f} ms (host {bmn['host_ms']:.1f} ms, card busy {bmn['busy_ms']:.1f} ms), peak "
          f"{bmn['step_peak_gib']:.3f} GiB; MoSI R-2D3D-18: train {mosi['train_clips_per_s']:.3f} clips/s, resident step {mosi['step_ms']:.1f} ms "
          f"(host {mosi['host_ms']:.1f} ms, card busy {mosi['busy_ms']:.1f} ms), peak {mosi['step_peak_gib']:.3f} GiB; "
          + "; ".join(f"{name}: {r['test_episodes_per_s']:.3f} test episodes/s"
                      + (f", {r['episodes_per_s']:.4f} train episodes/s" if "episodes_per_s" in r else "")
                      + f", resident step {r['resident_step_ms']:.1f} ms (host {r['host_ms']:.1f} ms), peak {r['peak_gib']:.3f} GiB"
                      for name, r in signatures.items())
          + "; towers (one-episode bf16 train step's peak): " + ", ".join(
              f"{t} {r['peak_gib']:.2f} GiB" + ("" if r["fits"] else " (did not fit)") for t, r in towers.items())
          + "; heads and trunks (the same): " + ", ".join(f"{h} {r['peak_gib']:.2f} GiB" for h, r in heads.items()))
    kernels = [
        ("clip_mha_fwd", "fused", "clip_fsar_torch/csrc/clip_mha_fwd.cu", "clip_fsar_tpu/ops/fused_attention.py:71"),
        ("clip_mha_bwd", "fused", "clip_fsar_torch/csrc/clip_mha_bwd.cu", "clip_fsar_tpu/ops/fused_attention.py:97"),
        ("flash_mha_fwd", "flash", "clip_fsar_torch/csrc/flash_mha_fwd.cu", "clip_fsar_tpu/ops/flash_attention.py:47"),
        ("flash_mha_bwd_dq", "flash", "clip_fsar_torch/csrc/flash_mha_bwd.cu", "clip_fsar_tpu/ops/flash_attention.py:98"),
        ("flash_mha_bwd_dkv", "flash", "clip_fsar_torch/csrc/flash_mha_bwd.cu", "clip_fsar_tpu/ops/flash_attention.py:123"),
        ("layer_norm_fwd", "replay", "clip_fsar_torch/csrc/layer_norm.cu", "clip_fsar_tpu/ops/fused_layernorm.py:77"),
        ("layer_norm_bwd", "replay", "clip_fsar_torch/csrc/layer_norm.cu", "clip_fsar_tpu/ops/fused_layernorm.py:96"),
    ] + [(f"clip_mha_decomp_{mode}", "tool", "clip_fsar_torch/csrc/clip_mha_decomp.cu", "tools/_fa_decomp.py:64") for mode in decomp] + [
        # no TPU kernel: the JAX package's flax pools, whose gradient XLA computes (the port's replaces torch's atomic backward)
        ("max_pool3d_bwd", "pool", "clip_fsar_torch/csrc/pool3d.cu", "clip_fsar_tpu/models/video/blocks.py:225"),
        ("avg_pool3d_bwd", "pool", "clip_fsar_torch/csrc/pool3d.cu", "clip_fsar_tpu/models/video/branches.py:163"),
    ]
    # launches: each kernel's count from the path that runs it, counted from 0: the train slice (train,
    # validation, test) of its own attention path, the LayerNorm replay, the stage-ablation tool's table
    launches = {"fused": train["fused"]["launches"], "flash": train["flash"]["launches"], "replay": replay["launches"],
                "tool": {name: record["launches"] for name, record in timings.items() if "launches" in record},
                "pool": {"max_pool3d_bwd": mosi["launches"]["max_pool3d_bwd"], "avg_pool3d_bwd": cls["launches"]["avg_pool3d_bwd"]}}
    # K1-K5 at the new towers' shapes, with the launches of the tower phase's bf16 steps (K1 / K2 fused, K3-K5 flash)
    tower_launches = {key: {name: n for path in towers[tower]["launches"].values() for name, n in path.items() if n}
                      for key, tower in (("at_vit_b32", "ViT-B/32"), ("at_vit_l14_224", "ViT-L/14"))}
    records = []
    for name, path, source, replaces in kernels:
        t = timings[name]
        records.append({"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches[path][name],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"], "rn50_launches": train["rn50"]["launches"][name] + rn_test["launches"][name],
                        "vit_l336_launches": train["vit_l336"]["launches"][name],
                        "classic_launches": {slice_name: t["launches"][name] for slice_name, t in classic.items()},
                        "bank_launches": bank_launches[name], "pyth_launches": reference["launches"][name], "dp_launches": dp_launches[name],
                        "classification_launches": classification_launches[name], "localization_launches": bmn["launches"][name],
                        "pretrain_launches": mosi["launches"][name], "tp_launches": tp["launches"][name],
                        **({"at_tp_rank_heads": tp["kernels"][name]} if name in tp["kernels"] else {}),
                        **{key: t[key] for key in ("library_covers", "at_480_frames", "at_shapes") if key in t},
                        **{key: {**tower_kernels[key][name], "launches": tower_launches[key].get(name, 0)} for key in tower_kernels
                           if name in tower_kernels[key]},
                        "new_paths_launches": {"signatures": sum(r["launches"][name] for r in signatures.values()),
                                               "towers": sum(p.get(name, 0) for r in towers.values() for p in r.get("launches", {}).values()),
                                               "heads": sum(r["launches"][name] for r in heads.values())},
                        **({"at_vit_l336_chunk": l336_kernels[name]} if name in l336_kernels else {})})
        if not records[-1]["launches"] > 0:
            raise AssertionError(f"{name} was launched no time on the path that runs it")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
