"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one line of output each (failures raise and exit non-zero):

1. device: requires CUDA (there is no CPU path) and prints the card's name
   and power limit as ``nvidia-smi --query-gpu=name,power.limit
   --format=csv,noheader`` gives them;
2. build: compiles the hand-written kernels (ops/csrc/*.cu) from the
   checkout into build/kernels/ and prints the build seconds, each
   kernel's registers, spills and shared memory (``-Xptxas -v``; every
   build of the sampler (K1, K5, K8), of K7, K10s and K10u, and of K2's
   and K3's fp32 bodies must be free of spills), and, by ``cuobjdump
   -sass``, the tensor-core, fp32 FMA and asynchronous-copy instructions
   of K1's, K2's, K3's, K7's, K9's and K10's kernels: K2's and K3's bf16
   kernels must hold HGMMA (``wgmma``), K1's bf16/int8 sampler and K7's
   bf16 body HMMA, K9's builds IGMMA (int8 ``wgmma``) and IMMA
   (``mma.sync``), K2's fp32 kernels, K3's CUDA-core body and K1's fp32
   projected build FFMA, each with LDGSTS (``cp.async``) or UTMALDG
   (TMA); K10's product builds (bf16 and fp32 epilogues) IGMMA and
   UTMALDG;
3. kernels: each of K1-K4 against its plain PyTorch version on the card, at
   the H36M serving path's shapes with batch 64 (K2-K4 also at the 3DHP
   lifters' widths: K2 at D=64/96/320/480, each with the route
   ``fused_mlp.plan`` picks, K3 at 64/96, K4 at head dims 40/60), and K5
   (the sampler at the HRNet-W32 and W48 pyramids: the zeros 17-point call
   and the border 272-point call with the lifter's mixed in-kernel
   projection, W made as the lifter's parameters are; K1 and K5 also that
   border call without the projection, the gather alone; K5 each level of
   the border call alone), in bf16 and fp32 (TF32 off), each sampler
   call with its plan (``deformable.sampler_plan``: per level the body,
   points a unit and units, the order, the shared memory): max abs
   error, error relative to max|plain|, median kernel and plain device
   times over 20 CUDA-event-timed runs, the bound and the kernel's share
   of it, and the time of the PyTorch call that computes the same function
   where there is one (information only; the port never calls it); then
   the float convs' epilogue (``ops/conv_epilogue.py``: BN affine, residual
   and ReLU in one pass) against its plain chain bit for bit at HRNet-W32's
   branch 0 and the CPN stem (batch 512, bf16) and the fp32 CPN's layer1
   tail (batch 256), with its time, the chain's and its byte bound;
4. slice: the full-width h36m_cpn serving slice (bf16 CPN ResNet-50 with the
   native pyramid, lifter embed 128 depth 4, random weights from seed 0)
   serves 3 requests of 64 uint8 frames through ``serve.lift``; the output
   must be finite (64, 17, 3), every kernel's launch count must grow by its
   per-request count (the float convs' epilogue: one launch a float conv,
   84 in the CPN), and the same request through the plain versions
   (``int8_impl="plain"`` for the backbone's) must launch nothing and
   agree to a relative RMS of 2e-2. Information only: host ms a request and
   frames/s over 10 requests, stage times by CUDA events, and under
   torch.profiler the device busy ms a request, its idle share of the
   unprofiled host time, K1's, K2's, K3's and K9's device ms and share of
   it, and the top kernels;
4b. fp32_lifter: the same slice with ``lifter.compute_dtype="float32"``
   (the serving knobs in fp32: K1 with the in-sampler projection, K3's
   CUDA-core body, K4, K2's fp32 routes; the backbone bf16), 3 requests
   with K1 5, K2 12, K3 4 and K4 4 launches each, the output against the
   plain routes (``sampler="gather"``, einsum) within a relative RMS of
   1e-4, and, as in the slice phase, host ms over 5 requests and, under
   torch.profiler, the device busy ms and K1's (its fp32 projected build),
   K2's and K3's ms and share;
5. hrnet: the same for the full-width h36m_hrnet_32 slice (bf16 HRNet-W32,
   3 requests), then one request each of h36m_hrnet_48, mpi_3dhp_hrnet_32
   and mpi_3dhp_hrnet_48;
6. int8: K10 (the int8 convolution) at every shape of the HRNet deploy
   graph and K9 (the fused int8 layer1) on the 64x48 stem output, batch 64,
   W32 and W48, against their plain versions (bit for bit; K9 also against
   K10's per-conv chain on the card), with median kernel and plain device
   times, the bound and, for K10's 1x1 shape, ``torch._int_mm`` (information
   only); then the full-width ``serve.deploy_config("h36m_hrnet_32")`` (the
   bf16 HRNet with the int8 layer1 and int8 wide convs) calibrated by
   ``serve.prepare`` on one seeded batch of 64 frames serves 3 requests with
   K1-K5, K9 and K10 at their per-request counts, agrees with the plain
   versions of every kernel to a relative RMS of 2e-2 and prints its
   relative RMS against the float slice of the same weights (information),
   then where its time goes as in the slice phase; then one request each of
   the other three HRNet deploy configurations;
7. cpn_int8: ``serve.deploy_config("h36m_cpn")`` (bf16 CPN with the
   calibrated int8 wide convs, the int8 residual stream and int8 pyramid
   maps, random weights from seed 0) calibrated by ``serve.prepare`` on one
   seeded batch of 64 frames; one request records every distinct shape and
   variant K10 takes in the stream (1x1/3x3, stride 1/2, 8x6 to 64x48,
   64-2048 channels; int8 or calibrated bf16 input, bf16 or int8 residual,
   bf16 or int8 output) with its calls a request, and K10 on that
   request's own tensors must equal its plain version bit for bit
   (median kernel and plain ms, the bound; a bf16 input's quantize pass,
   K10q's step form, timed apart and K10 on its output); K10q in its step
   form (dynamic and calibrated) and its scale form on all 65,536 bf16
   patterns at 16 amax values each, bit for bit; the stream's own
   quantizes recorded from the same request (K10q's scale form on the
   three refineNet cascades' inputs and the int8 /4 map, K10p, the stem's
   quantize and 3x3/s2 max-pool, on the (64, 128, 96, 64) stem output,
   also against the two-pass route, quantize then pool in bf16) bit for
   bit, with median kernel and plain ms and the bound; then 3 requests as
   the int8 phase serves them, with K1 5, K2 12, K3 4, K4 4, K10 83, K10q
   7 and K10p 1 launches a request (every conv but the float stem: the JAX
   graph's 83 int8 convolutions, tests/test_torch_cpn_int8.py; the 3
   up-convs read bf16, the stream quantizes 4 more tensors; HRNet: K10 87
   and K10q 85), agreement with the plain versions of every kernel to 2e-2
   relative RMS and, for information, the float slice's output, host ms,
   device busy and idle and the top kernels; then K1 projecting the int8
   pyramid (the lifter's border
   call, W a parameter and each level's dequant scale apart, as the
   lifter serves it) against its plain version,
   its bound with the blend at the fp32 rate and the projection at the
   bf16 rate beside the count of both at the fp32 rate (the yardstick of
   a projection on CUDA cores), and the same call's gather alone;
8. quantize: the backbone's other int8 modes (``serve.quantize_config``:
   the float slice with ``quantize`` "static" or "c128" and the 0.999
   calibration quantile, random weights from seed 0), each prepared by
   ``serve.prepare`` on one seeded batch of 64 frames and served as the
   int8 phase serves the deploy graphs: h36m_hrnet_32 "static" 3 requests,
   h36m_hrnet_48 and h36m_cpn "static" and h36m_hrnet_32 and h36m_cpn
   "c128" one each, with K10 and K10q once a static or wide conv ("static"
   HRNet 256, CPN 76; "c128" HRNet 85, CPN 73; no K9) beside the lifter's
   kernels, agreement with the plain versions of every kernel to 2e-2
   relative RMS; each "c128" graph's first request, served before
   ``prepare`` (its weights quantized each call), must equal the prepared
   model's bit for bit; for information the float slice's distance, host
   ms, device busy and idle, K10's and K10q's share and the top kernels.
   One request of each graph (and of h36m_hrnet_48 "c128") records every
   distinct K10 shape and variant (among them W48's Cin 48 at stride 1
   and 2, whose K of 432 bytes ends in a zero-filled stage, and the 3x3
   64->64 stem and layer1 convs), and K10 on that request's own tensors
   must equal its plain version bit for bit, with median kernel and plain
   ms and the bound (a bf16 input's quantize pass, K10q, timed apart with
   its plain ms and bound), summed into each graph's K10 and K10q ms a
   request;
8b. fp32_int8: the int8 graphs with an fp32 backbone (``config.deploy``
   built in fp32, as the JAX package serves them at ``use_bf16=False``;
   the lifter stays bf16). K10q's fp32 form on all 2^32 fp32 bit
   patterns (in chunks of 2^28) at two amax values a step form (one whose
   step lies in [2^-64, 2^64], one outside it) and two in the scale form,
   and in the dynamic route on max|x| of the finite patterns; the rest of
   K10Q_AMAXES on 2^26 random patterns; each bit for bit, its seconds
   printed. K10p at the stem shape, bf16 and fp32, seeded with NaN, +-inf
   and +-0, bit for bit. Then ``StreamingLifter(deploy(preset(
   "h36m_cpn")), StreamingConfig(use_bf16=False))`` (its weights the
   JAX-format variables of the fp32 model drawn from seed 0), prepared on
   one seeded batch: 3 ``lift_batch`` requests of 64 frames and one pass of
   4 cameras x 38 frames, each with K1 5, K2 12, K3 4, K4 4, K10 83, K10q 7
   and K10p 1 launches a request and no int8 plain version called; its
   backbone maps and scales bit for bit equal to the same model's with
   ``int8_impl="plain"``, its poses within 2e-2 relative RMS of that plain
   graph's; every K10 shape and variant and every stream quantize of that
   request against its plain version as in the cpn_int8 phase, summed
   into the fp32 forms' kernel, plain and bound ms a request; host ms,
   frames/s and where the time goes beside ``StreamingLifter(
   use_bf16=True)`` on the same weights, and the two graphs' relative
   RMS. Then one request of ``serve.build_model(deploy(preset(
   "h36m_hrnet_32")).model, torch.float32, "cuda")`` after
   ``serve.prepare``: K10 100 (its per-conv layer1's 13, K9 being bf16
   only), K10q 98 (85 step form, 13 scale form), no K9, no plain version;
   maps and poses against ``int8_impl="plain"`` as above; beside the bf16
   deploy graph (K9) of the same weights;
8c. cpn_knobs: the CPN deploy graph's two serving knobs (random weights
   from seed 0, batch 64, full width), ``cpn_fold_normalize`` (raw uint8
   frames into the int8 stem, K10s), ``cpn_int8_topdown`` (the s8 top-down
   hops, K10u, the up-convs requantizing in K10's epilogue) and both, in
   bf16, and both with an fp32 backbone, beside the main path, each
   prepared by ``serve.prepare`` on one seeded batch (``KNOB_GRAPHS``):
   one request records every K10s and K10u call, each equal to its plain
   version bit for bit (K10s also on all-0, all-255 and batch-1 frames;
   on the bf16 and fp32 fold+topdown requests timed: kernel, plain and
   library ms (K10s: normalize + cuDNN conv + addcmul + ReLU; K10u:
   interpolate + mul + add), the bound and the share of it), and on the
   top-down graph K10's up-convs (int8 out, no ReLU, no residual) bit for
   bit; then 2 requests with K10s 1 and K10u 3 launches a request beside
   the deploy graph's, the backbone maps and scales bit-equal to the same
   graph's with ``int8_impl="plain"`` and the poses within 2e-2 of it;
   host ms, frames/s, busy, idle, the K10s/K10u share and the top kernels
   of each graph beside the main path's (information); last, K10s and
   K10u at their edge shapes (``STEM_EDGES``, ``TOPDOWN_EDGES``), bf16 and
   fp32, bit for bit, one launch a call;
9. streaming: ``models.streaming.StreamingLifter`` over
   ``deploy_config("h36m_cpn")`` at batch 64 (its weights the JAX-format
   variables of the model drawn from seed 0): ``lift_batch`` refused
   before ``prepare``, then prepared on one seeded batch; 4 cameras x 38
   time slots (152 frames: two full chunks, one padded from 24 by
   repeating its last row) through the double-buffered ``lift_batch``,
   each chunk equal bit for bit to ``serve.lift`` on the same padded
   chunk, launches 3x a request's; ``stream`` with ``ema_alpha=0.5``
   equal to the per-camera EMA of ``lift_batch``'s poses to 1e-6; for
   information ``latency_stats`` over 20 passes (p50/p90/p99 ms, frames/s)
   beside the same frames through ``serve.lift`` chunk by chunk with no
   overlap; then one pass of ``deploy_config("h36m_hrnet_32")`` (K5, K9);
10. probes: the TPU probes' counterparts (``probes/``, K9's one-block and
   floor builds), their main path run once with every launch count set to
   0 before it and read after it, then each against its plain version
   (bit for bit; the two timing-only builds, wrong by design, run and are
   timed) with median kernel, plain and library ms and the bound: K10's
   requantizing 3x3 chain 1 and 8 deep at 64x48x32, batch 128 (library:
   cuDNN's bf16 conv + affine + ReLU); K10's pieces at that shape (the
   int32 main loop with and without border predication, the (98304, 576)
   x (576, 128) GEMM over a pre-windowed input against ``torch._int_mm``,
   the epilogue alone, the quantize pass alone, the bf16 main loop
   against cuDNN's conv); K9 at batch 128; K9 on one block against K10's
   chain of it; K9's floor build; the int8 window shift by an address
   offset and by a word shift, each beside the launch floor of the same
   timer (the library's empty kernel);
11. aggregate: this phase's main path, with every launch count set to 0
   before it and read after it: K8 through ``sample_points`` at full
   width, batch 64 (the CPN pyramid's 64x48x256 level with 17 zeros
   points and HRNet-W32's 64x48x32 level with 272 border points, in bf16
   and fp32, then the 64x48x256 level as int8, sampled to bf16), one
   launch a call, printed beside the launch floor of the timer (the
   library's empty kernel, one block); and K7 through ``deformable_aggregate`` on the first
   DeformableBlock of one served request of ``h36m_cpn`` and of
   ``h36m_hrnet_32`` (random weights from seed 0, batch 64; inputs
   captured by a forward hook, the block's own attention weights, points
   and ``embed_proj`` weights), in border mode, and at the CPN shapes in
   zeros mode and in fp32. Each call against its plain version (error /
   max|plain| within TOL; for K7 level by level, each level against its
   own max|plain|), with median kernel, plain and library times
   (``F.grid_sample``; for K7 per level ``F.grid_sample`` + ``F.linear``
   + ``einsum``) and the bound. On each served block, the A/B of K7
   against the block's own route (K1 with the in-kernel projection where
   ``kernel_can_preproject`` holds, then ``embed_proj`` and the einsum),
   both held against the plain version; the packed-points probe: the
   packed offsets, the (b, L, p, nh*ns, 2) points and the tensor K1 is
   handed share one storage, and K1's time on that view; then K1 on the
   CPN pyramid as int8 maps (bf16 samples) against its plain version;
12. backward: K6 against the plain backward at the training shapes (four
   64x48x256 maps, batch 64, 4x272 border points and 4x17 zeros points),
   fp32 and bf16, with and without dF: max abs error and error / max|plain|
   of d(points) and dF, median kernel and plain device times; then the
   training steps' own calls (fp32, border, no dF): the CPN's four
   64x48x256 maps at batch 256 and the HRNet-W32 (64x48x32, 32x24x64,
   16x12x128, 8x6x256) and W48 (48/96/192/384 channels) pyramids at batch
   512, each with the library call (``grid_sampler_2d_backward``) and the
   bound;
13. train: three presets at full width, each set up by its training CLI's
   own parsing (``build_argparser``, ``make_config``, ``make_datasets``;
   synthetic data and weights from seed 0; TF32 off), through the
   ``Trainer`` (``Trainer3dhp`` for 3DHP): h36m_cpn (fp32 CPN ResNet-50
   with the /4 graph, lifter embed 128 depth 4 with deformable blocks,
   AdamW, batch 256, flip augmentation, drop-path 0.2; 3 steps),
   h36m_hrnet_32 (the fp32 frozen HRNet-W32, the same lifter, batch 512; 4
   steps) and mpi_3dhp_hrnet_32 (the lifter without deformable blocks,
   root joint 14, batch 160; 4 steps), then one flip-test eval batch each
   (3DHP: P1, PCK and AUC). Every loss must be finite, the lifter must
   change and the backbone must not, and the launches must match: K1 5 and
   K6 4 a step on H36M (HRNet: K5 5), K1 and K5 1 on 3DHP. For each, one
   deterministic step through the kernels must agree with one through the
   plain sampler (``sampler="gather"``) from the same weights on the same
   batch: loss to 1e-5 relative, lifter gradients to a global relative L2
   of 1e-4. The Trainer stages its batches through
   ``pipeline.device_prefetch`` (a producer thread, pinned memory, copies
   on a side stream): its step losses must equal, bit for bit, those of
   the same batches copied by ``pipeline.to_device`` from the same initial
   state. Steps/s through the Trainer beside ``train_step`` on a
   device-resident batch, and, from a profiled warm epoch, the
   host-to-device copies' streams and how much of their time overlaps
   kernels on another stream (information only);
14. parallel: data-parallel training. (a) h36m_cpn at full width (batch
   256 a rank, fp32, TF32 off, set up by ``train_h36m``'s parsing with
   ``--distributed``): 3 ``train_step``s through a plain ``Trainer``, then
   through one under ``DistributedDataParallel`` over NCCL with world size
   1 (``parallel.distributed.initialize`` in-process on a free port), on
   the same device batches and seed: the losses must agree to 1e-6
   relative, the lifter's parameters to 1e-5 relative L2, and both runs
   launch K1 5 and K6 4 a step; steps/s of both (information). (b)
   ``parallel.dryrun``: two processes on this one card over gloo (the
   model's CUDA gradients reduced through gloo), the tiny config with
   augmentation and dropout off, 2 steps: the loss falls, every rank holds
   the same parameters and P1, and those equal one process on the
   concatenated batch (``dryrun.reference``) to 1e-5 relative L2; each rank
   gathers 3 and 2 rows (``allgather_hosts``) in rank order. (c) Where
   there are two cards or more, the same over NCCL with one rank a card.
   (d) Tensor parallelism: h36m_cpn at full width (set up by
   ``train_h36m``'s parsing with ``--distributed --model-parallel 2``)
   split over two gloo ranks on this one card (``parallel.dryrun.spawn``),
   2 steps on the preset's first batches at batch 256 (or the first of 128
   and 64 that two ranks hold, printed), against the plain ``Trainer``'s 2
   steps on the same batches: losses to 1e-5 relative and equal on both
   ranks, the gathered lifter parameters to 1e-6 relative L2, K1 5 and K6
   4 a step on each rank; each rank's peak memory and steps/s on one batch
   (information). (e) ``parallel.dryrun`` with ``--model-parallel 2``: the
   tiny model split over two gloo ranks on the card against one process,
   as in (b); with four cards or more, dp=2 x tp=2 over NCCL;
15. coco: the CPN COCO detector (``models/cpn_coco.py``,
   ``train/train_coco.py``) at full width (ResNet-50 (3, 4, 6, 3), 256x192,
   K = 17, live BN, fp32, TF32 off, random weights from seed 0): the card
   against the CPU on the same weights at batch 4 (eval-mode global and
   refine heads, one train step's loss and the BN running statistics, each
   to 1e-4 relative RMS); 8 Adam steps at batch 32 on one repeated
   synthetic batch, whose loss must be finite and fall; ``train_coco
   --eval --flip`` on a synthetic person_keypoints set (6 JPEG frames
   written by cv2 to a temporary directory, with detections): one result a
   frame and an AP in [0, 1]. Information: ms a warm training step at
   batch 32 and flip-test eval frames/s (the model computes
   channels-last);
16. gate: the deploy-numerics gate (``deploy_numerics.preset_gate``, 250
   steps of the tiny model of h36m_cpn, h36m_hrnet_32 and
   mpi_3dhp_hrnet_32 on the synthetic task, then P1 of the fp32 model and
   of its int8 deploy stack calibrated by ``serve.prepare``): fails when
   the deploy P1 differs from the fp32 P1 by more than 1.0 mm either way,
   or the gate's training launched other than K1 3 and K6 2 a step (3DHP:
   K1 1); for h36m_cpn also the deploy stack with each serving knob on the
   same weights (K10s, K10u), each P1 printed with its delta against fp32
   (within the same 1.0 mm) and against the deploy stack. Then, at the gate's own shapes (embed 32, head dim 8, 64x64
   frames, batch 16): the trained fp32 model's deterministic step through
   the kernels against the plain sampler, as in phase 13; on one
   validation batch of the calibrated deploy model, its backbone maps
   through K9/K10/K10q/K10p against their plain versions bit for bit
   (HRNet: and against ``config.deploy``'s own layer1, the per-conv int8
   chain, bit for bit), each K1-K4 call of its lifter, recorded, against
   its plain version (error / max|plain| within the bf16 tolerance), and
   its flip-test predictions against the plain lifter (``sampler=
   "gather"``, einsum attention and MLP) in bf16 and in fp32: the
   kernels' relative RMS distance to the fp32 lifter may exceed the plain
   bf16 lifter's by at most 2e-2 (the tiny bf16 lifter itself sits 3-6%
   from its fp32 version). Each of those kernels must have launched in
   that batch and none in the plain runs;
17. tools: ``tools/model_flops`` (the parity graph's GFLOP a frame of
   every preset on the meta device by XLA's per-op rules, equal to the
   committed ``FLOPS_torch.json`` and not above the JAX package's
   ``FLOPS.json``, XLA's optimized graph; h36m_cpn's training step and
   deploy graph);
   the main path (``deploy_config("h36m_cpn")``, batch 64, prepared on
   one seeded batch): frames/s over 10 requests and its MFU against the
   bf16 peak, and one request profiled under
   ``tools/trace_budget.annotate`` whose named buckets (not the fallback
   ones) must hold 95% of the device time (traced twice, the second
   kept, each one's total and stem bucket printed; its "int8 quantize" and
   "backbone stem" buckets printed apart), and the same request through
   the deploy graph with both serving knobs, traced the same way (its
   "backbone stem" (K10s), "globalNet top-down (K10u)" and "globalNet"
   buckets printed, its named share held to the same 95%); ``tools/train_bench.bench_batch`` for h36m_cpn at batch
   256 (a burst of 3 steps: steps/s, MFU against the fp32 peak) with one
   profiled step whose budget must too; ``tools/demo`` (the h36m_hrnet_32
   float slice through ``StreamingLifter``) writes a PNG of finite poses;
18. a JSON line of per-kernel results (K1-K10, K10q, K10p, K10s, K10u and
   the float convs' epilogue ``conv_epilogue``, then the
   probes' counterparts, named ``probe <name>``), then the final JSON status
   line. ``launches`` are summed over the serving (quantize, fp32_int8
   and streaming included), aggregate, training, parallel (the full-width DDP run and
   both ranks of the tensor-parallel one) and gate runs, each counted from
   0 (the
   probes': their phase's main run). Each phase's seconds are printed as
   it ends and summed by phase before the JSON lines. Errors are the largest over the bf16 cases (int8 maps, sampled to
   bf16, included). Times are bf16 at the CPN serving shapes for K1-K4,
   at HRNet-W32's for K5 and K9, at the CPN int8 request's for K10, K10q
   and K10p, at the bf16 fold+topdown request's for K10s and K10u (K10u
   the sum of its 3 hops), all per request (the sum over a request's
   calls), K6's those of
   the CPN training step's call at batch 256 times its 4 calls a step, K7's
   the sum of its two served blocks' border calls and K8's of its two
   bf16 calls.
   ``bound_ms`` is the larger of the bytes the calls must move over
   3.35 TB/s and their operations over 989 TFLOP/s (bf16), 67 TFLOP/s
   (fp32) or 1979 TOP/s (int8), the H100 SXM peaks (the samplers' and
   K7's blend and weighting, which run in fp32, at the fp32 rate; their
   projection on bf16 and int8 maps, on the tensor cores, at the bf16 rate,
   the larger of the two; W counted at the element size the kernel reads);
   a sampler must read only the distinct map rows its points' taps touch,
   counted from this run's points. K7's operations are the least its
   function needs: it may pool each head's ns samples before one
   projection a row.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import time
from dataclasses import replace

import torch
import torch.nn.functional as F

BATCH = 64
REQUESTS = 3
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # error / max|plain|
SLICE_REL_RMS = 2e-2
# the fp32_lifter phase: the lifter's kernels in fp32 against its plain
# routes, relative RMS of the poses (the kernels sum in other orders, and
# the fused MLP's LN takes E[x^2] - mu^2 where the plain block's
# F.layer_norm takes two passes)
FP32_LIFTER_REL_RMS = 1e-4
_H36M = {"K1": 5, "K2": 12, "K3": 4, "K4": 4}
_H36M_HRNET = {**_H36M, "K5": 5}
_MPI_HRNET = {"K1": 1, "K2": 8, "K3": 4, "K4": 4, "K5": 1}
PER_REQUEST = {  # launches per request: depth 4, deformable blocks on H36M
    "h36m_cpn": _H36M,
    "h36m_hrnet_32": _H36M_HRNET, "h36m_hrnet_48": _H36M_HRNET,
    "mpi_3dhp_hrnet_32": _MPI_HRNET, "mpi_3dhp_hrnet_48": _MPI_HRNET,
}
HRNET_REQUESTS = {"h36m_hrnet_32": REQUESTS, "h36m_hrnet_48": 1,
                  "mpi_3dhp_hrnet_32": 1, "mpi_3dhp_hrnet_48": 1}
# the int8 deploy graphs add, per backbone kind: HRNet K9 (one launch a
# layer1 block) and K10 (85 convs with both channel counts >= 128, and
# transition1's two); CPN K10 for every conv but the stem: 52 ResNet-50
# convs (16 bottlenecks, 4 downsamples), 4 laterals, 3 up-convs and 24
# refineNet convs (6 bottlenecks), the count of int8 convolutions in the
# JAX package's graph (tests/test_torch_cpn_int8.py). K10q is K10's
# quantize pass, one launch for each conv with a bf16 input (its step
# form): HRNet's 85 wide convs (transition1 reads K9's int8), CPN's 3
# up-convs; and the CPN stream's own quantizes (its scale form): the three
# refineNet cascades' inputs and the int8 /4 map. K10p is the stream's
# stem, its quantize and max-pool in one launch. conv_epilogue, the float
# convs' epilogue, launches once for each float conv: 192 in HRNet's deploy
# graph (the stem, every conv of branches 0 and 1, the fuse layers' convs
# that stay float), the CPN's stem alone; a float backbone
# (FLOAT_EPILOGUES: the serving slices and training's frozen backbones)
# once for each of its convs (tests/test_torch_conv_epilogue.py)
INT8_PER_REQUEST = {"hrnet": {"K9": 4, "K10": 87, "K10q": 85,
                              "conv_epilogue": 192},
                    "cpn": {"K10": 83, "K10q": 7, "K10p": 1,
                            "conv_epilogue": 1}}
FLOAT_EPILOGUES = {"cpn": {"conv_epilogue": 84},
                   "hrnet": {"conv_epilogue": 292}}
# K10q's amax values on every bf16 pattern (cpn_int8 phase): the 1e-12
# clamp (amax 0), tiny (the dynamic route's step below 2^-64 takes the IEEE
# division), powers of two, random draws, the largest finite bf16
K10Q_AMAXES = (0.0, 1e-30, 1e-19, 1e-15, 2.0 ** -20, 2.0 ** -3, 1.0,
               127 / 16, 2.0 ** 7, 2.0 ** 40, 0.0371, 5.7, 190.11514, 3.1e4,
               6.02e11, 3.3895e38)
K10Q_FORMS = (("step dynamic", "step", False),
              ("step calibrated", "step", True), ("scale", "scale", True))
# the backbone's other quantize modes (serve.quantize_config): K10 and its
# quantize pass K10q once for each int8 conv, every input bf16; "static"
# every 3x3 conv with both channel counts >= 16 and every wide conv (HRNet
# 256, CPN 76), "c128" the wide convs (HRNet 85, CPN 73): the JAX graphs'
# counts (tests/test_torch_k10_plan.py). K9 runs in neither; the float
# epilogue once for each other conv
QUANT_PER_REQUEST = {
    "static": {"hrnet": {"K10": 256, "K10q": 256, "conv_epilogue": 36},
               "cpn": {"K10": 76, "K10q": 76, "conv_epilogue": 8}},
    "c128": {"hrnet": {"K10": 85, "K10q": 85, "conv_epilogue": 207},
             "cpn": {"K10": 73, "K10q": 73, "conv_epilogue": 11}},
}
# (preset, mode, requests served) of the quantize phase; each graph's K10
# shapes are checked, and those of QUANT_SHAPES_ONLY
QUANT_GRAPHS = (("h36m_hrnet_32", "static", REQUESTS),
                ("h36m_hrnet_48", "static", 1), ("h36m_cpn", "static", 1),
                ("h36m_hrnet_32", "c128", 1), ("h36m_cpn", "c128", 1))
QUANT_SHAPES_ONLY = (("h36m_hrnet_48", "c128"),)
# the cpn_knobs phase: the CPN deploy graph with each serving knob and both
# (bf16), and with both on an fp32 backbone, beside the main path; each
# knob's launches a request on top of the deploy graph's (the fold's stem
# K10s, in place of the float stem's epilogue; a top-down hop K10u each of
# globalNet's three)
KNOB_GRAPHS = (("main path", {}, torch.bfloat16),
               ("fold", {"cpn_fold_normalize": True}, torch.bfloat16),
               ("topdown", {"cpn_int8_topdown": True}, torch.bfloat16),
               ("fold+topdown", {"cpn_fold_normalize": True,
                                 "cpn_int8_topdown": True}, torch.bfloat16),
               ("fold+topdown fp32", {"cpn_fold_normalize": True,
                                      "cpn_int8_topdown": True},
                torch.float32))
KNOB_PER_REQUEST = {"cpn_fold_normalize": {"K10s": 1, "conv_epilogue": 0},
                    "cpn_int8_topdown": {"K10u": 3}}
KNOB_TIMED_GRAPHS = ("fold+topdown", "fold+topdown fp32")  # K10s, K10u timed
KNOB_REQUESTS = 2  # counted requests of each knob graph
KNOB_TIMED = 5  # host-clock requests of each knob graph
QUANT_TIMED = 5  # host-clock requests of a quantize graph
# the fp32_int8 phase: the int8 deploy graphs with an fp32 backbone
# (``config.deploy(preset)`` built in fp32). K10, K10q and K10p a request:
# the CPN's as its bf16 graph's; an fp32 HRNet's layer1 is the per-conv
# chain (K9 is bf16 only): its 13 convs and 13 quantizes (K10q's scale
# form) beside the 85 wide convs with their 85 step-form quantizes and
# transition1's 2 convs; the float epilogue as the bf16 graphs'
FP32_PER_REQUEST = {"cpn": {"K10": 83, "K10q": 7, "K10p": 1,
                            "conv_epilogue": 1},
                    "hrnet": {"K10": 100, "K10q": 98, "conv_epilogue": 192}}
FP32_REQUESTS = 3  # lift_batch requests of BATCH frames
FP32_TIMED = 5  # host-clock requests of each graph
# K10q on all 2^32 fp32 bit patterns: (label, form, clamp, amax values):
# per step form one amax whose step lies in [2^-64, 2^64] (the reciprocal
# route) and one outside it (the IEEE division), two in the scale form;
# the rest of K10Q_AMAXES on a random draw of K10Q_FP32_DRAW patterns
K10Q_FP32_FULL = (("step dynamic", "step", False, (127 / 16, 1e-30)),
                  ("step calibrated", "step", True, (5.7, 3.3895e38)),
                  ("scale", "scale", True, (127 / 16, 190.11514)))
FP32_PATTERN_CHUNK = 2 ** 28
K10Q_FP32_DRAW = 2 ** 26
# the streaming phase: 4 cameras x 38 time slots through the h36m_cpn
# deploy graph at batch 64 (two full chunks, one padded from 24), then one
# pass of the h36m_hrnet_32 deploy graph; passes timed for latency_stats
STREAM_CAMERAS, STREAM_SLOTS = 4, 38
STREAM_PASSES = 20
STREAM_EMA = 0.5
TIMED_REQUESTS = 10  # host-clock frames/s, after the checked requests
FP32_LIFTER_TIMED = 5  # host-clock requests of the fp32_lifter phase
PROFILED = 5  # requests under torch.profiler
TOP_KERNELS = 8
TRAIN_BATCH = 256  # the h36m_cpn preset's batch
HRNET_TRAIN_BATCH = 512  # the HRNet H36M presets' batch
K6_CALLS_A_STEP = 4  # one a deformable block
# the training runs: (preset, its batch, steps, launches a step, launches
# of the flip-test eval batch, the deterministic kernels-vs-plain step).
# The 17 reference points need no K6; each sampler call on HRNet samples
# its 64x48x32 level (K5); the frozen float backbone's epilogues, once a
# forward (the flip test's is one forward of 2B)
_CPN_FLOAT = FLOAT_EPILOGUES["cpn"]
_HRNET_FLOAT = FLOAT_EPILOGUES["hrnet"]
TRAIN_RUNS = (
    ("h36m_cpn", TRAIN_BATCH, 3,
     {"K1": 5, "K6": K6_CALLS_A_STEP, **_CPN_FLOAT},
     {"K1": 5, **_CPN_FLOAT}, True),
    ("h36m_hrnet_32", HRNET_TRAIN_BATCH, 4,
     {"K1": 5, "K5": 5, "K6": K6_CALLS_A_STEP, **_HRNET_FLOAT},
     {"K1": 5, "K5": 5, **_HRNET_FLOAT}, True),
    ("mpi_3dhp_hrnet_32", 160, 4, {"K1": 1, "K5": 1, **_HRNET_FLOAT},
     {"K1": 1, "K5": 1, **_HRNET_FLOAT}, True),
)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL_L2 = 1e-4
# the parallel phase: h36m_cpn under DDP (world size 1) against the plain
# Trainer, then the tiny dry run's ranks against one process
PARALLEL_STEPS = 3
PARALLEL_PER_STEP = {"K1": 5, "K6": K6_CALLS_A_STEP, **_CPN_FLOAT}
PARALLEL_LOSS_RTOL = 1e-6
PARALLEL_REL_L2 = 1e-5
PARALLEL_DRYRUN_STEPS = 2
# the tensor-parallel runs: h36m_cpn at full width (the preset's batch)
# split over two gloo ranks on the one card against the plain Trainer on
# the same batches, then the tiny dry run split over two ranks
TP_STEPS = 2
TP_TIMED = 2  # steps a rank times on one batch, after the checked steps
TP_LOSS_RTOL = 1e-5
TP_REL_L2 = 1e-6
# the tools phase: timed requests of the main path, the train_bench burst
TOOLS_REQUESTS = 10
MIN_COVERAGE = 0.95  # of device time, by the trace budget
# the coco phase: card vs CPU at batch 4 (relative RMS), Adam steps on one
# batch of the recipe's 32, timed calls a layout, frames of the --eval run
COCO_CHECK_BATCH = 4
COCO_REL = 1e-4
COCO_STEPS = 8
COCO_TIMED = 5
COCO_EVAL_IMAGES = 6
# the deploy-numerics gate: one preset of each tiny class, with its
# launches a training step (the tiny lifter has depth 2: the reference
# points' call and one a deformable block; the tiny backbone's float
# epilogues: the CPN's one block a stage, HRNet at width 32) and the
# kernels one validation
# batch of its deploy model must launch; fail beyond this P1 delta (deploy
# minus fp32), either way
_GATE_LIFTER = ("K1", "K2", "K3", "K4")
GATE_PRESETS = {
    "h36m_cpn": ({"K1": 3, "K6": 2, "conv_epilogue": 48},
                 (*_GATE_LIFTER, "K10", "K10q", "K10p", "conv_epilogue")),
    "h36m_hrnet_32": ({"K1": 3, "K6": 2, "conv_epilogue": 67},
                      (*_GATE_LIFTER, "K9", "K10", "K10q", "conv_epilogue")),
    "mpi_3dhp_hrnet_32": ({"K1": 1, "conv_epilogue": 67},
                          (*_GATE_LIFTER, "K9", "K10", "K10q",
                           "conv_epilogue")),
}
GATE_STEPS = 250
GATE_MAX_DELTA_MM = 1.0
CSRC = "contextaware_poseformer_tpu_torch/ops/csrc/"
REPLACES = {
    "K1": "contextaware_poseformer_tpu/ops/deformable.py:409",
    "K2": "contextaware_poseformer_tpu/ops/fused_mlp.py:75",
    "K3": "contextaware_poseformer_tpu/ops/small_attention.py:58",
    "K4": "contextaware_poseformer_tpu/ops/joint_attention.py:50",
    "K5": "contextaware_poseformer_tpu/ops/deformable.py:148",
    "K6": "contextaware_poseformer_tpu/ops/deformable.py:783",
    "K7": "contextaware_poseformer_tpu/ops/deformable.py:947",
    "K8": "contextaware_poseformer_tpu/ops/deformable.py:215",
    "K9": "contextaware_poseformer_tpu/ops/layer1_chain.py:51",
    "K10": "contextaware_poseformer_tpu/models/backbone_common.py:204",
    "K10q": "contextaware_poseformer_tpu/models/backbone_common.py:201",
    "K10p": "contextaware_poseformer_tpu/models/cpn.py:244",
    "K10s": "contextaware_poseformer_tpu/models/cpn.py:214",
    "K10u": "contextaware_poseformer_tpu/models/cpn.py:334",
    "conv_epilogue": "none (XLA fuses the float convs' affine, residual "
                     "add and ReLU)",
    # the TPU probes' counterparts (probes phase)
    "chain_conv": "experiments/int8_chain_conv.py:54",
    "micro_matmul3": "experiments/int8_chain_micro.py:20",
    "micro_matmul3_nomask": "experiments/int8_chain_micro.py:37",
    "micro_requant": "experiments/int8_chain_micro.py:50",
    "micro_matmul1": "experiments/int8_chain_micro.py:66",
    "micro_bf16_matmul3": "experiments/int8_chain_micro.py:77",
    "micro_quantize": "experiments/int8_chain_micro.py:109",
    "layer1_v1": "experiments/layer1_chain_probe.py:32",
    "layer1_1block": "experiments/layer1_chain_probe.py:138",
    "layer1_floor": "experiments/layer1_chain_floor.py:22",
    "window_bitcast": "experiments/int8_primitives.py:39",
    "window_slice": "experiments/int8_primitives.py:47",
}
SOURCES = {"K1": "sampler.cu", "K2": "fused_mlp.cu",
           "K3": "small_attention.cu", "K4": "joint_attention.cu",
           "K5": "sampler.cu", "K6": "sampler_bwd.cu",
           "K7": "aggregate.cu", "K8": "sampler.cu",
           "K9": "layer1_chain.cu", "K10": "int8_conv.cu",
           "K10q": "int8_conv.cu", "K10p": "int8_conv.cu",
           "K10s": "stem_conv.cu", "K10u": "topdown.cu",
           "conv_epilogue": "conv_epilogue.cu",
           "chain_conv": "int8_conv.cu", "micro_matmul3": "int8_conv.cu",
           "micro_matmul3_nomask": "int8_conv.cu",
           "micro_requant": "int8_conv.cu", "micro_matmul1": "int8_conv.cu",
           "micro_bf16_matmul3": "int8_conv.cu",
           "micro_quantize": "int8_conv.cu", "layer1_v1": "layer1_chain.cu",
           "layer1_1block": "layer1_chain.cu",
           "layer1_floor": "layer1_chain.cu", "window_bitcast": "probes.cu",
           "window_slice": "probes.cu"}
LEVELS = ((8, 6), (16, 12), (32, 24), (64, 48))  # CPN native pyramid
HRNET_PYRAMIDS = {  # 256x192 frames, finest first
    "W32": ((64, 48, 32), (32, 24, 64), (16, 12, 128), (8, 6, 256)),
    "W48": ((64, 48, 48), (32, 24, 96), (16, 12, 192), (8, 6, 384)),
}
HEAD_DIM = 32  # deformable head dim: embed 128 over 4 heads
# K8 at full width: (case, map (H, W, C), padding, points per item); the
# CPN serving pyramid's 64x48 level with the 17 reference points, and
# HRNet-W32's 64x48x32 level (the TPU's two-stage body) with 17x16 points
K8_CASES = (
    ("CPN 64x48x256 zeros P=17", (64, 48, 256), "zeros", (17,)),
    ("W32 64x48x32 border P=272", (64, 48, 32), "border", (17, 16)),
)
AGGREGATE_PRESETS = ("h36m_cpn", "h36m_hrnet_32")  # K7 on their blocks
SLEEP_CYCLES = 4_000_000  # ~2 ms of device clock ahead of a timed window
# kernels whose share of a served request's device time is printed, by the
# names of their CUDA kernels (those redesigned for Hopper in the port)
SHARE_KERNELS = {"K1": ("sample_levels_kernel",),
                 "K2": ("ln_mlp_resident_kernel", "ln_fc1_kernel",
                        "fc2_residual_kernel", "ln_mlp_f32_fused_kernel",
                        "ln_rows_f32_kernel", "mlp_f32_gemm_kernel"),
                 "K3": ("small_attention_tc_kernel",
                        "small_attention_cores_kernel"),
                 "K9": ("layer1_block_kernel",),
                 "K10": ("::conv_kernel<",),
                 "K10q": ("int8_quantize_kernel",),
                 "K10p": ("int8_quant_pool_kernel",),
                 "K10s": ("stem_conv_kernel",),
                 "K10u": ("topdown_kernel",)}
# SASS instructions that show a build runs on Hopper's machinery: the
# tensor cores (HGMMA / IGMMA: bf16 / int8 wgmma, HMMA / IMMA: mma.sync) and
# the asynchronous copies (LDGSTS: cp.async, UTMALDG: TMA); per kernel:
# (function name parts, the instructions it must hold, one of which
# suffices for each tuple)
SASS_OPS = ("HGMMA", "HMMA", "IGMMA", "IMMA", "LDGSTS", "UTMALDG", "FFMA")
_WGMMA_ASYNC = (("HGMMA",), ("LDGSTS", "UTMALDG"))
_MMA_ASYNC = (("HMMA", "HGMMA"), ("LDGSTS", "UTMALDG"))
_FFMA_ASYNC = (("FFMA",), ("LDGSTS", "UTMALDG"))
SASS_REQUIRED = (
    # K7's bf16 body (pool first, then mma.sync; W by cp.async)
    ("K7", ("aggregate_cu", "aggregate_kernelI13__nv_bfloat16"), _MMA_ASYNC),
    # K3's bf16 body; K9's four builds (1x1 convs on wgmma, conv2 on mma.sync)
    ("K3", ("small_attention_tc_kernel",), _WGMMA_ASYNC),
    ("K9", ("layer1_block_kernel",),
     (("IGMMA",), ("IMMA",), ("LDGSTS", "UTMALDG"))),
    # K10's product builds (Mode 0, int8 operands), bf16 and fp32
    # epilogues: int8 wgmma, B by TMA
    ("K10", ("int8_conv_cu", "conv_kernel", "ModeE0ELb0E"),
     (("IGMMA",), ("UTMALDG",))),
    # K10s, the fold stem: int8 wgmma (A from registers), its rows by
    # cp.async; K10u, the s8 hop: its source rows by cp.async
    ("K10s", ("stem_conv_kernel",), (("IGMMA",), ("LDGSTS",))),
    ("K10u", ("topdown_kernel",), (("LDGSTS",),)),
    ("K2", ("fused_mlp", "resident_kernel"), _WGMMA_ASYNC),
    ("K2", ("fused_mlp", "ln_fc1_kernel"), _WGMMA_ASYNC),
    ("K2", ("fused_mlp", "fc2_residual_kernel"), _WGMMA_ASYNC),
    # K2's fp32 routes and K3's CUDA-core body: fp32 FMAs (FFMA) on
    # operands staged by cp.async (LDGSTS)
    ("K2", ("fused_mlp", "ln_mlp_f32_fused_kernel"), _FFMA_ASYNC),
    ("K2", ("fused_mlp", "mlp_f32_gemm_kernel"), _FFMA_ASYNC),
    ("K3", ("small_attention_cores_kernel",), _FFMA_ASYNC),
    # the sampler's builds with the tensor-core projected body (kProj =
    # true; the gather-only builds hold none by design)
    ("K1", ("sampler_cu", "sample_levels_kernelI13__nv_bfloat16S1_Lb1"),
     _MMA_ASYNC),
    ("K1", ("sampler_cu", "sample_levels_kernelIa13__nv_bfloat16Lb1"),
     _MMA_ASYNC),
    # its fp32 projected build: FFMA products on the blends and W's rows,
    # W by cp.async
    ("K1", ("sampler_cu", "sample_levels_kernelIffLb1"), _FFMA_ASYNC),
)
# kernels whose builds must not spill registers (-Xptxas -v): the
# sampler's (K1, K5, K8; the gather's batched taps and the tensor-core
# builds' register cap), K7's, K10s's and K10u's (two blocks an SM and
# more: the register caps their plans count on), and the fp32 bodies of K2
# and K3 (their micro-tiles of accumulators)
NO_SPILLS = ("sample_levels_kernel", "aggregate_kernel", "stem_conv_kernel",
             "topdown_kernel", "ln_mlp_f32_fused_kernel",
             "mlp_f32_gemm_kernel", "ln_rows_f32_kernel",
             "small_attention_cores_kernel")
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12,  # dense FLOP/s
            torch.int8: 1979e12}  # dense int8 TOP/s
# K10 at the deploy graph's shapes: (name, H, W, Cin, Cout, k, stride, int8
# input, calls a request); channel counts are multiples of the branch width
# C (32 or 48) except transition1's input, layer1's 256
K10_SHAPES = (
    ("transition1.0", 64, 48, 256, 1, 3, 1, True, 1),
    ("transition1.1", 64, 48, 256, 2, 3, 2, True, 1),
    ("branch 16x12", 16, 12, 4, 4, 3, 1, False, 56),
    ("branch 8x6", 8, 6, 8, 8, 3, 1, False, 24),
    ("fuse 1x1", 8, 6, 8, 4, 1, 1, False, 2),
    ("fuse / transition3 s2", 16, 12, 4, 8, 3, 2, False, 3),
)


def _median_ms(fn, runs=20, warmup=3):
    """Median device time of ``fn`` over ``runs`` CUDA-event windows. A
    sleep kernel queued before each window keeps the device busy while the
    host enqueues ``fn``'s launches, so a window holds device work only and
    not the host's Python and dispatch time."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    for start, end in events:
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _err(out, ref):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = max((o.float() - r.float()).abs().max().item()
              for o, r in zip(outs, refs))
    scale = max(r.float().abs().max().item() for r in refs)
    return err, err / scale


def _level_errs(out, ref):
    """(max abs error, [error / max|plain| of each level]) of a
    (b, L, ...) result: each level is held against its own scale, so a
    level of small values is not hidden by a larger one."""
    err = (out.float() - ref.float()).abs().max().item()
    rels = [_err(out[:, l], ref[:, l])[1] for l in range(ref.shape[1])]
    return err, rels


def _fmt_rels(rels):
    return "[" + ", ".join(f"{r:.3e}" for r in rels) + "]"


def _bound(nbytes, ops, dtype):
    """(bound ms, what bounds it) for work of ``nbytes`` and ``ops``, all of
    type ``dtype``, or ``ops`` {type: operations} of several types, each at
    its own rate (the tensor cores and the fp32 units run side by side)."""
    t_bytes = nbytes / PEAK_BYTES
    if isinstance(ops, dict):
        t_ops = max(n / PEAK_OPS[dt] for dt, n in ops.items())
    else:
        t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _distinct_taps(f, pts, border):
    """Distinct (batch item, map row) pairs the bilinear taps of ``pts``
    (b, P, 2) touch in the NHWC map ``f``, taps outside the map excluded."""
    b, h, w, _ = f.shape
    x = (pts[..., 0].float() + 1) * 0.5 * (w - 1)
    y = (pts[..., 1].float() + 1) * 0.5 * (h - 1)
    if border:
        x, y = x.clamp(0, w - 1), y.clamp(0, h - 1)
    x0, y0 = x.floor().long(), y.floor().long()
    item = torch.arange(b, device=f.device)[:, None]
    rows = []
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0 + dy, x0 + dx
            ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            rows.append(((item * h + yi) * w + xi)[ok])
    return torch.unique(torch.cat(rows)).numel()


def _ops_total(ops):
    return sum(ops.values()) if isinstance(ops, dict) else ops


def _sampler_work(maps, pts, projs, border, split=False):
    """(bytes, operations) of one sampler call: the distinct tap rows, the
    points, the outputs and the projection weights (W in bf16 where the
    tensor-core body reads W^T, bf16 and int8 maps, else fp32; the bias in
    fp32); 8 operations a sampled channel (4 taps, multiply and add) plus
    the projection's 2*C*Cout a point. ``split``: the operations as {type:
    count}, the blend in fp32 and the projection in bf16 (the tensor-core
    body of bf16 and int8 maps, and the JAX kernel's DEFAULT precision)."""
    b, levels = pts.shape[:2]
    p = pts[0, 0].numel() // 2
    pts = pts.reshape(b, levels, p, 2)
    nbytes, ops, proj_ops = pts.numel() * 4, 0, 0
    for l, f in enumerate(maps):
        c, elem = f.shape[-1], f.element_size()
        nbytes += _distinct_taps(f, pts[:, l], border) * c * elem
        cout = c
        if projs is not None and projs[l] is not None:
            cout = projs[l].shape[1]
            w_elem = 4 if f.dtype == torch.float32 else 2
            nbytes += c * cout * w_elem + cout * 4
            proj_ops += 2 * b * p * c * cout
        # an int8 map's samples are written as bf16
        nbytes += b * p * cout * (2 if f.dtype == torch.int8 else elem)
        ops += 8 * b * p * c
    if split:
        return nbytes, {torch.float32: ops, torch.bfloat16: proj_ops}
    return nbytes, ops + proj_ops


def _grid_sample_fn(maps, pts, mode, projs=None, biases=None):
    """The library call for a sampler call: ``F.grid_sample`` per level on
    the NCHW view of each NHWC map, plus ``F.linear`` for a projected
    level."""
    b, levels = pts.shape[:2]
    grid = pts.reshape(b, levels, 1, -1, 2).to(maps[0].dtype)

    def run():
        outs = []
        for l, f in enumerate(maps):
            s = F.grid_sample(f.permute(0, 3, 1, 2), grid[:, l],
                              mode="bilinear", padding_mode=mode,
                              align_corners=True)
            if projs is not None and projs[l] is not None:
                s = F.linear(s.squeeze(2).transpose(1, 2),
                             projs[l].t().to(f.dtype),
                             biases[l].to(f.dtype))
            outs.append(s)
        return outs

    return run


def _sampler_cases(gen, dtype, b, dims, mixed_proj):
    """(case name, calls per request, maps, points, mode, projs, biases) of
    a serving pyramid: the zeros 17-point call and the border 272-point
    call. ``mixed_proj``: project where the lifter does
    (``kernel_can_preproject``), else every level to HEAD_DIM."""
    from contextaware_poseformer_tpu_torch.ops import deformable

    def uniform(lo, hi, *shape):
        return (torch.rand(*shape, generator=gen) * (hi - lo) + lo).cuda()

    maps = [torch.randn(b, h, w, c, generator=gen).to("cuda", dtype)
            for h, w, c in dims]
    projs, biases = [], []
    # parameters as the served lifter holds them: made outside inference
    # mode, so that the tensor-core body reads W^T in bf16, cast once
    # (deformable.kernel_weight)
    with torch.inference_mode(False):
        for h, w, c in dims:
            on = not mixed_proj or deformable.kernel_can_preproject(
                h, w, c, HEAD_DIM, dtype)
            projs.append(uniform(-1, 1, c, HEAD_DIM) / c ** 0.5 if on
                         else None)
            biases.append(uniform(-0.1, 0.1, HEAD_DIM) if on else None)
    levels = len(dims)
    border = uniform(-1.5, 1.5, b, levels, 17, 16, 2)
    cases = [
        ("zeros P=17", 1, maps, uniform(-1.1, 1.1, b, levels, 17, 2),
         "zeros", None, None),
        ("border+proj P=272", 4, maps, border, "border", projs, biases),
        # the same call's gather alone: the split between gather and
        # projection (no request makes this call)
        ("border P=272 gather only", 0, maps, border, "border", None, None),
    ]
    if mixed_proj:  # K5: each level of the border call alone
        cases += [(f"border+proj P=272 level {l} {dims[l]} alone", 0,
                   [maps[l]], border[:, l:l + 1].contiguous(), "border",
                   [projs[l]], [biases[l]]) for l in range(levels)]
    return cases


def _sampler_plan_line(maps, pts, projs):
    """The sampler's plan of a call (``deformable.sampler_plan``): per
    level the body, points a unit and units, then the shared memory a
    block reserves."""
    from contextaware_poseformer_tpu_torch.ops import deformable

    dtype = maps[0].dtype
    projs = projs or [None] * len(maps)
    spec = [(f.shape[-1], None if w is None else w.shape[1])
            for f, w in zip(maps, projs)]
    p = pts[0, 0].numel() // 2
    plan = deformable.sampler_plan(dtype, spec, pts.shape[0], p)
    levels = ", ".join(
        f"{tuple(f.shape[1:])} {body} {size} points x {n}"
        for f, body, size, n in zip(maps, plan.bodies, plan.unit_points,
                                    plan.units))
    return (f"{levels}; {plan.blocks} blocks, order {list(plan.order)}, "
            f"{plan.smem} B shared memory a block")


def _kernel_cases(dtype, gen):
    """(kernel, case name, calls, kernel fn, plain fn, work, library fn or
    None, the sampler's plan or None) at the serving shapes with batch
    BATCH. ``calls``: the case's
    calls in the request whose times the JSON line reports (CPN's for
    K1-K4, HRNet-W32's for K5), 0 at another preset's shapes; ``work`` is
    (bytes, operations) of one call."""
    from contextaware_poseformer_tpu_torch.ops import (
        deformable, fused_mlp, joint_attention, small_attention,
    )

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    def uniform(lo, hi, *shape):
        return (torch.rand(*shape, generator=gen) * (hi - lo) + lo).cuda()

    b = BATCH
    cases = []
    samplers = [("K1", "CPN", tuple((h, w, 256) for h, w in LEVELS), False)]
    samplers += [("K5", name, dims, True)
                 for name, dims in sorted(HRNET_PYRAMIDS.items())]
    for kern, pyramid, dims, mixed in samplers:
        timed = pyramid != "W48"  # K5's times: the W32 request
        for case, calls, maps, pts, mode, projs, biases in _sampler_cases(
                gen, dtype, b, dims, mixed):
            cases.append((
                kern, f"{pyramid} {case}", calls if timed else 0,
                lambda maps=maps, pts=pts, mode=mode, projs=projs,
                biases=biases: deformable.sample_points_multi(
                    maps, pts, mode, True, projs, biases),
                lambda maps=maps, pts=pts, mode=mode, projs=projs,
                biases=biases: deformable.sample_points_multi_reference(
                    maps, pts, mode, True, projs, biases),
                _sampler_work(maps, pts, projs, mode == "border",
                              split=dtype != torch.float32),
                _grid_sample_fn(maps, pts, mode, projs, biases),
                _sampler_plan_line(maps, pts, projs),
            ))
    # the H36M lifter's widths (embed 128, joint 5 x 128), then the 3DHP
    # lifters' (embed 64/96, joint 320/480), which no request timed here
    # runs (weight 0)
    for label, shape, eps, calls in (
        ("context", (b, 4, 17, 128), 1e-5, 4),
        ("res", (b * 17, 5, 128), 1e-6, 4),
        ("joint", (b, 17, 640), 1e-6, 4),
        ("3DHP res", (b * 17, 5, 64), 1e-6, 0),
        ("3DHP res", (b * 17, 5, 96), 1e-6, 0),
        ("3DHP joint", (b, 17, 320), 1e-6, 0),
        ("3DHP joint", (b, 17, 480), 1e-6, 0),
    ):
        d = shape[-1]
        x = randn(*shape)
        # parameters as the served lifter holds them: made outside inference
        # mode, so that the bf16 routes cast them once
        # (fused_mlp.kernel_weight)
        with torch.inference_mode(False):
            p = (uniform(0.5, 1.5, d), uniform(-0.1, 0.1, d),
                 uniform(-1, 1, d, 2 * d) / d ** 0.5,
                 uniform(-0.1, 0.1, 2 * d),
                 uniform(-1, 1, 2 * d, d) / (2 * d) ** 0.5,
                 uniform(-0.1, 0.1, d))
        rows = x.numel() // d
        plan = fused_mlp.plan(dtype, d, 2 * d, rows)
        route = plan.route if dtype != torch.float32 else (
            f"fp32 fused, {plan.tiles[0]} rows a block"
            if len(plan.smem) == 1 else
            f"fp32 two-phase, tiles {plan.tiles[:5]} {plan.tiles[5:]}")
        cases.append((
            "K2", f"{label} D={d} ({route})", calls,
            lambda x=x, p=p, eps=eps: fused_mlp.ln_mlp_residual_kernel(
                x, *p, eps),
            lambda x=x, p=p, eps=eps: fused_mlp.ln_mlp_reference(
                x, *p, eps),
            (2 * x.numel() * x.element_size()
             + sum(t.numel() * 4 for t in p), 8 * rows * d * d),
            None,
            None,
        ))
    r, n = b * 17, 5
    for d, calls in ((128, 4), (64, 0), (96, 0)):
        xa = randn(r, n, d)
        # fp32 parameters made outside inference mode, as the served lifter
        # holds them: the bf16 route makes its operands once
        # (small_attention.kernel_operands)
        with torch.inference_mode(False):
            wa = tuple(t.float() for t in (
                randn(d, 3 * d, scale=d ** -0.5), randn(3 * d, scale=0.1),
                randn(d, d, scale=d ** -0.5), randn(d, scale=0.1)))
        # the library's layout: (out, in) weights in the call's dtype,
        # (N, R, D) tokens
        wl = [t.to(dtype) for t in wa]
        w_in, w_out = wl[0].t().contiguous(), wl[2].t().contiguous()
        xt = xa.transpose(0, 1)
        cases.append((
            "K3", f"{'' if calls else '3DHP '}R=b*17 N={n} D={d}", calls,
            lambda xa=xa, wa=wa: small_attention.small_attention_kernel(
                xa, *wa, 8),
            lambda xa=xa, wa=wa: small_attention.attention_reference(
                xa, *wa, 8),
            (2 * xa.numel() * xa.element_size()
             + sum(t.numel() * t.element_size() for t in wl),
             2 * r * n * d * 4 * d + 4 * r * n * n * d),
            lambda xt=xt, d=d, wl=wl, w_in=w_in, w_out=w_out:
                F.multi_head_attention_forward(
                    xt, xt, xt, d, 8, w_in, wl[1], None, None, False, 0.0,
                    w_out, wl[3], training=False, need_weights=False),
            None,
        ))
    for d, calls in ((640, 4), (320, 0), (480, 0)):
        qkv = randn(b, 17, 3 * d)
        q, k, v = qkv.view(b, 17, 3, 8, d // 8).permute(2, 0, 3, 1, 4)
        cases.append((
            "K4", f"{'' if calls else '3DHP '}N=17 D={d} hd={d // 8}", calls,
            lambda qkv=qkv: joint_attention.attention_middle_kernel(qkv, 8),
            lambda qkv=qkv: joint_attention.attention_middle_reference(
                qkv, 8),
            (qkv.numel() * qkv.element_size() * 4 // 3,
             4 * b * 17 * 17 * d),
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v),
            None,
        ))
    return cases


def _accumulate(res, largest, kern, calls, ms, plain_ms, bound_ms, by,
                lib_ms):
    """Add ``calls`` calls' times to a kernel's JSON numbers; the bound is
    named after the largest call's."""
    res["ms"] += calls * ms
    res["plain_ms"] += calls * plain_ms
    res["bound_ms"] += calls * bound_ms
    res["library_ms"] = (None if None in (lib_ms, res["library_ms"])
                         else res["library_ms"] + calls * lib_ms)
    if calls * bound_ms > largest.get(kern, (0.0, ""))[0]:
        largest[kern] = (calls * bound_ms, by)


def check_kernels():
    """Phase 3: returns {kernel: JSON numbers} with bf16 errors and
    per-request bf16 times (K5 at the W32 pyramid)."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")
    results = {k: dict.fromkeys(keys, 0.0) for k in ("K1", "K2", "K3",
                                                     "K4", "K5")}
    bound_by = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator().manual_seed(1234)
        name = str(dtype).removeprefix("torch.")
        with torch.inference_mode():
            for (kern, case, calls, fn, plain, work, library,
                 plan) in _kernel_cases(dtype, gen):
                out, ref = fn(), plain()
                torch.cuda.synchronize()
                err, rel = _err(out, ref)
                ms, plain_ms = _median_ms(fn), _median_ms(plain)
                lib_ms = None if library is None else _median_ms(library)
                bound_ms, by = _bound(*work, dtype)
                lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
                if plan is not None:
                    print(f"kernels: {kern} {case} {name} plan: {plan}",
                          flush=True)
                print(f"kernels: {kern} {case} {name}: max_abs_err {err:.3e} "
                      f"rel {rel:.3e} (tol {TOL[dtype]:.0e}); kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib},"
                      f" bound {bound_ms:.4f} ms ({by}: {work[0]} B, "
                      f"{_ops_total(work[1])} ops; the kernel at "
                      f"{bound_ms / ms:.1%} of it)", flush=True)
                if not rel <= TOL[dtype]:
                    raise AssertionError(
                        f"{kern} {case} {name}: rel error {rel:.3e} > "
                        f"{TOL[dtype]:.0e}")
                if dtype != torch.bfloat16:
                    continue
                res = results[kern]
                res["max_abs_err"] = max(res["max_abs_err"], err)
                if calls:
                    _accumulate(res, bound_by, kern, calls, ms, plain_ms,
                                bound_ms, by, lib_ms)
    for kern, res in results.items():
        res["bound_by"] = bound_by[kern][1]
    return results


# the float convs' epilogue at the served shapes: (case, batch, H, W, C,
# dtype, residual, relu, calls a request); the calls of one HRNet-W32
# deploy request of 512 frames at branch 0 (its 32 BasicBlock tails and
# their 32 conv1s) make the JSON line's times; the CPN stem (HRNet's conv1
# too) and the fp32 CPN's layer1 tail (training) are printed
EPILOGUE_CASES = (
    ("W32 branch 0 tail", 512, 64, 48, 32, torch.bfloat16, True, True, 32),
    ("W32 branch 0 conv1", 512, 64, 48, 32, torch.bfloat16, False, True,
     32),
    ("CPN stem", 512, 128, 96, 64, torch.bfloat16, False, True, 0),
    ("fp32 CPN layer1 tail", 256, 64, 48, 256, torch.float32, True, True,
     0),
)


def check_conv_epilogue():
    """Phase 3 (cont.): the float convs' epilogue (``ops/conv_epilogue.py``)
    against its plain version bit for bit at EPILOGUE_CASES, with median
    kernel and plain device times and the byte bound (y and the residual
    read, out written once). The plain version is the chain the kernel
    replaces (``addcmul``, add, ``relu``), so its time is also the
    library's. Returns the JSON numbers of the W32 branch-0 calls."""
    from contextaware_poseformer_tpu_torch.ops import conv_epilogue

    res = dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms"), 0.0)
    res.update(max_abs_err=0.0, bound_by="bytes")
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    gen = torch.Generator(device="cuda").manual_seed(24)
    with torch.inference_mode():
        for case, b, h, w, c, dt, has_res, relu, calls in EPILOGUE_CASES:
            def randn(*shape):
                return torch.randn(*shape, generator=gen,
                                   device="cuda").to(dt)

            y, r = randn(b, h, w, c), (randn(b, h, w, c) if has_res
                                       else None)
            scale, bias = randn(c).abs() + 0.5, randn(c) * 0.1
            out = torch.empty_like(y)

            def fn():
                return conv_epilogue.conv_epilogue_kernel(y, scale, bias, r,
                                                          relu, out)

            def plain():
                return conv_epilogue.conv_epilogue_reference(y, scale, bias,
                                                             r, relu)

            ref = plain()
            got = fn()
            torch.cuda.synchronize()
            equal = torch.equal(got.view(bits[dt]), ref.view(bits[dt]))
            del ref
            ms, plain_ms = _median_ms(fn), _median_ms(plain)
            nbytes = (3 if has_res else 2) * y.numel() * y.element_size()
            bound_ms = nbytes / PEAK_BYTES * 1e3
            p = conv_epilogue.plan(b * h * w, c, y.element_size())
            print(f"kernels: conv_epilogue {case} ({b}, {h}, {w}, {c}) "
                  f"{str(dt).removeprefix('torch.')}, residual {has_res}, "
                  f"relu {relu}: equal {equal}; kernel {ms:.4f} ms, plain "
                  f"(= library: addcmul, add, relu) {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms (bytes: {nbytes} B; the kernel at "
                  f"{bound_ms / ms:.1%} of it, {nbytes / ms / 1e9:.3f} "
                  f"TB/s); plan {p}", flush=True)
            if not equal:
                raise AssertionError(f"conv_epilogue {case} {dt}: kernel "
                                     "differs from the plain chain")
            res["ms"] += calls * ms
            res["plain_ms"] += calls * plain_ms
            res["library_ms"] += calls * plain_ms
            res["bound_ms"] += calls * bound_ms
            del y, r, out, got
    torch.cuda.empty_cache()
    return res


def _int8_conv_case(gen, b, h, w, cin, cout, k, int8_in):
    """Random K10 operands: x (int8 with its amax, or bf16), kernel_q and
    the fp32 wscale/scale/bias."""
    if int8_in:
        x = torch.randint(-127, 128, (b, h, w, cin), generator=gen,
                          dtype=torch.int8).cuda()
        amax = torch.tensor(9.5, device="cuda")
    else:  # post-ReLU, as the wide convs see their inputs (half zeros)
        x = torch.relu(torch.randn(b, h, w, cin, generator=gen) * 2).to(
            "cuda", torch.bfloat16)
        amax = None
    kq = torch.randint(-127, 128, (cout, k * k * cin), generator=gen,
                       dtype=torch.int8).cuda()
    vecs = [(torch.rand(cout, generator=gen) * 0.01 + 1e-3).cuda(),
            (torch.rand(cout, generator=gen) + 0.5).cuda(),
            (torch.randn(cout, generator=gen) * 0.1).cuda()]
    return x, kq, vecs, amax


def _layer1_blocks(gen):
    """Random pieces and calibrated scales of the four layer1 blocks."""
    def pieces(o, k):
        return (torch.randint(-127, 128, (o, k), generator=gen,
                              dtype=torch.int8).cuda(),
                (torch.rand(o, generator=gen) * 0.02 + 1e-3).cuda(),
                (torch.rand(o, generator=gen) + 0.5).cuda(),
                (torch.randn(o, generator=gen) * 0.1).cuda())

    return [{"conv1": pieces(64, 64 if b == 0 else 256),
             "conv2": pieces(64, 576), "conv3": pieces(256, 64),
             "downsample": pieces(256, 64) if b == 0 else None,
             "t1": torch.tensor(60.0 + b, device="cuda"),
             "t2": torch.tensor(80.0 + b, device="cuda"),
             "out": torch.tensor(45.0 + b, device="cuda")} for b in range(4)]


def _exact(out, ref):
    """(share of equal elements, max abs error)."""
    eq = (out == ref).float().mean().item()
    return eq, (out.float() - ref.float()).abs().max().item()


def check_int8_kernels(card):
    """Phase 6a: K10 at the deploy graph's shapes and K9 on the stem
    output, batch BATCH, W32 and W48, against their plain versions (equal
    bit for bit). Returns {kernel: JSON numbers}, times per W32 request."""
    from contextaware_poseformer_tpu_torch.ops import int8_conv, layer1_chain

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms")
    results = {k: {**dict.fromkeys(keys, 0.0), "library_ms": None}
               for k in ("K9", "K10")}
    b = BATCH
    largest = 0.0
    for width in (32, 48):
        gen = torch.Generator().manual_seed(width)
        for name, h, w, cin, cout, k, stride, int8_in, calls in K10_SHAPES:
            # channel counts: transition1 reads layer1's 256; the rest are
            # multiples of the branch width C
            cin = cin if name.startswith("transition1") else cin * width
            cout = cout * width
            x, kq, vecs, amax = _int8_conv_case(gen, b, h, w, cin, cout, k,
                                                int8_in)
            with torch.inference_mode():
                def fn():
                    return int8_conv.int8_conv(x, kq, *vecs, amax, stride,
                                               True)

                def plain():
                    return int8_conv.int8_conv_reference(x, kq, *vecs, amax,
                                                         stride, True)

                out, ref = fn(), plain()
                torch.cuda.synchronize()
                eq, err = _exact(out, ref)
                ms, plain_ms = _median_ms(fn), _median_ms(plain)
            ho, wo = out.shape[1:3]
            m = b * ho * wo
            work = (x.numel() * x.element_size() + kq.numel()
                    + 3 * 4 * cout + out.numel() * 2,
                    2 * m * cout * kq.shape[1])
            bound_ms, by = _bound(*work, torch.int8)
            lib = "no single call"
            if k == 1:  # the int32 product alone (information only)
                a2 = torch.randint(-127, 128, (m, cin), generator=gen,
                                   dtype=torch.int8).cuda()
                bt = kq.t()
                lib = (f"torch._int_mm {_median_ms(lambda: torch._int_mm(a2, bt)):.4f}"
                       " ms (int32 product only)")
            print(f"int8: K10 W{width} {name} {h}x{w} {cin}->{cout} k{k} "
                  f"s{stride} ({'int8' if int8_in else 'bf16'} in): equal "
                  f"{eq:.6f}, max_abs_err {err:.3e}; kernel {ms:.4f} ms, plain"
                  f" {plain_ms:.4f} ms, library {lib}, bound {bound_ms:.4f} "
                  f"ms ({by}: {work[0]} B, {work[1]} ops), {calls} a "
                  f"request ({card})", flush=True)
            if eq != 1.0:
                raise AssertionError(f"K10 W{width} {name}: equal share "
                                     f"{eq}, max abs error {err}")
            del x, kq, vecs, out, ref
            if width == 32:  # the request whose times the JSON line holds
                res = results["K10"]
                res["ms"] += calls * ms
                res["plain_ms"] += calls * plain_ms
                res["bound_ms"] += calls * bound_ms
                if calls * bound_ms > largest:  # named after its largest
                    largest, res["bound_by"] = calls * bound_ms, by
        x = (torch.randn(b, 64, 48, 64, generator=gen) * 2).to(
            "cuda", torch.bfloat16)
        blocks = _layer1_blocks(gen)
        amax = torch.tensor(6.0, device="cuda")
        with torch.inference_mode():
            def fn():
                return layer1_chain.layer1_chain_kernel(x, amax, blocks)

            def plain():
                return layer1_chain.layer1_chain_reference(x, amax, blocks)

            def chain():
                return layer1_chain.layer1_int8_chain(x, amax, blocks)

            out, ref, via = fn(), plain(), chain()
            torch.cuda.synchronize()
            eq, err = _exact(out, ref)
            eq_chain, _ = _exact(out, via)
            ms, plain_ms, chain_ms = (_median_ms(fn), _median_ms(plain),
                                      _median_ms(chain))
        weights = 0
        for blk in blocks:
            for conv in ("conv1", "conv2", "conv3", "downsample"):
                if blk[conv] is not None:
                    kq = blk[conv][0]
                    weights += kq.numel() + 3 * 4 * kq.shape[0]
        pixels = b * 64 * 48
        work = (x.numel() * 2 + weights + out.numel(),
                2 * pixels * (64 * 64 + 3 * 256 * 64 + 4 * 576 * 64
                              + 4 * 64 * 256 + 256 * 64))
        bound_ms, by = _bound(*work, torch.int8)
        sched = layer1_chain.plan(b, 64, 48, layer1_chain.EXPANSION,
                                  layer1_chain._sms(x.device))
        print(f"int8: K9 (W{width} run) {b}x64x48x64 bf16 -> int8 x256, "
              f"strips of {sched.strip_rows} rows, {sched.strips} strips on "
              f"a grid of {sched.grid} blocks (weights staged once a "
              f"block), ring depth {sched.depth}: "
              f"equal {eq:.6f} (plain), {eq_chain:.6f} (K10 chain on the "
              f"card), max_abs_err {err:.0f}, saturated "
              f"{(ref.abs() == 127).float().mean().item():.3f}; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, K10 chain "
              f"{chain_ms:.4f} ms, library no single call, bound "
              f"{bound_ms:.4f} ms ({by}: {work[0]} B, {work[1]} ops; {card})",
              flush=True)
        if eq != 1.0 or eq_chain != 1.0:
            raise AssertionError(f"K9: equal share {eq} (plain), {eq_chain} "
                                 "(K10 chain)")
        if width == 32:
            results["K9"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=by)
        del x, blocks, out, ref, via
    torch.cuda.empty_cache()
    return results


def _k10_signature(x, kq, stride, relu, residual, out_amax, amax,
                   dtype=torch.bfloat16):
    """A K10 call's shape and variant (``dtype``: its epilogue's)."""
    short = {torch.bfloat16: "bf16", torch.float32: "fp32"}
    if x.dtype == torch.int8:
        route = "int8 in"
    else:
        route = (f"{short[x.dtype]} in, "
                 + ("dynamic" if amax is None else "calibrated"))
    res = ("" if residual is None
           else f", {str(residual.dtype).removeprefix('torch.')} residual")
    out = "int8 out" if out_amax is not None else f"{short[dtype]} out"
    k = math.isqrt(kq.shape[1] // x.shape[-1])
    return (f"{x.shape[1]}x{x.shape[2]} {x.shape[-1]}->{kq.shape[0]} k{k} "
            f"s{stride} ({route}{res}, {'ReLU, ' if relu else ''}{out})")


def _record_k10(model, req, seen, stream=None):
    """Serve one request with K10's wrapper recording each distinct shape
    and variant: {signature: [calls, the first call's arguments]}; with
    ``stream`` (a list), the CPN stream's quantizes too, each call of
    ``cpn.quant`` as ("scale", x, amax) and of
    ``cpn.quant_max_pool_3x3_s2`` as ("pool", x, amax), tensors cloned."""
    from contextaware_poseformer_tpu_torch import serve
    from contextaware_poseformer_tpu_torch.models import cpn
    from contextaware_poseformer_tpu_torch.ops import int8_conv

    real = int8_conv.int8_conv_kernel
    patched = []
    for attr, kind in (("quant", "scale"), ("quant_max_pool_3x3_s2", "pool")):
        if stream is None:
            break
        fn = getattr(cpn, attr)

        def run(x, amax, impl="auto", fn=fn, kind=kind):
            stream.append((kind, x.clone(), amax.clone()))
            return fn(x, amax, impl)

        patched.append((attr, fn))
        setattr(cpn, attr, run)

    def record(x, kq, ws, sc, bi, amax, stride, relu, dtype=torch.bfloat16,
               residual=None, res_amax=None, out_amax=None):
        key = _k10_signature(x, kq, stride, relu, residual, out_amax, amax,
                             dtype)
        if key in seen:
            seen[key][0] += 1
        else:
            keep = [None if t is None else t.clone()
                    for t in (x, amax, residual, res_amax, out_amax)]
            seen[key] = [1, (keep[0], kq, ws, sc, bi, keep[1], stride, relu,
                             dtype, *keep[2:])]
        return real(x, kq, ws, sc, bi, amax, stride, relu, dtype, residual,
                    res_amax, out_amax)

    int8_conv.int8_conv_kernel = record
    try:
        serve.lift(model, *req)
        torch.cuda.synchronize()
    finally:
        int8_conv.int8_conv_kernel = real
        for attr, fn in patched:
            setattr(cpn, attr, fn)


def _k1_int8_projection(card):
    """K1 on the CPN deploy pyramid as int8 maps with the lifter's
    in-kernel projection, the border 272-point call, against its plain
    version, run as the served lifter runs it: under inference mode, W a
    parameter made outside it (its bf16 W^T cast once) and each level's
    dequant scale a one-element tensor on the card. Returns the max abs
    error."""
    from contextaware_poseformer_tpu_torch.ops import deformable

    gen = torch.Generator().manual_seed(9)
    maps = [torch.randint(-127, 128, (BATCH, h, w, 256), generator=gen,
                          dtype=torch.int8).cuda() for h, w in LEVELS]
    pts = (torch.rand(BATCH, len(LEVELS), 17, 16, 2, generator=gen) * 3
           - 1.5).cuda()
    with torch.inference_mode(False):
        projs = [torch.nn.Parameter(((torch.rand(
            256, HEAD_DIM, generator=gen) * 2 - 1) / 16).cuda())
            for _ in LEVELS]
    scales = [torch.tensor(0.01 + 0.01 * l, device="cuda")
              for l in range(len(LEVELS))]
    biases = [(torch.rand(HEAD_DIM, generator=gen) * 0.2 - 0.1).cuda()
              for _ in LEVELS]

    def fn():
        with torch.inference_mode():
            return deformable.sample_points_multi(maps, pts, "border", True,
                                                  projs, biases, scales)

    def plain():
        with torch.inference_mode():
            return deformable.sample_points_multi_reference(
                maps, pts, "border", True, projs, biases, scales)

    def gather():  # the same call without the projection: the gather alone
        with torch.inference_mode():
            return deformable.sample_points_multi(maps, pts, "border", True)

    out, ref = fn(), plain()
    err, rel = _err(out, ref)
    ms, plain_ms = _median_ms(fn), _median_ms(plain)
    gather_ms = _median_ms(gather)
    # the blend's operations at the fp32 rate, the projection's at the bf16
    # tensor-core rate; beside it both at the fp32 rate, the yardstick of a
    # projection on CUDA cores
    work = _sampler_work(maps, pts, projs, True, split=True)
    bound_ms, by = _bound(*work, None)
    fp32_ms, _ = _bound(work[0], _ops_total(work[1]), torch.float32)
    tol = TOL[torch.bfloat16]
    print(f"cpn_int8: K1 int8 maps border+proj P=272 -> bfloat16: "
          f"max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:.0e}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({by}: {work[0]} B, {work[1][torch.float32]} fp32 ops, "
          f"{work[1][torch.bfloat16]} bf16 ops; all at the fp32 rate "
          f"{fp32_ms:.4f} ms); the gather alone (no projection, bf16 "
          f"samples of 256 channels) {gather_ms:.4f} ms; 4 a request "
          f"({card})", flush=True)
    if not rel <= tol:
        raise AssertionError(f"K1 int8 projection: rel error {rel:.3e}")
    return err


def _k10q_plain(x, a, form, clamp):
    """K10q's plain version with its amax given (the dynamic route's
    stands for max|x|): the scale form's ``quant_reference``, or the step
    form's clip(round(x / step)) in fp32."""
    from contextaware_poseformer_tpu_torch.ops import int8_conv

    if form == "scale":
        return int8_conv.quant_reference(x, a)
    step = int8_conv.dequant_step(a, clamp=clamp)
    return torch.clamp(torch.round(x.float() / step), -127, 127).to(
        torch.int8)


def _k10q_every_pattern(card):
    """K10q in each of its forms on all 65,536 bf16 patterns (NaN, +-inf
    and subnormals included) at each amax of K10Q_AMAXES, and the dynamic
    route on max|x| of the finite patterns, against its plain version bit
    for bit (the step form's dynamic route with amax standing for
    max|x|)."""
    from contextaware_poseformer_tpu_torch.ops import int8_conv

    allp = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).cuda()
    cases = 0
    for label, form, clamp in K10Q_FORMS:
        for amax in K10Q_AMAXES:
            a = torch.tensor(amax, dtype=torch.float32, device="cuda")
            got = int8_conv.quantize_kernel(allp, a, clamp, form=form)
            eq, _ = _exact(got, _k10q_plain(allp, a, form, clamp))
            if eq != 1.0:
                raise AssertionError(f"K10q {label} amax {amax}: equal "
                                     f"share {eq} on the bf16 patterns")
            cases += 1
    finite = allp[torch.isfinite(allp.float())]
    finite = finite[:finite.numel() // 16 * 16]
    got = int8_conv.quantize_kernel(finite, int8_conv.absmax(finite), False)
    eq, _ = _exact(got, int8_conv.quantize_reference(finite, None))
    if eq != 1.0:
        raise AssertionError(f"K10q dynamic on max|x|: equal share {eq}")
    print(f"cpn_int8: K10q on all 65,536 bf16 patterns, the step form "
          f"(dynamic, calibrated) and the scale form at {len(K10Q_AMAXES)} "
          f"amax values each ({', '.join(f'{a:g}' for a in K10Q_AMAXES)}), "
          f"and the dynamic route on max|x| of the finite patterns: "
          f"{cases + 1} cases, each equal to its plain version bit for bit "
          f"({card})", flush=True)


def _stream_quant_case(kind, x, a, card, phase="cpn_int8"):
    """One recorded call of the CPN stream's quantizes on the card: K10q's
    scale form ("scale") or K10p ("pool") against its plain version (bit
    for bit), with median kernel and plain ms and the bound (bytes: x read
    once, the int8 output written once; operations at the fp32 rate: K10q
    3 a value, K10p 8 compares and 3 quantize steps an output). Returns
    (max abs error, ms, plain ms, (bound ms, by))."""
    from contextaware_poseformer_tpu_torch.models import backbone_common
    from contextaware_poseformer_tpu_torch.ops import int8_conv

    if kind == "scale":
        def fn():
            return int8_conv.quantize_kernel(x, a, True, form="scale")

        def plain():
            return int8_conv.quant_reference(x, a)
    else:
        def fn():
            return int8_conv.quant_max_pool_kernel(x, a)

        def plain():
            return int8_conv.quant_max_pool_3x3_s2_reference(x, a)

        def before():  # the two-pass route: quantize, then pool in bf16
            return backbone_common.max_pool_3x3_s2(
                int8_conv.quant_reference(x, a))
    out, ref = fn(), plain()
    torch.cuda.synchronize()
    eq, err = _exact(out, ref)
    ms, plain_ms = _median_ms(fn), _median_ms(plain)
    ops = 3 * x.numel() if kind == "scale" else 11 * out.numel()
    bound_ms, by = _bound(x.numel() * x.element_size() + out.numel(), ops,
                          torch.float32)
    what = ("K10q scale form" if kind == "scale"
            else "K10p quantize + 3x3/s2 max-pool")
    note = ""
    if kind == "pool":
        old_eq, _ = _exact(before(), ref)
        note = (f"; the two-pass route (quantize, then pool in bf16) "
                f"{_median_ms(before):.4f} ms, equal {old_eq:.6f}")
        eq = min(eq, old_eq)
    print(f"{phase}: {what} {tuple(x.shape)} {x.dtype} -> "
          f"{tuple(out.shape)} int8: "
          f"equal {eq:.6f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({by}){note} ({card})", flush=True)
    if eq != 1.0:
        raise AssertionError(f"{what} {tuple(x.shape)}: equal share {eq}")
    return err, ms, plain_ms, (bound_ms, by)


def _recorded_request(seen, stream, per_request, what):
    """Check a recorded request's calls against its counts: K10's calls,
    K10q's (K10's float inputs and the stream's scale-form quantizes) and
    K10p's. Returns K10's calls and those with a float input."""
    calls = sum(n for n, _ in seen.values())
    if calls != per_request["K10"]:
        raise AssertionError(f"{what}: recorded {calls} K10 calls a request")
    step_calls = sum(n for n, args in seen.values()
                     if args[0].dtype != torch.int8)
    kinds = [k for k, _, _ in stream]
    if (kinds.count("pool") != per_request["K10p"]
            or step_calls + kinds.count("scale") != per_request["K10q"]):
        raise AssertionError(f"{what}: recorded {step_calls} float K10 "
                             f"inputs and the stream's quantizes {kinds} a "
                             "request")
    return calls, step_calls


def _k10_calls_vs_plain(seen, phase, card):
    """K10 on each recorded shape and variant (``_record_k10``) against its
    plain version, bit for bit, with median kernel and plain ms and the
    bound, a float input's quantize pass (K10q's step form) apart. Returns
    (K10's numbers, K10q's) summed over a request's calls."""
    from contextaware_poseformer_tpu_torch.ops import int8_conv

    res = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "library_ms": None}
    quant = {**res, "bound_by": "bytes"}
    largest = 0.0
    with torch.inference_mode():
        for key, (n, args) in seen.items():
            eq, err, ms, plain_ms, (bound_ms, by), q = _k10_entry_ms(args)
            out_shape = _k10_out_shape(args)
            m = out_shape[0] * out_shape[1] * out_shape[2]
            kq, dt, r = args[1], args[8], args[9]
            tile = int8_conv.plan(m, kq.shape[0], kq.shape[1], dt,
                                  None if r is None else r.dtype)
            note = ""
            if q is not None:
                qeq, q_ms, q_plain, (q_bound, q_by) = q
                note = (f"; quantize pass equal {qeq:.6f}, {q_ms:.4f} ms, "
                        f"plain {q_plain:.4f} ms, bound {q_bound:.4f} ms "
                        f"({q_by})")
                if qeq != 1.0:
                    raise AssertionError(f"K10q {key}: equal share {qeq}")
                quant["ms"] += n * q_ms
                quant["plain_ms"] += n * q_plain
                quant["bound_ms"] += n * q_bound
                quant["bound_by"] = q_by
            print(f"{phase}: K10 {key}: equal {eq:.6f}, max_abs_err "
                  f"{err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({by}), tile "
                  f"64x{tile}, {n} a "
                  f"request{note} ({card})", flush=True)
            if eq != 1.0:
                raise AssertionError(f"K10 {key}: equal share {eq}")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["ms"] += n * ms
            res["plain_ms"] += n * plain_ms
            res["bound_ms"] += n * bound_ms
            if n * bound_ms > largest:
                largest, res["bound_by"] = n * bound_ms, by
    return res, quant


def _stream_quants_vs_plain(stream, quant, phase, card):
    """The recorded stream quantizes (``_record_k10``) against their plain
    versions (``_stream_quant_case``): K10q's scale form added into
    ``quant``; returns K10p's numbers."""
    pool = None
    with torch.inference_mode():
        for kind, x, a in stream:
            err, ms, plain_ms, (bound_ms, by) = _stream_quant_case(
                kind, x, a, card, phase)
            if kind == "pool":
                pool = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": by,
                        "library_ms": None}
                continue
            quant["max_abs_err"] = max(quant["max_abs_err"], err)
            quant["ms"] += ms
            quant["plain_ms"] += plain_ms
            quant["bound_ms"] += bound_ms
    return pool


def check_cpn_int8(results, card):
    """Phase 7: the CPN int8 deploy graph. K10 at every distinct shape and
    variant of the stream (recorded from one served request at batch BATCH,
    on that request's own tensors) against its plain version, bit for bit,
    with median kernel and plain times and the bound; K10q on every bf16
    pattern; the stream's own quantizes (K10q's scale form, K10p), recorded
    from the same request, the same way; K1 projecting int8 maps; then
    ``serve.deploy_config("h36m_cpn")`` served as the HRNet deploy graphs
    are. K10's, K10q's and K10p's JSON times become this request's.
    Returns the served requests' launch counts."""
    seen, stream = {}, []
    launches = check_serving(
        "h36m_cpn", REQUESTS, card, int8=True,
        inspect=lambda m, r: _record_k10(m, r, seen, stream))
    calls, step_calls = _recorded_request(seen, stream,
                                          INT8_PER_REQUEST["cpn"], "cpn_int8")
    res, quant = _k10_calls_vs_plain(seen, "cpn_int8", card)
    print(f"cpn_int8: K10 over a request's {calls} calls ({len(seen)} "
          f"shapes and variants): kernel {res['ms']:.4f} ms, plain "
          f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms; its "
          f"quantize pass (K10q's step form, {step_calls} calls) "
          f"{quant['ms']:.4f} ms, plain {quant['plain_ms']:.4f} ms, bound "
          f"{quant['bound_ms']:.4f} ms ({card})", flush=True)
    seen.clear()
    _k10q_every_pattern(card)
    pool = _stream_quants_vs_plain(stream, quant, "cpn_int8", card)
    stream.clear()
    print(f"cpn_int8: a request's quantizes: K10q "
          f"{INT8_PER_REQUEST['cpn']['K10q']} calls (step and scale forms) "
          f"{quant['ms']:.4f} ms, plain {quant['plain_ms']:.4f} ms, bound "
          f"{quant['bound_ms']:.4f} ms; K10p {pool['ms']:.4f} ms, plain "
          f"{pool['plain_ms']:.4f} ms, bound {pool['bound_ms']:.4f} ms "
          f"({card})", flush=True)
    results["K10"] = res
    results["K10q"] = quant
    results["K10p"] = pool
    err = _k1_int8_projection(card)
    results["K1"]["max_abs_err"] = max(results["K1"]["max_abs_err"], err)
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _knob_calls(calls):
    """While the block runs, append to ``calls`` each K10s and K10u launch
    as ("K10s" | "K10u", its arguments cloned)."""
    from contextaware_poseformer_tpu_torch.ops import int8_conv

    saved = [(k, n, getattr(int8_conv, n)) for k, n in (
        ("K10s", "stem_conv_kernel"), ("K10u", "topdown_kernel"))]
    for k, n, fn in saved:
        def spy(*args, _fn=fn, _k=k):
            calls.append((_k, tuple(a.clone() if isinstance(a, torch.Tensor)
                                    else a for a in args)))
            return _fn(*args)
        setattr(int8_conv, n, spy)
    try:
        yield calls
    finally:
        for _, n, fn in saved:
            setattr(int8_conv, n, fn)


def _k10s_case(args, conv1, card, timed):
    """K10s on one recorded call (frames, kernel_q, wscale, scale, bias,
    bias map, dtype) against its plain version, bit for bit; then on a
    batch-1 all-0 frame, an all-255 frame and the first frame alone. With
    ``timed``: median kernel ms with ``kernel_q`` a tensor with a version
    counter, as the served CPN holds it (the call recorded under
    ``torch.inference_mode()`` would make its k-steps every call), plain
    and library ms (the float stem it replaces: ``normalize_images`` +
    ``conv1``'s cuDNN conv, ``addcmul`` and ReLU) and the bound (the
    frames read once, the output and the bias map written and read once;
    2 x 147 int8 operations an output). Returns (max abs error, numbers
    or None)."""
    from contextaware_poseformer_tpu_torch.data import augment
    from contextaware_poseformer_tpu_torch.ops import int8_conv

    frames, rest = args[0], args[1:]
    one = frames[:1]
    cases = {"served": frames, "all-0": torch.zeros_like(one),
             "all-255": torch.full_like(one, 255), "batch 1": one}
    worst, shares = 0.0, {}
    for name, f in cases.items():
        out = int8_conv.stem_conv_kernel(f, *rest)
        ref = int8_conv.stem_conv_reference(f, *rest)
        torch.cuda.synchronize()
        shares[name], err = _exact(out, ref)
        worst = max(worst, err)
    dtype = rest[-1]
    label = (f"K10s {tuple(frames.shape)} uint8 -> {tuple(out.shape[1:])} "
             f"{str(dtype).removeprefix('torch.')}")
    if any(v != 1.0 for v in shares.values()):
        raise AssertionError(f"{label}: equal shares {shares}")
    if not timed:
        print(f"cpn_knobs: {label}: equal bit for bit (served frames, "
              f"all-0, all-255, batch 1) ({card})", flush=True)
        return worst, None
    served = (rest[0].clone(), *rest[1:])  # a tensor with a version counter
    ms = _median_ms(lambda: int8_conv.stem_conv_kernel(frames, *served))
    plain_ms = _median_ms(lambda: int8_conv.stem_conv_reference(frames,
                                                                *rest))
    with torch.inference_mode():
        lib_ms = _median_ms(lambda: conv1(augment.normalize_images(
            frames, "cpn", dtype)))
    ref = int8_conv.stem_conv_reference(frames, *rest)
    elem = ref.element_size()
    nbytes = frames.numel() + ref.numel() * elem + rest[-2].numel() * elem
    ops = 2 * ref.numel() * rest[0].shape[1]
    bound_ms, by = _bound(nbytes, ops, torch.int8)
    print(f"cpn_knobs: {label}: equal bit for bit (served frames, all-0, "
          f"all-255, batch 1); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library (normalize + cuDNN conv + addcmul + ReLU) {lib_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({by}: {nbytes} B, {ops} int8 ops), "
          f"{bound_ms / ms:.1%} of the bound ({card})", flush=True)
    return worst, {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": by,
                   "library_ms": lib_ms}


def _k10u_case(args, card, timed):
    """K10u on one recorded call (q, ua, lat, dtype) against its plain
    version, bit for bit; with ``timed`` the median kernel, plain and
    library ms (``F.interpolate`` of the dequantized map, the multiply and
    the add) and the bound (q and lat read once, the output written once).
    Returns (max abs error, (ms, plain ms, library ms, bound ms) or
    None)."""
    from contextaware_poseformer_tpu_torch.ops import int8_conv

    q, ua, lat, dtype = args
    out = int8_conv.topdown_kernel(*args)
    ref = int8_conv.topdown_reference(*args)
    torch.cuda.synchronize()
    eq, err = _exact(out, ref)
    label = (f"K10u {tuple(q.shape)} int8 -> {tuple(out.shape)} "
             f"{str(dtype).removeprefix('torch.')}")
    if eq != 1.0:
        raise AssertionError(f"{label}: equal share {eq}")
    if not timed:
        print(f"cpn_knobs: {label}: equal {eq:.6f} ({card})", flush=True)
        return err, None
    step = int8_conv.dequant_step(ua, clamp=True).to(dtype)

    def library():
        up = F.interpolate((q.to(dtype) * step).permute(0, 3, 1, 2),
                           scale_factor=2, mode="bilinear",
                           align_corners=True)
        return lat + up.permute(0, 2, 3, 1)

    ms = _median_ms(lambda: int8_conv.topdown_kernel(*args))
    plain_ms = _median_ms(lambda: int8_conv.topdown_reference(*args))
    lib_ms = _median_ms(library)
    nbytes = q.numel() + 2 * lat.numel() * lat.element_size()
    bound_ms, _ = _bound(nbytes, 0, torch.float32)
    print(f"cpn_knobs: {label}: equal {eq:.6f}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library (interpolate + mul + add) "
          f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes: {nbytes} B), "
          f"{bound_ms / ms:.1%} of the bound ({card})", flush=True)
    return err, (ms, plain_ms, lib_ms, bound_ms)


# the edge shapes K10s and K10u are held to beside the served ones: K10s
# (batch, H, W) at an odd height, the narrowest width and one-row frames;
# K10u (h, w, C) at a 1x1 source, odd sizes and C not a multiple of 16,
# each at these batches
STEM_EDGES = ((3, 37, 64), (2, 16, 32), (2, 1, 64), (1, 1, 32))
TOPDOWN_EDGES = ((1, 1, 8), (5, 3, 24), (2, 7, 16))
TOPDOWN_EDGE_BATCHES = (1, 64)


def stem_operands(gen, dtype, b, h, w):
    """K10s's operands on the card for ``b`` random uint8 frames of h x w:
    a random conv1 (7x7 weights, BN scale and bias), its int8 weights,
    scales and bias, and its bias map (``raw`` on the offset image, as the
    CPN makes it). Returns (frames, (kernel_q, wscale, scale, bias,
    bias_map, dtype))."""
    from contextaware_poseformer_tpu_torch.data import augment
    from contextaware_poseformer_tpu_torch.models import backbone_common

    conv = backbone_common.ConvBN(3, 64, 7, 2, True, dtype, device="cuda",
                                  int8=True)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(64, 3, 7, 7, generator=gen) * 0.1)
        conv.scale.copy_(torch.rand(64, generator=gen) + 0.5)
        conv.bias.copy_(torch.randn(64, generator=gen) * 0.1)
    vecs = tuple(t.detach().clone() for t in conv.packed())
    off = (128.0 - torch.tensor(augment.CPN_PIXEL_MEAN)) / 255.0
    with torch.inference_mode():
        bias_map = conv(off.cuda().expand(1, h, w, 3), raw=True)
    frames = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                           generator=gen).cuda()
    return frames, (*vecs, bias_map, dtype)


def _knob_edge_shapes(card):
    """K10s and K10u at STEM_EDGES and TOPDOWN_EDGES, bf16 and fp32, equal
    to their plain versions bit for bit, one launch a call (``stem_operands``
    with random and all-255 frames; random s8 maps and laterals)."""
    from contextaware_poseformer_tpu_torch.ops import int8_conv

    gen = torch.Generator().manual_seed(18)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for b, h, w in STEM_EDGES:
            frames, rest = stem_operands(gen, dtype, b, h, w)
            for f in (frames, torch.full_like(frames, 255)):
                before = int8_conv.launches_stem
                out = int8_conv.stem_conv(f, *rest)
                ref = int8_conv.stem_conv_reference(f, *rest)
                eq, _ = _exact(out, ref)
                if eq != 1.0 or int8_conv.launches_stem != before + 1:
                    raise AssertionError(f"K10s edge {(b, h, w)} {name}: "
                                         f"equal share {eq}")
            print(f"cpn_knobs: K10s edge {(b, h, w)} {name}: equal bit for "
                  f"bit (random and all-255 frames), one launch a call "
                  f"({card})", flush=True)
        for h, w, c in TOPDOWN_EDGES:
            for b in TOPDOWN_EDGE_BATCHES:
                q = torch.randint(-127, 128, (b, h, w, c), dtype=torch.int8,
                                  generator=gen).cuda()
                lat = torch.randn(b, 2 * h, 2 * w, c, generator=gen).to(
                    "cuda", dtype)
                ua = torch.tensor(5.1, device="cuda")
                before = int8_conv.launches_topdown
                out = int8_conv.topdown(q, ua, lat, dtype)
                eq, _ = _exact(out, int8_conv.topdown_reference(q, ua, lat,
                                                                dtype))
                if eq != 1.0 or int8_conv.launches_topdown != before + 1:
                    raise AssertionError(f"K10u edge {(b, h, w, c)} {name}:"
                                         f" equal share {eq}")
            print(f"cpn_knobs: K10u edge (h, w, C) {(h, w, c)} at batch "
                  f"{' and '.join(map(str, TOPDOWN_EDGE_BATCHES))} {name}: "
                  f"equal bit for bit, one launch a call ({card})",
                  flush=True)


def _knob_graph(label, knobs, dtype, card):
    """Build ``deploy_config("h36m_cpn")`` with ``knobs`` (random weights
    from seed 0) with its backbone in ``dtype``, prepared by
    ``serve.prepare`` on one seeded batch of BATCH frames. Returns (cfg,
    model, request, per-request launches)."""
    from contextaware_poseformer_tpu_torch import serve

    cfg = serve.deploy_config("h36m_cpn")
    cfg = replace(cfg, model=replace(cfg.model, backbone=replace(
        cfg.model.backbone, **knobs)))
    per_request = {**PER_REQUEST["h36m_cpn"], **INT8_PER_REQUEST["cpn"]}
    for knob in knobs:
        per_request.update(KNOB_PER_REQUEST[knob])
    t0 = time.perf_counter()
    model = serve.build_model(cfg.model, dtype, "cuda",
                              generator=torch.Generator().manual_seed(0))
    h, w = cfg.model.image_shape
    calib = torch.randint(0, 256, (BATCH, h, w, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(1))
    serve.prepare(model, [calib.cuda()])
    gen = torch.Generator().manual_seed(0)
    req = (torch.randint(0, 256, (BATCH, h, w, 3), dtype=torch.uint8,
                         generator=gen).cuda(),
           (torch.rand(BATCH, 17, 2, generator=gen) * 2 - 1).cuda(),
           (torch.rand(BATCH, 17, 2, generator=gen) * w).cuda())
    torch.cuda.synchronize()
    print(f"cpn_knobs: {label}: built and prepared in "
          f"{time.perf_counter() - t0:.1f} s (backbone "
          f"{str(dtype).removeprefix('torch.')}, "
          f"{', '.join(knobs) or 'no knob'}; launches a request "
          f"{per_request})", flush=True)
    return cfg, model, req, per_request


def check_cpn_knobs(results, card):
    """Phase 7c: the CPN deploy graph's two serving knobs,
    ``cpn_fold_normalize`` (uint8 frames into the int8 stem K10s) and
    ``cpn_int8_topdown`` (the s8 top-down hops K10u), at batch BATCH and
    full width (random weights from seed 0, each graph prepared on one
    seeded batch), beside the main path, in KNOB_GRAPHS. For each graph:
    one request records its K10s and K10u calls (and, for the top-down,
    K10's calls) on which each kernel must equal its plain version bit for
    bit: K10s also on all-0, all-255 and batch-1 frames, K10 in its
    requantizing variant without ReLU or residual (the up-convs); then
    KNOB_REQUESTS requests with every count set to 0 before them, each with
    its per-request launches; the backbone maps and scales bit-equal to the
    same graph's with ``int8_impl="plain"``, the poses within SLICE_REL_RMS
    of it; host ms, frames/s, busy, idle and the K10s/K10u share of each
    graph (information), and each graph's poses against the main path's;
    K10s and K10u at their edge shapes (``_knob_edge_shapes``). K10s and
    K10u are timed on the graphs of KNOB_TIMED_GRAPHS; their JSON numbers
    are the bf16 fold+topdown request's. Returns the counted requests'
    launches."""
    from contextaware_poseformer_tpu_torch import serve

    launches = dict.fromkeys(_counters(), 0)
    mains, timed = None, {}
    for label, knobs, dtype in KNOB_GRAPHS:
        cfg, model, req, per_request = _knob_graph(label, knobs, dtype,
                                                   card)
        calls, seen = [], {}
        with _knob_calls(calls):
            if "cpn_int8_topdown" in knobs:
                _record_k10(model, req, seen)
            else:
                serve.lift(model, *req)
                torch.cuda.synchronize()
        kinds = [k for k, _ in calls]
        want = {k: per_request.get(k, 0) for k in ("K10s", "K10u")}
        if {k: kinds.count(k) for k in want} != want:
            raise AssertionError(f"cpn_knobs {label}: recorded {kinds}, "
                                 f"expected {want}")
        timed_here = label in KNOB_TIMED_GRAPHS
        stem = hop = None
        for k, args in calls:
            if k == "K10s":
                err, stem = _k10s_case(args, model.backbone.resnet_conv1,
                                       card, timed_here)
            else:
                err, h = _k10u_case(args, card, timed_here)
                if h is not None:
                    hop = [a + b for a, b in zip(hop or (0,) * 4, h)]
            name = "K10s" if k == "K10s" else "K10u"
            results.setdefault(name, {"max_abs_err": 0.0})
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"], err)
        # the JSON line's numbers: the bf16 graph's
        if stem is not None and dtype == torch.bfloat16:
            results["K10s"].update(stem)
        if hop is not None:
            if dtype == torch.bfloat16:
                results["K10u"].update(
                    ms=hop[0], plain_ms=hop[1], library_ms=hop[2],
                    bound_ms=hop[3], bound_by="bytes")
            print(f"cpn_knobs: {label}: K10u over a request's 3 hops: "
                  f"kernel {hop[0]:.4f} ms, plain {hop[1]:.4f} ms, library "
                  f"{hop[2]:.4f} ms, bound {hop[3]:.4f} ms, "
                  f"{hop[3] / hop[0]:.1%} of the bound ({card})",
                  flush=True)
        upconvs = {key: v for key, v in seen.items()
                   if "int8 out" in key and "ReLU" not in key
                   and "residual" not in key}
        if "cpn_int8_topdown" in knobs and dtype == torch.bfloat16:
            if sum(n for n, _ in upconvs.values()) != 3:
                raise AssertionError(f"cpn_knobs {label}: up-convs {upconvs}")
            with torch.inference_mode():
                for key, (n, args) in upconvs.items():
                    eq, err, ms, plain_ms, (bound_ms, by), _ = \
                        _k10_entry_ms(args)
                    print(f"cpn_knobs: {label}: K10 {key}: equal {eq:.6f}; "
                          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                          f"bound {bound_ms:.4f} ms ({by}), {n} a request "
                          f"({card})", flush=True)
                    if eq != 1.0:
                        raise AssertionError(f"K10 {key}: equal share {eq}")
        seen.clear()

        _reset_counts()
        for i in range(KNOB_REQUESTS):
            before = _counts()
            out = serve.lift(model, *req)
            torch.cuda.synchronize()
            grew = {k: v - before[k] for k, v in _counts().items()}
            if grew != _expected(per_request):
                raise AssertionError(f"cpn_knobs {label} request {i}: "
                                     f"launches {grew}, expected "
                                     f"{per_request}")
        for k, v in _counts().items():
            launches[k] += v
        if out.shape != (BATCH, 17, 3) or not torch.isfinite(out).all():
            raise AssertionError(f"cpn_knobs {label}: bad output")
        _fp32_vs_plain(label, cfg, model, req, card, phase="cpn_knobs")
        if mains is None:
            mains = out
        else:
            print(f"cpn_knobs: {label}: poses vs the main path's (the same "
                  f"weights, each graph calibrated on the same frames): "
                  f"rel RMS {_rel_rms(out, mains):.3e} (information only; "
                  f"{card})", flush=True)
        serve.lift(model, *req)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(KNOB_TIMED):
            serve.lift(model, *req)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / KNOB_TIMED
        timed[label] = host_ms
        print(f"cpn_knobs: {label}: {host_ms:.3f} ms a request, "
              f"{BATCH * 1e3 / host_ms:.1f} frames/s (information only; "
              f"host clock over {KNOB_TIMED} requests, batch {BATCH}, "
              f"{card})", flush=True)
        _where_time_goes("cpn_knobs", label, cfg, model, req, host_ms,
                         f"batch {BATCH}, {card}")
        del model
        torch.cuda.empty_cache()
    print("cpn_knobs: host ms a request: " + ", ".join(
        f"{k} {v:.3f}" for k, v in timed.items()) + f" ({card})", flush=True)
    _knob_edge_shapes(card)
    for k in ("K10s", "K10u"):
        if "ms" not in results.get(k, {}):
            raise AssertionError(f"cpn_knobs: {k} was not timed")
    return launches


def _k10_out_shape(args):
    """The output shape (B, Ho, Wo, Cout) of a recorded K10 call."""
    from contextaware_poseformer_tpu_torch.ops import int8_conv

    x, kq, stride = args[0], args[1], args[6]
    k = math.isqrt(kq.shape[1] // x.shape[-1])
    return (x.shape[0], int8_conv.out_size(x.shape[1], k, stride),
            int8_conv.out_size(x.shape[2], k, stride), kq.shape[0])


def _k10_entry_ms(args):
    """K10 on one recorded call: (bit-equal share, max abs error, kernel ms,
    plain ms, bound (ms, by), the K10q numbers of a float input or None).
    A float input's quantize pass is timed apart and K10 on its int8
    output, the same convolution."""
    from contextaware_poseformer_tpu_torch.ops import int8_conv

    x, kq, residual, amax = args[0], args[1], args[9], args[5]

    def plain():
        return int8_conv.int8_conv_reference(*args)

    out, ref = int8_conv.int8_conv_kernel(*args), plain()
    torch.cuda.synchronize()
    eq, err = _exact(out, ref)
    timed, quant = args, None
    if x.dtype != torch.int8:
        clamp = amax is not None
        a = amax if clamp else int8_conv.absmax(x)
        xq = int8_conv.quantize_kernel(x, a, clamp)
        qeq, _ = _exact(xq, int8_conv.quantize_reference(x, amax))
        quant = (qeq,
                 _median_ms(lambda: int8_conv.quantize_kernel(x, a, clamp)),
                 _median_ms(lambda: int8_conv.quantize_reference(x, amax)),
                 _bound(x.numel() * (x.element_size() + 1), 3 * x.numel(),
                        torch.float32))
        timed = (xq, *args[1:5], a, *args[6:])
    ms = _median_ms(lambda: int8_conv.int8_conv_kernel(*timed))
    plain_ms = _median_ms(plain)
    m = out.shape[0] * out.shape[1] * out.shape[2]
    nbytes = (timed[0].numel() * timed[0].element_size() + kq.numel()
              + 3 * 4 * kq.shape[0] + out.numel() * out.element_size()
              + (0 if residual is None
                 else residual.numel() * residual.element_size()))
    bound = _bound(nbytes, 2 * m * kq.shape[0] * kq.shape[1], torch.int8)
    return eq, err, ms, plain_ms, bound, quant


def check_quantize(card):
    """Phase 8: the backbone's "static" and "c128" graphs
    (``serve.quantize_config``). Each graph of QUANT_GRAPHS is served as
    the int8 phase serves the deploy graphs (``check_serving``; a "c128"
    request before ``prepare`` equal to the prepared one), while one of its
    requests records K10's calls; QUANT_SHAPES_ONLY's graphs record one
    request. Then K10 at every distinct shape and variant recorded, on that
    request's own tensors, against its plain version bit for bit (K10q
    apart), with median kernel and plain ms and the bound; each graph's
    K10 and K10q ms a request. Returns the served requests' launches."""
    from contextaware_poseformer_tpu_torch import serve

    seen = {}  # signature -> [a call's arguments, {graph: calls a request}]

    def recorder(graph):
        def inspect(model, req):
            calls = {}
            _record_k10(model, req, calls)
            for key, (n, args) in calls.items():
                seen.setdefault(key, [args, {}])[1][graph] = n
        return inspect

    launches = [check_serving(name, n, card, inspect=recorder(
        f"{name} {mode}"), mode=mode, timed=QUANT_TIMED)
        for name, mode, n in QUANT_GRAPHS]
    for name, mode in QUANT_SHAPES_ONLY:
        cfg = serve.quantize_config(name, mode)
        model = serve.build_serving_model(
            cfg, "cuda", generator=torch.Generator().manual_seed(0))
        h, w = cfg.model.image_shape
        gen = torch.Generator().manual_seed(1)
        serve.prepare(model, [torch.randint(0, 256, (BATCH, h, w, 3),
                                            dtype=torch.uint8,
                                            generator=gen).cuda()])
        req = (torch.randint(0, 256, (BATCH, h, w, 3), dtype=torch.uint8,
                             generator=gen).cuda(),
               (torch.rand(BATCH, 17, 2, generator=gen) * 2 - 1).cuda(),
               (torch.rand(BATCH, 17, 2, generator=gen) * w).cuda())
        recorder(f"{name} {mode}")(model, req)
        del model
    graphs = [f"{n} {m}" for n, m, _ in QUANT_GRAPHS] + [
        f"{n} {m}" for n, m in QUANT_SHAPES_ONLY]
    per_graph = {g: dict.fromkeys(("ms", "plain_ms", "bound_ms", "q_ms",
                                   "q_plain", "q_bound", "calls"), 0.0)
                 for g in graphs}
    shapes = set()
    with torch.inference_mode():
        for key, (args, calls) in sorted(seen.items()):
            eq, err, ms, plain_ms, (bound_ms, by), quant = _k10_entry_ms(args)
            x, kq, stride = args[0], args[1], args[6]
            shapes.add((x.shape[-1], kq.shape[0],
                        math.isqrt(kq.shape[1] // x.shape[-1]), stride))
            note = ""
            if quant is not None:
                qeq, q_ms, q_plain, (q_bound, q_by) = quant
                note = (f"; K10q equal {qeq:.6f}, {q_ms:.4f} ms, plain "
                        f"{q_plain:.4f} ms, bound {q_bound:.4f} ms ({q_by})")
                if qeq != 1.0:
                    raise AssertionError(f"K10q {key}: equal share {qeq}")
            print(f"quantize: K10 {key}: equal {eq:.6f}, max_abs_err "
                  f"{err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({by}), a request: "
                  + ", ".join(f"{g} {n}" for g, n in calls.items())
                  + f"{note} ({card})", flush=True)
            if eq != 1.0:
                raise AssertionError(f"K10 {key}: equal share {eq}")
            for g, n in calls.items():
                res = per_graph[g]
                res["ms"] += n * ms
                res["plain_ms"] += n * plain_ms
                res["bound_ms"] += n * bound_ms
                res["calls"] += n
                if quant is not None:
                    res["q_ms"] += n * quant[1]
                    res["q_plain"] += n * quant[2]
                    res["q_bound"] += n * quant[3][0]
    seen.clear()
    needed = {(48, 48, 3, 1), (48, 96, 3, 2), (64, 64, 3, 2),
              (64, 64, 3, 1)}
    if not needed <= shapes:
        raise AssertionError(f"quantize: K10 shapes {sorted(shapes)} miss "
                             f"{sorted(needed - shapes)}")
    for g, res in per_graph.items():
        print(f"quantize: {g}: K10 {res['calls']:.0f} calls a request, "
              f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
              f"bound {res['bound_ms']:.4f} ms; K10q {res['q_ms']:.4f} ms "
              f"a request, plain {res['q_plain']:.4f} ms, bound "
              f"{res['q_bound']:.4f} ms (bytes) ({card})", flush=True)
    torch.cuda.empty_cache()
    return _sum_counts(launches)


def _k10q_every_fp32_pattern(card):
    """K10q on fp32 inputs against its plain version bit for bit: all 2^32
    fp32 bit patterns (NaN, +-inf and subnormals included) in chunks of
    FP32_PATTERN_CHUNK at the amax values of K10Q_FP32_FULL and in the
    dynamic route on max|x| of the finite patterns (the largest finite
    fp32), then K10Q_FP32_DRAW random patterns at the rest of K10Q_AMAXES
    in each form. Prints the seconds each part took."""
    from contextaware_poseformer_tpu_torch.ops import int8_conv

    t0 = time.perf_counter()
    full = [(label, form, clamp, amax)
            for label, form, clamp, amaxes in K10Q_FP32_FULL
            for amax in amaxes]
    full.append(("step dynamic, max|x| of the finite patterns", "step",
                 False, torch.finfo(torch.float32).max))
    amaxes = [torch.tensor(c[3], dtype=torch.float32, device="cuda")
              for c in full]
    bad = {}
    for start in range(-2 ** 31, 2 ** 31, FP32_PATTERN_CHUNK):
        x = (torch.arange(FP32_PATTERN_CHUNK, dtype=torch.int64,
                          device="cuda") + start).to(torch.int32).view(
            torch.float32)
        for (label, form, clamp, amax), a in zip(full, amaxes):
            got = int8_conv.quantize_kernel(x, a, clamp, form=form)
            n = int((got != _k10q_plain(x, a, form, clamp)).sum())
            if n:
                bad[(label, amax)] = bad.get((label, amax), 0) + n
        del x
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randint(-2 ** 31, 2 ** 31, (K10Q_FP32_DRAW,), generator=gen,
                      dtype=torch.int64, device="cuda").to(torch.int32).view(
        torch.float32)
    drawn = 0
    for label, form, clamp, done in K10Q_FP32_FULL:
        for amax in K10Q_AMAXES:
            if amax in done:
                continue
            a = torch.tensor(amax, dtype=torch.float32, device="cuda")
            got = int8_conv.quantize_kernel(x, a, clamp, form=form)
            n = int((got != _k10q_plain(x, a, form, clamp)).sum())
            drawn += 1
            if n:
                bad[(f"{label} (draw)", amax)] = n
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    print(f"fp32_int8: K10q on all 2^32 fp32 bit patterns at "
          + ", ".join(f"{label} amax {amax:g}" for label, _, _, amax in full)
          + f" ({len(full)} cases, {full_s:.1f} s), then {drawn} cases of "
          f"the other amax values of K10Q_AMAXES on {K10Q_FP32_DRAW} random "
          f"fp32 patterns ({draw_s:.1f} s): values differing from the plain "
          f"version {bad or 'none'} ({card})", flush=True)
    if bad:
        raise AssertionError(f"K10q fp32: differing values {bad}")


def _k10p_specials(card):
    """K10p at the stem shape (BATCH, 128, 96, 64), bf16 and fp32, on a
    tensor seeded with NaN, +-inf and +-0 (a twentieth of the values each)
    against its plain version, bit for bit."""
    from contextaware_poseformer_tpu_torch.ops import int8_conv

    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = (BATCH, 128, 96, 64)
    x = torch.randn(*shape, generator=gen, device="cuda") * 3
    pick = torch.randint(0, 20, shape, generator=gen, device="cuda")
    for i, v in enumerate((float("nan"), float("inf"), float("-inf"), 0.0,
                           -0.0)):
        x = torch.where(pick == i, torch.tensor(v, device="cuda"), x)
    a = torch.tensor(4.1, device="cuda")
    eqs = {}
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        eqs[str(dtype).removeprefix("torch.")], _ = _exact(
            int8_conv.quant_max_pool_kernel(xd, a),
            int8_conv.quant_max_pool_3x3_s2_reference(xd, a))
    print(f"fp32_int8: K10p at {shape} seeded with NaN, +-inf and +-0 (a "
          f"twentieth of the values each): equal share {eqs} ({card})",
          flush=True)
    if any(eq != 1.0 for eq in eqs.values()):
        raise AssertionError(f"K10p on NaN/inf/0: equal share {eqs}")


@contextlib.contextmanager
def _plain_int8_calls(counts):
    """While the block runs, count in ``counts`` the calls of the int8
    kernels' plain versions (K9's, K10's, K10q's two forms, K10p's, K10s's
    and K10u's)."""
    from contextaware_poseformer_tpu_torch.ops import int8_conv, layer1_chain

    names = [(int8_conv, n) for n in (
        "int8_conv_reference", "quantize_reference", "quant_reference",
        "quant_max_pool_3x3_s2_reference", "stem_conv_reference",
        "topdown_reference")] + [
        (layer1_chain, "layer1_chain_reference")]
    saved = [(mod, n, getattr(mod, n)) for mod, n in names]
    for mod, n, fn in saved:
        def spy(*args, _fn=fn, _n=n, **kw):
            counts[_n] = counts.get(_n, 0) + 1
            return _fn(*args, **kw)
        setattr(mod, n, spy)
    try:
        yield counts
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def _fp32_vs_plain(label, cfg, model, req, card, phase="fp32_int8"):
    """The fp32 graph against its plain graph on ``req``: the same weights
    and serving state with every kernel's plain version (``int8_impl=
    "plain"`` and the plain lifter knobs, as ``check_serving`` builds it).
    The backbone maps (and the CPN's dequant scales) must be equal bit for
    bit, the poses within SLICE_REL_RMS, and the plain graph must launch no
    kernel."""
    from contextaware_poseformer_tpu_torch import serve
    from contextaware_poseformer_tpu_torch.data import augment
    from contextaware_poseformer_tpu_torch.models.capf import backbone_maps

    plain_cfg = replace(cfg, model=replace(cfg.model, lifter=replace(
        cfg.model.lifter, sampler="gather", attention="einsum",
        attention_joint="einsum", mlp="einsum")))
    plain = serve.build_model(plain_cfg.model, model.backbone.dtype, "cuda",
                              generator=torch.Generator().manual_seed(1))
    plain.load_state_dict(model.state_dict())
    plain.backbone.int8_impl = "plain"
    images = augment.serving_images(req[0], cfg.model.backbone,
                                    dtype=model.backbone.dtype)
    with torch.inference_mode():
        maps, scales = backbone_maps(model.backbone(images))
        out = serve.lift(model, *req)
        torch.cuda.synchronize()
        before = _counts()
        plain_maps, plain_scales = backbone_maps(plain.backbone(images))
        ref = serve.lift(plain, *req)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _counts().items() if v
                    != before[k]}
    pairs = list(zip(maps, plain_maps)) + list(zip(scales or (),
                                                   plain_scales or ()))
    equal = [a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs]
    rel = _rel_rms(out, ref)
    shapes = [tuple(m.shape[1:]) for m in maps]
    print(f"{phase}: {label}: backbone maps {shapes} "
          f"{maps[0].dtype}{' and their scales' if scales else ''} equal "
          f"bit for bit to the plain graph's (int8_impl='plain', plain "
          f"lifter): {all(equal)} ({len(pairs)} tensors); poses vs the "
          f"plain graph rel RMS {rel:.3e} (tol {SLICE_REL_RMS:.0e}); the "
          f"plain graph's launches {launched or 'none'} ({card})",
          flush=True)
    if not all(equal) or not rel <= SLICE_REL_RMS or launched:
        raise AssertionError(f"{phase} {label}: maps equal {equal}, rel "
                             f"RMS {rel:.3e}, plain launches {launched}")
    del plain
    return out


def _fp32_beside_bf16(label, cfg, graphs, req, card):
    """Information: host ms a request over FP32_TIMED requests and where
    the time goes (``_where_time_goes``) for each of ``graphs`` ({name:
    model}: the fp32 graph and the bf16 deploy graph of the same weights),
    and the relative RMS between their poses."""
    from contextaware_poseformer_tpu_torch import serve

    outs = {}
    for name, model in graphs.items():
        outs[name] = serve.lift(model, *req)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FP32_TIMED):
            serve.lift(model, *req)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / FP32_TIMED
        print(f"fp32_int8: {label} {name}: {host_ms:.3f} ms a request, "
              f"{BATCH * 1e3 / host_ms:.1f} frames/s (information only; "
              f"host clock over {FP32_TIMED} requests, batch {BATCH}, "
              f"{card})", flush=True)
        _where_time_goes("fp32_int8", f"{label} {name}", cfg, model, req,
                         host_ms, f"batch {BATCH}, {card}")
    a, b = outs.values()
    print(f"fp32_int8: {label}: poses of the " + " and ".join(outs)
          + f" graphs of the same weights: rel RMS {_rel_rms(a, b):.3e} "
          f"(information only; {card})", flush=True)


def check_fp32_int8(results, card):
    """Phase 8b: the int8 deploy graphs with an fp32 backbone. K10q's fp32
    form on every fp32 bit pattern and K10p's on NaN/inf/0; the h36m_cpn
    deploy graph through ``StreamingLifter(use_bf16=False)`` (3 requests
    of BATCH frames, then a pass of STREAM_CAMERAS x STREAM_SLOTS frames)
    and the h36m_hrnet_32 one through ``serve.build_model(...,
    torch.float32, ...)``, ``serve.prepare`` and ``serve.lift`` (one
    request): launches at FP32_PER_REQUEST beside the lifter's, no int8
    plain version run, the backbone maps bit-equal to ``int8_impl=
    "plain"`` and the poses within SLICE_REL_RMS of that plain graph; each
    K10 shape and variant and each stream quantize of the fp32 CPN request
    against its plain version; host ms and device busy beside the bf16
    deploy graph of the same weights. Returns the counted runs'
    launches."""
    import numpy as np

    from contextaware_poseformer_tpu_torch import config, serve
    from contextaware_poseformer_tpu_torch.models import bridge, streaming

    _k10q_every_fp32_pattern(card)
    _k10p_specials(card)
    counted = []
    image_wh = (1000, 1000)
    cfg = config.deploy(config.preset("h36m_cpn"))
    hw = tuple(cfg.model.image_shape)
    src = serve.build_model(cfg.model, torch.float32, "cuda",
                            generator=torch.Generator().manual_seed(0))
    variables = bridge.variables_to_jax(src)
    del src
    calib = _stream_inputs(np.random.RandomState(1), BATCH, hw,
                           STREAM_CAMERAS)
    lifters = {}
    for name, use_bf16 in (("fp32", False), ("bf16", True)):
        t0 = time.perf_counter()
        sl = streaming.StreamingLifter(
            cfg.model, variables, streaming.StreamingConfig(
                batch_size=BATCH, use_bf16=use_bf16), device="cuda")
        sl.prepare(calib[0], calib[1], image_wh, calib[2], calib[3])
        torch.cuda.synchronize()
        lifters[name] = sl
        print(f"fp32_int8: h36m_cpn StreamingLifter(use_bf16={use_bf16}) "
              f"built and prepared in {time.perf_counter() - t0:.1f} s "
              f"(backbone {sl.model.backbone.dtype}, lifter "
              f"{cfg.model.lifter.compute_dtype})", flush=True)
    sl = lifters["fp32"]
    if sl.model.backbone.dtype != torch.float32:
        raise AssertionError(f"fp32_int8: backbone {sl.model.backbone.dtype}")
    per_request = {**PER_REQUEST["h36m_cpn"], **FP32_PER_REQUEST["cpn"]}
    reqs = [_stream_inputs(np.random.RandomState(10 + i), BATCH, hw,
                           STREAM_CAMERAS) for i in range(FP32_REQUESTS)]
    n = STREAM_CAMERAS * STREAM_SLOTS
    chunks = -(-n // BATCH)
    passed = _stream_inputs(np.random.RandomState(0), n, hw, STREAM_CAMERAS)
    plain = {}
    _reset_counts()
    with _plain_int8_calls(plain):
        for i, r in enumerate(reqs + [passed]):
            before = _counts()
            out = sl.lift_batch(r[0], r[1], image_wh, r[2], r[3])
            torch.cuda.synchronize()
            grew = {k: v - before[k] for k, v in _counts().items()}
            rows = len(r[0])
            want = _expected(per_request, 1 if i < len(reqs) else chunks)
            if grew != want or out.shape != (rows, 17, 3) \
                    or not np.isfinite(out).all():
                raise AssertionError(f"fp32_int8 h36m_cpn lift_batch {i}: "
                                     f"launches {grew}, expected {want}; "
                                     f"poses {out.shape}")
    counted.append(_counts())
    print(f"fp32_int8: h36m_cpn fp32 backbone: {len(reqs)} lift_batch "
          f"requests of {BATCH} frames and one pass of {STREAM_CAMERAS} "
          f"cameras x {STREAM_SLOTS} slots ({chunks} chunks), finite; "
          f"launches {counted[-1]} (a request {per_request}); int8 plain "
          f"versions run {plain or 'none'} ({card})", flush=True)
    if plain:
        raise AssertionError(f"fp32_int8: plain versions ran {plain}")

    kp_norm, crop = sl._preprocess(reqs[0][1], image_wh, reqs[0][2],
                                   reqs[0][3])
    req = tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                for a in (reqs[0][0], kp_norm, crop))
    _fp32_vs_plain("h36m_cpn", cfg, sl.model, req, card)
    seen, stream = {}, []
    _record_k10(sl.model, req, seen, stream)
    calls, step_calls = _recorded_request(seen, stream,
                                          FP32_PER_REQUEST["cpn"],
                                          "fp32_int8")
    res, quant = _k10_calls_vs_plain(seen, "fp32_int8", card)
    k10_ms = dict(res)
    pool = _stream_quants_vs_plain(stream, quant, "fp32_int8", card)
    seen.clear()
    stream.clear()
    print(f"fp32_int8: the fp32 forms over the fp32 CPN request: K10 "
          f"{calls} calls kernel {k10_ms['ms']:.4f} ms, plain "
          f"{k10_ms['plain_ms']:.4f} ms, bound {k10_ms['bound_ms']:.4f} ms;"
          f" K10q {FP32_PER_REQUEST['cpn']['K10q']} calls ({step_calls} "
          f"step form) {quant['ms']:.4f} ms, plain {quant['plain_ms']:.4f} "
          f"ms, bound {quant['bound_ms']:.4f} ms; K10p {pool['ms']:.4f} ms, "
          f"plain {pool['plain_ms']:.4f} ms, bound {pool['bound_ms']:.4f} ms"
          f" ({card})", flush=True)
    for k, r in (("K10", res), ("K10q", quant), ("K10p", pool)):
        results[k]["max_abs_err"] = max(results[k]["max_abs_err"],
                                        r["max_abs_err"])
    _fp32_beside_bf16("h36m_cpn", cfg, {n: l.model for n, l in
                                        lifters.items()}, req, card)
    del sl, lifters
    torch.cuda.empty_cache()

    name = "h36m_hrnet_32"
    cfg = config.deploy(config.preset(name))
    t0 = time.perf_counter()
    model = serve.build_model(cfg.model, torch.float32, "cuda",
                              generator=torch.Generator().manual_seed(0))
    variables = bridge.variables_to_jax(model)
    h, w = cfg.model.image_shape
    gen = torch.Generator().manual_seed(0)
    req = (torch.randint(0, 256, (BATCH, h, w, 3), dtype=torch.uint8,
                         generator=gen).cuda(),
           (torch.rand(BATCH, 17, 2, generator=gen) * 2 - 1).cuda(),
           (torch.rand(BATCH, 17, 2, generator=gen) * w).cuda())
    calib = torch.randint(0, 256, (BATCH, h, w, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(1)).cuda()
    serve.prepare(model, [calib])
    bf16 = serve.build_model(serve.deploy_config(name).model, torch.bfloat16,
                             "cuda", variables=variables)
    serve.prepare(bf16, [calib])
    torch.cuda.synchronize()
    print(f"fp32_int8: {name} fp32 backbone (layer1_impl "
          f"{cfg.model.backbone.layer1_impl!r}: the per-conv chain) and its "
          f"bf16 deploy graph (layer1 K9) built and prepared in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    per_request = {**PER_REQUEST[name], **FP32_PER_REQUEST["hrnet"]}
    _reset_counts()
    with _plain_int8_calls(plain):
        out = serve.lift(model, *req)
        torch.cuda.synchronize()
    counted.append(_counts())
    print(f"fp32_int8: {name} fp32 backbone: one request of {BATCH} frames "
          f"-> {tuple(out.shape)} finite {bool(torch.isfinite(out).all())};"
          f" launches {counted[-1]} (expected {per_request}); int8 plain "
          f"versions run {plain or 'none'} ({card})", flush=True)
    if (counted[-1] != _expected(per_request) or plain
            or out.shape != (BATCH, 17, 3)
            or not torch.isfinite(out).all()):
        raise AssertionError(f"fp32_int8 {name}: launches {counted[-1]}, "
                             f"plain {plain}")
    _fp32_vs_plain(name, cfg, model, req, card)
    _fp32_beside_bf16(name, cfg, {"fp32": model, "bf16": bf16}, req, card)
    del model, bf16
    torch.cuda.empty_cache()
    return _sum_counts(counted)


def _sum_counts(counts):
    return {k: sum(c[k] for c in counts) for k in _counters()}


def _stream_inputs(rng, n, hw, cams):
    """``n`` frames of ``cams`` cameras in time order (slot-major): crops,
    full-frame detections, each camera's box; (frames, kp_full, centers,
    scales, camera ids, boxes)."""
    import numpy as np

    boxes = {c: (np.array([480.0 + 20 * c, 500.0]),
                 np.array([1.0 + 0.05 * c, 1.1])) for c in range(cams)}
    ids = np.tile(np.arange(cams), n // cams)
    frames = rng.randint(0, 256, (n, *hw, 3)).astype(np.uint8)
    kp_full = rng.uniform(100, 900, (n, 17, 2))
    centers = np.stack([boxes[c][0] for c in ids])
    scales = np.stack([boxes[c][1] for c in ids])
    return frames, kp_full, centers, scales, ids, boxes


def _streamer(name):
    """A ``StreamingLifter`` of ``deploy_config(name)`` at batch BATCH on
    the card, its weights the JAX-format variables of the model drawn from
    seed 0."""
    from contextaware_poseformer_tpu_torch import serve
    from contextaware_poseformer_tpu_torch.models import bridge, streaming

    cfg = serve.deploy_config(name)
    src = serve.build_serving_model(
        cfg, "cuda", generator=torch.Generator().manual_seed(0))
    variables = bridge.variables_to_jax(src)
    del src
    return streaming.StreamingLifter(
        cfg.model, variables, streaming.StreamingConfig(batch_size=BATCH),
        device="cuda")


def check_streaming(card):
    """Phase 9: ``models.streaming.StreamingLifter`` over the h36m_cpn
    deploy graph at batch BATCH: refused before ``prepare``; prepared on
    one seeded batch; 4 cameras x 38 time slots (152 frames: two full
    chunks, one padded from 24) through ``lift_batch``, each chunk equal
    bit for bit to ``serve.lift`` on the same padded chunk, launches 3x a
    request's; ``stream`` with the EMA equal to the per-camera EMA of
    ``lift_batch``'s poses (1e-6); ``latency_stats`` over STREAM_PASSES
    passes beside the same frames through ``serve.lift`` chunk by chunk
    with no overlap (information); then one pass of the h36m_hrnet_32
    deploy graph (K5, K9). Returns the counted runs' launches."""
    import numpy as np

    from contextaware_poseformer_tpu_torch import serve

    image_wh = (1000, 1000)
    n = STREAM_CAMERAS * STREAM_SLOTS
    chunks = -(-n // BATCH)
    counted = []
    sl = _streamer("h36m_cpn")
    hw = sl.model_cfg.image_shape
    rng = np.random.RandomState(0)
    frames, kp, centers, scales, ids, boxes = _stream_inputs(
        rng, n, hw, STREAM_CAMERAS)
    args = (frames, kp, image_wh, centers, scales)
    try:
        sl.lift_batch(*args)
    except ValueError as e:
        print(f"streaming: h36m_cpn deploy refused before prepare: {e}",
              flush=True)
    else:
        raise AssertionError("streaming: lift_batch ran before prepare")
    calib = _stream_inputs(np.random.RandomState(1), BATCH, hw,
                           STREAM_CAMERAS)
    sl.prepare(calib[0], calib[1], image_wh, calib[2], calib[3])
    per_request = {**PER_REQUEST["h36m_cpn"], **INT8_PER_REQUEST["cpn"]}

    _reset_counts()
    out = sl.lift_batch(*args)
    torch.cuda.synchronize()
    counted.append(_counts())
    if counted[-1] != _expected(per_request, chunks):
        raise AssertionError(f"streaming: {n} frames launched "
                             f"{counted[-1]}, expected {chunks} x "
                             f"{per_request}")
    if out.shape != (n, 17, 3) or not np.isfinite(out).all():
        raise AssertionError(f"streaming: bad poses {out.shape}")
    kp_norm, crop = sl._preprocess(kp, image_wh, centers, scales)
    equal = []
    for start in range(0, n, BATCH):
        idx = slice(start, min(start + BATCH, n))
        ref = serve.lift(sl.model, *(
            torch.from_numpy(np.ascontiguousarray(sl.pad(a[idx], BATCH)))
            .cuda() for a in (frames, kp_norm, crop)))
        equal.append(np.array_equal(out[idx],
                                    ref[:idx.stop - start].cpu().numpy()))
    print(f"streaming: h36m_cpn deploy: {STREAM_CAMERAS} cameras x "
          f"{STREAM_SLOTS} slots = {n} frames in {chunks} chunks of "
          f"{BATCH} (the last padded from {n - (chunks - 1) * BATCH}); "
          f"launches {counted[-1]}; each chunk equal to serve.lift on the "
          f"padded chunk: {equal}", flush=True)
    if not all(equal):
        raise AssertionError(f"streaming: chunks equal {equal}")

    sl.cfg = replace(sl.cfg, ema_alpha=STREAM_EMA)
    _reset_counts()
    items = [(int(c), frames[i], kp[i]) for i, c in enumerate(ids)]
    streamed = list(sl.stream(iter(items), image_wh, lambda c: boxes[c]))
    torch.cuda.synchronize()
    counted.append(_counts())
    sl.cfg = replace(sl.cfg, ema_alpha=0.0)
    if [c for c, _ in streamed] != [int(c) for c in ids]:
        raise AssertionError("streaming: stream() reordered the cameras")
    ema, err = {}, 0.0
    for (cam, pose), raw in zip(streamed, out):
        want = raw if cam not in ema else (STREAM_EMA * ema[cam]
                                           + (1 - STREAM_EMA) * raw)
        ema[cam] = want
        err = max(err, float(np.abs(pose - want).max()))
    print(f"streaming: stream() with ema_alpha {STREAM_EMA}: max abs error "
          f"{err:.3e} against the per-camera EMA of lift_batch (tol 1e-6); "
          f"launches {counted[-1]}", flush=True)
    if not err <= 1e-6 or counted[-1] != _expected(per_request, chunks):
        raise AssertionError(f"streaming: EMA error {err}, launches "
                             f"{counted[-1]}")

    def chunk_by_chunk():  # serve.lift a chunk at a time, nothing overlapped
        t1 = time.perf_counter()
        knorm, kcrop = sl._preprocess(kp, image_wh, centers, scales)
        for start in range(0, n, BATCH):
            idx = slice(start, min(start + BATCH, n))
            serve.lift(sl.model, *(
                torch.from_numpy(np.ascontiguousarray(sl.pad(a[idx], BATCH)))
                .cuda() for a in (frames, knorm, kcrop))).cpu()
        return (time.perf_counter() - t1) * 1e3

    sl._latencies.clear()
    lat = []
    for i in range(STREAM_PASSES):  # in turns, each side first half the time
        if i % 2:
            lat.append(chunk_by_chunk())
        sl.lift_batch(*args)
        if not i % 2:
            lat.append(chunk_by_chunk())
    stats = sl.latency_stats()
    lat = np.asarray(lat)
    print(f"streaming: lift_batch of {n} frames over {stats['n']} passes: "
          f"p50 {stats['p50_ms']:.3f} ms, p90 {stats['p90_ms']:.3f}, p99 "
          f"{stats['p99_ms']:.3f}, mean {stats['mean_ms']:.3f}, "
          f"{stats['frames_per_sec']:.1f} frames/s; serve.lift chunk by "
          f"chunk without overlap: p50 {np.percentile(lat, 50):.3f} ms, p90 "
          f"{np.percentile(lat, 90):.3f}, p99 {np.percentile(lat, 99):.3f}, "
          f"{n * len(lat) / (lat.sum() / 1e3):.1f} frames/s (information "
          f"only; host clock, the two in turns; {card})", flush=True)
    del sl
    torch.cuda.empty_cache()

    sl = _streamer("h36m_hrnet_32")
    hw = sl.model_cfg.image_shape
    frames, kp, centers, scales, _, _ = _stream_inputs(
        np.random.RandomState(2), n, hw, STREAM_CAMERAS)
    calib = _stream_inputs(np.random.RandomState(3), BATCH, hw,
                           STREAM_CAMERAS)
    sl.prepare(calib[0], calib[1], image_wh, calib[2], calib[3])
    per_request = {**PER_REQUEST["h36m_hrnet_32"],
                   **INT8_PER_REQUEST["hrnet"]}
    _reset_counts()
    out = sl.lift_batch(frames, kp, image_wh, centers, scales)
    torch.cuda.synchronize()
    counted.append(_counts())
    print(f"streaming: h36m_hrnet_32 deploy: {n} frames -> {out.shape}, "
          f"finite {bool(np.isfinite(out).all())}; launches {counted[-1]}",
          flush=True)
    if (counted[-1] != _expected(per_request, chunks)
            or not np.isfinite(out).all()):
        raise AssertionError(f"streaming: h36m_hrnet_32 launches "
                             f"{counted[-1]}")
    del sl
    torch.cuda.empty_cache()
    return _sum_counts(counted)


def _probe_result(err, ms, plain_ms, work, dtype, library_ms=None):
    bound_ms, by = _bound(*work, dtype)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms}


def _print_probe(name, what, check, r, card):
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms")
    print(f"probes: {name} ({what}): {check}; kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} "
          f"ms ({r['bound_by']}) ({card})", flush=True)


def check_probes(card):
    """Phase 10: the TPU probes' counterparts. Their main path (each run
    once, every launch count set to 0 before it and read after it), then
    each held against its plain version (bit for bit where the function is
    integer; the two timing-only builds, wrong by design, run and are
    timed), with median kernel, plain and library times and the bound.
    Returns {probe: JSON numbers with its launches}."""
    from contextaware_poseformer_tpu_torch.ops import (
        _build,
        int8_conv,
        layer1_chain,
    )
    from contextaware_poseformer_tpu_torch.probes import int8_chain, window

    gen = torch.Generator().manual_seed(6)
    b, h, w, c = int8_chain.BATCH, int8_chain.H, int8_chain.W, int8_chain.C
    n_deep = 8

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int8).cuda()

    def uniform(lo, hi, *shape):
        return (torch.rand(*shape, generator=gen) * (hi - lo) + lo).cuda()

    # the chain: post-ReLU int8 input, int8 weights as the probe draws them
    x = ints(0, 128, b, h, w, c)
    convs = [(ints(-8, 9, c, 9 * c), torch.full((c,), 0.02, device="cuda"),
              uniform(0.5, 1.5, c), uniform(-0.1, 0.1, c))
             for _ in range(n_deep)]
    amaxes = [torch.tensor(10.0, device="cuda") for _ in range(n_deep + 1)]
    # the pieces
    kq = convs[0][0]
    x1 = ints(-127, 128, b, h, w // 4, 576)  # pre-windowed (M, 576)
    k1 = ints(-8, 9, 128, 576)
    xb = torch.randn(b, h, w, c, generator=gen).to("cuda", torch.bfloat16)
    wb = (torch.randn(c, 9 * c, generator=gen) / 17).to("cuda",
                                                       torch.bfloat16)
    acc = torch.randint(-6000, 6000, (b * h * w, c), generator=gen,
                        dtype=torch.int32).cuda()
    ws, sc, bi = convs[0][1:]
    a_in, a_out = torch.tensor(10.0, device="cuda"), torch.tensor(
        12.0, device="cuda")
    # K9 at the layer1 probe's shape (batch 128, 64x48x64)
    x9 = (torch.randn(b, 64, 48, 64, generator=gen) * 2).to("cuda",
                                                            torch.bfloat16)
    blocks = _layer1_blocks(gen)
    a9 = torch.tensor(6.0, device="cuda")
    # the window shift
    xf = (torch.randn(window.M, window.LANES, generator=gen) * 2).cuda()
    wv = ints(-20, 21, window.K, window.N)
    a4 = torch.tensor(4.0, device="cuda")

    runs = {
        "chain_conv": lambda: int8_chain.chain(x, convs, amaxes),
        "micro_matmul3": lambda: int8_chain.accum(x, kq),
        "micro_matmul3_nomask": lambda: int8_chain.accum(x, kq, mask=False),
        "micro_matmul1": lambda: int8_chain.accum(x1, k1),
        "micro_requant": lambda: int8_chain.requant(acc, ws, sc, bi, a_in,
                                                    a_out),
        "micro_quantize": lambda: int8_chain.quantize(xb, a_in),
        "micro_bf16_matmul3": lambda: int8_chain.bf16_conv(xb, wb),
        "layer1_v1": lambda: layer1_chain.layer1_chain_kernel(x9, a9, blocks),
        "layer1_1block": lambda: layer1_chain.layer1_block_kernel(
            x9, a9, blocks[0]),
        "layer1_floor": lambda: layer1_chain.layer1_chain_kernel(
            x9, a9, blocks, floor=True),
        "window_bitcast": lambda: window.window_matmul(xf, wv, a4, True),
        "window_slice": lambda: window.window_matmul(xf, wv, a4, False),
    }
    counters = {
        "chain_conv": (int8_conv, "launches"),
        "layer1_v1": (layer1_chain, "launches"),
        "layer1_1block": (layer1_chain, "launches"),
        "layer1_floor": (layer1_chain, "launches_floor"),
    }
    piece = {"micro_matmul3": "accum", "micro_matmul3_nomask": "accum_nomask",
             "micro_matmul1": "accum", "micro_requant": "requant",
             "micro_quantize": "quantize", "micro_bf16_matmul3": "bf16_conv",
             "window_bitcast": "words", "window_slice": "offset"}

    def count(name):
        if name in counters:
            mod, attr = counters[name]
            return getattr(mod, attr)
        return (window.launches if name.startswith("window")
                else int8_chain.launches)[piece[name]]

    _reset_counts()
    layer1_chain.launches_floor = 0
    for d in (int8_chain.launches, window.launches):
        for k in d:
            d[k] = 0
    launches, outs = {}, {}
    with torch.inference_mode():
        for name, run in runs.items():  # the probes' main path
            before = count(name)
            outs[name] = run()
            torch.cuda.synchronize()
            launches[name] = count(name) - before
    expect = {"chain_conv": n_deep, "layer1_v1": 4, "layer1_1block": 1,
              "layer1_floor": 4}
    bad = {k: v for k, v in launches.items() if v != expect.get(k, 1)}
    if bad:
        raise AssertionError(f"probe launches {bad}")

    results = {}
    m = b * h * w
    with torch.inference_mode():
        # the chain, 1 and n_deep convs, against its plain chain and cuDNN
        xlib = torch.relu(torch.randn(b, h, w, c, generator=gen)).to(
            "cuda", torch.bfloat16)
        wlib = (torch.randn(c, c, 3, 3, generator=gen) / 17).to(
            "cuda", torch.bfloat16).contiguous(memory_format=torch.channels_last)
        slib = uniform(0.5, 1.5, c).to(torch.bfloat16)[:, None, None]
        blib = uniform(-0.1, 0.1, c).to(torch.bfloat16)[:, None, None]
        for n in (1, n_deep):
            def fn(n=n):
                return int8_chain.chain(x, convs[:n], amaxes[:n + 1])

            def plain(n=n):
                return int8_chain.chain(x, convs[:n], amaxes[:n + 1],
                                        impl="plain")

            out, ref = fn(), plain()
            torch.cuda.synchronize()
            eq, err = _exact(out, ref)
            lib_ms = _median_ms(lambda n=n: int8_chain.library_chain(
                xlib, wlib, slib, blib, n))
            r = _probe_result(err, _median_ms(fn), _median_ms(plain),
                              (2 * m * c + n * (9 * c * c + 12 * c),
                               n * 2 * m * c * 9 * c), torch.int8, lib_ms)
            _print_probe(f"int8_chain_conv n={n}", f"K10 with the int8-out "
                         f"epilogue, batch {b}, {h}x{w}x{c} 3x3",
                         f"equal {eq:.6f} (saturated "
                         f"{(ref.abs() == 127).float().mean().item():.3f})",
                         r, card)
            if eq != 1.0:
                raise AssertionError(f"chain n={n}: equal share {eq}")
        results["chain_conv"] = r  # the n_deep chain, as the probe
        # the pieces
        acc3 = outs["micro_matmul3"]
        ref3 = int8_chain.accum_reference(x, kq)
        eq, err = _exact(acc3, ref3)
        plain3 = _median_ms(lambda: int8_chain.accum_reference(x, kq))
        r = _probe_result(err, _median_ms(runs["micro_matmul3"]), plain3,
                          (m * c + kq.numel() + m * c * 4,
                           2 * m * c * 9 * c), torch.int8)
        _print_probe("micro matmul3", "K10's main loop, int32 out",
                     f"equal {eq:.6f}", r, card)
        if eq != 1.0:
            raise AssertionError(f"matmul3: equal share {eq}")
        results["micro_matmul3"] = r
        nomask = outs["micro_matmul3_nomask"]
        eq, err = _exact(nomask, ref3)
        r = _probe_result(err, _median_ms(runs["micro_matmul3_nomask"]),
                          plain3, (m * c + kq.numel() + m * c * 4,
                                   2 * m * c * 9 * c), torch.int8)
        _print_probe("micro matmul3_nomask", "the same, border predication "
                     "compiled out: timing only", f"ran, int32 out, equal to "
                     f"the masked result at {eq:.4f} of the outputs (the "
                     "edges differ by design)", r, card)
        results["micro_matmul3_nomask"] = r
        ref1 = int8_chain.accum_reference(x1, k1)
        eq, err = _exact(outs["micro_matmul1"], ref1)
        a2 = x1.reshape(-1, 576)
        bt = k1.t()
        m1 = a2.shape[0]
        r = _probe_result(err, _median_ms(runs["micro_matmul1"]),
                          _median_ms(lambda: int8_chain.accum_reference(
                              x1, k1)),
                          (x1.numel() + k1.numel() + m1 * 128 * 4,
                           2 * m1 * 576 * 128), torch.int8,
                          _median_ms(lambda: torch._int_mm(a2, bt)))
        _print_probe("micro matmul1", f"K10 1x1 over a pre-windowed ({m1}, "
                     "576) input: one (M, 576) x (576, 128) int8 GEMM",
                     f"equal {eq:.6f}", r, card)
        if eq != 1.0:
            raise AssertionError(f"matmul1: equal share {eq}")
        results["micro_matmul1"] = r
        refr = int8_chain.requant_reference(acc, ws, sc, bi, a_in, a_out)
        eq, err = _exact(outs["micro_requant"], refr)
        r = _probe_result(err, _median_ms(runs["micro_requant"]),
                          _median_ms(lambda: int8_chain.requant_reference(
                              acc, ws, sc, bi, a_in, a_out)),
                          (acc.numel() * 5 + 12 * c, 6 * acc.numel()),
                          torch.float32)
        _print_probe("micro requant", "K10's epilogue alone, int32 -> int8",
                     f"equal {eq:.6f}", r, card)
        if eq != 1.0:
            raise AssertionError(f"requant: equal share {eq}")
        results["micro_requant"] = r
        refq = int8_chain.quantize_reference(xb, a_in)
        eq, err = _exact(outs["micro_quantize"], refq)
        r = _probe_result(err, _median_ms(runs["micro_quantize"]),
                          _median_ms(lambda: int8_chain.quantize_reference(
                              xb, a_in)),
                          (xb.numel() * 3, 3 * xb.numel()), torch.float32)
        _print_probe("micro quantize", "K10's quantize pass alone, bf16 "
                     "-> int8", f"equal {eq:.6f}", r, card)
        if eq != 1.0:
            raise AssertionError(f"quantize: equal share {eq}")
        results["micro_quantize"] = r
        refb = int8_chain.bf16_conv_reference(xb, wb)
        err, rel = _err(outs["micro_bf16_matmul3"], refb)
        xnchw = xb.permute(0, 3, 1, 2)
        wlib3 = wb.reshape(c, 3, 3, c).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        r = _probe_result(err, _median_ms(runs["micro_bf16_matmul3"]),
                          _median_ms(lambda: int8_chain.bf16_conv_reference(
                              xb, wb)),
                          (xb.numel() * 2 + wb.numel() * 2 + m * c * 4,
                           2 * m * c * 9 * c), torch.bfloat16,
                          _median_ms(lambda: F.conv2d(xnchw, wlib3,
                                                      padding=1)))
        _print_probe("micro bf16_matmul3", "K10's main loop on bf16 "
                     "operands (wgmma m64nNk16), fp32 out",
                     f"rel {rel:.3e} (tol 1e-5: fp32 sums in another order)",
                     r, card)
        if not rel <= 1e-5:
            raise AssertionError(f"bf16_matmul3: rel error {rel:.3e}")
        results["micro_bf16_matmul3"] = r

        # K9 at the layer1 probe's shape, one block against K10's chain of
        # that block, and the floor build
        ref9 = layer1_chain.layer1_chain_reference(x9, a9, blocks)
        eq, err = _exact(outs["layer1_v1"], ref9)
        weights = sum(blk[cv][0].numel() + 12 * blk[cv][0].shape[0]
                      for blk in blocks for cv in ("conv1", "conv2", "conv3",
                                                   "downsample")
                      if blk[cv] is not None)
        px = b * 64 * 48
        work9 = (x9.numel() * 2 + weights + px * 256,
                 2 * px * (64 * 64 + 3 * 256 * 64 + 4 * 576 * 64
                           + 4 * 64 * 256 + 256 * 64))
        k9_ms = _median_ms(runs["layer1_v1"])
        r = _probe_result(err, k9_ms, _median_ms(
            lambda: layer1_chain.layer1_chain_reference(x9, a9, blocks)),
            work9, torch.int8)
        _print_probe("layer1_chain_probe _kernel_v1", f"K9 itself (conv2 "
                     f"already one K=576 GEMM), batch {b}, 64x48x64",
                     f"equal {eq:.6f}", r, card)
        if eq != 1.0:
            raise AssertionError(f"K9 probe shape: equal share {eq}")
        results["layer1_v1"] = r
        one = outs["layer1_1block"]
        via = layer1_chain.layer1_int8_chain(x9, a9, blocks[:1])
        ref1b = layer1_chain.layer1_chain_reference(x9, a9, blocks[:1])
        eq_chain, _ = _exact(one, via)
        eq, err = _exact(one, ref1b)
        d = (one.int() - via.int()).abs()
        r = _probe_result(err, _median_ms(runs["layer1_1block"]), _median_ms(
            lambda: layer1_chain.layer1_chain_reference(x9, a9, blocks[:1])),
            (x9.numel() * 2 + px * 256 + 2 * 64 * 576,
             2 * px * (64 * 64 + 576 * 64 + 2 * 64 * 256)), torch.int8,
            None)
        chain_ms = _median_ms(lambda: layer1_chain.layer1_int8_chain(
            x9, a9, blocks[:1]))
        _print_probe("layer1_chain_probe pallas_1block", "K9 on one "
                     "bottleneck block", f"against K10's per-conv chain of "
                     f"the block: match={(d == 0).float().mean().item() * 100:.4f}%"
                     f" maxdiff={d.max().item()} frac|d|>1="
                     f"{(d > 1).float().mean().item() * 100:.4f}%; equal "
                     f"{eq:.6f} (plain); K10 chain {chain_ms:.4f} ms", r,
                     card)
        if eq != 1.0 or eq_chain != 1.0:
            raise AssertionError(f"one block: equal {eq} (plain), "
                                 f"{eq_chain} (K10 chain)")
        results["layer1_1block"] = r
        floor = outs["layer1_floor"]
        _, err = _exact(floor, ref9)
        r = _probe_result(err, _median_ms(runs["layer1_floor"]),
                          results["layer1_v1"]["plain_ms"], work9,
                          torch.int8)
        _print_probe("layer1_chain_floor", "K9's floor build: MMAs and bf16 "
                     "epilogues, no requant or window stages; timing only",
                     f"ran, int8 out, K9 takes {k9_ms:.4f} ms, the floor "
                     f"{r['ms'] / k9_ms:.1%} of it", r, card)
        results["layer1_floor"] = r

        # the window shift, both ways, beside the launch floor of the same
        # timer (the library's empty kernel)
        refw = window.window_matmul_reference(xf, wv, a4)
        plainw = _median_ms(lambda: window.window_matmul_reference(xf, wv,
                                                                   a4))
        floor_ms = _median_ms(lambda: _build.empty_kernel(xf.device))
        for name, words in (("window_bitcast", True),
                            ("window_slice", False)):
            eq, err = _exact(outs[name], refw)
            r = _probe_result(err, _median_ms(runs[name]), plainw,
                              (xf.numel() * 4 + wv.numel() + refw.numel() * 4,
                               2 * 2 * window.M * window.K * window.N),
                              torch.int8)
            _print_probe(f"int8_primitives {name.split('_')[1]}",
                         "the row-shifted int8 window by "
                         + ("a 3-word shift, __byte_perm" if words
                            else "an address offset"),
                         f"equal {eq:.6f} (xwin @ w + roll(xwin, -12) @ w); "
                         f"{r['ms'] / floor_ms:.2f}x the launch floor "
                         f"{floor_ms:.4f} ms", r, card)
            if eq != 1.0:
                raise AssertionError(f"{name}: equal share {eq}")
            results[name] = r
    del outs
    torch.cuda.empty_cache()
    for name in results:
        results[name]["launches"] = launches[name]
    return results


def _counters():
    """{kernel: (module, name of its launch counter)}"""
    from contextaware_poseformer_tpu_torch.ops import (
        conv_epilogue, deformable, fused_mlp, int8_conv, joint_attention,
        layer1_chain, small_attention,
    )

    return {"K1": (deformable, "launches"), "K2": (fused_mlp, "launches"),
            "K3": (small_attention, "launches"),
            "K4": (joint_attention, "launches"),
            "K5": (deformable, "launches_k5"),
            "K6": (deformable, "launches_bwd"),
            "K7": (deformable, "launches_k7"),
            "K8": (deformable, "launches_k8"),
            "K9": (layer1_chain, "launches"),
            "K10": (int8_conv, "launches"),
            "K10q": (int8_conv, "launches_quantize"),
            "K10p": (int8_conv, "launches_quant_pool"),
            "K10s": (int8_conv, "launches_stem"),
            "K10u": (int8_conv, "launches_topdown"),
            "conv_epilogue": (conv_epilogue, "launches")}


def _counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


def _reset_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _expected(per_call, calls=1):
    return {k: calls * per_call.get(k, 0) for k in _counters()}


def check_serving(name, requests_n, card, int8=False, inspect=None,
                  mode=None, timed=TIMED_REQUESTS, lifter_dtype=None):
    """Phases 4, 4b, 5, 6b, 7b and 8b: serve ``requests_n`` requests of the
    full-width ``slice_config(name)`` (``deploy_config(name)`` with
    ``int8``, ``quantize_config(name, mode)`` with ``mode``, either after
    ``serve.prepare`` on one seeded batch; with ``lifter_dtype`` the
    lifter computing in that dtype) through ``serve.lift``, checking each
    request's launches and the output, and one request against the plain
    knobs (and, for an int8 graph, K9's and K10's plain versions: relative
    RMS within SLICE_REL_RMS, an fp32 lifter's within FP32_LIFTER_REL_RMS);
    a "c128" graph's first request, served before ``prepare``, must equal
    the prepared model's. ``inspect(model, request)`` runs before the
    counted requests. Returns the launch counts of the requests."""
    from contextaware_poseformer_tpu_torch import serve

    phase = ("slice" if name == "h36m_cpn" else "hrnet") if not int8 else (
        "cpn_int8" if name == "h36m_cpn" else "int8")
    if mode is not None:
        phase = "quantize"
        cfg = serve.quantize_config(name, mode)
    else:
        cfg = serve.deploy_config(name) if int8 else serve.slice_config(name)
    tol = SLICE_REL_RMS
    if lifter_dtype is not None:
        phase = "fp32_lifter" if lifter_dtype == "float32" else (
            f"{lifter_dtype}_lifter")
        cfg = replace(cfg, model=replace(cfg.model, lifter=replace(
            cfg.model.lifter, compute_dtype=lifter_dtype)))
        tol = FP32_LIFTER_REL_RMS if lifter_dtype == "float32" else tol
    kind = cfg.model.backbone.kind
    per_request = PER_REQUEST[name]
    quantized = int8 or mode is not None
    if not quantized:
        per_request = {**per_request, **FLOAT_EPILOGUES[kind]}
    if int8:
        per_request = {**per_request, **INT8_PER_REQUEST[kind]}
    if mode is not None:
        per_request = {**per_request, **QUANT_PER_REQUEST[mode][kind]}
    label = name if mode is None else f"{name} {mode}"
    if lifter_dtype is not None:
        label = f"{label}, lifter {lifter_dtype}"
    t0 = time.perf_counter()
    model = serve.build_serving_model(
        cfg, "cuda", generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    h, w = cfg.model.image_shape
    gen = torch.Generator().manual_seed(0)
    requests = [
        (torch.randint(0, 256, (BATCH, h, w, 3), dtype=torch.uint8,
                       generator=gen).cuda(),
         (torch.rand(BATCH, 17, 2, generator=gen) * 2 - 1).cuda(),
         (torch.rand(BATCH, 17, 2, generator=gen) * w).cuda())
        for _ in range(requests_n)
    ]
    unprepared = None
    if mode == "c128":  # it serves without prepare, weights quantized a call
        unprepared = serve.lift(model, *requests[0])
    if quantized:
        calib = torch.randint(0, 256, (BATCH, h, w, 3), dtype=torch.uint8,
                              generator=torch.Generator().manual_seed(1))
        t1 = time.perf_counter()
        serve.prepare(model, [calib.cuda()])
        torch.cuda.synchronize()
        from contextaware_poseformer_tpu_torch.models import backbone_common
        scales = backbone_common.calibration_buffers(model.backbone)
        what = (f"{len(scales)} scales "
                f"{min(v.item() for v in scales.values()):.4g}.."
                f"{max(v.item() for v in scales.values()):.4g}" if scales
                else "weights only, no scales")
        print(f"{phase}: {label} prepared in "
              f"{time.perf_counter() - t1:.1f} s (calibration on {BATCH} "
              f"seeded frames, quantile {cfg.model.backbone.calib_quantile}; "
              f"{what})", flush=True)
    lc, bc = cfg.model.lifter, cfg.model.backbone
    print(f"{phase}: {label} built in {time.perf_counter() - t0:.1f} s "
          f"(image {h}x{w}, {bc.kind} width {bc.width}, maps "
          f"{bc.feature_dims}, lifter embed {lc.embed_dim_ratio} depth "
          f"{lc.depth} deformable {lc.use_deformable}, "
          f"{cfg.model.compute_dtype}, quantize {bc.quantize})", flush=True)
    if inspect is not None:
        inspect(model, requests[0])

    _reset_counts()
    outs = []
    for i, req in enumerate(requests):
        before = _counts()
        outs.append(serve.lift(model, *req))
        torch.cuda.synchronize()
        grew = {k: v - before[k] for k, v in _counts().items()}
        if grew != _expected(per_request):
            raise AssertionError(f"{label} request {i}: kernel launches "
                                 f"{grew}, expected {per_request}")
    launches = _counts()
    for out in outs:
        if out.shape != (BATCH, 17, 3) or not torch.isfinite(out).all():
            raise AssertionError(f"{label}: bad output {tuple(out.shape)}, "
                                 f"finite={bool(torch.isfinite(out).all())}")
    if unprepared is not None:
        same = torch.equal(unprepared, outs[0])
        print(f"{phase}: {label}: the request served before prepare (weights"
              f" quantized each call) equals the prepared model's bit for "
              f"bit: {same}", flush=True)
        if not same:
            raise AssertionError(f"{label}: unprepared output differs")

    plain_cfg = replace(cfg, model=replace(cfg.model, lifter=replace(
        lc, sampler="gather", attention="einsum", attention_joint="einsum",
        mlp="einsum")))
    plain = serve.build_serving_model(
        plain_cfg, "cuda", generator=torch.Generator().manual_seed(1))
    plain.load_state_dict(model.state_dict())
    plain.backbone.int8_impl = "plain"  # K9, K10 and the float epilogue
    before = _counts()
    ref = serve.lift(plain, *requests[0])
    torch.cuda.synchronize()
    if _counts() != before:
        raise AssertionError(f"{label}: the plain path launched a kernel")
    rel = ((outs[0] - ref).pow(2).mean().sqrt()
           / ref.pow(2).mean().sqrt()).item()
    print(f"{phase}: {label}: {requests_n} request(s) of {BATCH} frames -> "
          f"{tuple(outs[0].shape)} finite; launches per request "
          f"{per_request}; kernel vs plain rel RMS {rel:.3e} (tol "
          f"{tol:.0e})", flush=True)
    if not rel <= tol:
        raise AssertionError(f"{label} rel RMS {rel:.3e} > {tol}")
    if quantized:  # the float slice drawn from the same seed: same weights
        floating = serve.build_serving_model(
            serve.slice_config(name), "cuda",
            generator=torch.Generator().manual_seed(0))
        flt = serve.lift(floating, *requests[0])
        rel_float = ((outs[0] - flt).pow(2).mean().sqrt()
                     / flt.pow(2).mean().sqrt()).item()
        print(f"{phase}: {label}: int8 vs the float bf16 slice of the same "
              f"weights: rel RMS {rel_float:.3e} (information only)",
              flush=True)
        del floating

    host_ms = []
    for m in (model, plain):
        serve.lift(m, *requests[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(timed):
            serve.lift(m, *requests[i % requests_n])
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3 / timed)
    print(f"{phase}: {label}: {host_ms[0]:.3f} ms a request, "
          f"{BATCH * 1e3 / host_ms[0]:.1f} frames/s with the kernels; "
          f"{host_ms[1]:.3f} ms, {BATCH * 1e3 / host_ms[1]:.1f} frames/s "
          f"plain (information only; host clock over {timed} "
          f"requests, batch {BATCH}, {card})", flush=True)
    _where_time_goes(phase, label, cfg, model, requests[0], host_ms[0],
                     f"batch {BATCH}, {card}")
    del model, plain
    torch.cuda.empty_cache()
    return launches


def _where_time_goes(phase, name, cfg, model, req, host_ms, tag):
    """Information only: device ms of one request's stages by CUDA events
    (normalize, backbone, lifter, each including the host's dispatch gaps),
    then over PROFILED requests under torch.profiler the device busy ms a
    request, the idle share of the unprofiled host time a request
    ``host_ms``, and the TOP_KERNELS kernels by device time."""
    import tempfile

    from contextaware_poseformer_tpu_torch import serve
    from contextaware_poseformer_tpu_torch.data import augment
    from contextaware_poseformer_tpu_torch.models.capf import (
        backbone_maps,
        crop_coords_to_grid,
        lifter_maps,
    )
    from contextaware_poseformer_tpu_torch.utils import profiling

    frames, kp, kpc = req
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode():
        events[0].record()
        images = augment.serving_images(frames, cfg.model.backbone,
                                        dtype=model.backbone.dtype)
        events[1].record()
        feats, scales = backbone_maps(model.backbone(images))
        events[2].record()
        model.lifter(kp, crop_coords_to_grid(kpc, cfg.model.image_shape),
                     lifter_maps(feats, cfg.model.lifter.compute_dtype),
                     feat_scales=scales)
        events[3].record()
    torch.cuda.synchronize()
    stages = [events[i].elapsed_time(events[i + 1]) for i in range(3)]
    print(f"{phase}: {name}: stages " + ", ".join(
        f"{stage} {ms:.3f} ms" for stage, ms in zip(
            ("normalize", "backbone", "lifter"), stages))
        + f" (CUDA events, one request; {tag})", flush=True)

    with tempfile.TemporaryDirectory() as d, profiling.trace(d) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            serve.lift(model, *req)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / PROFILED
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / PROFILED
    print(f"{phase}: {name}: device busy {busy_ms:.3f} ms a request, idle "
          f"{1 - busy_ms / host_ms:.1%} of the unprofiled {host_ms:.3f} ms "
          f"(torch.profiler over {PROFILED} requests, which took "
          f"{profiled_ms:.3f} ms each; {tag})", flush=True)
    for kern, names in SHARE_KERNELS.items():
        ms = sum(e.self_device_time_total for e in kernels
                 if any(n in e.key for n in names)) / 1e3 / PROFILED
        print(f"{phase}: {name}: {kern} {ms:.3f} ms a request, "
              f"{ms / busy_ms:.1%} of the device busy time ({tag})",
              flush=True)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:TOP_KERNELS]:
        print(f"{phase}: {name}: kernel "
              f"{e.self_device_time_total / 1e3 / PROFILED:.3f} ms "
              f"{e.count / PROFILED:.1f}x {e.key[:90]}", flush=True)


def _served_block(name):
    """Serve one request of ``slice_config(name)`` (random weights from seed
    0, batch BATCH) and return its first DeformableBlock with the inputs
    it received (tokens, ref, features), captured by a forward hook."""
    from contextaware_poseformer_tpu_torch import serve

    cfg = serve.slice_config(name)
    model = serve.build_serving_model(
        cfg, "cuda", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    h, w = cfg.model.image_shape
    req = (torch.randint(0, 256, (BATCH, h, w, 3), dtype=torch.uint8,
                         generator=gen).cuda(),
           (torch.rand(BATCH, 17, 2, generator=gen) * 2 - 1).cuda(),
           (torch.rand(BATCH, 17, 2, generator=gen) * w).cuda())
    block = model.lifter.context_block_0
    seen = []
    hook = block.register_forward_pre_hook(
        lambda _, args: seen.append(args[:3]))
    out = serve.lift(model, *req)
    torch.cuda.synchronize()
    hook.remove()
    if out.shape != (BATCH, 17, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: bad output {tuple(out.shape)}")
    tokens, ref, features = seen[0]
    return block, tokens, ref, list(features)


def _aggregate_work(maps, pts, weights, hd, border):
    """(bytes, {type: operations}) of one K7 call: the distinct tap rows,
    the points, weights, projections (W at the element size the kernel
    reads: bf16 W^T for bf16 maps, fp32 W for fp32 maps; the bias in fp32)
    and output; the least operations of the function, which pools before it
    projects: sum_s w_s (x_s W + b) = (sum_s w_s x_s) W + (sum_s w_s) b. So
    8 a sampled channel, 2 a channel for the weighted sum over ns, ns for
    the sum of a (joint, head) row's weights and 2 * hd for the bias times
    that sum and its add, all in fp32; and each row's C -> hd projection
    (2 * C * hd), in bf16 on bf16 maps (the tensor cores), else fp32."""
    b, levels = pts.shape[:2]
    flat = pts.reshape(b, levels, -1, 2)
    n = flat.shape[2]  # points a level and item
    ns = weights.shape[-1]
    rows = n // ns  # (joint, head) rows a level and item
    elem = maps[0].element_size()
    nbytes = flat.numel() * 4 + weights.numel() * 4
    nbytes += b * levels * rows * hd * elem
    ops, proj_ops = 0, 0
    for l, f in enumerate(maps):
        c = f.shape[-1]
        nbytes += _distinct_taps(f, flat[:, l], border) * c * elem
        nbytes += c * hd * elem + hd * 4
        ops += b * n * (8 * c + 2 * c) + b * rows * (ns + 2 * hd)
        proj_ops += b * rows * 2 * c * hd
    if maps[0].dtype == torch.bfloat16:
        return nbytes, {torch.float32: ops, torch.bfloat16: proj_ops}
    return nbytes, {torch.float32: ops + proj_ops}


def _aggregate_library_fn(maps, pos, weights, projs, biases, mode):
    """The library composition of a K7 call: per level ``F.grid_sample`` on
    the NCHW view, ``F.linear`` and the weighted ``einsum``."""
    b, levels, p, nh, ns = weights.shape
    grid = pos.to(maps[0].dtype)

    def run():
        outs = []
        for l, f in enumerate(maps):
            s = F.grid_sample(f.permute(0, 3, 1, 2), grid[:, l],
                              mode="bilinear", padding_mode=mode,
                              align_corners=True)  # (b, C, p, nh*ns)
            s = F.linear(s.permute(0, 2, 3, 1), projs[l].t().to(f.dtype),
                         biases[l].to(f.dtype))
            outs.append(torch.einsum(
                "bphs,bphsd->bphd", weights[:, l].to(f.dtype),
                s.reshape(b, p, nh, ns, -1)).reshape(b, p, -1))
        return torch.stack(outs, dim=1)

    return run


def _k8_cases(gen):
    """(case, dtype, map, points, padding) of K8 at full width, batch
    BATCH: the K8_CASES in bf16 and fp32, then the CPN level as int8."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        for case, dims, mode, per_item in K8_CASES:
            if dtype == torch.int8 and dims[2] != 256:
                continue
            if dtype == torch.int8:
                f = torch.randint(-127, 128, (BATCH, *dims), generator=gen,
                                  dtype=torch.int8).cuda()
            else:
                f = torch.randn(BATCH, *dims, generator=gen).to("cuda", dtype)
            pts = (torch.rand(BATCH, *per_item, 2, generator=gen) * 3
                   - 1.5).cuda()
            cases.append((case, dtype, f, pts, mode))
    return cases


def check_aggregate(results, card):
    """Phase 11: K8 and K7 through their public entries at full width (this
    phase's main path, its launches counted from 0), each against its plain
    version, with kernel, plain, library and bound times; the A/B of K7
    against the DeformableBlock's own route on the served h36m_cpn and
    h36m_hrnet_32 blocks; K1 on the packed offsets without a copy; K1 on
    int8 maps. Adds K7's and K8's JSON numbers to ``results`` (and the
    int8 error to K1's) and returns the path's launch counts. The launch
    floor of the timer (the library's empty kernel) is printed beside
    K8's lines."""
    from contextaware_poseformer_tpu_torch.ops import _build, deformable

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")
    results.update({k: dict.fromkeys(keys, 0.0) for k in ("K7", "K8")})
    largest = {}
    blocks = {name: _served_block(name) for name in AGGREGATE_PRESETS}
    torch.cuda.empty_cache()
    with torch.inference_mode():
        k8 = _k8_cases(torch.Generator().manual_seed(7))
        k7 = []  # (case, calls a smoke pass in the JSON, block, args, mode)
        for name, (block, tokens, ref, features) in blocks.items():
            weights, packed = block.sampling(tokens, ref)
            b, lp1, p, _ = tokens.shape
            pos = packed.reshape(b, lp1 - 1, p, -1, 2)
            levels = range(lp1 - 1)
            args = (features, pos, weights,
                    [block.embed_proj(l).kernel for l in levels],
                    [block.embed_proj(l).bias for l in levels])
            blocks[name] = (block, packed, args)
            k7.append((f"{name} block border", 1, block, args, "border"))
            if name == "h36m_cpn":
                k7.append((f"{name} block zeros", 0, None, args, "zeros"))
                k7.append((f"{name} block border", 0, None,
                           ([f.float() for f in features], *args[1:]),
                           "border"))

        # the main path: every K8 and K7 call once through its entry
        _reset_counts()
        k8_outs = []
        for case, dtype, f, pts, mode in k8:
            before = deformable.launches_k8
            k8_outs.append(deformable.sample_points(f, pts, mode))
            if deformable.launches_k8 != before + 1:
                raise AssertionError(f"K8 {case}: launches_k8 "
                                     f"{deformable.launches_k8 - before}")
        k7_outs = [deformable.deformable_aggregate(*args, mode)
                   for _, _, _, args, mode in k7]
        torch.cuda.synchronize()
        launches = _counts()
        want = {**_expected({}), "K7": len(k7), "K8": len(k8)}
        if launches != want:
            raise AssertionError(f"aggregate path launched {launches}, "
                                 f"expected {want}")

        # the launch floor of this timer: the library's empty kernel
        floor_ms = _median_ms(lambda: _build.empty_kernel(
            torch.device("cuda")))
        print(f"aggregate: the launch floor (an empty kernel of the same "
              f"library, one block of 32 threads, the same timer): "
              f"{floor_ms:.4f} ms ({card})", flush=True)
        for (case, dtype, f, pts, mode), out in zip(k8, k8_outs):
            def fn(f=f, pts=pts, mode=mode):
                return deformable.sample_points(f, pts, mode, impl="fused")

            def plain(f=f, pts=pts, mode=mode):
                return deformable.sample_points(f, pts, mode, impl="gather")

            ref = plain()
            err, rel = _err(out, ref)
            tol = TOL[torch.float32 if dtype == torch.float32
                      else torch.bfloat16]
            ms, plain_ms = _median_ms(fn), _median_ms(plain)
            lib_ms = None
            if dtype != torch.int8:
                lib_ms = _median_ms(_grid_sample_fn([f], pts[:, None], mode))
            work = _sampler_work([f], pts[:, None], None, mode == "border")
            bound_ms, by = _bound(*work, torch.float32 if dtype == torch.int8
                                  else dtype)
            name = str(dtype).removeprefix("torch.")
            lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
            print(f"aggregate: K8 {case} {name}"
                  f"{' -> bfloat16' if dtype == torch.int8 else ''}: "
                  f"max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:.0e}); "
                  f"kernel {ms:.4f} ms ({ms - floor_ms:+.4f} over the "
                  f"launch floor {floor_ms:.4f}), plain {plain_ms:.4f} ms, "
                  f"library {lib}, bound {bound_ms:.4f} ms ({by}: "
                  f"{work[0]} B, {work[1]} ops; {card})", flush=True)
            if not rel <= tol:
                raise AssertionError(f"K8 {case} {name}: rel error "
                                     f"{rel:.3e} > {tol:.0e}")
            res = results["K8"]
            if dtype != torch.float32:
                res["max_abs_err"] = max(res["max_abs_err"], err)
            if dtype == torch.bfloat16:
                _accumulate(res, largest, "K8", 1, ms, plain_ms, bound_ms,
                            by, lib_ms)

        for (case, calls, block, args, mode), out in zip(k7, k7_outs):
            dtype = args[0][0].dtype

            def fn(args=args, mode=mode):
                return deformable.deformable_aggregate(*args, mode)

            def plain(args=args, mode=mode):
                return deformable.aggregate_reference(*args, mode)

            ref = plain()
            err, rels = _level_errs(out, ref)
            rel = max(rels)
            ms, plain_ms = _median_ms(fn), _median_ms(plain)
            lib_fn = _aggregate_library_fn(*args, mode)
            lib_ms = _median_ms(lib_fn)
            lib_rels = _level_errs(lib_fn(), ref)[1]
            work = _aggregate_work(args[0], args[1], args[2],
                                   args[3][0].shape[1], mode == "border")
            bound_ms, by = _bound(*work, None)
            route = ""
            if block is not None:  # the block's own route: K1 + Linear + einsum
                def route_fn(block=block, args=args):
                    return block.pool(args[0], args[1], args[2])

                route_rels = _level_errs(route_fn(), ref)[1]
                route_err = max(route_rels)
                route_ms = _median_ms(route_fn)
                route = (f"; block route (K1 + embed_proj + einsum) "
                         f"{route_ms:.4f} ms, rel by level "
                         f"{_fmt_rels(route_rels)}")
            name = str(dtype).removeprefix("torch.")
            print(f"aggregate: K7 {case} {name} (b={BATCH}, "
                  f"{tuple(args[2].shape)} weights, maps "
                  f"{[tuple(f.shape[1:]) for f in args[0]]}): max_abs_err "
                  f"{err:.3e}, rel by level {_fmt_rels(rels)} (tol "
                  f"{TOL[dtype]:.0e} each); kernel {ms:.4f} ms{route}; "
                  f"plain {plain_ms:.4f} ms; library {lib_ms:.4f} ms (rel "
                  f"by level {_fmt_rels(lib_rels)}); bound "
                  f"{bound_ms:.4f} ms ({by}: {work[0]} B, "
                  f"{work[1].get(torch.float32, 0)} fp32 ops, "
                  f"{work[1].get(torch.bfloat16, 0)} bf16 ops; {card})",
                  flush=True)
            if not rel <= TOL[dtype] or (route and not route_err <= TOL[dtype]):
                raise AssertionError(f"K7 {case} {name}: rel error by level "
                                     f"{_fmt_rels(rels)}{route} > "
                                     f"{TOL[dtype]:.0e}")
            if dtype == torch.bfloat16:
                res = results["K7"]
                res["max_abs_err"] = max(res["max_abs_err"], err)
                _accumulate(res, largest, "K7", calls, ms, plain_ms,
                            bound_ms, by, lib_ms)

        # the packed probe: the block's packed offset rows reach K1 as they
        # are; the (b, L, p, nh*ns, 2) points are a view of them
        for name, (block, packed, args) in blocks.items():
            features, pos = args[0], args[1]
            handed = deformable._check_levels("sample_points_multi",
                                              features, pos, "border")
            ptrs = {packed.data_ptr(), pos.data_ptr(), handed.data_ptr()}
            if len(ptrs) != 1:
                raise AssertionError(f"{name}: the packed offsets were "
                                     f"copied before K1 ({ptrs})")
            hd = args[3][0].shape[1]
            pre = [block.pre_project and deformable.kernel_can_preproject(
                *f.shape[1:], hd, f.dtype) for f in features]
            projs = [w if on else None for w, on in zip(args[3], pre)]
            biases = [v if on else None for v, on in zip(args[4], pre)]
            k1_ms = _median_ms(lambda: deformable.sample_points_multi(
                features, pos, "border", True, projs, biases))
            print(f"aggregate: packed probe {name}: the packed offsets "
                  f"{tuple(packed.shape)}, the points {tuple(pos.shape)} and "
                  f"K1's input share storage at 0x{packed.data_ptr():x} (no "
                  f"copy); K1 on the view {k1_ms:.4f} ms ({card})",
                  flush=True)

        _check_int8_k1(results, card)
    for k in ("K7", "K8"):
        results[k]["bound_by"] = largest[k][1]
    del blocks, k8, k7, k8_outs, k7_outs
    torch.cuda.empty_cache()
    return launches


def _check_int8_k1(results, card):
    """K1 on the CPN serving pyramid as int8 maps (raw samples in bf16),
    the zeros 17-point call, against the plain version (fp32 samples)."""
    from contextaware_poseformer_tpu_torch.ops import deformable

    gen = torch.Generator().manual_seed(8)
    maps = [torch.randint(-127, 128, (BATCH, h, w, 256), generator=gen,
                          dtype=torch.int8).cuda() for h, w in LEVELS]
    pts = (torch.rand(BATCH, len(LEVELS), 17, 2, generator=gen) * 2.2
           - 1.1).cuda()

    def fn():
        return deformable.sample_points_multi(maps, pts, "zeros")

    def plain():
        return deformable.sample_points_multi_reference(maps, pts, "zeros")

    out, ref = fn(), plain()
    if {o.dtype for o in out} != {torch.bfloat16}:
        raise AssertionError(f"K1 int8: outputs {[o.dtype for o in out]}")
    err, rel = _err(out, ref)
    ms, plain_ms = _median_ms(fn), _median_ms(plain)
    work = _sampler_work(maps, pts, None, False)
    bound_ms, by = _bound(*work, torch.float32)
    tol = TOL[torch.bfloat16]
    print(f"aggregate: K1 int8 CPN zeros P=17 -> bfloat16: max_abs_err "
          f"{err:.3e} rel {rel:.3e} (tol {tol:.0e}); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: "
          f"{work[0]} B, {work[1]} ops; {card})", flush=True)
    if not rel <= tol:
        raise AssertionError(f"K1 int8: rel error {rel:.3e} > {tol:.0e}")
    results["K1"]["max_abs_err"] = max(results["K1"]["max_abs_err"], err)


def _edge_points(gen, *shape, lo=-1.5, hi=1.5):
    """Uniform points with some exactly on the edges and some past them."""
    pts = torch.rand(*shape, generator=gen) * (hi - lo) + lo
    flat = pts.view(-1, 2)
    flat[:6] = torch.tensor([[1, 1], [-1, -1], [1, -1], [-1, 1],
                             [1.25, 0.3], [-0.2, -1.2]])
    return pts.cuda()


def _backward_case(label, dtype, maps, pts, grads, mode, need_df):
    """K6 against the plain backward on one case: prints and checks the
    errors; returns (d(points) max abs error, kernel ms, plain ms)."""
    from contextaware_poseformer_tpu_torch.ops import deformable

    def fn():
        return deformable.sample_points_multi_backward(
            maps, pts, grads, mode, True, need_df)

    def plain():
        return deformable.sample_points_multi_backward_reference(
            maps, pts, grads, mode, True, need_df)

    (dfs, dpts), (rdfs, rdpts) = fn(), plain()
    torch.cuda.synchronize()
    errs = {"d(points)": _err(dpts, rdpts)}
    if need_df:
        errs["dF"] = _err(tuple(dfs), tuple(rdfs))
    ms, plain_ms = _median_ms(fn), _median_ms(plain)
    text = "; ".join(f"{k} max_abs_err {e:.3e} rel {r:.3e}"
                     for k, (e, r) in errs.items())
    print(f"backward: {label}: {text} (tol {TOL[dtype]:.0e}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    for k, (e, r) in errs.items():
        if not r <= TOL[dtype]:
            raise AssertionError(f"{label} {k}: rel error {r:.3e} > "
                                 f"{TOL[dtype]:.0e}")
    return errs["d(points)"][0], ms, plain_ms


def _grid_sample_backward_fn(maps, pts, grads, mode, need_df):
    """The library call for a K6 call: autograd's ``grid_sampler_2d_backward``
    per level. It takes the border clamp's gradient as 1 at an exact edge
    where K6 (the JAX package's ``jnp.clip``) takes 0.5."""
    b, levels = pts.shape[:2]
    grid = pts.reshape(b, levels, 1, -1, 2)
    pad = {"zeros": 0, "border": 1}[mode]

    def run():
        return [torch.ops.aten.grid_sampler_2d_backward(
            g.reshape(b, 1, -1, f.shape[-1]).permute(0, 3, 1, 2),
            f.permute(0, 3, 1, 2), grid[:, l], 0, pad, True,
            [need_df, True]) for l, (f, g) in enumerate(zip(maps, grads))]

    return run


def check_backward():
    """Phase 12: K6 against the plain backward. Returns K6's JSON numbers:
    the largest fp32 d(points) error of the training steps' calls (border,
    no dF) and the per-step times of the CPN's (batch TRAIN_BATCH; 4 calls
    a step); the HRNet calls' times are printed."""
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        gen = torch.Generator().manual_seed(4321)
        maps = [torch.randn(BATCH, 64, 48, 256, generator=gen).to(
            "cuda", dtype) for _ in range(4)]
        for mode, shape in (("border", (BATCH, 4, 17, 16, 2)),
                            ("zeros", (BATCH, 4, 17, 2))):
            pts = _edge_points(gen, *shape)
            grads = [torch.randn(BATCH, *shape[2:-1], 256, generator=gen)
                     .to("cuda", dtype) for _ in range(4)]
            for need_df in (True, False):
                _backward_case(
                    f"K6 {mode} P={math.prod(shape[2:-1])} {name} "
                    f"{'with' if need_df else 'without'} dF", dtype, maps,
                    pts, grads, mode, need_df)
        del maps

    # the training step's calls at their batches: fp32, border, no dF; the
    # CPN's four 64x48x256 maps, then HRNet-W32's and W48's pyramids
    cases = [("CPN", TRAIN_BATCH, ((64, 48, 256),) * 4)]
    cases += [(name, HRNET_TRAIN_BATCH, dims)
              for name, dims in HRNET_PYRAMIDS.items()]
    rows = {}
    for name, b, dims in cases:
        rows[name] = _train_backward_case(name, b, dims)
        torch.cuda.empty_cache()
    return {**rows["CPN"],
            "max_abs_err": max(r["max_abs_err"] for r in rows.values())}


def _train_backward_case(name, b, dims):
    """K6 at a training step's call (fp32, border, no dF, 4x272 points) on
    maps of ``dims`` at batch ``b``: checked and timed against the plain
    backward, the library call and the bound; returns K6's JSON numbers
    for a step (K6_CALLS_A_STEP calls)."""
    gen = torch.Generator("cuda").manual_seed(4321)
    maps = [torch.randn(b, h, w, c, device="cuda", generator=gen)
            for h, w, c in dims]
    pts = _edge_points(torch.Generator().manual_seed(4321), b, len(dims), 17,
                       16, 2)
    grads = [torch.randn(b, 17, 16, c, device="cuda", generator=gen)
             for _, _, c in dims]
    channels = "/".join(str(c) for _, _, c in dims)
    err, ms, plain_ms = _backward_case(
        f"K6 {name} border P=272 float32 without dF, batch {b}, C "
        f"{channels} (a training step's call)", torch.float32, maps, pts,
        grads, "border", False)
    lib_ms = _median_ms(_grid_sample_backward_fn(maps, pts, grads, "border",
                                                 False))
    # bytes: the distinct tap rows, the upstream gradients, the points in
    # and their gradients out; 16 operations a sampled channel
    nbytes, ops = 2 * pts.numel() * 4, 0
    for l, (f, g) in enumerate(zip(maps, grads)):
        nbytes += (_distinct_taps(f, pts.reshape(b, len(dims), -1, 2)[:, l],
                                  True) * f.shape[-1] * 4
                   + g.numel() * 4)
        ops += 16 * g.numel()
    bound_ms, by = _bound(nbytes, ops, torch.float32)
    calls = K6_CALLS_A_STEP
    print(f"backward: K6 {name} a step ({calls} calls): kernel "
          f"{calls * ms:.4f} ms, plain {calls * plain_ms:.4f} ms, library "
          f"{calls * lib_ms:.4f} ms, bound {calls * bound_ms:.4f} ms ({by}: "
          f"{nbytes} B, {ops} ops a call)", flush=True)
    return {"max_abs_err": err, "ms": calls * ms, "plain_ms": calls * plain_ms,
            "bound_ms": calls * bound_ms, "bound_by": by,
            "library_ms": calls * lib_ms}


def _kernels_vs_plain_step(tag, cfg, model, raw, task, per_step):
    """One deterministic train step of ``model`` through the kernels and one
    of a copy through the plain sampler (``sampler="gather"``), from the
    same weights on the same device batch ``raw``: the kernels' launches
    must be ``per_step`` and the plain run's none, the loss must agree to
    TRAIN_LOSS_RTOL and the lifter gradients to TRAIN_GRAD_REL_L2 (global
    relative L2). Returns the plain copy."""
    from contextaware_poseformer_tpu_torch.models.capf import (
        ContextAwarePoseFormer,
    )
    from contextaware_poseformer_tpu_torch.train import steps

    plain_cfg = replace(cfg, model=replace(cfg.model, lifter=replace(
        cfg.model.lifter, sampler="gather")))
    plain = ContextAwarePoseFormer(plain_cfg.model, device="cuda")
    plain.load_state_dict(model.state_dict())
    plain.backbone.to(memory_format=torch.channels_last)
    plain.backbone.requires_grad_(False)
    plain.backbone.int8_impl = "plain"  # the float epilogue's chain
    batch = steps.prepare(raw, cfg.model.backbone, task)
    results = []
    for m in (model, plain):
        before = _counts()
        m.zero_grad(set_to_none=True)
        loss = steps.loss_and_grads(m, cfg, batch, None, deterministic=True)
        torch.cuda.synchronize()
        grew = {k: v - before[k] for k, v in _counts().items()}
        results.append((loss.item(), [p.grad.clone() for p in
                                      m.lifter.parameters()], grew))
    del batch
    if results[0][2] != _expected(per_step) or any(results[1][2].values()):
        raise AssertionError(f"{tag}: deterministic step launches: kernels "
                             f"{results[0][2]}, plain {results[1][2]}")
    (loss_k, grads_k, _), (loss_p, grads_p, _) = results
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    num = sum((a - b).pow(2).sum() for a, b in zip(grads_k, grads_p))
    den = sum(b.pow(2).sum() for b in grads_p)
    grad_rel = (num.sqrt() / den.sqrt()).item()
    print(f"{tag}: deterministic step (batch {raw.images_u8.shape[0]}), "
          f"kernels vs plain sampler: loss {loss_k:.8f} vs {loss_p:.8f} (rel "
          f"{loss_rel:.3e}, tol {TRAIN_LOSS_RTOL:.0e}), lifter gradients "
          f"global rel L2 {grad_rel:.3e} (tol {TRAIN_GRAD_REL_L2:.0e})",
          flush=True)
    if not (loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_REL_L2):
        raise AssertionError(f"{tag}: kernels vs plain: loss rel "
                             f"{loss_rel:.3e}, gradient rel L2 {grad_rel:.3e}")
    return plain


def _losses_through_to_device(trainer, n_steps):
    """The first ``n_steps`` step losses of epoch 0 from a fresh state
    (the Trainer's seed), each batch copied by ``pipeline.to_device`` on
    the current stream, as the Trainer staged them before
    ``device_prefetch``."""
    from contextaware_poseformer_tpu_torch.data import pipeline
    from contextaware_poseformer_tpu_torch.train import steps

    cfg = trainer.cfg
    state = trainer.init_state(cfg.train.seed)
    losses = []
    for raw, _ in pipeline.batch_iterator(
            trainer.train_ds, cfg.train.batch_size, shuffle=True,
            seed=cfg.train.seed, epoch=0, num_workers=cfg.data.num_workers):
        m = steps.train_step(state, pipeline.to_device(raw, trainer.device),
                             cfg, trainer.task, cfg.train.seed + 1)
        losses.append(float(m["loss"]))
        if len(losses) == n_steps:
            break
    del state
    torch.cuda.empty_cache()
    return losses


def _intervals_union(spans):
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _h2d_overlap(name, trainer, state, n_steps, card):
    """Information: a warm epoch of ``n_steps`` under torch.profiler; the
    host-to-device copies by stream, and how much of their time overlaps
    kernels running on another stream."""
    import glob
    import tempfile

    from contextaware_poseformer_tpu_torch.utils import profiling

    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            trainer.train_epoch(state, 2, max_steps=n_steps)
            torch.cuda.synchronize()
        (path,) = glob.glob(f"{d}/trace_*.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copy_streams = sorted({e["args"].get("stream") for e in copies})
    kernel_streams = sorted({e["args"].get("stream") for e in kernels})
    overlap = total = 0.0
    for s in copy_streams:
        busy = _intervals_union(
            [(k["ts"], k["ts"] + k["dur"]) for k in kernels
             if k["args"].get("stream") != s])
        for c in copies:
            if c["args"].get("stream") != s:
                continue
            a, b = c["ts"], c["ts"] + c["dur"]
            total += b - a
            overlap += sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
    print(f"train: {name}: profiled warm epoch ({n_steps} steps): "
          f"{len(copies)} host-to-device copies, {total / 1e3:.3f} ms, on "
          f"stream(s) {copy_streams}; kernels on stream(s) {kernel_streams};"
          f" {overlap / 1e3:.3f} ms of the copies overlap kernels on another"
          f" stream: overlapping {overlap > 0} (torch.profiler; {card})",
          flush=True)


def check_train(card, run):
    """Phase 13: one TRAIN_RUNS entry through its CLI's own parsing at
    full width: steps through ``Trainer.train_epoch``, one flip-test eval
    batch, launch counts, a finite loss, a lifter that moved and a
    backbone that did not; with ``deterministic``, one deterministic step
    through the kernels against one through the plain sampler; steps/s
    (information). Returns the run's launch counts."""
    from contextaware_poseformer_tpu_torch.data import pipeline
    from contextaware_poseformer_tpu_torch.train import (
        steps, train_3dhp, train_h36m,
    )
    from contextaware_poseformer_tpu_torch.train.loop import Trainer

    name, batch, n_steps, per_step, per_eval, deterministic = run
    cli, trainer_cls = ((train_3dhp, train_3dhp.Trainer3dhp)
                           if name.startswith("mpi") else (train_h36m, Trainer))
    t0 = time.perf_counter()
    args = cli.build_argparser().parse_args(
        ["--preset", name, "--synthetic", "--device", "cuda"])
    train_h36m.check_args(args)
    cfg = cli.make_config(args)
    if cfg.train.batch_size != batch:
        raise AssertionError(f"{name} batch {cfg.train.batch_size}")
    train_ds, val_ds = cli.make_datasets(cfg, args)
    trainer = trainer_cls(cfg, train_ds, val_ds, "cuda")
    state = trainer.init_state(cfg.train.seed)
    lifter0 = [p.detach().clone() for p in state.model.lifter.parameters()]
    backbone0 = {k: v.clone()
                 for k, v in state.model.backbone.state_dict().items()}
    torch.cuda.synchronize()
    lc = cfg.model.lifter
    print(f"train: {name} built in {time.perf_counter() - t0:.1f} s "
          f"(image {cfg.model.image_shape}, batch {cfg.train.batch_size}, "
          f"lifter embed {lc.embed_dim_ratio} depth {lc.depth}, deformable "
          f"{lc.use_deformable}, drop-path {lc.drop_path_rate}, flip "
          f"{cfg.train.flip_aug}, {cfg.model.compute_dtype})", flush=True)

    _reset_counts()
    t0 = time.perf_counter()
    m = trainer.train_epoch(state, 0, max_steps=n_steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    if launches != _expected(per_step, n_steps):
        raise AssertionError(f"{name}: {n_steps} train steps launched "
                             f"{launches}, expected {per_step} a step")
    losses = m["step_losses"]
    if len(losses) != n_steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{name}: train losses {losses}")
    staged = _losses_through_to_device(trainer, n_steps)
    print(f"train: {name}: the Trainer's step losses (device_prefetch: "
          f"pinned staging, copies on a side stream) equal the same batches "
          f"through to_device from the same state: {staged == losses} "
          f"({[f'{v:.9g}' for v in staged]})", flush=True)
    if staged != losses:
        raise AssertionError(f"{name}: prefetched losses {losses}, "
                             f"to_device {staged}")
    _reset_counts()
    summary, _ = trainer.evaluate(state, max_batches=1)
    torch.cuda.synchronize()
    evaluated = _counts()
    if evaluated != _expected(per_eval):
        raise AssertionError(f"{name}: the flip-test batch launched "
                             f"{evaluated}")
    if not all(map(math.isfinite, summary.values())):
        raise AssertionError(f"{name}: eval summary {summary}")
    changed = any(not torch.equal(a, p.detach()) for a, p in
                  zip(lifter0, state.model.lifter.parameters()))
    frozen = all(torch.equal(backbone0[k], v) for k, v in
                 state.model.backbone.state_dict().items())
    del backbone0
    scores = ", ".join(f"{k} {v:.2f}" for k, v in summary.items())
    print(f"train: {name}: {n_steps} steps, losses "
          f"{[f'{v:.6f}' for v in losses]}, {n_steps / seconds:.2f} "
          f"steps/s (first steps included); launches {launches}; flip-test "
          f"batch {scores}, launches {evaluated}; lifter changed {changed}, "
          f"backbone bit-identical {frozen}", flush=True)
    if not (changed and frozen):
        raise AssertionError("the lifter must change and the backbone not")

    t0 = time.perf_counter()
    warm = trainer.train_epoch(state, 1, max_steps=n_steps)
    torch.cuda.synchronize()
    trainer_rate = n_steps / (time.perf_counter() - t0)
    if not all(map(math.isfinite, warm["step_losses"])):
        raise AssertionError(f"warm epoch losses {warm['step_losses']}")
    _h2d_overlap(name, trainer, state, n_steps, card)
    raw, _ = next(pipeline.batch_iterator(train_ds, cfg.train.batch_size,
                                          shuffle=False, num_workers=8))
    raw = pipeline.to_device(raw, "cuda")
    models = [state.model]

    if deterministic:
        models.append(_kernels_vs_plain_step(f"train: {name}", cfg,
                                             state.model, raw, trainer.task,
                                             per_step))

    rates = []
    for model in models:
        run_state = steps.TrainState(
            model, steps.make_optimizer(cfg, trainer.steps_per_epoch, model))
        steps.train_step(run_state, raw, cfg, trainer.task, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            steps.train_step(run_state, raw, cfg, trainer.task, 1)
        torch.cuda.synchronize()
        rates.append(3 / (time.perf_counter() - t0))
    plain_rate = (f", {rates[1]:.3f} steps/s with the plain sampler"
                  if deterministic else "")
    print(f"train: {name}: {trainer_rate:.3f} steps/s through the Trainer "
          f"(a warm epoch of {n_steps} steps, host batch assembly and copy "
          f"included); train_step on a device-resident batch: "
          f"{rates[0]:.3f} steps/s with the kernels{plain_rate} "
          f"(information only; batch {cfg.train.batch_size}, {card})",
          flush=True)
    del models, state, trainer
    torch.cuda.empty_cache()
    return {k: launches[k] + evaluated[k] for k in launches}


def _lifter_vector(model):
    return torch.cat([p.detach().reshape(-1).double()
                      for p in model.lifter.parameters()])


def _ddp_vs_plain(cfg, train_ds, val_ds, raws, card):
    """Phase 14a: PARALLEL_STEPS train steps of ``cfg`` on the device
    batches ``raws`` through a plain ``Trainer``'s state, then through one
    under DDP over NCCL with world size 1 (the process group joined
    in-process on a free port): the losses to PARALLEL_LOSS_RTOL, the
    lifter's parameters to PARALLEL_REL_L2; the DDP run's launch counts
    (returned) must be its steps'; steps/s of both on one batch
    (information)."""
    from contextaware_poseformer_tpu_torch.parallel import distributed, dryrun
    from contextaware_poseformer_tpu_torch.train import steps
    from contextaware_poseformer_tpu_torch.train.loop import Trainer

    def run():
        trainer = Trainer(cfg, train_ds, val_ds, "cuda")
        state = trainer.init_state(cfg.train.seed)
        torch.cuda.synchronize()
        _reset_counts()
        losses = [float(steps.train_step(state, raw, cfg, trainer.task,
                                         cfg.train.seed + 1)["loss"])
                  for raw in raws]
        torch.cuda.synchronize()
        counts = _counts()
        params = _lifter_vector(state.model)
        t0 = time.perf_counter()
        for _ in range(PARALLEL_STEPS):
            steps.train_step(state, raws[0], cfg, trainer.task, 1)
        torch.cuda.synchronize()
        rate = PARALLEL_STEPS / (time.perf_counter() - t0)
        return state.ddp is not None, losses, params, counts, rate

    plain = run()
    topo = distributed.initialize(
        "cuda", init_method=f"tcp://localhost:{dryrun.free_port()}", rank=0,
        world_size=1)
    try:
        backend = torch.distributed.get_backend()
        ddp = run()
    finally:
        distributed.shutdown()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(ddp[1], plain[1]))
    rel = ((ddp[2] - plain[2]).norm() / plain[2].norm()).item()
    print(f"parallel: h36m_cpn batch {cfg.train.batch_size} a rank, "
          f"{PARALLEL_STEPS} steps under DDP over {backend} (topology "
          f"{topo}, wrapped {ddp[0]}) vs the plain Trainer (wrapped "
          f"{plain[0]}): losses {[f'{v:.9g}' for v in ddp[1]]} vs "
          f"{[f'{v:.9g}' for v in plain[1]]} (max rel {loss_rel:.3e}, tol "
          f"{PARALLEL_LOSS_RTOL:.0e}); lifter parameters rel L2 {rel:.3e} "
          f"(tol {PARALLEL_REL_L2:.0e}); launches {ddp[3]} (plain "
          f"{plain[3]})", flush=True)
    print(f"parallel: train_step on a device-resident batch: "
          f"{ddp[4]:.3f} steps/s under DDP (world size 1), {plain[4]:.3f} "
          f"without (information only; batch {cfg.train.batch_size}, "
          f"{card})", flush=True)
    if not (ddp[0] and not plain[0] and backend == "nccl"):
        raise AssertionError("parallel: the DDP run must wrap over NCCL")
    if loss_rel > PARALLEL_LOSS_RTOL or rel > PARALLEL_REL_L2:
        raise AssertionError(f"parallel: DDP vs plain: loss rel {loss_rel}"
                             f", parameters rel L2 {rel}")
    if ddp[3] != plain[3] or ddp[3] != _expected(PARALLEL_PER_STEP,
                                                  PARALLEL_STEPS):
        raise AssertionError(f"parallel: launches {ddp[3]}, plain "
                             f"{plain[3]}, expected {PARALLEL_PER_STEP} a "
                             "step")
    return ddp[3]


def _dryrun_vs_one_process(nproc, backend, what, tp=1):
    """``parallel.dryrun.run`` of ``nproc`` ranks, ``tp`` a model group,
    over ``backend`` on the card(s) against ``dryrun.reference`` on the
    data ranks' rows in this process: each rank's (gathered) lifter
    parameters to PARALLEL_REL_L2, P1 to 1e-5 relative; the gather of 3
    and 2 rows (checked by ``dryrun.check``)."""
    from contextaware_poseformer_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    ranks = dryrun.run(nproc, "cuda", backend=backend,
                       steps=PARALLEL_DRYRUN_STEPS, timeout=300,
                       model_parallel=tp)
    ref = dryrun.reference(nproc // tp, "cuda", steps=PARALLEL_DRYRUN_STEPS)
    rels = [dryrun.rel_l2(r["params"], ref["params"]) for r in ranks]
    p1_rel = abs(ranks[0]["p1_mm"] - ref["p1_mm"]) / ref["p1_mm"]
    print(f"parallel: {what}: {nproc} ranks ({nproc // tp} data x {tp} "
          f"model) over {ranks[0]['backend']} (rank 0's topology "
          f"{ranks[0]['topology']}), tiny config, {PARALLEL_DRYRUN_STEPS} "
          f"steps, augmentation and dropout off: losses "
          f"{[f'{v:.6f}' for v in ranks[0]['losses']]} equal on every rank, "
          f"parameters equal on every rank; against one process on the "
          f"data ranks' rows: rel L2 {[f'{v:.3e}' for v in rels]} (tol "
          f"{PARALLEL_REL_L2:.0e}), P1 {ranks[0]['p1_mm']:.4f} vs "
          f"{ref['p1_mm']:.4f} mm (rel {p1_rel:.3e}); allgather_hosts of "
          f"3 and 2 rows: {ranks[0]['gathered'].tolist()} on every rank "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if max(rels) > PARALLEL_REL_L2 or p1_rel > 1e-5:
        raise AssertionError(f"parallel: {what}: rel L2 {rels}, P1 rel "
                             f"{p1_rel}")


def _tp_rank_job(rank, world, device, batch):
    """One rank of the full-width h36m_cpn run split over ``world`` ranks
    (a spawned process, set up by ``train_h36m``'s parsing with
    ``--distributed --model-parallel``): TP_STEPS steps on the preset's
    first batches, then TP_TIMED timed steps on the first; its losses, the
    whole lifter's parameters (gathered), launch counts of the checked
    steps, peak memory and steps/s."""
    from contextaware_poseformer_tpu_torch.parallel import dryrun
    from contextaware_poseformer_tpu_torch.train import steps
    from contextaware_poseformer_tpu_torch.train.loop import Trainer

    cfg, train_ds, val_ds, raws = _tp_setup(
        batch, ["--distributed", "--model-parallel", str(world)])
    trainer = Trainer(cfg, train_ds, val_ds, device, model_parallel=world)
    state = trainer.init_state(cfg.train.seed)
    torch.cuda.synchronize()
    _reset_counts()
    losses = [float(steps.train_step(state, raw, cfg, trainer.task,
                                     cfg.train.seed + 1)["loss"])
              for raw in raws]
    torch.cuda.synchronize()
    counts = _counts()
    params = dryrun.lifter_vector(state.model.lifter)
    t0 = time.perf_counter()
    for _ in range(TP_TIMED):
        steps.train_step(state, raws[0], cfg, trainer.task, 1)
    torch.cuda.synchronize()
    return {"losses": losses, "params": params, "counts": counts,
            "rate": TP_TIMED / (time.perf_counter() - t0),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _tp_setup(batch, extra_args=()):
    """h36m_cpn through ``train_h36m``'s parsing at ``batch``: the config,
    the synthetic sets and the first TP_STEPS batches on the card."""
    from contextaware_poseformer_tpu_torch.data import pipeline
    from contextaware_poseformer_tpu_torch.train import train_h36m

    args = train_h36m.build_argparser().parse_args(
        ["--preset", "h36m_cpn", "--synthetic", "--device", "cuda",
         "--batch-size", str(batch), *extra_args])
    cfg = train_h36m.make_config(args)
    train_ds, val_ds = train_h36m.make_datasets(cfg, args)
    it = pipeline.batch_iterator(train_ds, batch, shuffle=False,
                                 num_workers=8)
    raws = [pipeline.to_device(next(it)[0], "cuda") for _ in range(TP_STEPS)]
    return cfg, train_ds, val_ds, raws


def _tp_vs_plain(card):
    """Phase 14d: h36m_cpn at full width split over two gloo ranks on the
    card against the plain Trainer on the same batches, at the preset's
    batch. Returns the ranks' launch counts."""
    import functools

    from contextaware_poseformer_tpu_torch.parallel import dryrun
    from contextaware_poseformer_tpu_torch.train import steps
    from contextaware_poseformer_tpu_torch.train.loop import Trainer

    batch = TRAIN_BATCH
    t0 = time.perf_counter()
    ranks = dryrun.spawn(2, functools.partial(_tp_rank_job, batch=batch),
                         "cuda", backend="gloo", timeout=600)
    seconds = time.perf_counter() - t0
    cfg, train_ds, val_ds, raws = _tp_setup(batch)
    trainer = Trainer(cfg, train_ds, val_ds, "cuda")
    state = trainer.init_state(cfg.train.seed)
    plain = [float(steps.train_step(state, raw, cfg, trainer.task,
                                    cfg.train.seed + 1)["loss"])
             for raw in raws]
    params = dryrun.lifter_vector(state.model.lifter)
    del state, trainer, raws
    torch.cuda.empty_cache()
    want = _expected(PARALLEL_PER_STEP, TP_STEPS)
    for r in ranks:
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                          plain))
        rel = dryrun.rel_l2(r["params"], params)
        print(f"parallel: h36m_cpn tp=2 rank {r['rank']} (two gloo ranks on "
              f"one card, batch {batch}, {TP_STEPS} steps): losses "
              f"{[f'{v:.9g}' for v in r['losses']]} vs the plain Trainer's "
              f"{[f'{v:.9g}' for v in plain]} (max rel {loss_rel:.3e}, tol "
              f"{TP_LOSS_RTOL:.0e}); gathered lifter parameters rel L2 "
              f"{rel:.3e} (tol {TP_REL_L2:.0e}); launches {r['counts']}; "
              f"peak memory {r['peak_gb']:.2f} GB; {r['rate']:.3f} steps/s "
              f"on one batch (information only; {card})", flush=True)
        if loss_rel > TP_LOSS_RTOL or rel > TP_REL_L2:
            raise AssertionError(f"parallel: tp=2 rank {r['rank']}: loss "
                                 f"rel {loss_rel}, parameters rel L2 {rel}")
        if r["counts"] != want:
            raise AssertionError(f"parallel: tp=2 rank {r['rank']}: "
                                 f"launches {r['counts']}, expected "
                                 f"{PARALLEL_PER_STEP} a step")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError("parallel: tp=2: the ranks' losses differ")
    print(f"parallel: h36m_cpn tp=2 run {seconds:.1f} s (spawn, build, "
          f"steps)", flush=True)
    return _sum_counts([r["counts"] for r in ranks])


def check_parallel(card):
    """Phase 14: data- and tensor-parallel training. Returns the launch
    counts of the full-width DDP and tensor-parallel runs."""
    from contextaware_poseformer_tpu_torch.data import pipeline
    from contextaware_poseformer_tpu_torch.train import train_h36m

    args = train_h36m.build_argparser().parse_args(
        ["--preset", "h36m_cpn", "--synthetic", "--device", "cuda",
         "--distributed"])
    cfg = train_h36m.make_config(args)
    if cfg.train.batch_size != TRAIN_BATCH:
        raise AssertionError(f"h36m_cpn batch {cfg.train.batch_size}")
    train_ds, val_ds = train_h36m.make_datasets(cfg, args)
    it = pipeline.batch_iterator(train_ds, cfg.train.batch_size,
                                 shuffle=False, num_workers=8)
    raws = [pipeline.to_device(next(it)[0], "cuda")
            for _ in range(PARALLEL_STEPS)]
    counts = _ddp_vs_plain(cfg, train_ds, val_ds, raws, card)
    del raws
    torch.cuda.empty_cache()
    _dryrun_vs_one_process(2, "gloo", "two ranks on one card")
    n = torch.cuda.device_count()
    if n >= 2:
        _dryrun_vs_one_process(n, "nccl", "one rank a card")
    else:
        print(f"parallel: NCCL with one rank a card: not run ({n} card)",
              flush=True)
    tp_counts = _tp_vs_plain(card)
    _dryrun_vs_one_process(2, "gloo", "the tiny model split over two ranks "
                           "on one card", tp=2)
    if n >= 4:
        _dryrun_vs_one_process(4, "nccl", "dp=2 x tp=2, one rank a card",
                               tp=2)
    else:
        print(f"parallel: dp=2 x tp=2 over NCCL: not run ({n} card)",
              flush=True)
    return _sum_counts([counts, tp_counts])


def check_tools(card):
    """Phase 17: the port's tools. ``model_flops``: GFLOP a frame of every
    preset, equal to the committed ``FLOPS_torch.json`` and not above
    ``FLOPS.json`` (``model_flops.against_jax``); the
    main path (``deploy_config("h36m_cpn")``, batch 64, prepared on one
    seeded batch) over TOOLS_REQUESTS timed requests and its MFU, and one
    request profiled under ``trace_budget.annotate``: its budget's named
    buckets (not the fallback ones) must hold MIN_COVERAGE of device time;
    a ``train_bench`` burst of
    h36m_cpn at batch 256 (steps/s, MFU) with one profiled step, whose
    budget must too; ``demo`` writes a PNG of finite poses."""
    import tempfile

    import numpy as np

    from contextaware_poseformer_tpu_torch import config, serve
    from contextaware_poseformer_tpu_torch.tools import (
        demo, model_flops, trace_budget, train_bench,
    )
    from contextaware_poseformer_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    counts = model_flops.count_all()
    if counts != model_flops.load():
        raise AssertionError(f"tools: model_flops counts {counts}, not the "
                             "committed FLOPS_torch.json")
    dev = model_flops.against_jax(counts)
    served_flops = model_flops.count(
        serve.deploy_config("h36m_cpn").model)["gflops_per_frame"]
    print("tools: model_flops (the parity graph on the meta device, batch "
          f"{model_flops.BATCH}, XLA's per-op rules; "
          f"{time.perf_counter() - t0:.1f} s; equal to FLOPS_torch.json): "
          + "; ".join(f"{k} {v['gflops_per_frame']:.3f} GFLOP/frame "
                      f"({dev[k]:+.2%} vs FLOPS.json, XLA's optimized graph)"
                      for k, v in counts.items())
          + "; training steps " + ", ".join(
              f"{k} {v['train_gflops_per_frame']:.3f}"
              for k, v in counts.items())
          + f" GFLOP/frame; the h36m_cpn deploy graph {served_flops:.3f}",
          flush=True)

    cfg = serve.deploy_config("h36m_cpn")
    model = serve.build_serving_model(
        cfg, "cuda", generator=torch.Generator().manual_seed(0))
    h, w = cfg.model.image_shape
    gen = torch.Generator().manual_seed(0)
    serve.prepare(model, [torch.randint(0, 256, (BATCH, h, w, 3),
                                        dtype=torch.uint8,
                                        generator=gen).cuda()])
    req = (torch.randint(0, 256, (BATCH, h, w, 3), dtype=torch.uint8,
                         generator=gen).cuda(),
           (torch.rand(BATCH, 17, 2, generator=gen) * 2 - 1).cuda(),
           (torch.rand(BATCH, 17, 2, generator=gen) * w).cuda())
    for _ in range(2):
        serve.lift(model, *req)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(TOOLS_REQUESTS):
        out = serve.lift(model, *req)
    torch.cuda.synchronize()
    fps = BATCH * TOOLS_REQUESTS / (time.perf_counter() - t1)
    flops = served_flops
    # two profiling sessions, the second kept: late in this long process a
    # session's trace has been seen to lose the request's first kernels
    # (the stem conv among them: "backbone stem" 0 ms) where a fresh
    # process (tools/quantize_ab.py) traces them all
    traced = []
    for _ in range(2):
        with tempfile.TemporaryDirectory() as d:
            with trace_budget.annotate(model), profiling.trace(d):
                serve.lift(model, *req)
                torch.cuda.synchronize()
            (path,) = [os.path.join(d, f) for f in os.listdir(d)]
            traced.append(trace_budget.budget(trace_budget.load_trace(path)))
    served = traced[-1]
    print("tools: main-path request traced twice: " + "; ".join(
        f"{b['total_us'] / 1e3:.3f} ms of device time, backbone stem "
        f"{b['buckets'].get('backbone stem', 0.0) / 1e3:.3f} ms"
        for b in traced) + " (the second kept)", flush=True)
    if not torch.isfinite(out).all():
        raise AssertionError("tools: the main path's poses are not finite")
    print(f"tools: main path (h36m_cpn int8 deploy graph, batch {BATCH}): "
          f"{fps:.1f} frames/s over {TOOLS_REQUESTS} requests (host clock), "
          f"MFU {model_flops.mfu(flops, fps) * 100:.3f}% of the bf16 peak "
          f"at {flops:.3f} GFLOP/frame ({card})", flush=True)
    _print_budget("main-path request", served)
    print("tools: main-path request: " + ", ".join(
        f"{k} {served['buckets'].get(k, 0.0) / 1e3:.3f} ms" for k in
        ("int8 quantize", "backbone stem")) + f" ({card})", flush=True)
    del model, out
    torch.cuda.empty_cache()

    # the same request through the deploy graph with both serving knobs
    # (the fold stem K10s, the top-down hops K10u), traced as above
    knobs = replace(cfg, model=replace(cfg.model, backbone=replace(
        cfg.model.backbone, cpn_fold_normalize=True,
        cpn_int8_topdown=True)))
    model = serve.build_serving_model(
        knobs, "cuda", generator=torch.Generator().manual_seed(0))
    serve.prepare(model, [torch.randint(
        0, 256, (BATCH, h, w, 3), dtype=torch.uint8,
        generator=torch.Generator().manual_seed(1)).cuda()])
    for _ in range(2):
        serve.lift(model, *req)
    torch.cuda.synchronize()
    knob_traced = []
    for _ in range(2):
        with tempfile.TemporaryDirectory() as d:
            with trace_budget.annotate(model), profiling.trace(d):
                serve.lift(model, *req)
                torch.cuda.synchronize()
            (path,) = [os.path.join(d, f) for f in os.listdir(d)]
            knob_traced.append(trace_budget.budget(
                trace_budget.load_trace(path)))
    knob_served = knob_traced[-1]
    _print_budget("fold+topdown request", knob_served)
    print("tools: fold+topdown request: " + ", ".join(
        f"{k} {knob_served['buckets'].get(k, 0.0) / 1e3:.3f} ms" for k in
        ("backbone stem", "globalNet top-down (K10u)", "globalNet",
         "int8 quantize"))
        + f"; named {knob_served['named']:.2%} of its "
        f"{knob_served['total_us'] / 1e3:.3f} ms (the main path: "
        f"{served['named']:.2%} of {served['total_us'] / 1e3:.3f} ms) "
        f"({card})", flush=True)
    del model, req
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        r = train_bench.bench_batch(config.preset("h36m_cpn"), TRAIN_BATCH,
                                    torch.device("cuda"), iters=3, bursts=1,
                                    evaluate=False, trace_steps=(1, 2),
                                    logdir=d)
    print(f"tools: train_bench h36m_cpn batch {TRAIN_BATCH}: "
          f"{r['ms_per_step']:.1f} ms/step, {r['steps_per_s']:.3f} steps/s, "
          f"{r['frames_per_s']:.0f} frames/s, MFU {r['mfu'] * 100:.3f}% of "
          f"the fp32 peak at {r['train_gflops_per_frame']:.3f} GFLOP/frame "
          f"(one burst of 3 steps; {card})", flush=True)
    _print_budget("h36m_cpn training step", r["budget"])
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        png, preds = demo.main(["--out", os.path.join(d, "demo.png")])
        with open(png, "rb") as f:
            is_png = f.read(8) == b"\x89PNG\r\n\x1a\n"
    if not (is_png and np.isfinite(preds).all()):
        raise AssertionError("tools: demo wrote no PNG of finite poses")
    print(f"tools: demo: h36m_hrnet_32 float slice through StreamingLifter, "
          f"{len(preds)} synthetic frames, a PNG of finite poses", flush=True)
    for name, b in (("main-path request", served),
                    ("fold+topdown request", knob_served),
                    ("h36m_cpn training step", r["budget"])):
        if b["named"] < MIN_COVERAGE:
            raise AssertionError(f"tools: {name}: the trace budget's named "
                                 f"buckets hold {b['named']:.2%}")


def _print_budget(what, b):
    from contextaware_poseformer_tpu_torch.tools import trace_budget

    total = max(b["total_us"], 1e-9)
    print(f"tools: trace budget of one {what}: {b['total_us'] / 1e3:.3f} ms "
          f"of device time, {b['coverage']:.2%} attributed, "
          f"{b['named']:.2%} to named buckets ({b['catch_all']:.2%} to the "
          f"fallback buckets {', '.join(trace_budget.CATCH_ALL)}); "
          + ", ".join(f"{k} {v / 1e3:.3f} ms ({v / total:.1%})"
                      for k, v in b["buckets"].items()), flush=True)
    for k in list(b["buckets"])[:6]:
        print(f"tools: {what}: {k}: top kernels " + ", ".join(
            f"{n[:70]} {us / 1e3:.3f} ms" for n, us in b["top"][k]),
            flush=True)
    if b["unattributed"]:
        print(f"tools: {what}: unattributed kernels "
              + ", ".join(f"{k[:60]} {v:.1f} us" for k, v in
                          list(b["unattributed"].items())[:8]), flush=True)


def _rel_rms(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()


def _bn_stats(model):
    return torch.cat([t.detach().double().cpu().reshape(-1)
                      for n, t in model.state_dict().items()
                      if n.endswith(("running_mean", "running_var"))])


def _write_coco(directory, n_imgs):
    """A synthetic person_keypoints set of ``n_imgs`` random JPEG frames
    (cv2), one person each, and detections on them, as
    ``tests/test_cpn_coco.py`` builds its own."""
    import os

    import cv2
    import numpy as np

    rng = np.random.RandomState(0)
    images, anns, dets = [], [], []
    for i in range(n_imgs):
        w, h = 320, 256
        name = f"{i:012d}.jpg"
        cv2.imwrite(os.path.join(directory, name),
                    rng.randint(0, 255, (h, w, 3), np.uint8))
        images.append({"id": i, "file_name": name, "width": w, "height": h})
        kps = np.zeros((17, 3))
        kps[:, 0] = rng.uniform(80, 240, 17)
        kps[:, 1] = rng.uniform(40, 220, 17)
        kps[:, 2] = rng.randint(1, 3, 17)
        box = [70.0, 30.0, 180.0, 200.0]
        anns.append({"id": 100 + i, "image_id": i, "category_id": 1,
                     "keypoints": kps.reshape(-1).tolist(),
                     "num_keypoints": 17, "iscrowd": 0, "bbox": box,
                     "area": box[2] * box[3]})
        dets.append({"image_id": i, "bbox": box, "score": 0.9,
                     "category_id": 1})
    ann = os.path.join(directory, "ann.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    det_path = os.path.join(directory, "dets.json")
    with open(det_path, "w") as f:
        json.dump(dets, f)
    return ann, det_path


def check_coco(card):
    """Phase 15: the CPN COCO detector at full width."""
    import tempfile

    import numpy as np

    from contextaware_poseformer_tpu_torch.config import cpn_backbone
    from contextaware_poseformer_tpu_torch.data import coco as coco_data
    from contextaware_poseformer_tpu_torch.data import pipeline
    from contextaware_poseformer_tpu_torch.train import train_coco

    def batch_of(n, seed, device):
        b = next(train_coco._synthetic_batches(
            np.random.RandomState(seed), 1, n, coco_data.DATA_SHAPE))
        return pipeline.to_device(train_coco.host_batch(b), device)

    # the card against the CPU on the same weights, batch COCO_CHECK_BATCH
    model = train_coco.build_model(cpn_backbone(), "cuda", 0)
    cpu = train_coco.build_model(cpn_backbone(), "cpu", 0)
    cpu.load_state_dict(model.state_dict())
    host = batch_of(COCO_CHECK_BATCH, 1, "cpu")
    dev = batch_of(COCO_CHECK_BATCH, 1, "cuda")
    with torch.no_grad():
        outs = [m.eval()(b.image) for m, b in ((model, dev), (cpu, host))]
    rels = [_rel_rms(a, b) for a, b in
            zip([*outs[0][0], outs[0][1]], [*outs[1][0], outs[1][1]])]
    losses = []
    for m, b in ((model, dev), (cpu, host)):
        opt = train_coco.Optimizer(m.parameters(), 1)
        losses.append(float(train_coco.train_step(m, opt, b)["loss"]))
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    stats_rel = _rel_rms(_bn_stats(model), _bn_stats(cpu))
    print(f"coco: CPNCoco ResNet-50 {cpn_backbone().cpn_layers}, "
          f"{coco_data.DATA_SHAPE}, K={coco_data.NUM_JOINTS}, fp32, TF32 "
          f"off, random weights from seed 0; card vs CPU, batch "
          f"{COCO_CHECK_BATCH}: eval heads (4 global, refine) rel RMS "
          f"{[f'{v:.2e}' for v in rels]} (tol {COCO_REL:.0e}); one train "
          f"step: loss {losses[0]:.6f} vs {losses[1]:.6f} (rel "
          f"{loss_rel:.2e}), BN running statistics rel RMS {stats_rel:.2e}",
          flush=True)
    if max(rels) > COCO_REL or loss_rel > COCO_REL or stats_rel > COCO_REL:
        raise AssertionError(f"coco: card vs CPU: heads {rels}, loss "
                             f"{loss_rel}, BN statistics {stats_rel}")
    del cpu, outs

    # COCO_STEPS Adam steps at the recipe's batch on one repeated batch
    model = train_coco.build_model(cpn_backbone(), "cuda", 0)
    opt = train_coco.Optimizer(model.parameters(), 1000)
    dev = batch_of(train_coco.BATCH_SIZE, 2, "cuda")
    losses = [float(train_coco.train_step(model, opt, dev)["loss"])
              for _ in range(COCO_STEPS)]
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"coco: the loss must be finite and fall: "
                             f"{losses}")
    print(f"coco: {COCO_STEPS} Adam steps at batch {train_coco.BATCH_SIZE} "
          f"on one batch: losses {[f'{v:.3f}' for v in losses]}", flush=True)

    # information: warm steps and flip-test eval of the same model
    train_coco.eval_step(model, dev.image, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(COCO_TIMED):
        train_coco.train_step(model, opt, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(COCO_TIMED):
        train_coco.eval_step(model, dev.image, True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"coco: batch {train_coco.BATCH_SIZE}, warm, host clock over "
          f"{COCO_TIMED} with syncs: {1e3 * (t1 - t0) / COCO_TIMED:.2f} ms a "
          f"training step ({COCO_TIMED / (t1 - t0):.3f} steps/s), "
          f"{COCO_TIMED * train_coco.BATCH_SIZE / (t2 - t1):.1f} flip-test "
          f"eval frames/s (one forward of 2B) (information only; {card})",
          flush=True)
    del model, opt, dev
    torch.cuda.empty_cache()

    # the CLI's --eval on a synthetic person_keypoints set
    with tempfile.TemporaryDirectory() as d:
        ann, dets = _write_coco(d, COCO_EVAL_IMAGES)
        summary = train_coco.main(["--eval", "--device", "cuda", "--ann",
                                   ann, "--dets", dets, "--image-dir", d,
                                   "--batch", "4", "--flip",
                                   "--result", d])
        with open(f"{d}/result.json") as f:
            n_results = len(json.load(f))
    print(f"coco: train_coco --eval --flip on {COCO_EVAL_IMAGES} synthetic "
          f"frames: {n_results} results, " + ", ".join(
              f"{k} {v:.4f}" for k, v in summary.items()), flush=True)
    if not (math.isfinite(summary["AP"]) and 0.0 <= summary["AP"] <= 1.0
            and n_results == COCO_EVAL_IMAGES):
        raise AssertionError(f"coco: --eval summary {summary}")


def _gate_backbone(model, images):
    """The backbone maps and their int8 scales (None for float maps)."""
    from contextaware_poseformer_tpu_torch.models.capf import backbone_maps

    with torch.inference_mode():
        features, scales = backbone_maps(model.backbone(images))
    return list(features), list(scales or ())


def _lifter_entries():
    """{kernel: (module, its kernel entry, its plain version)} of the
    lifter's bf16 kernels, K1-K4."""
    from contextaware_poseformer_tpu_torch.ops import (
        deformable, fused_mlp, joint_attention, small_attention,
    )

    return {"K1": (deformable, "_launch_forward",
                   deformable.sample_points_multi_reference),
            "K2": (fused_mlp, "ln_mlp_residual_kernel",
                   fused_mlp.ln_mlp_reference),
            "K3": (small_attention, "small_attention_kernel",
                   small_attention.attention_reference),
            "K4": (joint_attention, "attention_middle_kernel",
                   joint_attention.attention_middle_reference)}


def _cloned(v):
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, (list, tuple)):
        return type(v)(_cloned(t) for t in v)
    return v


def _record_lifter_calls(run):
    """``run()`` with K1-K4's kernel entries recording a copy of each
    call's arguments: {kernel: [args, ...]}."""
    entries = _lifter_entries()
    calls = {k: [] for k in entries}
    real = {k: getattr(mod, attr) for k, (mod, attr, _) in entries.items()}

    def recorder(k):
        def record(*args):
            calls[k].append(_cloned(args))
            return real[k](*args)
        return record

    for k, (mod, attr, _) in entries.items():
        setattr(mod, attr, recorder(k))
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        for k, (mod, attr, _) in entries.items():
            setattr(mod, attr, real[k])
    return out, calls


def _replay_lifter_calls(calls):
    """Each recorded call again through its kernel and its plain version:
    {kernel: (calls, largest error / max|plain| over the calls and, for
    K1, its levels, the first call's leading shape)}."""
    entries = _lifter_entries()
    res = {}
    for k, recorded in calls.items():
        mod, attr, plain = entries[k]
        worst = 0.0
        for args in recorded:
            with torch.no_grad():
                out, ref = getattr(mod, attr)(*args), plain(*args)
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            worst = max([worst] + [_err(o, r)[1] for o, r in zip(outs, refs)])
        if recorded:
            first = recorded[0][0]
            shape = ([tuple(f.shape[1:]) for f in first] if k == "K1"
                     else tuple(first.shape))
            res[k] = (len(recorded), worst, shape)
    return res


def _gate_deploy_check(name, trainer, state, needed):
    """One validation batch of the gate's calibrated deploy model: each of
    its K1-K4 calls against the plain version to the bf16 tolerance; its
    backbone maps through the kernels against K9's and K10's plain versions
    and, on HRNet, against ``config.deploy``'s per-conv layer1, bit for bit;
    its flip-test predictions against those of the same model with the
    plain lifter knobs and, as their yardstick, with the plain lifter in
    fp32. The tiny bf16 lifter amplifies rounding: on an H100 both bf16
    routes sat 3-6% (relative RMS) from the fp32 lifter and 3% from each
    other (the sampler's rounding, per call 0.6% of max|plain|), so the
    kernels' route may sit no more than SLICE_REL_RMS farther from the fp32
    lifter than the plain bf16 route does. Every kernel of ``needed`` must
    launch in the kernels' run and none in the plain runs."""
    from contextaware_poseformer_tpu_torch import serve
    from contextaware_poseformer_tpu_torch.data import pipeline
    from contextaware_poseformer_tpu_torch.data.augment import (
        serving_images,
    )
    from contextaware_poseformer_tpu_torch.train import steps

    cfg, model = trainer.cfg, state.model
    lc, bc = cfg.model.lifter, cfg.model.backbone
    raw, _ = next(pipeline.batch_iterator(trainer.val_ds, cfg.train.batch_size,
                                          shuffle=False, num_workers=1))
    raw = pipeline.to_device(raw, "cuda")
    images = serving_images(raw.images_u8, bc, dtype=model.backbone.dtype)

    def copy(model_cfg):
        m = serve.build_serving_model(
            replace(cfg, model=model_cfg), "cuda",
            generator=torch.Generator().manual_seed(1))
        m.load_state_dict(model.state_dict())
        return m

    plain_cfg = replace(cfg, model=replace(cfg.model, lifter=replace(
        lc, sampler="gather", attention="einsum", attention_joint="einsum",
        mlp="einsum")))
    fp32_cfg = replace(plain_cfg, model=replace(
        plain_cfg.model, lifter=replace(plain_cfg.model.lifter,
                                        compute_dtype="float32")))
    plain, fp32 = copy(plain_cfg.model), copy(fp32_cfg.model)
    for m in (plain, fp32):
        m.backbone.int8_impl = "plain"
    other = {"plain": plain}
    if bc.kind == "hrnet":
        other["config.deploy layer1"] = copy(replace(
            cfg.model, backbone=replace(bc, layer1_impl="xla")))
    before = _counts()
    maps = _gate_backbone(model, images)
    pred, calls = _record_lifter_calls(
        lambda: steps.eval_step(model, raw, cfg, trainer.task)[0])
    grew = {k: v - before[k] for k, v in _counts().items()}
    missing = [k for k in needed if not grew[k]]
    if missing:
        raise AssertionError(f"gate {name}: {missing} never launched in the "
                             f"deploy batch ({grew})")
    replayed = _replay_lifter_calls(calls)
    equal = {}
    for label, m in other.items():
        got = _gate_backbone(m, images)
        eq = [_exact(a, b)[0] for a, b in zip(maps[0] + maps[1],
                                              got[0] + got[1])]
        equal[label] = min(eq)
    before = _counts()
    ref = steps.eval_step(plain, raw, plain_cfg, trainer.task)[0]
    ref32 = steps.eval_step(fp32, raw, fp32_cfg, trainer.task)[0]
    torch.cuda.synchronize()
    if _counts() != before:
        raise AssertionError(f"gate {name}: the plain path launched a kernel")

    def rms(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()

    err, rel = _err(pred, ref)
    to_plain, to_fp32, plain_fp32 = (rms(pred, ref), rms(pred, ref32),
                                     rms(ref, ref32))
    tol = TOL[torch.bfloat16]
    print(f"gate: {name}: one deploy batch ({raw.images_u8.shape[0]} frames, "
          f"flip test; maps {[tuple(f.shape[1:]) for f in maps[0]]} "
          f"{maps[0][0].dtype}, lifter embed {lc.embed_dim_ratio}, sampler "
          f"head dim {lc.embed_dim_ratio // lc.deform_heads}): launches "
          f"{grew}; each call against its plain version, error / "
          f"max|plain| (tol {tol:.0e}): "
          + ", ".join(f"{k} {n} calls at {shape} {worst:.3e}"
                      for k, (n, worst, shape) in replayed.items())
          + "; backbone maps equal share vs "
          + ", ".join(f"{k} {v:.6f}" for k, v in equal.items())
          + f"; predictions vs the plain bf16 lifter max_abs_err {err:.3e} "
          f"rel {rel:.3e}, rel RMS {to_plain:.3e}; vs the fp32 lifter rel "
          f"RMS {to_fp32:.3e}, the plain bf16 lifter's {plain_fp32:.3e} "
          f"(limit + {SLICE_REL_RMS:.0e})", flush=True)
    if (any(v != 1.0 for v in equal.values())
            or any(not w <= tol for _, w, _ in replayed.values())
            or not to_fp32 <= plain_fp32 + SLICE_REL_RMS):
        raise AssertionError(f"gate {name}: kernels vs plain: equal {equal}, "
                             f"calls {replayed}, rel RMS to the fp32 lifter "
                             f"{to_fp32:.3e} (plain bf16 {plain_fp32:.3e})")
    del plain, fp32, other


def check_gate(card):
    """Phase 16: the deploy-numerics gate (``deploy_numerics.preset_gate``)
    for one preset of each tiny class: fp32 P1, the deploy stack's P1 and
    the delta, within GATE_MAX_DELTA_MM either way; each gate's launches
    counted from 0 (training: K1 and K6 a step as GATE_PRESETS says; the
    evaluations K1 and, on the deploy stack, K2-K4, K9, K10 and K10q);
    for the CPN also the deploy stack with each serving knob
    (``deploy_numerics.KNOBS``: K10s, K10u), each P1's delta against fp32
    within the same limit; then, on the gate's trained models, the kernels
    against their plain versions at the gate's shapes (launches not
    counted). Returns the launches summed over the gates."""
    from contextaware_poseformer_tpu_torch import deploy_numerics
    from contextaware_poseformer_tpu_torch.data import pipeline

    total = dict.fromkeys(_counters(), 0)
    for name, (per_step, needed) in GATE_PRESETS.items():
        run = {}

        def inspect(fp32, deploy, name=name, per_step=per_step,
                    needed=needed, run=run):
            torch.cuda.synchronize()
            run["counts"] = _counts()
            trainer, state = fp32
            raw, _ = next(pipeline.batch_iterator(
                trainer.train_ds, trainer.cfg.train.batch_size,
                shuffle=False, num_workers=1))
            _kernels_vs_plain_step(f"gate: {name}", trainer.cfg, state.model,
                                   pipeline.to_device(raw, "cuda"),
                                   trainer.task, per_step)
            _gate_deploy_check(name, *deploy, needed)

        _reset_counts()
        t0 = time.perf_counter()
        row = deploy_numerics.preset_gate(name, GATE_STEPS, "cuda",
                                          inspect=inspect)
        counts = run["counts"]
        for k, v in counts.items():
            total[k] += v
        delta = row["tiny_trained_delta_mm"]
        print(f"gate: {name}: {GATE_STEPS} steps, fp32 P1 "
              f"{row['tiny_trained_fp32_p1_mm']:.4f} mm, deploy P1 "
              f"{row['tiny_trained_deploy_p1_mm']:.4f} mm, delta "
              f"{delta:+.4f} mm (limit +-{GATE_MAX_DELTA_MM} mm); launches "
              f"{counts}; {time.perf_counter() - t0:.1f} s ({card})",
              flush=True)
        knob_kernels = ("K10s", "K10u") if name == "h36m_cpn" else ()
        if not all(counts[k] for k in knob_kernels):
            raise AssertionError(f"gate {name}: the knobs' evaluations "
                                 f"launched {counts}")
        for short, knob in deploy_numerics.KNOBS.items():
            if f"tiny_trained_{short}_delta_mm" not in row:
                continue
            kd = row[f"tiny_trained_{short}_delta_mm"]
            print(f"gate: {name}: deploy with {knob}: P1 "
                  f"{row[f'tiny_trained_deploy_{short}_p1_mm']:.4f} mm, "
                  f"delta vs fp32 {kd:+.4f} mm (limit "
                  f"+-{GATE_MAX_DELTA_MM} mm), vs the deploy stack "
                  f"{kd - delta:+.4f} mm ({card})", flush=True)
            if not abs(kd) <= GATE_MAX_DELTA_MM:
                raise AssertionError(f"gate {name} {knob}: {row}")
        missing = [k for k in needed if not counts[k]]
        if missing or counts["K6"] != GATE_STEPS * per_step.get("K6", 0):
            raise AssertionError(f"gate {name}: launches {counts}")
        if not (abs(delta) <= GATE_MAX_DELTA_MM
                and math.isfinite(row["tiny_trained_fp32_p1_mm"])):
            raise AssertionError(f"gate {name}: {row}")
    return total


def ptxas_usage(log):
    """{kernel: (registers, spill store bytes)} from nvcc's ``-Xptxas -v``
    output."""
    usage, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
            usage[fn] = (0, 0)
        elif fn and "spill stores" in ln:
            spills = int(ln.split("bytes spill stores")[0].split()[-1])
            usage[fn] = (usage[fn][0], spills)
        elif fn and "Used" in ln and "registers" in ln:
            usage[fn] = (int(ln.split("Used ")[1].split()[0]), usage[fn][1])
    return usage


def check_spills(log):
    """Fail if a build of NO_SPILLS spills registers; print each one's."""
    for fn, (regs, spills) in ptxas_usage(log).items():
        if any(k in fn for k in NO_SPILLS):
            print(f"build: {fn[-72:]}: {regs} registers, {spills} bytes "
                  "spill stores", flush=True)
            if spills:
                raise AssertionError(f"build: {fn} spills {spills} bytes")


def check_sass(path):
    """Count, with ``cuobjdump -sass``, the SASS instructions of SASS_OPS in
    each K1, K2, K3, K7, K9 and K10 kernel of the built library, print
    them, and fail unless each kernel of SASS_REQUIRED holds what it must.
    Prints
    "not measured" where the toolkit has no cuobjdump."""
    import shutil
    from pathlib import Path

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("sass: not measured (no cuobjdump)", flush=True)
        return
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op in SASS_OPS:
                if op in line:
                    counts[fn][op] += 1
    for kern, parts, required in SASS_REQUIRED:
        found = [(f, c) for f, c in counts.items()
                 if all(p in f for p in parts)]
        if not found:
            raise AssertionError(f"sass: no {kern} kernel matching {parts}")
        for f, c in found:
            held = " ".join(f"{op} {n}" for op, n in c.items() if n)
            print(f"sass: {kern} {f[:100]}: {held or 'none'}", flush=True)
            for ops in required:
                if not any(c[op] for op in ops):
                    raise AssertionError(
                        f"sass: {kern} {f} holds none of {ops}")


class _PhaseClock:
    """Seconds each phase took (host clock), printed as it ends and summed
    by phase at the end."""

    def __init__(self):
        self.seconds = {}

    def __call__(self, phase, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        dt = time.perf_counter() - t0
        self.seconds[phase] = self.seconds.get(phase, 0.0) + dt
        print(f"{phase}: phase step took {dt:.1f} s", flush=True)
        return out

    def report(self):
        print("phases: " + ", ".join(f"{p} {t:.1f} s" for p, t in
                                     self.seconds.items()), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke run needs "
                         "an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(f"device: torch {torch.__version__} CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    print(smi, flush=True)

    from contextaware_poseformer_tpu_torch.ops import _build

    # fp32 at full precision: TF32 off for cuDNN convolutions (PyTorch's
    # default is on) and for cuBLAS matmuls (default off)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    path, seconds = _build.build()
    log = path.with_suffix(".log")
    usage = [ln.strip() for ln in log.read_text().splitlines()
             if any(w in ln for w in ("entry function", "registers", "spill"))
             ] if log.exists() else []
    print(f"build: {seconds:.1f} s -> {path.name}", flush=True)
    for ln in usage:
        print(f"build: {ln}", flush=True)
    if log.exists():
        check_spills(log.read_text())
    check_sass(path)

    clock = _PhaseClock()
    results = clock("kernels", check_kernels)
    results["conv_epilogue"] = clock("kernels", check_conv_epilogue)
    served = [clock("slice", check_serving, "h36m_cpn", REQUESTS, card)]
    served.append(clock("fp32_lifter", check_serving, "h36m_cpn", REQUESTS,
                        card, timed=FP32_LIFTER_TIMED,
                        lifter_dtype="float32"))
    served += [clock("hrnet", check_serving, name, n, card)
               for name, n in HRNET_REQUESTS.items()]
    results.update(clock("int8", check_int8_kernels, card))
    served += [clock("int8", check_serving, name, n, card, int8=True)
               for name, n in HRNET_REQUESTS.items()]
    served.append(clock("cpn_int8", check_cpn_int8, results, card))
    served.append(clock("quantize", check_quantize, card))
    served.append(clock("fp32_int8", check_fp32_int8, results, card))
    served.append(clock("cpn_knobs", check_cpn_knobs, results, card))
    served.append(clock("streaming", check_streaming, card))
    probes = clock("probes", check_probes, card)
    served.append(clock("aggregate", check_aggregate, results, card))
    results["K6"] = clock("backward", check_backward)
    trained = [clock("train", check_train, card, run) for run in TRAIN_RUNS]
    trained.append(clock("parallel", check_parallel, card))
    clock("coco", check_coco, card)
    trained.append(clock("gate", check_gate, card))
    clock("tools", check_tools, card)
    clock.report()
    kernels = [
        {"name": k, "route": "cuda", "source": CSRC + SOURCES[k],
         "replaces": REPLACES[k],
         "launches": sum(s[k] for s in served + trained), **results[k]}
        for k in _counters()
    ] + [
        {"name": f"probe {k}", "route": "cuda", "source": CSRC + SOURCES[k],
         "replaces": REPLACES[k], **v}
        for k, v in probes.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
