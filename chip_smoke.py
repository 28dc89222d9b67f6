#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA
GPU: builds the port's kernels from this checkout, holds each against its
plain PyTorch version at the shapes of the serving and training paths,
serves GPT-2 small through the paged-KV engine (its steps captured in
CUDA graphs, beside the same steps run eagerly), trains it for ten steps
through the LM trainer, trains ResNet-50 for ten steps through the
ImageNet trainer (its default, every convolution in the port's conv
kernels; then with ``--no-pallas-conv``), both trainers replaying a
captured step, serves and trains GPT-2 small at amp O4 through the int8
quantized-matmul kernel, drives the ``[B, T, S]`` bias gradient through
``flash_attention``, runs the trainers' K-step windows from CUDA graphs
against eager steps, trains BERT-base at O2 with the leafwise and the
bucketed Adam and the bucketed LAMB, trains it again through the
imperative amp API (``amp.initialize``, ``scale_loss``, ``FusedAdam``,
``FusedLAMB``), trains the DCGAN pair with three loss scalers in both
of its trainer's modes, checks the card's answers against the CPU's,
trains ResNet-50 from a directory of images killed and resumed, resumes
the LM trainer from its checkpoint, hot-swaps trained weights into a
serving engine, trains ResNet-50 data parallel, records, exports and
reads back the run telemetry of the LM trainer and the serving engine,
and runs the profiling stages (capture, parse, analysis, roofline, the
memory ledger, capture counts) over the LM and ResNet-50 steps.

    python3 chip_smoke.py [--out results.json] [--was PARENT_CHECKOUT]

Phases (any failure ends the run with a non-zero exit and no result
line):

1. the card's name and power limit (``nvidia-smi``); TF32 off, so fp32
   products are fp32;
2. build the nine CUDA libraries (the flash forward's wgmma kernel;
   its decode kernel; its other routes; flash dQ and dK/dV's wgmma kernels; their other
   routes and the bias gradient; the conv kernels' wgmma routes
   (forward, dgrad, wgrad); their other routes; the int8 quantized
   matmul's wgmma kernel; its decode and ``mma.sync`` routes: one
   ``nvcc`` each) and compile the Triton kernels
   (LayerNorm, BN epilogue and cross-entropy, forward and backward, one
   after another), all concurrently, time each and print ``ptxas``'s
   registers and spills;
3. LayerNorm kernel vs plain at ``[1024, 768]``, ``[8, 768]``, the LM
   step's ``[8184, 768]`` and the BERT step's ``[2048, 768]``, bf16 and
   fp32, and rows of mean 100 (the kernel's single-pass variance
   follows the plain version's, not the two-pass one);
4. flash kernel vs plain at gpt2_small shapes: prefill with a
   ``[B, T, S]`` bias, full causal, decode (``q_len = 1``, key padding
   bias: the decode kernel) at serving's two buckets (1024 and 256 keys),
   GQA (12 query heads over 4 KV heads) causal and decode, a 256-key
   window, fp32, the LM's B 8, T 1023 causal call, fp16 (prefill and
   decode), head widths 16, 48, 256, 320 and 512 (the last two in
   256-wide slices of the 256 kernel), the BERT step's B 16, T 128 with
   every key visible, and width 128; each case names the route that
   served it (``flash_fwd_kernel.routes``), and where that is the wgmma
   kernel the ``mma.sync`` rule's tile (64 x 64) is timed on the same
   inputs beside it, and must be slower at the bf16/fp16 width-64 causal
   and bias cases; where it is the decode kernel the split-KV kernels
   (``route="split"``) run on the same inputs under the same gates and
   are timed beside it (their difference printed) and must be slower at
   the four decode cases, and the decode kernel runs again with its
   cluster merge off (the ticket's merge, gated and timed); with
   ``--was`` the other checkout's forward is timed beside each case; 4b.
   with ``--was``, the flash kernels of this checkout and the other one
   at widths up to 256 on the same inputs, compared bit for bit, forward
   and backward apart (printed, not a gate).
   ``library_ms`` times one
   PyTorch call computing the same function (``F.layer_norm``,
   ``F.scaled_dot_product_attention``) as a yardstick only; the port
   never calls it;
5. serving: gpt2_small in bf16, buckets (256, 1024), page 16, 8 slots,
   16 requests of 32-900 prompt tokens and 32 new tokens through the
   captured engine, with every launch counter set to 0 just before the
   engine is made and read after it served (each kernel's count the
   per-forward count times the forwards that ran on the card: the
   warmup's warm run of prefill and decode for each bucket, and every
   replay; a replay adds the launches its graph recorded, the capture
   adds none; 4 graphs at warmup, no capture and no AOT miss while
   serving, one replay a step; every prefill forward on the wgmma
   route, every decode step's on the decode kernel and none on
   split-KV, 12 each a forward, counted as the launches are), then the
   same load through the eager bodies: greedy tokens equal bit for bit,
   tokens/s, TTFT and TPOT p50/p99, host ms a step and the bytes of the
   graphs' memory pool, both ways; then a
   256-token prefill's logits on the card against the CPU port in fp32,
   and gpt_tiny served in fp32 on the card and on the CPU with equal
   greedy tokens (a mismatch is allowed only where the CPU's top-2 logit
   gap at that step is below 1e-4); with ``--was`` the same load through
   the other checkout's captured engine and this one's, alternated (was,
   this, this, was, twice), every run's tokens/s and TPOT printed (no
   gate; phase 17 the same for O4);
6. where the time goes: one serving run traced with ``torch.profiler``
   (device busy and idle share, host and device time per prefill and
   decode step, kernels a step, device time by kernel kind), captured
   and eager;
7. LayerNorm backward kernel vs plain at ``[8184, 768]`` (8 x 1023
   training rows) and ``[8, 768]``, bf16 and fp32, and the BERT step's
   ``[2048, 768]`` bf16; ``library_ms`` is one
   ``aten.native_layer_norm_backward`` call computing dx;
8. flash dQ and dK/dV kernels vs plain at gpt2_small training shapes (B
   8, T 1023, 12 heads of 64, causal, bf16), GQA 12/4, a 256-key window,
   fp32, a key-padding bias that needs a gradient, fp16, head widths 16,
   48, 128 and 256, 320 and 512 (B 1, T 1024), a ``[B, T, S]`` bias, and
   causal cross attention (q_len
   333, kv_len 1021: the queries the suffix of the keys), and the BERT
   step's B 16, T 128 with every key visible; each case names the route
   that served it (``flash_bwd_dq_kernel.routes``,
   ``flash_bwd_dkv_kernel.routes``), and where that is the wgmma
   kernels the ``mma.sync`` kernels run on the same inputs, held to the
   plain version too and timed beside them (slower at the width-64 bf16
   and fp16 causal cases and width 128); with
   ``--was`` the other checkout's kernels are timed beside each case;
   ``library_ms`` is the backward of one SDPA call (``torch.autograd.
   grad`` on a retained graph), captured in a CUDA graph of 5 calls as
   the kernels are, its eager time beside it;
9. training: the LM trainer (``apex_tpu_torch.examples.lm.main_amp``)
   on GPT-2 small, bf16 O2, Adam lr 3e-4, weight decay 0.1, static loss
   scale 1.0, the fused loss, B 8, seq_len 1024, 10 steps replayed from
   the graph of one step (``--steps-per-call 1``), every launch counter
   set to 0 just before and read just after (25 LN forward and backward,
   12 flash forward, dQ and dK/dV, 1 cross-entropy forward and backward
   per step of the warm run and of the ten replays, nothing else; one
   capture, ten replays; every dQ and dK/dV launch on the wgmma route,
   counted as the launches are: ``bwd_route_gate``, also in phases 20,
   21, 22, 36 (c) and 37); losses finite and falling; step ms, tokens/s,
   peak memory; then two eager steps traced with ``torch.profiler``
   (device time by kind, idle share);
10. training correctness: gpt_tiny O0 fp32 three steps on the card and
   on the CPU from the same weights; gpt2_small fp32 gradients at B 1, T
   256 card vs CPU; gpt_tiny O2 with a dynamic scale and an injected inf
   (the step is skipped, the scale halves, the next step applies); the
   fused LM loss equal to the ``--no-fused-loss`` composition on the
   card;
11. BN epilogue forward and backward kernels vs plain at ResNet-50 B 128
   shapes (``[1605632, 64]``, ``[401408, 256]`` with a residual,
   ``[6272, 2048]`` without ReLU, bf16; one fp32 case): bf16 within one
   ulp, fp32 within 1e-6; ``library_ms`` is ``F.batch_norm(training=
   False)`` and its backward where it computes the same function;
12. cross-entropy forward and backward kernels vs plain at
   ``[8184, 50257]`` (smoothing 0 and 0.1, padding rows; fp32 and bf16),
   ``[128, 1000]`` and the BERT head's fp32 ``[2048, 30522]`` (smoothing
   0.1); ``library_ms`` is ``F.cross_entropy`` and its backward;
13. ResNet-50 training: the ImageNet trainer
   (``apex_tpu_torch.examples.imagenet.main_amp``), B 128, 224 x 224,
   bf16 O2, SGD, its defaults ``--pallas-conv --fused-bn --fused-loss``,
   10 steps replayed from a captured step, every launch counter set to 0
   just before and read just after (53 conv forward, 52 dgrad (the
   stem's input needs no gradient) and 53 wgrad, 53 BN forward and
   backward, 1 cross-entropy forward and backward per step of the warm
   run and of the replays, nothing else; of the forwards and the wgrads,
   the stem's on conv.cu's ``mma.sync`` route and the other 52 on the
   wgmma routes, every dgrad on wgmma, counted as the launches are:
   ``RESNET_CONV_ROUTES``); losses finite; step ms,
   images/s, peak memory; two eager steps traced (device time by kind,
   the conv kernels split into forward, dgrad and wgrad; idle share);
   13b. the same with ``--no-pallas-conv`` (cuDNN convs), 5 steps, no
   conv kernel launched, also traced; 13c. 16 steps at K 1 leafwise and
   with ``--bucketed`` (the SGD momentum in flat buckets): the bucketed
   run's launches as above, its state equal to the leafwise run's bit
   for bit in every leaf;
14. ResNet correctness: a small bottleneck ResNet at O0 fp32, three SGD
   steps on the card and on the CPU (losses rtol 1e-4, parameters and
   running statistics atol 1e-4), with ``Conv`` and with ``PallasConv``
   (the conv kernels); an O2 dynamic-scale step with an injected inf
   skipped with the parameters bit-identical and the running statistics
   advanced, with both; conv outputs contiguous NHWC;
15. conv kernels vs plain at ResNet-50 B 128 shapes (the stem, a stage-1
   3x3, a stride-2 3x3 with flax's ``(0, 1)`` pads, two stage-3/4 1x1s,
   the stage-1 1x1 expansion with the fused epilogue; bf16), one fp32
   3x3 at B 32, fp16 (a 3x3/1, the 3x3/2, the epilogue), and the dgrad
   alone at the other four stride-2 sites of a step (the per-parity
   path): forward, dgrad (not for the stem) and wgrad, fp32 within 1e-4
   of max |plain|, fp16 within one fp16 ulp of max |plain|, bf16 within
   one ulp of max |plain| with 99.9% of
   elements within one ulp of their plain value (wgrad: of the fp64 sum,
   since its fp32 plain sum over up to 1.6 M products misses by more on
   elements near zero), the epilogue equal to the kernel's conv
   followed by the plain epilogue bit for bit; each call names its route
   (each wrapper's ``routes``: wgmma for bf16/fp16 where the gathered
   channel count, C or for dgrad O, is a multiple of 64, mma for the
   stem, simt for fp32), and where that is a wgmma kernel the
   ``mma.sync`` kernel is timed on the same inputs beside it (equal bit
   for bit: printed, not a gate); with ``--was``
   the other checkout's kernels are timed beside each case;
   ``library_ms`` is cuDNN (``F.conv2d`` channels-last,
   ``aten.convolution_backward``);
   15b. forward, dgrad and wgrad at every distinct ResNet-50 conv site (23
   at B 128, bf16) against their plain versions as in 15, each naming its
   route, timed beside the ``mma.sync`` kernel where the route is wgmma
   (the same bits printed), beside cuDNN and, with ``--was``, beside the
   conv kernels of another checkout (the parent commit's, built from its
   own sources), and summed over the 53 convs of a step;
16. the int8 quantized-matmul kernel vs plain, bit for bit, at the O4
   path's shapes: serving prefill M 1024 (768->768, 768->3072,
   3072->768), decode M 8 (768->768, 3072->768), training M 8184
   (768->3072), an fp32 case, a zero-amax weight column, ragged M 1000 /
   N 130, fp16, and K = 8 and K = 40 (the weight padded to a multiple of
   16); ``library_ms`` ``torch._int_mm`` on the quantized operands where
   it takes the shape, beside the bf16 matmul of O2; each case names its
   route (``qmm_kernel.routes``: wgmma for M > 64 and K >= 128, split
   for the decode rows, mma below K 128) and at M > 64 the other kernel
   is timed on the same inputs beside it, bit for bit too; with
   ``--was``, the other checkout's qmm kernel timed on the same inputs;
17. O4 serving: gpt2_small bf16 calibrated in observe mode on 4 batches
   (frozen with "max"), rebuilt with the frozen scales, serving phase
   5's load with an int8 KV cache through the captured engine and the
   eager bodies as in phase 5 (72 qmm, 25 LN and 12 flash launches a
   forward, nothing else; 72 weight preparations at the engine's warmup
   and none while serving; every prefill forward's qmm on the wgmma
   route, every decode step's on split; the flash routes as phase 5's;
   tokens equal), traced as in phase 6, and
   O4 beside O2 (host and device ms and kernels a decode step,
   tokens/s); O4 with an empty calibration equal to O2 bit for bit, O4
   vs O2 prefill logits, and O4's prefill logits and greedy tokens with
   the prepared weights equal to those with every preparation redone;
   gpt_tiny fp32 O4 with an int8 KV cache on the card and on the CPU
   with equal greedy tokens (a mismatch allowed only where the CPU
   engine's top-2 logit gap at that step is below ``O4_TINY_GAP``);
18. O4 training: ``make_train_step(opt_level="O4")`` on the calibrated
   gpt2_small, Adam, B 8, seq_len 1024, the fused loss, 10 steps (72 qmm
   a step beside phase 9's kernels, and 72 weight preparations: training
   prepares every call), losses finite and falling, beside phase 9's O2
   numbers; two steps traced;
19. the ``[B, T, S]`` bias-gradient kernel at B 8, T = S = 1024, 12 heads
   of 64 (full, causal, GQA 12/4, a 256-key window, fp32, fp16), of 16
   and of 256, and at B 1 of 320 and 512: through
   ``flash_attention`` under autograd (one db2 launch per backward, dq,
   dk, dv unchanged against the run without a bias gradient), then
   against ``_flash_bwd_ref``'s dbias within 1e-4 of max |dbias|;
   ``library_ms`` SDPA's backward with the bias expanded to heads; with
   ``--was``, the other checkout's db2 kernel timed on the same inputs
   (and equal bit for bit where this one runs the SIMT kernel);
20. K-step windows from CUDA graphs: the LM trainer at GPT-2 small O2
   and the ImageNet trainer at ResNet-50 O2 (phases 9 and 13's
   configurations) with ``--steps-per-call`` 1 and 8, and phase 18's O4
   step through the trainers' window loop, 16 steps each, against 16
   eager calls of the step function from the same initial state: every
   state leaf equal bit for bit (one capture, 16 / K replays); step ms
   and peak memory of each, the window's bytes, the K 8 peak over the K 1
   peak plus the window; and each K 8 run again with the state copied
   into the graph's static inputs only at the window's end (the design
   before each step's state was copied in), its state bit for bit too,
   for the step ms and peak memory before that change; every flash
   forward of the LM runs (eager, K 1, K 8, O2 and O4) on the wgmma
   route, every qmm of the O4 runs on wgmma, and every ResNet-50 conv
   forward and wgrad but the stem's and every dgrad on wgmma; with
   ``--was`` the O2 and O4 eager steps beside the other checkout's on the
   same model and batch, in the order was, this, this, was;
21. BERT-base training: the JAX package's BERT step (``bench.py``:
   ``bert_base(dtype=bf16, num_classes=None, attention_impl="flash")``,
   B 16, T 128, the tied fp32 head, cross-entropy with smoothing 0.1,
   ``padding_idx=-1``) at O2 through ``make_train_step`` with
   ``training.adam(lr=1e-4)``, ``adam(lr=1e-4, bucketed=True)`` and
   ``lamb(lr=1e-3, bucketed=True)``, each 16 eager steps and 16 steps at
   K 1 and K 4 through ``runtime.StepPipeline``: every state leaf equal
   to the eager one bit for bit, every launch counter set to 0 just
   before each window run and read just after (25 LN forward and
   backward, 12 flash forward, dQ and dK/dV, 1 cross-entropy forward and
   backward per step that ran on the card, nothing else; every flash
   forward on the wgmma route), losses finite
   and falling (the last four steps' mean below the first four's);
   step ms, sequences/s and peak memory; the bucketed Adam
   equal to the leafwise Adam bit for bit after 16 steps with a dynamic
   scale and an inf injected at step 5 (skipped in both), the bucketed
   LAMB, fed the leafwise LAMB's gradients, within rtol 5e-5, atol 5e-6
   of the leafwise LAMB's parameters; ``bert_tiny``
   fp32 logits and the parameters after three bucketed LAMB steps on the
   card against the CPU within 1e-4; and (after the profiler sessions
   have begun) the optimizer's device ms a step from one trace, for the
   three BERT optimizers and for the LM O2 step with the leafwise and
   the bucketed Adam;
22. imperative BERT-base at O2: phase 21's model, weights, batch and
   loss through ``amp.initialize(model, opt, opt_level="O2",
   loss_scale="dynamic")``, ``amp.scale_loss`` and ``opt.step()`` with
   ``FusedAdam(lr=1e-4)``, ``FusedAdam(lr=1e-4, bucketed=True)`` and
   ``FusedLAMB(lr=1e-3, bucketed=True)``, 16 steps each with an inf loss
   at step 5: the model's parameters bf16 with the norms fp32, the
   masters fp32; every launch counter set to 0 just before the 16 steps
   and read just after (phase 21's per-step counts x 16, nothing
   else); the inf step leaves every master bit-identical and halves the
   scaler; the Adam masters, moments and step bit for bit phase 21's
   ``make_train_step`` (leafwise and bucketed) run from the same
   masters; the LAMB masters and moments within rtol 5e-5, atol 5e-6 of
   phase 21's bucketed LAMB fed the same gradients and skip mask; eager
   step ms beside phase 21's eager and captured ms, peak memory;
23. DCGAN at the reference example's widths (``examples/dcgan/
   main_amp.py``: B 64, nz 100, ngf 64, ndf 64, 64 x 64 x 3, O1, three
   dynamic loss scalers): the pipelined trainer at ``--steps-per-call``
   1 and 8, 16 iterations each, every state leaf equal to 16 eager
   iterations of its step function bit for bit (one capture, 16 / K
   replays); ``--imperative`` with an overflow forced on loss 1 at
   iteration 5 (D's step skipped, G's not; only scaler 1 halved); O0
   three iterations on the CPU, each also on the card from the CPU's
   state (losses within rtol/atol 1e-4; the gradients at the initial
   weights within 1e-4 of each net's largest; every new parameter
   within 2.2 lr, since Adam takes an lr-sized step wherever a gradient
   is within rounding of zero, as the biases that feed a BatchNorm
   are); losses finite; every kernel counter 0
   (JAX runs this model through XLA, no Pallas kernel); the BatchNorm
   running statistics unchanged (both modes drop the batch statistics,
   as JAX's does); it/s of each mode and peak memory;
24. ResNet-50 O2 from a directory (the ImageNet trainer's run line, B
   128, 224 x 224, ``--steps-per-call 2 --workers 4 --augment``) over
   640 uint8 ``.npy`` images of 256 x 256 in 10 class folders written
   from seed 0 (5 batches an epoch, 4 epochs, 20 steps, a checkpoint
   every 4): (a) uninterrupted, (b) the same run as a subprocess killed
   with SIGKILL once its first checkpoint is published, (c)
   ``--resume`` to the end: (c)'s final checkpoint equal to (a)'s bit
   for bit in every leaf; every launch counter set to 0 just before (a)
   and (c) and read just after (phase 13's per-step counts x the steps
   that ran on the card); step ms beside phase 13's synthetic step, the
   loader's stall share;
25. the LM trainer at phase 20's GPT-2 small O2 (B 8, T 1023, Adam, K
   2): 16 steps, against 8 steps, a save, and a fresh pipeline with
   ``--resume`` to 16: the final checkpoints equal bit for bit (launches
   as phase 9's per step); the 8-step run starts with the pinned host
   cache emptied, and its first checkpoint's stall on the loop (the
   buffer reserved while the trainer warmed up) is at most 20% of a
   synchronous write of the same state; an async save that pins its
   buffer on the loop and a later one are printed beside it; the
   state's bytes, the snapshot ms, the serialize+fsync ms, the
   device-to-host GB/s;
26. hot-swap serving: phase 5's engine on random weights from seed 0,
   watching an empty directory (``watch_dir``, ``extract`` the trained
   masters, the watcher's own thread polling every 50 ms); phase 25's
   step 16 published into it while 16 requests are in flight, and new
   requests keep every slot busy until the swap lands between two
   scheduler steps: every request ok with 32 tokens, one hot-swap, 16
   later requests bit for bit a fresh engine's on the restored weights;
   a later step with a corrupted shard not adopted (``last_error``
   names it) while serving goes on; launches per forward (the warm runs
   of every capture, the 4 after the swap among them, and the
   replays; every flash decode step on the decode kernel, none on
   split-KV); the watcher's load ms, the adopting step's ms and TPOT p99
   across the swap, while the watcher staged, and without a swap;
27. data parallel under NCCL: the ImageNet trainer at ResNet-50 O2 B
   128 with ``--loss-scale dynamic --pallas-conv --fused-loss --sync_bn
   --no-fused-bn --steps-per-call 2``, 16 steps, as subprocesses: (a) under the
   spawner (``python -m apex_tpu_torch.parallel.multiproc --nproc 1``),
   an NCCL group of one, so every collective of the step (the gradient
   bucket, the 53 SyncBatchNorms' statistics and their cotangents, the
   loss and statistics' pmean, the overflow flag) sits in the captured
   graph; (b) without a group: (a)'s final checkpoint equal to (b)'s bit
   for bit in every leaf, one capture and 8 replays each, the same kernel
   launches with kernels 1-7 at least once a step, the conv routes of
   phase 13 in both, (a)'s collectives counted at the warm run and each
   replay; step ms of both;
28. data parallel under gloo: two ranks on the one card
   (``chip_smoke.py --ddp-gloo-worker DIR`` under ``multiproc.spawn``,
   600 s timeout), ResNet-50 fp32 O0 with ``PallasConv`` and GroupBN
   ``bn_group=2``, 32 images a rank of a global 64, SGD with momentum,
   3 eager steps: rank 1's seed-1 weights made rank 0's bit for bit by
   ``DistributedDataParallel.sync_params()``; the ranks' parameters and
   running statistics bit-identical, and within rtol/atol 1e-4 of one
   process on the whole batch with ``bn_group=1``; a dynamic-scale step
   with an inf on rank 1 only skipped on both, the scale halved; a CUDA
   ``StepPipeline`` of the gloo step refused; launches as phase 13's per
   step; the eager step ms a rank and gloo's share of it (not a measure
   of NCCL);
   27 and 28 also record telemetry: 27 (a) runs with ``--telemetry
   ...rank{rank}.jsonl`` (its 109 collectives a step noted once, all at
   the warm run before the first replay, one capture, a window event a
   replay; its state is the one held against (b) bit for bit), 28's
   ranks each write a stream that ``prof.fleet`` merges, each noting the
   gradient bucket once a step with the bucket's bytes;
29. training telemetry: phase 20's LM trainer (GPT-2 small O2, B 8, T
   1023, Adam, K 8, 16 steps) through its CLI (``run``) with no
   telemetry flag or variable, with ``--telemetry --watchdog
   --metrics-textfile``, and without again: the final states bit for bit
   in every leaf, the same launches (phase 20's per-step counts x the
   steps on the card), one ``window`` event a replay, one ``retrace``
   with ``first`` a capture and none without, one ``metrics`` event a
   window with JAX's fields and finite losses, no alert, a ``summary``
   at the end, the textfile with ``steps_per_s``, ``loss`` and
   ``peak_hbm_bytes``, ``prof.timeline --json`` reading 16 steps in 2
   windows; the captured step ms with the recorder over the mean of the
   two runs without, at most 1.5 (JAX's overhead gate); then 8 steps at
   K 4 with a dynamic scale and an inf at step 5: one ``scale`` skip
   event, no ``scale_collapse``;
30. serving telemetry: phase 5's engine and 16 requests without a
   recorder, with one, with every request traced (``trace_sample_n=1``,
   the SLO ``ttft_p99<200ms,tpot_p99<30ms``, the exporter's endpoint on a
   free localhost port) and without again: the traced run's tokens bit
   for bit phase 5's, 16 ``done`` events, 16 complete span trees (a
   ``request`` root with ``queue``, ``prefill`` and one ``decode_step``
   per decode step the request was in), ``prof.requests``' TTFT and TPOT
   per request equal to each ``ServedResult.timings``, ``GET /metrics``
   with ``serving_tokens_per_s`` and ``slo_goodput_pct``, the 4 warmup
   captures as ``retrace`` events and none while serving; every flash
   decode step of the four runs on the decode kernel, none on split-KV;
   TPOT p50/p99 and tokens/s of the four runs, and the host us of one
   ``span`` and
   one ``decode`` event through a recorder with the traced run's
   attachments;
31. the profiling stages (``apex_tpu_torch.prof``) over phase 20's LM
   (GPT-2 small O2 B 8 T 1023) and ResNet-50 (O2 B 128) training steps:
   ``roofline.harvest_costs`` on fake CUDA tensors equal to the same on
   fake CPU tensors (FLOPs, bytes, products), two eager steps under
   ``prof.trace``, parsed by ``prof.parse``: the per-kind device ms
   equal to ``trace_steps``' from the same trace within 0.1%, the
   launches per kernel equal to the counters, ``<unattributed>`` under
   5% of the kernel time; the MFU of the captured K 8 step in (0, 1) on
   the card's data-sheet peaks (``roofline.load_peaks``), the LM's
   products within 10% of the hand count; ``harvest_memory`` over one
   real step with its peak equal to ``max_memory_allocated``;
   ``assert_trace_count``: one capture of the LM pipeline and none
   after, 4 captures at phase 5's engine warmup and none while it serves
   phase 5's load, traced; that trace's decode steps' host time split
   into the CPU events inside each ``decode[b]`` range and the gaps
   between them (``prof.parse.range_host_time``);
32. the tuner (``apex_tpu_torch.tune``) in a cache of its own (phases
   1-31 run with an empty one: every kernel its rule's tile): each of
   the six families tuned at its example shape (at most 6 candidates
   measured), best ms <= the rule's, each winner through its public
   function with the cache consulted within the kernel table's
   tolerance of its plain version; ``tune_from_ledger`` on phase 31's
   GPT-2 small ledger by the blocks' submodules, not stored; the LM and
   ResNet-50 trainers (O2, K 8, 16 steps) and phase 17's O4 load with
   the tuned cache: a hit for every tuned bucket a path consults, the
   launches of phases 20 and 17, the final state (tokens) bit for bit
   phase 20's (17's) where every consulted config is exact, else losses
   finite and falling; step ms and TPOT beside the untuned; then the
   cache rewritten for another device: every consult misses and the six
   calls equal the rule's bit for bit.  Phase 2's ``build:`` line also
   times ``flash_attention.cu`` built at the rule's tile only.
33. ``generate`` on GPT-2 small at full width (random weights from seed
   0), B 8, prompts of 64 tokens, 128 new tokens, fp32 and bf16, its
   decode step captured once and replayed: every counter set to 0 just
   before and read just after (25 LayerNorm launches a forward, the
   warm run and 191 replays; no flash launch: the decode attention is
   plain fp32, as in JAX); captured tokens bit for bit the eager step's;
   fp32 greedy tokens equal to the serving engine's for the same prompts
   and weights (the smallest top-2 logit margin printed); the first 4
   decode steps' logits against a CPU fp32 run (atol 2e-3 fp32, 0.25
   bf16); tokens/s captured and eager;
34. the RNN stack: a byte-level mLSTM at 4096 units (input 64, T 64,
   B 32) and a 2-layer bidirectional LSTM at 1024, forward and backward
   card vs CPU fp32 (relative max error 1e-4 forward, 1e-3 gradients),
   bf16 finite, ms a step; one SGD step on the mLSTM with weight norm on
   its ``ih``/``hh`` weights over 16 time steps (``g``, ``v`` gradients
   against the CPU);
35. the sharding primitives: ZeRO-1 Adam on GPT-2 small at O2 through
   ``make_train_step(reduce_grads=False)`` over an NCCL group of one,
   bit for bit the replicated step for 4 steps (the counters set to 0
   just before it and read after); then two gloo ranks on the card
   (``--shard-gloo-worker``; gloo moves only all_reduce and broadcast
   of CUDA tensors, so zero1's reduce-scatter and all-gather, the MoE's
   all_to_all and the pipeline's send and receive are staged through the
   host inside ``distributed.host_staging()``): zero1 (each rank half the padded
   Adam state; parameters within rtol 1e-6 of the replicated two-rank DP
   step's), ``tp_self_attention`` (one flash launch a rank) and
   ``tp_mlp`` at GPT-2 small width, ``moe_layer`` and ``spmd_pipeline``
   against their single-process oracles;
36. sequence parallelism: (a) kernels 10-12 against their plain
   versions at the ring's relative offsets (-512, 0, +512 and -475 with
   512-row shards; GPT-2 small's 12 x 64 heads, B 8; bf16, fp32 and the
   decode route at q_len 8; causal and not): a row with no visible key
   gives out 0 and lse -1e30, hidden rows and unseen keys zero
   gradients, no NaN; every bf16 forward at 512 rows on the wgmma
   route, fp32 on SIMT, q_len 8 on the decode kernel; (b) two gloo ranks
   on the card
   (``--seq-gloo-worker``, the ring's send and receive, Ulysses's
   all_to_all and the mesh's all-gather and reduce-scatter staged
   through the host inside ``distributed.host_staging()``):
   ``ring_flash_attention``, ``ring_attention`` and
   ``ulysses_attention`` at B 8, T 1024 (512 a rank), 12 x 64, causal,
   against one process's ``flash_attention`` at T 1024 (fp32 out 2e-5,
   gradients 5e-4 relative; bf16 2e-2 both), ring_flash launching each
   of kernels 10-12 twice a rank (one a ring step); (c) the LM trainer's
   ``--sp 2 --attention ring_flash`` (its ``build``) on GPT-2 small O2,
   B 8, ``--seq-len 1025``, the fused loss, 3 eager steps on the two
   ranks, the launches counted (24 of each of kernels 10-12 a step), its
   losses within rtol 1.2e-4 of ``--sp 1 --attention flash``'s on the same
   batch;
37. the mesh: (a) in an NCCL group of one, ``make_mesh_train_step`` at
   zero 1, 2 and 3 on GPT-2 small O2 (B 4, T 256), 4 steps each bit for
   bit the replicated ``make_train_step`` (losses, parameters, zero 3's
   moments), the counters set to 0 just before each run; (b) zero 3
   through ``StepPipeline(wrap=ms.pipeline_wrap(state))`` at K 4,
   captured with the gather and scatter inside the graph: one capture,
   4 replays, every state leaf bit for bit 16 eager steps; (c) on the
   two gloo ranks of 36 (b), ``fsdp=2``, ``zero=3`` against the
   replicated two-rank DP step (parameters within rtol 1e-6, phase 35's
   gate), a rank holding half the state.

Phases 24-32 and 35-37 write their data under temporary directories,
removed at the end.  The phases run in the order 1-4, 17's calibration, 20, 29, 21
(all but its traces), 22, 23, 5, 30, 17's served load, 6 (with 17's
traces),
7-10, 21's traces, 11-16, the rest of 17, 18, 19, 24-28, 31-37: the eager
sides of 20-23, 5 and
17, and 29-30, run before the first profiler session, after which every launch of
the process costs the host more (phase 6 ends by timing phase 20's eager
LM steps again).

The line before the last two is one JSON object describing every kernel
(time, bound, launches on its path: the LN and flash forward kernels' on
the serving run (the decode kernel, ``flash_attention_fwd_decode``,
its own row: its launches the serving paths' decode routes), their
backward kernels' on the LM training run, the BN
and cross-entropy kernels' and the conv kernels' on the ResNet-50
run, the qmm kernel's on the O4 serving run, the bias-gradient kernel's
on phase 19's backward passes; ``launches_by_path`` adds every other
path, ``bert_training`` the bucketed LAMB's K 4 run, ``imperative_bert``
phase 22's ``FusedLAMB`` run, ``dcgan`` phase 23's runs,
``resnet_directory``, ``lm_resume`` and ``hotswap_serving`` the
uninterrupted runs of phases 24 and 25 and phase 26's engine,
``ddp_nccl`` phase 27's run in an NCCL group, ``ddp_gloo`` phase 28's
rank 0, ``generate`` phase 33's fp32 captured run, ``zero1_lm`` phase
35's zero1 run, ``ring_lm`` phase 36's ``--sp 2`` steps on rank 0,
``mesh_zero3`` phase 37's zero 3 run); then the
``nvidia-smi`` line;
the last line is ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --sp-gate-faults`` runs only phase 36 (c), sound
and with faults planted at run time, and prints how far each run's
losses part from ``--sp 1`` beside the limit; it exits 1 unless the
limit passes the sound run and fails every fault.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import importlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# kernel launches per serving forward (prefill or decode step)
SERVE_PER_FORWARD = {"layer_norm_fwd": 25, "flash_attention_fwd": 12}
# the same at O4: the 72 q/k/v/out/mlp_up/mlp_down projections
O4_SERVE_PER_FORWARD = dict(SERVE_PER_FORWARD, qmm=72)
# kernel launches per LM training step (O2; O4 adds the 72 qmm)
LM_PER_STEP = {"layer_norm_fwd": 25, "layer_norm_bwd": 25,
               "flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
               "flash_attention_bwd_dkv": 12, "xentropy_fwd": 1,
               "xentropy_bwd": 1}

FAILURES = []


def check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def time_ms(fn, iters: int = 20, stream=None) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph and replayed between two CUDA events, so the host's launch cost
    is left out (inputs stay warm in L2 where they fit its 50 MB, as they
    do when the previous layer has just written them).  ``stream``: the
    capture stream, for an autograd backward whose forward ran there (its
    kernels are launched on the forward's stream)."""
    fn()
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    return _events_ms(graph.replay) / iters


def eager_ms(fn, iters: int = 20) -> float:
    """Milliseconds per call of ``iters`` eager calls back to back: what
    the eager serving path pays, host launch cost included.  Each result
    is dropped before the next call, as a caller's would be, so the
    caching allocator reuses its memory (a list of all the results made
    every large call allocate afresh)."""
    fn()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run) / iters


def _events_ms(run) -> float:
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def costs():
    """The package's kernel cost formulas (``apex_tpu_torch.prof.costs``:
    the work each kernel call needs, and its bound on the card's peaks),
    the ones the analytic walk counts."""
    return importlib.import_module("apex_tpu_torch.prof.costs")


def bound(cost) -> tuple:
    """(bound_ms, bound_by) of a :class:`KernelCost`: the least time for
    its bytes over the memory rate and its operations over the peak rate
    of their type (``costs.HBM_BYTES_PER_S``, ``costs.PEAK_OPS``)."""
    return costs().bound(cost)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# -- phase 3: LayerNorm ---------------------------------------------------------

def layer_norm_cases(fln, dev):
    rng = np.random.RandomState(0)
    w = torch.from_numpy((1 + 0.1 * rng.randn(768)).astype(np.float32)).to(dev)
    b = torch.from_numpy((0.1 * rng.randn(768)).astype(np.float32)).to(dev)
    cases = []
    # serving prefill and decode rows, the LM step's 8 x 1023 and the
    # BERT step's 16 x 128
    for rows in (1024, 8, 8184, 2048):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            x = torch.from_numpy(rng.randn(rows, 768).astype(np.float32)).to(
                dev, dtype)
            got = fln.layer_norm_fwd_kernel(x, w, b, 1e-5)
            want = fln._fwd_ref(x, w, b, 1e-5)
            torch.cuda.synchronize()
            err = max(max_err(g, t) for g, t in zip(got, want))
            name = f"layer_norm [{rows}, 768] {str(dtype)[6:]}"
            check(err <= tol, f"{name}: max_abs_err {err:.3g} <= {tol}")
            bms, by = bound(costs().layer_norm_fwd(x, w, b))
            case = dict(
                case=name, max_abs_err=err,
                ms=time_ms(lambda: fln.layer_norm_fwd_kernel(x, w, b, 1e-5)),
                eager_ms=eager_ms(
                    lambda: fln.layer_norm_fwd_kernel(x, w, b, 1e-5)),
                plain_ms=time_ms(lambda: fln._fwd_ref(x, w, b, 1e-5)),
                library_ms=time_ms(lambda: F.layer_norm(x, (768,), w.to(dtype),
                                                        b.to(dtype), 1e-5)),
                bound_ms=bms, bound_by=by)
            print(f"      {name}: kernel {case['ms']:.4f} ms (eager "
                  f"{case['eager_ms']:.4f}), plain "
                  f"{case['plain_ms']:.4f} ms, library {case['library_ms']:.4f}"
                  f" ms, bound {bms:.4f} ms ({by})", flush=True)
            cases.append(case)
    cases.append(layer_norm_large_mean(fln, dev))
    return cases


def layer_norm_large_mean(fln, dev):
    """Rows of mean ~100 and spread ~1 built from quarters, so every sum
    of x and x*x is exact in fp32 and JAX's single-pass variance E[x^2] -
    mean^2 parts from the two-pass one only by the rounding of mean^2: the
    kernel must follow the plain version (within two fp32 ulps of invvar)
    ten times closer than the two-pass formula does."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy((100.0 + rng.randint(-8, 9, (1024, 64)) / 4.0)
                         .astype(np.float32)).to(dev)
    got = fln.layer_norm_fwd_kernel(x, None, None, 1e-5)
    want = fln._fwd_ref(x, None, None, 1e-5)
    xc = x - x.mean(1, keepdim=True)
    two_pass = torch.rsqrt((xc * xc).mean(1) + 1e-5)
    torch.cuda.synchronize()
    kern_err, two_err = max_err(got[2], want[2]), max_err(two_pass, want[2])
    err = max(max_err(g, t) for g, t in zip(got, want))
    name = "layer_norm [1024, 64] mean 100 fp32"
    check(kern_err <= 2 * 2.0 ** -23 * want[2].abs().max().item()
          and two_err > 10 * kern_err and err <= 1e-5,
          f"{name}: invvar err {kern_err:.3g} (two-pass formula "
          f"{two_err:.3g}), max_abs_err {err:.3g} <= 1e-5")
    bms, by = bound(costs().layer_norm_fwd(x, None, None))
    case = dict(case=name, max_abs_err=err, invvar_err=kern_err,
                two_pass_invvar_err=two_err,
                ms=time_ms(lambda: fln.layer_norm_fwd_kernel(x, None, None,
                                                             1e-5)),
                eager_ms=eager_ms(lambda: fln.layer_norm_fwd_kernel(
                    x, None, None, 1e-5)),
                plain_ms=time_ms(lambda: fln._fwd_ref(x, None, None, 1e-5)),
                library_ms=time_ms(lambda: F.layer_norm(x, (64,), eps=1e-5)),
                bound_ms=bms, bound_by=by)
    print(f"      {name}: kernel {case['ms']:.4f} ms, invvar err "
          f"{kern_err:.3g}, two-pass formula {two_err:.3g}", flush=True)
    return case


# -- phase 4: flash attention --------------------------------------------------

#: phase 4's bf16/fp16 width-64 causal and bias cases, where the wgmma
#: route must beat the mma.sync rule
FLASH_MUST_BEAT_MMA = ("prefill bias [1,1024,1024]", "causal 1024",
                       "gqa 12/4 causal 1024", "lm causal b8 t1023",
                       "fp16 causal 1024")
#: phase 4's decode cases (serving's two buckets, fp16, GQA 12/4), where
#: the decode kernel must beat the split-KV kernels on the same inputs
FLASH_MUST_BEAT_SPLIT = ("decode b8 tq1 tk1024", "fp16 decode b8 tq1 tk1024",
                         "decode b8 tq1 tk256",
                         "gqa 12/4 decode b8 tq1 tk1024")


def zero_routes(fa):
    """The flash forward's route counts set to 0, as each phase sets the
    launch counters."""
    for r in fa.flash_fwd_kernel.routes:
        fa.flash_fwd_kernel.routes[r] = 0


def route_gate(fa, name, launches, decode=False):
    """Since :func:`zero_routes`: every flash forward with q_len >= 16 of
    the path (all bf16 at width 64) was served by the wgmma kernel and,
    where the path decodes (``decode``), every decode step's by the decode
    kernel (``csrc/flash_decode_sm90.cu``): no mma.sync, SIMT or split-KV
    launch, and the routes sum to the forward's ``launches`` (captured
    replays included)."""
    routes = dict(fa.flash_fwd_kernel.routes)
    check(routes["wgmma"] > 0 and routes["mma"] == 0 and routes["simt"] == 0
          and routes["split"] == 0 and (routes["decode"] > 0) == decode
          and sum(routes.values()) == launches,
          f"{name}: flash forward routes {routes}: every prefill or "
          f"training forward on wgmma"
          f"{', every decode step on decode' if decode else ''}, none on "
          f"split-KV, {launches} launches")
    return routes


#: a ResNet-50 step's 53 conv forwards by route: the stem (C = 3, padded
#: to 8) on conv.cu's mma.sync kernel, the other 52 (C a multiple of 64)
#: on conv_sm90.cu's wgmma kernel
RESNET_FWD_ROUTES = {"wgmma": 52, "mma": 1, "simt": 0}
#: its 52 dgrads (O a multiple of 64; the stem's input needs none), all on
#: conv_sm90.cu's wgmma kernel
RESNET_DGRAD_ROUTES = {"wgmma": 52, "mma": 0, "simt": 0}
#: its 53 wgrads: the stem's (C = 3) on conv.cu's mma.sync kernel, the
#: other 52 on wgmma
RESNET_WGRAD_ROUTES = {"wgmma": 52, "mma": 1, "simt": 0}
#: each conv kernel's routes a step, by its counter's name
RESNET_CONV_ROUTES = {"conv_fwd": RESNET_FWD_ROUTES,
                      "conv_dgrad": RESNET_DGRAD_ROUTES,
                      "conv_wgrad": RESNET_WGRAD_ROUTES}


def zero_wrapper_routes(*wrappers):
    """Each wrapper's route counts set to 0, as the launch counters are."""
    for w in wrappers:
        for r in w.routes:
            w.routes[r] = 0


def zero_bwd_routes(fa):
    """The flash backward's route counts (dQ and dK/dV) set to 0."""
    zero_wrapper_routes(fa.flash_bwd_dq_kernel, fa.flash_bwd_dkv_kernel)


def bwd_route_gate(name, routes, launches):
    """Since :func:`zero_bwd_routes`: every dQ and dK/dV launch of a
    training path (all bf16 at width 64) served by the wgmma kernels of
    ``flash_attention_bwd_sm90.cu``, none by mma.sync or SIMT, each
    kernel's routes (``routes["dq"]``, ``routes["dkv"]``) summing to its
    launches (``launches``, the same keys; captured replays included)."""
    for key in ("dq", "dkv"):
        got = dict(routes[key])
        check(got["wgmma"] > 0 and got["mma"] == 0 and got["simt"] == 0
              and sum(got.values()) == launches[key],
              f"{name}: flash backward {key} routes {got}: every training "
              f"{key} on wgmma, {launches[key]} launches")
    return {k: dict(routes[k]) for k in ("dq", "dkv")}


def bwd_routes(fa):
    """The flash backward's route counts now, by kernel."""
    return {"dq": dict(fa.flash_bwd_dq_kernel.routes),
            "dkv": dict(fa.flash_bwd_dkv_kernel.routes)}


def launched_route(wrapper, fn):
    """``fn()``'s result and the route of the one launch it made."""
    before = dict(wrapper.routes)
    out = fn()
    moved = [r for r, n in wrapper.routes.items() if n != before[r]]
    return out, (moved[0] if len(moved) == 1 else moved)


def conv_route_gate(name, routes, launches):
    """Since the route counts were set to 0: each conv kernel's launches
    (``launches[k]``, ``k`` a key of ``RESNET_CONV_ROUTES``) a whole
    number of ResNet-50 steps, the same number for the three, by route
    (``routes[k]``) its ``RESNET_CONV_ROUTES[k]`` a step: every forward
    and wgrad but the stem's and every dgrad on wgmma."""
    steps = launches.get("conv_fwd", 0) // 53
    out = {}
    for k, per_step in RESNET_CONV_ROUTES.items():
        got = dict(routes.get(k, {}))
        n = launches.get(k, 0)
        want = {r: c * steps for r, c in per_step.items()}
        check(steps > 0 and n == sum(per_step.values()) * steps
              and got == want,
              f"{name}: {k} routes {got} = {per_step} x {steps} steps "
              f"({n} launches)")
        out[k] = got
    return out


def qmm_route_gate(name, routes, launches, decode):
    """Since the route counts were set to 0: every qmm launch of a path
    with more than 64 rows (a prefill or a training step, 72 a forward)
    on the wgmma route and, where the path decodes, every decode step's on
    split; no mma.sync launch, the routes summing to the launches."""
    routes = dict(routes)
    check(routes["mma"] == 0 and routes["wgmma"] > 0
          and routes["wgmma"] % 72 == 0 and routes["split"] % 72 == 0
          and (routes["split"] > 0) == decode
          and sum(routes.values()) == launches,
          f"{name}: qmm routes {routes}: every prefill or training qmm on "
          f"wgmma{', every decode step on split' if decode else ''}, "
          f"{launches} launches")
    return routes


def flash_cases(fa, dev, was_fa=None):
    """Each case: the kernel of the rule's route against the plain
    version; its time (a CUDA graph of 20 calls), eager, the plain
    version's, SDPA's and the bound; where the route is wgmma, the
    mma.sync rule's tile (64 x 64) on the same inputs beside it (it must
    be slower at ``FLASH_MUST_BEAT_MMA``); with ``was_fa`` the other
    checkout's kernel too."""
    rng = np.random.RandomState(1)
    t, h = 1024, 12

    def qkv(b, tq, tk, h_kv, d, dtype):
        return [torch.from_numpy(rng.randn(b, n, hh, d).astype(np.float32))
                .to(dev, dtype) for n, hh in ((tq, h), (tk, h_kv), (tk, h_kv))]

    key = torch.arange(t, device=dev)
    # the engine's prefill bias: causal visibility of a 1024 bucket
    prefill_bias = torch.where(key[None, None, :] <= key[None, :, None],
                               0.0, -1e9)
    lengths = torch.from_numpy(rng.randint(32, t, 8)).to(dev)
    decode_kb = torch.where(key[None, :] <= lengths[:, None], 0.0, -1e9)
    band = ((key[:, None] >= key[None, :])
            & (key[:, None] - key[None, :] < 256))
    # serving's small bucket: 256 keys, each row's live prefix
    lengths256 = torch.from_numpy(
        np.random.RandomState(5).randint(32, 256, 8)).to(dev)
    decode_kb256 = torch.where(
        key[None, :256] <= lengths256[:, None], 0.0, -1e9)
    bf16, fp16 = torch.bfloat16, torch.float16
    specs = [
        # name, b, tq, tk, h_kv, head_dim, dtype, causal, window, kbias,
        # bias, sdpa kwargs
        ("prefill bias [1,1024,1024]", 1, t, t, h, 64, bf16, False, None,
         None, prefill_bias, dict(attn_mask=prefill_bias[:, None])),
        ("causal 1024", 1, t, t, h, 64, bf16, True, None, None, None,
         dict(is_causal=True)),
        ("decode b8 tq1 tk1024", 8, 1, t, h, 64, bf16, True, None,
         decode_kb, None, dict(attn_mask=decode_kb[:, None, None, :])),
        ("gqa 12/4 causal 1024", 1, t, t, 4, 64, bf16, True, None, None,
         None, dict(is_causal=True)),
        ("window 256 causal 1024", 1, t, t, h, 64, bf16, True, 256, None,
         None, dict(attn_mask=band)),
        ("fp32 causal 1024", 1, t, t, h, 64, torch.float32, True, None, None,
         None, dict(is_causal=True)),
        # the LM's training call, 12 a forward
        ("lm causal b8 t1023", 8, 1023, 1023, h, 64, bf16, True, None, None,
         None, dict(is_causal=True)),
        ("fp16 causal 1024", 1, t, t, h, 64, fp16, True, None, None, None,
         dict(is_causal=True)),
        ("fp16 decode b8 tq1 tk1024", 8, 1, t, h, 64, fp16, True, None,
         decode_kb, None, dict(attn_mask=decode_kb[:, None, None, :])),
        ("head_dim 16 causal 1024", 1, t, t, h, 16, bf16, True, None, None,
         None, dict(is_causal=True)),
        ("head_dim 48 causal 1024", 1, t, t, h, 48, bf16, True, None, None,
         None, dict(is_causal=True)),
        ("head_dim 256 causal 1024", 1, t, t, h, 256, bf16, True, None, None,
         None, dict(is_causal=True)),
        # wider than the widest kernel: the 256 one in 256-wide slices
        ("head_dim 320 causal 1024", 1, t, t, h, 320, bf16, True, None, None,
         None, dict(is_causal=True)),
        ("head_dim 512 causal 1024", 1, t, t, h, 512, bf16, True, None, None,
         None, dict(is_causal=True)),
        # the BERT step's call, 12 a forward: no mask, every key visible
        ("bert b16 t128 full", 16, 128, 128, h, 64, bf16, False, None, None,
         None, {}),
        # the wgmma kernel's other width
        ("head_dim 128 causal 1024", 1, t, t, h, 128, bf16, True, None, None,
         None, dict(is_causal=True)),
        # serving's other bucket, and a GQA decode (K and V read once for
        # the three query heads of a KV head)
        ("decode b8 tq1 tk256", 8, 1, 256, h, 64, bf16, True, None,
         decode_kb256, None, dict(attn_mask=decode_kb256[:, None, None, :])),
        ("gqa 12/4 decode b8 tq1 tk1024", 8, 1, t, 4, 64, bf16, True, None,
         decode_kb, None, dict(attn_mask=decode_kb[:, None, None, :])),
    ]
    cases = []
    for (name, b, tq, tk, h_kv, d, dtype, causal, window, kb, bias,
         sdpa) in specs:
        q, k, v = qkv(b, tq, tk, h_kv, d, dtype)
        kw = dict(sm_scale=d ** -0.5, causal=causal, q_offset=tk - tq,
                  window=window)
        before = dict(fa.flash_fwd_kernel.routes)
        out, lse = fa.flash_fwd_kernel(q, k, v, kb, bias, **kw)
        route = next(r for r, n in fa.flash_fwd_kernel.routes.items()
                     if n != before[r])
        want_out, want_lse = fa._flash_fwd_ref(q, k, v, kb, bias, **kw)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        err = max_err(out, want_out)
        lse_err = max_err(lse, want_lse)
        check(err <= tol and lse_err <= 1e-3,
              f"flash {name} ({route}): max_abs_err {err:.3g} <= {tol}, lse "
              f"{lse_err:.3g} <= 1e-3")
        bms, by = bound(costs().flash_fwd(q, k, v, kb, bias, causal=causal,
                                          q_offset=tk - tq, window=window))
        # the library call gets KV heads repeated up front (untimed)
        qt, kt, vt = (x.repeat_interleave(h // x.shape[2], dim=2)
                      .transpose(1, 2) for x in (q, k, v))
        lib = {**sdpa}
        if "attn_mask" in lib and lib["attn_mask"].dtype != torch.bool:
            lib["attn_mask"] = lib["attn_mask"].to(dtype)
        case = dict(
            case=name, max_abs_err=err, lse_max_abs_err=lse_err,
            ms=time_ms(lambda: fa.flash_fwd_kernel(q, k, v, kb, bias, **kw)),
            eager_ms=eager_ms(
                lambda: fa.flash_fwd_kernel(q, k, v, kb, bias, **kw)),
            plain_ms=time_ms(lambda: fa._flash_fwd_ref(q, k, v, kb, bias,
                                                       **kw)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=d ** -0.5, **lib)),
            bound_ms=bms, bound_by=by, route=route, mma_ms=None,
            split_ms=None, was_ms=None)
        line = ""
        if route == "wgmma":
            # the mma.sync kernel by its rule's tile, on the same inputs
            mo, ml = fa.flash_fwd_kernel(q, k, v, kb, bias, tile=(64, 64),
                                         **kw)
            torch.cuda.synchronize()
            case["mma_max_abs_err"] = max_err(mo, want_out)
            case["mma_ms"] = time_ms(lambda: fa.flash_fwd_kernel(
                q, k, v, kb, bias, tile=(64, 64), **kw))
            line += f", mma.sync rule {case['mma_ms']:.4f} ms"
            if name in FLASH_MUST_BEAT_MMA:
                check(case["ms"] < case["mma_ms"],
                      f"flash {name}: wgmma {case['ms']:.4f} ms < mma.sync "
                      f"rule {case['mma_ms']:.4f} ms")
        if route == "decode":
            # the split-KV kernels on the same inputs, held to the same
            # gates
            so, sl = fa.flash_fwd_kernel(q, k, v, kb, bias, route="split",
                                         **kw)
            torch.cuda.synchronize()
            case["split_max_abs_err"] = max_err(so, want_out)
            case["split_lse_max_abs_err"] = max_err(sl, want_lse)
            case["decode_vs_split_max_abs_diff"] = max_err(out, so)
            check(case["split_max_abs_err"] <= tol
                  and case["split_lse_max_abs_err"] <= 1e-3,
                  f"flash {name} (split): max_abs_err "
                  f"{case['split_max_abs_err']:.3g} <= {tol}, lse "
                  f"{case['split_lse_max_abs_err']:.3g} <= 1e-3")
            # the decode kernel with its cluster merge off: 2-8 chunks
            # merged through the ticket, as a call of more chunks is
            fa._DECODE_CLUSTER_MERGE = False
            try:
                to, tl = fa.flash_fwd_kernel(q, k, v, kb, bias, **kw)
                torch.cuda.synchronize()
                case["ticket_ms"] = time_ms(lambda: fa.flash_fwd_kernel(
                    q, k, v, kb, bias, **kw))
            finally:
                fa._DECODE_CLUSTER_MERGE = True
            case["ticket_max_abs_err"] = max_err(to, want_out)
            case["ticket_lse_max_abs_err"] = max_err(tl, want_lse)
            case["ticket_same_bits"] = bool(torch.equal(to, out)
                                            and torch.equal(tl, lse))
            check(case["ticket_max_abs_err"] <= tol
                  and case["ticket_lse_max_abs_err"] <= 1e-3,
                  f"flash {name} (decode, ticket merge): max_abs_err "
                  f"{case['ticket_max_abs_err']:.3g} <= {tol}, lse "
                  f"{case['ticket_lse_max_abs_err']:.3g} <= 1e-3")
            line += (f", ticket merge {case['ticket_ms']:.4f} ms (same "
                     f"bits {case['ticket_same_bits']})")
            case["split_ms"] = time_ms(lambda: fa.flash_fwd_kernel(
                q, k, v, kb, bias, route="split", **kw))
            case["split_eager_ms"] = eager_ms(lambda: fa.flash_fwd_kernel(
                q, k, v, kb, bias, route="split", **kw))
            case["at_or_below_library"] = case["ms"] <= case["library_ms"]
            line += (f", split-KV {case['split_ms']:.4f} ms (eager "
                     f"{case['split_eager_ms']:.4f}), max |decode - split| "
                     f"{case['decode_vs_split_max_abs_diff']:.3g}")
            if name in FLASH_MUST_BEAT_SPLIT:
                check(case["ms"] < case["split_ms"],
                      f"flash {name}: decode {case['ms']:.4f} ms < split-KV "
                      f"{case['split_ms']:.4f} ms")
        if was_fa is not None:
            case["was_ms"] = time_ms(lambda: was_fa.flash_fwd_kernel(
                q, k, v, kb, bias, **kw))
            line += f", was {case['was_ms']:.4f} ms"
        print(f"      flash {name} ({route}): kernel {case['ms']:.4f} ms "
              f"(eager {case['eager_ms']:.4f}), plain "
              f"{case['plain_ms']:.4f} ms, library {case['library_ms']:.4f} "
              f"ms, bound {bms:.4f} ms ({by}){line}", flush=True)
        cases.append(case)
    return cases


def flash_same_as_was(fa, was_fa, dev):
    """Phase 4b, with ``--was``: the flash kernels of this checkout and of
    the other one on the same inputs at head widths up to 256, every path
    (tensor cores, SIMT, split-KV decode; the forward, dQ, dK/dV and db2),
    fp32 and bf16, compared bit for bit, the forward's outputs apart from
    the backward's.  Recorded and printed, not a gate: a kernel
    redesigned since that checkout may round otherwise."""
    rng = np.random.RandomState(4)
    rows = []
    for d in (16, 48, 64, 128, 160, 256):
        for dtype in (torch.float32, torch.bfloat16):
            for tq in (1, 200):
                q, do = (torch.from_numpy(rng.randn(2, tq, 4, d).astype(
                    np.float32)).to(dev, dtype) for _ in range(2))
                k, v = (torch.from_numpy(rng.randn(2, 300, 2, d).astype(
                    np.float32)).to(dev, dtype) for _ in range(2))
                bias = torch.from_numpy(rng.randn(2, tq, 300).astype(
                    np.float32)).to(dev)
                kw = dict(sm_scale=d ** -0.5, causal=True, q_offset=300 - tq)
                fwds, bwds = [], []
                for mod in (fa, was_fa):
                    out, lse = mod.flash_fwd_kernel(q, k, v, None, None,
                                                    **kw)
                    fwds.append([out, lse])
                    got = []
                    if tq > 1:
                        delta = fa._delta(do, out)
                        args = (q, k, v, do, lse, delta, None)
                        got += [mod.flash_bwd_dq_kernel(*args, None, **kw),
                                *mod.flash_bwd_dkv_kernel(*args, None,
                                                          **kw)[:2],
                                mod.flash_bwd_db2_kernel(*args, bias, **kw)]
                    bwds.append(got)
                torch.cuda.synchronize()
                rows.append(dict(
                    head_dim=d, dtype=str(dtype), q_len=tq,
                    fwd_bit_equal=all(torch.equal(a, b)
                                      for a, b in zip(*fwds)),
                    bwd_bit_equal=all(torch.equal(a, b)
                                      for a, b in zip(*bwds))))
    for part in ("fwd", "bwd"):
        key = f"{part}_bit_equal"
        print(f"      flash {part} kernels at widths <= 256 equal the other "
              f"checkout's bit for bit: {sum(r[key] for r in rows)} of "
              f"{len(rows)} cases"
              + "".join(f"; differ: {r}" for r in rows if not r[key]),
              flush=True)
    return rows


# -- phase 7: LayerNorm backward --------------------------------------------------

def layer_norm_bwd_cases(fln, dev):
    """The input-gradient kernel against its plain version at the
    training step's rows (8 x 1023) and at 8 rows."""
    rng = np.random.RandomState(7)
    w = torch.from_numpy((1 + 0.1 * rng.randn(768)).astype(np.float32)).to(dev)
    cases = []
    for rows, dtypes in ((8184, (torch.bfloat16, torch.float32)),
                         (8, (torch.bfloat16, torch.float32)),
                         (2048, (torch.bfloat16,))):
        for dtype in dtypes:
            tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
            x, g = (torch.from_numpy(rng.randn(rows, 768).astype(np.float32))
                    .to(dev, dtype) for _ in range(2))
            _, mean, invvar = fln.layer_norm_fwd_kernel(x, w, None, 1e-5)
            got = fln.layer_norm_bwd_kernel(g, x, mean, invvar, w)
            want = fln._bwd_input_ref(g, x, mean, invvar, w)
            torch.cuda.synchronize()
            err = max_err(got, want)
            name = f"layer_norm_bwd [{rows}, 768] {str(dtype)[6:]}"
            check(err <= tol, f"{name}: max_abs_err {err:.3g} <= {tol}")
            bms, by = bound(costs().layer_norm_bwd(g, x, w))
            wd = w.to(dtype)
            m2, r2 = mean[:, None], invvar[:, None]
            case = dict(
                case=name, max_abs_err=err,
                ms=time_ms(lambda: fln.layer_norm_bwd_kernel(
                    g, x, mean, invvar, w)),
                eager_ms=eager_ms(lambda: fln.layer_norm_bwd_kernel(
                    g, x, mean, invvar, w)),
                plain_ms=time_ms(lambda: fln._bwd_input_ref(
                    g, x, mean, invvar, w)),
                library_ms=time_ms(
                    lambda: torch.ops.aten.native_layer_norm_backward(
                        g, x, [768], m2, r2, wd, None,
                        [True, False, False])),
                bound_ms=bms, bound_by=by)
            print(f"      {name}: kernel {case['ms']:.4f} ms (eager "
                  f"{case['eager_ms']:.4f}), plain {case['plain_ms']:.4f} "
                  f"ms, library {case['library_ms']:.4f} ms, bound "
                  f"{bms:.4f} ms ({by})", flush=True)
            cases.append(case)
    return cases


# -- phase 8: flash backward ------------------------------------------------------

#: phase 8's width-64 bf16/fp16 cases, where the wgmma route must beat the
#: mma.sync kernel on the same inputs
FLASH_BWD_MUST_BEAT_MMA = ("causal b8 t1023", "gqa 12/4", "window 256",
                           "fp16 causal", "head_dim 128 causal")


def flash_bwd_cases(fa, dev, was_fa=None):
    """dQ and dK/dV against their plain version at gpt2_small training
    shapes (B 8, T 1023, 12 heads of 64; a case's shape may give its own
    batch), each on the route the rule picks (printed).  Where that is
    wgmma, the mma.sync kernels on the same inputs are held to the plain
    version too and timed beside it (slower at
    ``FLASH_BWD_MUST_BEAT_MMA``); with ``was_fa`` the other checkout's
    kernels are timed too.  ``plain_ms`` and ``library_ms`` are
    each one call computing dq, dk and dv together (``_flash_bwd_ref``;
    the backward of one SDPA call, ``torch.autograd.grad`` on a retained
    graph captured in a CUDA graph as the kernels are, its eager time
    beside it), so both kernels carry the same two numbers."""
    rng = np.random.RandomState(8)
    t, h = 1023, 12
    bf16 = torch.bfloat16
    specs = [
        # name, h_kv, dtype, causal, window, kbias needs grad, head_dim,
        # [B, T, S] bias, (q_len, kv_len[, batch, 8 if not given])
        ("causal b8 t1023", h, bf16, True, None, False, 64, False, (t, t)),
        ("gqa 12/4", 4, bf16, True, None, False, 64, False, (t, t)),
        ("window 256", h, bf16, True, 256, False, 64, False, (t, t)),
        ("fp32 causal", h, torch.float32, True, None, False, 64, False,
         (t, t)),
        ("key bias grad, full", h, bf16, False, None, True, 64, False,
         (t, t)),
        ("fp16 causal", h, torch.float16, True, None, False, 64, False,
         (t, t)),
        ("head_dim 16 causal", h, bf16, True, None, False, 16, False, (t, t)),
        ("head_dim 48 causal", h, bf16, True, None, False, 48, False, (t, t)),
        ("head_dim 128 causal", h, bf16, True, None, False, 128, False,
         (t, t)),
        ("head_dim 256 causal", h, bf16, True, None, False, 256, False,
         (t, t)),
        # wider than the widest kernel (256-wide slices), at B 1, T 1024
        ("head_dim 320 causal b1 t1024", h, bf16, True, None, False, 320,
         False, (1024, 1024, 1)),
        ("head_dim 512 causal b1 t1024", h, bf16, True, None, False, 512,
         False, (1024, 1024, 1)),
        ("[B,T,S] bias, full", h, bf16, False, None, False, 64, True, (t, t)),
        # queries the suffix of the keys, neither length a tile multiple
        ("cross causal tq 333 tk 1021", h, bf16, True, None, False, 64,
         False, (333, 1021)),
        # the BERT step's backward: B 16, T 128, every key visible
        ("bert b16 t128 full", h, bf16, False, None, False, 64, False,
         (128, 128, 16)),
    ]
    dq_cases, dkv_cases = [], []
    for (name, h_kv, dtype, causal, window, kgrad, d, with_bias,
         (tq, tk, *batch)) in specs:
        b = batch[0] if batch else 8
        q, do = (torch.from_numpy(rng.randn(b, tq, h, d).astype(np.float32))
                 .to(dev, dtype) for _ in range(2))
        k, v = (torch.from_numpy(rng.randn(b, tk, h_kv, d).astype(np.float32))
                .to(dev, dtype) for _ in range(2))
        kb = bias = None
        if kgrad:
            kb = torch.from_numpy(
                (0.5 * rng.randn(b, tk)).astype(np.float32)).to(dev)
        if with_bias:
            bias = torch.from_numpy(
                (0.5 * rng.randn(b, tq, tk)).astype(np.float32)).to(dev)
        q_offset = tk - tq if causal else 0
        kw = dict(sm_scale=d ** -0.5, causal=causal, q_offset=q_offset,
                  window=window)
        out, lse = fa.flash_fwd_kernel(q, k, v, kb, bias, **kw)
        delta = fa._delta(do, out)
        args = (q, k, v, do, lse, delta, kb, bias)

        def run_dq():
            return fa.flash_bwd_dq_kernel(*args, **kw)

        def run_dkv():
            return fa.flash_bwd_dkv_kernel(*args, kbias_grad=kgrad, **kw)

        def run_plain():
            return fa._flash_bwd_ref(q, k, v, kb, bias, out, lse, do, **kw)

        def errors(dq, dk, dv, part, want):
            errs = dict(dq=max_err(dq, want[0]), dk=max_err(dk, want[1]),
                        dv=max_err(dv, want[2]))
            if kgrad:
                errs["dkbias"] = max_err(part.sum(1) / kw["sm_scale"],
                                         want[3])
            return errs

        dq, route = launched_route(fa.flash_bwd_dq_kernel, run_dq)
        (dk, dv, part), dkv_route = launched_route(fa.flash_bwd_dkv_kernel,
                                                   run_dkv)
        want = run_plain()
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 3e-2
        errs = errors(dq, dk, dv, part, want)
        check(all(e <= tol for e in errs.values()) and route == dkv_route,
              f"flash bwd {name} ({route}): max_abs_err "
              + ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items())
              + f" <= {tol} (max |dq| {dq.float().abs().max().item():.3g},"
              f" |dk| {dk.float().abs().max().item():.3g}, |dv| "
              f"{dv.float().abs().max().item():.3g})")
        mma_errs = None
        if route == "wgmma":
            # the mma.sync kernels on the same inputs
            mdq = fa.flash_bwd_dq_kernel(*args, route="mma", **kw)
            mdk, mdv, mpart = fa.flash_bwd_dkv_kernel(
                *args, kbias_grad=kgrad, route="mma", **kw)
            torch.cuda.synchronize()
            mma_errs = errors(mdq, mdk, mdv, mpart, want)
            check(all(e <= tol for e in mma_errs.values()),
                  f"flash bwd {name} (mma, the same inputs): max_abs_err "
                  + ", ".join(f"{k_} {e:.3g}" for k_, e in mma_errs.items())
                  + f" <= {tol}")
            del mdq, mdk, mdv, mpart
        del want
        masks = dict(causal=causal, q_offset=q_offset, window=window)
        dq_cost = costs().flash_bwd_dq(q, k, v, kb, bias, **masks)
        dkv_cost = costs().flash_bwd_dkv(q, k, v, kb, bias, kbias_grad=kgrad,
                                         **masks)
        plain_ms = time_ms(run_plain, iters=3)
        # the library yardstick: SDPA's backward on a retained graph,
        # KV heads repeated up front (untimed)
        qt, kt, vt = (x.repeat_interleave(h // x.shape[2], dim=2)
                      .transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib = dict(is_causal=True) if causal and window is None else {}
        if window is not None or (causal and tq != tk):
            lib = dict(attn_mask=fa._visible(tq, tk, q_offset, window, dev))
        if kb is not None:
            lib = dict(attn_mask=kb[:, None, None, :].to(dtype))
        if bias is not None:
            lib = dict(attn_mask=bias[:, None].to(dtype))
        # the forward on the stream its backward is captured on (autograd
        # runs a backward op on its forward's stream)
        lib_stream = torch.cuda.Stream()
        lib_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(lib_stream):
            lout = F.scaled_dot_product_attention(qt, kt, vt,
                                                  scale=d ** -0.5, **lib)
        torch.cuda.current_stream().wait_stream(lib_stream)
        dot = do.transpose(1, 2)

        def run_library():
            return torch.autograd.grad(lout, (qt, kt, vt), dot,
                                       retain_graph=True)
        # timed as the kernels are (its backward kernels captured in a
        # graph of 5 calls), and eagerly, host cost included
        library_eager_ms = eager_ms(run_library, iters=5)
        library_ms = time_ms(run_library, iters=5, stream=lib_stream)
        for cases, fn, mma_fn, was_fn, cost, keys, rt in (
                (dq_cases, run_dq,
                 lambda: fa.flash_bwd_dq_kernel(*args, route="mma", **kw),
                 was_fa and (lambda: was_fa.flash_bwd_dq_kernel(*args,
                                                                **kw)),
                 dq_cost, ("dq",), route),
                (dkv_cases, run_dkv,
                 lambda: fa.flash_bwd_dkv_kernel(*args, kbias_grad=kgrad,
                                                 route="mma", **kw),
                 was_fa and (lambda: was_fa.flash_bwd_dkv_kernel(
                     *args, kbias_grad=kgrad, **kw)),
                 dkv_cost, ("dk", "dv", "dkbias"), dkv_route)):
            bms, by = bound(cost)
            case = dict(case=name, route=rt, max_abs_err=max(
                            e for k_, e in errs.items() if k_ in keys),
                        ms=time_ms(fn, iters=5),
                        eager_ms=eager_ms(fn, iters=5),
                        plain_ms=plain_ms, library_ms=library_ms,
                        library_eager_ms=library_eager_ms,
                        bound_ms=bms, bound_by=by, mma_ms=None,
                        mma_eager_ms=None, was_ms=None,
                        was_eager_ms=None)
            line = ""
            if rt == "wgmma":
                case["mma_max_abs_err"] = max(
                    e for k_, e in mma_errs.items() if k_ in keys)
                case["mma_ms"] = time_ms(mma_fn, iters=5)
                case["mma_eager_ms"] = eager_ms(mma_fn, iters=5)
                line += (f", mma.sync {case['mma_ms']:.4f} ms (eager "
                         f"{case['mma_eager_ms']:.4f})")
                if name in FLASH_BWD_MUST_BEAT_MMA:
                    check(case["ms"] < case["mma_ms"],
                          f"flash bwd {fn.__name__[4:]} {name}: wgmma "
                          f"{case['ms']:.4f} ms < mma.sync "
                          f"{case['mma_ms']:.4f} ms")
            if was_fn:
                case["was_ms"] = time_ms(was_fn, iters=5)
                case["was_eager_ms"] = eager_ms(was_fn, iters=5)
                line += (f", was {case['was_ms']:.4f} ms (eager "
                         f"{case['was_eager_ms']:.4f})")
            cases.append(case)
            print(f"      flash bwd {fn.__name__[4:]} {name} ({rt}): kernel "
                  f"{case['ms']:.4f} ms (eager {case['eager_ms']:.4f}), "
                  f"plain (dq+dk+dv) {plain_ms:.4f} ms, library (dq+dk+dv) "
                  f"{library_ms:.4f} ms (eager {library_eager_ms:.4f}), "
                  f"bound {bms:.4f} ms ({by}){line}", flush=True)
        del lout, qt, kt, vt
    return dq_cases, dkv_cases


# -- phase 5: serving ------------------------------------------------------------

def _pct(values, q):
    values = sorted(values)
    return values[min(len(values) - 1, int(q * (len(values) - 1)))] * 1e3


def eager_engine_cls(engine_mod):
    """The serving engine with every step run eagerly: its ``_dispatch``
    calls the step body the graphs capture, and its warmup runs each body
    once on the trash page (the comparison's eager side; the engine
    itself has no such switch)."""
    class EagerEngine(engine_mod.ServingEngine):
        def _dispatch(self, kind, bucket, args):
            return self._body(kind, bucket)(*args)

        def warmup(self, buckets=None):
            for b in (self.buckets if buckets is None else buckets):
                for kind in ("prefill", "decode"):
                    host = self._host_args(kind, b)
                    host.zero_()
                    host[-1] = 1 if kind == "prefill" else 0
                    self._dispatch(kind, b, (host,))
            torch.cuda.synchronize()
            return self
    return EagerEngine


def graph_pool_bytes() -> int:
    """Bytes the CUDA allocator holds in private pools, the memory of the
    graphs alive in this process (the allocator's snapshot tags each
    segment with its pool; the default pool is (0, 0))."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def _serve(model, cls, prompts, dev, cache_dtype):
    """One engine of ``cls`` over ``prompts`` (32 new tokens each):
    ``(results, stats, numbers)``."""
    eng = cls(model, buckets=(256, 1024), page_size=16, max_seqs=8,
              cache_dtype=cache_dtype, device=dev)
    preps = [preparations(model)]
    gc.collect()
    torch.cuda.empty_cache()       # the pools of graphs freed before
    pools = graph_pool_bytes()
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_captures = eng.stats["captures"]
    pool_bytes = graph_pool_bytes() - pools
    preps.append(preparations(model))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = eng.generate(prompts, max_new_tokens=32)
    wall = time.perf_counter() - t0
    preps.append(preparations(model))
    st = dict(eng.stats)
    eng.close()
    ok = [r for r in results if r.ok]
    return results, st, dict(
        kv_cache_dtype=eng.kv_cache_dtype,
        warmup_s=warm_s, warmup_captures=warm_captures,
        graph_pool_bytes=pool_bytes, wall_s=wall,
        tokens_out=st["tokens_out"], tokens_per_s=st["tokens_out"] / wall,
        prefills=st["prefills"], decode_steps=st["decode_steps"],
        captures_serving=st["captures"] - warm_captures,
        aot_misses=st["aot_misses"], replays=st["replays"],
        prefill_ms_mean=st["prefill_s"] / max(1, st["prefills"]) * 1e3,
        decode_step_ms_mean=st["decode_s"] / max(1, st["decode_steps"]) * 1e3,
        ttft_p50_ms=_pct([r.timings["ttft_s"] for r in ok], 0.5),
        ttft_p99_ms=_pct([r.timings["ttft_s"] for r in ok], 0.99),
        tpot_p50_ms=_pct([r.timings["tpot_s"] for r in ok], 0.5),
        tpot_p99_ms=_pct([r.timings["tpot_s"] for r in ok], 0.99),
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        preparations_warmup=preps[1] - preps[0],
        preparations_served=preps[2] - preps[1])


def _serve_line(tag, res):
    return (f"{tag}: {res['tokens_out']} tokens in {res['wall_s']:.3f} s "
            f"({res['tokens_per_s']:.1f} tok/s); ttft p50 "
            f"{res['ttft_p50_ms']:.2f} / p99 {res['ttft_p99_ms']:.2f} ms; "
            f"tpot p50 {res['tpot_p50_ms']:.2f} / p99 "
            f"{res['tpot_p99_ms']:.2f} ms; prefill "
            f"{res['prefill_ms_mean']:.2f} ms, decode step "
            f"{res['decode_step_ms_mean']:.3f} ms host (means); peak memory "
            f"{res['max_memory_allocated_bytes'] / 2**30:.2f} GiB; warmup "
            f"{res['warmup_s']:.2f} s, {res['warmup_captures']} graphs, "
            f"graph pools {res['graph_pool_bytes'] / 2**20:.1f} MiB")


def serve_gpt2_small(model, engine_mod, counters, dev, per_forward,
                     cache_dtype=None):
    """The phase-5 load (16 requests of 32-900 prompt tokens, 32 new
    tokens, buckets (256, 1024), page 16, 8 slots) through the captured
    ``ServingEngine``: every launch counter set to 0 just before the
    engine is made and read after it served, each equal to
    ``per_forward`` x the forwards that ran on the card (the warmup's
    warm run of every (kind, bucket), then one replay a prefill and a
    decode step; 0 where it is not named), no capture and no AOT miss
    while serving.  Then the
    same load through the eager engine (the bodies the graphs captured):
    greedy tokens equal bit for bit, its numbers beside."""
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, model.vocab_size, (int(n),))
               for n in rng.randint(32, 901, 16)]
    fa = counters["flash_attention_fwd"]
    fa_mod = importlib.import_module(fa.__module__)
    for c in counters.values():
        c.launches = 0
    zero_routes(fa_mod)
    zero_wrapper_routes(counters["qmm"])
    results, st, res = _serve(model, engine_mod.ServingEngine, prompts, dev,
                              cache_dtype)
    launches = {name: c.launches for name, c in counters.items()}
    qmm_routes = dict(counters["qmm"].routes)
    cache = importlib.import_module("apex_tpu_torch.cache")
    forwards = cache.WARM_RUNS * res["warmup_captures"] + res["replays"]
    tag = res["kv_cache_dtype"]
    check(all(r.ok and len(r.tokens) == 32 for r in results),
          f"gpt2_small ({tag} KV): {sum(r.ok for r in results)}/16 "
          f"requests served")
    check(res["warmup_captures"] == 4 and res["captures_serving"] == 0
          and res["aot_misses"] == 0
          and res["replays"] == st["prefills"] + st["decode_steps"],
          f"gpt2_small ({tag} KV): {res['warmup_captures']} graphs captured "
          f"at warmup (4), {res['captures_serving']} while serving and "
          f"{res['aot_misses']} AOT misses (0), {res['replays']} replays = "
          f"{st['prefills']} prefills + {st['decode_steps']} decode steps")
    check(all(launches[n] == per_forward.get(n, 0) * forwards
              for n in launches),
          f"gpt2_small ({tag} KV): launches {launches} = {per_forward} x "
          f"{forwards} forwards (the warmup's warm runs and the "
          f"replays)")
    res["flash_routes"] = route_gate(fa_mod, f"gpt2_small ({tag} KV)",
                                     launches["flash_attention_fwd"],
                                     decode=True)
    # a warm run of each bucket's prefill and decode, then one replay a
    # prefill or decode step: 12 forwards a layer stack each
    per = per_forward["flash_attention_fwd"]
    warm = cache.WARM_RUNS * res["warmup_captures"] // 2
    want = {"wgmma": per * (warm + st["prefills"]),
            "decode": per * (warm + st["decode_steps"])}
    check({r: n for r, n in res["flash_routes"].items() if n} == want,
          f"gpt2_small ({tag} KV): flash forward routes "
          f"{res['flash_routes']} = {want} ({per} a prefill forward on "
          f"wgmma, {per} a decode step on decode)")
    eager_results, _, eager = _serve(model, eager_engine_cls(engine_mod),
                                     prompts, dev, cache_dtype)
    same = sum(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(results, eager_results))
    check(same == 16, f"gpt2_small ({tag} KV): captured greedy tokens equal "
          f"the eager bodies' in {same}/16 requests")
    res.update(kv_bytes_per_token=st["kv_bytes_per_token"],
               tokens=[r.tokens.tolist() for r in results],
               buckets=sorted({r.bucket for r in results if r.ok}),
               launches={n: v for n, v in launches.items() if v},
               tokens_equal_eager=same, eager=eager,
               preparations_per_decode_step=res["preparations_served"]
               / max(1, st["decode_steps"]))
    if per_forward.get("qmm"):
        res["qmm_routes"] = qmm_route_gate(
            f"gpt2_small ({tag} KV)", qmm_routes, launches["qmm"],
            decode=True)
        check(res["preparations_warmup"] == per_forward["qmm"]
              and res["preparations_served"] == 0,
              f"gpt2_small ({tag} KV): weight preparations "
              f"{res['preparations_warmup']} at the engine's warmup "
              f"({per_forward['qmm']}: each site once), "
              f"{res['preparations_served']} while serving (0)")
    print("      " + _serve_line(f"captured ({tag} KV, "
                                 f"{res['kv_bytes_per_token']} B/token)",
                                 res), flush=True)
    print("      " + _serve_line("eager", eager), flush=True)
    return res


def serve_alternated(sides, dev, tag, cache_dtype=None, rounds=2):
    """With ``--was``: the phase-5 load (the same 16 prompts) through this
    checkout's captured engine and the other checkout's (``sides``: name
    -> (model, engine module), each model built by its checkout), in one
    process, alternated ``rounds`` times as was, this, this, was, so the
    host's drift falls on both alike: every run's tokens/s, TTFT and TPOT
    p50/p99 and host ms a decode step, printed, and each side's median
    (no gate: another checkout's kernels)."""
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, sides["this"][0].vocab_size, (int(n),))
               for n in rng.randint(32, 901, 16)]
    keys = ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms",
            "tpot_p99_ms", "decode_step_ms_mean")
    runs = {"was": [], "this": []}
    for who in ("was", "this", "this", "was") * rounds:
        model, engine_mod = sides[who]
        results, _, res = _serve(model, engine_mod.ServingEngine, prompts,
                                 dev, cache_dtype)
        runs[who].append(dict({k: res[k] for k in keys},
                              ok=sum(r.ok for r in results)))
        print("      " + _serve_line(f"{who} ({tag}, run {len(runs[who])})",
                                     res), flush=True)
    out = dict(runs=runs, order="was, this, this, was" + f" x {rounds}")
    for who, rs in runs.items():
        out[who] = {k: float(np.median([r[k] for r in rs])) for k in keys}
    print(f"      {tag} alternated, medians of {2 * rounds} runs each: this "
          f"{out['this']['tokens_per_s']:.1f} tok/s, tpot p50 / p99 "
          f"{out['this']['tpot_p50_ms']:.2f} / "
          f"{out['this']['tpot_p99_ms']:.2f} ms; was "
          f"{out['was']['tokens_per_s']:.1f} tok/s, "
          f"{out['was']['tpot_p50_ms']:.2f} / "
          f"{out['was']['tpot_p99_ms']:.2f} ms", flush=True)
    return out


def preparations(model) -> int:
    """Weight preparations so far of every int8 site of ``model``."""
    from apex_tpu_torch.quant import QuantDenseGeneral
    return sum(m.preparations for m in model.modules()
               if isinstance(m, QuantDenseGeneral))


def kind_tables():
    """The kernel-kind tables (``apex_tpu_torch.prof.parse``:
    ``SERVING_KINDS``, ``TRAINING_KINDS``, ``RESNET_KINDS``) and
    ``kernel_kind``, shared with the trace parser."""
    return importlib.import_module("apex_tpu_torch.prof.parse")


def _kind(name: str) -> str:
    return kind_tables().kernel_kind(name, kind_tables().SERVING_KINDS)


def where_time_goes(model, engine_mod, dev, cache_dtype=None,
                    engine_cls=None):
    """One traced serving run (8 prompts of 600-900 tokens, 16 new tokens
    each: prefills and decode steps at the 1024 bucket) under
    ``torch.profiler``, through the captured engine (or ``engine_cls``,
    the eager one): device busy share of the wall time, and per step
    kind (the engine's ``prefill[b]`` / ``decode[b]`` ranges around each
    dispatch and its read) the host time, the device time and the device
    time by kernel kind.  Each step ends in a host sync, so a kernel (a
    graph's, too) belongs to the last range that began before it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(5)
    cls = engine_cls or engine_mod.ServingEngine
    eng = cls(model, buckets=(256, 1024), page_size=16, max_seqs=8,
              cache_dtype=cache_dtype, device=dev).warmup()
    prompts = [rng.randint(1, model.vocab_size, (int(n),))
               for n in rng.randint(600, 901, 8)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=16)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.close()
    events = prof.events()
    is_range = lambda n: n.startswith(("prefill[", "decode["))  # noqa: E731
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events
                    if e.device_type == DeviceType.CPU and is_range(e.name))
    cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in events
                     if e.device_type == DeviceType.CUDA
                     and e.name not in cpu_names)
    starts = [r[0] for r in ranges]
    steps = {}
    for lo, hi, name in ranges:
        st = steps.setdefault(name, {"count": 0, "host_us": 0.0,
                                     "device_us": 0.0, "kinds_us": {},
                                     "kernels": 0})
        st["count"] += 1
        st["host_us"] += hi - lo
    busy, edge = 0.0, None
    for lo, hi, name in kernels:
        lo2 = lo if edge is None else max(lo, edge)
        busy += max(0.0, hi - lo2)
        edge = hi if edge is None else max(edge, hi)
        i = int(np.searchsorted(starts, lo, side="right")) - 1
        if i < 0:
            continue
        st = steps[ranges[i][2]]
        st["kernels"] += 1
        st["device_us"] += hi - lo
        st["kinds_us"][_kind(name)] = (st["kinds_us"].get(_kind(name), 0.0)
                                       + hi - lo)
    res = dict(profile_wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
               device_idle_share=1 - busy / wall_us if wall_us else None,
               kernels_traced=len(kernels), steps={})
    for name, st in sorted(steps.items()):
        n = st["count"]
        res["steps"][name] = dict(
            count=n, host_ms=st["host_us"] / n / 1e3,
            device_ms=st["device_us"] / n / 1e3,
            kernels_per_step=st["kernels"] / n,
            device_ms_by_kind={k: v / n / 1e3
                               for k, v in sorted(st["kinds_us"].items())})
        kinds = ", ".join(f"{k} {v / n / 1e3:.3f}"
                          for k, v in sorted(st["kinds_us"].items()))
        print(f"      {name} x{n}: host {st['host_us'] / n / 1e3:.2f} ms, "
              f"device {st['device_us'] / n / 1e3:.3f} ms, "
              f"{st['kernels'] / n:.1f} kernels per step ({kinds})",
              flush=True)
    print(f"      traced run ({cls.__name__}): wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.1f} ms, idle share "
          f"{res['device_idle_share']:.3f}, {len(kernels)} kernels",
          flush=True)
    check(len(kernels) > 0, "profiler traced device kernels")
    return res


def prefill_logits(models, dev):
    """A 256-token prefill through the engine's incremental forward, on
    the card (bf16 and fp32 weights) and on the CPU (fp32), same seed."""
    ids = np.random.RandomState(3).randint(1, 50257, (1, 256))

    def run(dtype, device):
        m = models.gpt2_small(dtype=dtype, device=device, seed=0)
        with torch.inference_mode():
            caches = models.init_cache(m, 1, cache_len=256)
            logits, _ = m(torch.from_numpy(ids).to(device), kv_caches=caches,
                          positions=torch.zeros((1,), dtype=torch.long,
                                                device=device))
        return logits.float().cpu()

    want = run(torch.float32, "cpu")
    res = {}
    for dtype, tol in ((torch.float32, 2e-3), (torch.bfloat16, 0.25)):
        err = max_err(run(dtype, dev), want)
        name = str(dtype)[6:]
        check(err <= tol, f"gpt2_small 256-token prefill logits, card "
              f"{name} vs CPU fp32: max_abs_err {err:.3g} <= {tol}")
        res[f"logits_{name}_vs_cpu_fp32_max_abs_err"] = err
    return res


def tiny_tokens(models, engine_mod, dev):
    """gpt_tiny served in fp32 on the card and on the CPU: equal greedy
    tokens, except after a step whose CPU top-2 logit gap is < 1e-4."""
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 1024, (int(n),))
               for n in rng.randint(4, 200, 12)]
    toks = {}
    for device in (dev, "cpu"):
        m = models.gpt_tiny(dtype=torch.float32, device=device, seed=1)
        eng = engine_mod.ServingEngine(m, buckets=(128, 256), page_size=16,
                                       max_seqs=4, device=device)
        toks[str(device)] = [r.tokens for r in eng.generate(prompts, 24)]
        eng.close()
    cpu_model = models.gpt_tiny(dtype=torch.float32, device="cpu", seed=1)
    mismatched, ties = 0, []
    for p, a, b in zip(prompts, toks[str(dev)], toks["cpu"]):
        if np.array_equal(a, b):
            continue
        mismatched += 1
        j = int(np.argmax(a != b))       # first divergent step
        with torch.inference_mode():
            ids = torch.from_numpy(np.concatenate([p, b[:j]]))[None]
            top2 = cpu_model(ids)[0, -1].topk(2).values
        ties.append(float(top2[0] - top2[1]))
    gap_ok = all(g < 1e-4 for g in ties)
    check(gap_ok, f"gpt_tiny fp32 tokens card vs CPU: {12 - mismatched}/12 "
          f"identical; top-2 gaps at divergence {ties}")
    return dict(tiny_identical=12 - mismatched, tiny_divergence_gaps=ties)


# -- phase 9: training ------------------------------------------------------------

TRAIN_ARGS = ["--synthetic", "-b", "8", "--seq-len", "1024", "--vocab",
              "50257", "--hidden", "768", "--layers", "12", "--heads", "12",
              "--opt-level", "O2", "--lr", "3e-4", "--weight-decay", "0.1"]


def pipeline_gate(name, pipe, steps, k=1):
    """The trainer's pipeline captured its hot loop once (K steps, after
    one warm run of them) and replayed it once a window; returns the
    steps that ran on the card (the warm run's and the replays')."""
    cache = importlib.import_module("apex_tpu_torch.cache")
    check(pipe["captures"] == {"hot": 1, "tail": 0}
          and pipe["replays"] == steps // k and pipe["steps"] == steps,
          f"{name}: {pipe['captures']} captures (one hot loop), "
          f"{pipe['replays']} replays for {steps} steps at K {k}")
    return cache.WARM_RUNS * k + steps


def train_gpt2_small(main_amp, counters, steps=10):
    """The LM trainer's entry point at GPT-2 small, bf16 O2, Adam: every
    launch counter set to 0 just before and read just after."""
    args = main_amp.parse(TRAIN_ARGS + ["--steps", str(steps)])
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    zero_bwd_routes(fa)
    res = main_amp.train(args, log=lambda line: print("      " + line,
                                                      flush=True))
    launches = {name: c.launches for name, c in counters.items()}
    flash_bwd_routes = bwd_route_gate(
        "gpt2_small training", bwd_routes(fa),
        {"dq": launches["flash_attention_bwd_dq"],
         "dkv": launches["flash_attention_bwd_dkv"]})
    ran = pipeline_gate("gpt2_small training", res["pipeline"], steps)
    per_step = LM_PER_STEP
    check(all(launches[n] == per_step.get(n, 0) * ran
              for n in launches),
          f"gpt2_small training: launches {launches} = "
          f"{per_step} x {ran} steps (the warm run and the "
          f"replays)")
    losses = res["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"gpt2_small training: losses finite, step {steps} "
          f"{losses[-1]:.4f} < step 1 {losses[0]:.4f}")
    step_ms = float(np.median(res["step_s"][2:])) * 1e3
    out = dict(losses=losses, step_ms_all=[x * 1e3 for x in res["step_s"]],
               step_ms_median_3_10=step_ms,
               tokens_per_s=res["tokens_per_step"] / step_ms * 1e3,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               launches=launches, flash_bwd_routes=flash_bwd_routes)
    print(f"      gpt2_small O2 B8 T1023: step {step_ms:.2f} ms (median of "
          f"steps 3-{steps}), {out['tokens_per_s']:.0f} tok/s, peak memory "
          f"{out['max_memory_allocated_bytes'] / 2**30:.2f} GiB", flush=True)
    return out


def trace_training(trainer, argv, kinds=None):
    """Two training steps of ``trainer`` (an example module with
    ``parse`` and ``build``) under ``torch.profiler``: device time by
    kind and the device's idle share of the wall time."""
    return trace_steps(*trainer.build(trainer.parse(argv)), kinds)


def trace_steps(state, step_fn, batch, kinds=None, logdir=None,
                counters=None):
    """One warm step, then two steps of ``step_fn`` under
    ``torch.profiler`` (with ``logdir``, ``prof.capture.trace``'s: its
    Chrome trace written there for ``prof.parse``); with ``counters``,
    their launches over the two steps in ``launches``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    kinds = kinds or kind_tables().TRAINING_KINDS
    state, m = step_fn(state, batch)          # warm: compiles, allocates
    m["loss"].item()
    for c in (counters or {}).values():
        c.launches = 0
    ctx = (importlib.import_module("apex_tpu_torch.prof.capture").trace(
        logdir) if logdir else profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA]))
    with ctx as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state, m = step_fn(state, batch)
            m["loss"].item()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launches = {n: c.launches for n, c in (counters or {}).items()}
    # the user ranges (the models' scopes, optimizer.update) show on the
    # device's timeline too: they are no kernels
    events = prof.events()
    cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in events
                     if e.device_type == DeviceType.CUDA
                     and e.name not in cpu_names)
    busy, edge, by_kind, by_name = 0.0, None, {}, {}
    for lo, hi, name in kernels:
        lo2 = lo if edge is None else max(lo, edge)
        busy += max(0.0, hi - lo2)
        edge = hi if edge is None else max(edge, hi)
        low = name.lower()
        kind = next((k for k, keys in kinds
                     if any(key in low for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + (hi - lo)
        by_name[name] = by_name.get(name, 0.0) + (hi - lo)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    # the device time of the kernels each named range launched
    ranges = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name == "optimizer.update":
            ranges[e.name] = ranges.get(e.name, 0.0) + e.device_time_total
    res = dict(wall_ms_per_step=wall_us / 2e3,
               ranges_device_ms={k: v / 2e3 for k, v in ranges.items()},
               device_busy_ms_per_step=busy / 2e3,
               device_idle_share=1 - busy / wall_us,
               device_ms_per_step_by_kind={k: v / 2e3 for k, v in
                                           sorted(by_kind.items())},
               top_kernels_ms_per_step=[(n[:100], v / 2e3) for n, v in top],
               kernels_per_step=len(kernels) / 2, launches=launches)
    print(f"      traced training step: wall {res['wall_ms_per_step']:.2f} "
          f"ms, device busy {res['device_busy_ms_per_step']:.2f} ms, idle "
          f"share {res['device_idle_share']:.3f}, "
          f"{res['kernels_per_step']:.0f} kernels; by kind (ms) "
          + ", ".join(f"{k} {v:.2f}" for k, v in
                      res["device_ms_per_step_by_kind"].items()),
          flush=True)
    for n, v in res["top_kernels_ms_per_step"]:
        print(f"        {v:8.3f} ms  {n}", flush=True)
    check(len(kernels) > 0, "profiler traced the training step's kernels")
    return res


# -- phase 10: training correctness ------------------------------------------------

def _lm_step(main_amp, training, model, opt_level, loss_scale=None,
             inject=False):
    def loss_fn(p, batch):
        loss = main_amp.lm_loss(torch.func.functional_call(
            model, p, (batch[0],)), batch[1], fused=True)
        return loss * batch[2] if inject else loss
    return training.make_train_step(loss_fn, training.adam(1e-3,
                                                           weight_decay=0.1),
                                    opt_level=opt_level,
                                    loss_scale=loss_scale)


def _zero_grad_leaf(name):
    # the key projection's bias: its gradient is zero in exact arithmetic
    # (a shift of a whole score row, which the softmax cancels)
    return name.endswith("attention.key.bias")


def training_correctness(models, main_amp, training, dev):
    res = {}
    # (a) gpt_tiny O0 fp32, three steps on the card and on the CPU
    states, losses = {}, {}
    for device in (dev, "cpu"):
        m = models.gpt_tiny(dtype=torch.float32, device="cpu", seed=1).to(
            device)
        init, step = _lm_step(main_amp, training, m, "O0")
        st = init(m.state_dict())
        x, y = main_amp.synthetic_batch(4, 129, 1024, device)
        losses[str(device)] = []
        for _ in range(3):
            st, met = step(st, (x, y))
            losses[str(device)].append(met["loss"].item())
        states[str(device)] = st.params
    lerr = max(abs(a - b) / abs(b) for a, b in
               zip(losses[str(dev)], losses["cpu"]))
    perr = max(max_err(states[str(dev)][k].cpu(), v)
               for k, v in states["cpu"].items() if not _zero_grad_leaf(k))
    check(lerr <= 1e-4 and perr <= 1e-4,
          f"gpt_tiny O0 3 steps card vs CPU: loss rel err {lerr:.3g} <= "
          f"1e-4, params max_abs_err {perr:.3g} <= 1e-4")
    res.update(tiny_o0_losses_card=losses[str(dev)],
               tiny_o0_losses_cpu=losses["cpu"], tiny_o0_loss_rel_err=lerr,
               tiny_o0_param_max_abs_err=perr)

    # (b) gpt2_small fp32, one forward and backward at B 1, T 256
    ids = torch.from_numpy(np.random.RandomState(9).randint(
        1, 50257, (1, 257)))
    grads = {}
    for device in (dev, "cpu"):
        m = models.gpt2_small(dtype=torch.float32, device="cpu",
                              seed=0).to(device)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in m.state_dict().items()}
        b = ids.to(device)
        loss = main_amp.lm_loss(torch.func.functional_call(
            m, params, (b[:, :-1],)), b[:, 1:])
        grads[str(device)] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
    rel = {k: max_err(grads[str(dev)][k].cpu(), g)
           / max(g.abs().max().item(), 1e-30)
           for k, g in grads["cpu"].items() if not _zero_grad_leaf(k)}
    worst = max(rel, key=rel.get)
    check(rel[worst] <= 1e-3,
          f"gpt2_small fp32 grads card vs CPU: max relative error "
          f"{rel[worst]:.3g} ({worst}) <= 1e-3")
    res.update(small_grad_max_rel_err=rel[worst], small_grad_worst=worst)

    # (c) gpt_tiny O2, dynamic scale, an inf injected into the loss
    m = models.gpt_tiny(dtype=torch.bfloat16, device=dev, seed=2)
    init, step = _lm_step(main_amp, training, m, "O2", "dynamic",
                          inject=True)
    st = init(m.state_dict())
    x, y = main_amp.synthetic_batch(4, 129, 1024, dev)
    before = {k: v.clone() for k, v in st.params.items()}
    st, met = step(st, (x, y, torch.tensor(float("inf"), device=dev)))
    skipped = (bool(met["overflow"]) and int(st.opt_state.step) == 0
               and all(torch.equal(st.params[k], v)
                       for k, v in before.items()))
    scale1 = met["loss_scale"].item()
    st, met = step(st, (x, y, torch.tensor(1.0, device=dev)))
    applied = (not bool(met["overflow"]) and int(st.opt_state.step) == 1
               and not torch.equal(st.params["wte"], before["wte"]))
    check(skipped and scale1 == 2.0 ** 15 and applied,
          f"gpt_tiny O2 dynamic: inf step skipped {skipped}, scale "
          f"{scale1:.0f} == 32768, next step applied {applied}")
    res.update(o2_dynamic_skip_ok=skipped and applied, o2_scale=scale1)
    return res


# -- phase 11: BN epilogue ---------------------------------------------------------

def _bf16_ordered(t):
    """bf16 bit patterns as integers ordered like the values."""
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def bf16_ulps(a, b) -> int:
    """Largest distance between two bf16 tensors in units in the last
    place."""
    return int((_bf16_ordered(a) - _bf16_ordered(b)).abs().max().item())


def _kernel_err(got, want):
    """(max_abs_err, max bf16 ulps or None, within tolerance): bf16 within
    one ulp, fp32 within 1e-6."""
    err = max_err(got, want)
    if got.dtype == torch.bfloat16:
        ulps = bf16_ulps(got, want)
        return err, ulps, ulps <= 1
    return err, None, err <= 1e-6


BN_CASES = [
    # name, rows, channels, dtype, relu, residual z
    ("[1605632, 64] bf16 relu", 1605632, 64, torch.bfloat16, True, False),
    ("[401408, 256] bf16 relu +z", 401408, 256, torch.bfloat16, True, True),
    ("[6272, 2048] bf16 no relu", 6272, 2048, torch.bfloat16, False, False),
    ("[401408, 256] fp32 relu +z", 401408, 256, torch.float32, True, True),
]


def bn_epilogue_cases(fba, dev):
    """Kernels 4 (forward) and 5 (dx/dz) against their plain versions at
    ResNet-50 B 128 shapes (bn_init, a stage-1 bn3, a stage-4
    downsample_bn, and an fp32 case).  ``library_ms`` is one
    ``F.batch_norm(training=False)`` call (forward) and the backward of
    one (dx), where it computes the same function: no z, no ReLU."""
    gen = torch.Generator(device=dev).manual_seed(11)
    fwd_cases, bwd_cases = [], []
    for name, rows, c, dtype, relu, has_z in BN_CASES:
        def rnd(*shape):
            return torch.randn(*shape, device=dev, generator=gen)
        x, g = rnd(rows, c).to(dtype), rnd(rows, c).to(dtype)
        z = rnd(rows, c).to(dtype) if has_z else None
        mean, w, b = 0.3 * rnd(c), 1 + 0.2 * rnd(c), 0.2 * rnd(c)
        invstd = rnd(c).abs() + 0.5

        def run_fwd():
            return fba.bn_act_fwd_kernel(x, mean, invstd, w, b, z, relu)

        def run_bwd():
            return fba.bn_act_bwd_kernel(g, x, mean, invstd, w, b, z, relu)
        out, (dx, dz) = run_fwd(), run_bwd()
        want_dx, want_dz = fba._bwd_act_ref(g, x, mean, invstd, w, b, z,
                                            relu)
        torch.cuda.synchronize()
        f_err, f_ulps, f_ok = _kernel_err(
            out, fba._fwd_ref(x, mean, invstd, w, b, z, relu))
        b_err, b_ulps, b_ok = _kernel_err(dx, want_dx)
        if has_z:
            z_err, z_ulps, z_ok = _kernel_err(dz, want_dz)
            b_err, b_ok = max(b_err, z_err), b_ok and z_ok
            b_ulps = None if b_ulps is None else max(b_ulps, z_ulps)
        check(f_ok and b_ok and (dz is None) == (z is None),
              f"bn epilogue {name}: fwd max_abs_err {f_err:.3g} (ulps "
              f"{f_ulps}), bwd {b_err:.3g} (ulps {b_ulps}); bf16 <= 1 ulp, "
              f"fp32 <= 1e-6")
        # each input read once, each output written once: forward x (z)
        # in, out; backward g in, dx out, x (and z) in only under ReLU,
        # dz out with a z
        fwd_cost, bwd_cost = costs().bn_act_fwd(x, z), costs().bn_act_bwd(
            x, z, relu)
        lib_fwd = lib_bwd = None
        if not relu and not has_z:
            var = 1.0 / invstd ** 2 - 1e-5
            lib_fwd = time_ms(lambda: F.batch_norm(x, mean, var, w, b, False,
                                                   0.0, 1e-5))
            xr = x.detach().requires_grad_(True)
            lout = F.batch_norm(xr, mean, var, w, b, False, 0.0, 1e-5)
            lib_bwd = eager_ms(lambda: torch.autograd.grad(
                lout, xr, g, retain_graph=True), iters=10)
            del lout, xr
        for cases, fn, plain, cost, err, ulps, lib in (
                (fwd_cases, run_fwd,
                 lambda: fba._fwd_ref(x, mean, invstd, w, b, z, relu),
                 fwd_cost, f_err, f_ulps, lib_fwd),
                (bwd_cases, run_bwd,
                 lambda: fba._bwd_act_ref(g, x, mean, invstd, w, b, z, relu),
                 bwd_cost, b_err, b_ulps, lib_bwd)):
            bms, by = bound(cost)
            case = dict(case=name, max_abs_err=err, max_bf16_ulps=ulps,
                        ms=time_ms(fn), eager_ms=eager_ms(fn),
                        plain_ms=time_ms(plain, iters=5), library_ms=lib,
                        bound_ms=bms, bound_by=by)
            cases.append(case)
            lib_s = "n/a" if lib is None else f"{lib:.4f} ms"
            print(f"      bn {'fwd' if cases is fwd_cases else 'bwd'} "
                  f"{name}: kernel {case['ms']:.4f} ms (eager "
                  f"{case['eager_ms']:.4f}), plain {case['plain_ms']:.4f} "
                  f"ms, library {lib_s}, bound {bms:.4f} ms ({by})",
                  flush=True)
        del x, g, z, out, dx, dz, want_dx, want_dz
    return fwd_cases, bwd_cases


# -- phase 12: softmax cross-entropy ------------------------------------------------

XENT_CASES = [
    # name, rows, vocabulary, dtype, smoothing, padding_idx
    ("[8184, 50257] fp32 s0", 8184, 50257, torch.float32, 0.0, 0),
    ("[8184, 50257] fp32 s0.1", 8184, 50257, torch.float32, 0.1, 0),
    ("[128, 1000] fp32", 128, 1000, torch.float32, 0.0, -1),
    ("[8184, 50257] bf16 s0.1", 8184, 50257, torch.bfloat16, 0.1, 0),
    # the BERT step's tied head: 16 x 128 rows, padding_idx -1
    ("[2048, 30522] fp32 s0.1", 2048, 30522, torch.float32, 0.1, -1),
]


def xentropy_cases(xent, dev):
    """Kernels 6 (losses, mlse) and 7 (dx) against their plain versions
    at the LM step's ``[8184, 50257]`` (every 10th label the padding
    index) and the ResNet step's ``[128, 1000]``.  ``library_ms`` is one
    ``F.cross_entropy(reduction="none")`` call and the backward of one
    (eager), computing the same function."""
    gen = torch.Generator(device=dev).manual_seed(12)
    fwd_cases, bwd_cases = [], []
    for name, n, v, dtype, smoothing, pad in XENT_CASES:
        x = (2 * torch.randn(n, v, device=dev, generator=gen)).to(dtype)
        labels = torch.randint(1, v, (n,), device=dev, generator=gen,
                               dtype=torch.int32)
        if pad >= 0:
            labels[::10] = pad
        g = torch.where(labels == pad, 0.0, 1.0 / n)

        def run_fwd():
            return xent.xentropy_fwd_kernel(x, labels, smoothing)
        loss, mlse = run_fwd()

        def run_bwd():
            return xent.xentropy_bwd_kernel(g, x, mlse, labels, smoothing)
        dx = run_bwd()
        want_loss, want_mlse = xent._fwd_ref(x, labels, smoothing)
        # the backward kernel and its plain version on the same inputs
        # (the kernel's mlse)
        want_dx = xent._bwd_ref(g, x, mlse, labels, smoothing)
        torch.cuda.synchronize()
        f_err = max(max_err(loss, want_loss), max_err(mlse, want_mlse))
        b_err = max_err(dx, want_dx)
        ulps = bf16_ulps(dx, want_dx) if dtype == torch.bfloat16 else None
        b_ok = ulps <= 1 if ulps is not None else b_err <= 1e-5
        check(f_err <= 1e-4 and b_ok,
              f"xentropy {name}: losses/mlse max_abs_err {f_err:.3g} <= "
              f"1e-4, dx {b_err:.3g} (ulps {ulps}); fp32 <= 1e-5, bf16 <= "
              f"1 ulp")
        lab64 = labels.long()
        xr = x.detach().requires_grad_(True)
        lout = F.cross_entropy(xr, lab64, reduction="none",
                               label_smoothing=smoothing, ignore_index=pad)
        lib_bwd = eager_ms(lambda: torch.autograd.grad(
            lout, xr, g.to(lout.dtype), retain_graph=True), iters=5)
        del lout, xr
        lib_fwd = time_ms(lambda: F.cross_entropy(
            x, lab64, reduction="none", label_smoothing=smoothing,
            ignore_index=pad), iters=5)
        for cases, fn, plain, cost, err, lib in (
                (fwd_cases, run_fwd,
                 lambda: xent._fwd_ref(x, labels, smoothing),
                 costs().xentropy_fwd(x), f_err, lib_fwd),
                (bwd_cases, run_bwd,
                 lambda: xent._bwd_ref(g, x, mlse, labels, smoothing),
                 costs().xentropy_bwd(x), b_err, lib_bwd)):
            bms, by = bound(cost)
            case = dict(case=name, max_abs_err=err,
                        max_bf16_ulps=ulps if cases is bwd_cases else None,
                        ms=time_ms(fn, iters=10), eager_ms=eager_ms(fn),
                        plain_ms=time_ms(plain, iters=3), library_ms=lib,
                        bound_ms=bms, bound_by=by)
            cases.append(case)
            print(f"      xentropy {'fwd' if cases is fwd_cases else 'bwd'} "
                  f"{name}: kernel {case['ms']:.4f} ms (eager "
                  f"{case['eager_ms']:.4f}), plain {case['plain_ms']:.4f} "
                  f"ms, library {lib:.4f} ms, bound {bms:.4f} ms ({by})",
                  flush=True)
        del x, dx, want_dx
    return fwd_cases, bwd_cases


# -- phase 15: conv kernels ------------------------------------------------------

CONV_CASES = [
    # name, x shape, w shape, stride, flax padding, dtype, epilogue
    ("stem [128,224,224,3] 7x7/2", (128, 224, 224, 3), (7, 7, 3, 64), 2,
     ((3, 3), (3, 3)), torch.bfloat16, False),
    ("[128,56,56,64] 3x3/1", (128, 56, 56, 64), (3, 3, 64, 64), 1, "SAME",
     torch.bfloat16, False),
    ("[128,56,56,128] 3x3/2 pad (0,1)", (128, 56, 56, 128),
     (3, 3, 128, 128), 2, "SAME", torch.bfloat16, False),
    ("[128,14,14,1024] 1x1 ->256", (128, 14, 14, 1024), (1, 1, 1024, 256),
     1, "SAME", torch.bfloat16, False),
    ("[128,14,14,1024] 1x1/2 ->2048", (128, 14, 14, 1024),
     (1, 1, 1024, 2048), 2, "SAME", torch.bfloat16, False),
    ("fp32 [32,56,56,64] 3x3/1", (32, 56, 56, 64), (3, 3, 64, 64), 1,
     "SAME", torch.float32, False),
    ("[128,56,56,64] 1x1 ->256 +bn,z,relu", (128, 56, 56, 64),
     (1, 1, 64, 256), 1, "SAME", torch.bfloat16, True),
    ("fp16 [128,56,56,64] 3x3/1", (128, 56, 56, 64), (3, 3, 64, 64), 1,
     "SAME", torch.float16, False),
    ("fp16 [128,56,56,128] 3x3/2 pad (0,1)", (128, 56, 56, 128),
     (3, 3, 128, 128), 2, "SAME", torch.float16, False),
    ("fp16 [128,56,56,64] 1x1 ->256 +bn,z,relu", (128, 56, 56, 64),
     (1, 1, 64, 256), 1, "SAME", torch.float16, True, ("conv_fwd",)),
    # the other stride-2 dgrad sites of a ResNet-50 step
    ("[128,56,56,256] 1x1/2 ->512", (128, 56, 56, 256), (1, 1, 256, 512),
     2, "SAME", torch.bfloat16, False, ("conv_dgrad",)),
    ("[128,28,28,256] 3x3/2 pad (0,1)", (128, 28, 28, 256),
     (3, 3, 256, 256), 2, "SAME", torch.bfloat16, False, ("conv_dgrad",)),
    ("[128,28,28,512] 1x1/2 ->1024", (128, 28, 28, 512), (1, 1, 512, 1024),
     2, "SAME", torch.bfloat16, False, ("conv_dgrad",)),
    ("[128,14,14,512] 3x3/2 pad (0,1)", (128, 14, 14, 512),
     (3, 3, 512, 512), 2, "SAME", torch.bfloat16, False, ("conv_dgrad",)),
]


def _within_1ulp(got, want) -> float:
    """Share of bf16 elements within one ulp of ``want``'s."""
    dist = (_bf16_ordered(got) - _bf16_ordered(want)).abs()
    return (dist <= 1).float().mean().item()


def _conv_err(got, want, exact=None):
    """(max_abs_err, share of elements within one bf16 ulp or None, ok):
    fp32 within 1e-4 of max |plain|; fp16 within one fp16 ulp of max
    |plain| (2**-10 of it); bf16 within one ulp of max |plain| (2**-7 of
    it) and 99.9% of elements within one ulp of their own value: the
    plain one, or ``exact`` where given (wgrad)."""
    err = max_err(got, want)
    scale = want.float().abs().max().item()
    if got.dtype == torch.float16:
        return err, None, err <= 2.0 ** -10 * scale
    if got.dtype != torch.bfloat16:
        return err, None, err <= 1e-4 * scale
    within = _within_1ulp(got, want if exact is None else exact)
    return err, within, err <= 2.0 ** -7 * scale and within >= 0.999


def _wgrad_fp64(x, dy, stride, padding, kernel_size):
    """The weight gradient summed in fp64 and rounded once to x's type:
    wgrad's sums run over N*OH*OW (up to 1.6 M) products, where the plain
    fp32 sum itself misses by more than a bf16 ulp on elements near zero
    (0.2% of them at ``[128,56,56,64]`` 3x3), so a kernel's per-element
    share is taken against the exact value."""
    (pt, pb), (pl_, pr) = padding
    xd = F.pad(x.double().permute(0, 3, 1, 2), (pl_, pr, pt, pb))
    dyd = dy.double().permute(0, 3, 1, 2).contiguous()
    wd = torch.zeros((dy.shape[3], x.shape[3], *kernel_size),
                     dtype=torch.float64, device=x.device)
    dw = torch.ops.aten.convolution_backward(
        dyd, xd.contiguous(), wd, None, list(stride), [0, 0], [1, 1], False,
        [0, 0], 1, [False, True, False])[1]
    return dw.permute(2, 3, 1, 0).to(x.dtype)


def conv_cases(cv, fba, dev, was=None):
    """Kernels 1-3 against their plain versions at ResNet-50 B 128 shapes
    (cuDNN TF32 off, so the fp32 plain conv is full fp32).  Each call
    names its route; where that is wgmma, conv.cu's ``mma.sync`` kernel
    is timed on the same inputs (``mma_ms``, and whether it gives the same
    bits).  With ``was`` (another checkout's ``ops.conv``, ``--was``) its
    kernel is timed on the same inputs, in the same process.  ``library_ms``
    is cuDNN on the same inputs, channels-last: ``F.conv2d`` (an
    asymmetric pad applied to its input beforehand, untimed) and
    ``aten.convolution_backward`` with the matching output mask; none for
    the epilogue case.  The bound counts each conv's multiply-adds twice
    (the dgrad kernel's zero taps at stride 2 are not work) over the
    type's peak, and each input and output once."""
    gen = torch.Generator(device=dev).manual_seed(15)
    out = {"conv_fwd": [], "conv_dgrad": [], "conv_wgrad": []}
    for name, xs, ws, s, pad, dtype, ep, *only in CONV_CASES:
        stride, dil = (s, s), (1, 1)
        padding = cv._norm_padding(pad, xs[1], xs[2], ws[0], ws[1], s, s, 1,
                                   1)
        oh, ow = cv._out_hw(xs[1], xs[2], padding, ws[0], ws[1], s, s, 1, 1)
        x = torch.randn(xs, device=dev, generator=gen).to(dtype)
        w = (torch.randn(ws, device=dev, generator=gen)
             / (ws[0] * ws[1] * ws[2]) ** 0.5).to(dtype)
        dy = torch.randn((xs[0], oh, ow, ws[3]), device=dev,
                         generator=gen).to(dtype)
        o = ws[3]
        epi = ()
        if ep:
            epi = (0.3 * torch.randn(o, device=dev, generator=gen),
                   torch.rand(o, device=dev, generator=gen) + 0.5,
                   1 + 0.2 * torch.randn(o, device=dev, generator=gen),
                   0.2 * torch.randn(o, device=dev, generator=gen),
                   torch.randn((xs[0], oh, ow, o), device=dev,
                               generator=gen).to(dtype), True)
        # library operands: the NCHW views of the NHWC tensors (channels-
        # last memory), the weights made channels-last, pads applied
        (pt, pb), (pl_, pr) = padding
        xl = F.pad(x.permute(0, 3, 1, 2), (pl_, pr, pt, pb))
        xl = xl.contiguous(memory_format=torch.channels_last)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        dyl = dy.permute(0, 3, 1, 2)

        def lib_fwd():
            return F.conv2d(xl, wl, stride=stride)

        def lib_bwd(mask):
            return torch.ops.aten.convolution_backward(
                dyl, xl, wl, None, list(stride), [0, 0], [1, 1], False,
                [0, 0], 1, mask)

        def run_fwd():
            return cv.conv_fwd_kernel(x, w, stride, padding, dil, *epi)[0]

        def run_dgrad():
            return cv.conv_dgrad_kernel(dy, w, stride, padding, dil, xs[1:3])

        def run_wgrad():
            return cv.conv_wgrad_kernel(x, dy, stride, padding, dil, ws[:2])

        def calls(mod, **kw):
            return {"conv_fwd": lambda: mod.conv_fwd_kernel(
                        x, w, stride, padding, dil, *epi, **kw)[0],
                    "conv_dgrad": lambda: mod.conv_dgrad_kernel(
                        dy, w, stride, padding, dil, xs[1:3], **kw),
                    "conv_wgrad": lambda: mod.conv_wgrad_kernel(
                        x, dy, stride, padding, dil, ws[:2], **kw)}

        def plain_fwd():
            return cv._fwd_ref(x, w, stride, padding, dil, *epi)[0]
        phases = [("conv_fwd", run_fwd, plain_fwd, lib_fwd, time_ms,
                   costs().conv_fwd(x, w, (oh, ow), bool(ep)))]
        if xs[3] != 3:                 # the stem's input needs no dx
            phases.append((
                "conv_dgrad", run_dgrad,
                lambda: cv._dgrad_ref(dy, w, stride, padding, dil, xs[1:3]),
                lambda: lib_bwd([True, False, False]), eager_ms,
                costs().conv_dgrad(dy, w, x.shape)))
        phases.append((
            "conv_wgrad", run_wgrad,
            lambda: cv._wgrad_ref(x, dy, stride, padding, dil, ws[:2]),
            lambda: lib_bwd([False, True, False]), eager_ms,
            costs().conv_wgrad(x, dy, w.shape)))
        if only:
            phases = [ph for ph in phases if ph[0] in only[0]]
        for kname, fn, plain, lib, lib_timer, cost in phases:
            got, route = launched_route(getattr(cv, f"{kname}_kernel"), fn)
            want = plain()
            exact = plain_within = None
            if kname == "conv_wgrad" and dtype == torch.bfloat16:
                exact = _wgrad_fp64(x, dy, stride, padding, ws[:2])
                plain_within = _within_1ulp(want, exact)
            torch.cuda.synchronize()
            err, within, ok = _conv_err(got, want, exact)
            msg = (f"{kname} {name}: max_abs_err {err:.3g} (max |plain| "
                   f"{want.float().abs().max().item():.3g}), within 1 ulp "
                   f"{within}")
            if exact is not None:
                msg += (f" of the fp64 sum (the plain fp32 version: "
                        f"{plain_within})")
            if ep and kname == "conv_fwd":
                y, _ = cv.conv_fwd_kernel(x, w, stride, padding, dil)
                exact = torch.equal(got, fba._fwd_ref(y, *epi))
                ok = ok and exact
                msg += f", equals conv -> plain epilogue bit for bit {exact}"
            check(ok, msg)
            del got, want, exact
            bms, by = bound(cost)
            case = dict(case=name, max_abs_err=err, within_1ulp=within,
                        plain_within_1ulp_of_fp64=plain_within,
                        ms=time_ms(fn, iters=10), eager_ms=eager_ms(fn,
                                                                    iters=5),
                        plain_ms=(time_ms(plain, iters=3)
                                  if kname == "conv_fwd"
                                  else eager_ms(plain, iters=3)),
                        library_ms=(None if ep else lib_timer(lib, iters=5)),
                        bound_ms=bms, bound_by=by)
            case["tflops"] = cost.flops / case["ms"] / 1e9
            case["route"] = route
            extra = f", route {route}"
            if route == "wgmma":
                mma = calls(cv, route="mma")[kname]
                case["mma_ms"] = time_ms(mma, iters=10)
                case["mma_same_bits"] = torch.equal(mma(), fn())
                extra += (f" (mma.sync {case['mma_ms']:.4f} ms, the same "
                          f"bits {case['mma_same_bits']})")
            if was is not None:
                case["was_ms"] = time_ms(calls(was)[kname], iters=10)
                extra += f" [was {case['was_ms']:.4f} ms]"
            out[kname].append(case)
            lib_s = ("n/a" if case["library_ms"] is None
                     else f"{case['library_ms']:.4f} ms")
            print(f"      {kname} {name}: kernel {case['ms']:.4f} ms (eager "
                  f"{case['eager_ms']:.4f}, {case['tflops']:.1f} TFLOP/s)"
                  f"{extra}, plain {case['plain_ms']:.4f} ms, library "
                  f"{lib_s}, bound {bms:.4f} ms ({by})", flush=True)
        del x, w, dy, xl, wl, dyl, epi
    return out


# every distinct conv site of a ResNet-50 step at B 128, 224 x 224 (the
# stride on the 3x3 and on the projection, flax 'SAME' pads): name, x
# shape, w shape, stride, the site's convs a step (53 in all)
RESNET50_SITES = [
    ("stem 7x7/2 3->64", (128, 224, 224, 3), (7, 7, 3, 64), 2, 1),
    ("s1 1x1 64->64", (128, 56, 56, 64), (1, 1, 64, 64), 1, 1),
    ("s1 3x3 64->64", (128, 56, 56, 64), (3, 3, 64, 64), 1, 3),
    ("s1 1x1 64->256", (128, 56, 56, 64), (1, 1, 64, 256), 1, 4),
    ("s1 1x1 256->64", (128, 56, 56, 256), (1, 1, 256, 64), 1, 2),
    ("s2 1x1 256->128", (128, 56, 56, 256), (1, 1, 256, 128), 1, 1),
    ("s2 3x3/2 128->128", (128, 56, 56, 128), (3, 3, 128, 128), 2, 1),
    ("s2 1x1 128->512", (128, 28, 28, 128), (1, 1, 128, 512), 1, 4),
    ("s2 1x1/2 256->512", (128, 56, 56, 256), (1, 1, 256, 512), 2, 1),
    ("s2 1x1 512->128", (128, 28, 28, 512), (1, 1, 512, 128), 1, 3),
    ("s2 3x3 128->128", (128, 28, 28, 128), (3, 3, 128, 128), 1, 3),
    ("s3 1x1 512->256", (128, 28, 28, 512), (1, 1, 512, 256), 1, 1),
    ("s3 3x3/2 256->256", (128, 28, 28, 256), (3, 3, 256, 256), 2, 1),
    ("s3 1x1 256->1024", (128, 14, 14, 256), (1, 1, 256, 1024), 1, 6),
    ("s3 1x1/2 512->1024", (128, 28, 28, 512), (1, 1, 512, 1024), 2, 1),
    ("s3 1x1 1024->256", (128, 14, 14, 1024), (1, 1, 1024, 256), 1, 5),
    ("s3 3x3 256->256", (128, 14, 14, 256), (3, 3, 256, 256), 1, 5),
    ("s4 1x1 1024->512", (128, 14, 14, 1024), (1, 1, 1024, 512), 1, 1),
    ("s4 3x3/2 512->512", (128, 14, 14, 512), (3, 3, 512, 512), 2, 1),
    ("s4 1x1 512->2048", (128, 7, 7, 512), (1, 1, 512, 2048), 1, 3),
    ("s4 1x1/2 1024->2048", (128, 14, 14, 1024), (1, 1, 1024, 2048), 2, 1),
    ("s4 1x1 2048->512", (128, 7, 7, 2048), (1, 1, 2048, 512), 1, 2),
    ("s4 3x3 512->512", (128, 7, 7, 512), (3, 3, 512, 512), 1, 2),
]


def load_was(root, module):
    """``module`` (e.g. ``"ops.conv"``) of another checkout of the port at
    ``root`` (the parent commit's, unpacked), whose package is imported as
    ``was_apex_tpu_torch`` so that it builds its own libraries from its
    own sources into its own tree."""
    import importlib.util
    if "was_apex_tpu_torch" not in sys.modules:
        pkg = os.path.join(os.path.abspath(root), "apex_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            "was_apex_tpu_torch", os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"was_apex_tpu_torch.{module}")


def conv_sites(cv, dev, was=None):
    """Phase 15b: forward, dgrad (not at the stem) and wgrad at every
    distinct ResNet-50 site, B 128, bf16: each held against its plain
    version as phase 15 holds it, named by its route, timed (a CUDA graph
    of 10 calls), beside conv.cu's ``mma.sync`` kernel on the same inputs
    where the route is wgmma (whether the bits are equal printed, not
    gated), ``was`` (another checkout's conv module, ``--was``: the same
    call timed through its kernels) and cuDNN; then each kernel's sum over
    the 53 convs of a step (each site times its count; the ``mma.sync``
    sum takes the route's own time where that is mma)."""
    gen = torch.Generator(device=dev).manual_seed(16)
    rows = []
    step = {k: dict(ms=0.0, mma_ms=0.0, was_ms=0.0 if was else None,
                    library_ms=0.0)
            for k in ("conv_fwd", "conv_dgrad", "conv_wgrad")}
    for name, xs, ws, s, count in RESNET50_SITES:
        stride, dil = (s, s), (1, 1)
        padding = cv._norm_padding(
            ((3, 3), (3, 3)) if ws[0] == 7 else "SAME", xs[1], xs[2], ws[0],
            ws[1], s, s, 1, 1)
        oh, ow = cv._out_hw(xs[1], xs[2], padding, ws[0], ws[1], s, s, 1, 1)
        x = torch.randn(xs, device=dev, generator=gen).to(torch.bfloat16)
        w = (torch.randn(ws, device=dev, generator=gen)
             / (ws[0] * ws[1] * ws[2]) ** 0.5).to(torch.bfloat16)
        dy = torch.randn((xs[0], oh, ow, ws[3]), device=dev,
                         generator=gen).to(torch.bfloat16)
        (pt, pb), (pl_, pr) = padding
        xl = F.pad(x.permute(0, 3, 1, 2), (pl_, pr, pt, pb)).contiguous(
            memory_format=torch.channels_last)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        dyl = dy.permute(0, 3, 1, 2)

        def lib_bwd(mask):
            return torch.ops.aten.convolution_backward(
                dyl, xl, wl, None, list(stride), [0, 0], [1, 1], False,
                [0, 0], 1, mask)

        def call(mod, kname, **kw):
            if kname == "conv_fwd":
                return lambda: mod.conv_fwd_kernel(x, w, stride, padding,
                                                   dil, **kw)[0]
            if kname == "conv_dgrad":
                return lambda: mod.conv_dgrad_kernel(dy, w, stride, padding,
                                                     dil, xs[1:3], **kw)
            return lambda: mod.conv_wgrad_kernel(x, dy, stride, padding, dil,
                                                 ws[:2], **kw)
        phases = [("conv_fwd",
                   lambda: cv._fwd_ref(x, w, stride, padding, dil)[0],
                   lambda: F.conv2d(xl, wl, stride=stride), time_ms)]
        if xs[3] != 3:                 # the stem's input needs no dx
            phases.append((
                "conv_dgrad",
                lambda: cv._dgrad_ref(dy, w, stride, padding, dil, xs[1:3]),
                lambda: lib_bwd([True, False, False]), eager_ms))
        phases.append((
            "conv_wgrad",
            lambda: cv._wgrad_ref(x, dy, stride, padding, dil, ws[:2]),
            lambda: lib_bwd([False, True, False]), eager_ms))
        # x, w and dy read or written once, the forward's multiply-adds:
        # the same bound for the three passes
        site_cost = costs().conv_wgrad(x, dy, w.shape)
        bms, by = bound(site_cost)
        for kname, plain, lib, lib_timer in phases:
            run = call(cv, kname)
            got, route = launched_route(getattr(cv, f"{kname}_kernel"), run)
            want = plain()
            exact = (_wgrad_fp64(x, dy, stride, padding, ws[:2])
                     if kname == "conv_wgrad" else None)
            torch.cuda.synchronize()
            err, within, ok = _conv_err(got, want, exact)
            check(ok, f"{kname} site {name}: route {route}, max_abs_err "
                      f"{err:.3g} (max |plain| "
                      f"{want.float().abs().max().item():.3g}), within 1 "
                      f"ulp {within}")
            mma = call(cv, kname, route="mma") if route == "wgmma" else None
            same = None if mma is None else torch.equal(mma(), got)
            del got, want, exact
            row = dict(site=name, kernel=kname, count=count, route=route,
                       max_abs_err=err, within_1ulp=within,
                       ms=time_ms(run, iters=10),
                       mma_ms=None if mma is None else time_ms(mma,
                                                               iters=10),
                       mma_same_bits=same,
                       was_ms=(time_ms(call(was, kname), iters=10)
                               if was else None),
                       library_ms=lib_timer(lib, iters=5), bound_ms=bms,
                       bound_by=by)
            row["tflops"] = site_cost.flops / row["ms"] / 1e9
            rows.append(row)
            for k in ("ms", "was_ms", "library_ms"):
                if row[k] is not None:
                    step[kname][k] += count * row[k]
            step[kname]["mma_ms"] += count * (row["mma_ms"] or row["ms"])
            was_s = ("" if row["was_ms"] is None
                     else f", was {row['was_ms']:.4f} ms")
            mma_s = ("" if mma is None else
                     f" (mma.sync {row['mma_ms']:.4f} ms, the same bits "
                     f"{same})")
            print(f"      {kname} site {name} (x{count}): route {route} "
                  f"{row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s)"
                  f"{mma_s}{was_s}, library {row['library_ms']:.4f} ms, "
                  f"bound {bms:.4f} ms ({by})", flush=True)
        del x, w, dy, xl, wl, dyl
    for kname, st in step.items():
        was_s = ("" if st["was_ms"] is None
                 else f", was {st['was_ms']:.2f} ms")
        print(f"      {kname}: the 53 convs of a step {st['ms']:.2f} ms "
              f"(mma.sync {st['mma_ms']:.2f}){was_s}, cuDNN "
              f"{st['library_ms']:.2f} ms", flush=True)
    return dict(sites=rows, per_step=step)


# -- phase 13: ResNet-50 training ------------------------------------------------------

IMAGENET_ARGS = ["--synthetic", "--arch", "resnet50", "-b", "128",
                 "--opt-level", "O2", "--print-freq", "1"]


def train_resnet50(imagenet, counters, steps=10, pallas_conv=True):
    """The ImageNet trainer's entry point at ResNet-50, B 128, 224 x
    224, bf16 O2, SGD, with its default ``--pallas-conv`` (the conv
    kernels) or ``--no-pallas-conv`` (cuDNN): every launch counter set to
    0 just before and read just after."""
    flag = "--pallas-conv" if pallas_conv else "--no-pallas-conv"
    args = imagenet.parse(IMAGENET_ARGS + ["--prof", str(steps), flag])
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    zero_wrapper_routes(*(counters[k] for k in RESNET_CONV_ROUTES))
    res = imagenet.train(args, log=lambda line: print("      " + line,
                                                      flush=True))
    launches = {name: c.launches for name, c in counters.items()}
    per_step = {"bn_act_fwd": 53, "bn_act_bwd": 53, "xentropy_fwd": 1,
                "xentropy_bwd": 1}
    if pallas_conv:
        # 53 convs a step; the stem's input (the images) needs no dx
        per_step.update(conv_fwd=53, conv_dgrad=52, conv_wgrad=53)
    ran = pipeline_gate(f"resnet50 training {flag}", res["pipeline"],
                        steps)
    check(all(launches[n] == per_step.get(n, 0) * ran
              for n in launches),
          f"resnet50 training {flag}: launches {launches} = {per_step} x "
          f"{ran} steps (the warm run and the replays; no other "
          f"kernel)")
    conv_routes = None
    if pallas_conv:
        conv_routes = conv_route_gate(
            f"resnet50 training {flag}",
            {k: counters[k].routes for k in RESNET_CONV_ROUTES}, launches)
    losses = res["losses"]
    check(all(np.isfinite(losses)),
          f"resnet50 training {flag}: losses finite ({losses[0]:.4f} -> "
          f"{losses[-1]:.4f})")
    step_ms = float(np.median(res["step_s"][2:])) * 1e3
    out = dict(losses=losses, step_ms_all=[x * 1e3 for x in res["step_s"]],
               step_ms_median_3_10=step_ms,
               images_per_s=res["images_per_step"] / step_ms * 1e3,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               launches=launches, conv_routes=conv_routes)
    print(f"      resnet50 O2 B128 224 {flag}: step {step_ms:.2f} ms "
          f"(median of steps 3-{steps}), {out['images_per_s']:.1f} "
          f"images/s, peak "
          f"memory {out['max_memory_allocated_bytes'] / 2**30:.2f} GiB",
          flush=True)
    return out


def resnet50_bucketed(imagenet, counters, steps=16):
    """Phase 13's trainer at K 1 for 16 steps, leafwise and with
    ``--bucketed`` (the SGD momentum in flat buckets): the bucketed run's
    launches as phase 13's (every counter set to 0 just before it), and
    its state equal to the leafwise run's bit for bit in every leaf
    (parameters, momentum, BN statistics, scaler), as JAX holds the
    bucketed SGD to the leafwise one."""
    mt = importlib.import_module("apex_tpu_torch.multi_tensor")
    states = {}
    for bucketed in (False, True):
        args = imagenet.parse(IMAGENET_ARGS + ["--prof", str(steps)]
                              + (["--bucketed"] if bucketed else []))
        for c in counters.values():
            c.launches = 0
        res = imagenet.train(args, log=lambda line: None)
        launches = {name: c.launches for name, c in counters.items()}
        states[bucketed] = res["state"]
    ran = pipeline_gate("resnet50 training --bucketed", res["pipeline"],
                        steps)
    per_step = dict(conv_fwd=53, conv_dgrad=52, conv_wgrad=53,
                    bn_act_fwd=53, bn_act_bwd=53, xentropy_fwd=1,
                    xentropy_bwd=1)
    check(all(launches[n] == per_step.get(n, 0) * ran for n in launches),
          f"resnet50 training --bucketed: launches {launches} = "
          f"{per_step} x {ran} steps")
    leaf, buck = states[False], states[True]
    check(isinstance(buck.opt_state.momentum_buf, mt.Packed),
          "resnet50 --bucketed: the momentum is Packed")
    store = mt.BucketStore(buck.params)
    want = {**leaf.params, **leaf.model_state,
            **{f"momentum.{k}": v
               for k, v in leaf.opt_state.momentum_buf.items()}}
    got = {**buck.params, **buck.model_state,
           **{f"momentum.{k}": v for k, v in store.unpack(
               buck.opt_state.momentum_buf).items()}}
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    bad += [f"scaler.{i}" for i, (a, b) in enumerate(zip(buck.scaler,
                                                          leaf.scaler))
            if not torch.equal(a, b)]
    check(not bad, f"resnet50 --bucketed K 1: state after {steps} steps "
          f"equals the leafwise run's in {len(want) + 3 - len(bad)}/"
          f"{len(want) + 3} leaves" + (f"; differing {bad[:5]}" if bad
                                       else ""))
    return dict(launches=launches, leaves_differing=len(bad))


# -- phase 14: ResNet correctness ---------------------------------------------------------

def resnet_correctness(imagenet, training, dev):
    """(a) a small ResNet-50-shaped network (bottleneck blocks, 8
    filters, 1000 classes, 32 x 32, B 8) at O0 fp32, three SGD steps on
    the card and on the CPU; (b) O2 with a dynamic scale and an inf
    injected into the loss on the card; both with ``Conv`` (cuDNN) and
    with ``PallasConv`` (the conv kernels, fp32 FMA path at O0); (c) conv
    outputs are contiguous NHWC (no copy before the epilogue)."""
    from apex_tpu_torch.amp import convert_params
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.models.resnet import BottleneckBlock, Conv, ResNet
    from apex_tpu_torch.ops import conv as cv
    res = {}

    def small(dtype, device, conv_cls):
        return ResNet(stage_sizes=[1, 1, 1, 1], block_cls=BottleneckBlock,
                      num_filters=8, dtype=dtype, norm_cls=BatchNorm2d_NHWC,
                      conv_cls=conv_cls, device="cpu", seed=3).to(device)

    def steps_of(m, opt_level, loss_scale=None, inject=False):
        def loss_fn(p, ms, batch):
            logits, new_ms = m.apply(p, ms, batch[0])
            loss = imagenet.image_loss(logits, batch[1])
            return (loss * batch[2] if inject else loss), new_ms
        init, step = training.make_train_step(
            loss_fn, training.sgd(0.02, momentum=0.9, weight_decay=1e-4),
            opt_level=opt_level, loss_scale=loss_scale,
            has_model_state=True)
        params, stats = m.variables()
        return init({k: v.detach() for k, v in params.items()},
                    {k: v.clone() for k, v in stats.items()}), step

    for tag, conv_cls in (("conv", None), ("pallas_conv", cv.PallasConv)):
        # (a)
        states, losses = {}, {}
        launches = cv.conv_fwd_kernel.launches
        for device in (dev, "cpu"):
            st, step = steps_of(small(torch.float32, device, conv_cls), "O0")
            x, y = imagenet.synthetic_batch(8, 32, device)
            losses[str(device)] = []
            for _ in range(3):
                st, met = step(st, (x, y))
                losses[str(device)].append(met["loss"].item())
            states[str(device)] = st
        ran = cv.conv_fwd_kernel.launches - launches
        lerr = max(abs(a - b) / abs(b) for a, b in
                   zip(losses[str(dev)], losses["cpu"]))
        perr = max(max_err(states[str(dev)].params[k].cpu(), v)
                   for k, v in states["cpu"].params.items())
        serr = max(max_err(states[str(dev)].model_state[k].cpu(), v)
                   for k, v in states["cpu"].model_state.items())
        check(lerr <= 1e-4 and perr <= 1e-4 and serr <= 1e-4
              and (ran == 3 * 17) == (conv_cls is not None),
              f"small resnet ({tag}) O0 3 SGD steps card vs CPU: loss rel "
              f"err {lerr:.3g} <= 1e-4, params max_abs_err {perr:.3g}, "
              f"running stats {serr:.3g} <= 1e-4; conv kernel launches "
              f"{ran}")
        res.update({f"small_o0_{tag}_losses_card": losses[str(dev)],
                    f"small_o0_{tag}_losses_cpu": losses["cpu"],
                    f"small_o0_{tag}_loss_rel_err": lerr,
                    f"small_o0_{tag}_param_max_abs_err": perr,
                    f"small_o0_{tag}_stats_max_abs_err": serr})

        # (b)
        m = small(torch.bfloat16, dev, conv_cls)
        st, step = steps_of(m, "O2", "dynamic", inject=True)
        x, y = imagenet.synthetic_batch(8, 32, dev)
        before = {k: v.clone() for k, v in st.params.items()}
        with torch.no_grad():
            _, want_stats = m.apply(convert_params(st.params, torch.bfloat16),
                                    st.model_state, x)
        st, met = step(st, (x, y, torch.tensor(float("inf"), device=dev)))
        kept = all(torch.equal(st.params[k], v) for k, v in before.items())
        stats_err = max(max_err(st.model_state[k], v)
                        for k, v in want_stats.items())
        skipped = (bool(met["overflow"]) and kept
                   and not bool(st.opt_state.initialized)
                   and met["loss_scale"].item() == 2.0 ** 15)
        check(skipped and stats_err <= 1e-6,
              f"small resnet ({tag}) O2 dynamic, inf injected: skipped with "
              f"params bit-identical {skipped}, running stats advanced as "
              f"in JAX (max_abs_err vs the step's forward {stats_err:.3g} "
              f"<= 1e-6)")
        res.update({f"o2_{tag}_skip_ok": skipped,
                    f"o2_{tag}_skip_stats_err": stats_err})

    # (c)
    xin = torch.randn(8, 56, 56, 64, device=dev, dtype=torch.bfloat16)
    layout = {}
    for name, k, s_ in (("3x3 s2", (3, 3), (2, 2)), ("1x1 s1", (1, 1),
                                                     (1, 1)),
                        ("3x3 s1", (3, 3), (1, 1))):
        for cls in (Conv, cv.PallasConv):
            conv = cls(64, 128, k, s_, dtype=torch.bfloat16, device=dev)
            with torch.no_grad():
                layout[f"{cls.__name__} {name}"] = conv(xin).is_contiguous()
    check(all(layout.values()),
          f"conv outputs are contiguous NHWC: {layout}")
    res["conv_outputs_contiguous"] = layout
    return res


def lm_fused_vs_plain_loss(models, main_amp, dev):
    """The LM loss on the card: the fused kernels against the
    ``--no-fused-loss`` composition on the same logits (gpt2_small bf16,
    B 2, T 256, every 16th label padding)."""
    ids = torch.from_numpy(np.random.RandomState(10).randint(
        1, 50257, (2, 257))).to(dev)
    labels = ids[:, 1:].clone()
    labels[:, ::16] = 0
    m = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0)
    with torch.no_grad():
        logits = m(ids[:, :-1])
        fused = main_amp.lm_loss(logits, labels, 0.1, fused=True).item()
        plain = main_amp.lm_loss(logits, labels, 0.1, fused=False).item()
    rel = abs(fused - plain) / abs(plain)
    check(rel <= 1e-4, f"gpt2_small LM loss on the card: fused {fused:.6f} "
          f"vs --no-fused-loss {plain:.6f}, rel err {rel:.3g} <= 1e-4")
    return dict(lm_fused_loss=fused, lm_plain_loss=plain,
                lm_fused_vs_plain_rel_err=rel)


# -- phase 16: the quantized matmul --------------------------------------------------

QMM_CASES = [
    # name, M, K, N, dtype, a zero-amax weight column
    ("prefill M1024 768->768", 1024, 768, 768, torch.bfloat16, False),
    ("prefill M1024 768->3072", 1024, 768, 3072, torch.bfloat16, False),
    ("prefill M1024 3072->768", 1024, 3072, 768, torch.bfloat16, False),
    ("decode M8 768->768", 8, 768, 768, torch.bfloat16, False),
    ("decode M8 3072->768", 8, 3072, 768, torch.bfloat16, False),
    ("training M8184 768->3072", 8184, 768, 3072, torch.bfloat16, False),
    ("fp32 M1024 768->768", 1024, 768, 768, torch.float32, False),
    ("zero-amax column M256 768->768", 256, 768, 768, torch.bfloat16, True),
    ("ragged M1000 768->130", 1000, 768, 130, torch.bfloat16, False),
    ("fp16 M1024 768->3072", 1024, 768, 3072, torch.float16, False),
    ("K8 M1024 8->768", 1024, 8, 768, torch.bfloat16, False),
    ("K40 fp16 M1000 40->130", 1000, 40, 130, torch.float16, False),
]


def qmm_cases(qk, dev, was=None):
    """Kernel 14 against ``_qmm_ref`` at the O4 path's shapes, bit for
    bit; with ``was`` (another checkout's ``quant.kernels``, ``--was``)
    its kernel timed on the same inputs, in the same process.
    ``library_ms`` is ``torch._int_mm`` on the pre-quantized operands
    where it takes the shape (the int8 GEMM alone: a lower bound
    on the same product); ``o2_matmul_ms`` the bf16 ``torch.matmul`` the
    O2 path runs at the same shape (what O4 competes with).  Each case
    names its route; at M > 64 the other kernel (quant.cu's ``mma.sync``
    beside wgmma, wgmma where the rule keeps ``mma.sync``) runs on the
    same inputs, bit for bit the plain version too, and is timed beside
    it (``mma_ms`` or ``wgmma_ms``).  The bound
    counts x, qw, the scales and the output once, and 2 M N K operations
    at the int8 peak."""
    gen = torch.Generator(device=dev).manual_seed(16)
    cases = []
    for name, m, k, n, dtype, zero_col in QMM_CASES:
        x = (2 * torch.randn(m, k, device=dev, generator=gen)).to(dtype)
        w = torch.randn(k, n, device=dev, generator=gen) / k ** 0.5
        if zero_col:
            w[:, n // 3] = 0.0
        w = w.to(dtype)
        ws = qk.channel_scale(w)
        qw = qk.weight_layout(w, ws)            # [N, K padded to 16]
        xs = torch.tensor(x.float().abs().max().item() / 127.0 * 0.9,
                          device=dev)

        def run():
            return qk.qmm_kernel(x, qw, xs, ws, dtype)

        def plain():
            return qk._qmm_ref(x, qw, xs, ws, dtype)

        (got, route), want = launched_route(qk.qmm_kernel, run), plain()
        # the other kernel of the prefill and training rows, on the same
        # inputs: mma.sync beside wgmma, wgmma where the rule keeps mma
        other = ({"wgmma": "mma", "mma": "wgmma"}.get(route)
                 if qk._tma_ok(x, qw) else None)

        def run_other():
            return qk.qmm_kernel(x, qw, xs, ws, dtype, route=other)
        torch.cuda.synchronize()
        exact = torch.equal(got, want)
        if other:
            exact = exact and torch.equal(run_other(), want)
        if zero_col:
            exact = exact and not got[:, n // 3].any()
        check(exact, f"qmm {name}: route {route}, equals the plain version "
              f"bit for bit {exact}"
              + (f" (and the {other} kernel)" if other else "")
              + f" (max_abs_err {max_err(got, want):.3g})")
        bms, by = bound(costs().qmm(x, qw))
        lib = None
        qx, qkn = qk.quantize(x, xs), qw[:, :k].t()
        try:
            lib = time_ms(lambda: torch._int_mm(qx, qkn))
        except RuntimeError as e:          # shapes _int_mm refuses
            print(f"      qmm {name}: torch._int_mm refused "
                  f"({str(e).splitlines()[0][:80]})", flush=True)
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        case = dict(case=name, route=route, max_abs_err=max_err(got, want),
                    bit_exact=exact, ms=time_ms(run), eager_ms=eager_ms(run),
                    plain_ms=time_ms(plain, iters=3), library_ms=lib,
                    o2_matmul_ms=time_ms(lambda: xb @ wb),
                    bound_ms=bms, bound_by=by)
        case["tops"] = 2.0 * m * n * k / case["ms"] / 1e9
        was_s = f" route {route}"
        if other:
            case[f"{other}_ms"] = time_ms(run_other)
            was_s += f" ({other} {case[f'{other}_ms']:.4f} ms)"
        if was is not None:
            was_got = was.qmm_kernel(x, qw, xs, ws, dtype)
            case["was_bit_exact"] = torch.equal(was_got, want)
            case["was_ms"] = time_ms(
                lambda: was.qmm_kernel(x, qw, xs, ws, dtype))
            was_s += (f" [was {case['was_ms']:.4f} ms, bit for bit "
                      f"{case['was_bit_exact']}]")
        lib_s = "n/a" if lib is None else f"{lib:.4f} ms"
        print(f"      qmm {name}: kernel {case['ms']:.4f} ms{was_s} (eager "
              f"{case['eager_ms']:.4f}, {case['tops']:.1f} TOP/s), plain "
              f"{case['plain_ms']:.4f} ms, _int_mm {lib_s}, bf16 matmul "
              f"{case['o2_matmul_ms']:.4f} ms, bound {bms:.4f} ms ({by})",
              flush=True)
        cases.append(case)
        del x, w, qw, got, want, qx, xb, wb
    return cases


# -- phase 17: O4 serving ---------------------------------------------------------------

def calibrate_gpt2_small(models, quant, dev, n_batches=4):
    """The JAX recipe's observation phase on GPT-2 small bf16: 4 synthetic
    batches (B 2, T 1024, ids from RandomState(17)) through the
    observe-mode model, each batch's absmax of every site harvested, the
    history frozen with "max"."""
    obs = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0,
                            quant=quant.QuantConfig.observe())
    cal = quant.Calibrator()
    rng = np.random.RandomState(17)
    with torch.no_grad():
        for _ in range(n_batches):
            obs(torch.from_numpy(rng.randint(1, 50257, (2, 1024))).to(dev))
            cal.harvest(quant.quant_stats(obs))
    calib = cal.freeze("max")
    check(len(calib) == 72 and all(a > 0 for a in calib.amax.values()),
          f"gpt2_small calibration: {len(calib)} sites (72), amax "
          f"{min(calib.amax.values()):.3g}-{max(calib.amax.values()):.3g}")
    return calib


def _prefill_logits(model, ids, dev):
    from apex_tpu_torch.models import init_cache
    with torch.inference_mode():
        logits, _ = model(ids.to(dev), kv_caches=init_cache(
            model, ids.shape[0], cache_len=ids.shape[1]),
            positions=torch.zeros((ids.shape[0],), dtype=torch.long,
                                  device=dev))
    return logits.float()


class _EmptiedWeights:
    """Within it, every int8 site of ``model`` empties its prepared weight
    before each forward, so each call prepares anew (the path without the
    cache)."""

    def __init__(self, model, quant):
        self.sites = [m for m in model.modules()
                      if isinstance(m, quant.QuantDenseGeneral)]

    def __enter__(self):
        def empty(mod, args):
            mod._prepared = None
        self.hooks = [m.register_forward_pre_hook(empty) for m in self.sites]
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


def o4_prefill_checks(models, quant, calib, dev, engine_mod):
    """A 256-token prefill of gpt2_small bf16: O4 with an empty
    calibration bit for bit O2, the relative RMS error of O4 (the frozen
    calibration) against O2, and O4's prefill logits and greedy tokens
    (4 prompts, 8 new tokens, int8 KV) with the prepared weights equal
    bit for bit to those with every preparation redone."""
    ids = torch.from_numpy(np.random.RandomState(3).randint(1, 50257,
                                                            (1, 256)))
    o2 = _prefill_logits(models.gpt2_small(dtype=torch.bfloat16, device=dev,
                                           seed=0), ids, dev)
    empty = _prefill_logits(models.gpt2_small(
        dtype=torch.bfloat16, device=dev, seed=0,
        quant=quant.QuantConfig("quant", scales={})), ids, dev)
    o4 = _prefill_logits(models.gpt2_small(
        dtype=torch.bfloat16, device=dev, seed=0,
        quant=quant.QuantConfig.frozen(calib)), ids, dev)
    same = torch.equal(empty, o2)
    rel = ((o4 - o2).pow(2).mean().sqrt() / o2.pow(2).mean().sqrt()).item()
    agree = (o4.argmax(-1) == o2.argmax(-1)).float().mean().item()
    check(same and np.isfinite(rel),
          f"gpt2_small O4 with an empty calibration equals O2 bit for bit "
          f"{same}; O4 vs O2 256-token prefill logits relative RMS error "
          f"{rel:.4g}, top-1 agreement {agree:.3f}")
    m = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0,
                          quant=quant.QuantConfig.frozen(calib))
    prompts = [np.random.RandomState(6).randint(1, 50257, (n,))
               for n in (40, 300, 700, 999)]

    def served():
        eng = engine_mod.ServingEngine(m, buckets=(256, 1024), page_size=16,
                                       max_seqs=4, cache_dtype=torch.int8,
                                       device=dev)
        toks = [r.tokens for r in eng.generate(prompts, 8)]
        eng.close()
        return toks
    cached, cached_toks = _prefill_logits(m, ids, dev), served()
    with _EmptiedWeights(m, quant):
        redone, redone_toks = _prefill_logits(m, ids, dev), served()
    logits_same = torch.equal(cached, redone) and torch.equal(cached, o4)
    toks_same = all(np.array_equal(a, b)
                    for a, b in zip(cached_toks, redone_toks))
    check(logits_same and toks_same,
          f"gpt2_small O4 with prepared weights: prefill logits equal those "
          f"with every preparation redone bit for bit {logits_same}; greedy "
          f"tokens of 4 requests equal {toks_same}")
    return dict(o4_empty_equals_o2=same, o4_vs_o2_logits_rel_rms=rel,
                o4_vs_o2_top1_agreement=agree,
                o4_prepared_logits_equal_redone=logits_same,
                o4_prepared_tokens_equal_redone=toks_same)


def o4_vs_o2(o2, o4):
    """Per decode step of the traced runs (phases 6 and 17) and end to
    end: host ms, device ms and kernels, and tokens/s, O4 beside O2."""
    def decode(prof):
        steps = [v for k, v in prof["steps"].items()
                 if k.startswith("decode")]
        n = sum(v["count"] for v in steps)
        return {key: sum(v[key] * v["count"] for v in steps) / max(1, n)
                for key in ("host_ms", "device_ms", "kernels_per_step")}
    d2, d4 = decode(o2["profile"]), decode(o4["profile"])
    res = dict(o2_decode=d2, o4_decode=d4,
               o2_tokens_per_s=o2["tokens_per_s"],
               o4_tokens_per_s=o4["tokens_per_s"],
               o4_over_o2_tokens_per_s=o4["tokens_per_s"]
               / o2["tokens_per_s"])
    print(f"      O4 vs O2 a decode step: host {d4['host_ms']:.2f} vs "
          f"{d2['host_ms']:.2f} ms, device {d4['device_ms']:.3f} vs "
          f"{d2['device_ms']:.3f} ms, {d4['kernels_per_step']:.1f} vs "
          f"{d2['kernels_per_step']:.1f} kernels; tokens/s "
          f"{o4['tokens_per_s']:.1f} vs {o2['tokens_per_s']:.1f} "
          f"({res['o4_over_o2_tokens_per_s']:.3f}x)", flush=True)
    return res


#: a card-vs-CPU token mismatch of the int8 gpt_tiny is allowed only
#: where the CPU's top-2 logit gap at that step is below this: one fp32
#: rounding difference that lands on an int8 rounding boundary moves a
#: quantized value by a whole step (1/127 of its site's or row's amax),
#: and all of quantization together moves gpt_tiny's logits by 0.04-0.07
O4_TINY_GAP = 1e-2


def tiny_tokens_o4(models, quant, engine_mod, dev):
    """gpt_tiny fp32 with a frozen calibration (observed on the CPU) and an
    int8 KV cache, served on the card and on the CPU: equal greedy tokens
    except after a step whose top-2 logit gap on the CPU engine is below
    ``O4_TINY_GAP`` (the gap read from a one-slot CPU rerun of that
    request, whose logits a forward hook records)."""
    rng = np.random.RandomState(4)
    obs = models.gpt_tiny(dtype=torch.float32, device="cpu", seed=1,
                          quant=quant.QuantConfig.observe())
    cal = quant.Calibrator()
    with torch.no_grad():
        for _ in range(3):
            obs(torch.from_numpy(rng.randint(1, 1024, (2, 128))))
            cal.harvest(quant.quant_stats(obs))
    cfg = quant.QuantConfig.frozen(cal.freeze())
    prompts = [rng.randint(1, 1024, (int(n),))
               for n in rng.randint(4, 200, 12)]

    def engine(device, slots):
        m = models.gpt_tiny(dtype=torch.float32, device=device, seed=1,
                            quant=cfg)
        return m, engine_mod.ServingEngine(
            m, buckets=(128, 256), page_size=16, max_seqs=slots,
            cache_dtype=torch.int8, device=device)
    toks = {}
    for device in (dev, "cpu"):
        _, eng = engine(device, 4)
        toks[str(device)] = [r.tokens for r in eng.generate(prompts, 24)]
        eng.close()
    mismatched, gaps = 0, []
    for p, a, b in zip(prompts, toks[str(dev)], toks["cpu"]):
        if np.array_equal(a, b):
            continue
        mismatched += 1
        j = int(np.argmax(a != b))       # first divergent step
        m, eng = engine("cpu", 1)
        seen = []
        hook = m.register_forward_hook(
            lambda mod, inp, out: seen.append(out[0].detach()))
        eng.generate([p], 24)
        eng.close()
        hook.remove()
        step = seen[0][0, len(p) - 1] if j == 0 else seen[j][0, -1]
        top2 = step.topk(2).values
        gaps.append(float(top2[0] - top2[1]))
    check(all(g < O4_TINY_GAP for g in gaps),
          f"gpt_tiny fp32 O4 + int8 KV tokens card vs CPU: "
          f"{12 - mismatched}/12 identical; top-2 gaps at divergence "
          f"{gaps} < {O4_TINY_GAP}")
    return dict(o4_tiny_identical=12 - mismatched,
                o4_tiny_divergence_gaps=gaps)


# -- phase 18: O4 training --------------------------------------------------------------

def o4_setup(models, quant, main_amp, training, calib, dev):
    """A function giving ``(state, step, batch, model)`` of
    ``make_train_step(opt_level="O4")`` on the calibrated GPT-2 small
    (the LM trainer's model, loss and batch: Adam lr 3e-4, weight decay
    0.1, B 8, seq_len 1024, the fused loss), made afresh each call."""
    def build():
        model = models.GPT(vocab_size=50257, hidden_size=768, num_layers=12,
                           num_heads=12, mlp_dim=3072, max_len=1024,
                           dtype=torch.bfloat16, attention_impl="flash",
                           device=dev, seed=0,
                           quant=quant.QuantConfig.frozen(calib))

        def loss_fn(params, batch):
            return main_amp.lm_loss(torch.func.functional_call(
                model, params, (batch[0],)), batch[1], 0.0, True)
        init, step = training.make_train_step(
            loss_fn, training.adam(3e-4, weight_decay=0.1), opt_level="O4")
        return (init(model.state_dict()), step,
                main_amp.synthetic_batch(8, 1024, 50257, dev), model)
    return build


def train_o4(build, counters, steps=10):
    """Phase 18's O4 steps, eager (``o4_setup``): every launch counter
    set to 0 just before and read just after."""
    state, step, batch, model = build()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    preps = preparations(model)
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, met = step(state, batch)
        losses.append(met["loss"].item())
        step_s.append(time.perf_counter() - t0)
    launches = {n: c.launches for n, c in counters.items()}
    preps = preparations(model) - preps
    check(preps == 72 * steps,
          f"gpt2_small O4 training: {preps} weight preparations = 72 x "
          f"{steps} steps (training prepares every call)")
    per_step = dict(LM_PER_STEP, qmm=72)
    check(all(launches[n] == per_step.get(n, 0) * steps for n in launches),
          f"gpt2_small O4 training: launches {launches} = {per_step} x "
          f"{steps} steps (the qmm backward launches nothing)")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"gpt2_small O4 training: losses finite, step {steps} "
          f"{losses[-1]:.4f} < step 1 {losses[0]:.4f}")
    step_ms = float(np.median(step_s[2:])) * 1e3
    out = dict(losses=losses, step_ms_all=[x * 1e3 for x in step_s],
               step_ms_median_3_10=step_ms,
               tokens_per_s=8 * 1023 / step_ms * 1e3,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               launches={n: v for n, v in launches.items() if v},
               preparations_per_step=preps / steps)
    print(f"      gpt2_small O4 B8 T1023: step {step_ms:.2f} ms (median of "
          f"steps 3-{steps}), {out['tokens_per_s']:.0f} tok/s, peak memory "
          f"{out['max_memory_allocated_bytes'] / 2**30:.2f} GiB; losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    out["profile"] = trace_steps(state, step, batch)
    return out


# -- phase 19: the [B, T, S] bias gradient ------------------------------------------------

DB2_CASES = [
    # name, kv heads, dtype, causal, window, head_dim[, batch, 8 if not
    # given]
    ("full", 12, torch.bfloat16, False, None, 64),
    ("causal", 12, torch.bfloat16, True, None, 64),
    ("gqa 12/4 causal", 4, torch.bfloat16, True, None, 64),
    ("window 256", 12, torch.bfloat16, True, 256, 64),
    ("fp32 causal", 12, torch.float32, True, None, 64),
    ("fp16 causal", 12, torch.float16, True, None, 64),
    ("head_dim 16 causal", 12, torch.bfloat16, True, None, 16),
    ("head_dim 256 causal", 12, torch.bfloat16, True, None, 256),
    # wider than the widest kernel (256-wide slices), at B 1
    ("head_dim 320 causal b1", 12, torch.bfloat16, True, None, 320, 1),
    ("head_dim 512 causal b1", 12, torch.bfloat16, True, None, 512, 1),
]


def db2_cases(fa, counters, dev, was=None):
    """Kernel 13 at GPT-2 small's attention shapes (B 8, T = S = 1024, 12
    heads of 64) with a learnable fp32 ``[B, T, S]`` bias.  First the
    public op under autograd, every counter set to 0 just before and
    read just after: one forward, dQ, dK/dV and db2 launch per backward
    that needs the bias gradient, none of db2 without it, and dq/dk/dv
    equal between the two.  Then the kernel against
    ``_flash_bwd_ref``'s dbias on the same inputs, within 1e-4 of max
    |dbias| (fp32 sums over 12 heads in another order), zero where the
    band hides a key.  ``library_ms``: the eager backward of SDPA with
    the bias expanded to ``[B, H, T, S]`` and needing a gradient (the
    band folded into it as -inf), where a backend takes it.  With ``was``
    (another checkout's ``ops.flash_attention``, ``--was``) its db2
    kernel is timed on the same inputs, and where this checkout runs the
    SIMT kernel (fp32, widths above 128) the two must agree bit for
    bit."""
    rng = np.random.RandomState(19)
    t, h = 1024, 12
    cases, db2_launches = [], 0
    for name, h_kv, dtype, causal, window, d, *batch in DB2_CASES:
        b = batch[0] if batch else 8
        q, do = (torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32))
                 .to(dev, dtype) for _ in range(2))
        k, v = (torch.from_numpy(rng.randn(b, t, h_kv, d).astype(np.float32))
                .to(dev, dtype) for _ in range(2))
        bias = torch.from_numpy(
            (0.5 * rng.randn(b, t, t)).astype(np.float32)).to(dev)
        kw = dict(sm_scale=d ** -0.5, causal=causal, q_offset=0,
                  window=window)
        for c in counters.values():
            c.launches = 0
        grads = {}
        for learn in (True, False):
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            bl = bias.detach().requires_grad_(learn)
            out = fa.flash_attention(*leaves, bias=bl, causal=causal,
                                     window=window)
            grads[learn] = torch.autograd.grad(
                out, leaves + ([bl] if learn else []), do)
        launched = {n: c.launches for n, c in counters.items()
                    if c.launches}
        db2_launches += launched.get("flash_attention_bwd_db2", 0)
        want_l = {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
                  "flash_attention_bwd_dkv": 2, "flash_attention_bwd_db2": 1}
        same = all(torch.equal(a, b_) for a, b_ in
                   zip(grads[True][:3], grads[False]))
        check(launched == want_l and same,
              f"flash bias grad {name}: launches {launched} = {want_l}; "
              f"dq/dk/dv equal to the run without a bias gradient {same}")

        out, lse = fa.flash_fwd_kernel(q, k, v, None, bias, **kw)
        delta = fa._delta(do, out)

        def run():
            return fa.flash_bwd_db2_kernel(q, k, v, do, lse, delta, None,
                                           bias, **kw)

        def plain():
            return fa._flash_bwd_ref(q, k, v, None, bias, out, lse, do,
                                     **kw)[4]
        got, want = run(), plain()
        torch.cuda.synchronize()
        err, scale = max_err(got, want), want.abs().max().item()
        zeros = True
        if causal:
            vis = fa._visible(t, t, 0, window, dev)
            zeros = not got[:, ~vis].any()
        op_same = torch.equal(grads[True][3], got)
        check(err <= 1e-4 * scale and zeros and op_same,
              f"flash db2 {name}: max_abs_err {err:.3g} <= 1e-4 x max "
              f"|dbias| {scale:.3g}; hidden keys zero {zeros}; the op's "
              f"dbias equals the kernel's {op_same}")
        del grads
        # the bias is read where the band leaves a key visible; dbias is
        # written whole (its hidden entries are zeros)
        bms, by = bound(costs().flash_bwd_db2(q, k, v, bias, causal=causal,
                                              q_offset=0, window=window))
        lib = None
        try:
            qt, kt, vt = (x.repeat_interleave(h // x.shape[2], dim=2)
                          .transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            lb = bias
            if causal:
                lb = torch.where(fa._visible(t, t, 0, window, dev), bias,
                                 float("-inf"))
            lb = lb.to(dtype)[:, None].expand(b, h, t, t).requires_grad_(True)
            lout = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=lb,
                                                  scale=d ** -0.5)
            dot = do.transpose(1, 2)
            lib = eager_ms(lambda: torch.autograd.grad(
                lout, (qt, kt, vt, lb), dot, retain_graph=True), iters=3)
            del lout, qt, kt, vt, lb
        except RuntimeError as e:
            print(f"      flash db2 {name}: no SDPA backend takes a bias "
                  f"gradient ({str(e).splitlines()[0][:80]})", flush=True)
        case = dict(case=name, max_abs_err=err, max_abs_dbias=scale,
                    ms=time_ms(run, iters=5), eager_ms=eager_ms(run, iters=5),
                    plain_ms=time_ms(plain, iters=2), library_ms=lib,
                    bound_ms=bms, bound_by=by)
        was_s = ""
        if was is not None:
            def was_run():
                return was.flash_bwd_db2_kernel(q, k, v, do, lse, delta, None,
                                                bias, **kw)
            case["was_equal"] = torch.equal(was_run(), got)
            case["was_ms"] = time_ms(was_run, iters=5)
            was_s = (f" [was {case['was_ms']:.4f} ms, equal "
                     f"{case['was_equal']}]")
            if dtype == torch.float32 or d > 128:
                check(case["was_equal"],
                      f"flash db2 {name} (SIMT): equals the --was "
                      f"checkout's kernel bit for bit")
        lib_s = "n/a" if lib is None else f"{lib:.4f} ms"
        print(f"      flash db2 {name}: kernel {case['ms']:.4f} ms{was_s} "
              f"(eager {case['eager_ms']:.4f}), plain {case['plain_ms']:.4f} ms, "
              f"SDPA backward with a bias gradient {lib_s}, bound "
              f"{bms:.4f} ms ({by})", flush=True)
        cases.append(case)
        del q, k, v, do, bias, out, lse, delta, got, want
    return cases, {"flash_attention_bwd_db2": db2_launches}


# -- phase 20: K-step windows captured, against eager steps --------------------------

def _state_diff(got, want):
    """(leaves that differ, leaves, the largest |difference| and the first
    differing leaves' names) of two states of one structure."""
    paths = torch.utils._pytree.tree_flatten_with_path(want)[0]
    leaves = torch.utils._pytree.tree_leaves(got)
    differ, worst, names = 0, 0.0, []
    for (path, w), g in zip(paths, leaves):
        if not isinstance(w, torch.Tensor) or torch.equal(g, w):
            continue
        differ += 1
        worst = max(worst, (g.double() - w.double()).abs().max().item())
        if len(names) < 5:
            names.append(torch.utils._pytree.keystr(path))
    return differ, len(paths), worst, names


def window_loop(state, step_fn, batch, k, steps):
    """The trainers' loop (``StepPipeline`` over one reused batch, the
    metrics read one window behind) for a step function no trainer
    builds: the same result dictionary as their ``train``."""
    runtime = importlib.import_module("apex_tpu_torch.runtime")
    window = tuple(t.unsqueeze(0).expand(k, *t.shape) for t in batch)
    pipe = runtime.StepPipeline(step_fn, k).warmup(state, window)
    res = dict(losses=[], step_s=[])
    last = runtime.mark(batch[0].device)

    def emit(wm):
        nonlocal last
        vals = wm.fetch()
        res["losses"] += [float(x) for x in vals["loss"][:wm.n_valid]]
        res["step_s"] += ([runtime.seconds_between(last, wm.end)
                           / wm.n_valid] * wm.n_valid)
        last = wm.end

    state, _ = pipe.run(state, ((window, k) for _ in range(steps // k)),
                        on_metrics=emit)
    res.update(state=state, pipeline=pipe.stats)
    return res


def eager_steps(build, steps=16):
    """``steps`` eager calls of the step function from ``build()``'s
    state: the final state, the ms a step of calls 2-``steps`` (run back
    to back, one read of the last loss) and the bytes of one batch."""
    state, step_fn, batch = build()
    state, met = step_fn(state, batch)
    met["loss"].item()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state, met = step_fn(state, batch)
    met["loss"].item()
    batch_bytes = sum(t.numel() * t.element_size() for t in batch)
    return (state, (time.perf_counter() - t0) / (steps - 1) * 1e3,
            batch_bytes)


@contextlib.contextmanager
def window_end_commit(runtime, cache):
    """``StepPipeline`` as it captured a window before each step's state
    was copied into the static inputs: K chained steps, the state copied
    in once at the window's end.  Measured beside the per-step copy, in
    the same process."""
    per_step = runtime.StepPipeline._capture

    def _capture(self, program, state, window, valid):
        fn = self.loop if program == "hot" else self.tail_loop

        def body(state, window, valid):
            new_state, metrics = fn(state, window, valid)
            runtime._copy_tree(state, new_state)
            return metrics
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = cache.warmup(body, state, window, valid, pool=self._pool)
        self.stats["captures"][program] += 1
        return graph
    runtime.StepPipeline._capture = _capture
    try:
        yield
    finally:
        runtime.StepPipeline._capture = per_step


def _window_run(name, run_k, k, steps, want):
    """``run_k(k, steps)`` from an emptied allocator: its state against
    ``want`` bit for bit (one capture, ``steps / k`` replays); step ms
    (each window after the first), peak memory and losses."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = run_k(k, steps)
    differ, n, worst, names = _state_diff(res["state"], want)
    pipe = res["pipeline"]
    check(differ == 0 and pipe["replays"] == steps // k
          and pipe["captures"]["hot"] == 1,
          f"{name} K {k}: state after {steps} steps equals {steps} eager "
          f"steps in {n - differ}/{n} leaves (max |diff| {worst:.3g}"
          + (f", first {names}" if names else "") + f"); "
          f"{pipe['captures']['hot']} capture, {pipe['replays']} replays")
    return dict(step_ms=float(np.median(res["step_s"][k:])) * 1e3,
                step_ms_all=[x * 1e3 for x in res["step_s"]],
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                leaves_differing=differ, leaves=n, max_abs_diff=worst,
                losses=res["losses"])


def _cpu_copy(tree):
    """A copy of ``tree``'s tensors on the CPU."""
    return torch.utils._pytree.tree_map(
        lambda t: t.detach().to("cpu", copy=True)
        if isinstance(t, torch.Tensor) else t, tree)


#: final states and step ms of phase 20's runs with an empty tune cache,
#: kept on the CPU for phase 32's tuned runs
UNTUNED = {}


def capture_vs_eager(name, build, run_k, steps=16, ks=(1, 8),
                     window_end=None, keep=None):
    """``steps`` eager calls of the step function (``build()`` gives the
    initial state, the step and the batch), then ``run_k(k, steps)`` for
    each K, the same steps in windows of K replayed from CUDA graphs: the
    final state of each equal to the eager one bit for bit; step ms (the
    eager steps 2-16, each window after the first) and peak memory of
    each.  With ``window_end`` (:func:`window_end_commit`'s arguments)
    the K > 1 windows run again with the state copied in only at the
    window's end, for the step ms and peak memory before the per-step
    copy.  The window's bytes are K batches'.  With ``keep``, the final
    state (on the CPU) and the last K's step ms go to ``UNTUNED[keep]``."""
    torch.cuda.reset_peak_memory_stats()
    want, step_ms, batch_bytes = eager_steps(build, steps)
    out = {"eager": dict(
        step_ms=step_ms,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())}
    for k in ks:
        out[f"k{k}"] = _window_run(name, run_k, k, steps, want)
        out[f"k{k}"]["window_bytes"] = k * batch_bytes
        if window_end is not None and k > 1:
            with window_end_commit(*window_end):
                out[f"k{k}_window_end_commit"] = _window_run(
                    f"{name} (state copied at the window's end)", run_k, k,
                    steps, want)
    if keep is not None:
        UNTUNED[keep] = dict(state=_cpu_copy(want),
                             step_ms=out[f"k{ks[-1]}"]["step_ms"])
    del want
    torch.cuda.empty_cache()

    def gib(key):
        return out[key]["max_memory_allocated_bytes"] / 2**30
    line = (f"      {name}: step ms eager {out['eager']['step_ms']:.2f}, "
            + ", ".join(f"K {k} {out[f'k{k}']['step_ms']:.2f}" for k in ks)
            + f"; peak GiB eager {gib('eager'):.2f}, "
            + ", ".join(f"K {k} {gib(f'k{k}'):.2f}" for k in ks))
    for k in ks[1:]:
        win = out[f"k{k}"]["window_bytes"] / 2**30
        ratio = gib(f"k{k}") / (gib(f"k{ks[0]}") + win)
        out[f"k{k}"]["peak_over_k1_plus_window"] = ratio
        line += (f"; K {k} window {win:.3f} GiB, K {k} peak / (K "
                 f"{ks[0]} peak + window) {ratio:.3f}")
        if f"k{k}_window_end_commit" in out:
            before = out[f"k{k}_window_end_commit"]
            line += (f"; state copied at the window's end: K {k} step "
                     f"{before['step_ms']:.2f} ms, peak "
                     f"{gib(f'k{k}_window_end_commit'):.2f} GiB")
    print(line, flush=True)
    return out


def training_windows(main_amp, imagenet, build_o4, steps=16):
    """LM O2 and ResNet-50 O2 through their trainers at
    ``--steps-per-call`` 1 and 8, O4 through the trainers' loop on
    phase 18's step, each against the eager step function, and each
    K 8 window again with the state copied in at the window's end."""
    quiet = dict(log=lambda line: None)
    window_end = (importlib.import_module("apex_tpu_torch.runtime"),
                  importlib.import_module("apex_tpu_torch.cache"))
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    qk = importlib.import_module("apex_tpu_torch.quant.kernels")
    cv = importlib.import_module("apex_tpu_torch.ops.conv")
    launched = fa.flash_fwd_kernel.launches
    bwd_launched = {"dq": fa.flash_bwd_dq_kernel.launches,
                    "dkv": fa.flash_bwd_dkv_kernel.launches}
    zero_routes(fa)
    zero_bwd_routes(fa)
    lm = capture_vs_eager(
        "gpt2_small O2 B8 T1023",
        lambda: main_amp.build(main_amp.parse(TRAIN_ARGS)),
        lambda k, n: main_amp.train(main_amp.parse(
            TRAIN_ARGS + ["--steps", str(n), "--steps-per-call", str(k)]),
            **quiet), steps, window_end=window_end, keep="lm_o2")
    qmm_launched = qk.qmm_kernel.launches
    zero_wrapper_routes(qk.qmm_kernel)
    o4 = capture_vs_eager(
        "gpt2_small O4 B8 T1023", lambda: build_o4()[:3],
        lambda k, n: window_loop(*build_o4()[:3], k, n), steps,
        window_end=window_end)
    o4["qmm_routes"] = qmm_route_gate(
        "gpt2_small O4 B8 T1023, eager and K 1 / K 8", qk.qmm_kernel.routes,
        qk.qmm_kernel.launches - qmm_launched, decode=False)
    lm["flash_routes"] = route_gate(
        fa, "gpt2_small O2 and O4 B8 T1023, eager and K 1 / K 8",
        fa.flash_fwd_kernel.launches - launched)
    lm["flash_bwd_routes"] = bwd_route_gate(
        "gpt2_small O2 and O4 B8 T1023, eager and K 1 / K 8", bwd_routes(fa),
        {"dq": fa.flash_bwd_dq_kernel.launches - bwd_launched["dq"],
         "dkv": fa.flash_bwd_dkv_kernel.launches - bwd_launched["dkv"]})
    conv_kernels = {"conv_fwd": cv.conv_fwd_kernel,
                    "conv_dgrad": cv.conv_dgrad_kernel,
                    "conv_wgrad": cv.conv_wgrad_kernel}
    conv_launched = {k: w.launches for k, w in conv_kernels.items()}
    zero_wrapper_routes(*conv_kernels.values())
    resnet = capture_vs_eager(
        "resnet50 O2 B128 224",
        lambda: imagenet.build(imagenet.parse(IMAGENET_ARGS)),
        lambda k, n: imagenet.train(imagenet.parse(
            IMAGENET_ARGS + ["--prof", str(n), "--steps-per-call", str(k)]),
            **quiet), steps, window_end=window_end, keep="resnet50_o2")
    resnet["conv_routes"] = conv_route_gate(
        "resnet50 O2 B128 224, eager and K 1 / K 8",
        {k: w.routes for k, w in conv_kernels.items()},
        {k: w.launches - conv_launched[k] for k, w in conv_kernels.items()})
    return dict(lm_o2=lm, lm_o4=o4, resnet50_o2=resnet)


def eager_vs_was(builds, steps=16):
    """Phase 20 with ``--was``: each eager step (:func:`eager_steps`)
    beside the other checkout's on the same model, batch and step, in
    one process, run in the order was, this, this, was; ``builds`` maps a
    name to its ``(this, was)`` builds.  Returns each run's ms a step."""
    out = {}
    for name, (this, was) in builds.items():
        runs = []
        for which, build in (("was", was), ("this", this), ("this", this),
                             ("was", was)):
            runs.append((which, eager_steps(build, steps)[1]))
            torch.cuda.empty_cache()
        out[name] = {w: [ms for w_, ms in runs if w_ == w]
                     for w in ("this", "was")}
        print(f"      {name} eager step ms (was, this, this, was): "
              + ", ".join(f"{ms:.2f}" for _, ms in runs), flush=True)
    return out


# -- phase 21: BERT-base at O2 with Adam and LAMB ------------------------------------

BERT_B, BERT_T, BERT_VOCAB = 16, 128, 30522
# kernel launches per BERT-base training step: 25 LayerNorms (the
# embeddings' and two a layer), 12 flash attentions, one cross-entropy
BERT_PER_STEP = dict(LM_PER_STEP)


def bert_optimizers(training):
    """The BERT path's three optimizers, made afresh each call."""
    return {"adam": lambda: training.adam(lr=1e-4),
            "adam_bucketed": lambda: training.adam(lr=1e-4, bucketed=True),
            "lamb_bucketed": lambda: training.lamb(lr=1e-3, bucketed=True)}


def bert_setup(models, training, xent, dev):
    """A function ``build(tx, loss_scale=None)`` giving ``(state, step,
    batch)`` of the JAX package's BERT step (``bench.py:538-577``):
    ``bert_base(dtype=bf16, num_classes=None, attention_impl="flash")``,
    B 16, T 128, the tied fp32 head ``feats @ word_embeddings.T``,
    ``softmax_cross_entropy_loss`` with smoothing 0.1 and
    ``padding_idx=-1``, O2 through ``make_train_step``; the batch is
    ``(ids, labels, multiplier)``, the loss times the multiplier (1; inf
    injects an overflow).  Every state starts from one model's weights."""
    model = models.bert_base(dtype=torch.bfloat16, num_classes=None,
                             attention_impl="flash", device=dev, seed=0)
    rng = np.random.RandomState(0)
    ids, labels = (torch.from_numpy(rng.randint(0, BERT_VOCAB,
                                                (BERT_B, BERT_T))).to(dev)
                   for _ in range(2))
    one = torch.ones((), device=dev)
    weights = {k: v.detach() for k, v in model.state_dict().items()}

    def loss_fn(p, batch):
        ids_b, labels_b, mult = batch
        feats = torch.func.functional_call(model, p, (ids_b,))
        logits = feats @ p["word_embeddings.embedding"].float().T
        losses = xent.softmax_cross_entropy_loss(
            logits.reshape(-1, logits.shape[-1]), labels_b.reshape(-1),
            smoothing=0.1, padding_idx=-1)
        return losses.mean() * mult

    def build(tx, loss_scale=None, start=None):
        init, step = training.make_train_step(loss_fn, tx, opt_level="O2",
                                              loss_scale=loss_scale)
        return (init({k: v.clone() for k, v in (start or weights).items()}),
                step, (ids, labels, one))
    build.weights, build.batch = weights, (ids, labels, one)
    return build


def bert_windows(build, training, counters, steps=16):
    """Each optimizer: 16 eager steps, then 16 steps at K 1 and K 4
    through the trainers' window loop (every state leaf equal to the
    eager one bit for bit), every launch counter set to 0 just before
    each window run and read just after (``BERT_PER_STEP`` x the steps
    that ran on the card, nothing else), losses finite and falling (the
    last four steps' mean below the first four's: LAMB at lr 1e-3 on
    one fixed batch jumps for a single step now and then, the JAX
    package's BERT step as well); step ms, sequences/s and peak
    memory.  The launches of the bucketed
    LAMB's K 4 run are the path's."""
    out, launches = {}, {}
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    for name, make_tx in bert_optimizers(training).items():
        def run_k(k, n, name=name, make_tx=make_tx):
            state, step, batch = build(make_tx())
            for c in counters.values():
                c.launches = 0
            zero_routes(fa)
            zero_bwd_routes(fa)
            res = window_loop(state, step, batch, k, n)
            got = {c: w.launches for c, w in counters.items()}
            route_gate(fa, f"bert_base {name} K {k}",
                       got["flash_attention_fwd"])
            bwd_route_gate(f"bert_base {name} K {k}", bwd_routes(fa),
                           {"dq": got["flash_attention_bwd_dq"],
                            "dkv": got["flash_attention_bwd_dkv"]})
            ran = pipeline_gate(f"bert_base {name} K {k}", res["pipeline"],
                                n, k)
            check(all(got[c] == BERT_PER_STEP.get(c, 0) * ran for c in got),
                  f"bert_base {name} K {k}: launches {got} = "
                  f"{BERT_PER_STEP} x {ran} steps (the warm run and the "
                  f"replays)")
            launches[(name, k)] = got
            return res
        res = capture_vs_eager(f"bert_base O2 B16 T128 {name}",
                               lambda make_tx=make_tx: build(make_tx()),
                               run_k, steps, ks=(1, 4))
        for k in (1, 4):
            losses = res[f"k{k}"]["losses"]
            first, last = np.mean(losses[:4]), np.mean(losses[-4:])
            check(all(np.isfinite(losses)) and last < first,
                  f"bert_base {name} K {k}: losses finite and falling, "
                  f"steps {steps - 3}-{steps} {last:.4f} < steps 1-4 "
                  f"{first:.4f} on average")
            res[f"k{k}"]["sequences_per_s"] = (
                BERT_B / res[f"k{k}"]["step_ms"] * 1e3)
        print(f"      bert_base {name}: sequences/s K 1 "
              f"{res['k1']['sequences_per_s']:.1f}, K 4 "
              f"{res['k4']['sequences_per_s']:.1f}; losses "
              + " ".join(f"{x:.4f}" for x in res["k1"]["losses"]),
              flush=True)
        out[name] = res
    out["launches"] = launches[("lamb_bucketed", 4)]
    return out


def _twin(leaf_tx, bucketed_tx):
    """A leafwise optimizer that also runs ``bucketed_tx`` on the same
    gradients, skip mask and scale each step, on parameters and a state
    of its own (``side``): the two updates compared on equal inputs, as
    JAX's bucketed-vs-leafwise LAMB test compares them."""
    training = importlib.import_module("apex_tpu_torch.training")
    side = {}

    def init(params):
        side["params"] = {k: v.clone() for k, v in params.items()}
        side["state"] = bucketed_tx.init(side["params"])
        return leaf_tx.init(params)

    def update(grads, state, params, **kw):
        side["params"], side["state"] = bucketed_tx.update(
            grads, side["state"], side["params"], **kw)
        return leaf_tx.update(grads, state, params, **kw)
    return training.FunctionalOptimizer(init, update), side


def bert_optimizer_parity(build, training, steps=16, bad_step=5):
    """16 eager steps with a dynamic loss scale and an inf injected at
    ``bad_step`` (skipped): the bucketed Adam's run equals the leafwise
    Adam's bit for bit in every parameter and moment (the step count 15
    in both); the bucketed LAMB, fed the leafwise LAMB's gradients each
    step, keeps parameters within rtol 5e-5 and atol 5e-6 of the
    leafwise LAMB's (per-leaf norms summed in another order; two runs
    that each take their own gradients part by more, since the bf16
    forward turns any difference into other gradients)."""
    mt = importlib.import_module("apex_tpu_torch.multi_tensor")
    want_flags = [i == bad_step for i in range(steps)]

    def run(tx):
        state, step, (ids, labels, one) = build(tx, loss_scale="dynamic")
        inf = torch.full_like(one, float("inf"))
        flags = []
        for i in range(steps):
            state, met = step(state, (ids, labels,
                                      inf if i == bad_step else one))
            flags.append(met["overflow"])
        return state, [bool(f) for f in flags]
    leaf, leaf_flags = run(training.adam(1e-4))
    buck, buck_flags = run(training.adam(1e-4, bucketed=True))
    store = mt.BucketStore(buck.params)
    pairs = [(f"params.{k}", v, buck.params[k])
             for k, v in leaf.params.items()]
    for moment in ("exp_avg", "exp_avg_sq"):
        unpacked = store.unpack(getattr(buck.opt_state, moment))
        pairs += [(f"{moment}.{k}", v, unpacked[k])
                  for k, v in getattr(leaf.opt_state, moment).items()]
    bad = [n for n, x, y in pairs if not torch.equal(x, y)]
    check(not bad and leaf_flags == buck_flags == want_flags
          and int(leaf.opt_state.step) == int(buck.opt_state.step)
          == steps - 1,
          f"bert_base adam_bucketed vs adam: {len(pairs) - len(bad)}/"
          f"{len(pairs)} parameters and moments bit for bit after {steps} "
          f"steps, step {bad_step} skipped in both"
          + (f"; differing {bad[:5]}" if bad else ""))
    del leaf, buck, pairs
    tx, side = _twin(training.lamb(1e-3), training.lamb(1e-3,
                                                        bucketed=True))
    leaf, flags = run(tx)
    outside = [k for k, v in leaf.params.items() if not torch.allclose(
        side["params"][k], v, rtol=5e-5, atol=5e-6)]
    worst = max(max_err(side["params"][k], v)
                for k, v in leaf.params.items())
    check(not outside and flags == want_flags
          and int(side["state"].step) == steps - 1,
          f"bert_base lamb_bucketed vs lamb on the same gradients: "
          f"parameters within rtol 5e-5, atol 5e-6 (max |diff| "
          f"{worst:.3g}) after {steps} steps, step {bad_step} skipped in "
          f"both" + (f"; outside {outside[:5]}" if outside else ""))
    return dict(adam_leaves_differing=len(bad),
                lamb_leaves_outside=len(outside), lamb_max_abs_diff=worst)


def bert_tiny_card_vs_cpu(models, training, xent, dev):
    """``bert_tiny`` in fp32 on the card and on the CPU from the same
    weights: the classifier's logits with a padding mask, then the
    parameters after three bucketed LAMB steps of the tied-head loss at
    O0, within rtol/atol 1e-4 (fp32 summation order)."""
    rng = np.random.RandomState(21)
    ids = torch.from_numpy(rng.randint(0, 1024, (4, 64)))
    mask = torch.ones(4, 64, dtype=torch.bool)
    mask[1, 40:] = False
    mask[3, 9:] = False
    pair = [models.bert_tiny(device=d, seed=3, attention_impl="flash")
            for d in ("cpu", dev)]
    with torch.no_grad():
        logits = [m(ids.to(m.word_embeddings.embedding.device),
                    mask.to(m.word_embeddings.embedding.device)).cpu()
                  for m in pair]
    err = max_err(logits[1], logits[0])
    check(torch.allclose(logits[1], logits[0], rtol=1e-4, atol=1e-4),
          f"bert_tiny fp32 logits card vs CPU: max |diff| {err:.3g} "
          f"(rtol/atol 1e-4)")
    params = []
    for d in ("cpu", dev):
        model = models.bert_tiny(device=d, seed=3, num_classes=None,
                                 attention_impl="flash")

        def loss_fn(p, batch, model=model):
            feats = torch.func.functional_call(model, p, (batch[0],))
            logits = feats @ p["word_embeddings.embedding"].T
            return xent.softmax_cross_entropy_loss(
                logits.reshape(-1, logits.shape[-1]), batch[1].reshape(-1),
                smoothing=0.1, padding_idx=-1).mean()
        init, step = training.make_train_step(
            loss_fn, training.lamb(1e-3, bucketed=True), opt_level="O0")
        state = init(model.state_dict())
        for i in range(3):
            b = np.random.RandomState(30 + i).randint(0, 1024, (2, 4, 64))
            state, _ = step(state, tuple(torch.from_numpy(x).to(d)
                                         for x in b))
        params.append({k: v.cpu() for k, v in state.params.items()})
    bad = [k for k in params[0] if not torch.allclose(
        params[1][k], params[0][k], rtol=1e-4, atol=1e-4)]
    perr = max(max_err(params[1][k], params[0][k]) for k in params[0])
    check(not bad, f"bert_tiny fp32 parameters after 3 bucketed LAMB steps "
          f"card vs CPU: max |diff| {perr:.3g} (rtol/atol 1e-4)"
          + (f"; outside {bad[:5]}" if bad else ""))
    return dict(logits_max_abs_diff=err, params_max_abs_diff=perr)


def traced_tx(tx):
    """``tx`` with its update inside a ``record_function`` range named
    ``optimizer.update``, so a trace gives the optimizer's device time."""
    def update(*args, **kw):
        with torch.profiler.record_function("optimizer.update"):
            return tx.update(*args, **kw)
    return tx._replace(update=update)


def optimizer_traces(bert_build, main_amp, models, training, dev):
    """The optimizer's device ms a step, leafwise against bucketed, from
    one trace of two eager steps each: the BERT-base step with the three
    BERT optimizers, and the LM O2 step (phase 9's model and loss) with
    the leafwise and the bucketed Adam."""
    out = {}
    for name, make_tx in bert_optimizers(training).items():
        print(f"      bert_base {name}:", flush=True)
        out[f"bert_{name}"] = trace_steps(*bert_build(traced_tx(make_tx())))
    args = main_amp.parse(TRAIN_ARGS)
    model = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0)

    def loss_fn(params, batch):
        return main_amp.lm_loss(torch.func.functional_call(
            model, params, (batch[0],)), batch[1], args.smoothing,
            args.fused_loss)
    for bucketed in (False, True):
        init, step = training.make_train_step(
            loss_fn, traced_tx(training.adam(args.lr,
                                             weight_decay=args.weight_decay,
                                             bucketed=bucketed)),
            opt_level="O2")
        name = "lm_o2_adam" + ("_bucketed" if bucketed else "")
        print(f"      gpt2_small O2 {name}:", flush=True)
        out[name] = trace_steps(
            init(model.state_dict()), step,
            main_amp.synthetic_batch(8, 1024, 50257, dev))
    print("      optimizer device ms a step (the optimizer.update range): "
          + ", ".join(f"{k} {v['ranges_device_ms'].get('optimizer.update', 0):.3f}"
                      for k, v in out.items()), flush=True)
    return out


# -- phase 22: imperative BERT-base at O2 -------------------------------------------

def _imperative_bert_run(name, make_opt, bert_build, models, amp, xent,
                         counters, dev, steps, bad_step, side=None):
    """``amp.initialize`` on a BERT-base of phase 21's weights with
    ``make_opt(model)``, then ``steps`` steps of phase 21's loss through
    ``scale_loss``, ``step()`` and ``zero_grad()``, an inf loss at
    ``bad_step``; every launch counter set to 0 just before the steps and
    read just after.  ``side(opt)`` runs after each backward, before the
    step (it sees the master gradients and the pending overflow flag)."""
    ids, labels, one = bert_build.batch
    model = models.bert_base(dtype=torch.bfloat16, num_classes=None,
                             attention_impl="flash", device=dev, seed=0)
    model.load_state_dict(bert_build.weights)
    model, opt = amp.initialize(model, make_opt(model), opt_level="O2",
                                loss_scale="dynamic", verbosity=0)
    norm = amp.default_norm_predicate
    wrong = [n for n, p in model.named_parameters()
             if p.dtype != (torch.float32 if norm(n) else torch.bfloat16)]
    check(not wrong and all(m.dtype == torch.float32
                            for m in amp.master_params(opt)),
          f"imperative bert_base {name}: model parameters bf16, the norms' "
          f"fp32, masters fp32" + (f"; wrong {wrong[:5]}" if wrong else ""))
    start = {k: v.clone() for k, v in opt.master_tree().items()}
    scaler = amp._amp_state.loss_scalers[0]
    gc.collect()                   # an earlier run's cycles held off the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    for c in counters.values():
        c.launches = 0
    zero_bwd_routes(fa)
    inf = torch.full_like(one, float("inf"))
    skipped_ok = False
    t0 = None
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        feats = model(ids)
        logits = feats @ model.word_embeddings.embedding.float().T
        loss = xent.softmax_cross_entropy_loss(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
            smoothing=0.1, padding_idx=-1).mean() * (
                inf if i == bad_step else one)
        if i == bad_step:
            before = {k: v.clone() for k, v in opt.master_tree().items()}
            scale = scaler.loss_scale()
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        if side is not None:
            side(opt)
        opt.step()
        opt.zero_grad()
        if i == bad_step:
            skipped_ok = (all(torch.equal(v, before[k]) for k, v in
                              opt.master_tree().items())
                          and scaler.loss_scale() == scale / 2)
            del before
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
    got = {c: w.launches for c, w in counters.items()}
    check(got == {c: BERT_PER_STEP.get(c, 0) * steps for c in counters},
          f"imperative bert_base {name}: launches {got} = {BERT_PER_STEP} "
          f"x {steps} steps")
    bwd_route_gate(f"imperative bert_base {name}", bwd_routes(fa),
                   {"dq": got["flash_attention_bwd_dq"],
                    "dkv": got["flash_attention_bwd_dkv"]})
    check(skipped_ok, f"imperative bert_base {name}: the inf step {bad_step} "
          f"left every master bit-identical and halved its scaler")
    res = dict(step_ms=step_ms, launches=got,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    return model, opt, res, start


def imperative_bert(bert_build, bert, models, training, amp, optimizers,
                    xent, counters, dev, steps=16, bad_step=5):
    """Phase 22: BERT-base O2 through the imperative API with
    ``FusedAdam``, ``FusedAdam(bucketed=True)`` and ``FusedLAMB(lr=1e-3,
    bucketed=True)``, 16 steps each with an inf loss at step 5, against
    phase 21's ``make_train_step`` on the same weights, batch and
    dynamic scale: the Adam masters, moments and step bit for bit; the
    LAMB masters and moments within rtol 5e-5, atol 5e-6 of phase 21's
    bucketed LAMB fed the same gradients and skip mask (per-leaf norms
    summed in another order: the port's store keys the buckets on the
    model's bf16 and fp32 parameters, ``make_train_step``'s on the fp32
    masters).  LAMB's step ms, peak memory and launches come from a run
    of its own, without that side update."""
    out = {}
    mt = importlib.import_module("apex_tpu_torch.multi_tensor")
    for name, make_opt, make_tx in (
            ("FusedAdam", lambda m: optimizers.FusedAdam(
                m.parameters(), lr=1e-4), lambda: training.adam(1e-4)),
            ("FusedAdam_bucketed", lambda m: optimizers.FusedAdam(
                m.parameters(), lr=1e-4, bucketed=True),
             lambda: training.adam(1e-4, bucketed=True))):
        model, opt, res, start = _imperative_bert_run(
            name, make_opt, bert_build, models, amp, xent, counters, dev,
            steps, bad_step)
        masters = opt.master_tree()
        st = opt._fstate[0]
        store = opt.param_groups[0]["_store"]
        moments = {m: (store.unpack(getattr(st, m)) if store is not None
                       else getattr(st, m))
                   for m in ("exp_avg", "exp_avg_sq")}
        del model
        amp.initialize(enabled=False, verbosity=0)
        state, step, (ids, labels, one) = bert_build(
            make_tx(), loss_scale="dynamic", start=start)
        inf = torch.full_like(one, float("inf"))
        for i in range(steps):
            state, _ = step(state, (ids, labels,
                                    inf if i == bad_step else one))
        want_m = {m: getattr(state.opt_state, m) for m in moments}
        if isinstance(want_m["exp_avg"], mt.Packed):
            ref_store = mt.BucketStore(state.params)
            want_m = {m: ref_store.unpack(v) for m, v in want_m.items()}
        pairs = [(f"params.{k}", v, state.params[k])
                 for k, v in masters.items()]
        pairs += [(f"{m}.{k}", v, want_m[m][k]) for m in moments
                  for k, v in moments[m].items()]
        bad = [n for n, x, y in pairs if not torch.equal(x, y)]
        check(not bad and int(st.step) == int(state.opt_state.step)
              == steps - 1,
              f"imperative bert_base {name}: {len(pairs) - len(bad)}/"
              f"{len(pairs)} masters and moments bit for bit phase 21's "
              f"make_train_step after {steps} steps, step {bad_step} "
              f"skipped in both" + (f"; differing {bad[:5]}" if bad else ""))
        res["leaves_differing"] = len(bad)
        out[name] = res
        del opt, masters, moments, state, pairs, start
        torch.cuda.empty_cache()

    tx = training.lamb(1e-3, bucketed=True)
    side = {}

    def feed(opt):
        """phase 21's bucketed LAMB on this step's master gradients and
        skip mask"""
        grads = opt.param_groups[0]["_store"].unpack(opt._master_grads[0])
        if "params" not in side:
            side["params"] = {k: v.clone()
                              for k, v in opt.master_tree().items()}
            side["state"] = tx.init(side["params"])
        mask = torch.logical_not(opt._pending[-1][0])
        side["params"], side["state"] = tx.update(
            grads, side["state"], side["params"], apply_mask=mask)

    def make_lamb(m):
        return optimizers.FusedLAMB(m.parameters(), lr=1e-3, bucketed=True)

    # the timed run (step ms, peak memory, launches) without the side
    # update, then the gate's run with it
    model, opt, res, _ = _imperative_bert_run(
        "FusedLAMB_bucketed", make_lamb, bert_build, models, amp, xent,
        counters, dev, steps, bad_step)
    del model, opt
    amp.initialize(enabled=False, verbosity=0)
    torch.cuda.empty_cache()
    model, opt, _, _ = _imperative_bert_run(
        "FusedLAMB_bucketed (with phase 21's LAMB beside it)", make_lamb,
        bert_build, models, amp, xent, counters, dev, steps, bad_step,
        side=feed)
    st = opt._fstate[0]
    store = opt.param_groups[0]["_store"]
    ref_store = mt.BucketStore(side["params"])
    pairs = [(f"params.{k}", v, side["params"][k])
             for k, v in opt.master_tree().items()]
    for m in ("exp_avg", "exp_avg_sq"):
        got_m = store.unpack(getattr(st, m))
        want_m = ref_store.unpack(getattr(side["state"], m))
        pairs += [(f"{m}.{k}", v, want_m[k]) for k, v in got_m.items()]
    outside = [n for n, x, y in pairs
               if not torch.allclose(x, y, rtol=5e-5, atol=5e-6)]
    worst = max(max_err(x, y) for _, x, y in pairs)
    check(not outside and int(st.step) == int(side["state"].step)
          == steps - 1,
          f"imperative bert_base FusedLAMB_bucketed vs phase 21's bucketed "
          f"LAMB on the same gradients: masters and moments within rtol "
          f"5e-5, atol 5e-6 (max |diff| {worst:.3g}) after {steps} steps, "
          f"step {bad_step} skipped in both"
          + (f"; outside {outside[:5]}" if outside else ""))
    res.update(leaves_outside=len(outside), max_abs_diff=worst)
    out["FusedLAMB_bucketed"] = res
    del model, opt, pairs, side
    amp.initialize(enabled=False, verbosity=0)
    torch.cuda.empty_cache()
    phase21 = {"FusedAdam": "adam", "FusedAdam_bucketed": "adam_bucketed",
               "FusedLAMB_bucketed": "lamb_bucketed"}
    for name, key in phase21.items():
        r = out[name]
        print(f"      imperative bert_base {name}: eager step "
              f"{r['step_ms']:.2f} ms (phase 21's {key}: eager "
              f"{bert[key]['eager']['step_ms']:.2f}, captured K 1 "
              f"{bert[key]['k1']['step_ms']:.2f}); peak "
              f"{r['max_memory_allocated_bytes'] / 2**30:.2f} GiB",
              flush=True)
    out["launches"] = out["FusedLAMB_bucketed"]["launches"]
    return out


# -- phase 23: DCGAN at the reference example's widths ----------------------------------

DCGAN_WIDTHS = ["--batchSize", "64", "--nz", "100", "--ngf", "64",
                "--ndf", "64"]
DCGAN_ARGS = DCGAN_WIDTHS + ["--opt_level", "O1", "--data-pool", "8",
                             "--print-freq", "0", "--no-drain"]


def _dcgan_stats_unchanged(name, nets):
    """The running statistics of the pair are their initial 0 and 1."""
    bad = [k for net in nets for k, v in net.named_buffers()
           if not torch.equal(v, torch.zeros_like(v) if k.endswith("mean")
                              else torch.ones_like(v))]
    check(not bad, f"dcgan {name}: BatchNorm running statistics unchanged"
          + (f"; changed {bad[:5]}" if bad else ""))


def dcgan_phase(counters, dev, iters=16):
    """Phase 23: the DCGAN trainer at the reference example's widths (B
    64, nz 100, ngf/ndf 64, 64 x 64 x 3, O1): pipelined at K 1 and K 8,
    16 iterations each, every state leaf equal to 16 eager iterations of
    the step function on the same window's batches bit for bit;
    ``--imperative`` with three scalers and an overflow forced on loss 1
    at iteration 5 (only D's step skipped, only scaler 1 halved); O0
    three iterations card against CPU; losses finite, every kernel
    counter 0, the running statistics unchanged; it/s and peak memory."""
    dcgan = importlib.import_module("apex_tpu_torch.examples.dcgan.main_amp")
    amp = importlib.import_module("apex_tpu_torch.amp")
    out = {}
    for c in counters.values():
        c.launches = 0
    for k in (1, 8):
        args = dcgan.parse(DCGAN_ARGS + ["--iters-per-epoch", str(iters),
                                         "--steps-per-call", str(k)])
        try:
            netG, netD = dcgan.build_models(args, dev)
            state, step_fn = dcgan.build_pipelined(args, netG, netD)
            pool = dcgan.synthetic_pool(args, dev)
            for i in range(iters):
                state, met = step_fn(state, pool[(i % k) % len(pool)])
            want = state
            del state
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            netG, netD = dcgan.build_models(args, dev)
            res = dcgan.train_pipelined(args, netG, netD,
                                        log=lambda line: None)
        finally:
            amp.shutdown()
        differ, n, worst, names = _state_diff(res["state"], want)
        pipe = res["pipeline"]
        check(differ == 0 and pipe["captures"]["hot"] == 1
              and pipe["replays"] == iters // k,
              f"dcgan O1 B64 K {k}: state after {iters} iterations equals "
              f"{iters} eager iterations in {n - differ}/{n} leaves (max "
              f"|diff| {worst:.3g}" + (f", first {names}" if names else "")
              + f"); {pipe['captures']['hot']} capture, {pipe['replays']} "
              f"replays")
        losses = res["loss_d"] + res["loss_g"]
        check(len(losses) == 2 * iters and all(np.isfinite(losses)),
              f"dcgan O1 K {k}: {len(losses)} losses, all finite")
        _dcgan_stats_unchanged(f"pipelined K {k}", (netG, netD))
        out[f"pipelined_k{k}"] = dict(
            it_per_s=res["it_per_s"], loss_d=res["loss_d"],
            loss_g=res["loss_g"], leaves_differing=differ,
            max_memory_allocated_bytes=res.get("peak_bytes"))
        del res, want
        torch.cuda.empty_cache()

    args = dcgan.parse(DCGAN_ARGS + ["--iters-per-epoch", str(iters),
                                     "--imperative"])
    netG, netD = dcgan.build_models(args, dev)
    bad, seen = 5, {}

    def on_iter(i):
        if i == bad:
            seen["d"] = {k: v.clone() for k, v in netD.named_parameters()}
            seen["g"] = {k: v.clone() for k, v in netG.named_parameters()}
            return (1.0, float("inf"), 1.0)
        if i == bad + 1:
            seen["d_kept"] = all(torch.equal(v, seen["d"][k])
                                 for k, v in netD.named_parameters())
            seen["g_moved"] = not all(torch.equal(v, seen["g"][k])
                                      for k, v in netG.named_parameters())
        return None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        res = dcgan.train_imperative(args, netG, netD, log=lambda l: None,
                                     on_iter=on_iter)
        scales = [s.loss_scale() for s in amp._amp_state.loss_scalers]
    finally:
        amp.shutdown()
        amp.initialize(enabled=False, verbosity=0)
    check(seen.get("d_kept") and seen.get("g_moved")
          and scales == [2.0 ** 16, 2.0 ** 15, 2.0 ** 16],
          f"dcgan --imperative O1: an overflow on loss 1 at iteration {bad} "
          f"skipped D's step only (G stepped), scales {scales} (only "
          f"scaler 1 halved)")
    losses = res["loss_d"] + res["loss_g"]
    check(all(np.isfinite(losses)),
          f"dcgan --imperative O1: {len(losses)} losses, all finite")
    _dcgan_stats_unchanged("--imperative", (netG, netD))
    out["imperative"] = dict(it_per_s=res["it_per_s"],
                             loss_d=res["loss_d"], loss_g=res["loss_g"],
                             max_memory_allocated_bytes=res.get(
                                 "peak_bytes"))
    del res, netG, netD
    got = {c: w.launches for c, w in counters.items()}
    check(not any(got.values()),
          f"dcgan: every kernel counter 0 over the pipelined and imperative "
          f"runs ({got})")
    out["launches"] = got
    out["card_vs_cpu_o0"] = dcgan_card_vs_cpu(dcgan, dev)
    print("      dcgan B64 O1 it/s: pipelined K 1 "
          f"{out['pipelined_k1']['it_per_s']:.1f}, K 8 "
          f"{out['pipelined_k8']['it_per_s']:.1f}, imperative "
          f"{out['imperative']['it_per_s']:.1f}; peak GiB "
          + ", ".join(f"{k} {out[k]['max_memory_allocated_bytes'] / 2**30:.2f}"
                      for k in ("pipelined_k1", "pipelined_k8",
                                "imperative")), flush=True)
    return out


def dcgan_grads(dcgan, args, device):
    """The gradients at the initial weights of D's loss on the real batch
    and of G's loss through D (the trainer's losses), one list a net."""
    netG, netD = dcgan.build_models(args, device)
    real, noise = dcgan.synthetic_pool(args, device)[0]
    d_loss = dcgan.bce_with_logits(dcgan._forward(netD, None, real), 1.0)
    g_loss = dcgan.bce_with_logits(dcgan._forward(
        netD, None, dcgan._forward(netG, None, noise)), 1.0)
    return [[g.cpu() for g in torch.autograd.grad(loss, list(net.parameters()))]
            for loss, net in ((d_loss, netD), (g_loss, netG))]


def dcgan_iteration_grads(dcgan, netG, netD, state, batch, d_next):
    """One O0 iteration's gradients from ``state``: D's (its loss on the
    real batch plus its loss on G's detached fakes) and G's (through the
    discriminator ``d_next``), one dict a net."""
    real, noise = batch

    def grads(loss_fn, params):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        return dict(zip(leaves, torch.autograd.grad(
            loss_fn(leaves), list(leaves.values()))))
    with torch.no_grad():
        fake = dcgan._forward(netG, state["g"], noise)
    g_d = grads(lambda p: dcgan.bce_with_logits(
        dcgan._forward(netD, p, real), 1.0) + dcgan.bce_with_logits(
        dcgan._forward(netD, p, fake), 0.0), state["d"])
    g_g = grads(lambda p: dcgan.bce_with_logits(dcgan._forward(
        netD, d_next, dcgan._forward(netG, p, noise)), 1.0), state["g"])
    return g_d, g_g


def dcgan_card_vs_cpu(dcgan, dev, iters=3):
    """Three O0 iterations on the CPU; each of them also on the card from
    the CPU's state of that iteration, so that each is held alone: the
    two losses within rtol/atol 1e-4; D's and G's gradients at the
    initial weights within 1e-4 of each net's largest |gradient| (fp32
    summation order); the trainer's Adam fed the CPU's gradients of each
    iteration on both devices, its new parameters and moments within
    1e-6 + 1e-5 |x| (the update's own rounding); every new parameter
    whose new first moment on the CPU is at least 2% of its net's
    largest |gradient| that iteration within rtol/atol 1e-4, and every
    element within 2.2 lr.  Adam steps an element by about lr whatever
    its gradient's size, so an element whose moment is within the two
    devices' difference of zero steps either way: the biases that feed a
    BatchNorm (their gradient is rounding), and elements near zero when a
    leaky ReLU's branch moves a gradient (a pre-activation within
    rounding of 0 takes the other slope on one device: on an H100 80GB
    HBM3 at 700 W three of D's 7.9M after one iteration, which move G's
    gradients by up to 0.25% of their largest, ``python -m
    apex_tpu_torch.examples.dcgan.kink_probe``; the moment moves by half
    the gradient's difference).  Three iterations run
    freely on each device part by more (3e-4 in the G loss at the third
    on that card): each Adam step turns those differences into lr-sized
    steps, and the two players feed them to each other."""
    pytree = torch.utils._pytree
    args = dcgan.parse(DCGAN_WIDTHS + ["--opt_level", "O0", "--data-pool",
                                       "3"])
    tx = importlib.import_module("apex_tpu_torch.training").adam(
        lr=args.lr, beta1=args.beta1, beta2=0.999)     # the trainer's
    runs = {}
    for d in ("cpu", dev):
        netG, netD = dcgan.build_models(args, d)
        state, step_fn = dcgan.build_pipelined(args, netG, netD)
        runs[d] = (state, step_fn, dcgan.synthetic_pool(args, d),
                   dcgan_grads(dcgan, args, d), (netG, netD))
    state, _, _, cpu_g, cpu_nets = runs["cpu"]
    card_g = runs[dev][3]
    grad_err = max(max_err(a, b) / max(x.abs().max().item() for x in bs)
                   for as_, bs in zip(card_g, cpu_g)
                   for a, b in zip(as_, bs))
    loss_err, param_err, update_err, losses = 0.0, 0.0, 0.0, []
    held, total, off = 0, 0, []

    def on(tree, d):
        return pytree.tree_map(
            lambda t: t.to(d) if isinstance(t, torch.Tensor) else t, tree)
    for i in range(iters):
        new = {d: runs[d][1](on(state, d), runs[d][2][i])
               for d in ("cpu", dev)}
        (cpu_s, cpu_m), (card_s, card_m) = new["cpu"], new[dev]
        for k in ("loss_d", "loss_g"):
            a, b = float(card_m[k]), float(cpu_m[k])
            losses.append((b, a))
            loss_err = max(loss_err, abs(a - b) / (1e-4 + 1e-4 * abs(b)))
        grads = dcgan_iteration_grads(dcgan, *cpu_nets, state,
                                      runs["cpu"][2][i], cpu_s["d"])
        for n, g in zip(("d", "g"), grads):
            floor = 0.02 * max(x.abs().max().item() for x in g.values())
            moment = cpu_s[f"{n}_opt"].exp_avg
            for k, ref in cpu_s[n].items():
                got = card_s[n][k].cpu()
                param_err = max(param_err, max_err(got, ref))
                sure = moment[k].abs() >= floor
                bad = sure & ~torch.isclose(got, ref, rtol=1e-4, atol=1e-4)
                held, total = held + int(sure.sum()), total + sure.numel()
                if bad.any():
                    off.append(f"{i}:{n}.{k}x{int(bad.sum())}")
            cpu_u, card_u = (pytree.tree_leaves(tx.update(
                on(g, d), on(state[f"{n}_opt"], d), on(state[n], d)))
                for d in ("cpu", dev))
            update_err = max([update_err] + [
                ((a.cpu() - b).abs() / (1e-6 + 1e-5 * b.abs())).max().item()
                for a, b in zip(card_u, cpu_u) if b.is_floating_point()])
        state = cpu_s
    check(loss_err <= 1.0 and grad_err <= 1e-4 and update_err <= 1.0
          and not off and param_err <= 2.2 * args.lr,
          f"dcgan O0 B64 {iters} iterations card vs CPU, each from the "
          f"CPU's state: losses within rtol/atol 1e-4 (worst at "
          f"{loss_err:.3g} of it), initial gradients within {grad_err:.3g} "
          f"of each net's largest (<= 1e-4), Adam on the CPU's gradients "
          f"within 1e-6 + 1e-5 |x| (worst at {update_err:.3g} of it), the "
          f"{held}/{total} new parameters whose moment is >= 2% of the "
          f"net's largest |gradient| within rtol/atol 1e-4"
          + (f" but {off[:5]}" if off else "") + f", every element within "
          f"{param_err:.3g} (<= 2.2 lr = {2.2 * args.lr:.3g})")
    return dict(loss_err_of_tol=loss_err, grad_rel_err=grad_err,
                update_err_of_tol=update_err, params_held=held,
                params_total=total, params_off=off,
                param_max_abs_diff=param_err, losses_cpu_card=losses)


# -- phases 24-26: state and input ------------------------------------------------

RESNET_PER_STEP = {"conv_fwd": 53, "conv_dgrad": 52, "conv_wgrad": 53,
                   "bn_act_fwd": 53, "bn_act_bwd": 53, "xentropy_fwd": 1,
                   "xentropy_bwd": 1}


def _ckpt_arrays(step_dir):
    """Every leaf of a checkpoint step directory, as stored."""
    out = {}
    for name in sorted(os.listdir(step_dir)):
        if name.endswith(".npz"):
            with np.load(os.path.join(step_dir, name)) as z:
                out.update({k: z[k] for k in z.files})
    return out


def _same_checkpoint(name, got_dir, want_dir,
                     what="the uninterrupted run's"):
    """Check two checkpoints hold the same leaves bit for bit; returns
    (leaves equal, leaves)."""
    got, want = _ckpt_arrays(got_dir), _ckpt_arrays(want_dir)
    same = sum(k in got and got[k].dtype == want[k].dtype
               and np.array_equal(got[k], want[k]) for k in want)
    differ = [k for k in want if k not in got
              or not np.array_equal(got[k], want[k])][:5]
    check(sorted(got) == sorted(want) and same == len(want),
          f"{name}: {os.path.basename(got_dir)} equals {what} in "
          f"{same}/{len(want)} leaves bit for bit"
          + (f" (first differing {differ})" if differ else ""))
    return same, len(want)


def _counted_run(name, counters, run, per_step, k):
    """``run()`` (a trainer's ``train``) with every launch counter set to
    0 just before and read just after: each equal to ``per_step`` x the
    steps that ran on the card (the warm run of one window and the
    replays)."""
    cache = importlib.import_module("apex_tpu_torch.cache")
    for c in counters.values():
        c.launches = 0
    res = run()
    launches = {n: c.launches for n, c in counters.items()}
    pipe = res["pipeline"]
    ran = cache.WARM_RUNS * k + pipe["steps"]
    check(pipe["captures"] == {"hot": 1, "tail": 0}
          and pipe["replays"] == pipe["steps"] // k
          and all(launches[n] == per_step.get(n, 0) * ran
                  for n in launches),
          f"{name}: {pipe['captures']} captures, {pipe['replays']} replays "
          f"for {pipe['steps']} steps at K {k}; launches "
          f"{ {n: v for n, v in launches.items() if v} } = {per_step} x "
          f"{ran} steps")
    return res, launches


def write_image_folders(root, n_images=640, classes=10, size=256, seed=0):
    """``n_images`` uint8 ``.npy`` images of ``size`` x ``size`` x 3 in
    ``classes`` class folders, their bytes the splitmix64 stream of
    ``seed`` (``native.synth_bytes``)."""
    native = importlib.import_module("apex_tpu_torch.native")
    per = size * size * 3
    raw = native.synth_bytes(n_images * per, seed).reshape(
        n_images, size, size, 3)
    for i in range(n_images):
        d = os.path.join(root, f"class_{i % classes:02d}")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"img_{i:04d}.npy"), raw[i])
    return root


def _kill_after_first_checkpoint(argv, ck_dir, timeout=600):
    """Run ``argv`` as a subprocess from this checkout and SIGKILL it once
    its first valid checkpoint is published; returns ``(returncode, the
    newest valid step directory's name then, its output)``."""
    checkpoint = importlib.import_module("apex_tpu_torch.checkpoint")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    log = os.path.join(ck_dir + ".log")
    with open(log, "w") as out:
        proc = subprocess.Popen(argv, cwd=here, env=env, stdout=out,
                                stderr=subprocess.STDOUT)
        t0 = time.time()
        try:
            while checkpoint.latest_checkpoint(ck_dir) is None:
                if proc.poll() is not None or time.time() - t0 > timeout:
                    break
                time.sleep(0.05)
            found = checkpoint.latest_checkpoint(ck_dir)
            proc.send_signal(signal.SIGKILL)
        finally:
            proc.wait()
    with open(log) as f:
        return proc.returncode, found and os.path.basename(found), f.read()


def resnet50_directory_resume(imagenet, counters, tmp, synthetic_step_ms):
    """Phase 24: the ImageNet trainer at its run line over 640 ``.npy``
    images (5 batches of 128 an epoch, 4 epochs), ``--augment``, K 2,
    ``--workers 4``, a checkpoint every 4 steps: (a) uninterrupted, (b)
    the same run as a subprocess SIGKILLed after its first valid
    checkpoint, (c) ``--resume`` to the end; (c)'s final checkpoint
    equal to (a)'s bit for bit; launches per step; step ms beside the
    synthetic step's, the loader's stall."""
    data_dir = write_image_folders(os.path.join(tmp, "imagenet"))
    k, steps = 2, 20

    def argv(ck):
        return [data_dir, "--arch", "resnet50", "-b", "128", "--opt-level",
                "O2", "--pallas-conv", "--fused-bn", "--fused-loss",
                "--image-size", "224", "--steps-per-call", str(k),
                "--workers", "4", "--augment", "--epochs", "4",
                "--checkpoint-every", "4", "--print-freq", "4",
                "--checkpoint-dir", ck]

    def train(ck, extra=()):
        return imagenet.train(imagenet.parse(argv(ck) + list(extra)),
                              log=lambda line: print("      " + line,
                                                     flush=True))
    ck_a, ck_b = os.path.join(tmp, "resnet_a"), os.path.join(tmp,
                                                             "resnet_b")
    gc.collect()
    torch.cuda.empty_cache()
    res_a, launches = _counted_run("resnet50 directory (a) uninterrupted",
                                   counters, lambda: train(ck_a),
                                   RESNET_PER_STEP, k)
    out = dict(steps=res_a["step"], loader=res_a["loader"],
               step_ms_all=[x * 1e3 for x in res_a["step_s"]],
               step_ms_median=float(np.median(res_a["step_s"][k:])) * 1e3,
               synthetic_step_ms=synthetic_step_ms, launches=launches,
               losses=res_a["losses"])
    check(res_a["step"] == steps and all(np.isfinite(res_a["losses"])),
          f"resnet50 directory (a): {res_a['step']} steps ({steps}), losses "
          f"finite")
    del res_a
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc, saved, log_b = _kill_after_first_checkpoint(
        [sys.executable, "-m", "apex_tpu_torch.examples.imagenet.main_amp"]
        + argv(ck_b), ck_b)
    out["killed_after_s"] = time.perf_counter() - t0
    out["killed_with_valid_step"] = saved
    check(rc == -signal.SIGKILL and saved,
          f"resnet50 directory (b): the subprocess killed (rc {rc}) after "
          f"its checkpoint {saved} was published"
          + ("" if saved else f"\n{log_b[-2000:]}"))
    res_c, out["launches_resumed"] = _counted_run(
        "resnet50 directory (c) resumed", counters,
        lambda: train(ck_b, ["--resume"]), RESNET_PER_STEP, k)
    start = steps - res_c["pipeline"]["steps"]
    check(res_c["step"] == steps and start > 0,
          f"resnet50 directory (c): resumed at step {start}, ran to "
          f"{res_c['step']}")
    out["resumed_at"] = start
    out["leaves_equal"], out["leaves"] = _same_checkpoint(
        "resnet50 directory (c) resumed", os.path.join(ck_b,
                                                       "step_00000020"),
        os.path.join(ck_a, "step_00000020"))
    del res_c
    gc.collect()
    torch.cuda.empty_cache()
    print(f"      resnet50 O2 B128 224 from a directory (--augment, K 2, "
          f"4 workers): step {out['step_ms_median']:.2f} ms (median after "
          f"the first window) beside the synthetic step "
          f"{synthetic_step_ms:.2f} ms (phase 13); loader stall "
          f"{out['loader']['loader_stall_pct']:.2f}% "
          f"({out['loader']['consumer_wait_s']:.3f} s waited of "
          f"{out['loader']['elapsed_s']:.3f} s); killed after "
          f"{out['killed_after_s']:.1f} s, resumed at step {start}",
          flush=True)
    return out


def empty_host_cache():
    """Free the pinned host blocks PyTorch's caching host allocator keeps,
    so the next pinned allocation is a new one, as a process's first."""
    fn = (getattr(getattr(torch, "accelerator", None), "empty_host_cache",
                  None) or getattr(torch._C, "_host_emptyCache", None))
    check(fn is not None, "this torch can empty its pinned host cache")
    if fn is not None:
        fn()


def lm_checkpoint_resume(main_amp, checkpoint, counters, tmp):
    """Phase 25: the LM trainer at phase 20's GPT-2 small O2 (B 8, T 1023,
    Adam, K 2): 16 uninterrupted steps; 8 steps and a save, then a fresh
    pipeline with ``--resume`` to 16: the two final checkpoints equal bit
    for bit.  Run (b) starts with the pinned host cache emptied, as a
    fresh trainer does: its first checkpoint's stall on the loop (the
    manager reserved the pinned buffer while the trainer warmed up) is
    held to <= 20% of a synchronous write of the same state; then, the
    cache emptied again, an async save by a manager that reserved
    nothing (it pins its buffer on the loop's thread), the synchronous
    one and a later async one, each timed from the loop's side."""
    k = 2

    def train(ck, steps, every, extra=()):
        args = main_amp.parse(TRAIN_ARGS + [
            "--steps", str(steps), "--steps-per-call", str(k),
            "--checkpoint-dir", ck, "--checkpoint-every", str(every)]
            + list(extra))
        return main_amp.train(args, log=lambda line: None)
    ck_a, ck_b = os.path.join(tmp, "lm_a"), os.path.join(tmp, "lm_b")
    res_a, launches = _counted_run("gpt2_small checkpoint (a) 16 steps",
                                   counters, lambda: train(ck_a, 16, 16),
                                   LM_PER_STEP, k)
    del res_a
    gc.collect()
    empty_host_cache()
    res_b, _ = _counted_run("gpt2_small checkpoint (b) 8 steps", counters,
                            lambda: train(ck_b, 8, 8), LM_PER_STEP, k)
    first_s = res_b["checkpoint"]["snapshot_s"]
    del res_b
    res_c, launches_c = _counted_run(
        "gpt2_small checkpoint (c) resumed to 16", counters,
        lambda: train(ck_b, 16, 8, ["--resume"]), LM_PER_STEP, k)
    check(res_c["pipeline"]["steps"] == 8 and res_c["step"] == 16,
          f"gpt2_small checkpoint (c): resumed at step "
          f"{16 - res_c['pipeline']['steps']} (8), ran to {res_c['step']}")
    same, n = _same_checkpoint("gpt2_small checkpoint (c) resumed",
                               os.path.join(ck_b, "step_00000016"),
                               os.path.join(ck_a, "step_00000016"))
    shutil.rmtree(ck_a, ignore_errors=True)
    state = res_c["state"]
    ck_t = os.path.join(tmp, "lm_timed")
    mgr = checkpoint.CheckpointManager(ck_t, keep=2)

    def async_stall(step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(step, state)
        stall = time.perf_counter() - t0
        mgr.wait()
        return stall, dict(mgr.stats)
    # cold: a save that pins its buffer on the loop's thread; warm: the
    # caching host allocator hands the same buffer back
    gc.collect()
    empty_host_cache()
    cold_s, cold_stats = async_stall(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(2, state, block=True)
    sync_s = time.perf_counter() - t0
    sync_stats = dict(mgr.stats)
    warm_s, warm_stats = async_stall(3)
    mgr.close()
    shutil.rmtree(ck_t, ignore_errors=True)
    del res_c, state
    gc.collect()
    torch.cuda.empty_cache()
    nbytes = warm_stats["bytes"]
    out = dict(leaves_equal=same, leaves=n, launches=launches,
               launches_resumed=launches_c, state_bytes=nbytes,
               sync_write_s=sync_s, trainer_first_save_stall_s=first_s,
               cold_async_stall_s=cold_s, warm_async_stall_s=warm_s,
               snapshot_ms=warm_stats["snapshot_s"] * 1e3,
               write_ms=warm_stats["write_s"] * 1e3,
               d2h_ms=warm_stats["d2h_s"] * 1e3,
               d2h_gb_per_s=nbytes / warm_stats["d2h_s"] / 1e9,
               cold_d2h_ms=cold_stats["d2h_s"] * 1e3,
               sync_snapshot_ms=sync_stats["snapshot_s"] * 1e3,
               sync_d2h_ms=sync_stats["d2h_s"] * 1e3)
    check(first_s <= 0.2 * sync_s,
          f"gpt2_small checkpoint: the trainer's first async save stalls "
          f"the loop {first_s * 1e3:.2f} ms, {first_s / sync_s:.4f} of the "
          f"synchronous write's {sync_s * 1e3:.1f} ms (<= 0.2); a save "
          f"that pins its buffer on the loop {cold_s * 1e3:.2f} ms "
          f"({cold_s / sync_s:.4f}), a later one {warm_s * 1e3:.2f} ms "
          f"({warm_s / sync_s:.4f})")
    print(f"      gpt2_small O2 state {nbytes / 1e9:.3f} GB: async stall "
          f"{first_s * 1e3:.2f} ms at the trainer's first save (buffer "
          f"reserved), {cold_s * 1e3:.2f} ms with the buffer pinned on the "
          f"loop, {warm_s * 1e3:.2f} ms at a later save (snapshot "
          f"{out['snapshot_ms']:.2f} ms), D2H {out['d2h_ms']:.2f} ms "
          f"({out['d2h_gb_per_s']:.2f} GB/s), serialize+fsync+publish "
          f"{out['write_ms']:.1f} ms on the writer; synchronous save "
          f"{sync_s * 1e3:.1f} ms", flush=True)
    return out


def _publish(prepared, watch):
    """Move a prepared step directory into ``watch`` in one rename, as a
    trainer's manager publishes it."""
    dst = os.path.join(watch, os.path.basename(prepared))
    os.rename(prepared, dst)
    return dst


def hotswap_serving(models, engine_mod, convert, checkpoint, counters, dev,
                    ck_src, tmp):
    """Phase 26: phase 5's GPT-2 small O2 engine on random weights (seed
    0) watching an empty directory with its background watcher (a poll
    every 50 ms); phase 25's step 16 is published into it while 16
    requests are in flight, and the engine keeps serving (new requests
    take freed slots) while the watcher's thread stages it, until the
    swap lands between two scheduler steps (``extract``: the trained
    masters); every request ok with 32 tokens, one hot-swap; 16 requests
    after it equal a fresh engine's on the restored weights bit for bit;
    a later step with a corrupted shard, published the same way, is not
    adopted (``last_error`` names it) while serving goes on; launches per
    forward."""
    cache = importlib.import_module("apex_tpu_torch.cache")
    watch, prep = os.path.join(tmp, "watch"), os.path.join(tmp, "prepared")
    os.makedirs(watch)
    os.makedirs(prep)
    src = os.path.join(ck_src, "step_00000016")
    good = os.path.join(prep, "step_00000016")
    shutil.copytree(src, good)
    torn = os.path.join(prep, "step_00000024")
    shutil.copytree(src, torn)
    shard = [n for n in os.listdir(torn) if n.endswith(".npz")][0]
    with open(os.path.join(torn, shard), "r+b") as f:
        f.seek(os.path.getsize(os.path.join(torn, shard)) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    model = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0)
    like = convert.lm_train_state_like(model)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, model.vocab_size, (int(n),))
               for n in rng.randint(32, 901, 16)]
    later = [rng.randint(1, model.vocab_size, (int(n),))
             for n in rng.randint(32, 901, 16)]
    fa_mod = importlib.import_module(
        counters["flash_attention_fwd"].__module__)
    for c in counters.values():
        c.launches = 0
    zero_routes(fa_mod)
    eng = engine_mod.ServingEngine(
        model, buckets=(256, 1024), page_size=16, max_seqs=8, device=dev,
        watch_dir=watch, extract=convert.gpt_params_from_train_state,
        watch_like=like, poll_every_s=0.05)
    eng.warmup()
    comps = [eng.submit(p, 32) for p in prompts]
    for _ in range(12):
        eng.step()
    _publish(good, watch)
    t_pub = time.perf_counter()
    deadline = t_pub + 120.0
    i = 0
    while eng.stats["hotswaps"] == 0 and time.perf_counter() < deadline:
        # keep every slot busy while the watcher's thread stages
        if sum(not c.done() for c in comps) < eng.max_seqs:
            comps.append(eng.submit(prompts[i % len(prompts)], 32))
            i += 1
        eng.step()
    wait_s = time.perf_counter() - t_pub
    at_swap = [c for c in comps if not c.done()]
    before = [c for c in comps if c.done()]
    eng.run_until_idle()
    across = [c.result(timeout=0) for c in at_swap]
    first = [c.result(timeout=0) for c in comps]
    served_before = [c.result(timeout=0) for c in before]
    after = eng.generate(later, max_new_tokens=32)
    _publish(torn, watch)
    deadline = time.perf_counter() + 60.0
    tail = eng.generate(prompts[:4], max_new_tokens=32)
    while ("step 24" not in (eng.watcher.last_error or "")
           and time.perf_counter() < deadline):
        tail += eng.generate(prompts[:4], max_new_tokens=32)
    launches = {n: c.launches for n, c in counters.items()}
    flash_routes = route_gate(fa_mod, "gpt2_small hot-swap",
                              launches["flash_attention_fwd"], decode=True)
    st = dict(eng.stats)
    load_ms = eng.watcher.load_s * 1e3
    last_error = eng.watcher.last_error
    adopted = eng.watcher.adopted_step
    eng.close()
    forwards = cache.WARM_RUNS * st["captures"] + st["replays"]
    check(all(launches[n] == SERVE_PER_FORWARD.get(n, 0) * forwards
              for n in launches),
          f"gpt2_small hot-swap: launches "
          f"{ {n: v for n, v in launches.items() if v} } = "
          f"{SERVE_PER_FORWARD} x {forwards} forwards (the warm runs of "
          f"{st['captures']} captures, {st['recaptures']} of them after the "
          f"swap, and {st['replays']} replays)")
    served = first + after + tail
    check(st["hotswaps"] == 1 and len(at_swap) > 0
          and all(r.ok and len(r.tokens) == 32 for r in served),
          f"gpt2_small hot-swap: step 16 staged by the watcher's thread and "
          f"adopted {wait_s:.2f} s after it was published, "
          f"{st['hotswaps']} hot-swap (1), {len(at_swap)} requests in "
          f"flight across it, "
          f"{sum(r.ok and len(r.tokens) == 32 for r in served)}/"
          f"{len(served)} requests ok with 32 tokens")
    check(adopted == 16 and "step 24" in (last_error or ""),
          f"gpt2_small hot-swap: the corrupted step 24 not adopted (adopted "
          f"step {adopted}), last_error {last_error!r}")
    fresh_model = models.gpt2_small(dtype=torch.bfloat16, device=dev,
                                    seed=0)
    restored = checkpoint.load_checkpoint_dir(src, like)
    fresh_model.load_state_dict(convert.gpt_params_from_train_state(restored))
    fresh = engine_mod.ServingEngine(fresh_model, buckets=(256, 1024),
                                     page_size=16, max_seqs=8,
                                     device=dev).warmup()
    want = fresh.generate(later, max_new_tokens=32)
    fresh.close()
    same = sum(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(after, want))
    check(same == 16, f"gpt2_small hot-swap: tokens after adoption equal a "
          f"fresh engine's on the restored weights in {same}/16 requests")
    del model, fresh_model, like, restored
    gc.collect()
    torch.cuda.empty_cache()

    def tpot_p99(results):
        return _pct([r.timings["tpot_s"] for r in results if r.ok], 0.99)
    out = dict(in_flight_at_swap=len(at_swap), hotswaps=st["hotswaps"],
               recaptures=st["recaptures"], watcher_load_ms=load_ms,
               publish_to_swap_s=wait_s, swap_ms=st["swap_s"] * 1e3,
               requests_while_staging=len(served_before),
               tpot_p99_ms_across_swap=tpot_p99(across),
               tpot_p99_ms_while_staging=tpot_p99(served_before),
               tpot_p99_ms_without_swap=tpot_p99(after),
               tokens_equal_fresh=same, torn_last_error=last_error,
               launches=launches, flash_routes=flash_routes)
    print(f"      gpt2_small hot-swap: the watcher's thread staged step 16 "
          f"in {load_ms:.1f} ms (adopted {wait_s:.2f} s after it was "
          f"published), the adopting step's swap and recapture "
          f"{out['swap_ms']:.1f} ms ({st['recaptures']} graphs); TPOT p99 "
          f"{out['tpot_p99_ms_across_swap']:.2f} ms of the {len(at_swap)} "
          f"requests in flight across the swap, "
          f"{out['tpot_p99_ms_while_staging']:.2f} ms of the "
          f"{len(served_before)} finished while the watcher staged, "
          f"{out['tpot_p99_ms_without_swap']:.2f} ms of 16 without a swap",
          flush=True)
    return out


# -- main ---------------------------------------------------------------------

# -- phases 27-28: data parallel -----------------------------------------------------

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
RESNET_KERNELS = ("conv_fwd", "conv_dgrad", "conv_wgrad", "bn_act_fwd",
                  "bn_act_bwd", "xentropy_fwd", "xentropy_bwd")
DDP_NCCL_ARGS = ["-m", "apex_tpu_torch.examples.imagenet.main_amp",
                 "--synthetic", "--arch", "resnet50", "-b", "128",
                 "--opt-level", "O2", "--loss-scale", "dynamic",
                 "--pallas-conv", "--fused-loss", "--sync_bn",
                 "--no-fused-bn", "--steps-per-call", "2", "--prof", "16",
                 "--print-freq", "8"]
# per ResNet-50 O2 step under one NCCL rank: the gradients in one fp32
# bucket, the 53 SyncBatchNorms' statistics forward and their cotangent
# backward, the loss with the statistics' pmean, the overflow flag (the
# O2 preset's scale is static: the flag's agreement needs the dynamic
# scale)
DDP_NCCL_COLLECTIVES = {"grads": 1, "bn_stats": 53, "bn_grad": 53,
                        "state": 1, "overflow": 1}
DDP_GLOO_WORLD, DDP_GLOO_BATCH, DDP_GLOO_STEPS = 2, 64, 3


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _by_kernel(counters, launches):
    """A run's launches (by wrapper name) by the kernels' names here,
    every kernel listed."""
    return {n: launches.get(c.__name__, 0) for n, c in counters.items()}


def _collectives(launches):
    return {w[len("collective_"):]: v for w, v in launches.items()
            if w.startswith("collective_")}


def _trainer_subprocess(name, cmd, tmp, timeout=900):
    """Run a trainer command line as a subprocess, its state checkpointed
    at the end and its numbers in ``--stats-json``; returns ``(stats,
    checkpoint step dir)`` or None (the failure checked)."""
    ck = os.path.join(tmp, name, "ck")
    stats_path = os.path.join(tmp, name, "stats.json")
    os.makedirs(os.path.dirname(stats_path), exist_ok=True)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd + ["--checkpoint-dir", ck, "--stats-json",
                                     stats_path], capture_output=True,
                              text=True, timeout=timeout, env=_child_env(),
                              cwd=REPO_ROOT)
        rc, err = proc.returncode, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, err = None, str(e)
    wall = time.perf_counter() - t0
    check(rc == 0, f"{name}: the trainer exited {rc} after {wall:.1f} s"
          + ("" if rc == 0 else f": {err[-3000:]}"))
    if rc != 0:
        return None
    checkpoint = importlib.import_module("apex_tpu_torch.checkpoint")
    with open(stats_path) as f:
        stats = json.load(f)
    stats["wall_s"] = wall
    return stats, checkpoint.latest_checkpoint(ck)


def ddp_nccl(counters, tmp):
    """Phase 27: the ImageNet trainer at ResNet-50 O2 B 128 with
    ``--sync_bn --no-fused-bn`` and K 2, 16 steps, (a) under the spawner
    as an NCCL group of one and (b) plainly: (a)'s final state equal to
    (b)'s bit for bit, one capture and 8 replays each, the same kernel
    launches, kernels 1-7 at least once a step, and (a)'s collectives
    recorded in the graph (counted at the warm run and each replay)."""
    cache = importlib.import_module("apex_tpu_torch.cache")
    k, steps = 2, 16
    ran = cache.WARM_RUNS * k + steps
    stream = os.path.join(tmp, "ddp_nccl_rank{rank}.jsonl")
    spawned = _trainer_subprocess("ddp_nccl_group", [
        sys.executable, "-m", "apex_tpu_torch.parallel.multiproc", "--nproc",
        "1", "--coordinator", f"file://{tmp}/ddp_nccl_store", "--timeout",
        "800"] + DDP_NCCL_ARGS + ["--telemetry", stream], tmp)
    plain = _trainer_subprocess("ddp_nccl_plain",
                                [sys.executable] + DDP_NCCL_ARGS, tmp)
    if spawned is None or plain is None:
        return dict(launches={})
    (a, a_dir), (b, b_dir) = spawned, plain
    for name, st in (("(a) NCCL group of one", a), ("(b) no group", b)):
        pipe = st["pipeline"]
        check(st["world"] == 1 and pipe["captures"] == {"hot": 1, "tail": 0}
              and pipe["replays"] == steps // k and st["steps"] == steps,
              f"ddp_nccl {name}: {pipe['captures']} captures, "
              f"{pipe['replays']} replays for {st['steps']} steps at K {k}")
    _same_checkpoint("ddp_nccl", a_dir, b_dir,
                     what="the run without a group's")
    ka, kb = _by_kernel(counters, a["launches"]), _by_kernel(counters,
                                                            b["launches"])
    check(ka == kb and all(ka.get(n, 0) >= ran for n in RESNET_KERNELS),
          f"ddp_nccl: kernel launches of (a) {ka} = (b)'s {kb}, kernels 1-7 "
          f"each at least once a step ({ran} steps on the card)")
    names = {k: counters[k].__name__ for k in RESNET_CONV_ROUTES}
    for tag, st in (("(a)", a), ("(b)", b)):
        conv_route_gate(
            f"ddp_nccl {tag}",
            {k: st.get("routes", {}).get(n, {}) for k, n in names.items()},
            {k: st["launches"].get(n, 0) for k, n in names.items()})
    coll = _collectives(a["launches"])
    want = {kind: n * ran for kind, n in DDP_NCCL_COLLECTIVES.items()}
    check(coll == want and not _collectives(b["launches"]),
          f"ddp_nccl: (a)'s collectives {coll} = {DDP_NCCL_COLLECTIVES} a "
          f"step x {ran} (the warm run and 8 replays of one graph), (b) "
          f"none")
    # (a) recorded its stream: the collectives noted once, in the warm
    # run's first step before the graph was captured, never per replay
    ev = _stream(stream.format(rank=0))
    first_window = next(i for i, e in enumerate(ev) if e["kind"] == "window")
    coll = [i for i, e in enumerate(ev) if e["kind"] == "collective"]
    retr = [e for e in ev if e["kind"] == "retrace"]
    check(len(coll) == sum(DDP_NCCL_COLLECTIVES.values())
          and all(i < first_window for i in coll)
          and len(retr) == 1 and retr[0]["first"]
          and ev[0]["process_index"] == 0
          and sum(e["kind"] == "window" for e in ev) == steps // k,
          f"ddp_nccl (a) telemetry: {len(coll)} collective events (the "
          f"{sum(DDP_NCCL_COLLECTIVES.values())} a step), all at the warm "
          f"run before the first replay; {len(retr)} capture; "
          f"{sum(e['kind'] == 'window' for e in ev)} windows")
    out = dict(launches=ka, collectives_per_step=DDP_NCCL_COLLECTIVES,
               collective_events=len(coll))
    for tag, st in (("group", a), ("plain", b)):
        out[f"{tag}_step_ms"] = float(np.median(st["step_s"][2:])) * 1e3
        out[f"{tag}_step_ms_all"] = [x * 1e3 for x in st["step_s"]]
        out[f"{tag}_wall_s"] = st["wall_s"]
    print(f"      ddp_nccl ResNet-50 O2 B128 K2 --sync_bn, dynamic scale: "
          f"step {out['group_step_ms']:.2f} ms in an NCCL group of one, "
          f"{out['plain_step_ms']:.2f} ms without a group (medians of "
          f"steps 3-16); collectives a step {DDP_NCCL_COLLECTIVES}",
          flush=True)
    return out


def _ddp_gloo_model(models, groupbn, ops, dev, seed, bn_group):
    import functools
    norm = functools.partial(groupbn.BatchNorm2d_NHWC, bn_group=bn_group,
                             axis_name="data" if bn_group > 1 else None,
                             world_size=DDP_GLOO_WORLD if bn_group > 1
                             else None)
    return models.ResNet50(num_classes=1000, dtype=torch.float32,
                           norm_cls=norm, conv_cls=ops.PallasConv,
                           device=dev, seed=seed)


def _ddp_gloo_step(training, imagenet, model, axis, loss_scale=None):
    def loss_fn(p, ms, batch):
        logits, new_ms = model.apply(p, ms, batch[0])
        loss = imagenet.image_loss(logits, batch[1])
        if len(batch) > 2:
            loss = loss * batch[2].max()
        return loss, new_ms
    return training.make_train_step(
        loss_fn, training.sgd(lr=0.1 * DDP_GLOO_BATCH / 256, momentum=0.9,
                              weight_decay=1e-4),
        opt_level="O0", loss_scale=loss_scale, axis_name=axis,
        has_model_state=True)


def _state_arrays(state):
    out = {f"params/{k}": v.detach().cpu().numpy()
           for k, v in state.params.items()}
    out.update({f"stats/{k}": v.detach().cpu().numpy()
                for k, v in state.model_state.items()})
    return out


def ddp_gloo_worker(out_dir) -> int:
    """One rank of phase 28 (``chip_smoke.py --ddp-gloo-worker DIR``,
    started by the spawner with ``--rank``): ResNet-50 fp32 O0 with
    ``PallasConv`` and GroupBN ``bn_group=2``, its weights from seed
    ``rank`` broadcast from rank 0; 3 eager steps of 32 images; a fourth
    step instrumented for gloo's share; a dynamic-scale step with an inf
    on rank 1 only.  Writes ``rank<r>.npz`` and ``rank<r>.json``."""
    multiproc = importlib.import_module("apex_tpu_torch.parallel.multiproc")
    rank, world = multiproc.initialize(device="cuda", backend="gloo")
    telemetry = importlib.import_module("apex_tpu_torch.telemetry")
    rec = telemetry.start(os.path.join(out_dir, f"rank{rank}.jsonl"),
                          example="ddp_gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    models = importlib.import_module("apex_tpu_torch.models")
    groupbn = importlib.import_module("apex_tpu_torch.contrib.groupbn")
    ops = importlib.import_module("apex_tpu_torch.ops")
    parallel = importlib.import_module("apex_tpu_torch.parallel")
    training = importlib.import_module("apex_tpu_torch.training")
    runtime = importlib.import_module("apex_tpu_torch.runtime")
    build = importlib.import_module("apex_tpu_torch._build")
    imagenet = importlib.import_module(
        "apex_tpu_torch.examples.imagenet.main_amp")
    info = dict(rank=rank, world=world)
    model = _ddp_gloo_model(models, groupbn, ops, dev, rank, 2)
    own = {k: v.clone() for k, v in model.state_dict().items()}
    parallel.DistributedDataParallel(model).sync_params()
    ref = _ddp_gloo_model(models, groupbn, ops, dev, 0, 2).state_dict()
    info["broadcast_exact"] = all(torch.equal(v, ref[k])
                                  for k, v in model.state_dict().items())
    info["seed_differs"] = rank == 0 or not all(
        torch.equal(v, ref[k]) for k, v in own.items())
    del ref, own
    init, step = _ddp_gloo_step(training, imagenet, model, "data")
    params, stats = model.variables()
    state = init({k: v.detach() for k, v in params.items()},
                 {k: v.clone() for k, v in stats.items()})
    rows = DDP_GLOO_BATCH // world
    x, y = imagenet.synthetic_batch(DDP_GLOO_BATCH, 224, dev)
    batch = (x[rank * rows:(rank + 1) * rows].contiguous(),
             y[rank * rows:(rank + 1) * rows].contiguous())
    window = tuple(t.unsqueeze(0).expand(2, *t.shape) for t in batch)
    try:
        runtime.StepPipeline(step, 2).warmup(state, window)
        info["pipeline_refused"] = False
    except RuntimeError as e:
        info["pipeline_refused"] = "gloo" in str(e)
    for c in build.COUNTED:
        c.launches = 0
    step_ms, losses = [], []
    for _ in range(DDP_GLOO_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    info.update(step_ms=step_ms, losses=losses,
                launches={c.__name__: c.launches for c in build.COUNTED
                          if c.launches})
    buckets = importlib.import_module("apex_tpu_torch.multi_tensor.buckets")
    info["bucket_bytes"] = int(sum(
        d.numel() * d.element_size() for d in
        buckets.BucketStore(state.params).pack(state.params).data))
    rec.close()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **_state_arrays(state))
    # one more step, its result dropped, with every all_reduce timed
    # between two synchronizations: gloo's share of an eager step
    dist = importlib.import_module("torch.distributed")
    plain_all_reduce, spent = dist.all_reduce, [0.0]

    def timed_all_reduce(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plain_all_reduce(*a, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        return out
    dist.all_reduce = timed_all_reduce
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        dist.all_reduce = plain_all_reduce
    info.update(instrumented_step_ms=total * 1e3,
                all_reduce_ms=spent[0] * 1e3)
    # a dynamic scale, and an inf on rank 1's rows only
    init2, step2 = _ddp_gloo_step(training, imagenet, model, "data",
                                  loss_scale="dynamic")
    st2 = init2(state.params, state.model_state)
    scale_before = float(st2.scaler.loss_scale)
    before = {k: v.clone() for k, v in st2.params.items()}
    factor = torch.full((rows,), float("inf") if rank == 1 else 1.0,
                        device=dev)
    st2, m2 = step2(st2, batch + (factor,))
    info.update(
        skip_overflow=bool(m2["overflow"]),
        skip_params_same=all(torch.equal(before[k], v)
                             for k, v in st2.params.items()),
        skip_scale=float(m2["loss_scale"]), skip_scale_before=scale_before)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    multiproc.shutdown()
    return 0


def ddp_gloo(counters, tmp, dev):
    """Phase 28: two gloo ranks on the one card (``ddp_gloo_worker``),
    then one process on the whole 64-image batch with ``bn_group=1``:
    the ranks' parameters and statistics bit-identical to each other and
    within rtol/atol 1e-4 of the one process's; the broadcast exact; the
    inf on one rank skipped on both with the scale halved; a captured
    pipeline refused; kernels 1-7 launched on every step."""
    multiproc = importlib.import_module("apex_tpu_torch.parallel.multiproc")
    out_dir = os.path.join(tmp, "ddp_gloo")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    res = multiproc.spawn([os.path.abspath(__file__), "--ddp-gloo-worker",
                           out_dir], DDP_GLOO_WORLD,
                          f"file://{out_dir}/store", timeout=600,
                          capture=True, env=_child_env(), cwd=REPO_ROOT)
    wall = time.perf_counter() - t0
    rcs = [r["returncode"] for r in res]
    check(rcs == [0] * DDP_GLOO_WORLD,
          f"ddp_gloo: {DDP_GLOO_WORLD} ranks exited {rcs} in {wall:.1f} s"
          + ("" if rcs == [0] * DDP_GLOO_WORLD else ": " + " | ".join(
              (r["output"] or "")[-2000:] for r in res)))
    if rcs != [0] * DDP_GLOO_WORLD:
        return dict(launches={})
    infos, arrays = [], []
    for r in range(DDP_GLOO_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            infos.append(json.load(f))
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            arrays.append({k: z[k] for k in z.files})
    same = sum(np.array_equal(arrays[0][k], arrays[1][k]) for k in arrays[0])
    check(same == len(arrays[0]) and infos[0]["losses"] == infos[1]["losses"],
          f"ddp_gloo: after {DDP_GLOO_STEPS} steps the ranks' parameters "
          f"and running statistics bit-identical in {same}/"
          f"{len(arrays[0])} leaves, losses {infos[0]['losses']}")
    check(all(i["broadcast_exact"] and i["seed_differs"] for i in infos),
          "ddp_gloo: rank 1's seed-1 weights made rank 0's bit for bit by "
          "DistributedDataParallel.sync_params()")
    check(all(i["pipeline_refused"] for i in infos),
          "ddp_gloo: a CUDA StepPipeline refuses the gloo step (no capture, "
          "no eager fallback)")
    check(all(i["skip_overflow"] and i["skip_params_same"]
              and i["skip_scale"] == i["skip_scale_before"] / 2
              for i in infos),
          f"ddp_gloo: an inf on rank 1 only: both ranks skip "
          f"(parameters bit-identical), the scale "
          f"{infos[0]['skip_scale_before']:.0f} -> "
          f"{[i['skip_scale'] for i in infos]}")
    launches = _by_kernel(counters, infos[0]["launches"])
    want = {n: RESNET_PER_STEP.get(n, 0) * DDP_GLOO_STEPS for n in counters}
    check({n: launches.get(n, 0) for n in counters} == want,
          f"ddp_gloo rank 0: launches {launches} = {RESNET_PER_STEP} x "
          f"{DDP_GLOO_STEPS} eager steps")
    coll = {kind: n / DDP_GLOO_STEPS
            for kind, n in _collectives(infos[0]["launches"]).items()}
    # the ranks' streams, merged by prof.fleet: each rank noted the
    # gradient bucket once a step, its bytes the bucket's
    tfleet = importlib.import_module("apex_tpu_torch.prof.fleet")
    paths = [os.path.join(out_dir, f"rank{r}.jsonl")
             for r in range(DDP_GLOO_WORLD)]
    hosts = tfleet.load_fleet(paths)
    fleet = tfleet.analyze_fleet(hosts)
    grads = [[e["bytes"] for e in h.events if e["kind"] == "collective"
              and e["op"] == "psum" and e["bytes"] == i["bucket_bytes"]]
             for h, i in zip(hosts, infos)]
    check(fleet["n_hosts"] == DDP_GLOO_WORLD
          and [h.host for h in hosts] == list(range(DDP_GLOO_WORLD))
          and all(len(g) == DDP_GLOO_STEPS for g in grads)
          and infos[0]["bucket_bytes"] == infos[1]["bucket_bytes"],
          f"ddp_gloo telemetry: prof.fleet merged {fleet['n_hosts']} rank "
          f"streams; each noted the {infos[0]['bucket_bytes']}-byte "
          f"gradient bucket once an eager step "
          f"({[len(g) for g in grads]})")
    # one process, the whole batch, statistics over all 64 images
    models = importlib.import_module("apex_tpu_torch.models")
    groupbn = importlib.import_module("apex_tpu_torch.contrib.groupbn")
    ops = importlib.import_module("apex_tpu_torch.ops")
    training = importlib.import_module("apex_tpu_torch.training")
    imagenet = importlib.import_module(
        "apex_tpu_torch.examples.imagenet.main_amp")
    model = _ddp_gloo_model(models, groupbn, ops, dev, 0, 1)
    init, step = _ddp_gloo_step(training, imagenet, model, None)
    params, stats = model.variables()
    state = init({k: v.detach() for k, v in params.items()},
                 {k: v.clone() for k, v in stats.items()})
    batch = imagenet.synthetic_batch(DDP_GLOO_BATCH, 224, dev)
    losses = []
    for _ in range(DDP_GLOO_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    whole = _state_arrays(state)
    del model, state
    worst, off = 0.0, []
    for k, want_v in whole.items():
        got = arrays[0][k]
        err = float(np.max(np.abs(got - want_v)
                           / (1e-4 + 1e-4 * np.abs(want_v))))
        worst = max(worst, err)
        if err > 1.0:
            off.append(k)
    check(not off and np.allclose(infos[0]["losses"], losses, rtol=1e-4,
                                  atol=1e-4),
          f"ddp_gloo: two ranks within rtol/atol 1e-4 of one process on the "
          f"whole batch in every leaf (worst at {worst:.3g} of it)"
          + (f" but {off[:5]}" if off else "") + f"; losses "
          f"{infos[0]['losses']} vs {losses}")
    out = dict(launches=launches, collectives_per_step=coll,
               step_ms=[i["step_ms"] for i in infos],
               step_ms_median=[float(np.median(i["step_ms"])) for i in infos],
               instrumented_step_ms=[i["instrumented_step_ms"]
                                     for i in infos],
               all_reduce_ms=[i["all_reduce_ms"] for i in infos],
               gloo_share=[i["all_reduce_ms"] / i["instrumented_step_ms"]
                           for i in infos],
               worst_of_tol=worst, wall_s=wall)
    print(f"      ddp_gloo ResNet-50 O0 fp32, 2 ranks x 32 images on one "
          f"card: eager step ms a rank {out['step_ms_median']} (median of "
          f"{DDP_GLOO_STEPS}); gloo's host-staged all_reduce "
          f"{[round(x, 2) for x in out['all_reduce_ms']]} ms of an "
          f"instrumented step's {[round(x, 2) for x in out['instrumented_step_ms']]}"
          f" (share {[round(x, 4) for x in out['gloo_share']]}; gloo, not "
          f"a measure of NCCL); collectives a step {coll}", flush=True)
    return out


# -- phases 29-30: run telemetry ------------------------------------------------------

TELEMETRY_ENV = ("APEX_TPU_TELEMETRY", "APEX_TPU_WATCHDOG",
                 "APEX_TPU_METRICS_PORT", "APEX_TPU_METRICS_TEXTFILE",
                 "APEX_TPU_TRACE_SAMPLE", "APEX_TPU_SLO")
SERVE_SLO = "ttft_p99<200ms,tpot_p99<30ms"


def _stream(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _lm_telemetry_run(main_amp, counters, flags, steps=16, k=8):
    """Phase 20's LM trainer at K ``k`` through its CLI (``run``) with
    ``flags``: its result and the launches of the run (every counter set
    to 0 just before)."""
    for c in counters.values():
        c.launches = 0
    res = main_amp.run(TRAIN_ARGS + ["--steps", str(steps),
                                     "--steps-per-call", str(k)] + flags,
                       log=lambda line: None)
    launches = {n: c.launches for n, c in counters.items()}
    return res, launches


def _timeline_json(path):
    """``python -m apex_tpu_torch.prof.timeline PATH --json``."""
    out = subprocess.run([sys.executable, "-m",
                          "apex_tpu_torch.prof.timeline", path, "--json"],
                         capture_output=True, text=True, timeout=120,
                         env=_child_env(), cwd=REPO_ROOT, check=True)
    return json.loads(out.stdout)


def _skip_run(main_amp, training, telemetry, path, dev, steps=8, k=4,
              bad=5):
    """GPT-2 small O2 with a dynamic scale through ``StepPipeline`` at K
    ``k``, the loss multiplied by a per-step factor of the window (inf at
    step ``bad``), under a recorder with the watchdog: its stream and the
    per-step overflow flags."""
    runtime = importlib.import_module("apex_tpu_torch.runtime")
    args = main_amp.parse(TRAIN_ARGS)
    model = importlib.import_module("apex_tpu_torch.models").GPT(
        vocab_size=args.vocab, hidden_size=args.hidden,
        num_layers=args.layers, num_heads=args.heads, mlp_dim=4 * args.hidden,
        max_len=args.seq_len, dtype=torch.bfloat16, attention_impl="flash",
        device=dev, seed=0)
    init, step = _lm_step(main_amp, training, model, "O2",
                          loss_scale="dynamic", inject=True)
    state = init(model.state_dict())
    x, y = main_amp.synthetic_batch(args.batch_size, args.seq_len,
                                    args.vocab, dev)
    factors = torch.ones(steps, device=dev)
    factors[bad] = float("inf")
    windows = [((x.expand(k, *x.shape), y.expand(k, *y.shape),
                 factors[i:i + k]), k) for i in range(0, steps, k)]
    flags = []
    rec = telemetry.start(path, watchdog=True, example="skip")
    try:
        runtime.StepPipeline(step, k).run(
            state, windows, on_metrics=lambda wm: flags.extend(
                bool(f) for f in wm.fetch()["overflow"][:wm.n_valid]))
    finally:
        rec.close()
    return _stream(path), flags, rec.watchdog.health()


def training_telemetry(main_amp, training, counters, dev, tmp):
    """Phase 29: phase 20's LM trainer (GPT-2 small O2, B 8, T 1023, Adam,
    K 8, 16 steps) through its CLI without any telemetry flag or variable
    and with ``--telemetry --watchdog --metrics-textfile``: the final
    states bit for bit, the same launches (phase 20's per-step counts x
    the steps on the card), the stream's windows, captures, metric reads,
    no alert, the summary, the textfile, ``prof.timeline --json``; the
    captured step ms of both and their ratio (at most 1.5, JAX's
    overhead gate).  Then a dynamic-scale run with an inf at one step:
    one ``scale`` skip event, no ``scale_collapse``."""
    telemetry = importlib.import_module("apex_tpu_torch.telemetry")
    cache = importlib.import_module("apex_tpu_torch.cache")
    saved = {k: os.environ.pop(k) for k in TELEMETRY_ENV if k in os.environ}
    steps, k = 16, 8
    path, prom = os.path.join(tmp, "lm.jsonl"), os.path.join(tmp, "lm.prom")
    try:
        # without, with, without: the recorder's run between two plain ones
        plain, plain_l = _lm_telemetry_run(main_amp, counters, [], steps, k)
        rec_res, rec_l = _lm_telemetry_run(
            main_amp, counters, ["--telemetry", path, "--watchdog",
                                 "--metrics-textfile", prom], steps, k)
        again, _ = _lm_telemetry_run(main_amp, counters, [], steps, k)
    finally:
        os.environ.update(saved)
    differ, n, worst, names = _state_diff(rec_res["state"], plain["state"])
    check(differ == 0, f"lm telemetry: the final state with the recorder "
          f"equals the run without in {n - differ}/{n} leaves"
          + (f" (first {names}, max |diff| {worst:.3g})" if differ else ""))
    ran = cache.WARM_RUNS * k + steps
    want = {name: LM_PER_STEP.get(name, 0) * ran for name in counters}
    check(plain_l == rec_l == want,
          f"lm telemetry: launches with the recorder {rec_l} = without "
          f"{plain_l} = {LM_PER_STEP} x {ran} steps on the card")
    ev = _stream(path)
    kinds = [e["kind"] for e in ev]
    pipe = rec_res["pipeline"]
    retr = [e for e in ev if e["kind"] == "retrace"]
    check(kinds.count("window") == pipe["replays"] == steps // k
          and len(retr) == pipe["captures"]["hot"] == 1
          and all(e["first"] for e in retr),
          f"lm telemetry: {kinds.count('window')} window events = "
          f"{pipe['replays']} replays, {len(retr)} retrace event(s) with "
          f"first = {pipe['captures']['hot']} capture, none without")
    mets = [e for e in ev if e["kind"] == "metrics"]
    fields = {"t", "kind", "step", "n_valid", "dur", "loss", "loss_scale",
              "skips"}
    check(len(mets) == steps // k
          and all(set(m) == fields and len(m["loss"]) == k
                  and all(np.isfinite(m["loss"])) for m in mets)
          and [m["step"] for m in mets] == list(range(0, steps, k)),
          f"lm telemetry: {len(mets)} metrics events, one a window, "
          f"fields {sorted(set().union(*map(set, mets)))} with {k} finite "
          f"losses each")
    check("alert" not in kinds and kinds[-1] == "summary",
          f"lm telemetry: no alert ({kinds.count('alert')}), the stream "
          f"ends with the summary ({kinds[-1]})")
    with open(prom) as f:
        text = f.read()
    have = {m: f"apex_tpu_{m} " in text
            for m in ("steps_per_s", "loss", "peak_hbm_bytes")}
    check(all(have.values()), f"lm telemetry: the textfile holds {have}")
    tl = _timeline_json(path)
    check((tl["steps"], tl["windows"]) == (steps, steps // k),
          f"lm telemetry: prof.timeline --json reads {tl['steps']} steps "
          f"in {tl['windows']} windows")
    ms = [float(np.median(r["step_s"][k:])) * 1e3
          for r in (plain, rec_res, again)]
    ratio = ms[1] / (0.5 * (ms[0] + ms[2]))
    check(ratio <= 1.5, f"lm telemetry: captured step {ms[1]:.3f} ms with "
          f"the recorder / {0.5 * (ms[0] + ms[2]):.3f} ms without (the "
          f"mean of the runs before and after) = {ratio:.4f} (<= 1.5)")
    print(f"      lm telemetry K {k}: captured step ms without "
          f"{ms[0]:.3f}, with the recorder {ms[1]:.3f}, without again "
          f"{ms[2]:.3f} (ratio {ratio:.4f}); window events' host ms "
          f"{[round(e['dur'] * 1e3, 3) for e in ev if e['kind'] == 'window']}"
          f", gaps {[round(e['gap'] * 1e3, 3) for e in ev if e['kind'] == 'window']}"
          f"; {len(ev)} events", flush=True)
    skip_ev, flags, health = _skip_run(main_amp, training, telemetry,
                                       os.path.join(tmp, "skip.jsonl"), dev)
    skips = [e for e in skip_ev if e["kind"] == "scale"
             and e["event"] == "skip"]
    check(flags == [i == 5 for i in range(8)]
          and [e["step"] for e in skips] == [5]
          and "scale_collapse" not in health["by_rule"],
          f"lm telemetry: an inf at step 5 of 8 (K 4, dynamic scale): "
          f"overflow flags {flags}, skip events at {[e['step'] for e in skips]}"
          f", watchdog {health} (nonfinite: the skipped step's loss is "
          f"inf, as in JAX)")
    return dict(step_ms_without=ms[0], step_ms_with=ms[1],
                step_ms_without_again=ms[2], ratio=ratio,
                step_ms_all_without=[x * 1e3 for x in plain["step_s"]],
                step_ms_all_with=[x * 1e3 for x in rec_res["step_s"]],
                events=len(ev), launches=rec_l,
                window_host_ms=[e["dur"] * 1e3 for e in ev
                                if e["kind"] == "window"],
                skip_steps=[e["step"] for e in skips],
                skip_health=health, timeline=tl)


def _traced_serve(model, engine_mod, prompts, dev, telemetry, path,
                  sample_n, slo):
    """Phase 5's captured engine over ``prompts`` under a recorder (None:
    none; ``sample_n`` its tracer, ``slo`` its SLO, with the exporter's
    endpoint on a free localhost port): the results, the engine's stats,
    TPOT p50/p99 ms, tokens/s and, with a recorder, the ``GET /metrics``
    body taken after serving."""
    rec = None
    if path is not None:
        rec = telemetry.start(path, watchdog=True, trace_sample_n=sample_n,
                              slo=slo, export_port=0 if slo else None,
                              example="serving")
    body = None
    try:
        eng = engine_mod.ServingEngine(model, buckets=(256, 1024),
                                       page_size=16, max_seqs=8, device=dev)
        eng.warmup()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        warm = eng.stats["captures"]
        t0 = time.perf_counter()
        results = eng.generate(prompts, max_new_tokens=32)
        wall = time.perf_counter() - t0
        st = dict(eng.stats)
        eng.close()
        if rec is not None and rec.exporter is not None:
            import urllib.request
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{rec.exporter.port}/metrics",
                    timeout=30) as r:
                body = r.read().decode()
    finally:
        if rec is not None:
            rec.close()
    tpots = [r.timings["tpot_s"] for r in results if r.ok]
    return results, dict(
        warmup_captures=warm, captures_serving=st["captures"] - warm,
        tokens_per_s=st["tokens_out"] / wall,
        tpot_p50_ms=_pct(tpots, 0.5), tpot_p99_ms=_pct(tpots, 0.99),
        decode_steps=st["decode_steps"]), body


def _event_host_us(telemetry, path, n=4000):
    """Host microseconds of one event through a recorder with the traced
    run's attachments (the watchdog, the SLO, the tracer, the endpoint):
    a ``span`` event by ``Tracer.emit`` (what tracing adds per request
    and decode step) and a ``serving`` ``decode`` event (what the
    recorder adds per decode step)."""
    rec = telemetry.start(path, watchdog=True, trace_sample_n=1,
                          slo=SERVE_SLO, export_port=0, example="cost")
    try:
        tr = rec.tracer
        t0 = time.perf_counter()
        for i in range(n):
            tr.emit("decode_step", "t0-000000", parent="s000000",
                    dur=0.004, slot=i % 8, bucket=1024, batch_size=8)
        t1 = time.perf_counter()
        for _ in range(n):
            rec.event("serving", phase="decode", active=8, bucket=1024,
                      dur=0.004)
        t2 = time.perf_counter()
    finally:
        rec.close()
    return (t1 - t0) / n * 1e6, (t2 - t1) / n * 1e6


def serving_telemetry(model, engine_mod, dev, phase5_tokens, tmp):
    """Phase 30: phase 5's GPT-2 small bf16 engine and 16 requests three
    ways: no recorder, a recorder without tracing, and a recorder with
    every request traced, the SLO folded and the exporter's endpoint on a
    free localhost port.  The traced run's tokens bit for bit phase 5's,
    16 ``done`` events and 16 complete span trees, the requests reader's
    TTFT and TPOT equal to each ``ServedResult.timings``, ``GET
    /metrics`` with ``serving_tokens_per_s`` and ``slo_goodput_pct``, no
    capture while serving; TPOT p50/p99 and tokens/s of the three."""
    telemetry = importlib.import_module("apex_tpu_torch.telemetry")
    trequests = importlib.import_module("apex_tpu_torch.prof.requests")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, model.vocab_size, (int(n),))
               for n in rng.randint(32, 901, 16)]
    saved = {k: os.environ.pop(k) for k in TELEMETRY_ENV if k in os.environ}
    runs = {}
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    fa.flash_fwd_kernel.launches = 0
    zero_routes(fa)
    try:
        for tag, path, n, slo in (
                ("none", None, 0, None),
                ("recorder", os.path.join(tmp, "serve_rec.jsonl"), 0, None),
                ("traced", os.path.join(tmp, "serve.jsonl"), 1, SERVE_SLO),
                ("none_again", None, 0, None)):
            runs[tag] = _traced_serve(model, engine_mod, prompts, dev,
                                      telemetry, path, n, slo)
    finally:
        os.environ.update(saved)
    flash_routes = route_gate(fa, "serving telemetry (4 runs)",
                              fa.flash_fwd_kernel.launches, decode=True)
    results, res, body = runs["traced"]
    same = sum(np.array_equal(r.tokens, t)
               for r, t in zip(results, phase5_tokens))
    check(same == 16 and all(r.ok for r in results),
          f"serving telemetry: traced tokens equal phase 5's in {same}/16 "
          f"requests")
    ev = _stream(os.path.join(tmp, "serve.jsonl"))
    dones = [e for e in ev if e["kind"] == "serving"
             and e["phase"] == "done"]
    falls = trequests.build_waterfalls(ev)
    complete = 0
    for w in falls:
        names = [s["name"] for s in w["spans"]]
        roots = [s for s in w["spans"] if s["name"] == "request"]
        done = [d for d in dones if d.get("trace") == w["trace"]]
        complete += (len(roots) == 1 and roots[0]["parent"] is None
                     and names.count("queue") == names.count("prefill") == 1
                     and len(done) == 1
                     and w["decode_steps"] == done[0]["n_tokens"] - 1
                     and all(s["parent"] == roots[0]["span"]
                             for s in w["spans"] if s is not roots[0]))
    check(len(dones) == 16 and len(falls) == 16 and complete == 16,
          f"serving telemetry: {len(dones)} done events, {complete}/"
          f"{len(falls)} complete span trees (a request root with queue, "
          f"prefill and one decode_step a decode step it was in)")
    from_stream = sorted((d["ttft_s"], d["tpot_s"]) for d in
                         trequests._dones(trequests.load_request_events(
                             [os.path.join(tmp, "serve.jsonl")])))
    from_results = sorted((r.timings["ttft_s"], r.timings["tpot_s"])
                          for r in results)
    check(from_stream == from_results,
          "serving telemetry: prof.requests' TTFT and TPOT per request "
          "equal the engine's ServedResult.timings")
    have = {m: body is not None and f"apex_tpu_{m} " in body
            for m in ("serving_tokens_per_s", "slo_goodput_pct")}
    retr = [e for e in ev if e["kind"] == "retrace"]
    check(all(have.values()) and res["captures_serving"] == 0
          and len(retr) == res["warmup_captures"] == 4
          and all(e["first"] for e in retr),
          f"serving telemetry: GET /metrics holds {have}; "
          f"{res['warmup_captures']} captures at warmup as retrace events "
          f"({len(retr)}), {res['captures_serving']} while serving")
    req = trequests.analyze(ev, slo=SERVE_SLO)
    out = {tag: r[1] for tag, r in runs.items()}
    out["flash_routes"] = flash_routes
    out["slo"] = req.get("slo")
    out["slo_online"] = req.get("slo_online")
    out["events"] = len(ev)
    out["span_event_us"], out["decode_event_us"] = _event_host_us(
        importlib.import_module("apex_tpu_torch.telemetry"),
        os.path.join(tmp, "cost.jsonl"))
    base = 0.5 * (out["none"]["tpot_p50_ms"] + out["none_again"]["tpot_p50_ms"])
    for tag in ("none", "recorder", "traced", "none_again"):
        out[tag]["tpot_p50_over_none"] = out[tag]["tpot_p50_ms"] / base
    print("      serving telemetry (16 requests, 32 new tokens; ratios "
          "against the mean of the two runs without): "
          + "; ".join(f"{tag} TPOT p50 {out[tag]['tpot_p50_ms']:.3f} "
                      f"(x{out[tag]['tpot_p50_over_none']:.4f})"
                      f" / p99 {out[tag]['tpot_p99_ms']:.3f} ms, "
                      f"{out[tag]['tokens_per_s']:.1f} tok/s"
                      for tag in ("none", "recorder", "traced",
                                  "none_again"))
          + f"; SLO {SERVE_SLO}: goodput "
          f"{(req.get('slo') or {}).get('goodput_pct')}%; host us an event "
          f"(watchdog, SLO, tracer, endpoint attached): span "
          f"{out['span_event_us']:.2f}, decode {out['decode_event_us']:.2f}",
          flush=True)
    return out


# -- phase 31: the profiling stages -------------------------------------------

def _on_cpu(tree):
    """The same tree's tensors as uninitialized CPU tensors of the same
    shapes, strides and dtypes: what the analytic walk reads."""
    return torch.utils._pytree.tree_map(
        lambda t: torch.empty_strided(t.shape, t.stride(), dtype=t.dtype)
        if isinstance(t, torch.Tensor) else t, tree)


def lm_hand_flops(b=8, t=1023, layers=12, d=768, heads=12, vocab=50257):
    """The hand count of a GPT-2 small training step: 3 x (2 x the
    dense and tied-head weights + 2 x 2 x head width x heads x layers x
    the causal pairs' mean keys) x tokens (forward and the two backward
    products of every product)."""
    dense = layers * (4 * d * d + 2 * d * 4 * d) + vocab * d
    attn = 4 * (d // heads) * heads * layers * (t + 1) / 2
    return 3.0 * (2 * dense + attn) * b * t


def model_flops(records):
    """The products' FLOPs the model needs, from the walk's records: the
    kernels' formulas count the work the flash backward does, which
    recomputes the scores and their gradient's product (dQ 3 and dK/dV
    4 products a visible pair and head, where the model's backward
    needs 4 in all); here the backward's attention products are twice
    the forward's, as for every other product."""
    ledger = importlib.import_module("apex_tpu_torch.prof.ledger")
    total = fwd = bwd = 0.0
    for r in records:
        if r.op not in ledger.COMPUTE_OPS:
            continue
        total += r.flops * r.count
        if r.op == "flash_attention_fwd":
            fwd += r.flops * r.count
        elif r.op.startswith("flash_attention_bwd"):
            bwd += r.flops * r.count
    return total - bwd + 2 * fwd


def _prof_step(name, build, step_ms, kinds, counters, tmp,
               cross_check=True):
    """One training step through the profiling stages: the analytic
    harvest on fake CUDA and fake CPU tensors (equal), two eager steps
    traced and parsed (per-kind device ms equal to ``trace_steps``'s,
    launches equal to the counters, ``<unattributed>`` under 5%), the
    MFU ledger at the captured K 8 step, and the allocator's memory
    ledger of one real step held to its own history and to the walk."""
    analysis = importlib.import_module("apex_tpu_torch.prof.analysis")
    roofline = importlib.import_module("apex_tpu_torch.prof.roofline")
    memory = importlib.import_module("apex_tpu_torch.prof.memory")
    parse = kind_tables()
    state, step_fn, batch = build()
    t0 = time.perf_counter()
    walked = analysis.profile_function(step_fn, state, batch,
                                       xla_cost=cross_check)
    harvest = roofline.harvest_costs(step_fn, state, batch, prof=walked)
    harvest_s = time.perf_counter() - t0
    on_cpu = roofline.harvest_costs(step_fn, _on_cpu(state), _on_cpu(batch),
                                    xla=False)
    check((on_cpu.flops, on_cpu.bytes, on_cpu.matmul_flops)
          == (harvest.flops, harvest.bytes, harvest.matmul_flops),
          f"prof {name}: the harvest counts {harvest.flops:.6g} FLOPs, "
          f"{harvest.bytes:.6g} bytes on fake CUDA tensors and "
          f"{on_cpu.flops:.6g}, {on_cpu.bytes:.6g} on fake CPU ones")
    logdir = os.path.join(tmp, f"trace_{name}")
    traced = trace_steps(state, step_fn, batch, kinds, logdir=logdir,
                         counters=counters)
    tp = parse.parse_trace(logdir, kinds=kinds)
    parsed = {k: v["total_us"] / 2e3 for k, v in tp.by_category().items()}
    want = traced["device_ms_per_step_by_kind"]
    worst = max((abs(parsed.get(k, 0.0) - v) / v for k, v in want.items()
                 if v > 0), default=0.0)
    check(set(parsed) == set(want) and worst < 1e-3,
          f"prof {name}: per-kind device ms parsed from the trace equal "
          f"trace_steps' within 0.1% (worst {worst:.2e}; parsed {parsed})")
    launched = {k: v for k, v in traced["launches"].items() if v}
    check(tp.launches() == launched,
          f"prof {name}: launches parsed {tp.launches()} = the counters "
          f"{launched} over the two traced steps")
    regions = tp.by_region()
    unattributed = regions.get("<unattributed>", 0.0) / max(tp.total_us,
                                                            1e-9)
    check(unattributed < 0.05,
          f"prof {name}: <unattributed> holds {unattributed:.4f} of the "
          f"eager step's kernel time (< 0.05)")
    peaks = roofline.load_peaks()
    ledger = roofline.mfu_ledger(harvest, step_time_s=step_ms / 1e3,
                                 peaks=peaks, top=8)
    # the same walk by the blocks' submodules (depth 2: block_i/attention,
    # block_i/ln1, ...): the regions phase 32's tuner reads
    ledger_blocks = roofline.mfu_ledger(
        roofline.harvest_costs(step_fn, state, batch, prof=walked,
                               region_depth=2),
        step_time_s=step_ms / 1e3, peaks=peaks)
    # MFU counts the model's products; HFU the kernels' formulas (the
    # ledger's "mfu", as JAX's), the flash backward's recompute included
    flops_model = model_flops(walked.records)
    mfu = flops_model / (step_ms / 1e3) / peaks["flops"]
    hfu = harvest.matmul_flops / (step_ms / 1e3) / peaks["flops"]
    check(0.0 < mfu <= hfu < 1.0, f"prof {name}: MFU of the captured K 8 "
          f"step ({step_ms:.2f} ms) {mfu:.4f} in (0, 1), at most its HFU "
          f"{hfu:.4f}")
    mem_state, mem_step, mem_batch = build()
    # what the process holds besides the call (earlier phases' tensors)
    # is in the allocator's totals, not in the walk: the three are
    # compared on the bytes the call adds above its start
    requested_before = torch.cuda.memory_stats().get(
        "requested_bytes.all.current")
    mem = memory.harvest_memory(mem_step, mem_state, mem_batch, xla=True)
    requested = torch.cuda.memory_stats().get("requested_bytes.all.peak")
    check(mem.source == "allocator"
          and mem.requested_peak_bytes == requested,
          f"prof {name}: the call's allocator history replayed peaks at "
          f"{mem.requested_peak_bytes} requested bytes = the allocator's "
          f"requested-bytes peak {requested}")
    added = mem.requested_peak_bytes - requested_before
    rounding = (mem.peak_bytes - mem.argument_bytes) / max(added, 1) - 1
    check(abs(rounding) < 0.02,
          f"prof {name}: harvest_memory's peak {mem.peak_bytes} "
          f"(max_memory_allocated) adds {rounding:+.4%} to the history's "
          f"{added} bytes above the call's start (the allocator's blocks "
          f"round requests up; < 2%)")
    walk_added = mem.walk_peak_bytes - mem.by_region.get("<arguments>", 0)
    walk_rel = walk_added / max(added, 1) - 1
    check(abs(walk_rel) < 0.05,
          f"prof {name}: the walk's peak adds {walk_added} bytes to the "
          f"call's arguments, within 5% of the history's ({walk_rel:+.4%})")
    del mem_state, mem_step, mem_batch
    measured = {r: us / 2e3 for r, us in sorted(
        regions.items(), key=lambda kv: -kv[1])[:8]}
    res = dict(harvest_s=harvest_s, flops=harvest.flops,
               bytes=harvest.bytes, matmul_flops=harvest.matmul_flops,
               flop_counter_flops=harvest.counter_flops,
               coverage_pct=harvest.coverage_pct, step_ms_k8=step_ms,
               model_flops=flops_model, mfu=mfu, hfu=hfu, ledger=ledger,
               ledger_blocks=ledger_blocks,
               unattributed_share=unattributed,
               measured_ms_by_region=measured, parsed_ms_by_kind=parsed,
               parse_worst_rel=worst, launches=tp.launches(),
               memory=dict(peak_bytes=mem.peak_bytes,
                           requested_peak_bytes=mem.requested_peak_bytes,
                           walk_peak_bytes=mem.walk_peak_bytes,
                           requested_before_bytes=requested_before,
                           walk_over_history=walk_rel,
                           allocator_over_history=rounding,
                           argument_bytes=mem.argument_bytes,
                           output_bytes=mem.output_bytes,
                           temp_bytes=mem.temp_bytes,
                           by_region=dict(sorted(
                               mem.by_region.items(),
                               key=lambda kv: -kv[1])[:6])))
    print(f"      prof {name}: {harvest.matmul_flops / 1e12:.4f} TFLOP of "
          f"products ({harvest.flops / 1e12:.4f} all, "
          f"{harvest.bytes / 1e9:.2f} GB; FlopCounterMode "
          f"{(harvest.counter_flops or 0) / 1e12:.4f}) in "
          f"{harvest_s:.1f} s; at K 8 {step_ms:.2f} ms MFU {mfu:.4f} "
          f"({flops_model / 1e12:.4f} TFLOP of the model's products), HFU "
          f"{hfu:.4f} ({peaks['source']}); peak memory "
          f"{mem.peak_bytes / 2**30:.3f} GiB (requested "
          f"{mem.requested_peak_bytes / 2**30:.3f}, walk "
          f"{mem.walk_peak_bytes / 2**30:.3f})", flush=True)
    print("      " + roofline.format_ledger(ledger).replace("\n", "\n      "),
          flush=True)
    print("      measured ms by region (eager step): " + ", ".join(
        f"{k} {v:.3f}" for k, v in measured.items()), flush=True)
    return res


def _decode_host_untraced(eng, prompts):
    """The load once more with no profiler: the engine's host ms a decode
    step, and the host ms of the decode graph's call (its inputs copied
    in and the replay, ``cache.Captured.__call__``; the graph called
    most)."""
    cache = importlib.import_module("apex_tpu_torch.cache")
    calls, call = {}, cache.Captured.__call__

    def timed(self, *args):
        t0 = time.perf_counter()
        out = call(self, *args)
        calls.setdefault(id(self), []).append(time.perf_counter() - t0)
        return out
    s0, n0 = eng.stats["decode_s"], eng.stats["decode_steps"]
    cache.Captured.__call__ = timed
    try:
        eng.generate(prompts, max_new_tokens=32)
    finally:
        cache.Captured.__call__ = call
    steps = eng.stats["decode_steps"] - n0
    decode = max(calls.values(), key=len)
    return dict(steps=steps,
                step_ms=(eng.stats["decode_s"] - s0) / max(steps, 1) * 1e3,
                replay_call_ms=float(np.mean(decode)) * 1e3,
                replay_calls=len(decode))


def prof_stages(main_amp, imagenet, models, engine_mod, counters, windows,
                dev, tmp):
    """Phase 31: the profiling stages over GPT-2 small and ResNet-50
    training, the capture counts of a serving engine and a trainer's
    pipeline, and the host time of a captured decode step."""
    prof = importlib.import_module("apex_tpu_torch.prof")
    runtime = importlib.import_module("apex_tpu_torch.runtime")
    parse = kind_tables()
    out = {}
    out["lm"] = _prof_step(
        "gpt2_small O2", lambda: main_amp.build(main_amp.parse(TRAIN_ARGS)),
        windows["lm_o2"]["k8"]["step_ms"], parse.TRAINING_KINDS, counters,
        tmp)
    hand = lm_hand_flops()
    rel = out["lm"]["model_flops"] / hand - 1
    check(abs(rel) < 0.10, f"prof gpt2_small O2: "
          f"{out['lm']['model_flops']:.5g} FLOPs of the model's products "
          f"within 10% of the hand count {hand:.5g} ({rel:+.4f}; the "
          f"kernels' formulas {out['lm']['matmul_flops']:.5g})")
    out["lm"]["hand_flops"] = hand
    out["resnet50"] = _prof_step(
        "resnet50 O2", lambda: imagenet.build(imagenet.parse(IMAGENET_ARGS)),
        windows["resnet50_o2"]["k8"]["step_ms"], parse.RESNET_KINDS,
        counters, tmp, cross_check=False)
    gc.collect()
    torch.cuda.empty_cache()
    # one hot capture for a trainer's pipeline, none after
    state, step_fn, batch = main_amp.build(main_amp.parse(TRAIN_ARGS))
    pipe = runtime.StepPipeline(step_fn, 1)
    window = tuple(t.unsqueeze(0) for t in batch)
    try:
        with prof.assert_trace_count(pipe, 1):
            pipe.warmup(state, window)
            state, _ = pipe.step_window(state, window)
        with prof.assert_trace_count(pipe, 0):
            pipe.step_window(state, window)
        check(True, "prof: the LM pipeline captured once, then replayed "
              "with no capture (assert_trace_count)")
    except AssertionError as e:
        check(False, f"prof: trainer pipeline capture count: {e}")
    del pipe, state, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    # phase 5's engine: 4 captures at warmup, none while serving; its
    # traced decode steps' host time split
    model = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0)
    eng = engine_mod.ServingEngine(model, buckets=(256, 1024), page_size=16,
                                   max_seqs=8, device=dev)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, model.vocab_size, (int(n),))
               for n in rng.randint(32, 901, 16)]
    logdir = os.path.join(tmp, "trace_serving")
    try:
        with prof.assert_trace_count(eng, 4):
            eng.warmup()
        with prof.assert_trace_count(eng, 0):
            untraced = _decode_host_untraced(eng, prompts)
            with prof.trace(logdir):
                t0 = time.perf_counter()
                results = eng.generate(prompts, max_new_tokens=32)
                wall = time.perf_counter() - t0
        check(all(r.ok for r in results),
              "prof: the engine captured 4 graphs at warmup and none while "
              "serving (assert_trace_count)")
    except AssertionError as e:
        check(False, f"prof: serving capture count: {e}")
        wall, untraced = None, None
    eng.close()
    del eng, model
    out["serving_decode_untraced"] = untraced
    if untraced:
        print(f"      prof decode, untraced: host {untraced['step_ms']:.3f} "
              f"ms a step, of which the graph's call (inputs copied in, "
              f"replay) {untraced['replay_call_ms']:.3f} ms, over "
              f"{untraced['steps']} steps", flush=True)
    split = parse.range_host_time(logdir, "decode[")
    tp = parse.parse_trace(logdir, kinds=parse.SERVING_KINDS)
    for name, row in split.items():
        dev_ms = tp.steps().get(name, 0.0) / 1e3 / row["count"]
        row["device_ms"] = dev_ms
        top = list(row["by_name"].items())[:6]
        print(f"      prof {name} x{row['count']}: host "
              f"{row['host_us'] / 1e3:.3f} ms = CPU events "
              f"{row['covered_us'] / 1e3:.3f} + gaps "
              f"{row['gaps_us'] / 1e3:.3f}; device {dev_ms:.3f} ms; "
              + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in top),
              flush=True)
        row["by_name"] = dict(top)
    out["serving_decode_host"] = split
    out["serving_traced_wall_s"] = wall
    check(bool(split), "prof: the traced serving run's decode ranges split")
    return out


# -- phase 32: the tuner ------------------------------------------------------

#: the tune cache phases 1-31 run with: a path in an empty directory, so
#: every kernel runs its rule's tile whatever the host's cache holds
EMPTY_TUNE_CACHE = os.path.join(tempfile.gettempdir(),
                                f"chip_smoke_no_tune_{os.getpid()}",
                                "tune_configs.json")

TUNE_FAMILIES = ("flash_attention", "conv2d", "fused_layer_norm",
                 "bn_relu_residual", "xentropy", "quantized_matmul")
#: phase 32's measurement budget a family (the tuner's max_candidates):
#: every flash, conv and qmm tile at its example shape; the Triton
#: families' candidates past it are launched once untimed (below)
TUNE_MAX_CANDIDATES = 6


def _use_tune_cache(path):
    """Point the tune store at ``path`` and drop the consults' memo and
    counts."""
    os.environ["APEX_TPU_TUNE_CACHE"] = path
    importlib.import_module("apex_tpu_torch.tune.store").load(reload=True)
    importlib.import_module("apex_tpu_torch.tune.dispatch").reset_stats()


def _untimed_candidates(spec, shape, res):
    """The legal candidates of ``spec`` at ``shape`` that its tuning
    ``res`` did not time (``max_candidates`` truncated them), each
    launched once on the card: its outputs against the rule's by the
    tuner's oracle (bit for bit for an exact family).  A launch that
    raises fails the phase.  Returns ``(launched, failing configs)``."""
    measure = importlib.import_module("apex_tpu_torch.tune.measure")
    default = spec.defaults(shape)
    legal = [c for c in measure._dedupe(
        spec, shape, [default] + list(spec.candidates(shape, res.bound)))
        if c == default or spec.constraint(shape, c)]
    rest = [c for c in legal if c not in res.order]
    if not rest:
        return 0, []
    case = spec.build(shape, False)
    ref = case.run(default)
    bad = []
    for cfg in rest:
        out = case.run(cfg)
        torch.cuda.synchronize()
        if not measure._oracle_ok(spec, case, ref, out):
            bad.append(cfg)
        del out
    del case, ref
    gc.collect()
    torch.cuda.empty_cache()
    return len(rest), bad


@contextlib.contextmanager
def _plain_kernels(families):
    """Within it, the tile-taking kernels of ``families`` (flash's
    forward, xentropy's forward and backward) run their plain versions
    on the card: the reference of :func:`_tuned_vs_plain`."""
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    xe = importlib.import_module("apex_tpu_torch.contrib.xentropy")
    swaps = {
        "flash_attention": [(fa, "flash_fwd_kernel",
                             lambda q, k, v, kb, b, tile=None, **kw:
                             fa._flash_fwd_ref(q, k, v, kb, b, **kw))],
        "xentropy": [(xe, "xentropy_fwd_kernel",
                      lambda lg, lb, sm, config=None:
                      xe._fwd_ref(lg, lb, sm)),
                     (xe, "xentropy_bwd_kernel",
                      lambda g, lg, mlse, lb, sm, config=None:
                      xe._bwd_ref(g, lg, mlse, lb, sm))]}
    undo = []
    try:
        for fam in families:
            for mod, name, plain in swaps[fam]:
                undo.append((mod, name, getattr(mod, name)))
                setattr(mod, name, plain)
        yield
    finally:
        for mod, name, fn in reversed(undo):
            setattr(mod, name, fn)


def _tuned_vs_plain(label, run, families, tuned_path):
    """The gate of a path whose consulted tuned configs are not exact
    (``families``): ``run()`` (a list of tensors: a loss and every
    gradient, or logits) with the tuned cache, with the rule's tiles (an
    empty cache), and with the rule where those families' kernels run
    their plain versions.  The tuned outputs may be no further from the
    plain ones than twice the rule's own distance (the largest relative
    L2 error of an output, ||tuned - plain|| / ||plain||), and the tuned
    run must hit each of those families."""
    dispatch = importlib.import_module("apex_tpu_torch.tune.dispatch")
    outs = {}
    for key, path, plain in (("tuned", tuned_path, ()),
                             ("rule", EMPTY_TUNE_CACHE, ()),
                             ("plain", EMPTY_TUNE_CACHE, families)):
        _use_tune_cache(path)
        with _plain_kernels(plain):
            outs[key] = [t.detach().float() for t in run()]
        if key == "tuned":
            by = dispatch.dispatch_stats()["by_kernel"]
            hits = {f: by.get(f, {}).get("hits", 0) for f in families}
    _use_tune_cache(tuned_path)

    def dist(a, b):
        return max((x - y).norm().item() / max(y.norm().item(), 1e-30)
                   for x, y in zip(a, b))
    d_tuned = dist(outs["tuned"], outs["plain"])
    d_rule = dist(outs["rule"], outs["plain"])
    check(all(hits.values()) and d_tuned <= 2 * d_rule,
          f"tune: {label} with {families} tuned (not exact), hits {hits}: "
          f"tuned vs their plain versions {d_tuned:.3g} <= 2 x the rule's "
          f"{d_rule:.3g} (the largest relative L2 error of "
          f"{len(outs['plain'])} outputs)")
    return dict(tuned_vs_plain=d_tuned, rule_vs_plain=d_rule, hits=hits)


def _tune_public_calls(dev):
    """Each family's public function at its example shape (the tuner's
    registry) with its tile left to the consult: ``name -> (call, plain,
    gate)``, ``gate(got, want) -> (max_abs_err, ok)`` the kernel table
    phase's tolerance (3: LN 2e-2; 4: flash 2e-2; 11: BN one bf16 ulp;
    12: xentropy 1e-4; 15: conv one bf16 ulp of the largest value, 99.9%
    within one ulp; 16: qmm bit for bit)."""
    fln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    fba = importlib.import_module("apex_tpu_torch.normalization.fused_bn_act")
    xent = importlib.import_module("apex_tpu_torch.contrib.xentropy")
    cv = importlib.import_module("apex_tpu_torch.ops.conv")
    qk = importlib.import_module("apex_tpu_torch.quant.kernels")
    reg = importlib.import_module("apex_tpu_torch.tune.registry")
    ex = {s.name: s.example_shape for s in reg.all_specs()}
    g = torch.Generator().manual_seed(32)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def within(tol):
        return lambda got, want: (max_err(got, want),
                                  max_err(got, want) <= tol)

    def ulp(got, want):
        err, _, ok = _kernel_err(got, want)
        return err, ok

    def conv_gate(got, want):
        err, _, ok = _conv_err(got, want)
        return err, ok

    calls = {}
    sh = ex["fused_layer_norm"]
    x = rnd(sh["n1"], sh["n2"])
    w, b = rnd(sh["n2"], dtype=torch.float32), rnd(sh["n2"],
                                                   dtype=torch.float32)
    calls["fused_layer_norm"] = (
        lambda: fln.fused_layer_norm(x, (x.shape[1],), w, b),
        lambda: fln._fwd_ref(x, w, b, 1e-5)[0], within(2e-2))
    sh = ex["flash_attention"]
    q, k, v = (rnd(sh["batch"], sh["q_len"], sh["heads"], sh["head_dim"],
                   scale=0.5) for _ in range(3))
    calls["flash_attention"] = (
        lambda: fa.flash_attention(q, k, v, causal=True),
        lambda: fa._flash_fwd_ref(q, k, v, None, None, sm_scale=0.125,
                                  causal=True)[0], within(2e-2))
    sh = ex["bn_relu_residual"]
    xb, zb = (rnd(sh["rows"], sh["channels"]) for _ in range(2))
    vb = [rnd(sh["channels"], dtype=torch.float32, scale=0.1) + off
          for off in (0.0, 1.0, 1.0, 0.0)]
    calls["bn_relu_residual"] = (
        lambda: fba.bn_relu_residual(xb, *vb, z=zb),
        lambda: fba.bn_act_epilogue_ref(xb, *vb, z=zb, relu=True), ulp)
    sh = ex["xentropy"]
    logits = rnd(sh["rows"], sh["vocab"], dtype=torch.float32, scale=2.0)
    labels = torch.randint(1, sh["vocab"], (sh["rows"],), generator=g).to(dev)
    calls["xentropy"] = (
        lambda: xent.softmax_cross_entropy_loss(logits, labels, 0.1),
        lambda: xent._fwd_ref(logits, labels.int(), 0.1)[0], within(1e-4))
    sh = ex["conv2d"]
    xc = rnd(sh["batch"], sh["h"], sh["w"], sh["cin"])
    wc = rnd(sh["kh"], sh["kw"], sh["cin"], sh["cout"], scale=0.05)
    calls["conv2d"] = (lambda: cv.conv2d(xc, wc),
                       lambda: cv.conv2d_ref(xc, wc), conv_gate)
    sh = ex["quantized_matmul"]
    xq, wq = rnd(sh["m"], sh["k"], scale=0.05), rnd(sh["k"], sh["n"],
                                                     scale=0.05)
    xs = 0.25 / 127.0
    calls["quantized_matmul"] = (
        lambda: qk.quantized_matmul(xq, wq, x_scale=xs),
        lambda: qk.quantized_matmul_ref(xq, wq, x_scale=xs),
        lambda got, want: (max_err(got, want), torch.equal(got, want)))
    return calls


def _tuned_hits_gate(name, dispatch, results):
    """The families a run consulted; every one whose tuned bucket it
    consulted hit the cache.  Returns the families whose consulted
    config is not the rule's and not exact (the run is then not bit for
    bit the untuned one)."""
    reg = importlib.import_module("apex_tpu_torch.tune.registry")
    tuned = {(r.kernel, r.bucket): r for r in results.values()}
    seen = {tuple(kb) for kb in dispatch.dispatch_stats()["consulted"]}
    hit = {kb: tuned[kb] for kb in seen if kb in tuned}
    by = dispatch.dispatch_stats()["by_kernel"]
    fams = sorted({k for k, _ in hit})
    check(bool(hit) and all(by[k]["hits"] >= 1 for k in fams),
          f"tune: {name} consulted {sorted({k for k, _ in seen})}; the "
          f"tuned buckets {sorted(b for _, b in hit)} hit "
          f"{ {k: by[k]['hits'] for k in fams} }")
    return sorted({k for (k, _), r in hit.items()
                   if r.config != r.default_config
                   and not reg.get_spec(k).exact})


def _lm_loss_and_grads(models, main_amp, dev):
    """gpt2_small bf16 at the LM trainer's B 8, T 1023: the fused loss
    and every parameter's gradient, one forward and backward (the
    tuned flash and xentropy buckets of the trainer)."""
    def run():
        m = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0)
        x, y = main_amp.synthetic_batch(8, 1024, 50257, dev)
        params = list(m.parameters())
        loss = main_amp.lm_loss(m(x), y, 0.1, fused=True)
        grads = torch.autograd.grad(loss, params)
        return [loss, torch.cat([g.float().flatten() for g in grads])]
    return run


def _image_loss_and_grad(imagenet, dev):
    """ResNet-50's loss at B 128 (its xentropy bucket): the fused loss of
    seeded fp32 logits and its gradient."""
    def run():
        g = torch.Generator().manual_seed(13)
        logits = (torch.randn(128, 1000, generator=g) * 3).to(dev)
        labels = torch.randint(0, 1000, (128,), generator=g).to(dev)
        logits.requires_grad_(True)
        loss = imagenet.image_loss(logits, labels)
        return [loss, torch.autograd.grad(loss, logits)[0]]
    return run


def _o4_logits(model, dev):
    """The O4 model's logits of a 1000-token prefill into a 1024-key
    cache and of the next decode step (the serving path's attention)."""
    from apex_tpu_torch.models import init_cache

    def run():
        ids = torch.from_numpy(np.random.RandomState(5).randint(
            1, model.vocab_size, (1, 1000))).to(dev)
        with torch.inference_mode():
            caches = init_cache(model, 1, cache_len=1024)
            pre, caches = model(ids, kv_caches=caches, positions=torch.zeros(
                (1,), dtype=torch.long, device=dev))
            dec, _ = model(pre[:, -1:].argmax(-1), kv_caches=caches,
                           positions=torch.full((1,), 1000,
                                                dtype=torch.long,
                                                device=dev))
        return [pre, dec]
    return run


def tune_phase(main_amp, imagenet, models, engine_mod, quant, calib,
               counters, dev, ledger, o4_tokens, tmp):
    """Phase 32: the tuner on the card, in a cache of its own.  (1) Each
    family tuned at its example shape (at most ``TUNE_MAX_CANDIDATES``
    timed; the legal candidates past them launched once untimed), and
    flash at width 128 (not stored): best <= default, no candidate
    failing the oracle or refused by the kernels, each winner through
    its public function with the cache consulted within the kernel
    table's tolerance of its plain version; (2) ``tune_from_ledger`` on
    phase 31's GPT-2 small ledger, not stored; (3) the LM (O2, K 8, 16
    steps) and ResNet-50 (O2, K 8, 16 steps) trainers and O4 serving of
    phase 17's load with the tuned cache: a hit for every tuned bucket a
    path consults, phase 20's and 17's launches, the state or tokens bit
    for bit the untuned ones where every consulted config is exact, else
    :func:`_tuned_vs_plain` (also run with non-rule flash and xentropy
    tiles forced, so the gate is exercised whatever wins); step ms beside
    phase 20's untuned ones, and the O4 load served untuned, tuned,
    tuned, untuned for TPOT; (4) the cache rewritten for another device:
    every consult misses and the six calls equal the rule's bit for
    bit."""
    measure = importlib.import_module("apex_tpu_torch.tune.measure")
    reg = importlib.import_module("apex_tpu_torch.tune.registry")
    store = importlib.import_module("apex_tpu_torch.tune.store")
    dispatch = importlib.import_module("apex_tpu_torch.tune.dispatch")
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    cache_dir = os.path.join(tmp, "tune_cache")
    _use_tune_cache(cache_dir)
    out = {"cache": store.cache_path()}
    calls = _tune_public_calls(dev)
    rule = {n: c[0]() for n, c in calls.items()}
    by = dispatch.dispatch_stats()["by_kernel"]
    check(set(by) == set(calls) and all(v["hits"] == 0 for v in by.values()),
          f"tune: with an empty cache the six calls consult and miss "
          f"({ {k: v['misses'] for k, v in by.items()} })")

    # (1) each family at its example shape, the qmm at the O4 server's
    # prefill shape too (its example is the O4 trainer's), and flash at
    # width 128 (6 heads of 128), which no model of the paths runs, so
    # it is not stored
    results = {}
    flash_ex = reg.get_spec("flash_attention").example_shape
    shapes = {"quantized_matmul_prefill": (
        "quantized_matmul", dict(reg.get_spec("quantized_matmul")
                                 .example_shape, m=1024), True),
        "flash_attention_d128": (
            "flash_attention", dict(flash_ex, heads=6, head_dim=128), False)}
    for name in TUNE_FAMILIES + tuple(shapes):
        family, shape, keep = shapes.get(name, (name, None, True))
        spec = reg.get_spec(family)
        t0 = time.perf_counter()
        res = measure.tune_kernel(family, shape, iters=10, reps=3, seed=0,
                                  max_candidates=TUNE_MAX_CANDIDATES,
                                  store_result=keep)
        untimed, bad = _untimed_candidates(
            spec, dict(shape or spec.example_shape), res)
        results[name] = res
        print(f"      tune {name} [{res.bucket}]: default "
              f"{res.default_config} {res.default_ms:.4f} ms, best "
              f"{res.config} {res.best_ms:.4f} ms "
              f"(x{res.tuned_over_default}); {res.candidates} measured, "
              f"{res.rejected_constraint} rejected by constraint, "
              f"{res.rejected_oracle} by the oracle, {res.rejected_kernel} "
              f"refused by the kernels, {res.truncated} truncated and "
              f"launched once untimed ({untimed}, {len(bad)} failing the "
              f"oracle) ({time.perf_counter() - t0:.1f} s)", flush=True)
        check(res.best_ms <= res.default_ms and res.stored == keep
              and res.source == "device" and res.rejected_oracle == 0
              and res.rejected_kernel == 0 and untimed == res.truncated
              and not bad,
              f"tune {name}: best {res.best_ms} ms <= default "
              f"{res.default_ms} ms; every legal candidate launched at "
              f"{res.bucket} passed the oracle ({res.rejected_oracle} "
              f"timed, {bad} untimed failed) and none was refused by the "
              f"kernels ({res.rejected_kernel})")
    out["results"] = {n: {k: getattr(r, k) for k in (
        "bucket", "config", "default_config", "best_ms", "default_ms",
        "candidates", "rejected_constraint", "rejected_oracle",
        "rejected_kernel", "truncated")} for n, r in results.items()}
    # the width-128 rule against the plain version (the oracle above
    # held every other tile to it)
    sh = shapes["flash_attention_d128"][1]
    g = torch.Generator().manual_seed(128)
    q, k, v = ((torch.randn(sh["batch"], sh["q_len"], sh["heads"],
                            sh["head_dim"], generator=g) * 0.5)
               .to(dev, torch.bfloat16) for _ in range(3))
    got = fa.flash_attention(q, k, v, causal=True)
    err = max_err(got, fa._flash_fwd_ref(q, k, v, None, None,
                                         sm_scale=128 ** -0.5,
                                         causal=True)[0])
    check(err <= 2e-2, f"tune: flash at width 128 (B8 T1023 6 heads), "
          f"the rule's tile against its plain version: max_abs_err "
          f"{err:.3g} <= 2e-2")
    del q, k, v, got

    dispatch.reset_stats()
    for name, (call, plain, gate) in calls.items():
        got = call()
        err, ok = gate(got, plain())
        hits = dispatch.dispatch_stats()["by_kernel"][name]["hits"]
        same = torch.equal(got, rule[name])
        default = results[name].config == results[name].default_config
        check(ok and hits == 1 and (same or not default),
              f"tune {name}: the public call with the cache consulted "
              f"({hits} hit, {results[name].config}) max_abs_err "
              f"{err:.3g} against its plain version; "
              + ("the rule's tile: bit for bit the rule's output "
                 f"({same})" if default else
                 f"bit for bit the rule's output: {same}"))
    del calls
    gc.collect()
    torch.cuda.empty_cache()

    # (2) the ledger's verdicts
    verdicts = {s.name: measure.bound_from_ledger(ledger, s)
                for s in reg.all_specs()}
    matched = {s.name: [r["region"] for r in ledger.get("regions", [])
                        if any(f in str(r["region"]).lower()
                               for f in s.regions)]
               for s in reg.all_specs()}
    led = measure.tune_from_ledger(ledger, store_result=False, iters=3,
                                   reps=2, max_candidates=TUNE_MAX_CANDIDATES)
    print(f"      tune from phase 31's GPT-2 small ledger ("
          f"{len(ledger.get('regions', []))} regions): "
          + "; ".join(f"{r.kernel} {verdicts[r.kernel] or 'no region'}"
                      f" -> {r.config} ({len(matched[r.kernel])} regions)"
                      for r in led), flush=True)
    check(not any(r.stored for r in led)
          and all(r.best_ms <= r.default_ms and r.rejected_oracle == 0
                  and r.rejected_kernel == 0 for r in led)
          and any(matched.values()),
          f"tune: tune_from_ledger stored nothing, best <= default and no "
          f"candidate failing the oracle or refused for every family; "
          f"regions matched: { {k: len(v) for k, v in matched.items()} }")
    out["ledger"] = {r.kernel: dict(verdict=verdicts[r.kernel],
                                    regions=matched[r.kernel],
                                    config=r.config) for r in led}

    # (3) the trainers and the server with the tuned cache
    quiet = dict(log=lambda line: None)
    runs = {}
    for key, label, run, per_step, plain_run in (
            ("lm_o2", "lm O2 B8 T1023 K 8", lambda: main_amp.train(
                main_amp.parse(TRAIN_ARGS + ["--steps", "16",
                                             "--steps-per-call", "8"]),
                **quiet), LM_PER_STEP,
             _lm_loss_and_grads(models, main_amp, dev)),
            ("resnet50_o2", "resnet50 O2 B128 K 8", lambda: imagenet.train(
                imagenet.parse(IMAGENET_ARGS + ["--prof", "16",
                                                "--steps-per-call", "8"]),
                **quiet), RESNET_PER_STEP,
             _image_loss_and_grad(imagenet, dev))):
        dispatch.reset_stats()
        res, launches = _counted_run(f"tune: {label}", counters, run,
                                     per_step, 8)
        inexact = _tuned_hits_gate(label, dispatch, results)
        stats = dispatch.dispatch_stats()
        coverage = dispatch.coverage_line()
        losses = res["losses"]
        differ, n, worst, names = _state_diff(_cpu_copy(res["state"]),
                                              UNTUNED[key]["state"])
        step_ms = float(np.median(res["step_s"][8:])) * 1e3
        del res
        gc.collect()
        torch.cuda.empty_cache()
        vs_plain = None
        if inexact:
            check(all(np.isfinite(losses)),
                  f"tune: {label}: losses finite ({losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}); {differ}/{n} leaves differ from "
                  f"the untuned run (max |diff| {worst:.3g})")
            vs_plain = _tuned_vs_plain(label, plain_run, inexact,
                                       cache_dir)
            gc.collect()
            torch.cuda.empty_cache()
        else:
            check(differ == 0, f"tune: {label}: every consulted config "
                  f"exact; the final state equals the untuned run's in "
                  f"{n - differ}/{n} leaves" + (f" (first {names})"
                                                if differ else ""))
        print(f"      tune {label}: step {step_ms:.2f} ms tuned, "
              f"{UNTUNED[key]['step_ms']:.2f} untuned (phase 20); "
              f"{coverage}", flush=True)
        runs[key] = dict(step_ms=step_ms,
                         untuned_step_ms=UNTUNED[key]["step_ms"],
                         inexact=inexact, leaves_differing=differ,
                         vs_plain=vs_plain,
                         launches={k: v for k, v in launches.items() if v},
                         stats=stats)

    # O4 serving of phase 17's load: untuned, tuned, tuned, untuned in
    # one stretch, so the TPOTs compare under one state of the process
    o4_model = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0,
                                 quant=quant.QuantConfig.frozen(calib))
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, o4_model.vocab_size, (int(n),))
               for n in rng.randint(32, 901, 16)]
    cache = importlib.import_module("apex_tpu_torch.cache")
    serves, inexact = [], []
    for tuned in (False, True, True, False):
        _use_tune_cache(cache_dir if tuned else EMPTY_TUNE_CACHE)
        for c in counters.values():
            c.launches = 0
        served, st, res = _serve(o4_model, engine_mod.ServingEngine,
                                 prompts, dev, torch.int8)
        launches = {n: c.launches for n, c in counters.items()}
        forwards = cache.WARM_RUNS * res["warmup_captures"] + res["replays"]
        tag = "tuned" if tuned else "untuned"
        check(all(r.ok and len(r.tokens) == 32 for r in served)
              and all(launches[n] == O4_SERVE_PER_FORWARD.get(n, 0)
                      * forwards for n in launches),
              f"tune: O4 serving ({tag}): {sum(r.ok for r in served)}/16 "
              f"requests served, launches "
              f"{ {n: v for n, v in launches.items() if v} } = "
              f"{O4_SERVE_PER_FORWARD} x {forwards} forwards (phase 17's)")
        if tuned:
            inexact = _tuned_hits_gate("O4 serving", dispatch, results)
        same = sum(np.array_equal(r.tokens, np.asarray(t))
                   for r, t in zip(served, o4_tokens))
        check(same == 16 or (tuned and inexact),
              f"tune: O4 serving ({tag}): "
              + ("every consulted config exact; " if tuned else "")
              + f"tokens equal phase 17's in {same}/16 requests")
        serves.append(dict(tuned=tuned, tokens_equal=same,
                           stats=dispatch.dispatch_stats(),
                           coverage=dispatch.coverage_line(), **{
                               k: res[k] for k in (
                                   "tpot_p50_ms", "tpot_p99_ms",
                                   "ttft_p50_ms", "prefill_ms_mean",
                                   "decode_step_ms_mean", "tokens_per_s")}))
        del served
    vs_plain = None
    if inexact:
        vs_plain = _tuned_vs_plain("O4 serving", _o4_logits(o4_model, dev),
                                   inexact, cache_dir)
    _use_tune_cache(cache_dir)
    tpot = {t: [r["tpot_p50_ms"] for r in serves if r["tuned"] == t]
            for t in (False, True)}
    def each(key):
        return ", ".join(f"{r[key]:.3f}" for r in serves)
    print(f"      tune O4 serving (untuned, tuned, tuned, untuned): tpot "
          f"p50 {each('tpot_p50_ms')} ms; prefill {each('prefill_ms_mean')}"
          f" ms, decode step {each('decode_step_ms_mean')} ms host "
          f"(means); tokens equal phase 17's "
          f"{[r['tokens_equal'] for r in serves]}/16"
          + (f" ({inexact} tuned, not exact)" if inexact else "") + "; "
          + serves[1]["coverage"], flush=True)
    runs["o4_serving"] = dict(serves=serves, inexact=inexact,
                              vs_plain=vs_plain,
                              untuned_tpot_p50_ms=tpot[False],
                              tuned_tpot_p50_ms=tpot[True])
    # the inexact gate above, exercised whatever the winners: flash's
    # 64 x 32 tile (the rule's is 64 x 64) and a 96-key decode chunk, and
    # xentropy's 2048 columns on 4 warps (the rule's 4096 on 8), forced
    # into the LM's and the O4 model's buckets
    xe = importlib.import_module("apex_tpu_torch.contrib.xentropy")
    forced = os.path.join(tmp, "tune_forced", "tune_configs.json")
    for kernel, version, bucket, cfg in (
            ("flash_attention", fa.TUNE_VERSION,
             fa.tune_bucket(1023, 1023, 64, True, False, False),
             {"block_q": 64, "block_k": 32}),
            ("flash_attention", fa.TUNE_VERSION,
             fa.tune_bucket(1000, 1024, 64, False, True, False),
             {"block_q": 64, "block_k": 32}),
            ("flash_attention", fa.TUNE_VERSION,
             fa.tune_bucket(1, 1024, 64, True, False, False),
             {"block_q": 64, "block_k": 96}),
            ("xentropy", xe.TUNE_VERSION, xe.tune_bucket(8184, 50257),
             {"col_block": 2048, "num_warps": 4})):
        store.put(kernel, version, bucket, cfg, path=forced)
    runs["forced_inexact"] = {
        "lm": _tuned_vs_plain("lm (forced tiles)", _lm_loss_and_grads(
            models, main_amp, dev), ["flash_attention", "xentropy"],
            forced),
        "o4": _tuned_vs_plain("O4 (forced tiles)", _o4_logits(o4_model, dev),
                              ["flash_attention"], forced)}
    _use_tune_cache(cache_dir)
    out["runs"] = runs
    del o4_model
    gc.collect()
    torch.cuda.empty_cache()

    # (4) another card's cache: every consult misses
    path = store.cache_path()
    with open(path) as f:
        data = json.load(f)
    other = "NVIDIA_A100-SXM4-80GB"
    data["entries"] = {
        "|".join([other] + key.split("|")[1:]): dict(ent, device_kind=other)
        for key, ent in data["entries"].items()}
    with open(path, "w") as f:
        json.dump(data, f)
    _use_tune_cache(cache_dir)
    calls = _tune_public_calls(dev)
    same = {n: torch.equal(c[0](), rule[n]) for n, c in calls.items()}
    by = dispatch.dispatch_stats()["by_kernel"]
    check(all(same.values()) and set(by) == set(calls)
          and all(v["hits"] == 0 for v in by.values()),
          f"tune: a cache of another device ({other}, "
          f"{len(data['entries'])} entries): every consult misses "
          f"({ {k: v['misses'] for k, v in by.items()} }) and the six calls "
          f"equal the rule's bit for bit ({same})")
    del calls, rule
    _use_tune_cache(EMPTY_TUNE_CACHE)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 33: generate() over the decode cache ------------------------------------

GEN_B, GEN_PROMPT, GEN_NEW = 8, 64, 128


def _top2_margin(logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return float((top[..., 0] - top[..., 1]).min())


def _decode_logits(models, model, tokens, steps):
    """``model``'s decode step teacher-forced through ``tokens`` ``[B,
    steps]``: the logits of each step, ``[steps, B, V]`` on the CPU."""
    gpt = importlib.import_module("apex_tpu_torch.models.gpt")
    out = []
    with gpt._decoding(model), torch.no_grad():
        cache = models.init_decode_cache(model, tokens.shape[0])
        for t in range(steps):
            logits, _ = model(tokens[:, t:t + 1].to(model.device),
                              cache=cache)
            out.append(logits[:, 0].float().cpu())
    return torch.stack(out)


def generate_phase(models, engine_mod, counters, dev):
    """Phase 33: ``generate`` on GPT-2 small at full width (random weights
    from seed 0), B 8, prompts of 64 tokens, 128 new tokens, in fp32 and
    bf16: the captured step (every counter set to 0 just before, read
    just after: 25 LayerNorm launches a forward, the warm run and 191
    replays; no flash launch, the decode attention being plain) equal
    bit for bit to the eager step; fp32 greedy tokens equal to the
    serving engine's for the same prompts and weights (the smallest
    top-2 logit margin printed); the first 4 decode steps' logits
    against a CPU fp32 run (atol 2e-3 fp32, 0.25 bf16); tokens/s."""
    cache = importlib.import_module("apex_tpu_torch.cache")
    rng = np.random.RandomState(33)
    prompts = rng.randint(1, 50257, (GEN_B, GEN_PROMPT))
    cpu = models.gpt2_small(dtype=torch.float32, device="cpu", seed=0)
    want4 = _decode_logits(models, cpu, torch.from_numpy(prompts), 4)
    del cpu
    steps = GEN_PROMPT + GEN_NEW - 1
    out = {}
    for dtype, atol in ((torch.float32, 2e-3), (torch.bfloat16, 0.25)):
        tag = str(dtype).replace("torch.", "")
        model = models.gpt2_small(dtype=dtype, device=dev, seed=0)
        res = {}
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        captured = models.generate(model, model, prompts, GEN_NEW)
        torch.cuda.synchronize()
        res["captured_s"] = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()
                    if c.launches}
        t0 = time.perf_counter()
        eager = models.generate(model, model, prompts, GEN_NEW,
                                capture=False)
        torch.cuda.synchronize()
        res["eager_s"] = time.perf_counter() - t0
        forwards = cache.WARM_RUNS + steps
        check(launches == {"layer_norm_fwd": 25 * forwards},
              f"generate {tag}: launches {launches} = 25 LayerNorm a "
              f"forward x {forwards} (the warm run and {steps} replays)")
        check(tuple(captured.shape) == (GEN_B, GEN_PROMPT + GEN_NEW)
              and torch.equal(captured, eager)
              and torch.equal(captured[:, :GEN_PROMPT].cpu(),
                              torch.from_numpy(prompts)),
              f"generate {tag}: captured tokens {tuple(captured.shape)} "
              f"equal the eager step's bit for bit, the prompt kept")
        # every step's logits for fp32's top-2 margins; bf16's first 4
        got = _decode_logits(models, model, captured,
                             steps if dtype == torch.float32 else 4)
        err = (got[:4] - want4).abs().max().item()
        check(err <= atol, f"generate {tag}: the first 4 decode steps' "
              f"logits vs a CPU fp32 run: max abs err {err:.3g} "
              f"(atol {atol})")
        res.update(tokens_per_s_captured=GEN_B * GEN_NEW
                   / res["captured_s"],
                   tokens_per_s_eager=GEN_B * GEN_NEW / res["eager_s"],
                   cpu_logits_max_abs_err=err, launches=launches)
        if dtype == torch.float32:
            res["min_top2_margin"] = _top2_margin(got[GEN_PROMPT - 1:])
            eng = engine_mod.ServingEngine(model, buckets=(256,),
                                           page_size=16, max_seqs=GEN_B,
                                           device=dev)
            eng.warmup()
            served = eng.generate(list(prompts), max_new_tokens=GEN_NEW)
            eng.close()
            same = sum(r.ok and np.array_equal(
                np.asarray(r.tokens), captured[i, GEN_PROMPT:].cpu().numpy())
                for i, r in enumerate(served))
            first = [next((j for j, (a, b) in enumerate(zip(
                np.asarray(r.tokens), captured[i, GEN_PROMPT:].tolist()))
                if a != b), None) for i, r in enumerate(served)]
            check(same == GEN_B,
                  f"generate fp32: greedy tokens equal the serving "
                  f"engine's in {same}/{GEN_B} requests x {GEN_NEW} tokens "
                  f"(first differing position a request {first}); "
                  f"smallest top-2 logit margin {res['min_top2_margin']:.4g}")
            res["engine_equal"] = same
        print(f"      generate {tag}: {GEN_B} x {GEN_NEW} tokens, captured "
              f"{res['tokens_per_s_captured']:.1f} tok/s "
              f"({res['captured_s']:.3f} s with the capture), eager "
              f"{res['tokens_per_s_eager']:.1f} tok/s; CPU logits err "
              f"{err:.3g}", flush=True)
        out[tag] = res
        del model
    return out


# -- phase 34: the RNN stack and weight norm ------------------------------------------

def _rel(a, b):
    return ((a.float().cpu() - b.float().cpu()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _rnn_fwd_bwd(model, x):
    out, finals = model(x)
    loss = (out.float() ** 2).mean()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return out, finals, grads


def rnn_phase(dev):
    """Phase 34: a byte-level mLSTM at the 4096-unit width of Radford et
    al. 2017 (input 64, T 64, B 32) and a 2-layer bidirectional LSTM at
    1024: forward (outputs, final states) and backward (every gradient)
    on the card against the CPU in fp32, the relative max error gated at
    1e-4 (forward) and 1e-3 (gradients); bf16 finite; one SGD step on
    the mLSTM with weight norm on its ``ih``/``hh`` weights (T 16), ``g``
    and ``v`` gradients and the stepped ``g``, ``v`` against the CPU; ms
    a forward-and-backward step."""
    rnn = importlib.import_module("apex_tpu_torch.RNN")
    rep = importlib.import_module("apex_tpu_torch.reparameterization")
    T, B, IN = 64, 32, 64
    x = torch.from_numpy(np.random.RandomState(34).randn(T, B, IN)
                         .astype(np.float32))
    out = {}
    for name, make in (("mlstm_4096", lambda d, dt=torch.float32: rnn.mLSTM(
                            IN, 4096, 1, dtype=dt, device=d)),
                       ("bilstm_1024_x2", lambda d, dt=torch.float32:
                        rnn.LSTM(IN, 1024, 2, bidirectional=True, dtype=dt,
                                 device=d))):
        card, host = make(dev), make("cpu")
        o_c, f_c, g_c = _rnn_fwd_bwd(card, x.to(dev))
        o_h, f_h, g_h = _rnn_fwd_bwd(host, x)
        fwd = max([_rel(o_c, o_h)] + [_rel(a, b) for a, b in zip(
            torch.utils._pytree.tree_leaves(f_c),
            torch.utils._pytree.tree_leaves(f_h))])
        bwd = max(_rel(a, b) for a, b in zip(g_c, g_h))
        ms = eager_ms(lambda: _rnn_fwd_bwd(card, x.to(dev)), iters=3)
        bf = make(dev, torch.bfloat16)
        o_b, _, g_b = _rnn_fwd_bwd(bf, x.to(dev))
        finite = bool(torch.isfinite(o_b.float()).all()) and all(
            bool(torch.isfinite(g.float()).all()) for g in g_b)
        check(fwd <= 1e-4 and bwd <= 1e-3 and finite,
              f"{name}: card vs CPU fp32 forward rel err {fwd:.3g} (1e-4), "
              f"gradients {bwd:.3g} (1e-3); bf16 finite {finite}")
        print(f"      {name}: T {T} B {B}, forward+backward {ms:.2f} ms a "
              f"step (fp32, card)", flush=True)
        out[name] = dict(fwd_rel_err=fwd, grad_rel_err=bwd, step_ms=ms,
                         bf16_finite=finite)
        del card, bf
    # weight norm on the mLSTM's ih/hh weights (JAX's dim 0 of the
    # kernel is dim 1 of the weight), one SGD step over the first 16
    # time steps (the depth cut: the CPU's side is the phase's cost)
    results = []
    for d in (dev, "cpu"):
        model = rnn.mLSTM(IN, 4096, 1, device=d)
        p = rep.apply_weight_norm(dict(model.state_dict()),
                                  name="layer0/ih", dim=1)
        p = rep.apply_weight_norm(p, name="layer0/hh", dim=1)
        aux = [p[k][part] for k in ("layer0.ih.weight", "layer0.hh.weight")
               for part in ("g", "v")]
        for t in aux:
            t.requires_grad_(True)
        o, _ = torch.func.functional_call(model, rep.reconstruct(p),
                                          (x[:16].to(d),))
        grads = torch.autograd.grad((o ** 2).mean(), aux)
        with torch.no_grad():
            stepped = [t - 0.1 * g for t, g in zip(aux, grads)]
        results.append((grads, stepped))
    g_err = max(_rel(a, b) for a, b in zip(results[0][0], results[1][0]))
    s_err = max(_rel(a, b) for a, b in zip(results[0][1], results[1][1]))
    check(g_err <= 1e-3 and s_err <= 1e-5,
          f"mlstm weight norm: g/v gradients card vs CPU rel err "
          f"{g_err:.3g} (1e-3), after one SGD step {s_err:.3g} (1e-5)")
    out["weight_norm"] = dict(grad_rel_err=g_err, step_rel_err=s_err)
    return out


# -- phase 35: the sharding primitives --------------------------------------------

SHARD_GLOO_WORLD, GLOO_ZERO_STEPS = 2, 2
ZERO_ARGS = dict(b=4, t=256, steps=4)


def _lm_batch(b, t, seed, dev):
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        1, 50257, (b, t + 1))).to(dev)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def _lm_loss_fn(main_amp, model):
    def loss_fn(p, batch):
        return main_amp.lm_loss(torch.func.functional_call(
            model, p, (batch[0],)), batch[1], fused=True)
    return loss_fn


def _flat_jax_order(tree):
    zero = importlib.import_module("apex_tpu_torch.parallel.zero")
    return zero._flatten(tree)


def zero1_nccl(models, main_amp, training, counters, tmp, dev):
    """Phase 35 (a): Adam on GPT-2 small at O2 through
    ``make_train_step(reduce_grads=False)`` with ``zero1`` over an NCCL
    group of one, against the replicated step from the same weights: 4
    steps, every parameter and both moments bit for bit; the counters
    set to 0 just before the zero1 run and read just after."""
    import torch.distributed as dist
    zero = importlib.import_module("apex_tpu_torch.parallel.zero")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/zero1_nccl",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        model = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0)
        params = {k: v.detach() for k, v in model.state_dict().items()}
        batch = _lm_batch(ZERO_ARGS["b"], ZERO_ARGS["t"], 35, dev)
        runs = {}
        for name in ("replicated", "zero1"):
            adam = training.adam(3e-4, weight_decay=0.1)
            tx = (zero.zero1(adam, group, num_shards=1)
                  if name == "zero1" else adam)
            init_fn, step_fn = training.make_train_step(
                _lm_loss_fn(main_amp, model), tx, opt_level="O2",
                axis_name=group if name == "zero1" else None,
                reduce_grads=name != "zero1")
            state = init_fn({k: v.clone() for k, v in params.items()})
            for c in counters.values():
                c.launches = 0
            losses = []
            for _ in range(ZERO_ARGS["steps"]):
                state, m = step_fn(state, batch)
                losses.append(float(m["loss"]))
            runs[name] = (state, losses,
                          {n: c.launches for n, c in counters.items()
                           if c.launches})
        rs, zs = runs["replicated"][0], runs["zero1"][0]
        same_p = sum(torch.equal(rs.params[k], zs.params[k])
                     for k in rs.params)
        inner = zs.opt_state.inner
        same_m = (torch.equal(_flat_jax_order(rs.opt_state.exp_avg),
                              inner.exp_avg[:sum(v.numel() for v in
                                                 params.values())])
                  and torch.equal(_flat_jax_order(rs.opt_state.exp_avg_sq),
                                  inner.exp_avg_sq[:sum(
                                      v.numel() for v in params.values())]))
        check(same_p == len(rs.params) and same_m
              and runs["zero1"][1] == runs["replicated"][1],
              f"zero1 (NCCL group of one): after {ZERO_ARGS['steps']} O2 "
              f"Adam steps {same_p}/{len(rs.params)} parameters and both "
              f"moments bit for bit the replicated step's, losses "
              f"{runs['zero1'][1]}")
        return dict(losses=runs["zero1"][1], launches=runs["zero1"][2],
                    state_bytes=sum(t.numel() * t.element_size()
                                    for t in torch.utils._pytree
                                    .tree_leaves(zs.opt_state)))
    finally:
        dist.destroy_process_group()


def shard_gloo_worker(out_dir) -> int:
    """One rank of phase 35 (b) (``chip_smoke.py --shard-gloo-worker
    DIR``): two gloo ranks sharing the card, every collective gloo
    cannot move on CUDA tensors (zero1's reduce-scatter and all-gather,
    the MoE's all_to_all, the pipeline's send and receive) staged
    through the host inside ``distributed.host_staging()``, as in phases
    36-37."""
    multiproc = importlib.import_module("apex_tpu_torch.parallel.multiproc")
    distributed = importlib.import_module(
        "apex_tpu_torch.parallel.distributed")
    models = importlib.import_module("apex_tpu_torch.models")
    training = importlib.import_module("apex_tpu_torch.training")
    main_amp = importlib.import_module("apex_tpu_torch.examples.lm.main_amp")
    par = importlib.import_module("apex_tpu_torch.parallel")
    zero = importlib.import_module("apex_tpu_torch.parallel.zero")
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = multiproc.initialize(device=dev, backend="gloo")
    with distributed.host_staging():
        info, arrays = _shard_gloo_rank(models, training, main_amp, par,
                                        zero, fa, rank, world, dev)
    info["collectives"] = {k: c.launches
                           for k, c in distributed.COLLECTIVES.items()
                           if c.launches}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    multiproc.shutdown()
    return 0


def _shard_gloo_rank(models, training, main_amp, par, zero, fa, rank,
                     world, dev):
    """Phase 35 (b) on one rank: ``(info, arrays)``."""
    info, arrays = {}, {}
    # ZeRO-1 against the replicated two-rank DP step
    model = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    ids, labels = _lm_batch(2 * 2, 128, 351, dev)
    batch = (ids[2 * rank:2 * rank + 2], labels[2 * rank:2 * rank + 2])
    for name in ("dp", "zero1"):
        # both runs update on the card: the DP step all-reduces there,
        # zero1 reduce-scatters and all-gathers through the host
        adam = training.adam(3e-4, weight_decay=0.1)
        tx = (zero.zero1(adam, "data", num_shards=world)
              if name == "zero1" else adam)
        init_fn, step_fn = training.make_train_step(
            _lm_loss_fn(main_amp, model), tx, opt_level="O2",
            axis_name="data", reduce_grads=name != "zero1")
        state = init_fn({k: v.clone() for k, v in params.items()})
        for _ in range(GLOO_ZERO_STEPS):
            state, m = step_fn(state, batch)
        info[f"{name}_loss"] = float(m["loss"])
        info[f"{name}_state_bytes"] = sum(
            t.numel() * t.element_size()
            for t in torch.utils._pytree.tree_leaves(state.opt_state)
            if t.dim() >= 1)
        arrays.update({f"{name}/{k}": v.float().cpu().numpy()
                       for k, v in state.params.items()})
    info["padded_state_bytes"] = 2 * 4 * zero.padded_shard_len(
        sum(v.numel() for v in params.values()), world)
    del model, state
    # tensor parallel at GPT-2 small width: 12 heads, 6 a rank
    g = torch.Generator().manual_seed(352)
    rnd = lambda *s: (torch.randn(*s, generator=g) * 0.05).to(dev)
    x, wqkv, wo = rnd(4, 256, 768), rnd(768, 3, 12, 64), rnd(768, 768)
    w1, b1, w2, b2 = rnd(768, 3072), rnd(3072), rnd(3072, 768), rnd(768)
    h = slice(6 * rank, 6 * rank + 6)
    before = fa.flash_fwd_kernel.launches
    y = par.tp_self_attention(x, wqkv[:, :, h].contiguous(),
                              par.shard_row(wo, "data"), 6, "data",
                              causal=True)
    info["tp_flash_launches"] = fa.flash_fwd_kernel.launches - before
    qkv = torch.einsum("btd,dche->btche", x, wqkv)
    ref = fa.flash_attention(qkv[:, :, 0].contiguous(),
                             qkv[:, :, 1].contiguous(),
                             qkv[:, :, 2].contiguous(), causal=True)
    ref = ref.reshape(4, 256, -1) @ wo
    info["tp_attention_rel_err"] = _rel(y, ref)
    y = par.tp_mlp(x, par.shard_column(w1, "data"),
                   par.shard_column(b1[None], "data")[0],
                   par.shard_row(w2, "data"), b2, "data")
    ref = torch.nn.functional.gelu(x @ w1 + b1, approximate="tanh") @ w2 + b2
    info["tp_mlp_rel_err"] = _rel(y, ref)
    # expert and pipeline parallel on the card, the tokens' all_to_all
    # and the activations' send and receive staged
    def ffn(p, hh):
        return torch.tanh(hh @ p["w"]) @ p["v"]
    experts = [{"w": rnd(768, 3072), "v": rnd(3072, 768)}
               for _ in range(world)]
    router = rnd(768, world)
    xt = (torch.randn(world * 512, 768, generator=g) * 0.5).to(dev)
    rows = slice(512 * rank, 512 * rank + 512)
    y, aux = par.moe_layer(xt[rows], router, ffn, experts[rank],
                           axis_name="data", capacity_factor=world)
    probs = torch.softmax(xt @ router, -1)
    gate, assign = probs.max(-1)
    dense = torch.stack([ffn(e, xt) for e in experts])
    oracle = dense[assign, torch.arange(xt.shape[0])] * gate[:, None]
    info["moe_rel_err"] = _rel(y, oracle[rows])
    info["moe_dropped"] = float(aux.dropped_fraction)
    stages = [{"w": rnd(768, 768), "b": rnd(768)} for _ in range(world)]

    def stage(p, hh):
        return torch.tanh(hh @ p["w"] + p["b"])
    xp = torch.randn(16, 768, generator=g).to(dev)
    mine = {k: v[None].clone().requires_grad_(True)
            for k, v in stages[rank].items()}
    yp = par.spmd_pipeline(stage, mine, xp, axis_name="data",
                           num_microbatches=4)
    yp.square().mean().backward()
    seq = [{k: v.clone().requires_grad_(True) for k, v in s.items()}
           for s in stages]
    ys = xp
    for s in seq:
        ys = stage(s, ys)
    ys.square().mean().backward()
    info["pipeline_rel_err"] = _rel(yp, ys)
    info["pipeline_grad_rel_err"] = max(
        _rel(mine[k].grad[0], seq[rank][k].grad) for k in ("w", "b"))
    return info, arrays


def shard_gloo(tmp):
    """Phase 35 (b): two gloo ranks sharing the card
    (``shard_gloo_worker``): zero1 Adam on GPT-2 small at O2, each rank
    holding half the padded state, parameters within rtol 1e-6 of the
    replicated two-rank DP step's (zero1's reduce-scatter and
    all-gather staged through the host); ``tp_self_attention`` (one flash
    launch a rank on its 6 heads) and ``tp_mlp`` at GPT-2 small width
    against the unsharded product; ``moe_layer`` and ``spmd_pipeline``
    (forward and gradients) against their single-process oracles."""
    multiproc = importlib.import_module("apex_tpu_torch.parallel.multiproc")
    out_dir = os.path.join(tmp, "shard_gloo")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    res = multiproc.spawn([os.path.abspath(__file__), "--shard-gloo-worker",
                           out_dir], SHARD_GLOO_WORLD,
                          f"file://{out_dir}/store", timeout=420,
                          capture=True, env=_child_env(), cwd=REPO_ROOT)
    wall = time.perf_counter() - t0
    rcs = [r["returncode"] for r in res]
    check(rcs == [0] * SHARD_GLOO_WORLD,
          f"shard_gloo: {SHARD_GLOO_WORLD} ranks exited {rcs} in "
          f"{wall:.1f} s" + ("" if rcs == [0] * SHARD_GLOO_WORLD else
                             ": " + " | ".join((r["output"] or "")[-3000:]
                                               for r in res)))
    if rcs != [0] * SHARD_GLOO_WORLD:
        return {}
    infos, arrays = [], []
    for r in range(SHARD_GLOO_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            infos.append(json.load(f))
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            arrays.append({k: z[k] for k in z.files})
    worst = 0.0
    for a in arrays:
        for k in a:
            if k.startswith("zero1/"):
                want = a["dp/" + k[len("zero1/"):]]
                diff = np.abs(a[k] - want)
                worst = max(worst, float(np.max(np.where(
                    diff == 0, 0.0, diff / np.maximum(np.abs(want),
                                                      1e-30)))))
    half = infos[0]["padded_state_bytes"] // SHARD_GLOO_WORLD
    check(all(i["zero1_state_bytes"] == half for i in infos)
          and worst <= 1e-6,
          f"shard_gloo zero1: each rank holds {infos[0]['zero1_state_bytes']} "
          f"B of Adam state, half the padded {infos[0]['padded_state_bytes']}"
          f" B (replicated DP: {infos[0]['dp_state_bytes']} B a rank); "
          f"parameters after {GLOO_ZERO_STEPS} O2 steps within rtol "
          f"{worst:.3g} of the "
          f"replicated two-rank DP step's (1e-6)")
    check(all(i["tp_flash_launches"] == 1 and i["tp_attention_rel_err"]
              <= 1e-5 and i["tp_mlp_rel_err"] <= 1e-5 for i in infos),
          f"shard_gloo tp: flash launches a rank "
          f"{[i['tp_flash_launches'] for i in infos]}, tp_self_attention "
          f"rel err {[i['tp_attention_rel_err'] for i in infos]}, tp_mlp "
          f"{[i['tp_mlp_rel_err'] for i in infos]} (1e-5)")
    check(all(i["moe_rel_err"] <= 1e-5 and i["moe_dropped"] == 0
              and i["pipeline_rel_err"] <= 1e-6
              and i["pipeline_grad_rel_err"] <= 1e-5 for i in infos),
          f"shard_gloo moe rel err {[i['moe_rel_err'] for i in infos]} "
          f"(1e-5), pipeline {[i['pipeline_rel_err'] for i in infos]} "
          f"(1e-6), its gradients "
          f"{[i['pipeline_grad_rel_err'] for i in infos]} (1e-5)")
    print(f"      shard_gloo collectives, rank 0: {infos[0]['collectives']}",
          flush=True)
    return dict(wall_s=wall, ranks=infos, zero1_param_rtol=worst)


# -- phases 36-37: sequence parallelism and the mesh --------------------------------

SEQ_GLOO_WORLD = 2
RING_T_LOCAL = 512
#: 36 (c): the LM trainer's --sp 2 on GPT-2 small, a few eager steps
SP_LM_ARGS = ["--synthetic", "--device", "cuda", "--vocab", "50257",
              "--hidden", "768", "--layers", "12", "--heads", "12",
              "--seq-len", "1025", "-b", "8", "--opt-level", "O2",
              "--fused-loss"]
SP_LM_STEPS = 3
#: the --sp 2 losses against --sp 1's: bf16 activations either way, but
#: the ring merges each shard's bf16-rounded partial output in fp32 and
#: the gradients are all-reduced over two ranks, so the sums run in
#: another order. Measured on an H100: sound 1.69e-5; rank 1's positions
#: started at 0 9.10e-4; rank 1's ring step over rank 0's keys dropped
#: 3.44e-2. The limit sits between the sound run and the first fault
SP_LM_RTOL = 1.2e-4
MESH_ARGS = dict(b=4, t=256, steps=4, k=4)


def ring_kernel_offsets(fa, dev):
    """Phase 36 (a): kernels 10-12 against their plain versions at the
    ring's relative offsets (-t_local, 0, +t_local and a non-multiple)
    with t_local 512 and GPT-2 small's heads (B 8, 12 x 64), bf16 and
    fp32, causal and not, plus the split-KV route (q_len 8) in bf16: a
    row with no visible key gives out 0 and lse -1e30, every gradient
    of a hidden row or an unseen key is 0, no NaN anywhere."""
    t = RING_T_LOCAL
    g = torch.Generator().manual_seed(36)
    worst, ms = {}, {}
    ok = True
    for dtype, tol, tq in ((torch.bfloat16, 2e-2, t), (torch.float32, 1e-4, t),
                           (torch.bfloat16, 2e-2, 8)):
        q, do = (torch.randn(8, tq, 12, 64, generator=g).to(dev, dtype)
                 for _ in range(2))
        k, v = (torch.randn(8, t, 12, 64, generator=g).to(dev, dtype)
                for _ in range(2))
        zero_routes(fa)
        zero_bwd_routes(fa)
        for causal in (True, False):
            for off in (-t, 0, t, 37 - t):
                kw = dict(sm_scale=64 ** -0.5, causal=causal, q_offset=off)
                out, lse = fa.flash_fwd_kernel(q, k, v, None, None, **kw)
                ro, rl = fa._flash_fwd_ref(q, k, v, None, None, **kw)
                rows = torch.arange(tq, device=dev)
                hidden = ((off + rows < 0) if causal
                          else torch.zeros_like(rows, dtype=torch.bool))
                glse = torch.where(lse == fa.NEG_INF,
                                   torch.full_like(lse, 0.5),
                                   torch.logaddexp(lse, torch.full_like(
                                       lse, 0.5))).contiguous()
                delta = fa._delta(do, out)
                dq = fa.flash_bwd_dq_kernel(q, k, v, do, glse, delta, None,
                                            None, **kw)
                dk, dv, _ = fa.flash_bwd_dkv_kernel(q, k, v, do, glse, delta,
                                                    None, None, **kw)
                wq, wk, wv, _, _ = fa._flash_bwd_ref(q, k, v, None, None,
                                                     out, glse, do, **kw)
                errs = [(out.float() - ro.float()).abs().max().item(),
                        (lse - rl).abs().max().item()]
                errs += [_rel(a, b) for a, b in ((dq, wq), (dk, wk),
                                                 (dv, wv))]
                finite = all(not torch.isnan(x.float()).any()
                             for x in (out, lse, dq, dk, dv))
                zeros = True
                if hidden.any():
                    zeros = (bool((out[:, hidden] == 0).all())
                             and bool((lse[:, :, hidden] == fa.NEG_INF).all())
                             and bool((dq[:, hidden] == 0).all()))
                if causal:
                    unseen = torch.arange(t, device=dev) > off + tq - 1
                    if unseen.any():
                        zeros = zeros and bool((dk[:, unseen] == 0).all()
                                               and (dv[:, unseen] == 0).all())
                key = (f"{str(dtype)[6:]} tq{tq} "
                       f"{'causal' if causal else 'full'} {off:+d}")
                worst[key] = max(errs)
                if dtype == torch.bfloat16 and tq == t and causal \
                        and off % t == 0:
                    # what a ring step costs at each offset (a shard
                    # ahead skips every tile), beside its bound
                    masks = dict(causal=True, q_offset=off, window=None)
                    cf = costs()
                    ms[off] = dict(
                        ms=[time_ms(fn, iters=5) for fn in (
                            lambda: fa.flash_fwd_kernel(q, k, v, None, None,
                                                        **kw),
                            lambda: fa.flash_bwd_dq_kernel(
                                q, k, v, do, glse, delta, None, None, **kw),
                            lambda: fa.flash_bwd_dkv_kernel(
                                q, k, v, do, glse, delta, None, None,
                                **kw))],
                        bound_ms=[bound(c)[0] for c in (
                            cf.flash_fwd(q, k, v, None, None, **masks),
                            cf.flash_bwd_dq(q, k, v, None, None, **masks),
                            cf.flash_bwd_dkv(q, k, v, None, None,
                                             **masks))])
                ok = ok and max(errs) <= tol and finite and zeros
                if not (max(errs) <= tol and finite and zeros):
                    print(f"      ring offsets {key}: errs {errs}, finite "
                          f"{finite}, hidden zeros {zeros}", flush=True)
        # the route of every forward of this group: bf16 at 512 rows on
        # wgmma, fp32 on SIMT, 8 rows on the decode kernel (none on
        # split-KV)
        routes = dict(fa.flash_fwd_kernel.routes)
        want = ("decode" if tq < fa._SPLIT_TQ else
                "simt" if dtype == torch.float32 else "wgmma")
        check(routes[want] > 0 and sum(routes.values()) == routes[want],
              f"ring offsets {str(dtype)[6:]} q_len {tq}: forward routes "
              f"{routes}, all {want}")
        # and of every dQ and dK/dV: bf16 on wgmma, fp32 on SIMT
        want = "simt" if dtype == torch.float32 else "wgmma"
        for key, got in bwd_routes(fa).items():
            check(got[want] > 0 and sum(got.values()) == got[want],
                  f"ring offsets {str(dtype)[6:]} q_len {tq}: backward "
                  f"{key} routes {got}, all {want}")
    check(ok, f"ring offsets: kernels 10-12 vs plain at q_offset "
              f"{{-512, 0, +512, -475}} (bf16 2e-2, fp32 1e-4; the decode "
              f"kernel at q_len 8 in bf16), hidden rows 0 / -1e30 / zero "
              f"gradients, "
              f"no NaN: worst {max(worst.values()):.3g}")
    print("      ring offsets, bf16 causal, B 8 x 512 rows x 12 x 64, "
          "kernels 10 / 11 / 12 ms (bound ms): " + "; ".join(
              f"{off:+d}: " + " / ".join(
                  f"{x:.4f} ({y:.4f})" for x, y in zip(v["ms"],
                                                       v["bound_ms"]))
              for off, v in ms.items()), flush=True)
    return dict(worst=worst, ms={str(k): v for k, v in ms.items()})


def _ring_gloo(fa, ra, rank, world, dev):
    """Phase 36 (b) on one rank: ring_flash, ring and Ulysses attention at
    B 8, T 1024 (512 a rank), 12 x 64, causal, forward and the gradients
    of ``sum(out * dout)``, against one process's ``flash_attention`` at
    T 1024 on the same inputs; ring_flash's kernel launches counted."""
    info = {}
    counters = _kernel_counters()
    g = torch.Generator().manual_seed(362)
    for dtype in (torch.float32, torch.bfloat16):
        full = [torch.randn(8, 1024, 12, 64, generator=g).to(dev, dtype)
                for _ in range(4)]
        ref_in = [x.clone().requires_grad_(True) for x in full[:3]]
        ref = fa.flash_attention(*ref_in, causal=True)
        (ref.float() * full[3].float()).sum().backward()
        sl = slice(512 * rank, 512 * rank + 512)
        for name in ("ring_flash", "ring", "ulysses"):
            fn = getattr(ra, f"{name}_attention")
            mine = [x[:, sl].clone().requires_grad_(True) for x in full[:3]]
            for c in counters.values():
                c.launches = 0
            out = fn(*mine, "data", causal=True)
            (out.float() * full[3][:, sl].float()).sum().backward()
            torch.cuda.synchronize()
            key = f"{name}_{str(dtype)[6:]}"
            info[f"{key}_out_err"] = (out.float() - ref[:, sl].float()
                                      ).abs().max().item()
            info[f"{key}_grad_rel"] = max(
                _rel(m.grad, r.grad[:, sl]) for m, r in zip(mine, ref_in))
            info[f"{key}_launches"] = {n: c.launches
                                       for n, c in counters.items()
                                       if c.launches}
    return info


def _sp_lm_gloo(main_amp, rank, dev):
    """Phase 36 (c) on one rank: the LM trainer's ``--sp 2 --attention
    ring_flash`` (its ``build``: the ``sp`` axis over the two ranks), a
    few eager steps on this rank's half of the sequence, the kernels'
    launches counted; rank 0 then runs ``--sp 1 --attention flash`` on
    the same batch for the reference losses."""
    counters = _kernel_counters()
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    args = main_amp.parse(SP_LM_ARGS + ["--attention", "ring_flash",
                                        "--sp", "2"])
    state, step_fn, batch = main_amp.build(args)
    mine = main_amp.sequence_shard(batch, 1)
    for c in counters.values():
        c.launches = 0
    zero_bwd_routes(fa)
    losses = []
    t0 = time.perf_counter()
    for _ in range(SP_LM_STEPS):
        state, m = step_fn(state, mine)
        losses.append(float(m["loss"]))
    info = {"sp_lm_losses": losses,
            "sp_lm_step_s": (time.perf_counter() - t0) / SP_LM_STEPS,
            "sp_lm_launches": {n: c.launches for n, c in counters.items()
                               if c.launches},
            "sp_lm_bwd_routes": bwd_routes(fa)}
    del state
    if rank == 0:
        args = main_amp.parse(SP_LM_ARGS + ["--attention", "flash"])
        state, step_fn, batch = main_amp.build(args)
        ref = []
        for _ in range(SP_LM_STEPS):
            state, m = step_fn(state, batch)
            ref.append(float(m["loss"]))
        info["sp1_lm_losses"] = ref
        del state
    gc.collect()
    torch.cuda.empty_cache()
    return info


def _mesh_gloo(models, main_amp, training, rank, dev):
    """Phase 37 (c) on one rank: ``make_mesh_train_step`` at ``fsdp=2``,
    ``zero=3`` on GPT-2 small O2 (2 rows a rank, T 128) against the
    replicated two-rank DP step, 2 steps from the same weights."""
    mesh = importlib.import_module("apex_tpu_torch.parallel.mesh")
    model = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    ids, labels = _lm_batch(2 * SEQ_GLOO_WORLD, 128, 373, dev)
    loss_fn = _lm_loss_fn(main_amp, model)
    plan = mesh.MeshPlan(dp=1, fsdp=SEQ_GLOO_WORLD)
    ms = mesh.make_mesh_train_step(
        loss_fn, training.adam(3e-4, weight_decay=0.1), plan, zero=3,
        opt_level="O2")
    st = ms.init({k: v.clone() for k, v in params.items()})
    spec = ms.state_spec(st)
    ratio = plan.state_bytes((st.params, st.opt_state),
                             (spec.params, spec.opt_state))["ratio"]
    batch = plan.device_put_batch((ids, labels))
    for _ in range(GLOO_ZERO_STEPS):
        st, m = ms.step_fn(st, batch)
    full = ms.gather_params(st)
    init_fn, step_fn = training.make_train_step(
        loss_fn, training.adam(3e-4, weight_decay=0.1), opt_level="O2",
        axis_name="data")
    dp = init_fn({k: v.clone() for k, v in params.items()})
    for _ in range(GLOO_ZERO_STEPS):
        dp, m_dp = step_fn(dp, batch)
    worst = 0.0
    for k, v in full.items():
        want = dp.params[k].float()
        diff = (v.float() - want).abs()
        rel = torch.where(diff == 0, torch.zeros_like(diff),
                          diff / want.abs().clamp_min(1e-30))
        worst = max(worst, rel.max().item())
    return {"mesh_state_ratio": ratio, "mesh_param_rtol": worst,
            "mesh_loss": float(m["loss"]), "dp_loss": float(m_dp["loss"])}


def seq_gloo_worker(out_dir) -> int:
    """One rank of phases 36 (b, c) and 37 (c) (``chip_smoke.py
    --seq-gloo-worker DIR``): two gloo ranks sharing the card, every
    collective gloo cannot move on CUDA tensors (the ring's send and
    receive, Ulysses's all_to_all, the mesh's all-gather and
    reduce-scatter) staged through the host inside
    ``distributed.host_staging()``, each counted in
    ``COLLECTIVES["host_staged"]``."""
    multiproc = importlib.import_module("apex_tpu_torch.parallel.multiproc")
    distributed = importlib.import_module(
        "apex_tpu_torch.parallel.distributed")
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    ra = importlib.import_module("apex_tpu_torch.parallel.ring_attention")
    models = importlib.import_module("apex_tpu_torch.models")
    training = importlib.import_module("apex_tpu_torch.training")
    main_amp = importlib.import_module("apex_tpu_torch.examples.lm.main_amp")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = multiproc.initialize(device=dev, backend="gloo")
    info = {}
    with distributed.host_staging():
        t0 = time.perf_counter()
        info.update(_ring_gloo(fa, ra, rank, world, dev))
        info["ring_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        info.update(_sp_lm_gloo(main_amp, rank, dev))
        info["sp_lm_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        info.update(_mesh_gloo(models, main_amp, training, rank, dev))
        info["mesh_s"] = time.perf_counter() - t0
    info["collectives"] = {k: c.launches
                           for k, c in distributed.COLLECTIVES.items()
                           if c.launches}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    multiproc.shutdown()
    return 0


#: the faults ``--sp-gate-faults`` plants in phase 36 (c), each read
#: against the sound run to place ``SP_LM_RTOL`` between them
SP_GATE_FAULTS = ("none", "positions", "dropped_step")


def sp_fault_worker(out_dir, fault) -> int:
    """One rank of ``--sp-gate-faults`` (``chip_smoke.py
    --sp-fault-worker DIR FAULT``): phase 36 (c) with ``fault`` planted
    at run time: ``positions`` starts every rank's positions at 0,
    ``dropped_step`` drops each rank's ring step over an earlier shard's
    keys (its forward part set to out 0, lse -1e30)."""
    multiproc = importlib.import_module("apex_tpu_torch.parallel.multiproc")
    distributed = importlib.import_module(
        "apex_tpu_torch.parallel.distributed")
    main_amp = importlib.import_module("apex_tpu_torch.examples.lm.main_amp")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, _ = multiproc.initialize(device=dev, backend="gloo")
    if fault == "positions":
        gpt = importlib.import_module("apex_tpu_torch.models.gpt")
        gpt.axis_index = lambda axis: 0
    elif fault == "dropped_step":
        ra = importlib.import_module("apex_tpu_torch.parallel.ring_attention")
        fwd = ra._fwd_part

        def dropped(q, k, v, sm_scale, causal, offset):
            out, lse = fwd(q, k, v, sm_scale, causal, offset)
            if offset > 0:
                return torch.zeros_like(out), torch.full_like(lse, -1e30)
            return out, lse
        ra._fwd_part = dropped
    with distributed.host_staging():
        info = _sp_lm_gloo(main_amp, rank, dev)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    multiproc.shutdown()
    return 0


def sp_gate_faults() -> int:
    """``chip_smoke.py --sp-gate-faults``: the reach of phase 36 (c)'s
    gate. Runs it sound and with each of :data:`SP_GATE_FAULTS` planted
    (two gloo ranks each) and prints each run's largest relative loss
    difference from ``--sp 1`` beside ``SP_LM_RTOL``; exits 1 if the
    sound run fails the limit or a fault passes it."""
    multiproc = importlib.import_module("apex_tpu_torch.parallel.multiproc")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    tmp = tempfile.mkdtemp(prefix="sp_gate_")
    rels = {}
    try:
        for fault in SP_GATE_FAULTS:
            d = os.path.join(tmp, fault)
            os.makedirs(d)
            res = multiproc.spawn(
                [os.path.abspath(__file__), "--sp-fault-worker", d, fault],
                SEQ_GLOO_WORLD, f"file://{d}/store", timeout=420,
                capture=True, env=_child_env(), cwd=REPO_ROOT)
            if [r["returncode"] for r in res] != [0] * SEQ_GLOO_WORLD:
                print(f"{fault}: ranks failed: " + " | ".join(
                    (r["output"] or "")[-3000:] for r in res), flush=True)
                return 1
            with open(os.path.join(d, "rank0.json")) as f:
                info = json.load(f)
            lm, ref = info["sp_lm_losses"], info["sp1_lm_losses"]
            rels[fault] = max(abs(a - b) / abs(b) for a, b in zip(lm, ref))
            print(f"{fault}: losses {lm}, --sp 1 {ref}, rel "
                  f"{rels[fault]!r} (limit {SP_LM_RTOL})", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok = rels["none"] <= SP_LM_RTOL and all(
        r > SP_LM_RTOL for f, r in rels.items() if f != "none")
    print(json.dumps({"sp_gate": rels, "limit": SP_LM_RTOL, "ok": ok}))
    return 0 if ok else 1


def seq_gloo(tmp):
    """Phases 36 (b, c) and 37 (c): two gloo ranks sharing the card
    (``seq_gloo_worker``)."""
    multiproc = importlib.import_module("apex_tpu_torch.parallel.multiproc")
    out_dir = os.path.join(tmp, "seq_gloo")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    res = multiproc.spawn([os.path.abspath(__file__), "--seq-gloo-worker",
                           out_dir], SEQ_GLOO_WORLD,
                          f"file://{out_dir}/store", timeout=420,
                          capture=True, env=_child_env(), cwd=REPO_ROOT)
    wall = time.perf_counter() - t0
    rcs = [r["returncode"] for r in res]
    check(rcs == [0] * SEQ_GLOO_WORLD,
          f"seq_gloo: {SEQ_GLOO_WORLD} ranks exited {rcs} in {wall:.1f} s"
          + ("" if rcs == [0] * SEQ_GLOO_WORLD else
             ": " + " | ".join((r["output"] or "")[-3000:] for r in res)))
    if rcs != [0] * SEQ_GLOO_WORLD:
        return {}
    infos = []
    for r in range(SEQ_GLOO_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            infos.append(json.load(f))
    for dtype, out_tol, grad_tol in (("float32", 2e-5, 5e-4),
                                     ("bfloat16", 2e-2, 2e-2)):
        for name in ("ring_flash", "ring", "ulysses"):
            key = f"{name}_{dtype}"
            errs = [(i[f"{key}_out_err"], i[f"{key}_grad_rel"])
                    for i in infos]
            check(all(o <= out_tol and gr <= grad_tol for o, gr in errs),
                  f"{key} over 2 gloo ranks (B 8, T 1024, 12 x 64, causal) "
                  f"vs one process's flash_attention: out err / gradient "
                  f"rel err a rank {errs} ({out_tol} / {grad_tol})")
    want = {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
            "flash_attention_bwd_dkv": 2}
    got = [i["ring_flash_float32_launches"] for i in infos]
    check(all(g == want for g in got),
          f"ring_flash launches a rank {got} (n = 2 of each of kernels "
          f"10-12: one a ring step)")
    lm = [i["sp_lm_losses"] for i in infos]
    ref = infos[0]["sp1_lm_losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lm[0], ref))
    per_step = {"layer_norm_fwd": 25, "layer_norm_bwd": 25,
                "flash_attention_fwd": 24, "flash_attention_bwd_dq": 24,
                "flash_attention_bwd_dkv": 24, "xentropy_fwd": 1,
                "xentropy_bwd": 1}
    want = {k: v * SP_LM_STEPS for k, v in per_step.items()}
    launches = [i["sp_lm_launches"] for i in infos]
    check(lm[0] == lm[1] and rel <= SP_LM_RTOL
          and all(la == want for la in launches),
          f"LM --sp 2 --attention ring_flash (GPT-2 small O2 B 8, "
          f"--seq-len 1025, fused loss, {SP_LM_STEPS} eager steps on 2 gloo "
          f"ranks): losses {lm[0]} on both ranks, --sp 1 --attention flash "
          f"{ref}, rel {rel:.3g} ({SP_LM_RTOL}); launches a rank "
          f"{launches} = {per_step} x {SP_LM_STEPS} (kernels 10-12: "
          f"2 ring steps x 12 layers a pass)")
    for r, i in enumerate(infos):
        bwd_route_gate(f"LM --sp 2 --attention ring_flash, rank {r}",
                       i["sp_lm_bwd_routes"],
                       {"dq": i["sp_lm_launches"]["flash_attention_bwd_dq"],
                        "dkv": i["sp_lm_launches"][
                            "flash_attention_bwd_dkv"]})
    worst = max(i["mesh_param_rtol"] for i in infos)
    check(worst <= 1e-6 and all(i["mesh_state_ratio"] <= 0.5 + 0.01
                                for i in infos),
          f"mesh fsdp=2 zero=3 over 2 gloo ranks (GPT-2 small O2): "
          f"parameters after {GLOO_ZERO_STEPS} steps within rtol "
          f"{worst:.3g} of the replicated two-rank DP step's (1e-6, phase "
          f"35's); state held a rank {[i['mesh_state_ratio'] for i in infos]}"
          f" of the whole")
    print(f"      seq_gloo: {wall:.1f} s (ring {infos[0]['ring_s']:.1f}, "
          f"LM --sp 2 {infos[0]['sp_lm_s']:.1f} at "
          f"{infos[0]['sp_lm_step_s'] * 1e3:.1f} ms a step, mesh "
          f"{infos[0]['mesh_s']:.1f}); collectives a rank "
          f"{[i['collectives'] for i in infos]}", flush=True)
    return dict(wall_s=wall, ranks=infos, lm_rel=rel, mesh_param_rtol=worst,
                ring_lm_launches=launches[0])


def mesh_nccl(models, main_amp, training, counters, tmp, dev):
    """Phase 37 (a, b) in an NCCL group of one: ``make_mesh_train_step``
    at zero 1, 2 and 3 on GPT-2 small O2 (B 4, T 256), each bit for bit
    ``make_train_step``'s replicated step after 4 steps (losses and
    parameters; zero 3's moments too); then zero 3 through
    ``StepPipeline(wrap=ms.pipeline_wrap(state))`` at K 4, captured with
    its gather and scatter inside the graph: one capture, 16 / K
    replays, every state leaf bit for bit 16 eager steps."""
    import torch.distributed as dist
    mesh = importlib.import_module("apex_tpu_torch.parallel.mesh")
    runtime = importlib.import_module("apex_tpu_torch.runtime")
    bk = importlib.import_module("apex_tpu_torch.multi_tensor.buckets")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/mesh_nccl",
                            world_size=1, rank=0)
    out = {}
    try:
        model = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0)
        params = {k: v.detach() for k, v in model.state_dict().items()}
        batch = _lm_batch(MESH_ARGS["b"], MESH_ARGS["t"], 37, dev)
        loss_fn = _lm_loss_fn(main_amp, model)

        def adam():
            return training.adam(3e-4, weight_decay=0.1)

        def fresh():
            return {k: v.clone() for k, v in params.items()}
        init_fn, step_fn = training.make_train_step(loss_fn, adam(),
                                                    opt_level="O2")
        ref = init_fn(fresh())
        ref_losses = []
        for _ in range(MESH_ARGS["steps"]):
            ref, m = step_fn(ref, batch)
            ref_losses.append(float(m["loss"]))
        plan = mesh.MeshPlan()
        for zero in (1, 2, 3):
            ms = mesh.make_mesh_train_step(loss_fn, adam(), plan, zero=zero,
                                           opt_level="O2")
            st = ms.init(fresh())
            fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
            for c in counters.values():
                c.launches = 0
            zero_bwd_routes(fa)
            losses = []
            for _ in range(MESH_ARGS["steps"]):
                st, m = ms.step_fn(st, plan.device_put_batch(batch))
                losses.append(float(m["loss"]))
            launches = {n: c.launches for n, c in counters.items()
                        if c.launches}
            bwd_route_gate(f"mesh zero={zero} (NCCL group of one)",
                           bwd_routes(fa),
                           {"dq": launches["flash_attention_bwd_dq"],
                            "dkv": launches["flash_attention_bwd_dkv"]})
            full = ms.gather_params(st)
            same = sum(torch.equal(full[k], ref.params[k]) for k in params)
            moments = True
            if zero == 3:
                store = ms.store()
                inner = st.opt_state.inner
                for attr in ("exp_avg", "exp_avg_sq"):
                    got = store.unpack(bk.Packed(
                        data=tuple(getattr(s, attr)[:b.size] for s, b in
                                   zip(inner, store.buckets)), rest=()))
                    moments = moments and all(
                        torch.equal(got[k], getattr(ref.opt_state, attr)[k])
                        for k in params)
            check(same == len(params) and moments and losses == ref_losses,
                  f"mesh zero={zero} (NCCL group of one): after "
                  f"{MESH_ARGS['steps']} O2 steps {same}/{len(params)} "
                  f"parameters{' and both moments' if zero == 3 else ''} "
                  f"bit for bit the replicated step's, losses {losses}")
            out[f"zero{zero}"] = dict(losses=losses, launches=launches)
            del st
        # 37 (b): zero 3 through the captured pipeline
        k = MESH_ARGS["k"]
        ms = mesh.make_mesh_train_step(loss_fn, adam(), plan, zero=3,
                                       opt_level="O2")
        st = ms.init(fresh())
        pipe = runtime.StepPipeline(ms.step_fn, k,
                                    wrap=ms.pipeline_wrap(st))
        window = tuple(t.unsqueeze(0).expand(k, *t.shape).contiguous()
                       for t in batch)
        pipe.warmup(st, window)
        for _ in range(16 // k):
            st, metrics = pipe.step_window(st, window)
        eager = ms.init(fresh())
        for _ in range(16):
            eager, _ = ms.step_fn(eager, batch)
        leaves = torch.utils._pytree.tree_leaves((st.params, st.opt_state))
        want = torch.utils._pytree.tree_leaves((eager.params,
                                                eager.opt_state))
        same = sum(torch.equal(a, b) for a, b in zip(leaves, want))
        stats = pipe.stats
        check(same == len(want) and stats["captures"]["hot"] == 1
              and stats["replays"] == 16 // k,
              f"mesh zero=3 StepPipeline(wrap=) K {k} captured (gather and "
              f"scatter in the graph): {same}/{len(want)} state leaves bit "
              f"for bit 16 eager steps; captures {stats['captures']}, "
              f"replays {stats['replays']} (1, {16 // k})")
        out["pipeline"] = dict(same_leaves=same, leaves=len(want),
                               captures=stats["captures"]["hot"],
                               replays=stats["replays"])
    finally:
        # the group, and the mesh's axes and sub-groups cached on it
        importlib.import_module(
            "apex_tpu_torch.parallel.multiproc").shutdown()
    return out


def _kernel_counters():
    """Every kernel's wrapper (its launch counter) by the kernel's name."""
    mod = importlib.import_module
    fln = mod("apex_tpu_torch.normalization.fused_layer_norm")
    fa = mod("apex_tpu_torch.ops.flash_attention")
    fba = mod("apex_tpu_torch.normalization.fused_bn_act")
    xent = mod("apex_tpu_torch.contrib.xentropy")
    cv = mod("apex_tpu_torch.ops.conv")
    qk = mod("apex_tpu_torch.quant.kernels")
    return {
        "layer_norm_fwd": fln.layer_norm_fwd_kernel,
        "layer_norm_bwd": fln.layer_norm_bwd_kernel,
        "flash_attention_fwd": fa.flash_fwd_kernel,
        "flash_attention_bwd_dq": fa.flash_bwd_dq_kernel,
        "flash_attention_bwd_dkv": fa.flash_bwd_dkv_kernel,
        "bn_act_fwd": fba.bn_act_fwd_kernel,
        "bn_act_bwd": fba.bn_act_bwd_kernel,
        "xentropy_fwd": xent.xentropy_fwd_kernel,
        "xentropy_bwd": xent.xentropy_bwd_kernel,
        "conv_fwd": cv.conv_fwd_kernel,
        "conv_dgrad": cv.conv_dgrad_kernel,
        "conv_wgrad": cv.conv_wgrad_kernel,
        "qmm": qk.qmm_kernel,
        "flash_attention_bwd_db2": fa.flash_bwd_db2_kernel}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--was", default=None,
                    help="the root of another checkout of the port (the "
                         "parent commit's): phases 4b, 15b, 16 and 19 "
                         "time its flash, conv, qmm and db2 kernels "
                         "beside this one's, and phases 5, 17 and 6 serve "
                         "and trace its engine")
    ap.add_argument("--ddp-gloo-worker", default=None, metavar="DIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--shard-gloo-worker", default=None, metavar="DIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--seq-gloo-worker", default=None, metavar="DIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--sp-fault-worker", default=None, nargs=2,
                    metavar=("DIR", "FAULT"), help=argparse.SUPPRESS)
    ap.add_argument("--sp-gate-faults", action="store_true",
                    help="only run phase 36 (c) sound and with faults "
                         "planted, against its limit")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.ddp_gloo_worker:
        return ddp_gloo_worker(args.ddp_gloo_worker)
    if args.shard_gloo_worker:
        return shard_gloo_worker(args.shard_gloo_worker)
    if args.seq_gloo_worker:
        return seq_gloo_worker(args.seq_gloo_worker)
    if args.sp_fault_worker:
        return sp_fault_worker(*args.sp_fault_worker)
    if args.sp_gate_faults:
        return sp_gate_faults()
    fln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    fba = importlib.import_module("apex_tpu_torch.normalization.fused_bn_act")
    xent = importlib.import_module("apex_tpu_torch.contrib.xentropy")
    cv = importlib.import_module("apex_tpu_torch.ops.conv")
    models = importlib.import_module("apex_tpu_torch.models")
    engine_mod = importlib.import_module("apex_tpu_torch.serving.engine")
    build = importlib.import_module("apex_tpu_torch._build")
    training = importlib.import_module("apex_tpu_torch.training")
    main_amp = importlib.import_module("apex_tpu_torch.examples.lm.main_amp")
    imagenet = importlib.import_module(
        "apex_tpu_torch.examples.imagenet.main_amp")
    quant = importlib.import_module("apex_tpu_torch.quant")
    qk = importlib.import_module("apex_tpu_torch.quant.kernels")
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    # phases 1-31 run with an empty tune cache (the rules' tiles)
    os.environ["APEX_TPU_TUNE_CACHE"] = EMPTY_TUNE_CACHE

    # phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} ({smi})", flush=True)

    # phase 2: every kernel built at once, one nvcc per CUDA source; the
    # Triton kernels compile one after another in a fourth thread
    def timed(fn):
        def run():
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        return run

    def build_triton():
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.ones((16, 768), device=dev, dtype=dtype)
            w = torch.ones((768,), device=dev)
            _, mean, invvar = fln.layer_norm_fwd_kernel(x, w, w, 1e-5)
            fln.layer_norm_bwd_kernel(x, x, mean, invvar, w)
            c = torch.ones((64,), device=dev)
            for relu, z in ((True, None), (True, x[:, :64].contiguous()),
                            (False, None)):
                xc = x[:, :64].contiguous()
                fba.bn_act_fwd_kernel(xc, c, c, c, c, z, relu)
                fba.bn_act_bwd_kernel(xc, xc, c, c, c, c, z, relu)
            labels = torch.zeros((16,), device=dev, dtype=torch.int32)
            _, mlse = xent.xentropy_fwd_kernel(x, labels, 0.0)
            xent.xentropy_bwd_kernel(mlse, x, mlse, labels, 0.0)
        torch.cuda.synchronize()

    def build_rule_tiles(scratch, name):
        """csrc/<name>.cu with its tensor-core forward at the rule's tiles
        only (the difference from <name>_nvcc_s is what the tuner's tiles
        cost the build)."""
        src = os.path.join(os.path.dirname(build.__file__), "csrc",
                           f"{name}.cu")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                        "-DAPEX_FLASH_TUNE_TILES=0", "-o",
                        os.path.join(scratch, f"lib{name}.so"), src],
                       check=True, capture_output=True)

    tile_scratch = tempfile.mkdtemp(prefix="chip_smoke_tiles_")
    jobs = {"flash_attention_nvcc_s": lambda: build.load("flash_attention"),
            "flash_attention_sm90_nvcc_s":
                lambda: build.load("flash_attention_sm90"),
            "flash_decode_sm90_nvcc_s":
                lambda: build.load("flash_decode_sm90"),
            "flash_attention_rule_tile_only_nvcc_s":
                lambda: build_rule_tiles(tile_scratch, "flash_attention"),
            "flash_attention_sm90_rule_tile_only_nvcc_s":
                lambda: build_rule_tiles(tile_scratch,
                                         "flash_attention_sm90"),
            "flash_attention_bwd_nvcc_s":
                lambda: build.load("flash_attention_bwd"),
            "flash_attention_bwd_sm90_nvcc_s":
                lambda: build.load("flash_attention_bwd_sm90"),
            "conv_nvcc_s": lambda: build.load("conv"),
            "conv_sm90_nvcc_s": lambda: build.load("conv_sm90"),
            "quant_nvcc_s": lambda: build.load("quant"),
            "quant_sm90_nvcc_s": lambda: build.load("quant_sm90"),
            "triton_s": build_triton}
    if args.was:
        was_build = load_was(args.was, "_build")
        for name in ("flash_attention", "flash_attention_sm90",
                     "flash_decode_sm90", "flash_attention_bwd",
                     "flash_attention_bwd_sm90", "conv", "conv_sm90",
                     "quant", "quant_sm90"):
            if os.path.exists(os.path.join(args.was, "apex_tpu_torch",
                                           "csrc", f"{name}.cu")):
                jobs[f"was_{name}_nvcc_s"] = (
                    lambda n=name: was_build.load(n))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(timed(fn)) for k, fn in jobs.items()}
        build_s = {k: f.result() for k, f in futures.items()}
    shutil.rmtree(tile_scratch, ignore_errors=True)
    print(f"      build: {build_s}", flush=True)
    print(f"      build: the tuner's 16 mma.sync flash forward tiles (4 "
          f"tiles x widths 64, 128 x bf16, fp16) cost "
          f"{build_s['flash_attention_nvcc_s'] - build_s['flash_attention_rule_tile_only_nvcc_s']:.1f} s "
          f"of flash_attention.cu's nvcc, the 8 wgmma tiles past the "
          f"rule's (2 tiles x 2 widths x 2 dtypes) "
          f"{build_s['flash_attention_sm90_nvcc_s'] - build_s['flash_attention_sm90_rule_tile_only_nvcc_s']:.1f} s "
          f"of flash_attention_sm90.cu's (conv and qmm reuse their "
          f"instantiations)", flush=True)
    for name in ("flash_attention", "flash_attention_sm90",
                 "flash_decode_sm90", "flash_attention_bwd",
                 "flash_attention_bwd_sm90", "conv", "conv_sm90", "quant",
                 "quant_sm90"):
        report = [ln for ln in build.ptxas_report(name).splitlines()
                  if "registers" in ln or "spill" in ln]
        print(f"      ptxas {name}: "
              + " | ".join(r.strip() for r in report[:36]), flush=True)

    counters = _kernel_counters()
    ln_cases = layer_norm_cases(fln, dev)          # phase 3
    fa_cases = flash_cases(fa, dev, load_was(args.was,            # 4
                                             "ops.flash_attention")
                           if args.was else None)
    same_as_was = (flash_same_as_was(fa, load_was(args.was,
                                                  "ops.flash_attention"),
                                     dev) if args.was else None)   # 4b
    # the eager sides of phases 20, 5 and 17 run before the first
    # profiler session (phase 6), which leaves host work behind on every
    # later launch of the process (measured below)
    calib = calibrate_gpt2_small(models, quant, dev)               # 17
    build_o4 = o4_setup(models, quant, main_amp, training, calib, dev)
    windows = training_windows(main_amp, imagenet, build_o4)       # 20
    if args.was:
        was_lm = load_was(args.was, "examples.lm.main_amp")
        was_o4 = o4_setup(load_was(args.was, "models"),
                          load_was(args.was, "quant"), was_lm,
                          load_was(args.was, "training"), calib, dev)
        windows["eager_vs_was"] = eager_vs_was({
            "gpt2_small O2": (
                lambda: main_amp.build(main_amp.parse(TRAIN_ARGS)),
                lambda: was_lm.build(was_lm.parse(TRAIN_ARGS))),
            "gpt2_small O4": (lambda: build_o4()[:3],
                              lambda: was_o4()[:3])})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tel_") as d:
        train_tel = training_telemetry(main_amp, training, counters,  # 29
                                       dev, d)
    bert_build = bert_setup(models, training, xent, dev)           # 21
    bert = bert_windows(bert_build, training, counters)
    bert["parity"] = bert_optimizer_parity(bert_build, training)
    bert["tiny_card_vs_cpu"] = bert_tiny_card_vs_cpu(models, training,
                                                     xent, dev)
    imp_bert = imperative_bert(                                    # 22
        bert_build, bert, models, training,
        importlib.import_module("apex_tpu_torch.amp"),
        importlib.import_module("apex_tpu_torch.optimizers"), xent,
        counters, dev)
    gan = dcgan_phase(counters, dev)                               # 23
    model = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0)
    serving = serve_gpt2_small(model, engine_mod, counters, dev,   # 5
                               SERVE_PER_FORWARD)
    if args.was:
        was_models = load_was(args.was, "models")
        was_engine = load_was(args.was, "serving.engine")
        was_model = was_models.gpt2_small(dtype=torch.bfloat16, device=dev,
                                          seed=0)
        serving["was"] = serve_alternated(
            {"this": (model, engine_mod), "was": (was_model, was_engine)},
            dev, "O2")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tel_") as d:
        serve_tel = serving_telemetry(model, engine_mod, dev,         # 30
                                      serving["tokens"], d)
    o4_model = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0,
                                 quant=quant.QuantConfig.frozen(calib))
    o4_serving = serve_gpt2_small(o4_model, engine_mod, counters,  # 17
                                  dev, O4_SERVE_PER_FORWARD,
                                  cache_dtype=torch.int8)
    if args.was:
        was_o4_model = was_models.gpt2_small(
            dtype=torch.bfloat16, device=dev, seed=0,
            quant=load_was(args.was, "quant").QuantConfig.frozen(calib))
        o4_serving["was"] = serve_alternated(
            {"this": (o4_model, engine_mod),
             "was": (was_o4_model, was_engine)},
            dev, "O4", cache_dtype=torch.int8)
    serving.update(prefill_logits(models, dev))
    serving.update(tiny_tokens(models, engine_mod, dev))
    profile_res = where_time_goes(model, engine_mod, dev)          # 6
    if args.was:
        # the other checkout's captured engine, traced the same way
        profile_res["was"] = where_time_goes(was_model, was_engine, dev)
        o4_serving["profile_was"] = where_time_goes(
            was_o4_model, was_engine, dev, cache_dtype=torch.int8)
        del was_model, was_o4_model
    profile_res["eager"] = where_time_goes(
        model, engine_mod, dev, engine_cls=eager_engine_cls(engine_mod))
    o4_serving["profile"] = where_time_goes(o4_model, engine_mod, dev,
                                            cache_dtype=torch.int8)
    o4_serving["profile"]["eager"] = where_time_goes(
        o4_model, engine_mod, dev, cache_dtype=torch.int8,
        engine_cls=eager_engine_cls(engine_mod))
    del model, o4_model
    windows["lm_o2"]["eager_after_profiler_step_ms"] = eager_steps(
        lambda: main_amp.build(main_amp.parse(TRAIN_ARGS)))[1]
    print(f"      gpt2_small O2 eager step after the profiler sessions: "
          f"{windows['lm_o2']['eager_after_profiler_step_ms']:.2f} ms "
          f"(before them {windows['lm_o2']['eager']['step_ms']:.2f})",
          flush=True)
    ln_bwd_cases = layer_norm_bwd_cases(fln, dev)                  # 7
    dq_cases, dkv_cases = flash_bwd_cases(                         # 8
        fa, dev,
        load_was(args.was, "ops.flash_attention") if args.was else None)
    trained = train_gpt2_small(main_amp, counters)                 # 9
    trained["profile"] = trace_training(main_amp,
                                        TRAIN_ARGS + ["--steps", "1"])
    trained.update(training_correctness(models, main_amp, training,
                                        dev))                      # 10
    trained.update(lm_fused_vs_plain_loss(models, main_amp, dev))
    bert["optimizer_traces"] = optimizer_traces(bert_build, main_amp,  # 21
                                                models, training, dev)
    del bert_build
    bn_fwd_cases, bn_bwd_cases = bn_epilogue_cases(fba, dev)       # 11
    xent_fwd_cases, xent_bwd_cases = xentropy_cases(xent, dev)     # 12
    resnet = train_resnet50(imagenet, counters)                    # 13
    resnet["profile"] = trace_training(imagenet,
                                       IMAGENET_ARGS + ["--prof", "1"],
                                       kind_tables().RESNET_KINDS)
    resnet["no_pallas_conv"] = train_resnet50(imagenet, counters,  # 13b
                                              pallas_conv=False)
    resnet["no_pallas_conv"]["profile"] = trace_training(
        imagenet, IMAGENET_ARGS + ["--prof", "1", "--no-pallas-conv"],
        kind_tables().RESNET_KINDS)
    resnet["bucketed"] = resnet50_bucketed(imagenet, counters)      # 13c
    resnet.update(resnet_correctness(imagenet, training, dev))     # 14
    conv = conv_cases(cv, fba, dev,                                # 15
                      load_was(args.was, "ops.conv") if args.was else None)
    sites = conv_sites(cv, dev,                                    # 15b
                       load_was(args.was, "ops.conv") if args.was else None)
    qmm = qmm_cases(qk, dev, load_was(args.was, "quant.kernels")   # 16
                    if args.was else None)
    o4_serving.update(o4_prefill_checks(models, quant, calib, dev,  # 17
                                        engine_mod))
    o4_serving.update(tiny_tokens_o4(models, quant, engine_mod, dev))
    o4_serving["bf16_kv_o2"] = {k: serving[k] for k in (
        "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms",
        "tpot_p99_ms", "kv_bytes_per_token", "max_memory_allocated_bytes")}
    o4_serving["vs_o2"] = o4_vs_o2(dict(serving, profile=profile_res),
                                   o4_serving)
    o4_train = train_o4(build_o4, counters)                        # 18
    o4_train["o2"] = {k: trained[k] for k in (
        "step_ms_median_3_10", "tokens_per_s", "max_memory_allocated_bytes")}
    db2, db2_launches = db2_cases(                                 # 19
        fa, counters, dev,
        load_was(args.was, "ops.flash_attention") if args.was else None)
    checkpoint = importlib.import_module("apex_tpu_torch.checkpoint")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        state_input = {"resnet_directory": resnet50_directory_resume(  # 24
            imagenet, counters, tmp, resnet["step_ms_median_3_10"])}
        state_input["lm_resume"] = lm_checkpoint_resume(               # 25
            main_amp, checkpoint, counters, tmp)
        state_input["hotswap_serving"] = hotswap_serving(              # 26
            models, engine_mod,
            importlib.import_module("apex_tpu_torch.convert"), checkpoint,
            counters, dev, os.path.join(tmp, "lm_b"), tmp)
        gc.collect()
        torch.cuda.empty_cache()
        data_parallel = {"ddp_nccl": ddp_nccl(counters, tmp)}           # 27
        data_parallel["ddp_gloo"] = ddp_gloo(counters, tmp, dev)       # 28
        t31 = time.perf_counter()
        profiling = prof_stages(main_amp, imagenet, models,            # 31
                                engine_mod, counters, windows, dev, tmp)
        profiling["phase_s"] = time.perf_counter() - t31
        print(f"      phase 31: {profiling['phase_s']:.1f} s", flush=True)
        t32 = time.perf_counter()
        tuned = tune_phase(main_amp, imagenet, models, engine_mod,    # 32
                           quant, calib, counters, dev,
                           profiling["lm"]["ledger_blocks"],
                           o4_serving["tokens"], tmp)
        tuned["phase_s"] = time.perf_counter() - t32
        print(f"      phase 32: {tuned['phase_s']:.1f} s", flush=True)
        t33 = time.perf_counter()
        gen = generate_phase(models, engine_mod, counters, dev)        # 33
        gen["phase_s"] = time.perf_counter() - t33
        t34 = time.perf_counter()
        rnn = rnn_phase(dev)                                           # 34
        rnn["phase_s"] = time.perf_counter() - t34
        t35 = time.perf_counter()
        sharding = {"zero1_nccl": zero1_nccl(models, main_amp,         # 35
                                             training, counters, tmp, dev)}
        sharding["gloo"] = shard_gloo(tmp)
        sharding["phase_s"] = time.perf_counter() - t35
        print(f"      phases 33-35: {gen['phase_s']:.1f} s, "
              f"{rnn['phase_s']:.1f} s, {sharding['phase_s']:.1f} s",
              flush=True)
        t36 = time.perf_counter()
        seq = {"offsets": ring_kernel_offsets(fa, dev)}                # 36
        gc.collect()
        torch.cuda.empty_cache()
        seq["mesh_nccl"] = mesh_nccl(models, main_amp, training,      # 37
                                     counters, tmp, dev)
        gc.collect()
        torch.cuda.empty_cache()
        seq["gloo"] = seq_gloo(tmp)                            # 36b-c, 37c
        seq["phase_s"] = time.perf_counter() - t36
        print(f"      phases 36-37: {seq['phase_s']:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    paths = {"serving": serving["launches"], "training": trained["launches"],
             "resnet_training": resnet["launches"],
             "o4_serving": o4_serving["launches"],
             "o4_training": o4_train["launches"],
             "bias_grad": db2_launches,
             "bert_training": bert["launches"],
             "imperative_bert": imp_bert["launches"],
             "dcgan": gan["launches"],
             "resnet_directory": state_input["resnet_directory"]["launches"],
             "lm_resume": state_input["lm_resume"]["launches"],
             "hotswap_serving": state_input["hotswap_serving"]["launches"],
             "ddp_nccl": data_parallel["ddp_nccl"]["launches"],
             "ddp_gloo": data_parallel["ddp_gloo"]["launches"],
             "generate": gen["float32"]["launches"],
             "zero1_lm": sharding["zero1_nccl"]["launches"],
             "ring_lm": seq["gloo"].get("ring_lm_launches", {}),
             "mesh_zero3": seq["mesh_nccl"]["zero3"]["launches"]}

    decode_cases = [c for c in fa_cases if c["route"] == "decode"]
    decode_main = next(c for c in decode_cases
                       if c["case"] == "decode b8 tq1 tk1024")

    def entry(name, route, source, replaces, cases, main_case, path):
        rep = cases[main_case]
        launches = {p: counts.get(name) for p, counts in paths.items()}
        return dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[path],
            launches_by_path={k: v for k, v in launches.items()
                              if v is not None},
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            shape=rep["case"], cases=cases)

    kernels = [
        entry("layer_norm_fwd", "triton",
              "apex_tpu_torch/normalization/fused_layer_norm.py",
              "apex_tpu/normalization/fused_layer_norm.py:206", ln_cases, 0,
              "serving"),
        entry("layer_norm_bwd", "triton",
              "apex_tpu_torch/normalization/fused_layer_norm.py",
              "apex_tpu/normalization/fused_layer_norm.py:223", ln_bwd_cases,
              0, "training"),
        # the serving path's prefill forwards run the wgmma kernel, its
        # decode steps the decode kernel (its own row below)
        dict(entry("flash_attention_fwd", "cuda",
                   "apex_tpu_torch/csrc/flash_attention_sm90.cu",
                   "apex_tpu/ops/flash_attention.py:238", fa_cases, 0,
                   "serving"),
             sources=["apex_tpu_torch/csrc/flash_attention_sm90.cu",
                      "apex_tpu_torch/csrc/flash_decode_sm90.cu",
                      "apex_tpu_torch/csrc/flash_attention.cu"],
             routes=serving["flash_routes"]),
        # the decode route of the same wrapper: its launches are the
        # serving paths' decode routes
        dict(name="flash_attention_fwd_decode", route="cuda",
             source="apex_tpu_torch/csrc/flash_decode_sm90.cu",
             replaces="apex_tpu/ops/flash_attention.py:238",
             launches=serving["flash_routes"]["decode"],
             launches_by_path={
                 "serving": serving["flash_routes"]["decode"],
                 "o4_serving": o4_serving["flash_routes"]["decode"],
                 "hotswap_serving": state_input["hotswap_serving"][
                     "flash_routes"]["decode"],
                 "serving_telemetry": serve_tel["flash_routes"]["decode"]},
             max_abs_err=max(c["max_abs_err"] for c in decode_cases),
             ms=decode_main["ms"], plain_ms=decode_main["plain_ms"],
             bound_ms=decode_main["bound_ms"],
             bound_by=decode_main["bound_by"],
             library_ms=decode_main["library_ms"],
             shape=decode_main["case"], cases=decode_cases),
        # the training path's dQ and dK/dV run the wgmma kernels; fp32,
        # widths 16, 32 and above 128 the kernels of flash_attention_bwd.cu
        dict(entry("flash_attention_bwd_dq", "cuda",
                   "apex_tpu_torch/csrc/flash_attention_bwd_sm90.cu",
                   "apex_tpu/ops/flash_attention.py:440", dq_cases, 0,
                   "training"),
             sources=["apex_tpu_torch/csrc/flash_attention_bwd_sm90.cu",
                      "apex_tpu_torch/csrc/flash_attention_bwd.cu"],
             routes=trained["flash_bwd_routes"]["dq"]),
        dict(entry("flash_attention_bwd_dkv", "cuda",
                   "apex_tpu_torch/csrc/flash_attention_bwd_sm90.cu",
                   "apex_tpu/ops/flash_attention.py:478", dkv_cases, 0,
                   "training"),
             sources=["apex_tpu_torch/csrc/flash_attention_bwd_sm90.cu",
                      "apex_tpu_torch/csrc/flash_attention_bwd.cu"],
             routes=trained["flash_bwd_routes"]["dkv"]),
        # the BN rows show the stage-4 downsample_bn case, the one with a
        # library call computing the same function; every case is in
        # --out
        entry("bn_act_fwd", "triton",
              "apex_tpu_torch/normalization/fused_bn_act.py",
              "apex_tpu/normalization/fused_bn_act.py:148", bn_fwd_cases, 2,
              "resnet_training"),
        entry("bn_act_bwd", "triton",
              "apex_tpu_torch/normalization/fused_bn_act.py",
              "apex_tpu/normalization/fused_bn_act.py:161", bn_bwd_cases, 2,
              "resnet_training"),
        entry("xentropy_fwd", "triton",
              "apex_tpu_torch/contrib/xentropy/__init__.py",
              "apex_tpu/contrib/xentropy/__init__.py:109", xent_fwd_cases,
              2, "resnet_training"),
        entry("xentropy_bwd", "triton",
              "apex_tpu_torch/contrib/xentropy/__init__.py",
              "apex_tpu/contrib/xentropy/__init__.py:123", xent_bwd_cases,
              2, "resnet_training"),
        # the conv rows show the stage-1 3x3 case; every case is in --out.
        # The non-stem bf16 sites run the wgmma kernels, the stem's
        # forward and wgrad conv.cu's mma.sync kernels
        dict(entry("conv_fwd", "cuda", "apex_tpu_torch/csrc/conv_sm90.cu",
                   "apex_tpu/ops/conv.py:267", conv["conv_fwd"], 1,
                   "resnet_training"),
             sources=["apex_tpu_torch/csrc/conv_sm90.cu",
                      "apex_tpu_torch/csrc/conv.cu"],
             routes=resnet["conv_routes"]["conv_fwd"]),
        dict(entry("conv_dgrad", "cuda", "apex_tpu_torch/csrc/conv_sm90.cu",
                   "apex_tpu/ops/conv.py:375", conv["conv_dgrad"], 0,
                   "resnet_training"),
             sources=["apex_tpu_torch/csrc/conv_sm90.cu",
                      "apex_tpu_torch/csrc/conv.cu"],
             routes=resnet["conv_routes"]["conv_dgrad"]),
        dict(entry("conv_wgrad", "cuda", "apex_tpu_torch/csrc/conv_sm90.cu",
                   "apex_tpu/ops/conv.py:397", conv["conv_wgrad"], 1,
                   "resnet_training"),
             sources=["apex_tpu_torch/csrc/conv_sm90.cu",
                      "apex_tpu_torch/csrc/conv.cu"],
             routes=resnet["conv_routes"]["conv_wgrad"]),
        # the qmm row shows the prefill 768->3072 case, the db2 row the
        # causal one; every case is in --out
        dict(entry("qmm", "cuda", "apex_tpu_torch/csrc/quant_sm90.cu",
                   "apex_tpu/quant/kernels.py:147", qmm, 1, "o4_serving"),
             sources=["apex_tpu_torch/csrc/quant_sm90.cu",
                      "apex_tpu_torch/csrc/quant.cu"],
             routes=o4_serving["qmm_routes"]),
        entry("flash_attention_bwd_db2", "cuda",
              "apex_tpu_torch/csrc/flash_attention_bwd.cu",
              "apex_tpu/ops/flash_attention.py:562", db2, 1, "bias_grad"),
    ]
    elapsed = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(gpu=smi, torch=torch.__version__, build=build_s,
                           kernels=kernels, serving=serving,
                           profile=profile_res, training=trained,
                           resnet_training=resnet, conv_sites=sites,
                           flash_same_as_was=same_as_was,
                           o4_serving=o4_serving,
                           o4_training=o4_train,
                           training_windows=windows,
                           bert_training=bert,
                           imperative_bert=imp_bert, dcgan=gan,
                           state_and_input=state_input,
                           data_parallel=data_parallel,
                           telemetry={"training": train_tel,
                                      "serving": serve_tel},
                           profiling=profiling, tune=tuned,
                           generate=gen, rnn=rnn, sharding=sharding,
                           sequence_and_mesh=seq,
                           o4_calibration=calib.state_dict(),
                           elapsed_s=elapsed, failures=FAILURES), f,
                      indent=1)
    print(f"      elapsed {elapsed:.1f} s", flush=True)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{k: v for k, v in e.items()
                                   if k != "cases"} for e in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
