"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--requests N] [--seed S] [--out smoke.json]

Drives ``tpuic_torch``'s serving and training paths on the card and exits
non-zero at the first phase that fails:

1. device — ``nvidia-smi`` name and power limit, torch/CUDA versions.
   Refuses to run without CUDA.
2. build  — every kernel source in ``tpuic_torch/kernels/csrc`` compiled
   by ``nvcc`` (one process per source, started together), while two
   forked processes write the synthetic folders of ``train`` and
   ``inception-train``; both end before anything is timed.
3. kernel — the fused conv+BN+ReLU kernel (K3) at every distinct conv
   shape a ResNet-50 forward at 224x224 launches, plus the space-to-depth
   stem, at batch 8 and at batch 32 (the engine's largest bucket): held
   against its plain PyTorch version (float32, TF32 off, atol/rtol 1e-4;
   bf16 x with float32 w at every shape, atol/rtol 1e-2, two bf16 ulps of
   the output), and timed per call from Python as every kernel is
   (``ms``), and on the card alone (``device_ms``: the card sleeps while
   the host enqueues the calls, so launch cost stays out), beside the
   plain version, one cuDNN call that
   computes the same float32 function (TF32 off; timed only, the port
   never calls it), the same call with TF32 on (a less exact function, for
   information), and the bound: FLOPs at the rate of the kernel's 3xTF32
   products (a third of the TF32 peak) or bytes over HBM bandwidth,
   whichever is larger, with the float32 CUDA-core bound beside it.  Each
   row names its plan (block height, K slices, gather).  Then the bits: a
   row at batch 1 must equal the same row inside batch 32 at a split-K
   shape, the bits must not move with the TF32 flags, and the plain
   version on TF32-rounded inputs must fall outside 1e-4 (so the check
   tells one TF32 pass from 3xTF32).  bf16 x (the serve ladder's bf16
   rung) is timed per shape too, beside its plain version and one cuDNN
   bf16 convolution of the same x with the folded weights in bf16 and the
   earlier bf16 design (the mma.sync build, at the shapes the wgmma build
   now runs), with bf16 w as the bf16 rung folds it (held too), its bound
   at the rate of its products (one bf16 wgmma product, or two TF32 MMAs
   in the mma.sync build), and summed per forward.
4. model  — ``create_model("resnet50", 1000, dtype="float32",
   fused_conv_bn=True)`` with seeded synthetic weights: its logits at
   batch 4 against the same weights through the unfused cuDNN branch (TF32
   off, atol/rtol 1e-3: float32 sums in another order through 53 layers),
   and exactly 53 kernel launches per forward.  Then the unfused branch
   through the engine's ``make_forward`` under torch's default flags: a
   row's probabilities at batch 1 and inside batch 32 agree within 1e-5.
5. serve  — ``InferenceEngine`` (uint8 in, normalized in the forward,
   buckets 1/8/32, one CUDA graph per bucket captured at warmup, the
   device memory the graphs hold reported) answering a few hundred
   requests of 1-8 images from eight closed-loop client threads: every
   future resolves with the right shape, a sample matches a direct
   forward (1e-5), and the kernel launches 53 times per device call
   during the run (each replay adds the launches its graph captured).
   Then at every bucket a graph replay against an eager forward of the
   same batch (the same bits, or within 1e-6, as reported), and a batch-8
   device call replayed and eager, timed from Python, on the card alone
   and as host cost per call.  The requests' numpy rows reach the card
   through two page-locked staging buffers a bucket (their bytes are in
   the graph-memory line).
6. swap   — the engine's hot swap through the graphs: ResNet-50 weights A
   (``[model]``'s) served to eight closed-loop clients and swapped to B
   (another seed) after a third of SWAP_REQUESTS; traffic goes on until
   a third more are submitted after the swap returned.  Every answer is A's
   or B's within 1e-5, every one submitted after the swap B's, and the
   kernel launches 53 times per device call and per standby capture.  Then
   three swaps with traffic stopped (A, B, A): each bucket's replay
   launches 53 kernels and equals an eager forward of the weights just
   swapped in bit for bit (K3's folded weights are refolded in place), and
   the graph memory and allocated bytes after the fourth swap equal those
   after the second.  Each swap's duration, captures and the host time it
   held the batcher, and the latency of requests that span the flip, are
   printed.
7. admission — priorities, quotas and deadline shedding: a ResNet-50
   engine with queue 32 and an ``AdmissionController`` quota on a flood
   tenant, four threads flooding ``low`` requests of 8 images and one
   thread sending ``high`` requests with ``deadline_ms`` (every fifth too
   tight to meet) for ADMISSION_S: accepted + rejected == offered, the
   causes queue_full, quota and deadline all seen, no ``high`` request
   evicted, ``high``'s p50 latency below ``low``'s.
8. xent   — the fused cross-entropy forward and backward kernels (K1) at
   [128, 1000] and [128, 7], label smoothing 0 and 0.1, against their
   plain versions (rtol 1e-5 / atol 1e-6: float32 row sums in another
   order), plus class-weighted, masked cases with an out-of-range label
   at C = 1, 7, 1000 and 21843 (w exact); the earlier design
   (``cross_entropy_bench``) within the same tolerance; the backward's
   bits for every row of a batch of 128 equal to that row's alone (C = 1,
   7, 1000, 21843: a row is one team of threads, whatever its alignment)
   and equal on two calls; timed per call from Python beside the plain
   versions, the bound and one ``F.cross_entropy`` call (forward for K1f,
   forward + backward for K1b), and on the card alone (the median of 5
   replays of a CUDA graph of 100 calls) for K1f, K1b, both their earlier
   designs and ``F.cross_entropy``'s forward and forward + backward (its
   backward alone reported as the difference of the two).
9. optim  — the fused LARS and LAMB update kernels (K2) over the whole
   ResNet-50 + head parameter list (167 leaves, flax-default init, so the
   zero BN biases take the trust = 1 branch), against their plain versions
   (rtol 1e-5 / atol 1e-7: the trust-ratio norms are summed in another
   order), the same bits on two runs, and LAMB's debias factors (computed
   by the kernel from the device count) within 1 ulp of the plain
   version's; timed per call from Python and on the card alone (the
   median of 5 replays of a CUDA graph of 100 back-to-back updates, with
   the replays' spread), and the wrappers' host cost per call (``host_ms``,
   the median of 5 windows of 20 calls enqueued without a synchronise),
   beside the plain versions and the bound (no single PyTorch call
   computes a LARS or LAMB update).  Each also through
   its earlier design (``optimizer_update_bench``), held and timed the
   same way.
9b. pack   — the default data path (``tpuic``'s ``pack`` and ``native``):
   the native C++ core's build on this machine (or its compiler's first
   error line, when PIL decodes instead), then a pack of a tree of
   ``train``'s PNGs (PACK_PER_CLASS a class, linked), PACK_JPEGS JPEG
   copies a class and one PNG cut to half its bytes: its rate in img/s,
   what decoded the rows, and the truncated file packed as another sample
   of its class under that sample's id and label.  Then the decode loader
   (host threads), the streaming packed loader (uint8 rows to the card,
   augmented there) and the resident one (the dataset on the card, a
   batch ships its indices) at ``train``'s batch over PACK_EPOCHS
   augmented epochs: images within PACK_TOL (1e-5, ``tpuic``'s), labels,
   masks and ids equal; each loader's bytes to the card a batch and ms a
   batch alone, and the resident prep's device ms beside its bytes bound.
   Every training phase after it (and predict) runs on the packed,
   resident path; each prints its data-wait share (and the share without
   the epoch's first batch), and ``data-wait`` lists them all after
   ``timing``.  ``vit-train``'s bf16 arm and ``inception-train``'s
   float32 arm run again on the decode path (``decode_path``): step ms
   and data-wait beside the packed path's, in the same run.
10. train  — ``Trainer`` on a synthetic 224x224 ImageFolder written by
   ``tpuic_torch.data.synthetic``: ResNet-50, float32, batch 128, LARS lr
   4.8 / wd 1e-4 / 5 warmup epochs of a 90-epoch schedule, label smoothing
   0.1, no class weights, fused loss and fused optimizer, for 12 steps, then
   one val pass through the conv+BN+ReLU kernel.  Every launch count is set
   to 0 before the run and read after it: K1 forward and backward launch
   once per step, K2 LARS once per step, K3 53 times per val forward.
   Then 3 steps at a constant lr of 0.48 from one initial state on the
   same 3 batches, once through the kernels and once through the plain
   loss and plain LARS, TF32 off and cuDNN deterministic: the per-step
   losses agree within rtol 1e-3.  Last, a 3-step LAMB run at
   batch 32 through the Trainer, counted the same way, puts K2 LAMB on the
   path.
11. ckpt   — the checkpoint (``tpuic_torch/checkpoint/manager.py``) with
   ``train``'s configuration: a ``Trainer`` takes 3 steps and saves
   ``best`` and ``latest``; a fresh ``Trainer`` restores them, and every
   parameter, BN buffer and K2 optimizer-state tensor must equal the saved
   one bit for bit; the next step's loss on one batch, cuDNN
   deterministic, must equal the uninterrupted trainer's exactly; with one
   byte of ``latest``'s payload flipped the restore must fall back to
   ``best``, bit for bit.  The payload's bytes and the host and disk
   seconds to snapshot, commit and restore are reported.
11b. ddp   — data-parallel training through ``python -m tpuic_torch.train``
   started with the ``TPUIC_*`` trio, at ``train``'s recipe (ResNet-50,
   224 px, 1000 classes, LARS 4.8 with its warmup, global batch 128,
   fused loss and optimizer, ``--fused-conv-bn``, and section 4's mixup
   0.2, CutMix 1.0 and drop-path 0.1, which ResNet-50 takes with no
   drop-path site) for one epoch of
   DDP_STEPS steps on ``train``'s first images, then its val pass: arm 1 a
   one-process NCCL group (DDP around the model); arm 2 two processes
   sharing the card over gloo with CUDA tensors (NCCL refuses two ranks on
   one device), batch 64 each, SyncBN's and the loss normalizer's
   all-reduces and the mix partners' all_gather between them.  Each
   process counts its own launches from 0 at ``fit``: K1 forward and
   backward twice a step (the mixed loss), K2 LARS once a step, K3 53
   times per val forward.  Arm 1's per-step global losses against the
   one-process ``Trainer``'s on the same batches, and arm 2's against arm
   1's, within rtol 1e-3 (TRAIN_LOSS_RTOL); the step ms of each.  Then the
   MoE arm: vit-tiny-moe at 32 px (4 experts in block 1) with drop-path
   0.1, flash attention, the fused loss and LAMB, through the same three
   runs (the one-process ``Trainer``, one NCCL process, two gloo ranks):
   the drop-path masks and the aux loss's one all-reduce a step across
   ranks, each arm's losses within TRAIN_LOSS_RTOL of the one-process
   run's, and every process's launches (K1 and K2b once a step, K4 2 a
   step and 2 a val forward).  The two one-process ``Trainer``s train
   first, alone on the card; then the four arms' six processes run at
   once (their process starts overlap; their step ms share the card).
12. serve-cli — ``python -m tpuic_torch.serve --model auto`` as a
   subprocess on ``ckpt``'s ResNet-50 checkpoint: 48 image files of the
   synthetic folder over stdin JSONL, each record's top-5 probabilities
   within 1e-5 of a direct forward of the same decoded pixels; then a
   ``--listen`` server (started beside the stdin server, as is
   ``swap-cli``'s): ready file, a ping answered with the model's
   digest, requests by path and by b64 array, a burst and SIGTERM, after
   which it exits 0 with every request answered.
13. swap-cli — ``{"op": "swap"}`` lines through a ``--listen`` server on
   that checkpoint: a swap to ``synthetic_seed`` 1 with requests in flight (a
   ``swap_result`` of generation 1; the next pong and the ready file carry
   its digest), a swap back to the checkpoint by ``ckpt_dir`` (answers
   equal a direct forward within 1e-5, the digest ``serve-cli``'s), a swap
   from a copy with one byte flipped (a typed ``swap_corrupt`` record, the
   digest and generation unchanged), then SIGTERM: exit 0, every request
   answered.
14. predict — ``python -m tpuic_torch.predict``'s ``main`` over the val
   fold from that checkpoint's ``best`` track at the ``Trainer``'s val
   batch: its accuracy equals the ``Trainer``'s val accuracy for the save
   exactly, every batch reaches the engine as a tensor on the card, and
   K3 launches 53 times per device call.
15. attn  — the flash-attention kernels (K4: forward, dq, dk/dv) at the
   ViT-B/16 shapes [8, 197, 12, 64] and [64, 197, 12, 64] and
   ViT-S/16-MoE's [64, 197, 6, 64] (its summary under MOE_SHAPE_KEY in
   each K4 row), on strided
   q/k/v views of one qkv projection, against their plain versions
   (float32, TF32 off, atol/rtol 1e-4; bfloat16 at 1e-2); in float32 the
   forward and the backward again with TF32 allowed, which must give the
   same bits (they are 3xTF32 whatever the flag says), and the plain
   forward and backward in single-pass TF32, which must each fall outside
   the 1e-4 tolerance (so the check tells TF32 from 3xTF32); plus a
   ``valid_len`` case (50 of 64 keys) and a
   fully masked case (o = 0, lse = the sentinel, for sentinels 0 and
   -1e30), in float32 and in bf16, plus [2, 300, 12, 64] (bf16's
   forward refills its key ring there).  bf16 at D = 64 runs K4f's TMA and
   wgmma build (``flash_fwd_sm90.cu``); the earlier mma.sync bf16 forward
   is held and timed beside it.  Each kernel is timed beside its plain
   version and one
   ``F.scaled_dot_product_attention`` call (timed only): the forward
   beside K4f; SDPA's backward alone (from one forward outside the timed
   calls) and its forward + backward beside the sum of dq and dk/dv, as
   no one call computes either alone; the forward and SDPA's also on the
   card alone.  The bound is at the rate of the products each kernel
   issues, 3xTF32 or bf16 MMAs (the float32 CUDA-core bound beside it).
16. vit   — ``create_model("vit-b16", 1000, dtype="float32",
   attention="flash")`` with seeded synthetic weights: its logits at batch
   4 against the same weights under ``attention="dense"`` (TF32 off,
   atol/rtol 1e-3), and exactly 12 K4 forward launches per forward.
17. vit-serve — the engine serving that model as ``serve`` serves
   ResNet-50 (graphs, their memory, graph against eager, the batch-8
   times), under torch's default flags: 12 K4 forward launches per device
   call.
18. vit-swap — ``swap``'s traffic and checks on that model (B another
   seed), with one stopped swap: 12 K4 forward launches per device call.
19. vit-train — ``Trainer`` on the ImageFolder of ``train``: ViT-B/16 with
   the repo's ViT recipe (recipes/README.md, section 4: AdamW lr 3e-4, wd
   0.05, 10 warmup epochs of 300, label smoothing 0.1, clipping at 1.0,
   batch 64), ``attention="flash"`` and the fused loss, for 12 steps, then
   one val pass, in float32 and in bf16 (``compute_dtype`` bf16: K4's bf16
   kernels forward and backward; a forward hook holds every attention
   block's input and output to bfloat16).  Launches per arm: K4 forward 12
   per step and 12 per val forward, dq and dk/dv 12 per step, K1 once per
   step.  The bf16 arm's logged losses (steps 4, 8, 12) lie within
   BF16_LOSS_RTOL (2e-2) of the float32 arm's.  Then 3 steps from one
   state through the kernels, through dense attention and the plain loss
   (TF32 off: the per-step losses agree within rtol 1e-3), and through the
   kernels in bf16 (within BF16_LOSS_RTOL of the float32 kernels').  Then
   the recipe arm: section 4's regularisers (mixup 0.2, CutMix 1.0, random
   erasing 0.25, drop-path 0.1, EMA 0.9999) in bf16 for 12 steps and a val
   pass on the EMA weights: K4 as above, K1 twice a step (the mixed loss's
   two terms), step ms beside the plain-recipe bf16 arm's; 3 steps through
   the kernels against 3 through dense attention and the plain loss with
   the same draws (float32, TF32 off, rtol 1e-3); and two steps with
   ``--remat --remat-policy dots`` against two without: losses and
   gradient norms within REMAT_RTOL (1e-6, stated before the first run),
   K4's forward 24 a step under remat (12 run again in the backward).
   accum (inside ``train``) — the same ResNet-50 LARS recipe at batch 64
   with ``grad_accum_steps`` 2 for 4 micro-steps through the kernels and
   through the plain loss and LARS: the parameters still on the
   micro-steps between updates, within ACCUM_RTOL (1e-3) of the plain
   arm's after each update, K2a launched on every micro-step with its gate
   open on 2.
   effnet-train — recipes/README.md section 3: EfficientNet-B0 at 224 px,
   SGD 0.4, bf16, batch 128, stochastic depth 0.2 (9 draw sites), the
   fused loss, 12 steps and a val pass: step ms, data-wait share, K1 once
   each way a step, every convolution of the first step bfloat16; 3 steps
   through K1 against 3 through the plain loss with the same draws
   (float32, TF32 off, rtol 1e-3).
20. ladder — the serve dtype ladder (``tpuic_torch.quant``: fp32, bf16,
   int8) for ResNet-50 (224 px, K3 on every rung), InceptionV3 (299 px,
   no kernel) and ViT-B/16 (224 px, K4f on every rung, its bf16 build on
   the bf16 rung), each at full width with synthetic weights: the accuracy
   gate (each rung's top-1 agreement with fp32 on
   ``quant.eval_images(128)`` at least 1 - DEFAULT_EPSILON, a corrupted
   int8 rung below it), each rung's batch-1 row against batch 32 within
   RUNG_ROW_TOL (stated before the first run: fp32 and int8 1e-5, bf16
   1e-2) wherever the engine runs the rung at every bucket (a bf16 rung
   on cuDNN's convolutions, InceptionV3's, runs at the largest bucket
   only: its rows are reported, and the same for EfficientNet-B3 and an
   unfused ResNet-50), each rung's weight bytes (int8's quantized leaves
   beside their float32 bytes), then one engine with a graph per (rung,
   bucket): per rung ``[serve]``'s client mix in LADDER_WINDOWS windows
   (images/s of each and their median and spread, p50/p99, spans, graph
   pool by rung, launches per device call, answers within RUNG_SERVE_TOL
   of the rung's direct forward) and LONE_REQUESTS one-image requests one
   at a time (the bucket they ride, latency, device span); the bf16
   rung's lone requests again at the serve CLI's default buckets (1, 8,
   32, 128); for ResNet-50 one swap of the whole ladder under mixed
   traffic, every answer the old or the new ladder's and every one
   submitted after the swap the new one's.
21. serve-cli-ladder — ``python -m tpuic_torch.serve --serve-dtypes
   fp32,bf16,int8`` on ``ckpt``'s checkpoint: its start gate's lines, and
   CLI_IMAGES image files over stdin naming the rungs in turn with
   ``serve_dtype``, each record within its rung's bound of the rung's
   direct forward.

22. inception — ``create_model("inceptionv3", 1000, dtype="float32")`` at
   299x299 with seeded synthetic weights, eval forward: a row's
   probabilities at batch 1 and inside batch 32 agree within 1e-5
   (``make_forward``, TF32 off), then ``serve``'s engine, clients and graph
   checks at 299 px.  No kernel lies on this forward (K3 is ResNet-only, as
   in ``tpuic``): every launch count must stay 0.
23. inception-train — the reference's recipe (InceptionV3 with its aux
   head, 299 px, Adam lr 0.5e-5, the 7 class weights) on a synthetic
   7-class ImageFolder at batch 32 with the fused loss, through
   ``Trainer``: 12 steps in float32 and 12 in bf16 (``compute_dtype``
   bf16), each launching K1 forward and backward twice a step (main and
   aux logits), master weights and Adam moments float32 after, and every
   convolution of the first step returning the arm's dtype (a forward
   hook); then 3 steps from one state through the kernels and through the
   plain loss (float32, TF32 off: loss rtol 1e-3), and through the
   kernels in bf16 (loss within BF16_LOSS_RTOL, 2e-2, of the float32
   kernels', every convolution's output bfloat16).
24. ref-cli — the reference's own command, ``python -m tpuic_torch.train
   --datadir D --epochs 1 --ckpt-dir C``, as a
   subprocess with its defaults (InceptionV3, bfloat16, Adam, batch 4, the
   class weights; the plain loss, as ``--fused-loss`` is off) on 7 classes
   at 299 px, 8 train and 4 val images a class: exit 0, ``best`` and
   ``latest`` written.  Predict scores ``best`` in float32, as the serve
   CLI serves every checkpoint; the ``Trainer``'s own bf16 forward,
   through ``run_predict``, must score it as the ``Trainer`` did, and the
   two may disagree on at most REF_PREDICT_LIMIT (2) of the 28 images.
25. digits — the port's first real-data run: the
   handwritten digits written from ``tpuic_torch/data/digits_split.npz``
   (1,438 train, 359 val), the train CLI's ``main`` with the recipe of
   ``perf/convergence_digits.json`` (``resnet18-cifar``, 32 px, batch 128,
   SGD lr 0.05, 3 warmup epochs of a 40-epoch cosine, wd 5e-4, no
   augmentation, no class weights, the fused loss), in float32 (its bf16
   arm was cut when ``digits-vit`` joined the run: the time limit):
   per-epoch val top-1, the best at least DIGITS_BOUND (350/359 = 97.49%,
   stated before the first run), K1 once forward and once backward a
   step, each convolution of the first step float32.  Predict scores
   ``best`` in float32 through K3, as served: it may disagree with the
   ``Trainer``'s own forward on at most DIGITS_PREDICT_LIMIT (3) images,
   and its accuracy equals the ``Trainer``'s.
   digits-vit — ``tpuic``'s ViT digits run (``tpuic_vit-tiny``: vit-tiny,
   32 px, batch 128, Adam wd 5e-4, lr 1e-3 with 3 warmup epochs of a
   120-epoch cosine, mixup 0.2, CutMix 0.5, no augmentation, float32) with
   ``--attention flash``: its best at least DIGITS_VIT_BOUND (305/359 =
   84.96%, stated before the first run), K1 twice a step, K4 2 a step and
   2 a val forward; predict within DIGITS_PREDICT_LIMIT images of the
   ``Trainer``'s forward; then 3 epochs with ``--ema-decay 0.99``, whose
   ``best`` predict and the serve CLI score within 1e-5 of a direct
   forward of its ``ema_params``.  Both digits phases print their
   seconds an epoch and its parts (steps, loader wait, val pass,
   checkpoint saves).
26. effnet-serve — ``inception``'s checks and serving for EfficientNet-B3
   at 300x300, 1000 classes, seeded synthetic weights.
27. moe-train — ViT-S/16-MoE (hidden 384, 12 blocks, 6 heads, 8 experts
   in blocks 1, 3, ..., 11, capacity 31 of 197 tokens) at 224 px, batch
   64, through ``python -m tpuic_torch.train``'s ``main``: flash
   attention, the fused loss, LAMB through K2b, drop-path 0.1, one epoch
   of ``train``'s folder (24 steps) and its val pass, in float32 and in
   bf16, with ``--metrics-jsonl``, ``--trace-dir`` (a window forced by
   ``TPUIC_TRACE`` over steps 2-4), ``--trace-analyze``, ``--prom-dump``
   and ``--slo``.  Launches: K4 12 a step and 12 a val forward (dq and
   dk/dv 12 a step), K1 and K2b once a step.  Printed: the logged aux
   losses, each MoE block's expert token shares and dropped share on the
   first batch under the trained weights, the step ms (median over the
   steps outside the window), goodput and the window's op-class
   waterfall; then 3 steps through the kernels against 3 through dense
   attention, the plain loss and the plain LAMB on the same batches
   (float32, TF32 off, rtol 1e-3).
28. moe-serve — ViT-S/16-MoE (synthetic weights, flash attention) served
   on the fp32 and bf16 rungs by one engine: a row alone against the same
   row in a request of 32 within RUNG_ROW_TOL (fp32: [vit-serve]'s 1e-5;
   routing groups are per image), MOE_REQUESTS closed-loop requests a
   rung (images/s, p50/p99), answers within RUNG_SERVE_TOL of the rung's
   direct forward, K4f 12 times a device call.
29. telemetry — InceptionV3 (bf16, as the reference trains) at batch 32,
   two epochs of TEL_STEPS steps through the train CLI (a subprocess)
   with every telemetry flag on, then again with none (both processes
   started at once; the off run waits, built, until the on run has
   ended).  The JSONL holds
   ``step``, ``epoch``, ``eval``, ``goodput``, ``checkpoint_commit``,
   ``memory``, ``trace`` and ``profile`` events, the final goodput
   report's buckets sum to its wall time, the prom file has the train
   rows, ``--profile-dir`` traced epoch 0 and the forced window was
   analyzed (its op-class waterfall and device idle share printed).  Its
   cudaStreamSynchronize and cudaDeviceSynchronize calls a step equal
   those of a window of the script's own over global steps TEL_WINDOW of
   the off run.  Printed: epoch 1's step ms after the on run's windows
   against the off run's before its window, and the telemetry's own host
   cost on the card (a memory sample, and a step's ``step_end`` with a
   run's default subscribers).
30. serve-ops — the operated replica, ResNet-50 at 224 px (seeded
   weights), buckets 1/8/32, fp32.  ``waterfall``: bucket 32's graph
   replayed before any profiler window, after the engine's waterfall
   window and after a second: bit for bit an eager forward and the first
   replay, replay ms within OPS_REPLAY_TOL (10%) of the ms before; the
   window's kernel classes (K3's share named) summed within
   OPS_WATERFALL_TOL (5%) of the measured device span.  ``spans``: sync
   calls a batch under a profiler window with ``serve_span`` unsubscribed
   and subscribed, equal; each span's six phases within 1e-3 ms of its
   ``total_ms``; K3 53 times a device call.  ``canary``:
   ``canary_degrade#0.05`` silent on the boot weights, firing after a swap
   (whose standby graphs take the live slot's window, no window under
   traffic), silent again once the boot weights are swapped back.  ``slo``: ``python -m tpuic_torch.serve
   --listen`` with ``--slo``, ``--brownout-slo``, ``--admission`` and
   ``--prom-port`` under ``TPUIC_FAULTS=flood#3000`` (above the knee) and a
   client's high requests: the brownout gauge tightens and recovers,
   every high request is answered, one scrape holds the latency, reject,
   memory, waterfall and graph rows.  ``crash`` and ``wedge``, at once,
   each a replica under ``python -m tpuic_torch.supervise``:
   ``replica_crash@6`` restarted, its ready file back, the first answer
   after it the same record as before with the same digest, the restart
   seconds printed; ``replica_wedge@6`` escalated SIGQUIT -> SIGTERM ->
   SIGKILL by the watchdog, a stack dump and a flight dump on disk, the
   restarted replica answering.
31. resilience — the trainer's failure story, every life of ``python -m
   tpuic_torch.train`` under cuDNN's deterministic algorithms, read
   through its exit code, log, checkpoints and ``--metrics-jsonl``
   events (its launches from the ``kernel_launches`` event ``fit``
   publishes as it returns).  ``preempt``: ResNet-50 at 224 px,
   batch 32, LARS through K2a, the fused loss (K1), K3 on the val
   forward, float32, two epochs of RES_STEPS steps, once uninterrupted,
   once under ``TPUIC_FAULTS=sigterm@5`` (exit 43, ``latest`` flushed at
   epoch 0 step 5), then the same command again (it resumes at epoch 0
   step 5, exit 0): its final weights equal the uninterrupted run's bit
   for bit, and the two lives' K1f, K1b, K2a and K3 launches sum to the
   uninterrupted run's; the flush seconds (the ``preempt`` event's: the
   signal to the committed flush) and the resume seconds (the spawn to
   the first ``step`` event).  ``rollback``: ``nan_batch@10-13*4`` with
   ``--skip-threshold 3 --rewarm-steps 4``: one ``rollback`` event to
   epoch 1 step 0 (epoch 0's ``latest``) saying the parameters were
   finite and 10 steps applied (none of the 4 skipped ones, though K2a
   ran on each, gated off), the next 4 logged lr values ``rewarm_scale``
   composed onto the schedule (rtol RES_LR_RTOL), finite weights.
   ``crash``: ``python -m tpuic_torch.supervise --chaos hard_crash@9``
   over the train command: one restart (exit -9, then 0), resumed at
   epoch 1 step 0, a ``restart`` event with its downtime.
   ``gang``: ``supervise --gang 2 --coordinator`` over two gloo ranks on
   the card (ResNet-50 at 64 px, batch 8 a rank, three epochs of 4 steps),
   undisturbed and under ``rank_crash@6#1``: rank 1 killed, the teardown
   logged, both ranks restarted with ``TPUIC_RESUME_STEP``, exit 0, the
   weights within GANG_TOL (1e-6) of the undisturbed gang's.  The
   uninterrupted and preempted lives, ``rollback`` and the two gangs run
   at once (the time limit); then the resumed life alone, then ``crash``
   alone, so that the resume seconds and the downtime are their own.
   Each life runs in a process group of its own, killed whole on a
   timeout.
32. convert — the converter's CLI in this process (``main(argv)``):
   ``--verify`` of reference-layout ResNet-50 and ViT-B/16 checkpoints
   made from ``torch_ref``'s bare replicas (seeded, 224 px, 1000
   classes, the reference's MLP head; the ResNet's BN statistics a
   seeded batch's own) holds the port's serving forward (53 K3
   launches; 12 K4f) against the replica's, cuDNN and cuBLAS with TF32
   off: max |logits delta| < 1e-3, every leaf mapped, no replica key
   missing or unexpected.  Then ``--export-torch`` of ``ckpt``'s
   ResNet-50 ``best``, composed with ``--verify`` of the written file.
33. fleet — the front tier: two ``python -m tpuic_torch.serve
   --synthetic-init --listen`` ResNet-50 replicas (224 px, buckets
   1/8/32, ``--admission``) behind ``tpuic_torch.serve.router`` and its
   HTTP front end, both in this process.  Poisson waves through
   ``loadgen.run_stream`` at FLEET_LOAD of one replica's burst capacity
   (``probe_batched_rps``, measured first): a steady wave at r0 alone
   and through the router (p50/p99 of each); a wave in which r1 is
   SIGKILLed holding requests (zero client timeouts, resolved +
   typed-rejected == offered, no untyped error or duplicate, every
   answer within 1e-5 of a direct forward of the same seeded weights);
   r1's respawn (with ``canary_degrade`` armed) and a wave that closes
   its breaker (open -> half_open -> closed in the router ledger); then
   canary rollouts under waves: a seeded candidate on r1 rolled back on
   ``slo_burn``, a byte-flipped checkpoint refused ``swap_corrupt``
   before any stage, another seeded candidate promoted from r0 over two
   stages (both pongs carry its digest).  Each replica's graph captures
   stay flat across each steady wave; a rollout's are its swaps'.  The
   HTTP front end answers ``/healthz`` 200, ``/predict`` 200 and a
   typed 503, ``/metrics`` with the router and rollout rows.  K3's
   launches per replica life come from each replica's pong.
34. score — bulk scoring: ``python -m tpuic_torch.score`` over a seeded
   1,024-row corpus at 224 px (``train``'s first 128 images a class,
   linked into a ``val`` fold of its own and packed by ``pack_dataset``),
   scored with ``ckpt``'s ResNet-50 (``--model auto``) in shards of 64
   rows at batch 32, K3 on every conv of each rung's graph-replayed
   forward.  A: the undisturbed int8 run (the CLI's default) in this
   process: images/s over the scoring loop beside ``ladder``'s int8
   figure, K3 53 times a device call, no graph captured after warmup, the
   audit exact; its shard files are the reference bytes.  B: the fp32
   and bf16 rungs the same way, each rung's top-1 within 0.9 of fp32's
   (the ladder's gate).  C, started with A: two worker processes under a
   membership file (init, degrade, rejoin); rank 1, armed
   ``scorer_crash@1#1``, dies by SIGKILL between its first link and
   manifest, rank 0 steals its lease at once and adopts the shard, a
   replacement rank 1 joins; ``python -m tpuic_torch.telemetry.fleet
   --score-ledger --prom-dump`` exits 0 (scored + quarantined == corpus,
   no duplicate commit record, a recovered one), every shard file equals
   A's bit for bit, no worker captured a graph after warmup.  D:
   ``shard_corrupt@2#1`` puts exactly one row in the quarantined column,
   the audit exact.  E: a ledger copy with a commit record duplicated,
   and one with it dropped, fail the audit (exit 1).

Every launch count is set to 0 just before a path runs and read just after
it.  Cuts: ResNet-50 trains in float32 (bf16 runs the ViT-B/16,
InceptionV3 and EfficientNet-B0 training phases); bf16 and int8 serving
run in ``ladder``; ``digits`` in float32 only; one card.  ``timing``
prints every phase's seconds and the run's total (a failed run prints
what ran on stderr).

The second-to-last lines are the per-kernel JSON summary (K1's
``launches`` are ``[train]``'s; its ``launches_by_path`` gives each
training path's count; K3's and K4's bf16 builds have rows of their own,
with the launches of the bf16 paths) and the card's name and power
limit; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import glob
import importlib
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpuic_torch.kernels.conv_bn_relu_bench import (device_ms,
                                                    resnet50_launches,
                                                    s2d_stem_launch)

BATCH = 8
SERVE_BATCH = 32   # the engine's largest bucket, which carries most images
IMAGE = 224
F32_TOL = 1e-4
BF16_TOL = 1e-2
MODEL_TOL = 1e-3
SERVE_TOL = 1e-5
GRAPH_TOL = 1e-6   # a graph replay against an eager forward, when not bitwise
CLI_IMAGES = 48    # image files the serve CLI answers over stdin
SWAP_REQUESTS = 160  # closed-loop requests in each [swap] phase
FLOOD_RPS = 1000   # the [admission] flood tenant's quota, requests/s
ADMISSION_S = 3.0  # how long the [admission] flood runs
XENT_RTOL, XENT_ATOL = 1e-5, 1e-6
OPT_RTOL, OPT_ATOL = 1e-5, 1e-7
TRAIN_LOSS_RTOL = 1e-3
COMPARE_LR = 0.48
TRAIN_BATCH = 128
TRAIN_STEPS = 12
TRAIN_CLASSES = 8
LAMB_BATCH = 32
DDP_STEPS = 4       # [ddp]'s epoch: [train]'s first DDP_STEPS global batches
# recipes/README.md section 4's mixing and drop-path on [ddp]'s arms: the
# mix partners' all_gather and the mixed loss's normalisers across ranks.
# ResNet-50 has no drop-path site: the flag is taken and draws nothing.
DDP_RECIPE = ("--mixup", "0.2", "--cutmix", "1.0", "--drop-path", "0.1")
DDP_TIMEOUT = 300.0
CKPT_STEPS = 3
INC_IMAGE = 299     # the reference's resize (train.py:110)
INC_BATCH = 32
EFF_MODEL = "efficientnet-b3"
EFF_IMAGE = 300     # EfficientNet-B3's published resolution
REF_WEIGHTS = (3.0, 3.0, 10.0, 1.0, 4.0, 4.0, 5.0)  # train.py:157-158
BF16_LOSS_RTOL = 2e-2
DIGITS_EPOCHS = 40
# [digits] runs float32 only since [digits-vit] joined the run: the time
# limit.  Its bf16 arm's earlier bests are in PERF.md.
DIGITS_DTYPES = ("float32",)
DIGITS_BOUND = 100.0 * 350 / 359  # at most 3 val images below 98.33
# Val images on which predict (float32, as served) may score a run's best
# otherwise than its Trainer's own forward, stated before the first run.
DIGITS_PREDICT_LIMIT = 3  # of 359
REF_PREDICT_LIMIT = 2     # of 28
VIT_MODEL = "vit-b16"
VIT_BATCH = 64
VIT_LR = 3e-4
VIT_COMPARE_LR = 3e-5
VIT_LAYERS = 12
# recipes/README.md section 4's regularisers ([vit-train]'s recipe arm).
VIT_RECIPE = dict(mixup_alpha=0.2, cutmix_alpha=1.0, random_erase=0.25,
                  ema_decay=0.9999)
# A remat arm's loss and gradient norm against the same step without
# remat, stated before the first run (bitwise on the CPU).
REMAT_RTOL = 1e-6
BREAKDOWN_STEPS = 10      # steps a turn in step_breakdown
BREAKDOWN_TOP = 8         # kernels listed by device time
EFF_TRAIN_MODEL = "efficientnet-b0"
EFF_TRAIN_LR = 0.4        # recipes/README.md section 3
EFF_COMPARE_LR = 0.04     # a tenth of the peak, as COMPARE_LR
EFF_SITES = 9             # B0's blocks with a residual: drop-path sites
ACCUM_BATCH = 64
ACCUM_K = 2
ACCUM_MICRO = 4
# Parameters after each real update against the plain arm's: the largest
# difference of a tensor over its largest magnitude, stated before the
# first run.
ACCUM_RTOL = 1e-3
DIGITS_VIT_EPOCHS = 120
PACK_PER_CLASS = 64   # [pack]'s train images a class (linked from [train]'s)
PACK_JPEGS = 2        # JPEG copies a class beside them
PACK_EPOCHS = 2       # augmented epochs the three loaders are held over
PACK_TOL = 1e-5       # tpuic's (tests/test_pack.py)
# tpuic's ViT digits run (perf/convergence_digits.json, tpuic_vit-tiny)
# reached 317/359; the port's draws are its own: at most 12 images below,
# stated before the first run.
DIGITS_VIT_BOUND = 100.0 * 305 / 359
DIGITS_VIT_EMA_EPOCHS = 3
DIGITS_VIT_SERVED = 16    # val image files the serve CLI scores
EMA_SERVE_TOL = 1e-5
ATTN_N, ATTN_H, ATTN_D = 197, 12, 64
MOE_HEADS = 6     # ViT-S/16-MoE's heads of D = 64: K4 at [64, 197, 6, 64]
# (batch, heads) of [attn]'s timed shapes: ViT-B/16's two, ViT-S/16-MoE's.
ATTN_SHAPES = ((8, ATTN_H), (VIT_BATCH, ATTN_H), (VIT_BATCH, MOE_HEADS))
LADDER_REQUESTS = 160  # closed-loop requests a window in [ladder]
LADDER_WINDOWS = 3     # windows a rung; images/s is their median
LONE_REQUESTS = 20     # one-image requests a rung, one at a time
# Each rung's batch-1 row against its row of a batch-32 forward, the
# largest probability difference allowed, stated before the first run on
# the card: fp32 and int8 compute in float32 with TF32 off (int8 widens
# its weights first), rows independent of their bucket; bf16 rounds every
# layer's output to 8 mantissa bits, and cuDNN and cuBLAS may take other
# algorithms at another batch.
RUNG_ROW_TOL = {"fp32": SERVE_TOL, "bf16": 1e-2, "int8": SERVE_TOL}
# Served answers against the same rung's direct forward (another bucket).
RUNG_SERVE_TOL = RUNG_ROW_TOL

# Published dense peaks by card variant (NVIDIA data sheets): float32
# outside the tensor cores, and HBM bandwidth.  The name nvidia-smi reports
# picks the row; "H100 80GB HBM3" is the SXM part.
PEAKS = (("H100 PCIe", 51.2e12, 2.0e12), ("H100 NVL", 60.0e12, 3.9e12),
         ("H200", 67.0e12, 4.8e12), ("H100", 67.0e12, 3.35e12))
# Dense TF32 and bf16 tensor-core peaks of the same parts: the rates of
# the backward flash kernels' 3xTF32 and bf16 MMAs.
TF32_PEAKS = (("H100 PCIe", 378e12), ("H100 NVL", 417.5e12),
              ("H200", 495e12), ("H100", 495e12))
BF16_PEAKS = (("H100 PCIe", 756e12), ("H100 NVL", 835e12),
              ("H200", 989e12), ("H100", 989e12))


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# Seconds by phase, as ``main`` runs them: a failed run reports what ran.
TIMING: dict = {}


def fail(phase: str, msg: str) -> None:
    print(f"[{phase}] FAILED: {msg}", file=sys.stderr, flush=True)
    if TIMING and threading.current_thread() is threading.main_thread():
        print(f"[timing] until the failure: {json.dumps(TIMING)}",
              file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail("device", f"nvidia-smi exited {out.returncode}: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, flops, bw in PEAKS:
        if key in name:
            return key, flops, bw
    fail("device", f"no published peak for {name!r}")


def tf32_peak(name: str) -> float:
    return next(p for key, p in TF32_PEAKS if key in name)


def bf16_peak(name: str) -> float:
    return next(p for key, p in BF16_PEAKS if key in name)


def host_ms(fn, iters: int = 20, repeats: int = 5, warmup: int = 3) -> float:
    """Host milliseconds per call to enqueue ``iters`` back-to-back calls
    (no synchronise inside a window, one between windows), the median of
    ``repeats`` windows: a wrapper's own cost.  A window is short enough
    that the card's launch queue never fills, and the median keeps one
    stall of the shared host out."""
    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        runs.append((time.perf_counter() - t0) / iters * 1e3)
    torch.cuda.synchronize()
    return statistics.median(runs)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls,
    between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def work(xs, ws, stride, padding, dtype_bytes=4):
    """(FLOPs, bytes) one launch must do: 2*M*N*K multiply-adds, and each
    input read once (x, w, scale, bias) and the output written once."""
    from tpuic_torch.kernels.conv_bn_relu import norm_padding
    (pt, pb), (pl, pr) = norm_padding(padding)
    b, h, w, cin = xs
    kh, kw, _, cout = ws
    ho = (h + pt + pb - kh) // stride + 1
    wo = (w + pl + pr - kw) // stride + 1
    flops = 2.0 * b * ho * wo * cout * kh * kw * cin
    nbytes = dtype_bytes * (math.prod(xs) + b * ho * wo * cout) + \
        4 * (math.prod(ws) + 2 * cout)
    return flops, nbytes


def bound(ops: float, nbytes: float, peak_flops: float, hbm: float):
    """``(bound_ms, bound_by)``: the larger of operations over
    ``peak_flops`` and bytes over the HBM bandwidth."""
    t_ops, t_bytes = ops / peak_flops * 1e3, nbytes / hbm * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def max_err(got, want) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def library_call(x, w_folded_cl, bias, stride, padding, relu):
    """One cuDNN call computing conv + folded BN (+ ReLU) on channels_last
    data: the yardstick.  The s2d stem's (2, 1) padding runs as a
    symmetric 2 with the extra output row and column sliced off."""
    from tpuic_torch.kernels.conv_bn_relu import norm_padding
    (pt, _), (pl, _) = norm_padding(padding)
    xc = x.permute(0, 3, 1, 2)
    if relu:
        y = torch.cudnn_convolution_relu(xc, w_folded_cl, bias,
                                         (stride, stride), (pt, pl), (1, 1),
                                         1)
    else:
        y = F.conv2d(xc, w_folded_cl, bias, stride, (pt, pl))
    return y


def tf32_round(t):
    """``t`` rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero): the inputs of a single-pass TF32 product."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def conv_inputs(xs, ws, gen):
    k_red = ws[0] * ws[1] * ws[2]
    x = torch.randn(xs, generator=gen).cuda()
    w = (torch.randn(ws, generator=gen) / math.sqrt(k_red)).cuda()
    scale = (1.0 + 0.1 * torch.randn(ws[3], generator=gen)).cuda()
    bias = (0.1 * torch.randn(ws[3], generator=gen)).cuda()
    return x, w, scale, bias


def kernel_row(device_name, spec, per_fwd, gen, batch):
    """One K3 shape at ``batch``: held against its plain version (float32
    at F32_TOL; bf16 x with float32 w at BF16_TOL), then timed beside the
    plain version and one cuDNN call with TF32 off (``library_ms``, the same
    float32 function) and on (``library_tf32_ms``, a less exact one, for
    information).  ``ms`` and the ``library`` times are back-to-back calls
    from Python (``time_ms``, as every kernel's row); ``device_ms`` and the
    ``library`` ``device_ms`` times are the card's alone (``device_ms``).
    The bound is at the rate of the products the kernel
    issues, 3xTF32 (FLOPs over a third of the TF32 peak), or bytes over HBM
    bandwidth if larger; the float32 CUDA-core bound stands beside it."""
    from tpuic_torch.kernels.conv_bn_relu import (fused_conv_bn_relu,
                                                  fused_conv_bn_relu_plain,
                                                  no_tf32, plan, takes_sm90)
    from tpuic_torch.kernels.conv_bn_relu_bench import earlier_bf16_conv
    _, peak_flops, hbm = peaks(device_name)
    xs, ws, stride, padding, relu = spec
    xs = (batch,) + tuple(xs[1:])
    x, w, scale, bias = conv_inputs(xs, ws, gen)

    def kernel():
        return fused_conv_bn_relu(x, w, scale, bias, strides=stride,
                                  padding=padding, relu=relu)

    def plain():
        return fused_conv_bn_relu_plain(x, w, scale, bias, stride, padding,
                                        relu)

    w_folded = (w * scale).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)

    def library():
        return library_call(x, w_folded, bias, stride, padding, relu)

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=F32_TOL, atol=F32_TOL):
        fail("kernel", f"x {xs} w {ws} s{stride} p{padding}: max abs err "
                       f"{err} beyond atol/rtol {F32_TOL}")
    xb = x.to(torch.bfloat16)
    gotb = fused_conv_bn_relu(xb, w, scale, bias, strides=stride,
                              padding=padding, relu=relu).float()
    wantb = fused_conv_bn_relu_plain(xb, w, scale, bias, stride, padding,
                                     relu).float()
    bf16_err = float((gotb - wantb).abs().max())
    if not torch.allclose(gotb, wantb, rtol=BF16_TOL, atol=BF16_TOL):
        fail("kernel", f"bf16 x {xs} w {ws}: max abs err {bf16_err} beyond "
                       f"atol/rtol {BF16_TOL}")
    del gotb, wantb
    # bf16 x and bf16 w, as the serve ladder's bf16 rung folds them (the
    # check above held a float32 w, which the wgmma build takes as two bf16
    # parts), beside one cuDNN bf16 convolution of the same x with the
    # folded weights in bf16, and the earlier bf16 design (the mma.sync
    # build, with the same w widened to float32) where the wgmma build now
    # runs the shape.
    wb = w.to(torch.bfloat16)
    gotb = fused_conv_bn_relu(xb, wb, scale, bias, strides=stride,
                              padding=padding, relu=relu).float()
    wantb = fused_conv_bn_relu_plain(xb, wb, scale, bias, stride, padding,
                                     relu).float()
    bf16_err = max(bf16_err, float((gotb - wantb).abs().max()))
    if not torch.allclose(gotb, wantb, rtol=BF16_TOL, atol=BF16_TOL):
        fail("kernel", f"bf16 x, bf16 w {xs} w {ws}: max abs err "
                       f"{float((gotb - wantb).abs().max())} beyond atol/rtol "
                       f"{BF16_TOL}")
    del gotb, wantb
    w_folded_b = (wb.float() * scale).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last).to(torch.bfloat16)
    bias_b = bias.to(torch.bfloat16)
    sm90 = takes_sm90(xs, ws, torch.bfloat16)

    def kernel_b():
        return fused_conv_bn_relu(xb, wb, scale, bias, strides=stride,
                                  padding=padding, relu=relu)

    def library_b():
        return library_call(xb, w_folded_b, bias_b, stride, padding, relu)

    def plain_b():
        return fused_conv_bn_relu_plain(xb, wb, scale, bias, stride, padding,
                                        relu)

    def earlier_b():
        return earlier_bf16_conv(xb, wb.float(), scale, bias, stride,
                                 padding, relu)

    flops_b, bytes_b = work(xs, ws, stride, padding, dtype_bytes=2)
    bf16 = {"ms": time_ms(kernel_b), "device_ms": device_ms(kernel_b),
            "plain_ms": time_ms(plain_b), "library_ms": time_ms(library_b),
            "library_device_ms": device_ms(library_b),
            "flops": flops_b, "bytes": bytes_b}
    if sm90:
        erb = earlier_b().float()
        bf16["earlier_max_abs_err"] = float((erb - kernel_b().float())
                                            .abs().max())
        bf16["earlier_ms"] = time_ms(earlier_b)
        bf16["earlier_device_ms"] = device_ms(earlier_b)
        del erb
    else:
        bf16["earlier_ms"], bf16["earlier_device_ms"] = (bf16["ms"],
                                                         bf16["device_ms"])
    # The bound at the card's bf16 peak for every shape.  The mma.sync
    # build (the stem) issues two TF32 MMAs a product: that rate's time
    # stands beside the bound, not as it.
    bf16["bound_ms"], bf16["bound_by"] = bound(
        flops_b, bytes_b, bf16_peak(device_name), hbm)
    bf16["issue_rate_ms"] = bound(
        flops_b, bytes_b, bf16_peak(device_name) if sm90
        else tf32_peak(device_name) / 2, hbm)[0]
    del xb, wb, w_folded_b, bias_b
    with no_tf32():
        lib = library().permute(0, 2, 3, 1)
        lib_err = float((lib[:, :want.shape[1], :want.shape[2]]
                         - want).abs().max())
        ms_lib = time_ms(library), device_ms(library)
    with tf32_on():
        ms_lib_tf32 = time_ms(library), device_ms(library)
    flops, nbytes = work(xs, ws, stride, padding)
    bound_ms, bound_by = bound(flops, nbytes, tf32_peak(device_name) / 3, hbm)
    core_ms, core_by = bound(flops, nbytes, peak_flops, hbm)
    pl = plan(xs, ws, stride, padding)
    row = {"x": list(xs), "w": list(ws), "stride": stride,
           "padding": padding, "relu": relu, "per_forward": per_fwd,
           "plan": {"bm": pl.bm, "splits": pl.splits, "gather": pl.gather},
           "max_abs_err": err, "bf16_max_abs_err": bf16_err,
           "library_max_abs_err": lib_err,
           "ms": time_ms(kernel), "device_ms": device_ms(kernel),
           "plain_ms": time_ms(plain), "library_ms": ms_lib[0],
           "library_device_ms": ms_lib[1], "library_tf32_ms": ms_lib_tf32[0],
           "library_tf32_device_ms": ms_lib_tf32[1],
           "bound_ms": bound_ms, "bound_by": bound_by,
           "fp32_core_bound_ms": core_ms, "fp32_core_bound_by": core_by,
           "flops": flops, "bytes": nbytes, "bf16": bf16}
    row["share_of_bound"] = bound_ms / row["ms"]
    row["device_share_of_bound"] = bound_ms / row["device_ms"]
    log("kernel", json.dumps(row))
    return row


def kernel_bits(gen):
    """The float32 kernel's bits: a row at batch 1 equals the same row
    inside batch 32 (stage-4 3x3x512 at 7x7, a split-K shape), and the
    same under both TF32 flags; and the tolerance tells 3xTF32 from one
    TF32 pass (the plain version on TF32-rounded inputs must fall outside
    it).  Returns that control's max abs error."""
    from tpuic_torch.kernels.conv_bn_relu import (fused_conv_bn_relu,
                                                  fused_conv_bn_relu_plain,
                                                  no_tf32, plan)
    xs, ws, stride, padding, relu = resnet50_launches(32)[-2]
    x, w, scale, bias = conv_inputs(xs, ws, gen)
    kw = dict(strides=stride, padding=padding, relu=relu)
    with no_tf32():
        big = fused_conv_bn_relu(x, w, scale, bias, **kw)
        for row in (0, 13, 31):
            one = fused_conv_bn_relu(x[row:row + 1].contiguous(), w, scale,
                                     bias, **kw)
            if not torch.equal(one[0], big[row]):
                fail("kernel", f"x {xs} w {ws}: row {row} at batch 1 differs "
                               "from the same row in batch 32 (max abs "
                               f"{float((one[0] - big[row]).abs().max())})")
        want = fused_conv_bn_relu_plain(x, w, scale, bias, stride, padding,
                                        relu)
        single = fused_conv_bn_relu_plain(tf32_round(x), tf32_round(w),
                                          scale, bias, stride, padding, relu)
    with tf32_on():
        on = fused_conv_bn_relu(x, w, scale, bias, **kw)
    torch.cuda.synchronize()
    if not torch.equal(on, big):
        fail("kernel", f"x {xs} w {ws}: bits differ between allow_tf32 "
                       "False and True")
    err = float((single - want).abs().max())
    if torch.allclose(single, want, rtol=F32_TOL, atol=F32_TOL):
        fail("kernel", f"the plain version on TF32-rounded inputs is within "
                       f"atol/rtol {F32_TOL} of float32 (max abs err {err}), "
                       "so the check cannot tell one TF32 pass from 3xTF32")
    log("kernel", f"x {xs} w {ws} ({plan(xs, ws, stride, padding)}): rows "
                  "0, 13, 31 bitwise equal at batch 1 and in batch 32; "
                  "bitwise equal under allow_tf32 False and True; the plain "
                  f"version on TF32-rounded inputs is {err} off, outside "
                  f"atol/rtol {F32_TOL}")
    return err


def phase_kernel(device_name: str, gen: torch.Generator):
    """K3 at every distinct conv shape of a ResNet-50 forward at 224x224 and
    at the s2d stem, at batch 8 and 32; then its bits.  Returns the
    summary (per-forward sums at batch 8, and at batch 32 beside them),
    every row, and the TF32 control's error."""
    sums, rows = {}, []
    for batch in (BATCH, SERVE_BATCH):
        launches = resnet50_launches(batch)
        counts = {}
        for spec in launches:
            counts[spec] = counts.get(spec, 0) + 1
        shapes = list(counts.items()) + [(s2d_stem_launch(batch), 0)]
        log("kernel", f"{len(counts)} distinct ResNet-50 conv shapes "
                      f"({len(launches)} launches per forward) + the s2d "
                      f"stem, batch {batch}")
        part = [kernel_row(device_name, spec, n, gen, batch)
                for spec, n in shapes]
        rows += part
        fwd = [r for r in part if r["per_forward"]]
        # Per ResNet-50 forward: each shape's time times its launches per
        # forward, summed.
        sums[batch] = {k: sum(r[k] * r["per_forward"] for r in fwd)
                       for k in ("ms", "device_ms", "plain_ms",
                                 "library_ms", "library_device_ms",
                                 "library_tf32_ms", "library_tf32_device_ms",
                                 "bound_ms", "fp32_core_bound_ms")}
        sums[batch]["over_library"] = (sums[batch]["ms"]
                                       / sums[batch]["library_ms"])
        b16 = {k: sum(r["bf16"][k] * r["per_forward"] for r in fwd)
               for k in ("ms", "device_ms", "plain_ms", "library_ms",
                         "library_device_ms", "bound_ms", "issue_rate_ms",
                         "earlier_ms", "earlier_device_ms")}
        # What bounds most of the forward's bound time.
        by = {}
        for r in fwd:
            by[r["bf16"]["bound_by"]] = by.get(r["bf16"]["bound_by"], 0.0) \
                + r["bf16"]["bound_ms"] * r["per_forward"]
        b16["bound_by"] = max(by, key=by.get)
        b16["over_library"] = b16["ms"] / b16["library_ms"]
        b16["device_over_library"] = (b16["device_ms"]
                                      / b16["library_device_ms"])
        sums[batch]["bf16"] = b16
        sums[batch]["device_over_library"] = (
            sums[batch]["device_ms"] / sums[batch]["library_device_ms"])
        _, peak_flops, hbm = peaks(device_name)
        sums[batch]["bound_by"] = bound(
            sum(r["flops"] * r["per_forward"] for r in fwd),
            sum(r["bytes"] * r["per_forward"] for r in fwd),
            tf32_peak(device_name) / 3, hbm)[1]
        log("kernel", f"per forward at batch {batch}: "
                      f"{json.dumps(sums[batch])}")
        gc.collect()
        torch.cuda.empty_cache()
    tf32_err = kernel_bits(gen)
    summary = {
        "name": "conv_bn_relu", "route": "cuda",
        "source": "tpuic_torch/kernels/csrc/conv_bn_relu.cu",
        "replaces": "tpuic/kernels/conv_bn_relu.py:76",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "bf16_max_abs_err": max(r["bf16_max_abs_err"] for r in rows),
        "tf32_plain_max_abs_err": tf32_err,
        **sums[BATCH], f"batch{SERVE_BATCH}": sums[SERVE_BATCH],
    }
    log("kernel", "kernels " + json.dumps(
        [{"name": "conv_bn_relu", "max_abs_err": summary["max_abs_err"],
          "bf16_max_abs_err": summary["bf16_max_abs_err"],
          "status": "ok"}]))
    return summary, rows


def phase_model(gen: torch.Generator):
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.kernels import fused_conv_bn_relu, no_tf32
    from tpuic_torch.models import create_model
    model = create_model("resnet50", 1000, dtype="float32",
                         fused_conv_bn=True)
    init_synthetic(model, seed=0)
    model.eval()
    x = torch.randn((4, IMAGE, IMAGE, 3), generator=gen).cuda()
    with torch.inference_mode():
        model(x)  # folds the weights
        torch.cuda.synchronize()
        before = fused_conv_bn_relu.launches
        fused = model(x)
        torch.cuda.synchronize()
        per_forward = fused_conv_bn_relu.launches - before
        if per_forward != len(resnet50_launches(4)):
            fail("model", f"{per_forward} kernel launches per forward, "
                          f"expected {len(resnet50_launches(4))}")
        fused_ms = time_ms(lambda: model(x), iters=10)
        model.backbone.fused_inference = False
        with no_tf32():
            ref = model(x)
            unfused_ms = time_ms(lambda: model(x), iters=10)
        model.backbone.fused_inference = True
    err = float((fused - ref).abs().max())
    if not (torch.isfinite(fused).all() and fused.shape == (4, 1000)):
        fail("model", f"logits {tuple(fused.shape)} not finite")
    if not torch.allclose(fused, ref, rtol=MODEL_TOL, atol=MODEL_TOL):
        fail("model", f"fused vs unfused logits: max abs err {err} beyond "
                      f"atol/rtol {MODEL_TOL}")
    top1 = bool((fused.argmax(-1) == ref.argmax(-1)).all())
    bucket = unfused_bucket_check(model)
    log("model", json.dumps({
        "model": "resnet50", "classes": 1000, "image": IMAGE, "batch": 4,
        "dtype": "float32", "launches_per_forward": per_forward,
        "max_abs_err_vs_unfused": err, "logit_abs_max":
        float(ref.abs().max()), "top1_agree": top1,
        "fused_forward_ms": fused_ms, "unfused_cudnn_forward_ms":
        unfused_ms, "unfused_batch1_vs_batch32": bucket}))
    return model


def resnet50_b(seed: int):
    """[model]'s ResNet-50 with other seeded weights: [swap]'s B."""
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.models import create_model
    return init_synthetic(create_model("resnet50", 1000, dtype="float32",
                                       fused_conv_bn=True), seed=seed).eval()


def vit_b(seed: int):
    """[vit]'s ViT-B/16 with other seeded weights."""
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.models import create_model
    return init_synthetic(create_model(VIT_MODEL, 1000, dtype="float32",
                                       attention="flash", image_size=IMAGE),
                          seed=seed).eval()


def unfused_bucket_check(model) -> dict:
    """The unfused (cuDNN) ResNet-50 branch under torch's default flags:
    one image's row from a batch-1 forward against its row of a batch-32
    forward.  Served through the engine's ``make_forward`` the
    probabilities must agree within SERVE_TOL; the same forward called
    directly, where cuDNN's TF32 algorithms are chosen by batch size, is
    reported beside it."""
    from tpuic_torch.serve import make_forward
    if not torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        fail("model", "the bucket check needs torch's default TF32 flags")
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(
        0, 256, (SERVE_BATCH, IMAGE, IMAGE, 3), dtype=np.uint8)).cuda()
    rows = (0, 17, 31)
    model.backbone.fused_inference = False
    try:
        served = make_forward(model, normalize=True)
        big, _ = served(images)
        served_diff = max(float((served(images[r:r + 1])[0][0]
                                 - big[r]).abs().max()) for r in rows)
        with torch.inference_mode():
            x = images.float() / 255.0
            big = model(x)
            direct = [(model(x[r:r + 1])[0], big[r]) for r in rows]
    finally:
        model.backbone.fused_inference = True
    out = {"rows": list(rows), "served_probs_max_abs_diff": served_diff,
           "direct_logits_max_abs_diff": max(
               float((a - b).abs().max()) for a, b in direct),
           "direct_probs_max_abs_diff": max(
               float((a.softmax(-1) - b.softmax(-1)).abs().max())
               for a, b in direct)}
    if served_diff > SERVE_TOL:
        fail("model", f"unfused ResNet-50 served under the default flags: a "
                      f"row's probabilities at batch 1 and in batch "
                      f"{SERVE_BATCH} differ by {served_diff} > {SERVE_TOL}")
    return out


@contextlib.contextmanager
def gc_pauses():
    """Python's cyclic collections in the block, which stop every thread
    while they run: the yielded dict gets, on exit, their count by
    generation and the longest and total pause in ms."""
    started, pauses = {}, []

    def note(phase, info):
        if phase == "start":
            started[threading.get_ident()] = time.perf_counter()
        elif threading.get_ident() in started:
            pauses.append((info["generation"], time.perf_counter()
                           - started.pop(threading.get_ident())))

    out = {}
    gc.callbacks.append(note)
    try:
        yield out
    finally:
        gc.callbacks.remove(note)
        out.update({"by_generation": {str(g): sum(1 for p in pauses
                                                   if p[0] == g)
                                      for g in (0, 1, 2)},
                    "max_ms": 1000.0 * max((p[1] for p in pauses),
                                           default=0.0),
                    "total_ms": 1000.0 * sum(p[1] for p in pauses)})


def phase_serve(model, n_requests: int, seed: int, smi: str,
                tag: str = "serve", counter: str = "conv_bn_relu",
                per_call: int = 0, image: int = IMAGE):
    """Serve ``model`` to eight closed-loop clients through one CUDA graph
    per bucket; ``counter``'s kernel must launch ``per_call`` times per
    device call (default: the 53 of a fused ResNet-50 forward; replays
    count the launches their graph captured) and no other kernel may
    launch (``counter=None``: no kernel at all).  Then the graphs against
    eager forwards (``graph_checks``)."""
    from tpuic_torch.serve import InferenceEngine, make_forward
    if counter is not None:
        per_call = per_call or len(resnet50_launches(1))
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (64, image, image, 3), dtype=np.uint8)
    eng = InferenceEngine(model, None, image_size=image,
                          input_dtype=np.uint8, normalize=True,
                          buckets=(1, 8, 32))
    warm = eng.warmup()
    log(tag, f"warmup (s per bucket: eager run, capture, one replay): "
             f"{json.dumps(warm)}")
    memory = eng.graph_memory()
    log(tag, "graph memory (bytes): " + json.dumps(memory))
    eng.stats.reset()
    reset_counts()
    results, errors, lock = [], [], threading.Lock()
    n_clients = 8

    def client(tid):
        # Closed loop: each client waits for its answer before it sends
        # the next request, so latency is service time, not a backlog.
        r = np.random.default_rng(seed + 1 + tid)
        try:
            for _ in range(n_requests // n_clients):
                n = int(r.integers(1, 9))
                lo = int(r.integers(0, pool.shape[0] - n + 1))
                out = eng.submit(pool[lo:lo + n]).result(timeout=600)
                with lock:
                    results.append((lo, n, out))
        except Exception as e:  # reported below; the phase fails
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_clients)]
    with gc_pauses() as pauses:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts.get(counter, 0)
    eng.close()
    snap = eng.stats.snapshot()
    if errors or any(t.is_alive() for t in threads):
        fail(tag, f"client errors: {errors[:3]}")
    for lo, n, (probs, order) in results:
        if probs.shape != (n, 1000) or order.shape != (n, 1000) \
                or not np.isfinite(probs).all():
            fail(tag, f"request of {n}: probs {probs.shape}, order "
                      f"{order.shape}")
    direct = make_forward(model, normalize=True)
    worst = 0.0
    for lo, n, (probs, order) in results[::max(1, len(results) // 12)]:
        want_p, want_o = direct(torch.from_numpy(pool[lo:lo + n]).cuda())
        worst = max(worst, float(np.abs(probs - want_p.cpu().numpy()).max()))
        if not np.array_equal(order[:, 0], want_o[:, 0].cpu().numpy()):
            fail(tag, f"top-1 differs from a direct forward at {lo}:{n}")
    if worst > SERVE_TOL:
        fail(tag, f"probs differ from a direct forward by {worst} > "
                  f"{SERVE_TOL}")
    others = {k: v for k, v in counts.items() if k != counter and v}
    if (counter is not None and launches == 0) \
            or launches != per_call * snap["device_calls"] or others:
        fail(tag, f"{launches} {counter} launches for "
                  f"{snap['device_calls']} device calls (expected "
                  f"{per_call} each), other kernels {others}")
    graphs = graph_checks(eng, model, tag, image)
    log(tag, json.dumps({
        "requests": len(results), "images": snap["images"],
        "wall_s": wall, "device_calls": snap["device_calls"],
        "kernel": counter, "kernel_launches": launches,
        "latency_ms": snap["latency_ms"],
        "throughput_images_per_sec": snap["throughput_images_per_sec"],
        "images_per_s_wall": snap["images"] / wall,
        "pad_efficiency": snap["pad_efficiency"],
        "batch_hist": snap["batch_hist"], "span_ms": snap["span_ms"],
        "gc_during_traffic": pauses,
        "max_abs_err_vs_direct": worst, "graph_memory": memory,
        "graphs": graphs, "card": smi}))
    snap["graph_memory"], snap["graphs"] = memory, graphs
    return launches, snap


def graph_checks(eng, model, tag: str, image: int = IMAGE) -> dict:
    """Each bucket's graph replay against an eager forward of the same
    batch (``make_forward``, as the engine captured it): the same bits, or
    within GRAPH_TOL.  Then one batch-8 device call, replayed and eager,
    timed from Python (``ms``: back-to-back calls between two events),
    on the card alone (``device_ms``) and as host cost per call
    (``host_ms``).  Run after the served window's counts were read: these
    launches are comparisons, not the path."""
    from tpuic_torch.serve import make_forward
    eager = make_forward(model, normalize=True)
    rng = np.random.default_rng(7)
    rows = {}
    for b in eng.buckets:
        x = torch.from_numpy(rng.integers(0, 256, (b, image, image, 3),
                                          dtype=np.uint8)).cuda()
        want_p, want_o = eager(x)
        got_p, got_o = (t.clone() for t in eng.replay(b, x))
        torch.cuda.synchronize()
        bits = bool(torch.equal(got_p, want_p) and torch.equal(got_o, want_o))
        diff = float((got_p - want_p).abs().max())
        rows[str(b)] = {"bits_equal": bits, "max_abs_diff": diff,
                        "top1_equal": bool(torch.equal(got_o[:, 0],
                                                       want_o[:, 0]))}
        if not bits and diff > GRAPH_TOL:
            fail(tag, f"bucket {b}: graph replay differs from an eager "
                      f"forward by {diff} > {GRAPH_TOL}")
    x8 = torch.from_numpy(rng.integers(0, 256, (8, image, image, 3),
                                       dtype=np.uint8)).cuda()

    def replay():
        return eng.replay(8, x8)

    def direct():
        return eager(x8)

    times = {"replay": {"ms": time_ms(replay, iters=20),
                        "device_ms": device_ms(replay, iters=20),
                        "host_ms": host_ms(replay)},
             "eager": {"ms": time_ms(direct, iters=10),
                       "device_ms": device_ms(direct, iters=5),
                       "host_ms": host_ms(direct, iters=5)}}
    out = {"replay_vs_eager": rows, "batch8_forward": times}
    log(tag, "graphs: " + json.dumps(out))
    return out


def _pct(values, q) -> float:
    """Nearest-rank quantile in ms of ``values`` (seconds); None if empty."""
    if not values:
        return None
    v = sorted(values)
    return 1000.0 * v[max(0, min(len(v) - 1, math.ceil(q / 100 * len(v))
                                 - 1))]


def phase_swap(model, other, n_requests: int, seed: int, smi: str,
               tag: str = "swap", name: str = "resnet50",
               counter: str = "conv_bn_relu", per_call: int = 0,
               stopped: int = 3) -> dict:
    """Hot swap on the card through the per-bucket graphs.  ``model``
    holds weights A and ``other`` weights B (each a direct, eager
    reference); the engine serves a copy of A to eight closed-loop
    clients; once ``n_requests // 3`` are answered the main thread swaps
    to B, and the clients go on until ``n_requests // 3`` submitted after
    the swap returned are answered.  Every request must be answered, with
    A's or B's probabilities (SERVE_TOL), and every request submitted
    after ``swap_weights`` returned with B's; A's and B's answers to each
    request must lie more than 2 * SERVE_TOL apart, so that the nearer
    one names the weights that served it.  ``counter`` must launch
    ``per_call`` times per device call and per capture of the standby's
    graphs (the eager run before each).  Then, traffic stopped,
    ``stopped`` more swaps
    alternating A and B: after each, every bucket's replay must launch
    ``per_call`` kernels and equal bit for bit an eager forward of the
    weights just swapped in (K3's folded weights refolded in place), and
    the graph memory after the fourth swap must equal that after the
    second."""
    import copy

    from tpuic_torch.serve import InferenceEngine, make_forward
    per_call = per_call or len(resnet50_launches(1))
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (64, IMAGE, IMAGE, 3), dtype=np.uint8)
    weights = {"A": model, "B": other}
    direct = {}
    for k, m in weights.items():
        fwd = make_forward(m, normalize=True)
        direct[k] = np.concatenate([
            fwd(torch.from_numpy(pool[i:i + SERVE_BATCH]).cuda())[0]
            .cpu().numpy() for i in range(0, pool.shape[0], SERVE_BATCH)])
    eng = InferenceEngine(copy.deepcopy(model), None, image_size=IMAGE,
                          input_dtype=np.uint8, normalize=True,
                          buckets=(1, 8, 32))
    eng.warmup()
    eng.stats.reset()
    reset_counts()
    results, errors, lock = [], [], threading.Lock()
    stop, offered = threading.Event(), [0] * 8

    def client(tid):
        r = np.random.default_rng(seed + 1 + tid)
        try:
            while not stop.is_set():
                n = int(r.integers(1, 9))
                lo = int(r.integers(0, pool.shape[0] - n + 1))
                offered[tid] += 1
                t0 = time.perf_counter()
                out = eng.submit(pool[lo:lo + n]).result(timeout=600)
                with lock:
                    results.append((t0, time.perf_counter(), lo, n, out[0]))
        except Exception as e:  # reported below; the phase fails
            errors.append(repr(e))

    def answered(since=-math.inf):
        with lock:
            return sum(r[0] > since for r in results)

    # Traffic from eight closed-loop clients until n_requests // 3 are
    # answered, then the swap, then until n_requests // 3 more submitted
    # after the swap returned are answered.
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(len(offered))]
    for t in threads:
        t.start()
    while answered() < n_requests // 3 and not errors:
        time.sleep(0.001)
    t_swap0 = time.perf_counter()
    first = eng.swap_weights(other.state_dict())
    t_swap1 = time.perf_counter()
    while answered(t_swap1) < n_requests // 3 and not errors \
            and time.perf_counter() - t_swap1 < 300:
        time.sleep(0.001)
    stop.set()
    for t in threads:
        t.join(timeout=600)
    counts = read_counts()
    eng.close()
    snap = eng.stats.snapshot()
    if errors or any(t.is_alive() for t in threads) \
            or len(results) != sum(offered) \
            or answered(t_swap1) < n_requests // 3:
        fail(tag, f"{len(results)} of {sum(offered)} answered, "
                  f"{answered(t_swap1)} submitted after the swap; client "
                  f"errors: {errors[:3]}")
    worst, by_gen, spanning = {"A": 0.0, "B": 0.0}, {"A": 0, "B": 0}, []
    apart = math.inf  # the least max |A - B| over a request's rows
    for t0, t1, lo, n, probs in results:
        errs = {k: float(np.abs(probs - d[lo:lo + n]).max())
                for k, d in direct.items()}
        gen = min(errs, key=errs.get)
        # Only where A's and B's answers lie more than twice the
        # tolerance apart does "within SERVE_TOL of one" name which.
        dist = float(np.abs(direct["A"][lo:lo + n]
                            - direct["B"][lo:lo + n]).max())
        apart = min(apart, dist)
        if errs[gen] > SERVE_TOL or (t0 > t_swap1 and gen != "B") \
                or dist <= 2 * SERVE_TOL:
            fail(tag, f"request {lo}:{n} submitted at {t0 - t_swap1:+.4f} s "
                      f"from the swap's return: max abs err against A "
                      f"{errs['A']}, against B {errs['B']}, A and B "
                      f"{dist} apart (tolerance {SERVE_TOL}, after the "
                      f"swap only B, A and B more than twice it apart)")
        worst[gen] = max(worst[gen], errs[gen])
        by_gen[gen] += 1
        if t0 <= t_swap1 and t1 >= t_swap0:
            spanning.append(t1 - t0)
    want = per_call * (snap["device_calls"] + first["prewarmed"])
    others = {k: v for k, v in counts.items() if k != counter and v}
    if counts[counter] != want or others or first["generation"] != 1:
        fail(tag, f"{counts[counter]} {counter} launches for "
                  f"{snap['device_calls']} device calls and "
                  f"{first['prewarmed']} captures (expected {want}), "
                  f"other kernels {others}; swap {first}")
    swaps, memory = [first], []
    x = torch.from_numpy(rng.integers(0, 256, (SERVE_BATCH, IMAGE, IMAGE, 3),
                                      dtype=np.uint8)).cuda()
    # The eager references' device constants exist before the first
    # reading of the memory, so that the readings compare like with like.
    eagers = {k: make_forward(m, normalize=True) for k, m in weights.items()}
    for fwd in eagers.values():
        fwd(x[:1])
    for i in range(stopped):
        k = "A" if i % 2 == 0 else "B"
        res = eng.swap_weights(weights[k].state_dict())
        torch.cuda.synchronize()
        memory.append({**eng.graph_memory(),
                       "allocated": torch.cuda.memory_allocated()})
        eager = eagers[k]
        for b in eng.buckets:
            reset_counts()
            got = [t.clone() for t in eng.replay(b, x[:b])]
            launched = read_counts()
            ref = eager(x[:b])
            if launched != expect(**{counter: per_call}) or not (
                    torch.equal(got[0], ref[0])
                    and torch.equal(got[1], ref[1])):
                fail(tag, f"swap {res['generation']} to {k}, bucket {b}: "
                          f"launches {launched}, replay against an eager "
                          f"forward of {k}: max abs diff "
                          f"{float((got[0] - ref[0]).abs().max())} (must "
                          f"be bitwise equal)")
            del got, ref  # the next swap's memory reading must not see them
        swaps.append(res)
    if stopped >= 3 and memory[2] != memory[0]:
        fail(tag, f"graph memory after the fourth swap {memory[2]} differs "
                  f"from that after the second {memory[0]}")
    if any(not r["reused_executables"] for r in swaps[1:]):
        fail(tag, f"a swap after the first captured again: {swaps}")
    lat = [t1 - t0 for t0, t1, *_ in results]
    row = {"model": name, "requests": len(results),
           "submitted_after_the_swap": answered(t_swap1),
           "answered_by": by_gen,
           "max_abs_err_vs_direct": worst, "least_a_b_distance": apart, "device_calls":
           snap["device_calls"], "kernel": counter,
           "kernel_launches": counts[counter],
           "swaps": [{k: r[k] for k in ("generation", "duration_s",
                                        "reused_executables", "prewarmed",
                                        "batcher_hold_s")} for r in swaps],
           "latency_ms": {"p50": _pct(lat, 50), "p99": _pct(lat, 99)},
           "spanning_the_flip": {"requests": len(spanning),
                                 "p50_ms": _pct(spanning, 50),
                                 "p99_ms": _pct(spanning, 99)},
           "replay_vs_eager_after_each_stopped_swap": "bits_equal",
           "graph_memory_after_swaps_2_3_4": memory, "card": smi}
    log(tag, json.dumps(row))
    del eng
    free()
    return row


def phase_admission(model, seed: int, smi: str) -> dict:
    """Priorities, quotas and deadline shedding on the card: a
    ResNet-50 engine (queue 32) with an ``AdmissionController`` quota
    on the ``flood`` tenant, four threads flooding ``low`` requests of 8
    images, and one thread sending ``high`` requests of one image with
    ``deadline_ms`` (every fifth tight enough to be shed).  Accepted +
    rejected must equal offered, the causes ``queue_full``, ``quota``
    and ``deadline`` must all be seen, no ``high`` request may be
    evicted, and ``high``'s p50 latency must be below ``low``'s."""
    from tpuic_torch.serve import InferenceEngine
    from tpuic_torch.serve.admission import (AdmissionController,
                                             AdmissionError, parse_quotas)
    tag = "admission"
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (64, IMAGE, IMAGE, 3), dtype=np.uint8)
    ctl = AdmissionController(parse_quotas([f"flood={FLOOD_RPS}"]))
    eng = InferenceEngine(model, None, image_size=IMAGE,
                          input_dtype=np.uint8, normalize=True,
                          buckets=(1, 8, 32), queue_size=32, admission=ctl)
    eng.warmup()
    eng.stats.reset()
    reset_counts()
    outcomes, lock, stop = {"low": [], "high": []}, threading.Lock(), \
        threading.Event()

    def note(cls, out, secs):
        with lock:
            outcomes[cls].append((out, secs))

    def offer(cls, images, **sla):
        t0 = time.perf_counter()
        try:
            fut = eng.submit(images, timeout=0, priority=cls, **sla)
        except AdmissionError as e:
            note(cls, e.cause, None)
            return

        def done(f):
            try:
                f.result()
                out = "ok"
            except AdmissionError as e:
                out = e.cause
            except Exception as e:  # reported below; the phase fails
                out = repr(e)
            note(cls, out, time.perf_counter() - t0)

        fut.add_done_callback(done)

    def flood(tid):
        r = np.random.default_rng(seed + 10 + tid)
        while not stop.is_set():
            lo = int(r.integers(0, pool.shape[0] - 8))
            offer("low", pool[lo:lo + 8], tenant="flood")
            time.sleep(0.0005)

    def high():
        i = 0
        while not stop.is_set():
            offer("high", pool[i % 64:i % 64 + 1], tenant="app",
                  deadline_ms=0.5 if i % 5 == 4 else 2000.0)
            i += 1
            time.sleep(0.01)

    threads = [threading.Thread(target=flood, args=(t,)) for t in range(4)]
    threads.append(threading.Thread(target=high))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(ADMISSION_S)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    eng.close()
    wall = time.perf_counter() - t0
    counts = read_counts()
    snap = eng.stats.snapshot()
    offered = sum(len(v) for v in outcomes.values())
    causes = {c for v in outcomes.values() for c, _ in v if c != "ok"}
    lat = {cls: [s for c, s in v if c == "ok"] for cls, v in outcomes.items()}
    p50 = {cls: _pct(v, 50) for cls, v in lat.items()}
    bad = [c for v in outcomes.values() for c, _ in v
           if c not in ("ok", "queue_full", "quota", "deadline")]
    evicted_high = sum(c == "queue_full" for c, _ in outcomes["high"])
    per_call = len(resnet50_launches(1))
    if (bad or snap["requests"] + snap["rejected"] != offered
            or not {"queue_full", "quota", "deadline"} <= causes
            or evicted_high or None in p50.values()
            or not p50["high"] < p50["low"]
            or counts != expect(conv_bn_relu=per_call
                                * snap["device_calls"])):
        fail(tag, f"offered {offered}, accepted {snap['requests']}, "
                  f"rejected {snap['rejected']} {snap['rejected_by']}; "
                  f"causes seen {sorted(causes)}, unexpected {bad[:3]}; "
                  f"high evicted {evicted_high}; p50 ms {p50}; launches "
                  f"{counts} for {snap['device_calls']} device calls")
    row = {"seconds": wall, "offered": offered,
           "accepted": snap["requests"], "rejected": snap["rejected"],
           "rejected_by": snap["rejected_by"],
           "latency_ms": {cls: {"requests": len(v), "p50": _pct(v, 50),
                                "p99": _pct(v, 99)}
                          for cls, v in lat.items()},
           "images_per_s": snap["throughput_images_per_sec"],
           "device_calls": snap["device_calls"],
           "conv_bn_relu_launches": counts["conv_bn_relu"],
           "quota": ctl.state(), "card": smi}
    log(tag, json.dumps(row))
    return row


def xent_rows_ignore_batch(K1, gen: torch.Generator) -> dict:
    """K1b's dx for every row of a class-weighted, masked batch of 128 (one
    label out of range, smoothing 0.1) against the same row alone at batch
    1, bit for bit, at C = 1, 7, 1000 and 21843: in the batch a row of C =
    7 or 21843 is 16-byte aligned only every fourth row, alone always, so
    both load paths meet.  Returns the rows checked per C."""
    b, out = TRAIN_BATCH, {}
    for c in (1, 7, 1000, 21843):
        x = (3.0 * torch.randn((b, c), generator=gen)).cuda()
        y = torch.randint(0, c, (b,), generator=gen, dtype=torch.int32)
        y[5] = c
        y = y.cuda()
        cw = (0.5 + torch.rand(c, generator=gen)).cuda()
        mask = (torch.rand(b, generator=gen) > 0.2).float().cuda()
        scale = torch.tensor(0.37, device="cuda")
        whole = K1.cross_entropy_bwd(x, y, cw, mask, scale, 0.1)
        alone = torch.cat([K1.cross_entropy_bwd(
            x[r:r + 1].clone(), y[r:r + 1].clone(), cw,
            mask[r:r + 1].clone(), scale, 0.1) for r in range(b)])
        torch.cuda.synchronize()
        if not torch.equal(whole, alone):
            bad = [r for r in range(b) if not torch.equal(whole[r],
                                                          alone[r])]
            fail("xent", f"[{b}, {c}]: the backward's rows {bad[:8]} differ "
                         "from the same rows at batch 1")
        out[c] = b
    return out


def phase_xent(device_name: str, gen: torch.Generator):
    """K1 forward and backward against their plain versions, then timed.
    Returns the (K1f, K1b) summaries at the train path's shape, [128,
    1000] with smoothing 0.1 and no class weights."""
    from tpuic_torch.kernels import cross_entropy as K1
    from tpuic_torch.kernels import cross_entropy_bench as K1B
    from tpuic_torch.kernels.optimizer_update_bench import device_time
    _, peak_flops, hbm = peaks(device_name)
    earlier = K1B.build_earlier()
    # Class-weighted, masked batches with one out-of-range label (w = 0),
    # from a single class to a long row (C = 21843 rows are 16-byte
    # aligned only every fourth row: both load paths run).
    b = 37
    for c in (1, 7, 1000, 21843):
        x = (3.0 * torch.randn((b, c), generator=gen)).cuda()
        y = torch.randint(0, c, (b,), generator=gen, dtype=torch.int32)
        y[0] = c
        y = y.cuda()
        cw = (0.5 + torch.rand(c, generator=gen)).cuda()
        mask = (torch.rand(b, generator=gen) > 0.2).float().cuda()
        scale = torch.tensor(0.37, device="cuda")
        for ls in (0.0, 0.1):
            got = [*K1.cross_entropy_fwd(x, y, cw, mask, ls),
                   K1.cross_entropy_bwd(x, y, cw, mask, scale, ls)]
            torch.cuda.synchronize()
            want = [*K1.cross_entropy_fwd_plain(x, y, cw, mask, ls),
                    K1.cross_entropy_bwd_plain(x, y, cw, mask, scale, ls)]
            if not all(torch.allclose(g, w, rtol=XENT_RTOL, atol=XENT_ATOL)
                       for g, w in zip(got, want)) \
                    or not torch.equal(got[1], want[1]) \
                    or float(got[1][0]) != 0.0:
                fail("xent", f"weighted, masked [{b}, {c}] smoothing {ls}: "
                             f"max abs err {max_err(got, want)}")
    log("xent", f"weighted, masked [{b}, C] for C in 1, 7, 1000, 21843, "
                f"smoothing 0 and 0.1: within rtol {XENT_RTOL} / atol "
                f"{XENT_ATOL}, w exact")
    log("xent", "backward rows against their batch: " + json.dumps(
        xent_rows_ignore_batch(K1, gen)))
    rows, main = [], {}
    for b, c in ((TRAIN_BATCH, 1000), (TRAIN_BATCH, 7)):
        for ls in (0.0, 0.1):
            # The train path's inputs: no class weights, nothing masked.
            x, y, cw, mask, scale = K1B.train_inputs(b, c, gen)
            yl = y.long()
            fwd = (x, y, cw, mask)
            got = [*K1.cross_entropy_fwd(*fwd, ls),
                   K1.cross_entropy_bwd(*fwd, scale, ls)]
            old = [*K1B.fwd_with(earlier, *fwd, ls),
                   K1B.bwd_with(earlier, *fwd, scale, ls)]
            torch.cuda.synchronize()
            want = [*K1.cross_entropy_fwd_plain(*fwd, ls),
                    K1.cross_entropy_bwd_plain(*fwd, scale, ls)]
            err_f, err_b = max_err(got[:2], want[:2]), max_err(got[2:],
                                                               want[2:])
            if not all(torch.allclose(g, w, rtol=XENT_RTOL, atol=XENT_ATOL)
                       for g, w in zip(got + old, want + want)):
                fail("xent", f"[{b}, {c}] smoothing {ls}: max abs err "
                             f"fwd {err_f} bwd {err_b}, earlier design "
                             f"{max_err(old, want)}")
            again = K1.cross_entropy_bwd(*fwd, scale, ls)
            torch.cuda.synchronize()
            if not torch.equal(got[2], again):
                fail("xent", f"[{b}, {c}] smoothing {ls}: two backward "
                             "calls gave different bits")
            # One library call each: with all-one weights and smoothing,
            # F.cross_entropy's smoothed sum is the same function (its
            # smoothing differs from tpuic's only with class weights).
            kw = (dict(label_smoothing=ls) if ls
                  else dict(weight=cw))
            xr = x.clone().requires_grad_(True)

            def lib_fwd():
                return F.cross_entropy(x, yl, reduction="sum", **kw)

            def lib_fwd_bwd():
                return torch.autograd.grad(
                    F.cross_entropy(xr, yl, reduction="sum", **kw), xr)

            def k1f():
                return K1.cross_entropy_fwd(*fwd, ls)

            def k1b():
                return K1.cross_entropy_bwd(*fwd, scale, ls)

            def k1f_earlier():
                return K1B.fwd_with(earlier, *fwd, ls)

            def k1b_earlier():
                return K1B.bwd_with(earlier, *fwd, scale, ls)

            ms = {"fwd": time_ms(k1f, iters=200),
                  "fwd_plain": time_ms(
                      lambda: K1.cross_entropy_fwd_plain(*fwd, ls),
                      iters=200),
                  "fwd_lib": time_ms(lib_fwd, iters=200),
                  "bwd": time_ms(k1b, iters=200),
                  "bwd_plain": time_ms(
                      lambda: K1.cross_entropy_bwd_plain(*fwd, scale, ls),
                      iters=200),
                  "bwd_lib": time_ms(lib_fwd_bwd, iters=200)}
            # On the card alone: the median of 5 replays of a CUDA graph of
            # 100 calls.
            dev = {"fwd": device_time(k1f)["median"],
                   "fwd_earlier": device_time(k1f_earlier)["median"],
                   "bwd": device_time(k1b)["median"],
                   "bwd_earlier": device_time(k1b_earlier)["median"],
                   "fwd_lib": device_time(lib_fwd)["median"],
                   "fwd_bwd_lib": device_time(lib_fwd_bwd)["median"]}
            # F.cross_entropy's backward alone, on the card: its forward +
            # backward minus its forward.
            dev["bwd_lib_fwd_bwd_minus_fwd"] = (dev["fwd_bwd_lib"]
                                                - dev["fwd_lib"])
            # Bytes: each input read once, each output written once.  Ops
            # per logit: max, subtract + exp, sum (+ sum of x when
            # smoothing) forward; those plus exp, divide, subtract target
            # and scale backward.
            n = b * c
            fb = bound(n * (5 if ls else 4), K1B.fwd_bytes(b, c),
                       peak_flops, hbm)
            bb = bound(n * 9, K1B.bwd_bytes(b, c), peak_flops, hbm)
            row = {"b": b, "c": c, "label_smoothing": ls,
                   "fwd_max_abs_err": err_f, "bwd_max_abs_err": err_b,
                   "earlier_fwd_max_abs_err": max_err(old[:2], want[:2]),
                   "earlier_bwd_max_abs_err": max_err(old[2:], want[2:]),
                   "bwd_bits_equal_on_two_calls": True,
                   **ms, "device_ms": dev,
                   "fwd_earlier_over_shipped": dev["fwd_earlier"]
                   / dev["fwd"],
                   "bwd_over_earlier": dev["bwd"] / dev["bwd_earlier"],
                   "fwd_bound_ms": fb[0], "bwd_bound_ms": bb[0]}
            rows.append(row)
            log("xent", json.dumps(row))
            if (b, c, ls) == (TRAIN_BATCH, 1000, 0.1):
                main = {
                    "cross_entropy_fwd": {
                        "max_abs_err": err_f, "ms": ms["fwd"],
                        "device_ms": dev["fwd"],
                        "earlier_device_ms": dev["fwd_earlier"],
                        "plain_ms": ms["fwd_plain"], "bound_ms": fb[0],
                        "bound_by": fb[1], "library_ms": ms["fwd_lib"],
                        "library_device_ms": dev["fwd_lib"]},
                    "cross_entropy_bwd": {
                        "max_abs_err": err_b, "ms": ms["bwd"],
                        "device_ms": dev["bwd"],
                        "earlier_device_ms": dev["bwd_earlier"],
                        "plain_ms": ms["bwd_plain"], "bound_ms": bb[0],
                        "bound_by": bb[1], "library_ms": ms["bwd_lib"],
                        "library_device_ms": dev["fwd_bwd_lib"],
                        "library_bwd_device_ms_fwd_bwd_minus_fwd":
                            dev["bwd_lib_fwd_bwd_minus_fwd"]}}
    return main, rows


def phase_optim(device_name: str, seed: int):
    """K2 LARS and LAMB over the ResNet-50 + head parameter list against
    their plain versions, the same bits on a second run, then timed: per
    call from Python (``ms``, 100 back-to-back calls) and on the card alone
    (``device_ms``: the median of 5 replays of a CUDA graph of 100
    back-to-back updates, with their spread); each also through its
    earlier design (``optimizer_update_bench``), held and timed the same
    way.  LAMB's debias factors, computed by the kernel from the device
    count, are held to ``lamb_debias`` on the card within 1 ulp.  Returns
    their summaries."""
    from tpuic_torch.checkpoint import init_params
    from tpuic_torch.kernels import optimizer_update as K2
    from tpuic_torch.kernels import optimizer_update_bench as K2B
    from tpuic_torch.models import create_model
    _, peak_flops, hbm = peaks(device_name)
    model = init_params(create_model("resnet50", 1000, dtype="float32"),
                        seed, device="cuda")
    w = [p.detach() for p in model.parameters()]
    cg = torch.Generator(device="cuda").manual_seed(seed)
    g = [1e-3 * torch.randn(t.shape, generator=cg, device="cuda") for t in w]
    m = [1e-3 * torch.randn(t.shape, generator=cg, device="cuda") for t in w]
    v = [1e-6 * torch.rand(t.shape, generator=cg, device="cuda") for t in w]
    n = sum(t.numel() for t in w)
    zero = sum(1 for t in w if not bool(t.any()))
    # lr at step 1 of the recipe's warmup (4.8 over 5 epochs of 12 steps).
    lr = torch.tensor(4.8 / 60, device="cuda")
    count = torch.tensor(3, dtype=torch.int32, device="cuda")
    finite = torch.tensor(True, device="cuda")
    lars_kw = dict(weight_decay=1e-4, trust_coefficient=0.001, momentum=0.9)
    lamb_kw = dict(b1=0.9, b2=0.999, eps=1e-6, weight_decay=1e-4)
    block_libs = K2B.build_earlier()
    out = {}
    for kind in ("lars", "lamb"):
        if kind == "lars":
            new_m = K2.lars_update_plain(w, g, m, lr, **lars_kw)
            want = [*[a + b for a, b in zip(w, new_m)], *new_m]
            state = (w, m)

            def update(ws, table):
                K2.lars_update(ws[0], g, ws[1], lr, finite, table=table,
                               **lars_kw)

            def earlier_update(ws, table):
                K2B.block_lars_update(block_libs["lars"], ws[0], g, ws[1],
                                      lr, finite, table=table, **lars_kw)

            def plain():
                return K2.lars_update_plain(w, g, m, lr, **lars_kw)
            # g, w, m read; m', w' written.  Ops per element: u = g +
            # wd*w, the two squares summed, the update and w + m'.  The
            # two passes read g and w twice: 7 tensors.
            ops, nbytes, two_pass = 10.0 * n, 4.0 * 5 * n, 4.0 * 7 * n
        else:
            upd, mus, nus = K2.lamb_update_plain(w, g, m, v, count, lr,
                                                 **lamb_kw)
            want = [*[a + b for a, b in zip(w, upd)], *mus, *nus]
            state = (w, m, v)

            def update(ws, table):
                K2.lamb_update(ws[0], g, ws[1], ws[2], count, lr, finite,
                               table=table, **lamb_kw)

            def earlier_update(ws, table):
                K2B.block_lamb_update(block_libs["lamb"], ws[0], g, ws[1],
                                      ws[2], count, lr, finite, table=table,
                                      **lamb_kw)

            def plain():
                return K2.lamb_update_plain(w, g, m, v, count, lr, **lamb_kw)
            # g, w, m, v read; m', v', w' written.  Ops per element: the
            # two moments, debias, sqrt, divide, decay, the two squares
            # summed, and the update.  Two passes: 10 tensors.
            ops, nbytes, two_pass = 20.0 * n, 4.0 * 7 * n, 4.0 * 10 * n
        # The shipped kernels twice from the same state, each on its own
        # copies and table, then the earlier design once.
        runs = []
        for _ in range(2):
            copies = [[t.clone() for t in ts] for ts in state]
            table = K2.LeafTable()
            update(copies, table)
            torch.cuda.synchronize()
            runs.append((copies, table))
        got = [t for ts in runs[0][0] for t in ts]
        err = max_err(got, want)
        bad = [i for i, (a, b) in enumerate(zip(got, want))
               if not torch.allclose(a, b, rtol=OPT_RTOL, atol=OPT_ATOL)]
        if bad:
            fail("optim", f"{kind}: {len(bad)} tensors beyond rtol "
                          f"{OPT_RTOL} / atol {OPT_ATOL}, max abs err {err}")
        if not all(torch.equal(a, b) for a, b in zip(
                got, [t for ts in runs[1][0] for t in ts])):
            fail("optim", f"{kind}: two runs from one state differ")
        row = {"kind": kind, "leaves": len(w), "params": n,
               "zero_norm_leaves": zero, "max_abs_err": err,
               "bits_equal_on_two_runs": True}
        if kind == "lamb":
            # The c1, c2 the kernel's first pass computed, against the
            # plain version's on the card: within 1 ulp.
            got_c = runs[0][1].a[-2:]
            want_c = torch.stack(K2.lamb_debias(count, lamb_kw["b1"],
                                                lamb_kw["b2"]))
            ulps = (got_c.view(torch.int32).long()
                    - want_c.view(torch.int32).long()).abs().max()
            row["debias_ulps"] = int(ulps)
            if int(ulps) > 1:
                fail("optim", f"lamb: debias {got_c.tolist()} against "
                              f"{want_c.tolist()}, {int(ulps)} ulps apart")
        old_state = [[t.clone() for t in ts] for ts in state]
        old_table = K2.LeafTable()

        def earlier():
            earlier_update(old_state, old_table)
        earlier()
        torch.cuda.synchronize()
        row["earlier_max_abs_err"] = max_err(
            [t for ts in old_state for t in ts], want)
        copies, table = runs[0]

        def kernel():
            update(copies, table)
        row["earlier_device_ms"] = K2B.device_time(earlier)
        row["earlier_ms"] = time_ms(earlier, iters=100)
        row["earlier_host_ms"] = host_ms(earlier)
        dev = K2B.device_time(kernel)
        bms, by = bound(ops, nbytes, peak_flops, hbm)
        row.update(ms=time_ms(kernel, iters=100), host_ms=host_ms(kernel),
                   device_ms=dev,
                   plain_ms=time_ms(plain, iters=5, warmup=1), bound_ms=bms,
                   bound_by=by, two_pass_bound_ms=two_pass / hbm * 1e3,
                   device_share_of_bound=bms / dev["median"],
                   gb_per_s=nbytes / dev["median"] / 1e6)
        row["earlier_over_shipped"] = (row["earlier_device_ms"]["median"]
                                       / dev["median"])
        log("optim", json.dumps(row))
        out[f"{kind}_update"] = {
            "max_abs_err": err, "ms": row["ms"], "host_ms": row["host_ms"],
            "device_ms": dev["median"],
            "device_ms_spread": dev["spread"], "plain_ms": row["plain_ms"],
            "bound_ms": bms, "bound_by": by,
            "two_pass_bound_ms": row["two_pass_bound_ms"],
            "library_ms": None,
            "earlier_device_ms": row["earlier_device_ms"]["median"]}
    return out


def _counters():
    from tpuic_torch.kernels import (cross_entropy_bwd, cross_entropy_fwd,
                                     flash_attention_bwd_dkv,
                                     flash_attention_bwd_dq,
                                     flash_attention_fwd, fused_conv_bn_relu,
                                     lamb_update, lars_update)
    return {"cross_entropy_fwd": cross_entropy_fwd,
            "cross_entropy_bwd": cross_entropy_bwd,
            "lars_update": lars_update, "lamb_update": lamb_update,
            "conv_bn_relu": fused_conv_bn_relu,
            "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv}


def expect(**launches) -> dict:
    """Every counter at 0 except the ones named."""
    out = {k: 0 for k in _counters()}
    out.update(launches)
    return out


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in _counters().items()}


def train_config(root: str, seed: int):
    """The repo's large-batch ResNet-50 recipe (recipes/README.md,
    section 5) on one card, float32, with the fused loss and optimizer."""
    from tpuic_torch.config import (Config, DataConfig, ModelConfig,
                                    OptimConfig, RunConfig)
    return Config(
        data=DataConfig(data_dir=root, resize_size=IMAGE,
                        batch_size=TRAIN_BATCH, num_workers=8,
                        shuffle_seed=seed),
        model=ModelConfig(name="resnet50", num_classes=1000,
                          dtype="float32", fused_conv_bn=True),
        optim=OptimConfig(optimizer="lars", learning_rate=4.8,
                          weight_decay=1e-4, warmup_epochs=5,
                          label_smoothing=0.1, class_weights=(),
                          fused_loss=True, fused_optimizer=True),
        run=RunConfig(epochs=90, max_steps=TRAIN_STEPS, log_every_steps=4,
                      seed=seed, ckpt_dir=os.path.join(root, "ckpt")))


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, no autotuning, inside the block:
    the two arms of the comparison then differ only by the kernels."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


@contextlib.contextmanager
def conv_dtypes(first: int = 64):
    """Yields a list that receives the output dtype of the first ``first``
    convolutions run inside the block: a global forward hook that removes
    itself after them, so the steps it does not see pay nothing."""
    seen = []

    def hook(module, args, out):
        if isinstance(module, torch.nn.Conv2d):
            seen.append(out.dtype)
            if len(seen) >= first:
                handle.remove()

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


@contextlib.contextmanager
def attn_dtypes(first: int = 48):
    """As ``conv_dtypes`` for the ViT: the dtype of each attention block's
    input and output (q, k and v are views of the projection of that
    input), for the first ``first`` blocks run inside the block."""
    from tpuic_torch.models.vit import MultiHeadAttention
    seen = []

    def hook(module, args, out):
        if isinstance(module, MultiHeadAttention):
            seen.extend((args[0].dtype, out.dtype))
            if len(seen) >= 2 * first:
                handle.remove()

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def check_conv_dtypes(tag: str, arm: str, seen: list, dtype: str) -> str:
    """Fails unless convolutions ran and every one returned ``dtype``: a
    bf16 arm that computes in float32 would pass every loss bound."""
    want = getattr(torch, dtype)
    if not seen or set(seen) != {want}:
        fail(tag, f"{arm}: convolution outputs "
                  f"{sorted(str(d) for d in set(seen))}, expected {want}")
    return dtype


def compare_plain(cfg, batches, seed: int, lr: float, plain_model=None,
                  bf16_model=None, probe=None):
    """3 steps from one initial state on ``batches``, through the kernels
    and through the plain versions (the plain loss, the plain optimizer
    and ``plain_model``, default ``cfg.model``), TF32 off: per-step loss
    and gradient norm of each arm, and the step times.  ``bf16_model``
    adds an arm through the kernels under that (bf16) model config, whose
    output dtypes ``probe`` (default ``conv_dtypes``) records."""
    from tpuic_torch.checkpoint import init_params
    from tpuic_torch.kernels import no_tf32
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.train.optimizer import make_optimizer, make_schedule
    from tpuic_torch.train.state import create_train_state
    from tpuic_torch.train.step import make_train_step
    arms = {}
    todo = [("kernels", cfg.model, True),
            ("plain", plain_model or cfg.model, False)]
    if bf16_model is not None:
        todo.append(("bf16", bf16_model, True))
    for arm, mcfg, fused in todo:
        # Both arms start from the same numbers: init_params draws them
        # from a CPU generator seeded alike.
        model = init_params(create_model_from_config(
            mcfg, image_size=cfg.data.resize_size), seed, device="cuda")
        # A constant lr of a tenth of the peak, so every step moves the
        # weights (the recipe's warmup starts at lr 0) and 3 steps stay in
        # the tame early regime the warmup is there to give.
        ocfg = dataclasses.replace(cfg.optim, learning_rate=lr,
                                   warmup_epochs=0, milestones=(),
                                   fused_loss=fused, fused_optimizer=fused)
        state = create_train_state(model, make_optimizer(ocfg),
                                   ema=ocfg.ema_decay > 0)
        # One seed for every arm: a recipe's draws (mixup, CutMix,
        # erasing, drop-path) are the same in each.
        step = make_train_step(ocfg, mcfg, lr_schedule=make_schedule(
            ocfg, 1, 1), device="cuda", seed=cfg.run.seed)
        metrics, times = [], []
        seen_by = ((probe or conv_dtypes)() if arm == "bf16"
                   else contextlib.nullcontext())
        with no_tf32(), deterministic_cudnn(), seen_by as seen:
            for batch in batches:
                t0 = time.perf_counter()
                state, mt = step(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                metrics.append({k: float(mt[k]) for k in ("loss",
                                                          "grad_norm",
                                                          "skipped")})
        arms[arm] = {"metrics": metrics, "step_ms": times}
        if arm == "bf16":
            arms[arm]["conv_dtypes"] = seen
        del model, state, step
        gc.collect()
        torch.cuda.empty_cache()
    return arms


def write_folder(root: str, seed: int) -> None:
    """The synthetic 224x224 ImageFolder both training phases read."""
    from tpuic_torch.data.synthetic import make_synthetic_imagefolder
    classes = tuple(f"class{i}" for i in range(TRAIN_CLASSES))
    t0 = time.perf_counter()
    make_synthetic_imagefolder(
        root, classes, per_class=TRAIN_BATCH * TRAIN_STEPS
        // TRAIN_CLASSES, size=IMAGE, folds=("train",), seed=seed)
    make_synthetic_imagefolder(
        root, classes, per_class=2 * TRAIN_BATCH // TRAIN_CLASSES,
        size=IMAGE, folds=("val",), seed=seed + 1)
    log("train", f"synthetic ImageFolder {IMAGE}x{IMAGE}: "
                 f"{TRAIN_BATCH * TRAIN_STEPS} train + "
                 f"{2 * TRAIN_BATCH} val images in "
                 f"{time.perf_counter() - t0:.3f} s")


def start_folder_writers(root: str, seed: int) -> list:
    """Write ``train``'s folder and ``inception-train``'s (under
    ``{root}/inception``), each in a forked process of its own: PNG
    encoding is host work, and it overlaps the kernels' build, which
    ``join_folder_writers`` waits for before anything is timed."""
    import multiprocessing
    ctx = multiprocessing.get_context("fork")
    procs = [ctx.Process(target=write_folder, args=(root, seed)),
             ctx.Process(target=write_inception_folder,
                         args=(os.path.join(root, "inception"), seed))]
    for proc in procs:
        proc.start()
    return procs


def join_folder_writers(procs: list) -> None:
    for proc in procs:
        proc.join()
        if proc.exitcode:
            fail("train", f"a folder writer exited {proc.exitcode}")


def pack_folder(root: str, dst: str) -> str:
    """``[pack]``'s train fold: the first PACK_PER_CLASS images of each
    class of ``train``'s (hard links), PACK_JPEGS JPEG copies of the next
    ones a class, and a PNG cut to half its bytes in the first class (the
    truncated file).  Returns the truncated file's path."""
    from PIL import Image
    victim = ""
    for c in sorted(os.listdir(os.path.join(root, "train"))):
        src = os.path.join(root, "train", c)
        out = os.path.join(dst, "train", c)
        os.makedirs(out)
        names = sorted(os.listdir(src))
        for name in names[:PACK_PER_CLASS]:
            os.link(os.path.join(src, name), os.path.join(out, name))
        for name in names[PACK_PER_CLASS:PACK_PER_CLASS + PACK_JPEGS]:
            with Image.open(os.path.join(src, name)) as im:
                im.convert("RGB").save(os.path.join(
                    out, os.path.splitext(name)[0] + ".jpg"), quality=90)
        if not victim:
            with open(os.path.join(src, names[-1]), "rb") as f:
                data = f.read()
            victim = os.path.join(out, "truncated.png")
            with open(victim, "wb") as f:
                f.write(data[:len(data) // 2])
    return victim


def phase_pack(root: str, seed: int, smi: str) -> dict:
    """The default data path: the native core's build, the pack of
    ``pack_folder``'s tree (PNG, JPEG and one truncated file), and the
    three loaders (decode, streaming, resident) held against each other
    on the card over PACK_EPOCHS augmented epochs at ``train``'s batch
    (images within PACK_TOL, labels, masks and ids equal); the truncated
    file packed as a same-class replacement under that sample's id; each
    loader's bytes to the card a batch and its ms a batch alone."""
    from tpuic_torch import native
    from tpuic_torch.config import DataConfig
    from tpuic_torch.data.device_prep import (identity_params,
                                              make_resident_prep,
                                              pack_params)
    from tpuic_torch.data.folder import ImageFolderDataset
    from tpuic_torch.data.pack import pack_dataset
    from tpuic_torch.data.pipeline import Loader
    tag = "pack"
    t0 = time.perf_counter()
    built = native.status()
    log(tag, f"native core: {json.dumps(built)} "
             f"({time.perf_counter() - t0:.3f} s to build and load)")
    data = os.path.join(root, "pack")
    victim = pack_folder(root, data)
    ds = ImageFolderDataset(data, "train", IMAGE, DataConfig(
        data_dir=data, resize_size=IMAGE, shuffle_seed=seed))
    t0 = time.perf_counter()
    packed = pack_dataset(ds, os.path.join(data, ".tpuic_pack"),
                          verbose=False)
    pack_s = time.perf_counter() - t0
    vi = [p for p, _ in ds.samples].index(victim)
    labels = {ds.image_id(i): lb for i, (_, lb) in enumerate(ds.samples)}
    stood_in = packed.image_id(vi)
    honest = (packed.quarantine_count == 1 and stood_in != ds.image_id(vi)
              and labels.get(stood_in) == ds.samples[vi][1]
              == packed.label(vi))
    jpegs = sum(p.endswith(".jpg") for p, _ in ds.samples)
    kw = dict(seed=seed, drop_last=True, device="cuda", num_workers=8)
    loaders = {"decode": Loader(ds, TRAIN_BATCH, **kw),
               "streaming": Loader(packed, TRAIN_BATCH,
                                   device_cache_bytes=0, **kw),
               "resident": Loader(packed, TRAIN_BATCH, **kw)}
    errs = {"streaming_vs_decode": 0.0, "resident_vs_decode": 0.0,
            "resident_vs_streaming": 0.0}
    n = 0
    for epoch in range(PACK_EPOCHS):
        for d, st, rs in zip(*(ld.epoch(epoch) for ld in loaders.values())):
            for key, a, b in (("streaming_vs_decode", st, d),
                              ("resident_vs_decode", rs, d),
                              ("resident_vs_streaming", rs, st)):
                errs[key] = max(errs[key], max_err(a["image"], b["image"]))
                if not (torch.equal(a["label"], b["label"])
                        and torch.equal(a["mask"], b["mask"])
                        and a.image_ids == b.image_ids):
                    fail(tag, f"{key}: labels, masks or ids differ in "
                              f"epoch {epoch}")
            n += 1
    ms = {}
    for name, ld in loaders.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k = 0
        for b in ld.epoch(PACK_EPOCHS):
            b["image"].sum().item()  # the batch as the step would see it
            k += 1
        ms[name] = (time.perf_counter() - t0) / k * 1e3
    res = loaders["resident"]
    idx = torch.arange(TRAIN_BATCH, device="cuda", dtype=torch.int32)
    params = torch.from_numpy(pack_params(identity_params(
        TRAIN_BATCH))).cuda()
    prep = make_resident_prep()
    prep_ms = time_ms(lambda: prep(res._data, idx, params), iters=10)
    _, _, hbm = peaks(torch.cuda.get_device_name(0))
    prep_bytes = TRAIN_BATCH * IMAGE * IMAGE * 3 * (1 + 4)
    row = {"native": built, "images": len(ds), "jpeg": jpegs,
           "pack_s": pack_s, "pack_img_per_s": len(ds) / pack_s,
           "decoded": packed.decoded,
           "quarantine": {"truncated": os.path.basename(victim),
                          "packed_as": stood_in,
                          "label": packed.label(vi),
                          "count": packed.quarantine_count,
                          "decode_path_count": ds.quarantine_count},
           "batches_compared": n, "max_abs_err": errs, "tol": PACK_TOL,
           "bytes_per_batch": {k: ld.bytes_per_batch()
                               for k, ld in loaders.items()},
           "resident_bytes": res.resident_bytes,
           "ms_per_batch": ms, "resident_prep_ms": prep_ms,
           "resident_prep_bound_ms": prep_bytes / hbm * 1e3,
           "batch": TRAIN_BATCH, "card": smi}
    log(tag, json.dumps(row))
    del loaders, res, prep
    free()
    if not honest or n != PACK_EPOCHS * (len(ds) // TRAIN_BATCH):
        fail(tag, f"quarantine {row['quarantine']}, {n} batches compared")
    if max(errs.values()) > PACK_TOL:
        fail(tag, f"loaders differ by {errs} > {PACK_TOL}")
    return row


def epoch_row(parts: dict) -> dict:
    """``epoch_parts``' sums as seconds an epoch: the whole, and the
    train loop's steps, its wait for the loader, the val pass and the
    checkpoint saves; the data-wait share of the train loop."""
    e = max(1, parts["epochs"])
    return {"epoch_s": parts["fit_s"] / e,
            "epoch_parts_s": {
                "steps": (parts["train_s"] - parts["data_wait_s"]) / e,
                "loader_wait": parts["data_wait_s"] / e,
                "val": parts["val_s"] / e, "ckpt": parts["ckpt_s"] / e,
                "rest": (parts["fit_s"] - parts["train_s"] - parts["val_s"]
                         - parts["ckpt_s"]) / e},
            "data_wait_share": parts["data_wait_s"]
            / max(parts["train_s"], 1e-9)}


@contextlib.contextmanager
def epoch_parts():
    """Seconds of each part of the epochs every ``Trainer`` runs inside
    the block, summed: ``train_s`` (``train_epoch``), in it
    ``data_wait_s`` (waiting for the loader), ``val_s`` (``val_epoch``),
    ``ckpt_s`` (the saves' host time and the final wait for their
    commits), ``fit_s``; and the epochs run."""
    from tpuic_torch.checkpoint.manager import CheckpointManager
    from tpuic_torch.train.loop import Trainer
    parts = {"epochs": 0, "fit_s": 0.0, "train_s": 0.0, "data_wait_s": 0.0,
             "val_s": 0.0, "ckpt_s": 0.0}
    saved, active = [], set()

    def timed(cls, name, key):
        orig = getattr(cls, name)
        saved.append((cls, name, orig))

        def wrapper(self, *a, **k):
            if key in active:  # a save's own wait: counted once
                return orig(self, *a, **k)
            active.add(key)
            t0 = time.perf_counter()
            try:
                return orig(self, *a, **k)
            finally:
                active.discard(key)
                parts[key] += time.perf_counter() - t0
                if name == "train_epoch":
                    parts["epochs"] += 1
                    parts["data_wait_s"] += self.stats["data_wait_s"]
        setattr(cls, name, wrapper)

    for cls, name, key in ((Trainer, "fit", "fit_s"),
                           (Trainer, "train_epoch", "train_s"),
                           (Trainer, "val_epoch", "val_s"),
                           (CheckpointManager, "save_best", "ckpt_s"),
                           (CheckpointManager, "maybe_save_latest", "ckpt_s"),
                           (CheckpointManager, "wait", "ckpt_s")):
        timed(cls, name, key)
    try:
        yield parts
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)


def train_row(trainer, stats: dict, counts: dict, batch: int,
              smi: str) -> dict:
    """Step time, images/s and data-wait share of ``trainer``'s epoch: the
    step time between the first and last deferred metric read."""
    drains = stats["drains"]
    (s0, t_0), (s1, t_1) = drains[0], drains[-1]
    step_ms = (t_1 - t_0) / (s1 - s0) * 1e3
    return {"model": trainer.mcfg.name,
            "image": trainer.cfg.data.resize_size, "batch": batch,
            "dtype": trainer.mcfg.dtype, "optimizer": trainer.state.tx.kind,
            "steps": stats["steps"], "wall_s": stats["wall_s"],
            "step_ms": step_ms, "step_ms_window": [s0, s1],
            "images_per_s": batch / step_ms * 1e3,
            "data_wait_s": stats["data_wait_s"],
            "data_wait_share": stats["data_wait_s"] / stats["wall_s"],
            "first_wait_s": stats["first_wait_s"],
            "data_wait_share_after_first": (
                stats["data_wait_s"] - stats["first_wait_s"])
            / (stats["wall_s"] - stats["first_wait_s"]),
            "launches": counts,
            "val_forwards": len(trainer.val_loader),
            "val": {k: trainer.last_val[k] for k in ("accuracy", "loss")},
            "card": smi}


def decode_arm(tag: str, cfg, batch: int, smi: str) -> dict:
    """``cfg``'s ``Trainer`` again on the decode path (``pack=False``: host
    threads decode and augment every image), for the same steps, in the
    same run: its step ms and data-wait beside the packed path's."""
    from tpuic_torch.train.loop import Trainer
    dcfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, pack=False),
        run=dataclasses.replace(cfg.run, resume=False, ckpt_dir=os.path.join(
            cfg.data.data_dir, f"decode_arm_{tag}")))
    trainer = Trainer(dcfg, log=lambda msg: None)
    trainer.fit()
    st = dict(trainer.stats)
    step_ms = _step_ms(st)
    row = {"step_ms": step_ms, "images_per_s": batch / step_ms * 1e3,
           "wall_s": st["wall_s"], "data_wait_s": st["data_wait_s"],
           "data_wait_share": st["data_wait_s"] / st["wall_s"],
           "first_wait_s": st["first_wait_s"],
           "data_wait_share_after_first": (
               st["data_wait_s"] - st["first_wait_s"])
           / (st["wall_s"] - st["first_wait_s"])}
    del trainer
    free()
    log(tag, "the same steps on the decode path (no pack): "
             + json.dumps(row))
    return row


def check_compare(tag: str, arms: dict) -> dict:
    rel = [abs(k["loss"] - p["loss"]) / abs(p["loss"])
           for k, p in zip(arms["kernels"]["metrics"],
                           arms["plain"]["metrics"])]
    row = {"steps": len(rel), "loss_rel_diff": rel,
           "loss_rtol": TRAIN_LOSS_RTOL, **arms}
    log(tag, "kernels vs plain, TF32 off: " + json.dumps(row))
    if any(m["skipped"] or not math.isfinite(m["loss"])
           for a in arms.values() for m in a["metrics"]):
        fail(tag, "a comparison step was skipped or not finite")
    if max(rel) > TRAIN_LOSS_RTOL:
        fail(tag, f"kernel and plain losses differ by {max(rel)} > rtol "
                  f"{TRAIN_LOSS_RTOL}")
    return row


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def first_batches(trainer, k: int = 3) -> list:
    """The first ``k`` batches of the trainer's epoch 1, on the card."""
    it = trainer.train_loader.epoch(1)
    batches = [{n: b[n] for n in ("image", "label", "mask")}
               for b, _ in zip(it, range(k))]
    it.close()
    return batches


def phase_accum(cfg, batches, seed: int, smi: str) -> dict:
    """``[train]``'s ResNet-50 LARS recipe at batch ACCUM_BATCH with
    ``grad_accum_steps`` ACCUM_K for ACCUM_MICRO micro-steps (``[train]``'s
    first two batches of 128, halved), through the kernels (K1, K2a) and
    through the plain loss and LARS, from one state (float32, TF32 off):
    the parameters do not move on the micro-steps between updates, and
    after each real update they lie within ACCUM_RTOL of the plain arm's
    (each tensor's largest difference over its largest magnitude).  K2a
    launches every micro-step, its gate open on the real updates only:
    ACCUM_MICRO launches, ``gradient_step`` ACCUM_MICRO / ACCUM_K."""
    from tpuic_torch.checkpoint import init_params
    from tpuic_torch.kernels import no_tf32
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.train.optimizer import make_optimizer, make_schedule
    from tpuic_torch.train.state import create_train_state
    from tpuic_torch.train.step import make_train_step
    micro = [{k: v[i * ACCUM_BATCH:(i + 1) * ACCUM_BATCH]
              for k, v in b.items()}
             for b in batches[:ACCUM_MICRO * ACCUM_BATCH // TRAIN_BATCH]
             for i in range(TRAIN_BATCH // ACCUM_BATCH)]
    arms, updates = {}, {}
    for arm, fused in (("kernels", True), ("plain", False)):
        model = init_params(create_model_from_config(
            cfg.model, image_size=cfg.data.resize_size), seed, device="cuda")
        ocfg = dataclasses.replace(cfg.optim, learning_rate=COMPARE_LR,
                                   warmup_epochs=0, milestones=(),
                                   fused_loss=fused, fused_optimizer=fused,
                                   grad_accum_steps=ACCUM_K)
        state = create_train_state(model, make_optimizer(ocfg))
        step = make_train_step(ocfg, cfg.model, lr_schedule=make_schedule(
            ocfg, 1, 1), device="cuda", seed=cfg.run.seed)
        params = list(model.parameters())
        moved, times, snaps = [], [], []
        reset_counts()
        with no_tf32(), deterministic_cudnn():
            for i, batch in enumerate(micro):
                before = [p.detach().clone() for p in params]
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                moved.append(any(not torch.equal(a, b)
                                 for a, b in zip(params, before)))
                if (i + 1) % ACCUM_K == 0:
                    snaps.append([p.detach().clone() for p in params])
                del before
        launches = read_counts()
        arms[arm] = {"moved": moved, "step_ms": times,
                     "launches": launches, "loss": float(m["loss"]),
                     "gradient_step": int(state.opt_state.gradient_step),
                     "count": int(state.opt_state.count)}
        updates[arm] = snaps
        del model, state, step, params
        free()
    worst = [max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                  1e-30)
                 for a, b in zip(k, p))
             for k, p in zip(updates["kernels"], updates["plain"])]
    del updates
    free()
    gate = [(i + 1) % ACCUM_K == 0 for i in range(ACCUM_MICRO)]
    k = arms["kernels"]
    row = {"batch": ACCUM_BATCH, "grad_accum_steps": ACCUM_K,
           "micro_steps": ACCUM_MICRO, "gate_open": gate,
           "update_rel_diff": worst, "rtol": ACCUM_RTOL, **arms,
           "card": smi}
    log("accum", json.dumps(row))
    want = expect(cross_entropy_fwd=ACCUM_MICRO,
                  cross_entropy_bwd=ACCUM_MICRO, lars_update=ACCUM_MICRO)
    if (k["moved"] != gate or arms["plain"]["moved"] != gate
            or k["launches"] != want
            or not (k["gradient_step"] == k["count"]
                    == ACCUM_MICRO // ACCUM_K)
            or max(worst) > ACCUM_RTOL
            or not all(math.isfinite(a["loss"]) for a in arms.values())):
        fail("accum", f"moved {k['moved']} / {arms['plain']['moved']} "
                      f"(expected {gate}), launches {k['launches']} "
                      f"(expected {want}), gradient_step "
                      f"{k['gradient_step']}, count {k['count']}, update "
                      f"differences {worst} (rtol {ACCUM_RTOL})")
    return row


def phase_train(root: str, seed: int, smi: str):
    """The training path through ``Trainer``, the kernel-vs-plain 3-step
    comparison and the LAMB run; returns launch counts and the row."""
    from tpuic_torch.train.loop import Trainer
    cfg = train_config(root, seed)
    trainer = Trainer(cfg, log=lambda msg: log("train", msg))
    reset_counts()
    trainer.fit()
    stats = dict(trainer.stats)
    t0 = time.perf_counter()
    trainer.val_epoch(0)
    val_s = time.perf_counter() - t0
    counts = read_counts()
    steps = stats["steps"]
    val_forwards = len(trainer.val_loader)
    want = expect(cross_entropy_fwd=steps, cross_entropy_bwd=steps,
                  lars_update=steps, conv_bn_relu=53 * val_forwards)
    if steps != TRAIN_STEPS or counts != want:
        fail("train", f"{steps} steps, launches {counts}, expected "
                      f"{TRAIN_STEPS} steps and {want}")
    if not all(bool(torch.isfinite(p).all())
               for p in trainer.model.parameters()) or not all(
            math.isfinite(v) for v in trainer.last_val.values()):
        fail("train", f"non-finite state after {steps} steps: val "
                      f"{trainer.last_val}")
    row = train_row(trainer, stats, counts, TRAIN_BATCH, smi)
    # The validation pass (its first call folds the BN into the weights),
    # and one validation forward (K3's 53 launches) on a batch on the card.
    it = trainer.val_loader.epoch(0)
    val_batch = {n: b[n] for b, _ in zip(it, range(1))
                 for n in ("image", "label", "mask")}
    it.close()
    row["val_pass_s"] = val_s
    row["val_forward_ms"] = time_ms(
        lambda: trainer.eval_step(trainer.state, val_batch), iters=5)
    log("train", json.dumps(row))
    batches = first_batches(trainer)
    del trainer
    free()
    row["compare"] = check_compare("train", compare_plain(cfg, batches, seed,
                                                          COMPARE_LR))
    row["accum"] = phase_accum(cfg, batches, seed, smi)
    del batches
    free()

    lcfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=LAMB_BATCH),
        optim=dataclasses.replace(cfg.optim, optimizer="lamb",
                                  learning_rate=1e-2, warmup_epochs=0,
                                  milestones=()),
        run=dataclasses.replace(cfg.run, max_steps=3, log_every_steps=1))
    lamb = Trainer(lcfg, log=lambda msg: log("train", msg))
    reset_counts()
    lamb.fit()
    lamb_counts = read_counts()
    lamb_want = expect(cross_entropy_fwd=3, cross_entropy_bwd=3,
                       lamb_update=3)
    if lamb_counts != lamb_want or not all(
            bool(torch.isfinite(p).all()) for p in lamb.model.parameters()):
        fail("train", f"LAMB run: launches {lamb_counts}, expected "
                      f"{lamb_want}, or non-finite parameters")
    log("train", "LAMB run: " + json.dumps({
        "batch": LAMB_BATCH, "steps": lamb.stats["steps"],
        "launches": lamb_counts, "wall_s": lamb.stats["wall_s"]}))
    del lamb
    free()
    return counts, lamb_counts, row


# One process of ``python -m tpuic_torch.train`` (run as ``__main__``
# through runpy) that counts its kernel launches from 0 at ``fit`` and
# writes them, with the epoch's timing and the val numbers, as JSON.
# ``gloo`` joins the trio's group on the card (gloo carries CUDA tensors;
# NCCL refuses two ranks on one device) before the CLI's ``initialize``,
# which then keeps it.
_DDP_RANK = r"""
import json, os, runpy, sys
out, backend, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
import torch
from tpuic_torch import kernels
from tpuic_torch.train import loop
if backend == "gloo":
    torch.distributed.init_process_group(
        "gloo", init_method="tcp://" + os.environ["TPUIC_COORDINATOR_ADDRESS"],
        world_size=int(os.environ["TPUIC_NUM_PROCESSES"]),
        rank=int(os.environ["TPUIC_PROCESS_ID"]))
counters = {"cross_entropy_fwd": kernels.cross_entropy_fwd,
            "cross_entropy_bwd": kernels.cross_entropy_bwd,
            "lars_update": kernels.lars_update,
            "lamb_update": kernels.lamb_update,
            "conv_bn_relu": kernels.fused_conv_bn_relu,
            "flash_attention_fwd": kernels.flash_attention_fwd,
            "flash_attention_bwd_dq": kernels.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": kernels.flash_attention_bwd_dkv}
_fit = loop.Trainer.fit

def fit(self, *a, **k):
    for fn in counters.values():
        fn.launches = 0
    best = _fit(self, *a, **k)
    torch.cuda.synchronize()
    rec = {"rank": self.rank, "world": self.world,
           "backend": torch.distributed.get_backend(),
           "launches": {n: fn.launches for n, fn in counters.items()},
           "stats": self.stats, "val": self.last_val,
           "val_forwards": len(self.val_loader)}
    with open(os.path.join(out, "rank%d.json" % self.rank), "w") as f:
        json.dump(rec, f)
    return best

loop.Trainer.fit = fit
sys.argv = ["python -m tpuic_torch.train"] + argv
runpy.run_module("tpuic_torch.train", run_name="__main__", alter_sys=True)
"""


def ddp_folder(root: str, dst: str) -> str:
    """``train``'s folder cut to DDP_STEPS global batches: the first
    images of each class of its train fold, linked, and its val fold."""
    os.makedirs(os.path.join(dst, "train"))
    per = TRAIN_BATCH * DDP_STEPS // TRAIN_CLASSES
    for c in sorted(os.listdir(os.path.join(root, "train"))):
        src = os.path.join(root, "train", c)
        os.makedirs(os.path.join(dst, "train", c))
        for name in sorted(os.listdir(src))[:per]:
            os.symlink(os.path.join(src, name),
                       os.path.join(dst, "train", c, name))
    os.symlink(os.path.join(root, "val"), os.path.join(dst, "val"))
    return dst


def _ddp_argv(root: str, work: str, batch: int, seed: int) -> list:
    """``train``'s recipe as train-CLI flags, for one epoch of ``root``."""
    return ["--datadir", root, "--model", "resnet50", "--resize",
            str(IMAGE), "--batchsize", str(batch), "--num-classes", "1000",
            "--optimizer", "lars", "--lr", "4.8", "--weight-decay", "1e-4",
            "--warmup-epochs", "5", "--epochs", "1", "--label-smoothing",
            "0.1", "--no-class-weights", "--milestones", "--fused-loss",
            "--fused-optimizer", "--fused-conv-bn", "--dtype", "float32",
            *DDP_RECIPE, "--workers", "8",
            "--log-every-steps", "1", "--seed", str(seed), "--no-resume",
            "--ckpt-dir", os.path.join(work, "ckpt"), "--log-dir",
            os.path.join(work, "logs")]


def _ddp_start(root: str, work: str, world: int, backend: str, seed: int,
               argv_of=None) -> dict:
    """Start one arm: ``world`` processes of the train CLI on the card,
    joined over ``backend`` (flags ``argv_of(root, work, batch, seed)``,
    default ``_ddp_argv``)."""
    import socket
    os.makedirs(work)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    argv = (argv_of or _ddp_argv)(root, work, TRAIN_BATCH // world, seed)
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)),
            TPUIC_COORDINATOR_ADDRESS=f"localhost:{port}",
            TPUIC_NUM_PROCESSES=str(world), TPUIC_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _DDP_RANK, work, backend, *argv],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return {"work": work, "world": world, "backend": backend,
            "procs": procs, "t0": time.perf_counter()}


def _ddp_kill(arms) -> None:
    for a in arms:
        for p in a["procs"]:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _ddp_finish(tag: str, arm: dict, others=()) -> dict:
    """Wait for ``arm``'s processes: their records, per-step global
    losses and the arm's wall seconds from its start.  On a failure every
    process of ``others`` is stopped too."""
    world, backend, work = arm["world"], arm["backend"], arm["work"]
    outs = []
    try:
        for p in arm["procs"]:
            outs.append(p.communicate(timeout=DDP_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        _ddp_kill([arm, *others])
        fail(tag, f"{backend} x{world}: no end within {DDP_TIMEOUT} s")
    wall = time.perf_counter() - arm["t0"]
    for r, (p, out) in enumerate(zip(arm["procs"], outs)):
        for line in out.splitlines()[-12:]:
            log(tag, f"{backend} rank {r}: {line}")
        if p.returncode:
            _ddp_kill(others)
            fail(tag, f"{backend} x{world}: rank {r} exited {p.returncode}")
    recs = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    logged = os.path.join(work, "logs", "metrics.jsonl")
    return {"recs": recs, "losses": _jsonl_losses(logged),
            "aux": _jsonl_losses(logged, "moe_aux"), "wall_s": wall}


def _jsonl_losses(path: str, key: str = "loss") -> list:
    """Per-step ``key`` values (the loss by default) from a
    ``MetricLogger``'s ``metrics.jsonl``."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r[key] for r in sorted(recs, key=lambda r: r["step"])
            if key in r]


def _step_ms(stats: dict) -> float:
    """Step ms between the first and the last deferred metric read."""
    (s0, t_0), (s1, t_1) = stats["drains"][0], stats["drains"][-1]
    return (t_1 - t_0) / (s1 - s0) * 1e3


def _held(tag: str, name: str, got: list, want: list,
          rtol: float = TRAIN_LOSS_RTOL) -> list:
    if len(got) != DDP_STEPS or len(want) != DDP_STEPS:
        fail(tag, f"{name}: {len(got)} and {len(want)} logged values, "
                  f"expected {DDP_STEPS}")
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    if not all(math.isfinite(v) for v in got) or max(rel) > rtol:
        fail(tag, f"{name}: {got} against {want}, relative "
                  f"difference {max(rel)} > {rtol}")
    return rel


def _ddp_launches(val_forwards: int) -> dict:
    """One process's launches in ``ddp``'s epoch: K1 both ways twice a step
    (the mixed loss's two terms), K2 LARS once a step, K3 53 times per val
    forward."""
    return expect(cross_entropy_fwd=2 * DDP_STEPS,
                  cross_entropy_bwd=2 * DDP_STEPS, lars_update=DDP_STEPS,
                  conv_bn_relu=53 * val_forwards)


def phase_ddp(root: str, seed: int, smi: str) -> dict:
    """Data-parallel training through the train CLI: a one-process NCCL
    group against the one-process ``Trainer``, and two gloo processes on
    the card against it (see the module docstring, ``ddp``); the same
    for the MoE arm (``ddp_moe``).  The one-process ``Trainer``s train
    first, in this process, alone on the card; then the four arms (six
    processes) run at once, so their process starts overlap (their step
    ms are taken with the card shared)."""
    from tpuic_torch.train import __main__ as train_cli
    from tpuic_torch.train.loop import Trainer
    tag = "ddp"
    t_start = time.perf_counter()
    work = tempfile.mkdtemp(prefix="ddp_", dir=root)
    data = ddp_folder(root, os.path.join(work, "data"))
    # The one-process Trainer: the CLI's configuration, in this process.
    parser = train_cli.build_parser()
    cfg = train_cli.config_from_args(parser.parse_args(
        _ddp_argv(data, os.path.join(work, "one"), TRAIN_BATCH, seed)),
        parser)
    one = Trainer(cfg, log=lambda msg: log(tag, f"one process: {msg}"),
                  log_dir=os.path.join(work, "one", "logs"))
    reset_counts()
    one.fit()
    one_counts = read_counts()
    one_losses = _jsonl_losses(os.path.join(work, "one", "logs",
                                            "metrics.jsonl"))
    row = {"steps": DDP_STEPS, "global_batch": TRAIN_BATCH,
           "recipe": list(DDP_RECIPE),
           "drop_path_sites": len(one.model.drop_path_rates()),
           "one_process": {"losses": one_losses,
                           "step_ms": _step_ms(one.stats),
                           "data_wait_share": one.stats["data_wait_s"]
                           / one.stats["wall_s"],
                           "launches": one_counts,
                           "val": {k: one.last_val[k]
                                   for k in ("accuracy", "loss")}}}
    want = _ddp_launches(len(one.val_loader))
    del one
    free()
    if one_counts != want:
        fail(tag, f"one process: launches {one_counts}, expected {want}")
    moe_work = os.path.join(work, "moe")
    moe_one = _ddp_moe_one(data, moe_work, seed)
    t_arms = time.perf_counter()
    started = {
        ("resnet50", "nccl"): _ddp_start(data, os.path.join(work, "nccl"),
                                         1, "nccl", seed),
        ("resnet50", "gloo"): _ddp_start(data, os.path.join(work, "gloo"),
                                         2, "gloo", seed),
        ("moe", "nccl"): _ddp_start(data, os.path.join(moe_work, "nccl"),
                                    1, "nccl", seed, _ddp_moe_argv),
        ("moe", "gloo"): _ddp_start(data, os.path.join(moe_work, "gloo"),
                                    2, "gloo", seed, _ddp_moe_argv)}
    arms = {}
    for name, world, backend, ref in (("nccl", 1, "nccl", one_losses),
                                      ("gloo", 2, "gloo", None)):
        arm = _ddp_finish(tag, started[("resnet50", name)],
                          [a for k, a in started.items()
                           if k != ("resnet50", name)])
        ref = ref if ref is not None else arms["nccl"]["losses"]
        against = "one process" if world == 1 else "arm 1 (nccl)"
        rel = _held(tag, f"{backend} x{world} against {against}",
                    arm["losses"], ref)
        for rec in arm["recs"]:
            if rec["backend"] != backend or rec["world"] != world:
                fail(tag, f"rank {rec['rank']}: {rec['backend']} x"
                          f"{rec['world']}, expected {backend} x{world}")
            per = _ddp_launches(rec["val_forwards"])
            if rec["launches"] != per:
                fail(tag, f"{backend} rank {rec['rank']}: launches "
                          f"{rec['launches']}, expected {per}")
        r0 = arm["recs"][0]
        arms[name] = {
            "world": world, "backend": backend,
            "batch_per_process": TRAIN_BATCH // world,
            "losses": arm["losses"], "loss_rel_diff": rel,
            "against": against,
            "step_ms": [_step_ms(r["stats"]) for r in arm["recs"]],
            "data_wait_s": [r["stats"]["data_wait_s"] for r in arm["recs"]],
            "data_wait_share": [r["stats"]["data_wait_s"]
                                / r["stats"]["wall_s"] for r in arm["recs"]],
            "launches": [r["launches"] for r in arm["recs"]],
            "val_forwards": [r["val_forwards"] for r in arm["recs"]],
            "val": {k: r0["val"][k] for k in ("accuracy", "loss")},
            "wall_s": arm["wall_s"]}
        log(tag, f"{backend} x{world}: " + json.dumps(arms[name]))
    row["moe"] = ddp_moe(moe_one, {k[1]: a for k, a in started.items()
                                   if k[0] == "moe"})
    row.update(arms=arms, arms_wall_s=time.perf_counter() - t_arms,
               loss_rtol=TRAIN_LOSS_RTOL, card=smi,
               phase_s=time.perf_counter() - t_start)
    log(tag, json.dumps({k: v for k, v in row.items()
                         if k not in ("arms", "moe")}))
    return row


def _ddp_moe_argv(root: str, work: str, batch: int, seed: int) -> list:
    """``[ddp]``'s MoE arm as train-CLI flags: vit-tiny-moe at 32 px with
    drop-path 0.1, flash attention, the fused loss and LAMB (K2b)."""
    return ["--datadir", root, *DDP_MOE_ARGS, "--batchsize", str(batch),
            "--num-classes", "1000", "--epochs", "1", "--no-class-weights",
            "--milestones", "--fused-loss", "--fused-optimizer", "--dtype",
            "float32", "--workers", "8", "--log-every-steps", "1", "--seed",
            str(seed), "--no-resume", "--ckpt-dir",
            os.path.join(work, "ckpt"), "--log-dir",
            os.path.join(work, "logs")]


def _ddp_moe_launches(val_forwards: int) -> dict:
    """One process's launches in the MoE arm's epoch: K1 both ways and K2b
    once a step, K4's forward 2 a step and 2 a val forward (depth 2), its
    backward pair 2 a step."""
    return expect(cross_entropy_fwd=DDP_STEPS, cross_entropy_bwd=DDP_STEPS,
                  lamb_update=DDP_STEPS,
                  flash_attention_fwd=2 * (DDP_STEPS + val_forwards),
                  flash_attention_bwd_dq=2 * DDP_STEPS,
                  flash_attention_bwd_dkv=2 * DDP_STEPS)


def _ddp_moe_one(data: str, work: str, seed: int) -> dict:
    """``[ddp]``'s MoE arm's one-process ``Trainer`` (vit-tiny-moe with
    drop-path 0.1) in this process: its losses, aux losses, launches and
    drop-path sites."""
    from tpuic_torch.train import __main__ as train_cli
    from tpuic_torch.train.loop import Trainer
    tag = "ddp"
    parser = train_cli.build_parser()
    cfg = train_cli.config_from_args(parser.parse_args(_ddp_moe_argv(
        data, os.path.join(work, "one"), TRAIN_BATCH, seed)), parser)
    one = Trainer(cfg, log=lambda msg: log(tag, f"moe one process: {msg}"),
                  log_dir=os.path.join(work, "one", "logs"))
    reset_counts()
    one.fit()
    one_counts = read_counts()
    sites = len(one.model.backbone.drop_path_rates())
    want = _ddp_moe_launches(len(one.val_loader))
    logged = os.path.join(work, "one", "logs", "metrics.jsonl")
    out = {"losses": _jsonl_losses(logged),
           "aux": _jsonl_losses(logged, "moe_aux"), "launches": one_counts,
           "drop_path_sites": sites}
    del one
    free()
    if one_counts != want or not sites:
        fail(tag, f"moe one process: launches {one_counts}, expected "
                  f"{want}; {sites} drop-path sites")
    return out


def ddp_moe(one: dict, started: dict) -> dict:
    """``[ddp]``'s MoE arm: vit-tiny-moe with drop-path 0.1 (the drop-path
    masks and the aux loss's all-reduce across ranks), one NCCL process
    against the one-process ``Trainer`` (``one``, ``_ddp_moe_one``'s) and
    two gloo ranks on the card against it, each step's loss within
    TRAIN_LOSS_RTOL and its global aux loss within MOE_AUX_RTOL, with the
    launches of each process.  ``started``: the two arms, running."""
    tag = "ddp"
    row = {"model": "vit-tiny-moe", "image": 32,
           "drop_path_sites": one["drop_path_sites"],
           "one_process": {k: one[k] for k in ("losses", "aux",
                                               "launches")},
           "arms": {}}
    for name, world, backend in (("nccl", 1, "nccl"), ("gloo", 2, "gloo")):
        arm = _ddp_finish(tag, started[name],
                          [a for k, a in started.items() if k != name])
        rel = _held(tag, f"moe {backend} x{world} against one process",
                    arm["losses"], one["losses"])
        # The aux term is ~0.01 of the loss: held on its own, tightly.
        aux_rel = _held(tag, f"moe {backend} x{world} aux loss against one "
                             f"process", arm["aux"], one["aux"],
                        MOE_AUX_RTOL)
        for rec in arm["recs"]:
            per = _ddp_moe_launches(rec["val_forwards"])
            if rec["launches"] != per or rec["world"] != world:
                fail(tag, f"moe {backend} rank {rec['rank']}: launches "
                          f"{rec['launches']}, expected {per}")
        row["arms"][name] = {
            "world": world, "losses": arm["losses"], "loss_rel_diff": rel,
            "aux": arm["aux"], "aux_rel_diff": aux_rel,
            "step_ms": [_step_ms(r["stats"]) for r in arm["recs"]],
            "launches": [r["launches"] for r in arm["recs"]],
            "wall_s": arm["wall_s"]}
    log(tag, "moe arm: " + json.dumps(row))
    return row


def _flip_byte(path: str, offset: int = 4096) -> None:
    """One byte of ``path`` XOR 0xFF, its size kept."""
    with open(path, "r+b") as f:
        f.seek(min(offset, os.path.getsize(path) - 1))
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _mismatches(got: dict, want: dict) -> list:
    """Names of the tensors of two ``snapshot``s whose bits differ."""
    def flat(snap):
        out = {f"model/{k}": v for k, v in snap["model"].items()}
        for k, v in snap["opt_state"].items():
            for i, t in enumerate(v if isinstance(v, list) else [v]):
                out[f"opt/{k}/{i}"] = t
        out["step"], out["skip_count"] = snap["step"], snap["skip_count"]
        return out
    g, w = flat(got), flat(want)
    if sorted(g) != sorted(w):
        return sorted(set(g) ^ set(w))
    return [k for k in w if not torch.equal(g[k], w[k])]


def phase_ckpt(root: str, seed: int, ckpt_dir: str) -> dict:
    """The checkpoint on the card with ``[train]``'s configuration: a
    ``Trainer`` takes CKPT_STEPS steps and saves ``best`` and ``latest``;
    a fresh ``Trainer`` restores them (``latest``, the newer on a tie);
    every parameter, BN buffer and K2 optimizer-state tensor must equal
    the saved one bit for bit; the next step on one batch, under
    ``deterministic_cudnn()``, must give the uninterrupted trainer's loss
    exactly; then one byte of ``latest``'s payload is flipped and the
    restore must fall back to ``best``, again bit for bit.  Reports the
    payload's bytes and the host and disk seconds to snapshot, commit and
    restore.  The checkpoint stays in ``ckpt_dir`` for ``serve-cli`` and
    ``predict``, with the ``Trainer``'s val accuracy of its ``best``
    save (``row["best_val_accuracy"]``)."""
    from tpuic_torch.checkpoint.manager import PAYLOAD, snapshot
    from tpuic_torch.train.loop import Trainer
    base = train_config(root, seed)
    cfg = dataclasses.replace(base, run=dataclasses.replace(
        base.run, max_steps=CKPT_STEPS, ckpt_dir=ckpt_dir))
    first = Trainer(cfg, log=lambda msg: log("ckpt", msg))
    if first.start_epoch != 0:
        fail("ckpt", f"an empty checkpoint directory resumed at epoch "
                     f"{first.start_epoch}")
    first.fit()
    first.ckpt.save_best(first.state, 0, 12.5)
    first.ckpt.wait()
    saves = {"best": dict(first.ckpt.last_save)}
    first.ckpt.save_latest(first.state, 0, 12.5)
    first.ckpt.wait()
    saves["latest"] = dict(first.ckpt.last_save)
    want = snapshot(first.state)
    second = Trainer(cfg, log=lambda msg: log("ckpt", msg))
    rung, restore_s = (second.ckpt.last_restore_rung,
                       second.ckpt.last_restore_s)
    bad = _mismatches(snapshot(second.state), want)
    if rung != "latest" or second.start_epoch != 1 or bad:
        fail("ckpt", f"restored rung {rung}, start epoch "
                     f"{second.start_epoch}, {len(bad)} tensors differ "
                     f"from the save: {bad[:5]}")
    batch = first_batches(first, 1)[0]
    with deterministic_cudnn():
        _, m1 = first.train_step(first.state, batch)
        _, m2 = second.train_step(second.state, batch)
        losses = [float(m1["loss"]), float(m2["loss"])]
    after = _mismatches(snapshot(second.state), snapshot(first.state))
    if losses[0] != losses[1] or not math.isfinite(losses[0]):
        fail("ckpt", f"the next step's loss after the restore, "
                     f"{losses[1]!r}, is not the uninterrupted run's "
                     f"{losses[0]!r}")
    _flip_byte(os.path.join(first.ckpt.root, "latest", PAYLOAD))
    _, start, _ = second.ckpt.restore_into(second.state)
    fallback, fallback_s = (second.ckpt.last_restore_rung,
                            second.ckpt.last_restore_s)
    bad = _mismatches(snapshot(second.state), want)
    if fallback != "best" or start != 1 or bad:
        fail("ckpt", f"with latest corrupt the restore took rung "
                     f"{fallback} (start epoch {start}), {len(bad)} "
                     f"tensors differ from the save: {bad[:5]}")
    best_val = second.val_epoch(0)  # the state is best's, bit for bit
    # The same model's top-1 per val image and its margin over the
    # runner-up, for ``predict``'s rows.
    second.model.eval()
    best_top1 = {}
    with torch.inference_mode():
        for batch in second.val_loader.epoch(0):
            top2 = second.model(batch["image"]).topk(2, dim=-1)
            idx = top2.indices[:, 0].cpu().numpy()
            gap = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
            for iid, i, g, m in zip(batch.image_ids, idx, gap,
                                    batch["mask"].cpu().numpy()):
                if m > 0:
                    best_top1[iid] = (int(i), float(g))
    n_tensors = (len(want["model"]) + 3 + sum(
        len(v) for v in want["opt_state"].values()
        if isinstance(v, list)))
    row = {"model": first.mcfg.name, "optimizer": first.state.tx.kind,
           "steps_before_save": CKPT_STEPS, "tensors": n_tensors,
           "payload_bytes": saves["latest"]["bytes"],
           "host_and_disk_s": {
               "snapshot": {k: v["snapshot_s"] for k, v in saves.items()},
               "commit": {k: v["commit_s"] for k, v in saves.items()},
               "restore": restore_s, "restore_after_fallback": fallback_s},
           "restored_rung": rung, "restore_bits_equal": True,
           "next_step_loss": losses,
           "tensors_differing_after_next_step": len(after),
           "corrupt_latest_restored_rung": fallback,
           "fallback_bits_equal": True,
           "best_val_accuracy": best_val}
    log("ckpt", json.dumps(row))
    row["best_top1"] = best_top1
    del first, second
    free()
    return row


def _ckpt_model(ckpt_dir: str):
    """``[ckpt]``'s ``best`` ResNet-50 through the loading path the CLIs
    use, on the card, and its class names."""
    from tpuic_torch.checkpoint.loading import load_inference_variables
    from tpuic_torch.config import Config, DataConfig, RunConfig
    from tpuic_torch.predict import serving_model_config
    cfg = Config(data=DataConfig(data_dir=".", resize_size=IMAGE),
                 model=serving_model_config("resnet50", 1000),
                 run=RunConfig(ckpt_dir=ckpt_dir))
    model = load_inference_variables(cfg, track="best", log=lambda m: None)
    with open(os.path.join(ckpt_dir, "resnet50", "class_to_idx.json")) as f:
        names = {int(v): k for k, v in json.load(f).items()}
    return model, names


def _serve_cmd(ckpt_dir: str, *extra) -> list:
    return [sys.executable, "-m", "tpuic_torch.serve", "--ckpt-dir",
            ckpt_dir, "--model", "auto", "--buckets", "1,8,32", "--top-k",
            "5", *extra]


class _Records:
    """Newline-framed JSON records from a socket, the partial tail kept
    between reads."""

    def __init__(self, sock) -> None:
        self.sock, self.buf = sock, b""

    def read(self, done) -> list:
        """Records until ``done(records so far)`` holds or the peer
        closes."""
        out = []
        while not done(out):
            chunk = self.sock.recv(1 << 16)
            if not chunk:
                break
            *recs, self.buf = (self.buf + chunk).split(b"\n")
            out.extend(json.loads(r) for r in recs if r.strip())
        return out


def _start_listen(root: str, ckpt_dir: str, name: str) -> dict:
    """Start ``python -m tpuic_torch.serve --listen`` on ``[ckpt]``'s
    checkpoint, ready file and stderr named for ``name``: ``[serve-cli]``
    and ``[swap-cli]`` start theirs beside the stdin server, so the
    three process starts overlap.  Killed at exit if still running."""
    import atexit
    here = os.path.dirname(os.path.abspath(__file__))
    ready = os.path.join(root, f"{name}_ready.json")
    err_path = os.path.join(root, f"{name}_listen.err")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            _serve_cmd(ckpt_dir, "--listen", "127.0.0.1:0", "--ready-file",
                       ready), env=dict(os.environ, PYTHONPATH=here),
            cwd=here, stdout=subprocess.DEVNULL, stderr=err)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "ready": ready, "err": err_path,
            "t0": time.perf_counter()}


def phase_serve_cli(root: str, ckpt_dir: str, smi: str,
                    server: dict) -> dict:
    """``python -m tpuic_torch.serve`` as a user runs it, on ``[ckpt]``'s
    ResNet-50 checkpoint with ``--model auto``: CLI_IMAGES image files of
    the synthetic folder over stdin JSONL, each record's top-5
    probabilities held against a direct forward of the same decoded
    pixels (SERVE_TOL); then a ``--listen`` server: its ready file, a
    ping, requests by path and by b64 payload, a burst and SIGTERM, after
    which it must exit 0 with every request answered."""
    import glob
    import signal
    import socket

    from tpuic_torch.checkpoint.loading import variables_digest
    from tpuic_torch.serve import make_forward, wire
    from tpuic_torch.serve.__main__ import _load_image
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    paths = sorted(glob.glob(os.path.join(root, "val", "*", "*.png")))
    paths = paths[::max(1, len(paths) // CLI_IMAGES)][:CLI_IMAGES]
    t0 = time.perf_counter()
    out = subprocess.run(_serve_cmd(ckpt_dir), input="".join(
        json.dumps({"id": p, "path": p}) + "\n" for p in paths),
        capture_output=True, text=True, timeout=600, env=env, cwd=here)
    stdin_s = time.perf_counter() - t0
    if out.returncode != 0:
        fail("serve-cli", f"stdin server exited {out.returncode}: "
                          f"{out.stderr[-3000:]}")
    recs = {r["id"]: r for r in map(json.loads, out.stdout.splitlines())}
    for line in out.stderr.splitlines():
        if "warmup" in line or "auto-resolved" in line:
            log("serve-cli", line)
    model, names = _ckpt_model(ckpt_dir)
    index = {v: k for k, v in names.items()}
    x = torch.from_numpy(np.stack([_load_image(p, IMAGE)
                                   for p in paths])).cuda()
    probs, order = (t.cpu().numpy() for t in make_forward(
        model, normalize=True)(x))
    worst, top1 = 0.0, 0
    for i, p in enumerate(paths):
        rec = recs.get(p)
        if rec is None or "pred" not in rec or len(rec["topk"]) != 5:
            fail("serve-cli", f"no answer for {p}: {rec}")
        for name, q in rec["topk"]:
            j = index.get(name, None if not name.isdigit() else int(name))
            worst = max(worst, abs(q - float(probs[i, j])))
        a, b = order[i, 0], order[i, 1]
        if rec["pred"] == names.get(int(a), str(a)):
            top1 += 1
        elif probs[i, a] - probs[i, b] > SERVE_TOL:
            fail("serve-cli", f"{p}: top-1 {rec['pred']} against the direct "
                              f"forward's {names.get(int(a), str(a))}")
    # Records carry probabilities rounded to 6 decimals (tpuic's format).
    if worst > SERVE_TOL:
        fail("serve-cli", f"served probabilities differ from a direct "
                          f"forward by {worst} > {SERVE_TOL}")
    digest = variables_digest(model)
    del model, x
    free()

    # The --listen server, started beside the stdin server.
    proc, err_path = server["proc"], server["err"]
    try:
        ready = _await_ready("serve-cli", server["ready"], server["proc"],
                             server["err"])
        ready_s = time.perf_counter() - server["t0"]
        img = _load_image(paths[0], IMAGE)[None]
        with socket.create_connection(("127.0.0.1", ready["port"]),
                                      timeout=300) as sock:
            lines = [{"op": "ping", "id": "ping"}]
            lines += [{"id": f"p{i}", "path": p}
                      for i, p in enumerate(paths[:8])]
            lines += [{"id": f"b{i}", **wire.encode_array(img)}
                      for i in range(8)]
            sock.sendall("".join(json.dumps(r) + "\n"
                                 for r in lines).encode())
            reader = _Records(sock)
            first = {r["id"]: r for r in reader.read(
                lambda got: len(got) >= len(lines))}
            # A burst, then a ping: the server reads a connection's lines
            # in order, so its pong means every burst line was accepted
            # (SIGTERM before that would close a socket holding unread
            # requests).  Then SIGTERM while the burst is in flight.
            burst = [{"id": f"s{i}", **wire.encode_array(img)}
                     for i in range(32)]
            sock.sendall("".join(json.dumps(r) + "\n" for r in burst
                                 + [{"op": "ping", "id": "ping2"}]).encode())
            rest = reader.read(lambda got: any(r.get("id") == "ping2"
                                               for r in got))
            proc.send_signal(signal.SIGTERM)
            rest += reader.read(lambda got: False)  # to the server's close
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    pong = first.get("ping", {})
    answered = [r for r in list(first.values()) + rest if "pred" in r]
    if (rc != 0 or pong.get("op") != "pong" or pong.get("digest") != digest
            or ready.get("digest") != digest or pong.get("generation") != 0
            or len(answered) != 16 + len(burst)):
        fail("serve-cli", f"--listen: exit {rc}, pong {pong}, ready "
                          f"{ready}, {len(answered)} of {16 + len(burst)} "
                          f"answered; {open(err_path).read()[-2000:]}")
    stats = [ln for ln in open(err_path).read().splitlines()
             if "served" in ln or "SIGTERM" in ln]
    row = {"images": len(paths), "stdin_wall_s": stdin_s,
           "max_abs_err_vs_direct": worst, "top1_equal": top1,
           "listen_ready_s": ready_s, "listen_exit": rc,
           "listen_answered": len(answered), "digest": digest,
           "listen_log": stats[-2:], "card": smi}
    log("serve-cli", json.dumps(row))
    return row


def phase_swap_cli(root: str, ckpt_dir: str, digest: str, smi: str,
                   server: dict) -> dict:
    """Swap lines through ``python -m tpuic_torch.serve --listen`` on
    ``[ckpt]``'s checkpoint (``server``, started with ``[serve-cli]``'s
    stdin server): a ping; requests with ``{"op": "swap",
    "synthetic_seed": 1}`` among them, answered by a ``swap_result`` of
    generation 1 and then a pong and a ready file with its digest; a swap
    back to the checkpoint by ``ckpt_dir``, after which answers equal a
    direct forward of the checkpoint's model (SERVE_TOL) and the digest
    is ``[serve-cli]``'s again; a swap from a copy of the checkpoint with
    one byte flipped, refused with a typed ``swap_corrupt`` record while
    the digest and generation stay; then a burst, SIGTERM, exit 0 and
    every request answered."""
    import glob
    import shutil
    import signal
    import socket

    from tpuic_torch.checkpoint.manager import PAYLOAD
    from tpuic_torch.serve import make_forward, wire
    from tpuic_torch.serve.__main__ import _load_image
    tag = "swap-cli"
    paths = sorted(glob.glob(os.path.join(root, "val", "*", "*.png")))[:16]
    model, names = _ckpt_model(ckpt_dir)
    index = {v: k for k, v in names.items()}
    x = torch.from_numpy(np.stack([_load_image(p, IMAGE)
                                   for p in paths])).cuda()
    probs = make_forward(model, normalize=True)(x)[0].cpu().numpy()
    del model, x
    free()
    flipped = os.path.join(root, "ckpt_flipped")
    shutil.copytree(ckpt_dir, flipped)
    _flip_byte(os.path.join(flipped, "resnet50", "best", PAYLOAD))
    # The --listen server (``server``), started beside [serve-cli]'s.
    proc, err_path, ready_file = (server["proc"], server["err"],
                                  server["ready"])
    seen = {}
    try:
        port = _await_ready(tag, ready_file, proc, err_path)["port"]
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=300) as sock:
            reader = _Records(sock)

            def ask(lines, *ids):
                sock.sendall("".join(json.dumps(r) + "\n"
                                     for r in lines).encode())
                for r in reader.read(lambda got: all(
                        i in seen or any(g.get("id") == i for g in got)
                        for i in ids)):
                    seen[r.get("id")] = r
                return [seen[i] for i in ids]

            def req(prefix, n):
                return [{"id": f"{prefix}{i}", "path": paths[i % 16]}
                        for i in range(n)]

            (p0,) = ask([{"op": "ping", "id": "p0"}], "p0")
            t_swap = time.perf_counter()
            s1, p1 = ask(req("a", 8) + [{"op": "swap", "id": "s1",
                                         "synthetic_seed": 1}]
                         + req("b", 8) + [{"op": "ping", "id": "p1"}],
                         "s1", "p1")
            swap1_s = time.perf_counter() - t_swap
            *_, p2 = ask([{"op": "ping", "id": "p2"}],
                         *[f"{c}{i}" for c in "ab" for i in range(8)], "p2")
            ready = wire.read_ready_file(ready_file)
            s2, *_ = ask([{"op": "swap", "id": "s2", "ckpt_dir": ckpt_dir,
                           "track": "best"}], "s2")
            answers = ask(req("c", 16), *[f"c{i}" for i in range(16)])
            s3, p3 = ask([{"op": "swap", "id": "s3", "ckpt_dir": flipped,
                           "track": "best"}, {"op": "ping", "id": "p3"}],
                         "s3", "p3")
            (p4,) = ask([{"op": "ping", "id": "p4"}], "p4")
            burst = req("d", 16) + [{"op": "ping", "id": "p5"}]
            ask(burst, "p5")
            proc.send_signal(signal.SIGTERM)
            for r in reader.read(lambda got: False):  # to the server's close
                seen[r.get("id")] = r
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    worst = 0.0
    for i, rec in enumerate(answers):
        if "pred" not in rec:
            fail(tag, f"no answer after the swap back: {rec}")
        for name, q in rec["topk"]:
            j = index.get(name, None if not name.isdigit() else int(name))
            worst = max(worst, abs(q - float(probs[i % 16, j])))
    ids = [f"{c}{i}" for c in "ab" for i in range(8)] + \
        [f"c{i}" for i in range(16)] + [f"d{i}" for i in range(16)]
    answered = sum("pred" in seen.get(i, {}) for i in ids)
    new_digest = s1.get("digest")
    if (rc != 0 or p0.get("generation") != 0 or p0.get("digest") != digest
            or not s1.get("ok") or s1.get("generation") != 1
            or new_digest == digest
            or (p2.get("digest"), p2.get("generation")) != (new_digest, 1)
            or (ready.get("digest"), ready.get("generation"))
            != (new_digest, 1)
            or not s2.get("ok") or s2.get("generation") != 2
            or s2.get("digest") != digest or worst > SERVE_TOL
            or s3.get("cause") != "swap_corrupt"
            or (p4.get("digest"), p4.get("generation")) != (digest, 2)
            or answered != len(ids)):
        fail(tag, f"exit {rc}; pongs {p0} {p2} {p4}; ready {ready}; swaps "
                  f"{s1} {s2} {s3}; served against direct {worst}; "
                  f"{answered} of {len(ids)} answered; "
                  f"{open(err_path).read()[-2000:]}")
    row = {"answered": answered, "exit": rc,
           "swap_synthetic": {k: s1[k] for k in (
               "generation", "digest", "reused_executables", "prewarmed",
               "duration_s", "batcher_hold_s")},
           "swap_synthetic_line_to_result_s": swap1_s,
           "pong_after": {k: p2[k] for k in ("digest", "generation")},
           "swap_back": {k: s2[k] for k in ("generation", "digest",
                                            "reused_executables",
                                            "duration_s")},
           "max_abs_err_vs_direct_after_swap_back": worst,
           "corrupt": {k: s3.get(k) for k in ("cause", "error")},
           "pong_after_corrupt": {k: p4[k] for k in ("digest",
                                                     "generation")},
           "log": [ln for ln in open(err_path).read().splitlines()
                   if "hot-swap" in ln or "[swap]" in ln or "served" in ln
                   ][-6:], "card": smi}
    log(tag, json.dumps(row))
    return row


def phase_predict(root: str, ckpt_dir: str, val_accuracy: float,
                  best_top1: dict) -> dict:
    """``python -m tpuic_torch.predict`` (its ``main``) over the synthetic
    folder's val fold from ``[ckpt]``'s ``best`` track, at the
    ``Trainer``'s val batch: its accuracy must equal the ``Trainer``'s val
    accuracy for that save exactly; every batch must reach the engine as a
    tensor on the card (no host bounce); K3 launches 53 times per device
    call, the warmup's eager run and replay included; each row's top-1
    equals that of the ``Trainer``'s model called on the image wherever
    its top logit leads the next by more than MODEL_TOL."""
    import csv
    import io

    from tpuic_torch import predict
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = predict.main(["--datadir", root, "--ckpt-dir", ckpt_dir,
                           "--fold", "val", "--batchsize", str(TRAIN_BATCH),
                           "--top-k", "5",
                           "--out", os.path.join(root, "predict.csv")])
    wall = time.perf_counter() - t0
    counts = read_counts()
    printed = buf.getvalue().strip().splitlines()
    for line in printed[:-1]:
        log("predict", line)
    summary = json.loads(printed[-1])
    eng = summary.pop("engine")
    n_buckets = eng["compiles"]
    batches = 2  # the val fold holds 2 x TRAIN_BATCH images
    want = expect(conv_bn_relu=53 * (eng["device_calls"] + 2 * n_buckets))
    if rc != 0 or summary.get("accuracy") != val_accuracy:
        fail("predict", f"accuracy {summary.get('accuracy')!r}, the "
                        f"Trainer's {val_accuracy!r} (exit {rc})")
    if (summary["device_requests"] != batches or summary["host_requests"]
            or summary["full_batches"] != batches or counts != want):
        fail("predict", f"{summary}: expected {batches} full batches, all "
                        f"on the card; launches {counts}, expected {want}")
    with open(os.path.join(ckpt_dir, "resnet50", "class_to_idx.json")) as f:
        index = json.load(f)
    with open(os.path.join(root, "predict.csv")) as f:
        rows = list(csv.DictReader(f))
    same, ties = 0, 0
    for r in rows:
        want, gap = best_top1[r["image_id"]]
        got = index.get(r["pred"], None if not r["pred"].isdigit()
                        else int(r["pred"]))
        if got == want:
            same += 1
        elif gap > MODEL_TOL:
            fail("predict", f"{r['image_id']}: predicted {got}, the "
                            f"Trainer's model {want} (logit gap {gap})")
        else:
            ties += 1
    if len(rows) != len(best_top1):
        fail("predict", f"{len(rows)} CSV rows for {len(best_top1)} images")
    row = {**summary, "trainer_val_accuracy": val_accuracy,
           "top1_equal_to_trainer_model": same, "near_ties": ties,
           "wall_s": wall, "launches": counts,
           "device_calls": eng["device_calls"], "buckets": n_buckets,
           "latency_ms": eng["latency_ms"], "span_ms": eng["span_ms"]}
    log("predict", json.dumps(row))
    return row


MOE_SHAPE_KEY = "vit-s16-moe [64, 197, 6, 64]"
K4 = ("flash_attention_fwd", "flash_attention_bwd_dq",
      "flash_attention_bwd_dkv")


def attn_work(b: int, n: int = ATTN_N, h: int = ATTN_H, d: int = ATTN_D,
              itemsize: int = 4) -> dict:
    """(FLOPs, bytes) of each K4 kernel at [b, n, h, d]: the reference's
    CostEstimate FLOPs (4*B*H*N^2*D forward, 5*B*H*N^2*D per backward
    kernel, flash_attention.py:336, :465, :493) at the unpadded N; each
    input read once and each output written once (q/k/v/o/do/dq/dk/dv
    [B, N, H, D], lse and delta float32 [B, H, N])."""
    t = b * n * h * d * itemsize
    r = b * h * n * 4
    nnd = b * h * n * n * d
    return {"flash_attention_fwd": (4.0 * nnd, 3 * t + t + r),
            "flash_attention_bwd_dq": (5.0 * nnd, 5 * t + r + t + r),
            "flash_attention_bwd_dkv": (5.0 * nnd, 4 * t + 2 * r + 2 * t)}


@contextlib.contextmanager
def tf32_on():
    """TF32 allowed in cuBLAS matmuls and cuDNN convolutions in the block;
    restores both flags on exit."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def phase_attn(device_name: str, gen: torch.Generator):
    """K4 against its plain versions at the ViT-B/16 shapes, ViT-S/16-MoE's
    [64, 197, 6, 64] and the masked cases, then timed.  Returns the
    summaries at [64, 197, 12, 64] (with the MoE shape's under
    MOE_SHAPE_KEY) in float32 and bf16, and every row."""
    from tpuic_torch.kernels import no_tf32
    FA = importlib.import_module("tpuic_torch.kernels.flash_attention")
    _, peak_flops, hbm = peaks(device_name)
    tc_peak = {torch.float32: tf32_peak(device_name) / 3,  # 3xTF32
               torch.bfloat16: bf16_peak(device_name)}

    def inputs(b, n, dtype=torch.float32, h=ATTN_H):
        # q/k/v as the ViT makes them: strided views of one projection.
        qkv = torch.randn((b, n, 3 * h * ATTN_D), generator=gen)
        q, k, v = (t.view(b, n, h, ATTN_D)
                   for t in qkv.cuda().to(dtype).split(h * ATTN_D, -1))
        do = torch.randn((b, n, h, ATTN_D), generator=gen)
        return q, k, v, do.cuda().to(dtype)

    def check(label, q, k, v, do, tol, sentinel=0.0, backward=True, **mask):
        o, lse = FA.flash_attention_fwd(q, k, v, masked_sentinel=sentinel,
                                        **mask)
        dq, delta = FA.flash_attention_bwd_dq(q, k, v, o, lse, do, **mask)
        dk, dv = FA.flash_attention_bwd_dkv(q, k, v, lse, delta, do, **mask)
        torch.cuda.synchronize()
        want_o, want_lse = FA.flash_attention_fwd_plain(
            q, k, v, masked_sentinel=sentinel, **mask)
        wdq, wdk, wdv = FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                     **mask)
        want_delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
        pairs = {"flash_attention_fwd": ((o, lse), (want_o, want_lse)),
                 "flash_attention_bwd_dq": ((dq, delta), (wdq, want_delta)),
                 "flash_attention_bwd_dkv": ((dk, dv), (wdk, wdv))}
        if not backward:
            pairs = {"flash_attention_fwd": pairs["flash_attention_fwd"]}
        errs = {name: max_err([t.float() for t in got],
                              [t.float() for t in want])
                for name, (got, want) in pairs.items()}
        bad = [name for name, (got, want) in pairs.items()
               if not all(torch.allclose(a.float(), b.float(), rtol=tol,
                                         atol=tol)
                          for a, b in zip(got, want))]
        if bad:
            fail("attn", f"{label}: {bad} beyond atol/rtol {tol}; max abs "
                         f"err {errs}")
        log("attn", f"{label}: max abs err {json.dumps(errs)} (atol/rtol "
                    f"{tol})")
        return errs, (o, lse, delta), (dq, dk, dv)

    def tf32_checks(label, q, k, v, o, lse, do, grads):
        """The float32 kernels are 3xTF32 whatever the TF32 flags say: the
        forward's o and lse and the backward's dq, dk, dv have the same
        bits with TF32 allowed.  And the tolerance tells 3xTF32 from one
        TF32 pass: the plain forward and the plain backward with their
        products in TF32 must each fall outside it.  Returns the two
        controls' max abs errors (forward, backward)."""
        want_fwd = FA.flash_attention_fwd_plain(q, k, v)
        want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
        with tf32_on():
            fwd = FA.flash_attention_fwd(q, k, v)
            dq, delta = FA.flash_attention_bwd_dq(q, k, v, o, lse, do)
            dk, dv = FA.flash_attention_bwd_dkv(q, k, v, lse, delta, do)
            single_fwd = FA.flash_attention_fwd_plain(q, k, v)
            single = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
            torch.cuda.synchronize()
        if not (torch.equal(fwd[0], o) and torch.equal(fwd[1], lse)):
            fail("attn", f"{label}: o/lse differ between allow_tf32 False "
                         "and True")
        if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), grads)):
            fail("attn", f"{label}: dq/dk/dv differ between allow_tf32 "
                         "False and True")
        errs = []
        for what, got, ref in (("forward", single_fwd, want_fwd),
                               ("backward", single, want)):
            err = max_err(got, ref)
            if all(torch.allclose(a, b, rtol=F32_TOL, atol=F32_TOL)
                   for a, b in zip(got, ref)):
                fail("attn", f"{label}: the plain {what} in single-pass TF32 "
                             f"is within atol/rtol {F32_TOL} of float32 "
                             f"(max abs err {err}), so the check cannot tell "
                             "it from 3xTF32")
            errs.append(err)
        log("attn", f"{label}: o, lse, dq, dk, dv bitwise equal under "
                    "allow_tf32 False and True; the plain forward in TF32 "
                    f"is {errs[0]} off, the plain backward {errs[1]}, both "
                    f"outside atol/rtol {F32_TOL}")
        return errs

    from tpuic_torch.kernels.flash_attention_bench import earlier_bf16_fwd
    rows, main, main_bf16 = [], {}, {}
    with no_tf32():
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            dname = str(dtype).replace("torch.", "")
            for b, h in ATTN_SHAPES:
                label = f"{dname} [{b}, {ATTN_N}, {h}, {ATTN_D}]"
                q, k, v, do = inputs(b, ATTN_N, dtype, h)
                errs, (o, lse, delta), grads = check(label, q, k, v, do, tol)
                tf32_err = (tf32_checks(label, q, k, v, o, lse, do, grads)
                            if dtype == torch.float32 else None)
                del grads
                fwd_device = {"kernel": device_ms(
                                  lambda: FA.flash_attention_fwd(q, k, v)),
                              "sdpa": device_ms(
                                  lambda: F.scaled_dot_product_attention(
                                      *(t.transpose(1, 2)
                                        for t in (q, k, v))))}
                ms = {"flash_attention_fwd": time_ms(
                          lambda: FA.flash_attention_fwd(q, k, v)),
                      "flash_attention_bwd_dq": time_ms(
                          lambda: FA.flash_attention_bwd_dq(q, k, v, o, lse,
                                                            do)),
                      "flash_attention_bwd_dkv": time_ms(
                          lambda: FA.flash_attention_bwd_dkv(q, k, v, lse,
                                                             delta, do))}
                # The plain backward computes dq, dk and dv in one
                # function: its time stands beside each backward kernel.
                plain = {"fwd": time_ms(
                             lambda: FA.flash_attention_fwd_plain(q, k, v),
                             iters=10),
                         "bwd": time_ms(
                             lambda: FA.flash_attention_bwd_plain(
                                 q, k, v, o, lse, do),
                             iters=10)}
                # SDPA on [B, H, N, D] views of the same tensors, timed
                # only, never called by the port: the forward; the backward
                # alone (one forward outside the timed calls, then
                # autograd.grad with the graph kept); forward + backward.
                qh, kh, vh, gh = (t.transpose(1, 2) for t in (q, k, v, do))
                qr, kr, vr = (t.detach().requires_grad_(True)
                              for t in (qh, kh, vh))
                out = F.scaled_dot_product_attention(qr, kr, vr)

                def sdpa_fwd_bwd():
                    y = F.scaled_dot_product_attention(qr, kr, vr)
                    return torch.autograd.grad(y, (qr, kr, vr), gh)

                sdpa = {"fwd": time_ms(
                            lambda: F.scaled_dot_product_attention(qh, kh,
                                                                   vh)),
                        "bwd": time_ms(lambda: torch.autograd.grad(
                            out, (qr, kr, vr), gh, retain_graph=True)),
                        "fwd_bwd": time_ms(sdpa_fwd_bwd)}
                row = {"shape": [b, ATTN_N, h, ATTN_D], "dtype": dname,
                       "max_abs_err": errs, "tf32_plain_max_abs_err": tf32_err,
                       "ms": ms, "plain_ms": plain, "sdpa_ms": sdpa,
                       "fwd_device_ms": fwd_device,
                       "fwd_over_sdpa_fwd": ms["flash_attention_fwd"]
                       / sdpa["fwd"],
                       "bound_ms": {}, "bound_by": {},
                       "fp32_core_bound_ms": {}, "fp32_core_bound_by": {},
                       "share_of_bound": {},
                       "bwd_sum_ms": ms["flash_attention_bwd_dq"]
                       + ms["flash_attention_bwd_dkv"]}
                row["bwd_sum_over_sdpa_bwd"] = row["bwd_sum_ms"] / sdpa["bwd"]
                if dtype == torch.bfloat16:
                    # The earlier bf16 forward (flash_attention.cu's
                    # mma.sync build, PR 7), held and timed beside.
                    eo, el = earlier_bf16_fwd(q, k, v)
                    torch.cuda.synchronize()
                    row["earlier_fwd"] = {
                        "max_abs_err": max_err((eo.float(), el),
                                               (o.float(), lse)),
                        "ms": time_ms(lambda: earlier_bf16_fwd(q, k, v)),
                        "device_ms": device_ms(
                            lambda: earlier_bf16_fwd(q, k, v))}
                    if row["earlier_fwd"]["max_abs_err"] > BF16_TOL:
                        fail("attn", f"{label}: the earlier bf16 forward "
                                     f"is {row['earlier_fwd']} off")
                    del eo, el
                for name, (ops, nbytes) in attn_work(
                        b, h=h, itemsize=dtype.itemsize).items():
                    core = bound(ops, nbytes, peak_flops, hbm)
                    # The bound at the rate of the products each kernel
                    # issues: 3xTF32 (float32) or bf16 tensor-core MMAs.
                    # The float32 CUDA-core bound is kept beside it.
                    bms, by = bound(ops, nbytes, tc_peak[dtype], hbm)
                    row["bound_ms"][name], row["bound_by"][name] = bms, by
                    (row["fp32_core_bound_ms"][name],
                     row["fp32_core_bound_by"][name]) = core
                    row["share_of_bound"][name] = bms / ms[name]
                rows.append(row)
                log("attn", json.dumps(row))
                if h == MOE_HEADS:
                    # ViT-S/16-MoE's shape, beside the ViT-B/16 row.
                    summary = main if dtype == torch.float32 else main_bf16
                    for name in K4:
                        summary[name][MOE_SHAPE_KEY] = {
                            "shape": row["shape"],
                            "max_abs_err": errs[name], "ms": ms[name],
                            "plain_ms": plain["fwd" if name == K4[0]
                                              else "bwd"],
                            "bound_ms": row["bound_ms"][name],
                            "bound_by": row["bound_by"][name],
                            "library_ms": sdpa["fwd"] if name == K4[0]
                            else None,
                            "sdpa_bwd_ms": sdpa["bwd"]}
                elif b == VIT_BATCH:
                    summary = main if dtype == torch.float32 else main_bf16
                    for name in K4:
                        fwd = name == "flash_attention_fwd"
                        summary[name] = {
                            "max_abs_err": errs[name], "ms": ms[name],
                            "plain_ms": plain["fwd" if fwd else "bwd"],
                            "bound_ms": row["bound_ms"][name],
                            "bound_by": row["bound_by"][name],
                            "fp32_core_bound_ms": row["fp32_core_bound_ms"][
                                name],
                            "library_ms": sdpa["fwd"] if fwd else None}
                        if fwd:
                            summary[name].update(
                                device_ms=fwd_device["kernel"],
                                library_device_ms=fwd_device["sdpa"],
                                over_library=row["fwd_over_sdpa_fwd"])
                            if tf32_err is not None:
                                summary[name]["tf32_plain_max_abs_err"] = \
                                    tf32_err[0]
                            if "earlier_fwd" in row:
                                summary[name]["earlier"] = row["earlier_fwd"]
                        else:
                            # No one PyTorch call computes dq alone or
                            # dk/dv alone: SDPA's backward (dq, dk and dv)
                            # stands beside the pair's sum.
                            summary[name].update(
                                sdpa_bwd_ms=sdpa["bwd"],
                                sdpa_fwd_bwd_ms=sdpa["fwd_bwd"],
                                bwd_sum_ms=row["bwd_sum_ms"],
                                bwd_sum_over_sdpa_bwd=row[
                                    "bwd_sum_over_sdpa_bwd"])
                del q, k, v, do, o, lse, delta, qh, kh, vh, gh, qr, kr, vr
                del out
                free()
        # The masks, in both builds of each dtype (bf16's forward is the
        # TMA and wgmma kernel; N = 300 refills its key ring).
        none = torch.zeros(1, dtype=torch.int32, device="cuda")
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            dname = str(dtype).replace("torch.", "")
            q, k, v, do = inputs(4, 64, dtype)
            check(f"{dname} valid_len 50 of 64", q, k, v, do, tol,
                  valid_len=50)
            check(f"{dname} valid 50 of 64 (device count)", q, k, v, do,
                  tol, valid=torch.tensor([50], dtype=torch.int32,
                                          device="cuda"))
            for sentinel in (0.0, FA.NEG_INF):
                # A row whose lse is the -1e30 sentinel has p = 1 at every
                # key in the backward, so dq and dk/dv are sums of 64 ds
                # of a few units each: in bf16, ds rounded to 8 bits (as
                # the reference rounds it) lies outside 1e-2 of the float32
                # plain version there.  bf16 holds the forward of that case
                # (the masked rows' o and lse); float32 holds all of it.
                _, (o, lse, _), _ = check(
                    f"{dname} fully masked, sentinel {sentinel}", q, k, v,
                    do, tol, sentinel=sentinel, valid=none,
                    backward=dtype == torch.float32 or sentinel == 0.0)
                if not (bool((o == 0).all())
                        and bool((lse == sentinel).all())):
                    fail("attn", f"fully masked rows: o max "
                                 f"{o.abs().max()}, lse "
                                 f"{lse.unique().tolist()[:4]}, expected 0 "
                                 f"and {sentinel}")
            q, k, v, do = inputs(2, 300, dtype)
            check(f"{dname} [2, 300, 12, 64], valid_len 233", q, k, v, do,
                  tol, valid_len=233)
    return main, main_bf16, rows


def phase_vit(gen: torch.Generator, seed: int):
    """ViT-B/16 through K4 against the same weights under dense attention;
    returns the flash model for serving."""
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.kernels import no_tf32
    from tpuic_torch.models import create_model
    model = init_synthetic(create_model(VIT_MODEL, 1000, dtype="float32",
                                        attention="flash",
                                        image_size=IMAGE), seed=seed)
    dense = create_model(VIT_MODEL, 1000, dtype="float32",
                         attention="dense", image_size=IMAGE)
    dense.load_state_dict(model.state_dict())
    model.eval()
    dense.eval()
    x = torch.randn((4, IMAGE, IMAGE, 3), generator=gen).cuda()
    with torch.inference_mode():
        model(x)
        with no_tf32():
            reset_counts()
            flash = model(x)
            counts = read_counts()
            ref = dense(x)
        flash_ms = time_ms(lambda: model(x), iters=10)
        dense_ms = time_ms(lambda: dense(x), iters=10)
    if counts != expect(flash_attention_fwd=VIT_LAYERS):
        fail("vit", f"launches per forward {counts}, expected "
                    f"{VIT_LAYERS} flash_attention_fwd")
    if not (torch.isfinite(flash).all() and flash.shape == (4, 1000)):
        fail("vit", f"logits {tuple(flash.shape)} not finite")
    err = float((flash - ref).abs().max())
    if not torch.allclose(flash, ref, rtol=MODEL_TOL, atol=MODEL_TOL):
        fail("vit", f"flash vs dense logits: max abs err {err} beyond "
                    f"atol/rtol {MODEL_TOL}")
    log("vit", json.dumps({
        "model": VIT_MODEL, "classes": 1000, "image": IMAGE, "batch": 4,
        "dtype": "float32", "params": sum(p.numel()
                                          for p in model.parameters()),
        "launches_per_forward": counts["flash_attention_fwd"],
        "max_abs_err_vs_dense": err,
        "logit_abs_max": float(ref.abs().max()),
        "top1_agree": bool((flash.argmax(-1) == ref.argmax(-1)).all()),
        "flash_forward_ms": flash_ms, "dense_forward_ms": dense_ms}))
    del dense
    free()
    return model


def vit_train_config(root: str, seed: int, dtype: str = "float32",
                     recipe: bool = False):
    """The repo's ViT-B/16 recipe (recipes/README.md, section 4) on one
    card, in ``dtype`` (bfloat16: ``compute_dtype`` bf16, as the
    reference trains), through the flash kernels and the fused loss;
    with ``recipe`` its regularisers too (mixup 0.2, CutMix 1.0, random
    erasing 0.25, drop-path 0.1, EMA 0.9999), else without them (the
    plain-recipe arm)."""
    from tpuic_torch.config import (Config, DataConfig, ModelConfig,
                                    OptimConfig, RunConfig)
    extra = VIT_RECIPE if recipe else {}
    return Config(
        data=DataConfig(data_dir=root, resize_size=IMAGE,
                        batch_size=VIT_BATCH, num_workers=8,
                        shuffle_seed=seed),
        model=ModelConfig(name=VIT_MODEL, num_classes=1000, dtype=dtype,
                          compute_dtype="bf16" if dtype == "bfloat16"
                          else "", attention="flash",
                          drop_path=0.1 if recipe else 0.0),
        optim=OptimConfig(optimizer="adam", learning_rate=VIT_LR,
                          weight_decay=0.05, warmup_epochs=10,
                          milestones=(), label_smoothing=0.1,
                          grad_clip_norm=1.0, class_weights=(),
                          fused_loss=True, **extra),
        run=RunConfig(epochs=300, max_steps=TRAIN_STEPS, log_every_steps=4,
                      seed=seed, ckpt_dir=os.path.join(root, "ckpt")))


def _logged_losses(lines: list) -> dict:
    """``{step: loss}`` from a ``Trainer``'s log lines."""
    import re
    out = {}
    for line in lines:
        m = re.search(r"step (\d+); Loss ([-\d.e+]+)\|", line)
        if m:
            out[int(m.group(1))] = float(m.group(2))
    return out


def phase_vit_train(root: str, seed: int, smi: str):
    """ViT-B/16 training through ``Trainer``, in float32 and in bf16 (K4's
    bf16 kernels forward and backward, every attention block's input and
    output bfloat16), launches counted per arm; the bf16 arm's logged
    losses within BF16_LOSS_RTOL of the float32 arm's at the same steps
    (one init, one data order); then the 3-step comparison of the kernels
    with dense attention and the plain loss, and a bf16 arm through the
    kernels held to BF16_LOSS_RTOL of the float32 kernels'."""
    from tpuic_torch.train.loop import Trainer
    counts, rows, losses = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = vit_train_config(root, seed, dtype)
        lines = []

        def note(msg, lines=lines):
            lines.append(msg)
            log("vit-train", msg)

        trainer = Trainer(cfg, log=note)
        reset_counts()
        probe = (attn_dtypes() if dtype == "bfloat16"
                 else contextlib.nullcontext())
        with probe as seen:
            trainer.fit()
        stats = dict(trainer.stats)
        trainer.val_epoch(0)
        counts[dtype] = read_counts()
        losses[dtype] = _logged_losses(lines)
        steps = stats["steps"]
        val_forwards = len(trainer.val_loader)
        want = expect(flash_attention_fwd=VIT_LAYERS * (steps
                                                        + val_forwards),
                      flash_attention_bwd_dq=VIT_LAYERS * steps,
                      flash_attention_bwd_dkv=VIT_LAYERS * steps,
                      cross_entropy_fwd=steps, cross_entropy_bwd=steps)
        if steps != TRAIN_STEPS or counts[dtype] != want:
            fail("vit-train", f"{dtype}: {steps} steps, launches "
                              f"{counts[dtype]}, expected {TRAIN_STEPS} "
                              f"steps and {want}")
        if not all(bool(torch.isfinite(p).all())
                   for p in trainer.model.parameters()) or not all(
                math.isfinite(v) for v in trainer.last_val.values()):
            fail("vit-train", f"{dtype}: non-finite state after {steps} "
                              f"steps: val {trainer.last_val}")
        rows[dtype] = train_row(trainer, stats, counts[dtype], VIT_BATCH,
                                smi)
        if dtype == "bfloat16":
            rows[dtype]["attn_dtypes"] = check_conv_dtypes(
                "vit-train", "bf16 arm's attention blocks", seen,
                "bfloat16")
            if not all(p.dtype == torch.float32
                       for p in trainer.model.parameters()):
                fail("vit-train", "bf16: master weights are not float32")
        log("vit-train", json.dumps(rows[dtype]))
        if dtype == "float32":
            batches = first_batches(trainer)
        del trainer
        free()
    rows["bfloat16"]["decode_path"] = decode_arm(
        "vit-train", vit_train_config(root, seed, "bfloat16"), VIT_BATCH, smi)
    logged = sorted(set(losses["float32"]) & set(losses["bfloat16"]))
    rel = {s_: abs(losses["bfloat16"][s_] - losses["float32"][s_])
           / abs(losses["float32"][s_]) for s_ in logged}
    log("vit-train", "bf16 vs float32 Trainer losses: " + json.dumps(
        {"steps": logged, "float32": losses["float32"],
         "bfloat16": losses["bfloat16"], "rel_diff": rel,
         "rtol": BF16_LOSS_RTOL}))
    if not rel or max(rel.values()) > BF16_LOSS_RTOL:
        fail("vit-train", f"bf16 and float32 Trainer losses differ by "
                          f"{rel} (rtol {BF16_LOSS_RTOL})")
    cfg = vit_train_config(root, seed)
    arms = compare_plain(
        cfg, batches, seed, VIT_COMPARE_LR,
        plain_model=dataclasses.replace(cfg.model, attention="dense"),
        bf16_model=vit_train_config(root, seed, "bfloat16").model,
        probe=attn_dtypes)
    bf16_rel = [abs(b["loss"] - k["loss"]) / abs(k["loss"])
                for b, k in zip(arms["bf16"]["metrics"],
                                arms["kernels"]["metrics"])]
    bf16_attn = check_conv_dtypes("vit-train", "3-step bf16 arm's attention",
                                  arms["bf16"].pop("conv_dtypes"),
                                  "bfloat16")
    row = check_compare("vit-train", arms)
    row["bf16_loss_rel_diff"] = bf16_rel
    row["bf16_attn_dtype"] = bf16_attn
    log("vit-train", "3-step bf16 vs float32 through the kernels: "
                     + json.dumps({"loss_rel_diff": bf16_rel,
                                   "rtol": BF16_LOSS_RTOL}))
    if max(bf16_rel) > BF16_LOSS_RTOL:
        fail("vit-train", f"3-step bf16 and float32 losses differ by "
                          f"{max(bf16_rel)} > {BF16_LOSS_RTOL}")
    del batches
    free()
    return counts, {**rows, "trainer_loss_rel_diff": rel, "compare": row}


def remat_check(cfg, batches, seed: int) -> dict:
    """Two steps of ``cfg``'s recipe from one state with and without
    ``--remat --remat-policy dots`` (float32, TF32 off, the same draws):
    each step's loss and gradient norm within REMAT_RTOL; launches of
    each arm (under remat K4f's forward runs again in the backward, as
    the Pallas call does under ``jax.checkpoint``), the second step's ms
    (the first sets up the selective checkpoint's dispatch mode) and peak
    memory."""
    from tpuic_torch.checkpoint import init_params
    from tpuic_torch.kernels import no_tf32
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.train.optimizer import make_optimizer, make_schedule
    from tpuic_torch.train.state import create_train_state
    from tpuic_torch.train.step import make_train_step
    arms = {}
    for arm, on in (("no_remat", False), ("remat_dots", True)):
        mcfg = dataclasses.replace(cfg.model, remat=on, remat_policy="dots")
        ocfg = dataclasses.replace(cfg.optim, learning_rate=VIT_COMPARE_LR,
                                   warmup_epochs=0, milestones=())
        model = init_params(create_model_from_config(
            mcfg, image_size=cfg.data.resize_size), seed, device="cuda")
        state = create_train_state(model, make_optimizer(ocfg),
                                   ema=ocfg.ema_decay > 0)
        step = make_train_step(ocfg, mcfg, lr_schedule=make_schedule(
            ocfg, 1, 1), device="cuda", seed=cfg.run.seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        metrics = []
        with no_tf32(), deterministic_cudnn():
            for batch in batches[:2]:
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                metrics.append({k: float(m[k]) for k in ("loss",
                                                         "grad_norm")})
        arms[arm] = {"metrics": metrics, "step_ms": ms,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "launches": read_counts()}
        del model, state, step
        free()
    p, r = arms["no_remat"], arms["remat_dots"]
    rel = max(abs(b[k] - a[k]) / abs(a[k])
              for a, b in zip(p["metrics"], r["metrics"])
              for k in ("loss", "grad_norm"))
    row = {**arms, "max_rel_diff": rel, "rtol": REMAT_RTOL}
    want = dict(p["launches"], flash_attention_fwd=4 * VIT_LAYERS)
    if rel > REMAT_RTOL or r["launches"] != want or \
            p["launches"]["flash_attention_fwd"] != 2 * VIT_LAYERS:
        fail("vit-train", f"remat dots: {json.dumps(row)}; expected the "
                          f"launches {want}")
    return row


def step_breakdown(cfgs: dict, batches, seed: int) -> dict:
    """Each config of ``cfgs`` ({arm: Config}) stepped on the same cached
    batches (no loader) in turns, A B B A: per arm the host clock over
    BREAKDOWN_STEPS steps after two warm-up steps (ms a step, the median
    of its two turns), then a ``torch.profiler`` trace of 3 steps: the
    card's busy ms a step (the sum of the kernels' device time), the
    idle share ``1 - busy / step``, the kernels taking the most device
    time, and the kernels launched a step."""
    from torch.autograd import DeviceType
    from tpuic_torch.checkpoint import init_params
    from tpuic_torch.telemetry import tracing
    from tpuic_torch.telemetry.profile import LAYER_SCOPE
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.train.optimizer import make_optimizer, make_schedule
    from tpuic_torch.train.state import create_train_state
    from tpuic_torch.train.step import make_train_step
    names = list(cfgs)
    out = {a: {"step_ms": []} for a in names}
    for arm in names + names[::-1]:
        cfg = cfgs[arm]
        model = init_params(create_model_from_config(
            cfg.model, image_size=cfg.data.resize_size), seed, device="cuda")
        state = create_train_state(model, make_optimizer(cfg.optim),
                                   ema=cfg.optim.ema_decay > 0)
        step = make_train_step(cfg.optim, cfg.model, lr_schedule=make_schedule(
            cfg.optim, 1, 1), device="cuda", seed=cfg.run.seed)
        for b in batches[:2]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(BREAKDOWN_STEPS):
            state, _ = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / BREAKDOWN_STEPS * 1e3
        out[arm]["step_ms"].append(ms)
        if "busy_ms" not in out[arm]:
            # The port's profiler session: CUPTI torn down at its stop,
            # so the turns and phases after it pay no launch tax.
            prof = tracing.start_profiler()
            for b in batches[:3]:
                state, _ = step(state, b)
            torch.cuda.synchronize()
            prof.stop()
            # The kernels themselves (an operator's row repeats the
            # device time of the kernels it launched; a record_function
            # scope's row on the card spans the kernels inside it).
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and not LAYER_SCOPE.match(e.key)]
            busy = sum(e.self_device_time_total for e in events) / 3e3
            top = sorted(events, key=lambda e: -e.self_device_time_total)
            out[arm].update(
                busy_ms=busy or None,
                kernels_a_step=sum(e.count for e in events) // 3,
                top=[[e.key[:48], e.self_device_time_total / 3e3,
                      e.count // 3] for e in top[:BREAKDOWN_TOP]
                     if e.self_device_time_total])
        del model, state, step
        free()
    for arm in names:
        o = out[arm]
        o["median_step_ms"] = statistics.median(o["step_ms"])
        o["idle_share"] = (1.0 - o["busy_ms"] / o["median_step_ms"]
                           if o["busy_ms"] else None)
    return out


def phase_vit_recipe(root: str, seed: int, smi: str, plain: dict):
    """ViT-B/16 with recipes/README.md section 4's regularisers (mixup
    0.2, CutMix 1.0, random erasing 0.25, drop-path 0.1, EMA 0.9999) in
    bf16 through ``Trainer`` for 12 steps, then a val pass on the EMA
    weights: launches (K4 as the plain recipe's, K1 twice a step: the
    mixed loss's two terms), step ms beside the plain-recipe bf16 arm's
    (``plain``) on this card and ``step_breakdown`` of the two on cached
    batches; then 3 steps through the kernels against 3 through dense
    attention and the plain loss with the same draws (float32, TF32 off,
    loss rtol 1e-3), and ``remat_check``."""
    from tpuic_torch.train.loop import Trainer
    cfg = vit_train_config(root, seed, "bfloat16", recipe=True)
    trainer = Trainer(cfg, log=lambda msg: log("vit-train", "recipe: "
                                               + msg))
    reset_counts()
    trainer.fit()
    stats = dict(trainer.stats)
    trainer.val_epoch(0)
    counts = read_counts()
    steps = stats["steps"]
    val_forwards = len(trainer.val_loader)
    want = expect(flash_attention_fwd=VIT_LAYERS * (steps + val_forwards),
                  flash_attention_bwd_dq=VIT_LAYERS * steps,
                  flash_attention_bwd_dkv=VIT_LAYERS * steps,
                  cross_entropy_fwd=2 * steps, cross_entropy_bwd=2 * steps)
    st = trainer.state
    if steps != TRAIN_STEPS or counts != want:
        fail("vit-train", f"recipe: {steps} steps, launches {counts}, "
                          f"expected {TRAIN_STEPS} steps and {want}")
    if st.ema_params is None or not all(
            bool(torch.isfinite(t).all())
            for t in list(trainer.model.parameters()) + st.ema_params) \
            or not all(math.isfinite(v) for v in trainer.last_val.values()):
        fail("vit-train", f"recipe: no EMA or a non-finite state after "
                          f"{steps} steps: val {trainer.last_val}")
    row = train_row(trainer, stats, counts, VIT_BATCH, smi)
    row.update(recipe=dict(VIT_RECIPE, drop_path=0.1),
               drop_path_sites=len(trainer.model.drop_path_rates()),
               plain_recipe_step_ms=plain["step_ms"],
               over_plain_recipe=row["step_ms"] / plain["step_ms"])
    log("vit-train", "recipe: " + json.dumps(row))
    batches = first_batches(trainer)
    del trainer, st
    free()
    row["breakdown"] = step_breakdown(
        {"plain_recipe": vit_train_config(root, seed, "bfloat16"),
         "recipe": cfg}, batches, seed)
    log("vit-train", "recipe breakdown (cached batches, A B B A): "
                     + json.dumps(row["breakdown"]))
    fcfg = vit_train_config(root, seed, "float32", recipe=True)
    row["compare"] = check_compare("vit-train", compare_plain(
        fcfg, batches, seed, VIT_COMPARE_LR,
        plain_model=dataclasses.replace(fcfg.model, attention="dense")))
    row["remat"] = remat_check(fcfg, batches, seed)
    log("vit-train", "recipe remat dots: " + json.dumps(row["remat"]))
    del batches
    free()
    return counts, row


def eff_train_config(root: str, seed: int, dtype: str = "bfloat16"):
    """recipes/README.md section 3 on one card: EfficientNet-B0 at 224 px,
    SGD 0.4 with 5 warmup epochs of 90, no class weights, bf16
    (``compute_dtype``), batch 128, the fused loss; stochastic depth 0.2
    (``tpuic``'s, always on)."""
    from tpuic_torch.config import (Config, DataConfig, ModelConfig,
                                    OptimConfig, RunConfig)
    return Config(
        data=DataConfig(data_dir=root, resize_size=IMAGE,
                        batch_size=TRAIN_BATCH, num_workers=8,
                        shuffle_seed=seed),
        model=ModelConfig(name=EFF_TRAIN_MODEL, num_classes=1000,
                          dtype=dtype, compute_dtype="bf16"
                          if dtype == "bfloat16" else ""),
        optim=OptimConfig(optimizer="sgd", learning_rate=EFF_TRAIN_LR,
                          warmup_epochs=5, milestones=(), class_weights=(),
                          fused_loss=True),
        run=RunConfig(epochs=90, max_steps=TRAIN_STEPS, log_every_steps=4,
                      seed=seed, ckpt_dir=os.path.join(root, "ckpt")))


def phase_effnet_train(root: str, seed: int, smi: str):
    """EfficientNet-B0 training with stochastic depth 0.2 through
    ``Trainer`` (``eff_train_config``) for 12 steps and a val pass: step
    ms, data-wait share, K1 once forward and once backward a step and no
    other kernel (the model has none, as in ``tpuic``), EFF_SITES draw
    sites, every convolution of the first step bfloat16; then 3 steps
    through K1 against 3 through the plain loss with the same
    stochastic-depth draws (float32, TF32 off, loss rtol 1e-3)."""
    from tpuic_torch.train.loop import Trainer
    cfg = eff_train_config(root, seed)
    trainer = Trainer(cfg, log=lambda msg: log("effnet-train", msg))
    reset_counts()
    with conv_dtypes() as seen:
        trainer.fit()
    stats = dict(trainer.stats)
    trainer.val_epoch(0)
    counts = read_counts()
    steps = stats["steps"]
    want = expect(cross_entropy_fwd=steps, cross_entropy_bwd=steps)
    sites = len(trainer.model.drop_path_rates())
    if steps != TRAIN_STEPS or counts != want or sites != EFF_SITES:
        fail("effnet-train", f"{steps} steps, launches {counts}, {sites} "
                             f"drop-path sites; expected {TRAIN_STEPS}, "
                             f"{want}, {EFF_SITES}")
    if not all(bool(torch.isfinite(p).all())
               for p in trainer.model.parameters()) or not all(
            math.isfinite(v) for v in trainer.last_val.values()):
        fail("effnet-train", f"non-finite state after {steps} steps: val "
                             f"{trainer.last_val}")
    row = train_row(trainer, stats, counts, TRAIN_BATCH, smi)
    row["conv_out_dtype"] = check_conv_dtypes("effnet-train", "bf16", seen,
                                              "bfloat16")
    row["drop_path_sites"] = sites
    log("effnet-train", json.dumps(row))
    batches = first_batches(trainer)
    del trainer
    free()
    row["compare"] = check_compare("effnet-train", compare_plain(
        eff_train_config(root, seed, "float32"), batches, seed,
        EFF_COMPARE_LR))
    del batches
    free()
    return counts, row


def rows_check(model, tag: str, image: int) -> dict:
    """Rows served through the engine's ``make_forward`` (TF32 off for the
    call): one image's probabilities from a batch-1 forward against its row
    of a batch-32 forward, within SERVE_TOL."""
    from tpuic_torch.serve import make_forward
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(
        0, 256, (SERVE_BATCH, image, image, 3), dtype=np.uint8)).cuda()
    served = make_forward(model, normalize=True)
    big, _ = served(images)
    rows = (0, 17, 31)
    diff = max(float((served(images[r:r + 1])[0][0] - big[r]).abs().max())
               for r in rows)
    if not bool(torch.isfinite(big).all()):
        fail(tag, "non-finite probabilities")
    if diff > SERVE_TOL:
        fail(tag, f"a row's probabilities at batch 1 and in batch "
                  f"{SERVE_BATCH} differ by {diff} > {SERVE_TOL}")
    return {"rows": list(rows), "probs_max_abs_diff": diff,
            "batch32_forward_ms": time_ms(lambda: served(images), iters=5)}


def phase_cnn_serve(name: str, image: int, tag: str, n_requests: int,
                    seed: int, smi: str) -> dict:
    """``name`` at full width, 1000 classes, seeded synthetic weights, in
    eval mode: batch-1 rows against batch-32 rows, then ``phase_serve``'s
    engine, clients and graph checks.  No kernel lies on this forward (as
    in ``tpuic``, K3 is ResNet-only): every launch count must stay 0."""
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.models import create_model
    model = init_synthetic(create_model(name, 1000, dtype="float32"),
                           seed=0).eval()
    params = sum(p.numel() for p in model.parameters())
    bucket = rows_check(model, tag, image)
    log(tag, json.dumps({"model": name, "image": image, "classes": 1000,
                         "params": params, "dtype": "float32",
                         "batch1_vs_batch32": bucket}))
    _, snap = phase_serve(model, n_requests, seed, smi, tag=tag,
                          counter=None, image=image)
    del model
    free()
    return {"model": name, "image": image, "params": params,
            "batch1_vs_batch32": bucket, "serve": snap}


def write_ref_folder(root: str, seed: int, per_train: int,
                     per_val: int) -> None:
    """A synthetic ImageFolder of the reference's 7 classes at 299 px."""
    from tpuic_torch.data.synthetic import make_synthetic_imagefolder
    classes = tuple(f"class{i}" for i in range(len(REF_WEIGHTS)))
    make_synthetic_imagefolder(root, classes, per_class=per_train,
                               size=INC_IMAGE, folds=("train",), seed=seed)
    make_synthetic_imagefolder(root, classes, per_class=per_val,
                               size=INC_IMAGE, folds=("val",), seed=seed + 1)


def write_inception_folder(root: str, seed: int) -> None:
    """``inception-train``'s folder: the reference's 7 classes at 299 px,
    TRAIN_STEPS batches of INC_BATCH and a spare a class."""
    t0 = time.perf_counter()
    write_ref_folder(root, seed, per_train=INC_BATCH * TRAIN_STEPS
                     // len(REF_WEIGHTS) + 1, per_val=4)
    log("inception-train", f"synthetic ImageFolder {INC_IMAGE}x{INC_IMAGE}, "
                           f"{len(REF_WEIGHTS)} classes, in "
                           f"{time.perf_counter() - t0:.3f} s")


def inception_train_config(root: str, seed: int, dtype: str):
    """The reference program's recipe (train.py: InceptionV3 with its aux
    head at 299 px, Adam lr 0.5e-5, MultiStepLR [50, 80], the 7 class
    weights) at batch 32, with the fused loss K1."""
    from tpuic_torch.config import (Config, DataConfig, ModelConfig,
                                    OptimConfig, RunConfig)
    return Config(
        data=DataConfig(data_dir=root, resize_size=INC_IMAGE,
                        batch_size=INC_BATCH, num_workers=8,
                        shuffle_seed=seed),
        model=ModelConfig(name="inceptionv3", dtype=dtype,
                          compute_dtype="bf16" if dtype == "bfloat16"
                          else ""),
        optim=OptimConfig(optimizer="adam", class_weights=REF_WEIGHTS,
                          fused_loss=True),
        run=RunConfig(epochs=100, max_steps=TRAIN_STEPS, log_every_steps=4,
                      seed=seed, ckpt_dir=os.path.join(root, "ckpt"),
                      resume=False))


def phase_inception_train(root: str, seed: int, smi: str):
    """InceptionV3 training, the reference's own model and recipe, through
    ``Trainer``: 12 steps in float32 and 12 in bf16, each counting two K1
    forward and two K1 backward launches a step (main and aux logits);
    then 3 steps from one state through the kernels, through the plain
    loss (float32, TF32 off: loss rtol 1e-3) and through the kernels in
    bf16 (loss within BF16_LOSS_RTOL of the float32 kernels')."""
    from tpuic_torch.train.loop import Trainer
    rows, counts = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = inception_train_config(root, seed, dtype)
        trainer = Trainer(cfg, log=lambda msg: log("inception-train", msg))
        reset_counts()
        with conv_dtypes() as seen:
            trainer.fit()
        stats = dict(trainer.stats)
        counts[dtype] = read_counts()
        conv_out = check_conv_dtypes("inception-train", dtype, seen, dtype)
        steps = stats["steps"]
        want = expect(cross_entropy_fwd=2 * steps,
                      cross_entropy_bwd=2 * steps)
        if steps != TRAIN_STEPS or counts[dtype] != want:
            fail("inception-train", f"{dtype}: {steps} steps, launches "
                                    f"{counts[dtype]}, expected "
                                    f"{TRAIN_STEPS} steps and {want}")
        if not all(bool(torch.isfinite(p).all())
                   for p in trainer.model.parameters()):
            fail("inception-train", f"{dtype}: non-finite parameters")
        if not all(p.dtype == torch.float32
                   for p in trainer.model.parameters()) or not all(
                t.dtype == torch.float32 for t in trainer.state.opt_state.mu):
            fail("inception-train", f"{dtype}: master weights or Adam "
                                    "moments are not float32")
        trainer.val_epoch(0)  # one val forward: no kernel on it
        rows[dtype] = train_row(trainer, stats, counts[dtype], INC_BATCH,
                                smi)
        rows[dtype]["conv_out_dtype"] = conv_out
        log("inception-train", json.dumps(rows[dtype]))
        if dtype == "float32":
            rows[dtype]["decode_path"] = decode_arm(
                "inception-train", cfg, INC_BATCH, smi)
        if dtype == "float32":
            batches = first_batches(trainer)
        del trainer
        free()
    cfg = inception_train_config(root, seed, "float32")
    arms = compare_plain(cfg, batches, seed, cfg.optim.learning_rate,
                         bf16_model=inception_train_config(
                             root, seed, "bfloat16").model)
    bf16_rel = [abs(b["loss"] - k["loss"]) / abs(k["loss"])
                for b, k in zip(arms["bf16"]["metrics"],
                                arms["kernels"]["metrics"])]
    bf16_conv = check_conv_dtypes("inception-train", "3-step bf16 arm",
                                  arms["bf16"].pop("conv_dtypes"),
                                  "bfloat16")
    row = check_compare("inception-train", arms)
    row["bf16_loss_rel_diff"] = bf16_rel
    row["bf16_conv_out_dtype"] = bf16_conv
    log("inception-train", "bf16 vs float32 through the kernels: "
                           + json.dumps({"loss_rel_diff": bf16_rel,
                                         "rtol": BF16_LOSS_RTOL}))
    if max(bf16_rel) > BF16_LOSS_RTOL:
        fail("inception-train", f"bf16 and float32 losses differ by "
                                f"{max(bf16_rel)} > {BF16_LOSS_RTOL}")
    del batches
    free()
    return counts, {**rows, "compare": row}


def _train_cli(argv: list):
    """``python -m tpuic_torch.train``'s ``main`` in this process (so its
    kernel launches count), its printed lines kept."""
    import io

    from tpuic_torch.train import __main__ as train_cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(argv)
    return rc, buf.getvalue().splitlines(), time.perf_counter() - t0


def _rows(path: str) -> dict:
    import csv
    with open(path) as f:
        return {r["image_id"]: r["pred"] for r in csv.DictReader(f)}


def _predict(root: str, ckpt_dir: str, batch: int, tag: str,
             out: str) -> dict:
    """``python -m tpuic_torch.predict``'s ``main`` on the val fold of the
    single trained model under ``ckpt_dir`` (``--model auto``), its rows
    written to ``out``."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = importlib.import_module("tpuic_torch.predict").main(
            ["--datadir", root, "--ckpt-dir", ckpt_dir, "--fold", "val",
             "--batchsize", str(batch), "--out", out])
    printed = buf.getvalue().strip().splitlines()
    for line in printed[:-1]:
        log(tag, line)
    if rc != 0:
        fail(tag, f"predict exited {rc}")
    return json.loads(printed[-1])


def _trainer_forward(root: str, ckpt_dir: str, batch: int,
                     out: str) -> dict:
    """The val fold scored by the ``Trainer``'s own eval forward: the run's
    model config from its ``config.json`` (its dtype, no fused kernel),
    through ``run_predict``, its rows written to ``out``."""
    from tpuic_torch.config import Config, DataConfig, ModelConfig, RunConfig
    from tpuic_torch.predict import resolve_model_auto, run_predict
    name = resolve_model_auto(ckpt_dir)["name"]
    with open(os.path.join(ckpt_dir, name, "config.json")) as f:
        saved = json.load(f)
    model = dict(saved["model"], head_widths=tuple(
        saved["model"]["head_widths"]))
    cfg = Config(data=DataConfig(data_dir=root,
                                 resize_size=saved["data"]["resize_size"],
                                 batch_size=batch, val_batch_size=batch),
                 model=ModelConfig(**model),
                 run=RunConfig(ckpt_dir=ckpt_dir))
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return run_predict(cfg, fold="val", track="best", top_k=1,
                           out_path=out)


def against_trainer(tag: str, arm: str, root: str, ckpt_dir: str,
                    batch: int, best: float, limit: int,
                    kernel: str = "") -> dict:
    """Predict's CLI on ``best`` (float32 through the kernels, as the serve
    CLI serves every checkpoint) against the ``Trainer``'s own forward,
    which must score ``best`` exactly: the two may disagree on at most
    ``limit`` val images, and their accuracies lie at most ``limit``
    images apart.  ``kernel``: the one counter predict's forward launches
    (``conv_bn_relu`` for the ResNet family, ``flash_attention_fwd`` for
    a ViT), else none."""
    cli_out = os.path.join(root, f"predict_{tag}_{arm}.csv")
    own_out = os.path.join(root, f"trainer_forward_{tag}_{arm}.csv")
    reset_counts()
    summary = _predict(root, ckpt_dir, batch, tag, cli_out)
    launched = read_counts()
    want = expect(**{kernel: launched[kernel]}) if kernel else expect()
    if launched != want or (kernel and not launched[kernel]):
        fail(tag, f"{arm}: predict launched {launched}")
    own = _trainer_forward(root, ckpt_dir, batch, own_out)
    if round(own.get("accuracy", -1.0), 4) != best:
        fail(tag, f"{arm}: the Trainer's forward scores "
                  f"{own.get('accuracy')} on best, the Trainer {best}")
    got, ref = _rows(cli_out), _rows(own_out)
    if set(got) != set(ref):
        fail(tag, f"{arm}: predict wrote {len(got)} rows, the Trainer's "
                  f"forward {len(ref)}")
    n = len(got)
    disagree = sum(got[k] != ref[k] for k in got)
    gap = abs(round(summary["accuracy"] * n / 100) - round(best * n / 100))
    row = {"predict_accuracy": summary["accuracy"], "predict_rows": n,
           "trainer_forward_accuracy": own["accuracy"],
           "disagree_images": disagree, "accuracy_gap_images": gap,
           "limit_images": limit, "predict_launches": launched}
    if disagree > limit or gap > limit:
        fail(tag, f"{arm}: predict (float32) and the Trainer's forward "
                  f"disagree on {disagree} of {n} images, accuracies "
                  f"{gap} images apart; the limit is {limit}")
    return row


def phase_ref_cli(root: str, seed: int, smi: str) -> dict:
    """The reference program's own command on the port, with nothing
    added but its data, one epoch and a checkpoint directory:
    ``python -m tpuic_torch.train --datadir D --epochs 1 --ckpt-dir C``
    (InceptionV3 with its aux head, 299 px,
    bfloat16, Adam, batch 4, the 7 class weights), as a user starts it.
    It must exit 0 and write ``best`` and ``latest``; predict scores
    ``best`` in float32, as served, within REF_PREDICT_LIMIT images of the
    ``Trainer``'s bf16 forward (``against_trainer``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(root, "ref")
    write_ref_folder(data, seed, per_train=8, per_val=4)
    ckpt = os.path.join(root, "ref_ckpt")
    cmd = [sys.executable, "-m", "tpuic_torch.train", "--datadir", data,
           "--epochs", "1", "--ckpt-dir", ckpt]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=here), cwd=here)
    wall = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    for line in lines:
        if line.startswith(("[model]", "[tpuic_torch]", "[ckpt]", "[pack]",
                            "[data]")) or "Val Accuracy" in line:
            log("ref-cli", line)
    if out.returncode != 0:
        fail("ref-cli", f"exited {out.returncode}: {out.stderr[-3000:]}")
    model_dir = os.path.join(ckpt, "inceptionv3")
    missing = [t for t in ("best", "latest")
               if not os.path.isdir(os.path.join(model_dir, t))]
    if missing or not any("bfloat16 compute" in ln for ln in lines):
        fail("ref-cli", f"tracks missing {missing}, or not the bfloat16 "
                        f"defaults: {lines[:3]}")
    best = float(lines[-1].split("best val accuracy ")[1])
    scored = against_trainer("ref-cli", "bfloat16", data, ckpt, 4, best,
                             REF_PREDICT_LIMIT)
    row = {"command": " ".join(cmd[1:]), "wall_s": wall,
           "trainer_best": best, **scored, "card": smi}
    log("ref-cli", json.dumps(row))
    return row


DIGITS_ARGS = ["--model", "resnet18-cifar", "--resize", "32", "--batchsize",
               "128", "--optimizer", "sgd", "--lr", "0.05",
               "--warmup-epochs", "3", "--weight-decay", "5e-4",
               "--milestones", "--epochs", str(DIGITS_EPOCHS),
               "--no-augment", "--no-class-weights", "--fused-loss",
               "--log-every-steps", "11"]


def phase_digits(root: str, smi: str):
    """The port's first real-data run: sklearn's
    handwritten digits (``tpuic_torch.data.digits``, 1,438 train and 359
    val images) through the train CLI with the recipe of
    ``perf/convergence_digits.json``, once in float32 and once in
    bfloat16.  Each arm's best val top-1 must reach DIGITS_BOUND (350 of
    359, stated before the first run), K1 must launch once forward and
    once backward a step, and every convolution of the arm's first step
    must return its dtype.  Predict scores each ``best`` in float32
    through K3, as served, within DIGITS_PREDICT_LIMIT images of the
    ``Trainer``'s forward (``against_trainer``); in the float32 arm its
    accuracy also equals the ``Trainer``'s."""
    from tpuic_torch.data.digits import write_digits_folder
    data = os.path.join(root, "digits")
    counts_written = write_digits_folder(data)
    out, counts = {}, {}
    for dtype in DIGITS_DTYPES:
        ckpt = os.path.join(root, f"digits_ckpt_{dtype}")
        reset_counts()
        with conv_dtypes() as seen, epoch_parts() as parts:
            rc, lines, wall = _train_cli(["--datadir", data, "--ckpt-dir",
                                          ckpt, "--dtype", dtype,
                                          *DIGITS_ARGS])
        counts[dtype] = read_counts()
        conv_out = check_conv_dtypes("digits", dtype, seen, dtype)
        for line in lines:
            if line.startswith(("[model]", "[tpuic_torch]", "[pack]",
                                "[data]")):
                log("digits", f"{dtype}: {line}")
        curve = [float(ln.split("Val Accuracy ")[1].split(";")[0])
                 for ln in lines if "Val Accuracy" in ln]
        steps = max((int(ln.split("; step ")[1].split(";")[0])
                     for ln in lines if ln.startswith("Epoch: ")
                     and "; step " in ln), default=0)
        best = max(curve) if curve else 0.0
        want = expect(cross_entropy_fwd=steps, cross_entropy_bwd=steps)
        if rc != 0 or len(curve) != DIGITS_EPOCHS or counts[dtype] != want:
            fail("digits", f"{dtype}: exit {rc}, {len(curve)} val passes, "
                           f"launches {counts[dtype]}, expected {want}")
        scored = against_trainer("digits", dtype, data, ckpt, 128, best,
                                 DIGITS_PREDICT_LIMIT,
                                 kernel="conv_bn_relu")
        row = {"dtype": dtype, "val_top1_per_epoch": curve, "best": best,
               "bound": DIGITS_BOUND, "steps": steps, "wall_s": wall,
               **epoch_row(parts),
               "launches": counts[dtype], "conv_out_dtype": conv_out,
               **scored, "card": smi}
        log("digits", json.dumps(row))
        if best < DIGITS_BOUND:
            fail("digits", f"{dtype}: best val top-1 {best} < "
                           f"{DIGITS_BOUND}")
        if dtype == "float32" and round(scored["predict_accuracy"],
                                        4) != best:
            fail("digits", f"float32: predict's accuracy "
                           f"{scored['predict_accuracy']} on best, the "
                           f"Trainer's {best}")
        out[dtype] = row
    out["images"] = counts_written
    return counts, out


DIGITS_VIT_ARGS = ["--model", "vit-tiny", "--attention", "flash",
                   "--resize", "32", "--batchsize", "128", "--optimizer",
                   "adam", "--lr", "1e-3", "--warmup-epochs", "3",
                   "--weight-decay", "5e-4", "--milestones", "--mixup",
                   "0.2", "--cutmix", "0.5", "--no-augment",
                   "--no-class-weights", "--fused-loss", "--dtype",
                   "float32", "--log-every-steps", "11"]


def _ema_model(ckpt_dir: str):
    """The ``best`` save under ``ckpt_dir`` as served (float32, flash),
    holding its ``ema_params``, straight from the payload."""
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.predict import resolve_model_auto, serving_model_config
    saved = resolve_model_auto(ckpt_dir)
    payload = torch.load(os.path.join(ckpt_dir, saved["name"], "best",
                                      "state.pt"), map_location="cuda",
                         weights_only=True)
    model = create_model_from_config(
        serving_model_config(saved["name"], saved["num_classes"]),
        image_size=saved["resize_size"])
    model.load_state_dict(payload["model"])
    ema = payload["ema_params"]
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(ema[name])
    return model.eval(), saved["resize_size"]


def _serve_cli_records(ckpt_dir: str, paths: list, out: str) -> list:
    """``python -m tpuic_torch.serve``'s ``main`` in this process over
    ``paths`` on stdin (``--model auto``), its records."""
    import io
    from tpuic_torch.serve import __main__ as serve_cli
    lines = "".join(json.dumps({"id": p, "path": p}) + "\n" for p in paths)
    stdin = sys.stdin
    sys.stdin = io.StringIO(lines)
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            rc = serve_cli.main(["--ckpt-dir", ckpt_dir, "--model", "auto",
                                 "--buckets", "1,8,16", "--out", out])
    finally:
        sys.stdin = stdin
    if rc != 0:
        fail("digits-vit", f"the serve CLI exited {rc}")
    with open(out) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def ema_served(data: str, ckpt_dir: str) -> dict:
    """Predict and the serve CLI on an EMA run's ``best`` both score its
    ``ema_params``: every row's probability within EMA_SERVE_TOL of a
    direct forward of them (predict: the val fold through the same
    loader; the serve CLI: DIGITS_VIT_SERVED val files, decoded as it
    decodes them)."""
    from tpuic_torch.config import DataConfig
    from tpuic_torch.data.folder import ImageFolderDataset
    from tpuic_torch.data.pipeline import Loader
    from tpuic_torch.serve import __main__ as serve_cli
    from tpuic_torch.serve import make_forward
    model, size = _ema_model(ckpt_dir)
    out = os.path.join(data, "predict_ema.csv")
    summary = _predict(data, ckpt_dir, 128, "digits-vit", out)
    ds = ImageFolderDataset(data, "val", size, DataConfig(
        resize_size=size, pack=False, native=False))
    loader = Loader(ds, 128, shuffle=False, augment=False, device="cuda")
    forward = make_forward(model)
    direct = []
    for batch in loader.epoch(0):
        probs, order = forward(batch["image"])
        for i in range(int(batch["mask"].sum())):
            j = int(order[i, 0])
            direct.append((batch.image_ids[i], j, float(probs[i, j])))
    import csv
    with open(out) as f:
        rows = list(csv.DictReader(f))
    names = {i: c for c, i in ds.class_to_idx.items()}
    predict_err = max(abs(float(r["prob"]) - p) for r, (_, _, p)
                      in zip(rows, direct))
    predict_same = sum(r["image_id"] == d and r["pred"] == names[j]
                       for r, (d, j, _) in zip(rows, direct))
    paths = [ds.samples[i][0] for i in range(DIGITS_VIT_SERVED)]
    recs = _serve_cli_records(ckpt_dir, paths,
                              os.path.join(data, "serve_ema.jsonl"))
    x = torch.from_numpy(np.stack([serve_cli._load_image(p, size)
                                   for p in paths])).cuda()
    probs, order = make_forward(model, normalize=True)(x)
    probs = probs.cpu().numpy()
    serve_err = max(abs(r["prob"] - float(probs[i, order[i, 0]]))
                    for i, r in enumerate(recs))
    row = {"predict_rows": len(rows), "predict_top1_equal": predict_same,
           "predict_max_abs_err": predict_err,
           "predict_accuracy": summary["accuracy"],
           "served": len(recs), "serve_max_abs_err": serve_err,
           "tol": EMA_SERVE_TOL}
    if (len(rows) != len(direct) or predict_same != len(rows)
            or len(recs) != len(paths) or max(predict_err, serve_err)
            > EMA_SERVE_TOL):
        fail("digits-vit", f"EMA serving: {json.dumps(row)}")
    return row


def phase_digits_vit(root: str, smi: str):
    """``tpuic``'s ViT digits run (``perf/convergence_digits.json``,
    ``tpuic_vit-tiny``) through the train CLI's ``main``: vit-tiny at 32
    px, batch 128, Adam with wd 5e-4, lr 1e-3 warmup-cosine over 3 of
    DIGITS_VIT_EPOCHS epochs, mixup 0.2, CutMix 0.5, no augmentation,
    float32, ``--attention flash`` (K4 trains it; ``tpuic``'s run used
    dense attention, the same function), on the digits split ``[digits]``
    wrote.  Its best val top-1 must reach DIGITS_VIT_BOUND (stated before
    the first run); launches: K1 twice a step (the mixed loss), K4's
    forward 2 a step and 2 a val forward (depth 2), its backward pair 2 a
    step.  Predict scores ``best`` (no EMA) within DIGITS_PREDICT_LIMIT
    images of the ``Trainer``'s forward.  Then DIGITS_VIT_EMA_EPOCHS
    epochs with ``--ema-decay 0.99``: predict and the serve CLI score its
    ``ema_params`` (``ema_served``)."""
    data = os.path.join(root, "digits")
    ckpt = os.path.join(root, "digits_vit_ckpt")
    reset_counts()
    with epoch_parts() as parts:
        rc, lines, wall = _train_cli(["--datadir", data, "--ckpt-dir", ckpt,
                                      "--epochs", str(DIGITS_VIT_EPOCHS),
                                      *DIGITS_VIT_ARGS])
    counts = read_counts()
    for line in lines:
        if line.startswith(("[model]", "[tpuic_torch]", "[pack]", "[data]")):
            log("digits-vit", line)
    curve = [float(ln.split("Val Accuracy ")[1].split(";")[0])
             for ln in lines if "Val Accuracy" in ln]
    steps = max((int(ln.split("; step ")[1].split(";")[0])
                 for ln in lines if ln.startswith("Epoch: ")
                 and "; step " in ln), default=0)
    best = max(curve) if curve else 0.0
    val_forwards = -(-359 // 128) * len(curve)
    want = expect(cross_entropy_fwd=2 * steps, cross_entropy_bwd=2 * steps,
                  flash_attention_fwd=2 * (steps + val_forwards),
                  flash_attention_bwd_dq=2 * steps,
                  flash_attention_bwd_dkv=2 * steps)
    if rc != 0 or len(curve) != DIGITS_VIT_EPOCHS or counts != want:
        fail("digits-vit", f"exit {rc}, {len(curve)} val passes, launches "
                           f"{counts}, expected {want}")
    scored = against_trainer("digits-vit", "float32", data, ckpt, 128, best,
                             DIGITS_PREDICT_LIMIT,
                             kernel="flash_attention_fwd")
    row = {"val_top1_per_epoch": curve, "best": best,
           "bound": DIGITS_VIT_BOUND, "tpuic_best": 100.0 * 317 / 359,
           "steps": steps, "wall_s": wall, **epoch_row(parts),
           "launches": counts, **scored, "card": smi}
    log("digits-vit", json.dumps(row))
    log("digits-vit", "seconds an epoch: " + json.dumps(
        {k: row[k] for k in ("epoch_s", "epoch_parts_s",
                             "data_wait_share")}))
    if best < DIGITS_VIT_BOUND:
        fail("digits-vit", f"best val top-1 {best} < {DIGITS_VIT_BOUND}")
    ema_ckpt = os.path.join(root, "digits_vit_ema_ckpt")
    rc, lines, ema_wall = _train_cli([
        "--datadir", data, "--ckpt-dir", ema_ckpt, "--epochs",
        str(DIGITS_VIT_EMA_EPOCHS), "--ema-decay", "0.99",
        *DIGITS_VIT_ARGS])
    if rc != 0:
        fail("digits-vit", f"the EMA run exited {rc}")
    row["ema"] = {"epochs": DIGITS_VIT_EMA_EPOCHS, "decay": 0.99,
                  "wall_s": ema_wall, **ema_served(data, ema_ckpt)}
    log("digits-vit", "EMA: " + json.dumps(row["ema"]))
    return counts, row


def _serve_rung(eng, pool, n_requests: int, seed: int, dtype=None,
                on_answer=None, keep_going=None):
    """Eight closed-loop clients sending ``n_requests`` requests of 1-8
    images of ``pool`` to ``eng`` (or, with ``keep_going``, as long as it
    returns true), each naming the rung ``dtype`` (a callable of the
    client's generator picks one a request).  Returns the answers
    ``(rung, lo, n, outputs, submitted)``, the errors, the wall seconds
    and Python's collections during the traffic."""
    results, errors, lock = [], [], threading.Lock()
    n_clients = 8

    def requests():
        if keep_going is None:
            return range(n_requests // n_clients)
        return iter(keep_going, False)

    def client(tid):
        r = np.random.default_rng(seed + 1 + tid)
        try:
            for _ in requests():
                n = int(r.integers(1, 9))
                lo = int(r.integers(0, pool.shape[0] - n + 1))
                tag = dtype(r) if callable(dtype) else dtype
                t_sub = time.perf_counter()
                out = eng.submit(pool[lo:lo + n], dtype=tag).result(
                    timeout=600)
                with lock:
                    results.append((tag, lo, n, out, t_sub))
                    if on_answer is not None:
                        on_answer(len(results))
        except Exception as e:  # reported by the caller; the phase fails
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_clients)]
    with gc_pauses() as pauses:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        errors.append("a client did not finish")
    return results, errors, time.perf_counter() - t0, pauses


def _pool_outputs(forward, pool) -> np.ndarray:
    """A rung's probabilities of every pool image, 32 at a time (the last
    chunk padded with zero images to 32, as the engine pads a bucket)."""
    out = []
    for lo in range(0, pool.shape[0], SERVE_BATCH):
        chunk = pool[lo:lo + SERVE_BATCH]
        x = np.zeros((SERVE_BATCH,) + chunk.shape[1:], chunk.dtype)
        x[:chunk.shape[0]] = chunk
        out.append(forward(torch.from_numpy(x).cuda())[0].cpu().numpy()[
            :chunk.shape[0]])
    return np.concatenate(out)


def ladder_model(name: str, image: int, seed: int):
    """``name`` at full width, 1000 classes, synthetic weights from
    ``seed``, float32, in eval mode: the fused ResNet-50 (K3), ViT-B/16
    with flash attention (K4), InceptionV3 as ``tpuic`` serves it."""
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.models import create_model
    kw = {"resnet50": dict(fused_conv_bn=True),
          VIT_MODEL: dict(attention="flash", image_size=image)}.get(name, {})
    return init_synthetic(create_model(name, 1000, dtype="float32", **kw),
                          seed=seed).eval()


def phase_ladder(name: str, image: int, seed: int, smi: str,
                 counter=None, per_call: int = 0, swap: bool = False):
    """The serve ladder for ``name``: the gate (each rung's top-1
    agreement with fp32 on ``quant.eval_images(128)`` at least ``1 -
    DEFAULT_EPSILON``, the corruption arm below it), each rung's batch-1
    rows against batch-32 rows (RUNG_ROW_TOL), weight bytes on the card,
    then one engine serving all three rungs, a graph per (rung, bucket):
    per rung the client mix of ``[serve]`` (images/s, latency, spans,
    launches per device call, answers against the rung's direct forward
    within RUNG_SERVE_TOL).  ``swap``: one swap of the whole ladder under
    mixed traffic, every answer one generation's."""
    from tpuic_torch import quant
    from tpuic_torch.serve import (DEFAULT_BUCKETS, InferenceEngine,
                                   make_forward)
    tag, t0 = "ladder", time.perf_counter()
    model = ladder_model(name, image, seed)
    rungs = quant.serve_variants(model, quant.DTYPE_TAGS)
    fwd = {t: make_forward(m, normalize=True) for t, m in rungs.items()}
    floor = 1.0 - quant.DEFAULT_EPSILON
    imgs = quant.eval_images(128, image)
    agree = {t: quant.top1_agreement(fwd["fp32"], fwd[t], imgs,
                                     device="cuda")
             for t in quant.DTYPE_TAGS[1:]}
    bad = quant.quantized_forward(quant.corrupt_variables(model, seed=seed))
    corrupt = quant.top1_agreement(fwd["fp32"], make_forward(
        bad, normalize=True), imgs, device="cuda")
    del bad
    free()
    if min(agree.values()) < floor or corrupt >= floor:
        fail(tag, f"{name}: gate agreement {agree} (floor {floor}), the "
                  f"corruption arm {corrupt} (must fall below it)")
    # Each rung's own forward, a row at batch 1 against batch 32: held to
    # RUNG_ROW_TOL for every rung the engine runs at every bucket; for a
    # rung it pins to its largest bucket (rows_follow_batch) reported.
    rows = {t: _rung_rows(tag, name, t, rungs[t], f, image)
            for t, f in fwd.items()}
    leaves = set(quant.quantized_leaves(model))
    leaf_bytes = {
        "fp32": sum(p.numel() * p.element_size()
                    for n, p in model.named_parameters() if n in leaves),
        "int8": sum(b.numel() * b.element_size()
                    for n, b in rungs["int8"].named_buffers()
                    if n.endswith(("weight_q", "weight_scale")))}
    weight_bytes = {t: quant.weight_bytes(m) for t, m in rungs.items()}
    eng = InferenceEngine(rungs["fp32"], image_size=image,
                          input_dtype=np.uint8, normalize=True,
                          buckets=(1, 8, 32), variants={
                              t: m for t, m in rungs.items()
                              if t != "fp32"})
    warm = eng.warmup()
    memory = eng.graph_memory()
    buckets = {t: eng.bucket_for(1, t) for t in quant.DTYPE_TAGS}
    # Served rows: an image alone and inside a request of 32, through the
    # engine, against RUNG_ROW_TOL (0 by construction for a pinned rung:
    # both ride bucket 32).
    rng = np.random.default_rng(1)
    x32 = rng.integers(0, 256, (SERVE_BATCH, image, image, 3),
                       dtype=np.uint8)
    served_rows = {}
    for t in quant.DTYPE_TAGS:
        big = eng.submit(x32, dtype=t).result(timeout=600)[0]
        served_rows[t] = max(float(np.abs(eng.submit(
            x32[r:r + 1], dtype=t).result(timeout=600)[0][0] - big[r]).max())
            for r in (0, 17, 31))
        if served_rows[t] > RUNG_ROW_TOL[t]:
            fail(tag, f"{name} {t}: a served row alone and in a request of "
                      f"{SERVE_BATCH} differ by {served_rows[t]} (bound "
                      f"{RUNG_ROW_TOL[t]})")
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (64, image, image, 3), dtype=np.uint8)
    refs = {t: _pool_outputs(f, pool) for t, f in fwd.items()}
    served = {}
    for t in quant.DTYPE_TAGS:
        reset_counts()
        windows, calls = [], 0
        for _ in range(LADDER_WINDOWS):
            # The same requests each window: the windows differ by timing.
            eng.stats.reset()
            results, errors, wall, pauses = _serve_rung(
                eng, pool, LADDER_REQUESTS, seed, dtype=t)
            snap = eng.stats.snapshot()
            if errors:
                fail(tag, f"{name} {t}: client errors {errors[:3]}")
            worst = max(float(np.abs(out[0] - refs[t][lo:lo + n]).max())
                        for _, lo, n, out, _ in results)
            if worst > RUNG_SERVE_TOL[t]:
                fail(tag, f"{name} {t}: served probabilities {worst} from "
                          f"a direct forward (bound {RUNG_SERVE_TOL[t]})")
            calls += snap["device_calls"]
            windows.append({
                "requests": len(results), "images": snap["images"],
                "images_per_s": snap["throughput_images_per_sec"],
                "images_per_s_wall": snap["images"] / wall,
                "latency_ms": snap["latency_ms"], "span_ms": snap["span_ms"],
                "device_calls": snap["device_calls"],
                "max_abs_err_vs_direct": worst,
                "gc_during_traffic": pauses})
        counts = read_counts()
        launches = counts.get(counter, 0) if counter else 0
        others = {k: v for k, v in counts.items() if k != counter and v}
        if launches != per_call * calls or others:
            fail(tag, f"{name} {t}: {launches} {counter} launches for "
                      f"{calls} device calls (expected {per_call} each), "
                      f"other kernels {others}")
        rates = sorted(r["images_per_s"] for r in windows)
        served[t] = {
            "images_per_s": rates[len(rates) // 2],
            "images_per_s_spread": (rates[-1] - rates[0]) / rates[0],
            "windows": windows, "device_calls": calls, "kernel": counter,
            "kernel_launches": launches, "launch_counts": counts,
            "lone": _lone_requests(eng, pool, t)}
    out = {"model": name, "image": image, "gate_agreement": agree,
           "corruption_agreement": corrupt, "gate_floor": floor,
           "batch1_vs_batch32": rows, "bucket_of_one_image": buckets,
           "served_batch1_vs_batch32": served_rows,
           "row_bounds": RUNG_ROW_TOL,
           "weight_bytes": weight_bytes, "quantized_leaf_bytes": leaf_bytes,
           "warmup_s": warm, "graph_memory": memory, "served": served,
           "card": smi}
    if swap:
        out["swap"] = _ladder_swap(eng, name, image, seed, pool, refs, tag)
    eng.close()
    del eng
    free()
    # A lone bf16 request at the serve CLI's default buckets.
    cli = InferenceEngine(rungs["bf16"], image_size=image,
                          input_dtype=np.uint8, normalize=True,
                          buckets=DEFAULT_BUCKETS, default_variant="bf16")
    cli.warmup()
    out["bf16_lone_at_cli_buckets"] = {
        "buckets": list(DEFAULT_BUCKETS), **_lone_requests(cli, pool,
                                                           "bf16")}
    cli.close()
    out["seconds"] = time.perf_counter() - t0
    log(tag, json.dumps(out))
    del cli, rungs, fwd, model
    free()
    return out


def _rung_rows(tag: str, name: str, t: str, rung, f, image: int) -> dict:
    """Rung ``t``'s forward ``f``: the largest probability difference
    between a row at batch 1 and the same row in a batch of 32 (rows 0,
    17, 31).  The phase fails on a non-finite output, or where the engine
    runs the rung at every bucket and the rows differ beyond
    RUNG_ROW_TOL."""
    from tpuic_torch.serve.engine import rows_follow_batch
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(
        0, 256, (SERVE_BATCH, image, image, 3), dtype=np.uint8)).cuda()
    big = f(x)[0]
    diff = max(float((f(x[r:r + 1])[0][0] - big[r]).abs().max())
               for r in (0, 17, 31))
    pinned = rows_follow_batch(t, rung)
    if not bool(torch.isfinite(big).all()) or (
            not pinned and diff > RUNG_ROW_TOL[t]):
        fail(tag, f"{name} {t}: a row at batch 1 and in batch "
                  f"{SERVE_BATCH} differ by {diff} (bound "
                  f"{RUNG_ROW_TOL[t]}), served at every bucket")
    return {"diff": diff, "max_prob": float(big.max()),
            "largest_bucket_only": pinned}


def _lone_requests(eng, pool, t: str) -> dict:
    """LONE_REQUESTS one-image requests of rung ``t``, one at a time:
    the bucket they ride, their latency and device span (ms)."""
    eng.stats.reset()
    for i in range(LONE_REQUESTS):
        eng.submit(pool[i:i + 1], dtype=t).result(timeout=600)
    snap = eng.stats.snapshot()
    return {"bucket": eng.bucket_for(1, t), "batch_hist": snap["batch_hist"],
            "latency_ms": snap["latency_ms"],
            "device_span_ms": snap["span_ms"].get("device")}


def bf16_rows_by_family(smi: str) -> dict:
    """The bf16 rung's batch-1 rows against batch 32 (``_rung_rows``) of
    the families ``[ladder]`` does not serve: EfficientNet-B3 and
    ResNet-50 unfused (cuDNN's convolutions, pinned by the engine)."""
    from tpuic_torch import quant
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.models import create_model
    from tpuic_torch.serve import make_forward
    out = {}
    for label, name, image, kw in (
            ("efficientnet-b3", EFF_MODEL, EFF_IMAGE, {}),
            ("resnet50 unfused", "resnet50", IMAGE, {})):
        model = init_synthetic(create_model(name, 1000, dtype="float32",
                                            **kw), seed=0).eval()
        rung = quant.bf16_variables(model)
        out[label] = _rung_rows("ladder", label, "bf16", rung,
                                make_forward(rung, normalize=True), image)
        del model, rung
        free()
    log("ladder", f"bf16 rows by family: {json.dumps(out)} | {smi}")
    return out


def _ladder_swap(eng, name, image, seed, pool, refs, tag) -> dict:
    """One swap of the whole ladder to another seed's weights while eight
    clients send requests of every rung: each answer must be the old
    ladder's or the new one's for its rung (within RUNG_SERVE_TOL, the two
    at least twice that apart), and every request submitted after the
    swap returned the new one's."""
    from tpuic_torch import quant
    from tpuic_torch.serve import make_forward
    new = quant.serve_variants(ladder_model(name, image, seed + 1),
                               quant.DTYPE_TAGS)
    refs_b = {t: _pool_outputs(make_forward(m, normalize=True), pool)
              for t, m in new.items()}
    half = threading.Event()
    swapped, sent = {}, {"all": 0, "after": 0}
    lock = threading.Lock()

    def answered(n):
        if n >= SWAP_REQUESTS // 3:
            half.set()

    def keep_going():
        # Until a third of SWAP_REQUESTS went in after the swap returned.
        with lock:
            sent["all"] += 1
            if "done" in swapped:
                sent["after"] += 1
            return (sent["after"] <= SWAP_REQUESTS // 3
                    and sent["all"] <= 20 * SWAP_REQUESTS)

    def swap_when_half():
        half.wait(timeout=600)
        swapped["t"] = time.perf_counter()
        swapped["res"] = eng.swap_weights(new["fp32"], variants={
            t: new[t] for t in quant.DTYPE_TAGS[1:]})
        swapped["done"] = time.perf_counter()

    worker = threading.Thread(target=swap_when_half)
    worker.start()
    results, errors, wall, _ = _serve_rung(
        eng, pool, SWAP_REQUESTS, seed + 7,
        dtype=lambda r: quant.DTYPE_TAGS[int(r.integers(0, 3))],
        on_answer=answered, keep_going=keep_going)
    worker.join(timeout=600)
    if errors or "res" not in swapped:
        fail(tag, f"{name} swap: errors {errors[:3]}, swap {swapped}")
    by_gen, gap = {"A": 0, "B": 0}, float("inf")
    for t, lo, n, out, t_sub in results:
        a = float(np.abs(out[0] - refs[t][lo:lo + n]).max())
        b = float(np.abs(out[0] - refs_b[t][lo:lo + n]).max())
        gap = min(gap, float(np.abs(refs[t][lo:lo + n]
                                    - refs_b[t][lo:lo + n]).max()))
        gen = "A" if a <= RUNG_SERVE_TOL[t] else (
            "B" if b <= RUNG_SERVE_TOL[t] else None)
        if gen is None or (t_sub > swapped["done"] and gen != "B"):
            fail(tag, f"{name} swap: a {t} request answered {a} from A and "
                      f"{b} from B (bound {RUNG_SERVE_TOL[t]}), submitted "
                      f"{'after' if t_sub > swapped['done'] else 'before'} "
                      "the swap returned")
        by_gen[gen] += 1
    if gap <= 2 * max(RUNG_SERVE_TOL.values()) or not by_gen["B"]:
        fail(tag, f"{name} swap: A and B lie {gap} apart, answers {by_gen}")
    row = {**swapped["res"], "answered_by": by_gen, "least_a_b_distance":
           gap, "requests": len(results), "wall_s": wall,
           "graph_memory": eng.graph_memory()}
    log(tag, f"{name} swap under traffic: " + json.dumps(row))
    return row


def phase_serve_cli_ladder(root: str, ckpt_dir: str, smi: str) -> dict:
    """``python -m tpuic_torch.serve --serve-dtypes fp32,bf16,int8`` on
    ``[ckpt]``'s checkpoint as a user runs it: CLI_IMAGES image files over
    stdin, each request naming a rung with ``serve_dtype`` in turn, every
    record's top-5 probabilities within that rung's RUNG_SERVE_TOL of the
    rung's direct forward of the same decoded pixels; the start gate's
    lines and the warmup's graph count printed."""
    import glob

    from tpuic_torch import quant
    from tpuic_torch.serve import make_forward
    from tpuic_torch.serve.__main__ import _load_image
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    paths = sorted(glob.glob(os.path.join(root, "val", "*", "*.png")))
    paths = paths[::max(1, len(paths) // CLI_IMAGES)][:CLI_IMAGES]
    tags = quant.DTYPE_TAGS
    t0 = time.perf_counter()
    out = subprocess.run(
        _serve_cmd(ckpt_dir, "--serve-dtypes", ",".join(tags)),
        input="".join(json.dumps({"id": p, "path": p,
                                  "serve_dtype": tags[i % 3]}) + "\n"
                      for i, p in enumerate(paths)),
        capture_output=True, text=True, timeout=600, env=env, cwd=here)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail("serve-cli-ladder", f"exited {out.returncode}: "
                                 f"{out.stderr[-3000:]}")
    gate = [ln for ln in out.stderr.splitlines()
            if "accuracy gate" in ln or "warmup" in ln]
    for line in gate:
        log("serve-cli-ladder", line)
    recs = {r["id"]: r for r in map(json.loads, out.stdout.splitlines())}
    model, names = _ckpt_model(ckpt_dir)
    index = {v: k for k, v in names.items()}
    rungs = quant.serve_variants(model, tags)
    x = np.stack([_load_image(p, IMAGE) for p in paths])
    probs = {t: _pool_outputs(make_forward(m, normalize=True), x)
             for t, m in rungs.items()}
    worst = {t: 0.0 for t in tags}
    for i, p in enumerate(paths):
        t, rec = tags[i % 3], recs.get(p)
        if rec is None or "pred" not in rec or len(rec["topk"]) != 5:
            fail("serve-cli-ladder", f"no answer for {p} ({t}): {rec}")
        for name, q in rec["topk"]:
            j = index.get(name, None if not name.isdigit() else int(name))
            worst[t] = max(worst[t], abs(q - float(probs[t][i, j])))
    if any(worst[t] > RUNG_SERVE_TOL[t] for t in tags):
        fail("serve-cli-ladder", f"records against the rungs' direct "
                                 f"forwards: {worst} (bounds "
                                 f"{RUNG_SERVE_TOL})")
    row = {"images": len(paths), "wall_s": wall, "tags": list(tags),
           "max_abs_err_vs_direct": worst, "gate_lines": gate, "card": smi}
    log("serve-cli-ladder", json.dumps(row))
    del model, rungs
    free()
    return row


# -- the Switch-MoE ViT and the trainer's telemetry ---------------------------
MOE_MODEL = "vit-s16-moe"
MOE_BATCH = 64
MOE_BLOCKS = (1, 3, 5, 7, 9, 11)
MOE_LR = 2e-3
MOE_SLO = "train_step:p99<=500ms"
MOE_REQUESTS = 320
# vit-tiny-moe at 32 px (65 tokens, 4 experts) for [ddp]'s MoE arm.
DDP_MOE_ARGS = ["--model", "vit-tiny-moe", "--resize", "32", "--attention",
                "flash", "--optimizer", "lamb", "--lr", "1e-3",
                "--weight-decay", "0.05", "--drop-path", "0.1"]
# Each step's logged aux loss in [ddp]'s MoE arm (the mean of the ranks'
# loss terms) against one process's: a term off by its ``world`` factor,
# or built on per-rank sums, moves it by far more (the gloo ranks'
# losses sat 6.7e-8 from one process).
MOE_AUX_RTOL = 1e-5
TEL_MODEL = "inceptionv3"
TEL_BATCH = 32
TEL_STEPS = 8             # [telemetry]'s steps an epoch (two epochs)
TEL_TRACE_STEPS = 2       # the on run's forced window (steps 10-11)
TEL_WINDOW = (14, 16)     # the off run's window: global steps [a, b)


def _jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _moe_argv(root: str, work: str, dtype: str, seed: int) -> list:
    """``[moe-train]``'s train-CLI flags: vit-s16-moe at 224 px, flash
    attention, the fused loss, LAMB through K2b, drop-path 0.1, one epoch
    of ``root`` (24 steps at batch 64), and the telemetry."""
    return ["--datadir", root, "--model", MOE_MODEL, "--resize", str(IMAGE),
            "--batchsize", str(MOE_BATCH), "--num-classes", "1000",
            "--attention", "flash", "--fused-loss", "--optimizer", "lamb",
            "--fused-optimizer", "--lr", str(MOE_LR), "--weight-decay",
            "0.05", "--drop-path", "0.1", "--label-smoothing", "0.1",
            "--no-class-weights", "--milestones", "--epochs", "1",
            "--dtype", dtype,
            *(["--compute-dtype", "bf16"] if dtype == "bfloat16" else []),
            "--workers", "8", "--log-every-steps", "4", "--seed", str(seed),
            "--no-resume", "--ckpt-dir", os.path.join(work, "ckpt"),
            "--log-dir", os.path.join(work, "logs"),
            "--metrics-jsonl", os.path.join(work, "events.jsonl"),
            "--trace-dir", os.path.join(work, "traces"), "--trace-steps",
            "3", "--trace-analyze", "--prom-dump",
            os.path.join(work, "train.prom"), "--slo", MOE_SLO]


@contextlib.contextmanager
def forced_trace(path: str):
    """``TPUIC_TRACE`` set in the block: the run's first step opens a
    profiler window at once."""
    old = os.environ.get("TPUIC_TRACE")
    os.environ["TPUIC_TRACE"] = path
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("TPUIC_TRACE", None)
        else:
            os.environ["TPUIC_TRACE"] = old


def telemetry_row(tag: str, work: str, model: str, dtype: str,
                  batch: int, image: int, profiled=()) -> dict:
    """What the run's telemetry wrote: the step events' total ms (median
    and p90 over the steps no profiler recorded: not a window's, not the
    one after it, which ran its analysis, not ``profiled``, the first two
    aside) and the MFU of that median step (the analytic FLOPs over the
    card's peak for ``dtype``), the final goodput report (its buckets
    must sum to its wall time), the memory peak, the analyzed window's
    waterfall (which must hold device events), its busy ms against the
    median step (the idle share without the profiler's own host cost;
    the window's span carries it) and the prom file's train rows."""
    from tpuic_torch.telemetry import goodput
    recs = _jsonl(os.path.join(work, "events.jsonl"))
    kinds = {}
    for r in recs:
        kinds[r["event"]] = kinds.get(r["event"], 0) + 1
    traced, window = set(profiled), None
    for r in recs:
        if r["event"] == "trace" and r.get("action") == "started":
            window = True
        elif r["event"] == "trace" and r.get("action") == "stopped":
            window = "analysis"
        elif r["event"] == "step" and window:
            traced.add(r["step"])
            window = None if window == "analysis" else window
    steps = [r for r in recs if r["event"] == "step"]
    clean = sorted(r["total_ms"] for r in steps[2:]
                   if r["step"] not in traced) or [0.0]
    final = [r for r in recs if r["event"] == "goodput" and r.get("final")]
    if len(final) != 1:
        fail(tag, f"{len(final)} final goodput reports")
    gp = final[0]
    buckets = sum(gp[k] for k in gp if k.endswith("_s") and k not in (
        "wall_s", "checkpoint_async_s"))
    if abs(buckets - gp["wall_s"]) > 0.01 + 0.01 * gp["wall_s"]:
        fail(tag, f"goodput buckets sum to {buckets} s of {gp['wall_s']} s")
    profiles = [r for r in recs if r["event"] == "profile"
                and not r.get("final") and "classes" in r]
    if not profiles:
        fail(tag, "no analyzed trace window: " + json.dumps(
            [r for r in recs if r["event"] in ("profile", "trace")]))
    wf = profiles[-1]
    prom = open(os.path.join(work, "train.prom")).read()
    for row in ("tpuic_train_goodput_fraction", "tpuic_train_steps_total",
                "tpuic_train_device_time_ms", "tpuic_train_mfu",
                "tpuic_train_device_memory_bytes"):
        if row not in prom:
            fail(tag, f"the prom file lacks {row}")
    memory = [r for r in recs if r["event"] == "memory"]
    median = clean[len(clean) // 2]
    peak = goodput.peak_flops(torch.cuda.get_device_name(0), dtype,
                              tf32=torch.backends.cuda.matmul.allow_tf32)
    flops = goodput.analytic_flops_per_step(model, image, batch)
    return {
        "events": kinds, "steps": len(steps), "clean_steps": len(clean),
        "step_ms_median": median,
        "step_ms_p90": clean[int(0.9 * (len(clean) - 1))],
        "mfu_median_step": flops / (peak * median * 1e-3),
        "peak_flops": peak, "analytic_flops_per_step": flops,
        "busy_over_median_step": wf["busy_ms_per_step"] / median,
        "idle_frac_without_profiler": 1.0 - wf["busy_ms_per_step"] / median,
        "traced_steps": sorted(traced),
        "goodput": {k: gp[k] for k in gp if k.startswith(("frac_", "mfu"))
                    or k in ("wall_s", "accounted_frac", "compiles")},
        "peak_bytes_in_use": max(r.get("peak_bytes_in_use", 0)
                                 for r in memory) if memory else None,
        "waterfall": {k: wf[k] for k in (
            "classes", "port_kernels", "layers", "busy_ms_per_step",
            "span_ms_per_step", "idle_frac", "device_ms_per_step",
            "stall_ms", "syncs", "steps_traced", "kernels_per_step",
            "host_ops_per_step", "top_kernels") if k in wf}}


def moe_routing(cfg, batch) -> dict:
    """The trained ``latest`` weights of ``cfg``'s run in train mode on
    ``batch`` (every drop-path site kept): each MoE block's expert token
    shares and dropped-token share, and the batch's aux loss."""
    from tpuic_torch.checkpoint.loading import load_inference_variables
    from tpuic_torch.models import moe
    model = load_inference_variables(cfg, track="latest",
                                     log=lambda m: None).train()
    layers = moe.moe_layers(model)
    masks = torch.ones((len(model.backbone.drop_path_rates()),
                        batch["image"].shape[0]), dtype=torch.bool,
                       device="cuda")
    with torch.no_grad():
        model(batch["image"], drop_masks=masks)
        stats = moe.take_router_stats(layers)
        out = {}
        auxes = []
        for i, (layer, (p, o)) in zip(MOE_BLOCKS, zip(layers, stats)):
            summ = moe.routing_summary(o, layer.capacity(
                p.shape[1])).tolist()
            auxes.append(float(moe.switch_aux_loss(p, o, batch["mask"])))
            # An image's busiest expert's share of its own tokens.
            per_image = float((o.sum(dim=1) / o.shape[1]).amax(-1).mean())
            out[f"block{i}"] = {"expert_share": summ[:-1],
                                "dropped_share": summ[-1],
                                "image_top_expert_share": per_image}
    del model
    free()
    return {"blocks": out, "aux_loss": sum(auxes) / len(auxes)}


def phase_moe_train(root: str, seed: int, smi: str):
    """ViT-S/16-MoE through the train CLI, in float32 and bf16: launches
    (K4 at [64, 197, 6, 64], K1, K2b's LAMB), the aux loss, each block's
    routing and the telemetry's step ms and waterfall; then the kernels
    against the plain versions on the same 3 batches (TF32 off)."""
    from tpuic_torch.train import __main__ as train_cli
    from tpuic_torch.train.loop import Trainer
    tag = "moe-train"
    t_start = time.perf_counter()
    counts, rows = {}, {}
    steps = TRAIN_BATCH * TRAIN_STEPS // MOE_BATCH
    for dtype in ("float32", "bfloat16"):
        work = tempfile.mkdtemp(prefix=f"moe_{dtype}_", dir=root)
        argv = _moe_argv(root, work, dtype, seed)
        reset_counts()
        with forced_trace(os.path.join(work, "traces")):
            rc, lines, wall = _train_cli(argv)
        counts[dtype] = read_counts()
        for line in lines:
            if line.startswith(("[model]", "[goodput]", "[slo]")) or \
                    "Val Accuracy" in line:
                log(tag, f"{dtype}: {line}")
        val_forwards = -(-2 * TRAIN_BATCH // MOE_BATCH)
        want = expect(flash_attention_fwd=12 * (steps + val_forwards),
                      flash_attention_bwd_dq=12 * steps,
                      flash_attention_bwd_dkv=12 * steps,
                      cross_entropy_fwd=steps, cross_entropy_bwd=steps,
                      lamb_update=steps)
        if rc != 0 or counts[dtype] != want:
            fail(tag, f"{dtype}: exit {rc}, launches {counts[dtype]}, "
                      f"expected {want}")
        logged = _jsonl(os.path.join(work, "logs", "metrics.jsonl"))
        aux = [r["moe_aux"] for r in logged if "moe_aux" in r]
        losses = [r["loss"] for r in logged if "loss" in r]
        if not aux or not all(math.isfinite(v) for v in aux + losses):
            fail(tag, f"{dtype}: aux {aux}, losses {losses}")
        parser = train_cli.build_parser()
        cfg = train_cli.config_from_args(parser.parse_args(argv), parser)
        if dtype == "float32":
            cfg32 = cfg
        tel = telemetry_row(tag, work, MOE_MODEL,
                            "bf16" if dtype == "bfloat16" else "f32",
                            MOE_BATCH, IMAGE)
        rows[dtype] = {"steps": steps, "wall_s": wall, "launches":
                       counts[dtype], "moe_aux_logged": aux,
                       "losses_logged": losses, **tel,
                       "images_per_s": MOE_BATCH / tel["step_ms_median"]
                       * 1e3, "card": smi}
        if dtype == "float32":
            trainer = Trainer(dataclasses.replace(
                cfg, run=dataclasses.replace(cfg.run, metrics_jsonl="",
                                             trace_dir="", slo="",
                                             trace_analyze=False)),
                log=lambda m: None)
            batches = first_batches(trainer)
            del trainer
            free()
        rows[dtype]["routing"] = moe_routing(cfg, batches[0])
        log(tag, f"{dtype}: " + json.dumps(rows[dtype]))
    arms = compare_plain(cfg32, batches, seed, MOE_LR / 10,
                         plain_model=dataclasses.replace(
                             cfg32.model, attention="dense"))
    rows["compare"] = check_compare(tag, arms)
    rows["phase_s"] = time.perf_counter() - t_start
    del batches
    free()
    return counts, rows


def phase_moe_serve(seed: int, smi: str) -> dict:
    """ViT-S/16-MoE (seeded synthetic weights, flash attention) served on
    the fp32 and bf16 rungs by one engine, a CUDA graph per (rung,
    bucket): a row alone against the same row in a request of 32
    (RUNG_ROW_TOL: fp32's is [vit-serve]'s SERVE_TOL; routing groups are
    per image), then MOE_REQUESTS closed-loop requests a rung (images/s,
    p50/p99), answers against the rung's direct forward, K4f 12 times a
    device call."""
    from tpuic_torch import quant
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.models import create_model
    from tpuic_torch.serve import InferenceEngine, make_forward
    tag, t0 = "moe-serve", time.perf_counter()
    model = init_synthetic(create_model(
        MOE_MODEL, 1000, dtype="float32", attention="flash",
        image_size=IMAGE), seed=seed).eval()
    tags = ("fp32", "bf16")
    rungs = quant.serve_variants(model, tags)
    fwd = {t: make_forward(m, normalize=True) for t, m in rungs.items()}
    rows = {t: _rung_rows(tag, MOE_MODEL, t, rungs[t], f, IMAGE)
            for t, f in fwd.items()}
    eng = InferenceEngine(rungs["fp32"], image_size=IMAGE,
                          input_dtype=np.uint8, normalize=True,
                          buckets=(1, 8, 32), variants={"bf16":
                                                        rungs["bf16"]})
    warm = eng.warmup()
    rng = np.random.default_rng(1)
    x32 = rng.integers(0, 256, (SERVE_BATCH, IMAGE, IMAGE, 3),
                       dtype=np.uint8)
    served_rows = {}
    for t in tags:
        big = eng.submit(x32, dtype=t).result(timeout=600)[0]
        served_rows[t] = max(float(np.abs(eng.submit(
            x32[r:r + 1], dtype=t).result(timeout=600)[0][0] - big[r]).max())
            for r in (0, 17, 31))
        if served_rows[t] > RUNG_ROW_TOL[t]:
            fail(tag, f"{t}: a served row alone and in a request of "
                      f"{SERVE_BATCH} differ by {served_rows[t]} (bound "
                      f"{RUNG_ROW_TOL[t]})")
    pool = np.random.default_rng(seed).integers(
        0, 256, (64, IMAGE, IMAGE, 3), dtype=np.uint8)
    refs = {t: _pool_outputs(f, pool) for t, f in fwd.items()}
    served = {}
    for t in tags:
        eng.stats.reset()
        reset_counts()
        results, errors, wall, pauses = _serve_rung(
            eng, pool, MOE_REQUESTS, seed, dtype=t)
        snap = eng.stats.snapshot()
        counts = read_counts()
        if errors:
            fail(tag, f"{t}: client errors {errors[:3]}")
        worst = max(float(np.abs(out[0] - refs[t][lo:lo + n]).max())
                    for _, lo, n, out, _ in results)
        if worst > RUNG_SERVE_TOL[t]:
            fail(tag, f"{t}: served probabilities {worst} from a direct "
                      f"forward (bound {RUNG_SERVE_TOL[t]})")
        if counts != expect(flash_attention_fwd=12 * snap["device_calls"]):
            fail(tag, f"{t}: launches {counts} for {snap['device_calls']} "
                      "device calls (expected 12 K4f each)")
        served[t] = {"requests": len(results), "images": snap["images"],
                     "images_per_s": snap["throughput_images_per_sec"],
                     "images_per_s_wall": snap["images"] / wall,
                     "latency_ms": snap["latency_ms"],
                     "device_calls": snap["device_calls"],
                     "kernel_launches": counts["flash_attention_fwd"],
                     "max_abs_err_vs_direct": worst,
                     "gc_during_traffic": pauses}
    eng.close()
    out = {"model": MOE_MODEL, "image": IMAGE,
           "params": sum(p.numel() for p in model.parameters()),
           "batch1_vs_batch32": rows, "served_batch1_vs_batch32":
           served_rows, "row_bounds": {t: RUNG_ROW_TOL[t] for t in tags},
           "warmup_s": warm, "served": served, "card": smi,
           "phase_s": time.perf_counter() - t0}
    log(tag, json.dumps(out))
    del eng, rungs, model
    free()
    return out


_SYNC_WINDOW = r"""
import atexit, json, os, runpy, sys, time
out, a, b, argv = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4:]
import torch
from tpuic_torch.telemetry import profile, tracing
from tpuic_torch.train import loop
_make = loop.make_train_step
stamps = []

def dump():
    with open(os.path.join(out, "stamps.json"), "w") as f:
        json.dump(stamps, f)

atexit.register(dump)

gate, parent = os.environ.get("SMOKE_TEL_GATE", ""), os.getppid()

def make(*args, **kw):
    step = _make(*args, **kw)
    calls = {"n": 0, "prof": None}
    if gate and not os.path.exists(gate):
        # Built: say so, then wait for this run's turn.
        open(os.path.join(out, "ready"), "w").close()
        while not os.path.exists(gate):
            if os.getppid() != parent:
                sys.exit(3)
            time.sleep(0.01)

    def wrapped(*a_, **k_):
        calls["n"] += 1
        stamps.append(time.perf_counter())
        if calls["n"] == a:
            calls["prof"] = tracing.start_profiler()
        elif calls["n"] == b:
            tracing.stop_profiler(calls["prof"], out)
            wf = profile.parse_trace(out, steps=b - a)
            with open(os.path.join(out, "window.json"), "w") as f:
                json.dump(wf, f)
        return step(*a_, **k_)
    return wrapped

loop.make_train_step = make
sys.argv = ["python -m tpuic_torch.train"] + argv
runpy.run_module("tpuic_torch.train", run_name="__main__", alter_sys=True)
"""


def _tel_start(work: str, argv: list, env: dict, window=(0, 0)) -> dict:
    """Start one train-CLI process, with a profiler window of its own over
    the global steps ``[a, b)`` of ``window`` unless it is ``(0, 0)``.
    Once built (its train step made) it writes ``ready`` and waits for
    its gate file: two runs' process starts overlap, their steps do
    not."""
    win = os.path.join(work, "window")
    os.makedirs(win)
    gate = os.path.join(work, "go")
    proc = subprocess.Popen(
        [sys.executable, "-c", _SYNC_WINDOW, win, str(window[0]),
         str(window[1]), *argv],
        env=dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)), SMOKE_TEL_GATE=gate, **env),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return {"proc": proc, "win": win, "gate": gate, "window": window}


def _tel_ready(tag: str, runs: list) -> None:
    t0 = time.perf_counter()
    while not all(os.path.exists(os.path.join(r["win"], "ready"))
                  for r in runs):
        for r in runs:
            if r["proc"].poll() is not None:
                out = r["proc"].communicate()[0]
                log(tag, "\n".join(out.splitlines()[-20:]))
                for other in runs:
                    if other["proc"].poll() is None:
                        other["proc"].kill()
                        other["proc"].communicate()
                fail(tag, f"the train CLI exited {r['proc'].returncode} "
                          "before its turn")
        if time.perf_counter() - t0 > DDP_TIMEOUT:
            for r in runs:
                r["proc"].kill()
                r["proc"].communicate()
            fail(tag, f"the runs were not built within {DDP_TIMEOUT} s")
        time.sleep(0.05)


def _tel_finish(tag: str, run: dict, others=()) -> dict:
    """Open ``run``'s gate and wait for it: its window's parsed trace
    (sync calls a step among it, else None), the host time of each
    train-step call (``stamps``: when each call began) and its seconds
    from the gate."""
    t0 = time.perf_counter()
    open(run["gate"], "w").close()
    try:
        out, _ = run["proc"].communicate(timeout=DDP_TIMEOUT)
    except subprocess.TimeoutExpired:
        for r in (run, *others):
            r["proc"].kill()
            r["proc"].communicate()
        fail(tag, f"the train CLI did not end within {DDP_TIMEOUT} s")
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        if line.startswith(("[model]", "[goodput]", "[slo]", "[profile]",
                            "[tpuic_torch]")) or "Val Accuracy" in line:
            log(tag, line)
    if run["proc"].returncode:
        log(tag, "\n".join(out.splitlines()[-20:]))
        for r in others:
            r["proc"].kill()
            r["proc"].communicate()
        fail(tag, f"the train CLI exited {run['proc'].returncode}")
    parsed = None
    if run["window"] != (0, 0):
        with open(os.path.join(run["win"], "window.json")) as f:
            parsed = json.load(f)
    with open(os.path.join(run["win"], "stamps.json")) as f:
        stamps = json.load(f)
    return {"window": parsed, "wall_s": wall, "stamps": stamps}


def telemetry_cost(n: int = 2000) -> dict:
    """The telemetry's own host microseconds on the card: one memory
    sample, and a step's ``step_end`` with a run's default subscribers
    (step timer, memory sampler every CARD_EVERY steps, goodput), the
    mean over ``n`` calls."""
    from tpuic_torch.config import RunConfig
    from tpuic_torch.telemetry.events import EventBus
    from tpuic_torch.telemetry.memory import MemorySampler
    from tpuic_torch.telemetry.wiring import TrainTelemetry
    dev = torch.device("cuda", 0)
    sampler = MemorySampler(publish=EventBus().publish, device=dev)
    sampler.sample(step=0)
    t0 = time.perf_counter()
    for i in range(n):
        sampler.sample(step=i)
    sample_us = (time.perf_counter() - t0) / n * 1e6
    tm = TrainTelemetry(RunConfig(), model_name=TEL_MODEL,
                        image_size=INC_IMAGE, global_batch=TEL_BATCH,
                        device=dev, compute_dtype="bf16")
    timer = tm.steptime
    timer.epoch_start()
    t0 = time.perf_counter()
    for i in range(n):
        timer.dispatch_start()
        timer.dispatch_end()
        timer.step_end(i + 1)
    step_us = (time.perf_counter() - t0) / n * 1e6
    tm.close()
    return {"memory_sample_us": sample_us, "step_end_us": step_us}


def phase_telemetry(root: str, seed: int, smi: str) -> dict:
    """InceptionV3 (the reference's default model, bf16 as it trains) at
    batch 32 through the train CLI, two epochs of TEL_STEPS steps, with
    every telemetry flag on (``--profile-dir`` traces epoch 0, a forced
    ``TPUIC_TRACE`` window then takes TEL_TRACE_STEPS steps of epoch 1
    and is analyzed), and again with none: the JSONL's events, goodput's
    buckets summing to its wall time, the prom rows, the analyzed
    waterfall and idle share.  The forced window's cudaStreamSynchronize
    and cudaDeviceSynchronize calls a step must equal those of a window
    of the script's own over as many steps of the off run.  Epoch 1's
    step ms after the on run's windows against the off run's before its
    window: what a finished profiler session leaves behind."""
    tag = "telemetry"
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="telemetry_", dir=root)
    data = os.path.join(work, "data")
    os.makedirs(os.path.join(data, "train"))
    per = TEL_BATCH * TEL_STEPS // TRAIN_CLASSES
    for c in sorted(os.listdir(os.path.join(root, "train"))):
        src = os.path.join(root, "train", c)
        os.makedirs(os.path.join(data, "train", c))
        for name in sorted(os.listdir(src))[:per]:
            os.symlink(os.path.join(src, name),
                       os.path.join(data, "train", c, name))
    os.symlink(os.path.join(root, "val"), os.path.join(data, "val"))
    base = ["--datadir", data, "--model", TEL_MODEL, "--batchsize",
            str(TEL_BATCH), "--num-classes", "1000", "--epochs", "2",
            "--no-class-weights", "--workers", "8", "--log-every-steps",
            "1", "--seed", str(seed), "--no-resume"]
    on_dir = os.path.join(work, "on")
    on_argv = base + [
        "--ckpt-dir", os.path.join(on_dir, "ckpt"),
        "--metrics-jsonl", os.path.join(on_dir, "events.jsonl"),
        "--profile-dir", os.path.join(on_dir, "profile"),
        "--trace-dir", os.path.join(on_dir, "traces"), "--trace-steps",
        str(TEL_TRACE_STEPS), "--trace-analyze", "--prom-dump",
        os.path.join(on_dir, "train.prom"), "--slo", MOE_SLO, "--log-dir",
        os.path.join(on_dir, "logs")]
    off_dir = os.path.join(work, "off")
    runs = [_tel_start(on_dir, on_argv,
                       {"TPUIC_TRACE": os.path.join(on_dir, "traces")}),
            _tel_start(off_dir, base + ["--ckpt-dir",
                                        os.path.join(off_dir, "ckpt")],
                       {"TPUIC_TRACE": ""}, window=TEL_WINDOW)]
    _tel_ready(tag, runs)
    on = _tel_finish(tag, runs[0], runs[1:])
    off = _tel_finish(tag, runs[1])
    # Epoch 0 ran under --profile-dir.
    row = telemetry_row(tag, on_dir, TEL_MODEL, "bf16", TEL_BATCH,
                        INC_IMAGE, profiled=range(1, TEL_STEPS + 1))
    need = {"step", "epoch", "eval", "goodput", "checkpoint_commit",
            "memory", "trace", "profile"}
    if not need <= set(row["events"]):
        fail(tag, f"events {row['events']} lack {need - set(row['events'])}")
    if not os.path.isfile(os.path.join(on_dir, "profile", "epoch0",
                                       "trace.json")):
        fail(tag, "--profile-dir wrote no trace of epoch 0")
    # The forced window against the script's own in the off run: windows
    # of as many steps, each whole loop iterations.
    wf = row["waterfall"]
    if wf.get("steps_traced") != TEL_TRACE_STEPS:
        fail(tag, f"the forced window traced {wf.get('steps_traced')} "
                  f"steps, expected {TEL_TRACE_STEPS}")
    syncs = {"on": wf["syncs"], "off": off["window"]["syncs"]}
    if syncs["on"] != syncs["off"]:
        fail(tag, f"sync calls a step with telemetry on and off: {syncs}")
    # Step ms of epoch 1: an iteration is the interval from a step's call
    # to the next one's, kept where no profiler recorded, started or
    # stopped in it.  The on run's come after --profile-dir's epoch and
    # its forced window; the off run's before its own window.
    on_off = {}
    for arm, run, traced in (
            ("on", on, set(row["traced_steps"])),
            ("off", off, set(range(*TEL_WINDOW)))):
        clean = [k for k in range(TEL_STEPS + 1, 2 * TEL_STEPS)
                 if k not in traced and k + 1 not in traced]
        st = run["stamps"]
        ms = sorted((st[k] - st[k - 1]) * 1e3 for k in clean)
        on_off[arm] = {"steps": clean, "median_ms": ms[len(ms) // 2],
                       "ms": ms}
    row.update(model=TEL_MODEL, batch=TEL_BATCH, dtype="bfloat16",
               syncs_per_step=syncs, window_steps={
                   "on": [k for k in row["traced_steps"] if k > TEL_STEPS],
                   "off": list(range(*TEL_WINDOW))},
               step_ms_on_off=on_off,
               after_window_over_before=on_off["on"]["median_ms"]
               / on_off["off"]["median_ms"],
               host_cost=telemetry_cost(),
               off_window={k: off["window"][k] for k in (
                   "busy_ms_per_step", "span_ms_per_step", "idle_frac",
                   "classes")},
               wall_s={"on": on["wall_s"], "off": off["wall_s"]},
               card=smi, phase_s=time.perf_counter() - t0)
    log(tag, json.dumps(row))
    return row


# [serve-ops]: the operated replica (ResNet-50, 224 px, buckets 1/8/32).
OPS_BUCKETS = (1, 8, 32)
OPS_REPLAY_TOL = 0.10     # replay ms after a profiler window against before
OPS_WATERFALL_TOL = 0.05  # the classes' ms against the device span
OPS_TIMING_ITERS = 30     # replays a timing window; the median of 3 windows
OPS_WINDOW_TRAFFIC = 16   # requests of 32 images the device span averages
OPS_SPAN_BATCHES = 20     # closed-loop batches a sync-count window
# The flood against the replica's knee ([ladder]'s fp32 ResNet-50: ~2,266
# images/s in requests of 1-8 images; one-image requests are host-bound
# near 1,570 a second, p50 ~40 ms): one-image low requests at
# OPS_FLOOD_RPS, high ones from a client at OPS_HIGH_RPS for OPS_SLO_S
# (each a 200 KB b64 line the server decodes holding the GIL: 300 a second
# held the high requests' own p50 near 30 ms).  A p50 objective, so that
# half the tracker's 1,024-sample window of good samples brings the burn
# back under 1: recovery takes ~7 s of high requests after the tighten.
# 3,000 a second did not overload a faster host (H100 80GB HBM3, 700 W:
# all 37,311 flood requests served at p50 18 ms, so the SLO never
# burned); 6,000 a second is past what the device serves at any bucket
# (bucket 32's replay ~8 ms: ~4,000 images a second).
OPS_FLOOD_RPS = 6000
OPS_HIGH_RPS = 100
OPS_SLO_S = 12.0
OPS_SLO = "serve_latency:p50<=25ms"
OPS_TIGHTEN = 1.2         # burn rate 1.2: 40% of the window good
OPS_SCRAPE_S = 0.2        # the scraper's period
OPS_CRASH_AT = 6          # replica_crash@K: the Kth accepted request
OPS_WEDGE_AT = 6          # replica_wedge@K
OPS_WATCHDOG_S = 5.0
OPS_CANARY_S = 0.05       # canary_degrade#0.05
OPS_START_S = 240.0       # a replica's start, its warmup included


def _replica_cmd(ready: str, *extra) -> list:
    """``python -m tpuic_torch.serve`` as a load-testing replica: ResNet-50
    at 224 px with seeded weights, buckets 1/8/32, on ``--listen``."""
    return [sys.executable, "-m", "tpuic_torch.serve", "--synthetic-init",
            "--model", "resnet50", "--num-classes", "1000", "--resize",
            str(IMAGE), "--buckets", ",".join(map(str, OPS_BUCKETS)),
            "--listen", "127.0.0.1:0", "--ready-file", ready, *extra]


def _await_ready(tag: str, ready: str, proc, err_path: str,
                 not_pid=None) -> dict:
    """The replica's ready file once it names a pid other than
    ``not_pid``; fails the phase when ``proc`` exits first or after
    OPS_START_S."""
    from tpuic_torch.serve import wire
    t0 = time.perf_counter()
    while True:
        info = wire.read_ready_file(ready)
        if info is not None and info.get("pid") != not_pid:
            return info
        if proc.poll() is not None or time.perf_counter() - t0 > OPS_START_S:
            fail(tag, f"no ready file (exit {proc.poll()}): "
                      f"{open(err_path).read()[-3000:]}")
        time.sleep(0.05)


def _ask(port: int, lines: list, timeout: float = 120.0) -> list:
    """Send ``lines`` on one connection; the records that come back, one
    a line, until each has its answer or the server closes."""
    import socket
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as sock:
        sock.sendall("".join(json.dumps(r) + "\n" for r in lines).encode())
        return _Records(sock).read(lambda got: len(got) >= len(lines))


def _syncs_by_scope(trace_dir: str, scopes) -> dict:
    """cuda runtime synchronize calls in a Chrome trace, by name, within
    the host range of each ``record_function`` scope in ``scopes`` (on
    any thread: the batcher's calls fall inside the range of the scope
    the main thread was in)."""
    from tpuic_torch.telemetry import profile
    events = [e for f in profile._trace_files(trace_dir)
              for e in profile._load_events(f) if e.get("ph") == "X"]
    ranges = {str(e["name"]): (float(e["ts"]), float(e["ts"])
                               + float(e.get("dur", 0.0)))
              for e in events if e.get("name") in scopes}
    out = {k: {} for k in scopes}
    for e in events:
        name = str(e.get("name", ""))
        if e.get("cat") != "cuda_runtime" or "Synchronize" not in name:
            continue
        for k, (a, b) in ranges.items():
            if a <= float(e.get("ts", 0.0)) <= b:
                out[k][name] = out[k].get(name, 0) + 1
    return out, sorted(ranges)


def _ops_waterfall(tag: str, eng, model, x32, smi: str) -> dict:
    """Replays of bucket 32's graph before any profiler window, after one
    and after two (``_take_waterfall``, the window warmup takes): bit for
    bit an eager forward and the first replay, and as fast.  Then the
    waterfall over OPS_WINDOW_TRAFFIC served requests of 32 images: its
    classes summed against the measured device span."""
    from tpuic_torch.serve import make_forward
    from tpuic_torch.telemetry.profile import port_kernel
    eager = [t.clone() for t in make_forward(model, normalize=True)(x32)]

    def replay():
        return eng.replay(32, x32)

    def timed():
        return statistics.median(time_ms(replay, iters=OPS_TIMING_ITERS)
                                 for _ in range(3))

    def bits(ref):
        got = [t.clone() for t in replay()]
        torch.cuda.synchronize()
        return all(torch.equal(a, b) for a, b in zip(got, ref))

    first = [t.clone() for t in replay()]
    torch.cuda.synchronize()
    rows = {"before": {"ms": timed(), "bits_vs_eager": bits(eager)}}
    windows = []
    for k in ("after_window_1", "after_window_2"):
        t0 = time.perf_counter()
        eng._take_waterfall(eng._gen, eng.generation)
        windows.append(time.perf_counter() - t0)
        rows[k] = {"ms": timed(), "bits_vs_eager": bits(eager),
                   "bits_vs_first_replay": bits(first)}
    for k, r in rows.items():
        if not r["bits_vs_eager"] or not r.get("bits_vs_first_replay", True):
            fail(tag, f"bucket 32's replay {k} differs from the eager "
                      f"forward or the first replay: {rows}")
        ratio = r["ms"] / rows["before"]["ms"]
        r["over_before"] = ratio
        if abs(ratio - 1.0) > OPS_REPLAY_TOL:
            fail(tag, f"replay ms {k} is {ratio:.3f}x the ms before any "
                      f"window (tolerance {OPS_REPLAY_TOL}): {rows}")
    eng.stats.reset()
    pool = np.random.default_rng(5).integers(0, 256, (32, IMAGE, IMAGE, 3),
                                             dtype=np.uint8)
    for _ in range(OPS_WINDOW_TRAFFIC):
        eng.submit(pool).result(timeout=120)
    wf = eng.profile_waterfall()
    if wf is None or not wf.get("classes"):
        fail(tag, f"no measured waterfall: {wf}")
    with eng.stats._lock:
        meter = eng.stats.spans["device"]
        span_ms = 1000.0 * meter.total / meter.count
    total = sum(c["ms"] for c in wf["classes"].values())
    if abs(total - span_ms) > OPS_WATERFALL_TOL * span_ms:
        fail(tag, f"the waterfall's classes sum to {total} ms against a "
                  f"device span of {span_ms} ms")
    k3 = sum(ms for k, ms in wf["port_kernels"].items() if k == "K3")
    out = {"replays": rows, "window_s": windows,
           "classes": {k: {"ms": c["ms"], "frac": c["frac"]}
                       for k, c in wf["classes"].items()},
           "classes_ms_sum": total, "device_span_ms": span_ms,
           "k3_ms_per_replay": k3, "k3_share_of_busy": k3 / max(
               1e-9, wf["busy_ms_per_step"]),
           "busy_ms_per_replay": wf["busy_ms_per_step"],
           "kernels_per_replay": wf["kernels_per_step"],
           "stall_ms": wf["stall_ms"], "bucket": wf["bucket"],
           "top_kernels": wf["top_kernels"][:5],
           "k_ids": sorted({port_kernel(n) for n, _, _ in wf["top_kernels"]
                            if port_kernel(n)}), "card": smi}
    log(tag, "waterfall: " + json.dumps(out))
    return out


def _ops_spans(tag: str, eng, root: str) -> dict:
    """Sync calls a batch with ``serve_span`` unsubscribed and subscribed:
    one profiler window over OPS_SPAN_BATCHES closed-loop batches of 32
    images in each arm, the arms in ``record_function`` scopes of their
    own; each span's six phases against its ``total_ms``."""
    from tpuic_torch.serve.metrics import SPAN_PHASES
    from tpuic_torch.telemetry import events, tracing
    pool = np.random.default_rng(6).integers(0, 256, (32, IMAGE, IMAGE, 3),
                                             dtype=np.uint8)
    eng.submit(pool).result(timeout=120)
    sink = events.MemorySink(maxlen=OPS_SPAN_BATCHES * 2)
    out_dir = os.path.join(root, "spans")
    prof = tracing.start_profiler()
    try:
        for arm in ("off", "on"):
            unsub = (events.bus.subscribe(sink, kinds=("serve_span",))
                     if arm == "on" else None)
            try:
                with torch.profiler.record_function(f"spans_{arm}"):
                    for _ in range(OPS_SPAN_BATCHES):
                        eng.submit(pool).result(timeout=120)
            finally:
                if unsub is not None:
                    unsub()
    finally:
        tracing.stop_profiler(prof, out_dir)
    syncs, found = _syncs_by_scope(out_dir, ("spans_off", "spans_on"))
    per_batch = {k[6:]: {n: c / OPS_SPAN_BATCHES for n, c in v.items()}
                 for k, v in syncs.items()}
    spans = sink.of("serve_span")
    if len(spans) != OPS_SPAN_BATCHES or len(found) != 2:
        fail(tag, f"{len(spans)} serve_span events for {OPS_SPAN_BATCHES} "
                  f"requests; scopes in the trace: {found}")
    worst = max(abs(sum(ev.data[f"{p}_ms"] for p in SPAN_PHASES)
                    - ev.data["total_ms"]) for ev in spans)
    if per_batch["on"] != per_batch["off"] or not per_batch["off"] \
            or worst > 1e-3:
        fail(tag, f"sync calls a batch with spans off and on: {per_batch}; "
                  f"phases against total_ms: {worst} ms")
    out = {"syncs_per_batch": per_batch, "phase_sum_max_err_ms": worst,
           "spans": len(spans), "span_example": spans[-1].data}
    log(tag, "spans: " + json.dumps(out))
    return out


def _ops_canary(tag: str, eng, model, other) -> dict:
    """``canary_degrade#OPS_CANARY_S`` armed in this process: silent on
    the boot weights, firing after a swap to ``other`` (whose standby
    graphs, captured in the live slot's shapes, take the live slot's
    waterfall window: no window beside traffic), standing down once the
    boot weights are swapped back."""
    from tpuic_torch.runtime import faults
    boot = {k: v.clone() for k, v in model.state_dict().items()}
    x = np.random.default_rng(8).integers(0, 256, (1, IMAGE, IMAGE, 3),
                                          dtype=np.uint8)

    def lone_ms():
        t0 = time.perf_counter()
        eng.submit(x).result(timeout=120)
        return (time.perf_counter() - t0) * 1e3

    faults.reset()
    faults.arm("canary_degrade", param=OPS_CANARY_S)
    eng.waterfall = True
    try:
        rows = {"boot": {"ms": lone_ms(),
                         "fired": faults.fired("canary_degrade")}}
        wf_live = eng._gen.waterfall
        swap = eng.swap_weights(other)
        wf_gen = eng.profile_waterfall()["gen"]
        inherited = eng._gen.waterfall == wf_live
        rows["swapped"] = {"ms": lone_ms(),
                           "fired": faults.fired("canary_degrade"),
                           "generation": swap["generation"],
                           "prewarmed": swap["prewarmed"],
                           "waterfall_gen": wf_gen,
                           "waterfall_inherited": inherited}
        back = eng.swap_weights(boot)
        rows["swapped_back"] = {"ms": lone_ms(),
                                "fired": faults.fired("canary_degrade"),
                                "digest_is_boot":
                                    eng.model_digest == eng._boot_digest,
                                "generation": back["generation"]}
    finally:
        faults.reset()
        eng.waterfall = False
    if (rows["boot"]["fired"] != 0 or rows["swapped"]["fired"] < 1
            or rows["swapped_back"]["fired"] != rows["swapped"]["fired"]
            or not rows["swapped_back"]["digest_is_boot"]
            or rows["swapped"]["ms"] < 1e3 * OPS_CANARY_S
            or not swap["prewarmed"] or not inherited
            or wf_gen != wf_live["gen"]):
        fail(tag, f"canary_degrade: {rows}")
    log(tag, "canary: " + json.dumps(rows))
    return rows


def _scrape(port: int) -> str:
    import urllib.request
    return urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                  timeout=10).read().decode()


def _gauge(text: str, name: str):
    for ln in text.splitlines():
        if ln.startswith(name):
            return float(ln.rsplit(" ", 1)[1])
    return None


def _ops_slo(tag: str, root: str, smi: str) -> dict:
    """A replica with ``--slo``, ``--brownout-slo``, ``--admission`` and
    ``--prom-port`` under ``TPUIC_FAULTS=flood#OPS_FLOOD_RPS``; a client
    sends one-image ``high`` requests at OPS_HIGH_RPS for OPS_SLO_S while
    a scraper reads /metrics every OPS_SCRAPE_S.  The brownout gauge must
    go up (tighten) and come down (recover), every high request must be
    answered, and one scrape must hold the latency quantiles, rejects by
    cause, device memory, the waterfall's rows and the graph rows."""
    import socket

    from tpuic_torch.serve import wire
    work = tempfile.mkdtemp(prefix="serve_ops_slo_", dir=root)
    ready = os.path.join(work, "ready.json")
    err_path = os.path.join(work, "replica.err")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here,
               TPUIC_FAULTS=f"flood#{OPS_FLOOD_RPS}")
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(_replica_cmd(
            ready, "--slo", OPS_SLO, "--brownout-slo", "serve_latency_p50",
            "--brownout-tighten", str(OPS_TIGHTEN), "--admission",
            "--prom-port", "-1"), env=env, cwd=here,
            stdout=subprocess.DEVNULL, stderr=err)
    try:
        info = _await_ready(tag, ready, proc, err_path)
        start_s = time.perf_counter() - t0
        img = np.random.default_rng(9).integers(
            0, 256, (1, IMAGE, IMAGE, 3), dtype=np.uint8)
        payload = wire.encode_array(img)
        levels, stop = [], threading.Event()

        def scraper():
            while not stop.is_set():
                try:
                    text = _scrape(info["prom_port"])
                    levels.append((time.perf_counter() - t0, _gauge(
                        text, "tpuic_serve_brownout_level")))
                except OSError:
                    pass
                stop.wait(OPS_SCRAPE_S)

        scrape = threading.Thread(target=scraper, daemon=True)
        scrape.start()
        n = int(OPS_SLO_S * OPS_HIGH_RPS)
        with socket.create_connection(("127.0.0.1", info["port"]),
                                      timeout=120) as sock:
            got = {}
            reader = _Records(sock)

            def receive():
                for rec in reader.read(lambda r: len(r) >= n):
                    got[rec.get("id")] = rec

            rx = threading.Thread(target=receive, daemon=True)
            rx.start()
            t_send = time.perf_counter()
            for i in range(n):
                sock.sendall((json.dumps({"id": f"h{i}", "priority": "high",
                                          **payload}) + "\n").encode())
                delay = t_send + (i + 1) / OPS_HIGH_RPS - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            rx.join(timeout=120)
        stop.set()
        scrape.join(timeout=10)
        text = _scrape(info["prom_port"])
        proc.send_signal(__import__("signal").SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    answered = sum(1 for r in got.values() if "pred" in r)
    seq = [lv for _, lv in levels if lv is not None]
    tightened = any(b > a for a, b in zip(seq, seq[1:]))
    recovered = any(b < a for a, b in zip(seq, seq[1:]))
    need = ('tpuic_serve_latency_ms{quantile="p99"}',
            'tpuic_serve_rejected_total{cause="brownout",priority="low"}',
            "tpuic_serve_device_memory_bytes{", "tpuic_serve_device_time_ms{",
            "tpuic_serve_compile_cache_entries", "tpuic_serve_slo_burn_rate")
    missing = [r for r in need if r not in text]
    transitions = [(round(t, 3), lv) for (t, lv), prev in zip(
        levels[1:], levels) if lv != prev[1]]
    row = {"flood_rps": OPS_FLOOD_RPS, "high_sent": n,
           "high_answered": answered, "start_s": start_s,
           "level_transitions": transitions, "tightened": tightened,
           "recovered": recovered, "exit": rc,
           "requests_total": _gauge(text, "tpuic_serve_requests_total"),
           "rejected": {c: _gauge(text, f'tpuic_serve_rejected_total{{cause='
                                        f'"{c}",priority="low"}}')
                        for c in ("brownout", "queue_full")},
           "latency_ms": {q: _gauge(text, f'tpuic_serve_latency_ms{{quantile'
                                          f'="{q}"}}')
                          for q in ("p50", "p99")},
           "waterfall_rows": [ln for ln in text.splitlines()
                              if ln.startswith("tpuic_serve_device_time_ms")],
           "graph_rows": [ln for ln in text.splitlines()
                          if ln.startswith("tpuic_serve_compile_cache")],
           "card": smi}
    with open(os.path.join(work, "metrics.prom"), "w") as f:
        f.write(text)
    if (answered != n or not tightened or not recovered or missing
            or rc != 0):
        fail(tag, f"slo: {json.dumps(row)}; missing rows {missing}; "
                  f"{open(err_path).read()[-2000:]}")
    log(tag, "slo: " + json.dumps(row))
    return row


def _supervised(tag: str, work: str, chaos: str, *sup_args):
    """``python -m tpuic_torch.supervise`` over a replica, attempt 0 under
    ``chaos``; returns (process, ready path, stderr path, state dir)."""
    here = os.path.dirname(os.path.abspath(__file__))
    ready = os.path.join(work, "ready.json")
    err_path = os.path.join(work, "supervise.err")
    state = os.path.join(work, "state")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpuic_torch.supervise", "--state-dir",
             state, "--watchdog-s", str(OPS_WATCHDOG_S), "--startup-grace-s",
             str(OPS_START_S), "--poll-s", "0.2", "--backoff-s", "0.1",
             "--chaos", chaos, *sup_args, "--",
             *_replica_cmd(ready)], env=dict(os.environ, PYTHONPATH=here),
            cwd=here, stdout=subprocess.DEVNULL, stderr=err)
    return proc, ready, err_path, state


def _stop_supervised(tag: str, proc, err_path: str) -> int:
    import signal
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(tag, f"the supervisor did not stop: "
                  f"{open(err_path).read()[-2000:]}")


def _ledger_of(state: str) -> list:
    with open(os.path.join(state, "ledger.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _start_crash(tag: str, root: str):
    work = tempfile.mkdtemp(prefix="serve_ops_crash_", dir=root)
    return _supervised(tag, work, f"replica_crash@{OPS_CRASH_AT}")


def _ops_crash(tag: str, box: dict, started) -> None:
    """``replica_crash@OPS_CRASH_AT`` under the supervisor (``started``:
    ``_start_crash``'s): the replica answers OPS_CRASH_AT - 1 requests,
    dies at the next, is restarted, and its ready file reappears; the
    first answer after the restart equals the one before the crash (the
    same record, the same digest)."""
    from tpuic_torch.serve import wire
    proc, ready, err_path, state = started
    try:
        info = _await_ready(tag, ready, proc, err_path)
        img = np.random.default_rng(10).integers(
            0, 256, (1, IMAGE, IMAGE, 3), dtype=np.uint8)
        req = {"id": "x", **wire.encode_array(img)}
        before = _ask(info["port"], [dict(req, id=f"r{i}")
                                     for i in range(OPS_CRASH_AT - 1)]
                      + [{"op": "ping", "id": "ping"}])
        pong = next(r for r in before if r.get("op") == "pong")
        answer = next(r for r in before if r.get("id") == "r0")
        os.remove(ready)  # SIGKILL leaves it: it must be written again
        t_crash = time.perf_counter()
        try:
            lost = _ask(info["port"], [dict(req, id="crash")], timeout=60)
        except OSError as e:  # the connection reset by the kill
            lost = repr(e)
        info2 = _await_ready(tag, ready, proc, err_path, not_pid=info["pid"])
        restart_s = time.perf_counter() - t_crash
        after = _ask(info2["port"], [dict(req, id="r0"),
                                     {"op": "ping", "id": "ping"}])
        pong2 = next(r for r in after if r.get("op") == "pong")
        answer2 = next(r for r in after if r.get("id") == "r0")
    finally:
        rc = _stop_supervised(tag, proc, err_path)
    spawns = [r for r in _ledger_of(state) if r["event"] == "spawn"]
    exits = [r for r in _ledger_of(state) if r["event"] == "exit"]
    box["crash"] = row = {
        "answers_before": len(before) - 1, "lost": lost,
        "restart_s": restart_s, "pids": [info["pid"], info2["pid"]],
        "same_answer": answer2 == answer, "answer": answer2,
        "digest": [pong["digest"], pong2["digest"]],
        "spawns": len(spawns), "first_exit": exits[0]["returncode"]
        if exits else None, "supervisor_exit": rc}
    if (answer2 != answer or pong["digest"] != pong2["digest"]
            or len(spawns) != 2 or row["first_exit"] != -9 or rc != 0):
        fail(tag, f"crash: {json.dumps(row)}; "
                  f"{open(err_path).read()[-2000:]}")


def _start_wedge(tag: str, root: str):
    work = tempfile.mkdtemp(prefix="serve_ops_wedge_", dir=root)
    return _supervised(tag, work, f"replica_wedge@{OPS_WEDGE_AT}",
                       "--quit-wait-s", "2", "--grace-s", "3")


def _ops_wedge(tag: str, box: dict, started) -> None:
    """``replica_wedge@OPS_WEDGE_AT`` under the supervisor (``started``:
    ``_start_wedge``'s): the replica stops servicing its socket, the
    heartbeat goes stale, the watchdog sends SIGQUIT (a stack dump and a
    flight dump land in the state directory), then SIGTERM, then SIGKILL,
    and the restarted replica serves again."""
    from tpuic_torch.serve import wire
    proc, ready, err_path, state = started
    try:
        info = _await_ready(tag, ready, proc, err_path)
        img = np.random.default_rng(11).integers(
            0, 256, (1, IMAGE, IMAGE, 3), dtype=np.uint8)
        req = wire.encode_array(img)
        first = _ask(info["port"], [{"id": f"w{i}", **req}
                                    for i in range(OPS_WEDGE_AT - 1)])
        os.remove(ready)
        t_wedge = time.perf_counter()
        import socket
        wedged = socket.create_connection(("127.0.0.1", info["port"]),
                                          timeout=5)
        wedged.sendall((json.dumps({"id": "wedge", **req}) + "\n").encode())
        info2 = _await_ready(tag, ready, proc, err_path, not_pid=info["pid"])
        back_s = time.perf_counter() - t_wedge
        wedged.close()
        again = _ask(info2["port"], [{"id": "again", **req}])
    finally:
        rc = _stop_supervised(tag, proc, err_path)
    ledger = _ledger_of(state)
    hang = [r for r in ledger if r["event"] == "hang"]
    exits = [r for r in ledger if r["event"] == "exit"]
    stack = os.path.join(state, "stackdump-0.txt")
    flight = os.path.join(state, "flightdump-0.jsonl")
    stack_ok = os.path.isfile(stack) and "File" in open(stack).read()
    trailer = None
    if os.path.isfile(flight):
        with open(flight) as f:
            recs = [json.loads(ln) for ln in f]
        trailer = recs[-1] if recs else None
        kinds = sorted({r["event"] for r in recs[:-1]})
    else:
        kinds = []
    box["wedge"] = row = {
        "answered_before": sum("pred" in r for r in first),
        "back_s": back_s, "hang": hang[:1], "first_exit":
        exits[0]["returncode"] if exits else None,
        "hung": exits[0]["hung"] if exits else None,
        "stack_dump_has_frames": stack_ok, "flight_trailer": trailer,
        "flight_kinds": kinds, "answered_after": sum(
            "pred" in r for r in again), "supervisor_exit": rc}
    if (not hang or row["first_exit"] != -9 or not row["hung"]
            or not stack_ok or trailer is None
            or trailer.get("reason") != "sigquit"
            or row["answered_after"] != 1 or rc != 0):
        fail(tag, f"wedge: {json.dumps(row)}; "
                  f"{open(err_path).read()[-2000:]}")


def phase_serve_ops(root: str, seed: int, smi: str) -> dict:
    """The operated replica: ResNet-50 at 224 px, buckets 1/8/32, fp32.
    In this process an engine's measured waterfall beside its graphs
    (``waterfall``), the sync calls of its span events (``spans``) and
    ``canary_degrade`` (``canary``); then ``python -m tpuic_torch.serve``
    under a flood with brownout and Prometheus (``slo``), and two
    replicas under ``python -m tpuic_torch.supervise`` at once, one
    crashed (``crash``) and one wedged (``wedge``)."""
    from tpuic_torch.serve import InferenceEngine
    tag = "serve-ops"
    t0 = time.perf_counter()
    model = resnet50_b(seed)
    eng = InferenceEngine(model, None, image_size=IMAGE,
                          input_dtype=np.uint8, normalize=True,
                          buckets=OPS_BUCKETS)
    row = {}
    try:
        eng.warmup()
        x32 = torch.from_numpy(np.random.default_rng(4).integers(
            0, 256, (32, IMAGE, IMAGE, 3), dtype=np.uint8)).cuda()
        row["waterfall"] = _ops_waterfall(tag, eng, model, x32, smi)
        calls = eng.stats.snapshot()["device_calls"]
        reset_counts()
        row["spans"] = _ops_spans(tag, eng, root)
        launches = read_counts()["conv_bn_relu"]
        calls = eng.stats.snapshot()["device_calls"] - calls
        if launches != len(resnet50_launches(1)) * calls:
            fail(tag, f"{launches} K3 launches for {calls} device calls")
        row["canary"] = _ops_canary(tag, eng, model, resnet50_b(seed + 1))
        row["graph_cache"] = eng.graph_cache_counters()
    finally:
        eng.close()
    del eng, model
    free()
    row["launches"] = launches
    # The supervised replicas start beside the slo arm's and wait, ready
    # and beating, until it ends.
    started = {_ops_crash: _start_crash(tag, root),
               _ops_wedge: _start_wedge(tag, root)}
    box, errors = {}, []
    try:
        row["slo"] = _ops_slo(tag, root, smi)
    except SystemExit:
        for proc, _, err_path, _ in started.values():
            _stop_supervised(tag, proc, err_path)
        raise

    def arm(fn):
        try:
            fn(tag, box, started[fn])
        except SystemExit as e:  # fail() in a thread: reported below
            errors.append(f"{fn.__name__}: exit {e.code}")

    threads = [threading.Thread(target=arm, args=(fn,))
               for fn in (_ops_crash, _ops_wedge)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(tag, f"supervised arms: {errors}")
    row.update(box, card=smi, phase_s=time.perf_counter() - t0)
    log(tag, json.dumps(row))
    return row


# -- [resilience]: the trainer's failure story ------------------------------
RES_BATCH = 32            # ResNet-50 at 224 px, float32
RES_STEPS = 8             # steps an epoch: 8 x 32 train images
RES_EPOCHS = 2
RES_VAL_PER_CLASS = 8     # 64 val images: 2 val forwards of 32
RES_SIGTERM_AT = 5        # sigterm@5: the flush at epoch 0 step 5
RES_NAN = "nan_batch@10-13*4"  # epoch 1's steps 2-5, once each
RES_SKIP_THRESHOLD = 3
RES_REWARM = 4
RES_CRASH_AT = 9          # hard_crash@9: epoch 1's second step
GANG_IMAGE = 64           # [resilience]'s gang: orchestration at full width
GANG_BATCH = 8            # a rank; global batch 16
GANG_STEPS = 4            # steps an epoch
GANG_EPOCHS = 3
GANG_CRASH = "rank_crash@6#1"  # rank 1 dies at epoch 1's third step
GANG_TOL = 1e-6           # the gang's weights against an undisturbed gang
RES_TIMEOUT = 300.0
RES_LR_RTOL = 1e-6        # the logged lr against rewarm_scale's composite

# One life of ``python -m tpuic_torch.train`` (``__main__`` through runpy)
# under cuDNN's deterministic algorithms.  With ``gloo`` it joins the
# trio's group on the card first (NCCL refuses two ranks on one device).
# What the arms read of a life is public: its exit code, its log, its
# ``--metrics-jsonl`` events (``step``, ``preempt``, ``rollback``,
# ``restart``, ``kernel_launches``), its checkpoints.
_RES_LIFE = r"""
import os, runpy, sys
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
if sys.argv[1] == "gloo":
    torch.distributed.init_process_group(
        "gloo", init_method="tcp://" + os.environ["TPUIC_COORDINATOR_ADDRESS"],
        world_size=int(os.environ["TPUIC_NUM_PROCESSES"]),
        rank=int(os.environ["TPUIC_PROCESS_ID"]))
sys.argv = ["python -m tpuic_torch.train"] + sys.argv[2:]
runpy.run_module("tpuic_torch.train", run_name="__main__", alter_sys=True)
"""
# chip_smoke's names for the path's kernels -> the wrappers' names in the
# trainer's ``kernel_launches`` event.
RES_KERNELS = {"cross_entropy_fwd": "cross_entropy_fwd",
               "cross_entropy_bwd": "cross_entropy_bwd",
               "lars_update": "lars_update",
               "conv_bn_relu": "fused_conv_bn_relu"}


def _res_folder(root: str, dst: str, per_train: int, per_val: int) -> str:
    """``train``'s folder cut to ``per_train`` train and ``per_val`` val
    images a class (symbolic links)."""
    for fold, per in (("train", per_train), ("val", per_val)):
        for c in sorted(os.listdir(os.path.join(root, fold))):
            src = os.path.join(root, fold, c)
            os.makedirs(os.path.join(dst, fold, c))
            for name in sorted(os.listdir(src))[:per]:
                os.symlink(os.path.join(src, name),
                           os.path.join(dst, fold, c, name))
    return dst


def _res_argv(data: str, ckpt: str, events: str, batch: int, image: int,
              epochs: int, seed: int, *extra) -> list:
    """The slice's path as train-CLI flags: ResNet-50, LARS through K2a,
    the fused loss (K1), K3 on the val forward, float32, a warmup epoch of
    a cosine schedule, a ``latest`` every epoch, the events to
    ``events``."""
    return ["--datadir", data, "--model", "resnet50", "--resize", str(image),
            "--batchsize", str(batch), "--num-classes", str(TRAIN_CLASSES),
            "--optimizer", "lars", "--lr", "0.48", "--weight-decay", "1e-4",
            "--warmup-epochs", "1", "--epochs", str(epochs),
            "--label-smoothing", "0.1", "--no-class-weights", "--milestones",
            "--fused-loss", "--fused-optimizer", "--fused-conv-bn",
            "--dtype", "float32", "--workers", "4", "--seed", str(seed),
            "--save-period", "1", "--ckpt-dir", ckpt, "--metrics-jsonl",
            events, *extra]


def _res_cmd(backend: str, argv: list) -> list:
    return [sys.executable, "-c", _RES_LIFE, backend, *argv]


def _res_env(**extra) -> dict:
    """This process's environment for a life: the checkout on the path,
    no fault armed but ``extra``'s."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    env.pop("TPUIC_FAULTS", None)
    env.update(extra)
    return env


def _res_start(cmd: list, log_path: str, env: dict) -> tuple:
    """Start ``cmd`` in a process group of its own (a supervisor's
    children with it), its output to ``log_path``; ``(process, spawn wall
    time, log path)``."""
    t_spawn = time.time()
    with open(log_path, "w") as f:
        proc = subprocess.Popen(cmd, env=env, stdout=f,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
    return proc, t_spawn, log_path


def _res_kill_group(proc) -> None:
    """SIGKILL what is left of ``proc``'s process group."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def _res_wait(tag: str, started: tuple) -> tuple:
    """Wait for ``_res_start``'s process, then end what is left of its
    group; ``(exit code, spawn wall time, log text)``.  On a timeout the
    whole group is killed and the phase fails."""
    proc, t_spawn, log_path = started
    try:
        rc = proc.wait(timeout=RES_TIMEOUT)
    except subprocess.TimeoutExpired:
        _res_kill_group(proc)
        proc.wait()
        with open(log_path) as f:
            fail(tag, f"{log_path}: no end within {RES_TIMEOUT} s: "
                      f"{f.read()[-3000:]}")
    _res_kill_group(proc)
    with open(log_path) as f:
        text = f.read()
    return rc, t_spawn, text


def _res_run(tag: str, cmd: list, log_path: str, env: dict) -> tuple:
    """Run ``cmd`` to its end; ``(exit code, spawn wall time, log text)``."""
    return _res_wait(tag, _res_start(cmd, log_path, env))


def _res_events(path: str) -> list:
    """A life's events (a SIGKILLed life may leave a torn last line)."""
    from tpuic_torch.telemetry.events import read_jsonl
    return read_jsonl(path)


def _res_after_restart(evs: list) -> list:
    """The events of the last life in a stream that several lives
    appended to: those from its ``restart`` event on."""
    at = max((i for i, e in enumerate(evs) if e["event"] == "restart"),
             default=0)
    return evs[at:]


def _res_first_step(evs: list) -> dict:
    return next((e for e in evs if e["event"] == "step"),
                {"step": None, "t": math.nan})


def _res_weights(ckpt: str) -> dict:
    from tpuic_torch.checkpoint.manager import PAYLOAD
    return torch.load(os.path.join(ckpt, "resnet50", "latest", PAYLOAD),
                      map_location="cpu", weights_only=True)


def _res_diff(a: dict, b: dict) -> tuple:
    """``(bitwise equal, largest |difference|)`` of two payloads' model
    tensors."""
    ma, mb = a["model"], b["model"]
    if sorted(ma) != sorted(mb):
        return False, math.inf
    equal, worst = True, 0.0
    for k in ma:
        equal = equal and torch.equal(ma[k], mb[k])
        if ma[k].is_floating_point():
            worst = max(worst, float((ma[k] - mb[k]).abs().max()))
    return equal, worst


def _res_sum(evs: list) -> dict:
    """The path's kernel launches summed over the ``kernel_launches``
    events in ``evs`` (one a life that reached the end of ``fit``)."""
    done = [e for e in evs if e["event"] == "kernel_launches"]
    return {n: sum(e[k] for e in done) for n, k in RES_KERNELS.items()}


def _res_preempt_pair(tag: str, work: str, seed: int) -> dict:
    """The uninterrupted life and the one under
    ``sigterm@RES_SIGTERM_AT`` (exit 43, ``latest`` at that step), at
    once; the preempted life's events go to the file its resumed life
    appends to."""
    data = os.path.join(work, "data")
    started = {}
    for arm, ckpt, faults in (
            ("straight", "ck_a", None),
            ("preempted", "ck_b", f"sigterm@{RES_SIGTERM_AT}")):
        argv = _res_argv(data, os.path.join(work, ckpt),
                         os.path.join(work, f"{ckpt}_events.jsonl"),
                         RES_BATCH, IMAGE, RES_EPOCHS, seed)
        env = _res_env(**({"TPUIC_FAULTS": faults} if faults else {}))
        started[arm] = (_res_start(_res_cmd("none", argv),
                                   os.path.join(work, f"{arm}.log"), env),
                        ckpt, argv)
    runs = {}
    for arm, (proc, ckpt, argv) in started.items():
        rc, _, text = _res_wait(tag, proc)
        want = 43 if arm == "preempted" else 0
        if rc != want:
            fail(tag, f"preempt: the {arm} run exited {rc}, expected "
                      f"{want}: {text[-3000:]}")
        runs[arm] = dict(argv=argv, events=_res_events(
            os.path.join(work, f"{ckpt}_events.jsonl")))
    # The flush, before the resume overwrites it.
    with open(os.path.join(work, "ck_b", "resnet50",
                           "latest.manifest.json")) as f:
        manifest = json.load(f)
    runs["flushed"] = {k: manifest[k]
                       for k in ("epoch", "step_in_epoch", "step")}
    return runs


def _res_preempt(tag: str, work: str, pair: dict) -> dict:
    """The preempted life's command again, alone on the card (its resume
    seconds are its own): it resumes at epoch 0 step RES_SIGTERM_AT and
    ends on the uninterrupted run's bits, the two lives' launches summing
    to the uninterrupted run's."""
    argv = pair["preempted"]["argv"]
    rc, t_spawn, text = _res_run(tag, _res_cmd("none", argv),
                                 os.path.join(work, "resumed.log"),
                                 _res_env())
    if rc != 0:
        fail(tag, f"preempt: the resumed run exited {rc}: {text[-3000:]}")
    pre = pair["preempted"]["events"]
    resumed = _res_events(os.path.join(work, "ck_b_events.jsonl"))[len(pre):]
    flush = [e for e in pre if e["event"] == "preempt"]
    line = f"resuming epoch 0 at step {RES_SIGTERM_AT}"
    equal, worst = _res_diff(_res_weights(os.path.join(work, "ck_a")),
                             _res_weights(os.path.join(work, "ck_b")))
    launches = {"straight": _res_sum(pair["straight"]["events"]),
                "preempted": _res_sum(pre), "resumed": _res_sum(resumed)}
    summed = {n: launches["preempted"][n] + launches["resumed"][n]
              for n in RES_KERNELS}
    first = _res_first_step(resumed)
    row = {
        "flushed": pair["flushed"], "preempt_events": flush,
        "resume_line": line in text, "resumed_first_step": first["step"],
        "weights_bits_equal": equal, "weights_max_abs_diff": worst,
        "launches": launches,
        "flush_s": flush[0]["flush_s"] if flush else None,
        "resume_s": first["t"] - t_spawn}
    per_step = {"cross_entropy_fwd": RES_STEPS * RES_EPOCHS,
                "cross_entropy_bwd": RES_STEPS * RES_EPOCHS,
                "lars_update": RES_STEPS * RES_EPOCHS,
                "conv_bn_relu": 53 * 2 * RES_EPOCHS}
    if (pair["flushed"] != {"epoch": 0, "step_in_epoch": RES_SIGTERM_AT,
                            "step": RES_SIGTERM_AT}
            or len(flush) != 1 or row["flush_s"] is None
            or not row["resume_line"]
            or first["step"] != RES_SIGTERM_AT + 1 or not equal
            or summed != launches["straight"]
            or launches["straight"] != per_step):
        fail(tag, f"preempt: {json.dumps(row)}; want launches {per_step}")
    return row


def _res_rollback(tag: str, work: str, seed: int) -> dict:
    """``RES_NAN`` under ``--skip-threshold`` and ``--rewarm-steps``: the
    guard skips (the parameters stay finite, no skipped step applied),
    one rollback to epoch 1 step 0 after epoch 0's ``latest``, the logged
    lr re-warming as ``rewarm_scale`` composed onto the schedule, finite
    weights."""
    from tpuic_torch.train.__main__ import build_parser, config_from_args
    from tpuic_torch.train.optimizer import make_schedule, rewarm_scale
    data = os.path.join(work, "data")
    events = os.path.join(work, "rollback_events.jsonl")
    argv = _res_argv(data, os.path.join(work, "ck_r"), events, RES_BATCH,
                     IMAGE, RES_EPOCHS, seed, "--skip-threshold",
                     str(RES_SKIP_THRESHOLD), "--rewarm-steps",
                     str(RES_REWARM), "--log-every-steps", "1",
                     "--log-dir", os.path.join(work, "rollback_logs"))
    rc, _, text = _res_run(tag, _res_cmd("none", argv),
                           os.path.join(work, "rollback.log"),
                           _res_env(TPUIC_FAULTS=RES_NAN))
    if rc != 0:
        fail(tag, f"rollback: exit {rc}: {text[-3000:]}")
    evs = _res_events(events)
    rollbacks = [e for e in evs if e["event"] == "rollback"]
    skips = [e for e in evs if e["event"] == "skip"]
    with open(os.path.join(work, "rollback_logs", "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f if '"lr"' in ln]
    # The records after the restore: the first whose step is not past the
    # one before it.
    cut = next((i for i in range(1, len(recs))
                if recs[i]["step"] <= recs[i - 1]["step"]), None)
    ramp = [r["lr"] for r in recs[cut:cut + RES_REWARM]] if cut else []
    parser = build_parser()
    cfg = config_from_args(parser.parse_args(argv), parser)
    base = make_schedule(cfg.optim, RES_STEPS, RES_EPOCHS,
                         global_batch=RES_BATCH)
    restored = RES_STEPS  # epoch 0's latest: 8 applied steps
    scale = rewarm_scale(restored, RES_REWARM)
    want = [float(base(torch.tensor(t)) * scale(torch.tensor(t)))
            for t in range(restored, restored + RES_REWARM)]
    rel = [abs(a - b) / abs(b) for a, b in zip(ramp, want)] or [math.inf]
    final = _res_weights(os.path.join(work, "ck_r"))["model"]
    finite = all(bool(torch.isfinite(t).all()) for t in final.values()
                 if t.is_floating_point())
    launches = _res_sum(evs)
    # Epoch 1 ran 6 steps before the rollback (2 clean, then the 4
    # poisoned ones, K2a launched and gated off), then all RES_STEPS again.
    run_steps = RES_STEPS * RES_EPOCHS + 6
    row = {"rollback_events": rollbacks, "skip_events": len(skips),
           "lr_ramp": ramp, "lr_want": want, "lr_rel_diff": max(rel),
           "finite": finite, "launches": launches}
    if (len(rollbacks) != 1 or rollbacks[0]["epoch"] != 1
            or rollbacks[0]["step_in_epoch"] != 0
            or rollbacks[0]["params_finite"] is not True
            or rollbacks[0]["applied_steps"] != RES_STEPS + 2
            or launches["lars_update"] != run_steps
            or max(rel) > RES_LR_RTOL or not finite):
        fail(tag, f"rollback: {json.dumps(row)}; {text[-2000:]}")
    return row


def _res_crash(tag: str, work: str, seed: int) -> dict:
    """``python -m tpuic_torch.supervise --chaos hard_crash@RES_CRASH_AT``
    over the train command, alone on the card (its downtime is its own):
    one restart, resumed from the last commit (epoch 0's end), exit 0,
    the ``restart`` event with its downtime."""
    data = os.path.join(work, "data")
    events = os.path.join(work, "crash_events.jsonl")
    state = os.path.join(work, "crash_state")
    # Commits before training goes on: the crash lands two steps after
    # epoch 0's save, which must be the last commit.
    argv = _res_argv(data, os.path.join(work, "ck_c"), events, RES_BATCH,
                     IMAGE, RES_EPOCHS, seed, "--no-async-checkpoint")
    cmd = [sys.executable, "-m", "tpuic_torch.supervise", "--state-dir",
           state, "--poll-s", "0.2", "--backoff-s", "0.1", "--chaos",
           f"hard_crash@{RES_CRASH_AT}", "--", *_res_cmd("none", argv)]
    rc, _, text = _res_run(tag, cmd, os.path.join(work, "crash.log"),
                           _res_env())
    ledger = _ledger_of(state)
    spawns = [r for r in ledger if r["event"] == "spawn"]
    exits = [r["returncode"] for r in ledger if r["event"] == "exit"]
    evs = _res_events(events)
    restarts = [e for e in evs if e["event"] == "restart"]
    second = _res_after_restart(evs)
    first = _res_first_step(second)
    equal, _ = _res_diff(_res_weights(os.path.join(work, "ck_a")),
                         _res_weights(os.path.join(work, "ck_c")))
    row = {"supervisor_exit": rc, "spawns": len(spawns), "exits": exits,
           "restart_events": restarts, "first_step": first["step"],
           "weights_bits_equal_uninterrupted": equal,
           "launches_second_life": _res_sum(second)}
    if (rc != 0 or len(spawns) != 2 or exits[:1] != [-9]
            or len(restarts) != 1 or restarts[0]["downtime_s"] <= 0
            or [restarts[0]["epoch"], restarts[0]["step_in_epoch"]] != [1, 0]
            or first["step"] != RES_STEPS + 1):
        fail(tag, f"crash: {json.dumps(row)}; {text[-3000:]}")
    return row


def _res_gang(tag: str, work: str, seed: int) -> dict:
    """Two gloo ranks on the card under ``supervise --gang 2``: an
    undisturbed gang beside one under ``GANG_CRASH`` (rank 1 SIGKILLed,
    the gang torn down and restarted with ``TPUIC_RESUME_STEP``), whose
    weights equal the undisturbed gang's within GANG_TOL."""
    import socket
    from tpuic_torch.data.synthetic import make_synthetic_imagefolder
    from tpuic_torch.telemetry.fleet import rank_stream_path
    classes = tuple(f"class{i}" for i in range(TRAIN_CLASSES))
    data = os.path.join(work, "gang_data")
    per = GANG_BATCH * 2 * GANG_STEPS // TRAIN_CLASSES
    make_synthetic_imagefolder(data, classes, per_class=per,
                               size=GANG_IMAGE, folds=("train",), seed=seed)
    make_synthetic_imagefolder(data, classes, per_class=2, size=GANG_IMAGE,
                               folds=("val",), seed=seed + 1)
    # The two gangs run at once, on ports of their own.
    started, ports, socks = {}, [], []
    for _ in range(2):
        socks.append(socket.socket())
        socks[-1].bind(("localhost", 0))
        ports.append(socks[-1].getsockname()[1])
    for sock in socks:
        sock.close()
    for (arm, chaos), port in zip((("undisturbed", None),
                                   ("disturbed", GANG_CRASH)), ports):
        ckpt = os.path.join(work, f"ck_{arm}")
        state = os.path.join(work, f"gang_{arm}")
        argv = _res_argv(data, ckpt, os.path.join(work, f"{arm}.jsonl"),
                         GANG_BATCH, GANG_IMAGE, GANG_EPOCHS, seed,
                         "--workers", "2")
        cmd = [sys.executable, "-m", "tpuic_torch.supervise", "--state-dir",
               state, "--gang", "2", "--coordinator", f"localhost:{port}",
               "--gang-ckpt", os.path.join(ckpt, "resnet50"), "--poll-s",
               "0.05", "--backoff-s", "0.1", "--grace-s", "20",
               *(("--chaos", chaos) if chaos else ()), "--",
               *_res_cmd("gloo", argv)]
        started[arm] = (_res_start(cmd, os.path.join(work, f"{arm}.log"),
                                   _res_env()), state)
    gangs = {}
    for arm, (proc, state) in started.items():
        rc, t_spawn, text = _res_wait(tag, proc)
        ranks = [_res_events(rank_stream_path(
            os.path.join(work, f"{arm}.jsonl"), r)) for r in (0, 1)]
        gangs[arm] = dict(rc=rc, text=text, ledger=_ledger_of(state),
                          ranks=ranks, wall_s=time.time() - t_spawn)
    dis = gangs["disturbed"]
    ledger = dis["ledger"]
    teardown = [r for r in ledger if r["event"] == "teardown"]
    exits = [(r["attempt"], r["rank"], r["returncode"]) for r in ledger
             if r["event"] == "exit"]
    resume = [r for r in ledger if r["event"] == "gang_resume"]
    restarted = [_res_after_restart(evs) for evs in dis["ranks"]]
    restart_evs = [evs[0] if evs and evs[0]["event"] == "restart" else None
                   for evs in restarted]
    equal, worst = _res_diff(
        _res_weights(os.path.join(work, "ck_undisturbed")),
        _res_weights(os.path.join(work, "ck_disturbed")))
    logged = "tearing down gang" in dis["text"]
    row = {"exit": {a: g["rc"] for a, g in gangs.items()},
           "wall_s": {a: g["wall_s"] for a, g in gangs.items()},
           "teardown": teardown, "teardown_logged": logged, "exits": exits,
           "gang_resume": resume, "restart_events": restart_evs,
           "weights_bits_equal": equal, "weights_max_abs_diff": worst,
           "launches": {
               "undisturbed": [_res_sum(evs)
                               for evs in gangs["undisturbed"]["ranks"]],
               "disturbed_restart": [_res_sum(evs) for evs in restarted]}}
    if (any(g["rc"] != 0 for g in gangs.values()) or not teardown
            or teardown[0]["rank"] != 1 or not logged
            or (0, 1, -9) not in exits
            or any(e is None or e["resume_step"] is None
                   for e in restart_evs)
            or worst > GANG_TOL):
        fail(tag, f"gang: {json.dumps(row)}; {dis['text'][-3000:]}")
    return row


def phase_resilience(root: str, seed: int, smi: str) -> dict:
    """The trainer's failure story on the card, through the train CLI and
    ``python -m tpuic_torch.supervise``: ``preempt``, ``rollback``,
    ``crash`` and ``gang`` (module docstring).  Every life runs cuDNN's
    deterministic algorithms, so a resumed run is held bit for bit.  The
    lives whose seconds are read run alone: the preempted command's
    resumed life (resume seconds), then the crash arm (downtime); the
    rest run at once before them (the time limit)."""
    tag = "resilience"
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="resilience_", dir=root)
    _res_folder(root, os.path.join(work, "data"),
                RES_BATCH * RES_STEPS // TRAIN_CLASSES, RES_VAL_PER_CLASS)
    row, errors, parts = {}, [], {}

    def arm(name, fn, *args):
        t = time.perf_counter()
        try:
            parts[name] = fn(tag, work, *args)
        except SystemExit as e:  # fail() in a thread: reported below
            errors.append(f"{name}: exit {e.code}")
            return
        except Exception as e:
            errors.append(f"{name}: {e!r}")
            return
        parts[name + "_s"] = time.perf_counter() - t

    def report(name):
        row[name] = dict(parts[name], arm_s=parts[name + "_s"])
        log(tag, f"{name}: {json.dumps(row[name])}")

    threads = [threading.Thread(target=arm, args=item) for item in (
        ("pair", _res_preempt_pair, seed), ("rollback", _res_rollback, seed),
        ("gang", _res_gang, seed))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(tag, f"arms: {errors}")
    report("rollback")
    report("gang")
    arm("preempt", _res_preempt, parts["pair"])
    arm("crash", _res_crash, seed)
    if errors:
        fail(tag, f"arms: {errors}")
    parts["preempt_s"] += parts["pair_s"]
    report("preempt")
    report("crash")
    row.update(card=smi, phase_s=time.perf_counter() - t0)
    log(tag, json.dumps({k: row[k] for k in ("card", "phase_s")}))
    return row



# -- [convert]: the converter's CLI on the card ------------------------------
CONVERT_BATCH = 8        # --verify's batch of seeded random images
CONVERT_CALIB = 16       # images whose batch statistics become the BN stats
CONVERT_TOL = 1e-3       # the CLI's --tol: max |logits delta|


def _reference_checkpoint(arch: str, path: str, seed: int) -> float:
    """A reference-layout checkpoint (``{'epoch', 'best_score',
    'state_dict'}``, DDP's ``module.encoder.`` keys) of ``torch_ref``'s
    bare replica of ``arch`` at IMAGE px and 1000 classes with the MLP
    head, drawn from ``seed``; the BN running statistics are a seeded
    batch's own (as a trained network's match its data), so the eval
    forward stays at the scale of a real one.  Returns the replica's max
    |logit| on ``--verify``'s own input, under TF32 off."""
    from tpuic_torch.checkpoint.torch_ref import build_reference_model
    from tpuic_torch.kernels import no_tf32
    torch.manual_seed(seed)
    m = build_reference_model(arch, 1000, mlp_head=True,
                              image_size=IMAGE).cuda()
    bns = [b for b in m.modules() if isinstance(b, torch.nn.BatchNorm2d)]
    if bns:
        for b in bns:
            b.momentum = None  # the cumulative average: this batch's
            b.reset_running_stats()
        x = torch.randn(CONVERT_CALIB, 3, IMAGE, IMAGE,
                        generator=torch.Generator().manual_seed(seed + 1))
        m.train()
        with torch.no_grad():
            m(x.cuda())
    m.eval()
    torch.save({"epoch": 0, "best_score": 0.0,
                "state_dict": {"module.encoder." + k: v.cpu()
                               for k, v in m.state_dict().items()}}, path)
    x = np.random.default_rng(0).normal(
        size=(CONVERT_BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    with torch.no_grad(), no_tf32():
        logits = m(torch.from_numpy(x).cuda().permute(0, 3, 1, 2))
    del m
    free()
    return float(logits.abs().max())


def _convert_cli(tag: str, argv: list) -> tuple:
    """``python -m tpuic_torch.checkpoint.torch_convert`` in this process
    (``main(argv)``): its exit code, its JSON records, its seconds and the
    kernels' launches, counted from 0 just before it."""
    import io

    from tpuic_torch.checkpoint import torch_convert
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = torch_convert.main(argv)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    recs = [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.startswith("{")]
    for rec in recs:
        log(tag, json.dumps(rec))
    return rc, recs, seconds, counts


def _verified(tag: str, name: str, rc: int, rec: dict, counts: dict,
              want: dict) -> None:
    """``--verify``'s record must say ok: exit 0, every leaf mapped, no
    replica key missing or unexpected, the delta under CONVERT_TOL; and
    the port's forward must have launched ``want``."""
    mapped = [rec[k].split("/") for k in ("params_mapped",
                                          "batch_stats_mapped")]
    if (rc != 0 or rec.get("verify") != "ok"
            or not rec["max_logits_delta"] < CONVERT_TOL
            or any(a != b for a, b in mapped)
            or rec["replica_missing_keys"] or rec["replica_unexpected_keys"]):
        fail(tag, f"{name}: exit {rc}, record {rec}")
    if counts != want:
        fail(tag, f"{name}: launches {counts}, expected {want}")


def phase_convert(root: str, seed: int, ckpt_dir: str, smi: str) -> dict:
    """The converter's CLI on the card, in this process through
    ``main(argv)``: ``--verify`` of a reference-layout ResNet-50 and
    ViT-B/16 checkpoint made here from ``torch_ref``'s replicas (seeded,
    224 px, 1000 classes, the reference's MLP head) holds the port's
    serving forward (K3 on every conv of the ResNet, K4f in every ViT
    block) against the replica's (cuDNN and cuBLAS with TF32 off): max
    |logits delta| under CONVERT_TOL and every leaf mapped.  Then
    ``--export-torch`` writes ``[ckpt]``'s ResNet-50 ``best`` out in the
    reference layout, composed with ``--verify`` of the file it wrote."""
    tag = "convert"
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="convert_", dir=root)
    row = {}
    for arch, want in (("resnet50", expect(conv_bn_relu=len(
            resnet50_launches(1)))), (VIT_MODEL, expect(
                flash_attention_fwd=VIT_LAYERS))):
        path = os.path.join(work, f"{arch}.pth")
        scale = _reference_checkpoint(arch, path, seed)
        rc, recs, seconds, counts = _convert_cli(tag, [
            path, "--verify", "--image-size", str(IMAGE), "--batch",
            str(CONVERT_BATCH)])
        info, rec = recs
        _verified(tag, arch, rc, rec, counts, want)
        row[arch] = {**rec, "arch": info["arch"],
                     "param_leaves": info["param_leaves"],
                     "batch_stat_leaves": info["batch_stat_leaves"],
                     "replica_logits_abs_max": scale,
                     "launches": {k: v for k, v in counts.items() if v},
                     "seconds": seconds}
        free()
    out = os.path.join(work, "exported.pth")
    rc, recs, seconds, counts = _convert_cli(tag, [
        os.path.join(ckpt_dir, "resnet50", "best"), "--export-torch", out,
        "--verify", "--image-size", str(IMAGE), "--batch",
        str(CONVERT_BATCH)])
    exported, info, rec = recs
    _verified(tag, "export", rc, rec, counts,
              expect(conv_bn_relu=len(resnet50_launches(1))))
    if exported["keys"] <= 0 or info["arch"] != "resnet50":
        fail(tag, f"export: {exported}, {info}")
    row["export"] = {**rec, **exported, "arch": info["arch"],
                     "launches": {k: v for k, v in counts.items() if v},
                     "seconds": seconds}
    row.update(card=smi, phase_s=time.perf_counter() - t0)
    log(tag, json.dumps(row))
    free()
    return row


# -- [fleet]: the front tier over two port replicas --------------------------
FLEET_BUCKETS = "1,8,32"
FLEET_POOL = 32          # distinct one-image requests the waves cycle through
FLEET_PROBE = 256        # requests of the burst-capacity probe
FLEET_LOAD = 0.25        # the waves' Poisson rate: this share of the probe's
FLEET_WAVE_S = 2.0       # seconds of traffic in a steady wave
FLEET_SOAK_S = 4.0       # seconds of the wave the SIGKILL lands in
FLEET_KILL_AT = 1.5      # seconds into it
FLEET_ARM_S = 2.0        # seconds of a wave under a rollout (back to back)
FLEET_START_S = 240.0    # a replica's start, its warmup included
FLEET_RESULT_S = 120.0   # a client's wait for one answer: past it, a timeout
FLEET_TOL = SERVE_TOL    # served probability against a direct forward
# The rollouts' canary SLO: p99 <= max(FLEET_SLO_FLOOR_MS, FLEET_SLO_X x
# the steady wave's p99 through the router) at a 0.9 target, the floor
# tpuic's rollout soak takes.  At 100 ms and 4x a slow host's stalls
# burned a healthy canary's budget from 2 of its first 9 samples and
# rolled it back.
FLEET_SLO_FLOOR_MS = 250.0
FLEET_SLO_X = 10.0
FLEET_DEGRADE_X = 3.0    # canary_degrade's sleep a batch, x the threshold


class _DirectClient:
    """One replica over one socket, no router: the loadgen endpoint
    protocol (``submit(line) -> Future``, ``stats``), for the waves that
    measure one replica alone."""

    def __init__(self, port: int) -> None:
        import socket
        from concurrent.futures import Future

        from tpuic_torch.serve.router import RouterStats
        self._future = Future
        self.stats = RouterStats()
        self.sock = socket.create_connection(("127.0.0.1", port))
        self._lock = threading.Lock()
        self._pending = {}
        self._n = 0
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def submit(self, line: dict, **kw):
        fut = self._future()
        with self._lock:
            self._n += 1
            rid = f"d{self._n}"
            self._pending[rid] = (fut, time.perf_counter())
        self.stats.record_offered()
        self.sock.sendall((json.dumps({**line, "id": rid}) + "\n").encode())
        return fut

    def _read(self) -> None:
        from tpuic_torch.serve import wire
        recs = _Records(self.sock)
        while True:
            try:
                got = recs.read(lambda out: len(out) >= 1)
            except OSError:
                return
            if not got:
                return
            for rec in got:
                with self._lock:
                    fut, t = self._pending.pop(rec.get("id"), (None, 0.0))
                if fut is None:
                    continue
                if "error" in rec:
                    err = wire.rebuild_error(rec)
                    self.stats.record_reject(getattr(err, "cause", "?"),
                                             "normal")
                    fut.set_exception(err)
                else:
                    self.stats.record_resolved(time.perf_counter() - t)
                    fut.set_result(rec)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _fleet_wave(tag: str, endpoint, lines: list, rate: float, n: int,
                seed: int, strict: bool = True) -> dict:
    """A Poisson wave of ``n`` one-image requests at ``rate`` a second
    through ``loadgen.run_stream``: zero client timeouts (a request not
    answered within FLEET_RESULT_S fails the phase), an exact ledger
    (resolved + typed-rejected == offered, no untyped error, no
    duplicate, every outcome hook fired).  With ``strict`` false (a wave
    off the main thread, where ``fail`` cannot end the run) a broken
    wave returns ``{"problem": ...}`` for its caller to fail on."""
    from tpuic_torch.serve.loadgen import run_stream
    rng = np.random.default_rng(seed)
    offsets = np.cumsum(rng.exponential(1.0 / rate, size=n))
    items = [lines[i % len(lines)] for i in range(n)]
    done, retried = [], []
    try:
        wall, arrival, snap = run_stream(
            endpoint, items, offsets_s=offsets,
            result_timeout_s=FLEET_RESULT_S,
            on_done=lambda i, ok, s: done.append((i, ok)),
            on_retry=lambda i, k: retried.append((i, k)))
    except TimeoutError:
        problem = f"a client timed out (>{FLEET_RESULT_S} s)"
    else:
        problem = None
        if (snap["requests"] + snap["rejected"] != n or snap.get("errors")
                or snap.get("duplicates") or snap.get("wire_errors")
                or len(done) != n):
            problem = (f"ledger: {n} offered, {len(done)} outcomes, "
                       f"snapshot {json.dumps(snap)[:800]}")
    if problem is not None:
        if strict:
            fail(tag, problem)
        return {"problem": problem}
    return {"offered": n, "rate": rate, "wall_s": wall,
            "arrival_s": arrival, "resolved": snap["requests"],
            "rejected_by": snap.get("rejected_by", {}),
            "latency_ms": snap.get("latency_ms"),
            "retries": snap.get("retries", 0),
            "failovers": snap.get("failovers", 0),
            "failover_requeued": snap.get("failover_requeued", 0),
            "replayed_items": len(retried)}


def _fleet_scrape(router) -> dict:
    """Each replica's graph-capture counters from its own /metrics."""
    out = {}
    for rep in router.replicas:
        try:
            text = _scrape(rep.prom_port)
        except OSError:
            out[rep.name] = None
            continue
        out[rep.name] = {k: _gauge(text, f"tpuic_serve_{k}") for k in (
            "compile_cache_misses_total", "compile_cache_prewarmed_total",
            "device_calls_total")}
    return out


def _fleet_flat(tag: str, arm: str, before: dict, after: dict) -> dict:
    """The graph captures of each replica across a steady wave: none."""
    moved = {k: (before[k]["compile_cache_misses_total"],
                 after[k]["compile_cache_misses_total"])
             for k in before if before[k] and after.get(k)}
    if any(a != b for a, b in moved.values()) or not moved:
        fail(tag, f"{arm}: graph captures moved in a steady wave: {moved}")
    return {k: v[1] for k, v in moved.items()}


def _fleet_pongs(router) -> dict:
    """Each replica's own pong (a ping on a connection of ours): its pid,
    digest, generation and kernel launches in this life."""
    out = {}
    for rep in router.replicas:
        recs = _ask(rep.addr[1], [{"op": "ping", "id": "k"}], timeout=30)
        out[rep.name] = {k: recs[0].get(k) for k in (
            "pid", "digest", "generation", "kernel_launches")}
    return out


def _fleet_rollout(tag: str, router, candidate: dict, incumbent: dict,
                   slo: str, canary: str, lines: list, rate: float,
                   seed: int):
    """One canary rollout under live traffic: Poisson waves of
    FLEET_ARM_S seconds back to back until the rollout's verdict, each
    wave's ledger exact.  Returns the rollout, its verdict, the waves'
    sums, the ``rollout`` events it wrote and the graph captures it
    caused by replica (its swaps' standby captures)."""
    from tpuic_torch.serve.rollout import CanaryRollout
    before = _fleet_scrape(router)
    n_events = len(_jsonl(router.ledger_path))
    ro = CanaryRollout(router, candidate, incumbent, objective=slo,
                       stages=(0.5, 1.0), hold_s=1.0, min_samples=15,
                       burn_rollback=2.0, rollback_after=2, poll_s=0.1,
                       stage_timeout_s=60.0, swap_timeout_s=120.0,
                       canary=canary)
    stop = threading.Event()
    waves, problems = [], []

    def traffic():
        k = 0
        try:
            while not stop.is_set():
                w = _fleet_wave(tag, router, lines, rate,
                                int(rate * FLEET_ARM_S), seed + k,
                                strict=False)
                if "problem" in w:
                    problems.append(w["problem"])
                    return
                waves.append(w)
                k += 1
        except Exception as e:  # noqa: BLE001 — failed on the main thread
            problems.append(f"{type(e).__name__}: {e}")

    t = threading.Thread(target=traffic)
    t.start()
    try:
        verdict = ro.run()
    finally:
        stop.set()
        t.join()
    if problems or not waves:
        fail(tag, f"the traffic under the rollout to {candidate}: "
                  f"{problems or 'no wave ran'}")
    after = _fleet_scrape(router)
    events = [e for e in _jsonl(router.ledger_path)[n_events:]
              if e.get("event") == "rollout"]
    captures = {k: after[k]["compile_cache_misses_total"]
                - before[k]["compile_cache_misses_total"]
                for k in before if before[k] and after.get(k)}
    wave = {"waves": len(waves),
            **{k: sum(w[k] for w in waves) for k in (
                "offered", "resolved", "retries", "failovers")},
            "rejected_by": [w["rejected_by"] for w in waves],
            "latency_ms": [w["latency_ms"] for w in waves]}
    return ro, verdict, wave, events, captures


def _wait_until(cond, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _fleet_start(root: str) -> dict:
    """``[fleet]``'s router over two ResNet-50 replicas, started on a
    thread of its own: the replicas' process starts and warmups overlap
    ``[convert]``, which runs in this thread meanwhile.  The router is
    closed at exit if ``phase_fleet`` never ran."""
    import atexit

    from tpuic_torch.serve.router import Router
    work = tempfile.mkdtemp(prefix="fleet_", dir=root)
    cmd = [sys.executable, "-m", "tpuic_torch.serve", "--synthetic-init",
           "--model", "resnet50", "--num-classes", "1000", "--resize",
           str(IMAGE), "--buckets", FLEET_BUCKETS, "--admission",
           "--listen", "127.0.0.1:0", "--prom-port", "-1"]
    os.environ.pop("TPUIC_FAULTS", None)
    router = Router(replica_cmd=cmd, n_replicas=2,
                    state_dir=os.path.join(work, "router"),
                    breaker_threshold=3, breaker_cooldown_s=0.5,
                    ping_interval_s=0.1, ping_timeout_s=3.0,
                    wedge_timeout_s=60.0, spawn_timeout_s=FLEET_START_S,
                    respawn_backoff_s=0.2, grace_s=15.0,
                    drain_timeout_s=30.0)
    box = {"router": router, "work": work, "cmd": cmd}

    def start():
        t0 = time.perf_counter()
        try:
            router.start(timeout_s=FLEET_START_S)
        except RuntimeError as e:
            box["error"] = str(e)
        box["start_s"] = time.perf_counter() - t0

    box["thread"] = threading.Thread(target=start, daemon=True)
    box["thread"].start()
    atexit.register(lambda: router.close(drain=False))
    return box


def phase_fleet(root: str, seed: int, ckpt_dir: str, smi: str,
                started: dict) -> dict:
    """The front tier on the card: two ``python -m tpuic_torch.serve
    --synthetic-init --listen`` ResNet-50 replicas (224 px, buckets
    1/8/32, K3 on every conv of their graph-replayed forwards) share the
    H100 behind the port's router and its HTTP front end, both in this
    process.  Waves are Poisson through ``loadgen.run_stream`` at
    FLEET_LOAD of one replica's burst capacity, measured first.  A steady
    wave at one replica alone and through the router; a wave in which r1
    is SIGKILLed while it holds requests (failover, zero client timeouts,
    exact ledger, answers equal to a direct forward), its respawn and a
    wave that closes its breaker (open -> half_open -> closed in the
    router ledger; the corrupt arm below runs on r0 while r1 respawns); then three canary rollouts under waves: r1, respawned
    with ``canary_degrade`` armed, rolls a seeded candidate back on
    ``slo_burn``; a byte-flipped checkpoint is refused ``swap_corrupt``
    before any stage; the seeded candidate promotes on r0 over two stages
    and both pongs carry its digest.  Each replica's graph captures stay
    flat across each steady wave; a rollout's are its swaps'."""
    import shutil
    import urllib.error
    import urllib.request

    from tpuic_torch.checkpoint.convert import init_params
    from tpuic_torch.checkpoint.manager import PAYLOAD
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.predict import serving_model_config
    from tpuic_torch.serve import wire
    from tpuic_torch.serve.engine import make_forward
    from tpuic_torch.serve.http import RouterHTTPServer
    from tpuic_torch.serve.loadgen import probe_batched_rps
    from tpuic_torch.telemetry.prom import PromServer, router_exposition
    tag = "fleet"
    t0 = time.perf_counter()
    router, work = started["router"], started["work"]
    rng = np.random.default_rng(seed + 7)
    pool = rng.integers(0, 256, (FLEET_POOL, IMAGE, IMAGE, 3), np.uint8)
    lines = [wire.encode_array(pool[i:i + 1]) for i in range(FLEET_POOL)]
    # The direct forward the answers are held against: the replicas'
    # seeded init (seed 0 of the port's flax-default draw).
    model = init_params(create_model_from_config(
        serving_model_config("resnet50", 1000), image_size=IMAGE), 0)
    want, _ = make_forward(model.eval(), normalize=True)(
        torch.from_numpy(pool).cuda())
    want = want.cpu().numpy()
    del model
    free()
    errs = []

    def check_answer(i, rec):
        if "pred" not in rec:
            return
        p = want[i]
        err = abs(float(rec["prob"]) - float(p[int(rec["pred"])]))
        top = float(p.max()) - float(p[int(rec["pred"])])
        errs.append(err)
        if err > FLEET_TOL or top > FLEET_TOL:
            fail(tag, f"request {i}: served {rec}, direct top "
                      f"{int(p.argmax())} {p.max()}, error {err}")

    slot = {id(line): j for j, line in enumerate(lines)}

    def answers(endpoint, **kw):
        """A wave whose answers are held against the direct forward."""
        futs = []
        orig = endpoint.submit

        def submit(line, **k):
            fut = orig(line, **k)
            futs.append((slot[id(line)], fut))
            return fut
        endpoint.submit = submit
        try:
            row = _fleet_wave(tag, endpoint, lines, **kw)
        finally:
            endpoint.submit = orig
        for j, fut in futs:
            if fut.exception() is None:
                check_answer(j, fut.result())
        return row

    row = {"replica_cmd": " ".join(started["cmd"][1:])}
    http = None
    try:
        t = time.perf_counter()
        started["thread"].join(timeout=FLEET_START_S)
        row["start_s"] = started.get("start_s")
        row["start_wait_s"] = time.perf_counter() - t
        if started.get("error") or [r.state for r in router.replicas] \
                != ["up", "up"]:
            fail(tag, f"{started.get('error')}; replicas "
                      f"{router.snapshot()['replicas']}")
        boot = router.fleet_digest
        pongs0 = _fleet_pongs(router)
        if any(p["digest"] != boot for p in pongs0.values()):
            fail(tag, f"boot pongs {pongs0}, fleet digest {boot}")
        # One replica alone: its burst capacity (the load's anchor), then
        # a steady wave at the fleet's rate.
        direct = _DirectClient(router.replicas[0].addr[1])
        try:
            capacity = probe_batched_rps(direct, lines * (
                FLEET_PROBE // FLEET_POOL), probe_n=FLEET_PROBE)
            rate = FLEET_LOAD * capacity
            n_wave = int(rate * FLEET_WAVE_S)
            cap0 = _fleet_scrape(router)
            row["one_replica_alone"] = answers(direct, rate=rate,
                                               n=n_wave, seed=seed)
        finally:
            direct.close()
        row["anchor"] = {"burst_capacity_rps": capacity,
                         "load": FLEET_LOAD, "rate_rps": rate,
                         "probe": "loadgen.probe_batched_rps on r0 alone"}
        row["through_router"] = answers(router, rate=rate, n=n_wave,
                                        seed=seed + 1)
        row["graph_captures_steady"] = _fleet_flat(
            tag, "steady waves", cap0, _fleet_scrape(router))
        # The SIGKILL: r1 dies with requests in flight; its respawn boots
        # with canary_degrade armed (the degrade arm's canary).
        p99 = row["through_router"]["latency_ms"]["p99"]
        thresh_ms = max(FLEET_SLO_FLOOR_MS, FLEET_SLO_X * p99)
        slo = f"serve_latency:p99<={thresh_ms:.0f}ms@0.9"
        degrade_s = FLEET_DEGRADE_X * thresh_ms / 1000.0
        victim = router.replicas[1]
        n_events = len(_jsonl(router.ledger_path))
        killed = {}

        def kill():
            time.sleep(FLEET_KILL_AT)
            os.environ["TPUIC_FAULTS"] = f"canary_degrade#{degrade_s:.3f}"
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                # This life's launches at its last pong before the kill.
                life = _ask(victim.addr[1], [{"op": "ping", "id": "k"}],
                            timeout=30)[0]
                # The in-flight count and the SIGKILL in one step: the
                # router takes its lock to resolve or fail over a request.
                with router._lock:
                    n = len(victim.inflight)
                    if n:
                        os.kill(victim.child.pid, signal.SIGKILL)
                        killed.update(
                            inflight=n, pid=victim.child.pid,
                            kernel_launches_at_last_pong=life.get(
                                "kernel_launches"),
                            t=time.monotonic(), wall=time.time())
                        return
                time.sleep(0.01)

        killer = threading.Thread(target=kill)
        killer.start()
        soak = answers(router, rate=rate, n=int(rate * FLEET_SOAK_S),
                       seed=seed + 2)
        killer.join()
        if "t" not in killed or killed["inflight"] < 1:
            fail(tag, f"r1 never held a request in flight to kill: {killed}")
        if soak["failovers"] < 1 or soak["replayed_items"] < 1:
            fail(tag, f"the SIGKILL failed nothing over: {soak}")
        # The replicas' boot weights, and two seeded candidates: a rolled
        # back candidate's digest stays disallowed for the fleet's life.
        incumbent = {"synthetic_seed": 0}
        degraded, candidate = {"synthetic_seed": 1}, {"synthetic_seed": 2}
        # Corrupt, on r0 while r1 respawns: [ckpt]'s checkpoint with a
        # byte of best flipped.
        bad = os.path.join(work, "corrupt")
        shutil.copytree(ckpt_dir, bad)
        _flip_byte(os.path.join(bad, "resnet50", "best", PAYLOAD))
        ro, v, wave, ev, caps = _fleet_rollout(
            tag, router, {"ckpt_dir": bad, "track": "best"}, incumbent, slo,
            "r0", lines, rate, seed + 50)
        stages = [e for e in ev if e.get("action") == "stage"]
        if (v.get("verdict") != "refused" or v.get("cause")
                != "swap_corrupt" or stages
                or router.fleet_digest != boot
                or router.snapshot()["traffic_split"] is not None):
            fail(tag, f"corrupt arm: {v}, {len(stages)} stages")
        row["corrupt"] = {"verdict": v, "wave": wave,
                          "graph_captures_by_swaps": caps,
                          "events": [e.get("action") for e in ev]}
        if not _wait_until(lambda: victim.spawns >= 2
                           and victim.state == "up", FLEET_START_S):
            fail(tag, f"r1 never came back: {victim.health()}")
        os.environ.pop("TPUIC_FAULTS", None)
        cap1 = _fleet_scrape(router)
        rejoin = answers(router, rate=rate, n=n_wave, seed=seed + 3)
        row["graph_captures_rejoin"] = _fleet_flat(
            tag, "rejoin wave", cap1, _fleet_scrape(router))
        events = _jsonl(router.ledger_path)[n_events:]
        failover = [e for e in events if e.get("event") == "router_failover"
                    and e.get("replica") == victim.name]
        breaker = [e["new"] for e in events
                   if e.get("event") == "router_breaker"
                   and e.get("replica") == victim.name]
        order = [s for s in breaker if s in ("open", "half_open", "closed")]
        seq = ["open", "half_open", "closed"]
        it = iter(order)
        back = [e for e in events if e.get("event") == "router_replica"
                and e.get("replica") == victim.name
                and e.get("action") == "connect"]
        if not failover or not back or not all(s in it for s in seq):
            fail(tag, f"r1's breaker went {breaker}, failover events "
                      f"{failover}, reconnects {back}: expected open -> "
                      "half_open -> closed")
        # The kill to the router's reconnect to the respawned life.
        downtime = back[0]["t"] - killed["wall"]
        row["soak"] = {**soak, "killed": {k: v for k, v in killed.items()
                                          if k not in ("t", "wall")},
                       "failover_detect_s": failover[0]["t"]
                       - killed["wall"],
                       "respawn_downtime_s": downtime,
                       "breaker": breaker, "rejoin": rejoin}
        log(tag, "soak: " + json.dumps(row["soak"]))
        # Degrade: r1's respawned life serves its candidate slowly.
        ro, v, wave, ev, caps = _fleet_rollout(
            tag, router, degraded, incumbent, slo, "r1", lines, rate,
            seed + 4)
        if (v.get("verdict") != "rolled_back" or v.get("reason")
                != "slo_burn" or v.get("swap_back_failed")):
            fail(tag, f"degrade arm: {v}")
        if not _wait_until(lambda: victim.digest == boot, 30.0) \
                or router.fleet_digest != boot:
            fail(tag, f"degrade arm: r1 on {victim.digest}, fleet "
                      f"{router.fleet_digest}, boot {boot}")
        row["degrade"] = {"verdict": v, "wave": wave, "slo": slo,
                          "degrade_s_per_batch": degrade_s,
                          "graph_captures_by_swaps": caps,
                          "events": [e.get("action") for e in ev]}
        # Promote: the seeded candidate over two stages on r0.
        ro, v, wave, ev, caps = _fleet_rollout(
            tag, router, candidate, incumbent, slo, "r0", lines, rate,
            seed + 100)
        if v.get("verdict") != "promoted" or v.get("digest") == boot:
            fail(tag, f"promote arm: {v}")
        if not _wait_until(lambda: all(r.digest == v["digest"]
                                       for r in router.replicas), 30.0) \
                or router.fleet_digest != v["digest"]:
            fail(tag, f"promote arm: replicas on "
                      f"{[r.digest for r in router.replicas]}")
        pongs = _fleet_pongs(router)
        if any(p["digest"] != v["digest"] for p in pongs.values()):
            fail(tag, f"promote arm: pongs {pongs}")
        row["promote"] = {"verdict": v, "wave": wave,
                          "graph_captures_by_swaps": caps,
                          "stages": len([e for e in ev if e.get("action")
                                         == "stage"]),
                          "events": [e.get("action") for e in ev]}
        # The HTTP front end over the same router, and the rollout's rows
        # where the rollout CLI serves them: its --prom-port exposition.
        http = RouterHTTPServer(router, port=0)
        base = f"http://127.0.0.1:{http.port}"
        rollout_prom = PromServer(0, lambda: router_exposition(
            router.snapshot(), rollout=ro.state()))
        try:
            rollout_metrics = _scrape(rollout_prom.port)
        finally:
            rollout_prom.close()

        def call(path, body=None):
            req = urllib.request.Request(
                base + path, method="POST" if body is not None else "GET",
                data=None if body is None else json.dumps(body).encode())
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return resp.status, resp.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()

        got = {"healthz": call("/healthz"),
               "predict": call("/predict", {"id": "h1", **lines[0]}),
               "predict_expired": call("/predict", {
                   "id": "h2", "deadline_ms": 0.001, **lines[1]}),
               "metrics": call("/metrics")}
        ok = (got["healthz"][0] == 200
              and json.loads(got["healthz"][1])["status"] == "ok"
              and got["predict"][0] == 200
              and "pred" in json.loads(got["predict"][1])
              and got["predict_expired"][0] in (429, 503)
              and json.loads(got["predict_expired"][1]).get("cause")
              and got["metrics"][0] == 200
              and "tpuic_router_offered_total" in got["metrics"][1]
              and "tpuic_router_offered_total" in rollout_metrics
              and "tpuic_router_rollout_phase 5" in rollout_metrics)
        if not ok:
            fail(tag, f"http: {json.dumps(got)[:2000]}; rollout "
                      f"/metrics {rollout_metrics[:1000]}")
        row["http"] = {k: (s, body[:200] if k != "metrics" else len(body))
                       for k, (s, body) in got.items()}
        lives = {"r0": pongs["r0"]["kernel_launches"],
                 "r1 (killed; at its last pong)":
                     killed["kernel_launches_at_last_pong"],
                 "r1 (respawned)": pongs["r1"]["kernel_launches"]}
        row["k3_launches_by_life"] = {
            name: (life or {}).get("fused_conv_bn_relu", 0)
            for name, life in lives.items()}
        row["k3_at_start"] = {name: p["kernel_launches"].get(
            "fused_conv_bn_relu", 0) for name, p in pongs0.items()}
        for name, k3 in row["k3_launches_by_life"].items():
            if not k3 or k3 % len(resnet50_launches(1)):
                fail(tag, f"{name}: K3 launches {k3}")
        row["router"] = {k: v for k, v in router.snapshot().items()
                         if k not in ("replicas",)}
        row["answers_max_abs_err"] = max(errs) if errs else None
        row["answers_checked"] = len(errs)
    finally:
        os.environ.pop("TPUIC_FAULTS", None)
        if http is not None:
            http.close()
        router.close(drain=False)
    row.update(card=smi, phase_s=time.perf_counter() - t0)
    log(tag, json.dumps(row))
    return row


# -- [score]: bulk scoring on the card -----------------------------------------
SCORE_PER_CLASS = 128    # corpus rows a class: 8 classes x 128 = 1,024
SCORE_MIN_ROWS = 1024
SCORE_BATCH = 32         # the engine's largest bucket
SCORE_SHARD = 64         # rows a shard: 16 shards of two batches
SCORE_CRASH_RANK = 1     # scorer_crash@1#1: rank 1 dies at its first commit
SCORE_CORRUPT = (2, 1)   # shard_corrupt@2#1: shard 2's row at offset 1
SCORE_AGREE = 0.9        # a rung's top-1 agreement with fp32: the ladder's gate
SCORE_TIMEOUT = 300.0    # a gang worker's life, start to exit; each wait


def _score_corpus(root: str) -> dict:
    """The scoring corpus: the first SCORE_PER_CLASS images of each class
    of ``train``'s folder (hard links: seeded synthetic PNGs at 224 px)
    as a ``val`` fold of its own, packed by ``pack_dataset``."""
    from tpuic_torch.config import DataConfig
    from tpuic_torch.data.folder import ImageFolderDataset
    from tpuic_torch.data.pack import pack_dataset
    data = os.path.join(root, "score_data")
    src = os.path.join(root, "train")
    for c in sorted(os.listdir(src)):
        os.makedirs(os.path.join(data, "val", c))
        for name in sorted(os.listdir(os.path.join(src, c)))[
                :SCORE_PER_CLASS]:
            os.link(os.path.join(src, c, name),
                    os.path.join(data, "val", c, name))
    ds = ImageFolderDataset(data, "val", IMAGE, DataConfig(
        data_dir=data, resize_size=IMAGE), allow_unlabeled=True)
    packed = pack_dataset(ds, os.path.join(data, ".tpuic_pack"),
                          log=lambda m: log("score", m))
    t0 = time.perf_counter()
    for i in range(len(packed)):
        if not packed.verify_row(i):
            fail("score", f"packed row {i} fails its CRC at rest")
    return {"data": data, "n": len(packed), "pack_s": packed.pack_seconds,
            "decoded": packed.decoded,
            "crc_s": time.perf_counter() - t0}


def _score_cmd(data: str, out: str, ckpt_dir: str) -> list:
    return [sys.executable, "-m", "tpuic_torch.score", "--datadir", data,
            "--out", out, "--ckpt-dir", ckpt_dir, "--model", "auto",
            "--shard-size", str(SCORE_SHARD), "--batchsize",
            str(SCORE_BATCH), "--poll", "0.1"]


def _score_records(out: str) -> dict:
    """``{index: record}`` of a job's result files."""
    return {r["index"]: r for path in sorted(glob.glob(os.path.join(
        out, "results", "*.jsonl"))) for r in _jsonl(path)}


def _score_bytes(out: str) -> dict:
    out_bytes = {}
    for path in sorted(glob.glob(os.path.join(out, "results", "*.jsonl"))):
        with open(path, "rb") as f:
            out_bytes[os.path.basename(path)] = f.read()
    return out_bytes


def _score_ledger(out: str) -> list:
    """Every rank's ledger records (a killed rank's torn tail skipped)."""
    from tpuic_torch.telemetry.events import read_jsonl
    return [r for p in sorted(glob.glob(os.path.join(out, "*.jsonl")))
            for r in read_jsonl(p)]


def _score_orphans(out: str) -> list:
    """Result files published without a manifest (the dead rank's)."""
    return [p for p in glob.glob(os.path.join(out, "results", "*.jsonl"))
            if not os.path.exists(os.path.join(out, "manifests", os.path
                                               .basename(p)[:-len(".jsonl")]
                                               + ".json"))]


def _score_gang(box: dict, data: str, out: str, ckpt_dir: str,
                work: str) -> None:
    """``[score]``'s elastic gang, on a thread of its own: two ``python -m
    tpuic_torch.score`` workers on the card under the membership file
    this thread writes.  Rank 1, armed ``scorer_crash@1#1``, starts
    first; rank 0 starts once rank 1 has published its plan (so rank 1 is
    first to a commit); rank 1 dies by SIGKILL between its first link and
    manifest; the degrade is booked; rank 0 steals the dead rank's lease
    at once (its owner left the active set; the lease's TTL is 30 s) and
    adopts the shard; then the rejoin is booked and a replacement rank 1
    starts.  Fills ``box`` (``error`` on a failure)."""
    from tpuic_torch.runtime.membership import (ENV_MEMBERSHIP_FILE,
                                                Membership, write_membership)
    from tpuic_torch.telemetry.fleet import ENV_FLEET_RANK, ENV_FLEET_RANKS
    here = os.path.dirname(os.path.abspath(__file__))
    member = os.path.join(work, "membership.json")
    procs, logs = box["procs"], box["logs"]
    t0 = time.perf_counter()

    def start(name, rank, spec=""):
        env = dict(os.environ, PYTHONPATH=here,
                   **{ENV_FLEET_RANK: str(rank), ENV_FLEET_RANKS: "2",
                      ENV_MEMBERSHIP_FILE: member})
        env.pop("TPUIC_FAULTS", None)
        if spec:
            env["TPUIC_FAULTS"] = spec
        logs[name] = os.path.join(work, f"{name.replace(' ', '_')}.log")
        with open(logs[name], "w") as f:
            procs[name] = subprocess.Popen(
                _score_cmd(data, out, ckpt_dir), env=env, cwd=here,
                stdout=f, stderr=subprocess.STDOUT)
        box["started_s"][name] = time.perf_counter() - t0

    def book(version, active, reason, rank=None):
        write_membership(member, Membership(
            version=version, world=2, active=active, resume_step=None,
            reason=reason, rank=rank, t=time.time()))
        box["membership"].append((reason, time.perf_counter() - t0))

    def planned():
        path = os.path.join(out, f"ledger.rank{SCORE_CRASH_RANK}.jsonl")
        return os.path.exists(path) and '"score_plan"' in open(path).read()

    try:
        book(1, [0, 1], "init")
        start("rank 1", 1, f"scorer_crash@1#{SCORE_CRASH_RANK}")
        if not _wait_until(lambda: planned()
                           or procs["rank 1"].poll() is not None,
                           SCORE_TIMEOUT):
            raise RuntimeError("rank 1 published no plan")
        start("rank 0", 0)
        box["rc"]["rank 1"] = procs["rank 1"].wait(timeout=SCORE_TIMEOUT)
        box["killed_s"] = time.perf_counter() - t0
        if box["rc"]["rank 1"] != -signal.SIGKILL:
            raise RuntimeError(f"rank 1 exited {box['rc']['rank 1']}, not "
                               "by scorer_crash's SIGKILL")
        box["orphans_at_kill"] = len(_score_orphans(out))
        book(2, [0], "degrade", SCORE_CRASH_RANK)
        if not _wait_until(lambda: not _score_orphans(out)
                           or procs["rank 0"].poll() is not None,
                           SCORE_TIMEOUT) or _score_orphans(out):
            raise RuntimeError(f"the dead rank's shard was not adopted "
                               f"(rank 0 exit {procs['rank 0'].poll()})")
        box["adopted_s"] = time.perf_counter() - t0
        book(3, [0, 1], "rejoin", SCORE_CRASH_RANK)
        start("rank 1 replacement", 1)
        for name in ("rank 0", "rank 1 replacement"):
            box["rc"][name] = procs[name].wait(timeout=SCORE_TIMEOUT)
        box["wall_s"] = time.perf_counter() - t0
    except Exception:  # noqa: BLE001 - reported by the main thread
        import traceback
        box["error"] = traceback.format_exc()[-2000:]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def _score_run(tag: str, arm: str, data: str, out: str, ckpt_dir: str,
               dtype: str, n: int) -> dict:
    """One in-process ``run_score`` life over the corpus (the CLI's
    defaults but the rung, batch and shard size): every count set to 0
    just before, read just after.  Fails unless every shard committed,
    the loop captured no graph, its audit is exact, and K3 ran 53 times a
    device call and no other kernel ran."""
    from tpuic_torch.score.driver import run_score
    from tpuic_torch.telemetry.fleet import load_streams, score_audit
    reset_counts()
    s = run_score(data_dir=data, out_dir=out, model_name="resnet50",
                  num_classes=1000, resize=IMAGE, batch_size=SCORE_BATCH,
                  shard_size=SCORE_SHARD, dtype=dtype, ckpt_dir=ckpt_dir,
                  poll_s=0.1, log=lambda *a: log(tag, " ".join(
                      str(x) for x in a[1:])))
    counts = read_counts()
    audit = score_audit(load_streams([out]))
    per_call = len(resnet50_launches(1))
    calls = sum(-(-(int(m["scored"])) // SCORE_BATCH) for m in (
        json.load(open(p)) for p in glob.glob(os.path.join(
            out, "manifests", "*.json"))))
    loop = s["kernel_launches"]
    k3 = loop["fused_conv_bn_relu"]
    if (s["shards_committed"] != s["shards"] or s["halted"]
            or s["steady_compiles"] != 0 or not audit["ok"]
            or s["rows_scored"] + s["rows_quarantined"] != n):
        fail(tag, f"{arm}: {json.dumps(s)}; audit {audit['errors']}")
    if (k3 != per_call * calls or not k3
            or any(v for k, v in loop.items() if k != "fused_conv_bn_relu")
            or counts["conv_bn_relu"] < k3):
        fail(tag, f"{arm}: K3 launched {k3} times in the loop for {calls} "
                  f"device calls ({per_call} a call); loop {loop}; counts "
                  f"{counts}")
    row = {"dtype": dtype, "images_per_s": s["rows_scored"] / s["wall_s"],
           "wall_s": s["wall_s"], "device_calls": calls,
           "k3_launches": k3, "k3_launches_with_warmup":
               counts["conv_bn_relu"],
           **{k: s[k] for k in ("rows_scored", "rows_quarantined",
                                "steady_compiles", "commits_this_life")}}
    log(tag, f"{arm}: {json.dumps(row)}")
    free()
    return row


def phase_score(root: str, seed: int, ckpt_dir: str, smi: str,
                ladder_int8: float) -> dict:
    """Bulk scoring on the card: ``python -m tpuic_torch.score`` over a
    seeded 1,024-row corpus at 224 px, scored with ``[ckpt]``'s ResNet-50
    (1000 classes; ``--model auto --ckpt-dir``) in shards of SCORE_SHARD
    rows at batch SCORE_BATCH, K3 on every conv of each rung's
    graph-replayed forward.  A: the undisturbed int8 run (the CLI's
    default) in this process, the reference bytes of every shard file;
    B: the fp32 and bf16 rungs, each rung's top-1 within SCORE_AGREE of
    fp32's; C: the elastic gang (``_score_gang``), started with A, its
    audit exact through the fleet CLI (with ``--prom-dump``), a recovered
    record, every shard file bitwise A's; D: ``shard_corrupt@2#1`` puts
    exactly one row in the quarantined column, the audit exact; E: a
    ledger copy with a commit record duplicated, and one with it dropped,
    fail the audit."""
    from tpuic_torch.telemetry.fleet import main as fleet_main
    tag = "score"
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="score_", dir=root)
    corpus = _score_corpus(root)
    data, n = corpus["data"], corpus["n"]
    if n < SCORE_MIN_ROWS:
        fail(tag, f"corpus of {n} rows")
    log(tag, f"corpus: {n} rows at {IMAGE} px, packed in "
             f"{corpus['pack_s']:.3f} s ({corpus['decoded']}), shards of "
             f"{SCORE_SHARD} at batch {SCORE_BATCH}; every row's CRC "
             f"checked in {corpus['crc_s']:.3f} s")
    gang = {"procs": {}, "logs": {}, "rc": {}, "started_s": {},
            "membership": []}
    out_el = os.path.join(work, "elastic")
    thread = threading.Thread(target=_score_gang, daemon=True, args=(
        gang, data, out_el, ckpt_dir, work))
    thread.start()
    row = {"corpus": {k: corpus[k] for k in ("n", "pack_s", "decoded",
                                             "crc_s")},
           "shard_size": SCORE_SHARD, "batch": SCORE_BATCH}
    try:
        outs = {t: os.path.join(work, t) for t in ("int8", "fp32", "bf16")}
        rungs = {"int8": _score_run(tag, "A int8", data, outs["int8"],
                                    ckpt_dir, "int8", n)}
        for t in ("fp32", "bf16"):
            rungs[t] = _score_run(tag, f"B {t}", data, outs[t], ckpt_dir, t,
                                  n)
        preds = {t: {i: r["pred"] for i, r in _score_records(o).items()}
                 for t, o in outs.items()}
        for t in ("int8", "bf16"):
            agree = sum(preds[t][i] == preds["fp32"][i]
                        for i in range(n)) / n
            rungs[t]["top1_agreement_with_fp32"] = agree
            if agree < SCORE_AGREE:
                fail(tag, f"rung {t}: top-1 agreement {agree:.4f} with "
                          f"fp32 < {SCORE_AGREE}")
        row["rungs"] = rungs
        row["ladder_int8_images_per_s"] = ladder_int8
        row["crc_share_of_int8_loop"] = (corpus["crc_s"]
                                         / rungs["int8"]["wall_s"])
        reference = _score_bytes(outs["int8"])

        # D: one row of shard 2 quarantined; the accounting stays exact.
        shard, off = SCORE_CORRUPT
        out_d = os.path.join(work, "corrupt")
        from tpuic_torch.runtime import faults
        faults.arm("shard_corrupt", steps=shard, param=off)
        try:
            corrupt = _score_run(tag, "D shard_corrupt", data, out_d,
                                 ckpt_dir, "int8", n)
        finally:
            faults.reset()
        bad = [r for r in _score_records(out_d).values()
               if r.get("quarantined")]
        rc_d = fleet_main([out_d, "--score-ledger"])
        got_d = _score_bytes(out_d)
        same = [k for k in reference if k != f"shard-{shard:05d}.jsonl"
                and got_d.get(k) != reference[k]]
        if (corrupt["rows_quarantined"] != 1 or len(bad) != 1
                or bad[0]["index"] != shard * SCORE_SHARD + off
                or bad[0]["reason"] != "injected" or rc_d != 0 or same):
            fail(tag, f"shard_corrupt: {corrupt}, quarantined rows {bad}, "
                      f"audit exit {rc_d}, other shards differing {same}")
        row["shard_corrupt"] = {"quarantined_index": bad[0]["index"],
                                "audit_exit": rc_d, **corrupt}

        thread.join(timeout=4 * SCORE_TIMEOUT)
        if thread.is_alive() or "error" in gang:
            tails = {k: open(p).read()[-1500:]
                     for k, p in gang["logs"].items() if os.path.exists(p)}
            fail(tag, f"gang: {gang.get('error', 'still running')}; "
                      f"exits {gang['rc']}; logs {json.dumps(tails)}")
        here = os.path.dirname(os.path.abspath(__file__))
        rep_path = os.path.join(work, "audit_elastic.json")
        prom_path = os.path.join(work, "score_elastic.prom")
        cli = subprocess.run(
            [sys.executable, "-m", "tpuic_torch.telemetry.fleet", out_el,
             "--score-ledger", "--json", rep_path, "--prom-dump",
             prom_path], cwd=here, env=dict(os.environ, PYTHONPATH=here),
            capture_output=True, text=True, timeout=120)
        rep = json.load(open(rep_path)) if os.path.exists(rep_path) else {}
        prom = open(prom_path).read() if os.path.exists(prom_path) else ""
        got = _score_bytes(out_el)
        diff = sorted(k for k in reference if got.get(k) != reference[k])
        dones = {r.get("rank"): r for r in _score_ledger(out_el)
                 if r.get("event") == "score_done"}
        if (cli.returncode != 0 or rep.get("n") != n
                or rep.get("rows_scored", 0) + rep.get("rows_quarantined", 0)
                != n or rep.get("shards_duplicated") != 0
                or rep.get("recovered_records", 0) < 1
                or "tpuic_score_ledger_exact 1" not in prom
                or diff or len(got) != len(reference)
                or sorted(dones) != [0, 1]
                or any(d["steady_compiles"] for d in dones.values())
                or gang["rc"] != {"rank 1": -signal.SIGKILL, "rank 0": 0,
                                  "rank 1 replacement": 0}):
            fail(tag, f"gang: audit exit {cli.returncode} "
                      f"{cli.stdout[-600:]}{cli.stderr[-600:]}; report "
                      f"{json.dumps(rep)[:800]}; files differing from A "
                      f"{diff}; score_done by rank {json.dumps(dones)}; "
                      f"exits {gang['rc']}")
        row["gang"] = {
            "wall_s": gang["wall_s"], "started_s": gang["started_s"],
            "killed_s": gang["killed_s"], "adopted_s": gang["adopted_s"],
            "membership": gang["membership"], "exits": gang["rc"],
            "orphans_at_kill": gang["orphans_at_kill"],
            "audit": {k: rep.get(k) for k in (
                "shards_committed", "rows_scored", "rows_quarantined",
                "shards_duplicated", "recovered_records",
                "duplicate_score_events")},
            "by_life": {
                "rank 1 (SIGKILLed at its first commit)": "lost with it",
                **{("rank 0" if r == 0 else "rank 1 replacement"): {
                    "k3_launches": d["kernel_launches"][
                        "fused_conv_bn_relu"],
                    **{k: d[k] for k in (
                        "commits_this_life", "steals_this_life",
                        "recovered_records", "duplicates_this_life",
                        "steady_compiles", "wall_s")}}
                   for r, d in sorted(dones.items())}},
            "prom_rows": sum(1 for ln in prom.splitlines()
                             if ln.startswith("tpuic_score_"))}
        if not dones[0]["steals_this_life"]:
            fail(tag, f"rank 0 stole no lease: {json.dumps(dones[0])}")

        # E: tampered ledger copies fail the audit.
        lines = [ln for p in sorted(glob.glob(os.path.join(out_el,
                                                           "*.jsonl")))
                 for ln in open(p).read().splitlines(keepends=True)]
        commit = next(ln for ln in lines if '"score_commit"' in ln)
        tampered = {}
        for arm, kept in (("duplicated", lines + [commit]),
                          ("dropped", [ln for ln in lines
                                       if ln != commit])):
            d = os.path.join(work, f"tampered_{arm}")
            os.makedirs(d)
            with open(os.path.join(d, "ledger.jsonl"), "w") as f:
                f.writelines(kept)
            tampered[arm] = fleet_main([d, "--score-ledger"])
        if tampered != {"duplicated": 1, "dropped": 1}:
            fail(tag, f"tampered ledgers audited {tampered}")
        row["tampered_audit_exits"] = tampered
    finally:
        for proc in gang["procs"].values():
            if proc.poll() is None:
                proc.kill()
    row["k3_launches_by_path"] = {
        **{f"score {t} (A)" if t == "int8" else f"score {t}": r[
            "k3_launches"] for t, r in row["rungs"].items()},
        "score int8 shard_corrupt": row["shard_corrupt"]["k3_launches"],
        **{f"score gang {life}": v["k3_launches"]
           for life, v in row["gang"]["by_life"].items()
           if isinstance(v, dict)}}
    row.update(card=smi, phase_s=time.perf_counter() - t0)
    log(tag, json.dumps(row))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=320)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="",
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false: this smoke run "
                       "needs an NVIDIA GPU")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log("device", f"{smi} | torch {torch.__version__} CUDA "
                  f"{torch.version.cuda} | {kind} | peaks "
                  f"{peaks(kind)}")

    from tpuic_torch.kernels import _build
    t_start = time.perf_counter()
    # Seconds by phase, every phase named (those up to [vit-train] too),
    # in the order they ran; "to_vit_train" is their running sum there,
    # the figure earlier runs reported.
    took = TIMING

    def timed(label, fn, /, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        took[label] = time.perf_counter() - t0
        return out

    t0 = time.perf_counter()
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    writers = start_folder_writers(workdir.name, args.seed)
    built = _build.build()
    log("build", f"{json.dumps(built)} in {time.perf_counter() - t0:.3f} s")
    join_folder_writers(writers)
    log("build", f"the synthetic folders written beside it: "
                 f"{time.perf_counter() - t0:.3f} s in all")
    for name in _build.sources():
        for line in _build.ptxas_log(name).splitlines():
            if any(key in line for key in ("entry function", "Function "
                                           "properties", "registers",
                                           "spill")):
                log("build", f"{name}: {line.strip()}")
    took["build"] = time.perf_counter() - t0

    gen = torch.Generator().manual_seed(args.seed)
    summary, rows = timed("kernel", phase_kernel, kind, gen)
    model = timed("model", phase_model, gen)
    launches, snap = timed("serve", phase_serve, model, args.requests,
                           args.seed, smi)
    summary["launches"] = launches
    summary["status"] = "ok"
    swap = timed("swap", phase_swap, model, resnet50_b(args.seed + 1),
                 SWAP_REQUESTS, args.seed, smi)
    admission = timed("admission", phase_admission, model, args.seed, smi)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    xent, xent_rows = timed("xent", phase_xent, kind, gen)
    optim = timed("optim", phase_optim, kind, args.seed)
    with workdir as root:
        pack = timed("pack", phase_pack, root, args.seed, smi)
        counts, lamb_counts, train = timed("train", phase_train, root,
                                           args.seed, smi)
        ddp = timed("ddp", phase_ddp, root, args.seed, smi)
        ckpt_dir = os.path.join(root, "ckpt_smoke")
        ckpt = timed("ckpt", phase_ckpt, root, args.seed, ckpt_dir)
        listen = {n: _start_listen(root, ckpt_dir, n)
                  for n in ("serve_cli", "swap_cli")}
        serve_cli = timed("serve-cli", phase_serve_cli, root, ckpt_dir, smi,
                          listen["serve_cli"])
        swap_cli = timed("swap-cli", phase_swap_cli, root, ckpt_dir,
                         serve_cli["digest"], smi, listen["swap_cli"])
        predicted = timed("predict", phase_predict, root, ckpt_dir,
                          ckpt["best_val_accuracy"], ckpt.pop("best_top1"))
        attn, attn_bf16, attn_rows = timed("attn", phase_attn, kind, gen)
        vit = timed("vit", phase_vit, gen, args.seed)
        # Under torch's default flags: the engine's forward turns TF32 off
        # for its call, and the ViT's patch embedding is one matmul, which
        # cuBLAS runs in float32 by default.
        _, vit_snap = timed("vit-serve", phase_serve, vit, args.requests,
                            args.seed, smi, tag="vit-serve",
                            counter="flash_attention_fwd",
                            per_call=VIT_LAYERS)
        vit_swap = timed("vit-swap", phase_swap, vit, vit_b(args.seed + 1),
                         SWAP_REQUESTS, args.seed, smi, tag="vit-swap",
                         name=VIT_MODEL, counter="flash_attention_fwd",
                         per_call=VIT_LAYERS, stopped=1)
        del vit
        free()
        vit_counts, vit_train = timed("vit-train", phase_vit_train, root,
                                      args.seed, smi)
        took["to_vit_train"] = time.perf_counter() - t_start
        recipe_counts, vit_train["recipe"] = timed(
            "vit-train-recipe", phase_vit_recipe, root, args.seed, smi,
            vit_train["bfloat16"])
        eff_counts, eff_train = timed("effnet-train", phase_effnet_train,
                                      root, args.seed, smi)
        t0 = time.perf_counter()
        ladder = {
            "resnet50": phase_ladder("resnet50", IMAGE, args.seed, smi,
                                     counter="conv_bn_relu",
                                     per_call=len(resnet50_launches(1)),
                                     swap=True),
            "inceptionv3": phase_ladder("inceptionv3", INC_IMAGE, args.seed,
                                        smi),
            VIT_MODEL: phase_ladder(VIT_MODEL, IMAGE, args.seed, smi,
                                    counter="flash_attention_fwd",
                                    per_call=VIT_LAYERS)}
        ladder["bf16_rows_by_family"] = bf16_rows_by_family(smi)
        took["ladder"] = time.perf_counter() - t0
        cli_ladder = timed("serve-cli-ladder", phase_serve_cli_ladder, root,
                           ckpt_dir, smi)
        inception = timed("inception", phase_cnn_serve, "inceptionv3",
                          INC_IMAGE, "inception", args.requests, args.seed,
                          smi)
        inc_counts, inc_train = timed(
            "inception-train", phase_inception_train,
            os.path.join(root, "inception"), args.seed, smi)
        ref_cli = timed("ref-cli", phase_ref_cli, root, args.seed, smi)
        digits_counts, digits = timed("digits", phase_digits, root, smi)
        dvit_counts, digits_vit = timed("digits-vit", phase_digits_vit,
                                        root, smi)
        effnet = timed("effnet-serve", phase_cnn_serve, EFF_MODEL,
                       EFF_IMAGE, "effnet-serve", args.requests, args.seed,
                       smi)
        moe_counts, moe_train = timed("moe-train", phase_moe_train, root,
                                      args.seed, smi)
        moe_serve = timed("moe-serve", phase_moe_serve, args.seed, smi)
        telemetry = timed("telemetry", phase_telemetry, root, args.seed,
                          smi)
        serve_ops = timed("serve-ops", phase_serve_ops, root, args.seed,
                          smi)
        resilience = timed("resilience", phase_resilience, root, args.seed,
                           smi)
        # [fleet]'s replicas start while [convert] runs.
        fleet_started = _fleet_start(root)
        convert = timed("convert", phase_convert, root, args.seed, ckpt_dir,
                        smi)
        fleet = timed("fleet", phase_fleet, root, args.seed, ckpt_dir, smi,
                      fleet_started)
        score = timed("score", phase_score, root, args.seed, ckpt_dir, smi,
                      ladder["resnet50"]["served"]["int8"]["images_per_s"])
    took["total"] = time.perf_counter() - t_start
    log("timing", json.dumps(took))
    # The share of each training cell's train loop spent waiting for the
    # loader (every cell on the packed, resident path).
    data_wait = {
        "train": train["data_wait_share"],
        **{f"vit-train {d}": vit_train[d]["data_wait_share"]
           for d in ("float32", "bfloat16")},
        "vit-train recipe": vit_train["recipe"]["data_wait_share"],
        "effnet-train": eff_train["data_wait_share"],
        **{f"inception-train {d}": inc_train[d]["data_wait_share"]
           for d in ("float32", "bfloat16")},
        "ddp one process": ddp["one_process"]["data_wait_share"],
        **{f"ddp {a} rank {r}": w for a, arm in ddp["arms"].items()
           for r, w in enumerate(arm["data_wait_share"])},
        **{f"digits {d}": digits[d]["data_wait_share"]
           for d in DIGITS_DTYPES},
        "digits-vit": digits_vit["data_wait_share"]}
    log("data-wait", json.dumps(data_wait))

    def ddp_counts(name):
        """``name``'s launches on the ``ddp`` paths, by process."""
        return {f"ddp {arm} rank {r}": c[name]
                for arm, a in ddp["arms"].items()
                for r, c in enumerate(a["launches"])}

    def moe_paths(name):
        """``name``'s launches on the MoE paths: ``[moe-train]``'s arms and
        ``[ddp]``'s MoE arm by process."""
        return {**{f"moe-train {d}": c[name] for d, c in moe_counts.items()},
                "ddp moe one process": ddp["moe"]["one_process"][
                    "launches"][name],
                **{f"ddp moe {arm} rank {r}": c[name]
                   for arm, a in ddp["moe"]["arms"].items()
                   for r, c in enumerate(a["launches"])}}

    accum = train["accum"]
    remat = vit_train["recipe"]["remat"]

    def res_paths(name):
        """``name``'s launches on ``[resilience]``'s paths, each life
        counted from 0 at its ``fit`` (a SIGKILLed life's are lost)."""
        pre, gang = resilience["preempt"], resilience["gang"]
        return {
            **{f"resilience preempt {arm}": c[name]
               for arm, c in pre["launches"].items()},
            "resilience rollback": resilience["rollback"]["launches"][name],
            "resilience crash (restarted life)":
                resilience["crash"]["launches_second_life"][name],
            **{f"resilience gang {arm} rank {r}": c[name]
               for arm, per in gang["launches"].items()
               for r, c in enumerate(per)}}

    def k1(name):
        """K1's launches on each training path, each counted from 0 just
        before its path ran; ``launches`` stays ``[train]``'s."""
        return {"train": counts[name], **res_paths(name), **{
            f"{tag} {dtype}": c[name]
            for tag, per in (("inception-train", inc_counts),
                             ("digits", digits_counts))
            for dtype, c in per.items()}, **ddp_counts(name),
            "vit-train float32": vit_counts["float32"][name],
            "vit-train bfloat16": vit_counts["bfloat16"][name],
            "vit-train recipe (bf16, 2 a step)": recipe_counts[name],
            "vit-train remat dots": remat["remat_dots"]["launches"][name],
            "effnet-train": eff_counts[name],
            "accum": accum["kernels"]["launches"][name],
            "digits-vit (2 a step)": dvit_counts[name], **moe_paths(name)}

    def k4(name):
        """K4's launches on each training path."""
        return {"vit-train float32": vit_counts["float32"][name],
                "vit-train bfloat16": vit_counts["bfloat16"][name],
                "vit-train recipe (bf16)": recipe_counts[name],
                "vit-train no remat (2 steps)":
                    remat["no_remat"]["launches"][name],
                "vit-train remat dots (2 steps)":
                    remat["remat_dots"]["launches"][name],
                "digits-vit": dvit_counts[name], **moe_paths(name),
                **({f"moe-serve {t}": r["kernel_launches"]
                    for t, r in moe_serve["served"].items()}
                   if name == K4[0] else {}),
                **({f"convert {VIT_MODEL} --verify": convert[VIT_MODEL][
                    "launches"].get(name, 0)} if name == K4[0] else {})}

    csrc = "tpuic_torch/kernels/csrc/"
    kernels = [summary]
    for name, row, source, replaces, n in (
            ("cross_entropy_fwd", xent["cross_entropy_fwd"],
             csrc + "cross_entropy.cu", "tpuic/kernels/cross_entropy.py:50",
             counts["cross_entropy_fwd"]),
            ("cross_entropy_bwd", xent["cross_entropy_bwd"],
             csrc + "cross_entropy.cu", "tpuic/kernels/cross_entropy.py:64",
             counts["cross_entropy_bwd"]),
            ("lars_update", optim["lars_update"],
             csrc + "optimizer_update.cu",
             "tpuic/kernels/optimizer_update.py:94", counts["lars_update"]),
            ("lamb_update", optim["lamb_update"],
             csrc + "optimizer_update.cu",
             "tpuic/kernels/optimizer_update.py:146",
             lamb_counts["lamb_update"]),
            *((name, attn[name], csrc + "flash_attention.cu",
               f"tpuic/kernels/flash_attention.py:{line}",
               vit_counts["float32"][name])
              for name, line in zip(K4, (154, 346, 373))),
            # bf16 builds: K4f's TMA and wgmma kernel at D = 64, the
            # backward pair's and K3's bf16 builds; launches on the bf16
            # paths (the ladder's bf16 rungs, [vit-train]'s bf16 arm).
            *((f"{name} (bf16)", attn_bf16[name],
               csrc + ("flash_fwd_sm90.cu" if name == K4[0]
                       else "flash_attention.cu"),
               f"tpuic/kernels/flash_attention.py:{line}",
               vit_counts["bfloat16"][name] + (
                   ladder[VIT_MODEL]["served"]["bf16"]["kernel_launches"]
                   if name == K4[0] else 0))
              for name, line in zip(K4, (154, 346, 373))),
            ("conv_bn_relu (bf16 x)", {
                "max_abs_err": summary["bf16_max_abs_err"],
                **{k: summary["bf16"][k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "issue_rate_ms", "library_ms", "library_device_ms",
                    "over_library")},
                f"batch{SERVE_BATCH}": summary[f"batch{SERVE_BATCH}"][
                    "bf16"]},
             csrc + "conv_bn_relu_sm90.cu",
             "tpuic/kernels/conv_bn_relu.py:76",
             ladder["resnet50"]["served"]["bf16"]["kernel_launches"])):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": n, **row,
                        "status": "ok"})
        if name.startswith("cross_entropy"):
            kernels[-1]["launches_by_path"] = k1(name)
        if name == "lamb_update":
            kernels[-1]["launches_by_path"] = {
                "train (lamb arm)": lamb_counts[name], **moe_paths(name)}
        if name == "lars_update":
            kernels[-1]["launches_by_path"] = {
                "train": counts[name], **ddp_counts(name),
                "accum (gate open on 2 of 4)":
                    accum["kernels"]["launches"][name], **res_paths(name)}
        if name.split(" ")[0] in K4:
            kernels[-1]["launches_by_path"] = k4(name.split(" ")[0])
        if name == "conv_bn_relu (bf16 x)":
            kernels[-1]["launches_by_path"] = {
                "ladder bf16": n,
                "score bf16": score["rungs"]["bf16"]["k3_launches"]}
    # K3 on the ladder's int8 and bf16 ResNet-50 rungs and the ddp val
    # passes beside [serve]'s.
    summary["launches_by_path"] = {
        "serve": launches, **{f"ladder {t}": r["kernel_launches"] for t, r
                              in ladder["resnet50"]["served"].items()},
        **ddp_counts("conv_bn_relu"), "serve-ops": serve_ops["launches"],
        **res_paths("conv_bn_relu"),
        "convert resnet50 --verify": convert["resnet50"]["launches"][
            "conv_bn_relu"],
        "convert --export-torch --verify": convert["export"]["launches"][
            "conv_bn_relu"],
        **{f"fleet {life}": n
           for life, n in fleet["k3_launches_by_life"].items()},
        **score["k3_launches_by_path"]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "kind": kind, "kernels": kernels,
                       "shapes": rows,
                       "serve": snap, "xent": xent_rows, "train": train,
                       "swap": swap, "admission": admission, "ddp": ddp,
                       "ckpt": ckpt, "serve_cli": serve_cli,
                       "swap_cli": swap_cli, "predict": predicted,
                       "attn": attn_rows, "vit_serve": vit_snap,
                       "vit_swap": vit_swap, "vit_train": vit_train,
                       "inception": inception,
                       "inception_train": inc_train, "ref_cli": ref_cli,
                       "pack": pack, "data_wait": data_wait,
                       "digits": digits, "digits_vit": digits_vit,
                       "effnet_train": eff_train, "effnet_serve": effnet,
                       "ladder": ladder, "serve_cli_ladder": cli_ladder,
                       "moe_train": moe_train, "moe_serve": moe_serve,
                       "telemetry": telemetry, "serve_ops": serve_ops,
                       "resilience": resilience, "convert": convert,
                       "fleet": fleet, "score": score,
                       "k1_launches": {"train": counts, "inception_train":
                                       inc_counts, "digits": digits_counts,
                                       "vit_recipe": recipe_counts,
                                       "effnet_train": eff_counts,
                                       "digits_vit": dvit_counts},
                       "seconds": took},
                      f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
