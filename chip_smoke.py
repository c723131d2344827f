#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
nonzero, and only a run where every phase passed prints the last line,
``{"ok": true, "device": {...}}``. Phases 0-5 are the serving slice,
phases 6-8 the ResNet training slice, phases 9-10 the LM training slice,
phases 11-13 the ImageNet example's slice, phases 14-16 the Seq2Seq
Transformer's, phases 17-19 gradient accumulation and the fp16_utils path
on the LM, phases 20-22 the ImageNet example's ViT-B/16 step with
attention dropout and the flash kernels' full bias, phases 23-25 the wide
LayerNorm (lm_bench's LM at GPT-3 175B's width) and ``bn_backward_reduce``,
phases 26-30 lm_bench's LM served (head dim 64) and trained in fp16 and
fp32, and the LayerNorm and BN at widths not a multiple of 4, phases 31-33
lm_bench's LM at 8 heads of 256 (the flash forward, dq and dk/dv at D
256), in bf16 and in fp32, phase 34 the DCGAN example's three-loss step
under O1 (``amp.autocast``), phase 35 lm_bench's LM with ``--remat``,
remat under O1 and in the ViT and the Seq2Seq Transformer, phases 36-38
speculative decoding on the multi-row decode kernel, the shared-prefix page
cache, sampled ``generate`` and the fused-MLP API, phase 39 the serving
engine's programs as CUDA graphs against the same programs run eagerly, and
phase 41 the router tier (replicas in threads and in child processes of
this script, ``--router-replica``, which the phase starts itself), and
phase 42 the telemetry sidecar (``prof.metrics``, ``flightrec``,
``watchdog``) in the engine and the DCGAN loop, with the port's serving
tools run as subprocesses, and phase 43 data parallelism
(``torch.distributed``: bench.py's ddp and zero arms at world size 1 over
NCCL, and ranks in child processes of this script, ``--ddp-rank``, over
gloo on the one card), and phase 44 sequence, expert and pipeline
parallelism (lm_bench's MoE LM, the engine serving it, and ranks in child
processes, ``--mp-rank``). ``python3 chip_smoke.py --model-parallel``
runs phases 0, 1 and 44 alone and prints no last line.
Every serving engine runs its programs captured (``run``'s way on the card);
``warmup()`` captures them first where a phase calls it:

0. device — needs CUDA; prints the card's ``nvidia-smi`` name and power
   limit (also as a raw line of its own) and the torch / CUDA versions.
1. build — compiles the hand kernels from ``apex_tpu_torch/ops/cuda/csrc``
   with ``nvcc`` for ``sm_90a`` (all sources at once) and loads them;
   prints every kernel's registers, spills and static shared memory
   (``ptxas``) and, apart, the
   flash forward's and backward's Hopper kernels (``flash_fwd_ptxas``,
   ``flash_bwd_ptxas``: 18 and 24 forms, bf16 and fp16; of them the 14 at
   head dim 256, ``flash_d256_ptxas``), the fp32 backward's
   (``flash_f32_ptxas``: 12 forms, D 64 and 128 and the pair kernels at
   256, plain and with a bias or dropout) and the fp32 forward's
   (``flash_f32_fwd_ptxas``: 6 forms, D 64, 128 and 256, plain and with a
   bias or dropout), the bf16/fp16 forward's, dq's and dk/dv's at D 384
   and 512 (``flash_d512_ptxas``: 12 forward, 8 dq, 8 dv and 8 dk forms)
   and the fp32 ones' there (``flash_f32_d512_ptxas``: 4 forward, 4 dq
   and 4 dk/dv forms, plain and with a bias or dropout) and the
   shared-bias gradient's (``flash_dbias_ptxas``: bf16, fp16 and fp32),
   none of whose forms may spill; and the one-pass wide LayerNorm
   backward's (``ln_bwd_row_ptxas``: 56 forms, none may spill) with the
   plans of phase 2's readings (``ln_bwd_row_plans``: the shared memory,
   dynamic, that each takes).
2. kernels — each kernel against its plain PyTorch version on the card,
   at its path's shapes: max abs error against the stated tolerance, the
   kernel's time, the plain version's, one PyTorch library call's where
   one computes the same function, the least time the card could take
   (the bound), and the host time of one wrapper call (``host_us``; the
   eager steps are host-bound). Serving kernels in bf16 and f32; the
   training kernels (``scale``, ``lamb_phase1``, ``lamb_phase2``) over a
   flat buffer of RN50's size T = 25,558,016, fp32 (and bf16 for
   ``scale``), with the overflow flag for an inf at the first, a middle
   and the last element, and two LAMB runs compared bit for bit; the BN
   kernels (``bn_moments``, ``bn_backward_fused_reduce``,
   ``bn_backward_dx``) at every distinct ``[N·H·W, C]`` bf16 shape of the
   RN50 step's 53 BNs, their times also summed over the step; the LM
   step's kernels at its shapes: ``adam`` over the LM's flat fp32 master
   store (T = 138,520,576; bit-equal), ``ln_bwd`` over [32760, 1024] bf16
   rows (dx within one bf16 ulp, the column sums within 1e-5 of each
   column's Σ|terms|, two runs bit-equal), and the flash kernels
   (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``) over [128, 4095,
   64] bf16, causal (held against the plain versions on the first 8
   heads, element by element: o, dq, dk and dv within 2 bf16 ulps plus
   2^-6 of the row's RMS over D, lse within 1e-3; and the rule must
   refuse the plain result with its later half 5% off; o, lse, dq, dk and
   dv each repeated bit for bit), the whole backward (``flash_bwd``:
   ``flash_delta``, dq and dk/dv in one timed call, its bound over five
   products and its bytes, SDPA's backward beside it), and the forward,
   dq, dk/dv and the whole backward again at the wide LM's [384, 2048,
   128] (reading ``wide``: the same rule, repeats and bounds, causal SDPA
   and SDPA's backward beside them); the ImageNet
   step's optimizer kernels over RN50's flat fp32 buffer: ``rowsumsq``
   (within 1e-5 relative of the plain version; beside it the whole
   per-tensor L2 norm and ``torch._foreach_norm`` over the 161 tensors),
   ``rowmaxabs`` (exact), ``sgd`` at main_amp's flags (bit-equal; every
   flag combination bit-equal at a small size) and ``novograd``
   (bit-equal; its whole step at L2 and L-inf norms); the translation
   step's kernels: ``xent_fwd`` and ``xent_bwd`` over its fp32 logits
   [16512, 37000] at label smoothing 0.1 (loss and lse within 1e-5
   relative, dx bit-equal, two runs bit-equal;
   ``F.cross_entropy`` and its backward beside them) and the three flash
   kernels with the source's key-padding ``kv_bias`` at the encoder's
   [1024, 128, 64] and the cross-attention's (Sq 129, Sk 128) shapes,
   bf16, every head under the flash rule, masked keys getting exactly no
   gradient (SDPA with the additive mask broadcast from [B, 1, 1, Sk]
   beside them); the accumulation and fp16_utils kernels over the LM's
   flat fp32 master store: ``axpby`` as ``unscale_with_stashed`` calls it
   (bit-equal in all three flag modes; an inf or NaN at the first, a
   middle and the last element of x and then of y flagged exactly when
   the mode checks that input; ``torch.add`` with alpha beside it),
   ``l2norm`` (within 1e-5 relative, two runs bit-equal;
   ``linalg.vector_norm`` beside it) and ``adagrad`` (bit-equal in both
   weight-decay modes at wd 1e-2; ``torch.optim.Adagrad`` fused or
   foreach beside it); and impl="auto"'s crossover: the flash path and
   the plain composed attention at [128, S, 64] bf16 for S 128-4096,
   forward and forward + backward, causal and not (SDPA beside them), the
   kernels required to win at every S from ``DEFAULT_FLASH_MIN_S``; the
   rest of the flash kernels at the ViT step's [1536, 197, 64] bf16: with
   dropout 0.1, with a shared [1, 197, 197] and a per-bh [1536, 197, 197]
   fp32 bias (dq's dS under the flash rule too), ``flash_bwd_dbias`` at
   that shape and causal at [128, 1024, 64] (against the plain per-bh dS
   summed over bh, two runs bit-equal, the simple form's
   ``flash_simt_dbias`` held and timed beside it; SDPA with ``dropout_p``
   and SDPA's backward with a learned ``attn_mask`` beside them as
   yardsticks), and
   the dropout mask read back exactly: q = k = 0 and v = I over 64 keys
   make o[i, j] != 0 (and, with dO = I, dv[j, i] != 0) exactly where the
   kernel kept (i, j), which must equal ``dropout_bits`` at a nonzero bh,
   q_start and k_start; the wide LayerNorm (``ln_fwd_wide``,
   ``ln_bwd_wide``) at the wide LM's [8192, 12288] bf16 rows, at [32,
   200704] bf16 (FusedLayerNorm over a [256, 28, 28] map) and at the JAX
   tests' (13, 16384) and (520, 9344) fp32 with and without affine (y
   within one bf16 ulp plus 1e-5, or 1e-5 relative in fp32; mean and
   invvar within 1e-5 relative; dx and the column sums as ``ln_bwd``, in
   fp32 with the row means' terms taken at their own rounding scale; two
   runs of each bit-equal; ``F.layer_norm`` and
   ``native_layer_norm_backward`` beside them; the backward's form and, to
   F 16384, its one-pass plan), and x = 1000 + 0.01·N(0,
   1) at [9, 16384] fp32 within 0.05 of fp64; ``bn_backward_reduce`` from
   a bf16 xhat at every RN50 BN shape (within 1e-5·Σ|terms|, bit-equal
   repeats; ``batch_norm_backward_reduce`` beside it); the split decode
   kernel at lm_bench's [8, 16, 1024, 64] (bf16 and f32, dense and
   paged equal bit for bit, repeats bit for bit; masked SDPA beside it),
   at both head dims at the lengths 0, 1, 63-65, 127, 129 and 1024 with a
   page of 5, its merge alone, its multi-row form (``decode_attention_rows``,
   ``paged_decode_attention_rows``) at phase 36's S 8, Q 4, H 8, hd 128, L
   1024, rows around 900, dense and paged (page 32), bf16 and fp32 and at hd 64
   (the decode rule, each row bit-equal to a 1-query call at its length, paged
   equal to dense, repeats; the bound over each slot's longest row; the JAX
   package's layout beside it: rows flattened over K/V expanded per row, and Q
   one-row calls; masked SDPA with an [S, 1, Q, L] mask), and the timer's
   reading of one and two empty launches and of one PyTorch elementwise call on
   one element (the launch floor); the flash kernels' fp16 forms at [128, 4095,
   64] and [384, 2048, 128] (2 fp16 ulps + 2^-6 of the row's RMS; fp16 SDPA
   beside them) and the simple form in fp32 at [128, 4095, 64] (2 fp32 ulps +
   2^-14 of the larger of the row's and the tensor's RMS; its bound at 67
   TFLOP/s; fp32 SDPA beside it), and on its inputs the fp32
   backward on the tensor cores (``flash_f32_dq``, ``flash_f32_dkv``,
   3xTF32: the same rule, its bounds at 3xTF32's 165 TFLOP/s and at 67,
   the simple form's, the plain version's and SDPA's fp32 backward times
   from the same run beside it) and the fp32 forward there
   (``flash_f32_fwd``: o under the same rule, lse within 1e-4, its bounds
   at 165 and 67 TFLOP/s, the simple form's, the plain version's and
   SDPA's fp32 forward beside it), each output repeated bit for bit; the
   simple form at phase 30's [32, 1024, 256] in bf16 and fp32 (readings
   ``d256_bf16``, ``d256_f32``: SDPA's forward and backward at D 256
   beside it), on the fp32 inputs the fp32 forward in 3xTF32
   (``flash_f32_fwd``, reading ``d256_f32``: o under the fp32 rule, lse
   within 1e-4, bounds at 165 and 67 TFLOP/s) and the fp32 dq and dk/dv
   in 3xTF32 (``flash_f32_dq``, ``flash_f32_dkv``, reading ``d256_f32``:
   the fp32 rule, the simple form's times on the same inputs and SDPA's
   fp32 backward beside them, bounds at 165 and 67 TFLOP/s; again at
   phase 33's [64, 4096, 256], reading ``hd256_lm_f32``, the simple form
   and SDPA timed there) and at D 320 in bf16
   (``d320_bf16``) and fp32 (``d320_f32``, its bound at 67 TFLOP/s, SDPA
   fp32 beside it); the forward, dq and dk/dv at D 384 and 512
   (``flash_d512_fwd``, ``flash_d512_dq``, ``flash_d512_dkv``), in bf16
   and fp16, at [32, 1024, 320] (``d320_tc_bf16``, with the whole
   backward, ``d320_tc_f16``) and [16, 1024, 512] (``d512_tc_bf16``,
   ``d512_tc_f16``), the simple forward's, dq's and dk/dv's times on the
   same inputs beside them; the fp32 forward, dq and dk/dv there in
   3xTF32 (``flash_f32_d512_fwd``, ``flash_f32_d512_dq``,
   ``flash_f32_d512_dkv``) at [32, 1024, 320] (``d320_f32x``, with the
   whole backward) and [16, 1024, 512] (``d512_f32x``): the fp32 rule,
   lse within 1e-4, bounds at 165 and 67 TFLOP/s, the simple forward's,
   dq's and dk/dv's times on the same inputs and SDPA fp32's beside
   them; ``flash_bwd_dbias`` at [32, 1024, 256] and [32, 1024, 320]
   causal in bf16 (the wgmma kernel) and fp32 (3xTF32) and at ViT's
   [1536, 197, 64] in fp32 with dropout (``dbias_readings``: the dtype's
   flash rule, bit-for-bit repeats, the simple form's time on the same
   inputs, SDPA's backward with a learned [1, 1, Sq, Sk] mask beside it,
   bounds at 989 TFLOP/s and 3xTF32's 165); the D-256
   forward, dq and dk/dv (``flash_d256_fwd``,
   ``flash_d256_dq``, ``flash_d256_dkv``), in bf16 and fp16, at [32,
   1024, 256] (``d256_tc_bf16``, ``d256_tc_f16``: the simple form's times
   on the same inputs beside bf16's) and at phase 31's [64, 4096, 256]
   (``hd256_lm_bf16``, with the whole backward, and ``hd256_lm_f16``),
   under the flash rule, each output repeated bit for bit, bounds at 989
   TFLOP/s, SDPA beside them; the crossover again at head dim 256 ([32,
   S, 256]: the D-256 forward, dq and dk/dv against the plain path), which
   must win at every S from ``DEFAULT_FLASH_MIN_S``, as impl="auto" takes
   it; the bf16 kernels' outputs hashed at both shapes
   (``flash_bits``) and ``ln_bwd_wide``'s at [8192, 12288]
   (``ln_wide_bits``), to hold one package's against another's; the
   scalar tails beside the vector forms: ``ln_bwd`` at [32760, 1022], the
   wide kernels at [8192, 12290] (the one-pass backward's 2-wide loads) and
   [8192, 12289] (its scalar loads) and the welford passes at C 6 (and C
   8) over 256·56·56 rows.
3. dense — the serve_bench model at full width (8 layers, 1024 wide,
   8 heads, vocab 32768, bf16, random weights from ``torch.Generator``
   seed 0) behind ``ContinuousBatchingEngine(slots=8, max_len=1024,
   prefill_chunk=32)`` serving serve_bench's default traffic (32 Poisson
   requests at 8/s, prompts uniform 16-96, outputs uniform 8-48, seed 0).
   ``warmup()`` first (its seconds, the graphs captured and the graph
   pool's bytes printed); the run after it must capture none. Kernel launch
   counts are zeroed just before the run and read just after (a replay
   adds the launches its capture recorded).
4. paged — the same requests on the paged arena (page 32, half the pages
   of the dense reservation); token streams must equal phase 3's.
5. crosscheck — a 2-layer f32 model at the same widths: prefill hidden
   states and first decode-step logits (dense and paged) with the kernels
   against ``dispatch.backend("reference")`` on the card, atol 1e-4.
6. train — the RN50 AMP O2 FusedLAMB step of ``bench.py`` at full width
   (ResNet-50, 1000 classes, random weights from ``torch.Generator``
   seed 0) at ``examples/imagenet/main_amp.py``'s ImageNet shape, batch
   256 at 224×224, bf16, static loss scale 1.0, ``FusedLAMB(lr=1e-3)``,
   the same numpy batch every step (``bench.py:1269-1271``): 3 warm-up
   steps, then 10 timed steps (CUDA events per step, one synchronize
   around the window): img/s, step ms p50/p95, MFU against the H100's
   989 TFLOP/s bf16 dense peak, peak memory, first and last loss (finite
   and falling), one launch of ``scale`` and of each LAMB phase per step
   and one of each BN kernel per BN per step (53). Then two steps under
   ``torch.profiler``: device time by kernel family and the device's idle
   share.
7. overflow — the CI-size ResNet (``bench.py:1248``) under fp16 O2 with a
   dynamic scale: an inf written into one flat grad element before the
   unscale skips the step (masters, slots and step bitwise unchanged) and
   halves the scale 65536 -> 32768; a clean step after it advances.
8. train_crosscheck — the CI-size ResNet, three steps with the kernels
   against ``dispatch.backend("reference")`` with ``cudnn.deterministic``:
   in f32 O0 the masters within atol 5e-5 and the update within 1e-3 of
   its L2 norm; in bf16 O2 within 1.5 times bf16's own effect on them.
9. lm_train — ``tools/lm_bench.py``'s step at its defaults on one card
   (TransformerLM: vocab 32768, 8 layers, 1024 wide, 16 heads of 64,
   attention "fast", fused head in vocab chunks of 8192; random weights
   from ``torch.Generator`` seed 0; batch 8 × 4096 tokens, one numpy
   batch reused every step; O2 bf16 over fp32 flat masters,
   ``FusedAdam(lr=1e-4)``): 3 warm-up and 10 timed steps: tok/s
   (lm_bench's count, batch × 4096 a step), step ms p50/p95, MFU with
   lm_bench's FLOP model (6·P·tokens + 6·L·d·S²·B) against 989 TFLOP/s,
   peak memory, first and last loss (finite and falling), each kernel's
   launches per step (8 of each flash kernel, 17 of each LayerNorm
   kernel, one Adam); then two steps under ``torch.profiler``.
10. lm_crosscheck — a small LM (2 layers, embed 128, 2 heads of 64,
    vocab 512, S 257, batch 2), three O2 steps with the kernels against
    ``dispatch.backend("reference")`` (``adam_crosscheck``): step 1's
    flat gradient within 1.5 times bf16's own effect on it in mean and
    max, the masters after 3 steps so in mean (those with a
    rounding-level gradient left out: Adam moves them by about lr in
    every run); two kernel runs equal bit for bit.
11. imagenet_train — ``examples/imagenet/main_amp.py``'s step at its
    defaults on one card, at phase 6's full width and batch (ResNet-50,
    batch 256 at 224×224, so img/s compares with the LAMB step; main_amp's
    batch 64 is a CPU-smoke default): O2 bf16 (static scale 1.0),
    ``FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)``, one uint8 NHWC
    batch from ``np.random.RandomState(0)`` center-cropped from a 232×232
    pool (main_amp.py:367-370) and normalized inside the step: 3 warm-up
    and 10 timed steps, as phase 6 reads them; one ``sgd`` and one
    ``scale`` launch a step and one of each BN kernel per BN; losses
    finite, the first three falling and none above 4 times the first
    (main_amp's lr 0.1 has no warm-up, so on one repeated batch the step
    overshoots after a few steps); then two profiled steps, one
    ``evaluate`` (top-1, top-5), and the witness: the same 13 steps from
    the same init under the plain versions, whose first 4 losses must be
    within 1e-2 relative of the kernel path's and whose last must be 1.25
    times its least (the overshoot is the step's, not the kernels').
12. imagenet_larc, imagenet_novograd — the same step under
    ``LARC(FusedSGD)`` (two ``rowsumsq`` launches a step) and under
    ``FusedNovoGrad(lr=1e-2)`` with L2 norms (one ``rowsumsq``) and
    L-inf norms (one ``rowmaxabs``), one ``novograd`` a step: 3 warm-up
    and 5 timed steps each; losses finite and the last below the
    first.
13. imagenet_crosscheck — the CI-size ResNet on a uint8 batch, three
    steps with the kernels against ``dispatch.backend("reference")``
    for FusedSGD, LARC and FusedNovoGrad (L2 and L-inf), at O0 and O2,
    with phase 8's bars (O2 losses within 5e-3 or 1.5 times bf16's own
    effect on them, whichever is larger: at lr 0.1 a rounding moves the
    next loss further than LAMB's lr 1e-3 does); two kernel runs equal
    bit for bit, none launched in the plain runs.
14. seq2seq_train — ``examples/seq2seq/train_translation.py``'s step at
    Transformer-base width on one card (``Seq2SeqTransformer``: 6 + 6
    layers, 512 wide, 8 heads of 64, FFN 2048, shared vocabulary 37000,
    attention "fast", dropout 0; random weights from ``torch.Generator``
    seed 0): its make_batch at batch 128 × 128 (sources 64-128 tokens,
    padded; ``RandomState(0)``), O2 bf16 over fp32 flat masters through
    ``LMTrainer``, label smoothing 0.1, ``FusedAdam(5e-4, (0.9, 0.98),
    1e-9)``: 3 warm-up and 10 timed steps: target tokens a second (the
    non-pad targets, fairseq's wps) and all token slots a second, step ms
    p50/p95, MFU from an analytic FLOP count (``s2s_flops``) against 989
    TFLOP/s, peak memory, each kernel's launches a step (one of each xent
    kernel, 18 of each flash kernel, 32 of each LayerNorm kernel, one
    Adam), two profiled steps; losses finite, the first near ln 37000,
    the first three falling; the plain witness (3 steps from the same
    init under the plain versions, no kernel launched, losses within 1e-4
    relative of the kernel path's).
15. seq2seq_decode — ``greedy_decode`` of 8 held-out sources
    (``RandomState(1234)``) to 130 tokens with the trained masters in
    bf16: decoded tokens a second; BOS first and only PAD after EOS; the
    first step's logits within atol 1e-2 of the plain versions' on the
    same encoder memory, and through the whole path (the encoder's flash
    kernels too) within 2 bf16 ulps of the largest logit; the plain
    path's greedy streams decoded beside them and their agreement
    reported.
16. seq2seq_crosscheck — a small Seq2Seq Transformer (2 + 2 layers,
    embed 256, 4 heads of 64, vocab 1000, source length 64, batch 8,
    ragged), phase 10's ``adam_crosscheck`` with the translation step's
    Adam and label smoothing.
17. lm_accum — ``examples/lm/train_ring.py``'s accumulation
    (``--grad-accum 2 --loss-scale dynamic``) on phase 9's model and batch
    through ``LMTrainer(microbatches=2, loss_scale="dynamic")``: step 1's
    accumulated flat grad within 1.5 times bf16's own effect (the
    one-batch grad against the plain fp32 one) of phase 9's one-batch
    grad from the same masters, in mean and max; 3 warm-up and 10 timed
    steps as phase 9 reads them (tok/s, step ms, MFU with phase 9's FLOP
    model, peak memory, below phase 9's), 2 ``axpby`` and 1 Adam launches
    a step and each model kernel twice phase 9's; losses finite, the
    first three falling; an inf in microbatch 2 alone leaves masters,
    slots and step bit for bit, halves the scale, counts one overflow.
18. fp16opt_adagrad — the legacy path on the same model and batch:
    ``FP16_Optimizer(FusedAdagrad(lr=1e-4, model_dtype=bf16),
    dynamic_loss_scale=True)``, each step the grads of the scaled loss
    with respect to the bf16 param tree, ``clip_master_grads(1.0)`` and
    ``step``: 3 warm-up and 5 timed steps (tok/s, step ms, each step's
    norm and clip coefficient, the norm within 1e-5 of the plain
    version's on the same grads); 1 ``l2norm``, 1 ``adagrad`` and 1 +
    leaves ``scale`` launches a step; losses finite and falling; an inf
    in one leaf's grad skips the step and ``last_culprits`` names it.
19. fp16opt_crosscheck — phase 10's small LM at batch 4 under
    ``crosscheck`` (phase 10's bars): ``LMTrainer(microbatches=2,
    loss_scale="dynamic")``, and ``FP16_Optimizer(FusedAdagrad)`` with
    clipping in both weight-decay modes.
20. vit_train — ``examples/imagenet/main_amp.py --arch vit_b16 --dropout
    0.1`` at its defaults otherwise on one card (``vit_b16``: patch 16, 12
    layers of 768, 12 heads of 64, FFN 3072, 197 tokens; random weights
    from ``torch.Generator`` seed 0), batch 128 at 224² (phase 11's uint8
    batch and normalization), O2 bf16, FusedSGD(0.1, 0.9, 1e-4), attention
    "auto" (the flash kernels from S 128), per-layer dropout seeds drawn
    each step from the Trainer's generator: 3 warm-up and 10 timed steps
    (img/s, step ms p50/p95, MFU from ``models.vit.analytic_flops`` against
    989 TFLOP/s, peak memory), two profiled steps, ``evaluate``; 12 of
    each flash kernel, 25 of each LayerNorm kernel, one ``scale`` and one
    ``sgd`` launch a step; losses finite, the first within 0.5 of ln 1000,
    none above 4 times the first; the witness: the same 13 steps under
    the plain versions (the same masks: the same hash and seeds), no
    kernel launched, the first 4 losses within 1e-2 relative.
21. vit_crosscheck — a small ViT (2 layers of 256, 4 heads of 64, 65
    tokens, attention "fast", dropout 0.1), three O2 SGD steps with the
    kernels against the plain versions: masters within 1.5 times bf16's
    own effect (the plain O2 masters against the plain O0 ones) in mean
    and max; two kernel runs bit-equal.
22. flash_bias — the public ``flash_attention`` with a learned fp32
    bias: at [1536, 197, 64] with dropout 0.1 in bf16, [1, 197, 197] (one
    launch of ``flash_bwd_dbias``) and [1536, 197, 197] (dq's dS), and
    [1, 197, 197] in fp32; a shared [1, 1024, 1024] causal at [16, 1024,
    256] fp32 and [16, 1024, 320] bf16: o, dq, dk, dv and dbias against
    the plain versions under the dtype's flash rule, one launch of each
    form's wrapper and none of the simple form's.
23. bn_reduce — ``bn_backward_reduce`` as its users call it, the
    reduce_bn pass from a materialized xhat, once per BN of the RN50 step
    (53 launches, bf16 at their shapes), counts zeroed just before.
24. wide_lm_train — ``tools/lm_bench.py --dim 12288 --heads 96 --layers 1
    --seq 2048 --vocab 32768`` on one card (GPT-3 175B's width: 96 heads
    of 128, FFN 49152; one layer of its 96, so that 2.24e9 parameters'
    fp32 masters, Adam state and flat grad fit; attention "fast", fused
    head in chunks of 8192; random weights from ``torch.Generator`` seed
    0), O2 bf16, FusedAdam(lr=1e-4), batch 4 × 2048: 3 warm-up and 10
    timed steps (tok/s, step ms p50/p95, MFU by phase 9's FLOP model,
    peak memory), two profiled steps; 3 launches of each wide LayerNorm
    kernel a step, none of the one-pass ones, one of each flash kernel
    and one Adam; losses finite, the mean of the last 3 below the first.
25. wide_lm_crosscheck — a one-layer LM with rows over 8192 (embed 8320,
    65 heads of 128, vocab 512, S 128, batch 2) under phase 10's
    ``adam_crosscheck``, its kernel runs through the wide LayerNorm
    kernels only.
26-27. lm_serve_dense, lm_serve_paged — lm_bench's LM (8 × 1024, 16
    heads of 64, vocab 32768, bf16, random weights from seed 0) behind
    phases 3-4's engines and requests: every decode step by the split
    kernel and its merge (8 launches each a step); paged streams equal
    to dense. Every serving phase also profiles one run of 8 requests
    (device time by family, the idle share).
28. lm_train_f16 — phase 9's model and batch under O2 in fp16
    (``half_dtype=float16``, dynamic loss scale): 3 warm-up and 5 timed
    steps and one profiled; the flash kernels' fp16 forms, 8 launches of
    each a step; losses finite, the mean of the last 3 below the first.
29. lm_train_f32 — the same in fp32 (O0, lm_bench's ``--dtype f32``),
    full batch: 2 warm-up and 3 timed steps, one profiled; the fp32
    forward and backward on the tensor cores (``flash_f32_fwd``,
    ``flash_f32_dq``, ``flash_f32_dkv``), 8 launches of each a step, none
    of the simple form's.
30. tails_train — ``FusedLayerNorm(1022)`` over [16, 2048, 1022] bf16,
    ``SyncBatchNorm(6, fuse_relu=True)`` over [64, 6, 56, 56] bf16 with a
    residual, ``flash_attention`` at head dim 256 over [32, 1024, 256]
    fp32 (the 3xTF32 forward, dq and dk/dv) and at head dim 320 over [16,
    1024, 320] bf16 (the forward, dq and dk/dv at D 384,
    ``flash_d512_fwd``, ``flash_d512_dq`` and ``flash_d512_dkv``) and fp32
    (the 3xTF32 forward, dq and dk/dv at D 384, ``flash_f32_d512_fwd``,
    ``flash_f32_d512_dq`` and ``flash_f32_d512_dkv``), 3 forward/backward
    passes each against the plain versions.
31. lm_train_hd256 — ``tools/lm_bench.py --dim 2048 --heads 8`` (8
    layers of 2048, 8 heads of 256: Gemma 2B's attention shape; vocab
    32768, S 4096, batch 8, attention "fast", random weights from seed 0),
    O2 bf16, FusedAdam(1e-4): 3 warm-up and 5 timed steps, one profiled;
    8 launches a step of ``flash_d256_fwd``, ``flash_d256_dq`` and
    ``flash_d256_dkv``, none of the simple form's; losses finite, the mean
    of the last 3 below the first.
32. lm_hd256_crosscheck — a small LM at head dim 256 (2 layers, embed
    512, 2 heads of 256, vocab 512, S 256) under phase 10's
    ``adam_crosscheck``.
33. lm_train_hd256_f32 — phase 31's LM in fp32 (O0, lm_bench's
    ``--dtype f32 --dim 2048 --heads 8``): 2 warm-up and 3 timed steps,
    one profiled; 8 launches a step of ``flash_f32_fwd``, ``flash_f32_dq``
    and ``flash_f32_dkv``, none of the simple form's or the 16-bit
    kernels'; losses finite, the mean of the last 3 below the first; MFU
    against 67 TFLOP/s.
34. dcgan_o1 — ``examples/dcgan/main_amp.py`` at its defaults on one card
    (``DCGANTrainer`` over ``models.DCGAN``: nz 64, ngf 32, ndf 32, batch
    32 of 32×32×3 NHWC images; random inits from seeds 1 and 2; O1 bf16,
    three loss scalers, two ``FusedAdam(2e-4, (0.5, 0.999))``; the
    example's data stream, ``RandomState(0)`` normal reals and latents,
    made before the first step): 3 warm-up and 50 timed steps (steps and
    images a second, step ms p50/p95), five profiled (device time by
    family, the idle share); 3 ``scale`` and 2 ``adam`` launches a step;
    losses finite; with cuDNN deterministic, 3 steps from the same masters
    with the kernels (O1 twice, bit for bit; O0) and the plain versions
    (O1, O0; no kernel launched): step 1's unscaled D and G grads, O1
    against O0, within 1.5 times the plain versions' gap (bf16's own
    effect) in mean and max, the masters within 1.5 times bf16's own effect
    of the plain run's (phase 8's bar); an inf in loss 1's grad at step 2
    of a dynamic-scale run leaves D's masters and slots bit for bit,
    halves scaler 1 alone (65536 -> 32768), lets G update and is named by
    scaler 1's census; the final G grads' underflow census equals a
    recount on the host.
35. lm_train_remat — ``tools/lm_bench.py --remat`` at phase 9's width and
    batch with ``--remat-policy nothing_saveable`` and ``dots_saveable``:
    step 1's flat grad equal bit for bit to phase 9's one-batch grad from
    the same masters; 3 warm-up and 10 timed steps read as phase 9's
    (tok/s, step ms, MFU by phase 9's FLOP model, peak memory below phase
    9's), one profiled; each forward kernel inside the blocks twice a
    layer (``flash_fwd`` 16, ``ln_fwd`` 33 a step), the backward kernels
    and Adam as phase 9's; losses finite and falling. Then lm_remat_o1:
    phase 10's small LM with ``remat=True`` under ``amp.initialize(
    lm.loss, opt_level="O1")``: the fp32 flash forms launched and the bf16
    ones not, every LayerNorm given fp32 rows, fp32 grads within 1.5 times
    bf16's own effect of the O0 grads (kernels against the plain
    versions' gap); and remat_models: phase 21's small ViT and phase 16's
    small Seq2Seq, one O2 grad with and without remat (both policies),
    equal bit for bit.
36. serve_spec — phase 3's model and traffic with ``spec_k=3`` and
    ``draft_from_prefix(model, params, 4)`` (serve_bench's half depth),
    dense and on phase 4's pages: each step the draft's 2-row catch-up and
    the target's 4 rows through the multi-row kernel (one launch a layer),
    the draft's other 2 steps through the 1-query kernel; paged streams
    equal to dense; tok/s, decode step, TTFT and token latency beside phase
    3's, the acceptance histogram and mean. Then the fp32 parity gate on the
    same widths (``serve_spec_parity``, 16 of the requests): speculative
    greedy streams equal plain greedy, dense and paged; the self-draft's
    mean acceptance exactly 3; a temperature-0.9 run replays its tokens and
    histogram; ``row_invariant``: whether one layer's fp32 products give the
    first S rows the same bits at M = S and M = 4S.
37. serve_prefix — phase 4's paged engine with ``prefix_share=True`` over
    phase 3's requests behind one seeded 256-token system prompt (8 pages
    of 32): streams equal to a no-share paged run and a dense run, fewer
    prefill chunks, hits, every page given back but the cache's own holds;
    TTFT of the hit requests against the same requests unshared.
38. generate_sampling, mlp — ``generate`` on phase 3's model (batch 8,
    prompt 64, 64 new tokens, temperature 0.8, top-k 50, top-p 0.9, key 0):
    replays, every sampled token in its step's filtered set (a replay of
    the same calls, filtered on the CPU), ``top_k=1`` equal to greedy on
    the same weights in fp32 (bf16 logits tie at the largest, and top-k
    keeps ties: the tied rows are counted); then
    ``MLP([480, 1024, 1024, 512, 256, 1])`` forward and backward at batch
    1024 against an fp64 CPU run, output and every gradient: relu's error
    norm within 1e-4 of the value's (a relu input at rounding distance
    from 0 moves one sample's share of an element), sigmoid's every
    element within 1e-5 of the largest.
39. serve_graphs — one row for each of phase 3's, 4's, 36's dense and paged
    and 37's sharing engine (``config`` dense, paged, spec_dense,
    spec_paged, prefix_share), printed right after that phase's run on the
    same engine and requests: ``warmup()``'s seconds, graphs and graph-pool
    bytes; 0 captures in the runs after it (a check); the streams of the
    same requests under ``programs.eager()`` equal token for token (a
    check); each program's launches a replay equal to its eager call's (a
    check); the spec dense acceptance histogram equal (a check; the paged
    one is exempt: rows past a request's reservation read the null page,
    which other slots write); decode step p50/p95, decode tok/s and TTFT
    of both arms on the Poisson requests, and their profiled idle share on
    8 requests all arriving at once (the serving loop without the wait for
    arrivals; the captured arm's over the Poisson arrivals is its phase's
    ``profile_8_requests``). Then ``serial_fp32``, in phase 36's fp32
    section: the serialized engine (``fused=False``) at phase 3's widths
    in fp32 on 16 requests, its greedy streams equal to the fused
    engine's (a check), its step p50 beside the fused one's.
41. serve_router — run before phase 40's line, whose launches include
    it: phase 3's model and traffic shape (serve_bench's router defaults:
    64 Poisson requests at 8/s, prompts 16-96, outputs 8-48, seed 0) behind
    ``serve.router.Router`` (least-queue), every engine warmed first. One
    row an arm: in process, ``EngineReplica`` threads each on its own CUDA
    stream, the Poisson requests at 1 and 2 replicas (``poisson_1``,
    ``poisson_2``) and the same 64 all at t=0 (``saturated_1``,
    ``saturated_2``); ``live_2``, 16 requests with each replica's
    ``LiveEmitter`` streaming to a ``LiveCollector`` on localhost TCP, an
    ``AdmissionController(shed=True)`` attached, and ``shed_2``, the 64
    after ``trip("occupancy_min", replica=1)``, with an ``admission`` row
    (the collector's step samples from both replicas); then the socket
    transport: a ``RouterServer`` and 2 child processes, each on a
    ``ReplicaClient`` (``socket_2``, the saturated 64), and a second
    session where rank 1 exits after acking 2 retirements
    (``socket_kill``). Each row: the card's name and power limit
    (``card``), completed, shed, dropped (0, a check),
    streams equal to a plain engine run of the same requests (a check;
    in the kill arm every re-routed request's), captures after warmup (0,
    a check), launches equal to the replicas' replays × each program's
    launches a replay (a check), decode tok/s over the wall from the
    router's start to the last completion, each replica's hot-loop decode
    tok/s, TTFT and token latency, ``routed_balance``, and the card's
    busy time (the union of every traced device activity, so concurrent
    streams count once), its sum and idle share over the arm. Every shed
    row names its rule and replica (a check); the kill arm re-routes at
    least one request and completes all (a check). Last, the
    ``serve_router_saturated`` row: decode tok/s at 1 thread, 2 threads
    and 2 processes with the card's name and power limit.
42. telemetry — run before phase 40's line, whose launches include its
    in-process runs. (a) ``telemetry_serve``: phase 3's engine, warmed,
    on serve_bench's 64 requests all at t=0, four runs in turns: plain,
    armed (a ``MetricsLogger``, ``SpanTracer``, ``SLOMonitor`` with a
    deliberately tight ``step_ms_p50`` rule and ``FlightRecorder``),
    telemetry alone, plain; streams equal (a check), 0 captures after
    warmup (a check), one ``step`` record a decode step (a check), every
    record read back by ``read_sidecar`` (a check), the rule's alert
    dumping a flight-recorder file that ``read_dump`` reads (a check);
    decode step p50 of each run and the host cost of one ``log_step``.
    (b) ``serve_bench``: ``tools/serve_bench_torch.py`` at its defaults
    (64 Poisson requests at 8/s, 8 slots) with ``--paged --parity
    --telemetry --trace --slo --flightrec``, its JSON line printed, its
    sidecar read back (a check). (c) ``decode_bench``:
    ``tools/decode_bench_torch.py`` at its defaults (P 512, N 128, batch
    8) and with ``--fused``, both lines printed. (d) ``dcgan_fit``:
    ``DCGANTrainer.fit`` at phase 34's shape for 20 steps with a logger
    and an SLO monitor: 3 ``amp`` and 2 ``step`` records (a check). (e)
    ``telemetry_sync``: 64 ``log_step`` calls with CUDA scalars under
    ``torch.cuda.set_sync_debug_mode("error")`` (none syncs, a check), a
    logged tensor changed in place after the call (its logged value
    survives, a check), then one ``flush`` fetching all 128 scalars in one
    device-to-host copy (profiled, a check). Sidecars, traces and dumps
    go to a temporary directory.
43. data_parallel — run before phase 40's line, whose launches include
    (a)'s. (a) ``ddp_world1``: an NCCL group of world size 1 (a
    ``file://`` store), bench.py's ``--zero ddp`` step (``DDPTrainer``,
    the BNs converted to SyncBatchNorm over ``"data"``) at phase 6's
    width (RN50, batch 256 at 224², O2 bf16, FusedLAMB 1e-3) for 3 steps
    against ``Trainer``'s plain step from the same init and batch:
    masters, BN state and losses bit-equal (a check), 53 launches of each
    BN kernel a step (a check), 108 collectives a step (a check); 5 timed
    steps (img/s, step p50, MFU, peak memory, the state's bytes); then
    the ``--zero zero`` step (``ZeROTrainer``) at 1 shard: masters within
    ``DP_ZERO_ATOL`` of FusedLAMB's (a check), 5 timed; then the plain
    step's 3 steps at O0, the fp32 reference of (b). (b) ``ddp_2ranks``:
    two children of this script (``--ddp-rank``, started by the port's
    ``launch.multiproc``) on the one card try NCCL once (what it says is
    printed: it refuses two ranks on one device), then run over gloo on
    CUDA tensors, each on half the batch, the built kernels loaded (a
    rebuild is a failure): ddp then zero at 2 shards at O2, then both at
    O0, then the control, ddp at O0 with the BNs left local. Checks: every
    arm's ranks bit-equal; at O0 step 1's averaged grad within
    ``DP_REORDER_FACTOR`` times fp32's own effect (world 1's grad of the
    batch with its halves swapped) of (a)'s O0 grad and its loss within
    ``DP_STEP1_LOSS``, the control's outside that bar, and
    zero's first update within ``DP_ZERO_ATOL`` of FusedLAMB's from the
    same grads; each
    zero rank's state half of ddp's, and the device memory its trainer
    holds no more than that state; the gaps after 3 steps are printed.
    (c)
    ``groups_4ranks``: four children, the CI ResNet
    with ``create_syncbn_process_group(2)``, one forward: the stem BN's
    statistics equal within each pair, apart across, and within 1e-5 of
    BN over the pair's joined batch (checks).
44. model_parallel — run before phase 40's line, whose launches include
    (a)'s and (b)'s. (a) ``moe_lm``: lm_bench's ``--moe-experts 4
    --moe-every 2`` LM (8 × 1024, 8 heads of 128, S 2048, batch 8) under
    ``LMTrainer`` (O2 bf16, FusedAdam) at ``moe_top_k`` 1 and 2: 3 steps
    (losses finite and falling, the dropped fraction in [0, 1), checks),
    5 timed (tok/s, p50, peak; no MFU); then a small MoE LM's
    kernels-vs-plain ``crosscheck`` at top 1, 2 and 4 (step 1's grad
    held at each, the masters after 3 steps at top 4; at top 1 and 2
    printed beside the tokens that changed expert). (b) ``moe_serve``:
    serve_bench's model with those MoE layers in bf16, 16 requests at
    once, dense and paged engines: 0 captures after ``warmup()``,
    captured == ``programs.eager()``, paged == dense, and in fp32 the
    engine's greedy streams == ``generate``'s (checks); decode step p50
    and tok/s. (c) two children (``--mp-rank``, through
    ``launch.multiproc``, gloo over CUDA tensors, the kernels loaded, a
    rebuild a failure): train_ring's step (``SeqParallelTrainer``) at
    phase 9's LM, 2048 tokens a rank: fp32 step 1 within
    ``MP_REORDER_FACTOR`` times fp32's own effect on world 1's grad, and
    three planted faults outside that bar (checks), then 3 bf16 steps;
    Ulysses at [8, 16, 2048 a rank, 64] under the flash rule; GPipe over 2
    stages of that LM's blocks against the serial stack; (a)'s LM with
    its experts split over the ranks against the dense one.
40. the ``{"kernels": [...], "off_path": [...]}`` line (42 kernels; dq's
    and dk/dv's entries also carry their ``wide`` reading and the whole
    backward's, ``backward``, at both shapes, the D-256 ones the whole
    backward at [64, 4096, 256]; the fp32 ones their readings at D 256;
    ``flash_bwd_dbias`` its readings at D 256, 320 and ViT's fp32; the
    multi-row entries their fp32 and hd-64 readings and the JAX layout's
    times; ``off_path``: the simple forward, dq, dk/dv and shared-bias
    gradient, which no path takes, with their phase-2 readings and 0
    launches), then the ``ok`` line.

Times are CUDA-event medians of single calls with the L2 cache flushed
before each and the stream held busy, so host launch time is not counted.
Bounds use the H100 SXM's published 3.35 TB/s and 67 TFLOP/s (fp32,
outside the tensor cores), 989 TFLOP/s bf16 dense for the flash
kernels' products and a third of its 495 TFLOP/s TF32 dense for the fp32
kernels' 3xTF32 products; MFU its 989 TFLOP/s bf16 dense.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
BF16_DENSE_OPS_S = 989e12
# fp32 products in 3xTF32: three TF32 products (495 TFLOP/s dense on the
# tensor cores) for each
TF32X3_OPS_S = 495e12 / 3

TOL = {"float32": (1e-5, 1e-5),        # atol, rtol: order of fp32 sums
       "bfloat16": (1e-2, 1e-2)}       # one bf16 rounding of the output


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_table(log: str) -> dict:
    """Registers a thread, spill bytes and static shared memory of each
    kernel of the build, by its mangled name, from ptxas's report."""
    table, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("spill_bytes", r"(\d+) bytes spill stores"),
                         ("smem_bytes", r"(\d+) bytes smem")):
            got = re.search(pat, ln)
            if name and got:
                table.setdefault(name, {})[key] = int(got.group(1))
    return table


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# -- timing --------------------------------------------------------------

class Timer:
    """Median GPU time of one call: an L2-sized buffer is cleared before
    each call (the serving path finds K/V cold: seven other layers run in
    between), and a sleep kernel keeps the stream busy while the host
    enqueues the timed call.

    The card's host shares its cores, so an enqueue can outlast the sleep
    and the work queued before it; the card then idles between the events,
    which time the host. A rep whose first event the card had reached
    before the host finished enqueuing is dropped and made again with the
    sleep doubled, up to ``MAX_SLEEP`` times the first; a rep enqueued in
    under a quarter of its sleep halves it for the next. A call that waits
    on the card itself outlasts any sleep: it is told apart on its first
    dropped rep (``_waits_on_card``) and timed as it comes. ``calls``,
    ``redone``, ``waiting`` (calls told so) and ``seconds`` (host time in
    the calls) count what the timer did."""

    SLEEP_CYCLES = 2_000_000
    MAX_SLEEP = 256
    PROBE_SLEEP = 10

    def __init__(self, torch, reps: int = 25):
        self.torch = torch
        self.reps = reps
        self.calls = self.redone = self.waiting = 0
        self.seconds = 0.0
        self.flush = torch.empty(256 << 20, dtype=torch.uint8,
                                 device="cuda")
        # the sleep's cycles per ms of this card, to tell an enqueue's
        # host time against the sleep's length
        torch.cuda._sleep(self.SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(4 * self.SLEEP_CYCLES)
        b.record()
        torch.cuda.synchronize()
        self.cycles_per_ms = 4 * self.SLEEP_CYCLES / a.elapsed_time(b)

    def _enqueue_ms(self, fn, cycles: int) -> float:
        t0 = time.perf_counter()
        if cycles:
            self.torch.cuda._sleep(cycles)
        fn()
        return (time.perf_counter() - t0) * 1e3

    def _waits_on_card(self, fn) -> bool:
        """Whether fn's enqueue lengthens by the work queued ahead of it:
        the fewest ms of two enqueues behind a ``PROBE_SLEEP``-fold sleep
        against the fewest of two behind none. A host that is merely slow
        lengthens both."""
        probe = self.PROBE_SLEEP * self.SLEEP_CYCLES
        behind, alone = [], []
        for _ in range(2):
            for cycles, got in ((probe, behind), (0, alone)):
                got.append(self._enqueue_ms(fn, cycles))
                self.torch.cuda.synchronize()
        return min(behind) - min(alone) > probe / self.cycles_per_ms / 2

    def __call__(self, fn) -> float:
        torch = self.torch
        t_call = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        cycles, guard = self.SLEEP_CYCLES, None
        pairs = []
        while len(pairs) < self.reps:
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            enqueue_ms = self._enqueue_ms(
                lambda: (a.record(), fn(), b.record()), cycles)
            if a.query() and cycles < self.MAX_SLEEP * self.SLEEP_CYCLES:
                if guard is None:
                    guard = not self._waits_on_card(fn)
                    self.waiting += not guard
                if guard:
                    self.redone += 1
                    cycles *= 2
                    continue
            elif (enqueue_ms < cycles / self.cycles_per_ms / 4
                  and cycles > self.SLEEP_CYCLES):
                cycles //= 2
            pairs.append((a, b))
        torch.cuda.synchronize()
        self.calls += 1
        self.seconds += time.perf_counter() - t_call
        return statistics.median(a.elapsed_time(b) for a, b in pairs)


def host_us(torch, fn, n: int = 500) -> float:
    """Host time of one call (enqueue only), microseconds: the cost a
    host-bound eager loop pays per call."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def max_err(got, want, dtype_name: str):
    atol, rtol = TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= atol + rtol * w.abs()).all())
    return float(err.max()), ok


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_S):
    """The least time (ms) for ``nbytes`` of device memory traffic and
    ``ops`` operations at ``ops_per_s`` (fp32 outside the tensor cores
    unless the work is bf16 tensor-core products), and which one binds."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# -- phase 2: each kernel against its plain version -------------------------

def kernel_phase(torch, timer):
    import torch.nn.functional as F

    from apex_tpu_torch.ops import decode_attn as DA
    from apex_tpu_torch.ops import layer_norm as LN

    gen = torch.Generator(device="cuda").manual_seed(1)
    S, H, HD, L, PAGE = 8, 8, 128, 1024, 32
    max_pages = L // PAGE
    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        es = torch.tensor([], dtype=dt).element_size()
        lengths = torch.tensor([1, 1024, 17, 300, 512, 77, 999, 640],
                               dtype=torch.int32, device="cuda")
        q = torch.randn(S, H, HD, generator=gen, device="cuda").to(dt)
        k = torch.randn(S, H, L, HD, generator=gen, device="cuda").to(dt)
        v = torch.randn(S, H, L, HD, generator=gen, device="cuda").to(dt)
        lens = lengths.tolist()
        kv_bytes = sum(2 * n * H * HD * es for n in lens)
        io_bytes = 2 * S * H * HD * es + 4 * S
        ops = sum(n * H * (4 * HD + 5) for n in lens)

        # dense
        got = DA.decode_attention(q, k, v, lengths)
        want = DA.decode_attention_plain(q, k, v, lengths)
        torch.cuda.synchronize()
        err, ok = max_err(got, want, name)
        check(ok, f"decode_attention {name}: max abs err {err}")
        check(torch.equal(DA.decode_attention(q, k, v, lengths), got),
              f"decode_attention {name}: two runs differ")
        mask = (torch.arange(L, device="cuda")[None, None, None, :]
                < lengths[:, None, None, None])
        b_ms, b_by = bound(kv_bytes + io_bytes, ops)
        row = dict(
            kernel="decode_attention", dtype=name, shape=[S, H, L, HD],
            lengths=lens, max_abs_err=err, tol=TOL[name],
            ms=timer(lambda: DA.decode_attention(q, k, v, lengths)),
            plain_ms=timer(lambda: DA.decode_attention_plain(q, k, v,
                                                             lengths)),
            library_ms=timer(lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], k, v, attn_mask=mask)),
            bound_ms=b_ms, bound_by=b_by,
            host_us=host_us(torch, lambda: DA.decode_attention(
                q, k, v, lengths)),
            library_host_us=host_us(
                torch, lambda: F.scaled_dot_product_attention(
                    q[:, :, None, :], k, v, attn_mask=mask)))
        emit({"phase": "kernels", **row})
        rows[("decode_attention", name)] = row

        # paged: the same logical K/V behind a shuffled page table; the
        # unmapped entries point at the null page 0, which holds garbage
        n_phys = 1 + S * max_pages
        perm = torch.randperm(n_phys - 1, generator=gen,
                              device="cuda").to(torch.int32) + 1
        table = torch.zeros(S, max_pages, dtype=torch.int32, device="cuda")
        kp = torch.full((n_phys, H, PAGE, HD), 30.0, device="cuda").to(dt)
        vp = torch.full((n_phys, H, PAGE, HD), -30.0, device="cuda").to(dt)
        nxt = 0
        for s, n in enumerate(lens):
            for lp in range(-(-n // PAGE)):
                phys = int(perm[nxt])
                nxt += 1
                table[s, lp] = phys
                kp[phys] = k[s, :, lp * PAGE:(lp + 1) * PAGE]
                vp[phys] = v[s, :, lp * PAGE:(lp + 1) * PAGE]
        pages_read = sum(-(-n // PAGE) for n in lens)
        got_p = DA.paged_decode_attention(q, kp, vp, lengths,
                                          page_table=table)
        want_p = DA.paged_decode_attention_plain(q, kp, vp, lengths,
                                                 page_table=table)
        torch.cuda.synchronize()
        err, ok = max_err(got_p, want_p, name)
        check(ok, f"paged_decode_attention {name}: max abs err {err}")
        # one kernel body for both arenas: paged == dense, bit for bit
        check(torch.equal(got_p, got),
              f"paged_decode_attention {name} differs from the dense "
              f"kernel on the same bytes")
        b_ms, b_by = bound(kv_bytes + io_bytes + 4 * pages_read, ops)
        row = dict(
            kernel="paged_decode_attention", dtype=name,
            shape=[n_phys, H, PAGE, HD], lengths=lens, max_abs_err=err,
            tol=TOL[name],
            ms=timer(lambda: DA.paged_decode_attention(
                q, kp, vp, lengths, page_table=table)),
            plain_ms=timer(lambda: DA.paged_decode_attention_plain(
                q, kp, vp, lengths, page_table=table)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            host_us=host_us(torch, lambda: DA.paged_decode_attention(
                q, kp, vp, lengths, page_table=table)))
        emit({"phase": "kernels", **row})
        rows[("paged_decode_attention", name)] = row

        # LayerNorm: the decode step's rows (S) and a prefill chunk's
        # (S * 32), F = 1024, gamma/beta in the model's dtype
        for n_rows in (8, 256):
            f = 1024
            x = (torch.randn(n_rows, f, generator=gen, device="cuda") * 3
                 + 0.5).to(dt)
            w = (torch.randn(f, generator=gen, device="cuda") + 1).to(dt)
            b = torch.randn(f, generator=gen, device="cuda").to(dt)
            y, mean, inv = LN.ln_fwd(x, w, b, 1e-5)
            y0, mean0, inv0 = LN.ln_fwd_plain(x, w, b, 1e-5)
            torch.cuda.synchronize()
            err, ok = max_err(y, y0, name)
            check(ok, f"ln_fwd {name} rows={n_rows}: y max abs err {err}")
            for t, t0, what in ((mean, mean0, "mean"), (inv, inv0, "inv")):
                e, ok = max_err(t, t0, "float32")
                check(ok, f"ln_fwd {name} rows={n_rows}: {what} err {e}")
            b_ms, b_by = bound(n_rows * f * 2 * es + 2 * f * es
                               + 8 * n_rows, 8 * n_rows * f)
            row = dict(
                kernel="ln_fwd", dtype=name, shape=[n_rows, f],
                max_abs_err=err, tol=TOL[name],
                ms=timer(lambda: LN.ln_fwd(x, w, b, 1e-5)),
                plain_ms=timer(lambda: LN.ln_fwd_plain(x, w, b, 1e-5)),
                library_ms=timer(lambda: F.layer_norm(x, (f,), w, b,
                                                      1e-5)),
                bound_ms=b_ms, bound_by=b_by,
                host_us=host_us(torch, lambda: LN.ln_fwd(x, w, b, 1e-5)),
                library_host_us=host_us(
                    torch, lambda: F.layer_norm(x, (f,), w, b, 1e-5)))
            emit({"phase": "kernels", **row})
            rows[("ln_fwd", name, n_rows)] = row
    return rows


# -- phase 2, training kernels: scale and the two LAMB phases -----------------

def train_kernel_phase(torch, timer, table):
    """The training kernels over a flat buffer laid out by ``table`` (the
    RN50 master store), fp32 (and bf16 for scale)."""
    from apex_tpu_torch.ops import multi_tensor as MT

    gen = torch.Generator(device="cuda").manual_seed(4)
    T, R, S = table.total, table.total // 128, table.num_segments
    valid = table.valid_mask("cuda")
    rows = {}

    def randn(scale=1.0):
        return torch.randn(T, generator=gen, device="cuda") * scale * valid

    # scale: the unscale of a flat fp32 (and bf16) grad
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        es = torch.tensor([], dtype=dt).element_size()
        x = randn().to(dt)
        s = torch.full((), 0.3, device="cuda")
        got, inf = MT.scale(x, s)
        want, inf0 = MT.scale_plain(x, s)
        torch.cuda.synchronize()
        err, ok = max_err(got, want, name)
        check(ok and not bool(inf) and not bool(inf0),
              f"scale {name}: max abs err {err}, flags {bool(inf)}, "
              f"{bool(inf0)}")
        flags = {}
        for where, pos in (("first", 0), ("middle", T // 2),
                           ("last", T - 1)):
            y = x.clone()
            y[pos] = float("inf")
            flags[where] = bool(MT.scale(y, s)[1])
        check(all(flags.values()), f"scale {name}: inf not flagged {flags}")
        lib = x.clone()
        found = torch.zeros(1, device="cuda")
        b_ms, b_by = bound(2 * T * es + 8, 2 * T)
        row = dict(
            kernel="scale", dtype=name, shape=[T], max_abs_err=err, tol=0.0,
            bitwise=bool(torch.equal(got, want)), inf_flags=flags,
            ms=timer(lambda: MT.scale(x, s)),
            plain_ms=timer(lambda: MT.scale_plain(x, s)),
            # the library call takes fp32, fp16 and fp64 only
            library_ms=timer(
                lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                    [lib], found, s)) if dt == torch.float32 else None,
            bound_ms=b_ms, bound_by=b_by,
            host_us=host_us(torch, lambda: MT.scale(x, s)))
        check(err == 0.0, f"scale {name}: not exact ({err})")
        emit({"phase": "kernels", **row})
        rows[("scale", name)] = row

    # LAMB at FusedLAMB's defaults, step 3, decoupled weight decay
    g, p, m = randn(), randn(0.05), randn(0.01)
    v = randn(0.001).abs()
    step = torch.tensor(3, dtype=torch.int32, device="cuda")
    gnorm = torch.linalg.vector_norm(g)
    sc = MT.lamb_scalars(beta1=0.9, beta2=0.999, eps=1e-6, step=step,
                         bias_correction=True, weight_decay=0.01,
                         grad_averaging=True, global_grad_norm=gnorm,
                         max_grad_norm=1.0, device="cuda")
    got = MT.lamb_phase1(g, p, m, v, sc, 1)
    want = MT.lamb_phase1_plain(g, p, m, v, sc, 1)
    torch.cuda.synchronize()
    errs = {}
    for what, a, b in zip(("u", "m", "v", "prow", "urow"), got, want):
        errs[what], ok = max_err(a, b, "float32")
        check(ok, f"lamb_phase1 {what}: max abs err {errs[what]}")
    b_ms, b_by = bound(28 * T + 8 * R + 36, 20 * T)
    row = dict(
        kernel="lamb_phase1", dtype="float32", shape=[T], max_abs_err=max(
            errs.values()), errs=errs, tol=TOL["float32"],
        bitwise_umv=all(bool(torch.equal(a, b))
                        for a, b in zip(got[:3], want[:3])),
        ms=timer(lambda: MT.lamb_phase1(g, p, m, v, sc, 1)),
        plain_ms=timer(lambda: MT.lamb_phase1_plain(g, p, m, v, sc, 1)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        host_us=host_us(torch, lambda: MT.lamb_phase1(g, p, m, v, sc, 1)))
    emit({"phase": "kernels", **row})
    rows[("lamb_phase1", "float32")] = row

    u = got[0]
    ratio = torch.rand(S, generator=gen, device="cuda") * 1e-3
    row_seg = table.row_segment_ids("cuda")
    got2 = MT.lamb_phase2(p, u, ratio, row_seg)
    want2 = MT.lamb_phase2_plain(p, u, ratio, row_seg)
    torch.cuda.synchronize()
    err, ok = max_err(got2, want2, "float32")
    check(ok, f"lamb_phase2: max abs err {err}")
    row_ratio = ratio[row_seg.long()][:, None]
    p2, u2 = p.view(R, 128), u.view(R, 128)
    b_ms, b_by = bound(12 * T + 4 * R + 4 * S, 2 * T)
    row = dict(
        kernel="lamb_phase2", dtype="float32", shape=[T], max_abs_err=err,
        tol=TOL["float32"], bitwise=bool(torch.equal(got2, want2)),
        ms=timer(lambda: MT.lamb_phase2(p, u, ratio, row_seg)),
        plain_ms=timer(lambda: MT.lamb_phase2_plain(p, u, ratio, row_seg)),
        library_ms=timer(lambda: torch.addcmul(p2, row_ratio, u2,
                                               value=-1)),
        bound_ms=b_ms, bound_by=b_by,
        host_us=host_us(torch, lambda: MT.lamb_phase2(p, u, ratio,
                                                      row_seg)))
    emit({"phase": "kernels", **row})
    rows[("lamb_phase2", "float32")] = row

    # the whole two-phase step twice on the same inputs: bit for bit
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, step=step,
              weight_decay=0.01, mode=1, global_grad_norm=gnorm,
              max_grad_norm=1.0)
    a = MT.lamb_step(g, p, m, v, table, **kw)
    b = MT.lamb_step(g, p, m, v, table, **kw)
    same = all(bool(torch.equal(x, y)) for x, y in zip(a, b))
    emit({"phase": "kernels", "kernel": "lamb_step", "repeat_equal": same})
    check(same, "lamb_step: two runs on the same inputs differ")
    return rows


# -- phase 2, BatchNorm kernels: the welford passes at RN50's BN shapes -------

def rn50_bn_calls(model, batch: int, image: int) -> dict:
    """The training step's BN calls as ``{(rows, C, relu, z): count}``,
    walked like the model's ``apply`` (53 for ResNet-50)."""
    def up(n, s):
        return -(-n // s)

    calls = {}

    def add(h, c, relu, z):
        key = (batch * h * h, c, relu, z)
        calls[key] = calls.get(key, 0) + 1

    h = up(image, 2)
    add(h, model.width, True, False)                 # the stem
    h = up(h, 2)                                     # max pool
    cin = model.width
    for s, nblocks in enumerate(model.block_sizes):
        cmid = model.width * (2 ** s)
        cout = cmid * model.expansion
        for b in range(nblocks):
            stride = 2 if (s > 0 and b == 0) else 1
            hout = up(h, stride)
            if b == 0 and (stride != 1 or cin != cout):
                add(hout, cout, False, False)        # the projection
            add(h, cmid, True, False)                # bn1, before the stride
            add(hout, cmid, True, False)
            add(hout, cout, True, True)              # residual and relu
            cin, h = cout, hout
    return calls


def welford_kernel_phase(torch, timer, calls) -> dict:
    """Each welford pass against its plain version at every distinct BN
    shape of the RN50 step (bf16 rows; ``bn_backward_reduce`` from a bf16
    xhat), and one PyTorch library call that computes the same
    per-channel function (without the relu mask;
    ``batch_norm_backward_reduce``, which recomputes xhat, for both
    reduces); the kernels line takes each time summed over the step's 53
    BNs."""
    from apex_tpu_torch.ops import welford as WF

    gen = torch.Generator(device="cuda").manual_seed(6)
    es = 2
    totals = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                      bound_bytes=0.0, bound_ops=0.0, max_abs_err=0.0,
                      calls=0) for k in ("bn_moments",
                                         "bn_backward_fused_reduce",
                                         "bn_backward_dx",
                                         "bn_backward_reduce")}

    def close_sums(got, want, terms, what):
        bound_ = 1e-5 * terms.abs().sum(0) + 1e-6
        err = (got - want).abs()
        check(bool((err <= bound_).all()),
              f"{what}: sums off by {float((err / bound_).max())} of the "
              f"1e-5·Σ|terms| bound")
        return float(err.max())

    for (rows, c, relu, has_z), n in sorted(calls.items()):
        x = (torch.randn(rows, c, generator=gen, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        dy = torch.randn(rows, c, generator=gen, device="cuda").to(
            torch.bfloat16)
        out = torch.relu(torch.randn(rows, c, generator=gen,
                                     device="cuda")).to(torch.bfloat16) \
            if relu else None
        s0, sq0 = WF.bn_moments_plain(x)
        mean = s0 / rows
        invvar = torch.rsqrt(sq0 / rows - mean * mean + 1e-5)
        weight = torch.rand(c, generator=gen, device="cuda") + 0.5
        count = torch.full((1,), rows, dtype=torch.int32, device="cuda")
        shape = dict(rows=rows, C=c, relu=relu, z=has_z, per_step=n)

        # moments
        s, sq = WF.bn_moments(x)
        xf = x.float()
        err = max(close_sums(s, s0, xf, f"bn_moments {shape}"),
                  close_sums(sq, sq0, xf * xf, f"bn_moments {shape}"))
        del xf
        rec = dict(kernel="bn_moments", max_abs_err=err,
                   repeat_equal=bool(torch.equal(WF.bn_moments(x)[1], sq)),
                   ms=timer(lambda: WF.bn_moments(x)),
                   plain_ms=timer(lambda: WF.bn_moments_plain(x)),
                   library_ms=timer(lambda: torch.batch_norm_stats(x, 1e-5)),
                   bytes=rows * c * es + 8 * c, ops=3 * rows * c)
        check(rec["repeat_equal"], f"bn_moments {shape}: runs differ")
        recs = [rec]

        # backward reduce
        sd, sx = WF.bn_backward_fused_reduce(dy, x, mean, invvar, out)
        sd0, sx0 = WF.bn_backward_fused_reduce_plain(dy, x, mean, invvar,
                                                     out)
        dyf = WF._masked_dy(dy, out)
        err = max(close_sums(sd, sd0, dyf, f"bn_backward_fused_reduce "
                                           f"{shape}"),
                  close_sums(sx, sx0, dyf * ((x.float() - mean) * invvar),
                             f"bn_backward_fused_reduce {shape}"))
        del dyf
        streams = 3 if relu else 2
        recs.append(dict(
            kernel="bn_backward_fused_reduce", max_abs_err=err,
            ms=timer(lambda: WF.bn_backward_fused_reduce(dy, x, mean,
                                                         invvar, out)),
            plain_ms=timer(lambda: WF.bn_backward_fused_reduce_plain(
                dy, x, mean, invvar, out)),
            library_ms=timer(lambda: torch.batch_norm_backward_reduce(
                dy, x, mean, invvar, weight, True, True, True)),
            bytes=streams * rows * c * es + 16 * c,
            ops=(7 if relu else 6) * rows * c))

        # the reduce_bn pass from a materialized xhat, in dy's dtype
        xhat = ((x.float() - mean) * invvar).to(torch.bfloat16)
        rd, rx = WF.bn_backward_reduce(dy, xhat)
        rd0, rx0 = WF.bn_backward_reduce_plain(dy, xhat)
        dyf = dy.float()
        err = max(close_sums(rd, rd0, dyf, f"bn_backward_reduce {shape}"),
                  close_sums(rx, rx0, dyf * xhat.float(),
                             f"bn_backward_reduce {shape}"))
        del dyf
        again = WF.bn_backward_reduce(dy, xhat)
        rep = bool(torch.equal(again[0], rd)) and bool(
            torch.equal(again[1], rx))
        check(rep, f"bn_backward_reduce {shape}: runs differ")
        recs.append(dict(
            kernel="bn_backward_reduce", max_abs_err=err, repeat_equal=rep,
            ms=timer(lambda: WF.bn_backward_reduce(dy, xhat)),
            plain_ms=timer(lambda: WF.bn_backward_reduce_plain(dy, xhat)),
            library_ms=timer(lambda: torch.batch_norm_backward_reduce(
                dy, x, mean, invvar, weight, True, True, True)),
            host_us=host_us(torch, lambda: WF.bn_backward_reduce(dy, xhat),
                            n=100),
            bytes=2 * rows * c * es + 8 * c, ops=3 * rows * c))
        del xhat, again

        # backward dx (and dz where the BN carries the residual)
        args = (dy, x, mean, invvar, invvar * weight, sd0 / rows,
                sx0 / rows, out)
        dx, dz = WF.bn_backward_dx(*args, emit_dz=has_z)
        dx0, dz0 = WF.bn_backward_dx_plain(*args, emit_dz=has_z)
        err = float((dx.float() - dx0.float()).abs().max())
        same = bool(torch.equal(dx, dx0)) and (
            not has_z or bool(torch.equal(dz, dz0)))
        check(same, f"bn_backward_dx {shape}: not bit-equal to the plain "
                    f"version (max abs err {err})")
        recs.append(dict(
            kernel="bn_backward_dx", max_abs_err=err, bitwise=same,
            ms=timer(lambda: WF.bn_backward_dx(*args, emit_dz=has_z)),
            plain_ms=timer(lambda: WF.bn_backward_dx_plain(
                *args, emit_dz=has_z)),
            library_ms=timer(lambda: torch.batch_norm_backward_elemt(
                dy, x, mean, invvar, weight, sd0, sx0, count)),
            bytes=(streams + 1 + has_z) * rows * c * es + 20 * c,
            ops=(9 if relu else 8) * rows * c))

        for r in recs:
            b_ms, b_by = bound(r["bytes"], r["ops"])
            r.update(bound_ms=b_ms, bound_by=b_by)
            emit({"phase": "kernels", **r, **shape})
            t = totals[r["kernel"]]
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                t[k] += n * r[k]
            t["bound_bytes"] += n * r["bytes"]
            t["bound_ops"] += n * r["ops"]
            t["max_abs_err"] = max(t["max_abs_err"], r["max_abs_err"])
            t["calls"] += n
            if "host_us" in r:
                t["host_us"] = t.get("host_us", 0.0) + n * r["host_us"]
        del x, dy, out, dx, dz, dx0, dz0
    out = {}
    for k, t in totals.items():
        b_ms, b_by = bound(t["bound_bytes"], t["bound_ops"])
        row = dict(kernel=k, dtype="bfloat16", per="step of 53 BNs",
                   **{f: t[f] for f in ("ms", "plain_ms", "library_ms",
                                        "max_abs_err", "calls", "host_us")
                      if f in t},
                   bound_ms=b_ms, bound_by=b_by)
        emit({"phase": "kernels", **row})
        out[(k, "bfloat16")] = row
    return out


# -- phase 2, the LM training kernels: Adam, LayerNorm backward, flash --------

LM_SHAPE = dict(batch=8, seq=4096, embed=1024, heads=16, layers=8,
                vocab=32768)
# launches of each kernel in one LM training step: one flash forward, dq
# and dk/dv per layer; two LayerNorms per layer and the final one; Adam
LM_PER_STEP = {"flash_fwd": 8, "flash_bwd_dq": 8, "flash_bwd_dkv": 8,
               "ln_fwd": 17, "ln_bwd": 17, "adam": 1}
FLASH_CHECK_HEADS = 8     # heads held against the plain version


def storage_ulp(torch, t, dtype=None):
    """The spacing of ``dtype``'s values (t's own by default) at each
    element's magnitude: 2^(e - bits) for a normal value, and below the
    normal range the fixed spacing of the subnormals (fp16's 2^-24, where
    2^(e - bits) would give a spacing fp16 does not have)."""
    bits, tiny = {torch.bfloat16: (8, 2.0 ** -133),
                  torch.float16: (11, 2.0 ** -24),
                  torch.float32: (24, 2.0 ** -149)}[dtype or t.dtype]
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32),
                       e - bits).clamp_min(tiny)


def check_ln_bwd(torch, what, got, want, dy, x, w, mean, inv,
                 row_sums: bool = False) -> dict:
    """A LayerNorm backward against its plain version on the same inputs:
    dx within one ulp of its dtype plus 1e-5 of its terms' magnitude
    inv·(|dxhat| + |mean(dxhat)| + |xhat·mean(dxhat·xhat)|) (the two row
    means sum in another order, and where the terms cancel that difference
    is many ulps of a small result); with ``row_sums`` the two means'
    magnitudes are those of their own terms, mean(|dxhat|) and
    mean(|dxhat·xhat|), the scale of their rounding (fp32 rows, where no
    ulp of dx hides it). The column sums within 1e-5 of each column's sum
    of |terms|."""
    (dx, gw, gb), (dx0, gw0, gb0) = got, want
    xhat = (x.float() - mean[:, None]) * inv[:, None]
    dxh = dy.float() * w.float() if w is not None else dy.float()
    if row_sums:
        m1 = dxh.abs().mean(1, keepdim=True)
        m2 = (dxh * xhat).abs().mean(1, keepdim=True)
    else:
        m1 = dxh.mean(1, keepdim=True)
        m2 = (dxh * xhat).mean(1, keepdim=True)
    scale = inv[:, None] * (dxh.abs() + m1.abs() + (xhat * m2).abs())
    ulp = torch.maximum(storage_ulp(torch, dx), storage_ulp(torch, dx0))
    dx_err = (dx.float() - dx0.float()).abs()
    lim = ulp + 1e-5 * scale
    check(bool((dx_err <= lim).all()),
          f"{what}: dx off by {float((dx_err / lim).max())} of its bound")
    out = {"max_abs_err": float(dx_err.max()),
           "max_ulps": float((dx_err / ulp).max()), "sums_max_abs_err": 0.0}
    del dxh, m1, m2, scale, ulp, lim, dx_err
    if w is not None:
        for got_s, want_s, terms in ((gw, gw0, dy.float() * xhat),
                                     (gb, gb0, dy.float())):
            lim = 1e-5 * terms.abs().sum(0) + 1e-6
            e = (got_s - want_s).abs()
            check(bool((e <= lim).all()),
                  f"{what}: column sums off by {float((e / lim).max())} of "
                  f"1e-5·Σ|terms|")
            out["sums_max_abs_err"] = max(out["sums_max_abs_err"],
                                          float(e.max()))
    return out


# flash outputs: each element within FLASH_ULPS bf16 ulps of itself plus
# FLASH_RMS of its row's RMS over D (a query row of o and dq, a key row of
# dk and dv), a row's RMS taken as at least FLASH_FLOOR of the tensor's
# (rows whose exact value is 0, as dq's first causal row, are rounding
# noise). The kernels round P and dS to bf16 before their second products:
# that error is a share of the row, not of the tensor's largest value.
FLASH_ULPS, FLASH_RMS, FLASH_FLOOR = 2.0, 2.0 ** -6, 2.0 ** -6
# the simple form's fp32 outputs: FLASH_RMS_F32 of the larger of the row's
# RMS and the tensor's (sums of thousands of terms in another order, exp2
# against exp; a row whose exact value cancels to about 0, as dq's first
# causal row, keeps the rounding of its terms, which are of the tensor's
# scale)
FLASH_RMS_F32 = 2.0 ** -14


def flash_err(torch, got, want, dt=None) -> dict:
    """``used``: the largest |got - want| over its limit (the check passes
    at <= 1); ``ulps`` and ``rms``: the largest error in ulps of ``dt``
    (bf16 by default) and as a share of its row's RMS. bf16 and fp16: 2
    ulps + 2^-6 of the row's RMS (at least FLASH_FLOOR of the tensor's);
    fp32 (the simple form): 2 ulps + FLASH_RMS_F32 of the larger of the
    row's RMS and the tensor's."""
    dt = dt or torch.bfloat16
    a, b = got.float(), want.float()
    err = (a - b).abs()
    ulp = torch.maximum(storage_ulp(torch, a, dt), storage_ulp(torch, b, dt))
    frac, floor = (FLASH_RMS_F32, 1.0) if dt == torch.float32 \
        else (FLASH_RMS, FLASH_FLOOR)
    rms = torch.clamp(b.pow(2).mean(-1, keepdim=True).sqrt(),
                      min=floor * float(b.pow(2).mean().sqrt()))
    lim = FLASH_ULPS * ulp + frac * rms
    return {"max_abs_err": float(err.max()),
            "ulps": float((err / ulp).max()), "rms": float((err / rms).max()),
            "used": float((err / lim).max())}


def lm_kernel_phase(torch, timer, total: int) -> dict:
    """The LM step's new kernels at its shapes: Adam over the flat fp32
    master store (``total`` elements), the LayerNorm backward over
    [B·(S-1), E] bf16 rows, the flash kernels over [B·H, S-1, D] bf16,
    causal. Each against its plain version on the same inputs (the flash
    ones on the first heads, where the plain version's fp32 scores fit),
    with its time, the plain version's over the whole input, one PyTorch
    library call's and the bound."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import flash_attn as FA
    from apex_tpu_torch.ops import layer_norm as LN
    from apex_tpu_torch.ops import multi_tensor as MT

    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {}

    # Adam: lm_bench's FusedAdam(lr=1e-4), AdamW mode, weight decay 0,
    # at step 3; fp32 grad, masters and slots
    T = total
    g = torch.randn(T, generator=gen, device="cuda") * 1e-2
    p = torch.randn(T, generator=gen, device="cuda") * 0.02
    m = torch.randn(T, generator=gen, device="cuda") * 1e-3
    v = torch.rand(T, generator=gen, device="cuda") * 1e-6
    sc = MT.adam_scalars(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                         step=torch.tensor(3, device="cuda"),
                         bias_correction=True, weight_decay=0.0,
                         device="cuda")
    got = MT.adam(g, p, m, v, sc, MT.MODE_DECOUPLED)
    want = MT.adam_plain(g, p, m, v, sc, MT.MODE_DECOUPLED)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(same, f"adam: not bit-equal to the plain version ({err})")
    del got, want
    lib_p = p.clone().requires_grad_(True)
    lib_p.grad = g.clone()
    lib = torch.optim.AdamW([lib_p], lr=1e-4, weight_decay=0.0, fused=True)
    lib.step()                      # creates its state
    b_ms, b_by = bound(28 * T + 36, 16 * T)
    row = dict(kernel="adam", dtype="float32", shape=[T], max_abs_err=err,
               tol=0.0, bitwise=same, per_step=LM_PER_STEP["adam"],
               ms=timer(lambda: MT.adam(g, p, m, v, sc, MT.MODE_DECOUPLED)),
               plain_ms=timer(lambda: MT.adam_plain(g, p, m, v, sc,
                                                    MT.MODE_DECOUPLED)),
               library_ms=timer(lib.step), bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: MT.adam(
                   g, p, m, v, sc, MT.MODE_DECOUPLED)))
    emit({"phase": "kernels", **row})
    rows[("adam", "float32")] = row
    del g, p, m, v, lib, lib_p

    # LayerNorm backward over the step's rows, bf16 with bf16 gamma (the
    # O2 model's params), from the forward kernel's statistics
    n_rows = LM_SHAPE["batch"] * (LM_SHAPE["seq"] - 1)
    f = LM_SHAPE["embed"]
    x = (torch.randn(n_rows, f, generator=gen, device="cuda") * 2
         + 0.5).to(torch.bfloat16)
    dy = torch.randn(n_rows, f, generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn(f, generator=gen, device="cuda") + 1).to(torch.bfloat16)
    b = torch.randn(f, generator=gen, device="cuda").to(torch.bfloat16)
    _, mean, inv = LN.ln_fwd(x, w, b, 1e-5)
    dx, gw, gb = LN.ln_bwd(dy, x, w, mean, inv)
    dx0, gw0, gb0 = LN.ln_bwd_plain(dy, x, w, mean, inv)
    torch.cuda.synchronize()
    errs = check_ln_bwd(torch, "ln_bwd", (dx, gw, gb), (dx0, gw0, gb0), dy,
                        x, w, mean, inv)
    again = LN.ln_bwd(dy, x, w, mean, inv)
    repeat = all(bool(torch.equal(a, c)) for a, c in zip((dx, gw, gb),
                                                        again))
    check(repeat, "ln_bwd: two runs on the same inputs differ")
    del again
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [f], w, b, 1e-5)
    es = 2
    b_ms, b_by = bound(3 * n_rows * f * es + 8 * n_rows + f * es + 8 * f,
                       11 * n_rows * f)
    row = dict(kernel="ln_bwd", dtype="bfloat16", shape=[n_rows, f],
               **errs,
               tol="dx: 1 bf16 ulp + 1e-5 of its terms; sums: 1e-5·Σ|terms|",
               repeat_equal=repeat,
               per_step=LM_PER_STEP["ln_bwd"],
               ms=timer(lambda: LN.ln_bwd(dy, x, w, mean, inv)),
               plain_ms=timer(lambda: LN.ln_bwd_plain(dy, x, w, mean, inv)),
               library_ms=timer(
                   lambda: torch.ops.aten.native_layer_norm_backward(
                       dy, x, [f], lmean, lrstd, w, b, [True, True, True])),
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: LN.ln_bwd(dy, x, w, mean,
                                                        inv)))
    emit({"phase": "kernels", **row})
    rows[("ln_bwd", "bfloat16")] = row
    del x, dy, dx, dx0, lmean, lrstd

    # flash attention: [B·H, S-1, D] bf16, causal, the model's scale
    B, H = LM_SHAPE["batch"], LM_SHAPE["heads"]
    S, D = LM_SHAPE["seq"] - 1, LM_SHAPE["embed"] // LM_SHAPE["heads"]
    BH, n = B * H, FLASH_CHECK_HEADS
    kw = dict(causal=True, scale=D ** -0.5)

    def rnd():
        return torch.randn(BH, S, D, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = rnd(), rnd(), rnd(), rnd()
    o, lse = FA.flash_fwd(q, k, v, **kw)
    delta = FA.flash_delta(o, do)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    o0, lse0 = FA.reference_attention(q[:n], k[:n], v[:n], return_lse=True,
                                      **kw)
    dq0, dk0, dv0 = FA.flash_bwd_plain(q[:n], k[:n], v[:n], do[:n], lse[:n],
                                       delta[:n], **kw)
    torch.cuda.synchronize()

    errs = {what: flash_err(torch, a[:n], b0) for what, a, b0 in
            (("o", o, o0), ("dq", dq, dq0), ("dk", dk, dk0), ("dv", dv, dv0))}
    lse_err = float((lse[:n] - lse0).abs().max())
    emit({"phase": "flash_tol", "ulps": FLASH_ULPS, "rms": FLASH_RMS,
          "floor": FLASH_FLOOR, "lse_err": lse_err, **errs})
    check(lse_err <= 1e-3, f"flash lse: max abs err {lse_err} > 1e-3")
    for what, e in errs.items():
        check(e["used"] <= 1.0, f"flash {what}: {e}")
    # the other side: the rule refuses the plain result with its later
    # half 5% off
    late = torch.arange(S, device="cuda")[None, :, None] >= S // 2
    for what, b0 in (("o", o0), ("dq", dq0), ("dk", dk0), ("dv", dv0)):
        off = torch.where(late, b0.float() * 1.05, b0.float())
        check(flash_err(torch, off, b0)["used"] > 1.0,
              f"flash {what}: the limit passes a result 5% off")
    rep = flash_repeats(torch, (q, k, v, do, lse, delta), kw, (dq, dk, dv))
    fwd_rep = fwd_repeat(torch, (q, k, v), kw, (o, lse))
    del o0, lse0, dq0, dk0, dv0, late, off
    group = 16

    def plain_fwd():
        # the plain version head group by head group: its fp32 scores for
        # all 128 heads at once would take tens of GB
        for i in range(0, BH, group):
            FA.reference_attention(q[i:i + group], k[i:i + group],
                                   v[i:i + group], return_lse=True, **kw)

    def plain_bwd():
        FA.flash_bwd_plain(q, k, v, do, lse, delta, **kw)

    q4, k4, v4, do4 = (t.view(B, H, S, D) for t in (q, k, v, do))
    ql, kl, vl = (t.detach().clone().requires_grad_(True)
                  for t in (q4, k4, v4))
    lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_bwd = timer(lambda: torch.autograd.grad(lo, (ql, kl, vl), do4,
                                                retain_graph=True))
    pairs = BH * S * (S + 1) // 2            # causal (query, key) pairs
    sz = BH * S * D * 2
    common = dict(dtype="bfloat16", shape=[BH, S, D], causal=True,
                  per_step=LM_PER_STEP["flash_fwd"], checked_heads=n)
    b_ms, b_by = bound(4 * sz + 4 * BH * S, 4 * D * pairs, BF16_DENSE_OPS_S)
    tol = (f"{FLASH_ULPS:g} bf16 ulps + {FLASH_RMS:g} of the row's RMS "
           f"(at least {FLASH_FLOOR:g} of the tensor's); lse 1e-3")
    fwd = dict(kernel="flash_fwd", **common,
               max_abs_err=errs["o"]["max_abs_err"],
               tol_used=errs["o"]["used"], tol=tol, lse_err=lse_err,
               repeat_equal=fwd_rep,
               ms=timer(lambda: FA.flash_fwd(q, k, v, **kw)),
               plain_ms=timer(plain_fwd),
               library_ms=timer(lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, is_causal=True)),
               bound_ms=b_ms, bound_by=b_by)
    plain_bwd_ms = timer(plain_bwd)
    b_ms, b_by = bound(5 * sz + 8 * BH * S, 6 * D * pairs, BF16_DENSE_OPS_S)
    dqr = dict(kernel="flash_bwd_dq", **common,
               max_abs_err=errs["dq"]["max_abs_err"],
               tol_used=errs["dq"]["used"], tol=tol, repeat_equal=rep["dq"],
               ms=timer(lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta,
                                                **kw)),
               plain_ms=plain_bwd_ms, library_ms=lib_bwd,
               library_covers="dq, dk and dv (one SDPA backward)",
               bound_ms=b_ms, bound_by=b_by)
    b_ms, b_by = bound(6 * sz + 8 * BH * S, 8 * D * pairs, BF16_DENSE_OPS_S)
    dkvr = dict(kernel="flash_bwd_dkv", **common,
                max_abs_err=max(errs["dk"]["max_abs_err"],
                                errs["dv"]["max_abs_err"]),
                tol_used=max(errs["dk"]["used"], errs["dv"]["used"]),
                tol=tol, repeat_equal=rep["dk"] and rep["dv"],
                ms=timer(lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                  **kw)),
                plain_ms=plain_bwd_ms, library_ms=lib_bwd,
                library_covers="dq, dk and dv (one SDPA backward)",
                bound_ms=b_ms, bound_by=b_by)
    dqr["plain_covers"] = dkvr["plain_covers"] = \
        "dq, dk and dv (one flash_bwd_plain)"
    whole = flash_bwd_row(torch, timer, (q, k, v, o, do, lse), kw, errs,
                          rep, lib_bwd, pairs, common)
    for r in (fwd, dqr, dkvr, whole):
        emit({"phase": "kernels", **r})
        rows[(r["kernel"], "bfloat16")] = r
    rows.update(wide_flash_phase(torch, timer))
    return rows


def fwd_repeat(torch, args, kw, outs) -> bool:
    """o and lse of a second forward on the same inputs, bit for bit the
    first's: a block owns its output rows."""
    from apex_tpu_torch.ops import flash_attn as FA
    same = all(bool(torch.equal(a, b))
               for a, b in zip(FA.flash_fwd(*args, **kw), outs))
    check(same, "flash forward: two runs on the same inputs differ")
    return same


def flash_repeats(torch, args, kw, outs) -> dict:
    """dq, dk and dv of a second run on the same inputs, each bit for bit
    against the first: a block owns its output rows, no float atomics."""
    from apex_tpu_torch.ops import flash_attn as FA
    again = (FA.flash_bwd_dq(*args, **kw), *FA.flash_bwd_dkv(*args, **kw))
    rep = {w: bool(torch.equal(a, b))
           for w, a, b in zip(("dq", "dk", "dv"), again, outs)}
    check(all(rep.values()),
          f"flash backward: two runs on the same inputs differ: {rep}")
    return rep


def flash_bwd_row(torch, timer, tensors, kw, errs, rep, lib_bwd,
                  pairs: int, common: dict,
                  ops_s: float = BF16_DENSE_OPS_S) -> dict:
    """The whole backward as the autograd Function runs it, one timed
    call: ``flash_delta``, dq and dk/dv (the plain version: ``flash_delta``
    and ``flash_bwd_plain``), beside SDPA's backward; its bound is the
    backward's own least work, five products (10·D·pairs operations, at
    ``ops_s``) and its bytes (q, k, v, o, dO and lse read once; dq, dk, dv
    written)."""
    from apex_tpu_torch.ops import flash_attn as FA
    q, k, v, o, do, lse = tensors
    bh, s, d = q.shape

    def run(dq_fn, dkv_fn):
        delta = FA.flash_delta(o, do)
        dq_fn(q, k, v, do, lse, delta, **kw)
        dkv_fn(q, k, v, do, lse, delta, **kw)

    sz = bh * s * d * q.element_size()
    b_ms, b_by = bound(8 * sz + 4 * bh * s, 10 * d * pairs, ops_s)
    return dict(common, kernel="flash_bwd",
                kernels="flash_delta + flash_bwd_dq + flash_bwd_dkv",
                max_abs_err=max(errs[w]["max_abs_err"]
                                for w in ("dq", "dk", "dv")),
                tol_used=max(errs[w]["used"] for w in ("dq", "dk", "dv")),
                repeat_equal=all(rep.values()),
                ms=timer(lambda: run(FA.flash_bwd_dq, FA.flash_bwd_dkv)),
                plain_ms=timer(lambda: FA.flash_bwd_plain(
                    q, k, v, do, lse, FA.flash_delta(o, do), **kw)),
                plain_covers="flash_delta + flash_bwd_plain",
                library_ms=lib_bwd,
                library_covers="dq, dk and dv (one SDPA backward)",
                bound_ms=b_ms, bound_by=b_by)


def wide_flash_phase(torch, timer) -> dict:
    """The flash kernels at the wide LM's attention, [B·H, S, 128] bf16
    causal (``WIDE_SHAPE``: 4 × 96 heads, S 2048): the forward, dq, dk/dv
    and the whole backward against the plain versions on the first heads
    (the flash rule; lse within 1e-3), each output repeated bit for bit,
    with their bounds, the plain versions' times (the forward's head group
    by head group) and causal SDPA's forward and backward."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import flash_attn as FA

    c = WIDE_SHAPE
    B, H, S = c["batch"], c["heads"], c["seq"]
    D = c["embed"] // H
    BH, n = B * H, FLASH_CHECK_HEADS
    kw = dict(causal=True, scale=D ** -0.5)
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = (torch.randn(BH, S, D, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(4))
    o, lse = FA.flash_fwd(q, k, v, **kw)
    delta = FA.flash_delta(o, do)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    o0, lse0 = FA.reference_attention(q[:n], k[:n], v[:n], return_lse=True,
                                      **kw)
    want = FA.flash_bwd_plain(q[:n], k[:n], v[:n], do[:n], lse[:n],
                              delta[:n], **kw)
    torch.cuda.synchronize()
    errs = {w: flash_err(torch, a[:n], b0)
            for w, a, b0 in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                                (o0, *want))}
    lse_err = float((lse[:n] - lse0).abs().max())
    emit({"phase": "flash_tol", "shape": [BH, S, D], "reading": "wide",
          "lse_err": lse_err, **errs})
    check(lse_err <= 1e-3, f"flash lse at {[BH, S, D]}: {lse_err} > 1e-3")
    for w, e in errs.items():
        check(e["used"] <= 1.0, f"flash {w} at {[BH, S, D]}: {e}")
    args = (q, k, v, do, lse, delta)
    rep = flash_repeats(torch, args, kw, (dq, dk, dv))
    fwd_rep = fwd_repeat(torch, (q, k, v), kw, (o, lse))
    del want, o0, lse0
    group = 16

    def plain_fwd():
        # head group by head group, as the LM's reading
        for i in range(0, BH, group):
            FA.reference_attention(q[i:i + group], k[i:i + group],
                                   v[i:i + group], return_lse=True, **kw)

    q4, k4, v4, do4 = (t.view(B, H, S, D) for t in (q, k, v, do))
    ql, kl, vl = (t.detach().clone().requires_grad_(True)
                  for t in (q4, k4, v4))
    lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_bwd = timer(lambda: torch.autograd.grad(lo, (ql, kl, vl), do4,
                                                retain_graph=True))
    del lo, ql, kl, vl
    plain_ms = timer(lambda: FA.flash_bwd_plain(*args, **kw))
    pairs = BH * S * (S + 1) // 2
    sz = BH * S * D * 2
    common = dict(dtype="bfloat16", shape=[BH, S, D], causal=True,
                  per_step=WIDE_PER_STEP["flash_bwd_dq"], checked_heads=n,
                  plain_covers="dq, dk and dv (one flash_bwd_plain)",
                  library_covers="dq, dk and dv (one SDPA backward)")
    fwd_b = bound(4 * sz + 4 * BH * S, 4 * D * pairs, BF16_DENSE_OPS_S)
    dq_b = bound(5 * sz + 8 * BH * S, 6 * D * pairs, BF16_DENSE_OPS_S)
    dkv_b = bound(6 * sz + 8 * BH * S, 8 * D * pairs, BF16_DENSE_OPS_S)
    rows = {}
    for r in (
            dict(common, kernel="flash_fwd",
                 max_abs_err=errs["o"]["max_abs_err"],
                 tol_used=errs["o"]["used"], lse_err=lse_err,
                 repeat_equal=fwd_rep,
                 ms=timer(lambda: FA.flash_fwd(q, k, v, **kw)),
                 plain_ms=timer(plain_fwd),
                 plain_covers="the forward (reference_attention)",
                 library_ms=timer(lambda: F.scaled_dot_product_attention(
                     q4, k4, v4, is_causal=True)),
                 library_covers="the forward (causal SDPA)",
                 bound_ms=fwd_b[0], bound_by=fwd_b[1]),
            dict(common, kernel="flash_bwd_dq",
                 max_abs_err=errs["dq"]["max_abs_err"],
                 tol_used=errs["dq"]["used"], repeat_equal=rep["dq"],
                 ms=timer(lambda: FA.flash_bwd_dq(*args, **kw)),
                 plain_ms=plain_ms, library_ms=lib_bwd, bound_ms=dq_b[0],
                 bound_by=dq_b[1]),
            dict(common, kernel="flash_bwd_dkv",
                 max_abs_err=max(errs["dk"]["max_abs_err"],
                                 errs["dv"]["max_abs_err"]),
                 tol_used=max(errs["dk"]["used"], errs["dv"]["used"]),
                 repeat_equal=rep["dk"] and rep["dv"],
                 ms=timer(lambda: FA.flash_bwd_dkv(*args, **kw)),
                 plain_ms=plain_ms, library_ms=lib_bwd, bound_ms=dkv_b[0],
                 bound_by=dkv_b[1]),
            flash_bwd_row(torch, timer, (q, k, v, o, do, lse), kw, errs,
                          rep, lib_bwd, pairs, common)):
        emit({"phase": "kernels", "reading": "wide", **r})
        rows[(r["kernel"], "wide")] = r
    return rows


# -- phase 2, the ImageNet step's optimizer kernels ---------------------------

# main_amp.py:53-62's FusedSGD: lr 0.1, momentum 0.9, weight decay 1e-4,
# no dampening or nesterov
MAIN_AMP_SGD = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)


def optimizer_kernel_phase(torch, timer, table) -> dict:
    """The per-row norm, SGD and NovoGrad kernels over a flat fp32 buffer
    laid out by ``table`` (the RN50 master store), each against its plain
    version, with its time, the plain version's, one library call's where
    PyTorch has one, and the bound."""
    from apex_tpu_torch.ops import dispatch
    from apex_tpu_torch.ops import kernels as K
    from apex_tpu_torch.ops import multi_tensor as MT

    gen = torch.Generator(device="cuda").manual_seed(8)
    T, R, S = table.total, table.total // 128, table.num_segments
    valid = table.valid_mask("cuda")
    rows = {}

    def randn(scale=1.0):
        return torch.randn(T, generator=gen, device="cuda") * scale * valid

    g, p, m = randn(1e-2), randn(0.05), randn(1e-3)
    views = [g[o:o + n] for o, n in zip(table.offsets, table.sizes)]

    # rowsumsq: the row pass of LARC's and NovoGrad's per-tensor L2 norms
    got, want = MT.rowsumsq(g), MT.rowsumsq_plain(g)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    check(bool(((got - want).abs() <= 1e-5 * want.abs()).all()),
          f"rowsumsq: off by {rel} relative (limit 1e-5)")
    b_ms, b_by = bound(4 * T + 4 * R, 2 * T)
    row = dict(kernel="rowsumsq", dtype="float32", shape=[T],
               max_abs_err=float((got - want).abs().max()), max_rel_err=rel,
               tol="1e-5 relative",
               ms=timer(lambda: MT.rowsumsq(g)),
               plain_ms=timer(lambda: MT.rowsumsq_plain(g)),
               library_ms=timer(lambda: torch.linalg.vector_norm(
                   g.view(-1, 128), dim=1)),
               library_call="linalg.vector_norm over the (rows, 128) view",
               per_segment_ms=timer(lambda: K.l2norm_per_segment(
                   g, table, aligned_segments=True)),
               library_foreach_norm_ms=timer(lambda: torch._foreach_norm(
                   views)),
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: MT.rowsumsq(g)))
    emit({"phase": "kernels", **row})
    rows[("rowsumsq", "float32")] = row

    # rowmaxabs: the row pass of NovoGrad's L-inf norms; exact
    got, want = MT.rowmaxabs(g), MT.rowmaxabs_plain(g)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "rowmaxabs: not equal to the plain "
                                  "version")
    b_ms, b_by = bound(4 * T + 4 * R, 2 * T)
    row = dict(kernel="rowmaxabs", dtype="float32", shape=[T],
               max_abs_err=0.0, tol=0.0, bitwise=True,
               ms=timer(lambda: MT.rowmaxabs(g)),
               plain_ms=timer(lambda: MT.rowmaxabs_plain(g)),
               library_ms=timer(lambda: g.view(-1, 128).abs().amax(1)),
               library_call="abs().amax(1) over the (rows, 128) view",
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: MT.rowmaxabs(g)))
    emit({"phase": "kernels", **row})
    rows[("rowmaxabs", "float32")] = row

    # sgd: every flag combination at a small size, then main_amp's at RN50
    small = {}
    n = 128 * 1037
    for flags in range(16):
        for first in (False, True):
            sc = MT.sgd_scalars(wd=1e-4, lr=0.1, momentum=0.9,
                                dampening=0.1, first_run=torch.tensor(
                                    first, device="cuda"), device="cuda")
            a = MT.sgd(g[:n], p[:n], m[:n], sc, flags)
            b = MT.sgd_plain(g[:n], p[:n], m[:n], sc, flags)
            small[f"{flags}/{int(first)}"] = all(
                bool(torch.equal(x, y)) for x, y in zip(a, b))
    check(all(small.values()), f"sgd: flag combinations not bit-equal "
                               f"{small}")
    flags = MT._sgd_flags(wd=MAIN_AMP_SGD["weight_decay"],
                          momentum=MAIN_AMP_SGD["momentum"], nesterov=False,
                          wd_after_momentum=False)
    sc = MT.sgd_scalars(wd=MAIN_AMP_SGD["weight_decay"],
                        lr=MAIN_AMP_SGD["lr"],
                        momentum=MAIN_AMP_SGD["momentum"], dampening=0.0,
                        first_run=torch.tensor(False, device="cuda"),
                        device="cuda")
    got, want = MT.sgd(g, p, m, sc, flags), MT.sgd_plain(g, p, m, sc, flags)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(same, f"sgd: not bit-equal to the plain version ({err})")
    del got, want
    lib_p = p.clone().requires_grad_(True)
    lib_p.grad = g.clone()
    lib = torch.optim.SGD([lib_p], fused=True, **MAIN_AMP_SGD)
    lib.step()                      # creates its momentum buffer
    b_ms, b_by = bound(20 * T + 24, 8 * T)
    row = dict(kernel="sgd", dtype="float32", shape=[T], max_abs_err=err,
               tol=0.0, bitwise=same, flags=flags, small_flags_bitwise=small,
               ms=timer(lambda: MT.sgd(g, p, m, sc, flags)),
               plain_ms=timer(lambda: MT.sgd_plain(g, p, m, sc, flags)),
               library_ms=timer(lib.step),
               library_call="optim.SGD(fused=True).step",
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: MT.sgd(g, p, m, sc, flags)))
    emit({"phase": "kernels", **row})
    rows[("sgd", "float32")] = row
    del lib, lib_p

    # novograd: the elementwise kernel at FusedNovoGrad's defaults (mode 1)
    # from a step-3 denominator; then the whole step at L2 and L-inf
    v = torch.rand(S, generator=gen, device="cuda") * 1e-2 + 1e-3
    row_seg = table.row_segment_ids("cuda")
    step = torch.tensor(3, dtype=torch.int32, device="cuda")
    bc1 = 1.0 - torch.pow(torch.tensor(0.95, device="cuda"), step.float())
    nsc = MT.novograd_scalars(lr=1e-2, beta1=0.95, weight_decay=0.0,
                              grad_averaging=True, bc1=bc1, device="cuda")
    mode = MT.MODE_DECOUPLED
    got = MT.novograd(g, p, m, v, row_seg, nsc, mode)
    want = MT.novograd_plain(g, p, m, v, row_seg, nsc, mode)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(same, f"novograd: not bit-equal to the plain version ({err})")
    steps = {}
    kw = dict(lr=1e-2, beta1=0.95, beta2=0.98, eps=1e-8, step=step,
              mode=mode)
    for nt, name in ((MT.NORM_L2, "l2"), (MT.NORM_LINF, "linf")):
        a = MT.novograd_step(g, p, m, v, table, norm_type=nt, **kw)
        with dispatch.backend("reference"):
            b = MT.novograd_step(g, p, m, v, table, norm_type=nt, **kw)
        e = max(float(((x - y).abs() / y.abs().clamp_min(1e-30)).max())
                for x, y in zip(a[2:], b[2:]))
        exact = all(bool(torch.equal(x, y)) for x, y in zip(a, b))
        # L-inf norms are exact, so the whole step is; L2 norms add in
        # another order, so the blended norms within 1e-5 relative
        check(exact if nt == MT.NORM_LINF else e <= 1e-5,
              f"novograd_step {name}: norms off by {e}, exact {exact}")
        steps[name] = dict(bitwise=exact, norms_max_rel_err=e,
                           ms=timer(lambda: MT.novograd_step(
                               g, p, m, v, table, norm_type=nt, **kw)))
    b_ms, b_by = bound(20 * T + 4 * R + 4 * S + 20, 9 * T)
    row = dict(kernel="novograd", dtype="float32", shape=[T],
               max_abs_err=err, tol=0.0, bitwise=same, mode=mode,
               ms=timer(lambda: MT.novograd(g, p, m, v, row_seg, nsc, mode)),
               plain_ms=timer(lambda: MT.novograd_plain(g, p, m, v, row_seg,
                                                        nsc, mode)),
               library_ms=None, library_call="none (PyTorch has no NovoGrad)",
               bound_ms=b_ms, bound_by=b_by, whole_step=steps,
               host_us=host_us(torch, lambda: MT.novograd(
                   g, p, m, v, row_seg, nsc, mode)))
    emit({"phase": "kernels", **row})
    rows[("novograd", "float32")] = row
    return rows


# -- phase 2, gradient accumulation and fp16_utils: axpby, l2norm, Adagrad ---

# FusedAdagrad at lm_bench's lr, with the weight decay both modes are held at
ADAGRAD = dict(lr=1e-4, eps=1e-10, weight_decay=1e-2)


def accum_kernel_phase(torch, timer, total: int) -> dict:
    """The kernels of the accumulation and fp16_utils phases over the LM's
    flat fp32 master store (``total`` elements): ``axpby`` as
    ``unscale_with_stashed`` calls it (a = 1/65536 on the device, b = 1),
    in all three flag modes with an inf or NaN at the first, a middle and
    the last element of x and then of y; ``l2norm`` (within 1e-5 relative
    of the plain version, two runs bit-equal); ``adagrad`` in both weight
    decay modes (bit-equal). Each with its time, the plain version's, one
    PyTorch call's and the bound."""
    from apex_tpu_torch.ops import multi_tensor as MT

    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = {}
    T = total
    x = torch.randn(T, generator=gen, device="cuda") * 65536.0 * 1e-2
    y = torch.randn(T, generator=gen, device="cuda") * 1e-2
    a = torch.full((), 1.0 / 65536.0, device="cuda")

    # axpby: bit-equal to the plain version in every flag mode; each
    # injected inf or NaN flagged exactly when the mode checks its input
    same, flags = {}, {}
    for check_arg in (-1, 0, 1):
        got, fi = MT.axpby(a, x, 1.0, y, check_arg)
        want, fi0 = MT.axpby_plain(a, x, 1.0, y, check_arg)
        same[check_arg] = bool(torch.equal(got, want)) and \
            not bool(fi) and not bool(fi0)
        for arg, t in (("x", x), ("y", y)):
            covered = check_arg == -1 or check_arg == (0 if arg == "x" else 1)
            for where, pos, bad in (("first", 0, float("inf")),
                                    ("middle", T // 2, float("nan")),
                                    ("last", T - 1, float("-inf"))):
                keep = t[pos].clone()
                t[pos] = bad
                k_flag = bool(MT.axpby(a, x, 1.0, y, check_arg)[1])
                p_flag = bool(MT.axpby_plain(a, x, 1.0, y, check_arg)[1])
                t[pos] = keep
                flags[f"check{check_arg}_{arg}_{where}"] = k_flag
                check(k_flag == covered and p_flag == covered,
                      f"axpby check {check_arg}: {bad} in {arg} at {where} "
                      f"flagged {k_flag} (plain {p_flag}), want {covered}")
    check(all(same.values()), f"axpby: not bit-equal to the plain version "
                              f"{same}")
    got, _ = MT.axpby(a, x, 1.0, y, 0)
    want, _ = MT.axpby_plain(a, x, 1.0, y, 0)
    err = float((got - want).abs().max())
    del got, want
    b_ms, b_by = bound(12 * T + 12, 3 * T)
    row = dict(kernel="axpby", dtype="float32", shape=[T], max_abs_err=err,
               tol=0.0, bitwise=all(same.values()), inf_flags=flags,
               per_step=2,
               ms=timer(lambda: MT.axpby(a, x, 1.0, y, 0)),
               plain_ms=timer(lambda: MT.axpby_plain(a, x, 1.0, y, 0)),
               library_ms=timer(lambda: torch.add(y, x, alpha=1.0 / 65536)),
               library_covers="a·x + y, no flag (torch.add with alpha)",
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: MT.axpby(a, x, 1.0, y, 0)))
    emit({"phase": "kernels", **row})
    rows[("axpby", "float32")] = row

    # l2norm: within 1e-5 relative of the plain version; two runs bit-equal
    n1, n2 = MT.l2norm(y), MT.l2norm(y)
    n0 = MT.l2norm_plain(y)
    torch.cuda.synchronize()
    rel = float((n1 - n0).abs() / n0)
    repeat = bool(torch.equal(n1, n2))
    check(rel <= 1e-5, f"l2norm: {float(n1)} against plain {float(n0)} "
                       f"({rel:.3g} relative)")
    check(repeat, "l2norm: two runs on the same input differ")
    b_ms, b_by = bound(4 * T + 4, 2 * T)
    row = dict(kernel="l2norm", dtype="float32", shape=[T],
               max_abs_err=float((n1 - n0).abs()), rel_err=rel, tol=1e-5,
               repeat_equal=repeat, per_step=1,
               ms=timer(lambda: MT.l2norm(y)),
               plain_ms=timer(lambda: MT.l2norm_plain(y)),
               library_ms=timer(lambda: torch.linalg.vector_norm(y)),
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: MT.l2norm(y)))
    emit({"phase": "kernels", **row})
    rows[("l2norm", "float32")] = row
    del x

    # adagrad at lm_bench's lr with weight decay 1e-2, both modes, step 3's
    # accumulator
    g = y
    p = torch.randn(T, generator=gen, device="cuda") * 0.02
    h = torch.rand(T, generator=gen, device="cuda") * 3e-4
    sc = MT.adagrad_scalars(device="cuda", **ADAGRAD)
    same, err = {}, 0.0
    for mode in (MT.MODE_L2, MT.MODE_DECOUPLED):
        got = MT.adagrad(g, p, h, sc, mode)
        want = MT.adagrad_plain(g, p, h, sc, mode)
        torch.cuda.synchronize()
        same[mode] = all(bool(torch.equal(u, w)) for u, w in zip(got, want))
        err = max([err] + [float((u - w).abs().max())
                           for u, w in zip(got, want)])
        del got, want
    check(all(same.values()),
          f"adagrad: not bit-equal to the plain version {same} ({err})")
    lib_p = p.clone().requires_grad_(True)
    lib_p.grad = g.clone()
    lib, lib_kind = None, None
    for kind in ("fused", "foreach"):
        try:
            opt = torch.optim.Adagrad([lib_p], lr=ADAGRAD["lr"],
                                      eps=ADAGRAD["eps"],
                                      weight_decay=ADAGRAD["weight_decay"],
                                      **{kind: True})
            opt.step()
            lib, lib_kind = opt, kind
            break
        except (RuntimeError, TypeError, ValueError):
            continue
    b_ms, b_by = bound(20 * T + 12, 9 * T)
    row = dict(kernel="adagrad", dtype="float32", shape=[T], max_abs_err=err,
               tol=0.0, bitwise=all(same.values()), modes_bit_equal={
                   "l2": same[MT.MODE_L2],
                   "decoupled": same[MT.MODE_DECOUPLED]},
               per_step=1, **ADAGRAD,
               ms=timer(lambda: MT.adagrad(g, p, h, sc, MT.MODE_L2)),
               plain_ms=timer(lambda: MT.adagrad_plain(g, p, h, sc,
                                                       MT.MODE_L2)),
               library_ms=timer(lib.step) if lib is not None else None,
               library_covers=f"torch.optim.Adagrad({lib_kind}=True).step"
               if lib is not None else "none runs",
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: MT.adagrad(g, p, h, sc,
                                                         MT.MODE_L2)))
    emit({"phase": "kernels", **row})
    rows[("adagrad", "float32")] = row
    return rows


# impl="auto"'s crossover: the flash kernels against the plain composed
# attention at [128, S, 64] bf16, forward and forward + backward, causal and
# not (SDPA beside them as a yardstick only); the plain path runs in head
# groups of at most 128·2048² score elements, whose times add up
CROSSOVER_S = (128, 256, 512, 1024, 2048, 4096)
CROSSOVER_BH, CROSSOVER_D = 128, 64


def flash_crossover_phase(torch, dtype_name: str = "bfloat16",
                          d: int = CROSSOVER_D) -> dict:
    """Times of the flash path and the plain path over S in one dtype at
    head dim d, over BH·D = CROSSOVER_BH·CROSSOVER_D (BH 128 at D 64, 32
    at D 256); ``min_s`` is the smallest S measured from which the kernel
    wins every case at every larger S (None when it never does). bf16 at
    D 64 and at D 256 (the tensor-core kernels, every run: at D 256 the
    D-256 forward, dq and dk/dv) is held to ``DEFAULT_FLASH_MIN_S``, the
    length impl="auto" takes them from at both. fp32 is a reading made on
    its own, not in a run: from the repository root on the card, ``import
    torch, chip_smoke`` and then ``chip_smoke.flash_crossover_phase(torch,
    "float32")``."""
    import torch.nn.functional as F

    from apex_tpu_torch.contrib.multihead_attn import (
        DEFAULT_FLASH_MIN_S, flash_attention, reference_attention)
    from apex_tpu_torch.ops import flash_attn as FA

    dt = getattr(torch, dtype_name)

    timer = Timer(torch, reps=5)
    gen = torch.Generator(device="cuda").manual_seed(17)
    bh = CROSSOVER_BH * CROSSOVER_D // d
    table = []
    for causal in (False, True):
        for s in CROSSOVER_S:
            q, k, v, do = (torch.randn(bh, s, d, generator=gen, device="cuda")
                           .to(dt) for _ in range(4))
            qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
            group = max(1, min(bh, bh * 2048 * 2048 // (s * s)))

            def fwd_bwd(fn, q=qg, k=kg, v=vg):
                o = fn(q, k, v, causal=causal)
                torch.autograd.grad(o, (q, k, v), do)

            def plain(grad):
                def run():
                    for i in range(0, bh, group):
                        sl = slice(i, i + group)
                        if grad:
                            o = reference_attention(qg[sl], kg[sl], vg[sl],
                                                    causal=causal)
                            torch.autograd.grad(o, (qg, kg, vg), do[sl],
                                                allow_unused=True)
                        else:
                            reference_attention(q[sl], k[sl], v[sl],
                                                causal=causal)
                return run

            q4, k4, v4 = (t.view(1, bh, s, d) for t in (qg, kg, vg))
            do4 = do.view(1, bh, s, d)

            def sdpa_fb():
                o = F.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=causal)
                torch.autograd.grad(o, (qg, kg, vg), do4)

            with torch.no_grad():
                r = {"causal": causal, "s": s, "plain_head_group": group,
                     "fwd_ms": timer(lambda: flash_attention(
                         q, k, v, causal=causal)),
                     "plain_fwd_ms": timer(plain(False)),
                     "sdpa_fwd_ms": timer(
                         lambda: F.scaled_dot_product_attention(
                             q.view(1, bh, s, d), k.view(1, bh, s, d),
                             v.view(1, bh, s, d), is_causal=causal))}
            r["fwd_bwd_ms"] = timer(lambda: fwd_bwd(flash_attention))
            r["plain_fwd_bwd_ms"] = timer(plain(True))
            r["sdpa_fwd_bwd_ms"] = timer(sdpa_fb)
            r["kernel_wins"] = r["fwd_ms"] < r["plain_fwd_ms"] and \
                r["fwd_bwd_ms"] < r["plain_fwd_bwd_ms"]
            forms = [FA.kernel_form(q, kn) for kn in ("fwd", "dq", "dkv")]
            emit({"phase": "flash_crossover", "shape": [bh, s, d],
                  "dtype": dtype_name, "forms": forms, **r})
            table.append(r)
            del q, k, v, do, qg, kg, vg, q4, k4, v4, do4
    min_s = None
    for s in sorted(CROSSOVER_S, reverse=True):
        if all(r["kernel_wins"] for r in table if r["s"] >= s):
            min_s = s
        else:
            break
    row = {"phase": "flash_crossover_min_s", "dtype": dtype_name,
           "head_dim": d, "min_s": min_s, "timer_reps_redone": timer.redone}
    if dt == torch.bfloat16:
        row["default_flash_min_s"] = DEFAULT_FLASH_MIN_S
        check(all(r["kernel_wins"] for r in table
                  if r["s"] >= DEFAULT_FLASH_MIN_S),
              f"flash crossover at D {d}: the kernel does not win at every "
              f"S >= DEFAULT_FLASH_MIN_S {DEFAULT_FLASH_MIN_S} (min_s "
              f"{min_s})")
    emit(row)
    return row


# -- phases 3-4: the serving slice --------------------------------------------

TRAIN_KERNELS = ("scale", "lamb_phase1", "lamb_phase2", "bn_moments",
                 "bn_backward_fused_reduce", "bn_backward_dx")


def counters():
    from apex_tpu_torch.ops import decode_attn as DA
    from apex_tpu_torch.ops import flash_attn as FA
    from apex_tpu_torch.ops import layer_norm as LN
    from apex_tpu_torch.ops import multi_tensor as MT
    from apex_tpu_torch.ops import welford as WF
    from apex_tpu_torch.ops import xentropy as XE
    return {"decode_attention": DA.decode_attention,
            "paged_decode_attention": DA.paged_decode_attention,
            "decode_attention_rows": DA.decode_attention_rows,
            "paged_decode_attention_rows": DA.paged_decode_attention_rows,
            "decode_merge": DA.decode_merge,
            "ln_fwd": LN.ln_fwd, "scale": MT.scale,
            "lamb_phase1": MT.lamb_phase1, "lamb_phase2": MT.lamb_phase2,
            "bn_moments": WF.bn_moments,
            "bn_backward_fused_reduce": WF.bn_backward_fused_reduce,
            "bn_backward_dx": WF.bn_backward_dx,
            "adam": MT.adam, "ln_bwd": LN.ln_bwd,
            "flash_fwd": FA.flash_fwd, "flash_bwd_dq": FA.flash_bwd_dq,
            "flash_bwd_dkv": FA.flash_bwd_dkv, "rowsumsq": MT.rowsumsq,
            "rowmaxabs": MT.rowmaxabs, "sgd": MT.sgd,
            "novograd": MT.novograd, "xent_fwd": XE.xent_fwd,
            "xent_bwd": XE.xent_bwd, "axpby": MT.axpby,
            "l2norm": MT.l2norm, "adagrad": MT.adagrad,
            "flash_bwd_dbias": FA.flash_bwd_dbias,
            "flash_simt_dbias": FA.flash_simt_dbias,
            "ln_fwd_wide": LN.ln_fwd_wide, "ln_bwd_wide": LN.ln_bwd_wide,
            "bn_backward_reduce": WF.bn_backward_reduce,
            "flash_simt_fwd": FA.flash_simt_fwd,
            "flash_simt_dq": FA.flash_simt_dq,
            "flash_simt_dkv": FA.flash_simt_dkv,
            "flash_f32_dq": FA.flash_f32_dq,
            "flash_f32_dkv": FA.flash_f32_dkv,
            "flash_f32_fwd": FA.flash_f32_fwd,
            "flash_d256_fwd": FA.flash_d256_fwd,
            "flash_d256_dq": FA.flash_d256_dq,
            "flash_d256_dkv": FA.flash_d256_dkv,
            "flash_d512_fwd": FA.flash_d512_fwd,
            "flash_d512_dq": FA.flash_d512_dq,
            "flash_d512_dkv": FA.flash_d512_dkv,
            "flash_f32_d512_fwd": FA.flash_f32_d512_fwd,
            "flash_f32_d512_dq": FA.flash_f32_d512_dq,
            "flash_f32_d512_dkv": FA.flash_f32_d512_dkv}


def zero_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def warm_engine(torch, eng) -> dict:
    """``eng.warmup()``: every program captured (the card loads each
    product's kernels on first use, which is set-up, not serving). Its
    seconds, graphs and graph-pool bytes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    return {"warmup_s": time.perf_counter() - t0,
            "graphs": sum(p.captures for p in eng.programs.values()),
            "graph_pool_bytes": sum(p.pool_bytes
                                    for p in eng.programs.values())}


def captures_since(eng, warm: dict) -> int:
    return sum(p.captures for p in eng.programs.values()) - warm["graphs"]


def at_once(reqs) -> list:
    """The same requests all arriving at 0: the serving loop with no wait
    for arrivals."""
    import dataclasses
    return [dataclasses.replace(r, arrival_s=0.0) for r in reqs]


def serve_arm(torch, eng, reqs, arriving=True, at_once_too=True) -> tuple:
    """One run of ``reqs`` with the launch counts zeroed just before and
    read just after, then the profiled idle share of 8 of them as they
    arrive (``arriving``) and all arriving at once (``at_once_too``)."""
    zero_counts()
    results, stats = eng.run(reqs)
    torch.cuda.synchronize()
    counts = read_counts()
    prof = (profile_steps(torch, lambda: eng.run(reqs[:8]), SERVE_FAMILIES,
                          n=1) if arriving else None)
    closed = (profile_steps(torch, lambda: eng.run(at_once(reqs[:8])),
                            SERVE_FAMILIES, n=1) if at_once_too else None)
    return results, stats, counts, prof, closed


def decode_tok_s(results, stats) -> float:
    tokens = sum(len(r.tokens) for r in results) - len(results)
    return tokens / (sum(stats["step_ms"]) / 1e3)


def graphs_row(torch, config, eng, reqs, warm, graph) -> dict:
    """Phase 39's row for one engine: its captured run (``graph``, from
    :func:`serve_arm`) against the same requests under
    ``programs.eager()``."""
    from apex_tpu_torch.serve import programs, summarize_serving
    g_res, g_stats, _, _, g_closed = graph
    replay = {n: p.launches for n, p in eng.programs.items()}
    with programs.eager():
        e_res, e_stats, _, _, e_closed = serve_arm(torch, eng, reqs,
                                                   arriving=False)
    eager = {n: p.eager_launches for n, p in eng.programs.items()}
    gs = summarize_serving(g_res, g_stats, offered_rps=8.0)
    es = summarize_serving(e_res, e_stats, offered_rps=8.0)
    row = {"phase": "serve_graphs", "config": config, **warm,
           "captures_after_warmup": captures_since(eng, warm),
           "streams_equal": _stream_equal(g_res, e_res),
           "launches_per_call": replay,
           "launches_per_call_equal": replay == eager}
    for key, g, e in (
            ("decode_step_ms", gs["decode_step_ms"], es["decode_step_ms"]),
            ("decode_tok_s", decode_tok_s(g_res, g_stats),
             decode_tok_s(e_res, e_stats)),
            ("ttft_ms", gs["ttft_ms"], es["ttft_ms"]),
            ("tokens_per_s", gs["tokens_per_s"], es["tokens_per_s"]),
            ("idle_share_at_once", g_closed["idle_share"],
             e_closed["idle_share"]),
            ("wall_ms_8_at_once", g_closed["wall_ms_per_step"],
             e_closed["wall_ms_per_step"]),
            ("by_family_ms_8_at_once", g_closed["by_family_ms"],
             e_closed["by_family_ms"])):
        row[key] = {"graph": g, "eager": e}
    if "spec_accept_hist" in gs:
        row["spec_accept_hist"] = {"graph": gs["spec_accept_hist"],
                                   "eager": es["spec_accept_hist"]}
    emit(row)
    check(row["captures_after_warmup"] == 0,
          f"serve_graphs {config}: {row['captures_after_warmup']} captures "
          f"after warmup")
    check(row["streams_equal"],
          f"serve_graphs {config}: captured streams differ from eager")
    check(row["launches_per_call_equal"],
          f"serve_graphs {config}: launches a replay {replay} != an eager "
          f"call's {eager}")
    if config == "spec_dense":
        check(gs["spec_accept_hist"] == es["spec_accept_hist"],
              f"serve_graphs {config}: acceptance histograms differ")
    return row


def serve_phase(torch, name, model, params, reqs, graphs=None, **kw):
    """One serving engine at serve_bench's shape, warmed, over ``reqs``;
    with ``graphs`` (a config name) phase 39's eager arm on it."""
    from apex_tpu_torch.serve import (ContinuousBatchingEngine,
                                      summarize_serving)
    eng = ContinuousBatchingEngine(model, params, slots=8, max_len=1024,
                                   prefill_chunk=32, **kw)
    warm = warm_engine(torch, eng)
    arm = serve_arm(torch, eng, reqs, at_once_too=bool(graphs))
    results, stats, counts, prof, _ = arm
    summary = summarize_serving(results, stats, offered_rps=8.0)
    for r, q in zip(results, reqs):
        check(r.finish_s is not None and len(r.tokens) == q.max_new,
              f"{name}: request {q.id} got {len(r.tokens)} of "
              f"{q.max_new} tokens")
        check(all(0 <= t < model.vocab_size for t in r.tokens),
              f"{name}: request {q.id} emitted a token out of range")
    steps = stats["decode_steps"]
    decode_tokens = summary["tokens_out"] - len(results)
    check(captures_since(eng, warm) == 0,
          f"{name}: the runs after warmup captured "
          f"{captures_since(eng, warm)} graphs")
    emit({"phase": name, "requests": len(results), **warm,
          "completed": summary["completed"],
          "tokens": summary["tokens_out"],
          "wall_s": summary["duration_s"],
          "tokens_per_s": summary["tokens_per_s"],
          "decode_steps": steps,
          "decode_tok_s": decode_tokens / (sum(stats["step_ms"]) / 1e3),
          "decode_step_ms": summary["decode_step_ms"],
          "ttft_ms": summary["ttft_ms"],
          "token_lat_ms": summary["token_lat_ms"],
          "itl_ms": summary["itl_ms"],
          "slot_occupancy": summary["slot_occupancy"],
          "prefill_batches": summary["prefill_batches"],
          "prefill_chunks": summary["prefill_chunks"],
          "kv_reserved_bytes": summary["kv_reserved_bytes"],
          **{k: summary[k] for k in ("spec_k", "spec_accept_mean",
                                     "spec_accept_hist") if k in summary},
          "launches": counts,
          "launches_per_step": {k: v / steps for k, v in counts.items()},
          "profile_8_requests": prof})
    if graphs:
        graphs_row(torch, graphs, eng, reqs, warm, arm)
    return results, stats, counts


# -- phase 5: kernels against the plain versions through the model ------------

def crosscheck_phase(torch, dispatch):
    from apex_tpu_torch.models import TransformerLM

    m = TransformerLM(vocab_size=32768, max_seq_len=1024, embed_dim=1024,
                      num_heads=8, num_layers=2)
    p = m.init(torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    S, P, PAGE = 8, 40, 32
    prompt = torch.randint(0, 32768, (S, P), generator=g).cuda()
    toks = torch.randint(0, 32768, (S,), generator=g).to(torch.int32).cuda()
    pos = torch.tensor([1, 5, 39, 40, 17, 33, 8, 40], dtype=torch.int32,
                       device="cuda")
    max_pages = 1024 // PAGE
    table = (torch.randperm(S * max_pages, generator=g) + 1).to(
        torch.int32).reshape(S, max_pages).cuda()

    def step(paged: bool):
        hid, caches = m._prefill(p, prompt, 1024)
        kw = {}
        if paged:
            pools = {}
            for name, kv in caches.items():
                pools[name] = tuple(
                    torch.zeros((1 + S * max_pages, 8, PAGE, 128),
                                device="cuda") for _ in kv)
                for c, pool in zip(kv, pools[name]):
                    pool[table.reshape(-1).long()] = (
                        c.reshape(S, 8, max_pages, PAGE, 128)
                        .transpose(1, 2).reshape(-1, 8, PAGE, 128))
            caches = pools
            kw = dict(page_table=table, page_size=PAGE)
        out, _ = m._decode_slots(p, toks, pos, caches, **kw)
        return hid, (out @ p["tok_emb"].T).float()

    hid_k, dense_k = step(False)
    _, paged_k = step(True)
    with dispatch.backend("reference"):
        zero_counts()
        hid_r, dense_r = step(False)
        _, paged_r = step(True)
        torch.cuda.synchronize()
        plain_launches = read_counts()
    check(not any(plain_launches.values()),
          f"crosscheck: kernels launched in the plain run {plain_launches}")
    errs = {"prefill_hidden": float((hid_k - hid_r).abs().max()),
            "dense_logits": float((dense_k - dense_r).abs().max()),
            "paged_logits": float((paged_k - paged_r).abs().max())}
    emit({"phase": "crosscheck", "layers": 2, "dtype": "float32",
          "atol": 1e-4, "max_abs_err": errs,
          "paged_equals_dense": bool(torch.equal(paged_k, dense_k)),
          "finite": bool(torch.isfinite(dense_k).all())})
    for what, e in errs.items():
        check(e <= 1e-4, f"crosscheck {what}: max abs err {e} > 1e-4")
    check(torch.equal(paged_k, dense_k),
          "crosscheck: paged logits differ from dense with the kernels")
    check(bool(torch.isfinite(dense_k).all()), "crosscheck: non-finite")


# -- phases 6-8: the training slice -------------------------------------------

KERNEL_FAMILIES = (
    ("SGD", ("sgd_kernel",)),
    ("NovoGrad", ("novograd_kernel",)),
    ("norm kernels", ("rowsumsq_kernel", "rowmaxabs_kernel")),
    ("BN kernels", ("moments_kernel", "bwd_reduce_kernel", "finalize_kernel",
                    "bwd_dx_kernel")),
    ("training kernels", ("scale_kernel", "lamb_phase")),
    ("convolution", ("conv", "xmma", "gemm", "cutlass", "dgrad", "wgrad",
                     "cudnn", "implicit", "sm90")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where",
                     "copy", "fill", "clamp")),
    ("pooling", ("pool",)),
)


SERVE_FAMILIES = (
    ("decode kernels", ("decode_chunk_kernel", "decode_merge_kernel")),
    ("LN kernels", ("ln_fwd_kernel",)),
    ("GEMMs", ("gemm", "xmma", "cutlass", "nvjet", "sm90", "cublas")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where",
                     "copy", "fill", "clamp", "cat", "index", "embedding")),
)

# the fp32 backward's kernels (csrc/flash_f32.cu): D 64 and 128, and the
# pair kernels at D 256
F32_BWD_KERNELS = ("f32_dq_kernel", "f32_dkv_kernel", "f32_dq_pair_kernel",
                   "f32_dkv_pair_kernel")
LM_KERNEL_FAMILIES = (
    ("flash kernels", ("flash_fwd_kernel", "flash_dq_kernel",
                       "flash_dkv_kernel", "flash_dkv_split_kernel",
                       "simt_fwd_kernel", "simt_dq_kernel", "simt_dkv_kernel",
                       "f32_fwd_kernel", "f32x_fwd_kernel",
                       "f32x_dq_kernel") + F32_BWD_KERNELS),
    ("LN kernels", ("ln_fwd_kernel", "ln_bwd_kernel", "ln_wide",
                    "finalize_kernel")),
    ("Adam", ("adam_kernel",)),
    ("GEMMs", ("gemm", "xmma", "cutlass", "nvjet", "sm90", "cublas")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where",
                     "copy", "fill", "clamp", "cat", "index", "embedding")),
)


VIT_FAMILIES = (("SGD", ("sgd_kernel",)),
                ("training kernels", ("scale_kernel",))) + LM_KERNEL_FAMILIES


def _family(name: str, families) -> str:
    low = name.lower()
    for fam, keys in families:
        if any(k in low for k in keys):
            return fam
    return "other"


def profile_steps(torch, step, families=KERNEL_FAMILIES, n=2) -> dict:
    """Device time by kernel family and the device's idle share over
    ``n`` calls of ``step`` under ``torch.profiler`` (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam, top = {}, []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if not us or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        f = _family(e.key, families)
        fam[f] = fam.get(f, 0.0) + us / 1e3 / n
        top.append((us / 1e3 / n, e.count // n, e.key[:90]))
    busy = sum(fam.values())
    top.sort(reverse=True)
    return {"steps": n, "wall_ms_per_step": wall_ms / n,
            "device_ms_per_step": busy,
            "idle_share": (1.0 - busy / (wall_ms / n)) if wall_ms else None,
            "by_family_ms": dict(sorted(fam.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": t, "calls": c, "name": k}
                            for t, c, k in top[:12]]}


def timed_steps(torch, step, warm: int, timed: int) -> dict:
    """``warm`` calls of ``step`` (which returns the loss), then ``timed``
    calls with the launch counts zeroed just before and read just after:
    CUDA events per step, one synchronize around the window."""
    losses = [step() for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(timed)]
    t0 = time.perf_counter()
    for a, b in events:
        a.record()
        losses.append(step())
        b.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    step_ms = sorted(a.elapsed_time(b) for a, b in events)
    return {"wall": wall, "counts": counts, "step_ms": step_ms,
            "peak": torch.cuda.max_memory_allocated(),
            "loss": [float(v) for v in losses]}


def window_row(r: dict, timed: int) -> dict:
    """Step times, peak memory and losses of a training window."""
    wall, loss, step_ms = r["wall"], r["loss"], r["step_ms"]
    return {"steps_timed": timed, "wall_s": wall,
            "step_ms_mean": wall / timed * 1e3,
            "step_ms_p50": statistics.median(step_ms),
            "step_ms_p95": step_ms[min(timed - 1,
                                       int(round(0.95 * (timed - 1))))],
            "peak_mem_bytes": r["peak"], "loss_first": loss[0],
            "loss_last": loss[-1], "losses": loss}


def step_row(r: dict, batch: int, timed: int, flops: float) -> dict:
    """The end-to-end numbers of a ResNet training window."""
    img_s = batch * timed / r["wall"]
    return {**window_row(r, timed), "img_per_s": img_s,
            "analytic_fwd_gflop_per_img": flops / 1e9,
            "mfu": 3 * flops * img_s / BF16_DENSE_OPS_S}


def check_losses(phase: str, loss: list, *, overshoot=None) -> None:
    """Finite losses that fall: the last below the first; or, where the
    step overshoots the repeated batch (``overshoot``, a factor), the
    first three falling and none above ``overshoot`` times the first."""
    import numpy as np
    check(all(np.isfinite(loss)), f"{phase}: non-finite loss {loss}")
    if overshoot is None:
        fell = loss[-1] < loss[0]
    else:
        fell = loss[0] > loss[1] > loss[2] and \
            max(loss) <= overshoot * loss[0]
    check(fell, f"{phase}: loss did not fall {loss}")


def check_counts(phase: str, counts: dict, want: dict) -> None:
    for k, n in want.items():
        check(counts[k] == n, f"{phase}: {k} launched {counts[k]} times, "
                              f"not {n}")


def train_phase(torch, model, params, state, bn_calls) -> tuple:
    import numpy as np

    from apex_tpu_torch.models import analytic_flops
    from apex_tpu_torch.train import Trainer

    batch, image, warm, timed = 256, 224, 3, 10
    tr = Trainer(model, params, state, opt_level="O2")
    rs = np.random.RandomState(0)                # bench.py:1269-1271
    x = torch.from_numpy(rs.randn(batch, image, image, 3)).cuda().to(
        tr.half).permute(0, 3, 1, 2)             # NHWC data, channels_last
    y = torch.from_numpy(rs.randint(0, model.num_classes, batch).astype(
        np.int32)).cuda()
    r = timed_steps(torch, lambda: tr.step(x, y), warm, timed)
    counts = r["counts"]
    prof = profile_steps(torch, lambda: tr.step(x, y))
    row = {"phase": "train", "model": "resnet50", "batch": batch,
           "image": image, "dtype": "bfloat16", "opt_level": "O2",
           "loss_scale": float(tr.handle.loss_scale(tr.amp_state)),
           **step_row(r, batch, timed, analytic_flops(model, image)),
           "flat_total": tr.table.total,
           "segments": tr.table.num_segments, "launches": counts,
           "profile": prof}
    emit(row)
    check_losses("train", r["loss"])
    n_bn = sum(bn_calls.values())
    check_counts("train", counts, {
        k: timed * (n_bn if k.startswith("bn_") else 1)
        for k in TRAIN_KERNELS})
    return counts, row


# -- phases 11-13: the ImageNet example's slice -------------------------------

IMAGENET_KERNELS = ("sgd", "rowsumsq", "rowmaxabs", "novograd")

# main_amp's lr 0.1 has no warm-up, so on one repeated batch its SGD step
# falls for three steps and then overshoots: 7.06 -> 5.82 at step 4, 17.14
# at step 13 (2.43 times the first, the same bits in three runs), and the
# plain versions' path 21.77 (3.08 times; PR 4's chip runs on the H100).
# The kernel path's losses stay under 4 times the first, and the plain
# versions' path (the witness) must overshoot the same way: the first
# WITNESS_STEPS losses within WITNESS_RTOL of the kernel path's (read
# 1.2e-3), and its last above WITNESS_RISE times its least.
SGD_OVERSHOOT = 4.0
WITNESS_STEPS, WITNESS_RTOL, WITNESS_RISE = 4, 1e-2, 1.25


def plain_witness(torch, make, x, y, n: int) -> dict:
    """``n`` steps of a fresh trainer from ``make`` under the plain
    versions (``dispatch.backend("reference")``): its losses and the
    kernel launches it made (none)."""
    from apex_tpu_torch.ops import dispatch
    with dispatch.backend("reference"):
        tr = make()
        zero_counts()
        loss = [float(tr.step(x, y)) for _ in range(n)]
        torch.cuda.synchronize()
        launches = read_counts()
    return {"losses": loss, "launches": launches}


def check_witness(phase: str, loss: list, w: dict) -> None:
    plain = w["losses"]
    check(not any(w["launches"].values()),
          f"{phase} witness: kernels launched {w['launches']}")
    check(len(plain) == len(loss) and all(
        abs(a - b) <= WITNESS_RTOL * abs(b)
        for a, b in zip(loss[:WITNESS_STEPS], plain[:WITNESS_STEPS])),
        f"{phase} witness: kernel losses {loss} against plain {plain}")
    check(plain[-1] >= WITNESS_RISE * min(plain),
          f"{phase} witness: the plain path does not overshoot {plain}")


def imagenet_batch(torch, batch: int, image: int, classes: int):
    """main_amp.py's synthetic uint8 pool (:362-364), here one batch of
    (image + 8)² images center-cropped to image² as its hold-out is
    (:367-370); labels from the same RandomState."""
    import numpy as np
    rs = np.random.RandomState(0)
    pool = rs.randint(0, 256, (batch, image + 8, image + 8, 3),
                      dtype=np.uint8)
    y = rs.randint(0, classes, batch).astype(np.int32)
    x = np.ascontiguousarray(pool[:, 4:4 + image, 4:4 + image])
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def imagenet_phases(torch, model, params, state, bn_calls) -> dict:
    """main_amp.py's step at full width: FusedSGD (imagenet_train, with a
    profile and one evaluate), LARC(FusedSGD) and FusedNovoGrad at L2 and
    L-inf norms. Returns each run's launch counts."""
    from apex_tpu_torch.models import analytic_flops
    from apex_tpu_torch.train import Trainer

    batch, image = 256, 224
    n_bn = sum(bn_calls.values())
    flops = analytic_flops(model, image)
    x, y = imagenet_batch(torch, batch, image, model.num_classes)
    # (phase, Trainer keywords, warm-up, timed, launches a step); main_amp
    # passes its flags to the class (main_amp.py:208-210)
    runs = (("imagenet_train", dict(optimizer="sgd", **MAIN_AMP_SGD), 3, 10,
             {"sgd": 1}),
            ("imagenet_larc", dict(optimizer="sgd", larc=True), 3, 5,
             {"sgd": 1, "rowsumsq": 2}),
            ("imagenet_novograd", dict(optimizer="novograd", lr=1e-2), 3, 5,
             {"novograd": 1, "rowsumsq": 1}),
            ("imagenet_novograd", dict(optimizer="novograd", lr=1e-2,
                                       norm_type=0), 3, 5,
             {"novograd": 1, "rowmaxabs": 1}))
    out = {}
    for phase, kw, warm, timed, per_step in runs:
        def make():
            return Trainer(model, params, state, opt_level="O2", **kw)

        tr = make()
        r = timed_steps(torch, lambda: tr.step(x, y), warm, timed)
        counts = r["counts"]
        want = {k: timed * per_step.get(k, 0) for k in IMAGENET_KERNELS}
        want.update({k: timed * (n_bn if k.startswith("bn_") else
                                 int(k == "scale"))
                     for k in TRAIN_KERNELS})
        row = {"phase": phase, "model": "resnet50", "batch": batch,
               "image": image, "input": "uint8 NHWC, normalized in the step",
               "dtype": "bfloat16", "opt_level": "O2",
               "loss_scale": float(tr.handle.loss_scale(tr.amp_state)),
               "optimizer": type(tr.opt).__name__,
               "hyperparameters": {k: v for k, v in
                                   tr.opt.param_groups[0].items()},
               **step_row(r, batch, timed, flops),
               "launches": {k: counts[k] for k in want},
               "launches_per_step": {k: counts[k] / timed for k in want}}
        if phase == "imagenet_train":
            row["profile"] = profile_steps(torch, lambda: tr.step(x, y))
            top1, top5 = tr.evaluate(x, y)
            row["evaluate"] = {"top1": float(top1), "top5": float(top5)}
            tr = None                   # the card's memory for the witness
            row["plain_witness"] = plain_witness(torch, make, x, y,
                                                 warm + timed)
        emit(row)
        if phase == "imagenet_train":
            check_losses(phase, r["loss"], overshoot=SGD_OVERSHOOT)
            check_witness(phase, r["loss"], row["plain_witness"])
        else:
            check_losses(phase, r["loss"])
        check_counts(phase, counts, want)
        key = phase if phase != "imagenet_novograd" else \
            f"imagenet_novograd_{row['hyperparameters']['norm_type']}"
        out[key] = counts
        del tr
    return out


IMAGENET_CASES = {
    "sgd": dict(optimizer="sgd"),
    "larc": dict(optimizer="sgd", larc=True),
    "novograd_l2": dict(optimizer="novograd", lr=1e-2),
    "novograd_linf": dict(optimizer="novograd", lr=1e-2, norm_type=0),
}


def imagenet_crosscheck_phase(torch, dispatch):
    """Three steps of main_amp's step on the CI model (uint8 batch) for
    each optimizer, with the kernels and with the plain versions on the
    card, at O0 and O2, under phase 8's bars; two O2 kernel runs must
    give the same losses and masters bit for bit."""
    from apex_tpu_torch.ops import flat
    from apex_tpu_torch.train import Trainer

    torch.backends.cudnn.deterministic = True
    model = _ci_model()
    params, state = model.init(0)
    init = flat.flatten(params, dtype=torch.float32)[0]
    x, y = imagenet_batch(torch, 4, 32, 10)
    result = {}
    for case, kw in IMAGENET_CASES.items():
        def run(level):
            tr = Trainer(model, params, state, opt_level=level, **kw)
            loss = [float(tr.step(x, y)) for _ in range(3)]
            return tr.opt.state[0].master, loss

        gk, loss_k = run("O0")
        hk, loss_hk = run("O2")
        hk2, loss_hk2 = run("O2")
        with dispatch.backend("reference"):
            zero_counts()
            gr, loss_r = run("O0")
            hr, loss_hr = run("O2")
            torch.cuda.synchronize()
            plain_launches = read_counts()
        check(not any(plain_launches.values()),
              f"imagenet_crosscheck {case}: kernels launched in the plain "
              f"runs {plain_launches}")
        upd = gr - init
        o0 = {"master": float((gk - gr).abs().max()),
              "update_rel_l2": float(torch.linalg.vector_norm(gk - gr)
                                     / torch.linalg.vector_norm(upd)),
              "update_max": float(upd.abs().max())}
        d_o2, d_bf16 = (hk - hr).abs(), (hr - gr).abs()
        o2 = {"mean": float(d_o2.mean()), "max": float(d_o2.max()),
              "bf16_mean": float(d_bf16.mean()),
              "bf16_max": float(d_bf16.max())}
        loss_lim = [max(5e-3, 1.5 * abs(a - b))
                    for a, b in zip(loss_hr, loss_r)]
        repeat = loss_hk == loss_hk2 and bool(torch.equal(hk, hk2))
        result[case] = {"O0": {"max_abs_err": o0, "loss_kernels": loss_k,
                               "loss_plain": loss_r},
                        "O2": {"master_err": o2, "loss_kernels": loss_hk,
                               "loss_plain": loss_hr, "loss_limit": loss_lim},
                        "repeat_equal": repeat}
        check(o0["master"] <= O0_MASTER_ATOL
              and o0["update_rel_l2"] <= O0_UPDATE_RTOL,
              f"imagenet_crosscheck {case} O0: masters differ by {o0}")
        check(o2["mean"] <= 1.5 * o2["bf16_mean"]
              and o2["max"] <= 1.5 * o2["bf16_max"],
              f"imagenet_crosscheck {case} O2: masters differ by {o2}")
        check(all(abs(a - b) <= lim for a, b, lim in
                  zip(loss_hk, loss_hr, loss_lim)),
              f"imagenet_crosscheck {case} O2: losses {loss_hk} vs "
              f"{loss_hr}")
        check(repeat, f"imagenet_crosscheck {case}: two kernel runs differ")
    emit({"phase": "imagenet_crosscheck", "steps": 3, "model": "CI ResNet",
          "O0_atol": O0_MASTER_ATOL, "O0_update_rtol": O0_UPDATE_RTOL,
          **result})
    torch.backends.cudnn.deterministic = False


def _ci_model():
    from apex_tpu_torch.models import ResNet
    # bench.py:1248's CI model: stage 1 opens with a stride-2 bottleneck
    return ResNet(block_sizes=(1, 1), bottleneck=True, num_classes=10,
                  width=8)


def _ci_batch(torch, dtype):
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(4, 3, 32, 32, generator=g, device="cuda").to(dtype)
    y = torch.randint(0, 10, (4,), generator=g, device="cuda")
    return x, y


def overflow_phase(torch):
    from apex_tpu_torch.train import Trainer

    model = _ci_model()
    params, state = model.init(0)
    tr = Trainer(model, params, state, opt_level="O2",
                 half_dtype=torch.float16, loss_scale="dynamic")
    x, y = _ci_batch(torch, torch.float16)
    gs0 = tr.opt.state[0]
    scale0 = float(tr.handle.loss_scale(tr.amp_state))
    flat_grad, _, new_bn = tr.loss_and_grad(x, y)
    flat_grad[tr.table.offsets[3] + 1] = float("inf")
    found = bool(tr.apply_grads(flat_grad, new_bn))
    gs1 = tr.opt.state[0]
    scale1 = float(tr.handle.loss_scale(tr.amp_state))
    unchanged = {
        "master": bool(torch.equal(gs1.master, gs0.master)),
        "slots": all(bool(torch.equal(gs1.slots[k], gs0.slots[k]))
                     for k in gs0.slots),
        "step": int(gs1.step) == int(gs0.step)}
    tr.step(x, y)
    gs2 = tr.opt.state[0]
    clean = {"step": int(gs2.step), "master_moved": not bool(
        torch.equal(gs2.master, gs0.master)),
        "scale": float(tr.handle.loss_scale(tr.amp_state))}
    emit({"phase": "overflow", "half": "float16", "found_inf": found,
          "scale_before": scale0, "scale_after": scale1,
          "unchanged": unchanged, "clean_step": clean,
          "scaler": tr.handle.state_dict(tr.amp_state)})
    check(found, "overflow: the injected inf was not flagged")
    check(all(unchanged.values()), f"overflow: state moved {unchanged}")
    check(scale0 == 65536.0 and scale1 == 32768.0,
          f"overflow: scale {scale0} -> {scale1}")
    check(clean["step"] == int(gs0.step) + 1 and clean["master_moved"],
          f"overflow: the clean step did not advance {clean}")


O0_MASTER_ATOL = 5e-5
O0_UPDATE_RTOL = 1e-3


def train_crosscheck_phase(torch, dispatch):
    """Three steps of the CI model with every kernel against the plain
    versions on the card. O0 (f32): the BN sums add in another order, so
    a gradient near zero can tip LAMB's first steps, which move a weight
    by about lr times the sign of its gradient; so the masters within
    5e-5 (three steps at lr 1e-3 move a weight by 1e-4 to 1e-3), and the
    whole update within 1e-3 of its own L2 norm, which an update off by a
    percent anywhere fails. O2 (bf16): a bf16 activation may round the
    other way as well; the kernel run's masters may be no farther from the
    plain run's than 1.5 times bf16's own effect (the plain O2 masters
    against the plain O0 ones), in mean and in max, the bar of
    tests/test_torch_resnet.py."""
    from apex_tpu_torch.ops import flat
    from apex_tpu_torch.train import Trainer

    torch.backends.cudnn.deterministic = True
    model = _ci_model()
    params, state = model.init(0)
    x, y = _ci_batch(torch, torch.float32)

    def run(level):
        tr = Trainer(model, params, state, opt_level=level)
        loss = [float(tr.step(x, y)) for _ in range(3)]
        return tr.opt.state[0], loss

    init = flat.flatten(params, dtype=torch.float32)[0]
    gk, loss_k = run("O0")
    hk, loss_hk = run("O2")
    with dispatch.backend("reference"):
        zero_counts()
        gr, loss_r = run("O0")
        hr, loss_hr = run("O2")
        torch.cuda.synchronize()
        plain_launches = read_counts()
    # the plain runs' backward too (it runs on the autograd device thread)
    check(not any(plain_launches.values()),
          f"train_crosscheck: kernels launched in the plain runs "
          f"{plain_launches}")
    errs = {"master": float((gk.master - gr.master).abs().max()),
            **{k: float((gk.slots[k] - gr.slots[k]).abs().max())
               for k in gk.slots}}
    upd = gr.master - init
    errs["update_rel_l2"] = float(torch.linalg.vector_norm(
        gk.master - gr.master) / torch.linalg.vector_norm(upd))
    errs["update_max"] = float(upd.abs().max())
    d_o2 = (hk.master - hr.master).abs()
    d_bf16 = (hr.master - gr.master).abs()
    o2 = {"mean": float(d_o2.mean()), "max": float(d_o2.max()),
          "bf16_mean": float(d_bf16.mean()), "bf16_max": float(d_bf16.max())}
    emit({"phase": "train_crosscheck", "steps": 3,
          "O0": {"atol": O0_MASTER_ATOL, "update_rtol": O0_UPDATE_RTOL,
                 "max_abs_err": errs,
                 "loss_kernels": loss_k, "loss_plain": loss_r},
          "O2": {"master_err": o2, "loss_kernels": loss_hk,
                 "loss_plain": loss_hr}})
    torch.backends.cudnn.deterministic = False
    check(errs["master"] <= O0_MASTER_ATOL
          and errs["update_rel_l2"] <= O0_UPDATE_RTOL,
          f"train_crosscheck O0: masters differ by {errs}")
    check(o2["mean"] <= 1.5 * o2["bf16_mean"]
          and o2["max"] <= 1.5 * o2["bf16_max"],
          f"train_crosscheck O2: masters differ by {o2}")
    check(all(abs(a - b) <= 5e-3 for a, b in zip(loss_hk, loss_hr)),
          f"train_crosscheck O2: losses {loss_hk} vs {loss_hr}")


# -- phases 9-10: the LM training slice ---------------------------------------

def lm_model():
    from apex_tpu_torch.models import TransformerLM
    c = LM_SHAPE
    # tools/lm_bench.py's defaults: attn "fast", the fused head in vocab
    # chunks of min(8192, vocab)
    return TransformerLM(vocab_size=c["vocab"], max_seq_len=c["seq"],
                         embed_dim=c["embed"], num_heads=c["heads"],
                         num_layers=c["layers"], attn_impl="fast",
                         head_chunk=min(8192, c["vocab"]))


def lm_batch(torch):
    """Phase 9's token batch: 8 × 4096 from RandomState(1)."""
    import numpy as np
    c = LM_SHAPE
    return torch.from_numpy(np.random.RandomState(1).randint(
        0, c["vocab"], (c["batch"], c["seq"])).astype(np.int64)).cuda()




def lm_step_flops(n_params: int, c=LM_SHAPE) -> float:
    """lm_bench's FLOP model of one step: 6·P·tokens + 6·L·d·S²·B."""
    return 6.0 * n_params * c["batch"] * c["seq"] + (
        12 * c["layers"] * c["embed"] * c["seq"] ** 2 * c["batch"]) / 2


def lm_train_phase(torch, model, params) -> tuple:
    """tools/lm_bench.py's step at its defaults on one card: O2 bf16 over
    fp32 flat masters, FusedAdam(lr=1e-4), one numpy token batch reused
    every step; 3 warm-up and 10 timed steps, then two profiled ones."""
    from apex_tpu_torch.train import LMTrainer

    c = LM_SHAPE
    warm, timed = 3, 10
    tr = LMTrainer(model, params, lr=1e-4)
    toks = lm_batch(torch)
    r = timed_steps(torch, lambda: tr.step(toks), warm, timed)
    counts = r["counts"]
    tokens = c["batch"] * c["seq"]               # lm_bench's count
    n_params = tr.table.total
    step_flops = lm_step_flops(n_params)
    tok_s = tokens * timed / r["wall"]
    prof = profile_steps(torch, lambda: tr.step(toks), LM_KERNEL_FAMILIES)
    row = {"phase": "lm_train", "model": "TransformerLM", **c,
           "attn_impl": model.attn_impl, "head_chunk": model.head_chunk,
           "dtype": "bfloat16", "masters": "float32", "optimizer":
           "FusedAdam(lr=1e-4)", **window_row(r, timed),
           "tokens_per_step": tokens, "tok_per_s": tok_s,
           "step_tflop": step_flops / 1e12,
           "mfu": step_flops * timed / r["wall"] / BF16_DENSE_OPS_S,
           "params": n_params,
           "launches": {k: counts[k] for k in LM_PER_STEP},
           "launches_per_step": {k: counts[k] / timed for k in LM_PER_STEP},
           "profile": prof}
    emit(row)
    check_losses("lm_train", r["loss"])
    check_counts("lm_train", counts,
                 {k: n * timed for k, n in LM_PER_STEP.items()})
    return counts, row


def crosscheck(torch, dispatch, phase, run, hold_masters=True,
               readings=None, **extra) -> dict:
    """``run(dtype)`` — three training steps from fixed masters, returning
    ``(masters, [flat grad of each step, unscaled], [losses])`` — with the
    kernels (bf16, twice) and with the plain versions on the card (bf16,
    and fp32: ``dtype`` None). Step 1 starts every run from the same
    masters, so its flat gradient holds the kernels' own effect: the
    kernel run's within 1.5 times bf16's (the plain bf16 gradient against
    the plain fp32 one), in mean and in max. After 3 steps the masters
    within 1.5 times bf16's effect in mean, leaving out those whose fp32
    gradient at some step is within 1e-7 of its largest entry (the key
    biases, zero analytically; unused vocabulary rows): Adam and Adagrad
    turn rounding noise there into moves of about lr either way, in every
    run, and cap the largest difference of any master at about 2 × 3 ×
    lr, so the masters' max is reported, not held. Two kernel runs give
    the same losses and masters bit for bit; no kernel launches in the
    plain runs. Only step 1's gradients and the noise mask are kept
    between runs, so a wide model's four runs fit one card. With
    ``hold_masters`` False the masters' gap after 3 steps is printed, not
    held; ``readings()``, called after the four runs, adds its dict to the
    printed row."""
    zero_counts()
    mk, gk, loss_k = run(torch.bfloat16)
    gk = gk[0]
    mk2, gk2, loss_k2 = run(torch.bfloat16)
    del gk2
    torch.cuda.synchronize()
    kernel_launches = {k: n for k, n in read_counts().items() if n}
    with dispatch.backend("reference"):
        zero_counts()
        mr, gr, loss_r = run(torch.bfloat16)
        gr = gr[0]
        mf, gf, loss_f = run(None)
        noise = torch.zeros_like(mk, dtype=torch.bool)
        for g in gf:
            noise |= g.abs() <= 1e-7 * g.abs().max()
        gf = gf[0]
        torch.cuda.synchronize()
        plain_launches = read_counts()
    check(not any(plain_launches.values()),
          f"{phase}: kernels launched in the plain runs {plain_launches}")
    g_k, g_bf16 = (gk - gr).abs(), (gr - gf).abs()
    rest = ~noise
    d_k, d_bf16 = (mk - mr).abs(), (mr - mf).abs()
    errs = {"grad1_mean": float(g_k.mean()), "grad1_max": float(g_k.max()),
            "grad1_bf16_mean": float(g_bf16.mean()),
            "grad1_bf16_max": float(g_bf16.max()),
            "grad1_abs_max": float(gf.abs().max()),
            "mean": float(d_k[rest].mean()), "max": float(d_k[rest].max()),
            "bf16_mean": float(d_bf16[rest].mean()),
            "bf16_max": float(d_bf16[rest].max()),
            "noise_max": float(d_k[noise].max()) if noise.any() else 0.0,
            "noise_elements": int(noise.sum())}
    repeat = loss_k == loss_k2 and bool(torch.equal(mk, mk2))
    row = {"phase": phase, **extra, "steps": 3, "dtype": "bfloat16",
           "err": errs, "masters_held": hold_masters,
           "masters_over_bf16": errs["mean"] / errs["bf16_mean"]
           if errs["bf16_mean"] else None, "loss_kernels": loss_k,
           "loss_kernels_again": loss_k2, "loss_plain": loss_r,
           "loss_plain_f32": loss_f, "repeat_equal": repeat,
           "kernel_launches": kernel_launches,
           **(readings() if readings else {})}
    emit(row)
    check(errs["grad1_mean"] <= 1.5 * errs["grad1_bf16_mean"]
          and errs["grad1_max"] <= 1.5 * errs["grad1_bf16_max"],
          f"{phase}: step 1's gradients differ by {errs}")
    check(not hold_masters or errs["mean"] <= 1.5 * errs["bf16_mean"],
          f"{phase}: masters differ by {errs}")
    check(repeat, f"{phase}: two kernel runs differ {loss_k} vs {loss_k2}")
    check(all(abs(a - b) <= 2e-2 for a, b in zip(loss_k, loss_r)),
          f"{phase}: losses {loss_k} vs {loss_r}")
    return row


def adam_crosscheck(torch, dispatch, phase, model, params, batch,
                    loss_kw, adam, hold_masters=True, readings=None,
                    **trainer_kw) -> dict:
    """``crosscheck`` of three O2 ``LMTrainer`` steps of ``model`` on
    ``batch``; ``trainer_kw`` (``microbatches``, ``loss_scale``) selects
    train_ring's accumulation."""
    from apex_tpu_torch.train import LMTrainer

    def run(dtype):
        tr = LMTrainer(model, params, dtype=dtype, **adam, **trainer_kw)
        grads, loss = [], []
        for _ in range(3):
            if tr.handle is None:
                (g, l_), fi = tr.loss_and_grad(*batch, **loss_kw), None
            else:
                g, fi, l_ = tr.accumulate_grads(*batch, **loss_kw)
            grads.append(g.clone())
            tr.apply_grads(g, fi)
            loss.append(float(l_))
        return tr.opt.state[0].master, grads, loss

    return crosscheck(torch, dispatch, phase, run, hold_masters, readings,
                      **trainer_kw)


def lm_crosscheck_phase(torch, dispatch):
    """A small LM (2 layers, embed 128, 2 heads of 64, vocab 512, S 257,
    batch 2) under ``adam_crosscheck`` at lr 1e-3."""
    from apex_tpu_torch.models import TransformerLM

    m = TransformerLM(vocab_size=512, max_seq_len=256, embed_dim=128,
                      num_heads=2, num_layers=2, attn_impl="fast",
                      head_chunk=512)
    params = m.init(torch.Generator().manual_seed(2))
    toks = torch.randint(0, 512, (2, 257), generator=torch.Generator()
                         .manual_seed(3)).cuda()
    adam_crosscheck(torch, dispatch, "lm_crosscheck", m, params, (toks,),
                    {}, {"lr": 1e-3})


# -- gradient accumulation and the fp16_utils path on lm_bench's LM ----------

# train_ring's --grad-accum 2: phase 9's batch of 8 as 2 microbatches of 4;
# each kernel of the model runs once per microbatch
ACCUM_MICRO = 2
ACCUM_PER_STEP = {"axpby": ACCUM_MICRO, "adam": 1,
                  **{k: ACCUM_MICRO * LM_PER_STEP[k]
                     for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                               "ln_fwd", "ln_bwd")}}
ACCUM_KERNELS = ("axpby", "l2norm", "adagrad")
FP16_MAX_NORM = 1.0


def lm_accum_phase(torch, dispatch, model, params, peak9: int) -> tuple:
    """examples/lm/train_ring.py's accumulation (--grad-accum 2,
    --loss-scale dynamic) on phase 9's model and batch: step 1's
    accumulated flat grad against the one-batch grad of phase 9's step
    from the same masters, then 3 warm-up and 10 timed steps, then an inf
    in microbatch 2 alone."""
    from apex_tpu_torch.ops import flat
    from apex_tpu_torch.train import LMTrainer

    c = LM_SHAPE
    warm, timed = 3, 10
    toks = lm_batch(torch)
    one = LMTrainer(model, params, lr=1e-4)
    g_one, _ = one.loss_and_grad(toks)
    del one
    tr = LMTrainer(model, params, lr=1e-4, microbatches=ACCUM_MICRO,
                   loss_scale="dynamic")
    g_acc, fi, _ = tr.accumulate_grads(toks)
    check(float(fi) == 0.0, "lm_accum: step 1 overflowed")
    # bf16's own effect on the grad: the one-batch grad against the fp32
    # one of the plain versions, taken a sequence at a time (the plain
    # attention's fp32 scores of the whole batch would need ~50 GB)
    with dispatch.backend("reference"):
        f32 = LMTrainer(model, params, lr=1e-4, dtype=None,
                        microbatches=c["batch"])
        g_f32, _, _ = f32.accumulate_grads(toks)
        del f32
    d_acc, d_bf16 = (g_acc - g_one).abs(), (g_one - g_f32).abs()
    grad1 = {"mean": float(d_acc.mean()), "max": float(d_acc.max()),
             "bf16_mean": float(d_bf16.mean()),
             "bf16_max": float(d_bf16.max()),
             "abs_max": float(g_f32.abs().max())}
    del g_one, g_acc, g_f32, d_acc, d_bf16
    check(grad1["mean"] <= 1.5 * grad1["bf16_mean"]
          and grad1["max"] <= 1.5 * grad1["bf16_max"],
          f"lm_accum: step 1's accumulated grad differs from the one-batch "
          f"grad by {grad1}")
    # a fresh trainer from the same masters for the timed window
    tr = LMTrainer(model, params, lr=1e-4, microbatches=ACCUM_MICRO,
                   loss_scale="dynamic")
    r = timed_steps(torch, lambda: tr.step(toks), warm, timed)
    counts = r["counts"]
    tokens = c["batch"] * c["seq"]
    tok_s = tokens * timed / r["wall"]
    flops = lm_step_flops(tr.table.total)

    # an inf in microbatch 2 alone: the step skipped bit for bit, the scale
    # halved, one overflow counted
    def bad_loss(m, mb):
        t, poison = mb
        p = flat.unflatten(m, tr.table, dtype=torch.bfloat16)
        return model.loss(p, t) + m.sum() * poison

    poison = torch.tensor([0.0, float("inf")], device="cuda")
    micro = (toks.reshape(ACCUM_MICRO, -1, c["seq"]), poison)
    gs0, st0 = tr.opt.state[0], tr.amp_state[0]
    fg, fi, _ = tr.handle.accumulate_grads(bad_loss, gs0.master, micro,
                                           tr.amp_state)
    tr.apply_grads(fg, fi)
    gs1, st1 = tr.opt.state[0], tr.amp_state[0]
    inject = {"found_inf": float(fi),
              "master": bool(torch.equal(gs1.master, gs0.master)),
              "slots": all(bool(torch.equal(gs1.slots[k], gs0.slots[k]))
                           for k in gs0.slots),
              "step": int(gs1.step) == int(gs0.step),
              "scale_before": float(st0.scale),
              "scale_after": float(st1.scale),
              "overflows": int(st1.overflow_count) - int(st0.overflow_count)}
    row = {"phase": "lm_accum", "model": "TransformerLM", **c,
           "microbatches": ACCUM_MICRO, "loss_scale": "dynamic",
           "attn_impl": model.attn_impl, "dtype": "bfloat16",
           "masters": "float32", "optimizer": "FusedAdam(lr=1e-4)",
           **window_row(r, timed), "tokens_per_step": tokens,
           "tok_per_s": tok_s, "step_tflop": flops / 1e12,
           "mfu": flops * timed / r["wall"] / BF16_DENSE_OPS_S,
           "peak_mem_bytes_phase9": peak9, "grad1_err": grad1,
           "launches": {k: counts[k] for k in ACCUM_PER_STEP},
           "launches_per_step": {k: counts[k] / timed
                                 for k in ACCUM_PER_STEP},
           "inject_microbatch2": inject}
    emit(row)
    loss = r["loss"]
    check(all(math.isfinite(v) for v in loss)
          and loss[0] > loss[1] > loss[2],
          f"lm_accum: losses not finite, or the first three not falling "
          f"{loss}")
    check_counts("lm_accum", counts,
                 {k: n * timed for k, n in ACCUM_PER_STEP.items()})
    check(r["peak"] < peak9, f"lm_accum: peak memory {r['peak']} is not "
                             f"below phase 9's {peak9}")
    check(inject["found_inf"] == 1.0 and inject["master"] and inject["slots"]
          and inject["step"] and inject["overflows"] == 1
          and inject["scale_after"] == inject["scale_before"] / 2,
          f"lm_accum: the poisoned microbatch was not skipped {inject}")
    return counts, row


def fp16_grads(torch, model, opt, toks):
    """The grads of ``opt.scale_loss(loss)`` with respect to the model's
    param tree (``opt.params_tree()``, the masters in the model dtype),
    and the loss."""
    from apex_tpu_torch.ops import flat
    params = flat.tree_map(lambda t: t.detach().requires_grad_(True),
                           opt.params_tree())
    leaves, treedef = flat.tree_flatten(params)
    loss = model.loss(params, toks)
    grads = torch.autograd.grad(opt.scale_loss(loss), leaves)
    return flat.tree_unflatten(treedef, list(grads)), loss.detach()


def fp16opt_adagrad_phase(torch, dispatch, model, params) -> tuple:
    """The legacy fp16_utils path on phase 9's model and batch:
    ``FP16_Optimizer(FusedAdagrad(lr=1e-4, model_dtype=bf16),
    dynamic_loss_scale=True)``, each step the grads of the scaled loss,
    ``clip_master_grads(1.0)`` and ``step``: 3 warm-up and 5 timed steps
    (CUDA events around each step; each step reads the overflow flag on
    the host), each step's norm held against the plain version's on the
    same grads between the steps; then an injected overflow."""
    from apex_tpu_torch.fp16_utils import FP16_Optimizer
    from apex_tpu_torch.optimizers import FusedAdagrad
    from apex_tpu_torch.prof import numerics

    c = LM_SHAPE
    warm, timed = 3, 5
    toks = lm_batch(torch)
    opt = FP16_Optimizer(FusedAdagrad(params, lr=1e-4,
                                      model_dtype=torch.bfloat16),
                         dynamic_loss_scale=True)
    n_leaves = opt.optimizer._tables[0].num_segments
    losses, norms, rel = [], [], []
    step_ms = []
    torch.cuda.synchronize()
    for i in range(warm + timed):
        if i == warm:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        grads, loss = fp16_grads(torch, model, opt, toks)
        clipped, norm = opt.clip_master_grads(FP16_MAX_NORM, grads)
        opt.step(clipped)
        b.record()
        if i >= warm:
            torch.cuda.synchronize()
            step_ms.append(a.elapsed_time(b))
        check(not opt.overflow, f"fp16opt_adagrad: step {i} overflowed")
        with dispatch.backend("reference"):
            _, norm0 = opt.clip_master_grads(FP16_MAX_NORM, grads)
        rel.append(float((norm - norm0).abs() / norm0))
        losses.append(float(loss))
        norms.append(float(norm))
        del grads, clipped
    counts = read_counts()          # the plain norm checks launch none
    peak = torch.cuda.max_memory_allocated()
    coefs = [min(FP16_MAX_NORM / (n + 1e-6), 1.0) for n in norms]
    flops = lm_step_flops(opt.optimizer._tables[0].total)
    tokens = c["batch"] * c["seq"]
    per_step = {"l2norm": 1, "adagrad": 1, "scale": 1 + n_leaves}
    # an inf in one leaf's grad: the clip passes it through, the step is
    # skipped, the leaf named
    grads, _ = fp16_grads(torch, model, opt, toks)
    leaf = "layer_3/mlp/w1"
    grads["layer_3"]["mlp"]["w1"][7, 11] = float("inf")
    gs0, scale0 = opt.optimizer.state[0], opt.loss_scale
    opt.step(opt.clip_master_grads(FP16_MAX_NORM, grads)[0])
    gs1 = opt.optimizer.state[0]
    inject = {"overflow": opt.overflow,
              "master": bool(torch.equal(gs1.master, gs0.master)),
              "slots": bool(torch.equal(gs1.slots["sum"],
                                        gs0.slots["sum"])),
              "step": int(gs1.step) == int(gs0.step),
              "scale_before": scale0, "scale_after": opt.loss_scale,
              "culprits": opt.last_culprits,
              "leaves": numerics.tree_meta(grads).n}
    del grads
    step_ms_sorted = sorted(step_ms)
    row = {"phase": "fp16opt_adagrad", "model": "TransformerLM", **c,
           "dtype": "bfloat16", "masters": "float32",
           "optimizer": "FP16_Optimizer(FusedAdagrad(lr=1e-4), "
                        "dynamic_loss_scale=True)",
           "max_norm": FP16_MAX_NORM, "steps_timed": timed,
           "tok_per_s": tokens * timed / (sum(step_ms) / 1e3),
           "step_ms_p50": statistics.median(step_ms),
           "step_ms_p95": step_ms_sorted[min(timed - 1, int(round(
               0.95 * (timed - 1))))],
           "mfu": flops * timed / (sum(step_ms) / 1e3) / BF16_DENSE_OPS_S,
           "peak_mem_bytes": peak, "losses": losses, "norms": norms,
           "clip_coef": coefs, "norm_rel_err": rel, "grad_leaves": n_leaves,
           "launches": {k: counts[k] for k in per_step},
           "launches_per_step": {k: counts[k] / timed for k in per_step},
           "inject": inject}
    emit(row)
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"fp16opt_adagrad: losses not finite and falling {losses}")
    check(max(rel) <= 1e-5, f"fp16opt_adagrad: norms off the plain "
                            f"version's by {rel}")
    check_counts("fp16opt_adagrad", counts,
                 {k: n * timed for k, n in per_step.items()})
    check(inject["overflow"] and inject["master"] and inject["slots"]
          and inject["step"] and inject["scale_after"] == scale0 / 2
          and inject["culprits"][:1] == [{
              "path": leaf, "inf": 1, "nan": 0,
              "abs_max": inject["culprits"][0]["abs_max"]}],
          f"fp16opt_adagrad: the injected overflow {inject}")
    return counts, row


def fp16opt_crosscheck_phase(torch, dispatch):
    """The small LM of phase 10 (batch 4) under ``crosscheck``:
    ``LMTrainer(microbatches=2, loss_scale="dynamic")``, and
    ``FP16_Optimizer(FusedAdagrad)`` with clipping in both weight-decay
    modes."""
    from apex_tpu_torch.fp16_utils import FP16_Optimizer
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.optimizers import FusedAdagrad

    m = TransformerLM(vocab_size=512, max_seq_len=256, embed_dim=128,
                      num_heads=2, num_layers=2, attn_impl="fast",
                      head_chunk=512)
    params = m.init(torch.Generator().manual_seed(2))
    toks = torch.randint(0, 512, (4, 257), generator=torch.Generator()
                         .manual_seed(3)).cuda()
    rows = [adam_crosscheck(torch, dispatch, "fp16opt_crosscheck", m,
                            params, (toks,), {}, {"lr": 1e-3},
                            microbatches=2, loss_scale="dynamic")]
    for w_mode in (False, True):
        def run(dtype, w_mode=w_mode):
            opt = FP16_Optimizer(FusedAdagrad(
                params, lr=1e-3, weight_decay=1e-2, adagrad_w_mode=w_mode,
                model_dtype=dtype), dynamic_loss_scale=True)
            grads, loss = [], []
            for _ in range(3):
                g, l_ = fp16_grads(torch, m, opt, toks)
                grads.append(opt.optimizer.flatten_grads(g)[0]
                             / opt.scaler_state.scale)
                clipped, _ = opt.clip_master_grads(0.25, g)
                opt.step(clipped)
                loss.append(float(l_))
            return opt.optimizer.state[0].master, grads, loss
        rows.append(crosscheck(torch, dispatch, "fp16opt_crosscheck", run,
                               optimizer="FP16_Optimizer(FusedAdagrad)",
                               adagrad_w_mode=w_mode, max_norm=0.25))
    return rows


# -- phases 14-16: the Seq2Seq Transformer's training step -------------------

# examples/seq2seq/train_translation.py's model at the Transformer-base
# widths (its class defaults: 6 + 6 layers, 512 wide, 8 heads of 64, FFN
# 2048, max_seq_len 512) with Vaswani et al.'s ~37000-token shared BPE
# vocabulary, attention "fast", dropout 0 (fairseq transformer_wmt_en_de's
# attention_dropout); its make_batch at B 128, seq_len 128
S2S = dict(src_vocab_size=37000, tgt_vocab_size=37000, max_seq_len=512,
           embed_dim=512, num_heads=8, num_encoder_layers=6,
           num_decoder_layers=6, ffn_mult=4, pad_id=0, attn_impl="fast")
S2S_BATCH, S2S_SEQ = 128, 128
S2S_PAD, S2S_BOS, S2S_EOS, S2S_RESERVED = 0, 1, 2, 3
# fairseq transformer_wmt_en_de's Adam and peak lr; Table 3's eps_ls
S2S_ADAM = dict(lr=5e-4, betas=(0.9, 0.98), eps=1e-9)
S2S_SMOOTHING = 0.1
# launches of each kernel in one step: 6 encoder self-attentions, 6
# decoder self- and 6 cross-attentions; 2 LayerNorms an encoder layer,
# 3 a decoder layer, and the two final ones; one loss; one Adam
S2S_PER_STEP = {"xent_fwd": 1, "xent_bwd": 1, "flash_fwd": 18,
                "flash_bwd_dq": 18, "flash_bwd_dkv": 18, "ln_fwd": 32,
                "ln_bwd": 32, "adam": 1}
S2S_FAMILIES = (("xent kernels", ("xent_fwd_kernel", "xent_bwd_kernel")),
                ) + LM_KERNEL_FAMILIES
# the plain witness's 3 losses within this share of the kernel path's
# (bf16 O2: the flash kernels round P and dS to bf16 where the plain
# versions keep fp32). Read 3.8e-6, 2.1e-6, 2.5e-6 on an H100 80GB HBM3
# at 700 W (PERF.md); the limit keeps 26 times the largest
S2S_WITNESS_RTOL = 1e-4


def s2s_batch(torch, rs, n: int, seq_len: int, vocab: int):
    """train_translation.py's make_batch (:99-111): sources of uniform
    length in [seq_len / 2, seq_len], padded; targets BOS, the reversed
    source through the fixed permutation of RandomState(7), EOS."""
    import numpy as np
    perm = np.arange(vocab)
    perm[S2S_RESERVED:] = np.random.RandomState(7).permutation(
        perm[S2S_RESERVED:])
    src = np.full((n, seq_len), S2S_PAD, np.int32)
    tgt = np.full((n, seq_len + 2), S2S_PAD, np.int32)
    for i in range(n):
        ln = rs.randint(seq_len // 2, seq_len + 1)
        s = rs.randint(S2S_RESERVED, vocab, ln)
        src[i, :ln] = s
        tgt[i, 0] = S2S_BOS
        tgt[i, 1:1 + ln] = perm[s[::-1]]
        tgt[i, 1 + ln] = S2S_EOS
    return torch.from_numpy(src).cuda(), torch.from_numpy(tgt).cuda()


def s2s_flops(c: dict, b: int, ts: int, tt: int) -> float:
    """Analytic FLOPs of one training step (3 × the forward's products,
    every token slot counted, padding included, as the step computes
    them): encoder layer QKV 6·E², out 2·E², MLP 4·E·F per source token
    and attention 4·Ts·E per source token; decoder layer self QKV and out
    8·E², causal attention 4·E·(Tt+1)/2, cross q and out 4·E² per target
    token and kv 4·E² per source token, cross attention 4·Ts·E, MLP
    4·E·F; the head 2·E·V per target token."""
    e, f, v = c["embed_dim"], c["ffn_mult"] * c["embed_dim"], \
        c["tgt_vocab_size"]
    enc = b * ts * (8 * e * e + 4 * e * f + 4 * ts * e)
    dec = b * tt * (8 * e * e + 2 * e * (tt + 1) + 4 * e * e + 4 * ts * e
                    + 4 * e * f) + b * ts * 4 * e * e
    head = b * tt * 2 * e * v
    fwd = c["num_encoder_layers"] * enc + c["num_decoder_layers"] * dec \
        + head
    return 3.0 * fwd


def s2s_kernel_phase(torch, timer) -> dict:
    """The Seq2Seq step's new kernel work at its shapes: the softmax
    cross-entropy kernels over the loss's fp32 logits [B·Tt, V] =
    [16512, 37000] at label smoothing 0.1, and the flash kernels with the
    source's key-padding kv_bias at the encoder's self-attention shape
    [B·H, Ts, D] = [1024, 128, 64] and the cross-attention's (Sq 129,
    Sk 128), bf16, against their plain versions on the same inputs."""
    import numpy as np
    import torch.nn.functional as F

    from apex_tpu_torch.ops import flash_attn as FA
    from apex_tpu_torch.ops import xentropy as XE

    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = {}
    b, ts, tt = S2S_BATCH, S2S_SEQ, S2S_SEQ + 1
    n, v = b * tt, S2S["tgt_vocab_size"]
    eps = S2S_SMOOTHING
    x = torch.randn(n, v, generator=gen, device="cuda") * 2
    lab = torch.randint(S2S_RESERVED, v, (n,), generator=gen, device="cuda")
    lab[::4] = S2S_PAD
    lab[1] = v - 1
    g = torch.where(lab == S2S_PAD, 0.0,
                    torch.rand(n, generator=gen, device="cuda"))
    loss, lse = XE.xent_fwd(x, lab, eps)
    loss0, lse0 = XE.xent_fwd_plain(x, lab, eps)
    dx = XE.xent_bwd(x, lab, lse, g, eps)
    dx0 = XE.xent_bwd_plain(x, lab, lse, g, eps)
    torch.cuda.synchronize()
    # loss and lse within 1e-5 relative (the row's max and sums in another
    # order); dx bit-equal: given lse, each element is the plain version's
    # expf and _rn operations in its order
    rel = max(float(((loss - loss0).abs() / loss0.abs()).max()),
              float(((lse - lse0).abs() / lse0.abs()).max()))
    dx_max = float((dx - dx0).abs().max())
    dx_equal = bool(torch.equal(dx, dx0))
    repeat = bool(torch.equal(XE.xent_fwd(x, lab, eps)[0], loss)) and \
        bool(torch.equal(XE.xent_bwd(x, lab, lse, g, eps), dx))
    emit({"phase": "xent_tol", "loss_lse_max_rel_err": rel,
          "loss_max_abs_err": float((loss - loss0).abs().max()),
          "dx_max_abs_err": dx_max, "dx_bit_equal": dx_equal,
          "repeat_equal": repeat})
    check(rel <= 1e-5, f"xent_fwd: loss/lse off by {rel} relative")
    check(dx_equal, f"xent_bwd: dx differs from the plain version by up "
                    f"to {dx_max}")
    check(repeat, "xent: two runs on the same inputs differ")
    del dx0
    lab64 = lab.long()
    xl = x.clone().requires_grad_(True)
    lib_loss = F.cross_entropy(xl, lab64, label_smoothing=eps,
                               ignore_index=S2S_PAD, reduction="none")
    nbytes = n * v * 4
    b_ms, b_by = bound(nbytes + 8 * n + 8 * n, 6 * n * v)
    fwd = dict(kernel="xent_fwd", dtype="float32", shape=[n, v],
               smoothing=eps, max_abs_err=float((loss - loss0).abs().max()),
               max_rel_err=rel, tol="loss, lse: 1e-5 relative",
               per_step=S2S_PER_STEP["xent_fwd"],
               ms=timer(lambda: XE.xent_fwd(x, lab, eps)),
               plain_ms=timer(lambda: XE.xent_fwd_plain(x, lab, eps)),
               library_ms=timer(lambda: F.cross_entropy(
                   x, lab64, label_smoothing=eps, ignore_index=S2S_PAD,
                   reduction="none")),
               library_call="F.cross_entropy(label_smoothing=0.1, "
                            "ignore_index=0, reduction='none')",
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: XE.xent_fwd(x, lab, eps)))
    b_ms, b_by = bound(2 * nbytes + 16 * n, 7 * n * v)
    bwd = dict(kernel="xent_bwd", dtype="float32", shape=[n, v],
               smoothing=eps, max_abs_err=dx_max, tol="dx: bit-equal",
               repeat_equal=repeat, per_step=S2S_PER_STEP["xent_bwd"],
               ms=timer(lambda: XE.xent_bwd(x, lab, lse, g, eps)),
               plain_ms=timer(lambda: XE.xent_bwd_plain(x, lab, lse, g,
                                                        eps)),
               library_ms=timer(lambda: torch.autograd.grad(
                   lib_loss, xl, g, retain_graph=True)),
               library_call="the backward of that F.cross_entropy",
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: XE.xent_bwd(
                   x, lab, lse, g, eps)))
    for r in (fwd, bwd):
        emit({"phase": "kernels", **r})
        rows[(r["kernel"], "float32")] = r
    del x, xl, lib_loss, dx, loss0, lse0

    # flash with the key-padding kv_bias: the sources' lengths as
    # make_batch draws them (uniform in [64, 128])
    H = S2S["num_heads"]
    D = S2S["embed_dim"] // H
    BH = b * H
    lengths = torch.from_numpy(np.random.RandomState(0).randint(
        ts // 2, ts + 1, b)).cuda()
    keep = torch.arange(ts, device="cuda")[None, :] < lengths[:, None]
    kvb = torch.where(keep, 0.0, FA.NEG_INF).repeat_interleave(H, dim=0)
    live_keys = int(lengths.sum()) * H        # summed over bh
    mask4 = torch.where(keep, 0.0, FA.NEG_INF).to(torch.bfloat16)[
        :, None, None, :]

    def rnd(s):
        return torch.randn(BH, s, D, generator=gen, device="cuda").to(
            torch.bfloat16)

    for shape, sq in (("encoder", ts), ("cross", tt)):
        q, do, k, v_ = rnd(sq), rnd(sq), rnd(ts), rnd(ts)
        kw = dict(causal=False, scale=D ** -0.5, kv_bias=kvb)
        o, lse = FA.flash_fwd(q, k, v_, **kw)
        delta = FA.flash_delta(o, do)
        dq = FA.flash_bwd_dq(q, k, v_, do, lse, delta, **kw)
        dk, dv = FA.flash_bwd_dkv(q, k, v_, do, lse, delta, **kw)
        o0, lse0 = FA.reference_attention(q, k, v_, return_lse=True, **kw)
        dq0, dk0, dv0 = FA.flash_bwd_plain(q, k, v_, do, lse, delta, **kw)
        torch.cuda.synchronize()
        errs = {w: flash_err(torch, a, b0) for w, a, b0 in
                (("o", o, o0), ("dq", dq, dq0), ("dk", dk, dk0),
                 ("dv", dv, dv0))}
        lse_err = float((lse - lse0).abs().max())
        emit({"phase": "flash_tol", "shape": shape, "kv_bias": True,
              "lse_err": lse_err, **errs})
        check(lse_err <= 1e-3, f"flash kv_bias {shape} lse: {lse_err}")
        for w, e in errs.items():
            check(e["used"] <= 1.0, f"flash kv_bias {shape} {w}: {e}")
        # dk, dv of masked keys are exactly zero
        masked = ~keep.repeat_interleave(H, dim=0)
        check(not dk[masked].any() and not dv[masked].any(),
              f"flash kv_bias {shape}: masked keys got a gradient")
        q4, k4, v4, do4 = (t.view(b, H, -1, D) for t in (q, k, v_, do))
        ql, kl, vl = (t.detach().clone().requires_grad_(True)
                      for t in (q4, k4, v4))
        lo = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask4)
        lib_bwd = timer(lambda: torch.autograd.grad(
            lo, (ql, kl, vl), do4, retain_graph=True))
        pairs = sq * live_keys               # scores the data needs
        sz_q, sz_k = BH * sq * D * 2, BH * ts * D * 2
        common = dict(dtype="bfloat16", shape=[BH, sq, ts, D],
                      kv_bias="[B·H, Sk] key padding", path_shape=shape,
                      per_step=6, causal=False)
        b_ms, b_by = bound(2 * sz_q + 2 * sz_k + 4 * BH * ts
                           + 4 * BH * sq, 4 * D * pairs, BF16_DENSE_OPS_S)
        r_fwd = dict(kernel="flash_fwd", **common,
                     max_abs_err=errs["o"]["max_abs_err"],
                     tol_used=errs["o"]["used"], lse_err=lse_err,
                     ms=timer(lambda: FA.flash_fwd(q, k, v_, **kw)),
                     plain_ms=timer(lambda: FA.reference_attention(
                         q, k, v_, return_lse=True, **kw)),
                     library_ms=timer(
                         lambda: F.scaled_dot_product_attention(
                             q4, k4, v4, attn_mask=mask4)),
                     bound_ms=b_ms, bound_by=b_by,
                     host_us=host_us(torch, lambda: FA.flash_fwd(
                         q, k, v_, **kw)))
        plain_bwd_ms = timer(lambda: FA.flash_bwd_plain(
            q, k, v_, do, lse, delta, **kw))
        b_ms, b_by = bound(3 * sz_q + 2 * sz_k + 4 * BH * ts
                           + 8 * BH * sq, 6 * D * pairs, BF16_DENSE_OPS_S)
        r_dq = dict(kernel="flash_bwd_dq", **common,
                    max_abs_err=errs["dq"]["max_abs_err"],
                    tol_used=errs["dq"]["used"],
                    ms=timer(lambda: FA.flash_bwd_dq(
                        q, k, v_, do, lse, delta, **kw)),
                    plain_ms=plain_bwd_ms, library_ms=lib_bwd,
                    library_covers="dq, dk and dv (one SDPA backward)",
                    plain_covers="dq, dk and dv (one flash_bwd_plain)",
                    bound_ms=b_ms, bound_by=b_by,
                    host_us=host_us(torch, lambda: FA.flash_bwd_dq(
                        q, k, v_, do, lse, delta, **kw)))
        b_ms, b_by = bound(2 * sz_q + 4 * sz_k + 4 * BH * ts
                           + 8 * BH * sq, 8 * D * pairs, BF16_DENSE_OPS_S)
        r_dkv = dict(kernel="flash_bwd_dkv", **common,
                     max_abs_err=max(errs["dk"]["max_abs_err"],
                                     errs["dv"]["max_abs_err"]),
                     tol_used=max(errs["dk"]["used"], errs["dv"]["used"]),
                     ms=timer(lambda: FA.flash_bwd_dkv(
                         q, k, v_, do, lse, delta, **kw)),
                     plain_ms=plain_bwd_ms, library_ms=lib_bwd,
                     library_covers="dq, dk and dv (one SDPA backward)",
                     plain_covers="dq, dk and dv (one flash_bwd_plain)",
                     bound_ms=b_ms, bound_by=b_by,
                     host_us=host_us(torch, lambda: FA.flash_bwd_dkv(
                         q, k, v_, do, lse, delta, **kw)))
        for r in (r_fwd, r_dq, r_dkv):
            emit({"phase": "kernels", **r})
            rows[(r["kernel"], "kv_bias", shape)] = r
        del q, k, v_, do, o, dq, dk, dv, o0, dq0, dk0, dv0, ql, kl, vl, lo
    return rows


def s2s_model():
    from apex_tpu_torch.models import Seq2SeqTransformer
    return Seq2SeqTransformer(**S2S)


def s2s_train_phase(torch, model, params) -> tuple:
    """The translation example's step at Transformer-base width on one
    card: O2 bf16 over fp32 flat masters through ``LMTrainer``, label
    smoothing 0.1, FusedAdam(5e-4, (0.9, 0.98), 1e-9), one make_batch
    batch reused every step; 3 warm-up and 10 timed steps, two profiled
    ones, and the plain witness: 3 steps from the same init under the
    plain versions, no kernel launched, losses within S2S_WITNESS_RTOL."""
    import math

    import numpy as np

    from apex_tpu_torch.ops import dispatch
    from apex_tpu_torch.train import LMTrainer

    warm, timed = 3, 10
    src, tgt = s2s_batch(torch, np.random.RandomState(0), S2S_BATCH,
                         S2S_SEQ, S2S["src_vocab_size"])

    def make():
        return LMTrainer(model, params, **S2S_ADAM)

    def step():
        return tr.step(src, tgt, label_smoothing=S2S_SMOOTHING)

    tr = make()
    r = timed_steps(torch, step, warm, timed)
    counts = r["counts"]
    ts, tt = src.shape[1], tgt.shape[1] - 1
    real_tgt = int((tgt[:, 1:] != S2S_PAD).sum())
    real_src = int((src != S2S_PAD).sum())
    slots = S2S_BATCH * (ts + tt)
    flops = s2s_flops(S2S, S2S_BATCH, ts, tt)
    prof = profile_steps(torch, step, S2S_FAMILIES)
    master, table = tr.opt.state[0].master, tr.table
    tr = None                           # the card's memory for the witness
    with dispatch.backend("reference"):
        wt = make()
        zero_counts()
        w_loss = [float(wt.step(src, tgt, label_smoothing=S2S_SMOOTHING))
                  for _ in range(3)]
        torch.cuda.synchronize()
        w_launches = read_counts()
        wt = None
    loss = r["loss"]
    w_rel = [abs(a - b) / abs(b) for a, b in zip(loss[:3], w_loss)]
    row = {"phase": "seq2seq_train", "model": "Seq2SeqTransformer",
           **{k: v for k, v in S2S.items()}, "batch": S2S_BATCH,
           "src_len": ts, "tgt_len": tt, "dtype": "bfloat16",
           "masters": "float32", "label_smoothing": S2S_SMOOTHING,
           "optimizer": f"FusedAdam({S2S_ADAM})", **window_row(r, timed),
           "params": table.total,
           "real_src_tokens_per_step": real_src,
           "real_tgt_tokens_per_step": real_tgt,
           "token_slots_per_step": slots,
           "tgt_tok_per_s": real_tgt * timed / r["wall"],
           "slot_tok_per_s": slots * timed / r["wall"],
           "step_tflop": flops / 1e12,
           "mfu": flops * timed / r["wall"] / BF16_DENSE_OPS_S,
           "ln_vocab": math.log(S2S["tgt_vocab_size"]),
           "launches": {k: counts[k] for k in S2S_PER_STEP},
           "launches_per_step": {k: counts[k] / timed
                                 for k in S2S_PER_STEP},
           "profile": prof,
           "plain_witness": {"losses": w_loss, "rel_err": w_rel,
                             "rtol": S2S_WITNESS_RTOL,
                             "launches": w_launches}}
    emit(row)
    check(all(np.isfinite(loss)), f"seq2seq_train: non-finite {loss}")
    check(abs(loss[0] - math.log(S2S["tgt_vocab_size"]))
          <= 0.1 * math.log(S2S["tgt_vocab_size"]),
          f"seq2seq_train: first loss {loss[0]} is not near ln V")
    check(loss[0] > loss[1] > loss[2],
          f"seq2seq_train: the first three losses do not fall {loss}")
    check_counts("seq2seq_train", counts,
                 {k: n * timed for k, n in S2S_PER_STEP.items()})
    check(not any(w_launches.values()),
          f"seq2seq_train witness: kernels launched {w_launches}")
    check(max(w_rel) <= S2S_WITNESS_RTOL,
          f"seq2seq_train witness: kernel losses {loss[:3]} against plain "
          f"{w_loss}")
    return counts, master, table


def s2s_decode_phase(torch, model, master, table) -> dict:
    """``greedy_decode`` of 8 held-out sources (make_batch from
    RandomState(1234)) to max_len 130 with the trained masters cast to
    bf16: decoded tokens a second; every row opens with BOS and is all
    PAD after its first EOS. The first decode step's logits with the
    kernels against the plain versions': on the same encoder memory (the
    step's own kernels are the LayerNorms) within atol 1e-2, and through
    the whole path (the encoder's six flash forwards with ``kv_bias``
    too) within 2 bf16 ulps of the largest logit: the logits are bf16,
    and the kernels' bf16 P moves each by rounding steps. The plain
    path's greedy streams are decoded too and their agreement reported
    (a near tie may turn a token)."""
    import numpy as np

    from apex_tpu_torch.ops import dispatch, flat

    params = flat.unflatten(master, table, dtype=torch.bfloat16)
    src, _ = s2s_batch(torch, np.random.RandomState(1234), 8, S2S_SEQ,
                       S2S["src_vocab_size"])
    max_len = S2S_SEQ + 2

    def decode():
        return model.greedy_decode(params, src, bos_id=S2S_BOS,
                                   eos_id=S2S_EOS, max_len=max_len)

    model.greedy_decode(params, src[:2], bos_id=S2S_BOS, eos_id=S2S_EOS,
                        max_len=4)        # first use of each product
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = decode()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    o = out.cpu().numpy()
    real = 0
    for row_ in o:
        eos = np.nonzero(row_ == S2S_EOS)[0]
        end = int(eos[0]) if eos.size else max_len - 1
        check(row_[0] == S2S_BOS, f"seq2seq_decode: row opens {row_[0]}")
        check(not row_[end + 1:].any(),
              "seq2seq_decode: tokens after EOS are not PAD")
        real += end

    @torch.no_grad()
    def first_step(mem=None):
        if mem is None:
            mem = model.encode(params, src)
        cross = model._cross_kv(params, mem)
        caches = model._self_caches(src.shape[0], max_len,
                                    torch.bfloat16, src.device)
        tok = torch.full((src.shape[0],), S2S_BOS, dtype=torch.int32,
                         device=src.device)
        logits, _ = model._decode_one(params, tok, 0, caches, cross,
                                      model._src_bias(src))
        return logits, mem

    logits, mem = first_step()
    with dispatch.backend("reference"):
        step_plain, _ = first_step(mem)
        path_plain, _ = first_step()
        o_plain = decode().cpu().numpy()
        torch.cuda.synchronize()
    step_err = float((logits - step_plain).abs().max())
    path_err = float((logits - path_plain).abs().max())
    top = path_plain.abs().max()
    path_lim = 2 * float(storage_ulp(torch, top, torch.bfloat16))
    row = {"phase": "seq2seq_decode", "sources": 8, "max_len": max_len,
           "seconds": secs, "steps": max_len - 1,
           "decoded_tok_per_s": 8 * (max_len - 1) / secs,
           "real_tok_per_s": real / secs, "real_tokens": real,
           "first_step_logits_err": step_err,
           "first_step_logits_err_whole_path": path_err,
           "whole_path_limit": path_lim, "logits_max_abs": float(top),
           "plain_streams_equal_rows": int((o == o_plain).all(1).sum()),
           "plain_streams_equal_tokens": float((o == o_plain).mean()),
           "launches": {k: counts[k] for k in ("flash_fwd", "ln_fwd")}}
    emit(row)
    check(step_err <= 1e-2,
          f"seq2seq_decode: first step's logits off by {step_err}")
    check(path_err <= path_lim,
          f"seq2seq_decode: first step's logits through the whole path "
          f"off by {path_err}, limit {path_lim}")
    check(counts["flash_fwd"] == S2S["num_encoder_layers"]
          and counts["ln_fwd"] > 0,
          f"seq2seq_decode: launches {counts}")
    return counts


def s2s_crosscheck_phase(torch, dispatch):
    """A small Seq2Seq Transformer (2 + 2 layers, embed 256, 4 heads of
    64, vocab 1000, source length 64, batch 8, ragged) under
    ``adam_crosscheck`` with the translation step's Adam and label
    smoothing."""
    import numpy as np

    from apex_tpu_torch.models import Seq2SeqTransformer

    cfg = dict(S2S, src_vocab_size=1000, tgt_vocab_size=1000,
               max_seq_len=128, embed_dim=256, num_heads=4,
               num_encoder_layers=2, num_decoder_layers=2)
    m = Seq2SeqTransformer(**cfg)
    params = m.init(torch.Generator().manual_seed(2))
    src, tgt = s2s_batch(torch, np.random.RandomState(3), 8, 64, 1000)
    adam_crosscheck(torch, dispatch, "seq2seq_crosscheck", m, params,
                    (src, tgt), {"label_smoothing": S2S_SMOOTHING}, S2S_ADAM)


# -- the ViT slice: the rest of the flash kernels, main_amp's ViT step --------

# examples/imagenet/main_amp.py --arch vit_b16 --dropout 0.1 at its
# defaults otherwise (models/vit.py's vit_b16: patch 16, 12 layers of 768,
# 12 heads of 64, FFN 3072, cls pooling; 197 tokens at 224²), at the batch
# of the repo's earlier ViT-B/16 run (128)
VIT = dict(num_classes=1000, image_size=224, dropout=0.1)
VIT_BATCH = 128
VIT_BH, VIT_S, VIT_D = VIT_BATCH * 12, 197, 64
VIT_SEED = 1234                # the dropout seed of phase 2's readings
# launches a step: a flash forward, dq and dk/dv per layer; two
# LayerNorms a layer and the final one; the unscale and the SGD update
VIT_PER_STEP = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                "ln_fwd": 25, "ln_bwd": 25, "scale": 1, "sgd": 1}
# a shared-bias gradient at a causal LM-like shape beside the ViT's
DBIAS_CAUSAL_SHAPE = (128, 1024, 64)


def _flash_readings(torch, timer, q, k, v, do, kw, lib_fwd, lib_bwd,
                    per_bh_ds: bool, live_pairs: int) -> dict:
    """The three flash kernels (and dq's per-bh dS) on one input set
    against their plain versions: errors under the flash rule, times,
    bounds (operations, the pairs the data leaves live), and the library
    yardsticks' times."""
    from apex_tpu_torch.ops import flash_attn as FA
    bh, sq, d = q.shape
    sk = k.shape[1]
    o, lse = FA.flash_fwd(q, k, v, **kw)
    delta = FA.flash_delta(o, do)
    out = FA.flash_bwd_dq(q, k, v, do, lse, delta, return_ds=per_bh_ds,
                          **kw)
    dq, ds = out if per_bh_ds else (out, None)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    o0, lse0 = FA.reference_attention(q, k, v, kw.get("bias"),
                                      return_lse=True,
                                      **{n: x for n, x in kw.items()
                                         if n != "bias"})
    dq0, dk0, dv0, ds0 = FA.flash_bwd_plain(q, k, v, do, lse, delta,
                                            return_ds=True, **kw)
    torch.cuda.synchronize()
    pairs = [("o", o, o0), ("dq", dq, dq0), ("dk", dk, dk0), ("dv", dv, dv0)]
    if per_bh_ds:
        pairs.append(("ds", ds, ds0))
    errs = {w: flash_err(torch, a, b) for w, a, b in pairs}
    lse_err = float((lse - lse0).abs().max())
    bias = kw.get("bias")
    bias_bytes = 0 if bias is None else bias.numel() * 4
    sz_q, sz_k = bh * sq * d * 2, bh * sk * d * 2
    fwd_b = bound(2 * sz_q + 2 * sz_k + 4 * bh * sq + bias_bytes,
                  4 * d * live_pairs, BF16_DENSE_OPS_S)
    dq_b = bound(3 * sz_q + 2 * sz_k + 8 * bh * sq + bias_bytes
                 + (4 * bh * sq * sk if per_bh_ds else 0),
                 6 * d * live_pairs, BF16_DENSE_OPS_S)
    dkv_b = bound(2 * sz_q + 4 * sz_k + 8 * bh * sq + bias_bytes,
                  8 * d * live_pairs, BF16_DENSE_OPS_S)
    plain_bwd = timer(lambda: FA.flash_bwd_plain(q, k, v, do, lse, delta,
                                                 **kw))
    rows = {
        "flash_fwd": dict(max_abs_err=errs["o"]["max_abs_err"],
                          tol_used=errs["o"]["used"], lse_err=lse_err,
                          ms=timer(lambda: FA.flash_fwd(q, k, v, **kw)),
                          plain_ms=timer(lambda: FA.reference_attention(
                              q, k, v, bias, return_lse=True,
                              **{n: x for n, x in kw.items()
                                 if n != "bias"})),
                          library_ms=timer(lib_fwd), bound_ms=fwd_b[0],
                          bound_by=fwd_b[1]),
        "flash_bwd_dq": dict(
            max_abs_err=max(errs["dq"]["max_abs_err"],
                            errs.get("ds", {"max_abs_err": 0.0})
                            ["max_abs_err"]),
            tol_used=max(errs["dq"]["used"],
                         errs.get("ds", {"used": 0.0})["used"]),
            ms=timer(lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta,
                                             return_ds=per_bh_ds, **kw)),
            plain_ms=plain_bwd, library_ms=lib_bwd, bound_ms=dq_b[0],
            bound_by=dq_b[1]),
        "flash_bwd_dkv": dict(
            max_abs_err=max(errs["dk"]["max_abs_err"],
                            errs["dv"]["max_abs_err"]),
            tol_used=max(errs["dk"]["used"], errs["dv"]["used"]),
            ms=timer(lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta,
                                              **kw)),
            plain_ms=plain_bwd, library_ms=lib_bwd, bound_ms=dkv_b[0],
            bound_by=dkv_b[1]),
    }
    check(lse_err <= 1e-3, f"flash lse: {lse_err}")
    for w, e in errs.items():
        check(e["used"] <= 1.0, f"flash {w} ({sorted(kw)}): {e}")
    return {"rows": rows, "errs": errs, "lse": lse, "delta": delta,
            "ds0": ds0}


def _dbias_reading(torch, timer, q, k, v, do, lse, delta, kw, ds_sum,
                   lib_bwd, live_pairs: int, dt=None,
                   ops_s=BF16_DENSE_OPS_S, simple=False) -> dict:
    """``flash_bwd_dbias`` against the plain per-bh dS summed over bh under
    dt's flash rule (bf16's by default), its repeat bitwise, its time, the
    plain version's, the yardstick's and the bound (its two products over
    the live pairs at ``ops_s``; fp32's also at fp32 FMAs' rate,
    ``bound_fma_ms``). With ``simple``, the simple form
    (``flash_simt_dbias``) held and timed on the same inputs:
    ``simple_ms``, and its own row under ``"simple"``."""
    from apex_tpu_torch.ops import flash_attn as FA
    bh, sq, d = q.shape
    sk = k.shape[1]
    es = q.element_size()
    runs = FA.dbias_runs(bh, sq, sk, torch.cuda.get_device_properties(
        0).multi_processor_count)
    nbytes = (2 * bh * sq * d * es + 2 * bh * sk * d * es + 8 * bh * sq
              + 8 * sq * sk)
    b_ms, b_by = bound(nbytes, 4 * d * live_pairs, ops_s)
    plain_ms = timer(lambda: FA.flash_bwd_dbias_plain(q, k, v, do, lse,
                                                      delta, **kw))
    rows = {}
    for name in ("flash_bwd_dbias",) + (("flash_simt_dbias",) if simple
                                        else ()):
        fn = getattr(FA, name)
        db = fn(q, k, v, do, lse, delta, **kw)
        again = fn(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        err = flash_err(torch, db, ds_sum, dt)
        repeat = bool(torch.equal(db, again))
        check(err["used"] <= 1.0, f"{name}: {err}")
        check(repeat, f"{name}: two runs on the same inputs differ")
        rows[name] = dict(max_abs_err=err["max_abs_err"],
                          tol_used=err["used"], repeat_equal=repeat,
                          runs=runs,
                          ms=timer(lambda: fn(q, k, v, do, lse, delta,
                                              **kw)),
                          plain_ms=plain_ms, library_ms=lib_bwd,
                          bound_ms=b_ms, bound_by=b_by)
        if ops_s != BF16_DENSE_OPS_S:
            rows[name]["bound_fma_ms"] = bound(nbytes, 4 * d * live_pairs)[0]
        del db, again
    row = rows["flash_bwd_dbias"]
    if simple:
        row["simple_ms"] = rows["flash_simt_dbias"]["ms"]
        row["simple"] = rows["flash_simt_dbias"]
    return row


def dropout_readback(torch) -> dict:
    """The exact mask read-back: q = k = 0 makes every probability 1/64
    over Sk = D = 64 keys, v = I puts p·keep/(1 - rate) at o[i, j], so
    o[i, j] != 0 exactly where the kernel kept (i, j); dO = I does the
    same for dv[j, i]. Both must equal ``dropout_bits`` >= the threshold,
    at nonzero bh, q_start and k_start (a tolerance cannot see one
    mis-dropped probability of 1/197)."""
    from apex_tpu_torch.ops import flash_attn as FA
    bh, n, rate, seed = 24, 64, VIT["dropout"], 0x9E3779B9
    eye = torch.eye(n, device="cuda", dtype=torch.bfloat16)
    z = torch.zeros(bh, n, n, device="cuda", dtype=torch.bfloat16)
    v = eye.expand(bh, n, n).contiguous()
    kw = dict(causal=False, scale=0.125, q_start=4099, k_start=77,
              dropout_rate=rate, dropout_seed=seed)
    o, lse = FA.flash_fwd(z, z, v, **kw)
    _, dv = FA.flash_bwd_dkv(z, z, v, v, lse, FA.flash_delta(o, v), **kw)
    pos = torch.arange(n, device="cuda")
    keep = FA.dropout_bits(
        seed, torch.arange(bh, device="cuda")[:, None, None],
        4099 + pos[None, :, None], 77 + pos[None, None, :]) \
        >= FA.drop_threshold(rate)
    o_bad = int(((o != 0) != keep).sum())
    dv_bad = int(((dv != 0) != keep.transpose(1, 2)).sum())
    row = {"phase": "dropout_readback", "shape": [bh, n, n],
           "q_start": 4099, "k_start": 77, "seed": seed, "rate": rate,
           "kept_share": float(keep.float().mean()),
           "o_mismatches": o_bad, "dv_mismatches": dv_bad}
    emit(row)
    check(o_bad == 0 and dv_bad == 0,
          f"dropout read-back: {o_bad} o and {dv_bad} dv elements disagree "
          f"with dropout_bits")
    return row


def vit_kernel_phase(torch, timer) -> dict:
    """The flash kernels at the ViT step's shape [B·H, 197, 64] bf16, with
    dropout 0.1 (the step's own attention), with a shared [1, 197, 197]
    and a per-bh [B·H, 197, 197] fp32 bias (the public entry point's;
    dq's dS for the latter), and ``flash_bwd_dbias`` at that shape and at
    a causal [128, 1024, 64] one, each against its plain version; SDPA
    with ``dropout_p`` and SDPA's backward with a learned ``attn_mask``
    beside them as yardsticks only (their RNG is not the same function);
    then the exact mask read-back."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import flash_attn as FA

    gen = torch.Generator(device="cuda").manual_seed(13)
    bh, s, d = VIT_BH, VIT_S, VIT_D
    b, h = VIT_BATCH, bh // VIT_BATCH

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = (rnd(bh, s, d) for _ in range(4))
    q4, k4, v4, do4 = (t.view(b, h, s, d) for t in (q, k, v, do))
    ql, kl, vl = (t.detach().clone().requires_grad_(True)
                  for t in (q4, k4, v4))
    rows = {}
    base = dict(causal=False, scale=d ** -0.5)

    # dropout: the step's attention
    kw = dict(base, dropout_rate=VIT["dropout"], dropout_seed=VIT_SEED)
    lo = F.scaled_dot_product_attention(ql, kl, vl,
                                        dropout_p=VIT["dropout"])
    r = _flash_readings(
        torch, timer, q, k, v, do, kw,
        lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                               dropout_p=VIT["dropout"]),
        timer(lambda: torch.autograd.grad(lo, (ql, kl, vl), do4,
                                          retain_graph=True)),
        False, bh * s * s)
    emit({"phase": "flash_tol", "shape": [bh, s, d], "reading": "dropout",
          **r["errs"]})
    for name, row in r["rows"].items():
        emit({"phase": "kernels", "kernel": name, "shape": [bh, s, d],
              "reading": "dropout", **row})
        rows[(name, "vit", "dropout")] = row
    del lo, r

    # a learned bias shared over bh, then one per bh
    for reading, nb in (("bias", 1), ("bias_bh", bh)):
        bias = torch.randn(nb, s, s, generator=gen, device="cuda") * 0.5
        bias[0, :, ::9] = -1.0e30                     # masked keys
        mask = bias.to(torch.bfloat16).view(
            *((1, 1) if nb == 1 else (b, h)), s, s)
        ml = mask.detach().clone().requires_grad_(True)
        lo = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=ml)
        lib_bwd = timer(lambda: torch.autograd.grad(
            lo, (ql, kl, vl, ml), do4, retain_graph=True))
        kw = dict(base, bias=bias)
        r = _flash_readings(
            torch, timer, q, k, v, do, kw,
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   attn_mask=mask),
            lib_bwd, nb > 1, bh * s * s)
        emit({"phase": "flash_tol", "shape": [bh, s, d],
              "reading": reading, **r["errs"]})
        for name, row in r["rows"].items():
            emit({"phase": "kernels", "kernel": name, "shape": [bh, s, d],
                  "reading": reading, **row})
            rows[(name, "vit", reading)] = row
        if nb == 1:
            row = _dbias_reading(torch, timer, q, k, v, do, r["lse"],
                                 r["delta"], kw,
                                 r["ds0"].sum(0, keepdim=True), lib_bwd,
                                 bh * s * s, simple=True)
            row.update(dtype="bfloat16", shape=[bh, s, s, d],
                       library_covers="dq, dk, dv and the mask's gradient "
                                      "(one SDPA backward)")
            rows[("flash_simt_dbias", "bfloat16")] = row.pop("simple")
            emit({"phase": "kernels", "kernel": "flash_bwd_dbias", **row})
            rows[("flash_bwd_dbias", "bfloat16")] = row
        del lo, ml, r, bias, mask

    # flash_bwd_dbias causal at S 1024
    bh2, s2, d2 = DBIAS_CAUSAL_SHAPE
    q, k, v, do = (rnd(bh2, s2, d2) for _ in range(4))
    bias = torch.randn(1, s2, s2, generator=gen, device="cuda") * 0.5
    kw = dict(causal=True, scale=d2 ** -0.5, bias=bias)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    delta = FA.flash_delta(o, do)
    ds_sum = FA.flash_bwd_dbias_plain(q, k, v, do, lse, delta, **kw)
    causal_mask = torch.ones(s2, s2, device="cuda", dtype=torch.bool).tril()
    mask = torch.where(causal_mask, bias[0], float("-inf")).to(
        torch.bfloat16)[None, None]
    ml = mask.detach().clone().requires_grad_(True)
    q4, k4, v4 = (t.view(8, bh2 // 8, s2, d2).detach().requires_grad_(True)
                  for t in (q, k, v))
    lo = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=ml)
    lib_bwd = timer(lambda: torch.autograd.grad(
        lo, (q4, k4, v4, ml), do.view(8, bh2 // 8, s2, d2),
        retain_graph=True))
    row = _dbias_reading(torch, timer, q, k, v, do, lse, delta, kw, ds_sum,
                         lib_bwd, bh2 * s2 * (s2 + 1) // 2, simple=True)
    row.update(dtype="bfloat16", shape=[bh2, s2, s2, d2], causal=True)
    rows[("flash_simt_dbias", "causal")] = row.pop("simple")
    emit({"phase": "kernels", "kernel": "flash_bwd_dbias", **row})
    rows[("flash_bwd_dbias", "causal")] = row
    del q, k, v, do, o, lo, ml, ds_sum
    dropout_readback(torch)
    return rows


def vit_model(**kw):
    from apex_tpu_torch.models import vit_b16
    return vit_b16(**{**VIT, **kw})


def vit_train_phase(torch, model, params) -> tuple:
    """main_amp.py's ViT step (``--arch vit_b16 --dropout 0.1``) at full
    width on one card: O2 bf16 over fp32 flat masters, FusedSGD(0.1, 0.9,
    1e-4), one uint8 NHWC batch of 128 at 224² normalized in the step,
    attention "auto" (the flash kernels), dropout seeds drawn per step and
    layer from the Trainer's generator: 3 warm-up and 10 timed steps,
    two profiled ones, ``evaluate``, and the witness: the same 13 steps
    under the plain versions from the same init and seeds."""
    import math

    from apex_tpu_torch.models.vit import analytic_flops
    from apex_tpu_torch.train import Trainer

    warm, timed = 3, 10
    x, y = imagenet_batch(torch, VIT_BATCH, VIT["image_size"],
                          VIT["num_classes"])

    def make():
        return Trainer(model, params, opt_level="O2", optimizer="sgd",
                       **MAIN_AMP_SGD)

    tr = make()
    r = timed_steps(torch, lambda: tr.step(x, y), warm, timed)
    counts = r["counts"]
    flops = analytic_flops(model)
    prof = profile_steps(torch, lambda: tr.step(x, y), VIT_FAMILIES)
    top1, top5 = tr.evaluate(x, y)
    tr = None                           # the card's memory for the witness
    witness = plain_witness(torch, make, x, y, warm + timed)
    loss = r["loss"]
    row = {"phase": "vit_train", "model": "vit_b16", **VIT,
           "batch": VIT_BATCH, "tokens": model.seq_len,
           "input": "uint8 NHWC, normalized in the step",
           "dtype": "bfloat16", "opt_level": "O2", "attn_impl":
           model.attn_impl, "optimizer": f"FusedSGD({MAIN_AMP_SGD})",
           **step_row(r, VIT_BATCH, timed, flops),
           "launches": {k: counts[k] for k in VIT_PER_STEP},
           "launches_per_step": {k: counts[k] / timed
                                 for k in VIT_PER_STEP},
           "profile": prof, "ln_classes": math.log(VIT["num_classes"]),
           "evaluate": {"top1": float(top1), "top5": float(top5)},
           "plain_witness": witness}
    emit(row)
    check(all(math.isfinite(v) for v in loss),
          f"vit_train: non-finite loss {loss}")
    check(abs(loss[0] - math.log(VIT["num_classes"])) <= 0.5,
          f"vit_train: first loss {loss[0]} is not within 0.5 of ln 1000")
    check(max(loss) <= SGD_OVERSHOOT * loss[0],
          f"vit_train: a loss above {SGD_OVERSHOOT} times the first {loss}")
    check_counts("vit_train", counts,
                 {k: n * timed for k, n in VIT_PER_STEP.items()})
    plain = witness["losses"]
    check(not any(witness["launches"].values()),
          f"vit_train witness: kernels launched {witness['launches']}")
    check(all(abs(a - b) <= WITNESS_RTOL * abs(b) for a, b in
              zip(loss[:WITNESS_STEPS], plain[:WITNESS_STEPS])),
          f"vit_train witness: kernel losses {loss} against plain {plain}")
    return counts, row


def vit_crosscheck_phase(torch, dispatch):
    """A small ViT (2 layers of 256, 4 heads of 64, 64² images in patches
    of 8: 65 tokens, attention "fast", dropout 0.1), three main_amp SGD
    steps on a uint8 batch of 8 with the kernels at O2 and with the plain
    versions at O2 and O0 on the card: the kernel run's masters no farther
    from the plain O2 run's than 1.5 times bf16's own effect (the plain O2
    masters against the plain O0 ones), in mean and in max; two kernel
    runs equal bit for bit; no kernel launched in the plain runs. Every
    run draws the same dropout seeds from its Trainer's generator."""
    from apex_tpu_torch.models import ViT
    from apex_tpu_torch.train import Trainer

    model = ViT(num_classes=10, image_size=64, patch_size=8, embed_dim=256,
                num_heads=4, num_layers=2, dropout=VIT["dropout"],
                attn_impl="fast")
    params = model.init(torch.Generator().manual_seed(3))
    x, y = imagenet_batch(torch, 8, 64, 10)

    def run(level):
        tr = Trainer(model, params, opt_level=level, optimizer="sgd")
        loss = [float(tr.step(x, y)) for _ in range(3)]
        return tr.opt.state[0].master, loss

    zero_counts()
    hk, loss_k = run("O2")
    hk2, loss_k2 = run("O2")
    torch.cuda.synchronize()
    launches = read_counts()
    with dispatch.backend("reference"):
        zero_counts()
        hr, loss_r = run("O2")
        gr, loss_g = run("O0")
        torch.cuda.synchronize()
        plain_launches = read_counts()
    d, d_bf16 = (hk - hr).abs(), (hr - gr).abs()
    err = {"mean": float(d.mean()), "max": float(d.max()),
           "bf16_mean": float(d_bf16.mean()),
           "bf16_max": float(d_bf16.max())}
    repeat = loss_k == loss_k2 and bool(torch.equal(hk, hk2))
    emit({"phase": "vit_crosscheck", "steps": 3, "tokens": model.seq_len,
          "master_err": err, "loss_kernels": loss_k, "loss_plain": loss_r,
          "loss_plain_O0": loss_g, "repeat_equal": repeat,
          "launches": {k: launches[k] for k in VIT_PER_STEP}})
    check(launches["flash_fwd"] == 2 * 2 * 3,
          f"vit_crosscheck: flash_fwd launched {launches['flash_fwd']}")
    check(not any(plain_launches.values()),
          f"vit_crosscheck: kernels launched in the plain runs "
          f"{plain_launches}")
    check(err["mean"] <= 1.5 * err["bf16_mean"]
          and err["max"] <= 1.5 * err["bf16_max"],
          f"vit_crosscheck: masters differ by {err}")
    check(repeat, "vit_crosscheck: two kernel runs differ")


# phase 22's passes: name -> ([BH, S, D], dtype name, bias rows (1:
# shared, 0: one per bh), causal, dropout)
FLASH_BIAS_PASSES = {
    "bias": ([VIT_BH, VIT_S, VIT_D], "bfloat16", 1, False, True),
    "bias_bh": ([VIT_BH, VIT_S, VIT_D], "bfloat16", 0, False, True),
    "bias_f32": ([VIT_BH, VIT_S, VIT_D], "float32", 1, False, True),
    "d256_f32": ([16, 1024, 256], "float32", 1, True, False),
    "d320_bf16": ([16, 1024, 320], "bfloat16", 1, True, False),
}
# the wrapper that counts each form's launch of the forward, dq and dk/dv
FORM_COUNTERS = {
    "fwd": {"tc": "flash_fwd", "tc256": "flash_d256_fwd",
            "tc512": "flash_d512_fwd", "f32": "flash_f32_fwd",
            "f32_512": "flash_f32_d512_fwd"},
    "dq": {"tc": "flash_bwd_dq", "tc256": "flash_d256_dq",
           "tc512": "flash_d512_dq", "f32": "flash_f32_dq",
           "f32_512": "flash_f32_d512_dq"},
    "dkv": {"tc": "flash_bwd_dkv", "tc256": "flash_d256_dkv",
            "tc512": "flash_d512_dkv", "f32": "flash_f32_dkv",
            "f32_512": "flash_f32_d512_dkv"}}


def flash_bias_phase(torch, dispatch) -> dict:
    """The public ``flash_attention`` with a learned fp32 bias
    (``FLASH_BIAS_PASSES``): at the ViT shape [B·H, 197, 64] with dropout
    0.1 in bf16, [1, 197, 197] (its gradient from ``flash_bwd_dbias``) and
    [B·H, 197, 197] (from dq's dS), and [1, 197, 197] in fp32; [1, 1024,
    1024] causal at [16, 1024, 256] in fp32 and [16, 1024, 320] in bf16.
    o and lse against the plain forward, and dq, dk, dv and dbias against
    the plain backward from the same o and lse (``flash_bwd_plain``, its dS
    summed over bh for the shared bias), each under the dtype's flash rule.
    The launch counts of each pass are this phase's reading: one of the
    dtype and head dim's forward, dq and dk/dv, one of ``flash_bwd_dbias``
    for a shared bias, none of the simple form's."""
    from apex_tpu_torch.contrib.multihead_attn import flash_attention
    from apex_tpu_torch.ops import flash_attn as FA

    gen = torch.Generator(device="cuda").manual_seed(17)
    total = dict.fromkeys(counters(), 0)
    result = {}
    for reading, (shape, dt_name, rows, causal, drop) in \
            FLASH_BIAS_PASSES.items():
        dt = getattr(torch, dt_name)
        bh, s, d = shape
        q, k, v, do = (torch.randn(bh, s, d, generator=gen,
                                   device="cuda").to(dt) for _ in range(4))
        nb = rows or bh
        bias = torch.randn(nb, s, s, generator=gen, device="cuda") * 0.5
        cfg = dict(causal=causal)
        if drop:
            cfg.update(dropout_rate=VIT["dropout"], dropout_seed=VIT_SEED)
        ins = [t.detach().clone().requires_grad_(True)
               for t in (q, k, v, bias)]
        zero_counts()
        o, lse = flash_attention(*ins, return_lse=True, **cfg)
        got = [o] + list(torch.autograd.grad(o, ins, do))
        torch.cuda.synchronize()
        counts = read_counts()
        kw = dict(scale=d ** -0.5, bias=bias, **cfg)
        with dispatch.backend("reference"):
            o0, lse0 = FA.flash_fwd(q, k, v, **kw)
            dq0, dk0, dv0, ds0 = FA.flash_bwd_plain(
                q, k, v, do, lse.detach(), FA.flash_delta(o.detach(), do),
                return_ds=True, **kw)
        want = [o0, dq0, dk0, dv0,
                ds0.sum(0, keepdim=True) if nb == 1 else ds0]
        errs = {w: flash_err(torch, a.detach(), b, dt) for w, a, b in
                zip(("o", "dq", "dk", "dv", "dbias"), got, want)}
        lse_err = float((lse.detach() - lse0).abs().max())
        want_n = {FORM_COUNTERS[kn][FA.kernel_form(q, kn)]: 1
                  for kn in ("fwd", "dq", "dkv")}
        want_n["flash_bwd_dbias"] = int(nb == 1)
        want_n.update({n: 0 for n in counts if n.startswith("flash_simt")})
        result[reading] = {"shape": shape, "dtype": dt_name,
                           "causal": causal, "errs": errs,
                           "lse_err": lse_err,
                           "launches": {n: counts[n] for n in want_n}}
        for n, c in counts.items():
            total[n] += c
        check(lse_err <= (1e-4 if dt == torch.float32 else 1e-3),
              f"flash_bias {reading} lse: {lse_err}")
        for w, e in errs.items():
            check(e["used"] <= 1.0, f"flash_bias {reading} {w}: {e}")
        check(got[4].dtype == torch.float32 and got[4].shape == bias.shape,
              f"flash_bias {reading}: dbias {got[4].dtype} "
              f"{tuple(got[4].shape)}")
        check_counts(f"flash_bias {reading}", counts, want_n)
        del ins, o, lse, got, want, ds0, q, k, v, do, bias
    emit({"phase": "flash_bias", "dropout": VIT["dropout"], **result})
    return total


# -- the wide LayerNorm slice: lm_bench's LM at GPT-3 175B's width -----------

# tools/lm_bench.py --dim 12288 --heads 96 --layers 1 --seq 2048 --vocab
# 32768: GPT-3 175B's d_model, 96 heads of 128 and FFN 4·d (Brown et al.
# 2020, Table 2.1), cut to one layer of its 96 so that the fp32 masters,
# Adam's state and the flat grad of 2.24e9 parameters fit one card
WIDE_SHAPE = dict(batch=4, seq=2048, embed=12288, heads=96, layers=1,
                  vocab=32768)
# launches a step: ln1, ln2 and ln_f by the wide kernels, forward and
# backward, and none by the one-pass ones; a flash forward, dq and dk/dv;
# one Adam
WIDE_PER_STEP = {"ln_fwd_wide": 3, "ln_bwd_wide": 3, "ln_fwd": 0,
                 "ln_bwd": 0, "flash_fwd": 1, "flash_bwd_dq": 1,
                 "flash_bwd_dkv": 1, "adam": 1}
# the wide readings of phase 2: the LM's rows; FusedLayerNorm over a
# [256, 28, 28] map (the reference's multi-dim normalized_shape), far
# wider than shared memory; the JAX tests' shapes (13, 16384) and (520,
# 9344) in fp32, with and without affine
WIDE_READINGS = (
    ("lm", WIDE_SHAPE["batch"] * WIDE_SHAPE["seq"], WIDE_SHAPE["embed"],
     "bfloat16", True),
    ("chw", 32, 256 * 28 * 28, "bfloat16", True),
    ("13x16384", 13, 16384, "float32", True),
    ("13x16384_plain", 13, 16384, "float32", False),
    ("520x9344", 520, 9344, "float32", True),
    ("520x9344_plain", 520, 9344, "float32", False))
# the one-pass wide backward's plans phase 1 prints (rows, F, dtype, x's
# and gamma's element sizes): the wide LM's rows and the tails', the JAX
# tests' fp32 shapes, and bf16 and fp32 at the widest row
LN_ROW_PLANS = (
    (8192, 12288, "bfloat16", 2, 2), (8192, 12289, "bfloat16", 2, 2),
    (8192, 16384, "bfloat16", 2, 2), (520, 9344, "float32", 4, 4),
    (520, 9344, "float32", 4, 0), (13, 16384, "float32", 4, 4),
    (13, 16384, "float32", 4, 0), (8192, 16384, "float32", 4, 4))


def ln_bwd_wide_form(LN, x, w) -> dict:
    """The form ``ln_bwd_wide`` takes on fresh (aligned) buffers: to
    ``LN.ROW_MAX`` the one pass (``csrc/ln_bwd_row.cu``) with its load width
    and its plan, as the C side gives them (``LN.row_plan``), past it the
    chunked kernels."""
    rows, f = x.shape
    if f > LN.ROW_MAX:
        return {"form": "chunked"}
    plan = LN.row_plan(rows, f, x.element_size(),
                       0 if w is None else w.element_size())
    vec = plan.pop("vec")
    return {"form": "one-pass, " + (f"{vec}-wide" if vec > 1 else "scalar"),
            "plan": plan}


def wide_ln_readings(torch, timer, tag, n_rows, f, dt_name, affine) -> dict:
    """``ln_fwd_wide`` and ``ln_bwd_wide`` over [n_rows, f] rows (gamma,
    beta in x's dtype) against their plain versions on the same inputs:
    y within one bf16 ulp plus 1e-5 (fp32: 1e-5 relative), mean and invvar
    within 1e-5 relative, the backward as ``check_ln_bwd`` holds it; two
    runs of each bit-equal. Each with its time, the plain version's,
    ``F.layer_norm``'s or ``native_layer_norm_backward``'s, the bound and
    the host time of a call."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import layer_norm as LN

    dtype = getattr(torch, dt_name)
    es = torch.tensor([], dtype=dtype).element_size()
    gen = torch.Generator(device="cuda").manual_seed(n_rows + f)
    x = (torch.randn(n_rows, f, generator=gen, device="cuda") * 2
         + 0.5).to(dtype)
    dy = torch.randn(n_rows, f, generator=gen, device="cuda").to(dtype)
    w = b = None
    if affine:
        w = (torch.randn(f, generator=gen, device="cuda") + 1).to(dtype)
        b = torch.randn(f, generator=gen, device="cuda").to(dtype)
    shape = dict(reading=tag, dtype=dt_name, shape=[n_rows, f],
                 affine=affine)

    y, mean, inv = LN.ln_fwd_wide(x, w, b, 1e-5)
    y0, mean0, inv0 = LN.ln_fwd_plain(x, w, b, 1e-5)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        y_err, ok = max_err(y, y0, "float32")
    else:
        e = (y.float() - y0.float()).abs()
        ok = bool((e <= torch.maximum(storage_ulp(torch, y),
                                      storage_ulp(torch, y0)) + 1e-5).all())
        y_err = float(e.max())
        del e
    check(ok, f"ln_fwd_wide {tag}: y max abs err {y_err}")
    stats_err = 0.0
    for t, t0, what in ((mean, mean0, "mean"), (inv, inv0, "invvar")):
        e, ok = max_err(t, t0, "float32")
        check(ok, f"ln_fwd_wide {tag}: {what} err {e}")
        stats_err = max(stats_err, e)
    again = LN.ln_fwd_wide(x, w, b, 1e-5)
    rep = all(bool(torch.equal(a, c)) for a, c in zip((y, mean, inv), again))
    check(rep, f"ln_fwd_wide {tag}: two runs differ")
    del y, y0, again
    io = n_rows * f * es
    wb = (2 * f * es) if affine else 0
    b_ms, b_by = bound(2 * io + wb + 8 * n_rows, 8 * n_rows * f)
    fwd = dict(kernel="ln_fwd_wide", **shape, max_abs_err=y_err,
               stats_max_abs_err=stats_err,
               tol=("y: 1e-5 relative" if dtype == torch.float32 else
                    "y: 1 bf16 ulp + 1e-5") + "; mean, invvar: 1e-5 "
               "relative", repeat_equal=rep,
               ms=timer(lambda: LN.ln_fwd_wide(x, w, b, 1e-5)),
               plain_ms=timer(lambda: LN.ln_fwd_plain(x, w, b, 1e-5)),
               library_ms=timer(lambda: F.layer_norm(x, (f,), w, b, 1e-5)),
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: LN.ln_fwd_wide(x, w, b, 1e-5),
                               n=100))

    got = LN.ln_bwd_wide(dy, x, w, mean, inv)
    want = LN.ln_bwd_plain(dy, x, w, mean, inv)
    torch.cuda.synchronize()
    fp32 = dtype == torch.float32
    errs = check_ln_bwd(torch, f"ln_bwd_wide {tag}", got, want, dy, x, w,
                        mean, inv, row_sums=fp32)
    again = LN.ln_bwd_wide(dy, x, w, mean, inv)
    rep = all(bool(torch.equal(a, c)) for a, c in zip(got, again)
              if a is not None)
    check(rep, f"ln_bwd_wide {tag}: two runs differ")
    del got, want, again
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [f], w, b, 1e-5)
    b_ms, b_by = bound(3 * io + 8 * n_rows + ((es + 8) * f if affine else 0),
                       11 * n_rows * f)
    bwd = dict(kernel="ln_bwd_wide", **shape, **ln_bwd_wide_form(LN, x, w),
               **errs, tol="dx: 1 ulp + 1e-5 of its terms" + (
                   " (the row means' as mean|terms|)" if fp32 else "")
               + "; sums: 1e-5·Σ|terms|",
               repeat_equal=rep,
               ms=timer(lambda: LN.ln_bwd_wide(dy, x, w, mean, inv)),
               plain_ms=timer(lambda: LN.ln_bwd_plain(dy, x, w, mean, inv)),
               library_ms=timer(
                   lambda: torch.ops.aten.native_layer_norm_backward(
                       dy, x, [f], lmean, lrstd, w, b,
                       [True, affine, affine])),
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: LN.ln_bwd_wide(
                   dy, x, w, mean, inv), n=100))
    for r in (fwd, bwd):
        emit({"phase": "kernels", **r})
    return {("ln_fwd_wide", tag): fwd, ("ln_bwd_wide", tag): bwd}


def wide_kernel_phase(torch, timer) -> dict:
    """The wide LayerNorm readings (``WIDE_READINGS``), then the large-mean
    case: x = 1000 + 0.01·N(0, 1), [9, 16384] fp32, y within 0.05 of an
    fp64 reference (the JAX test's bar) and finite, where E[x²] − E[x]²
    cancels."""
    from apex_tpu_torch.ops import layer_norm as LN

    rows = {}
    for reading in WIDE_READINGS:
        rows.update(wide_ln_readings(torch, timer, *reading))
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = 1000.0 + 0.01 * torch.randn(9, 16384, generator=gen, device="cuda")
    y, _, _ = LN.ln_fwd_wide(x, None, None, 1e-5)
    y0, _, _ = LN.ln_fwd_plain(x, None, None, 1e-5)
    xd = x.double()
    ref = (xd - xd.mean(1, keepdim=True)) * torch.rsqrt(
        xd.var(1, unbiased=False, keepdim=True) + 1e-5)
    err = float((y.double() - ref).abs().max())
    err0 = float((y0.double() - ref).abs().max())
    finite = bool(torch.isfinite(y).all())
    b_ms, b_by = bound(2 * x.numel() * 4 + 8 * 9, 8 * x.numel())
    row = dict(kernel="ln_fwd_wide", reading="large_mean", dtype="float32",
               shape=[9, 16384], affine=False, max_abs_err_fp64=err,
               plain_max_abs_err_fp64=err0, tol="0.05 of fp64",
               finite=finite,
               ms=timer(lambda: LN.ln_fwd_wide(x, None, None, 1e-5)),
               plain_ms=timer(lambda: LN.ln_fwd_plain(x, None, None, 1e-5)),
               library_ms=timer(lambda: torch.nn.functional.layer_norm(
                   x, (16384,), None, None, 1e-5)),
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: LN.ln_fwd_wide(
                   x, None, None, 1e-5), n=100))
    emit({"phase": "kernels", **row})
    check(finite and err <= 0.05,
          f"ln_fwd_wide large mean: {err} from fp64 (finite: {finite})")
    rows[("ln_fwd_wide", "large_mean")] = row
    return rows


def bn_reduce_phase(torch, calls) -> dict:
    """``bn_backward_reduce`` as its users call it, the reduce_bn partial
    pass from a materialized xhat: once per BN of the RN50 step (53, at
    their [N·H·W, C] shapes, dy and xhat bf16), the launch counts zeroed
    just before and read just after; every sum finite."""
    from apex_tpu_torch.ops import welford as WF

    gen = torch.Generator(device="cuda").manual_seed(8)
    inputs = {}
    for (rows, c, _, _), n in sorted(calls.items()):
        if (rows, c) not in inputs:
            inputs[(rows, c)] = tuple(
                torch.randn(rows, c, generator=gen, device="cuda").to(
                    torch.bfloat16) for _ in range(2))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    sums = []
    for (rows, c, _, _), n in sorted(calls.items()):
        for _ in range(n):
            sums.extend(WF.bn_backward_reduce(*inputs[(rows, c)]))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    finite = all(bool(torch.isfinite(t).all()) for t in sums)
    emit({"phase": "bn_reduce", "bn_calls": sum(calls.values()),
          "wall_ms": wall_ms, "finite": finite,
          "launches": {k: n for k, n in counts.items() if n}})
    check(finite, "bn_reduce: a sum is not finite")
    check_counts("bn_reduce", counts,
                 {k: (53 if k == "bn_backward_reduce" else 0)
                  for k in counts})
    return counts


def wide_lm_model(c=WIDE_SHAPE):
    from apex_tpu_torch.models import TransformerLM
    return TransformerLM(vocab_size=c["vocab"], max_seq_len=c["seq"],
                         embed_dim=c["embed"], num_heads=c["heads"],
                         num_layers=c["layers"], attn_impl="fast",
                         head_chunk=min(8192, c["vocab"]))


def wide_lm_train_phase(torch) -> tuple:
    """lm_bench's step at ``WIDE_SHAPE`` on one card: O2 bf16 over fp32
    flat masters, FusedAdam(lr=1e-4), one numpy batch of 4 × 2049 tokens
    reused every step; 3 warm-up and 10 timed steps, then two profiled
    ones. Every LayerNorm row is 12288 wide: the wide kernels, 3 of each a
    step, and no one-pass LayerNorm launch."""
    import numpy as np

    from apex_tpu_torch.train import LMTrainer

    c = WIDE_SHAPE
    warm, timed = 3, 10
    torch.cuda.empty_cache()
    model = wide_lm_model()
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0))
    tr = LMTrainer(model, params, lr=1e-4)
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    state_bytes = torch.cuda.memory_allocated()
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, c["vocab"], (c["batch"], c["seq"] + 1)).astype(np.int64)).cuda()
    r = timed_steps(torch, lambda: tr.step(toks), warm, timed)
    counts = r["counts"]
    tokens = c["batch"] * c["seq"]
    n_params = tr.table.total
    step_flops = lm_step_flops(n_params, c)
    prof = profile_steps(torch, lambda: tr.step(toks), LM_KERNEL_FAMILIES)
    row = {"phase": "wide_lm_train", "model": "TransformerLM", **c,
           "attn_impl": model.attn_impl, "head_chunk": model.head_chunk,
           "dtype": "bfloat16", "masters": "float32",
           "optimizer": "FusedAdam(lr=1e-4)", "setup_s": setup_s,
           "state_bytes": state_bytes, **window_row(r, timed),
           "tokens_per_step": tokens,
           "tok_per_s": tokens * timed / r["wall"],
           "step_tflop": step_flops / 1e12,
           "mfu": step_flops * timed / r["wall"] / BF16_DENSE_OPS_S,
           "params": n_params,
           "launches": {k: counts[k] for k in WIDE_PER_STEP},
           "launches_per_step": {k: counts[k] / timed
                                 for k in WIDE_PER_STEP},
           "profile": prof}
    emit(row)
    loss = r["loss"]
    check(all(math.isfinite(v) for v in loss),
          f"wide_lm_train: non-finite loss {loss}")
    check(statistics.mean(loss[-3:]) < loss[0],
          f"wide_lm_train: the last 3 losses do not sit below the first "
          f"{loss}")
    check_counts("wide_lm_train", counts,
                 {k: n * timed for k, n in WIDE_PER_STEP.items()})
    del tr, toks
    torch.cuda.empty_cache()
    return counts, row


def wide_lm_crosscheck_phase(torch, dispatch):
    """A one-layer LM with rows over 8192 (embed 8320, 65 heads of 128,
    vocab 512, S 128, batch 2) under ``adam_crosscheck`` at lr 1e-3, its
    kernel runs through the wide LayerNorm kernels only."""
    c = dict(batch=2, seq=128, embed=8320, heads=65, layers=1, vocab=512)
    m = wide_lm_model(c)
    params = m.init(torch.Generator().manual_seed(2))
    toks = torch.randint(0, c["vocab"], (c["batch"], c["seq"] + 1),
                         generator=torch.Generator().manual_seed(3)).cuda()
    row = adam_crosscheck(torch, dispatch, "wide_lm_crosscheck", m, params,
                          (toks,), {}, {"lr": 1e-3})
    got = row["kernel_launches"]
    # two kernel runs of three steps: the three LayerNorms each step
    check(got.get("ln_fwd_wide") == 18 and got.get("ln_bwd_wide") == 18
          and "ln_fwd" not in got and "ln_bwd" not in got,
          f"wide_lm_crosscheck: LayerNorm launches {got}")
    del params
    torch.cuda.empty_cache()


# -- phase 2, the split decode kernel at head dim 64, its merge; the flash
# -- kernels in fp16 and the simple form; the scalar tails -------------------

# lm_bench's LM served: 8 × 1024, 16 heads of 64 (phases 26-27)
LM_SERVE_HEADS = 16
DECODE_LENGTHS = [1, 1024, 17, 300, 512, 77, 999, 640]
# the decode kernel's edges: no key, one, a chunk's edges and the arena's
DECODE_EDGE_LENGTHS = [0, 1, 63, 64, 65, 127, 129, 1024]


def paged_copy(torch, gen, k, v, lens, page):
    """The dense k, v [S, H, L, hd] behind a shuffled page table: (k pool,
    v pool, table, pages read); the unmapped entries point at the null
    page 0, which holds garbage."""
    S, H, L, hd = k.shape
    max_pages = -(-L // page)
    n_phys = 1 + S * max_pages
    perm = torch.randperm(n_phys - 1, generator=gen,
                          device="cuda").to(torch.int32) + 1
    table = torch.zeros(S, max_pages, dtype=torch.int32, device="cuda")
    kp = torch.full((n_phys, H, page, hd), 30.0, device="cuda").to(k.dtype)
    vp = torch.full((n_phys, H, page, hd), -30.0, device="cuda").to(k.dtype)
    nxt = 0
    for s, n in enumerate(lens):
        for lp in range(-(-n // page)):
            phys = int(perm[nxt])
            nxt += 1
            table[s, lp] = phys
            w = min(page, L - lp * page)
            kp[phys, :, :w] = k[s, :, lp * page:lp * page + w]
            vp[phys, :, :w] = v[s, :, lp * page:lp * page + w]
    return kp, vp, table, sum(-(-n // page) for n in lens)


def decode_kernel_phase(torch, timer) -> dict:
    """The split decode kernel at lm_bench's serving shape, [8, 16, 1024,
    64] (bf16 and f32; dense and paged, page 32), under phase 2's decode
    rule, dense == paged and two runs bit for bit; at both head dims the
    edge lengths (0, 1, a chunk's edges, the arena) with a page of 5; the
    merge kernel alone on the serve shape's partials; and the timer's
    reading of one and of two launches of a trivial kernel."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import decode_attn as DA

    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = {}
    S, H, HD, L = 8, LM_SERVE_HEADS, 64, 1024
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    lens = lengths.tolist()
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        es = torch.tensor([], dtype=dt).element_size()
        q = torch.randn(S, H, HD, generator=gen, device="cuda").to(dt)
        k = torch.randn(S, H, L, HD, generator=gen, device="cuda").to(dt)
        v = torch.randn(S, H, L, HD, generator=gen, device="cuda").to(dt)
        got = DA.decode_attention(q, k, v, lengths)
        want = DA.decode_attention_plain(q, k, v, lengths)
        torch.cuda.synchronize()
        err, ok = max_err(got, want, name)
        check(ok, f"decode_attention hd 64 {name}: max abs err {err}")
        rep = bool(torch.equal(DA.decode_attention(q, k, v, lengths), got))
        check(rep, f"decode_attention hd 64 {name}: two runs differ")
        kp, vp, table, pages = paged_copy(torch, gen, k, v, lens, 32)
        got_p = DA.paged_decode_attention(q, kp, vp, lengths,
                                          page_table=table)
        check(torch.equal(got_p, got),
              f"paged_decode_attention hd 64 {name} differs from dense")
        mask = (torch.arange(L, device="cuda")[None, None, None, :]
                < lengths[:, None, None, None])
        kv_bytes = sum(2 * n * H * HD * es for n in lens)
        io = 2 * S * H * HD * es + 4 * S
        ops = sum(n * H * (4 * HD + 5) for n in lens)
        b_ms, b_by = bound(kv_bytes + io, ops)
        for kern, call, plain, lib, extra in (
                ("decode_attention",
                 lambda: DA.decode_attention(q, k, v, lengths),
                 lambda: DA.decode_attention_plain(q, k, v, lengths),
                 lambda: F.scaled_dot_product_attention(
                     q[:, :, None, :], k, v, attn_mask=mask), 0),
                ("paged_decode_attention",
                 lambda: DA.paged_decode_attention(q, kp, vp, lengths,
                                                   page_table=table),
                 lambda: DA.paged_decode_attention_plain(
                     q, kp, vp, lengths, page_table=table), None,
                 4 * pages)):
            bb = bound(kv_bytes + io + extra, ops)
            row = dict(kernel=kern, reading="hd64", dtype=name,
                       shape=[S, H, L, HD], lengths=lens, max_abs_err=err,
                       tol=TOL[name], repeat_equal=rep, paged_equal=True,
                       ms=timer(call), plain_ms=timer(plain),
                       library_ms=timer(lib) if lib else None,
                       bound_ms=bb[0], bound_by=bb[1],
                       host_us=host_us(torch, call))
            emit({"phase": "kernels", **row})
            rows[(kern, "hd64", name)] = row
        del k, v, kp, vp
    # the edges, both head dims, a page size that is no power of 2
    for hd, h in ((64, LM_SERVE_HEADS), (128, 8)):
        el = torch.tensor(DECODE_EDGE_LENGTHS, dtype=torch.int32,
                          device="cuda")
        q = torch.randn(8, h, hd, generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn(8, h, L, hd, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        got = DA.decode_attention(q, k, v, el)
        err, ok = max_err(got, DA.decode_attention_plain(q, k, v, el),
                          "bfloat16")
        check(ok, f"decode edges hd {hd}: max abs err {err}")
        check(not bool(got[0].any()), f"decode edges hd {hd}: length 0")
        check(torch.equal(DA.decode_attention(q, k, v, el), got),
              f"decode edges hd {hd}: two runs differ")
        kp, vp, table, _ = paged_copy(torch, gen, k, v,
                                      DECODE_EDGE_LENGTHS, 5)
        check(torch.equal(DA.paged_decode_attention(
            q, kp, vp, el, page_table=table), got),
            f"decode edges hd {hd}: paged (page 5) differs from dense")
        emit({"phase": "decode_edges", "head_dim": hd,
              "lengths": DECODE_EDGE_LENGTHS, "max_abs_err": err,
              "repeat_equal": True, "paged_equal": True})
    # the merge alone: the serve shape's chunk partials (random: any
    # partials are the merge's input), the rows of more than one chunk
    S, H, HD = 8, 8, 128
    nchunk = DA.decode_chunks(L)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    part = torch.randn(S, H, nchunk, HD + 2, generator=gen, device="cuda")
    part[..., 0] *= 3.0
    part[..., 1] = part[..., 1].abs() + 0.5
    out = torch.zeros(S, H, HD, dtype=torch.bfloat16, device="cuda")
    got = DA.decode_merge(part, lengths, out.clone(), L)
    want = DA.decode_merge_plain(part, lengths, out.clone(), L)
    torch.cuda.synchronize()
    err, ok = max_err(got, want, "bfloat16")
    check(ok, f"decode_merge: max abs err {err}")
    check(torch.equal(DA.decode_merge(part, lengths, out.clone(), L), got),
          "decode_merge: two runs differ")
    live = sum(-(-n // DA.DECODE_CHUNK) for n in DECODE_LENGTHS
               if n > DA.DECODE_CHUNK)
    merged = sum(1 for n in DECODE_LENGTHS if n > DA.DECODE_CHUNK)
    b_ms, b_by = bound(live * H * (HD + 2) * 4 + merged * H * HD * 2 + 4 * S,
                       live * H * (2 * HD + 4))
    row = dict(kernel="decode_merge", dtype="bfloat16",
               shape=[S, H, nchunk, HD + 2], lengths=DECODE_LENGTHS,
               max_abs_err=err, tol=TOL["bfloat16"], repeat_equal=True,
               ms=timer(lambda: DA.decode_merge(part, lengths, out, L)),
               plain_ms=timer(lambda: DA.decode_merge_plain(part, lengths,
                                                            out, L)),
               library_ms=None, bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: DA.decode_merge(
                   part, lengths, out, L)))
    emit({"phase": "kernels", **row})
    rows[("decode_merge", "bfloat16")] = row
    # what this timer reads for launches that do no work: the floor under
    # the decode's two launches; and one PyTorch elementwise call on one
    # element, the launch floor the launch-bound kernels (ln_fwd at
    # serving's [8, 1024], the decode merge) are read against (a yardstick:
    # no path runs it)
    tiny = torch.zeros(64, device="cuda")
    one = torch.zeros(1, device="cuda")
    emit({"phase": "timer_floor",
          "one_launch_ms": timer(lambda: tiny.zero_()),
          "two_launches_ms": timer(lambda: (tiny.zero_(), tiny.zero_())),
          "one_element_add_ms": timer(lambda: one.add_(1.0)),
          "nvidia_smi": nvidia_smi("name,power.limit")})
    return rows


def flash_bits(torch) -> dict:
    """The first 16 hex digits of the sha256 of the bf16 flash kernels' o,
    lse, dq, dk and dv at the LM's [128, 4095, 64], the wide LM's [384,
    2048, 128] and [32, 1024, 256], of the fp32 (3xTF32) kernels' at the
    LM's shape and at [32, 1024, 256], and of both at phase 30's [16,
    1024, 320], causal, from seeded inputs: one package's bits, to hold
    against another's (the fp16 forms must leave bf16's unchanged, the
    kernels past D 256 those at D <= 256, and dk/dv at D 384 the forward
    and dq there)."""
    import hashlib

    from apex_tpu_torch.ops import flash_attn as FA

    out = {}
    for name, (bh, s, d), dt in (
            ("lm", (128, 4095, 64), torch.bfloat16),
            ("wide", (384, 2048, 128), torch.bfloat16),
            ("f32_lm", (128, 4095, 64), torch.float32),
            ("f32_d256", (32, 1024, 256), torch.float32),
            ("d256", (32, 1024, 256), torch.bfloat16),
            ("d320", (16, 1024, 320), torch.bfloat16),
            ("f32_d320", (16, 1024, 320), torch.float32)):
        gen = torch.Generator(device="cuda").manual_seed(5)
        q, k, v, do = (torch.randn(bh, s, d, generator=gen, device="cuda")
                       .to(dt) for _ in range(4))
        kw = dict(causal=True, scale=d ** -0.5)
        o, lse = FA.flash_fwd(q, k, v, **kw)
        delta = FA.flash_delta(o, do)
        dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        out[name] = {
            n: hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()[:16]
            for n, t in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk),
                         ("dv", dv))}
    return out


def form_inputs(torch, shape, dt):
    """q, k, v, dO [BH, S, D] in dt from seed 13: the flash forms'
    readings share them."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    return [torch.randn(*shape, generator=gen, device="cuda").to(dt)
            for _ in range(4)]


def flash_form_readings(torch, timer, reading, shape, dt, fns, ops_s,
                        plain_group=16, whole=False, simple=None,
                        lse_tol=1e-3, fma_ops_s=None) -> dict:
    """One form of the flash kernels at [BH, S, D] causal in dtype dt: the
    forward, dq and dk/dv (``fns``: the three wrappers) against the plain
    versions on the first heads under ``flash_err`` in dt (lse within
    ``lse_tol``),
    the rule refusing a result 5% off, each output repeated bit for bit;
    times beside the plain versions' (the forward head group by head
    group), SDPA's in dt and the bounds at ``ops_s``; with ``whole`` also
    the whole backward as autograd runs it (``flash_bwd_row``, keyed
    ("flash_bwd", reading)); with ``simple`` (the simple form's forward,
    dq and dk/dv) their times on the same inputs beside the kernels'
    (``simple_ms``); with ``fma_ops_s`` (the fp32 products in 3xTF32 at
    ``ops_s``) the bounds at fp32 FMAs' rate too (``bound_fma_ms``)."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import flash_attn as FA

    fwd, dq_fn, dkv_fn = fns
    BH, S, D = shape
    n = FLASH_CHECK_HEADS
    kw = dict(causal=True, scale=D ** -0.5)
    q, k, v, do = form_inputs(torch, shape, dt)
    o, lse = fwd(q, k, v, **kw)
    delta = FA.flash_delta(o, do)
    args = (q, k, v, do, lse, delta)
    dq = dq_fn(*args, **kw)
    dk, dv = dkv_fn(*args, **kw)
    o0, lse0 = FA.reference_attention(q[:n], k[:n], v[:n], return_lse=True,
                                      **kw)
    want = FA.flash_bwd_plain(q[:n], k[:n], v[:n], do[:n], lse[:n],
                              delta[:n], **kw)
    torch.cuda.synchronize()
    errs = {w: flash_err(torch, a[:n], b0, dt)
            for w, a, b0 in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                                (o0, *want))}
    lse_err = float((lse[:n] - lse0).abs().max())
    check(lse_err <= lse_tol, f"flash {reading} lse: {lse_err} > {lse_tol}")
    for w, e in errs.items():
        check(e["used"] <= 1.0, f"flash {reading} {w}: {e}")
    late = torch.arange(S, device="cuda")[None, :, None] >= S // 2
    for w, b0 in zip(("o", "dq", "dk", "dv"), (o0, *want)):
        off = torch.where(late, b0.float() * 1.05, b0.float())
        check(flash_err(torch, off, b0, dt)["used"] > 1.0,
              f"flash {reading} {w}: the limit passes a result 5% off")
    again = (*fwd(q, k, v, **kw), dq_fn(*args, **kw), *dkv_fn(*args, **kw))
    rep = {w: bool(torch.equal(a, b)) for w, a, b in
           zip(("o", "lse", "dq", "dk", "dv"), again, (o, lse, dq, dk, dv))}
    check(all(rep.values()), f"flash {reading}: two runs differ: {rep}")
    del want, o0, lse0, again, late, off

    def plain_fwd():
        for i in range(0, BH, plain_group):
            FA.reference_attention(q[i:i + plain_group],
                                   k[i:i + plain_group],
                                   v[i:i + plain_group], return_lse=True,
                                   **kw)

    q4, k4, v4, do4 = (t.view(1, BH, S, D) for t in (q, k, v, do))
    ql, kl, vl = (t.detach().clone().requires_grad_(True)
                  for t in (q4, k4, v4))
    lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_bwd = timer(lambda: torch.autograd.grad(lo, (ql, kl, vl), do4,
                                                retain_graph=True))
    del lo, ql, kl, vl
    plain_ms = timer(lambda: FA.flash_bwd_plain(*args, **kw))
    pairs = BH * S * (S + 1) // 2
    sz = BH * S * D * q.element_size()
    name = str(dt).split(".")[1]
    common = dict(reading=reading, dtype=name, shape=[BH, S, D],
                  causal=True, checked_heads=n,
                  tol=("2 ulps + 2^-14 of the larger of the row's and the "
                       "tensor's RMS" if dt == torch.float32 else
                       "2 ulps + 2^-6 of the row's RMS (at least 2^-6 of "
                       "the tensor's)"),
                  plain_covers="dq, dk and dv (one flash_bwd_plain)",
                  library_covers="dq, dk and dv (one SDPA backward)")
    fwd_b = bound(4 * sz + 4 * BH * S, 4 * D * pairs, ops_s)
    dq_b = bound(5 * sz + 8 * BH * S, 6 * D * pairs, ops_s)
    dkv_b = bound(6 * sz + 8 * BH * S, 8 * D * pairs, ops_s)
    was = {} if simple is None else {
        fwd.__name__: timer(lambda: simple[0](q, k, v, **kw)),
        dq_fn.__name__: timer(lambda: simple[1](*args, **kw)),
        dkv_fn.__name__: timer(lambda: simple[2](*args, **kw))}
    out = {}
    fma = {} if fma_ops_s is None else {
        name: {"bound_fma_ms": bound(nb, ops, fma_ops_s)[0],
               "products": "3xTF32"}
        for name, nb, ops in ((fwd.__name__, 4 * sz + 4 * BH * S,
                               4 * D * pairs),
                              (dq_fn.__name__, 5 * sz + 8 * BH * S,
                               6 * D * pairs),
                              (dkv_fn.__name__, 6 * sz + 8 * BH * S,
                               8 * D * pairs))}
    for r in (
            dict(common, kernel=fwd.__name__,
                 max_abs_err=errs["o"]["max_abs_err"],
                 tol_used=errs["o"]["used"], lse_err=lse_err,
                 repeat_equal=rep["o"] and rep["lse"],
                 ms=timer(lambda: fwd(q, k, v, **kw)),
                 plain_ms=timer(plain_fwd),
                 plain_covers="the forward (reference_attention)",
                 library_ms=timer(lambda: F.scaled_dot_product_attention(
                     q4, k4, v4, is_causal=True)),
                 library_covers="the forward (causal SDPA)",
                 bound_ms=fwd_b[0], bound_by=fwd_b[1]),
            dict(common, kernel=dq_fn.__name__,
                 max_abs_err=errs["dq"]["max_abs_err"],
                 tol_used=errs["dq"]["used"], repeat_equal=rep["dq"],
                 ms=timer(lambda: dq_fn(*args, **kw)),
                 plain_ms=plain_ms, library_ms=lib_bwd, bound_ms=dq_b[0],
                 bound_by=dq_b[1]),
            dict(common, kernel=dkv_fn.__name__,
                 max_abs_err=max(errs["dk"]["max_abs_err"],
                                 errs["dv"]["max_abs_err"]),
                 tol_used=max(errs["dk"]["used"], errs["dv"]["used"]),
                 repeat_equal=rep["dk"] and rep["dv"],
                 ms=timer(lambda: dkv_fn(*args, **kw)),
                 plain_ms=plain_ms, library_ms=lib_bwd, bound_ms=dkv_b[0],
                 bound_by=dkv_b[1])):
        if r["kernel"] in was:
            r["simple_ms"] = was[r["kernel"]]
        r.update(fma.get(r["kernel"], {}))
        emit({"phase": "kernels", **r})
        out[(r["kernel"], reading)] = r
    if whole:
        r = flash_bwd_row(torch, timer, (q, k, v, o, do, lse), kw, errs,
                          rep, lib_bwd, pairs, common, ops_s)
        emit({"phase": "kernels", **r})
        out[("flash_bwd", reading)] = r
    return out


def f32_backward_readings(torch, timer, shape, simple,
                          reading: str = "f32") -> dict:
    """The fp32 backward on the tensor cores (``flash_f32_dq``,
    ``flash_f32_dkv``, 3xTF32; at D 256 the pair kernels) at [BH, S, D]
    causal on the inputs of the simple form's reading ``reading``
    (``form_inputs``; ``simple``: its rows; the new rows keyed by the same
    name): against the plain version on the first heads under the fp32
    flash rule, the rule refusing a result 5% off, each output repeated bit
    for bit; times beside the simple form's dq and dk/dv, the plain
    version's and SDPA's fp32 backward from that reading, bounds at
    3xTF32's 165 TFLOP/s (``bound_ms``) and at fp32 FMAs' 67 TFLOP/s
    (``bound_fma_ms``). Where ``simple`` has no such reading (the hd-256
    LM's shape), the simple dq and dk/dv, the plain version and SDPA's
    fp32 backward are timed here, 5 reps each."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import flash_attn as FA

    BH, S, D = shape
    n = FLASH_CHECK_HEADS
    kw = dict(causal=True, scale=D ** -0.5)
    q, k, v, do = form_inputs(torch, shape, torch.float32)
    o, lse = FA.flash_simt_fwd(q, k, v, **kw)
    args = (q, k, v, do, lse, FA.flash_delta(o, do))
    outs = (FA.flash_f32_dq(*args, **kw), *FA.flash_f32_dkv(*args, **kw))
    want = FA.flash_bwd_plain(*(t[:n] for t in args), **kw)
    torch.cuda.synchronize()
    errs = [flash_err(torch, a[:n], b0, torch.float32)
            for a, b0 in zip(outs, want)]
    late = torch.arange(S, device="cuda")[None, :, None] >= S // 2
    for w, e, b0 in zip(("dq", "dk", "dv"), errs, want):
        check(e["used"] <= 1.0, f"flash f32 backward {w}: {e}")
        off = torch.where(late, b0.float() * 1.05, b0.float())
        check(flash_err(torch, off, b0, torch.float32)["used"] > 1.0,
              f"flash f32 backward {w}: the limit passes a result 5% off")
    again = (FA.flash_f32_dq(*args, **kw), *FA.flash_f32_dkv(*args, **kw))
    rep = [bool(torch.equal(a, b)) for a, b in zip(again, outs)]
    check(all(rep), f"flash f32 backward: two runs differ: {rep}")
    del want, again, late, off, o, outs
    if ("flash_simt_dq", reading) not in simple:
        slow = Timer(torch, reps=5)
        q4, k4, v4 = (t.view(1, BH, S, D).detach().clone()
                      .requires_grad_(True) for t in (q, k, v))
        lo = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        lib_ms = slow(lambda: torch.autograd.grad(
            lo, (q4, k4, v4), do.view(1, BH, S, D), retain_graph=True))
        del lo, q4, k4, v4
        common = dict(tol="2 ulps + 2^-14 of the larger of the row's and "
                          "the tensor's RMS",
                      plain_ms=slow(lambda: FA.flash_bwd_plain(*args, **kw)),
                      plain_covers="dq, dk and dv (one flash_bwd_plain)",
                      library_ms=lib_ms)
        simple = {(fn.__name__, reading): dict(common, ms=slow(
            lambda: fn(*args, **kw))) for fn in (FA.flash_simt_dq,
                                                 FA.flash_simt_dkv)}
    pairs = BH * S * (S + 1) // 2
    sz = BH * S * D * 4
    out = {}
    for fn, e, rp, nbytes, ops in (
            (FA.flash_f32_dq, errs[:1], rep[:1], 5 * sz + 8 * BH * S,
             6 * D * pairs),
            (FA.flash_f32_dkv, errs[1:], rep[1:], 6 * sz + 8 * BH * S,
             8 * D * pairs)):
        was = simple[(fn.__name__.replace("f32", "simt"), reading)]
        b_ms, b_by = bound(nbytes, ops, TF32X3_OPS_S)
        r = {"phase": "kernels", "kernel": fn.__name__, "reading": reading,
             "dtype": "float32", "shape": [BH, S, D], "causal": True,
             "checked_heads": n, "products": "3xTF32",
             "tol": was["tol"],
             "max_abs_err": max(x["max_abs_err"] for x in e),
             "tol_used": max(x["used"] for x in e),
             "repeat_equal": all(rp),
             "ms": timer(lambda: fn(*args, **kw)),
             "simple_ms": was["ms"], "plain_ms": was["plain_ms"],
             "plain_covers": was["plain_covers"],
             "library_ms": was["library_ms"],
             "library_covers": "dq, dk and dv (one SDPA fp32 backward, "
                               "allow_tf32 False)",
             "bound_ms": b_ms, "bound_by": b_by,
             "bound_fma_ms": bound(nbytes, ops)[0]}
        emit(r)
        out[(fn.__name__, reading)] = r
    dq_r = out[("flash_f32_dq", reading)]
    dkv_r = out[("flash_f32_dkv", reading)]
    emit({"phase": "kernels", "reading": reading + "_pair",
          "shape": [BH, S, D],
          "kernel": "flash_f32_dq + flash_f32_dkv",
          "ms": dq_r["ms"] + dkv_r["ms"],
          "simple_ms": dq_r["simple_ms"] + dkv_r["simple_ms"],
          "library_ms": dq_r["library_ms"],
          "bound_ms": dq_r["bound_ms"] + dkv_r["bound_ms"],
          "bound_fma_ms": dq_r["bound_fma_ms"] + dkv_r["bound_fma_ms"]})
    return out


def f32_forward_reading(torch, timer, shape, simple,
                        reading: str = "f32") -> dict:
    """The fp32 forward on the tensor cores (``flash_f32_fwd``, 3xTF32) at
    [BH, S, D] causal on the inputs of the simple form's reading
    ``reading`` (``form_inputs``; ``simple``: its rows; the new row keyed
    by the same name): o against the plain version on the first heads
    under the fp32 flash rule, lse within 1e-4, the rule refusing a result
    5% off, o and lse repeated bit for bit; its time beside the simple
    form's forward, the plain version's and SDPA's fp32 forward from that
    reading, bounds at 3xTF32's 165 TFLOP/s (``bound_ms``) and at fp32
    FMAs' 67 TFLOP/s (``bound_fma_ms``)."""
    from apex_tpu_torch.ops import flash_attn as FA

    BH, S, D = shape
    n = FLASH_CHECK_HEADS
    kw = dict(causal=True, scale=D ** -0.5)
    q, k, v, _ = form_inputs(torch, shape, torch.float32)
    o, lse = FA.flash_f32_fwd(q, k, v, **kw)
    o0, lse0 = FA.reference_attention(q[:n], k[:n], v[:n], return_lse=True,
                                      **kw)
    torch.cuda.synchronize()
    e = flash_err(torch, o[:n], o0, torch.float32)
    lse_err = float((lse[:n] - lse0).abs().max())
    check(e["used"] <= 1.0, f"flash f32 forward o: {e}")
    check(lse_err <= 1e-4, f"flash f32 forward lse: {lse_err} > 1e-4")
    late = torch.arange(S, device="cuda")[None, :, None] >= S // 2
    off = torch.where(late, o0 * 1.05, o0)
    check(flash_err(torch, off, o0, torch.float32)["used"] > 1.0,
          "flash f32 forward o: the limit passes a result 5% off")
    again = FA.flash_f32_fwd(q, k, v, **kw)
    rep = bool(torch.equal(again[0], o) and torch.equal(again[1], lse))
    check(rep, "flash f32 forward: two runs differ")
    del o0, lse0, again, late, off, o, lse
    was = simple[("flash_simt_fwd", reading)]
    pairs = BH * S * (S + 1) // 2
    nbytes, ops = 4 * BH * S * D * 4 + 4 * BH * S, 4 * D * pairs
    b_ms, b_by = bound(nbytes, ops, TF32X3_OPS_S)
    r = {"phase": "kernels", "kernel": "flash_f32_fwd", "reading": reading,
         "dtype": "float32", "shape": [BH, S, D], "causal": True,
         "checked_heads": n, "products": "3xTF32", "tol": was["tol"],
         "max_abs_err": e["max_abs_err"], "tol_used": e["used"],
         "lse_err": lse_err, "repeat_equal": rep,
         "ms": timer(lambda: FA.flash_f32_fwd(q, k, v, **kw)),
         "simple_ms": was["ms"], "plain_ms": was["plain_ms"],
         "plain_covers": was["plain_covers"],
         "library_ms": was["library_ms"],
         "library_covers": "the forward (causal SDPA fp32, allow_tf32 "
                           "False)",
         "bound_ms": b_ms, "bound_by": b_by,
         "bound_fma_ms": bound(nbytes, ops)[0]}
    emit(r)
    return {("flash_f32_fwd", reading): r}


# the shared-bias gradient's readings of phase 2 past the ViT bf16 ones:
# name -> ([BH, S, D], dtype name, causal, dropout); a learned [1, S, S]
# bias, the inputs of the flash forms' readings (form_inputs)
DBIAS_READINGS = {
    "d256_bf16": ([32, 1024, 256], "bfloat16", True, False),
    "d256_f32": ([32, 1024, 256], "float32", True, False),
    "d320_bf16": ([32, 1024, 320], "bfloat16", True, False),
    "d320_f32": ([32, 1024, 320], "float32", True, False),
    "vit_f32": ([VIT_BH, VIT_S, VIT_D], "float32", False, True),
}


def dbias_case(torch, shape, dt: str, causal: bool, drop: bool) -> tuple:
    """(q, k, v, dO, lse, delta, kw) of a shared-bias reading (as
    ``DBIAS_READINGS`` gives them): the flash forms' inputs (seed 13), the
    bias from seed 37 (times 0.5), lse by the forward of the package on
    the path, delta of its o."""
    from apex_tpu_torch.ops import flash_attn as FA
    q, k, v, do = form_inputs(torch, shape, getattr(torch, dt))
    gen = torch.Generator(device="cuda").manual_seed(37)
    s = shape[1]
    bias = torch.randn(1, s, s, generator=gen, device="cuda") * 0.5
    kw = dict(causal=causal, scale=shape[2] ** -0.5, bias=bias)
    if drop:
        kw.update(dropout_rate=VIT["dropout"], dropout_seed=VIT_SEED)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    return q, k, v, do, lse, FA.flash_delta(o, do), kw


def dbias_readings(torch, timer) -> dict:
    """``flash_bwd_dbias`` at ``DBIAS_READINGS``: [32, 1024, 256] and [32,
    1024, 320] causal in bf16 (the wgmma kernel) and fp32 (3xTF32), and
    ViT's [1536, 197, 64] in fp32 with dropout 0.1, each against the plain
    version under the dtype's flash rule and repeated bit for bit, the
    simple form (``flash_simt_dbias``) held and timed on the same inputs,
    SDPA's backward with the bias as a learned [1, 1, Sq, Sk] mask (its
    causal part -inf; with ``dropout_p`` where the reading drops, a
    yardstick only) beside it; bounds at 989 TFLOP/s (bf16) and at 3xTF32's
    165 and fp32 FMAs' 67 (fp32). Keyed ("flash_bwd_dbias", name) and
    ("flash_simt_dbias", name)."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import flash_attn as FA

    rows = {}
    for name, (shape, dt_name, causal, drop) in DBIAS_READINGS.items():
        dt = getattr(torch, dt_name)
        bh, s, d = shape
        q, k, v, do, lse, delta, kw = dbias_case(torch, shape, dt_name,
                                                 causal, drop)
        ds_sum = FA.flash_bwd_dbias_plain(q, k, v, do, lse, delta, **kw)
        bias = kw["bias"]
        if causal:
            keep = torch.ones(s, s, device="cuda", dtype=torch.bool).tril()
            mask = torch.where(keep, bias[0], float("-inf"))
        else:
            mask = bias[0]
        ml = mask.to(dt)[None, None].detach().clone().requires_grad_(True)
        q4, k4, v4 = (t.view(1, bh, s, d).detach().requires_grad_(True)
                      for t in (q, k, v))
        lo = F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=ml,
            dropout_p=kw.get("dropout_rate", 0.0))
        lib_bwd = timer(lambda: torch.autograd.grad(
            lo, (q4, k4, v4, ml), do.view(1, bh, s, d), retain_graph=True))
        live = bh * s * (s + 1) // 2 if causal else bh * s * s
        row = _dbias_reading(torch, timer, q, k, v, do, lse, delta, kw,
                             ds_sum, lib_bwd, live, dt,
                             BF16_DENSE_OPS_S if dt_name == "bfloat16"
                             else TF32X3_OPS_S, simple=True)
        row.update(dtype=dt_name, shape=[bh, s, s, d], causal=causal,
                   dropout=kw.get("dropout_rate", 0.0),
                   form=FA.kernel_form(q, "dbias"),
                   library_covers="dq, dk, dv and the mask's gradient "
                                  "(one SDPA backward)")
        simple = row.pop("simple")
        emit({"phase": "kernels", "kernel": "flash_bwd_dbias",
              "reading": name, **row})
        emit({"phase": "kernels", "kernel": "flash_simt_dbias",
              "reading": name, **simple})
        rows[("flash_bwd_dbias", name)] = row
        rows[("flash_simt_dbias", name)] = simple
        del q, k, v, do, lse, delta, kw, lo, ml, ds_sum, q4, k4, v4, mask
    return rows


def flash_forms_phase(torch, timer) -> dict:
    """The fp16 forms of the tensor-core kernels at the LM's [128, 4095,
    64] and the wide LM's [384, 2048, 128] (their bf16 forms' rows are
    phase 2's LM and wide readings), the simple form in fp32 at [128,
    4095, 64], its bound at the 67 TFLOP/s of fp32 outside the tensor
    cores, and the fp32 forward and backward on the tensor cores on the
    same inputs; the simple form at phase 30's [32, 1024, 256] in bf16 and
    fp32 (SDPA's at D 256 beside it; bf16's bound at 989 TFLOP/s, fp32's
    at 67) and in bf16 and fp32 at D 320; the forward, dq and dk/dv at D
    384 and 512 at [32, 1024, 320] and [16, 1024, 512] in bf16 and fp16
    (readings ``d320_tc_*``, ``d512_tc_*``) and in fp32 in 3xTF32
    (``d320_f32x``, ``d512_f32x``), the simple forward's, dq's and dk/dv's
    times beside them; ``flash_bwd_dbias`` at D 256 and 320 in bf16 and
    fp32 and at ViT's shape in fp32, the simple form's beside it
    (``dbias_readings``); and the fp32 forward, dq and dk/dv in
    3xTF32 on the fp32 inputs (reading ``d256_f32``), dq and dk/dv again
    at the hd-256 LM's [64, 4096, 256] (``hd256_lm_f32``, the simple form
    timed there); the D-256 forward, dq and dk/dv,
    in bf16 and fp16, at [32, 1024, 256] (readings ``d256_tc_bf16``,
    ``d256_tc_f16``: the simple form's times on the same inputs beside
    bf16's) and at the hd-256 LM's [64, 4096, 256] (``hd256_lm_bf16``,
    with the whole backward, ``hd256_lm_f16``), bounds at 989 TFLOP/s."""
    from apex_tpu_torch.ops import flash_attn as FA

    tc = (FA.flash_fwd, FA.flash_bwd_dq, FA.flash_bwd_dkv)
    simt = (FA.flash_simt_fwd, FA.flash_simt_dq, FA.flash_simt_dkv)
    tc256 = (FA.flash_d256_fwd, FA.flash_d256_dq, FA.flash_d256_dkv)
    lm = [LM_SHAPE["batch"] * LM_SHAPE["heads"], LM_SHAPE["seq"] - 1,
          LM_SHAPE["embed"] // LM_SHAPE["heads"]]
    w = WIDE_SHAPE
    wide = [w["batch"] * w["heads"], w["seq"], w["embed"] // w["heads"]]
    rows = {}
    rows.update(flash_form_readings(torch, timer, "f16", lm, torch.float16,
                                    tc, BF16_DENSE_OPS_S))
    rows.update(flash_form_readings(torch, timer, "f16_wide", wide,
                                    torch.float16, tc, BF16_DENSE_OPS_S))
    rows.update(flash_form_readings(torch, timer, "f32", lm, torch.float32,
                                    simt, FP32_OPS_S, plain_group=8))
    rows.update(f32_backward_readings(torch, timer, lm, rows))
    rows.update(f32_forward_reading(torch, timer, lm, rows))
    d256 = [32, 1024, 256]
    for dt, tag, ops_s in ((torch.bfloat16, "bf16", BF16_DENSE_OPS_S),
                           (torch.float32, "f32", FP32_OPS_S)):
        rows.update(flash_form_readings(torch, timer, "d256_" + tag, d256,
                                        dt, simt, ops_s))
    rows.update(f32_forward_reading(torch, timer, d256, rows, "d256_f32"))
    rows.update(f32_backward_readings(torch, timer, d256, rows, "d256_f32"))
    d320 = [32, 1024, 320]
    rows.update(flash_form_readings(torch, timer, "d320_bf16", d320,
                                    torch.bfloat16, simt, BF16_DENSE_OPS_S))
    rows.update(flash_form_readings(torch, timer, "d320_f32", d320,
                                    torch.float32, simt, FP32_OPS_S))
    # the forward, dq and dk/dv at D 384 and 512, the simple forward, dq
    # and dk/dv timed on the same inputs
    tc512 = (FA.flash_d512_fwd, FA.flash_d512_dq, FA.flash_d512_dkv)
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        for shape, reading in ((d320, "d320_tc_" + tag),
                               ([16, 1024, 512], "d512_tc_" + tag)):
            rows.update(flash_form_readings(
                torch, timer, reading, shape, dt, tc512, BF16_DENSE_OPS_S,
                whole=reading == "d320_tc_bf16", simple=simt))
    # and in fp32, in 3xTF32 (the bounds at 3xTF32's rate and at fp32
    # FMAs'; lse within 1e-4), the simple forward, dq and dk/dv timed on
    # the same inputs, the whole backward at [32, 1024, 320]
    f32x = (FA.flash_f32_d512_fwd, FA.flash_f32_d512_dq,
            FA.flash_f32_d512_dkv)
    for shape, reading in ((d320, "d320_f32x"), ([16, 1024, 512],
                                                 "d512_f32x")):
        rows.update(flash_form_readings(
            torch, timer, reading, shape, torch.float32, f32x, TF32X3_OPS_S,
            plain_group=8, whole=reading == "d320_f32x", simple=simt,
            lse_tol=1e-4, fma_ops_s=FP32_OPS_S))
    rows.update(dbias_readings(torch, timer))
    c = HD256_SHAPE
    lm256 = [c["batch"] * c["heads"], c["seq"], c["embed"] // c["heads"]]
    rows.update(f32_backward_readings(torch, timer, lm256, rows,
                                      "hd256_lm_f32"))
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        for shape, reading in ((d256, "d256_tc_" + tag),
                               (lm256, "hd256_lm_" + tag)):
            got = flash_form_readings(torch, timer, reading, shape, dt,
                                      tc256, BF16_DENSE_OPS_S,
                                      whole=reading == "hd256_lm_bf16")
            if reading == "d256_tc_bf16":
                # the simple forward, dq and dk/dv on the same inputs
                for new, old in (("flash_d256_fwd", "flash_simt_fwd"),
                                 ("flash_d256_dq", "flash_simt_dq"),
                                 ("flash_d256_dkv", "flash_simt_dkv")):
                    r = got[(new, reading)]
                    r["simple_ms"] = rows[(old, "d256_bf16")]["ms"]
                    emit({"phase": "kernels", "reading": reading,
                          "kernel": new, "simple_ms": r["simple_ms"],
                          "ms": r["ms"]})
            rows.update(got)
    return rows


def ln_wide_bits(torch) -> dict:
    """The first 16 hex digits of the sha256 of ``ln_bwd_wide``'s dx, dγ and
    dβ at the wide LM's [8192, 12288] bf16 rows (the one-pass form, 16-byte
    loads) from seeded inputs: one package's bits, to hold against
    another's."""
    import hashlib

    from apex_tpu_torch.ops import layer_norm as LN

    gen = torch.Generator(device="cuda").manual_seed(31)
    f = 12288
    x, dy = ((torch.randn(8192, f, generator=gen, device="cuda") * 2 + 0.5)
             .to(torch.bfloat16) for _ in range(2))
    w = (torch.randn(f, generator=gen, device="cuda") + 1).to(torch.bfloat16)
    _, mean, inv = LN.ln_fwd_plain(x, w, torch.zeros_like(w), 1e-5)
    got = LN.ln_bwd_wide(dy, x, w, mean, inv)
    return {n: hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()[:16]
            for n, t in zip(("dx", "gw", "gb"), got)}


def tail_kernel_phase(torch, timer) -> dict:
    """The scalar tails beside the vector forms: ``ln_bwd`` (and
    ``ln_fwd``) at F 1022 over the LM's 32760 rows, bf16, under phase 2's
    LN rule (the vector form's reading is row ``ln_bwd`` at F 1024), the
    wide kernels at F 12290 (the one-pass backward's 2-wide loads) and
    12289 (its scalar loads) over the wide LM's 8192 rows; the welford
    passes at C 6 and, beside them, C 8 over 256·56·56 rows, bf16 (sums
    within 1e-5·Σ|terms|, dx and dz bit-equal, repeats bit-equal)."""
    from apex_tpu_torch.ops import layer_norm as LN
    from apex_tpu_torch.ops import welford as WF

    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = {}
    for kern, n_rows, f in (("ln_bwd", LM_SHAPE["batch"] *
                             (LM_SHAPE["seq"] - 1), 1022),
                            ("ln_bwd_wide", 8192, 12290),
                            ("ln_bwd_wide", 8192, 12289)):
        x = (torch.randn(n_rows, f, generator=gen, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        dy = torch.randn(n_rows, f, generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn(f, generator=gen, device="cuda") + 1).to(
            torch.bfloat16)
        b = torch.randn(f, generator=gen, device="cuda").to(torch.bfloat16)
        y, mean, inv = LN.ln_fwd(x, w, b, 1e-5)
        y0, _, _ = LN.ln_fwd_plain(x, w, b, 1e-5)
        y_err, ok = max_err(y, y0, "bfloat16")
        check(ok, f"{kern} F {f}: the forward's y err {y_err}")
        got = LN.ln_bwd(dy, x, w, mean, inv)
        errs = check_ln_bwd(torch, f"{kern} F {f}", got,
                            LN.ln_bwd_plain(dy, x, w, mean, inv), dy, x, w,
                            mean, inv)
        rep = all(bool(torch.equal(a, c)) for a, c in
                  zip(got, LN.ln_bwd(dy, x, w, mean, inv)))
        check(rep, f"{kern} F {f}: two runs differ")
        b_ms, b_by = bound(3 * n_rows * f * 2 + 8 * n_rows + 2 * f + 8 * f,
                           11 * n_rows * f)
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [f], w, b,
                                                           1e-5)
        fwd_kern = "ln_fwd" if f <= LN.F_SINGLE_MAX else "ln_fwd_wide"
        fb = bound(2 * n_rows * f * 2 + 4 * f + 8 * n_rows, 8 * n_rows * f)
        for r in (dict(kernel=fwd_kern, reading="tail", dtype="bfloat16",
                       shape=[n_rows, f], max_abs_err=y_err,
                       tol=TOL["bfloat16"],
                       ms=timer(lambda: LN.ln_fwd(x, w, b, 1e-5)),
                       plain_ms=timer(lambda: LN.ln_fwd_plain(x, w, b,
                                                              1e-5)),
                       library_ms=timer(lambda: torch.nn.functional
                                        .layer_norm(x, (f,), w, b, 1e-5)),
                       bound_ms=fb[0], bound_by=fb[1],
                       host_us=host_us(torch, lambda: LN.ln_fwd(x, w, b,
                                                                1e-5),
                                       n=100)),
                  dict(kernel=kern, reading="tail", dtype="bfloat16",
                       shape=[n_rows, f],
                       # fresh tensors are aligned: the width picks the
                       # form (the wide backward's load width)
                       **(ln_bwd_wide_form(LN, x, w)
                          if kern == "ln_bwd_wide" else {"form": "scalar"}),
                       **errs, repeat_equal=rep,
                       ms=timer(lambda: LN.ln_bwd(dy, x, w, mean, inv)),
                       plain_ms=timer(lambda: LN.ln_bwd_plain(dy, x, w, mean,
                                                              inv)),
                       library_ms=timer(
                           lambda: torch.ops.aten.native_layer_norm_backward(
                               dy, x, [f], lmean, lrstd, w, b,
                               [True, True, True])),
                       bound_ms=b_ms, bound_by=b_by,
                       host_us=host_us(torch, lambda: LN.ln_bwd(
                           dy, x, w, mean, inv), n=100))):
            emit({"phase": "kernels", **r})
            rows[(r["kernel"], "tail", f)] = r
        del x, dy, y, y0, got, lmean, lrstd
    n = 256 * 56 * 56
    for c in (6, 8):
        x = (torch.randn(n, c, generator=gen, device="cuda") * 2 + 0.5).to(
            torch.bfloat16)
        dy = torch.randn(n, c, generator=gen, device="cuda").to(
            torch.bfloat16)
        out = torch.relu(torch.randn(n, c, generator=gen,
                                     device="cuda")).to(torch.bfloat16)
        s, q = WF.bn_moments(x)
        s0, q0 = WF.bn_moments_plain(x)
        xf = x.float()
        for a, b0, terms in ((s, s0, xf.abs()), (q, q0, xf * xf)):
            lim = 1e-5 * terms.sum(0) + 1e-6
            check(bool(((a - b0).abs() <= lim).all()),
                  f"bn_moments C {c}: sums off")
        check(torch.equal(WF.bn_moments(x)[1], q), f"bn_moments C {c}: "
              f"two runs differ")
        mean = s0 / n
        inv = torch.rsqrt(q0 / n - mean * mean + 1e-5)
        r1 = WF.bn_backward_fused_reduce(dy, x, mean, inv, out)
        r0 = WF.bn_backward_fused_reduce_plain(dy, x, mean, inv, out)
        dyf = dy.float()
        for a, b0, terms in ((r1[0], r0[0], dyf),
                             (r1[1], r0[1], dyf * (xf - mean) * inv)):
            lim = 1e-5 * terms.abs().sum(0) + 1e-6
            check(bool(((a - b0).abs() <= lim).all()),
                  f"bn_backward_fused_reduce C {c}: sums off")
        wt = torch.rand(c, generator=gen, device="cuda") + 0.5
        args = (dy, x, mean, inv, inv * wt, r0[0] / n, r0[1] / n, out, True)
        dx, dz = WF.bn_backward_dx(*args)
        dx0, dz0 = WF.bn_backward_dx_plain(*args)
        check(torch.equal(dx, dx0) and torch.equal(dz, dz0),
              f"bn_backward_dx C {c}: not bit-equal to the plain version")
        del xf, dyf
        for kern, call, plain, nbytes, ops in (
                ("bn_moments", lambda: WF.bn_moments(x),
                 lambda: WF.bn_moments_plain(x), 2 * n * c + 8 * c,
                 3 * n * c),
                ("bn_backward_fused_reduce",
                 lambda: WF.bn_backward_fused_reduce(dy, x, mean, inv, out),
                 lambda: WF.bn_backward_fused_reduce_plain(dy, x, mean, inv,
                                                           out),
                 6 * n * c + 16 * c, 6 * n * c),
                ("bn_backward_dx", lambda: WF.bn_backward_dx(*args),
                 lambda: WF.bn_backward_dx_plain(*args), 10 * n * c + 20 * c,
                 8 * n * c)):
            b_ms, b_by = bound(nbytes, ops)
            r = dict(kernel=kern, reading="tail", dtype="bfloat16",
                     shape=[n, c],
                     # fresh tensors are aligned: the width picks the form
                     form="scalar" if c % 4 else "vector",
                     max_abs_err=0.0 if kern == "bn_backward_dx" else None,
                     repeat_equal=True, ms=timer(call),
                     plain_ms=timer(plain), library_ms=None, bound_ms=b_ms,
                     bound_by=b_by)
            emit({"phase": "kernels", **r})
            rows[(kern, "tail", c)] = r
        del x, dy, out
    return rows


# -- phases 26-27: lm_bench's LM served at full width (16 heads of 64) ------

def lm_serve_model(torch):
    from apex_tpu_torch.models import TransformerLM
    model = TransformerLM(vocab_size=LM_SHAPE["vocab"], max_seq_len=1024,
                          embed_dim=LM_SHAPE["embed"],
                          num_heads=LM_SERVE_HEADS,
                          num_layers=LM_SHAPE["layers"])
    return model, model.init(torch.Generator().manual_seed(0),
                             dtype=torch.bfloat16)


def lm_serve_phases(torch, reqs) -> tuple:
    """lm_bench's LM (8 × 1024, 16 heads of 64) behind phases 3-4's
    engines and requests: every decode step's attention by the split
    kernel at head dim 64, and its merge (the arena holds 1024 positions);
    paged streams equal to dense."""
    model, params = lm_serve_model(torch)
    check(model.embed_dim // model.num_heads == 64, "lm_serve: head dim")
    dense, dstats, dcounts = serve_phase(torch, "lm_serve_dense", model,
                                         params, reqs)
    steps = dstats["decode_steps"]
    check(dcounts["decode_attention"] == model.num_layers * steps,
          f"lm_serve_dense: decode_attention launched "
          f"{dcounts['decode_attention']} times for {steps} steps")
    check(dcounts["decode_merge"] == model.num_layers * steps,
          f"lm_serve_dense: decode_merge launched {dcounts['decode_merge']}"
          f" times for {steps} steps")
    check(dcounts["paged_decode_attention"] == 0,
          "lm_serve_dense: the paged kernel ran on the dense arena")
    paged, pstats, pcounts = serve_phase(
        torch, "lm_serve_paged", model, params, reqs, paged=True,
        page_size=32, kv_pages=8 * (1024 // 32) // 2)
    steps = pstats["decode_steps"]
    check(pcounts["paged_decode_attention"] == model.num_layers * steps
          and pcounts["decode_merge"] == model.num_layers * steps,
          "lm_serve_paged: paged_decode_attention or decode_merge count != "
          "layers x steps")
    check(pcounts["decode_attention"] == 0,
          "lm_serve_paged: the dense kernel ran on the paged arena")
    same = [a.tokens == b.tokens for a, b in zip(dense, paged)]
    emit({"phase": "lm_serve_paged_vs_dense", "requests_equal": sum(same),
          "requests": len(same)})
    check(all(same), "lm_serve: paged token streams differ from dense")
    return dcounts, pcounts


# -- phases 28-29: lm_bench's LM trained in fp16 (O2, dynamic scale) and
# -- in fp32 (O0, --dtype f32), attention "fast" ------------------------------

F16_PER_STEP = {"flash_fwd": 8, "flash_bwd_dq": 8, "flash_bwd_dkv": 8,
                "flash_simt_fwd": 0, "flash_simt_dq": 0,
                "flash_simt_dkv": 0, "flash_f32_fwd": 0, "flash_f32_dq": 0,
                "flash_f32_dkv": 0, "ln_fwd": 17, "ln_bwd": 17}
# fp32: the forward and the backward on the tensor cores in 3xTF32, none
# of the simple form
F32_PER_STEP = {"flash_f32_fwd": 8, "flash_f32_dq": 8, "flash_f32_dkv": 8,
                "flash_simt_fwd": 0, "flash_simt_dq": 0, "flash_simt_dkv": 0,
                "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "ln_fwd": 17, "ln_bwd": 17}


def lm_dtype_phase(torch, model, params, phase, dtype, warm, timed,
                   per_step) -> dict:
    """phase 9's model and batch in another dtype: fp16 by O2 with a
    dynamic loss scale (``LMTrainer(dtype=float16, loss_scale="dynamic")``:
    ``amp.initialize(opt_level="O2", half_dtype=float16)``), fp32 by O0
    (``dtype=None``); ``warm`` + ``timed`` steps, then one profiled;
    losses finite, the mean of the last 3 below the first; the launches a
    step of ``per_step``."""
    import numpy as np

    from apex_tpu_torch.train import LMTrainer

    c = LM_SHAPE
    kw = dict(loss_scale="dynamic") if dtype == torch.float16 else {}
    tr = LMTrainer(model, params, lr=1e-4, dtype=dtype, **kw)
    toks = lm_batch(torch)
    r = timed_steps(torch, lambda: tr.step(toks), warm, timed)
    counts = r["counts"]
    tokens = c["batch"] * c["seq"]
    step_flops = lm_step_flops(tr.table.total)
    prof = profile_steps(torch, lambda: tr.step(toks), LM_KERNEL_FAMILIES,
                         n=1)
    row = {"phase": phase, "model": "TransformerLM", **c,
           "attn_impl": model.attn_impl,
           "dtype": "float32" if dtype is None else "float16",
           "masters": "float32", "optimizer": "FusedAdam(lr=1e-4)",
           "loss_scale": kw.get("loss_scale"), "batch_cut": False,
           **window_row(r, timed), "tok_per_s": tokens * timed / r["wall"],
           "mfu": step_flops * timed / r["wall"] / (
               FP32_OPS_S if dtype is None else BF16_DENSE_OPS_S),
           "mfu_peak": "67 TFLOP/s fp32" if dtype is None
           else "989 TFLOP/s fp16 dense",
           "launches": {k: counts[k] for k in per_step},
           "launches_per_step": {k: counts[k] / timed for k in per_step},
           "profile": prof}
    if tr.amp_state is not None:
        row["loss_scale_last"] = float(tr.handle.loss_scale(tr.amp_state))
    emit(row)
    loss = r["loss"]
    check(all(np.isfinite(loss)), f"{phase}: non-finite loss {loss}")
    check(sum(loss[-3:]) / 3 < loss[0], f"{phase}: the mean of the last 3 "
          f"losses is not below the first: {loss}")
    check_counts(phase, counts, {k: n * timed for k, n in per_step.items()})
    return counts


# -- phase 30: FusedLayerNorm(1022) and SyncBatchNorm(6) trained -------------

def tails_train_phase(torch) -> dict:
    """The fault inputs as their users call them, a few forward/backward
    passes each against the plain versions on the same inputs under phase
    2's limits: ``FusedLayerNorm(1022)`` over [16, 2048, 1022] bf16 (y
    within 1 bf16 ulp + 1e-5; dx, dγ, dβ by ``check_ln_bwd``),
    ``SyncBatchNorm(6, axis_name=None, fuse_relu=True)`` over [64, 6, 56,
    56] bf16 in channels_last with a residual (out, dx and dz within
    phase 2's bf16 tolerance, dγ and dβ within 1e-5·Σ|terms|), and
    ``flash_attention`` at head dim 256 over [32, 1024, 256] fp32 causal
    (the forward, dq and dk/dv in 3xTF32) under the fp32 flash rule, and
    at head dim 320 over [16, 1024, 320] causal in bf16 (the forward, dq
    and dk/dv at D 384) under the flash rule and in fp32 (the forward, dq
    and dk/dv in 3xTF32 at D 384) under the fp32 rule; the kernels'
    launches counted, none of the simple form's."""
    from apex_tpu_torch.contrib.multihead_attn import flash_attention
    from apex_tpu_torch.normalization import FusedLayerNorm
    from apex_tpu_torch.ops import dispatch
    from apex_tpu_torch.ops import layer_norm as LN
    from apex_tpu_torch.parallel import SyncBatchNorm

    gen = torch.Generator(device="cuda").manual_seed(29)
    f = 1022
    ln = FusedLayerNorm(f, device="cuda")
    with torch.no_grad():
        ln.weight.copy_(torch.rand(f, generator=gen, device="cuda") + 0.5)
        ln.bias.copy_(torch.randn(f, generator=gen, device="cuda"))
    bn = SyncBatchNorm(6, axis_name=None, channel_last=False,
                       fuse_relu=True)
    params, state = bn.init("cuda")
    params = {k: (torch.rand(6, generator=gen, device="cuda") + 0.5
                  if k == "weight" else torch.randn(
                      6, generator=gen, device="cuda")).requires_grad_(True)
              for k in params}

    def ln_pass():
        x = (torch.randn(16, 2048, f, generator=gen, device="cuda") * 2
             + 0.5).to(torch.bfloat16).requires_grad_(True)
        dy = torch.randn(16, 2048, f, generator=gen, device="cuda").to(
            torch.bfloat16)

        def run():
            y = ln(x)
            return (y, *torch.autograd.grad(y, (x, ln.weight, ln.bias), dy))
        got = run()
        with dispatch.backend("reference"):
            want = run()
        y_err, ok = max_err(got[0], want[0], "bfloat16")
        check(ok, f"FusedLayerNorm(1022): y err {y_err}")
        x2 = x.detach().reshape(-1, f)
        _, mean, inv = LN.ln_fwd_plain(x2, None, None, 1e-5)
        errs = check_ln_bwd(torch, "FusedLayerNorm(1022)",
                            (got[1].reshape(-1, f), got[2], got[3]),
                            (want[1].reshape(-1, f), want[2], want[3]),
                            dy.reshape(-1, f), x2, ln.weight.detach(), mean,
                            inv)
        return {"y_err": y_err, **errs}

    def bn_pass():
        x = (torch.randn(64, 6, 56, 56, generator=gen, device="cuda") * 2
             + 0.5).to(torch.bfloat16).contiguous(
                 memory_format=torch.channels_last).requires_grad_(True)
        z = torch.randn(64, 6, 56, 56, generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(
                memory_format=torch.channels_last).requires_grad_(True)
        dy = torch.randn(64, 6, 56, 56, generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

        def run():
            out, _ = bn(params, state, x, z=z)
            return (out, *torch.autograd.grad(
                out, (x, z, params["weight"], params["bias"]), dy))
        got = run()
        with dispatch.backend("reference"):
            want = run()
        out_err, ok = max_err(got[0], want[0], "bfloat16")
        check(ok, f"SyncBatchNorm(6): out err {out_err}")
        for name, a, b0 in (("dx", got[1], want[1]), ("dz", got[2], want[2])):
            e, ok = max_err(a, b0, "bfloat16")
            check(ok, f"SyncBatchNorm(6): {name} err {e}")
        # the sums' terms: dy masked by the relu, times xhat for dγ
        xf = x.detach().float()
        mean = xf.mean((0, 2, 3), keepdim=True)
        xhat = (xf - mean) * torch.rsqrt(
            xf.var((0, 2, 3), unbiased=False, keepdim=True) + 1e-5)
        dym = torch.where(got[0].float() > 0, dy.float(),
                          torch.zeros((), device="cuda"))
        for name, a, b0, terms in (("dweight", got[3], want[3], dym * xhat),
                                   ("dbias", got[4], want[4], dym)):
            lim = 1e-5 * terms.abs().sum((0, 2, 3)) + 1e-6
            check(bool(((a - b0).abs() <= lim).all()),
                  f"SyncBatchNorm(6): {name} off by "
                  f"{float((a - b0).abs().max())}")
        return {"out_err": out_err,
                "dx_err": float((got[1].float() - want[1].float()).abs()
                                .max())}

    def flash_pass(shape, dt):
        q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda")
                       .to(dt) for _ in range(4))
        ts = [t.requires_grad_(True) for t in (q, k, v)]

        def run():
            o = flash_attention(*ts, causal=True)
            return (o, *torch.autograd.grad(o, ts, do))
        got = run()
        with dispatch.backend("reference"):
            want = run()
        errs = {}
        for name, a, b0 in zip(("o", "dq", "dk", "dv"), got, want):
            errs[name] = flash_err(torch, a, b0, dt)["used"]
            check(errs[name] <= 1.0, f"flash_attention at {shape} {dt}: "
                  f"{name} uses {errs[name]} of the flash rule")
        return errs

    f32_256, bf16_320, f32_320 = ([32, 1024, 256], torch.float32), \
        ([16, 1024, 320], torch.bfloat16), ([16, 1024, 320], torch.float32)
    ln_pass()
    bn_pass()                       # first use of every form
    flash_pass(*f32_256)
    flash_pass(*bf16_320)
    flash_pass(*f32_320)
    torch.cuda.synchronize()
    zero_counts()
    lns = [ln_pass() for _ in range(3)]
    bns = [bn_pass() for _ in range(3)]
    fls = [flash_pass(*f32_256) for _ in range(3)]
    wide = [flash_pass(*bf16_320) for _ in range(3)]
    wide32 = [flash_pass(*f32_320) for _ in range(3)]
    torch.cuda.synchronize()
    counts = read_counts()
    row = {"phase": "tails_train", "fused_layer_norm": {
               "shape": [16, 2048, f], "dtype": "bfloat16", "passes": lns},
           "sync_batchnorm": {"shape": [64, 6, 56, 56], "dtype": "bfloat16",
                              "layout": "channels_last", "fuse_relu": True,
                              "passes": bns},
           "flash_attention": {"shape": [32, 1024, 256], "dtype": "float32",
                               "causal": True, "tol_used": fls},
           "flash_attention_d320": {"shape": [16, 1024, 320],
                                    "dtype": "bfloat16", "causal": True,
                                    "tol_used": wide},
           "flash_attention_d320_f32": {"shape": [16, 1024, 320],
                                        "dtype": "float32", "causal": True,
                                        "tol_used": wide32},
           "launches": {k: counts[k] for k in TAIL_KERNELS}}
    emit(row)
    for k in TAIL_KERNELS:
        check(counts[k] > 0, f"tails_train: {k} never launched")
    simple = {k: counts[k] for k in ("flash_simt_fwd", "flash_simt_dq",
                                     "flash_simt_dkv")}
    check(not any(simple.values()), f"tails_train: the simple form ran "
          f"{simple}")
    return counts


TAIL_KERNELS = ("ln_fwd", "ln_bwd", "bn_moments", "bn_backward_fused_reduce",
                "bn_backward_dx", "flash_f32_fwd", "flash_f32_dq",
                "flash_f32_dkv", "flash_d512_fwd", "flash_d512_dq",
                "flash_d512_dkv", "flash_f32_d512_fwd", "flash_f32_d512_dq",
                "flash_f32_d512_dkv")


# -- phases 31-33: lm_bench's LM at 8 heads of 256, bf16 and fp32 ------------

# tools/lm_bench.py --dim 2048 --heads 8 at its other defaults (phase 9's
# vocab, S, depth and batch): Gemma 2B's attention shape (d_model 2048, 8
# heads of 256)
HD256_SHAPE = dict(LM_SHAPE, embed=2048, heads=8)
HD256_BATCH = 8           # the batch the phase runs (HD256_SHAPE's: no cut)
# the forward, dq and dk/dv on the tensor cores at D 256; none of the
# simple form's
HD256_PER_STEP = {"flash_d256_fwd": 8, "flash_d256_dq": 8,
                  "flash_d256_dkv": 8, "flash_simt_fwd": 0,
                  "flash_simt_dq": 0, "flash_simt_dkv": 0, "flash_fwd": 0,
                  "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "ln_fwd": 17,
                  "ln_bwd": 17, "adam": 1}
# phase 33, in fp32 (``--dtype f32``): the forward, dq and dk/dv in
# 3xTF32 at D 256 (dq and dk/dv by the pair kernels), none of the simple
# form's or the 16-bit kernels'
HD256_F32_BATCH = 8       # the batch the phase runs (not cut)
HD256_F32_PER_STEP = {"flash_f32_fwd": 8, "flash_f32_dq": 8,
                      "flash_f32_dkv": 8, "flash_simt_fwd": 0,
                      "flash_simt_dq": 0, "flash_simt_dkv": 0,
                      "flash_d256_fwd": 0, "flash_d256_dq": 0,
                      "flash_d256_dkv": 0, "flash_fwd": 0,
                      "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "ln_fwd": 17,
                      "ln_bwd": 17, "adam": 1}


def lm_hd256_train_phase(torch, dtype=None) -> dict:
    """``tools/lm_bench.py --dim 2048 --heads 8`` on one card
    (TransformerLM: vocab 32768, 8 layers, 2048 wide, 8 heads of 256,
    attention "fast", fused head in vocab chunks of 8192; random weights
    from ``torch.Generator`` seed 0), ``FusedAdam(lr=1e-4)``, phase 9's
    batch (8 × 4096, the batch cut to ``HD256_BATCH`` rows where that is
    smaller). Phase 31 (``dtype`` bf16): O2 bf16 over fp32 flat masters, 3
    warm-up and 5 timed steps, the launches a step of ``HD256_PER_STEP``,
    MFU against 989 TFLOP/s; phase 33 (``dtype`` None, ``--dtype f32``):
    O0 fp32 (``LMTrainer(dtype=None)``), 2 warm-up and 3 timed steps, the
    batch cut to ``HD256_F32_BATCH``, ``HD256_F32_PER_STEP``, MFU against
    67 TFLOP/s fp32. One step profiled; losses finite, the mean of the
    last 3 below the first."""
    import numpy as np

    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.train import LMTrainer

    c = HD256_SHAPE
    f32 = dtype is None
    phase = "lm_train_hd256_f32" if f32 else "lm_train_hd256"
    warm, timed = (2, 3) if f32 else (3, 5)
    batch = HD256_F32_BATCH if f32 else HD256_BATCH
    per_step = HD256_F32_PER_STEP if f32 else HD256_PER_STEP
    model = TransformerLM(vocab_size=c["vocab"], max_seq_len=c["seq"],
                          embed_dim=c["embed"], num_heads=c["heads"],
                          num_layers=c["layers"], attn_impl="fast",
                          head_chunk=min(8192, c["vocab"]))
    kw = dict(dtype=None) if f32 else {}
    tr = LMTrainer(model, model.init(torch.Generator().manual_seed(0)),
                   lr=1e-4, **kw)
    toks = lm_batch(torch)[:batch]
    r = timed_steps(torch, lambda: tr.step(toks), warm, timed)
    counts = r["counts"]
    tokens = batch * c["seq"]
    step_flops = lm_step_flops(tr.table.total, dict(c, batch=batch))
    prof = profile_steps(torch, lambda: tr.step(toks), LM_KERNEL_FAMILIES,
                         n=1)
    row = {"phase": phase, "model": "TransformerLM", **c,
           "head_dim": c["embed"] // c["heads"], "batch": batch,
           "batch_cut": batch != c["batch"],
           "attn_impl": model.attn_impl, "head_chunk": model.head_chunk,
           "dtype": "float32" if f32 else "bfloat16", "masters": "float32",
           "optimizer": "FusedAdam(lr=1e-4)", **window_row(r, timed),
           "tokens_per_step": tokens, "tok_per_s": tokens * timed / r["wall"],
           "step_tflop": step_flops / 1e12,
           "mfu": step_flops * timed / r["wall"] / (
               FP32_OPS_S if f32 else BF16_DENSE_OPS_S),
           "mfu_peak": "67 TFLOP/s fp32" if f32
           else "989 TFLOP/s bf16 dense",
           "params": tr.table.total,
           "launches": {k: counts[k] for k in per_step},
           "launches_per_step": {k: counts[k] / timed for k in per_step},
           "profile": prof}
    emit(row)
    loss = r["loss"]
    check(all(np.isfinite(loss)), f"{phase}: non-finite loss {loss}")
    check(sum(loss[-3:]) / 3 < loss[0], f"{phase}: the mean of the last 3 "
          f"losses is not below the first: {loss}")
    check_counts(phase, counts, {k: n * timed for k, n in per_step.items()})
    return counts


def lm_hd256_crosscheck_phase(torch, dispatch) -> dict:
    """A small LM at head dim 256 (2 layers, embed 512, 2 heads of 256,
    vocab 512, S 256, batch 2) under phase 10's ``adam_crosscheck`` at lr
    1e-3: the kernel runs through the D-256 forward, dq and dk/dv."""
    from apex_tpu_torch.models import TransformerLM

    m = TransformerLM(vocab_size=512, max_seq_len=256, embed_dim=512,
                      num_heads=2, num_layers=2, attn_impl="fast",
                      head_chunk=512)
    params = m.init(torch.Generator().manual_seed(2))
    toks = torch.randint(0, 512, (2, 257), generator=torch.Generator()
                         .manual_seed(3)).cuda()
    row = adam_crosscheck(torch, dispatch, "lm_hd256_crosscheck", m, params,
                          (toks,), {}, {"lr": 1e-3})
    ran = row["kernel_launches"]
    check(all(ran.get(k, 0) > 0 for k in ("flash_d256_fwd", "flash_d256_dq",
                                          "flash_d256_dkv"))
          and not any(ran.get(k) for k in ("flash_simt_fwd", "flash_simt_dq",
                                           "flash_simt_dkv")),
          f"lm_hd256_crosscheck: kernels launched {ran}")
    return row


# -- phase 34: the DCGAN example's three-loss step under O1 -------------------

# examples/dcgan/main_amp.py at its defaults: nz 64, ngf 32, ndf 32, batch
# 32 of 32×32×3 NHWC images, --steps 50, --opt-level O1 (bf16), FusedAdam
# (2e-4, (0.5, 0.999)) for G and D, three loss scalers
DCGAN_BATCH, DCGAN_WARM, DCGAN_STEPS = 32, 3, 50
# launches a step: one unscale per loss, one Adam update per model
DCGAN_PER_STEP = {"scale": 3, "adam": 2}
DCGAN_FAMILIES = (
    ("training kernels", ("scale_kernel",)),
    ("Adam", ("adam_kernel",)),
    ("convolution", ("conv", "xmma", "cutlass", "dgrad", "wgrad", "cudnn",
                     "implicit", "sm90")),
    ("GEMMs", ("gemm", "nvjet", "cublas")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where",
                     "copy", "fill", "clamp", "cat", "index", "upsample",
                     "nearest")),
)


def dcgan_data(torch, n: int, nz: int) -> list:
    """The example's data stream (main_amp.py:229-235): ``n`` batches of
    RandomState(0) normal reals (× 0.5) and latents, made in bulk and
    moved to the card before any step."""
    import numpy as np
    rs = np.random.RandomState(0)
    host = []
    for _ in range(n):
        real = (rs.randn(DCGAN_BATCH, 32, 32, 3) * 0.5).astype(np.float32)
        z = rs.randn(DCGAN_BATCH, nz).astype(np.float32)
        host.append((real, z))
    return [(torch.from_numpy(r).cuda(), torch.from_numpy(z).cuda())
            for r, z in host]


def _grad_gap(a, b) -> dict:
    d = (a - b).abs()
    return {"mean": float(d.mean()), "max": float(d.max())}


def dcgan_phase(torch, dispatch) -> tuple:
    """``DCGANTrainer`` at the example's defaults under O1 bf16 from seeded
    inits (``DCGAN().g_init(1)``, ``d_init(2)``): 3 warm-up and 50 timed
    steps on the example's data stream (steps and images a second, step
    ms p50/p95), 3 and 2 launches a step of ``scale`` and Adam, then a
    profile (device time by family, the idle share); losses finite. Then,
    with cuDNN deterministic, 3 steps from the same masters and data with
    the kernels at O1 (twice: equal bit for bit) and O0, and with the
    plain versions at O1 and O0 (no kernel launched): step 1's unscaled D
    and G grads, O1 against O0, no farther apart with the kernels than
    1.5 times the plain versions' (bf16's own effect), in mean and max,
    and the kernel run's masters within 1.5 times bf16's own effect of the
    plain run's (phase 8's O2 bar); an inf in loss 1's grad at step 2 of a
    dynamic-scale run (the example's bf16 default is a static scale of 1,
    which never halves) leaves D's masters and slots bit for bit, halves
    scaler 1 alone, lets G update and is named by scaler 1's census; the
    final G grads' underflow census equals a recount on the host."""
    import numpy as np

    from apex_tpu_torch.models import DCGAN, bce_logits
    from apex_tpu_torch.prof import numerics as NU
    from apex_tpu_torch.train import DCGANTrainer

    model = DCGAN()
    gp, dp = model.g_init(1), model.d_init(2)
    data = dcgan_data(torch, DCGAN_WARM + DCGAN_STEPS, model.nz)
    tr = DCGANTrainer(model, gp, dp, opt_level="O1", numerics=True)
    it = iter(data)
    g_losses = []

    def step():
        d_l, g_l = tr.step(*next(it))
        g_losses.append(g_l)
        return d_l

    r = timed_steps(torch, step, DCGAN_WARM, DCGAN_STEPS)
    counts = r["counts"]
    prof = profile_steps(torch, lambda: tr.step(*data[-1]), DCGAN_FAMILIES,
                         n=5)
    step_s = statistics.median(r["step_ms"]) / 1e3
    row = {"phase": "dcgan_o1", "model": "DCGAN", "nz": model.nz,
           "ngf": model.ngf, "ndf": model.ndf, "batch": DCGAN_BATCH,
           "image": [32, 32, 3], "opt_level": "O1", "compute": "bfloat16",
           "optimizer": "2 x FusedAdam(2e-4, (0.5, 0.999))",
           "loss_scales": [s["loss_scale"] for s in (
               tr.handle.scalers[i].state_dict(tr.amp_state[i])
               for i in range(3))],
           **window_row(r, DCGAN_STEPS),
           "steps_per_s": DCGAN_STEPS / r["wall"],
           "images_per_s": DCGAN_BATCH * DCGAN_STEPS / r["wall"],
           "images_per_s_p50": DCGAN_BATCH / step_s,
           "g_loss_first": float(g_losses[0]),
           "g_loss_last": float(g_losses[-1]),
           "launches": {k: counts[k] for k in DCGAN_PER_STEP},
           "launches_per_step": {k: counts[k] / DCGAN_STEPS
                                 for k in DCGAN_PER_STEP},
           "profile": prof}
    loss = r["loss"] + [float(v) for v in g_losses]
    check(all(math.isfinite(v) for v in loss),
          f"dcgan_o1: non-finite loss {loss}")
    check_counts("dcgan_o1", counts,
                 {k: n * DCGAN_STEPS for k, n in DCGAN_PER_STEP.items()})

    # kernels against the plain versions, O1 against O0, 3 steps each
    torch.backends.cudnn.deterministic = True

    def run(level):
        t = DCGANTrainer(model, gp, dp, opt_level=level)
        grad1, losses = None, []
        for real, z in data[:3]:
            (fr, ff, fg), (d_l, g_l) = t.loss_and_grads(real, z)
            if grad1 is None:        # unscaled by the scale kernel (or not)
                grad1 = [t.handle.unscale(g, t.amp_state, i)[0]
                         for i, g in enumerate((fr, ff, fg))]
            t.apply_grads(fr, ff, fg)
            losses += [float(d_l), float(g_l)]
        return (t.d_opt.state[0], t.g_opt.state[0]), grad1, losses

    zero_counts()
    k1, kg1, kl1 = run("O1")
    k1b, _, kl1b = run("O1")
    k0, kg0, _ = run("O0")
    torch.cuda.synchronize()
    kernel_launches = {k: n for k, n in read_counts().items() if n}
    with dispatch.backend("reference"):
        zero_counts()
        p1, pg1, pl1 = run("O1")
        p0, pg0, _ = run("O0")
        torch.cuda.synchronize()
        plain_launches = read_counts()
    torch.backends.cudnn.deterministic = False
    grads = {name: {"kernels_O1_vs_O0": _grad_gap(a1, a0),
                    "bf16_own": _grad_gap(b1, b0)}
             for name, a1, a0, b1, b0 in zip(
                 ("d_real", "d_fake", "g"), kg1, kg0, pg1, pg0)}
    masters = {name: {"kernels_vs_plain": _grad_gap(a.master, b.master),
                      "bf16_own": _grad_gap(b.master, f.master)}
               for name, a, b, f in zip(("d", "g"), k1, p1, p0)}
    repeat = kl1 == kl1b and all(
        torch.equal(a.master, b.master) and all(
            torch.equal(a.slots[s], b.slots[s]) for s in a.slots)
        for a, b in zip(k1, k1b))

    # an inf in loss 1's gradient at step 2 of a dynamic-scale run
    t = DCGANTrainer(model, gp, dp, opt_level="O1", numerics=True,
                     loss_scale="dynamic")
    t.step(*data[0])
    d0, g0 = t.d_opt.state[0], t.g_opt.state[0]
    (fr, ff, fg), _ = t.loss_and_grads(*data[1])
    at = t.d_table.offsets[2] + 5
    ff[at] = float("inf")
    flags = [bool(f) for f in t.apply_grads(fr, ff, fg)]
    d1, g1 = t.d_opt.state[0], t.g_opt.state[0]
    scales = [t.handle.scalers[i].state_dict(t.amp_state[i])["loss_scale"]
              for i in range(3)]
    culprits = NU.culprit_table(t.d_meta, t.censuses[1])
    inject = {"flags": flags, "scales": scales,
              "d_master": bool(torch.equal(d1.master, d0.master)),
              "d_slots": all(bool(torch.equal(d1.slots[s], d0.slots[s]))
                             for s in d0.slots),
              "d_step": int(d1.step) == int(d0.step),
              "g_moved": not bool(torch.equal(g1.master, g0.master))
              and int(g1.step) == int(g0.step) + 1,
              "culprits": culprits, "injected_leaf": t.d_meta.paths[2]}

    # the final G grads' underflow census against a recount on the host
    z = data[-1][1]
    census = tr.g_underflow_census(z)
    g_m, _, gpt, dpt = tr.master_trees()
    (fgg,) = torch.autograd.grad(
        bce_logits(tr.d_fwd(dpt, tr.g_fwd(gpt, z)), 1.0), g_m)
    host = fgg.cpu().numpy()
    edges = np.asarray(NU.HIST_EDGES_LOG2, np.float32)
    recount = {"tiny_count": [], "ftz_count": [], "zero_count": []}
    hist = np.zeros(len(edges) + 1, np.int64)
    for off, size in zip(tr.g_table.offsets, tr.g_table.sizes):
        mag = np.abs(host[off:off + size])
        nz = mag > 0
        recount["tiny_count"].append(int((nz & (mag < NU.FP16_TINY)).sum()))
        recount["ftz_count"].append(int((nz & (mag < NU.FP16_FTZ)).sum()))
        recount["zero_count"].append(int((~nz).sum()))
        hist += np.bincount(np.searchsorted(
            edges, np.log2(mag[nz]), side="right"), minlength=len(hist))
    recount["hist"] = hist.tolist()
    got = {k: getattr(census, k).cpu().tolist() for k in recount}
    summary = NU.underflow_summary(NU.tree_meta(tr.g_table), census)

    row.update({"grad1": grads, "masters_3_steps": masters,
                "repeat_equal": repeat, "losses_kernels": kl1,
                "losses_plain": pl1, "kernel_launches": kernel_launches,
                "plain_launches": {k: n for k, n in plain_launches.items()
                                   if n},
                "inject_loss1": inject, "g_underflow": summary,
                "g_underflow_recount_equal": got == recount})
    emit(row)
    for name, g in grads.items():
        check(g["kernels_O1_vs_O0"]["mean"] <= 1.5 * g["bf16_own"]["mean"]
              and g["kernels_O1_vs_O0"]["max"] <= 1.5 * g["bf16_own"]["max"],
              f"dcgan_o1: step 1's {name} grads, O1 against O0, {g}")
    for name, m in masters.items():
        check(m["kernels_vs_plain"]["mean"] <= 1.5 * m["bf16_own"]["mean"]
              and m["kernels_vs_plain"]["max"] <= 1.5 * m["bf16_own"]["max"],
              f"dcgan_o1: {name}'s masters against the plain run's {m}")
    check(not any(plain_launches.values()),
          f"dcgan_o1: kernels launched in the plain runs {plain_launches}")
    # three kernel runs: step 1's three grads unscaled for the comparison,
    # then 3 steps of 3 unscales and 2 updates
    check(kernel_launches.get("scale") == 3 * (3 + 3 * 3)
          and kernel_launches.get("adam") == 3 * 3 * 2,
          f"dcgan_o1: the kernel runs launched {kernel_launches}")
    check(repeat, f"dcgan_o1: two kernel runs differ {kl1} vs {kl1b}")
    check(flags == [False, True, False] and scales == [65536.0, 32768.0,
                                                       65536.0]
          and inject["d_master"] and inject["d_slots"] and inject["d_step"]
          and inject["g_moved"] and len(culprits) == 1
          and culprits[0]["path"] == t.d_meta.paths[2]
          and culprits[0]["inf"] == 1,
          f"dcgan_o1: the inf in loss 1 was not handled {inject}")
    check(got == recount, f"dcgan_o1: underflow census {got} against the "
                          f"recount {recount}")
    return counts, row


# -- phase 35: lm_bench's LM with --remat, and remat under O1 -----------------

REMAT_RUNS = ("nothing_saveable", "dots_saveable")
# launches a step with every block rematerialized: each forward kernel
# inside the blocks twice a layer (the final LayerNorm, outside them, once);
# the backward kernels and Adam as phase 9's
REMAT_PER_STEP = {"flash_fwd": 16, "flash_bwd_dq": 8, "flash_bwd_dkv": 8,
                  "ln_fwd": 33, "ln_bwd": 17, "adam": 1}
# phase 10's small LM (2 layers, embed 128, 2 heads of 64, vocab 512, S 257,
# batch 2) under O1: the fp32 flash forms, none of the bf16 ones
O1_LM_FORMS = ("flash_f32_fwd", "flash_f32_dq", "flash_f32_dkv")
O1_LM_ABSENT = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                "flash_simt_fwd", "flash_simt_dq", "flash_simt_dkv")


def lm_remat_phase(torch, dispatch, params, peak9: int) -> tuple:
    """``tools/lm_bench.py --remat`` at phase 9's full width and batch,
    with ``--remat-policy nothing_saveable`` and ``dots_saveable``: step
    1's flat grad equal bit for bit to phase 9's one-batch grad from the
    same masters (the recompute runs the same kernels on the same inputs),
    3 warm-up and 10 timed steps read as phase 9's (tok/s, step ms, MFU by
    phase 9's FLOP model, which counts no recompute; peak memory below
    phase 9's), ``REMAT_PER_STEP`` launches a step, losses finite and
    falling. Then remat under O1 and in the other models:
    ``lm_remat_o1`` and ``remat_models``."""
    import dataclasses

    from apex_tpu_torch.train import LMTrainer

    c = LM_SHAPE
    warm, timed = 3, 10
    toks = lm_batch(torch)
    base = lm_model()
    g_one, _ = LMTrainer(base, params, lr=1e-4).loss_and_grad(toks)
    tokens = c["batch"] * c["seq"]
    all_counts, rows = {}, []
    for policy in REMAT_RUNS:
        model = dataclasses.replace(base, remat=True, remat_policy=policy)
        tr = LMTrainer(model, params, lr=1e-4)
        g_rem, _ = tr.loss_and_grad(toks)
        equal = bool(torch.equal(g_rem, g_one))
        gap = _grad_gap(g_rem, g_one)
        del g_rem
        r = timed_steps(torch, lambda: tr.step(toks), warm, timed)
        counts = r["counts"]
        flops = lm_step_flops(tr.table.total)
        prof = profile_steps(torch, lambda: tr.step(toks),
                             LM_KERNEL_FAMILIES, n=1)
        row = {"phase": "lm_train_remat", "model": "TransformerLM", **c,
               "remat": True, "remat_policy": policy, "dtype": "bfloat16",
               "masters": "float32", "optimizer": "FusedAdam(lr=1e-4)",
               **window_row(r, timed), "tokens_per_step": tokens,
               "tok_per_s": tokens * timed / r["wall"],
               "mfu": flops * timed / r["wall"] / BF16_DENSE_OPS_S,
               "peak_mem_bytes_phase9": peak9,
               "grad1_equal_phase9": equal, "grad1_gap": gap,
               "launches": {k: counts[k] for k in REMAT_PER_STEP},
               "launches_per_step": {k: counts[k] / timed
                                     for k in REMAT_PER_STEP},
               "profile": prof}
        emit(row)
        rows.append(row)
        check_losses(f"lm_train_remat {policy}", r["loss"])
        check_counts(f"lm_train_remat {policy}", counts,
                     {k: n * timed for k, n in REMAT_PER_STEP.items()})
        check(r["peak"] < peak9, f"lm_train_remat {policy}: peak memory "
                                 f"{r['peak']} is not below phase 9's {peak9}")
        check(equal, f"lm_train_remat {policy}: step 1's grad differs from "
                     f"phase 9's one-batch grad {gap}")
        for k, n in counts.items():
            all_counts[k] = all_counts.get(k, 0) + n
        del tr
    del g_one
    for k, n in lm_remat_o1_phase(torch, dispatch).items():
        all_counts[k] = all_counts.get(k, 0) + n
    remat_models_phase(torch)
    return all_counts, rows


def lm_remat_o1_phase(torch, dispatch) -> dict:
    """Phase 10's small LM with ``remat=True`` under ``amp.initialize(
    lm.loss, opt_level="O1")``, one loss and grad w.r.t. fp32 params from
    seeded init: the fp32 flash forms launched and the bf16 ones not, every
    LayerNorm given fp32 rows, fp32 grads; the kernels' O1 grads no farther
    from their O0 grads than 1.5 times the plain versions' O1 grads are
    from theirs (bf16's own effect), in mean and max. Returns the kernel
    run's launches."""
    import sys

    from apex_tpu_torch import amp
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.ops import flat

    m = TransformerLM(vocab_size=512, max_seq_len=256, embed_dim=128,
                      num_heads=2, num_layers=2, attn_impl="fast",
                      head_chunk=512, remat=True)
    params = m.init(torch.Generator().manual_seed(2))
    toks = torch.randint(0, 512, (2, 257), generator=torch.Generator()
                         .manual_seed(3)).cuda()
    o1, _ = amp.initialize(m.loss, opt_level="O1", verbosity=0)
    ln_mod = sys.modules["apex_tpu_torch.normalization.fused_layer_norm"]
    ln_fwd, ln_dtypes = ln_mod.ln_fwd, set()

    def spy(x, *a, **k):
        ln_dtypes.add(str(x.dtype))
        return ln_fwd(x, *a, **k)

    def grads(fn):
        p = flat.tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = fn(p, toks)
        return loss, torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            loss, flat.tree_leaves(p))])

    zero_counts()
    ln_mod.ln_fwd = spy
    try:
        loss1, k1 = grads(o1)
    finally:
        ln_mod.ln_fwd = ln_fwd
    torch.cuda.synchronize()
    launches = read_counts()
    _, k0 = grads(m.loss)
    with dispatch.backend("reference"):
        _, p1 = grads(o1)
        _, p0 = grads(m.loss)
    gap, own = _grad_gap(k1, k0), _grad_gap(p1, p0)
    row = {"phase": "lm_remat_o1", "layers": 2, "embed": 128, "heads": 2,
           "seq": 256, "batch": 2, "remat": True, "opt_level": "O1",
           "loss": float(loss1.detach()), "grad_dtype": str(k1.dtype),
           "ln_input_dtypes": sorted(ln_dtypes),
           "grad_kernels_O1_vs_O0": gap, "grad_bf16_own": own,
           "launches": {k: n for k, n in launches.items() if n}}
    emit(row)
    check(all(launches[k] > 0 for k in O1_LM_FORMS)
          and not any(launches[k] for k in O1_LM_ABSENT),
          f"lm_remat_o1: launches {row['launches']}")
    check(launches["ln_fwd"] > 0 and launches["ln_bwd"] > 0
          and ln_dtypes == {"torch.float32"},
          f"lm_remat_o1: LayerNorm launches {row['launches']}, inputs "
          f"{ln_dtypes}")
    check(k1.dtype == torch.float32 and math.isfinite(row["loss"]),
          f"lm_remat_o1: grads {k1.dtype}, loss {row['loss']}")
    check(gap["mean"] <= 1.5 * own["mean"] and gap["max"] <= 1.5 * own["max"],
          f"lm_remat_o1: O1 grads against O0 {gap}, bf16's own {own}")
    return {k: launches[k] for k in O1_LM_FORMS + ("ln_fwd", "ln_bwd")}


def remat_models_phase(torch) -> None:
    """A small ViT (phase 21's) and a small Seq2Seq Transformer (phase
    16's), one O2 loss and grad from the same masters without remat and
    with ``nothing_saveable`` and ``dots_saveable``: the flat grads equal
    bit for bit."""
    import dataclasses

    import numpy as np

    from apex_tpu_torch.models import Seq2SeqTransformer, ViT
    from apex_tpu_torch.train import LMTrainer, Trainer

    vit = ViT(num_classes=10, image_size=64, patch_size=8, embed_dim=256,
              num_heads=4, num_layers=2, dropout=VIT["dropout"],
              attn_impl="fast")
    vp = vit.init(torch.Generator().manual_seed(3))
    x, y = imagenet_batch(torch, 8, 64, 10)
    s2s = Seq2SeqTransformer(**dict(
        S2S, src_vocab_size=1000, tgt_vocab_size=1000, max_seq_len=128,
        embed_dim=256, num_heads=4, num_encoder_layers=2,
        num_decoder_layers=2))
    sp = s2s.init(torch.Generator().manual_seed(2))
    src, tgt = s2s_batch(torch, np.random.RandomState(3), 8, 64, 1000)

    def vit_grad(model):
        tr = Trainer(model, vp, opt_level="O2", optimizer="sgd")
        return tr.loss_and_grad(x, y, dropout_seeds=[5, 6])[0]

    def s2s_grad(model):
        tr = LMTrainer(model, sp, **S2S_ADAM)
        return tr.loss_and_grad(src, tgt, label_smoothing=S2S_SMOOTHING)[0]

    out = {}
    for name, model, grad in (("vit", vit, vit_grad),
                              ("seq2seq", s2s, s2s_grad)):
        want = grad(model)
        out[name] = {p: bool(torch.equal(grad(dataclasses.replace(
            model, remat=True, remat_policy=p)), want)) for p in REMAT_RUNS}
    emit({"phase": "remat_models", "grads_equal_without_remat": out})
    check(all(all(v.values()) for v in out.values()),
          f"remat_models: grads with remat differ {out}")


# -- phase 2: the multi-row decode form; phases 36-38 -----------------------

SPEC_K = 3
# phase 2's multi-row reading: the (k+1)-row scoring at k 3, rows at
# lengths pos .. pos + 3 around 900
ROW_BASES = [897, 900, 903, 880, 910, 899, 901, 905]


def decode_rows_phase(torch, timer) -> dict:
    """The multi-row decode form (speculative scoring:
    ``decode_attention_rows``, ``paged_decode_attention_rows``) at S 8, Q 4, H
    8, hd 128, L 1024, row lengths pos .. pos + 3 around 900, dense and paged
    (page 32), bf16 and fp32, and at hd 64 (16 heads): the decode rule against
    the plain version, each row bit-equal to a 1-query call at its length,
    paged equal to dense, two runs equal; the time against the bound (K/V bytes
    once for each slot's longest row, q, out), the JAX package's layout
    beside it (rows flattened into the slot axis over K/V expanded per row
    or the page table repeated; and Q one-row calls) and masked SDPA with
    an [S, 1, Q, L] boolean mask."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import decode_attn as DA

    gen = torch.Generator(device="cuda").manual_seed(36)
    rows = {}
    S, Q, L, PAGE = 8, SPEC_K + 1, 1024, 32
    lengths = torch.tensor([[b + j for j in range(Q)] for b in ROW_BASES],
                           dtype=torch.int32, device="cuda")
    nmax = lengths.amax(dim=1).tolist()
    flat_len = lengths.reshape(-1).contiguous()
    for hd, H, dt, reading in ((128, 8, torch.bfloat16, "bfloat16"),
                               (128, 8, torch.float32, "float32"),
                               (64, LM_SERVE_HEADS, torch.bfloat16, "hd64")):
        name = str(dt).split(".")[1]
        es = torch.tensor([], dtype=dt).element_size()
        q = torch.randn(S, Q, H, hd, generator=gen, device="cuda").to(dt)
        k = torch.randn(S, H, L, hd, generator=gen, device="cuda").to(dt)
        v = torch.randn(S, H, L, hd, generator=gen, device="cuda").to(dt)
        got = DA.decode_attention_rows(q, k, v, lengths)
        want = DA.decode_attention_plain(q, k, v, lengths)
        torch.cuda.synchronize()
        err, ok = max_err(got, want, name)
        check(ok, f"decode_attention_rows {reading}: max abs err {err}")
        rep = bool(torch.equal(DA.decode_attention_rows(q, k, v, lengths),
                               got))
        check(rep, f"decode_attention_rows {reading}: two runs differ")
        qj = [q[:, j].contiguous() for j in range(Q)]
        lj = [lengths[:, j].contiguous() for j in range(Q)]
        one = [DA.decode_attention(qj[j], k, v, lj[j]) for j in range(Q)]
        check(all(torch.equal(got[:, j], one[j]) for j in range(Q)),
              f"decode_attention_rows {reading}: a row differs from the "
              f"1-query call at its length")
        kp, vp, table, pages = paged_copy(torch, gen, k, v, nmax, PAGE)
        got_p = DA.paged_decode_attention_rows(q, kp, vp, lengths,
                                               page_table=table)
        check(torch.equal(got_p, got),
              f"paged_decode_attention_rows {reading} differs from dense")
        # the JAX package's layout: the rows flattened into the slot axis
        qf = q.reshape(S * Q, H, hd)
        kx = k[:, None].expand(S, Q, H, L, hd).reshape(S * Q, H, L, hd)
        vx = v[:, None].expand(S, Q, H, L, hd).reshape(S * Q, H, L, hd)
        tx = table.repeat_interleave(Q, dim=0)
        check(torch.equal(DA.decode_attention(qf, kx, vx, flat_len),
                          got.reshape(S * Q, H, hd)),
              f"decode_attention_rows {reading}: the flattened layout "
              f"differs")
        mask = (torch.arange(L, device="cuda")[None, None, None, :]
                < lengths[:, None, :, None])                 # [S, 1, Q, L]
        kv_bytes = sum(2 * n * H * hd * es for n in nmax)
        io = 2 * S * Q * H * hd * es + 4 * S * Q
        ops = sum(n * H * (4 * hd + 5) for n in lengths.reshape(-1).tolist())
        for kern, call, plain, lib, flat, singles, extra in (
                ("decode_attention_rows",
                 lambda: DA.decode_attention_rows(q, k, v, lengths),
                 lambda: DA.decode_attention_plain(q, k, v, lengths),
                 lambda: F.scaled_dot_product_attention(
                     q.transpose(1, 2), k, v, attn_mask=mask),
                 lambda: DA.decode_attention(qf, kx, vx, flat_len),
                 lambda: [DA.decode_attention(qj[j], k, v, lj[j])
                          for j in range(Q)], 0),
                ("paged_decode_attention_rows",
                 lambda: DA.paged_decode_attention_rows(
                     q, kp, vp, lengths, page_table=table),
                 lambda: DA.paged_decode_attention_plain(
                     q, kp, vp, lengths, page_table=table), None,
                 lambda: DA.paged_decode_attention(qf, kp, vp, flat_len,
                                                   page_table=tx),
                 lambda: [DA.paged_decode_attention(qj[j], kp, vp, lj[j],
                                                    page_table=table)
                          for j in range(Q)], 4 * pages)):
            bb = bound(kv_bytes + io + extra, ops)
            row = dict(kernel=kern, reading=reading, dtype=name,
                       shape=[S, Q, H, L, hd], lengths=lengths.tolist(),
                       max_abs_err=err, tol=TOL[name], repeat_equal=rep,
                       rows_equal_one_query=True, paged_equal=True,
                       ms=timer(call), plain_ms=timer(plain),
                       library_ms=timer(lib) if lib else None,
                       bound_ms=bb[0], bound_by=bb[1],
                       flattened_ms=timer(flat),
                       one_row_calls_ms=timer(singles),
                       host_us=host_us(torch, call),
                       nvidia_smi=nvidia_smi("name,power.limit"))
            if lib is not None:
                # the expansion the flattened layout needs, with the call
                row["flattened_expand_ms"] = timer(
                    lambda: DA.decode_attention(
                        qf, k[:, None].expand(S, Q, H, L, hd).reshape(
                            S * Q, H, L, hd),
                        v[:, None].expand(S, Q, H, L, hd).reshape(
                            S * Q, H, L, hd), flat_len))
            emit({"phase": "kernels", **row})
            rows[(kern, reading)] = row
        del k, v, kp, vp, kx, vx
    return rows


def _stream_equal(a, b) -> bool:
    return [r.tokens for r in a] == [r.tokens for r in b]


def row_invariance(torch, params, s: int, q_rows: int) -> dict:
    """Whether one layer's fp32 products give each of the first ``s`` rows
    the same bits at M = s and at M = s * q_rows (cuBLAS picks its kernel,
    and with it the order of the sums, by the shape)."""
    lp = params["layer_0"]
    g = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for name, w in (("in_proj", lp["attn"]["in_proj"]),
                    ("out_proj", lp["attn"]["out_proj"]),
                    ("mlp_w1", lp["mlp"]["w1"]), ("mlp_w2", lp["mlp"]["w2"]),
                    ("head", params["tok_emb"].T)):
        x = torch.randn(s * q_rows, w.shape[0], generator=g, device="cuda",
                        dtype=w.dtype)
        out[name] = bool(torch.equal((x @ w)[:s], x[:s] @ w))
    return out


def serve_spec_phase(torch, model, params, reqs, base: dict) -> tuple:
    """Phase 36: phase 3's model and traffic with ``spec_k=3`` and
    ``draft_from_prefix(model, params, 4)`` (serve_bench's half depth),
    dense and on phase 4's pages: the multi-row kernel in every step,
    paged streams equal to dense, the readings beside phase 3's (``base``).
    Then the fp32 parity gate on the same widths with 16 of the requests:
    speculative greedy streams equal plain greedy, dense and paged; the
    self-draft's acceptance exactly k; a run at temperature 0.9 replays its
    tokens and histogram; and ``row_invariant``."""
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.serve import (ContinuousBatchingEngine,
                                      draft_from_prefix, summarize_serving)

    draft = draft_from_prefix(model, params, model.num_layers // 2)
    dl = draft[0].num_layers
    spec = dict(spec_k=SPEC_K, draft=draft)
    dense, dstats, dcounts = serve_phase(torch, "serve_spec_dense", model,
                                         params, reqs, graphs="spec_dense",
                                         **spec)
    steps = dstats["decode_steps"]
    # per step: the target's (k+1) rows in each layer, the draft's 2-row
    # catch-up in each of its layers, then k-1 one-row draft steps
    check(dcounts["decode_attention_rows"] == (model.num_layers + dl) * steps
          and dcounts["decode_attention"] == dl * (SPEC_K - 1) * steps
          and dcounts["paged_decode_attention_rows"] == 0,
          f"serve_spec_dense: launches {dcounts} for {steps} steps")
    paged, pstats, pcounts = serve_phase(
        torch, "serve_spec_paged", model, params, reqs, graphs="spec_paged",
        paged=True, page_size=32, kv_pages=8 * (1024 // 32) // 2, **spec)
    psteps = pstats["decode_steps"]
    check(pcounts["paged_decode_attention_rows"]
          == (model.num_layers + dl) * psteps
          and pcounts["decode_attention_rows"] == 0,
          f"serve_spec_paged: launches {pcounts} for {psteps} steps")
    same = _stream_equal(paged, dense)
    d = summarize_serving(dense, dstats, offered_rps=8.0)
    row = {"phase": "serve_spec", "spec_k": SPEC_K, "draft_layers": dl,
           "paged_equals_dense": same,
           "accept_mean": {"dense": d["spec_accept_mean"],
                           "paged": pstats["spec_accept_mean"]},
           "accept_hist": {"dense": d["spec_accept_hist"],
                           "paged": pstats["spec_accept_hist"]},
           "multi_row_launches": {
               "dense": dcounts["decode_attention_rows"],
               "paged": pcounts["paged_decode_attention_rows"]}}
    for key in ("tokens_per_s", "decode_step_ms", "ttft_ms", "token_lat_ms"):
        row[key] = {"spec": d[key], "phase_3": base[key]}
    emit(row)
    check(same, "serve_spec: paged spec streams differ from dense")

    # the fp32 parity gate
    m32 = TransformerLM(vocab_size=32768, max_seq_len=1024, embed_dim=1024,
                        num_heads=8, num_layers=8)
    p32 = m32.init(torch.Generator().manual_seed(0))
    d32 = draft_from_prefix(m32, p32, m32.num_layers // 2)
    r16 = reqs[:16]
    kw = dict(slots=8, max_len=1024, prefill_chunk=32)
    pages = dict(paged=True, page_size=32, kv_pages=8 * (1024 // 32) // 2)
    plain_eng = ContinuousBatchingEngine(m32, p32, **kw)
    warm_engine(torch, plain_eng)
    plain, plain_stats = plain_eng.run(r16)
    # phase 39's serialized engine (fused=False): its greedy streams are
    # the fused engine's
    serial_eng = ContinuousBatchingEngine(m32, p32, fused=False, **kw)
    serial_warm = warm_engine(torch, serial_eng)
    serial, serial_stats = serial_eng.run(r16)
    srow = {"phase": "serve_graphs", "config": "serial_fp32",
            "requests": len(r16), **serial_warm,
            "captures_after_warmup": captures_since(serial_eng, serial_warm),
            "streams_equal_fused": _stream_equal(serial, plain),
            "prefill_batch_sizes": serial_stats["prefill_batch_sizes"],
            "fused": serial_stats["fused"]}
    for key in ("decode_step_ms", "ttft_ms", "tokens_per_s"):
        srow[key] = {
            "serial": summarize_serving(serial, serial_stats,
                                        offered_rps=8.0)[key],
            "fused": summarize_serving(plain, plain_stats,
                                       offered_rps=8.0)[key]}
    emit(srow)
    check(srow["streams_equal_fused"] and not srow["fused"]
          and set(srow["prefill_batch_sizes"]) == {1},
          "serve_graphs serial_fp32: serialized streams differ from fused")
    check(srow["captures_after_warmup"] == 0,
          "serve_graphs serial_fp32: captures after warmup")
    del serial_eng, plain_eng
    sd, sds = ContinuousBatchingEngine(m32, p32, spec_k=SPEC_K, draft=d32,
                                       **kw).run(r16)
    sp, _ = ContinuousBatchingEngine(m32, p32, spec_k=SPEC_K, draft=d32,
                                     **kw, **pages).run(r16)
    _, self_stats = ContinuousBatchingEngine(
        m32, p32, spec_k=SPEC_K, draft=(m32, p32), **kw).run(r16)
    hot = ContinuousBatchingEngine(m32, p32, spec_k=SPEC_K, draft=d32,
                                   temperature=0.9, seed=0, **kw)
    a, sa = hot.run(r16)
    b, sb = hot.run(r16)
    gate = {"phase": "serve_spec_parity", "dtype": "float32",
            "requests": len(r16),
            "dense_equals_plain": _stream_equal(sd, plain),
            "paged_equals_plain": _stream_equal(sp, plain),
            "first_difference": next(
                (i for i, (x, y) in enumerate(zip(sd, plain))
                 if x.tokens != y.tokens), None),
            "accept_mean": sds["spec_accept_mean"],
            "self_draft_accept_mean": self_stats["spec_accept_mean"],
            "self_draft_hist": self_stats["spec_accept_hist"],
            "temperature_replays": _stream_equal(a, b)
            and sa["spec_accept_hist"] == sb["spec_accept_hist"],
            "temperature_hist": sa["spec_accept_hist"],
            "temperature_differs_from_greedy": not _stream_equal(a, sd),
            "row_invariant": row_invariance(torch, p32, 8, SPEC_K + 1)}
    emit(gate)
    check(gate["dense_equals_plain"] and gate["paged_equals_plain"],
          "serve_spec_parity: fp32 speculative greedy streams differ from "
          "plain greedy")
    check(gate["self_draft_accept_mean"] == float(SPEC_K),
          f"serve_spec_parity: self-draft acceptance "
          f"{gate['self_draft_accept_mean']}, not {SPEC_K}")
    check(gate["temperature_replays"],
          "serve_spec_parity: the temperature run does not replay")
    del m32, p32, d32
    return dcounts, pcounts


def serve_prefix_phase(torch, model, params, reqs) -> dict:
    """Phase 37: phase 4's paged engine with ``prefix_share=True`` over the
    same requests, each behind one seeded 256-token system prompt
    (serve_bench's ``--system-prompt-len`` shape: 8 pages of 32): streams
    equal to a no-share paged run and a dense run, fewer prefill chunks,
    hits, every page given back but the cache's own holds; TTFT of the hit
    requests against the same requests without sharing."""
    import dataclasses

    import numpy as np

    from apex_tpu_torch.serve import (ContinuousBatchingEngine,
                                      summarize_serving)

    sys_prompt = np.random.RandomState(37).randint(
        0, model.vocab_size, 256).astype(np.int32)
    sreqs = [dataclasses.replace(r, prompt=np.concatenate(
        [sys_prompt, np.asarray(r.prompt, np.int32)])) for r in reqs]
    kw = dict(slots=8, max_len=1024, prefill_chunk=32)
    pages = dict(paged=True, page_size=32, kv_pages=8 * (1024 // 32) // 2)
    dense_eng = ContinuousBatchingEngine(model, params, **kw)
    noshare_eng = ContinuousBatchingEngine(model, params, **kw, **pages)
    share_eng = ContinuousBatchingEngine(model, params, prefix_share=True,
                                         **kw, **pages)
    warm_engine(torch, dense_eng)
    warm_engine(torch, noshare_eng)
    share_warm = warm_engine(torch, share_eng)
    zero_counts()
    dense, _ = dense_eng.run(sreqs)
    noshare, nss = noshare_eng.run(sreqs)
    share, ss = share_eng.run(sreqs)
    torch.cuda.synchronize()
    counts = read_counts()
    hit = [r.id for r in share if r.prefix_tokens > 0]

    def ttft(results):
        vals = sorted(r.ttft_s * 1e3 for r in results if r.id in hit)
        return {"p50": statistics.median(vals),
                "p95": vals[min(len(vals) - 1,
                                int(math.ceil(0.95 * len(vals))) - 1)]}

    cached = share_eng._prefix_cache.pages
    released = (ss["kv_pages_free"] + len(cached) == pages["kv_pages"]
                and all(share_eng._page_pool.ref(p) == 1 for p in cached)
                and not share_eng._page_table.any())
    summary = summarize_serving(share, ss, offered_rps=8.0)
    row = {"phase": "serve_prefix", "system_prompt": 256,
           "requests": len(sreqs), "share_equals_noshare":
           _stream_equal(share, noshare),
           "share_equals_dense": _stream_equal(share, dense),
           "prefill_chunks": {"share": ss["prefill_chunks"],
                              "noshare": nss["prefill_chunks"]},
           "prefix_hits": ss["prefix_hits"], "hit_requests": len(hit),
           "prefix_entries": ss["prefix_entries"],
           "prefix_evictions": ss["prefix_evictions"],
           "pages_released": released,
           "kv_pages_free": ss["kv_pages_free"],
           "hit_ttft_ms": {"share": ttft(share) if hit else None,
                           "noshare": ttft(noshare) if hit else None},
           "ttft_ms": {"share": summary["ttft_ms"],
                       "noshare": summarize_serving(
                           noshare, nss, offered_rps=8.0)["ttft_ms"]},
           "tokens_per_s": summary["tokens_per_s"], "launches": counts}
    emit(row)
    check(row["share_equals_noshare"] and row["share_equals_dense"],
          "serve_prefix: shared-prefix streams differ")
    check(ss["prefill_chunks"] < nss["prefill_chunks"]
          and ss["prefix_hits"] > 0 and hit,
          "serve_prefix: no prefill chunk saved or no hit")
    check(released, "serve_prefix: pages held past the cache's own holds")
    del dense_eng, noshare_eng
    graph = (share, ss, counts, None,
             profile_steps(torch, lambda: share_eng.run(at_once(sreqs[:8])),
                           SERVE_FAMILIES, n=1))
    graphs_row(torch, "prefix_share", share_eng, sreqs, share_warm, graph)
    return counts


def generate_mlp_phase(torch, model, params) -> None:
    """Phase 38: sampled ``generate`` on phase 3's model (batch 8, prompt
    64, 64 new tokens, temperature 0.8, top-k 50, top-p 0.9): tokens
    replay under the same key, each sampled token lies in its step's
    filtered set (the step's logits by a replay of the same calls, the set
    by ``_filter_logits`` on the CPU), ``top_k=1`` equals greedy on the
    same weights in fp32 (top-k keeps ties at the k-th value, and bf16
    logits tie at the largest: the rows that do are counted). Then
    ``MLP([480, 1024, 1024, 512, 256, 1])`` forward and backward at batch
    1024 on the card against an fp64 CPU run of the same params, relu and
    sigmoid."""
    from apex_tpu_torch.mlp import MLP

    g = torch.Generator().manual_seed(38)
    prompt = torch.randint(0, model.vocab_size, (8, 64), generator=g).to(
        "cuda", torch.int32)
    kw = dict(max_new_tokens=64, temperature=0.8, top_k=50, top_p=0.9,
              key=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = model.generate(params, prompt, **kw)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    b = model.generate(params, prompt, **kw)
    greedy = model.generate(params, prompt, max_new_tokens=64)
    hid, caches = model._prefill(params, prompt, 128)
    outside, kept, ties = 0, [], 0
    for t in range(63, 127):
        if t > 63:
            hid, caches = model._decode_one(params, a[:, t], t, caches)
        logits = (hid @ params["tok_emb"].T).float().cpu()
        filt = type(model)._filter_logits(logits / 0.8, 50, 0.9)
        tok = a[:, t + 1].cpu().long()
        outside += int((~torch.isfinite(filt.gather(1, tok[:, None]))).sum())
        kept.extend(torch.isfinite(filt).sum(dim=1).tolist())
        top2 = logits.topk(2, dim=1).values
        ties += int((top2[:, 0] == top2[:, 1]).sum())
    # top_k=1 keeps every token tied at the largest logit (the JAX filter's
    # logits >= k-th); bf16 logits tie there often (ties above: the rows
    # whose two largest are equal), so greedy is pinned on the same
    # weights in fp32
    from apex_tpu_torch.ops import flat
    p32 = flat.tree_map(lambda t: t.float(), params)
    top1 = model.generate(p32, prompt, max_new_tokens=64, temperature=0.8,
                          top_k=1, key=0)
    greedy32 = model.generate(p32, prompt, max_new_tokens=64)
    row = {"phase": "generate_sampling", "batch": 8, "prompt": 64,
           "new_tokens": 64, "temperature": 0.8, "top_k": 50, "top_p": 0.9,
           "seconds": gen_s, "tokens_per_s": 8 * 64 / gen_s,
           "replays": bool(torch.equal(a, b)),
           "outside_filtered_set": outside,
           "filtered_set_size": {"min": min(kept), "max": max(kept),
                                 "mean": sum(kept) / len(kept)},
           "bf16_rows_tied_at_the_max": ties,
           "top_k_1_equals_greedy_fp32": bool(torch.equal(top1, greedy32)),
           "differs_from_greedy": not bool(torch.equal(a, greedy))}
    emit(row)
    check(row["replays"] and outside == 0
          and row["top_k_1_equals_greedy_fp32"]
          and row["differs_from_greedy"], f"generate_sampling: {row}")
    del p32

    sizes = [480, 1024, 1024, 512, 256, 1]
    x = torch.randn(1024, sizes[0], generator=g)
    w = torch.randn(1024, 1, generator=g)

    def run(m, params, x, w):
        leaves = {n: t.clone().requires_grad_(True) for n, t in
                  params.items()}
        xr = x.clone().requires_grad_(True)
        y = m.apply(leaves, xr)
        (y * w).sum().backward()
        return y.detach(), {n: t.grad for n, t in leaves.items()}, xr.grad

    def rel(got, want):
        d = got.double().cpu() - want
        return (float(d.norm() / want.norm().clamp_min(1e-30)),
                float(d.abs().max() / want.abs().max().clamp_min(1e-30)))

    # relu (the default) against fp64 by the error's norm over the value's:
    # a pre-activation within fp32's rounding of 0 passes its gradient in
    # one run and not in the other, which moves single elements by one
    # sample's share (up to 1.6e-4 of the largest on an H100 at 700 W);
    # sigmoid, smooth, element by element
    row = {"phase": "mlp", "sizes": sizes, "batch": 1024, "dtype": "float32",
           "nvidia_smi": nvidia_smi("name,power.limit")}
    for act, tol, which in (("relu", 1e-4, 0), ("sigmoid", 1e-5, 1)):
        m = MLP(sizes, activation=act)
        p = m.init(torch.Generator().manual_seed(38))
        xc, wc = x.cuda(), w.cuda()
        y, gp, gx = run(m, p, xc, wc)
        y64, gp64, gx64 = run(m, {n: t.double().cpu() for n, t in p.items()},
                              x.double(), w.double())
        errs = {"y": rel(y, y64), "dx": rel(gx, gx64),
                **{f"d{n}": rel(gp[n], gp64[n]) for n in gp}}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(10):
            run(m, p, xc, wc)
        ev[1].record()
        torch.cuda.synchronize()
        row[act] = {"rel_l2_err": {k: e[0] for k, e in errs.items()},
                    "rel_max_err": {k: e[1] for k, e in errs.items()},
                    "held": ("rel_l2_err", "rel_max_err")[which],
                    "tol": tol,
                    "fwd_bwd_ms": ev[0].elapsed_time(ev[1]) / 10}
        row[act]["ok"] = all(e[which] <= tol for e in errs.values())
    emit(row)
    check(row["relu"]["ok"] and row["sigmoid"]["ok"], f"mlp: {row}")


# -- phase 41: the router tier ------------------------------------------------

ROUTER_DIR_ENV = "APEX_ROUTER_SMOKE_DIR"


def serve_model(torch):
    """serve_bench's model (phase 3): 8 layers of 1024, 8 heads, vocab
    32768, bf16, random weights from seed 0."""
    from apex_tpu_torch.models import TransformerLM
    model = TransformerLM(vocab_size=32768, max_seq_len=1024,
                          embed_dim=1024, num_heads=8, num_layers=8)
    params = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16)
    return model, params


def serve_engine(model, params):
    from apex_tpu_torch.serve import ContinuousBatchingEngine
    return ContinuousBatchingEngine(model, params, slots=8, max_len=1024,
                                    prefill_chunk=32)


def router_requests() -> list:
    """serve_bench's default router traffic: 64 Poisson requests at 8/s,
    prompts uniform 16-96, outputs uniform 8-48, seed 0."""
    from apex_tpu_torch.serve import poisson_requests
    return poisson_requests(64, rate=8.0, prompt_dist="uniform:16,96",
                            new_dist="uniform:8,48", vocab_size=32768,
                            seed=0, max_len=1024, prefill_chunk=32)


def _union_ms(spans) -> float:
    """Length of the union of ``(start, end)`` intervals (µs), in ms."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def _device_spans(torch, prof) -> list:
    """Every device activity (kernels, copies, sets) a profile saw, as
    ``(start µs, end µs, name)``."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    try:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
            else:
                s, d = float(e.start_us()), float(e.duration_us())
            out.append((s, s + d, e.name()))
    except AttributeError:
        out = [(e.time_range.start, e.time_range.end, e.name)
               for e in prof.events() if e.device_type == cuda]
    return out


def device_activity(torch, fn) -> tuple:
    """``fn()`` under ``torch.profiler`` tracing the card only (CUPTI; no
    host events, so the host loop is not slowed): its result, and the
    device's busy time as the union of every activity's interval (streams
    of concurrent replicas overlap), their sum, the idle share of the
    wall time, and the time by kernel family."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = _device_spans(torch, prof)
    busy = _union_ms([(s, e) for s, e, _ in spans])
    fam = {}
    for s, e, name in spans:
        f = _family(name, SERVE_FAMILIES)
        fam[f] = fam.get(f, 0.0) + (e - s) / 1e3
    return out, {"wall_ms": wall_ms, "device_busy_ms": busy,
                 "device_sum_ms": sum(fam.values()),
                 "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
                 "by_family_ms": dict(sorted(fam.items(),
                                             key=lambda kv: -kv[1]))}


def _decode_tokens(results) -> int:
    return sum(max(len(r.tokens) - 1, 0) for r in results)


def fleet_run(torch, engines, reqs, *, admission=None,
              emitters=None) -> dict:
    """One router run: ``EngineReplica`` s over ``engines`` (each on its
    own stream, after ``warmup()``), ``Router.run`` over ``reqs`` under
    least-queue, then ``merge_router_run`` and ``summarize_serving``, the
    launch counts zeroed just before and read just after."""
    import threading

    from apex_tpu_torch.serve import (EngineReplica, Router,
                                      merge_router_run, summarize_serving)
    replicas = [EngineReplica(e, i, emitter=emitters[i] if emitters else
                              None) for i, e in enumerate(engines)]
    router = Router(replicas, policy="least-queue", admission=admission)
    caps = [sum(p.captures for p in e.programs.values()) for e in engines]
    replays = [{n: p.replays for n, p in e.programs.items()}
               for e in engines]
    mu, last = threading.Lock(), [None]

    def completer(i):
        def on_retire(res):
            router.on_complete(i, res.id)
            with mu:
                last[0] = time.perf_counter()
        return on_retire

    zero_counts()
    t0 = time.perf_counter()
    for rep in replicas:
        rep.start(t0, on_retire=completer(rep.index))
    shed = router.run(reqs, t0=t0)
    router.close()
    for rep in replicas:
        rep.join(300.0)
    torch.cuda.synchronize()
    counts = read_counts()
    check(not any(rep._thread.is_alive() for rep in replicas),
          "serve_router: a replica thread did not end")
    results, merged = merge_router_run(   # re-raises a replica's error
        replicas, shed, duration_s=max(
            [router.duration_s] + [r.stats["duration_s"] for r in replicas
                                   if r.stats]))
    fns = counters()
    return {"replicas": replicas, "summary": summarize_serving(
        results, merged, offered_rps=8.0, shed=shed),
        "router": router.summary(), "shed": shed, "results": results,
        "wall_s": (last[0] - t0) if last[0] is not None else None,
        "counts": counts, "want": {name: sum(
            (p.replays - replays[i][pn]) * p.launches.get(fn.__name__, 0)
            for i, e in enumerate(engines)
            for pn, p in e.programs.items()) for name, fn in fns.items()},
        "captures": [sum(p.captures for p in e.programs.values()) - c
                     for e, c in zip(engines, caps)]}


def check_fleet_run(arm, run, reqs, ref, shed_all) -> None:
    """Nothing lost (every request completes, or with ``shed_all`` is shed
    with its rule and replica), every stream equal to ``ref`` (the plain
    engine's), no capture, and each wrapper's launches equal to the
    replicas' replays × each program's launches a replay."""
    summary, rs = run["summary"], run["router"]
    done = [r for r in run["results"] if r.finish_s is not None]
    same = [r.tokens == ref[r.id] for r in done]
    check(summary["dropped"] == 0,
          f"serve_router {arm}: {summary['dropped']} request(s) lost")
    if shed_all:
        check(summary["shed"] == len(reqs) and not done,
              f"serve_router {arm}: {summary['shed']} of {len(reqs)} shed")
    else:
        check(summary["completed"] == len(reqs) and rs["completed"]
              == len(reqs), f"serve_router {arm}: {summary['completed']} "
              f"of {len(reqs)} completed")
        check(all(same), f"serve_router {arm}: {len(same) - sum(same)} "
              f"streams differ from the plain engine's")
    check(not any(run["captures"]),
          f"serve_router {arm}: captures after warmup {run['captures']}")
    check(run["counts"] == run["want"], f"serve_router {arm}: launches "
          f"{run['counts']} != replays x launches a replay {run['want']}")


def fleet_arm(torch, arm, engines, reqs, ref, card, *, admission=None,
              emitters=None, shed_all=False, profile=True) -> tuple:
    """One arm of phase 41: :func:`fleet_run` for its numbers, then (with
    ``profile``) the same run again with the card traced for its busy and
    idle share; both runs are checked (:func:`check_fleet_run`). Returns
    the row, the launches of both runs and the shed rows."""
    run = fleet_run(torch, engines, reqs, admission=admission,
                    emitters=emitters)
    summary, rs, wall = run["summary"], run["router"], run["wall_s"]
    done = [r for r in run["results"] if r.finish_s is not None]
    row = {"phase": "serve_router", "arm": arm, "card": card,
           "replicas": len(engines),
           "requests": len(reqs), "completed": summary["completed"],
           "shed": summary["shed"], "dropped": summary["dropped"],
           "streams_equal": sum(r.tokens == ref[r.id] for r in done),
           "captures_after_warmup": run["captures"], "wall_s": wall,
           "decode_tok_s": (_decode_tokens(done) / wall) if wall else None,
           "tokens_per_s": summary["tokens_per_s"],
           "replica_decode_tok_s": [
               _decode_tokens(r.results) / (sum(r.stats["step_ms"]) / 1e3)
               if r.stats["step_ms"] else None for r in run["replicas"]],
           "routed_balance": rs["routed_balance"],
           "routed": [p["routed"] for p in rs["per_replica"]],
           "launches": {k: v for k, v in run["counts"].items() if v},
           "launches_exact": run["counts"] == run["want"]}
    if done:
        row.update({k: summary[k] for k in ("decode_step_ms", "ttft_ms",
                                            "token_lat_ms")})
    else:
        row["shed_by_rule"] = summary["shed_by_rule"]
    counts = dict(run["counts"])
    prun = None
    if profile:
        prun, dev = device_activity(torch, lambda: fleet_run(
            torch, engines, reqs, admission=admission, emitters=emitters))
        pwall = prun["wall_s"]
        pdone = [r for r in prun["results"] if r.finish_s is not None]
        row["profiled"] = {
            **dev, "wall_s": pwall, "decode_tok_s": _decode_tokens(pdone)
            / pwall if pwall else None,
            "decode_step_ms_p50": prun["summary"]["decode_step_ms"]["p50"],
            "streams_equal": sum(r.tokens == ref[r.id] for r in pdone)}
        for k, v in prun["counts"].items():
            counts[k] += v
    emit(row)
    check_fleet_run(arm, run, reqs, ref, shed_all)
    if prun is not None:
        check_fleet_run(arm + " (profiled)", prun, reqs, ref, shed_all)
    return row, counts, run["shed"]


def router_replica_main(argv) -> int:
    """A socket replica of phase 41 (``chip_smoke.py --router-replica
    ENDPOINT_A ENDPOINT_B RANK``, started by the phase): phase 3's model
    and engine from the same seed, warmed, then one session on each
    endpoint: a ``ReplicaClient`` whose feed the engine runs, acking each
    retirement. Rank 1 dies (``os._exit``) after acking 2 retirements of
    the second session. Each finished session's results go to one JSON
    file in ``$APEX_ROUTER_SMOKE_DIR``."""
    import os

    import torch

    from apex_tpu_torch.serve.router import ReplicaClient
    endpoints, rank = argv[:2], int(argv[2])
    out_dir = os.environ[ROUTER_DIR_ENV]
    torch.backends.cuda.matmul.allow_tf32 = False
    model, params = serve_model(torch)
    eng = serve_engine(model, params)
    warm = warm_engine(torch, eng)
    for session, endpoint in enumerate(endpoints):
        client = ReplicaClient(endpoint, rank)
        acked = [0]
        kill = session == 1 and rank == 1

        def on_retire(res, client=client, acked=acked, kill=kill):
            client.ack(res)
            acked[0] += 1
            if kill and acked[0] >= 2:
                time.sleep(0.25)      # the acks already queued drain
                os._exit(0)

        results, stats = eng.run(client.feed, t0=client.t0,
                                 on_retire=on_retire)
        client.close()
        row = {"rank": rank, "session": session,
               "received": client.received,
               "tokens": {str(r.id): r.tokens for r in results},
               "decode_tokens": _decode_tokens(results),
               "step_ms_sum": sum(stats["step_ms"]),
               "decode_steps": stats["decode_steps"],
               "captures_after_warmup": captures_since(eng, warm), **warm}
        path = os.path.join(out_dir, f"rank{rank}_s{session}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(row, f)
        os.replace(path + ".tmp", path)
    return 0


def _err_tail(out_dir: str, rank: int) -> str:
    import os
    with open(os.path.join(out_dir, f"rank{rank}.err")) as f:
        return f.read()[-2000:]


def await_replicas(srv, procs, out_dir: str, timeout: float) -> None:
    """``srv.wait_ready`` in short turns, failing as soon as a replica
    process has exited before its hello."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            srv.wait_ready(5.0)
            return
        except TimeoutError:
            for rank, p in enumerate(procs):
                check(p.poll() is None, f"serve_router: replica {rank} "
                      f"exited {p.returncode}: {_err_tail(out_dir, rank)}")
            check(time.monotonic() < deadline,
                  f"serve_router: the replicas' hello took {timeout} s")


def _wait_file(path: str, procs, timeout: float) -> dict:
    import os
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        check(time.monotonic() < deadline, f"serve_router: {path} never "
              f"came (replicas' exit codes {[p.poll() for p in procs]})")
        time.sleep(0.05)
    with open(path) as f:
        return json.load(f)


def socket_session(srv, arm, reqs, ref, procs, out_dir, kill,
                   card) -> dict:
    """One session of the socket transport: a ``Router`` over the
    ``SocketReplica`` s of ``srv`` (after every replica's hello), the
    requests as ``WireRequest`` s all at t=0, until every one is
    completed; then each surviving replica's results. Checks: completed
    equals the number offered, nothing lost, and every stream (every
    re-routed one's, from the survivor, in the kill arm) equals the plain
    engine's."""
    import os
    import threading

    from apex_tpu_torch.serve.router import Router, WireRequest
    await_replicas(srv, procs, out_dir, 240.0)
    router, reps = srv.make_replicas(
        lambda slots: Router(slots, policy="least-queue"))
    routes, mu, last = {}, threading.Lock(), [None]

    def recording(rep):
        submit = rep.submit

        def sub(req):
            routes.setdefault(int(req.id), []).append(rep.index)
            submit(req)
        return sub

    for rep in reps:
        rep.submit = recording(rep)
    on_complete = router.on_complete

    def completed(index, rid):
        on_complete(index, rid)
        with mu:
            last[0] = time.perf_counter()

    router.on_complete = completed
    wire = [WireRequest(id=r.id, prompt=[int(t) for t in r.prompt],
                        max_new=r.max_new) for r in reqs]
    t0 = time.perf_counter()
    shed = router.run(wire, t0=t0)
    deadline = time.monotonic() + 180.0
    while True:
        s = router.summary()
        if s["completed"] + s["shed"] >= s["offered"] - s["redirected"]:
            break
        check(time.monotonic() < deadline,
              f"serve_router {arm}: {s['completed']} of {len(reqs)} "
              f"completed in 180 s")
        time.sleep(0.002)
    router.close()
    for rep in reps:
        rep.join(60.0)
    s = router.summary()
    survivors = [0] if kill else [0, 1]
    rows = [_wait_file(os.path.join(out_dir, f"rank{r}_s{int(kill)}.json"),
                       procs, 120.0) for r in survivors]
    tokens = {int(k): v for row in rows for k, v in row["tokens"].items()}
    rerouted = sorted(i for i, hops in routes.items() if len(hops) > 1)
    checked = rerouted if kill else sorted(tokens)
    same = [tokens.get(i) == ref[i] for i in checked]
    wall = last[0] - t0
    dec = sum(row["decode_tokens"] for row in rows)
    out = {"phase": "serve_router", "arm": arm, "card": card, "replicas": 2,
           "transport": "socket", "requests": len(reqs),
           "offered": s["offered"], "completed": s["completed"],
           "shed": s["shed"], "redirected": s["redirected"],
           "rerouted": len(rerouted), "streams_equal": sum(same),
           "streams_checked": len(same), "wall_s": wall,
           "decode_tok_s": dec / wall if not kill else None,
           "replica_decode_tok_s": [
               row["decode_tokens"] / (row["step_ms_sum"] / 1e3)
               for row in rows if row["step_ms_sum"]],
           "routed": [p["routed"] for p in s["per_replica"]],
           "routed_balance": s["routed_balance"],
           "captures_after_warmup": [row["captures_after_warmup"]
                                     for row in rows],
           "warmup_s": [row["warmup_s"] for row in rows]}
    emit(out)
    check(not shed and s["completed"] == len(reqs),
          f"serve_router {arm}: completed {s['completed']} of {len(reqs)}")
    check(s["completed"] + s["shed"] == s["offered"] - s["redirected"],
          f"serve_router {arm}: requests lost ({s})")
    check(all(same) and same, f"serve_router {arm}: "
          f"{len(same) - sum(same)} of {len(same)} streams differ")
    check(not any(out["captures_after_warmup"]),
          f"serve_router {arm}: a replica captured after warmup")
    if kill:
        check(s["redirected"] >= 1 and rerouted,
              f"serve_router {arm}: nothing was re-routed")
    return out


def serve_router_phase(torch, model, params) -> dict:
    """Phase 41: the router tier on phase 3's model (serve_bench's width),
    each engine warmed before any router starts. (a) In process under
    least-queue: serve_bench's router traffic, 64 Poisson requests, at 1
    and 2 replicas (``EngineReplica`` threads, each on its own stream),
    then the same 64 all at t=0 (the saturated arm) at 1 and 2. (b)
    Admission: a ``LiveCollector`` on localhost TCP receiving each
    replica's ``LiveEmitter`` (process = replica index) with an
    ``AdmissionController(shed=True)`` attached: 16 requests served, then
    the controller tripped (``trip``) and every arrival shed with its rule
    and replica. (c) Across processes: a ``RouterServer`` and 2 children
    of this script (``--router-replica``), each warmed and on a
    ``ReplicaClient``: the saturated 64 served; then a second session in
    which rank 1 dies after acking 2 retirements and its requests are
    re-routed to rank 0. The children start first, so their set-up
    overlaps the Poisson arms. Returns the launches of (a) and (b)."""
    import gc
    import os
    import tempfile

    from apex_tpu_torch.prof.live import LiveCollector, LiveEmitter
    from apex_tpu_torch.serve import AdmissionController
    from apex_tpu_torch.serve.router import RouterServer
    gc.collect()
    torch.cuda.empty_cache()      # room for the children's engines
    card = nvidia_smi("name,power.limit")
    reqs = router_requests()
    saturated = at_once(reqs)
    tmp = tempfile.TemporaryDirectory()
    srv_a, srv_b = RouterServer(2), RouterServer(2)
    env = {**os.environ, ROUTER_DIR_ENV: tmp.name}
    logs = [open(os.path.join(tmp.name, f"rank{rank}.err"), "w")
            for rank in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--router-replica",
         srv_a.endpoint, srv_b.endpoint, str(rank)], env=env,
        stdout=subprocess.DEVNULL, stderr=log) for rank, log in
        zip((0, 1), logs)]
    totals: dict = {}
    try:
        engines = [serve_engine(model, params) for _ in range(2)]
        warm = [warm_engine(torch, e) for e in engines]
        # the plain engine's streams: every arm is held to them
        base, _ = engines[0].run(saturated)
        ref = {r.id: r.tokens for r in base}
        check(all(len(r.tokens) == q.max_new for r, q in zip(base, reqs)),
              "serve_router: the plain engine's run is short")
        rows = {}
        for arm, rq, n in (("poisson", reqs, 1), ("poisson", reqs, 2),
                           ("saturated", saturated, 1),
                           ("saturated", saturated, 2)):
            if arm == "saturated" and n == 1:
                # the children warmed and idle before the timed arms
                await_replicas(srv_a, procs, tmp.name, 240.0)
            row, counts, _ = fleet_arm(torch, f"{arm}_{n}", engines[:n],
                                       rq, ref, card)
            rows[(arm, n)] = row
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
        # (b) admission on the live plane's alert seam
        col = LiveCollector(http_port=None).start()
        adm = AdmissionController(shed=True, window_s=600.0).attach(col)
        ems = [LiveEmitter(col.endpoint, process_index=i, process_count=2,
                           run="serve_router") for i in range(2)]
        _, counts, _ = fleet_arm(torch, "live_2", engines, saturated[:16],
                                 ref, card, admission=adm, emitters=ems,
                                 profile=False)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        adm.trip("occupancy_min", replica=1)
        _, _, shed = fleet_arm(torch, "shed_2", engines, saturated, ref,
                               card, admission=adm, emitters=ems,
                               shed_all=True, profile=False)
        for em in ems:
            em.close()
        deadline = time.monotonic() + 20.0
        while True:
            snap = col.snapshot()
            steps = {r["process"]: r["step_p50_ms"]
                     for r in snap["replicas"]}
            if all(steps.get(i) is not None for i in (0, 1)) and all(
                    r["closed"] for r in snap["replicas"]):
                break
            check(time.monotonic() < deadline,
                  f"serve_router shed_2: the collector holds {steps}")
            time.sleep(0.05)
        col.close()
        emit({"phase": "serve_router", "arm": "admission", "card": card,
              "shed": len(shed), "alerts_consumed": adm.alerts_consumed,
              "attributed": sum(r["rule"] == "occupancy_min"
                                and r["replica"] == 1 for r in shed),
              "collector": {str(r["process"]): {
                  k: r[k] for k in ("samples", "step_p50_ms", "occupancy",
                                    "ttft_p95_ms", "drops", "closed")}
                  for r in snap["replicas"]}})
        check(len(shed) == len(saturated) and all(
            r["rule"] == "occupancy_min" and r["replica"] == 1
            for r in shed), "serve_router shed_2: a shed row without its "
              "rule and replica")
        check(all(r["drops"] == 0 for r in snap["replicas"]),
              "serve_router: the live emitters dropped samples")
        del engines
        gc.collect()
        torch.cuda.empty_cache()
        # (c) the socket transport across processes
        sock = socket_session(srv_a, "socket_2", saturated, ref, procs,
                              tmp.name, False, card)
        socket_session(srv_b, "socket_kill", saturated, ref, procs,
                       tmp.name, True, card)
        for rank, p in enumerate(procs):
            p.wait(timeout=120)
            check(p.returncode == 0, f"serve_router: replica {rank} exit "
                  f"{p.returncode}: {_err_tail(tmp.name, rank)}")
        one, two = rows[("saturated", 1)], rows[("saturated", 2)]
        emit({"phase": "serve_router_saturated", "card": card,
              "decode_tok_s": {
                "threads_1": one["decode_tok_s"],
                "threads_2": two["decode_tok_s"],
                "processes_2": sock["decode_tok_s"]},
              "threads_2_over_1": two["decode_tok_s"] / one["decode_tok_s"],
              "processes_2_over_threads_1": sock["decode_tok_s"]
              / one["decode_tok_s"],
              "idle_share": {"threads_1": one["profiled"]["idle_share"],
                             "threads_2": two["profiled"]["idle_share"]},
              "warmup": warm})
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for log in logs:
            log.close()
        srv_a.close()
        srv_b.close()
        tmp.cleanup()
    return totals


# -- phase 42: the telemetry sidecar ------------------------------------------

TELEMETRY_SLO = "ttft_p95_ms<=250,token_lat_p99_ms<=50@100"


def tool_line(args, cwd: str, timeout: float) -> dict:
    """Run one of the port's tools (``tools/<name>`` with ``args``) in
    ``cwd`` and return its JSON line, the last of its output; a nonzero
    exit fails the phase with the end of its stderr."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, os.path.join(here, "tools",
                                                       args[0]), *args[1:]],
                         cwd=cwd, capture_output=True, text=True,
                         timeout=timeout)
    check(out.returncode == 0, f"{args[0]} exit {out.returncode}: "
          f"{out.stderr[-1500:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def telemetry_serve(torch, model, params, tmp: str, card: str) -> dict:
    """Phase 42 (a): phase 3's engine with and without the observation
    hooks. Returns the armed run's launches."""
    import os

    from apex_tpu_torch.prof import flightrec as FR
    from apex_tpu_torch.prof import metrics as M
    from apex_tpu_torch.prof.flightrec import FlightRecorder
    from apex_tpu_torch.prof.slo import SLOMonitor
    from apex_tpu_torch.prof.spans import SpanTracer
    from apex_tpu_torch.serve import summarize_serving
    reqs = at_once(router_requests())
    eng = serve_engine(model, params)
    warm = warm_engine(torch, eng)
    runs, counts = {}, None
    for arm in ("plain", "armed", "telemetry", "plain_again"):
        hooks, log = {}, None
        if arm in ("armed", "telemetry"):
            log = M.MetricsLogger(os.path.join(tmp, f"TELEM_{arm}.jsonl"),
                                  run="chip_smoke_serve")
            hooks["telemetry"] = log
        if arm == "armed":
            # a rule no decode step can meet: its alert must dump the
            # flight recorder
            slo = SLOMonitor("step_ms_p50<=0.001", logger=log,
                             min_samples=4)
            fr = FlightRecorder(path=os.path.join(tmp, "FLIGHTREC.json"),
                                window_s=120.0, cooldown_s=0.5)
            tr = SpanTracer()
            hooks.update(tracer=tr, slo=slo, flightrec=fr)
        zero_counts()
        t0 = time.perf_counter()
        res, stats = eng.run(reqs, **hooks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if arm == "armed":
            counts = read_counts()
        runs[arm] = (res, stats, wall, log)
    res, stats, _, log = runs["armed"]
    deadline = time.monotonic() + 10.0
    while not fr.dumps and time.monotonic() < deadline:
        time.sleep(0.05)
    log.log_spans(tr)
    log.log_serving(**summarize_serving(res, stats, offered_rps=0.0))
    log.close()
    runs["telemetry"][3].close()
    recs = M.read_sidecar(log.path)
    for r in recs:
        M.validate_record(r)
    kinds: dict = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    steps = [r for r in recs if r["kind"] == "step"]
    dump = FR.read_dump(fr.dumps[0]) if fr.dumps else None
    # the host cost of one log_step (Python numbers, as the engine logs)
    cost_log = M.MetricsLogger(os.path.join(tmp, "TELEM_cost.jsonl"),
                               run="log_step_cost", track_compiles=False)
    n = 20000
    t0 = time.perf_counter()
    for i in range(n):
        cost_log.log_step(i, step_ms=1.0, active_slots=8, queue_depth=0)
    cost_us = (time.perf_counter() - t0) / n * 1e6
    cost_log.close()
    base = runs["plain"][0]
    row = {"phase": "telemetry_serve", "card": card, **warm,
           "requests": len(reqs),
           "captures_after_warmup": captures_since(eng, warm),
           "streams_equal": {arm: _stream_equal(r[0], base)
                             for arm, r in runs.items()},
           "decode_steps": stats["decode_steps"],
           "step_records": len(steps), "record_kinds": kinds,
           "step_record_keys": sorted(steps[0]) if steps else None,
           "slo_alerts": len(slo.alerts), "flightrec_dumps": len(fr.dumps),
           "flightrec_counts": dump["counts"] if dump else None,
           "decode_step_ms_p50": {arm: statistics.median(r[1]["step_ms"])
                                  for arm, r in runs.items()},
           "decode_tok_s": {arm: decode_tok_s(r[0], r[1])
                            for arm, r in runs.items()},
           "wall_s": {arm: r[2] for arm, r in runs.items()},
           "log_step_host_us": cost_us,
           "launches": {k: v for k, v in counts.items() if v}}
    emit(row)
    check(all(row["streams_equal"].values()),
          f"telemetry_serve: streams differ {row['streams_equal']}")
    check(row["captures_after_warmup"] == 0,
          f"telemetry_serve: {row['captures_after_warmup']} captures "
          f"after warmup")
    check(len(steps) == stats["decode_steps"],
          f"telemetry_serve: {len(steps)} step records for "
          f"{stats['decode_steps']} decode steps")
    check(bool(steps) and {"step", "step_ms", "active_slots",
                           "queue_depth"} <= set(steps[0]),
          f"telemetry_serve: step record {steps[:1]}")
    check(slo.alerts and dump is not None and kinds.get("flightrec") == 1,
          f"telemetry_serve: alerts {len(slo.alerts)}, dumps {fr.dumps}, "
          f"kinds {kinds}")
    return counts


def telemetry_tools(tmp: str, card: str) -> None:
    """Phase 42 (b, c): the port's serving tools at their defaults."""
    import os

    from apex_tpu_torch.prof import metrics as M
    sb = tool_line(["serve_bench_torch.py", "--paged", "--parity",
                    "--telemetry", os.path.join(tmp, "TELEM_sb.jsonl"),
                    "--trace", os.path.join(tmp, "TRACE_sb.json"),
                    "--slo", TELEMETRY_SLO,
                    "--flightrec", os.path.join(tmp, "FLIGHTREC_sb.json")],
                   tmp, 400)
    emit({"phase": "serve_bench", "card": card, "line": sb})
    recs = M.read_sidecar(sb["telemetry"])
    steps = sum(r["kind"] == "step" for r in recs)
    check(sb["completed"] == 64 and sb["dropped"] == 0
          and sb["parity"] == "bit-equal",
          f"serve_bench: {sb['completed']} completed, parity "
          f"{sb.get('parity')}")
    check(steps == sb["decode_steps"] and sum(
        r["kind"] == "serving" for r in recs) == 1,
          f"serve_bench: {steps} step records for {sb['decode_steps']} "
          f"decode steps")
    check(sb["run_meta"]["platform"] == "gpu",
          f"serve_bench: ran on {sb['run_meta']}")
    for args in ([], ["--fused"]):
        db = tool_line(["decode_bench_torch.py", *args], tmp, 400)
        emit({"phase": "decode_bench", "card": card, "args": args,
              "line": db})
        check(db["value"] > 0 and db["run_meta"]["platform"] == "gpu",
              f"decode_bench {args}: {db}")


def telemetry_dcgan(torch, tmp: str, card: str) -> dict:
    """Phase 42 (d): ``DCGANTrainer.fit`` with telemetry. Returns its
    launches."""
    import os

    from apex_tpu_torch.models import DCGAN
    from apex_tpu_torch.prof import metrics as M
    from apex_tpu_torch.prof.slo import SLOMonitor
    from apex_tpu_torch.train import DCGANTrainer
    model = DCGAN()
    tr = DCGANTrainer(model, model.g_init(1), model.d_init(2),
                      opt_level="O1", numerics=True)
    log = M.MetricsLogger(os.path.join(tmp, "TELEM_dcgan.jsonl"),
                          run="dcgan", meta={"opt_level": "O1",
                                             "batch": DCGAN_BATCH,
                                             "num_losses": 3})
    slo = SLOMonitor("step_ms_p95<=1000,skip_rate<=0.5", logger=log,
                     min_samples=1)
    zero_counts()
    t0 = time.perf_counter()
    rows = tr.fit(20, batch_size=DCGAN_BATCH, telemetry=log, slo=slo)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log.close()
    recs = M.read_sidecar(log.path)
    kinds: dict = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    emit({"phase": "dcgan_fit", "card": card, "steps": 20,
          "batch": DCGAN_BATCH, "wall_s": wall, "intervals": rows,
          "record_kinds": kinds, "slo": slo.summary(),
          "launches": {k: v for k, v in counts.items() if v}})
    check(kinds.get("amp") == 3 and kinds.get("step") == 2,
          f"dcgan_fit: record kinds {kinds}")
    check(all(math.isfinite(r["loss_d"]) and math.isfinite(r["loss_g"])
              for r in rows), f"dcgan_fit: losses {rows}")
    check(counts["scale"] == 20 * DCGAN_PER_STEP["scale"]
          and counts["adam"] == 20 * DCGAN_PER_STEP["adam"],
          f"dcgan_fit: launches {counts}")
    return counts


def telemetry_sync(torch, tmp: str, card: str) -> None:
    """Phase 42 (e): logging adds no host sync, a logged tensor keeps its
    value, and a flush fetches the buffer in one transfer."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.prof import metrics as M
    log = M.MetricsLogger(os.path.join(tmp, "TELEM_sync.jsonl"),
                          run="sync", flush_every=1000,
                          track_compiles=False)
    xs = [torch.full((), float(i), device="cuda") for i in range(64)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i, x in enumerate(xs):
            log.log_step(i, step_ms=1.0, loss=x, loss_scale=xs[-1 - i])
        xs[0].add_(100.0)           # after the call: the log keeps 0.0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    before = log.fetches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        log.flush()
        torch.cuda.synchronize()
    copies = [n for _, _, n in _device_spans(torch, prof) if "DtoH" in n]
    log.close()
    steps = [r for r in M.read_sidecar(log.path) if r["kind"] == "step"]
    row = {"phase": "telemetry_sync", "card": card, "log_steps": len(xs),
           "scalars": 2 * len(xs), "sync_debug": "error",
           "flush_transfers": log.fetches - before,
           "profiled_dtoh_copies": len(copies),
           "first_loss": steps[0]["loss"] if steps else None}
    emit(row)
    check(row["flush_transfers"] == 1 and len(copies) == 1,
          f"telemetry_sync: {row['flush_transfers']} transfers, "
          f"copies {copies}")
    check(len(steps) == 64 and steps[0]["loss"] == 0.0
          and steps[5]["loss"] == 5.0 and steps[5]["loss_scale"] == 58.0,
          f"telemetry_sync: {steps[:6]}")


def telemetry_phase(torch, model, params) -> dict:
    """Phase 42: the telemetry sidecar on the port's paths. Returns the
    launches of its in-process runs."""
    import gc
    import tempfile
    gc.collect()
    torch.cuda.empty_cache()
    card = nvidia_smi("name,power.limit")
    tmp = tempfile.TemporaryDirectory()
    totals: dict = {}
    try:
        for counts in (telemetry_serve(torch, model, params, tmp.name,
                                       card),
                       telemetry_dcgan(torch, tmp.name, card)):
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
        telemetry_sync(torch, tmp.name, card)
        gc.collect()
        torch.cuda.empty_cache()    # room for the tools' processes
        telemetry_tools(tmp.name, card)
    finally:
        tmp.cleanup()
    return totals


# -- phase 43: data parallelism -------------------------------------------------

DP_BATCH, DP_IMAGE, DP_STEPS, DP_TIMED = 256, 224, 3, 5
# Zero at 1 shard is FusedLAMB's arithmetic in the same layout: within
# DP_ZERO_ATOL of its masters.
# (b)'s two ranks against (a) on the full batch are held at step 1 in fp32
# (O0), before any update: the averaged flat grad against (a)'s O0 grad
# (mean and max of |diff| over mean and max of |grad|) within
# DP_REORDER_FACTOR times fp32's own effect, the gap between (a)'s grad and
# (a)'s grad of the same batch with its halves swapped, and the first loss
# within DP_STEP1_LOSS (20 fp32 ulps at 7). The BN sums and conv grads are
# added in another order, and RN50's 53 BN backward projections, each a
# small difference of large sums, magnify that rounding at random init.
# After an update the gap stops measuring the program:
# LAMB moves each weight by lr times about the sign of its grad, so a grad
# near zero that changes sign moves its weight by up to 2 lr (the first
# card runs read 5.4e-3 at O0 after 3 steps), and at O2 a master 1 ulp
# apart rounds to another bf16 param (8.7e-4). So the 3-step gaps are
# readings. The control, BNs left local, must fall outside the step-1 bar.
# Zero at 2 shards against FusedLAMB is held on the same grads: each
# rank's step-1 grad of the ddp arm, reduce-scattered by zero's first
# update, against FusedLAMB's update from their average. Only LAMB's
# norms, summed in another order, part them: within DP_ZERO_ATOL.
DP_ZERO_ATOL = 1e-6
DP_REORDER_FACTOR, DP_STEP1_LOSS = 2.0, 1e-5
# (b)'s arms: name, trainer, BNs synced, amp level
DP_ARMS = (("ddp", "ddp", True, "O2"), ("zero", "zero", True, "O2"),
           ("ddp_o0", "ddp", True, "O0"), ("zero_o0", "zero", True, "O0"),
           ("ddp_o0_local_bn", "ddp", False, "O0"))


def dp_batch(torch, classes: int, rank: int = 0, world: int = 1):
    """bench.py's batch (RandomState(0), :887-889), this rank's share, on
    the card: x NCHW (channels_last) fp32, y int32."""
    import numpy as np
    rs = np.random.RandomState(0)
    x = rs.randn(DP_BATCH, DP_IMAGE, DP_IMAGE, 3).astype(np.float32)
    y = rs.randint(0, classes, DP_BATCH).astype(np.int32)
    n = DP_BATCH // world
    sl = slice(rank * n, (rank + 1) * n)
    return (torch.from_numpy(x[sl]).cuda().permute(0, 3, 1, 2),
            torch.from_numpy(y[sl]).cuda())


def dp_state_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dp_build(torch, build) -> tuple:
    """``build()`` and the device bytes it leaves allocated: what the
    trainer holds."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    tr = build()
    torch.cuda.synchronize()
    return tr, torch.cuda.memory_allocated() - before


def dp_gap(a, b, loss_a, loss_b) -> dict:
    """The masters' mean and max absolute gap and the losses' largest."""
    d = (a - b).abs()
    return {"mean": float(d.mean()), "max": float(d.max()),
            "loss": max(abs(u - v) for u, v in zip(loss_a, loss_b))}


def dp_step1(grad, loss, ref_grad, ref_loss) -> dict:
    """Step 1 against the reference: the grads' mean and max |diff| over
    the reference's mean and max |grad|, and the losses' |diff|."""
    d = (grad - ref_grad).abs()
    return {"grad_mean": float(d.mean() / ref_grad.abs().mean()),
            "grad_max": float(d.max() / ref_grad.abs().max()),
            "loss": abs(loss - ref_loss)}


def dp_within(gap: dict, bar: dict) -> bool:
    return all(gap[k] <= bar[k] for k in bar)


def dp_window(torch, tr, x, y, flops: float, batch: int) -> dict:
    """DP_TIMED timed steps of a warmed trainer: img/s, step p50, MFU,
    peak memory and the launches (``timed_steps``)."""
    r = timed_steps(torch, lambda: tr.step(x, y), 0, DP_TIMED)
    return {**step_row(r, batch, DP_TIMED, flops), "launches": r["counts"]}


def ddp_world1(torch, card: str) -> tuple:
    """(a): NCCL at world size 1, bench.py's ddp arm at phase 6's width
    against Trainer's plain step, then its zero arm at 1 shard."""
    import os
    import tempfile

    import torch.distributed as dist

    from apex_tpu_torch.models import analytic_flops, resnet50
    from apex_tpu_torch.ops import flat
    from apex_tpu_torch.parallel import collectives as C
    from apex_tpu_torch.parallel import (convert_syncbn_model, launch,
                                         make_mesh)
    from apex_tpu_torch.train import DDPTrainer, Trainer, ZeROTrainer
    tmp = tempfile.TemporaryDirectory()
    launch.initialize(device="cuda", rank=0, world_size=1,
                      init_method=f"file://{os.path.join(tmp.name, 's')}")
    totals: dict = {}
    try:
        make_mesh(device="cuda")
        model = resnet50()
        params, state = model.init(0)
        flops = analytic_flops(model, DP_IMAGE)
        x, y = dp_batch(torch, model.num_classes)
        plain = Trainer(model, params, state)
        p_loss = [plain.step(x, y) for _ in range(DP_STEPS)]
        sync = convert_syncbn_model(model, axis_name="data")
        ddp, ddp_held = dp_build(torch,
                                 lambda: DDPTrainer(sync, params, state))
        zero_counts()
        d_loss = [ddp.step(x, y) for _ in range(DP_STEPS)]
        counts = read_counts()
        tally = C.collective_bytes()
        same = torch.equal(plain.opt.state[0].master,
                           ddp.opt.state[0].master)
        bn_same = all(torch.equal(a, b) for a, b in zip(
            flat.tree_leaves(plain.bn_state), flat.tree_leaves(ddp.bn_state)))
        loss_same = all(torch.equal(a, b) for a, b in zip(p_loss, d_loss))
        ddp_masters = ddp.opt.state[0].master.detach().cpu()
        ddp_losses = [float(v) for v in d_loss]
        del plain
        window = dp_window(torch, ddp, x, y, flops, DP_BATCH)
        ddp_bytes = dp_state_bytes([ddp.opt.state[0].master,
                                    *ddp.opt.state[0].slots.values()])
        for k, v in window["launches"].items():
            totals[k] = totals.get(k, 0) + v
        emit({"phase": "data_parallel", "part": "ddp_world1", "card": card,
              "backend": dist.get_backend(), "world": 1,
              "model": "resnet50", "batch": DP_BATCH, "image": DP_IMAGE,
              "steps": DP_STEPS, "masters_bit_equal": same,
              "bn_state_bit_equal": bn_same, "losses_bit_equal": loss_same,
              "losses": ddp_losses,
              "collectives_per_step": tally.get("total_calls"),
              "collective_bytes_per_step": tally.get("total_bytes"),
              "collectives": tally.get("ops"),
              "params_opt_state_bytes_per_device": ddp_bytes,
              "trainer_device_bytes": ddp_held,
              "launches_3_steps": counts,
              **{k: v for k, v in window.items() if k != "losses"}})
        check(same and bn_same and loss_same,
              "ddp_world1: the DDP step is not the plain step bit for bit "
              f"(masters {same}, BN state {bn_same}, losses {loss_same})")
        check_counts("ddp_world1", counts, {
            k: DP_STEPS * (53 if k.startswith("bn_") else 1)
            for k in TRAIN_KERNELS})
        check(tally.get("total_calls") == 2 * 53 + 2,
              f"ddp_world1: {tally.get('total_calls')} collectives a step, "
              f"not 2 a BN + the grad's and the loss's")
        del ddp
        # the zero arm at one shard against FusedLAMB's masters above
        zt, z_held = dp_build(torch,
                              lambda: ZeROTrainer(sync, params, state))
        zero_counts()
        z_loss = [float(zt.step(x, y)) for _ in range(DP_STEPS)]
        zcounts = read_counts()
        ztally = C.collective_bytes()
        zm = zt.masters().detach().cpu()
        err = float((zm - ddp_masters).abs().max())
        zwindow = dp_window(torch, zt, x, y, flops, DP_BATCH)
        for k, v in zwindow["launches"].items():
            totals[k] = totals.get(k, 0) + v
        z_bytes = dp_state_bytes([zt.state.master,
                                  *zt.state.slots.values()])
        emit({"phase": "data_parallel", "part": "zero_world1", "card": card,
              "num_shards": 1, "losses": z_loss,
              "masters_max_abs_vs_fused_lamb": err,
              "masters_bit_equal": err == 0.0,
              "collectives_per_step": ztally.get("total_calls"),
              "collective_bytes_per_step": ztally.get("total_bytes"),
              "collectives": ztally.get("ops"),
              "params_opt_state_bytes_per_device": z_bytes,
              "trainer_device_bytes": z_held,
              "launches_3_steps": zcounts,
              **{k: v for k, v in zwindow.items() if k != "losses"}})
        check(err <= DP_ZERO_ATOL, f"zero_world1: masters {err} from "
              f"FusedLAMB's, over {DP_ZERO_ATOL}")
        check_counts("zero_world1", zcounts, {
            k: DP_STEPS * (53 if k.startswith("bn_") else 1)
            for k in TRAIN_KERNELS})
        del zt
        # the same 3 steps at O0: (b)'s fp32 reference, and bf16's own
        # effect for the record
        fp32 = Trainer(model, params, state, opt_level="O0")
        grad, first, _ = fp32.loss_and_grad(x, y)
        o0_grad = grad.detach().cpu()
        # fp32's own effect: the same batch, its halves swapped
        h = DP_BATCH // 2
        grad, loss, _ = fp32.loss_and_grad(torch.cat([x[h:], x[:h]]),
                                           torch.cat([y[h:], y[:h]]))
        reorder = dp_step1(grad.detach().cpu(), float(loss), o0_grad,
                           float(first))
        del grad
        o0_loss = [float(fp32.step(x, y)) for _ in range(DP_STEPS)]
        o0_masters = fp32.opt.state[0].master.detach().cpu()
        bf16_effect = dp_gap(o0_masters, ddp_masters, o0_loss, ddp_losses)
        del fp32
    finally:
        C.unbind_axes()
        dist.destroy_process_group()
        tmp.cleanup()
    return totals, {"masters": ddp_masters, "losses": ddp_losses,
                    "o0_masters": o0_masters, "o0_losses": o0_loss,
                    "o0_grad": o0_grad, "reorder_effect": reorder,
                    "bf16_effect": bf16_effect}


def ddp_rank_main(argv) -> int:
    """A rank of phase 43 (``chip_smoke.py --ddp-rank MODE DIR``, started
    by ``launch.multiproc``, which sets ``RANK`` and ``WORLD_SIZE``;
    results and logs in DIR). MODE ``nccl``: join an NCCL group on the
    one card and all-reduce once, writing what NCCL says; ``train``: gloo
    over CUDA tensors, the arms of ``DP_ARMS`` on this rank's half of the
    batch; ``groups``: gloo, the CI ResNet with
    ``create_syncbn_process_group(2)``, one forward."""
    import os

    mode, out = argv[0], argv[1]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if rank == 0:       # the launcher leaves rank 0 on the phase's output
        fd = os.open(os.path.join(out, "rank0.log"),
                     os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
    import torch
    import torch.distributed as dist

    from apex_tpu_torch.parallel import launch
    store = f"file://{os.path.join(out, 'store')}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def write(name, obj):
        path = os.path.join(out, name)
        with open(path + ".tmp", "w") as f:
            json.dump(obj, f)
        os.replace(path + ".tmp", path)

    if mode == "nccl":
        launch.initialize(device="cuda", init_method=store, timeout=60)
        t = torch.ones(4, device="cuda")
        try:      # the probe's question is what NCCL says
            dist.all_reduce(t)
            torch.cuda.synchronize()
            said = {"ok": True, "sum": float(t[0])}
        except Exception as e:      # noqa: BLE001 - reported, not hidden
            said = {"ok": False, "error": f"{type(e).__name__}: {e}"[:600]}
        write(f"nccl{rank}.json", said)
        os._exit(0)     # the group may be left half made: leave at once
    launch.initialize("gloo", device="cuda", init_method=store,
                      timeout=300)
    from apex_tpu_torch.ops import cuda as kcuda
    from apex_tpu_torch.parallel import collectives as C
    from apex_tpu_torch.parallel import (convert_syncbn_model,
                                         create_syncbn_process_group,
                                         make_mesh)
    make_mesh(device="cuda")
    kcuda.lib()
    check(kcuda.build_seconds is None, "ddp rank: the kernels were rebuilt")
    if mode == "groups":
        from apex_tpu_torch.models import ResNet
        model = ResNet(block_sizes=(1, 1), bottleneck=True, num_classes=10,
                       width=8)
        params, state = model.init(0)
        sync = convert_syncbn_model(
            model, create_syncbn_process_group(2), axis_name="data")
        g = torch.Generator().manual_seed(100 + rank)
        x = torch.randn(4, 3, 32, 32, generator=g).cuda()
        _, new = sync.apply(params, state, x, training=True)
        write(f"groups{rank}.json", {
            "stem_mean": new["bn_stem"]["running_mean"].tolist(),
            "stem_var": new["bn_stem"]["running_var"].tolist(),
            "x_seed": 100 + rank})
        dist.barrier()
        dist.destroy_process_group()
        return 0
    from apex_tpu_torch.models import resnet50
    from apex_tpu_torch.ops import flat
    from apex_tpu_torch.train import DDPTrainer, ZeROTrainer
    local = resnet50()
    synced = convert_syncbn_model(local, axis_name="data")
    params, state = local.init(0)
    x, y = dp_batch(torch, local.num_classes, rank, world)
    row = {"rank": rank}

    def masters(tr, kind):
        if kind == "ddp":
            return tr.opt.state[0].master
        # in the ddp arm's (128-aligned) layout, to compare in place
        return flat.flatten(flat.unflatten(tr.masters(), tr.table),
                            dtype=torch.float32)[0]

    def save(t, name):
        torch.save(t.detach().cpu(), os.path.join(out, f"{name}{rank}.pt"))

    step1 = None
    for arm, kind, sync_bn, level in DP_ARMS:
        cls = DDPTrainer if kind == "ddp" else ZeROTrainer
        model = synced if sync_bn else local
        tr, held = dp_build(torch, lambda: cls(model, params, state,
                                               opt_level=level))
        if kind == "ddp" and level == "O0":
            # step 1's grad, before any update, averaged over the ranks
            grad = tr.loss_and_grad(x, y)[0]
            avg = tr.ddp.average_gradients(grad)
            save(avg, f"{arm}_grad")
            if sync_bn:
                # FusedLAMB's first update from it, and this rank's grad
                # for zero's first update (a second backward would not
                # give the same grads: cuDNN's fp32 backward adds in no
                # fixed order)
                save(tr.opt.apply_update(tr.opt.state, [avg])[0].master,
                     "lamb_step1_")
                step1 = (grad.cpu(), tr.table)
            del grad, avg
        if kind == "zero" and level == "O0":
            grad = flat.flatten(flat.unflatten(step1[0].cuda(), step1[1]),
                                table=tr.table, dtype=torch.float32)[0]
            st, _ = tr.opt.shard_step(tr.state, grad, gather=False)
            full = C.all_gather(st.master, "data")
            save(flat.flatten(flat.unflatten(full, tr.table),
                              dtype=torch.float32)[0], "zero_step1_")
            del grad, st, full
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(tr.step(x, y)) for _ in range(DP_STEPS)]
        torch.cuda.synchronize()
        row[arm] = {"losses": losses,
                    "s_per_step": (time.perf_counter() - t0) / DP_STEPS,
                    "launches": read_counts(),
                    "collectives": C.collective_bytes(),
                    "trainer_device_bytes": held}
        if kind == "ddp":
            tensors = [tr.opt.state[0].master,
                       *tr.opt.state[0].slots.values()]
        else:
            tensors = [tr.state.master, *tr.state.slots.values()]
            # the state of one rank of ZeRO's own (n·128-aligned) layout
            row[arm]["unsharded_bytes"] = 3 * 4 * tr.opt.total
        row[arm]["state_bytes"] = dp_state_bytes(tensors)
        save(masters(tr, kind), arm)
        del tr, tensors
        torch.cuda.empty_cache()
    write(f"train{rank}.json", row)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def dp_children(mode: str, world: int, root: str, timeout: float) -> tuple:
    """``world`` ranks of ``--ddp-rank MODE`` through the port's launcher
    (``launch.multiproc``, killed at ``timeout``): the first nonzero exit
    code (0 if none), and the directory of their results and logs."""
    import os

    from apex_tpu_torch.parallel import launch
    out = os.path.join(root, mode)
    os.makedirs(out)
    rc = launch.multiproc(os.path.abspath(__file__), world, "--ddp-rank",
                          mode, out, log_dir=out, timeout=timeout)
    return rc, out


def _dp_err(out: str, world: int) -> str:
    import os
    tails = []
    for r in range(world):
        path = os.path.join(out, f"rank{r}.log")
        if os.path.exists(path):
            with open(path) as f:
                tails.append(f"rank {r}: {f.read()[-1500:]}")
    return "\n".join(tails)


def ddp_two_ranks(torch, card: str, ref: dict) -> None:
    """(b): two ranks on the one card. NCCL is tried once; the arms run
    over gloo on CUDA tensors (the collectives' gloo-on-CUDA rules)."""
    import os
    import tempfile
    tmp = tempfile.TemporaryDirectory()
    try:
        t0 = time.perf_counter()
        rc, out = dp_children("nccl", 2, tmp.name, 90.0)
        said = []
        for r in range(2):
            path = os.path.join(out, f"nccl{r}.json")
            said.append(json.load(open(path)) if os.path.exists(path)
                        else {"ok": None, "exit": rc,
                              "log": _dp_err(out, 2)[-600:]})
        emit({"phase": "data_parallel", "part": "nccl_two_ranks_one_card",
              "card": card, "said": said,
              "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        rc, out = dp_children("train", 2, tmp.name, 400.0)
        check(rc == 0, f"ddp_2ranks: exit code {rc}\n{_dp_err(out, 2)}")
        rows = [json.load(open(os.path.join(out, f"train{r}.json")))
                for r in range(2)]
        arms = [a[0] for a in DP_ARMS]
        m = {(arm, r): torch.load(os.path.join(out, f"{arm}{r}.pt"))
             for arm in arms for r in range(2)}
        ranks_equal = {arm: torch.equal(m[(arm, 0)], m[(arm, 1)])
                       for arm in arms}

        def gap(a, b):
            la = rows[0][a]["losses"]
            ma = m[(a, 0)]
            if b in ref:
                return dp_gap(ma, ref[b], la, ref[b.replace("masters",
                                                            "losses")])
            return dp_gap(ma, m[(b, 0)], la, rows[0][b]["losses"])
        def load(name):
            return torch.load(os.path.join(out, f"{name}0.pt"))

        def step1(a):
            return dp_step1(load(f"{a}_grad"), rows[0][a]["losses"][0],
                            ref["o0_grad"], ref["o0_losses"][0])
        reorder = ref["reorder_effect"]
        bar = {"grad_mean": DP_REORDER_FACTOR * reorder["grad_mean"],
               "grad_max": DP_REORDER_FACTOR * reorder["grad_max"],
               "loss": DP_STEP1_LOSS}
        o0_step1 = step1("ddp_o0")
        control = step1("ddp_o0_local_bn")
        zero_step1 = float((load("zero_step1_")
                            - load("lamb_step1_")).abs().max())
        halves = [rows[r]["zero"]["state_bytes"] * 2
                  == rows[r]["zero"]["unsharded_bytes"] for r in range(2)]
        # the zero trainer holds its state and nothing of the full size
        held_ok = [rows[r]["zero"]["trainer_device_bytes"]
                   <= rows[r]["zero"]["state_bytes"] + (1 << 20)
                   for r in range(2)]
        emit({"phase": "data_parallel", "part": "ddp_2ranks", "card": card,
              "backend": "gloo", "device": "cuda",
              "note": "NCCL refuses two ranks on one device; gloo over CUDA "
                      "tensors, all_reduce native, reduce_scatter as "
                      "all_reduce + slice, all_gather as a broadcast a rank",
              "batch_per_rank": DP_BATCH // 2, "ranks_bit_equal":
              ranks_equal,
              "o0_step1_vs_world1": o0_step1, "step1_bar": bar,
              "fp32_reorder_effect_world1": reorder,
              "control_local_bn_step1_vs_world1": control,
              "o0_zero_vs_fused_lamb_step1_max_abs": zero_step1,
              "zero_atol": DP_ZERO_ATOL,
              "readings_after_3_steps": {
                  "o2_vs_world1": gap("ddp", "masters"),
                  "o2_zero_vs_ddp": gap("zero", "ddp"),
                  "bf16_effect_world1": ref["bf16_effect"],
                  "o0_vs_world1": gap("ddp_o0", "o0_masters"),
                  "o0_zero_vs_ddp": gap("zero_o0", "ddp_o0"),
                  "control_local_bn_o0_vs_world1": gap("ddp_o0_local_bn",
                                                       "o0_masters")},
              "zero_half_state": halves, "zero_holds_only_its_state":
              held_ok,
              "seconds": time.perf_counter() - t0,
              "ranks": rows})
        check(all(ranks_equal.values()),
              f"ddp_2ranks: the two ranks' masters differ {ranks_equal}")
        check(dp_within(o0_step1, bar),
              f"ddp_2ranks: O0 step 1 {o0_step1} from world 1, over {bar}")
        check(not dp_within(control, bar),
              f"ddp_2ranks: the control (BNs left local) {control} passes "
              f"the bar {bar}")
        check(zero_step1 <= DP_ZERO_ATOL,
              f"ddp_2ranks: zero's first update {zero_step1} from "
              f"FusedLAMB's on the same grads, over {DP_ZERO_ATOL}")
        check(all(halves), "ddp_2ranks: a zero rank does not hold half the "
              "optimizer state")
        check(all(held_ok), "ddp_2ranks: a zero trainer holds more device "
              "memory than its state")
        for r in rows:
            check_counts("ddp_2ranks", r["ddp"]["launches"], {
                k: DP_STEPS * (53 if k.startswith("bn_") else 1)
                for k in TRAIN_KERNELS})
    finally:
        tmp.cleanup()


def groups_four_ranks(torch, card: str) -> None:
    """(c): four ranks of the CI ResNet with create_syncbn_process_group(2):
    the stem BN's statistics shared within each pair, not across, and
    equal to local BN over the pair's joined batch."""
    import os
    import tempfile

    from apex_tpu_torch.models import ResNet
    tmp = tempfile.TemporaryDirectory()
    try:
        t0 = time.perf_counter()
        rc, out = dp_children("groups", 4, tmp.name, 240.0)
        check(rc == 0, f"groups_4ranks: exit code {rc}\n{_dp_err(out, 4)}")
        rows = [json.load(open(os.path.join(out, f"groups{r}.json")))
                for r in range(4)]
        model = ResNet(block_sizes=(1, 1), bottleneck=True, num_classes=10,
                       width=8)
        params, state = model.init(0)
        errs = []
        for pair in ((0, 1), (2, 3)):
            x = torch.cat([torch.randn(
                4, 3, 32, 32, generator=torch.Generator().manual_seed(
                    rows[r]["x_seed"])) for r in pair]).cuda()
            _, new = model.apply(params, state, x, training=True)
            want = new["bn_stem"]["running_mean"].cpu()
            errs.append(max(float((torch.tensor(rows[r]["stem_mean"])
                                   - want).abs().max()) for r in pair))
        within = rows[0]["stem_mean"] == rows[1]["stem_mean"] and \
            rows[2]["stem_mean"] == rows[3]["stem_mean"]
        across = rows[0]["stem_mean"] != rows[2]["stem_mean"]
        emit({"phase": "data_parallel", "part": "groups_4ranks",
              "card": card, "backend": "gloo", "groups": [[0, 1], [2, 3]],
              "shared_within_pairs": within, "apart_across_pairs": across,
              "max_abs_vs_pair_batch": errs,
              "seconds": time.perf_counter() - t0})
        check(within and across and max(errs) <= 1e-5,
              f"groups_4ranks: within {within}, across {across}, "
              f"errors {errs}")
    finally:
        tmp.cleanup()


def data_parallel_phase(torch) -> dict:
    """Phase 43: data parallelism. (a) ``ddp_world1``; (b) ``ddp_2ranks``;
    (c) ``groups_4ranks``. Returns (a)'s launches."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    card = nvidia_smi("name,power.limit")
    totals, ref = ddp_world1(torch, card)
    gc.collect()
    torch.cuda.empty_cache()       # room for the ranks
    ddp_two_ranks(torch, card, ref)
    groups_four_ranks(torch, card)
    return totals


# -- phase 44: sequence, expert and pipeline parallelism ------------------------

T_IMPORT = time.perf_counter()

# (a)'s LM: tools/lm_bench.py --moe-experts 4 --moe-every 2 at S 2048, 8 heads
# of 128 (LMBENCH_r05_s2048_moe4top1_bf16.json's configuration)
MOE_LM = dict(batch=8, seq=2048, embed=1024, heads=8, layers=8, vocab=32768,
              experts=4, every=2)
MOE_WARM, MOE_TIMED = 3, 5
# launches of each kernel in one step of (a)'s LM: phase 9's, per layer
MOE_PER_STEP = {"flash_fwd": 8, "flash_bwd_dq": 8, "flash_bwd_dkv": 8,
                "ln_fwd": 17, "ln_bwd": 17, "adam": 1}
# (c)'s ring: phase 9's LM (16 heads of 64, S 4096) over 2 ranks of 2048;
# step 1 in fp32 within MP_REORDER_FACTOR times fp32's own effect on world
# 1's grad: the larger of its gap to its grad of the batch with its halves
# swapped (the token sums reordered, phase 43's control) and to its grad with
# the plain versions (the attention's sums reordered, which the ring's
# merge of two partials also does and the swap cannot show); the loss
# within the larger of DP_STEP1_LOSS and that factor of the effects' loss
# gaps; three faults planted in the ring (each rank attending only its own
# keys, the own shard's k_start one key early, the partials' lse detached
# before the merge) each outside that bar; the pipeline's and the expert-parallel grads within the JAX tests'
# tolerances (tests/test_pipeline.py, tests/test_moe.py), the absolute
# part taken of each tensor's largest entry
MP_REORDER_FACTOR = 2.0
MP_RING_STEPS = 3
PIPE_TOL = {"out": (1e-5, 1e-5), "grad": (1e-4, 1e-5)}     # rtol, atol
EXPERT_TOL = (1e-5, 1e-6)
PIPE_SHAPE = dict(batch=8, seq=2048, microbatches=4, stages=2)


def moe_lm_model(top_k: int = 1, **kw):
    """(a)'s TransformerLM: lm_bench's defaults (attn "fast", the fused
    head in vocab chunks of 8192) with 4 experts every 2nd layer."""
    from apex_tpu_torch.models import TransformerLM
    c = MOE_LM
    return TransformerLM(vocab_size=c["vocab"], max_seq_len=c["seq"],
                         embed_dim=c["embed"], num_heads=c["heads"],
                         num_layers=c["layers"], attn_impl="fast",
                         head_chunk=min(8192, c["vocab"]),
                         moe_experts=c["experts"], moe_every=c["every"],
                         moe_top_k=top_k, **kw)


def moe_lm_batch(torch, device="cuda"):
    """(a)'s token batch: 8 × 2048 from RandomState(4)."""
    import numpy as np
    c = MOE_LM
    return torch.from_numpy(np.random.RandomState(4).randint(
        0, c["vocab"], (c["batch"], c["seq"])).astype(np.int64)).to(device)


def moe_lm_phase(torch, dispatch, card: str) -> dict:
    """(a): lm_bench's MoE step, top 1 and top 2: 3 steps (loss finite and
    falling, the aux dropped fraction in [0, 1)), 5 timed (tok/s, step
    p50, peak memory; no MFU: lm_bench omits it for MoE), a profile of one
    top-1 step; then a small MoE LM kernels-vs-plain. Returns the timed
    steps' launches."""
    import gc

    from apex_tpu_torch.ops import flat
    from apex_tpu_torch.train import LMTrainer
    c = MOE_LM
    totals: dict = {}
    toks = moe_lm_batch(torch)
    for top_k in (1, 2):
        model = moe_lm_model(top_k)
        params = model.init(torch.Generator().manual_seed(5))
        tr = LMTrainer(model, params, lr=1e-4)
        del params
        r = timed_steps(torch, lambda: tr.step(toks), MOE_WARM, MOE_TIMED)
        counts = r["counts"]
        with torch.no_grad():
            p = flat.unflatten(tr.opt.state[0].master, tr.table,
                               dtype=torch.bfloat16)
            _, aux = model.apply(p, toks[:, :-1], return_hidden=True,
                                 return_aux=True)
            del p
        dropped = float(aux["moe_dropped_fraction"])
        balance = float(aux["moe_load_balance_loss"])
        prof = profile_steps(torch, lambda: tr.step(toks),
                             LM_KERNEL_FAMILIES, n=1) if top_k == 1 \
            else None
        tokens = c["batch"] * c["seq"]
        emit({"phase": "model_parallel", "part": f"moe_lm_top{top_k}",
              "card": card, "model": "TransformerLM", **c, "top_k": top_k,
              "capacity_factor": model.moe_capacity_factor,
              "attn_impl": "fast", "head_chunk": model.head_chunk,
              "dtype": "bfloat16", "masters": "float32",
              "optimizer": "FusedAdam(lr=1e-4)", "params": tr.table.total,
              **window_row(r, MOE_TIMED), "tokens_per_step": tokens,
              "tok_per_s": tokens * MOE_TIMED / r["wall"],
              "mfu_note": "omitted: dense param-count flop model "
                          "overcounts inactive experts",
              "aux_dropped_fraction": dropped,
              "aux_load_balance_loss": balance,
              "launches": {k: counts[k] for k in MOE_PER_STEP},
              "profile": prof})
        check_losses(f"moe_lm_top{top_k}", r["loss"])
        check(0.0 <= dropped < 1.0, f"moe_lm_top{top_k}: dropped fraction "
              f"{dropped} outside [0, 1)")
        check_counts(f"moe_lm_top{top_k}", counts,
                     {k: n * MOE_TIMED for k, n in MOE_PER_STEP.items()})
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n
        del tr, model, aux
        gc.collect()
        torch.cuda.empty_cache()
    moe_crosscheck_phase(torch, dispatch)
    return totals


def moe_crosscheck_phase(torch, dispatch):
    """A small MoE LM (2 layers, embed 128, 2 heads of 64, 4 experts in
    layer 1, vocab 512, S 256, batch 2) under ``adam_crosscheck`` at lr
    1e-3, at ``moe_top_k`` 1, 2 and 4, the experts each run chose
    recorded call by call. At top 1 and 2 the routing is discrete: a
    token whose best experts nearly tie (the router starts at scale 0.02,
    its probabilities near 1/4 each) changes expert on a rounding, and
    Adam carries the jump on, so there step 1's grad (from the same
    masters, the routing as good as fixed) is held and the masters' gap
    after 3 steps is printed beside the count of tokens that changed
    expert between the kernel run and the plain one, step by step. At top
    4 every token reaches every expert, the output is continuous in the
    router, and the masters are held too."""
    from apex_tpu_torch.contrib.moe import MoEMLP
    from apex_tpu_torch.models import TransformerLM
    toks = torch.randint(0, 512, (2, 257), generator=torch.Generator()
                         .manual_seed(3)).cuda()
    route = MoEMLP._route
    for top_k in (1, 2, 4):
        m = TransformerLM(vocab_size=512, max_seq_len=256, embed_dim=128,
                          num_heads=2, num_layers=2, attn_impl="fast",
                          head_chunk=512, moe_experts=4, moe_every=2,
                          moe_top_k=top_k)
        params = m.init(torch.Generator().manual_seed(2))
        chosen = []          # each forward's experts [tokens, k], in order

        def recording(self, p, x):
            probs, tope, gates = route(self, p, x)
            chosen.append(tope.detach().clone())
            return probs, tope, gates

        def flips():
            # runs: kernels, kernels again, plain bf16, plain fp32; one
            # MoE layer, so one route a step
            steps = len(chosen) // 4
            run = [chosen[i * steps:(i + 1) * steps] for i in range(4)]

            def moved(a, b):
                return [int((x != y).any(dim=-1).sum())
                        for x, y in zip(a, b)]
            return {"tokens": int(chosen[0].shape[0]),
                    "flipped_kernels_vs_plain": moved(run[0], run[2]),
                    "flipped_plain_bf16_vs_fp32": moved(run[2], run[3])}

        MoEMLP._route = recording
        try:
            adam_crosscheck(torch, dispatch, f"moe_crosscheck_top{top_k}",
                            m, params, (toks,), {}, {"lr": 1e-3},
                            hold_masters=top_k == 4, readings=flips)
        finally:
            MoEMLP._route = route


def moe_serve_model(torch, dtype):
    """(b)'s model: serve_bench's (phase 3) with 4 experts every 2nd
    layer, random weights from seed 0."""
    from apex_tpu_torch.models import TransformerLM
    model = TransformerLM(vocab_size=32768, max_seq_len=1024,
                          embed_dim=1024, num_heads=8, num_layers=8,
                          moe_experts=4, moe_every=2)
    return model, model.init(torch.Generator().manual_seed(0), dtype=dtype)


def moe_serve_phase(torch, card: str) -> dict:
    """(b): the engine serving an MoE LM. bf16, 16 requests at once
    (prompts 16-96, outputs 8-48): dense and paged engines warmed, their
    greedy streams equal, 0 captures after warmup, the captured run equal
    to ``programs.eager()``'s; decode step p50 and decode tok/s. In fp32
    (bf16 ties logits at their largest often: phase 36's gate) the
    engine's greedy streams equal ``generate``'s. Returns the captured
    runs' launches."""
    import gc

    from apex_tpu_torch.serve import (ContinuousBatchingEngine,
                                      poisson_requests, programs,
                                      summarize_serving)
    reqs = at_once(poisson_requests(
        16, rate=8.0, prompt_dist="uniform:16,96", new_dist="uniform:8,48",
        vocab_size=32768, seed=3, max_len=1024, prefill_chunk=32))
    model, params = moe_serve_model(torch, torch.bfloat16)
    totals: dict = {}
    streams = {}
    for name, kw in (("dense", {}), ("paged", dict(
            paged=True, page_size=32, kv_pages=8 * (1024 // 32) // 2))):
        eng = ContinuousBatchingEngine(model, params, slots=8, max_len=1024,
                                       prefill_chunk=32, **kw)
        warm = warm_engine(torch, eng)
        zero_counts()
        res, stats = eng.run(reqs)
        torch.cuda.synchronize()
        counts = read_counts()
        with programs.eager():
            e_res, _ = eng.run(reqs)
        summary = summarize_serving(res, stats, offered_rps=8.0)
        streams[name] = [r.tokens for r in res]
        row = {"phase": "model_parallel", "part": f"moe_serve_{name}",
               "card": card, "model": "serve_bench LM + MoE 4 every 2",
               "dtype": "bfloat16", "requests": len(res), **warm,
               "captures_after_warmup": captures_since(eng, warm),
               "captured_equals_eager": _stream_equal(res, e_res),
               "decode_steps": stats["decode_steps"],
               "decode_step_ms": summary["decode_step_ms"],
               "decode_tok_s": decode_tok_s(res, stats),
               "tokens_per_s": summary["tokens_per_s"],
               "ttft_ms": summary["ttft_ms"], "launches": counts}
        emit(row)
        check(row["captures_after_warmup"] == 0,
              f"moe_serve_{name}: {row['captures_after_warmup']} captures "
              f"after warmup")
        check(row["captured_equals_eager"],
              f"moe_serve_{name}: captured streams differ from eager")
        for r, q in zip(res, reqs):
            check(len(r.tokens) == q.max_new,
                  f"moe_serve_{name}: request {q.id} got {len(r.tokens)} "
                  f"of {q.max_new} tokens")
        kern = "paged_decode_attention" if name == "paged" \
            else "decode_attention"
        check(counts[kern] == model.num_layers * stats["decode_steps"],
              f"moe_serve_{name}: {kern} launched {counts[kern]} times "
              f"for {stats['decode_steps']} steps")
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    same = streams["dense"] == streams["paged"]
    del params
    # fp32: the engine against generate, request by request
    model32, p32 = moe_serve_model(torch, torch.float32)
    eng = ContinuousBatchingEngine(model32, p32, slots=8, max_len=1024,
                                   prefill_chunk=32)
    warm_engine(torch, eng)
    res, _ = eng.run(reqs[:8])
    gen_equal = []
    for r, q in zip(res, reqs[:8]):
        out = model32.generate(p32, torch.as_tensor(q.prompt)[None],
                               max_new_tokens=q.max_new)
        gen_equal.append(out[0, len(q.prompt):].tolist() == list(r.tokens))
    emit({"phase": "model_parallel", "part": "moe_serve_parity",
          "card": card, "paged_equals_dense": same,
          "engine_equals_generate_fp32": gen_equal})
    check(same, "moe_serve: paged streams differ from dense")
    check(all(gen_equal), f"moe_serve: the fp32 engine's greedy streams "
          f"differ from generate's {gen_equal}")
    del eng, p32
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def ring_lm(seq_axis=None):
    """(c)'s ring LM: phase 9's (lm_bench's defaults), over ``seq_axis``
    of 2 ranks when given."""
    from apex_tpu_torch.models import TransformerLM
    c = LM_SHAPE
    kw = dict(seq_axis=seq_axis, seq_axis_size=2) if seq_axis else {}
    return TransformerLM(vocab_size=c["vocab"], max_seq_len=c["seq"],
                         embed_dim=c["embed"], num_heads=c["heads"],
                         num_layers=c["layers"], attn_impl="fast",
                         head_chunk=min(8192, c["vocab"]), **kw)


def ring_reference(torch, dispatch) -> dict:
    """World 1's fp32 step-1 grad of the ring LM on the whole batch (the
    reference, kept in host memory) and fp32's own effects on it: its
    grad of the batch with its halves swapped (the sums over tokens in
    another order) and its grad with the plain versions (attention and
    LayerNorm summed in another order, as the ring's merge of two partials
    does)."""
    from apex_tpu_torch.train import LMTrainer
    model = ring_lm()
    params = model.init(torch.Generator().manual_seed(6))
    tr = LMTrainer(model, params, dtype=None)
    del params
    toks = lm_batch(torch)
    grad, loss = tr.loss_and_grad(toks)
    ref_grad, ref_loss = grad.cpu(), float(loss)
    del grad
    h = toks.shape[0] // 2
    grad, loss = tr.loss_and_grad(torch.cat([toks[h:], toks[:h]]))
    reorder = dp_step1(grad.cpu(), float(loss), ref_grad, ref_loss)
    del grad
    torch.cuda.empty_cache()
    with dispatch.backend("reference"):
        grad, loss = tr.loss_and_grad(toks)
    attention = dp_step1(grad.cpu(), float(loss), ref_grad, ref_loss)
    del grad, tr
    return {"grad": ref_grad, "loss": ref_loss, "reorder": reorder,
            "attention_order": attention}


def _rel_err(got, want, rtol: float, atol: float) -> float:
    """The largest |got - want| over rtol·|want| + atol·max|want| (the
    bar passes at <= 1)."""
    d = (got.float() - want.float()).abs()
    lim = rtol * want.float().abs() + atol * float(want.float().abs().max())
    return float((d / lim.clamp_min(1e-30)).max())


def mp_block(model):
    """One pre-LN block of ``model`` as GPipe's ``layer_fn``: its LayerNorm
    kernels and its attention (the flash kernels for "fast")."""
    mha = model._mha()

    def layer_fn(lp, h):
        a, _ = mha.apply(lp["attn"], model._ln(h, lp["ln1"]).transpose(0, 1),
                         is_training=False)
        h = h + a.transpose(0, 1)
        return h + model._mlp(model._ln(h, lp["ln2"]), lp["mlp"])
    return layer_fn


def mp_rank_ring(torch, rank, out, write) -> None:
    """train_ring's step on this rank's half of phase 9's batch: step 1 in
    fp32 (the reduced grad saved for the parent), the same under each of
    ``RING_FAULTS`` (rank 0's grad saved), then 3 bf16 steps."""
    import os

    from apex_tpu_torch.contrib.multihead_attn.flash_attention import \
        flash_attention
    from apex_tpu_torch.parallel import ring_attention as ra
    from apex_tpu_torch.train import SeqParallelTrainer
    toks = lm_batch(torch)
    t = toks.shape[1] // 2
    mine = toks[:, rank * t:(rank + 1) * t].contiguous()
    model = ring_lm("seq")
    params = model.init(torch.Generator().manual_seed(6))
    row = {"rank": rank}
    tr = SeqParallelTrainer(model, params, dtype=None)
    grad, _, loss = tr.global_grad(mine)
    torch.save(grad.cpu(), os.path.join(out, f"ring_grad{rank}.pt"))
    row["fp32_loss"] = float(loss)
    del grad

    # the faults, planted by swapping the ring module's flash_attention
    def local_only(q, k, v, **kw):
        # each rank attends only its own keys: the other rotations' partials
        # come back empty
        if kw["k_start"] != kw["q_start"]:
            return torch.zeros_like(q), torch.full(
                q.shape[:-1], ra.NEG_INF, device=q.device)
        return flash_attention(q, k, v, **kw)

    def kstart_early(q, k, v, **kw):
        # the own shard's k_start one key early: each row sees one key
        # past its own, its target
        if kw["k_start"] == kw["q_start"]:
            kw = dict(kw, k_start=kw["k_start"] - 1)
        return flash_attention(q, k, v, **kw)

    def lse_detached(q, k, v, **kw):
        # the merge's weights get no gradient
        o, lse = flash_attention(q, k, v, **kw)
        return o, lse.detach()

    for name, fault in (("local", local_only), ("kstart", kstart_early),
                        ("lse", lse_detached)):
        ra.flash_attention = fault
        try:
            grad, _, loss = tr.global_grad(mine)
        finally:
            ra.flash_attention = flash_attention
        if rank == 0:
            torch.save(grad.cpu(), os.path.join(out, f"ring_{name}.pt"))
        row[f"{name}_loss"] = float(loss)
        del grad
    del tr
    torch.cuda.empty_cache()
    tr = SeqParallelTrainer(model, params)          # bf16, O2
    del params
    zero_counts()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(MP_RING_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for a, b in events:
        a.record()
        losses.append(tr.step(mine))
        b.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from apex_tpu_torch.parallel import collectives as C
    tokens = toks.shape[0] * toks.shape[1]
    row.update({"bf16_losses": [float(v) for v in losses],
                "step_ms": sorted(a.elapsed_time(b) for a, b in events),
                "wall_s": wall, "tok_per_s": tokens * MP_RING_STEPS / wall,
                "launches": read_counts(),
                "collectives_last_step": C.collective_bytes()})
    del tr
    torch.cuda.empty_cache()
    write(f"ring{rank}.json", row)


def mp_rank_ulysses(torch, rank, write) -> None:
    """One Ulysses forward and backward at [8, 16, 2048 a rank, 64] bf16,
    causal, against flash_attention over the whole sequence (this rank's
    rows), under the flash rule."""
    from apex_tpu_torch.contrib.multihead_attn.flash_attention import \
        flash_attention
    from apex_tpu_torch.parallel.ring_attention import ulysses_attention
    g = torch.Generator(device="cuda").manual_seed(7)
    b, h, s, d = 8, 16, 4096, 64
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(4))
    t = s // 2
    sl = slice(rank * t, (rank + 1) * t)
    mine = [x[:, :, sl].clone().requires_grad_(True) for x in (q, k, v)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = ulysses_attention(*mine, "seq", 2, causal=True)
    grads = torch.autograd.grad(o, mine, do[:, :, sl])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    whole = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o_ref = flash_attention(*whole, causal=True)
    refs = torch.autograd.grad(o_ref, whole, do)
    errs = {"o": flash_err(torch, o, o_ref[:, :, sl])}
    for n, a, r in zip(("dq", "dk", "dv"), grads, refs):
        errs[n] = flash_err(torch, a, r[:, :, sl])
    write(f"ulysses{rank}.json", {"rank": rank, "shape": [b, h, t, d],
                                  "seconds": sec, "err": errs})


def mp_rank_pipeline(torch, rank, write) -> None:
    """GPipe over 2 stages of the ring LM's 8 blocks (4 a stage, its
    LayerNorm and flash kernels), 4 microbatches of [2, 2048, 1024] fp32,
    loss mean((out - y)²): the output and this stage's grads against the
    serial stack's."""
    from apex_tpu_torch.ops import flat
    from apex_tpu_torch.parallel.pipeline import (gpipe, stack_layers,
                                                  unstack_layers)
    c = PIPE_SHAPE
    model = ring_lm()
    params = model.init(torch.Generator().manual_seed(8))
    layers = [params[f"layer_{i}"] for i in range(model.num_layers)]
    del params
    fn = mp_block(model)
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(c["batch"], c["seq"], model.embed_dim, generator=g,
                    device="cuda")
    y = torch.randn(x.shape, generator=g, device="cuda")
    per = model.num_layers // c["stages"]
    local = stack_layers(layers[rank * per:(rank + 1) * per])
    leaves = flat.tree_leaves(local)
    for t_ in leaves:
        t_.requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = gpipe(fn, local, x, axis_name="pipe", num_stages=c["stages"],
                num_microbatches=c["microbatches"])
    loss = torch.mean((out - y) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    serial = stack_layers(layers)
    s_leaves = flat.tree_leaves(serial)
    for t_ in s_leaves:
        t_.requires_grad_(True)
    h = x
    for lp in unstack_layers(serial):
        h = fn(lp, h)
    s_loss = torch.mean((h - y) ** 2)
    s_grads = torch.autograd.grad(s_loss, s_leaves)
    grad_used = max(_rel_err(a, b[rank * per:(rank + 1) * per],
                             *PIPE_TOL["grad"])
                    for a, b in zip(grads, s_grads))
    write(f"pipe{rank}.json", {
        "rank": rank, **c, "seconds": sec, "loss": float(loss),
        "serial_loss": float(s_loss),
        "out_used": _rel_err(out.detach(), h.detach(), *PIPE_TOL["out"]),
        "grad_used": grad_used})


def mp_rank_expert(torch, rank, write) -> None:
    """(a)'s MoE LM (top 1) in fp32 with its experts split over the 2
    ranks (``expert_axis``), on (a)'s batch: the loss and grads against
    the dense model's from the same params."""
    from apex_tpu_torch.ops import flat
    dense = moe_lm_model(1)
    params = dense.init(torch.Generator().manual_seed(5))
    toks = moe_lm_batch(torch)
    leaves = flat.tree_leaves(params)
    for t_ in leaves:
        t_.requires_grad_(True)
    loss_d = dense.loss(params, toks)
    g_d = torch.autograd.grad(loss_d, leaves)
    ep = moe_lm_model(1, expert_axis="expert", expert_axis_size=2)
    el = MOE_LM["experts"] // 2
    local = {}
    for name, lp in params.items():
        if isinstance(lp, dict) and "moe" in lp:
            moe = {k: (v if k == "router" else v[rank * el:(rank + 1) * el])
                   for k, v in lp["moe"].items()}
            lp = dict(lp, moe=moe)
        local[name] = lp
    l_leaves = [t_.detach().clone().requires_grad_(True)
                for t_ in flat.tree_leaves(local)]
    local = flat.tree_unflatten(flat.tree_flatten(local)[1], l_leaves)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_p = ep.loss(local, toks)
    g_p = torch.autograd.grad(loss_p, l_leaves)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    used = 0.0
    for (path, a), b in zip(zip(flat.tree_paths(flat.tree_flatten(
            local)[1]), g_p), g_d):
        if "moe" in path and path[-1] != "router":
            b = b[rank * el:(rank + 1) * el]
        used = max(used, _rel_err(a, b, *EXPERT_TOL))
    write(f"expert{rank}.json", {
        "rank": rank, "seconds": sec, "loss": float(loss_p),
        "dense_loss": float(loss_d), "grad_used": used,
        "loss_used": abs(float(loss_p) - float(loss_d))
        / (EXPERT_TOL[0] * abs(float(loss_d)))})


def mp_rank_main(argv) -> int:
    """A rank of phase 44 (``chip_smoke.py --mp-rank DIR``, started by
    ``launch.multiproc``): gloo over CUDA tensors, one group bound as
    ``"seq"``, ``"pipe"`` and ``"expert"``; the ring, Ulysses, GPipe and
    expert-parallel parts in turn, results in DIR."""
    import os

    out = argv[0]
    rank = int(os.environ["RANK"])
    if rank == 0:       # the launcher leaves rank 0 on the phase's output
        fd = os.open(os.path.join(out, "rank0.log"),
                     os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
    import torch
    import torch.distributed as dist

    from apex_tpu_torch.ops import cuda as kcuda
    from apex_tpu_torch.parallel import collectives as C
    from apex_tpu_torch.parallel import launch, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launch.initialize("gloo", device="cuda",
                      init_method=f"file://{os.path.join(out, 'store')}",
                      timeout=300)
    make_mesh({"seq": 2}, device="cuda")
    for name in ("pipe", "expert"):
        C.bind_axis(name, None, device_type="cuda")
    kcuda.lib()
    check(kcuda.build_seconds is None, "mp rank: the kernels were rebuilt")

    def write(name, obj):
        path = os.path.join(out, name)
        with open(path + ".tmp", "w") as f:
            json.dump(obj, f)
        os.replace(path + ".tmp", path)

    mp_rank_ring(torch, rank, out, write)
    mp_rank_ulysses(torch, rank, write)
    torch.cuda.empty_cache()
    mp_rank_pipeline(torch, rank, write)
    torch.cuda.empty_cache()
    mp_rank_expert(torch, rank, write)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mp_children(torch, dispatch, card: str) -> None:
    """(c): world 1's fp32 references, then two children of this script
    (``--mp-rank``, through ``launch.multiproc``) and the checks of what
    they wrote."""
    import gc
    import os
    import tempfile

    from apex_tpu_torch.parallel import launch
    t0 = time.perf_counter()
    ref = ring_reference(torch, dispatch)
    gc.collect()
    torch.cuda.empty_cache()        # room for the ranks
    ref_s = time.perf_counter() - t0
    tmp = tempfile.TemporaryDirectory()
    try:
        out = tmp.name
        t0 = time.perf_counter()
        rc = launch.multiproc(os.path.abspath(__file__), 2, "--mp-rank", out,
                              log_dir=out, timeout=600.0)
        check(rc == 0, f"model_parallel ranks: exit code {rc}\n"
              f"{_dp_err(out, 2)}")
        ranks_s = time.perf_counter() - t0

        def load(name):
            return [json.load(open(os.path.join(out, f"{name}{r}.json")))
                    for r in range(2)]
        ring, uly, pipe, expert = (load(n) for n in ("ring", "ulysses",
                                                     "pipe", "expert"))
        grads = [torch.load(os.path.join(out, f"ring_grad{r}.pt"))
                 for r in range(2)]
        reorder, attention = ref["reorder"], ref["attention_order"]
        bar = {k: MP_REORDER_FACTOR * max(reorder[k], attention[k])
               for k in ("grad_mean", "grad_max")}
        bar["loss"] = max(DP_STEP1_LOSS, MP_REORDER_FACTOR * max(
            reorder["loss"], attention["loss"]))
        step1 = dp_step1(grads[0], ring[0]["fp32_loss"], ref["grad"],
                         ref["loss"])
        faults = {name: dp_step1(torch.load(os.path.join(
            out, f"ring_{name}.pt")), ring[0][f"{name}_loss"], ref["grad"],
            ref["loss"]) for name in ("local", "kstart", "lse")}
        ranks_equal = torch.equal(grads[0], grads[1]) and \
            ring[0]["fp32_loss"] == ring[1]["fp32_loss"] and \
            ring[0]["bf16_losses"] == ring[1]["bf16_losses"]
        r0 = ring[0]
        emit({"phase": "model_parallel", "part": "ring", "card": card,
              "backend": "gloo", "device": "cuda", **LM_SHAPE,
              "seq_per_rank": LM_SHAPE["seq"] // 2,
              "note": "train_ring's step (SeqParallelTrainer): grads summed "
                      "over seq; ppermute and all_to_all staged through "
                      "host buffers (gloo has no CUDA send/recv)",
              "fp32_step1_vs_world1": step1, "step1_bar": bar,
              "fp32_reorder_effect_world1": reorder,
              "fp32_attention_order_effect_world1": attention,
              "step1_over_reorder": {
                  k: step1[k] / reorder[k] if reorder[k] else None
                  for k in ("grad_mean", "grad_max")},
              "faults_step1": faults,
              "ranks_equal": ranks_equal, "bf16_losses": r0["bf16_losses"],
              "bf16_step_ms_p50": statistics.median(r0["step_ms"]),
              "bf16_tok_per_s": r0["tok_per_s"],
              "launches_3_steps": r0["launches"],
              "collectives_last_step": r0["collectives_last_step"],
              "reference_s": ref_s, "ranks_s": ranks_s})
        check(dp_within(step1, bar), f"ring: fp32 step 1 {step1} from world "
              f"1, over {bar}")
        for name, gap in faults.items():
            check(not dp_within(gap, bar), f"ring: the planted fault "
                  f"{name} {gap} passes the bar {bar}")
        check(ranks_equal, "ring: the two ranks' losses or grads differ")
        check_losses("ring_bf16", r0["bf16_losses"])
        check_counts("ring_bf16", r0["launches"], {
            "flash_fwd": 2 * 8 * MP_RING_STEPS,
            "flash_bwd_dq": 2 * 8 * MP_RING_STEPS,
            "flash_bwd_dkv": 2 * 8 * MP_RING_STEPS,
            "ln_fwd": 17 * MP_RING_STEPS, "ln_bwd": 17 * MP_RING_STEPS,
            "adam": MP_RING_STEPS})
        used = max(e["used"] for u in uly for e in u["err"].values())
        emit({"phase": "model_parallel", "part": "ulysses", "card": card,
              "shape_per_rank": uly[0]["shape"], "causal": True,
              "dtype": "bfloat16", "seconds": uly[0]["seconds"],
              "err": [u["err"] for u in uly], "flash_rule_used": used})
        check(used <= 1.0, f"ulysses: {used} of the flash rule")
        pused = max(max(p["out_used"], p["grad_used"]) for p in pipe)
        emit({"phase": "model_parallel", "part": "pipeline", "card": card,
              "dtype": "float32", "layers": LM_SHAPE["layers"],
              "tolerances": PIPE_TOL, "ranks": pipe, "used": pused})
        check(pused <= 1.0, f"pipeline: {pused} of the JAX tests' "
              f"tolerance {PIPE_TOL}")
        eused = max(max(e["grad_used"], e["loss_used"]) for e in expert)
        emit({"phase": "model_parallel", "part": "expert", "card": card,
              "dtype": "float32", "experts_per_rank": MOE_LM["experts"] // 2,
              "tolerance": EXPERT_TOL, "ranks": expert, "used": eused})
        check(eused <= 1.0, f"expert: {eused} of the JAX tests' tolerance "
              f"{EXPERT_TOL}")
    finally:
        tmp.cleanup()


def model_parallel_phase(torch, dispatch) -> dict:
    """Phase 44: (a) ``moe_lm``, (b) ``moe_serve``, (c) the ring, Ulysses,
    GPipe and expert parallelism over two gloo ranks. Returns (a)'s and
    (b)'s launches."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    card = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    totals = moe_lm_phase(torch, dispatch, card)
    t1 = time.perf_counter()
    for k, n in moe_serve_phase(torch, card).items():
        totals[k] = totals.get(k, 0) + n
    t2 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    mp_children(torch, dispatch, card)
    emit({"phase": "model_parallel", "part": "seconds", "card": card,
          "started_at": t0 - T_IMPORT, "moe_lm": t1 - t0,
          "moe_serve": t2 - t1,
          "children": time.perf_counter() - t2})
    return totals


def model_parallel_main() -> int:
    """``--model-parallel``: phases 0, 1 and 44 alone."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from apex_tpu_torch.ops import cuda as kcuda
    from apex_tpu_torch.ops import dispatch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(nvidia_smi("name,power.limit"), flush=True)
    t0 = time.perf_counter()
    kcuda.lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    counts = model_parallel_phase(torch, dispatch)
    emit({"phase": "model_parallel", "part": "launches", "counts": counts,
          "seconds": time.perf_counter() - T_IMPORT})
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on an NVIDIA card", file=sys.stderr)
        return 2

    from apex_tpu_torch.ops import cuda as kcuda
    from apex_tpu_torch.ops import dispatch
    from apex_tpu_torch.serve import poisson_requests

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 0. device
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 1. build
    t0 = time.perf_counter()
    kcuda.lib()
    ptxas = ptxas_table(kcuda.build_log)
    # the flash forward's and backward's Hopper kernels, every form:
    # registers at entry (setmaxnreg gives the consumers more) and spills,
    # which must be none
    flash_fwd = {n: e for n, e in ptxas.items() if "flash_fwd_kernel" in n}
    flash_bwd = {n: e for n, e in ptxas.items()
                 if "flash_dq_kernel" in n or "flash_dkv_kernel" in n
                 or "flash_dkv_split_kernel" in n}
    # the fp32 backward in 3xTF32: dq and dk/dv at D 64 and 128 and the
    # pair kernels at 256, plain and with a bias or dropout; the fp32
    # forward likewise, at D 64, 128 and 256
    flash_f32 = {n: e for n, e in ptxas.items()
                 if any(k in n for k in F32_BWD_KERNELS)}
    flash_f32_fwd = {n: e for n, e in ptxas.items() if "f32_fwd_kernel" in n}
    # of those, the forward's, dq's and dk/dv's forms at head dim 256 (the
    # template argument 256 in their mangled names)
    flash_d256 = {n: e for n, e in {**flash_fwd, **flash_bwd}.items()
                  if "Li256E" in n}
    # the bf16/fp16 forward, dq and dk/dv at D 384 and 512 (flash_d512.cu,
    # flash_d512_dkv.cu), and the fp32 ones in 3xTF32 (flash_f32_d512.cu)
    flash_d512 = {n: e for n, e in ptxas.items()
                  if any(k in n for k in (
                      "flash_fwd_d512_kernel", "flash_dq_d512_kernel",
                      "flash_dv_d512_kernel", "flash_dk_d512_kernel"))}
    flash_f32_d512 = {n: e for n, e in ptxas.items()
                      if any(k in n for k in (
                          "f32x_fwd_kernel", "f32x_dq_kernel",
                          "f32x_dkv_kernel"))}
    # the shared-bias gradient at every head dim (flash_dbias.cu): bf16 and
    # fp16 on wgmma, fp32 in 3xTF32
    flash_dbias = {n: e for n, e in ptxas.items()
                   if "flash_tc_dbias_kernel" in n
                   or "flash_f32_dbias_kernel" in n}
    # the one-pass wide LayerNorm backward (csrc/ln_bwd_row.cu): every
    # form's registers and spills; its shared memory is dynamic, so beside
    # them the plans of phase 2's readings, as the C side computes them
    ln_row = {n: e for n, e in ptxas.items()
              if "ln_wide_bwd_row_kernel" in n}
    from apex_tpu_torch.ops import layer_norm as LN
    ln_row_plans = {f"{rows}x{f} {dt}" + ("" if w else " plain"):
                    LN.row_plan(rows, f, xs, w)
                    for rows, f, dt, xs, w in LN_ROW_PLANS}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": kcuda.build_seconds is not None, "ptxas": ptxas,
          "flash_fwd_ptxas": flash_fwd, "flash_bwd_ptxas": flash_bwd,
          "flash_f32_ptxas": flash_f32,
          "flash_f32_fwd_ptxas": flash_f32_fwd,
          "flash_d256_ptxas": flash_d256, "flash_d512_ptxas": flash_d512,
          "flash_f32_d512_ptxas": flash_f32_d512,
          "flash_dbias_ptxas": flash_dbias, "ln_bwd_row_ptxas": ln_row,
          "ln_bwd_row_plans": ln_row_plans})
    # bf16 and fp16: 2 x 9 forward forms (3 kinds at D 64, 128, 256) and
    # 2 x 12 backward (dq and dk/dv, plain and extra, at D 64, 128, 256),
    # 6 + 8 of them at D 256; fp32: 12 backward and 6 forward (plain and
    # extra at D 64, 128, 256); at D 384 and 512 2 x 6 forward forms (3
    # kinds), 2 x 4 dq, 2 x 4 dv and 2 x 4 dk (plain and extra), and in
    # fp32 2 x 2 forward, 2 x 2 dq and 2 x 2 dk/dv (plain and extra); the
    # shared-bias gradient's bf16, fp16 and fp32 kernels; the one-pass
    # wide LN backward's 56 (bf16 and fp16 rows: 4 gammas by 4 load widths;
    # fp32: 4 by 3, whole rows and 2-block clusters)
    check(not kcuda.build_seconds or len(ln_row) == 56,
          f"ptxas reported {len(ln_row)} one-pass wide LN backward forms, "
          f"not 56")
    check(all(e.get("spill_bytes", 0) == 0 for e in ln_row.values()),
          f"the one-pass wide LN backward spills: {ln_row}")
    check(not kcuda.build_seconds or (len(flash_fwd) == 18
                                      and len(flash_bwd) == 24
                                      and len(flash_d256) == 14
                                      and len(flash_f32) == 12
                                      and len(flash_f32_fwd) == 6
                                      and len(flash_d512) == 36
                                      and len(flash_f32_d512) == 12
                                      and len(flash_dbias) == 3),
          f"ptxas reported {len(flash_fwd)} forward, {len(flash_bwd)} "
          f"backward ({len(flash_d256)} at D 256), {len(flash_f32)} fp32 "
          f"backward, {len(flash_f32_fwd)} fp32 forward, "
          f"{len(flash_d512)} D-384/512, {len(flash_f32_d512)} fp32 "
          f"D-384/512 and {len(flash_dbias)} shared-bias gradient flash "
          f"forms, not 18, 24 (14), 12, 6, 36, 12 and 3")
    for what, forms in (("forward", flash_fwd), ("backward", flash_bwd),
                        ("fp32 backward", flash_f32),
                        ("fp32 forward", flash_f32_fwd),
                        ("D-384/512", flash_d512),
                        ("fp32 D-384/512", flash_f32_d512),
                        ("shared-bias gradient", flash_dbias)):
        check(all(e.get("spill_bytes", 0) == 0 for e in forms.values()),
              f"the flash {what} kernels spill: {forms}")

    # 2. kernels against their plain versions; the training kernels over
    # the RN50 master store's layout
    from apex_tpu_torch.models import resnet50
    from apex_tpu_torch.ops import flat
    rn50 = resnet50()
    rn50_params, rn50_state = rn50.init(0)
    timer = Timer(torch)
    rows = kernel_phase(torch, timer)
    rows.update(train_kernel_phase(torch, timer,
                                   flat.make_table(rn50_params)))
    bn_calls = rn50_bn_calls(rn50, 256, 224)
    check(sum(bn_calls.values()) == 53, f"RN50 has 53 BNs, got {bn_calls}")
    rows.update(welford_kernel_phase(torch, timer, bn_calls))
    # the LM step's kernels over its flat master store's size
    lm = lm_model()
    lm_params = lm.init(torch.Generator().manual_seed(0))
    rows.update(lm_kernel_phase(torch, timer,
                                flat.make_table(lm_params).total))
    # the ImageNet step's optimizer kernels over the RN50 master store
    rows.update(optimizer_kernel_phase(torch, timer,
                                       flat.make_table(rn50_params)))
    # the Seq2Seq step's softmax cross-entropy and kv_bias flash kernels
    rows.update(s2s_kernel_phase(torch, timer))
    # the rest of the flash kernels at the ViT step's shape: dropout, the
    # full bias, dq's dS and the shared-bias gradient; the mask read-back
    rows.update(vit_kernel_phase(torch, timer))
    # the accumulation and fp16_utils kernels over the LM's master store,
    # and impl="auto"'s crossover
    rows.update(accum_kernel_phase(torch, timer,
                                   flat.make_table(lm_params).total))
    flash_crossover_phase(torch)
    # at head dim 256: the D-256 forward, dq and dk/dv
    flash_crossover_phase(torch, "bfloat16", 256)
    # the wide LayerNorm at the wide LM's rows and the other wide shapes
    rows.update(wide_kernel_phase(torch, timer))
    # the split decode kernel at head dim 64 and its merge; the flash
    # kernels' fp16 forms and the simple form; the scalar tails
    rows.update(decode_kernel_phase(torch, timer))
    # the multi-row form (speculative scoring) at phase 36's rows
    rows.update(decode_rows_phase(torch, timer))
    rows.update(flash_forms_phase(torch, timer))
    emit({"phase": "flash_bits", **flash_bits(torch)})
    emit({"phase": "ln_wide_bits", **ln_wide_bits(torch)})
    rows.update(tail_kernel_phase(torch, timer))
    emit({"phase": "timer", "calls": timer.calls, "redone": timer.redone,
          "waiting": timer.waiting, "seconds": timer.seconds})

    # 3-4. the serving slice, dense then paged
    model, params = serve_model(torch)
    reqs = poisson_requests(32, rate=8.0, prompt_dist="uniform:16,96",
                            new_dist="uniform:8,48", vocab_size=32768,
                            seed=0, max_len=1024, prefill_chunk=32)
    dense, dstats, dcounts = serve_phase(torch, "dense", model, params, reqs,
                                         graphs="dense")
    check(dcounts["decode_attention"]
          == model.num_layers * dstats["decode_steps"],
          f"dense: decode_attention launched {dcounts['decode_attention']}"
          f" times for {dstats['decode_steps']} steps")
    check(dcounts["ln_fwd"] > 0, "dense: ln_fwd never launched")
    check(dcounts["paged_decode_attention"] == 0,
          "dense: the paged kernel ran on the dense arena")
    paged, pstats, pcounts = serve_phase(
        torch, "paged", model, params, reqs, graphs="paged", paged=True,
        page_size=32, kv_pages=8 * (1024 // 32) // 2)
    check(pcounts["paged_decode_attention"]
          == model.num_layers * pstats["decode_steps"],
          "paged: paged_decode_attention count != layers x steps")
    check(pcounts["ln_fwd"] > 0, "paged: ln_fwd never launched")
    check(pcounts["decode_attention"] == 0,
          "paged: the dense kernel ran on the paged arena")
    same = [a.tokens == b.tokens for a, b in zip(dense, paged)]
    emit({"phase": "paged_vs_dense", "requests_equal": sum(same),
          "requests": len(same)})
    check(all(same), "paged token streams differ from dense")

    # 5. the model with the kernels against the plain versions
    crosscheck_phase(torch, dispatch)

    # 6-8. the training slice
    del timer
    tcounts, _ = train_phase(torch, rn50, rn50_params, rn50_state,
                             bn_calls)
    # 11-12. the ImageNet example's step on the same model
    icounts = imagenet_phases(torch, rn50, rn50_params, rn50_state,
                              bn_calls)
    del rn50_params, rn50_state
    overflow_phase(torch)
    train_crosscheck_phase(torch, dispatch)

    # 9-10. the LM training slice, with train_ring's accumulation and the
    # fp16_utils path on the same model and batch
    lcounts, lrow = lm_train_phase(torch, lm, lm_params)
    acounts, _ = lm_accum_phase(torch, dispatch, lm, lm_params,
                                lrow["peak_mem_bytes"])
    fcounts, _ = fp16opt_adagrad_phase(torch, dispatch, lm, lm_params)
    del lm_params
    lm_crosscheck_phase(torch, dispatch)
    fp16opt_crosscheck_phase(torch, dispatch)

    # 13. the ImageNet step with the kernels against the plain versions
    imagenet_crosscheck_phase(torch, dispatch)

    # 14-16. the Seq2Seq Transformer's translation step, its greedy
    # decode and the small model against the plain versions
    s2s = s2s_model()
    s2s_params = s2s.init(torch.Generator().manual_seed(0))
    scounts, s2s_master, s2s_table = s2s_train_phase(torch, s2s, s2s_params)
    del s2s_params
    s2s_dec_counts = s2s_decode_phase(torch, s2s, s2s_master, s2s_table)
    del s2s_master
    s2s_crosscheck_phase(torch, dispatch)

    # 20-22. main_amp's ViT-B/16 step with attention dropout, a small ViT
    # against the plain versions, and the public entry point's learned
    # bias (the shared-bias gradient kernel's path)
    vit = vit_model()
    vit_params = vit.init(torch.Generator().manual_seed(0))
    vcounts, _ = vit_train_phase(torch, vit, vit_params)
    del vit_params
    vit_crosscheck_phase(torch, dispatch)
    bcounts = flash_bias_phase(torch, dispatch)

    # 23-25. bn_backward_reduce's entry point over the RN50 step's BNs;
    # lm_bench's LM at GPT-3 175B's width, every LayerNorm by the wide
    # kernels; a wide LM against the plain versions
    ncounts = bn_reduce_phase(torch, bn_calls)
    wcounts, _ = wide_lm_train_phase(torch)
    wide_lm_crosscheck_phase(torch, dispatch)

    # 26-27. lm_bench's LM served at full width (16 heads of 64), dense and
    # paged, the split decode kernel at head dim 64 in every step
    mcounts, mpcounts = lm_serve_phases(torch, reqs)
    # 28-29. lm_bench's LM trained in fp16 (O2, dynamic scale: the
    # tensor-core kernels' fp16 forms) and in fp32 (O0: the 3xTF32 kernels)
    lm_params = lm.init(torch.Generator().manual_seed(0))
    hcounts = lm_dtype_phase(torch, lm, lm_params, "lm_train_f16",
                             torch.float16, 3, 5, F16_PER_STEP)
    f32counts = lm_dtype_phase(torch, lm, lm_params, "lm_train_f32", None,
                               2, 3, F32_PER_STEP)
    del lm_params
    # 30. FusedLayerNorm(1022) and SyncBatchNorm(6) trained; flash at D 256
    # in fp32 and at D 320 in bf16 and fp32
    tl_counts = tails_train_phase(torch)
    # 31-32. lm_bench's LM at 8 heads of 256: the D-256 forward and dq in
    # every step; the small LM at head dim 256 against the plain versions
    d256_counts = lm_hd256_train_phase(torch, torch.bfloat16)
    lm_hd256_crosscheck_phase(torch, dispatch)
    # 33. the same LM in fp32: the 3xTF32 forward, dq and dk/dv at D 256
    d256_f32_counts = lm_hd256_train_phase(torch)

    # 34. the DCGAN example's three-loss step under O1
    gan_counts, _ = dcgan_phase(torch, dispatch)
    # 35. lm_bench's LM with --remat (phase 9's masters); remat under O1 on
    # the small LM, and in a small ViT and Seq2Seq
    lm_params = lm.init(torch.Generator().manual_seed(0))
    remat_counts, _ = lm_remat_phase(torch, dispatch, lm_params,
                                     lrow["peak_mem_bytes"])
    del lm_params

    # 36-38. speculative decoding on phase 3's model and traffic with the
    # fp32 parity gate (and phase 39's serialized engine); the
    # shared-prefix cache on phase 4's engine; sampled generate and the
    # MLP. Phase 39's rows ride with phases 3-4 and 36-37, on their engines
    from apex_tpu_torch.serve import summarize_serving
    spec_counts = serve_spec_phase(
        torch, model, params, reqs,
        summarize_serving(dense, dstats, offered_rps=8.0))
    prefix_counts = serve_prefix_phase(torch, model, params, reqs)
    generate_mlp_phase(torch, model, params)
    # 41. the router tier on phase 3's model: in-process replicas, the
    # admission window, and replicas in other processes
    router_counts = serve_router_phase(torch, model, params)

    # 42. the telemetry sidecar in the engine, the DCGAN loop and the
    # serving tools
    telemetry_counts = telemetry_phase(torch, model, params)

    # 43. data parallelism: bench.py's ddp and zero arms on an NCCL group
    # of one; two gloo ranks and four (SyncBN groups) on the one card
    dp_counts = data_parallel_phase(torch)

    # 44. sequence, expert and pipeline parallelism: lm_bench's MoE step,
    # the engine serving an MoE LM, and two gloo ranks on the one card
    mp_counts = model_parallel_phase(torch, dispatch)

    # 40. the kernels line, then the contract line
    launches = {k: dcounts[k] + pcounts[k] for k in dcounts}
    launches.update({k: tcounts[k] for k in TRAIN_KERNELS})
    for k in LM_PER_STEP:                # ln_fwd: serving and training
        launches[k] += lcounts[k]
    for counts in icounts.values():      # scale and BN: both RN50 steps
        for k in TRAIN_KERNELS + IMAGENET_KERNELS:
            launches[k] += counts[k]
    for k in S2S_PER_STEP:               # the translation step and decode
        launches[k] += scounts[k] + s2s_dec_counts[k]
    for counts in (acounts, fcounts):    # accumulation, fp16_utils
        for k, n in counts.items():
            launches[k] += n
    for k in VIT_PER_STEP:               # the ViT step
        launches[k] += vcounts[k]
    for k, n in bcounts.items():         # the learned-bias entry point
        launches[k] += n
    for k in ("ln_fwd_wide", "ln_bwd_wide"):     # the wide LM step
        launches[k] += wcounts[k]
    launches["bn_backward_reduce"] += ncounts["bn_backward_reduce"]
    for counts in (mcounts, mpcounts):   # lm_bench's LM served
        for k in ("decode_attention", "paged_decode_attention",
                  "decode_merge", "ln_fwd"):
            launches[k] += counts[k]
    for counts, per in ((hcounts, F16_PER_STEP), (f32counts, F32_PER_STEP)):
        for k in per:                    # the fp16 and fp32 LM steps
            launches[k] += counts[k]
    for k in TAIL_KERNELS:               # the fault inputs trained
        launches[k] += tl_counts[k]
    for k in HD256_PER_STEP:             # the LM at 8 heads of 256
        launches[k] += d256_counts[k]
    for k in HD256_F32_PER_STEP:         # and in fp32
        launches[k] += d256_f32_counts[k]
    for k in DCGAN_PER_STEP:             # the DCGAN step: unscale, Adam
        launches[k] += gan_counts[k]
    for k, n in remat_counts.items():    # remat, and O1's fp32 forms
        launches[k] += n
    for counts in spec_counts + (prefix_counts,):  # spec, prefix share
        for k in ("decode_attention", "paged_decode_attention",
                  "decode_attention_rows", "paged_decode_attention_rows",
                  "decode_merge", "ln_fwd"):
            launches[k] += counts[k]
    for k, n in router_counts.items():   # the router's replicas
        launches[k] += n
    for k, n in telemetry_counts.items():  # telemetry armed, DCGAN fit
        launches[k] += n
    for k, n in dp_counts.items():       # ddp and zero at world 1
        launches[k] += n
    for k, n in mp_counts.items():       # the MoE LM trained and served
        launches[k] += n
    sources = {
        "decode_attention": (
            "apex_tpu_torch/ops/cuda/csrc/decode_attn.cu",
            "apex_tpu/ops/pallas/decode_attn.py:53"),
        "paged_decode_attention": (
            "apex_tpu_torch/ops/cuda/csrc/decode_attn.cu",
            "apex_tpu/ops/pallas/decode_attn.py:122"),
        # the same kernel with Q query rows a slot (speculative scoring),
        # where the JAX package flattens the rows into the slot axis
        "decode_attention_rows": (
            "apex_tpu_torch/ops/cuda/csrc/decode_attn.cu",
            "apex_tpu/ops/pallas/decode_attn.py:53"),
        "paged_decode_attention_rows": (
            "apex_tpu_torch/ops/cuda/csrc/decode_attn.cu",
            "apex_tpu/ops/pallas/decode_attn.py:122"),
        "ln_fwd": ("apex_tpu_torch/ops/cuda/csrc/layer_norm.cu",
                   "apex_tpu/ops/pallas/layer_norm.py:51"),
        "scale": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                  "apex_tpu/ops/pallas/multi_tensor.py:96"),
        "lamb_phase1": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                        "apex_tpu/ops/pallas/multi_tensor.py:452"),
        "lamb_phase2": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                        "apex_tpu/ops/pallas/multi_tensor.py:480"),
        "bn_moments": ("apex_tpu_torch/ops/cuda/csrc/welford.cu",
                       "apex_tpu/ops/pallas/welford.py:60"),
        "bn_backward_fused_reduce": (
            "apex_tpu_torch/ops/cuda/csrc/welford.cu",
            "apex_tpu/ops/pallas/welford.py:94"),
        "bn_backward_dx": ("apex_tpu_torch/ops/cuda/csrc/welford.cu",
                           "apex_tpu/ops/pallas/welford.py:152"),
        "adam": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                 "apex_tpu/ops/pallas/multi_tensor.py:270"),
        "ln_bwd": ("apex_tpu_torch/ops/cuda/csrc/layer_norm.cu",
                   "apex_tpu/ops/pallas/layer_norm.py:105"),
        "flash_fwd": ("apex_tpu_torch/ops/cuda/csrc/flash_fwd.cu",
                      "apex_tpu/contrib/multihead_attn/flash_attention.py"
                      ":181"),
        "flash_bwd_dq": ("apex_tpu_torch/ops/cuda/csrc/flash_bwd.cu",
                         "apex_tpu/contrib/multihead_attn/"
                         "flash_attention.py:349"),
        "flash_bwd_dkv": ("apex_tpu_torch/ops/cuda/csrc/flash_bwd.cu",
                          "apex_tpu/contrib/multihead_attn/"
                          "flash_attention.py:392"),
        "rowsumsq": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                     "apex_tpu/ops/pallas/multi_tensor.py:197"),
        "rowmaxabs": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                      "apex_tpu/ops/pallas/multi_tensor.py:219"),
        "sgd": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                "apex_tpu/ops/pallas/multi_tensor.py:354"),
        "novograd": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                     "apex_tpu/ops/pallas/multi_tensor.py:393"),
        "xent_fwd": ("apex_tpu_torch/ops/cuda/csrc/xentropy.cu",
                     "apex_tpu/ops/pallas/xentropy.py:55"),
        "xent_bwd": ("apex_tpu_torch/ops/cuda/csrc/xentropy.cu",
                     "apex_tpu/ops/pallas/xentropy.py:131"),
        "axpby": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                  "apex_tpu/ops/pallas/multi_tensor.py:127"),
        "l2norm": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                   "apex_tpu/ops/pallas/multi_tensor.py:169"),
        "adagrad": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                    "apex_tpu/ops/pallas/multi_tensor.py:322"),
        # the shared-bias gradient at every head dim: bf16/fp16 on wgmma,
        # fp32 in 3xTF32 (two kernels of one file, one wrapper)
        "flash_bwd_dbias": ("apex_tpu_torch/ops/cuda/csrc/flash_dbias.cu",
                            "apex_tpu/contrib/multihead_attn/"
                            "flash_attention.py:427"),
        "ln_fwd_wide": ("apex_tpu_torch/ops/cuda/csrc/layer_norm.cu",
                        "apex_tpu/ops/pallas/layer_norm.py:201"),
        # to F 16384 (every path's width) the one-pass kernel; past it
        # layer_norm.cu's chunked ln_wide_bwd_reduce_kernel and
        # ln_wide_bwd_dx_kernel
        "ln_bwd_wide": ("apex_tpu_torch/ops/cuda/csrc/ln_bwd_row.cu",
                        "apex_tpu/ops/pallas/layer_norm.py:288"),
        "bn_backward_reduce": ("apex_tpu_torch/ops/cuda/csrc/welford.cu",
                               "apex_tpu/ops/pallas/welford.py:216"),
        # a helper pass of the dense and paged decode sites (rows 1-2):
        # the split decode's second kernel, which merges their chunks
        "decode_merge": ("apex_tpu_torch/ops/cuda/csrc/decode_attn.cu",
                         "apex_tpu/ops/pallas/decode_attn.py:53"),
        # the simple form: fp32, and head dims past 128
        "flash_simt_fwd": ("apex_tpu_torch/ops/cuda/csrc/flash_simt.cu",
                           "apex_tpu/contrib/multihead_attn/"
                           "flash_attention.py:181"),
        "flash_simt_dq": ("apex_tpu_torch/ops/cuda/csrc/flash_simt.cu",
                          "apex_tpu/contrib/multihead_attn/"
                          "flash_attention.py:349"),
        "flash_simt_dkv": ("apex_tpu_torch/ops/cuda/csrc/flash_simt.cu",
                           "apex_tpu/contrib/multihead_attn/"
                           "flash_attention.py:392"),
        "flash_simt_dbias": ("apex_tpu_torch/ops/cuda/csrc/flash_simt.cu",
                             "apex_tpu/contrib/multihead_attn/"
                             "flash_attention.py:427"),
        # the fp32 backward at D <= 128 on the tensor cores, 3xTF32
        "flash_f32_dq": ("apex_tpu_torch/ops/cuda/csrc/flash_f32.cu",
                         "apex_tpu/contrib/multihead_attn/"
                         "flash_attention.py:349"),
        "flash_f32_dkv": ("apex_tpu_torch/ops/cuda/csrc/flash_f32.cu",
                          "apex_tpu/contrib/multihead_attn/"
                          "flash_attention.py:392"),
        # the fp32 forward at D <= 128 on the tensor cores, 3xTF32
        "flash_f32_fwd": ("apex_tpu_torch/ops/cuda/csrc/flash_f32.cu",
                          "apex_tpu/contrib/multihead_attn/"
                          "flash_attention.py:181"),
        # the bf16/fp16 forward and dq at D 129-256 on the tensor cores
        "flash_d256_fwd": ("apex_tpu_torch/ops/cuda/csrc/flash_fwd.cu",
                           "apex_tpu/contrib/multihead_attn/"
                           "flash_attention.py:181"),
        "flash_d256_dq": ("apex_tpu_torch/ops/cuda/csrc/flash_bwd.cu",
                          "apex_tpu/contrib/multihead_attn/"
                          "flash_attention.py:349"),
        "flash_d256_dkv": ("apex_tpu_torch/ops/cuda/csrc/flash_bwd.cu",
                           "apex_tpu/contrib/multihead_attn/"
                           "flash_attention.py:392"),
        # the bf16/fp16 forward and dq at D 257-512 on the tensor cores
        "flash_d512_fwd": ("apex_tpu_torch/ops/cuda/csrc/flash_d512.cu",
                           "apex_tpu/contrib/multihead_attn/"
                           "flash_attention.py:181"),
        "flash_d512_dq": ("apex_tpu_torch/ops/cuda/csrc/flash_d512.cu",
                          "apex_tpu/contrib/multihead_attn/"
                          "flash_attention.py:349"),
        # the fp32 forward and dq at D 257-512 in 3xTF32
        "flash_f32_d512_fwd": (
            "apex_tpu_torch/ops/cuda/csrc/flash_f32_d512.cu",
            "apex_tpu/contrib/multihead_attn/flash_attention.py:181"),
        "flash_f32_d512_dq": (
            "apex_tpu_torch/ops/cuda/csrc/flash_f32_d512.cu",
            "apex_tpu/contrib/multihead_attn/flash_attention.py:349"),
        # dk/dv at D 257-512: bf16/fp16 on the tensor cores, fp32 in 3xTF32
        "flash_d512_dkv": ("apex_tpu_torch/ops/cuda/csrc/flash_d512_dkv.cu",
                           "apex_tpu/contrib/multihead_attn/"
                           "flash_attention.py:392"),
        "flash_f32_d512_dkv": (
            "apex_tpu_torch/ops/cuda/csrc/flash_f32_d512.cu",
            "apex_tpu/contrib/multihead_attn/flash_attention.py:392"),
    }
    # the simple forward, dq, dk/dv and shared-bias gradient: no path of
    # the port takes them since every dtype and head dim up to 512 has a
    # tensor-core form (their launches on the paths are 0); phase 2 still
    # builds, holds and times them, and their readings ride beside the
    # kernels line's
    off_path = ("flash_simt_fwd", "flash_simt_dq", "flash_simt_dkv",
                "flash_simt_dbias")
    # the wide wrappers each take the place of more than one TPU kernel
    also_replaces = {
        "ln_fwd_wide": ["apex_tpu/ops/pallas/layer_norm.py:227"],
        "ln_bwd_wide": ["apex_tpu/ops/pallas/layer_norm.py:310",
                        "apex_tpu/ops/pallas/layer_norm.py:331"]}
    row_keys = {"decode_attention": ("decode_attention", "bfloat16"),
                "paged_decode_attention": ("paged_decode_attention",
                                           "bfloat16"),
                # S 8, Q 4, H 8, hd 128, rows around 900, bf16
                "decode_attention_rows": ("decode_attention_rows",
                                          "bfloat16"),
                "paged_decode_attention_rows": (
                    "paged_decode_attention_rows", "bfloat16"),
                "ln_fwd": ("ln_fwd", "bfloat16", 8),
                # the training kernels at the step's own dtype (fp32
                # master grads and state)
                "scale": ("scale", "float32"),
                "lamb_phase1": ("lamb_phase1", "float32"),
                "lamb_phase2": ("lamb_phase2", "float32"),
                # the BN passes summed over the step's 53 BNs, bf16 rows
                "bn_moments": ("bn_moments", "bfloat16"),
                "bn_backward_fused_reduce": ("bn_backward_fused_reduce",
                                             "bfloat16"),
                "bn_backward_dx": ("bn_backward_dx", "bfloat16"),
                # the LM step's kernels at its shapes
                "adam": ("adam", "float32"), "ln_bwd": ("ln_bwd", "bfloat16"),
                "flash_fwd": ("flash_fwd", "bfloat16"),
                "flash_bwd_dq": ("flash_bwd_dq", "bfloat16"),
                "flash_bwd_dkv": ("flash_bwd_dkv", "bfloat16"),
                # the ImageNet step's optimizer kernels over RN50's buffer
                **{k: (k, "float32") for k in IMAGENET_KERNELS},
                # the translation step's loss over its fp32 logits
                "xent_fwd": ("xent_fwd", "float32"),
                "xent_bwd": ("xent_bwd", "float32"),
                # accumulation and fp16_utils over the LM's master store
                **{k: (k, "float32") for k in ACCUM_KERNELS},
                # the shared [1, 197, 197] bias's gradient at the ViT shape
                "flash_bwd_dbias": ("flash_bwd_dbias", "bfloat16"),
                # the wide LM's rows, [8192, 12288] bf16; the welford
                # reduce from xhat summed over the RN50 step's 53 BNs
                "ln_fwd_wide": ("ln_fwd_wide", "lm"),
                "ln_bwd_wide": ("ln_bwd_wide", "lm"),
                "bn_backward_reduce": ("bn_backward_reduce", "bfloat16"),
                "decode_merge": ("decode_merge", "bfloat16"),
                # the simple form at the LM's shape in fp32
                "flash_simt_fwd": ("flash_simt_fwd", "f32"),
                "flash_simt_dq": ("flash_simt_dq", "f32"),
                "flash_simt_dkv": ("flash_simt_dkv", "f32"),
                # the simple shared-bias gradient at [32, 1024, 256] fp32
                "flash_simt_dbias": ("flash_simt_dbias", "d256_f32"),
                "flash_f32_dq": ("flash_f32_dq", "f32"),
                "flash_f32_dkv": ("flash_f32_dkv", "f32"),
                "flash_f32_fwd": ("flash_f32_fwd", "f32"),
                # the D-256 kernels at the hd-256 LM's [64, 4096, 256]
                "flash_d256_fwd": ("flash_d256_fwd", "hd256_lm_bf16"),
                "flash_d256_dq": ("flash_d256_dq", "hd256_lm_bf16"),
                "flash_d256_dkv": ("flash_d256_dkv", "hd256_lm_bf16"),
                # the D-384/512 kernels at [32, 1024, 320] (phase 30's
                # D-320 pass, read at twice its bh)
                "flash_d512_fwd": ("flash_d512_fwd", "d320_tc_bf16"),
                "flash_d512_dq": ("flash_d512_dq", "d320_tc_bf16"),
                # the fp32 D-384/512 kernels at [32, 1024, 320] (phase
                # 30's fp32 D-320 pass, read at twice its bh)
                "flash_f32_d512_fwd": ("flash_f32_d512_fwd", "d320_f32x"),
                "flash_f32_d512_dq": ("flash_f32_d512_dq", "d320_f32x"),
                # dk/dv at D 384 at the same readings
                "flash_d512_dkv": ("flash_d512_dkv", "d320_tc_bf16"),
                "flash_f32_d512_dkv": ("flash_f32_d512_dkv", "d320_f32x")}
    sub = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
           "library_ms")
    kernels, off = [], []
    for name, (src, repl) in sources.items():
        r = rows[row_keys[name]]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": repl, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            # the same kernels with the source's key-padding kv_bias, at
            # the translation step's encoder and cross-attention shapes
            entry["kv_bias"] = {
                shape: {k: rows[(name, "kv_bias", shape)][k] for k in sub}
                for shape in ("encoder", "cross")}
            # at the ViT step's [B·H, 197, 64]: dropout 0.1, and a learned
            # bias shared over bh or one per bh
            vit_shape = [VIT_BH, VIT_S, VIT_D]
            entry["dropout"] = {"shape": vit_shape, **{
                k: rows[(name, "vit", "dropout")][k] for k in sub[1:]}}
            entry["bias"] = {
                nb: {"shape": vit_shape, **{
                    k: rows[(name, "vit", reading)][k] for k in sub[1:]}}
                for nb, reading in (("shared", "bias"),
                                    ("per_bh", "bias_bh"))}
        if name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            # at the wide LM's [384, 2048, 128]
            entry["wide"] = {k: rows[(name, "wide")][k] for k in sub}
        if name in ("flash_bwd_dq", "flash_bwd_dkv"):
            # the whole backward (flash_delta, dq and dk/dv in one timed
            # call) at both shapes
            entry["backward"] = {
                shape: {k: rows[("flash_bwd", key)][k] for k in sub}
                for shape, key in (("lm", "bfloat16"), ("wide", "wide"))}
        if name in ("flash_bwd_dbias", "flash_simt_dbias"):
            # causal at [128, 1024, 64] bf16; at D 256 and 320 in bf16 and
            # fp32 and ViT's shape in fp32 (the simple form's time beside)
            entry["causal"] = {k: rows[(name, "causal")].get(k)
                               for k in sub}
            entry["readings"] = {
                reading: {k: rows[(name, reading)].get(k)
                          for k in sub + ("bound_fma_ms", "simple_ms")
                          if k in rows[(name, reading)]}
                for reading in DBIAS_READINGS}
        if name == "flash_simt_dbias":
            entry["vit_bf16"] = {k: rows[(name, "bfloat16")].get(k)
                                 for k in sub}
        if name in ("decode_attention_rows", "paged_decode_attention_rows"):
            # fp32 and head dim 64; the JAX package's layout beside
            entry["readings"] = {
                reading: {k: rows[(name, reading)].get(k)
                          for k in sub + ("flattened_ms", "one_row_calls_ms",
                                          "flattened_expand_ms")
                          if k in rows[(name, reading)]}
                for reading in ("bfloat16", "float32", "hd64")}
        if name in ("decode_attention", "paged_decode_attention"):
            # lm_bench's serving shape, head dim 64
            entry["hd64"] = {k: rows[(name, "hd64", "bfloat16")][k]
                             for k in sub}
        if name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            # the fp16 forms at the LM's and the wide LM's shapes
            entry["f16"] = {reading: {k: rows[(name, reading)][k]
                                      for k in sub}
                            for reading in ("f16", "f16_wide")}
        if name in ("ln_fwd", "ln_bwd", "ln_fwd_wide", "ln_bwd_wide",
                    "bn_moments", "bn_backward_fused_reduce",
                    "bn_backward_dx"):
            # the scalar tails (and, for the welford passes, C 8 beside)
            entry["tails"] = {str(key[2]): {k: rows[key].get(k)
                                            for k in sub}
                              for key in rows
                              if key[0] == name and key[1:2] == ("tail",)}
        if name in ("flash_f32_fwd", "flash_f32_dq", "flash_f32_dkv"):
            # the bound at fp32 FMAs' rate; the simple form on the inputs
            entry["bound_fma_ms"] = r["bound_fma_ms"]
            entry["simple_ms"] = r["simple_ms"]
        if name in ("flash_f32_fwd", "flash_f32_dq", "flash_f32_dkv"):
            # at phase 30's [32, 1024, 256]
            entry["d256"] = {k: rows[(name, "d256_f32")].get(k)
                             for k in sub + ("bound_fma_ms", "simple_ms")}
        if name in ("flash_f32_dq", "flash_f32_dkv"):
            # at phase 33's [64, 4096, 256] (the pair kernels)
            entry["hd256_lm"] = {
                k: rows[(name, "hd256_lm_f32")].get(k)
                for k in sub + ("bound_fma_ms", "simple_ms")}
        if name in ("flash_simt_fwd", "flash_simt_dq", "flash_simt_dkv"):
            # at the head dims it is kept for: tails_train's [32, 1024,
            # 256] in fp32 (dq and dk/dv), bf16 past 256; the bf16 D-256
            # reading is the one the D-256 kernels replaced, the fp32
            # forward's the one the 3xTF32 forward replaced
            entry["d256"] = {dt: {k: rows[(name, f"d256_{dt}")][k]
                                  for k in sub}
                             for dt in ("bf16", "f32")}
            entry["d320"] = {dt: {k: rows[(name, f"d320_{dt}")][k]
                                  for k in sub}
                             for dt in ("bf16", "f32")}
        if name in ("flash_d256_fwd", "flash_d256_dq", "flash_d256_dkv"):
            # [32, 1024, 256] in bf16 (the simple form's time on the same
            # inputs beside it) and fp16; the LM's shape in fp16
            entry["readings"] = {
                reading: {k: rows[(name, reading)].get(k)
                          for k in sub + ("simple_ms",)}
                for reading in ("d256_tc_bf16", "d256_tc_f16",
                                "hd256_lm_f16")}
        if name in ("flash_d256_dq", "flash_d256_dkv"):
            # the whole backward (flash_delta, dq and dk/dv in one timed
            # call) at the hd-256 LM's [64, 4096, 256]
            entry["backward"] = {
                k: rows[("flash_bwd", "hd256_lm_bf16")][k] for k in sub}
        if name in ("flash_d512_fwd", "flash_d512_dq", "flash_d512_dkv"):
            # the simple form's time on the same inputs; fp16, and [16,
            # 1024, 512] in both
            entry["simple_ms"] = r["simple_ms"]
            entry["readings"] = {
                reading: {k: rows[(name, reading)].get(k)
                          for k in sub + ("simple_ms",)}
                for reading in ("d320_tc_f16", "d512_tc_bf16",
                                "d512_tc_f16")}
        if name in ("flash_d512_dq", "flash_d512_dkv"):
            # the whole backward at [32, 1024, 320]: flash_delta, dq and
            # dk/dv in one timed call
            entry["backward"] = {
                k: rows[("flash_bwd", "d320_tc_bf16")][k] for k in sub}
        if name in ("flash_f32_d512_fwd", "flash_f32_d512_dq",
                    "flash_f32_d512_dkv"):
            # the bound at fp32 FMAs' rate, the simple form's time on the
            # same inputs; [16, 1024, 512]
            entry["bound_fma_ms"] = r["bound_fma_ms"]
            entry["simple_ms"] = r["simple_ms"]
            entry["readings"] = {"d512_f32x": {
                k: rows[(name, "d512_f32x")].get(k)
                for k in sub + ("bound_fma_ms", "simple_ms")}}
        if name in ("flash_f32_d512_dq", "flash_f32_d512_dkv"):
            # the whole backward at [32, 1024, 320] in fp32: flash_delta,
            # dq and dk/dv in one timed call
            entry["backward"] = {
                k: rows[("flash_bwd", "d320_f32x")][k] for k in sub}
        if name in also_replaces:
            entry["also_replaces"] = also_replaces[name]
            entry["readings"] = {
                key[1]: {k: rows[key].get(k) for k in sub}
                for key in rows
                if len(key) == 2 and key[0] == name and key[1] != "lm"}
        (off if name in off_path else kernels).append(entry)
    check(len(kernels) == 42 and all(e["launches"] > 0 for e in kernels)
          and len(off) == 4 and all(e["launches"] == 0 for e in off),
          f"kernels line: {[(e['name'], e['launches']) for e in kernels]}, "
          f"off the paths: {[(e['name'], e['launches']) for e in off]}")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "nvidia_smi": nvidia_smi(
              "clocks.sm,power.draw,power.limit,temperature.gpu")})
    emit({"kernels": kernels, "off_path": off})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--router-replica"]:
        sys.exit(router_replica_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--ddp-rank"]:
        sys.exit(ddp_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--mp-rank"]:
        sys.exit(mp_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--model-parallel"]:
        sys.exit(model_parallel_main())
    sys.exit(main())
