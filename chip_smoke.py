#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with one GPU visible:

    python3 chip_smoke.py            # every phase; last line is the result
    python3 chip_smoke.py --quick    # phases 1-3c, 6 and 8 (builds + kernels)

Phases, each printed on its own line; the first failed check exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``); f32 matmuls
   must run in full f32 (``allow_tf32`` off), and so must the port's f32
   convolutions (cuDNN's TF32 is on by default; ``ops.nn.convolution``
   turns it off for its call): within 1e-5 of a float64 convolution.
2. build: compile the CUDA kernel libraries from ``mxnet_tpu_torch/csrc``,
   one ``nvcc`` per library, all started together (the flash kernels build
   one library per (q/k, v) dtype pair); each kernel's registers
   and spills as ``ptxas -v`` reports them, under the kernel's name (no
   ``conv1x1_pair`` kernel may spill, no kernel of ``int8_dense`` or
   ``stable_ops``, nor a ``decode_attention`` kernel for D <= 128).
3. kernel: the decode-attention kernel against its plain PyTorch version
   on the card at Llama-3-8B shapes (H=32, KV=8, D=128; f32 and int8 rings),
   each case with its grid (``split_plan``: splits, blocks, workspace) and
   two calls that must repeat bit for bit; at the main path's shape its
   time, its bound, the plain version's time, the time of the same grid
   with no live position (the launch pair's floor) and, for f32, the time
   of one ``scaled_dot_product_attention`` call as a yardstick. Then a
   context sweep (S = 1024-8192, B = 1 and 4, every row at start_pos =
   S - 1; each point checked against the plain version, timed against its
   bound and, in f32, the library) and a split-aim sweep (the grid aimed at
   1, 2 and 4 blocks a SM, at the main shape and at B=4, S=8192).
3b. int8: the int8 x int8 product (``ops.hopper.int8_dense``: row
   quantization on a cluster of blocks a row, then int8 products into
   int32 with the rescale fused: the weight-streaming ``decode`` kernel for
   decode and verify rows, M <= 32, and ``wgmma`` + TMA for prefill rows,
   both on an aligned weight; ``mma.sync`` for ragged or misaligned
   weights; each call must take the kernel ``route_for`` names; the decode
   kernel's tile, stages, bytes in flight and shared memory printed) at every
   Llama-3-8B projection shape, (O, U) = (4096, 4096), (1024, 4096),
   (14336, 4096), (4096, 14336) at M = 1, 4, 20, 256 and 1024 and the head
   (128256, 4096) at M = 1, 4 and 20, and at M = 3, O = 37, U = 30 and on a
   misaligned x and weight. Activations are seeded normals with a row of
   zeros and a row of exact .5 ties, weights uniform in +-0.07 (the
   model's) quantized per channel. The kernel must equal its plain version
   bit for bit, two calls must repeat bit for bit, and each row's RMS
   error against the exact product with the unquantized weight must stay
   within 1.6e-2 of its RMS output (printed beside the largest error over
   the row's largest |output|, and beside the same reading of the
   algorithm with truncation in place of rounding, which the limit tells
   apart). At M = 1, 4, 20, 256 and 1024: the call's time, K1
   (quantization) and the product alone, the ``mma.sync`` kernel's product
   on the same call (the tile kernel: the yardstick of the other two; at
   M <= 20 the call and both products also after a flush that leaves L2
   clean, ``_clean_l2``), its bound (bytes at 3.35 TB/s or
   int8 operations at 1,979 TOP/s) and share of it, the plain version,
   the weight-only route (``F.linear(x, qweight.float()) * scale``), f32
   ``F.linear`` on the f32 weight (the ``pallas`` rung's) and
   ``torch._int_mm`` where it takes the shape; then their sums over one
   forward's products (225 at M <= 20, 224 at prefill) against 2.24 ms, the
   weight bytes of one decode forward at 3.35 TB/s. Then the host's
   microseconds a call at M = 4, O = 1024, U = 4096 and at M = 1024,
   O = U = 4096 (200 calls an arm back to back, in 10 rounds with the
   arms in turn), beside f32 ``F.linear``'s; at M = 4 also on a misaligned
   copy of the weight (the ``mma.sync`` route), which the decode route's
   may not exceed by more than 15%.
3c. stable: the strict ``baseline`` rung's shape-stable kernels
   (``ops.hopper.stable_ops``, whose arithmetic for one output is a
   function of the reduced length alone), each against its plain version
   within STABLE_REL of the largest |output| and two calls bit for bit:
   S1 (``stable_dense``) at every Llama-3-8B projection shape at 1024 rows
   (the head at 20), rows at M = 1 and 4 bit for bit the same rows inside
   that call (first, middle and last places), the ring-fed prefill tile
   bit for bit every other instantiation (the first prefill tile, which
   loads from global memory, and each decode tile) at M = 256 and 1024 at
   the four layer shapes and at a ragged (1000, 37, 4095) with a bias,
   every instantiation bit for bit the others at M = 24, misaligned copies
   (scalar loads, 4-byte copies) bit for bit the aligned call at decode
   and prefill rows, a ragged U with a bias; S2 (the mul+reduce
   ``cached_attention``) at B = 4, H = 32, KV = 8, D = 128 over a
   1024-position ring at T = 1 (the middle of a generate; the heads
   kernel) and T = 256 (the rows kernel), the rows kernel bit for bit the
   heads kernel at T = 256 from position 0 and from mid-ring and at MHA
   D = 30, GQA D = 256 and D = 30 (aligned and misaligned), a T = 1 query
   bit for bit the same row inside T = 256, misaligned rings; S3 (the row
   norm) at 1024 rows of 4096 (4 rows bit for bit inside them), misaligned
   and a ragged 4095. No kernel may spill. Times: S1 at M = 4, 256 and
   1024 for each shape and over one forward (225 products at decode rows,
   a prefill's 224 above), at prefill rows the first prefill tile beside
   the plan's, S2 at T = 1 and 256 over one forward's 32 layers (at 256
   the heads kernel beside the rows kernel), S3 at 4 and 1024 rows over
   one forward's 65 and 64, each beside its bound (bytes at 3.35 TB/s or
   its f32 products at three TF32 passes; S1 also beside its f32 FMAs at
   67 TFLOP/s, the bound of a design that keeps the f32 FMA chains), its
   plain version and the library call for the same function (f32
   ``F.linear``; f32 ``scaled_dot_product_attention`` on the expanded heads
   with a boolean mask; ``F.rms_norm``); and whether each library call,
   and the port's own ``ops.nn.rms_norm``, is itself row-invariant at these
   shapes (printed, no gate).
4. serve pallas / 5. serve int8: Llama-3-8B at full width and depth with
   seeded random weights, served by ``Generator`` (warmup, then 4 prompts x
   32 greedy tokens): every decode step of every layer must launch the
   kernel, no shape may be new after warmup, and the greedy tokens must be
   identical to a run with the plain attention forced. On ``int8`` that
   run's tokens are printed (with their first divergence and logit gaps):
   the route's last-bit differences move activations across int8
   rounding steps (C4). There every plain call of that run must agree
   with the kernel on the same inputs (within ATOL plus 1e-4 of the batch
   row's largest |output|), the first decode step's logits on the two
   routes, from the same prefill and token, must lie within 0.5 of their
   norm of each other (the gap after every few layers printed), and a
   third generate runs every kernel
   launch also through the plain version on the same inputs (within ATOL
   plus 1e-4 of the batch row's largest |output|) and must repeat the
   timed run's tokens. ``int8`` runs with
   int8 weights (``MXNET_SERVE_DECODE_INT8_WEIGHTS=auto`` on the card,
   ``int8_weights=True`` printed): every forward launches the int8 product
   7 x 32 + 1 = 225 times (a prefill's 224 layer products on the wgmma
   kernel at M = 1024, its head and every decode step's on the decode
   kernel at M = 4, none on ``mma.sync``; phase 5 checks the counts by
   kernel and rows, and the JSON line's int8 rows are those pairs),
   ``pallas``
   none, in this phase and in 5a-5c and
   5f (prefills and decode iterations, counted at graph replays; 5d and 5e
   serve ``pallas``: none). The int8 rung's prefill logits' gap to the
   ``pallas`` rung's is printed (no gate), and each rung's prefill ms: the
   generate's reading and three synchronised prefills alone.
serve baseline (after 5, before 5a): the strict rung on the same model
   and prompts (``Generator(decode_path="baseline")``, buckets (1, 4) x
   (64, 256), 32 greedy tokens): every forward launches S1 225 times, S2 32
   and S3 65 (by rows: a prefill's layer products at 1024 rows, its head
   and every decode step at 4; S2's prefill on its rows kernel, its decode
   steps on the heads kernel), nothing is new after warmup; at decode
   steps 1 and 6 every row's logits are bit for bit those of a fresh full
   prefill of its prefix at bucket 256; a paged ``Generator``'s prefill
   and decode logits are bit for bit the ring run's and its tokens the
   same; a multi-step (N = 8, CUDA graphs) run and a ``ContinuousEngine``
   ((1, 256) prefill chunks, 4 slots) give the single-step tokens; with
   ``MXNET_SERVE_STRICT_PARITY=1`` a default ``Generator`` serves the rung
   and its tokens. Printed: decode ms a token, prefill ms (beside
   STABLE_FIRST_PREFILL_MS, the first stable kernels' reading), the
   phase's seconds, the tokens' agreement with the ``pallas`` rung and the
   prefill logits' gap to it (no gate: other products give other last
   bits).
5a. multistep pallas / multistep int8: the same model and prompts through
   ``Generator(multistep=True, decode_steps=8)``, batch buckets (1, 4):
   ``warmup()`` captures every super-step CUDA graph (its signatures,
   graphs and capture seconds printed), then three 32-token greedy
   generates, each timed. The tokens must be identical to that rung's
   single-step phase; a generate must take 4 host visits and launch the
   kernel 32 layers x 8 iterations x 4 visits = 1024 times (counted at
   every graph replay); no graph may be captured after warmup. Then a run
   with the plain attention forced (its graphs are captured on that route)
   must give the same tokens (on ``int8``: the tokens of phase 5's
   forced-plain run, C4) and launch no kernel. Printed: decode ms a
   token, tokens/s, host visits a token, peak memory.
5b. paged: on both rungs the same prompts through ``paged=True``, single-
   and multi-step, must give the ring run's tokens; then two prompts
   sharing a 64-token prefix go through ``prefix_cache=True`` (multi-step)
   twice: the second run must match a nonzero prefix, and both runs must
   give the tokens of a ring run of the same prompts.
5c. continuous: ``ContinuousEngine(max_seq=1024, num_slots=4,
   page_size=natural_block(), prefill_chunk=256, prefix_cache=True)`` on
   both rungs, single-step and multi-step (``decode_steps=8``): after
   ``warmup()`` (the multi-step engine captures its four graphs), the
   prompts of phases 4-5 submitted at once for 32 greedy tokens must give
   that rung's phase 4-5 tokens (on a mismatch the row, the step and the
   logit gap are printed); then a churn of 12 seeded requests (prompts of
   8-300 tokens, two over one chunk, 4-40 new tokens) submitted at once
   through the 4 slots must each give the tokens of a batch-1
   ``Generator`` run of its prompt; then two prompts sharing a 64-token
   prefix, submitted one after the other, must match a nonzero prefix
   and give the tokens of a prefix miss. Before each rung, prompt 2's K
   prefilled at (4, 256) and at (1, 256) is compared: on ``pallas``
   within 1e-2 of the largest |K| at the first and last layer. On
   ``int8`` the two differ in whole quantization steps, so greedy tokens
   depend on the shapes a request runs at and on the attention route:
   there single-step holds every kernel launch of part 1 and the churn
   to the plain version on the same inputs (the engine's pages, dead
   lanes and scales; within 1e-5 plus 1e-4 of the batch row's largest
   |output|; its readings include that extra work), multi-step must give single-step's tokens, and the
   agreement with phases 4-5, the batch-1 runs and the same engine with
   the plain attention forced is printed, with the prompt bucket of each
   churn request that differs from its batch-1 run. The kernel must
   launch 32 layers x the
   decode iterations the engine ran (counted at every graph replay), no
   shape or graph may be new after warmup, and every page must be free
   once the trie is cleared. Printed: TTFT and ITL p50/p95, decode ms a
   token, tokens/s, host visits a token, peak memory: readings of a burst
   of 4 (or 12) requests, not server metrics, which
   ``python -m mxnet_tpu_torch.serve_load`` takes under sustained load.
5d. tenancy: ``ModelRegistry(max_models=1)`` over two tenants behind
   5c's multi-step engine settings (``pallas``): the Llama serves the
   prompts of phases 4-5, loading the random 2-layer draft evicts it, and
   serving it again reloads it through its factory. Both serves must give
   the phase 4-5 tokens; one eviction of each tenant and one reload are
   counted; no graph is captured after a ``warmup()``; every page is
   free once the tries are cleared. Printed: each load's seconds (factory,
   engine build, warmup with its graph captures).
5e. fleet: a ``Router`` over two ``Replica`` s, each a single-step
   ``pallas`` ``Generator`` sharing the model, serves the prompts twice
   (8 requests at once) with a ``die`` injected at replica 0's third
   dispatch. Every request settles once with the phase 4 tokens of its
   prompt; at least one failover is counted; each flusher thread runs its
   runner with the device current and under ``inference_mode``; the
   kernel launches (read once the fleet is drained) equal 32 x the decode
   steps the replicas ran.
5f. speculative (last of the Llama phases: it changes the weights): the
   target's layers 2-31 get zero ``o_proj``/``down_proj`` (their cost
   stays, their output is 0); a 2-layer draft is copied from the target's
   embedding, first two layers, norm and head, and the random 2-layer
   draft of 5d is the other. On both rungs, k = 4, buckets (1, 4): the
   target's own single-step ``Generator`` gives the reference tokens, then
   ``SpeculativeGenerator`` with each draft, single- and multi-step. On
   ``pallas`` the tokens must equal the reference; on ``int8`` multi-step
   must equal single-step and the agreement with the reference is printed
   (with the first differing step and its logit gap). A multi-step round
   must be 2 host visits (one draft replay, one verify replay); the
   kernel launches must be the draft's 2 layers x 5 iterations x rounds
   (the verify graph launches none); nothing is captured after
   ``warmup()``; on ``int8`` a verify replay launches the int8 product 225
   times and the 2-layer draft 15 a forward. Printed: decode ms a token,
   tokens a round, acceptance,
   host visits a token, the draft and verify replays' device ms (CUDA
   events) and peak memory.
6. flash: each dtype pair's kernel attributes (registers and spilled bytes
   a thread, blocks an SM, threads, shared memory; ``kernel_attributes``)
   at D = 64, 128 and 256; the (bf16, bf16) backward must hold at least two
   blocks an SM at D <= 128, and that pair's forward
   (``flash_fwd_bf16_kernel``: bf16 tiles, bf16 ``mma.sync``, P in three
   bf16 pieces) at least three. The three flash-attention kernels (forward,
   dq, dk/dv) each
   against its plain version at the training shape (B=2, H=32, T=2048,
   D=128, causal), non-causal with valid lengths [0, 1000] (dead rows must
   be exact zeros), causal with Tq != Tk, a ragged T=1000, D=64, and a
   ragged T=333 at D=30 (4-byte copies) and D=256; at the training shape
   each kernel's time, its bound (its products on the tensor cores in the
   fewest passes that keep them as exact as 3xTF32 for their operand
   types, with the f32 bound beside it), its plain time, and the
   ``scaled_dot_product_attention`` forward and backward as yardsticks,
   with the device kernels that the library backward launches
   (``torch.profiler``) and the port's whole backward (the delta reduce,
   dq and dk/dv, through autograd); then the forward kernel against the
   library forward, and dq + dk/dv and the whole backward against the
   library backward, at T=512..4096. Then each other dtype instantiation
   ((f32, bf16), (f32, f16), (bf16, bf16), (f16, f16) as (q/k, v)) against
   its plain version on the same cases, within ATOL / RTOL plus one unit in
   the last place of each output's dtype, launches counted on its pair;
   at the training shape two calls bit for bit, its time, bound, share of
   the bound and plain time, its attributes at that D, and for the
   one-dtype pairs the library forward and backward in that dtype. No
   library time may beat its row's bound. Then BERT-base's
   attention shape (B=64, H=12, T=128, D=64, non-causal, valid lengths 112
   on every fourth row, 0 on row 1, else 128) in f32 and (bf16, bf16):
   each kernel against its plain version, the row of length 0 and the
   masked keys exact zeros, two calls bit for bit; each kernel's time,
   bound (the masked keys and the dead row's queries not read), share of
   the bound, attributes and plain
   time, and ``scaled_dot_product_attention`` in the same dtype with a
   boolean key mask as the yardstick, with the device kernels it ran (its
   backend). Then Transformer-base's shapes as 10c runs them (B=192, H=8,
   T=128, D=64, f32): the decoder's causal self-attention and the
   encoder's and cross-attention's over 10c's source lengths, each kernel
   against its plain version and two calls bit for bit.
7. train: Llama-3-8B width (units 4096, FFN 14336, 32 heads, 8 KV heads,
   vocab 128256) at depth 4 with seeded weights, three Adam steps of
   ``gluon.Trainer`` on one next-token batch (B=2, T=2048): every layer's
   attention must launch each flash kernel once a step, the loss must be
   finite and fall, and the losses and the parameters after three steps
   must match the same steps with the plain attention forced.
7b. train amp: phase 7's model (built with ``remat=True``), batch and Adam
   under ``parallel.ShardedTrainer(dtype="bfloat16")``: three ``step()``
   calls, one ``step_n`` window of three on a fresh model from the same
   seed (its losses must equal the steps'), and the steps with the plain
   attention forced. Each step runs every layer's forward twice (the
   recompute): the forward kernel launches 2 x 4 x 3 times, dq and dk/dv
   4 x 3, layer 0's on the (f32, bf16) instantiation (its v is bf16, its
   q and k f32 after RoPE), the rest on f32; the plain route launches
   none. Losses against the plain route as phase 7's; the weights within
   AMP_PARAM_RTOL of their movement, itself at most a quarter of the
   bf16 run's distance from phase 7's f32 weights; step ms, tokens/s and
   peak memory beside phase 7's.
8. pair: the fused 1x1-pair kernel (``conv1x1_pair``) against its plain
   version at ResNet-50's four block-boundary shapes (batch 32, 224 x 224;
   residual and mid) in bf16 and f32, and on the no-residual and
   residual-only variants, a ragged M, Cout != C1 and an x tile too wide to
   stay in shared memory; two calls must repeat bit for bit. Per stage its
   grid (``split_plan``: Cm slices S, blocks, workspace bytes; stages 3-4
   must split and give at least a block a SM) and shared-memory layout,
   and per stage and dtype the kernel's time, its bound, the plain
   version's time and, as the yardstick, the ``use_pallas=False`` boundary
   (two ``torch.matmul`` in the working dtype and the elementwise
   epilogue); then stages 3-4 timed with the grid aimed at 1, 2 and 3
   blocks a SM.
9. resnet: ``resnet50_v1`` at full width and depth with seeded weights and
   BatchNorm statistics from a seeded train-mode pass, fused by
   ``fuse_resnet_v1(dtype="bfloat16", use_pallas=True)`` and served by
   ``InferenceSession(batch_buckets=(1, 8, 32))``: warmup, then requests of
   1, 5 and 32 images. Every forward must launch the pair kernel 12 times
   (0 on the ``use_pallas=False`` arm), no shape may be new after warmup;
   in f32 the kernel arm, the library arm and the unfused model agree to
   1e-4 of the largest logit, and the card's unfused logits match the CPU's
   to 1e-4; the bf16 kernel arm is within 5e-2 of the f32 logits. Then
   img/s at batch 32 of the bf16 kernel arm, the bf16 library arm and the
   unfused f32 model (three rounds in turns), and each one's device time
   for a forward with the pair kernel's share of it (``torch.profiler``).
   The JSON line's bf16 launches are the served run's; its f32 launches
   are those of the f32 kernel arm's one forward, counted from 0.
10a. bert serve: BERT-base (``bert_12_768_12``, seeded weights) under a
   2-class ``BERTClassifier``, f32, ``eval()``, behind ``BERTStep`` (the
   valid length from the pad mask), served by ``InferenceSession(
   batch_buckets=(1, 8, 32), seq_buckets=(32, 64, 128), pad_value=0)``:
   warmup (9 signatures), then requests of 1 x 20, 5 x 50 (its last row
   all padding, so valid length 0, as are the rows the bucket adds) and
   32 x 128 tokens. Each forward launches the flash forward once a layer
   (12), nothing is new after warmup, the logits are finite and within
   1e-4 of the largest logit of the same requests with the plain
   attention forced. Printed: ms a request at each size, samples/s at
   batch 32 (three rounds), one forward's device time and the flash
   forward's share of it.
10b. bert train: bench.py's ``_bert_setup``: ``BERTForPretrain`` over
   BERT-base (dropout 0.1) behind ``BERTStep``, B=64, T=128, tokens from
   1..29999 with every fourth row padded from position 112, random MLM
   and NSP labels, loss ``ce(mlm).mean() + ce(nsp).mean()``, under
   ``ShardedTrainer(..., "adam", {"learning_rate": 1e-4},
   dtype="bfloat16")``: three ``step()`` calls, a ``step_n`` window of
   three on a fresh model from the same seed (weights and dropout stream;
   its losses equal the steps' bit for bit), the same steps on two plain
   routes, the kernels' plain versions (``force_path("versions")``: f32
   scores, as the kernels) and ``force_path("torch")``
   (``attention_torch``: bf16 scores, as the JAX package's XLA path), and
   the same batch and steps in f32 through ``gluon.Trainer`` as the
   yardstick. Every attention is (bf16, bf16): each flash kernel launches
   12 x 3 times on that pair and on no other, the plain routes none; the
   loss is finite (it need not fall: bench.py's Adam at 1e-4 with no
   warmup raises it over the first steps, in the JAX package too). The
   kernel route against each plain route: each step's loss within
   LOSS_ATOL + ROUTE_SCALE times the widest gap at that step among the
   plain routes and the f32 run, and the weights within ROUTE_SCALE times
   the plain routes' distance from each other. Then the first step's
   gradients: in f32 the kernels within GRAD_RTOL of the plain versions;
   in bf16 the kernels within ROUTE_SCALE times the plain routes' distance
   from each other of each. Printed for the bf16 and f32 runs: step ms,
   samples/s over a window of RATE_STEPS steps (its fastest, median and
   slowest step), peak memory, and from one profiled step the flash
   kernels' device ms and share, and the forward's device ms of it.
10c. transformer: Transformer-base (units 512, FFN 2048, 8 heads, 6 + 6
   layers, a tied 37000-token vocabulary, dropout 0.1), three f32 Adam
   steps of ``gluon.Trainer`` at B=192, T_src = T_tgt = 128 with seeded
   source lengths: each flash kernel launches 18 times a step (6 encoder,
   6 causal decoder and 6 cross-attentions), the loss is finite and
   falls; the first step's gradients and the losses and weights after
   three steps on the kernels lie within ROUTE_SCALE times the two plain
   routes' own distance of each. Printed:
   step ms and target tokens/s.
11. resnet train: ``resnet50_v1`` trained as ``bench.py``'s ResNet rows
   train it (batch 256, 224 x 224, 1000 classes, synthetic images and
   labels from seed 0, ``SoftmaxCrossEntropyLoss``, SGD lr 0.1, momentum
   0.9, wd 1e-4). 11a: the f32 convolution (``ops.nn.convolution``)
   forward, data gradient and weight gradient at the stem (7 x 7, stride
   2), a 3 x 3 and a strided 1 x 1 within 1e-5 of float64 on the CPU, as a
   share of the largest value, beside the same convolution under PyTorch's
   defaults (cuDNN TF32); no global TF32 flag may move. 11b: one f32 SGD
   step (``gluon.Trainer``) of ``get_resnet(1, 50, trainable=True)`` at
   batch 8 on the card and on the CPU in f32, each against the same step
   in float64 on the CPU: the card's loss, gradients, weights and running
   statistics within C3_MODEL_SCALE times the CPU's f32 distance; the
   card's step with TF32 convolutions is printed beside them. 11c:
   ``ShardedTrainer`` in f32, in bf16 (cast-for-compute) and as bf16
   ``step_n`` windows, three gated steps each from the same seeded
   weights (finite losses, running
   statistics finite, f32 and moved), twice for ``step()``; ``step_n``
   must equal ``step()`` bit for bit where two ``step()`` runs do, else lie
   within ROUTE_SCALE times their distance; the bf16 run's distance from
   the f32 run is printed. Then for f32, bf16 and the window of 8: img/s
   over 10 steps (3 windows of 8) after the gated three with the fastest,
   median and slowest step, one step's device time from ``torch.profiler``
   (convolutions, BatchNorm and the rest) and its busy share, the peak
   memory, ``step_flops`` and the MFU it gives against the dtype's peak.
   11d: the train_imagenet loop in f32 through ``gluon.Trainer``
   (``loss.sum().backward()``, ``step(256)``) with ``Accuracy`` and
   ``TopKAccuracy(5)``, within ROUTE_SCALE times the distance of two f32
   ``step()`` runs from the f32 ``ShardedTrainer`` steps. The phase adds
   no kernel.

Then one JSON line of per-kernel numbers (S1-S3 at the rows serve
baseline ran them, with its launches), the card's name and power limit,
and, last, the result line. Without CUDA, or without the package next to
this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12    # H100 SXM TF32 tensor cores, dense
BF16_FLOP_PER_S = 989e12    # H100 SXM bf16 and f16 tensor cores, dense
CONFIG = "llama3_8b"
PROMPT_LENS = (17, 64, 130, 250)
NEW_TOKENS = 32
PREFILL_REPEATS = 3  # phases 4-5: the prefill alone, synchronised
DECODE_STEPS = 8            # iterations a multi-step super-step runs
PREFIX_LEN, PREFIX_TAILS = 64, (20, 45)   # phase 5b's shared-prefix prompts
CB_SLOTS, CB_CHUNK = 4, 256  # phase 5c: the engine's lanes and prefill chunk
CB_CHURN, CB_LENS, CB_NEW = 12, (8, 300), (4, 40)  # 5c's seeded churn
CB_OVER = 2                  # churn prompts longer than one prefill chunk
CB_WAIT = 600                # seconds any one 5c request may take
B1_BUCKETS = (64, 256, 512)  # 5c's batch-1 Generator prompt buckets
# 5c, pallas: prompt 2's f32 K prefilled at (4, 256) and at (1, 256), at
# the first and last layer, within 1e-2 of the largest |K|. The two
# shapes sum the same products in another order, which moved K by at most
# 8.1e-4 at layer 31 on an H100; a prefill that mixed rows or positions
# would move it by its own size
KSHAPE_RTOL = 1e-2
# 5c, int8: every kernel launch against the plain version on the engine's
# inputs, within ATOL plus 1e-4 of the batch row's largest |output|. An
# output is a weighted mean of V rows, so rounding scales with V's size,
# not with the element's own, which may cancel to near 0 (on an H100 the
# kernel gave 3.3e-5 where phase 3's elementwise RTOL allowed less); a
# wrong page, position or scale moves an output by V's size
SHADOW_RTOL = 1e-4
MAX_SEQ = 1024
SPEC_K = 4                  # 5f: draft tokens a round (k + 1 = 5 iterations)
ATOL, RTOL = 1e-5, 1e-4     # same f32 math, only the order of sums differs
SPIN_CYCLES = 4_000_000     # about 2 ms of the card's clock: covers host work
DECODE_SWEEP_S = (1024, 2048, 4096, 8192)   # ring lengths of the context sweep
DECODE_SWEEP_B = (1, 4)
DECODE_AIMS = (1, 2, 4)     # blocks a SM the split-aim sweep aims the grid at
DECODE_LONG_S = 8192        # the split-aim sweep's long ring (Llama-3-8B's context)
INT8_OPS_PER_S = 1979e12   # H100 SXM int8 tensor cores, dense
INT8_SOURCE = "mxnet_tpu_torch/csrc/int8_dense.cu"
# not a pallas_call: the TPU ran this branch of quantized_dense on XLA's
# int8 dot
INT8_REPLACES = "mxnet_tpu/ops/nn.py:944"
# phase 3b: Llama-3-8B's projections, (O, U, products in one forward: per
# layer times 32, the head once); the head runs at decode and verify rows
# only (prefill gathers the last positions before it)
INT8_SHAPES = [(4096, 4096, 64), (1024, 4096, 64), (14336, 4096, 64),
               (4096, 14336, 32), (128256, 4096, 1)]
INT8_M = (1, 4, 20, 256, 1024)
INT8_HEAD_M = (1, 4, 20)
INT8_TIMED_M = (1, 4, 20, 256, 1024)
INT8_DECODE_M = (1, 4, 20)  # the decode kernel's timed rows
INT8_FORWARD = 7 * 32 + 1   # int8 products in one Llama-3-8B forward
INT8_PREFILL_PRODUCTS = 7 * 32  # of a prefill's, prefill rows (not the head)
INT8_DECODE_BOUND_MS = 2.24  # 7.50 G weight bytes at 3.35 TB/s
# phase 3b: each row's RMS error against the f32 product with the
# unquantized weight, over the row's RMS output. On phase 3b's inputs the
# reference algorithm reaches about 1.35e-2 (1,024 rows of U = 14,336);
# the same algorithm with one rounding step lost (truncation) or at half
# the resolution (sx doubled) exceeds 1.45e-2 on single rows and 1.8e-2
# on every case of several rows
INT8_ROW_RMS_LIMIT = 1.6e-2
# phase 3b: host cost of one call, back to back, without a sync, in
# rounds of INT8_HOST_CALLS / INT8_HOST_ROUNDS calls an arm, the arms in
# turn (reversed every other round), so the host's drift falls on all
INT8_HOST_CALLS = 200
INT8_HOST_ROUNDS = 10
# phase 3b: the decode route's host cost a call at most this times the
# mma.sync route's on the same shape (both are the same Python and three
# launches; measured one after the other on an H100's host the two read
# 0.92-1.03 times each other)
INT8_HOST_GROWTH = 1.15
# phase 5 on int8: the first decode step's logits, kernel against the
# plain attention on the same prefill and token, within this share of
# their norm (the largest over rows). The routes differ in the last bits,
# which move a few activations by one int8 step, and those steps grow
# from layer to layer: on an H100 the gap read 1.5e-2 of the state after
# the first layer and 0.232 at the logits; two unrelated logit vectors of
# one norm lie about 1.41 apart
INT8_ROUTE_RTOL = 0.5
KERNEL_SOURCE = "mxnet_tpu_torch/csrc/decode_attention.cu"
REPLACES = "mxnet_tpu/ops/pallas/decode_attention.py:173"
FLASH_SOURCE = "mxnet_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {"fwd": "mxnet_tpu/ops/pallas/flash_attention.py:158",
                  "bwd_dq": "mxnet_tpu/ops/pallas/flash_attention.py:262",
                  "bwd_dkv": "mxnet_tpu/ops/pallas/flash_attention.py:350"}
# (B, H, Tq, Tk, D, causal, valid_length); the first is the training shape
FLASH_CASES = [(2, 32, 2048, 2048, 128, True, None),
               (2, 32, 2048, 2048, 128, False, [0, 1000]),
               (2, 32, 1024, 2048, 128, True, None),
               (2, 32, 1000, 1000, 128, True, None),
               (2, 32, 2048, 2048, 64, True, None),
               (2, 32, 333, 333, 30, True, None),
               (2, 8, 333, 333, 256, True, [333, 200])]
SWEEP_T = (512, 1024, 2048, 4096)
TRAIN_LAYERS, TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR = 4, 2, 2048, 3, 1e-4
# kernel route against forced-plain route after three Adam steps. Losses
# to 1e-4 (the attention differs by ~1e-6). The weights: each within 7 lr,
# the most Adam can move a weight apart in three steps (about lr a step
# each way) where a gradient within rounding of 0 takes the other sign on
# the other route; and the norm of the routes' difference within 1e-2 of
# the norm of how far the weights moved. Those sign flips alone gave
# 1.2e-3 on an H100 (a few hundred of 1.92 B weights 2 lr apart); a wrong
# attention gradient changes the update of every weight it reaches
LOSS_ATOL, PARAM_ATOL, PARAM_RTOL = 1e-4, 7 * TRAIN_LR, 1e-2
# phase 7b, kernel route against forced-plain route under bf16 AMP: the
# norm of the weights' difference within 2.5e-2 of the norm of their
# movement. On an H100 it read 1.576e-2 in five runs, bit for bit,
# against 1.076e-3 in f32. Three quarters of its square lay in differences
# under lr / 2 spread over 73% of the weights (diff_bands): bf16 roundings
# of layer 0's gradients move Adam's updates a little wherever they reach.
# The run checks
# that the limit stays at most a quarter of the bf16 run's own distance
# from the f32 weights (3.469e-1 there), as tests/test_torch_sharded.py
# does on the CPU
AMP_PARAM_RTOL = 2.5e-2
PAIR_SOURCE = "mxnet_tpu_torch/csrc/conv1x1.cu"
PAIR_REPLACES = "mxnet_tpu/ops/pallas/conv1x1.py:32"
# ResNet-50's block boundaries at batch 32, 224 x 224, in kernel terms:
# (stage, launches a forward, M = 32 * H * W, C1 = Cout = the block's mid
# width, Cm = its output width)
PAIR_STAGES = [(1, 2, 32 * 56 * 56, 64, 256), (2, 3, 32 * 28 * 28, 128, 512),
               (3, 5, 32 * 14 * 14, 256, 1024), (4, 2, 32 * 7 * 7, 512, 2048)]
# (M, C1, Cm, Cout, residual, return_mid): the other variants, a ragged M,
# Cout != C1
PAIR_EXTRA = [(6272, 256, 1024, 256, False, False),
              (6272, 256, 1024, 256, True, False),
              (33, 256, 1024, 256, True, True),
              (1000, 256, 128, 192, True, True),
              (1000, 1024, 128, 64, True, True)]
PAIR_SWEEP_BLOCKS_PER_SM = (1, 2, 3)  # grids timed at stages 3-4
# f32: the same sums in another order; bf16: within 2e-2 of the plain
# version's largest value (an h one bf16 rounding apart moves y by about an
# ulp of h times w2)
PAIR_F32_TOL, PAIR_BF16_TOL = 1e-4, 2e-2
RESNET_HW = 224             # image height and width
RESNET_BUCKETS = (1, 8, 32)
RESNET_REQUESTS = (1, 5, 32)
RESNET_PAIRS = 12           # block boundaries of one ResNet-50 forward
LOGIT_F32_TOL, LOGIT_BF16_TOL = 1e-4, 5e-2
# phases 6 and 10: BERT-base as bench.py's _bert_setup trains it (batch 64,
# sequence 128, tokens drawn from 1..29999, every fourth row padded from
# position 112) and serves it; Transformer-base (Vaswani et al. 2017:
# units 512, FFN 2048, 8 heads, 6 + 6 layers, a shared vocabulary of 37000)
BERT_CONFIG = "bert_12_768_12"
BERT_LAYERS, BERT_HEADS, BERT_D = 12, 12, 64
BERT_B, BERT_T, BERT_TOKENS, BERT_PAD_FROM = 64, 128, 30000, 112
BERT_BUCKETS, BERT_SEQ_BUCKETS = (1, 8, 32), (32, 64, 128)
BERT_REQUESTS = ((1, 20), (5, 50), (32, 128))   # (rows, tokens)
MT_VOCAB, MT_B, MT_T, MT_LAYERS, MT_HEADS, MT_D = (37000, 192, 128,
                                                  6, 8, 64)
# phase 10: the routes of a BERT or Transformer step. Two plain routes
# compute the same attention and differ only in where they round: the
# kernels' plain versions (force_path("versions"): f32 scores, as the
# kernels) and attention_torch (force_path("torch"); the JAX package's XLA
# formula, which rounds bf16 scores to bf16). A fixed limit does not carry
# over from phase 7: on an H100 the two plain routes' first-step gradients
# part by 6.2e-4 of their norm at Transformer-base's B=192 (5e-7 at B=4),
# and BERT-base's bf16 step turns any last-bit difference into bf16's own
# noise within three Adam steps (the kernels 9.3e-2 of the movement from
# either plain route, these 9.2e-2 from each other, bf16 0.115 from f32),
# while phase 6 holds each kernel to its plain version at 1e-5. So the
# kernel route is held within ROUTE_SCALE times the noise of each plain
# route: the two plain routes' own distance for the weights and first-step
# gradients (sums over 1e8 entries, a steady measure), and for the losses
# (plus LOSS_ATOL) the widest gap at the step among the runs that are not
# the kernels': in bf16 (10b) a loss is one draw of bf16's noise, and one
# pair of draws measures it badly (the plain routes 3.0e-4 apart at step 1
# where each lies 7.1e-2 from the f32 run), so there the f32 run, the same
# batch and steps without bf16's rounding, joins the plain routes. In f32
# the first-step gradients are also held within GRAD_RTOL of the plain
# versions' (2.8e-6 of the norm on an H100 at BERT-base)
ROUTE_SCALE = 2
GRAD_RTOL = 1e-5
RATE_STEPS = 10      # 10b: steps of the window samples/s is taken over
# phase 11: ResNet-50 v1 trained as bench.py's bench_resnet_train and
# bench_resnet_train_fused time it (batch 256, 224 x 224, 1000 classes,
# SGD lr 0.1, momentum 0.9, wd 1e-4; synthetic images and labels from a
# seed)
RT_BATCH, RT_CLASSES, RT_FUSE = 256, 1000, 8
RT_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
RT_GATED, RT_WINDOWS = 3, 3   # gated steps; step_n windows of RT_FUSE timed
# 11a: the port's f32 convolution, forward and both gradients, against
# float64 on the CPU, as a share of the largest value
C3_OP_TOL = 1e-5
# 11b: one f32 SGD step of resnet50_v1 at batch 8, on the card and on the
# CPU in f32, each against the same step in float64 on the CPU: the loss,
# the gradients (total norm), the weights and the running statistics (of
# their movement). The card's distances must stay within C3_MODEL_SCALE
# times the CPU's f32 ones (plus C3_MODEL_ATOL where both are at f32's
# rounding). The step itself is ill-conditioned in f32: on an H100 (run
# B) the CPU's f32 gradients lay 1.75e-2 of their norm from float64 and
# the card's 2.10e-2 (BatchNorm's backward cancels terms at every layer),
# while TF32 convolutions put them 0.655 away, so a fixed 1e-4 limit
# against the CPU's f32 step was wrong
C3_MODEL_SCALE, C3_MODEL_ATOL = 2.0, 1e-6
C3_MODEL_BATCH = 8
# phase 3c and serve baseline: the strict rung's shape-stable kernels
# (ops.hopper.stable_ops), port-only as the int8 product is: the JAX
# package runs these formulas on XLA (no pallas_call)
STABLE_SOURCE = "mxnet_tpu_torch/csrc/stable_ops.cu"
STABLE_REPLACES = {"dense": "mxnet_tpu/ops/nn.py:1053",
                   "attention": "mxnet_tpu/ops/nn.py:1018",
                   "norm": "mxnet_tpu/ops/nn.py:497"}
# kernel against plain: the same f32 sums in another order, within this
# share of the largest |output|
STABLE_REL = 1e-5
STABLE_EPS = 1e-5           # Llama's norm epsilon
STABLE_DECODE_M = 4         # decode rows: the batch bucket
STABLE_PREFILL_M = 4 * 256  # prefill rows: batch x prompt bucket
STABLE_CHUNK_M = 256        # the engine's prefill chunk (1, 256)
# serve baseline's prefill ms with S1's first prefill tile (global loads)
# and S2's heads kernel at every T, on one H100 80GB HBM3 at 700.00 W: the
# reading the ring-fed tile and the rows kernel are set beside
STABLE_FIRST_PREFILL_MS = 802.6
STABLE_LAYERS = 32
STABLE_PRODUCTS = 7 * 32 + 1   # S1 launches a forward (the head included)
STABLE_NORMS = 2 * 32 + 1      # S3 launches a forward (the final norm too)
# phase 3c's decode positions: the middle of a 32-token generate of
# phase 4-5's prompts
STABLE_DECODE_SP = [n + NEW_TOKENS // 2 for n in PROMPT_LENS]
# serve baseline: the decode steps whose logits must equal a full
# prefill's (the sixth is the last whose prefixes all fit bucket 256)
PARITY_STEPS = (1, 6)


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps=25, warm=3):
    """Median device time of ``fn`` over ``reps`` launches, each timed by its
    own CUDA event pair, with the L2 cache flushed before each (in the
    decode step the ring of a layer is cold: 32 layers of weights pass
    through L2 between two reads of it). A spin kernel queued ahead of the
    first event keeps the card busy while the host enqueues ``fn``, so the
    pair times the device work and not the host's launch overhead."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def kernel_bound(b_sp, kv, g, d, elem, quant):
    """Least time (ms) for one launch: bytes (q, out, start_pos, and the
    K/V rows up to each start_pos, plus int8 scales) over the memory rate,
    against flops (4 * G * D per position and KV head) over the f32 rate."""
    positions = sum(sp + 1 for sp in b_sp) * kv
    b = len(b_sp)
    nbytes = (2 * b * kv * g * d * 4 + 4 * b + positions * d * elem * 2
              + (positions * 8 if quant else 0))
    flops = positions * 4 * g * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_inputs(torch, nn_ops, dev, quant, b, s, seed, h=32, kv=8, d=128):
    """Seeded q and rings at Llama-3-8B heads; int8 rings quantized on the
    card as the serving path writes them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, 1, d, device=dev, generator=gen)
    kf = torch.randn(b, kv, s, d, device=dev, generator=gen)
    vf = torch.randn(b, kv, s, d, device=dev, generator=gen)
    if not quant:
        return q, kf, vf, None, None
    zero = torch.zeros(b, dtype=torch.int32, device=dev)
    k = torch.zeros(b, kv, s, d, dtype=torch.int8, device=dev)
    v = torch.zeros_like(k)
    ks = torch.zeros(b, kv, s, device=dev)
    vs = torch.zeros_like(ks)
    nn_ops.kv_cache_write_q(k, ks, kf, zero)
    nn_ops.kv_cache_write_q(v, vs, vf, zero)
    return q, k, v, ks, vs


def plan_fields(da, b, s, sms, h=32, kv=8, d=128):
    """The grid ``split_plan`` gives a launch at these shapes."""
    plan = da.split_plan(b, kv, s, h // kv, d, sms)
    return {"splits": plan.splits, "blocks": plan.blocks,
            "workspace_bytes": plan.workspace_bytes}


def decode_check(torch, da, q, k, v, sp, ks, vs, what):
    """Two kernel calls against the plain version: they must agree to
    ATOL / RTOL and repeat bit for bit, and a row with no live position
    (start_pos < 0) must give zeros, as the Pallas kernel does (the plain
    version, like ``_xla_decode``, averages V there). Returns the max
    error."""
    out = da.decode_attention(q, k, v, sp, k_scale=ks, v_scale=vs)
    check(da.last_path() == "cuda", "kernel call did not take the kernel")
    again = da.decode_attention(q, k, v, sp, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    ref = da.decode_attention_torch(q, k, v, sp, k_scale=ks, v_scale=vs)
    live = sp >= 0
    err = (out[live] - ref[live]).abs()
    max_err = float(err.max())
    check(bool(torch.isfinite(out).all()), f"kernel output not finite ({what})")
    check(bool((err <= ATOL + RTOL * ref[live].abs()).all()),
          f"kernel disagrees with plain: max_abs_err={max_err} ({what})")
    check(not bool(out[~live].any()), f"a dead row is not zeros ({what})")
    check(torch.equal(out, again), f"kernel does not repeat bit for bit "
          f"({what})")
    return max_err


def kernel_phase(torch, da, nn_ops, flush, dev):
    """Phase 3: kernel vs plain at Llama-3-8B attention shapes, then the
    context and split-aim sweeps. Returns {variant: numbers at the main
    path's last decode step, max error over every case and sweep point}."""
    import torch.nn.functional as F

    h, kv, d = 32, 8, 128
    g = h // kv
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    main_sp = [n + NEW_TOKENS - 2 for n in PROMPT_LENS]
    cases = []
    for quant in (False, True):
        for s in (1024, 1000):
            cases.append((quant, 1, s, [s - 1]))
            cases.append((quant, 4, s, [0, 100, s // 2 + 3, s - 1]))
            cases.append((quant, 4, s, [-1, 31, 32, 33]))
        cases.append((quant, 4, MAX_SEQ, main_sp))
    results = {}
    seed = 0
    for quant, b, s, sps in cases:
        seed += 1
        q, k, v, ks, vs = decode_inputs(torch, nn_ops, dev, quant, b, s, seed)
        sp = torch.tensor(sps, dtype=torch.int32, device=dev)
        variant = "int8" if quant else "f32"
        plan = plan_fields(da, b, s, sms)
        max_err = decode_check(torch, da, q, k, v, sp, ks, vs,
                               f"{variant} B={b} S={s} start_pos={sps}")
        fields = dict(variant=variant, B=b, S=s, start_pos=sps, **plan,
                      max_abs_err=f"{max_err:.3e}", repeats_bitwise=True)
        r = results.setdefault(variant, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], max_err)
        if not (b == 4 and s == MAX_SEQ and sps == main_sp):
            say("kernel", **fields)
            continue
        # the main path's last decode step: times against the bound
        def kernel():
            return da.decode_attention(q, k, v, sp, k_scale=ks, v_scale=vs)

        def plain():
            return da.decode_attention_torch(q, k, v, sp, k_scale=ks,
                                             v_scale=vs)

        dead = torch.full_like(sp, -1)
        k_ms = time_ms(torch, kernel, flush)
        p_ms = time_ms(torch, plain, flush)
        empty_ms = time_ms(torch, lambda: da.decode_attention(
            q, k, v, dead, k_scale=ks, v_scale=vs), flush)
        lib_ms = None if quant else library_ms(torch, F, q, k, v, sp, flush)
        bound, bound_by = kernel_bound(sps, kv, g, d, 1 if quant else 4,
                                       quant)
        say("kernel", **fields, kernel_ms=f"{k_ms:.6f}",
            bound_ms=f"{bound:.6f}", bound_by=bound_by,
            plain_ms=f"{p_ms:.6f}", empty_ms=f"{empty_ms:.6f}",
            library_ms="null" if lib_ms is None else f"{lib_ms:.6f}")
        r.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
                 library_ms=lib_ms)
    context_sweep(torch, F, da, nn_ops, flush, dev, sms, results)
    aim_sweep(torch, da, nn_ops, flush, dev, sms, main_sp)
    return results


def library_ms(torch, F, q, k, v, sp, flush, reps=25):
    """One ``scaled_dot_product_attention`` call on the same inputs."""
    s = k.shape[2]
    valid = (torch.arange(s, device=q.device)[None, :]
             <= sp[:, None].long())[:, None, None, :]
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=valid, enable_gqa=True), flush, reps=reps)


def context_sweep(torch, F, da, nn_ops, flush, dev, sms, results):
    """Every row at start_pos = S - 1: the kernel against the plain version
    and timed against its bound and (f32) the library, per ring length."""
    kv, g, d = 8, 4, 128
    for quant in (False, True):
        variant = "int8" if quant else "f32"
        for b in DECODE_SWEEP_B:
            for s in DECODE_SWEEP_S:
                q, k, v, ks, vs = decode_inputs(torch, nn_ops, dev, quant, b,
                                                s, 1000 + s + b)
                sps = [s - 1] * b
                sp = torch.tensor(sps, dtype=torch.int32, device=dev)
                err = decode_check(torch, da, q, k, v, sp, ks, vs,
                                   f"sweep {variant} B={b} S={s}")
                results[variant]["max_abs_err"] = max(
                    results[variant]["max_abs_err"], err)
                k_ms = time_ms(torch, lambda: da.decode_attention(
                    q, k, v, sp, k_scale=ks, v_scale=vs), flush, reps=15)
                lib = (None if quant else
                       library_ms(torch, F, q, k, v, sp, flush, reps=15))
                bound, bound_by = kernel_bound(sps, kv, g, d,
                                               1 if quant else 4, quant)
                say("kernel sweep", variant=variant, B=b, S=s,
                    start_pos="S-1", **plan_fields(da, b, s, sms),
                    max_abs_err=f"{err:.3e}", kernel_ms=f"{k_ms:.6f}",
                    bound_ms=f"{bound:.6f}", bound_by=bound_by,
                    bound_share=f"{bound / k_ms:.4f}",
                    library_ms="null" if lib is None else f"{lib:.6f}")
                del q, k, v, ks, vs
    torch.cuda.empty_cache()


def aim_sweep(torch, da, nn_ops, flush, dev, sms, main_sp):
    """The grid aimed at DECODE_AIMS blocks a SM, in turns, at the main
    path's shape (its time also over a generate's 32 x 31 launches) and at
    B=4, S=DECODE_LONG_S with every row full."""
    default = da.BLOCKS_PER_SM
    for quant in (False, True):
        variant = "int8" if quant else "f32"
        for s, sps in ((MAX_SEQ, main_sp), (DECODE_LONG_S,
                                            [DECODE_LONG_S - 1] * 4)):
            q, k, v, ks, vs = decode_inputs(torch, nn_ops, dev, quant, 4, s,
                                            2000 + s)
            sp = torch.tensor(sps, dtype=torch.int32, device=dev)
            sweep = {}
            try:
                for aim in DECODE_AIMS * 2:
                    da.BLOCKS_PER_SM = aim
                    decode_check(torch, da, q, k, v, sp, ks, vs,
                                 f"aim {aim} {variant} S={s}")
                    sweep.setdefault(aim, []).append(time_ms(
                        torch, lambda: da.decode_attention(
                            q, k, v, sp, k_scale=ks, v_scale=vs), flush,
                        reps=15))
            finally:
                da.BLOCKS_PER_SM = default
            fields = {}
            for aim, ms in sweep.items():
                da.BLOCKS_PER_SM = aim
                fields[f"blocks_per_sm_{aim}"] = (
                    f"splits={plan_fields(da, 4, s, sms)['splits']}:"
                    f"{ms[0]:.6f},{ms[1]:.6f}")
                if s == MAX_SEQ:
                    fields[f"generate_ms_{aim}"] = (
                        f"{32 * (NEW_TOKENS - 1) * statistics.mean(ms):.4f}")
            da.BLOCKS_PER_SM = default
            say("kernel aim", variant=variant, B=4, S=s, start_pos=sps,
                default=default, **fields)
            del q, k, v, ks, vs
    torch.cuda.empty_cache()


def pairs_kept(b, h, tq, tk, causal, vl):
    """(query, key) pairs the masks keep: the work a flash kernel must do
    on these inputs."""
    off = tk - tq
    total = 0
    for kv in (vl if vl is not None else [tk] * b):
        kv = max(0, min(kv, tk))
        if causal:
            # sum over q of min(kv, max(0, q + off + 1))
            total += sum(min(kv, max(0, q + off + 1)) for q in range(tq))
        else:
            total += kv * tq
    return total * h


# the matrix products of each flash kernel, 2 D flops a kept (query, key)
# pair each, by operand types: "qk" and "v" are the inputs' types, "f32"
# the kernel's own P and dS (G comes in q's type)
FLASH_PRODUCTS = {
    "fwd": (("qk", "qk"), ("f32", "v")),                  # S = QK^T, O = PV
    "bwd_dq": (("qk", "qk"), ("qk", "v"), ("f32", "qk")),  # S, dP = GV^T, dS K
    "bwd_dkv": (("qk", "qk"), ("f32", "qk"), ("qk", "v"),  # S, dV = P^T G,
                ("f32", "qk"))}                            # dP, dK = dS^T Q


def product_s_per_flop(a, b):
    """Least seconds a flop of one matrix product of operand types ``a``
    and ``b`` ("f32", "bf16", "f16") takes on the tensor cores: the fewest
    passes that keep it as exact as the kernels' 3xTF32 (an f32 operand cut
    into pieces of 22 significand bits or more in all), at the rate of the
    type they run in. f32 x f32: three TF32 passes (six bf16 passes cost
    the same). A narrow type against itself: one pass, the product exact
    in the f32 accumulator. f32 against bf16: three bf16 pieces of the f32
    operand (8 + 8 + 8 bits; two TF32 passes cost more); against f16: two
    f16 pieces (11 + 11 bits)."""
    if a == b == "f32":
        return 3 / TF32_FLOP_PER_S
    if a == b:
        return 1 / BF16_FLOP_PER_S
    if "f32" not in (a, b):
        raise ValueError(f"no flash instantiation multiplies {a} by {b}")
    narrow = b if a == "f32" else a
    return {"bf16": 3, "f16": 2}[narrow] / BF16_FLOP_PER_S


def live_rows_keys(b, tq, tk, causal, vl):
    """(query rows with a kept key, keys some query keeps) of one head,
    summed over the batch: the rows and keys of q, g, lse, delta and of k,
    v that a flash kernel must read on these inputs."""
    rows = keys = 0
    for kv in (vl if vl is not None else [tk] * b):
        kv = max(0, min(kv, tk))
        if kv:
            # causal: query q keeps keys up to q + tk - tq
            rows += tq - (min(tq, max(0, tq - tk)) if causal else 0)
            keys += kv
    return rows, keys


def flash_bound(kernel, b, h, tq, tk, d, causal, vl, qk="f32", v="f32"):
    """Least time (ms) of one launch on inputs of types ``qk`` (q, k, g)
    and ``v``: its inputs read once where a kept pair needs them (the rows
    and keys of live_rows_keys: a key past its valid length, or a query
    row with no kept key, is never read) and its outputs written whole
    (dead rows as zeros) over the memory rate (q, k, g, out, dq, dk in
    ``qk``, v and dv in ``v``, lse and delta f32), against its products
    (FLASH_PRODUCTS, 2 D flops a kept pair each) at the least each costs
    for its operand types (product_s_per_flop). Returns (ms, "bytes" |
    "operations", f32 ms): the bound and, beside it, the bound with every
    flop at the f32 rate outside the tensor cores."""
    elem = {"f32": 4, "bf16": 2, "f16": 2}
    rows, keys = live_rows_keys(b, tq, tk, causal, vl)
    q_in, q_out = h * rows * d * elem[qk], b * h * tq * d * elem[qk]
    k_in, k_out = h * keys * d * elem[qk], b * h * tk * d * elem[qk]
    v_in, v_out = h * keys * d * elem[v], b * h * tk * d * elem[v]
    r_in, r_out = h * rows * 4, b * h * tq * 4
    nbytes = {"fwd": q_in + k_in + v_in + q_out + r_out,
              "bwd_dq": 2 * q_in + k_in + v_in + 2 * r_in + q_out,
              "bwd_dkv": 2 * q_in + k_in + v_in + 2 * r_in + k_out
              + v_out}[kernel] + 4 * b
    types = {"qk": qk, "v": v, "f32": "f32"}
    flops = 2 * d * pairs_kept(b, h, tq, tk, causal, vl)  # one product's
    products = FLASH_PRODUCTS[kernel]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_f32 = len(products) * flops / F32_FLOP_PER_S * 1e3
    t_ops = sum(product_s_per_flop(types[x], types[y])
                for x, y in products) * flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            max(t_bytes, t_f32))


def device_kernels(torch, fn):
    """{device kernel name: device ms} of one call of ``fn``, from a
    ``torch.profiler`` window after a warm call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key: ev.device_time_total / 1e3 for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA}


def flash_attributes_phase(fa):
    """Phase 6, first: each pair's kernel attributes at D = 64, 128 and 256
    (the instantiation of 16-byte copies), one line a pair and D; the
    (bf16, bf16) backward holds at least two blocks an SM at D <= 128, its
    forward at least three."""
    for pair in fa.DTYPE_PAIRS:
        for d in (64, 128, 256):
            at = fa.kernel_attributes(pair, d)
            say("flash attributes", pair=fa.pair_label(pair), D=d,
                **{n: attribute_text(fa, a) for n, a in at.items()},
                fields="/".join(fa.ATTRIBUTES))
            if fa.pair_label(pair) == "bf16" and d <= 128:
                check(all(at[n]["blocks_per_sm"] >= 2
                          for n in ("bwd_dq", "bwd_dkv")),
                      f"flash bf16 backward below two blocks an SM at D {d}:"
                      f" {at}")
                check(at["fwd"]["blocks_per_sm"] >= 3,
                      f"flash bf16 forward below three blocks an SM at D {d}:"
                      f" {at['fwd']}")


def attribute_text(fa, at):
    """One kernel's ``kernel_attributes`` as "registers/local_bytes/..."."""
    return "/".join(str(at[k]) for k in fa.ATTRIBUTES)


def flash_phase(torch, fa, flush, dev):
    """Phase 6: each flash kernel against its plain version on the card.
    Returns {kernel: numbers at the training shape, max error}."""
    import torch.nn.functional as F

    results = {n: {"max_abs_err": 0.0} for n in fa.KERNELS}
    for case_i, (b, h, tq, tk, d, causal, vl) in enumerate(FLASH_CASES):
        gen = torch.Generator(device=dev).manual_seed(100 + case_i)

        def rnd(t):
            return torch.randn(b * h, t, d, device=dev, generator=gen)

        q, k, v, g = rnd(tq), rnd(tk), rnd(tk), rnd(tq)
        kvalid = fa.kvalid_of(None if vl is None else torch.tensor(vl), b,
                              tk, dev)
        args = (kvalid, causal, tk - tq, d ** -0.5)
        out, lse = fa.flash_fwd(q, k, v, *args)
        check(fa.last_path() == "cuda", "flash call did not take the kernel")
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_fwd_torch(q, k, v, *args)
        delta = (g * ref_out).sum(-1)
        dq = fa.flash_bwd_dq(q, k, v, g, ref_lse, delta, *args)
        dk, dv = fa.flash_bwd_dkv(q, k, v, g, ref_lse, delta, *args)
        torch.cuda.synchronize()
        ref_dq = fa.flash_bwd_dq_torch(q, k, v, g, ref_lse, delta, *args)
        ref_dk, ref_dv = fa.flash_bwd_dkv_torch(q, k, v, g, ref_lse, delta,
                                                *args)
        errs = {}
        for name, pairs in (("fwd", ((out, ref_out), (lse, ref_lse))),
                            ("bwd_dq", ((dq, ref_dq),)),
                            ("bwd_dkv", ((dk, ref_dk), (dv, ref_dv)))):
            err = 0.0
            for ours, ref in pairs:
                check(bool(torch.isfinite(ours).all()),
                      f"flash {name} output not finite")
                diff = (ours - ref).abs()
                check(bool((diff <= ATOL + RTOL * ref.abs()).all()),
                      f"flash {name} disagrees with plain: max_abs_err="
                      f"{float(diff.max())} (case {case_i})")
                err = max(err, float(diff.max()))
            errs[name] = err
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               err)
        dead = ref_lse <= -1e29
        n_dead = int(dead.sum())
        check(bool(torch.equal(lse <= -1e29, dead))
              and bool((lse[dead] == -1e30).all())
              and not bool(out[dead].any()) and not bool(dq[dead].any()),
              f"flash dead rows are not exact zeros (case {case_i})")
        if vl is not None and vl[0] == 0:
            check(n_dead == h * tq and not bool(dk[:h].any())
                  and not bool(dv[:h].any()),
                  "flash: a batch row with valid length 0 has gradients")
        check(bool(dq.abs().max() > 0) and bool(dk.abs().max() > 0),
              "flash gradients are all zero")
        say("flash", B=b, H=h, Tq=tq, Tk=tk, D=d, causal=causal,
            valid_length=vl, dead_rows=n_dead,
            **{f"{n}_max_abs_err": f"{e:.3e}" for n, e in errs.items()})
        if case_i:
            continue
        # the training shape: times
        calls = {"fwd": lambda: fa.flash_fwd(q, k, v, *args),
                 "bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, g, ref_lse,
                                                   delta, *args),
                 "bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, g, ref_lse,
                                                     delta, *args)}
        plains = {"fwd": lambda: fa.flash_fwd_torch(q, k, v, *args),
                  "bwd_dq": lambda: fa.flash_bwd_dq_torch(
                      q, k, v, g, ref_lse, delta, *args),
                  "bwd_dkv": lambda: fa.flash_bwd_dkv_torch(
                      q, k, v, g, ref_lse, delta, *args)}
        q4, k4, v4, g4 = (x.view(b, h, -1, d) for x in (q, k, v, g))
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), flush)
        qr, kr, vr = (x.detach().clone().requires_grad_()
                      for x in (q4, k4, v4))
        lib_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), g4, retain_graph=True), flush)
        lib_kernels = device_kernels(torch, lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), g4, retain_graph=True))
        say("flash", library_backward_kernels=json.dumps(
            {n: round(ms, 6) for n, ms in sorted(
                lib_kernels.items(), key=lambda kv: -kv[1])}))

        def lib_fwd_bwd():
            o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
            torch.autograd.grad(o, (qr, kr, vr), g4)

        lib_both = time_ms(torch, lib_fwd_bwd, flush)
        # the port's whole backward as training runs it: _FlashCore.backward
        # computes delta = rowsum(dO * O) with a torch reduce, then launches
        # dq and dk/dv; the library's timed backward holds its own pre-pass
        core_bwd = core_backward_ms(torch, fa, q4, k4, v4, g4, flush)
        delta_ms = time_ms(torch, lambda: torch.sum(g * ref_out, dim=-1),
                           flush)
        for name in fa.KERNELS:
            k_ms = time_ms(torch, calls[name], flush)
            p_ms = time_ms(torch, plains[name], flush)
            bound, bound_by, bound_f32 = flash_bound(
                name, b, h, tq, tk, d, causal, vl)
            lib_ms = lib_fwd if name == "fwd" else lib_bwd
            results[name].update(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                                 bound_by=bound_by, library_ms=lib_ms)
            say("flash", kernel=name, B=b, H=h, T=tq, D=d, causal=causal,
                kernel_ms=f"{k_ms:.6f}", bound_ms=f"{bound:.6f}",
                bound_by=bound_by, bound_f32_ms=f"{bound_f32:.6f}",
                bound_3xtf32_ms=f"{bound:.6f}", plain_ms=f"{p_ms:.6f}",
                library_ms=f"{lib_ms:.6f}",
                library=("sdpa_forward" if name == "fwd"
                         else "sdpa_backward_dq_dk_dv"))
        say("flash", library_fwd_bwd_ms=f"{lib_both:.6f}",
            kernels_fwd_bwd_ms=f"{sum(results[n]['ms'] for n in fa.KERNELS):.6f}",
            kernels_bwd_ms=(
                f"{results['bwd_dq']['ms'] + results['bwd_dkv']['ms']:.6f}"),
            delta_ms=f"{delta_ms:.6f}", core_backward_ms=f"{core_bwd:.6f}",
            library_backward_ms=f"{lib_bwd:.6f}")
        del qr, kr, vr, lib_out
    # crossover record: the forward kernel against the library forward, and
    # the port's backward against the library backward
    for t in SWEEP_T:
        b, h, d = 2, 32, 128
        gen = torch.Generator(device=dev).manual_seed(t)
        q, k, v, g = (torch.randn(b * h, t, d, device=dev, generator=gen)
                      for _ in range(4))
        kvalid = fa.kvalid_of(None, b, t, dev)
        args = (kvalid, True, 0, d ** -0.5)
        k_ms = time_ms(torch, lambda: fa.flash_fwd(q, k, v, *args), flush,
                       reps=10)
        q4, k4, v4, g4 = (x.view(b, h, t, d) for x in (q, k, v, g))
        l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), flush, reps=10)
        bound, _, bound_f32 = flash_bound("fwd", b, h, t, t, d, True, None)
        say("flash sweep", direction="forward", B=b, H=h, T=t, D=d,
            causal=True,
            kernel_ms=f"{k_ms:.6f}", library_ms=f"{l_ms:.6f}",
            bound_ms=f"{bound:.6f}", bound_f32_ms=f"{bound_f32:.6f}")
        out, lse = fa.flash_fwd(q, k, v, *args)
        delta = (g * out).sum(-1)

        def backward():
            fa.flash_bwd_dq(q, k, v, g, lse, delta, *args)
            fa.flash_bwd_dkv(q, k, v, g, lse, delta, *args)

        kb_ms = time_ms(torch, backward, flush, reps=10)
        core_bwd = core_backward_ms(torch, fa, q4, k4, v4, g4, flush, reps=10)
        qr, kr, vr = (x.detach().clone().requires_grad_()
                      for x in (q4, k4, v4))
        lib_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        lb_ms = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), g4, retain_graph=True), flush, reps=10)
        bound = sum(flash_bound(n, b, h, t, t, d, True, None)[0]
                    for n in ("bwd_dq", "bwd_dkv"))
        say("flash sweep", direction="backward", B=b, H=h, T=t, D=d,
            causal=True, kernels_ms=f"{kb_ms:.6f}",
            core_backward_ms=f"{core_bwd:.6f}", library_ms=f"{lb_ms:.6f}",
            bound_ms=f"{bound:.6f}")
        del qr, kr, vr, lib_out
    return results


def core_backward_ms(torch, fa, q4, k4, v4, g4, flush, reps=25):
    """Device ms of the port's attention backward through autograd, as a
    training step runs it: delta, then the dq and dk/dv kernels."""
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    out = fa.attention(qr, kr, vr, causal=True)
    return time_ms(torch, lambda: torch.autograd.grad(
        out, (qr, kr, vr), g4, retain_graph=True), flush, reps=reps)


def ulp(torch, x, dtype):
    """One unit in the last place of ``dtype`` at |x| (0 for f32)."""
    if dtype == torch.float32:
        return torch.zeros_like(x)
    mant, lo = (7, -126) if dtype == torch.bfloat16 else (10, -14)
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x),
                       torch.clamp(e - 1, min=lo) - mant)


def flash_dtype_phase(torch, fa, flush, dev):
    """Phase 6, dtypes: each instantiation other than f32 against its plain
    version (the same f32 math, rounded once to the output's dtype) on the
    FLASH_CASES shapes; at the training shape two calls bit for bit, the
    times, the bound and, for one-dtype pairs, the library's. Returns
    {pair label: {kernel: numbers at the training shape, max error}}."""
    import torch.nn.functional as F

    out = {}
    for pair in fa.DTYPE_PAIRS[1:]:
        qk, vt = pair
        label = fa.pair_label(pair)
        res = {n: {"max_abs_err": 0.0} for n in fa.KERNELS}
        for case_i, (b, h, tq, tk, d, causal, vl) in enumerate(FLASH_CASES):
            gen = torch.Generator(device=dev).manual_seed(200 + case_i)

            def rnd(t, dtype):
                return torch.randn(b * h, t, d, device=dev,
                                   generator=gen).to(dtype)

            q, k, v, g = rnd(tq, qk), rnd(tk, qk), rnd(tk, vt), rnd(tq, qk)
            kvalid = fa.kvalid_of(None if vl is None else torch.tensor(vl),
                                  b, tk, dev)
            args = (kvalid, causal, tk - tq, d ** -0.5)
            n0 = fa.launch_count(pair)
            o, lse = fa.flash_fwd(q, k, v, *args)
            check(fa.last_path() == "cuda", "flash call did not take the "
                  "kernel")
            ref_o, ref_lse = fa.flash_fwd_torch(q, k, v, *args)
            delta = (g.float() * ref_o.float()).sum(-1)
            dq = fa.flash_bwd_dq(q, k, v, g, ref_lse, delta, *args)
            dk, dv = fa.flash_bwd_dkv(q, k, v, g, ref_lse, delta, *args)
            torch.cuda.synchronize()
            check(fa.launch_count(pair) == {
                n: c + 1 for n, c in n0.items()},
                f"flash {label}: launches not counted on its instantiation")
            ref_dq = fa.flash_bwd_dq_torch(q, k, v, g, ref_lse, delta, *args)
            ref_dk, ref_dv = fa.flash_bwd_dkv_torch(q, k, v, g, ref_lse,
                                                    delta, *args)
            errs = {}
            for name, pairs in (("fwd", ((o, ref_o), (lse, ref_lse))),
                                ("bwd_dq", ((dq, ref_dq),)),
                                ("bwd_dkv", ((dk, ref_dk), (dv, ref_dv)))):
                err = 0.0
                for ours, ref in pairs:
                    check(ours.dtype == ref.dtype, f"flash {label} {name}: "
                          f"{ours.dtype}, the plain version {ref.dtype}")
                    check(bool(torch.isfinite(ours).all()),
                          f"flash {label} {name} output not finite")
                    a, r = ours.float(), ref.float()
                    diff = (a - r).abs()
                    bound = ATOL + RTOL * r.abs() + ulp(
                        torch, torch.maximum(a.abs(), r.abs()), ours.dtype)
                    check(bool((diff <= bound).all()),
                          f"flash {label} {name} disagrees with plain: "
                          f"max_abs_err={float(diff.max())} (case {case_i})")
                    err = max(err, float(diff.max()))
                errs[name] = err
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                               err)
            dead = ref_lse <= -1e29
            check(bool(torch.equal(lse <= -1e29, dead))
                  and not bool(o[dead].any()) and not bool(dq[dead].any()),
                  f"flash {label}: dead rows are not exact zeros (case "
                  f"{case_i})")
            say("flash dtypes", pair=label, B=b, H=h, Tq=tq, Tk=tk, D=d,
                causal=causal, valid_length=vl, dead_rows=int(dead.sum()),
                **{f"{n}_max_abs_err": f"{e:.3e}" for n, e in errs.items()})
            if case_i:
                continue
            # the training shape: repeats, times, bounds, library
            again = (fa.flash_fwd(q, k, v, *args),
                     fa.flash_bwd_dq(q, k, v, g, ref_lse, delta, *args),
                     fa.flash_bwd_dkv(q, k, v, g, ref_lse, delta, *args))
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(
                (again[0][0], again[0][1], again[1], again[2][0],
                 again[2][1]), (o, lse, dq, dk, dv))),
                  f"flash {label}: two calls differ")
            calls = {"fwd": lambda: fa.flash_fwd(q, k, v, *args),
                     "bwd_dq": lambda: fa.flash_bwd_dq(
                         q, k, v, g, ref_lse, delta, *args),
                     "bwd_dkv": lambda: fa.flash_bwd_dkv(
                         q, k, v, g, ref_lse, delta, *args)}
            plains = {"fwd": lambda: fa.flash_fwd_torch(q, k, v, *args),
                      "bwd_dq": lambda: fa.flash_bwd_dq_torch(
                          q, k, v, g, ref_lse, delta, *args),
                      "bwd_dkv": lambda: fa.flash_bwd_dkv_torch(
                          q, k, v, g, ref_lse, delta, *args)}
            lib = dict.fromkeys(fa.KERNELS)
            if qk == vt:  # one library call takes one dtype
                q4, k4, v4, g4 = (x.view(b, h, -1, d) for x in (q, k, v, g))
                lib["fwd"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True), flush)
                qr, kr, vr = (x.detach().clone().requires_grad_()
                              for x in (q4, k4, v4))
                lib_out = F.scaled_dot_product_attention(qr, kr, vr,
                                                         is_causal=True)
                lib["bwd_dq"] = lib["bwd_dkv"] = time_ms(
                    torch, lambda: torch.autograd.grad(
                        lib_out, (qr, kr, vr), g4, retain_graph=True), flush)
                del qr, kr, vr, lib_out
            types = fa.pair_label((qk, qk)), fa.pair_label((vt, vt))
            attrs = fa.kernel_attributes(pair, d)
            for name in fa.KERNELS:
                k_ms = time_ms(torch, calls[name], flush)
                p_ms = time_ms(torch, plains[name], flush)
                bound, bound_by, bound_f32 = flash_bound(
                    name, b, h, tq, tk, d, causal, vl, *types)
                res[name].update(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                                 bound_by=bound_by, library_ms=lib[name])
                say("flash dtypes", pair=label, kernel=name, B=b, H=h, T=tq,
                    D=d, causal=causal, kernel_ms=f"{k_ms:.6f}",
                    bound_ms=f"{bound:.6f}", bound_by=bound_by,
                    bound_share=f"{bound / k_ms:.4f}",
                    bound_f32_ms=f"{bound_f32:.6f}", plain_ms=f"{p_ms:.6f}",
                    library_ms=("none" if lib[name] is None
                                else f"{lib[name]:.6f}"),
                    attributes=attribute_text(fa, attrs[name]))
        out[label] = res
    torch.cuda.empty_cache()
    return out


def bert_valid_lengths():
    """Phase 6's key lengths at BERT's attention shape: the training
    batch's (112 on every fourth row, the rest 128), with row 1 all
    padding (0)."""
    vl = [BERT_PAD_FROM if i % 4 == 0 else BERT_T for i in range(BERT_B)]
    vl[1] = 0
    return vl


def flash_case_check(torch, fa, dev, what, b, h, tq, tk, d, causal, vl,
                     dtype, seed):
    """Each flash kernel against its plain version on seeded inputs of
    ``dtype`` (q, k, v, g) at one main-path shape: within ATOL / RTOL plus
    one unit in the last place, launches counted on its pair, the rows and
    keys the masks drop exact zeros (lse -1e30), two calls bit for bit.
    Returns ({kernel: {"max_abs_err"}}, the inputs and plain outputs)."""
    pair = (dtype, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b * h, tq, d, device=dev, generator=gen).to(dtype)
    k, v = (torch.randn(b * h, tk, d, device=dev, generator=gen).to(dtype)
            for _ in range(2))
    g = torch.randn(b * h, tq, d, device=dev, generator=gen).to(dtype)
    kvalid = fa.kvalid_of(None if vl is None else torch.tensor(vl), b, tk,
                          dev)
    args = (kvalid, causal, tk - tq, d ** -0.5)
    n0 = fa.launch_count(pair)
    o, lse = fa.flash_fwd(q, k, v, *args)
    check(fa.last_path() == "cuda", "flash call did not take the kernel")
    ref_o, ref_lse = fa.flash_fwd_torch(q, k, v, *args)
    delta = (g.float() * ref_o.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, g, ref_lse, delta, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, ref_lse, delta, *args)
    torch.cuda.synchronize()
    check(fa.launch_count(pair) == {n: c + 1 for n, c in n0.items()},
          f"flash {what}: launches not counted on its pair")
    ref_dq = fa.flash_bwd_dq_torch(q, k, v, g, ref_lse, delta, *args)
    ref_dk, ref_dv = fa.flash_bwd_dkv_torch(q, k, v, g, ref_lse, delta,
                                            *args)
    res = {}
    for name, pairs in (("fwd", ((o, ref_o), (lse, ref_lse))),
                        ("bwd_dq", ((dq, ref_dq),)),
                        ("bwd_dkv", ((dk, ref_dk), (dv, ref_dv)))):
        err = 0.0
        for ours, ref in pairs:
            check(ours.dtype == ref.dtype and bool(torch.isfinite(ours).all()),
                  f"flash {what} {name}: {ours.dtype} or not finite")
            a, r = ours.float(), ref.float()
            diff = (a - r).abs()
            bound = ATOL + RTOL * r.abs() + ulp(
                torch, torch.maximum(a.abs(), r.abs()), ours.dtype)
            check(bool((diff <= bound).all()),
                  f"flash {what} {name} disagrees with plain: "
                  f"max_abs_err={float(diff.max())}")
            err = max(err, float(diff.max()))
        res[name] = {"max_abs_err": err}
    rows, _ = live_rows_keys(b, tq, tk, causal, vl)
    dead = ref_lse <= -1e29
    cut = (torch.arange(tk, device=dev)[None, :]
           >= kvalid.repeat_interleave(h)[:, None])    # keys never kept
    check(int(dead.sum()) == b * h * tq - h * rows
          and bool(torch.equal(lse <= -1e29, dead))
          and not bool(o[dead].any()) and not bool(dq[dead].any())
          and not bool(dk[cut].any()) and not bool(dv[cut].any()),
          f"flash {what}: masked rows or keys are not zeros")
    again = (fa.flash_fwd(q, k, v, *args),
             fa.flash_bwd_dq(q, k, v, g, ref_lse, delta, *args),
             fa.flash_bwd_dkv(q, k, v, g, ref_lse, delta, *args))
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(
        (again[0][0], again[0][1], again[1], again[2][0], again[2][1]),
        (o, lse, dq, dk, dv))), f"flash {what}: two calls differ")
    say("flash bert" if what.startswith("bert") else "flash transformer",
        case=what, B=b, H=h, Tq=tq, Tk=tk, D=d, causal=causal,
        valid_length=("all" if vl is None else f"{min(vl)}..{max(vl)}, "
                      f"mean {statistics.mean(vl):.2f}"),
        dead_rows=int(dead.sum()), masked_keys=int(cut.sum()),
        **{f"{n}_max_abs_err": f"{r['max_abs_err']:.3e}"
           for n, r in res.items()})
    return res, (q, k, v, g, ref_lse, delta, args)


def mt_data(np):
    """Phase 10c's batch: source, target and label tokens, and the
    seeded source lengths (64..128)."""
    rng = np.random.RandomState(0)
    src, tgt, labels = (rng.randint(1, MT_VOCAB, (MT_B, MT_T)).astype(
        np.int64) for _ in range(3))
    svl = rng.randint(MT_T // 2, MT_T + 1, (MT_B,)).astype(np.int64)
    return src, tgt, labels, svl


def flash_bert_phase(torch, np, fa, flush, dev):
    """Phase 6 at BERT-base's attention shape (B=64, H=12, T=128, D=64,
    non-causal, bert_valid_lengths()), in f32 and (bf16, bf16): each kernel
    against its plain version (flash_case_check); its time, bound and
    plain time, and the library: one ``scaled_dot_product_attention`` call
    in the same dtype with a boolean key mask (forward; backward for dq,
    dk, dv), with the device kernels it ran. Then Transformer-base's two
    shapes (B=192, H=8, T=128, D=64, f32, as 10c runs them): the decoder's
    causal self-attention and the encoder's and cross-attention's
    non-causal one over 10c's source lengths, checked alone. Returns
    {"f32" | "bf16": {kernel: numbers}}."""
    import torch.nn.functional as F

    b, h, t, d = BERT_B, BERT_HEADS, BERT_T, BERT_D
    vl = bert_valid_lengths()
    keep = (torch.arange(t, device=dev)[None, :]
            < torch.tensor(vl, device=dev)[:, None])[:, None, None, :]
    out = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        res, (q, k, v, g, ref_lse, delta, args) = flash_case_check(
            torch, fa, dev, f"bert {label}", b, h, t, t, d, False, vl, dtype,
            300)
        calls = {"fwd": lambda: fa.flash_fwd(q, k, v, *args),
                 "bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, g, ref_lse,
                                                   delta, *args),
                 "bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, g, ref_lse,
                                                     delta, *args)}
        plains = {"fwd": lambda: fa.flash_fwd_torch(q, k, v, *args),
                  "bwd_dq": lambda: fa.flash_bwd_dq_torch(
                      q, k, v, g, ref_lse, delta, *args),
                  "bwd_dkv": lambda: fa.flash_bwd_dkv_torch(
                      q, k, v, g, ref_lse, delta, *args)}
        q4, k4, v4, g4 = (x.view(b, h, t, d) for x in (q, k, v, g))
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=keep), flush)
        fwd_kernels = device_kernels(
            torch, lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                          attn_mask=keep))
        qr, kr, vr = (x.detach().clone().requires_grad_()
                      for x in (q4, k4, v4))
        lib_out = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=keep)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), g4, retain_graph=True), flush)
        bwd_kernels = device_kernels(torch, lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), g4, retain_graph=True))
        say("flash bert", pair=label, library="sdpa with a boolean key mask",
            sdpa_forward_kernels=json.dumps(sorted(fwd_kernels)),
            sdpa_backward_kernels=json.dumps(sorted(bwd_kernels)))
        del qr, kr, vr, lib_out
        attrs = fa.kernel_attributes((dtype, dtype), d)
        for name in fa.KERNELS:
            k_ms = time_ms(torch, calls[name], flush)
            p_ms = time_ms(torch, plains[name], flush)
            bound, bound_by, bound_f32 = flash_bound(
                name, b, h, t, t, d, False, vl, label, label)
            lib_ms = lib_fwd if name == "fwd" else lib_bwd
            res[name].update(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                             bound_by=bound_by, library_ms=lib_ms)
            say("flash bert", pair=label, kernel=name, kernel_ms=f"{k_ms:.6f}",
                bound_ms=f"{bound:.6f}", bound_by=bound_by,
                bound_share=f"{bound / k_ms:.4f}",
                bound_f32_ms=f"{bound_f32:.6f}", plain_ms=f"{p_ms:.6f}",
                library_ms=f"{lib_ms:.6f}",
                kernel_over_library=f"{k_ms / lib_ms:.3f}",
                attributes=attribute_text(fa, attrs[name]))
        out[label] = res
    svl = [int(x) for x in mt_data(np)[3]]
    for what, causal, lengths in (("transformer decoder self", True, None),
                                  ("transformer encoder/cross", False, svl)):
        flash_case_check(torch, fa, dev, what, MT_B, MT_HEADS, MT_T, MT_T,
                         MT_D, causal, lengths, torch.float32, 301)
    torch.cuda.empty_cache()
    return out


def train_run(torch, mt, fa, get_llama, Trainer, loss_mod, dev, route,
              toks, keep_initial):
    """Three Adam steps of the 4-layer Llama-3-8B-width model on ``toks``
    with the attention on ``route`` (None: the kernels; "torch": plain).
    Returns (losses, step ms, launches, peak bytes, params on the host,
    initial params on the host or None)."""
    mt.random.seed(0)
    model = get_llama(CONFIG, device=dev, trainable=True,
                      num_layers=TRAIN_LAYERS)
    initial = ({n: p.detach().to("cpu", copy=True)
                for n, p in model.named_parameters()}
               if keep_initial else None)
    trainer = Trainer(model.parameters(), "adam",
                      {"learning_rate": TRAIN_LR})
    loss_fn = loss_mod.SoftmaxCrossEntropyLoss()
    x = torch.from_numpy(toks[:, :-1]).to(dev)
    y = torch.from_numpy(toks[:, 1:]).to(dev)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.force_path(route)
    fa.reset_launch_count()
    try:
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            loss = loss_fn(model(x), y)
            loss.sum().backward()          # MXNet's loss.backward()
            trainer.step(TRAIN_B)
            losses.append(float(loss.detach().mean()))  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        fa.force_path(None)
    launches = fa.launch_count()
    peak = torch.cuda.max_memory_allocated()
    final = {n: p.detach().to("cpu", copy=True)
             for n, p in model.named_parameters()}
    del model, trainer, loss, x, y
    torch.cuda.empty_cache()
    return losses, step_ms, launches, peak, final, initial


def train_phase(torch, np, mt, fa, get_llama, Trainer, loss_mod, dev, vocab):
    """Phase 7: train Llama-3-8B width at depth 4 on the kernel route, then
    the same steps with the plain attention forced; returns the kernel
    route's launches and its step ms (steps 2-3), tokens/s, peak memory
    and final weights on the host."""
    toks = np.random.RandomState(0).randint(
        0, vocab, size=(TRAIN_B, TRAIN_T + 1)).astype(np.int64)
    runs = {}
    for route in (None, "torch"):
        losses, step_ms, launches, peak, final, initial = train_run(
            torch, mt, fa, get_llama, Trainer, loss_mod, dev, route, toks,
            keep_initial=route is None)
        label = "kernel" if route is None else "plain"
        tok_s = TRAIN_B * TRAIN_T / (statistics.mean(step_ms[1:]) / 1e3)
        say("train", route=label, layers=TRAIN_LAYERS, B=TRAIN_B,
            T=TRAIN_T, losses=[f"{x:.6f}" for x in losses],
            step_ms=[f"{x:.3f}" for x in step_ms],
            tokens_s=f"{tok_s:.3f}", peak_mem_bytes=peak,
            launches=launches)
        check(all(np.isfinite(losses)), f"{label} route: loss not finite")
        check(losses[-1] < losses[0], f"{label} route: loss did not fall "
              f"({losses})")
        runs[label] = (losses, launches, final, initial)
        if route is None:
            summary = {"step_ms": statistics.mean(step_ms[1:]),
                       "tokens_s": tok_s, "peak": peak, "final": final}
    k_losses, k_launches, k_final, initial = runs["kernel"]
    p_losses, p_launches, p_final, _ = runs["plain"]
    want = TRAIN_LAYERS * TRAIN_STEPS
    check(k_launches == dict.fromkeys(fa.KERNELS, want),
          f"kernel route launched {k_launches}, want {want} of each")
    check(p_launches == dict.fromkeys(fa.KERNELS, 0),
          f"plain route launched the kernels: {p_launches}")
    loss_diff = max(abs(a - b) for a, b in zip(k_losses, p_losses))
    max_diff, rel = route_agreement(torch, dev, k_final, p_final, initial)
    say("train", loss_max_diff=f"{loss_diff:.3e}",
        param_max_abs_diff=f"{max_diff:.3e}",
        param_diff_over_movement=f"{rel:.3e}",
        params=sum(t.numel() for t in k_final.values()))
    check(loss_diff <= LOSS_ATOL, f"losses differ from the plain route by "
          f"{loss_diff} > {LOSS_ATOL}")
    check(max_diff <= PARAM_ATOL and rel <= PARAM_RTOL,
          f"parameters differ from the plain route: max {max_diff} "
          f"(limit {PARAM_ATOL}), relative {rel} (limit {PARAM_RTOL})")
    return k_launches, summary


def route_agreement(torch, dev, k_final, p_final, initial, top=0):
    """Phase 7's measures of two runs' weights: the largest difference,
    and the norm of the difference over the norm of how far ``k_final``
    moved from ``initial``; with ``top``, also the ``top`` parameters with
    the largest share of the squared difference, as (name, share)."""
    max_diff, diff_sq, moved_sq, by_name = 0.0, 0.0, 0.0, {}
    for name, pk in k_final.items():
        pk, pp, p0 = (t.to(dev) for t in (pk, p_final[name], initial[name]))
        max_diff = max(max_diff, float((pk - pp).abs().max()))
        by_name[name] = float(((pk - pp).double() ** 2).sum())
        diff_sq += by_name[name]
        moved_sq += float(((pk - p0).double() ** 2).sum())
    rel = (diff_sq / moved_sq) ** 0.5 if moved_sq else float("inf")
    if not top:
        return max_diff, rel
    worst = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return max_diff, rel, [(n, d / diff_sq if diff_sq else 0.0)
                           for n, d in worst]


# 7b's reading of where the routes' weight difference lies: bands of |d| in
# units of lr; 1.5-2.5 lr is an Adam step that went the other way (each
# route moves such a weight by about lr, in opposite directions)
DIFF_BANDS_LR = (0.0, 0.5, 1.5, 2.5, float("inf"))


def diff_bands(torch, dev, k_final, p_final, lr):
    """For each band of DIFF_BANDS_LR, the weights whose difference between
    two runs lies in it (the first band counts only those that differ at
    all) and the band's share of the difference's squared norm."""
    edges = torch.tensor([e * lr for e in DIFF_BANDS_LR[1:-1]], device=dev)
    n = len(DIFF_BANDS_LR) - 1
    counts = torch.zeros(n, dtype=torch.float64, device=dev)
    sq = torch.zeros(n, dtype=torch.float64, device=dev)
    for name, pk in k_final.items():
        d = (pk.to(dev) - p_final[name].to(dev)).abs().flatten()
        d = d[d > 0]
        band = torch.bucketize(d, edges)
        counts += torch.bincount(band, minlength=n).double()
        sq += torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
            0, band, d.double() ** 2)
    total = float(sq.sum()) or 1.0
    names = [f"{a:g}-{b:g}lr" if b < float("inf") else f">{a:g}lr"
             for a, b in zip(DIFF_BANDS_LR, DIFF_BANDS_LR[1:])]
    return {"diff_bands": json.dumps({
        nm: [int(c), round(float(q) / total, 4)]
        for nm, c, q in zip(names, counts, sq)})}


def train_amp_run(torch, mt, fa, get_llama, ShardedTrainer, loss_mod, dev,
                  route, toks, windowed, keep):
    """Three bf16 AMP steps of the 4-layer Llama-3-8B-width model with
    per-layer recompute, through ``ShardedTrainer(dtype="bfloat16")``:
    three ``step()`` calls, or (``windowed``) one ``step_n`` window of
    three over the batch stacked three times, with the attention on
    ``route``. Returns (losses, step ms, launches by dtype pair, peak
    bytes, final params on the host or None, initial params or None)."""
    mt.random.seed(0)
    model = get_llama(CONFIG, device=dev, trainable=True,
                      num_layers=TRAIN_LAYERS, remat=True)
    initial = ({n: p.detach().to("cpu", copy=True)
                for n, p in model.named_parameters()}
               if keep == "both" else None)
    trainer = ShardedTrainer(model, loss_mod.SoftmaxCrossEntropyLoss(),
                             "adam", {"learning_rate": TRAIN_LR},
                             dtype="bfloat16")
    x = torch.from_numpy(toks[:, :-1]).to(dev)
    y = torch.from_numpy(toks[:, 1:]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.force_path(route)
    fa.reset_launch_count()
    try:
        t0 = time.perf_counter()
        if windowed:
            n = TRAIN_STEPS
            losses = [float(v) for v in trainer.step_n(
                x.expand(n, *x.shape), y.expand(n, *y.shape))]
            step_ms = [(time.perf_counter() - t0) * 1e3 / n] * n
        else:
            losses, step_ms = [], []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                losses.append(float(trainer.step(x, y)))  # waits for it
                step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        fa.force_path(None)
    launches = {fa.pair_label(p): fa.launch_count(p) for p in fa.DTYPE_PAIRS}
    peak = torch.cuda.max_memory_allocated()
    final = ({n: p.detach().to("cpu", copy=True)
              for n, p in model.named_parameters()} if keep else None)
    del model, trainer, x, y
    torch.cuda.empty_cache()
    return losses, step_ms, launches, peak, final, initial


def train_amp_phase(torch, np, mt, fa, get_llama, ShardedTrainer, loss_mod,
                    dev, vocab, f32):
    """Phase 7b: phase 7's model, batch and optimizer under
    ``ShardedTrainer(dtype="bfloat16")`` with per-layer recompute: three
    ``step()`` calls on the kernel route, one ``step_n`` window of three on
    a fresh model from the same seed, and the steps with the plain
    attention forced. ``f32``: phase 7's kernel-route step ms, tokens/s,
    peak (printed beside) and final weights: the same model, batch and
    Adam steps in f32. Returns the kernel route's launches by dtype
    pair."""
    toks = np.random.RandomState(0).randint(
        0, vocab, size=(TRAIN_B, TRAIN_T + 1)).astype(np.int64)
    runs = {}
    for label, route, windowed, keep in (("kernel", None, False, "both"),
                                         ("kernel step_n", None, True, None),
                                         ("plain", "torch", False, "final")):
        losses, step_ms, launches, peak, final, initial = train_amp_run(
            torch, mt, fa, get_llama, ShardedTrainer, loss_mod, dev, route,
            toks, windowed, keep)
        ms = statistics.mean(step_ms[1:])
        tok_s = TRAIN_B * TRAIN_T / (ms / 1e3)
        say("train amp", route=label, dtype="bfloat16", remat=True,
            layers=TRAIN_LAYERS, B=TRAIN_B, T=TRAIN_T,
            losses=[f"{x:.6f}" for x in losses],
            step_ms=[f"{x:.3f}" for x in step_ms], tokens_s=f"{tok_s:.3f}",
            peak_mem_bytes=peak, launches=json.dumps(launches))
        check(all(np.isfinite(losses)), f"amp {label}: loss not finite")
        check(losses[-1] < losses[0], f"amp {label}: loss did not fall "
              f"({losses})")
        runs[label] = (losses, launches, final, initial, ms, tok_s, peak)
    k_losses, k_launches, k_final, initial, ms, tok_s, peak = runs["kernel"]
    p_losses, p_launches, p_final = runs["plain"][:3]
    layer0 = (torch.float32, torch.bfloat16)  # v_proj's bf16 v meets f32 q, k
    want = {fa.pair_label(p): dict.fromkeys(fa.KERNELS, 0)
            for p in fa.DTYPE_PAIRS}
    steps = TRAIN_STEPS
    want[fa.pair_label(layer0)] = {"fwd": 2 * steps, "bwd_dq": steps,
                                   "bwd_dkv": steps}
    rest = TRAIN_LAYERS - 1
    want["f32"] = {"fwd": 2 * rest * steps, "bwd_dq": rest * steps,
                   "bwd_dkv": rest * steps}
    for label in ("kernel", "kernel step_n"):
        check(runs[label][1] == want, f"amp {label} launched "
              f"{runs[label][1]}, want {want}")
    check(all(v == dict.fromkeys(fa.KERNELS, 0) for v in p_launches.values()),
          f"amp plain route launched the kernels: {p_launches}")
    window_diff = max(abs(a - b) for a, b in zip(runs["kernel step_n"][0],
                                                 k_losses))
    loss_diff = max(abs(a - b) for a, b in zip(k_losses, p_losses))
    max_diff, rel, worst = route_agreement(torch, dev, k_final, p_final,
                                           initial, top=4)
    # the distance bf16 itself puts between these weights and phase 7's f32
    # ones, which AMP_PARAM_RTOL must stay well inside
    _, rel_f32, _ = route_agreement(torch, dev, k_final, f32["final"],
                                    initial, top=1)
    bands = diff_bands(torch, dev, k_final, p_final, TRAIN_LR)
    say("train amp", step_n_loss_max_diff=f"{window_diff:.3e}",
        loss_max_diff=f"{loss_diff:.3e}",
        param_max_abs_diff=f"{max_diff:.3e}",
        param_diff_over_movement=f"{rel:.3e}",
        amp_vs_f32_over_movement=f"{rel_f32:.3e}",
        largest_shares=json.dumps([[n, round(x, 4)] for n, x in worst]),
        **bands)
    say("train amp", amp_step_ms=f"{ms:.3f}", f32_step_ms=f"{f32['step_ms']:.3f}",
        amp_tokens_s=f"{tok_s:.3f}", f32_tokens_s=f"{f32['tokens_s']:.3f}",
        amp_peak_mem_bytes=peak, f32_peak_mem_bytes=f32["peak"],
        step_ratio=f"{ms / f32['step_ms']:.4f}")
    check(window_diff <= LOSS_ATOL, f"step_n's losses differ from step()'s "
          f"by {window_diff} > {LOSS_ATOL}")
    check(loss_diff <= LOSS_ATOL, f"amp losses differ from the plain route "
          f"by {loss_diff} > {LOSS_ATOL}")
    check(AMP_PARAM_RTOL <= rel_f32 / 4, f"the amp weight limit "
          f"{AMP_PARAM_RTOL} is over a quarter of the bf16 run's distance "
          f"from the f32 run ({rel_f32})")
    check(max_diff <= PARAM_ATOL and rel <= AMP_PARAM_RTOL,
          f"amp parameters differ from the plain route: max {max_diff} "
          f"(limit {PARAM_ATOL}), relative {rel} (limit {AMP_PARAM_RTOL})")
    return k_launches


def pair_bound(m, c1, cm, cout, elem, residual, mid):
    """Least time (ms) of one pair launch: x, the residual, the weights and
    affines read once and y and the mid written once, over the memory rate,
    against its two products (2 M C1 Cm + 2 M Cm Cout flops) over the
    tensor cores' bf16 rate or the f32 rate outside them."""
    nbytes = (elem * (m * c1 + m * cout + c1 * cm + cm * cout
                      + m * cm * (int(residual) + int(mid)))
              + 4 * 2 * (cm + cout))
    flops = 2 * m * cm * (c1 + cout)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOP_PER_S if elem == 2 else F32_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pair_phase(torch, c1x1, FusedResNetV1, flush, dev):
    """Phase 8: the fused 1x1-pair kernel against its plain version. Returns
    {dtype name: numbers summed over one ResNet-50 forward's 12 launches,
    max error}."""
    affine_relu = FusedResNetV1._affine_relu
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for stage, _, m, c1, cm in PAIR_STAGES:
        plan = c1x1.split_plan(m, cm, c1, sms)
        layouts = {name: c1x1.smem_layout(dt, plan, c1)
                   for name, dt in (("bf16", torch.bfloat16),
                                    ("f32", torch.float32))}
        say("pair", stage=stage, sms=sms, slices=plan.slices,
            slice_cols=plan.slice_cols, grid=list(plan.grid),
            blocks=plan.blocks, workspace_bytes=plan.workspace_bytes,
            tile=f"{plan.block_rows}x{plan.block_cols}",
            **{f"{k}_{f}": v for k, lay in layouts.items()
               for f, v in lay.items()})
        if stage >= 3:
            check(plan.slices > 1 and plan.blocks >= sms,
                  f"stage {stage} grid {plan.grid} does not fill {sms} SMs")
    results = {}
    cases = [(m, c1, cm, c1, True, True, (stage, n))
             for stage, n, m, c1, cm in PAIR_STAGES]
    cases += [(*c, None) for c in PAIR_EXTRA]
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        r = results[name] = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                             "bound_ms": 0.0, "library_ms": 0.0,
                             "bound_by_ms": {"bytes": 0.0, "operations": 0.0}}
        for i, (m, c1, cm, cout, residual, mid, stage) in enumerate(cases):
            gen = torch.Generator(device=dev).manual_seed(200 + i)

            def rnd(*shape, scale=1.0, shift=0.0):
                return (torch.randn(*shape, device=dev, generator=gen)
                        * scale + shift)

            x = rnd(m, c1, scale=0.5).relu().to(dtype)
            w1 = rnd(c1, cm, scale=(2.0 / c1) ** 0.5).to(dtype)
            w2 = rnd(cm, cout, scale=(2.0 / cm) ** 0.5).to(dtype)
            aff = [rnd(cm, scale=0.2, shift=1.0), rnd(cm, scale=0.1),
                   rnd(cout, scale=0.2, shift=1.0), rnd(cout, scale=0.1)]
            res = rnd(m, cm, scale=0.5).to(dtype) if residual else None

            def kernel():
                return c1x1.conv1x1_pair(x, w1, w2, *aff, residual=res,
                                         return_mid=mid)

            def plain():
                return c1x1.conv1x1_pair_torch(x, w1, w2, *aff, residual=res,
                                               return_mid=mid)

            got = kernel()
            check(c1x1.last_path() == "cuda", "pair call did not take the "
                  "kernel")
            again = kernel()
            torch.cuda.synchronize()
            ref = plain()
            got, again, ref = ((got, again, ref) if mid else
                               ((got,), (again,), (ref,)))
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"pair kernel does not repeat bit for bit ({name}, M={m} "
                  f"C1={c1} Cm={cm} Cout={cout})")
            err = 0.0
            for ours, theirs in zip(got, ref):
                check(bool(torch.isfinite(ours).all()),
                      "pair kernel output not finite")
                diff = (ours.float() - theirs.float()).abs()
                if dtype == torch.float32:
                    ok = bool((diff <= PAIR_F32_TOL
                               + PAIR_F32_TOL * theirs.abs()).all())
                else:
                    ok = float(diff.max()) <= PAIR_BF16_TOL * float(
                        theirs.float().abs().max())
                check(ok, f"pair kernel disagrees with plain ({name}, M={m} "
                      f"C1={c1} Cm={cm} Cout={cout} residual={residual} "
                      f"mid={mid}): max_abs_err={float(diff.max())}")
                err = max(err, float(diff.max()))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            del got, again, ref
            fields = dict(dtype=name, M=m, C1=c1, Cm=cm, Cout=cout,
                          residual=residual, mid=mid,
                          slices=c1x1.split_plan(m, cm, cout, sms).slices,
                          repeats_bitwise=True, max_abs_err=f"{err:.3e}")
            if stage is None:
                say("pair", **fields)
                continue
            # a stage of the main path: times against the bound
            ad = [a.to(dtype) for a in aff]  # the fused model's cast affines

            def library():
                y = affine_relu(x @ w1, (ad[0], ad[1]), relu=False)
                h = torch.relu(y + res).to(dtype)
                return affine_relu(h @ w2, (ad[2], ad[3])), h

            k_ms = time_ms(torch, kernel, flush)
            p_ms = time_ms(torch, plain, flush)
            l_ms = time_ms(torch, library, flush)
            bound, bound_by = pair_bound(m, c1, cm, cout, dtype.itemsize,
                                         residual, mid)
            n = stage[1]
            r["ms"] += n * k_ms
            r["plain_ms"] += n * p_ms
            r["library_ms"] += n * l_ms
            r["bound_ms"] += n * bound
            r["bound_by_ms"][bound_by] += n * bound
            say("pair", stage=stage[0], launches_per_forward=n, **fields,
                kernel_ms=f"{k_ms:.6f}", bound_ms=f"{bound:.6f}",
                bound_by=bound_by, plain_ms=f"{p_ms:.6f}",
                library_ms=f"{l_ms:.6f}",
                library="use_pallas_false_boundary_2_matmul_epilogue",
                kernel_tflop_s=f"{2 * m * cm * (c1 + cout) / k_ms / 1e9:.3f}")
            if stage[0] < 3:
                continue
            # the grid aimed at more blocks a SM, in turns with the default
            sweep = {}
            default = c1x1.BLOCKS_PER_SM
            try:
                for per_sm in PAIR_SWEEP_BLOCKS_PER_SM * 2:
                    c1x1.BLOCKS_PER_SM = per_sm
                    sweep.setdefault(per_sm, []).append(
                        (c1x1.split_plan(m, cm, cout, sms).slices,
                         time_ms(torch, kernel, flush)))
            finally:
                c1x1.BLOCKS_PER_SM = default
            say("pair sweep", stage=stage[0], dtype=name, **{
                f"blocks_per_sm_{k}": f"S={v[0][0]}:"
                f"{v[0][1]:.6f},{v[1][1]:.6f}" for k, v in sweep.items()})
        by = r.pop("bound_by_ms")
        r["bound_by"] = max(by, key=by.get)
        say("pair", dtype=name, forward_12_launches_kernel_ms=f"{r['ms']:.6f}",
            bound_ms=f"{r['bound_ms']:.6f}", bound_by=r["bound_by"],
            plain_ms=f"{r['plain_ms']:.6f}",
            library_ms=f"{r['library_ms']:.6f}",
            kernel_under_library=r["ms"] < r["library_ms"])
    return results


def resnet_burn_in(torch, np, model, dev):
    """Move the BatchNorm running statistics off their initial values: one
    train-mode pass over 8 seeded images (no gradients), as the JAX fuse
    test does."""
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (8, 3, RESNET_HW, RESNET_HW)).astype(np.float32)).to(dev)
    model.train()
    with torch.no_grad():
        model(x)
    model.eval()


def img_s(torch, sess, batch, reps=10):
    """Images/s of ``sess.predict`` on one batch: CUDA events around each
    call (host padding and copy included), median of ``reps`` after two
    warm calls."""
    for _ in range(2):
        sess.predict(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        sess.predict(batch)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    ms = statistics.median(times)
    return batch.shape[0] / ms * 1e3, ms


def device_profile(torch, module, x):
    """(device ms of one forward of ``module`` on ``x``, of which in the
    pair kernel), from a ``torch.profiler`` trace of one forward after a
    warm one; None if the trace holds no device time."""
    with torch.inference_mode():
        ms = device_kernels(torch, lambda: module(x))
    total = sum(ms.values())
    pair = sum(t for name, t in ms.items() if "conv1x1_pair" in name)
    return (total, pair) if total else None


def resnet_phase(torch, np, mt, c1x1, vision, fuse, Session, dev):
    """Phase 9: ResNet-50 v1 fused and served through the pair kernel.
    Returns the kernel's launches by dtype: bf16 over the served run, f32
    over the f32 kernel arm's own forward (each counted from 0)."""
    import copy

    mt.random.seed(0)
    t0 = time.perf_counter()
    model = vision.get_resnet(1, 50, device=dev)
    resnet_burn_in(torch, np, model, dev)
    torch.cuda.synchronize()
    n_weights = sum(p.numel() for p in model.parameters())
    n_state = sum(t.numel() for t in model.state_dict().values())
    say("resnet", model="resnet50_v1", params=n_weights,
        params_and_bn_stats=n_state, init_s=f"{time.perf_counter() - t0:.3f}")
    check(n_state == 25_610_152, f"resnet50_v1 holds {n_state} values")
    rng = np.random.RandomState(0)
    requests = [rng.uniform(-1, 1, (n, 3, RESNET_HW, RESNET_HW)).astype(
        np.float32)
                for n in RESNET_REQUESTS]
    fused = fuse(model, dtype="bfloat16", use_pallas=True)
    plain_fused = fuse(model, dtype="bfloat16", use_pallas=False)
    forwards = []
    fused.register_forward_pre_hook(lambda mod, a: forwards.append(
        a[0].shape[0]))

    # the main path: counts to 0, serve, read the counts
    c1x1.reset_launch_count()
    sess = Session(fused, batch_buckets=RESNET_BUCKETS, name="resnet50_v1")
    t0 = time.perf_counter()
    sigs = sess.warmup(requests[0])
    warm_s = time.perf_counter() - t0
    outs = [sess.predict(r) for r in requests]
    torch.cuda.synchronize()
    sess.assert_no_recompiles()
    served = c1x1.launch_count(torch.bfloat16)
    launches = {"bf16": sum(served.values())}
    check(served == {"pair": 0, "pair_res": 0,
                     "pair_res_mid": RESNET_PAIRS * len(forwards)},
          f"{served} pair launches for {len(forwards)} forwards")
    for r, o in zip(requests, outs):
        check(tuple(o.shape) == (r.shape[0], 1000) and o.dtype ==
              torch.float32, f"logits {tuple(o.shape)} {o.dtype}")
        check(bool(torch.isfinite(o).all()), "served logits not finite")
    say("resnet", arm="bf16_kernel", warmup_s=f"{warm_s:.3f}",
        signatures=sigs, forwards=forwards, pair_launches=served)

    # the library arm launches nothing
    n0 = c1x1.launch_count()
    lib_sess = Session(plain_fused, batch_buckets=RESNET_BUCKETS,
                       name="resnet50_v1_library")
    lib_sess.warmup(requests[0])
    lib_outs = [lib_sess.predict(r) for r in requests]
    lib_sess.assert_no_recompiles()
    check(c1x1.launch_count() == n0, "use_pallas=False launched the kernel")
    arm_diff = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(outs, lib_outs))
    say("resnet", arm="bf16_library", pair_launches=0,
        max_rel_diff_to_kernel_arm=f"{arm_diff:.3e}")

    # f32 on 2 images: both arms and the unfused model, and the CPU
    x2 = torch.from_numpy(requests[1][:2]).to(dev)
    f32_fused = fuse(model, dtype="float32", use_pallas=True)
    with torch.inference_mode():
        unfused = model(x2)
        f32_library = fuse(model, dtype="float32", use_pallas=False)(x2)
        bf16_kernel = fused(x2)
        # the f32 kernel arm's own run: counts to 0, one forward, read
        c1x1.reset_launch_count()
        f32_kernel = f32_fused(x2)
        torch.cuda.synchronize()
        launches["f32"] = sum(c1x1.launch_count(torch.float32).values())
    check(launches["f32"] == RESNET_PAIRS and not any(
        c1x1.launch_count(torch.bfloat16).values()),
          f"f32 kernel arm launched {c1x1.launch_count()} for one forward")
    say("resnet", arm="f32_kernel", images=2, forwards=1,
        pair_launches=launches["f32"])
    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        cpu_logits = cpu_model(x2.cpu())
    del cpu_model
    scale = float(unfused.abs().max())
    errs = {"f32_kernel_vs_unfused": f32_kernel,
            "f32_library_vs_unfused": f32_library}
    errs = {k: float((v - unfused).abs().max()) / scale
            for k, v in errs.items()}
    errs["card_unfused_vs_cpu"] = float(
        (unfused.cpu() - cpu_logits).abs().max()) / float(
            cpu_logits.abs().max())
    bf16_err = float((bf16_kernel - unfused).abs().max()) / scale
    say("resnet", **{k: f"{v:.3e}" for k, v in errs.items()},
        bf16_kernel_vs_f32=f"{bf16_err:.3e}", max_abs_logit=f"{scale:.4f}")
    for k, v in errs.items():
        check(v < LOGIT_F32_TOL, f"{k}: {v} >= {LOGIT_F32_TOL}")
    check(bf16_err < LOGIT_BF16_TOL, f"bf16 kernel arm vs f32: {bf16_err}")

    # top-1 of the bf16 arm against f32 on the 32-image request
    x32 = requests[2]
    with torch.inference_mode():
        f32_top = model(torch.from_numpy(x32).to(dev)).argmax(-1)
    top1 = float((outs[2].argmax(-1) == f32_top).float().mean())
    say("resnet", bf16_top1_agreement_with_f32=f"{top1:.4f}", images=32)

    # throughput at batch 32, the arms in turns; then device time a forward
    f32_sess = Session(model, batch_buckets=(32,), name="resnet50_v1_f32")
    arms = (("bf16_kernel", sess, fused), ("bf16_library", lib_sess,
                                           plain_fused),
            ("f32_unfused", f32_sess, model))
    rates = {label: [] for label, _, _ in arms}
    for _ in range(3):
        for label, s, _ in arms:
            rates[label].append(img_s(torch, s, x32)[0])
    say("resnet", batch=32, rounds=3, **{
        f"{k}_img_s": [f"{r:.3f}" for r in v] for k, v in rates.items()},
        **{f"{k}_img_s_median": f"{statistics.median(v):.3f}"
           for k, v in rates.items()})
    x32d = torch.from_numpy(x32).to(dev)
    for label, _, module in arms:
        prof = device_profile(torch, module, x32d)
        if prof is None:
            say("resnet", arm=label, forward_device_ms="not measured (no "
                "device time in the profiler trace)")
            continue
        say("resnet", arm=label, batch=32, forward_device_ms=f"{prof[0]:.4f}",
            pair_device_ms=f"{prof[1]:.4f}",
            pair_share=f"{prof[1] / prof[0]:.4f}",
            device_img_s=f"{32 / prof[0] * 1e3:.3f}")
    del model, fused, plain_fused, sess, lib_sess, f32_sess
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def request_ms(torch, sess, batch, reps=10):
    """Median ms of ``sess.predict(batch)`` (host padding and copy
    included): CUDA events around each call, after two warm calls."""
    return 1e3 * batch.shape[0] / img_s(torch, sess, batch, reps)[0]


def flash_share(torch, kernels):
    """(device ms of the three flash kernels, of everything) in a
    ``device_kernels`` reading."""
    flash = sum(ms for name, ms in kernels.items()
                if any(f"flash_{k}" in name for k in ("fwd", "bwd_dq",
                                                      "bwd_dkv")))
    return flash, sum(kernels.values())


def flash_fwd_ms(kernels):
    """Device ms of the flash forward kernel in a ``device_kernels``
    reading."""
    return sum(ms for name, ms in kernels.items() if "flash_fwd" in name)


def bert_serve_phase(torch, np, mt, fa, models, Session, dev):
    """Phase 10a: BERT-base's classifier (f32, eval) behind ``BERTStep``,
    served by ``InferenceSession`` over (batch, seq) buckets. Returns the
    served run's launches by kernel (of the f32 pair)."""
    mt.random.seed(0)
    t0 = time.perf_counter()
    block = models.BERTStep(models.BERTClassifier(
        models.get_bert_model(BERT_CONFIG, device=dev), num_classes=2)).eval()
    torch.cuda.synchronize()
    say("bert serve", model=BERT_CONFIG, head="BERTClassifier(2)",
        params=sum(p.numel() for p in block.parameters()),
        init_s=f"{time.perf_counter() - t0:.3f}")
    rng = np.random.RandomState(0)
    requests = [rng.randint(1, BERT_TOKENS, size=shape).astype(np.int64)
                for shape in BERT_REQUESTS]
    # a row of padding only (valid_length 0: every key masked); the rows the
    # batch bucket adds repeat it, as the session pads by edge
    requests[1][-1] = 0
    forwards = []
    hook = block.register_forward_pre_hook(
        lambda mod, a: forwards.append(tuple(a[0].shape)))
    # the main path: counts to 0, warm up and serve, read the counts
    fa.reset_launch_count()
    sess = Session(block, batch_buckets=BERT_BUCKETS,
                   seq_buckets=BERT_SEQ_BUCKETS, pad_value=0,
                   name="bert_base")
    t0 = time.perf_counter()
    sigs = sess.warmup(requests[0])
    warm_s = time.perf_counter() - t0
    outs = [sess.predict(r) for r in requests]
    torch.cuda.synchronize()
    sess.assert_no_recompiles()
    served = fa.launch_count((torch.float32, torch.float32))
    hook.remove()
    check(fa.launch_count() == served == {
        "fwd": BERT_LAYERS * len(forwards), "bwd_dq": 0, "bwd_dkv": 0},
          f"bert serve: {fa.launch_count()} launches for {len(forwards)} "
          "forwards")
    check(sigs == len(BERT_BUCKETS) * len(BERT_SEQ_BUCKETS),
          f"bert serve: {sigs} signatures after warmup")
    fa.force_path("torch")
    try:
        plain = [sess.predict(r) for r in requests]
    finally:
        fa.force_path(None)
    sess.assert_no_recompiles()
    errs = []
    for r, o, p in zip(requests, outs, plain):
        check(tuple(o.shape) == (r.shape[0], 2) and o.dtype == torch.float32,
              f"bert logits {tuple(o.shape)} {o.dtype}")
        check(bool(torch.isfinite(o).all()), "bert logits not finite")
        errs.append(float((o - p).abs().max() / p.abs().max()))
    say("bert serve", warmup_s=f"{warm_s:.3f}", signatures=sigs,
        forwards=len(forwards), fwd_launches=served["fwd"],
        requests=[list(r.shape) for r in requests],
        valid_length_0_rows=1,
        max_rel_diff_to_plain=[f"{e:.3e}" for e in errs])
    check(max(errs) <= LOGIT_F32_TOL, f"bert logits differ from the plain "
          f"route by {max(errs)} of the largest logit")
    ms = [request_ms(torch, sess, r) for r in requests]
    rates = [img_s(torch, sess, requests[2])[0] for _ in range(3)]
    say("bert serve", ms_per_request={f"{n}x{t}": f"{m:.3f}" for (n, t), m
                                      in zip(BERT_REQUESTS, ms)},
        batch=32, rounds=3, samples_s=[f"{x:.3f}" for x in rates],
        samples_s_median=f"{statistics.median(rates):.3f}")
    x = torch.from_numpy(requests[2]).to(dev)
    with torch.inference_mode():
        flash, total = flash_share(torch, device_kernels(
            torch, lambda: block(x)))
    if total:
        say("bert serve", batch=32, T=128, forward_device_ms=f"{total:.4f}",
            flash_fwd_device_ms=f"{flash:.4f}",
            flash_share=f"{flash / total:.4f}")
    else:
        say("bert serve", forward_device_ms="not measured (no device time "
            "in the profiler trace)")
    del block, sess, x
    free_cuda(torch)
    return served


def bert_batch(np):
    """bench.py's _bert_setup batch: tokens, MLM labels, NSP labels."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(1, BERT_TOKENS, (BERT_B, BERT_T)).astype(np.int64)
    tokens[::4, BERT_PAD_FROM:] = 0
    mlm = rng.randint(1, BERT_TOKENS, (BERT_B, BERT_T)).astype(np.int64)
    nsp = rng.randint(0, 2, (BERT_B,)).astype(np.int64)
    return tokens, mlm, nsp


def bert_train_run(torch, mt, fa, models, ShardedTrainer, Trainer, loss_mod,
                   dev, batch, route, mode, keep, profile):
    """Three Adam steps (lr 1e-4) of BERT-base pretraining (MLM + NSP,
    dropout 0.1) behind ``BERTStep`` on ``batch``, the attention on
    ``route``. ``mode``: "steps" (three ``step()`` of
    ``ShardedTrainer(dtype="bfloat16")``), "step_n" (one window of three)
    or "f32" (``gluon.Trainer`` in f32); ``route`` None (the kernels),
    "versions" or "torch" (``force_path(route)``). The weights and the
    dropout stream come from seed 0. ``keep``: "both" (initial and final
    weights), "final" or None. With ``profile``, RATE_STEPS more steps
    are timed after the final weights are taken, then two more run, the
    second under the profiler. Returns a dict."""
    ce = loss_mod.SoftmaxCrossEntropyLoss()

    def loss_fn(outs, labels):
        return ce(outs[0], labels[0]).mean() + ce(outs[1], labels[1]).mean()

    mt.random.seed(0)
    net = models.BERTStep(models.BERTForPretrain(
        models.get_bert_model(BERT_CONFIG, device=dev)))
    initial = ({n: p.detach().to("cpu", copy=True)
                for n, p in net.named_parameters()}
               if keep == "both" else None)
    tokens, mlm, nsp = (torch.from_numpy(a).to(dev) for a in batch)
    if mode == "f32":
        trainer = Trainer(net.parameters(), "adam",
                          {"learning_rate": TRAIN_LR})

        def step():
            loss = loss_fn(net(tokens), (mlm, nsp))
            loss.backward()
            trainer.step(1)       # the loss is already the batch mean
            return loss.detach()
    else:
        trainer = ShardedTrainer(net, loss_fn, "adam",
                                 {"learning_rate": TRAIN_LR},
                                 dtype="bfloat16")

        def step():
            return trainer.step(tokens, (mlm, nsp))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    fa.force_path(route)
    try:
        if mode == "step_n":
            n = TRAIN_STEPS
            t0 = time.perf_counter()
            losses = [float(v) for v in trainer.step_n(
                tokens.expand(n, *tokens.shape),
                (mlm.expand(n, *mlm.shape), nsp.expand(n, *nsp.shape)))]
            step_ms = [(time.perf_counter() - t0) * 1e3 / n] * n
        else:
            losses, step_ms = [], []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                losses.append(float(step()))   # waits for the step
                step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {fa.pair_label(p): fa.launch_count(p)
                    for p in fa.DTYPE_PAIRS}
        peak = torch.cuda.max_memory_allocated()
        final = ({n: p.detach().to("cpu", copy=True)
                  for n, p in net.named_parameters()} if keep else None)
        window = prof = None
        if profile:
            window = []
            for _ in range(RATE_STEPS):
                t0 = time.perf_counter()
                float(step())
                window.append((time.perf_counter() - t0) * 1e3)
            kernels = device_kernels(torch, step)
            prof = flash_share(torch, kernels) + (flash_fwd_ms(kernels),)
    finally:
        fa.force_path(None)
    del net, trainer, tokens, mlm, nsp
    free_cuda(torch)
    return {"losses": losses, "step_ms": step_ms, "launches": launches,
            "peak": peak, "final": final, "initial": initial,
            "window": window, "prof": prof}


def grad_distance(a, b):
    """Norm of the difference of two {name: gradient} over the norm of
    ``b``'s."""
    diff = sum(float(((a[n] - g).double() ** 2).sum()) for n, g in b.items())
    return (diff / sum(float((g.double() ** 2).sum())
                       for g in b.values())) ** 0.5


def bert_first_grads(torch, mt, fa, models, ShardedTrainer, loss_fn, dev,
                     batch, route, dtype):
    """The f32 masters' gradients of BERT-base pretraining's first step
    (seed 0, dropout on) through ``ShardedTrainer(dtype=dtype)``, on
    ``route``: the step's forward and backward without the update."""
    mt.random.seed(0)
    net = models.BERTStep(models.BERTForPretrain(
        models.get_bert_model(BERT_CONFIG, device=dev)))
    trainer = ShardedTrainer(net, loss_fn, "adam",
                             {"learning_rate": TRAIN_LR}, dtype=dtype)
    tokens, mlm, nsp = (torch.from_numpy(a).to(dev) for a in batch)
    fa.force_path(route)
    try:
        with trainer._train_mode():
            trainer._loss(tokens, (mlm, nsp)).backward()
    finally:
        fa.force_path(None)
    return {n: p.grad for n, p in net.named_parameters()}


def route_distances(phase, torch, dev, runs, initial, ref, against):
    """Losses (largest difference over the steps) and weights (norm of the
    difference over the norm of ``ref``'s movement) of each run named in
    ``against`` from run ``ref``, printed with where the weight difference
    lies; returns {name: (loss gap, largest weight difference,
    relative)}."""
    r = runs[ref]
    out = {}
    for label in against:
        p = runs[label]
        gap = max(abs(x - y) for x, y in zip(r["losses"], p["losses"]))
        max_diff, rel, worst = route_agreement(torch, dev, r["final"],
                                               p["final"], initial, top=4)
        say(phase, run=ref, against=label, loss_max_diff=f"{gap:.3e}",
            param_max_abs_diff=f"{max_diff:.3e}",
            param_diff_over_movement=f"{rel:.3e}",
            largest_shares=json.dumps([[n, round(x, 4)] for n, x in worst]),
            **diff_bands(torch, dev, r["final"], p["final"], TRAIN_LR))
        out[label] = (gap, max_diff, rel)
    return out


def bert_train_phase(torch, np, mt, fa, models, ShardedTrainer, Trainer,
                     loss_mod, dev):
    """Phase 10b: BERT-base pretraining as bench.py trains it, under
    ``ShardedTrainer(dtype="bfloat16")``: three ``step()`` calls, a
    ``step_n`` window of three from the same seed (bit for bit), the steps
    on both plain routes and the f32 ``gluon.Trainer`` yardstick; the
    kernel route's losses, weights and first-step gradients within
    ROUTE_SCALE times the noise of each plain route, and its f32 first-step
    gradients within GRAD_RTOL of the plain versions'. Returns the kernel
    route's launches by dtype pair and the f32 run's."""
    batch = bert_batch(np)
    runs = {}
    for label, route, mode, keep, profile in (
            ("kernel", None, "steps", "both", True),
            ("kernel step_n", None, "step_n", None, False),
            ("plain versions", "versions", "steps", "final", False),
            ("forced plain", "torch", "steps", "final", False),
            ("f32", None, "f32", "final", True)):
        r = bert_train_run(torch, mt, fa, models, ShardedTrainer, Trainer,
                           loss_mod, dev, batch, route, mode, keep, profile)
        ms = statistics.mean(r["step_ms"][1:])
        fields = {}
        if r["window"]:
            w = r["window"]
            r["rate"] = BERT_B * len(w) / (sum(w) / 1e3)
            fields = dict(window_steps=len(w),
                          window_step_ms=f"{min(w):.3f}/"
                          f"{statistics.median(w):.3f}/{max(w):.3f}",
                          window_samples_s=f"{r['rate']:.3f}")
        if r["prof"] and r["prof"][1]:
            flash, total, fwd = r["prof"]
            fields.update(step_device_ms=f"{total:.3f}",
                          flash_ms_per_step=f"{flash:.3f}",
                          flash_fwd_ms_per_step=f"{fwd:.3f}",
                          flash_share=f"{flash / total:.4f}")
        elif r["prof"]:
            fields.update(step_device_ms="not measured (no device time in "
                          "the profiler trace)")
        say("bert train", route=label,
            dtype="float32" if mode == "f32" else "bfloat16",
            trainer="gluon.Trainer" if mode == "f32" else "ShardedTrainer",
            B=BERT_B, T=BERT_T, losses=[f"{x:.6f}" for x in r["losses"]],
            step_ms=[f"{x:.3f}" for x in r["step_ms"]],
            samples_s=f"{BERT_B / (ms / 1e3):.3f}", peak_mem_bytes=r["peak"],
            launches=json.dumps({k: v for k, v in r["launches"].items()
                                 if any(v.values())}), **fields)
        # finite, but not falling: bench.py's Adam at 1e-4 with no warmup
        # raises BERT's loss over the first steps, in the JAX package too
        check(all(np.isfinite(r["losses"])), f"bert {label}: loss not finite")
        r["ms"] = ms
        runs[label] = r
    zero = dict.fromkeys(fa.KERNELS, 0)
    bf16 = fa.pair_label((torch.bfloat16, torch.bfloat16))
    want = {fa.pair_label(p): zero for p in fa.DTYPE_PAIRS}
    want[bf16] = dict.fromkeys(fa.KERNELS, BERT_LAYERS * TRAIN_STEPS)
    for label in ("kernel", "kernel step_n"):
        check(runs[label]["launches"] == want, f"bert {label} launched "
              f"{runs[label]['launches']}, want {want}")
    for label in ("plain versions", "forced plain"):
        check(all(v == zero for v in runs[label]["launches"].values()),
              f"bert {label} launched the kernels: "
              f"{runs[label]['launches']}")
    f32_want = dict(want, **{bf16: zero, "f32": want[bf16]})
    check(runs["f32"]["launches"] == f32_want, f"bert f32 launched "
          f"{runs['f32']['launches']}, want {f32_want}")
    k, f = runs["kernel"], runs["f32"]
    window = runs["kernel step_n"]["losses"]
    say("bert train", step_n_losses_equal=window == k["losses"])
    check(window == k["losses"], f"bert step_n's losses {window} are not "
          f"step()'s {k['losses']}")
    # the yardstick, printed: each bf16 route's distance from the f32 run
    gaps = route_distances("bert train", torch, dev, runs, k["initial"],
                           "f32", ("kernel", "plain versions",
                                   "forced plain"))
    plain = route_distances("bert train", torch, dev, runs, k["initial"],
                            "plain versions", ("forced plain",))
    _, _, scale_rel = plain["forced plain"]
    others = [runs[n]["losses"] for n in ("plain versions", "forced plain",
                                          "f32")]
    scale_loss = [max(xs) - min(xs) for xs in zip(*others)]
    say("bert train", loss_noise_per_step=[f"{x:.3e}" for x in scale_loss],
        weight_noise=f"{scale_rel:.3e}",
        kernel_from_f32=f"{gaps['kernel'][2]:.3e}")
    for label, (_, max_diff, rel) in route_distances(
            "bert train", torch, dev, runs, k["initial"], "kernel",
            ("plain versions", "forced plain")).items():
        for step, (a, b, lim) in enumerate(zip(
                k["losses"], runs[label]["losses"], scale_loss)):
            check(abs(a - b) <= LOSS_ATOL + ROUTE_SCALE * lim,
                  f"bert step {step}: the kernels' loss {a} and the {label} "
                  f"route's {b} differ by more than {LOSS_ATOL} + "
                  f"{ROUTE_SCALE} x {lim}")
        check(max_diff <= PARAM_ATOL and rel <= ROUTE_SCALE * scale_rel,
              f"bert weights differ from the {label} route: max {max_diff} "
              f"(limit {PARAM_ATOL}), relative {rel} (limit {ROUTE_SCALE} x "
              f"{scale_rel})")
    del runs
    free_cuda(torch)
    ce = loss_mod.SoftmaxCrossEntropyLoss()

    def loss_fn(outs, labels):
        return ce(outs[0], labels[0]).mean() + ce(outs[1], labels[1]).mean()

    grads = {}
    for key in ((None, None), ("versions", None), (None, "bfloat16"),
                ("versions", "bfloat16"), ("torch", "bfloat16")):
        grads[key] = bert_first_grads(torch, mt, fa, models, ShardedTrainer,
                                      loss_fn, dev, batch, *key)
    f32_err = grad_distance(grads[None, None], grads["versions", None])
    noise = grad_distance(grads["versions", "bfloat16"],
                          grads["torch", "bfloat16"])
    errs = {route: grad_distance(grads[None, "bfloat16"],
                                 grads[route, "bfloat16"])
            for route in ("versions", "torch")}
    say("bert train", first_step_grads_f32_kernels_vs_plain=f"{f32_err:.3e}",
        first_step_grads_bf16_plain_routes=f"{noise:.3e}",
        **{f"first_step_grads_bf16_kernels_vs_{r}": f"{e:.3e}"
           for r, e in errs.items()},
        **{f"first_step_grads_bf16_{r or 'kernels'}_vs_f32":
           f"{grad_distance(grads[r, 'bfloat16'], grads[None, None]):.3e}"
           for r in (None, "versions", "torch")})
    check(f32_err <= GRAD_RTOL, f"bert f32 first-step gradients: the "
          f"kernels {f32_err} of the norm from the plain versions'")
    for route, e in errs.items():
        check(e <= ROUTE_SCALE * noise, f"bert bf16 first-step gradients: "
              f"the kernels {e} of the norm from the {route} route's, limit "
              f"{ROUTE_SCALE} x {noise}")
    del grads
    free_cuda(torch)
    say("bert train", amp_step_ms=f"{k['ms']:.3f}",
        f32_step_ms=f"{f['ms']:.3f}",
        amp_window_samples_s=f"{k['rate']:.3f}",
        f32_window_samples_s=f"{f['rate']:.3f}",
        amp_peak_mem_bytes=k["peak"], f32_peak_mem_bytes=f["peak"],
        window_rate_ratio=f"{k['rate'] / f['rate']:.4f}")
    return k["launches"], f["launches"]


def mt_train_run(torch, mt, fa, models, Trainer, loss_mod, dev, data, route,
                 keep_initial):
    """Three f32 Adam steps (lr 1e-4) of Transformer-base (dropout 0.1,
    seed 0) through ``gluon.Trainer`` on ``data``, the attention on
    ``route``. Returns (losses, step ms, launches, peak bytes, final
    weights on the host, initial weights or None, the first step's
    gradients on the device)."""
    mt.random.seed(0)
    model = models.Transformer(MT_VOCAB, tie_embeddings=True, device=dev)
    initial = ({n: p.detach().to("cpu", copy=True)
                for n, p in model.named_parameters()}
               if keep_initial else None)
    trainer = Trainer(model.parameters(), "adam", {"learning_rate": TRAIN_LR})
    loss_fn = loss_mod.SoftmaxCrossEntropyLoss()
    src, tgt, labels, svl = (torch.from_numpy(a).to(dev) for a in data)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    fa.force_path(route)
    try:
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            loss = loss_fn(model(src, tgt, svl), labels)
            loss.sum().backward()          # MXNet's loss.backward()
            if i == 0:
                grads = {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}
            trainer.step(MT_B)
            losses.append(float(loss.detach().mean()))  # waits for it
            step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        fa.force_path(None)
    launches = fa.launch_count()
    peak = torch.cuda.max_memory_allocated()
    final = {n: p.detach().to("cpu", copy=True)
             for n, p in model.named_parameters()}
    del model, trainer, loss, src, tgt, labels, svl
    free_cuda(torch)
    return losses, step_ms, launches, peak, final, initial, grads


def mt_train_phase(torch, np, mt, fa, models, Trainer, loss_mod, dev):
    """Phase 10c: Transformer-base (shared 37000-token vocabulary) in f32,
    three Adam steps at B=192, T_src = T_tgt = 128, seeded source lengths,
    on the kernels and on both plain routes (ROUTE_SCALE, also for the
    first step's gradients). Returns the kernel route's launches."""
    data = mt_data(np)
    runs = {}
    for label, route in (("kernel", None), ("plain versions", "versions"),
                         ("forced plain", "torch")):
        losses, step_ms, launches, peak, final, initial, grads = \
            mt_train_run(torch, mt, fa, models, Trainer, loss_mod, dev,
                         data, route, keep_initial=route is None)
        ms = statistics.mean(step_ms[1:])
        say("transformer", route=label, units=512, layers="6+6",
            vocab=MT_VOCAB, B=MT_B, T_src=MT_T, T_tgt=MT_T,
            losses=[f"{x:.6f}" for x in losses],
            step_ms=[f"{x:.3f}" for x in step_ms],
            tgt_tokens_s=f"{MT_B * MT_T / (ms / 1e3):.3f}",
            peak_mem_bytes=peak, launches=launches)
        check(all(np.isfinite(losses)), f"transformer {label}: loss not "
              "finite")
        check(losses[-1] < losses[0], f"transformer {label}: loss did not "
              f"fall ({losses})")
        runs[label] = {"losses": losses, "launches": launches,
                       "final": final, "initial": initial, "grads": grads}
    k, v, f = runs["kernel"], runs["plain versions"], runs["forced plain"]
    # a step: 6 encoder self-attentions, 6 decoder causal self-attentions
    # and 6 cross-attentions, each one forward and one backward
    want = 3 * MT_LAYERS * TRAIN_STEPS
    check(k["launches"] == dict.fromkeys(fa.KERNELS, want),
          f"transformer launched {k['launches']}, want {want} of each")
    for label in ("plain versions", "forced plain"):
        check(runs[label]["launches"] == dict.fromkeys(fa.KERNELS, 0),
              f"transformer {label} launched the kernels: "
              f"{runs[label]['launches']}")
    scale = grad_distance(v["grads"], f["grads"])
    errs = {label: grad_distance(k["grads"], runs[label]["grads"])
            for label in ("plain versions", "forced plain")}
    say("transformer", first_step_grads_plain_routes=f"{scale:.3e}",
        **{f"first_step_grads_kernels_vs_{label.replace(' ', '_')}":
           f"{e:.3e}" for label, e in errs.items()},
        params=sum(t.numel() for t in k["final"].values()))
    for label, e in errs.items():
        check(e <= ROUTE_SCALE * scale, f"transformer first-step gradients: "
              f"the kernels {e} of the norm from the {label} route's, limit "
              f"{ROUTE_SCALE} x {scale}")
    for r in runs.values():
        del r["grads"]
    free_cuda(torch)
    scale = route_distances("transformer", torch, dev, runs, k["initial"],
                            "plain versions", ("forced plain",))
    scale_loss, _, scale_rel = scale["forced plain"]
    for label, (gap, max_diff, rel) in route_distances(
            "transformer", torch, dev, runs, k["initial"], "kernel",
            ("plain versions", "forced plain")).items():
        check(gap <= LOSS_ATOL + ROUTE_SCALE * scale_loss,
              f"transformer losses differ from the {label} route by {gap}, "
              f"limit {LOSS_ATOL} + {ROUTE_SCALE} x {scale_loss}")
        check(max_diff <= PARAM_ATOL and rel <= ROUTE_SCALE * scale_rel,
              f"transformer weights differ from the {label} route: max "
              f"{max_diff} (limit {PARAM_ATOL}), relative {rel} (limit "
              f"{ROUTE_SCALE} x {scale_rel})")
    return k["launches"]


def rel_max(a, b):
    """Largest |a - b| over the largest |b|."""
    b = b.double()
    return float((a.double().cpu() - b.cpu()).abs().max()
                 / b.abs().max().clamp_min(1e-30))


def c3_op_phase(torch, F, nn_ops, dev):
    """Phase 11a: the port's f32 convolution on the card, forward and both
    gradients, against float64 on the CPU at ResNet-50's stem (7 x 7,
    stride 2), a 3 x 3 and a strided 1 x 1, beside the same convolution
    under PyTorch's defaults (cuDNN TF32 on); no global flag may move."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    cases = (("stem_7x7_s2", (2, 3, 224, 224), (64, 3, 7, 7), 2, 3),
             ("3x3", (2, 64, 56, 56), (64, 64, 3, 3), 1, 1),
             ("1x1_s2", (2, 256, 56, 56), (512, 256, 1, 1), 2, 0))
    worst = 0.0
    for label, xs, ws, stride, pad in cases:
        gen = torch.Generator().manual_seed(11)
        x = torch.randn(xs, generator=gen)
        w = torch.randn(ws, generator=gen) / ws[1] ** 0.5
        x64 = x.double().requires_grad_()
        w64 = w.double().requires_grad_()
        y64 = F.conv2d(x64, w64, None, stride, pad)
        gy = torch.randn(y64.shape, generator=gen)
        y64.backward(gy.double())
        errs = {}
        for arm, conv in (("port", nn_ops.convolution), ("torch_default",
                                                        F.conv2d)):
            xc = x.to(dev).requires_grad_()
            wc = w.to(dev).requires_grad_()
            yc = conv(xc, wc, None, stride, pad)
            yc.backward(gy.to(dev))
            errs[arm] = {"out": rel_max(yc.detach(), y64.detach()),
                         "dx": rel_max(xc.grad, x64.grad),
                         "dw": rel_max(wc.grad, w64.grad)}
        say("resnet train", c3_op=label, **{
            f"{arm}_{k}": f"{v:.3e}" for arm, e in errs.items()
            for k, v in e.items()})
        worst = max(worst, *errs["port"].values())
        check(max(errs["port"].values()) <= C3_OP_TOL,
              f"C3: the port's f32 convolution {label} is not full f32: "
              f"{errs['port']} relative to float64")
    check((torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32) == flags,
          "C3: a global TF32 flag moved")
    return worst


def state_cpu(model):
    """{name: float64 CPU copy} of every parameter and buffer."""
    return {n: t.detach().to("cpu").double()
            for n, t in model.state_dict().items()
            if t.is_floating_point()}


def moved_distance(torch, dev, ref, other, init, keys):
    """``route_agreement``'s norm of ``ref - other`` over the norm of
    ``ref``'s movement from ``init``, over ``keys``."""
    return route_agreement(torch, dev, {n: ref[n] for n in keys}, other,
                           init)[1]


def split_keys(state):
    stats = [n for n in state if "running" in n]
    return [n for n in state if n not in stats], stats


def c3_step(torch, nn_ops, model, x, y, loss_mod, Trainer, tf32):
    """One f32 SGD step of ``model`` through ``gluon.Trainer`` on the mean
    loss: (loss, {name: gradient}, state after), float64 on the CPU. With
    ``tf32`` the convolutions run under cuDNN's default TF32."""
    import contextlib

    orig = nn_ops._full_f32
    if tf32:
        nn_ops._full_f32 = lambda device: contextlib.nullcontext()
    try:
        tr = Trainer(model.parameters(), "sgd", dict(RT_SGD))
        loss = loss_mod.SoftmaxCrossEntropyLoss()(model(x), y).mean()
        loss.backward()
        grads = {n: p.grad.detach().to("cpu", torch.float64, copy=True)
                 for n, p in model.named_parameters()}
        tr.step(1)
    finally:
        nn_ops._full_f32 = orig
    return float(loss.detach()), grads, state_cpu(model)


def c3_model_phase(torch, np, mt, nn_ops, vision, loss_mod, Trainer, dev):
    """Phase 11b: one f32 SGD step of resnet50_v1 at batch 8 on the card
    and on the CPU, each against the same step in float64 on the CPU (the
    loss, the gradients, the weights and running statistics after it), and
    the card's step with TF32 convolutions beside them."""
    import copy

    mt.random.seed(0)
    base = vision.get_resnet(1, 50, device="cpu", trainable=True)
    init = state_cpu(base)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.uniform(
        -1, 1, (C3_MODEL_BATCH, 3, RESNET_HW, RESNET_HW)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, RT_CLASSES, C3_MODEL_BATCH))
    t0 = time.perf_counter()
    runs = {}
    for arm in ("cpu_f64", "cpu", "card", "card_tf32"):
        d = dev if arm.startswith("card") else torch.device("cpu")
        model = copy.deepcopy(base).to(d)
        xs = x.to(d)
        if arm == "cpu_f64":
            model, xs = model.double(), xs.double()
        runs[arm] = c3_step(torch, nn_ops, model, xs, y.to(d), loss_mod,
                            Trainer, arm == "card_tf32")
        del model
    ref_loss, ref_g, ref_s = runs["cpu_f64"]
    weights, stats = split_keys(ref_s)
    out = {}
    for arm in ("cpu", "card", "card_tf32"):
        loss, grads, state = runs[arm]
        out[arm] = {
            "loss": abs(loss - ref_loss) / abs(ref_loss),
            "grads": grad_distance(grads, ref_g),
            "weights": moved_distance(torch, dev, ref_s, state, init,
                                      weights),
            "stats": moved_distance(torch, dev, ref_s, state, init, stats)}
    say("resnet train", c3_model="resnet50_v1", batch=C3_MODEL_BATCH,
        reference="cpu_f64", loss=f"{ref_loss:.6f}",
        seconds=f"{time.perf_counter() - t0:.3f}",
        **{f"{arm}_{k}": f"{v:.3e}" for arm, e in out.items()
           for k, v in e.items()})
    for k, v in out["card"].items():
        limit = C3_MODEL_SCALE * out["cpu"][k] + C3_MODEL_ATOL
        check(v <= limit, f"C3 model step: the card's f32 {k} {v:.3e} from "
              f"float64, limit {limit:.3e} (the CPU's f32: "
              f"{out['cpu'][k]:.3e})")
    free_cuda(torch)
    return out


def resnet_data(torch, np, dev):
    """bench.py's synthetic batch: 256 images uniform in [-1, 1), labels
    in [0, 1000), from seed 0; on the card."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (RT_BATCH, 3, RESNET_HW, RESNET_HW)).astype(
        np.float32)
    y = rng.randint(0, RT_CLASSES, RT_BATCH)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def bn_stats(model):
    return [m for m in model.modules() if hasattr(m, "running_var")]


def resnet_train_run(torch, mt, vision, loss_mod, ShardedTrainer, Trainer,
                     metric, dev, data, dtype, mode, timed=False):
    """Three SGD steps of resnet50_v1 from seed 0 on ``data``: ``mode``
    "steps" (``ShardedTrainer.step``), "step_n" (one window of three) or
    "trainer" (``gluon.Trainer`` in f32, MXNet's summed loss and
    ``step(batch)``, with ``Accuracy`` and ``TopKAccuracy(5)``). Gated on
    finite losses and running statistics that moved and stayed finite.
    With ``timed``: RATE_STEPS steps (or RT_WINDOWS windows of RT_FUSE)
    on the host clock, then one step (window) under ``torch.profiler``,
    one more for its wall time, and (``step()`` runs) the BatchNorm layers
    alone.
    Returns a dict; the state after the three steps on the CPU."""
    x, y = data
    mt.random.seed(0)
    model = vision.get_resnet(1, 50, device=dev, trainable=True)
    init = state_cpu(model) if mode == "steps" and dtype is None else None
    lf = loss_mod.SoftmaxCrossEntropyLoss()
    metrics = None
    if mode == "trainer":
        tr = Trainer(model.parameters(), "sgd", dict(RT_SGD))
        metrics = [metric.Accuracy(), metric.TopKAccuracy(5)]

        def step():
            out = model(x)
            loss = lf(out, y)
            loss.sum().backward()       # MXNet's loss.backward()
            tr.step(x.shape[0])
            for m in metrics:
                m.update([y], [out])
            return loss.detach().mean()
    else:
        tr = ShardedTrainer(model, lf, "sgd", dict(RT_SGD), dtype=dtype)

        def step():
            return tr.step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if mode == "step_n":
        xs = x.expand(RT_GATED, *x.shape)
        ys = y.expand(RT_GATED, *y.shape)
        losses = [float(v) for v in tr.step_n(xs, ys)]
    else:
        losses = [float(step()) for _ in range(RT_GATED)]
    gated_s = time.perf_counter() - t0
    check(all(map(math.isfinite, losses)),
          f"resnet train {dtype} {mode}: loss {losses}")
    for m in bn_stats(model):
        check(bool(torch.isfinite(m.running_var).all()
                   and torch.isfinite(m.running_mean).all()),
              f"resnet train {dtype} {mode}: running statistics not finite")
        check(m.running_var.dtype == torch.float32,
              f"resnet train: running_var is {m.running_var.dtype}")
    check(all(bool((m.running_mean != 0).any()) for m in bn_stats(model)),
          f"resnet train {dtype} {mode}: running statistics did not move")
    final = state_cpu(model)
    res = {"losses": losses, "final": final, "init": init,
           "flops": getattr(tr, "step_flops", None), "gated_s": gated_s,
           "metrics": ([m.get() for m in metrics] if metrics else None)}
    if timed:
        if mode == "step_n":
            xs = x.expand(RT_FUSE, *x.shape)
            ys = y.expand(RT_FUSE, *y.shape)

            def window():
                return tr.step_n(xs, ys)[-1]
            per, reps = RT_FUSE, RT_WINDOWS
        else:
            window, per, reps = step, 1, RATE_STEPS
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(window())
            times.append((time.perf_counter() - t0) * 1e3 / per)
        kernels = device_kernels(torch, window)
        res.update(step_ms=times, peak=torch.cuda.max_memory_allocated(),
                   device_ms=sum(kernels.values()) / per,
                   kernels=kernels, per=per)
        if mode == "steps":
            res["bn_alone_ms"] = bn_layer_ms(
                torch, model, x, torch.bfloat16 if dtype else torch.float32)
        # the profiled call's own wall time, for the busy share
        t0 = time.perf_counter()
        float(window())
        res["wall_ms"] = (time.perf_counter() - t0) * 1e3 / per
    del model, tr
    free_cuda(torch)
    return res


def bn_layer_ms(torch, model, x, dtype):
    """Device ms of every BatchNorm of ``model`` in train mode, forward and
    backward, at the input shapes one step gives them, run alone (CUDA
    events over 5 repeats after a warm one): the step's BatchNorm share
    where its kernels carry no name of their own (the 16-bit composite)."""
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: shapes.append((mod, tuple(inp[0].shape))))
        for m in bn_stats(model)]
    with torch.no_grad():
        model(x[:8])
    for h in hooks:
        h.remove()
    total = 0.0
    for mod, shape in shapes:
        layer = type(mod)(in_channels=shape[1]).to(x.device)
        layer.reset_parameters()
        layer = layer.to(dtype).train()
        inp = torch.randn((x.shape[0],) + shape[1:], device=x.device,
                          dtype=dtype, requires_grad=True)
        grad = torch.randn_like(inp)
        layer(inp).backward(grad)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            layer(inp).backward(grad)
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1) / 5
    return total


def conv_bn_share(kernels):
    """{"conv", "bn", "other"} device ms from {kernel name: ms}: the
    convolutions (cuDNN and cuBLAS conv and gemm kernels, the weight
    gradient's im2col), cuDNN's BatchNorm kernels, and everything else
    (elementwise and reductions: the 16-bit BatchNorm, ReLU, the residual
    adds, casts, pooling, the optimizer)."""
    out = {"conv": 0.0, "bn": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        low = name.lower()
        if any(k in low for k in ("conv", "gemm", "xmma", "cutlass", "sm90",
                                  "implicit", "wgrad", "dgrad", "fprop",
                                  "im2col")):
            out["conv"] += ms
        elif "batch_norm" in low or "bn_" in low or "batchnorm" in low:
            out["bn"] += ms
        else:
            out["other"] += ms
    return out


def resnet_train_phase(torch, np, mt, vision, loss_mod, ShardedTrainer,
                       Trainer, metric, dev):
    """Phase 11c-d: ResNet-50 v1 at batch 256 trained in f32, in bf16 and
    as bf16 ``step_n`` windows of 8, and the f32 ``gluon.Trainer`` loop."""
    data = resnet_data(torch, np, dev)
    t0 = time.perf_counter()
    a = resnet_train_run(torch, mt, vision, loss_mod, ShardedTrainer,
                         Trainer, metric, dev, data, None, "steps",
                         timed=True)
    b = resnet_train_run(torch, mt, vision, loss_mod, ShardedTrainer,
                         Trainer, metric, dev, data, None, "steps")
    c = resnet_train_run(torch, mt, vision, loss_mod, ShardedTrainer,
                         Trainer, metric, dev, data, None, "step_n")
    d = resnet_train_run(torch, mt, vision, loss_mod, ShardedTrainer,
                         Trainer, metric, dev, data, None, "trainer")
    e = resnet_train_run(torch, mt, vision, loss_mod, ShardedTrainer,
                         Trainer, metric, dev, data, "bfloat16", "steps",
                         timed=True)
    f = resnet_train_run(torch, mt, vision, loss_mod, ShardedTrainer,
                         Trainer, metric, dev, data, "bfloat16", "step_n",
                         timed=True)
    g = resnet_train_run(torch, mt, vision, loss_mod, ShardedTrainer,
                         Trainer, metric, dev, data, "bfloat16", "steps")
    init = a["init"]
    weights, stats = split_keys(init)

    def dist(ref, other, keys=weights):
        return moved_distance(torch, dev, ref["final"], other["final"], init,
                              keys)

    pairs = {"f32_steps_twice": dist(a, b), "f32_step_n_vs_steps": dist(a, c),
             "f32_trainer_vs_steps": dist(a, d),
             "bf16_steps_twice": dist(e, g), "bf16_step_n_vs_steps": dist(e, f),
             "bf16_vs_f32": dist(a, e),
             "f32_stats_steps_twice": dist(a, b, stats),
             "bf16_vs_f32_stats": dist(a, e, stats)}
    bitwise = {k: a_["losses"] == b_["losses"] and all(
        torch.equal(a_["final"][n], b_["final"][n]) for n in a_["final"])
        for k, (a_, b_) in {"f32": (a, b), "f32_step_n": (a, c),
                            "bf16": (e, g), "bf16_step_n": (e, f)}.items()}
    say("resnet train", **{k: f"{v:.3e}" for k, v in pairs.items()},
        **{f"bitwise_{k}": v for k, v in bitwise.items()},
        losses_f32=[f"{v:.6f}" for v in a["losses"]],
        losses_bf16=[f"{v:.6f}" for v in e["losses"]],
        losses_trainer=[f"{v:.6f}" for v in d["losses"]],
        trainer_metrics=d["metrics"],
        seconds=f"{time.perf_counter() - t0:.3f}")
    # step_n against step(): bit for bit where two step() runs are, else
    # within twice their distance (cuDNN's and max-pool's backward add in
    # no fixed order)
    for prec, (same, n_vs_s) in {
            "f32": (bitwise["f32"], "f32_step_n_vs_steps"),
            "bf16": (bitwise["bf16"], "bf16_step_n_vs_steps")}.items():
        twice = pairs[f"{prec}_steps_twice"]
        if same:
            check(bitwise[f"{prec}_step_n"], f"resnet train {prec}: two "
                  "step() runs are bitwise equal, step_n is not")
        else:
            check(pairs[n_vs_s] <= ROUTE_SCALE * twice,
                  f"resnet train {prec}: step_n {pairs[n_vs_s]:.3e} from "
                  f"step(), two step() runs {twice:.3e}")
    noise = max(pairs["f32_steps_twice"], pairs["f32_step_n_vs_steps"])
    check(pairs["f32_trainer_vs_steps"] <= ROUTE_SCALE * noise,
          f"resnet train: gluon.Trainer {pairs['f32_trainer_vs_steps']:.3e} "
          f"from the f32 ShardedTrainer steps, limit {ROUTE_SCALE} x "
          f"{noise:.3e}")
    rows = {}
    for label, r, peak_flops in (("f32", a, F32_FLOP_PER_S),
                                 ("bf16", e, BF16_FLOP_PER_S),
                                 ("bf16_step_n8", f, BF16_FLOP_PER_S)):
        ms = r["step_ms"]
        med = statistics.median(ms)
        share = conv_bn_share(r["kernels"])
        rows[label] = {
            "img_s": RT_BATCH * len(ms) / (sum(ms) / 1e3),
            "step_ms_fastest": min(ms), "step_ms_median": med,
            "step_ms_slowest": max(ms), "device_ms": r["device_ms"],
            "busy": r["device_ms"] / r["wall_ms"],
            "peak_gb": r["peak"] / 1e9, "step_flops": r["flops"],
            "floor_ms": r["flops"] / peak_flops * 1e3,
            "mfu": r["flops"] / (med / 1e3) / peak_flops,
            **{f"{k}_ms": v / r["per"] for k, v in share.items()},
            "batchnorm_alone_ms": r.get("bn_alone_ms", "not measured")}
        say("resnet train", run=label, batch=RT_BATCH,
            steps_timed=len(ms) if r["per"] == 1 else
            f"{len(ms)} windows of {r['per']}",
            **{k: (f"{v:.4f}" if isinstance(v, float) else v)
               for k, v in rows[label].items()})
    top = sorted(e["kernels"].items(), key=lambda kv: -kv[1])[:8]
    print("  bf16 step, top device kernels (ms): "
          + "; ".join(f"{n[:60]}={t:.2f}" for n, t in top), flush=True)
    top = sorted(a["kernels"].items(), key=lambda kv: -kv[1])[:8]
    print("  f32 step, top device kernels (ms): "
          + "; ".join(f"{n[:60]}={t:.2f}" for n, t in top), flush=True)
    del data
    free_cuda(torch)
    return rows, pairs


def replay_logits(da, gen, prompts, tokens, steps, route):
    """The (prompts, vocab) logits of ``gen`` after its prefill and
    ``steps`` single decode steps fed ``tokens`` (a run's greedy tokens by
    row), with the decode attention on ``route`` (``None``: the kernel;
    ``"torch"``: the plain version)."""
    da.force_path(route)
    try:
        toks, lens, bb = gen._pad_prompts(prompts)
        lg, cache = gen.prefill(toks, lens, gen._fresh_cache(bb))
        pos = lens.copy()
        for j in range(steps):
            ids = [tokens[r][j] if r < len(tokens) else 0 for r in range(bb)]
            lg, cache = gen.decode_step(ids, pos, cache)
            pos = pos + 1
    finally:
        da.force_path(None)
    return lg[:len(prompts)].float()


def first_divergence(torch, da, gen, prompts, a, b):
    """Row and step of the first differing greedy token of the kernel run
    ``a`` and the plain run ``b``, with each route's logit gap between the
    two candidates there (both routes replay the plain run's tokens)."""
    row, step = next((i, j) for j in range(NEW_TOKENS)
                     for i in range(len(a)) if a[i][j:j + 1] != b[i][j:j + 1])
    ta, tb = a[row][step], b[row][step]
    logits = {route: replay_logits(da, gen, prompts, b, step, route)[row]
              for route in (None, "torch")}
    gap_k = float(logits[None][ta] - logits[None][tb])
    gap_p = float(logits["torch"][ta] - logits["torch"][tb])
    diff = float((logits[None] - logits["torch"]).abs().max())
    return (f"row={row} step={step} kernel_token={ta} plain_token={tb} "
            f"kernel_gap={gap_k:.6e} plain_gap={gap_p:.6e} "
            f"max_logit_diff={diff:.6e}")


class ForwardCount:
    """The eager forward calls of ``model`` from construction to
    ``close()`` (a forward pre-hook, so graph replays, which run no
    Python, are not counted): ``calls`` of them, ``prefills`` over more
    than one position."""

    def __init__(self, model):
        self.calls = self.prefills = 0
        self._hook = model.register_forward_pre_hook(self._count)

    def _count(self, module, args):
        self.calls += 1
        self.prefills += int(args[0].shape[1] > 1)

    def close(self):
        self._hook.remove()


def int8_expected(rung, prefills, b1_launches, layers, products=INT8_FORWARD):
    """The int8 products a serving run must launch: ``products`` a forward
    on the ``int8`` rung (its projections run on int8 weights), none on
    ``pallas``. The forwards are the eager prefills and the decode
    iterations, each of which launched B1 once a layer, eagerly or in a
    replayed graph."""
    check(b1_launches % layers == 0,
          f"{b1_launches} B1 launches over {layers} layers")
    if rung != "int8":
        return 0
    return products * (prefills + b1_launches // layers)


def int8_gate(phase, rung, got, want):
    check(got == want, f"{phase}: {got} int8-product launches, expected "
          f"{want} ({INT8_FORWARD} a forward on int8, 0 on pallas)")


def first_step_states(da, gen, prompts, tokens, route):
    """The first decode step's output of every decoder layer, (prompts,
    units) each, and its logits: ``gen``'s prefill, then the tokens
    ``tokens[r][0]``, the decode attention on ``route``."""
    outs = []

    def keep(module, args, out):
        if out.shape[1] == 1:
            outs.append(out[:len(prompts), 0].float().clone())

    hooks = [blk.register_forward_hook(keep) for blk in gen.model._blocks]
    try:
        logits = replay_logits(da, gen, prompts, tokens, 1, route)
    finally:
        for h in hooks:
            h.remove()
    return outs, logits


def rel_gap(a, b):
    """The largest over rows of |a - b| over |b| (2-norms)."""
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


def int8_route_check(torch, da, gen, prompts, out, out_plain, launches):
    """Phase 5's check of B1 on ``int8``, where greedy tokens move with the
    attention route (C4: the plain attention's last-bit differences move
    activations across int8 rounding steps at the next projection, so the
    forced-plain run's tokens are printed, with the first divergence and
    its logit gaps): the first decode step's logits on both routes, from
    the same prefill and token, within INT8_ROUTE_RTOL of their norm (the
    gap after every few layers printed); then the same generate again with every kernel launch
    also run through the plain version on the same inputs (``ShadowB1``,
    within ATOL plus SHADOW_RTOL of the batch row's largest |output|), and
    its tokens bit for bit the timed run's (same route, same shapes)."""
    phase = "serve int8"
    plain, plain_logits = first_step_states(da, gen, prompts, out_plain,
                                            "torch")
    states, logits = first_step_states(da, gen, prompts, out_plain, None)
    gap = rel_gap(logits, plain_logits)
    picks = sorted({i for i in (0, 1, 3, 7, 15) if i < len(plain)}
                   | {len(plain) - 1})
    say(phase, first_step_layer_gaps_to_plain={
        i: f"{rel_gap(states[i], plain[i]):.3e}" for i in picks},
        first_step_logit_gap_to_plain=f"{gap:.3e}",
        limit=INT8_ROUTE_RTOL,
        logit_max_gap=f"{float((logits - plain_logits).abs().max()):.4e}",
        largest_logit=f"{float(plain_logits.abs().max()):.4e}",
        top1_equal_rows=int((logits.argmax(1) == plain_logits.argmax(1)).sum()))
    check(gap <= INT8_ROUTE_RTOL, f"{phase}: the first decode step's logits "
          f"lie {gap:.3e} of their norm apart on the two attention routes "
          f"(limit {INT8_ROUTE_RTOL})")
    if out != out_plain:
        say(phase, rows_equal_to_plain=sum(
            a == b for a, b in zip(out, out_plain)),
            first_divergence_from_plain=first_divergence(
                torch, da, gen, prompts, out, out_plain))
    shadow = ShadowB1(torch, da)
    shadow.start()
    try:
        again, _ = gen.generate(prompts, max_new_tokens=NEW_TOKENS)
    finally:
        shadow.stop()
    check(again == out, f"{phase}: a second generate's tokens differ")
    check(shadow.calls == launches, f"{phase}: {shadow.calls} shadowed "
          f"calls for {launches} launches")
    err = float(shadow.err)
    check(shadow.within(), f"{phase}: the kernel differs from its plain "
          f"version on the generator's inputs by up to {err}")
    say(phase, repeat_tokens_identical=True,
        kernel_calls_held_to_plain=shadow.calls,
        kernel_max_abs_err_vs_plain=err,
        kernel_max_err_over_row_scale=float(shadow.rel))


def serve_phase(torch, da, Generator, model, rung, prompts, n_layers, vocab):
    """Phases 4/5: serve the prompts on one rung; returns its numbers."""
    from mxnet_tpu_torch.ops.hopper import int8_dense as i8

    phase = f"serve {rung}"
    torch.cuda.reset_peak_memory_stats()
    gen = Generator(model, max_seq=MAX_SEQ, batch_buckets=(1, 4),
                    prompt_buckets=(64, 256), decode_path=rung,
                    name=f"llama3_8b_{rung}")
    int8_weights = bool(gen._qweights)
    check(int8_weights == (rung == "int8"), f"{rung}: int8 weights "
          f"{int8_weights} under MXNET_SERVE_DECODE_INT8_WEIGHTS=auto")
    table_bytes = sum(q.numel() + 4 * sc.numel()
                      for q, sc in gen._qweights.values())
    w = gen.warmup()
    say(phase, warmup_s=f"{w['wall_s']:.3f}", signatures=w["signatures"],
        int8_weights=int8_weights, int8_table_bytes=table_bytes)
    toks, lens, bb = gen._pad_prompts(prompts)
    logits, _ = gen.prefill(toks, lens, gen._fresh_cache(bb))
    check(tuple(logits.shape) == (bb, vocab),
          f"prefill logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    prefill_logits = logits.float().cpu()
    # the prefill alone, synchronised, a few times: the generate's
    # prefill_ms below is one host reading
    prefill_sync_ms = []
    for _ in range(PREFILL_REPEATS):
        cache = gen._fresh_cache(bb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.prefill(toks, lens, cache)
        torch.cuda.synchronize()
        prefill_sync_ms.append(f"{(time.perf_counter() - t0) * 1e3:.3f}")
    del cache

    da.force_path(None)
    da.reset_launch_count()
    i8.reset_launch_count()
    fc = ForwardCount(model)
    try:
        out, info = gen.generate(prompts, max_new_tokens=NEW_TOKENS)
    finally:
        fc.close()
    launches = da.launch_count()
    i8_launches = i8.launch_count()
    i8_routes = i8.route_launches()
    i8_rows = i8.row_launches()
    steps = info["decode_steps"]
    check(steps == NEW_TOKENS - 1, f"{steps} decode steps")
    check(all(len(o) == NEW_TOKENS for o in out), "short output")
    check(launches == n_layers * steps,
          f"{launches} kernel launches for {steps} decode steps x "
          f"{n_layers} layers")
    check(fc.calls == 1 + steps, f"{fc.calls} forwards for one prefill "
          f"and {steps} decode steps")
    int8_gate(phase, rung, i8_launches,
              int8_expected(rung, fc.prefills, launches, n_layers))
    # a prefill's layer projections are prefill rows (the wgmma kernel, M =
    # the padded batch x the padded prompt); its head (the last positions)
    # and every decode step, decode rows (the decode kernel, M = the padded
    # batch); no weight of the model is ragged or misaligned
    wgmma = INT8_PREFILL_PRODUCTS * fc.prefills if rung == "int8" else 0
    want = {"wgmma": wgmma, "decode": i8_launches - wgmma, "mma_sync": 0}
    check(i8_routes == want, f"{phase}: int8 products by kernel "
          f"{i8_routes}, expected {want}")
    want = {k: n for k, n in ((("wgmma", toks.shape[0] * toks.shape[1]),
                               wgmma), (("decode", bb), want["decode"])) if n}
    check(i8_rows == want, f"{phase}: int8 products by (kernel, rows) "
          f"{i8_rows}, expected {want}")
    gen.assert_no_recompiles()
    say(phase, prefill_ms=f"{info['prefill_ms']:.3f}",
        prefill_sync_ms=prefill_sync_ms,
        decode_ms_per_token=f"{info['decode_ms'] / steps:.3f}",
        tokens_s=f"{info['tokens_s']:.3f}", decode_steps=steps,
        kernel_launches=launches, int8_launches=i8_launches,
        int8_launches_by_kernel=i8_routes,
        int8_launches_by_kernel_and_rows=sorted(i8_rows.items()),
        int8_launches_per_forward=i8_launches / fc.calls,
        kv_cache_bytes=gen.kv_cache_bytes(),
        peak_mem_bytes=torch.cuda.max_memory_allocated())

    da.force_path("torch")
    i8.reset_launch_count()
    fc = ForwardCount(model)
    # on int8 every plain call is also held to the kernel on its inputs
    shadow = ShadowB1(torch, da, plain_route=True)
    if rung == "int8":
        shadow.start()
    try:
        out_plain, info_plain = gen.generate(prompts,
                                             max_new_tokens=NEW_TOKENS)
    finally:
        shadow.stop()
        da.force_path(None)
        fc.close()
    check(da.launch_count() - shadow.calls == launches,
          "forced-plain run launched the kernel")
    if rung == "int8":
        check(shadow.calls == launches, f"{phase}: {shadow.calls} plain "
              f"calls of the forced-plain run held to the kernel, expected "
              f"{launches}")
        check(shadow.within(), f"{phase}: on the forced-plain run's inputs "
              f"the kernel differs from the plain version by up to "
              f"{float(shadow.err)}")
        say(phase, forced_plain_calls_held_to_kernel=shadow.calls,
            forced_plain_max_abs_err_vs_kernel=float(shadow.err),
            forced_plain_max_err_over_row_scale=float(shadow.rel))
    int8_gate(f"{phase} forced-plain attention", rung, i8.launch_count(),
              INT8_FORWARD * fc.calls if rung == "int8" else 0)
    gen.assert_no_recompiles()
    if rung == "pallas" and out != out_plain:
        raise CheckFailed(f"{rung}: greedy tokens differ from the plain run: "
                          + first_divergence(torch, da, gen, prompts, out,
                                             out_plain))
    say(phase, tokens_identical_to_plain=out == out_plain,
        plain_decode_ms_per_token=f"{info_plain['decode_ms'] / steps:.3f}",
        first_tokens=[o[:4] for o in out])
    if rung == "int8":
        int8_route_check(torch, da, gen, prompts, out, out_plain, launches)
    return {"launches": launches, "int8_launches": i8_launches,
            "int8_routes": i8_routes, "int8_rows": i8_rows,
            "info": info, "out": out, "out_plain": out_plain,
            "prefill_logits": prefill_logits}


def free_cuda(torch):
    gc.collect()
    torch.cuda.empty_cache()


def multistep_phase(torch, da, Generator, model, rung, prompts, n_layers,
                    single):
    """Phase 5a on one rung: the super-step's CUDA graphs against the
    single-step phase's tokens (``single``: phase 4-5's result), on both
    attention routes, with replay-aware launch counts."""
    from mxnet_tpu_torch.ops.hopper import int8_dense as i8

    phase = f"multistep {rung}"
    torch.cuda.reset_peak_memory_stats()
    gen = Generator(model, max_seq=MAX_SEQ, batch_buckets=(1, 4),
                    prompt_buckets=(64, 256), decode_path=rung,
                    multistep=True, decode_steps=DECODE_STEPS,
                    name=f"llama3_8b_{rung}_multi")
    da.force_path(None)
    w = gen.warmup()
    say(phase, warmup_s=f"{w['wall_s']:.3f}", signatures=w["signatures"],
        graphs_captured=w["captures"], capture_s=f"{w['capture_s']:.3f}",
        int8_weights=bool(gen._qweights))
    check(w["captures"] == 2 * 4, f"{w['captures']} graphs captured")
    captures = gen._msession.captures
    visits = -(-(NEW_TOKENS - 1) // DECODE_STEPS)
    expect = n_layers * DECODE_STEPS * visits
    runs = []
    for rep in range(3):
        da.reset_launch_count()
        i8.reset_launch_count()
        fc = ForwardCount(model)
        try:
            out, info = gen.generate(prompts, max_new_tokens=NEW_TOKENS)
        finally:
            fc.close()
        launches = da.launch_count()
        i8_launches = i8.launch_count()
        int8_gate(phase, rung, i8_launches,
                  int8_expected(rung, fc.prefills, launches, n_layers))
        check(out == single["out"], f"{rung}: multi-step tokens differ "
              "from the single-step phase's")
        check(info["decode_visits"] == visits,
              f"{info['decode_visits']} host visits, expected {visits}")
        check(info["decode_steps"] == NEW_TOKENS - 1,
              f"{info['decode_steps']} decode iterations settled")
        check(launches == expect,
              f"{launches} kernel launches for {visits} visits x "
              f"{DECODE_STEPS} iterations x {n_layers} layers (expected "
              f"{expect})")
        runs.append(info)
    check(gen._msession.captures == captures,
          "a graph was captured after warmup")
    gen.assert_no_recompiles()
    ms_tok = [r["decode_ms"] / r["decode_steps"] for r in runs]
    say(phase, decode_ms_per_token=[f"{x:.3f}" for x in ms_tok],
        tokens_s=[f"{r['tokens_s']:.3f}" for r in runs],
        host_visits_per_token=f"{visits / (NEW_TOKENS - 1):.4f}",
        decode_visits=visits, kernel_launches=launches,
        int8_launches=i8_launches,
        launches_per_replay=gen._msession.launches(
            (4, DECODE_STEPS, False, (None, None))),
        prefill_ms=f"{runs[-1]['prefill_ms']:.3f}",
        peak_mem_bytes=torch.cuda.max_memory_allocated())

    da.force_path("torch")
    try:
        da.reset_launch_count()
        out_plain, info_plain = gen.generate(prompts,
                                             max_new_tokens=NEW_TOKENS)
        plain_launches = da.launch_count()
    finally:
        da.force_path(None)
    check(plain_launches == 0,
          f"the forced-plain multi-step run launched the kernel "
          f"{plain_launches} times")
    # on int8 the route moves tokens (C4): there the plain route is held
    # to the single-step phase's plain run (same route, same shapes)
    want = single["out_plain"] if rung == "int8" else out
    check(out_plain == want, f"{rung}: forced-plain multi-step tokens "
          "differ from the " + ("single-step forced-plain run's"
                                if rung == "int8" else "kernel run's"))
    say(phase, tokens_identical_to_plain=out_plain == out,
        plain_equal_to_single_step_plain=out_plain == single["out_plain"],
        rows_equal_to_plain=sum(a == b for a, b in zip(out, out_plain)),
        plain_graphs_captured=gen._msession.captures - captures,
        plain_decode_ms_per_token=(
            f"{info_plain['decode_ms'] / info_plain['decode_steps']:.3f}"))
    del gen
    free_cuda(torch)
    return {"launches": launches, "int8_launches": i8_launches,
            "decode_ms_per_token": ms_tok}


def paged_phase(torch, np, da, Generator, model, prompts, n_layers, vocab,
                served):
    """Phase 5b: paged pools (single- and multi-step) against the ring
    runs, and the prefix cache's second pass against a ring run."""
    rng = np.random.RandomState(1)
    shared = [int(t) for t in rng.randint(1, vocab, size=PREFIX_LEN)]
    px_prompts = [shared + [int(t) for t in rng.randint(1, vocab, size=n)]
                  for n in PREFIX_TAILS]
    from mxnet_tpu_torch.ops.hopper import int8_dense as i8

    kw = dict(max_seq=MAX_SEQ, batch_buckets=(1, 4),
              prompt_buckets=(64, 256))
    for rung in ("pallas", "int8"):
        for multistep in (False, True):
            gen = Generator(model, decode_path=rung, paged=True,
                            multistep=multistep, decode_steps=DECODE_STEPS,
                            name=f"llama3_8b_{rung}_paged", **kw)
            w = gen.warmup()
            da.reset_launch_count()
            i8.reset_launch_count()
            fc = ForwardCount(model)
            try:
                out, info = gen.generate(prompts, max_new_tokens=NEW_TOKENS)
            finally:
                fc.close()
            launches = da.launch_count()
            int8_gate(f"paged {rung}", rung, i8.launch_count(),
                      int8_expected(rung, fc.prefills, launches, n_layers))
            check(out == served[rung]["out"], f"{rung}: paged "
                  f"(multistep={multistep}) tokens differ from the ring "
                  "run's")
            check(launches == n_layers * info["decode_visits"] * (
                DECODE_STEPS if multistep else 1),
                f"{launches} launches in a paged run")
            gen.assert_no_recompiles()
            say("paged", rung=rung, multistep=multistep,
                page_size=gen._fresh_cache(4).page_size,
                pool_bytes=gen.kv_cache_bytes(),
                signatures=w["signatures"], kernel_launches=launches,
                int8_weights=bool(gen._qweights),
                int8_launches=i8.launch_count(),
                decode_ms_per_token=(
                    f"{info['decode_ms'] / info['decode_steps']:.3f}"),
                tokens_identical_to_ring=True)
            del gen
            free_cuda(torch)
        ring = Generator(model, decode_path=rung, **kw)
        want, _ = ring.generate(px_prompts, max_new_tokens=NEW_TOKENS)
        del ring
        gen = Generator(model, decode_path=rung, prefix_cache=True,
                        multistep=True, decode_steps=DECODE_STEPS, **kw)
        gen.warmup()
        da.reset_launch_count()
        i8.reset_launch_count()
        fc = ForwardCount(model)
        try:
            first, _ = gen.generate(px_prompts, max_new_tokens=NEW_TOKENS)
            again, info = gen.generate(px_prompts, max_new_tokens=NEW_TOKENS)
        finally:
            fc.close()
        int8_gate(f"prefix {rung}", rung, i8.launch_count(),
                  int8_expected(rung, fc.prefills, da.launch_count(),
                                n_layers))
        st = gen.stats()["prefix"][4]
        check(st["tokens_matched"] > 0, "the second prefix run matched no "
              "prefix")
        check(first == want and again == want,
              f"{rung}: prefix-cache tokens differ from the ring run's")
        gen.assert_no_recompiles()
        say("prefix", rung=rung, shared_prefix=PREFIX_LEN,
            tokens_matched=st["tokens_matched"], hits=st["hits"],
            second_run_equal_to_ring=again == want,
            pages_held=st["pages_held"], int8_launches=i8.launch_count(),
            prefill_ms_second_run=f"{info['prefill_ms']:.3f}",
            first_run_identical_to_ring=True)
        del gen
        free_cuda(torch)


def batch1_reference(Generator, model, rung, prompts, budgets):
    """Each prompt alone through a batch-1 single-step Generator."""
    gen = Generator(model, max_seq=MAX_SEQ, batch_buckets=(1,),
                    prompt_buckets=B1_BUCKETS, decode_path=rung,
                    name=f"llama3_8b_{rung}_b1")
    out = [gen.generate([p], max_new_tokens=m)[0][0]
           for p, m in zip(prompts, budgets)]
    del gen
    return out


def prefill_shape_check(torch, Generator, model, rung, prompts):
    """Prompt 2's K at the first and the last layer, prefilled with phases
    4-5's prompts at (4, 256) and alone at (1, 256). On ``pallas`` the f32
    K must agree within ``KSHAPE_RTOL`` of the largest |K|; on ``int8``
    the entries that differ are counted and printed (rounding moves
    values across quantization steps, so a batch-1 run is no token
    reference there)."""
    gen = Generator(model, max_seq=MAX_SEQ, batch_buckets=(1, 4),
                    prompt_buckets=(64, 256), decode_path=rung,
                    name=f"llama3_8b_{rung}_shape")
    toks, lens, _ = gen._pad_prompts(prompts)
    _, c4 = gen.prefill(toks, lens, gen._fresh_cache(4))
    per_layer = 4 if rung == "int8" else 2
    picks = (0, len(c4.flat()) - per_layer)   # K of the first, last layer
    k4 = [c4.flat()[i][2].clone() for i in picks]
    t1, l1, _ = gen._pad_prompts([prompts[2]])
    _, c1 = gen.prefill(t1, l1, gen._fresh_cache(1))
    n = len(prompts[2])
    diffs = []
    for layer, a, i in zip(("first", "last"), k4, picks):
        a, b = a[:, :n], c1.flat()[i][0, :, :n]
        if rung == "int8":
            diffs.append(f"{int((a != b).sum())}/{a.numel()}")
            continue
        err = float((a - b).abs().max())
        scale = float(a.abs().max())
        check(err <= KSHAPE_RTOL * scale,
              f"prefill K at (4, 256) and (1, 256) differ by {err:.3e} at "
              f"the {layer} layer (largest |K| {scale:.3e})")
        diffs.append(f"{err:.3e}/{scale:.3e}")
    say("continuous", rung=rung,
        prefill_k_4x256_vs_1x256_layer_first_last=diffs)
    del gen, c4, c1, k4
    free_cuda(torch)


def first_diff(a, b):
    """Index of the first token where two token lists differ."""
    return next((j for j in range(max(len(a), len(b)))
                 if a[j:j + 1] != b[j:j + 1]), None)


def bucket(n):
    """The batch-1 Generator's prompt bucket for a prompt of ``n``."""
    return next(b for b in B1_BUCKETS if b >= n)


def clear_trie(eng):
    """Empty the running engine's prefix trie between requests."""
    check(eng.drain(timeout=CB_WAIT), "drain timed out")
    eng.prefix.clear()
    eng.resume()


def engine_run(torch, da, eng, prompts, budgets):
    """Submit every prompt at once to the running engine and wait; returns
    (token lists, results, seconds, the kernel's launches, the engine's
    decode iterations and visits over the run)."""
    st0 = eng.stats()
    n0 = da.launch_count()
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
    res = [f.result(timeout=CB_WAIT) for f in futs]
    wall = time.perf_counter() - t0
    st = eng.stats()
    return ([r["tokens"] for r in res], res, wall, da.launch_count() - n0,
            st["decode_iterations"] - st0["decode_iterations"],
            st["decode_visits"] - st0["decode_visits"])


class ShadowB1:
    """From ``start()`` to ``stop()`` every decode-attention kernel launch
    also runs the plain version on the same inputs (the engine's gathered
    pages, dead lanes, int8 rings and scales), on the device with no host
    read; ``within()`` says whether every output agreed to ATOL plus
    SHADOW_RTOL of its batch row's largest |output|, at live rows. With
    ``plain_route``, a decode call (T = 1) that took the plain version
    (the plain attention forced) also launches the kernel on the same
    inputs, held alike; those launches count in the module's
    ``launch_count()``. On
    ``int8`` a token comparison cannot hold the kernel to its plain
    version: every step requantizes the K/V it writes, so the two routes'
    1e-6 differences move later inputs by whole quantization steps."""

    def __init__(self, torch, da, plain_route=False):
        self.torch, self.da, self.kernel = torch, da, None
        self.plain_route = plain_route
        self.calls, self.err, self.excess, self.rel = 0, None, None, None

    def start(self):
        torch, da = self.torch, self.da
        kernel = self.kernel = da.decode_attention

        def shadowed(q, k, v, start_pos, scale=None, k_scale=None,
                     v_scale=None):
            kw = dict(scale=scale, k_scale=k_scale, v_scale=v_scale)
            out = kernel(q, k, v, start_pos, **kw)
            got = None
            if da.last_path() == "cuda":
                got = out
                ref = da.decode_attention_torch(q, k, v, start_pos, **kw)
            elif self.plain_route and q.shape[2] == 1:
                forced = da.forced_path()
                da.force_path("cuda")
                try:
                    got = kernel(q, k, v, start_pos, **kw)
                finally:
                    da.force_path(forced)
                ref = out
            if got is not None:
                live = (start_pos >= 0).view(-1, 1, 1, 1)
                err = torch.where(live, (got - ref).abs(), 0.0)
                scale = ref.abs().amax(dim=(1, 2, 3), keepdim=True)
                excess = (err - ATOL - SHADOW_RTOL * scale).amax()
                rel = (err / scale.clamp_min(ATOL)).amax()
                err = err.amax()
                if self.calls:
                    err = torch.maximum(self.err, err)
                    excess = torch.maximum(self.excess, excess)
                    rel = torch.maximum(self.rel, rel)
                self.err, self.excess, self.rel = err, excess, rel
                self.calls += 1
            return out

        da.decode_attention = shadowed

    def stop(self):
        if self.kernel is not None:
            self.da.decode_attention, self.kernel = self.kernel, None

    def within(self):
        return self.calls > 0 and bool(self.excess <= 0)


def plain_agreement(torch, da, eng, prompts, budgets, got):
    """The running engine serves ``prompts`` again, at its own shapes,
    with the plain attention forced (the kernel must not launch); returns
    how many requests give the tokens ``got`` and where the others first
    differ. The engine is drained and its trie emptied first, so every
    request is a prefix miss again."""
    clear_trie(eng)
    da.force_path("torch")
    try:
        plain, _, _, launches, _, _ = engine_run(torch, da, eng, prompts,
                                                 budgets)
    finally:
        da.force_path(None)
    check(launches == 0, f"{launches} kernel launches with the plain "
          "attention forced")
    bad = [f"#{i} from token {first_diff(a, b)}"
           for i, (a, b) in enumerate(zip(got, plain)) if a != b]
    return len(prompts) - len(bad), bad


def continuous_phase(torch, np, da, Generator, ContinuousEngine, percentile,
                     model, prompts, n_layers, vocab, served):
    """Phase 5c: the continuous-batching engine on both rungs, single- and
    multi-step. On ``pallas`` every request is held to phases 4-5 or to a
    batch-1 Generator run. On ``int8`` the rung's greedy tokens depend on
    the shapes a request runs at (``prefill_shape_check`` counts it) and
    on the attention route, so there single-step holds every kernel
    launch of part 1 and the churn to the plain version on the same
    inputs (``ShadowB1``) and multi-step holds the tokens to single-step
    (the same shapes, the graph replays the same kernels); the agreement
    with phases 4-5, the batch-1 runs (with the prompt bucket of each
    churn request that differs) and the same engine with the plain
    attention forced is printed. On ``int8`` every forward (prefill chunks
    and decode iterations) launches the int8 product 225 times; on
    ``pallas`` none."""
    from mxnet_tpu_torch.ops.hopper import int8_dense as i8

    rng = np.random.RandomState(5)
    # the first two churn prompts over one chunk, the rest anywhere
    lens = np.concatenate([
        rng.randint(CB_CHUNK + 1, CB_LENS[1] + 1, size=CB_OVER),
        rng.randint(CB_LENS[0], CB_LENS[1] + 1, size=CB_CHURN - CB_OVER)])
    churn = [[int(t) for t in rng.randint(1, vocab, size=int(n))]
             for n in lens]
    churn_new = [int(m) for m in rng.randint(CB_NEW[0], CB_NEW[1] + 1,
                                             size=CB_CHURN)]
    shared = [int(t) for t in rng.randint(1, vocab, size=PREFIX_LEN)]
    px = [shared + [int(t) for t in rng.randint(1, vocab, size=n)]
          for n in PREFIX_TAILS]
    out, single = {}, None
    for rung in ("pallas", "int8"):
        exact = rung == "pallas"
        prefill_shape_check(torch, Generator, model, rung, prompts)
        t0 = time.perf_counter()
        ref = batch1_reference(Generator, model, rung, churn,
                               churn_new)
        free_cuda(torch)
        say("continuous", rung=rung, batch1_reference_s=(
            f"{time.perf_counter() - t0:.3f}"))
        for multistep in (False, True):
            phase = f"continuous {rung} {'multi' if multistep else 'single'}"
            torch.cuda.reset_peak_memory_stats()
            eng = ContinuousEngine(
                model, max_seq=MAX_SEQ, num_slots=CB_SLOTS,
                page_size=da.natural_block(), prefill_chunk=CB_CHUNK,
                decode_path=rung, prefix_cache=True, multistep=multistep,
                decode_steps=DECODE_STEPS, max_queue=64,
                name=f"llama3_8b_{rung}_cb")
            shadow = ShadowB1(torch, da)
            fc = None
            try:
                da.force_path(None)
                w = eng.warmup()
                captures = w.get("captures", 0)
                check(captures == (4 if multistep else 0),
                      f"{captures} graphs captured by warmup")
                say(phase, warmup_s=f"{w['wall_s']:.3f}",
                    signatures=w["signatures"], graphs_captured=captures,
                    int8_weights=bool(eng._qweights))
                check(bool(eng._qweights) == (rung == "int8"),
                      f"{phase}: int8 weights {bool(eng._qweights)}")
                b1_0, i8_0 = da.launch_count(), i8.launch_count()
                fc = ForwardCount(model)
                eng.start()
                # the int8 single-step arm shadows every kernel launch
                shadowing = not exact and not multistep
                if shadowing:
                    shadow.start()
                # part 1: the prompts of phases 4-5, at once
                toks, res, wall, launches, iters, visits = engine_run(
                    torch, da, eng, prompts, [NEW_TOKENS] * len(prompts))
                all_launches = launches
                check(launches == n_layers * iters > 0,
                      f"{launches} kernel launches for {iters} decode "
                      f"iterations x {n_layers} layers")
                snap = eng.metrics.snapshot()
                itl = [ms for ms, _ in eng.metrics.itl_samples()]
                steps = max(r["decode_steps"] for r in res)
                say(phase, ttft_p50_ms=f"{snap['ttft_p50_ms']:.3f}",
                    ttft_p95_ms=f"{snap['ttft_p95_ms']:.3f}",
                    itl_p50_ms=f"{percentile(itl, 50):.3f}",
                    itl_p95_ms=f"{percentile(itl, 95):.3f}",
                    decode_ms_per_token=f"{sum(itl) / len(itl):.3f}",
                    tokens_s=f"{sum(map(len, toks)) / wall:.3f}",
                    wall_s=f"{wall:.3f}", decode_visits=visits,
                    decode_iterations=iters,
                    host_visits_per_token=f"{visits / steps:.4f}",
                    kernel_launches=launches)
                if exact and toks != served[rung]["out"]:
                    gen = Generator(model, max_seq=MAX_SEQ,
                                    batch_buckets=(1, 4),
                                    prompt_buckets=(64, 256),
                                    decode_path=rung)
                    raise CheckFailed(
                        f"{phase}: tokens differ from phases 4-5: "
                        + first_divergence(torch, da, gen, prompts, toks,
                                           served[rung]["out"]))
                # part 2: the seeded churn, at once
                ctoks, res, cwall, launches, iters, visits = engine_run(
                    torch, da, eng, churn, churn_new)
                all_launches += launches
                if shadowing:
                    shadow.stop()
                    check(shadow.calls == all_launches,
                          f"{phase}: {shadow.calls} shadowed calls for "
                          f"{all_launches} launches")
                    err = float(shadow.err) if shadow.calls else None
                    check(shadow.within(), f"{phase}: the kernel differs "
                          f"from its plain version on the engine's inputs "
                          f"by up to {err}")
                    say(phase, kernel_calls_held_to_plain=shadow.calls,
                        kernel_max_abs_err_vs_plain=err,
                        kernel_max_err_over_row_scale=float(shadow.rel))
                    single = toks + ctoks
                elif not exact:
                    bad = [f"#{i} from token {first_diff(a, b)}"
                           for i, (a, b) in enumerate(zip(toks + ctoks,
                                                          single)) if a != b]
                    check(not bad, f"{phase}: tokens differ from the "
                          f"single-step engine's: {bad}")
                    say(phase, tokens_identical_to_single_step_engine=len(
                        single))
                check(launches == n_layers * iters,
                      f"churn: {launches} launches for {iters} iterations")
                say(phase, churn_requests=CB_CHURN,
                    churn_tokens=sum(map(len, ctoks)),
                    churn_tokens_s=f"{sum(map(len, ctoks)) / cwall:.3f}",
                    churn_decode_visits=visits, churn_decode_iterations=iters,
                    churn_kernel_launches=launches)
                b1_bad = [f"#{i} (prompt {len(churn[i])}, bucket "
                          f"{bucket(len(churn[i]))}) from token "
                          f"{first_diff(ctoks[i], ref[i])}"
                          for i in range(CB_CHURN) if ctoks[i] != ref[i]]
                if exact:
                    check(not b1_bad, f"{phase}: churn requests differ from "
                          f"batch-1 Generator runs: {b1_bad}")
                say(phase, rows_equal_to_phase_4_5=sum(
                    a == b for a, b in zip(toks, served[rung]["out"])),
                    churn_equal_to_batch1_generator=CB_CHURN - len(b1_bad),
                    churn_differing_from_batch1=b1_bad,
                    engine_prefill_chunk=CB_CHUNK)
                # part 3: a shared 64-token prefix, one request after the
                # other; the hit must keep the tokens of a miss
                matched0 = eng.metrics.snapshot()["prefix_tokens_skipped"]
                hits = [engine_run(torch, da, eng, [p], [NEW_TOKENS])[0][0]
                        for p in px]
                matched = (eng.metrics.snapshot()["prefix_tokens_skipped"]
                           - matched0)
                check(matched > 0, "the shared-prefix prompt matched no "
                      "prefix")
                clear_trie(eng)
                miss = engine_run(torch, da, eng, px[1:], [NEW_TOKENS])[0]
                check(hits[1:] == miss,
                      f"{phase}: the prefix hit's tokens "
                      "differ from a miss's")
                eng.assert_no_recompiles()
                if multistep:
                    check(eng._msession.captures == captures,
                          "a graph was captured after warmup")
                i8_launches = i8.launch_count() - i8_0
                int8_gate(phase, rung, i8_launches, int8_expected(
                    rung, fc.prefills, da.launch_count() - b1_0, n_layers))
                say(phase, forwards_prefill=fc.prefills,
                    int8_launches=i8_launches)
                fc.close()
                snap = eng.metrics.snapshot()
                peak = torch.cuda.max_memory_allocated()
                if shadowing:
                    same, bad = plain_agreement(
                        torch, da, eng, prompts + churn,
                        [NEW_TOKENS] * len(prompts) + churn_new, toks + ctoks)
                    say(phase, tokens_equal_to_forced_plain_engine=same,
                        differing_from_forced_plain=bad)
            finally:
                shadow.stop()
                if fc is not None:
                    fc.close()
                eng.close()
            eng.prefix.clear()
            pool = eng.stats()["pool"]
            check(pool["pages_owned"] == 0 and pool["pages_used"] == 0,
                  f"pages not recycled: {pool}")
            say(phase, prefix_tokens_matched=matched,
                prefix_hit_equals_miss=hits[1:] == miss,
                prefix_hits=snap["prefix_hits"],
                prefix_evictions=snap["prefix_evictions"],
                requests=snap["requests"], errors=snap["errors"],
                pool_high_water=pool["high_water"],
                pool_bytes=pool["nbytes"], peak_mem_bytes=peak,
                pages_recycled=True)
            out[(rung, multistep)] = snap
            del eng
            free_cuda(torch)
    return out



def tenancy_phase(torch, da, ModelRegistry, model, draft_rand, prompts,
                  n_layers, served):
    """Phase 5d: ``ModelRegistry(max_models=1)`` over two tenants behind
    phase 5c's multi-step engine settings: serve phase 4's prompts, load
    the 2-layer draft (evicting the Llama), serve the Llama again (a
    reload through its factory). Returns the Llama tenant's kernel
    launches of its first serve."""
    t0 = time.perf_counter()
    kw = dict(max_seq=MAX_SEQ, num_slots=CB_SLOTS,
              page_size=da.natural_block(), prefill_chunk=CB_CHUNK,
              decode_path="pallas", prefix_cache=True, multistep=True,
              decode_steps=DECODE_STEPS, max_queue=64)
    from mxnet_tpu_torch.ops.hopper import int8_dense as i8

    want = served["pallas"]["out"]
    engines = []
    i8.reset_launch_count()

    def serve(reg, name, batch):
        eng = reg.load(name)
        captures = eng._msession.captures
        st0 = eng.stats()
        da.reset_launch_count()
        futs = [reg.submit(name, p, max_new_tokens=NEW_TOKENS)
                for p in batch]
        toks = [f.result(timeout=CB_WAIT)["tokens"] for f in futs]
        launches = da.launch_count()
        iters = eng.stats()["decode_iterations"] - st0["decode_iterations"]
        layers = len(eng.model._blocks)
        check(launches == layers * iters > 0,
              f"tenancy {name}: {launches} kernel launches for {iters} "
              f"decode iterations x {layers} layers")
        eng.assert_no_recompiles()
        check(eng._msession.captures == captures,
              f"tenancy {name}: a graph was captured after warmup")
        if eng not in engines:
            engines.append(eng)
        return toks, launches

    with ModelRegistry(max_models=1, name="chip", **kw) as reg:
        reg.load("llama3_8b", factory=lambda: model)
        first, launches = serve(reg, "llama3_8b", prompts)
        check(first == want, "tenancy: the Llama tenant's tokens differ "
              "from phases 4-5's")
        reg.load("draft_rand", factory=lambda: draft_rand)
        check(reg.resident() == ["draft_rand"],
              f"tenancy: resident {reg.resident()} after the second load")
        serve(reg, "draft_rand", prompts[:1])
        again, _ = serve(reg, "llama3_8b", prompts)      # the reload
        check(again == want, "tenancy: the reloaded Llama tenant's tokens "
              "differ from phases 4-5's")
        summ = reg.summary()
        check(summ["loads"] == 3 and summ["evictions"] == 2,
              f"tenancy: {summ['loads']} loads, {summ['evictions']} "
              "evictions (expected 3 and 2: one eviction of each tenant, "
              "one reload)")
        secs = reg.load_seconds()
        clear_trie(reg.get("llama3_8b"))
    int8_gate("tenancy", "pallas", i8.launch_count(), 0)
    for eng in engines:
        eng.prefix.clear()
        pool = eng.stats()["pool"]
        check(pool["pages_owned"] == 0 and pool["pages_used"] == 0,
              f"tenancy: pages not recycled: {pool}")
    say("tenancy", tokens_equal_to_phase_4_5="both loads",
        loads=summ["loads"], evictions=summ["evictions"],
        llama_load_s=f"{secs['llama3_8b'][0]:.3f}",
        llama_reload_s=f"{secs['llama3_8b'][1]:.3f}",
        draft_load_s=f"{secs['draft_rand'][0]:.3f}",
        kernel_launches=launches, pages_recycled=True,
        seconds=f"{time.perf_counter() - t0:.3f}")
    del engines
    free_cuda(torch)
    return launches


def fleet_phase(torch, da, Generator, Replica, Router, fleet_stats, faults,
                model, prompts, n_layers, served, dev):
    """Phase 5e: a Router over two replicas, each a single-step ``pallas``
    Generator over phase 4's model; phase 4's prompts twice, with a
    ``die`` at replica 0's third dispatch. Returns the kernel launches."""
    t0 = time.perf_counter()
    want = served["pallas"]["out"]
    gens = [Generator(model, max_seq=MAX_SEQ, batch_buckets=(1, 4),
                      prompt_buckets=(64, 256), decode_path="pallas",
                      name=f"llama3_8b_fleet{i}") for i in range(2)]
    for g in gens:
        g.warmup()
    steps = [0, 0]

    def runner_for(i):
        def run(batch):
            check(torch.cuda.current_device() == dev.index
                  and torch.is_inference_mode_enabled(),
                  f"replica {i}'s flusher thread runs without the device "
                  "or inference mode")
            out, info = gens[i].generate(batch, max_new_tokens=NEW_TOKENS)
            steps[i] += info["decode_steps"]
            return out
        return run

    reps = [Replica(runner_for(i), index=i, max_batch_size=4,
                    timeout_ms=5.0, device=dev) for i in range(2)]
    requests = prompts * 2
    faults.install_plan({"rules": [{"site": "replica:dispatch",
                                    "kind": "die", "replica": 0,
                                    "at": [2]}]})
    from mxnet_tpu_torch.ops.hopper import int8_dense as i8

    try:
        da.reset_launch_count()
        i8.reset_launch_count()
        with Router(reps, name="chip_fleet", probe_ms=25.0) as router:
            futs = [router.submit(p, key=f"req{j}")
                    for j, p in enumerate(requests)]
            outs = [f.result(timeout=CB_WAIT) for f in futs]
            stats = fleet_stats()["chip_fleet"]
        # drained: the killed replica's flusher may still be finishing the
        # batch it held when the router fenced it
        for r in reps:
            if r.batcher._thread is not None:
                r.batcher._thread.join(CB_WAIT)
        launches = da.launch_count()
        int8_gate("fleet", "pallas", i8.launch_count(), 0)
    finally:
        faults.clear_plan()
    bad = [j for j, o in enumerate(outs) if o != want[j % len(prompts)]]
    check(not bad, f"fleet: requests {bad} differ from phase 4's tokens")
    check(all(f.done() for f in futs), "fleet: a request is unsettled")
    check(stats["failovers"] >= 1 and stats["kills"] == 1,
          f"fleet: {stats['failovers']} failovers, {stats['kills']} kills")
    check(launches == n_layers * sum(steps) > 0,
          f"fleet: {launches} kernel launches for {sum(steps)} decode "
          f"steps x {n_layers} layers")
    say("fleet", requests=len(requests), settled_once=len(outs),
        tokens_equal_to_phase_4=True, failovers=stats["failovers"],
        requeued=stats["requeued"], kills=stats["kills"],
        fenced_results=stats["fenced_results"],
        dispatched=stats["dispatched"], decode_steps=steps,
        kernel_launches=launches,
        seconds=f"{time.perf_counter() - t0:.3f}")
    del gens, reps
    free_cuda(torch)
    return launches


def spec_divergence(gen, prompts, a, b):
    """Row and step of the first differing token of the speculative run
    ``a`` and the Generator run ``b``, with the Generator's logit gap
    between the two candidates there (it replays its own tokens)."""
    row, step = next((i, j) for j in range(NEW_TOKENS)
                     for i in range(len(a)) if a[i][j:j + 1] != b[i][j:j + 1])
    toks, lens, bb = gen._pad_prompts(prompts)
    lg, cache = gen.prefill(toks, lens, gen._fresh_cache(bb))
    pos = lens.copy()
    for j in range(step):
        ids = [b[r][j] if r < len(b) else 0 for r in range(bb)]
        lg, cache = gen.decode_step(ids, pos, cache)
        pos = pos + 1
    gap = float(lg[row, b[row][step]] - lg[row, a[row][step]])
    return f"row={row} step={step} gap={gap:.6e}"


def speculative_phase(torch, da, Generator, SpeculativeGenerator, get_llama,
                      model, draft_rand, prompts, dev):
    """Phase 5f: ``SpeculativeGenerator`` over the full-depth target with
    layers 2-31's ``o_proj``/``down_proj`` zeroed (their cost stays, their
    output is 0), a draft copied from its first two layers (acceptance
    near 1) and the random 2-layer draft (near 0), on both rungs, single-
    and multi-step. Changes ``model``'s weights in place. Returns the
    draft's kernel launches of the ``pallas`` multi-step copied-draft
    run."""
    from mxnet_tpu_torch.ops.hopper import int8_dense as i8

    t0 = time.perf_counter()
    with torch.no_grad():
        for blk in model._blocks[2:]:
            blk.attention.o_proj.weight.zero_()
            blk.ffn.down_proj.weight.zero_()
    draft_copy = get_llama(CONFIG, device=dev, num_layers=2)
    own = draft_copy.state_dict()
    draft_copy.load_state_dict({k: v for k, v in model.state_dict().items()
                                if k in own})
    drafts = {"copy": draft_copy, "rand": draft_rand}
    n_draft = len(draft_copy._blocks)
    kw = dict(max_seq=MAX_SEQ, batch_buckets=(1, 4), prompt_buckets=(64, 256))
    decode_tokens = NEW_TOKENS - 1
    result = None
    for rung in ("pallas", "int8"):
        gen = Generator(model, decode_path=rung, **kw)
        gen.warmup()
        ref, rinfo = gen.generate(prompts, max_new_tokens=NEW_TOKENS)
        say("speculative", rung=rung, target_generator_decode_ms_per_token=(
            f"{rinfo['decode_ms'] / decode_tokens:.3f}"))
        for dname, draft in drafts.items():
            single = None
            for multistep in (False, True):
                phase = (f"speculative {rung} {dname} "
                         f"{'multi' if multistep else 'single'}")
                torch.cuda.reset_peak_memory_stats()
                sg = SpeculativeGenerator(
                    model, draft, k=SPEC_K, decode_path=rung,
                    multistep=multistep, name=f"spec_{rung}_{dname}", **kw)
                w = sg.warmup()
                caps = (sg._verify.captures, sg.draft._msession.captures
                        if multistep else 0)
                vr0 = sg._verify.replays
                dr0 = sg.draft._msession.replays if multistep else 0
                events = {"draft": [], "verify": []}
                da.reset_launch_count()
                i8.reset_launch_count()
                tfc, dfc = ForwardCount(model), ForwardCount(draft)
                try:
                    out, info = sg.generate(prompts,
                                            max_new_tokens=NEW_TOKENS,
                                            events=events)
                finally:
                    tfc.close()
                    dfc.close()
                launches = da.launch_count()
                torch.cuda.synchronize()
                rounds = info["rounds"]
                check(launches == n_draft * (SPEC_K + 1) * rounds,
                      f"{phase}: {launches} kernel launches for {rounds} "
                      f"rounds x {SPEC_K + 1} draft iterations x {n_draft} "
                      "layers")
                # the target's forwards: its prefill and one verify replay
                # a round (T = k + 1: no B1); the draft's: its prefill and
                # its k + 1 iterations a round (2 layers: 15 products)
                verify = sg._verify.launches((4, SPEC_K + 1, (None, None)))
                check(verify[0] == 0,
                      f"{phase}: the verify graph launches the kernel")
                draft_products = 7 * n_draft + 1
                want_i8 = (int8_expected(rung, tfc.prefills + rounds, 0, 1)
                           + int8_expected(rung, dfc.prefills, launches,
                                           n_draft, draft_products))
                int8_gate(phase, rung, i8.launch_count(), want_i8)
                check(verify[1:] == ([INT8_FORWARD] if rung == "int8"
                                     else []),
                      f"{phase}: the verify graph's launches {verify}")
                check(sg._verify.replays - vr0 == rounds,
                      f"{phase}: {sg._verify.replays - vr0} verify replays "
                      f"for {rounds} rounds")
                if multistep:
                    check(sg.draft._msession.replays - dr0 == rounds
                          and info["decode_visits"] == 2 * rounds,
                          f"{phase}: {info['decode_visits']} host visits "
                          f"for {rounds} rounds (expected 2 a round)")
                    check(sg.draft._msession.captures == caps[1],
                          f"{phase}: a draft graph was captured after "
                          "warmup")
                check(sg._verify.captures == caps[0],
                      f"{phase}: a verify graph was captured after warmup")
                sg.assert_no_recompiles()
                if rung == "pallas":
                    if out != ref:
                        raise CheckFailed(
                            f"{phase}: tokens differ from the target's "
                            "Generator: " + spec_divergence(gen, prompts,
                                                            out, ref))
                    agree = "identical"
                else:
                    if multistep:
                        bad = [i for i in range(len(out))
                               if out[i] != single[i]]
                        check(not bad, f"{phase}: rows {bad} differ from "
                              "single-step's")
                    else:
                        single = out
                    agree = ("identical" if out == ref else
                             spec_divergence(gen, prompts, out, ref))
                dev_ms = {k: [e0.elapsed_time(e1) for e0, e1 in v]
                          for k, v in events.items()}
                say(phase, warmup_s=f"{w['wall_s']:.3f}",
                    verify_graphs=w["verify_captures"],
                    decode_ms_per_token=(
                        f"{info['decode_ms'] / decode_tokens:.3f}"),
                    tokens_per_round=f"{decode_tokens / rounds:.3f}",
                    acceptance_rate=f"{info['acceptance_rate']:.4f}",
                    rounds=rounds,
                    host_visits_per_token=(
                        f"{info['decode_visits'] / decode_tokens:.4f}"),
                    draft_replay_device_ms=(
                        f"{statistics.mean(dev_ms['draft']):.3f}"
                        if dev_ms["draft"] else "single-step"),
                    verify_replay_device_ms=(
                        f"{statistics.mean(dev_ms['verify']):.3f}"
                        if dev_ms["verify"] else None),
                    kernel_launches=launches,
                    int8_launches=i8.launch_count(),
                    verify_graph_launches=verify,
                    tokens_vs_target_generator=agree,
                    peak_mem_bytes=torch.cuda.max_memory_allocated())
                if rung == "pallas" and dname == "copy" and multistep:
                    result = launches
                del sg
                free_cuda(torch)
        del gen
        free_cuda(torch)
    say("speculative", seconds=f"{time.perf_counter() - t0:.3f}")
    return result


def int8_inputs(torch, dev, m, o, u, seed):
    """Seeded normal activations (M, U), with a row of zeros and a row of
    exact .5 ties (amax 127, so sx = 1) where M >= 3, and a weight drawn
    as the model's (uniform in +-0.07), quantized per output channel as
    ``serve.generate._quantize_serving_weights`` does. Returns (x, f32
    weight, int8 weight, scale)."""
    from mxnet_tpu_torch.ops.hopper import int8_dense as i8

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, u, device=dev, generator=gen)
    if m >= 3:
        x[1] = 0.0
        x[2] = 0.0
        n = min(u, 6)
        x[2, :n] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5][:n],
                                device=dev)
    wf = torch.rand(o, u, device=dev, generator=gen) * 0.14 - 0.07
    scale = i8.int8_scale(wf.abs().amax(dim=1))
    qw = torch.clamp(torch.round(wf / scale[:, None]), -127, 127).to(
        torch.int8)
    return x, wf, qw, scale


def int8_bound_ms(m, o, u):
    """Least time (ms) of one call: x read, the int8 weight and its scales
    read and the f32 output written once at the memory rate, against
    2 M O U int8 operations at the tensor cores' rate."""
    t_bytes = (o * u + 4 * m * u + 4 * o + 4 * m * o) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * o * u / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_errors(torch, out, exact):
    """Each live row's largest |error| over its largest |output|, and its
    RMS error over its RMS output (float64)."""
    err = out.double() - exact
    live = exact.abs().amax(1) > 0
    err, exact = err[live], exact[live]
    if not len(exact):
        return 0.0, 0.0
    peak = float((err.abs().amax(1) / exact.abs().amax(1)).max())
    rms = float((err.norm(dim=1) / exact.norm(dim=1)).max())
    return peak, rms


def int8_case(torch, i8, x, wf, qw, scale, what):
    """The kernel against its plain version (bit for bit), two calls bit
    for bit, and each row's RMS error against the exact product with the
    unquantized weight (float64) within INT8_ROW_RMS_LIMIT of its RMS
    output. The same reading is taken of the algorithm with truncation in
    place of rounding (one rounding step lost), which the limit must be
    able to tell apart. Returns the largest difference to the plain
    version and the readings: largest |error| over the row's largest
    |output| (the JAX docstring's ~1e-2), the RMS reading, the truncated
    algorithm's RMS reading. Each call must take the product kernel
    ``route_for`` names."""
    route = i8.route_for(x.shape[0], x.shape[1], qw.data_ptr())
    r0 = i8.route_launches()
    out = i8.int8_dense(x, qw, scale)
    again = i8.int8_dense(x, qw, scale)
    check(i8.last_path() == "cuda", f"int8 {what}: the kernel did not run")
    r1 = i8.route_launches()
    check({k: r1[k] - r0[k] for k in r1} == {
        k: 2 if k == route else 0 for k in r1}, f"int8 {what}: the calls "
        f"did not both take the {route} kernel ({r0} -> {r1})")
    ref = i8.int8_dense_torch(x, qw, scale)
    torch.cuda.synchronize()
    diff = float((out - ref).abs().max())
    check(torch.equal(out, ref), f"int8 {what}: the kernel differs from "
          f"its plain version by up to {diff:.3e}")
    check(torch.equal(out, again), f"int8 {what}: two calls differ")
    exact = x.double() @ wf.double().t()
    peak, rms = row_errors(torch, out, exact)
    check(rms <= INT8_ROW_RMS_LIMIT, f"int8 {what}: a row's RMS error is "
          f"{rms:.3e} of its RMS output (limit {INT8_ROW_RMS_LIMIT})")
    _, sx = i8.quantize_rows_torch(x)
    xt = torch.clamp(torch.trunc(x / sx), -127, 127)
    trunc = (xt.double() @ qw.double().t()).float() * sx * scale
    _, rms_trunc = row_errors(torch, trunc, exact)
    del exact, xt, trunc
    return diff, {"peak": peak, "rms": rms, "rms_trunc": rms_trunc,
                  "route": route}


def int8_phase(torch, F, i8, flush, dev):
    """Phase 3b: the int8 x int8 product at every Llama-3-8B projection
    shape and the edge cases, against its plain version; times at M = 4,
    256 and 1024 against the bound, the plain version, the weight-only
    route, the f32 product and ``torch._int_mm``; then the sums over one
    forward's products. Returns the JSON rows' numbers by M."""
    from mxnet_tpu_torch.int8_variants import ReadFlush

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for block_rows in sorted(i8.TILES):
        say("int8", kernel="mma_sync", block_rows=block_rows,
            block_cols=i8.TILES[block_rows],
            smem_bytes=i8.smem_bytes(block_rows))
    for block_cols in i8.WGMMA_COLS:
        say("int8", kernel="wgmma", block_rows=i8.WGMMA_ROWS,
            block_cols=block_cols, stage_bytes_of_u=i8.WGMMA_CHUNK,
            smem_bytes=i8.wgmma_smem_bytes(block_cols))
    stage_bytes = i8.DECODE_STAGE_ROWS * i8.DECODE_STAGE
    say("int8", kernel="decode", block_cols=i8.DECODE_COLS,
        max_rows=i8.DECODE_ROWS, stages=i8.DECODE_STAGES,
        stage_channels=i8.DECODE_STAGE_ROWS,
        stage_bytes_of_u=i8.DECODE_STAGE, stage_weight_bytes=stage_bytes,
        weight_bytes_in_flight_a_block=i8.DECODE_STAGES * stage_bytes,
        xq_slice_bytes_at_most=i8.DECODE_XQ_BYTES,
        quantize_threads=i8.QUANT_THREADS,
        quantize_blocks_a_row_at_most=i8.QUANT_CLUSTER_MAX)
    for name, a in i8.kernel_attributes().items():
        say("int8", kernel=name, **a)
        check(a["local_bytes"] == 0, f"int8 kernel {name} uses "
              f"{a['local_bytes']} local bytes a thread (a spill)")
    max_diff, seed = 0.0, 100
    worst = {"peak": 0.0, "rms": 0.0}

    def plan_of(m, o, u, route):
        return i8.PLANS[route](m, o, u, sms)
    # the truncated algorithm's least reading at the projection shapes
    trunc_least = {"one_row": 1.0, "several_rows": 1.0}

    def keep(m, u, diff, errs):
        for k in worst:
            worst[k] = max(worst[k], errs[k])
        if u >= 4096:
            rows = "one_row" if m == 1 else "several_rows"
            trunc_least[rows] = min(trunc_least[rows], errs["rms_trunc"])
        return max(max_diff, diff)

    def readings(errs):
        return dict(route=errs["route"],
                    err_over_row_max=f"{errs['peak']:.3e}",
                    rms_err_over_row_rms=f"{errs['rms']:.3e}",
                    truncated_rms_err=f"{errs['rms_trunc']:.3e}")
    # edge cases: ragged M, O and U; a misaligned x and weight (4-byte
    # floats and single bytes instead of 16-byte copies)
    for m, o, u, misaligned in ((3, 37, 30, False), (17, 1024, 4096, True),
                                (4, 37, 30, True)):
        seed += 1
        x, wf, qw, scale = int8_inputs(torch, dev, m, o, u, seed)
        if misaligned:
            xf = torch.empty(x.numel() + 1, device=dev)
            qf = torch.empty(qw.numel() + 1, dtype=torch.int8, device=dev)
            x = xf[1:].view(m, u).copy_(x)
            qw = qf[1:].view(o, u).copy_(qw)
        diff, errs = int8_case(torch, i8, x, wf, qw, scale,
                               f"M={m} O={o} U={u}")
        max_diff = keep(m, u, diff, errs)
        say("int8", M=m, O=o, U=u, misaligned=misaligned,
            plan=tuple(plan_of(m, o, u, errs["route"])), bitwise=True,
            repeats_bitwise=True, **readings(errs))
    sums = {m: {"ms": 0.0, "k1_ms": 0.0, "product_ms": 0.0,
                "mma_sync_ms": 0.0, "plain_ms": 0.0,
                "weight_only_ms": 0.0, "f32_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0, "library_refused": [], "bound_by": set()}
            for m in INT8_TIMED_M}
    for m in INT8_DECODE_M:
        sums[m].update(ms_clean_l2=0.0, product_clean_l2_ms=0.0,
                       mma_sync_clean_l2_ms=0.0)
    for o, u, per_forward in INT8_SHAPES:
        for m in INT8_M:
            if o == INT8_SHAPES[-1][0] and m not in INT8_HEAD_M:
                continue
            seed += 1
            x, wf, qw, scale = int8_inputs(torch, dev, m, o, u, seed)
            diff, errs = int8_case(torch, i8, x, wf, qw, scale,
                                   f"M={m} O={o} U={u}")
            max_diff = keep(m, u, diff, errs)
            plan = plan_of(m, o, u, errs["route"])
            fields = dict(M=m, O=o, U=u, block_rows=plan.block_rows,
                          block_cols=plan.block_cols,
                          slices=plan.slices, blocks=plan.blocks,
                          workspace_bytes=plan.workspace_bytes,
                          quantize_blocks_a_row=i8.quantize_cluster(m, u,
                                                                    sms),
                          bitwise=True, repeats_bitwise=True,
                          **readings(errs))
            if errs["route"] == "decode":
                fields["smem_bytes"] = i8.decode_smem_bytes(
                    plan.block_rows, plan.chunks_per_slice)
                fields["slice_bytes_of_u"] = (plan.chunks_per_slice
                                              * i8.DECODE_CHUNK)
            if m not in INT8_TIMED_M:
                say("int8", **fields)
                continue
            xq, sx = i8.quantize_rows(x)
            t = {"ms": time_ms(torch, lambda: i8.int8_dense(x, qw, scale),
                               flush),
                 "k1_ms": time_ms(torch, lambda: i8.quantize_rows(x), flush),
                 "product_ms": time_ms(torch, lambda: i8.product(
                     xq, sx, u, qw, scale), flush),
                 # the mma.sync tile kernel on the same call: the
                 # yardstick of the decode and wgmma kernels
                 "mma_sync_ms": time_ms(torch, lambda: i8.product(
                     xq, sx, u, qw, scale, route="mma_sync"), flush),
                 "plain_ms": time_ms(torch, lambda: i8.int8_dense_torch(
                     x, qw, scale), flush),
                 "weight_only_ms": time_ms(torch, lambda: F.linear(
                     x, qw.float()) * scale, flush),
                 "f32_ms": time_ms(torch, lambda: F.linear(x, wf), flush)}
            if m in INT8_DECODE_M:  # the stream after a flush that leaves L2 clean
                clean = ReadFlush(flush)
                t["ms_clean_l2"] = time_ms(
                    torch, lambda: i8.int8_dense(x, qw, scale), clean)
                t["product_clean_l2_ms"] = time_ms(torch, lambda: i8.product(
                    xq, sx, u, qw, scale), clean)
                t["mma_sync_clean_l2_ms"] = time_ms(torch, lambda: i8.product(
                    xq, sx, u, qw, scale, route="mma_sync"), clean)
            bound, bound_by = int8_bound_ms(m, o, u)
            try:
                xq_u = xq[:, :u]
                lib = time_ms(torch, lambda: torch._int_mm(xq_u, qw.t()),
                              flush)
            except RuntimeError as exc:
                lib = None
                sums[m]["library_refused"].append(
                    f"{o}x{u}: {str(exc).splitlines()[0][:80]}")
            r = sums[m]
            for k, v in t.items():
                r[k] += v * per_forward
            r["bound_ms"] += bound * per_forward
            r["bound_by"].add(bound_by)
            if lib is not None and r["library_ms"] is not None:
                r["library_ms"] += lib * per_forward
            else:
                r["library_ms"] = None
            say("int8", **fields, **{k: f"{v:.6f}" for k, v in t.items()},
                bound_ms=f"{bound:.6f}", bound_by=bound_by,
                share_of_bound=f"{bound / t['ms']:.4f}",
                product_share_of_bound=f"{bound / t['product_ms']:.4f}",
                int_mm_ms="refused" if lib is None else f"{lib:.6f}")
            del xq, sx
        del x, wf, qw, scale
        free_cuda(torch)
    out = {}
    for m, r in sums.items():
        products = sum(n for o, _, n in INT8_SHAPES
                       if o != INT8_SHAPES[-1][0] or m in INT8_HEAD_M)
        say("int8 forward", M=m, products=products,
            **{k: f"{v:.6f}" for k, v in r.items()
               if isinstance(v, float)},
            library_ms_int_mm=("null" if r["library_ms"] is None
                               else f"{r['library_ms']:.6f}"),
            int_mm_refused=r["library_refused"] or None,
            bound_by="+".join(sorted(r["bound_by"])),
            share_of_bound=f"{r['bound_ms'] / r['ms']:.4f}",
            product_share_of_bound=f"{r['bound_ms'] / r['product_ms']:.4f}",
            mma_sync_over_product=f"{r['mma_sync_ms'] / r['product_ms']:.4f}",
            k1_share_of_call=f"{r['k1_ms'] / r['ms']:.4f}",
            product_over_int_mm=("null" if r["library_ms"] is None else
                                 f"{r['product_ms'] / r['library_ms']:.4f}"),
            decode_bound_ms=INT8_DECODE_BOUND_MS if m in INT8_DECODE_M
            else None)
        out[m] = dict(r, bound_by="bytes" if r["bound_by"] == {"bytes"}
                      else "operations", max_abs_err=max_diff,
                      products=products)
    say("int8", max_abs_err_vs_plain=max_diff,
        max_err_over_row_max=f"{worst['peak']:.3e}",
        max_rms_err_over_row_rms=f"{worst['rms']:.3e}",
        rms_limit=INT8_ROW_RMS_LIMIT,
        **{f"truncated_least_{k}": f"{v:.3e}"
           for k, v in trunc_least.items()})
    int8_host_us(torch, F, i8, dev)
    return out


def int8_host_us(torch, F, i8, dev):
    """The host's cost of one call at decode's k/v shape (M = 4, O = 1024,
    U = 4096, the decode kernel; and on a misaligned copy of the weight,
    which takes the ``mma.sync`` kernel) and at a prefill shape (M = 1024,
    O = U = 4096, the wgmma kernel, whose call also encodes two tensor
    maps): INT8_HOST_CALLS calls an arm issued back to back in
    INT8_HOST_ROUNDS rounds, the arms in turn, each round's calls timed on
    the host before the sync, beside the device span of the same calls
    (CUDA events; a span near the host time means the card waited on the
    host) and the same readings of f32 ``F.linear`` at that shape. The
    decode route's host time may not exceed the ``mma.sync`` route's by
    more than INT8_HOST_GROWTH times."""
    per_round = INT8_HOST_CALLS // INT8_HOST_ROUNDS
    for m, o, u in ((4, 1024, 4096), (1024, 4096, 4096)):
        x, wf, qw, scale = int8_inputs(torch, dev, m, o, u, 9)
        arms = [("int8_dense", qw), ("f32_linear", None)]
        if m == 4:
            qf = torch.empty(qw.numel() + 1, dtype=torch.int8, device=dev)
            arms.insert(1, ("int8_dense_mma_sync",
                            qf[1:].view(o, u).copy_(qw)))
        fields, fns = {}, {}
        for name, w in arms:
            if w is None:
                fns[name] = lambda: F.linear(x, wf)  # noqa: E731
            else:
                fields[f"{name}_kernel"] = i8.route_for(m, u, w.data_ptr())
                fns[name] = (lambda w=w:  # noqa: E731
                             i8.int8_dense(x, w, scale))
            for _ in range(10):
                fns[name]()
        torch.cuda.synchronize()
        host, span = dict.fromkeys(fns, 0.0), dict.fromkeys(fns, 0.0)
        for r in range(INT8_HOST_ROUNDS):
            for name in list(fns)[::-1] if r % 2 else list(fns):
                fn = fns[name]
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                t0 = time.perf_counter()
                for _ in range(per_round):
                    fn()
                host[name] += time.perf_counter() - t0
                e1.record()
                torch.cuda.synchronize()
                span[name] += e0.elapsed_time(e1) * 1e-3
        calls = per_round * INT8_HOST_ROUNDS
        for name in fns:
            fields[f"{name}_host_us"] = f"{host[name] / calls * 1e6:.3f}"
            fields[f"{name}_span_us"] = f"{span[name] / calls * 1e6:.3f}"
        say("int8 host", M=m, O=o, U=u, calls=calls,
            rounds=INT8_HOST_ROUNDS, forward_calls=INT8_FORWARD, **fields)
        if m == 4:
            check(fields["int8_dense_kernel"] == "decode"
                  and fields["int8_dense_mma_sync_kernel"] == "mma_sync",
                  f"int8 host: the arms took {fields}")
            growth = host["int8_dense"] / host["int8_dense_mma_sync"]
            say("int8 host", decode_over_mma_sync=f"{growth:.4f}",
                limit=INT8_HOST_GROWTH)
            check(growth <= INT8_HOST_GROWTH,
                  f"int8 host: the decode route's call costs "
                  f"{fields['int8_dense_host_us']} us on the host, "
                  f"{growth:.4f} times the mma.sync route's "
                  f"{fields['int8_dense_mma_sync_host_us']} (limit "
                  f"{INT8_HOST_GROWTH})")
        del x, wf, qw, scale


def stable_close(torch, out, ref, what):
    """S1-S3 against their plain versions: within STABLE_REL of the
    largest |output| (the same f32 sums in another order). Returns the max
    abs error."""
    err = float((out - ref).abs().max())
    check(bool(torch.isfinite(out).all()), f"{what}: output not finite")
    check(err <= STABLE_REL * float(ref.abs().max()),
          f"{what}: kernel differs from plain by {err} (largest |output| "
          f"{float(ref.abs().max())})")
    return err


def stable_dense_bound(m, o, u):
    """S1's least time (ms): the bytes of x, w and out at the memory rate
    against its f32 products at three TF32 passes (the table's rule)."""
    t_bytes = 4 * (m * u + o * u + m * o) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * o * u * 3 / TF32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stable_attention_bound(b, h, kv, t, d, sp):
    """S2's least time (ms) for one launch: q, out and each batch row's
    live K/V rows (up to start_pos + T) read once, against its 4 D f32
    products a live (query, position) pair at three TF32 passes."""
    kv_rows = sum(min(p + t, MAX_SEQ) for p in sp)
    pairs = sum(min(p + i + 1, MAX_SEQ) for p in sp for i in range(t)) * h
    t_bytes = 4 * (2 * b * h * t * d + 2 * kv * kv_rows * d + b) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * d * pairs * 3 / TF32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_attention(torch, F, q, k, v, sp):
    """The library's call for S2: f32 ``scaled_dot_product_attention`` on
    the expanded heads with a boolean mask of the live positions."""
    b, h, t, _ = q.shape
    s = k.shape[2]
    rep = h // k.shape[1]
    ke = k.repeat_interleave(rep, dim=1)
    ve = v.repeat_interleave(rep, dim=1)
    pos = sp.long()[:, None] + torch.arange(t, device=q.device)
    mask = (torch.arange(s, device=q.device)[None, None, :]
            <= pos[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)


def stable_phase(torch, F, st, nn_ops, flush, dev):
    """Phase 3c: S1-S3 (``ops.hopper.stable_ops``) at Llama-3-8B's shapes
    against their plain versions, bitwise repeats, bitwise row invariance,
    misaligned and ragged inputs; times over one forward beside the bound,
    the plain version and the library call, and whether each library call
    is row-invariant. Returns the JSON rows' numbers by name."""
    phase = "stable"
    for name, a in st.kernel_attributes().items():
        say(phase, kernel=name, **a)
        check(a["local_bytes"] == 0, f"stable kernel {name} uses "
              f"{a['local_bytes']} local bytes a thread (a spill)")
    gen = torch.Generator(device=dev).manual_seed(22)
    rows, lib_inv = {}, {}
    err = {"dense": 0.0, "attention": 0.0, "norm": 0.0}

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def weight(o, u):
        return (torch.rand(o, u, device=dev, generator=gen) - 0.5) * 0.14

    # S1 at every projection shape: decode (1, 4), verify (20), the
    # engine's chunk (256) and prefill (1024) rows; sums over one forward at
    # M = 4 (225 products), 256 and 1024 (the 224 layer products; a
    # prefill's head runs at M = 4). At prefill rows the plan's ring-fed
    # tile is held bit for bit to every other instantiation (the first
    # prefill tile, which loads from global memory, and the decode tiles)
    # and timed beside the first prefill tile
    sums = {m: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "bound_ms": 0.0, "ops_ms": 0.0, "fma_ms": 0.0,
                "global_tile_ms": 0.0}
            for m in (STABLE_DECODE_M, STABLE_CHUNK_M, STABLE_PREFILL_M)}
    others = [i for i in range(len(st.DENSE_TILES)) if i != st.PREFILL_TILE]
    for o, u, n in INT8_SHAPES:
        w = weight(o, u)
        head = n == 1
        full_m = 20 if head else STABLE_PREFILL_M
        x = randn(full_m, u)
        full = st.stable_dense(x, w)
        check(st.last_path() == "cuda", "stable_dense did not launch")
        check(torch.equal(st.stable_dense(x, w), full),
              f"S1 does not repeat bit for bit at ({full_m}, {o}, {u})")
        err["dense"] = max(err["dense"], stable_close(
            torch, full, st.stable_dense_torch(x, w), f"S1 ({full_m}, {o}, "
            f"{u})"))
        for r0, m in ((0, 1), (0, 4), (full_m // 2, 4), (full_m - 4, 4),
                      (full_m - 1, 1)):
            check(torch.equal(st.stable_dense(x[r0:r0 + m], w),
                              full[r0:r0 + m]),
                  f"S1 rows {r0}..{r0 + m} differ from the same rows inside "
                  f"M = {full_m} at ({o}, {u})")
        if not head:
            for m in (STABLE_CHUNK_M, STABLE_PREFILL_M):
                xm = x[:m].contiguous()
                new = st.dense_launch(xm, w, tile=st.PREFILL_TILE)
                for i in others:
                    check(torch.equal(st.dense_launch(xm, w, tile=i), new),
                          f"S1's prefill tile differs from instantiation "
                          f"{i} {st.DENSE_TILES[i]} at ({m}, {o}, {u})")
            del new
        lib_inv[f"linear_{o}x{u}"] = bool(torch.equal(
            F.linear(x[:4], w), F.linear(x, w)[:4]))
        for m in sums:
            if head and m != STABLE_DECODE_M:
                continue
            xm = x[:m].contiguous()
            reps = 25 if m <= 20 else 3
            k_ms = time_ms(torch, lambda: st.stable_dense(xm, w), flush,
                           reps=reps, warm=1)
            p_ms = time_ms(torch, lambda: st.stable_dense_torch(xm, w), flush,
                           reps=3, warm=1)
            l_ms = time_ms(torch, lambda: F.linear(xm, w), flush, reps=reps,
                           warm=1)
            g_ms = (time_ms(torch, lambda: st.dense_launch(
                xm, w, tile=st.GLOBAL_PREFILL_TILE), flush, reps=reps,
                warm=1) if m > st.DECODE_ROWS else 0.0)
            bound, by = stable_dense_bound(m, o, u)
            fma = 2 * m * o * u / F32_FLOP_PER_S * 1e3
            say(phase, kernel="dense", m=m, o=o, u=u,
                tile=st.DENSE_TILES[st.dense_plan(m, o, st._sm_count(dev))],
                ms=f"{k_ms:.6f}", global_tile_ms=f"{g_ms:.6f}",
                plain_ms=f"{p_ms:.6f}", library_ms=f"{l_ms:.6f}",
                bound_ms=f"{bound:.6f}", bound_by=by,
                share=f"{bound / k_ms:.4f}", f32_fma_bound_ms=f"{fma:.6f}",
                f32_fma_share=f"{fma / k_ms:.4f}")
            acc = sums[m]
            acc["ms"] += n * k_ms
            acc["plain_ms"] += n * p_ms
            acc["library_ms"] += n * l_ms
            acc["global_tile_ms"] += n * g_ms
            acc["bound_ms"] += n * bound
            acc["ops_ms"] += n * 2 * m * o * u * 3 / TF32_FLOP_PER_S * 1e3
            acc["fma_ms"] += n * fma
        del w, x, full
    # every instantiation gives every output the same bits; misaligned
    # (scalar loads, 4-byte copies) and ragged inputs
    x, w = randn(24, 4096), weight(1024, 4096)
    outs = [st.dense_launch(x, w, tile=i) for i in range(len(st.DENSE_TILES))]
    check(all(torch.equal(o_, outs[0]) for o_ in outs),
          "S1's instantiations disagree")
    xa, wa = randn(4, 4096), weight(1024, 4096)
    xm_, wm_ = misaligned(torch, xa), misaligned(torch, wa)
    check(torch.equal(st.stable_dense(xm_, wm_), st.stable_dense(xa, wa)),
          "S1 on misaligned inputs differs from the aligned call")
    xa = randn(STABLE_PREFILL_M, 4096)
    check(torch.equal(st.stable_dense(misaligned(torch, xa),
                                      misaligned(torch, wa)),
                      st.stable_dense(xa, wa)),
          "S1's prefill tile on misaligned inputs differs from the aligned "
          "call")
    xr, wr, br = randn(3, 30), weight(37, 30), randn(37)
    err["dense"] = max(err["dense"], stable_close(
        torch, st.stable_dense(xr, wr, br), st.stable_dense_torch(xr, wr, br),
        "S1 ragged (3, 37, 30) with bias"))
    xr, wr, br = randn(1000, 4095), weight(37, 4095), randn(37)
    ragged = st.stable_dense(xr, wr, br)
    err["dense"] = max(err["dense"], stable_close(
        torch, ragged, st.stable_dense_torch(xr, wr, br),
        "S1 ragged (1000, 37, 4095) with bias"))
    for i in others:
        check(torch.equal(st.dense_launch(xr, wr, br, tile=i), ragged),
              f"S1's prefill tile differs from instantiation {i} at (1000, "
              "37, 4095)")
    del x, w, xa, wa, xr, wr, ragged, outs
    for m in sums:
        acc = sums[m]
        n_fw = STABLE_PRODUCTS - (1 if m > st.DECODE_ROWS else 0)
        say(phase, kernel="dense", forward_rows=m, products=n_fw,
            ms=f"{acc['ms']:.6f}", global_tile_ms=f"{acc['global_tile_ms']:.6f}",
            plain_ms=f"{acc['plain_ms']:.6f}",
            library_ms=f"{acc['library_ms']:.6f}",
            bound_ms=f"{acc['bound_ms']:.6f}",
            ops_bound_ms=f"{acc['ops_ms']:.6f}",
            f32_fma_bound_ms=f"{acc['fma_ms']:.6f}",
            share=f"{acc['bound_ms'] / acc['ms']:.4f}",
            f32_fma_share=f"{acc['fma_ms'] / acc['ms']:.4f}",
            over_library=f"{acc['ms'] / acc['library_ms']:.4f}")
        if m == STABLE_CHUNK_M:
            continue
        rows[f"stable_dense_m{m}"] = {
            "kernel": "dense", "rows": m, "max_abs_err": err["dense"],
            "ms": acc["ms"], "plain_ms": acc["plain_ms"],
            "bound_ms": acc["bound_ms"],
            "bound_by": ("bytes" if acc["bound_ms"] > acc["ops_ms"]
                         else "operations"),
            "library_ms": acc["library_ms"]}

    # S2: decode (T = 1 at the middle of a 32-token generate) and prefill
    # (T = 256 from position 0; the rows kernel) at Llama-3-8B's heads, the
    # rows kernel bit for bit the heads kernel at T = 256 from position 0
    # and from mid-ring, at D = 30 and 256 (MHA and ragged) and on
    # misaligned rings; times over one forward's 32 layers (at T = 256 the
    # heads kernel's beside the rows kernel's)
    b, h, kv, d = 4, 32, 8, 128
    sc = 1.0 / math.sqrt(d)
    cases = [("t1", 1, STABLE_DECODE_SP), ("t256", 256, [0] * b)]
    for label, t, sp_list in cases:
        q, k, v = randn(b, h, t, d), randn(b, kv, MAX_SEQ, d), \
            randn(b, kv, MAX_SEQ, d)
        sp = torch.tensor(sp_list, dtype=torch.int32, device=dev)
        out = st.stable_attention(q, k, v, sp)
        check(st.last_path() == "cuda", "stable_attention did not launch")
        check(torch.equal(st.stable_attention(q, k, v, sp), out),
              f"S2 does not repeat bit for bit at T = {t}")
        check(torch.equal(st.stable_attention(misaligned(torch, q),
                                              misaligned(torch, k),
                                              misaligned(torch, v), sp), out),
              f"S2 on misaligned inputs differs at T = {t}")
        err["attention"] = max(err["attention"], stable_close(
            torch, out, st.stable_attention_torch(q, k, v, sp),
            f"S2 at T = {t}"))
        route = st.attention_route(b, h, kv, t, MAX_SEQ, d,
                                   st._sm_count(dev))
        h_ms = 0.0
        if route == "rows":
            check(torch.equal(st.attention_launch(q, k, v, sp, sc,
                                                  route="heads"), out),
                  f"S2's rows kernel differs from the heads kernel at T = "
                  f"{t} from position 0")
            mid = sp + torch.tensor([300, 517, 700, 3], dtype=torch.int32,
                                    device=dev)
            check(torch.equal(
                st.attention_launch(q, k, v, mid, sc, route="rows"),
                st.attention_launch(q, k, v, mid, sc, route="heads")),
                f"S2's rows kernel differs from the heads kernel at T = {t} "
                "from mid-ring")
            h_ms = time_ms(torch, lambda: st.attention_launch(
                q, k, v, sp, sc, route="heads"), flush)
        lib = library_attention(torch, F, q, k, v, sp)
        k_ms = time_ms(torch, lambda: st.stable_attention(q, k, v, sp), flush)
        p_ms = time_ms(torch, lambda: st.stable_attention_torch(q, k, v, sp),
                       flush, reps=3, warm=1)
        l_ms = time_ms(torch, lib, flush)
        bound, by = stable_attention_bound(b, h, kv, t, d, sp_list)
        if route == "rows":
            tq, gb = st.attention_rows_plan(h, kv, t, MAX_SEQ, d)
            plan = dict(route=route, tq=tq, gb=gb,
                        smem_bytes=st.attention_rows_smem_bytes(
                            tq * gb, MAX_SEQ, d))
        else:
            plan = dict(route=route, warps=st.attention_warps(h, kv),
                        smem_bytes=st.attention_smem_bytes(
                            st.attention_warps(h, kv), MAX_SEQ, d))
        say(phase, kernel="attention", t=t, start_pos=sp_list, **plan,
            ms=f"{k_ms:.6f}", heads_kernel_ms=f"{h_ms:.6f}",
            plain_ms=f"{p_ms:.6f}", library_ms=f"{l_ms:.6f}",
            bound_ms=f"{bound:.6f}", bound_by=by,
            share=f"{bound / k_ms:.4f}",
            forward_ms=f"{k_ms * STABLE_LAYERS:.6f}",
            forward_heads_kernel_ms=f"{h_ms * STABLE_LAYERS:.6f}",
            forward_library_ms=f"{l_ms * STABLE_LAYERS:.6f}")
        rows[f"stable_attention_{label}"] = {
            "kernel": "attention", "rows": t, "max_abs_err": 0.0,
            "ms": k_ms * STABLE_LAYERS, "plain_ms": p_ms * STABLE_LAYERS,
            "bound_ms": bound * STABLE_LAYERS, "bound_by": by,
            "library_ms": l_ms * STABLE_LAYERS}
        if t > 1:  # a T = 1 query inside T = 256: the kernel and the library
            inv, lib_rows = True, True
            full_lib = lib()
            for i in (0, 17, 128, 255):
                qi = q[:, :, i:i + 1].contiguous()
                inv &= torch.equal(st.stable_attention(qi, k, v, sp + i),
                                   out[:, :, i:i + 1])
                lib_rows &= torch.equal(
                    library_attention(torch, F, qi, k, v, sp + i)(),
                    full_lib[:, :, i:i + 1])
            check(inv, "S2: a T = 1 query differs from the same row inside "
                  "T = 256")
            lib_inv["sdpa_f32_mask"] = bool(lib_rows)
        del q, k, v, out
    for bb, hh, kk, t, s, dd, sp_list in ((2, 6, 6, 3, 70, 30, [0, 40]),
                                          (2, 8, 2, 5, 333, 256, [100, 330]),
                                          (2, 8, 2, 40, 333, 256, [0, 310]),
                                          (2, 32, 8, 20, 1024, 30,
                                           [1000, 77])):
        q, k, v = randn(bb, hh, t, dd), randn(bb, kk, s, dd), \
            randn(bb, kk, s, dd)
        sp = torch.tensor(sp_list, dtype=torch.int32, device=dev)
        out = st.stable_attention(q, k, v, sp)
        check(torch.equal(st.stable_attention(q, k, v, sp), out),
              f"S2 does not repeat bit for bit at D = {dd}")
        heads = st.attention_launch(q, k, v, sp, 1.0 / math.sqrt(dd),
                                    route="heads")
        check(torch.equal(out, heads) and torch.equal(
            st.attention_launch(misaligned(torch, q), misaligned(torch, k),
                                misaligned(torch, v), sp,
                                1.0 / math.sqrt(dd), route="rows"), heads),
              f"S2's rows kernel differs from the heads kernel at D = {dd}, "
              f"H = {hh}, KV = {kk}, T = {t}")
        err["attention"] = max(err["attention"], stable_close(
            torch, out, st.stable_attention_torch(q, k, v, sp),
            f"S2 at D = {dd}, H = {hh}, KV = {kk}"))
    for label in ("t1", "t256"):
        rows[f"stable_attention_{label}"]["max_abs_err"] = err["attention"]

    # S3: rows of 4096 at M = 4 (decode: 65 a forward) and 1024 (a
    # prefill's 64 layer norms), a misaligned copy, a ragged 4095
    n_norm = 4096
    gamma = torch.rand(n_norm, device=dev, generator=gen) + 0.5
    x = randn(STABLE_PREFILL_M, n_norm)
    full = st.stable_rms_norm(x, gamma, STABLE_EPS)
    check(torch.equal(st.stable_rms_norm(x, gamma, STABLE_EPS), full),
          "S3 does not repeat bit for bit")
    check(torch.equal(st.stable_rms_norm(misaligned(torch, x), gamma,
                                         STABLE_EPS), full),
          "S3 on a misaligned x differs")
    err["norm"] = stable_close(torch, full, st.stable_rms_norm_torch(
        x, gamma, STABLE_EPS), "S3 at 1024 rows")
    xr, gr = randn(5, 4095), torch.rand(4095, device=dev, generator=gen)
    err["norm"] = max(err["norm"], stable_close(
        torch, st.stable_rms_norm(xr, gr, STABLE_EPS),
        st.stable_rms_norm_torch(xr, gr, STABLE_EPS), "S3 ragged rows"))
    for r0 in (0, 510, 1020):
        check(torch.equal(st.stable_rms_norm(x[r0:r0 + 4], gamma,
                                             STABLE_EPS), full[r0:r0 + 4]),
              f"S3 rows {r0}..{r0 + 4} differ from the same rows inside 1024")
    lib_inv["rms_norm"] = bool(torch.equal(
        F.rms_norm(x[:4], (n_norm,), gamma, STABLE_EPS),
        F.rms_norm(x, (n_norm,), gamma, STABLE_EPS)[:4]))
    lib_inv["ops_nn_rms_norm"] = bool(torch.equal(
        nn_ops.rms_norm(x[:4], gamma, eps=STABLE_EPS),
        nn_ops.rms_norm(x, gamma, eps=STABLE_EPS)[:4]))
    for m, n in ((STABLE_DECODE_M, STABLE_NORMS),
                 (STABLE_PREFILL_M, STABLE_NORMS - 1)):
        xm = x[:m].contiguous()
        k_ms = time_ms(torch, lambda: st.stable_rms_norm(xm, gamma,
                                                         STABLE_EPS), flush)
        p_ms = time_ms(torch, lambda: st.stable_rms_norm_torch(
            xm, gamma, STABLE_EPS), flush)
        l_ms = time_ms(torch, lambda: F.rms_norm(xm, (n_norm,), gamma,
                                                 STABLE_EPS), flush)
        bound = 4 * (2 * m * n_norm + n_norm) / HBM_BYTES_PER_S * 1e3
        say(phase, kernel="norm", m=m, n=n_norm, ms=f"{k_ms:.6f}",
            plain_ms=f"{p_ms:.6f}", library_ms=f"{l_ms:.6f}",
            bound_ms=f"{bound:.6f}", share=f"{bound / k_ms:.4f}",
            forward_launches=n, forward_ms=f"{k_ms * n:.6f}")
        rows[f"stable_rms_norm_m{m}"] = {
            "kernel": "norm", "rows": m, "max_abs_err": err["norm"],
            "ms": k_ms * n, "plain_ms": p_ms * n, "bound_ms": bound * n,
            "bound_by": "bytes", "library_ms": l_ms * n}
    say(phase, library_row_invariant=lib_inv)
    say(phase, max_abs_err_dense=err["dense"],
        max_abs_err_attention=err["attention"], max_abs_err_norm=err["norm"])
    return rows


def misaligned(torch, x):
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary: the kernels must take it with scalar loads, in the same
    order."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = flat[1:].view(x.shape)
    y.copy_(x)
    return y


def baseline_phase(torch, st, Generator, ContinuousEngine, model, prompts,
                   n_layers, vocab, pallas, pallas_prefill_logits):
    """Serve baseline: the strict rung on ``llama3_8b`` (phase 4-5's
    prompts, ring, buckets and 32 greedy tokens). Gates: S1-S3 launched
    by every layer of every forward and nothing new after warmup; at the
    first and sixth decode step every row's logits bit for bit a fresh
    full prefill's of its prefix at bucket 256; the paged run's logits and
    tokens the ring run's; multi-step (N = 8) and ``ContinuousEngine``
    tokens the single-step tokens; a default ``Generator`` under
    ``MXNET_SERVE_STRICT_PARITY=1`` serving the rung. Returns the launches
    by (kernel, rows) of the timed single-step generate."""
    import numpy as np

    from mxnet_tpu_torch.ops.hopper.decode_attention import natural_block
    from mxnet_tpu_torch.serve import KVCache

    phase = "serve baseline"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(max_seq=MAX_SEQ, batch_buckets=(1, 4), prompt_buckets=(64, 256))
    gen = Generator(model, decode_path="baseline", name="llama3_8b_baseline",
                    **kw)
    w = gen.warmup()
    say(phase, warmup_s=f"{w['wall_s']:.3f}", signatures=w["signatures"])
    st.reset_launch_count()
    fc = ForwardCount(model)
    try:
        out, info = gen.generate(prompts, max_new_tokens=NEW_TOKENS)
    finally:
        fc.close()
    counts, rows = st.launch_count(), st.row_launches()
    routes = st.route_launches()
    steps = info["decode_steps"]
    check(steps == NEW_TOKENS - 1 and fc.calls == 1 + steps,
          f"{phase}: {steps} decode steps, {fc.calls} forwards")
    check(all(len(o) == NEW_TOKENS for o in out), f"{phase}: short output")
    forwards = fc.calls
    want = {"dense": STABLE_PRODUCTS * forwards,
            "attention": n_layers * forwards,
            "norm": (2 * n_layers + 1) * forwards}
    check(counts == want, f"{phase}: launches {counts}, expected {want}")
    toks, lens, bb = gen._pad_prompts(prompts)
    m_pre = toks.shape[0] * toks.shape[1]
    want_rows = {("dense", m_pre): STABLE_PRODUCTS - 1,
                 ("dense", bb): 1 + STABLE_PRODUCTS * steps,
                 ("attention", toks.shape[1]): n_layers,
                 ("attention", 1): n_layers * steps,
                 ("norm", m_pre): 2 * n_layers,
                 ("norm", bb): 1 + (2 * n_layers + 1) * steps}
    check(rows == want_rows, f"{phase}: launches by (kernel, rows) "
          f"{sorted(rows.items())}, expected {sorted(want_rows.items())}")
    # S2's prefill (bb x 256 rows) takes the rows kernel, each decode step
    # the heads kernel
    want_routes = {"rows": n_layers, "heads": n_layers * steps}
    check(routes == want_routes, f"{phase}: S2 launches by kernel {routes}, "
          f"expected {want_routes}")
    gen.assert_no_recompiles()
    agree = sum(a == b for a, b in zip(out, pallas["out"]))
    say(phase, prefill_ms=f"{info['prefill_ms']:.3f}",
        first_kernels_prefill_ms=STABLE_FIRST_PREFILL_MS,
        decode_ms_per_token=f"{info['decode_ms'] / steps:.3f}",
        tokens_s=f"{info['tokens_s']:.3f}", decode_steps=steps,
        launches=counts, launches_by_kernel_and_rows=sorted(rows.items()),
        attention_launches_by_kernel=routes,
        rows_equal_to_pallas_tokens=f"{agree}/{len(out)}",
        first_tokens=[o[:4] for o in out])

    # decode against a fresh full prefill of each row's prefix, bit for bit
    def fresh_prefill(seqs):
        t = np.zeros_like(toks)
        for i, sq in enumerate(seqs):
            t[i, :len(sq)] = sq
        n = np.array([len(sq) for sq in seqs], np.int32)
        return gen.prefill(t, n, KVCache.alloc(model, bb, MAX_SEQ))[0]

    logits, cache = gen.prefill(toks, lens, gen._fresh_cache(bb))
    check(tuple(logits.shape) == (bb, vocab)
          and bool(torch.isfinite(logits).all()),
          f"{phase}: prefill logits {tuple(logits.shape)}")
    lp = pallas_prefill_logits.to(logits.device)
    say(phase, prefill_logit_gap_to_pallas=(
        f"{float((logits - lp).abs().max()):.6e}"),
        prefill_logit_rel_gap_to_pallas=f"{rel_gap(logits, lp):.3e}",
        top1_equal_rows=int((logits.argmax(-1) == lp.argmax(-1)).sum()))
    seqs = [list(p) for p in prompts] + [[int(toks[i, 0])]
                                         for i in range(len(prompts), bb)]
    pos = lens.copy()
    ring = [logits.clone()]
    ids_by_step = []
    for k in range(1, PARITY_STEPS[-1] + 1):
        ids = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        ids_by_step.append(ids)
        for i in range(bb):
            seqs[i].append(int(ids[i]))
        logits, cache = gen.decode_step(ids, pos, cache)
        pos = pos + 1
        ring.append(logits.clone())
        if k in PARITY_STEPS:
            ref = fresh_prefill(seqs)
            diff = float((logits - ref).abs().max())
            say(phase, decode_step=k, prefix_lens=[len(sq) for sq in seqs],
                max_abs_diff_to_full_prefill=diff)
            check(torch.equal(logits, ref), f"{phase}: decode step {k}'s "
                  f"logits differ from a full prefill's by up to {diff}")
    for i in range(len(prompts)):
        check(seqs[i][len(prompts[i]):] == out[i][:PARITY_STEPS[-1]],
              f"{phase}: the parity run's tokens differ from the generate's "
              f"in row {i}")
    # paged: the same prefill and decode steps, then a generate
    paged = Generator(model, decode_path="baseline", paged=True,
                      name="llama3_8b_baseline_paged", **kw)
    pl, pool = paged.prefill(toks, lens, paged._fresh_cache(bb))
    check(torch.equal(pl, ring[0]), f"{phase}: paged prefill logits differ")
    pos = lens.copy()
    for k, ids in enumerate(ids_by_step, 1):
        pl, pool = paged.decode_step(ids, pos, pool)
        pos = pos + 1
        check(torch.equal(pl, ring[k]), f"{phase}: paged decode step {k}'s "
              "logits differ from the ring run's")
    out_paged, _ = paged.generate(prompts, max_new_tokens=NEW_TOKENS)
    check(out_paged == out, f"{phase}: paged tokens differ from the ring's")
    del paged, pool
    free_cuda(torch)
    # multi-step: one CUDA graph a (bucket, N or 1, greedy or sampled)
    multi = Generator(model, decode_path="baseline", multistep=True,
                      decode_steps=DECODE_STEPS,
                      name="llama3_8b_baseline_multi", **kw)
    mw = multi.warmup()
    n0 = st.launch_count()["dense"]
    out_multi, minfo = multi.generate(prompts, max_new_tokens=NEW_TOKENS)
    multi.assert_no_recompiles()
    dense = st.launch_count()["dense"] - n0
    check(out_multi == out, f"{phase}: multi-step tokens differ from "
          "single-step's")
    check(dense == STABLE_PRODUCTS * (1 + DECODE_STEPS
                                      * minfo["decode_visits"]),
          f"{phase}: multi-step launched S1 {dense} times in "
          f"{minfo['decode_visits']} visits")
    say(phase, multistep_captures=mw.get("captures"),
        multistep_visits=minfo["decode_visits"],
        multistep_decode_ms_per_token=(
            f"{minfo['decode_ms'] / minfo['decode_steps']:.3f}"),
        multistep_dense_launches=dense)
    del multi
    free_cuda(torch)
    # the continuous engine: (1, 256) prefill chunks, 4 decode slots
    with ContinuousEngine(model, max_seq=MAX_SEQ, num_slots=4,
                          page_size=natural_block(), prefill_chunk=CB_CHUNK,
                          decode_path="baseline",
                          name="llama3_8b_baseline_cb") as eng:
        futs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        out_eng = [f.result(timeout=CB_WAIT)["tokens"] for f in futs]
        eng.assert_no_recompiles()
    check(out_eng == out, f"{phase}: engine tokens differ from the "
          "Generator's")
    free_cuda(torch)
    # MXNET_SERVE_STRICT_PARITY=1: a default Generator serves the rung
    os.environ["MXNET_SERVE_STRICT_PARITY"] = "1"
    try:
        strict = Generator(model, name="llama3_8b_strict", **kw)
        out_strict, _ = strict.generate(prompts, max_new_tokens=NEW_TOKENS)
    finally:
        del os.environ["MXNET_SERVE_STRICT_PARITY"]
    check(strict.decode_path == "baseline" and out_strict == out,
          f"{phase}: the strict-parity Generator ({strict.decode_path}) "
          "did not serve the baseline tokens")
    del strict, gen
    free_cuda(torch)
    say(phase, paged_equal=True, multistep_equal=True, engine_equal=True,
        strict_parity_equal=True,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        phase_seconds=f"{time.perf_counter() - t_phase:.3f}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="run phases 1-3c, 6 and 8 only (builds and kernels)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "mxnet_tpu_torch")):
        print(f"chip_smoke: no mxnet_tpu_torch package next to {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import numpy as np
    import torch.nn.functional as F

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.contrib.pallas_fuse import (FusedResNetV1,
                                                     fuse_resnet_v1)
    from mxnet_tpu_torch.gluon import loss as loss_mod
    from mxnet_tpu_torch.gluon import metric
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.models import get_llama
    from mxnet_tpu_torch.models.llama import _LLAMA_CONFIGS
    from mxnet_tpu_torch.ops import nn as nn_ops
    from mxnet_tpu_torch.ops.hopper import _build
    from mxnet_tpu_torch.ops.hopper import conv1x1 as c1x1
    from mxnet_tpu_torch.ops.hopper import decode_attention as da
    from mxnet_tpu_torch.ops.hopper import flash_attention as fa
    from mxnet_tpu_torch.ops.hopper import int8_dense as i8
    from mxnet_tpu_torch.ops.hopper import stable_ops as st
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.resilience import faults
    from mxnet_tpu_torch.serve import (ContinuousEngine, Generator,
                                       InferenceSession, ModelRegistry,
                                       Replica, Router, SpeculativeGenerator,
                                       fleet_stats, percentile)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say("device", kind=json.dumps(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])
    print(f"nvidia-smi: {smi}", flush=True)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "allow_tf32 is on: f32 matmuls would run in TF32")
    gen = torch.Generator(device=dev).manual_seed(7)
    cx = torch.randn(8, 64, 56, 56, device=dev, generator=gen)
    cw = torch.randn(64, 64, 3, 3, device=dev, generator=gen)
    c64 = F.conv2d(cx.double(), cw.double(), None, 1, 1)
    conv_err = {label: float((out.double() - c64).abs().max()
                             / c64.abs().max())
                for label, out in (("port", nn_ops.convolution(cx, cw, None,
                                                               1, 1)),
                                   ("torch_default", F.conv2d(cx, cw, None,
                                                              1, 1)))}
    say("device", cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        conv_f32_rel_err_port=f"{conv_err['port']:.3e}",
        conv_f32_rel_err_torch_default=f"{conv_err['torch_default']:.3e}")
    check(conv_err["port"] < 1e-5, "the port's f32 convolution is not full "
          f"f32: {conv_err['port']} relative to float64")
    del cx, cw, c64

    # 2. build: one nvcc per library, all started together (the flash
    # kernels build one library per dtype pair)
    t0 = time.perf_counter()
    specs = ([("decode_attention", ()), ("conv1x1", ()), ("int8_dense", ()),
              ("stable_ops", ())]
             + [fa.build_spec(p) for p in fa.DTYPE_PAIRS])
    _build.build_many(specs)
    da.build()
    fa.build()
    c1x1.build()
    i8.build()
    st.build()
    spills = []  # gated kernels that spill
    for name, defines in specs:
        key = _build.variant_key(name, defines)
        log = _build.BUILD_LOGS.get(key)
        say("build", source=key,
            seconds=f"{log['seconds']:.3f}" if log else "cached",
            library=os.path.relpath(_build.library_path(name, defines),
                                    root))
        function = ""
        for line in (log["log"].splitlines() if log else []):
            if "Function properties for" in line:
                function = line.split("for", 1)[1].strip()
            if any(w in line for w in ("Function properties", "registers",
                                       "spill")):
                print(f"  ptxas: {line.strip()}", flush=True)
            # the pair kernels, every int8 and stable kernel, and the decode
            # kernels for D <= 128 (NC = 1, the main path's; D > 128
            # instantiations may spill a few bytes)
            gated = ("conv1x1_pair" in function
                     or name in ("int8_dense", "stable_ops") or (
                "decode_attention" in function and "ELi2EE" not in function))
            if ("spill" in line and gated and
                    " 0 bytes spill stores, 0 bytes spill loads" not in line):
                spills.append(function)
    check(not spills, f"kernels spill: {spills}")
    say("build", seconds=f"{time.perf_counter() - t0:.3f}",
        natural_block=da.natural_block())

    flush = torch.empty(64 << 18, device=dev)  # 64 MiB > the 50 MB L2
    # 3. kernel vs plain
    kres = kernel_phase(torch, da, nn_ops, flush, dev)
    # 3b. the int8 x int8 product vs plain
    t3b = time.perf_counter()
    ires = int8_phase(torch, F, i8, flush, dev)
    say("int8", phase_3b_seconds=f"{time.perf_counter() - t3b:.3f}")
    # 3c. the strict rung's shape-stable kernels vs plain
    t3c = time.perf_counter()
    sres = stable_phase(torch, F, st, nn_ops, flush, dev)
    say("stable", phase_3c_seconds=f"{time.perf_counter() - t3c:.3f}")
    if args.quick:
        flash_attributes_phase(fa)
        flash_phase(torch, fa, flush, dev)
        flash_dtype_phase(torch, fa, flush, dev)
        flash_bert_phase(torch, np, fa, flush, dev)
        pair_phase(torch, c1x1, FusedResNetV1, flush, dev)
        say("quick", seconds=f"{time.perf_counter() - t_start:.3f}")
        return 0
    del flush

    # 4./5. serve llama3_8b on the pallas and int8 rungs
    cfg = _LLAMA_CONFIGS[CONFIG]
    mt.random.seed(0)
    t0 = time.perf_counter()
    model = get_llama(CONFIG, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say("model", config=CONFIG, layers=cfg["num_layers"],
        units=cfg["units"], vocab=cfg["vocab_size"], params=n_params,
        init_s=f"{time.perf_counter() - t0:.3f}")
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, cfg["vocab_size"], size=n)]
               for n in PROMPT_LENS]
    served = {}
    for rung in ("pallas", "int8"):
        served[rung] = serve_phase(torch, da, Generator, model, rung, prompts,
                                   cfg["num_layers"], cfg["vocab_size"])
        torch.cuda.empty_cache()
    # C4: how far the int8 rung's prefill logits lie from the pallas rung's
    # (int8 weights and KV rings against f32), no gate
    lp, li = (served[r].pop("prefill_logits") for r in ("pallas", "int8"))
    say("serve int8", prefill_logit_gap_to_pallas=(
        f"{float((li - lp).abs().max()):.6e}"),
        prefill_logit_rel_gap_to_pallas=f"{rel_gap(li, lp):.3e}",
        largest_pallas_logit=f"{float(lp.abs().max()):.6e}",
        top1_equal_rows=int((li.argmax(-1) == lp.argmax(-1)).sum()),
        rows=lp.shape[0])
    # serve baseline: the strict rung (before 5f, which changes the weights)
    stable_rows = baseline_phase(torch, st, Generator, ContinuousEngine,
                                 model, prompts, cfg["num_layers"],
                                 cfg["vocab_size"], served["pallas"], lp)
    torch.cuda.empty_cache()
    # 5a. multi-step decode through CUDA graphs; 5b. paged KV and prefix
    for rung in ("pallas", "int8"):
        served[rung]["multistep"] = multistep_phase(
            torch, da, Generator, model, rung, prompts, cfg["num_layers"],
            served[rung])
    paged_phase(torch, np, da, Generator, model, prompts, cfg["num_layers"],
                cfg["vocab_size"], served)
    # 5c. continuous batching: ContinuousEngine over per-slot paged KV
    continuous_phase(torch, np, da, Generator, ContinuousEngine, percentile,
                     model, prompts, cfg["num_layers"], cfg["vocab_size"],
                     served)
    # the random 2-layer draft of 5d and 5f
    mt.random.seed(2)
    draft_rand = get_llama(CONFIG, device=dev, num_layers=2)
    # 5d. tenancy: two tenants behind ModelRegistry(max_models=1)
    tenancy_launches = tenancy_phase(torch, da, ModelRegistry, model,
                                     draft_rand, prompts, cfg["num_layers"],
                                     served)
    # 5e. fleet: a Router over two Generator replicas, one killed
    fleet_launches = fleet_phase(torch, da, Generator, Replica, Router,
                                 fleet_stats, faults, model, prompts,
                                 cfg["num_layers"], served, dev)
    # 5f. speculative decoding (last: zeroes layers 2-31's output weights)
    spec_launches = speculative_phase(torch, da, Generator,
                                      SpeculativeGenerator, get_llama, model,
                                      draft_rand, prompts, dev)
    say("b1_launches", serve=served["pallas"]["launches"],
        multistep=served["pallas"]["multistep"]["launches"],
        tenancy=tenancy_launches, fleet=fleet_launches,
        speculative_draft=spec_launches)
    del model, draft_rand
    gc.collect()
    torch.cuda.empty_cache()

    # 6. flash kernels vs plain, f32 and the other dtype pairs
    flush = torch.empty(64 << 18, device=dev)
    flash_attributes_phase(fa)
    fres = flash_phase(torch, fa, flush, dev)
    dres = flash_dtype_phase(torch, fa, flush, dev)
    bres = flash_bert_phase(torch, np, fa, flush, dev)
    del flush
    gc.collect()
    torch.cuda.empty_cache()

    # 7. train llama3_8b width at depth 4 on both attention routes
    train_launches, f32_train = train_phase(
        torch, np, mt, fa, get_llama, Trainer, loss_mod, dev,
        cfg["vocab_size"])
    gc.collect()
    torch.cuda.empty_cache()
    # 7b. the same under ShardedTrainer(dtype="bfloat16") with recompute
    amp_launches = train_amp_phase(torch, np, mt, fa, get_llama,
                                   ShardedTrainer, loss_mod, dev,
                                   cfg["vocab_size"], f32_train)
    gc.collect()
    torch.cuda.empty_cache()

    # 8. the fused 1x1-pair kernel vs plain
    flush = torch.empty(64 << 18, device=dev)
    pres = pair_phase(torch, c1x1, FusedResNetV1, flush, dev)
    del flush

    # 9. resnet50_v1 fused and served through the pair kernel
    pair_launches = resnet_phase(torch, np, mt, c1x1, vision,
                                 fuse_resnet_v1, InferenceSession, dev)

    # 10. BERT-base served (10a) and trained (10b), Transformer-base (10c)
    t10 = time.perf_counter()
    bert_served = bert_serve_phase(torch, np, mt, fa, models,
                                   InferenceSession, dev)
    bert_amp, bert_f32 = bert_train_phase(torch, np, mt, fa, models,
                                          ShardedTrainer, Trainer, loss_mod,
                                          dev)
    mt_launches = mt_train_phase(torch, np, mt, fa, models, Trainer,
                                 loss_mod, dev)
    say("flash_launches", bert_serve=bert_served, bert_train_bf16=bert_amp[
        "bf16"], bert_train_f32=bert_f32["f32"], transformer=mt_launches,
        phase_10_seconds=f"{time.perf_counter() - t10:.3f}")

    # 11. ResNet-50 v1 training: C3 at the op (11a) and model (11b) level,
    # f32, bf16 and step_n at batch 256 (11c), gluon.Trainer (11d)
    t11 = time.perf_counter()
    c3_op_phase(torch, F, nn_ops, dev)
    c3_model_phase(torch, np, mt, nn_ops, vision, loss_mod, Trainer, dev)
    resnet_train_phase(torch, np, mt, vision, loss_mod, ShardedTrainer,
                       Trainer, metric, dev)
    say("resnet train", phase_11_seconds=f"{time.perf_counter() - t11:.3f}")

    kernels = []
    for variant, rung in (("f32", "pallas"), ("int8", "int8")):
        r = kres[variant]
        kernels.append({
            "name": f"decode_attention_{variant}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": served[rung]["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for name in fa.KERNELS:
        r = fres[name]
        kernels.append({
            "name": f"flash_{name}", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES[name],
            "launches": train_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for label, res in dres.items():  # launches: phase 7b's kernel route
        for name in fa.KERNELS:
            r = res[name]
            kernels.append({
                "name": f"flash_{name}_{label}", "route": "cuda",
                "source": FLASH_SOURCE, "replaces": FLASH_REPLACES[name],
                "launches": amp_launches[label][name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # BERT's attention shape; launches: bf16 over 10b's kernel route, f32
    # the forward over 10a's served run and dq, dk/dv over 10b's f32 run
    bert_launches = {"bf16": bert_amp["bf16"],
                     "f32": dict(bert_f32["f32"], fwd=bert_served["fwd"])}
    for label, res in bres.items():
        for name in fa.KERNELS:
            r = res[name]
            kernels.append({
                "name": f"flash_{name}_bert_{label}", "route": "cuda",
                "source": FLASH_SOURCE, "replaces": FLASH_REPLACES[name],
                "launches": bert_launches[label][name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the int8 products of one forward at the rows phase 5's int8 serve run
    # launched each kernel at (decode rows M = 4, the 225 of a forward: the
    # decode kernel; prefill rows M = 1024, the 224 of the layers: the
    # wgmma kernel), the whole call (the row quantization, the product, the
    # split's sum): phase 3b's sums over the shapes; launches: that run's,
    # by kernel and rows. Phase 3b prints the other rows' times.
    for (route, m), launches in sorted(served["int8"]["int8_rows"].items()):
        check(m in ires, f"phase 5 launched the {route} kernel at M = {m}, "
              "which phase 3b does not time")
        r = ires[m]
        label = f"decode_m{m}" if route == "decode" else f"wgmma_prefill_m{m}"
        kernels.append({
            "name": f"int8_dense_{label}", "route": "cuda",
            "source": INT8_SOURCE, "replaces": INT8_REPLACES,
            "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the strict rung's kernels at the rows serve baseline ran them (S1 at
    # decode rows M = 4 and prefill rows M = 1024, S2 at T = 1 and 256, S3
    # at 4 and 1024 rows): phase 3c's times over one forward; launches:
    # that phase's single-step generate, by kernel and rows
    for name, r in sres.items():
        kernels.append({
            "name": name, "route": "cuda", "source": STABLE_SOURCE,
            "replaces": STABLE_REPLACES[r["kernel"]],
            "launches": stable_rows.get((r["kernel"], r["rows"]), 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        check(kernels[-1]["launches"] > 0, f"serve baseline never launched "
              f"{name}")
    for name in ("bf16", "f32"):
        r = pres[name]
        kernels.append({
            "name": f"conv1x1_pair_{name}", "route": "cuda",
            "source": PAIR_SOURCE, "replaces": PAIR_REPLACES,
            "launches": pair_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for row in kernels:
        check(row["library_ms"] is None
              or row["library_ms"] >= row["bound_ms"],
              f"{row['name']}: the library's {row['library_ms']} ms beats "
              f"the bound {row['bound_ms']} ms")
    print(json.dumps({"kernels": kernels}), flush=True)
    say("done", seconds=f"{time.perf_counter() - t_start:.3f}")
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
