#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--report PATH]

Phases, each fatal on failure (no phase's failure is caught):

1. print the card's name and power limit; build the CUDA kernels from
   ``mxnet_tpu_torch/ops/cuda/csrc`` with nvcc (sm_90a), timed, and
   print each kernel's registers and spilled bytes (``-Xptxas -v``);
2. hold each serving kernel route against its plain PyTorch version on
   the card, float32 and bfloat16: decode at the serving widths (1-8
   rows, 4 kv heads x group 4, head_dim 64, 16-token pages) and one batch
   of lengths 0, 1, 15, 16, 17 and 256 at group 1, 2, 4 and 8 and head
   dims 32, 64 and 128 (the "cluster" route; a row of length 0 must give
   zeros, the kernels' result, where the plain version averages V), 3
   kv heads with 8-token pages, and head dims 12 / 6 (the "serial"
   route); a second decode call bitwise equal to the first; prefill at
   buckets 16-256 over 4 kv heads and over kv_heads = n_heads, group 8
   and 16, head dims 32 and 128, and ragged cases (3 kv heads, a tail q
   tile), bfloat16 on the "mma" route and float32 on "fma"; the
   prefill kernel's pages must equal the plain version's bitwise (page
   0 excepted); every launch's route is read from the route counts;
3. time each kernel (CUDA events, L2 flushed and a 0.5 ms device-side
   hold before every launch) on its redesigned route and on its first
   design (the old route, in turns new, old, old, new) beside its bound,
   its plain version and one PyTorch library call
   (scaled_dot_product_attention) that computes the same function, and
   the host microseconds of a wrapper call on each route;
4. serve 16 requests of the decode_serve mix through
   ``serve.DecodeEngine`` at the full width of the repo's decode config
   (vocab 32768, d_model 1024, 16 heads / 4 kv heads, 12 layers, d_ff
   4096, RoPE, bf16, seeded weights), and check every session's token
   count, that the kernels ran 12 times per prefill and per step, and
   that every launch took the redesigned route ("cluster", "mma");
   then the same requests once more under torch.profiler for the
   device's busy share and device time by kernel class;
5. hold the whole path on the card against the port on the CPU in
   float32 (one 128-token prompt, prefill + 8 decode steps);
6. hold the training kernels, ``flash_attention`` (o, lse) and
   ``flash_attention_bwd`` (dq, dk, dv), against their plain versions
   by relative RMS error per (batch, head) slice: the train path's
   shape (8, 16, 1024, 64), a small head_dim-32 shape and three tails
   (s = 200 with one head and with b * heads = 6, s = 40), causal and
   full, f32 and bf16; at the train shape in bf16 run both kernels a
   second time and require all five outputs bitwise equal (the
   backward is deterministic); then show that two planted faults (a
   dropped key tile, a shifted lse) fail;
7. time both at the train path's shape (bf16, causal), L2 flushed,
   beside their bound, plain version and scaled_dot_product_attention
   (its backward through torch.autograd.grad): the ratio to it, the
   TFLOP/s of both, the share of the bound;
8. train the repo's transformer LM config at full width
   (benchmark.py's train_transformer_lm: vocab 32768, d_model 1024, 16
   heads, 12 layers, d_ff 4096, learned positions, bf16, 185.6M
   parameters, batch 8 x seq 1024, SGD lr 0.01, 8 steps a call): one
   warm and two timed calls, finite loss, weights changed, 12 + 12 flash
   launches per step; tokens/s, ms/step, MFU; one profiled step;
9. the train step on the card against the port on the CPU in float32
   (full width, 2 layers, batch 2, seq 256, 2 steps): losses and every
   weight;
10. the train path in bf16 at its width (2 layers, batch 8 x seq 1024):
    loss and every weight's gradient with attention through the kernels
    against the plain attention route (``impl="einsum"``) on the card,
    and a planted fault (lse rounded to bf16) that must fail;
11. hold the fused optimizer update kernel (``sgd_fused_update``,
    ``adam_fused_update``: one launch over a whole parameter list)
    against its plain versions, bitwise, over all 157 ResNet-50
    parameter shapes: SGD with momentum, stateless, with clip; Adam at
    steps 1 and 7; per-tensor lr and wd; then a planted fault (the hyper
    table shifted by one tensor) that must fail;
12. time both over the ResNet-50 parameter list beside their bound,
    plain version and ``torch._fused_sgd_`` / ``torch._fused_adam_``;
13. train ResNet-50 through ``Module.fit`` with the arguments
    ``examples/common/fit.py`` passes for ``--network resnet
    --num-layers 50 --benchmark 1`` (batch 32 of float32 3x224x224, SGD
    lr 0.1 momentum 0.9 wd 1e-4, MultiFactorScheduler, Xavier, TF32
    off): a warm epoch and a timed epoch of 24 batches each, finite
    loss, weights and moving statistics changed, ``sgd_fused_update``
    launched once a step and its plain version never; img/s, ms/step,
    MFU; the same fit with ``--optimizer adam`` for 4 batches
    (``adam_fused_update`` once a step); one profiled step;
14. two chained ResNet-50 steps (batch 2) on the card, on the CPU in
    float32 and on the CPU in float64 (the witness): the card's errors
    against the witness (outputs, each weight's and moving statistic's
    change) held to the CPU float32's own, and a planted BatchNorm
    gradient fault that must fail;
15. hold the int8 kernels of quantized serving (``int8_matmul``,
    ``int8_conv_im2col``) against their plain versions, bitwise, each
    on the route (wgmma or mma.sync) its wrapper's route function picks,
    asserted from the per-route launch counts: the matmul at small
    ragged shapes (zero-scale channels among them), a large m, a
    misaligned x and ResNet-50's FC (m 1, 8, 32 x 2048 x 1000; the
    split-K FC twice, bitwise equal), the convolution at every distinct
    conv shape of ResNet-50 at batch 1 and 32, groups 2 and 32, a
    dilated case and odd H/W tails, each with channels-last and with
    contiguous operands; then planted faults that must fail (the scale
    table shifted by one channel, the last 32-deep K chunk dropped, one
    K slice of the split-K FC dropped, one tap of a 3x3 conv zeroed);
    and the inference BatchNorm kernel
    (``batch_norm_inference``) bitwise at every distinct BatchNorm shape
    of ResNet-50 at batch 1 and 32 and at ragged and misaligned inputs,
    with two planted faults (the mean shifted by one channel, eps
    dropped) that must fail;
16. time the three at the batch-32 shapes (CUDA events, L2 flushed): the
    conv per distinct shape (channels-last operands, as serving gives
    them; the route each takes) and summed over a forward's 53 convs,
    the FC, the BatchNorm per shape and summed over a forward's 51;
    beside each its bound (int8 operations over 1979 TOP/s, bytes over
    3.35 TB/s) and share of it, its plain version, the first design
    (the mma.sync route) and, for the matmul, ``torch._int_mm``, for
    the BatchNorm ``F.batch_norm`` (no PyTorch call computes an int8
    conv on the card: its library_ms is null; ``torch._int_mm`` over
    prebuilt patch matrices is reported beside it); the host
    microseconds of a wrapper call on each route;
17. serve ResNet-50 in int8 at full width (benchmark.py's
    infer_quantized / quantized_serve route): seeded Xavier weights ->
    ``model.save_checkpoint`` -> ``quantize.quantize_checkpoint`` (naive
    calibration over one seeded batch of 32) -> ``QuantizedParams.load``
    -> ``serving.Predictor`` on the card -> ``serve.InferenceEngine``
    (max_batch 32, batch_wait 2 ms), warmed, and the fp32 Predictor of
    the checkpoint under its own engine; a correctness set of 64
    one-image requests from 16 client threads and 4 requests of 4 rows
    to each: every request answered, 53 ``int8_conv_im2col`` + 1
    ``int8_matmul`` (fp32: none) and 51 ``batch_norm_inference``
    launches per executed batch, the FC and 52 convs on the wgmma route
    and the stem on mma.sync with no operand copied to another memory
    format, repeats of an image bitwise equal
    (int8); then four timed closed-loop windows of 6 s (int8, fp32,
    fp32, int8; 16 clients of one-image requests, the same launch
    checks): img/s and p50/p99 latency; the int8-vs-fp32 drift; one
    profiled batch-32 int8 forward (device ms by class, busy share, the
    conv's share), and its input's upload timed alone;
18. the int8 artifact on the card against the port on the CPU at batch
    2: each of the 54 quantized layers bitwise given the card's input
    to it, the whole forward within 1e-3 relative RMS, the share of
    int8 activations that flipped;
19. ``rtc``: compile CUDA C at run time through ``rtc.CudaModule``
    (NVRTC, sm_90a), each source timed cold and then cached; hold every
    runtime kernel against its PyTorch expression on the card (doubler,
    addone, a template ``scale_t`` through ``exports``: bitwise; axpy
    within 2 ulps, for FMA contraction; a row sum over 64 KB of dynamic
    shared memory within 2e-6 of the sum of |x|); launch from a second
    thread (and show that a driver launch there without the primary
    context fails); a compile error (NVRTC's log in the message), a
    float64 array for ``float *``, a written array aliasing a ``const``
    one, CPU arrays and a 2048-thread block must raise ``MXNetError``;
    a planted fault (the kernel's bound drops the last element) must
    fail;
20. time ``axpy`` at 2^26 float32 elements (L2 flushed) beside its byte
    bound (12 B an element over 3.35 TB/s), ``y += a * x`` (plain) and
    ``y.add_(x, alpha=a)`` (library), and the host time of a ``launch``
    of a one-element kernel against a one-element PyTorch op;
21. the ``scaled_square`` custom op with rtc kernels for its forward and
    backward: ``nd.Custom`` under ``autograd.record()`` and ``backward``
    on a 32x256x56x56 float32 activation, output and ``x.grad`` equal
    to the PyTorch expression bitwise, in exactly 2 rtc launches;
22. train ``gluon.model_zoo.vision.get_model("resnet50_v1",
    classes=1000)`` at batch 32 of float32 3x224x224 (TF32 off) with
    ``SoftmaxCrossEntropyLoss`` and ``Trainer("sgd", lr 0.1, momentum
    0.9, wd 1e-4)``, eager and hybridized in the same call (two nets
    from one seeded state; the hybridized one runs its traced Symbol as
    CUDA graphs): the hybridized first step's logits and loss within
    1e-5 of the eager step's, 8 warm steps each, then four timed windows
    of 24 steps (eager, hybridized, hybridized, eager), finite loss,
    ``sgd_fused_update`` once a ``trainer.step`` in both modes and its
    plain version never; the hybridized net's moving statistics updated
    once a step, one step's update equal to a host-side replay of the
    momentum rule over that step's batch statistics; 4 Adam steps
    (``adam_fused_update`` once each); img/s, ms/step, MFU over the zoo
    net's own conv and FC FLOPs, the ratio to phase 13's img/s; one
    profiled step of each mode (kernels, busy share, host launches);
23. two chained Gluon ``trainer.step``s of resnet50_v1 at batch 2 on the
    card (f32) eager and hybridized, the CPU (f32) and the CPU in
    float64 (the witness), held by phase 14's ratio rule, and a planted
    BatchNorm fault (gamma's gradient doubled), eager and hybridized,
    that must fail it;
24. the data path: write ``build/smoke_data/train.rec`` / ``.idx`` through
    ``recordio.pack_img`` (768 seeded images as ``tools/im2rec.py
    --resize 256`` leaves ImageNet: short side 256, long side 256-384,
    JPEG quality 95, labels 0-999), its size and write time; the decoder
    backend must be ``nvjpeg``; 64 records through ``ImageIter`` on the
    native route (nvJPEG + ``crop_mirror_normalize``) against the python
    route (cv2 + Augmenters), center crop: within DECODE_LEVEL_TOL /
    DECODE_MEAN_TOL uint8 levels (the inverse DCTs' rounding), and a
    planted fault (the mean shifted one channel) must fail; the kernel
    at a batch of 32 (random crop and mirror) bitwise equal to its plain
    version on the card and on the CPU, a planted fault failing, timed
    beside its bound and plain version; ``ImageRecordIter`` alone (batch
    32, random crop and mirror, staged onto the card) in img/s at 4 and
    ``nproc`` decode threads; one batch's upload from pageable and from
    pinned memory; staged batches (python route through the pinned ring,
    native route) bitwise equal to synchronous copies of the same
    records; then ``build/smoke_data/domain.rec``, 256 seeded JPEGs at
    original sizes (short side 60-500, a tenth below 224) in six chroma
    subsamplings: the kernel bitwise equal to its plain version at
    resize 0, 256 and 160 (below the crop: two launches) and one
    channel, and on random planes of every kind (4:1:0 included) with a
    downscale past the dense window; two planted faults (a cubic
    coefficient off by one, the vertical pass in integers) must fail;
    the native route against the python route at resize 256 within
    RESIZE_LEVEL_TOL / RESIZE_MEAN_TOL; the kernel timed at resize 256
    beside its bound (a call's CUDA event time, as every row of the
    kernels line, and the kernel's profiler device time beside it);
25. the north-star CLI in-process, ``train_imagenet.main([... "--benchmark",
    "1", "--max-batches", "48", ...])``: img/s from its Speedometer
    lines against phase 13's, ``sgd_fused_update`` once a step and its
    plain version never, no input copied by the executor;
26. the CLI on the records with ``--model-prefix`` (2 epochs of 24
    batches, random crop and mirror): every batch on the native route
    (nvjpeg, one ``crop_mirror_normalize`` launch a batch), on the card
    when it reaches ``Module.fit`` (the executor copies no input), 48
    update launches, finite loss, epoch 2's img/s; the manifests verify;
    ``Module.load(prefix, 2, load_optimizer_states=True)`` equals the
    trained module bitwise (parameters and optimizer states); a profiled
    window of 8 real-data steps (the device's busy share); then
    ``--load-epoch 1``: its parameters equal checkpoint 1's bitwise and
    the resumed epoch's loss is finite;
27. ``export`` phase 22's trained net (``-symbol.json``, ``-0000.params``)
    and serve the files: ``SymbolBlock.imports`` on the card, hybridized,
    at batch 32, within 1e-5 of the Gluon net's eager predict, and
    ``model.load_checkpoint`` + ``serving.Predictor`` within 1e-5 of it;
    ``batch_norm_inference`` once per BatchNorm node (53) a forward, by
    its counter with the replays counted, its plain version never; eager
    predict against the imported block's graph replay (img/s, host
    microseconds a forward; turns eager, imported, imported, eager); a
    planted fault (one exported moving variance doubled) must fail;
28. the CLI's other networks at full width: ``train_imagenet.main``
    with ``--network alexnet``, ``vgg --num-layers 16``, ``mobilenet``
    and ``inception-bn`` (``--benchmark 1``, batch 32 of 3x224x224, 1000
    classes, 32 batches each): ``sgd_fused_update`` once a step and its
    plain version never, no executor copy, finite outputs; img/s from
    the Speedometer lines, ms/step and MFU over each network's conv and
    FC FLOPs (TF32 off); a timed batch-32 ``Module.predict`` window;
    BASELINE.md's 1x V100 figure beside them as published context; one
    profiled step each (busy share, device ms by class). Then
    per network one SGD step at batch 2 on the card and on the CPU
    against the CPU's float64 witness, phase 14's step-1 rule with a
    floor of 1e-5 under its ratio (AlexNet
    and VGG with Dropout's p set to 0 through their JSON), with a
    planted fault (AlexNet: LRN without 1 / nsize; MobileNet and
    Inception-BN: phase 14's BatchNorm fault) that must fail; and
    Dropout at p = 0.5 on the card: the kept share within 4 sigma,
    kept values exactly x / (1 - p), the backward's mask the forward's,
    new masks each draw and each executor step, the same after a
    re-seed, and a planted fault (no 1 / (1 - p)) that must fail;
29. every op of the port's core op files (but ``RNN``, phase 37's) on
    the card against the same op on the CPU
    (``tests/torch_op_cases.py``'s inputs, three shapes each): forward
    and gradient, integer outputs bitwise, float within 2e-5 (gradients
    1e-4) of the largest magnitude; integer reductions, argmax /
    argsort / topk over ties, bitwise with their types;
30. Inception v3 from the Gluon model zoo trained as ``benchmark.py``'s
    ``train_inception`` does (traced to a Symbol under ``SoftmaxOutput``,
    ``Module.fit`` at batch 32 of float32 3x299x299, SGD lr 0.05
    momentum 0.9, a warm and a timed epoch of 24 batches):
    ``sgd_fused_update`` once a step and its plain version never, no
    executor copy; img/s, ms/step, MFU; one profiled step; the V100's
    published 214.48 img/s as context;
31. MobileNet-1.0 through Gluon as phase 22 trains ResNet-50 (eager and
    hybridized from one state, batch 32 at 224, ``Trainer("sgd")``): the
    hybridized first step within 1e-5 of eager's, windows eager,
    hybridized, hybridized, eager, ``sgd_fused_update`` once a
    ``trainer.step``; host launches and busy share of a profiled step;
32. the zoo scored on the card: alexnet, vgg16, vgg16_bn, squeezenet1.0
    and 1.1, densenet121, inceptionv3 (299), mobilenet1.0 and
    mobilenetv2_1.0 hybridized at batch 32: img/s and MFU over a window
    of forwards; ``batch_norm_inference`` once per BatchNorm node a
    forward (0 without BatchNorm), replays counted; batch-2 logits within
    1e-4 of the CPU's from the same weights; ``export`` ->
    ``SymbolBlock.imports`` of inceptionv3 and mobilenetv2_1.0 within
    1e-5, and planted faults (Concat order reversed in Inception's
    ``_Mix``; a moving variance doubled) that must fail; the V100's
    published figures beside alexnet, vgg16 and inceptionv3;
33. one SGD step at batch 2 of inceptionv3, mobilenetv2_1.0 and
    densenet121 on the card and the CPU against the CPU's float64
    witness by phase 28's rule (a change zero in exact arithmetic held
    within 1e-5), and a planted BatchNorm fault that must fail (phase
    14's; phase 23's for Inception, whose float32 step hides phase 14's);
34. ``train_mnist.main`` in-process for ``--network mlp`` and ``lenet``
    with the default flags and a seeded shuffle: ``sgd_fused_update``
    once a step, finite outputs, the final validation accuracy above
    chance, img/s;
35. the ``lstm_bucketing`` CLI at reference MXNet's defaults (the PTB
    "small" LM: 2 x 200 LSTM cells unrolled per bucket, 200-wide
    embedding, batch 32, buckets 10..60, PTB's 10 000 words) over a
    seeded corpus file of 4000 sentences, through ``BucketingModule.fit``:
    a warm and a timed epoch, ``sgd_fused_update`` once a step, samples/s,
    tokens/s padded and not, ms/step, MFU over its matmul shapes, the
    perplexity finite and falling, one profiled step of the longest
    bucket; one step at batch 2 against the CPU's float64 witness by
    phase 28's rule, with a planted fault (SliceChannel's outputs
    reversed) that must fail;
36. the Gluon word LM at reference MXNet's defaults (WikiText-2's 33 278
    words: Embedding -> ``gluon.rnn.LSTM(200, 2 layers, dropout 0.2)`` ->
    Dense, bptt 35, batch 32, ``clip_global_norm``, ``Trainer("sgd", lr
    20)``, the hidden state carried and detached), eager and hybridized
    (the ``RNN`` op on cuDNN inside the replayed CUDA graphs): the
    hybridized first step (Dropout off) within 1e-5 of eager's, windows
    eager, hybridized, hybridized, eager: tokens/s, MFU,
    ``sgd_fused_update`` once a step; host launches, busy share and
    cuDNN RNN time of a profiled step;
37. the ``RNN`` op on the card against the CPU (its four modes, uni- and
    bidirectional, LSTMP; outputs, states, gradients) and ``CTCLoss``
    (both blank labels, with and without lengths; loss and gradient); a
    planted i/f gate swap must fail;
38. both routes of the flash kernels over the TPU kernel's whole domain
    (k and v of their own length s_k, head dims up to 256, float32 and
    bf16): "wgmma" (bf16 at head_dim 32 / 64 / 128, any s_q and s_k) and
    "fma" (float32, other head dims), against the plain versions by
    phase 6's limits, causal and full, each launch on the route
    ``flash_route`` names, a second run bitwise equal; planted faults
    that must fail on each route (a key tile hidden; at head_dim 128 also
    k's second 64-column box read as zeros); each timed shape beside its
    bound, plain version and causal SDPA (float32 with TF32 off) at the
    same shape (bf16 head_dim 128; bf16 s_q 512 < s_k 1024; the CLI's
    f32 shape; the train path's bf16 head_dim 64);
39. ``_contrib_flash_attention`` on the card (bf16, causal; head_dim 128,
    and s_k twice s_q) through ``nd.contrib``, a bound ``sym.contrib``
    Symbol and a hybridized block (CUDA graphs): output and gradients
    against the plain versions, one launch each a call on the route
    ``flash_route`` names;
40. the ``train_transformer_lm`` CLI in-process at benchmark.py:669's
    widths (d 1024, 16 heads, 12 layers, d_ff 4096, vocab 32768, seq
    1024, batch 8) in float32, dense and with ``--num-experts 8``, each
    with ``--generate 32``: its printed lines, the loss falling, 12 + 12
    flash launches a step on the fma route;
41. the bf16 train step at the same widths as MoE (8 experts, top-2),
    dense with ``remat=True`` and dense: tokens/s, MFU (6 N_active + 12
    L d s / 2 a token; N_active counts a token's two experts), peak
    memory, flash launches a step, a profiled step; remat's loss and
    gradients against no remat's from the same weights and batch;
42. ``transformer_generate`` at benchmark.py:736's decode config (bf16,
    GQA 16/4, RoPE, 12 layers, batch 8, prompt 32, 128 steps):
    generated tokens/s, a profiled call; at 2 layers in float32 the
    dense cache's greedy tokens on the card equal the CPU's and the
    paged ``DecodeEngine``'s;
43. the same config with 8 experts through ``DecodeEngine``, 16
    requests of phase 4's mix: the paged kernels launched once a layer
    per prefill and step on their redesigned routes, tokens/s, and the
    requests again profiled;
44. ResNet-50 (1000 classes, 3x224x224) through
    ``parallel.ShardedTrainer.run_steps``, ``benchmark.py``'s
    ``train_resnet`` rows: batch 32 float32 (TF32 off), batch 32, 128 and
    256 bf16, SGD lr 0.05 momentum 0.9; 8 distinct staged batches a call,
    the 8 steps ONE CUDA graph replay (captured once), a capturing call,
    a warm one and 3 timed (synced on the loss and an updated weight):
    img/s, ms/step, MFU over the network's own conv / FC FLOPs (67
    TFLOP/s f32, 989 bf16; above 1.05 an error), peak memory, one
    profiled replay (host launches, busy share, device ms by class);
    phase 13's ``Module.fit`` img/s beside the f32 row as context;
45. ``run_steps`` against 8 eager ``step`` calls from one state
    (ResNet-50 f32 batch 32, deterministic cuDNN): the last loss and
    every parameter and momentum within 1e-5 relative, twice (the second
    over new batches written into the same static stack); a planted
    fault (the stack never written again) must fail;
46. the trainer's update against a float64 replay of the JAX trainer's
    rule over the executor's gradients (the MLP, from nonzero momenta),
    and a bf16 ResNet-50 step's moving statistics against the float32
    update of the same forward's batch statistics (float32, within
    1e-5); planted faults (MXNet's momentum rule, lr inside; the moving
    statistics kept in bf16) must fail;
47. ``benchmark.py``'s ``train_inception`` (the zoo's inceptionv3 traced
    under ``SoftmaxOutput``, batch 32 float32 3x299x299, 4 steps a graph;
    its Dropout draws anew on every replay) and one bf16 step, finite;
    ``train_mlp`` (batch 64, 32 steps a graph): steps/s;
48. ``e2e_train_resnet``: 512 seeded 256x256 noise JPEGs written to
    ``build/smoke_data/e2e.rec``, ``ImageRecordIter`` (nvJPEG route,
    resize 256, random crop and mirror, ``prefetch_buffer=2``) feeding
    ``ShardedTrainer.step`` with its device tensors, bf16 ResNet-50 at
    batch 64: img/s, MFU, one ``crop_mirror_normalize`` launch a decoded
    batch, a profiled window (busy share);
49. ``DataPipeline(RecordBatchSource)`` over that file (batch 128,
    3x224x224, resize 224, random crop and mirror) with 0, 2 and
    ``nproc`` workers, staged on the card: img/s, the first 4 batches
    bitwise equal across the worker counts; then the MLP's
    ``Module.fit`` fed by ``DataPipeline(ArrayBatchSource)`` (2 workers,
    3 epochs of 24 batches of 64): ``sgd_fused_update`` once a step, no
    executor copy;
50. hold every rule of the update kernel (SGD, NAG, signSGD / Signum,
    Adam, AdaGrad, RMSProp plain and centered, AdaDelta, FTRL, FTML,
    Adamax, Test; Adam and FTML at steps 1 and 7) against its plain
    version, bitwise, over all 157 ResNet-50 parameter shapes, on
    float32, bf16 and float16 weights, clip on and off, and the master
    mode (float16 weights, float32 states and master) for SGD, SGD with
    momentum and Adam, one launch a call; then three planted faults that
    must fail (the hypers applied in float32 at bf16, the weight written
    from the pre-update master, FTML's v and z swapped);
51. time bf16 SGD with momentum, master-mode SGD at float16 and each
    other rule at float32 over the ResNet-50 list (L2 flushed) beside its
    bound, plain version, host ms and ``torch._fused_sgd_`` for bf16 SGD
    and (nesterov) NAG;
52. Gluon resnet50_v1 cast to bf16 and hybridized, batch 64 of bf16
    3x224x224, ``Trainer("sgd", lr 0.1, momentum 0.9, wd 1e-4)``: 8 warm
    steps, two timed windows of 24 (img/s, ms/step, MFU over 989 TFLOP/s,
    peak memory), one ``sgd_fused_update`` launch a step over bf16 and
    float32 (BatchNorm) tensors, a profiled step; each other optimizer's
    rule for two steps of that net (one launch a step); the same net in
    float16 with ``multi_precision`` (one window, one master-mode launch
    a step); one bf16 step at batch 2 on the card, on the CPU and in
    float64 (the witness): the card's errors within 1.5x the CPU's own,
    a planted BatchNorm fault that must miss; ``train_imagenet.main``
    with ``--optimizer nag --benchmark 1`` for 16 batches (one
    ``nag_fused_update`` a step);
53. the serving front at full width: ``serve_http`` over one
    ``ModelRegistry`` (phase 17's ResNet-50 fp32 checkpoint, max batch 32,
    batch wait 2 ms) with a ``DecodeEngine`` at phase 4's configuration
    attached: /healthz 503 before the warmups and ``ok`` after; counts 0,
    then phase 4's mix as 16 concurrent streaming /generate requests
    (every stream complete; tokens/s, TTFT, ITL through HTTP), the
    68-request /predict set from 16 threads (scaled images whose answers
    are spread and apart: within 1e-5 of the direct predictor), and under closed-loop traffic from 2 clients the int8
    canary (``enable_shadow`` at 0.25), ``swap(quantized=)`` (the 16
    images' int8 answers bitwise phase 17's) and the rollback, no request
    failed; counts read: the paged kernels once a layer a prefill and a
    step, the int8 kernels 53 + 1 a forward of the int8 engines, BatchNorm
    51 a forward (batches and the three engines' warmups); a client that
    resets mid-stream gives its pages back;
    /metrics parses, every ``serving/mfu`` and ``decode/mfu`` at most
    1.05 and the hand count against the health layer's count under the
    ``mfu_divergence`` rule's 0.20; /traces holds one trace a request
    with ``serve.*`` nested; /alerts lists the default rules; decode
    tokens/s with trace sampling 1.0 and 0.0 in turns;
54. faults and health: ``serve.worker`` and ``decode.step`` armed once
    each on that server (the serve worker restarts and
    ``worker_restart_burn`` fires on ``evaluate_once``; the decode
    session in flight fails with 500 and the scheduler restarts; the
    next requests complete); a NaN batch trips the numerics sentinel in
    a ResNet-50 ``Module.fit`` (policy raise); phase 13's step with the
    sentinel off / step / full, the flight recorder on and "off" again
    (min of alternated rounds): the step mode held to the 2% budget above
    twice the noise floor; a ``DataPipeline``-fed fit
    whose traces hold ``train.data_wait`` and ``io.*`` spans;
55. print a ``kernels`` JSON line (the ``rtc`` entry's times from phase
    20, its launches from phase 21; the flash kernels' fma-route rows'
    times from phase 38, their launches from phases 39 and 40;
    ``crop_mirror_normalize``'s times from phase 24, its launches from
    phases 26 and 48; ``sgd_fused_update``'s
    launches from phase 22's first hybridized window, phase 28's four CLI
    runs, phase 30's fit, phase 31's first hybridized window, phase 34's
    runs, phase 35's fit, phase 36's first hybridized window and phase
    49's fit and phase 54's steps; ``batch_norm_inference``'s from phase
    27's and phase 32's windows and phase 53; the paged and int8 kernels'
    from phases 4 and 17 and phase 53; phase 51's rows with their
    launches from phase 52), the card line, and last ``{"ok": true,
    "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or without
the package beside it. ``--report PATH`` also writes every measurement
(all shapes, the profile's top kernels) to PATH as JSON.
"""
import argparse
import copy
import functools
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

# full-precision float32 matmuls/convolutions wherever f32 is compared
F32_TOL = 2e-5          # kernel vs plain version, both float32
BF16_TOL = 1e-2         # bf16 output rounding (2^-8 rel.) of values <~3
PATH_TOL = 2e-3         # card vs CPU logits, f32, 12 layers summed
                        # in different orders (logits ~0.6 in magnitude)
# flash_attention / flash_attention_bwd vs plain: relative RMS error
# ||got - ref|| / ||ref|| of each (batch, head) slice, the largest slice's
# (rel_err; the gradients sum up to 1024 terms that cancel, so an
# elementwise relative bound means nothing). The plain backward is fed
# the plain o (in the inputs' dtype) and the plain lse, never the
# kernel's. Phase 6 plants faults to show these limits catch them.
FA_F32_TOL = 1e-5       # o, dq, dk, dv, both float32: sums in other
                        # orders
FA_BF16_TOL = 1e-2      # o, dq, dk, dv: bf16 inputs, the plain version in
                        # f32 on the same inputs. One bf16 rounding has a
                        # relative RMS error of 1.7e-3; the kernel rounds
                        # p (ds in the backward) for the tensor cores and
                        # its output, so a sound kernel reads a few 1e-3
FA_LSE_TOL = 1e-5       # lse, both dtypes: f32 sums of exact products of
                        # the same inputs in another order
TRAIN_LOSS_TOL = 1e-4   # card vs CPU train step, f32: loss ~10.4
TRAIN_PARAM_TOL = 1e-5  # and every weight after 2 SGD steps (|w| ~0.02,
                        # updates lr * g with lr 0.01)
TRAIN_BF16_GRAD_TOL = 2e-2  # bf16 train gradients, kernels vs the plain
                        # attention route: relative RMS error per weight.
                        # Once the routes' roundings inside attention
                        # differ, every later bf16 rounding differs too:
                        # sound runs read up to ~9e-3, so this catches
                        # gross faults only; the kernels themselves are
                        # held per launch at FA_BF16_TOL / FA_LSE_TOL
HBM_BPS = 3.35e12       # H100 SXM device memory
PTXAS = {}              # nvcc's output of each library this run built
BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


class Timer(object):
    """Mean device time of ``fn`` over ``iters`` launches, each after a
    256 MB write that evicts the 50 MB L2 and keeps the card busy
    while the host enqueues the launch. ``hold_ms`` adds a device-side
    wait of that long after the write, for calls whose host side takes
    longer than the write (the start event is then recorded with the
    launch already queued)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, iters=30, hold_ms=0.0):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            if hold_ms:
                torch.cuda._sleep(int(hold_ms * 2e6))   # ~2 GHz clock
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


def kernel_device_ms(torch, timer, fn, match, iters=20, evict=None):
    """Device time of the kernels named ``match`` that one call of ``fn``
    launches (all of them summed), from torch.profiler over ``iters``
    calls, each after ``evict()`` (by default the timer's L2-evicting
    write): the wrapper's host work and its copies stay out."""
    from torch.profiler import ProfilerActivity, profile
    if evict is None:
        evict = timer.flush.zero_
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            evict()
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.end - ev.time_range.start for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and match in ev.name)
    return us / iters / 1e3


def kernel_label(mangled):
    """``flash_fwd_bf16_kernel<64>`` (or ``dq_fma_kernel<float, 64, 32,
    2, 2>``) from a mangled entry name: the last length-prefixed
    identifier that ends in ``kernel``, and its template arguments
    (integers, float, bf16) if it has them."""
    best = None
    for i in range(len(mangled)):
        for j in range(i + 1, min(i + 4, len(mangled))):
            if not mangled[i:j].isdigit():
                break
            ident = mangled[j:j + int(mangled[i:j])]
            if (len(ident) == int(mangled[i:j])
                    and re.fullmatch(r"[A-Za-z_]\w*kernel", ident)):
                best = (ident, j + len(ident))
    if best is None:
        return mangled
    args = re.match(r"I((?:f|13__nv_bfloat16|Li\d+E|Lb[01]E)+)E",
                    mangled[best[1]:])
    if not args:
        return best[0]
    return best[0] + "<%s>" % ", ".join(
        "float" if a == "f" else "bf16" if a.startswith("13") else
        ("true" if a == "Lb1E" else "false") if a.startswith("Lb") else
        a[2:-1] for a in re.findall(r"f|13__nv_bfloat16|Li\d+E|Lb[01]E",
                                   args.group(1)))


def ptxas_summary(out):
    """One "name: registers, spills" entry per kernel from nvcc's
    ``-Xptxas -v`` output, and ptxas's C75xx performance warnings."""
    rows, name, spills = [], None, "?"
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_label(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append("%s %s regs %s B spilled" % (name, m.group(1),
                                                     spills))
        m = re.search(r"\((C75\d\d)\)", line)
        if m:
            rows.append("ptxas %s" % m.group(1))
    return rows


def max_err(got, ref):
    return float((got.float() - ref.float()).abs().max())


def within(got, ref, tol):
    got, ref = got.float(), ref.float()
    return bool(((got - ref).abs() <= tol + tol * ref.abs()).all())


# ---------------------------------------------------------------------------
# phase 2/3: kernels
# ---------------------------------------------------------------------------

def decode_inputs(torch, gen, b, lengths, dtype, kvh=4, g=4, hd=64, ps=16,
                  pps=16, num_pages=512):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)
    perm = torch.randperm(num_pages - 1, generator=gen)[:b * pps] + 1
    return (rnd(b, kvh, g, hd), rnd(num_pages, ps, kvh, hd),
            rnd(num_pages, ps, kvh, hd),
            perm.reshape(b, pps).to("cuda", torch.int32),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def prefill_inputs(torch, gen, b, s, nh, kvh, dtype, hd=64, ps=16,
                   num_pages=512):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)
    n_pb = s // ps
    perm = torch.randperm(num_pages - 1, generator=gen)[:b * n_pb] + 1
    return (rnd(b, s, nh, hd), rnd(b, s, kvh, hd), rnd(b, s, kvh, hd),
            rnd(num_pages, ps, kvh, hd), rnd(num_pages, ps, kvh, hd),
            perm.reshape(b, n_pb).to("cuda", torch.int32))


def rel_err(got, ref):
    """Relative RMS error ||got - ref|| / ||ref|| of each (batch, head)
    slice of (b, h, s[, d]) tensors, the largest: a fault confined to
    one slice is not averaged away over the batch."""
    d = (got.float() - ref.float()).flatten(2).flatten(0, 1)
    r = ref.float().flatten(2).flatten(0, 1)
    return float((d.norm(dim=1) / r.norm(dim=1)).max())


def decode_cost(q, block_tables, lengths):
    """(bytes, flops) the call needs: q read and o written once, every
    live key and value (positions < lengths) read once, the index
    tensors read once; 4 * group * head_dim flops per key and kv head."""
    b, kvh, g, hd = q.shape
    keys = int(lengths.sum())
    item = q.element_size()
    nbytes = (2 * q.numel() * item + keys * kvh * hd * 2 * item
              + 4 * (block_tables.numel() + lengths.numel()))
    return nbytes, 4.0 * g * hd * kvh * keys


class forced_route(object):
    """``with forced_route(fa, "decode_route", ("serial", None)):`` makes
    the wrapper take that route whatever the shapes (the first designs
    stay routes of the same libraries, so old and new run in one call)."""

    def __init__(self, fa, fn_name, route):
        self.fa, self.fn_name, self.route = fa, fn_name, route

    def __enter__(self):
        self.saved = getattr(self.fa, self.fn_name)
        route = self.route
        setattr(self.fa, self.fn_name, lambda *a, **k: route)

    def __exit__(self, *exc):
        setattr(self.fa, self.fn_name, self.saved)


def _serve_routed(fa, name, fn):
    """``fn()``'s result and the one route its single launch took."""
    before = dict(fa.ROUTES[name])
    out = fn()
    taken = [r for r, n in fa.ROUTES[name].items() if n != before[r]]
    check(len(taken) == 1 and sum(fa.ROUTES[name].values())
          == sum(before.values()) + 1, "%s: one launch on one route "
          "expected, routes %s -> %s" % (name, before, fa.ROUTES[name]))
    return out, taken[0]


# phase 2's decode cases: (lengths, kv heads, group, head_dim, page
# size, pages a row); lengths 0, 1, a page edge and the whole table in
# one batch; group 1-16; head dims 32-128 (cluster route), 12 and 6
# (serial route, not whole 16-byte segments in bf16 / f32 rows)
DECODE_CHECKS = (
    [([0, 1, 15, 16, 17, 256], 4, g, 64, 16, 16) for g in (1, 2, 4, 8)]
    + [([0, 1, 15, 16, 17, 256], 4, 4, hd, 16, 16) for hd in (32, 128)]
    + [([5, 33, 64, 200], 3, 2, 64, 8, 32),
       ([0, 1, 17, 256], 1, 16, 64, 16, 16)])    # two head blocks
# phase 2's prefill cases: (b, s, n_heads, kv_heads, page size, head_dim)
PREFILL_CHECKS = (
    [(1, s, 16, 4, 16, 64) for s in (16, 32, 64, 128, 256)]
    + [(1, s, 16, 16, 16, 64) for s in (16, 32, 64, 128, 256)]   # kvh = nh
    + [(1, 128, 16, 2, 16, 64), (1, 64, 16, 1, 16, 64),          # group 8, 16
       (1, 64, 8, 2, 16, 32), (1, 64, 8, 2, 16, 128),            # head dims
       (2, 48, 12, 3, 16, 64), (2, 40, 6, 3, 8, 64)])            # ragged


def check_decode_case(torch, fa, gen, dtype, lengths, kvh, g, hd, ps, pps,
                      want):
    """One decode call against the plain version (rows of length 0
    against zeros); returns (max abs err, route, output)."""
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    b = len(lengths)
    q, kp, vp, bt, ln = decode_inputs(torch, gen, b, lengths, dtype, kvh=kvh,
                                      g=g, hd=hd, ps=ps, pps=pps)
    got, route = _serve_routed(fa, "paged_decode_attention",
                               lambda: fa.paged_decode_attention(q, kp, vp,
                                                                 bt, ln))
    torch.cuda.synchronize()
    check(route == want, "paged_decode_attention %s hd=%d took the %s route"
          % (dtype, hd, route))
    # bf16: the plain version in f32 on the same bf16 inputs
    ref = fa._paged_decode_torch(q.float(), kp.float(), vp.float(), bt, ln,
                                 1.0 / hd ** 0.5)
    live = ln > 0
    ref[~live] = 0.0          # the kernels' (and the TPU kernel's) zeros
    check(not got[~live].any(), "paged_decode_attention: a row of length "
          "0 is not zero")
    err = max_err(got, ref)
    check(within(got, ref, tol), "paged_decode_attention %s lengths=%s "
          "kvh=%d g=%d hd=%d: max err %g > tol %g"
          % (dtype, lengths, kvh, g, hd, err, tol))
    return err, route, (q, kp, vp, bt, ln, got)


def check_kernels(torch, fa):
    """Phase 2: every serving kernel route against its plain version on
    the card."""
    gen = torch.Generator().manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for b in (1, 2, 4, 8):
            lengths = [int(x) for x in
                       torch.randint(1, 257, (b,), generator=gen)]
            err, route, _ = check_decode_case(torch, fa, gen, dtype, lengths,
                                              4, 4, 64, 16, 16, "cluster")
            rows.append(("paged_decode_attention", str(dtype),
                         "b=%d %s" % (b, route), lengths, err))
        for lengths, kvh, g, hd, ps, pps in DECODE_CHECKS:
            err, route, args = check_decode_case(
                torch, fa, gen, dtype, lengths, kvh, g, hd, ps, pps,
                "cluster")
            rows.append(("paged_decode_attention", str(dtype),
                         "kvh=%d g=%d hd=%d ps=%d %s" % (kvh, g, hd, ps,
                                                         route),
                         lengths, err))
            if g == 4 and hd == 64:
                # a second call repeats the first bitwise (rank-order
                # combine, no atomics)
                again = fa.paged_decode_attention(*args[:5])
                check(torch.equal(again, args[5]), "paged_decode_attention "
                      "%s: a second call differs from the first" % dtype)
        # the serial route: rows that are not whole 16-byte segments
        hd = 12 if dtype == torch.bfloat16 else 6
        err, route, _ = check_decode_case(
            torch, fa, gen, dtype, [0, 1, 17, 256], 4, 4, hd, 16, 16,
            "serial")
        rows.append(("paged_decode_attention", str(dtype),
                     "hd=%d %s" % (hd, route), None, err))
        for b, s, nh, kvh, ps, hd in PREFILL_CHECKS:
            q, kg, vg, kp, vp, bt = prefill_inputs(torch, gen, b, s, nh,
                                                   kvh, dtype, hd=hd, ps=ps)
            kp_ref, vp_ref = kp.clone(), vp.clone()
            (o, kp, vp), route = _serve_routed(
                fa, "flash_prefill_paged",
                lambda: fa.flash_prefill_paged(q, kg, vg, kp, vp, bt))
            torch.cuda.synchronize()
            want = "mma" if dtype == torch.bfloat16 else "fma"
            check(route == want, "flash_prefill_paged %s took the %s route"
                  % (dtype, route))
            ro, _, _ = fa._flash_prefill_torch(
                q.float(), kg.float(), vg.float(), kp_ref.float(),
                vp_ref.float(), bt)
            fa._flash_prefill_torch(q, kg, vg, kp_ref, vp_ref, bt)
            err = max_err(o, ro)
            rows.append(("flash_prefill_paged", str(dtype),
                         "b=%d s=%d nh=%d kvh=%d ps=%d hd=%d %s"
                         % (b, s, nh, kvh, ps, hd, route), None, err))
            check(within(o, ro, tol), "flash_prefill_paged %s s=%d nh=%d "
                  "kvh=%d hd=%d: max err %g > tol %g"
                  % (dtype, s, nh, kvh, hd, err, tol))
            check(torch.equal(kp[1:], kp_ref[1:])
                  and torch.equal(vp[1:], vp_ref[1:]),
                  "flash_prefill_paged %s s=%d: pages differ from the "
                  "plain version's" % (dtype, s))
    for r in rows:
        log("check %-24s %-15s %-40s max_abs_err=%.3g" % (r[0], r[1], r[2],
                                                          r[4]))
    return rows


def library_decode(torch, q, kp, vp, bt, ln):
    """The decode call's library yardstick: the row's pages gathered,
    then scaled_dot_product_attention with the length mask."""
    import torch.nn.functional as F
    b, kvh, g, hd = q.shape
    kc = kp[bt.long()].reshape(b, -1, kvh, hd).transpose(1, 2)
    vc = vp[bt.long()].reshape(b, -1, kvh, hd).transpose(1, 2)
    L = kc.shape[2]
    mask = (torch.arange(L, device=q.device)[None, :]
            < ln[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q.reshape(b, kvh * g, 1, hd), kc.repeat_interleave(g, 1),
        vc.repeat_interleave(g, 1), attn_mask=mask)


def library_prefill(torch, q, kg, vg, kp, vp, bt):
    """The prefill call's library yardstick: causal
    scaled_dot_product_attention over the expanded K/V, then the page
    scatter."""
    import torch.nn.functional as F
    b, s, nh, hd = q.shape
    kvh, ps = kg.shape[2], kp.shape[1]
    grp = nh // kvh
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), kg.repeat_interleave(grp, 2).transpose(1, 2),
        vg.repeat_interleave(grp, 2).transpose(1, 2), is_causal=True)
    kp[bt.long()] = kg.reshape(b, s // ps, ps, kvh, hd)
    vp[bt.long()] = vg.reshape(b, s // ps, ps, kvh, hd)
    return o.transpose(1, 2)


def prefill_cost(q, kg, bt):
    """(bytes, flops) of a prefill call: q, kg, vg read and o written
    once, the page rows (kg + vg bytes again) written once; QK^T and PV
    over the causal half."""
    b, s, nh, hd = q.shape
    item = q.element_size()
    nbytes = (2 * q.numel() + 4 * kg.numel()) * item + 4 * bt.numel()
    return nbytes, 2.0 * b * nh * hd * s * (s + 1)


def bound_of(nbytes, flops):
    """(bound ms, what bounds it): bf16 operations over 989 TFLOP/s or
    bytes over 3.35 TB/s, the larger."""
    t_b, t_o = nbytes / HBM_BPS, flops / BF16_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


OLD_ROUTES = {"paged_decode_attention": ("decode_route", ("serial", None)),
              "flash_prefill_paged": ("prefill_route", "fma")}


def time_kernels(torch, fa, timer):
    """Phase 3: kernel (its new route) vs its first design (the old
    route, same call) vs bound vs plain vs library, bf16, serving
    shapes; the host microseconds of a wrapper call on each route.
    Returns (json entries of the main-path shapes, full table)."""
    gen = torch.Generator().manual_seed(1)
    bf16 = torch.bfloat16
    table = []
    sdpa_decode = functools.partial(library_decode, torch)
    sdpa_prefill = functools.partial(library_prefill, torch)

    def timed(name, call, plain, library):
        """new, old, old, new in turns (kernel ms at the hold that keeps
        the wrapper's host time off the device clock)"""
        fn_name, old = OLD_ROUTES[name]
        turns = []
        for version in ("new", "old", "old", "new"):
            if version == "new":
                turns.append(timer(call, hold_ms=0.5))
            else:
                with forced_route(fa, fn_name, old):
                    turns.append(timer(call, hold_ms=0.5))
        return {"ms": min(turns[0], turns[3]),
                "old_ms": min(turns[1], turns[2]), "turns_ms": turns,
                "plain_ms": timer(plain), "library_ms": timer(library)}

    for b in (1, 2, 4, 8):
        # serving depths: prompt + generated of the decode_serve mix
        lengths = [int(x) for x in torch.randint(4, 145, (b,),
                                                 generator=gen)]
        args = decode_inputs(torch, gen, b, lengths, bf16)
        q, _, _, bt, ln = args
        bound, bound_by = bound_of(*decode_cost(q, bt, ln))
        got = fa.paged_decode_attention(*args)
        ref = fa._paged_decode_torch(*[a.float() if a.is_floating_point()
                                       else a for a in args], 1.0 / 8.0)
        row = {"name": "paged_decode_attention", "shape": "b=%d" % b,
               "lengths": lengths, "bound_ms": bound, "bound_by": bound_by,
               "max_abs_err": max_err(got, ref)}
        row.update(timed("paged_decode_attention",
                         lambda: fa.paged_decode_attention(*args),
                         lambda: fa._paged_decode_torch(*args, 1.0 / 8.0),
                         lambda: sdpa_decode(*args)))
        if b == 8:
            row["host_us"] = host_us(
                torch, lambda: fa.paged_decode_attention(*args))
            with forced_route(fa, *OLD_ROUTES["paged_decode_attention"]):
                row["old_host_us"] = host_us(
                    torch, lambda: fa.paged_decode_attention(*args))
        table.append(row)
    for s in (16, 32, 64, 128, 256):
        nh, kvh, hd = 16, 4, 64
        args = prefill_inputs(torch, gen, 1, s, nh, kvh, bf16)
        q, kg, vg, kp, vp, bt = args
        bound, bound_by = bound_of(*prefill_cost(q, kg, bt))
        o, _, _ = fa.flash_prefill_paged(*args)
        ro, _, _ = fa._flash_prefill_torch(q.float(), kg.float(), vg.float(),
                                           kp.float(), vp.float(), bt)
        row = {"name": "flash_prefill_paged", "shape": "b=1 s=%d" % s,
               "bound_ms": bound, "bound_by": bound_by,
               "max_abs_err": max_err(o, ro)}
        row.update(timed("flash_prefill_paged",
                         lambda: fa.flash_prefill_paged(*args),
                         lambda: fa._flash_prefill_torch(*args),
                         lambda: sdpa_prefill(*args)))
        if s == 128:
            row["host_us"] = host_us(
                torch, lambda: fa.flash_prefill_paged(*args))
            with forced_route(fa, *OLD_ROUTES["flash_prefill_paged"]):
                row["old_host_us"] = host_us(
                    torch, lambda: fa.flash_prefill_paged(*args))
        table.append(row)
    for r in table:
        log("time %-24s %-10s ms=%.4f old_ms=%.4f plain_ms=%.4f "
            "library_ms=%.4f bound_ms=%.5f (%s) max_abs_err=%.3g%s"
            % (r["name"], r["shape"], r["ms"], r["old_ms"], r["plain_ms"],
               r["library_ms"], r["bound_ms"], r["bound_by"],
               r["max_abs_err"],
               " host_us=%.2f old_host_us=%.2f" % (r["host_us"],
                                                   r["old_host_us"])
               if "host_us" in r else ""))
    # the JSON line carries the main path's busiest shapes: the full
    # 8-slot decode bucket and the 128-token prefill bucket
    main = [r for r in table if r["shape"] in ("b=8", "b=1 s=128")]
    return main, table


# ---------------------------------------------------------------------------
# phases 6/7: the training kernels
# ---------------------------------------------------------------------------

# (b, heads, s, head_dim): the train path's, a small one with head_dim
# 32, and tails: s not a multiple of the 128-row tile (one head, and
# several, where a tile's rows past s would be the next head's rows but
# for the TMA maps' zero fill), s below one tile
FLASH_SHAPES = [(8, 16, 1024, 64), (2, 4, 128, 32), (1, 3, 200, 64),
                (2, 3, 200, 64), (2, 2, 40, 32)]


def attn_inputs(torch, gen, shape, dtype):
    return tuple(torch.randn(*shape, generator=gen).to("cuda", dtype)
                 for _ in range(4))                       # q, k, v, do


FLASH_OUTS = ("o", "lse", "dq", "dk", "dv")


def flash_limits(dtype, torch):
    tol = FA_F32_TOL if dtype == torch.float32 else FA_BF16_TOL
    return {n: FA_LSE_TOL if n == "lse" else tol for n in FLASH_OUTS}


def plain_flash(torch, fa, q, k, v, do, causal, scale):
    """The plain (o, lse, dq, dk, dv) in float32 on the same inputs; the
    backward takes the plain o rounded to the inputs' dtype (what the
    kernel stores) and the plain lse."""
    f = [t.float() for t in (q, k, v, do)]
    ro, rlse = fa._flash_fwd_torch(f[0], f[1], f[2], causal, scale)
    rg = fa._flash_bwd_torch(f[0], f[1], f[2], ro.to(q.dtype).float(), rlse,
                             f[3], causal, scale)
    return (ro, rlse) + tuple(rg)


def planted_faults(torch, fa, q, k, v, do, ref, scale):
    """Phase 6's checks against two planted faults in slice (0, 0) of the
    train path's shape (bf16, causal); each must fail the checks it
    touches. (a) The function with key tile 0 hidden from the last
    64-row q tile, what a kernel that skipped that one tile pair would
    compute (the weakest such fault here: those rows see ~1000 keys):
    o and lse must fail. (b) The plain backward fed an lse off by
    log(16/15), as from a forward that lost a sixteenth of a row's
    weight: dq, dk and dv must fail."""
    n = q.shape[2]
    x = [t[:1, :1].float() for t in (q, k, v, do)]
    want = [t[:1, :1] for t in ref]
    qf, kf, vf = (t.clone().requires_grad_() for t in x[:3])
    keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    keep[n - 64:, :64] = False
    sc = torch.where(keep, qf @ kf.transpose(-1, -2) * scale, fa.NEG_INF)
    lse = torch.logsumexp(sc, -1)
    o = torch.exp(sc - lse[..., None]) @ vf
    dropped = [o.detach(), lse.detach()] + list(
        torch.autograd.grad(o, (qf, kf, vf), x[3]))
    shifted = fa._flash_bwd_torch(
        x[0], x[1], x[2], want[0].to(q.dtype).float(),
        want[1] + float(np.log(16.0 / 15.0)), x[3], True, scale)
    lim = flash_limits(q.dtype, torch)
    res = {}
    for tag, got, names in (("dropped key tile", dropped, ("o", "lse")),
                            ("lse + log(16/15)", shifted,
                             ("dq", "dk", "dv"))):
        errs = {nm: rel_err(g, want[FLASH_OUTS.index(nm)])
                for nm, g in zip(FLASH_OUTS[5 - len(got):], got)}
        res[tag] = errs
        log("planted fault (%s): %s" % (tag, " ".join(
            "%s=%.2e" % kv for kv in errs.items())))
        missed = [nm for nm in names if errs[nm] <= lim[nm]]
        check(not missed, "planted fault (%s) passes the %s check(s): %s"
              % (tag, missed, errs))
    return res


def flash_repeat(torch, fa, q, k, v, do, causal, first):
    """Both kernels once more on the same inputs: each output must equal
    ``first`` (o, lse, dq, dk, dv) bitwise. The backward sums every
    element in a fixed order (no atomics), so a second run differs only
    if that breaks."""
    o, lse = fa._flash_fwd(q, k, v, causal)
    again = (o, lse) + tuple(fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                    causal))
    torch.cuda.synchronize()
    differ = [n for n, a, b in zip(FLASH_OUTS, first, again)
              if not torch.equal(a, b)]
    log("flash repeat %s causal=%d: %s" % (tuple(q.shape), causal,
                                           "bitwise equal" if not differ
                                           else "differ in %s" % differ))
    check(not differ, "flash kernels not deterministic: a second run on "
          "the same inputs differs in %s" % differ)
    return not differ


def check_flash(torch, fa):
    """Phase 6: flash_attention (o, lse) and flash_attention_bwd (dq,
    dk, dv) against their plain versions (plain_flash), causal and full,
    f32 and bf16 (bf16: the plain version in f32 on the same inputs),
    by rel_err; at the train path's shape in bf16 a second run of both
    kernels bitwise equal to the first; then the planted faults there."""
    gen = torch.Generator().manual_seed(2)
    rows, planted, repeats = [], None, []
    for dtype in (torch.float32, torch.bfloat16):
        lim = flash_limits(dtype, torch)
        for shape in FLASH_SHAPES:
            for causal in (True, False):
                q, k, v, do = attn_inputs(torch, gen, shape, dtype)
                scale = 1.0 / shape[3] ** 0.5
                o, lse = fa._flash_fwd(q, k, v, causal)
                dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                    causal)
                torch.cuda.synchronize()
                ref = plain_flash(torch, fa, q, k, v, do, causal, scale)
                errs = {n: rel_err(g, r) for n, g, r in
                        zip(FLASH_OUTS, (o, lse, dq, dk, dv), ref)}
                rows.append({"dtype": str(dtype), "shape": list(shape),
                             "causal": causal, "rel_err": errs,
                             "max_abs_err": max(max_err(g, r) for g, r in
                                                zip((o, dq, dk, dv),
                                                    ref[:1] + ref[2:]))})
                log("check flash_attention(_bwd) %-14s %-18s causal=%d %s"
                    % (dtype, shape, causal, " ".join(
                        "%s=%.2e" % kv for kv in errs.items())))
                bad = {n: e for n, e in errs.items() if e > lim[n]}
                check(not bad, "flash_attention %s %s causal=%s: %s over "
                      "the limits %s" % (dtype, shape, causal, bad, lim))
                if dtype == torch.bfloat16 and shape == FLASH_SHAPES[0]:
                    repeats.append(flash_repeat(torch, fa, q, k, v, do,
                                                causal,
                                                (o, lse, dq, dk, dv)))
                    if causal:
                        planted = planted_faults(torch, fa, q, k, v, do,
                                                 ref, scale)
    return {"rows": rows, "planted": planted, "bitwise_repeat": repeats}


def time_flash(torch, fa, timer):
    """Phase 7: both training kernels at the train path's shape (bf16,
    causal), L2 flushed before every launch, beside their bound, plain
    version and one PyTorch library call (scaled_dot_product_attention;
    its backward through torch.autograd.grad)."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(3)
    shape = FLASH_SHAPES[0]
    b, h, s, d = shape
    q, k, v, do = attn_inputs(torch, gen, shape, torch.bfloat16)
    scale = 1.0 / d ** 0.5
    o, lse = fa._flash_fwd(q, k, v, True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    ro, _, *rg = plain_flash(torch, fa, q, k, v, do, True, scale)
    pairs = b * h * s * (s + 1) // 2     # visible causal (query, key)
    item = q.element_size()
    # forward: q, k, v read, o written, lse (f32) written; QK^T and PV
    fwd_bytes, fwd_flops = 4 * q.numel() * item + 4 * lse.numel(), \
        4.0 * d * pairs
    # backward: q, k, v, o, do and lse read, dq, dk, dv written; the
    # five products (QK^T again, dO V^T, P^T dO, dS^T Q, dS K)
    bwd_bytes, bwd_flops = 8 * q.numel() * item + 4 * lse.numel(), \
        10.0 * d * pairs
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    rows = []
    for name, fn, plain, lib, nbytes, flops, err in (
            ("flash_attention", lambda: fa._flash_fwd(q, k, v, True),
             lambda: fa._flash_fwd_torch(q, k, v, True, scale),
             lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
             fwd_bytes, fwd_flops, max_err(o, ro)),
            ("flash_attention_bwd",
             lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True),
             lambda: fa._flash_bwd_torch(q, k, v, o, lse, do, True, scale),
             lambda: torch.autograd.grad(lo, (lq, lk, lv), do,
                                         retain_graph=True),
             bwd_bytes, bwd_flops,
             max(max_err(a, r) for a, r in zip((dq, dk, dv), rg)))):
        t_bytes, t_flops = nbytes / HBM_BPS, flops / BF16_FLOPS
        rows.append({
            "name": name, "shape": "b=%d h=%d s=%d d=%d causal bf16" % shape,
            "ms": timer(fn), "plain_ms": timer(plain),
            "library_ms": timer(lib), "bound_ms": max(t_bytes, t_flops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "flops": flops, "bytes": nbytes, "max_abs_err": err})
    for r in rows:
        r["tflops"] = r["flops"] / (r["ms"] * 1e-3) / 1e12
        r["library_tflops"] = r["flops"] / (r["library_ms"] * 1e-3) / 1e12
        r["vs_library"] = r["ms"] / r["library_ms"]
        r["of_bound"] = r["bound_ms"] / r["ms"]
        log("time %-20s %s ms=%.4f plain_ms=%.4f library_ms=%.4f "
            "(kernel/SDPA %.2fx) bound_ms=%.4f (%s; %.0f%% of it) "
            "%.1f TFLOP/s (SDPA %.1f) max_abs_err=%.3g"
            % (r["name"], r["shape"], r["ms"], r["plain_ms"],
               r["library_ms"], r["vs_library"], r["bound_ms"],
               r["bound_by"], 100 * r["of_bound"], r["tflops"],
               r["library_tflops"], r["max_abs_err"]))
    return rows


# ---------------------------------------------------------------------------
# phase 4: serve at full width
# ---------------------------------------------------------------------------

FULL = dict(vocab_size=32768, d_model=1024, n_heads=16, n_kv_heads=4,
            n_layers=12, d_ff=4096, max_len=256, pos_type="rope")


def decode_mix(vocab):
    """Phase 4's 16 requests: benchmark.py decode_serve's mix."""
    rng = np.random.RandomState(0)
    reqs = []
    for _ in range(16):
        if rng.rand() < 0.5:
            plen, mnew = rng.randint(4, 24), rng.randint(32, 64)
        else:
            plen, mnew = rng.randint(48, 128), rng.randint(4, 16)
        reqs.append((list(rng.randint(0, vocab, (plen,))), int(mnew)))
    return reqs


def serve(torch, fa):
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.parallel.transformer import (
        TransformerConfig, init_transformer_params_np)
    from mxnet_tpu_torch.serve import DecodeConfig, DecodeEngine

    cfg = TransformerConfig(dtype=torch.bfloat16, **FULL)
    t0 = time.time()
    params = init_transformer_params_np(cfg, seed=0)        # cuda:0
    log("serve: weights %.1fs (%.1fM params)"
        % (time.time() - t0, sum(p.numel() for p in params.parameters())
           / 1e6))
    eng = DecodeEngine(params, cfg, DecodeConfig()).start()
    try:
        t0 = time.time()
        eng.warmup()
        log("serve: warmup %.1fs (prefill buckets %s, slot buckets %s)"
            % (time.time() - t0, eng.config.prefill_buckets,
               eng.config.slot_buckets))
        reqs = decode_mix(cfg.vocab_size)

        def hist_count(name):
            return telemetry.snapshot().get(name, {"count": 0})["count"]

        n_pre0 = hist_count("decode/prefill_seconds")
        n_step0 = hist_count("decode/step_seconds")
        fa.reset_launches()
        t_start = telemetry.monotonic()
        sessions = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
        outs = [s.result() for s in sessions]
        wall = telemetry.monotonic() - t_start
        launches = dict(fa.LAUNCHES)
        routes = {k: dict(v) for k, v in fa.ROUTES.items()}
        n_pre = hist_count("decode/prefill_seconds") - n_pre0
        n_step = hist_count("decode/step_seconds") - n_step0
        step = telemetry.snapshot()["decode/step_seconds"]
        n_step1 = hist_count("decode/step_seconds")
        prof = profile_round(torch, eng, reqs)
        prof["decode_steps"] = hist_count("decode/step_seconds") - n_step1
        prof["kernels_per_step"] = prof["kernels"] / max(
            1, prof["decode_steps"])
    finally:
        eng.close(drain=False)
    for (p, m), out in zip(reqs, outs):
        check(len(out) == m, "session produced %d tokens, expected %d"
              % (len(out), m))
        check(all(0 <= t < cfg.vocab_size for t in out),
              "token outside the vocabulary")
    check(n_pre == len(reqs), "%d prefills for %d requests"
          % (n_pre, len(reqs)))
    serving = ("paged_decode_attention", "flash_prefill_paged")
    check(n_step > 0 and min(launches[k] for k in serving) > 0,
          "a kernel of the path was never launched: %s" % launches)
    check(all(n == 0 for k, n in launches.items() if k not in serving),
          "serving launched a training kernel: %s" % launches)
    check(launches["flash_prefill_paged"] == cfg.n_layers * n_pre,
          "flash_prefill_paged launched %d times for %d prefills x %d "
          "layers" % (launches["flash_prefill_paged"], n_pre,
                      cfg.n_layers))
    check(launches["paged_decode_attention"] == cfg.n_layers * n_step,
          "paged_decode_attention launched %d times for %d steps x %d "
          "layers" % (launches["paged_decode_attention"], n_step,
                      cfg.n_layers))
    # every serving launch on the redesigned routes
    check(routes["paged_decode_attention"]["cluster"]
          == launches["paged_decode_attention"]
          and routes["flash_prefill_paged"]["mma"]
          == launches["flash_prefill_paged"],
          "a serving launch took a first-design route: %s" % routes)
    tokens = sum(len(o) for o in outs)
    ttft = [s.t_first - t_start for s in sessions]
    itl = [(s.t_done - s.t_first) / (len(o) - 1)
           for s, o in zip(sessions, outs) if len(o) > 1]
    res = {"requests": len(reqs), "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
           "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3,
           "itl_p50_ms": float(np.percentile(itl, 50)) * 1e3,
           "prefills": n_pre, "decode_steps": n_step,
           "step_mean_ms": step["sum"] / max(1, step["count"]) * 1e3,
           "short_requests": sum(1 for p, _ in reqs if len(p) < 24),
           "launches": launches, "routes": routes, "profiled_round": prof}
    log("serve: %d requests, %d tokens in %.3fs: %.1f tokens/s, TTFT "
        "p50 %.1f ms p99 %.1f ms, ITL p50 %.2f ms, step mean %.2f ms; "
        "%d prefills, %d decode steps; launches %s, routes %s"
        % (len(reqs), tokens, wall, res["tokens_per_s"],
           res["ttft_p50_ms"], res["ttft_p99_ms"], res["itl_p50_ms"],
           res["step_mean_ms"], n_pre, n_step, launches, routes))
    log("serve profiled round: wall %.3fs, device busy %s, %d kernels "
        "(%.0f per decode step), device ms by class %s"
        % (prof["wall_s"], "not measured" if prof["busy_share"] is None
           else "%.1f%%" % (100 * prof["busy_share"]), prof["kernels"],
           prof["kernels_per_step"], {k: round(v, 3) for k, v in
                                      prof["device_ms"].items()}))
    for name, ms in prof["top_kernels_ms"]:
        log("serve profiled round: %8.3f ms  %s" % (ms, name))
    return res


def _kernel_class(name):
    low = name.lower()
    # paged_decode_split_kernel / paged_decode_kernel (the two routes)
    if "paged_decode_" in low:
        return "paged_decode_attention"
    # flash_prefill_mma_kernel / flash_prefill_kernel
    if "flash_prefill_" in low:
        return "flash_prefill_paged"
    if "flash_fwd_" in low:
        return "flash_attention"
    if any(k in low for k in ("dkdv_", "dq_bf16", "dq_f32", "delta_kernel")):
        return "flash_attention_bwd"
    if any(k in low for k in ("gemm", "gemv", "xmma", "cutlass", "cublas",
                              "nvjet")):
        return "matmul"
    return "other"


def profile_round(torch, eng, reqs):
    """The same requests again under torch.profiler (see profile_run)."""
    def run():
        for sess in [eng.submit(p, max_new_tokens=m) for p, m in reqs]:
            sess.result()
    return profile_run(torch, run)


# the runtime calls that enqueue work on the card: kernel launches,
# copies and fills, and graph launches
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cuGraphLaunch", "cudaLaunchCooperativeKernel",
                "cudaMemcpyAsync", "cudaMemsetAsync")


def profile_run(torch, run, classify=_kernel_class, classify_seq=None):
    """``run()`` under torch.profiler, CUDA activity only: the device's
    busy share of the wall time (union of kernel intervals) and device
    time by kernel class (``classify(kernel name)``, or
    ``classify_seq(names in start order)`` giving one class each). The
    profiler slows the host, so this wall is not a measured one."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, device_ms, by_name = [], {}, {}
    evs = sorted((ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda ev: ev.time_range.start)
    classes = (classify_seq([ev.name for ev in evs]) if classify_seq
               else [classify(ev.name) for ev in evs])
    for ev, cls in zip(evs, classes):
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        device_ms[cls] = device_ms.get(cls, 0.0) + (end - start) / 1e3
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (end - start) / 1e3
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # host launches: the runtime's launch calls, a graph replay one
    launch_calls = [ev.name for ev in prof.events()
                    if ev.device_type != torch.autograd.DeviceType.CUDA
                    and ev.name.startswith(LAUNCH_CALLS)]
    graphs = sum(n.startswith(("cudaGraphLaunch", "cuGraphLaunch"))
                 for n in launch_calls)
    return {"wall_s": wall, "kernels": len(spans), "device_ms": device_ms,
            "top_kernels_ms": [[n[:96], ms] for n, ms in top],
            "busy_share": (busy_us / (wall * 1e6)) if spans else None,
            "host_launches": len(launch_calls) if launch_calls else None,
            "graph_launches": graphs if launch_calls else None}


# ---------------------------------------------------------------------------
# phase 8: train at full width
# ---------------------------------------------------------------------------

# mxnet_tpu/benchmark.py:669-697 train_transformer_lm: GPT ~185M, learned
# positions, MHA, batch 8, seq 1024, bf16, SGD lr 0.01, 8 steps a call
TRAIN = dict(vocab_size=32768, d_model=1024, n_heads=16, n_layers=12,
             d_ff=4096, max_len=1024)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_K, TRAIN_LR = 8, 1024, 8, 0.01


def train(torch, fa):
    """One warm call and two timed calls of 8 steps through
    ``make_transformer_train_step(device_loop=True)``; loss finite every
    call, weights changed, 12 forward and 12 backward flash launches per
    step; tokens/s, ms/step and MFU with benchmark.py's flop count
    (6N + 12 L d s / 2 per token); then one profiled step."""
    from mxnet_tpu_torch.parallel.transformer import (
        TransformerConfig, init_transformer_params_np,
        make_transformer_train_step)
    cfg = TransformerConfig(dtype=torch.bfloat16, **TRAIN)
    t0 = time.time()
    params = init_transformer_params_np(cfg, seed=0, trainable=True)
    n_params = sum(p.numel() for p in params.parameters())
    log("train: weights %.1fs (%d params)" % (time.time() - t0, n_params))
    rng = np.random.RandomState(0)            # as benchmark.py draws them
    shape = (TRAIN_K, TRAIN_BATCH, TRAIN_SEQ)
    tokens = torch.tensor(rng.randint(0, cfg.vocab_size, shape),
                          dtype=torch.int32, device="cuda")
    targets = torch.tensor(rng.randint(0, cfg.vocab_size, shape),
                           dtype=torch.int32, device="cuda")
    loop = make_transformer_train_step(cfg, None, lr=TRAIN_LR,
                                       device_loop=True)
    w0 = params.layers["wq"].detach().clone()
    calls = []
    for i in range(3):
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = loop(params, tokens, targets)
        loss = float(loss)
        torch.cuda.synchronize()
        calls.append({"wall_s": time.perf_counter() - t0, "loss": loss,
                      "launches": dict(fa.LAUNCHES)})
        log("train: call %d (%s) %.3fs, last loss %.4f, launches %s"
            % (i, "warm" if i == 0 else "timed", calls[-1]["wall_s"], loss,
               calls[-1]["launches"]))
        check(np.isfinite(loss), "train: loss %r is not finite" % loss)
        for name in ("flash_attention", "flash_attention_bwd"):
            check(calls[-1]["launches"][name] == cfg.n_layers * TRAIN_K,
                  "train: %s launched %d times for %d steps x %d layers"
                  % (name, calls[-1]["launches"][name], TRAIN_K,
                     cfg.n_layers))
        for name in ("paged_decode_attention", "flash_prefill_paged"):
            check(calls[-1]["launches"][name] == 0,
                  "train: %s launched" % name)
    check(not torch.equal(w0, params.layers["wq"].detach()),
          "train: the weights did not change")
    dt = sum(c["wall_s"] for c in calls[1:]) / len(calls[1:])
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ * TRAIN_K / dt
    flop_per_tok = 6 * n_params + 12 * cfg.n_layers * cfg.d_model * \
        TRAIN_SEQ * 0.5
    mfu = tokens_per_s * flop_per_tok / BF16_FLOPS
    check(mfu <= 1.05, "train: %.0f tokens/s implies MFU %.2f > 1"
          % (tokens_per_s, mfu))
    step = make_transformer_train_step(cfg, None, lr=TRAIN_LR)
    prof = profile_run(torch, lambda: step(params, tokens[0], targets[0]))
    res = {"n_params": n_params, "calls": calls, "ms_per_step": dt * 1e3 /
           TRAIN_K, "tokens_per_s": tokens_per_s,
           "flop_per_token": flop_per_tok, "mfu": mfu,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "profiled_step": prof}
    log("train: %.0f tokens/s, %.2f ms/step, MFU %.3f (%.3g GFLOP/token, "
        "989 TFLOP/s peak), peak memory %.1f GB"
        % (tokens_per_s, res["ms_per_step"], mfu, flop_per_tok / 1e9,
           res["peak_mem_gb"]))
    log("train profiled step: wall %.3fs, device busy %s, %d kernels, "
        "device ms by class %s"
        % (prof["wall_s"], "not measured" if prof["busy_share"] is None
           else "%.1f%%" % (100 * prof["busy_share"]), prof["kernels"],
           {k: round(v, 3) for k, v in prof["device_ms"].items()}))
    for name, ms in prof["top_kernels_ms"]:
        log("train profiled step: %8.3f ms  %s" % (ms, name))
    return res


def train_vs_cpu(torch, fa):
    """Phase 9: the train step on the card against the port on the CPU,
    float32, at full width with 2 layers, batch 2, seq 256: the loss of
    each of 2 steps and every weight after them."""
    from mxnet_tpu_torch.convert import params_to_numpy
    from mxnet_tpu_torch.parallel.transformer import (
        TransformerConfig, init_transformer_params_np,
        make_transformer_train_step)
    cfg = TransformerConfig(dtype=torch.float32,
                            **dict(TRAIN, n_layers=2, max_len=256))
    p_cpu = init_transformer_params_np(cfg, seed=0, device="cpu",
                                       trainable=True)
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    rng = np.random.RandomState(1)
    tok = torch.tensor(rng.randint(0, cfg.vocab_size, (2, 2, 256)))
    tgt = torch.tensor(rng.randint(0, cfg.vocab_size, (2, 2, 256)))
    step = make_transformer_train_step(cfg, None, lr=TRAIN_LR)
    losses = {"cpu": [], "cuda": []}
    fa.reset_launches()
    for i in range(2):
        for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
            _, loss = step(params, tok[i].to(dev), tgt[i].to(dev))
            losses[dev].append(float(loss))
    launches = dict(fa.LAUNCHES)
    check(launches["flash_attention"] == 2 * cfg.n_layers
          and launches["flash_attention_bwd"] == 2 * cfg.n_layers,
          "train vs CPU: launches %s for 2 card steps x %d layers"
          % (launches, cfg.n_layers))
    loss_err = max(abs(a - b) for a, b in zip(losses["cpu"],
                                               losses["cuda"]))
    got, want = params_to_numpy(p_gpu), params_to_numpy(p_cpu)
    param_err = {}
    for k in want:
        pairs = (want[k].items() if k == "layers" else [(k, want[k])])
        for name, w in pairs:
            g = got[k][name] if k == "layers" else got[k]
            param_err[name] = float(np.abs(g - w).max())
    log("train vs CPU f32 (2 layers, batch 2, seq 256): losses cpu %s card "
        "%s, max loss err %.2e (tol %g), max weight err %.2e in %s (tol %g)"
        % (losses["cpu"], losses["cuda"], loss_err, TRAIN_LOSS_TOL,
           max(param_err.values()), max(param_err, key=param_err.get),
           TRAIN_PARAM_TOL))
    check(all(np.isfinite(losses["cuda"])), "train vs CPU: non-finite loss")
    check(loss_err <= TRAIN_LOSS_TOL, "train vs CPU: loss differs by %g"
          % loss_err)
    check(max(param_err.values()) <= TRAIN_PARAM_TOL,
          "train vs CPU: weights differ: %s" % param_err)
    return {"losses": losses, "loss_err": loss_err, "param_err": param_err}


def check_captured(torch, fa, rec, lim):
    """rel_err of one captured flash launch of the train path (its q, k,
    v, the o and lse it returned, and the do, dq, dk, dv of its backward
    launch) against the plain versions on the same inputs."""
    ref = plain_flash(torch, fa, rec["q"], rec["k"], rec["v"], rec["do"],
                      True, rec["scale"])
    errs = {n: rel_err(rec[n], r) for n, r in zip(FLASH_OUTS, ref)}
    return errs, {n: e for n, e in errs.items() if e > lim[n]}


def train_bf16_routes(torch, fa):
    """Phase 10: the train path in bf16 at its width (2 of its 12 layers,
    batch 8 x seq 1024), loss and gradients from the same weights and
    batch, three ways:

    - "kernels": attention through flash_attention inside autograd (o
      and lse saved, the incoming gradient transposed by the head
      merge). Every launch's inputs and outputs are captured and held
      against the plain versions on those inputs at phase 6's limits:
      the kernels at the activations the path gives them.
    - "plain": attention through ring_attention_local impl="einsum"
      (plain tensor ops, autograd's own backward). The loss must agree
      within one bf16 ulp of the summed token losses, and every weight's
      gradient (the step applies p - lr * g; compared before the bf16
      weights round the update) within TRAIN_BF16_GRAD_TOL: the routes
      round differently inside attention and every later bf16 rounding
      then differs, so this limit is looser than phase 6's.
    - "planted": the kernels with the forward's lse rounded to bf16; the
      captured launches must fail their checks."""
    from mxnet_tpu_torch.parallel.transformer import (
        TransformerConfig, _lm_local_loss, init_transformer_params_np)
    cfg = TransformerConfig(dtype=torch.bfloat16, **dict(TRAIN, n_layers=2))
    params = init_transformer_params_np(cfg, seed=0, trainable=True)
    names = [n for n, _ in params.named_parameters()]
    leaves = list(params.parameters())
    rng = np.random.RandomState(2)
    tok, tgt = (torch.tensor(rng.randint(0, cfg.vocab_size,
                                         (TRAIN_BATCH, TRAIN_SEQ)),
                             device="cuda") for _ in range(2))
    real_fwd, real_bwd = fa._flash_fwd, fa.flash_attention_bwd
    lim = flash_limits(torch.bfloat16, torch)

    def run(route):
        recs = []
        fwd = real_fwd
        if route == "planted":
            def fwd(*args):
                o, lse = real_fwd(*args)
                return o, lse.bfloat16().float()

        def capture_fwd(q, k, v, causal, sm_scale):
            o, lse = fwd(q, k, v, causal, sm_scale)
            recs.append({"q": q.detach(), "k": k.detach(),
                         "v": v.detach(), "o": o.detach(), "lse": lse,
                         "scale": sm_scale})
            return o, lse

        def capture_bwd(q, k, v, o, lse, do, causal, sm_scale):
            dq, dk, dv = real_bwd(q, k, v, o, lse, do, causal, sm_scale)
            rec = next(r for r in recs
                       if r["o"].data_ptr() == o.data_ptr())
            rec.update(do=do, dq=dq, dk=dk, dv=dv)
            return dq, dk, dv

        fa.reset_launches()
        fa._flash_fwd, fa.flash_attention_bwd = capture_fwd, capture_bwd
        try:
            with torch.enable_grad():
                loss = _lm_local_loss(params, tok, tgt, cfg, attn_impl=(
                    "einsum" if route == "plain" else "auto"))
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
        finally:
            fa._flash_fwd, fa.flash_attention_bwd = real_fwd, real_bwd
        n = 0 if route == "plain" else cfg.n_layers
        launches = dict(fa.LAUNCHES)
        check(launches["flash_attention"] == n
              and launches["flash_attention_bwd"] == n and len(recs) == n,
              "bf16 routes: %s route launched %s, expected %d + %d"
              % (route, launches, n, n))
        checks = [check_captured(torch, fa, r, lim) for r in recs]
        return float(loss.detach()), grads, checks

    runs = {route: run(route) for route in ("kernels", "plain", "planted")}
    ref_loss, ref_grads, _ = runs["plain"]
    # the per-token losses are summed in bf16 (as in the JAX step): the
    # loss resolves one bf16 ulp of the sum over the token count
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    loss_ulp = 2.0 ** (np.floor(np.log2(ref_loss * n_tok)) - 7) / n_tok
    res = {"loss_plain": ref_loss, "loss_ulp": loss_ulp}
    for route in ("kernels", "planted"):
        loss, grads, checks = runs[route]
        errs = {n: float((g.float() - r.float()).norm() / r.float().norm())
                for n, g, r in zip(names, grads, ref_grads)}
        worst = max(errs, key=errs.get)
        res[route] = {"loss": loss, "grad_rel_err": errs,
                      "launch_rel_err": [c[0] for c in checks]}
        for li, (e, bad) in enumerate(checks):
            log("bf16 routes: %s, layer %d's flash launches vs plain: %s%s"
                % (route, li, " ".join("%s=%.2e" % kv for kv in e.items()),
                   " OVER %s" % sorted(bad) if bad else ""))
        log("bf16 routes: %s vs plain attention: loss %.5f vs %.5f (ulp "
            "%.4f); gradient rel. RMS err max %.2e in %s (limit %g): %s"
            % (route, loss, ref_loss, loss_ulp, errs[worst], worst,
               TRAIN_BF16_GRAD_TOL, " ".join(
                   "%s=%.1e" % kv for kv in errs.items())))
    ok = res["kernels"]
    check(not any(bad for _, bad in runs["kernels"][2]),
          "bf16 routes: a flash launch of the train path disagrees with "
          "the plain version: %s" % ok["launch_rel_err"])
    check(np.isfinite(ok["loss"]) and abs(ok["loss"] - ref_loss)
          <= loss_ulp, "bf16 routes: loss %r vs plain %r" % (ok["loss"],
                                                             ref_loss))
    check(max(ok["grad_rel_err"].values()) <= TRAIN_BF16_GRAD_TOL,
          "bf16 routes: gradients differ from the plain route's: %s"
          % ok["grad_rel_err"])
    check(all(bad for _, bad in runs["planted"][2]),
          "bf16 routes: the planted fault (lse in bf16) passes the launch "
          "checks: %s" % res["planted"]["launch_rel_err"])
    return res


# ---------------------------------------------------------------------------
# phases 11-14: ResNet-50 Module.fit and the fused update kernel
# ---------------------------------------------------------------------------

RESNET_BATCH = 32       # examples/train_imagenet.py --batch-size default
IMAGENET_EXAMPLES = 1281167
# benchmark.py:84-86: 4.09 GFLOP a 224x224 forward, x2 multiply-add, x3
# forward + backward
RESNET_TRAIN_FLOP = 3 * 2 * 4.09e9
F32_FLOPS = 67e12       # H100 SXM dense float32 outside the tensor cores
# phase 14: two chained steps of the card (f32), the CPU (f32) and the CPU
# in float64 (the witness) from one state; per step, relative RMS error
# against the witness of the outputs, each weight's change since the start
# and each moving statistic's. At this network's initialization float32
# itself is far off: the CPU's weight changes sit 1.4e-2 (median) from the
# witness after step 1 and ~0.5 after step 2, and a 1e-7 nudge of the
# witness's own weights moves it as far (the gradient is ill-conditioned,
# whatever the precision). So the card is held to the CPU's own float32
# error: every error at most RESNET_RATIO_TOL times the CPU's same error
# (the card read 1.10-1.30x in its first run; the planted BatchNorm fault
# 2.9-4.0x). Step 1's outputs and moving statistics are forward only and
# are held absolutely (card 4.7e-6 and 1.9e-5 in that run).
RESNET_OUT_TOL = 1e-4
RESNET_DSTAT_TOL = 1e-3
RESNET_RATIO_TOL = 1.75

def resnet_symbol(mx, num_layers=50):
    """examples/train_imagenet.py --network resnet --num-layers 50."""
    return mx.models.resnet(num_classes=1000, num_layers=num_layers,
                            image_shape=(3, 224, 224))


def resnet_param_shapes(mx):
    """(name, shape) of ResNet-50's 157 trained arguments, from the
    port's infer_shape."""
    sym = resnet_symbol(mx)
    arg_shapes, _, _ = sym.infer_shape(data=(RESNET_BATCH, 3, 224, 224),
                                       softmax_label=(RESNET_BATCH,))
    return [(n, s) for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")]


def update_inputs(torch, gen, shapes, kind, clip=False, step=1):
    """Random weights, gradients and states on the card for every shape,
    and per-tensor hypers (lr and wd differing between tensors, wd 0 on
    biases and betas as ``set_wd_mult`` gives): kind "sgd_mom", "sgd"
    or "adam" (lr bias-corrected for ``step`` as ``Adam.fused_hyper``)."""
    def rnd(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to("cuda")

    ws = [rnd(s, 0.05) for _, s in shapes]
    gs = [rnd(s, 1.0) for _, s in shapes]
    if kind == "sgd_mom":
        states = [(rnd(s, 0.01),) for _, s in shapes]
    elif kind == "sgd":
        states = [() for _ in shapes]
    else:
        states = [(rnd(s, 0.01), rnd(s, 1e-3).abs()) for _, s in shapes]
    hypers = []
    for i, (name, _) in enumerate(shapes):
        decays = name.endswith("_weight") or name.endswith("_gamma")
        h = {"lr": 0.1 * (1 + (i % 7) / 7.0),
             "wd": 1e-4 * (1 + i % 3) if decays else 0.0,
             "rescale_grad": 1.0 / RESNET_BATCH}
        if clip:
            h["clip_gradient"] = 0.02   # clips about half of g / 32
        if kind == "sgd_mom":
            h["momentum"] = 0.9
        elif kind == "adam":
            b1, b2 = 0.9, 0.999
            h["lr"] = 1e-3 * (1 + (i % 7) / 7.0) * float(
                np.sqrt(1.0 - b2 ** step) / (1.0 - b1 ** step))
            h.update(beta1=b1, beta2=b2, one_minus_beta1=1.0 - b1,
                     one_minus_beta2=1.0 - b2, epsilon=1e-8)
        hypers.append(h)
    return ws, gs, states, hypers


def run_update(torch, fu, kind, ws, gs, states, hypers, plain):
    """A copy of the weights and states after one update, by the kernel
    or (``plain``) the plain version."""
    ws = [w.clone() for w in ws]
    states = [tuple(s.clone() for s in st) for st in states]
    if plain:
        rule = fu._adam_fused if kind == "adam" else fu._sgd_fused
    else:
        rule = fu.adam_fused_update if kind == "adam" \
            else fu.sgd_fused_update
    rule(ws, gs, states, hypers)
    torch.cuda.synchronize()
    return ws, states


def update_diff(torch, a, b):
    """(all bitwise equal, max abs difference) of two update results."""
    pairs = list(zip(a[0], b[0])) + [
        (x, y) for sa, sb in zip(a[1], b[1]) for x, y in zip(sa, sb)]
    return (all(torch.equal(x, y) for x, y in pairs),
            max(max_err(x, y) for x, y in pairs))


def check_fused(torch, mx, fu):
    """Phase 11: both update kernels against their plain versions on the
    card, bitwise, over all 157 ResNet-50 parameter shapes: SGD with
    momentum, stateless SGD, SGD with clip, Adam at steps 1 and 7. Then a
    planted fault that must fail: the plain version fed the hyper table
    shifted by one tensor."""
    shapes = resnet_param_shapes(mx)
    check(len(shapes) == 157, "ResNet-50 has %d trained arguments, not 157"
          % len(shapes))
    gen = torch.Generator().manual_seed(11)
    rows = []
    for kind, clip, step in (("sgd_mom", False, 1), ("sgd", False, 1),
                             ("sgd_mom", True, 1), ("adam", False, 1),
                             ("adam", False, 7)):
        args = update_inputs(torch, gen, shapes, kind, clip, step)
        got = run_update(torch, fu, kind, *args, plain=False)
        ref = run_update(torch, fu, kind, *args, plain=True)
        same, err = update_diff(torch, got, ref)
        rows.append({"kind": kind, "clip": clip, "step": step,
                     "bitwise": same, "max_abs_err": err})
        log("check %s_fused_update %-7s clip=%d step=%d over %d tensors: "
            "bitwise %s, max abs err %.3g" % (
                "adam" if kind == "adam" else "sgd", kind, clip, step,
                len(shapes), same, err))
        check(same, "fused update %s clip=%s step=%d differs from the "
              "plain version (max abs err %g)" % (kind, clip, step, err))
        if kind == "sgd_mom" and not clip:
            ws, gs, states, hypers = args
            shifted = run_update(torch, fu, kind, ws, gs, states,
                                 hypers[1:] + hypers[:1], plain=True)
            same_p, err_p = update_diff(torch, got, shifted)
            log("planted fault (hyper table shifted by one tensor): "
                "bitwise %s, max abs err %.3g" % (same_p, err_p))
            check(not same_p, "planted fault (shifted hyper table) passes "
                  "the bitwise check")
            rows.append({"planted": "hypers shifted by one",
                         "bitwise": same_p, "max_abs_err": err_p})
    return rows


def time_fused(torch, mx, fu, timer):
    """Phase 12: both kernels over the whole ResNet-50 parameter list
    (25.55M values), L2 flushed before every launch, beside their bound,
    the plain version and PyTorch's own fused optimizer kernels
    (``torch._fused_sgd_`` / ``torch._fused_adam_``, what
    ``torch.optim.SGD/Adam(fused=True)`` run; the same bytes under a
    slightly different formula). The wrapper's host side (argument
    checks, tables) takes longer than the L2 flush, so the kernel and
    library calls are timed with a 2 ms device-side hold before each;
    ``host_ms`` is the wrapper's own host time per call."""
    shapes = resnet_param_shapes(mx)
    gen = torch.Generator().manual_seed(12)
    n = sum(int(np.prod(s)) for _, s in shapes)
    rows = []
    # bytes: SGD-momentum reads w, g, mom and writes w, mom; Adam reads
    # w, g, m, v and writes w, m, v. Operations per value: 7 and 15.
    for kind, nbytes, flops in (("sgd_mom", 20 * n, 7.0 * n),
                                ("adam", 28 * n, 15.0 * n)):
        ws, gs, states, hypers = update_inputs(torch, gen, shapes, kind)
        got = run_update(torch, fu, kind, ws, gs, states, hypers, False)
        ref = run_update(torch, fu, kind, ws, gs, states, hypers, True)
        _, err = update_diff(torch, got, ref)
        if kind == "adam":
            name = "adam_fused_update"
            fn = lambda: fu.adam_fused_update(ws, gs, states, hypers)
            plain = lambda: fu._adam_fused(ws, gs, states, hypers)
            steps = [torch.ones((), device="cuda") for _ in ws]
            lib = lambda: torch._fused_adam_(
                ws, gs, [s[0] for s in states], [s[1] for s in states], [],
                steps, lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=1e-4,
                eps=1e-8, amsgrad=False, maximize=False)
        else:
            name = "sgd_fused_update"
            fn = lambda: fu.sgd_fused_update(ws, gs, states, hypers)
            plain = lambda: fu._sgd_fused(ws, gs, states, hypers)
            lib = lambda: torch._fused_sgd_(
                ws, gs, [s[0] for s in states], weight_decay=1e-4,
                momentum=0.9, lr=0.1, dampening=0.0, nesterov=False,
                maximize=False, is_first_step=False)
        t_bytes, t_flops = nbytes / HBM_BPS, flops / F32_FLOPS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        rows.append({
            "name": name, "shape": "ResNet-50: 157 tensors, %d values" % n,
            "ms": timer(fn, hold_ms=2.0), "plain_ms": timer(plain),
            "library_ms": timer(lib, hold_ms=2.0), "host_ms": host_ms,
            "bound_ms": max(t_bytes, t_flops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": nbytes, "max_abs_err": err})
        del ws, gs, states
    for r in rows:
        log("time %-18s %s ms=%.4f plain_ms=%.4f library_ms=%.4f "
            "bound_ms=%.4f (%s) %.0f GB/s host_ms=%.3f max_abs_err=%.3g"
            % (r["name"], r["shape"], r["ms"], r["plain_ms"],
               r["library_ms"], r["bound_ms"], r["bound_by"],
               r["bytes"] / (r["ms"] * 1e-3) / 1e9, r["host_ms"],
               r["max_abs_err"]))
    return rows


def synthetic_iter(mx, data_shape, num_classes, epoch_size, ctx):
    """examples/common/data.py:55-87 SyntheticDataIter: one fixed batch
    from RandomState(0), uniform in [-1, 1), labels in [0, num_classes),
    replayed ``epoch_size`` times; on the card, as the JAX iterator's
    arrays land on the default (accelerator) context."""
    class SyntheticDataIter(mx.io.DataIter):
        def __init__(self):
            super().__init__(batch_size=data_shape[0])
            rng = np.random.RandomState(0)
            self._data = mx.nd.array(rng.uniform(-1, 1, data_shape).astype(
                np.float32), ctx=ctx)
            self._label = mx.nd.array(rng.randint(
                0, num_classes, (data_shape[0],)).astype(np.float32),
                ctx=ctx)
            self.provide_data = [mx.io.DataDesc("data", data_shape)]
            self.provide_label = [mx.io.DataDesc("softmax_label",
                                                 (data_shape[0],))]
            self._cur = 0

        def reset(self):
            self._cur = 0

        def next(self):
            if self._cur >= epoch_size:
                raise StopIteration
            self._cur += 1
            return mx.io.DataBatch(data=[self._data], label=[self._label],
                                   provide_data=self.provide_data,
                                   provide_label=self.provide_label)

    return SyntheticDataIter()


def fit_args(mx, optimizer="sgd", lr=0.1, batch_size=RESNET_BATCH):
    """The Module.fit arguments examples/common/fit.py:98-160 passes for
    ``--network resnet --num-layers 50 --benchmark 1`` on one device:
    ``_get_lr_scheduler``'s MultiFactorScheduler over ImageNet's epoch
    size (steps at epochs 30, 60, 80, factor 0.1), wd 1e-4, momentum 0.9
    for SGD, Xavier(gaussian, in, 2), accuracy and top-5 accuracy, a
    Speedometer every 20 batches, kvstore 'device', allow_missing."""
    epoch_size = -(-IMAGENET_EXAMPLES // batch_size)
    params = {"learning_rate": lr, "wd": 1e-4,
              "lr_scheduler": mx.lr_scheduler.MultiFactorScheduler(
                  step=[epoch_size * e for e in (30, 60, 80)], factor=0.1,
                  base_lr=lr)}
    if optimizer == "sgd":
        params["momentum"] = 0.9
    return dict(kvstore="device", optimizer=optimizer,
                optimizer_params=params,
                initializer=mx.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2),
                eval_metric=["accuracy",
                             mx.metric.create("top_k_accuracy", top_k=5)],
                batch_end_callback=[mx.callback.Speedometer(batch_size, 20)],
                allow_missing=True)


def _resnet_class(name):
    low = name.lower()
    if "fused_update_kernel" in low:
        return "fused_update"
    if any(k in low for k in ("jpeg", "idct", "huffman",
                              "crop_mirror_normalize")):
        return "image_decode"
    if "batch_norm" in low or "bn_" in low or "welford" in low:
        return "batchnorm"
    if any(k in low for k in ("fprop", "dgrad", "wgrad", "conv", "winograd",
                              "implicit_gemm", "cudnn", "xmma_fft")):
        return "cudnn_conv"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "cublas", "cutlass")):
        return "cublas"
    return "elementwise_other"


def resnet_fit(torch, mx, fu, fa, batches=24):
    """Phase 13: ResNet-50 through ``Module.fit`` on the card, the
    configuration of examples/train_imagenet.py --benchmark 1 (batch 32
    of float32 3x224x224, TF32 off), two epochs of ``batches`` batches:
    the first warms up, the second is timed (host clock from the end of
    the first epoch-end callback, after its snapshot of the weights, to
    the start of the second, after a synchronize). Every launch count is
    0 just before the fit and read just after: ``sgd_fused_update`` once a
    step, its plain version never. Then the same fit with
    ``--optimizer adam`` for 4 batches (``adam_fused_update`` once a
    step), and one SGD step under torch.profiler."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    sym = resnet_symbol(mx)
    shape = (RESNET_BATCH, 3, 224, 224)
    ctx = mx.gpu(0)
    train = mx.io.ResizeIter(synthetic_iter(
        mx, shape, 1000, IMAGENET_EXAMPLES // RESNET_BATCH, ctx), batches)
    ends, resumed, snaps = [], [], []

    def epoch_end(epoch, _sym, arg, aux):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        snaps.append(({k: v.asnumpy() for k, v in arg.items()},
                      {k: v.asnumpy() for k, v in aux.items()}))
        resumed.append(time.perf_counter())   # the snapshot is not timed

    plain_calls = [0]
    real_plain = fu._sgd_fused

    def spy(*args):
        plain_calls[0] += 1
        return real_plain(*args)

    mod = mx.mod.Module(sym, context=ctx)
    mx.random.seed(0)
    torch.cuda.reset_peak_memory_stats()
    fu.reset_launches()
    fa.reset_launches()
    fu._sgd_fused = spy
    try:
        t0 = time.perf_counter()
        mod.fit(train, num_epoch=2, epoch_end_callback=epoch_end,
                **fit_args(mx))
    finally:
        fu._sgd_fused = real_plain
    launches = dict(fu.LAUNCHES, **fa.LAUNCHES)
    warm_s = ends[0] - t0
    dt = ends[1] - resumed[0]
    steps = 2 * batches
    check(launches["sgd_fused_update"] == steps,
          "fit: sgd_fused_update launched %d times for %d steps"
          % (launches["sgd_fused_update"], steps))
    check(plain_calls[0] == 0, "fit: the plain SGD rule ran %d times"
          % plain_calls[0])
    check(all(n == 0 for k, n in launches.items()
              if k != "sgd_fused_update"),
          "fit launched another kernel: %s" % launches)
    ce = mx.metric.CrossEntropy()
    ce.update([train.data_iter._label], mod.get_outputs())
    loss = float(ce.get()[1])
    out = mod.get_outputs()[0]
    check(out.shape == (RESNET_BATCH, 1000), "outputs %s" % (out.shape,))
    check(np.isfinite(loss), "fit: cross-entropy %r is not finite" % loss)
    (a0, x0), (a1, x1) = snaps
    w_moved = max(float(np.abs(a1[k] - a0[k]).max()) for k in a0)
    s_moved = max(float(np.abs(x1[k] - x0[k]).max()) for k in x0)
    check(w_moved > 0 and s_moved > 0, "fit: weights (%g) or BN moving "
          "stats (%g) did not change in the timed epoch" % (w_moved,
                                                          s_moved))
    check(all(np.isfinite(v).all() for v in a1.values()),
          "fit: non-finite weights")
    img_s = RESNET_BATCH * batches / dt
    mfu = img_s * RESNET_TRAIN_FLOP / F32_FLOPS
    check(mfu <= 1.05, "fit: %.0f img/s implies MFU %.2f > 1" % (img_s, mfu))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    metric = mx.metric.create(["accuracy"])
    batch = next(iter(train))
    train.reset()
    fu.reset_launches()

    def one_step():
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric, batch.label)

    prof = profile_run(torch, one_step, _resnet_class)
    check(fu.LAUNCHES["sgd_fused_update"] == 1, "profiled step launched "
          "sgd_fused_update %d times" % fu.LAUNCHES["sgd_fused_update"])
    del mod
    # --optimizer adam: the same fit, 4 batches
    mod = mx.mod.Module(sym, context=ctx)
    fu.reset_launches()
    mod.fit(mx.io.ResizeIter(train.data_iter, 4), num_epoch=1,
            **fit_args(mx, optimizer="adam"))
    adam_launches = fu.LAUNCHES["adam_fused_update"]
    check(adam_launches == 4, "fit(optimizer='adam'): adam_fused_update "
          "launched %d times for 4 steps" % adam_launches)
    check(all(np.isfinite(v.asnumpy()).all()
              for v in mod.get_params()[0].values()),
          "fit(optimizer='adam'): non-finite weights")
    del mod
    res = {"batch": RESNET_BATCH, "timed_batches": batches,
           "warm_epoch_s": warm_s, "timed_epoch_s": dt,
           "img_per_s": img_s, "ms_per_step": dt * 1e3 / batches,
           "mfu": mfu, "cross_entropy": loss, "weights_moved": w_moved,
           "stats_moved": s_moved, "launches": launches,
           "adam_launches": adam_launches, "peak_mem_gb": peak_gb,
           "cudnn_benchmark": torch.backends.cudnn.benchmark,
           "profiled_step": prof}
    log("resnet fit: %d steps (%d warm); timed epoch %.3fs: %.1f img/s, "
        "%.2f ms/step, MFU %.3f (24.54 GFLOP/img, 67 TFLOP/s f32 peak); "
        "warm epoch %.2fs; cross-entropy %.4f; launches %s; adam run %d "
        "launches; peak memory %.1f GB; cudnn.benchmark=%s"
        % (steps, batches, dt, img_s, res["ms_per_step"], mfu, warm_s, loss,
           launches, adam_launches, peak_gb, res["cudnn_benchmark"]))
    log("resnet profiled step: wall %.3fs, device busy %s, %d kernels, "
        "device ms by class %s"
        % (prof["wall_s"], "not measured" if prof["busy_share"] is None
           else "%.1f%%" % (100 * prof["busy_share"]), prof["kernels"],
           {k: round(v, 3) for k, v in prof["device_ms"].items()}))
    for name, ms in prof["top_kernels_ms"]:
        log("resnet profiled step: %8.3f ms  %s" % (ms, name))
    return res


def rel_rms(got, ref):
    """||got - ref|| / ||ref|| (0 when both are 0)."""
    den = float(np.linalg.norm(ref))
    num = float(np.linalg.norm(got - ref))
    return num / den if den > 0 else num


def bn_unbiased_backward(torch, real):
    """A planted fault for phase 14: BatchNorm whose gradient is that of
    normalizing by the unbiased batch variance; its forward value (and the
    moving statistics) stay the sound op's."""
    def fn(data, gamma, beta, moving_mean, moving_var, **attrs):
        res = real(data, gamma, beta, moving_mean, moving_var, **attrs)
        if not attrs.get("train_mode") or attrs.get("use_global_stats"):
            return res
        out = res[0] if isinstance(res, tuple) else res
        red = tuple(i for i in range(data.dim()) if i != 1)
        var, mean = torch.var_mean(data, dim=red, correction=1, keepdim=True)
        if attrs.get("fix_gamma", True):
            gamma = torch.ones_like(gamma)
        shape = (1, -1) + (1,) * (data.dim() - 2)
        bad = ((data - mean) / torch.sqrt(var + attrs.get("eps", 1e-3))
               * gamma.view(shape) + beta.view(shape))
        out = bad + (out - bad).detach()
        return (out,) + tuple(res[1:]) if isinstance(res, tuple) else out
    return fn


def float64_constants(mx, sym):
    """``sym`` with its constant nodes (``_zeros``, ``_ones``, ``_full``,
    float32 unless told otherwise) made float64, so that the graph binds
    in float64 throughout."""
    graph = json.loads(sym.tojson())
    for node in graph["nodes"]:
        if node["op"] in ("_zeros", "_ones", "_full"):
            node["attrs"]["dtype"] = "float64"
    return mx.sym.load_json(json.dumps(graph))


class _F64Witness(object):
    """The fused SGD step of ``Module.fit`` in float64 on the CPU: the
    port's graph bound in float64 (``simple_bind``, its constants made
    float64), ``Executor.train_step`` with the plain rule, the hypers of
    an optimizer made as Module makes it."""

    def __init__(self, torch, mx, fu, sym, arg0, aux0, x, y, nudge=0.0):
        self.names = [n for n in sym.list_arguments()
                      if n not in ("data", "softmax_label")]
        sym = float64_constants(mx, sym)
        f64 = np.float64
        self.exe = sym.simple_bind(
            ctx=mx.cpu(), grad_req={n: "write" for n in self.names},
            type_dict={n: f64 for n in sym.list_arguments()
                       + sym.list_auxiliary_states()},
            data=x.shape, softmax_label=y.shape)
        self.exe.copy_params_from(
            {k: v.asnumpy().astype(f64) for k, v in arg0.items()},
            {k: v.asnumpy().astype(f64) for k, v in aux0.items()})
        gen = torch.Generator().manual_seed(5)
        for n in self.names:            # a relative nudge of every weight
            w = self.exe.arg_dict[n]._data
            w.mul_(1 + nudge * torch.randn(w.shape, generator=gen,
                                           dtype=torch.float64))
        self.opt = mx.optimizer.create(
            "sgd", sym=sym, param_idx2name=dict(enumerate(self.names)),
            rescale_grad=1.0 / x.shape[0],
            **fit_args(mx, batch_size=x.shape[0])["optimizer_params"])
        self.states = {n: (mx.nd.NDArray(torch.zeros(
            self.exe.arg_dict[n].shape, dtype=torch.float64)),)
            for n in self.names}
        self.feed = {"data": x.astype(f64), "softmax_label": y.astype(f64)}
        self.rule = fu._sgd_fused

    def step(self):
        hyper = {n: self.opt.fused_hyper(i) for i, n in enumerate(self.names)}
        out = self.exe.train_step(self.rule, self.names, self.states, hyper,
                                  feed=self.feed)
        return (out[0].asnumpy(),
                {n: self.exe.arg_dict[n].asnumpy() for n in self.names},
                {k: v.asnumpy() for k, v in self.exe.aux_dict.items()})


def resnet_vs_f64(torch, mx, fu, batch=2, steps=2, sides=(
        "cpu", "dev", "planted", "f64_nudged"), num_layers=50, sym=None,
        plant=None, label="resnet", image=(3, 224, 224), exact_zero=None):
    """``module_vs_f64`` of ResNet-50 (or ``num_layers``, or the image
    classifier ``sym``) at full width on ``batch`` seeded images of
    ``image`` and labels of 1000 classes; ``plant`` defaults to
    BatchNorm's ``bn_unbiased_backward``."""
    if sym is None:
        sym = resnet_symbol(mx, num_layers)
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (batch,) + tuple(image)).astype(np.float32)
    y = rng.randint(0, 1000, (batch,)).astype(np.float32)
    return module_vs_f64(torch, mx, fu, sym, x, y, (batch, 1000), steps=steps,
                         sides=sides, label=label, exact_zero=exact_zero,
                         plant=plant or ("BatchNorm", bn_unbiased_backward))


def module_vs_f64(torch, mx, fu, sym, x, y, out_shape, steps, sides, plant,
                  label, exact_zero=None):
    """The network ``sym`` on data ``x`` and labels ``y``, ``steps``
    chained fused SGD steps (``forward_backward`` + ``update``,
    ``Module.fit``'s loop body with its optimizer arguments) from one
    Xavier state: the witness (``_F64Witness``) and each side of
    ``sides``: "cpu" a CPU Module in f32, "dev" the card's Module in
    f32, "planted" the card's with the op ``plant[0]``'s function
    replaced by ``plant[1](torch, real)``, "f64_nudged" a second witness
    whose weights are nudged by 1e-7 (relative). The first output must
    be finite and of ``out_shape``. Per step and side, relative RMS
    error against the witness of the outputs, of each weight's change
    since the start and of each moving statistic's. With
    ``exact_zero``, a tensor whose witness change has an RMS of at most
    that is zero in exact arithmetic (its float64 change is rounding):
    it is left out of those relative errors, and the largest RMS of such
    a tensor's change on the side is ``zero_max``.
    """
    from mxnet_tpu_torch.ops import registry as reg
    plant_op, make_plant = plant
    data = mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                         [mx.nd.array(y, ctx=mx.cpu())])
    mx.random.seed(1)
    init = mx.mod.Module(sym, context=mx.cpu())
    init.bind(data_shapes=[("data", x.shape)],
              label_shapes=[("softmax_label", y.shape)])
    init.init_params(fit_args(mx)["initializer"])
    arg0, aux0 = init.get_params()
    a0 = {k: v.asnumpy().astype(np.float64) for k, v in arg0.items()}
    x0 = {k: v.asnumpy().astype(np.float64) for k, v in aux0.items()}
    del init
    witness = _F64Witness(torch, mx, fu, sym, arg0, aux0, x, y)
    mods = {}
    for side in sides:
        if side == "f64_nudged":
            mods[side] = _F64Witness(torch, mx, fu, sym, arg0, aux0, x, y,
                                     nudge=1e-7)
            continue
        mod = mx.mod.Module(sym, context=mx.cpu() if side == "cpu"
                            else mx.gpu(0))
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", y.shape)])
        mod.init_params(None, arg_params=arg0, aux_params=aux0)
        mod.init_optimizer(kvstore="device", optimizer="sgd",
                           optimizer_params=fit_args(
                               mx, batch_size=x.shape[0])["optimizer_params"])
        mods[side] = mod
    bn = reg.get_op(plant_op)
    sound_bn = bn.fn
    rows = []
    for step in range(1, steps + 1):
        t0 = time.time()
        o_w, a_w, s_w = witness.step()
        row = {"step": step, "witness_s": time.time() - t0}
        for side, mod in mods.items():
            if side == "f64_nudged":
                out, a, s = mod.step()
            else:
                fu.reset_launches()
                if side == "planted":
                    bn.fn = make_plant(torch, sound_bn)
                try:
                    mod.forward_backward(data)
                    mod.update()
                finally:
                    bn.fn = sound_bn
                check(side == "cpu" or fu.LAUNCHES["sgd_fused_update"] == 1,
                      "%s vs f64: %d launches in one %s step"
                      % (label, fu.LAUNCHES["sgd_fused_update"], side))
                a, s = [{k: v.asnumpy() for k, v in d.items()}
                        for d in mod.get_params()]
                out = mod.get_outputs()[0].asnumpy()
            check(np.isfinite(out).all() and out.shape == out_shape,
                  "%s vs f64: %s outputs %s" % (label, side, out.shape,))
            changes = [(k, a[k] - a0[k], a_w[k] - a0[k], "w")
                       for k in a0] + [(k, v - x0[k], s_w[k] - x0[k], "s")
                                       for k, v in s.items()]
            zero = {k: float(np.sqrt(np.mean(np.square(got))))
                    for k, got, ref, _ in changes if exact_zero is not None
                    and np.sqrt(np.mean(np.square(ref))) <= exact_zero}
            dw = {k: rel_rms(got, ref) for k, got, ref, kind in changes
                  if kind == "w" and k not in zero}
            ds = {k: rel_rms(got, ref) for k, got, ref, kind in changes
                  if kind == "s" and k not in zero}
            row[side] = {"out_rel": rel_rms(out, o_w), "dw": dw, "ds": ds,
                         "dw_max": max(dw.values()),
                         "dw_median": float(np.median(list(dw.values()))),
                         "dw_worst": max(dw, key=dw.get),
                         "ds_max": max(ds.values(), default=0.0),
                         "ds_worst": max(ds, key=ds.get, default=None),
                         "zero_keys": len(zero),
                         "zero_max": max(zero.values(), default=0.0)}
        rows.append(row)
        log("%s vs f64 (batch %d) step %d (witness %.1fs): %s" % (
            label, x.shape[0], step, row["witness_s"], "; ".join(
                "%s outputs %.2e, weight change median %.2e max %.2e (%s), "
                "moving-stat change max %.2e (%s)"
                % (side, r["out_rel"], r["dw_median"], r["dw_max"],
                   r["dw_worst"], r["ds_max"], r["ds_worst"])
                for side, r in ((k, row[k]) for k in sides))))
    return rows


def resnet_misses(side, cpu, step, floor=0.0):
    """The phase-14 limits ``side``'s errors (a ``resnet_vs_f64`` row
    entry) exceed at ``step``, against the CPU's float32 ``cpu``; no
    ratio limit is below ``floor``."""
    misses = []
    if step == 1:       # forward only: outputs and batch statistics
        if side["out_rel"] > RESNET_OUT_TOL:
            misses.append("outputs %.3g > %g" % (side["out_rel"],
                                                  RESNET_OUT_TOL))
        if side["ds_max"] > RESNET_DSTAT_TOL:
            misses.append("%s's change %.3g > %g" % (
                side["ds_worst"], side["ds_max"], RESNET_DSTAT_TOL))
        keys = ("dw_median", "dw_max")
    else:
        keys = ("out_rel", "dw_median", "dw_max", "ds_max")
    for k in keys:
        if side[k] > max(RESNET_RATIO_TOL * cpu[k], floor):
            misses.append("%s %.3g > %g x the CPU's %.3g" % (
                k, side[k], RESNET_RATIO_TOL, cpu[k]))
    return misses


def resnet_vs_cpu(torch, mx, fu):
    """Phase 14: ResNet-50 on the card against the CPU's float64
    witness, two chained steps at batch 2 (``resnet_vs_f64``), beside the
    CPU's own float32 run and a nudged witness: the card must keep within
    the limits of ``resnet_misses`` at every step, and the planted
    BatchNorm fault must not."""
    rows = resnet_vs_f64(torch, mx, fu)
    planted = []
    for row in rows:
        misses = resnet_misses(row["dev"], row["cpu"], row["step"])
        check(not misses, "resnet vs f64 step %d: the card is off: %s"
              % (row["step"], "; ".join(misses)))
        planted += resnet_misses(row["planted"], row["cpu"], row["step"])
        log("resnet vs f64 step %d: card/CPU error ratios: %s; planted: %s"
            % (row["step"], ", ".join(
                "%s %.2f" % (k, row["dev"][k] / max(row["cpu"][k], 1e-30))
                for k in ("out_rel", "dw_median", "dw_max", "ds_max")),
               ", ".join("%s %.2f" % (k, row["planted"][k]
                                      / max(row["cpu"][k], 1e-30))
                         for k in ("out_rel", "dw_median", "dw_max",
                                   "ds_max"))))
    log("resnet vs f64: the planted BatchNorm fault misses %s"
        % (planted or "nothing"))
    check(planted, "resnet vs f64: the planted BatchNorm fault passes")
    return [{"step": row["step"], "witness_s": row["witness_s"],
             **{side: {k: v for k, v in r.items() if k not in ("dw", "ds")}
                for side, r in row.items() if isinstance(r, dict)}}
            for row in rows]


# ---------------------------------------------------------------------------
# phases 15-18: int8 quantized serving of ResNet-50 and its two kernels
# ---------------------------------------------------------------------------

INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core peak
SERVE_BATCH = 32        # benchmark.py infer_quantized: ResNet-50, batch 32
SERVE_IMAGE = (3, 224, 224)
SERVE_CLIENTS = 16      # client threads; 64 one-image requests (16 images
SERVE_IMAGES = 16       # x 4) and 4 requests of 4 rows
SERVE_WINDOW_S = 6.0    # each timed closed-loop serving window; two a
                        # Predictor, int8 and fp32 in turn
INT8_OUT_TOL = 1e-3     # card vs CPU, whole int8 forward, relative RMS:
                        # an activation whose scaled value lies within an
                        # ulp of a rounding boundary, where a card's fp32
                        # layer rounds otherwise than the CPU's (the global
                        # average pool sums in another order; BatchNorm
                        # and the residual adds round alike), moves one
                        # int8 step


def graph_layers(mx, op, batch, sym=None, image=SERVE_IMAGE):
    """[(node, its data input's shape, {argument: shape})] of every
    ``op`` node of ResNet-50 (or ``sym``) at ``batch``, in graph order,
    from the port's shape inference."""
    from mxnet_tpu_torch.symbol.symbol import _topo
    if sym is None:
        sym = resnet_symbol(mx)
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(data=(batch,) + image)
    shapes = dict(zip(internals.list_outputs(), outs))
    args = dict(zip(sym.list_arguments(),
                    sym.infer_shape(data=(batch,) + image)[0]))
    layers = []
    for node in _topo(sym._entries):
        if node.op == op:
            src = node.inputs[0][0]
            layers.append((node, tuple(shapes[src.name if src.is_var
                                              else src.name + "_output"]),
                           args))
    return layers


def int8_conv_layers(mx, batch, sym=None, image=SERVE_IMAGE):
    """Every Convolution of ResNet-50 (or ``sym``) at ``batch``, in graph
    order: (name, data shape, weight shape, stride, dilate, pad,
    groups)."""
    layers = []
    for node, shape, args in graph_layers(mx, "Convolution", batch, sym,
                                          image):
        a = node.attrs
        nd = len(a["kernel"])
        layers.append((node.name, shape,
                       tuple(args[node.inputs[1][0].name]),
                       tuple(a.get("stride") or (1,) * nd),
                       tuple(a.get("dilate") or (1,) * nd),
                       tuple(a.get("pad") or (0,) * nd),
                       int(a.get("num_group", 1))))
    return layers


def bn_layers(mx, batch, sym=None, image=SERVE_IMAGE):
    """Every BatchNorm of ResNet-50 (or ``sym``) at ``batch``, in graph
    order: (name, data shape, fix_gamma, eps)."""
    return [(node.name, shape, bool(node.attrs.get("fix_gamma", True)),
             float(node.attrs.get("eps", 1e-3)))
            for node, shape, _ in graph_layers(mx, "BatchNorm", batch, sym,
                                               image)]


def distinct_rows(layers):
    """[(shape key, count)] of ``int8_conv_layers`` or ``bn_layers``
    rows, first-seen order; the key is the row without its name."""
    counts = {}
    for row in layers:
        counts[row[1:]] = counts.get(row[1:], 0) + 1
    return list(counts.items())


def conv_cost(key):
    """(operations, bytes, M, N, K) of one int8 convolution: 2*M*N*K
    int8 operations; the int8 input, the int8 weights and the f32 output,
    each once."""
    (b, c, h, w), (co, cg, kh, kw), st, dl, pd, g = key
    oh = (h + 2 * pd[0] - (dl[0] * (kh - 1) + 1)) // st[0] + 1
    ow = (w + 2 * pd[1] - (dl[1] * (kw - 1) + 1)) // st[1] + 1
    m, k = b * oh * ow, cg * kh * kw
    return (2.0 * m * co * k, b * c * h * w + co * cg * kh * kw
            + 4 * m * co, m, co, k)


def bound_ms(ops, nbytes):
    t_ops, t_bytes = ops / INT8_OPS, nbytes / HBM_BPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def int8_inputs(torch, rng, key, dev):
    (b, c, h, w), wshape, st, dl, pd, g = key
    q = torch.from_numpy(rng.randint(-127, 128, (b, c, h, w)).astype(
        np.int8)).to(dev)
    wq = torch.from_numpy(rng.randint(-127, 128, wshape).astype(
        np.int8)).to(dev)
    s = torch.from_numpy(rng.rand(wshape[0]).astype(np.float32) * 0.1
                         + 1e-3).to(dev)
    return q, wq, s


def _routed(i8, kind, fn):
    """``fn()`` and the routes of ``kind`` that it launched (from the
    per-route counts)."""
    before = dict(i8.ROUTES[kind])
    out = fn()
    return out, [r for r, n in i8.ROUTES[kind].items() if n != before[r]]


def _in_format(torch, t, fmt):
    return t.contiguous(memory_format=torch.channels_last
                        if fmt == "channels_last" else torch.contiguous_format)


def int8_conv_cases(mx):
    """Phase 15's convolutions: every distinct conv shape of ResNet-50 at
    batch 1 and 32, groups 2 and 32, a dilated case, odd H/W tails, a
    1 x 1 input (one position an image), 8 output channels, and 200
    (not a multiple of 64)."""
    convs = []
    for batch in (1, SERVE_BATCH):
        convs += [key for key, _ in distinct_rows(int8_conv_layers(mx,
                                                                    batch))]
    return convs + [
        ((2, 64, 14, 14), (64, 32, 3, 3), (1, 1), (1, 1), (1, 1), 2),
        ((2, 64, 10, 10), (64, 2, 3, 3), (1, 1), (1, 1), (1, 1), 32),
        ((2, 64, 15, 13), (32, 64, 3, 3), (1, 1), (2, 2), (2, 2), 1),
        ((3, 24, 17, 23), (40, 24, 5, 3), (2, 3), (1, 1), (2, 1), 1),
        ((3, 96, 17, 23), (40, 96, 5, 3), (2, 3), (1, 1), (2, 1), 1),
        ((1, 32, 1, 1), (16, 32, 3, 3), (1, 1), (1, 1), (1, 1), 1),
        ((2, 64, 3, 2), (8, 64, 1, 1), (1, 1), (1, 1), (0, 0), 1),
        ((3, 128, 5, 5), (200, 128, 3, 3), (2, 2), (1, 1), (1, 1), 1)]


# (m, k, n) of phase 15's matmuls: ragged (mma.sync), small and large m
# on the wgmma route, ResNet-50's FC at m 1, 8, 32, and a misaligned x
INT8_MATMULS = [(1, 8, 4), (5, 37, 11), (16, 256, 64), (200, 512, 130),
                (1, 2048, 1000), (8, 2048, 1000), (32, 2048, 1000)]


def check_int8(torch, mx, i8):
    """Phase 15: both int8 kernels against their plain versions on the
    card, bitwise, each on the route the wrapper's route function picks
    for it, asserted from the per-route launch counts: ``int8_matmul`` at
    INT8_MATMULS (zero-scale channels at (16, 256, 64)) and with x 1 byte
    off alignment; ``int8_conv_im2col`` at ``int8_conv_cases``, each with
    q and wq in channels-last memory and again contiguous. The split-K FC
    twice, bitwise equal. Then planted faults that must fail: the scale
    table shifted by one channel and the last 32-deep K chunk dropped
    (the FC, and the stem on the mma.sync route), one K slice of the
    split-K FC dropped, one tap of a 3x3 conv zeroed (wgmma route)."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(15)
    rows = []

    def hold(kind, shape, route, got, ref):
        torch.cuda.synchronize()
        same, err = torch.equal(got, ref), max_err(got, ref)
        rows.append({"kernel": kind, "shape": str(shape), "route": route,
                     "bitwise": same, "max_abs_err": err})
        check(same, "%s %s (%s) differs from its plain version (max abs "
              "err %g)" % (kind, shape, route, err))

    fc = None
    for m, k, n in INT8_MATMULS + [(9, 64, 24)]:
        x = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(
            np.int8)).to(dev)
        if (m, k) == (9, 64):           # x 1 byte off alignment
            x = torch.empty(m * k + 1, dtype=torch.int8,
                            device=dev)[1:].view(m, k).copy_(x)
        w = torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(
            np.int8)).to(dev)
        s = torch.from_numpy(rng.rand(n).astype(np.float32) * 0.1).to(dev)
        if (m, k) == (16, 256):
            s[::7] = 0.0                # zero-scale channels
        want = i8.matmul_route(m, n, k, x.data_ptr() % 16 == 0)
        got, routes = _routed(i8, "int8_matmul",
                              lambda: i8.int8_matmul(x, w, s))
        check(routes == [want[0]], "int8_matmul %s launched %s, its route "
              "is %s" % ((m, k, n), routes, want[0]))
        hold("int8_matmul", (m, k, n) + want[1:], want[0], got,
             i8._int8_matmul_plain(x, w, s))
        if (m, k) == (16, 256):
            check(bool((got[:, ::7] == 0).all()), "zero-scale channels "
                  "are not exact zeros")
        if (m, k, n) == (32, 2048, 1000):
            check(want[2] > 1 and -(-n // 64) * want[2] >= 128,
                  "the FC's split-K grid has %d slices" % want[2])
            again = i8.int8_matmul(x, w, s)
            torch.cuda.synchronize()
            check(torch.equal(got, again), "two runs of the split-K FC "
                  "differ")
            rows.append({"repeat": "int8_matmul split-K FC", "bitwise":
                         True})
            fc = (x, w, s, got, want)
    stem = tap = None
    routes_seen = {"wgmma": 0, "mma_sync": 0}
    for key in int8_conv_cases(mx):
        q0, wq0, s = int8_inputs(torch, rng, key, dev)
        args = key[2:]
        for fmt in ("channels_last", "contiguous"):
            q, wq = _in_format(torch, q0, fmt), _in_format(torch, wq0, fmt)
            # (a 1 x 1 input's memory is channels-last either way)
            want = i8.conv_route(q.shape, wq.shape, *args,
                                 channels_last=q.is_contiguous(
                                     memory_format=torch.channels_last))
            got, routes = _routed(i8, "int8_conv_im2col", lambda:
                                  i8.int8_conv_im2col(q, wq, s, *args))
            check(routes == [want[0]], "int8_conv_im2col %s (%s) launched "
                  "%s, its route is %s" % (key, fmt, routes, want[0]))
            routes_seen[want[0]] += 1
            hold("int8_conv_im2col", key + (fmt,), want[0], got,
                 i8._int8_conv_plain(q, wq, s, *args))
            if stem is None:
                stem = (q, wq, s, args, got)   # ResNet-50's 7x7 stem
            if tap is None and want[0] == "wgmma" and key[1][2:] == (3, 3):
                tap = (q, wq, s, args, got)
    check(tap is not None, "no 3x3 conv took the wgmma route")
    log("check int8: %d int8_matmul and %d int8_conv_im2col cases (convs: "
        "%d wgmma, %d mma_sync), all bitwise equal to their plain versions "
        "on the route their route function picks" % (
            sum(r.get("kernel") == "int8_matmul" for r in rows),
            sum(r.get("kernel") == "int8_conv_im2col" for r in rows),
            routes_seen["wgmma"], routes_seen["mma_sync"]))
    # planted faults: the references a broken kernel would match
    x, w, s, got, (_, bn, splits) = fc
    per = -(-w.shape[1] // i8.WG_BK) // splits * i8.WG_BK
    faults = [
        ("int8_matmul", "scale table shifted by one channel", got,
         i8._int8_matmul_plain(x, w, torch.roll(s, 1))),
        ("int8_matmul", "last K chunk dropped", got,
         i8._int8_matmul_plain(x, _drop_last_chunk(w), s)),
        ("int8_matmul", "one K slice of the split-K FC dropped", got,
         i8._int8_matmul_plain(x, _zero_k(w, per, 2 * per), s))]
    q, wq, s, args, got = stem
    faults += [
        ("int8_conv_im2col", "stem, scale table shifted by one channel",
         got, i8._int8_conv_plain(q, wq, torch.roll(s, 1), *args)),
        ("int8_conv_im2col", "stem, last K chunk dropped", got,
         i8._int8_conv_plain(q, _drop_last_chunk(wq), s, *args))]
    q, wq, s, args, got = tap
    wz = wq.clone()
    wz[:, :, 1, 2] = 0
    faults.append(("int8_conv_im2col", "one tap of a 3x3 conv zeroed (%s)"
                   % (tuple(q.shape),), got,
                   i8._int8_conv_plain(q, wz, s, *args)))
    for kind, label, got, ref in faults:
        same = torch.equal(got, ref)
        log("planted fault (%s, %s): bitwise %s, max abs err %.3g"
            % (kind, label, same, max_err(got, ref)))
        check(not same, "planted fault (%s) passes the %s check"
              % (label, kind))
        rows.append({"planted": "%s: %s" % (kind, label), "bitwise": same})
    return rows


def _zero_k(w, k0, k1):
    """``w`` (n, k) with columns k0..k1 zeroed: what a split-K kernel
    that lost one slice would compute."""
    w = w.clone()
    w[:, k0:k1] = 0
    return w


def bn_inputs(torch, rng, shape, dev, offset=0):
    """x (at ``offset`` floats into its buffer), gamma, beta, mean, var:
    float32 on ``dev``."""
    c = shape[1]
    buf = torch.empty(int(np.prod(shape)) + offset, device=dev)
    x = buf[offset:].view(shape)
    x.copy_(torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3 + 1))
    params = [rng.rand(c) + 0.5, rng.randn(c), rng.randn(c),
              rng.rand(c) * 2 + 0.1]
    return [x] + [torch.from_numpy(p.astype(np.float32)).to(dev)
                  for p in params]


def check_bn(torch, mx, bnk):
    """Phase 15, the inference BatchNorm kernel: bitwise equal to its
    plain version at every distinct BatchNorm shape of ResNet-50 at batch
    1 and 32 (``fix_gamma`` as the graph has it), and at a misaligned
    input, a 2-D input and odd planes; then two planted faults (the mean
    shifted by one channel, ``eps`` dropped) that must fail."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(25)
    cases = []
    for batch in (1, SERVE_BATCH):
        cases += [key + (0,) for key, _ in distinct_rows(bn_layers(mx,
                                                                   batch))]
    cases += [((3, 5, 7, 9), False, 1e-3, 1), ((7, 10), True, 1e-3, 0),
              ((2, 6, 3, 5), False, 2e-5, 3)]
    rows = []
    for shape, fix_gamma, eps, offset in cases:
        ins = bn_inputs(torch, rng, shape, dev, offset)
        got = bnk.batch_norm_inference(*ins, eps, fix_gamma)
        ref = bnk._batch_norm_inference_plain(*ins, eps, fix_gamma)
        torch.cuda.synchronize()
        same, err = torch.equal(got, ref), max_err(got, ref)
        rows.append({"kernel": "batch_norm_inference", "shape": str(shape),
                     "fix_gamma": fix_gamma, "offset": offset,
                     "bitwise": same, "max_abs_err": err})
        check(same, "batch_norm_inference %s differs from its plain version "
              "(max abs err %g)" % (shape, err))
    log("check batch_norm_inference: %d shapes, all bitwise equal to the "
        "plain version" % len(cases))
    # planted faults: the references a broken kernel would match
    x, g, b, m, v = ins
    for label, ref in (
            ("mean shifted by one channel", bnk._batch_norm_inference_plain(
                x, g, b, torch.roll(m, 1), v, eps, fix_gamma)),
            ("eps dropped", bnk._batch_norm_inference_plain(
                x, g, b, m, v, 0.0, fix_gamma))):
        same = torch.equal(got, ref)
        log("planted fault (batch_norm_inference, %s): bitwise %s, max abs "
            "err %.3g" % (label, same, max_err(got, ref)))
        check(not same, "planted fault (%s) passes the batch_norm_inference "
              "check" % label)
        rows.append({"planted": "batch_norm_inference: " + label,
                     "bitwise": same})
    return rows


def time_bn(torch, mx, bnk, timer):
    """Phase 16, the inference BatchNorm kernel at ResNet-50's batch-32
    shapes, per distinct shape and summed over a forward's 51 BatchNorms,
    L2 flushed and a 1 ms device-side hold before every launch (the
    wrapper's host side outlasts the flush): beside it the bound (x read
    and y written once, and the four (c,) parameters, over 3.35 TB/s),
    the plain version and ``F.batch_norm(training=False)``, the library
    call that computes the same function (not the same bits).
    max_abs_err: the timed kernel's output against the plain version's
    on the same inputs."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    rng = np.random.RandomState(26)
    layers = bn_layers(mx, SERVE_BATCH)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    err, shapes = 0.0, []
    for (shape, fix_gamma, eps), count in distinct_rows(layers):
        x, g, b, m, v = bn_inputs(torch, rng, shape, dev)
        gl = torch.ones_like(g) if fix_gamma else g
        nbytes = 8 * x.numel() + 16 * shape[1]
        row = {"shape": str(shape), "count": count,
               "ms": timer(lambda: bnk.batch_norm_inference(
                   x, g, b, m, v, eps, fix_gamma), hold_ms=1.0),
               "plain_ms": timer(lambda: bnk._batch_norm_inference_plain(
                   x, g, b, m, v, eps, fix_gamma), hold_ms=1.0),
               "library_ms": timer(lambda: F.batch_norm(
                   x, m, v, gl, b, training=False, eps=eps), hold_ms=1.0),
               "bound_ms": nbytes / HBM_BPS * 1e3}
        got = bnk.batch_norm_inference(x, g, b, m, v, eps, fix_gamma)
        ref = bnk._batch_norm_inference_plain(x, g, b, m, v, eps, fix_gamma)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), "batch_norm_inference %s differs from "
              "its plain version" % (shape,))
        err = max(err, max_err(got, ref))
        for f in tot:
            tot[f] += count * row[f]
        shapes.append(row)
        log("time batch_norm_inference %s x%d: ms=%.4f plain_ms=%.4f "
            "library_ms=%.4f bound_ms=%.4f (bytes) %.0f GB/s"
            % (shape, count, row["ms"], row["plain_ms"], row["library_ms"],
               row["bound_ms"], nbytes / (row["ms"] * 1e-3) / 1e9))
        del x, got, ref
    row = dict(tot, name="batch_norm_inference", bound_by="bytes",
               max_abs_err=err, shapes=shapes,
               shape="ResNet-50 batch 32: the 51 BatchNorms of a forward")
    log("time batch_norm_inference %s: ms=%.4f plain_ms=%.4f "
        "library_ms=%.4f bound_ms=%.4f (bytes) max_abs_err=%.3g"
        % (row["shape"], row["ms"], row["plain_ms"], row["library_ms"],
           row["bound_ms"], err))
    return row


def _drop_last_chunk(w):
    """``w`` with the last 32-deep chunk of its contraction (K in the
    (cin, kh, kw) order) zeroed: what a kernel that skipped its last
    stage would compute."""
    flat = w.reshape(w.shape[0], -1).clone()
    flat[:, 32 * ((flat.shape[1] - 1) // 32):] = 0
    return flat.reshape(w.shape)


def _held(torch, got, ref, what):
    """max abs error of ``got`` against ``ref``, which must be bitwise
    equal (the int8 kernels against their plain versions)."""
    torch.cuda.synchronize()
    err = max_err(got, ref)
    check(torch.equal(got, ref), "%s differs from its plain version (max "
          "abs err %g)" % (what, err))
    return err


def _mma_sync_matmul(torch, i8, x, w, s):
    """The FC on the mma.sync route (the first design), which the wrapper
    no longer picks for it: the library's entry called directly, counted
    nowhere (a yardstick, as the plain version)."""
    from mxnet_tpu_torch.ops.cuda import _build
    out = torch.empty((x.shape[0], w.shape[0]), dtype=torch.float32,
                      device=x.device)
    lib = _build.load("int8_matmul", i8._SYMBOLS["int8_matmul"])
    err = lib.int8_matmul(x.data_ptr(), w.data_ptr(), s.data_ptr(),
                          out.data_ptr(), x.shape[0], w.shape[0], x.shape[1],
                          torch.cuda.current_stream().cuda_stream)
    check(err == 0, "int8_matmul mma.sync launch failed (%d)" % err)
    return out


def host_us(torch, fn, n=1000, reps=3):
    """Host microseconds a call of ``fn`` (a wrapper that launches one
    kernel): the least over ``reps`` runs of ``n`` calls enqueued back to
    back, each followed by a synchronise outside the clock (the host's
    clock varies with its other load)."""
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        best = t if best is None else min(best, t)
    return best


def time_int8(torch, mx, i8, timer):
    """Phase 16: both kernels at the batch-32 shapes, L2 flushed and a
    0.5 ms device-side hold before every launch (the wrappers' host side
    may outlast the flush): ``int8_conv_im2col`` per distinct conv shape of
    ResNet-50 and summed over one forward's 53 convolutions, with q and
    wq in channels-last memory as quantized serving gives them (the route
    each takes is recorded), ``int8_matmul`` at the FC (32 x 2048 x 1000).
    Beside each: the bound (max of the int8 operations over 1979 TOP/s
    and the bytes over 3.35 TB/s) and the share of it reached, the plain
    version's time, the first design's (the mma.sync route: the conv on
    contiguous inputs, the FC through its entry) and, for the matmul,
    ``torch._int_mm`` followed by the scale multiply. No single PyTorch
    call computes an int8 convolution on the card, so the conv's
    library_ms is null; ``int_mm_patch_ms`` is ``torch._int_mm`` over a
    prebuilt patch matrix (the explicit im2col, built untimed) for the
    shapes it takes (K and N multiples of 8: all but the stem). Then the
    host microseconds a wrapper call takes on each route (the FC aligned
    and with x 1 byte off; the first 3x3 conv channels-last and
    contiguous). max_abs_err: each timed kernel's output against its
    plain version's on the same inputs (bitwise, so 0)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    rng = np.random.RandomState(16)
    layers = int8_conv_layers(mx, SERVE_BATCH)
    check(len(layers) == 53, "ResNet-50 has %d convolutions, not 53"
          % len(layers))
    shapes, err = [], 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
           "bytes_ms": 0.0, "mma_sync_ms": 0.0, "int_mm_patch_ms": 0.0,
           "int_mm_shapes": 0}
    conv3 = None
    for key, count in distinct_rows(layers):
        q0, wq0, s = int8_inputs(torch, rng, key, dev)
        q = q0.contiguous(memory_format=torch.channels_last)
        wq = wq0.contiguous(memory_format=torch.channels_last)
        args = key[2:]
        (got, routes) = _routed(i8, "int8_conv_im2col", lambda:
                                i8.int8_conv_im2col(q, wq, s, *args))
        err = max(err, _held(torch, got, i8._int8_conv_plain(q, wq, s,
                                                             *args),
                             "int8_conv_im2col %s" % (key,)))
        ops, nbytes, m, n, k = conv_cost(key)
        bms, by = bound_ms(ops, nbytes)
        row = {"shape": str(key), "count": count, "m": m, "n": n, "k": k,
               "route": routes[0],
               "ms": timer(lambda: i8.int8_conv_im2col(q, wq, s, *args),
                           hold_ms=0.5),
               "mma_sync_ms": timer(lambda: i8.int8_conv_im2col(q0, wq0, s,
                                                           *args),
                               hold_ms=0.5),
               "plain_ms": timer(lambda: i8._int8_conv_plain(q, wq, s,
                                                             *args),
                                 iters=3),
               "bound_ms": bms, "bound_by": by, "int_mm_patch_ms": None}
        row["share_of_bound"] = bms / row["ms"]
        if routes[0] == "wgmma" and key[1][2:] == (3, 3) and conv3 is None:
            conv3 = (q, wq, q0, wq0, s, args)
        if k % 8 == 0 and n % 8 == 0 and key[5] == 1:
            (kh, kw) = key[1][2:]
            patches = F.unfold(q0.float(), (kh, kw), dilation=args[1],
                               padding=args[2], stride=args[0])
            patches = patches.transpose(1, 2).reshape(m, k).to(
                torch.int8).contiguous()
            wmat = wq0.reshape(n, k)
            row["int_mm_patch_ms"] = timer(
                lambda: torch._int_mm(patches, wmat.t()).float() * s,
                hold_ms=0.5)
            tot["int_mm_patch_ms"] += count * row["int_mm_patch_ms"]
            tot["int_mm_shapes"] += count
            del patches
        shapes.append(row)
        for f in ("ms", "plain_ms", "bound_ms", "mma_sync_ms"):
            tot[f] += count * row[f]
        tot["ops_ms"] += count * ops / INT8_OPS * 1e3
        tot["bytes_ms"] += count * nbytes / HBM_BPS * 1e3
        log("time int8_conv_im2col %s x%d (%s): ms=%.4f mma_sync_ms=%.4f "
            "plain_ms=%.3f bound_ms=%.4f (%s) share %.3f %.1f TOP/s "
            "int_mm_patch_ms=%s"
            % (key, count, routes[0], row["ms"], row["mma_sync_ms"],
               row["plain_ms"], bms, by, row["share_of_bound"],
               ops / (row["ms"] * 1e-3) / 1e12,
               "%.4f" % row["int_mm_patch_ms"]
               if row["int_mm_patch_ms"] is not None else "n/a"))
        del q, wq, q0, wq0, s
    conv = {"name": "int8_conv_im2col",
            "shape": "ResNet-50 batch 32: the 53 convolutions of a forward",
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "mma_sync_ms": tot["mma_sync_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                         else "bytes"),
            "library_ms": None, "max_abs_err": err,
            "int_mm_patch_ms": tot["int_mm_patch_ms"],
            "int_mm_patch_convs": tot["int_mm_shapes"], "shapes": shapes}
    x = torch.from_numpy(rng.randint(-127, 128, (SERVE_BATCH, 2048)).astype(
        np.int8)).to(dev)
    w = torch.from_numpy(rng.randint(-127, 128, (1000, 2048)).astype(
        np.int8)).to(dev)
    s = torch.from_numpy(rng.rand(1000).astype(np.float32) * 0.1).to(dev)
    ops = 2.0 * SERVE_BATCH * 1000 * 2048
    nbytes = SERVE_BATCH * 2048 + 1000 * 2048 + 4 * SERVE_BATCH * 1000
    bms, by = bound_ms(ops, nbytes)
    _held(torch, _mma_sync_matmul(torch, i8, x, w, s),
          i8._int8_matmul_plain(x, w, s), "int8_matmul mma.sync (FC)")
    fc = {"name": "int8_matmul", "shape": "ResNet-50 FC: 32 x 2048 x 1000",
          "route": "wgmma",
          "ms": timer(lambda: i8.int8_matmul(x, w, s), hold_ms=0.5),
          "mma_sync_ms": timer(lambda: _mma_sync_matmul(torch, i8, x, w, s),
                          hold_ms=0.5),
          "plain_ms": timer(lambda: i8._int8_matmul_plain(x, w, s)),
          "library_ms": timer(
              lambda: torch._int_mm(x, w.t()).float() * s[None, :],
              hold_ms=0.5),
          "bound_ms": bms, "bound_by": by,
          "max_abs_err": _held(torch, i8.int8_matmul(x, w, s),
                               i8._int8_matmul_plain(x, w, s),
                               "int8_matmul (FC)")}
    fc["share_of_bound"] = bms / fc["ms"]
    # host microseconds a wrapper call, each route
    xu = torch.empty(x.numel() + 1, dtype=torch.int8,
                     device=dev)[1:].view(x.shape).copy_(x)
    q, wq, q0, wq0, cs, args = conv3
    host = {"int8_matmul": {
        "wgmma": host_us(torch, lambda: i8.int8_matmul(x, w, s)),
        "mma_sync": host_us(torch, lambda: i8.int8_matmul(xu, w, s))},
        "int8_conv_im2col": {
        "wgmma": host_us(torch, lambda: i8.int8_conv_im2col(q, wq, cs,
                                                             *args)),
        "mma_sync": host_us(torch, lambda: i8.int8_conv_im2col(q0, wq0, cs,
                                                                *args))},
        "torch_op": host_us(torch, lambda: torch.mul(s, 2.0))}
    for r in (conv, fc):
        r["host_us"] = host[r["name"]]
        log("time %-17s %s: ms=%.4f mma_sync_ms=%.4f plain_ms=%.3f "
            "library_ms=%s bound_ms=%.4f (%s) share %.3f max_abs_err=%.3g%s"
            % (r["name"], r["shape"], r["ms"], r["mma_sync_ms"],
               r["plain_ms"],
               "null" if r["library_ms"] is None
               else "%.4f" % r["library_ms"], r["bound_ms"], r["bound_by"],
               r["bound_ms"] / r["ms"], r["max_abs_err"],
               "; torch._int_mm over prebuilt patch matrices of %d of the "
               "53 convs: %.4f ms" % (r["int_mm_patch_convs"],
                                      r["int_mm_patch_ms"])
               if r is conv else ""))
    log("host us a wrapper call: int8_matmul wgmma %.2f, mma_sync %.2f; "
        "int8_conv_im2col wgmma %.2f, mma_sync %.2f; a one-op torch call "
        "%.2f" % (host["int8_matmul"]["wgmma"],
                  host["int8_matmul"]["mma_sync"],
                  host["int8_conv_im2col"]["wgmma"],
                  host["int8_conv_im2col"]["mma_sync"], host["torch_op"]))
    return [conv, fc]


def _int8_classes(names):
    """Classes of a profiled int8 forward's kernels, in launch order. The
    activation quantizer is four kernels launched in a row: the multiply
    by the act scale, the round, the clip, the cast to int8; the clip's
    kernel is also ReLU's, so a kernel belongs to the quantizer by its
    place around a round kernel, not by its name."""
    classes = []
    for name in names:
        low = name.lower()
        if "int8_conv" in low:
            cls = "int8_conv_im2col"
        elif "int8_matmul" in low:
            cls = "int8_matmul"
        elif "bn_inference_kernel" in low:
            cls = "batch_norm_inference"
        elif "memcpy" in low:
            cls = "input_copy"
        elif any(k in low for k in ("pool", "clamp", "threshold", "add",
                                    "mul", "binaryfunctor")):
            cls = "relu_pool_add"
        else:
            cls = "other"
        classes.append(cls)
    for i, name in enumerate(names):
        if "round_kernel" in name.lower():
            for j in range(max(0, i - 1), min(len(names), i + 3)):
                classes[j] = "act_quantize"
    return classes


def serve_traffic(eng, pool):
    """The correctness set: 64 one-image requests from SERVE_CLIENTS
    threads (thread t sends images (t + 3j) % 16, j = 0..3: every image 4
    times) and 4 requests of 4 rows (images 4r..4r+3, from threads 0-3
    after their singles). Returns per-request results and the image
    count (too few requests to time the server: see serve_window)."""
    import threading
    out, errors = {}, []
    lock = threading.Lock()

    def client(t):
        try:
            jobs = [((t + 3 * j) % SERVE_IMAGES,) for j in range(4)]
            if t < 4:
                jobs.append(tuple(range(4 * t, 4 * t + 4)))
            for j, idx in enumerate(jobs):
                res = eng.predict(pool[list(idx)])[0]
                with lock:
                    out[(t, j)] = (idx, res)
        except Exception as e:          # noqa: BLE001 (reported, fatal)
            with lock:
                errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "a client hung")
    check(not errors, "requests failed: %s" % errors[:3])
    check(len(out) == 68, "%d of 68 requests answered" % len(out))
    return {"results": out,
            "images": sum(len(v[0]) for v in out.values())}


def serve_window(eng, pool, seconds):
    """A timed closed loop: SERVE_CLIENTS threads each send one-image
    requests (thread t images (t + 3j) % 16), each waiting for its answer
    before the next, until ``seconds`` have passed. img/s over the wall
    from the first send to the last answer; p50/p99 over every
    request."""
    import threading
    lats = [[] for _ in range(SERVE_CLIENTS)]
    errors = []
    start = threading.Event()
    stop = [0.0]

    def client(t):
        start.wait()
        j = 0
        try:
            while time.perf_counter() < stop[0]:
                i = (t + 3 * j) % SERVE_IMAGES
                t0 = time.perf_counter()
                eng.predict(pool[i:i + 1])
                lats[t].append(time.perf_counter() - t0)
                j += 1
        except Exception as e:          # noqa: BLE001 (reported, fatal)
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    stop[0] = t0 + seconds
    start.set()
    for t in threads:
        t.join(timeout=seconds + 600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a client hung")
    check(not errors, "requests failed: %s" % errors[:3])
    lat = np.concatenate([np.array(l) for l in lats])
    return {"requests": int(lat.size), "wall_s": wall,
            "img_per_s": lat.size / wall,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3)}


def _per_image(served, classes):
    """image index -> list of its output rows over every request."""
    per = {}
    for idx, res in served["results"].values():
        check(res.shape == (len(idx), classes) and np.isfinite(res).all(),
              "output %s not finite of shape (%d, %d)" % (res.shape,
                                                          len(idx),
                                                          classes))
        check(np.allclose(res.sum(1), 1.0, atol=1e-4), "outputs are not "
              "probabilities")
        for i, r in zip(idx, res):
            per.setdefault(i, []).append(r)
    return per


def serve_int8(torch, mx, i8, bnk, workdir, dev, num_layers=50,
               image=SERVE_IMAGE, classes=1000, batch=SERVE_BATCH,
               window_s=SERVE_WINDOW_S):
    """Phase 17: int8 serving of ResNet-50 at full width on ``dev``:
    seeded Xavier weights (fit.py's initializer) -> model.save_checkpoint
    -> quantize_checkpoint(calib_mode="naive") over one seeded batch of
    32 (benchmark.py infer_quantized's calibration) -> QuantizedParams.load
    -> Predictor -> InferenceEngine(max_batch 32, batch_wait 2 ms),
    warmed; the fp32 Predictor of the same checkpoint under its own
    engine beside it. For each, the correctness set of ``serve_traffic``:
    every request answered, 53 + 1 int8 kernel launches (0 in fp32) and
    51 BatchNorm launches per executed batch (counts 0 just before, read
    just after), every repeat of an image bitwise equal (int8). Then
    timed closed-loop windows of ``window_s`` seconds, int8 and fp32 in
    turn (int8, fp32, fp32, int8), with the same launch checks: img/s
    and p50/p99 latency. The int8-vs-fp32 drift; one profiled batch-32
    int8 forward, and the input's upload timed by CUDA events. A smaller
    ``num_layers`` / ``image`` / ``window_s`` rehearses the phase on the
    CPU (no launches there)."""
    on_card = dev.type == "cuda"
    sym = mx.models.resnet(num_classes=classes, num_layers=num_layers,
                           image_shape=image)
    convs = int8_conv_layers(mx, 1, sym, image)
    n_convs = len(convs)
    # the convs whose shape the wgmma route takes: in serving their
    # activations and weights come channels-last, so they take it
    n_wgmma = sum(i8.conv_wgmma_shape_ok(*row[2:]) for row in convs)
    check(n_wgmma == n_convs - 1 or num_layers != 50, "%d of ResNet-50's "
          "convs take the wgmma route, not 52" % n_wgmma)
    n_bns = len(bn_layers(mx, 1, sym, image))
    os.makedirs(workdir, exist_ok=True)
    prefix = os.path.join(workdir, "resnet%d" % num_layers)
    t0 = time.perf_counter()
    mod = mx.mod.Module(sym, context=dev)
    mod.bind(data_shapes=[("data", (batch,) + image)],
             label_shapes=[("softmax_label", (batch,))], for_training=False)
    mx.random.seed(0)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    arg, aux = mod.get_params()
    mx.model.save_checkpoint(prefix, 0, sym, arg, aux)
    del mod, arg, aux
    t_ckpt = time.perf_counter() - t0
    calib = np.random.RandomState(0).randn(batch, *image).astype(np.float32)
    t0 = time.perf_counter()
    qp = mx.quantize.quantize_checkpoint(prefix, [calib], calib_mode="naive",
                                         ctx=dev)
    t_quant = time.perf_counter() - t0
    check(len(qp.meta) == n_convs + 1, "quantized %d layers, expected %d"
          % (len(qp.meta), n_convs + 1))
    qp = mx.quantize.QuantizedParams.load(qp.prefix)
    dev_type = None if on_card else 1
    cfg = mx.serve.ServeConfig(max_batch=batch, batch_wait_ms=2)
    pool = np.random.RandomState(17).randn(SERVE_IMAGES, *image).astype(
        np.float32)
    with open(prefix + "-0000.params", "rb") as f:
        fp32_blob = f.read()

    def counted(kind, eng, run):
        """``run()`` with every count 0 just before and read just after;
        checks the launches per executed batch on the card, and the int8
        kernels' routes: the FC and the wgmma-shaped convs on the wgmma
        route, the rest on mma.sync, no operand copied to another memory
        format."""
        snap0 = mx.telemetry.snapshot()
        i8.reset_launches()
        bnk.reset_launches()
        out = run()
        launches = dict(i8.LAUNCHES, **bnk.LAUNCHES)
        routes = {k: dict(v) for k, v in i8.ROUTES.items()}
        conversions = i8.CONVERSIONS["int8_conv_im2col"]
        batches = mx.telemetry.snapshot().get("serving/batches_total", 0) \
            - snap0.get("serving/batches_total", 0)
        if on_card:
            n = batches * (kind == "int8")
            want = {"int8_conv_im2col": n_convs * n, "int8_matmul": n,
                    "batch_norm_inference": n_bns * batches}
            check(batches >= 1 and launches == want,
                  "%s serving: launches %s over %d batches, expected %s"
                  % (kind, launches, batches, want))
            want = {"int8_conv_im2col": {"wgmma": n_wgmma * n,
                                         "mma_sync": (n_convs - n_wgmma) * n},
                    "int8_matmul": {"wgmma": n, "mma_sync": 0}}
            check(routes == want and conversions == 0, "%s serving: routes "
                  "%s and %d operand copies over %d batches, expected %s and "
                  "none" % (kind, routes, conversions, batches, want))
        return out, dict(launches, routes=routes,
                         conversions=conversions), batches

    runs, engines = {}, {}
    for kind in ("int8", "fp32"):
        pred = mx.serving.Predictor(
            *((qp.symbol_json, qp.param_bytes()) if kind == "int8"
              else (sym.tojson(), fp32_blob)),
            dev_type=dev_type, input_shapes={"data": (1,) + image})
        t0 = time.perf_counter()
        eng = engines[kind] = mx.serve.InferenceEngine(pred, cfg).start() \
            .warmup()
        t_warm = time.perf_counter() - t0
        check(eng.ready, "%s engine not ready after warmup" % kind)
        served, launches, batches = counted(kind, eng,
                                            lambda: serve_traffic(eng, pool))
        per = _per_image(served, classes)
        repeats_equal = all(all(np.array_equal(r, rs[0]) for r in rs)
                            for rs in per.values())
        # the same image alone, twice: the same bucket, the same bits
        alone = [eng.predict(pool[3:4])[0] for _ in range(2)]
        runs[kind] = {"correctness_set": {
            "requests": len(served["results"]), "images": served["images"],
            "batches": batches},
            "launches": launches, "warmup_s": t_warm,
            "repeats_bitwise": repeats_equal,
            "alone_bitwise": bool(np.array_equal(*alone)),
            "per_image": {i: rs[0] for i, rs in per.items()}, "windows": []}
        log("serve %s, correctness set: %d requests (%d images) answered in "
            "%d batches; launches %s; warmup %.2fs; repeats bitwise %s, "
            "alone twice bitwise %s"
            % (kind, len(served["results"]), served["images"], batches,
               launches, t_warm, repeats_equal, runs[kind]["alone_bitwise"]))
        if kind == "int8":
            check(runs[kind]["alone_bitwise"], "the same image alone twice "
                  "gave different int8 outputs")
            check(repeats_equal, "repeats of an image differ between "
                  "batches in the int8 path")
    for kind in ("int8", "fp32", "fp32", "int8"):
        win, launches, batches = counted(
            kind, engines[kind],
            lambda: serve_window(engines[kind], pool, window_s))
        win.update(batches=batches, launches=launches)
        runs[kind]["windows"].append(win)
        log("serve %s, timed window %d: %d requests in %.3fs: %.1f img/s, "
            "p50 %.2f ms, p99 %.2f ms; %d batches (%.1f images each)"
            % (kind, len(runs[kind]["windows"]), win["requests"],
               win["wall_s"], win["img_per_s"], win["p50_ms"], win["p99_ms"],
               batches, win["requests"] / max(batches, 1)))
    for kind in ("int8", "fp32"):
        r = runs[kind]
        r["img_per_s"] = sum(w["requests"] for w in r["windows"]) \
            / sum(w["wall_s"] for w in r["windows"])
        log("serve %s, %d timed windows: %.1f img/s (windows %s)"
            % (kind, len(r["windows"]), r["img_per_s"],
               ["%.1f" % w["img_per_s"] for w in r["windows"]]))
    if on_card:
        runs["int8"]["profiled_forward"] = profile_int8(
            torch, i8, bnk, engines["int8"]._bucket_pred(batch), dev, batch,
            image, n_convs, n_bns, n_wgmma)
    for eng in engines.values():
        eng.close()
    del engines, eng, pred
    # drift over the served probabilities and over the logits (the FC's
    # output, through Predictors of the graphs cut there)
    fc = [n for n in qp.meta if qp.meta[n]["op"] == "FullyConnected"][-1]
    logits = {}
    for kind, graph, blob in (
            ("int8", qp.symbol.get_internals()[fc + "_int8_output"],
             qp.param_bytes()),
            ("fp32", sym.get_internals()[fc + "_output"], fp32_blob)):
        pred = mx.serving.Predictor(
            graph.tojson(), blob, dev_type=dev_type,
            input_shapes={"data": (SERVE_IMAGES,) + image})
        pred.set_input("data", pool.tobytes())
        pred.forward()
        logits[kind] = np.frombuffer(pred.get_output(0), np.float32).reshape(
            SERVE_IMAGES, classes)
    drift = {}
    for what, a, b in (
            ("probabilities",
             np.stack([runs["int8"]["per_image"][i]
                       for i in range(SERVE_IMAGES)]),
             np.stack([runs["fp32"]["per_image"][i]
                       for i in range(SERVE_IMAGES)])),
            ("logits", logits["int8"], logits["fp32"])):
        drift[what] = {
            "max_abs": float(np.abs(a - b).max()),
            "rel_rms": rel_rms(a, b),
            "top1_agree": float((a.argmax(1) == b.argmax(1)).mean()),
            "fp32_abs_max": float(np.abs(b).max())}
        log("int8 vs fp32 %s over %d images: max abs %.3g (fp32 |max| "
            "%.3g), relative RMS %.3g, top-1 agreement %.3f"
            % (what, SERVE_IMAGES, drift[what]["max_abs"],
               drift[what]["fp32_abs_max"], drift[what]["rel_rms"],
               drift[what]["top1_agree"]))
    int8_rows = runs["int8"]["per_image"]
    for r in runs.values():
        del r["per_image"]
    return {"checkpoint_s": t_ckpt, "quantize_s": t_quant,
            "quantized_layers": len(qp.meta), "runs": runs,
            "drift": drift, "artifact": qp, "int8_rows": int8_rows,
            "fp32_blob": fp32_blob}


def profile_int8(torch, i8, bnk, pred, dev, batch, image, n_convs, n_bns,
                 n_wgmma):
    """One batch-32 int8 forward of the served bucket under torch.profiler
    (busy share and device ms by class, the input's upload included as
    the profiler records it; the conv's share of device time), and that
    upload alone, timed by CUDA events and by the host's clock: the
    executor's own copy of a pageable host array, five times, the
    median."""
    feed = np.random.RandomState(19).randn(batch, *image).astype(np.float32)
    i8.reset_launches()
    bnk.reset_launches()
    prof = profile_run(torch, lambda: [
        o.asnumpy() for o in pred._exe.forward(is_train=False, data=feed)],
        classify_seq=_int8_classes)
    check(dict(i8.LAUNCHES, **bnk.LAUNCHES) == {
        "int8_conv_im2col": n_convs, "int8_matmul": 1,
        "batch_norm_inference": n_bns} and i8.ROUTES == {
        "int8_conv_im2col": {"wgmma": n_wgmma, "mma_sync": n_convs - n_wgmma},
        "int8_matmul": {"wgmma": 1, "mma_sync": 0}},
        "profiled forward launched %s, %s, routes %s" % (
            i8.LAUNCHES, bnk.LAUNCHES, i8.ROUTES))
    dev_ms = sum(prof["device_ms"].values())
    prof["conv_share"] = prof["device_ms"].get("int8_conv_im2col", 0.0) \
        / dev_ms if dev_ms else None
    ev_ms, host_ms = [], []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.record()
        torch.as_tensor(feed).to(dev)
        e.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(s.elapsed_time(e))
    prof["upload"] = {"bytes": feed.nbytes,
                      "event_ms": float(np.median(ev_ms)),
                      "host_ms": float(np.median(host_ms))}
    log("int8 profiled batch-%d forward: wall %.4fs, device busy %s, %d "
        "kernels and copies, %.3f device ms, by class %s (conv share %s); "
        "the input's upload (%d bytes, pageable) alone: %.3f ms by CUDA "
        "events, %.3f ms by the host clock"
        % (batch, prof["wall_s"], "not measured" if prof["busy_share"] is None
           else "%.1f%%" % (100 * prof["busy_share"]), prof["kernels"],
           dev_ms,
           {k: round(v, 3) for k, v in sorted(prof["device_ms"].items())},
           "not measured" if prof["conv_share"] is None
           else "%.1f%%" % (100 * prof["conv_share"]),
           feed.nbytes, prof["upload"]["event_ms"],
           prof["upload"]["host_ms"]))
    for name, ms in prof["top_kernels_ms"]:
        log("int8 profiled forward: %8.3f ms  %s" % (ms, name))
    return prof


def int8_vs_cpu(torch, mx, qp, dev, batch=2, image=SERVE_IMAGE):
    """Phase 18: the int8 artifact on ``dev`` against the port on the CPU
    (plain versions) at batch 2. Each of the 54 quantized layers, given
    the card's input to it, must give the card's int8 activations and
    output bitwise on the CPU; the whole forward (the FC's logits and the
    served probabilities) within INT8_OUT_TOL relative RMS; the share of
    int8 activations that differ between the two independent forwards
    is printed."""
    from mxnet_tpu_torch.ops import registry as reg
    from mxnet_tpu_torch.ops.quantization_ops import _quantize_act
    from mxnet_tpu_torch.symbol.symbol import _topo
    x = np.random.RandomState(18).randn(batch, *image).astype(np.float32)
    internals = qp.symbol.get_internals()
    names = internals.list_outputs()
    types = {k: v.dtype for k, v in qp.arg_params.items()}

    def run(d):
        exe = internals.simple_bind(ctx=d, grad_req="null", type_dict=types,
                                    data=(batch,) + image)
        exe.copy_params_from(qp.arg_params, qp.aux_params,
                             allow_extra_params=True)
        return dict(zip(names, exe.forward(is_train=False, data=x)))

    t0 = time.perf_counter()
    card = run(dev)
    cpu = run(torch.device("cpu"))
    layers = [n for n in _topo(qp.symbol._entries)
              if n.op in ("_contrib_quantized_conv_int8",
                          "_contrib_quantized_fc_int8")]
    check(len(layers) == 54 or image != SERVE_IMAGE,
          "%d quantized layers, not 54" % len(layers))
    flips = total = 0
    for node in layers:
        src = node.inputs[0][0]
        src = src.name if src.is_var else src.name + "_output"
        attrs = {k: v for k, v in node.attrs.items()
                 if not k.startswith("__")}
        x_card = card[src]._data
        q_card = _quantize_act(x_card, attrs["act_scale"]).cpu()
        q_cpu = _quantize_act(x_card.cpu(), attrs["act_scale"])
        out_cpu = reg.get_op(node.op).fn(
            x_card.cpu(), *[qp.arg_params[n.name]._data
                            for n, _ in node.inputs[1:]], **attrs)
        out_card = card[node.name + "_output"]._data.cpu()
        check(torch.equal(q_card, q_cpu), "%s: int8 activations differ "
              "between the card and the CPU on the same input" % node.name)
        check(torch.equal(out_card, out_cpu), "%s: output differs between "
              "the card and the CPU on the same input (max abs err %g)"
              % (node.name, max_err(out_card, out_cpu)))
        q_chain = _quantize_act(cpu[src]._data, attrs["act_scale"])
        flips += int((q_card != q_chain).sum())
        total += q_chain.numel()
    errs = {}
    logits = layers[-1].name + "_output"
    for name in (logits, names[-1]):
        got = card[name].asnumpy()
        ref = cpu[name].asnumpy()
        check(np.isfinite(got).all(), "%s not finite on the card" % name)
        errs[name] = rel_rms(got, ref)
    res = {"layers": len(layers), "layers_bitwise": True,
           "rel_rms": errs, "flipped": flips, "activations": total,
           "flip_share": flips / total, "wall_s": time.perf_counter() - t0}
    log("int8 card vs CPU, batch %d: %d layers bitwise on the same inputs; "
        "whole forward relative RMS %s (tol %g); %d of %d int8 activations "
        "flipped (%.3g)"
        % (batch, len(layers), {k: "%.3g" % v for k, v in errs.items()},
           INT8_OUT_TOL, flips, total, flips / total))
    for name, err in errs.items():
        check(err <= INT8_OUT_TOL, "int8 forward %s: card vs CPU relative "
              "RMS %g > %g" % (name, err, INT8_OUT_TOL))
    return res


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU, f32
# ---------------------------------------------------------------------------

def path_vs_cpu(torch):
    from mxnet_tpu_torch.parallel.transformer import (
        PagedKVCache, TransformerConfig, init_kv_pages,
        init_transformer_params_np, transformer_decode_step,
        transformer_prefill_paged)
    cfg = TransformerConfig(dtype=torch.float32, **FULL)
    p_cpu = init_transformer_params_np(cfg, seed=0, device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 128))
    runs = {}
    with torch.inference_mode():
        for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
            kp, vp = init_kv_pages(cfg, 17, 16, device=dev)
            cache = PagedKVCache(kp, vp, torch.arange(
                1, 17, dtype=torch.int32, device=dev)[None], 16)
            logits, _ = transformer_prefill_paged(
                params, cache, torch.tensor(prompt, device=dev),
                torch.tensor([128], dtype=torch.int32, device=dev), cfg)
            runs[dev] = {"cache": cache, "logits": [logits.cpu()],
                         "params": params}
        # feed the CPU's greedy tokens to both so they stay in step
        for t in range(8):
            tok = int(torch.argmax(runs["cpu"]["logits"][-1][0]))
            for dev, run in runs.items():
                logits, _ = transformer_decode_step(
                    run["params"], run["cache"],
                    torch.tensor([tok], dtype=torch.int32, device=dev),
                    128 + t, cfg)
                run["logits"].append(logits.cpu())
    errs = []
    for lc, lg in zip(runs["cpu"]["logits"], runs["cuda"]["logits"]):
        check(bool(torch.isfinite(lg).all()), "non-finite logits on card")
        check(tuple(lg.shape) == (1, cfg.vocab_size), "logits shape %s"
              % (tuple(lg.shape),))
        errs.append(max_err(lg, lc))
    log("path: card vs CPU f32 logits, prefill + 8 steps: max abs err "
        "%s (tol %g)" % (["%.2e" % e for e in errs], PATH_TOL))
    check(max(errs) <= PATH_TOL, "card logits differ from the CPU's by "
          "%g > %g" % (max(errs), PATH_TOL))
    return errs


# ---------------------------------------------------------------------------
# phases 19-21: rtc, runtime-compiled CUDA kernels over NVRTC
# ---------------------------------------------------------------------------

# the runtime kernels phase 19 compiles; one source each, so each compile
# is timed on its own. doubler / addone are tests/test_custom_op_rtc.py's
# Pallas bodies in CUDA C, axpy the reference's example, scale_t a template
# reached through ``exports``, row_sum a reduction over dynamic shared
# memory (above the 48 KB default), sq_fwd / sq_bwd the scaled_square
# custom op of the same test, addone_short a planted fault (its bound drops
# the last element)
RTC_SOURCES = {
    "doubler": r'''
extern "C" __global__ void doubler(const float *x, float *y, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = x[i] * 2.0f;
}''',
    "addone": r'''
extern "C" __global__ void addone(const float *x, float *y, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = x[i] + 1.0f;
}''',
    "axpy": r'''
extern "C" __global__ void axpy(const float *x, float *y, float a, int n) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x)
        y[i] += a * x[i];
}''',
    "scale_t": r'''
template <typename T>
__global__ void scale_t(const T *x, T *y, T s, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = x[i] * s;
}''',
    "row_sum": r'''
extern "C" __global__ void row_sum(const float *x, float *y, int cols) {
    extern __shared__ float row[];
    const float *src = x + (size_t)blockIdx.x * cols;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) row[c] = src[c];
    __syncthreads();
    for (int c = threadIdx.x + blockDim.x; c < cols; c += blockDim.x)
        row[threadIdx.x] += row[c];
    __syncthreads();
    for (int w = blockDim.x / 2; w > 0; w /= 2) {
        if (threadIdx.x < w) row[threadIdx.x] += row[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) y[blockIdx.x] = row[0];
}''',
    "scaled_square": r'''
extern "C" __global__ void sq_fwd(const float *x, float *y, float s, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = x[i] * x[i] * s;
}
extern "C" __global__ void sq_bwd(const float *g, const float *x, float *dx,
                                  float s, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) dx[i] = g[i] * 2.0f * s * x[i];
}''',
    "addone_short": r'''
extern "C" __global__ void addone_short(const float *x, float *y, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n - 1) y[i] = x[i] + 1.0f;
}''',
}
RTC_SIGS = {
    "doubler": "const float *x, float *y, int n",
    "addone": "const float *x, float *y, int n",
    "addone_short": "const float *x, float *y, int n",
    "axpy": "const float *x, float *y, float a, int n",
    "scale_t<float>": "const float *x, float *y, float s, int n",
    "scale_t<double>": "const double *x, double *y, double s, int n",
    "row_sum": "const float *x, float *y, int cols",
    "sq_fwd": "const float *x, float *y, float s, int n",
    "sq_bwd": "const float *g, const float *x, float *dx, float s, int n",
}
RTC_AXPY_N = 1 << 26        # phase 20: 2^26 float32 elements
RTC_ROW_COLS = 16384        # row_sum: 64 KB of dynamic shared memory a row
RTC_ULP_TOL = 2.4e-7        # axpy against y.add_(x, alpha=a): NVRTC may
                            # contract a * x + y into one FMA (one rounding)
                            # where PyTorch rounds the product: 2 ulps
RTC_SUM_TOL = 2e-6          # row_sum against torch.sum: 16384 terms summed
                            # in another order (relative to the sum of |x|)


def _grid(n, block=256):
    return (-(-n // block), 1, 1), (block, 1, 1)


def rtc_modules(mx):
    """NVRTC compile of every source, timed: cold (a new source), then the
    same source again (the cached cubin)."""
    rtc = mx.rtc
    mods, times = {}, {}
    for name, src in RTC_SOURCES.items():
        exports = ("scale_t<float>", "scale_t<double>") \
            if name == "scale_t" else ()
        t0 = time.perf_counter()
        mods[name] = rtc.CudaModule(src, exports=exports)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = rtc.CudaModule(src, exports=exports)
        cached = time.perf_counter() - t0
        check(again._lowered == mods[name]._lowered, "rtc: %s cached module "
              "differs" % name)
        times[name] = {"cold_ms": cold * 1e3, "cached_ms": cached * 1e3}
    return mods, times


def _kernel(mods, name):
    mod = {"scale_t<float>": "scale_t", "scale_t<double>": "scale_t",
           "sq_fwd": "scaled_square", "sq_bwd": "scaled_square"}.get(
               name, name)
    return mods[mod].get_kernel(name, RTC_SIGS[name])


def _on_card(mx, torch, t):
    return mx.nd.NDArray(t.to("cuda").contiguous())


def check_rtc(torch, mx, mods):
    """Phase 19: every runtime kernel against its PyTorch expression on
    the card (bitwise where the arithmetic is the same operations, else
    the stated tolerance), a launch from a second thread, the errors that
    must raise, and the planted fault."""
    import ctypes
    import threading
    from mxnet_tpu_torch.ops.cuda import _nvrtc
    rtc = mx.rtc
    gen = torch.Generator().manual_seed(19)
    dev = mx.gpu(0)
    rows = []

    def rnd(*shape, dtype=torch.float32):
        return _on_card(mx, torch, torch.randn(*shape, generator=gen,
                                               dtype=dtype))

    def held(name, got, ref, tol=0.0, scale=None):
        err = max_err(got, ref)
        bound = tol * (float(ref.abs().max()) if scale is None else scale)
        rows.append({"kernel": name, "max_abs_err": err, "tol": bound,
                     "bitwise": tol == 0.0})
        check(err <= bound, "rtc: %s differs from its PyTorch expression by "
              "%g (tol %g)" % (name, err, bound))

    for n in (1, 1000, 4097, 1 << 20):
        x = rnd(n)
        for name, expr in (("doubler", lambda t: t * 2.0),
                           ("addone", lambda t: t + 1.0)):
            y = mx.nd.NDArray(torch.empty_like(x._data))
            _kernel(mods, name).launch([x, y, n], dev, *_grid(n))
            torch.cuda.synchronize()
            held("%s n=%d" % (name, n), y._data, expr(x._data))
        for name, dt in (("scale_t<float>", torch.float32),
                         ("scale_t<double>", torch.float64)):
            xd = rnd(n, dtype=dt)
            y = mx.nd.NDArray(torch.empty_like(xd._data))
            _kernel(mods, name).launch([xd, y, 0.75, n], dev, *_grid(n))
            torch.cuda.synchronize()
            held("%s n=%d" % (name, n), y._data, xd._data * 0.75)
        x, y = rnd(n), rnd(n)
        ref = y._data.clone().add_(x._data, alpha=1.5)
        _kernel(mods, "axpy").launch([x, y, 1.5, n], dev, (min(
            -(-n // 256), 1024), 1, 1), (256, 1, 1))
        torch.cuda.synchronize()
        held("axpy n=%d" % n, y._data, ref, RTC_ULP_TOL)
    for rows_n in (1, 7, 64):
        x = rnd(rows_n, RTC_ROW_COLS)
        y = mx.nd.NDArray(torch.empty(rows_n, device="cuda"))
        _kernel(mods, "row_sum").launch(
            [x, y, RTC_ROW_COLS], dev, (rows_n, 1, 1), (256, 1, 1),
            shared_mem=4 * RTC_ROW_COLS)
        torch.cuda.synchronize()
        held("row_sum %dx%d" % (rows_n, RTC_ROW_COLS), y._data,
             x._data.sum(dim=1), RTC_SUM_TOL,
             scale=float(x._data.abs().sum(dim=1).max()))
    # a launch from a second thread (which never touched CUDA): rtc makes
    # the device's primary context current; a raw driver launch without
    # it must fail
    x = rnd(4096)
    y = mx.nd.NDArray(torch.empty_like(x._data))
    k = _kernel(mods, "doubler")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}

    k.launch([x, y, 4096], dev, *_grid(4096))      # loads the function
    torch.cuda.synchronize()
    y._data.zero_()
    values = k._pack([x, y, 4096], torch.device("cuda", 0))
    params = (ctypes.c_void_p * 3)(*[ctypes.cast(ctypes.byref(v),
                                                 ctypes.c_void_p)
                                     for v in values])

    def worker():
        # first the raw driver launch, while this thread has no current
        # context; then rtc's launch, which makes it current
        rc = _nvrtc._driver().cuLaunchKernel(
            k._funcs[0][0], 16, 1, 1, 256, 1, 1, 0, ctypes.c_void_p(stream),
            params, None)
        out["raw"] = "launched" if rc == 0 else "CUDA error %d" % rc
        try:
            k.launch([x, y, 4096], dev, *_grid(4096))
            out["rtc"] = "ok"
        except Exception as e:              # reported below, then fatal
            out["rtc"] = repr(e)

    th = threading.Thread(target=worker)
    th.start()
    th.join()
    torch.cuda.synchronize()
    check(out["rtc"] == "ok", "rtc: a launch from a second thread failed: %s"
          % out["rtc"])
    held("doubler from a second thread", y._data, x._data * 2.0)
    check(out["raw"] != "launched", "rtc: a driver launch without the "
          "context in a second thread did not fail")
    raised = {"raw launch without the context": out["raw"]}
    # errors that must raise MXNetError, none reaching the card
    before = dict(rtc.LAUNCHES)
    bad_src = "extern \"C\" __global__ void broken(float *y) { y[0] = " \
        "undeclared_name; }"
    for what, fn, needle in (
            ("compile error", lambda: rtc.CudaModule(bad_src),
             "undeclared_name"),
            ("float64 array for float *", lambda: _kernel(
                mods, "doubler").launch([rnd(8, dtype=torch.float64), y, 8],
                                        dev, (1, 1, 1), (8, 1, 1)),
             "float64"),
            ("written array aliasing a const one", lambda: _kernel(
                mods, "axpy").launch([x, x, 1.0, 8], dev, (1, 1, 1),
                                     (8, 1, 1)), "shares memory"),
            ("CPU arrays", lambda: _kernel(mods, "doubler").launch(
                [mx.nd.array(np.ones(8, np.float32), ctx=mx.cpu()),
                 mx.nd.array(np.ones(8, np.float32), ctx=mx.cpu()), 8], dev,
                (1, 1, 1), (8, 1, 1)), "CUDA card")):
        try:
            fn()
            raised[what] = None
        except mx.MXNetError as e:
            raised[what] = str(e)
        check(raised[what] is not None and needle in raised[what],
              "rtc: %s did not raise MXNetError naming %r: %r"
              % (what, needle, raised[what]))
    check(rtc.LAUNCHES == before, "rtc: a refused launch was counted")
    # a launch error: more threads a block than the card takes
    try:
        _kernel(mods, "doubler").launch([x, y, 4096], dev, (2, 1, 1),
                                        (2048, 1, 1))
        raised["launch error"] = None
    except mx.MXNetError as e:
        raised["launch error"] = str(e)
    check(raised["launch error"] is not None
          and "cuLaunchKernel" in raised["launch error"],
          "rtc: a 2048-thread block did not raise: %r"
          % raised["launch error"])
    # the planted fault must fail the check
    n = 4097
    x = rnd(n)
    y = mx.nd.NDArray(torch.zeros(n, device="cuda"))
    _kernel(mods, "addone_short").launch([x, y, n], dev, *_grid(n))
    torch.cuda.synchronize()
    planted = max_err(y._data, x._data + 1.0)
    check(planted > 0, "rtc: the planted fault (last element dropped) "
          "passes")
    log("rtc: %d checks held (%d bitwise); raised: %s; planted fault "
        "max_abs_err %.3g" % (len(rows), sum(r["bitwise"] for r in rows),
                              {k: (v or "")[:80] for k, v in raised.items()},
                              planted))
    return {"checks": rows, "raised": raised, "planted_max_abs_err": planted}


def time_rtc(torch, mx, mods, timer):
    """Phase 20: axpy at 2^26 float32 elements, L2 flushed, beside its
    byte bound (12 bytes an element over 3.35 TB/s), the plain PyTorch
    expression (``y += a * x``: two kernels) and the one PyTorch call
    ``y.add_(x, alpha=a)``; and the host time of a ``launch`` of a
    one-element kernel against a one-element PyTorch op."""
    n = RTC_AXPY_N
    gen = torch.Generator(device="cuda").manual_seed(20)
    x = mx.nd.NDArray(torch.randn(n, device="cuda", generator=gen))
    y = mx.nd.NDArray(torch.randn(n, device="cuda", generator=gen))
    k = _kernel(mods, "axpy")
    dev = mx.gpu(0)
    grid = (132 * 16, 1, 1)            # grid-stride: 16 blocks an SM
    y0 = y._data.clone()
    k.launch([x, y, 0.5, n], dev, grid, (256, 1, 1))
    ref = y0.add_(x._data, alpha=0.5)
    err = max_err(y._data, ref)
    check(err <= RTC_ULP_TOL * float(ref.abs().max()),
          "rtc axpy at 2^26: max_abs_err %g" % err)
    ms = timer(lambda: k.launch([x, y, 0.5, n], dev, grid, (256, 1, 1)))
    plain_ms = timer(lambda: y._data.__iadd__(0.5 * x._data))
    lib_ms = timer(lambda: y._data.add_(x._data, alpha=0.5))
    one_x = mx.nd.NDArray(torch.ones(1, device="cuda"))
    one_y = mx.nd.NDArray(torch.ones(1, device="cuda"))
    t = one_y._data
    host = {}
    for what, fn in (("rtc_launch", lambda: k.launch(
            [one_x, one_y, 0.5, 1], dev, (1, 1, 1), (32, 1, 1))),
                     ("torch_op", lambda: t.add_(1.0))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        host[what] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    nbytes = 12 * n
    t_bytes, t_ops = nbytes / HBM_BPS, 2.0 * n / F32_FLOPS
    row = {"name": "rtc", "shape": "axpy, %d float32" % n, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "max_abs_err": err,
           "host_us_per_launch": host["rtc_launch"],
           "host_us_per_torch_op": host["torch_op"]}
    log("time rtc axpy %s ms=%.4f plain_ms=%.4f library_ms=%.4f "
        "bound_ms=%.4f (%s) %.0f GB/s; host us a launch: rtc %.2f, torch "
        "op %.2f; max_abs_err=%.3g"
        % (row["shape"], ms, plain_ms, lib_ms, row["bound_ms"],
           row["bound_by"], nbytes / (ms * 1e-3) / 1e9, host["rtc_launch"],
           host["torch_op"], err))
    return row


CUSTOM_SHAPE = (32, 256, 56, 56)    # a ResNet-50 activation (stage 1)


def rtc_custom_op(torch, mx, mods):
    """Phase 21: the scaled_square custom op with rtc kernels for its
    forward and backward, ``nd.Custom`` under ``autograd.record()`` then
    ``backward`` on a 32x256x56x56 float32 activation: the output and
    ``x.grad`` equal the PyTorch expression bitwise, in exactly 2 rtc
    launches."""
    fwd, bwd = _kernel(mods, "sq_fwd"), _kernel(mods, "sq_bwd")
    scale = 1.25

    @mx.operator.register("rtc_scaled_square")
    class _Prop(mx.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class _Op(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    n = in_data[0].size
                    fwd.launch([in_data[0], out_data[0], scale, n],
                               in_data[0].context, *_grid(n))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    n = in_data[0].size
                    bwd.launch([out_grad[0], in_data[0], in_grad[0], scale,
                                n], in_data[0].context, *_grid(n))
            return _Op()

    gen = torch.Generator(device="cuda").manual_seed(21)
    x = mx.nd.NDArray(torch.randn(CUSTOM_SHAPE, device="cuda",
                                  generator=gen))
    x.attach_grad()
    mx.rtc.reset_launches()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type="rtc_scaled_square")
    y.backward()
    torch.cuda.synchronize()
    launches = sum(mx.rtc.LAUNCHES.values())
    xt = x._data.detach()
    y_ref = xt * xt * scale
    g_ref = torch.ones_like(xt) * 2.0 * scale * xt
    errs = (max_err(y._data.detach(), y_ref), max_err(x.grad._data, g_ref))
    check(launches == 2, "custom op: %d rtc launches (%s), expected 2"
          % (launches, mx.rtc.LAUNCHES))
    check(errs == (0.0, 0.0), "custom op: output / x.grad differ from the "
          "PyTorch expression: %s" % (errs,))
    log("rtc custom op %s: output and x.grad bitwise, launches %s"
        % ("x".join(map(str, CUSTOM_SHAPE)), dict(mx.rtc.LAUNCHES)))
    return {"shape": CUSTOM_SHAPE, "launches": launches,
            "by_kernel": dict(mx.rtc.LAUNCHES), "max_abs_err": max(errs)}


# ---------------------------------------------------------------------------
# phases 22-23: Gluon training of model_zoo ResNet-50 v1
# ---------------------------------------------------------------------------

GLUON_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
GLUON_WARM, GLUON_TIMED = 8, 24
GLUON_FIRST_TOL = 1e-5  # hybridized vs eager first step: logits, loss
GLUON_STAT_TOL = 1e-6   # one step's statistics vs the host replay
GLUON_PLANT = 2.0       # phase 23's planted fault: BatchNorm's gamma
                        # gradient doubled


def gluon_flops(mx, net, side=224):
    """Training FLOP an image of the zoo net at ``side`` x ``side``: 2 x
    multiply-adds of every conv and FC at batch 1 (their shapes, by
    forward hooks), x3 for forward + backward."""
    from mxnet_tpu_torch.gluon.nn.conv_layers import _Conv
    macs = []

    def hook(block, inputs, out):
        w = block.weight.data()
        if isinstance(block, _Conv):
            macs.append(out.size * int(np.prod(w.shape[1:])))
        else:
            macs.append(out.size * w.shape[1])

    def attach(block):
        if isinstance(block, (_Conv, mx.gluon.nn.Dense)):
            block.register_forward_hook(hook)
        for child in block._children.values():
            attach(child)

    attach(net)
    with mx.autograd.predict_mode():
        net(mx.nd.array(np.zeros((1, 3, side, side), np.float32),
                        ctx=mx.gpu(0)))
    net.apply(lambda b: b._forward_hooks.clear())
    return 3 * 2 * sum(macs), len(macs)


def gluon_fit(torch, mx, fu, module_img_s):
    """Phase 22: ``gluon.model_zoo.vision.get_model("resnet50_v1",
    classes=1000)`` trained at full width on the card, eager and
    hybridized in the same call: two nets from one seeded state, batch
    32 of float32 3x224x224 (TF32 off), SoftmaxCrossEntropyLoss,
    ``Trainer("sgd", lr 0.1, momentum 0.9, wd 1e-4)`` each. The
    hybridized net's first step (its CUDA graphs' capture) gives the
    eager step's logits and loss within GLUON_FIRST_TOL; then GLUON_WARM
    warm steps each and four timed windows of GLUON_TIMED steps (eager,
    hybridized, hybridized, eager; host clock, synchronized at both
    ends). ``sgd_fused_update`` launches once a step in both modes and
    its plain version never; the hybridized CachedOp updated the moving
    statistics once a step, and one step's update equals a host-side
    replay of the momentum rule over that step's batch statistics; 4
    Adam steps (``adam_fused_update`` once each); one profiled step of
    each mode (kernels, busy share, host launches: a graph replay is
    one)."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.uniform(-1, 1, (RESNET_BATCH, 3, 224, 224)).astype(
        np.float32), ctx=mx.gpu(0))
    y = mx.nd.array(rng.randint(0, 1000, (RESNET_BATCH,)).astype(
        np.float32), ctx=mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    nets = {}
    for mode in ("eager", "hybridized"):
        mx.random.seed(22)
        net = mx.gluon.model_zoo.vision.get_model(
            "resnet50_v1", classes=1000, prefix="g22_")
        net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                      magnitude=2), ctx=mx.gpu(0))
        if mode == "eager":
            flop, n_layers = gluon_flops(mx, net)
        else:
            gluon_params_copy(nets["eager"][0], net)
            net.hybridize()
        nets[mode] = (net, mx.gluon.Trainer(net.collect_params(), "sgd",
                                            GLUON_OPT))
    params = nets["hybridized"][0].collect_params()
    n_trained = sum(p.grad_req != "null" for p in params.values())

    def run(mode, steps, trainer=None):
        net, default = nets[mode]
        for _ in range(steps):
            with mx.autograd.record():
                out = net(x)
                loss = loss_fn(out, y)
            loss.backward()
            (trainer or default).step(RESNET_BATCH)
        return out, loss

    plain_calls = [0]
    real_plain = fu._sgd_fused

    def spy(*args):
        plain_calls[0] += 1
        return real_plain(*args)

    fu._sgd_fused = spy
    windows, launches, first = [], {}, {}
    try:
        for mode in ("eager", "hybridized"):
            fu.reset_launches()
            t0 = time.perf_counter()
            out, loss = run(mode, 1)
            torch.cuda.synchronize()
            first[mode] = (out.asnumpy(), loss.asnumpy(),
                           time.perf_counter() - t0)
            run(mode, GLUON_WARM - 1)
            torch.cuda.synchronize()
            launches[mode + "_warm"] = fu.LAUNCHES["sgd_fused_update"]
        hyb_op = nets["hybridized"][0]._cached_op
        updates0 = hyb_op.stat_updates
        for mode in ("eager", "hybridized", "hybridized", "eager"):
            fu.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, loss = run(mode, GLUON_TIMED)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            windows.append({"mode": mode, "s": dt,
                            "img_per_s": RESNET_BATCH * GLUON_TIMED / dt,
                            "ms_per_step": dt * 1e3 / GLUON_TIMED,
                            "launches": fu.LAUNCHES["sgd_fused_update"],
                            "loss_mean": float(loss.asnumpy().mean())})
    finally:
        fu._sgd_fused = real_plain
    for w in windows:
        w["mfu"] = w["img_per_s"] * flop / F32_FLOPS
        check(w["launches"] == GLUON_TIMED, "gluon %s: sgd_fused_update "
              "launched %d times in %d steps"
              % (w["mode"], w["launches"], GLUON_TIMED))
        check(w["mfu"] <= 1.05 and np.isfinite(w["loss_mean"]),
              "gluon %s: %.0f img/s (MFU %.2f), loss %s"
              % (w["mode"], w["img_per_s"], w["mfu"], w["loss_mean"]))
    check(all(launches[m + "_warm"] == GLUON_WARM for m in nets),
          "gluon: warm-up launches %s" % launches)
    check(plain_calls[0] == 0, "gluon: the plain SGD rule ran %d times"
          % plain_calls[0])
    stat_updates = hyb_op.stat_updates - updates0
    check(stat_updates == 2 * GLUON_TIMED, "gluon: the hybridized net "
          "updated its moving statistics %d times in %d steps"
          % (stat_updates, 2 * GLUON_TIMED))
    first_err = {"logits": rel_max(first["hybridized"][0], first["eager"][0]),
                 "loss": rel_max(first["hybridized"][1], first["eager"][1])}
    check(max(first_err.values()) <= GLUON_FIRST_TOL, "gluon: the "
          "hybridized first step is off the eager one: %s" % first_err)
    replay = gluon_stat_replay(torch, mx, nets["hybridized"][0], x, run)
    check(replay["err"] <= GLUON_STAT_TOL < replay["err_if_twice"],
          "gluon: one step's moving-statistics update is not one update of "
          "the momentum rule: %s" % replay)
    snap = {k: p.data().asnumpy() for k, p in params.items()}
    check(all(np.isfinite(v).all() for v in snap.values()),
          "gluon: non-finite weights")
    profiled = {}
    for mode in ("eager", "hybridized"):
        fu.reset_launches()
        profiled[mode] = profile_run(torch, lambda: run(mode, 1),
                                     _resnet_class)
        check(fu.LAUNCHES["sgd_fused_update"] == 1, "gluon %s: profiled "
              "step launched sgd_fused_update %d times"
              % (mode, fu.LAUNCHES["sgd_fused_update"]))
    adam = mx.gluon.Trainer(params, "adam", {"learning_rate": 1e-3,
                                             "wd": 1e-4})
    fu.reset_launches()
    run("hybridized", 4, adam)
    torch.cuda.synchronize()
    adam_launches = fu.LAUNCHES["adam_fused_update"]
    check(adam_launches == 4 and fu.LAUNCHES["sgd_fused_update"] == 0,
          "gluon adam: launches %s for 4 steps" % fu.LAUNCHES)
    check(all(np.isfinite(p.data().asnumpy()).all()
              for p in params.values()), "gluon adam: non-finite weights")
    by_mode = {m: [w for w in windows if w["mode"] == m] for m in nets}
    img_s = {m: sum(w["img_per_s"] for w in ws) / len(ws)
             for m, ws in by_mode.items()}
    res = {"batch": RESNET_BATCH, "warm_steps": GLUON_WARM,
           "timed_steps": GLUON_TIMED, "windows": windows,
           "img_per_s": img_s, "hybridized_over_eager":
           img_s["hybridized"] / img_s["eager"],
           "mfu": {m: v * flop / F32_FLOPS for m, v in img_s.items()},
           "first_step_s": {m: first[m][2] for m in nets},
           "first_step_rel_err": first_err, "stat_replay": replay,
           "captures": hyb_op.runner.captures,
           "train_flop_per_img": flop, "conv_fc_layers": n_layers,
           "params_trained": n_trained,
           "launches": {"sgd_fused_update": by_mode["hybridized"][0][
               "launches"]}, "adam_launches": adam_launches,
           "module_fit_img_per_s": module_img_s,
           "ratio_to_module_fit": {m: v / module_img_s
                                   for m, v in img_s.items()},
           "profiled_step": profiled, "net": nets["hybridized"][0],
           "x": x}
    log("gluon resnet50_v1: first step eager %.2fs, hybridized %.2fs "
        "(captures %d), logits/loss off by %.2e / %.2e; windows %s; "
        "hybridized / eager %.3f; MFU %s (%.2f GFLOP/img from its %d "
        "conv/FC shapes, 67 TFLOP/s f32 peak); %s Module.fit's %.1f img/s; "
        "sgd_fused_update once a step (%d tensors a launch); adam %d "
        "launches; one step's statistics update off the host replay by "
        "%.2e (twice: %.2e)"
        % (first["eager"][2], first["hybridized"][2], hyb_op.runner.captures,
           first_err["logits"], first_err["loss"],
           ", ".join("%s %.1f img/s %.2f ms" % (w["mode"], w["img_per_s"],
                                                w["ms_per_step"])
                     for w in windows), res["hybridized_over_eager"],
           {m: round(v, 4) for m, v in res["mfu"].items()}, flop / 1e9,
           n_layers, {m: round(v, 3) for m, v in
                      res["ratio_to_module_fit"].items()}, module_img_s,
           n_trained, adam_launches, replay["err"], replay["err_if_twice"]))
    for mode, prof in profiled.items():
        log("gluon profiled %s step: wall %.3fs, device busy %s, %d kernels, "
            "host launches %s (graph launches %s), device ms by class %s"
            % (mode, prof["wall_s"], "not measured"
               if prof["busy_share"] is None
               else "%.1f%%" % (100 * prof["busy_share"]), prof["kernels"],
               prof["host_launches"], prof["graph_launches"],
               {k: round(v, 3) for k, v in prof["device_ms"].items()}))
        for name, ms in prof["top_kernels_ms"][:4]:
            log("gluon profiled %s step: %8.3f ms  %s" % (mode, ms, name))
    return res


def gluon_params_copy(src, dst):
    """``dst``'s parameters set to ``src``'s, in place, by position (two
    nets of one architecture)."""
    for p, q in zip(src.collect_params().values(),
                    dst.collect_params().values()):
        q.set_data(p.data())


def rel_max(got, ref):
    """Largest absolute error over the reference's largest magnitude
    (numpy arrays)."""
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def gluon_stat_replay(torch, mx, net, x, run):
    """One hybridized step's moving-statistics update against the momentum
    rule replayed on the host: the batch statistics of the step's
    forward, from the CachedOp's traced Symbol evaluated on the same
    weights (a pure function: it updates nothing), then the step; every
    BatchNorm's new statistic within GLUON_STAT_TOL (relative, over all
    53) of ``momentum * old + (1 - momentum) * batch`` in float32, and
    the distance to two updates beside it."""
    from mxnet_tpu_torch.symbol.symbol import _graph_eval_fn
    op = net._cached_op
    tr = op._graphs[(True, 1)]
    env, _aux, xs = tr.bind([x])
    env.update(zip(tr.names, xs))
    with torch.no_grad():
        _, stats = _graph_eval_fn(tr.sym, True)(env)
    params = net.collect_params()
    old = {k: p.data().asnumpy() for k, p in params.items()
           if "running" in k}
    before = op.stat_updates
    run("hybridized", 1)
    torch.cuda.synchronize()
    new = {k: params[k].data().asnumpy() for k in old}
    errs, twice = [], []
    for mm, mv, mom, mean, var in stats:
        m32 = np.float32(mom)
        for name, batch in ((mm, mean), (mv, var)):
            b = batch.cpu().numpy().astype(np.float32)
            once = old[name] * m32 + b * np.float32(1 - mom)
            two = once * m32 + b * np.float32(1 - mom)
            scale = max(np.abs(once).max(), 1e-30)
            errs.append(float(np.abs(new[name] - once).max() / scale))
            twice.append(float(np.abs(new[name] - two).max() / scale))
    return {"bn_nodes": len(stats), "err": max(errs),
            "err_if_twice": min(twice),
            "updates": op.stat_updates - before}


def gamma_grad_scaled(torch, real, factor):
    """A planted fault for phase 23: BatchNorm whose gamma gradient is
    ``factor`` times the sound one (its forward value is the sound
    op's). It keeps the sound op's signature, from which a Symbol
    traced under it takes the op's input slots."""
    @functools.wraps(real)
    def fn(data, gamma, beta, *rest, **attrs):
        g = gamma * factor - (gamma * (factor - 1)).detach()
        return real(data, g, beta, *rest, **attrs)
    return fn


def host64(a):
    """An NDArray as a float64 numpy array (bf16 too, without ml_dtypes,
    which the card's machine lacks)."""
    return a._data.detach().double().cpu().numpy()


class _GluonSide(object):
    """One side of phases 23 and 52: the zoo's resnet50_v1 made from a
    common state on ``ctx`` in ``dtype``, stepped by ``Trainer`` (float32,
    bfloat16) or, in float64, by the plain SGD rule with the hypers an SGD
    optimizer gives (the kernel takes float32, bfloat16 and float16)."""

    def __init__(self, torch, mx, fu, state, x, y, ctx, dtype="float32",
                 hybridize=False):
        self.torch, self.mx, self.fu = torch, mx, fu
        self.net = mx.gluon.model_zoo.vision.get_model(
            "resnet50_v1", classes=1000, prefix="g23_")
        self.params = self.net.collect_params()
        mx.convert.gluon_params_from_jax(state, self.params, ctx=ctx)
        if dtype != "float32":
            self.net.cast(dtype)
        if hybridize:
            self.net.hybridize()
        self.x = mx.nd.array(x, ctx=ctx, dtype=dtype)
        # class ids as float32 (bfloat16 holds integers to 256 only)
        self.y = mx.nd.array(y, ctx=ctx, dtype="float64"
                             if dtype == "float64" else "float32")
        self.loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        self.f64 = dtype == "float64"
        opt = dict(GLUON_OPT)
        if self.f64:
            self.opt = mx.optimizer.create("sgd", **opt)
            self.trained = [p for p in self.params.values()
                            if p.grad_req != "null"]
            self.opt.param_dict = dict(enumerate(self.trained))
            self.opt.rescale_grad = 1.0 / x.shape[0]
            self.mom = [torch.zeros_like(p.data()._data)
                        for p in self.trained]
        else:
            self.trainer = mx.gluon.Trainer(self.params, "sgd", opt)

    def step(self, grads=None):
        """The step's (outputs, parameters, running statistics); the
        gradients of ``grads`` (names) are stored in ``self.grads``."""
        mx, torch = self.mx, self.torch
        with mx.autograd.record():
            out = self.net(self.x)
            loss = self.loss_fn(out, self.y)
        loss.backward()
        self.grads = {k: host64(self.params[k].grad()) for k in grads or ()}
        if self.f64:
            hyper = [self.opt.fused_hyper(i)
                     for i in range(len(self.trained))]
            with torch.no_grad():
                self.fu._sgd_fused([p.data()._data for p in self.trained],
                                   [p.grad()._data for p in self.trained],
                                   [(m,) for m in self.mom], hyper)
        else:
            self.trainer.step(self.x.shape[0])
        return (host64(out),
                {k: host64(p.data()) for k, p in self.params.items()
                 if "running" not in k},
                {k: host64(p.data()) for k, p in self.params.items()
                 if "running" in k})


def gluon_vs_cpu(torch, mx, fu, batch=2, steps=2):
    """Phase 23: two chained Gluon ``trainer.step``s of resnet50_v1 at
    batch 2 from one state, on the card (float32) eager and hybridized
    (its CUDA graphs), on the CPU (float32) and on the CPU in float64
    (the witness), each card side held by phase 14's rule
    (``resnet_misses``: the card's errors against the witness within
    RESNET_RATIO_TOL times the CPU's own, step 1's outputs and running
    statistics absolutely), with the planted fault (BatchNorm's gamma
    gradient doubled) on the card, eager and hybridized, that must miss
    it."""
    from mxnet_tpu_torch.ops import registry as reg
    rng = np.random.RandomState(23)
    x = rng.uniform(-1, 1, (batch, 3, 224, 224)).astype(np.float32)
    y = rng.randint(0, 1000, (batch,)).astype(np.float32)
    mx.random.seed(23)
    init = mx.gluon.model_zoo.vision.get_model("resnet50_v1", classes=1000,
                                               prefix="g23_")
    init.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2), ctx=mx.cpu())
    with mx.autograd.predict_mode():
        init(mx.nd.array(x, ctx=mx.cpu()))
    state = mx.convert.gluon_params_to_numpy(init)
    del init
    sides = {"witness": _GluonSide(torch, mx, fu, state, x, y, mx.cpu(),
                                   "float64"),
             "cpu": _GluonSide(torch, mx, fu, state, x, y, mx.cpu()),
             "dev": _GluonSide(torch, mx, fu, state, x, y, mx.gpu(0)),
             "planted": _GluonSide(torch, mx, fu, state, x, y, mx.gpu(0)),
             "hybridized": _GluonSide(torch, mx, fu, state, x, y, mx.gpu(0),
                                      hybridize=True),
             "planted_hybridized": _GluonSide(torch, mx, fu, state, x, y,
                                              mx.gpu(0), hybridize=True)}
    card_sides = ("dev", "planted", "hybridized", "planted_hybridized")
    # the v1 bottleneck's 1x1 convs carry biases, each followed by a
    # BatchNorm in training mode: their gradient is zero in exact
    # arithmetic, so the witness moves them by rounding only and a
    # relative error of their change means nothing; they are left out
    zero_grad = re.compile(r"conv2d\d+_bias$")
    a0 = {k: v.astype(np.float64) for k, v in state.items()
          if "running" not in k and not zero_grad.search(k)}
    x0 = {k: v.astype(np.float64) for k, v in state.items()
          if "running" in k}
    bn = reg.get_op("BatchNorm")
    sound = bn.fn
    rows, planted = [], {"planted": [], "planted_hybridized": []}
    for step in range(1, steps + 1):
        t0 = time.time()
        o_w, a_w, s_w = sides["witness"].step()
        row = {"step": step, "witness_s": time.time() - t0}
        for side in ("cpu",) + card_sides:
            fu.reset_launches()
            if side.startswith("planted"):
                bn.fn = gamma_grad_scaled(torch, sound, GLUON_PLANT)
            try:
                out, a, s = sides[side].step()
            finally:
                bn.fn = sound
            check(side == "cpu" or fu.LAUNCHES["sgd_fused_update"] == 1,
                  "gluon vs cpu: %d launches in one %s step"
                  % (fu.LAUNCHES["sgd_fused_update"], side))
            check(np.isfinite(out).all() and out.shape == (batch, 1000),
                  "gluon vs cpu: %s outputs %s" % (side, out.shape))
            dw = {k: rel_rms(a[k] - a0[k], a_w[k] - a0[k]) for k in a0}
            ds = {k: rel_rms(v - x0[k], s_w[k] - x0[k]) for k, v in s.items()}
            row[side] = {"out_rel": rel_rms(out, o_w),
                         "dw_median": float(np.median(list(dw.values()))),
                         "dw_max": max(dw.values()),
                         "dw_worst": max(dw, key=dw.get),
                         "ds_max": max(ds.values()),
                         "ds_worst": max(ds, key=ds.get)}
        for side in ("dev", "hybridized"):
            misses = resnet_misses(row[side], row["cpu"], step)
            check(not misses, "gluon vs f64 step %d: the card (%s) is off: "
                  "%s" % (step, side, "; ".join(misses)))
        for side in planted:
            planted[side] += resnet_misses(row[side], row["cpu"], step)
        row["weights_held"] = len(a0)
        rows.append(row)
        log("gluon vs f64 (batch %d) step %d (witness %.1fs): %s" % (
            batch, step, row["witness_s"], "; ".join(
                "%s outputs %.2e, weight change median %.2e max %.2e (%s), "
                "running-stat change max %.2e (%s)"
                % (side, r["out_rel"], r["dw_median"], r["dw_max"],
                   r["dw_worst"], r["ds_max"], r["ds_worst"])
                for side, r in ((k, row[k]) for k in ("cpu",) +
                                card_sides))))
    for side, misses in planted.items():
        log("gluon vs f64: the planted gamma-gradient fault (%s) misses %s"
            % (side, misses or "nothing"))
        check(misses, "gluon vs f64: the planted BatchNorm fault passes "
              "(%s)" % side)
    return rows


# ---------------------------------------------------------------------------
# phase 27: export the trained Gluon net and serve what was exported
# ---------------------------------------------------------------------------

EXPORT_TOL = 1e-5       # imported predictor vs the Gluon net, relative
EXPORT_FORWARDS = 20    # forwards a timed window; four windows
HOST_SAMPLES = 10       # single forwards on an idle card, for host µs


def forward_window(torch, fn, n=EXPORT_FORWARDS, batch=RESNET_BATCH):
    """``n`` calls of ``fn`` back to back: img/s over the wall
    (synchronized at both ends); then the host microseconds of one call
    made on an idle card (its Python call alone, the least of
    HOST_SAMPLES), which a back-to-back window cannot give: there the
    host waits whenever the card is behind."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = []
    for _ in range(HOST_SAMPLES):
        t = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t)
        torch.cuda.synchronize()
    return {"img_per_s": n * batch / wall, "host_us": min(host) * 1e6,
            "ms_per_forward": wall / n * 1e3}


def _read(path, mode="r"):
    with open(path, mode) as f:
        return f.read()


def gluon_export(torch, mx, bnk, net, x, workdir, dev_type=2):
    """Phase 27: ``net.export(prefix, epoch=0)`` of phase 22's trained
    resnet50_v1, then ``SymbolBlock.imports`` of its files on the card,
    hybridized, predicting the batch of 32: its logits within EXPORT_TOL
    (relative) of the Gluon net's own eager predict; the same files
    through ``model.load_checkpoint`` and ``serving.Predictor`` within
    EXPORT_TOL of the imported block's; ``batch_norm_inference`` launched
    once per BatchNorm node of the traced Symbol a forward (replays
    counted) and its plain version never; eager Gluon predict against
    the imported block's graph replay, img/s and host microseconds a
    forward, in turns eager, imported, imported, eager; a planted fault
    (one exported ``aux:`` moving variance scaled by 2) that must fail
    the comparison. ``dev_type=1`` puts the Predictor on the host (a CPU
    rehearsal)."""
    from mxnet_tpu_torch.ops import nn as nn_ops
    from mxnet_tpu_torch.symbol.symbol import _topo
    os.makedirs(workdir, exist_ok=True)
    prefix = os.path.join(workdir, "g22")
    t0 = time.time()
    sym = net.export(prefix, epoch=0)
    export_s = time.time() - t0
    n_bn = sum(1 for n in _topo(sym._entries) if n.op == "BatchNorm")
    files = (prefix + "-symbol.json", prefix + "-0000.params")
    net.hybridize(False)
    with mx.autograd.predict_mode():
        ref = net(x).asnumpy()
    plain_calls = [0]
    real = bnk._batch_norm_inference_plain

    def spy(x, *args, **kwargs):
        # shape inference runs the op on meta tensors: no computation
        plain_calls[0] += x.device.type != "meta"
        return real(x, *args, **kwargs)

    bnk._batch_norm_inference_plain = nn_ops._batch_norm_inference_plain = spy
    try:
        t0 = time.time()
        blk = mx.gluon.SymbolBlock.imports(files[0], ["data"], files[1],
                                           ctx=mx.gpu(0))
        blk.hybridize()
        import_s = time.time() - t0
        with mx.autograd.predict_mode():
            t0 = time.time()
            got = blk(x).asnumpy()
            first_s = time.time() - t0
            bnk.reset_launches()
            again = blk(x).asnumpy()
            torch.cuda.synchronize()
            per_forward = bnk.LAUNCHES["batch_norm_inference"]
            arg, aux = mx.model.load_checkpoint(prefix, 0)[1:]
            pred = mx.serving.Predictor(
                _read(files[0]), _read(files[1], "rb"), dev_type=dev_type,
                input_shapes={"data": x.shape})
            pred.set_input("data", x.asnumpy().astype("<f4").tobytes())
            pred.forward()
            served = np.frombuffer(pred.get_output(0), "<f4").reshape(
                pred.get_output_shape(0))
            windows = []
            bnk.reset_launches()
            for mode in ("eager", "imported", "imported", "eager"):
                w = forward_window(torch, (lambda: net(x)) if mode == "eager"
                                   else (lambda: blk(x)), batch=x.shape[0])
                w["mode"] = mode
                windows.append(w)
            window_launches = bnk.LAUNCHES["batch_norm_inference"]
    finally:
        bnk._batch_norm_inference_plain = real
        nn_ops._batch_norm_inference_plain = real
    errs = {"imported": rel_max(got, ref), "predictor": rel_max(served, got),
            "repeat_bitwise": bool(np.array_equal(again, got)),
            "predictor_bitwise": bool(np.array_equal(served, got))}
    check(got.shape == (RESNET_BATCH, 1000) and np.isfinite(got).all(),
          "export: imported logits %s" % (got.shape,))
    check(errs["imported"] <= EXPORT_TOL and errs["predictor"] <= EXPORT_TOL,
          "export: the imported block / Predictor are off: %s" % errs)
    check(sorted(arg) == sorted(sym.list_arguments()[1:])
          and sorted(aux) == sorted(sym.list_auxiliary_states()),
          "export: load_checkpoint's arg/aux split differs from the symbol's")
    check(per_forward == n_bn and n_bn == 53, "export: %d batch_norm_"
          "inference launches a forward for %d BatchNorm nodes"
          % (per_forward, n_bn))
    check(window_launches == 2 * (EXPORT_FORWARDS + HOST_SAMPLES) * 2 * n_bn,
          "export: %d batch_norm_inference launches in the windows"
          % window_launches)
    check(plain_calls[0] == 0, "export: the plain BatchNorm ran %d times"
          % plain_calls[0])
    # the planted fault: one moving variance scaled by 2 in the file
    saved = mx.nd.load(files[1])
    victim = sorted(k for k in saved if k.startswith("aux:")
                    and k.endswith("running_var"))[0]
    saved[victim] = saved[victim] * 2
    mx.nd.save(prefix + "-planted-0000.params", saved, format="mxnet")
    bad = mx.gluon.SymbolBlock.imports(files[0], ["data"],
                                       prefix + "-planted-0000.params",
                                       ctx=mx.gpu(0))
    bad.hybridize()
    with mx.autograd.predict_mode():
        planted = rel_max(bad(x).asnumpy(), ref)
    check(planted > EXPORT_TOL, "export: the planted moving-variance fault "
          "passes (%.2e)" % planted)
    by = {m: [w for w in windows if w["mode"] == m] for m in
          ("eager", "imported")}
    summary = {m: {k: sum(w[k] for w in ws) / len(ws) for k in
                   ("img_per_s", "host_us", "ms_per_forward")}
               for m, ws in by.items()}
    res = {"export_s": export_s, "import_s": import_s,
           "first_forward_s": first_s, "bn_nodes": n_bn,
           "launches_per_forward": per_forward,
           "window_launches": window_launches, "errors": errs,
           "planted_rel_err": planted, "planted_key": victim,
           "windows": windows, "summary": summary,
           "params_mb": os.path.getsize(files[1]) / 1e6,
           "captures": blk._cached_op.runner.captures}
    log("export: %.2fs (%.1f MB params), imports %.2fs, first forward "
        "(capture) %.2fs; imported vs Gluon %.2e, Predictor vs imported "
        "%.2e (bitwise %s, repeat bitwise %s); %d batch_norm_inference a "
        "forward for %d nodes; planted %s x2: %.2e; %s"
        % (export_s, res["params_mb"], import_s, first_s, errs["imported"],
           errs["predictor"], errs["predictor_bitwise"],
           errs["repeat_bitwise"], per_forward, n_bn, victim, planted,
           ", ".join("%s %.1f img/s %.1f host us/forward"
                     % (w["mode"], w["img_per_s"], w["host_us"])
                     for w in windows)))
    shutil.rmtree(workdir, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phases 24-26: the data path and the north-star CLI with checkpoints
# ---------------------------------------------------------------------------

SMOKE_RECORDS = 768     # phase 24's .rec: 24 batches of 32
SMOKE_SHORT = 256       # tools/im2rec.py --resize 256: short side 256,
SMOKE_LONG = (256, 384)  # the long side as ImageNet's aspect ratios leave it
SMOKE_QUALITY = 95      # im2rec's JPEG quality
CLI_MEAN = (123.68, 116.779, 103.939)   # the CLI's --rgb-mean
CLI_STD = (58.393, 57.12, 57.375)       # an ImageNet --rgb-std
# nvJPEG's component planes differ from libjpeg-turbo's (OpenCV's) by
# the rounding of the inverse DCT; the colour conversion and chroma
# upsampling are libjpeg-turbo's own (bitwise, tests/test_torch_image.py).
# On an H100 with nvJPEG 12.4 the two were at most 3 levels apart, on
# ~4% of values (q 95 records; PERF.md §6); a mean moved by one channel
# moves the values 7-13 levels.
DECODE_LEVEL_TOL = 4    # max |native - python| in uint8 levels
DECODE_MEAN_TOL = 0.1   # mean |native - python| in levels
# phase 24's second record set: images at original ImageNet-like sizes,
# mostly 4:2:0, the resize path's inputs
DOMAIN_RECORDS = 256
DOMAIN_SHORT = (60, 500)    # short side; the long side up to 500
DOMAIN_SMALL = 0.1          # share of images with the short side < 224
# (kind, cv2 sampling-factor constant, share); gray is a 1-channel JPEG
DOMAIN_SAMPLINGS = (("420", "IMWRITE_JPEG_SAMPLING_FACTOR_420", 0.6),
                    ("444", "IMWRITE_JPEG_SAMPLING_FACTOR_444", 0.08),
                    ("422", "IMWRITE_JPEG_SAMPLING_FACTOR_422", 0.08),
                    ("440", "IMWRITE_JPEG_SAMPLING_FACTOR_440", 0.08),
                    ("411", "IMWRITE_JPEG_SAMPLING_FACTOR_411", 0.08),
                    ("gray", None, 0.08))
# native vs python route at resize=256: the inverse DCTs' <= 3 levels
# pass through the cubic (sum of |coefficients| 1.1875 an axis), and
# Python cv2's cubic is itself 1 level off the reference's on ~4% of
# values
RESIZE_LEVEL_TOL = 6
RESIZE_MEAN_TOL = 0.15
CLI_BATCHES = 48        # phase 25: --max-batches
DECODE_BACKEND = "nvjpeg"   # the H100 machines this script targets have
                            # nvJPEG and no OpenCV C++ headers
CLI_EXTRA = []          # appended to the CLI's arguments (a CPU rehearsal)


class LogLines(logging.Handler):
    """The messages logged at INFO and above while it is attached to the
    root logger (the CLI's Speedometer and epoch lines)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        root = logging.getLogger()
        self._level = root.level
        root.setLevel(logging.INFO)
        root.addHandler(self)
        return self

    def __exit__(self, *exc):
        root = logging.getLogger()
        root.removeHandler(self)
        root.setLevel(self._level)
        return False

    def speeds(self, epoch=None):
        out = []
        for line in self.lines:
            m = re.search(r"Epoch\[(\d+)\] Batch \[(\d+)\]\s+Speed: "
                          r"([0-9.]+) samples/sec", line)
            if m and (epoch is None or int(m.group(1)) == epoch):
                out.append(float(m.group(3)))
        return out

    def train_value(self, name):
        """{epoch: value} of the ``Epoch[e] Train-<name>=`` lines."""
        out = {}
        for line in self.lines:
            m = re.search(r"Epoch\[(\d+)\] Train-%s=([-+0-9.eEinfa]+)"
                          % re.escape(name), line)
            if m:
                out[int(m.group(1))] = float(m.group(2))
        return out


def smoke_records(mx, path, n=SMOKE_RECORDS, seed=0):
    """Write ``n`` seeded images as ``tools/im2rec.py --resize 256`` leaves
    ImageNet (short side 256, long side 256-384, either orientation, JPEG
    quality 95, labels 0-999) through ``recordio.pack_img``: smooth
    fields (a 6x8 random grid, cubic upsampled) plus uniform noise, so
    that the files are the size of real ones. Returns (bytes, seconds)."""
    import cv2
    rng = np.random.RandomState(seed)
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    w = mx.recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                      path, "w")
    for i in range(n):
        long_side = int(rng.randint(SMOKE_LONG[0], SMOKE_LONG[1] + 1))
        h, wd = (SMOKE_SHORT, long_side) if rng.rand() < 0.75 else (
            long_side, SMOKE_SHORT)
        grid = rng.uniform(0, 255, (6, 8, 3)).astype(np.float32)
        field = cv2.resize(grid, (wd, h), interpolation=cv2.INTER_CUBIC)
        noise = rng.randint(-16, 17, (h, wd, 3)).astype(np.float32)
        img = np.clip(field + noise, 0, 255).astype(np.uint8)
        label = float(rng.randint(0, 1000))
        w.write_idx(i, mx.recordio.pack_img(
            mx.recordio.IRHeader(0, label, i, 0), img,
            quality=SMOKE_QUALITY))
    w.close()
    return os.path.getsize(path), time.perf_counter() - t0


def _levels(torch, a, b):
    """|a - b| in uint8 levels of normalised NCHW batches (x std)."""
    std = torch.tensor(CLI_STD, dtype=torch.float64).reshape(1, 3, 1, 1)
    return (a.double().cpu() - b.double().cpu()).abs() * std


def _source_span(idec, n_in, n_out, start, count):
    """Source samples an axis reads for outputs start .. start + count - 1
    of its n_in -> n_out resize: the span of their cubic taps (the crop
    itself without a resize)."""
    if n_in == n_out:
        return count
    taps = idec._cubic_tables(n_in, n_out)[0][start:start + count]
    return int(taps.max() - taps.min() + 1)


def _plane_cost(items, oh, ow, c=3):
    """Bytes crop_mirror_normalize must move: the Y samples each crop
    reads (the span of its resize's taps, or the crop) and the chroma
    samples under them read once, float32 NCHW written once."""
    from mxnet_tpu_torch.ops.cuda import image_decode as idec
    total = 0
    for row in items.tolist():
        h, w, x0, y0 = row[1], row[2], row[3], row[4]
        kind, ch, cw, rh, rw, crh, crw = row[6:13]
        rows = _source_span(idec, h, rh, y0, crh)
        cols = _source_span(idec, w, rw, x0, crw)
        total += 4 * c * oh * ow + rows * cols
        if c == 3 and kind > 0:
            hs, vs = idec._SUBSAMPLING[kind]
            total += 2 * (min(ch, rows // vs + 2) if vs > 1 else rows) * (
                min(cw, cols // hs + 2) if hs > 1 else cols)
    return total


def data_pipeline(torch, mx, idec, rec, timer):
    """Phase 24: the records' decode on both routes, the augment kernel
    against its plain version, the iterator's rate, the upload's cost,
    and staged batches against synchronous copies."""
    dev = torch.device("cuda", 0)
    mean = np.array(CLI_MEAN, np.float32)
    std = np.array(CLI_STD, np.float32)
    check("nvjpeg" in mx.image.decoder_backends(),
          "no nvjpeg decoder backend: %s" % mx.image.decoder_backends())
    backend = mx.image.decoder_backends()[0]
    check(backend == DECODE_BACKEND, "decoder backend %r, expected %s"
          % (backend, DECODE_BACKEND))
    # native (nvJPEG + kernel) against python (cv2 + Augmenters) on 64
    # records, center crop, no resize
    kw = dict(path_imgrec=rec, mean=mean, std=std)
    native = mx.image.ImageIter(64, (3, 224, 224), preprocess_threads=4,
                                ctx=dev, **kw)
    python = mx.image.ImageIter(64, (3, 224, 224), **kw)
    check(native.route == "native" and python.route == "python",
          "routes %s / %s" % (native.route, python.route))
    a = native.next().data[0]._data
    check(a.device.type == "cuda", "native batch on %s" % a.device)
    b = python.next().data[0]._data
    lv = _levels(torch, a, b)
    lmax, lmean = float(lv.max()), float(lv.mean())
    frac = float((lv > 0.5).double().mean())
    check(lmax <= DECODE_LEVEL_TOL and lmean <= DECODE_MEAN_TOL,
          "native vs python decode: max %.3f, mean %.4f levels" % (lmax,
                                                                   lmean))
    # planted fault: the mean moved by one channel must fail the bound
    bad = mx.image.ImageIter(64, (3, 224, 224), path_imgrec=rec,
                             mean=np.roll(mean, 1), std=std)
    lv_bad = _levels(torch, a, bad.next().data[0]._data)
    check(float(lv_bad.max()) > DECODE_LEVEL_TOL
          or float(lv_bad.mean()) > DECODE_MEAN_TOL,
          "planted fault (mean shifted one channel) passed the decode "
          "bound")
    # the kernel against its plain version at the main path's shape: one
    # batch of 32, random crop and mirror
    dec = mx.image.NativeImageDecoder((3, 224, 224), rand_crop=True,
                                      rand_mirror=True, mean=mean, std=std,
                                      num_threads=4, backend="nvjpeg")
    reader = mx.recordio.MXIndexedRecordIO(
        os.path.splitext(rec)[0] + ".idx", rec, "r")
    bufs = [mx.recordio.unpack(reader.read_idx(k))[1] for k in range(32)]
    reader.close()
    src, items = dec.decode_planes(bufs, base=0)
    idec.reset_launches()
    got = idec.crop_mirror_normalize(src, items, (3, 224, 224), mean, std)
    check(idec.LAUNCHES["crop_mirror_normalize"] == 1, "kernel not launched")
    plain = idec._crop_mirror_normalize_plain(src, items, (3, 224, 224),
                                              mean, std)
    plain_cpu = idec._crop_mirror_normalize_plain(
        src.cpu(), items, (3, 224, 224), mean, std)
    check(torch.equal(got, plain) and torch.equal(got.cpu(), plain_cpu),
          "crop_mirror_normalize differs from its plain version: %g"
          % float((got - plain).abs().max()))
    faulty = idec._crop_mirror_normalize_plain(src, items, (3, 224, 224),
                                               np.roll(mean, 1), std)
    check(not torch.equal(got, faulty), "planted fault (mean shifted one "
          "channel) passed the kernel check")
    kinds = sorted(set(items[:, 6].tolist()))
    # the call's time as every row of the kernels line is timed (CUDA
    # events, the card held 0.5 ms: the items' copy included); beside it
    # the kernel's device time alone (torch.profiler)
    call = lambda: idec.crop_mirror_normalize(  # noqa: E731
        src, items, (3, 224, 224), mean, std)
    ms = timer(call, hold_ms=0.5)
    device_ms = kernel_device_ms(torch, timer, call, "crop_mirror_normalize")
    plain_ms = timer(lambda: idec._crop_mirror_normalize_plain(
        src, items, (3, 224, 224), mean, std), iters=3)
    nbytes = _plane_cost(items, 224, 224)
    row = {"name": "crop_mirror_normalize", "max_abs_err": 0.0, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BPS * 1e3,
           "bound_by": "bytes", "library_ms": None, "kinds": kinds,
           "bytes": nbytes, "device_ms": device_ms}
    # ImageRecordIter alone, as the CLI builds it (random crop and mirror,
    # staged onto the card by its prefetch thread)
    nproc = os.cpu_count()
    rates = {}
    for threads in sorted({4, nproc}):
        it = mx.io.ImageRecordIter(
            path_imgrec=rec, data_shape=(3, 224, 224), batch_size=32,
            shuffle=True, rand_crop=True, rand_mirror=True,
            mean_r=CLI_MEAN[0], mean_g=CLI_MEAN[1], mean_b=CLI_MEAN[2],
            std_r=CLI_STD[0], std_g=CLI_STD[1], std_b=CLI_STD[2],
            preprocess_threads=threads, prefetch_buffer=2, ctx=dev)
        for _ in range(2):
            it.next()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(16):
            batch = it.next()
            check(batch.data[0]._data.device.type == "cuda",
                  "ImageRecordIter batch on %s" % batch.data[0].context)
        torch.cuda.synchronize()
        rates[threads] = 16 * 32 / (time.perf_counter() - t0)
        it.close()
    # one batch's upload: pageable against pinned host memory
    host = torch.empty((32, 3, 224, 224), dtype=torch.float32)
    host.copy_(torch.from_numpy(np.random.RandomState(0).uniform(
        -2, 2, host.shape).astype(np.float32)))
    pinned = host.pin_memory()
    dst = torch.empty(host.shape, dtype=torch.float32, device=dev)
    upload = {}
    for name, t, nb in (("pageable", host, False), ("pinned", pinned, True),
                        ("pageable", host, False), ("pinned", pinned, True)):
        dst.copy_(t, non_blocking=nb)
        torch.cuda.synchronize()
        s_ev = torch.cuda.Event(enable_timing=True)
        e_ev = torch.cuda.Event(enable_timing=True)
        s_ev.record()
        for _ in range(10):
            dst.copy_(t, non_blocking=nb)
        e_ev.record()
        torch.cuda.synchronize()
        upload.setdefault(name, []).append(s_ev.elapsed_time(e_ev) / 10)
    check(torch.equal(dst.cpu(), host), "upload corrupted the batch")
    # staged batches against synchronous copies of the same records, more
    # batches than the pinned ring has slots: the python route (host
    # batches through the pinned ring) and the native route
    staged_ok = {}
    for route, extra in (("python", {}), ("native",
                                          {"preprocess_threads": 4})):
        args = dict(path_imgrec=rec, data_shape=(3, 224, 224),
                    batch_size=32, shuffle=True, rand_crop=True,
                    rand_mirror=True, mean_r=CLI_MEAN[0], std_r=CLI_STD[0],
                    **extra)
        staged = mx.io.ImageRecordIter(prefetch_buffer=2, ctx=dev, **args)
        direct = mx.io.ImageRecordIter(
            ctx=torch.device("cpu") if route == "python" else dev, **args)
        for _ in range(5):
            sb, db = staged.next(), direct.next()
            for x, y in zip(sb.data + sb.label, db.data + db.label):
                check(x._data.device.type == "cuda",
                      "%s route: staged batch on %s" % (route, x.context))
                check(torch.equal(x._data, y._data.to(dev)),
                      "%s route: a staged batch differs from the "
                      "synchronous copy" % route)
        staged.close()
        staged_ok[route] = 5
    res = {"backend": backend, "routes": {"native": native.route,
                                          "python": python.route},
           "decode_levels_max": lmax, "decode_levels_mean": lmean,
           "decode_values_differing": frac,
           "planted_levels_max": float(lv_bad.max()),
           "kernel": row, "iter_img_per_s": rates, "nproc": nproc,
           "upload_ms": {k: min(v) for k, v in upload.items()},
           "staged_batches_bitwise": staged_ok}
    log("data: backend %s; native vs python decode (64 records, no resize): "
        "max %.3f, mean %.4f levels, %.2f%% of values differ (bound %d / "
        "%.2f); planted mean shift: max %.1f levels"
        % (backend, lmax, lmean, 100 * frac, DECODE_LEVEL_TOL,
           DECODE_MEAN_TOL, res["planted_levels_max"]))
    log("data: crop_mirror_normalize (32 images, planes %s) %.4f ms a call "
        "(events, the items' copy included; %.0f%% of the bound), %.4f ms "
        "device (profiler, %.0f%%), plain %.3f ms, bound %.4f ms (bytes), "
        "bitwise vs plain (card and CPU)"
        % (kinds, ms, 100 * row["bound_ms"] / ms, device_ms,
           100 * row["bound_ms"] / device_ms, plain_ms, row["bound_ms"]))
    log("data: ImageRecordIter alone, batch 32 3x224x224, random crop + "
        "mirror, staged: %s img/s (threads: img/s; nproc %d)"
        % ({k: round(v, 1) for k, v in rates.items()}, nproc))
    log("data: one batch upload (19.3 MB): pageable %.3f ms, pinned %.3f ms"
        % (res["upload_ms"]["pageable"], res["upload_ms"]["pinned"]))
    return res


def domain_records(mx, path, n=DOMAIN_RECORDS, seed=1):
    """Phase 24's second record set: ``n`` seeded images at original
    ImageNet-like sizes (short side 60-500, a tenth below 224, long side
    up to 500, either orientation), smooth fields plus noise as
    :func:`smoke_records`', JPEG quality 95 in the chroma subsamplings
    of ``DOMAIN_SAMPLINGS`` (cv2's encoder). Returns {kind: count}."""
    import cv2
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    w = mx.recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                      path, "w")
    shares = np.array([p for _, _, p in DOMAIN_SAMPLINGS])
    counts = {}
    for i in range(n):
        if rng.rand() < DOMAIN_SMALL:
            short = int(rng.randint(DOMAIN_SHORT[0], 224))
        else:
            short = int(rng.randint(224, DOMAIN_SHORT[1] + 1))
        long_side = int(rng.randint(short, DOMAIN_SHORT[1] + 1))
        h, wd = (short, long_side) if rng.rand() < 0.75 else (long_side,
                                                                short)
        grid = rng.uniform(0, 255, (6, 8, 3)).astype(np.float32)
        field = cv2.resize(grid, (wd, h), interpolation=cv2.INTER_CUBIC)
        noise = rng.randint(-16, 17, (h, wd, 3)).astype(np.float32)
        img = np.clip(field + noise, 0, 255).astype(np.uint8)
        kind, factor, _ = DOMAIN_SAMPLINGS[rng.choice(len(shares),
                                                      p=shares / shares.sum())]
        params = [cv2.IMWRITE_JPEG_QUALITY, SMOKE_QUALITY]
        if factor is not None:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(cv2, factor)]
        ok, buf = cv2.imencode(".jpg", img[..., 0] if kind == "gray" else img,
                               params)
        check(ok, "cv2 could not encode a %s JPEG" % kind)
        counts[kind] = counts.get(kind, 0) + 1
        w.write_idx(i, mx.recordio.pack(
            mx.recordio.IRHeader(0, float(rng.randint(0, 1000)), i, 0),
            buf.tobytes()))
    w.close()
    return counts


def _resize_int_vertical(torch, idec):
    """A planted fault: the cubic resize's vertical pass in integer
    arithmetic ((sum beta*S + 2^21) >> 22) for every value."""
    def resize(img, nh, nw):
        h, w, c = img.shape
        if (nh, nw) == (h, w):
            return img
        tx, ax = (torch.from_numpy(v).to(img.device)
                  for v in idec._cubic_tables(w, nw))
        ty, ay = (torch.from_numpy(v).to(img.device)
                  for v in idec._cubic_tables(h, nh))
        hor = (img[:, tx].long() * ax[None, :, :, None]).sum(2)
        v = ((hor[ty] * ay[:, :, None, None]).sum(1) + (1 << 21)) >> 22
        return v.clamp(0, 255).to(torch.uint8)
    return resize


def _random_planes(rng, shapes):
    """Random planes of (kind, h, w) images, one flat uint8 array, and
    their (offset, h, w, kind, chroma h, chroma w) rows."""
    from mxnet_tpu_torch.ops.cuda import image_decode as idec
    parts, rows, off = [], [], 0
    for kind, h, w in shapes:
        hs, vs = idec._SUBSAMPLING.get(kind, (1, 1))
        ch, cw = (-(-h // vs), -(-w // hs)) if kind else (0, 0)
        p = rng.randint(0, 256, h * w + 2 * ch * cw).astype(np.uint8)
        parts.append(p)
        rows.append((off, h, w, kind, ch, cw))
        off += len(p)
    return np.concatenate(parts), rows


def decode_domain(torch, mx, idec, rec, timer):
    """Phase 24, second half: the nvjpeg route over the JAX decoder's
    whole domain on ``domain_records``: the kernel against its plain
    version bitwise at resize 0 (small images resized to the crop), 256
    and 160 (below the crop: two launches), one channel, and on random
    planes of every kind (4:1:0 included, which cv2 cannot encode, and a
    downscale past the dense window); two planted faults; the native
    route against the python route at resize=256; the kernel timed at
    resize=256 beside its bound."""
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    mean = np.array(CLI_MEAN, np.float32)
    std = np.array(CLI_STD, np.float32)
    reader = mx.recordio.MXIndexedRecordIO(
        os.path.splitext(rec)[0] + ".idx", rec, "r")
    bufs = [mx.recordio.unpack(reader.read_idx(k))[1]
            for k in range(len(reader.keys))]
    reader.close()
    # the native route against the python route (Python cv2 decodes and
    # resizes), resize=256, center crop, every record
    kw = dict(path_imgrec=rec, mean=mean, std=std, resize=256)
    native = mx.image.ImageIter(64, (3, 224, 224), preprocess_threads=4,
                                ctx=dev, **kw)
    python = mx.image.ImageIter(64, (3, 224, 224), **kw)
    check(native.route == "native" and python.route == "python",
          "routes %s / %s" % (native.route, python.route))
    lmax = lsum = cnt = 0.0
    for _ in range(len(bufs) // 64):
        lv = _levels(torch, native.next().data[0]._data,
                     python.next().data[0]._data)
        lmax = max(lmax, float(lv.max()))
        lsum += float(lv.sum())
        cnt += lv.numel()
    lmean = lsum / cnt
    check(lmax <= RESIZE_LEVEL_TOL and lmean <= RESIZE_MEAN_TOL,
          "native vs python decode at resize=256: max %.3f, mean %.4f levels"
          % (lmax, lmean))
    # the kernel against its plain version, batches of 32 on every path
    paths = {}
    for label, resize, shape in (("resize 0", 0, (3, 224, 224)),
                                 ("resize 256", 256, (3, 224, 224)),
                                 ("resize 160", 160, (3, 224, 224)),
                                 ("resize 256, 1 channel", 256,
                                  (1, 224, 224))):
        c = shape[0]
        dec = mx.image.NativeImageDecoder(
            shape, resize=resize, rand_crop=True, rand_mirror=True,
            mean=mean[:c], std=std[:c], num_threads=4, backend="nvjpeg")
        seen = {"images": 0, "crop_resized": 0, "both": 0, "launches": 0,
                "kinds": set()}
        for b in range(0, len(bufs), 32):
            src, items = dec.decode_planes(bufs[b:b + 32], base=b)
            rows = items.numpy()
            small = (rows[:, 11] < shape[1]) | (rows[:, 12] < shape[2])
            resized = (rows[:, 9] != rows[:, 1]) | (rows[:, 10] != rows[:, 2])
            idec.reset_launches()
            got = idec.crop_mirror_normalize(src, items, shape, mean[:c],
                                             std[:c])
            n_launch = idec.LAUNCHES["crop_mirror_normalize"]
            check(n_launch == 1 + int((small & resized).any()),
                  "%s: %d launches for a batch" % (label, n_launch))
            plain = idec._crop_mirror_normalize_plain(src, items, shape,
                                                      mean[:c], std[:c])
            check(torch.equal(got, plain), "crop_mirror_normalize (%s) "
                  "differs from its plain version in %d values"
                  % (label, int((got != plain).sum())))
            if b == 0:
                check(torch.equal(got.cpu(), idec._crop_mirror_normalize_plain(
                    src.cpu(), items, shape, mean[:c], std[:c])),
                      "%s: the plain version differs on the CPU" % label)
            seen["images"] += len(rows)
            seen["crop_resized"] += int(small.sum())
            seen["both"] += int((small & resized).sum())
            seen["launches"] += n_launch
            seen["kinds"] |= set(rows[:, 6].tolist())
        seen["kinds"] = sorted(seen["kinds"])
        paths[label] = seen
    check(paths["resize 0"]["crop_resized"] > 0
          and paths["resize 160"]["both"] > 0,
          "the record set misses a path: %s" % paths)
    # random planes of every kind, 4:1:0 included; a 1400 x 1100 image
    # resized to 64 spreads its taps past the dense window
    rng = np.random.RandomState(24)
    shapes = [(k, int(rng.randint(20, 400)), int(rng.randint(20, 400)))
              for k in range(7) for _ in range(3)] + [(6, 1400, 1100),
                                                     (3, 1100, 1400)]
    planes, prow = _random_planes(rng, shapes)
    src = torch.from_numpy(planes).to(dev)
    for resize, shape in ((0, (3, 224, 224)), (256, (3, 224, 224)),
                          (64, (3, 48, 48)), (64, (3, 224, 224))):
        dec = mx.image.NativeImageDecoder(shape, resize=resize,
                                          rand_crop=True, rand_mirror=True,
                                          mean=mean, std=std,
                                          backend="nvjpeg")
        hw = np.array([[h, w] for _, h, w, _, _, _ in prow], np.int32)
        plan = dec.plan(hw, base=resize)
        items = torch.from_numpy(np.array(
            [[r[0], r[1], r[2]] + list(p[:3]) + [r[3], r[4], r[5]]
             + list(p[3:]) for r, p in zip(prow, plan.tolist())],
            dtype=np.int64))
        got = idec.crop_mirror_normalize(src, items, shape, mean, std)
        plain = idec._crop_mirror_normalize_plain(src, items, shape, mean,
                                                  std)
        check(torch.equal(got, plain), "crop_mirror_normalize on random "
              "planes (resize %d, %s) differs from its plain version in %d "
              "values" % (resize, shape, int((got != plain).sum())))
    # planted faults at resize 256: one cubic coefficient off by one;
    # the vertical pass in integer arithmetic
    dec = mx.image.NativeImageDecoder((3, 224, 224), resize=256,
                                      rand_crop=True, rand_mirror=True,
                                      mean=mean, std=std, num_threads=4,
                                      backend="nvjpeg")
    src, items = dec.decode_planes(bufs[:32], base=0)
    got = idec.crop_mirror_normalize(src, items, (3, 224, 224), mean, std)
    tables = idec._cubic_tables

    def off_by_one(n_in, n_out):
        taps, alpha = tables(n_in, n_out)
        alpha = alpha.copy()
        alpha[n_out // 2, 1] += 1
        return taps, alpha

    planted = {}
    for name, attr, fault in (
            ("coefficient off by one", "_cubic_tables", off_by_one),
            ("integer vertical pass", "_resize_cubic_plain",
             _resize_int_vertical(torch, idec))):
        real = getattr(idec, attr)
        setattr(idec, attr, fault)
        try:
            bad = idec._crop_mirror_normalize_plain(src, items,
                                                    (3, 224, 224), mean, std)
        finally:
            setattr(idec, attr, real)
        planted[name] = int((bad != got).sum())
        check(planted[name] > 0, "planted fault (%s) passed the kernel "
              "check" % name)
    # the kernel timed at resize 256 (32 images, random crop and mirror)
    call = lambda: idec.crop_mirror_normalize(  # noqa: E731
        src, items, (3, 224, 224), mean, std)
    ms = timer(call, hold_ms=0.5)
    device_ms = kernel_device_ms(torch, timer, call, "crop_mirror_normalize")
    plain_ms = timer(lambda: idec._crop_mirror_normalize_plain(
        src, items, (3, 224, 224), mean, std), iters=3)
    nbytes = _plane_cost(items, 224, 224)
    # context, not the same function: a float bicubic resize of the
    # crops' source windows and a normalise
    rows = items.numpy()
    side = int(round(224 * float(np.mean(rows[:, 1] / rows[:, 9]))))
    win = torch.randint(0, 256, (len(rows), 3, side, side), device=dev,
                        dtype=torch.uint8).float()
    m_t = torch.tensor(mean, device=dev).reshape(1, 3, 1, 1)
    s_t = torch.tensor(std, device=dev).reshape(1, 3, 1, 1)
    interp_ms = timer(lambda: (F.interpolate(
        win, size=(224, 224), mode="bicubic", align_corners=False) - m_t)
        / s_t)
    row = {"name": "crop_mirror_normalize (resize 256)", "ms": ms,
           "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BPS * 1e3,
           "bound_by": "bytes", "library_ms": None, "bytes": nbytes,
           "device_ms": device_ms,
           "max_abs_err": 0.0, "interpolate_context_ms": interp_ms,
           "interpolate_window": side}
    res = {"records": len(bufs), "paths": paths,
           "levels_max_resize_256": lmax, "levels_mean_resize_256": lmean,
           "planted": planted, "kernel_resize": row,
           "ptxas": ptxas_summary(PTXAS.get("image_decode", ""))}
    log("data (domain set, %d records): native vs python at resize=256: "
        "max %.3f, mean %.4f levels (bound %d / %.2f)"
        % (len(bufs), lmax, lmean, RESIZE_LEVEL_TOL, RESIZE_MEAN_TOL))
    log("data: crop_mirror_normalize bitwise vs plain (card; CPU on a "
        "batch): %s; random planes of kinds 0-6 at resize 0 / 256 / 64; "
        "planted faults differ in %s values"
        % ("; ".join("%s: %d images, %d crops resized, %d both, %d "
                     "launches, kinds %s" % (k, v["images"],
                                             v["crop_resized"], v["both"],
                                             v["launches"], v["kinds"])
                     for k, v in paths.items()), planted))
    log("data: crop_mirror_normalize (resize 256, 32 images) %.4f ms a call "
        "(events; %.0f%% of the bound), %.4f ms device (profiler, %.0f%%), "
        "plain %.3f ms, bound %.4f ms (bytes, %d B); context, not the same "
        "function: F.interpolate bicubic of a %dx%d float window + "
        "normalise %.4f ms; %s"
        % (ms, 100 * row["bound_ms"] / ms, device_ms,
           100 * row["bound_ms"] / device_ms, plain_ms, row["bound_ms"],
           nbytes, side, side, interp_ms, "; ".join(res["ptxas"])))
    return res


def cli_args(*extra):
    return ["--network", "resnet", "--num-layers", "50", "--batch-size",
            str(RESNET_BATCH), "--disp-batches", "8"] + list(extra) + \
        CLI_EXTRA


def cli_synthetic(torch, mx, fu, module_img_s):
    """Phase 25: ``train_imagenet.main(... --benchmark 1)`` in-process,
    48 batches: img/s from its Speedometer lines, one
    ``sgd_fused_update`` launch a step and its plain version never,
    no input copied by the executor."""
    from mxnet_tpu_torch import executor
    from mxnet_tpu_torch.examples import train_imagenet
    plain_calls = [0]
    real_plain = fu._sgd_fused

    def spy(*args):
        plain_calls[0] += 1
        return real_plain(*args)

    fu.reset_launches()
    executor.INPUT_COPIES["count"] = 0
    fu._sgd_fused = spy
    try:
        with LogLines() as logs:
            t0 = time.perf_counter()
            mod = train_imagenet.main(cli_args(
                "--benchmark", "1", "--num-epochs", "1", "--max-batches",
                str(CLI_BATCHES)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        fu._sgd_fused = real_plain
    launches = fu.LAUNCHES["sgd_fused_update"]
    check(launches == CLI_BATCHES, "CLI: sgd_fused_update launched %d "
          "times for %d steps" % (launches, CLI_BATCHES))
    check(plain_calls[0] == 0, "CLI: the plain SGD rule ran")
    check(executor.INPUT_COPIES["count"] == 0, "CLI: the executor copied "
          "%d inputs" % executor.INPUT_COPIES["count"])
    speeds = logs.speeds(0)
    # a line at batches 8, 16, ..., each over the 8 batches before it
    check(len(speeds) == (CLI_BATCHES - 1) // 8, "Speedometer lines: %s"
          % speeds)
    img_s = float(np.mean(speeds[-3:]))
    out = mod.get_outputs()[0].asnumpy()
    check(np.isfinite(out).all(), "CLI: non-finite outputs")
    del mod
    res = {"img_per_s": img_s, "speedometer": speeds, "wall_s": wall,
           "launches": launches, "ratio_to_module_fit": img_s / module_img_s}
    log("cli --benchmark 1: %d steps in %.2fs; Speedometer img/s %s; the "
        "last 3 lines %.1f img/s, %.3fx phase 13's %.1f; "
        "sgd_fused_update %d launches; nproc %d"
        % (CLI_BATCHES, wall, [round(v, 1) for v in speeds], img_s,
           res["ratio_to_module_fit"], module_img_s, launches,
           os.cpu_count()))
    return res


def cli_records(torch, mx, fu, idec, rec, prefix):
    """Phase 26: ``train_imagenet.main`` on the records with checkpoints,
    two epochs of 24 batches. Every count is 0 just before and read just
    after: 48 update launches; every batch decoded on the native route
    (nvjpeg) by one ``crop_mirror_normalize`` launch; the batches reach
    ``Module.fit`` on the card (the executor copies no input); the loss
    is finite. Then the manifests verify, ``Module.load(prefix, 2,
    load_optimizer_states=True)`` gives the trained module's parameters
    and optimizer states bitwise, a profiled window of 8 real-data steps
    gives the device's busy share, and ``--load-epoch 1`` resumes: its
    loaded parameters equal checkpoint 1's bitwise (``--num-epochs 1``,
    no step), and the resumed epoch's loss is finite."""
    from mxnet_tpu_torch import checkpoint, executor
    from mxnet_tpu_torch.examples import train_imagenet
    from mxnet_tpu_torch.examples.common import data as cli_data
    dev = mx.gpu(0)
    shutil.rmtree(os.path.dirname(prefix), ignore_errors=True)
    argv = cli_args("--data-train", rec, "--random-crop", "1",
                    "--random-mirror", "1", "--max-batches", "24",
                    "--model-prefix", prefix, "--loss", "ce")
    fu.reset_launches()
    idec.reset_launches()
    mx.image.reset_routes()
    executor.INPUT_COPIES["count"] = 0
    with LogLines() as logs:
        t0 = time.perf_counter()
        mod = train_imagenet.main(argv + ["--num-epochs", "2"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = fu.LAUNCHES["sgd_fused_update"]
    routes, backends = dict(mx.image.ROUTES), dict(mx.image.BACKENDS)
    kernel_launches = idec.LAUNCHES["crop_mirror_normalize"]
    copies = executor.INPUT_COPIES["count"]
    check(steps == 48, "records fit: %d update launches for 48 steps"
          % steps)
    check(routes["python"] == 0 and routes["native"] >= 48,
          "records fit: routes %s" % routes)
    check(backends[DECODE_BACKEND] == routes["native"]
          and kernel_launches == routes["native"],
          "records fit: backends %s, crop_mirror_normalize launches %d"
          % (backends, kernel_launches))
    check(copies == 0, "records fit: the executor copied %d inputs: the "
          "batches did not arrive on the card" % copies)
    ce = logs.train_value("cross-entropy")
    check(sorted(ce) == [0, 1] and all(np.isfinite(v) for v in ce.values()),
          "records fit: cross-entropy %s" % ce)
    speeds = logs.speeds(1)
    img_s = float(np.mean(speeds))
    mans = [checkpoint.verify_checkpoint(prefix, e) for e in (1, 2)]
    check(all(m["has_optimizer_states"] for m in mans),
          "checkpoints without optimizer states")
    loaded = mx.mod.Module.load(prefix, 2, load_optimizer_states=True,
                                context=mx.gpu(0))
    loaded.bind(data_shapes=mod.data_shapes, label_shapes=mod.label_shapes)
    loaded.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    # the loaded module's bound arrays on the card against the trained
    # module's
    te, le = mod._exec, loaded._exec
    check(all(torch.equal(te.arg_dict[k]._data, le.arg_dict[k]._data)
              for k in mod._param_names)
          and all(torch.equal(te.aux_dict[k]._data, le.aux_dict[k]._data)
                  for k in mod._aux_names)
          and le.arg_dict[mod._param_names[0]]._data.device.type == "cuda",
          "Module.load: parameters differ from the trained module's")
    states = 0
    for i, st in mod._updater.states.items():
        w = loaded._exec.arg_dict[loaded._param_names[i]]
        got = loaded._updater.ensure_state(i, w)
        check(torch.equal(st._data, got._data), "Module.load: optimizer "
              "state %d differs" % i)
        states += 1
    check(states == len(mod._param_names), "%d optimizer states for %d "
          "parameters" % (states, len(mod._param_names)))
    del loaded
    # a profiled window of real-data steps: the CLI's pipeline feeding the
    # trained module as the fit does
    it, _ = cli_data.get_rec_iter(train_imagenet.parse_args(argv), dev)
    for _ in range(2):
        batch = it.next()
        mod.forward_backward(batch)
        mod.update()
    torch.cuda.synchronize()

    def window():
        for _ in range(8):
            b = it.next()
            mod.forward_backward(b)
            mod.update()

    prof = profile_run(torch, window, _resnet_class)
    it.close()
    del mod
    # resume: --load-epoch 1 loads checkpoint 1's parameters ...
    _, arg1, aux1 = mx.model.load_checkpoint(prefix, 1)
    resumed = train_imagenet.main(argv + ["--load-epoch", "1",
                                          "--num-epochs", "1"])
    ra, rx = resumed.get_params()
    check(all(torch.equal(ra[k]._data.cpu(), arg1[k]._data) for k in arg1)
          and all(torch.equal(rx[k]._data.cpu(), aux1[k]._data)
                  for k in aux1),
          "--load-epoch 1: the loaded parameters differ from checkpoint 1")
    del resumed
    # ... and trains the second epoch from them
    with LogLines() as rlogs:
        resumed = train_imagenet.main(argv + ["--load-epoch", "1",
                                              "--num-epochs", "2"])
        torch.cuda.synchronize()
    rce = rlogs.train_value("cross-entropy")
    check(sorted(rce) == [1] and np.isfinite(rce[1]),
          "resumed epoch: cross-entropy %s" % rce)
    del resumed
    ckpt_bytes = sum(os.path.getsize(os.path.join(os.path.dirname(prefix), f))
                     for f in os.listdir(os.path.dirname(prefix)))
    shutil.rmtree(os.path.dirname(prefix), ignore_errors=True)
    res = {"wall_s": wall, "steps": steps, "routes": routes,
           "backends": backends, "kernel_launches": kernel_launches,
           "executor_input_copies": copies, "cross_entropy": ce,
           "epoch2_speedometer": speeds, "epoch2_img_per_s": img_s,
           "optimizer_states_bitwise": states, "profiled_window": prof,
           "resumed_cross_entropy": rce[1], "checkpoint_bytes": ckpt_bytes}
    log("cli records: 2 epochs of 24 batches in %.2fs; routes %s, backends "
        "%s, crop_mirror_normalize %d launches, sgd_fused_update %d, "
        "executor input copies %d; cross-entropy %s; epoch 2 Speedometer "
        "%s img/s (mean %.1f; 4 decode threads, nproc %d)"
        % (wall, routes, backends, kernel_launches, steps, copies,
           {k: round(v, 4) for k, v in ce.items()},
           [round(v, 1) for v in speeds], img_s, os.cpu_count()))
    log("cli records: manifests 1, 2 verify; Module.load(2, optimizer "
        "states) bitwise: %d parameters' states; --load-epoch 1 loads "
        "checkpoint 1 bitwise; resumed epoch cross-entropy %.4f; "
        "checkpoint files %.1f MB"
        % (states, rce[1], res["checkpoint_bytes"] / 1e6))
    log("cli records: profiled window of 8 real-data steps: wall %.3fs, "
        "device busy %s, %d kernels, device ms by class %s"
        % (prof["wall_s"], "not measured" if prof["busy_share"] is None
           else "%.1f%%" % (100 * prof["busy_share"]), prof["kernels"],
           {k: round(v, 3) for k, v in prof["device_ms"].items()}))
    return res


# ---------------------------------------------------------------------------
# phases 28-29: the CLI's other networks, and the op surface on the card
# ---------------------------------------------------------------------------

NET_BATCHES = 32        # phase 28: --max-batches a network (Speedometer
#                         lines at batches 8, 16 and 24; the first, with
#                         the warm-up, is left out of img/s)
NET_SCORE_BATCHES = 16  # batch-32 forwards in a timed scoring window
NET_EXTRA = []          # appended to the CLI's arguments (a CPU rehearsal)
NET_LR = "0.001"        # the CLI's default 0.1, and 0.01, send VGG16 (no
#                         BatchNorm; its He-initialized logits start near a
#                         loss of 11) to NaN within a few steps, in the JAX
#                         package as in the port
NETWORKS = (("alexnet", ["--network", "alexnet"]),
            ("vgg16", ["--network", "vgg", "--num-layers", "16"]),
            ("mobilenet", ["--network", "mobilenet"]),
            ("inception-bn", ["--network", "inception-bn"]))
# BASELINE.md (docs/faq/perf.md:147-214), 1x V100, batch 32, float32:
# published context, not a target (no MobileNet figure is published;
# AlexNet's training figure is at batch 32 x 16)
V100_IMG_S = {"alexnet": {"score": 7906.09, "train": 2585.61},
              "vgg16": {"score": 708.43}, "inception-bn": {"score": 1847.26}}
NET_CHECK_IMAGE = (3, 224, 224)     # the card-vs-f64 step's input
# phase 28's floor under the ratio rule: a weight change within 1e-5
# relative RMS of the witness's (a hundred float32 ulps) passes whatever
# the CPU's error. Where float32 is well-conditioned both sides sit at
# its rounding, and the ratio measures which algorithms cuDNN and the
# CPU picked: VGG16's card error read 1.84e-6 against the CPU's 9.07e-7
# (2.03x) in its first card run. The planted faults sit at 1e-2 and
# above.
NET_F32_FLOOR = 1e-5
DROPOUT_P = 0.5
DROPOUT_N = 1 << 22     # values a Dropout draw on the card


def lrn_without_nsize(torch, real):
    """A planted fault: LRN whose ``alpha / nsize`` lost its divisor."""
    @functools.wraps(real)
    def fn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
        return real(data, alpha=alpha * nsize, beta=beta, knorm=knorm,
                    nsize=nsize)
    return fn


def dropout_unscaled(torch, real):
    """A planted fault: Dropout without its ``1 / (1 - p)``."""
    @functools.wraps(real)
    def fn(gen, data, p=0.5, **attrs):
        return real(gen, data, p=p, **attrs) * (1.0 - p)
    return fn


# the planted fault of each network's card-vs-f64 step (alexnet: LRN
# without its 1 / nsize; the BatchNorm nets: phase 14's; vgg16 has
# neither op, and phase 28's Dropout check plants its own)
NET_PLANTS = {"alexnet": ("LRN", lrn_without_nsize),
              "mobilenet": ("BatchNorm", bn_unbiased_backward),
              "inception-bn": ("BatchNorm", bn_unbiased_backward)}


def _network_class(name):
    """Phase 28's kernel classes: phase 13's, and the draws of Dropout's
    masks."""
    low = name.lower()
    if "distribution" in low or "uniform" in low or "philox" in low:
        return "dropout_rng"
    return _resnet_class(name)


def network_flops(mx, sym, image=SERVE_IMAGE):
    """Training FLOPs of one image: 3 x 2 x the multiply-adds of every
    Convolution and FullyConnected (forward, and a backward of twice
    that)."""
    from mxnet_tpu_torch.symbol.symbol import _topo
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(data=(1,) + image)
    shapes = dict(zip(internals.list_outputs(), outs))
    args = dict(zip(sym.list_arguments(),
                    sym.infer_shape(data=(1,) + image)[0]))
    macs = 0
    for node in _topo(sym._entries):
        if node.op in ("Convolution", "FullyConnected"):
            w = args[node.inputs[1][0].name]
            macs += int(np.prod(shapes[node.name + "_output"])) * int(
                np.prod(w[1:]))
    return 3 * 2 * macs


def no_dropout(mx, sym):
    """``sym`` with every Dropout's ``p`` set to 0, through its JSON."""
    graph = json.loads(sym.tojson())
    for node in graph["nodes"]:
        if node["op"] == "Dropout":
            node["attrs"]["p"] = 0.0
    return mx.sym.load_json(json.dumps(graph))


def cli_networks(torch, mx, fu):
    """Phase 28 (speed): ``train_imagenet.main`` for each of NETWORKS at
    batch 32, 3x224x224, 1000 classes, ``--benchmark 1``, NET_BATCHES
    batches: one ``sgd_fused_update`` launch a step and its plain
    version never, no input copied by the executor, finite outputs;
    img/s from the Speedometer lines (the first left out), ms/step, MFU
    over the network's conv and FC FLOPs (TF32 off); then a timed
    scoring window (``Module.predict`` over NET_SCORE_BATCHES batches on
    the card) beside BASELINE.md's 1x V100 figure, and one profiled
    step (busy share, device ms by class)."""
    from mxnet_tpu_torch import executor
    from mxnet_tpu_torch.examples import train_imagenet
    plain_calls = [0]
    real_plain = fu._sgd_fused

    def spy(*args):
        plain_calls[0] += 1
        return real_plain(*args)

    res = {}
    for name, argv in NETWORKS:
        fu.reset_launches()
        executor.INPUT_COPIES["count"] = 0
        fu._sgd_fused = spy
        try:
            with LogLines() as logs:
                t0 = time.perf_counter()
                mod = train_imagenet.main(argv + [
                    "--benchmark", "1", "--batch-size", str(RESNET_BATCH),
                    "--image-shape", "3,224,224", "--num-classes", "1000",
                    "--num-epochs", "1", "--max-batches", str(NET_BATCHES),
                    "--disp-batches", "8", "--lr", NET_LR] + NET_EXTRA)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            fu._sgd_fused = real_plain
        launches = fu.LAUNCHES["sgd_fused_update"]
        check(launches == NET_BATCHES, "%s CLI: sgd_fused_update launched "
              "%d times for %d steps" % (name, launches, NET_BATCHES))
        check(plain_calls[0] == 0, "%s CLI: the plain SGD rule ran" % name)
        check(executor.INPUT_COPIES["count"] == 0, "%s CLI: the executor "
              "copied %d inputs" % (name, executor.INPUT_COPIES["count"]))
        speeds = logs.speeds(0)
        check(len(speeds) == (NET_BATCHES - 1) // 8, "%s Speedometer lines:"
              " %s" % (name, speeds))
        img_s = float(np.mean(speeds[1:]))
        out = mod.get_outputs()[0].asnumpy()
        check(np.isfinite(out).all(), "%s CLI: non-finite outputs" % name)
        batch, shape = out.shape[0], mod.data_shapes[0][1]
        image = tuple(shape[1:])
        flop = network_flops(mx, mod.symbol, image)
        mfu = img_s * flop / F32_FLOPS
        check(mfu <= 1.05, "%s: %.0f img/s implies MFU %.2f > 1"
              % (name, img_s, mfu))
        dev = mod._exec._ctx
        warm = synthetic_iter(mx, shape, 1000, 2, dev)
        mod.predict(warm, merge_batches=False)
        it = synthetic_iter(mx, shape, 1000, NET_SCORE_BATCHES, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = mod.predict(it, merge_batches=False)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        check(len(outs) == NET_SCORE_BATCHES and np.isfinite(
            outs[-1][0].asnumpy()).all(), "%s scoring: outputs" % name)
        score_img_s = NET_SCORE_BATCHES * batch / score_s
        one = next(iter(synthetic_iter(mx, shape, 1000, 1, dev)))
        fu.reset_launches()

        def one_step():
            mod.forward_backward(one)
            mod.update()

        prof = profile_run(torch, one_step, _network_class)
        check(fu.LAUNCHES["sgd_fused_update"] == 1, "%s profiled step "
              "launched sgd_fused_update %d times"
              % (name, fu.LAUNCHES["sgd_fused_update"]))
        v100 = V100_IMG_S.get(name, {})
        res[name] = {"img_per_s": img_s, "ms_per_step": batch / img_s * 1e3,
                     "mfu": mfu, "gflop_per_img": flop / 1e9,
                     "speedometer": speeds, "wall_s": wall,
                     "launches": launches, "score_img_per_s": score_img_s,
                     "score_ms_per_batch": score_s / NET_SCORE_BATCHES * 1e3,
                     "v100_published": v100, "profiled_step": prof}
        log("%s: train batch %d: %.1f img/s, %.2f ms/step, MFU %.3f (%.2f "
            "GFLOP/img, 67 TFLOP/s f32); Speedometer %s; %d steps in %.1fs; "
            "sgd_fused_update %d launches; score batch %d: %.1f img/s; "
            "published 1x V100 (BASELINE.md, context only): %s"
            % (name, batch, img_s, res[name]["ms_per_step"], mfu, flop / 1e9,
               [round(v, 1) for v in speeds], NET_BATCHES, wall, launches,
               batch, score_img_s, v100 or "none"))
        log("%s profiled step: wall %.3fs, device busy %s, %d kernels, "
            "device ms by class %s; top %s"
            % (name, prof["wall_s"], "not measured" if prof["busy_share"]
               is None else "%.1f%%" % (100 * prof["busy_share"]),
               prof["kernels"], {k: round(v, 3) for k, v in
                                 prof["device_ms"].items()},
               "; ".join("%.3f ms %s" % (ms, n[:60])
                         for n, ms in prof["top_kernels_ms"][:4])))
        del mod, outs
    return res


def dropout_misses(torch, mx, dev):
    """Phase 28's Dropout check on ``dev`` (the misses, empty when it
    holds): ``nd.Dropout`` at p = DROPOUT_P under ``autograd.record``
    over DROPOUT_N values keeps a share within 4 sigma of 1 - p, each
    kept value exactly ``x / (1 - p)``; the gradient is the head times
    the forward's mask over 1 - p; a second draw differs and
    ``random.seed`` repeats the first; a Module-style executor
    (``train_step``, FC + Dropout) updates only the weight rows of units
    its masks kept, and repeats itself after a re-seed."""
    misses = []
    rng = np.random.RandomState(4)
    x = mx.nd.array(rng.uniform(0.5, 1.5, DROPOUT_N).astype(np.float32),
                    ctx=dev)
    head = mx.nd.array(rng.uniform(-1, 1, DROPOUT_N).astype(np.float32),
                       ctx=dev)
    keep = 1.0 - DROPOUT_P

    def draw():
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Dropout(x, p=DROPOUT_P)
        y.backward(head)
        return y._data.clone(), x.grad._data.clone()

    mx.random.seed(21)
    y, g = draw()
    y2, _ = draw()
    mx.random.seed(21)
    y3, _ = draw()
    kept = y != 0
    share = float(kept.float().mean())
    sigma = (DROPOUT_P * keep / DROPOUT_N) ** 0.5
    if abs(share - keep) > 4 * sigma:
        misses.append("kept share %.5f, want %.2f +- %.5f" % (
            share, keep, 4 * sigma))
    if not torch.equal(y[kept], x._data[kept] / keep):
        misses.append("kept values are not x / (1 - p)")
    mask = kept.to(torch.float32) / keep
    if not torch.equal(g, head._data * mask):
        misses.append("the gradient is not the forward's mask")
    if torch.equal(y, y2):
        misses.append("two draws gave one mask")
    if not torch.equal(y, y3):
        misses.append("a re-seed did not repeat the mask")
    # the executor: one mask a step, in the forward and the backward
    data = mx.sym.var("data")
    net = mx.sym.Dropout(mx.sym.FullyConnected(data, num_hidden=1024,
                                               name="fc"), p=DROPOUT_P)
    x0 = rng.uniform(-1, 1, (1, 64)).astype(np.float32)
    w0 = rng.uniform(-1, 1, (1024, 64)).astype(np.float32)
    runs = []
    for _ in range(2):
        ex = net.simple_bind(ctx=dev, data=(1, 64))
        ex.arg_dict["data"][:] = x0
        ex.arg_dict["fc_weight"][:] = w0
        mx.random.seed(22)
        outs = []
        for _ in range(2):
            def rule(ws, gs, states, hypers):
                for w, gr in zip(ws, gs):
                    w.sub_(0.1 * gr)
            (o,) = ex.train_step(rule, ["fc_weight"], {"fc_weight": ()},
                                 {"fc_weight": {}})
            outs.append(o._data[0] != 0)
        runs.append((outs, ex.arg_dict["fc_weight"]._data.clone()))
    (kept1, kept2), w = runs[0]
    # a unit's weight row moves exactly when a step's mask kept it
    moved = (w - torch.from_numpy(w0).to(w.device)).abs().sum(dim=1) > 0
    if torch.equal(kept1, kept2):
        misses.append("executor: two steps drew one mask")
    if not torch.equal(moved, kept1 | kept2):
        misses.append("executor: %d weight rows moved, %d units kept: the "
                      "backward's masks are not the forward's"
                      % (int(moved.sum()), int((kept1 | kept2).sum())))
    if not (torch.equal(w, runs[1][1]) and all(
            torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))):
        misses.append("executor: a re-seed did not repeat the steps")
    return misses


def networks_vs_cpu(torch, mx, fu):
    """Phase 28 (correctness): per network at full width, one fused SGD
    step at batch 2 of 3x224x224 on the card and on the CPU in float32
    against the CPU's float64 witness (``resnet_vs_f64``, phase 14's
    step-1 rule: outputs and moving statistics within RESNET_OUT_TOL /
    RESNET_DSTAT_TOL, weight changes within RESNET_RATIO_TOL x the CPU's
    own float32 error or NET_F32_FLOOR), AlexNet and VGG with every
    Dropout's p set to 0
    through their JSON; each network's planted fault (NET_PLANTS) must
    miss. Then ``dropout_misses`` on the card, and with Dropout's
    ``1 / (1 - p)`` dropped, which must miss."""
    from mxnet_tpu_torch.examples import train_imagenet
    from mxnet_tpu_torch.ops import registry as reg
    res = {}
    for name, argv in NETWORKS:
        sym = no_dropout(mx, train_imagenet.get_network(
            train_imagenet.parse_args(argv + ["--num-classes", "1000"])))
        plant = NET_PLANTS.get(name)
        sides = ("cpu", "dev", "planted") if plant else ("cpu", "dev")
        (row,) = resnet_vs_f64(torch, mx, fu, batch=2, steps=1, sides=sides,
                               sym=sym, plant=plant, label=name,
                               image=NET_CHECK_IMAGE)
        misses = resnet_misses(row["dev"], row["cpu"], 1, NET_F32_FLOOR)
        check(not misses, "%s vs f64: the card is off: %s"
              % (name, "; ".join(misses)))
        planted = resnet_misses(row["planted"], row["cpu"], 1,
                                    NET_F32_FLOOR) \
            if plant else None
        check(planted is None or planted, "%s vs f64: the planted %s fault "
              "passes" % (name, plant and plant[0]))
        log("%s vs f64: card/CPU error ratios: %s; planted %s misses %s"
            % (name, ", ".join("%s %.2f" % (k, row["dev"][k] / max(
                row["cpu"][k], 1e-30)) for k in ("dw_median", "dw_max")),
               plant and plant[0], planted))
        res[name] = {side: {k: v for k, v in r.items()
                            if k not in ("dw", "ds")}
                     for side, r in row.items() if isinstance(r, dict)}
    dev = mx.gpu(0)
    misses = dropout_misses(torch, mx, dev)
    check(not misses, "dropout on the card: %s" % "; ".join(misses))
    op = reg.get_op("Dropout")
    real = op.fn
    op.fn = dropout_unscaled(torch, real)
    try:
        planted = dropout_misses(torch, mx, dev)
    finally:
        op.fn = real
    check(planted, "dropout on the card: the planted fault (no 1 / (1 - p))"
          " passes")
    log("dropout on the card (p %.1f, %d values): holds; the planted fault "
        "misses %s" % (DROPOUT_P, DROPOUT_N, planted))
    res["dropout"] = {"planted_misses": planted}
    return res


SWEEP_FWD_TOL = 2e-5    # card vs CPU, float32 outputs: summation order,
#                         CUDA's transcendental functions (a few ulps)
SWEEP_GRAD_TOL = 1e-4   # and gradients (atomics in scatter-adds)
SWEEP_SLOW_TOL = {"erfinv": 1e-4, "gamma": 1e-4, "gammaln": 1e-4}
SWEEP_FILES = ("creation.py", "elemwise.py", "reduce.py", "matrix.py",
               "nn.py")
SWEEP_ELSEWHERE = {"RNN"}   # phase 37 holds it, card against CPU


def op_sweep(torch, mx):
    """Phase 29: every op of the port's ``ops/{creation,elemwise,reduce,
    matrix,nn}.py`` (the core op surface) but ``RNN`` (phase 37's) on
    CUDA tensors against the same op on CPU tensors, at the three shapes
    of its case in ``tests/torch_op_cases.py``: the forward, and the
    gradient where the op is differentiable; integer and index outputs
    bitwise (with their types), float outputs within SWEEP_FWD_TOL
    (gradients SWEEP_GRAD_TOL) of the largest magnitude; every output on
    the card. Then integer
    reductions and ties on the card: sum / prod / mean / argmax / topk /
    argsort of int32, uint8 and tied float inputs bitwise against the
    CPU's."""
    import inspect
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tests"))
    import torch_op_cases as cases
    reg = mx.ops.registry
    names = [n for n in reg.list_ops() if os.path.basename(
        inspect.getsourcefile(reg.get_op(n).fn)) in SWEEP_FILES
        and n not in SWEEP_ELSEWHERE]
    by_fn = {}
    for n in cases.SPECS:
        if n in reg._REGISTRY:
            by_fn.setdefault(reg.get_op(n).fn, n)
    dev, cpu = mx.gpu(0), mx.cpu()
    worst = {}
    t0 = time.time()
    for name in names:
        case = name if name in cases.SPECS else by_fn.get(reg.get_op(name).fn)
        check(case is not None, "op sweep: no case for %s" % name)
        sp = cases.SPECS[case]
        op = reg.get_op(name)
        tol = SWEEP_SLOW_TOL.get(name, SWEEP_FWD_TOL)
        err = 0.0
        for i, shape in enumerate(sp["shapes"]):
            inputs = sp["make"](np.random.RandomState(1000 + i), shape)
            attrs = cases.attrs_at(sp, i)
            wanted = cases.wanted_grads(sp, inputs, op.differentiable)
            heads = {}
            c_out, c_grad, _ = cases.run_case(
                mx, name, inputs, attrs, wanted, heads,
                np.random.RandomState(7 + i), ctx=cpu)
            g_out, g_grad, outs = cases.run_case(
                mx, name, inputs, attrs, wanted, heads,
                np.random.RandomState(7 + i), ctx=dev)
            check(all(o.context == dev for o in outs),
                  "op sweep: %s left the card" % name)
            try:
                for k, (g, c) in enumerate(zip(g_out, c_out)):
                    cases.close(g, c, tol, "%s[%d] output %d" % (name, i, k))
                for k, (g, c) in enumerate(zip(g_grad or [], c_grad or [])):
                    cases.close(g, c, max(tol, SWEEP_GRAD_TOL),
                                "%s[%d] grad %d" % (name, i, wanted[k]))
            except AssertionError as e:
                check(False, "op sweep: card vs CPU: %s" % e)
            for g, c in zip(g_out + (g_grad or []), c_out + (c_grad or [])):
                if c.dtype.kind == "f" and c.size:
                    fin = np.isfinite(c)
                    if fin.any():
                        err = max(err, float(np.abs(
                            g[fin].astype(np.float64) - c[fin]).max()
                            / max(np.abs(c[fin]).max(), 1e-30)))
        worst[name] = err
    # integer reductions and ties, bitwise with their types
    rng = np.random.RandomState(3)
    extra = 0
    for dtype in ("int32", "uint8", "int8"):
        src = rng.randint(0, 7, (3, 40, 5)).astype(dtype)
        for op_name, attrs in (("sum", {}), ("sum", {"axis": 1}),
                               ("prod", {"axis": 2}), ("mean", {}),
                               ("max", {"axis": 0}), ("argmax", {"axis": 1}),
                               ("argsort", {"axis": 1}),
                               ("topk", {"k": 4, "axis": 1,
                                         "ret_typ": "both"})):
            got, want = [], []
            for ctx, sink in ((dev, got), (cpu, want)):
                with ctx:
                    r = mx.nd.invoke_op(op_name, [mx.nd.array(
                        src, ctx=ctx, dtype=dtype)], attrs)
                sink.extend(x.asnumpy() for x in (r if isinstance(r, list)
                                                  else [r]))
            for g, w in zip(got, want):
                check(g.dtype == w.dtype and np.array_equal(g, w),
                      "op sweep: %s %s of %s: card %s %s, CPU %s %s"
                      % (op_name, attrs, dtype, g.dtype, g.ravel()[:6],
                         w.dtype, w.ravel()[:6]))
            extra += 1
    wall = time.time() - t0
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    log("op sweep: %d ops x 3 cases on the card against the CPU, forward "
        "and gradient, plus %d integer / tie cases bitwise: all held in "
        "%.1fs; largest relative errors %s" % (
            len(names), extra, wall, ", ".join("%s %.2e" % kv for kv in top)))
    return {"ops": len(names), "integer_cases": extra, "wall_s": wall,
            "max_rel_err": worst}


# ---------------------------------------------------------------------------
# phases 30-34: the Gluon model zoo at full width, and train_mnist
# ---------------------------------------------------------------------------

ZOO_SIDE = {"inceptionv3": 299}     # its final AvgPool2D(8); the rest 224
INCEPTION_OPT = {"learning_rate": 0.05, "momentum": 0.9}    # benchmark.py
#                                     train_inception's SGD
INCEPTION_BATCHES = 24  # a warm and a timed epoch of this many batches
INCEPTION_V100 = 214.48     # benchmark.py:45, 1x V100: context, no target
MOBILENET_WINDOWS = ("eager", "hybridized", "hybridized", "eager")
ZOO_SCORE = ("alexnet", "vgg16", "vgg16_bn", "squeezenet1.0",
             "squeezenet1.1", "densenet121", "inceptionv3", "mobilenet1.0",
             "mobilenetv2_1.0")
ZOO_FORWARDS = 20       # batch-32 forwards a timed scoring window
ZOO_SCORE_V100 = {"alexnet": 7906.09, "vgg16": 708.43,
                  "inceptionv3": 814.59}    # benchmark.py:48-51: context
ZOO_EXPORTED = ("inceptionv3", "mobilenetv2_1.0")
# card vs CPU logits at batch 2, float32 (TF32 off) from the same weights,
# relative to the largest logit: up to 121 layers (DenseNet) summed in
# other orders by other algorithms (cuDNN against oneDNN), each step a
# few ulps of 2^-24 ~ 6e-8, growing along the depth; sound nets read
# below 1e-5 (PERF.md), the planted faults 1e-2 and above
ZOO_PATH_TOL = 1e-4
# phase 33: (net, BatchNorm nodes, planted fault). Phase 14's BatchNorm
# fault (the unbiased variance's gradient) moves a gradient by about
# 1 / (N - 1), N the values of a channel: at batch 2 Inception's fewest
# are 128 (8x8), and its float32 step is ill-conditioned (the CPU's
# weight changes read 2.45e-2 median off the float64 witness's), so on
# an H100 the fault sat at 1.68x the CPU's error, inside the ratio rule;
# Inception plants phase 23's (gamma's gradient doubled)
ZOO_F64 = (("inceptionv3", 94, "gamma"), ("mobilenetv2_1.0", 53, "bn"),
           ("densenet121", 121, "bn"))
# phase 33: a change whose float64 RMS is at most ZOO_EXACT_ZERO is zero
# in exact arithmetic (its float64 value is rounding, ~1e-17): MobileNet
# v2's linear bottlenecks feed a BatchNorm's output (channel means = its
# beta) through 1x1 convs into other BatchNorms, which makes those convs'
# batch means and the first BatchNorm's beta gradient exactly zero. Such
# a tensor's float32 change, noise on either side, is held to at most
# ZOO_ZERO_TOL (RMS): the CPU's read 2.6e-7 for MobileNet v2 (34 such
# tensors), and a planted update of lr 0.1 x a gradient of 1e-3 reads 1e-4
ZOO_EXACT_ZERO = 1e-12
ZOO_ZERO_TOL = 1e-5
# phase 34: the CLI's NDArrayIter shuffles from numpy's global generator
# (the JAX package's rule), which nothing seeds, so the phase drew a new
# order each run; at the default lr 0.3 / momentum 0.9 the MLP collapses
# to chance on some orders in both packages (on the CPU, shuffles seeded
# 0-7: the port's on 3, the JAX package's on 2). Seeded for a
# reproducible run.
MNIST_SHUFFLE_SEED = 0
MNIST_EXTRA = []        # appended to train_mnist's arguments (a CPU
#                         rehearsal)


def zoo_image(name):
    return (3,) + (ZOO_SIDE.get(name, 224),) * 2


def zoo_net(mx, name, ctx, seed):
    """``get_model(name, classes=1000)`` initialized on ``ctx`` from a
    seed (Xavier, gaussian, in, 2: the CLI's), its deferred shapes
    finished by one predict-mode forward."""
    mx.random.seed(seed)
    net = mx.gluon.model_zoo.vision.get_model(name, classes=1000,
                                              prefix="zoo_")
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=ctx)
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1,) + zoo_image(name), ctx=ctx))
    return net


class _PlainSGDSpy(object):
    """Counts calls of the plain SGD rule while it is entered."""

    def __init__(self, fu):
        self.fu, self.calls = fu, 0

    def __enter__(self):
        self.real = self.fu._sgd_fused

        def spy(*args):
            self.calls += 1
            return self.real(*args)
        self.fu._sgd_fused = spy
        return self

    def __exit__(self, *exc):
        self.fu._sgd_fused = self.real
        return False


def inception_fit(torch, mx, fu):
    """Phase 30: Inception v3 trained as ``benchmark.py``'s
    ``train_inception`` does: ``get_model("inceptionv3", classes=1000)``
    initialized on the card, traced by ``_trace_symbol`` under
    ``SoftmaxOutput``, through ``Module.fit`` at batch 32 of float32
    3x299x299 (TF32 off), SGD lr 0.05 momentum 0.9, a warm and a timed
    epoch of INCEPTION_BATCHES synthetic batches on the card:
    ``sgd_fused_update`` once a step and its plain version never, no
    input copied by the executor, finite outputs, weights and moving
    statistics changed; img/s, ms/step, MFU over the net's own conv and
    FC FLOPs; one profiled step; the V100's published 214.48 img/s
    beside it as context."""
    from mxnet_tpu_torch import executor
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    ctx = mx.gpu(0)
    image = zoo_image("inceptionv3")
    net = zoo_net(mx, "inceptionv3", ctx, 30)
    sym = mx.sym.SoftmaxOutput(net._trace_symbol(), name="softmax")
    names, auxs = set(sym.list_arguments()), set(sym.list_auxiliary_states())
    params = net.collect_params()
    arg = {k: p.data() for k, p in params.items() if k in names}
    aux = {k: p.data() for k, p in params.items() if k in auxs}
    flop = network_flops(mx, sym, image)
    shape = (RESNET_BATCH,) + image
    train = mx.io.ResizeIter(synthetic_iter(mx, shape, 1000, 1 << 20, ctx),
                             INCEPTION_BATCHES)
    ends, resumed, snaps = [], [], []

    def epoch_end(epoch, _sym, a, x):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        snaps.append(({k: v.asnumpy() for k, v in a.items()},
                      {k: v.asnumpy() for k, v in x.items()}))
        resumed.append(time.perf_counter())

    mod = mx.mod.Module(sym, context=ctx)
    fu.reset_launches()
    executor.INPUT_COPIES["count"] = 0
    with _PlainSGDSpy(fu) as plain:
        t0 = time.perf_counter()
        mod.fit(train, num_epoch=2, epoch_end_callback=epoch_end,
                kvstore="device", optimizer="sgd",
                optimizer_params=INCEPTION_OPT, arg_params=arg,
                aux_params=aux, eval_metric="acc")
    steps = 2 * INCEPTION_BATCHES
    launches = fu.LAUNCHES["sgd_fused_update"]
    check(launches == steps, "inception fit: sgd_fused_update launched %d "
          "times for %d steps" % (launches, steps))
    check(plain.calls == 0, "inception fit: the plain SGD rule ran %d times"
          % plain.calls)
    check(executor.INPUT_COPIES["count"] == 0, "inception fit: the executor "
          "copied %d inputs" % executor.INPUT_COPIES["count"])
    out = mod.get_outputs()[0].asnumpy()
    check(out.shape == (RESNET_BATCH, 1000) and np.isfinite(out).all(),
          "inception fit: outputs %s" % (out.shape,))
    (a0, x0), (a1, x1) = snaps
    w_moved = max(float(np.abs(a1[k] - a0[k]).max()) for k in a0)
    s_moved = max(float(np.abs(x1[k] - x0[k]).max()) for k in x0)
    check(w_moved > 0 and s_moved > 0 and all(
        np.isfinite(v).all() for v in a1.values()), "inception fit: weights "
          "(%g) or moving statistics (%g) did not change, or are not finite"
          % (w_moved, s_moved))
    dt = ends[1] - resumed[0]
    img_s = RESNET_BATCH * INCEPTION_BATCHES / dt
    mfu = img_s * flop / F32_FLOPS
    check(mfu <= 1.05, "inception fit: %.0f img/s implies MFU %.2f > 1"
          % (img_s, mfu))
    batch = next(iter(train))
    train.reset()
    fu.reset_launches()

    def one_step():
        mod.forward_backward(batch)
        mod.update()

    prof = profile_run(torch, one_step, _network_class)
    check(fu.LAUNCHES["sgd_fused_update"] == 1, "inception profiled step "
          "launched sgd_fused_update %d times"
          % fu.LAUNCHES["sgd_fused_update"])
    res = {"batch": RESNET_BATCH, "image": image,
           "timed_batches": INCEPTION_BATCHES, "warm_epoch_s": ends[0] - t0,
           "timed_epoch_s": dt, "img_per_s": img_s,
           "ms_per_step": dt * 1e3 / INCEPTION_BATCHES, "mfu": mfu,
           "gflop_per_img": flop / 1e9, "launches": launches,
           "weights_moved": w_moved, "stats_moved": s_moved,
           "v100_published": INCEPTION_V100, "profiled_step": prof}
    log("inceptionv3 fit: batch %d x 3x299x299, timed epoch %.3fs: %.1f "
        "img/s, %.2f ms/step, MFU %.3f (%.2f GFLOP/img from its conv/FC "
        "shapes, 67 TFLOP/s f32); warm epoch %.2fs; sgd_fused_update %d "
        "launches in %d steps; published 1x V100 %.2f img/s (context only)"
        % (RESNET_BATCH, dt, img_s, res["ms_per_step"], mfu, flop / 1e9,
           res["warm_epoch_s"], launches, steps, INCEPTION_V100))
    log_profile("inceptionv3 profiled step", prof)
    del mod, net
    return res


def log_profile(label, prof):
    log("%s: wall %.3fs, device busy %s, %d kernels, host launches %s "
        "(graph launches %s), device ms by class %s; top %s"
        % (label, prof["wall_s"], "not measured" if prof["busy_share"] is None
           else "%.1f%%" % (100 * prof["busy_share"]), prof["kernels"],
           prof["host_launches"], prof["graph_launches"],
           {k: round(v, 3) for k, v in prof["device_ms"].items()},
           "; ".join("%.3f ms %s" % (ms, n[:60])
                     for n, ms in prof["top_kernels_ms"][:4])))


def mobilenet_gluon(torch, mx, fu, name="mobilenet1.0"):
    """Phase 31: BASELINE.json's Gluon config, ``model_zoo.vision``
    MobileNet-1.0 hybridized, trained as phase 22 trains ResNet-50: batch
    32 of float32 3x224x224 (TF32 off), SoftmaxCrossEntropyLoss,
    ``Trainer("sgd", lr 0.1, momentum 0.9, wd 1e-4)``; two nets from one
    seeded state, eager and hybridized (its CUDA-graph replay); the
    hybridized first step's logits and loss within GLUON_FIRST_TOL of the
    eager step's; GLUON_WARM warm steps each, then timed windows of
    GLUON_TIMED steps (eager, hybridized, hybridized, eager);
    ``sgd_fused_update`` once a ``trainer.step`` in both modes and its
    plain version never; img/s, MFU; one profiled step of each mode (host
    launches, busy share)."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    ctx = mx.gpu(0)
    rng = np.random.RandomState(31)
    x = mx.nd.array(rng.uniform(-1, 1, (RESNET_BATCH,) + zoo_image(name))
                    .astype(np.float32), ctx=ctx)
    y = mx.nd.array(rng.randint(0, 1000, (RESNET_BATCH,)).astype(
        np.float32), ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    nets = {}
    for mode in ("eager", "hybridized"):
        net = zoo_net(mx, name, ctx, 31)
        if mode == "eager":
            flop, n_layers = gluon_flops(mx, net)
        else:
            gluon_params_copy(nets["eager"][0], net)
            net.hybridize()
        nets[mode] = (net, mx.gluon.Trainer(net.collect_params(), "sgd",
                                            GLUON_OPT))

    def run(mode, steps):
        net, trainer = nets[mode]
        for _ in range(steps):
            with mx.autograd.record():
                out = net(x)
                loss = loss_fn(out, y)
            loss.backward()
            trainer.step(RESNET_BATCH)
        return out, loss

    first, windows = {}, []
    with _PlainSGDSpy(fu) as plain:
        for mode in ("eager", "hybridized"):
            fu.reset_launches()
            out, loss = run(mode, 1)
            first[mode] = (out.asnumpy(), loss.asnumpy())
            run(mode, GLUON_WARM - 1)
            torch.cuda.synchronize()
            check(fu.LAUNCHES["sgd_fused_update"] == GLUON_WARM, "%s %s: "
                  "%d update launches in %d warm steps" % (
                      name, mode, fu.LAUNCHES["sgd_fused_update"],
                      GLUON_WARM))
        for mode in MOBILENET_WINDOWS:
            fu.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, loss = run(mode, GLUON_TIMED)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            img_s = RESNET_BATCH * GLUON_TIMED / dt
            windows.append({"mode": mode, "img_per_s": img_s,
                            "ms_per_step": dt * 1e3 / GLUON_TIMED,
                            "mfu": img_s * flop / F32_FLOPS,
                            "launches": fu.LAUNCHES["sgd_fused_update"],
                            "loss_mean": float(loss.asnumpy().mean())})
    for w in windows:
        check(w["launches"] == GLUON_TIMED, "%s %s: sgd_fused_update "
              "launched %d times in %d steps" % (name, w["mode"],
                                                 w["launches"], GLUON_TIMED))
        check(w["mfu"] <= 1.05 and np.isfinite(w["loss_mean"]),
              "%s %s: %.0f img/s (MFU %.2f), loss %s" % (
                  name, w["mode"], w["img_per_s"], w["mfu"], w["loss_mean"]))
    check(plain.calls == 0, "%s: the plain SGD rule ran %d times"
          % (name, plain.calls))
    first_err = {"logits": rel_max(first["hybridized"][0], first["eager"][0]),
                 "loss": rel_max(first["hybridized"][1], first["eager"][1])}
    check(max(first_err.values()) <= GLUON_FIRST_TOL, "%s: the hybridized "
          "first step is off the eager one: %s" % (name, first_err))
    profiled = {}
    for mode in ("eager", "hybridized"):
        fu.reset_launches()
        profiled[mode] = profile_run(torch, lambda: run(mode, 1),
                                     _resnet_class)
        check(fu.LAUNCHES["sgd_fused_update"] == 1, "%s %s: profiled step "
              "launched sgd_fused_update %d times"
              % (name, mode, fu.LAUNCHES["sgd_fused_update"]))
    img_s = {m: float(np.mean([w["img_per_s"] for w in windows
                               if w["mode"] == m])) for m in nets}
    res = {"batch": RESNET_BATCH, "windows": windows, "img_per_s": img_s,
           "mfu": {m: v * flop / F32_FLOPS for m, v in img_s.items()},
           "hybridized_over_eager": img_s["hybridized"] / img_s["eager"],
           "first_step_rel_err": first_err, "gflop_per_img": flop / 1e9,
           "conv_fc_layers": n_layers,
           "captures": nets["hybridized"][0]._cached_op.runner.captures,
           "launches": windows[1]["launches"], "profiled_step": profiled}
    log("%s Gluon: logits/loss of the hybridized first step off eager's by "
        "%.2e / %.2e; windows %s; hybridized / eager %.3f; MFU %s (%.3f "
        "GFLOP/img from its %d conv/FC shapes); sgd_fused_update once a "
        "step" % (name, first_err["logits"], first_err["loss"], ", ".join(
            "%s %.1f img/s %.2f ms" % (w["mode"], w["img_per_s"],
                                       w["ms_per_step"]) for w in windows),
            res["hybridized_over_eager"],
            {m: round(v, 4) for m, v in res["mfu"].items()}, flop / 1e9,
            n_layers))
    for mode, prof in profiled.items():
        log_profile("%s profiled %s step" % (name, mode), prof)
    return res


def _count_bn(sym):
    from mxnet_tpu_torch.symbol.symbol import _topo
    return sum(1 for n in _topo(sym._entries) if n.op == "BatchNorm")


def concat_reversed_mix(mx):
    """A planted fault: Inception's ``_Mix`` concatenating its branches
    in reverse order (the channel count is unchanged, their order is
    not)."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import inception

    def hybrid_forward(self, F, x):
        return F.Concat(*[b(x) for b in reversed(list(
            self._children.values()))], dim=1)
    return inception._Mix, hybrid_forward


def zoo_export(torch, mx, name, net, x, ref, workdir):
    """Phase 32's export check of ``name``: ``export`` → ``SymbolBlock
    .imports`` on the card, hybridized, within EXPORT_TOL of ``ref`` (the
    net's own predict of ``x``); and its planted fault must fail it
    (Inception: ``_Mix``'s Concat order reversed in the exported trace;
    otherwise one exported moving variance doubled)."""
    os.makedirs(workdir, exist_ok=True)
    prefix = os.path.join(workdir, name)
    net.export(prefix)
    files = (prefix + "-symbol.json", prefix + "-0000.params")

    def imported(json_file, params_file):
        blk = mx.gluon.SymbolBlock.imports(json_file, ["data"], params_file,
                                           ctx=mx.gpu(0))
        blk.hybridize()
        with mx.autograd.predict_mode():
            return blk(x).asnumpy()

    err = rel_max(imported(*files), ref)
    check(err <= EXPORT_TOL, "%s export: the imported block is off by %.2e"
          % (name, err))
    if name == "inceptionv3":
        cls, bad_forward = concat_reversed_mix(mx)
        real = cls.hybrid_forward
        cls.hybrid_forward = bad_forward
        try:
            net.export(prefix + "-planted")
        finally:
            cls.hybrid_forward = real
        plant = "Concat order reversed in _Mix"
        planted = rel_max(imported(prefix + "-planted-symbol.json",
                                   prefix + "-planted-0000.params"), ref)
    else:
        saved = mx.nd.load(files[1])
        victim = sorted(k for k in saved if k.startswith("aux:")
                        and k.endswith("running_var"))[0]
        saved[victim] = saved[victim] * 2
        mx.nd.save(prefix + "-planted-0000.params", saved, format="mxnet")
        plant = "%s doubled" % victim
        planted = rel_max(imported(files[0], prefix + "-planted-0000.params"),
                          ref)
    check(planted > EXPORT_TOL, "%s export: the planted fault (%s) passes "
          "(%.2e)" % (name, plant, planted))
    shutil.rmtree(workdir, ignore_errors=True)
    return {"rel_err": err, "planted": plant, "planted_rel_err": planted}


def zoo_score(torch, mx, bnk, workdir):
    """Phase 32: every net of ZOO_SCORE scored on the card as
    ``benchmark.py``'s ``infer_score`` does (hybridized, batch 32,
    float32, TF32 off; Inception at 299, the rest at 224, 1000 classes):
    a timed window of ZOO_FORWARDS forwards (img/s, MFU over the net's
    own conv and FC FLOPs); ``batch_norm_inference`` once per BatchNorm
    node of the traced Symbol a forward, replays counted (0 for the nets
    without BatchNorm), its plain version never on the card; the logits
    of a batch of 2 within ZOO_PATH_TOL of the CPU's from the same
    weights (carried as numpy arrays by ``gluon_params_from_jax``); for
    ZOO_EXPORTED, ``zoo_export``; the V100's published img/s beside
    AlexNet, VGG16 and Inception v3 as context."""
    from mxnet_tpu_torch.convert import (gluon_params_from_jax,
                                         gluon_params_to_numpy)
    from mxnet_tpu_torch.ops import nn as nn_ops
    dev, cpu = mx.gpu(0), mx.cpu()
    plain = [0]
    real = bnk._batch_norm_inference_plain

    def spy(x, *args, **kwargs):
        plain[0] += x.device.type == "cuda"
        return real(x, *args, **kwargs)

    res = {}
    bnk._batch_norm_inference_plain = nn_ops._batch_norm_inference_plain = spy
    try:
        for i, name in enumerate(ZOO_SCORE):
            image = zoo_image(name)
            net = zoo_net(mx, name, dev, 320 + i)
            flop = gluon_flops(mx, net, image[1])[0] / 3
            vals = gluon_params_to_numpy(net)
            rng = np.random.RandomState(32)
            x = rng.uniform(-1, 1, (RESNET_BATCH,) + image).astype(
                np.float32)
            x_dev = mx.nd.array(x, ctx=dev)
            x2 = mx.nd.array(x[:2], ctx=dev)
            n_bn = _count_bn(net._trace_symbol())
            net.hybridize()
            with mx.autograd.predict_mode():
                t0 = time.time()
                net(x_dev)
                torch.cuda.synchronize()
                first_s = time.time() - t0
                bnk.reset_launches()
                ref = net(x_dev).asnumpy()
                per_forward = bnk.LAUNCHES["batch_norm_inference"]
                bnk.reset_launches()
                w = forward_window(torch, lambda: net(x_dev),
                                   n=ZOO_FORWARDS)
                window_launches = bnk.LAUNCHES["batch_norm_inference"]
                card2 = net(x2).asnumpy()
                cpu_net = mx.gluon.model_zoo.vision.get_model(
                    name, classes=1000, prefix="zoo_")
                gluon_params_from_jax(vals, cpu_net, ctx=cpu)
                host2 = cpu_net(mx.nd.array(x[:2], ctx=cpu)).asnumpy()
            check(np.isfinite(ref).all() and ref.shape == (RESNET_BATCH,
                                                          1000),
                  "%s scoring: logits %s" % (name, ref.shape))
            check(per_forward == n_bn, "%s scoring: %d batch_norm_inference "
                  "launches a forward for %d BatchNorm nodes"
                  % (name, per_forward, n_bn))
            want = (ZOO_FORWARDS + HOST_SAMPLES) * n_bn
            check(window_launches == want, "%s scoring: %d batch_norm_"
                  "inference launches in the window, want %d"
                  % (name, window_launches, want))
            path_err = rel_max(card2, host2)
            check(path_err <= ZOO_PATH_TOL, "%s scoring: the card's logits "
                  "are off the CPU's by %.2e" % (name, path_err))
            mfu = w["img_per_s"] * flop / F32_FLOPS
            check(mfu <= 1.05, "%s scoring: %.0f img/s implies MFU %.2f"
                  % (name, w["img_per_s"], mfu))
            row = {"image": image, "img_per_s": w["img_per_s"],
                   "ms_per_forward": w["ms_per_forward"],
                   "host_us": w["host_us"], "mfu": mfu,
                   "fwd_gflop_per_img": flop / 1e9, "bn_nodes": n_bn,
                   "bn_launches_per_forward": per_forward,
                   "bn_window_launches": window_launches,
                   "card_vs_cpu_rel_err": path_err, "first_forward_s":
                   first_s, "v100_published": ZOO_SCORE_V100.get(name)}
            if name in ZOO_EXPORTED:
                with mx.autograd.predict_mode():
                    row["export"] = zoo_export(torch, mx, name, net, x_dev,
                                               ref, workdir)
            res[name] = row
            log("%s scoring: batch %d x %s: %.1f img/s, %.2f ms a forward, "
                "%.0f host us, MFU %.3f (%.2f GFLOP/img forward); "
                "batch_norm_inference %d a forward (%d nodes), %d in the "
                "window; card vs CPU logits %.2e; first forward (capture) "
                "%.2fs%s%s" % (
                    name, RESNET_BATCH, "x".join(map(str, image)),
                    w["img_per_s"], w["ms_per_forward"], w["host_us"], mfu,
                    flop / 1e9, per_forward, n_bn, window_launches, path_err,
                    first_s, "; export %s" % row["export"] if "export" in row
                    else "", "; published 1x V100 %.2f img/s (context only)"
                    % ZOO_SCORE_V100[name] if name in ZOO_SCORE_V100
                    else ""))
            del net, cpu_net
    finally:
        bnk._batch_norm_inference_plain = real
        nn_ops._batch_norm_inference_plain = real
    check(plain[0] == 0, "zoo scoring: the plain BatchNorm ran %d times on "
          "the card" % plain[0])
    res["window_launches"] = sum(r["bn_window_launches"]
                                 for r in res.values())
    return res


def zoo_vs_f64(torch, mx, fu):
    """Phase 33: one fused SGD step at batch 2 of each net of ZOO_F64 (its
    traced Symbol under ``SoftmaxOutput``, 1000 classes, at its input
    size) on the card and on the CPU in float32 against the CPU's float64
    witness, by phase 28's rule (phase 14's step-1 limits, weight changes
    within RESNET_RATIO_TOL x the CPU's own float32 error or
    NET_F32_FLOOR), Dropout's p set to 0 through the JSON, and the
    tensors whose change is zero in exact arithmetic held apart
    (``zoo_misses``); a planted BatchNorm fault must miss it (phase 14's;
    phase 23's for Inception, see ZOO_F64)."""
    plants = {"bn": ("BatchNorm", bn_unbiased_backward),
              "gamma": ("BatchNorm", functools.partial(
                  gamma_grad_scaled, factor=GLUON_PLANT))}
    res = {}
    for name, n_bn, plant in ZOO_F64:
        net = mx.gluon.model_zoo.vision.get_model(name, classes=1000,
                                                  prefix="zoo_")
        sym = no_dropout(mx, mx.sym.SoftmaxOutput(net._trace_symbol(),
                                                  name="softmax"))
        check(_count_bn(sym) == n_bn, "%s: %d BatchNorm nodes, want %d"
              % (name, _count_bn(sym), n_bn))
        (row,) = resnet_vs_f64(torch, mx, fu, batch=2, steps=1,
                               sides=("cpu", "dev", "planted"), sym=sym,
                               label=name, image=zoo_image(name),
                               plant=plants[plant],
                               exact_zero=ZOO_EXACT_ZERO)
        misses = zoo_misses(row["dev"], row["cpu"])
        check(not misses, "%s vs f64: the card is off: %s"
              % (name, "; ".join(misses)))
        planted = zoo_misses(row["planted"], row["cpu"])
        check(planted, "%s vs f64: the planted BatchNorm fault (%s) passes"
              % (name, plant))
        log("%s vs f64: card/CPU error ratios: %s; %d tensors zero in "
            "exact arithmetic, their largest change card %.2e, CPU %.2e; "
            "planted (%s) misses %s"
            % (name, ", ".join("%s %.2f" % (k, row["dev"][k] / max(
                row["cpu"][k], 1e-30)) for k in ("dw_median", "dw_max")),
               row["dev"]["zero_keys"], row["dev"]["zero_max"],
               row["cpu"]["zero_max"], plant, planted))
        res[name] = {side: {k: v for k, v in r.items()
                            if k not in ("dw", "ds")}
                     for side, r in row.items() if isinstance(r, dict)}
    return res


def zoo_misses(side, cpu):
    """Phase 33's misses of ``side``: phase 28's rule over the tensors
    whose change is not zero in exact arithmetic, and ZOO_ZERO_TOL over
    those whose change is."""
    misses = resnet_misses(side, cpu, 1, NET_F32_FLOOR)
    if side["zero_max"] > ZOO_ZERO_TOL:
        misses.append("a change that is zero in exact arithmetic reads "
                      "%.3g > %g" % (side["zero_max"], ZOO_ZERO_TOL))
    return misses


def mnist_cli(torch, mx, fu):
    """Phase 34: ``train_mnist.main`` in-process on the card for ``--network
    mlp`` and ``lenet`` with the default flags (the seeded synthetic set
    of 6000 images, batch 64, 6 epochs, SGD lr 0.3 momentum 0.9):
    ``sgd_fused_update`` once a step and its plain version never, finite
    outputs, the printed final validation accuracy above chance (0.1),
    the shuffle seeded (MNIST_SHUFFLE_SEED);
    img/s from the Speedometer lines (the first epoch's left out)."""
    import contextlib
    import io as _io
    from mxnet_tpu_torch.examples import train_mnist
    args = train_mnist.parse_args(MNIST_EXTRA)
    batches = -(-args.num_examples // args.batch_size)
    steps = args.num_epochs * batches
    res = {}
    for net in ("mlp", "lenet"):
        fu.reset_launches()
        printed = _io.StringIO()
        with _PlainSGDSpy(fu) as plain, LogLines() as logs, \
                contextlib.redirect_stdout(printed):
            np.random.seed(MNIST_SHUFFLE_SEED)
            t0 = time.perf_counter()
            mod = train_mnist.main(["--network", net] + MNIST_EXTRA)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = fu.LAUNCHES["sgd_fused_update"]
        check(launches == steps, "train_mnist %s: sgd_fused_update launched "
              "%d times for %d steps" % (net, launches, steps))
        check(plain.calls == 0, "train_mnist %s: the plain SGD rule ran"
              % net)
        m = re.search(r"final validation accuracy: ([0-9.]+)",
                      printed.getvalue())
        acc = float(m.group(1)) if m else float("nan")
        check(acc > 0.1, "train_mnist %s: final validation accuracy %s"
              % (net, acc))
        out = mod.get_outputs()[0].asnumpy()
        check(np.isfinite(out).all(), "train_mnist %s: non-finite outputs"
              % net)
        train_acc = logs.train_value("accuracy")
        speeds = [v for e in range(1, args.num_epochs)
                  for v in logs.speeds(e)]
        check(len(speeds) >= 1, "train_mnist %s: Speedometer lines %s"
              % (net, logs.speeds()))
        img_s = float(np.mean(speeds))
        res[net] = {"img_per_s": img_s, "speedometer": logs.speeds(),
                    "final_val_accuracy": acc, "train_accuracy": train_acc,
                    "launches": launches, "steps": steps, "wall_s": wall}
        log("train_mnist %s: %d steps in %.1fs, %.1f img/s (Speedometer, "
            "epochs 1-%d), final validation accuracy %.4f, train accuracy "
            "by epoch %s; sgd_fused_update %d launches"
            % (net, steps, wall, img_s, args.num_epochs - 1, acc,
               {k: round(v, 4) for k, v in train_acc.items()}, launches))
        del mod
    return res


# ---------------------------------------------------------------------------
# phases 35-37: recurrent language models
# ---------------------------------------------------------------------------

# (a) reference MXNet's example/rnn/bucketing/lstm_bucketing.py at its
# defaults (the PTB "small" LM): 2 x 200 LSTM, 200-wide embedding, batch
# 32, buckets 10..60, SGD lr 0.01 (the port's CLI holds momentum at 0.9),
# PTB's 10 000 words over a seeded corpus cut to LM_SENTENCES sentences
LM_VOCAB = 10000
LM_SENTENCES = 4000     # PTB train has 42 068; cut so an epoch is ~125 steps
LM_LEN_SHAPE = 3.0      # sentence lengths ~ Gamma(3, 7) in 2..60: mean ~21,
LM_LEN_SCALE = 7.0      # PTB's
LM_ZIPF = 1.1           # token ranks ~ Zipf(1.1), every word at least once
LM_FOLLOW = 0.5         # share of tokens that are their predecessor's fixed
                        # successor (structure an LSTM can learn)
# lr 0.001: the CLI's momentum is 0.9, so its step lr / (1 - momentum) is
# the reference's lr 0.01 without momentum
LM_ARGS = ["--num-layers", "2", "--num-hidden", "200", "--num-embed", "200",
           "--batch-size", "32", "--buckets", "10,20,30,40,50,60",
           "--lr", "0.001", "--disp-batches", "50", "--num-epochs", "2"]
LM_EXTRA = []           # appended to the CLI's arguments (a CPU rehearsal)
LM_CHECK_LEN = 60       # phase 35's float64 step: the longest bucket
LM_SPLIT_STEPS = 5      # phase 35: fit steps timed in two parts

# (b) reference MXNet's example/gluon/word_language_model/train.py at its
# defaults (WikiText-2's 33 278 words): Embedding -> LSTM(200, 2 layers,
# dropout 0.2) -> Dense, untied; bptt 35, batch 32, clip 0.2, SGD lr 20
GLM_VOCAB = 33278
GLM_BPTT, GLM_BATCH, GLM_HIDDEN, GLM_LAYERS = 35, 32, 200, 2
GLM_DROPOUT, GLM_LR, GLM_CLIP = 0.2, 20.0, 0.2
GLM_WARM, GLM_TIMED = 5, 50
GLM_WINDOWS = ("eager", "hybridized", "hybridized", "eager")

# phase 37: card vs CPU
RNN_CARD_SHAPE = (35, 32, 200, 200, 2)      # (T, N, I, H, layers)
RNN_CARD_TOL = 1e-4     # card vs CPU f32, relative to the largest magnitude:
                        # 35 recurrent steps summed in other orders (cuDNN)
CTC_CARD_SHAPE = (50, 32, 30, 12)           # (T, N, A, max label length)
CTC_CARD_TOL = 1e-4     # and CTC's gradient (atomics on the card)


def lm_corpus(path, n=LM_SENTENCES, vocab=LM_VOCAB, seed=35):
    """Write a seeded PTB-like corpus to ``path``: ``n`` sentences,
    lengths ~ Gamma(LM_LEN_SHAPE, LM_LEN_SCALE) clipped to 2..60, tokens
    "w<rank>": a sentence's first token and, with probability 1 -
    LM_FOLLOW, each later one drawn by rank ~ Zipf(LM_ZIPF) over
    ``vocab`` words, else the previous token's successor under a fixed
    seeded permutation; the words no draw reached replace random tokens,
    so the file holds all ``vocab``. Returns (sentences as token lists,
    token count)."""
    rng = np.random.RandomState(seed)
    lens = np.clip(np.round(rng.gamma(LM_LEN_SHAPE, LM_LEN_SCALE, n)),
                   2, 60).astype(int)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -LM_ZIPF
    total = int(lens.sum())
    draws = rng.choice(vocab, size=total, p=p / p.sum())
    follow = rng.rand(total) < LM_FOLLOW
    succ = rng.permutation(vocab)
    toks = draws.copy()
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    first = np.zeros(total, bool)
    first[starts] = True
    for i in range(1, total):
        if follow[i] and not first[i]:
            toks[i] = succ[toks[i - 1]]
    missing = np.setdiff1d(np.arange(vocab), toks)
    toks[rng.choice(total, len(missing), replace=False)] = missing
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sents = []
    with open(path, "w") as f:
        for s0, ln in zip(starts, lens):
            words = ["w%d" % t for t in toks[s0:s0 + ln]]
            sents.append(words)
            f.write(" ".join(words) + "\n")
    return sents, total


def lstm_flops(batch, seq_len, embed, hidden, layers, vocab):
    """Training FLOPs of one batch of the unrolled LSTM LM: per step and
    layer the i2h and h2h products (2 N In 4H, 2 N H 4H), the output
    layer over every position (2 N T H V), times 3 (forward, backward to
    the activations and to the weights)."""
    per_step = sum(2 * batch * ((embed if l == 0 else hidden) + hidden)
                   * 4 * hidden for l in range(layers))
    return 3.0 * (seq_len * per_step + 2 * batch * seq_len * hidden * vocab)


class _TokenSpy(object):
    """Counts what ``BucketSentenceIter`` serves in each epoch: batches by
    bucket, tokens (data positions that hold a word) and positions."""

    def __init__(self, it_cls):
        self.cls = it_cls
        self.epochs = [{"buckets": {}, "words": 0, "positions": 0}]

    def __enter__(self):
        self.real_next, self.real_reset = self.cls.next, self.cls.reset
        spy = self

        def counted(it):
            batch = spy.real_next(it)
            d = batch.data[0].asnumpy()
            e = spy.epochs[-1]
            e["buckets"][batch.bucket_key] = \
                e["buckets"].get(batch.bucket_key, 0) + 1
            e["words"] += int((d != -1).sum())
            e["positions"] += d.size
            return batch

        def reset(it):
            if spy.epochs[-1]["buckets"]:
                spy.epochs.append({"buckets": {}, "words": 0,
                                   "positions": 0})
            return spy.real_reset(it)
        self.cls.next = self.cls.__next__ = counted
        self.cls.reset = reset
        return self

    def __exit__(self, *exc):
        self.cls.next = self.cls.__next__ = self.real_next
        self.cls.reset = self.real_reset
        return False


def _lm_class(name):
    low = name.lower()
    if "fused_update_kernel" in low:
        return "fused_update"
    if "memcpy" in low:
        return "memcpy"
    if "rnn" in low or "lstm" in low:
        return "cudnn_rnn"
    if any(k in low for k in ("gemm", "gemv", "xmma", "cutlass", "cublas",
                              "nvjet")):
        return "cublas"
    if "softmax" in low:
        return "softmax"
    if "index" in low or "embedding" in low or "gather" in low \
            or "scatter" in low:
        return "embedding"
    return "elementwise_other"


def slice_reversed(torch, real):
    """Planted fault: SliceChannel's outputs in reverse order (the LSTM
    gates i, f, c, o read as o, c, f, i)."""
    @functools.wraps(real)
    def fn(*args, **kwargs):
        return tuple(reversed(real(*args, **kwargs)))
    return fn


def lstm_cli(torch, mx, fu, workdir):
    """Phase 35: configuration (a), ``lstm_bucketing.main`` in-process on
    the card over a seeded PTB-like corpus file (``lm_corpus``): a warm
    epoch and a timed epoch through ``BucketingModule.fit``; one
    ``sgd_fused_update`` launch a step and the plain rule never; samples/s
    from the Speedometer (epoch 2), tokens/s of the timed epoch padded and
    not, ms/step, MFU over its matmul shapes (``lstm_flops``) against 67
    TFLOP/s f32; the training perplexity finite and falling; one profiled
    fit step of the longest bucket, the metric's update included (busy
    share, host launches), and that step's two parts timed apart
    unprofiled (``forward_backward`` + ``update``, ``update_metric``,
    which copies the softmax output to the host); then one step
    at batch 2 of that bucket on the card and the CPU against the CPU's
    float64 witness by phase 28's rule, with a planted fault (SliceChannel
    reversed) that must fail."""
    from mxnet_tpu_torch.examples import lstm_bucketing
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    path = os.path.join(workdir, "ptb_synthetic.txt")
    t0 = time.perf_counter()
    sents, n_tok = lm_corpus(path)
    corpus_s = time.perf_counter() - t0
    argv = ["--data", path] + LM_ARGS + LM_EXTRA
    args = lstm_bucketing.parse_args(argv)
    buckets = [int(b) for b in args.buckets.split(",")]
    fu.reset_launches()
    with _PlainSGDSpy(fu) as plain, LogLines() as logs, \
            _TokenSpy(mx.rnn.BucketSentenceIter) as tokens:
        t0 = time.perf_counter()
        mod = lstm_bucketing.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = sum(sum(e["buckets"].values()) for e in tokens.epochs)
    launches = fu.LAUNCHES["sgd_fused_update"]
    check(launches == steps and steps > 0, "lstm_bucketing: sgd_fused_update "
          "launched %d times for %d steps" % (launches, steps))
    check(plain.calls == 0, "lstm_bucketing: the plain SGD rule ran")
    ppl = logs.train_value("perplexity")
    costs = {}
    for line in logs.lines:
        m = re.search(r"Epoch\[(\d+)\] Time cost=([0-9.]+)", line)
        if m:
            costs[int(m.group(1))] = float(m.group(2))
    last = args.num_epochs - 1
    timed = tokens.epochs[last]
    n_batch = sum(timed["buckets"].values())
    n_words, n_pos = timed["words"], timed["positions"]
    dt = costs[last]
    vocab = LM_VOCAB + 1
    flop = sum(n * lstm_flops(args.batch_size, L, args.num_embed,
                              args.num_hidden, args.num_layers, vocab)
               for L, n in timed["buckets"].items())
    speeds = logs.speeds(last)
    res = {"corpus_sentences": len(sents), "corpus_tokens": n_tok,
           "corpus_s": corpus_s, "vocab": vocab, "steps": steps,
           "launches": launches, "wall_s": wall, "epoch_s": costs,
           "perplexity": ppl, "batches_by_bucket": timed["buckets"],
           "samples_per_s": float(np.mean(speeds)) if speeds else None,
           "speedometer": logs.speeds(),
           "tokens_per_s": n_words / dt, "padded_tokens_per_s": n_pos / dt,
           "padding_share": 1 - n_words / n_pos,
           "ms_per_step": dt * 1e3 / n_batch,
           "gflop_per_epoch": flop / 1e9, "mfu": flop / dt / F32_FLOPS}
    check(res["mfu"] <= 1.05, "lstm_bucketing: MFU %.2f" % res["mfu"])
    # one profiled step of the longest bucket
    longest = max(buckets)
    lines = [" ".join(s) for s in sents]
    it = mx.rnn.BucketSentenceIter(
        lstm_bucketing.encode(lines, lstm_bucketing.build_vocab(lines)),
        args.batch_size, buckets=buckets, invalid_label=-1)
    batch = next(b for b in it if b.bucket_key == longest)
    ppl_metric = mx.metric.Perplexity(ignore_label=-1)

    def fit_step(parts=None):
        """``fit``'s loop body: the step, then the metric (which reads
        the whole softmax output on the host)."""
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mod.update_metric(ppl_metric, batch.label)
        torch.cuda.synchronize()
        if parts is not None:
            parts.append((t1 - t0, time.perf_counter() - t1))
    fu.reset_launches()
    prof = profile_run(torch, fit_step, _lm_class)
    check(fu.LAUNCHES["sgd_fused_update"] == 1, "lstm_bucketing: profiled "
          "step launched sgd_fused_update %d times"
          % fu.LAUNCHES["sgd_fused_update"])
    parts = []
    for _ in range(LM_SPLIT_STEPS):
        fit_step(parts)
    step_ms, metric_ms = (1e3 * float(np.median(p)) for p in zip(*parts))
    res["fit_step_ms"] = {"forward_backward_update": step_ms,
                          "update_metric": metric_ms,
                          "metric_share": metric_ms / (step_ms + metric_ms)}
    out = mod.get_outputs()[0]
    check(out._data.is_cuda and np.isfinite(out.asnumpy()).all(),
          "lstm_bucketing: outputs on %s" % out.context)
    res["profiled_step"] = prof
    res["profiled_bucket"] = longest
    log("lstm_bucketing (PTB small widths, vocab %d, %d sentences / %d "
        "tokens written in %.2fs): %d steps in %.1fs, sgd_fused_update %d "
        "launches; timed epoch %.2fs: %s samples/s (Speedometer), %.0f "
        "tokens/s (%.0f padded, padding %.1f%%), %.2f ms/step, MFU %.4f "
        "(%.1f GFLOP/epoch from its matmul shapes); perplexity by epoch %s"
        % (vocab, len(sents), n_tok, corpus_s, steps, wall, launches, dt,
           "%.1f" % res["samples_per_s"] if speeds else "none",
           res["tokens_per_s"], res["padded_tokens_per_s"],
           100 * res["padding_share"], res["ms_per_step"], res["mfu"],
           flop / 1e9, {k: round(v, 2) for k, v in ppl.items()}))
    log_profile("lstm_bucketing profiled bucket-%d fit step (with the "
                "metric)" % longest, prof)
    log("lstm_bucketing bucket-%d fit step, median of %d unprofiled: "
        "forward_backward + update %.2f ms, update_metric (Perplexity on "
        "the host) %.2f ms, %.1f%% of the step"
        % (longest, LM_SPLIT_STEPS, step_ms, metric_ms,
           100 * res["fit_step_ms"]["metric_share"]))
    check(len(ppl) == args.num_epochs and all(np.isfinite(list(
        ppl.values()))) and ppl[args.num_epochs - 1] < ppl[0],
        "lstm_bucketing: training perplexity by epoch %s" % ppl)
    del mod
    # one step at batch 2 against the float64 witness: the CLI's network
    # for the longest bucket
    sym, _, _ = lstm_bucketing.sym_gen_for(
        lstm_bucketing.lstm_stack(args.num_layers, args.num_hidden), vocab,
        args.num_embed, args.num_hidden, 2)(LM_CHECK_LEN)
    rng = np.random.RandomState(35)
    x = rng.randint(1, vocab, (2, LM_CHECK_LEN)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.full((2, 1), -1, np.float32)], 1)
    x[1, 40:] = -1
    y[1, 39:] = -1
    (row,) = module_vs_f64(torch, mx, fu, sym, x, y, (2 * LM_CHECK_LEN, vocab),
                           steps=1, sides=("cpu", "dev", "planted"),
                           plant=("SliceChannel", slice_reversed),
                           label="lstm_bucketing")
    misses = resnet_misses(row["dev"], row["cpu"], 1, NET_F32_FLOOR)
    check(not misses, "lstm_bucketing vs f64: the card is off: %s"
          % "; ".join(misses))
    planted = resnet_misses(row["planted"], row["cpu"], 1, NET_F32_FLOOR)
    check(planted, "lstm_bucketing vs f64: the planted SliceChannel fault "
          "passes")
    log("lstm_bucketing vs f64: card/CPU error ratios %s; planted "
        "SliceChannel fault misses %s" % (", ".join(
            "%s %.2f" % (k, row["dev"][k] / max(row["cpu"][k], 1e-30))
            for k in ("dw_median", "dw_max")), planted))
    res["vs_f64"] = {side: {k: v for k, v in r.items()
                            if k not in ("dw", "ds")}
                     for side, r in row.items() if isinstance(r, dict)}
    return res


def _glm_net(mx, ctx, seed):
    """Reference MXNet's word-LM ``RNNModel`` (mode lstm, untied): Dropout
    -> Embedding -> ``gluon.rnn.LSTM`` -> Dropout -> Dense, seeded Xavier
    weights (the encoder Uniform(0.1)), the two states in and out."""
    nn, rnn = mx.gluon.nn, mx.gluon.rnn

    class RNNModel(mx.gluon.HybridBlock):
        def __init__(self):
            super(RNNModel, self).__init__()
            with self.name_scope():
                self.drop = nn.Dropout(GLM_DROPOUT)
                self.encoder = nn.Embedding(
                    GLM_VOCAB, GLM_HIDDEN,
                    weight_initializer=mx.init.Uniform(0.1))
                self.rnn = rnn.LSTM(GLM_HIDDEN, GLM_LAYERS,
                                    dropout=GLM_DROPOUT,
                                    input_size=GLM_HIDDEN)
                self.decoder = nn.Dense(GLM_VOCAB, in_units=GLM_HIDDEN)

        def hybrid_forward(self, F, inputs, h, c):
            emb = self.drop(self.encoder(inputs))
            output, (h, c) = self.rnn(emb, [h, c])
            output = self.drop(output)
            return [self.decoder(output.reshape((-1, GLM_HIDDEN))), h, c]

    mx.random.seed(seed)
    net = RNNModel()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def glm_flops():
    """Training FLOPs of one (bptt x batch) step of the Gluon LM: the
    LSTM's products and the decoder, times 3."""
    tok = GLM_BPTT * GLM_BATCH
    lstm = sum(2 * tok * 2 * GLM_HIDDEN * 4 * GLM_HIDDEN
               for _ in range(GLM_LAYERS))
    return 3.0 * (lstm + 2 * tok * GLM_HIDDEN * GLM_VOCAB)


def lstm_gluon(torch, mx, fu):
    """Phase 36: configuration (b), the Gluon word LM through ``Trainer``
    on the card, two nets from one seeded state, eager and hybridized (the
    ``RNN`` op a node of the traced Symbol, replayed in the block's CUDA
    graphs). Each step: forward under ``autograd.record()``, summed
    ``SoftmaxCrossEntropyLoss``, backward, ``clip_global_norm`` at
    clip x bptt x batch, ``trainer.step(batch)``; the hidden state carried
    and detached. The first step of each runs with Dropout off (predict
    mode), and the hybridized one's logits and loss are held within
    GLUON_FIRST_TOL of eager's; GLM_WARM warm steps each, then windows of
    GLM_TIMED steps (eager, hybridized, hybridized, eager): tokens/s,
    ms/step, MFU (``glm_flops``), ``sgd_fused_update`` once a step and the
    plain rule never, finite loss; one profiled step of each mode (host
    launches, graph launches, busy share, cuDNN RNN device ms)."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    ctx = mx.gpu(0)
    rng = np.random.RandomState(36)
    ranks = np.arange(1, GLM_VOCAB + 1, dtype=np.float64)
    p = ranks ** -LM_ZIPF
    n_win = 1 + GLM_WARM + GLM_TIMED
    stream = rng.choice(GLM_VOCAB, size=(n_win * GLM_BPTT + 1, GLM_BATCH),
                        p=p / p.sum()).astype(np.float32)
    windows_data = [(mx.nd.array(stream[i * GLM_BPTT:(i + 1) * GLM_BPTT],
                                 ctx=ctx),
                     mx.nd.array(stream[i * GLM_BPTT + 1:(i + 1) * GLM_BPTT
                                        + 1].reshape(-1), ctx=ctx))
                    for i in range(n_win)]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    nets = {}
    for mode in ("eager", "hybridized"):
        net = _glm_net(mx, ctx, 36)
        if mode == "hybridized":
            gluon_params_copy(nets["eager"][0], net)
            net.hybridize()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": GLM_LR, "momentum": 0,
                                    "wd": 0})
        nets[mode] = [net, trainer, None]
    params = {m: [p for p in nets[m][0].collect_params().values()
                  if p.grad_req != "null"] for m in nets}

    def run(mode, steps, start=0, train=True):
        net, trainer, hidden = nets[mode]
        for i in range(steps):
            data, target = windows_data[(start + i) % n_win]
            if hidden is None:
                hidden = net.rnn.begin_state(GLM_BATCH, ctx=ctx)
            hidden = [h.detach() for h in hidden]
            with mx.autograd.record(train_mode=train):
                out, h, c = net(data, *hidden)
                loss = loss_fn(out, target)
            loss.backward()
            mx.gluon.utils.clip_global_norm(
                [q.grad() for q in params[mode]],
                GLM_CLIP * GLM_BPTT * GLM_BATCH)
            trainer.step(GLM_BATCH)
            hidden = [h, c]
        nets[mode][2] = hidden
        return out, loss

    flop = glm_flops()
    first, windows = {}, []
    with _PlainSGDSpy(fu) as plain:
        for mode in ("eager", "hybridized"):
            fu.reset_launches()
            out, loss = run(mode, 1, train=False)
            first[mode] = (out.asnumpy(), loss.asnumpy())
            run(mode, GLM_WARM, start=1)
            torch.cuda.synchronize()
            check(fu.LAUNCHES["sgd_fused_update"] == GLM_WARM + 1,
                  "Gluon LM %s: %d update launches in %d steps" % (
                      mode, fu.LAUNCHES["sgd_fused_update"], GLM_WARM + 1))
        for mode in GLM_WINDOWS:
            fu.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, loss = run(mode, GLM_TIMED, start=1 + GLM_WARM)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            tok_s = GLM_BPTT * GLM_BATCH * GLM_TIMED / dt
            windows.append({"mode": mode, "tokens_per_s": tok_s,
                            "ms_per_step": dt * 1e3 / GLM_TIMED,
                            "mfu": flop * GLM_TIMED / dt / F32_FLOPS,
                            "launches": fu.LAUNCHES["sgd_fused_update"],
                            "loss_mean": float(loss.asnumpy().mean())})
    for w in windows:
        check(w["launches"] == GLM_TIMED, "Gluon LM %s: sgd_fused_update "
              "launched %d times in %d steps" % (w["mode"], w["launches"],
                                                 GLM_TIMED))
        check(w["mfu"] <= 1.05 and np.isfinite(w["loss_mean"]),
              "Gluon LM %s: %.0f tokens/s (MFU %.2f), loss %s" % (
                  w["mode"], w["tokens_per_s"], w["mfu"], w["loss_mean"]))
    check(plain.calls == 0, "Gluon LM: the plain SGD rule ran %d times"
          % plain.calls)
    first_err = {"logits": rel_max(first["hybridized"][0], first["eager"][0]),
                 "loss": rel_max(first["hybridized"][1], first["eager"][1])}
    check(max(first_err.values()) <= GLUON_FIRST_TOL, "Gluon LM: the "
          "hybridized first step is off the eager one: %s" % first_err)
    cached = nets["hybridized"][0]._cached_op
    check(cached is not None and cached.runner.captures >= 1,
          "Gluon LM: the hybridized net captured no CUDA graph")
    profiled = {}
    for mode in ("eager", "hybridized"):
        fu.reset_launches()
        profiled[mode] = profile_run(torch, lambda: run(mode, 1),
                                     _lm_class)
        check(fu.LAUNCHES["sgd_fused_update"] == 1, "Gluon LM %s: profiled "
              "step launched sgd_fused_update %d times"
              % (mode, fu.LAUNCHES["sgd_fused_update"]))
        check(profiled[mode]["device_ms"].get("cudnn_rnn", 0) > 0,
              "Gluon LM %s: no cuDNN RNN kernel in the step: %s"
              % (mode, profiled[mode]["device_ms"]))
    hyb = profiled["hybridized"]
    check(hyb["graph_launches"] is None or hyb["graph_launches"] >= 1,
          "Gluon LM hybridized: no graph launch in the profiled step")
    tok_s = {m: float(np.mean([w["tokens_per_s"] for w in windows
                               if w["mode"] == m])) for m in nets}
    res = {"windows": windows, "tokens_per_s": tok_s,
           "mfu": {m: v / (GLM_BPTT * GLM_BATCH) * flop / F32_FLOPS
                   for m, v in tok_s.items()},
           "hybridized_over_eager": tok_s["hybridized"] / tok_s["eager"],
           "first_step_rel_err": first_err, "gflop_per_step": flop / 1e9,
           "captures": cached.runner.captures,
           "launches": windows[1]["launches"], "profiled_step": profiled}
    log("Gluon LM (WikiText-2 widths): hybridized first step off eager's "
        "by %.2e / %.2e (logits / loss, Dropout off); windows %s; "
        "hybridized / eager %.3f; MFU %s (%.2f GFLOP a step); %d captures; "
        "sgd_fused_update once a step" % (
            first_err["logits"], first_err["loss"], ", ".join(
                "%s %.0f tokens/s %.2f ms" % (w["mode"], w["tokens_per_s"],
                                              w["ms_per_step"])
                for w in windows), res["hybridized_over_eager"],
            {m: round(v, 4) for m, v in res["mfu"].items()}, flop / 1e9,
            res["captures"]))
    for mode, prof in profiled.items():
        log_profile("Gluon LM profiled %s step" % mode, prof)
    return res


def _rnn_case(torch, mode, bidirectional, proj, dev):
    """Phase 37's RNN op inputs, seeded, on ``dev``: (data, flat weights,
    h0[, c0]) and the op's attrs."""
    from mxnet_tpu_torch.ops import nn as tnn
    T, N, I, H, L = RNN_CARD_SHAPE
    dirs = 2 if bidirectional else 1
    hout = proj or H
    gen = torch.Generator().manual_seed(37)
    n = tnn.rnn_param_size(L, I, H, bidirectional, mode, proj)
    shapes = [(T, N, I), (n,), (L * dirs, N, hout)] + (
        [(L * dirs, N, H)] if mode == "lstm" else [])
    ins = [(torch.rand(s, generator=gen) - 0.5).to(dev) for s in shapes]
    ins[1] *= 0.2
    attrs = dict(state_size=H, num_layers=L, bidirectional=bidirectional,
                 mode=mode, state_outputs=True)
    if proj:
        attrs["projection_size"] = proj
    return ins, attrs


def _rnn_run(torch, ins, attrs):
    from mxnet_tpu_torch.ops import nn as tnn
    xs = [t.clone().requires_grad_() for t in ins]
    outs = tnn._rnn(None, *xs, **attrs)
    loss = sum((o * torch.linspace(-1, 1, o.numel(), device=o.device)
                .reshape(o.shape) * (i + 1)).sum()
               for i, o in enumerate(outs))
    grads = torch.autograd.grad(loss, xs)
    return [o.detach().cpu().numpy() for o in outs] + \
        [g.cpu().numpy() for g in grads]


def gate_swapped(torch, real):
    """Planted fault: the LSTM's i and f gate rows swapped in unpacking."""
    @functools.wraps(real)
    def fn(params, num_layers, input_size, state_size, *args, **kw):
        layers = real(params, num_layers, input_size, state_size, *args,
                      **kw)
        H = state_size

        def sw(t):
            return torch.cat([t[H:2 * H], t[:H], t[2 * H:]], 0)
        return [[(sw(W), sw(R), sw(bW), sw(bR), P)
                 for W, R, bW, bR, P in per_dir] for per_dir in layers]
    return fn


def rnn_compaction_cost(torch, dev):
    """The ``RNN`` op's forward and backward at the Gluon LM's shape
    (bptt 35, batch 32, 2 x 200 LSTM) on weights that are views of the
    JAX package's flat layout, which cuDNN copies into its own buffer at
    every call, against ``torch.nn.LSTM`` on the same values in its
    flattened buffer (CUDA events, L2 flushed, turns op, module, module,
    op): the difference is what the copy costs. On the card only."""
    from mxnet_tpu_torch.ops import nn as tnn
    if dev.type != "cuda":
        return None
    T, N, H, L = GLM_BPTT, GLM_BATCH, GLM_HIDDEN, GLM_LAYERS
    gen = torch.Generator().manual_seed(371)
    n = tnn.rnn_param_size(L, H, H, False, "lstm")
    w = ((torch.rand(n, generator=gen) - 0.5) * 0.2).to(dev)
    x = (torch.rand(T, N, H, generator=gen) - 0.5).to(dev)
    h0 = torch.zeros(L, N, H, device=dev)
    lstm = torch.nn.LSTM(H, H, L).to(dev)
    with torch.no_grad():
        flat = [t for d in tnn._unpack_rnn_params(w, L, H, H, False, "lstm")
                for t in d[0][:4]]
        for p, v in zip(lstm._flat_weights, flat):
            p.copy_(v)
    lstm.flatten_parameters()
    wl = w.clone().requires_grad_()
    xl = x.clone().requires_grad_()

    def op():
        out = tnn._rnn(None, xl, wl, h0, h0, state_size=H, num_layers=L,
                       mode="lstm")
        out.sum().backward()

    def module():
        out, _ = lstm(xl, (h0, h0))
        out.sum().backward()

    timer = Timer(torch)
    times = {"op": [], "module": []}
    for name in ("op", "module", "module", "op"):
        times[name].append(timer(op if name == "op" else module, iters=20))
    del timer
    res = {k: float(np.mean(v)) for k, v in times.items()}
    res["copy_ms"] = res["op"] - res["module"]
    log("RNN op at the Gluon LM's shape, forward + backward: %.4f ms on the "
        "JAX layout's views (cuDNN compacts them a call) vs %.4f ms for "
        "torch.nn.LSTM's flattened buffer: the copy costs ~%.4f ms a call"
        % (res["op"], res["module"], res["copy_ms"]))
    return res


def rnn_ctc_card(torch, mx, dev=None):
    """Phase 37: the ``RNN`` op on the card (cuDNN) against the same op on
    the CPU (ATen) at RNN_CARD_SHAPE, in its four modes uni- and
    bidirectional and LSTMP: outputs, final states and the gradients to
    data, weights and states within RNN_CARD_TOL of the CPU's largest
    magnitude; a planted i/f gate swap on the card must miss; then
    ``CTCLoss`` (both blank labels, with and without lengths) on the card
    against the CPU, loss and gradient within CTC_CARD_TOL."""
    from mxnet_tpu_torch.ops import contrib_ops
    from mxnet_tpu_torch.ops import nn as tnn
    dev = dev or torch.device("cuda")
    res = {"rnn": {}, "ctc": {}}
    cases = [(m, b, None) for m in ("lstm", "gru", "rnn_tanh", "rnn_relu")
             for b in (False, True)] + [("lstm", False, 100),
                                        ("lstm", True, 100)]
    for mode, bi, proj in cases:
        ins, attrs = _rnn_case(torch, mode, bi, proj, dev)
        card = _rnn_run(torch, ins, attrs)
        cpu = _rnn_run(torch, [t.cpu() for t in ins], attrs)
        errs = [rel_max(c, r) for c, r in zip(card, cpu)]
        label = "%s%s%s" % (mode, "-bi" if bi else "",
                            "-proj%d" % proj if proj else "")
        check(max(errs) <= RNN_CARD_TOL, "RNN %s card vs CPU: %s"
              % (label, ["%.2e" % e for e in errs]))
        res["rnn"][label] = max(errs)
    ins, attrs = _rnn_case(torch, "lstm", True, None, dev)
    cpu = _rnn_run(torch, [t.cpu() for t in ins], attrs)
    real = tnn._unpack_rnn_params
    tnn._unpack_rnn_params = gate_swapped(torch, real)
    try:
        planted = _rnn_run(torch, ins, attrs)
    finally:
        tnn._unpack_rnn_params = real
    planted_err = max(rel_max(c, r) for c, r in zip(planted, cpu))
    check(planted_err > 100 * RNN_CARD_TOL, "RNN: the planted gate swap "
          "passes (%.2e)" % planted_err)
    res["rnn_planted_err"] = planted_err
    T, N, A, L = CTC_CARD_SHAPE
    rng = np.random.RandomState(37)
    for blank in ("first", "last"):
        for lengths in (False, True):
            data = torch.from_numpy(rng.randn(T, N, A).astype(np.float32))
            lens = rng.randint(1, L + 1, N)
            label = np.full((N, L), -1, np.float32)
            lo, hi = (1, A) if blank == "first" else (0, A - 1)
            for i, n in enumerate(lens):
                label[i, :n] = rng.randint(lo, hi, n)
            # data lengths that leave room for any labelling (2L + 1)
            extra = [torch.from_numpy(rng.randint(
                max(T - 10, 2 * L + 1), T + 1, N).astype(np.float32)),
                     torch.from_numpy(lens.astype(np.float32))] \
                if lengths else []
            attrs = {"blank_label": blank, "use_data_lengths": lengths,
                     "use_label_lengths": lengths}
            out = {}
            for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
                x = data.to(d).requires_grad_()
                loss = contrib_ops._ctc_loss(
                    x, torch.from_numpy(label).to(d),
                    *[e.to(d) for e in extra], **attrs)
                (g,) = torch.autograd.grad(loss.sum(), x)
                out[side] = (loss.detach().cpu().numpy(), g.cpu().numpy())
            errs = [rel_max(out["card"][i], out["cpu"][i]) for i in (0, 1)]
            key = "%s-%s" % (blank, "lengths" if lengths else "nolengths")
            check(np.isfinite(out["card"][0]).all()
                  and max(errs) <= CTC_CARD_TOL, "CTCLoss %s card vs CPU: "
                  "%s" % (key, errs))
            res["ctc"][key] = errs
    res["compaction"] = rnn_compaction_cost(torch, dev)
    log("RNN op card vs CPU at %s: worst relative error %s; planted i/f "
        "swap off by %.2e; CTCLoss at %s: %s" % (
            RNN_CARD_SHAPE, {k: "%.2e" % v for k, v in res["rnn"].items()},
            planted_err, CTC_CARD_SHAPE,
            {k: "%.2e / %.2e" % tuple(v) for k, v in res["ctc"].items()}))
    return res


# ---------------------------------------------------------------------------
# phases 38-43: the rest of the transformer LM family
# ---------------------------------------------------------------------------

# phase 38: (b, heads, s_q, s_k, head_dim, dtype) held on each route. The
# wgmma route: head_dim 128 at s_q = s_k and not, the ragged (100, 37)
# case, queries against twice as many keys, fewer keys than queries; the
# fma route: float32 at head dims 64 and 128 (s_k != s_q), and bf16 at
# the head dims the wgmma route does not take, up to 256
ROUTE_CHECKS = {
    "wgmma": [(2, 8, 256, 256, 128, "bfloat16"),
              (1, 2, 130, 70, 128, "bfloat16"),
              (2, 3, 100, 37, 32, "bfloat16"),
              (2, 8, 512, 1024, 64, "bfloat16"),
              (1, 2, 16, 8, 64, "bfloat16")],
    "fma": [(1, 2, 8, 16, 64, "float32"), (2, 8, 256, 256, 128, "float32"),
            (1, 2, 33, 33, 8, "bfloat16"), (1, 4, 130, 70, 80, "bfloat16"),
            (1, 2, 64, 64, 256, "bfloat16")]}
# the planted faults (route, shape, fault), causal, each must fail phase
# 6's limits: a key tile hidden from the last query rows, and at head_dim
# 128 on wgmma the second 64-column box of k read as zeros
PLANTED = [("wgmma", (2, 8, 512, 1024, 64, "bfloat16"), "hidden key tile"),
           ("wgmma", (2, 8, 256, 256, 128, "bfloat16"), "hidden key tile"),
           ("wgmma", (2, 8, 256, 256, 128, "bfloat16"),
            "k columns 64-127 zero"),
           ("fma", (2, 8, 256, 256, 128, "float32"), "hidden key tile"),
           ("fma", (1, 4, 130, 70, 80, "bfloat16"), "hidden key tile")]
# phase 38's timed shapes, causal, L2 flushed: (label, b, heads, s_q, s_k,
# head_dim, dtype). A d_model 1024 model with 8 heads of 128; queries
# against twice as many keys; the train_transformer_lm CLI's own float32
# attention at full width (its flash launches take the fma route); the
# train path's shape (bf16 head_dim 64, phase 7's) beside them
ROUTE_TIMED = [("bf16 head_dim 128", 8, 8, 1024, 1024, 128, "bfloat16"),
               ("bf16 s_q 512 < s_k 1024", 8, 16, 512, 1024, 64,
                "bfloat16"),
               ("f32 CLI shape", 8, 16, 1024, 1024, 64, "float32"),
               ("bf16 head_dim 64", 8, 16, 1024, 1024, 64, "bfloat16")]
# phase 39: the _contrib_flash_attention op's shapes on the card, causal
CONTRIB_SHAPES = [(2, 8, 256, 256, 128), (2, 8, 256, 512, 64)]
# phase 40: the CLI at benchmark.py:669's widths (float32, its own dtype)
LM_CLI_ARGS = ["--d-model", "1024", "--n-heads", "16", "--n-layers", "12",
               "--d-ff", "4096", "--vocab", "32768", "--seq-len", "1024",
               "--batch-size", "8", "--steps", "10", "--generate", "32"]
LM_CLI_EXTRA = []       # appended to the CLI's arguments (a CPU rehearsal)
# phase 41: the bf16 train step's three configurations, 4 steps a call
STEP_K = 4
STEP_CONFIGS = (("moe", dict(num_experts=8)), ("remat", dict(remat=True)),
                ("dense", dict()))
# phase 42: benchmark.py:736 decode_transformer_lm
GEN_BATCH, GEN_PROMPT, GEN_STEPS = 8, 32, 128
GEN_CHECK_LAYERS = 2    # the f32 stream checks
GEN_REQUESTS = 16       # phase 43: phase 4's mix
CARD = "cuda"           # the device of phases 38-49 ("cpu": a rehearsal)


def attn_cost(b, h, s_q, s_k, d, item, causal, backward):
    """(bytes, flops) of one flash call: q, k, v (and o, do, lse for the
    backward) read once, o and lse (dq, dk, dv) written once; 4 (10 for
    the backward's five products) * head_dim flops per visible (query,
    key) pair, ``kpos <= qpos`` when causal."""
    if causal:
        m = min(s_q, s_k)
        pairs = b * h * (m * (m + 1) // 2 + (s_q - m) * s_k)
    else:
        pairs = b * h * s_q * s_k
    q_el, k_el = b * h * s_q * d, b * h * s_k * d
    if backward:
        return ((4 * q_el + 4 * k_el) * item + 4 * b * h * s_q,
                10.0 * d * pairs)
    return (2 * q_el + 2 * k_el) * item + 4 * b * h * s_q, 4.0 * d * pairs


def attn_bound(torch, nbytes, flops, dtype):
    """(bound ms, what bounds it) at the peak for the dtype's operations:
    bf16 tensor cores, or float32 outside them."""
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_b, t_o = nbytes / HBM_BPS, flops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def planted_attention(torch, fa, q, k, v, causal, scale, fault):
    """(o, lse) of the plain function under a planted fault: "hidden key
    tile" hides keys 0..15 from the last 16 query rows (what a kernel
    that skipped that one tile pair would compute); "k columns 64-127
    zero" reads k's second 64-column box as zeros (what a head_dim-128
    kernel that lost its second TMA box would compute)."""
    s_q, s_k = q.shape[2], k.shape[2]
    keep = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device)
    if causal:
        keep = (torch.arange(s_k, device=q.device)[None, :]
                <= torch.arange(s_q, device=q.device)[:, None])
    kf = k.float()
    if fault == "k columns 64-127 zero":
        kf = kf.clone()
        kf[..., 64:] = 0.0
    else:
        keep[s_q - 16:, :16] = False
    sc = torch.where(keep, q.float() @ kf.transpose(-1, -2) * scale,
                     fa.NEG_INF)
    lse = torch.logsumexp(sc, -1)
    return torch.exp(sc - lse[..., None]) @ v.float(), lse


def check_flash_routes(torch, fa, timer):
    """Phase 38: both routes of both flash kernels over the TPU kernel's
    domain (ROUTE_CHECKS: s_k != s_q, head dims up to 256) against the
    plain versions by phase 6's limits, each launch on the route
    flash_route names and a second run bitwise equal; the planted faults
    (PLANTED) must fail on each route; then each timed shape
    (ROUTE_TIMED) beside its bound, its plain version and causal
    scaled_dot_product_attention at the same shape (top-left causal
    alignment, kpos <= qpos, as the kernel's rule; float32 with TF32
    off)."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(38)
    names = ("flash_attention", "flash_attention_bwd")
    rows, planted = [], []
    for want, shapes in ROUTE_CHECKS.items():
        for b, h, s_q, s_k, d, dt in shapes:
            dtype = getattr(torch, dt)
            lim = flash_limits(dtype, torch)
            route = fa.flash_route(dtype, d, s_q, s_k)
            check(route == want, "flash_route %s: %s, expected %s"
                  % ((dt, d, s_q, s_k), route, want))
            for causal in (True, False):
                q, do = (torch.randn(b, h, s_q, d, generator=gen).to(
                    CARD, dtype) for _ in range(2))
                k, v = (torch.randn(b, h, s_k, d, generator=gen).to(
                    CARD, dtype) for _ in range(2))
                scale = 1.0 / d ** 0.5
                r0 = {n: dict(fa.ROUTES[n]) for n in names}
                o, lse = fa._flash_fwd(q, k, v, causal)
                dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                    causal)
                torch.cuda.synchronize()
                for n in names:
                    check(all(fa.ROUTES[n][r] == r0[n][r] + (r == route)
                              for r in r0[n]),
                          "%s: not one launch on the %s route: %s"
                          % (n, route, fa.ROUTES[n]))
                ref = plain_flash(torch, fa, q, k, v, do, causal, scale)
                errs = {n: rel_err(g, r) for n, g, r in
                        zip(FLASH_OUTS, (o, lse, dq, dk, dv), ref)}
                rows.append({"route": route, "dtype": dt,
                             "shape": [b, h, s_q, s_k, d],
                             "causal": causal, "rel_err": errs})
                log("check flash %-5s route %-8s (b, h, s_q, s_k, d) %-24s "
                    "causal=%d %s" % (route, dt, (b, h, s_q, s_k, d), causal,
                                      " ".join("%s=%.2e" % kv
                                               for kv in errs.items())))
                bad = {n: e for n, e in errs.items() if e > lim[n]}
                check(not bad, "flash %s route %s %s causal=%s: %s over %s"
                      % (route, dt, (b, h, s_q, s_k, d), causal, bad, lim))
                rows[-1]["bitwise_repeat"] = flash_repeat(
                    torch, fa, q, k, v, do, causal, (o, lse, dq, dk, dv))
                for p_route, p_shape, fault in PLANTED:
                    if not causal or p_route != route or p_shape != (
                            b, h, s_q, s_k, d, dt):
                        continue
                    po, plse = planted_attention(torch, fa, q, k, v, causal,
                                                 scale, fault)
                    perr = {"o": rel_err(po, ref[0]),
                            "lse": rel_err(plse, ref[1])}
                    planted.append({"route": route, "fault": fault,
                                    "shape": list(p_shape), "rel_err": perr})
                    log("planted fault (%s route %s, %s): o=%.2e lse=%.2e"
                        % (route, fault, p_shape, perr["o"], perr["lse"]))
                    check(perr["o"] > lim["o"] and perr["lse"] > lim["lse"],
                          "planted fault (%s route, %s) passes the checks: "
                          "%s" % (route, fault, perr))
    check(len(planted) == len(PLANTED), "%d of %d planted faults ran"
          % (len(planted), len(PLANTED)))
    timed = []
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for label, b, h, s_q, s_k, d, dt in ROUTE_TIMED:
            timed += time_flash_shape(torch, fa, timer, gen, label, b, h,
                                      s_q, s_k, d, dt, rows)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return {"rows": rows, "planted": planted, "timed": timed}


def time_flash_shape(torch, fa, timer, gen, label, b, h, s_q, s_k, d, dt,
                     rows):
    """Phase 38's timing of one shape (causal): both kernels held to
    phase 6's limits first (appended to ``rows``), then each beside its
    bound, its plain version and SDPA (forward; backward through
    torch.autograd.grad)."""
    import torch.nn.functional as F
    dtype = getattr(torch, dt)
    q, do = (torch.randn(b, h, s_q, d, generator=gen).to(CARD, dtype)
             for _ in range(2))
    k, v = (torch.randn(b, h, s_k, d, generator=gen).to(CARD, dtype)
            for _ in range(2))
    scale = 1.0 / d ** 0.5
    route = fa.flash_route(dtype, d, s_q, s_k)
    o, lse = fa._flash_fwd(q, k, v, True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    ref = plain_flash(torch, fa, q, k, v, do, True, scale)
    # the timed shapes are held to the same limits: the CLI's f32 shape
    # is the one phase 40 launches, at its full grid
    lim = flash_limits(dtype, torch)
    errs = {n: rel_err(g, r_) for n, g, r_ in
            zip(FLASH_OUTS, (o, lse, dq, dk, dv), ref)}
    rows.append({"route": route, "dtype": dt, "shape": [b, h, s_q, s_k, d],
                 "causal": True, "rel_err": errs, "label": label})
    log("check flash %s route %-24s %s" % (
        route, label, " ".join("%s=%.2e" % kv for kv in errs.items())))
    bad = {n: e for n, e in errs.items() if e > lim[n]}
    check(not bad, "flash %s route %s %s causal: %s over %s"
          % (route, label, (b, h, s_q, s_k, d), bad, lim))
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    item = q.element_size()
    timed = []
    for name, fn, plain, lib, backward, err in (
            ("flash_attention", lambda: fa._flash_fwd(q, k, v, True),
             lambda: fa._flash_fwd_torch(q, k, v, True, scale),
             lambda: F.scaled_dot_product_attention(q, k, v,
                                                    is_causal=True),
             False, max_err(o, ref[0])),
            ("flash_attention_bwd",
             lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True),
             lambda: fa._flash_bwd_torch(q, k, v, o, lse, do, True, scale),
             lambda: torch.autograd.grad(lo, (lq, lk, lv), do,
                                         retain_graph=True),
             True, max(max_err(a, r) for a, r in
                       zip((dq, dk, dv), ref[2:])))):
        nbytes, flops = attn_cost(b, h, s_q, s_k, d, item, True, backward)
        bound, by = attn_bound(torch, nbytes, flops, dtype)
        r = {"name": name, "label": label, "route": route,
             "shape": "b=%d h=%d s_q=%d s_k=%d d=%d causal %s"
             % (b, h, s_q, s_k, d, dt),
             # the hold keeps the wrapper's host time (and autograd's,
             # for SDPA's backward) out of the device time
             "ms": timer(fn, iters=10, hold_ms=0.5),
             "plain_ms": timer(plain, iters=5),
             "library_ms": timer(lib, iters=10, hold_ms=0.5),
             "bound_ms": bound,
             "bound_by": by, "max_abs_err": err, "flops": flops}
        r["of_bound"] = bound / r["ms"]
        r["vs_library"] = r["ms"] / r["library_ms"]
        timed.append(r)
        log("time %-20s %s (%s route) ms=%.4f plain_ms=%.4f "
            "library_ms=%.4f (kernel/SDPA %.2fx) bound_ms=%.4f (%s; "
            "%.1f%% of it) %.2f TFLOP/s max_abs_err=%.3g"
            % (name, r["shape"], route, r["ms"], r["plain_ms"],
               r["library_ms"], r["vs_library"], bound, by,
               100 * r["of_bound"], flops / (r["ms"] * 1e-3) / 1e12, err))
    return timed


def _as_nd(mx, t):
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    return NDArray(t)


def contrib_card(torch, mx, fa):
    """Phase 39: ``_contrib_flash_attention`` on the card, bf16, causal,
    at CONTRIB_SHAPES (head_dim 128; s_k twice s_q), through
    ``nd.contrib``, a bound ``sym.contrib`` Symbol and a hybridized
    block (its CUDA graphs): output and q, k, v gradients against the
    plain versions at phase 6's limits, every launch on the route
    flash_route names (wgmma at both shapes); the launches are counted
    (the kernels line's entries for phase 38's bf16 shapes)."""
    gen = torch.Generator().manual_seed(39)
    lim = flash_limits(torch.bfloat16, torch)
    launches = {"flash_attention": 0, "flash_attention_bwd": 0}
    rows = []

    class Attn(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, q, k, v):
            return F.contrib.flash_attention(q, k, v, causal=True)

    for b, h, s_q, s_k, d in CONTRIB_SHAPES:
        q, do = (torch.randn(b, h, s_q, d, generator=gen).to(
            CARD, torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, h, s_k, d, generator=gen).to(
            CARD, torch.bfloat16) for _ in range(2))
        ref = plain_flash(torch, fa, q, k, v, do, True, 1.0 / d ** 0.5)
        want = [ref[0]] + list(ref[2:])
        want_route = fa.flash_route(torch.bfloat16, d, s_q, s_k)
        net = Attn()
        net.hybridize()
        for i, route in enumerate(("nd", "sym", "hybridized",
                                   "hybridized")):
            # the first hybridized call warms up (a real launch of each
            # kernel), captures (none) and replays (one)
            want_n = 2 if i == 2 else 1
            fa.reset_launches()
            if route == "sym":
                s = mx.sym.contrib.flash_attention(
                    mx.sym.var("q"), mx.sym.var("k"), mx.sym.var("v"),
                    causal=True)
                grads = {n: _as_nd(mx, torch.zeros_like(t))
                         for n, t in zip("qkv", (q, k, v))}
                ex = s.bind(mx.gpu(0), {n: _as_nd(mx, t) for n, t in
                                        zip("qkv", (q, k, v))},
                            args_grad=grads)
                out = ex.forward(is_train=True)[0]._data
                ex.backward([_as_nd(mx, do)])
                got = [out] + [grads[n]._data for n in "qkv"]
            else:
                nds = [_as_nd(mx, t.clone()) for t in (q, k, v)]
                for a in nds:
                    a.attach_grad()
                fn = (mx.nd.contrib.flash_attention if route == "nd"
                      else (lambda *a: net(*a)))
                with mx.autograd.record():
                    out = fn(*nds) if route == "hybridized" else fn(
                        *nds, causal=True)
                out.backward(_as_nd(mx, do))
                got = [out._data.detach()] + [a.grad._data for a in nds]
            torch.cuda.synchronize()
            errs = {n: rel_err(g, r) for n, g, r in
                    zip(("o", "dq", "dk", "dv"), got, want)}
            counts = dict(fa.LAUNCHES)
            routes = {n: dict(fa.ROUTES[n]) for n in launches}
            for n in launches:
                launches[n] += counts[n]
            rows.append({"route": route, "shape": [b, h, s_q, s_k, d],
                         "rel_err": errs, "launches": {
                             n: counts[n] for n in launches}})
            log("contrib flash_attention %-10s %s bf16 causal: %s; "
                "launches %s, routes %s" % (
                    route, (b, h, s_q, s_k, d), " ".join(
                        "%s=%.2e" % kv for kv in errs.items()),
                    {n: counts[n] for n in launches}, routes))
            bad = {n: e for n, e in errs.items() if e > lim[n]}
            check(not bad, "contrib flash_attention %s %s: %s over %s"
                  % (route, (b, h, s_q, s_k, d), bad, lim))
            check(all(counts[n] == want_n
                      and routes[n][want_route] == want_n
                      for n in launches), "contrib flash_attention %s: "
                  "launches %s routes %s, expected %d %s launches each"
                  % (route, counts, routes, want_n, want_route))
    return {"rows": rows, "launches": launches}


def lm_cli(torch, mx, fa):
    """Phase 40: ``train_transformer_lm.main`` in-process at
    benchmark.py:669's widths in float32 (the CLI's dtype), dense, then
    with ``--num-experts 8`` (top-2, capacity factor 2.0), each with
    ``--generate 32``: the printed lines, the loss falling on the
    stream, 12 forward and 12 backward flash launches a step on the
    route flash_route names (float32: fma), the paged kernels never, 32
    tokens generated."""
    import contextlib
    import io
    from mxnet_tpu_torch.examples import train_transformer_lm as cli
    res = {}
    for label, extra in (("dense", []), ("moe", ["--num-experts", "8"])):
        argv = LM_CLI_ARGS + extra + LM_CLI_EXTRA
        steps, layers, n_gen, d_model, heads, seq = (
            int(argv[len(argv) - 1 - argv[::-1].index(flag) + 1])
            for flag in ("--steps", "--n-layers", "--generate",
                         "--d-model", "--n-heads", "--seq-len"))
        want_route = fa.flash_route(torch.float32, d_model // heads, seq,
                                    seq)
        fa.reset_launches()
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = cli.main(argv, device=mx.gpu(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lines = buf.getvalue().strip().splitlines()
        for line in lines:
            log("lm cli %s | %s" % (label, line))
        launches = dict(fa.LAUNCHES)
        routes = {n: dict(fa.ROUTES[n]) for n in ("flash_attention",
                                                  "flash_attention_bwd")}
        losses = [float(ln.split()[3]) for ln in lines
                  if ln.startswith("step")]
        n_params = sum(p.numel() for p in out["params"].parameters())
        res[label] = {"lines": lines, "losses": losses, "wall_s": wall,
                      "launches": launches, "routes": routes,
                      "n_params": n_params, "match": out.get("match"),
                      "steps": steps}
        log("lm cli %s: %d params, %d steps + generate in %.1fs; losses "
            "%s; flash launches %s, routes %s; match %.2f"
            % (label, n_params, steps, wall, losses,
               {k: launches[k] for k in routes}, routes, out["match"]))
        check(all(np.isfinite(losses)), "lm cli %s: loss %s" % (label,
                                                                  losses))
        check(losses[-1] < losses[0], "lm cli %s: the loss did not fall: "
              "%s" % (label, losses))
        check(any(ln.startswith("mesh=") for ln in lines)
              and any(ln.startswith("generated %d tokens" % n_gen)
                      for ln in lines),
              "lm cli %s: missing printed lines" % label)
        check(tuple(out["generated"].shape) == (1, n_gen),
              "lm cli %s: generated %s" % (label,
                                           tuple(out["generated"].shape)))
        for name in routes:
            check(launches[name] == layers * steps
                  and routes[name][want_route] == launches[name],
                  "lm cli %s: %s launched %d times (routes %s) for %d "
                  "steps x %d layers" % (label, name, launches[name],
                                         routes[name], steps, layers))
        check(launches["paged_decode_attention"] == 0
              and launches["flash_prefill_paged"] == 0,
              "lm cli %s: the paged kernels ran: %s" % (label, launches))
    return res


def card_params(torch, cfg, seed, trainable=True):
    """Full-width weights drawn on the card (std 0.02, ones / zeros for
    the LayerNorms) from a seeded CUDA generator, in the port's layout:
    the MoE experts' 805M draws would take the host ~30 s in numpy; the
    numpy draw order is the CPU tests'."""
    from mxnet_tpu_torch.parallel.transformer import (TransformerParams,
                                                      expected_shapes)
    gen = torch.Generator(device=CARD).manual_seed(seed)
    tensors = {}
    for name, shape in expected_shapes(cfg).items():
        if name.startswith("ln"):
            fill = torch.ones if name.endswith("_g") else torch.zeros
            tensors[name] = fill(shape, dtype=cfg.dtype, device=CARD)
        else:
            tensors[name] = (torch.randn(shape, generator=gen,
                                         device=CARD) * 0.02).to(
                cfg.dtype)
    return TransformerParams(cfg, tensors, trainable=trainable)


def active_params(cfg, n_params):
    """Parameters a token runs through: all but the experts it skips
    (an MoE layer's top-2 of num_experts)."""
    if not cfg.num_experts:
        return n_params
    per_expert = 2 * cfg.d_model * cfg.d_ff
    return n_params - cfg.n_layers * (cfg.num_experts - min(
        cfg.moe_top_k, 2)) * per_expert


def train_configs(torch, fa):
    """Phase 41: ``make_transformer_train_step`` in bf16 at the train
    path's widths (phase 8) in three configurations: MoE (8 experts,
    top-2, capacity 2.0), dense with ``remat=True``, dense without. A
    warm and a timed call of STEP_K steps each: tokens/s, ms/step, MFU
    (6 N_active + 12 L d s / 2 a token: N_active counts a token's two
    experts, not all eight), peak memory of the step, flash launches a
    step (remat: two forwards a layer), one profiled step; then the loss
    and every weight's gradient with remat, which must be bitwise those
    without, from the same weights and batch."""
    from mxnet_tpu_torch.parallel.transformer import (
        TransformerConfig, _lm_local_loss, make_transformer_train_step)
    rng = np.random.RandomState(41)
    shape = (STEP_K, TRAIN_BATCH, TRAIN_SEQ)
    tokens = torch.tensor(rng.randint(0, TRAIN["vocab_size"], shape),
                          dtype=torch.int32, device=CARD)
    targets = torch.tensor(rng.randint(0, TRAIN["vocab_size"], shape),
                           dtype=torch.int32, device=CARD)
    res = {"flop_convention": "6 * N_active + 12 * L * d * s / 2 per "
           "token; N_active = parameters less the (num_experts - 2) "
           "experts a token skips in each MoE layer"}
    for label, kw in STEP_CONFIGS:
        cfg = TransformerConfig(dtype=torch.bfloat16, **dict(TRAIN, **kw))
        params = card_params(torch, cfg, seed=41)
        n_params = sum(p.numel() for p in params.parameters())
        n_active = active_params(cfg, n_params)
        loop = make_transformer_train_step(cfg, None, lr=TRAIN_LR,
                                           device_loop=True)
        calls = []
        for i in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launches()
            t0 = time.perf_counter()
            params, loss = loop(params, tokens, targets)
            loss = float(loss)
            torch.cuda.synchronize()
            calls.append({"wall_s": time.perf_counter() - t0, "loss": loss,
                          "launches": dict(fa.LAUNCHES),
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
            check(np.isfinite(loss), "train %s: loss %r" % (label, loss))
        fwd = 2 if cfg.remat else 1
        ln = calls[1]["launches"]
        check(ln["flash_attention"] == fwd * cfg.n_layers * STEP_K
              and ln["flash_attention_bwd"] == cfg.n_layers * STEP_K,
              "train %s: flash launches %s for %d steps x %d layers"
              % (label, ln, STEP_K, cfg.n_layers))
        dt = calls[1]["wall_s"]
        tps = TRAIN_BATCH * TRAIN_SEQ * STEP_K / dt
        flop_tok = 6 * n_active + 12 * cfg.n_layers * cfg.d_model * \
            TRAIN_SEQ * 0.5
        mfu = tps * flop_tok / BF16_FLOPS
        check(mfu <= 1.05, "train %s: MFU %.2f > 1" % (label, mfu))
        step = make_transformer_train_step(cfg, None, lr=TRAIN_LR)
        prof = profile_run(torch, lambda: step(params, tokens[0],
                                               targets[0]))
        log_profile("train %s profiled step" % label, prof)
        res[label] = {"n_params": n_params, "n_active": n_active,
                      "tokens_per_s": tps, "ms_per_step": dt * 1e3 / STEP_K,
                      "mfu": mfu, "flop_per_token": flop_tok,
                      "peak_mem_gb": calls[1]["peak_gb"], "calls": calls,
                      "profiled_step": prof}
        log("train %s (bf16, batch %d x %d): %d params (%d active), %.0f "
            "tokens/s, %.2f ms/step, MFU %.3f (%.3g GFLOP/token), peak "
            "memory %.2f GB, last loss %.4f, launches %s"
            % (label, TRAIN_BATCH, TRAIN_SEQ, n_params, n_active, tps,
               res[label]["ms_per_step"], mfu, flop_tok / 1e9,
               calls[1]["peak_gb"], calls[1]["loss"],
               {k: v for k, v in ln.items() if v}))
        del params, loop, step
    # remat against no remat: the same weights and batch, loss and grads
    cfg = TransformerConfig(dtype=torch.bfloat16, **TRAIN)
    params = card_params(torch, cfg, seed=42)
    leaves = list(params.parameters())
    names = [n for n, _ in params.named_parameters()]
    out = {}
    for remat in (False, True):
        cfg.remat = remat
        with torch.enable_grad():
            loss = _lm_local_loss(params, tokens[0], targets[0], cfg)
        grads = torch.autograd.grad(loss, leaves)
        out[remat] = (loss.detach(), grads)
    cfg.remat = False
    diff = {n: float((a.float() - b.float()).abs().max())
            for n, a, b in zip(names, out[True][1], out[False][1])}
    same = torch.equal(out[True][0], out[False][0]) and not any(
        diff.values())
    res["remat_vs_plain"] = {"bitwise": same, "loss": [
        float(out[False][0]), float(out[True][0])],
        "max_grad_diff": max(diff.values()),
        "worst": max(diff, key=diff.get)}
    log("train remat vs no remat (bf16, same weights and batch): loss %.6f "
        "/ %.6f, %s; largest gradient difference %.3g (%s)"
        % (float(out[False][0]), float(out[True][0]),
           "bitwise equal" if same else "NOT bitwise equal",
           max(diff.values()), max(diff, key=diff.get)))
    # the recompute runs the forward's kernels on the same inputs, so
    # the loss and every gradient must be bitwise those without remat
    check(same, "train: remat is not bitwise equal to no remat: loss %s "
          "vs %s, largest gradient difference %.3g (%s)"
          % (float(out[True][0]), float(out[False][0]), max(diff.values()),
             max(diff, key=diff.get)))
    return res


def generate_card(torch, mx, fa):
    """Phase 42: ``transformer_generate`` at benchmark.py:736
    decode_transformer_lm (bf16, GQA 16 / 4, RoPE, 12 layers, batch 8,
    prompt 32, 128 steps, seeded weights): generated tokens/s of a
    timed call after a warm one, the paged kernels never launched, and a
    profiled call of 16 steps. Then
    float32 at GEN_CHECK_LAYERS layers: the greedy tokens of the dense
    cache on the card equal the CPU's and the paged ``DecodeEngine``'s
    for the same prompts (the engine launching the paged kernels)."""
    from mxnet_tpu_torch.parallel.transformer import (
        TransformerConfig, init_transformer_params_np, transformer_generate)
    from mxnet_tpu_torch.serve import DecodeConfig, DecodeEngine
    cfg = TransformerConfig(dtype=torch.bfloat16, **FULL)
    params = init_transformer_params_np(cfg, seed=0, device=mx.gpu(0))
    rng = np.random.RandomState(42)
    prompt = torch.tensor(rng.randint(0, cfg.vocab_size,
                                      (GEN_BATCH, GEN_PROMPT)),
                          dtype=torch.int32, device=CARD)
    runs = []
    for i in range(2):
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = transformer_generate(params, prompt, GEN_STEPS, cfg)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        check(all(v == 0 for v in fa.LAUNCHES.values()),
              "generate launched %s" % fa.LAUNCHES)
    check(tuple(out.shape) == (GEN_BATCH, GEN_STEPS)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generate: tokens %s" % (tuple(out.shape),))
    tps = GEN_BATCH * GEN_STEPS / runs[1]
    res = {"tokens_per_s": tps, "wall_s": runs, "ms_per_token_step":
           runs[1] * 1e3 / GEN_STEPS}
    log("generate (bf16, GQA 16/4, RoPE, 12 layers, batch %d, prompt %d, "
        "%d steps): warm %.3fs, timed %.3fs: %.1f generated tokens/s, "
        "%.2f ms a step" % (GEN_BATCH, GEN_PROMPT, GEN_STEPS, runs[0],
                            runs[1], tps, res["ms_per_token_step"]))
    res["profiled_16_steps"] = profile_run(
        torch, lambda: transformer_generate(params, prompt, 16, cfg))
    log_profile("generate profiled (16 steps)", res["profiled_16_steps"])
    del params
    # float32 streams: dense cache (card, CPU) and the paged engine
    cfg = TransformerConfig(dtype=torch.float32, **dict(
        FULL, n_layers=GEN_CHECK_LAYERS))
    p_cpu = init_transformer_params_np(cfg, seed=0, device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(CARD)
    steps = 32
    streams = {"cpu": transformer_generate(p_cpu, prompt.cpu(), steps, cfg),
               "card": transformer_generate(p_gpu, prompt, steps,
                                            cfg).cpu()}
    eng = DecodeEngine(p_gpu, cfg, DecodeConfig(), device=CARD).start()
    try:
        fa.reset_launches()
        sess = [eng.submit(p.tolist(), max_new_tokens=steps)
                for p in prompt.cpu()]
        streams["engine"] = torch.tensor([s.result() for s in sess],
                                         dtype=torch.int32)
        launches = dict(fa.LAUNCHES)
    finally:
        eng.close(drain=False)
    agree = {k: float((v == streams["cpu"]).float().mean())
             for k, v in streams.items()}
    res["f32_streams"] = {"agree_with_cpu": agree, "engine_launches":
                          launches}
    log("generate f32 (%d layers, batch %d, %d steps): share of tokens "
        "equal to the CPU's dense stream: %s; engine launches %s"
        % (GEN_CHECK_LAYERS, GEN_BATCH, steps, agree,
           {k: v for k, v in launches.items() if v}))
    check(torch.equal(streams["card"], streams["cpu"]),
          "generate: card stream differs from the CPU's")
    check(torch.equal(streams["engine"], streams["cpu"]),
          "generate: the paged engine's stream differs from the dense "
          "cache's")
    check(launches["paged_decode_attention"] > 0
          and launches["flash_prefill_paged"] == cfg.n_layers * GEN_BATCH,
          "generate: engine launches %s" % launches)
    return res


def moe_serve(torch, mx, fa):
    """Phase 43: the decode config with 8 experts (bf16, 12 layers,
    weights drawn on the card) through ``DecodeEngine``, GEN_REQUESTS
    requests of phase 4's mix: every session's token count, the paged
    kernels launched once a layer per prefill and per step on their
    redesigned routes, tokens/s; then the same requests profiled."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.parallel.transformer import TransformerConfig
    from mxnet_tpu_torch.serve import DecodeConfig, DecodeEngine
    cfg = TransformerConfig(dtype=torch.bfloat16, num_experts=8, **FULL)
    params = card_params(torch, cfg, seed=43, trainable=False)
    rng = np.random.RandomState(0)
    reqs = []
    for _ in range(GEN_REQUESTS):
        if rng.rand() < 0.5:
            plen, mnew = rng.randint(4, 24), rng.randint(32, 64)
        else:
            plen, mnew = rng.randint(48, 128), rng.randint(4, 16)
        reqs.append((list(rng.randint(0, cfg.vocab_size, (plen,))),
                     int(mnew)))

    def count(name):
        return telemetry.snapshot().get(name, {"count": 0})["count"]

    eng = DecodeEngine(params, cfg, DecodeConfig(), device=CARD).start()
    try:
        eng.warmup()
        n_pre0, n_step0 = count("decode/prefill_seconds"), count(
            "decode/step_seconds")
        fa.reset_launches()
        t0 = telemetry.monotonic()
        outs = [s.result() for s in [eng.submit(p, max_new_tokens=m)
                                     for p, m in reqs]]
        wall = telemetry.monotonic() - t0
        launches = dict(fa.LAUNCHES)
        routes = {k: dict(fa.ROUTES[k]) for k in ("paged_decode_attention",
                                                  "flash_prefill_paged")}
        n_pre = count("decode/prefill_seconds") - n_pre0
        n_step = count("decode/step_seconds") - n_step0
        prof = profile_round(torch, eng, reqs)
    finally:
        eng.close(drain=False)
    log_profile("moe serve profiled round", prof)
    for (p, m), out in zip(reqs, outs):
        check(len(out) == m, "moe serve: %d tokens, expected %d"
              % (len(out), m))
    check(launches["flash_prefill_paged"] == cfg.n_layers * n_pre
          and launches["paged_decode_attention"] == cfg.n_layers * n_step
          and n_step > 0, "moe serve: launches %s for %d prefills, %d "
          "steps" % (launches, n_pre, n_step))
    check(routes["paged_decode_attention"]["cluster"]
          == launches["paged_decode_attention"]
          and routes["flash_prefill_paged"]["mma"]
          == launches["flash_prefill_paged"],
          "moe serve: a launch off the redesigned routes: %s" % routes)
    tokens = sum(len(o) for o in outs)
    res = {"requests": len(reqs), "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall, "prefills": n_pre,
           "decode_steps": n_step, "launches": launches, "routes": routes,
           "profiled_round": prof}
    log("moe serve (8 experts, bf16, 12 layers): %d requests, %d tokens in "
        "%.3fs: %.1f tokens/s; %d prefills, %d steps; launches %s"
        % (len(reqs), tokens, wall, res["tokens_per_s"], n_pre, n_step,
           {k: v for k, v in launches.items() if v}))
    return res


# ---------------------------------------------------------------------------
# phases 44-49: the JAX package's headline training path (ShardedTrainer,
# benchmark.py's train_resnet / train_inception / train_mlp /
# e2e_train_resnet) and DataPipeline
# ---------------------------------------------------------------------------

# benchmark.py:3288-3318: the train_resnet jobs at 3x224x224, 1000 classes
SHARDED_ROWS = (("resnet50_train", 32, "float32"),
                ("resnet50_train_bf16", 32, "bfloat16"),
                ("resnet50_train_b128_bf16", 128, "bfloat16"),
                ("resnet50_train_b256_bf16", 256, "bfloat16"))
SHARDED_IMAGE = (3, 224, 224)
SHARDED_K = 8           # train_resnet's steps_per_call
SHARDED_WARM = 1        # run_steps calls after the capturing one, untimed
SHARDED_CALLS = 3       # timed calls: 24 steps a row
SHARDED_HYPER = dict(lr=0.05, momentum=0.9)     # benchmark.py:380
# run_steps against k eager steps from one state: the losses, every
# parameter and momentum, relative to each tensor's norm (the JAX
# package's own test, tests/test_parallel_5d.py:493, holds rtol 1e-5)
SHARDED_EQ_TOL = 1e-5
SHARDED_EQ_BATCH = 32   # the check at the first row's batch, float32
SHARDED_PLANT_BATCH = 8     # the planted stale-stack fault, cheaper
# the trainer's update against a float64 replay of the JAX rule over the
# executor's gradients (float32 rounding of one step: ~1e-7 relative);
# and a bf16 step's moving statistics against the same forward's float32
# batch statistics (the same kernels: equal in a sound run)
RULE_TOL = 1e-5
AUX_TOL = 1e-5
INCEPTION_K = 4         # benchmark.py:514 train_inception
INCEPTION_CALLS = 3
INCEPTION_SIDE = 299
MLP_BATCH, MLP_K, MLP_CALLS = 64, 32, 4     # benchmark.py:1788 train_mlp
E2E_RECORDS = 512       # benchmark.py:595 e2e_train_resnet: 512 JPEGs of
E2E_SIDE = 256          # 256 x 256, batch 64, bf16, resize 256, 8 steps
E2E_BATCH = 64
E2E_ITERS = 8
E2E_PROFILED = 4        # steps in the profiled window
PIPE_BATCH = 128        # benchmark.py:461 data_pipeline: batch 128, 224
PIPE_ITERS = 6          # timed batches a worker count, after a warm one
PIPE_COMPARED = 4       # batches held bitwise across worker counts
PROBE = dict(batch=64, batches=24, epochs=3, workers=2)     # :407

def _sync(torch):
    if CARD == "cuda":
        torch.cuda.synchronize()


def _sharded_mesh(mx):
    return mx.parallel.make_mesh(devices=[CARD])


def _sharded_ctx(mx):
    return mx.gpu(0) if CARD == "cuda" else mx.cpu()


def _rel_norm(torch, got, ref):
    den = float(ref.double().norm())
    num = float((got.double() - ref.double()).norm())
    return num / den if den > 0 else num


def _state_err(torch, a, b):
    """The largest relative norm of the difference over two states'
    tensors (parameters and momenta)."""
    return max(_rel_norm(torch, a[i][n], b[i][n])
               for i in range(2) for n in b[i])


def _clone_state(state):
    return [{n: t.clone() for n, t in d.items()} for d in state]


def measure_sharded(torch, tr, batch, image, classes, k, calls, flop, peak,
                    label, warm=SHARDED_WARM, finite=True):
    """``benchmark.py``'s ``_measure_train`` through ``run_steps``: init,
    ``stage_many`` of k distinct seeded batches,
    a capturing call and ``warm`` more, then ``calls`` timed calls of k
    steps synced on the loss and an updated weight; img/s, ms/step, MFU
    (refused above 1.05); with ``finite`` the loss must be finite."""
    state = list(tr.init((batch,) + image, (batch,)))
    # seeded batches drawn on the device (a host draw of batch 256's
    # 1.2 GB takes seconds): stage_many copies them into its stack
    gen = torch.Generator(device=CARD).manual_seed(0)
    data = torch.randn((k, batch) + image, generator=gen,
                       device=CARD)
    lab = torch.randint(0, classes, (k, batch), generator=gen,
                        device=CARD).float()
    d, l = tr.stage_many(data, lab)
    del data
    first = next(iter(state[0]))

    def call():
        state[0], state[1], state[2], loss = tr.run_steps(*state, d, l)
        return loss

    def synced(loss):
        return float(loss), float(state[0][first].reshape(-1)[0])

    t0 = time.perf_counter()
    synced(call())
    capture_s = time.perf_counter() - t0
    for _ in range(warm):
        synced(call())
    t0 = time.perf_counter()
    for _ in range(calls):
        loss = call()
    loss_v, _w = synced(loss)
    dt = (time.perf_counter() - t0) / (calls * k)
    img_s = batch / dt
    mfu = img_s * flop / peak
    check(np.isfinite(loss_v) or not finite, "%s: loss %r"
          % (label, loss_v))
    check(mfu <= 1.05, "%s: %.0f img/s implies MFU %.2f > 1: the clock "
          "does not block" % (label, img_s, mfu))
    return {"batch": batch, "k": k, "timed_steps": calls * k,
            "img_per_s": img_s, "ms_per_step": dt * 1e3, "mfu": mfu,
            "gflop_per_img": flop / 1e9, "loss": loss_v,
            "first_call_s": capture_s, "captures": tr.captures,
            "call": call}


def sharded_rows(torch, mx, module_img_s):
    """Phase 44: ResNet-50 (``examples/train_imagenet.py``'s network, 1000
    classes) through ``ShardedTrainer.run_steps`` as ``benchmark.py``'s
    ``train_resnet`` rows run it: batch 32 float32 (TF32 off), batch 32,
    128 and 256 bf16; k = 8 distinct staged batches a call, ONE CUDA
    graph replay a call (captured once); img/s, ms/step, MFU over the
    network's own conv / FC FLOPs (67 TFLOP/s f32, 989 bf16), peak
    memory, one profiled replay (host launches, busy share, device ms by
    class); phase 13's ``Module.fit`` img/s beside the f32 row as
    context."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    mesh = _sharded_mesh(mx)
    sym = resnet_symbol(mx)
    flop = network_flops(mx, sym, SHARDED_IMAGE)
    rows = {}
    for name, batch, dtype in SHARDED_ROWS:
        mx.random.seed(44)
        tr = mx.parallel.ShardedTrainer(
            sym, mesh, compute_dtype=None if dtype == "float32" else dtype,
            **SHARDED_HYPER)
        if CARD == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        peak = F32_FLOPS if dtype == "float32" else BF16_FLOPS
        res = measure_sharded(torch, tr, batch, SHARDED_IMAGE, 1000,
                              SHARDED_K, SHARDED_CALLS, flop, peak, name)
        call = res.pop("call")
        check(tr.captures == 1, "%s: %d CUDA graph captures for one shape"
              % (name, tr.captures))
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 \
            if CARD == "cuda" else None
        prof = profile_run(torch, call, _resnet_class)
        check(tr.captures == 1, "%s: the profiled call captured again"
              % name)
        res.update(dtype=dtype, profiled_call=prof)
        rows[name] = res
        log("%s: ShardedTrainer.run_steps, batch %d %s x 3x224x224, %d "
            "steps a call (one CUDA graph), %d timed steps: %.1f img/s, "
            "%.2f ms/step, MFU %.3f (%.2f GFLOP/img from its conv/FC "
            "shapes over %s TFLOP/s); first call (warm-up + capture + "
            "replay) %.2fs; peak memory %s GB; loss %.4f"
            % (name, batch, dtype, SHARDED_K, res["timed_steps"],
               res["img_per_s"], res["ms_per_step"], res["mfu"],
               flop / 1e9, "67" if dtype == "float32" else "989",
               res["first_call_s"], None if res["peak_mem_gb"] is None
               else "%.2f" % res["peak_mem_gb"], res["loss"]))
        log_profile("%s profiled replay (%d steps)" % (name, SHARDED_K),
                    prof)
        del tr, call
    f32 = rows[SHARDED_ROWS[0][0]]["img_per_s"]
    log("ShardedTrainer f32 batch %d: %.1f img/s against phase 13's "
        "Module.fit at batch %d: %.1f img/s (%.3fx; context, not a target)"
        % (SHARDED_ROWS[0][1], f32, RESNET_BATCH, module_img_s,
           f32 / module_img_s))
    rows["module_fit_img_per_s"] = module_img_s
    return rows


def sharded_vs_eager(torch, mx, batch=SHARDED_EQ_BATCH, plant=None):
    """Phase 45: ``run_steps`` (one CUDA graph of k steps) against k eager
    ``step`` calls from the same state, ResNet-50 float32 under
    deterministic cuDNN: the last loss, every parameter and momentum
    within SHARDED_EQ_TOL; then a second ``stage_many`` of new batches
    (written into the same static stack) and both again. ``plant``
    replaces the trainer's ``_restage`` (a planted fault)."""
    mesh = _sharded_mesh(mx)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mx.random.seed(45)
        tr = mx.parallel.ShardedTrainer(resnet_symbol(mx), mesh,
                                        **SHARDED_HYPER)
        if plant is not None:
            tr._restage = plant
        graph = list(tr.init((batch,) + SHARDED_IMAGE, (batch,)))
        eager = _clone_state(graph)
        gen = torch.Generator().manual_seed(45)
        errs = []
        for _round in range(2):
            x = torch.randn((SHARDED_K, batch) + SHARDED_IMAGE,
                            generator=gen)
            y = torch.randint(0, 1000, (SHARDED_K, batch),
                              generator=gen).float()
            d, l = tr.stage_many(x, y)
            *graph[:3], loss_g = tr.run_steps(*graph, d, l)
            for i in range(SHARDED_K):
                *eager[:3], loss_e = tr.step(*eager, x[i], y[i])
            _sync(torch)
            err = max(_state_err(torch, graph, eager),
                      abs(float(loss_g) - float(loss_e))
                      / max(1.0, abs(float(loss_e))))
            errs.append(err)
            check(err <= SHARDED_EQ_TOL, "run_steps vs %d eager steps "
                  "(round %d): relative error %.3g > %g"
                  % (SHARDED_K, _round + 1, err, SHARDED_EQ_TOL))
        check(tr.captures == 1, "run_steps captured %d graphs for one "
              "shape" % tr.captures)
    finally:
        torch.backends.cudnn.deterministic = det
    return errs


def _stale_stack():
    """A planted fault: the static stack is written once, then never
    again (a later stage_many leaves the captured graph reading the first
    batches)."""
    written = []

    def restage(static, src):
        if len(written) < 2:
            written.append(1)
            static.copy_(src)
    return restage


def sharded_update_rule(torch, mx, plant=None):
    """Phase 46a: one trainer step of the MLP (float32, lr 0.1, momentum
    0.9, wd 1e-4) from nonzero momenta against a float64 replay of the
    JAX trainer's rule (``g = grad + wd * p; m = momentum * m + g; p = p -
    lr * m``) over the executor's gradients of the same batch (another
    code path): parameters and momenta within RULE_TOL. ``plant``
    replaces the trainer module's update rule."""
    from mxnet_tpu_torch.parallel import trainer as trm
    lr, mom, wd = 0.1, 0.9, 1e-4
    sym = mx.models.mlp()
    mesh = _sharded_mesh(mx)
    mx.random.seed(46)
    tr = mx.parallel.ShardedTrainer(sym, mesh, lr=lr, momentum=mom, wd=wd)
    p, m, a = tr.init((MLP_BATCH, 784), (MLP_BATCH,))
    gen = torch.Generator().manual_seed(46)
    for t in m.values():
        t.copy_(torch.randn(t.shape, generator=gen) * 0.01)
    x = torch.randn(MLP_BATCH, 784, generator=gen)
    y = torch.randint(0, 10, (MLP_BATCH,), generator=gen).float()
    dev = torch.device(CARD)
    args = {n: mx.nd.NDArray(t.clone()) for n, t in p.items()}
    args["data"] = mx.nd.NDArray(x.to(dev))
    args["softmax_label"] = mx.nd.NDArray(y.to(dev))
    exe = sym.bind(dev, args, grad_req={n: "write" for n in p})
    exe.forward(is_train=True)
    exe.backward()
    want_p, want_m = {}, {}
    for n in p:
        g = exe.grad_dict[n]._data.double() + wd * p[n].double()
        want_m[n] = mom * m[n].double() + g
        want_p[n] = p[n].double() - lr * want_m[n]
    real = trm._sgd_momentum
    if plant is not None:
        trm._sgd_momentum = plant
    try:
        tr.step(p, m, a, x, y)
    finally:
        trm._sgd_momentum = real
    err = _state_err(torch, [p, m], [want_p, want_m])
    check(err <= RULE_TOL, "trainer update against the JAX rule: "
          "relative error %.3g > %g" % (err, RULE_TOL))
    return err


def mxnet_rule(ps, grads, ms, lr, momentum, wd):
    """A planted fault: MXNet's ``sgd_mom_update`` (lr inside the
    momentum: ``mom = momentum * mom - lr * (g + wd * w); w += mom``)."""
    import torch
    with torch.no_grad():
        for p, g, m in zip(ps, grads, ms):
            m.mul_(momentum).sub_(lr * (g + wd * p))
            p.add_(m)


def sharded_bf16_aux(torch, mx, plant=None):
    """Phase 46b: one bf16 ResNet-50 step at batch 32: every auxiliary
    state float32 and equal (within AUX_TOL) to the moving update of the
    float32 batch statistics of the same bf16 forward, evaluated apart
    through ``_graph_eval_fn``. ``plant`` replaces the trainer module's
    moving-statistics update."""
    from mxnet_tpu_torch.parallel import trainer as trm
    from mxnet_tpu_torch.symbol.symbol import (_graph_eval_fn,
                                               update_moving_stats)
    sym = resnet_symbol(mx)
    mesh = _sharded_mesh(mx)
    mx.random.seed(47)
    batch = RESNET_BATCH
    tr = mx.parallel.ShardedTrainer(sym, mesh, compute_dtype="bfloat16",
                                    **SHARDED_HYPER)
    p, m, a = tr.init((batch,) + SHARDED_IMAGE, (batch,))
    gen = torch.Generator().manual_seed(47)
    for n, t in a.items():
        r = torch.rand(t.shape, generator=gen)
        t.copy_(r + 0.5 if n.endswith("_var") else r - 0.5)
    x = torch.randn((batch,) + SHARDED_IMAGE, generator=gen).to(CARD)
    y = torch.randint(0, 1000, (batch,), generator=gen).float().to(
        CARD)
    # the step's own forward, apart: bf16 casts of fresh leaves
    with torch.enable_grad():
        env = {n: t.detach().requires_grad_().to(torch.bfloat16)
               for n, t in p.items()}
        env.update(a)
        env.update(data=x.to(torch.bfloat16), softmax_label=y)
        _outs, stats = _graph_eval_fn(sym, True)(env)
    want = {n: t.clone() for n, t in a.items()}
    update_moving_stats(stats, want)
    del env, _outs, stats
    real = trm.update_moving_stats
    if plant is not None:
        trm.update_moving_stats = plant
    try:
        tr.step(p, m, a, x, y)
    finally:
        trm.update_moving_stats = real
    _sync(torch)
    check(all(t.dtype == torch.float32 for t in a.values()),
          "bf16 step: auxiliary states of types %s"
          % sorted({str(t.dtype) for t in a.values()}))
    err = max(_rel_norm(torch, a[n], want[n]) for n in a)
    check(err <= AUX_TOL, "bf16 step: moving statistics %.3g from the "
          "float32 batch statistics' update > %g" % (err, AUX_TOL))
    return err


def bf16_moving_stats(stats, aux):
    """A planted fault: the moving statistics updated in bf16 and kept
    at bf16's precision."""
    import torch
    from mxnet_tpu_torch.symbol.symbol import update_moving_stats
    half = {n: t.to(torch.bfloat16) for n, t in aux.items()}
    update_moving_stats(stats, half)
    with torch.no_grad():
        for n, t in half.items():
            aux[n].copy_(t)


def planted(fn, *args, **kw):
    """True when ``fn`` fails its check (a planted fault must)."""
    try:
        fn(*args, **kw)
    except RuntimeError as e:
        if "chip_smoke:" not in str(e):
            raise
        log("planted fault caught: %s" % str(e)[len("chip_smoke: "):])
        return True
    return False


def sharded_checks(torch, mx):
    """Phases 45-46: run_steps against eager steps, the update rule and
    the bf16 moving statistics, each with a planted fault that must
    fail."""
    res = {"graph_vs_eager": sharded_vs_eager(torch, mx),
           "update_rule": sharded_update_rule(torch, mx),
           "bf16_aux": sharded_bf16_aux(torch, mx)}
    check(planted(sharded_vs_eager, torch, mx, SHARDED_PLANT_BATCH,
                  _stale_stack()), "a run_steps graph over a stale staged "
          "stack passed")
    check(planted(sharded_update_rule, torch, mx, mxnet_rule),
          "MXNet's momentum rule (lr inside the momentum) passed")
    check(planted(sharded_bf16_aux, torch, mx, bf16_moving_stats),
          "a bf16 step with bf16 moving statistics passed")
    log("ShardedTrainer checks: run_steps vs %d eager steps (ResNet-50 "
        "f32, batch %d, deterministic cuDNN) relative %s (limit %g); the "
        "update vs the JAX rule in float64 %.3g (limit %g); bf16 moving "
        "statistics vs their float32 update %.3g (limit %g); three planted "
        "faults failed" % (SHARDED_K, SHARDED_EQ_BATCH,
                           ["%.3g" % e for e in res["graph_vs_eager"]],
                           SHARDED_EQ_TOL, res["update_rule"], RULE_TOL,
                           res["bf16_aux"], AUX_TOL))
    return res


def sharded_inception_mlp(torch, mx):
    """Phase 47: ``benchmark.py``'s ``train_inception`` (the zoo's
    inceptionv3 traced by ``_trace_symbol`` under ``SoftmaxOutput``, batch
    32 of float32 3x299x299, k = 4, Dropout drawing on every replay from
    the port's generator registered with the graph) and one bf16 step,
    finite; and ``train_mlp`` (the MLP at batch 64, k = 32): steps/s."""
    mesh = _sharded_mesh(mx)
    net = zoo_net(mx, "inceptionv3", _sharded_ctx(mx), 30)
    image = (3, INCEPTION_SIDE, INCEPTION_SIDE)
    sym = mx.sym.SoftmaxOutput(net._trace_symbol(), name="softmax")
    del net
    flop = network_flops(mx, sym, image)
    mx.random.seed(47)
    tr = mx.parallel.ShardedTrainer(sym, mesh, **SHARDED_HYPER)
    incep = measure_sharded(torch, tr, RESNET_BATCH, image, 1000,
                            INCEPTION_K, INCEPTION_CALLS, flop, F32_FLOPS,
                            "inceptionv3")
    incep.pop("call")
    del tr
    tr16 = mx.parallel.ShardedTrainer(sym, mesh, compute_dtype="bfloat16",
                                      **SHARDED_HYPER)
    state = tr16.init((RESNET_BATCH,) + image, (RESNET_BATCH,))
    gen = torch.Generator().manual_seed(48)
    *state, loss16 = tr16.step(*state, torch.randn(
        (RESNET_BATCH,) + image, generator=gen), torch.randint(
        0, 1000, (RESNET_BATCH,), generator=gen).float())
    loss16 = float(loss16)
    check(np.isfinite(loss16) and all(
        bool(torch.isfinite(t).all()) for t in state[0].values()),
        "inceptionv3 bf16 step: loss %r" % loss16)
    incep["bf16_step_loss"] = loss16
    del tr16, state
    log("inceptionv3: ShardedTrainer.run_steps, batch %d f32 x 3x299x299, "
        "%d steps a call, %d timed: %.1f img/s, %.2f ms/step, MFU %.3f "
        "(%.2f GFLOP/img); first call %.2fs; one bf16 step, loss %.4f"
        % (RESNET_BATCH, INCEPTION_K, incep["timed_steps"],
           incep["img_per_s"], incep["ms_per_step"], incep["mfu"],
           flop / 1e9, incep["first_call_s"], loss16))
    sym = mx.models.mlp()
    mlp_flop = network_flops(mx, sym, (784,))
    mx.random.seed(48)
    tr = mx.parallel.ShardedTrainer(sym, mesh, lr=0.1, momentum=0.9)
    # lr 0.1 on SoftmaxOutput's batch-summed gradient diverges from some
    # initializations, in the JAX package's job too: the loss is printed
    mlp = measure_sharded(torch, tr, MLP_BATCH, (784,), 10, MLP_K,
                          MLP_CALLS, mlp_flop, F32_FLOPS, "mlp", warm=2,
                          finite=False)
    mlp.pop("call")
    mlp["steps_per_s"] = 1e3 / mlp["ms_per_step"]
    log("mlp: ShardedTrainer.run_steps, batch %d, %d steps a call (one "
        "CUDA graph), %d timed: %.1f steps/s (%.4f ms/step, %.0f img/s); "
        "loss %.4f" % (MLP_BATCH, MLP_K, mlp["timed_steps"],
                       mlp["steps_per_s"], mlp["ms_per_step"],
                       mlp["img_per_s"], mlp["loss"]))
    return {"inceptionv3": incep, "mlp": mlp}


def synth_records(mx, path, n=E2E_RECORDS, side=E2E_SIDE, seed=0):
    """``benchmark.py``'s ``_write_synth_rec``: ``n`` seeded uniform-noise
    JPEGs of side x side (cv2's default quality), labels i % 10, in an
    indexed ``.rec``. Returns seconds."""
    import cv2
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rec = mx.recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                        path, "w")
    rng = np.random.RandomState(seed)
    for i in range(n):
        im = rng.randint(0, 255, (side, side, 3), dtype=np.uint8)
        _ok, buf = cv2.imencode(".jpg", im)
        rec.write_idx(i, mx.recordio.pack(
            mx.recordio.IRHeader(0, float(i % 10), i, 0), buf.tobytes()))
    rec.close()
    return time.perf_counter() - t0


def e2e_train(torch, mx, idec, rec):
    """Phase 48: ``benchmark.py``'s ``e2e_train_resnet``: ``ImageRecordIter
    (resize=256, rand_crop, rand_mirror, prefetch_buffer=2)`` over the
    512-record file on the native route (nvJPEG + ``crop_mirror_normalize``,
    ``nproc`` decode threads) feeding ``ShardedTrainer.step`` with the
    iterator's device tensors, bf16 ResNet-50 at batch 64: 2 warm steps,
    then E2E_ITERS timed (synced on the loss and an updated weight);
    img/s, MFU, one ``crop_mirror_normalize`` launch a decoded batch, no
    input copied; a profiled window (busy share)."""
    from mxnet_tpu_torch import image as mximage
    mesh = _sharded_mesh(mx)
    it = mx.io.ImageRecordIter(
        path_imgrec=rec, data_shape=SHARDED_IMAGE, batch_size=E2E_BATCH,
        shuffle=True, rand_crop=True, rand_mirror=True, resize=256,
        preprocess_threads=os.cpu_count(), prefetch_buffer=2,
        ctx=_sharded_ctx(mx))
    sym = resnet_symbol(mx)
    flop = network_flops(mx, sym, SHARDED_IMAGE)
    mx.random.seed(48)
    tr = mx.parallel.ShardedTrainer(sym, mesh, compute_dtype="bfloat16",
                                    **SHARDED_HYPER)
    state = list(tr.init((E2E_BATCH,) + SHARDED_IMAGE, (E2E_BATCH,)))
    first = next(iter(state[0]))
    idec.reset_launches()
    mximage.reset_routes()
    seen = [0]

    def feed():
        try:
            b = next(it)
        except StopIteration:
            it.reset()
            b = next(it)
        seen[0] += 1
        return b

    def step(b):
        check(b.data[0]._data.device.type == CARD,
              "e2e: a batch on %s" % b.data[0]._data.device)
        state[0], state[1], state[2], loss = tr.step(
            *state, b.data[0]._data, b.label[0]._data)
        return loss

    def synced(loss):
        return float(loss), float(state[0][first].reshape(-1)[0])

    for _ in range(2):
        loss = step(feed())
    synced(loss)
    n = 0
    t0 = time.perf_counter()
    for _ in range(E2E_ITERS):
        b = feed()
        loss = step(b)
        n += b.data[0].shape[0] - (b.pad or 0)
    loss_v, _w = synced(loss)
    dt = time.perf_counter() - t0
    img_s = n / dt
    mfu = img_s * flop / BF16_FLOPS
    check(np.isfinite(loss_v), "e2e: loss %r" % loss_v)
    check(mfu <= 1.05, "e2e: %.0f img/s implies MFU %.2f > 1"
          % (img_s, mfu))

    def window():
        for _ in range(E2E_PROFILED):
            step(feed())
    prof = profile_run(torch, window, _resnet_class)
    it.close()
    launches = idec.LAUNCHES["crop_mirror_normalize"]
    routes = dict(mximage.ROUTES)
    check(routes.get("python", 0) == 0 and launches == routes["native"]
          and launches >= seen[0], "e2e: routes %s, crop_mirror_normalize "
          "launched %d times for %d batches consumed"
          % (routes, launches, seen[0]))
    res = {"batch": E2E_BATCH, "dtype": "bfloat16", "timed_steps": E2E_ITERS,
           "img_per_s": img_s, "mfu": mfu, "loss": loss_v,
           "decode_threads": os.cpu_count(), "kernel_launches": launches,
           "batches_consumed": seen[0], "routes": routes,
           "profiled_window": prof}
    log("e2e_train_resnet: ImageRecordIter (nvJPEG, %d threads, resize "
        "256, random crop and mirror) -> ShardedTrainer.step, ResNet-50 "
        "bf16 batch %d: %.1f img/s over %d steps, MFU %.3f; "
        "crop_mirror_normalize %d launches for %d batches consumed "
        "(%s); loss %.4f" % (os.cpu_count(), E2E_BATCH, img_s, E2E_ITERS,
                             mfu, launches, seen[0], routes, loss_v))
    log_profile("e2e profiled window (%d steps)" % E2E_PROFILED, prof)
    return res


def pipeline_phase(torch, mx, fu, rec):
    """Phase 49: ``DataPipeline(RecordBatchSource)`` as ``benchmark.py``'s
    ``data_pipeline`` runs it (batch 128, 3x224x224, resize 224, random
    crop and mirror, python decode in the workers) with 0, 2 and
    ``nproc`` workers, staged on the card: img/s of PIPE_ITERS batches
    after a warm one, every batch on the card, the first PIPE_COMPARED
    batches bitwise equal across the worker counts; then its
    ``_pipeline_train_probe``: the MLP's ``Module.fit`` fed by
    ``DataPipeline(ArrayBatchSource)`` (2 workers, 3 epochs of 24 batches
    of 64), ``sgd_fused_update`` once a step, no input copied by the
    executor."""
    from mxnet_tpu_torch import executor
    dev = _sharded_ctx(mx)
    curve, ref = {}, None
    nproc = os.cpu_count() or 1
    for workers in sorted({0, 2, nproc}):
        src = mx.io.RecordBatchSource(
            rec, SHARDED_IMAGE, PIPE_BATCH, shuffle=True, seed=0,
            aug_kwargs=dict(resize=224, rand_crop=True, rand_mirror=True))
        got = []
        with mx.io.DataPipeline(src, num_workers=workers, prefetch=2,
                                ctx=dev) as pipe:
            b = next(pipe)
            got.append(b)
            n = 0
            t0 = time.perf_counter()
            while n < PIPE_ITERS * PIPE_BATCH:
                try:
                    b = next(pipe)
                except StopIteration:
                    pipe.reset()
                    b = next(pipe)
                if len(got) < PIPE_COMPARED:
                    got.append(b)
                n += b.data[0].shape[0] - (b.pad or 0)
            _sync(torch)
            dt = time.perf_counter() - t0
        check(all(x._data.device.type == CARD
                  for g in got for x in g.data + g.label),
              "data_pipeline: a batch off the card")
        if ref is None:
            ref = got
        else:
            same = all(torch.equal(a._data, c._data)
                       for g, h in zip(got, ref)
                       for a, c in zip(g.data + g.label, h.data + h.label))
            check(same, "data_pipeline: %d workers' stream differs from "
                  "the inline one" % workers)
        curve["workers_%d" % workers] = n / dt
        log("data_pipeline workers=%d: %.1f img/s (batch %d, %d batches "
            "timed, staged on %s)" % (workers, n / dt, PIPE_BATCH,
                                      PIPE_ITERS, got[0].data[0]._data.device))
    del ref, got
    rng = np.random.RandomState(0)
    nb = PROBE["batch"] * PROBE["batches"]
    src = mx.io.ArrayBatchSource(
        rng.randn(nb, 784).astype(np.float32),
        rng.randint(0, 10, (nb,)).astype(np.float32),
        batch_size=PROBE["batch"], shuffle=True, seed=0)
    pipe = mx.io.DataPipeline(src, num_workers=PROBE["workers"], prefetch=2,
                              ctx=dev)
    mod = mx.mod.Module(mx.models.mlp(), context=dev)
    fu.reset_launches()
    executor.INPUT_COPIES["count"] = 0
    t0 = time.perf_counter()
    mod.fit(pipe, num_epoch=PROBE["epochs"], optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            initializer=mx.init.Uniform(0.1))
    _sync(torch)
    fit_s = time.perf_counter() - t0
    steps = PROBE["batches"] * PROBE["epochs"]
    launches = fu.LAUNCHES["sgd_fused_update"]
    check(launches == steps, "pipeline fit: sgd_fused_update launched %d "
          "times for %d steps" % (launches, steps))
    check(executor.INPUT_COPIES["count"] == 0, "pipeline fit: the executor "
          "copied %d inputs (the pipeline stages on the card)"
          % executor.INPUT_COPIES["count"])
    out = mod.get_outputs()[0].asnumpy()
    check(np.isfinite(out).all(), "pipeline fit: outputs not finite")
    log("pipeline fit (MLP Module.fit over DataPipeline(ArrayBatchSource), "
        "%d workers): %d steps in %.2fs (%.1f img/s with the pool's start), "
        "sgd_fused_update %d launches, 0 executor copies"
        % (PROBE["workers"], steps, fit_s, nb * PROBE["epochs"] / fit_s,
           launches))
    return {"img_per_s": curve, "batch": PIPE_BATCH, "host_cpus": nproc,
            "fit": {"steps": steps, "wall_s": fit_s, "launches": launches}}


# ---------------------------------------------------------------------------
# phases 50-52: the update kernel's other rules, bf16 / float16 weights and
# the master mode; low-precision Gluon ResNet-50 training
# ---------------------------------------------------------------------------

# each rule's hypers beside lr, wd, rescale_grad and clip_gradient (step t
# for the bias corrections), and its state counts
def rule_extra(rule, n_state, lr, t):
    b1, b2 = 0.9, 0.999
    if rule in ("sgd", "nag"):
        return {"momentum": 0.9} if n_state else {}
    if rule == "signum":
        return ({"momentum": 0.9, "one_minus_momentum": 0.1,
                 "wdlh_coef": 1.0 - lr * 0.01, "lr_wd": lr * 1e-4}
                if n_state else {})
    if rule == "adam":
        return {"lr": lr * float(np.sqrt(1 - b2 ** t) / (1 - b1 ** t)),
                "beta1": b1, "beta2": b2, "one_minus_beta1": 1 - b1,
                "one_minus_beta2": 1 - b2, "epsilon": 1e-8}
    if rule == "adagrad":
        return {"eps": 1e-7}
    if rule == "rmsprop":
        h = {"gamma1": 0.9, "one_minus_gamma1": 0.1, "epsilon": 1e-8,
             "clip_weights": 0.2}
        if n_state == 3:
            h["gamma2"] = 0.9
        return h
    if rule == "adadelta":
        return {"rho": 0.9, "one_minus_rho": 0.1, "epsilon": 1e-5}
    if rule == "ftrl":
        return {"lamda1": 0.01, "beta": 1.0}
    if rule == "ftml":
        return {"beta1": 0.6, "one_minus_beta1": 0.4, "beta2": b2,
                "one_minus_beta2": 1 - b2, "epsilon": 1e-8,
                "d_coef": (1 - 0.6 ** t) / lr, "v_coef": 1 - b2 ** t}
    if rule == "adamax":
        return {"lr": lr / (1 - b1 ** t), "beta1": b1,
                "one_minus_beta1": 1 - b1, "beta2": b2}
    return {}


# (rule, state count, step)
RULE_VARIANTS = (("sgd", 0, 1), ("sgd", 1, 1), ("nag", 0, 1), ("nag", 1, 1),
                 ("signum", 0, 1), ("signum", 1, 1), ("adam", 2, 1),
                 ("adam", 2, 7), ("adagrad", 1, 1), ("rmsprop", 1, 1),
                 ("rmsprop", 3, 1), ("adadelta", 2, 1), ("ftrl", 2, 1),
                 ("ftml", 3, 1), ("ftml", 3, 7), ("adamax", 2, 1),
                 ("test", 1, 1))
RULE_DTYPES = ("float32", "bfloat16", "float16")
# the master mode (float16 weights, float32 states and master)
MASTER_VARIANTS = (("sgd", 0, 1), ("sgd", 1, 1), ("adam", 2, 1))


def rule_base(torch, shapes, seed):
    """float32 weights, gradients and three states (non-negative: the
    rules' second moments) on the card for every shape."""
    gen = torch.Generator(device=CARD).manual_seed(seed)

    def rnd(shape, scale):
        return torch.randn(shape, generator=gen, device=CARD) * scale

    return {"w": [rnd(s, 0.05) for _, s in shapes],
            "g": [rnd(s, 1.0) for _, s in shapes],
            "s": [[rnd(s, 0.01).abs_() for _, s in shapes]
                  for _ in range(3)]}


def rule_hypers(shapes, rule, n_state, clip, t):
    """Per-tensor hypers as update_inputs gives them (lr and wd differing
    between tensors, wd 0 on biases and betas)."""
    hypers = []
    for i, (name, _) in enumerate(shapes):
        decays = name.endswith("_weight") or name.endswith("_gamma")
        lr = 0.1 * (1 + (i % 7) / 7.0)
        h = {"lr": lr, "wd": 1e-4 * (1 + i % 3) if decays else 0.0,
             "rescale_grad": 1.0 / RESNET_BATCH}
        if rule == "test":
            del h["wd"]
        elif clip:
            h["clip_gradient"] = 0.02
        h.update(rule_extra(rule, n_state, lr, t))
        hypers.append(h)
    return hypers


def rule_run(torch, fu, base, rule, n_state, dtype, master, hypers, plain,
             order=None):
    """Copies of the inputs in ``dtype`` (float32 states and masters in the
    master mode), updated by the kernel or (``plain``) the plain version;
    ``order`` permutes the state tensors given to the call."""
    dt = getattr(torch, dtype)
    sdt = torch.float32 if master else dt
    ws = [w.to(dt, copy=True) for w in base["w"]]
    gs = [g.to(dt, copy=True) for g in base["g"]]
    states = [tuple(base["s"][k][i].to(sdt, copy=True)
                    for k in range(n_state)) for i in range(len(ws))]
    masters = [w.float() for w in ws] if master else None
    given = states if order is None else [tuple(st[k] for k in order)
                                          for st in states]
    fn = getattr(fu, ("_%s_fused" if plain else "%s_fused_update") % rule)
    fn(ws, gs, given, hypers, masters)
    torch.cuda.synchronize()
    return ws, states, masters


def same_bits(torch, a, b):
    """Bitwise equal, a NaN equal to any NaN."""
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return bool(((a.view(ints) == b.view(ints))
                 | (a.isnan() & b.isnan())).all())


def run_diff(torch, a, b):
    """(bitwise equal, max abs difference) of two rule_run results."""
    pairs = list(zip(a[0], b[0])) + [
        (x, y) for sa, sb in zip(a[1], b[1]) for x, y in zip(sa, sb)] + (
        list(zip(a[2], b[2])) if a[2] is not None else [])
    same = all(same_bits(torch, x, y) for x, y in pairs)
    err = max(float((x.float() - y.float()).abs().nan_to_num(0.0).max())
              for x, y in pairs)
    return same, err


def check_rules(torch, mx, fu):
    """Phase 50: every rule of ``fused_update.cu`` against its plain
    version on the card, bitwise, over all 157 ResNet-50 parameter
    shapes: each rule and state count (Adam and FTML at steps 1 and 7)
    x float32 / bf16 / float16 weights x clip on and off, and the master
    mode (float16 weights, float32 states and master) for SGD, SGD with
    momentum and Adam; one launch a call. Then three planted faults that
    must fail: the hyperparameters applied in float32 at bf16 (Python
    scalars, PyTorch's opmath), the master mode writing the weight from
    the pre-update master, and FTML's v and z swapped."""
    shapes = resnet_param_shapes(mx)
    base = rule_base(torch, shapes, 50)
    cases = [(r, n, t, d, False) for r, n, t in RULE_VARIANTS
             for d in RULE_DTYPES] + [(r, n, t, "float16", True)
                                      for r, n, t in MASTER_VARIANTS]
    rows, bad = [], []
    t0 = time.time()
    for rule, n_state, t, dtype, master in cases:
        for clip in (False, True):
            if rule == "test" and clip:
                continue            # Test has no clipping
            hypers = rule_hypers(shapes, rule, n_state, clip, t)
            name = "%s_fused_update" % rule
            n0 = fu.LAUNCHES[name]
            got = rule_run(torch, fu, base, rule, n_state, dtype, master,
                           hypers, False)
            launched = fu.LAUNCHES[name] - n0
            ref = rule_run(torch, fu, base, rule, n_state, dtype, master,
                           hypers, True)
            same, err = run_diff(torch, got, ref)
            rows.append({"rule": rule, "states": n_state, "step": t,
                         "dtype": dtype, "master": master, "clip": clip,
                         "bitwise": same, "max_abs_err": err,
                         "launches": launched})
            if not same or launched != 1:
                bad.append(rows[-1])
            del got, ref
    log("check fused_update rules over %d tensors: %d cases (%d rule "
        "variants x float32/bf16/float16 x clip, master mode for %s) in "
        "%.1fs: %d bitwise and one launch each; %s"
        % (len(shapes), len(rows), len(RULE_VARIANTS),
           ", ".join("%s/%d" % (r, n) for r, n, _ in MASTER_VARIANTS),
           time.time() - t0, len(rows) - len(bad), bad or "none off"))
    check(not bad, "fused_update rules off their plain versions: %s" % bad)
    planted = {}
    # (a) bf16, the hypers as Python floats (float32 opmath) in the plain
    hypers = rule_hypers(shapes, "sgd", 1, False, 1)
    got = rule_run(torch, fu, base, "sgd", 1, "bfloat16", False, hypers,
                   False)
    ws = [w.to(torch.bfloat16) for w in base["w"]]
    gs = [g.to(torch.bfloat16) for g in base["g"]]
    sts = [(s.to(torch.bfloat16),) for s in base["s"][0]]
    for w, g, st, h in zip(ws, gs, sts, hypers):
        w_new, st_new = fu._sgd(w, g, st, h)
        w.copy_(w_new)
        st[0].copy_(st_new[0])
    torch.cuda.synchronize()
    planted["hypers in float32 at bf16"] = run_diff(torch, got,
                                                     (ws, sts, None))
    # (b) master mode, the weight from the pre-update master
    hypers = rule_hypers(shapes, "sgd", 1, False, 1)
    got = rule_run(torch, fu, base, "sgd", 1, "float16", True, hypers, False)
    ref = rule_run(torch, fu, base, "sgd", 1, "float16", True, hypers, True)
    old = [w.to(torch.float16) for w in base["w"]]
    planted["weight from the old master"] = run_diff(torch, got,
                                                      (old,) + ref[1:])
    # (c) FTML's v and z pointers swapped in the kernel's call
    hypers = rule_hypers(shapes, "ftml", 3, False, 1)
    got = rule_run(torch, fu, base, "ftml", 3, "float32", False, hypers,
                   False, order=(0, 2, 1))
    ref = rule_run(torch, fu, base, "ftml", 3, "float32", False, hypers,
                   True)
    planted["FTML's v and z swapped"] = run_diff(torch, got, ref)
    for what, (same, err) in planted.items():
        log("planted fault (%s): bitwise %s, max abs err %.3g"
            % (what, same, err))
        check(not same, "planted fault (%s) passes the bitwise check"
              % what)
    return {"cases": rows, "planted": {k: {"bitwise": v[0],
                                           "max_abs_err": v[1]}
                                       for k, v in planted.items()}}


# phase 51's rows: (label, rule, state count, dtype, master, operations
# a value counted from the kernel's rule)
RULE_TIMED = (("sgd bf16", "sgd", 1, "bfloat16", False, 7),
              ("sgd float16 master", "sgd", 1, "float16", True, 7),
              ("nag", "nag", 1, "float32", False, 9),
              ("signum", "signum", 1, "float32", False, 10),
              ("adagrad", "adagrad", 1, "float32", False, 10),
              ("rmsprop", "rmsprop", 1, "float32", False, 12),
              ("adadelta", "adadelta", 2, "float32", False, 18),
              ("ftrl", "ftrl", 2, "float32", False, 19),
              ("ftml", "ftml", 3, "float32", False, 20),
              ("adamax", "adamax", 2, "float32", False, 12),
              ("test", "test", 1, "float32", False, 4))


def rule_bytes(n_state, dtype, master, n):
    """Bytes a call must move: each input read once, each output written
    once. The weight is not read in the master mode."""
    item = {"float32": 4, "bfloat16": 2, "float16": 2}[dtype]
    if master:      # g read; states and master read and written; w written
        return n * (item + 2 * 4 * n_state + 2 * 4 + item)
    return n * item * (2 + 2 * n_state + 1)


def time_rules(torch, mx, fu, timer):
    """Phase 51: each RULE_TIMED row over the whole ResNet-50 parameter
    list (25.55M values), L2 flushed before every launch (a 2 ms hold
    before each, as phase 12), beside its bound, the plain version, the
    wrapper's host ms and a PyTorch call where one computes the rule:
    ``torch._fused_sgd_`` on the same bf16 tensors for bf16 SGD (its
    arithmetic in float32 with one rounding at the end: the same bytes,
    not the same function) and ``torch._fused_sgd_(nesterov=True)`` for
    NAG (float32; it may contract multiply-adds); otherwise null."""
    shapes = resnet_param_shapes(mx)
    n = sum(int(np.prod(s)) for _, s in shapes)
    base = rule_base(torch, shapes, 51)
    rows = []
    for label, rule, n_state, dtype, master, ops in RULE_TIMED:
        hypers = rule_hypers(shapes, rule, n_state, False, 1)
        got = rule_run(torch, fu, base, rule, n_state, dtype, master,
                       hypers, False)
        ref = rule_run(torch, fu, base, rule, n_state, dtype, master,
                       hypers, True)
        _, err = run_diff(torch, got, ref)
        ws, states, masters = got
        del ref
        gs = [g.to(getattr(torch, dtype), copy=True) for g in base["g"]]
        kernel = getattr(fu, "%s_fused_update" % rule)
        plain = getattr(fu, "_%s_fused" % rule)
        lib = None
        if rule == "sgd" and not master:
            lib = lambda: torch._fused_sgd_(   # noqa: E731
                ws, gs, [s[0] for s in states], weight_decay=1e-4,
                momentum=0.9, lr=0.1, dampening=0.0, nesterov=False,
                maximize=False, is_first_step=False)
        elif rule == "nag":
            lib = lambda: torch._fused_sgd_(   # noqa: E731
                ws, gs, [s[0] for s in states], weight_decay=1e-4,
                momentum=0.9, lr=0.1, dampening=0.0, nesterov=True,
                maximize=False, is_first_step=False)

        def fn():
            kernel(ws, gs, states, hypers, masters)

        def fn_plain():
            plain(ws, gs, states, hypers, masters)

        nbytes = rule_bytes(n_state, dtype, master, n)
        t_bytes, t_ops = nbytes / HBM_BPS, ops * n / F32_FLOPS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        rows.append({
            "name": "%s_fused_update" % rule, "label": label,
            "shape": "ResNet-50: 157 tensors, %d values, %s%s"
                     % (n, dtype, ", float32 master" if master else ""),
            "ms": timer(fn, hold_ms=2.0), "plain_ms": timer(fn_plain,
                                                            iters=5),
            "library_ms": timer(lib, hold_ms=2.0) if lib else None,
            "host_ms": host_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "max_abs_err": err})
        del ws, gs, states, masters, got
    for r in rows:
        log("time %-22s %-18s ms=%.4f plain_ms=%.3f library_ms=%s "
            "bound_ms=%.4f (%s, %.0f%% of it) %.0f GB/s host_ms=%.3f "
            "max_abs_err=%.3g" % (
                r["name"], r["label"], r["ms"], r["plain_ms"],
                "%.4f" % r["library_ms"] if r["library_ms"] else "null",
                r["bound_ms"], r["bound_by"],
                100 * r["bound_ms"] / r["ms"],
                r["bytes"] / (r["ms"] * 1e-3) / 1e9, r["host_ms"],
                r["max_abs_err"]))
    return rows


LOWP_BATCH = 64         # phase 52: bf16 / float16 Gluon ResNet-50
LOWP_WARM, LOWP_TIMED = 8, 24
BF16_RATIO_TOL = 1.5    # the card's bf16 error against float64 at most
                        # this times the CPU's own bf16 error (the ratio
                        # tests/test_torch_trainer.py holds bf16 steps to)
BF16_GRAD_TOL = 1.15    # the same for each group of gradients: a sound
                        # card run reads 0.99-1.02 of the CPU in every
                        # group, gamma's gradient x2 1.42 (PERF.md)
LOWP_PLANT = 2.0        # the planted BatchNorm gamma-gradient factor
CLI_NAG_BATCHES = 16


class _UpdateSpy(object):
    """Records each call of a fused-update wrapper: the weights' and
    states' types and how many tensors had a master. With ``plain`` (the
    wrapper's plain version), each call's inputs are also cloned and
    updated by ``plain``, and the kernel's weights, states and masters
    held against those bitwise (``self.held``: one row a call)."""

    def __init__(self, fu, name, torch=None, plain=None):
        self.fu, self.name, self.torch, self.plain = fu, name, torch, plain
        self.real = getattr(fu, name)
        self.calls, self.held = [], []

    def __enter__(self):
        real = self.real

        def spy(ws, gs, states, hypers, masters=None):
            self.calls.append({
                "weights": sorted({str(w.dtype) for w in ws}),
                "states": sorted({str(t.dtype) for st in states
                                  for t in st}),
                "masters": sum(m is not None for m in masters or ())})
            if self.plain is None:
                return real(ws, gs, states, hypers, masters)
            cw = [w.clone() for w in ws]
            cs = [tuple(t.clone() for t in st) for st in states]
            cm = None if masters is None else [
                None if m is None else m.clone() for m in masters]
            real(ws, gs, states, hypers, masters)
            self.plain(cw, gs, cs, hypers, cm)
            self.torch.cuda.synchronize()
            pairs = list(zip(ws, cw)) + [
                (a, b) for sa, sb in zip(states, cs)
                for a, b in zip(sa, sb)] + [
                (a, b) for a, b in zip(masters or (), cm or ())
                if a is not None]
            kinds = {}
            for w, m in zip(ws, masters or [None] * len(ws)):
                k = str(w.dtype)[6:] + (" + master" if m is not None
                                        else "")
                kinds[k] = kinds.get(k, 0) + 1
            self.held.append({
                "tensors": kinds, "compared": len(pairs),
                "values": sum(w.numel() for w in ws),
                "bitwise": all(same_bits(self.torch, a, b)
                               for a, b in pairs),
                "max_abs_err": max(float((a.float() - b.float()).abs()
                                         .nan_to_num(0.0).max())
                                   for a, b in pairs)})

        setattr(self.fu, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.fu, self.name, self.real)


def lowp_net(torch, mx, dtype, prefix, seed=52):
    mx.random.seed(seed)
    net = mx.gluon.model_zoo.vision.get_model("resnet50_v1", classes=1000,
                                              prefix=prefix)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mx.gpu(0))
    net.cast(dtype)
    net.hybridize()
    return net


def lowp_fit(torch, mx, fu, dtype, multi_precision, windows, flop,
             keep=False):
    """One low-precision run of phase 52: the zoo's resnet50_v1 cast to
    ``dtype`` and hybridized, batch LOWP_BATCH of ``dtype`` 3x224x224,
    ``Trainer("sgd", lr 0.1, momentum 0.9, wd 1e-4[, multi_precision])``;
    LOWP_WARM warm steps, then ``windows`` timed windows of LOWP_TIMED
    (host clock, synchronized at both ends), one profiled step; the
    update one ``sgd_fused_update`` launch a step and never its plain
    version, every call's weight and state types recorded."""
    rng = np.random.RandomState(52)
    x = mx.nd.array(rng.uniform(-1, 1, (LOWP_BATCH, 3, 224, 224)).astype(
        np.float32), ctx=mx.gpu(0)).astype(dtype)
    y = mx.nd.array(rng.randint(0, 1000, (LOWP_BATCH,)).astype(np.float32),
                    ctx=mx.gpu(0))
    net = lowp_net(torch, mx, dtype, "g52%s_" % dtype[:4])
    opt = dict(GLUON_OPT)
    if multi_precision:
        opt["multi_precision"] = True
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", opt)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def run(steps):
        for _ in range(steps):
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(LOWP_BATCH)
        return loss

    plain_calls = [0]
    real_plain = fu._sgd_fused

    def plain_spy(*args):
        plain_calls[0] += 1
        return real_plain(*args)

    fu._sgd_fused = plain_spy
    res = {"dtype": dtype, "multi_precision": multi_precision,
           "batch": LOWP_BATCH, "windows": []}
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run(LOWP_WARM)
        torch.cuda.synchronize()
        res["warm_s"] = time.perf_counter() - t0
        for _ in range(windows):
            fu.reset_launches()
            with _UpdateSpy(fu, "sgd_fused_update") as spy:
                t0 = time.perf_counter()
                loss = run(LOWP_TIMED)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            img_s = LOWP_BATCH * LOWP_TIMED / dt
            res["windows"].append({
                "s": dt, "img_per_s": img_s,
                "ms_per_step": dt * 1e3 / LOWP_TIMED,
                "mfu": img_s * flop / BF16_FLOPS,
                "launches": fu.LAUNCHES["sgd_fused_update"],
                "calls": spy.calls,
                "loss_mean": float(loss._data.detach().float().mean())})
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # one step's launch, its whole mixed table, against the plain rule
        with _UpdateSpy(fu, "sgd_fused_update", torch, real_plain) as spy:
            run(1)
        res["held"] = spy.held
        fu.reset_launches()
        res["profiled_step"] = profile_run(torch, lambda: run(1),
                                           _resnet_class)
        res["profiled_launches"] = fu.LAUNCHES["sgd_fused_update"]
    finally:
        fu._sgd_fused = real_plain
    res["plain_calls"] = plain_calls[0]
    params = net.collect_params()
    n_trained = sum(p.grad_req != "null" for p in params.values())
    for w in res["windows"]:
        check(w["launches"] == LOWP_TIMED and len(w["calls"]) == LOWP_TIMED,
              "%s gluon: sgd_fused_update launched %d times (%d calls) in "
              "%d steps" % (dtype, w["launches"], len(w["calls"]),
                            LOWP_TIMED))
        want_w = sorted({"torch." + dtype, "torch.float32"})
        check(all(c["weights"] == want_w for c in w["calls"]),
              "%s gluon: update calls on %s" % (dtype, w["calls"][:1]))
        if multi_precision:
            check(all(c["masters"] > 0 and c["states"] == ["torch.float32"]
                      for c in w["calls"]),
                  "%s gluon: not the master mode: %s" % (dtype,
                                                         w["calls"][:1]))
        else:
            check(all(c["states"] == want_w for c in w["calls"]),
                  "%s gluon: states %s" % (dtype, w["calls"][:1]))
        check(np.isfinite(w["loss_mean"]) and w["mfu"] <= 1.05,
              "%s gluon: loss %s, MFU %.3f" % (dtype, w["loss_mean"],
                                               w["mfu"]))
    check(res["plain_calls"] == 0, "%s gluon: the plain SGD rule ran %d "
          "times" % (dtype, res["plain_calls"]))
    check(len(res["held"]) == 1 and res["held"][0]["bitwise"],
          "%s gluon: a step's sgd_fused_update off its plain version: %s"
          % (dtype, res["held"]))
    log("%s gluon: one step's sgd_fused_update held against _sgd_fused on "
        "clones of its inputs: %s" % (dtype, res["held"]))
    check(res["profiled_launches"] == 1, "%s gluon: the profiled step "
          "launched sgd_fused_update %d times"
          % (dtype, res["profiled_launches"]))
    masters = res["windows"][0]["calls"][0]["masters"]
    res.update(params_trained=n_trained, masters=masters,
               img_per_s=float(np.mean([w["img_per_s"]
                                        for w in res["windows"]])))
    res["mfu"] = res["img_per_s"] * flop / BF16_FLOPS
    for w in res["windows"]:
        del w["calls"]
    prof = res["profiled_step"]
    log("gluon resnet50_v1 %s%s batch %d: windows %s; MFU %.4f (%.2f "
        "GFLOP/img, 989 TFLOP/s bf16 peak); peak %.2f GB; %d trained "
        "tensors, one sgd_fused_update a step (%d on master copies); "
        "profiled step: wall %.3fs, device busy %s, host launches %s"
        % (dtype, " multi_precision" if multi_precision else "",
           LOWP_BATCH, ", ".join("%.1f img/s %.2f ms" % (
               w["img_per_s"], w["ms_per_step"]) for w in res["windows"]),
           res["mfu"], flop / 1e9, res["peak_gb"], n_trained, masters,
           prof["wall_s"], "not measured" if prof["busy_share"] is None
           else "%.1f%%" % (100 * prof["busy_share"]),
           prof["host_launches"]))
    if keep:
        res["kept"] = (net, x, y)
    return res


# the other rules on phase 52's bf16 net: (optimizer, its arguments).
# Adamax divides by u = max(beta2 u, |g|), 0 where a gradient is 0 (the
# conv biases before a BatchNorm, and bf16 gradients that are 0): NaN
# there after its first step, in both packages, so a NaN loss at its
# second
OTHER_RULES = (("signum", {"momentum": 0.9}), ("adagrad", {}),
               ("rmsprop", {}), ("rmsprop", {"centered": True}),
               ("adadelta", {}), ("ftrl", {}), ("ftml", {}), ("test", {}),
               ("adam", {}), ("adamax", {}))
OTHER_STEPS = 2


def other_rules(torch, mx, fu, net, x, y):
    """Phase 52: each other optimizer with a fused rule takes OTHER_STEPS
    Trainer steps of the bf16 net (learning rate 1e-4), each from the
    state the bf16 run left (parameters and running statistics restored
    in place before every rule): one launch of its kernel a step, none of
    any other; the first step's loss the same for every rule (the same
    state, the same batch), every loss finite. Adamax's NaN after its
    first step must lie only in values whose gradient was 0, and its
    second loss is not held."""
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = net.collect_params()
    saved = {k: p.data()._data.clone() for k, p in params.items()}
    res = {}
    for name, kw in OTHER_RULES:
        tag = name + ("_centered" if kw.get("centered") else "")
        with torch.no_grad():
            for k, p in params.items():
                p.data()._data.copy_(saved[k])
        trainer = mx.gluon.Trainer(params, name,
                                   dict(kw, learning_rate=1e-4))
        fu.reset_launches()
        losses, bad, off = [], 0, 0
        for step in range(OTHER_STEPS):
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(x.shape[0])
            losses.append(float(loss._data.detach().float().mean()))
            for p in params.values() if step == 0 else ():
                if p.grad_req != "null":
                    nan = ~p.data()._data.isfinite()
                    bad += int(nan.sum())
                    off += int((nan & (p.grad()._data != 0)).sum())
        torch.cuda.synchronize()
        launched = {k: v for k, v in fu.LAUNCHES.items() if v}
        kernel = "%s_fused_update" % name
        check(launched == {kernel: OTHER_STEPS}, "gluon bf16 %s: launches "
              "%s in %d steps" % (tag, launched, OTHER_STEPS))
        held = losses if name != "adamax" else losses[:1]
        check(np.isfinite(held).all(), "gluon bf16 %s: losses %s"
              % (tag, losses))
        check(off == 0 if name == "adamax" else bad == 0, "gluon bf16 %s: "
              "%d values non-finite after one step, %d where the gradient "
              "was not 0" % (tag, bad, off))
        res[tag] = {"launches": launched.get(kernel, 0), "losses": losses,
                    "non_finite_after_1": bad}
    first = [v["losses"][0] for v in res.values()]
    check(max(first) - min(first) <= 1e-3 * abs(first[0]),
          "gluon bf16 other rules: first losses %s differ (not one state)"
          % first)
    log("gluon resnet50_v1 bf16, %d Trainer steps each from one state "
        "(first loss %.4f): %s" % (OTHER_STEPS, first[0], ", ".join(
            "%s %d launches (loss %s%s)" % (
                k, v["launches"], " -> ".join("%.4f" % l
                                              for l in v["losses"]),
                "; %d values NaN after step 1" % v["non_finite_after_1"]
                if v["non_finite_after_1"] else "")
            for k, v in res.items())))
    return res


def bf16_misses(side, cpu):
    """The keys in which ``side``'s bf16 errors against the float64
    witness exceed BF16_RATIO_TOL times the CPU's own bf16 errors
    (BF16_GRAD_TOL for the gradient groups, ``g_*``)."""
    return ["%s %.3g > %g x the CPU's %.3g" % (k, side[k], tol, cpu[k])
            for k in sorted(side)
            for tol in (BF16_GRAD_TOL if k.startswith("g_")
                        else BF16_RATIO_TOL,)
            if side[k] > tol * cpu[k]]


def grad_rel(got, wit, keys):
    """||gradient - the witness's|| / ||the witness's|| over every tensor
    of ``keys`` together."""
    d = np.concatenate([got[k].ravel() for k in keys])
    w = np.concatenate([wit[k].ravel() for k in keys])
    return float(np.linalg.norm(d - w) / max(np.linalg.norm(w), 1e-30))


def group_rel(new, wit, start, keys):
    """||change - the witness's change|| / ||the witness's change|| over
    every tensor of ``keys`` together."""
    d = np.concatenate([(new[k] - start[k]).ravel() for k in keys])
    w = np.concatenate([(wit[k] - start[k]).ravel() for k in keys])
    return float(np.linalg.norm(d - w) / max(np.linalg.norm(w), 1e-30))


def lowp_vs_cpu(torch, mx, fu, batch=2):
    """Phase 52's check: one bf16 ``Trainer`` step of resnet50_v1 at batch
    2 from one state on the card (hybridized) and on the CPU, and in
    float64 on the CPU (the witness, phase 23's). The card's errors
    against the witness (outputs; the change of the bf16 weights, of the
    float32 BatchNorm gamma and beta, of the moving statistics, each as
    one relative norm over its group) within BF16_RATIO_TOL times the
    CPU's own; the gradients, taken before the update, by depth (the
    classifier, each stage, the stem; BatchNorm's gamma and beta) within
    BF16_GRAD_TOL times the CPU's. At this initial state the backward
    amplifies bf16's rounding with depth: the classifier's gradient is
    ~9% off the witness's, the stages' ~130% (uncorrelated: cosine
    ~0.14 at the stem) on the card and the CPU alike, and so is the
    update. The planted fault, BatchNorm's gamma gradient LOWP_PLANT
    times the sound one, must miss."""
    from mxnet_tpu_torch.ops import registry as reg
    rng = np.random.RandomState(52)
    x = rng.uniform(-1, 1, (batch, 3, 224, 224)).astype(np.float32)
    y = rng.randint(0, 1000, (batch,)).astype(np.float32)
    mx.random.seed(52)
    init = mx.gluon.model_zoo.vision.get_model("resnet50_v1", classes=1000,
                                               prefix="g23_")
    init.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2), ctx=mx.cpu())
    with mx.autograd.predict_mode():
        init(mx.nd.array(x, ctx=mx.cpu()))
    # every side starts from the bf16 values (BatchNorm's stay float32)
    state = {k: (v if "batchnorm" in k else torch.from_numpy(v).to(
        torch.bfloat16).float().numpy())
        for k, v in mx.convert.gluon_params_to_numpy(init).items()}
    del init
    sides = {"witness": _GluonSide(torch, mx, fu, state, x, y, mx.cpu(),
                                   "float64"),
             "cpu": _GluonSide(torch, mx, fu, state, x, y, mx.cpu(),
                               "bfloat16"),
             "dev": _GluonSide(torch, mx, fu, state, x, y, mx.gpu(0),
                               "bfloat16", hybridize=True),
             "planted": _GluonSide(torch, mx, fu, state, x, y, mx.gpu(0),
                                   "bfloat16", hybridize=True)}
    start = {k: v.astype(np.float64) for k, v in state.items()}
    zero_grad = re.compile(r"conv2d\d+_bias$")     # see phase 23
    groups = {"dw_bf16": [k for k in state if "batchnorm" not in k
                          and not zero_grad.search(k)],
              "dw_f32": [k for k in state if "batchnorm" in k
                         and "running" not in k],
              "ds": [k for k in state if "running" in k]}
    bn = reg.get_op("BatchNorm")
    sound = bn.fn
    graded = groups["dw_bf16"] + groups["dw_f32"]
    # the gradients by depth (the classifier, then each stage down to the
    # stem: bf16's rounding is amplified on the way down), and BatchNorm's
    # gamma and beta together
    stages = {"g_%s" % st: [k for k in graded if st in k]
              for st in ("dense0", "stage4", "stage3", "stage2", "stage1")}
    stages["g_stem"] = [k for k in graded if "stage" not in k
                        and "dense0" not in k]
    stages["g_bn"] = groups["dw_f32"]
    o_w, a_w, s_w = sides["witness"].step(graded)
    g_w = sides["witness"].grads
    a_w.update(s_w)
    row = {}
    for side in ("cpu", "dev", "planted"):
        fu.reset_launches()
        if side == "planted":
            bn.fn = gamma_grad_scaled(torch, sound, LOWP_PLANT)
        try:
            out, a, s = sides[side].step(graded)
        finally:
            bn.fn = sound
        check(side == "cpu" or fu.LAUNCHES["sgd_fused_update"] == 1,
              "bf16 gluon vs cpu: %d launches in one %s step"
              % (fu.LAUNCHES["sgd_fused_update"], side))
        check(np.isfinite(out).all() and out.shape == (batch, 1000),
              "bf16 gluon vs cpu: %s outputs %s" % (side, out.shape))
        a.update(s)
        row[side] = {"out_rel": rel_rms(out, o_w)}
        row[side].update((g, grad_rel(sides[side].grads, g_w, keys))
                         for g, keys in stages.items())
        sides[side].grads = None
        row[side].update((g, group_rel(a, a_w, start, keys))
                         for g, keys in groups.items())
    misses = bf16_misses(row["dev"], row["cpu"])
    planted = bf16_misses(row["planted"], row["cpu"])
    order = ["out_rel"] + list(stages) + list(groups)
    log("bf16 gluon vs f64 (batch %d, one step; relative norms: %s): %s; "
        "the planted gamma-gradient fault (x%g) misses %s"
        % (batch, " / ".join(order), "; ".join(
            "%s %s" % (k, " / ".join("%.3e" % r[c] for c in order))
            for k, r in row.items()), LOWP_PLANT, planted or "nothing"))
    check(not misses, "bf16 gluon vs f64: the card is off: %s"
          % "; ".join(misses))
    check(planted, "bf16 gluon vs f64: the planted BatchNorm fault passes")
    row["planted_misses"] = planted
    return row


def cli_nag(torch, mx, fu):
    """Phase 52's CLI run: ``train_imagenet.main(--network resnet
    --num-layers 50 --optimizer nag --benchmark 1)`` for CLI_NAG_BATCHES
    batches: one ``nag_fused_update`` launch a step (none of
    ``sgd_fused_update``), its plain version never, finite outputs."""
    from mxnet_tpu_torch.examples import train_imagenet
    plain_calls = [0]
    real_plain = fu._nag_fused

    def spy(*args):
        plain_calls[0] += 1
        return real_plain(*args)

    fu.reset_launches()
    fu._nag_fused = spy
    try:
        with LogLines() as logs:
            t0 = time.perf_counter()
            mod = train_imagenet.main(cli_args(
                "--optimizer", "nag", "--benchmark", "1", "--num-epochs",
                "1", "--max-batches", str(CLI_NAG_BATCHES)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        fu._nag_fused = real_plain
    launches = dict(fu.LAUNCHES)
    check(launches["nag_fused_update"] == CLI_NAG_BATCHES
          and launches["sgd_fused_update"] == 0,
          "CLI nag: launches %s for %d steps" % (launches, CLI_NAG_BATCHES))
    check(plain_calls[0] == 0, "CLI nag: the plain NAG rule ran")
    out = mod.get_outputs()[0].asnumpy()
    check(np.isfinite(out).all(), "CLI nag: non-finite outputs")
    speeds = logs.speeds(0)
    del mod
    res = {"wall_s": wall, "launches": launches["nag_fused_update"],
           "speedometer": speeds}
    log("cli --optimizer nag --benchmark 1: %d steps in %.2fs; Speedometer "
        "img/s %s; nag_fused_update %d launches"
        % (CLI_NAG_BATCHES, wall, [round(v, 1) for v in speeds],
           res["launches"]))
    return res


def gluon_lowp(torch, mx, fu):
    """Phase 52: low-precision Gluon ResNet-50 v1 training on the card:
    bf16 (two timed windows), the other optimizers' rules on that net,
    float16 with ``multi_precision`` (one window), the batch-2 bf16 step
    against the CPU and float64, and the CLI with ``--optimizer nag``."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    probe = mx.gluon.model_zoo.vision.get_model("resnet50_v1", classes=1000,
                                                prefix="g52p_")
    probe.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    flop, _ = gluon_flops(mx, probe)
    del probe
    res = {"train_flop_per_img": flop,
           "bf16": lowp_fit(torch, mx, fu, "bfloat16", False, 2, flop,
                            keep=True)}
    res["other_rules"] = other_rules(torch, mx, fu,
                                     *res["bf16"].pop("kept"))
    res["float16_multi_precision"] = lowp_fit(torch, mx, fu, "float16",
                                              True, 1, flop)
    res["bf16_vs_cpu"] = lowp_vs_cpu(torch, mx, fu)
    res["cli_nag"] = cli_nag(torch, mx, fu)
    return res


# ---------------------------------------------------------------------------
# phases 53-54: the serving front and its observability
# ---------------------------------------------------------------------------

HTTP_SHADOW = 0.25      # phase 53: the canary's mirrored fraction
HTTP_MIRRORS = 8        # mirrored requests before the int8 flip
HTTP_CANARY_CLIENTS = 2     # closed-loop clients across the canary, swap
                            # and rollback: each /predict parses ~3 MB of
                            # JSON under the GIL that the swap's engine
                            # build needs, so more clients slow the swap
HTTP_CANARY_REQUESTS = 16   # answered requests after the flip, and again
                            # after the rollback
HTTP_TRACED = 24        # /predict requests whose traces are read back
HTTP_OUT_TOL = 1e-5     # /predict vs the direct predictor, fp32
HTTP_LOGIT_STD = 2.5    # the /predict set's images are scaled so that the
                        # log-probabilities' spread a row is this: at unit
                        # input the seeded weights' logits reach ~1e3 and
                        # the softmax is one-hot. The network is linear in
                        # its input's scale (its biases and BatchNorm
                        # shifts are 0, its statistics the initial ones)
HTTP_APART = 100        # every two images' direct answers differ by more
                        # than this many HTTP_OUT_TOL: a swapped or
                        # misplaced row of a coalesced batch shows
HTTP_TRACE_ROUNDS = (1.0, 0.0, 0.0, 1.0, 1.0, 0.0)  # trace sampling a round
HTTP_DISCONNECT_NEW = 64    # the hung-up stream's max_new_tokens
HTTP_TIMEOUT = 300          # every client wait, seconds
HTTP_DEADLINE_MS = 60000    # a /predict's deadline: handler threads parse
                            # ~3 MB of JSON an image under the GIL the
                            # engine's worker needs, so the default 2 s
                            # (MXNET_SERVE_DEADLINE_MS) expires queued
                            # requests at 16 clients
HEALTH_ROUNDS = 6       # phase 54: rounds a configuration, the order
                        # reversed every other round (after a warm one)
HEALTH_STEPS = 12       # timed fit steps a round (after 2 warm ones)
HEALTH_BUDGET = 0.02    # the JAX package's health_overhead promise (step),
                        # enforced as it does: above max(budget, twice the
                        # noise floor "off2", the "off" step re-measured)
HEALTH_PIPE_ROWS = 512  # phase 54's DataPipeline-fed fit: 8 batches of 64


def _http(port, method, path, body=None, headers=None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


_PREDICT_BODIES = {}     # rows' bytes -> their /predict body


def _http_predict(port, rows, rid=None):
    """(status, outputs or the error body) of one /predict, with a
    deadline of HTTP_DEADLINE_MS. The JSON body of an image is ~3 MB:
    the clients share the server's process (and GIL), so each body is
    encoded once."""
    key = rows.tobytes()
    body = _PREDICT_BODIES.get(key)
    if body is None:
        body = _PREDICT_BODIES[key] = json.dumps(
            {"inputs": {"data": rows.tolist()},
             "timeout_ms": HTTP_DEADLINE_MS}).encode()
    st, _, body = _http(port, "POST", "/predict", body,
                        {"X-Request-Id": rid} if rid else None)
    if st != 200:
        return st, body
    return st, np.asarray(json.loads(body)["outputs"][0], np.float32)


def _http_stream(port, prompt, max_new, out, i):
    """One streaming /generate: its token lines as they arrive, with the
    time of each (``out[i]``: tokens, times, the final line, status)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/generate", json.dumps(
            {"prompt": [int(t) for t in prompt],
             "max_new_tokens": int(max_new)}).encode(),
            {"X-Request-Id": "gen-%d-%d" % (i, int(t0 * 1e6) % 10 ** 9)})
        r = conn.getresponse()
        toks, times, last = [], [], None
        while True:
            line = r.readline()
            if not line:
                break
            msg = json.loads(line)
            if "token" in msg:
                toks.append(msg["token"])
                times.append(time.perf_counter() - t0)
            else:
                last = msg
        out[i] = {"status": r.status, "tokens": toks, "times": times,
                  "last": last, "rid": r.getheader("X-Request-Id")}
    except Exception as e:          # noqa: BLE001 (reported, fatal)
        out[i] = {"error": repr(e)}
    finally:
        conn.close()


def http_generate_round(port, reqs, vocab):
    """The mix as concurrent streaming clients: every stream complete and
    well formed; tokens/s over the round's wall, TTFT and ITL."""
    import threading
    out = [None] * len(reqs)
    threads = [threading.Thread(target=_http_stream,
                                args=(port, p, m, out, i))
               for i, (p, m) in enumerate(reqs)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(HTTP_TIMEOUT)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a /generate client hung")
    for (p, m), o in zip(reqs, out):
        check("error" not in o, "a /generate stream failed: %s" % o)
        check(o["status"] == 200 and o["last"] == {"done": True, "n": m}
              and len(o["tokens"]) == m
              and all(0 <= t < vocab for t in o["tokens"]),
              "a /generate stream is incomplete or malformed: status %s, "
              "%d of %d tokens, last line %s"
              % (o["status"], len(o["tokens"]), m, o["last"]))
    tokens = sum(len(o["tokens"]) for o in out)
    itl = [(o["times"][-1] - o["times"][0]) / (len(o["times"]) - 1)
           for o in out if len(o["times"]) > 1]
    ttft = [o["times"][0] for o in out]
    return {"requests": len(reqs), "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
            "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3,
            "itl_p50_ms": float(np.percentile(itl, 50)) * 1e3,
            "rids": [o["rid"] for o in out]}


def http_predict_set(port, pool, direct, tag):
    """serve_traffic's correctness set over HTTP: 64 one-image requests
    from SERVE_CLIENTS threads and 4 of 4 rows, each answer within
    HTTP_OUT_TOL of the direct predictor's rows."""
    import threading
    out, errors = {}, []
    lock = threading.Lock()

    def client(t):
        try:
            jobs = [((t + 3 * j) % SERVE_IMAGES,) for j in range(4)]
            if t < 4:
                jobs.append(tuple(range(4 * t, 4 * t + 4)))
            for j, idx in enumerate(jobs):
                st, res = _http_predict(port, pool[list(idx)],
                                        "%s-%d-%d" % (tag, t, j))
                with lock:
                    if st != 200:
                        errors.append((st, res[:200]))
                    else:
                        out[(t, j)] = (idx, res)
        except Exception as e:          # noqa: BLE001 (reported, fatal)
            with lock:
                errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(HTTP_TIMEOUT)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a /predict client hung")
    check(not errors, "/predict failed: %s" % errors[:3])
    check(len(out) == 68, "%d of 68 /predict requests answered" % len(out))
    err = 0.0
    for idx, res in out.values():
        err = max(err, float(np.abs(res - np.stack(
            [direct[i] for i in idx])).max()))
    check(err <= HTTP_OUT_TOL, "/predict differs from the direct predictor "
          "by %.3g > %g" % (err, HTTP_OUT_TOL))
    lerr = max(float(np.abs(np.log(res) - np.log(np.stack(
        [direct[i] for i in idx]))).max()) for idx, res in out.values())
    images = sum(len(v[0]) for v in out.values())
    return {"requests": len(out), "images": images, "wall_s": wall,
            "img_per_s": images / wall, "max_abs_err": err,
            "max_log_prob_err": lerr}


def spread_images(engine, pool):
    """``pool`` scaled so that the direct answers' log-probabilities
    spread by HTTP_LOGIT_STD a row, and those answers: every probability
    above 0, none above 0.5, and every two images' answers more than
    HTTP_APART x HTTP_OUT_TOL apart, so that the /predict set's tolerance
    sees a row that went to another request."""
    def answers(x):
        return np.stack([engine.predict(x[i:i + 1])[0][0]
                         for i in range(len(x))])
    scale = 1e-3                    # logits ~1: nothing underflows
    std = float(np.log(answers(pool * scale)).std(axis=1).mean())
    scale *= HTTP_LOGIT_STD / std
    x = (pool * scale).astype(np.float32)
    rows = answers(x)
    apart = min(float(np.abs(rows[i] - rows[j]).max())
                for i in range(len(rows)) for j in range(i))
    check(rows.min() > 0 and rows.max() <= 0.5
          and apart > HTTP_APART * HTTP_OUT_TOL,
          "the /predict set's answers are saturated or alike: probabilities"
          " in [%.3g, %.3g], two images' answers %.3g apart"
          % (rows.min(), rows.max(), apart))
    return x, dict(enumerate(rows)), {
        "scale": scale, "p_min": float(rows.min()),
        "p_max": float(rows.max()), "apart": apart}


class _Traffic(object):
    """Closed-loop /predict clients (one image a request) until stopped:
    every answer's status counted, the int8 answers kept by image."""

    def __init__(self, port, pool, clients=SERVE_CLIENTS):
        import threading
        self.port, self.pool = port, pool
        self.codes, self.errors, self.answers = {}, [], []
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self._client, args=(t,))
                        for t in range(clients)]
        for t in self.threads:
            t.start()

    def _client(self, t):
        j = 0
        while not self.stop.is_set():
            i = (t + 3 * j) % SERVE_IMAGES
            try:
                st, res = _http_predict(self.port, self.pool[i:i + 1])
            except Exception as e:      # noqa: BLE001 (reported, fatal)
                with self.lock:
                    self.errors.append(repr(e))
                return
            with self.lock:
                self.codes[st] = self.codes.get(st, 0) + 1
                if st == 200:
                    self.answers.append((i, res))
            j += 1

    def count(self):
        with self.lock:
            return sum(self.codes.values())

    def finish(self):
        self.stop.set()
        for t in self.threads:
            t.join(HTTP_TIMEOUT)
        check(not any(t.is_alive() for t in self.threads),
              "a traffic client hung")
        return dict(self.codes)


def _wait(cond, what, timeout=HTTP_TIMEOUT):
    t_end = time.perf_counter() + timeout
    while not cond():
        check(time.perf_counter() < t_end, "timed out waiting for %s" % what)
        time.sleep(0.01)


def parse_prometheus(text):
    """{(name, ((label, value), ...)): float} of a 0.0.4 exposition;
    fails on a line it cannot parse."""
    out = {}
    pat = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
    lab = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = pat.match(line)
        check(m is not None, "/metrics: unparsable line %r" % line)
        labels = tuple(lab.findall(m.group(3) or ""))
        out[(m.group(1), labels)] = float(m.group(4))
    return out


def _disconnect(port, prompt, max_new):
    """A streaming /generate hung up (reset) after its first token."""
    import socket
    import struct
    s = socket.create_connection(("127.0.0.1", port), timeout=HTTP_TIMEOUT)
    body = json.dumps({"prompt": [int(t) for t in prompt],
                       "max_new_tokens": int(max_new)}).encode()
    s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\nContent-Length: %d"
              b"\r\n\r\n" % len(body) + body)
    got = b""
    while b'{"token"' not in got:
        chunk = s.recv(4096)
        check(chunk, "the stream ended before its first token")
        got += chunk
    s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    s.close()
    return got


def serve_http_phase(torch, mx, i8, bnk, fa, dev, fp32_blob, qp, int8_rows,
                     num_layers=50, image=SERVE_IMAGE, classes=1000,
                     batch=SERVE_BATCH, decode_model=None, phase4=None):
    """Phase 53: ``serve_http`` over one ``ModelRegistry`` at full width:
    /predict through phase 17's ResNet-50 fp32 checkpoint (``fp32_blob``;
    max batch 32, batch wait 2 ms), with phase 17's int8 artifact ``qp``
    and its answers ``int8_rows``; /generate through a ``DecodeEngine`` at
    phase 4's configuration. /healthz 503 before the warmups, ``ok``
    after. Counts 0, then: phase 4's mix as 16 concurrent streams; the
    68-request /predict set from 16 threads (``spread_images``: each within
    1e-5 of the direct predictor); under closed-loop traffic (2 clients) the int8 canary
    (``enable_shadow`` at 0.25), ``swap(quantized=)`` (the 16 images'
    int8 answers bitwise phase 17's) and the rollback, nothing dropped;
    counts read: the paged kernels once a layer a prefill / step, the int8
    kernels 53 + 1 a forward of the int8 engines, BatchNorm 51 a forward
    (the batches, and the warmups of the three engines built). Then a
    client that hangs up mid-stream (the pool's free count
    returns), /metrics (every ``serving/mfu`` and ``decode/mfu`` at most
    1.05; ``note_mfu_divergence`` of the hand count against the health
    layer's count over the measured img/s under 0.20), /traces (one trace
    a request, ``serve.*`` nested in it), /alerts (the default rules), and
    decode tokens/s with trace sampling 1.0 against 0.0. Returns the
    results and the live server for phase 54."""
    from mxnet_tpu_torch import health, tracing
    on_card = dev.type == "cuda"
    dev_type = None if on_card else 1
    sym = mx.models.resnet(num_classes=classes, num_layers=num_layers,
                           image_shape=image)
    n_convs = len(int8_conv_layers(mx, 1, sym, image))
    n_bns = len(bn_layers(mx, 1, sym, image))
    from mxnet_tpu_torch.parallel.transformer import (
        TransformerConfig, init_transformer_params_np)
    cfg = TransformerConfig(dtype=torch.bfloat16 if on_card
                            else torch.float32, **(decode_model or FULL))
    params = init_transformer_params_np(cfg, seed=0, device=dev)
    reg = mx.serve.ModelRegistry(
        sym.tojson(), fp32_blob, {"data": (1,) + image}, dev_type=dev_type,
        config=mx.serve.ServeConfig(max_batch=batch, batch_wait_ms=2))
    deng = mx.serve.DecodeEngine(params, cfg, mx.serve.DecodeConfig(),
                                 device=dev).start()
    reg.attach_decode(deng)
    srv = mx.serve.serve_http(reg)
    port = srv.port
    cold = _http(port, "GET", "/healthz")
    check(cold[0] == 503 and cold[2] == b"warming\n",
          "/healthz before warmup: %s %r" % (cold[0], cold[2]))
    t0 = time.perf_counter()
    reg.warmup()
    deng.warmup()
    t_warm = time.perf_counter() - t0
    warm = _http(port, "GET", "/healthz")
    check(warm[0] == 200 and warm[2] == b"ok\n",
          "/healthz after warmup: %s %r" % (warm[0], warm[2]))
    log("serve_http: registry and decode warmup %.2fs; /healthz %d before, "
        "%d after" % (t_warm, cold[0], warm[0]))
    pool = np.random.RandomState(17).randn(SERVE_IMAGES, *image).astype(
        np.float32)
    spread, direct, spread_info = spread_images(reg.engine(), pool)
    reqs = decode_mix(cfg.vocab_size)

    def hist_count(name):
        return mx.telemetry.snapshot().get(name, {"count": 0})["count"]

    def value(name):
        return mx.telemetry.snapshot().get(name, 0)

    # -- the counted segment --------------------------------------------
    n_pre0 = hist_count("decode/prefill_seconds")
    n_step0 = hist_count("decode/step_seconds")
    batches0 = value("serving/batches_total")
    mirrors0 = value("quantize/shadow_requests_total")
    fa.reset_launches()
    i8.reset_launches()
    bnk.reset_launches()
    gen = http_generate_round(port, reqs, cfg.vocab_size)
    pset = http_predict_set(port, spread, direct, "set")
    traffic = _Traffic(port, pool, HTTP_CANARY_CLIENTS)
    t_can = time.perf_counter()
    reg.enable_shadow(qp, fraction=HTTP_SHADOW)
    _wait(lambda: value("quantize/shadow_requests_total") - mirrors0
          >= HTTP_MIRRORS, "%d mirrored requests" % HTTP_MIRRORS)
    t0 = time.perf_counter()
    reg.swap(quantized=qp)
    t_swap = time.perf_counter() - t0
    check(reg.quantized_active, "swap(quantized=) left fp32 active")
    int8_http = {}
    for i in range(SERVE_IMAGES):
        st, res = _http_predict(port, pool[i:i + 1])
        check(st == 200, "/predict after the int8 flip: %s" % st)
        int8_http[i] = res[0]
    n_before_rollback = traffic.count()
    _wait(lambda: traffic.count() >= n_before_rollback
          + HTTP_CANARY_REQUESTS, "int8 traffic")
    t0 = time.perf_counter()
    reg.swap(fp32_blob)
    t_rollback = time.perf_counter() - t0
    check(not reg.quantized_active, "the rollback left int8 active")
    n_after = traffic.count()
    _wait(lambda: traffic.count() >= n_after + HTTP_CANARY_REQUESTS,
          "fp32 traffic")
    reg.disable_shadow()
    codes = traffic.finish()
    t_can = time.perf_counter() - t_can
    launches = dict(fa.LAUNCHES, **i8.LAUNCHES)
    launches.update(bnk.LAUNCHES)
    n_pre = hist_count("decode/prefill_seconds") - n_pre0
    n_step = hist_count("decode/step_seconds") - n_step0
    batches = value("serving/batches_total") - batches0
    mirrored = value("quantize/shadow_requests_total") - mirrors0
    shadow = reg.shadow_report()
    check(not traffic.errors and set(codes) == {200},
          "requests failed across the canary, swap and rollback: %s %s"
          % (codes, traffic.errors[:3]))
    bitwise = all(int8_http[i].tobytes() == int8_rows[i].tobytes()
                  for i in range(SERVE_IMAGES))
    check(bitwise, "int8 answers through HTTP differ from phase 17's")
    # three engines were built and warmed in the segment (the shadow, the
    # int8 swap's, the rollback's): a forward a bucket each, off the
    # batch count
    n_warm = 3 * len(reg.engine().config.buckets)
    n_int8 = launches["int8_matmul"]
    if on_card:
        check(n_pre == len(reqs) and n_step > 0, "%d prefills for %d "
              "requests, %d steps" % (n_pre, len(reqs), n_step))
        check(launches["flash_prefill_paged"] == cfg.n_layers * n_pre
              and launches["paged_decode_attention"]
              == cfg.n_layers * n_step,
              "paged kernels launched %s for %d prefills and %d steps x %d "
              "layers" % (launches, n_pre, n_step, cfg.n_layers))
        check(n_int8 >= 1 and launches["int8_conv_im2col"]
              == n_convs * n_int8,
              "int8 kernels launched %s: not %d + 1 a batch"
              % (launches, n_convs))
        check(launches["batch_norm_inference"] == n_bns * (batches + n_warm),
              "batch_norm_inference launched %d times over %d batches and "
              "%d warmup forwards, not %d a forward"
              % (launches["batch_norm_inference"], batches, n_warm, n_bns))
    log("serve_http /generate: %d streams, %d tokens in %.3fs: %.1f "
        "tokens/s, TTFT p50 %.1f ms p99 %.1f ms, ITL p50 %.2f ms (phase 4 "
        "direct: %s); %d prefills, %d decode steps"
        % (gen["requests"], gen["tokens"], gen["wall_s"],
           gen["tokens_per_s"], gen["ttft_p50_ms"], gen["ttft_p99_ms"],
           gen["itl_p50_ms"], "not run" if phase4 is None else
           "%.1f tokens/s, TTFT p50 %.1f ms p99 %.1f ms, ITL p50 %.2f ms"
           % (phase4["tokens_per_s"], phase4["ttft_p50_ms"],
              phase4["ttft_p99_ms"], phase4["itl_p50_ms"]), n_pre, n_step))
    log("serve_http /predict set: %d requests (%d images) in %.3fs, max "
        "|http - direct| %.3g, max |log p http - log p direct| %.3g; the "
        "images scaled by %.4g: probabilities in [%.3g, %.3g], two images' "
        "answers at least %.3g apart"
        % (pset["requests"], pset["images"], pset["wall_s"],
           pset["max_abs_err"], pset["max_log_prob_err"],
           spread_info["scale"], spread_info["p_min"],
           spread_info["p_max"], spread_info["apart"]))
    log("serve_http canary -> int8 swap -> rollback under %d clients: %.2fs, "
        "statuses %s, %d mirrored (shadow drift max %s p99 %s), swap %.2fs, "
        "rollback %.2fs, int8 answers bitwise phase 17's %s; launches %s over "
        "%d batches and %d warmup forwards (%d int8 forwards)"
        % (HTTP_CANARY_CLIENTS, t_can, codes, mirrored, shadow["drift_max"],
           shadow["drift_p99"], t_swap, t_rollback, bitwise, launches,
           batches, n_warm, n_int8))
    # -- a client that hangs up mid-stream --------------------------------
    free0 = deng._pool.free_pages
    pre0 = value("decode/preempted_total")
    _disconnect(port, reqs[0][0], HTTP_DISCONNECT_NEW)
    t0 = time.perf_counter()
    _wait(lambda: deng._pool.free_pages == free0
          and value("decode/preempted_total") > pre0,
          "the hung-up session's pages")
    t_free = time.perf_counter() - t0
    log("serve_http disconnect: pool back to %d free pages %.3fs after the "
        "reset; decode/preempted_total +%d"
        % (free0, t_free, value("decode/preempted_total") - pre0))
    # -- /metrics: the MFU gauges and the divergence ----------------------
    st, _, body = _http(port, "GET", "/metrics")
    check(st == 200, "/metrics answered %d" % st)
    prom = parse_prometheus(body.decode())
    serve_mfu = {dict(k[1])["bucket"]: v for k, v in prom.items()
                 if k[0] == "mxnet_serving_mfu"}
    decode_mfu = {"%s/%s" % (dict(k[1])["phase"], dict(k[1])["bucket"]): v
                  for k, v in prom.items() if k[0] == "mxnet_decode_mfu"}
    check(serve_mfu and decode_mfu, "/metrics lacks serving/mfu or "
          "decode/mfu: %s %s" % (serve_mfu, decode_mfu))
    hbm = {dict(k[1])["device"]: v for k, v in prom.items()
           if k[0] == "mxnet_hbm_bytes_in_use"}
    check(hbm or not on_card, "/metrics lacks hbm/bytes_in_use")
    over = {k: v for k, v in list(serve_mfu.items())
            + list(decode_mfu.items()) if v > 1.05 or v <= 0}
    check(not over, "MFU gauges out of (0, 1.05]: %s" % over)
    rec = reg.engine()._bucket_cost.get(batch)
    check(rec is not None, "no cost record for the batch-%d bucket" % batch)
    hand = network_flops(mx, sym, image) / 3.0        # forward, per image
    est = hand * pset["img_per_s"] / health.peak_flops()
    measured = rec["flops"] / batch * pset["img_per_s"] / health.peak_flops()
    ratio = health.note_mfu_divergence(est, measured)
    health.evaluate_once()
    firing = health.evaluate_once()
    check(abs(ratio - 1.0) < 0.20 and "mfu_divergence" not in firing,
          "mfu_divergence %.4f (rule firing: %s)" % (abs(ratio - 1.0),
                                                     firing))
    log("serve_http /metrics: serving/mfu %s, decode/mfu %s (peak %.4g "
        "FLOP/s, spec sheet); hbm/bytes_in_use %s; hand-count vs "
        "health-count FLOPs/image %.4g vs %.4g: divergence %.4f"
        % ({k: round(v, 4) for k, v in sorted(serve_mfu.items())},
           {k: round(v, 4) for k, v in sorted(decode_mfu.items())},
           health.peak_flops(), hbm, hand, rec["flops"] / batch,
           abs(ratio - 1.0)))
    # -- /traces: one trace a request, serve.* nested ---------------------
    rids = ["trace-%d" % i for i in range(HTTP_TRACED)]
    for i, rid in enumerate(rids):
        check(_http_predict(port, pool[i % SERVE_IMAGES:][:1], rid)[0]
              == 200, "/predict for the trace check failed")
    nested = 0
    for rid in rids:
        st, _, body = _http(port, "GET", "/traces?id=%s" % rid)
        check(st == 200, "/traces has no trace %s" % rid)
        tr = json.loads(body)
        names = {s["span_id"]: s["name"] for s in tr["spans"]}
        pairs = {(s["name"], names.get(s["parent_id"])) for s in tr["spans"]}
        check(tr["root"] == "http.request"
              and ("serve.batch", "http.request") in pairs
              and ("serve.compute", "serve.batch") in pairs
              and ("serve.queue_wait", "http.request") in pairs,
              "trace %s: spans %s" % (rid, sorted(pairs)))
        nested += 1
    one = [None]
    _http_stream(port, reqs[0][0], reqs[0][1], one, 0)
    st, _, body = _http(port, "GET", "/traces?id=%s" % one[0]["rid"])
    check(st == 200, "/traces has no trace of a /generate request")
    tr = json.loads(body)
    names = {s["span_id"]: s["name"] for s in tr["spans"]}
    pairs = {(s["name"], names.get(s["parent_id"])) for s in tr["spans"]}
    check(("decode.prefill", "http.request") in pairs
          and ("decode.step", "http.request") in pairs,
          "a /generate trace's spans: %s" % sorted(pairs))
    gen_phases = tr["phases"]
    st, _, body = _http(port, "GET", "/alerts")
    rules = sorted(r["name"] for r in json.loads(body)["rules"])
    check(st == 200 and set(rules) >= {
        "serve_p99", "decode_itl_p99", "queue_depth", "worker_restart_burn",
        "kv_giveups", "numerics", "mfu_divergence", "badput_fraction"},
        "/alerts rules: %s" % rules)
    log("serve_http /traces: %d of %d requests' traces with serve.* nested; "
        "a /generate trace's phases %s; /alerts rules %s"
        % (nested, len(rids), gen_phases, rules))
    # -- decode tokens/s, trace sampling 1.0 against 0.0 -------------------
    overhead = []
    for rate in HTTP_TRACE_ROUNDS:
        prev = tracing.set_sample(rate)
        try:
            r = http_generate_round(port, reqs, cfg.vocab_size)
        finally:
            tracing.set_sample(prev)
        overhead.append({"sample": rate, "tokens_per_s": r["tokens_per_s"],
                         "wall_s": r["wall_s"]})
    on = [r["tokens_per_s"] for r in overhead if r["sample"] == 1.0]
    off = [r["tokens_per_s"] for r in overhead if r["sample"] == 0.0]
    log("serve_http trace overhead: decode tokens/s sampled %s, unsampled "
        "%s: median sampled / median unsampled %.4f (the unsampled rounds "
        "spread %.4fx)"
        % (["%.1f" % x for x in on], ["%.1f" % x for x in off],
           float(np.median(on) / np.median(off)), max(off) / min(off)))
    res = {"warmup_s": t_warm,
           "healthz": [cold[0], warm[0]], "generate": gen,
           "predict_set": pset, "predict_spread": spread_info,
           "canary": {
               "wall_s": t_can, "statuses": codes, "mirrored": mirrored,
               "shadow": shadow, "swap_s": t_swap, "rollback_s": t_rollback,
               "int8_bitwise_phase17": bitwise},
           "launches": launches, "batches": batches, "warmup_forwards": n_warm,
           "int8_forwards": n_int8,
           "prefills": n_pre, "decode_steps": n_step,
           "disconnect_free_s": t_free, "serving_mfu": serve_mfu,
           "decode_mfu": decode_mfu, "mfu_divergence": abs(ratio - 1.0),
           "traces_nested": nested, "alerts_rules": rules,
           "trace_overhead": overhead}
    return res, {"reg": reg, "decode": deng, "srv": srv, "pool": pool,
                 "reqs": reqs, "vocab": cfg.vocab_size}


def fault_phase(mx, live):
    """Phase 54a: ``serve.worker`` and ``decode.step`` armed once each on
    the live server: the serve worker restarts (its batch's request is
    served), ``worker_restart_burn`` fires on ``evaluate_once``; the
    decode scheduler's crash fails the session in flight with a 500 and
    the scheduler restarts; the next requests complete."""
    from mxnet_tpu_torch import fault, health
    port, pool, reg = live["srv"].port, live["pool"], live["reg"]
    health.evaluate_once()                  # primes the counter deltas

    def value(name):
        return mx.telemetry.snapshot().get(name, 0)

    r0 = value("serving/worker_restarts_total")
    fault.arm("serve.worker", step=1)
    try:
        st1, _ = _http_predict(port, pool[:1])
        st2, _ = _http_predict(port, pool[1:2])
        _wait(lambda: value("serving/worker_restarts_total") > r0,
              "the serve worker's restart")
    finally:
        fault.disarm("serve.worker")
    firing = health.evaluate_once()
    check(st1 == 200 and st2 == 200, "/predict around the serve.worker "
          "fault: %s %s" % (st1, st2))
    check("worker_restart_burn" in firing, "worker_restart_burn did not fire"
          " after a serve worker restart: %s" % firing)
    d0 = value("decode/worker_restarts_total")
    prompt, _ = live["reqs"][1]
    fault.arm("decode.step", step=1)
    try:
        st, _, body = _http(port, "POST", "/generate", json.dumps(
            {"prompt": [int(t) for t in prompt], "max_new_tokens": 8,
             "stream": False}).encode())
    finally:
        fault.disarm("decode.step")
    check(st == 500 and b"injected fault" in body,
          "/generate under the decode.step fault: %s %r" % (st, body[:200]))
    _wait(lambda: value("decode/worker_restarts_total") > d0,
          "the decode scheduler's restart")
    st_p, _ = _http_predict(port, pool[2:3])
    st_g, _, body = _http(port, "POST", "/generate", json.dumps(
        {"prompt": [int(t) for t in prompt], "max_new_tokens": 8,
         "stream": False}).encode())
    check(st_p == 200 and st_g == 200 and len(json.loads(body)["tokens"])
          == 8, "requests after the faults: %s %s" % (st_p, st_g))
    health.evaluate_once()
    log("faults: serve.worker -> statuses %s %s, serving restarts +%d, "
        "rules firing %s; decode.step -> %d (%s), decode restarts +%d; "
        "after: /predict %d, /generate %d"
        % (st1, st2, value("serving/worker_restarts_total") - r0, firing, st,
           json.loads(body).get("error", "")[:60] if st_g != 200 else "ok",
           value("decode/worker_restarts_total") - d0, st_p, st_g))
    return {"serve_worker_statuses": [st1, st2], "rules_firing": firing,
            "decode_step_status": st, "after": [st_p, st_g]}


def _nan_iter(mx, shape, nan_batch, batches, ctx):
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (batches,) + shape).astype(np.float32)
    x[nan_batch] = np.nan
    y = rng.randint(0, 1000, (batches, shape[0])).astype(np.float32)
    return mx.io.NDArrayIter(x.reshape((-1,) + shape[1:]),
                             y.reshape(-1), batch_size=shape[0])


def health_phase(torch, mx, fu, workdir, num_layers=50, image=(3, 224, 224),
                 batch=RESNET_BATCH):
    """Phase 54b: a NaN batch trips the numerics sentinel in a ResNet-50
    ``Module.fit`` (policy raise); phase 13's fit step timed with the
    sentinel off / ``step`` / ``full``, the flight recorder on, and "off"
    again as the noise floor (min of HEALTH_ROUNDS rounds of HEALTH_STEPS
    steps, the order reversed every other round): on the card the
    ``step`` mode's cost is held to the JAX package's 2% budget as its
    ``health_overhead`` holds it (above twice the noise floor only); a
    ``DataPipeline``-fed fit whose traces hold ``train.data_wait`` and
    the ``io.*`` spans."""
    from mxnet_tpu_torch import blackbox, health, tracing
    ctx = mx.gpu(0) if torch.cuda.is_available() else mx.cpu()
    sym = mx.models.resnet(num_classes=1000, num_layers=num_layers,
                           image_shape=image)
    shape = (batch,) + image
    prev = health.set_numerics("step"), health.set_numerics_policy("raise")
    trips0 = health.numerics_trips()
    try:
        mod = mx.mod.Module(sym, context=ctx)
        tripped = None
        try:
            mod.fit(_nan_iter(mx, shape, 1, 3, ctx), num_epoch=1,
                    optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1,
                                      "momentum": 0.9},
                    initializer=mx.init.Xavier(rnd_type="gaussian",
                                               factor_type="in",
                                               magnitude=2))
        except health.NumericsError as e:
            tripped = e.report
        check(tripped is not None and tripped["nonfinite"] > 0,
              "a NaN batch did not trip the sentinel: %s" % tripped)
        check(health.numerics_trips() == trips0 + 1, "numerics trips %d"
              % (health.numerics_trips() - trips0))
        log("numerics: the NaN batch tripped the sentinel (report %s)"
            % {k: v for k, v in tripped.items() if k != "per_param"})
        del mod
        # phase 13's step, the sentinel and the recorder in turns
        mod = mx.mod.Module(sym, context=ctx)
        train = synthetic_iter(mx, shape, 1000, 4, ctx)
        mod.bind(data_shapes=train.provide_data,
                 label_shapes=train.provide_label)
        mod.init_params(mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2))
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4})
        data_batch = next(iter(train))
        metric = mx.metric.create(["accuracy"])
        path = os.path.join(workdir, "flight.bin")
        # "off2" is "off" measured again: its distance from "off" is the
        # measure's noise floor (the JAX package's health_overhead)
        configs = (("off", ("off", False)), ("step", ("step", False)),
                   ("full", ("full", False)),
                   ("off+recorder", ("off", True)),
                   ("off2", ("off", False)))
        times = {name: [] for name, _ in configs}

        def loop(mode, rec):
            health.set_numerics(mode)
            blackbox.configure(path if rec else None)
            for i in range(2 + HEALTH_STEPS):
                if i == 2:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                mod.forward_backward(data_batch)
                mod.update()
                mod.update_metric(metric, data_batch.label)
            mod._exec.flush_numerics()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / HEALTH_STEPS * 1e3

        fu.reset_launches()
        for _name, cfg in configs:
            loop(*cfg)                  # warm: each mode's first steps
        for rnd in range(HEALTH_ROUNDS):
            for name, cfg in configs[::1 if rnd % 2 == 0 else -1]:
                times[name].append(loop(*cfg))
        blackbox.configure(None)
        steps = (HEALTH_ROUNDS + 1) * len(configs) * (2 + HEALTH_STEPS)
        check(fu.LAUNCHES["sgd_fused_update"] == steps
              or not torch.cuda.is_available(),
              "sgd_fused_update launched %d times for %d steps"
              % (fu.LAUNCHES["sgd_fused_update"], steps))
        best = {k: min(v) for k, v in times.items()}
        over = {k: v / best["off"] - 1.0 for k, v in best.items()}
        noise = abs(over["off2"])
        gate = max(HEALTH_BUDGET, 2 * noise)
        log("numerics step time (ms, min of %d alternated rounds of %d "
            "ResNet-50 batch-%d steps): %s; overhead vs off %s; step mode "
            "%+.2f%% against the %.0f%% budget (noise floor off2 %.2f%%, "
            "gate %.2f%%)"
            % (HEALTH_ROUNDS, HEALTH_STEPS, batch,
               {k: round(v, 3) for k, v in best.items()},
               {k: "%+.2f%%" % (100 * v) for k, v in over.items()},
               100 * over["step"], 100 * HEALTH_BUDGET, 100 * noise,
               100 * gate))
        check(over["step"] <= gate or not torch.cuda.is_available(),
              "the step-mode numerics sentinel costs "
              "%+.2f%% a step, above the %.0f%% budget and twice the "
              "%.2f%% noise floor" % (100 * over["step"],
                                      100 * HEALTH_BUDGET, 100 * noise))
        del mod
    finally:
        health.set_numerics(prev[0])
        health.set_numerics_policy(prev[1])
    # a DataPipeline-fed fit: train.data_wait and io.* spans
    rng = np.random.RandomState(6)
    x = rng.randn(HEALTH_PIPE_ROWS, 256).astype(np.float32)
    y = rng.randint(0, 10, (HEALTH_PIPE_ROWS,)).astype(np.float32)
    pipe = mx.io.DataPipeline(mx.io.ArrayBatchSource(x, y, batch_size=64),
                              num_workers=0, prefetch=1, ctx=ctx)
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=10, name="fc"), name="softmax")
    tracing.reset()
    fu.reset_launches()
    mx.mod.Module(net, context=ctx).fit(
        pipe, num_epoch=1, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1})
    pipe_launches = fu.LAUNCHES["sgd_fused_update"]
    spans = {}
    for t in tracing.finished_traces():
        names = {s["span_id"]: s["name"] for s in t["spans"]}
        for s in t["spans"]:
            key = (s["name"], names.get(s["parent_id"]))
            spans[key] = spans.get(key, 0) + 1
    check(("train.data_wait", "train.step") in spans
          and ("io.batch_wait", "train.data_wait") in spans
          and any(k[0] == "io.h2d" for k in spans),
          "pipeline fit spans: %s" % sorted(spans))
    check(pipe_launches == HEALTH_PIPE_ROWS // 64
          or not torch.cuda.is_available(), "pipeline fit launched "
          "sgd_fused_update %d times" % pipe_launches)
    log("pipeline fit traces: %s" % {"%s<%s" % k: n
                                     for k, n in sorted(spans.items(),
                                                        key=str)})
    return {"tripped": {k: v for k, v in tripped.items()
                        if k != "per_param"},
            "step_ms": best, "overhead": over, "noise_floor": noise,
            "step_rounds_ms": times,
            "launches": steps + pipe_launches, "pipeline_spans": {
                "%s<%s" % k: n for k, n in spans.items()}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", help="write the full report here (JSON)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.cuda import _build
    from mxnet_tpu_torch.ops.cuda import batch_norm as bnk
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda import fused_update as fu
    from mxnet_tpu_torch.ops.cuda import image_decode as idec
    from mxnet_tpu_torch.ops.cuda import int8_matmul as i8
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.time()

    card = card_line()
    log(card)
    log("torch %s cuda %s python %s" % (torch.__version__,
                                       torch.version.cuda,
                                       sys.version.split()[0]))
    t0 = time.time()
    logs = _build.build_all()
    PTXAS.update(logs)
    log("build_s %.2f (%s)" % (time.time() - t0, ", ".join(sorted(logs))
                               or "cached"))
    for name in sorted(logs):
        log("ptxas %s: %s" % (name, "; ".join(ptxas_summary(logs[name]))))

    timer = Timer(torch)
    checks = check_kernels(torch, fa)
    main_rows, table = time_kernels(torch, fa, timer)
    served = serve(torch, fa)
    path_errs = path_vs_cpu(torch)
    flash_checks = check_flash(torch, fa)
    flash_rows = time_flash(torch, fa, timer)
    del timer
    trained = train(torch, fa)
    train_cpu = train_vs_cpu(torch, fa)
    routes = train_bf16_routes(torch, fa)
    fused_checks = check_fused(torch, mx, fu)
    timer = Timer(torch)
    fused_rows = time_fused(torch, mx, fu, timer)
    del timer
    fitted = resnet_fit(torch, mx, fu, fa)
    resnet_cpu = resnet_vs_cpu(torch, mx, fu)
    int8_checks = check_int8(torch, mx, i8) + check_bn(torch, mx, bnk)
    timer = Timer(torch)
    int8_rows = time_int8(torch, mx, i8, timer) + [time_bn(torch, mx, bnk,
                                                           timer)]
    del timer
    workdir = os.path.join(root, "build", "chip_smoke_int8")
    try:
        served_int8 = serve_int8(torch, mx, i8, bnk, workdir,
                                 torch.device("cuda"))
        # phase 53 serves the same checkpoint and artifact over HTTP
        qp17 = served_int8.pop("artifact")
        int8_rows17 = served_int8.pop("int8_rows")
        fp32_blob17 = served_int8.pop("fp32_blob")
        int8_cpu = int8_vs_cpu(torch, mx, qp17, torch.device("cuda"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rtc_mods, rtc_compile = rtc_modules(mx)
    log("rtc NVRTC compile ms (cold / cached): %s" % ", ".join(
        "%s %.1f / %.3f" % (k, v["cold_ms"], v["cached_ms"])
        for k, v in rtc_compile.items()))
    rtc_checks = check_rtc(torch, mx, rtc_mods)
    timer = Timer(torch)
    rtc_row = time_rtc(torch, mx, rtc_mods, timer)
    del timer
    custom = rtc_custom_op(torch, mx, rtc_mods)
    gluon = gluon_fit(torch, mx, fu, fitted["img_per_s"])
    g_net, g_x = gluon.pop("net"), gluon.pop("x")
    g_net.hybridize(False)          # its CUDA graphs go; phase 27 exports it
    gluon_cpu = gluon_vs_cpu(torch, mx, fu)
    rec = os.path.join(root, "build", "smoke_data", "train.rec")
    rec_bytes, rec_s = smoke_records(mx, rec)
    log("data: wrote %d records (%.1f MB, %.1f KB a record) in %.2fs: %s"
        % (SMOKE_RECORDS, rec_bytes / 1e6, rec_bytes / SMOKE_RECORDS / 1e3,
           rec_s, os.path.relpath(rec, root)))
    timer = Timer(torch)
    data = data_pipeline(torch, mx, idec, rec, timer)
    rec2 = os.path.join(root, "build", "smoke_data", "domain.rec")
    kinds = domain_records(mx, rec2)
    log("data: wrote %d records of original sizes, subsamplings %s: %s"
        % (DOMAIN_RECORDS, kinds, os.path.relpath(rec2, root)))
    data["domain"] = decode_domain(torch, mx, idec, rec2, timer)
    del timer
    data.update(records=SMOKE_RECORDS, rec_bytes=rec_bytes, rec_write_s=rec_s)
    cli_synth = cli_synthetic(torch, mx, fu, fitted["img_per_s"])
    cli_rec = cli_records(torch, mx, fu, idec, rec, os.path.join(
        root, "build", "smoke_ckpt", "r50"))
    exported = gluon_export(torch, mx, bnk, g_net, g_x, os.path.join(
        root, "build", "chip_smoke_export"))
    networks = cli_networks(torch, mx, fu)
    networks_cpu = networks_vs_cpu(torch, mx, fu)
    swept = op_sweep(torch, mx)
    incep = inception_fit(torch, mx, fu)
    mobile = mobilenet_gluon(torch, mx, fu)
    zoo = zoo_score(torch, mx, bnk, os.path.join(root, "build",
                                                  "chip_smoke_zoo"))
    zoo_cpu = zoo_vs_f64(torch, mx, fu)
    mnist = mnist_cli(torch, mx, fu)
    lm_dir = os.path.join(root, "build", "chip_smoke_lm")
    try:
        lstm_a = lstm_cli(torch, mx, fu, lm_dir)
    finally:
        shutil.rmtree(lm_dir, ignore_errors=True)
    lstm_b = lstm_gluon(torch, mx, fu)
    rnn_card = rnn_ctc_card(torch, mx)
    timer = Timer(torch)
    routes38 = check_flash_routes(torch, fa, timer)
    del timer
    contrib = contrib_card(torch, mx, fa)
    lm = lm_cli(torch, mx, fa)
    steps = train_configs(torch, fa)
    generated = generate_card(torch, mx, fa)
    moe = moe_serve(torch, mx, fa)
    sharded = sharded_rows(torch, mx, fitted["img_per_s"])
    sharded_chk = sharded_checks(torch, mx)
    sharded_more = sharded_inception_mlp(torch, mx)
    e2e_rec = os.path.join(root, "build", "smoke_data", "e2e.rec")
    e2e_write_s = synth_records(mx, e2e_rec)
    log("data: wrote %d %dx%d noise JPEGs in %.2fs: %s"
        % (E2E_RECORDS, E2E_SIDE, E2E_SIDE, e2e_write_s,
           os.path.relpath(e2e_rec, root)))
    e2e = e2e_train(torch, mx, idec, e2e_rec)
    pipeline = pipeline_phase(torch, mx, fu, e2e_rec)
    rule_checks = check_rules(torch, mx, fu)
    timer = Timer(torch)
    rule_rows = time_rules(torch, mx, fu, timer)
    del timer
    lowp = gluon_lowp(torch, mx, fu)
    http53, live = serve_http_phase(torch, mx, i8, bnk, fa,
                                    torch.device("cuda"), fp32_blob17, qp17,
                                    int8_rows17, phase4=served)
    del fp32_blob17, qp17, int8_rows17
    try:
        faults54 = fault_phase(mx, live)
    finally:
        live["srv"].close()
        live["reg"].close(drain=False)
        del live
    hdir = os.path.join(root, "build", "chip_smoke_health")
    try:
        health54 = health_phase(torch, mx, fu, hdir)
    finally:
        shutil.rmtree(hdir, ignore_errors=True)

    sources = {"paged_decode_attention": (
        "mxnet_tpu_torch/ops/cuda/csrc/paged_decode_attention.cu",
        "mxnet_tpu/ops/pallas/flash_attention.py:351"),
        "flash_prefill_paged": (
        "mxnet_tpu_torch/ops/cuda/csrc/flash_prefill_paged.cu",
        "mxnet_tpu/ops/pallas/flash_attention.py:515"),
        "flash_attention": (
        "mxnet_tpu_torch/ops/cuda/csrc/flash_attention.cu",
        "mxnet_tpu/ops/pallas/flash_attention.py:60"),
        # the TPU's backward is XLA (_flash_bwd), not a Pallas kernel
        "flash_attention_bwd": (
        "mxnet_tpu_torch/ops/cuda/csrc/flash_attention_bwd.cu",
        "mxnet_tpu/ops/pallas/flash_attention.py:238"),
        # one CUDA source computes both; the TPU's body is _update_kernel
        "sgd_fused_update": (
        "mxnet_tpu_torch/ops/cuda/csrc/fused_update.cu",
        "mxnet_tpu/ops/pallas/fused_update.py:65"),
        "adam_fused_update": (
        "mxnet_tpu_torch/ops/cuda/csrc/fused_update.cu",
        "mxnet_tpu/ops/pallas/fused_update.py:65"),
        "int8_matmul": (
        "mxnet_tpu_torch/ops/cuda/csrc/int8_matmul.cu",
        "mxnet_tpu/ops/pallas/int8_matmul.py:56"),
        # on the TPU: _im2col, then the int8_matmul kernel per group
        "int8_conv_im2col": (
        "mxnet_tpu_torch/ops/cuda/csrc/int8_conv_im2col.cu",
        "mxnet_tpu/ops/pallas/int8_matmul.py:197"),
        # XLA on the TPU: the inference branch of the BatchNorm op
        "batch_norm_inference": (
        "mxnet_tpu_torch/ops/cuda/csrc/batch_norm_inference.cu",
        "mxnet_tpu/ops/nn.py:234"),
        # the user's kernel, compiled at run time: NVRTC for Pallas
        "rtc": ("mxnet_tpu_torch/rtc.py", "mxnet_tpu/rtc.py:90"),
        # no TPU kernel: the host decoder's float loop (OpenCV on threads)
        "crop_mirror_normalize": (
        "mxnet_tpu_torch/ops/cuda/csrc/image_decode.cu",
        "src/native/imagedec.cc:187")}
    # launches: the serving kernels' from the served round, the training
    # kernels' from the first timed train call (8 steps), the SGD update's
    # from phase 22's first hybridized window (24 steps, the update once
    # a step beside the CUDA graphs), phase 28's four CLI runs, phase 30's
    # Inception fit, phase 31's first hybridized window, phase 34's two
    # train_mnist runs, phase 35's lstm_bucketing fit and phase 36's first
    # hybridized window, phase 49's pipeline-fed fit, Adam's from
    # Module.fit (4 steps)
    launches = dict(served["launches"])
    for name in ("flash_attention", "flash_attention_bwd"):
        launches[name] = trained["calls"][1]["launches"][name]
    launches["sgd_fused_update"] = gluon["launches"]["sgd_fused_update"] \
        + sum(r["launches"] for r in networks.values()) \
        + incep["launches"] + mobile["launches"] \
        + sum(r["launches"] for r in mnist.values()) \
        + lstm_a["launches"] + lstm_b["launches"] \
        + pipeline["fit"]["launches"]
    launches["adam_fused_update"] = fitted["adam_launches"]
    # the int8 kernels' from the int8 correctness set of phase 17; the
    # BatchNorm kernel's from phase 27's timed windows (its replays of
    # the exported predictor counted, and the eager predicts) and phase
    # 32's scoring windows (replays counted)
    launches.update(served_int8["runs"]["int8"]["launches"])
    launches["batch_norm_inference"] = exported["window_launches"] \
        + zoo["window_launches"]
    # phase 53's through HTTP (the counted segment: the /generate mix, the
    # /predict set, the canary, the int8 swap and the rollback), phase
    # 54's fit steps
    for name in ("paged_decode_attention", "flash_prefill_paged",
                 "int8_matmul", "int8_conv_im2col", "batch_norm_inference"):
        launches[name] += http53["launches"][name]
    launches["sgd_fused_update"] += health54["launches"]
    # rtc's from the custom op of phase 21 (its forward and backward)
    launches["rtc"] = custom["launches"]
    # the augment kernel's from the records fit of phase 26 and phase
    # 48's e2e steps
    launches["crop_mirror_normalize"] = cli_rec["kernel_launches"] \
        + e2e["kernel_launches"]
    kernels = []
    for r in main_rows + flash_rows + fused_rows + int8_rows + [
            rtc_row, data["kernel"]]:
        src, rep = sources[r["name"]]
        kernels.append({
            "name": r["name"], "route": "cuda", "source": src,
            "replaces": rep, "launches": launches[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # phase 38's timed rows of both routes: launches of the bf16 shapes
    # from phase 39's contrib op at the same head_dim / key length, of
    # the float32 shape from phase 40's two CLI runs (the train shape is
    # phase 7's row above, its launches phase 8's)
    for r in routes38["timed"]:
        src, rep = sources[r["name"]]
        if r["label"].startswith("f32"):
            n = sum(run["launches"][r["name"]] for run in lm.values())
        elif r["label"] == ROUTE_TIMED[-1][0]:
            continue
        else:
            shape = CONTRIB_SHAPES[0 if "128" in r["label"] else 1]
            n = sum(row["launches"][r["name"]] for row in contrib["rows"]
                    if row["shape"] == list(shape))
        kernels.append({
            "name": "%s (%s route, %s)" % (r["name"], r["route"],
                                           r["label"]),
            "route": "cuda", "source": src, "replaces": rep,
            "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # phase 51's rows: the bf16 and master-mode SGD rows' launches from
    # phase 52's first timed window of each, NAG's from its CLI run, the
    # other rules' from their Trainer steps on the bf16 net
    src, rep = sources["sgd_fused_update"]
    for r in rule_rows:
        rule = r["name"][:-len("_fused_update")]
        if rule == "sgd":
            run = lowp["float16_multi_precision" if "master" in r["label"]
                       else "bf16"]
            n = run["windows"][0]["launches"]
            name = "sgd_fused_update (%s)" % r["label"][4:]
        else:
            n = (lowp["cli_nag"] if rule == "nag"
                 else lowp["other_rules"][rule])["launches"]
            name = r["name"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    kind = torch.cuda.get_device_name(0)
    report = {"card": card, "torch": torch.__version__,
              "checks": checks, "timings": table, "serve": served,
              "path_max_abs_err": path_errs, "flash_checks": flash_checks,
              "flash_timings": flash_rows, "train": trained,
              "train_vs_cpu": train_cpu, "train_bf16_routes": routes,
              "fused_update_checks": fused_checks,
              "fused_update_timings": fused_rows, "resnet_fit": fitted,
              "resnet_vs_cpu": resnet_cpu, "int8_checks": int8_checks,
              "int8_timings": int8_rows, "int8_serve": served_int8,
              "int8_vs_cpu": int8_cpu, "rtc_compile": rtc_compile,
              "rtc_checks": rtc_checks, "rtc_timing": rtc_row,
              "rtc_custom_op": custom, "gluon_fit": gluon,
              "gluon_vs_cpu": gluon_cpu, "gluon_export": exported,
              "data": data,
              "cli_synthetic": cli_synth, "cli_records": cli_rec,
              "networks": networks, "networks_vs_cpu": networks_cpu,
              "op_sweep": swept, "inception_fit": incep,
              "mobilenet_gluon": mobile, "zoo_score": zoo,
              "zoo_vs_f64": zoo_cpu, "train_mnist": mnist,
              "lstm_bucketing": lstm_a, "gluon_lm": lstm_b,
              "rnn_ctc_card": rnn_card, "flash_routes": routes38,
              "contrib_flash_attention": contrib, "lm_cli": lm,
              "train_configs": steps, "generate": generated,
              "moe_serve": moe, "sharded_trainer": sharded,
              "sharded_checks": sharded_chk,
              "sharded_inception_mlp": sharded_more, "e2e_train": e2e,
              "data_pipeline_pool": pipeline,
              "fused_update_rules": rule_checks,
              "fused_update_rule_timings": rule_rows,
              "gluon_low_precision": lowp, "serve_http": http53,
              "faults": faults54, "health": health54, "kernels": kernels,
              "update_launches": {
                  "module_fit": fitted["launches"]["sgd_fused_update"],
                  "gluon_fit": gluon["launches"]["sgd_fused_update"],
                  "gluon_adam": gluon["adam_launches"],
                  "networks": {k: v["launches"]
                               for k, v in networks.items()},
                  "inception_fit": incep["launches"],
                  "mobilenet_gluon": mobile["launches"],
                  "train_mnist": {k: v["launches"]
                                  for k, v in mnist.items()},
                  "lstm_bucketing": lstm_a["launches"],
                  "gluon_lm": lstm_b["launches"],
                  "pipeline_fit": pipeline["fit"]["launches"],
                  "gluon_bf16": lowp["bf16"]["windows"][0]["launches"],
                  "gluon_float16_master": lowp["float16_multi_precision"][
                      "windows"][0]["launches"],
                  "cli_nag": lowp["cli_nag"]["launches"],
                  "other_rules": {k: v["launches"] for k, v in
                                  lowp["other_rules"].items()}},
              "wall_s": time.time() - t_all}
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    log("sgd_fused_update launches: Module.fit %d, Gluon fit %d; "
        "adam_fused_update: Module.fit %d, Gluon %d"
        % (fitted["launches"]["sgd_fused_update"],
           gluon["launches"]["sgd_fused_update"],
           launches["adam_fused_update"], gluon["adam_launches"]))
    log("wall_s %.1f" % report["wall_s"])
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
