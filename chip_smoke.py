#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py [--profile] [--seed N]

Phases (any failure exits non-zero before the last line is printed):

1. build   — compile every CUDA kernel of the paths from ``ever_tpu_torch/csrc``
             with ``nvcc``, one process per source, all at once; print each
             library's most registers and spills from ptxas's report, and
             fail on a ``wgmma`` that ptxas serialized.
2. kernels — each attention kernel against its plain PyTorch version on the card:
             the attention forward (K1) and backward (K2) at the main
             paths' shape (B=8, H=16, N=1029, D=64, bf16, RoPE), with stack
             padding (N=1032, ``n_valid=1029``), at head dim 128 without RoPE,
             and from float32 inputs, and at the spatial phase's (f) strip
             shape (B=1, H=16, 2053 queries against 4101 keys, each with its
             own RoPE rows; bf16 and from float32 inputs); then each timed
             beside its bound and one PyTorch library call computing the
             same function (K1 also at head dim 128 and from float32 inputs;
             both at the strip shape too), and both split by kernel from
             ``torch.profiler`` (K1: its K staging launch and main kernel;
             K2: its prologue, dK/dV pass and dQ pass) with each main
             kernel's TFLOP/s.
3. serve   — DinoSeg ViT-L/16 (``vitl16_sat493m``, 24 blocks, width 1024,
             16 heads) with bf16 parameters and seeded random weights,
             served through ``tiled_inference`` over one 4096² scene (512²
             tiles, stride 512, ``tile_batch=8``: 64 tiles, 8 batches).  Every
             attention call (N = 1029 tokens) goes through K1: 24 × 8 = 192
             launches per scene.  The output must be finite probabilities,
             one tile batch through the kernel must match the same batch with
             plain attention, and a float32 model must launch K1 too.
4. train   — the same model as the JAX package's ``vit512`` bench section:
             bf16 compute with float32 parameters, AdamW (weight decay 0.05)
             with a cosine schedule (base_lr 1e-4, 1000 iterations), built
             through ``builder`` and ``parallel.spmd``; 8 seeded random 512²
             tiles with labels in [0, 7), RoPE rescale augmentation on.  Two
             warm-up and ten timed steps: 24 K1 and 24 K2 launches per step, a
             finite loss and grad_norm every step, parameters still float32.
             Then the gradients of 2 tiles through the kernels against the
             same step with plain attention, one 1024² step at B=2 with
             ``remat='full'`` (48 K1 and 24 K2 launches) against the same
             step without remat, and one forward and backward through
             ``impl='flash'`` at N=16389 (a 2048² tile) against the plain
             versions; one step runs under ``torch.cuda.set_sync_debug_mode
             ('error')``: the step never makes the host wait for the card.
5. farseg  — FarSeg-R50 (the JAX package's ``farseg`` bench section, without
             its TPU-only layouts) with ``maxpool_impl='pallas'``: first the
             stem's max pool backward (K8) against its plain version at the
             main shape ([8, 256, 256, 64] bf16), in float32, at the siamese
             detectors' [16, 256, 256, 64] bf16, at [2, 30, 22, 5] (the
             unaligned path), on inputs with ties, and at the spatial
             phase's stem shapes (a rank's [1, 514, 1024, 64] strip and the
             one process's [1, 1024, 1024, 64] for (a), [1, 258, 512, 64]
             and [1, 512, 512, 64] for (d) and (e), bf16 and float32), then
             timed.  Then
             the train step: 512² tiles, batch 8, bf16 compute with float32
             parameters, SGD with momentum 0.9 and a poly schedule (base_lr
             0.01, power 0.9, 1000 iterations), built through ``builder`` and
             ``parallel.spmd``; two warm-up and ten timed steps, one K8
             launch per step, a finite loss and grad_norm every step,
             parameters still float32, running statistics finite and moved;
             the step's FLOPs counted once by ``FlopCounterMode`` for MFU.
             Then the gradients of 2 tiles at float32 compute through K8
             against ``maxpool_impl='reduce_window'``.  Then one 4096² scene
             through ``tiled_inference`` (512² tiles, stride 512,
             ``tile_batch=8``, bf16): no K8 launch, as K8 is a backward.
6. layernorm — the fused LayerNorm's forward (K4) and backward (K5) against
             their plain versions at DinoSeg's shape ([8232, 1024] bf16,
             float32 γ and β), in float32, at [37, 203] (a width off the
             16-byte vector: the element-by-element path), at [517, 768]
             (partial last CTAs) and at [300, 4096] (K5's two-sweep path),
             each on the K5 path the wrapper predicts and the kernel takes;
             K4's y against a float64 LayerNorm within half an ulp plus
             the float32 statistics' error, element by element, at every
             case on these inputs and on those of ``LN_SEEDS`` more
             generator states (``ln_float64_excess``);
             two K5 calls on the same inputs must give the same bits; then
             each timed beside its bound, its plain version and the
             library's LayerNorm forward and backward, K5 split by kernel
             (rows, partial sums).
7. fused-LN DinoSeg — the DinoSeg ViT-L/16 of phases 3 and 4 built with
             ``EVER_FUSED_LN=1``, full depth: 2 + 10 train steps at 512² B=8
             (49 K4 and 49 K5, 24 K1 and 24 K2 launches a step), 2 tiles'
             gradients against the default-LN model with the same weights,
             one 4096² scene in bf16 (392 K4 and 192 K1 launches) and one
             tile batch against the default-LN model.
8. quant   — the int8 serving layer: the quantize pass (K6) against its plain
             version, exactly, in both rounding modes at the three shapes of
             ``tools/quant_check.py``, the stochastic mode's error statistics
             at [32808, 4096]; the int8 matmul (K7) against its plain version,
             exactly, at [32808, 4096] x [4096, 1024] (ViT-L/16's fc2 over 8
             tiles of 1024²), (300, 128, 130), a K of 80 with N = 257 (TMA's
             zero fill past K) on its ``wgmma`` path, and on its ``mma.sync``
             path a K of 45 and an x_q off 16-byte alignment, each case
             checking that the wrapper and the kernel pick the path it wants;
             ``QuantDense.from_params`` of a seeded [4096, 1024] kernel with
             bias, applied to [32808, 4096], against float32 within 1.1× the
             error its stochastic rounding noise predicts (the card's
             default), and the same product composed from K6 to nearest and
             K7 within 0.02 (``tools/quant_check.py``'s limit); then K6,
             K7 and the layer timed beside bounds, plain versions and library
             calls.
9. trainer — the config-driven run: the project template's
             ``configs/dinoseg_vitl_loveda.py`` as it is (DinoSeg ViT-L/16 in
             bf16, AdamW, cosine with warmup, ``grad_clip``) with its data
             replaced by seeded in-memory crops (16 of 512², batch 8; 4
             test scenes of 1024², batch 2) and its run cut to 8 steps,
             through ``get_trainer('th_ddp', argv=...)().run()``: finite
             losses, the last checkpoint in ``checkpoint_info.json``, and
             exactly 24 K1 launches a train step and an eval batch and 24 K2
             a train step; the automatic evaluation's confusion matrix,
             counted on the card, equal to ``np.bincount`` of the same
             predictions on the host; a resume to 10 steps against 10 steps
             at once, bit for bit; the trained model under
             ``tiled_inference(tta='d4')`` (one 1024² scene, ``tile_batch=2``:
             16 tiles and 24 K1 launches a call) against per-tile ``tta()``
             calls; and the times: ms/step through the ``Launcher`` (a
             12-step run without periodic checkpoints, its loop under
             ``torch.cuda.set_sync_debug_mode('error')``, and the 8-step run
             with one every 2 steps) beside the bare train step, the
             checkpoint saves, s per evaluated scene, tiles/s with and
             without TTA, each with the card's name and power limit.
10. workflow — the user's workflow from files on disk: ``python -m
             ever_tpu_torch create`` makes a project (scripts that import
             ``ever_tpu_torch`` alone, the template's configs); a seeded
             LoveDA tree of 1024² RGB PNG scenes (2 domains x 4 train, x 1
             val) written by the port's codec with the five row filters in
             turn, each decoded exactly, and the decode ms per scene; a
             seeded ViT-L/16 state_dict in the reference DINOv3 layout
             (``qkv.bias_mask``, ``mask_token``, ``rope_embed.periods``) as
             ``GLOBAL.weight.path``: every trunk tensor loaded bit-equal to
             the file's converted one, the head reported missing; the
             project's ``train.py`` on ``configs/dinoseg_vitl_loveda.py``
             (6 steps, 4 loader workers, one checkpoint, evaluation of the 2
             val scenes): finite losses, 24 K1 and 24 K2 a step, data ms a
             step from disk; the prefetcher held against a delayed copy
             stream; the same run with ``train.iterator_type='prefetched'``
             and its loop under ``set_sync_debug_mode('error')``: losses and
             final parameters bit-equal; the project's ``infer.py``
             ``build_from_model_dir``: the last checkpoint, parameters and a
             val scene's forward bit-equal to the trained model's, then
             ``tiled_inference`` of both val scenes (finite probabilities
             summing to 1, mIoU, tiles/s); ``configs/farseg_r50_loveda.py``
             at batch 8 with ``maxpool_impl='pallas'``, ``freeze_at`` 2 and a
             seeded torchvision ResNet-50 file: 1 K8 a step, the encoder
             loaded bit-equal to the file, the stem and layer1 unchanged and
             every other parameter moved after 4 steps; ``GeoTileDataset``
             over two PNG scenes and a ``.npy`` scene: ``read_batch`` through
             the host library equal to the per-item path.
11. ddp    — data parallel over processes, on the one card (phase_ddp): a
             project from ``create`` and a seeded LoveDA tree (16 train
             scenes of 512², read whole, no-data corners of three sizes in
             turn; 3 val scenes of 1024²).  (a) its
             train.py under ``torchrun --standalone --nproc_per_node 1`` on
             ``configs/dinoseg_vitl_loveda.py`` (4 steps, NCCL): an
             ``SPMDTrainer`` over an NCCL group, 24 K1 + 24 K2 a step, its
             losses and final state bit-equal to ``--trainer base``'s, the
             ms/step of both (the two runs side by side on the card).
             Then two gloo ranks sharing the card, started by this script
             (``--ddp-worker``): (b) ``configs/
             farseg_r50_loveda.py`` at a global batch of 16, K8, float32,
             TF32 off, deterministic cuDNN, 4 steps with a checkpoint after
             each: one K8 a rank a step, the ranks' states bit-equal, the
             checkpoints' keys a one-process run's; one process (the base
             trainer on the same global batches,
             ``data.distributed.global_batches``) stepping from the 2-rank
             state before each of steps 1-2: loss and new state within
             1e-4 (the coupled steps are chaotic, so each step starts from
             the 2-rank state); the step-2 checkpoint resumed to 4 in 2
             processes bit-equal to the unbroken run;
             (c) the DinoSeg config, 4 a rank, 2 steps: 24 K1 + 24 K2 a rank
             a step, the ranks bit-equal, losses within 1e-3 of one
             process's; (d) the distributed evaluation of the val scenes (2
             and 1 a rank) equal to one process's confusion matrix; (e)
             ``tiled_inference(mesh=)`` of a 4096² scene at stride 384 (121
             tiles, 64 slots a rank) within 1e-6 of one process, after
             checking that a tile's output does not depend on its slot in
             the batch.  ms/step of each labelled with its backend, the
             bytes all-reduced a step, the phase's seconds.
12. models — the rest of the ported models (``phase_models``): a project
             from ``create`` and a seeded LoveDA tree (16 train scenes of
             512², 2 val scenes of 1024²).  (a) ``LoveDA(layout='s2d')``
             items equal to the port's ``SpaceToDepth`` of the ``'hwc'``
             items bit for bit, masks at full resolution, and
             ``GeoTileDataset(layout='s2d').read_batch`` through the host
             library equal to its per-item path; (b) FarSeg++-R50 from a
             config written beside ``configs/farseg_r50_loveda.py``
             (``relation_type='v2'``, channel dropout 0.1,
             ``stem='s2d_input'``, K8, LoveDA ``layout='s2d'``, batch 8 of
             512², bf16, SGD momentum 0.9 + poly) through the project's
             train.py: 3 steps, a resume to 6, against 6 steps at once and
             the evaluation of the val scenes, deterministic cuDNN: finite
             losses, 1 K8 a step, the dropout masks differing between steps
             and bit-equal across the repeat, the resumed state bit-equal
             to the unbroken run's, the card's confusion matrix equal to
             ``np.bincount`` on the host; ms/step through the ``Launcher``
             and of the bare step, and its FLOPs for MFU; (c) the trained
             ``state_dict`` in a ``stem='s2d'`` model on the unfolded val
             scenes bit-equal to the ``s2d_input`` model on the folded ones;
             (d) that model through ``tiled_inference`` over a 4096² scene
             (bf16, 512² tiles, stride 512, ``tile_batch=8``): finite
             probabilities summing to 1, no K8; (e) at full width, one
             forward and backward at B=2, 512², bf16 of FarSeg-R50 with
             ``se_ratio=16``, with ``gc_ratio=1/16``, FarSeg++ with the
             decoder's ``norm='gn'``, ``align_corners`` and classifier
             dropout 0.1, and FPNs with ``top_blocks='p6p7'`` and
             ``'maxpool'`` over ResNet-50 features: finite, 1 K8 each, three
             repeats from the same state and generator bit-equal to the
             first (the corner-aligned resizes are matrix products), the
             median ms; (f) ``vitl16_sat493m`` with
             ``untie_global_and_local_cls_norm``, bf16, train mode, RoPE
             rescale, over [2 global crops of 512², 8 local crops of 112²]
             with ``DINOHead`` (65536 out, hidden 2048, bottleneck 256) on
             each crop's cls token and a sum loss: 24 K1 and 24 K2 a forward
             and backward (the local crops' 54 tokens take the plain path),
             gradients against the same pass with plain attention in
             float32 (TF32 off): ``||dg||/||g||`` and the worst per-tensor
             1 - cosine each at most ``MULTICROP_REL_RATIO`` (1.25) times the
             plain bf16 path's, the worst cosine at least
             ``MULTICROP_COS_FLOOR`` (K1/K2 against plain bf16 printed too),
             ``local_cls_norm``'s gradient non-zero and from crop 1 alone.
             The phase's K1, K2 and K8 launches join the kernels line.
13. change — FactSeg and the change detectors from the project template's
             configs (``phase_change``): a project from ``create`` and seeded
             trees of 1024² PNG scenes written by the port's codec (iSAID:
             8 train and 2 val, devkit-palette masks with an off-palette
             square each; LEVIR-CD: 8 train and 2 test pairs, grey 0/255
             labels; xView2: 8 train and 2 hold pairs, targets 0..5).
             (a) the ``ISAID``, ``LEVIRCD`` and ``XView2`` items finite, their
             labels in their sets, the whole scenes' labels the written ones
             (off-palette colours and damage 5 read as 255); (b)
             FactSeg-R50 from a config written beside
             ``configs/factseg_r50_isaid.py`` (batch 8 of 512² crops, K8,
             bf16, SGD + poly) through the project's train.py, 2 steps and a
             resume to 4 against 4 at once, deterministic cuDNN: finite
             ``cls_loss``, ``fa_loss`` and ``dice_loss``, 1 K8 a step, the
             resumed state bit-equal, the evaluation's confusion matrix equal
             to ``np.bincount`` on the host; ms/step through the ``Launcher``
             and of the bare step with its FLOPs for MFU; a 4096² scene
             through ``tiled_inference`` (bf16, 512² tiles, stride 512,
             ``tile_batch=8``): joint probabilities finite and summing to 1,
             no K8; (c) ChangeStar-R18 (SGD) and ChangeMask-R18 (AdamW +
             cosine) from configs beside theirs on the LEVIR-CD tree, batch
             8 of 512² pairs, K8, bf16, 3 steps each: ChangeStar's
             ``seg_loss`` exactly 0 (the masks are all ignored) with a zero
             gradient to ``seg_cls`` and 1 K8 in that backward, finite
             change and consistency losses, 1 K8 a step (one encoder pass
             over both dates), the auto-routed change evaluation's 2 × 2
             matrix equal to the host's, the bare steps timed (after a
             counted and two warm-up steps, ten by CUDA events: median, min
             and max, as every bare step); (d) ChangeOS-R50 the same on the xView2 tree, its
             damage evaluation's 5 × 5 matrix, and a 4096² pre/post scene
             (6 channels) through ``tiled_inference`` with a ``predict_fn``
             concatenating ``(loc_prob, damage_prob)``: finite, the damage
             channels summing to 1, no K8.  Cuts of the configs:
             ``total_batch_size`` 32 or 16 → 8, ``num_iters`` → 6 or 3,
             ``maxpool_impl='pallas'``; widths, bf16, optimizers and
             schedules as written.  The phase's K8 launches join the
             kernels line.
14. user   — a user's own model trained with the reader's augmentations
             (``phase_user``): (a) ``preprocess.device.batch_augment`` of 8
             seeded uint8 scenes of 1024² and their masks (a 512² crop, a
             symmetry of the square, the normalisation) under
             ``torch.cuda.set_sync_debug_mode('error')``: each sample
             exactly the plain evaluation of its draws (the window, its
             ``rot90``/flip, then normalised), all 8 symmetries over 64
             calls, ms a batch by CUDA events; (b) a project from
             ``create``, a seeded LoveDA tree of 1024² PNGs (8 train and 2
             val scenes), a ``module/user_farseg.py`` registering a
             FarSeg-R50 (``maxpool_impl='pallas'``) through the port's
             public imports whose train forward returns OHEM of the
             per-pixel CE (keep 0.25), a focal Tversky loss (α 0.7, β 0.3,
             γ 0.75) and a label-smoothed CE (ε 0.1), and a config beside
             ``configs/farseg_r50_loveda.py`` (batch 8 of 512² crops, 4
             workers, bf16, SGD + poly, the reader's ``transforms``:
             ``RandomDiscreteScale``, ``RandomCrop``, ``RandomRotate90K``,
             ``RandomTranspose``, ``RandomHorizontalFlip``,
             ``MeanStdNormalize``); the project's train.py for 6 steps with
             ``--use_tensorboard`` and ``train.profile_dir`` over steps
             2-3: finite losses and 1 K8 a step; item 0 of the train
             dataset equal to the bare item through a copy of the
             transforms; on the first batch's logits the three losses and
             ``focal_loss`` (plain and normalised), ``sigmoid_focal_loss``,
             ``label_smoothing_binary_cross_entropy``,
             ``soft_cross_entropy``, ``dice_coeff`` and their logit
             gradients within 1e-5 of a float64 evaluation on the CPU
             (OHEM's gradient off the pixels whose CE is within 1e-5 of
             the k-th, where float32 may order them otherwise), ``select``
             exact; the trace with 2 K8 kernels and 2 ``load_data`` spans,
             its device-busy share, five kernels with the most time and
             five longest idle gaps; the TensorBoard event file with
             ``train/ohem_loss`` at every step (a line says so when
             ``tensorboard`` does not import); then ms/step through the
             ``Launcher`` of the same run untraced, with and without the
             transforms.  The phase's K8 launches join the kernels line.
15. int8   — W8A8 serving and the exported programs (``phase_int8``):
             (a) ``torch.library.opcheck`` of every op (K1, K2, K4, K5, K6,
             K7, K8 and the pool K8 differentiates) on CUDA tensors at small
             shapes, each launch counter then equal to the C calls the
             checks made; (b) phase 3's DinoSeg ViT-L/16 (bf16 parameters,
             seeded) saved through a checkpoint, ``export_model`` at
             ``(8, 512, 512, 3)`` and ``torch.export.load``: one tile batch
             through the program bit-equal to the eager model with 24 K1
             launches, a 4096² scene through ``tiled_inference`` with the
             program bit-equal to the eager scene with 192; (c) the same
             model quantized by ``ptq_quantize`` on 2 seeded batches of 8
             tiles (``min_in_features=64``): the layers the config implies
             (24 × qkv, proj, fc1, fc2, the patch embedding, the head), none
             left in floating point, one K7 launch per int8 layer call and
             24 K1 a tile batch, every K7 call of one tile batch on the
             path its operands ask for (the wrapper's and the kernel's
             choice alike) and equal to ``int8_matmul_reference`` on its
             operands (limit 0: the int32 sum is exact), the W8A8
             scene's centred cosine against the bf16 scene above 0.99, and
             ``export_model(ptq_calib=...)`` loaded back bit-equal to the
             eager W8A8 tile batch; (d) the same for FarSeg-R50 in phase 5's
             serving configuration (bf16) with the JAX test's
             initialisation, seeded (``seeded_flax_init_``): every conv
             with kh·kw·Cin/g >= 64, the stem's K of 147 on K7's
             ``mma.sync`` path and the rest on ``wgmma``, cosine above
             0.98; (e) the LR range test: FarSeg-R50 through
             the ``Launcher`` for 12 steps on in-memory crops under the
             ``search`` schedule (1e-5 to 0.1) with
             ``PlotLearningRateAndLoss``: 12 CSV rows, each LR the
             schedule's, finite losses, one K8 a step; (f)
             ``PadCropWrapper(FarSeg-R50)`` on [2, 500, 500, 3] bit-equal to
             a manual pad, run and crop, its ``state_dict`` the model's;
             (g) the times, with the card's name and power limit: W8A8
             against bf16 per tile batch and per scene for both models,
             export and load seconds, and a ``torch.profiler`` split of one
             W8A8 FarSeg tile batch into K7, the im2col gather, the
             activations' quantize and the rest.  The phase's K1, K7 and
             K8 launches join the kernels line.
16. zoo    — HRNetV2 and the segmentation heads (``phase_zoo``), each model
             a user's ``ZooSeg`` (``register_zoo_model``: a registered
             encoder, ``ListIndex`` of the features, a registered head, a
             CE loss) at full width and depth, 7 classes, 512² tiles, bf16
             compute, float32 parameters, SGD momentum 0.9 + poly:
             HRNet-W32 + ``HRNetHead``; DeepLabv3+ (``Deeplabv3pHead`` on
             [c2, c5]) on ResNet-50 at output stride 16; DeepLabv3
             (``ASPPHead``) and PSPNet (``PPMHead``, bins 1, 2, 3, 6) on
             ResNet-50 at output stride 8; the ResNets with
             ``maxpool_impl='pallas'``.  (a) at B=8: 2 warm-up steps and
             10 timed ones for HRNet-W32 and DeepLabv3+, 3 for DeepLabv3
             and PSPNet (median, min-max, tiles/s, MFU from
             ``FlopCounterMode``); every model: 3 steps twice from
             one seeded state under deterministic cuDNN, losses,
             parameters and BatchNorm statistics bit-equal; finite
             losses; one K8 a ResNet step, none for HRNet.  (b) each model
             over a 4096² bf16 scene (512² tiles, stride 512,
             ``tile_batch=8``) after a warm-up scene: finite
             probabilities summing to 1, no K8; ms/scene and tiles/s.
             (c) HRNet-W32 from a config (``frozen_stages=1``) through
             ``get_trainer('th_ddp')`` and the ``Launcher`` on in-memory
             crops: 2 steps with a checkpoint, a resume to 4, against 4 at
             once: the logged losses of steps 3-4 and the final states
             bit-equal, the stem and layer1 unchanged and every other
             parameter moved.  (d) a seeded HRNet-W32 state_dict in the
             reference ``_hrnet.py`` layout with ``module.`` prefixes (and
             the classification neck and counters) through
             ``load_weights`` into ``HRNetEncoder`` on the card and on the
             CPU: no missing, unexpected or mismatched key, every tensor
             the file's, float32 eval features within ``ZOO_WEIGHT_TOL``
             of the CPU's.  (e) the times with the card's name and power
             limit; ``--profile`` splits one HRNet-W32 and one
             DeepLabv3+ step by kind of kernel (convolutions, BatchNorm,
             the resizes' and pools' matrix products, the adds).  The
             phase's K8 launches join the kernels line.
17. backbones — EfficientNet with BiFPN, DenseNet, ResNeSt and ConvNeXt
             (``phase_backbones``), each a user's ``ZooSeg`` (a registered
             encoder, ``ListIndex``, a ``neck`` of ops from the ``OP``
             registry or ``ever_tpu_torch.module``, a registered head or
             a 1×1 classifier, a CE loss) at full width and depth, 7
             classes, 512² tiles, bf16 compute, float32 parameters, SGD
             momentum 0.9 + poly: B0-BiFPN (EfficientDet-D0's widths: B0's
             taps os4-os32 reduced to 64 by a 1×1 conv-BN each, three
             ``BiFPN(64, (4, 8, 16, 32))``, a 1×1 classifier on the os4
             output, ×4 bilinear; drop-connect on); DenseNet-121 and
             ConvNeXt-T (drop-path 0.1) under ``FPN`` (256) and
             ``AssymetricDecoder`` (128, to os4, its classifier ×4), as
             FarSeg's decoder; ResNeSt-50 at output stride 8 under
             ``ASPPHead`` (DeepLabv3).  (a) at B=8: 2 warm-up steps and
             10 timed ones for B0-BiFPN and ConvNeXt-T, 3 for the others
             (median, min-max, tiles/s, MFU from ``FlopCounterMode``: 3 ×
             the forward's count, as the step's own count takes a grouped
             conv's backward for an ungrouped one); every model: 3 steps
             twice from one seeded state, first with cuDNN as it is
             and, where those differ (the differing tensors printed),
             under deterministic cuDNN: losses, parameters and
             BatchNorm statistics bit-equal, the drop-connect and
             drop-path draws from the step's generator; finite losses.
             (b) each model over a 4096² bf16 scene (512² tiles, stride
             512, ``tile_batch=8``) after a warm-up scene: finite
             probabilities summing to 1; ms/scene and tiles/s.  (c)
             B0-BiFPN from a config through ``get_trainer('th_ddp')`` and
             the ``Launcher`` on in-memory crops: 2 steps with a
             checkpoint, a resume to 4, against 4 at once, drop-connect
             on: the logged losses of steps 3-4 and the final states
             bit-equal.  (d) a seeded state_dict in each reference layout
             (``efficientnet_pytorch`` B0 with ``_conv_head``/``_bn1``/
             ``_fc``, torchvision DenseNet-121 with ``norm5`` and
             ``classifier`` saved with ``module.`` prefixes, ``resnest50``
             with ``fc``, DINOv3's ConvNeXt-T with ``norm``/``head``; the
             counters) through ``load_weights`` into its encoder on the
             card and on the CPU: no missing, unexpected or mismatched
             key, every tensor the file's, float32 eval features within
             ``BACKBONE_WEIGHT_TOL`` of the CPU's.  No kernel of the port
             is launched in (a)-(c).  (e) the times with the card's name
             and power limit; ``--profile`` splits one B0-BiFPN and one
             ConvNeXt-T step by kind of kernel (convolutions, depthwise
             ones apart, BatchNorm and LayerNorm, SiLU/sigmoid/GELU, the
             resizes' matrix products, concatenations, adds) with the
             card's busy share: the kernels' sum over the median step
             timed without the profiler, which stretches the step it
             traces.
18. vitencoder — ``ViTEncoder`` (``vit_large``, patch 16, 4 storage
             tokens; the taps of blocks 5, 11, 17 and 23 resized to output
             strides 4-32 by matrix products) under ``FPN`` (256) and
             ``AssymetricDecoder`` (``FPN_DECODER``), a user's ``ZooSeg``
             from the registries, 7 classes, seeded weights, bf16 compute,
             float32 parameters, AdamW + cosine (``phase_vitencoder``):
             (a) 2 warm-up and 10 timed steps at 512², B=8: 24 K1 and 24
             K2 launches a step and no other kernel, finite losses,
             median ms/step, tiles/s, MFU by 3 × the forward's
             ``FlopCounterMode`` count (with plain attention, which it can
             count), peak memory; (b) 2 tiles' gradients through the
             kernels against plain attention: with the decoder's
             BatchNorms training (printed, beside plain attention in bf16
             against float32: those BatchNorms amplify any bf16 rounding
             alike), and gated with them frozen, at phase 4's limits; (c)
             2 steps twice from one state, bit-equal with cuDNN as it is;
             (d) one 4096² scene through ``tiled_inference`` (512² tiles,
             ``tile_batch=8``): 192 K1 launches and no other, finite
             probabilities summing to 1; (e) ``Fp8Linear`` at ViT-L's
             fc1 ([8232, 1024] → 4096) and fc2 ([8232, 4096] → 1024) and
             ``Fp8LinearKMaskedBias`` at its qkv (→ 3072): one K7 launch a
             call, equal to the bit to the plain version (``scale`` and
             ``int8_matmul_reference``, plus the bias), timed against the
             bf16 ``nn.Linear``; (f) their straight-through backward:
             finite gradients; (g) ``LinearW24`` at the same widths: the
             two largest |w| of every four kept, equal to the masked dense
             product, timed.  The phase's K1, K2 and K7 launches of (a),
             (d) and (e) join the kernels line.
19. freenet — ``FreeNet`` at its default widths ((96, 128, 192, 256),
             float32, TF32 off, batch 1 whole scene) on two scene
             geometries of the FreeNet/FPGA paper's benchmarks (Zheng et
             al., IEEE TGRS 2020): Indian Pines (145×145, 200 bands, 16
             classes) and Pavia University (610×340, 103 bands, 9
             classes), seeded scenes with about 5 % of the pixels labelled
             and the rest 255 (``phase_freenet``): 2 warm-up and 10 timed
             SGD steps (momentum 0.9, poly): finite losses, every
             parameter moved, median ms/step, scenes/s, MFU against the
             float32 peak (3 × the forward's ``FlopCounterMode`` count);
             2 steps twice from one state, bit-equal with cuDNN as it is
             or, where those differ (printed), under deterministic cuDNN;
             the whole-scene forward timed, probabilities summing to 1; no
             kernel of the port launched.  Then a seeded archive in the
             JAX package's ``.npz`` layout through ``load_weights``
             (``convert_flax_freenet``) on the card and on the CPU: every
             tensor the archive's, float32 probabilities within
             ``FREENET_WEIGHT_TOL``.
20. gan    — the DCGAN at its registered widths (64², 3 channels, latent
             128, base width 64; ``phase_gan``) with Adam lr 2e-4, beta1 0.5
             for both roles (Radford, Metz and Chintala, ICLR 2016), batch
             128 of seeded in-memory images in [-1, 1], float32, TF32 off,
             through ``get_trainer('gan_th_ddp')``: (a) every logged
             metric (``D_d_loss``, ``D_d_real_acc``, ``G_g_loss``, both
             grad norms and learning rates) finite and every tensor of
             both roles moved; (b) 6 steps and a resume to 10 (a checkpoint
             every 2 steps, deterministic cuDNN) against 10 at once: the
             final state and the logged metrics of steps 7-10 bit-equal;
             (c) two gloo ranks on the card (64 each, the parallel
             phases' ranks) against one process on the same global batches for 3
             steps: the ranks bit-equal, step 1's D loss and gradient norm
             within ``GAN_DDP_FIRST_TOL`` (the norm is that of the
             averaged gradient), G's within ``GAN_DDP_G_TOL``, the
             parameters after 3 steps within ``GAN_DDP_TOL``; (d) no
             kernel of the
             port launched (the JAX DCGAN reaches no Pallas kernel); then
             the bare step's median ms over 10 after 2 and its MFU (3 × the
             forward's ``FlopCounterMode`` count of ``d_loss`` and
             ``g_loss``, against the float32 peak).
21. zero   — ZeRO-1/3 (``phase_zero``): DinoSeg ``vitl16_sat493m`` at 512²,
             bf16 compute, float32 parameters, AdamW + cosine, the same
             seeded weights on two gloo ranks on the card (the parallel
             phases' ranks), 4 tiles a rank; 3 steps each of replicated DDP,
             ZeRO-1 and ZeRO-3: (a) the ZeRO parameters against the
             replicated run's after step 1 within ``ZERO_FIRST_TOL`` and
             after step 3 within ``ZERO_TOL`` (bit-equality printed); (b)
             each rank's optimizer-state bytes, and under ZeRO-3 its
             parameter bytes, read from its own tensors, at most half the
             replicated run's plus 1 MiB; (c) the ZeRO-3 state at step 2
             saved with ``checkpoint_backend='orbax'`` and
             ``'orbax_async'`` + ``wait()`` (the same contents), restored
             sharded into a fresh ZeRO-3 state whose step 3 equals the
             unbroken run's bit for bit; (d) exactly 24 K1 and 24 K2
             launches a step on each rank, which join the kernels line;
             (e) ZeRO-3 gathers a unit at a time (each block, the root for
             the step): the whole parameter and gradient bytes a rank holds
             at once at most two units' worth, on both ranks; ms/step and
             step 3's peak memory above what a rank holds at rest
             (``max_memory_allocated``) of each layout with the card's
             name and power limit.
22. layouts — the model-parallel layouts (``phase_layouts``) over two gloo
             ranks sharing the card (the parallel phases' ranks),
             the same seeded weights in every process: (a) DinoSeg
             ``vitl16_sat493m`` built through ``builder`` under tensor
             parallel on ``make_hybrid_mesh(('data', 'model'), (1, 2))`` (a
             dcn axis of 1), ``create_train_state_sharded(level=3,
             tp_axis='model')``, AdamW with the template config's cosine
             schedule and ``grad_clip``, bf16 compute, float32 parameters,
             B=8 at 512²: the first step's gradients (gathered) against one
             process on the same weights and batch within phase 4's
             ``GRAD_REL_TOL`` and ``GRAD_COS_MIN``; 2 warm-up and 2 timed
             steps with finite losses and gradient norms and exactly 24 K1
             and 24 K2 launches a rank a step (8 heads a rank); each rank
             holding at most half the split leaves' bytes plus 1 MiB; one
             rank's attention at B=8, H=8, N=1029, D=64 against its plain
             version at phase 2's limits; the state after the warm-up
             saved with ``'orbax'`` and ``'orbax_async'`` + ``wait()`` (each
             rank its shards, the split leaves over both axes) and
             restored into a fresh TP + ZeRO-3 state whose next step equals
             the first timed step bit for bit (the loss and every gathered
             parameter), the GiB written and the seconds to save and
             restore.  (b) the ViT-L/16 trunk through
             ``pipelined_vit_apply`` on ``('pipe',)`` = 2 stages of 12 blocks,
             B=8 at 512², 4 microbatches (the bubble's ticks skipped: 48 K1
             and 48 K2 launches a stage a forward and backward): the patch
             tokens and the input and parameter gradients of
             ``sum(x_norm_clstoken²)`` against the plain trunk at phase 4's
             limits, each stage holding its 12 blocks alone, its hops'
             bytes and ms.  (c) ``MoEMlp(num_experts=8, hidden=4096, k=2)``
             at width 1024 on 8 × 1029 tokens, float32, TF32 off, on
             ``('expert',)`` = 2: output, auxiliary loss and every gradient
             against one process within ``EP_REL_TOL``, 4 experts a rank, no
             port kernel launched.  ms/step or ms/call of each layout beside
             one process's, the backend, the bytes moved, the card's name
             and power limit; one card shows correctness and bytes held, not
             a multi-card speed.  The phase's K1 and K2 launches of (a) and
             (b) join the kernels line.
23. spatial — the spatial layouts (``phase_spatial``): one process first
             runs the references on the whole tiles, then two gloo ranks
             share the card (the parallel phases' ranks) on
             ``make_mesh(('data',))`` with the same seeded weights: (a)
             phase 5's FarSeg-R50 (K8, 7 classes, SGD momentum 0.9 + poly)
             on one 2048² tile with labels in [0, 7), split into two strips
             of 1024 rows by ``build_spatial_train_step``: the first step
             at float32 compute, TF32 off, against one process's
             ``build_train_step`` on the whole tile (``total_loss`` within
             1e-5 relative; every parameter and running statistic within
             rtol 1e-3, atol 2e-5, ``tests/test_spatial_train.py``'s limits;
             the worst distances printed; the ranks' states bit-equal); then
             bf16 compute, float32 parameters, 2 warm-up and 2 timed steps a
             rank: finite losses and gradient norms, exactly one K8 a rank a
             step and no other port kernel (they join the kernels line); the
             halo broadcasts and bytes a step, ms/step against the one-process
             step at 2048², peak memory a rank against its.  (b) a
             resolution-preserving net (four 3×3 convs of 64 with ReLU, a
             1×1 head) on a 4096² float32 tile, halo 8:
             ``spatial_partition_apply`` ``'exact'`` within 1e-5 of the
             whole forward, ``'zeros'`` within it off the true border, one
             ``build_halo_train_step`` step's parameters within 1e-5 of the
             unsharded step's.  (c) ``util.eda`` without PIL: ``thumbnail``
             of a 2048² RGB PNG (and of a constant grey one: its value
             kept) and ``render_multi_binary_mask`` of three 512² masks the
             phase writes with ``write_png``, their shapes.  (d) FarSeg++-R50
             (``relation_type='v2'``, channel dropout 0.1, the decoder's
             ``norm='gn'``: GroupNorm on the strips, and on the pooled scene,
             whole on every rank) and (e) FarSeg-R50 on a ResNet-50 with
             ``se_ratio=16`` and ``gc_ratio=1/16`` in every bottleneck (the
             squeezes and the GC block's softmax pool summed over the
             strips), each on one 1024² tile as two strips of 512 rows,
             with (a)'s gates: the float32 first step against one process,
             where a tensor's limit is widened to twice one float32
             process's distance from its float64 step when that distance
             passes half the limit (``SPATIAL_NOISE_FACTOR``: (e)'s GC
             transforms), then 1 warm-up and 2 timed bf16 steps a rank,
             one K8 a rank a step ([1, 258, 512, 64]) and no other port
             kernel.  (f) DinoSeg ViT-L/16 (``vitl16_sat493m`` at full width
             and depth, RoPE rescale on, 7 classes, AdamW at a constant
             ``SPATIAL_VIT_LR``) on one 1024² tile as two strips of 512 rows:
             a rank's 2053 queries (the prefix and its 32 patch rows)
             attend to the tile's 4101 keys, gathered by one broadcast a
             rank a block; the float32 first step (TF32 off) with ``remat``
             None and ``'full'`` against one process's on the whole tile
             with (a)'s gates, and its gradients within
             ``SPATIAL_GRAD_TOL`` (||Δg|| / ||g||), 24 gathers (and 24 more
             in the recomputation with ``'full'``), the ranks' states
             bit-equal; then 1 warm-up and 2 timed bf16 steps a rank:
             finite losses, exactly 24 K1 and 24 K2 launches a rank a step,
             all at [1, 2053, 16, 64] queries against [1, 4101, 16, 64]
             keys, and no other port kernel (they join the kernels line);
             the gathered MiB, ms/step against one process's and peak
             memory a rank.  (g) a user's ViTEncoder ViT-L/16 (4 storage
             tokens, 24 blocks) under FPN + AssymetricDecoder
             (``VITENC_MODEL``) on the same tile and strips with (f)'s
             optimizer, steps and gates: its taps resized by the strip
             forms (the os32 tap's antialiased halving), the same 24 K1 and
             24 K2 launches a rank a step at the same shapes.  (h)
             FarSeg-R50 with ``stem='s2d_input'`` (K8 at the stem) on the
             same tile folded to [1, 512, 512, 12]: its float32 strip step
             against one process's ``stem='conv'`` step on the unfolded
             tile with (d)'s gates (the limits that one process's float64
             step sets: the stem conv's gradient sums a 1024² tile through
             a BatchNorm), and the bits of the same weights' ``stem='conv'``
             strip step; one K8 a rank a step.  (i) FreeNet
             at its default widths on one 1024×512 scene of 200 bands, 16
             classes, 5 % of its pixels labelled: its spectral gates
             squeezed over the tile, with (a)'s gates, no port kernel.  (h)
             and (i) take 2 bf16 steps a rank.  Every peak a rank is read
             above what the process held after a collection (DDP's wrapper
             holds reference cycles), and printed beside one process's.
24. report — a ``{"kernels": [...]}`` line, the card's name and power limit,
             and the result line ``{"ok": true, "device": {...}}``.

The phases run in three streams after ``ddp``.  The parallel phases
(20-23) share one pair of gloo ranks (``start_parallel``: ``--ddp-worker
parallel`` runs the gan, zero, layouts and spatial workers in turn after
the spatial phase's one-process references); the phases zoo, backbones,
vitencoder and freenet (16-19) run in one process of their own
(``start_side``: ``--side``, on a generator seeded anew); this process
runs models, change, user and int8 (12-15) meanwhile, then prints the
side process's output and reads the ranks phase by phase.  The phases
before them run alone, so the kernels' times and the trainer's, the
workflow's and ddp's clocks are a card to themselves; from models on a
time shares the card and the host's cores with the other streams.

Cuts that keep the script within 1100 s with the ``spatial`` phase (the
phase took 61.7 s alone on an H100 80GB HBM3 at 700 W, and a whole run
with the last two cuts alone 1161.7 s on a slow host): the parallel
phases' ranks start once instead of four times (each pair of processes
took about 17 s of start-up and initialisation; the four phases 125-138 s
together against about 263 s apart); ``ddp`` (b) holds one process to the
2-rank steps 1-2 (was 1-4) and no longer prints the 3 coupled steps in one
process or the 1-process resume (two trainer runs that gated nothing;
about 30 s); ``layouts`` (a) times 3 steps after the warm-up (was 5; about
7 s).  The ZeRO-3 step gathered block by block and the TP directories'
saves and restores added about 45 s to the parallel phases (181 s against
125-138); for them ``ddp`` (b) trains 4 steps and resumes from step 2 (was
6 and 3) and ``change`` (b) trains FactSeg 4 steps and resumes from step 2
(was 6 and 3).  (d) and (e) added 20-45 s (the references 13-21 s, the
ranks 7-25 s more; the whole script took 1166 s on a slow host, its
`ddp` phase 249 s against 198-213 before them); for them ``spatial`` (a)
times 2 steps after its warm-up (was 5; 2.4-4.5 s) and ``layouts`` (a)
2 (was 3; about 3.4 s).  (f) added about 35 s (the references 5 s, the
ranks 29 s; the whole script 1097 s on an H100 80GB HBM3 at 700 W); for it
(f) builds one model a process and one step a rank, and runs the float32
steps with ``remat`` None and ``'full'`` and the bf16 steps from the same
weights (``fresh_start``: each model build and DDP wrapping of ViT-L
costs a few seconds), and rank 0 compares its states and gradients with
one process's on the card.  The driver's check stopped that script after
1200 s on its host, and the same tree took 1269 s on another (913 s of
serial phases, then the parallel ranks' 323 s): for the streams above
and the limit, the parallel ranks run beside models to int8 (about 190 s
of 208-323 hidden), the side phases beside them too (about 150 s),
``ddp`` (a)'s torchrun and base-trainer runs side by side (82-122 s
alone, 44 s together), and the trainer phase's fresh 10-step run saves
its 3.6 GB checkpoint once instead of every 2 steps (5 saves, about 20
s; the 8-step run's saves give the per-save times).

``--profile`` adds ``torch.profiler`` traces of one tile batch and one train
step of each model, and of one fused-LN DinoSeg train step: device busy time
against wall time, device time by kind of kernel, and the kernels that take
the most of it.

It imports nothing of JAX and needs one CUDA card; without one it exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import gc
import hashlib
import inspect
import json
import math
import os
import subprocess
import sys
import time

import torch

# H100 SXM dense peaks (NVIDIA data sheet), for the bound
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

B, H, S, D = 8, 16, 1029, 64          # the main path's attention shape
EMBED = H * D                         # ViT-L width
SCENE, TILE, STRIDE, TILE_BATCH, CLASSES = 4096, 512, 512, 8, 7
# kernel vs plain version (f32 from the same inputs).  The kernel rounds the
# rotated, scaled q and K (and, from f32 inputs, V) to bf16 for the tensor
# cores, P to bf16 for P·V, and writes o in the input type.  With N(0, 1)
# inputs the softmax spreads over hundreds of keys, so o is small (max |o|
# a few tenths, mean |o| a few hundredths): the o limits sit on that scale,
# as the largest error and as the relative RMS error ||do|| / ||o||, which a
# fault in P·V (a wrong V row in a tile) moves far more than rounding does.
# lse is about log(S) ~ 7, so its limit is a fraction of a percent.
ATTN_O_MAX_TOL, ATTN_O_RMS_TOL, ATTN_LSE_TOL = 8e-3, 1e-2, 2e-2
# K2 vs its plain version (f32 from the same inputs, real rows), on each
# gradient's own scale: the largest error against the gradient's largest
# value, and ||dg|| / ||g||.  The kernel rounds scale*rope(q), rope(k), v
# and do to bf16 (2^-9 relative each) and p and ds again before the
# products that make dq, dk and dv, so ds carries two roundings into two
# chained products: about 4e-3 relative, measured at every shape.  A wrong
# row or lane in one product (one key row of dV read from its neighbour)
# moves the relative error of that gradient to O(0.1).
ATTN_BWD_MAX_TOL, ATTN_BWD_RMS_TOL = 3e-2, 1.5e-2
# one tile batch, kernel path vs plain path, both bf16 through 24 blocks:
# the two attentions round differently in every block
SLICE_MAX_TOL, SLICE_MEAN_TOL = 5e-2, 5e-3
# the train step: DinoSeg ViT-L/16 at 512², as the JAX package's vit512
# bench section
TRAIN_BATCH, WARMUP_STEPS, TIMED_STEPS = 8, 2, 10
# useful work of one train step, as the JAX bench counts it (no remat, no
# padding): the matmuls are 24·C² FLOP per token per block forward (qkv 6C²,
# proj 2C², fc1 8C², fc2 8C²), three times that with the backward; attention
# 4·B·H·N²·D forward and 8·B·H·N²·D backward, over 24 blocks
TRAIN_FLOPS = 24 * (3 * 24 * EMBED ** 2 * TRAIN_BATCH * S
                    + 12 * TRAIN_BATCH * H * S * S * D)
# kernels vs plain attention on 2 tiles in the same train step (bf16
# compute): global ||dg|| / ||g|| and the worst per-tensor cosine.  The
# first run measured 8.8e-4 and 0.99994: the two attentions round p, ds and
# their outputs differently in every block.  The limits sit ten times
# further out; a kernel path that sends no gradient into q, k or v leaves
# the qkv weights a cosine near 0.
GRAD_REL_TOL, GRAD_COS_MIN = 1e-2, 0.999
# phase 12 (f): K1/K2's bf16 multi-crop gradients stand at most this times as
# far from plain float32 attention as the plain bf16 path does, by ||dg||/||g||
# and by the worst per-tensor 1 - cosine (both bf16 paths read 2.2-2.7e-2 from
# float32, and their worst cosines 0.9980-0.9992: the plain path itself falls
# below GRAD_COS_MIN on three of five draws; the two paths against each other
# read 7.5e-3 to 1.025e-2 over draws, so a limit on that pair sat within their
# rounding), and K1/K2's worst cosine at least MULTICROP_COS_FLOOR
MULTICROP_REL_RATIO, MULTICROP_COS_FLOOR = 1.25, 0.995
# remat='full' vs no remat: the same kernels on the same inputs, recomputed.
# Two runs without remat (printed beside it) differed by about 1e-4 while
# the logits' upsample was F.interpolate, whose CUDA backward adds with
# atomics; as two matrix products (module/ops.py upsample_bilinear) both
# comparisons read 0
REMAT_REL_TOL = 1e-3
# impl='flash' at a 2048² tile: N = 128² + 5 tokens, B=1, H=2
FLASH_N = 128 * 128 + 5
# CUDA-core float32 peak (NVIDIA data sheet): K8's compares and adds
PEAK_F32_FLOPS = 67e12
# K8 (the stem max pool's backward) at FarSeg-R50's 512², batch-8 stem
POOL_SHAPE = (8, 256, 256, 64)
# one FarSeg-R50 tile of the spatial phase (phase 23): two strips of 1024 rows
SPATIAL_TILE = 2048
# K8 in that phase: a rank's stem strip with the 2 rows it takes from the
# previous strip (514 rows: a ragged block after the output row it drops),
# and the one-process reference's whole stem
SPATIAL_POOL_STRIP = (1, SPATIAL_TILE // 4 + 2, SPATIAL_TILE // 2, 64)
SPATIAL_POOL_WHOLE = (1, SPATIAL_TILE // 2, SPATIAL_TILE // 2, 64)
# the spatial phase's (d) FarSeg++-R50 and (e) SE + GC FarSeg-R50: one tile
# of 1024² as two strips of 512 rows; K8 at a rank's strip of their stem
# ([1, 258, 512, 64]) and at the one process's whole stem
SPATIAL_MORE_TILE = 1024
# (f) DinoSeg ViT-L/16 on the same tile's two strips: a rank's queries (the
# 5 prefix tokens and its 32 × 64 patches) against the tile's 5 + 64² keys
STRIP_Q = 5 + (SPATIAL_MORE_TILE // 32) * (SPATIAL_MORE_TILE // 16)
STRIP_KV = 5 + (SPATIAL_MORE_TILE // 16) ** 2
SPATIAL_MORE_POOL_STRIP = (1, SPATIAL_MORE_TILE // 4 + 2, SPATIAL_MORE_TILE // 2, 64)
SPATIAL_MORE_POOL_WHOLE = (1, SPATIAL_MORE_TILE // 2, SPATIAL_MORE_TILE // 2, 64)
# (shape, type, ties): the main shape, in float32, the siamese detectors'
# stem (both dates of the batch stacked), an H and W that are even but
# leave a ragged block with C off the 8-wide vector (the kernel's
# element-by-element path), and small integers (many exact ties)
POOL_CASES = ((POOL_SHAPE, torch.bfloat16, False), (POOL_SHAPE, torch.float32, False),
              ((2 * TRAIN_BATCH, 256, 256, 64), torch.bfloat16, False),
              ((2, 30, 22, 5), torch.bfloat16, False), ((8, 64, 64, 64), torch.bfloat16, True))
# the spatial phase's strip and whole stem in bf16 (its timed steps) and
# float32 (its first step); drawn from a generator of their own, so that
# every later phase draws what it drew before these cases joined
SPATIAL_POOL_CASES = tuple((shape, dtype, False)
                           for shape in (SPATIAL_POOL_STRIP, SPATIAL_POOL_WHOLE,
                                         SPATIAL_MORE_POOL_STRIP, SPATIAL_MORE_POOL_WHOLE)
                           for dtype in (torch.bfloat16, torch.float32))
# K8 vs its plain version: both compare the same values exactly and sum the
# same <= 4 float32 terms before one rounding, so they should agree to the
# bit; the limit is one bf16 ulp of the largest |dx| (2^-8 relative), which
# a dropped or misplaced window term exceeds (it moves dx by a whole g)
POOL_TOL = 2.0 ** -8
# the FarSeg-R50 train step: the JAX package's farseg bench section
FARSEG = dict(encoder=dict(resnet_type='resnet50', maxpool_impl='pallas'),
              classes=CLASSES, dtype='bfloat16')
# K8 vs maxpool_impl='reduce_window' on 2 tiles at float32 compute: the two
# backwards differ at the exact ties of the stem's BatchNorm output (float32
# values of 8 M pixels: a few windows hold two equal maxima), where K8 sends
# the gradient to each and the library to one; that moves the stem's
# gradients, above all the cancelling sums of its BatchNorm's.  Two runs of
# the same step differ far less (cuDNN's backward convolutions, printed
# beside).  The first run measured 4.8e-4 and a worst cosine of 0.99987;
# the limits sit ten times further out.  A K8 that drops a window's term
# moves the stem conv's cosine far below them.
FARSEG_GRAD_REL_TOL, FARSEG_GRAD_COS_MIN = 5e-3, 0.9987
# K4/K5 (the fused LayerNorm) at DinoSeg ViT-L/16's 512² batch of 8: one
# row per token, 8 · 1029 rows of width 1024; the sat preset's eps
LN_ROWS, LN_EPS = TRAIN_BATCH * S, 1e-5
# (rows, width, type, K5's path): the main shape, in float32, a width off
# the 16-byte vector (the kernels' element-by-element path; 37 rows leave
# K5's second CTA 5 rows), 517 rows (K4's last CTA 5 rows of 8, K5's 5 of
# 32), and a width past K5's one-pass registers (ViT-g's 4096: two sweeps)
LN_CASES = ((LN_ROWS, EMBED, torch.bfloat16, 'one_pass'),
            (LN_ROWS, EMBED, torch.float32, 'one_pass'),
            (37, 203, torch.bfloat16, 'elementwise'), (517, 768, torch.bfloat16, 'one_pass'),
            (300, 4096, torch.bfloat16, 'two_sweep'))
# K4's y against a float64 LayerNorm of the same inputs, element by element:
# the output is a float32 value rounded once to its type, so it may stand
# half an ulp of that type from the float32 value, which itself stands off
# the float64 one by what the float32 statistics carry (the kernel's own
# mean and rstd against float64's, times |x - mean| and |γ|) and by four
# float32 roundings of the affine map.  An element past that bound is a K4
# fault.  The plain version is held to the same bound and printed beside.
# A bound on max |y - plain| of 2^-8 · max|y|, the gate before, sits below
# one bf16 ulp in the upper half of a binade, where two versions rounding
# float32 values a hair apart land one ulp apart.  Checked on the phase's
# inputs and on inputs from LN_SEEDS more generator states.
# K5 against its plain version on the same inputs (given K4's mean and
# rstd): dx the same float32 arithmetic with the row sums in another order,
# rounded once to the output type, so at most a bf16 ulp of the largest
# value apart (2^-8 relative); a wrong row statistic or a misplaced vector
# moves it by O(1).  mean and rstd: float32 row sums in another order, 1e-5
# relative.  dγ and dβ: float32 sums over all rows, per CTA and then across
# CTAs, against torch's reduction: ||d|| / ||ref|| <= 1e-5; the partial sums
# of one lost CTA (8 to 32 of 8232 rows) move them by 3e-2 to 6e-2.
LN_DX_TOL, LN_STAT_TOL, LN_DW_TOL, LN_SEEDS = 2.0 ** -8, 1e-5, 1e-5, 3
# DinoSeg with EVER_FUSED_LN=1 against the default LayerNorm, same weights:
# the fused norm takes its statistics in one pass (E[x²] - mu²) and applies
# float32 γ and β, the default two-pass statistics with γ and β rounded to
# bf16.  One tile batch in bf16, probabilities: the limits of the attention
# comparison above.  2 tiles' gradients: ||dg|| / ||g|| and the worst
# per-tensor cosine: the first run measured 3.2e-3 and 0.99991 (vit.cls_token);
# the limits sit ten times further out.
FUSED_LN_GRAD_REL_TOL, FUSED_LN_GRAD_COS_MIN = 3e-2, 0.999
# DinoSeg's LayerNorms per forward: two per block and the trunk's final norm
LN_PER_FORWARD = 2 * 24 + 1
# the int8 serving layer, at the shapes of tools/quant_check.py: quantize at
# 8 tiles of 1024² (4101 tokens each) x 4096, [4096, 16384] and [512, 768]
QUANT_SHAPES = ((8 * 4101, 4096), (4096, 16384), (512, 768))
# K7: (M, K, N, byte offset of x_q, path).  ViT-L/16's fc2 over those tokens
# (M = 256·128 + 40 rows: a ragged last tile of 128); (300, 128, 130) from
# the JAX tests (M and N ragged, N below one 256-wide tile); a K that is a
# multiple of 16 but not of TMA's 128-byte slice (zero-filled past K) with an
# odd N; then the mma.sync path: a K off 16 bytes, and an x_q starting 1 byte
# past 16-byte alignment
MM_CASES = ((8 * 4101, 4096, 1024, 0, 'wgmma'), (300, 128, 130, 0, 'wgmma'),
            (1000, 80, 257, 0, 'wgmma'), (77, 45, 100, 0, 'mma_sync'),
            (64, 128, 64, 1, 'mma_sync'))
# QuantDense's product rounded to nearest against float32 x @ w + b
# (tools/quant_check.py's limit); stochastic rounding, the layer's own mode
# on the card, doubles the error's variance and is held to its own
# prediction instead (phase_quant)
QUANT_REL_TOL = 0.02
# H100 SXM dense int8 tensor-core peak (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12


# kernel-name words that sort a profile's device time by kind
PROFILE_KINDS = (('the port\'s kernels', ('attn_fwd_kernel', 'stage_kernel', 'attn_bwd_',
                                         'prologue_kernel', 'maxpool32', 'int8_gemm',
                                         'ever_ln_', 'ever_quant')),
                 ('convolutions and matmuls', ('xmma', 'gemm', 'nvjet', 'cutlass', 'conv')),
                 ('normalization', ('batch_norm', 'layer_norm', 'GammaBeta')),
                 ('resizes', ('upsample',)),
                 ('optimizer', ('multi_tensor_apply',)),
                 ('reductions', ('reduce_kernel',)))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events over ``iters``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of ``fn()`` in ms, from CUDA events over ``iters`` calls
    queued behind a spin of the card long enough (about 1 ms a call) for the
    host to queue every call before the first one starts: a host slower than
    the kernel then cannot starve the card between calls, as it can in
    ``cuda_ms``.  For calls that a CUDA graph cannot capture (autograd)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * 2e6))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of ``fn()`` in ms, from CUDA events around the replay of
    one CUDA graph holding ``iters`` calls: the host's cost of each call
    (Python, allocation, the launch itself) stays out, which matters for
    kernels that take tens of microseconds."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):                 # warm up where it is captured
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def rope_tables(n_tokens: int, device, dtype=torch.bfloat16,
                grid: int = TILE // 16, head_dim: int = D) -> tuple:
    """The main paths' RoPE tables at 512² tiles: the ViT's 32×32 patch
    tables (``grid``² patches) with identity rows for the 5 prefix tokens
    (cls + 4 storage) and for any tail pad rows, in ``dtype``, as
    ``SelfAttention`` builds them; ``head_dim`` wide (the width split
    into fewer heads for 128)."""
    from ever_tpu_torch.module.vit import RopePositionEmbedding, token_rope
    sin, cos = RopePositionEmbedding(EMBED, EMBED // head_dim, rescale_coords=2.0)(
        grid, grid, device=device)
    sin, cos = token_rope(sin, cos, prefix=5, tail=n_tokens - 5 - sin.shape[0])
    return sin.to(dtype), cos.to(dtype)


def strip_rope(device, dtype=torch.bfloat16) -> tuple:
    """The stacked RoPE tables of the spatial phase's (f) attention: the
    query rows of strip 0 (the 5 prefix tokens and the first 32 of the 64
    patch rows of a 1024² tile) and the key rows of the whole tile, as
    ``SelfAttention`` stacks them under a spatial step."""
    from ever_tpu_torch.module.vit import RopePositionEmbedding, token_rope
    grid = SPATIAL_MORE_TILE // 16
    sin, cos = RopePositionEmbedding(EMBED, H, rescale_coords=2.0)(grid, grid, device=device)
    patches = STRIP_Q - 5
    q_tabs = token_rope(sin[:patches], cos[:patches], prefix=5, tail=0)
    k_tabs = token_rope(sin, cos, prefix=5, tail=0)
    return tuple(torch.cat([a, b]).to(dtype) for a, b in zip(q_tabs, k_tabs))


# (batch, heads, tokens, n_valid, head dim, RoPE, type): the main paths'
# shape, the same with stack padding, ViT-7B's head dim 128 without RoPE,
# and the main paths' shape from float32 inputs
KERNEL_CASES = ((B, H, S, None, D, True, torch.bfloat16),
                (B, H, S + 3, S, D, True, torch.bfloat16),
                (1, 32, S, S - 100, 128, False, torch.bfloat16),
                (B, H, S, None, D, True, torch.float32))
# the spatial phase's (f): a rank's strip of STRIP_Q queries against the
# whole tile's STRIP_KV keys (an eighth element: the key tokens), bf16 and
# from float32 inputs; drawn from a generator of their own (phase_kernels)
STRIP_CASES = tuple((1, H, STRIP_Q, None, D, True, dtype, STRIP_KV)
                    for dtype in (torch.bfloat16, torch.float32))


def case_inputs(gen, b, h, s, d, with_rope, dtype, s_kv=None):
    """q/k/v as strided views of one packed [B, N, 3, H, D] tensor, as the
    model makes them, and the RoPE tables (or None).  With ``s_kv`` keys
    (the spatial phase's (f) only), q is a view of a rank's packed [B, S, 3,
    H, D] projection and k and v of the gathered [B, S_kv, 2, H, D] keys
    and values, and the tables are :func:`strip_rope`'s."""
    dev = torch.device('cuda')
    qkv = torch.randn(b, s, 3, h, d, generator=gen, device=dev).to(dtype)
    q, k, v = qkv.unbind(2)
    if s_kv is None:
        return q, k, v, rope_tables(s, dev, dtype, head_dim=d) if with_rope else None
    k, v = torch.randn(b, s_kv, 2, h, d, generator=gen, device=dev).to(dtype).unbind(2)
    return q, k, v, strip_rope(dev, dtype) if with_rope else None


def case_rows(case) -> tuple:
    """A kernel case's name, its unpacked fields with the key tokens (None:
    as many as the queries), and the query rows and key rows that are real
    (with one length, the rows past ``n_valid`` are garbage by contract)."""
    b, h, s, n_valid, d, with_rope, dtype = case[:7]
    s_kv = case[7] if len(case) > 7 else None
    name = (f'B={b} H={h} S={s}' + (f' S_kv={s_kv}' if s_kv else '')
            + f' D={d} n_valid={n_valid} rope={with_rope} {str(dtype)[6:]}')
    q_rows = s if s_kv else (n_valid or s)
    return name, (b, h, s, n_valid, d, with_rope, dtype, s_kv), q_rows, n_valid or s_kv or s


def f32_rope(rope):
    return None if rope is None else (rope[0].float(), rope[1].float())


def check_fwd(gen, cases=KERNEL_CASES) -> float:
    """K1 against its plain version at every case; the largest error."""
    from ever_tpu_torch.ops import attention as A

    errs = []
    for case in cases:
        label, (b, h, s, n_valid, d, with_rope, dtype, s_kv), n, _ = case_rows(case)
        q, k, v, rope = case_inputs(gen, b, h, s, d, with_rope, dtype, s_kv)
        o, lse = A.fused_attention(q, k, v, n_valid=n_valid, rope=rope)
        torch.cuda.synchronize()
        ro, rlse = A.attention_reference(q.float(), k.float(), v.float(),
                                         n_valid=n_valid, rope=f32_rope(rope),
                                         return_lse=True)
        do = o[:, :n].float() - ro[:, :n]
        err_o = do.abs().max().item()
        rms_o = (do.norm() / ro[:, :n].norm()).item()
        err_l = (lse[..., :n] - rlse[..., :n]).abs().max().item()
        finite = bool(torch.isfinite(o[:, :n]).all() and torch.isfinite(lse[..., :n]).all())
        name = f'attention_fwd {label}'
        print(f'kernels: {name}: max|o-plain| {err_o:.3e} (max|o| '
              f'{ro[:, :n].abs().max().item():.3e}), ||do||/||o|| {rms_o:.3e}, '
              f'max|lse-plain| {err_l:.3e} (tolerances {ATTN_O_MAX_TOL}, '
              f'{ATTN_O_RMS_TOL}, {ATTN_LSE_TOL})', flush=True)
        check(finite, f'{name}: non-finite output')
        check(o.dtype == dtype, f'{name}: o is {o.dtype}')
        check(err_o <= ATTN_O_MAX_TOL and rms_o <= ATTN_O_RMS_TOL
              and err_l <= ATTN_LSE_TOL, f'{name} disagrees with its plain version')
        errs.append(max(err_o, err_l))
    return max(errs)


def check_bwd(gen, cases=KERNEL_CASES) -> float:
    """K2 against its plain version at every case, from K1's o and lse and
    a random upstream gradient; the largest error."""
    from ever_tpu_torch.ops import attention as A

    errs = []
    for case in cases:
        label, (b, h, s, n_valid, d, with_rope, dtype, s_kv), q_rows, k_rows = case_rows(case)
        q, k, v, rope = case_inputs(gen, b, h, s, d, with_rope, dtype, s_kv)
        o, lse = A.fused_attention(q, k, v, n_valid=n_valid, rope=rope)
        do = torch.randn(o.shape, generator=gen, device=o.device).to(dtype)
        grads = A.fused_attention_bwd(q, k, v, o, lse, do, n_valid=n_valid, rope=rope)
        torch.cuda.synchronize()
        refs = A.attention_bwd_reference(q.float(), k.float(), v.float(), o.float(),
                                         lse, do.float(), n_valid=n_valid,
                                         rope=f32_rope(rope))
        name = f'attention_bwd {label}'
        parts, fails = [], []
        for gname, g, r, n in zip(('dq', 'dk', 'dv'), grads, refs, (q_rows, k_rows, k_rows)):
            delta = g[:, :n].float() - r[:, :n]
            err, scale = delta.abs().max().item(), r[:, :n].abs().max().item()
            rms = (delta.norm() / r[:, :n].norm()).item()
            parts.append(f'{gname} max|d| {err:.3e} (max|{gname}| {scale:.3e}) '
                         f'rel {rms:.3e}')
            if g.dtype != dtype or not bool(torch.isfinite(g[:, :n]).all()):
                fails.append(f'{gname} is {g.dtype} or not finite')
            if err > ATTN_BWD_MAX_TOL * scale or rms > ATTN_BWD_RMS_TOL:
                fails.append(f'{gname} disagrees with its plain version')
            errs.append(err)
        zero_tail = all(not t[:, k_rows:].any() for t in grads[1:])
        print(f'kernels: {name}: {"; ".join(parts)}; dk, dv zero past n_valid: '
              f'{zero_tail} (tolerances {ATTN_BWD_MAX_TOL}·max, {ATTN_BWD_RMS_TOL})',
              flush=True)
        check(not fails, f'{name}: {", ".join(fails)}')
        check(zero_tail, f'{name}: dk or dv not zero on rows past n_valid')
    return max(errs)


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(bound ms, 'operations' or 'bytes') on the H100's memory peak and
    ``peak_flops`` (the bf16 tensor-core peak unless given)."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes'


# each kernel's launches by part, as (part, words of its kernel names), for
# its split: K1's staging launch and main kernel; K2's prologue and passes;
# K5's rows (one pass, or the two-sweep kernel) and its partial sums
FWD_KERNELS = (('K staging', ('stage_kernel',)), ('main kernel', ('attn_fwd_kernel',)))
BWD_KERNELS = (('prologue', ('prologue_kernel',)), ('dK/dV pass', ('attn_bwd_dkdv',)),
               ('dQ pass', ('attn_bwd_dq',)))
LN_BWD_KERNELS = (('rows', ('ever_ln_bwd_rows', 'ever_ln_bwd<')),
                  ('partial sums', ('ever_ln_bwd_reduce',)))


def kernel_split(fn, parts, calls: int = 10) -> dict:
    """Device ms per call of each part of a kernel (``parts`` as in
    ``BWD_KERNELS``) over ``calls`` calls of ``fn``, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {part: 0.0 for part, _ in parts}
    for event in prof.key_averages():
        for part, words in parts:
            if any(w in event.key for w in words):
                split[part] += event.device_time_total / calls / 1e3
    check(all(ms > 0 for ms in split.values()), f'the profiler missed a kernel: {split}')
    return split


def phase_kernels(gen):
    """Both attention kernels checked and timed at the main shape: their
    records for the report."""
    from ever_tpu_torch.ops import attention as A

    fwd_err, bwd_err = check_fwd(gen), check_bwd(gen)
    # the cross-length cases from a generator of their own, so that every
    # later phase draws what it drew before they joined
    strip_gen = torch.Generator(device='cuda').manual_seed(gen.initial_seed() + 22)
    fwd_err = max(fwd_err, check_fwd(strip_gen, STRIP_CASES))
    bwd_err = max(bwd_err, check_bwd(strip_gen, STRIP_CASES))

    # timing at the main paths' shape: S=1029, no pad, RoPE on
    q, k, v, rope = case_inputs(gen, B, H, S, D, True, torch.bfloat16)
    ms = device_ms(lambda: A.fused_attention(q, k, v, rope=rope), iters=50)
    # the float32 instance (a default DinoSeg's type) and head dim 128 at the
    # same width and work (8 heads), for the record only
    q32, k32, v32 = (t.float() for t in (q, k, v))
    rope32 = f32_rope(rope)
    f32_ms = device_ms(lambda: A.fused_attention(q32, k32, v32, rope=rope32), iters=50)
    q128, k128, v128, rope128 = case_inputs(gen, B, H // 2, S, 2 * D, True, torch.bfloat16)
    d128_ms = device_ms(lambda: A.fused_attention(q128, k128, v128, rope=rope128), iters=50)
    del q128, k128, v128
    plain_ms = cuda_ms(lambda: A.attention_reference(q, k, v, rope=rope), iters=10)
    # yardstick only: one PyTorch call on the same, already rotated, tensors
    qr, kr = A._rope_outside(q, k, rope, 'bnhd')
    qr, kr, vr = (t.transpose(1, 2).contiguous() for t in (qr, kr, v))
    library_ms = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vr), iters=50)
    flops = 4.0 * B * H * S * S * D
    nbytes = 4 * B * S * H * D * 2 + B * H * S * 4 + 2 * S * D * 2
    bound_ms, bound_by = bound(flops, nbytes)
    print(f'kernels: attention_fwd {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, '
          f'SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms '
          f'({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), '
          f'{flops / ms / 1e9:.1f} TFLOP/s; float32 inputs {f32_ms:.4f} ms/launch; '
          f'head dim 128 (H={H // 2}, RoPE) {d128_ms:.4f} ms/launch', flush=True)
    split = kernel_split(lambda: A.fused_attention(q, k, v, rope=rope), FWD_KERNELS)
    print('kernels: attention_fwd split by kernel (profiler, device ms per call): '
          f'K staging {split["K staging"]:.4f}; main kernel {split["main kernel"]:.4f} '
          f'({flops / split["main kernel"] / 1e9:.1f} TFLOP/s)', flush=True)
    fwd = dict(name='attention_fwd', route='cuda',
               source='ever_tpu_torch/csrc/attention_fwd.cu',
               replaces='ever_tpu/ops/attention.py:175', launches=None,
               max_abs_err=fwd_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms)

    o, lse = A.fused_attention(q, k, v, rope=rope)
    do = torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype)
    bwd_ms = device_ms(lambda: A.fused_attention_bwd(q, k, v, o, lse, do, rope=rope),
                       iters=30)
    bwd32_ms = device_ms(lambda: A.fused_attention_bwd(
        q32, k32, v32, o.float(), lse, do.float(), rope=rope32), iters=10)
    bwd_plain_ms = cuda_ms(lambda: A.attention_bwd_reference(
        q, k, v, o, lse, do, rope=rope), iters=5)
    # yardstick only: SDPA's backward on the rotated tensors, graph kept
    qg, kg, vg = (t.detach().requires_grad_() for t in (qr, kr, vr))
    og = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg)
    dog = do.transpose(1, 2).contiguous()
    bwd_library_ms = device_ms(lambda: torch.autograd.grad(
        og, (qg, kg, vg), dog, retain_graph=True), iters=30)
    # five products of 2·B·H·N²·D; q, k, v, o, do read, dq, dk, dv written
    bflops = 10.0 * B * H * S * S * D
    bbytes = 8 * B * S * H * D * 2 + B * H * S * 4 + 2 * S * D * 2
    bwd_bound_ms, bwd_bound_by = bound(bflops, bbytes)
    print(f'kernels: attention_bwd {bwd_ms:.4f} ms/launch, plain {bwd_plain_ms:.4f} ms, '
          f'SDPA backward {bwd_library_ms:.4f} ms, bound {bwd_bound_ms:.4f} ms '
          f'({bflops / 1e9:.1f} GFLOP, {bbytes / 1e6:.1f} MB), '
          f'{bflops / bwd_ms / 1e9:.1f} TFLOP/s; float32 inputs {bwd32_ms:.4f} ms/launch',
          flush=True)
    split = kernel_split(lambda: A.fused_attention_bwd(q, k, v, o, lse, do, rope=rope),
                         BWD_KERNELS)
    # the dK/dV pass runs four products, the dQ pass three (it repeats s and dp)
    work = {'prologue': None, 'dK/dV pass': 4, 'dQ pass': 3}
    print('kernels: attention_bwd split by kernel (profiler, device ms per call): '
          + '; '.join(f'{part} {ms:.4f}' + (
              f' ({work[part] * bflops / 5 / ms / 1e9:.1f} TFLOP/s)' if work.get(part) else '')
              for part, ms in split.items()), flush=True)
    bwd = dict(name='attention_bwd', route='cuda',
               source='ever_tpu_torch/csrc/attention_bwd.cu',
               replaces='ever_tpu/ops/attention.py:207', launches=None,
               max_abs_err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain_ms,
               bound_ms=bwd_bound_ms, bound_by=bwd_bound_by,
               library_ms=bwd_library_ms)
    del q32, k32, v32, qr, kr, vr, qg, kg, vg, og, dog
    time_strip(strip_gen)
    return fwd, bwd


def time_strip(gen) -> None:
    """K1 and K2 at the spatial phase's (f) shape (a rank's STRIP_Q queries
    against the tile's STRIP_KV keys, B=1, H=16, D=64, RoPE), bf16 and from
    float32 inputs: each timed beside its bound, its plain version and
    SDPA on the same (rotated) tensors."""
    from ever_tpu_torch.ops import attention as A

    q, k, v, rope = case_inputs(gen, 1, H, STRIP_Q, D, True, torch.bfloat16, STRIP_KV)
    o, lse = A.fused_attention(q, k, v, rope=rope)
    do = torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype)
    ms = device_ms(lambda: A.fused_attention(q, k, v, rope=rope), iters=50)
    bwd_ms = device_ms(lambda: A.fused_attention_bwd(q, k, v, o, lse, do, rope=rope), iters=30)
    q32, k32, v32, o32, do32 = (t.float() for t in (q, k, v, o, do))
    rope32 = f32_rope(rope)
    f32_ms = device_ms(lambda: A.fused_attention(q32, k32, v32, rope=rope32), iters=20)
    bwd32_ms = device_ms(lambda: A.fused_attention_bwd(q32, k32, v32, o32, lse, do32,
                                                       rope=rope32), iters=10)
    plain_ms = cuda_ms(lambda: A.attention_reference(q, k, v, rope=rope), iters=5)
    bwd_plain_ms = cuda_ms(lambda: A.attention_bwd_reference(q, k, v, o, lse, do, rope=rope),
                           iters=3)
    # yardsticks only: SDPA forward and backward on the rotated tensors
    qr, kr = A._rope_outside(q, k, rope, 'bnhd')
    qr, kr, vr = (t.transpose(1, 2).contiguous().requires_grad_() for t in (qr, kr, v))
    library_ms = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qr.detach(), kr.detach(), vr.detach()), iters=50)
    og = torch.nn.functional.scaled_dot_product_attention(qr, kr, vr)
    dog = do.transpose(1, 2).contiguous()
    bwd_library_ms = device_ms(lambda: torch.autograd.grad(
        og, (qr, kr, vr), dog, retain_graph=True), iters=30)
    flops = 4.0 * H * STRIP_Q * STRIP_KV * D
    # q, o, do, dq: S_q rows; k, v, dk, dv: S_kv rows; lse; both tables
    tables = 2 * (STRIP_Q + STRIP_KV) * D * 2
    nbytes = 2 * (STRIP_Q + STRIP_KV) * H * D * 2 + H * STRIP_Q * 4 + tables
    bbytes = 4 * (STRIP_Q + STRIP_KV) * H * D * 2 + H * STRIP_Q * 4 + tables
    (fwd_bound, fwd_by), (bwd_bound, bwd_by) = bound(flops, nbytes), bound(2.5 * flops, bbytes)
    print(f'kernels: attention_fwd at the spatial strip shape (B=1, H={H}, S_q={STRIP_Q}, '
          f'S_kv={STRIP_KV}, D={D}, RoPE, bf16): {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, '
          f'SDPA {library_ms:.4f} ms, bound {fwd_bound:.4f} ms ({fwd_by}; '
          f'{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), {flops / ms / 1e9:.1f} TFLOP/s; '
          f'float32 inputs {f32_ms:.4f} ms/launch', flush=True)
    print(f'kernels: attention_bwd at the spatial strip shape: {bwd_ms:.4f} ms/launch, plain '
          f'{bwd_plain_ms:.4f} ms, SDPA backward {bwd_library_ms:.4f} ms, bound '
          f'{bwd_bound:.4f} ms ({bwd_by}; {2.5 * flops / 1e9:.1f} GFLOP, {bbytes / 1e6:.1f} MB), '
          f'{2.5 * flops / bwd_ms / 1e9:.1f} TFLOP/s; float32 inputs {bwd32_ms:.4f} ms/launch',
          flush=True)


def seeded_init_(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights: matrices ~N(0, 0.04²) (peaked softmaxes),
    biases and tokens ~N(0, 0.02²), norm weights and LayerScale gammas
    ~U(0.5, 1.5) so every block moves the output."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('gamma') or ('norm' in name and name.endswith('weight')):
                p.copy_(torch.rand(p.shape, generator=gen, device=p.device) + 0.5)
            elif p.dim() >= 2 and not name.endswith(('cls_token', 'storage_tokens')):
                p.copy_(0.04 * torch.randn(p.shape, generator=gen, device=p.device))
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=gen, device=p.device))


def kernel_name(key: str) -> str:
    """A profiler row's kernel without its return type, namespace and
    arguments: 'attn_fwd_kernel<64, __nv_bfloat16>'."""
    key = key.replace('(anonymous namespace)::', '')
    return key.removeprefix('void ').split('(')[0]


def profile_run(label: str, fn, kinds=PROFILE_KINDS) -> tuple:
    """Device time of one call of ``fn`` by kernel, from ``torch.profiler``,
    summed by ``kinds`` (the first kind that names a word of a kernel):
    (wall ms, ms of kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # rows named like 'Optimizer.step#SGD.step' are annotations spanning
    # kernels, not kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and '#' not in e.key]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    print(f'profile: {label} under the profiler: {wall_ms:.2f} ms wall, '
          f'{busy_ms:.2f} ms of kernels, {len(kernels)} kernel names', flush=True)
    by_kind = {}
    for e in kernels:
        kind = next((k for k, words in kinds if any(w in e.key for w in words)),
                    'elementwise, copies and the rest')
        by_kind[kind] = by_kind.get(kind, 0.0) + e.device_time_total / 1e3
    print('profile: by kind: ' + '; '.join(
        f'{k} {v:.3f} ms' for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])),
        flush=True)
    port = [e for e in kernels if any(w in e.key for w in PROFILE_KINDS[0][1])]
    print('profile: the port\'s kernels: ' + ('; '.join(
        f'{kernel_name(e.key)} {e.device_time_total / 1e3:.3f} ms ({e.count}x)'
        for e in sorted(port, key=lambda e: -e.device_time_total)) or 'none'), flush=True)
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:20]:
        print(f'profile: {e.device_time_total / 1e3:9.3f} ms {e.count:5d}x '
              f'{e.key[:100]}', flush=True)
    return wall_ms, busy_ms


def build_dinoseg(gen, **backbone):
    """DinoSeg vitl16_sat493m with bf16 compute, float32 parameters and
    seeded random weights, on the card."""
    from ever_tpu_torch.core.builder import make_model

    cfg = {'type': 'DinoSeg', 'params': dict(
        backbone=dict(name='vitl16_sat493m', **backbone), classes=CLASSES,
        dtype='bfloat16')}
    with torch.device('cuda'):                      # initialise on the card
        model = make_model(cfg)
    seeded_init_(model, gen)
    return model


def phase_serve(gen, profile: bool) -> None:
    """The serving path: one scene, one tile batch against plain attention,
    one float32 tile batch."""
    from ever_tpu_torch import tiled_inference
    from ever_tpu_torch.module.vit import SelfAttention
    from ever_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    model = build_dinoseg(gen).to(torch.bfloat16)   # serving keeps bf16 parameters
    scene = torch.randn(SCENE, SCENE, 3, generator=gen, device='cuda')
    torch.cuda.synchronize()
    print(f'serve: DinoSeg vitl16_sat493m bf16, '
          f'{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, '
          f'built in {time.perf_counter() - t0:.1f} s', flush=True)

    def serve():
        out = tiled_inference(model, scene, TILE, STRIDE, CLASSES,
                              tile_batch=TILE_BATCH)
        torch.cuda.synchronize()
        return out

    serve()                                         # warm-up scene
    torch.cuda.reset_peak_memory_stats()
    A.fused_attention.launches = A.fused_attention_bwd.launches = 0
    t0 = time.perf_counter()
    out = serve()
    secs = time.perf_counter() - t0
    launches, bwd_launches = A.fused_attention.launches, A.fused_attention_bwd.launches
    n_tiles = (SCENE // STRIDE) ** 2
    print(f'serve: {n_tiles} tiles in {secs * 1e3:.1f} ms/scene = '
          f'{n_tiles / secs:.1f} tiles/s; attention_fwd launches {launches} '
          f'(expected {24 * n_tiles // TILE_BATCH}), attention_bwd {bwd_launches}; '
          f'peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)
    check(launches == 24 * n_tiles // TILE_BATCH and bwd_launches == 0,
          f'attention kernels launched {launches}/{bwd_launches} times, expected 192/0')
    check(tuple(out.shape) == (SCENE, SCENE, CLASSES), f'bad output shape {tuple(out.shape)}')
    check(bool(torch.isfinite(out).all()), 'non-finite probabilities')
    sums = out.sum(-1)
    check(float((sums - 1).abs().max()) < 1e-3, 'class probabilities do not sum to 1')

    # one tile batch: kernel path vs the same model with the plain attention
    tiles = torch.stack([scene[y:y + TILE, x:x + TILE]
                         for y, x in ((0, 0), (0, 512), (512, 0), (512, 512),
                                      (1024, 0), (0, 1024), (2048, 2048), (3584, 3584))])
    attns = [m for m in model.modules() if isinstance(m, SelfAttention)]
    with torch.no_grad():
        batch_ms = cuda_ms(lambda: model(tiles), iters=3, warmup=1)
        p_kernel = model(tiles)
        for m in attns:
            m.attn_impl = 'xla'
        plain_batch_ms = cuda_ms(lambda: model(tiles), iters=3, warmup=1)
        p_plain = model(tiles)
        for m in attns:
            m.attn_impl = None
    diff = (p_kernel - p_plain).abs()
    agree = (p_kernel.argmax(-1) == p_plain.argmax(-1)).float().mean().item()
    print(f'serve: tile batch of {TILE_BATCH}: {batch_ms:.2f} ms with the kernel, '
          f'{plain_batch_ms:.2f} ms with plain attention; kernel vs plain '
          f'max|dp| {diff.max().item():.3e}, mean|dp| {diff.mean().item():.3e} '
          f'(tolerances {SLICE_MAX_TOL}, {SLICE_MEAN_TOL}), argmax agreement '
          f'{agree:.4f}', flush=True)
    check(diff.max().item() <= SLICE_MAX_TOL and diff.mean().item() <= SLICE_MEAN_TOL,
          'kernel path and plain path disagree on a tile batch')

    # a default DinoSeg computes in float32: its attention goes through the
    # kernel too
    model.config.dtype = 'float32'
    model.float()
    with torch.no_grad():
        f32_batch_ms = cuda_ms(lambda: model(tiles), iters=3, warmup=1)
        A.fused_attention.launches = 0
        p32 = model(tiles)
        torch.cuda.synchronize()
    launches32 = A.fused_attention.launches
    agree32 = (p32.argmax(-1) == p_kernel.argmax(-1)).float().mean().item()
    print(f'serve: the same tile batch in float32: {f32_batch_ms:.2f} ms, '
          f'attention_fwd launches {launches32} (expected 24), argmax agreement '
          f'with bf16 {agree32:.4f}', flush=True)
    check(launches32 == 24, f'float32 model launched the kernel {launches32} times')
    check(bool(torch.isfinite(p32).all()), 'non-finite float32 probabilities')
    if profile:
        model.config.dtype = 'bfloat16'
        model.to(torch.bfloat16)
        with torch.no_grad():
            profile_run('one serving tile batch', lambda: model(tiles))


def loss_and_grads(model, x, y, seed: int):
    """One train forward and backward: the loss and every parameter's
    gradient (float32 copies)."""
    model.zero_grad(set_to_none=True)
    out = model(x, y, train=True,
                generator=torch.Generator(device='cuda').manual_seed(seed))
    out['cls_loss'].backward()
    grads = [p.grad.detach().float().clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return out['cls_loss'].item(), grads


def compare_grads(got, want):
    """(global ||got - want|| / ||want||, worst per-tensor cosine, every
    tensor's cosine) over matching gradient lists; a tensor whose wanted
    gradient is zero counts as cosine 1."""
    num = sum(((g - w) ** 2).sum() for g, w in zip(got, want)).sqrt()
    den = sum((w ** 2).sum() for w in want).sqrt()
    cos = [float((g * w).sum() / (g.norm() * w.norm()).clamp_min(1e-30))
           if w.norm() > 0 else 1.0 for g, w in zip(got, want)]
    return float(num / den), min(cos), cos


def adamw_step(model):
    """AdamW (weight decay 0.05) with the cosine schedule (base_lr 1e-4, 1000
    iterations) through ``parallel.spmd``, as the JAX package's ``vit512``
    bench section trains: (state, step)."""
    from ever_tpu_torch.core.builder import make_learningrate, make_optimizer
    from ever_tpu_torch.parallel.spmd import build_train_step, create_train_state

    schedule = make_learningrate({'type': 'cosine', 'params': dict(base_lr=1e-4,
                                                                   max_iters=1000)})
    factory, _ = make_optimizer({'type': 'adamw', 'params': dict(weight_decay=0.05)})
    tx = factory.build(schedule)
    return create_train_state(model, tx), build_train_step(model, tx, schedule)


def phase_train(gen, profile: bool):
    """The train path, then the gradient, remat and flash-route checks;
    returns the K1 and K2 launches of the timed steps and their median
    ms/step."""
    from ever_tpu_torch.module.vit import SelfAttention
    from ever_tpu_torch.ops import attention as A

    model = build_dinoseg(gen)
    state, step = adamw_step(model)
    x = torch.randn(TRAIN_BATCH, TILE, TILE, 3, generator=gen, device='cuda')
    y = torch.randint(0, CLASSES, (TRAIN_BATCH, TILE, TILE), generator=gen,
                      device='cuda')
    for _ in range(WARMUP_STEPS):
        state, _ = step(state, (x, y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.fused_attention.launches = A.fused_attention_bwd.launches = 0
    # an event at every step boundary and one synchronize at the end, as a
    # training loop runs: the host dispatches the next step while the card
    # works, and a step's time is the interval between its two events
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    metrics = []
    events[0].record()
    for i in range(TIMED_STEPS):
        state, m = step(state, (x, y))
        events[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    launches = (A.fused_attention.launches, A.fused_attention_bwd.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    times = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    med = sorted(times)[len(times) // 2]
    losses = [m['cls_loss'].item() for m in metrics]
    norms = [m['grad_norm'].item() for m in metrics]
    print(f'train: DinoSeg vitl16_sat493m, bf16 compute, float32 params, AdamW + '
          f'cosine; {TRAIN_BATCH} tiles of {TILE}²; median {med * 1e3:.2f} ms/step '
          f'(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = '
          f'{TRAIN_BATCH / med:.1f} tiles/s; MFU {TRAIN_FLOPS / med / PEAK_BF16_FLOPS:.4f} '
          f'({TRAIN_FLOPS / 1e12:.2f} TFLOP/step / step time / 989 TFLOP/s); '
          f'peak memory {peak:.2f} GiB', flush=True)
    print(f'train: loss per step {" ".join(f"{v:.5f}" for v in losses)}', flush=True)
    print(f'train: grad_norm per step {" ".join(f"{v:.4f}" for v in norms)}; '
          f'learning_rate {metrics[-1]["learning_rate"].item():.6e}', flush=True)
    print(f'train: launches in {TIMED_STEPS} steps: attention_fwd {launches[0]}, '
          f'attention_bwd {launches[1]} (expected {24 * TIMED_STEPS} each)', flush=True)
    check(launches == (24 * TIMED_STEPS, 24 * TIMED_STEPS),
          f'train steps launched the attention kernels {launches} times')
    check(all(math.isfinite(v) for v in losses + norms), 'non-finite loss or grad_norm')
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          'parameters left float32')
    check(all(st['exp_avg'].dtype == torch.float32
              for st in state.optimizer.state.values()), 'AdamW state left float32')
    # the step never makes the host wait for the card: torch raises on any
    # synchronizing CUDA call in this mode
    torch.cuda.set_sync_debug_mode('error')
    try:
        state, _ = step(state, (x, y))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print('train: one more step under torch.cuda.set_sync_debug_mode("error"): no host sync',
          flush=True)
    if profile:
        profile_run('one train step', lambda: step(state, (x, y)))

    # gradients of 2 tiles: kernels vs plain attention, same draws
    attns = [m for m in model.modules() if isinstance(m, SelfAttention)]
    loss_k, g_kernel = loss_and_grads(model, x[:2], y[:2], seed=5)
    for m in attns:
        m.attn_impl = 'xla'
    loss_p, g_plain = loss_and_grads(model, x[:2], y[:2], seed=5)
    for m in attns:
        m.attn_impl = None
    rel, worst, cos = compare_grads(g_kernel, g_plain)
    names = [n for n, _ in model.named_parameters()]
    qkv_cos = cos[names.index('vit.blocks.0.attn.qkv.weight')]
    print(f'train: gradients of 2 tiles, kernels vs plain attention: loss '
          f'{loss_k:.6f} vs {loss_p:.6f}; ||dg||/||g|| {rel:.3e}, worst per-tensor '
          f'cosine {worst:.6f}, block 0 qkv weight cosine {qkv_cos:.6f} '
          f'(limits {GRAD_REL_TOL}, {GRAD_COS_MIN})', flush=True)
    check(rel <= GRAD_REL_TOL and worst >= GRAD_COS_MIN,
          'kernel gradients disagree with plain attention gradients')
    del g_kernel, g_plain, state, step, metrics
    torch.cuda.empty_cache()

    # one 1024² step at B=2 with remat='full' against the same without
    xr = torch.randn(2, 2 * TILE, 2 * TILE, 3, generator=gen, device='cuda')
    yr = torch.randint(0, CLASSES, (2, 2 * TILE, 2 * TILE), generator=gen, device='cuda')
    torch.cuda.reset_peak_memory_stats()
    loss_n, g_plain = loss_and_grads(model, xr, yr, seed=7)
    peak_n = torch.cuda.max_memory_allocated() / 2**30
    noise = compare_grads(loss_and_grads(model, xr, yr, seed=7)[1], g_plain)[0]
    model.vit.remat = 'full'
    torch.cuda.reset_peak_memory_stats()
    A.fused_attention.launches = A.fused_attention_bwd.launches = 0
    loss_r, g_remat = loss_and_grads(model, xr, yr, seed=7)
    remat_launches = (A.fused_attention.launches, A.fused_attention_bwd.launches)
    peak_r = torch.cuda.max_memory_allocated() / 2**30
    model.vit.remat = None
    rel_r, worst_r, _ = compare_grads(g_remat, g_plain)
    print(f'train: 1024² step at B=2 (N=4101), remat=full vs none: loss {loss_r:.6f} '
          f'vs {loss_n:.6f}; ||dg||/||g|| {rel_r:.3e} (two runs without remat: '
          f'{noise:.3e}), worst cosine {worst_r:.6f} (limit {REMAT_REL_TOL}); '
          f'launches {remat_launches} (expected (48, 24)); '
          f'peak memory {peak_r:.2f} vs {peak_n:.2f} GiB', flush=True)
    check(remat_launches == (48, 24), f'remat step launched {remat_launches}')
    check(math.isfinite(loss_r) and rel_r <= REMAT_REL_TOL,
          'remat gradients disagree with the step without remat')
    del model, g_plain, g_remat
    torch.cuda.empty_cache()
    check_flash_route(gen)
    return launches, med * 1e3


def check_flash_route(gen) -> None:
    """impl='flash' at N=16389 (a 2048² tile; B=1, H=2, D=64), forward and
    backward through the kernels, against the plain versions: the regime
    that the TPU's library flash kernel serves."""
    from ever_tpu_torch.ops import attention as A

    qkv = torch.randn(1, FLASH_N, 3, 2, D, generator=gen, device='cuda').to(torch.bfloat16)
    qkv.requires_grad_()
    q, k, v = qkv.unbind(2)
    rope = rope_tables(FLASH_N, 'cuda', torch.bfloat16, grid=128)
    do = torch.randn(1, FLASH_N, 2, D, generator=gen, device='cuda').to(torch.bfloat16)
    A.fused_attention.launches = A.fused_attention_bwd.launches = 0
    o = A.attention(q, k, v, impl='flash', rope=rope)
    o.backward(do)
    torch.cuda.synchronize()
    launches = (A.fused_attention.launches, A.fused_attention_bwd.launches)
    q32, k32, v32 = (t.detach().float() for t in (q, k, v))
    ro, rlse = A.attention_reference(q32, k32, v32, rope=f32_rope(rope), return_lse=True)
    refs = A.attention_bwd_reference(q32, k32, v32, ro, rlse, do.float(),
                                     rope=f32_rope(rope))
    delta = o.detach().float() - ro
    rms_o = (delta.norm() / ro.norm()).item()
    parts, ok = [], rms_o <= ATTN_O_RMS_TOL and delta.abs().max().item() <= ATTN_O_MAX_TOL
    for name, g, r in zip(('dq', 'dk', 'dv'), qkv.grad.unbind(2), refs):
        d = g.float() - r
        rel, err = (d.norm() / r.norm()).item(), d.abs().max().item()
        parts.append(f'{name} rel {rel:.3e} max|d| {err:.3e}')
        ok = ok and rel <= ATTN_BWD_RMS_TOL and err <= ATTN_BWD_MAX_TOL * r.abs().max().item()
    print(f'train: impl=flash at N={FLASH_N} (B=1, H=2): ||do||/||o|| {rms_o:.3e}, '
          f'{"; ".join(parts)}; launches {launches} (expected (1, 1))', flush=True)
    check(launches == (1, 1), f'flash route launched {launches}')
    check(ok, 'flash route disagrees with the plain versions')


def pool_inputs(gen, shape, dtype, ties):
    """x (a BatchNorm output's scale, or small integers for ties), the
    forward's out and a random upstream gradient, all [N, H, W, C] views of
    NCHW tensors in channels_last memory, as the ResNet stem makes them."""
    if ties:
        x = torch.randint(-2, 3, shape, generator=gen, device='cuda').to(dtype)
    else:
        x = torch.randn(shape, generator=gen, device='cuda').to(dtype)
    out = torch.nn.functional.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    g = torch.randn(out.shape, generator=gen, device='cuda').to(dtype)
    return x, out, g


def check_maxpool(gen) -> float:
    """K8 against its plain version at every case, and against the library
    backward on float32 inputs without ties; the largest error."""
    from ever_tpu_torch.ops import pool as P

    errs = []
    own = torch.Generator(device='cuda').manual_seed(gen.initial_seed() + 1)
    for shape, dtype, ties, draw in ([c + (gen,) for c in POOL_CASES]
                                     + [c + (own,) for c in SPATIAL_POOL_CASES]):
        x, out, g = pool_inputs(draw, shape, dtype, ties)
        dx = P.max_pool_32_bwd(x, out, g)
        torch.cuda.synchronize()
        ref = P.max_pool_32_bwd_reference(x, out, g)
        err = (dx.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        name = f'maxpool_bwd {list(shape)} {str(dtype)[6:]}{" ties" if ties else ""}'
        extra = ''
        if ties:
            # with ties a window's gradient reaches every tied maximum:
            # more of dx is nonzero than the library's one-winner backward
            lib = torch.ops.aten.max_pool2d_with_indices_backward(
                g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), [3, 3], [2, 2], [1, 1],
                [1, 1], False, torch.nn.functional.max_pool2d(
                    x.permute(0, 3, 1, 2), 3, 2, 1, return_indices=True)[1])
            extra = (f', nonzero dx {int((dx != 0).sum())} vs '
                     f'{int((lib != 0).sum())} with one winner per window')
        print(f'kernels: {name}: max|dx-plain| {err:.3e} (max|dx| {scale:.3e}, '
              f'tolerance {POOL_TOL}·max){extra}', flush=True)
        check(dx.dtype == dtype and dx.shape == x.shape, f'{name}: dx is {dx.dtype} '
              f'{tuple(dx.shape)}')
        check(bool(torch.isfinite(dx).all()), f'{name}: non-finite dx')
        check(err <= POOL_TOL * scale, f'{name} disagrees with its plain version')
        errs.append(err)

    # against the library backward where no window holds a tie: distinct
    # float32 integers (float32 normals at the main shape hold some
    # exact ties), so both give each window's gradient to its one maximum
    shape = (2, 64, 64, 64)
    x = torch.randperm(math.prod(shape), generator=gen, device='cuda').float().view(shape)
    xc = x.permute(0, 3, 1, 2)
    out, idx = torch.nn.functional.max_pool2d(xc, 3, 2, 1, return_indices=True)
    g = torch.randn(out.shape, generator=gen, device='cuda').permute(0, 2, 3, 1).contiguous()
    dx = P.max_pool_32_bwd(x, out.permute(0, 2, 3, 1).contiguous(), g)
    lib = torch.ops.aten.max_pool2d_with_indices_backward(
        g.permute(0, 3, 1, 2), xc, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)
    lib_err = (dx - lib.permute(0, 2, 3, 1)).abs().max().item()
    print(f'kernels: maxpool_bwd {list(shape)} float32 without ties: max|dx-library| '
          f'{lib_err:.3e} (max|dx| {dx.abs().max().item():.3e}, tolerance 1e-6·max)',
          flush=True)
    check(lib_err <= 1e-6 * dx.abs().max().item(),
          'maxpool_bwd disagrees with the library backward without ties')
    return max(errs)


def phase_maxpool(gen):
    """K8 checked at every case and timed at the main shape: its record."""
    from ever_tpu_torch.ops import pool as P

    err = check_maxpool(gen)
    x, out, g = pool_inputs(gen, POOL_SHAPE, torch.bfloat16, False)
    ms = cuda_ms(lambda: P.max_pool_32_bwd(x, out, g), iters=100)
    plain_ms = cuda_ms(lambda: P.max_pool_32_bwd_reference(x, out, g), iters=5)
    x32, out32, g32 = (t.float().contiguous() for t in (x, out, g))
    f32_ms = cuda_ms(lambda: P.max_pool_32_bwd(x32, out32, g32), iters=50)
    # yardstick only: the library backward given the forward's indices
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    idx = torch.nn.functional.max_pool2d(xc, 3, 2, 1, return_indices=True)[1]
    library_ms = cuda_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
        gc, xc, [3, 3], [2, 2], [1, 1], [1, 1], False, idx), iters=100)
    # x, out and g read once, dx written once; a compare and an add for each
    # window covering each input (1, 2 or 4 by row and column parity: 2.25
    # on average), on the CUDA cores
    n = x.numel()
    nbytes = (2 * n + 2 * out.numel()) * x.element_size()
    flops = 2 * 2.25 * n
    bound_ms, bound_by = bound(flops, nbytes, PEAK_F32_FLOPS)
    print(f'kernels: maxpool_bwd {ms:.4f} ms/launch ({nbytes / ms / 1e9:.3f} TB/s), '
          f'plain {plain_ms:.4f} ms, library (max_pool2d_with_indices_backward) '
          f'{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, '
          f'{flops / 1e6:.0f} M operations); float32 inputs {f32_ms:.4f} ms/launch',
          flush=True)
    return dict(name='maxpool_bwd', route='cuda', source='ever_tpu_torch/csrc/maxpool_bwd.cu',
                replaces='ever_tpu/ops/pool.py:53', launches=None, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def seeded_conv_init_(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights for a conv net: kernels ~N(0, 2/fan_in) (He),
    BatchNorm weights ~N(1, 0.1²), biases ~N(0, 0.02²); a BiFPN fusion's
    weights keep their own initialisation (a draw around 0 would let the
    fast-normalize ReLU cut whole paths)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('fusion.weights'):
                continue
            if p.dim() >= 2:
                fan_in = p[0].numel()
                p.copy_((2.0 / fan_in) ** 0.5 * torch.randn(p.shape, generator=gen,
                                                            device=p.device))
            elif name.endswith('weight'):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen, device=p.device))
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=gen, device=p.device))


def set_compute_dtype(model, dtype: str) -> None:
    """FarSeg and its encoder each cast their input to their config's dtype."""
    model.config.dtype = model.encoder.config.dtype = dtype


def phase_farseg_train(gen, profile: bool):
    """The FarSeg train path, then the float32 gradient check; returns the
    trained model and the K8 launches of the timed steps."""
    from torch.utils.flop_counter import FlopCounterMode

    from ever_tpu_torch.core.builder import make_learningrate, make_model, make_optimizer
    from ever_tpu_torch.ops import pool as P
    from ever_tpu_torch.parallel.spmd import build_train_step, create_train_state

    t0 = time.perf_counter()
    model = make_model({'type': 'FarSeg', 'params': FARSEG})
    seeded_conv_init_(model, gen)
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    schedule = make_learningrate({'type': 'poly', 'params': dict(
        base_lr=0.01, power=0.9, max_iters=1000)})
    factory, _ = make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})
    tx = factory.build(schedule)
    state = create_train_state(model, tx)
    step = build_train_step(model, tx, schedule)
    x = torch.randn(TRAIN_BATCH, TILE, TILE, 3, generator=gen, device='cuda')
    y = torch.randint(0, CLASSES, (TRAIN_BATCH, TILE, TILE), generator=gen, device='cuda')
    print(f'farseg: FarSeg-R50 bf16 compute, '
          f'{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, built in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    with FlopCounterMode(display=False) as counter:   # the first warm-up step
        state, _ = step(state, (x, y))
    step_flops = counter.get_total_flops()
    for _ in range(WARMUP_STEPS - 1):
        state, _ = step(state, (x, y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    P.max_pool_32_bwd.launches = 0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    metrics = []
    events[0].record()
    for i in range(TIMED_STEPS):
        state, m = step(state, (x, y))
        events[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    launches = P.max_pool_32_bwd.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    times = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    med = sorted(times)[len(times) // 2]
    losses = [m['cls_loss'].item() for m in metrics]
    norms = [m['grad_norm'].item() for m in metrics]
    print(f'farseg: train, bf16 compute, float32 params, SGD momentum 0.9 + poly; '
          f'{TRAIN_BATCH} tiles of {TILE}²; median {med * 1e3:.2f} ms/step (min '
          f'{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = {TRAIN_BATCH / med:.1f} '
          f'tiles/s; MFU {step_flops / med / PEAK_BF16_FLOPS:.4f} ({step_flops / 1e12:.3f} '
          f'TFLOP/step by FlopCounterMode / step time / 989 TFLOP/s); peak memory '
          f'{peak:.2f} GiB', flush=True)
    print(f'farseg: loss per step {" ".join(f"{v:.5f}" for v in losses)}', flush=True)
    print(f'farseg: grad_norm per step {" ".join(f"{v:.4f}" for v in norms)}; '
          f'learning_rate {metrics[-1]["learning_rate"].item():.6e}', flush=True)
    moved = sum(not torch.equal(b, stats0[n]) for n, b in model.named_buffers())
    finite = all(bool(torch.isfinite(b).all()) for b in model.buffers())
    print(f'farseg: maxpool_bwd launches in {TIMED_STEPS} steps: {launches} (expected '
          f'{TIMED_STEPS}); running statistics moved in {moved} of '
          f'{len(stats0)} buffers, all finite: {finite}', flush=True)
    check(launches == TIMED_STEPS, f'FarSeg steps launched K8 {launches} times')
    check(all(math.isfinite(v) for v in losses + norms), 'non-finite loss or grad_norm')
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          'parameters left float32')
    check(finite and moved == len(stats0), 'running statistics not finite or not moved')
    if profile:
        profile_run('one FarSeg train step', lambda: step(state, (x, y)))
    del state, step, metrics
    torch.cuda.empty_cache()

    # gradients of 2 tiles at float32 compute: K8 against the library backward
    set_compute_dtype(model, 'float32')
    resnet = model.encoder.resnet
    loss_k, g_kernel = loss_and_grads(model, x[:2], y[:2], seed=0)
    resnet.maxpool_impl = 'reduce_window'
    loss_l, g_lib = loss_and_grads(model, x[:2], y[:2], seed=0)
    noise = compare_grads(loss_and_grads(model, x[:2], y[:2], seed=0)[1], g_lib)[0]
    resnet.maxpool_impl = 'pallas'
    set_compute_dtype(model, 'bfloat16')
    rel, worst, cos = compare_grads(g_kernel, g_lib)
    names = [n for n, _ in model.named_parameters()]
    stem_cos = cos[names.index('encoder.resnet.conv1.weight')]
    print(f'farseg: gradients of 2 tiles at float32, K8 vs reduce_window: loss '
          f'{loss_k:.6f} vs {loss_l:.6f}; ||dg||/||g|| {rel:.3e} (two runs of '
          f'reduce_window: {noise:.3e}), worst per-tensor cosine {worst:.7f} '
          f'({names[cos.index(worst)]}), stem conv cosine {stem_cos:.7f} (limits '
          f'{FARSEG_GRAD_REL_TOL}, {FARSEG_GRAD_COS_MIN})', flush=True)
    check(rel <= FARSEG_GRAD_REL_TOL and worst >= FARSEG_GRAD_COS_MIN,
          'K8 gradients disagree with the library max pool backward')
    del g_kernel, g_lib
    torch.cuda.empty_cache()
    return model, launches


def phase_farseg_serve(gen, model, profile: bool) -> None:
    """One 4096² scene through tiled_inference with the trained FarSeg in
    bf16 compute; the forward launches no K8."""
    from ever_tpu_torch import tiled_inference
    from ever_tpu_torch.ops import pool as P

    scene = torch.randn(SCENE, SCENE, 3, generator=gen, device='cuda')

    def serve():
        out = tiled_inference(model, scene, TILE, STRIDE, CLASSES, tile_batch=TILE_BATCH)
        torch.cuda.synchronize()
        return out

    serve()                                         # warm-up scene
    torch.cuda.reset_peak_memory_stats()
    P.max_pool_32_bwd.launches = 0
    t0 = time.perf_counter()
    out = serve()
    secs = time.perf_counter() - t0
    launches = P.max_pool_32_bwd.launches
    n_tiles = (SCENE // STRIDE) ** 2
    tiles = torch.stack([scene[i * TILE:(i + 1) * TILE, :TILE] for i in range(TILE_BATCH)])
    with torch.no_grad():
        batch_ms = cuda_ms(lambda: model(tiles), iters=5, warmup=2)
    print(f'farseg: serve {n_tiles} tiles in {secs * 1e3:.1f} ms/scene = '
          f'{n_tiles / secs:.1f} tiles/s; tile batch of {TILE_BATCH}: {batch_ms:.2f} ms; '
          f'maxpool_bwd launches {launches} (K8 is a backward: serving launches none); '
          f'peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)
    if profile:
        with torch.no_grad():
            profile_run('one FarSeg serving tile batch', lambda: model(tiles))
    check(launches == 0, f'serving launched K8 {launches} times')
    check(tuple(out.shape) == (SCENE, SCENE, CLASSES), f'bad output shape {tuple(out.shape)}')
    check(bool(torch.isfinite(out).all()), 'non-finite probabilities')
    check(float((out.sum(-1) - 1).abs().max()) < 1e-3, 'class probabilities do not sum to 1')


def ln_inputs(gen, rows, width, dtype):
    """x with a nonzero row mean, γ ~ U(0.5, 1.5), β ~ N(0, 0.1²) (float32)
    and an upstream gradient dy, on the card."""
    x = (2 * torch.randn(rows, width, generator=gen, device='cuda') + 1).to(dtype)
    w = torch.rand(width, generator=gen, device='cuda') + 0.5
    b = 0.1 * torch.randn(width, generator=gen, device='cuda')
    dy = torch.randn(rows, width, generator=gen, device='cuda').to(dtype)
    return x, w, b, dy


def rel_norm(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def kernel_ln_bwd_path(x, dy, w) -> str:
    """The path the built K5 library picks for these operands (with a fresh
    dx and partial-sum buffer, as the wrapper gives it)."""
    import ctypes
    from ever_tpu_torch.ops import _build
    from ever_tpu_torch.ops import norm as N

    fn = _build.load('layernorm').ever_layernorm_bwd_path
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    dx, partial = torch.empty_like(x), N._bwd_partial(*x.shape, x.device)
    return N.BWD_PATHS[fn(x.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
                          partial.data_ptr(), N._KERNEL_DTYPES[x.dtype], x.shape[1])]


def ulp(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One ulp of ``dtype`` at |v| (float64; the normal range)."""
    tiny = torch.finfo(dtype).tiny
    return torch.finfo(dtype).eps * torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(tiny))))


def ln_float64_excess(y, x, w, b, mean, rstd) -> tuple:
    """A LayerNorm output ``y`` (and the float32 ``mean``, ``rstd`` it was
    made with) against the float64 LayerNorm of the same inputs: (the
    largest |y - y64| in ulps of y's type at max|y64|, the largest
    |y - y64| over its bound).  The bound of each element: half an ulp at max(|y|,
    |y64|), plus the statistics' error |γ|·(|x - μ64|·|rstd - rstd64| +
    |mean - μ64|·rstd64), plus 4 float32 roundings of |x - μ64|·rstd64·|γ|
    + |β|."""
    x64, w64, b64 = x.double(), w.double(), b.double()
    mu64 = x64.mean(-1, keepdim=True)
    rstd64 = torch.rsqrt(((x64 - mu64) ** 2).mean(-1, keepdim=True) + LN_EPS)
    y64 = (x64 - mu64) * rstd64 * w64 + b64
    err = (y.double() - y64).abs()
    stat = w64.abs() * ((x64 - mu64).abs() * (rstd.double()[:, None] - rstd64).abs()
                        + (mean.double()[:, None] - mu64).abs() * rstd64)
    arith = 4 * 2.0 ** -24 * ((x64 - mu64).abs() * rstd64 * w64.abs() + b64.abs())
    bound = 0.5 * ulp(torch.maximum(y.double().abs(), y64.abs()), y.dtype) + stat + arith
    return float(err.max() / ulp(y64.abs().max(), y.dtype)), float((err / bound).max())


def check_layernorm(gen, seed: int):
    """K4 and K5 against their plain versions at every case (K5 given K4's
    mean and rstd, on the path the case wants, which the wrapper must
    predict and the kernel take), and K5 twice on the same inputs (the same
    bits); K4's y and the plain version's against float64 within their
    rounding, at every case on these inputs and on those of ``LN_SEEDS``
    more generator states (seeded ``seed + 1`` ...); the largest error of
    each kernel against its plain version."""
    from ever_tpu_torch.ops import norm as N

    fwd_errs, bwd_errs = [], []
    for rows, width, dtype, path in LN_CASES:
        x, w, b, dy = ln_inputs(gen, rows, width, dtype)
        paths = (N.layer_norm_bwd_path(x, dy, w), kernel_ln_bwd_path(x, dy, w))
        y, mean, rstd = N.layer_norm_fwd(x, w, b, LN_EPS)
        dx, dw, db = N.layer_norm_bwd(x, dy, w, mean, rstd)
        dx2, dw2, db2 = N.layer_norm_bwd(x, dy, w, mean, rstd)
        torch.cuda.synchronize()
        same = torch.equal(dx, dx2) and torch.equal(dw, dw2) and torch.equal(db, db2)
        ry, rmean, rrstd = N.layer_norm_reference(x, w, b, LN_EPS)
        rdx, rdw, rdb = N.layer_norm_bwd_reference(x, dy, w, mean, rstd)
        err_y = (y.float() - ry.float()).abs().max().item() / ry.float().abs().max().item()
        err_dx = (dx.float() - rdx.float()).abs().max().item() / rdx.float().abs().max().item()
        err_stat = max((mean - rmean).abs().max().item() / rmean.abs().max().item(),
                       (rstd - rrstd).abs().max().item() / rrstd.abs().max().item())
        err_dw, err_db = rel_norm(dw, rdw), rel_norm(db, rdb)
        ulps, excess = ln_float64_excess(y, x, w, b, mean, rstd)
        rulps, rexcess = ln_float64_excess(ry, x, w, b, rmean, rrstd)
        name = f'layernorm [{rows}, {width}] {str(dtype)[6:]}'
        print(f'kernels: {name}: max|y-plain| {err_y:.3e}·max|y|, mean/rstd {err_stat:.3e} '
              f'relative; y against float64: K4 {ulps:.3f} ulps of max|y| at most, '
              f'{excess:.3f} of its bound, plain {rulps:.3f} ulps, {rexcess:.3f} of its bound; '
              f'max|dx-plain| {err_dx:.3e}·max|dx|, ||d dgamma||/||dgamma|| {err_dw:.3e}, ||d dbeta||/||dbeta|| '
              f'{err_db:.3e} (tolerances {LN_STAT_TOL}, {LN_DX_TOL}·max, {LN_DW_TOL}); K5 path '
              f'{paths[1]} (wrapper predicts {paths[0]}, case wants {path}); two K5 calls '
              f'bit-equal: {same}', flush=True)
        check(paths == (path, path), f'{name}: K5 took the path {paths}')
        check(same, f'{name}: two K5 calls on the same inputs differ')
        outs = (y, dx, mean, rstd, dw, db)
        check(y.dtype == dx.dtype == dtype and y.shape == dx.shape == x.shape
              and dw.dtype == db.dtype == torch.float32, f'{name}: wrong output types')
        check(all(bool(torch.isfinite(t).all()) for t in outs), f'{name}: non-finite output')
        check(excess <= 1.0 and err_stat <= LN_STAT_TOL, f'{name}: K4 is off the float64 '
              'LayerNorm by more than its rounding, or its statistics disagree with the plain '
              'version\'s')
        check(err_dx <= LN_DX_TOL and err_dw <= LN_DW_TOL and err_db <= LN_DW_TOL,
              f'{name}: K5 disagrees with its plain version')
        fwd_errs.append((y.float() - ry.float()).abs().max().item())
        bwd_errs.append(max((dx.float() - rdx.float()).abs().max().item(),
                            (dw - rdw).abs().max().item(), (db - rdb).abs().max().item()))
    for k in range(1, LN_SEEDS + 1):
        other = torch.Generator(device='cuda').manual_seed(seed + k)
        for rows, width, dtype, _ in LN_CASES:
            x, w, b, _ = ln_inputs(other, rows, width, dtype)
            y, mean, rstd = N.layer_norm_fwd(x, w, b, LN_EPS)
            ry, rmean, rrstd = N.layer_norm_reference(x, w, b, LN_EPS)
            err_y = (y.float() - ry.float()).abs().max().item() / ry.float().abs().max().item()
            ulps, excess = ln_float64_excess(y, x, w, b, mean, rstd)
            rulps, rexcess = ln_float64_excess(ry, x, w, b, rmean, rrstd)
            name = f'layernorm [{rows}, {width}] {str(dtype)[6:]}, generator seed {seed + k}'
            print(f'kernels: {name}: max|y-plain| {err_y:.3e}·max|y|; y against float64: K4 '
                  f'{ulps:.3f} ulps of max|y| at most, {excess:.3f} of its bound, plain {rulps:.3f} ulps, '
                  f'{rexcess:.3f} of its bound', flush=True)
            check(excess <= 1.0, f'{name}: K4 is off the float64 LayerNorm by more than its '
                  'rounding')
            fwd_errs.append((y.float() - ry.float()).abs().max().item())
    return max(fwd_errs), max(bwd_errs)


def phase_layernorm(gen, seed: int):
    """K4 and K5 checked at every case and timed at the main shape: their
    records for the report."""
    from ever_tpu_torch.ops import norm as N

    fwd_err, bwd_err = check_layernorm(gen, seed)
    x, w, b, dy = ln_inputs(gen, LN_ROWS, EMBED, torch.bfloat16)
    _, mean, rstd = N.layer_norm_fwd(x, w, b, LN_EPS)
    # device times from CUDA graphs: a launch's host cost is larger than
    # these kernels' time (host_ms, printed beside, times back-to-back
    # calls from Python)
    fwd_ms = graph_ms(lambda: N.layer_norm_fwd(x, w, b, LN_EPS), iters=200)
    bwd_ms = graph_ms(lambda: N.layer_norm_bwd(x, dy, w, mean, rstd), iters=200)
    fwd_host = cuda_ms(lambda: N.layer_norm_fwd(x, w, b, LN_EPS), iters=200)
    fwd_plain = graph_ms(lambda: N.layer_norm_reference(x, w, b, LN_EPS), iters=20)
    bwd_plain = graph_ms(lambda: N.layer_norm_bwd_reference(x, dy, w, mean, rstd), iters=20)
    x32, dy32 = x.float(), dy.float()
    f32_fwd = graph_ms(lambda: N.layer_norm_fwd(x32, w, b, LN_EPS), iters=100)
    f32_bwd = graph_ms(lambda: N.layer_norm_bwd(x32, dy32, w, mean, rstd), iters=100)
    # yardsticks only: the library's LayerNorm forward and backward on the
    # same bf16 tensors (γ and β in bf16, as the port's default LayerNorm)
    wb, bb = w.to(x.dtype), b.to(x.dtype)
    fwd_lib = graph_ms(lambda: torch.ops.aten.native_layer_norm(x, [EMBED], wb, bb, LN_EPS),
                       iters=200)
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [EMBED], wb, bb, LN_EPS)
    bwd_lib = graph_ms(lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [EMBED], lmean, lrstd, wb, bb, [True, True, True]), iters=200)
    # bytes: K4 reads x, γ, β and writes y, mean, rstd; K5 reads x, dy, γ,
    # mean, rstd and writes dx, dγ, dβ.  About 8 and 12 float32 operations
    # per element on the CUDA cores, far below the bytes' time
    n, e = x.numel(), x.element_size()
    fwd_bytes = 2 * n * e + 2 * EMBED * 4 + 2 * LN_ROWS * 4
    bwd_bytes = 3 * n * e + 3 * EMBED * 4 + 2 * LN_ROWS * 4
    fwd_bound, fwd_by = bound(8.0 * n, fwd_bytes, PEAK_F32_FLOPS)
    bwd_bound, bwd_by = bound(12.0 * n, bwd_bytes, PEAK_F32_FLOPS)
    print(f'kernels: layernorm_fwd {fwd_ms:.4f} ms/launch ({fwd_bytes / fwd_ms / 1e9:.3f} '
          f'TB/s), plain {fwd_plain:.4f} ms, library (native_layer_norm) {fwd_lib:.4f} ms, '
          f'bound {fwd_bound:.4f} ms ({fwd_bytes / 1e6:.1f} MB); float32 inputs '
          f'{f32_fwd:.4f} ms/launch; host_ms {fwd_host:.4f} (calls from Python)', flush=True)
    print(f'kernels: layernorm_bwd {bwd_ms:.4f} ms/launch ({bwd_bytes / bwd_ms / 1e9:.3f} '
          f'TB/s), plain {bwd_plain:.4f} ms, library (native_layer_norm_backward) '
          f'{bwd_lib:.4f} ms, bound {bwd_bound:.4f} ms ({bwd_bytes / 1e6:.1f} MB); float32 '
          f'inputs {f32_bwd:.4f} ms/launch', flush=True)
    split = kernel_split(lambda: N.layer_norm_bwd(x, dy, w, mean, rstd), LN_BWD_KERNELS,
                         calls=50)
    print('kernels: layernorm_bwd split by kernel (profiler, device ms per call): '
          f'rows {split["rows"]:.4f} ({bwd_bytes / split["rows"] / 1e9:.3f} TB/s); '
          f'partial sums {split["partial sums"]:.4f}', flush=True)
    src = 'ever_tpu_torch/csrc/layernorm.cu'
    return (dict(name='layernorm_fwd', route='cuda', source=src,
                 replaces='ever_tpu/ops/norm.py:48', launches=None, max_abs_err=fwd_err,
                 ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fwd_bound, bound_by=fwd_by,
                 library_ms=fwd_lib),
            dict(name='layernorm_bwd', route='cuda', source=src,
                 replaces='ever_tpu/ops/norm.py:61', launches=None, max_abs_err=bwd_err,
                 ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bwd_bound, bound_by=bwd_by,
                 library_ms=bwd_lib))


@contextlib.contextmanager
def fused_layer_norm():
    """``EVER_FUSED_LN=1`` while a model is built (the port reads it then)."""
    old = os.environ.get('EVER_FUSED_LN')
    os.environ['EVER_FUSED_LN'] = '1'
    try:
        yield
    finally:
        if old is None:
            del os.environ['EVER_FUSED_LN']
        else:
            os.environ['EVER_FUSED_LN'] = old


def kernel_wrappers() -> tuple:
    """Every kernel wrapper of the port, each with its ``launches`` count."""
    from ever_tpu_torch.ops import attention as A, norm as N, pool as P, quant as Q

    return (A.fused_attention, A.fused_attention_bwd, P.max_pool_32_bwd,
            N.layer_norm_fwd, N.layer_norm_bwd, Q.quantize_int8_values, Q.int8_matmul_t)


def reset_counts():
    """Every kernel wrapper's launch count set to 0."""
    for fn in kernel_wrappers():
        fn.launches = 0


def counts():
    """(K1, K2, K4, K5) launches since the last reset."""
    from ever_tpu_torch.ops import attention as A, norm as N

    return (A.fused_attention.launches, A.fused_attention_bwd.launches,
            N.layer_norm_fwd.launches, N.layer_norm_bwd.launches)


def phase_fused_ln(gen, profile: bool):
    """DinoSeg ViT-L/16 under EVER_FUSED_LN=1: train steps, gradients and
    a tile batch against the default-LN model, one scene; returns the K4
    and K5 launches of the timed steps."""
    from ever_tpu_torch import tiled_inference
    from ever_tpu_torch.ops.norm import FusedLayerNorm

    with fused_layer_norm():
        model = build_dinoseg(gen)
    n_fused = sum(isinstance(m, FusedLayerNorm) for m in model.modules())
    check(n_fused == LN_PER_FORWARD, f'{n_fused} FusedLayerNorm modules, expected '
          f'{LN_PER_FORWARD}')
    plain = build_dinoseg(gen)                      # the default LayerNorm
    state, step = adamw_step(model)
    x = torch.randn(TRAIN_BATCH, TILE, TILE, 3, generator=gen, device='cuda')
    y = torch.randint(0, CLASSES, (TRAIN_BATCH, TILE, TILE), generator=gen, device='cuda')
    for _ in range(WARMUP_STEPS):
        state, _ = step(state, (x, y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    metrics = []
    events[0].record()
    for i in range(TIMED_STEPS):
        state, m = step(state, (x, y))
        events[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    launches = train_launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    times = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    med = sorted(times)[len(times) // 2]
    losses = [m['cls_loss'].item() for m in metrics]
    norms = [m['grad_norm'].item() for m in metrics]
    want = (24 * TIMED_STEPS, 24 * TIMED_STEPS, LN_PER_FORWARD * TIMED_STEPS,
            LN_PER_FORWARD * TIMED_STEPS)
    print(f'fused-LN: train, DinoSeg vitl16_sat493m with EVER_FUSED_LN=1, bf16 compute, '
          f'float32 params, AdamW + cosine; {TRAIN_BATCH} tiles of {TILE}²; median '
          f'{med * 1e3:.2f} ms/step (min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) '
          f'= {TRAIN_BATCH / med:.1f} tiles/s; MFU {TRAIN_FLOPS / med / PEAK_BF16_FLOPS:.4f}; '
          f'peak memory {peak:.2f} GiB', flush=True)
    print(f'fused-LN: loss per step {" ".join(f"{v:.5f}" for v in losses)}; grad_norm '
          f'{" ".join(f"{v:.4f}" for v in norms)}', flush=True)
    print(f'fused-LN: launches in {TIMED_STEPS} steps (K1, K2, K4, K5): {launches} '
          f'(expected {want})', flush=True)
    check(launches == want, f'fused-LN train steps launched {launches}, expected {want}')
    check(all(math.isfinite(v) for v in losses + norms), 'non-finite loss or grad_norm')
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          'parameters left float32')
    if profile:
        profile_run('one fused-LN train step', lambda: step(state, (x, y)))
    del state, step, metrics
    torch.cuda.empty_cache()

    # gradients of 2 tiles: fused LayerNorm vs the default one, same weights
    plain.load_state_dict(model.state_dict())
    loss_f, g_fused = loss_and_grads(model, x[:2], y[:2], seed=5)
    loss_p, g_plain = loss_and_grads(plain, x[:2], y[:2], seed=5)
    rel, worst, cos = compare_grads(g_fused, g_plain)
    names = [n for n, _ in model.named_parameters()]
    print(f'fused-LN: gradients of 2 tiles, fused vs default LayerNorm: loss {loss_f:.6f} '
          f'vs {loss_p:.6f}; ||dg||/||g|| {rel:.3e}, worst per-tensor cosine {worst:.6f} '
          f'({names[cos.index(worst)]}), block 0 norm1 weight cosine '
          f'{cos[names.index("vit.blocks.0.norm1.weight")]:.6f} (limits '
          f'{FUSED_LN_GRAD_REL_TOL}, {FUSED_LN_GRAD_COS_MIN})', flush=True)
    check(rel <= FUSED_LN_GRAD_REL_TOL and worst >= FUSED_LN_GRAD_COS_MIN,
          'fused-LN gradients disagree with the default LayerNorm\'s')
    del g_fused, g_plain
    torch.cuda.empty_cache()

    # serving: bf16 parameters, one scene, one tile batch against the default
    model.to(torch.bfloat16)
    plain.to(torch.bfloat16)
    scene = torch.randn(SCENE, SCENE, 3, generator=gen, device='cuda')

    def serve():
        out = tiled_inference(model, scene, TILE, STRIDE, CLASSES, tile_batch=TILE_BATCH)
        torch.cuda.synchronize()
        return out

    serve()                                         # warm-up scene
    reset_counts()
    t0 = time.perf_counter()
    out = serve()
    secs = time.perf_counter() - t0
    launches = counts()
    n_tiles = (SCENE // STRIDE) ** 2
    batches = n_tiles // TILE_BATCH
    want = (24 * batches, 0, LN_PER_FORWARD * batches, 0)
    print(f'fused-LN: serve {n_tiles} tiles in {secs * 1e3:.1f} ms/scene = '
          f'{n_tiles / secs:.1f} tiles/s; launches (K1, K2, K4, K5) {launches} (expected '
          f'{want})', flush=True)
    check(launches == want, f'fused-LN scene launched {launches}, expected {want}')
    check(tuple(out.shape) == (SCENE, SCENE, CLASSES), f'bad output shape {tuple(out.shape)}')
    check(bool(torch.isfinite(out).all()), 'non-finite probabilities')
    check(float((out.sum(-1) - 1).abs().max()) < 1e-3, 'class probabilities do not sum to 1')
    tiles = torch.stack([scene[i * TILE:(i + 1) * TILE, :TILE] for i in range(TILE_BATCH)])
    with torch.no_grad():
        fused_ms = cuda_ms(lambda: model(tiles), iters=3, warmup=1)
        plain_ms = cuda_ms(lambda: plain(tiles), iters=3, warmup=1)
        p_fused, p_plain = model(tiles), plain(tiles)
    diff = (p_fused - p_plain).abs()
    agree = (p_fused.argmax(-1) == p_plain.argmax(-1)).float().mean().item()
    print(f'fused-LN: tile batch of {TILE_BATCH}: {fused_ms:.2f} ms with the fused '
          f'LayerNorm, {plain_ms:.2f} ms with the default; max|dp| {diff.max().item():.3e}, '
          f'mean|dp| {diff.mean().item():.3e} (tolerances {SLICE_MAX_TOL}, {SLICE_MEAN_TOL}), '
          f'argmax agreement {agree:.4f}', flush=True)
    check(diff.max().item() <= SLICE_MAX_TOL and diff.mean().item() <= SLICE_MEAN_TOL,
          'fused-LN and default-LN models disagree on a tile batch')
    if profile:
        with torch.no_grad():
            profile_run('one fused-LN serving tile batch', lambda: model(tiles))
    return train_launches[2], train_launches[3]


def check_quantize(gen) -> int:
    """K6 against its plain version in both modes at every shape (exactly),
    and the stochastic mode's error statistics at the first; the largest
    |kernel - plain| over all of them, in int8 steps."""
    from ever_tpu_torch.ops import quant as Q

    worst = 0
    for i, (m, k) in enumerate(QUANT_SHAPES):
        x = torch.randn(m, k, generator=gen, device='cuda')
        for stochastic in (True, False):
            q, s = Q.quantize_int8(x, seed=1, stochastic=stochastic)
            torch.cuda.synchronize()
            rq, rs = Q.quantize_int8_reference(x, seed=1, stochastic=stochastic)
            same = torch.equal(q, rq) and torch.equal(s, rs)
            worst = max(worst, int((q.int() - rq.int()).abs().max()))
            mode = 'stochastic' if stochastic else 'nearest'
            print(f'kernels: quantize [{m}, {k}] {mode}: equal to the plain version '
                  f'{same} ({int((q != rq).sum())} values differ), scale {s.item():.6g}',
                  flush=True)
            check(q.dtype == torch.int8 and q.shape == x.shape, f'quantize [{m}, {k}]: '
                  f'values are {q.dtype} {tuple(q.shape)}')
            check(same, f'quantize [{m}, {k}] {mode} differs from its plain version')
        if i:
            continue
        # stochastic rounding: |q·s - x| < s, and unbiased.  The error of one
        # element is (1 - f)·s or -f·s with f the fraction of x/s, of
        # variance f(1 - f)·s²: the mean's σ follows from the data.  float32
        # rounding of x/s, of the added u and of q·s at |x/s| <= 127 adds at
        # most three half-ulps of 127, 1.2e-5·s.
        q, s = Q.quantize_int8(x, seed=1, stochastic=True)
        s = s.item()
        err = q.float() * s - x
        v = x / s
        frac = v - torch.floor(v)
        sigma = s * math.sqrt((frac * (1 - frac)).double().mean().item() / x.numel())
        mean_err = err.double().mean().item()
        q2, _ = Q.quantize_int8(x, seed=2, stochastic=True)
        differ = (q2 != q).float().mean().item()
        print(f'kernels: quantize [{m}, {k}] stochastic: max|q·s-x| '
              f'{err.abs().max().item():.4e} (scale {s:.4e}), mean(q·s-x) {mean_err:.3e} '
              f'(σ {sigma:.3e}, limit 5σ); seed 2 vs seed 1: {differ:.4f} of the values '
              f'differ', flush=True)
        check(err.abs().max().item() <= s * (1 + 2 ** -15), 'stochastic rounding error '
              'exceeds one step')
        check(abs(mean_err) <= 5 * sigma, 'stochastic rounding is biased')
        check(differ > 0.1, 'seeds 1 and 2 round alike')
    return worst


def kernel_mm_path(x_q, w_t) -> str:
    """The path the built K7 library picks for these operands."""
    import ctypes
    from ever_tpu_torch.ops import _build
    from ever_tpu_torch.ops import quant as Q

    fn = _build.load('int8_matmul').ever_int8_matmul_path
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    return Q.MM_PATHS[fn(x_q.data_ptr(), w_t.data_ptr(), x_q.shape[1])]


def check_int8_matmul(gen) -> float:
    """K7 against its plain version at every case, exactly, on the path the
    case is meant to take (the wrapper's prediction and the kernel's own
    choice must both name it); the largest |kernel - plain| over the cases."""
    from ever_tpu_torch.ops import quant as Q

    worst = 0.0
    for m, k, n, offset, path in MM_CASES:
        buf = torch.randint(-128, 128, (m * k + 16,), generator=gen, device='cuda',
                            dtype=torch.int8)
        xq = buf[offset:offset + m * k].view(m, k)
        wq = torch.randint(-128, 128, (k, n), generator=gen, device='cuda', dtype=torch.int8)
        wt = wq.t().contiguous()
        xs = torch.tensor([[0.0131]], device='cuda')
        ws = torch.tensor([[0.00217]], device='cuda')
        paths = (Q.int8_matmul_path(xq, wt), kernel_mm_path(xq, wt))
        out = Q.int8_matmul_t(xq, xs, wt, ws)
        torch.cuda.synchronize()
        ref = Q.int8_matmul_reference(xq, xs, wq, ws)
        same = torch.equal(out, ref)
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        print(f'kernels: int8_matmul [{m}, {k}] x [{k}, {n}] (x_q offset {offset}): path '
              f'{paths[1]} (wrapper predicts {paths[0]}, case wants {path}); equal to the '
              f'plain version {same} (max|d| {err:.3e}, max|out| '
              f'{ref.abs().max().item():.3e})', flush=True)
        check(paths == (path, path), f'int8_matmul [{m}, {k}] x [{k}, {n}] took {paths}')
        check(out.dtype == torch.float32 and out.shape == (m, n), f'int8_matmul: out is '
              f'{out.dtype} {tuple(out.shape)}')
        check(same, f'int8_matmul [{m}, {k}] x [{k}, {n}] differs from its plain version')
    return worst


def phase_quant(gen):
    """K6 and K7 checked, the QuantDense layer driven at the serving shape
    and held against float32, then all timed: their records."""
    from ever_tpu_torch.ops import quant as Q

    q_err, mm_err = check_quantize(gen), check_int8_matmul(gen)
    m, k = QUANT_SHAPES[0]
    n = MM_CASES[0][2]
    kernel = 0.02 * torch.randn(k, n, generator=gen, device='cuda')
    bias = 0.02 * torch.randn(n, generator=gen, device='cuda')
    x = torch.randn(m, k, generator=gen, device='cuda')
    reset_counts()
    layer = Q.QuantDense.from_params({'kernel': kernel, 'bias': bias}, seed=3, device='cuda')
    out = layer(x)
    torch.cuda.synchronize()
    launches = (Q.quantize_int8_values.launches, Q.int8_matmul_t.launches)
    ref = x @ kernel + bias
    rel = rel_norm(out, ref)
    # each operand's rounding error has variance s²·E[f(1 - f)] per element,
    # s²/6 stochastically and s²/12 to nearest, independent of the values:
    # the product's relative error is about the root of the two operands'
    # error-to-signal ratios
    noise = (layer.w_scale.item() ** 2 / kernel.square().mean().item()
             + (x.abs().amax().item() / 127) ** 2 / x.square().mean().item())
    # the same product rounded to nearest, composed from its parts as the
    # layer composes them: tools/quant_check.py's mode and limit
    w_n, ws_n = Q.quantize_int8(kernel, stochastic=False)
    x_n, xs_n = Q.quantize_int8(x, stochastic=False)
    rel_nearest = rel_norm(Q.int8_matmul_t(x_n, xs_n, w_n.t().contiguous(), ws_n) + bias, ref)
    print(f'quant: QuantDense.from_params [{k}, {n}] with bias, x [{m}, {k}]: '
          f'||y - (x @ w + b)|| / ||x @ w + b|| {rel:.4e} with stochastic rounding (the '
          f'card\'s default; its noise predicts {math.sqrt(noise / 6):.4e}, limit 1.1× that), '
          f'{rel_nearest:.4e} to nearest (predicted {math.sqrt(noise / 12):.4e}, limit '
          f'{QUANT_REL_TOL}); launches (K6, K7) {launches} (expected (2, 1): the weights, then '
          f'the activation)', flush=True)
    check(out.dtype == torch.float32 and out.shape == (m, n) and bool(torch.isfinite(out).all()),
          'QuantDense output is not finite float32 of the right shape')
    check(rel <= 1.1 * math.sqrt(noise / 6), 'stochastic QuantDense disagrees with float32')
    check(rel_nearest < QUANT_REL_TOL, 'QuantDense to nearest disagrees with float32')
    check(launches == (2, 1), f'QuantDense launched {launches}')

    # K6 alone: the values of the activation at its scale, stochastic (the
    # serving path) and to nearest
    s = torch.clamp(x.abs().amax() / 127.0, min=1e-8).reshape(1, 1)
    q_ms = graph_ms(lambda: Q.quantize_int8_values(x, s, 1, True), iters=50)
    qn_ms = graph_ms(lambda: Q.quantize_int8_values(x, s, 1, False), iters=50)
    q_plain = graph_ms(lambda: Q.quantize_int8_values_reference(x, s, 1, True), iters=3)
    # yardstick only: the library's per-tensor quantization, to nearest
    s_value = s.item()
    q_lib = graph_ms(lambda: torch.quantize_per_tensor(x, s_value, 0, torch.qint8), iters=50)
    q_bytes = x.numel() * 5
    q_bound, q_by = bound(3.0 * x.numel(), q_bytes, PEAK_F32_FLOPS)
    print(f'kernels: quantize_int8 [{m}, {k}] {q_ms:.4f} ms/launch stochastic '
          f'({q_bytes / q_ms / 1e9:.3f} TB/s), {qn_ms:.4f} to nearest; plain {q_plain:.4f} ms; '
          f'library (quantize_per_tensor, nearest) {q_lib:.4f} ms; bound {q_bound:.4f} ms '
          f'({q_bytes / 1e6:.1f} MB)', flush=True)

    # K7 alone on QuantDense's operands; the [K, N] API with its per-call
    # transpose; the library's int8 and bf16 products of the same shape
    xq, xs = Q.quantize_int8(x, seed=1)
    wt, ws = layer.weight_t, layer.w_scale
    wq = wt.t().contiguous()
    mm_ms = graph_ms(lambda: Q.int8_matmul_t(xq, xs, wt, ws), iters=20)
    api_ms = graph_ms(lambda: Q.int8_matmul(xq, xs, wq, ws), iters=20)
    mm_plain = graph_ms(lambda: Q.int8_matmul_reference(xq, xs, wq, ws), iters=3)
    mm_lib = graph_ms(lambda: torch._int_mm(xq, wt.t()), iters=20)
    xb, wb = x.to(torch.bfloat16), kernel.to(torch.bfloat16)
    bf16_ms = graph_ms(lambda: xb @ wb, iters=20)
    layer_ms = cuda_ms(lambda: layer(x), iters=20)
    ops = 2.0 * m * k * n
    mm_bytes = m * k + k * n + 4 * m * n
    mm_bound, mm_by = bound(ops, mm_bytes, PEAK_INT8_OPS)
    print(f'kernels: int8_matmul [{m}, {k}] x [{k}, {n}] {mm_ms:.4f} ms/launch '
          f'({ops / mm_ms / 1e9:.1f} TOP/s), with the [K, N] transpose {api_ms:.4f} ms; plain '
          f'{mm_plain:.4f} ms; library torch._int_mm {mm_lib:.4f} ms, bf16 matmul '
          f'{bf16_ms:.4f} ms; bound {mm_bound:.4f} ms ({ops / 1e9:.1f} G operations)',
          flush=True)
    print(f'quant: QuantDense layer at x [{m}, {k}]: {layer_ms:.4f} ms per call from Python '
          f'(scale, K6, K7, bias)', flush=True)
    return (dict(name='quantize_int8', route='cuda', source='ever_tpu_torch/csrc/quant_int8.cu',
                 replaces='ever_tpu/ops/quant.py:35', launches=launches[0],
                 max_abs_err=float(q_err), ms=q_ms, plain_ms=q_plain, bound_ms=q_bound,
                 bound_by=q_by, library_ms=q_lib),
            dict(name='int8_matmul', route='cuda', source='ever_tpu_torch/csrc/int8_matmul.cu',
                 replaces='ever_tpu/ops/quant.py:110', launches=launches[1],
                 max_abs_err=mm_err, ms=mm_ms, plain_ms=mm_plain, bound_ms=mm_bound,
                 bound_by=mm_by, library_ms=mm_lib))


# the trainer phase: the project template's DinoSeg config, its data and
# run length replaced by seeded in-memory crops (LoveDA needs image files)
TEMPLATE_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               'project_template', 'configs', 'dinoseg_vitl_loveda.py')
TRAINER_ITERS, RESUME_ITERS, EVAL_SCENE, EVAL_BATCH = 8, 10, 2 * TILE, 2
# a timing run without periodic checkpoints: every logged interval of the
# first run holds one 3.6 GB save (the fresh 10-step run saves at its end)
TIMING_ITERS = 12
# d4 TTA of a 1024² scene against per-tile tta() calls: the same model and
# kernels, but 16 tiles a forward against 1, so cuBLAS tiles the bf16
# products differently and each of the 24 blocks rounds differently: the
# regime of the serve phase's kernel-against-plain tile batch, with its limits
TTA_MAX_TOL, TTA_MEAN_TOL = SLICE_MAX_TOL, SLICE_MEAN_TOL


def register_smoke_data():
    """Register ``smoke_scenes`` in the port's DATASET registry: seeded
    float32 images ``[n, size, size, 3]`` with uint8 masks over 7 classes
    and 2 % ignored (255) pixels, made in bulk from ``seed``."""
    import numpy as np
    from ever_tpu_torch.core import registry
    from ever_tpu_torch.interface import ERDataset

    @registry.DATASET.register('smoke_scenes')
    class SmokeScenes(ERDataset):
        def set_default_config(self):
            self.config.update(dict(num_samples=16, image_size=TILE, seed=0))

        def __init__(self, config=None):
            super().__init__(config)
            c = self.config
            rng = np.random.default_rng(c.seed)
            shape = (c.num_samples, c.image_size, c.image_size)
            self.x = rng.standard_normal(shape + (3,), dtype=np.float32)
            self.y = rng.integers(0, CLASSES, shape, dtype=np.uint8)
            self.y[rng.random(shape, dtype=np.float32) < 0.02] = 255

        def __len__(self):
            return self.config.num_samples

        def __getitem__(self, idx):
            return self.x[idx], self.y[idx]


def d4_transforms():
    """The 8 symmetries in ``d4_tta``'s order, as the port's transforms:
    rotations by 0-3 quarter turns, then the same after a horizontal flip."""
    from ever_tpu_torch.interface.transform_base import Transform
    from ever_tpu_torch.magic import transform as T

    class FlipThen(Transform):
        """A horizontal flip, then ``rotation``; inverted in reverse."""

        def __init__(self, rotation):
            self.flip, self.rotation = T.HorizontalFlip(), rotation

        def transform(self, x):
            return self.rotation.transform(self.flip.transform(x))

        def inv_transform(self, y):
            return self.flip.inv_transform(self.rotation.inv_transform(y))

    rots = [T.Identity(), T.Rotate90k(1), T.Rotate90k(2), T.Rotate90k(3)]
    return rots + [FlipThen(r) for r in rots]


def trainer_run(model_dir: str, num_iters: int, seed: int, init_state=None, opts=(),
                sync_free: bool = False, config_path: str = TEMPLATE_CONFIG):
    """``get_trainer('th_ddp')().run()`` of the template config (or
    ``config_path``) into ``model_dir`` (``opts``: more config overrides,
    after this function's own); returns the launcher
    and what it logged, evaluated and saved.  ``sync_free``: the training
    loop runs under ``torch.cuda.set_sync_debug_mode('error')``, which
    raises on any synchronizing CUDA call (the logged steps' event waits are
    not one)."""
    from ever_tpu_torch.trainer import get_trainer

    train = dict(num_samples=16, image_size=TILE, seed=seed, total_batch_size=TRAIN_BATCH,
                 sampler_type='StepDistributedSampler')
    test = dict(num_samples=4, image_size=EVAL_SCENE, seed=seed + 1, batch_size=EVAL_BATCH,
                sampler_type='SequentialSampler')
    argv = ['--config_path', config_path, '--model_dir', model_dir,
            'data.train.type', 'smoke_scenes', 'data.train.params', repr(train),
            'data.test.type', 'smoke_scenes', 'data.test.params', repr(test),
            'train.num_iters', str(num_iters), 'train.save_ckpt_interval_epoch', '1',
            'train.eval_after_train', 'True', 'train.log_interval_step', '2', *opts]
    record = dict(logged=[], evals=[], saves=[])

    def wire(launcher):
        if init_state is not None:
            launcher.set_pretrained_state(init_state)
        train_log, evaluate = launcher.logger.train_log, launcher.evaluate
        save = launcher.checkpoint.save

        def timed_save(filename=None):
            t0 = time.perf_counter()
            save(filename)
            record['saves'].append(time.perf_counter() - t0)

        def logged(step, num_iters, loss_dict, data_time, time_cost, lr):
            record['logged'].append((step, dict(loss_dict), data_time, time_cost))
            return train_log(step, num_iters, loss_dict, data_time, time_cost, lr)

        def evaluated(data_loader, config=None):
            torch.cuda.synchronize()
            before, t0 = counts(), time.perf_counter()
            table = evaluate(data_loader, config)
            torch.cuda.synchronize()
            record['evals'].append((table, time.perf_counter() - t0,
                                    [a - b for a, b in zip(counts(), before)],
                                    len(data_loader)))
            return table

        launcher.logger.train_log, launcher.evaluate = logged, evaluated
        launcher.checkpoint.save = timed_save
        if sync_free:
            loop = launcher._train_loop

            def checked_loop(*args, **kwargs):
                torch.cuda.set_sync_debug_mode('error')
                try:
                    return loop(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode(0)

            launcher._train_loop = checked_loop

    reset_counts()
    out = get_trainer('th_ddp', argv=argv)().run(after_construct_launcher_callbacks=[wire])
    torch.cuda.synchronize()
    record['launches'] = counts()
    return out['launcher'], record


def record_confusion(seen: list):
    """Wrap ``ConfusionMatrix.forward`` to keep, for every batch counted, the
    device it counted on, its matrix and the labels and predictions copied
    to the host; returns the undo."""
    from ever_tpu_torch.metric.confusion_matrix import ConfusionMatrix

    forward = ConfusionMatrix.forward

    def recorded(self, y_true, y_pred):
        cm = forward(self, y_true, y_pred)
        pred = y_pred.argmax(dim=-1) if y_pred.ndim == y_true.ndim + 1 else y_pred
        seen.append((y_pred.device.type, cm, torch.as_tensor(y_true).cpu().numpy(),
                     pred.cpu().numpy()))
        return cm

    ConfusionMatrix.forward = ConfusionMatrix.update = recorded

    def undo():
        ConfusionMatrix.forward = ConfusionMatrix.update = forward
    return undo


def check_run(name: str, launcher, record: dict, steps: int, evals: int) -> None:
    """Finite losses, the step count, the checkpoint index and the exact
    launches of a trainer run: K1 24 a train step and an eval batch, K2 24
    a train step; the evaluation's own share of K1 and no K2."""
    from ever_tpu_torch.core.checkpoint import CheckPoint

    losses = [d['total_loss'] for _, d, _, _ in record['logged']]
    k1, k2 = record['launches'][:2]
    want_k1 = 24 * (steps + evals * record['evals'][-1][3])
    info = CheckPoint.load_checkpoint_info(launcher.model_dir)
    print(f'trainer: {name}: step {launcher.global_step}, logged steps '
          f'{[s for s, _, _, _ in record["logged"]]}, loss {" ".join(f"{v:.5f}" for v in losses)}; '
          f'last checkpoint {info["last"]}; attention_fwd {k1} (expected {want_k1}), '
          f'attention_bwd {k2} (expected {24 * steps}); evaluation launches '
          f'{[e[2][:2] for e in record["evals"]]}', flush=True)
    check(all(math.isfinite(v) for v in losses), f'{name}: non-finite loss')
    check(info['last']['name'] == f'checkpoint-{launcher.global_step}.ckpt'
          and os.path.exists(os.path.join(launcher.model_dir, info['last']['name'])),
          f'{name}: checkpoint_info names no last checkpoint')
    check((k1, k2) == (want_k1, 24 * steps), f'{name}: launches {(k1, k2)}')
    check(len(record['evals']) == evals and all(
        tuple(e[2][:2]) == (24 * e[3], 0) for e in record['evals']),
        f'{name}: evaluation launches')


def phase_trainer(gen, seed: int, bare_ms: float, smi: str) -> None:
    """The config-driven run: train, evaluate, checkpoint, resume and serve
    under d4 TTA the template's DinoSeg ViT-L/16 through the port's
    ``Trainer``."""
    import shutil
    import tempfile

    import numpy as np
    from ever_tpu_torch import tiled_inference
    from ever_tpu_torch.magic.transform import tta
    from ever_tpu_torch.ops import attention as A

    register_smoke_data()
    init = build_dinoseg(gen)
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    with tempfile.TemporaryDirectory(prefix='chip_smoke_trainer_') as tmp:
        # a: the run, b: the evaluation's matrix against the host's
        seen = []
        undo = record_confusion(seen)
        try:
            la, ra = trainer_run(os.path.join(tmp, 'a'), TRAINER_ITERS, seed, init_state)
        finally:
            undo()
        check_run('run', la, ra, TRAINER_ITERS, 1)
        table = ra['evals'][0][0]
        print(f'trainer: evaluation of {len(seen)} batches of {EVAL_BATCH} {EVAL_SCENE}² '
              f'scenes after {TRAINER_ITERS} steps:\n{table}', flush=True)
        dumps = sorted(os.listdir(os.path.join(la.model_dir, 'cm')))
        card_cm = np.load(os.path.join(la.model_dir, 'cm', dumps[-1]))
        truth = np.concatenate([y.reshape(-1) for _, _, y, _ in seen])
        pred = np.concatenate([p.reshape(-1) for _, _, _, p in seen])
        valid = truth != 255
        host_cm = np.bincount(truth[valid].astype(np.int64) * CLASSES + pred[valid],
                              minlength=CLASSES * CLASSES).reshape(CLASSES, CLASSES)
        print(f'trainer: confusion matrix counted on {sorted({d for d, _, _, _ in seen})}, '
              f'{int(card_cm.sum())} pixels; equal to np.bincount of the host copies: '
              f'{bool(np.array_equal(card_cm, host_cm))}', flush=True)
        check(len(seen) == 2 and all(d == 'cuda' for d, _, _, _ in seen),
              'the evaluation did not count its matrix on the card')
        check(np.array_equal(card_cm, host_cm) and int(host_cm.sum()) == int(valid.sum()),
              "the card's confusion matrix differs from the host's")

        def medians(record):
            logged = record['logged'][2:]
            return ([s for s, _, _, _ in logged],
                    sorted(t for _, _, _, t in logged)[len(logged) // 2],
                    sorted(d for _, _, d, _ in logged)[len(logged) // 2])

        # the run's times with its save every 2 steps, for e
        steps_a, per_step_a, data_a = medians(ra)
        saves = sorted(ra['saves'])
        del la, ra, seen
        torch.cuda.empty_cache()

        # c: resume to 10 steps against a fresh 10-step run
        lb, rb = trainer_run(os.path.join(tmp, 'a'), RESUME_ITERS, seed)
        check_run('resumed run', lb, rb, RESUME_ITERS - TRAINER_ITERS, 1)
        check(rb['logged'][0][0] == TRAINER_ITERS + 2, 'the resumed run did not start at '
              f'step {TRAINER_ITERS}')
        resumed = [p.detach().clone() for p in lb.model.parameters()]
        del lb, rb
        shutil.rmtree(os.path.join(tmp, 'a'))
        torch.cuda.empty_cache()
        lc, rc = trainer_run(os.path.join(tmp, 'c'), RESUME_ITERS, seed, init_state,
                             opts=('train.save_ckpt_interval_epoch', '1000'))
        check_run('fresh run', lc, rc, RESUME_ITERS, 1)
        # the train step is deterministic (K1, K2, cuBLAS, and DinoSeg's
        # logits upsampled by matrix products, whose backward adds no atomics)
        # and the batches are seeded by the step: the two runs agree bit for bit
        delta = max(float((a - b.detach()).abs().max())
                    for a, b in zip(resumed, lc.model.parameters()))
        print(f'trainer: {TRAINER_ITERS} steps + resume to {RESUME_ITERS} against '
              f'{RESUME_ITERS} steps at once: max|dp| {delta:.3e} (gate: equal bits)',
              flush=True)
        check(delta == 0.0, 'the resumed run differs from the unbroken run')
        del resumed

        # e: times through the Launcher (with a save every 2 steps in a,
        # then without), the checkpoint saves, the evaluation and the TTA scene
        size = os.path.getsize(os.path.join(lc.model_dir, f'checkpoint-{RESUME_ITERS}.ckpt'))
        eval_secs = rc['evals'][0][1]
        model = lc.model
        del lc, rc
        shutil.rmtree(os.path.join(tmp, 'c'))
        torch.cuda.empty_cache()
        ld, rd = trainer_run(os.path.join(tmp, 'd'), TIMING_ITERS, seed, init_state,
                             opts=('train.save_ckpt_interval_epoch', '1000',
                                   'train.eval_after_train', 'False'), sync_free=True)
        check(rd['launches'][:2] == (24 * TIMING_ITERS, 24 * TIMING_ITERS)
              and len(rd['saves']) == 1 and not rd['evals'],
              f'timing run: launches {rd["launches"][:2]}, {len(rd["saves"])} saves')
        steps_d, per_step_d, data_d = medians(rd)
        del ld, rd
        torch.cuda.empty_cache()
        print(f'trainer: {smi}: through the Launcher median {per_step_d * 1e3:.2f} ms/step '
              f'over logged steps {steps_d} without periodic checkpoints and without a host sync (loading, '
              f'callbacks and copies {data_d * 1e3:.2f} ms/step of it), against '
              f'{bare_ms:.2f} ms/step for build_train_step alone (train phase); with a '
              f'checkpoint every 2 steps {per_step_a * 1e3:.2f} ms/step over logged steps '
              f'{steps_a} ({data_a * 1e3:.2f} of it loading and callbacks); '
              f'{len(saves)} checkpoint saves of {size / 1e9:.2f} GB, median '
              f'{saves[len(saves) // 2]:.2f} s ({size / 1e9 / saves[len(saves) // 2]:.2f} '
              f'GB/s); evaluation {eval_secs / 4:.3f} s per {EVAL_SCENE}² scene', flush=True)

    # d: the trained model under d4 TTA against per-tile tta() calls
    scene = torch.randn(EVAL_SCENE, EVAL_SCENE, 3, generator=gen, device='cuda')
    sizes = []

    def predict(tiles):
        sizes.append(tiles.shape[0])
        return model(tiles)

    def scene_secs(**kw):
        tiled_inference(model, scene, TILE, TILE, CLASSES, tile_batch=2, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tiled_inference(model, scene, TILE, TILE, CLASSES, tile_batch=2, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    reset_counts()
    got = tiled_inference(predict, scene, TILE, TILE, CLASSES, tile_batch=2, tta='d4')
    torch.cuda.synchronize()
    k1 = A.fused_attention.launches
    want = torch.zeros_like(got)
    d4 = d4_transforms()
    with torch.no_grad():
        for y in range(0, EVAL_SCENE, TILE):
            for x in range(0, EVAL_SCENE, TILE):
                tile = scene[None, y:y + TILE, x:x + TILE]
                want[y:y + TILE, x:x + TILE] = tta(model, tile, d4)[0].float()
    diff = (got - want).abs()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    n_tiles = (EVAL_SCENE // TILE) ** 2
    print(f'trainer: tiled_inference(tta="d4") of a {EVAL_SCENE}² scene, tile_batch=2: '
          f'model calls of {sizes} tiles, attention_fwd {k1} (expected '
          f'{24 * n_tiles // 2}); against per-tile tta() max|dprob| {diff.max().item():.3e}, '
          f'mean {diff.mean().item():.3e} (limits {TTA_MAX_TOL}, {TTA_MEAN_TOL}), argmax '
          f'agreement {agree:.4f}', flush=True)
    check(sizes == [8 * 2] * (n_tiles // 2) and k1 == 24 * n_tiles // 2,
          f'd4 TTA ran {sizes} tiles a call and {k1} K1 launches')
    check(bool(torch.isfinite(got).all()) and diff.max().item() <= TTA_MAX_TOL
          and diff.mean().item() <= TTA_MEAN_TOL, 'd4 TTA disagrees with per-tile tta()')
    plain, _ = scene_secs()
    d4_secs, _ = scene_secs(tta='d4')
    print(f'trainer: {smi}: the {EVAL_SCENE}² scene at {n_tiles / plain:.1f} tiles/s '
          f'({plain * 1e3:.1f} ms) without TTA, {n_tiles / d4_secs:.1f} tiles/s '
          f'({d4_secs * 1e3:.1f} ms) with tta="d4"', flush=True)
    del model
    torch.cuda.empty_cache()


# the workflow phase: a project made by `create`, a LoveDA tree on disk
# (1024² RGB scenes, the LoveDA layout and mask encoding), pretrained weights
# from files, the project's train.py and infer.py
WORKFLOW_SCENE, WORKFLOW_TRAIN, WORKFLOW_VAL = 1024, 4, 1      # scenes per domain
WORKFLOW_ITERS, FARSEG_ITERS, WORKFLOW_WORKERS = 6, 4, 4
# tiled_inference of the served model: probabilities sum to 1 (bf16 model,
# f32 canvas); one bf16 ulp at 1 is 2^-8, the average of overlaps keeps it
PROB_SUM_TOL = 1e-3


def write_loveda(root: str, seed: int, layout=None, nodata=lambda i: 32) -> list:
    """A LoveDA tree (Train and Val, Urban and Rural) of seeded scenes:
    blocky class regions, each class its own colour plus noise, masks in
    the official encoding (0 = no-data, a corner of ``nodata(i)``² in scene
    i).  ``layout`` lists (split, domain, scenes, size); by default 4 train
    and 1 val scene of 1024² a domain.  The images are written with the
    five PNG filters in turn; returns (path, array, filter) of each."""
    import numpy as np
    from ever_tpu_torch.data._png import write_png

    if layout is None:
        layout = [(split, dom, n, WORKFLOW_SCENE)
                  for split, n in (('Train', WORKFLOW_TRAIN), ('Val', WORKFLOW_VAL))
                  for dom in ('Urban', 'Rural')]
    rng = np.random.default_rng(seed)
    palette = rng.integers(30, 220, (CLASSES, 3))
    written = []
    for split, dom, n, size in layout:
        for d in ('images_png', 'masks_png'):
            os.makedirs(os.path.join(root, split, dom, d))
        for i in range(n):
            blocks = size // 64
            label = np.kron(rng.integers(0, CLASSES, (blocks, blocks)),
                            np.ones((64, 64), np.int64))
            noise = rng.integers(-20, 21, (size, size, 3))
            img = np.clip(palette[label] + noise, 0, 255).astype(np.uint8)
            mask = (label + 1).astype(np.uint8)
            c = nodata(len(written))
            mask[:c, :c] = 0                                     # no-data
            name = f'{len(written)}.png'
            ft = len(written) % 5
            path = os.path.join(root, split, dom, 'images_png', name)
            write_png(path, img, filter_type=ft)
            write_png(os.path.join(root, split, dom, 'masks_png', name), mask)
            written.append((path, img, ft))
    return written


def run_project_script(script: str, argv: list, wire) -> dict:
    """``runpy`` of a project's ``train.py`` with ``argv``, ``wire`` added to
    the trainer's launcher callbacks; returns the run's ``{'config',
    'launcher'}``."""
    import runpy
    from ever_tpu_torch.trainer.trainer import Trainer

    run, out = Trainer.run, {}

    def wired(self, after_construct_launcher_callbacks=None):
        out.update(run(self, [wire]))
        return out

    Trainer.run, old_argv = wired, sys.argv
    sys.argv = [script, *argv]
    try:
        runpy.run_path(script, run_name='__main__')
    finally:
        Trainer.run, sys.argv = run, old_argv
    return out


def recorded_run(script: str, argv: list, sync_free: bool = False):
    """A project train.py run with its logged steps, the model's state just
    after ``init_state`` (weights loaded), ``load_weights``' report and the
    K1, K2 and K8 launches; ``sync_free`` runs the loop under
    ``torch.cuda.set_sync_debug_mode('error')``."""
    from ever_tpu_torch.ops import attention as A, pool as P
    from ever_tpu_torch.util import weight_io

    record = dict(logged=[], reports=[])
    load = weight_io.load_weights

    def loaded(*args, **kwargs):
        record['reports'].append(load(*args, **kwargs))
        return record['reports'][-1]

    def wire(launcher):
        train_log, init_state = launcher.logger.train_log, launcher.init_state

        def logged(step, num_iters, loss_dict, data_time, time_cost, lr):
            record['logged'].append((step, dict(loss_dict), data_time, time_cost))
            return train_log(step, num_iters, loss_dict, data_time, time_cost, lr)

        def snapshot():
            first = launcher.state is None
            init_state()
            if first:
                record['init'] = {k: v.detach().clone()
                                  for k, v in launcher.model.state_dict().items()}

        launcher.logger.train_log, launcher.init_state = logged, snapshot
        if sync_free:
            loop = launcher._train_loop

            def checked_loop(*args, **kwargs):
                torch.cuda.set_sync_debug_mode('error')
                try:
                    return loop(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode(0)

            launcher._train_loop = checked_loop

    reset_counts()
    weight_io.load_weights = loaded
    try:
        out = run_project_script(script, argv, wire)
    finally:
        weight_io.load_weights = load
    torch.cuda.synchronize()
    record['launches'] = (A.fused_attention.launches, A.fused_attention_bwd.launches,
                          P.max_pool_32_bwd.launches)
    return out['launcher'], record


def logged_medians(logged: list):
    """(ms/step, data ms/step): medians over the logged steps after the
    first.  A logged step's data time is that of the batch loaded while it
    ran (the Launcher logs a step after queuing the next), so the last
    step, with none after it, is left out of the data median."""
    steps = sorted(t for _, _, _, t in logged[1:])
    data = sorted(d for _, _, d, _ in logged[1:-1])
    return steps[len(steps) // 2] * 1e3, data[len(data) // 2] * 1e3


def check_prefetch_waits() -> None:
    """The prefetcher's consumer waits for the copies: its side stream is
    held back by a ~0.1 s sleep kernel, so a batch read without the wait
    would read memory the copy has not filled yet."""
    from ever_tpu_torch.core.prefetch import prefetch_to_device

    stream = torch.cuda.Stream

    def delayed(*args, **kwargs):
        s = stream(*args, **kwargs)
        if not kwargs:                 # a new stream; current_stream() wraps one by id
            with torch.cuda.stream(s):
                torch.cuda._sleep(200_000_000)
        return s

    batches = [torch.full((1024, 1024), float(i + 1)) for i in range(3)]
    torch.cuda.Stream = delayed
    try:
        sums = [float(b.sum()) for b in prefetch_to_device(iter(batches))]
    finally:
        torch.cuda.Stream = stream
    want = [float((i + 1) * 1024 * 1024) for i in range(3)]
    print(f'workflow: prefetch behind a delayed copy stream: batch sums {sums} '
          f'(expected {want})', flush=True)
    check(sums == want, 'the prefetched batches were read before their copies')


def phase_workflow(gen, seed: int, smi: str) -> None:
    """The user's workflow from files on disk: create a project, read a
    LoveDA tree, load pretrained weights, train the template's DinoSeg
    ViT-L/16 (normal and prefetched iterators) and FarSeg-R50 (stages
    frozen) through the project's train.py, serve the model dir through its
    infer.py, and read GeoTile patches in batches."""
    import re
    import tempfile

    import numpy as np
    from ever_tpu_torch import tiled_inference
    from ever_tpu_torch.data._png import read_png
    from ever_tpu_torch.data.geotile import GeoTileDataset
    from ever_tpu_torch.data.loveda import LoveDA

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix='chip_smoke_workflow_') as tmp:
        # a: create
        proj = os.path.join(tmp, 'proj')
        r = subprocess.run([sys.executable, '-m', 'ever_tpu_torch', 'create', proj], cwd=repo,
                           env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
                           text=True, timeout=300)
        check(r.returncode == 0, f'create failed: {r.stderr[-2000:]}')
        for script in ('train.py', 'infer.py'):
            with open(os.path.join(proj, script)) as f:
                text = f.read()
            check('import ever_tpu_torch as er' in text
                  and not re.search(r'^\s*(import|from)\s+ever_tpu\b(?!_torch)', text, re.M),
                  f'{script} does not import ever_tpu_torch alone')
        configs = sorted(os.listdir(os.path.join(proj, 'configs')))
        print(f'workflow: python -m ever_tpu_torch create: {configs}', flush=True)
        check('dinoseg_vitl_loveda.py' in configs and 'farseg_r50_loveda.py' in configs,
              'create copied no LoveDA configs')

        # b: the LoveDA tree, each filter decoded exactly, the decode time
        root = os.path.join(tmp, 'LoveDA')
        t0 = time.perf_counter()
        written = write_loveda(root, seed)
        write_s = time.perf_counter() - t0
        decode_ms = {}
        for path, img, ft in written[:5]:
            got = read_png(path)
            check(got.shape == img.shape and np.array_equal(got, img),
                  f'PNG filter {ft} decodes wrongly')
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                read_png(path)
                times.append(time.perf_counter() - t0)
            decode_ms[ft] = sorted(times)[1] * 1e3
        print(f'workflow: {smi}: {len(written)} scenes of {WORKFLOW_SCENE}² RGB written in '
              f'{write_s:.2f} s; each of the five PNG filters decodes exactly; decode ms per '
              f'{WORKFLOW_SCENE}² scene by filter: '
              + ', '.join(f'{ft} {ms:.2f}' for ft, ms in sorted(decode_ms.items()))
              + f' (mean {sum(decode_ms.values()) / 5:.2f})', flush=True)

        # c: a ViT-L/16 state_dict in the reference DINOv3 layout
        ref = build_dinoseg(gen)
        trunk = {k[len('vit.'):]: v.detach().cpu() for k, v in ref.state_dict().items()
                 if k.startswith('vit.')}
        del ref
        dim = EMBED
        for i in range(24):
            mask = torch.ones(3 * dim)
            mask[dim:2 * dim] = 0.0
            trunk[f'blocks.{i}.attn.qkv.bias_mask'] = mask
            trunk[f'blocks.{i}.attn.qkv.bias'][dim:2 * dim] = 1.0     # masked away on load
        trunk['mask_token'] = torch.zeros(1, dim)
        trunk['rope_embed.periods'] = torch.ones(D // 4)
        vit_pth = os.path.join(tmp, 'dinov3_vitl16_sat493m.pth')
        torch.save(trunk, vit_pth)

        # d: train the template's DinoSeg from the files, then prefetched
        cfg = os.path.join(proj, 'configs', 'dinoseg_vitl_loveda.py')

        def dinoseg_argv(model_dir):
            return ['--config_path', cfg, '--model_dir', model_dir,
                    'model.params.GLOBAL', repr(dict(weight=dict(path=vit_pth))),
                    'data.train.params.root', root, 'data.test.params.root', root,
                    'data.train.params.num_workers', str(WORKFLOW_WORKERS),
                    'train.num_iters', str(WORKFLOW_ITERS), 'train.log_interval_step', '1',
                    'train.save_ckpt_interval_epoch', '1000', 'train.eval_after_train', 'True']

        train_py = os.path.join(proj, 'train.py')
        la, ra = recorded_run(train_py, dinoseg_argv(os.path.join(tmp, 'run')))
        report = ra['reports'][0]
        init = ra['init']
        # the file's tensors as the reference converts them: the K bias masked
        converted = {k: v * trunk[k + '_mask'] if k.endswith('qkv.bias') else v
                     for k, v in trunk.items() if f'vit.{k}' in init}
        bad = [k for k, v in converted.items() if not torch.equal(init[f'vit.{k}'].cpu(), v)]
        dropped = [k for k in trunk if k not in converted]
        print(f'workflow: load_weights: {report.loaded} tensors loaded, missing {report.missing}, '
              f'{len(report.unexpected)} unexpected; {len(trunk) - len(dropped)} trunk tensors '
              f'bit-equal to the file\'s converted ones: {not bad}; dropped {len(dropped)} '
              f'(bias masks, mask_token, rope periods)', flush=True)
        check(not bad and len(dropped) == 26 and sorted(report.missing) == [
            'head_classifier.bias', 'head_classifier.weight'] and not report.mismatched,
            f'the trunk was not loaded from the file: {bad[:3]}')
        losses = [d['total_loss'] for _, d, _, _ in ra['logged']]
        k1, k2, _ = ra['launches']
        evals = 1                              # the 2 val scenes in one batch of 8
        print(f'workflow: DinoSeg ViT-L/16 from disk: steps {[s for s, _, _, _ in ra["logged"]]}, '
              f'loss {" ".join(f"{v:.5f}" for v in losses)}; attention_fwd {k1} (expected '
              f'{24 * (WORKFLOW_ITERS + evals)}), attention_bwd {k2} (expected '
              f'{24 * WORKFLOW_ITERS})', flush=True)
        check(len(losses) == WORKFLOW_ITERS and all(math.isfinite(v) for v in losses),
              'non-finite or missing losses')
        check((k1, k2) == (24 * (WORKFLOW_ITERS + evals), 24 * WORKFLOW_ITERS),
              f'DinoSeg launches {(k1, k2)}')
        trained_model = la.model.eval()
        trained = {k: v.detach().clone() for k, v in trained_model.state_dict().items()}
        model_dir = la.model_dir
        step_ms, data_ms = logged_medians(ra['logged'])
        del la
        torch.cuda.empty_cache()

        check_prefetch_waits()
        lp, rp = recorded_run(train_py, dinoseg_argv(os.path.join(tmp, 'prefetched')) + [
            'train.iterator_type', 'prefetched'], sync_free=True)
        same_losses = [d for _, d, _, _ in rp['logged']] == [d for _, d, _, _ in ra['logged']]
        same_params = all(torch.equal(v, trained[k]) for k, v in lp.model.state_dict().items())
        pf_step_ms, pf_data_ms = logged_medians(rp['logged'])
        print(f'workflow: {smi}: medians over steps 2-{WORKFLOW_ITERS}: normal iterator '
              f'{step_ms:.2f} ms/step, {data_ms:.2f} of it loading from disk; prefetched '
              f'{pf_step_ms:.2f} ms/step, '
              f'data {pf_data_ms:.2f} ms/step, its loop without a host sync; losses bit-equal: '
              f'{same_losses}, final parameters bit-equal: {same_params}; launches '
              f'{rp["launches"][:2]}', flush=True)
        check(same_losses and same_params, 'the prefetched run differs from the normal run')
        check(rp['launches'][:2] == (k1, k2), 'the prefetched run launched other kernels')
        del lp
        torch.cuda.empty_cache()

        # e: serve the model dir through the project's infer.py
        import runpy
        infer = runpy.run_path(os.path.join(proj, 'infer.py'))
        with open(os.path.join(model_dir, 'checkpoint_info.json')) as f:
            last = json.load(f)['last']
        served, state, step = infer['er'].infer_tool.build_from_model_dir(model_dir)
        same = all(torch.equal(state[k], v) for k, v in trained.items())
        val = LoveDA(dict(root=root, split='val'))
        x, y = val[0]
        xt = torch.from_numpy(x)[None].cuda()
        with torch.no_grad():
            fwd_equal = torch.equal(served(xt), trained_model(xt))
        del trained_model, trained
        print(f'workflow: build_from_model_dir: step {step} (checkpoint_info last {last}), '
              f'eval mode {not served.training}; parameters bit-equal to the trained model: '
              f'{same}; a {WORKFLOW_SCENE}² val scene\'s forward bit-equal: {fwd_equal}',
              flush=True)
        check(step == WORKFLOW_ITERS and last['name'] == f'checkpoint-{WORKFLOW_ITERS}.ckpt'
              and not served.training, f'build_from_model_dir chose step {step}')
        check(same and fwd_equal, 'the served model differs from the trained model')
        cm = np.zeros((CLASSES, CLASSES), np.int64)
        n_tiles = len(val) * (WORKFLOW_SCENE // TILE) ** 2
        tiled_inference(served, x, TILE, TILE, CLASSES, tile_batch=TILE_BATCH)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = [tiled_inference(served, val[i][0], TILE, TILE, CLASSES, tile_batch=TILE_BATCH)
                 for i in range(len(val))]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        sums_ok = True
        for i, prob in enumerate(probs):
            p = prob.cpu().numpy()
            sums_ok &= bool(np.isfinite(p).all()) and float(np.abs(p.sum(-1) - 1).max()) <= PROB_SUM_TOL
            mask = val[i][1]
            ok = mask != 255
            cm += np.bincount(mask[ok] * CLASSES + p.argmax(-1)[ok],
                              minlength=CLASSES * CLASSES).reshape(CLASSES, CLASSES)
        iou = np.diag(cm) / np.maximum(cm.sum(0) + cm.sum(1) - np.diag(cm), 1)
        print(f'workflow: {smi}: tiled_inference over the {len(val)} val scenes '
              f'({TILE}² tiles, tile_batch={TILE_BATCH}, bf16): {n_tiles / serve_s:.1f} tiles/s; '
              f'probabilities finite and summing to 1 within {PROB_SUM_TOL}: {sums_ok}; '
              f'mIoU {iou.mean():.4f} (random weights, {WORKFLOW_ITERS} steps)', flush=True)
        check(sums_ok, 'the served probabilities are not finite or do not sum to 1')
        del served, state, probs
        torch.cuda.empty_cache()

        # f: FarSeg-R50, torchvision weights, the stem and layer1 frozen
        from ever_tpu_torch.module.resnet import ResNet
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            r50 = {k: v.detach().clone() for k, v in ResNet('resnet50').state_dict().items()}
        r50 = {k: (v.abs() + 0.5 if k.endswith('running_var') else v + 0.01 * torch.randn_like(v))
               for k, v in r50.items()}
        r50.update({k[:-len('running_var')] + 'num_batches_tracked': torch.tensor(100)
                    for k in list(r50) if k.endswith('running_var')})
        r50['fc.weight'], r50['fc.bias'] = torch.randn(1000, 2048), torch.randn(1000)
        r50_pth = os.path.join(tmp, 'resnet50.pth')
        torch.save(r50, r50_pth)
        lf, rf = recorded_run(train_py, [
            '--config_path', os.path.join(proj, 'configs', 'farseg_r50_loveda.py'),
            '--model_dir', os.path.join(tmp, 'farseg'),
            'model.params.GLOBAL', repr(dict(weight=dict(path=r50_pth))),
            'model.params.encoder.maxpool_impl', 'pallas',
            'model.params.encoder.freeze_at', '2',
            'data.train.params.root', root, 'data.test.params.root', root,
            'data.train.params.total_batch_size', str(TRAIN_BATCH),
            'data.train.params.num_workers', str(WORKFLOW_WORKERS),
            'train.num_iters', str(FARSEG_ITERS), 'train.log_interval_step', '1',
            'train.save_ckpt_interval_epoch', '1000'])
        init = rf['init']
        loaded_ok = all(torch.equal(init[f'encoder.resnet.{k}'].cpu(), v) for k, v in r50.items()
                        if not (k.startswith('fc.') or k.endswith('num_batches_tracked')))
        frozen = ('encoder.resnet.conv1', 'encoder.resnet.bn1', 'encoder.resnet.layer1.')
        params = dict(lf.model.named_parameters())
        still = [k for k, p in params.items() if k.startswith(frozen)
                 and not torch.equal(p.detach(), init[k])]
        unmoved = [k for k, p in params.items() if not k.startswith(frozen)
                   and torch.equal(p.detach(), init[k])]
        f_losses = [d['total_loss'] for _, d, _, _ in rf['logged']]
        k8 = rf['launches'][2]
        print(f'workflow: FarSeg-R50 from disk, freeze_at 2: loss '
              f'{" ".join(f"{v:.5f}" for v in f_losses)}; max_pool_32_bwd {k8} (expected '
              f'{FARSEG_ITERS}); encoder tensors bit-equal to the file: {loaded_ok}; '
              f'{sum(k.startswith(frozen) for k in params)} frozen parameters, {len(still)} moved; '
              f'{len(unmoved)} of the other {sum(not k.startswith(frozen) for k in params)} '
              f'did not move', flush=True)
        check(len(f_losses) == FARSEG_ITERS and all(math.isfinite(v) for v in f_losses),
              'FarSeg: non-finite or missing losses')
        check(k8 == FARSEG_ITERS, f'FarSeg: {k8} K8 launches in {FARSEG_ITERS} steps')
        check(loaded_ok, 'FarSeg: the encoder was not loaded from the file')
        check(not still and not unmoved, f'FarSeg: frozen moved {still[:3]}, '
              f'trainable unmoved {unmoved[:3]}')
        del lf, params, init
        torch.cuda.empty_cache()

        # g: GeoTile patches of two PNG scenes and a .npy scene
        rng = np.random.default_rng(seed)
        np.save(os.path.join(tmp, 'scene.npy'),
                rng.integers(0, 256, (WORKFLOW_SCENE, WORKFLOW_SCENE, 3), dtype=np.uint8))
        np.save(os.path.join(tmp, 'scene_mask.npy'),
                rng.integers(0, CLASSES, (WORKFLOW_SCENE, WORKFLOW_SCENE), dtype=np.uint8))
        pairs = [(p, p.replace('images_png', 'masks_png')) for p, _, _ in written[:2]]
        pairs.append((os.path.join(tmp, 'scene.npy'), os.path.join(tmp, 'scene_mask.npy')))
        ds = GeoTileDataset(dict(scene_pairs=pairs, patch_size=TILE, stride=TILE,
                                 cache_scenes=len(pairs) * 2))
        idx = list(range(len(ds)))
        ds.read_batch(idx)                                            # decodes the scenes
        t0 = time.perf_counter()
        xb, yb = ds.read_batch(idx)
        batch_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        items = [ds[i] for i in idx]
        item_ms = (time.perf_counter() - t0) * 1e3
        equal = (np.array_equal(xb, np.stack([a for a, _ in items]))
                 and np.array_equal(yb, np.stack([b for _, b in items])))
        print(f'workflow: {smi}: GeoTileDataset over 2 PNG scenes and a .npy scene: '
              f'{len(ds)} patches of {TILE}²; read_batch {batch_ms:.2f} ms against '
              f'{item_ms:.2f} ms item by item; equal: {equal}', flush=True)
        check(equal and xb.shape == (len(ds), TILE, TILE, 3), 'read_batch differs from the '
              'per-item path')
    print(f'workflow: {smi}: phase wall time {time.perf_counter() - t_phase:.1f} s', flush=True)


# -- ddp: data parallel over processes ------------------------------------------------

# the ddp phase's LoveDA tree: 512² train scenes (the configs' crop; with
# random_crop off a sample is its whole scene, whatever the epoch) and
# 1024² val scenes, 2 Urban and 1 Rural (a 2/1 partition over 2 ranks)
DDP_LAYOUT = [('Train', 'Urban', 8, TILE), ('Train', 'Rural', 8, TILE),
              ('Val', 'Urban', 2, 2 * TILE), ('Val', 'Rural', 1, 2 * TILE)]
DDP_NCCL_ITERS = 4
# one batch a rank an epoch: with a checkpoint every epoch, the 2-rank run
# writes its state after each step (as the next epoch's batch is drawn)
DDP_FARSEG_BATCH, DDP_FARSEG_ITERS, DDP_RESUME_AT = 16, 4, 2
# FarSeg's steps are chaotic: a float32 rounding apart grows to 1e-3 in 3
# steps, so one process is held to each 2-rank step from the same state
# (steps 1-2; 1-4 cost two trainer runs more, about 15 s)
DDP_FORCED_STEPS = 2
DDP_DINO_BATCH, DDP_DINO_ITERS = 8, 2
DDP_TILED_STRIDE = 384          # 11 x 11 = 121 overlapping tiles of a 4096² scene
# limits stated before the first chip run (PERF.md): FarSeg in float32 with
# TF32 off, 2 ranks against one process, of each tensor's max |value| and
# relative for the losses; DinoSeg's losses in bf16, where cuBLAS tiles the
# products of a batch of 4 and of 8 differently, relative
DDP_FARSEG_TOL, DDP_DINO_LOSS_TOL = 1e-4, 1e-3
DDP_TILED_TOL = 1e-6            # absolute, when a tile's bits do not depend on its slot
DDP_WORKER_TIMEOUT = 600
# the parallel phases' ranks share the card and the host's cores with the
# serial phases from models on
PARALLEL_TIMEOUT = 900

def state_digest(state_dict) -> str:
    """sha256 of every tensor's name and bytes, in name order."""
    h = hashlib.sha256()
    for k in sorted(state_dict):
        h.update(k.encode())
        h.update(state_dict[k].detach().contiguous().reshape(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()


# recorder the ddp phase adds to the project's module/ (train.py registers
# the directory): every logged step, the process group, the kernel
# launches and a digest of the final model state, as JSON in the model dir
DDP_RECORDER = '''\
"""Record a train.py run for chip_smoke.py's ddp phase."""
import hashlib
import json
import os

import torch

import ever_tpu_torch as er
from ever_tpu_torch.ops import attention as A, pool as P
from ever_tpu_torch.trainer.trainer import Trainer

_run = Trainer.run


# STATE_DIGEST


def run(self, after_construct_launcher_callbacks=None):
    logged = []

    def wire(tl):
        train_log = tl.logger.train_log

        def log(step, num_iters, loss_dict, data_time, time_cost, lr):
            logged.append([step, dict(loss_dict), time_cost])
            return train_log(step, num_iters, loss_dict, data_time, time_cost, lr)

        tl.logger.train_log = log

    for fn in (A.fused_attention, A.fused_attention_bwd, P.max_pool_32_bwd):
        fn.launches = 0
    out = _run(self, [wire, *(after_construct_launcher_callbacks or [])])
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    init = torch.distributed.is_initialized()
    record = dict(trainer=type(self).__name__, world=er.dist.get_world_size(),
                  backend=torch.distributed.get_backend() if init else None,
                  logged=logged, step=out['launcher'].global_step,
                  launches=[A.fused_attention.launches, A.fused_attention_bwd.launches,
                            P.max_pool_32_bwd.launches],
                  digest=state_digest(out['launcher'].model.state_dict()))
    name = f'record-{er.dist.get_world_size()}-{er.dist.get_rank()}.json'
    with open(os.path.join(self.model_dir, name), 'w') as f:
        json.dump(record, f)
    return out


Trainer.run = run
'''.replace('# STATE_DIGEST', inspect.getsource(state_digest).strip())


def step_ms(logged: list) -> float:
    """Median wall ms of the logged steps after the first."""
    times = sorted(t for _, _, t in logged[1:])
    return times[len(times) // 2] * 1e3


def timed_ms(step_s: list) -> float:
    """Median ms of the timed train steps after the first."""
    times = sorted(step_s[1:])
    return times[len(times) // 2] * 1e3


def ddp_opts(spec: dict, model: str) -> list:
    """The command line's config overrides of a ddp run: the phase's LoveDA
    tree without random crops; FarSeg with K8, float32 compute and a
    global batch of 16, evaluated one val scene at a time."""
    opts = ['data.train.params.root', spec['root'], 'data.test.params.root', spec['root'],
            'data.train.params.random_crop', 'False', 'data.train.params.num_workers', '2',
            'train.log_interval_step', '1']
    if model == 'farseg':
        opts += ['model.params.encoder.maxpool_impl', 'pallas', 'model.params.dtype', 'float32',
                 'data.train.params.total_batch_size', str(DDP_FARSEG_BATCH),
                 'data.test.params.batch_size', '1']
    else:
        opts += ['data.train.params.total_batch_size', str(DDP_DINO_BATCH)]
    return opts


def ddp_run(spec: dict, model: str, trainer: str, model_dir: str, opts=(), train_dl=None,
            evaluate=None):
    """A config-driven run of the project's ``model`` config through
    ``get_trainer(trainer)`` on ``cuda:0``, optionally with an explicit
    train loader and an evaluation; returns the launcher and its record
    (logged steps, K1/K2/K8 launches, digest of the final model)."""
    from ever_tpu_torch.trainer import get_trainer

    logged, step_s = [], []

    def wire(tl):
        train_log, ensure = tl.logger.train_log, tl._ensure_train_step

        def log(step, num_iters, loss_dict, data_time, time_cost, lr):
            logged.append([step, dict(loss_dict), time_cost])
            return train_log(step, num_iters, loss_dict, data_time, time_cost, lr)

        def timed_steps(forward_times):
            # each train step's host time to its end on the card
            ensure(forward_times)
            step = tl._train_step

            def timed(state, batch):
                t0 = time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                return out

            tl._train_step = timed
            tl._ensure_train_step = ensure

        tl.logger.train_log, tl._ensure_train_step = log, timed_steps
        if evaluate is not None:
            tl.override_evaluate(evaluate)

    reset_counts()
    t = get_trainer(trainer, argv=['--config_path', spec[model], '--model_dir', model_dir,
                                   '--device', 'cuda:0', *ddp_opts(spec, model), *opts])()
    out = t.run([wire]) if train_dl is None else t.train_with_dataloader(train_dl, None, [wire])
    torch.cuda.synchronize()
    from ever_tpu_torch.ops import attention as A, pool as P
    launcher = out['launcher']
    return launcher, dict(logged=logged, step=launcher.global_step, step_s=step_s,
                          launches=[A.fused_attention.launches, A.fused_attention_bwd.launches,
                                    P.max_pool_32_bwd.launches],
                          digest=state_digest(launcher.model.state_dict()))


def ddp_dinoseg(seed: int):
    """The ddp phase's serving model: DinoSeg ViT-L/16 with seeded
    weights, bf16, in eval mode."""
    return build_dinoseg(torch.Generator(device='cuda').manual_seed(seed + 9)).eval()


def ddp_tiled(seed: int, mesh=None):
    """The serving model over the phase's 4096² scene at stride 384,
    split over ``mesh``; (model, scene, canvas, seconds, K1)."""
    from ever_tpu_torch import tiled_inference

    import numpy as np

    model = ddp_dinoseg(seed)
    scene = np.random.default_rng(seed + 9).standard_normal((SCENE, SCENE, 3), dtype=np.float32)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    canvas = tiled_inference(model, scene, TILE, DDP_TILED_STRIDE, CLASSES, tile_batch=TILE_BATCH,
                             mesh=mesh, device=next(model.parameters()).device)
    torch.cuda.synchronize()
    from ever_tpu_torch.ops import attention as A
    return model, scene, canvas, time.perf_counter() - t0, A.fused_attention.launches


def ddp_worker(job: str, rank: int, world: int, init: str, out: str) -> int:
    """One of the phase's gloo ranks, both on ``cuda:0``: ``job='main'``
    trains FarSeg-R50 4 steps (a checkpoint after each) and evaluates the val
    scenes distributed, trains DinoSeg ViT-L/16 2 steps, and serves the
    4096² scene over the mesh; ``job='resume'`` resumes the FarSeg run's
    step-2 checkpoint to 4; ``job='parallel'`` runs the gan, zero, layouts
    and spatial phases' workers in turn (``gan_worker``, ``zero_worker``,
    ``layouts_worker``, ``spatial_worker``: :func:`start_parallel`).  Writes
    ``{job}-rank{rank}.json`` and rank r's canvas; any failure raises and
    exits non-zero."""
    from ever_tpu_torch.core import dist
    from ever_tpu_torch.metric.evaluate_fn import distributed_evaluate_pixel_prediction_task
    from ever_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dist.init_dist_env(init, world, rank, backend='gloo')
    if job == 'parallel':
        result = dict(seconds={})
        for name, fn in (('gan', gan_worker), ('zero', zero_worker),
                         ('layouts', layouts_worker), ('spatial', spatial_worker)):
            t0 = time.perf_counter()
            result[name] = fn(rank, out)
            result['seconds'][name] = time.perf_counter() - t0
            gc.collect()                        # DDP wrappers hold cycles
            torch.cuda.empty_cache()
        with open(os.path.join(out, f'{job}-rank{rank}.json'), 'w') as f:
            json.dump(result, f)
        return 0
    with open(os.path.join(out, 'spec.json')) as f:
        spec = json.load(f)
    result = {}
    if job == 'main':
        t0 = time.perf_counter()
        launcher, rec = ddp_run(spec, 'farseg', 'th_ddp', spec['farseg_dir'], [
            'train.num_iters', str(DDP_FARSEG_ITERS), 'train.eval_after_train', 'True',
            'train.distributed_evaluate', 'True', 'train.save_ckpt_interval_epoch', '1'],
            evaluate=distributed_evaluate_pixel_prediction_task(CLASSES))
        rec['seconds'] = time.perf_counter() - t0
        rec['mesh'] = [launcher.mesh.size(), launcher.mesh.rank()]
        result['farseg'] = rec
        del launcher
        torch.cuda.empty_cache()
        launcher, result['dinoseg'] = ddp_run(spec, 'dinoseg', 'th_ddp', spec['dino_dir'], [
            'train.num_iters', str(DDP_DINO_ITERS), 'train.eval_after_train', 'False'])
        del launcher
        torch.cuda.empty_cache()
        _, _, canvas, secs, k1 = ddp_tiled(spec['seed'], mesh=make_mesh())
        torch.save(canvas.cpu(), os.path.join(out, f'tiled-rank{rank}.pt'))
        result['tiled'] = dict(seconds=secs, launches=k1)
    else:
        _, result['farseg'] = ddp_run(spec, 'farseg', 'th_ddp', spec['resume_dir'], [
            'train.num_iters', str(DDP_FARSEG_ITERS), 'train.eval_after_train', 'False',
            'train.save_ckpt_interval_epoch', '1000'])
    with open(os.path.join(out, f'{job}-rank{rank}.json'), 'w') as f:
        json.dump(result, f)
    return 0


def start_ddp_workers(job: str, out: str, timeout: float = DDP_WORKER_TIMEOUT) -> dict:
    """Start two gloo ranks of ``job`` (``chip_smoke.py --ddp-worker``)
    sharing the card; :func:`wait_ddp_workers` collects them, killing them
    ``timeout`` seconds after their start."""
    init = f'file://{out}/rendezvous-{job}'
    logs = [open(os.path.join(out, f'{job}-rank{r}.log'), 'w+') for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), '--ddp-worker', job,
                               str(r), '2', init, out], stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(2)]
    return dict(job=job, out=out, logs=logs, procs=procs, t0=time.perf_counter(),
                timeout=timeout)


def stop_ddp_workers(started: dict) -> None:
    """Kill the ranks of ``started`` that still run, and reap them."""
    for p in started['procs']:
        if p.poll() is None:
            p.kill()
        p.wait()


def wait_ddp_workers(started: dict) -> tuple:
    """Wait for the ranks of ``started``; when one fails the other is killed
    (it would wait in a collective) and the phase fails with both logs.
    Returns both ranks' results and the wall seconds since they started."""
    job, out, logs, procs, t0 = (started[k] for k in ('job', 'out', 'logs', 'procs', 't0'))
    try:
        deadline = time.monotonic() + started['timeout'] - (time.perf_counter() - t0)
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        stop_ddp_workers(started)
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f'--- {job} rank {r} (exit {procs[r].returncode}) ---\n{f.read()[-5000:]}')
        f.close()
    check(all(p.returncode == 0 for p in procs), 'a ddp rank failed:\n' + '\n'.join(text))
    results = []
    for r in range(2):
        with open(os.path.join(out, f'{job}-rank{r}.json')) as f:
            results.append(json.load(f))
    return results, time.perf_counter() - t0


def run_ddp_workers(job: str, out: str) -> tuple:
    """Two gloo ranks of ``job`` sharing the card, started and waited for:
    both ranks' results and the wall seconds."""
    return wait_ddp_workers(start_ddp_workers(job, out))


def run_train_pys(runs: list, cwd: str) -> list:
    """The project's train.py as each ``(cmd, model_dir, world)`` of
    ``runs`` (a plain process or torchrun), all at once, side by side on
    the card; fails with a run's output on its non-zero exit; returns each
    run's rank-0 record."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    logs = [open(f'{model_dir}.log', 'w+') for _, model_dir, _ in runs]
    procs = [subprocess.Popen(cmd, cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT)
             for (cmd, _, _), log in zip(runs, logs)]
    try:
        deadline = time.monotonic() + DDP_WORKER_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    records = []
    for (cmd, model_dir, world), p, log in zip(runs, procs, logs):
        log.seek(0)
        text = log.read()
        log.close()
        check(p.returncode == 0, f'{cmd[:6]} exited {p.returncode}:\n{text[-8000:]}')
        with open(os.path.join(model_dir, f'record-{world}-0.json')) as f:
            records.append(json.load(f))
    return records


def max_state_diff(got: dict, want: dict) -> float:
    """Largest max |got - want| / max(1, max |want|) over the floating
    tensors: relative for large tensors, absolute for small ones."""
    worst = 0.0
    for k, w in want.items():
        if w.is_floating_point():
            scale = max(float(w.abs().max()), 1.0)
            worst = max(worst, float((got[k].detach().float().cpu() - w.float().cpu())
                                     .abs().max()) / scale)
    return worst


def rel_losses(got: list, want: list) -> float:
    """Largest relative difference of the logged total losses."""
    check([s for s, _, _ in got] == [s for s, _, _ in want],
          f'logged steps {[s for s, _, _ in got]} and {[s for s, _, _ in want]}')
    return max(abs(g[1]['total_loss'] - w[1]['total_loss']) / abs(w[1]['total_loss'])
               for g, w in zip(got, want))


def ddp_bytes(model, world: int) -> dict:
    """Bytes one rank all-reduces a train step: the gradients (DDP's
    buckets), each BatchNorm's rows forward and sums backward, the loss's
    sums and the metrics."""
    from ever_tpu_torch.module.ops import BatchNorm2d

    grads = sum(p.numel() * p.element_size() for p in model.parameters() if p.requires_grad)
    bn = sum((world * (2 * m.weight.numel() + 1) + 2 * m.weight.numel()) * 4
             for m in model.modules() if isinstance(m, BatchNorm2d))
    return dict(gradients=grads, batchnorm=bn, loss_and_metrics=2 * 2 * 4 + 4 * 8)


def global_loader(spec: dict, model: str, steps: int, per_rank: int):
    """A one-process loader of the global batches 2 ranks of ``per_rank``
    draw in ``steps`` steps (``data.distributed.global_batches``), read
    from the same dataset config in sequence."""
    from ever_tpu_torch.core import registry
    from ever_tpu_torch.core.config import import_config
    from ever_tpu_torch.data.distributed import SubsetSampler, global_batches

    cfg = import_config(spec[model])
    cfg.update_from_list(ddp_opts(spec, model))
    ds = registry.DATASET[cfg.data.train.type](cfg.data.train.params)
    order = sum(global_batches(ds, 2, per_rank, steps), [])
    return torch.utils.data.DataLoader(ds, batch_size=2 * per_rank, sampler=SubsetSampler(order),
                                       collate_fn=ds.collate_fn, num_workers=2)


def resume_copy(src: str, dst: str, step: int) -> None:
    """A copy of model dir ``src`` whose last checkpoint is ``step``."""
    import shutil

    os.makedirs(dst)
    for name in ('config.pkl', f'checkpoint-{step}.ckpt'):
        shutil.copy(os.path.join(src, name), dst)
    with open(os.path.join(dst, 'checkpoint_info.json'), 'w') as f:
        json.dump({'last': dict(step=step, name=f'checkpoint-{step}.ckpt'),
                   str(step): f'checkpoint-{step}.ckpt'}, f)


def phase_ddp(seed: int, smi: str) -> None:
    """Data parallel over processes (gates in ``PERF.md`` and the module
    docstring): (a) the project's train.py under ``torchrun`` with one NCCL
    rank against the ``'base'`` trainer; (b) FarSeg-R50 over 2 gloo ranks
    on the one card against one process, and its resume in 2 processes and
    in 1; (c) DinoSeg ViT-L/16 over 2 gloo ranks; (d) the distributed
    evaluation; (e) ``tiled_inference(mesh=)``."""
    import tempfile

    import numpy as np
    from ever_tpu_torch import sliding_window
    from ever_tpu_torch.core.builder import make_model
    from ever_tpu_torch.core.checkpoint import CheckPoint
    from ever_tpu_torch.core.config import import_config
    from ever_tpu_torch.trainer import get_trainer

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True         # a resumed run's bits
    with tempfile.TemporaryDirectory(prefix='chip_smoke_ddp_') as tmp:
        proj = os.path.join(tmp, 'proj')
        r = subprocess.run([sys.executable, '-m', 'ever_tpu_torch', 'create', proj], cwd=repo,
                           env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
                           text=True, timeout=300)
        check(r.returncode == 0, f'create failed: {r.stderr[-2000:]}')
        with open(os.path.join(proj, 'module', 'chip_smoke_record.py'), 'w') as f:
            f.write(DDP_RECORDER)
        root = os.path.join(tmp, 'LoveDA')
        # no-data corners of 32², 128² and 224² in turn: the ranks' batches
        # hold different numbers of valid pixels
        write_loveda(root, seed, DDP_LAYOUT, nodata=lambda i: 32 + 96 * (i % 3))
        spec = dict(root=root, seed=seed,
                    farseg=os.path.join(proj, 'configs', 'farseg_r50_loveda.py'),
                    dinoseg=os.path.join(proj, 'configs', 'dinoseg_vitl_loveda.py'),
                    farseg_dir=os.path.join(tmp, 'farseg'), dino_dir=os.path.join(tmp, 'dino'),
                    resume_dir=os.path.join(tmp, 'farseg_resumed'))
        with open(os.path.join(tmp, 'spec.json'), 'w') as f:
            json.dump(spec, f)

        # a: torchrun, one NCCL rank, against the 'base' trainer
        train_py = os.path.join(proj, 'train.py')
        argv = ['--config_path', spec['dinoseg'], 'data.train.params.root', root,
                'data.test.params.root', root, 'data.train.params.random_crop', 'False',
                'train.num_iters', str(DDP_NCCL_ITERS), 'train.log_interval_step', '1']
        t0 = time.perf_counter()
        ra, rb = run_train_pys([
            ([sys.executable, '-m', 'torch.distributed.run', '--standalone', '--nproc_per_node',
              '1', train_py, '--model_dir', os.path.join(tmp, 'nccl'), *argv],
             os.path.join(tmp, 'nccl'), 1),
            ([sys.executable, train_py, '--trainer', 'base', '--model_dir',
              os.path.join(tmp, 'base'), *argv], os.path.join(tmp, 'base'), 1)], proj)
        a_secs = time.perf_counter() - t0
        evals = 1                              # the 3 val scenes in one batch of 8
        want = [24 * (DDP_NCCL_ITERS + evals), 24 * DDP_NCCL_ITERS, 0]
        same_losses = [d for _, d, _ in ra['logged']] == [d for _, d, _ in rb['logged']]
        same_state = ra['digest'] == rb['digest']
        print(f'ddp: a: {smi}: torchrun --nproc_per_node 1 train.py on dinoseg_vitl_loveda.py: '
              f'{ra["trainer"]}, backend {ra["backend"]}, world {ra["world"]}, steps '
              f'{[s for s, _, _ in ra["logged"]]}, loss '
              f'{" ".join(f"{d["total_loss"]:.5f}" for _, d, _ in ra["logged"])}; launches '
              f'{ra["launches"]} (expected {want}); {step_ms(ra["logged"]):.2f} ms/step (nccl, '
              f'one rank) against {step_ms(rb["logged"]):.2f} ms/step for the base trainer '
              f'({rb["trainer"]}, no process group; the two runs side by side on the card); '
              f'losses bit-equal {same_losses}, final state '
              f'bit-equal {same_state}', flush=True)
        check(ra['trainer'] == 'SPMDTrainer' and ra['backend'] == 'nccl' and ra['world'] == 1
              and rb['backend'] is None, f'a: {ra["trainer"]} {ra["backend"]} {rb["backend"]}')
        check(ra['launches'] == want and rb['launches'] == want,
              f'a: launches {ra["launches"]}, {rb["launches"]}')
        check(len(ra['logged']) == DDP_NCCL_ITERS and all(
            math.isfinite(d['total_loss']) for _, d, _ in ra['logged']), 'a: losses')
        if not (same_losses and same_state):
            got, ref = (CheckPoint.load(os.path.join(tmp, d, f'checkpoint-{DDP_NCCL_ITERS}.ckpt'),
                                        'cpu') for d in ('nccl', 'base'))
            print(f'ddp: a: one NCCL rank against base: largest loss difference '
                  f'{rel_losses(ra["logged"], rb["logged"]):.3e} relative, state '
                  f'{max_state_diff(got["model"], ref["model"]):.3e} of max |value|', flush=True)
        check(same_losses and same_state, 'a: the one-rank NCCL run differs from the base trainer')
        for d in ('nccl', 'base'):
            os.remove(os.path.join(tmp, d, f'checkpoint-{DDP_NCCL_ITERS}.ckpt'))

        # b-e: the two gloo ranks on the one card
        main, main_s = run_ddp_workers('main', tmp)
        f0, f1 = main[0]['farseg'], main[1]['farseg']
        check(f0['digest'] == f1['digest'], 'b: the two ranks\' FarSeg states differ')
        check(f0['mesh'] == [2, 0] and f1['mesh'] == [2, 1], f'b: mesh {f0["mesh"]}')
        check(f0['launches'][2] == DDP_FARSEG_ITERS and f1['launches'][2] == DDP_FARSEG_ITERS,
              f'b: K8 launches {f0["launches"]}, {f1["launches"]}')
        def two_ranks(step):
            """The 2-rank run's model state after ``step`` steps (rank 0's file)."""
            return CheckPoint.load(os.path.join(spec['farseg_dir'], f'checkpoint-{step}.ckpt'),
                                   'cpu')['model']

        one_keys = set(make_model(import_config(spec['farseg']).model, device='cpu').state_dict())
        keys_same = all(set(two_ranks(k)) == one_keys for k in range(1, DDP_FARSEG_ITERS + 1))
        check(keys_same, 'b: the checkpoint keys are not those of one process')
        resume_copy(spec['farseg_dir'], spec['resume_dir'], DDP_RESUME_AT)
        resumed, resume_s = run_ddp_workers('resume', tmp)

        # b: one process on the same global batches, each step from the
        # 2-rank run's state before it
        def one_process(name, start, steps):
            """The base trainer from the 2-rank run's checkpoint ``start`` (its
            initial weights for 0) to ``steps`` on the global batches."""
            d = os.path.join(tmp, name)
            if start:
                resume_copy(spec['farseg_dir'], d, start)
            return ddp_run(spec, 'farseg', 'base', d, [
                'train.num_iters', str(steps), 'train.eval_after_train', 'False'],
                train_dl=global_loader(spec, 'farseg', steps, DDP_FARSEG_BATCH // 2))

        forced = []
        for t in range(DDP_FORCED_STEPS):
            launcher, rec = one_process(f'farseg_from_{t}', t, t + 1)
            forced.append((rel_losses(f0['logged'][t:t + 1], rec['logged']),
                           max_state_diff(launcher.model.state_dict(), two_ranks(t + 1))))
            if t == 0:
                bytes_b = ddp_bytes(launcher.model, 2)
            del launcher
        resume2_equal = (resumed[0]['farseg']['digest'] == f0['digest']
                         and [s[:2] for s in resumed[0]['farseg']['logged']]
                         == [s[:2] for s in f0['logged'][DDP_RESUME_AT:]])
        worst = tuple(max(v) for v in zip(*forced))
        print(f'ddp: b: {smi}: FarSeg-R50 farseg_r50_loveda.py at a global batch of '
              f'{DDP_FARSEG_BATCH} (8 a rank), float32, TF32 off, deterministic cuDNN, K8: gloo, '
              f'two ranks sharing one card: {timed_ms(f0["step_s"]):.2f} ms/step (steps '
              f'2-{DDP_FARSEG_ITERS}, each to its end on the card); K8 launches a rank '
              f'{f0["launches"][2]} in {DDP_FARSEG_ITERS} steps; the ranks\' states bit-equal; '
              f'bytes all-reduced a rank a step {bytes_b}; one process stepping from the 2-rank '
              f'state before each of steps 1-{DDP_FORCED_STEPS}: losses '
              f'{" ".join(f"{a:.2e}" for a, _ in forced)} relative, the state after '
              f'{" ".join(f"{b:.2e}" for _, b in forced)} of max(1, |value|) (limit '
              f'{DDP_FARSEG_TOL}); checkpoint keys those of one process: {keys_same}; '
              f'step-{DDP_RESUME_AT} checkpoint resumed to {DDP_FARSEG_ITERS} in 2 processes '
              f'bit-equal to the unbroken run: {resume2_equal}', flush=True)
        check(all(math.isfinite(d['total_loss']) for _, d, _ in f0['logged']), 'b: losses')
        check(max(worst) <= DDP_FARSEG_TOL, 'b: a 2-rank step differs from one process\'s')
        check(resume2_equal, 'b: the 2-process resume differs from the unbroken run')
        torch.cuda.empty_cache()

        # d: the distributed evaluation against one process on the same checkpoint
        eval_dir = os.path.join(tmp, 'farseg_eval')
        resume_copy(spec['farseg_dir'], eval_dir, DDP_FARSEG_ITERS)
        get_trainer('base', argv=['--config_path', spec['farseg'], '--model_dir', eval_dir,
                                  '--device', 'cuda:0', *ddp_opts(spec, 'farseg')])().evaluate()
        cms = [np.load(os.path.join(d, 'cm', sorted(os.listdir(os.path.join(d, 'cm')))[-1]))
               for d in (spec['farseg_dir'], eval_dir)]
        print(f'ddp: d: distributed evaluation of 3 val scenes of {2 * TILE}² (2 on rank 0, 1 '
              f'on rank 1): confusion matrix equal to one process\'s: '
              f'{np.array_equal(*cms)}; {int(cms[0].sum())} pixels counted', flush=True)
        check(np.array_equal(*cms), 'd: the distributed confusion matrix differs')

        # c: DinoSeg over 2 ranks against one process's batch-8 steps
        d0, d1 = main[0]['dinoseg'], main[1]['dinoseg']
        one_launcher, dref = ddp_run(spec, 'dinoseg', 'base', os.path.join(tmp, 'dino_one'), [
            'train.num_iters', str(DDP_DINO_ITERS), 'train.eval_after_train', 'False'],
            train_dl=global_loader(spec, 'dinoseg', DDP_DINO_ITERS, DDP_DINO_BATCH // 2))
        bytes_c = ddp_bytes(one_launcher.model, 2)
        del one_launcher
        torch.cuda.empty_cache()
        dino_diff = rel_losses(d0['logged'], dref['logged'])
        want = [24 * DDP_DINO_ITERS, 24 * DDP_DINO_ITERS, 0]
        print(f'ddp: c: {smi}: DinoSeg ViT-L/16 dinoseg_vitl_loveda.py, 4 a rank, bf16: gloo, '
              f'two ranks sharing one card: {timed_ms(d0["step_s"]):.2f} '
              f'ms/step; launches a rank {d0["launches"]}, {d1["launches"]} (expected {want}); '
              f'the ranks\' states bit-equal {d0["digest"] == d1["digest"]}; bytes all-reduced '
              f'a rank a step {bytes_c}; losses against one process\'s batch-8 steps '
              f'{dino_diff:.3e} relative (limit {DDP_DINO_LOSS_TOL})', flush=True)
        check(d0['launches'] == want and d1['launches'] == want, 'c: launches')
        check(d0['digest'] == d1['digest'], 'c: the two ranks\' DinoSeg states differ')
        check(dino_diff <= DDP_DINO_LOSS_TOL, 'c: DinoSeg over 2 ranks differs from one process')

        # e: tiled_inference(mesh=) against one process
        model, scene, want_canvas, one_s, one_k1 = ddp_tiled(seed)
        boxes = sliding_window((SCENE, SCENE), TILE, DDP_TILED_STRIDE)
        slots = math.ceil(len(boxes) / (2 * TILE_BATCH)) * TILE_BATCH      # a rank's
        tiles = torch.stack([torch.from_numpy(scene[y:y + TILE, x:x + TILE]) for x, y in
                             boxes[::13][:TILE_BATCH, :2].tolist()]).to(
                                 next(model.parameters()).device)
        with torch.no_grad():
            a, b = model(tiles), model(tiles.roll(1, dims=0)).roll(-1, dims=0)
        slot_diff = float((a.float() - b.float()).abs().max())
        limit = max(DDP_TILED_TOL, slot_diff)
        del model, a, b
        canvases = [torch.load(os.path.join(tmp, f'tiled-rank{r}.pt')) for r in range(2)]
        ranks_equal = torch.equal(canvases[0], canvases[1])
        tiled_diff = float((canvases[0] - want_canvas.cpu()).abs().max())
        print(f'ddp: e: {smi}: tiled_inference(mesh=) of a {SCENE}² scene, {TILE}² tiles at '
              f'stride {DDP_TILED_STRIDE} ({len(boxes)} tiles, {slots} slots a rank), DinoSeg '
              f'bf16: a tile\'s '
              f'output in another slot of its batch differs by {slot_diff:.3e}; both ranks '
              f'return the same scene: {ranks_equal}; against one process {tiled_diff:.3e} '
              f'(limit {limit:.1e}); K1 launches a rank {main[0]["tiled"]["launches"]}, one '
              f'process {one_k1}; {main[0]["tiled"]["seconds"]:.2f} s over two ranks sharing '
              f'one card against {one_s:.2f} s in one process', flush=True)
        check(ranks_equal and tiled_diff <= limit, 'e: the tiled scene over 2 ranks differs')
        check(main[0]['tiled']['launches'] == 24 * slots // TILE_BATCH
              and one_k1 == 24 * math.ceil(len(boxes) / TILE_BATCH), 'e: K1 launches')
    torch.backends.cudnn.deterministic = deterministic
    print(f'ddp: {smi}: processes {main_s:.1f} s (b-e) and {resume_s:.1f} s (resume), a '
          f'{a_secs:.1f} s; phase wall time {time.perf_counter() - t_phase:.1f} s', flush=True)


# -- models: FarSeg++ on the folded stem, SE/GC ResNets, FPN and decoder variants,
# and DINOv3's multi-crop forward -------------------------------------------------

# 16 train scenes of 512² (a crop is the whole scene) and 2 val scenes of 1024²
MODELS_LAYOUT = [('Train', 'Urban', 8, TILE), ('Train', 'Rural', 8, TILE),
                 ('Val', 'Urban', 1, 2 * TILE), ('Val', 'Rural', 1, 2 * TILE)]
MODELS_ITERS, MODELS_RESUME_AT, MODELS_WORKERS = 6, 3, 4
MODELS_VARIANT_BATCH = 2
# the multi-crop forward: DINOv3's 2 global crops of 512² and 8 local ones of
# 112² (7² + 5 = 54 tokens: below FUSED_TOKEN_THRESHOLD, the plain path)
GLOBAL_CROPS, LOCAL_CROPS, LOCAL_SIZE = 2, 8, 112
DINO_HEAD = dict(out_dim=65536, hidden_dim=2048, bottleneck_dim=256)


def farseg_pp_config(proj: str, root: str) -> str:
    """The project's ``configs/farseg_r50_loveda.py`` made FarSeg++ on the
    folded stem: ``relation_type='v2'`` (channel dropout 0.1),
    ``stem='s2d_input'``, ``maxpool_impl='pallas'``, LoveDA read with
    ``layout='s2d'``, batch 8 of 512² crops, bf16, SGD momentum 0.9 + poly;
    written beside it, its path returned."""
    from ever_tpu_torch.core.config import import_config

    cfg = import_config(os.path.join(proj, 'configs', 'farseg_r50_loveda.py')).to_dict()
    params = cfg['model']['params']
    params['encoder'].update(stem='s2d_input', maxpool_impl='pallas')
    params['head'] = dict(relation_type='v2', fs_relation=dict(dropout_rate=0.1))
    cfg['data']['train']['params'].update(root=root, layout='s2d', total_batch_size=TRAIN_BATCH,
                                          num_workers=MODELS_WORKERS, crop_size=TILE)
    cfg['data']['test']['params'].update(root=root, layout='s2d', batch_size=2)
    cfg['train'].update(num_iters=MODELS_ITERS, log_interval_step=1,
                        save_ckpt_interval_epoch=1000, eval_after_train=True)
    path = os.path.join(proj, 'configs', 'farseg_pp_r50_s2d_loveda.py')
    with open(path, 'w') as f:
        f.write('# FarSeg++-R50 on the space-to-depth input stem, from farseg_r50_loveda.py\n'
                f'config = {cfg!r}\n')
    return path


def record_masks(masks: list):
    """Keep every dropout keep-mask drawn (``module.ops._keep_mask``), on the
    card; returns the undo."""
    from ever_tpu_torch.module import ops

    keep = ops._keep_mask

    def recorded(shape, rate, generator):
        mask = keep(shape, rate, generator)
        masks.append(mask.clone())
        return mask

    ops._keep_mask = recorded

    def undo():
        ops._keep_mask = keep
    return undo


def fwd_bwd(model, loss_fn, seed: int):
    """One forward and backward of ``loss_fn(model, generator)``: the loss,
    every parameter's gradient (None where it got none), and the K8
    launches."""
    from ever_tpu_torch.ops import pool as P

    model.zero_grad(set_to_none=True)
    before = P.max_pool_32_bwd.launches
    loss = loss_fn(model, torch.Generator(device='cuda').manual_seed(seed))
    loss.backward()
    grads = [None if p.grad is None else p.grad.detach().clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads, P.max_pool_32_bwd.launches - before


def repeat_step(name: str, model, loss_fn, smi: str, k8_each: int) -> float:
    """A train forward and backward, then three more from the same state
    and generator, each timed by CUDA events: finite, bit-equal to the
    first, ``k8_each`` K8 launches each.  Returns the median ms."""
    loss_a, grads_a, k8_a = fwd_bwd(model, loss_fn, seed=11)
    finite = bool(torch.isfinite(loss_a)) and all(
        g is None or bool(torch.isfinite(g).all()) for g in grads_a)
    missing = sum(g is None for g in grads_a)
    equal, k8s, times = True, [k8_a], []
    for _ in range(3):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss_b, grads_b, k8_b = fwd_bwd(model, loss_fn, seed=11)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        k8s.append(k8_b)
        equal &= torch.equal(loss_a, loss_b) and all(
            (a is None and b is None) or torch.equal(a, b) for a, b in zip(grads_a, grads_b))
    ms = sorted(times)[1]
    print(f'models: e: {smi}: {name}: loss {loss_a.item():.5f}, loss and gradients finite '
          f'{finite} ({missing} parameters without a gradient), 3 repeats bit-equal to the '
          f'first {equal}, K8 launches {k8s} (expected {k8_each} each); forward and backward '
          f'at B={MODELS_VARIANT_BATCH}, {TILE}², bf16: median {ms:.2f} ms of '
          f'{" ".join(f"{t:.2f}" for t in times)}', flush=True)
    check(finite and missing == 0, f'e: {name}: non-finite or missing gradients')
    check(equal, f'e: {name}: two runs from the same state differ')
    check(all(k == k8_each for k in k8s), f'e: {name}: K8 launches {k8s}')
    return ms


def phase_models(gen, seed: int, smi: str):
    """The rest of the ported models on the card (module docstring, phase
    12): (a) the s2d readers, (b) FarSeg++-R50 from a config through the
    project's train.py with a resume, (c) the stem fold, (d) serving, (e)
    the SE, GC, decoder and FPN variants at full width, (f) DINOv3's
    multi-crop forward with DINOHead.  Returns this phase's (K1, K2, K8)
    launches."""
    import tempfile

    import numpy as np

    from ever_tpu_torch import tiled_inference
    from ever_tpu_torch.core.builder import make_model
    from ever_tpu_torch.core.config import import_config
    from ever_tpu_torch.data import SpaceToDepth
    from ever_tpu_torch.data.geotile import GeoTileDataset
    from ever_tpu_torch.data.loveda import LoveDA
    from ever_tpu_torch.module.fpn import FPN
    from ever_tpu_torch.module.resnet import ResNetEncoder
    from ever_tpu_torch.module.vit import SAT_CONFIGS, DINOHead, DinoVisionTransformer
    from ever_tpu_torch.ops import attention as A, pool as P

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True          # a resumed run's and a repeat's bits
    with tempfile.TemporaryDirectory(prefix='chip_smoke_models_') as tmp:
        # a: create, the LoveDA tree, the s2d readers
        proj = os.path.join(tmp, 'proj')
        r = subprocess.run([sys.executable, '-m', 'ever_tpu_torch', 'create', proj], cwd=repo,
                           env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
                           text=True, timeout=300)
        check(r.returncode == 0, f'create failed: {r.stderr[-2000:]}')
        root = os.path.join(tmp, 'LoveDA')
        written = write_loveda(root, seed, MODELS_LAYOUT)
        fold = SpaceToDepth()
        n_items, same = 0, True
        for split in ('train', 'val'):
            hwc = LoveDA(dict(root=root, split=split, crop_size=TILE))
            s2d = LoveDA(dict(root=root, split=split, crop_size=TILE, layout='s2d'))
            for i in range(len(hwc)):
                (x, y), (xs, ys) = hwc[i], s2d[i]
                same &= (xs.shape == (x.shape[0] // 2, x.shape[1] // 2, 12)
                         and np.array_equal(xs, fold(x)[0]) and np.array_equal(ys, y))
                n_items += 1
        val_pairs = [(p, p.replace('images_png', 'masks_png'))
                     for p, _, _ in written if f'{os.sep}Val{os.sep}' in p]
        geo = GeoTileDataset(dict(scene_pairs=val_pairs, patch_size=TILE, stride=TILE,
                                  layout='s2d'))
        idx = list(range(len(geo)))
        xb, yb = geo.read_batch(idx)
        items = [geo[i] for i in idx]
        geo_equal = (np.array_equal(xb, np.stack([a for a, _ in items]))
                     and np.array_equal(yb, np.stack([b for _, b in items])))
        print(f'models: a: LoveDA(layout=\'s2d\'): {n_items} items (train crops of {TILE}², '
              f'val scenes of {2 * TILE}²) equal to SpaceToDepth of the \'hwc\' items bit for '
              f'bit, masks at full resolution: {same}; GeoTileDataset(layout=\'s2d\') '
              f'read_batch of {len(geo)} patches {tuple(xb.shape)} through the host library '
              f'equal to the per-item path: {geo_equal}', flush=True)
        check(same and n_items == sum(n for _, _, n, _ in MODELS_LAYOUT),
              'a: the s2d LoveDA items are not the folded hwc items')
        check(geo_equal and xb.shape == (len(geo), TILE // 2, TILE // 2, 12),
              'a: the s2d read_batch differs from the per-item path')

        # b: FarSeg++-R50 from the config through the project's train.py
        cfg_path = farseg_pp_config(proj, root)
        train_py = os.path.join(proj, 'train.py')

        def argv(model_dir, iters, evaluate=True):
            return ['--config_path', cfg_path, '--model_dir', model_dir,
                    'train.num_iters', str(iters), 'train.eval_after_train', str(evaluate)]

        masks_a, masks_b = [], []
        undo = record_masks(masks_a)
        try:
            _, ra = recorded_run(train_py, argv(os.path.join(tmp, 'a'), MODELS_RESUME_AT, False))
            la, ra2 = recorded_run(train_py, argv(os.path.join(tmp, 'a'), MODELS_ITERS, False))
        finally:
            undo()
        resumed = {k: v.detach().clone() for k, v in la.model.state_dict().items()}
        del la
        seen = []
        undo_cm, undo = record_confusion(seen), record_masks(masks_b)
        try:
            lb, rb = recorded_run(train_py, argv(os.path.join(tmp, 'b'), MODELS_ITERS))
        finally:
            undo()
            undo_cm()
        model = lb.model
        trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
        resume_equal = all(torch.equal(resumed[k], v) for k, v in trained.items())
        losses = [d['total_loss'] for _, d, _, _ in rb['logged']]
        k8_b = rb['launches'][2]
        per_step = len(masks_b) // MODELS_ITERS
        step_masks = [masks_b[i * per_step:(i + 1) * per_step] for i in range(MODELS_ITERS)]
        masks_differ = all(not all(torch.equal(a, b) for a, b in zip(s, t))
                           for s, t in zip(step_masks, step_masks[1:]))
        masks_repeat = (len(masks_a) == len(masks_b) and
                        all(torch.equal(a, b) for a, b in zip(masks_a, masks_b)))
        dumps = sorted(os.listdir(os.path.join(lb.model_dir, 'cm')))
        card_cm = np.load(os.path.join(lb.model_dir, 'cm', dumps[-1]))
        truth = np.concatenate([y.reshape(-1) for _, _, y, _ in seen])
        pred = np.concatenate([p.reshape(-1) for _, _, _, p in seen])
        valid = truth != 255
        host_cm = np.bincount(truth[valid].astype(np.int64) * CLASSES + pred[valid],
                              minlength=CLASSES * CLASSES).reshape(CLASSES, CLASSES)
        # 2-step epochs: the loader's workers start anew at each, so the
        # steps alternate between a wait and none; the mean says what a run takes
        logged = rb['logged'][1:]
        launcher_ms = sum(t for _, _, _, t in logged) / len(logged) * 1e3
        data_ms = sum(d for _, _, d, _ in logged) / len(logged) * 1e3
        print(f'models: b: {smi}: FarSeg++-R50 ({os.path.basename(cfg_path)}: relation v2, '
              f'channel dropout 0.1, stem s2d_input, K8, LoveDA layout s2d, batch '
              f'{TRAIN_BATCH} of {TILE}², bf16, SGD momentum 0.9 + poly) through train.py: '
              f'steps {[s for s, _, _, _ in rb["logged"]]}, loss '
              f'{" ".join(f"{v:.5f}" for v in losses)}; K8 launches {k8_b} (expected '
              f'{MODELS_ITERS}), K1/K2 {rb["launches"][:2]}; {per_step} dropout masks a step, '
              f'differing between steps {masks_differ}, bit-equal in the {MODELS_RESUME_AT} + '
              f'resumed {MODELS_ITERS - MODELS_RESUME_AT} steps {masks_repeat}; resumed from '
              f'step {MODELS_RESUME_AT} to {MODELS_ITERS} bit-equal to the unbroken run: '
              f'{resume_equal}; the evaluation of {len(seen)} batch(es) of the 2 val scenes: '
              f'confusion matrix ({int(card_cm.sum())} pixels) equal to np.bincount on the '
              f'host {bool(np.array_equal(card_cm, host_cm))}; through the Launcher '
              f'{launcher_ms:.2f} ms/step ({data_ms:.2f} of it loading), the means of steps '
              f'2-{MODELS_ITERS} (per step: '
              f'{" ".join(f"{t * 1e3:.1f}/{d * 1e3:.1f}" for _, _, d, t in logged)} ms '
              f'step/loading), deterministic cuDNN', flush=True)
        check(len(losses) == MODELS_ITERS and all(math.isfinite(v) for v in losses),
              'b: non-finite or missing losses')
        check(k8_b == MODELS_ITERS and ra['launches'][2] + ra2['launches'][2] == MODELS_ITERS,
              f'b: K8 launches {k8_b}, {ra["launches"][2]} + {ra2["launches"][2]}')
        check(per_step == 4 and masks_differ, 'b: the dropout masks repeat between steps')
        check(masks_repeat, 'b: the dropout masks differ across a repeat')
        check(resume_equal, 'b: the resumed run differs from the unbroken run')
        check(all(d == 'cuda' for d, _, _, _ in seen) and np.array_equal(card_cm, host_cm)
              and int(host_cm.sum()) == int(valid.sum()),
              "b: the card's confusion matrix differs from the host's")
        del lb, resumed
        torch.cuda.empty_cache()

        # b: the bare step on the trained model, and its FLOPs
        torch.backends.cudnn.deterministic = deterministic
        x = torch.randn(TRAIN_BATCH, TILE // 2, TILE // 2, 12, generator=gen, device='cuda')
        y = torch.randint(0, CLASSES, (TRAIN_BATCH, TILE, TILE), generator=gen, device='cuda')
        bare = bare_steps(model, cfg_path, (x, y))
        m = bare['metrics']
        print(f'models: b: {smi}: the bare FarSeg++ step (build_train_step, the config\'s SGD + '
              f'poly, folded batch of {TRAIN_BATCH}): {bare_text(bare)}; loss '
              f'{m["cls_loss"].item():.5f}', flush=True)
        check(bare['k8'] == bare['steps'] and math.isfinite(m['cls_loss'].item()),
              f'b: the bare step launched K8 {bare["k8"]} times in {bare["steps"]}')
        del m, bare
        model.load_state_dict(trained, strict=True)       # the weights train.py left
        torch.backends.cudnn.deterministic = True

        # c: the trained weights in a stem='s2d' model on the unfolded batch
        cfg = import_config(cfg_path).model
        cfg.params.encoder.stem = 's2d'
        plain = make_model(cfg)
        plain.load_state_dict(trained, strict=True)
        model.eval()
        plain.eval()
        hwc = LoveDA(dict(root=root, split='val'))
        s2d = LoveDA(dict(root=root, split='val', layout='s2d'))
        xh = torch.from_numpy(np.stack([hwc[i][0] for i in range(2)])).cuda()
        xs = torch.from_numpy(np.stack([s2d[i][0] for i in range(2)])).cuda()
        with torch.no_grad():
            folded, unfolded = model(xs), plain(xh)
        fold_equal = torch.equal(folded, unfolded)
        print(f'models: c: the trained state_dict in a stem=\'s2d\' model on the 2 unfolded '
              f'val scenes {tuple(xh.shape)} against the s2d_input model on the folded '
              f'{tuple(xs.shape)}, eval mode, bf16: bit-equal {fold_equal} (max |dp| '
              f'{float((folded - unfolded).abs().max()):.3e})', flush=True)
        check(fold_equal, 'c: the folded stem differs from the conv stem on the unfolded batch')
        del model, folded, unfolded, trained

        # d: serving a 4096² scene with the stem='s2d' model
        scene = torch.randn(SCENE, SCENE, 3, generator=gen, device='cuda')

        def serve():
            out = tiled_inference(plain, scene, TILE, STRIDE, CLASSES, tile_batch=TILE_BATCH)
            torch.cuda.synchronize()
            return out

        serve()
        before = P.max_pool_32_bwd.launches
        t0 = time.perf_counter()
        out = serve()
        serve_s = time.perf_counter() - t0
        serve_k8 = P.max_pool_32_bwd.launches - before
        n_tiles = (SCENE // STRIDE) ** 2
        sums = float((out.sum(-1) - 1).abs().max())
        finite = bool(torch.isfinite(out).all())
        print(f'models: d: {smi}: FarSeg++ (stem s2d) tiled_inference of a {SCENE}² scene, '
              f'{TILE}² tiles, stride {STRIDE}, tile_batch {TILE_BATCH}, bf16: '
              f'{serve_s * 1e3:.1f} ms/scene = {n_tiles / serve_s:.1f} tiles/s; probabilities '
              f'finite {finite}, sums within {sums:.2e} of 1; K8 launches {serve_k8}', flush=True)
        check(finite and sums <= PROB_SUM_TOL and tuple(out.shape) == (SCENE, SCENE, CLASSES),
              'd: the served probabilities are not finite or do not sum to 1')
        check(serve_k8 == 0, f'd: serving launched K8 {serve_k8} times')
        del plain, out, scene
        torch.cuda.empty_cache()

    # e: the variants at full width, one 512² step each at B=2, bf16
    x = torch.randn(MODELS_VARIANT_BATCH, TILE, TILE, 3, generator=gen, device='cuda')
    y = torch.randint(0, CLASSES, (MODELS_VARIANT_BATCH, TILE, TILE), generator=gen,
                      device='cuda')

    def seg_loss(model, generator):
        return model(x, y, train=True, generator=generator)['cls_loss']

    variants = [
        ('FarSeg-R50 se_ratio=16', dict(encoder=dict(se_ratio=16))),
        ('FarSeg-R50 gc_ratio=1/16', dict(encoder=dict(gc_ratio=1 / 16))),
        ('FarSeg++ decoder norm=gn, align_corners, classifier dropout 0.1', dict(head=dict(
            relation_type='v2', fpn_decoder=dict(norm='gn', align_corners=True,
                                                 classifier_config=dict(dropout_rate=0.1))))),
    ]
    variant_ms = {}
    for name, extra in variants:
        cfg = dict(FARSEG, encoder=dict(FARSEG['encoder'], **extra.get('encoder', {})),
                   **({'head': extra['head']} if 'head' in extra else {}))
        model = make_model({'type': 'FarSeg', 'params': cfg})
        seeded_conv_init_(model, gen)
        variant_ms[name] = repeat_step(name, model, seg_loss, smi, k8_each=1)
        del model
    for top in ('p6p7', 'maxpool'):
        net = torch.nn.ModuleDict(dict(
            encoder=ResNetEncoder(dict(resnet_type='resnet50', maxpool_impl='pallas',
                                       dtype='bfloat16')),
            fpn=FPN((256, 512, 1024, 2048), 256, top_blocks=top))).cuda()
        seeded_conv_init_(net, gen)
        levels = []

        def fpn_loss(net, generator):
            out = net['fpn'](net['encoder'](x, train=True), train=True)
            levels.append(len(out))
            return sum(level.float().square().mean() for level in out)

        name = f'FPN top_blocks={top!r} over ResNet-50 features'
        variant_ms[name] = repeat_step(name, net, fpn_loss, smi, k8_each=1)
        check(levels[-1] == (6 if top == 'p6p7' else 5), f'e: FPN {top} gave {levels[-1]} levels')
        del net
    torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()

    # f: DINOv3's multi-crop forward with DINOHead, K1/K2 and attn_impl='xla' in bf16
    # against 'xla' in float32
    with torch.device('cuda'):
        vit = DinoVisionTransformer(**{**SAT_CONFIGS['vitl16_sat493m'],
                                       'untie_global_and_local_cls_norm': True})
        head = DINOHead(vit.embed_dim, **DINO_HEAD)
    seeded_init_(vit, gen)
    seeded_init_(head, gen)
    net = torch.nn.ModuleDict(dict(vit=vit, head=head))
    crops = [torch.randn(GLOBAL_CROPS, TILE, TILE, 3, generator=gen, device='cuda').bfloat16(),
             torch.randn(LOCAL_CROPS, LOCAL_SIZE, LOCAL_SIZE, 3, generator=gen,
                         device='cuda').bfloat16()]

    def dino_loss(net, generator, which=(0, 1), dtype=torch.bfloat16):
        outs = net['vit']([c.to(dtype) for c in crops], train=True, generator=generator)
        return sum(net['head'](outs[i]['x_norm_clstoken']).float().sum() for i in which)

    def run(seed=3, which=(0, 1), dtype=torch.bfloat16):
        net.zero_grad(set_to_none=True)
        dino_loss(net, torch.Generator(device='cuda').manual_seed(seed), which, dtype).backward()
        grads = {n: None if p.grad is None else p.grad.detach().float().clone()
                 for n, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        return grads

    run()                                                        # warm-up
    torch.cuda.synchronize()
    k1_0, k2_0 = A.fused_attention.launches, A.fused_attention_bwd.launches
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g_kernel = run()
    end.record()
    torch.cuda.synchronize()
    dino_ms = start.elapsed_time(end)
    k1 = A.fused_attention.launches - k1_0
    k2 = A.fused_attention_bwd.launches - k2_0
    only_global = run(which=(0,))['vit.local_cls_norm.weight']
    for blk in vit.blocks:
        blk.attn.attn_impl = 'xla'
    g_plain = run()
    g_f32 = run(dtype=torch.float32)                             # the reference (TF32 off)
    for blk in vit.blocks:
        blk.attn.attn_impl = None
    names = [n for n, g in g_plain.items() if g is not None]

    def distance(got, want):
        return compare_grads([got[n] for n in names], [want[n] for n in names])

    rel, worst, cos = distance(g_kernel, g_f32)
    plain_rel, plain_worst, _ = distance(g_plain, g_f32)
    cos_ratio = (1 - worst) / max(1 - plain_worst, 1e-12)
    pair_rel, pair_worst, _ = distance(g_kernel, g_plain)
    local = g_kernel['vit.local_cls_norm.weight']
    local_ok = (local is not None and float(local.abs().sum()) > 0 and only_global is None)
    print(f'models: f: {smi}: vitl16_sat493m untie_global_and_local_cls_norm, bf16, train, '
          f'RoPE rescale, list of {GLOBAL_CROPS} x {TILE}² and {LOCAL_CROPS} x '
          f'{LOCAL_SIZE}², DINOHead {DINO_HEAD} on each crop\'s cls token, sum loss: '
          f'{dino_ms:.2f} ms forward and backward; attention_fwd {k1}, attention_bwd {k2} '
          f'(expected 24 and 24: the local crops\' 54 tokens take the plain path); gradients '
          f'against plain attention in float32: K1/K2 ||dg||/||g|| {rel:.3e}, worst cosine '
          f'{worst:.7f} ({names[cos.index(worst)]}); plain bf16 {plain_rel:.3e} (worst cosine '
          f'{plain_worst:.7f}); K1/K2 {rel / plain_rel:.3f} x the plain bf16 path\'s distance '
          f'and {cos_ratio:.3f} x its worst 1 - cosine (limits {MULTICROP_REL_RATIO} x, worst '
          f'cosine at least {MULTICROP_COS_FLOOR}); K1/K2 against plain bf16 '
          f'{pair_rel:.3e} (worst cosine {pair_worst:.7f}; printed only); local_cls_norm '
          f'gradient |sum| {0.0 if local is None else float(local.abs().sum()):.4e}, from the '
          f'global crop alone {only_global}', flush=True)
    check((k1, k2) == (24, 24), f'f: K1/K2 launches {(k1, k2)}')
    check(rel <= MULTICROP_REL_RATIO * plain_rel and cos_ratio <= MULTICROP_REL_RATIO
          and worst >= MULTICROP_COS_FLOOR,
          'f: the multi-crop gradients of K1/K2 stand further from float32 than plain bf16')
    check(local_ok, 'f: local_cls_norm gets its gradient from another crop than index 1')
    del vit, head, net, g_kernel, g_plain, g_f32
    torch.cuda.empty_cache()
    # the counts run on from the last train.py run's reset; the two before it
    launches = tuple(c + a + b for c, a, b in zip(
        (A.fused_attention.launches, A.fused_attention_bwd.launches, P.max_pool_32_bwd.launches),
        ra['launches'], ra2['launches']))
    print(f'models: {smi}: launches in the phase (K1, K2, K8) {launches}; phase wall time '
          f'{time.perf_counter() - t_phase:.1f} s', flush=True)
    return launches


# FactSeg and the change detectors from the project template's configs (phase 13)
CHANGE_SCENE, CHANGE_TRAIN, CHANGE_VAL = 1024, 8, 2
CHANGE_ITERS, CHANGE_RESUME_AT, DETECTOR_ITERS = 4, 2, 3
ISAID_CLASSES, DAMAGE_CLASSES = 16, 5
# off-palette colours painted into the iSAID masks: each must decode to 255
OFF_PALETTE = ((255, 0, 0), (1, 2, 3), (0, 63, 64))


def blocky_labels(rng, n_classes: int, size: int, block: int = 64):
    """A ``[size, size]`` label map of ``block``² regions of random classes."""
    import numpy as np

    blocks = size // block
    return np.kron(rng.integers(0, n_classes, (blocks, blocks)),
                   np.ones((block, block), np.int64))


def blocky_image(rng, label, palette):
    """Each class its own colour plus noise, as uint8 RGB."""
    import numpy as np

    noise = rng.integers(-20, 21, label.shape + (3,))
    return np.clip(palette[label] + noise, 0, 255).astype(np.uint8)


def write_change_trees(root: str, seed: int) -> dict:
    """Seeded iSAID, LEVIR-CD and xView2 trees of 1024² scenes written by
    the port's PNG codec: ``CHANGE_TRAIN`` train and ``CHANGE_VAL``
    val/test/hold scenes each.  iSAID masks are devkit-palette RGB with a
    32² square of an off-palette colour in every scene; LEVIR-CD labels
    are grey 0/255; xView2 targets are 0..5, 5 in a block of each post
    target.  Returns the written labels by (dataset, split): class ids with
    255 where the readers must ignore."""
    import numpy as np
    from ever_tpu_torch.data._png import write_png
    from ever_tpu_torch.data.benchmarks import ISAID_PALETTE

    rng = np.random.default_rng(seed + 11)
    colours = np.zeros((ISAID_CLASSES, 3), np.uint8)
    for rgb, c in ISAID_PALETTE.items():
        colours[c] = rgb
    palette = rng.integers(30, 220, (ISAID_CLASSES, 3))
    truth = {}
    n = 0
    for split, count in (('train', CHANGE_TRAIN), ('val', CHANGE_VAL)):
        d = os.path.join(root, 'iSAID', split, 'images')
        os.makedirs(d)
        for i in range(count):
            label = blocky_labels(rng, ISAID_CLASSES, CHANGE_SCENE)
            mask = colours[label]
            y0, x0 = rng.integers(0, CHANGE_SCENE - 32, 2)
            mask[y0:y0 + 32, x0:x0 + 32] = OFF_PALETTE[i % len(OFF_PALETTE)]
            want = label.astype(np.int32)
            want[y0:y0 + 32, x0:x0 + 32] = 255
            write_png(os.path.join(d, f'P{i:04d}.png'), blocky_image(rng, label, palette),
                      filter_type=n % 5)
            write_png(os.path.join(d, f'P{i:04d}_instance_color_RGB.png'), mask)
            truth.setdefault(('isaid', split), []).append(want)
            n += 1
    for split, count in (('train', CHANGE_TRAIN), ('test', CHANGE_VAL)):
        for sub in ('A', 'B', 'label'):
            os.makedirs(os.path.join(root, 'LEVIR-CD', split, sub))
        for i in range(count):
            before = blocky_labels(rng, 4, CHANGE_SCENE)
            change = blocky_labels(rng, 2, CHANGE_SCENE, 32)
            after = np.where(change == 1, (before + 1) % 4, before)
            for sub, lab in (('A', before), ('B', after)):
                write_png(os.path.join(root, 'LEVIR-CD', split, sub, f'{i}.png'),
                          blocky_image(rng, lab, palette), filter_type=n % 5)
                n += 1
            write_png(os.path.join(root, 'LEVIR-CD', split, 'label', f'{i}.png'),
                      (change * 255).astype(np.uint8))
            truth.setdefault(('levircd', split), []).append(change.astype(np.int32))
    for split, count in (('train', CHANGE_TRAIN), ('hold', CHANGE_VAL)):
        for sub in ('images', 'targets'):
            os.makedirs(os.path.join(root, 'xView2', split, sub))
        for i in range(count):
            building = blocky_labels(rng, 2, CHANGE_SCENE)
            damage = np.where(building == 1, blocky_labels(rng, 4, CHANGE_SCENE, 32) + 1, 0)
            damage[:64, :64] = np.where(building[:64, :64] == 1, 5, 0)
            pre = blocky_image(rng, building, palette)
            post = blocky_image(rng, damage, palette)
            stem = os.path.join(root, 'xView2', split, '{}', f'scene{i}_{{}}_disaster{{}}.png')
            write_png(stem.format('images', 'pre', ''), pre, filter_type=n % 5)
            write_png(stem.format('images', 'post', ''), post, filter_type=(n + 1) % 5)
            n += 2
            write_png(stem.format('targets', 'pre', '_target'), building.astype(np.uint8))
            write_png(stem.format('targets', 'post', '_target'), damage.astype(np.uint8))
            truth.setdefault(('xview2', split), []).append(
                (building.astype(np.int32), np.where(damage == 5, 255, damage).astype(np.int32)))
    return truth


def template_config(proj: str, template: str, name: str, root: str, **params) -> str:
    """The project's ``configs/{template}.py`` with its data under ``root``,
    batch ``TRAIN_BATCH`` of ``TILE``² crops with 4 loader workers,
    ``maxpool_impl='pallas'``, the model's ``params`` merged in, and its run
    cut to ``CHANGE_ITERS`` steps with one evaluation after training;
    written beside it as ``{name}.py``, its path returned."""
    from ever_tpu_torch.core.config import import_config

    cfg = import_config(os.path.join(proj, 'configs', f'{template}.py')).to_dict()
    cfg['model']['params']['encoder']['maxpool_impl'] = 'pallas'
    cfg['model']['params'].update(params)
    cfg['data']['train']['params'].update(root=root, total_batch_size=TRAIN_BATCH,
                                          num_workers=MODELS_WORKERS, crop_size=TILE)
    cfg['data']['test']['params'].update(root=root)
    cfg['train'].update(num_iters=CHANGE_ITERS, log_interval_step=1,
                        save_ckpt_interval_epoch=1000, eval_after_train=True)
    path = os.path.join(proj, 'configs', f'{name}.py')
    with open(path, 'w') as f:
        f.write(f'# {name}, from {template}.py with its run cut to size\n'
                f'config = {cfg!r}\n')
    return path


def host_confusion(seen: list, n_classes: int):
    """``np.bincount`` of the recorded evaluation's valid labels and
    predictions, on the host."""
    import numpy as np

    truth = np.concatenate([y.reshape(-1) for _, _, y, _ in seen])
    pred = np.concatenate([p.reshape(-1) for _, _, _, p in seen])
    valid = truth != 255
    return np.bincount(truth[valid].astype(np.int64) * n_classes + pred[valid],
                       minlength=n_classes * n_classes).reshape(n_classes, n_classes)


def card_confusion(model_dir: str):
    """The last confusion matrix the evaluation dumped under the model dir."""
    import numpy as np

    dumps = sorted(os.listdir(os.path.join(model_dir, 'cm')))
    return np.load(os.path.join(model_dir, 'cm', dumps[-1]))


def bare_steps(model, cfg_path: str, batch) -> dict:
    """The config's optimizer and schedule through ``build_train_step`` on
    ``batch`` (on the card): one step under ``FlopCounterMode``,
    ``WARMUP_STEPS`` more, then ``TIMED_STEPS`` timed by CUDA events.
    Returns the median, least and most ms of a timed step, the FLOPs of a
    step, the K8 launches of all ``steps`` steps and the last metrics."""
    from torch.utils.flop_counter import FlopCounterMode
    from ever_tpu_torch.core.builder import make_learningrate, make_optimizer
    from ever_tpu_torch.core.config import import_config
    from ever_tpu_torch.ops import pool as P
    from ever_tpu_torch.parallel.spmd import build_train_step, create_train_state

    cfg = import_config(cfg_path)
    schedule = make_learningrate(cfg.learning_rate)
    factory, _ = make_optimizer(cfg.optimizer)
    tx = factory.build(schedule)
    state = create_train_state(model, tx)
    step = build_train_step(model, tx, schedule)
    before = P.max_pool_32_bwd.launches
    with FlopCounterMode(display=False) as counter:
        state, _ = step(state, batch)
    for _ in range(WARMUP_STEPS):
        state, _ = step(state, batch)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    torch.cuda.synchronize()
    events[0].record()
    for i in range(TIMED_STEPS):
        state, metrics = step(state, batch)
        events[i + 1].record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return dict(ms=times[len(times) // 2], min_ms=times[0], max_ms=times[-1],
                flops=counter.get_total_flops(), k8=P.max_pool_32_bwd.launches - before,
                steps=1 + WARMUP_STEPS + TIMED_STEPS, metrics=metrics)


def bare_text(bare: dict) -> str:
    """The times, the rate and the MFU of a :func:`bare_steps` result."""
    return (f'median {bare["ms"]:.2f} ms/step of {TIMED_STEPS} after {WARMUP_STEPS + 1} '
            f'(min {bare["min_ms"]:.2f}, max {bare["max_ms"]:.2f}) = '
            f'{TRAIN_BATCH / bare["ms"] * 1e3:.1f} tiles/s; MFU '
            f'{bare["flops"] / (bare["ms"] / 1e3) / PEAK_BF16_FLOPS:.4f} '
            f'({bare["flops"] / 1e12:.3f} TFLOP/step by FlopCounterMode / step time / 989 '
            f'TFLOP/s); K8 {bare["k8"]} in {bare["steps"]} steps')


def timed_scene(predict, scene, channels: int):
    """A warm-up and a timed ``tiled_inference`` of ``scene`` (``TILE``²
    tiles, stride ``STRIDE``, ``tile_batch=TILE_BATCH``): (output, ms, K8
    launches of the timed scene)."""
    from ever_tpu_torch import tiled_inference
    from ever_tpu_torch.ops import pool as P

    tiled_inference(predict, scene, TILE, STRIDE, channels, tile_batch=TILE_BATCH)
    torch.cuda.synchronize()
    before = P.max_pool_32_bwd.launches
    t0 = time.perf_counter()
    out = tiled_inference(predict, scene, TILE, STRIDE, channels, tile_batch=TILE_BATCH)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, P.max_pool_32_bwd.launches - before


def levircd_batch(root: str):
    """The first ``TRAIN_BATCH`` LEVIR-CD train items as one batch on the
    card: x ``[B, TILE, TILE, 6]`` and the dict labels."""
    import numpy as np
    from ever_tpu_torch.data.benchmarks import LEVIRCD

    ds = LEVIRCD(dict(root=root, split='train', crop_size=TILE))
    items = [ds[i] for i in range(TRAIN_BATCH)]
    x = torch.from_numpy(np.stack([a for a, _ in items])).cuda()
    return x, {k: torch.from_numpy(np.stack([b[k] for _, b in items])).cuda()
               for k in items[0][1]}


def phase_change(gen, seed: int, smi: str) -> int:
    """FactSeg and the change detectors from the project template's configs
    (module docstring, phase 13): (a) the iSAID, LEVIR-CD and xView2
    readers on seeded trees, (b) FactSeg-R50 through the project's
    train.py with a resume, its evaluation, bare step and a 4096² scene,
    (c) ChangeStar-R18 and ChangeMask-R18 on LEVIR-CD, (d) ChangeOS-R50 on
    xView2 with a 4096² pre/post scene.  Cuts of the configs' runs:
    ``total_batch_size`` 32 or 16 → 8, ``num_iters`` → 6 (FactSeg) or 3,
    ``maxpool_impl='pallas'``; widths, dtype (bf16), optimizers and
    schedules as written.  Returns the phase's K8 launches."""
    import tempfile

    import numpy as np
    from ever_tpu_torch.data.benchmarks import ISAID, LEVIRCD, XView2
    from ever_tpu_torch.interface.module import sum_losses
    from ever_tpu_torch.ops import pool as P

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True          # a resumed run's bits
    k8 = 0
    with tempfile.TemporaryDirectory(prefix='chip_smoke_change_') as tmp:
        proj = os.path.join(tmp, 'proj')
        r = subprocess.run([sys.executable, '-m', 'ever_tpu_torch', 'create', proj], cwd=repo,
                           env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
                           text=True, timeout=300)
        check(r.returncode == 0, f'create failed: {r.stderr[-2000:]}')
        t0 = time.perf_counter()
        truth = write_change_trees(tmp, seed)
        write_s = time.perf_counter() - t0

        # a: the readers on the trees
        iroot, lroot, xroot = (os.path.join(tmp, d) for d in ('iSAID', 'LEVIR-CD', 'xView2'))
        readers = {('isaid', 'train'): ISAID(dict(root=iroot, split='train')),
                   ('isaid', 'val'): ISAID(dict(root=iroot, split='val')),
                   ('levircd', 'train'): LEVIRCD(dict(root=lroot, split='train')),
                   ('levircd', 'test'): LEVIRCD(dict(root=lroot, split='test')),
                   ('xview2', 'train'): XView2(dict(root=xroot, split='train')),
                   ('xview2', 'hold'): XView2(dict(root=xroot, split='hold'))}
        finite, in_sets, exact, n_items = True, True, True, 0
        for (name, split), ds in readers.items():
            for i in range(len(ds)):
                x, y = ds[i]
                n_items += 1
                finite &= bool(np.isfinite(x).all()) and x.dtype == np.float32
                if name == 'isaid':
                    in_sets &= x.shape[-1] == 3 and bool(np.isin(y, list(range(16)) + [255]).all())
                    if split == 'val':
                        exact &= np.array_equal(y, truth[name, split][i])
                elif name == 'levircd':
                    in_sets &= (x.shape[-1] == 6 and bool(np.isin(y['change'], (0, 1)).all())
                                and bool((y['masks'] == 255).all()))
                    if split == 'test':
                        exact &= np.array_equal(y['change'], truth[name, split][i])
                else:
                    in_sets &= (x.shape[-1] == 6 and bool(np.isin(y['loc'], (0, 1)).all())
                                and bool(np.isin(y['damage'], (0, 1, 2, 3, 4, 255)).all()))
                    if split == 'hold':
                        loc, dam = truth[name, split][i]
                        exact &= np.array_equal(y['loc'], loc) and np.array_equal(y['damage'], dam)
        print(f'change: a: seeded trees of {CHANGE_SCENE}² PNG scenes written in '
              f'{write_s:.1f} s; {n_items} items of ISAID, LEVIRCD and XView2 (train crops of '
              f'{TILE}², whole val/test/hold scenes): finite float32 {finite}, labels in their '
              f'sets {in_sets}, whole-scene labels equal to the written ones (off-palette '
              f'colours and damage 5 read as 255) {exact}', flush=True)
        check(finite and in_sets and exact, 'a: a reader yields wrong items')

        # b: FactSeg-R50 through the project's train.py, resumed
        train_py = os.path.join(proj, 'train.py')
        fact_cfg = template_config(proj, 'factseg_r50_isaid', 'factseg_r50_isaid_smoke', iroot)

        def argv(cfg_path, model_dir, iters, evaluate=True):
            return ['--config_path', cfg_path, '--model_dir', model_dir,
                    'train.num_iters', str(iters), 'train.eval_after_train', str(evaluate)]

        la, ra = recorded_run(train_py, argv(fact_cfg, os.path.join(tmp, 'fa'),
                                             CHANGE_RESUME_AT, False))
        del la
        la, ra2 = recorded_run(train_py, argv(fact_cfg, os.path.join(tmp, 'fa'),
                                              CHANGE_ITERS, False))
        resumed = {k: v.detach().clone() for k, v in la.model.state_dict().items()}
        del la
        seen = []
        undo_cm = record_confusion(seen)
        try:
            lb, rb = recorded_run(train_py, argv(fact_cfg, os.path.join(tmp, 'fb'),
                                                 CHANGE_ITERS))
        finally:
            undo_cm()
        k8 += ra['launches'][2] + ra2['launches'][2] + rb['launches'][2]
        model = lb.model
        trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
        resume_equal = all(torch.equal(resumed[k], v) for k, v in trained.items())
        logged = rb['logged']
        losses = {k: [d[k] for _, d, _, _ in logged] for k in ('cls_loss', 'fa_loss', 'dice_loss')}
        finite_losses = all(len(v) == CHANGE_ITERS and all(math.isfinite(a) for a in v)
                            for v in losses.values())
        card_cm, host_cm = card_confusion(lb.model_dir), host_confusion(seen, ISAID_CLASSES)
        launcher_ms = sum(t for _, _, _, t in logged[1:]) / len(logged[1:]) * 1e3
        data_ms = sum(d for _, _, d, _ in logged[1:]) / len(logged[1:]) * 1e3
        print(f'change: b: {smi}: FactSeg-R50 ({os.path.basename(fact_cfg)}: batch '
              f'{TRAIN_BATCH} of {TILE}² iSAID crops, bf16, SGD + poly, K8) through train.py: '
              + '; '.join(f'{k} {" ".join(f"{a:.5f}" for a in v)}' for k, v in losses.items())
              + f'; K8 launches {rb["launches"][2]} (expected {CHANGE_ITERS}), resumed run '
              f'{ra["launches"][2]} + {ra2["launches"][2]}; resumed from step '
              f'{CHANGE_RESUME_AT} to {CHANGE_ITERS} bit-equal to the unbroken run: '
              f'{resume_equal}; the evaluation of {len(seen)} batch(es) of the '
              f'{CHANGE_VAL} val scenes: confusion matrix {card_cm.shape} ({int(card_cm.sum())} '
              f'pixels) equal to np.bincount on the host '
              f'{bool(np.array_equal(card_cm, host_cm))}; through the Launcher '
              f'{launcher_ms:.2f} ms/step ({data_ms:.2f} of it loading; each step an epoch, '
              f'its workers started anew), the mean of steps 2-{CHANGE_ITERS}, deterministic '
              f'cuDNN', flush=True)
        check(finite_losses, 'b: non-finite or missing FactSeg losses')
        check(rb['launches'][2] == CHANGE_ITERS
              and ra['launches'][2] + ra2['launches'][2] == CHANGE_ITERS,
              f'b: K8 launches {rb["launches"][2]}, {ra["launches"][2]} + {ra2["launches"][2]}')
        check(resume_equal, 'b: the resumed FactSeg run differs from the unbroken run')
        check(all(d == 'cuda' for d, _, _, _ in seen) and np.array_equal(card_cm, host_cm)
              and card_cm.shape == (ISAID_CLASSES, ISAID_CLASSES) and int(card_cm.sum()) > 0,
              "b: the card's confusion matrix differs from the host's")
        del lb, resumed
        torch.backends.cudnn.deterministic = deterministic
        x = torch.randn(TRAIN_BATCH, TILE, TILE, 3, generator=gen, device='cuda')
        y = torch.randint(0, ISAID_CLASSES, (TRAIN_BATCH, TILE, TILE), generator=gen,
                          device='cuda')
        bare = bare_steps(model, fact_cfg, (x, y))
        m = bare['metrics']
        k8 += bare['k8']
        print(f'change: b: {smi}: the bare FactSeg-R50 step (build_train_step, batch '
              f'{TRAIN_BATCH} of {TILE}², bf16, SGD + poly): {bare_text(bare)}; losses '
              f'{m["cls_loss"].item():.5f} {m["fa_loss"].item():.5f} '
              f'{m["dice_loss"].item():.5f}', flush=True)
        check(bare['k8'] == bare['steps'] and math.isfinite(m['total_loss'].item()),
              f'b: the bare FactSeg step launched K8 {bare["k8"]} times in {bare["steps"]}')
        model.load_state_dict(trained, strict=True)
        scene = torch.randn(SCENE, SCENE, 3, generator=gen, device='cuda')
        out, fact_scene_ms, serve_k8 = timed_scene(model, scene, ISAID_CLASSES)
        sums = float((out.sum(-1) - 1).abs().max())
        finite = bool(torch.isfinite(out).all())
        print(f'change: b: {smi}: FactSeg-R50 tiled_inference of a {SCENE}² scene ({TILE}² '
              f'tiles, stride {STRIDE}, tile_batch {TILE_BATCH}, bf16): {fact_scene_ms:.1f} '
              f'ms/scene = {(SCENE // STRIDE) ** 2 / fact_scene_ms * 1e3:.1f} tiles/s; joint '
              f'probabilities finite {finite}, sums within {sums:.2e} of 1; K8 launches '
              f'{serve_k8}', flush=True)
        check(finite and sums <= PROB_SUM_TOL
              and tuple(out.shape) == (SCENE, SCENE, ISAID_CLASSES),
              'b: the served joint probabilities are not finite or do not sum to 1')
        check(serve_k8 == 0, f'b: serving launched K8 {serve_k8} times')
        del model, trained, out, scene, x, y
        torch.cuda.empty_cache()

        # c, d: the change detectors through train.py, 3 steps each
        detectors = (
            ('c', 'ChangeStar-R18', 'changestar_r18_levircd', lroot,
             ('seg_loss', 'change_loss'), 'SGD + poly'),
            ('c', 'ChangeMask-R18', 'changemask_r18_levircd', lroot,
             ('sem_loss', 'change_loss', 'consistency_loss'), 'AdamW + cosine'),
            ('d', 'ChangeOS-R50', 'changeos_r50_xview2', xroot,
             ('loc_loss', 'damage_loss'), 'SGD + poly'))
        for part, name, template, root, keys, opt in detectors:
            torch.backends.cudnn.deterministic = True
            cfg_path = template_config(proj, template, template + '_smoke', root)
            seen = []
            undo_cm = record_confusion(seen)
            try:
                launcher, rec = recorded_run(train_py, argv(
                    cfg_path, os.path.join(tmp, template), DETECTOR_ITERS))
            finally:
                undo_cm()
            torch.backends.cudnn.deterministic = deterministic
            k8 += rec['launches'][2]
            model = launcher.model
            losses = {k: [d[k] for _, d, _, _ in rec['logged']] for k in keys}
            finite_losses = all(len(v) == DETECTOR_ITERS and all(math.isfinite(a) for a in v)
                                for v in losses.values())
            n_cls = DAMAGE_CLASSES if name.startswith('ChangeOS') else 2
            card_cm, host_cm = card_confusion(launcher.model_dir), host_confusion(seen, n_cls)
            launcher_ms = sum(t for _, _, _, t in rec['logged'][1:]) / (DETECTOR_ITERS - 1) * 1e3
            extra = ''
            if name.startswith('ChangeStar'):
                # LEVIR-CD's per-date masks are all ignored: seg_loss is 0 and
                # the seg classifier gets a zero gradient, not a NaN
                xb, yb = levircd_batch(root)
                model.zero_grad(set_to_none=True)
                before = P.max_pool_32_bwd.launches
                out = model(xb, yb, train=True,
                            generator=torch.Generator(device='cuda').manual_seed(seed))
                sum_losses(out).backward()
                seg_k8 = P.max_pool_32_bwd.launches - before
                k8 += seg_k8
                seg_grads = [model.seg_cls.weight.grad, model.seg_cls.bias.grad]
                seg_zero = (out['seg_loss'].item() == 0.0 and all(
                    g is not None and not bool(g.any()) for g in seg_grads))
                model.zero_grad(set_to_none=True)
                extra = (f'; seg_loss of a LEVIR-CD batch {out["seg_loss"].item()} with a '
                         f'zero gradient to seg_cls {seg_zero} (K8 {seg_k8} in its backward)')
                check(seg_zero and all(v == 0.0 for v in losses['seg_loss']),
                      f'{part}: {name}: seg_loss is not exactly 0 with a zero gradient')
                check(seg_k8 == 1, f'{part}: {name}: the seg_loss backward launched K8 '
                      f'{seg_k8} times')
                del out, xb, yb
            x = torch.randn(TRAIN_BATCH, TILE, TILE, 6, generator=gen, device='cuda')
            if name.startswith('ChangeOS'):
                y = dict(loc=torch.randint(0, 2, (TRAIN_BATCH, TILE, TILE), generator=gen,
                                           device='cuda'),
                         damage=torch.randint(0, DAMAGE_CLASSES, (TRAIN_BATCH, TILE, TILE),
                                              generator=gen, device='cuda'))
            else:
                y = dict(masks=torch.full((TRAIN_BATCH, TILE, TILE, 2), 255, device='cuda'),
                         change=torch.randint(0, 2, (TRAIN_BATCH, TILE, TILE), generator=gen,
                                              device='cuda'))
            bare = bare_steps(model, cfg_path, (x, y))
            m = bare['metrics']
            k8 += bare['k8']
            print(f'change: {part}: {smi}: {name} ({os.path.basename(cfg_path)}: batch '
                  f'{TRAIN_BATCH} of {TILE}² pairs, bf16, {opt}, K8) through train.py: '
                  + '; '.join(f'{k} {" ".join(f"{a:.5f}" for a in v)}' for k, v in losses.items())
                  + f'; K8 launches {rec["launches"][2]} (expected {DETECTOR_ITERS}: one '
                  f'encoder pass over both dates a step){extra}; the auto-routed evaluation of '
                  f'{len(seen)} batch(es): confusion matrix {card_cm.shape} '
                  f'({int(card_cm.sum())} pixels) equal to np.bincount on the host '
                  f'{bool(np.array_equal(card_cm, host_cm))}; through the Launcher '
                  f'{launcher_ms:.2f} ms/step (steps 2-{DETECTOR_ITERS}); the bare step '
                  f'{bare_text(bare)}', flush=True)
            check(finite_losses and math.isfinite(m['total_loss'].item()),
                  f'{part}: {name}: non-finite or missing losses')
            check(rec['launches'][2] == DETECTOR_ITERS and bare['k8'] == bare['steps'],
                  f'{part}: {name}: K8 launches {rec["launches"][2]}, bare {bare["k8"]} in '
                  f'{bare["steps"]}')
            check(all(d == 'cuda' for d, _, _, _ in seen) and np.array_equal(card_cm, host_cm)
                  and card_cm.shape == (n_cls, n_cls) and int(card_cm.sum()) > 0,
                  f"{part}: {name}: the card's confusion matrix differs from the host's")
            if name.startswith('ChangeOS'):
                scene = torch.randn(SCENE, SCENE, 6, generator=gen, device='cuda')
                out, os_scene_ms, serve_k8 = timed_scene(
                    lambda t: torch.cat(model(t), dim=-1), scene, 1 + DAMAGE_CLASSES)
                sums = float((out[..., 1:].sum(-1) - 1).abs().max())
                finite = bool(torch.isfinite(out).all())
                loc_ok = bool(((out[..., 0] >= 0) & (out[..., 0] <= 1)).all())
                print(f'change: d: {smi}: ChangeOS-R50 tiled_inference of a {SCENE}² pre/post '
                      f'scene (6 channels, {TILE}² tiles, stride {STRIDE}, tile_batch '
                      f'{TILE_BATCH}, bf16, predict_fn (loc_prob, damage_prob) as one 6-channel '
                      f'output): {os_scene_ms:.1f} ms/scene; finite {finite}, localisation in '
                      f'[0, 1] {loc_ok}, damage probabilities sum within {sums:.2e} of 1; K8 '
                      f'launches {serve_k8}', flush=True)
                check(finite and loc_ok and sums <= PROB_SUM_TOL
                      and tuple(out.shape) == (SCENE, SCENE, 1 + DAMAGE_CLASSES),
                      'd: the served ChangeOS scene is not finite or not normalised')
                check(serve_k8 == 0, f'd: serving launched K8 {serve_k8} times')
                del out, scene
            del launcher, model, x, y
            torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic
    print(f'change: {smi}: K8 launches in the phase {k8}; phase wall time '
          f'{time.perf_counter() - t_phase:.1f} s', flush=True)
    return k8


# the user phase: a user's own FarSeg-R50 through the project's train.py
# with the reader's augmentations, the losses ported last, a trace and
# TensorBoard; and the batched augmentation on the card
USER_SCENE, USER_TRAIN, USER_VAL, USER_ITERS = 1024, 4, 1, 6    # scenes a domain
USER_AUG_BATCH, USER_AUG_CALLS, USER_AUG_TIMED = 8, 64, 20
USER_PROFILE_STEPS = (2, 4)
USER_LOSS_TOL = 1e-5            # relative, the card's float32 against float64 on the CPU
USER_MODULE = '''\
"""A user's own model: FarSeg-R50 trained on the hardest quarter of its
pixels' cross-entropies, a focal Tversky loss and a label-smoothed
cross-entropy."""
import torch

from ever_tpu_torch.core import registry
from ever_tpu_torch.module import FarSeg
from ever_tpu_torch.module import loss as L


@registry.MODEL.register('UserFarSeg')
class UserFarSeg(FarSeg):
    def logits(self, x, train=False, generator=None):
        feats = self.encoder(x.to(getattr(torch, self.config.dtype)), train)
        return self.head(feats, train, generator).permute(0, 2, 3, 1).float()

    def forward(self, x, y=None, train=False, generator=None):
        logits = self.logits(x, train, generator)
        if not (train and y is not None):
            return torch.softmax(logits, dim=-1)
        ce = L.softmax_ce_loss_with_logits(logits, y, reduction='none')
        return dict(
            ohem_loss=L.online_hard_example_mining(ce, keep_ratio=0.25),
            tversky_loss=L.tversky_loss_with_logits(logits, y, alpha=0.7, beta=0.3,
                                                    gamma=0.75),
            ls_ce_loss=L.label_smoothing_cross_entropy(logits, y, eps=0.1,
                                                       ignore_index=255))
'''
USER_CONFIG = '''\
# a user's FarSeg-R50 (module/user_farseg.py) on LoveDA, from
# farseg_r50_loveda.py: batch {batch} of {tile}² crops, the reader's
# augmentations, bf16, SGD + poly, its run cut to {iters} steps
from ever_tpu_torch.preprocess import segm

config = dict(
    model=dict(type='UserFarSeg', params=dict(
        encoder=dict(resnet_type='resnet50', maxpool_impl='pallas'),
        classes={classes}, dtype='bfloat16')),
    data=dict(
        train=dict(type='loveda', params=dict(
            root={root!r}, split='train', total_batch_size={batch}, num_workers={workers},
            sampler_type='StepDistributedSampler', crop_size={tile},
            transforms=[
                segm.RandomDiscreteScale([0.75, 1.25, 1.5], p=0.5, size_divisor=32, seed=1),
                segm.RandomCrop({tile}, seed=2),
                segm.RandomRotate90K(seed=3),
                segm.RandomTranspose(seed=4),
                segm.RandomHorizontalFlip(seed=5),
                segm.MeanStdNormalize(),
            ])),
        test=dict(type='loveda', params=dict(
            root={root!r}, split='val', batch_size=2, sampler_type='SequentialSampler')),
    ),
    learning_rate=dict(type='poly', params=dict(
        base_lr=0.0075, power=0.9, max_iters=15000,
        warmup=dict(type='linear', step=500, ratio=0.01))),
    optimizer=dict(type='sgd', params=dict(momentum=0.9, weight_decay=1e-4),
                   grad_clip=dict(max_norm=35.0)),
    train=dict(num_iters={iters}, forward_times=1, eval_per_epoch=False,
               eval_after_train=False, log_interval_step=1, save_ckpt_interval_epoch=1000,
               distributed=True, profile_dir={profile_dir!r},
               profile_steps={profile_steps!r}),
)
'''


def check_batch_augment(gen, seed: int, smi: str) -> None:
    """(a) ``preprocess.device.batch_augment`` of 8 seeded uint8 scenes of
    1024² with their masks: a 512² crop, a symmetry of the square and the
    normalisation, with no host wait; each sample equal to the plain
    evaluation of its draws; all 8 symmetries over 64 calls; timed."""
    from ever_tpu_torch.preprocess.device import batch_augment
    from ever_tpu_torch.preprocess.function import IMAGENET_MEAN, IMAGENET_STD

    n, size = USER_AUG_BATCH, USER_SCENE
    images = torch.randint(0, 256, (n, size, size, 3), generator=gen, device='cuda',
                           dtype=torch.uint8)
    masks = torch.randint(0, CLASSES, (n, size, size), generator=gen, device='cuda',
                          dtype=torch.uint8)
    g = torch.Generator(device='cuda').manual_seed(seed)
    crop = (TILE, TILE)
    batch_augment(g, images, masks, crop_size=crop)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out, out_masks, draws = batch_augment(g, images, masks, crop_size=crop,
                                              return_draws=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    mean = torch.tensor(IMAGENET_MEAN, device='cuda')
    std = torch.tensor(IMAGENET_STD, device='cuda')
    exact = True
    host = {k: v.tolist() for k, v in draws.items()}
    for i in range(n):
        y, x, k, flip = host['y'][i], host['x'][i], host['k'][i], host['flip'][i]
        for src, got in ((images, out), (masks, out_masks)):
            want = torch.rot90(src[i, y:y + TILE, x:x + TILE], k, (0, 1))
            if flip:
                want = torch.flip(want, (1,))
            if src is images:
                want = (want.float() - mean) / std
            exact &= got.dtype == want.dtype and torch.equal(got[i], want)
    pairs = []
    for _ in range(USER_AUG_CALLS):
        _, _, d = batch_augment(g, images, masks, crop_size=crop, return_draws=True)
        pairs.append(d['k'] * 2 + d['flip'].long())
    symmetries = sorted(set(torch.cat(pairs).tolist()))
    ms = cuda_ms(lambda: batch_augment(g, images, masks, crop_size=crop), USER_AUG_TIMED)
    moved = n * TILE * TILE * (3 + 3 * 4 + 1 + 1)
    print(f'user: a: {smi}: batch_augment of {n} uint8 scenes of {size}² with masks '
          f'(crop {TILE}², D4, normalize): {ms:.4f} ms a batch by CUDA events '
          f'({moved / ms / 1e6:.1f} GB/s of crops read and written), no host wait under '
          f"set_sync_debug_mode('error'); every sample equal to the plain evaluation of its "
          f'draws {exact}; symmetries drawn in {USER_AUG_CALLS} calls: {len(symmetries)} of 8',
          flush=True)
    check(exact and tuple(out.shape) == (n, TILE, TILE, 3) and out.dtype == torch.float32
          and out_masks.dtype == torch.uint8,
          'a: a batch_augment sample differs from the plain evaluation of its draws')
    check(symmetries == list(range(8)), f'a: batch_augment drew the symmetries {symmetries}')


def reference_losses(logits, labels) -> dict:
    """The losses of the user phase written plainly, in float64, on the
    CPU: name -> (value, gradient with respect to ``logits``), plus each
    element's reference CE (OHEM's ambiguous band is read from it)."""
    z = logits.detach().double().cpu().requires_grad_()
    y = labels.cpu().long()
    c = z.shape[-1]
    zf, yf = z.reshape(-1, c), y.reshape(-1)
    valid = (yf != 255).double()
    lab = torch.where(yf == 255, torch.zeros_like(yf), yf)
    onehot = torch.nn.functional.one_hot(lab, c).double() * valid[:, None]
    logp = torch.log_softmax(zf, -1)
    prob = torch.softmax(zf, -1) * valid[:, None]
    nll = -logp.gather(1, lab[:, None])[:, 0] * valid
    t = ((yf == 1) * 1.0).double()
    binary = zf[:, 1]
    bce = binary.clamp(min=0) - binary * t + torch.log1p(torch.exp(-binary.abs()))
    with torch.no_grad():
        p = torch.sigmoid(binary)
        mod = ((1 - p) * t + p * (1 - t)) ** 2
    p_sig = torch.sigmoid(binary)
    p_t = p_sig * t + (1 - p_sig) * (1 - t)
    ls_t = torch.where(yf == 0, torch.full_like(t, 0.1), (yf > 0) * 1.0 - 0.1).double()
    zb = zf[:, 0]
    ls_bce = (zb.clamp(min=0) - zb * ls_t + torch.log1p(torch.exp(-zb.abs()))) * valid
    soft = torch.nn.functional.one_hot(lab, c).double() * 0.9 + 0.1 / c
    k = max(int(0.25 * nll.numel()), 1)
    top = torch.sort(nll, descending=True, stable=True).values[:k]
    tp = (prob * onehot).sum(0)
    tversky = (1 - (tp + 1) / (tp + 0.7 * (onehot.sum(0) - tp) + 0.3 * (prob.sum(0) - tp)
                               + 1)) ** 0.75
    count = valid.sum().clamp(min=1)
    values = {
        'ohem': (top * (top != 0)).sum() / (top != 0).sum().clamp(min=1),
        'tversky': tversky.mean(),
        'ls_ce': (-logp.sum(-1) * valid).sum() / count * 0.1 / c + 0.9 * nll.sum() / count,
        'focal': (bce * mod).mean(),
        'focal_normalize': (bce * mod).sum() * (bce.sum() / (bce * mod).sum()),
        'sigmoid_focal': (bce * (1 - p_t) ** 2).mean(),
        'ls_bce': ls_bce.sum() / count,
        'soft_ce': -(soft.reshape(z.shape) * torch.log_softmax(z, -1)).mean((0, 1, 2)).sum(),
        'dice_coeff': ((2 * tp + 1) / (prob.sum(0) + onehot.sum(0) + 1)).mean(),
    }
    out = {}
    for name, v in values.items():
        (g,) = torch.autograd.grad(v, z, retain_graph=True)
        out[name] = (float(v.detach()), g)
    out['nll'], out['k'] = nll.detach(), k
    return out


def port_losses(logits, labels) -> dict:
    """The port's functions on the card, float32: name -> (value,
    gradient), with ``select``'s three outputs."""
    from ever_tpu_torch.module import loss as L

    c = logits.shape[-1]
    t = (labels == 1) * 1.0
    fns = {
        'ohem': lambda z: L.online_hard_example_mining(
            L.softmax_ce_loss_with_logits(z, labels, reduction='none'), keep_ratio=0.25),
        'tversky': lambda z: L.tversky_loss_with_logits(z, labels, alpha=0.7, beta=0.3,
                                                        gamma=0.75),
        'ls_ce': lambda z: L.label_smoothing_cross_entropy(z, labels, eps=0.1,
                                                           ignore_index=255),
        'focal': lambda z: L.focal_loss(z[..., 1], t),
        'focal_normalize': lambda z: L.focal_loss(z[..., 1], t, normalize=True),
        'sigmoid_focal': lambda z: L.sigmoid_focal_loss(z[..., 1], t),
        'ls_bce': lambda z: L.label_smoothing_binary_cross_entropy(
            z[..., 0], (labels > 0) * 1.0 + (labels == 255) * 254.0),
        'soft_ce': lambda z: L.soft_cross_entropy(
            z, torch.nn.functional.one_hot(torch.where(labels == 255, 0, labels).long(), c)
            * 0.9 + 0.1 / c),
        'dice_coeff': lambda z: L.dice_coeff(
            torch.softmax(z, -1).reshape(-1, c),
            torch.nn.functional.one_hot(torch.where(labels == 255, 0, labels).long(),
                                        c).reshape(-1, c).float(),
            (labels != 255).reshape(-1).float()),
    }
    out = {}
    for name, fn in fns.items():
        z = logits.detach().clone().requires_grad_()
        v = fn(z)
        v.backward()
        out[name] = (float(v.detach()), z.grad)
    out['select'] = L.select(logits, labels)
    return out


def trace_summary(path: str) -> dict:
    """Counts and shares of a Chrome trace of ``torch.profiler``: the K8
    kernels, the host's ``load_data`` spans, the device-busy share of the
    traced window (the union of the kernels', copies' and fills' intervals
    over the span of every event), the five kernels with the most time and
    the five longest gaps in the device's work."""
    with open(path) as f:
        events = [e for e in json.load(f)['traceEvents'] if e.get('ph') == 'X']
    kernels = [e for e in events if e.get('cat') == 'kernel']
    device = sorted((e for e in events if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')),
                    key=lambda e: e['ts'])
    begin = min(e['ts'] for e in events)
    end = max(e['ts'] + e.get('dur', 0) for e in events)
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for e in device:
        s, t = e['ts'], e['ts'] + e.get('dur', 0)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, cur_e - begin))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = {}
    for e in kernels:
        by_name[e['name']] = by_name.get(e['name'], 0.0) + e.get('dur', 0)
    return dict(
        k8=sum('maxpool32_bwd' in e['name'] for e in kernels),
        load_data=sum(e['name'] == 'load_data' and e.get('cat') == 'user_annotation'
                      for e in events),
        window_ms=(end - begin) / 1e3, busy=busy / max(end - begin, 1e-9),
        top=sorted(by_name.items(), key=lambda kv: -kv[1])[:5],
        gaps=sorted(gaps, reverse=True)[:5], n_kernels=len(kernels))


def phase_user(gen, seed: int, smi: str) -> int:
    """A user's own model trained with the reader's augmentations (module
    docstring, phase 14): (a) the batched augmentation on the card, (b) a
    FarSeg-R50 the project registers in ``module/`` through the project's
    train.py with the ``transforms`` list, the OHEM, Tversky and
    label-smoothing losses, ``--use_tensorboard`` and ``train.profile_dir``;
    the losses against float64; the trace's breakdown.  Returns the
    phase's K8 launches."""
    import tempfile

    import numpy as np
    from ever_tpu_torch.core import registry
    from ever_tpu_torch.core.config import import_config

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    check_batch_augment(gen, seed, smi)
    k8 = 0
    with tempfile.TemporaryDirectory(prefix='chip_smoke_user_') as tmp:
        proj = os.path.join(tmp, 'proj')
        r = subprocess.run([sys.executable, '-m', 'ever_tpu_torch', 'create', proj], cwd=repo,
                           env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
                           text=True, timeout=300)
        check(r.returncode == 0, f'create failed: {r.stderr[-2000:]}')
        with open(os.path.join(proj, 'module', 'user_farseg.py'), 'w') as f:
            f.write(USER_MODULE)
        root = os.path.join(tmp, 'LoveDA')
        write_loveda(root, seed, layout=[(split, dom, n, USER_SCENE)
                                         for split, n in (('Train', USER_TRAIN),
                                                          ('Val', USER_VAL))
                                         for dom in ('Urban', 'Rural')])
        profile_dir = os.path.join(tmp, 'runs', 'user', 'trace')
        cfg_path = os.path.join(proj, 'configs', 'user_farseg_loveda.py')
        with open(cfg_path, 'w') as f:
            f.write(USER_CONFIG.format(batch=TRAIN_BATCH, tile=TILE, iters=USER_ITERS,
                                       classes=CLASSES, root=root, workers=MODELS_WORKERS,
                                       profile_dir=profile_dir,
                                       profile_steps=USER_PROFILE_STEPS))
        train_py = os.path.join(proj, 'train.py')

        # b: the traced run with TensorBoard
        model_dir = os.path.join(tmp, 'runs', 'user')
        launcher, rec = recorded_run(train_py, ['--config_path', cfg_path, '--model_dir',
                                                model_dir, '--use_tensorboard'])
        launcher.logger.close()
        k8 += rec['launches'][2]
        logged = rec['logged']
        keys = ('ohem_loss', 'tversky_loss', 'ls_ce_loss')
        losses = {k: [d[k] for _, d, _, _ in logged] for k in keys}
        finite = all(len(v) == USER_ITERS and all(math.isfinite(a) for a in v)
                     for v in losses.values())
        check(type(launcher.model).__name__ == 'UserFarSeg', 'b: the model is not the user\'s')
        check(finite, 'b: non-finite or missing user losses')
        check(rec['launches'][2] == USER_ITERS,
              f'b: K8 launches {rec["launches"][2]} in {USER_ITERS} steps')
        traced_ms, traced_data_ms = logged_medians(logged)

        # the config's transforms are the ones that ran: item 0 of the
        # train dataset against the item without them, through a copy
        params = import_config(cfg_path).data.train.params
        dataset = registry.DATASET['loveda'](params)
        bare = registry.DATASET['loveda'](dict(params.to_dict(), transforms=None))
        image, mask = bare[0]
        for t in import_config(cfg_path).data.train.params.transforms:
            image, mask = t(image, mask)
        item = dataset[0]
        same_item = (np.array_equal(item[0], image) and np.array_equal(item[1], mask)
                     and item[0].dtype == image.dtype == np.float32)
        check(same_item, 'b: item 0 is not the bare item through the config\'s transforms')

        # the losses on the first batch's logits against float64
        items = [item] + [dataset[i] for i in range(1, TRAIN_BATCH)]
        x = torch.from_numpy(np.stack([a for a, _ in items])).cuda()
        y = torch.from_numpy(np.stack([b for _, b in items])).cuda()
        with torch.no_grad():
            logits = launcher.model.logits(x)
        got, want = port_losses(logits, y), reference_losses(logits, y)
        nll, kth = want['nll'], want['k']
        threshold = float(torch.sort(nll, descending=True).values[kth - 1])
        ambiguous = (nll - threshold).abs() <= 1e-5 * abs(threshold)
        errors = {}
        for name, (value, grad) in ((k, v) for k, v in got.items() if k != 'select'):
            wv, wg = want[name]
            g = grad.double().cpu()
            if name == 'ohem':
                keep = ~ambiguous.reshape(g.shape[:-1])
                g, wg = g[keep], wg[keep]
            errors[name] = (abs(value - wv) / max(abs(wv), 1e-30),
                            float((g - wg).abs().max() / wg.abs().max().clamp(min=1e-30)))
        sel = got['select']
        select_ok = (torch.equal(sel[0], logits.reshape(-1, CLASSES))
                     and torch.equal(sel[1], y.reshape(-1))
                     and torch.equal(sel[2], (y.reshape(-1) != 255).float()))
        worst = max(max(v) for v in errors.values())
        print(f'user: b: {smi}: the first batch\'s logits, the card\'s float32 against float64 '
              f'on the CPU (value, gradient; relative): '
              + ', '.join(f'{k} {a:.2e} {b:.2e}' for k, (a, b) in errors.items())
              + f'; OHEM gradient compared off {int(ambiguous.sum())} pixels whose CE is '
              f'within 1e-5 of the k-th; select equal {select_ok}', flush=True)
        check(worst <= USER_LOSS_TOL and select_ok,
              f'b: a loss differs from its float64 evaluation by {worst:.2e}')

        traces = os.listdir(profile_dir) if os.path.isdir(profile_dir) else []
        check(len(traces) == 1, f'b: the profile dir holds {traces}')
        summary = trace_summary(os.path.join(profile_dir, traces[0]))
        print(f'user: b: {smi}: the trace {traces[0]} ({summary["window_ms"]:.1f} ms, '
              f'{summary["n_kernels"]} kernels): K8 kernels {summary["k8"]}, load_data spans '
              f'{summary["load_data"]}; the card busy {summary["busy"] * 100:.1f} % of the '
              f'window; most time: '
              + '; '.join(f'{kernel_name(n)[:60]} {t / 1e3:.3f} ms' for n, t in summary['top'])
              + '; longest idle gaps: '
              + ', '.join(f'{g / 1e3:.3f} ms at {at / 1e3:.1f} ms' for g, at in summary['gaps']),
              flush=True)
        check(summary['k8'] == USER_PROFILE_STEPS[1] - USER_PROFILE_STEPS[0]
              and summary['load_data'] == USER_PROFILE_STEPS[1] - USER_PROFILE_STEPS[0],
              f'b: the trace holds {summary["k8"]} K8 kernels and {summary["load_data"]} '
              'load_data spans')

        try:
            from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
        except ImportError:
            print('user: b: tensorboard does not import on this machine: the logger warned '
                  'and skipped its TensorBoard sink (the CPU tests drive it)', flush=True)
        else:
            events = [n for n in os.listdir(model_dir) if n.startswith('events.out.tfevents')]
            check(len(events) == 1, f'b: event files {events}')
            acc = EventAccumulator(os.path.join(model_dir, events[0]))
            acc.Reload()
            steps = [e.step for e in acc.Scalars('train/ohem_loss')]
            print(f'user: b: the TensorBoard event file holds train/ohem_loss at steps {steps}',
                  flush=True)
            check(steps == list(range(1, USER_ITERS + 1)), f'b: TensorBoard steps {steps}')
        del launcher, logits, x, y
        torch.cuda.empty_cache()

        # the same run untraced, with and without the transforms
        times = {}
        for name, opts in (('with', []), ('without', ['data.train.params.transforms', 'null'])):
            launcher, run = recorded_run(train_py, [
                '--config_path', cfg_path, '--model_dir', os.path.join(tmp, 'runs', name),
                'train.profile_dir', 'null', *opts])
            k8 += run['launches'][2]
            check(run['launches'][2] == USER_ITERS and all(
                math.isfinite(d['ohem_loss']) for _, d, _, _ in run['logged']),
                f'b: the untraced run {name} the transforms: K8 {run["launches"][2]}')
            times[name] = logged_medians(run['logged'])
            del launcher
            torch.cuda.empty_cache()
        print(f'user: b: {smi}: {type(dataset).__name__} batch {TRAIN_BATCH} of {TILE}² crops '
              f'from {USER_SCENE}² PNGs, {MODELS_WORKERS} workers, bf16, SGD + poly, '
              f'{USER_ITERS} steps through train.py: losses '
              + '; '.join(f'{k} {" ".join(f"{a:.5f}" for a in v)}' for k, v in losses.items())
              + f'; K8 launches {rec["launches"][2]} (1 a step); through the Launcher '
              f'{times["with"][0]:.2f} ms/step with the transforms ({times["with"][1]:.2f} '
              f'loading), {times["without"][0]:.2f} without them ({times["without"][1]:.2f}); '
              f'the traced run {traced_ms:.2f} ({traced_data_ms:.2f}); medians of steps '
              f'2-{USER_ITERS}; item 0 equal to the bare item through a copy of the config\'s '
              f'transforms {same_item}', flush=True)
    print(f'user: {smi}: K8 launches in the phase {k8}; phase wall time '
          f'{time.perf_counter() - t_phase:.1f} s', flush=True)
    return k8


# phase 15, int8: W8A8 serving on K7 and the exported programs.  Calibration:
# 2 seeded batches of TILE_BATCH tiles; W8A8 against the bf16 scene by the
# centred cosine of tests/test_ptq.py (DinoSeg 0.99, FarSeg 0.98)
INT8_CALIB_BATCHES = 2
INT8_COS_MIN = {'dinoseg': 0.99, 'farseg': 0.98}
# the LR range test: the search schedule over LR_STEPS steps of FarSeg-R50
# (init_lr · mult^step, mult = (final/init)^(1/steps)); the sweep stops at
# 0.1 so that SGD keeps every loss finite over the 12 steps
LR_STEPS, LR_INIT, LR_FINAL = 12, 1e-5, 0.1
PADCROP_SHAPE = (2, 500, 500, 3)


@contextlib.contextmanager
def c_calls():
    """Calls of each kernel library's C entry inside the block, counted
    below the wrappers: ``{entry name: calls}``."""
    from ever_tpu_torch.ops import _build

    calls = {}
    original = _build.function

    def counted(lib, name, argtypes):
        fn = original(lib, name, argtypes)

        def call(*args):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args)
        return call

    _build.function = counted
    try:
        yield calls
    finally:
        _build.function = original


def check_ops_on_card(gen) -> None:
    """(a) ``torch.library.opcheck`` of every op on CUDA tensors at small
    shapes; then each launch counter must have moved by the C calls made."""
    from torch.library import opcheck
    from ever_tpu_torch.ops import attention as A, norm as N, pool as P, quant as Q

    def rand(*shape, dtype=torch.bfloat16, grad=False):
        return torch.randn(shape, generator=gen, device='cuda').to(dtype).requires_grad_(grad)

    q, k, v = (rand(2, 64, 2, 64) for _ in range(3))
    sin, cos = rope_tables(64, 'cuda', grid=7)
    o, lse = A.fused_attention(q, k, v, n_valid=60, rope=(sin, cos))
    x_ln, w_ln, b_ln = rand(64, 256), rand(256, dtype=torch.float32), rand(256, dtype=torch.float32)
    _, mean, rstd = N.layer_norm_fwd(x_ln, w_ln, b_ln, LN_EPS)
    x_p = rand(2, 16, 16, 8)
    out_p = P.max_pool_32(x_p)
    cases = [
        ('attention_fwd', A._attention_fwd_op, (q, k, v, sin, cos, 'bnhd', 60)),
        ('attention_fwd grad', A._attention_fwd_op,
         tuple(t.detach().requires_grad_() for t in (q, k, v)) + (None, None, 'bnhd', None)),
        ('attention_bwd', A._attention_bwd_op, (q, k, v, o, lse, rand(2, 64, 2, 64), sin, cos,
                                                'bnhd', 60)),
        ('layer_norm_fwd grad', N._layer_norm_fwd_op,
         (x_ln.detach().requires_grad_(), w_ln.detach().requires_grad_(),
          b_ln.detach().requires_grad_(), LN_EPS)),
        ('layer_norm_bwd', N._layer_norm_bwd_op, (x_ln, rand(64, 256), w_ln, mean, rstd)),
        ('max_pool_32 grad', P._max_pool_32_op, (x_p.detach().requires_grad_(),)),
        ('max_pool_32_bwd', P._max_pool_32_bwd_op, (x_p, out_p, rand(*out_p.shape))),
        ('quantize_int8_values', Q._quantize_op,
         (rand(64, 128, dtype=torch.float32), torch.full((1, 1), 0.02, device='cuda'), 3, True)),
        ('int8_matmul_t', Q._int8_matmul_op,
         (torch.randint(-127, 128, (64, 128), generator=gen, device='cuda', dtype=torch.int8),
          torch.ones(1, 1, device='cuda'),
          torch.randint(-127, 128, (32, 128), generator=gen, device='cuda', dtype=torch.int8),
          torch.full((1, 1), 0.5, device='cuda'))),
    ]
    counters = {'ever_attn_fwd': A.fused_attention, 'ever_attn_bwd': A.fused_attention_bwd,
                'ever_layernorm_fwd': N.layer_norm_fwd, 'ever_layernorm_bwd': N.layer_norm_bwd,
                'ever_maxpool32_bwd': P.max_pool_32_bwd, 'ever_quant_int8': Q.quantize_int8_values,
                'ever_int8_matmul': Q.int8_matmul_t}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with c_calls() as calls:
        for name, op, args in cases:
            opcheck(op, args)
        torch.cuda.synchronize()
    moved = {entry: fn.launches for entry, fn in counters.items()}
    print(f'int8: (a) opcheck of {len(cases)} op cases on CUDA tensors passed in '
          f'{time.perf_counter() - t0:.1f} s; launches counted by the wrappers {moved}, C calls '
          f'{calls}', flush=True)
    check(all(moved[e] == calls.get(e, 0) for e in counters),
          f'launch counters {moved} differ from the C calls {calls}')
    check(all(calls.get(e, 0) > 0 for e in counters), f'opcheck left a kernel unlaunched: {calls}')


def centred_cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / (a.norm() * b.norm() + 1e-12))


def int8_counts():
    from ever_tpu_torch.ops import attention as A, quant as Q

    return A.fused_attention.launches, Q.int8_matmul_t.launches


def export_and_load(cfg_path, ckpt, path, calib=None):
    """``export_model`` (with ``ptq_calib=calib`` when given) and
    ``torch.export.load(...).module()``: (program, export s, load s)."""
    from ever_tpu_torch.api import infer_tool

    t0 = time.perf_counter()
    infer_tool.export_model(cfg_path, ckpt, (TILE_BATCH, TILE, TILE, 3), path, ptq_calib=calib)
    t1 = time.perf_counter()
    program = torch.export.load(path).module()
    return program, t1 - t0, time.perf_counter() - t1


def int8_model(name: str, model, cfg_path: str, ckpt: str, tmp: str, gen, smi: str,
               n_layers: int):
    """Steps (b)-(d) for one model: the floating-point program against the
    eager model (DinoSeg only), the W8A8 model (``n_layers`` quantized) on
    the scene, each K7 call on the path its operands give it, the W8A8
    program against the eager W8A8 tile batch, and the times.  Returns (K1
    launches, K7 launches, the W8A8 predict function, the tile batch)."""
    import types
    from ever_tpu_torch import tiled_inference
    from ever_tpu_torch.ops import ptq
    from ever_tpu_torch.ops import quant as Q

    scene = torch.randn(SCENE, SCENE, 3, generator=gen, device='cuda')
    tiles = torch.stack([scene[i * TILE:(i + 1) * TILE, :TILE] for i in range(TILE_BATCH)])
    calib = [torch.randn(TILE_BATCH, TILE, TILE, 3, generator=gen, device='cuda')
             for _ in range(INT8_CALIB_BATCHES)]
    n_batches = (SCENE // STRIDE) ** 2 // TILE_BATCH
    k1 = k7 = 0
    with torch.no_grad():
        fp_tiles = model(tiles, train=False)
        fp_scene, fp_scene_ms, _ = timed_scene(model, scene, CLASSES)
        fp_batch_ms = cuda_ms(lambda: model(tiles, train=False), iters=5, warmup=1)
        if name == 'dinoseg':
            program, exp_s, load_s = export_and_load(cfg_path, ckpt, os.path.join(tmp, 'fp.pt2'))
            reset_counts()
            got = program(tiles)
            torch.cuda.synchronize()
            batch_k1 = int8_counts()[0]
            reset_counts()
            prog_scene = tiled_inference(program, scene, TILE, STRIDE, CLASSES,
                                         tile_batch=TILE_BATCH)
            torch.cuda.synchronize()
            scene_k1 = int8_counts()[0]
            k1 += batch_k1 + scene_k1
            prog_ms = cuda_ms(lambda: program(tiles), iters=5, warmup=1)
            print(f'int8: (b) {name}: the exported bf16 program (export {exp_s:.1f} s, load '
                  f'{load_s:.1f} s): tile batch equal to the eager model {torch.equal(got, fp_tiles)}'
                  f' with {batch_k1} K1 launches (expected 24); scene equal '
                  f'{torch.equal(prog_scene, fp_scene)} with {scene_k1} K1 (expected '
                  f'{24 * n_batches}); tile batch {prog_ms:.2f} ms against eager '
                  f'{fp_batch_ms:.2f} ms ({smi})', flush=True)
            check(torch.equal(got, fp_tiles), 'the exported program differs from the eager model')
            check(torch.equal(prog_scene, fp_scene), 'the exported scene differs from eager')
            check(batch_k1 == 24 and scene_k1 == 24 * n_batches,
                  f'the exported program launched K1 {batch_k1}/{scene_k1} times')
            del program

        t0 = time.perf_counter()
        qv = ptq.ptq_quantize(model, model.state_dict(), calib, apply_kwargs=dict(train=False),
                              min_in_features=64)
        quant_s = time.perf_counter() - t0
        predict = ptq.make_ptq_predict_fn(model, qv, train=False)
        serving = predict.serving
        # one W8A8 tile batch: each K7 call's layer (by its int8 weights),
        # its path from the wrapper and from the kernel, and the path its K
        # asks for (TMA needs K a multiple of 16; the operands are fresh, so
        # aligned); and each call's product against the plain version on the
        # same operands, which it must equal (the int32 sum is exact)
        layer_of = {e['kernel_q'].data_ptr(): n for n, e in qv['ptq'].items()}
        calls, paths, unequal = {}, {}, []
        original = Q.int8_matmul_t

        def spy(x_q, xs, w_t, ws):
            want = Q.MM_PATHS[1] if x_q.shape[1] % 16 else Q.MM_PATHS[0]
            key = (Q.int8_matmul_path(x_q, w_t), kernel_mm_path(x_q, w_t), want)
            paths[key] = paths.get(key, 0) + 1
            layer = layer_of[w_t.data_ptr()]
            calls[layer] = calls.get(layer, 0) + 1
            out = original(x_q, xs, w_t, ws)
            plain = Q.int8_matmul_reference(x_q, xs, w_t.t(), ws)
            if not torch.equal(out, plain):
                unequal.append((layer, key[0], tuple(x_q.shape), tuple(w_t.shape),
                                float((out - plain).abs().max())))
            return out

        reset_counts()
        calls0 = serving.int8_calls
        ptq._quant = types.SimpleNamespace(int8_matmul_t=spy)    # what ptq calls K7 through
        try:
            q_tiles = predict(tiles)
            torch.cuda.synchronize()
        finally:
            ptq._quant = Q
        per_forward = serving.int8_calls - calls0
        batch_k1, batch_k7 = int8_counts()
        mma = sum(c for n, c in calls.items() if qv['ptq'][n]['kernel_q'].shape[1] % 16)
        want_paths = {(p, p, p): c for p, c in ((Q.MM_PATHS[0], per_forward - mma),
                                                 (Q.MM_PATHS[1], mma)) if c}
        reset_counts()
        calls0 = serving.int8_calls
        q_scene, q_scene_ms, _ = timed_scene(predict, scene, CLASSES)
        scene_calls = serving.int8_calls - calls0
        scene_k1, scene_k7 = int8_counts()
        k1 += batch_k1 + scene_k1
        k7 += batch_k7 + scene_k7
        q_batch_ms = cuda_ms(lambda: predict(tiles), iters=5, warmup=1)
        cos = centred_cos(q_scene, fp_scene)
        expected_k1 = 24 if name == 'dinoseg' else 0
        print(f'int8: ({"c" if name == "dinoseg" else "d"}) {name}: {len(qv["ptq"])} layers '
              f'quantized in {quant_s:.1f} s (the model implies {n_layers}; '
              f'{len(serving.fp_layers)} left in floating point: {serving.fp_layers}); a W8A8 '
              f'tile batch made {per_forward} int8 layer calls and {batch_k7} K7 launches '
              f'({batch_k1} K1); K7 calls by (wrapper path, kernel path, path its K wants): '
              f'{paths}, expected {want_paths}; each K7 call equal to int8_matmul_reference on '
              f'its operands (limit 0): {sum(calls.values()) - len(unequal)} of '
              f'{sum(calls.values())}, unequal {unequal[:5]}; a W8A8 scene (timed after a '
              f'warm-up one) '
              f'{scene_k7 // 2} K7 and {scene_k1 // 2} K1 launches (expected '
              f'{per_forward * n_batches} and {expected_k1 * n_batches}); centred cosine '
              f'against the bf16 scene {cos:.6f} (limit {INT8_COS_MIN[name]})', flush=True)
        if len(qv['ptq']) != n_layers:
            stats = ptq.calibrate_int8(model, None, calib, apply_kwargs=dict(train=False))
            covered = {n for n, m in model.named_modules()
                       if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}
            print(f'int8: {name}: layers not quantized, with their statistic: '
                  f'{ {n: stats.get(n) for n in sorted(covered - set(qv["ptq"]))} }', flush=True)
        check(len(qv['ptq']) == n_layers, f'{name}: {len(qv["ptq"])} layers quantized, '
              f'expected {n_layers}')
        check(batch_k7 == per_forward and scene_k7 == 2 * per_forward * n_batches
              and scene_calls == 2 * per_forward * n_batches,
              f'{name}: K7 launched {batch_k7}/{scene_k7} for {per_forward} layer calls')
        check(batch_k1 == expected_k1 and scene_k1 == 2 * expected_k1 * n_batches,
              f'{name}: K1 launched {batch_k1}/{scene_k1} on the W8A8 path')
        check(paths == want_paths, f'{name}: K7 paths {paths}, expected {want_paths}')
        check(sum(calls.values()) == per_forward, f'{name}: {sum(calls.values())} K7 calls '
              f'seen for {per_forward} int8 layer calls')
        check(not unequal, f'{name}: {len(unequal)} K7 calls differ from the plain version: '
              f'{unequal[:5]}')
        check(not serving.fp_layers, f'{name}: layers left in floating point')
        check(bool(torch.isfinite(q_scene).all()), f'{name}: non-finite W8A8 scene')
        check(cos > INT8_COS_MIN[name], f'{name}: W8A8 scene cosine {cos:.6f}')

        program, exp_s, load_s = export_and_load(cfg_path, ckpt, os.path.join(tmp, 'int8.pt2'),
                                                 calib)
        reset_counts()
        got = program(tiles)
        torch.cuda.synchronize()
        prog_k1, prog_k7 = int8_counts()
        k1, k7 = k1 + prog_k1, k7 + prog_k7
        prog_ms = cuda_ms(lambda: program(tiles), iters=5, warmup=1)
        print(f'int8: {name}: the exported W8A8 program (export with calibration {exp_s:.1f} s, '
              f'load {load_s:.1f} s): tile batch equal to the eager W8A8 one '
              f'{torch.equal(got, q_tiles)} ({prog_k7} K7, {prog_k1} K1 launches); tile batch '
              f'{prog_ms:.2f} ms', flush=True)
        check(torch.equal(got, q_tiles), f'{name}: the exported W8A8 program differs from eager')
        check(prog_k7 == per_forward and prog_k1 == expected_k1,
              f'{name}: the W8A8 program launched K7 {prog_k7}, K1 {prog_k1} times')
        del program
    print(f'int8: (g) {name}: {smi}: tile batch of {TILE_BATCH} {q_batch_ms:.2f} ms W8A8 against '
          f'{fp_batch_ms:.2f} ms bf16; 4096² scene {q_scene_ms:.1f} ms W8A8 against '
          f'{fp_scene_ms:.1f} ms bf16', flush=True)
    return k1, k7, predict, tiles


def profile_int8_batch(predict, tiles, smi: str) -> None:
    """(g) a ``torch.profiler`` split of one W8A8 tile batch's device time:
    K7, the im2col gather, the activations' quantize and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from ever_tpu_torch.ops import ptq

    labelled = {'ptq_im2col': ptq._im2col, 'ptq_quantize': ptq._quantize_act}

    def wrap(label, fn):
        def run(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return run

    with torch.no_grad():
        predict(tiles)
        torch.cuda.synchronize()
        ptq._im2col = wrap('ptq_im2col', labelled['ptq_im2col'])
        ptq._quantize_act = wrap('ptq_quantize', labelled['ptq_quantize'])
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                predict(tiles)
                torch.cuda.synchronize()
        finally:
            ptq._im2col, ptq._quantize_act = labelled['ptq_im2col'], labelled['ptq_quantize']
    # each kernel goes to the outermost labelled op above the op that
    # launched it (K7 is the op ``ever_tpu_torch::int8_matmul_t``), else to
    # the rest
    labels = {'ever_tpu_torch::int8_matmul_t': 'K7', 'ptq_im2col': 'im2col',
              'ptq_quantize': 'quantize'}
    parts = dict.fromkeys(('K7', 'im2col', 'quantize', 'the rest'), 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        part, up = 'the rest', e
        while up is not None:
            part = labels.get(up.name, part)
            up = up.cpu_parent
        parts[part] += sum(k.duration for k in e.kernels) / 1e3
    total = sum(parts.values())
    print(f'int8: (g) farseg: {smi}: one W8A8 tile batch under the profiler: {total:.3f} ms of '
          f'kernels: ' + ', '.join(f'{k} {v:.3f} ms' for k, v in parts.items()), flush=True)
    check(total > 0 and parts['K7'] > 0, 'the profile shows no device time for K7')


def seeded_flax_init_(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded weights of the model ``tests/test_ptq.py`` holds W8A8 to,
    flax's default initialisation: kernels ~N(0, 1/fan_in) (lecun normal),
    conv biases and BatchNorm shifts 0, BatchNorm scales 1 and running
    statistics 0 and 1.  Random per-channel BatchNorm scales and statistics
    (``seeded_variables`` of the CPU tests) spread the channels' ranges, and
    a per-tensor int8 scale then leaves the small channels a few bins, so
    the W8A8 cosine of FarSeg-R50 moves widely with the seed."""
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if not t.is_floating_point():
                continue
            if t.dim() >= 2:
                t.copy_(t[0].numel() ** -0.5 * torch.randn(t.shape, generator=gen,
                                                           device=t.device))
            elif name.endswith(('weight', 'running_var')):
                t.fill_(1.0)
            else:
                t.zero_()


def check_lr_search(gen, tmp: str, smi: str) -> int:
    """(e) the LR range test: FarSeg-R50 through the ``Launcher`` for
    LR_STEPS steps on in-memory crops under the ``search`` schedule with
    ``PlotLearningRateAndLoss``: one CSV row a step, each LR the schedule's,
    finite losses, one K8 a step.  Returns the K8 launches."""
    import numpy as np
    from ever_tpu_torch.core import builder
    from ever_tpu_torch.core.launcher import Launcher
    from ever_tpu_torch.ops import pool as P
    from ever_tpu_torch.util.lr_search import PlotLearningRateAndLoss

    with torch.device('cuda'):
        model = builder.make_model({'type': 'FarSeg', 'params': FARSEG})
    seeded_conv_init_(model, gen)
    sched = builder.make_learningrate({'type': 'search', 'params': dict(
        init_lr=LR_INIT, final_lr=LR_FINAL, max_iters=LR_STEPS)})
    factory, _ = builder.make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})
    launcher = Launcher(os.path.join(tmp, 'lr'), model, factory.build(sched), sched)
    hook = PlotLearningRateAndLoss(os.path.join(tmp, 'lr', 'lr_search'))
    launcher.logger.register_train_log_hook(hook)
    rng = np.random.default_rng(int(torch.randint(0, 2 ** 31, (1,), generator=gen,
                                                  device='cuda').item()))
    data = [(rng.normal(size=(TILE_BATCH, TILE, TILE, 3)).astype(np.float32),
             rng.integers(0, CLASSES, (TILE_BATCH, TILE, TILE)).astype(np.int64))
            for _ in range(LR_STEPS)]
    P.max_pool_32_bwd.launches = 0
    t0 = time.perf_counter()
    launcher.train_iters(data, num_iters=LR_STEPS, log_interval_step=1,
                         save_ckpt_interval_epoch=10 ** 6)
    secs = time.perf_counter() - t0
    k8 = P.max_pool_32_bwd.launches
    with open(os.path.join(tmp, 'lr', 'lr_search.csv')) as f:
        rows = [line.strip().split(',') for line in f.readlines()[1:]]
    lrs = [float(r[0]) for r in rows]
    losses = [float(r[1]) for r in rows]
    want = [sched.value_at(s) for s in range(LR_STEPS)]
    rel = max(abs(a - b) / b for a, b in zip(lrs, want)) if len(lrs) == LR_STEPS else math.inf
    print(f'int8: (e) LR range test: FarSeg-R50, {LR_STEPS} steps through the Launcher in '
          f'{secs:.1f} s ({smi}); the CSV has {len(rows)} rows, LRs {lrs[0]:.3e} .. '
          f'{lrs[-1]:.3e} within {rel:.1e} of init·mult^step, losses {losses[0]:.4f} .. '
          f'{losses[-1]:.4f}; K8 launches {k8}', flush=True)
    check(len(rows) == LR_STEPS and rel < 1e-6, f'LR CSV rows {len(rows)}, LR error {rel}')
    check(all(math.isfinite(v) for v in losses), f'non-finite losses in the LR range test')
    check(k8 == LR_STEPS, f'the LR range test launched K8 {k8} times')
    return k8


def phase_int8(seed: int, smi: str):
    """int8 W8A8 serving and the exported programs (module docstring, phase
    15), from a generator seeded with ``seed``.  Returns this phase's (K1,
    K7, K8) launches on its main paths."""
    import tempfile
    from ever_tpu_torch.core import builder
    from ever_tpu_torch.magic.tiled import pad_crop_apply
    from ever_tpu_torch.module import PadCropWrapper

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # the phase's own generator: its weights and data do not depend on
    # what the phases before it drew
    gen = torch.Generator(device='cuda').manual_seed(seed)
    check_ops_on_card(gen)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_int8_') as tmp:
        # (b), (c): DinoSeg vitl16_sat493m with phase 3's bf16 parameters,
        # saved and rebuilt through a checkpoint as export_model builds it
        dino = build_dinoseg(gen).to(torch.bfloat16)
        dino_cfg = os.path.join(tmp, 'dinoseg.py')
        with open(dino_cfg, 'w') as f:
            f.write(f'config = dict(model=dict(type="DinoSeg", params=dict(backbone=dict('
                    f'name="vitl16_sat493m"), classes={CLASSES}, dtype="bfloat16")))\n')
        dino_ckpt = os.path.join(tmp, 'dinoseg-1.ckpt')
        torch.save(dino.state_dict(), dino_ckpt)
        del dino
        from ever_tpu_torch.api import infer_tool
        model = infer_tool.build_and_load_from_file(dino_cfg, dino_ckpt)[0]
        # 24 blocks x (qkv, proj, fc1, fc2), the patch embedding, the head
        n_layers = 24 * 4 + 1 + (model.head_hidden is not None) + 1
        k1, k7, _, _ = int8_model('dinoseg', model, dino_cfg, dino_ckpt, tmp, gen, smi,
                                  n_layers)
        del model
        torch.cuda.empty_cache()

        # (d): FarSeg-R50 in phase 5's serving configuration (bf16), with
        # the JAX test's initialisation (seeded_flax_init_)
        with torch.device('cuda'):
            farseg = builder.make_model({'type': 'FarSeg', 'params': FARSEG})
        seeded_flax_init_(farseg, gen)
        farseg.eval()
        fs_cfg = os.path.join(tmp, 'farseg.py')
        with open(fs_cfg, 'w') as f:
            f.write(f'config = dict(model=dict(type="FarSeg", params={FARSEG!r}))\n')
        fs_ckpt = os.path.join(tmp, 'farseg-1.ckpt')
        torch.save(farseg.state_dict(), fs_ckpt)
        # every conv whose kh·kw·Cin/g reaches min_in_features
        convs = sum(1 for m in farseg.modules() if isinstance(m, torch.nn.Conv2d)
                    and m.weight[0].numel() >= 64)
        fk1, fk7, predict, tiles = int8_model('farseg', farseg, fs_cfg, fs_ckpt, tmp, gen, smi,
                                              convs)
        k1, k7 = k1 + fk1, k7 + fk7
        profile_int8_batch(predict, tiles, smi)

        # (f) PadCropWrapper on a 500² batch against a manual pad, run, crop
        x = torch.randn(PADCROP_SHAPE, generator=gen, device='cuda')
        wrapped = PadCropWrapper(farseg, size_divisor=32)
        with torch.no_grad():
            got = wrapped(x)
            pad = 512 - PADCROP_SHAPE[1]
            want = farseg(torch.nn.functional.pad(x, (0, 0, 0, pad, 0, pad)))[:, :500, :500]
            fn = pad_crop_apply(farseg, x, 32)
        same = torch.equal(got, want) and torch.equal(fn, want)
        keys = list(wrapped.state_dict()) == list(farseg.state_dict())
        print(f'int8: (f) PadCropWrapper(FarSeg-R50) on {list(PADCROP_SHAPE)}: output '
              f'{list(got.shape)} equal to a manual pad, run and crop {same}; state_dict keys '
              f'the model\'s {keys}', flush=True)
        check(same and keys, 'PadCropWrapper differs from the manual pad and crop')
        del farseg, wrapped, predict
        torch.cuda.empty_cache()
        k8 = check_lr_search(gen, tmp, smi)
    print(f'int8: {smi}: launches in the phase (K1, K7, K8) {(k1, k7, k8)}; phase wall time '
          f'{time.perf_counter() - t_phase:.1f} s', flush=True)
    return k1, k7, k8


# -- phase 16: HRNetV2 and the segmentation heads -------------------------------

# the four models of the zoo phase: a registered encoder, the features the
# head takes (ListIndex) and a registered head with its defaults
ZOO_RESNET = dict(resnet_type='resnet50', maxpool_impl='pallas')
ZOO_MODELS = {
    'HRNet-W32': dict(encoder=dict(type='HRNetEncoder', params=dict(hrnet_type='hrnetv2_w32')),
                      head=dict(type='HRNetHead', params={}), index=None),
    'DeepLabv3+-R50': dict(encoder=dict(type='ResNetEncoder', params=dict(
        ZOO_RESNET, output_stride=16)), head=dict(type='Deeplabv3pHead', params={}),
        index=(0, 3)),
    'DeepLabv3-R50': dict(encoder=dict(type='ResNetEncoder', params=dict(
        ZOO_RESNET, output_stride=8)), head=dict(type='ASPPHead', params={}), index=(3,)),
    'PSPNet-R50': dict(encoder=dict(type='ResNetEncoder', params=dict(
        ZOO_RESNET, output_stride=8)), head=dict(type='PPMHead', params={}), index=(3,)),
}
# timed steps after 2 warm-up: 10 for HRNet-W32 and DeepLabv3+, 3 for the others
ZOO_TIMED = ('HRNet-W32', 'DeepLabv3+-R50')
ZOO_SHORT_STEPS = 3
ZOO_REPEAT_STEPS = 3
ZOO_TRAINER_ITERS, ZOO_RESUME_AT, ZOO_FROZEN_STAGES = 4, 2, 1
# the loaded HRNet-W32's float32 eval features, card against CPU: both
# float32 (TF32 off) through about 300 convs and BatchNorms whose sums run
# in other orders, about 1e-6 relative each; the limit is the largest
# difference against the largest feature value, a hundred times that.  A
# tensor landing in the wrong module moves the features by O(1).
ZOO_WEIGHT_TOL, ZOO_WEIGHT_SIZE = 1e-4, 256
ZOO_PROFILE_KINDS = (('the port\'s kernels', ('maxpool32',)),
                     ('convolutions', ('fprop', 'dgrad', 'wgrad', 'conv', 'implicit')),
                     ('resizes and pools (matrix products)', ('gemm', 'nvjet', 'cutlass')),
                     ('BatchNorm', ('batch_norm', 'bn_')),
                     ('optimizer', ('multi_tensor_apply',)),
                     ('adds (the fuses and the residuals)', ('add',)))


def register_zoo_model():
    """Register ``ZooSeg`` in the port's MODEL registry: a user's model
    composed from a registered encoder (given the step's generator when it
    draws: drop-connect, drop-path), the features picked by ``ListIndex``,
    an optional ``neck`` of ops applied in order (each from the ``OP``
    registry, or a block of ``ever_tpu_torch.module`` such as
    ``ChannelReduction``), then a registered head, or a 1×1 ``classifier``
    on the first feature (×4 bilinear), or neither (the neck's output is
    the logits); the logits in float32 and a CE loss; the encoder's frozen
    parameters are the model's."""
    from ever_tpu_torch import module as M
    from ever_tpu_torch.core import registry
    from ever_tpu_torch.interface.module import ERModule
    from ever_tpu_torch.module import loss as L
    from ever_tpu_torch.module.fpn import logits_nhwc
    from ever_tpu_torch.module.ops import Conv2d, ListIndex

    def plain(d):
        return d.to_dict() if hasattr(d, 'to_dict') else dict(d)

    def draws(m):
        return 'generator' in inspect.signature(m.forward).parameters

    @registry.MODEL.register('ZooSeg')
    class ZooSeg(ERModule):
        def set_default_config(self):
            self.config.update(dict(encoder={}, neck=[], head={}, classifier=None, index=None,
                                    classes=CLASSES, dtype='float32'))

        def __init__(self, config=None):
            super().__init__(config)
            c = self.config
            self.encoder = registry.MODEL[c.encoder.type](
                dict(c.encoder.params.to_dict(), dtype=c.dtype))
            self.neck = torch.nn.ModuleList(
                (registry.OP.get(plain(n)['type']) or getattr(M, plain(n)['type']))(
                    **plain(plain(n)['params'])) for n in (c.neck or []))
            self.head = registry.MODEL[c.head.type](
                dict(c.head.params.to_dict(), num_classes=c.classes, dtype=c.dtype)
            ) if c.head else None
            self.cls = Conv2d(c.classifier, c.classes, 1, bias=True) if c.classifier else None
            self.select = ListIndex(tuple(c.index)) if c.index else None
            self.draws = [draws(m) for m in [self.encoder, *self.neck]]

        def forward(self, x, y=None, train=False, generator=None):
            feats = (self.encoder(x, train, generator) if self.draws[0]
                     else self.encoder(x, train))
            if self.select is not None:
                feats = self.select(feats)
            for op, gen in zip(self.neck, self.draws[1:]):
                feats = op(feats, train, generator) if gen else op(feats, train)
            if self.head is not None:
                logits = self.head(feats, train, generator).permute(0, 2, 3, 1).float()
            elif self.cls is not None:
                logits = logits_nhwc(self.cls, feats[0])
            else:
                logits = feats.permute(0, 2, 3, 1).float()
            if train and y is not None:
                return dict(cls_loss=L.softmax_ce_loss_with_logits(logits, y, ignore_index=255))
            return torch.softmax(logits, dim=-1)

        def frozen_param_prefixes(self):
            hook = getattr(self.encoder, 'frozen_param_prefixes', None)
            return ['encoder.' + p for p in hook()] if hook else []


def zoo_model(gen, name: str, dtype: str = 'bfloat16', models=None, **encoder):
    """One of ``models`` (``ZOO_MODELS``) on the card with seeded random
    weights."""
    from ever_tpu_torch.core.builder import make_model

    cfg = dict((models or ZOO_MODELS)[name], classes=CLASSES, dtype=dtype)
    cfg['encoder'] = dict(cfg['encoder'], params=dict(cfg['encoder']['params'], **encoder))
    model = make_model({'type': 'ZooSeg', 'params': cfg})
    seeded_conv_init_(model, gen)
    return model


def zoo_sgd(model):
    """SGD with momentum 0.9 and the poly schedule (base_lr 0.01, power 0.9,
    1000 iterations) through ``parallel.spmd``: (state, step)."""
    from ever_tpu_torch.core.builder import make_learningrate, make_optimizer
    from ever_tpu_torch.parallel.spmd import build_train_step, create_train_state

    schedule = make_learningrate({'type': 'poly', 'params': dict(
        base_lr=0.01, power=0.9, max_iters=1000)})
    factory, _ = make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})
    tx = factory.build(schedule)
    return create_train_state(model, tx), build_train_step(model, tx, schedule)


def zoo_timed(name: str, model, batch, smi: str, profile: bool, steps: int,
              phase: str = 'zoo', kinds=None) -> dict:
    """One step under ``FlopCounterMode``, one more warm-up, ``steps`` timed
    by CUDA events: median, least and most ms, FLOPs, K8 launches, losses
    (and with ``profile`` the profiled step's wall and kernel ms, split by
    ``kinds``)."""
    from torch.utils.flop_counter import FlopCounterMode
    from ever_tpu_torch.ops import pool as P

    state, step = zoo_sgd(model)
    P.max_pool_32_bwd.launches = 0
    with FlopCounterMode(display=False) as counter:
        state, _ = step(state, batch)
    for _ in range(WARMUP_STEPS - 1):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses = []
    events[0].record()
    for i in range(steps):
        state, m = step(state, batch)
        events[i + 1].record()
        losses.append(m['cls_loss'])
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    out = dict(ms=times[len(times) // 2], min_ms=times[0], max_ms=times[-1],
               flops=counter.get_total_flops(), k8=P.max_pool_32_bwd.launches,
               losses=[v.item() for v in losses],
               peak=torch.cuda.max_memory_allocated() / 2**30)
    print(f'{phase}: a: {smi}: {name}: train, bf16 compute, float32 params, SGD momentum '
          f'0.9 + poly; {TRAIN_BATCH} tiles of {TILE}²; median {out["ms"]:.2f} ms/step of '
          f'{steps} after {WARMUP_STEPS} (min {out["min_ms"]:.2f}, max '
          f'{out["max_ms"]:.2f}) = {TRAIN_BATCH / out["ms"] * 1e3:.1f} tiles/s; MFU '
          f'{out["flops"] / (out["ms"] / 1e3) / PEAK_BF16_FLOPS:.4f} '
          f'({out["flops"] / 1e12:.3f} TFLOP/step by FlopCounterMode / step time / 989 '
          f'TFLOP/s); peak memory {out["peak"]:.2f} GiB; K8 {out["k8"]} in '
          f'{WARMUP_STEPS + steps} steps; loss per step '
          f'{" ".join(f"{v:.5f}" for v in out["losses"])}', flush=True)
    if profile:
        out['profile'] = profile_run(f'one {name} train step', lambda: step(state, batch),
                                     kinds or ZOO_PROFILE_KINDS)
    del state, step
    return out


def zoo_repeat(model, batch, steps: int, deterministic_cudnn: bool = True, optimizer=None):
    """``steps`` steps of ``optimizer`` (``zoo_sgd`` unless given; a
    ``model -> (state, step)`` function) from the model's current state,
    twice, under deterministic cuDNN (unless asked otherwise): (losses and
    the state after each run, the K8 launches of each run).  The model is
    left as it was."""
    from ever_tpu_torch.ops import pool as P

    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    runs, k8 = [], []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic_cudnn
    try:
        for _ in range(2):
            model.load_state_dict(init)
            state, step = (optimizer or zoo_sgd)(model)
            P.max_pool_32_bwd.launches = 0
            losses = []
            for _ in range(steps):
                state, m = step(state, batch)
                losses.append(m['cls_loss'])
            torch.cuda.synchronize()
            k8.append(P.max_pool_32_bwd.launches)
            runs.append((torch.stack(losses),
                         {k: v.detach().clone() for k, v in model.state_dict().items()}))
            del state, step
    finally:
        torch.backends.cudnn.deterministic = deterministic
    model.load_state_dict(init)
    return runs, k8


def zoo_train_and_serve(gen, name: str, batch, scene, smi: str, profile: bool) -> int:
    """(a) and (b) for one model: the timed steps (10 for ``ZOO_TIMED``,
    else ``ZOO_SHORT_STEPS``), the bit-equal repeats, then the 4096² scene.  Returns the K8 launches of
    its train steps."""
    resnet = name != 'HRNet-W32'
    t0 = time.perf_counter()
    model = zoo_model(gen, name)
    n_params = sum(p.numel() for p in model.parameters())
    print(f'zoo: {name}: {n_params / 1e6:.2f} M parameters, built in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    steps = TIMED_STEPS if name in ZOO_TIMED else ZOO_SHORT_STEPS
    timed = zoo_timed(name, model, batch, smi, profile and name in ZOO_TIMED, steps)
    k8 = timed['k8']
    check(all(math.isfinite(v) for v in timed['losses']), f'a: {name}: non-finite loss')
    check(timed['k8'] == (WARMUP_STEPS + steps) * resnet, f'a: {name}: K8 launches {k8}')
    runs, k8s = zoo_repeat(model, batch, ZOO_REPEAT_STEPS)
    k8 += sum(k8s)
    (loss_a, state_a), (loss_b, state_b) = runs
    equal = torch.equal(loss_a, loss_b) and all(torch.equal(state_a[k], state_b[k])
                                                for k in state_a)
    moved = sum(not torch.equal(v, model.state_dict()[k]) for k, v in state_a.items())
    print(f'zoo: a: {name}: {ZOO_REPEAT_STEPS} steps twice from one seeded state, '
          f'deterministic cuDNN: loss {" ".join(f"{v:.5f}" for v in loss_a.tolist())}; '
          f'losses, parameters and BatchNorm statistics bit-equal {equal}; {moved} of '
          f'{len(state_a)} tensors moved; K8 launches {k8s} (expected '
          f'{ZOO_REPEAT_STEPS * resnet} each)', flush=True)
    check(bool(torch.isfinite(loss_a).all()), f'a: {name}: non-finite loss')
    check(equal, f'a: {name}: two runs of the same steps differ')
    check(all(k == ZOO_REPEAT_STEPS * resnet for k in k8s), f'a: {name}: K8 launches {k8s}')
    del runs, state_a, state_b

    model.eval()
    out, ms, k8_scene = timed_scene(model, scene, CLASSES)
    n_tiles = (SCENE // STRIDE) ** 2
    finite = bool(torch.isfinite(out).all())
    sums = float((out.sum(-1) - 1).abs().max())
    print(f'zoo: b: {smi}: {name}: one {SCENE}² scene, bf16, {TILE}² tiles at stride {STRIDE}, '
          f'tile_batch {TILE_BATCH}: {ms:.1f} ms/scene = {n_tiles / ms * 1e3:.1f} tiles/s; '
          f'probabilities finite {finite}, |sum - 1| <= {sums:.2e}; K8 {k8_scene}', flush=True)
    check(tuple(out.shape) == (SCENE, SCENE, CLASSES) and finite and sums < PROB_SUM_TOL,
          f'b: {name}: bad scene output')
    check(k8_scene == 0, f'b: {name}: serving launched K8 {k8_scene} times')
    del model, out
    torch.cuda.empty_cache()
    return k8


ZOO_CONFIG = '''\
# HRNet-W32 + HRNetHead on seeded in-memory crops (chip_smoke.py zoo phase)
config = dict(
    model=dict(type='ZooSeg', params=dict(
        encoder=dict(type='HRNetEncoder', params=dict(hrnet_type='hrnetv2_w32',
                                                      frozen_stages={frozen})),
        head=dict(type='HRNetHead', params=dict()),
        index=None, classes={classes}, dtype='bfloat16')),
    data=dict(train=dict(type='smoke_scenes', params=dict())),
    learning_rate=dict(type='poly', params=dict(base_lr=0.01, power=0.9, max_iters=1000)),
    optimizer=dict(type='sgd', params=dict(momentum=0.9, weight_decay=1e-4)),
    train=dict(num_iters={iters}, forward_times=1, eval_per_epoch=False,
               eval_after_train=False, log_interval_step=1, save_ckpt_interval_epoch=1,
               distributed=True),
)
'''


def zoo_config_run(gen, seed: int, tmp: str, smi: str) -> None:
    """(c): HRNet-W32 from a config through ``get_trainer('th_ddp')`` and
    the ``Launcher``: 2 steps (a checkpoint at 2), a resume to 4, against 4
    at once; ``frozen_stages=1`` leaves the stem and layer1 alone."""
    from ever_tpu_torch.ops import pool as P

    register_smoke_data()
    cfg_path = os.path.join(tmp, 'zoo_hrnet_w32.py')
    with open(cfg_path, 'w') as f:
        f.write(ZOO_CONFIG.format(frozen=ZOO_FROZEN_STAGES, classes=CLASSES,
                                  iters=ZOO_TRAINER_ITERS))
    init = zoo_model(gen, 'HRNet-W32', frozen_stages=ZOO_FROZEN_STAGES)
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    frozen = tuple(init.frozen_param_prefixes())
    del init
    opts = ('train.eval_after_train', 'False', 'train.log_interval_step', '1')
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True         # a resumed run's bits
    try:
        P.max_pool_32_bwd.launches = 0
        trainer_run(os.path.join(tmp, 'a'), ZOO_RESUME_AT, seed, init_state, opts,
                    config_path=cfg_path)
        lb, rb = trainer_run(os.path.join(tmp, 'a'), ZOO_TRAINER_ITERS, seed, opts=opts,
                             config_path=cfg_path)
        t0 = time.perf_counter()
        lc, rc = trainer_run(os.path.join(tmp, 'c'), ZOO_TRAINER_ITERS, seed, init_state, opts,
                             config_path=cfg_path)
        secs = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    k8 = P.max_pool_32_bwd.launches
    resumed, unbroken = ([(s, d['cls_loss']) for s, d, _, _ in rec['logged']]
                         for rec in (rb, rc))
    equal = all(torch.equal(a, b) for a, b in zip(lb.model.state_dict().values(),
                                                  lc.model.state_dict().values()))
    final = lc.model.state_dict()
    names = [n for n, _ in lc.model.named_parameters()]
    still = [n for n in names if torch.equal(final[n], init_state[n])]
    want_still = [n for n in names if n.startswith(frozen)]
    print(f'zoo: c: HRNet-W32 from a config through get_trainer(\'th_ddp\'): {ZOO_RESUME_AT} '
          f'steps + resume to {ZOO_TRAINER_ITERS}: logged {resumed}; {ZOO_TRAINER_ITERS} '
          f'at once: {unbroken}; final states bit-equal {equal}; frozen_stages '
          f'{ZOO_FROZEN_STAGES}: {len(want_still)} parameters under {list(frozen)}, '
          f'{len(still)} of {len(names)} unchanged after {ZOO_TRAINER_ITERS} steps; K8 {k8}; '
          f'{smi}: the unbroken run {secs:.1f} s with its build', flush=True)
    check(lb.global_step == lc.global_step == ZOO_TRAINER_ITERS, 'c: step counts')
    check([s for s, _ in resumed] == list(range(ZOO_RESUME_AT + 1, ZOO_TRAINER_ITERS + 1)),
          f'c: the resumed run logged steps {[s for s, _ in resumed]}')
    check(resumed == unbroken[ZOO_RESUME_AT:] and all(math.isfinite(v) for _, v in unbroken),
          'c: the resumed losses differ from the unbroken run')
    check(equal, 'c: the resumed run ends in another state than the unbroken run')
    check(bool(want_still) and still == want_still,
          'c: frozen_stages: the frozen parameters moved or others did not')
    check(k8 == 0, f'c: HRNet launched K8 {k8} times')
    del lb, lc, rb, rc, final, init_state
    torch.cuda.empty_cache()


def reference_hrnet_file(path: str, seed: int, width: str = 'hrnetv2_w32') -> dict:
    """A seeded HRNetV2 state_dict in the reference ``_hrnet.py`` layout as
    DDP saves it (``module.`` before every key), with the classification
    neck and ``num_batches_tracked``: conv kernels ~N(0, 2/fan_in),
    BatchNorm weights ~N(1, 0.1²), biases and means ~N(0, 0.1²), variances
    ~U(0.5, 1.5).  Returns the trunk's tensors by key."""
    from ever_tpu_torch.module.hrnet import HRNet

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in HRNet(width).state_dict().items():
        if v.dim() == 4:
            sd[k] = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5
        elif k.endswith('running_var'):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        elif k.endswith('weight'):
            sd[k] = 1.0 + 0.1 * torch.randn(v.shape, generator=g)
        else:
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
    neck = {'incre_modules.0.0.conv1.weight': torch.randn(32, 32, 1, 1, generator=g),
            'final_layer.0.weight': torch.randn(2048, 1024, 1, 1, generator=g),
            'classifier.weight': torch.randn(1000, 2048, generator=g)}
    counters = {k[:-len('running_var')] + 'num_batches_tracked': torch.tensor(5)
                for k in sd if k.endswith('running_var')}
    torch.save({'module.' + k: v for k, v in {**sd, **neck, **counters}.items()}, path)
    return sd


def zoo_weights(seed: int, tmp: str) -> None:
    """(d): the reference file into HRNet-W32 on the card and on the CPU
    through ``load_weights``: no missing or unexpected key, every tensor
    the file's, and the float32 eval features within ``ZOO_WEIGHT_TOL``."""
    from ever_tpu_torch.core.builder import make_model
    from ever_tpu_torch.util.weight_io import load_weights

    path = os.path.join(tmp, 'hrnetv2_w32.pth')
    sd = reference_hrnet_file(path, seed)
    enc = {'type': 'HRNetEncoder', 'params': dict(hrnet_type='hrnetv2_w32')}
    card, host = make_model(enc), make_model(enc, device='cpu')
    reports = [load_weights(path, card), load_weights(path, host, device='cpu')]
    same = all(torch.equal(card.state_dict()['hrnet.' + k].cpu(), v) for k, v in sd.items())
    x = torch.randn(2, ZOO_WEIGHT_SIZE, ZOO_WEIGHT_SIZE, 3,
                    generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        got = card(x.cuda())
        want = host(x)
    errs = [float((a.cpu() - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, want)]
    print(f'zoo: d: a seeded HRNet-W32 file in the reference layout with module. prefixes '
          f'({len(sd)} trunk tensors, the neck and the counters): loaded {reports[0].loaded} '
          f'on the card and {reports[1].loaded} on the CPU; missing {len(reports[0].missing)}, '
          f'unexpected {len(reports[0].unexpected)}, mismatched {len(reports[0].mismatched)}; '
          f'every tensor the file\'s {same}; float32 eval features at {ZOO_WEIGHT_SIZE}², '
          f'card against CPU: max|d| / max|ref| {" ".join(f"{e:.2e}" for e in errs)} '
          f'(limit {ZOO_WEIGHT_TOL})', flush=True)
    for r in reports:
        check(r.loaded == len(sd) and not r.missing and not r.unexpected and not r.mismatched,
              f'd: load_weights: {r.loaded} loaded, {r.missing[:3]} missing, '
              f'{r.unexpected[:3]} unexpected')
    check(same, 'd: a loaded tensor differs from the file')
    check(all(e <= ZOO_WEIGHT_TOL for e in errs), f'd: card and CPU features differ: {errs}')
    del card, host, got, want
    torch.cuda.empty_cache()


def phase_zoo(gen, seed: int, smi: str, profile: bool) -> int:
    """HRNetV2 and the segmentation heads on the card (module docstring,
    phase 16).  Returns the phase's K8 launches."""
    import tempfile

    t_phase = time.perf_counter()
    register_zoo_model()
    torch.cuda.empty_cache()
    x = torch.randn(TRAIN_BATCH, TILE, TILE, 3, generator=gen, device='cuda')
    y = torch.randint(0, CLASSES, (TRAIN_BATCH, TILE, TILE), generator=gen, device='cuda')
    scene = torch.randn(SCENE, SCENE, 3, generator=gen, device='cuda')
    k8 = 0
    for name in ZOO_MODELS:
        k8 += zoo_train_and_serve(gen, name, (x, y), scene, smi, profile)
    del x, y, scene
    with tempfile.TemporaryDirectory(prefix='chip_smoke_zoo_') as tmp:
        zoo_config_run(gen, seed, tmp, smi)
        zoo_weights(seed, tmp)
    print(f'zoo: {smi}: phase {time.perf_counter() - t_phase:.1f} s; K8 launches {k8}',
          flush=True)
    return k8


# -- phase 17: EfficientNet with BiFPN, DenseNet, ResNeSt and ConvNeXt ----------

# the four models of the backbones phase, each a ZooSeg: a registered
# encoder, the features the neck takes (ListIndex), the neck's ops and a
# head or a 1x1 classifier
FPN_DECODER = [dict(type='AssymetricDecoder', params=dict(
    in_channels=256, out_channels=128, classifier_config=dict(num_classes=CLASSES,
                                                              scale_factor=4)))]
BACKBONE_MODELS = {
    # EfficientDet-D0's widths (Tan, Pang and Le, CVPR 2020, Table 1): B0, a
    # BiFPN of width 64 and 3 layers over os4-os32
    'B0-BiFPN': dict(
        encoder=dict(type='EFNetEncoder', params=dict(efficientnet_type='efficientnet-b0')),
        index=(1, 2, 3, 4),
        neck=[dict(type='ChannelReduction', params=dict(in_channels_list=(24, 40, 112, 320),
                                                        out_channels=64))]
        + [dict(type='BiFPN', params=dict(in_channels=64, feature_strides=(4, 8, 16, 32)))] * 3,
        head=None, classifier=64),
    'DenseNet-121': dict(
        encoder=dict(type='DenseNetEncoder', params=dict(densenet_type='densenet121')),
        neck=[dict(type='FPN', params=dict(in_channels_list=(256, 512, 1024, 1024),
                                           out_channels=256))] + FPN_DECODER, head=None),
    'ResNeSt-50-DeepLabv3': dict(
        encoder=dict(type='ResNeStEncoder', params=dict(resnest_type='resnest50',
                                                        output_stride=8)),
        index=(3,), head=dict(type='ASPPHead', params={})),
    'ConvNeXt-T': dict(
        encoder=dict(type='ConvNeXtEncoder', params=dict(convnext_type='convnext_tiny',
                                                         drop_path_rate=0.1)),
        neck=[dict(type='FPN', params=dict(in_channels_list=(96, 192, 384, 768),
                                           out_channels=256))] + FPN_DECODER, head=None),
}
# timed steps after 2 warm-up: 10 for B0-BiFPN and ConvNeXt-T, 3 for the others
BACKBONE_TIMED = ('B0-BiFPN', 'ConvNeXt-T')
BACKBONE_TRAINER_ITERS, BACKBONE_RESUME_AT = 4, 2
# the loaded trunks' float32 eval features, card against CPU: as the zoo
# phase's HRNet (ZOO_WEIGHT_TOL's reasoning), through 16 to 121 layers
BACKBONE_WEIGHT_TOL, BACKBONE_WEIGHT_SIZE = 1e-4, 256
BACKBONE_PROFILE_KINDS = (
    ('the port\'s kernels', PROFILE_KINDS[0][1]),
    # cuDNN's depthwise kernels: one input and one output channel a group
    ('depthwise convolutions', ('c1_k1', 'depthwise', 'Depthwise')),
    ('convolutions', ('fprop', 'dgrad', 'wgrad', 'conv', 'implicit', 'xmma')),
    ('BatchNorm and LayerNorm', ('batch_norm', 'bn_', 'layer_norm', 'LayerNorm',
                                 'GammaBeta')),
    ('SiLU, sigmoid and GELU', ('silu', 'sigmoid', 'gelu', 'Gelu', 'GeLU')),
    ('matrix products (Linears, resizes)', ('gemm', 'nvjet', 'cutlass')),
    ('optimizer', ('multi_tensor_apply',)),
    ('concatenations', ('Cat', 'cat_')),
    ('adds', ('add',)))


def all_launches() -> int:
    """Every kernel wrapper's launches since the last ``reset_counts``."""
    return sum(fn.launches for fn in kernel_wrappers())


def backbone_train_and_serve(gen, name: str, batch, scene, smi: str, profile: bool) -> dict:
    """(a) and (b) for one model: the timed steps, the repeats (first with
    cuDNN as it is, then deterministic if those differ), then the 4096²
    scene; no kernel of the port launched.  Returns the numbers."""
    from torch.utils.flop_counter import FlopCounterMode
    from ever_tpu_torch.ops import pool as P

    reset_counts()
    t0 = time.perf_counter()
    model = zoo_model(gen, name, models=BACKBONE_MODELS)
    n_params = sum(p.numel() for p in model.parameters())
    print(f'backbones: {name}: {n_params / 1e6:.2f} M parameters, built in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    steps = TIMED_STEPS if name in BACKBONE_TIMED else ZOO_SHORT_STEPS
    timed = zoo_timed(name, model, batch, smi, profile and name in BACKBONE_TIMED, steps,
                      'backbones', BACKBONE_PROFILE_KINDS)
    check(all(math.isfinite(v) for v in timed['losses']), f'a: {name}: non-finite loss')
    # FlopCounterMode counts a grouped conv's backward as if ungrouped (a
    # depthwise 3×3's by its channel count over), so the step's count
    # overstates the depthwise nets; three forwards' count does not
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(batch[0])
    timed['flops_3fwd'] = 3 * counter.get_total_flops()
    print(f'backbones: a: {smi}: {name}: 3 × the forward\'s '
          f'{counter.get_total_flops() / 1e12:.3f} TFLOP = {timed["flops_3fwd"] / 1e12:.3f} '
          f'TFLOP a step (the step\'s own count {timed["flops"] / 1e12:.3f}): MFU '
          f'{timed["flops_3fwd"] / (timed["ms"] / 1e3) / PEAK_BF16_FLOPS:.4f}', flush=True)
    if 'profile' in timed:
        # the profiler stretches the step it traces, so the kernels' sum is
        # held against the median step timed without it
        wall, busy = timed['profile']
        print(f'backbones: e: {smi}: {name}: {busy:.2f} ms of kernels in the profiled step '
              f'({wall:.2f} ms wall under the profiler) against the unprofiled median '
              f'{timed["ms"]:.2f} ms: the card busy {busy / timed["ms"]:.1%}', flush=True)
    equal, needed, k8 = False, [], timed['k8']     # the zoo helpers reset K8's count
    for deterministic in (False, True):
        runs, k8s = zoo_repeat(model, batch, ZOO_REPEAT_STEPS, deterministic)
        k8 += sum(k8s)
        (loss_a, state_a), (loss_b, state_b) = runs
        differ = [k for k in state_a if not torch.equal(state_a[k], state_b[k])]
        equal = torch.equal(loss_a, loss_b) and not differ
        moved = sum(not torch.equal(v, model.state_dict()[k]) for k, v in state_a.items())
        print(f'backbones: a: {name}: {ZOO_REPEAT_STEPS} steps twice from one seeded state, '
              f'cudnn.deterministic {deterministic}: loss '
              f'{" ".join(f"{v:.5f}" for v in loss_a.tolist())}; losses, parameters and '
              f'BatchNorm statistics bit-equal {equal}; {moved} of {len(state_a)} tensors '
              f'moved; differing {len(differ)}: {differ[:6]}', flush=True)
        check(bool(torch.isfinite(loss_a).all()), f'a: {name}: non-finite loss')
        if equal:
            break
        needed = differ
    check(equal, f'a: {name}: two runs of the same steps differ under deterministic cuDNN')
    del runs, state_a, state_b
    P.max_pool_32_bwd.launches = 0
    out, ms, _ = timed_scene(model, scene, CLASSES)
    n_tiles = (SCENE // STRIDE) ** 2
    finite = bool(torch.isfinite(out).all())
    sums = float((out.sum(-1) - 1).abs().max())
    launches = k8 + all_launches()
    print(f'backbones: b: {smi}: {name}: one {SCENE}² scene, bf16, {TILE}² tiles at stride '
          f'{STRIDE}, tile_batch {TILE_BATCH}: {ms:.1f} ms/scene = {n_tiles / ms * 1e3:.1f} '
          f'tiles/s; probabilities finite {finite}, |sum - 1| <= {sums:.2e}; the port\'s '
          f'kernels launched {launches} times in (a) and (b)', flush=True)
    check(tuple(out.shape) == (SCENE, SCENE, CLASSES) and finite and sums < PROB_SUM_TOL,
          f'b: {name}: bad scene output')
    check(launches == 0, f'a, b: {name}: the port\'s kernels launched {launches} times')
    del model, out
    torch.cuda.empty_cache()
    return dict(timed, scene_ms=ms, deterministic_needed=needed)


BACKBONE_CONFIG = """\
# EfficientNet-B0 + BiFPN (EfficientDet-D0's widths) on seeded in-memory
# crops (chip_smoke.py backbones phase)
config = dict(
    model=dict(type='ZooSeg', params={model}),
    data=dict(train=dict(type='smoke_scenes', params=dict())),
    learning_rate=dict(type='poly', params=dict(base_lr=0.01, power=0.9, max_iters=1000)),
    optimizer=dict(type='sgd', params=dict(momentum=0.9, weight_decay=1e-4)),
    train=dict(num_iters={iters}, forward_times=1, eval_per_epoch=False,
               eval_after_train=False, log_interval_step=1, save_ckpt_interval_epoch=1,
               distributed=True),
)
"""


def backbone_config_run(gen, seed: int, tmp: str, smi: str) -> None:
    """(c): B0-BiFPN from a config through ``get_trainer('th_ddp')`` and the
    ``Launcher``: 2 steps (a checkpoint at 2), a resume to 4, against 4 at
    once, drop-connect on; no kernel of the port launched."""
    register_smoke_data()
    cfg_path = os.path.join(tmp, 'b0_bifpn.py')
    with open(cfg_path, 'w') as f:
        f.write(BACKBONE_CONFIG.format(
            model=repr(dict(BACKBONE_MODELS['B0-BiFPN'], classes=CLASSES, dtype='bfloat16')),
            iters=BACKBONE_TRAINER_ITERS))
    init = zoo_model(gen, 'B0-BiFPN', models=BACKBONE_MODELS)
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    opts = ('train.eval_after_train', 'False', 'train.log_interval_step', '1')
    launches = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True         # a resumed run's bits
    try:
        trainer_run(os.path.join(tmp, 'a'), BACKBONE_RESUME_AT, seed, init_state, opts,
                    config_path=cfg_path)
        launches.append(all_launches())
        lb, rb = trainer_run(os.path.join(tmp, 'a'), BACKBONE_TRAINER_ITERS, seed, opts=opts,
                             config_path=cfg_path)
        launches.append(all_launches())
        t0 = time.perf_counter()
        lc, rc = trainer_run(os.path.join(tmp, 'c'), BACKBONE_TRAINER_ITERS, seed, init_state,
                             opts, config_path=cfg_path)
        secs = time.perf_counter() - t0
        launches.append(all_launches())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    resumed, unbroken = ([(s, d['cls_loss']) for s, d, _, _ in rec['logged']]
                         for rec in (rb, rc))
    equal = all(torch.equal(a, b) for a, b in zip(lb.model.state_dict().values(),
                                                  lc.model.state_dict().values()))
    rates = [b.drop_connect_rate for b in lc.model.encoder.net._blocks]
    print(f'backbones: c: B0-BiFPN from a config through get_trainer(\'th_ddp\'), drop-connect '
          f'up to {max(rates):.4f}: {BACKBONE_RESUME_AT} steps + resume to '
          f'{BACKBONE_TRAINER_ITERS}: logged {resumed}; {BACKBONE_TRAINER_ITERS} at once: '
          f'{unbroken}; final states bit-equal {equal}; the port\'s kernels launched '
          f'{launches}; {smi}: the unbroken run {secs:.1f} s with its build', flush=True)
    check(lb.global_step == lc.global_step == BACKBONE_TRAINER_ITERS, 'c: step counts')
    check([s for s, _ in resumed] == list(range(BACKBONE_RESUME_AT + 1,
                                                BACKBONE_TRAINER_ITERS + 1)),
          f'c: the resumed run logged steps {[s for s, _ in resumed]}')
    check(resumed == unbroken[BACKBONE_RESUME_AT:] and all(math.isfinite(v)
                                                          for _, v in unbroken),
          'c: the resumed losses differ from the unbroken run')
    check(equal, 'c: the resumed run ends in another state than the unbroken run')
    check(max(rates) > 0, 'c: drop-connect is off')
    check(launches == [0, 0, 0], f'c: the port\'s kernels launched {launches} times')
    del lb, lc, rb, rc, init_state
    torch.cuda.empty_cache()


# family → (the trunk, the encoder's config, its attribute, what a reference
# file adds: the classification head, by key and shape; the file's prefix)
BACKBONE_FILES = {
    'EfficientNet-B0': ('efficientnet-b0', dict(type='EFNetEncoder', params=dict(
        efficientnet_type='efficientnet-b0')), 'net',
        {'_conv_head.weight': (1280, 320, 1, 1), '_bn1.weight': (1280,), '_bn1.bias': (1280,),
         '_bn1.running_mean': (1280,), '_bn1.running_var': (1280,), '_fc.weight': (1000, 1280),
         '_fc.bias': (1000,)}, ''),
    'DenseNet-121': ('densenet121', dict(type='DenseNetEncoder', params=dict(
        densenet_type='densenet121')), 'densenet',
        {'features.norm5.weight': (1024,), 'features.norm5.bias': (1024,),
         'features.norm5.running_mean': (1024,), 'features.norm5.running_var': (1024,),
         'classifier.weight': (1000, 1024), 'classifier.bias': (1000,)}, 'module.'),
    'ResNeSt-50': ('resnest50', dict(type='ResNeStEncoder', params=dict(
        resnest_type='resnest50')), 'net', {'fc.weight': (1000, 2048), 'fc.bias': (1000,)}, ''),
    'ConvNeXt-T': ('convnext_tiny', dict(type='ConvNeXtEncoder', params=dict(
        convnext_type='convnext_tiny')), 'net',
        {'norm.weight': (768,), 'norm.bias': (768,), 'head.weight': (1000, 768),
         'head.bias': (1000,)}, ''),
}


def reference_backbone_file(path: str, name: str, seed: int) -> dict:
    """A seeded state_dict of ``BACKBONE_FILES[name]`` in its reference
    package's layout (the trunk's keys, ``num_batches_tracked`` after each
    BatchNorm, the classification head), saved with its prefix: weights
    drawn as ``reference_hrnet_file`` draws them (layer scales and the rest
    of the 1-D tensors ~N(0, 0.1²) but norm weights ~N(1, 0.1²)).  Returns
    the trunk's tensors by key."""
    from ever_tpu_torch.core import registry

    trunk, _, _, head, prefix = BACKBONE_FILES[name]
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in registry.MODEL[trunk]().state_dict().items():
        if v.dim() >= 2:
            sd[k] = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5
        elif k.endswith('running_var'):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        elif k.endswith('weight'):
            sd[k] = 1.0 + 0.1 * torch.randn(v.shape, generator=g)
        else:
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
    extra = {k: torch.randn(shape, generator=g) for k, shape in head.items()}
    counters = {k[:-len('running_var')] + 'num_batches_tracked': torch.tensor(5)
                for k in list(sd) + list(extra) if k.endswith('running_var')}
    torch.save({prefix + k: v for k, v in {**sd, **extra, **counters}.items()}, path)
    return sd


def backbone_weights(seed: int, tmp: str) -> None:
    """(d): a reference file of each family through ``load_weights`` into
    its encoder on the card and on the CPU: no missing, unexpected or
    mismatched key, every tensor the file's, and the float32 eval features
    within ``BACKBONE_WEIGHT_TOL`` of the CPU's."""
    from ever_tpu_torch.core.builder import make_model
    from ever_tpu_torch.util.weight_io import load_weights

    x = torch.randn(2, BACKBONE_WEIGHT_SIZE, BACKBONE_WEIGHT_SIZE, 3,
                    generator=torch.Generator().manual_seed(seed))
    for i, (name, (_, enc, attr, head, prefix)) in enumerate(BACKBONE_FILES.items()):
        path = os.path.join(tmp, f'{name}.pth')
        sd = reference_backbone_file(path, name, seed + i)
        card, host = make_model(enc), make_model(enc, device='cpu')
        reports = [load_weights(path, card), load_weights(path, host, device='cpu')]
        same = all(torch.equal(card.state_dict()[f'{attr}.{k}'].cpu(), v) for k, v in sd.items())
        with torch.no_grad():
            got = card(x.cuda())
            want = host(x)
        errs = [float((a.cpu() - b).abs().max()) / float(b.abs().max())
                for a, b in zip(got, want)]
        print(f'backbones: d: a seeded {name} file in its reference layout'
              f'{" with module. prefixes" if prefix else ""} ({len(sd)} trunk tensors, '
              f'{len(head)} of the head and the counters): loaded {reports[0].loaded} on the '
              f'card and {reports[1].loaded} on the CPU; missing {len(reports[0].missing)}, '
              f'unexpected {len(reports[0].unexpected)}, mismatched '
              f'{len(reports[0].mismatched)}; every tensor the file\'s {same}; float32 eval '
              f'features at {BACKBONE_WEIGHT_SIZE}², card against CPU: max|d| / max|ref| '
              f'{" ".join(f"{e:.2e}" for e in errs)} (limit {BACKBONE_WEIGHT_TOL})', flush=True)
        for r in reports:
            check(r.loaded == len(sd) and not r.missing and not r.unexpected
                  and not r.mismatched, f'd: {name}: load_weights: {r.loaded} loaded, '
                  f'{r.missing[:3]} missing, {r.unexpected[:3]} unexpected')
        check(same, f'd: {name}: a loaded tensor differs from the file')
        check(all(e <= BACKBONE_WEIGHT_TOL for e in errs),
              f'd: {name}: card and CPU features differ: {errs}')
        del card, host, got, want
        torch.cuda.empty_cache()


def phase_backbones(gen, seed: int, smi: str, profile: bool) -> None:
    """EfficientNet with BiFPN, DenseNet, ResNeSt and ConvNeXt on the card
    (module docstring, phase 17)."""
    import tempfile

    t_phase = time.perf_counter()
    register_zoo_model()
    torch.cuda.empty_cache()
    x = torch.randn(TRAIN_BATCH, TILE, TILE, 3, generator=gen, device='cuda')
    y = torch.randint(0, CLASSES, (TRAIN_BATCH, TILE, TILE), generator=gen, device='cuda')
    scene = torch.randn(SCENE, SCENE, 3, generator=gen, device='cuda')
    results = {name: backbone_train_and_serve(gen, name, (x, y), scene, smi, profile)
               for name in BACKBONE_MODELS}
    del x, y, scene
    with tempfile.TemporaryDirectory(prefix='chip_smoke_backbones_') as tmp:
        backbone_config_run(gen, seed, tmp, smi)
        backbone_weights(seed, tmp)
    for name, r in results.items():
        print(f'backbones: e: {smi}: {name}: {r["ms"]:.2f} ms/step (median of '
              f'{len(r["losses"])}, {r["min_ms"]:.2f}-{r["max_ms"]:.2f}), '
              f'{TRAIN_BATCH / r["ms"] * 1e3:.1f} tiles/s, MFU '
              f'{r["flops_3fwd"] / (r["ms"] / 1e3) / PEAK_BF16_FLOPS:.4f} (3 forwards\' '
              f'{r["flops_3fwd"] / 1e12:.3f} TFLOP; the step\'s count '
              f'{r["flops"] / (r["ms"] / 1e3) / PEAK_BF16_FLOPS:.4f}), peak {r["peak"]:.2f} GiB; '
              f'{r["scene_ms"]:.1f} ms a {SCENE}² scene = '
              f'{(SCENE // STRIDE) ** 2 / r["scene_ms"] * 1e3:.1f} tiles/s; repeats needed '
              f'deterministic cuDNN for {r["deterministic_needed"][:6] or "none"}', flush=True)
    print(f'backbones: {smi}: phase {time.perf_counter() - t_phase:.1f} s; the port\'s kernels '
          f'launched 0 times', flush=True)


# ViTEncoder (vit_large, patch 16, 4 storage tokens) under the FPN neck and
# the AssymetricDecoder of FPN_DECODER, composed as a user's ZooSeg
VITENC_MODEL = dict(
    encoder=dict(type='ViTEncoder', params=dict(vit_type='vit_large', patch_size=16,
                                                n_storage_tokens=4)),
    neck=[dict(type='FPN', params=dict(in_channels_list=(EMBED,) * 4, out_channels=256))]
    + FPN_DECODER, head=None)
# (rows, in, out, K-masked bias): ViT-L/16's fc1 and qkv over 8 tiles of
# 512² (8 · 1029 tokens) and its fc2
FP8_CASES = ((TRAIN_BATCH * S, EMBED, 4 * EMBED, False),
             (TRAIN_BATCH * S, EMBED, 3 * EMBED, True),
             (TRAIN_BATCH * S, 4 * EMBED, EMBED, False))
VITENC_REPEAT_STEPS = 2


def vitenc_model(gen, dtype: str = 'bfloat16'):
    """The ``VITENC_MODEL`` ZooSeg on the card, seeded: the trunk as
    ``seeded_init_`` draws DinoSeg's, the neck and decoder as
    ``seeded_conv_init_`` draws a conv net's."""
    from ever_tpu_torch.core.builder import make_model

    with torch.device('cuda'):
        model = make_model({'type': 'ZooSeg', 'params': dict(VITENC_MODEL, classes=CLASSES,
                                                             dtype=dtype)})
    seeded_init_(model.encoder, gen)
    seeded_conv_init_(model.neck, gen)
    return model


def set_attn_impl(model, impl) -> None:
    from ever_tpu_torch.module.vit import SelfAttention

    for m in model.modules():
        if isinstance(m, SelfAttention):
            m.attn_impl = impl


def check_fp8_and_w24(gen, smi: str) -> int:
    """(e)-(g) at ViT-L's widths: ``Fp8Linear`` and ``Fp8LinearKMaskedBias``
    (one K7 launch a call, equal to the bit to the layer's plain version:
    ``scale`` and ``int8_matmul_reference`` plus the bias), timed against
    the bf16 ``nn.Linear``; their straight-through backward; ``LinearW24``
    with exactly the two largest |w| of every four kept.  Returns the K7
    launches of the layers' calls."""
    from ever_tpu_torch.module.dinov3.layers import fp8_linear as FP8
    from ever_tpu_torch.module.dinov3.layers import sparse_linear as SP
    from ever_tpu_torch.ops import quant as Q

    k7 = 0
    for rows, k, n, masked in FP8_CASES:
        name = f'{"Fp8LinearKMaskedBias" if masked else "Fp8Linear"} [{rows}, {k}] -> {n}'
        with torch.device('cuda'):
            layer = FP8.Fp8LinearKMaskedBias(k, n) if masked else FP8.Fp8Linear(k, n)
            dense = torch.nn.Linear(k, n, dtype=torch.bfloat16)
            w24 = SP.LinearW24(k, n)
        with torch.no_grad():
            for m in (layer, dense, w24):
                m.weight.copy_(0.04 * torch.randn(n, k, generator=gen, device='cuda'))
                m.bias.copy_(0.02 * torch.randn(n, generator=gen, device='cuda'))
        x = torch.randn(rows, k, generator=gen, device='cuda')
        reset_counts()
        with torch.no_grad():
            y = layer(x)
        torch.cuda.synchronize()
        launches = (Q.int8_matmul_t.launches, all_launches())
        k7 += launches[0]
        with torch.no_grad():
            x_q, x_s = FP8.scale(x, x.abs().amax())
            w_q, w_s = FP8.scale(layer.weight, layer.weight.abs().amax())
            plain = Q.int8_matmul_reference(x_q, x_s.reshape(1, 1), w_q.t(), w_s.reshape(1, 1))
            plain = plain + layer._bias()
            err = float((y - plain).abs().max())
            path = Q.int8_matmul_path(x_q, w_q)
            xb = x.to(torch.bfloat16)
            ms = cuda_ms(lambda: layer(x), iters=20)
            bf16_ms = cuda_ms(lambda: dense(xb), iters=20)
            w24_ms = cuda_ms(lambda: w24(xb), iters=20)
            kept = SP.sparsify24(w24.weight)
            groups = (kept.reshape(-1, 4) != 0).sum(1)
            top2 = w24.weight.abs().reshape(-1, 4).topk(2, dim=1).indices
            want_mask = torch.zeros(groups.shape[0], 4, dtype=torch.bool, device='cuda')
            want_mask.scatter_(1, top2, True)
            w24_err = float((w24(xb).float() - torch.nn.functional.linear(
                xb, kept.to(torch.bfloat16), w24.bias.to(torch.bfloat16)).float()).abs().max())
        xg = x.clone().requires_grad_()
        out = layer(xg)
        out.backward(torch.randn(out.shape, generator=gen, device='cuda'))
        finite = all(bool(torch.isfinite(t).all()) for t in (xg.grad, layer.weight.grad,
                                                            layer.bias.grad))
        flops = 2.0 * rows * k * n
        print(f'vitencoder: e: {smi}: {name}: K7 launches {launches[0]} (every kernel '
              f'{launches[1]}), path {path}; max|y - plain| {err:.3e} (limit 0); '
              f'{ms:.4f} ms a call ({flops / ms / 1e9:.1f} TFLOP/s of the product, quantize '
              f'and rescale included) against the bf16 nn.Linear {bf16_ms:.4f} ms; '
              f'straight-through gradients finite {finite}, shapes '
              f'{tuple(xg.grad.shape)} {tuple(layer.weight.grad.shape)}', flush=True)
        print(f'vitencoder: g: {smi}: LinearW24 [{rows}, {k}] -> {n}: kept a group '
              f'{int(groups.min())}-{int(groups.max())} of 4, the two largest |w| '
              f'{bool(torch.equal(kept.reshape(-1, 4) != 0, want_mask))}; max|y - masked '
              f'dense| {w24_err:.3e}; {w24_ms:.4f} ms a call (bf16; the dense Linear '
              f'{bf16_ms:.4f})', flush=True)
        check(launches == (1, 1), f'e: {name}: launches {launches}, expected one K7')
        check(err == 0.0, f'e: {name}: the layer differs from its plain version')
        check(finite, f'f: {name}: non-finite straight-through gradients')
        check(bool((groups == 2).all()) and torch.equal(kept.reshape(-1, 4) != 0, want_mask),
              f'g: LinearW24 [{k}, {n}]: not the two largest of every four')
        check(w24_err == 0.0, f'g: LinearW24 [{k}, {n}]: not the masked dense product')
        del layer, dense, w24, x, xg, out, plain
        torch.cuda.empty_cache()
    return k7


def vitenc_grads(model, x, y, dtype: str, plain_only: bool = False) -> tuple:
    """The gradients of 2 tiles (one train forward and backward, the same
    draws) through the kernels against plain attention, both at the
    compute ``dtype`` (or, ``plain_only``, plain attention at bf16 against
    plain attention at ``dtype``): (||dg|| / ||g||, the worst per-tensor
    cosine, the three worst tensors, the kernel pass's K1 and K2
    launches)."""
    from ever_tpu_torch.ops import attention as A

    def grads(impl, compute):
        set_attn_impl(model, impl)
        model.config.dtype = model.encoder.config.dtype = compute
        reset_counts()
        out = loss_and_grads(model, x[:2], y[:2], seed=5)[1]
        set_attn_impl(model, None)
        model.config.dtype = model.encoder.config.dtype = 'bfloat16'
        return out, (A.fused_attention.launches, A.fused_attention_bwd.launches)

    got, launches = grads('xla' if plain_only else None, 'bfloat16')
    want, _ = grads('xla', dtype)
    rel, worst, cos = compare_grads(got, want)
    names = [n for n, _ in model.named_parameters()]
    worst3 = ', '.join(f'{n} {c:.6f}' for c, n in sorted(zip(cos, names))[:3])
    return rel, worst, worst3, launches


def phase_vitencoder(gen, smi: str, profile: bool) -> tuple:
    """ViTEncoder under an FPN head, and the DINOv3 layers on K7 (module
    docstring, phase 18): returns the K1, K2 and K7 launches of its paths."""
    from torch.utils.flop_counter import FlopCounterMode
    from ever_tpu_torch import tiled_inference
    from ever_tpu_torch.module.ops import BatchNorm2d
    from ever_tpu_torch.ops import attention as A

    t_phase = time.perf_counter()
    register_zoo_model()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = vitenc_model(gen)
    print(f'vitencoder: ViTEncoder vit_large/16 + FPN + AssymetricDecoder, '
          f'{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters, built in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    x = torch.randn(TRAIN_BATCH, TILE, TILE, 3, generator=gen, device='cuda')
    y = torch.randint(0, CLASSES, (TRAIN_BATCH, TILE, TILE), generator=gen, device='cuda')
    # FLOPs: three times the forward's count, with plain attention (the
    # kernels are ops FlopCounterMode does not count)
    set_attn_impl(model, 'xla')
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x)
    set_attn_impl(model, None)
    flops = 3 * counter.get_total_flops()

    # (a) the train steps
    state, step = adamw_step(model)
    for _ in range(WARMUP_STEPS):
        state, _ = step(state, (x, y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    losses = []
    events[0].record()
    for i in range(TIMED_STEPS):
        state, m = step(state, (x, y))
        events[i + 1].record()
        losses.append(m['cls_loss'])
    torch.cuda.synchronize()
    k1, k2 = A.fused_attention.launches, A.fused_attention_bwd.launches
    others = all_launches() - k1 - k2
    times = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    med = times[len(times) // 2]
    losses = [v.item() for v in losses]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f'vitencoder: a: {smi}: train, bf16 compute, float32 params, AdamW + cosine; '
          f'{TRAIN_BATCH} tiles of {TILE}²; median {med:.2f} ms/step of {TIMED_STEPS} after '
          f'{WARMUP_STEPS} (min {times[0]:.2f}, max {times[-1]:.2f}) = '
          f'{TRAIN_BATCH / med * 1e3:.1f} tiles/s; MFU {flops / (med / 1e3) / PEAK_BF16_FLOPS:.4f} '
          f'(3 × the forward\'s {flops / 3e12:.3f} TFLOP = {flops / 1e12:.3f} TFLOP a step / '
          f'step time / 989 TFLOP/s); peak memory {peak:.2f} GiB; launches in {TIMED_STEPS} '
          f'steps: K1 {k1}, K2 {k2} (expected {24 * TIMED_STEPS} each), other kernels '
          f'{others}; loss per step {" ".join(f"{v:.5f}" for v in losses)}', flush=True)
    check((k1, k2, others) == (24 * TIMED_STEPS, 24 * TIMED_STEPS, 0),
          f'a: train steps launched K1 {k1}, K2 {k2}, others {others}')
    check(all(math.isfinite(v) for v in losses), 'a: non-finite loss')
    check(all(p.dtype == torch.float32 for p in model.parameters()), 'a: parameters left float32')
    if profile:
        profile_run('one ViTEncoder + FPN train step', lambda: step(state, (x, y)))
    del state, step
    torch.cuda.empty_cache()

    # (b) gradients of 2 tiles: kernels against plain attention, same draws.
    # The decoder's train-mode BatchNorms amplify any bf16 rounding of what
    # they normalise: plain attention in bf16 against plain attention in
    # float32 stands as far apart as the kernels against plain attention
    # (both printed).  The gate holds the kernels with those BatchNorms
    # frozen to their statistics, where phase 4's limits measure them.
    rel, worst, names, launches = vitenc_grads(model, x, y, 'bfloat16')
    floor = vitenc_grads(model, x, y, 'float32', plain_only=True)[0]
    print(f'vitencoder: b: gradients of 2 tiles with the BatchNorms training, kernels vs plain '
          f'attention: ||dg||/||g|| {rel:.3e}, worst per-tensor cosine {worst:.6f} '
          f'({names}); plain attention in bf16 vs in float32: {floor:.3e}; K1, K2 launches '
          f'{launches}', flush=True)
    for bn in model.modules():
        if isinstance(bn, BatchNorm2d):
            bn.frozen = True
    rel, worst, names, launches = vitenc_grads(model, x, y, 'bfloat16')
    for bn in model.modules():
        if isinstance(bn, BatchNorm2d):
            bn.frozen = False
    print(f'vitencoder: b: the same with the BatchNorms frozen: ||dg||/||g|| {rel:.3e}, worst '
          f'per-tensor cosine {worst:.6f} ({names}) (limits {GRAD_REL_TOL}, {GRAD_COS_MIN}); '
          f'K1, K2 launches {launches}', flush=True)
    check(launches == (24, 24), f'b: the kernel pass launched {launches}')
    check(rel <= GRAD_REL_TOL and worst >= GRAD_COS_MIN,
          'b: kernel gradients disagree with plain attention gradients')

    # (c) two runs of the same steps from one state
    runs, _ = zoo_repeat(model, (x, y), VITENC_REPEAT_STEPS, False, adamw_step)
    (loss_a, state_a), (loss_b, state_b) = runs
    differ = [k for k in state_a if not torch.equal(state_a[k], state_b[k])]
    equal = torch.equal(loss_a, loss_b) and not differ
    print(f'vitencoder: c: {VITENC_REPEAT_STEPS} AdamW steps twice from one seeded state, '
          f'cuDNN as it is: loss {" ".join(f"{v:.5f}" for v in loss_a.tolist())}; losses and '
          f'parameters bit-equal {equal}; differing {len(differ)}: {differ[:6]}', flush=True)
    check(equal, 'c: two runs of the same steps differ')
    del runs, state_a, state_b
    torch.cuda.empty_cache()

    # (d) one scene
    model.eval()
    scene = torch.randn(SCENE, SCENE, 3, generator=gen, device='cuda')
    with torch.no_grad():
        tiled_inference(model, scene, TILE, STRIDE, CLASSES, tile_batch=TILE_BATCH)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = tiled_inference(model, scene, TILE, STRIDE, CLASSES, tile_batch=TILE_BATCH)
        torch.cuda.synchronize()
    scene_ms = (time.perf_counter() - t0) * 1e3
    scene_k1, scene_all = A.fused_attention.launches, all_launches()
    n_tiles = (SCENE // STRIDE) ** 2
    sums = float((out.sum(-1) - 1).abs().max())
    print(f'vitencoder: d: {smi}: one {SCENE}² scene, bf16, {TILE}² tiles at stride {STRIDE}, '
          f'tile_batch {TILE_BATCH}: {scene_ms:.1f} ms/scene = {n_tiles / scene_ms * 1e3:.1f} '
          f'tiles/s; K1 launches {scene_k1} (expected {24 * n_tiles // TILE_BATCH}), every '
          f'kernel {scene_all}; |sum - 1| <= {sums:.2e}', flush=True)
    check(scene_k1 == scene_all == 24 * n_tiles // TILE_BATCH, f'd: the scene launched K1 '
          f'{scene_k1} times, every kernel {scene_all}')
    check(tuple(out.shape) == (SCENE, SCENE, CLASSES) and bool(torch.isfinite(out).all())
          and sums < PROB_SUM_TOL, 'd: bad scene output')
    del model, out, scene
    torch.cuda.empty_cache()

    k7 = check_fp8_and_w24(gen, smi)
    print(f'vitencoder: {smi}: phase {time.perf_counter() - t_phase:.1f} s', flush=True)
    return k1 + scene_k1, k2, k7


# FreeNet's scenes: (name, H, W, bands, classes), the FreeNet/FPGA paper's
# benchmarks (Zheng et al., IEEE TGRS 2020)
FREENET_SCENES = (('Indian Pines', 145, 145, 200, 16), ('Pavia University', 610, 340, 103, 9))
FREENET_LABELLED = 0.05
FREENET_REPEAT_STEPS = 2
# the loaded FreeNet's float32 eval probabilities, card against CPU: float32
# (TF32 off) through 14 convs, GroupNorms and gates whose sums run in other
# orders; probabilities lie in [0, 1], the limit is absolute.  A tensor in
# the wrong module moves them by O(0.1).
FREENET_WEIGHT_TOL = 1e-4


def freenet_scene(gen, h: int, w: int, bands: int, classes: int):
    """A seeded scene [1, H, W, bands] and labels with FREENET_LABELLED of
    the pixels in [0, classes), the rest 255, on the card."""
    x = torch.randn(1, h, w, bands, generator=gen, device='cuda')
    labels = torch.randint(0, classes, (1, h, w), generator=gen, device='cuda')
    keep = torch.rand(1, h, w, generator=gen, device='cuda') < FREENET_LABELLED
    return x, torch.where(keep, labels, torch.full_like(labels, 255))


# the port's FreeNet names → the JAX package's (the inverse of
# weight_io's rules), for the seeded archive
FREENET_JAX_NAMES = (
    (r'(enc\d+)\.(conv\d)\.0\.weight', r'\1/\2/Conv_0/kernel'),
    (r'(enc\d+)\.(conv\d)\.1\.weight', r'\1/\2/Norm_0/GroupNorm_0/scale'),
    (r'(enc\d+)\.(conv\d)\.1\.bias', r'\1/\2/Norm_0/GroupNorm_0/bias'),
    (r'(enc\d+)\.spec_attn\.(reduce|expand)\.weight', r'\1/spec_attn/\2/kernel'),
    (r'(enc\d+)\.spec_attn\.(reduce|expand)\.bias', r'\1/spec_attn/\2/bias'),
    (r'(lat\d+|fuse\d+)\.0\.weight', r'\1/Conv_0/kernel'),
    (r'(lat\d+|fuse\d+)\.1\.weight', r'\1/Norm_0/GroupNorm_0/scale'),
    (r'(lat\d+|fuse\d+)\.1\.bias', r'\1/Norm_0/GroupNorm_0/bias'),
    (r'classifier\.(weight|bias)', None),
)


def freenet_npz(path: str, model, seed: int) -> dict:
    """A seeded archive of a FreeNet's variables in the JAX package's flat
    layout (``params/enc0/conv1/Conv_0/kernel`` HWIO, GroupNorm
    ``scale``/``bias``), as its ``.npz`` files hold them: kernels ~N(0,
    2/fan_in), GroupNorm scales ~N(1, 0.1²), the rest ~N(0, 0.1²).  Returns
    the drawn tensors by the port's names."""
    import re

    import numpy as np

    g = torch.Generator().manual_seed(seed)
    flat, drawn = {}, {}
    for k, v in model.state_dict().items():
        if v.dim() >= 2:
            t = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5
        elif k.endswith('weight'):
            t = 1.0 + 0.1 * torch.randn(v.shape, generator=g)
        else:
            t = 0.1 * torch.randn(v.shape, generator=g)
        drawn[k] = t
        for pattern, template in FREENET_JAX_NAMES:
            m = re.fullmatch(pattern, k)
            if m:
                leaf = ('classifier/kernel' if k.endswith('weight') else 'classifier/bias'
                        ) if template is None else m.expand(template)
                break
        a = t.numpy()
        flat['params/' + leaf] = np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a
    np.savez(path, **flat)
    return drawn


def phase_freenet(gen, seed: int, smi: str) -> None:
    """FreeNet on two hyperspectral scenes and its loaded weights (module
    docstring, phase 19); it launches no kernel of the port."""
    import tempfile

    from torch.utils.flop_counter import FlopCounterMode
    from ever_tpu_torch.core.builder import make_model
    from ever_tpu_torch.util.weight_io import load_weights

    t_phase = time.perf_counter()
    for name, h, w, bands, classes in FREENET_SCENES:
        model = make_model({'type': 'FreeNet', 'params': dict(in_channels=bands,
                                                              classes=classes)})
        seeded_conv_init_(model, gen)
        x, y = freenet_scene(gen, h, w, bands, classes)
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(x)
        flops = 3 * counter.get_total_flops()
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        reset_counts()
        state, step = zoo_sgd(model)
        for _ in range(WARMUP_STEPS):
            state, _ = step(state, (x, y))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
        losses = []
        events[0].record()
        for i in range(TIMED_STEPS):
            state, m = step(state, (x, y))
            events[i + 1].record()
            losses.append(m['cls_loss'])
        torch.cuda.synchronize()
        times = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
        med = times[len(times) // 2]
        losses = [v.item() for v in losses]
        moved = sum(not torch.equal(v, init[k]) for k, v in model.state_dict().items())
        peak = torch.cuda.max_memory_allocated() / 2**30
        del state, step
        runs = []
        for deterministic in (False, True):
            runs, _ = zoo_repeat(model, (x, y), FREENET_REPEAT_STEPS, deterministic)
            (loss_a, state_a), (loss_b, state_b) = runs
            differ = [k for k in state_a if not torch.equal(state_a[k], state_b[k])]
            equal = torch.equal(loss_a, loss_b) and not differ
            print(f'freenet: {name}: {FREENET_REPEAT_STEPS} steps twice from one state, '
                  f'cudnn.deterministic {deterministic}: bit-equal {equal}; differing '
                  f'{len(differ)}: {differ[:6]}', flush=True)
            if equal:
                break
        del runs, state_a, state_b
        model.eval()
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: model(x), iters=5)
            probs = model(x)
        launches = all_launches()
        sums = float((probs.sum(-1) - 1).abs().max())
        print(f'freenet: {smi}: {name} ({h}×{w}, {bands} bands, {classes} classes, '
              f'{int((y != 255).sum())} labelled pixels), float32, SGD momentum 0.9 + poly, '
              f'batch 1 whole scene: median {med:.2f} ms/step of {TIMED_STEPS} after '
              f'{WARMUP_STEPS} (min {times[0]:.2f}, max {times[-1]:.2f}) = '
              f'{1e3 / med:.2f} scenes/s; MFU {flops / (med / 1e3) / PEAK_F32_FLOPS:.4f} of '
              f'the float32 peak (3 × the forward\'s {flops / 3e9:.2f} GFLOP / step time / '
              f'67 TFLOP/s; TF32 off); peak memory {peak:.2f} GiB; loss per step '
              f'{" ".join(f"{v:.5f}" for v in losses)}; {moved} of {len(init)} tensors moved; '
              f'the whole-scene forward {fwd_ms:.2f} ms = {1e3 / fwd_ms:.1f} scenes/s, '
              f'|sum - 1| <= {sums:.2e}; the port\'s kernels launched {launches} times', flush=True)
        check(all(math.isfinite(v) for v in losses), f'{name}: non-finite loss')
        check(moved == len(init), f'{name}: {moved} of {len(init)} parameters moved')
        check(equal, f'{name}: two runs of the same steps differ under deterministic cuDNN')
        check(tuple(probs.shape) == (1, h, w, classes) and bool(torch.isfinite(probs).all())
              and sums < PROB_SUM_TOL, f'{name}: bad probabilities')
        check(launches == 0, f'{name}: the port\'s kernels launched {launches} times')
        del model, x, y, probs
        torch.cuda.empty_cache()

    # a FreeNet from a seeded archive in the JAX package's layout, on the
    # card and on the CPU
    name, h, w, bands, classes = FREENET_SCENES[0]
    spec = {'type': 'FreeNet', 'params': dict(in_channels=bands, classes=classes)}
    card, host = make_model(spec), make_model(spec, device='cpu')
    with tempfile.TemporaryDirectory(prefix='chip_smoke_freenet_') as tmp:
        path = os.path.join(tmp, 'freenet.npz')
        drawn = freenet_npz(path, host, seed)
        reports = [load_weights(path, card), load_weights(path, host, device='cpu')]
    same = all(torch.equal(card.state_dict()[k].cpu(), v) for k, v in drawn.items())
    x = torch.randn(1, h, w, bands, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        err = float((card(x.cuda()).cpu() - host(x)).abs().max())
    print(f'freenet: a seeded {name} FreeNet in the JAX package\'s .npz layout '
          f'({len(drawn)} tensors) through load_weights (convert_flax_freenet): loaded '
          f'{reports[0].loaded} on the card and {reports[1].loaded} on the CPU; missing '
          f'{len(reports[0].missing)}, unexpected {len(reports[0].unexpected)}; every tensor '
          f'the archive\'s {same}; float32 eval probabilities, card against CPU: max|d| '
          f'{err:.3e} (limit {FREENET_WEIGHT_TOL})', flush=True)
    for r in reports:
        check(r.loaded == len(drawn) and not r.missing and not r.unexpected
              and not r.mismatched, f'freenet: load_weights: {r.loaded} loaded, '
              f'{r.missing[:3]} missing, {r.unexpected[:3]} unexpected')
    check(same, 'freenet: a loaded tensor differs from the archive')
    check(err <= FREENET_WEIGHT_TOL, f'freenet: card and CPU probabilities differ by {err}')
    print(f'freenet: {smi}: phase {time.perf_counter() - t_phase:.1f} s; the port\'s kernels '
          f'launched 0 times', flush=True)


# -- phase 20: the DCGAN and its two-optimizer trainer ----------------------------

# DCGAN at its registered widths (64², 3 channels, latent 128, base width
# 64) with Adam lr 2e-4, beta1 0.5 for both roles (Radford, Metz and
# Chintala, ICLR 2016): two batches of 128 an epoch, so a checkpoint every
# 2 steps
GAN_BATCH, GAN_SAMPLES, GAN_RESUME_AT, GAN_ITERS = 128, 256, 6, 10
GAN_DDP_STEPS = 3
# two gloo ranks (64 each) against one process on the same global batches,
# float32 with TF32 off.  Step 1 starts from one state: D's loss and the
# norm of its averaged gradient differ only by the order of float32 sums
# (the global BatchNorm's combine, the losses' means); a rank left on its
# own gradients would report a norm tens of percent off.  G's loss and
# norm come after one Adam update of D, which moves an element whose
# gradient sits at rounding's scale by up to lr (2e-4, on weights of
# ~0.02): the first call read G's norm 1.03e-4 apart, so G's limit is ten
# times D's.  That each role's gradients are the same on both ranks is the
# ranks' bit-equal states.  D's accuracy counts logits above 0, so one
# logit at 0 may flip it by 1/128.
GAN_DDP_FIRST_TOL = 1e-4       # relative, D's loss and gradient norm of step 1
GAN_DDP_G_TOL = 1e-3           # relative, G's loss and gradient norm of step 1
GAN_DDP_ACC_TOL = 2 / GAN_BATCH
GAN_CONFIG = '''\
config = dict(
    model=dict(type='DCGAN', params=dict()),
    data=dict(train=dict(type='smoke_gan_images', params=dict(
        num_samples={samples}, seed={seed}, total_batch_size={batch},
        sampler_type='StepDistributedSampler'))),
    learning_rate=dict(type='constant', params=dict(base_lr=2e-4)),
    optimizer=dict(type='adam', params=dict(betas=(0.5, 0.999))),
    train=dict(num_iters={iters}, log_interval_step=1, save_ckpt_interval_epoch=1),
)
'''


def adam_reach(lr: float, betas, steps: int) -> float:
    """The furthest two Adam runs from one state can stand apart after
    ``steps`` steps at ``lr``, whatever their gradients: Adam moves an
    element by ``lr·|m̂/√v̂|``, and by Cauchy-Schwarz over the moments'
    weights ``|m̂_t/√v̂_t| ≤ √(Σ_i w_i²/u_i) · √(1−β2^t) / (1−β1^t)``
    (``w_i = (1−β1)β1^(t−i)``, ``u_i = (1−β2)β2^(t−i)``); two runs whose
    gradients part (by rounding, which GAN and bf16 steps amplify) may move
    an element in opposite directions by that much each."""
    b1, b2 = betas
    reach = 0.0
    for t in range(1, steps + 1):
        s = sum(((1 - b1) * b1 ** (t - i)) ** 2 / ((1 - b2) * b2 ** (t - i))
                for i in range(1, t + 1))
        reach += math.sqrt(s) * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
    return 2 * lr * reach


# the parameters' max |d| after the steps (1e-6 of it for float32's rounding
# of the updates themselves)
GAN_DDP_TOL = adam_reach(2e-4, (0.5, 0.999), GAN_DDP_STEPS) * (1 + 1e-6)


def register_gan_data():
    """Register ``smoke_gan_images`` in the port's DATASET registry: seeded
    float32 images ``[n, 64, 64, 3]`` in [-1, 1], made in bulk."""
    import numpy as np
    from ever_tpu_torch.core import registry
    from ever_tpu_torch.interface import ERDataset

    if 'smoke_gan_images' in registry.DATASET:
        return

    @registry.DATASET.register('smoke_gan_images')
    class SmokeGanImages(ERDataset):
        def set_default_config(self):
            self.config.update(dict(num_samples=GAN_SAMPLES, image_size=64, seed=0))

        def __init__(self, config=None):
            super().__init__(config)
            c = self.config
            rng = np.random.default_rng(c.seed)
            self.x = rng.uniform(-1, 1, (c.num_samples, c.image_size, c.image_size, 3)
                                 ).astype(np.float32)

        def __len__(self):
            return self.config.num_samples

        def __getitem__(self, idx):
            return self.x[idx]


def gan_config(tmp: str, seed: int) -> str:
    path = os.path.join(tmp, 'dcgan.py')
    with open(path, 'w') as f:
        f.write(GAN_CONFIG.format(samples=GAN_SAMPLES, seed=seed, batch=GAN_BATCH,
                                  iters=GAN_ITERS))
    return path


def gan_run(cfg: str, model_dir: str, num_iters: int, train_dl=None):
    """``get_trainer('gan_th_ddp')`` of ``cfg`` into ``model_dir`` on
    ``cuda:0`` for ``num_iters`` steps (from its last checkpoint, if any):
    the launcher, every logged step's metrics and the model's state before
    training."""
    from ever_tpu_torch.trainer import get_trainer

    record = dict(logged=[], init=None)

    def wire(tl):
        record['init'] = {k: v.detach().clone() for k, v in tl.model.state_dict().items()}
        train_log = tl.logger.train_log

        def logged(step, n, loss_dict, data_time, time_cost, lr):
            record['logged'].append([step, dict(loss_dict)])
            return train_log(step, n, loss_dict, data_time, time_cost, lr)

        tl.logger.train_log = logged

    t = get_trainer('gan_th_ddp', argv=['--config_path', cfg, '--model_dir', model_dir,
                                        '--device', 'cuda:0', 'train.num_iters',
                                        str(num_iters)])()
    out = t.run([wire]) if train_dl is None else t.train_with_dataloader(train_dl, None, [wire])
    torch.cuda.synchronize()
    return out['launcher'], record


def gan_global_loader(cfg: str, steps: int):
    """One process's loader of the global batches two ranks of
    ``GAN_BATCH / 2`` draw in ``steps`` steps."""
    from ever_tpu_torch.core import registry
    from ever_tpu_torch.core.config import import_config
    from ever_tpu_torch.data.distributed import SubsetSampler, global_batches

    c = import_config(cfg)
    ds = registry.DATASET[c.data.train.type](c.data.train.params)
    order = sum(global_batches(ds, 2, GAN_BATCH // 2, steps), [])
    return torch.utils.data.DataLoader(ds, batch_size=GAN_BATCH, sampler=SubsetSampler(order),
                                       collate_fn=ds.collate_fn, num_workers=0)


def gan_worker(rank: int, out: str) -> dict:
    """One of two gloo ranks: ``GAN_DDP_STEPS`` steps of the config with a
    global batch of ``GAN_BATCH``."""
    with open(os.path.join(out, 'gan-spec.json')) as f:
        spec = json.load(f)
    register_gan_data()
    tl, rec = gan_run(spec['config'], os.path.join(out, f'gan-rank{rank}'), GAN_DDP_STEPS)
    torch.save({k: v.cpu() for k, v in tl.model.state_dict().items()},
               os.path.join(out, f'gan-state-rank{rank}.pt'))
    return dict(logged=rec['logged'], digest=state_digest(tl.model.state_dict()),
                mesh=[tl.mesh.size(), tl.mesh.rank()], launches=all_launches())


def gan_bare_step(cfg: str, seed: int):
    """The trainer's model, update rules and step on one card-resident
    batch of ``GAN_BATCH``: (model, step, state, batch)."""
    import numpy as np
    from ever_tpu_torch.core import builder
    from ever_tpu_torch.core.config import import_config
    from ever_tpu_torch.trainer.gan import build_gan_train_step, create_gan_state

    c = import_config(cfg)
    model = builder.make_model(c.model)
    txs = {}
    for role in ('G', 'D'):
        factory, _ = builder.make_optimizer(c.optimizer)
        txs[role] = factory.build(builder.make_learningrate(c.learning_rate))
    batch = torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, (GAN_BATCH, 64, 64, 3)).astype(np.float32)).cuda()
    return model, build_gan_train_step(model, txs, rng_seed=seed), create_gan_state(model, txs), \
        batch


def phase_gan(seed: int, smi: str, tmp: str, cfg: str, ranks: list) -> None:
    """The DCGAN through ``get_trainer('gan_th_ddp')`` (module docstring,
    phase 20) in ``tmp``, from the config file ``cfg``; ``ranks`` are the
    parallel phases' ranks' results (:func:`start_parallel`).  It launches
    no kernel of the port."""
    from torch.utils.flop_counter import FlopCounterMode

    t_phase = time.perf_counter()
    register_gan_data()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        reset_counts()
        _, part = gan_run(cfg, os.path.join(tmp, 'part'), GAN_RESUME_AT)
        resumed, rest = gan_run(cfg, os.path.join(tmp, 'part'), GAN_ITERS)
        whole, full = gan_run(cfg, os.path.join(tmp, 'whole'), GAN_ITERS)
        launches = all_launches()
        logged = part['logged'] + rest['logged'] + full['logged']
        finite = all(math.isfinite(v) for _, m in logged for v in m.values())
        keys = set(full['logged'][-1][1])
        end = whole.model.state_dict()
        moved = {role: all(not torch.equal(end[k], v) for k, v in full['init'].items()
                           if k.startswith(f'{role}.') and not k.endswith('num_batches'))
                 for role in ('G', 'D')}
        same = state_digest(resumed.model.state_dict()) == state_digest(end)
        same_logs = rest['logged'] == full['logged'][GAN_RESUME_AT:]
        print(f'gan: DCGAN 64² (latent 128, base width 64; G '
              f'{sum(p.numel() for p in whole.model.G.parameters()) / 1e6:.2f} M, D '
              f'{sum(p.numel() for p in whole.model.D.parameters()) / 1e6:.2f} M '
              f'parameters), Adam lr 2e-4 beta1 0.5 both roles, batch {GAN_BATCH}, '
              f'float32, TF32 off, deterministic cuDNN, through get_trainer(\'gan_th_ddp\'): '
              f'logged {sorted(keys)}; last step ' + ', '.join(
                  f'{k} {v:.5f}' for k, v in sorted(full['logged'][-1][1].items())),
              flush=True)
        print(f'gan: (a) every logged metric finite {finite}; every tensor moved: G '
              f'{moved["G"]}, D {moved["D"]}; (b) {GAN_RESUME_AT} steps and a resume to '
              f'{GAN_ITERS} against {GAN_ITERS} at once: final state bit-equal {same}, '
              f'logged metrics of steps {GAN_RESUME_AT + 1}-{GAN_ITERS} equal {same_logs}; '
              f'(d) the port\'s kernels launched {launches} times', flush=True)
        check(finite, 'gan: a non-finite logged metric')
        check(keys >= {'D_d_loss', 'D_d_real_acc', 'G_g_loss', 'd_grad_norm',
                       'g_grad_norm', 'd_lr', 'g_lr'}, f'gan: logged {sorted(keys)}')
        check(all(moved.values()), f'gan: parameters left unmoved: {moved}')
        check(same and same_logs, 'gan: the resumed run differs from the unbroken one')
        check(launches == 0, f'gan: the port\'s kernels launched {launches} times')
        del resumed, whole

        # (c) two gloo ranks on the card against one process
        r0, r1 = (r['gan'] for r in ranks)
        secs = ranks[0]['seconds']['gan']
        reset_counts()
        one, orec = gan_run(cfg, os.path.join(tmp, 'one'), GAN_DDP_STEPS,
                            train_dl=gan_global_loader(cfg, GAN_DDP_STEPS))
        two = torch.load(os.path.join(tmp, 'gan-state-rank0.pt'))
        params = {n for n, _ in one.model.named_parameters()}
        end = one.model.state_dict()
        diff = max(float((two[k] - end[k].cpu()).abs().max()) for k in params)
        bufs = max_state_diff({k: v for k, v in two.items() if k not in params},
                              {k: v for k, v in end.items() if k not in params})
        worst = []
        for (s2, m2), (s1, m1) in zip(r0['logged'], orec['logged']):
            check(s1 == s2, f'gan: logged steps {s1} and {s2}')
            worst.append({k: abs(m2[k] - v) / (1 if k.endswith('acc') else max(abs(v), 1e-12))
                          for k, v in m1.items() if not k.endswith('_lr')})
        first_d = max(v for k, v in worst[0].items() if k in ('D_d_loss', 'd_grad_norm'))
        first_g = max(v for k, v in worst[0].items() if k in ('G_g_loss', 'g_grad_norm'))
        print(f'gan: (c) two gloo ranks on the card ({r0["mesh"][0]}-rank mesh, '
              f'{GAN_BATCH // 2} a rank, {secs:.1f} s in the ranks) against one '
              f'process on the same global batches, {GAN_DDP_STEPS} steps: the ranks\' '
              f'states bit-equal {r0["digest"] == r1["digest"]}; step 1: '
              + ', '.join(f'{k} {v:.2e}' for k, v in sorted(worst[0].items()))
              + f' (relative; accuracy absolute; limits D {GAN_DDP_FIRST_TOL}, G '
              f'{GAN_DDP_G_TOL}, accuracy {GAN_DDP_ACC_TOL:.4f}); the largest relative '
              f'difference of steps 2-'
              f'{GAN_DDP_STEPS}: ' + ' '.join(f'{max(w.values()):.2e}' for w in worst[1:])
              + f'; after {GAN_DDP_STEPS} steps the parameters max|d| {diff:.3e} (limit '
              f'{GAN_DDP_TOL:.4e}), the running statistics max_state_diff {bufs:.3e}; '
              f'the ranks launched the port\'s kernels {r0["launches"] + r1["launches"]} '
              f'times', flush=True)
        check(r0['digest'] == r1['digest'], 'gan: the two ranks\' states differ')
        check(first_d <= GAN_DDP_FIRST_TOL and first_g <= GAN_DDP_G_TOL
              and worst[0]['D_d_real_acc'] <= GAN_DDP_ACC_TOL,
              f'gan: two ranks\' step 1 against one process: {worst[0]}')
        check(diff <= GAN_DDP_TOL, f'gan: two ranks\' parameters against one process: {diff}')
        check(r0['launches'] + r1['launches'] == 0, 'gan: the ranks launched port kernels')
        del one

        # the bare step's time and FLOPs
        model, step, state, batch = gan_bare_step(cfg, seed)
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model.d_loss(batch, train=True)
            model.g_loss(batch, train=True)
        flops = 3 * counter.get_total_flops()
        for _ in range(WARMUP_STEPS):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
        events[0].record()
        for i in range(TIMED_STEPS):
            state, _ = step(state, batch)
            events[i + 1].record()
        torch.cuda.synchronize()
        times = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
        med = times[len(times) // 2]
        print(f'gan: {smi}: the bare two-optimizer step (D update, then G update) at '
              f'batch {GAN_BATCH}: median {med:.3f} ms/step of {TIMED_STEPS} after '
              f'{WARMUP_STEPS} (min {times[0]:.3f}, max {times[-1]:.3f}) = '
              f'{GAN_BATCH / med * 1e3:.0f} images/s; MFU {flops / (med / 1e3) / PEAK_F32_FLOPS:.4f} '
              f'of the float32 peak (3 × the forward\'s {flops / 3e9:.2f} GFLOP: d_loss '
              f'and g_loss / step time / 67 TFLOP/s; TF32 off); phase '
              f'{time.perf_counter() - t_phase:.1f} s', flush=True)
    finally:
        torch.backends.cudnn.deterministic = det


# -- phase 21: ZeRO-1/3 and directory checkpoints -----------------------------------

ZERO_BATCH, ZERO_STEPS = 8, 3          # 4 tiles of 512² a rank
# one AdamW step from one state on the same averaged gradients: ZeRO
# computes what the replicated step computes element by element, so after
# step 1 only the optimizer's elementwise kernels (multi-tensor on whole
# tensors, per tensor on a strided shard) may round apart by an ulp
ZERO_FIRST_TOL = 1e-6
# after 3 steps: two AdamW runs whose parameters part by an ulp (through bf16
# activations) stand at most adam_reach apart (the cosine schedule's lr is
# 1e-4 over these steps; the decay term moves both alike)
ZERO_TOL = adam_reach(1e-4, (0.9, 0.999), ZERO_STEPS) * (1 + 1e-6)
ZERO_LAYOUTS = (('replicated (DDP)', 0), ('ZeRO-1', 1), ('ZeRO-3', 3))


class CkptHost:
    """What a ``CheckPoint`` reads of a launcher: the model dir, the state,
    the device, and the step it restores."""
    logger = None

    def __init__(self, model_dir: str, state, device):
        self.model_dir, self.state, self.device = model_dir, state, device
        os.makedirs(model_dir, exist_ok=True)

    def restore_state(self, model_state, opt_state, global_step):
        self.state.step = int(global_step)


def zero_state(seed: int, level: int, mesh):
    """DinoSeg ViT-L/16 (bf16 compute, float32 parameters, the same seeded
    weights on every rank), AdamW + cosine, placed for ``level`` (0:
    replicated under DDP): (state, step, shardings)."""
    from ever_tpu_torch.core.builder import make_learningrate, make_optimizer
    from ever_tpu_torch.parallel.spmd import build_train_step, create_train_state
    from ever_tpu_torch.parallel.zero import zero_init

    model = build_dinoseg(torch.Generator(device='cuda').manual_seed(seed + 17))
    schedule = make_learningrate({'type': 'cosine', 'params': dict(base_lr=1e-4,
                                                                   max_iters=1000)})
    factory, _ = make_optimizer({'type': 'adamw', 'params': dict(weight_decay=0.05)})
    tx = factory.build(schedule)
    state, sh = create_train_state(model, tx), None
    if level:
        state, sh = zero_init(state, mesh, level, device='cuda:0')
    return state, build_train_step(model, tx, schedule, mesh=mesh, state_shardings=sh), sh


def zero_worker(rank: int, out: str) -> dict:
    """One of two gloo ranks: each layout's steps, bytes and launches; the
    directory checkpoints of the ZeRO-3 run at step 2 and its resume."""
    from ever_tpu_torch.core.checkpoint import CheckPoint
    from ever_tpu_torch.parallel.mesh import make_mesh
    from ever_tpu_torch.parallel.zero import full_state_dict, local_bytes
    from ever_tpu_torch.ops import attention as A

    with open(os.path.join(out, 'zero-spec.json')) as f:
        seed = json.load(f)['seed']
    mesh = make_mesh()
    gen = torch.Generator(device='cuda').manual_seed(seed + 18)
    x = torch.randn(ZERO_BATCH, TILE, TILE, 3, generator=gen, device='cuda')
    y = torch.randint(0, CLASSES, (ZERO_BATCH, TILE, TILE), generator=gen, device='cuda')
    rows = slice(rank * ZERO_BATCH // 2, (rank + 1) * ZERO_BATCH // 2)
    batch = (x[rows], y[rows])
    res, ref = dict(layouts=[]), {}
    for name, level in ZERO_LAYOUTS:
        state, step, sh = zero_state(seed, level, mesh)
        reset_counts()
        ms, metrics, diffs = [], [], []
        for i in range(ZERO_STEPS):
            if i == ZERO_STEPS - 1:         # the state complete, the checkpoints written
                torch.cuda.synchronize()
                rest = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == ZERO_STEPS - 1:
                peak = torch.cuda.max_memory_allocated() - rest
            if i in (0, ZERO_STEPS - 1):
                full = {k: v.cpu() for k, v in full_state_dict(state).items()}
                if level == 0:
                    ref[i] = full
                else:
                    diffs.append(max_state_diff(full, ref[i]))
                    diffs.append(all(torch.equal(full[k], v) for k, v in ref[i].items()))
            if level == 3 and i == 1:
                for backend in ('orbax', 'orbax_async'):
                    ckpt = CheckPoint(CkptHost(os.path.join(out, f'zero-{backend}'), state,
                                               torch.device('cuda:0')), backend)
                    ckpt.set_global_step(2)
                    t0 = time.perf_counter()
                    ckpt.save()
                    res[f'save {backend}'] = time.perf_counter() - t0
                    ckpt.wait()
                    res[f'written {backend}'] = time.perf_counter() - t0
        whole = sum(p.numel() * 4 for p in state.model.parameters()) if level == 0 else \
            sum(s.shape.numel() * 4 for s in state.optimizer.slots.values())
        flight = dict(rest=rest, peak=peak, whole=2 * whole)
        if level == 3:
            zo = state.optimizer
            flight.update(held=zo.stats['peak_bytes'], budget=zo.unit_budget(),
                          units=len(zo.units), log=len(zo.unit_log))
        res['layouts'].append(dict(name=name, level=level, ms=ms, metrics=metrics, diffs=diffs,
                                   bytes=local_bytes(state), flight=flight,
                                   launches=[A.fused_attention.launches,
                                             A.fused_attention_bwd.launches]))
        unbroken = full                   # the ZeRO-3 run's step 3, last
        del state, step
        torch.cuda.empty_cache()
    # the ZeRO-3 run resumed from its step-2 directory, one step on
    fresh, step, _ = zero_state(seed, 3, mesh)
    ckpt = CheckPoint(CkptHost(os.path.join(out, 'zero-orbax'), fresh, torch.device('cuda:0')),
                      'orbax')
    t0 = time.perf_counter()
    resumed = ckpt.try_resume()
    res['restore'] = time.perf_counter() - t0
    res['resumed_at'] = fresh.step
    fresh, _ = step(fresh, batch)
    got = {k: v.cpu() for k, v in full_state_dict(fresh).items()}
    res['resume_equal'] = resumed and all(torch.equal(got[k], v) for k, v in unbroken.items())
    del fresh, step
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    if rank == 0:
        a = CheckPoint.load(os.path.join(out, 'zero-orbax', 'checkpoint-2'), device='cpu')
        b = CheckPoint.load(os.path.join(out, 'zero-orbax_async', 'checkpoint-2'), device='cpu')
        flat = lambda c: {**{f'model/{k}': v for k, v in c['model'].items()},  # noqa: E731
                          **{f'opt/{n}/{k}': v for n, st in c['opt']['state'].items()
                             for k, v in st.items()}}
        fa, fb = flat(a), flat(b)
        res['files_equal'] = set(fa) == set(fb) and all(
            torch.equal(torch.as_tensor(fb[k]), torch.as_tensor(v)) for k, v in fa.items())
        res['file_tensors'] = len(fa)
        res['file_bytes'] = sum(torch.as_tensor(v).nbytes for v in fa.values())
    return res


def phase_zero(smi: str, parallel: list) -> tuple:
    """ZeRO-1/3 of DinoSeg ViT-L/16 over two gloo ranks on the card (module
    docstring, phase 21) from the parallel phases' ranks' results
    (:func:`start_parallel`); returns the ranks' K1 and K2 launches."""
    ranks, secs = [r['zero'] for r in parallel], parallel[0]['seconds']['zero']
    r0 = ranks[0]
    rep = r0['layouts'][0]
    k1 = k2 = 0
    for res in ranks:
        for lay in res['layouts']:
            k1, k2 = k1 + lay['launches'][0], k2 + lay['launches'][1]
    for lay in r0['layouts']:
        b, rb = lay['bytes'], rep['bytes']
        steady = sorted(lay['ms'][1:])
        print(f'zero: {smi}: {lay["name"]}: DinoSeg vitl16_sat493m, bf16 compute, float32 '
              f'parameters, AdamW + cosine, {ZERO_BATCH // 2} tiles of {TILE}² a rank, 2 gloo '
              f'ranks on the card: ms/step {" ".join(f"{t:.1f}" for t in lay["ms"])} (steps '
              f'2-{ZERO_STEPS}: median {steady[len(steady) // 2]:.1f}); losses '
              f'{" ".join(f"{m["cls_loss"]:.5f}" for m in lay["metrics"])}; grad_norm '
              f'{" ".join(f"{m["grad_norm"]:.4f}" for m in lay["metrics"])}; rank 0 holds '
              f'parameters {b["params"] / 2**30:.3f} GiB ({b["params"] / rb["params"]:.3f} of '
              f'replicated), optimizer state {b["opt_state"] / 2**30:.3f} GiB '
              f'({b["opt_state"] / rb["opt_state"]:.3f}); K1/K2 launches {lay["launches"]}',
              flush=True)
        fl, rfl = lay['flight'], rep['flight']
        print(f'zero: {smi}: {lay["name"]}: step {ZERO_STEPS} peak {fl["peak"] / 2**30:.3f} GiB '
              f'above the {fl["rest"] / 2**30:.3f} GiB a rank holds at rest (max_memory_allocated; '
              f'replicated {rfl["peak"] / 2**30:.3f} above {rfl["rest"] / 2**30:.3f}); whole '
              f'float32 parameters and gradients of the model {fl["whole"] / 2**30:.3f} GiB'
              + (f'; held whole at once during the step {fl["held"] / 2**30:.4f} GiB, two '
                 f'units\' worth {fl["budget"] / 2**30:.4f} GiB ({fl["units"]} units, '
                 f'{fl["log"]} gathers and reductions a step)' if lay['level'] == 3 else ''),
              flush=True)
        if lay['level'] == 3:
            for res in ranks:
                f3 = next(x for x in res['layouts'] if x['level'] == 3)['flight']
                check(0 < f3['held'] <= f3['budget'],
                      f'zero: ZeRO-3 held {f3["held"]} whole bytes at once, over two units\' '
                      f'{f3["budget"]}')
        if lay['level']:
            d1, eq1, d3, eq3 = lay['diffs']
            print(f'zero: {lay["name"]} against replicated: after step 1 max_state_diff '
                  f'{d1:.3e} (bit-equal {eq1}; limit {ZERO_FIRST_TOL}), after step '
                  f'{ZERO_STEPS} {d3:.3e} (bit-equal {eq3}; limit {ZERO_TOL:.4e})', flush=True)
            check(d1 <= ZERO_FIRST_TOL and d3 <= ZERO_TOL,
                  f'zero: {lay["name"]} parted from the replicated run: {d1}, {d3}')
            check(b['opt_state'] <= 0.5 * rb['opt_state'] + 2**20,
                  f'zero: {lay["name"]} holds {b["opt_state"]} optimizer bytes a rank')
            if lay['level'] == 3:
                check(b['params'] <= 0.5 * rb['params'] + 2**20,
                      f'zero: ZeRO-3 holds {b["params"]} parameter bytes a rank')
        for res in ranks:
            got = next(x for x in res['layouts'] if x['name'] == lay['name'])['launches']
            check(got == [24 * ZERO_STEPS, 24 * ZERO_STEPS],
                  f'zero: {lay["name"]} launched K1/K2 {got} times in {ZERO_STEPS} steps')
        check(all(math.isfinite(m['cls_loss']) and math.isfinite(m['grad_norm'])
                  for m in lay['metrics']), f'zero: {lay["name"]}: non-finite metrics')
    print(f'zero: (c) the ZeRO-3 state at step 2 as directories: \'orbax\' save '
          f'{r0["save orbax"]:.2f} s; \'orbax_async\' save returned in '
          f'{r0["save orbax_async"]:.2f} s, written after wait() at '
          f'{r0["written orbax_async"]:.2f} s; {r0["file_tensors"]} tensors, '
          f'{r0["file_bytes"] / 2**30:.2f} GiB, the same contents {r0["files_equal"]}; a '
          f'sharded restore into a fresh ZeRO-3 state ({r0["restore"]:.2f} s) resumed at step '
          f'{r0["resumed_at"]} and its step 3 equals the unbroken run bit for bit: rank 0 '
          f'{r0["resume_equal"]}, rank 1 {ranks[1]["resume_equal"]}; {secs:.1f} s in the '
          f'ranks', flush=True)
    check(r0['files_equal'], 'zero: the orbax and orbax_async directories differ')
    check(r0['resumed_at'] == 2 and all(r['resume_equal'] for r in ranks),
          'zero: the resumed ZeRO-3 run differs from the unbroken one')
    return k1, k2


# -- phase 22: the model-parallel layouts -----------------------------------------------

LAYOUT_TP_STEPS = 2                     # timed, after WARMUP_STEPS
LAYOUT_PP_MICRO, LAYOUT_PP_RUNS = 4, 3  # microbatches; timed runs after the counted one
LAYOUT_EP = dict(num_experts=8, hidden=4096, k=2)
# expert parallel against one process, float32 with TF32 off: each rank's
# experts compute the same products on the same slots, and the partial
# outputs add exactly (a token's other choice is 0 on the other rank); the
# input's, the router's and the experts' gradients add two ranks' partial
# sums (or the chain through them) in another order: the relative norm of
# each difference
EP_REL_TOL = 1e-5


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in float32."""
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def step_grads(model, x, y) -> tuple:
    """The loss and every parameter's gradient (float32, by name) of the
    first step's forward and backward (the step's generator at count 0)."""
    from ever_tpu_torch.parallel.spmd import step_generator

    model.zero_grad(set_to_none=True)
    out = model(x, y, train=True, generator=step_generator(0, 0, device='cuda'))
    out['cls_loss'].backward()
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out['cls_loss'].item(), grads


def layouts_tp(rank: int, seed: int, out: str) -> dict:
    """(a) DinoSeg ViT-L/16 under tensor parallel with ZeRO-3 over the
    ``('replica', 'data', 'model')`` mesh of (1, 1, 2): one process's
    gradients (rank 0) against the TP state's, the bytes each rank holds of
    the split leaves, the timed steps' launches, losses and ms; the state
    after the warm-up written as directories (``'orbax'``, ``'orbax_async'``)
    and restored into fresh TP + ZeRO-3 states, whose next step is held
    against the first timed step."""
    import shutil
    from ever_tpu_torch.core.builder import make_learningrate, make_optimizer
    from ever_tpu_torch.core.checkpoint import CheckPoint
    from ever_tpu_torch.core.config import import_config
    from ever_tpu_torch.ops import attention as A
    from ever_tpu_torch.parallel.mesh import make_hybrid_mesh
    from ever_tpu_torch.parallel.sharded import create_train_state_sharded
    from ever_tpu_torch.parallel.spmd import build_train_step
    from ever_tpu_torch.parallel.tp import gather_tp, tp_plan
    from ever_tpu_torch.parallel.zero import full_state_dict

    mesh = make_hybrid_mesh(('data', 'model'), (1, 2))
    res = dict(mesh=mesh.shape, batch_axes=mesh.batch_axes)
    gen = torch.Generator(device='cuda').manual_seed(seed + 19)
    model = build_dinoseg(gen)
    x = torch.randn(TRAIN_BATCH, TILE, TILE, 3, generator=gen, device='cuda')
    y = torch.randint(0, CLASSES, (TRAIN_BATCH, TILE, TILE), generator=gen, device='cuda')
    names = [n for n, _ in model.named_parameters()]
    whole = {n: p.numel() * p.element_size() for n, p in model.named_parameters()}
    if rank == 0:                       # one process on the same weights and batch
        res['ref_loss'], ref = step_grads(copy.deepcopy(model), x, y)
    cfg = import_config(TEMPLATE_CONFIG)
    schedule = make_learningrate(cfg.learning_rate)
    factory, opt_cfg = make_optimizer(cfg.optimizer)
    tx = factory.build(schedule, grad_clip=opt_cfg.get('grad_clip'))
    res['max_norm'] = tx.max_norm
    state, sh = create_train_state_sharded(model, tx, mesh=mesh, level=3, tp_axis='model',
                                           device='cuda:0')
    plan = tp_plan(model)
    res['split'] = len(plan.sharded)
    res['split_whole'] = sum(whole[n] for n in plan.sharded)
    res['split_held'] = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                            if n in plan.sharded)
    res['heads'] = model.vit.blocks[0].attn.num_heads
    res['tp_loss'], grads = step_grads(model, x, y)
    grads = gather_tp(model, grads)
    if rank == 0:
        res['grad_rel'], res['grad_cos'], cos = compare_grads([grads[n] for n in names],
                                                              [ref[n] for n in names])
        res['qkv_cos'] = cos[names.index('vit.blocks.0.attn.qkv.weight')]
        del ref
    del grads
    torch.cuda.empty_cache()
    step = build_train_step(model, tx, schedule, mesh=mesh, state_shardings=sh)
    for _ in range(WARMUP_STEPS):
        state, _ = step(state, (x, y))
    dirs = {}
    for backend in ('orbax', 'orbax_async'):
        ckpt = CheckPoint(CkptHost(os.path.join(out, f'layouts-{backend}'), state,
                                   torch.device('cuda:0')), backend)
        ckpt.set_global_step(state.step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save()
        saved = time.perf_counter() - t0
        ckpt.wait()
        dirs[backend] = dict(dir=ckpt._launcher.model_dir, save=saved,
                             written=time.perf_counter() - t0)
    path = os.path.join(dirs['orbax']['dir'], CheckPoint.get_checkpoint_name(state.step, 'orbax'))
    res['dir_gib'] = sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path)) / 2**30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, metrics = [], []
    for i in range(LAYOUT_TP_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, (x, y))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            peak = torch.cuda.max_memory_allocated() / 2**30
            unbroken = {k: v.cpu() for k, v in full_state_dict(state).items()}
    res.update(ms=ms, metrics=metrics, peak_gib=peak,
               launches=[A.fused_attention.launches, A.fused_attention_bwd.launches])
    del state, step
    torch.cuda.empty_cache()
    # each directory restored into a fresh TP + ZeRO-3 state, one step on
    res['resumes'] = {}
    for backend, d in dirs.items():
        fresh_model = build_dinoseg(torch.Generator(device='cuda').manual_seed(seed + 20))
        fresh, fresh_sh = create_train_state_sharded(fresh_model, tx, mesh=mesh, level=3,
                                                     tp_axis='model', device='cuda:0')
        ckpt = CheckPoint(CkptHost(d['dir'], fresh, torch.device('cuda:0')), backend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.try_resume()
        torch.cuda.synchronize()
        restore = time.perf_counter() - t0
        at = fresh.step
        fresh_step = build_train_step(fresh_model, tx, schedule, mesh=mesh,
                                      state_shardings=fresh_sh)
        fresh, m = fresh_step(fresh, (x, y))
        got = {k: v.cpu() for k, v in full_state_dict(fresh).items()}
        res['resumes'][backend] = dict(
            at=at, save=d['save'], written=d['written'], restore=restore,
            loss_equal=float(m['cls_loss']) == metrics[0]['cls_loss'],
            equal=set(got) == set(unbroken) and all(torch.equal(got[k], v)
                                                    for k, v in unbroken.items()))
        del fresh, fresh_step, fresh_model, got
        torch.cuda.empty_cache()
        shutil.rmtree(d['dir'], ignore_errors=True)
    del unbroken
    # a step all-reduces over 'model': per block, the attention's and the
    # MLP's outputs forward and their inputs' gradients backward (bf16
    # [B, N, D] each), the qkv and fc1 biases' gradients (float32), and the
    # shards' squared norm
    act = TRAIN_BATCH * S * EMBED * 2
    res['allreduce_bytes'] = 24 * (4 * act + (3 * EMBED + 4 * EMBED) * 4) + 4
    if rank == 0:                       # one rank's attention at its 8 heads
        res['attn_fwd'] = check_fwd(gen, ((B, H // 2, S, None, D, True, torch.bfloat16),))
        res['attn_bwd'] = check_bwd(gen, ((B, H // 2, S, None, D, True, torch.bfloat16),))
    del model
    torch.cuda.empty_cache()
    return res


def layouts_pp(rank: int, seed: int) -> dict:
    """(b) The ViT-L/16 trunk through ``pipelined_vit_apply`` on a
    ``('pipe',)`` mesh of 2 stages, 4 microbatches of 2 tiles: outputs and
    gradients of ``sum(x_norm_clstoken²)`` against the plain trunk in this
    process, the blocks a stage holds, launches, hops and ms."""
    from ever_tpu_torch.core.builder import make_model
    from ever_tpu_torch.ops import attention as A
    from ever_tpu_torch.parallel.mesh import make_mesh
    from ever_tpu_torch.parallel.pp import pipelined_vit_apply

    mesh = make_mesh(('pipe',), (2,))
    gen = torch.Generator(device='cuda').manual_seed(seed + 20)
    with torch.device('cuda'):
        trunk = make_model({'type': 'vitl16_sat493m', 'params': {}})
    seeded_init_(trunk, gen)
    x = torch.randn(B, TILE, TILE, 3, generator=gen, device='cuda')

    def run(fn):
        xin = x.clone().requires_grad_()
        out = fn(xin.to(torch.bfloat16))
        (out['x_norm_clstoken'].float() ** 2).sum().backward()
        return out['x_norm_patchtokens'].detach(), xin.grad

    def timed(fn, params):
        times = []
        for _ in range(LAYOUT_PP_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(fn)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            for p in params:
                p.grad = None
        return sorted(times)[len(times) // 2]

    ref_patch, ref_gx = run(trunk)
    ref = {n: p.grad.float() for n, p in trunk.named_parameters()}
    trunk.zero_grad(set_to_none=True)
    res = dict(plain_ms=timed(trunk, list(trunk.parameters())))
    fn = pipelined_vit_apply(trunk, None, mesh, num_microbatches=LAYOUT_PP_MICRO,
                             device='cuda:0')
    del trunk
    torch.cuda.empty_cache()
    reset_counts()
    patch, gx = run(fn)
    res['launches'] = [A.fused_attention.launches, A.fused_attention_bwd.launches]
    names = [n for n, _ in fn.named_parameters()]
    res['blocks'] = fn.block_ids
    res['block_params'] = sorted({int(n.split('.')[1]) for n in names if n.startswith('blocks.')})
    res['params'] = len(names)
    res['param_bytes'] = sum(p.numel() * p.element_size() for p in fn.parameters())
    res['patch_rel'], res['gx_rel'] = rel(patch, ref_patch), rel(gx, ref_gx)
    res['grad_rel'], res['grad_cos'], _ = compare_grads([p.grad.float() for p in fn.parameters()],
                                                        [ref[n] for n in names])
    del ref
    for p in fn.parameters():
        p.grad = None
    first = dict(fn.stats)
    res['ms'] = timed(fn, list(fn.parameters()))
    res['stats'] = {k: (v - first[k]) / LAYOUT_PP_RUNS for k, v in fn.stats.items()}
    del fn
    torch.cuda.empty_cache()
    return res


def layouts_ep(rank: int, seed: int) -> dict:
    """(c) ``MoEMlp`` (8 experts, hidden 4096, k=2) at width 1024 on
    ViT-L's tokens (8 × 1029), float32, over an ``('expert',)`` mesh of 2:
    output, auxiliary loss and gradients of ``mean(y²) + aux`` against one
    process, the experts a rank holds, no port kernel launched, ms."""
    from ever_tpu_torch.parallel.ep import MoEMlp
    from ever_tpu_torch.parallel.mesh import make_mesh
    from ever_tpu_torch.parallel.spmd import sown_losses

    mesh = make_mesh(('expert',), (2,))
    gen = torch.Generator(device='cuda').manual_seed(seed + 21)
    moe = MoEMlp(**LAYOUT_EP, dim=EMBED, device='cuda:0')
    with torch.no_grad():
        for name, p in moe.named_parameters():
            scale = {'router': 0.02, 'experts_fc1': EMBED ** -0.5,
                     'experts_fc2': LAYOUT_EP['hidden'] ** -0.5}.get(name, 0.02)
            p.copy_(scale * torch.randn(p.shape, generator=gen, device=p.device))
    x = torch.randn(B, S, EMBED, generator=gen, device='cuda')

    def run(m):
        xin = x.clone().requires_grad_()
        with sown_losses() as sown:
            y = m(xin)
        aux = sown['moe_aux_loss'][0]
        ((y ** 2).mean() + aux).backward()
        grads = {n: p.grad for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return y.detach(), aux.item(), xin.grad, grads

    def timed(m):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(m)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[1]

    whole = copy.deepcopy(moe)
    y1, aux1, gx1, g1 = run(whole)
    res = dict(plain_ms=timed(whole))
    del whole
    moe.shard_experts(mesh)
    reset_counts()
    y2, aux2, gx2, g2 = run(moe)
    res['launches'] = sum(fn.launches for fn in kernel_wrappers())
    lo, n = moe.first_expert, moe.experts_fc1.shape[0]
    res.update(experts=n, first=lo, y_rel=rel(y2, y1), aux=[aux2, aux1], gx_rel=rel(gx2, gx1),
               grad_rel={k: rel(g, g1[k][lo:lo + n] if k.startswith('experts_') else g1[k])
                         for k, g in g2.items()},
               ms=timed(moe), tokens=B * S,
               capacity=int(-(-(LAYOUT_EP['k'] * B * S * moe.capacity_factor)
                              // LAYOUT_EP['num_experts'])),
               allreduce_bytes=2 * B * S * EMBED * 4 + EMBED * LAYOUT_EP['num_experts'] * 4)
    return res


def layouts_worker(rank: int, out: str) -> dict:
    """One of two gloo ranks of the layouts phase: (a) tensor parallel, (b)
    the pipeline, (c) expert parallel, each on a mesh of its own."""
    with open(os.path.join(out, 'layouts-spec.json')) as f:
        seed = json.load(f)['seed']
    res = {}
    for name, fn in (('tp', functools.partial(layouts_tp, out=out)), ('pp', layouts_pp),
                     ('ep', layouts_ep)):
        t0 = time.perf_counter()
        res[name] = fn(rank, seed)
        res[name]['seconds'] = time.perf_counter() - t0
    return res


def phase_layouts(smi: str, bare_ms: float, parallel: list) -> tuple:
    """The model-parallel layouts over two gloo ranks on the card (module
    docstring, phase 22) from the parallel phases' ranks' results
    (:func:`start_parallel`); returns the main paths' K1 and K2 launches
    (the TP steps and the pipeline's counted run, both ranks)."""
    ranks, secs = [r['layouts'] for r in parallel], parallel[0]['seconds']['layouts']
    backend = 'gloo, 2 ranks sharing one card: correctness and bytes held, not a multi-card speed'
    tp0 = ranks[0]['tp']
    for r, res in enumerate(ranks):
        tp = res['tp']
        steady = sorted(tp['ms'])
        print(f'layouts: (a) {smi}: rank {r}: DinoSeg vitl16_sat493m under tensor parallel + '
              f'ZeRO-3 on {tp["mesh"]} (batch axes {tp["batch_axes"]}), bf16 compute, float32 '
              f'parameters, AdamW + the template config\'s cosine and grad_clip '
              f'{tp["max_norm"]}, {TRAIN_BATCH} tiles of {TILE}²: ms/step '
              f'{" ".join(f"{t:.1f}" for t in tp["ms"])} (median '
              f'{steady[len(steady) // 2]:.1f}; one process {bare_ms:.1f}, phase 4); losses '
              f'{" ".join(f"{m["cls_loss"]:.5f}" for m in tp["metrics"])}; grad_norm '
              f'{" ".join(f"{m["grad_norm"]:.4f}" for m in tp["metrics"])}; {tp["heads"]} '
              f'heads a rank; holds {tp["split_held"] / 2**20:.1f} MiB of the {tp["split"]} '
              f'split leaves\' {tp["split_whole"] / 2**20:.1f} MiB; peak '
              f'{tp["peak_gib"]:.2f} GiB; K1/K2 launches {tp["launches"]} in '
              f'{LAYOUT_TP_STEPS} steps; all-reduced over \'model\' '
              f'{tp["allreduce_bytes"] / 2**30:.3f} GiB a step ({backend}); '
              f'{tp["seconds"]:.1f} s', flush=True)
        check(tp['mesh'] == {'replica': 1, 'data': 1, 'model': 2},
              f'layouts: the hybrid mesh is {tp["mesh"]}')
        check(tp['heads'] == H // 2, f'layouts: {tp["heads"]} heads a rank')
        check(tp['launches'] == [24 * LAYOUT_TP_STEPS] * 2,
              f'layouts: TP launched K1/K2 {tp["launches"]} in {LAYOUT_TP_STEPS} steps')
        check(tp['split_held'] <= tp['split_whole'] / 2 + 2**20,
              f'layouts: rank {r} holds {tp["split_held"]} of {tp["split_whole"]} split bytes')
        check(all(math.isfinite(m['cls_loss']) and math.isfinite(m['grad_norm'])
                  for m in tp['metrics']), 'layouts: TP metrics not finite')
    print(f'layouts: (a) the first step\'s gradients, TP (gathered) against one process on '
          f'the same weights and batch: loss {tp0["tp_loss"]:.6f} vs {tp0["ref_loss"]:.6f}; '
          f'||dg||/||g|| {tp0["grad_rel"]:.3e}, worst per-tensor cosine '
          f'{tp0["grad_cos"]:.6f}, block 0 qkv weight cosine {tp0["qkv_cos"]:.6f} (limits '
          f'{GRAD_REL_TOL}, {GRAD_COS_MIN}); one rank\'s attention at B={B}, H={H // 2}, '
          f'N={S}, D={D} against its plain version: K1 {tp0["attn_fwd"]:.3e}, K2 '
          f'{tp0["attn_bwd"]:.3e} (phase 2\'s limits)', flush=True)
    check(tp0['grad_rel'] <= GRAD_REL_TOL and tp0['grad_cos'] >= GRAD_COS_MIN,
          'layouts: TP gradients disagree with one process')
    for backend, rs in tp0['resumes'].items():
        print(f'layouts: (a) {smi}: the TP + ZeRO-3 state after {WARMUP_STEPS} steps as a '
              f'\'{backend}\' directory ({tp0["dir_gib"]:.2f} GiB): saved in {rs["save"]:.2f} s'
              + (f' (returned; written after wait() at {rs["written"]:.2f} s)'
                 if backend == 'orbax_async' else '')
              + f', restored into a fresh TP + ZeRO-3 state in {rs["restore"]:.2f} s at step '
              f'{rs["at"]}; its next step against the unbroken run\'s first timed step: loss '
              f'equal {rs["loss_equal"]}, every gathered parameter bit-equal: rank 0 '
              f'{rs["equal"]}, rank 1 {ranks[1]["tp"]["resumes"][backend]["equal"]}', flush=True)
        check(all(res['tp']['resumes'][backend]['at'] == WARMUP_STEPS
                  and res['tp']['resumes'][backend]['loss_equal']
                  and res['tp']['resumes'][backend]['equal'] for res in ranks),
              f'layouts: the TP state resumed from its \'{backend}\' directory differs from the '
              f'unbroken run')
    for r, res in enumerate(ranks):
        pp = res['pp']
        st = pp['stats']
        print(f'layouts: (b) {smi}: stage {r}: ViT-L/16 trunk over 2 stages, '
              f'{LAYOUT_PP_MICRO} microbatches of {B // LAYOUT_PP_MICRO} tiles of {TILE}², bf16 '
              f'compute: blocks {pp["blocks"][0]}-{pp["blocks"][-1]} ({pp["params"]} parameters, '
              f'{pp["param_bytes"] / 2**20:.1f} MiB); forward + backward of '
              f'sum(x_norm_clstoken²) {pp["ms"]:.1f} ms (one process {pp["plain_ms"]:.1f}); '
              f'hops a run: {st["hops"]:.0f} sent, {st["hop_bytes"] / 2**20:.2f} MiB, '
              f'{st["hop_ms"]:.1f} ms in hops; broadcasts {st["broadcasts"]:.0f} sent, '
              f'{st["broadcast_bytes"] / 2**20:.2f} MiB, {st["broadcast_ms"]:.1f} ms ({backend}); '
              f'against the plain trunk: patch tokens {pp["patch_rel"]:.3e}, input gradient '
              f'{pp["gx_rel"]:.3e}, parameter gradients ||dg||/||g|| {pp["grad_rel"]:.3e}, '
              f'worst cosine {pp["grad_cos"]:.6f}; K1/K2 launches {pp["launches"]} (12 blocks × '
              f'{LAYOUT_PP_MICRO} microbatches: 48 each); {pp["seconds"]:.1f} s', flush=True)
        per = 24 // 2
        check(pp['blocks'] == list(range(r * per, (r + 1) * per)) == pp['block_params'],
              f'layouts: stage {r} holds blocks {pp["block_params"]}')
        check(pp['launches'] == [per * LAYOUT_PP_MICRO] * 2,
              f'layouts: stage {r} launched K1/K2 {pp["launches"]}')
        check(max(pp['patch_rel'], pp['gx_rel'], pp['grad_rel']) <= GRAD_REL_TOL
              and pp['grad_cos'] >= GRAD_COS_MIN,
              f'layouts: the pipeline disagrees with the plain trunk on stage {r}')
    for r, res in enumerate(ranks):
        ep = res['ep']
        worst = max(ep['grad_rel'].values())
        print(f'layouts: (c) {smi}: rank {r}: MoEMlp {LAYOUT_EP} at width {EMBED} on '
              f'{ep["tokens"]} tokens, float32, TF32 off, capacity {ep["capacity"]}: experts '
              f'{ep["first"]}-{ep["first"] + ep["experts"] - 1}; forward + backward '
              f'{ep["ms"]:.1f} ms (one process {ep["plain_ms"]:.1f}); all-reduced over '
              f'\'expert\' {ep["allreduce_bytes"] / 2**20:.1f} MiB a call ({backend}); against '
              f'one process: y {ep["y_rel"]:.3e}, aux {ep["aux"][0]:.6e} vs {ep["aux"][1]:.6e}, '
              f'input gradient {ep["gx_rel"]:.3e}, parameter gradients at most {worst:.3e} '
              f'(limit {EP_REL_TOL}); port kernel launches {ep["launches"]}; '
              f'{ep["seconds"]:.1f} s', flush=True)
        check(ep['experts'] == 4 and ep['first'] == 4 * r, f'layouts: rank {r} experts')
        check(ep['launches'] == 0, f'layouts: expert parallel launched {ep["launches"]} kernels')
        check(max(ep['y_rel'], ep['gx_rel'], worst) <= EP_REL_TOL
              and abs(ep['aux'][0] - ep['aux'][1]) <= EP_REL_TOL * abs(ep['aux'][1]),
              f'layouts: expert parallel disagrees with one process on rank {r}')
    print(f'layouts: {secs:.1f} s in the ranks', flush=True)
    k1 = sum(res['tp']['launches'][0] + res['pp']['launches'][0] for res in ranks)
    k2 = sum(res['tp']['launches'][1] + res['pp']['launches'][1] for res in ranks)
    return k1, k2


# -- phase 23: the spatial layouts ------------------------------------------------------

SPATIAL_STEPS = 2                       # timed bf16 steps a rank, after WARMUP_STEPS
# the first float32 step (TF32 off) against one process on the whole tile:
# total_loss relative, and tests/test_spatial_train.py's limits on every
# parameter and running statistic (allclose: |Δ| <= atol + rtol·|value|)
SPATIAL_LOSS_TOL, SPATIAL_RTOL, SPATIAL_ATOL = 1e-5, 1e-3, 2e-5
# (b): the resolution-preserving conv net at 4096², float32; four 3×3 convs
# (receptive field 9 rows) under a halo of 8
HALO_TILE, HALO_WIDTH, HALO_DEPTH, HALO_ROWS = 4096, 64, 4, 8
HALO_RF_HALF = HALO_DEPTH             # rows at the true border that 'zeros' changes
HALO_TOL = 1e-5                       # |Δ| / max(1, max |value|), float32 sums in other orders
# (d) and (e): the models through the strip forms of GroupNorm, the SE
# squeeze and the GC block's softmax pool, on one SPATIAL_MORE_TILE² tile,
# with (a)'s gates; 1 warm-up and 2 timed bf16 steps a rank.  Their float32
# first step (and (h)'s, below) is also held against one process's float64
# step (max pool by reduce_window: K8 takes no float64): a tensor whose
# float32 one-process value stands more than half (a)'s limit from float64
# (the SE + GC trunk's GC transforms: their LayerNorm over 16 inner
# channels of a pooled context) is held to twice that distance, which two
# float32 roundings no worse than one process's stay within; every other
# tensor to (a)'s limit
SPATIAL_NOISE_FACTOR = 2.0
SPATIAL_MORE = (
    ('FarSeg++-R50', dict(head=dict(relation_type='v2', fs_relation=dict(dropout_rate=0.1),
                                    fpn_decoder=dict(norm='gn')))),
    ('SE+GC FarSeg-R50', dict(encoder=dict(FARSEG['encoder'], se_ratio=16, gc_ratio=1 / 16))))
SPATIAL_MORE_WARMUP, SPATIAL_MORE_STEPS = 1, 2
# (f) DinoSeg ViT-L/16 (vitl16_sat493m: 24 blocks, width 1024, 16 heads, 4
# storage tokens, RoPE with its rescale augmentation) on one
# SPATIAL_MORE_TILE² tile as two strips, AdamW (weight decay 0.05) at a
# constant LR, (a)'s gates on its float32 first step.  Adam's first step
# moves each element by about lr·sign(g): a gradient near 0 whose sign
# float32 rounding flips moves it by 2·lr, so lr is atol / 2, and the
# gradients themselves (left in .grad by the step, DDP's average on the
# ranks) are held to one process's: ||Δg|| / ||g|| at most SPATIAL_GRAD_TOL
SPATIAL_VIT_LR = SPATIAL_ATOL / 2
SPATIAL_GRAD_TOL = 1e-3
SPATIAL_VIT_WARMUP, SPATIAL_VIT_STEPS = 1, 2
# (f) and (g), a user's ViTEncoder ViT-L/16 (4 taps resized to os4-os32, the
# os32 tap by the antialiased halving) under FPN + AssymetricDecoder
# (VITENC_MODEL), on the same tile's strips with the same optimizer, steps
# and gates: (part, name)
SPATIAL_VITS = (('f', 'DinoSeg ViT-L/16 (vitl16_sat493m'),
                ('g', 'ViTEncoder ViT-L/16 + FPN + AssymetricDecoder (VITENC_MODEL'))
# (h) FarSeg-R50 on the folded input (stem='s2d_input', K8 at the stem) on
# one SPATIAL_MORE_TILE² tile folded to [1, 512, 512, 12], and (i) FreeNet at
# its default widths on one scene of SPATIAL_FREENET (rows, columns, bands,
# classes), each as two strips: one float32 step against one process (the
# folded input's against the conv stem's on the unfolded tile), then two
# bf16 steps a rank
SPATIAL_FREENET = (1024, 512, 200, 16)
SPATIAL_LAST = (('h', 'folded-input FarSeg-R50 (stem=\'s2d_input\', K8'),
                ('i', 'FreeNet (no port kernel'))
SPATIAL_LAST_WARMUP, SPATIAL_LAST_STEPS = 1, 1


class SpatialConvNet(torch.nn.Module):
    """``tests/test_spatial.py``'s conv stack widened: ``HALO_DEPTH`` 3×3
    convs of ``HALO_WIDTH`` with bias and ReLU, a 1×1 head of 4; NHWC in
    and out."""

    def __init__(self):
        super().__init__()
        from ever_tpu_torch.module.ops import Conv2d
        self.convs = torch.nn.ModuleList(
            Conv2d(3 if i == 0 else HALO_WIDTH, HALO_WIDTH, 3, bias=True)
            for i in range(HALO_DEPTH))
        self.out = Conv2d(HALO_WIDTH, 4, 1, bias=True)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = torch.relu(conv(x))
        return self.out(x).permute(0, 2, 3, 1)


def spatial_farseg(seed: int, dtype: str, variant: int = -1):
    """Phase 5's FarSeg-R50 (K8 at the stem, 7 classes, SGD momentum 0.9 +
    poly) at ``dtype`` compute on a 2048² tile, or ``SPATIAL_MORE``'s
    ``variant`` on a ``SPATIAL_MORE_TILE``² one, with the weights and the
    tile every process draws from ``seed`` (``'float64'``: float64
    parameters, the max pool by reduce_window): (model, tx, schedule, x,
    y)."""
    from ever_tpu_torch.core.builder import make_model

    gen = torch.Generator(device='cuda').manual_seed(seed + 23 + 10 * (variant + 1))
    cfg, tile = dict(FARSEG, dtype=dtype), SPATIAL_TILE
    if variant >= 0:
        cfg.update(SPATIAL_MORE[variant][1])
        tile = SPATIAL_MORE_TILE
    if dtype == 'float64':
        cfg['encoder'] = dict(cfg['encoder'], maxpool_impl='reduce_window')
    model = make_model({'type': 'FarSeg', 'params': cfg})
    seeded_conv_init_(model, gen)
    if dtype == 'float64':
        model.double()
    x = torch.randn(1, tile, tile, 3, generator=gen, device='cuda')
    y = torch.randint(0, CLASSES, (1, tile, tile), generator=gen, device='cuda')
    return (model, *spatial_sgd(), x, y)


def spatial_sgd() -> tuple:
    """SGD momentum 0.9 and the poly schedule of (a): (tx, schedule)."""
    from ever_tpu_torch.core.builder import make_learningrate, make_optimizer

    schedule = make_learningrate({'type': 'poly', 'params': dict(
        base_lr=0.01, power=0.9, max_iters=1000)})
    tx = make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})[0].build(schedule)
    return tx, schedule


def fold(x: torch.Tensor) -> torch.Tensor:
    """The 2×2 space-to-depth of an NHWC batch, channel ``(dy·2 + dx)·C +
    c`` (``data.SpaceToDepth``'s, what ``stem='s2d_input'`` takes)."""
    b, h, w, c = x.shape
    return (x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, h // 2, w // 2, 4 * c).contiguous())


def spatial_last(seed: int, dtype: str, part: str, unfold: bool = False):
    """``SPATIAL_LAST``'s ``part`` at ``dtype`` compute with SGD as (a):
    (h) FarSeg-R50 with ``stem='s2d_input'`` on a ``SPATIAL_MORE_TILE``²
    tile folded to [1, 512, 512, 12] (``unfold``: the same weights with
    ``stem='conv'`` on the unfolded tile), (i) FreeNet on a seeded
    ``SPATIAL_FREENET`` scene with 5 % of its pixels labelled: (model, tx,
    schedule, x, y), every process drawing the same from ``seed``
    (``'float64'``: float64 parameters, the max pool by reduce_window)."""
    from ever_tpu_torch.core.builder import make_model

    gen = torch.Generator(device='cuda').manual_seed(seed + (28 if part == 'h' else 29))
    if part == 'h':
        encoder = dict(FARSEG['encoder'], stem='conv' if unfold else 's2d_input')
        if dtype == 'float64':
            encoder['maxpool_impl'] = 'reduce_window'
        model = make_model({'type': 'FarSeg', 'params': dict(FARSEG, dtype=dtype,
                                                             encoder=encoder)})
        seeded_conv_init_(model, gen)
        if dtype == 'float64':
            model.double()
        x = torch.randn(1, SPATIAL_MORE_TILE, SPATIAL_MORE_TILE, 3, generator=gen, device='cuda')
        y = torch.randint(0, CLASSES, x.shape[:3], generator=gen, device='cuda')
        x = x if unfold else fold(x)
    else:
        h, w, bands, classes = SPATIAL_FREENET
        model = make_model({'type': 'FreeNet', 'params': dict(in_channels=bands,
                                                              classes=classes, dtype=dtype)})
        seeded_conv_init_(model, gen)
        x, y = freenet_scene(gen, h, w, bands, classes)
    return (model, *spatial_sgd(), x, y)


def spatial_vit(seed: int, part: str = 'f'):
    """``SPATIAL_VITS``'s ``part`` at float32 compute: (f) DinoSeg ViT-L/16,
    (g) the ``VITENC_MODEL`` ZooSeg (``config.dtype`` and the trunk's
    ``remat`` are read at each forward, so one model serves every step of
    the phase), the weights and the tile every process draws from ``seed``,
    and AdamW at ``SPATIAL_VIT_LR``: (model, tx, x, y, a copy of the
    weights)."""
    from ever_tpu_torch.core import registry
    from ever_tpu_torch.core.builder import make_model, make_optimizer

    gen = torch.Generator(device='cuda').manual_seed(seed + (26 if part == 'f' else 27))
    if part == 'f':
        cfg = {'type': 'DinoSeg', 'params': dict(
            backbone=dict(name='vitl16_sat493m'), classes=CLASSES, dtype='float32')}
        with torch.device('cuda'):
            model = make_model(cfg)
        seeded_init_(model, gen)
    else:
        if 'ZooSeg' not in registry.MODEL:
            register_zoo_model()
        model = vitenc_model(gen, 'float32')
    tx = make_optimizer({'type': 'adamw', 'params': dict(weight_decay=0.05)})[0].build(
        SPATIAL_VIT_LR)
    x = torch.randn(1, SPATIAL_MORE_TILE, SPATIAL_MORE_TILE, 3, generator=gen, device='cuda')
    y = torch.randint(0, CLASSES, (1, SPATIAL_MORE_TILE, SPATIAL_MORE_TILE), generator=gen,
                      device='cuda')
    return model, tx, x, y, {k: v.clone() for k, v in model.state_dict().items()}


def fresh_start(model, tx, weights: dict, **settings):
    """``model`` back at ``weights`` with its compute ``dtype`` and its
    trunk's ``remat`` set (``settings``; DinoSeg holds its trunk as
    ``vit`` and reads its own ``dtype``, the ZooSeg's ViTEncoder its own),
    and a fresh train state (step 0: the step's generator draws what it
    drew at the first step)."""
    from ever_tpu_torch.parallel.spmd import create_train_state

    holder = model if hasattr(model, 'vit') else model.encoder
    model.config.dtype = holder.config.dtype = settings.get('dtype', model.config.dtype)
    holder.vit.remat = settings.get('remat', holder.vit.remat)
    model.load_state_dict(weights)
    return create_train_state(model, tx)


def float_state(model) -> dict:
    """The model's floating-point state, where it lies."""
    return {k: v for k, v in model.state_dict().items() if v.is_floating_point()}


def grad_distance(model, ref: dict) -> dict:
    """The model's gradients against ``ref``'s (name → tensor, on the
    model's device): the global ||Δg|| / ||g|| and the worst tensor's."""
    num = den = 0.0
    worst, worst_name = 0.0, ''
    for name, p in model.named_parameters():
        g, w = p.grad.double(), ref[name].double()
        d2, w2 = float(((g - w) ** 2).sum()), float((w ** 2).sum())
        num, den = num + d2, den + w2
        if w2 > 0 and (d2 / w2) ** 0.5 > worst:
            worst, worst_name = (d2 / w2) ** 0.5, name
    return dict(grad_rel=(num / den) ** 0.5, grad_worst=worst, grad_worst_name=worst_name)


def spatial_vit_reference(seed: int, out: str, part: str) -> dict:
    """(f) or (g) (``part``) in one process on the whole tile: the float32
    first step (its loss, state and gradients saved for the ranks), then
    from the same weights the bf16 steps' ms and peak memory above what the
    process held before the model."""
    from ever_tpu_torch.parallel.spmd import build_train_step

    gc.collect()                                    # earlier phases' cycles
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    model, tx, x, y, weights = spatial_vit(seed, part)
    step = build_train_step(model, tx)
    _, ms, metrics = timed_steps(step, fresh_start(model, tx, weights), (x, y), 1)
    torch.save(dict(loss=metrics[0]['total_loss'],
                    state={k: v.cpu() for k, v in float_state(model).items()},
                    grads={k: p.grad.cpu() for k, p in model.named_parameters()}),
               os.path.join(out, f'spatial-ref-{part}.pt'))
    res = dict(f32=dict(ms=ms[0], loss=metrics[0]['total_loss']))
    state = fresh_start(model, tx, weights, dtype='bfloat16')
    del weights
    state, _, _ = timed_steps(step, state, (x, y), SPATIAL_VIT_WARMUP)
    torch.cuda.reset_peak_memory_stats()
    state, ms, metrics = timed_steps(step, state, (x, y), SPATIAL_VIT_STEPS)
    res['bf16'] = dict(ms=ms, peak_gib=(torch.cuda.max_memory_allocated() - held) / 2**30,
                       losses=[m['cls_loss'] for m in metrics])
    del model, state, step, tx, x, y
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def attention_shapes(shapes: set):
    """While entered, the (q, k) shapes of every K1 and K2 launch are added
    to ``shapes`` as ('fwd' or 'bwd', q's shape, k's shape)."""
    from ever_tpu_torch.ops import attention as A

    fwd, bwd = A._launch_fwd, A._launch_bwd

    def rec_fwd(q, k, *args):
        shapes.add(('fwd', tuple(q.shape), tuple(k.shape)))
        return fwd(q, k, *args)

    def rec_bwd(q, k, *args):
        shapes.add(('bwd', tuple(q.shape), tuple(k.shape)))
        return bwd(q, k, *args)

    A._launch_fwd, A._launch_bwd = rec_fwd, rec_bwd
    try:
        yield
    finally:
        A._launch_fwd, A._launch_bwd = fwd, bwd


def spatial_vit_worker(rank: int, seed: int, mesh, out: str, part: str) -> dict:
    """(f) or (g) (``part``) on one rank of two, one model and one step from
    the same weights each time: the float32 first step over the strips
    with ``remat`` None and ``'full'`` (rank 0 holds each against one
    process: loss, state, gradients), then the bf16 steps with the K1 and
    K2 launches and their shapes, the keys and values gathered, ms and peak
    memory above what the process held before the model."""
    from ever_tpu_torch.ops import attention as A
    from ever_tpu_torch.parallel.spatial import build_spatial_train_step

    gc.collect()                                    # earlier models' DDP cycles
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    model, tx, x, y, weights = spatial_vit(seed, part)
    step = build_spatial_train_step(model, tx, mesh=mesh, device='cuda:0')
    # rank 0 compares on the card, the reference read once
    ref = (torch.load(os.path.join(out, f'spatial-ref-{part}.pt'), map_location='cuda:0')
           if rank == 0 else None)
    res = {}
    for remat in (None, 'full'):
        sent = dict(step.stats)
        _, ms, metrics = timed_steps(step, fresh_start(model, tx, weights, remat=remat), (x, y), 1)
        got = float_state(model)
        f32 = res[f'f32-{remat}'] = dict(
            ms=ms[0], loss=metrics[0]['total_loss'], digest=state_digest(got),
            stats={k: v - sent.get(k, 0) for k, v in step.stats.items()})
        if ref is not None:
            f32.update(ref_loss=ref['loss'], tensors=len(ref['state']),
                       **spatial_distances(got, ref['state'], out),
                       **grad_distance(model, ref['grads']))
        del got
    del ref

    state = fresh_start(model, tx, weights, remat=None, dtype='bfloat16')
    del weights
    shapes = set()
    reset_counts()
    with attention_shapes(shapes):
        state, warm, _ = timed_steps(step, state, (x, y), SPATIAL_VIT_WARMUP)
        torch.cuda.reset_peak_memory_stats()
        sent = dict(step.stats)
        state, ms, metrics = timed_steps(step, state, (x, y), SPATIAL_VIT_STEPS)
    res['bf16'] = dict(
        ms=warm + ms, metrics=metrics, steps=SPATIAL_VIT_WARMUP + SPATIAL_VIT_STEPS,
        launches=[A.fused_attention.launches, A.fused_attention_bwd.launches],
        all_launches=sum(fn.launches for fn in kernel_wrappers()),
        shapes=sorted(list(t) for t in shapes),
        peak_gib=(torch.cuda.max_memory_allocated() - held) / 2**30,
        gathers=(step.stats['gathers'] - sent['gathers']) / SPATIAL_VIT_STEPS,
        gather_bytes=(step.stats['gather_bytes'] - sent['gather_bytes']) / SPATIAL_VIT_STEPS,
        hops=(step.stats['hops'] - sent['hops']) / SPATIAL_VIT_STEPS,
        float32=all(p.dtype == torch.float32 for p in model.parameters()))
    del model, state, step, tx, x, y
    torch.cuda.empty_cache()
    return res


def spatial_convnet(seed: int):
    """(b)'s net with seeded weights, its 4096² tile and target, and SGD
    momentum 0.9 at 0.05."""
    from ever_tpu_torch.core.builder import make_optimizer

    gen = torch.Generator(device='cuda').manual_seed(seed + 24)
    net = SpatialConvNet().cuda()
    seeded_conv_init_(net, gen)
    x = torch.randn(1, HALO_TILE, HALO_TILE, 3, generator=gen, device='cuda')
    t = torch.randn(1, HALO_TILE, HALO_TILE, generator=gen, device='cuda')
    tx = make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})[0].build(0.05)
    return net, x, t, tx


def mse(out, target):
    return ((out - target[..., None]) ** 2).mean()


def timed_steps(step, state, batch, n: int) -> tuple:
    """``n`` steps, each timed to its end on the card: (state, ms, metrics)."""
    ms, metrics = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, ms, metrics


def one_process_steps(make, out: str, key: str, warmup: int, steps: int,
                      unfold: bool = False) -> tuple:
    """One process on the whole tile of ``make(dtype)`` (model, tx,
    schedule, x, y): the float32 first step (its loss and floating-point
    state saved as ``spatial-ref{key}.pt``; with ``unfold``, of
    ``make('float32', unfold=True)``: (h)'s conv stem on the unfolded tile), then
    ``warmup`` and ``steps`` bf16 steps: their ms and peak memory above what
    the process held before the model, collected first."""
    from ever_tpu_torch.parallel.spmd import build_train_step, create_train_state

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True              # as the ranks run
    model, tx, schedule, x, y = make('float32', unfold=True) if unfold else make('float32')
    state, ms, metrics = timed_steps(build_train_step(model, tx, schedule),
                                     create_train_state(model, tx), (x, y), 1)
    torch.backends.cudnn.deterministic = deterministic
    torch.save(dict(loss=metrics[0]['total_loss'],
                    state={k: v.cpu() for k, v in float_state(model).items()}),
               os.path.join(out, f'spatial-ref{key}.pt'))
    f32 = dict(ms=ms[0], loss=metrics[0]['total_loss'])
    del model, state, x, y
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    model, tx, schedule, x, y = make('bfloat16')
    step = build_train_step(model, tx, schedule)
    state, _, _ = timed_steps(step, create_train_state(model, tx), (x, y), warmup)
    torch.cuda.reset_peak_memory_stats()
    state, ms, metrics = timed_steps(step, state, (x, y), steps)
    bf16 = dict(ms=ms, peak_gib=(torch.cuda.max_memory_allocated() - held) / 2**30,
                losses=[m['cls_loss'] for m in metrics])
    del model, state, step, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return f32, bf16


def float64_step(make, out: str, key: str) -> None:
    """One process's float64 first step of ``make()`` (model, tx, schedule,
    x, y; the max pool by reduce_window: K8 takes no float64), its state
    saved as ``spatial-ref64{key}.pt`` (``SPATIAL_NOISE_FACTOR``)."""
    from ever_tpu_torch.parallel.spmd import build_train_step, create_train_state

    model, tx, schedule, x, y = make()
    build_train_step(model, tx, schedule)(create_train_state(model, tx), (x, y))
    torch.save({k: v.cpu() for k, v in float_state(model).items()},
               os.path.join(out, f'spatial-ref64{key}.pt'))
    del model, x, y
    torch.cuda.empty_cache()


def spatial_reference(seed: int, out: str) -> dict:
    """One process on the whole tiles: the float32 first step of FarSeg-R50
    and of (d)-(i) (their states saved for the ranks; (d), (e) and (h) also
    in float64), the bf16 steps' ms and peak memory, and (b)'s whole forward
    and one unsharded SGD step (saved)."""
    t_start = time.perf_counter()
    res = {}
    for variant in range(-1, len(SPATIAL_MORE)):
        key = '' if variant < 0 else f'-{variant}'
        warmup, steps = ((WARMUP_STEPS, SPATIAL_STEPS) if variant < 0
                         else (SPATIAL_MORE_WARMUP, SPATIAL_MORE_STEPS))
        res[f'f32{key}'], res[f'bf16{key}'] = one_process_steps(
            functools.partial(spatial_farseg, seed, variant=variant), out, key, warmup, steps)
        if variant >= 0:
            float64_step(functools.partial(spatial_farseg, seed, 'float64', variant), out, key)
    for part, _ in SPATIAL_VITS:
        res[part] = spatial_vit_reference(seed, out, part)
    for part, _ in SPATIAL_LAST:
        res[f'f32-{part}'], res[f'bf16-{part}'] = one_process_steps(
            functools.partial(spatial_last, seed, part=part), out, f'-{part}',
            SPATIAL_LAST_WARMUP, SPATIAL_LAST_STEPS, unfold=part == 'h')
    float64_step(functools.partial(spatial_last, seed, 'float64', 'h', unfold=True), out, '-h')

    net, x, t, tx = spatial_convnet(seed)
    with torch.no_grad():
        whole = net(x)
    torch.save(whole.cpu(), os.path.join(out, 'spatial-whole.pt'))
    del whole
    opt = tx.init(net.named_parameters())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mse(net(x), t).backward()
    tx.apply(opt, 0)
    torch.cuda.synchronize()
    res['halo_ms'] = (time.perf_counter() - t0) * 1e3
    torch.save({k: v.detach().cpu() for k, v in net.named_parameters()},
               os.path.join(out, 'spatial-halo-ref.pt'))
    del net, opt, x, t
    torch.cuda.empty_cache()
    res['seconds'] = time.perf_counter() - t_start
    return res


def spatial_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got − want| / (``SPATIAL_ATOL`` + ``SPATIAL_RTOL``·|want|)."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (SPATIAL_ATOL + SPATIAL_RTOL * want.abs())).max())


def spatial_distances(got: dict, one: dict, out: str, key: str = None) -> dict:
    """The spatial step's float32 state ``got`` against one process's
    ``one``, tensor by tensor: the worst ratio (limit 1) and the largest
    |Δ|; for (d) and (e) also each tensor's limit from the float64 step
    (``SPATIAL_NOISE_FACTOR``): one process's and the spatial step's worst
    ratio against float64, and the worst share of its limit (``worst``,
    the gate: at most 1)."""
    res = dict(worst=0.0, worst_name='', max_abs=0.0, plain=0.0, plain_name='')
    exact = torch.load(os.path.join(out, f'spatial-ref64{key}.pt')) if key else None
    if exact is not None:
        res.update(one64=0.0, one64_name='', strips64=0.0, widened=0)
    for k, w in one.items():
        plain = spatial_ratio(got[k], w)
        res['max_abs'] = max(res['max_abs'], float((got[k] - w).abs().max()))
        if plain > res['plain']:
            res.update(plain=plain, plain_name=k)
        limit = 1.0
        if exact is not None:
            one64 = spatial_ratio(w, exact[k])
            res['strips64'] = max(res['strips64'], spatial_ratio(got[k], exact[k]))
            if one64 > res['one64']:
                res.update(one64=one64, one64_name=k)
            limit = max(1.0, SPATIAL_NOISE_FACTOR * one64)
            res['widened'] += limit > 1.0
        if plain / limit > res['worst']:
            res.update(worst=plain / limit, worst_name=k)
    return res


def strip_steps(make, mesh, rank: int, out: str, key: str, warmup: int, steps: int,
                wide: bool = False) -> tuple:
    """One rank's steps over the strips of ``make(dtype)`` (model, tx,
    schedule, x, y): the float32 first step (rank 0 holds it against one
    process's ``spatial-ref{key}.pt``; ``wide``: with the limits its
    float64 step sets, (d), (e) and (h)), then ``warmup`` and ``steps`` bf16 steps with their
    K8 and port kernel launches, halo hops and bytes, and the peak memory
    above what the process held before the model, read after a collection
    (DDP's wrapper holds reference cycles: without one the float32 model,
    its gradients and its momentum would still be counted as held):
    (f32, bf16)."""
    from ever_tpu_torch.ops import pool as P
    from ever_tpu_torch.parallel.spatial import build_spatial_train_step
    from ever_tpu_torch.parallel.spmd import create_train_state

    model, tx, schedule, x, y = make('float32')
    step = build_spatial_train_step(model, tx, schedule, mesh=mesh, device='cuda:0')
    state, ms, metrics = timed_steps(step, create_train_state(model, tx), (x, y), 1)
    got = {k: v.cpu() for k, v in float_state(model).items()}
    f32 = dict(ms=ms[0], loss=metrics[0]['total_loss'], digest=state_digest(got))
    if rank == 0:
        ref = torch.load(os.path.join(out, f'spatial-ref{key}.pt'))
        f32.update(ref_loss=ref['loss'], tensors=len(ref['state']),
                   **spatial_distances(got, ref['state'], out, key if wide else None))
    del model, state, step, x, y, got
    gc.collect()
    torch.cuda.empty_cache()

    held = torch.cuda.memory_allocated()
    model, tx, schedule, x, y = make('bfloat16')
    step = build_spatial_train_step(model, tx, schedule, mesh=mesh, device='cuda:0')
    reset_counts()
    state, warm, _ = timed_steps(step, create_train_state(model, tx), (x, y), warmup)
    torch.cuda.reset_peak_memory_stats()
    sent = dict(step.stats)
    state, ms, metrics = timed_steps(step, state, (x, y), steps)
    bf16 = dict(
        ms=warm + ms, metrics=metrics, launches=P.max_pool_32_bwd.launches,
        all_launches=sum(fn.launches for fn in kernel_wrappers()), steps=warmup + steps,
        peak_gib=(torch.cuda.max_memory_allocated() - held) / 2**30,
        hops=(step.stats['hops'] - sent['hops']) / steps,
        bytes=(step.stats['bytes'] - sent['bytes']) / steps,
        float32=all(p.dtype == torch.float32 for p in model.parameters()))
    del model, state, step, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return f32, bf16


def unfolded_step(seed: int, mesh) -> dict:
    """(h)'s weights with ``stem='conv'``: one float32 step over the strips
    of the unfolded tile, its loss and state digest."""
    from ever_tpu_torch.parallel.spatial import build_spatial_train_step
    from ever_tpu_torch.parallel.spmd import create_train_state

    model, tx, schedule, x, y = spatial_last(seed, 'float32', 'h', unfold=True)
    step = build_spatial_train_step(model, tx, schedule, mesh=mesh, device='cuda:0')
    _, _, metrics = timed_steps(step, create_train_state(model, tx), (x, y), 1)
    res = dict(loss=metrics[0]['total_loss'],
               digest=state_digest({k: v.cpu() for k, v in float_state(model).items()}))
    del model, step, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return res


def spatial_worker(rank: int, out: str) -> dict:
    """One of two gloo ranks of the spatial phase on ``make_mesh(('data',))``:
    (a) FarSeg-R50's, (d) FarSeg++-R50's and (e) the SE + GC FarSeg-R50's
    float32 first step and bf16 steps over the tile's two row strips, (f)
    DinoSeg ViT-L/16's and (g) ViTEncoder + FPN's
    (:func:`spatial_vit_worker`), (h) the folded-input FarSeg-R50's (and
    the same weights' conv-stem step on the unfolded tile) and (i)
    FreeNet's, (b) ``spatial_partition_apply`` and
    ``build_halo_train_step`` of the conv net at 4096²."""
    from ever_tpu_torch.parallel.mesh import make_mesh
    from ever_tpu_torch.parallel.spatial import build_halo_train_step, spatial_partition_apply

    with open(os.path.join(out, 'spatial-spec.json')) as f:
        seed = json.load(f)['seed']
    mesh = make_mesh(('data',))
    res = {}
    for variant in range(-1, len(SPATIAL_MORE)):
        key = '' if variant < 0 else f'-{variant}'
        warmup, steps = ((WARMUP_STEPS, SPATIAL_STEPS) if variant < 0
                         else (SPATIAL_MORE_WARMUP, SPATIAL_MORE_STEPS))
        res[f'f32{key}'], res[f'bf16{key}'] = strip_steps(
            functools.partial(spatial_farseg, seed, variant=variant), mesh, rank, out, key,
            warmup, steps, wide=variant >= 0)
    for part, _ in SPATIAL_VITS:
        res[part] = spatial_vit_worker(rank, seed, mesh, out, part)
    for part, _ in SPATIAL_LAST:
        res[f'f32-{part}'], res[f'bf16-{part}'] = strip_steps(
            functools.partial(spatial_last, seed, part=part), mesh, rank, out, f'-{part}',
            SPATIAL_LAST_WARMUP, SPATIAL_LAST_STEPS, wide=part == 'h')
    res['f32-h']['unfolded'] = unfolded_step(seed, mesh)

    net, x, t, tx = spatial_convnet(seed)
    h = HALO_TILE // 2
    rows = slice(rank * h, (rank + 1) * h)
    whole = torch.load(os.path.join(out, 'spatial-whole.pt'))[:, rows].cuda()
    top = max(HALO_RF_HALF - rank * h, 0)
    bottom = h - max(rank * h + h - (HALO_TILE - HALO_RF_HALF), 0)
    with torch.no_grad():
        for boundary in ('exact', 'zeros'):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = spatial_partition_apply(net, x, mesh, 'data', HALO_ROWS, boundary,
                                          device='cuda:0').to_local()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            scale = max(1.0, float(whole.abs().max()))
            inner = float((got - whole)[:, top:bottom].abs().max()) / scale
            res[f'partition_{boundary}'] = dict(
                ms=ms, shape=list(got.shape), inner=inner,
                all=float((got - whole).abs().max()) / scale)
            del got
    del whole
    params = dict(net.named_parameters())
    step = build_halo_train_step(lambda p, a: torch.func.functional_call(net, p, (a,)), mse,
                                 tx, mesh, halo=HALO_ROWS, device='cuda:0')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (it, params, _), m = step((0, params, tx.init(params.items())), (x, t))
    torch.cuda.synchronize()
    ref = torch.load(os.path.join(out, 'spatial-halo-ref.pt'))
    res['halo_step'] = dict(ms=(time.perf_counter() - t0) * 1e3, step=it,
                            loss=float(m['total_loss']), stats=dict(step.stats),
                            diff=max(float((params[k].detach().cpu() - w).abs().max())
                                     / max(1.0, float(w.abs().max())) for k, w in ref.items()))
    return res


def spatial_eda(seed: int, out: str) -> dict:
    """(c) ``util.eda`` on PNGs the phase writes: a 2048² RGB scene's
    thumbnail, a constant grey one's, and three overlapping 512² masks."""
    import numpy as np

    from ever_tpu_torch.data._png import write_png
    from ever_tpu_torch.util import eda

    rng = np.random.default_rng(seed)
    ramp = np.add.outer(np.linspace(0, 120, 2048), np.linspace(0, 100, 2048))[..., None]
    scene = np.clip(ramp * np.array([0.5, 0.8, 1.0]) + rng.normal(scale=20, size=(2048, 2048, 3)),
                    0, 255).astype(np.uint8)
    write_png(os.path.join(out, 'scene.png'), scene)
    write_png(os.path.join(out, 'grey.png'), np.full((1000, 700), 77, np.uint8))
    paths = []
    for i in range(3):
        path = os.path.join(out, f'mask{i}.png')
        write_png(path, np.where(rng.random((512, 512)) < 0.3, 255, 0).astype(np.uint8))
        paths.append(path)
    t0 = time.perf_counter()
    thumb = eda.thumbnail(os.path.join(out, 'scene.png'), 0.1)
    ms = (time.perf_counter() - t0) * 1e3
    grey = eda.thumbnail(os.path.join(out, 'grey.png'), 0.37)
    indices, palette = eda.render_multi_binary_mask(paths, [1, 2, 3],
                                                    [0, 0, 0, 255, 0, 0, 0, 255, 0, 0, 0, 255])
    first = np.asarray(eda._imread(paths[0])) == 255
    return dict(thumb=list(thumb.shape), thumb_ms=ms, grey=list(grey.shape),
                grey_values=sorted(set(np.unique(grey).tolist())),
                indices=list(indices.shape), classes=sorted(np.unique(indices).tolist()),
                palette=list(palette.shape), first_wins=bool((indices[first] == 1).all()))


def phase_spatial_vit(smi: str, ref: dict, ranks: list, part: str, name: str) -> tuple:
    """(f)'s or (g)'s (``part``, the model ``name``) gates and numbers
    (module docstring, phase 23) from one process's ``ref`` and the ranks'
    results; returns the ranks' K1 and K2 launches."""
    tile, backend = SPATIAL_MORE_TILE, 'gloo, 2 ranks sharing one card'
    per_block = H * (STRIP_Q - 5) * 2 * D
    for remat in (None, 'full'):
        f32, other = ranks[0][part][f'f32-{remat}'], ranks[1][part][f'f32-{remat}']
        st = f32['stats']
        print(f'spatial: ({part}) {smi}: {name}, 24 blocks, 7 classes, '
              f'AdamW at {SPATIAL_VIT_LR}) on one {tile}² tile as two strips of {tile // 2} '
              f'rows ({STRIP_Q} queries a rank against {STRIP_KV} keys), float32, TF32 off, '
              f'remat={remat!r}: the first step against one process on the whole tile: '
              f'total_loss {f32["loss"]:.7f} vs {f32["ref_loss"]:.7f} (limit '
              f'{SPATIAL_LOSS_TOL} relative); {f32["tensors"]} parameters, worst |Δ| / '
              f'({SPATIAL_ATOL} + {SPATIAL_RTOL}·|value|) {f32["plain"]:.3e} '
              f'({f32["plain_name"]}), largest |Δ| {f32["max_abs"]:.3e}; gradients '
              f'||Δg||/||g|| {f32["grad_rel"]:.3e} (limit {SPATIAL_GRAD_TOL}), worst tensor '
              f'{f32["grad_worst"]:.3e} ({f32["grad_worst_name"]}); the ranks\' states '
              f'equal: {f32["digest"] == other["digest"]}; keys and values gathered: '
              f'{st["gathers"]} broadcasts sent ({st["gather_bytes"] / 2**20:.2f} MiB) in the '
              f'forward, {st.get("remat_gathers", 0)} '
              f'({st.get("remat_gather_bytes", 0) / 2**20:.2f} MiB) in the recomputation; '
              f'halo hops {st["hops"]}; step {f32["ms"]:.1f} ms (one process '
              f'{ref[part]["f32"]["ms"]:.1f})', flush=True)
        check(abs(f32['loss'] - f32['ref_loss']) <= SPATIAL_LOSS_TOL * abs(f32['ref_loss']),
              f'spatial: ({part}) remat={remat}: the first step\'s loss differs from one process')
        check(f32['plain'] <= 1.0 and f32['grad_rel'] <= SPATIAL_GRAD_TOL,
              f'spatial: ({part}) remat={remat}: the first step differs from one process')
        check(f32['digest'] == other['digest'], f'spatial: ({part}) remat={remat}: the ranks\' '
              'states differ')
        check(st['gathers'] == 24 and st['gather_bytes'] == 24 * per_block * 4
              and st.get('remat_gathers', 0) == (24 if remat else 0),
              f'spatial: ({part}) remat={remat}: gathers {st}')
    one = sorted(ref[part]['bf16']['ms'])
    want = sorted([['bwd', [1, STRIP_Q, H, D], [1, STRIP_KV, H, D]],
                   ['fwd', [1, STRIP_Q, H, D], [1, STRIP_KV, H, D]]])
    k1 = k2 = 0
    for r, res in enumerate(ranks):
        bf = res[part]['bf16']
        steady = sorted(bf['ms'][SPATIAL_VIT_WARMUP:])
        print(f'spatial: ({part}) {smi}: {name.split(" (")[0]}: rank {r}: bf16 compute, float32 '
              f'parameters: ms/step {" ".join(f"{t:.1f}" for t in bf["ms"])} (timed median '
              f'{steady[len(steady) // 2]:.1f}; one process on the whole tile '
              f'{one[len(one) // 2]:.1f}); losses '
              f'{" ".join(f"{m["cls_loss"]:.5f}" for m in bf["metrics"])}; keys and values '
              f'gathered a step: {bf["gathers"]:.0f} broadcasts sent, '
              f'{bf["gather_bytes"] / 2**20:.2f} MiB; halo hops {bf["hops"]:.0f}; peak memory '
              f'above what the process held before {bf["peak_gib"]:.2f} GiB (one process '
              f'{ref[part]["bf16"]["peak_gib"]:.2f}); K1 and K2 launches {bf["launches"]} in '
              f'{bf["steps"]} steps at q, k shapes {bf["shapes"]}; all port kernels '
              f'{bf["all_launches"]} ({backend})', flush=True)
        check(bf['launches'] == [24 * bf['steps']] * 2 and bf['all_launches'] == 48 * bf['steps'],
              f'spatial: ({part}) rank {r} launched K1, K2 {bf["launches"]} times and all port '
              f'kernels {bf["all_launches"]} in {bf["steps"]} steps')
        check(bf['shapes'] == want, f'spatial: ({part}) rank {r}: K1/K2 shapes {bf["shapes"]}')
        check(all(math.isfinite(m['cls_loss']) and math.isfinite(m['grad_norm'])
                  for m in bf['metrics']), f'spatial: ({part}) rank {r}: non-finite metrics')
        check(bf['float32'] and bf['gathers'] == 24, f'spatial: ({part}) rank {r}: parameters '
              f'left float32, 24 gathers a step')
        k1, k2 = k1 + bf['launches'][0], k2 + bf['launches'][1]
    return k1, k2


def phase_spatial(seed: int, smi: str, ref: dict, parallel: list) -> tuple:
    """The spatial layouts (module docstring, phase 23): one process's
    references ``ref`` (:func:`spatial_reference`), the parallel phases'
    ranks' results (:func:`start_parallel`), then ``util.eda``.  Returns
    the ranks' K1, K2 and K8 launches."""
    import tempfile

    ranks, secs = [r['spatial'] for r in parallel], parallel[0]['seconds']['spatial']
    with tempfile.TemporaryDirectory(prefix='chip_smoke_eda_') as tmp:
        eda = spatial_eda(seed, tmp)
    backend = 'gloo, 2 ranks sharing one card: correctness and bytes moved, not a multi-card speed'
    more = f'one {SPATIAL_MORE_TILE}² tile'
    rows, cols, bands, classes = SPATIAL_FREENET
    farsegs = ([('a', '', f'FarSeg-R50 (K8, {CLASSES} classes', f'one {SPATIAL_TILE}² tile',
                 False)]
               + [(part, f'-{v}', f'{SPATIAL_MORE[v][0]} (K8, {CLASSES} classes', more, True)
                  for v, part in zip(range(len(SPATIAL_MORE)), 'de')])
    last = [('h', '-h', f'{SPATIAL_LAST[0][1]}, {CLASSES} classes',
             f'{more} folded to [1, {SPATIAL_MORE_TILE // 2}, {SPATIAL_MORE_TILE // 2}, 12]',
             True),
            ('i', '-i', f'{SPATIAL_LAST[1][1]}, {classes} classes',
             f'one {rows}×{cols} scene of {bands} bands', False)]
    k1 = k2 = k8 = 0

    def report(part, key, name, where, wide) -> int:
        """A conv net's gates and numbers; returns its K8 launches."""
        launched = 0
        f32 = ranks[0][f'f32{key}']
        noise = ('' if not wide else
                 f'; against one process\'s float64 step: one float32 process\'s worst ratio '
                 f'{f32["one64"]:.3e} ({f32["one64_name"]}), the spatial step\'s '
                 f'{f32["strips64"]:.3e}; {f32["widened"]} tensors held to '
                 f'{SPATIAL_NOISE_FACTOR} × one process\'s distance from float64 (over '
                 f'half the limit), the worst share of its limit {f32["worst"]:.3e} '
                 f'({f32["worst_name"]}), limit 1')
        if part == 'h':
            unfolded = f32['unfolded']
            noise += (f'; the same weights\' stem=\'conv\' step over the strips of the unfolded '
                      f'tile: total_loss {unfolded["loss"]:.7f}, the state equal: '
                      f'{unfolded["digest"] == f32["digest"]}')
        print(f'spatial: ({part}) {smi}: {name}, SGD momentum 0.9 + poly) on {where} as two '
              f'strips, float32, TF32 off: the first step against one process on the whole '
              f'{"unfolded tile with stem=conv" if part == "h" else "tile"}: total_loss '
              f'{f32["loss"]:.7f} vs {f32["ref_loss"]:.7f} (limit {SPATIAL_LOSS_TOL} relative); '
              f'{f32["tensors"]} parameters and running statistics, worst |Δ| / '
              f'({SPATIAL_ATOL} + {SPATIAL_RTOL}·|value|) {f32["plain"]:.3e} '
              f'({f32["plain_name"]}), largest |Δ| {f32["max_abs"]:.3e}{noise}; the ranks\' '
              f'states equal: {f32["digest"] == ranks[1][f"f32{key}"]["digest"]}; step '
              f'{f32["ms"]:.1f} ms (one process {ref[f"f32{key}"]["ms"]:.1f})', flush=True)
        check(abs(f32['loss'] - f32['ref_loss']) <= SPATIAL_LOSS_TOL * abs(f32['ref_loss']),
              f'spatial: ({part}) the first step\'s loss differs from one process')
        check(f32['worst'] <= 1.0,
              f'spatial: ({part}) the first step\'s state differs from one process')
        check(f32['digest'] == ranks[1][f'f32{key}']['digest'],
              f'spatial: ({part}) the ranks\' states differ')
        if part == 'h':
            check(all(res['f32-h']['unfolded'] == {'loss': res['f32-h']['loss'],
                                                    'digest': res['f32-h']['digest']}
                      for res in ranks),
                  'spatial: (h) the folded input\'s step differs from the conv stem\'s on the '
                  'unfolded tile')
        one = sorted(ref[f'bf16{key}']['ms'])
        for r, res in enumerate(ranks):
            bf = res[f'bf16{key}']
            warmup = bf['steps'] - len(one)
            steady = sorted(bf['ms'][warmup:])
            print(f'spatial: ({part}) {smi}: {name.split(" (")[0]}: rank {r}: bf16 compute, '
                  f'float32 parameters: ms/step {" ".join(f"{t:.1f}" for t in bf["ms"])} (timed '
                  f'median {steady[len(steady) // 2]:.1f}; one process on the whole tile '
                  f'{one[len(one) // 2]:.1f}); losses '
                  f'{" ".join(f"{m["cls_loss"]:.5f}" for m in bf["metrics"])}; grad_norm '
                  f'{" ".join(f"{m["grad_norm"]:.4f}" for m in bf["metrics"])}; halo hops sent '
                  f'a step {bf["hops"]:.0f}, {bf["bytes"] / 2**20:.2f} MiB; peak memory above '
                  f'what the process held before {bf["peak_gib"]:.2f} GiB (one process '
                  f'{ref[f"bf16{key}"]["peak_gib"]:.2f}, ratio '
                  f'{bf["peak_gib"] / ref[f"bf16{key}"]["peak_gib"]:.2f}); K8 launches '
                  f'{bf["launches"]} in {bf["steps"]} steps, all port kernels '
                  f'{bf["all_launches"]} ({backend})', flush=True)
            want = 0 if part == 'i' else bf['steps']
            check(bf['launches'] == want == bf['all_launches'],
                  f'spatial: ({part}) rank {r} launched K8 {bf["launches"]} times and all port '
                  f'kernels {bf["all_launches"]} in {bf["steps"]} steps')
            check(all(math.isfinite(m['cls_loss']) and math.isfinite(m['grad_norm'])
                      for m in bf['metrics']), f'spatial: ({part}) rank {r}: non-finite metrics')
            check(bf['float32'], f'spatial: ({part}) parameters left float32')
            launched += bf['launches']
        return launched

    for model in farsegs:
        k8 += report(*model)
    for vit, vit_name in SPATIAL_VITS:
        l1, l2 = phase_spatial_vit(smi, ref, ranks, vit, vit_name)
        k1, k2 = k1 + l1, k2 + l2
    for model in last:
        k8 += report(*model)
    for r, res in enumerate(ranks):
        ex, zs, hs = res['partition_exact'], res['partition_zeros'], res['halo_step']
        print(f'spatial: (b) {smi}: rank {r}: {HALO_DEPTH} 3×3 convs of {HALO_WIDTH} + 1×1 on '
              f'a {HALO_TILE}² float32 tile, halo {HALO_ROWS}: spatial_partition_apply '
              f'\'exact\' {ex["shape"]} in {ex["ms"]:.1f} ms, against the whole forward '
              f'{ex["all"]:.3e}; \'zeros\' {zs["ms"]:.1f} ms, {zs["inner"]:.3e} off the true '
              f'border ({zs["all"]:.3e} with it); build_halo_train_step: loss {hs["loss"]:.6f}, '
              f'parameters against one process\'s step {hs["diff"]:.3e} (limit {HALO_TOL}); '
              f'{hs["ms"]:.1f} ms (one process {ref["halo_ms"]:.1f}); hops '
              f'{hs["stats"]["hops"]}, {hs["stats"]["bytes"] / 2**20:.2f} MiB', flush=True)
        check(ex['all'] <= HALO_TOL and zs['inner'] <= HALO_TOL and hs['diff'] <= HALO_TOL
              and hs['step'] == 1, f'spatial: (b) disagrees with the whole tile on rank {r}')
    print(f'spatial: (c) util.eda without PIL: thumbnail of a 2048² RGB PNG at 0.1 '
          f'{eda["thumb"]} in {eda["thumb_ms"]:.1f} ms; of a constant 1000×700 grey PNG at 0.37 '
          f'{eda["grey"]} of values {eda["grey_values"]}; render_multi_binary_mask of three '
          f'512² masks: indices {eda["indices"]} of classes {eda["classes"]}, palette '
          f'{eda["palette"]}, the first mask wins its pixels {eda["first_wins"]}', flush=True)
    check(eda['thumb'] == [204, 204, 3] and eda['grey'] == [370, 259]
          and eda['grey_values'] == [77] and eda['indices'] == [512, 512]
          and eda['classes'] == [0, 1, 2, 3] and eda['palette'] == [4, 3] and eda['first_wins'],
          'spatial: util.eda gave other shapes or values')
    print(f'spatial: {smi}: references {ref["seconds"]:.1f} s, {secs:.1f} s in the ranks',
          flush=True)
    return k1, k2, k8


def start_parallel(seed: int) -> dict:
    """Phases 20-23 (gan, zero, layouts, spatial), whose gloo ranks are one
    pair of processes started once (``--ddp-worker parallel``: each phase's
    worker in turn) after the spatial phase's one-process references, and
    left running while this process goes on with the serial phases
    (:func:`finish_parallel` collects them)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix='chip_smoke_parallel_')
    try:
        cfg = gan_config(tmp, seed)
        for job, spec in (('gan', dict(config=cfg)), ('zero', dict(seed=seed)),
                          ('layouts', dict(seed=seed)), ('spatial', dict(seed=seed))):
            with open(os.path.join(tmp, f'{job}-spec.json'), 'w') as f:
                json.dump(spec, f)
        ref = spatial_reference(seed, tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    gc.collect()
    torch.cuda.empty_cache()                 # the ranks share the card from here
    return dict(tmp=tmp, cfg=cfg, ref=ref, t0=t0, workers=start_ddp_workers('parallel', tmp, PARALLEL_TIMEOUT))


def stop_parallel(started: dict) -> None:
    """Kill the parallel phases' ranks if they still run and remove their
    directory."""
    import shutil

    stop_ddp_workers(started['workers'])
    shutil.rmtree(started['tmp'], ignore_errors=True)


def finish_parallel(started: dict, seed: int, smi: str, bare_ms: float) -> tuple:
    """Wait for the parallel phases' ranks and read them phase by phase
    (:func:`stop_parallel` removes what they wrote).  Returns the K1, K2
    and K8 launches of their main paths."""
    t_wait = time.perf_counter()
    ranks, secs = wait_ddp_workers(started['workers'])
    print(f'parallel phases: {smi}: the ranks of gan, zero, layouts and spatial started '
          f'once, beside the serial phases from models on; joined {secs:.1f} s after '
          f'their start, of which this process waited {time.perf_counter() - t_wait:.1f} '
          f's; in the ranks '
          + ', '.join(f'{k} {v:.1f} s' for k, v in ranks[0]['seconds'].items()), flush=True)
    phase_gan(seed, smi, started['tmp'], started['cfg'], ranks)
    k1, k2 = phase_zero(smi, ranks)
    l1, l2 = phase_layouts(smi, bare_ms, ranks)
    s1, s2, k8 = phase_spatial(seed, smi, started['ref'], ranks)
    print(f'parallel phases: {smi}: wall time {time.perf_counter() - started["t0"]:.1f} s '
          f'from the references to the last check', flush=True)
    return k1 + l1 + s1, k2 + l2 + s2, k8


def side_phases(seed: int, smi: str, profile: bool, out: str) -> int:
    """The phases zoo, backbones, vitencoder and freenet in a process of
    their own (``chip_smoke.py --side OUT``), beside this script's serial
    phases from models on and the parallel phases' ranks: each phase as it
    runs in one process, on a generator of its own seeded with ``seed``.
    Writes their K1, K2, K7 and K8 launches to ``OUT/side.json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(seed)
    k8 = phase_zoo(gen, seed, smi, profile)
    phase_backbones(gen, seed, smi, profile)
    k1, k2, k7 = phase_vitencoder(gen, smi, profile)
    phase_freenet(gen, seed, smi)
    with open(os.path.join(out, 'side.json'), 'w') as f:
        json.dump(dict(k1=k1, k2=k2, k7=k7, k8=k8), f)
    return 0


def start_side(seed: int, smi: str, profile: bool) -> dict:
    """Start :func:`side_phases` in a process of its own, its output to a
    file that :func:`finish_side` prints."""
    import tempfile

    out = tempfile.mkdtemp(prefix='chip_smoke_side_')
    log = open(os.path.join(out, 'side.log'), 'w+')
    cmd = [sys.executable, os.path.abspath(__file__), '--seed', str(seed), '--side', out, smi]
    if profile:
        cmd.append('--profile')
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return dict(out=out, log=log, proc=proc, t0=time.perf_counter())


def finish_side(started: dict) -> dict:
    """Wait for the side phases, print their output, and return their
    launches; fails with their output when the process fails."""
    proc, log = started['proc'], started['log']
    t_wait = time.perf_counter()
    try:
        proc.wait(timeout=max(1.0, PARALLEL_TIMEOUT - (time.perf_counter() - started['t0'])))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    log.seek(0)
    text = log.read()
    log.close()
    print(text, end='' if text.endswith('\n') else '\n', flush=True)
    check(proc.returncode == 0, f'the side phases exited {proc.returncode}')
    with open(os.path.join(started['out'], 'side.json')) as f:
        launches = json.load(f)
    print(f'side phases: zoo, backbones, vitencoder and freenet in a process of their own: '
          f'{time.perf_counter() - started["t0"]:.1f} s from their start, of which this process '
          f'waited {time.perf_counter() - t_wait:.1f} s', flush=True)
    return launches


def stop_side(started: dict) -> None:
    """Kill the side process if it still runs and remove its directory."""
    import shutil

    if started['proc'].poll() is None:
        started['proc'].kill()
    started['proc'].wait()
    shutil.rmtree(started['out'], ignore_errors=True)


def check_build_notes() -> None:
    """ptxas's report on every kernel library: each library's most registers
    a thread and its spilled bytes, and no note that a ``wgmma`` was
    serialized (C7510-C7520)."""
    import re
    from ever_tpu_torch.ops import _build

    notes = []
    for name in _build.SOURCES:
        log = _build.build_log(name)
        regs = [int(n) for n in re.findall(r'Used (\d+) registers', log)]
        spills = sum(int(n) for n in re.findall(r'(\d+) bytes spill stores', log))
        notes += [line.strip() for line in log.splitlines() if 'serialized' in line]
        print(f'build: {name}: {len(regs)} kernels, at most {max(regs, default=0)} '
              f'registers a thread, {spills} bytes of spill stores', flush=True)
    for line in notes:
        print(f'build: {line}', flush=True)
    check(not notes, f'ptxas serialized wgmmas: {len(notes)} notes')


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--profile', action='store_true',
                        help='trace one tile batch and one train step of each '
                             'model with torch.profiler')
    parser.add_argument('--seed', type=int, default=0,
                        help="seed of the random weights, inputs and the trainer "
                             "phase's data")
    parser.add_argument('--ddp-worker', nargs=5, metavar=('JOB', 'RANK', 'WORLD', 'INIT', 'OUT'),
                        help='run one rank of the ddp phase or of the parallel phases (gan, '
                             'zero, layouts, spatial; the phases start them)')
    parser.add_argument('--side', nargs=2, metavar=('OUT', 'SMI'),
                        help='run the zoo, backbones, vitencoder and freenet phases in a '
                             'process of their own (the script starts it)')
    args = parser.parse_args()
    if args.side:
        return side_phases(args.seed, args.side[1], args.profile, args.side[0])
    if args.ddp_worker:
        job, rank, world, init, out = args.ddp_worker
        return ddp_worker(job, int(rank), int(world), init, out)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script needs one GPU',
              file=sys.stderr)
        return 1
    from ever_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)}; allow_tf32: matmul '
          f'{torch.backends.cuda.matmul.allow_tf32}, cudnn '
          f'{torch.backends.cudnn.allow_tf32}', flush=True)
    t0 = time.perf_counter()
    secs = _build.build()
    print(f'build: {", ".join(f"{n} {s:.1f} s" for n, s in secs.items())}; '
          f'total {time.perf_counter() - t0:.1f} s', flush=True)
    check_build_notes()

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device='cuda').manual_seed(args.seed)
    fwd, bwd = phase_kernels(gen)
    pool = phase_maxpool(gen)
    phase_serve(gen, args.profile)
    (fwd['launches'], bwd['launches']), bare_ms = phase_train(gen, args.profile)
    model, pool['launches'] = phase_farseg_train(gen, args.profile)
    phase_farseg_serve(gen, model, args.profile)
    del model
    torch.cuda.empty_cache()
    ln_fwd, ln_bwd = phase_layernorm(gen, args.seed)
    ln_fwd['launches'], ln_bwd['launches'] = phase_fused_ln(gen, args.profile)
    quant, matmul = phase_quant(gen)
    phase_trainer(gen, args.seed, bare_ms, smi)
    phase_workflow(gen, args.seed, smi)
    phase_ddp(args.seed, smi)
    parallel = start_parallel(args.seed)
    side = None
    try:
        side = start_side(args.seed, smi, args.profile)
        k1, k2, k8 = phase_models(gen, args.seed, smi)
        fwd['launches'] += k1
        bwd['launches'] += k2
        pool['launches'] += k8 + phase_change(gen, args.seed, smi)
        pool['launches'] += phase_user(gen, args.seed, smi)
        k1, k7, k8 = phase_int8(args.seed, smi)
        fwd['launches'] += k1
        matmul['launches'] += k7
        pool['launches'] += k8
        launches = finish_side(side)
        fwd['launches'] += launches['k1']
        bwd['launches'] += launches['k2']
        matmul['launches'] += launches['k7']
        pool['launches'] += launches['k8']
        k1, k2, k8 = finish_parallel(parallel, args.seed, smi, bare_ms)
    finally:
        if side is not None:
            stop_side(side)
        stop_parallel(parallel)
    fwd['launches'] += k1
    bwd['launches'] += k2
    pool['launches'] += k8

    records = [fwd, bwd, pool, ln_fwd, ln_bwd, quant, matmul]
    for kernel in records:
        for key, value in kernel.items():
            check(value is not None and (not isinstance(value, float) or math.isfinite(value)),
                  f'kernel record {kernel["name"]} {key} missing')
    print(json.dumps({'kernels': records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
