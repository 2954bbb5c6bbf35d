#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``experiment_yolo_torch``) on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:
 1. print the card's name and power limit (``nvidia-smi``);
 2. turn TF32 off for matmuls and cuDNN convolutions (full f32 throughout);
 3. build the five CUDA libraries of ``experiment_yolo_torch/csrc`` (nine
    kernels, K4's backward and K7, the rotated NMS, among them, four of them,
    K1, K1's backward, K3 and K3's backward, also in a bf16 form) with nvcc;
 4. build ``yolov8-LD-P2.yaml`` (n scale, nc=6) on the card from a seeded
    generator, and run one batch of 8 at 640 to take each kernel's inputs
    from the main path: the Detect maps (K1), the ten LDConv sources and
    offsets (K3), the hard-NMS candidates (K2);
 5. hold each kernel against its plain PyTorch version on those inputs
    (K1 and K3 within 1e-5 abs, K2 identical masks), K1 in one launch for
    the three levels, also under a +-200 logit spread, on random logits at
    imgsz 608, on four narrow levels that take every narrower load width and
    at reg_max 8 (:func:`hold_k1`), K3 also on random
    offsets at the same shapes that vary by pixel and image and reach 40 px
    out of bounds, K2 also on made-up candidates (a ragged K = 1,000, K =
    8,192, duplicates, IoUs exactly at the threshold, interleaved invalid
    candidates, an image with none valid); time kernel, plain version and,
    for K3, ``F.grid_sample`` as a library yardstick (CUDA events, median of
    20 runs after warm-up, 5 for a plain version), and read each kernel's device time from a
    ``torch.profiler`` trace, for K3 also layer by layer beside each layer's
    bound; K2's bound is the largest of its pair arithmetic, its bytes and
    its chain of decisions (the earlier design's own bound beside it);
 6. serve 12 batches of 8 seeded images of mixed sizes through
    ``DetectionPredictor`` at imgsz 640, once with soft and once with hard
    NMS, with every launch counter set to 0 just before and read just after
    (1 K5 per soft batch, 1 K2 per hard batch), and report the median batch
    time and its spread;
 7. run one batch through the same weights on the CPU with the plain versions
    and compare raw maps, the decode of the card's maps (K1 on the card, the
    plain version on the CPU) and hard-NMS detections; a second card forward
    of the batch (``model.predict``) reported beside, not gated (cuDNN may
    choose convolution algorithms whose sums differ from call to call), and
    so are the host's f32 ``exp`` against float64 on the decode's logits and,
    per level, K1's and the plain decode's errors against a float64 decode of
    the card's maps, in bins and px; on a failure of the decode gate the
    worst element (level, image, anchor, side, its 16 logits as hex floats,
    K1's, the plain and the float64 distance) is printed first;
 8. validate LD-P2 with ``DetectionValidator`` on 4 seeded labelled batches of
    8 at 640 (``ori_shape`` 640 x 640, ``ratio_pad`` (1, 0, 0)), soft-NMS in
    quirk mode and then hard NMS, counters at 0 just before each run and read
    just after (exactly 1 K1 and 10 K3 per forward, 1 K5 per soft batch, 1 K2
    per hard batch), and report img/s and the per-batch median and spread;
    hold K5 against its plain version on each batch's own candidate pools
    (multi-label, K = 4,096, quirk on and off) and on made-up pools (K = 1, a
    ragged K = 1,000, K = 4,096 and 8,192, duplicates, IoUs at the threshold,
    a decay onto the 0.25 floor, an image with none valid, the quirk's first
    box in the last slot, a trained-like pool with 5% of its scores above the
    floor, IoUs one float32 spacing from the threshold, a pool in which every
    box overlaps every other): identical kept sets, scores within 1e-6
    relative, every output bit-equal;
    the stats through K5 must equal those of the same maps through the plain
    loop on the card; time K5 on the first batch's pool beside its bound (the
    chain of steps the busiest image takes);
 9. take one training step (``DetectionTrainer.train_step``, batch 8 at 640,
    seeded labelled batches) and capture, through hooks, each LDConv's source,
    offsets and incoming gradient and each level's Detect map, decoded
    distances and incoming gradient; hold the K1 and K3 backward kernels
    against their plain versions on them (and K3's on phase 5's random
    offsets, on offsets that put 90% of each layer's samples on sixteen
    source positions and on seam offsets, whose neighbouring pixels' cells
    follow each other across images and sampling points; also the same ten
    layers at imgsz 608, where several have h*w no multiple of 32 and split
    their channels unevenly over threads, on random, contention and seam
    offsets), each output of each level or layer (K3's ``dx`` and
    ``doff`` apart) within 1e-5 of its own largest plain value (on the
    contention offsets K3's error and the plain version's against a plain
    version that sums in float64 reported beside), and K3's forward
    bit-equal to its plain version on the 608 layers; time them
    as phase 5 times the forwards (K3's device time summing every launch of
    its wrapper, the zero fill of ``dx`` included, also layer by layer), with
    ``F.grid_sample``'s backward as K3's yardstick;
10. take 12 timed training steps (CIoU) after 3 warm-up steps, 4 distinct
    seeded batches in turn, with every launch counter set to 0 just before and
    read just after (exactly 1 K1, 3 K1-backward, 10 K3 and 10 K3-backward
    launches per step); every loss and gradient finite, parameters and EMA
    moved;
11. take one step from the same weights and batch at 320, batch 2, on the card
    and on the CPU (plain versions), with warmup off and ``nbs`` equal to the
    batch, so that the step fires at once with the full LR of every group,
    once with CIoU and once with the paper's recipe (Wise-IoU v3, NWD,
    ``iou_ratio`` 0.5): identical foreground count, losses within 1e-4
    relative, every parameter's gradient, momentum buffer (clipped gradient
    plus weight decay) and update within 1e-3 relative L2 (an absolute floor
    of 1e-6 under a norm of 1e-5; an update also gets one f32 spacing of each
    new parameter, since each side rounds p + update once), and with the
    recipe the new ``iou_mean`` within 1e-6 relative; the CPU step takes the
    card step's LDConv offsets (their gradient flows into its own
    ``p_conv``), since a position within about 1e-6 of a whole number may
    take the other bilinear corner pair or border multiplier on each side,
    and ScalSeq's pick of scale (a max over three), and the line reports the
    two sides' largest raw offset difference, the CPU positions' least
    distance to a whole number and to a rail, the least gap of ScalSeq's two
    largest scales and the worst tensor;
12. write a synthetic BMP dataset with the port's ``make_synthetic_dataset``
    (64 train and 16 val images at 640, seed 0) under ``build/``, time the
    train loader alone (8 threads) over an epoch with and without mosaic, then
    train ``yolov8-LD-P2.yaml`` (n scale, nc=3) with ``DetectionTrainer.train()``
    for 2 epochs at batch 8 (``close_mosaic=1``: the second without mosaic,
    default augment otherwise), validating the EMA model after each epoch
    (soft-NMS), with every launch counter at 0 just before and read just after
    (exactly 1 K1, 3 K1-backward, 10 K3 and 10 K3-backward launches per step,
    1 K1, 10 K3 and 1 K5 per val batch); gates: finite losses, ``last.pt`` and
    ``best.pt`` written, ``load_checkpoint(last.pt)`` giving maps bit-equal to
    the trainer's EMA model's on a val batch, and ``resume=last.pt`` with
    ``epochs=3`` running exactly one more epoch of 8 steps; it reports the
    loop's img/s (loader included), each epoch's img/s and the share of its
    wall time spent waiting for the next batch, the loader's ms per batch
    alone, and val img/s;
13. build LD-P2 with seeded weights under ``DetectionTrainer``'s defaults
    (``amp=True``: bf16 compute), capture a bf16 forward's K1 and K3 inputs
    (bf16 maps and sources, f32 offsets) and a bf16 step's K1 and K3
    backward inputs, and hold the bf16 forms against their plain versions:
    K3's forward bit-equal on the main path's, random, contention and seam
    offsets and at 608 (random, contention, seam), and on the step's inputs;
    K1 within 1e-5 on phase 5's cases in bf16; each bf16 ``dx`` (K1's,
    K3's) within one bf16 spacing of the plain version's rounded result plus
    1e-5 of its largest value (f32 sums that cancel near 0), K3's f32
    ``doff`` within 1e-5 of its largest value; time each form as phase 5
    does (K1's backward, as its f32 form, the kernel
    alone), its bytes bound at bf16, and ``F.grid_sample``'s bf16 time beside
    K3 and its backward, also layer by layer;
14. take 12 timed bf16 training steps after 3 warm-up steps (exactly 1, 3,
    10, 10 launches of the bf16 forms of K1, K1-backward, K3, K3-backward a
    step, none of the f32 forms) and report img/s beside phase 10's f32
    img/s; take one step at 320, batch 2, on the card in bf16 and on the CPU
    in f32 and in bf16, from the same weights and batch (warmup off, ``nbs``
    the batch), on each of 3 seeded batches: the card's distance from the
    CPU's f32 steps, in relative L2 over the parameter vectors of the three
    steps, is at most 1.5 times the CPU bf16 steps' for the momentum buffers
    and the updates (the criterion the CPU tests hold the port to against
    the JAX package; one step's bf16 drift is a draw of its own), and their
    loss components lie within 5e-2 relative L2 of the f32 steps' (three
    numbers a step are too few for the ratio: see
    ``compare_train_cpu_bf16``); ``_check_amp`` must pass on LD-P2;
15. ``YOLO("yolov8-LD-P2.yaml", nc=3).train()`` on phase 12's dataset, 2
    epochs at batch 8, with no ``amp`` key (bf16; ``optimizer='SGD'``, as
    the reference fork's ``train.py`` passes it; phase 27 trains with
    ``auto``), counters at 0
    just before and read just after: the AMP check's two forwards, 1 / 3 /
    10 / 10 bf16 launches a step and 1 K1 + 10 K3 (bf16) + 1 K5 a per-epoch
    val batch; then ``.val()`` (f32: 1 K1, 10 K3, 1 K5 a batch),
    ``.predict()`` and ``YOLO(best.pt)``, whose maps equal the trained
    facade's bit for bit; reports the loop's img/s. Two epochs from scratch
    detect nothing, so a checkpoint of the seeded LD-P2 at nc=3 with boxes
    about 100 px a side (``utils/seeded.py:sized_boxes_``) is written too:
    ``YOLO(detector.pt).predict()`` must equal ``DetectionPredictor`` on the
    loaded checkpoint, with detections in every image;
16. ``python -m experiment_yolo_torch.cfg.cli`` in fresh processes: ``val
    model=<best.pt> data=<phase 12's dataset>`` and the same on that
    checkpoint exit 0 with stats lines equal to the facade's ``val``
    (precision, recall, mAP50, mAP50-95, fitness; the detector's mAP50 above
    0), and ``predict model=<detector.pt> source=<its val images>`` with each
    image's count of detections equal to the facade's (the facade's runs
    taken with TF32 as a fresh process has it);
17. ``DetectionServer`` on a checkpoint of phase 4's seeded LD-P2 (batch 8
    at 640, soft NMS) on an ephemeral port of 127.0.0.1: 16 BMP requests from
    4 threads, every one answered, ``/health`` counting 16 requests in fewer
    than 16 batches, 1 K1, 10 K3 and 1 K5 launches per batch, detections
    equal to ``DetectionPredictor``'s on the same images (to JSON's
    rounding); reports the median request latency;
18. build ``yolov8-C2f-VSS.yaml`` (n scale, nc=6: ten VSS blocks) on the card
    from the same seeds, SS2D's own init kept, and run phase 4's batch to
    take the selective-scan calls of every block as SS2D makes them: ten
    calls of K4, each covering a block's four scan directions (40 scans per
    forward) on two unreversed sequences, with the reverse flags, the
    direction-to-source index, and ``B`` and ``C`` as strided views;
19. hold K4 against its plain version on one block's call at each of the
    four pyramid levels (L = 25,600, 6,400, 1,600, 400), on random inputs of
    the same shapes and at a ragged L = 1,003 (``dt`` a softplus of a normal,
    ``A`` minus the exp of a normal and ``D`` per direction, two of four
    directions reversed, ``B`` and ``C`` views of a tensor with rows of 33
    floats: the seeded ``dt`` sits near 0.01 and its ``A`` and ``D`` are the
    same for every direction), every direction within 1e-5 of its own
    largest plain value; time one forward's ten calls (median of 20) and
    their plain versions (median of 3: each walks up to 25,600 steps in
    Python), and each level's call alone; take K4's device time again in a
    fresh process (``chip_smoke.py --k4-device-ms``), whose traces hold every
    launch, and report it as the kernel's;
20. serve 12 batches of 8 through ``DetectionPredictor`` on the VSS model, soft
    then hard NMS, counters at 0 just before and read just after: exactly 10
    K4 and 1 K1 launch per forward, 1 K5 per soft batch, 1 K2 per hard
    batch, no K3;
21. run 2 images of that batch through the same weights on the CPU (plain
    versions) and compare raw maps and hard-NMS detections as phase 7 does;
22. build ``yolov8.yaml``, ``yolov8-ASF-P2P2.yaml`` and ``yolov8-efficientnet.yaml``
    (n scale) on the card and push one batch through each: finite raw maps
    of the expected shapes, strides 8/16/32, 4/8/16 and 8/16/32;
23. build ``yolov8-ASF-P2.yaml`` (n scale, nc=6: ZoomCat, two ScalSeq + Add
    branches, a Detect on P2-P5, the reference fork's own training model) on
    the card from the same seeds; hold K1's forward, one launch for the four
    levels, against its plain version on the model's own maps in f32 and
    bf16 at 640 (34,000 anchors) and at 608 (P5 19 x 19, an odd count),
    within 1e-5, timed beside its bound; serve 12 batches of 8 through
    ``DetectionPredictor``, soft then hard NMS, counters at 0 just before
    and read just after (exactly 1 K1 a forward, 1 K5 or 1 K2 a batch, no K3
    or K4); compare 2 images' raw maps and hard-NMS detections with the CPU
    as phase 7 does;
24. train ASF-P2: hold K1's backward on an f32 and a bf16 step's four
    levels against its plain version (phase 9's and phase 13's gates); take
    12 timed bf16 ``train_step``s at 640, batch 8 (exactly 1 K1 and 4
    K1-backward launches a step, all bf16); one f32 step at 320, batch 2, on
    the card and on the CPU with phase 11's gates (the CPU takes the card's
    picks of ScalSeq's scale and of each window of ZoomCat's 2x2 max pool,
    and the line reports both least gaps); then ``YOLO("yolov8-ASF-P2.yaml",
    nc=3).train()`` for 1 epoch on phase 12's dataset with
    ``optimizer='SGD'`` and no ``amp`` key, as the fork's ``train.py`` calls
    it: the AMP check passed, 1 K1 and 4 K1-backward bf16 launches a step,
    1 K1 (bf16) and 1 K5 a per-epoch val batch;
25. the paper's two-stage inference on LD-P2 at full width, on phase 15's
    ``detector.pt``: ``YOLO.double_predict`` on 8 images at 640, one call an
    image (a first pass of 1 K1, 10 K3 and 1 K5, a batch of 16 crops of 1
    K1, 10 K3 and 1 K2), and ``YOLO.sliced_predict`` on 2 frames of 1280 x
    720 (slice 512, overlap 0.2: 6 slices, and the full image: 2 forwards
    and 1 K5 a frame), counters at 0 just before each and read just after;
    the same calls on the CPU for 2 of the images and both frames, where at
    least 0.95 of each image's card detections must have a CPU detection of
    the same class within 1e-2 px (phases 7 and 21's gate); img/s of each;
26. train the VSS family (``vss_trained``): phase 18's ``yolov8-C2f-VSS.yaml``
    weights and phase 9's batches; take the ten K4 calls of one f32
    ``train_step`` at 640, batch 8, with the gradient each receives; (a)
    hold K4's forward against a float64 plain version at the four levels on
    those inputs (gated: within 1e-5 of the largest value) and on inputs with
    step sizes near 1e-3 (reported), beside the f32 plain version's distance;
    (b) hold K4's backward, through the autograd Function, against
    ``selective_scan_bwd_plain`` in f32 and float64 on those calls with their
    gradients, on random inputs at the /4 and /32 levels with step sizes from 1e-3 to 1
    and other flags and sources, and at the ragged L = 1,003 with SS2D's
    flags and with none: y and each of the six gradients within 1e-5 of its
    largest f32 plain value, or no farther from float64 than the f32 plain
    version is, both reported; time the step's ten backward calls (events)
    and their plain versions (one run); (c) take the backward's device time
    for the step's ten calls and per level from a fresh process
    (``chip_smoke.py --k4-bwd-device-ms``); (d) 12 timed f32 and 12 timed
    bf16 ``train_step``s after 3 warm-ups (exactly 10 K4 and 10
    K4-backward launches a step, and 1 K1 and 3 K1-backward launches of the
    step's dtype), img/s and peak memory; (e) one f32 step at 128, batch 2,
    on the card and on the CPU with phase 11's gates, the CPU taking the
    card's pick in each window of SPPF's max pools, and the bf16 steps within
    1.5 times the CPU's bf16 distance over 3 seeded steps as phase 14 holds
    them, with the CPU's seconds; (f) ``YOLO("yolov8-C2f-VSS.yaml",
    nc=3).train()`` for 1 epoch on phase 12's dataset with phase 15's
    arguments: the AMP check passed, 10 K4 and 10 K4-backward launches a
    step (the AMP check's two forwards and each val batch 10 K4), 1 K1 and
    3 K1-backward bf16 launches a step, 1 K1 (bf16) and 1 K5 a per-epoch
    val batch; reports the loop's img/s and the phase's seconds;
27. the training recipe's switches (``recipes_phase``): (a) two recipes,
    each of f32 LD-P2 steps at 320, batch 2, from phase 11's weights, a
    new one of phase 14's three seeded batches each step, on the card and on
    the CPU (:func:`compare_recipe_cpu`): R1,
    ``optimizer='auto'`` with ``epochs=10`` (AdamW), SIoU with Inner-IoU,
    and through ``LossConfig`` the varifocal class loss and ATSS, one step;
    R2, Wise-IoU of ``wiou_ltype='MPDIoU'`` with Focaler-IoU and NWD,
    EMASlide with its ``slide_mean`` threaded, and SOAP, three steps (the
    first applies no update). Each CPU step starts from the card's state and
    takes the card's picks (phase 11's, and ATSS's where a tie splits the
    sides, reported with the least gaps); phase 11's gates for losses,
    gradients and the optimizers' moments, and the card's update within 1e-5
    of the CPU optimizer's step on the card's own gradients; counters at 0
    just before and read just after: 1, 3, 10, 10 launches a card step.
    Where SOAP's first step in its eigenbasis is held to the float64 step,
    the line reports, per tensor, the share of the gap (rotated into the
    eigenbasis) carried by rotated gradient components within an f32
    projection's rounding of 0, and, as a diagnosis only, the card's step
    rerun with its projections in float64 (:func:`soap_gap_near_zero`,
    :func:`soap_step_projected_in_float64`). (b)
    ``YOLO("yolov8-LD-P2.yaml", nc=3).train()`` for an epoch on phase 12's
    dataset with no ``optimizer`` argument (``auto``: AdamW) and phase 15's
    other arguments: the AMP check passed, phase 15's bf16 launches a step
    and a val batch, finite losses; then ``resume`` from its ``last.pt``
    for a second epoch; reports the loop's img/s and the phase's seconds;
28. the other configs (``other_configs_phase``): ``yolov8-aux.yaml`` (n
    scale, nc 80: ``DetectAux``, whose loss decodes its aux maps in a second
    K1 launch) and ``yolov8-lafiyolo.yaml`` (n scale, nc 6: ``MBConv``),
    each from seeded weights (:func:`other_config`): served, 12 batches of 8
    through ``DetectionPredictor``, soft then hard NMS (exactly 1 K1 a
    forward, 1 K5 or 1 K2 a batch, and no module of the aux branches run),
    2 images against the CPU as phase 7 holds them; K1's backward on an f32
    and a bf16 step's levels (DetectAux's six) against its plain version
    (phases 9 and 13's gates); 12 timed bf16 steps (exactly 2 K1 and 6
    K1-backward launches a step for the aux model, 1 and 3 for lafiyolo, all
    bf16) with img/s and peak memory; one f32 step at 320, batch 2, against
    the CPU with phase 11's gates, the CPU taking the card's picks in SPPF's
    windows; ``YOLO(cfg, nc=3).train()`` for an epoch on phase 12's dataset
    with phase 15's arguments (2 K1 a step and 1 a val batch, 6 K1-backward
    a step, for the aux model); each number beside the card's name and
    power limit, and the phase's seconds;
29. the user's own images (``image_input_phase``, ``data/codec.py``): the
    probe's answer (headers, libraries, ``ffmpeg``) and the route (JPEG
    through nvJPEG on the card, PNG through the port's own decoder); every
    committed fixture of ``tests/assets/images/`` decoded from its file and
    from its bytes, PNG bit-equal to its ``cv2.imread`` array and JPEG within
    the gap measured for nvJPEG (``NVJPEG_GAP``: chroma upsampling and IDCT
    rounding); a 1920 x 1080 JPEG's decode timed;
    ``YOLO(<phase 4's seeded LD-P2 checkpoint>).predict(<folder of 16 seeded
    1280 x 720 JPEGs>)`` at 640, batch 8, soft NMS, with exactly phase 6's
    launches a batch and the detections identical to ``predict`` on the same
    decoded arrays and to ``stream=True``, img/s; 8 JPEG requests to
    ``DetectionServer``, each answered as the BMP of the same pixels; and
    ``YOLO("yolov8-LD-P2.yaml", nc=3).train()`` for an epoch on a JPEG copy
    of phase 12's dataset written by the port's encoder (phase 15's launches),
    img/s; the phase's seconds;
30. ``C2f_LDConv`` and the segmentation family (``seg_phase``): LD-P2 with
    its ``C2f`` rows as ``C2f_LDConv`` at 320, batch 2 (28 LDConv layers, 22
    of them at stride 1, 18 in ``BottleneckLD``): a forward, an f32 and a bf16
    step with exact launches, K3 and its backward at stride 1 against their
    plain versions in f32 and bf16 (forward bit-equal, backward within
    BWD_RTOL, bf16 ``dx`` within one spacing; on the step's, random,
    contention and seam offsets) with device ms beside each bound, and one
    f32 step against the CPU's (phase 11's gates and picks); then
    ``yolov8-seg.yaml`` n (nc 80, seeded weights) served for 12 batches of 8
    at 640, soft then hard (1 K1 and 1 K5 or 1 K2 a batch, a bool mask a
    detection in its image), its maps within 1e-3 of the CPU's on two images
    and their masks equal to the CPU's except pixels within 1e-5 of 0.5
    (counted); ``SegmentationValidator`` on a synthetic seg dataset (64 +
    16 images at 640, nc 2; hard multi-label NMS, 1 K1 and 1 K2 a batch), K2's
    keep masks equal to plain and the stats equal to those through the plain
    NMS; one f32 step at 320 against the CPU (losses 1e-4, gradients 1e-3,
    the mask term's top 64 held, ``mask_handover``) and three bf16 steps within
    1.5 times the CPU's bf16 distance; one ``YOLO("yolov8-seg.yaml",
    nc=2).train()`` epoch with per-epoch mask validation; a seg
    ``DetectionServer`` on its ``last.pt`` answering 4 requests with
    ``mask_rle`` equal to the facade's masks; the phase's seconds;
31. the pose family (``pose_phase``): ``yolov8-pose.yaml`` n (nc 1, kpt
    17 x 3, seeded weights) served for 12 batches of 8 at 640, soft then hard
    (1 K1 and 1 K5 or 1 K2 a batch, (n, 17, 3) keypoints for n boxes), its
    raw maps and decoded keypoints within 1e-3 (px) of the CPU's on two
    images and its ``Results.keypoints`` the kept anchors' taken back;
    ``PoseValidator`` on a synthetic pose set (nk 5, 64 + 16 images at 640;
    hard multi-label NMS, 1 K1 and 1 K2 a batch), K2's keep masks equal to
    plain and the stats equal to those through the plain NMS; one f32 step
    at 320 against the CPU (losses 1e-4, gradients 1e-3) and three bf16 steps
    within 1.5 times the CPU's bf16 distance; one ``YOLO("yolov8-pose.yaml",
    nc=1).train()`` epoch, its head rebuilt from 17 x 3 to the set's 5 x 3,
    whose ``last.pt`` reloads as a 5 x 3 ``PoseModel``; a pose
    ``DetectionServer`` answering 4 requests with the facade's keypoints;
32. the fork's significance experiment (``experiment_phase``):
    ``run_experiment.main`` with ``seeds=0 epochs=1 imgsz=320 batch=8
    n_train=16 n_val=16 base=yolov8n.yaml deal=yolov8-LD-P2.yaml``, its
    report and ``results.json`` under the run's root, a second call that
    reuses both runs, each model's ``per_image_stats`` through K5 equal to
    the plain soft-NMS's, and the bootstrap comparison equal on both;
33. the oriented-box family (``obb_phase``): ``yolov8-obb.yaml`` n (nc 15,
    DOTA v1.0's classes, seeded weights) served for 20 batches of 8 at 1024,
    DOTA's image size (rotated hard NMS: 1 K1 and 1 K7 a batch, finite (n, 7)
    detections); K7's keep masks on the first batch's candidates and on
    made-up pools (a ragged K = 1,000, K = 8,192, duplicates, ProbIoU exactly
    at the threshold, 15 classes of one shape, interleaved invalid
    candidates, an image with none valid) equal to its plain version's on the
    card, timed beside its plain version and its bound; its raw maps and
    decoded xywh within 1e-3 (px) of the CPU's on two images, angles within
    1e-5 rad, the packed detections through K7 equal to those through the
    plain version, ``Results.obb`` the detections taken back;
    ``OBBValidator`` on a synthetic obb set (64 + 16 images at 640; 1 K1 and
    1 K7 a batch) with the same stats through the plain version; one f32
    step at 320 against the CPU (losses 1e-4, gradients 1e-3; the CPU takes
    the card's rotated TAL assignment where the two part only at near-ties
    of a gt's top-k cut, and any other difference fails) and three bf16 steps
    within 1.5 times the CPU's bf16 distance; one ``YOLO("yolov8-obb.yaml",
    nc=1).train()`` epoch whose ``last.pt`` reloads as an ``OBBModel``; an
    OBB ``DetectionServer`` answering 4 requests with the facade's ``xywhr``
    and ``points``;
34. print a ``{"kernel_detail": ...}``, a ``{"served": ...}``, a ``{"trained":
    ...}``, a ``{"served_vss": ...}``, a ``{"validated": ...}``, a
    ``{"trained_loop": ...}``, a ``{"trained_bf16": ...}``, a ``{"facade":
    ..., "cli": ..., "server": ...}``, an ``{"asf_p2": ...}``, a
    ``{"two_stage": ...}``, a ``{"vss_trained": ...}``, a ``{"recipes":
    ...}``, an ``{"other_configs": ...}``, an ``{"image_input": ...}`` and a
    ``{"segmentation_and_c2f_ldconv": ...}``, a ``{"pose": ...}``, an
    ``{"experiment": ...}`` and an ``{"obb": ...}`` line, then the
    ``{"kernels": [...]}`` line for the nine kernels and the four bf16
    forms (launches summed over every main path above), the card's name and
    power limit, and last ``{"ok": true, "device": {...}}``.

It exits non-zero and prints no result without a CUDA device, or when the
package is not beside it.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CFG = "yolov8-LD-P2.yaml"
VSS_CFG = "yolov8-C2f-VSS.yaml"
PLAIN_CONV_CFGS = {"yolov8.yaml": (8, 16, 32), "yolov8-ASF-P2P2.yaml": (4, 8, 16),  # config -> expected strides
                   "yolov8-efficientnet.yaml": (8, 16, 32)}
OTHER_CFGS = {"yolov8-aux.yaml": 2, "yolov8-lafiyolo.yaml": 1}  # phase 28's configs -> K1 decodes a training step
ASF_CFG, ASF_STRIDES, ASF_CMP_BATCH = "yolov8-ASF-P2.yaml", (4, 8, 16, 32), 2  # the reference fork's train.py model
TWO_STAGE_IMAGES, TWO_STAGE_CPU_IMAGES, SLICED_FRAMES, SLICE = 8, 2, 2, 512  # phase 25: double_predict, sliced_predict
IMGSZ, BATCH, SEED = 640, 8, 0
# 4 distinct batches of seeded images, served in turn; 12 batches a served pass and 12 timed training steps (20 each
# before phase 33 came: the run is held within its time, PERF.md section 6)
N_IMAGES, SERVE_BATCHES = 32, 12
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_BATCHES = 12, 3, 4  # timed steps, warm-up steps, distinct seeded batches
PLAIN_RUNS = 5  # timed runs of a plain version (after one warm-up); 20 before phase 33 came
CMP_IMGSZ, CMP_BATCH = 320, 2  # the card-versus-CPU training step
VSS_CMP_BATCH = 2  # the VSS card-versus-CPU batch: the CPU walks 25,600 scan steps one by one
VSS_CMP_IMGSZ = 128  # the VSS card-versus-CPU training steps (batch CMP_BATCH): at 320 one CPU step walking every
# scan step forwards and back took 17.8 s on the card's host, and phase 26 takes seven
PLAIN_SCAN_RUNS = 1  # timed runs of K4's plain version (3 before phase 33): one forward's ten scans walk 76,800 steps
K4_RTOL = 1e-5  # K4 vs plain: each direction's max abs error over that direction's largest plain value
BWD_RTOL = 1e-5  # backward kernels vs plain: max abs error over each output's largest plain value (atomics' order)
BF16_LOSS_RTOL = 0.05  # bf16 steps' loss components vs the f32 steps': about 2x the largest bf16 drift seen (0.029)
BF16_CMP_STEPS = 3  # seeded batches of the bf16 step comparison (one step's bf16 drift is a draw of its own)
RAGGED_IMGSZ = 608  # K3's backward is also held at this size: LDConv outputs of 76 x 76 and 38 x 38 pixels
CONF, IOU = 0.25, 0.7
RUNS, WARMUP = 20, 3
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s,
# and f32 operations/s outside the tensor cores (none of these kernels uses them).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# K2's bound is the largest of three: the IoU arithmetic of every pair (i, j > i) over the f32 rate, its
# bytes over HBM, and the chain of keep/suppress decisions of the image with most valid candidates, which
# depend on each other in score order and cost at least the latency of one dependent register operation
# each (4 clocks on Hopper), at the SXM part's 1.98 GHz. The bound stated for the earlier one-block-per-image
# design, kept beside it, was that design's own cost: a shared-memory round trip (about 30 clocks) per
# candidate and one more per kept box.
SM_CLOCK_HZ = 1.98e9
DEPENDENT_OP_CLOCKS = 4
IOU_OPS = 14  # 2 min, 2 max, 2 sub, 2 clamps, 3 mul/add/sub for inter and union, + eps, the division, the compare
SMEM_ROUND_TRIP_CLOCKS = 30  # the earlier design's bound's assumption
RAGGED_SCAN_LENGTH = 1003  # K4 also at a length that is no multiple of its chunk (48 here) or its 8-step tile
VAL_BATCHES = 4  # seeded labelled batches of the val phase
LOOP_TRAIN, LOOP_VAL, LOOP_NC, LOOP_EPOCHS = 64, 16, 3, 2  # the dataset-driven loop: synthetic BMP images at IMGSZ
TAL_TIE_RTOL = 1e-4  # rotated TAL: a pick within this of a gt's k-th metric (relative) is a tie
K5_RTOL = 1e-6  # K5 vs plain: kept scores' relative error (the same rounded operations: bit-equal, also gated)
VAL_PROTOCOLS = {"soft-quirk": {"nms_type": "soft", "soft_nms_quirk": True},  # PARITY.md's protocol
                 "hard": {"nms_type": "hard", "soft_nms_quirk": False}}
RECIPE = {"use_wiseiou": True, "wiou_ltype": "WIoU", "nwd": True, "iou_ratio": 0.5}  # EXPERIMENTS.md's box loss
# phase 27's recipes: (trainer overrides, LossConfig fields, steps, thread EMASlide's slide_mean)
RECIPES = {"R1": ({"optimizer": "auto", "epochs": 10, "iou_type": "SIoU", "inner_iou": True},
                  {"cls_loss": "varifocal", "assigner": "atss"}, 1, False),
           "R2": ({"optimizer": "SOAP", "use_wiseiou": True, "wiou_ltype": "MPDIoU", "focaler_iou": True, "nwd": True},
                  {"cls_loss": "emaslide"}, 3, True)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, runs: int = RUNS, warmup: int = WARMUP) -> float:
    """Median milliseconds of ``fn`` on the card: CUDA events around each of
    ``runs`` calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel: str, per_call: int, runs: int = 5, span: str | None = None):
    """Device milliseconds per call of ``fn`` spent in CUDA kernels whose name
    holds ``span`` (by default ``kernel``; ``""``: every device event of the
    trace, a wrapper's fills included), from a ``torch.profiler`` trace that
    holds all ``runs * per_call`` launches of the kernels named ``kernel``
    (``per_call``: those one call launches); None if five traces in a row miss
    some (a trace now and then comes back without some of a kernel's events,
    and its sum would read low). Late in a long process a trace has been seen
    to drop its first kernels every time: a profiler cycle of one call and a
    spin kernel, traced but not kept (the schedule's warm-up), goes first,
    and a spin kernel, not timed, heads the kept cycle."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    span = kernel if span is None else span
    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            torch.cuda._sleep(100_000)
            fn()
            torch.cuda.synchronize()
            prof.step()
            # late in the process a kept cycle has lost its first few kernels: each retry leads with a longer spin
            torch.cuda._sleep(100_000 * 10 ** min(attempt, 2))
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
            prof.step()
        events = [e for e in prof.key_averages()  # the cycle's own range is no kernel
                  if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key
                  and not e.key.startswith("ProfilerStep")]
        launched = sum(e.count for e in events if kernel in e.key)
        if launched == runs * per_call:
            return sum(e.self_device_time_total for e in events if span in e.key) / runs / 1e3
        print(f"chip_smoke: a trace held {launched} of the {runs * per_call} launches of {kernel}: "
              f"{ {e.key[:60]: e.count for e in events} }", file=sys.stderr, flush=True)
    return None


def device_ms_each(fns, kernel: str, per_call: int, runs: int = 5):
    """Device milliseconds of each of ``fns`` (called in turn, ``runs``
    times) from one ``torch.profiler`` trace: the device events up to the end
    of the device-side span of a ``record_function`` range around the call
    and after the span before it (fills included); a trace counts only if it
    holds all ``runs * len(fns) * per_call`` launches of the kernels named
    ``kernel`` and under 1% of its device time falls after the last span.
    None for each after five traces that do not. One trace for a layer set,
    where ``device_ms`` per layer would open one trace a layer."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    tag = "chip_smoke_item_"

    def once():
        for i, fn in enumerate(fns):
            with record_function(f"{tag}{i}"):
                fn()

    once()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            torch.cuda._sleep(100_000)
            once()
            torch.cuda.synchronize()
            prof.step()
            torch.cuda._sleep(100_000)
            for _ in range(runs):
                once()
            torch.cuda.synchronize()
            prof.step()
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = [(e.time_range.start, e.time_range.end, int(e.name[len(tag):])) for e in device
                 if e.name.startswith(tag)]  # a range's device-side span, first event to last
        work = [e for e in device if not e.name.startswith(tag) and "spin_kernel" not in e.name]
        launched = sum(kernel in e.name for e in work)
        spans.sort()
        sums, outside = [0.0] * len(fns), 0.0
        for e in work:
            # a range's device span starts at its first kernel: a memset ahead of it goes to the next range
            item = next((i for start, end, i in spans if e.time_range.start <= end), None)
            if item is None:
                outside += e.time_range.elapsed_us()
            else:
                sums[item] += e.time_range.elapsed_us()
        # a trace has been seen to hold one short device event after the last range; more than 1% is a miss
        if launched == runs * len(fns) * per_call and outside <= 0.01 * sum(sums):
            return [v / runs / 1e3 for v in sums]
        print(f"chip_smoke: a trace held {launched} of the {runs * len(fns) * per_call} launches of {kernel}, "
              f"{outside} us of device time in no range", file=sys.stderr, flush=True)
    return [None] * len(fns)


def bound(nbytes: float, ops: float):
    """Least time (ms) the card could take: bytes over HBM rate or operations
    over the f32 rate, whichever is larger, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def capture_inputs(model, x):
    """One forward on batch ``x``: the Detect maps, each LDConv's (source,
    offsets, stride), and the NMS pool that the serving path hands to K1, K3
    and K2 or K5 (``soft_nms``'s arguments; K2 takes its boxes and valid)."""
    import torch

    from experiment_yolo_torch.nn.modules import LDConv
    from experiment_yolo_torch.ops.anchors import decode_detections
    from experiment_yolo_torch.utils.seeded import soft_nms_pools

    ld = []
    hooks = [m.register_forward_pre_hook(lambda m, a: ld.append((a[0], m.p_conv(a[0]), m.stride)))
             for m in model.modules() if isinstance(m, LDConv)]
    with torch.no_grad():
        feats = model(x)
    for h in hooks:
        h.remove()
    boxes, scores = decode_detections(feats, model.stride, model.nc, model.reg_max)
    return feats, ld, soft_nms_pools(boxes, scores, val=False)[""][0]


def hold_k1(feats, gen):
    """K1's forward, one launch for every level, against its plain version
    (the levels' plain decodes concatenated) on a forward's maps ``feats`` and
    on maps of their dtype that take every load width a path can take: the
    same maps with a +-200 logit spread across the groups of one anchor (the
    output must stay finite), random logits at RAGGED_IMGSZ (levels of 152,
    76 and 38 squared), four levels whose anchor counts (38 x 38, 19 x 38,
    19 x 19) or address (an 8 x 8 map one element into its buffer) take
    narrower widths, and a map at reg_max 8 (the runtime-reg_max instance);
    the cases must take every width (anchors a thread) up to the widest the
    dtype allows. Returns each case's max abs error and the width of each
    level."""
    import torch

    from experiment_yolo_torch.ops.kernels.dfl_decode import (MAX_LOAD_BYTES, dfl_decode_levels_fwd, dfl_decode_plain,
                                                              level_table)

    dtype, b, no = feats[0].dtype, feats[0].shape[0], feats[0].shape[1]

    def rand(*shape):
        return (torch.randn(*shape, generator=gen) * 3).to(feats[0].device, dtype)

    spread = feats[-1].clone()
    spread[:, 0:16, 0, 0] += 200.0
    spread[:, 16:32, 0, 0] -= 200.0
    sizes = [RAGGED_IMGSZ * f.shape[2] // IMGSZ for f in feats]
    misaligned = rand(b * no * 64 + 1)[1:].view(b, no, 8, 8)
    cases = {"main path": (feats, 16), "+-200 spread": ([*feats[:-1], spread], 16),
             f"imgsz {RAGGED_IMGSZ}": ([rand(b, no, h, h) for h in sizes], 16),
             "narrow, 4 levels": ([rand(b, no, 38, 38), rand(b, no, 19, 38), rand(b, no, 19, 19), misaligned], 16),
             "reg_max 8": ([rand(b, 32 + no - 64, 40, 40)], 8)}
    out = {}
    for label, (maps, reg_max) in cases.items():
        got = dfl_decode_levels_fwd(maps, reg_max)
        check(bool(torch.isfinite(got).all()), f"K1 dfl_decode {dtype}: non-finite output on {label}")
        want = torch.cat([dfl_decode_plain(f, reg_max) for f in maps], 1)
        table = level_table([(f.shape[2] * f.shape[3], f.stride(0), f.data_ptr()) for f in maps],
                            maps[0].element_size())
        out[label] = {"max_abs_err": (got - want).abs().max().item(), "widths": [t.width for t in table]}
    torch.cuda.synchronize()
    widths = {w for row in out.values() for w in row["widths"]}
    widest = max(1, MAX_LOAD_BYTES // feats[0].element_size())
    every = {1 << i for i in range(widest.bit_length())}
    check(widths == every, f"K1 dfl_decode {dtype}: the cases took widths {sorted(widths)}, expected {sorted(every)}")
    return out


def k1_row(name, feats, cases, kernel):
    """The kernels-line row of K1's forward (f32 or bf16) on a forward's maps:
    one launch for every level, timed beside the plain version and the bytes
    bound (each logit read once, each distance written once)."""
    import torch

    from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode_levels_fwd, dfl_decode_plain

    err = max(row["max_abs_err"] for row in cases.values())
    check(err <= 1e-5, f"K1 {name} disagrees with its plain version: max abs err {err} ({json.dumps(cases)})")
    groups = sum(f.shape[0] * f.shape[2] * f.shape[3] * 4 for f in feats)
    b_ms, b_by = bound(groups * 16 * feats[0].element_size() + groups * 4, groups * (6 * 16 + 1))
    return dict(name=name, route="cuda", source="experiment_yolo_torch/csrc/dfl_decode.cu",
                replaces="experiment_yolo_tpu/ops/pallas/dfl_decode.py:46", max_abs_err=err,
                ms=cuda_ms(lambda: dfl_decode_levels_fwd(feats)),
                device_ms=device_ms(lambda: dfl_decode_levels_fwd(feats), kernel, 1),
                plain_ms=cuda_ms(lambda: torch.cat([dfl_decode_plain(f) for f in feats], 1), PLAIN_RUNS, 1),
                bound_ms=b_ms,
                bound_by=b_by, library_ms=None, per_call=1, cases=cases,
                shapes=[f"{tuple(f.shape)} {str(f.dtype).removeprefix('torch.')}" for f in feats])


def check_k1(feats):
    """K1's f32 form on an f32 forward's maps and the cases of :func:`hold_k1`."""
    import torch

    cases = hold_k1(feats, torch.Generator().manual_seed(SEED + 3))
    # the max, sub, exp, 2 sums (3 ops) of each bin, one division: the bound is the bytes
    return k1_row("dfl_decode", feats, cases, "dfl_decode_kernel<float")


def made_up_candidates(gen):
    """K2's made-up cases, each (boxes (B, K, 4), valid (B, K), threshold):
    clustered candidates at a ragged K = 1,000 and at the largest K, 8,192;
    exact duplicates; pairs whose float32 IoU is exactly 0.7, 0.8 or 0.6
    (small integers: 7/10 ties with the threshold and must not suppress);
    invalid candidates interleaved with valid ones; an image with no valid
    candidate."""
    import torch

    def clustered(b, k):
        centres = (torch.rand(b, k // 8 + 1, 2, generator=gen) * 600).repeat_interleave(8, 1)[:, :k]
        centres = centres + torch.randn(b, k, 2, generator=gen) * 6
        wh = torch.rand(b, k, 2, generator=gen) * 50 + 10
        return torch.cat([centres - wh / 2, centres + wh / 2], -1).contiguous()

    def some_valid(b, k):
        return torch.rand(b, k, generator=gen) > 0.2

    dup = clustered(2, 512)
    dup[:, 1::2] = dup[:, 0::2]
    x0 = 20.0 * torch.arange(300, dtype=torch.float32)
    inner = torch.tensor([7.0, 8.0, 6.0]).repeat(100)
    zero, one = torch.zeros(300), torch.ones(300)
    ties = torch.stack([torch.stack([x0, zero, x0 + 10, one], -1), torch.stack([x0, zero, x0 + inner, one], -1)], 1)
    ties = torch.stack([ties.reshape(600, 4), ties[torch.randperm(300, generator=gen)].reshape(600, 4)])
    interleaved = some_valid(2, 1024)
    interleaved[:, 1::2] = False
    none = some_valid(2, 1024)
    none[1] = False
    return {"ragged K=1000": (clustered(3, 1000), some_valid(3, 1000), IOU),
            "K=8192": (clustered(2, 8192), some_valid(2, 8192), IOU),
            "duplicates": (dup, some_valid(2, 512), IOU),
            "IoU at the threshold": (ties.contiguous(), torch.ones(2, 600, dtype=torch.bool), 0.7),
            "interleaved invalid": (clustered(2, 1024), interleaved, 0.5),
            "an image with no valid candidate": (clustered(2, 1024), none, 0.5)}


def k2_bound(valid, k: int):
    """(least ms, what bounds it, the three times) for a batch of K = ``k``
    candidates per image: pair arithmetic, bytes, the longest chain."""
    pairs = valid.shape[0] * k * (k - 1) / 2
    times = {"pairs_ms": pairs * IOU_OPS / F32_OPS_PER_S * 1e3,
             "bytes_ms": valid.numel() * (16 + 1 + 1) / HBM_BYTES_PER_S * 1e3,  # boxes, valid read; keep written
             "chain_ms": int(valid.sum(1).max()) * DEPENDENT_OP_CLOCKS / SM_CLOCK_HZ * 1e3}
    worst = max(times, key=times.get)
    return times[worst], "bytes" if worst == "bytes_ms" else "operations", times


def check_k2(shifted, valid):
    import torch

    from experiment_yolo_torch.ops.kernels.nms_suppress import nms_suppress, nms_suppress_plain

    keep, want = nms_suppress(shifted, valid, IOU), nms_suppress_plain(shifted, valid, IOU)
    torch.cuda.synchronize()
    mismatched = int((keep != want).sum())
    check(mismatched == 0, f"K2 nms_suppress: {mismatched} keep flags differ from its plain version")
    check(bool(want.any()) and bool((valid & ~want).any()), "K2 inputs neither keep nor suppress: no real work")
    made_up = {}
    for label, (boxes, ok, thr) in made_up_candidates(torch.Generator().manual_seed(SEED + 5)).items():
        boxes, ok = boxes.cuda(), ok.cuda()
        got, ref = nms_suppress(boxes, ok, thr), nms_suppress_plain(boxes, ok, thr)
        torch.cuda.synchronize()
        bad = int((got != ref).sum())
        check(bad == 0, f"K2 nms_suppress: {bad} keep flags differ from its plain version on the {label} case")
        made_up[label] = {"K": boxes.shape[1], "images": boxes.shape[0], "kept": int(ref.sum()),
                          "valid": int(ok.sum()), "mismatched": bad,
                          "device_ms": device_ms(lambda: nms_suppress(boxes, ok, thr), "nms_suppress_kernel", 2)}
    check(made_up["IoU at the threshold"]["kept"] == 1000, "K2's tie case should keep the 7/10 and 6/10 pairs whole")
    ms = cuda_ms(lambda: nms_suppress(shifted, valid, IOU))
    dev_ms = device_ms(lambda: nms_suppress(shifted, valid, IOU), "nms_suppress_kernel", 2)  # pairs, chain
    plain_ms = cuda_ms(lambda: nms_suppress_plain(shifted, valid, IOU), PLAIN_RUNS, 1)
    b_ms, b_by, parts = k2_bound(valid, shifted.shape[1])
    old_clocks = int(((valid.sum(1) + want.sum(1)) * SMEM_ROUND_TRIP_CLOCKS).max())
    return dict(name="nms_suppress", route="cuda", source="experiment_yolo_torch/csrc/nms_suppress.cu",
                replaces="experiment_yolo_tpu/ops/pallas/nms_kernel.py:26", max_abs_err=float(mismatched), ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                kept=int(want.sum()), candidates=int(valid.sum()), bound_parts=parts,
                bound_assumption=f"largest of: {IOU_OPS} f32 operations per pair (i, j > i) over "
                                 f"{F32_OPS_PER_S / 1e12:g} TFLOP/s; 18 bytes per candidate over HBM; the image "
                                 f"with most valid candidates deciding them one after another at "
                                 f"{DEPENDENT_OP_CLOCKS} clocks (one dependent register operation) each, "
                                 f"{SM_CLOCK_HZ / 1e9} GHz",
                old_design_bound_ms=old_clocks / SM_CLOCK_HZ * 1e3,
                old_design_bound_assumption=f"one block per image: {SMEM_ROUND_TRIP_CLOCKS} clocks per candidate plus "
                                            f"{SMEM_ROUND_TRIP_CLOCKS} per kept box, longest image",
                made_up=made_up)


def _random_offsets_like(o, gen):
    import torch

    r = torch.randn(o.shape, generator=gen) * 4
    far = torch.rand(o.shape, generator=gen) < 0.02
    return torch.where(far, r + 40 * r.sign(), r).to(o.device)


def random_offsets(ld):
    """The seeded model's offset convs keep the reference init (zero weights),
    so the main path's offsets are one value per channel. The kernels are
    also held on offsets that vary by pixel and image: N(0, 4^2) px, and 2%
    of them pushed 40 px further, far outside the source."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 2)
    return [(x, _random_offsets_like(o, gen), s) for x, o, s in ld]


def grid_sample_grids(layers):
    """``F.grid_sample``'s grids (B, hw, N, [x, y]) for the LDConv positions
    of each (source, offsets, stride): border clamp, no border double count."""
    import torch

    from experiment_yolo_torch.ops.kernels.ldconv_gather import grid_points

    out = []
    for x, o, s in layers:
        b, n2, h, w = o.shape
        n, (hx, wx) = n2 // 2, x.shape[2:]
        pts = torch.tensor(grid_points(n), dtype=torch.float32, device=x.device)
        o = o.reshape(b, 2, n, h * w).permute(0, 3, 2, 1)  # (B, hw, N, [row, col])
        rows = (torch.arange(h, device=x.device, dtype=torch.float32) * s)[:, None].expand(h, w).reshape(1, -1, 1)
        cols = (torch.arange(w, device=x.device, dtype=torch.float32) * s)[None, :].expand(h, w).reshape(1, -1, 1)
        pr, pc = rows + pts[:, 0] + o[..., 0], cols + pts[:, 1] + o[..., 1]
        out.append(torch.stack([pc / (wx - 1) * 2 - 1, pr / (hx - 1) * 2 - 1], -1))
    return out


def check_k3(ld, rand_ld):
    import torch.nn.functional as F

    # the kernel's own wrapper, without the autograd.Function around it
    from experiment_yolo_torch.ops.kernels.ldconv_gather import ldconv_gather_fwd as ldconv_gather
    from experiment_yolo_torch.ops.kernels.ldconv_gather import ldconv_gather_plain

    got = [ldconv_gather(x, o, s) for x, o, s in ld]
    err = max((a - ldconv_gather_plain(x, o, s)).abs().max().item() for a, (x, o, s) in zip(got, ld))
    check(err <= 1e-5, f"K3 ldconv_gather disagrees with its plain version: max abs err {err}")
    rand_err = max((ldconv_gather(x, o, s) - ldconv_gather_plain(x, o, s)).abs().max().item() for x, o, s in rand_ld)
    check(rand_err <= 1e-5, f"K3 ldconv_gather disagrees with its plain version on random offsets: {rand_err}")

    def library(layers, gs):
        return [F.grid_sample(x, g, mode="bilinear", padding_mode="border", align_corners=True)
                for (x, _, _), g in zip(layers, gs)]

    def kernel(layers):
        return [ldconv_gather(x, o, s) for x, o, s in layers]

    ms = cuda_ms(lambda: kernel(ld))
    dev_ms = device_ms(lambda: kernel(ld), "ldconv_gather_kernel", len(ld))
    plain_ms = cuda_ms(lambda: [ldconv_gather_plain(x, o, s) for x, o, s in ld], PLAIN_RUNS, 1)
    main_grids, rand_grids = grid_sample_grids(ld), grid_sample_grids(rand_ld)
    library_ms = cuda_ms(lambda: library(ld, main_grids))
    # ten calls cost the host more than the card, for the kernel and for the library: their device times beside them
    library_device_ms = device_ms(lambda: library(ld, main_grids), "grid_sampler", len(ld))
    random = {"max_abs_err": rand_err, "ms": cuda_ms(lambda: kernel(rand_ld)),
              "device_ms": device_ms(lambda: kernel(rand_ld), "ldconv_gather_kernel", len(ld)),
              "library_ms": cuda_ms(lambda: library(rand_ld, rand_grids)),
              "library_device_ms": device_ms(lambda: library(rand_ld, rand_grids), "grid_sampler", len(ld))}
    nbytes = ops = 0
    layers = []
    for (x, o, s), (_, ro, _), y in zip(ld, rand_ld, got):
        b, n2, h, w = o.shape
        cost = ((x.numel() + o.numel() + y.numel()) * 4,
                y.numel() * 9 + b * h * w * (n2 // 2) * 24)  # 4 products, 3 sums, 2 scalings; positions and weights
        nbytes, ops = nbytes + cost[0], ops + cost[1]
        layers.append({"shape": f"{tuple(x.shape)}->{tuple(y.shape)}", "stride": s,
                       "device_ms": device_ms(lambda: ldconv_gather(x, o, s), "ldconv_gather_kernel", 1),
                       "random_device_ms": device_ms(lambda: ldconv_gather(x, ro, s), "ldconv_gather_kernel", 1),
                       "bound_ms": bound(*cost)[0]})
    b_ms, b_by = bound(nbytes, ops)
    shapes = [row["shape"] for row in layers]
    return dict(name="ldconv_gather", route="cuda", source="experiment_yolo_torch/csrc/ldconv_gather.cu",
                replaces="experiment_yolo_tpu/ops/pallas/ldconv_kernel.py:29", max_abs_err=max(err, rand_err),
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                main_path_max_abs_err=err, library_device_ms=library_device_ms, random_offsets=random, shapes=shapes,
                layers=layers)


def k5_bound(out, k: int):
    """(least ms, what bounds it, the two times) of soft-NMS on one batch whose
    plain output is ``out`` (B, K): each image runs one step per kept box and
    one more that does not keep (at most min(300, K)), and each step needs
    ceil(log2 K) dependent compares for its argmax at 4 clocks each; the
    busiest image bounds the batch. Its bytes (boxes, scores and flags read,
    scores written: 25 per candidate) beside it."""
    steps = int(((out > -1).sum(1) + 1).clamp(max=min(300, k)).max())
    times = {"chain_ms": steps * math.ceil(math.log2(max(k, 2))) * DEPENDENT_OP_CLOCKS / SM_CLOCK_HZ * 1e3,
             "bytes_ms": out.numel() * 25 / HBM_BYTES_PER_S * 1e3}
    worst = max(times, key=times.get)
    return times[worst], "operations" if worst == "chain_ms" else "bytes", times, steps


def check_k5(pools, serve_pool):
    """K5 against its plain version on the val batches' own pools
    (``pools``: (label, args, kw) with args (boxes, scores, valid, iou_thres,
    max_det)) and on made-up pools, each with and without the quirk:
    identical kept sets, kept scores within K5_RTOL relative, and every
    output bit-equal (the same rounded operations). Timed on the
    first val pool, beside its bound; the serving path's pool (K = 1,024, one
    label per anchor) timed too."""
    import torch

    from experiment_yolo_torch.ops.kernels.soft_nms import soft_nms, soft_nms_plain
    from experiment_yolo_torch.utils.seeded import soft_nms_cases

    def held(label, args, kw):
        got, want = soft_nms(*args, **kw), soft_nms_plain(*args, **kw)
        torch.cuda.synchronize()
        kept = want > -1
        check(bool(((got > -1) == kept).all()), f"K5 soft_nms: kept sets differ from its plain version on {label}")
        rel = ((got - want).abs()[kept] / want[kept].abs()).max().item() if bool(kept.any()) else 0.0
        check(rel <= K5_RTOL, f"K5 soft_nms: kept scores differ from its plain version by {rel} relative on {label}")
        check(torch.equal(got, want), f"K5 soft_nms: not bit-equal to its plain version on {label}")
        return {"K": args[0].shape[1], "images": args[0].shape[0], "kept": int(kept.sum()),
                "valid": int(args[2].sum()), "max_abs_err": (got - want).abs().max().item(), "rel_err": rel,
                "bit_equal": True}

    main = {label: held(label, args, kw) for label, args, kw in pools}
    made_up = {}
    for label, (boxes, scores, valid, thr, first_idx, n_valid) in soft_nms_cases(SEED + 6, "cuda").items():
        for quirk in (False, True):
            kw = {"first_idx": first_idx, "n_valid": n_valid} if quirk else {}
            row = held(f"the {label} case" + (" (quirk)" if quirk else ""), (boxes, scores, valid, thr, 300), kw)
            row["device_ms"] = device_ms(lambda: soft_nms(boxes, scores, valid, thr, 300, **kw),
                                         "soft_nms_kernel", 1)
            made_up[label + (" quirk" if quirk else "")] = row
    label, args, kw = pools[0]
    ms = cuda_ms(lambda: soft_nms(*args, **kw))
    dev_ms = device_ms(lambda: soft_nms(*args, **kw), "soft_nms_kernel", 1)
    out = soft_nms_plain(*args, **kw)
    plain_ms = cuda_ms(lambda: soft_nms_plain(*args, **kw), PLAIN_RUNS, 1)
    b_ms, b_by, parts, steps = k5_bound(out, args[0].shape[1])
    s_out = soft_nms_plain(*serve_pool)
    serve = {"K": serve_pool[0].shape[1], "kept": int((s_out > -1).sum()), "ms": cuda_ms(lambda: soft_nms(*serve_pool)),
             "device_ms": device_ms(lambda: soft_nms(*serve_pool), "soft_nms_kernel", 1),
             "plain_ms": cuda_ms(lambda: soft_nms_plain(*serve_pool), PLAIN_RUNS, 1),
             "bound_ms": k5_bound(s_out, serve_pool[0].shape[1])[0],
             **{k: v for k, v in held("the serving pool", serve_pool, {}).items() if k in ("rel_err", "bit_equal")}}
    rows = (*main.values(), *made_up.values())
    err, rel = max(r["max_abs_err"] for r in rows), max(r["rel_err"] for r in rows)
    return dict(name="soft_nms", route="cuda", source="experiment_yolo_torch/csrc/soft_nms.cu",
                replaces="experiment_yolo_tpu/ops/nms.py:129", max_abs_err=err, rel_err=rel, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, timed_on=label,
                bound_parts=parts, bound_steps=steps,
                bound_assumption=f"the busiest image's {steps} steps (kept boxes and the one that stops), each "
                                 f"ceil(log2 K) dependent compares at {DEPENDENT_OP_CLOCKS} clocks, "
                                 f"{SM_CLOCK_HZ / 1e9} GHz; 25 bytes per candidate over HBM",
                main_path_pools=main, made_up=made_up,
                serving_pool=serve, library="none: no single PyTorch call computes soft-NMS")


def val_batches(nc: int):
    """VAL_BATCHES seeded labelled batches of BATCH at IMGSZ in the val
    loader's format: letterboxed at gain 1 and no pad."""
    import numpy as np

    from experiment_yolo_torch.utils.seeded import VAL_SEED, seeded_batch

    extra = {"ori_shape": np.full((BATCH, 2), IMGSZ, np.int32),
             "ratio_pad": np.tile(np.float32([1.0, 0.0, 0.0]), (BATCH, 1))}
    return [{**seeded_batch(BATCH, IMGSZ, SEED + VAL_SEED + i, nc=nc), **extra} for i in range(VAL_BATCHES)]


def validate_timed(model, batches, counters, card):
    """``DetectionValidator`` with soft-NMS in quirk mode and with hard NMS,
    every launch counter at 0 just before each run and read just after; the
    time of each batch is taken between the validator's requests for the
    next one (forward, NMS, copy to the host, matching). Returns the results
    per protocol and the launches of both runs."""
    import torch

    from experiment_yolo_torch import DetectionValidator

    out, launches = {}, dict.fromkeys(counters, 0)
    n = len(batches)
    for label, args in VAL_PROTOCOLS.items():
        validator = DetectionValidator(args)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        stamps = []

        def timed():
            for b in batches:
                stamps.append(time.perf_counter())
                yield b

        stats = validator(model, timed(), model.names)
        stamps.append(time.perf_counter())
        run = {name: fn.launches for name, fn in counters.items()}
        want = dict.fromkeys(counters, 0)
        want.update(dfl_decode=n, ldconv_gather=10 * n)
        want["soft_nms" if args["nms_type"] == "soft" else "nms_suppress"] = n
        check(run == want, f"the {label} val main path launched {run}, expected {want}")
        for name in launches:
            launches[name] += run[name]
        batch_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        median_ms = statistics.median(batch_ms)
        out[label] = {"stats": stats, "batches": n, "batch_ms": batch_ms, "batch_ms_median": median_ms,
                      "batch_ms_min": min(batch_ms), "batch_ms_max": max(batch_ms),
                      "img_per_s_at_median": BATCH / median_ms * 1e3,
                      "img_per_s_overall": n * BATCH / sum(batch_ms) * 1e3, "launches": run}
        log(f"validated {CFG} {label}: {n} batches of {BATCH} at {IMGSZ}: median {median_ms:.2f} ms per batch (min "
            f"{min(batch_ms):.2f}, max {max(batch_ms):.2f}), {out[label]['img_per_s_at_median']:.2f} img/s at the "
            f"median, stats {stats}, launches {run}, {card}")
    return out, launches


def val_pools_and_plain_stats(model, batches):
    """Each val batch's decoded maps once: its soft-NMS pools (multi-label,
    K = 4,096 at conf 0.001, quirk on and off) for K5's check, and the
    validator's soft-quirk stats with K5 and with the plain loop on those
    same maps, which must be equal."""
    import torch

    import experiment_yolo_torch.ops.nms as nms
    from experiment_yolo_torch import DetectionValidator
    from experiment_yolo_torch.ops.kernels.soft_nms import soft_nms, soft_nms_plain
    from experiment_yolo_torch.utils.metrics import DetMetrics
    from experiment_yolo_torch.utils.seeded import model_input, soft_nms_pools

    validator = DetectionValidator({**VAL_PROTOCOLS["soft-quirk"], "verbose": False})
    metrics = {"kernel": DetMetrics(), "plain": DetMetrics()}
    counts = {"kernel": [], "plain": []}
    pools = []
    for i, b in enumerate(batches):
        with torch.no_grad():
            boxes, scores = model.predict(model_input(b["img"], "cuda"))  # as infer does
        for kind, fn in (("kernel", soft_nms), ("plain", soft_nms_plain)):
            nms.soft_nms = fn
            try:
                det, n = (t.cpu().numpy() for t in validator.nms(boxes, scores))
            finally:
                nms.soft_nms = soft_nms
            validator.score_batch(metrics[kind], det, n, b)
            counts[kind] += n.tolist()
        pools += [(f"val batch {i}{quirk}", args, kw)
                  for quirk, (args, kw) in soft_nms_pools(boxes, scores, val=True).items()]
    stats = {kind: m.result() for kind, m in metrics.items()}
    check(counts["kernel"] == counts["plain"], f"val detections per image with K5 {counts['kernel']}, plain loop "
                                               f"{counts['plain']}")
    check(stats["kernel"] == stats["plain"], f"val stats with K5 {stats['kernel']} != plain loop {stats['plain']}")
    return pools, {"stats_with_k5": stats["kernel"], "stats_with_plain_loop": stats["plain"],
                   "detections_per_image": counts["kernel"]}


def capture_train_inputs(trainer, batch, n_ldconv=10, n_levels=3, n_decodes=1):
    """One training step with hooks on the two differentiable kernels: each
    LDConv's (source, offsets, stride, incoming gradient) and each level's
    (Detect map, every level's decoded distances and their incoming gradient,
    the level's first anchor in them), as the step hands them to K3, K1 and
    their backward kernels; the model must have ``n_ldconv`` LDConv layers
    and ``n_levels`` Detect levels, decoded by ``n_decodes`` K1 calls (2 for
    a DetectAux, main then aux; the levels of both are returned). Separate
    from :func:`capture_inputs`, which runs under ``no_grad``."""
    import experiment_yolo_torch.nn.modules as modules
    import experiment_yolo_torch.utils.loss as loss

    ld, calls = [], []
    gather, decode = modules.ldconv_gather, loss.dfl_decode_levels

    def keep_grad(out, entry):
        out.register_hook(lambda g: entry.append(g.detach().contiguous().clone()))

    def gather_hook(x, off, stride):
        out = gather(x, off, stride)
        ld.append([x.detach(), off.detach(), stride])
        keep_grad(out, ld[-1])
        return out

    def decode_hook(feats, reg_max=16):
        out = decode(feats, reg_max)
        calls.append([[f.detach() for f in feats], out.detach()])
        keep_grad(out, calls[-1])
        return out

    modules.ldconv_gather, loss.dfl_decode_levels = gather_hook, decode_hook
    try:
        trainer.train_step(batch)
    finally:
        modules.ldconv_gather, loss.dfl_decode_levels = gather, decode
    check(len(ld) == n_ldconv and all(len(e) == 4 for e in ld),
          f"captured {len(ld)} LDConv backward inputs, expected {n_ldconv}")
    check(len(calls) == n_decodes and all(len(c) == 3 and len(c[0]) == n_levels for c in calls),
          f"captured {len(calls)} decode calls, expected {n_decodes} of {n_levels} levels with their gradient")
    levels = []
    for maps, y, g in calls:
        first = 0
        for f in maps:  # each level's backward reads y and g in place, from its first anchor
            levels.append((f, y, g, first))
            first += f.shape[2] * f.shape[3]
    return [tuple(e) for e in ld], levels


def _rel_err(got, want):
    """(max abs error, and the worst of each pair's max abs error over that
    pair's own largest plain value) of tensor pairs, so that every output of
    every layer is held on its own scale."""
    errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
    return max(errs), max(e / max(b.abs().max().item(), 1e-30) for e, b in zip(errs, want))


def k1_bwd_calls(levels):
    """K1's backward on a step's ``levels`` (Detect map, concatenated
    distances, their gradient, the level's first anchor), one launch a level
    reading ``y`` and ``g`` in place, and its plain version on each level's
    slice of them."""
    from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode_bwd, dfl_decode_bwd_plain

    def kernel():
        return [dfl_decode_bwd(f, y, g, 16, first) for f, y, g, first in levels]

    def plain():
        return [dfl_decode_bwd_plain(f, y[:, first:first + f.shape[2] * f.shape[3]],
                                     g[:, first:first + f.shape[2] * f.shape[3]]) for f, y, g, first in levels]

    return kernel, plain


def check_k1_bwd(levels):
    kernel, plain = k1_bwd_calls(levels)
    err, rel = _rel_err(kernel(), plain())
    check(rel <= BWD_RTOL, f"K1 dfl_decode_bwd disagrees with its plain version: max abs err {err} ({rel} relative)")
    groups = sum(f.shape[0] * f.shape[2] * f.shape[3] * 4 for f, *_ in levels)
    no = levels[0][0].shape[1]
    # per anchor: 64 box logits, y and g (4 each) read; the whole dx map (no channels) written
    nbytes = sum(f.shape[0] * f.shape[2] * f.shape[3] * (64 + 4 + 4 + no) * 4 for f, *_ in levels)
    b_ms, b_by = bound(nbytes, groups * 16 * 10)  # per bin: max, 2 exps and subs, sum, then p*g*(r-y)
    return dict(name="dfl_decode_bwd", route="cuda", source="experiment_yolo_torch/csrc/dfl_decode.cu",
                replaces="experiment_yolo_tpu/ops/pallas/dfl_decode.py:53", max_abs_err=err, rel_err=rel,
                ms=cuda_ms(kernel), device_ms=device_ms(kernel, "dfl_decode_bwd_kernel", len(levels)),
                plain_ms=cuda_ms(plain), bound_ms=b_ms, bound_by=b_by, library_ms=None, per_call=len(levels),
                shapes=[f"{tuple(f.shape)}->{tuple(f.shape)}" for f, *_ in levels])


def check_k3_bwd(ld, rand_ld):
    """K3's backward against its plain version on one training step's inputs,
    on phase 5's random offsets, on contention offsets (90% of each layer's
    samples on sixteen source positions) and on seam offsets, and on the same
    layers at RAGGED_IMGSZ on random, contention and seam offsets, each
    output (``dx``, ``doff``) of each layer within BWD_RTOL of its own largest
    plain value; on the contention offsets the kernel's and the plain
    version's errors against the plain version summed in float64 are
    reported beside that gate. K3's forward is held bit-equal to its plain
    version on the RAGGED_IMGSZ layers. Device times sum every launch the
    wrapper makes, the zero fill of ``dx`` included; also layer by layer
    beside each layer's bytes bound."""
    import torch
    import torch.nn.functional as F

    from experiment_yolo_torch.ops.kernels.ldconv_gather import (ldconv_gather_bwd, ldconv_gather_bwd_plain,
                                                                 ldconv_gather_fwd, ldconv_gather_plain)
    from experiment_yolo_torch.utils.seeded import contention_offsets, seam_offsets

    bwd_kernel = "ldconv_gather_bwd_kernel"  # timed with every event of its calls: dx's fill, a memset of doff

    def kernel(layers):
        return [t for x, o, dy, s in layers for t in ldconv_gather_bwd(x, o, dy, s)]

    def plain(layers):
        return [t for x, o, dy, s in layers for t in ldconv_gather_bwd_plain(x, o, dy, s)]

    main = [(x, o, dy, s) for x, o, s, dy in ld]
    gen = torch.Generator().manual_seed(SEED + 3)
    rand = [(x, o, torch.randn(dy.shape, generator=gen).to(dy.device), s)
            for (x, o, s), (_, _, _, dy) in zip(rand_ld, ld)]
    contended = [(x, contention_offsets(x, o, s, gen), dy, s) for x, o, dy, s in rand]
    seam = [(x, seam_offsets(x, o, s), dy, s) for x, o, dy, s in rand]
    # the same layers at RAGGED_IMGSZ: every source and output side scaled, random sources and gradients
    ragged = []
    for x, o, dy, s in main:
        b, c, hx, wx = x.shape
        hx, wx = hx * RAGGED_IMGSZ // IMGSZ, wx * RAGGED_IMGSZ // IMGSZ
        o = torch.empty(b, o.shape[1], hx // s, wx // s, device=o.device)
        ragged.append((torch.randn(b, c, hx, wx, generator=gen).to(x.device), _random_offsets_like(o, gen),
                       torch.randn(b, o.shape[2] * o.shape[3], dy.shape[2], generator=gen).to(dy.device), s))
    fwd = [(ldconv_gather_fwd(x, o, s), ldconv_gather_plain(x, o, s)) for x, o, _, s in ragged]
    fwd_err = max((a - b).abs().max().item() for a, b in fwd)
    check(all(torch.equal(a, b) for a, b in fwd),
          f"K3 ldconv_gather is not bit-equal to its plain version at imgsz {RAGGED_IMGSZ}: max abs err {fwd_err}")
    del fwd
    errs, vs_f64 = {}, {}
    ragged_contended = [(x, contention_offsets(x, o, s, gen), dy, s) for x, o, dy, s in ragged]
    for kind, layers in (("main", main), ("random", rand), ("contention", contended), ("seam", seam),
                         (f"{RAGGED_IMGSZ} random", ragged), (f"{RAGGED_IMGSZ} contention", ragged_contended),
                         (f"{RAGGED_IMGSZ} seam", [(x, seam_offsets(x, o, s), dy, s) for x, o, dy, s in ragged])):
        got, want = kernel(layers), plain(layers)
        errs[kind] = _rel_err(got, want)
        check(errs[kind][1] <= BWD_RTOL, f"K3 ldconv_gather_bwd disagrees with its plain version on {kind} offsets: "
                                         f"{errs[kind][0]} ({errs[kind][1]} relative)")
        if "contention" in kind:  # reported, not gated: how far each float32 order is from float64 sums
            exact = [t for x, o, dy, s in layers for t in ldconv_gather_bwd_plain(x, o, dy, s, torch.float64)]
            vs_f64[kind] = {"kernel": _rel_err(got, exact), "plain": _rel_err(want, exact)}
            del exact

    # F.grid_sample's backward on the same positions and incoming gradients
    grids = grid_sample_grids([(x, o, s) for x, o, _, s in main])
    xs = [x.clone().requires_grad_() for x, _, _, _ in main]
    gs = [g.requires_grad_() for g in grids]
    outs = [F.grid_sample(x, g, mode="bilinear", padding_mode="border", align_corners=True) for x, g in zip(xs, gs)]
    dys = [dy.reshape(dy.shape[0], dy.shape[1], o.shape[1] // 2, -1).permute(0, 3, 1, 2).contiguous()
           for _, o, dy, _ in main]  # (B, C, hw, N), grid_sample's output layout
    library_ms = cuda_ms(lambda: torch.autograd.grad(outs, xs + gs, dys, retain_graph=True))

    def cost(x, o, dy):
        b, n2, h, w = o.shape
        return ((2 * x.numel() + 2 * o.numel() + dy.numel()) * 4,  # x, off, dy read; dx, doff written
                dy.numel() * 23 + b * h * w * (n2 // 2) * 30)  # per channel: d, 2 x 7 for the offsets, 4 + 4 scatter

    nbytes = ops = 0
    layers = []
    for i, (x, o, dy, s) in enumerate(main):
        nb, op = cost(x, o, dy)
        nbytes, ops = nbytes + nb, ops + op
        layers.append({"shape": f"{tuple(dy.shape)}->{tuple(x.shape)},{tuple(o.shape)}", "stride": s,
                       "device_ms": device_ms(lambda: ldconv_gather_bwd(x, o, dy, s), bwd_kernel, 1, span=""),
                       "random_device_ms": device_ms(lambda: ldconv_gather_bwd(*rand[i][:3], s), bwd_kernel, 1,
                                                     span=""),
                       "contention_device_ms": device_ms(lambda: ldconv_gather_bwd(*contended[i][:3], s), bwd_kernel,
                                                         1, span=""),
                       "bound_ms": bound(nb, op)[0]})
    b_ms, b_by = bound(nbytes, ops)
    err, rel = max(e for e, _ in errs.values()), max(r for _, r in errs.values())
    return dict(name="ldconv_gather_bwd", route="cuda", source="experiment_yolo_torch/csrc/ldconv_gather.cu",
                replaces="experiment_yolo_tpu/nn/modules.py:469", max_abs_err=err, rel_err=rel,
                ms=cuda_ms(lambda: kernel(main)),
                device_ms=device_ms(lambda: kernel(main), bwd_kernel, len(main), span=""),
                plain_ms=cuda_ms(lambda: plain(main), PLAIN_RUNS, 1), bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms,
                main_path={"max_abs_err": errs["main"][0], "rel_err": errs["main"][1]},
                other_offsets={kind: {"max_abs_err": e, "rel_err": r} for kind, (e, r) in errs.items()
                               if kind not in ("main", "random", "contention")},
                ragged_shapes=[f"{tuple(dy.shape)}->{tuple(x.shape)},{tuple(o.shape)}" for x, o, dy, _ in ragged],
                forward_at_ragged_imgsz={"imgsz": RAGGED_IMGSZ, "bit_equal": True, "max_abs_err": fwd_err},
                contention_vs_float64={kind: {who: {"max_abs_err": e, "rel_err": r} for who, (e, r) in v.items()}
                                       for kind, v in vs_f64.items()},
                random_offsets={"max_abs_err": errs["random"][0], "rel_err": errs["random"][1],
                                "ms": cuda_ms(lambda: kernel(rand)),
                                "device_ms": device_ms(lambda: kernel(rand), bwd_kernel, len(rand), span="")},
                contention_offsets={"max_abs_err": errs["contention"][0], "rel_err": errs["contention"][1],
                                    "ms": cuda_ms(lambda: kernel(contended)),
                                    "device_ms": device_ms(lambda: kernel(contended), bwd_kernel, len(contended),
                                                           span="")},
                device_ms_counts="every launch of the wrapper, the zero fill of dx included", layers=layers)


def train_timed(trainer, batches, counters):
    """TRAIN_WARMUP steps, then TRAIN_STEPS timed steps (host clock around
    each step and a synchronize) with every launch counter at 0 just before;
    returns the step times, the launches and the last losses."""
    import torch

    model = trainer.state.model
    for i in range(TRAIN_WARMUP):
        trainer.train_step(batches[i % len(batches)])
    before = [t.detach().clone() for t in model.parameters()]
    ema_before = [t.detach().clone() for t in trainer.state.ema.ema.parameters()]
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    step_ms, finite = [], []
    for i in range(TRAIN_STEPS):
        t = time.perf_counter()
        comps = trainer.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        finite.append(torch.stack([torch.isfinite(torch.stack([v.float() for v in comps.values()])).all()]
                                  + [torch.isfinite(g).all() for g in grads]).all())
        check(len(grads) == len(before), f"step {i}: {len(before) - len(grads)} parameters have no gradient")
    launches = {name: fn.launches for name, fn in counters.items()}
    check(bool(torch.stack(finite).all()), "a loss or a gradient of the timed steps is not finite")
    moved = sum(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    ema_moved = sum(not torch.equal(a, b) for a, b in zip(ema_before, trainer.state.ema.ema.parameters()))
    check(moved > 0 and ema_moved > 0, f"parameters moved {moved}, EMA moved {ema_moved}: expected both > 0")
    return step_ms, launches, {k: v.item() for k, v in comps.items()}, moved, ema_moved


def ldconv_position_margins(layers):
    """The least distance of any sample position of ``layers`` ((source,
    offsets, stride) of each LDConv) to a whole number, and to a rail: a
    padded position 0 or size_padded - 1 (clamp and gate), or R or R + size
    - 1 (the border multiplier), rows and columns alike."""
    import torch

    from experiment_yolo_torch.ops.kernels.ldconv_gather import WINDOW_R, _samples

    whole = rail = math.inf
    for x, off, stride in layers:
        pr, pc, _, _, _, (hp, wp) = _samples(x, off, stride)
        for pos, size, padded in ((pr, x.shape[2], hp), (pc, x.shape[3], wp)):
            whole = min(whole, (pos - pos.round()).abs().min().item())
            rails = torch.tensor([0.0, padded - 1.0, WINDOW_R, WINDOW_R + size - 1.0])
            rail = min(rail, (pos[..., None] - rails).abs().min().item())
    return whole, rail


class CardPicks:
    """The card's picks at the step functions of a forward, handed to the CPU.

    The bilinear floor, the border multiplier and the rail gate of LDConv's
    gather, ScalSeq's max over its three scales and the kink of its
    LeakyReLU, ZoomCat's 2x2 max pool and SPPF's max pools are step functions
    of their inputs: a value within rounding of a step may fall on the other
    side on each device, which moves a gradient by O(1) while both sides are
    right. Under :meth:`on` with ``"cuda"`` each of them records its pick;
    under ``"cpu"`` each takes the card's next one, in call order, and
    records its own margin (the gradient of LDConv's offsets flows into the
    CPU's own ``p_conv``)."""

    def __init__(self):
        self.offsets, self.cpu_layers, self.scales, self.scale_gaps = [], [], [], []
        self.windows, self.window_gaps, self.pools, self.pool_gaps = [], [], [], []
        self.signs, self.kink_gaps = [], []

    def counts(self, all_lists=False):
        """(LDConv, ScalSeq, ZoomCat, SPPF) picks taken on both sides, or
        every list's length."""
        lists = (self.offsets, self.cpu_layers, self.scales, self.scale_gaps, self.signs, self.kink_gaps,
                 self.windows, self.window_gaps, self.pools, self.pool_gaps)
        if all_lists:
            return [len(x) for x in lists]
        pairs = [(len(a), len(b)) for a, b in zip(lists[::2], lists[1::2])]
        if any(a != b for a, b in pairs) or pairs[1] != pairs[2]:
            return None
        return pairs[0][0], pairs[1][0], pairs[3][0], pairs[4][0]

    @contextlib.contextmanager
    def on(self, dev: str, n_sppf: int = 1):
        import torch
        import torch.nn.functional as F

        import experiment_yolo_torch.nn.modules as modules

        gather, scale_max, window_max = modules.ldconv_gather, modules.ScalSeq.scale_max, modules.ZoomCat.window_max
        scale_act, sppf_forward = modules.ScalSeq.act, modules.SPPF.forward
        card = dev == "cuda"

        def card_gather(x, off, stride):
            self.offsets.append(off.detach().cpu())
            return gather(x, off, stride)

        def cpu_gather(x, off, stride):
            self.cpu_layers.append((x.detach(), off.detach().clone(), stride))
            return gather(x, self.offsets[len(self.cpu_layers) - 1] + (off - off.detach()), stride)

        def card_max(z):
            self.scales.append(z.detach().argmax(2, keepdim=True).cpu())
            return scale_max(z)

        def cpu_max(z):
            top2 = z.detach().topk(2, dim=2).values
            self.scale_gaps.append((top2[:, :, 0] - top2[:, :, 1]).min().item())
            return z.gather(2, self.scales[len(self.scale_gaps) - 1]).squeeze(2)

        def card_act(y):
            self.signs.append((y.detach() > 0).cpu())
            return scale_act(y)

        def cpu_act(y):
            self.kink_gaps.append(y.detach().abs().min().item())
            return torch.where(self.signs[len(self.kink_gaps) - 1], y, 0.1 * y)

        def card_window_max(x):
            y, idx = F.max_pool2d(x, 2, return_indices=True)
            self.windows.append(idx.cpu())
            return y

        def cpu_window_max(x):
            b, c, h, w = x.shape
            windows = x.detach().reshape(b, c, h // 2, 2, w // 2, 2).transpose(3, 4).reshape(b, c, h // 2, w // 2, 4)
            top2 = windows.topk(2, dim=-1).values
            self.window_gaps.append((top2[..., 0] - top2[..., 1]).min().item())
            idx = self.windows[len(self.window_gaps) - 1]
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

        # SPPF's max pools (k x k, stride 1, padded with -inf)
        def sppf_with(pool):
            def forward(self_, x):
                ys = [self_.cv1(x)]
                for _ in range(3):
                    ys.append(pool(ys[-1], self_.m.kernel_size, self_.m.padding))
                return self_.cv2(torch.cat(ys, 1))
            return forward

        def card_pool(x, k, pad):
            y, idx = F.max_pool2d(x, k, 1, pad, return_indices=True)
            self.pools.append(idx.cpu())
            return y

        def cpu_pool(x, k, pad):
            b, c, h, w = x.shape
            windows = F.unfold(F.pad(x.detach(), (pad,) * 4, value=-math.inf), k).view(b, c, k * k, h * w)
            top2 = windows.topk(2, dim=2).values
            self.pool_gaps.append((top2[:, :, 0] - top2[:, :, 1]).min().item())
            idx = self.pools[len(self.pool_gaps) - 1]
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

        modules.ldconv_gather = card_gather if card else cpu_gather
        modules.ScalSeq.scale_max = staticmethod(card_max if card else cpu_max)
        modules.ScalSeq.act = staticmethod(card_act if card else cpu_act)
        modules.ZoomCat.window_max = staticmethod(card_window_max if card else cpu_window_max)
        if n_sppf:
            modules.SPPF.forward = sppf_with(card_pool if card else cpu_pool)
        try:
            yield self
        finally:
            modules.ldconv_gather, modules.ScalSeq.scale_max = gather, staticmethod(scale_max)
            modules.ScalSeq.act = staticmethod(scale_act)
            modules.ZoomCat.window_max, modules.SPPF.forward = staticmethod(window_max), sppf_forward

    def report(self):
        """The largest difference of the two sides' raw offsets, the least
        distance of the CPU's own positions to a whole number and to a rail,
        and the least gap or magnitude at each other step."""
        offset_diff = max(((a - c).abs().max().item() for a, (_, c, _) in zip(self.offsets, self.cpu_layers)),
                          default=None)
        to_whole, to_rail = ldconv_position_margins(self.cpu_layers) if self.cpu_layers else (None, None)
        return {"ldconv_offsets_card_vs_cpu_max_abs_diff": offset_diff,
                "cpu_positions_least_distance_to_whole_number": to_whole,
                "cpu_positions_least_distance_to_rail": to_rail,
                "cpu_scalseq_least_gap_of_top_two_scales": min(self.scale_gaps, default=None),
                "cpu_scalseq_least_magnitude_at_the_kink": min(self.kink_gaps, default=None),
                "cpu_zoomcat_least_gap_of_top_two_in_a_window": min(self.window_gaps, default=None),
                "cpu_sppf_least_gap_of_top_two_in_a_window": min(self.pool_gaps, default=None)}


class Handover:
    """A function of a step, its result taken on the card and held on the
    CPU. Under :meth:`on` with ``"cuda"``, ``module.name`` runs and
    ``record(out, args, kwargs)`` keeps what the comparison needs, on the
    host; under ``"cpu"`` it runs on the CPU's own inputs and
    ``hand_over(fn, out, kept, args, kwargs)`` gives (what the CPU step goes
    on with, a report): where the two sides part, the card's result, and how
    near the tie between them was."""

    def __init__(self, module, name: str, record, hand_over):
        self.module, self.name, self.record, self.hand_over = module, name, record, hand_over
        self.kept, self.facts = None, {}

    @contextlib.contextmanager
    def on(self, dev: str, active: bool = True):
        fn = getattr(self.module, self.name)

        def card(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.kept = self.record(out, args, kwargs)
            return out

        def cpu(*args, **kwargs):
            out, self.facts = self.hand_over(fn, fn(*args, **kwargs), self.kept, args, kwargs)
            return out

        if active:
            setattr(self.module, self.name, card if dev == "cuda" else cpu)
        try:
            yield self
        finally:
            setattr(self.module, self.name, fn)

    def report(self):
        return self.facts if self.kept is not None else {}


def mask_handover():
    """The mask loss's top-64 foreground anchors of a segment step
    (``utils/task_losses.py:top_foreground``): tied target scores are ordered
    alike on both sides (a stable sort), but near-equal ones may swap across
    the cut. Where the CPU's picks differ from the card's, the CPU step takes
    the card's; the least gap between the 64th and 65th weights of an image
    on the CPU is reported."""
    import torch

    import experiment_yolo_torch.engine.trainer as trainer_module

    def record(out, args, kwargs):
        return out[4].detach().cpu()

    def hand_over(fn, out, card, args, kwargs):
        res = out[2]
        w = torch.where(res.fg_mask, res.target_scores.sum(-1), -1.0).float()
        top = torch.sort(w, dim=1, descending=True, stable=True)[0]
        equal = torch.equal(out[4].cpu(), card)
        return (out if equal else fn(*args, picks=card, **kwargs),
                {"mask_top64_equal": equal, "mask_top64_cpu_took_card_picks": not equal,
                 "cpu_mask_least_gap_at_the_cut": (top[:, 63] - top[:, 64]).min().item() if top.shape[1] > 64
                 else None})

    return Handover(trainer_module, "segmentation_loss", record, hand_over)


def assign_handover():
    """The rotated assigner's result of an OBB step (``utils/tal.py:assign``
    with ``rotated``): each gt takes its top k anchors by align metric (a
    ProbIoU to the sixth power), and an anchor whose metric lies within
    rounding of a gt's k-th may fall on the other side of the cut on each
    device. The card records its result; the CPU compares its own
    foreground mask and gt indices with it. An anchor that differs is a
    near-tie when, for each gt it went to on either side, its CPU metric
    lies within TAL_TIE_RTOL of that gt's k-th metric; or, taken on both
    sides by gts that differ, its CPU overlaps with those two gts lie within
    TAL_TIE_RTOL of each other (an anchor claimed by several gts goes to the
    larger). Any other difference fails the phase; where every one is a
    near-tie the CPU step takes the card's result. The least relative gap
    between a gt's k-th and (k + 1)-th metric on the CPU is reported."""
    import inspect

    import experiment_yolo_torch.utils.tal as tal

    signature, wanted = inspect.signature(tal.assign), inspect.signature(tal.align_metrics).parameters

    def record(out, args, kwargs):
        return type(out)(*(t.cpu() for t in out))

    def hand_over(fn, out, card, args, kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        _, overlaps, metric = tal.align_metrics(**{k: v for k, v in bound.arguments.items() if k in wanted})
        k, valid = bound.arguments["topk"], bound.arguments["mask_gt"].bool()
        top = metric.sort(-1, descending=True).values
        kth = top[..., k - 1]  # (B, M)
        differ = (out.fg_mask != card.fg_mask) | (out.fg_mask & (out.target_gt_idx != card.target_gt_idx))
        far, worst = [], None
        for bi, ai in differ.nonzero().tolist():
            gts = sorted({int(r.target_gt_idx[bi, ai]) for r in (out, card) if r.fg_mask[bi, ai]})
            to_cut = max(float(abs(metric[bi, g, ai] - kth[bi, g]) / kth[bi, g]) if kth[bi, g] > 0 else math.inf
                         for g in gts)
            pair = overlaps[bi, gts, ai] if len(gts) == 2 and out.fg_mask[bi, ai] and card.fg_mask[bi, ai] else None
            apart = float(abs(pair[0] - pair[1]) / pair.max()) if pair is not None and pair.max() > 0 else math.inf
            worst = max(worst or 0.0, min(to_cut, apart))
            if min(to_cut, apart) > TAL_TIE_RTOL:
                far.append((bi, ai, gts, to_cut, apart))
        check(not far, f"the rotated assignment differs from the card's at {len(far)} anchors that are no near-tie "
                       f"(image, anchor, gts, relative distance to the cut, between the two gts' overlaps): "
                       f"{far[:5]}")
        n, held = int(differ.sum()), valid & (kth > 0)
        return (out if n == 0 else card,
                {"tal_assignment_equal": n == 0, "tal_anchors_taken_from_card": n,
                 "tal_taken_anchors_largest_relative_distance_to_a_tie": worst,
                 "cpu_tal_least_relative_gap_at_the_cut": ((top[..., k - 1] - top[..., k]) / kth)[held].min().item()
                 if bool(held.any()) else None})

    return Handover(tal, "assign", record, hand_over)


def compare_train_cpu(state_dict, batch, recipe=None, cfg=CFG, n_ldconv=10, n_scalseq=1, n_zoomcat=0, n_sppf=1,
                      imgsz=CMP_IMGSZ):
    """One step of ``cfg`` (with ``n_ldconv`` LDConv, ``n_scalseq`` ScalSeq,
    ``n_zoomcat`` ZoomCat and ``n_sppf`` SPPF layers) from the same weights
    and batch on the card and on the CPU.
    Warmup is off and ``nbs`` is the batch, so the step fires at once and
    every group, the weight group with its decay included, moves at lr0.
    ``recipe``: loss switches (Wise-IoU, NWD); then the new ``iou_mean`` is
    held too.

    The CPU step takes the card step's LDConv offsets (each ``p_conv``'s
    output, as the gather receives it): the bilinear floor, the border
    multiplier and the rail gate are step functions of the positions, and a
    position within about 1e-6 of a whole number can take the other side of
    one of them on each device, which moves ``p_conv``'s gradient by O(1)
    while both sides are right (``tests/test_torch_port_ldconv.py:
    test_positions_near_a_whole_number_move_p_conv_gradient_not_the_output``).
    The offsets' values are the card's; their gradient flows into the CPU's
    own ``p_conv``. ScalSeq's max over its three scales is another such step:
    the CPU takes the card's pick of scale for each element. It takes the
    card's side of ScalSeq's LeakyReLU kink at 0 too: one element within
    rounding of 0 taking the other slope moves ScalSeq's ``bn.bias``
    gradient by more than 1e-3 relative L2 (``tests/test_torch_port_model.py:
    test_a_value_at_scalseqs_kink_moves_bn_bias_gradient_not_the_output``).
    And it takes the card's
    pick in each 2x2 window of ZoomCat's max pool and in each window of
    SPPF's three max pools (the image size is ``imgsz``). The report gives
    the largest difference of the two sides' raw offsets, the least distance
    of the CPU's own positions to a whole number and to a rail, the least gap
    between the CPU's two largest scales and two largest values of a window,
    the least magnitude of the CPU's ScalSeq values at the kink, and the
    tensor of the largest difference of gradients, momentum buffers and
    updates. A segment ``cfg`` (``batch`` with ``masks``) adds the mask term:
    its loss component is held too, and the CPU's top-64 foreground anchors
    are held equal to the card's (:func:`mask_handover`; where they differ the
    CPU takes the card's, and the least gap at the cut is reported). An obb
    ``cfg`` (``bboxes`` (B, M, 5)) has the CPU take the card's rotated TAL
    assignment where every difference is a near-tie at a gt's top-k cut, and
    fails on any other (:func:`assign_handover`)."""
    import numpy as np

    from experiment_yolo_torch.engine.trainer import LOSS_KEYS, DetectionTrainer
    from experiment_yolo_torch.nn.tasks import guess_model_task, task_model

    picks, mask_picks, assign_picks = CardPicks(), mask_handover(), assign_handover()
    task = guess_model_task(cfg)
    out = {}
    for dev in ("cuda", "cpu"):
        model = task_model(task)(cfg, device=dev)
        model.load_state_dict(state_dict, strict=True)
        before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        trainer = DetectionTrainer(model, {"amp": False, "batch": CMP_BATCH, "imgsz": imgsz, "nbs": CMP_BATCH,
                                           "warmup_epochs": 0.0, **(recipe or {})})
        opt = trainer.state.optimizer
        lrs = opt.schedules()
        with picks.on(dev, n_sppf), mask_picks.on(dev), assign_picks.on(dev, task == "obb"):
            t = time.perf_counter()
            comps = trainer.train_step(batch)
            step_s = time.perf_counter() - t
        check(opt.updates == 1 and min(lrs[:2]) > 0, f"{dev}: the compared step fired {opt.updates} updates at "
                                                     f"(lr, bias lr, momentum) {lrs}: expected 1 with both LRs > 0")
        out[dev] = dict(comps={k: v.item() for k, v in comps.items()}, lrs=lrs, iou_mean=trainer.state.iou_mean.item(),
                        step_s=step_s,
                        grads={n: p.grad.cpu() for n, p in model.named_parameters()},
                        momentum={n: opt.state[p]["momentum_buffer"].cpu() for n, p in model.named_parameters()},
                        after={n: p.detach().cpu() for n, p in model.named_parameters()},
                        updates={n: p.detach().cpu() - before[n] for n, p in model.named_parameters()})
    check(picks.counts() == (n_ldconv, n_scalseq, n_zoomcat, 3 * n_sppf),
          f"the card and CPU steps took {picks.counts(all_lists=True)} LDConv offsets, ScalSeq picks and signs, "
          f"ZoomCat and SPPF maxima: expected {n_ldconv} LDConv layers, {n_scalseq} ScalSeq, {n_zoomcat} ZoomCat and "
          f"{3 * n_sppf} SPPF pools each")
    gpu, cpu = out["cuda"], out["cpu"]
    check(gpu["comps"]["fg"] == cpu["comps"]["fg"], f"foreground count {gpu['comps']['fg']} on the card, "
                                                      f"{cpu['comps']['fg']} on the CPU")
    keys = LOSS_KEYS[task]
    loss_rel = max(abs(gpu["comps"][k] - cpu["comps"][k]) / abs(cpu["comps"][k]) for k in keys)
    check(loss_rel <= 1e-4, f"loss components differ from the CPU's by {loss_rel} relative > 1e-4")
    check((mask_picks.kept is not None) == (task == "segment"), f"the mask term's picks: {mask_picks.report()}")

    def worst(a, b, slack=None):
        """Largest relative L2 difference over tensors, and the tensors that miss
        1e-3 relative (or 1e-6 absolute under a norm of 1e-5) by more than the
        absolute L2 allowance ``slack[n]``; the tensor of the largest difference
        is kept in ``worst_of``."""
        rels, bad = {}, []
        for n in b:
            diff, norm = float(np.linalg.norm(a[n] - b[n])), float(np.linalg.norm(b[n]))
            ok = diff <= (1e-6 if norm < 1e-5 else 1e-3 * norm) + (slack[n] if slack else 0.0)
            rels[n] = diff / norm if norm >= 1e-5 else 0.0
            if not ok:
                bad.append(n)
        worst_of.append(max(rels, key=rels.get))
        return max(rels.values()), bad

    worst_of = []
    grad_rel, bad = worst(gpu["grads"], cpu["grads"])
    check(not bad, f"gradients differ from the CPU's beyond 1e-3 relative L2: {bad[:5]}")
    mom_rel, bad = worst(gpu["momentum"], cpu["momentum"])
    check(not bad, f"momentum buffers differ from the CPU's beyond 1e-3 relative L2: {bad[:5]}")
    # a parameter near 1 that moves by 1e-4 carries f32 rounding of ~1e-3 of its update
    spacing = {n: float(np.linalg.norm(np.spacing(p.numpy()))) for n, p in cpu["after"].items()}
    upd_rel, bad = worst(gpu["updates"], cpu["updates"], spacing)
    check(not bad, f"parameter updates differ from the CPU's beyond 1e-3 relative L2: {bad[:5]}")
    iou_rel = abs(gpu["iou_mean"] - cpu["iou_mean"]) / abs(cpu["iou_mean"])
    if recipe:
        check(iou_rel <= 1e-6 and cpu["iou_mean"] != 1.0, f"iou_mean {gpu['iou_mean']} on the card, {cpu['iou_mean']} "
                                                          "on the CPU: not within 1e-6 relative, or it did not move")
    return {"imgsz": imgsz, "batch": CMP_BATCH, "loss_switches": recipe or "CIoU",
            "lr_bias_lr_momentum": gpu["lrs"], "fg": gpu["comps"]["fg"],
            "iou_mean_card": gpu["iou_mean"], "iou_mean_cpu": cpu["iou_mean"], "iou_mean_rel_err": iou_rel,
            "loss_max_rel_err": loss_rel, "grad_max_rel_l2": grad_rel, "momentum_max_rel_l2": mom_rel,
            "update_max_rel_l2": upd_rel, "worst_tensor_grad_momentum_update": worst_of,
            **picks.report(), **mask_picks.report(), **assign_picks.report(),
            "step_s_card": gpu["step_s"], "step_s_cpu": cpu["step_s"],
            "loss_card": {k: gpu["comps"][k] for k in keys},
            "loss_cpu": {k: cpu["comps"][k] for k in keys}}


def loader_ms(dataset, mosaic):
    """Host milliseconds per batch of the train loader alone (nothing else
    running): the gap between batches over one epoch, the first batch apart."""
    from experiment_yolo_torch.data import DataLoader

    loader = DataLoader(dataset, BATCH, shuffle=True, workers=8, seed=SEED, mosaic=mosaic)
    times, t = [], time.perf_counter()
    for _ in loader:
        now = time.perf_counter()
        times.append((now - t) * 1e3)
        t = now
    return {"first_ms": times[0], "median_ms": statistics.median(times[1:]), "batches": len(times)}


def trained_loop(root: Path, counters, card):
    """The dataset-driven main path: a synthetic BMP dataset written with the
    port's ``make_synthetic_dataset`` into ``root``, LD-P2 (nc=3) trained by
    ``DetectionTrainer.train()`` for LOOP_EPOCHS epochs (the last without
    mosaic), validated after each, then reloaded from ``last.pt`` and resumed
    for one more epoch. Gates: exact launch counts, finite losses, both
    checkpoints, the reload's maps bit-equal to the EMA model's, the resumed
    run's epoch and step counts. Returns the ``trained_loop`` record and the
    loop's launches."""
    import torch

    import experiment_yolo_torch.data.build as build
    from experiment_yolo_torch import DetectionModel, DetectionTrainer
    from experiment_yolo_torch.data import make_synthetic_dataset
    from experiment_yolo_torch.data.dataset import YOLODataset
    from experiment_yolo_torch.engine.checkpoint import load_checkpoint
    from experiment_yolo_torch.nn.tasks import yaml_model_load
    from experiment_yolo_torch.cfg import get_cfg

    t = time.perf_counter()
    data = make_synthetic_dataset(root / "data", n_train=LOOP_TRAIN, n_val=LOOP_VAL, imgsz=IMGSZ, seed=SEED)
    setup_s = time.perf_counter() - t
    cfg = {**yaml_model_load(CFG), "nc": LOOP_NC}
    args = {"data": str(data), "epochs": LOOP_EPOCHS, "batch": BATCH, "imgsz": IMGSZ, "workers": 8, "amp": False,
            "close_mosaic": 1, "optimizer": "SGD", "project": str(root / "runs"), "verbose": False}
    train_set = YOLODataset(root / "data" / "images" / "train", imgsz=IMGSZ, augment=True, hyp=get_cfg(args))
    nb = len(train_set) // BATCH
    alone = {"mosaic": loader_ms(train_set, None), "no_mosaic": loader_ms(train_set, False)}

    # the consumer's wait for each batch, train and val loaders apart
    waits, iterate = {True: [], False: []}, build.DataLoader.__iter__

    def timed_iter(self):
        it = iterate(self)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            waits[self.shuffle].append(time.perf_counter() - t0)
            yield item

    model = DetectionModel(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    trainer = DetectionTrainer(model, args)
    marks, losses = [], []
    trainer.callbacks.add("on_train_epoch_start", lambda trainer: marks.append(["epoch", time.perf_counter(),
                                                                                len(waits[True])]))
    trainer.callbacks.add("on_fit_epoch_end", lambda trainer: (marks.append(["end", time.perf_counter()]),
                                                               losses.append(dict(trainer.loss_items))))
    validate = trainer._validate

    def timed_validate():
        marks.append(["val", time.perf_counter(), len(waits[True])])
        return validate()

    trainer._validate = timed_validate
    for fn in counters.values():
        fn.launches = 0
    build.DataLoader.__iter__ = timed_iter
    try:
        t = time.perf_counter()
        metrics = trainer.train()
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t
    finally:
        build.DataLoader.__iter__ = iterate
    launches = {name: fn.launches for name, fn in counters.items()}
    steps, val_batches = LOOP_EPOCHS * nb, LOOP_EPOCHS * math.ceil(LOOP_VAL / BATCH)
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode=steps + val_batches, dfl_decode_bwd=3 * steps, ldconv_gather=10 * (steps + val_batches),
                ldconv_gather_bwd=10 * steps, soft_nms=val_batches)
    check(launches == want, f"the trained loop launched {launches}, expected {want}")
    check(metrics["epochs_run"] == LOOP_EPOCHS and trainer.state.step == steps,
          f"the loop ran {metrics['epochs_run']} epochs, {trainer.state.step} steps: expected {LOOP_EPOCHS}, {steps}")
    check(all(math.isfinite(v) for row in losses for v in row.values()), f"a loop epoch's loss is not finite: {losses}")
    weights = trainer.save_dir / "weights"
    check((weights / "last.pt").is_file() and (weights / "best.pt").is_file(), f"no last.pt or best.pt in {weights}")

    epochs = []
    for e in range(LOOP_EPOCHS):
        start, val, end = marks[3 * e], marks[3 * e + 1], marks[3 * e + 2]
        train_s, val_s = val[1] - start[1], end[1] - val[1]
        wait_s = sum(waits[True][start[2]:val[2]])
        epochs.append({"epoch": e + 1, "mosaic": e < LOOP_EPOCHS - 1, "train_s": train_s,
                       "img_per_s": nb * BATCH / train_s, "wait_share": wait_s / train_s,
                       "step_wall_ms": train_s / nb * 1e3, "wait_ms_per_step": wait_s / nb * 1e3,
                       "val_s": val_s, "val_img_per_s": LOOP_VAL / val_s, "losses": losses[e]})

    # the reload: last.pt's EMA weights give the trainer's EMA model's maps, bit for bit
    reloaded = load_checkpoint(weights / "last.pt").eval()
    vbatch = next(iter(trainer._validator._loader))
    x = torch.as_tensor(vbatch["img"]).to(reloaded.device).permute(0, 3, 1, 2).float().div(255.0).contiguous()
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False):
        want_maps, got_maps = trainer.state.ema.ema(x), reloaded(x)
    reload_equal = all(torch.equal(a, b) for a, b in zip(got_maps, want_maps))
    check(reload_equal, "load_checkpoint(last.pt) gives maps that differ from the trainer's EMA model's")
    del reloaded, want_maps, got_maps

    # resume=last.pt with one more epoch: exactly nb more steps
    for fn in counters.values():
        fn.launches = 0
    resumed = DetectionTrainer(DetectionModel(cfg),
                               {**args, "epochs": LOOP_EPOCHS + 1, "resume": str(weights / "last.pt")})
    t = time.perf_counter()
    rmetrics = resumed.train()
    resume_s = time.perf_counter() - t
    resumed_steps = resumed.state.step - steps
    bwd = counters["ldconv_gather_bwd"].launches
    check(rmetrics["epochs_run"] == LOOP_EPOCHS + 1 and resumed_steps == nb and bwd == 10 * nb,
          f"the resumed run: epochs_run {rmetrics['epochs_run']}, {resumed_steps} steps, {bwd} K3-backward launches; "
          f"expected {LOOP_EPOCHS + 1}, {nb}, {10 * nb}")
    for name, fn in counters.items():
        launches[name] += fn.launches
    record = {"cfg": CFG, "nc": LOOP_NC, "imgsz": IMGSZ, "batch": BATCH, "train_images": LOOP_TRAIN,
              "val_images": LOOP_VAL, "epochs": LOOP_EPOCHS, "workers": 8, "dtype": "float32",
              "dataset_write_s": setup_s, "loop_s": loop_s,
              "loop_img_per_s": steps * BATCH / loop_s, "epochs_detail": epochs,
              "loader_alone_ms_per_batch": alone, "last_val": {k: v for k, v in metrics.items() if k != "epochs_run"},
              "reload_maps_bit_equal": reload_equal, "resumed_epochs_run": rmetrics["epochs_run"],
              "resumed_steps": resumed_steps, "resume_s": resume_s, "launches_first_run": want, "card": card}
    return record, launches


def match_fraction(a, b, tol=1e-2):
    """Fraction of detections of ``a`` (N, 6) that have one in ``b`` of the same
    class with every coordinate within ``tol`` px."""
    import numpy as np

    if len(a) == 0:
        return 1.0
    if len(b) == 0:
        return 0.0
    close = (np.abs(a[:, None, :4] - b[None, :, :4]).max(-1) <= tol) & (a[:, None, 5] == b[None, :, 5])
    return float(close.any(1).mean())


def capture_scan_inputs(model, x):
    """One forward on batch ``x`` under ``no_grad``: the arguments of every
    selective-scan call, in order, as SS2D hands them to K4: (positional,
    keyword) pairs."""
    import torch

    import experiment_yolo_torch.nn.zoo_blocks as zoo

    calls, scan = [], zoo.selective_scan

    def scan_hook(*args, **kwargs):
        calls.append((args, kwargs))
        return scan(*args, **kwargs)

    zoo.selective_scan = scan_hook
    try:
        with torch.no_grad():
            feats = model(x)
    finally:
        zoo.selective_scan = scan
    return feats, calls


def k4_passes(args, sms: int) -> int:
    """The kernels one K4 call launches: the ends and carry passes only where the scan has more than one chunk."""
    from experiment_yolo_torch.ops.kernels.selective_scan import chunk_length

    bsz, g, length, dim = args[1].shape
    return 3 if length > chunk_length(bsz * g, length, dim, sms) else 1


def k4_device_ms_main() -> None:
    """Run as ``chip_smoke.py --k4-device-ms``, in a fresh process: the VSS
    model's scan calls of one forward at IMGSZ, batch BATCH (phase 4's batch),
    and the device time of one forward's ten K4 calls from a whole trace. Late
    in a long process every K4 trace has been seen to lack one launch; a fresh
    process has not. Prints one JSON line."""
    import torch

    from experiment_yolo_torch.ops.kernels import _build
    from experiment_yolo_torch.ops.kernels.selective_scan import selective_scan
    from experiment_yolo_torch.utils.seeded import letterboxed, model_input, seeded_images, seeded_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    x = model_input(letterboxed(seeded_images(BATCH, SEED), IMGSZ), "cuda")
    _, calls = capture_scan_inputs(seeded_model(VSS_CFG, SEED), x)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with torch.no_grad():
        ms = device_ms(lambda: [selective_scan(*a, **k) for a, k in calls], "selective_scan_kernel",
                       sum(k4_passes(a, sms) for a, _ in calls))
    print(json.dumps({"k4_device_ms": ms, "calls": len(calls)}), flush=True)


def k4_device_ms_fresh():
    """K4's device time per forward from :func:`k4_device_ms_main` in a
    subprocess (None if its traces lost launches too)."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--k4-device-ms"], capture_output=True,
                         text=True, timeout=600)
    check(out.returncode == 0, f"the fresh K4 timing process failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])["k4_device_ms"]


def check_k4(calls):
    """K4 against its plain version on one VSS block's call per pyramid
    level, exactly as SS2D makes it, on random inputs of the same shapes and
    at one ragged length (the seeded model's ``dt`` sits near 0.01 and its
    ``A`` and ``D`` do not differ by direction): every direction within
    K4_RTOL of its own largest plain value. Timed over the ten calls of one
    forward."""
    import torch
    import torch.nn.functional as F

    from experiment_yolo_torch.ops.kernels.selective_scan import chunk_length, selective_scan, selective_scan_plain

    levels = {}
    for args, kwargs in calls:
        levels.setdefault(args[1].shape[2], (args, kwargs))  # the first block of each sequence length
    check(sorted(levels) == [(IMGSZ // s) ** 2 for s in (32, 16, 8, 4)], f"scan lengths {sorted(levels)}")
    gen = torch.Generator().manual_seed(SEED + 4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(*shape):
        return torch.randn(shape, generator=gen).cuda()

    def random_call(bsz, length, dim):
        """Random inputs in SS2D's form: two sequences for four directions, two of them reversed (not
        SS2D's two), per-direction A and D, B and C as views of one tensor with rows of 33 floats."""
        wide = randn(bsz, 4, length, 2 * 16 + 1)
        args = (randn(bsz, 2, length, dim), F.softplus(randn(bsz, 4, length, dim)), -torch.exp(randn(4, dim, 16)),
                wide[..., 1:17], wide[..., 17:], randn(4, dim))
        return args, {"reverse": (True, False, False, True), "source": (1, 0, 0, 1)}

    def worst(got, want):
        """(max abs error, the worst direction's max abs error over that
        direction's largest plain value)."""
        err = (got - want).abs().amax((0, 2, 3))
        return err.max().item(), (err / want.abs().amax((0, 2, 3))).max().item()

    def cost(args):
        """Bytes (x, dt, A, B, C, D read once, y written once) and operations of one call: per (sequence,
        step, channel, state) 8 (dt*A, exp, dt*B, *x, h*da, +, h*C, the sum), per (sequence, step, channel) 2
        more for the skip."""
        n = args[1].numel()
        return (sum(t.numel() for t in args) + n) * 4, n * (16 * 8 + 2)

    def passes(args):
        return k4_passes(args, sms)

    def held(kind, length, args, kwargs):
        e, r = worst(selective_scan(*args, **kwargs), selective_scan_plain(*args, **kwargs))
        torch.cuda.synchronize()
        check(r <= K4_RTOL, f"K4 selective_scan disagrees with its plain version on {kind} inputs at "
                            f"L={length}: max abs err {e} ({r} of the direction's largest plain value)")
        return e, r

    detail, err, rel = [], 0.0, 0.0
    with torch.no_grad():
        for length, (args, kwargs) in sorted(levels.items()):
            x, dt, _, b, _, _ = args
            check(dt.dim() == 4 and dt.shape[1] == 4 and x.shape[1] == 2, f"a call covers x {x.shape}, dt {dt.shape}: "
                                                                           "not four directions on two sequences")
            check(kwargs.get("reverse") == (False, False, True, True) and kwargs.get("source") == (0, 1, 0, 1)
                  and not b.is_contiguous(), f"SS2D's call at L={length} is not the strided, flagged form: {kwargs}")
            bsz, _, _, dim = dt.shape
            row = {"shape_B_G_L_D": list(dt.shape), "dt_main_median": dt.median().item(), "B_row_floats": b.stride(2),
                   "chunk_steps": chunk_length(bsz * 4, length, dim, sms)}
            for kind, (a, k) in (("main", (args, kwargs)), ("random", random_call(bsz, length, dim))):
                e, r = held(kind, length, a, k)
                row[f"{kind}_max_abs_err"], row[f"{kind}_rel_err"] = e, r
                err, rel = max(err, e), max(rel, r)
            row["ms"] = cuda_ms(lambda: selective_scan(*args, **kwargs))
            row["device_ms"] = device_ms(lambda: selective_scan(*args, **kwargs), "selective_scan_kernel",
                                         passes(args))
            row["bytes"] = cost(args)[0]
            row["bound_ms"] = bound(*cost(args))[0]
            detail.append(row)
        # a length that is no multiple of the chunk or the tile, at the widest level's batch and a middle width
        bsz, dim = detail[0]["shape_B_G_L_D"][0], detail[1]["shape_B_G_L_D"][3]
        chunk = chunk_length(bsz * 4, RAGGED_SCAN_LENGTH, dim, sms)
        check(RAGGED_SCAN_LENGTH % chunk and RAGGED_SCAN_LENGTH % 8, f"L={RAGGED_SCAN_LENGTH} is not ragged for chunks of {chunk}")
        e, r = held("ragged random", RAGGED_SCAN_LENGTH, *random_call(bsz, RAGGED_SCAN_LENGTH, dim))
        err, rel = max(err, e), max(rel, r)
        ragged = {"shape_B_G_L_D": [bsz, 4, RAGGED_SCAN_LENGTH, dim], "chunk_steps": chunk, "max_abs_err": e, "rel_err": r}

        def kernel():
            return [selective_scan(*args, **kwargs) for args, kwargs in calls]

        ms, dev_ms = cuda_ms(kernel), device_ms(kernel, "selective_scan_kernel", sum(passes(a) for a, _ in calls))
        plain_ms = cuda_ms(lambda: [selective_scan_plain(*args, **kwargs) for args, kwargs in calls],
                           runs=PLAIN_SCAN_RUNS, warmup=1)
    nbytes, ops = (sum(v) for v in zip(*(cost(args) for args, _ in calls)))
    b_ms, b_by = bound(nbytes, ops)
    return dict(name="selective_scan", route="cuda", source="experiment_yolo_torch/csrc/selective_scan.cu",
                replaces="experiment_yolo_tpu/ops/pallas/selective_scan.py:50", max_abs_err=err, rel_err=rel, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, plain_runs=PLAIN_SCAN_RUNS, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                launches_per_forward=len(calls), scans_per_forward=sum(args[1].shape[1] for args, _ in calls),
                bytes_per_forward=nbytes, levels=detail, ragged=ragged)


def serve_timed(model, images, counters, per_forward, card, label):
    """SERVE_BATCHES batches of BATCH through ``DetectionPredictor`` with soft
    and then hard NMS, every launch counter at 0 just before each run and read
    just after; ``per_forward`` is the launches one forward must make. Returns
    the timings per NMS type, the launches of both runs, the hard results."""
    import numpy as np
    import torch

    from experiment_yolo_torch import DetectionPredictor

    stream = [images[i % N_IMAGES] for i in range(SERVE_BATCHES * BATCH)]
    launches = dict.fromkeys(counters, 0)
    served = {}
    hard_results = None
    for nms_type in ("soft", "hard"):
        pred = DetectionPredictor(model, {"imgsz": IMGSZ, "batch": BATCH, "nms_type": nms_type})
        pred(images[:BATCH])  # warm-up: cuDNN picks its algorithms
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        results, batch_ms = [], []
        for start in range(0, len(stream), BATCH):
            t = time.perf_counter()
            results += pred(stream[start:start + BATCH])  # ends in a copy to the host, which waits for the card
            batch_ms.append((time.perf_counter() - t) * 1e3)
        run = {name: fn.launches for name, fn in counters.items()}
        want = {name: per_forward.get(name, 0) * SERVE_BATCHES for name in counters}
        want["nms_suppress"] = SERVE_BATCHES if nms_type == "hard" else 0
        want["soft_nms"] = SERVE_BATCHES if nms_type == "soft" else 0
        check(run == want, f"{label} {nms_type} NMS main path launched {run}, expected {want}")
        for name in launches:
            launches[name] += run[name]
        check(len(results) == len(stream), f"{len(results)} results for {len(stream)} images")
        counts = [len(r) for r in results]
        check(min(counts) > 0, f"{label} {nms_type}: an image has no detections: {counts}")
        for r, img in zip(results, stream):
            d = r.boxes.data
            check(bool(np.isfinite(d).all()), f"{label} {nms_type}: non-finite detections")
            h, w = img.shape[:2]
            check(bool((d[:, [0, 2]] >= 0).all() and (d[:, [0, 2]] <= w).all() and (d[:, [1, 3]] >= 0).all()
                       and (d[:, [1, 3]] <= h).all()), f"{label} {nms_type}: boxes outside their image")
            check(bool(((d[:, 4] > CONF) & (d[:, 4] <= 1)).all() and ((d[:, 5] >= 0) & (d[:, 5] < model.nc)).all()),
                  f"{label} {nms_type}: scores or classes out of range")
        per_batch = results[::BATCH]  # every result of a batch carries that batch's speed
        median_ms = statistics.median(batch_ms)
        served[nms_type] = {
            "batches": SERVE_BATCHES, "batch_ms_median": median_ms, "batch_ms_min": min(batch_ms),
            "batch_ms_max": max(batch_ms), "batch_ms_p10_p90": statistics.quantiles(batch_ms, n=10)[::8],
            "img_per_s_at_median": BATCH / median_ms * 1e3, "img_per_s_overall": len(stream) / sum(batch_ms) * 1e3,
            "host_preprocess_ms_per_batch_median": statistics.median(r.speed["preprocess"] * BATCH for r in per_batch),
            "inference_ms_per_batch_median": statistics.median(r.speed["inference"] * BATCH for r in per_batch),
            "detections_per_image": sum(counts) / len(counts), "launches": run}
        log(f"served {label} {nms_type} NMS: {len(stream)} images in {SERVE_BATCHES} batches of {BATCH} at {IMGSZ}: "
            f"median {median_ms:.2f} ms per batch (min {min(batch_ms):.2f}, max {max(batch_ms):.2f}), "
            f"{served[nms_type]['img_per_s_at_median']:.2f} img/s at the median, launches {run}, {card}")
        if nms_type == "hard":
            hard_results = results
    check(hard_results is not None, "hard NMS did not run")
    return served, launches


def decode_against_float64(feats, strides, reg_max):
    """The card's maps decoded three ways: by K1 on the card, by the plain
    version on the CPU, and in float64 on the CPU (each group shifted by its
    max). Returns, per level, the largest error of K1 and of the plain decode
    against float64, in bins and in px (bins times the level's stride), and
    the element where K1 and the plain decode differ most in px: its level,
    image, anchor and side, its reg_max logits as hex floats, and the three
    distances."""
    import numpy as np
    import torch

    from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode_levels_fwd, dfl_decode_plain

    kernel = dfl_decode_levels_fwd(feats, reg_max).cpu().double()
    per_level, worst, first = [], None, 0
    for i, (f, s) in enumerate(zip(feats, strides)):
        x = f[:, : 4 * reg_max].cpu().double()
        b, _, h, w = x.shape
        a = h * w
        x = x.reshape(b, 4, reg_max, a)
        e = torch.exp(x - x.amax(2, keepdim=True))
        f64 = ((e * torch.arange(reg_max, dtype=torch.float64)[:, None]).sum(2) / e.sum(2)).transpose(1, 2)
        k1, plain = kernel[:, first:first + a], dfl_decode_plain(f.cpu(), reg_max).double()
        k1_err, plain_err = (k1 - f64).abs().max().item(), (plain - f64).abs().max().item()
        per_level.append({"level": i, "stride": s, "k1_max_err_bins": k1_err, "k1_max_err_px": k1_err * s,
                          "plain_max_err_bins": plain_err, "plain_max_err_px": plain_err * s})
        gap = (k1 - plain).abs() * s
        if worst is None or gap.max().item() > worst["k1_minus_plain_px"]:
            img, anchor, side = (int(v) for v in np.unravel_index(gap.argmax().item(), gap.shape))
            worst = {"k1_minus_plain_px": gap.max().item(), "level": i, "image": img, "anchor": anchor, "side": side,
                     "logits": [float(v).hex() for v in x[img, side, :, anchor].tolist()],
                     "k1": k1[img, anchor, side].item(), "plain": plain[img, anchor, side].item(),
                     "float64": f64[img, anchor, side].item()}
        first += a
    return per_level, worst


def compare_serving_cpu(cfg, model, x):
    """Batch ``x`` through ``model`` on the card and through the same weights
    on the CPU, plain versions only: raw maps, decode, hard-NMS detections.
    The decode is held on one set of card maps, decoded on the card and on
    the CPU; how far ``model.predict``'s own forward of ``x`` lands from it is
    reported, not gated, and so are K1's and the plain decode's errors against
    a float64 decode of those maps, per level (:func:`decode_against_float64`;
    on a failure of the decode gate the worst element is printed first)."""
    import numpy as np
    import torch

    from experiment_yolo_torch import DetectionModel
    from experiment_yolo_torch.ops.anchors import decode_detections
    from experiment_yolo_torch.ops.nms import non_max_suppression

    cpu = DetectionModel(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    with torch.no_grad():
        cpu_feats = cpu(x.cpu())
        feats = model(x)
        gpu_boxes, gpu_scores = decode_detections(feats, model.stride, model.nc, model.reg_max)
        predicted = model.predict(x)  # a second forward of the same batch
    repeat_err = max((a - b).abs().max().item() for a, b in zip(predicted, (gpu_boxes, gpu_scores)))
    map_err = max((a.cpu() - b).abs().max().item() for a, b in zip(feats, cpu_feats))
    check(map_err <= 1e-3, f"{cfg}: raw head maps differ from the CPU's by {map_err} > 1e-3")
    # decode and hard NMS on the card's own maps, once on the card (K1, K2) and once on the CPU (plain)
    cb, cs = decode_detections([f.cpu() for f in feats], model.stride, model.nc, model.reg_max)
    dec_err = (gpu_boxes.cpu() - cb).abs().max().item()
    decode_vs_f64, worst = decode_against_float64(feats, model.stride, model.reg_max)
    if dec_err > 1e-3:
        log(f"{cfg}: the decode's worst element: {json.dumps(worst)}")
    check(dec_err <= 1e-3, f"{cfg}: decoded boxes differ from the CPU decode of the same maps by {dec_err} px")
    # reported, not gated: this host's f32 exp against float64 on the decode's logits, each group shifted by its
    # max (the plain decode takes its exp in float64 rather than trust it: ops/kernels/dfl_decode.py)
    exp_err = 0.0
    for f in feats:
        t = f[:, : 4 * model.reg_max].float().cpu().reshape(f.shape[0], 4, model.reg_max, -1)
        d = t - t.amax(2, keepdim=True)
        e64 = torch.exp(d.double())
        keep = e64 > 1e-30
        exp_err = max(exp_err, ((torch.exp(d).double() - e64).abs()[keep] / e64[keep]).max().item())
    nms_kw = dict(conf_thres=CONF, iou_thres=IOU, nms_type="hard")
    gd, gn = non_max_suppression(gpu_boxes, gpu_scores, **nms_kw)
    pd, pn = non_max_suppression(gpu_boxes.cpu(), gpu_scores.cpu(), **nms_kw)
    gd, gn, pd, pn = gd.cpu().numpy(), gn.cpu().numpy(), pd.numpy(), pn.numpy()
    check((gn == pn).all(), f"{cfg}: hard-NMS counts on the card {gn.tolist()} != on the CPU {pn.tolist()}")
    check(int(gn.min()) > 0, f"{cfg}: an image of the compared batch has no detection: {gn.tolist()}")
    check((gd[..., 5] == pd[..., 5]).all(), f"{cfg}: hard-NMS classes differ between card and CPU")
    det_err = float(np.abs(gd[..., :4] - pd[..., :4]).max())
    check(det_err <= 1e-2, f"{cfg}: hard-NMS boxes differ between card and CPU by {det_err} px")
    # the whole CPU path on its own maps: near-equal scores may swap places in a
    # sort, so a few detections may differ; hold most of them
    cd, cn = non_max_suppression(*decode_detections(cpu_feats, model.stride, model.nc, model.reg_max), **nms_kw)
    cd, cn = cd.numpy(), cn.numpy()
    frac = min(match_fraction(gd[i, :gn[i]], cd[i, :cn[i]]) for i in range(len(gn)))
    check(frac >= 0.95, f"{cfg}: only {frac:.3f} of an image's card detections are on the CPU path")
    return {"batch": len(gn), "map_max_abs_err": map_err, "decode_max_abs_err_px": dec_err,
            "decode_vs_float64": decode_vs_f64, "host_f32_exp_max_rel_err": exp_err,
            "host_cpu_capability": torch.backends.cpu.get_cpu_capability(),
            "predict_again_max_abs_err": repeat_err,
            "nms_same_maps_max_abs_err_px": det_err, "cpu_path_min_match_fraction": frac,
            "cpu_path_max_count_gap": int(np.abs(gn - cn).max()), "counts": gn.tolist()}


def capture_bf16_inputs(model, x, n_ldconv=10):
    """One bf16 forward (no gradient): the Detect maps (K1's bf16 inputs) and
    each of the ``n_ldconv`` LDConv layers' (bf16 source, f32 offsets,
    stride) as the model hands them to K3."""
    import torch

    import experiment_yolo_torch.nn.modules as modules

    ld, gather = [], modules.ldconv_gather

    def record(src, off, stride):
        ld.append((src, off, stride))
        return gather(src, off, stride)

    modules.ldconv_gather = record
    try:
        with torch.no_grad():
            feats = model(x)
    finally:
        modules.ldconv_gather = gather
    check(all(f.dtype == torch.bfloat16 for f in feats) and len(ld) == n_ldconv
          and all(s.dtype == torch.bfloat16 and o.dtype == torch.float32 for s, o, _ in ld),
          f"the bf16 forward handed K1 {[f.dtype for f in feats]} maps and K3 {len(ld)} sources "
          f"{sorted({str(s.dtype) for s, _, _ in ld})}: expected bf16 maps, {n_ldconv} bf16 sources, f32 offsets")
    return feats, ld


def bf16_spacing(t):
    """The spacing of bf16 numbers at each element's magnitude (that of the
    smallest normal at 0): 2^(e - 8) for |t| = m * 2^e, m in [0.5, 1)."""
    import torch

    _, e = torch.frexp(t.float().abs().clamp(min=torch.finfo(torch.bfloat16).tiny))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def spacing_err(got, want):
    """bf16 outputs against their plain versions: (max abs error, the worst
    element's error in bf16 spacings of the plain value, and whether every
    element lies within one spacing of the plain value plus BWD_RTOL of the
    output's largest plain value). Both sides round an f32 sum once; the sums
    differ in order, so a value that straddles a rounding boundary lands one
    spacing apart, and a value that cancels to near 0 carries the f32 sums'
    own error, which the BWD_RTOL floor of the f32 gates bounds."""
    import torch

    worst_abs, worst_sp, ok = 0.0, 0.0, True
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs()
        sp = bf16_spacing(b)
        worst_abs = max(worst_abs, err.max().item())
        worst_sp = max(worst_sp, (err / sp).max().item())
        ok = ok and bool((err <= sp + BWD_RTOL * b.float().abs().max()).all())
    return worst_abs, worst_sp, ok


def bf16_offset_kinds(ld, gen):
    """bf16 K3 inputs (source, offsets, incoming gradient, stride) of each
    kind, with random bf16 incoming gradients: the main path's (``ld``, from
    the bf16 forward), random, contention and seam offsets, and the same
    layers at RAGGED_IMGSZ on random, contention and seam offsets with random
    bf16 sources."""
    import torch

    from experiment_yolo_torch.utils.seeded import contention_offsets, seam_offsets

    def grad_like(x, o, s):
        b, c = x.shape[:2]
        return torch.randn(b, o.shape[2] * o.shape[3], o.shape[1] // 2 * c, generator=gen).to(x.device, torch.bfloat16)

    main = [(x, o, grad_like(x, o, s), s) for x, o, s in ld]
    rand = [(x, _random_offsets_like(o, gen), dy, s) for x, o, dy, s in main]
    kinds = {"main": main, "random": rand,
             "contention": [(x, contention_offsets(x, o, s, gen), dy, s) for x, o, dy, s in rand],
             "seam": [(x, seam_offsets(x, o, s), dy, s) for x, o, dy, s in rand]}
    ragged = []
    for x, o, _, s in main:
        b, c, hx, wx = x.shape
        hx, wx = hx * RAGGED_IMGSZ // IMGSZ, wx * RAGGED_IMGSZ // IMGSZ
        ro = _random_offsets_like(torch.empty(b, o.shape[1], hx // s, wx // s), gen).to(o.device)
        rx = torch.randn(b, c, hx, wx, generator=gen).to(x.device, torch.bfloat16)
        ragged.append((rx, ro, grad_like(rx, ro, s), s))
    kinds[f"{RAGGED_IMGSZ} random"] = ragged
    kinds[f"{RAGGED_IMGSZ} contention"] = [(x, contention_offsets(x, o, s, gen), dy, s) for x, o, dy, s in ragged]
    kinds[f"{RAGGED_IMGSZ} seam"] = [(x, seam_offsets(x, o, s), dy, s) for x, o, dy, s in ragged]
    return kinds


def k1_bwd_bf16_row(levels):
    """K1's backward in bf16 on a bf16 step's ``levels`` against its plain
    version: each ``dx`` within one bf16 spacing of plain's rounded result
    (:func:`spacing_err`); timed as the f32 form, the bound at bf16."""
    import torch

    k1b, k1b_plain = k1_bwd_calls(levels)
    k1b_got, k1b_want = k1b(), k1b_plain()
    check(all(t.dtype == torch.bfloat16 for t in k1b_got), "K1 dfl_decode_bwd bf16: dx is not bf16")
    err, spacings, ok = spacing_err(k1b_got, k1b_want)
    check(ok, f"K1 dfl_decode_bwd bf16 disagrees with its plain version beyond one bf16 spacing: max abs err {err}, "
              f"{spacings} spacings")
    no = levels[0][0].shape[1]
    groups = sum(f.shape[0] * f.shape[2] * f.shape[3] * 4 for f, *_ in levels)
    nbytes = sum(f.shape[0] * f.shape[2] * f.shape[3] * ((64 + no) * 2 + (4 + 4) * 4) for f, *_ in levels)
    b_ms, b_by = bound(nbytes, groups * 16 * 10)
    return dict(name="dfl_decode_bwd_bf16", route="cuda", source="experiment_yolo_torch/csrc/dfl_decode.cu",
                replaces="experiment_yolo_tpu/ops/pallas/dfl_decode.py:53", max_abs_err=err,
                max_bf16_spacings=spacings, ms=cuda_ms(k1b),
                device_ms=device_ms(k1b, "dfl_decode_bwd_kernel<__nv_bfloat16>", len(levels)),
                plain_ms=cuda_ms(k1b_plain), bound_ms=b_ms, bound_by=b_by, library_ms=None,
                per_call=len(levels))


def check_bf16_forms(feats, ld, ld_train, levels):
    """The bf16 forms of K1, K1's backward, K3 and K3's backward against their
    plain versions: K3's forward bit-equal on every kind of offsets of
    :func:`bf16_offset_kinds`, K1 within 1e-5 on the cases of
    :func:`hold_k1`, each bf16 ``dx`` within one bf16 spacing of plain's rounded
    result (:func:`spacing_err`), K3's f32 ``doff`` within BWD_RTOL of its
    largest plain value. ``feats``, ``ld``: a bf16 forward's K1 and K3 inputs;
    ``ld_train``, ``levels``: a bf16 training step's K3 and K1 backward
    inputs. Times as the f32 rows (device ms from a trace holding every
    launch of the form; K3's backward with every event of its calls: the
    ``dx`` fill, a memset of ``doff``, the cast of ``dx`` to bf16), bounds on
    the bytes at bf16, and ``F.grid_sample``'s bf16 time beside K3."""
    import torch
    import torch.nn.functional as F

    from experiment_yolo_torch.ops.kernels.ldconv_gather import (ldconv_gather_bwd, ldconv_gather_bwd_plain,
                                                                 ldconv_gather_fwd, ldconv_gather_plain)

    rows = []
    # K1 forward: one launch for every level
    cases = hold_k1(feats, torch.Generator().manual_seed(SEED + 4))
    rows.append(k1_row("dfl_decode_bf16", feats, cases, "dfl_decode_kernel<__nv_bfloat16"))

    # K1 backward
    rows.append(k1_bwd_bf16_row(levels))

    # K3 forward and backward on every kind of offsets
    gen = torch.Generator().manual_seed(SEED + 5)
    kinds = bf16_offset_kinds(ld, gen)
    train_kind = [(x, o, dy, s) for x, o, s, dy in ld_train]
    fwd_err, bwd = {}, {}
    for kind, layers in {**kinds, "training step": train_kind}.items():
        outs = [(ldconv_gather_fwd(x, o, s), ldconv_gather_plain(x, o, s)) for x, o, _, s in layers]
        check(all(a.dtype == torch.bfloat16 for a, _ in outs), f"K3 ldconv_gather bf16 on {kind}: output not bf16")
        fwd_err[kind] = max((a.float() - b.float()).abs().max().item() for a, b in outs)
        check(all(torch.equal(a, b) for a, b in outs),
              f"K3 ldconv_gather bf16 is not bit-equal to its plain version on {kind} offsets: {fwd_err[kind]}")
        del outs
        got = [ldconv_gather_bwd(x, o, dy, s) for x, o, dy, s in layers]
        want = [ldconv_gather_bwd_plain(x, o, dy, s) for x, o, dy, s in layers]
        check(all(dx.dtype == torch.bfloat16 and do.dtype == torch.float32 for dx, do in got),
              f"K3 ldconv_gather_bwd bf16 on {kind}: dx must be bf16, doff f32")
        dx_err, dx_sp, ok = spacing_err([g[0] for g in got], [w[0] for w in want])
        check(ok, f"K3 ldconv_gather_bwd bf16 dx disagrees with its plain version beyond one bf16 spacing on {kind} "
                  f"offsets: max abs err {dx_err}, {dx_sp} spacings")
        doff_err, doff_rel = _rel_err([g[1] for g in got], [w[1] for w in want])
        check(doff_rel <= BWD_RTOL, f"K3 ldconv_gather_bwd bf16 doff disagrees with its plain version on {kind} "
                                    f"offsets: {doff_err} ({doff_rel} relative)")
        bwd[kind] = {"dx_max_abs_err": dx_err, "dx_max_bf16_spacings": dx_sp, "doff_max_abs_err": doff_err,
                     "doff_rel_err": doff_rel}
        del got, want

    main = kinds["main"]
    grids = [g.to(torch.bfloat16) for g in grid_sample_grids([(x, o, s) for x, o, _, s in main])]

    def library():
        return [F.grid_sample(x, g, mode="bilinear", padding_mode="border", align_corners=True)
                for (x, _, _, _), g in zip(main, grids)]

    fwd_kernel = "ldconv_gather_bf16_kernel"
    nbytes = ops = 0
    fwd_layers = []
    for x, o, _, s in main:
        b, n2, h, w = o.shape
        out_n = b * h * w * n2 // 2 * x.shape[1]
        cost = (x.numel() * 2 + o.numel() * 4 + out_n * 2,  # bf16 source and output, f32 offsets
                out_n * 9 + b * h * w * (n2 // 2) * 24)
        nbytes, ops = nbytes + cost[0], ops + cost[1]
        fwd_layers.append({"shape": f"{tuple(x.shape)}->{(b, h * w, out_n // (b * h * w))}", "stride": s,
                           "bound_ms": bound(*cost)[0]})
    per_layer = device_ms_each([functools.partial(ldconv_gather_fwd, x, o, s) for x, o, _, s in main], fwd_kernel, 1)
    per_library = device_ms_each([functools.partial(F.grid_sample, x, g, mode="bilinear", padding_mode="border",
                                                    align_corners=True) for (x, _, _, _), g in zip(main, grids)],
                                 "grid_sampler", 1)
    for row, ms, lib_ms in zip(fwd_layers, per_layer, per_library):
        row.update(device_ms=ms, grid_sample_device_ms=lib_ms)
    b_ms, b_by = bound(nbytes, ops)
    rows.append(dict(name="ldconv_gather_bf16", route="cuda", source="experiment_yolo_torch/csrc/ldconv_gather.cu",
                     replaces="experiment_yolo_tpu/ops/pallas/ldconv_kernel.py:29", max_abs_err=max(fwd_err.values()),
                     ms=cuda_ms(lambda: [ldconv_gather_fwd(x, o, s) for x, o, _, s in main]),
                     device_ms=device_ms(lambda: [ldconv_gather_fwd(x, o, s) for x, o, _, s in main], fwd_kernel,
                                         len(main)),
                     plain_ms=cuda_ms(lambda: [ldconv_gather_plain(x, o, s) for x, o, _, s in main], PLAIN_RUNS, 1),
                     bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(library),
                     library_device_ms=device_ms(library, "grid_sampler", len(main)),
                     # the f32 form on the same sources widened, so on the same positions (the widening not timed)
                     f32_form_same_sources_device_ms=device_ms(
                         lambda: [ldconv_gather_fwd(x.float(), o, s) for x, o, _, s in main], "ldconv_gather_kernel<float",
                         len(main)),
                     bit_equal_on=list(fwd_err), max_abs_err_by_kind=fwd_err, layers=fwd_layers))

    # the backward's yardstick: F.grid_sample's bf16 backward on the training step's positions and gradients
    tgrids = grid_sample_grids([(x, o, s) for x, o, _, s in train_kind])
    xs = [x.clone().requires_grad_() for x, _, _, _ in train_kind]
    gs = [g.to(torch.bfloat16).requires_grad_() for g in tgrids]
    outs = [F.grid_sample(x, g, mode="bilinear", padding_mode="border", align_corners=True) for x, g in zip(xs, gs)]
    dys = [dy.reshape(dy.shape[0], dy.shape[1], o.shape[1] // 2, -1).permute(0, 3, 1, 2).contiguous()
           for _, o, dy, _ in train_kind]

    def k3b():
        return [t for x, o, dy, s in train_kind for t in ldconv_gather_bwd(x, o, dy, s)]

    bwd_kernel = "ldconv_gather_bwd_kernel<__nv_bfloat16"  # timed with every event of its calls
    nbytes = ops = 0
    bwd_layers = []
    for x, o, dy, s in train_kind:
        b, n2, h, w = o.shape
        cost = (2 * x.numel() * 2 + 2 * o.numel() * 4 + dy.numel() * 2,  # x, dy bf16 read, dx bf16 written
                dy.numel() * 23 + b * h * w * (n2 // 2) * 30)
        nbytes, ops = nbytes + cost[0], ops + cost[1]
        bwd_layers.append({"shape": f"{tuple(dy.shape)}->{tuple(x.shape)},{tuple(o.shape)}", "stride": s,
                           "bound_ms": bound(*cost)[0]})
    per_layer = device_ms_each([functools.partial(ldconv_gather_bwd, x, o, dy, s) for x, o, dy, s in train_kind],
                               bwd_kernel, 1)
    # the library's backward called directly, on this thread (autograd runs it on a thread of its own, outside
    # the ranges): bilinear (0), border (1), align_corners
    per_library = device_ms_each([functools.partial(torch.ops.aten.grid_sampler_2d_backward, d, xi.detach(),
                                                    gi.detach(), 0, 1, True, [True, True])
                                  for xi, gi, d in zip(xs, gs, dys)], "grid_sampler_2d_backward", 1)
    for row, ms, lib_ms in zip(bwd_layers, per_layer, per_library):
        row.update(device_ms=ms, grid_sample_backward_device_ms=lib_ms)
    b_ms, b_by = bound(nbytes, ops)
    rows.append(dict(name="ldconv_gather_bwd_bf16", route="cuda",
                     source="experiment_yolo_torch/csrc/ldconv_gather.cu",
                     replaces="experiment_yolo_tpu/nn/modules.py:469",
                     max_abs_err=max(max(v["dx_max_abs_err"], v["doff_max_abs_err"]) for v in bwd.values()),
                     ms=cuda_ms(k3b), device_ms=device_ms(k3b, bwd_kernel, len(train_kind), span=""),
                     plain_ms=cuda_ms(lambda: [t for x, o, dy, s in train_kind
                                               for t in ldconv_gather_bwd_plain(x, o, dy, s)]),
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=cuda_ms(lambda: torch.autograd.grad(outs, xs + gs, dys, retain_graph=True)),
                     by_kind=bwd, layers=bwd_layers,
                     device_ms_counts="every event of the wrapper's calls: the memset of the f32 sums (and of "
                                      "doff where channels split over threads), the adds, the rounding into dx"))
    return rows


def compare_train_cpu_bf16(state_dict, batches, cfg=CFG, imgsz=CMP_IMGSZ):
    """A bf16 step of ``cfg`` at ``imgsz``, batch CMP_BATCH on the card against the
    CPU's f32 and bf16 steps from the same weights and batch (warmup off,
    ``nbs`` the batch: every group moves at lr0), for each of ``batches``,
    each step from ``state_dict``. The momentum buffers (the step's clipped
    gradient plus weight decay) and the parameter updates are held with the
    criterion of the CPU tests against the JAX package: the card's bf16
    distance from the f32 steps is at most 1.5 times the CPU's own bf16
    distance from them, in relative L2 over the parameter vectors of all the
    steps. One step is not enough: on these weights bf16 moves a step's
    gradient 0.27 to 0.78 relative L2 from f32, a draw of its own on each
    side, and the ratio of two single draws read 0.83 to 1.52 over PR 9's
    runs of correct code. The three loss components of a step are too few
    for the ratio: each is a sum of about 10^5 terms rounded to bf16, whose
    drift from f32 is a draw of its own (the CPU's read 0.0016 to 0.023
    relative L2 over PR 9's runs, the card's 0.003 to 0.029), so they are
    held within BF16_LOSS_RTOL of the f32 steps, the ratio reported."""
    import torch

    from experiment_yolo_torch.engine.trainer import DetectionTrainer
    from experiment_yolo_torch.nn.tasks import guess_model_task, task_model

    out = {}
    t = time.perf_counter()
    model_class = task_model(guess_model_task(cfg))
    for label, dev, amp in (("cpu f32", "cpu", False), ("cpu bf16", "cpu", True), ("card bf16", "cuda", True)):
        steps = []
        for batch in batches:
            model = model_class(cfg, device=dev)
            model.load_state_dict(state_dict, strict=True)
            before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
            trainer = DetectionTrainer(model, {"amp": amp, "batch": CMP_BATCH, "imgsz": imgsz, "nbs": CMP_BATCH,
                                               "warmup_epochs": 0.0})
            opt = trainer.state.optimizer
            comps = trainer.train_step(batch)
            check(opt.updates == 1, f"{label}: the compared step fired {opt.updates} updates, expected 1")
            steps.append(dict(comps=torch.tensor([comps[k].item() for k in trainer.loss_keys]),
                              fg=comps["fg"].item(), dtype=str(model.dtype),
                              momentum=torch.cat([opt.state[p]["momentum_buffer"].cpu().flatten()
                                                  for p in model.parameters()]),
                              updates=torch.cat([(p.detach().cpu() - before[n]).flatten()
                                                 for n, p in model.named_parameters()])))
        out[label] = {k: torch.cat([s[k] for s in steps]) for k in ("comps", "momentum", "updates")}
        out[label].update(fg=[s["fg"] for s in steps], dtype=steps[0]["dtype"])

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    ref, cpu, card = out["cpu f32"], out["cpu bf16"], out["card bf16"]
    result = {"cfg": cfg if isinstance(cfg, str) else cfg.get("yaml_file"), "imgsz": imgsz, "batch": CMP_BATCH, "steps": len(batches), "seconds": time.perf_counter() - t,
              "fg": {k: v["fg"] for k, v in out.items()}, "loss_cpu_f32": ref["comps"].tolist(),
              "loss_cpu_bf16": cpu["comps"].tolist(), "loss_card_bf16": card["comps"].tolist()}
    for what in ("comps", "momentum", "updates"):
        own, got = rel(cpu[what], ref[what]), rel(card[what], ref[what])
        result[what] = {"cpu_bf16_vs_cpu_f32": own, "card_bf16_vs_cpu_f32": got, "card_bf16_vs_cpu_bf16":
                        rel(card[what], cpu[what]), "ratio": got / own if own else float("inf")}
        if what == "comps":
            check(got <= BF16_LOSS_RTOL, f"the card's bf16 loss components are {got} from the CPU's f32 steps' "
                                         f"(relative L2), more than {BF16_LOSS_RTOL}")
        else:
            check(got <= 1.5 * own, f"the card's bf16 steps are {got} from the CPU's f32 steps in {what} (relative "
                                    f"L2), more than 1.5 times the CPU bf16 steps' {own}")
    check(card["dtype"] == "torch.bfloat16" and ref["dtype"] == "torch.float32", "the compared steps' dtypes")
    return result


def facade_phase(data: Path, root: Path, counters, card):
    """The facade with the defaults: ``YOLO(CFG, nc=LOOP_NC).train(...)``
    with no ``amp`` key (bf16 compute; ``optimizer='SGD'``, as the reference
    fork's ``train.py`` passes it), then
    ``.val()``, ``.predict()``, and ``YOLO(best.pt)``. Gates: the launches of
    the bf16 forms (the AMP check's two forwards, every step, every
    per-epoch validation batch: the bf16 K3 and K1), ``_check_amp`` passed,
    finite losses, the reload's maps bit-equal to the trained facade's. Two
    epochs from scratch detect nothing, so ``.predict()`` is also held on
    :func:`detector_checkpoint`'s model: ``YOLO(detector.pt).predict()``
    equal to ``DetectionPredictor`` on ``load_checkpoint(detector.pt)``, with
    detections in every image. Returns that checkpoint too."""
    import math

    import numpy as np
    import torch

    from experiment_yolo_torch import YOLO
    from experiment_yolo_torch.data.image_io import imread
    from experiment_yolo_torch.engine.checkpoint import load_checkpoint
    from experiment_yolo_torch.engine.predictor import DetectionPredictor

    yolo = YOLO(CFG, nc=LOOP_NC, seed=SEED)
    losses = []
    yolo.add_callback("on_fit_epoch_end", lambda trainer: losses.append(dict(trainer.loss_items)))
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    metrics = yolo.train(data=str(data), epochs=LOOP_EPOCHS, batch=BATCH, imgsz=IMGSZ, workers=8, optimizer="SGD",
                         close_mosaic=1, project=str(root / "facade"), verbose=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    trainer = yolo.trainer
    nb = LOOP_TRAIN // BATCH
    steps, val_batches = LOOP_EPOCHS * nb, LOOP_EPOCHS * math.ceil(LOOP_VAL / BATCH)
    launches = {name: fn.launches for name, fn in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update(ldconv_gather=10, ldconv_gather_bf16=10 + 10 * (steps + val_batches),  # the AMP check: f32, bf16
                dfl_decode_bf16=steps + val_batches, dfl_decode_bwd_bf16=3 * steps,
                ldconv_gather_bwd_bf16=10 * steps, soft_nms=val_batches)
    check(launches == want, f"YOLO.train with the defaults launched {launches}, expected {want}")
    check(trainer.dtype == torch.bfloat16 and trainer.amp_check["passed"],
          f"YOLO.train did not train in bf16 with a passed AMP check: {trainer.dtype}, {trainer.amp_check}")
    check(all(math.isfinite(v) for row in losses for v in row.values()), f"a facade epoch's loss is not finite: {losses}")
    check(yolo.model.dtype == torch.float32 and not yolo.model.training, "the facade's model after train: "
          f"{yolo.model.dtype}, training={yolo.model.training}; expected f32 in eval mode")
    best = trainer.save_dir / "weights" / "best.pt"
    check(best.is_file(), f"no {best}")

    for fn in counters.values():
        fn.launches = 0
    val_args = {"data": str(data), "imgsz": IMGSZ, "batch": BATCH, "workers": 8, "verbose": False}
    stats = yolo.val(**val_args)
    vlaunch = {name: fn.launches for name, fn in counters.items()}
    n_val = math.ceil(LOOP_VAL / BATCH)
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode=n_val, ldconv_gather=10 * n_val, soft_nms=n_val)
    check(vlaunch == want, f"YOLO.val launched {vlaunch}, expected {want}")
    images = [imread(p) for p in sorted((data.parent / "images" / "val").iterdir())]
    results = yolo.predict(images[:BATCH], imgsz=IMGSZ, batch=BATCH, conf=0.001)
    check(len(results) == BATCH and all(np.isfinite(r.boxes.data).all() for r in results),
          f"YOLO.predict gave {len(results)} results for {BATCH} images, or non-finite boxes")

    reloaded = YOLO(str(best))
    vbatch = next(iter(trainer._validator._loader))
    x = torch.as_tensor(vbatch["img"]).cuda().permute(0, 3, 1, 2).float().div(255.0).contiguous()
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False):
        same = all(torch.equal(a, b) for a, b in zip(yolo.model(x), reloaded.model(x)))
    check(same, "YOLO(best.pt) gives maps that differ from the trained facade's")

    detector = detector_checkpoint(root)
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False):
        got = YOLO(str(detector)).predict(images[:BATCH], imgsz=IMGSZ, batch=BATCH, conf=CONF)
        direct = DetectionPredictor(load_checkpoint(detector, "cuda"),
                                    {"imgsz": IMGSZ, "batch": BATCH, "conf": CONF})(images[:BATCH])
    check(len(got) == len(direct) == BATCH and all(len(r) > 0 for r in got)
          and all(np.array_equal(a.boxes.data, b.boxes.data) for a, b in zip(got, direct)),
          f"YOLO(detector.pt).predict() differs from DetectionPredictor on the same checkpoint, or finds nothing: "
          f"{[len(r) for r in got]} vs {[len(r) for r in direct]} detections")
    record = {"cfg": CFG, "nc": LOOP_NC, "imgsz": IMGSZ, "batch": BATCH, "epochs": LOOP_EPOCHS, "steps": steps,
              "train_dtype": str(trainer.dtype), "amp_check": trainer.amp_check, "train_s": train_s,
              "loop_img_per_s": steps * BATCH / train_s, "losses": losses,
              "last_epoch_metrics": {k: v for k, v in metrics.items() if k != "epochs_run"},
              "val_after_train": stats, "predict_detections": [len(r) for r in results],
              "detector_predict_detections": [len(r) for r in got], "reload_maps_bit_equal": same,
              "launches_train": launches, "launches_val": vlaunch, "card": card}
    for name in launches:
        launches[name] += vlaunch[name]
    return yolo, best, detector, record, launches


def detector_checkpoint(root: Path) -> Path:
    """A checkpoint of the seeded LD-P2 at the loop's ``nc`` whose boxes are
    about 100 px a side (:func:`sized_boxes_`): it keeps detections at the
    serving threshold and its mAP on phase 12's dataset is not 0."""
    from experiment_yolo_torch.engine.checkpoint import save_checkpoint
    from experiment_yolo_torch.nn.tasks import yaml_model_load
    from experiment_yolo_torch.utils.seeded import seeded_model, sized_boxes_

    model = seeded_model({**yaml_model_load(CFG), "nc": LOOP_NC}, SEED)
    sized_boxes_(model, 100.0)
    return save_checkpoint(root / "detector.pt", model)


def _cli(*args: str):
    """``python -m experiment_yolo_torch.cfg.cli *args`` in a fresh process:
    its standard output and seconds; it must exit 0."""
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "experiment_yolo_torch.cfg.cli", *args], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    check(proc.returncode == 0, f"the CLI {args[0]} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout, time.perf_counter() - t


def _cli_val(ckpt: Path, data: Path):
    """``val model=<ckpt>`` through the CLI: its stats line and seconds."""
    out, seconds = _cli("val", f"model={ckpt}", f"data={data}", f"imgsz={IMGSZ}", f"batch={BATCH}", "workers=8")
    line = [ln for ln in out.splitlines() if ln.startswith("val: {")]
    check(len(line) == 1, f"the CLI val printed no stats line: {out[-2000:]}")
    return json.loads(line[0][len("val: "):]), seconds


def cli_phase(best: Path, detector: Path, data: Path):
    """The CLI in fresh processes: ``val model=<best.pt> data=...`` and
    ``val model=<detector.pt> data=...``, whose whole stats lines must equal
    the facade's ``val`` of the same checkpoints (the detector's with a
    mAP50 above 0: two epochs from scratch detect nothing), and ``predict
    model=<detector.pt> source=<the val images>``, whose count of detections
    for each image must equal the facade's ``predict``. The facade's runs are
    taken in this process with TF32 as a fresh process has it (cuDNN's
    convolutions in TF32, matmuls in f32)."""
    import re

    import torch

    from experiment_yolo_torch import YOLO
    from experiment_yolo_torch.data.image_io import imread

    source = data.parent / "images" / "val"
    out, predict_s = _cli("predict", f"model={detector}", f"imgsz={IMGSZ}", f"batch={BATCH}", f"source={source}",
                          f"conf={CONF}")
    counts = [int(m.group(1)) for m in re.finditer(r"^\s+\S+: (\d+) detections$", out, re.M)]
    record = {"predict_seconds": predict_s, "predict_detections": counts}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        for name, ckpt in (("best", best), ("detector", detector)):
            cli, seconds = _cli_val(ckpt, data)
            yolo = YOLO(str(ckpt))
            want = yolo.val(data=str(data), imgsz=IMGSZ, batch=BATCH, workers=8, verbose=False)
            check(cli == want, f"the CLI's val stats of {name}.pt {cli} differ from the facade's {want}")
            record[name] = {"val_seconds": seconds, "cli_stats": cli}
        # the detector's facade, the loop's last
        results = yolo.predict([imread(p) for p in sorted(source.iterdir())], imgsz=IMGSZ, batch=BATCH, conf=CONF)
    check(record["detector"]["cli_stats"]["mAP50"] > 0, f"the detector's mAP50 is 0: {record['detector']}")
    want_counts = [len(r) for r in results]
    check(counts == want_counts and sum(counts) > 0, f"the CLI's predict found {counts} detections, the facade "
                                                     f"{want_counts}")
    return record


def server_phase(root: Path, images, counters, card):
    """``DetectionServer`` on a checkpoint of the seeded LD-P2 (batch BATCH at
    IMGSZ, soft NMS) on an ephemeral port of 127.0.0.1: 16 BMP requests from
    4 threads; gates: every request answered, /health counting 16 requests in
    fewer than 16 batches, the detections equal to ``DetectionPredictor``'s on
    the same images (to JSON's rounding), K1, K3 and K5 launched once per
    coalesced batch. Reports the median request latency."""
    import threading
    import urllib.request

    import numpy as np

    from experiment_yolo_torch.data.image_io import imwrite
    from experiment_yolo_torch.engine.checkpoint import save_checkpoint
    from experiment_yolo_torch.engine.predictor import DetectionPredictor
    from experiment_yolo_torch.serve import DetectionServer
    from experiment_yolo_torch.utils.seeded import seeded_model

    ckpt = save_checkpoint(root / "seeded.pt", seeded_model(CFG, SEED))
    server = DetectionServer(str(ckpt), batch=BATCH, imgsz=IMGSZ)
    port = server.start(host="127.0.0.1", port=0)
    bodies = []
    for i, img in enumerate(images[:16]):
        imwrite(root / f"req{i}.bmp", img)
        bodies.append((root / f"req{i}.bmp").read_bytes())
    answers, latency = [None] * 16, [0.0] * 16
    for fn in counters.values():
        fn.launches = 0

    def client(k):
        for i in range(k, 16, 4):
            t = time.perf_counter()
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=bodies[i])
            answers[i] = json.loads(urllib.request.urlopen(req, timeout=120).read())
            latency[i] = (time.perf_counter() - t) * 1e3

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        health = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60).read())
    finally:
        server.stop()
    launches = {name: fn.launches for name, fn in counters.items()}
    check(all(a is not None for a in answers), "a server request got no answer")
    batching = health["batching"]
    check(batching["items"] == 16 and batching["batches"] < 16,
          f"/health counted {batching}: expected 16 requests coalesced into fewer than 16 batches")
    n = batching["batches"]
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode=n, ldconv_gather=10 * n, soft_nms=n)
    check(launches == want, f"the server launched {launches} for {n} batches, expected {want}")
    direct = DetectionPredictor(server.yolo.model, {"batch": BATCH, "imgsz": IMGSZ, "conf": 0.25})(images[:16])
    worst = 0.0
    for a, r in zip(answers, direct):
        d = a["detections"]
        check(len(d) == len(r), f"the server found {len(d)} detections, the predictor {len(r)}")
        if d:
            box = np.array([x["box"] for x in d])
            conf = np.array([x["conf"] for x in d])
            cls = np.array([x["cls"] for x in d])
            worst = max(worst, float(np.abs(box - r.boxes.xyxy).max()))
            check((cls == r.boxes.cls.astype(int)).all() and np.abs(conf - r.boxes.conf).max() <= 5e-5 + 1e-6
                  and np.abs(box - r.boxes.xyxy).max() <= 5e-3 + 1e-4,
                  "the server's detections differ from the predictor's beyond JSON's rounding")
    return {"cfg": CFG, "imgsz": IMGSZ, "batch": BATCH, "requests": 16, "threads": 4, "health": health,
            "latency_ms_median": statistics.median(latency), "latency_ms_min": min(latency),
            "latency_ms_max": max(latency), "detections_per_request": [len(a["detections"]) for a in answers],
            "box_max_abs_err_vs_predictor": worst, "launches": launches, "card": card}, launches


def asf_k1(feats_by_case, name, kernel):
    """K1's forward (f32 or bf16), one launch for ASF-P2's four levels,
    against its plain version on the model's own maps at IMGSZ (34,000
    anchors) and at RAGGED_IMGSZ (P5 then holds 19 x 19 = 361 anchors, an odd
    count that takes the narrowest load): within 1e-5 (:func:`k1_row`'s
    gate), timed on the IMGSZ maps beside the bytes bound."""
    import torch

    from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode_levels_fwd, dfl_decode_plain, level_table

    cases = {}
    for label, maps in feats_by_case.items():
        check(len(maps) == 4, f"K1 {name} on {ASF_CFG} at {label}: {len(maps)} levels, expected 4")
        got = dfl_decode_levels_fwd(maps)
        check(bool(torch.isfinite(got).all()), f"K1 {name}: non-finite output on {ASF_CFG} at {label}")
        want = torch.cat([dfl_decode_plain(f) for f in maps], 1)
        table = level_table([(f.shape[2] * f.shape[3], f.stride(0), f.data_ptr()) for f in maps],
                            maps[0].element_size())
        cases[label] = {"max_abs_err": (got - want).abs().max().item(), "anchors": [t.anchors for t in table],
                        "widths": [t.width for t in table]}
    torch.cuda.synchronize()
    return k1_row(name, feats_by_case[f"imgsz {IMGSZ}"], cases, kernel)


def asf_served(asf, images, x, counters, card):
    """Phase 23: ``yolov8-ASF-P2.yaml`` served. K1's forward on the model's
    own 4-level maps in f32 and bf16 at IMGSZ and RAGGED_IMGSZ
    (:func:`asf_k1`); SERVE_BATCHES batches through ``DetectionPredictor``,
    soft then hard NMS (exactly 1 K1 a forward, 1 K5 or 1 K2 a batch, no K3
    or K4); ASF_CMP_BATCH images of phase 4's batch against the CPU
    (:func:`compare_serving_cpu`). Returns the ``asf_p2`` record's serving
    part and the launches."""
    import torch

    from experiment_yolo_torch.utils.seeded import letterboxed, model_input

    x_ragged = model_input(letterboxed(images[:BATCH], RAGGED_IMGSZ), "cuda")
    with torch.no_grad():
        f32 = {f"imgsz {IMGSZ}": asf(x), f"imgsz {RAGGED_IMGSZ}": asf(x_ragged)}
        asf.dtype = torch.bfloat16
        try:
            bf16 = {f"imgsz {IMGSZ}": asf(x), f"imgsz {RAGGED_IMGSZ}": asf(x_ragged)}
        finally:
            asf.dtype = torch.float32
    anchors = sum(f.shape[2] * f.shape[3] for f in f32[f"imgsz {IMGSZ}"])
    check(anchors == sum((IMGSZ // s) ** 2 for s in ASF_STRIDES) and all(f.dtype == torch.bfloat16
                                                                          for f in bf16[f"imgsz {IMGSZ}"]),
          f"{ASF_CFG}: {anchors} anchors at {IMGSZ} or bf16 maps of another dtype")
    k1 = [asf_k1(f32, "dfl_decode", "dfl_decode_kernel<float"),
          asf_k1(bf16, "dfl_decode_bf16", "dfl_decode_kernel<__nv_bfloat16")]
    del f32, bf16, x_ragged
    served, launches = serve_timed(asf, images, counters, {"dfl_decode": 1}, card, ASF_CFG)
    compare = compare_serving_cpu(ASF_CFG, asf, x[:ASF_CMP_BATCH])
    log(f"{ASF_CFG} CPU comparison: {json.dumps(compare)}")
    return {"k1_forward": k1, "anchors_at_imgsz": anchors, "served": served, "cpu_comparison": compare}, launches


def facade_epoch(cfg, want_launches, data: Path, root: Path, counters, card, optimizer="SGD", nc=LOOP_NC,
                 **train_args):
    """``YOLO(cfg, nc=nc).train()`` as the reference fork's own
    ``train.py`` calls it (``optimizer='SGD'``, no ``amp`` key: bf16) for one
    epoch on phase 12's dataset, counters at 0 just before and read just
    after: the AMP check passed, the launches ``want_launches(steps,
    val_batches)`` (none of the kernels it does not name); finite losses.
    ``optimizer=None`` passes no ``optimizer`` (``auto``); ``train_args``
    go to ``train()`` too. The record names the optimizer built and the
    run's ``weights`` folder."""
    import torch

    from experiment_yolo_torch import YOLO

    yolo = YOLO(cfg, nc=nc, seed=SEED)
    losses = []
    yolo.add_callback("on_fit_epoch_end", lambda trainer: losses.append(dict(trainer.loss_items)))
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    metrics = yolo.train(**{"data": str(data), "epochs": 1, "batch": BATCH, "imgsz": IMGSZ, "workers": 8,
                            "project": str(root / f"facade_{Path(cfg).stem}"), "verbose": False,
                            **({"optimizer": optimizer} if optimizer else {}), **train_args})
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    trainer = yolo.trainer
    steps, val_batches = LOOP_TRAIN // BATCH, math.ceil(LOOP_VAL / BATCH)
    launches = {name: fn.launches for name, fn in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update(want_launches(steps, val_batches))
    check(launches == want, f"YOLO({cfg!r}).train with the defaults launched {launches}, expected {want}")
    check(trainer.dtype == torch.bfloat16 and trainer.amp_check["passed"],
          f"YOLO({cfg!r}).train did not train in bf16 with a passed AMP check: {trainer.dtype}, "
          f"{trainer.amp_check}")
    check(all(math.isfinite(v) for row in losses for v in row.values()), f"a {cfg} epoch's loss: {losses}")
    opt = trainer.state.optimizer
    return {"cfg": cfg, "nc": nc, "imgsz": IMGSZ, "batch": BATCH, "epochs": metrics["epochs_run"],
            "steps": steps, "train_dtype": str(trainer.dtype), "amp_check": trainer.amp_check, "train_s": train_s,
            "loop_img_per_s": steps * BATCH / train_s, "losses": losses,
            "optimizer": {"arg": trainer.args.optimizer, "built": type(opt).__name__,
                          "family": getattr(opt, "family", None), "updates": opt.updates},
            "weights": str(trainer.save_dir / "weights"),
            "last_epoch_metrics": {k: v for k, v in metrics.items() if k != "epochs_run"}, "launches": launches,
            "card": card}, launches


def asf_trained(asf_state, batches, cmp_batch, data: Path, root: Path, counters, card):
    """Phase 24: ``yolov8-ASF-P2.yaml`` trained. K1's backward on an f32 and
    a bf16 step's four levels against its plain version (phase 9's gate,
    BWD_RTOL; phase 13's, one bf16 spacing); TRAIN_STEPS timed bf16 steps
    (exactly 1 K1 and 4 K1-backward launches a step, all bf16); one f32 step
    at CMP_IMGSZ against the CPU's with phase 11's gates (the CPU takes the
    card's ScalSeq and ZoomCat picks); then :func:`facade_epoch`.
    Returns the ``asf_p2`` record's training part and the launches."""
    import torch

    from experiment_yolo_torch import DetectionModel
    from experiment_yolo_torch.engine.trainer import DetectionTrainer

    def model():
        m = DetectionModel(ASF_CFG, device="cuda")
        m.load_state_dict(asf_state, strict=True)
        return m

    _, levels = capture_train_inputs(DetectionTrainer(model(), {"amp": False, "batch": BATCH, "imgsz": IMGSZ}),
                                     batches[0], n_ldconv=0, n_levels=4)
    k1_bwd = check_k1_bwd(levels)
    del levels
    trainer16 = DetectionTrainer(model(), {"batch": BATCH, "imgsz": IMGSZ})  # amp: the default, bf16
    check(trainer16.dtype == torch.bfloat16, f"DetectionTrainer's defaults left {ASF_CFG} in {trainer16.dtype}")
    _, levels16 = capture_train_inputs(trainer16, batches[0], n_ldconv=0, n_levels=4)
    k1_bwd16 = k1_bwd_bf16_row(levels16)
    del levels16
    step_ms, run, last, moved, ema_moved = train_timed(trainer16, batches, counters)
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode_bf16=TRAIN_STEPS, dfl_decode_bwd_bf16=4 * TRAIN_STEPS)
    check(run == want, f"the {ASF_CFG} bf16 training steps launched {run}, expected {want}")
    launches = dict(run)
    median = statistics.median(step_ms)
    trained = {"steps": TRAIN_STEPS, "warmup_steps": TRAIN_WARMUP, "batch": BATCH, "imgsz": IMGSZ,
               "dtype": "bfloat16", "step_ms_median": median, "step_ms_min": min(step_ms),
               "step_ms_max": max(step_ms), "step_ms_p10_p90": statistics.quantiles(step_ms, n=10)[::8],
               "img_per_s_at_median": BATCH / median * 1e3, "launches": run, "last_losses": last,
               "params_moved": moved, "ema_moved": ema_moved,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del trainer16
    torch.cuda.empty_cache()
    log(f"trained {ASF_CFG} bf16: {TRAIN_STEPS} steps of {BATCH} at {IMGSZ}: median {median:.2f} ms per step, "
        f"{trained['img_per_s_at_median']:.2f} img/s at the median, launches {run}, {card}")
    cmp = compare_train_cpu(asf_state, cmp_batch, cfg=ASF_CFG, n_ldconv=0, n_scalseq=2, n_zoomcat=2,
                            n_sppf=1)
    log(f"{ASF_CFG} training CPU comparison: {json.dumps(cmp)}")
    loop, run = facade_epoch(ASF_CFG, lambda steps, val: dict(dfl_decode_bf16=steps + val,
                                                              dfl_decode_bwd_bf16=4 * steps, soft_nms=val),
                             data, root, counters, card)
    for name in launches:
        launches[name] += run[name]
    log(f"{ASF_CFG} facade: YOLO(...).train() 1 epoch: {loop['loop_img_per_s']:.2f} img/s over the loop "
        f"({loop['train_dtype']}, AMP check {loop['amp_check']}), {card}")
    return {"k1_backward": [k1_bwd, k1_bwd16], "trained_bf16": trained, "cpu_comparison": cmp,
            "facade_train": loop}, launches


def _replaced(refined, first):
    """Rows of ``refined`` (N, 6) that are no row of ``first``: boxes a crop replaced."""
    import numpy as np

    return int(sum(not np.any(np.all(np.isclose(r, first), 1)) for r in refined)) if len(first) else len(refined)


def two_stage_phase(detector: Path, images, counters, card):
    """Phase 25: the paper's two-stage inference on LD-P2 at full width, on
    phase 15's seeded ``detector.pt`` (f32). ``YOLO.double_predict`` on
    TWO_STAGE_IMAGES images of mixed sizes at IMGSZ, one call an image (batch
    1): exactly 1 K1, 10 K3 and 1 K5 for the first pass and 1 K1, 10 K3 and 1
    K2 for its batch of 16 crops, every image with a first-pass detection;
    then the two stages timed apart. ``YOLO.sliced_predict`` on SLICED_FRAMES
    frames of 1280 x 720 at slice SLICE (overlap 0.2: 6 slices) with the full
    image: exactly 2 forwards (1 K1 and 10 K3 each) and 1 K5 a frame. Then
    the same calls on the CPU (plain versions) for TWO_STAGE_CPU_IMAGES
    images and every frame: the gate, as phases 7 and 21, is that at least
    0.95 of each image's card detections have a CPU detection of the same
    class within 1e-2 px (:func:`match_fraction`); the reverse fraction and
    the count gaps are reported. Reports img/s for each path."""
    import numpy as np
    import torch

    from experiment_yolo_torch import YOLO
    from experiment_yolo_torch.engine.double_inference import DoubleInference

    yolo = YOLO(str(detector))
    dbl_images = images[:TWO_STAGE_IMAGES]
    frames = [img for img in images if img.shape[:2] == (720, 1280)][:SLICED_FRAMES]
    check(len(frames) == SLICED_FRAMES, f"{len(frames)} frames of 1280 x 720 among the seeded images")
    dbl_kw, sl_kw = {"imgsz": IMGSZ, "batch": 1}, {"slice": SLICE, "overlap": 0.2, "imgsz": IMGSZ}
    yolo.double_predict([dbl_images[0]], **dbl_kw)  # warm-up: cuDNN picks its algorithms
    yolo.sliced_predict(frames[0], **sl_kw)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    dbl, dbl_ms = [], []
    for img in dbl_images:
        t = time.perf_counter()
        dbl += yolo.double_predict([img], **dbl_kw)
        dbl_ms.append((time.perf_counter() - t) * 1e3)
    run = {name: fn.launches for name, fn in counters.items()}
    n = len(dbl_images)
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode=2 * n, ldconv_gather=20 * n, soft_nms=n, nms_suppress=n)
    check(run == want, f"double_predict on {n} images launched {run}, expected {want}")
    dbl_launches, launches = run, dict(run)
    check(all(len(r) > 0 and np.isfinite(r.boxes.data).all() for r in dbl),
          f"double_predict: an image has no detections or non-finite ones: {[len(r) for r in dbl]}")
    first_ms, refine_ms, replaced = [], [], []
    refiner = DoubleInference(yolo.model)
    for img in dbl_images:
        t = time.perf_counter()
        first = yolo.predict([img], **dbl_kw)
        t1 = time.perf_counter()
        refined = refiner(first)
        t2 = time.perf_counter()
        first_ms.append((t1 - t) * 1e3)
        refine_ms.append((t2 - t1) * 1e3)
        replaced.append(_replaced(refined[0].boxes.data, first[0].boxes.data))

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    sliced, sliced_ms = [], []
    for frame in frames:
        t = time.perf_counter()
        sliced += yolo.sliced_predict(frame, **sl_kw)
        sliced_ms.append((time.perf_counter() - t) * 1e3)
    run = {name: fn.launches for name, fn in counters.items()}
    f = len(frames)
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode=2 * f, ldconv_gather=20 * f, soft_nms=f)
    check(run == want, f"sliced_predict on {f} frames launched {run}, expected {want}")
    check(all(len(r) > 0 and np.isfinite(r.boxes.data).all() for r in sliced),
          f"sliced_predict: a frame has no detections or non-finite ones: {[len(r) for r in sliced]}")
    for name in launches:
        launches[name] += run[name]

    cpu = YOLO(str(detector), device="cpu")
    compare = {"double_predict": [], "sliced_predict": []}
    pairs = [("double_predict", r, cpu.double_predict([img], **dbl_kw)[0])
             for r, img in zip(dbl, dbl_images[:TWO_STAGE_CPU_IMAGES])]
    pairs += [("sliced_predict", r, cpu.sliced_predict(frame, **sl_kw)[0]) for r, frame in zip(sliced, frames)]
    for path, card_r, cpu_r in pairs:
        a, b = card_r.boxes.data, cpu_r.boxes.data
        compare[path].append({"count_card": len(a), "count_cpu": len(b), "match_card_in_cpu": match_fraction(a, b),
                              "match_cpu_in_card": match_fraction(b, a)})
    frac = min(row["match_card_in_cpu"] for rows in compare.values() for row in rows)
    check(frac >= 0.95, f"two-stage: only {frac:.3f} of an image's card detections are on the CPU path: {compare}")
    del cpu
    record = {
        "cfg": CFG, "checkpoint": "phase 15's detector.pt (seeded LD-P2, nc=3, boxes about 100 px)",
        "double_predict": {
            "images": n, "sizes": [list(img.shape[:2]) for img in dbl_images], "imgsz": IMGSZ, "batch": 1,
            "crop_size": refiner.cfg.crop_size, "max_crops": refiner.cfg.max_crops,
            "ms_per_image_median": statistics.median(dbl_ms), "ms_per_image": dbl_ms,
            "img_per_s": n / sum(dbl_ms) * 1e3, "first_pass_ms_median": statistics.median(first_ms),
            "refine_ms_median": statistics.median(refine_ms), "detections": [len(r) for r in dbl],
            "boxes_replaced_by_a_crop": replaced, "launches": dbl_launches},
        "sliced_predict": {
            "frames": f, "size": [720, 1280], "slice": SLICE, "overlap": 0.2, "slices_per_frame": 6,
            "include_full": True, "ms_per_frame": sliced_ms, "img_per_s": f / sum(sliced_ms) * 1e3,
            "preprocess_ms": [r.speed["preprocess"] for r in sliced],
            "inference_ms": [r.speed["inference"] for r in sliced], "detections": [len(r) for r in sliced],
            "launches": run},
        "cpu_comparison": compare, "card": card}
    d = record["double_predict"]
    log(f"two-stage on {CFG}: double_predict {d['img_per_s']:.2f} img/s (first pass {d['first_pass_ms_median']:.2f} "
        f"ms, refine {d['refine_ms_median']:.2f} ms median), sliced_predict "
        f"{record['sliced_predict']['img_per_s']:.2f} frames/s, CPU match {frac:.3f}, {card}")
    return record, launches


def capture_scan_train_calls(trainer, batch):
    """One training step with a hook on every selective-scan call: its
    arguments as SS2D hands them to K4 (detached; ``B`` and ``C`` keep their
    strides), its keywords and the gradient that reaches its output, as the
    step hands them to K4 and its backward kernel."""
    import experiment_yolo_torch.nn.zoo_blocks as zoo

    calls, scan = [], zoo.selective_scan

    def scan_hook(*args, **kwargs):
        out = scan(*args, **kwargs)
        calls.append([tuple(a.detach() for a in args), kwargs])
        out.register_hook(lambda g, entry=calls[-1]: entry.append(g.detach().contiguous().clone()))
        return out

    zoo.selective_scan = scan_hook
    try:
        trainer.train_step(batch)
    finally:
        zoo.selective_scan = scan
    check(len(calls) == 10 and all(len(c) == 3 for c in calls),
          f"captured {len(calls)} scan calls of a VSS step ({[len(c) for c in calls]} parts), expected 10 with their "
          "gradients")
    return [tuple(c) for c in calls]


def first_of_each_level(calls):
    """The first call of each sequence length, by length, and the check that they are the four levels."""
    levels = {}
    for call in calls:
        levels.setdefault(call[0][1].shape[2], call)
    check(sorted(levels) == [(IMGSZ // s) ** 2 for s in (32, 16, 8, 4)], f"scan lengths {sorted(levels)}")
    return dict(sorted(levels.items()))


def ss2d_like(bsz, length, dim, rank, gen, step, a=None):
    """Random scan inputs in SS2D's form (two sequences for four directions, ``B`` and ``C`` as views of one
    projection with rows of ``rank`` + 32 floats, A and D per direction): ``dt`` log-uniform over ``step`` (low,
    high); ``a`` in place of minus the exp of a normal."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen).cuda()

    wide = randn(bsz, 4, length, rank + 2 * 16)
    lo, hi = math.log(step[0]), math.log(step[1])
    dt = torch.exp(lo + (hi - lo) * torch.rand((bsz, 4, length, dim), generator=gen)).cuda()
    return (randn(bsz, 2, length, dim), dt, -torch.exp(randn(4, dim, 16)) if a is None else a,
            wide[..., rank:rank + 16], wide[..., rank + 16:], randn(4, dim))


def k4_against_float64(levels):
    """Step 1 of the VSS training slice: K4's forward and the f32 plain
    version against a float64 plain version, each as a fraction of the
    largest float64 value, at each level on the seeded model's own inputs
    (gated: K4 within K4_RTOL) and on inputs whose step sizes lie near 1e-3
    (the model's decays A = -1 .. -16: its slowest state lives about 1,000
    steps; reported, a fault where K4 is beyond K4_RTOL)."""
    import torch

    from experiment_yolo_torch.ops.kernels.selective_scan import selective_scan, selective_scan_plain

    gen = torch.Generator().manual_seed(SEED + 26)
    rows = []
    with torch.no_grad():
        for length, (args, kwargs, _) in levels.items():
            bsz, _, _, dim = args[1].shape
            rank = args[3].stride(2) - 32
            cases = {"main": args, "step 1e-3": ss2d_like(bsz, length, dim, rank, gen, step=(5e-4, 2e-3), a=args[2])}
            row = {"L": length, "D": dim}
            for kind, case in cases.items():
                y64 = selective_scan_plain(*(t.double() for t in case), **kwargs)
                top = y64.abs().max()
                k4 = ((selective_scan(*case, **kwargs).double() - y64).abs().max() / top).item()
                plain = ((selective_scan_plain(*case, **kwargs).double() - y64).abs().max() / top).item()
                row[kind] = {"k4_vs_float64": k4, "f32_plain_vs_float64": plain, "dt_median": case[1].median().item()}
            check(row["main"]["k4_vs_float64"] <= K4_RTOL,
                  f"K4 is {row['main']['k4_vs_float64']} of the largest value from a float64 plain version on the "
                  f"seeded model's inputs at L={length}, more than {K4_RTOL}")
            rows.append(row)
    return rows


def k4_bwd_passes(args, sms: int) -> int:
    """The kernels one call of K4's backward launches: the tile start states (and g's chunk ends), g's carry
    where L has more than one chunk, the main pass, the dx sum, the channel groups' sum of dB and dC where
    D > 32, and dA and dD."""
    from experiment_yolo_torch.ops.kernels.selective_scan import chunk_length

    bsz, g, length, dim = args[1].shape
    return 4 + (length > chunk_length(bsz * g, length, dim, sms)) + (dim > 32)


def k4_bwd_cost(args):
    """Bytes (x, dt, A, B, C, D and dy read once; dx, ddt, dA, dB, dC, dD written once, B and C as dense
    (B, G, L, N)) and operations of one backward call: per (sequence, step, channel, state) 18 (the decay's
    exponent and exp, g, a h, the four products that dB, dC, dx and ddt sum and their adds, dA's product and
    add, the carried a g), per (sequence, step, channel) 4 (dx's scale and skip, dD's product and add)."""
    x, dt, a, b, c, d = args
    n = dt.numel()
    return (2 * (x.numel() + a.numel() + 2 * b.shape.numel() + d.numel()) + 3 * n) * 4, n * (16 * 18 + 4)


def check_k4_bwd(calls):
    """K4's backward (through ``SelectiveScan``, so that the forward's carry
    is the one the backward starts from) against ``selective_scan_bwd_plain``
    in f32 and in float64: on one f32 training step's calls at each level
    with their gradients, on random inputs at the widest and the narrowest
    level with step sizes log-uniform from 1e-3 to 1 and a seeded ``dy``, with SS2D's flags and
    sources, with other ones, and with none (four x directions), and at a
    ragged L. Each of the seven outputs (y and the six gradients) must be
    within BWD_RTOL of its largest f32 plain value, or else no farther from
    the float64 plain version than the f32 plain version is; both distances
    are reported. On the main path's calls two backward calls of one forward
    must give the same bits (every sum is taken in a fixed order). Timed over
    the step's ten calls: the backward alone (autograd's backward of one
    forward, kept), against the plain version."""
    import torch

    from experiment_yolo_torch.ops.kernels.selective_scan import (chunk_length, selective_scan,
                                                                  selective_scan_bwd_plain, selective_scan_plain)

    names = ("y", "dx", "ddt", "dA", "dB", "dC", "dD")
    gen = torch.Generator().manual_seed(SEED + 27)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def kernel_grads(args, kwargs, dy):
        leaves = [t.detach().requires_grad_() for t in args]
        y = selective_scan(*leaves, **kwargs)
        return (y.detach(), *torch.autograd.grad(y, leaves, dy))

    def plain(args, kwargs, dy, dtype):
        args, dy = [t.to(dtype) for t in args], dy.to(dtype)
        return (selective_scan_plain(*args, **kwargs), *selective_scan_bwd_plain(*args, dy, **kwargs))

    def held(kind, args, kwargs, dy):
        got, p32, p64 = kernel_grads(args, kwargs, dy), plain(args, kwargs, dy, torch.float32), \
            plain(args, kwargs, dy, torch.float64)
        torch.cuda.synchronize()
        row = {}
        for name, g, w32, w64 in zip(names, got, p32, p64):
            top32, top64 = w32.abs().max(), w64.abs().max()
            row[name] = {"max_abs_err": (g - w32).abs().max().item(),
                         "vs_f32_plain": ((g - w32).abs().max() / top32).item(),
                         "vs_float64": ((g.double() - w64).abs().max() / top64).item(),
                         "f32_plain_vs_float64": ((w32.double() - w64).abs().max() / top64).item()}
            r = row[name]
            check(r["vs_f32_plain"] <= BWD_RTOL or r["vs_float64"] <= r["f32_plain_vs_float64"],
                  f"K4's backward disagrees with its plain version on {kind} inputs at L={args[1].shape[2]}, {name}: "
                  f"{r}")
        return row

    def same_bits(args, kwargs, dy):
        leaves = [t.detach().requires_grad_() for t in args]
        y = selective_scan(*leaves, **kwargs)
        first, second = (torch.autograd.grad(y, leaves, dy, retain_graph=True) for _ in range(2))
        return all(torch.equal(a, b) for a, b in zip(first, second))

    levels = first_of_each_level(calls)
    detail, worst = [], 0.0
    for length, (args, kwargs, dy) in levels.items():
        bsz, _, _, dim = args[1].shape
        rank = args[3].stride(2) - 32
        row = {"shape_B_G_L_D": list(args[1].shape), "chunk_steps": chunk_length(bsz * 4, length, dim, sms),
               "main": held("main", args, kwargs, dy), "same_bits_twice": same_bits(args, kwargs, dy)}
        check(row["same_bits_twice"], f"two calls of K4's backward on the main path's inputs at L={length} gave "
              f"different bits")
        if length in (min(levels), max(levels)):  # the plain versions walk every step in Python
            rand = ss2d_like(bsz, length, dim, rank, gen, step=(1e-3, 1.0))
            rdy = torch.randn(dy.shape, generator=gen).cuda()
            row["random"] = held("random", rand, {"reverse": (True, False, False, True), "source": (1, 0, 0, 1)}, rdy)
        detail.append(row)
    bsz, dim = detail[0]["shape_B_G_L_D"][0], detail[1]["shape_B_G_L_D"][3]
    ragged = ss2d_like(bsz, RAGGED_SCAN_LENGTH, dim, 2, gen, step=(1e-3, 1.0))
    rdy = torch.randn((bsz, 4, RAGGED_SCAN_LENGTH, dim), generator=gen).cuda()
    other = {"ragged, SS2D's flags": held("ragged", ragged, {"reverse": (False, False, True, True),
                                                             "source": (0, 1, 0, 1)}, rdy)}
    four = (torch.randn((bsz, 4, RAGGED_SCAN_LENGTH, dim), generator=gen).cuda(), *ragged[1:])
    other["ragged, no flags or sources"] = held("ragged, unflagged", four, {}, rdy)
    for row in [r for d in detail for k, r in d.items() if k in ("main", "random")] + list(other.values()):
        worst = max(worst, *(v["vs_f32_plain"] for v in row.values()))
    err = max(v["max_abs_err"] for d in detail for v in d["main"].values())  # the main path's calls

    # the backward alone over the step's ten calls: one forward each, kept, and autograd's backward of it
    kept = []
    for args, kwargs, dy in calls:
        leaves = [t.detach().requires_grad_() for t in args]
        kept.append((selective_scan(*leaves, **kwargs), leaves, dy))

    def backward():
        return [torch.autograd.grad(y, leaves, dy, retain_graph=True) for y, leaves, dy in kept]

    ms = cuda_ms(backward)
    plain_ms = cuda_ms(lambda: [selective_scan_bwd_plain(*args, dy, **kwargs) for args, kwargs, dy in calls],
                       runs=1, warmup=0)
    del kept
    nbytes, ops = (sum(v) for v in zip(*(k4_bwd_cost(args) for args, _, _ in calls)))
    b_ms, b_by = bound(nbytes, ops)
    return dict(name="selective_scan_bwd", route="cuda", source="experiment_yolo_torch/csrc/selective_scan.cu",
                replaces="experiment_yolo_tpu/ops/pallas/selective_scan.py:32", max_abs_err=err, rel_err=worst, ms=ms,
                device_ms=None, plain_ms=plain_ms, plain_runs=1, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                launches_per_step=len(calls), bytes_per_step=nbytes, levels=detail, other=other)


def k4_bwd_device_ms_main() -> None:
    """Run as ``chip_smoke.py --k4-bwd-device-ms``, in a fresh process (as
    :func:`k4_device_ms_main`): the VSS model's ten scan calls of one f32
    training step at IMGSZ, batch BATCH, with their gradients, and the device
    time of their ten backward calls (autograd's backward of one forward
    each, kept), from a trace that holds every launch, also level by level.
    Prints one JSON line."""
    import torch

    from experiment_yolo_torch.engine.trainer import DetectionTrainer
    from experiment_yolo_torch.ops.kernels import _build
    from experiment_yolo_torch.ops.kernels.selective_scan import selective_scan
    from experiment_yolo_torch.utils.seeded import seeded_batch, seeded_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    model = seeded_model(VSS_CFG, SEED)
    calls = capture_scan_train_calls(DetectionTrainer(model, {"amp": False, "batch": BATCH, "imgsz": IMGSZ}),
                                     seeded_batch(BATCH, IMGSZ, SEED + 10, nc=model.nc))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kept = []
    for args, kwargs, dy in calls:
        leaves = [t.detach().requires_grad_() for t in args]
        kept.append((selective_scan(*leaves, **kwargs), leaves, dy, k4_bwd_passes(args, sms)))

    def backward(items):
        return lambda: [torch.autograd.grad(y, leaves, dy, retain_graph=True) for y, leaves, dy, _ in items]

    total = device_ms(backward(kept), "selective_scan_bwd_kernel", sum(k[3] for k in kept))
    levels = {}
    for item in kept:
        levels.setdefault(item[1][1].shape[2], item)
    per_level = {length: device_ms(backward([item]), "selective_scan_bwd_kernel", item[3])
                 for length, item in sorted(levels.items())}
    bounds = {length: bound(*k4_bwd_cost([t.detach() for t in item[1]]))[0] for length, item in sorted(levels.items())}
    print(json.dumps({"k4_bwd_device_ms": total, "calls": len(kept), "per_level_first_call": per_level,
                      "bound_ms_per_level": bounds, "launches_per_call": [k[3] for k in kept]}), flush=True)


def k4_bwd_device_ms_fresh():
    """K4's backward device time per training step from :func:`k4_bwd_device_ms_main` in a subprocess."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--k4-bwd-device-ms"], capture_output=True,
                         text=True, timeout=600)
    check(out.returncode == 0, f"the fresh K4 backward timing process failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def vss_trained(vss_state, batches, data: Path, root: Path, counters, card):
    """Phase 26: the VSS family trained (``yolov8-C2f-VSS.yaml``, phase 18's
    weights, phase 9's batches). (a) K4's forward against float64
    (:func:`k4_against_float64`) and (b) its backward against its plain
    versions (:func:`check_k4_bwd`), both on the K4 calls of one f32 step;
    (c) the backward's device time from a fresh process; (d) TRAIN_STEPS
    timed f32 and bf16 ``train_step``s (exactly 10 K4 and 10 K4-backward
    launches a step, and the K1 forms of the step's dtype); (e) one f32 step
    at VSS_CMP_IMGSZ against the CPU's with phase 11's gates, the CPU taking
    the card's picks in SPPF's windows, and the bf16 steps within 1.5x the
    CPU's bf16 distance over BF16_CMP_STEPS seeded steps (seeded batches of
    CMP_BATCH at VSS_CMP_IMGSZ); (f)
    ``YOLO(VSS_CFG, nc=3).train()`` for an epoch with the defaults. Returns
    the ``vss_trained`` record, the K4 backward kernel's row and the
    launches."""
    import torch

    from experiment_yolo_torch import DetectionModel
    from experiment_yolo_torch.engine.trainer import DetectionTrainer
    from experiment_yolo_torch.utils.seeded import seeded_batch

    t0 = time.perf_counter()

    def trainer(**overrides):
        m = DetectionModel(VSS_CFG, device="cuda")
        m.load_state_dict(vss_state, strict=True)
        return DetectionTrainer(m, {"batch": BATCH, "imgsz": IMGSZ, **overrides})

    parts, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        parts[name], t = time.perf_counter() - t, time.perf_counter()

    calls = capture_scan_train_calls(trainer(amp=False), batches[0])
    levels = first_of_each_level(calls)
    float64 = k4_against_float64(levels)
    faults = [r for r in float64 if r["step 1e-3"]["k4_vs_float64"] > K4_RTOL]
    lap("(a) capture and float64")
    k4_bwd = check_k4_bwd(calls)
    del calls, levels
    lap("(b) backward against plain")
    fresh = k4_bwd_device_ms_fresh()
    lap("(c) fresh process")
    k4_bwd["device_ms"], k4_bwd["device_ms_per_level"] = fresh["k4_bwd_device_ms"], fresh["per_level_first_call"]
    k4_bwd["bound_ms_per_level"] = fresh["bound_ms_per_level"]
    log(f"selective_scan_bwd: {k4_bwd['rel_err']} of the largest plain value at worst, kernel {k4_bwd['ms']:.4f} ms "
        f"(device {k4_bwd['device_ms']} ms) for a step's 10 calls, plain {k4_bwd['plain_ms']:.1f} ms (1 run), library "
        f"none, bound {k4_bwd['bound_ms']:.4f} ms ({k4_bwd['bound_by']})")
    for length, ms in fresh["per_level_first_call"].items():
        log(f"  K4 bwd first call at L={length}: device {json.dumps(ms)} ms, bound "
            f"{fresh['bound_ms_per_level'][length]:.4f} ms")
    log(f"  K4 against float64 (fraction of the largest value): {json.dumps(float64)}")
    for row in k4_bwd["levels"]:
        log(f"  K4 bwd level {json.dumps(row)}")
    log(f"  K4 bwd other {json.dumps(k4_bwd['other'])}")
    launches, timed = dict.fromkeys(counters, 0), {}
    for label, amp, k1 in (("float32", False, ("dfl_decode", "dfl_decode_bwd")),
                           ("bfloat16", True, ("dfl_decode_bf16", "dfl_decode_bwd_bf16"))):
        tr = trainer(amp=amp)
        torch.cuda.reset_peak_memory_stats()
        step_ms, run, last, moved, ema_moved = train_timed(tr, batches, counters)
        want = dict.fromkeys(counters, 0)
        want.update({"selective_scan": 10 * TRAIN_STEPS, "selective_scan_bwd": 10 * TRAIN_STEPS, k1[0]: TRAIN_STEPS,
                     k1[1]: 3 * TRAIN_STEPS})
        check(run == want, f"the {VSS_CFG} {label} training steps launched {run}, expected {want}")
        for name in launches:
            launches[name] += run[name]
        median = statistics.median(step_ms)
        timed[label] = {"steps": TRAIN_STEPS, "warmup_steps": TRAIN_WARMUP, "batch": BATCH, "imgsz": IMGSZ,
                        "dtype": str(tr.dtype), "step_ms_median": median, "step_ms_min": min(step_ms),
                        "step_ms_max": max(step_ms), "step_ms_p10_p90": statistics.quantiles(step_ms, n=10)[::8],
                        "img_per_s_at_median": BATCH / median * 1e3, "launches": run, "last_losses": last,
                        "params_moved": moved, "ema_moved": ema_moved,
                        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        log(f"trained {VSS_CFG} {label}: {TRAIN_STEPS} steps of {BATCH} at {IMGSZ}: median {median:.2f} ms per step, "
            f"{timed[label]['img_per_s_at_median']:.2f} img/s at the median, peak "
            f"{timed[label]['peak_memory_gib']:.2f} GiB, launches {run}, {card}")
        del tr
        torch.cuda.empty_cache()
    lap("(d) timed steps")
    cmp_batches = [seeded_batch(CMP_BATCH, VSS_CMP_IMGSZ, SEED + 20 + i, nc=6) for i in range(BF16_CMP_STEPS)]
    cmp = compare_train_cpu(vss_state, cmp_batches[0], cfg=VSS_CFG, n_ldconv=0, n_scalseq=0, n_sppf=1,
                            imgsz=VSS_CMP_IMGSZ)
    log(f"{VSS_CFG} training CPU comparison: {json.dumps(cmp)}")
    cmp16 = compare_train_cpu_bf16(vss_state, cmp_batches, cfg=VSS_CFG, imgsz=VSS_CMP_IMGSZ)
    log(f"{VSS_CFG} bf16 training CPU comparison: {json.dumps(cmp16)}")
    lap("(e) against the CPU")
    loop, run = facade_epoch(VSS_CFG, lambda steps, val: dict(
        selective_scan=10 * (2 + steps + val), selective_scan_bwd=10 * steps, dfl_decode_bf16=steps + val,
        dfl_decode_bwd_bf16=3 * steps, soft_nms=val), data, root, counters, card)
    for name in launches:
        launches[name] += run[name]
    log(f"{VSS_CFG} facade: YOLO(...).train() 1 epoch: {loop['loop_img_per_s']:.2f} img/s over the loop "
        f"({loop['train_dtype']}, AMP check {loop['amp_check']}), {card}")
    lap("(f) YOLO(...).train()")
    seconds = time.perf_counter() - t0
    log(f"phase 26 took {seconds:.1f} s: {json.dumps(parts)}")
    return {"cfg": VSS_CFG, "k4_vs_float64": float64, "k4_small_step_faults": [r["L"] for r in faults],
            "trained": timed, "cpu_comparison": cmp, "cpu_comparison_bf16": cmp16, "facade_train": loop,
            "seconds": seconds, "seconds_by_part": parts, "card": card}, k4_bwd, launches


def _cpu_copy(obj):
    """A copy of a nest of tensors (an optimizer's ``state_dict``) on the CPU."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _cpu_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu_copy(v) for v in obj)
    return obj


def atss_margins(anc_points, stride_tensor, feat_shapes, gt_bboxes, mask_gt, topk=9):
    """On ``atss.assign``'s inputs: the least gap between a valid gt's k-th
    and (k+1)-th nearest anchor of a level (a tie there picks by index), and
    the least distance of a candidate's IoU to its gt's threshold."""
    import torch

    from experiment_yolo_torch.ops.boxes import box_iou
    from experiment_yolo_torch.utils.atss import anchor_boxes_from_points

    b, m = mask_gt.shape
    centres = (gt_bboxes[..., :2] + gt_bboxes[..., 2:4]) / 2
    dist = ((centres[:, :, None] - anc_points[None, None]) ** 2).sum(-1).sqrt()[mask_gt]  # (valid gts, A)
    overlaps = box_iou(gt_bboxes.reshape(-1, 4), anchor_boxes_from_points(anc_points, stride_tensor))
    overlaps = overlaps.reshape(b, m, -1)[mask_gt]
    gap, cand, start = math.inf, torch.zeros_like(dist, dtype=torch.bool), 0
    for h, w in feat_shapes:
        d = dist[:, start:start + h * w]
        k = min(topk, h * w)
        srt, idx = torch.sort(d, dim=-1, stable=True)
        if k < h * w:
            gap = min(gap, (srt[:, k] - srt[:, k - 1]).min().item())
        cand[:, start:start + h * w].scatter_(1, idx[:, :k], True)
        start += h * w
    n = sum(min(topk, h * w) for h, w in feat_shapes)
    mean = torch.where(cand, overlaps, 0.0).sum(1, keepdim=True) / n
    thr = mean + (torch.where(cand, (overlaps - mean) ** 2, 0.0).sum(1, keepdim=True) / max(n - 1, 1)).sqrt()
    return gap, (overlaps - thr).abs()[cand].min().item()


def soap_step_projected_in_float64(args, state_dict, pre, pre_opt, grads):
    """A diagnosis of SOAP's first step in its eigenbasis, not a form of
    SOAP (whose math stays f32, as in the JAX package): the card's step rerun
    on the card from its state before the step (``pre``, ``pre_opt``) on its
    own gradients, with every projection into and out of the eigenbasis taken
    in float64 and rounded to f32. Returns each parameter's update."""
    import torch

    import experiment_yolo_torch.optim.soap as soap
    from experiment_yolo_torch import DetectionModel
    from experiment_yolo_torch.engine.trainer import DetectionTrainer

    model = DetectionModel(CFG, device="cuda")
    model.load_state_dict(state_dict, strict=True)
    opt = DetectionTrainer(model, args).state.optimizer
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(pre[n])
            p.grad = grads[n].to(p.device)
    opt.load_state_dict(_cpu_copy(pre_opt))
    project = soap._project
    soap._project = lambda g, qs, transpose: project(g.double(), [None if q is None else q.double() for q in qs],
                                                     transpose).to(g.dtype)
    try:
        check(opt.step(), "the float64-projection rerun of SOAP's step did not fire")
    finally:
        soap._project = project
    return {n: p.detach().cpu() - pre[n] for n, p in model.named_parameters()}


def soap_gap_near_zero(u, w64, g64, qs):
    """How much of the gap between the card's SOAP update ``u`` and the
    float64 step ``w64`` lies on rotated gradient components within rounding
    of 0: the gap rotated into the eigenbasis ``qs`` (float64), and the share
    of its square on the components whose float64 value |Q^T g| is at most
    gamma * (|Q|^T |g|), gamma = (the preconditioned sides summed) * 2^-24,
    the bound of an f32 projection's rounding (``g64`` the clipped gradient
    in float64). There Adam's first step, about sign(g), may take either
    sign on each device."""
    from experiment_yolo_torch.optim.soap import _project

    qs = [None if q is None else q.double() for q in qs]
    gamma = sum(q.shape[0] for q in qs if q is not None) * 2.0 ** -24
    near = _project(g64, qs, False).abs() <= gamma * _project(g64.abs(), [q if q is None else q.abs() for q in qs],
                                                              False)
    gap = _project(u.double() - w64, qs, False)
    total = float((gap ** 2).sum())
    return {"rotated_components": near.numel(), "near_zero_components": int(near.sum()),
            "gap_share_near_zero": float((gap[near] ** 2).sum()) / total if total else 0.0}


def compare_recipe_cpu(state_dict, batches, overrides, loss_fields, steps, slide=False):
    """``steps`` f32 steps of LD-P2 at CMP_IMGSZ, batch CMP_BATCH (step i on
    ``batches[i]``, as a training run takes a new batch each step), warmup off
    and ``nbs`` the batch, with the trainer ``overrides`` (the optimizer and
    the box loss's switches) and the ``LossConfig`` fields ``loss_fields``
    (the class loss, the assigner), on the card and on the CPU. ``slide``
    threads EMASlide's ``slide_mean`` through the trainer's state from 1.

    Each CPU step starts from the card's state before that step (weights,
    BatchNorm statistics, the optimizer's state, ``iou_mean``,
    ``slide_mean``) and takes the card's picks at the step functions of the
    forward (:class:`CardPicks`), and ATSS's assignment when the two differ
    (reported, with the least distance gap at a level's k-th anchor and the
    least IoU gap to a threshold). Gates, each step: the same foreground
    count; losses within 1e-4 relative; every parameter's gradient as the
    optimizer applies it (clipped, as phase 11 holds it), the unclipped
    gradients' global norm within 1e-4, and the optimizer's moments in gradient units
    (the first over 1 - b1, the root of the second over 1 - b2, SOAP's
    factors over 1 - beta) within 1e-3 relative L2 (the floor of phase 11
    under a norm of 1e-5; 1e-12 under 1e-10 for the factors); the card's
    update within 1e-5 relative L2, plus one f32 spacing of each parameter,
    of the CPU optimizer's step run from the card's state on the card's own
    gradients (Adam's first update ``lr * g / (|g| + eps)`` follows the
    sign of gradients that sit at rounding noise, so the two sides' own
    updates are not compared); where it is not, within the larger of 1e-3
    relative L2 (phase 11's update gate) and twice the CPU f32 step's
    distance of the same step in float64 (SOAP's first step in its eigenbasis
    is Adam's sign-like first step on rotated components, and a component
    that the projection's rounding leaves near 0 takes either sign, on each
    device its own: the CPU's f32 step and the card's each lie up to about
    1e-4 from float64 on some tensors, the card's up to 9x the CPU's);
    ``iou_mean`` and ``slide_mean`` within 1e-6 relative, and moved."""
    import dataclasses

    import numpy as np
    import torch

    from experiment_yolo_torch import DetectionModel
    from experiment_yolo_torch.engine.trainer import DetectionTrainer
    from experiment_yolo_torch.utils import atss

    args = {"amp": False, "batch": CMP_BATCH, "imgsz": CMP_IMGSZ, "nbs": CMP_BATCH, "warmup_epochs": 0.0, **overrides}
    sides = {}
    for dev in ("cuda", "cpu", "ref", "ref64"):
        model = DetectionModel(CFG, device="cuda" if dev == "cuda" else "cpu")
        model.load_state_dict(state_dict, strict=True)
        sides[dev] = DetectionTrainer(model.double() if dev == "ref64" else model, args)
        sides[dev].loss_cfg = dataclasses.replace(sides[dev].loss_cfg, **loss_fields)
    card, cpu = sides["cuda"].state, sides["cpu"].state
    if slide:
        card.slide_mean = torch.ones((), device="cuda")
    picks, assign, atss_rows = CardPicks(), atss.assign, []

    def card_assign(*a, **kw):
        res = assign(*a, **kw)
        atss_rows.append({"card": type(res)(*(t.cpu() for t in res))})
        return res

    def cpu_assign(pd_bboxes, anc_points, stride_tensor, feat_shapes, gt_labels, gt_bboxes, mask_gt, **kw):
        res = assign(pd_bboxes, anc_points, stride_tensor, feat_shapes, gt_labels, gt_bboxes, mask_gt, **kw)
        row, want = atss_rows[-1], atss_rows[-1]["card"]
        row.update(equal=bool(torch.equal(res.fg_mask, want.fg_mask) and torch.equal(res.target_gt_idx,
                                                                                     want.target_gt_idx)),
                   scores_max_abs_diff=(res.target_scores - want.target_scores).abs().max().item())
        row["least_distance_gap"], row["least_threshold_gap"] = atss_margins(
            anc_points, stride_tensor, feat_shapes, gt_bboxes, mask_gt.bool())
        return want  # the card's pick, should a tie have split the two sides

    def spy(opt, into):
        fire = opt.step

        def step():
            into.update({n: p.grad.detach().cpu().clone() for g in opt.param_groups
                         for n, p in zip(g["names"], g["params"])})
            return fire()
        opt.step = step

    def named_state(opt):
        return {n: opt.state[p] for g in opt.param_groups for n, p in zip(g["names"], g["params"])}

    def moments(opt):
        """Each state tensor but SOAP's bases, in gradient units."""
        one = np.float32(1)
        out = {}
        for n, st in named_state(opt).items():
            if "exp_avg" in st:
                out[f"{n}:exp_avg"] = (st["exp_avg"].cpu() / float(one - np.float32(opt.b1)), 1e-5, 1e-6)
                out[f"{n}:exp_avg_sq"] = ((st["exp_avg_sq"].cpu() / float(one - np.float32(opt.b2))).sqrt(), 1e-5,
                                          1e-6)
            if "momentum_buffer" in st:
                out[f"{n}:momentum_buffer"] = (st["momentum_buffer"].cpu(), 1e-5, 1e-6)
            for i, gg in enumerate(st.get("gg", [])):
                if gg is not None:
                    out[f"{n}:gg{i}"] = (gg.cpu() / (1 - opt.shampoo_beta), 1e-10, 1e-12)
        return out

    def gate(got, want, rtol, what, slack=None):
        """Largest relative L2 over tensors; fails naming the tensors beyond
        ``rtol`` (with each entry's (norm floor, absolute floor) where given)."""
        worst, bad = (0.0, ""), []
        for n, w in want.items():
            w, under, floor = w if isinstance(w, tuple) else (w, 1e-5, 1e-6)
            g = got[n][0] if isinstance(got[n], tuple) else got[n]
            diff, norm = float((g - w).double().norm()), float(w.double().norm())
            ok = diff <= (floor if norm < under else rtol * norm) + (slack[n] if slack else 0.0)
            rel = diff / norm if norm >= under else 0.0
            worst = max(worst, (rel, n))
            if not ok:
                bad.append(f"{n} (L2 diff {diff:.3g}, norm {norm:.3g})")
        check(not bad, f"{what} differ from the CPU's beyond {rtol} relative L2: {bad[:5]}")
        return worst

    rows = []
    for i in range(steps):
        cpu.model.load_state_dict(card.model.state_dict())
        pre_opt = _cpu_copy(card.optimizer.state_dict())
        cpu.optimizer.load_state_dict(_cpu_copy(pre_opt))  # a copy: loading on the CPU keeps the tensors it is given
        cpu.iou_mean, cpu.step = card.iou_mean.cpu(), card.step
        cpu.slide_mean = card.slide_mean.cpu() if slide else None
        pre = {n: p.detach().cpu().clone() for n, p in card.model.named_parameters()}
        grads = {"cuda": {}, "cpu": {}}  # the summed gradients before the optimizer clips them
        spy(card.optimizer, grads["cuda"])
        spy(cpu.optimizer, grads["cpu"])
        out = {}
        for dev, tr in (("cuda", sides["cuda"]), ("cpu", sides["cpu"])):
            atss.assign = card_assign if dev == "cuda" else cpu_assign
            try:
                with picks.on(dev):
                    t = time.perf_counter()
                    comps = tr.train_step(batches[i])
                    out[dev] = {"comps": {k: v.item() for k, v in comps.items()}, "s": time.perf_counter() - t}
            finally:
                atss.assign = assign
            del tr.state.optimizer.step
        check(card.optimizer.updates == i + 1, f"step {i}: the card fired {card.optimizer.updates} updates")
        check(picks.counts() == (10 * (i + 1), i + 1, 0, 3 * (i + 1)),
              f"step {i}: picks taken {picks.counts(all_lists=True)}")
        g, c = out["cuda"]["comps"], out["cpu"]["comps"]
        check(g["fg"] == c["fg"], f"step {i}: foreground count {g['fg']} on the card, {c['fg']} on the CPU")
        loss_rel = max(abs(g[k] - c[k]) / abs(c[k]) for k in ("box", "cls", "dfl"))
        check(loss_rel <= 1e-4, f"step {i}: loss components differ from the CPU's by {loss_rel} relative > 1e-4")
        # the gradients as the optimizer applies them: clipped to the global norm in place, as phase 11 holds them
        grad_rel = gate({n: p.grad.cpu() for n, p in card.model.named_parameters()},
                        {n: p.grad for n, p in cpu.model.named_parameters()}, 1e-3, f"step {i}: gradients")
        norms = [float(torch.stack([g.double().norm() for g in grads[d].values()]).norm()) for d in ("cuda", "cpu")]
        check(abs(norms[0] - norms[1]) <= 1e-4 * norms[1], f"step {i}: the gradients' global norm {norms[0]} on the "
                                                           f"card, {norms[1]} on the CPU")
        mom_rel = gate(moments(card.optimizer), moments(cpu.optimizer), 1e-3, f"step {i}: the optimizer's moments")
        # the update gate: the CPU optimizer from the card's state on the card's gradients, in f32 and in float64
        ref, bases = {}, {}
        for key in ("ref", "ref64"):
            st = sides[key].state
            with torch.no_grad():
                for n, p in st.model.named_parameters():
                    p.copy_(pre[n])
                    p.grad = grads["cuda"][n].to(p.dtype)
            st.optimizer.load_state_dict(_cpu_copy(pre_opt))
            if key == "ref64":  # SOAP's eigenbases before the step, in float64
                bases = {n: list(v["q"]) for n, v in named_state(st.optimizer).items() if "q" in v}
            check(st.optimizer.step(), f"step {i}: the update gate's optimizer did not fire")
            ref[key] = {n: p.detach() - pre[n].to(p.dtype) for n, p in st.model.named_parameters()}
        clipped64 = {n: p.grad for n, p in sides["ref64"].state.model.named_parameters()}
        after = {n: p.detach().cpu() for n, p in card.model.named_parameters()}
        upd, upd_rel, by64, proj64 = {n: after[n] - pre[n] for n in after}, (0.0, ""), {}, None
        for n, u in upd.items():
            slack = float(np.linalg.norm(np.spacing(after[n].numpy())))
            w, w64 = ref["ref"][n], ref["ref64"][n]
            diff, norm = float((u - w).double().norm()), float(w.double().norm())
            upd_rel = max(upd_rel, (diff / norm if norm else 0.0, n))
            if diff > 1e-5 * norm + slack:
                d_card, d_cpu = float((u.double() - w64).norm()), float((w.double() - w64).norm())
                by64[n] = {"rel_to_cpu_f32": diff / norm, "card_vs_f64_rel": d_card / norm,
                           "cpu_f32_vs_f64_rel": d_cpu / norm}
                if any(q is not None for q in bases.get(n, ())):  # a SOAP step in an eigenbasis: the diagnosis
                    if proj64 is None:
                        proj64 = soap_step_projected_in_float64(args, state_dict, pre, pre_opt, grads["cuda"])
                    by64[n].update(soap_gap_near_zero(u, w64, clipped64[n], bases[n]),
                                   card_projected_in_f64_vs_f64_rel=float((proj64[n].double() - w64).norm()) / norm)
                check(d_card <= max(2 * d_cpu, 1e-3 * norm) + slack, f"step {i}: {n}'s update is {diff:.3g} (L2) "
                      f"from the CPU optimizer's on the card's gradients (norm {norm:.3g}), and {d_card:.3g} from the "
                      f"float64 step, against the CPU f32 step's {d_cpu:.3g}: {json.dumps(by64[n])}")
        row = {"step": i, "fg": g["fg"], "loss_max_rel_err": loss_rel, "grad_global_norm": norms,
               "grad_max_rel_l2": grad_rel,
               "moments_max_rel_l2": mom_rel, "update_vs_cpu_step_on_card_grads_max_rel_l2": upd_rel,
               "updates_held_to_float64": by64,
               "loss_card": {k: g[k] for k in ("box", "cls", "dfl")}, "step_s_card": out["cuda"]["s"],
               "step_s_cpu": out["cpu"]["s"]}
        if args.get("use_wiseiou"):
            rel = abs(card.iou_mean.item() - cpu.iou_mean.item()) / abs(cpu.iou_mean.item())
            check(rel <= 1e-6 and card.iou_mean.item() != 1.0,
                  f"step {i}: iou_mean {card.iou_mean.item()} on the card, {cpu.iou_mean.item()} on the CPU: not "
                  "within 1e-6 relative, or it did not move")
            row["iou_mean_card"], row["iou_mean_rel_err"] = card.iou_mean.item(), rel
        if slide:
            rel = abs(card.slide_mean.item() - cpu.slide_mean.item()) / abs(cpu.slide_mean.item())
            check(rel <= 1e-6 and card.slide_mean.item() != 1.0,
                  f"step {i}: slide_mean {card.slide_mean.item()} on the card, {cpu.slide_mean.item()} on the CPU")
            row["slide_mean_card"], row["slide_mean_rel_err"] = card.slide_mean.item(), rel
        if atss_rows:
            r = atss_rows[-1]
            row["atss"] = {k: r[k] for k in ("equal", "scores_max_abs_diff", "least_distance_gap",
                                             "least_threshold_gap")}
        rows.append(row)
    opt = card.optimizer
    return {"overrides": overrides, "loss_fields": loss_fields, "slide_mean_threaded": slide,
            "optimizer": {"built": type(opt).__name__, "family": getattr(opt, "family", None),
                          "lr": opt.schedules()[0]},
            "imgsz": CMP_IMGSZ, "batch": CMP_BATCH, "steps": rows, **picks.report()}


def recipes_phase(state_dict, batches, data: Path, root: Path, counters, card):
    """Phase 27: the training recipe's switches. (a) RECIPES' R1 and R2 on
    the card and the CPU (:func:`compare_recipe_cpu`), counters at 0 just
    before and read just after (1 K1, 3 K1-backward, 10 K3 and 10
    K3-backward launches a card step); (b) ``YOLO(CFG, nc=LOOP_NC).train()``
    for one epoch with no ``optimizer`` argument (``auto``: AdamW), phase
    15's launches a step and a val batch, then ``resume`` from its
    ``last.pt`` for a second epoch. Returns the record and the launches."""
    import torch

    t0 = time.perf_counter()
    for fn in counters.values():
        fn.launches = 0
    record = {name: compare_recipe_cpu(state_dict, batches, *spec) for name, spec in RECIPES.items()}
    launches = {name: fn.launches for name, fn in counters.items()}
    steps = sum(spec[2] for spec in RECIPES.values())
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode=steps, dfl_decode_bwd=3 * steps, ldconv_gather=10 * steps, ldconv_gather_bwd=10 * steps)
    check(launches == want, f"the recipes' card steps launched {launches}, expected {want}")
    check(record["R1"]["optimizer"]["family"] == "AdamW" and record["R2"]["optimizer"]["built"] == "SOAP",
          f"the recipes built {record['R1']['optimizer']} and {record['R2']['optimizer']}")
    t_a = time.perf_counter() - t0
    torch.cuda.empty_cache()

    def per_epoch(steps, val):
        return dict(ldconv_gather=10, ldconv_gather_bf16=10 + 10 * (steps + val), dfl_decode_bf16=steps + val,
                    dfl_decode_bwd_bf16=3 * steps, ldconv_gather_bwd_bf16=10 * steps, soft_nms=val)

    loop, run = facade_epoch(CFG, per_epoch, data, root, counters, card, optimizer=None)
    check(loop["optimizer"]["arg"] == "auto" and loop["optimizer"]["family"] == "AdamW",
          f"YOLO.train with no optimizer built {loop['optimizer']}, expected auto -> AdamW")
    resumed, run2 = facade_epoch(CFG, per_epoch, data, root, counters, card, optimizer=None, epochs=2,
                                 resume=str(Path(loop["weights"]) / "last.pt"))
    check(resumed["epochs"] == 2 and resumed["optimizer"]["updates"] > loop["optimizer"]["updates"],
          f"resume from last.pt: {resumed['epochs']} epochs, {resumed['optimizer']}")
    for name in launches:
        launches[name] += run[name] + run2[name]
    return {"recipes": record, "auto_epoch": loop, "resumed_epoch": resumed, "seconds_a": t_a,
            "seconds": time.perf_counter() - t0, "card": card}, launches


def other_config(cfg, decodes, images, x, batches, cmp_batch, data: Path, root: Path, counters, card):
    """One config of phase 28 at n scale with seeded weights: served (exactly
    1 K1 a forward, 1 K5 or 1 K2 a batch, and no module of a DetectAux's aux
    branches run), the CPU on ASF_CMP_BATCH images (:func:`compare_serving_cpu`);
    K1's backward on an f32 and a bf16 step's levels against its plain
    version (phase 9's and phase 13's gates; a DetectAux's six levels:
    ``decodes`` K1 calls a step); TRAIN_STEPS timed bf16 steps (``decodes``
    K1 and 3 * ``decodes`` K1-backward launches a step, all bf16); one f32
    step at CMP_IMGSZ against the CPU's with phase 11's gates, the CPU taking
    the card's picks in SPPF's windows; :func:`facade_epoch`. Returns the
    config's record and the launches."""
    import torch

    from experiment_yolo_torch import DetectionModel
    from experiment_yolo_torch.engine.trainer import DetectionTrainer
    from experiment_yolo_torch.utils.seeded import seeded_model

    t0 = time.perf_counter()
    model = seeded_model(cfg, SEED)
    check(model.stride == (8, 16, 32), f"{cfg}: strides {model.stride}, expected (8, 16, 32)")
    state = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    params, strides = sum(p.numel() for p in model.parameters()), list(model.stride)
    log(f"model {cfg} scale n: {params} params, strides {model.stride}, nc {model.nc}, seeded weights")
    aux = [m for name in ("cv4", "cv5") for m in getattr(model.detect, name, [])]  # a level's branch each
    check(len(aux) == 2 * (decodes - 1) * len(model.stride), f"{cfg}: {len(aux)} aux branches")
    aux_calls = []
    hooks = [m.register_forward_hook(lambda *_: aux_calls.append(1)) for m in aux]
    try:
        served, launches = serve_timed(model, images, counters, {"dfl_decode": 1}, card, cfg)
        compare = compare_serving_cpu(cfg, model, x[:ASF_CMP_BATCH])
    finally:
        for h in hooks:
            h.remove()
    check(not aux_calls, f"{cfg}: the aux branches ran {len(aux_calls)} times in eval mode")
    log(f"{cfg} CPU comparison: {json.dumps(compare)}")
    del model
    torch.cuda.empty_cache()

    def trainer(amp):
        m = DetectionModel(cfg, device="cuda")
        m.load_state_dict(state, strict=True)
        return DetectionTrainer(m, {"amp": amp, "batch": BATCH, "imgsz": IMGSZ})

    _, levels = capture_train_inputs(trainer(False), batches[0], n_ldconv=0, n_decodes=decodes)
    k1_bwd = check_k1_bwd(levels)
    del levels
    trainer16 = trainer(True)
    _, levels16 = capture_train_inputs(trainer16, batches[0], n_ldconv=0, n_decodes=decodes)
    k1_bwd16 = k1_bwd_bf16_row(levels16)
    del levels16
    torch.cuda.reset_peak_memory_stats()
    step_ms, run, last, moved, ema_moved = train_timed(trainer16, batches, counters)
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode_bf16=decodes * TRAIN_STEPS, dfl_decode_bwd_bf16=3 * decodes * TRAIN_STEPS)
    check(run == want, f"the {cfg} bf16 training steps launched {run}, expected {want}")
    for name in launches:
        launches[name] += run[name]
    median = statistics.median(step_ms)
    trained = {"steps": TRAIN_STEPS, "warmup_steps": TRAIN_WARMUP, "batch": BATCH, "imgsz": IMGSZ,
               "dtype": "bfloat16", "step_ms_median": median, "step_ms_min": min(step_ms),
               "step_ms_max": max(step_ms), "step_ms_p10_p90": statistics.quantiles(step_ms, n=10)[::8],
               "img_per_s_at_median": BATCH / median * 1e3, "launches": run, "last_losses": last,
               "params_moved": moved, "ema_moved": ema_moved,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del trainer16
    torch.cuda.empty_cache()
    log(f"trained {cfg} bf16: {TRAIN_STEPS} steps of {BATCH} at {IMGSZ}: median {median:.2f} ms per step, "
        f"{trained['img_per_s_at_median']:.2f} img/s at the median, peak {trained['peak_memory_gib']:.2f} GiB, "
        f"launches {run}, {card}")
    cmp = compare_train_cpu(state, cmp_batch, cfg=cfg, n_ldconv=0, n_scalseq=0, n_sppf=1)
    log(f"{cfg} training CPU comparison: {json.dumps(cmp)}")
    loop, run = facade_epoch(cfg, lambda steps, val: dict(dfl_decode_bf16=decodes * steps + val,
                                                          dfl_decode_bwd_bf16=3 * decodes * steps, soft_nms=val),
                             data, root, counters, card)
    for name in launches:
        launches[name] += run[name]
    log(f"{cfg} facade: YOLO(...).train() 1 epoch: {loop['loop_img_per_s']:.2f} img/s over the loop "
        f"({loop['train_dtype']}, AMP check {loop['amp_check']}), {card}")
    return {"cfg": cfg, "params": params, "strides": strides, "served": served,
            "served_cpu_comparison": compare, "aux_branch_calls_served": len(aux_calls),
            "k1_backward": [k1_bwd, k1_bwd16], "trained_bf16": trained, "cpu_comparison": cmp,
            "facade_train": loop, "seconds": time.perf_counter() - t0, "card": card}, launches


def other_configs_phase(images, x, batches, cmp_batch, data: Path, root: Path, counters, card):
    """Phase 28: the other configs, ``yolov8-aux.yaml`` (DetectAux, whose
    loss decodes its aux maps in a second K1 launch) and
    ``yolov8-lafiyolo.yaml`` (MBConv), each through :func:`other_config`.
    Returns the record and the launches."""
    t0 = time.perf_counter()
    record, launches = {}, dict.fromkeys(counters, 0)
    for cfg, decodes in OTHER_CFGS.items():
        record[cfg], run = other_config(cfg, decodes, images, x, batches, cmp_batch, data, root, counters, card)
        for name in launches:
            launches[name] += run[name]
    record["seconds"] = time.perf_counter() - t0
    log(f"phase 28 took {record['seconds']:.1f} s, {card}")
    return record, launches


# Phase 29: nvJPEG's measured gap to the committed cv2.imread arrays (max abs, mean abs levels a fixture): chroma
# upsampling (nvJPEG repeats chroma samples where libjpeg interpolates) and IDCT rounding; measured on the
# committed fixtures on an H100 80GB HBM3 at 700 W. The same nvJPEG output lies within 1 level of libjpeg run with
# fancy upsampling off and the float IDCT, which names the cause.
NVJPEG_GAP = {"chroma upsampled": (68, 4.79), "no chroma upsampling": (3, 0.52)}
JPEG_FRAMES, FRAME_HW = 16, (720, 1280)  # phase 29's folder: seeded 1280 x 720 JPEGs written by the port's encoder
IMAGE_ASSETS = ROOT / "tests" / "assets" / "images"


def probe_image_libraries() -> dict:
    """What this machine offers for decoding images: headers, libraries, ffmpeg."""
    import os

    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    ld = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True, timeout=60).stdout
    return {"headers": {h: Path(h).exists() for h in ("/usr/include/jpeglib.h", "/usr/include/png.h",
                                                       "/usr/include/zlib.h", f"{cuda}/include/nvjpeg.h")},
            "libraries": sorted({line.split()[0] for line in ld.splitlines()
                                 if any(k in line for k in ("libjpeg", "libpng", "libz.", "libnvjpeg"))}),
            "ffmpeg": shutil.which("ffmpeg")}


def seeded_frame(h: int, w: int, seed: int):
    """An (h, w, 3) uint8 BGR frame: 32-px blocks of colour plus noise (``seeded_images``' recipe)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 32 + 1, w // 32 + 1, 3), dtype=np.uint8)
    img = np.repeat(np.repeat(base, 32, 0), 32, 1)[:h, :w].astype(np.int16)
    return np.clip(img + rng.integers(-20, 21, img.shape), 0, 255).astype(np.uint8)


def image_input_phase(root: Path, data: Path, bmp_epoch_img_per_s: float, counters, card):
    """Phase 29, the user's own images on the card (``data/codec.py``): (a)
    the probe's answer and the route; (b) every committed fixture decoded from
    its file and from its bytes, the two identical, PNG bit-equal to its
    ``cv2.imread`` array and JPEG within :data:`NVJPEG_GAP`; (c) the decode of
    a 1920 x 1080 JPEG timed; (d) ``YOLO(<phase 4's seeded LD-P2 checkpoint>)
    .predict(<folder of 16 seeded 1280 x 720 JPEGs>)`` at IMGSZ, batch BATCH,
    soft NMS: launches exactly phase 6's a batch (1 K1, 10 K3, 1 K5),
    detections identical to ``predict`` on the same decoded arrays and to
    ``stream=True``, img/s; (e) 8 JPEG requests to ``DetectionServer``, each
    answered as the BMP of the same decoded pixels; (f)
    ``YOLO(CFG, nc=LOOP_NC).train()`` for an epoch on a JPEG copy of phase
    12's dataset written by the port's encoder, with per-epoch val: phase
    15's launches, img/s. Returns the record and the launches."""
    import urllib.request

    import numpy as np
    import torch

    from experiment_yolo_torch import YOLO
    from experiment_yolo_torch.cfg import yaml_load
    from experiment_yolo_torch.utils import yaml_save
    from experiment_yolo_torch.data import codec, image_io
    from experiment_yolo_torch.engine.checkpoint import save_checkpoint
    from experiment_yolo_torch.serve import DetectionServer
    from experiment_yolo_torch.utils.seeded import seeded_model

    t0 = time.perf_counter()
    launches = dict.fromkeys(counters, 0)
    nv = codec.nvjpeg("cuda")
    record = {"probe": probe_image_libraries(),
              "route": "B: JPEG through nvJPEG's default backend on the card (csrc/nvjpeg_codec.cu), PNG through the "
                       "port's own decoder (zlib + csrc/png_unfilter.cpp); libjpeg (csrc/image_codec.cpp) only for "
                       "CPU callers",
              "hardware_backend_status": nv.engine_status, "card": card}
    log(f"image libraries: {json.dumps(record['probe'])}; route {record['route']}; nvJPEG's hardware backend "
        f"(probed, unused): {'created' if nv.engine_status == 0 else f'refused, status {nv.engine_status}'}")

    # (b) the committed fixtures against their cv2.imread arrays
    fixtures = {}
    for f in sorted(p for p in IMAGE_ASSETS.iterdir() if p.suffix != ".npy"):
        want = np.load(IMAGE_ASSETS / f"{f.name}.npy")
        from_file = image_io.imread(f)
        from_bytes = codec.decode(f.read_bytes(), f.name)
        check(np.array_equal(from_file, from_bytes), f"{f.name}: the decode from the file and from its bytes differ")
        check(from_file.shape == want.shape, f"{f.name}: decoded {from_file.shape}, cv2.imread {want.shape}")
        d = np.abs(from_file.astype(np.int16) - want)
        hdr = codec.header(f.read_bytes(), f.name)
        kind = ("png" if hdr.format == "png" else
                "chroma upsampled" if hdr.subsampled else "no chroma upsampling")
        limit = (0, 0.0) if kind == "png" else NVJPEG_GAP[kind]
        fixtures[f.name] = {"kind": kind, "max_abs": int(d.max()), "mean_abs": float(d.mean()),
                            "share_differing": float((d > 0).mean())}
        check(d.max() <= limit[0] and d.mean() <= limit[1],
              f"{f.name} ({kind}): {fixtures[f.name]} against cv2.imread, beyond the measured gap {limit}")
    record["fixtures"] = fixtures
    log(f"fixtures against cv2.imread (gate: PNG bit-equal, JPEG within {NVJPEG_GAP}): {json.dumps(fixtures)}")

    # (c) one 1920 x 1080 JPEG's decode
    big = codec.encode(seeded_frame(1080, 1920, SEED + 29), "jpeg")
    for _ in range(3):
        codec.decode(big)
    ms = []
    for _ in range(RUNS):
        t = time.perf_counter()
        codec.decode(big)
        ms.append((time.perf_counter() - t) * 1e3)
    record["decode_1080p"] = {"bytes": len(big), "ms_median": statistics.median(ms), "ms_min": min(ms),
                              "ms_max": max(ms), "runs": RUNS}
    log(f"decode of a 1920 x 1080 JPEG ({len(big)} bytes): median {statistics.median(ms):.3f} ms, {card}")

    # (d) YOLO(checkpoint).predict(folder)
    folder = root / "jpeg_frames"
    folder.mkdir()
    for i in range(JPEG_FRAMES):
        image_io.imwrite(folder / f"frame{i:02d}.jpg", seeded_frame(*FRAME_HW, SEED + 100 + i))
    files = sorted(folder.iterdir())
    ckpt = save_checkpoint(root / "seeded29.pt", seeded_model(CFG, SEED))
    yolo = YOLO(str(ckpt))
    args = {"imgsz": IMGSZ, "batch": BATCH, "nms_type": "soft"}
    yolo.predict(str(files[0]), **args)  # warm-up: cuDNN picks its algorithms
    for fn in counters.values():
        fn.launches = 0
    e0 = nv.images
    torch.cuda.synchronize()
    t = time.perf_counter()
    results = yolo.predict(str(folder), **args)
    folder_s = time.perf_counter() - t
    run = {name: fn.launches for name, fn in counters.items()}
    batches = math.ceil(JPEG_FRAMES / BATCH)
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode=batches, ldconv_gather=10 * batches, soft_nms=batches)
    check(run == want, f"predict on a folder launched {run}, expected {want}")
    for name in launches:
        launches[name] += run[name]
    check(nv.images - e0 == JPEG_FRAMES, "the folder's JPEGs were not decoded by nvJPEG")
    arrays = [image_io.imread(f) for f in files]
    direct = yolo.predict(arrays, **args)
    streamed = yolo.predict(str(folder), stream=True, **args)
    check(not isinstance(streamed, list), "predict(stream=True) gave a list")
    streamed = list(streamed)
    check([r.path for r in results] == [str(f) for f in files] == [r.path for r in streamed],
          "the folder's results are not the files in order")
    for a, b, c, img in zip(results, direct, streamed, arrays):
        check(np.array_equal(a.orig_img, img) and np.array_equal(a.boxes.data, b.boxes.data)
              and np.array_equal(a.boxes.data, c.boxes.data),
              f"{a.path}: detections from the file differ from those of its decoded array or of stream=True")
    counts = [len(r) for r in results]
    check(sum(counts) > 0, "the folder's images have no detections: the comparison would be empty")
    record["predict_folder"] = {"frames": JPEG_FRAMES, "hw": FRAME_HW, "imgsz": IMGSZ, "batch": BATCH, "nms": "soft",
                                "seconds": folder_s, "img_per_s": JPEG_FRAMES / folder_s,
                                "detections_per_image": sum(counts) / len(counts), "launches": run}
    log(f"predict on a folder of {JPEG_FRAMES} JPEGs of {FRAME_HW[1]} x {FRAME_HW[0]}: {folder_s:.3f} s, "
        f"{JPEG_FRAMES / folder_s:.2f} img/s with the decode, launches {run}, {card}")

    # (e) the server: JPEG bodies against BMP bodies of the same pixels, one request at a time
    server = DetectionServer(str(ckpt), batch=BATCH, imgsz=IMGSZ)
    port = server.start(host="127.0.0.1", port=0)

    def post(body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body)
        return json.loads(urllib.request.urlopen(req, timeout=120).read())["detections"]

    try:
        answers = []
        for i in range(8):
            image_io.imwrite(root / f"same{i}.bmp", arrays[i])
            answers.append((post(files[i].read_bytes()), post((root / f"same{i}.bmp").read_bytes())))
    finally:
        server.stop()
    for i, (jpeg, bmp) in enumerate(answers):
        check(jpeg == bmp, f"request {i}: the JPEG body's answer differs from the BMP of the same pixels")
    record["server"] = {"requests": 8, "detections": [len(a) for a, _ in answers]}

    # (f) train() on a JPEG copy of phase 12's dataset
    jroot = root / "jpeg_data"
    for split in ("train", "val"):
        (jroot / "images" / split).mkdir(parents=True)
        for f in sorted((data.parent / "images" / split).glob("*.bmp")):
            image_io.imwrite(jroot / "images" / split / f"{f.stem}.jpg", image_io.imread(f))
        shutil.copytree(data.parent / "labels" / split, jroot / "labels" / split)
    yaml_save(jroot / "data.yaml", {**yaml_load(data), "path": str(jroot)})

    def per_epoch(steps, val):
        return dict(ldconv_gather=10, ldconv_gather_bf16=10 + 10 * (steps + val), dfl_decode_bf16=steps + val,
                    dfl_decode_bwd_bf16=3 * steps, ldconv_gather_bwd_bf16=10 * steps, soft_nms=val)

    loop, run = facade_epoch(CFG, per_epoch, jroot / "data.yaml", root, counters, card)
    for name in launches:
        launches[name] += run[name]
    record["train_jpeg"] = loop
    record["nvjpeg"] = {"calls": nv.launches, "images": nv.images}
    record["seconds"] = time.perf_counter() - t0
    log(f"train() on the JPEG copy of phase 12's dataset: {loop['loop_img_per_s']:.2f} img/s over the loop (phase "
        f"15's BMP epoch {bmp_epoch_img_per_s:.2f}); nvJPEG {json.dumps(record['nvjpeg'])}; phase 29 took "
        f"{record['seconds']:.1f} s, {card}")
    return record, launches


# Phase 30: C2f_LDConv (LD-P2 with its C2f rows as C2f_LDConv, K3 and its backward at stride 1) and the
# segmentation family (yolov8-seg.yaml: Segment, Proto, the mask loss, the mask validator, masks in predict and the
# server)
SEG_CFG, SEG_NC, SEG_DATA_NC = "yolov8-seg.yaml", 80, 2  # the seg model served (COCO's classes) and trained (poly3/5)
SEG_CMP_IMAGES, SEG_CMP_MASKS = 2, 64  # the served CPU comparison: images of the first batch, masks an image
MASK_HALF_BAND = 1e-5  # mask pixels whose probability lies this close to 0.5 may threshold either way on each side


def seg_cfg():
    """``yolov8-seg.yaml`` at n scale, as a dict."""
    from experiment_yolo_torch.nn.tasks import yaml_model_load

    return yaml_model_load(SEG_CFG)


def c2f_ldconv_cfg():
    """``yolov8-LD-P2.yaml`` with its ``C2f`` rows renamed ``C2f_LDConv`` (no YAML of the repo uses the block)."""
    from experiment_yolo_torch.nn.tasks import yaml_model_load

    d = yaml_model_load(CFG)
    return {**d, **{sec: [[f, n, "C2f_LDConv" if m == "C2f" else m, a] for f, n, m, a in d[sec]]
                    for sec in ("backbone", "head")}}


def k3_stride1_rows(ld, ld_train, ld16, ld_train16):
    """K3 and K3's backward at stride 1 (the C2f_LDConv model's inner layers),
    f32 and bf16, against their plain versions: the forward bit-equal on the
    main path's and on random offsets, the f32 backward within BWD_RTOL of
    each output's largest plain value on the step's, random, contention and
    seam offsets, the bf16 ``dx`` within one bf16 spacing and ``doff``
    within BWD_RTOL; device ms of every stride-1 launch of one forward or
    step beside its bytes bound, the plain versions' and ``F.grid_sample``'s
    times (forward and backward)."""
    import torch
    import torch.nn.functional as F

    from experiment_yolo_torch.ops.kernels.ldconv_gather import (ldconv_gather_bwd, ldconv_gather_bwd_plain,
                                                                 ldconv_gather_fwd, ldconv_gather_plain)
    from experiment_yolo_torch.utils.seeded import contention_offsets, seam_offsets

    gen = torch.Generator().manual_seed(SEED + 7)
    rand = [(x, _random_offsets_like(o, gen), s) for x, o, s in ld]
    fwd = {}
    for kind, layers in (("main", ld), ("random", rand), ("bf16 main", ld16),
                         ("bf16 random", [(x, _random_offsets_like(o, gen), s) for x, o, s in ld16])):
        outs = [(ldconv_gather_fwd(x, o, s), ldconv_gather_plain(x, o, s)) for x, o, s in layers]
        fwd[kind] = max((a.float() - b.float()).abs().max().item() for a, b in outs)
        check(all(torch.equal(a, b) for a, b in outs),
              f"K3 at stride 1 is not bit-equal to its plain version on {kind} offsets: {fwd[kind]}")
    main = [(x, o, dy, s) for x, o, s, dy in ld_train]
    rnd = [(x, _random_offsets_like(o, gen), torch.randn(dy.shape, generator=gen).to(dy.device), s)
           for x, o, dy, s in main]
    bwd = {}
    for kind, layers in (("main", main), ("random", rnd),
                         ("contention", [(x, contention_offsets(x, o, s, gen), dy, s) for x, o, dy, s in rnd]),
                         ("seam", [(x, seam_offsets(x, o, s), dy, s) for x, o, dy, s in rnd])):
        got = [t for x, o, dy, s in layers for t in ldconv_gather_bwd(x, o, dy, s)]
        want = [t for x, o, dy, s in layers for t in ldconv_gather_bwd_plain(x, o, dy, s)]
        bwd[kind] = _rel_err(got, want)
        check(bwd[kind][1] <= BWD_RTOL, f"K3's backward at stride 1 disagrees with its plain version on {kind} "
                                        f"offsets: {bwd[kind][0]} ({bwd[kind][1]} relative)")
    main16 = [(x, o, dy, s) for x, o, s, dy in ld_train16]
    got = [ldconv_gather_bwd(x, o, dy, s) for x, o, dy, s in main16]
    want = [ldconv_gather_bwd_plain(x, o, dy, s) for x, o, dy, s in main16]
    check(all(g[0].dtype == torch.bfloat16 for g in got), "K3's bf16 backward at stride 1: dx not bf16")
    dx_err, dx_sp, ok = spacing_err([g[0] for g in got], [w[0] for w in want])
    check(ok, f"K3's bf16 backward at stride 1: dx beyond one bf16 spacing of plain ({dx_err}, {dx_sp} spacings)")
    doff_err, doff_rel = _rel_err([g[1] for g in got], [w[1] for w in want])
    check(doff_rel <= BWD_RTOL, f"K3's bf16 backward at stride 1: doff {doff_err} ({doff_rel} relative)")

    def fwd_cost(layers, el):
        nb = ops = 0
        for x, o, s in layers:
            b, n2, h, w = o.shape
            out_n = b * h * w * n2 // 2 * x.shape[1]
            nb += x.numel() * el + o.numel() * 4 + out_n * el
            ops += out_n * 9 + b * h * w * (n2 // 2) * 24  # as phase 5 counts K3's
        return bound(nb, ops)

    def bwd_cost(layers, el):
        nb = ops = 0
        for x, o, dy, s in layers:
            b, n2, h, w = o.shape
            nb += 2 * x.numel() * el + 2 * o.numel() * 4 + dy.numel() * el
            ops += dy.numel() * 23 + b * h * w * (n2 // 2) * 30  # as phase 9 counts K3's backward
        return bound(nb, ops)

    grids = grid_sample_grids(ld)

    def library_fwd():
        return [F.grid_sample(x, g, mode="bilinear", padding_mode="border", align_corners=True)
                for (x, _, _), g in zip(ld, grids)]

    xs = [x.clone().requires_grad_() for x, _, _, _ in main]
    gs = [g.clone().requires_grad_() for g in grid_sample_grids([(x, o, s) for x, o, _, s in main])]
    outs = [F.grid_sample(x, g, mode="bilinear", padding_mode="border", align_corners=True) for x, g in zip(xs, gs)]
    dys = [dy.reshape(dy.shape[0], dy.shape[1], o.shape[1] // 2, -1).permute(0, 3, 1, 2).contiguous()
           for _, o, dy, _ in main]
    rows = {}
    for label, layers, el, kernel in (("f32", ld, 4, "ldconv_gather_kernel"),
                                      ("bf16", ld16, 2, "ldconv_gather_bf16_kernel")):
        b_ms, b_by = fwd_cost(layers, el)
        rows[f"forward {label}"] = {
            "layers": len(layers), "shapes": sorted({f"{tuple(x.shape)}" for x, _, _ in layers}),
            "max_abs_err": max(v for k, v in fwd.items() if k.startswith("bf16") == (label == "bf16")),
            "ms": cuda_ms(lambda: [ldconv_gather_fwd(x, o, s) for x, o, s in layers]),
            "device_ms": device_ms(lambda: [ldconv_gather_fwd(x, o, s) for x, o, s in layers], kernel, len(layers)),
            "plain_ms": cuda_ms(lambda: [ldconv_gather_plain(x, o, s) for x, o, s in layers], runs=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by}
    rows["forward f32"]["library_ms"] = cuda_ms(library_fwd)
    rows["forward f32"]["library_device_ms"] = device_ms(library_fwd, "grid_sampler", len(ld))
    rows["forward bf16"]["library_ms"] = None
    for label, layers, el, kernel in (("f32", main, 4, "ldconv_gather_bwd_kernel"),
                                      ("bf16", main16, 2, "ldconv_gather_bwd_kernel<__nv_bfloat16")):
        b_ms, b_by = bwd_cost(layers, el)
        rows[f"backward {label}"] = {
            "layers": len(layers),
            "max_abs_err": max(e for e, _ in bwd.values()) if label == "f32" else dx_err,
            "rel_err_or_bf16_spacings": max(r for _, r in bwd.values()) if label == "f32" else dx_sp,
            "ms": cuda_ms(lambda: [ldconv_gather_bwd(x, o, dy, s) for x, o, dy, s in layers]),
            "device_ms": device_ms(lambda: [ldconv_gather_bwd(x, o, dy, s) for x, o, dy, s in layers], kernel,
                                   len(layers), span=""),
            "plain_ms": cuda_ms(lambda: [ldconv_gather_bwd_plain(x, o, dy, s) for x, o, dy, s in layers], runs=3,
                                warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    rows["backward f32"]["library_ms"] = cuda_ms(lambda: torch.autograd.grad(outs, xs + gs, dys, retain_graph=True))
    return {"forward_max_abs_err": fwd, "backward_errors": {k: {"max_abs_err": e, "rel_err": r}
                                                            for k, (e, r) in bwd.items()},
            "bf16_backward": {"dx_max_abs_err": dx_err, "dx_max_bf16_spacings": dx_sp, "doff_max_abs_err": doff_err,
                              "doff_rel_err": doff_rel}, "rows": rows}


def c2f_ldconv_part(images, counters, card):
    """The C2f_LDConv model (:func:`c2f_ldconv_cfg`, nc 6, seeded weights) at
    CMP_IMGSZ, batch CMP_BATCH: a forward and an f32 and a bf16 training step
    with exact launch counts (28 K3 forwards, 22 of them at stride 1, 18 in
    the bottlenecks; 28 K3 backwards a step), K3 and its backward at stride 1 against their plain
    versions (:func:`k3_stride1_rows`), and one f32 step against the CPU's
    with phase 11's gates (the CPU takes the card's LDConv offsets, ScalSeq's
    and SPPF's picks). Returns the record and the launches."""
    import torch

    from experiment_yolo_torch.engine.trainer import DetectionTrainer
    from experiment_yolo_torch.nn.modules import BottleneckLD, LDConv
    from experiment_yolo_torch.utils.seeded import letterboxed, model_input, seeded_batch, seeded_model

    t0 = time.perf_counter()
    cfg = c2f_ldconv_cfg()
    model = seeded_model(cfg, SEED)
    n_ld = sum(isinstance(m, LDConv) for m in model.modules())
    n_inner = 2 * sum(isinstance(m, BottleneckLD) for m in model.modules())
    n_one = sum(isinstance(m, LDConv) and m.stride == 1 for m in model.modules())
    check((n_ld, n_inner) == (28, 18), f"the C2f_LDConv model has {n_ld} LDConv layers, {n_inner} in bottlenecks")
    state = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    x = model_input(letterboxed(images[:CMP_BATCH], CMP_IMGSZ), "cuda")
    batch = seeded_batch(CMP_BATCH, CMP_IMGSZ, SEED + 40, nc=model.nc)
    launches = dict.fromkeys(counters, 0)

    def counted(fn, want, what):
        for f in counters.values():
            f.launches = 0
        out = fn()
        run = {name: f.launches for name, f in counters.items()}
        full = dict.fromkeys(counters, 0)
        full.update(want)
        check(run == full, f"the C2f_LDConv {what} launched {run}, expected {full}")
        for name in launches:
            launches[name] += run[name]
        return out

    _, ld, _ = counted(lambda: capture_inputs(model, x), {"dfl_decode": 1, "ldconv_gather": n_ld}, "forward")
    trainer = DetectionTrainer(model, {"amp": False, "batch": CMP_BATCH, "imgsz": CMP_IMGSZ})
    ld_train, _ = counted(lambda: capture_train_inputs(trainer, batch, n_ldconv=n_ld),
                          {"dfl_decode": 1, "dfl_decode_bwd": 3, "ldconv_gather": n_ld, "ldconv_gather_bwd": n_ld},
                          "f32 step")
    del trainer, model
    model16 = seeded_model(cfg, SEED)
    trainer16 = DetectionTrainer(model16, {"batch": CMP_BATCH, "imgsz": CMP_IMGSZ})  # amp: bf16
    model16.eval()
    _, ld16 = capture_bf16_inputs(model16, x, n_ld)
    model16.train()
    ld_train16, _ = counted(lambda: capture_train_inputs(trainer16, batch, n_ldconv=n_ld),
                            {"dfl_decode_bf16": 1, "dfl_decode_bwd_bf16": 3, "ldconv_gather_bf16": n_ld,
                             "ldconv_gather_bwd_bf16": n_ld}, "bf16 step")
    del trainer16, model16
    one = [(x.contiguous(), o, s) for x, o, s in ld if s == 1]  # a bottleneck's source is a view of cv1's output
    check(len(one) == n_one >= n_inner, f"{len(one)} stride-1 LDConv calls, expected {n_one} (>= {n_inner})")
    t1 = time.perf_counter()
    k3 = k3_stride1_rows(one, [e for e in ld_train if e[2] == 1], [e for e in ld16 if e[2] == 1],
                         [e for e in ld_train16 if e[2] == 1])
    del ld, ld_train, ld16, ld_train16
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    cmp = compare_train_cpu(state, batch, cfg=cfg, n_ldconv=n_ld, n_scalseq=1, n_sppf=1)
    record = {"cfg": "yolov8-LD-P2.yaml with C2f_LDConv", "imgsz": CMP_IMGSZ, "batch": CMP_BATCH,
              "ldconv_layers": n_ld, "stride1_layers": len(one), "k3_stride1": k3, "cpu_comparison": cmp,
              "launches": launches, "seconds": time.perf_counter() - t0,
              "part_seconds": {"model and captures": t1 - t0, "k3 rows": t2 - t1,
                               "cpu comparison": time.perf_counter() - t2}, "card": card}
    log(f"C2f_LDConv: {len(one)} stride-1 K3 layers: forward f32 device {k3['rows']['forward f32']['device_ms']} ms "
        f"(bound {k3['rows']['forward f32']['bound_ms']:.4f}), backward f32 device "
        f"{k3['rows']['backward f32']['device_ms']} ms (bound {k3['rows']['backward f32']['bound_ms']:.4f}); CPU "
        f"step {json.dumps({k: cmp[k] for k in ('loss_max_rel_err', 'grad_max_rel_l2', 'update_max_rel_l2')})}, "
        f"{card}")
    return record, launches


def seeded_seg_batch(batch: int, imgsz: int, seed: int, nc: int):
    """:func:`~experiment_yolo_torch.utils.seeded.seeded_batch` with the
    segment task's ``masks``: each box's rectangle drawn into the
    overlap-index image at 1/4 resolution, largest first, and the labels in
    that order, as ``format_sample`` orders them."""
    import numpy as np

    from experiment_yolo_torch.data.polygons import polygons2mask_overlap
    from experiment_yolo_torch.utils.seeded import seeded_batch

    out = seeded_batch(batch, imgsz, seed, nc=nc)
    masks = []
    for i in range(batch):
        n = int(out["mask"][i].sum())
        cx, cy, w, h = (out["bboxes"][i, :n] * imgsz).T
        rects = [np.asarray([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32)
                 for x0, y0, x1, y1 in zip(cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)]
        m, order = polygons2mask_overlap(rects, (imgsz, imgsz), 4)
        for k in ("bboxes", "cls"):
            out[k][i, :n] = out[k][i, :n][order]
        masks.append(m)
    return {**out, "masks": np.stack(masks)}


def seg_compare_cpu(model, pred, images):
    """The first SEG_CMP_IMAGES images of a served batch through the card
    and through the same weights on the CPU (plain versions): raw detect,
    coefficient and proto maps within 1e-3; then on the card's detections
    (hard NMS, its kept anchors) the first SEG_CMP_MASKS masks of each image
    in the original image, from the card's and from the CPU's coefficients and
    protos: the booleans equal except pixels whose probability lies within
    MASK_HALF_BAND of 0.5 on either side (counted), and the card's equal to
    its predictor's ``Results.masks``."""
    import numpy as np
    import torch

    from experiment_yolo_torch.data.augment import letterbox
    from experiment_yolo_torch.engine.predictor import masks_to_orig_probs
    from experiment_yolo_torch.nn.heads_extra import assemble_masks
    from experiment_yolo_torch.nn.tasks import SegmentationModel
    from experiment_yolo_torch.utils.seeded import letterboxed, model_input

    imgs = images[:SEG_CMP_IMAGES]
    batch = letterboxed(imgs, IMGSZ)
    x = model_input(batch, "cuda")
    cpu = SegmentationModel(model.yaml, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    with torch.no_grad():
        det_c, coef_c, proto_c = cpu(x.cpu())
        det_g, coef_g, proto_g = model(x)
    map_err = max((a.cpu() - b).abs().max().item() for a, b in zip([*det_g, *coef_g, proto_g],
                                                                     [*det_c, *coef_c, proto_c]))
    check(map_err <= 1e-3, f"seg raw maps (detect, coefficients, protos) differ from the CPU's by {map_err} > 1e-3")
    coeffs_c, protos_c = torch.cat([c.flatten(2) for c in coef_c], 2).transpose(1, 2), proto_c
    padded = np.zeros((pred.batch, IMGSZ, IMGSZ, 3), np.uint8)  # the predictor's batch: the images, then black
    padded[:len(imgs)] = batch
    with torch.no_grad():
        boxes, scores, coeffs_g, protos_g = model.predict(model_input(padded, "cuda"))
        _, counts, idx = pred._nms(boxes, scores, return_idx=True)
    results = pred(imgs)
    near = differ = compared = 0
    for i, (img, r) in enumerate(zip(imgs, results)):
        n = min(int(counts[i]), SEG_CMP_MASKS)
        _, gain, (padw, padh) = letterbox(img, IMGSZ)
        d = r.boxes.data[:n]
        sel = idx[i, :n].long()
        pg = assemble_masks(coeffs_g[i:i + 1, sel], protos_g[i:i + 1])[0]
        pc = assemble_masks(coeffs_c[i:i + 1, sel.cpu()], protos_c[i:i + 1])[0]
        fg, inside = masks_to_orig_probs(pg, d, IMGSZ, gain, padw, padh, *img.shape[:2])
        fc, inside_c = masks_to_orig_probs(pc, d, IMGSZ, gain, padw, padh, *img.shape[:2])
        mg, mc = (fg > 0.5) & inside, ((fc > 0.5) & inside_c).cuda()
        band = (((fg - 0.5).abs() <= MASK_HALF_BAND) | ((fc.cuda() - 0.5).abs() <= MASK_HALF_BAND)) & inside
        near += int(band.sum())
        differ += int(((mg != mc) & ~band).sum())
        compared += int(inside.sum())
        check(np.array_equal(mg.cpu().numpy(), r.masks.data[:n]), f"image {i}: the predictor's masks differ from "
                                                                    "the card's own resizes of its probabilities")
    check(differ == 0, f"{differ} mask pixels outside the 0.5 band differ between the card and the CPU")
    return {"images": len(imgs), "map_max_abs_err": map_err, "masks_per_image": SEG_CMP_MASKS,
            "mask_pixels_compared": compared, "mask_pixels_within_band_of_half": near, "band": MASK_HALF_BAND,
            "mask_pixels_differing_outside_band": differ}


def seg_served(model, images, counters, card):
    """SERVE_BATCHES batches of BATCH seeded images at IMGSZ through
    ``DetectionPredictor`` on the seg model, soft then hard NMS, counters at
    0 just before each run and read just after: exactly 1 K1 and 1 K5 (soft)
    or 1 K2 (hard) a batch; only the current batch's ``Results`` are kept
    (each holds a bool mask a detection in its image); each image's masks
    one per box, in its shape. Then :func:`seg_compare_cpu` on the first
    batch. Returns the record and the launches."""
    import torch

    from experiment_yolo_torch import DetectionPredictor

    stream = [images[i % N_IMAGES] for i in range(SERVE_BATCHES * BATCH)]
    launches, served = dict.fromkeys(counters, 0), {}
    for nms_type in ("soft", "hard"):
        pred = DetectionPredictor(model, {"imgsz": IMGSZ, "batch": BATCH, "nms_type": nms_type})
        pred(images[:BATCH])
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        batch_ms, dets, mask_px, empty, counted = [], [], 0, 0, 0
        for start in range(0, len(stream), BATCH):
            t = time.perf_counter()
            results = pred(stream[start:start + BATCH])
            batch_ms.append((time.perf_counter() - t) * 1e3)
            for r, img in zip(results, stream[start:start + BATCH]):
                m = r.masks.data
                check(m.shape == (len(r.boxes), *img.shape[:2]) and m.dtype == bool,
                      f"seg {nms_type}: masks {m.shape} for {len(r.boxes)} boxes on an image of {img.shape[:2]}")
                dets.append(len(r.boxes))
            m = results[0].masks.data  # the pixels of each batch's first image (a pass over all costs seconds)
            area = m.reshape(len(m), -1).sum(1)
            mask_px, empty, counted = mask_px + int(area.sum()), empty + int((area == 0).sum()), counted + len(m)
            del results, m
        run = {name: fn.launches for name, fn in counters.items()}
        want = dict.fromkeys(counters, 0)
        want.update(dfl_decode=SERVE_BATCHES, **{"soft_nms" if nms_type == "soft" else "nms_suppress": SERVE_BATCHES})
        check(run == want, f"seg {nms_type} NMS main path launched {run}, expected {want}")
        check(min(dets) > 0 and empty < counted, f"seg {nms_type}: detections {min(dets)}, empty masks {empty}")
        for name in launches:
            launches[name] += run[name]
        median_ms = statistics.median(batch_ms)
        served[nms_type] = {"batches": SERVE_BATCHES, "batch_ms_median": median_ms, "batch_ms_min": min(batch_ms),
                            "batch_ms_max": max(batch_ms), "batch_ms_p10_p90": statistics.quantiles(batch_ms, n=10)[::8],
                            "img_per_s_at_median": BATCH / median_ms * 1e3,
                            "detections_per_image": sum(dets) / len(dets),
                            "first_images_masks": counted, "first_images_empty_masks": empty,
                            "first_images_mask_pixels_per_detection": mask_px / counted, "launches": run}
        log(f"served {SEG_CFG} {nms_type} NMS: {len(stream)} images in {SERVE_BATCHES} batches of {BATCH} at {IMGSZ}: "
            f"median {median_ms:.2f} ms per batch (min {min(batch_ms):.2f}, max {max(batch_ms):.2f}), "
            f"{served[nms_type]['img_per_s_at_median']:.2f} img/s at the median, "
            f"{served[nms_type]['detections_per_image']:.1f} masks an image, launches {run}, {card}")
    t = time.perf_counter()
    served["cpu_comparison"] = seg_compare_cpu(model, pred, images)
    served["cpu_comparison"]["seconds"] = time.perf_counter() - t
    log(f"seg served CPU comparison: {json.dumps(served['cpu_comparison'])}")
    return served, launches


def task_validated(model, data: Path, counters, card):
    """The task's validator (``SegmentationValidator`` or ``PoseValidator``:
    multi-label hard NMS, as the JAX validators') on a synthetic task set's
    val split at IMGSZ, batch BATCH, counters at 0 just before and read just
    after (1 K1 and 1 K2 a batch): box and mask or pose mAP, img/s. Then
    every batch again: K2's keep masks on the card's candidates equal to its
    plain version's on the CPU, and the stats of the card's maps and kept
    outputs with the detections of the plain NMS on the CPU equal to the card
    run's. Returns the record and the launches."""
    import numpy as np
    import torch

    from experiment_yolo_torch.engine.validators_extra import TASK_VALIDATORS
    from experiment_yolo_torch.ops.kernels.nms_suppress import nms_suppress, nms_suppress_plain
    from experiment_yolo_torch.ops.nms import nms_candidates
    from experiment_yolo_torch.utils.metrics import DetMetrics

    ov = {"data": str(data), "imgsz": IMGSZ, "batch": BATCH, "workers": 8, "verbose": False}
    validator = TASK_VALIDATORS[model.task](ov)
    validator(model)  # warm-up; builds the dataset and the loader once
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    stats = validator(model)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in counters.items()}
    n_val = len(validator._dataset)
    nb = math.ceil(n_val / BATCH)
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode=nb, nms_suppress=nb)
    check(launches == want, f"the {model.task} validator launched {launches}, expected {want}")
    data_cfg, dataset, loader = validator._setup(model)
    box_m, task_m = DetMetrics(data_cfg["names"]), DetMetrics(data_cfg["names"])
    seen, keep_equal, kept = 0, True, 0
    a = validator.args
    for batch in loader:
        imgs = torch.as_tensor(np.asarray(batch["img"])).cuda()
        with torch.no_grad():
            boxes, scores, *rest = model.predict((imgs.permute(0, 3, 1, 2).float() / 255.0).contiguous())
        c = nms_candidates(boxes, scores, float(a.conf), multi_label=True)
        k_card = nms_suppress(c.shifted.contiguous(), c.valid, float(a.iou))
        k_plain = nms_suppress_plain(c.shifted.cpu(), c.valid.cpu(), float(a.iou))
        keep_equal = keep_equal and torch.equal(k_card.cpu(), k_plain)
        kept += int(k_plain.sum())
        det, counts, idx = validator.nms(boxes.cpu(), scores.cpu())  # plain NMS; the card's kept outputs
        extra = model.kept_outputs(*rest, idx.cuda()).float().cpu()
        n = min(len(det), n_val - seen)
        validator.score_batch(box_m, task_m, det.numpy(), counts.numpy(), extra.numpy(), batch, n)
        seen += n
    check(keep_equal, f"K2's keep masks on the {model.task} validator's candidates differ from its plain version's")
    bs, ts = box_m.result(), task_m.result()
    cpu_stats = {**{f"box_{k}": v for k, v in bs.items() if isinstance(v, float)},
                 **{f"{validator.family}_{k}": v for k, v in ts.items() if isinstance(v, float)}}
    diff = max(abs(stats[k] - v) for k, v in cpu_stats.items())
    check(diff == 0.0, f"the {model.task} validator's stats differ from those scored through the CPU by {diff}")
    return {"images": n_val, "batch": BATCH, "imgsz": IMGSZ, "nms": "hard, multi-label", "stats": stats,
            "img_per_s": n_val / secs, "seconds": secs, "k2_keep_equal_plain": keep_equal, "kept_candidates": kept,
            "stats_max_abs_diff_vs_cpu_scoring": diff, "launches": launches, "card": card}, launches


def seg_server(weights: Path, root: Path, images, counters, card):
    """A seg ``DetectionServer`` on the checkpoint ``weights`` (batch BATCH at IMGSZ) answers
    4 BMP requests, one at a time: each answer's boxes and ``mask_rle`` equal
    to the facade's ``predict`` of the same image alone (one image a batch,
    as the server ran it), its RLE decoding to the facade's masks; 1 K1 and 1
    K5 a request."""
    import urllib.request

    import numpy as np
    import torch

    from experiment_yolo_torch import YOLO
    from experiment_yolo_torch.data.image_io import imwrite
    from experiment_yolo_torch.serve import DetectionServer, _rle

    yolo = YOLO(str(weights))
    check(type(yolo.model).__name__ == "SegmentationModel", f"{weights} reloaded as {type(yolo.model).__name__}")
    server = DetectionServer(yolo, batch=BATCH, imgsz=IMGSZ)
    port = server.start(host="127.0.0.1", port=0)
    answers = []
    for fn in counters.values():
        fn.launches = 0
    try:
        for i, img in enumerate(images[:4]):
            imwrite(root / f"seg_req{i}.bmp", img)
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=(root / f"seg_req{i}.bmp").read_bytes())
            answers.append(json.loads(urllib.request.urlopen(req, timeout=120).read()))
    finally:
        server.stop()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode=4, soft_nms=4)
    check(launches == want, f"the seg server launched {launches} for 4 requests, expected {want}")
    masks = 0
    for img, a in zip(images[:4], answers):
        r = yolo.predict([img], imgsz=IMGSZ, batch=BATCH)[0]
        d = a["detections"]
        check(len(d) == len(r.boxes) and len(d) > 0, f"the server found {len(d)} detections, the facade {len(r.boxes)}")
        for k, det in enumerate(d):
            check(det["mask_rle"] == _rle(r.masks.data[k]), f"request mask {k}: the RLE differs from the facade's")
            counts, (h, w) = det["mask_rle"]["counts"], det["mask_rle"]["size"]
            flat = np.repeat(np.arange(len(counts)) % 2 == 1, counts)
            check(np.array_equal(flat.reshape(w, h).T, r.masks.data[k]), "an RLE does not decode to its mask")
            masks += 1
    return {"requests": 4, "masks": masks, "launches": launches, "card": card}, launches


def seg_phase(images, root: Path, counters, card):
    """Phase 30: :func:`c2f_ldconv_part`, then ``yolov8-seg.yaml`` (n scale,
    nc 80, seeded weights) served (:func:`seg_served`), the synthetic seg
    dataset (LOOP_TRAIN + LOOP_VAL images at IMGSZ) validated with a seeded
    nc-2 model (:func:`task_validated`), one f32 step at CMP_IMGSZ against the
    CPU (mask picks held, :func:`mask_handover`) and BF16_CMP_STEPS bf16 steps
    against the CPU's bf16 distance, one ``YOLO(SEG_CFG, nc=2).train()``
    epoch with per-epoch mask validation whose ``last.pt`` reloads as a
    ``SegmentationModel``, and a seg server (:func:`seg_server`) on a
    checkpoint of the served model (one epoch leaves every score under the
    predictor's conf). Returns the record and the launches."""
    import torch

    from experiment_yolo_torch import YOLO
    from experiment_yolo_torch.data import make_synthetic_task_dataset
    from experiment_yolo_torch.engine.checkpoint import save_checkpoint
    from experiment_yolo_torch.utils.seeded import seeded_model

    t0 = time.perf_counter()
    record, launches, seconds = {}, dict.fromkeys(counters, 0), {}

    def add(run, part):
        for name in launches:
            launches[name] += run[name]
        seconds[part] = time.perf_counter() - t0 - sum(seconds.values())

    record["c2f_ldconv"], run = c2f_ldconv_part(images, counters, card)
    add(run, "c2f_ldconv")
    model = seeded_model({**seg_cfg(), "nc": SEG_NC}, SEED)
    record["params"] = sum(p.numel() for p in model.parameters())
    check(model.stride == (8, 16, 32) and type(model).__name__ == "SegmentationModel", f"{SEG_CFG}: {model.stride}")
    log(f"model {SEG_CFG} scale n: {record['params']} params, strides {model.stride}, nc {model.nc}, seeded weights")
    record["served"], run = seg_served(model, images, counters, card)
    add(run, "served")
    served_ckpt = save_checkpoint(root / "seg_seeded.pt", model)
    del model
    torch.cuda.empty_cache()
    data = make_synthetic_task_dataset(root / "seg", "segment", n_train=LOOP_TRAIN, n_val=LOOP_VAL, imgsz=IMGSZ,
                                       seed=SEED)
    add(dict.fromkeys(counters, 0), "dataset")
    model = seeded_model({**seg_cfg(), "nc": SEG_DATA_NC}, SEED)
    record["validated"], run = task_validated(model, data, counters, card)
    add(run, "validated")
    log(f"seg validated: {record['validated']['images']} images, box mAP50 {record['validated']['stats']['box_mAP50']:.4f}"
        f", mask mAP50 {record['validated']['stats']['mask_mAP50']:.4f}, {record['validated']['img_per_s']:.2f} img/s, "
        f"{card}")
    state = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    cfg = dict(model.yaml)
    del model
    batches = [seeded_seg_batch(CMP_BATCH, CMP_IMGSZ, SEED + 50 + i, SEG_DATA_NC) for i in range(BF16_CMP_STEPS)]
    record["cpu_comparison"] = compare_train_cpu(state, batches[0], cfg=cfg, n_ldconv=0, n_scalseq=0, n_sppf=1)
    log(f"seg training CPU comparison: {json.dumps(record['cpu_comparison'])}")
    record["cpu_comparison_bf16"] = compare_train_cpu_bf16(state, batches, cfg=cfg)
    log(f"seg bf16 training CPU comparison: {json.dumps(record['cpu_comparison_bf16'])}")
    add(dict.fromkeys(counters, 0), "steps against the CPU")
    # the segment branch of the loss takes the detect maps in f32 (JAX engine/trainer.py:457-465): K1 and its
    # backward run their f32 forms in a bf16 step; validation decodes the bf16 model's maps
    loop, run = facade_epoch(SEG_CFG, lambda steps, val: dict(dfl_decode=steps, dfl_decode_bwd=3 * steps,
                                                               dfl_decode_bf16=val, nms_suppress=val),
                             data, root, counters, card, nc=SEG_DATA_NC)
    add(run, "facade epoch")
    record["facade_train"] = loop
    check(all(k in loop["last_epoch_metrics"] for k in ("box_mAP50", "mask_mAP50", "fitness")),
          f"the seg epoch's validation: {loop['last_epoch_metrics']}")
    log(f"{SEG_CFG} facade: YOLO(...).train() 1 epoch: {loop['loop_img_per_s']:.2f} img/s over the loop "
        f"({loop['train_dtype']}), val {json.dumps(loop['last_epoch_metrics'])}, {card}")
    reloaded = YOLO(str(Path(loop["weights"]) / "last.pt")).model
    check(type(reloaded).__name__ == "SegmentationModel", f"last.pt reloaded as {type(reloaded).__name__}")
    record["facade_train"]["last_pt_reloads_as"] = type(reloaded).__name__
    del reloaded
    record["server"], run = seg_server(served_ckpt, root, images, counters, card)
    add(run, "server")
    record["seconds"], record["part_seconds"] = time.perf_counter() - t0, seconds
    record["card"] = card
    log(f"phase 30 took {record['seconds']:.1f} s ({json.dumps({k: round(v, 1) for k, v in seconds.items()})}), "
        f"{card}")
    return record, launches



POSE_CFG, POSE_NC, POSE_DATA_NK = "yolov8-pose.yaml", 1, 5  # the published config (person, 17 x 3); the synthetic set's
POSE_CMP_IMAGES = 2  # the served CPU comparison: images of the first batch
POSE_KPT_ATOL = 1e-3  # px: the card's decoded keypoints against the CPU's on the same weights, and its raw maps
EXPERIMENT_ARGS = ["seeds=0", "epochs=1", "imgsz=320", "batch=8", "n_train=16", "n_val=16", "base=yolov8n.yaml",
                   "deal=yolov8-LD-P2.yaml"]


def pose_cfg(kpt_shape=(17, 3)):
    """``yolov8-pose.yaml`` at n scale, as a dict, with ``kpt_shape``."""
    from experiment_yolo_torch.nn.tasks import yaml_model_load

    return {**yaml_model_load(POSE_CFG), "kpt_shape": list(kpt_shape)}


def seeded_pose_batch(batch: int, imgsz: int, seed: int, nk: int):
    """:func:`~experiment_yolo_torch.utils.seeded.seeded_batch` at nc 1 with
    the pose task's ``keypoints`` (B, M, nk, 3): each box's keypoints drawn
    inside it, normalised, a fifth of them at visibility 0."""
    import numpy as np

    from experiment_yolo_torch.utils.seeded import seeded_batch

    out = seeded_batch(batch, imgsz, seed, nc=POSE_NC)
    rng = np.random.default_rng(seed + 1000)
    cxy, wh = out["bboxes"][..., None, :2], out["bboxes"][..., None, 2:]
    xy = cxy + rng.uniform(-0.5, 0.5, (*out["bboxes"].shape[:2], nk, 2)) * wh
    vis = np.where(rng.uniform(size=(*out["bboxes"].shape[:2], nk, 1)) < 0.2, 0.0, 2.0)
    kpts = np.concatenate([xy, vis], -1).astype(np.float32)
    return {**out, "keypoints": np.where(out["mask"][..., None, None], kpts, 0.0).astype(np.float32)}


def pose_compare_cpu(model, pred, images):
    """The first POSE_CMP_IMAGES images of a served batch through the card
    and through the same weights on the CPU (plain versions): raw detect and
    keypoint maps, and the decoded keypoints (pixels, every anchor), within
    POSE_KPT_ATOL; then the predictor's ``Results.keypoints`` equal to the
    card's kept anchors' keypoints taken back through each image's gain and
    pad. Returns the record."""
    import numpy as np
    import torch

    from experiment_yolo_torch.data.augment import letterbox
    from experiment_yolo_torch.nn.tasks import PoseModel
    from experiment_yolo_torch.utils.seeded import letterboxed, model_input

    imgs = images[:POSE_CMP_IMAGES]
    x = model_input(letterboxed(imgs, IMGSZ), "cuda")
    cpu = PoseModel(model.yaml, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    with torch.no_grad():
        det_c, kpt_c = cpu(x.cpu())
        det_g, kpt_g = model(x)
        k_c = cpu.predict(x.cpu())[2]
        k_g = model.predict(x)[2]
    map_err = max((a.cpu() - b).abs().max().item() for a, b in zip([*det_g, *kpt_g], [*det_c, *kpt_c]))
    kpt_err = (k_g.cpu() - k_c).abs().max().item()
    check(map_err <= POSE_KPT_ATOL, f"pose raw maps differ from the CPU's by {map_err} > {POSE_KPT_ATOL}")
    check(kpt_err <= POSE_KPT_ATOL, f"decoded keypoints differ from the CPU's by {kpt_err} px > {POSE_KPT_ATOL}")
    results = pred(imgs)
    padded = np.zeros((pred.batch, IMGSZ, IMGSZ, 3), np.uint8)
    padded[:len(imgs)] = letterboxed(imgs, IMGSZ)
    det, counts, kept = pred.infer(torch.from_numpy(padded).cuda())
    for i, (img, r) in enumerate(zip(imgs, results)):
        n = int(counts[i])
        _, gain, (padw, padh) = letterbox(img, IMGSZ)
        want = kept[i, :n].float().cpu().numpy().copy()
        want[..., 0] = ((want[..., 0] - padw) / gain).clip(0, img.shape[1])
        want[..., 1] = ((want[..., 1] - padh) / gain).clip(0, img.shape[0])
        check(n > 0 and np.array_equal(r.keypoints.data, want), f"image {i}: the predictor's keypoints differ from "
                                                                 "the card's kept keypoints taken back")
    return {"images": len(imgs), "map_max_abs_err": map_err, "decoded_kpt_max_abs_err_px": kpt_err,
            "atol": POSE_KPT_ATOL}


def pose_served(model, images, counters, card):
    """SERVE_BATCHES batches of BATCH seeded images at IMGSZ through
    ``DetectionPredictor`` on the pose model, soft then hard NMS, counters at
    0 just before each run and read just after: exactly 1 K1 and 1 K5 (soft)
    or 1 K2 (hard) a batch; each image's keypoints (n, 17, 3) for its n boxes,
    finite. Then :func:`pose_compare_cpu` on the first batch. Returns the
    record and the launches."""
    import numpy as np
    import torch

    from experiment_yolo_torch import DetectionPredictor

    stream = [images[i % N_IMAGES] for i in range(SERVE_BATCHES * BATCH)]
    launches, served = dict.fromkeys(counters, 0), {}
    for nms_type in ("soft", "hard"):
        pred = DetectionPredictor(model, {"imgsz": IMGSZ, "batch": BATCH, "nms_type": nms_type})
        pred(images[:BATCH])
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        batch_ms, dets = [], []
        for start in range(0, len(stream), BATCH):
            t = time.perf_counter()
            results = pred(stream[start:start + BATCH])
            batch_ms.append((time.perf_counter() - t) * 1e3)
            for r in results:
                k = r.keypoints.data
                check(k.shape == (len(r.boxes), *model.kpt_shape) and bool(np.isfinite(k).all()),
                      f"pose {nms_type}: keypoints {k.shape} for {len(r.boxes)} boxes")
                dets.append(len(r.boxes))
        run = {name: fn.launches for name, fn in counters.items()}
        want = dict.fromkeys(counters, 0)
        want.update(dfl_decode=SERVE_BATCHES, **{"soft_nms" if nms_type == "soft" else "nms_suppress": SERVE_BATCHES})
        check(run == want, f"pose {nms_type} NMS main path launched {run}, expected {want}")
        check(min(dets) > 0, f"pose {nms_type}: an image with {min(dets)} detections")
        for name in launches:
            launches[name] += run[name]
        median_ms = statistics.median(batch_ms)
        served[nms_type] = {"batches": SERVE_BATCHES, "batch_ms_median": median_ms, "batch_ms_min": min(batch_ms),
                            "batch_ms_max": max(batch_ms), "batch_ms_p10_p90": statistics.quantiles(batch_ms, n=10)[::8],
                            "img_per_s_at_median": BATCH / median_ms * 1e3,
                            "detections_per_image": sum(dets) / len(dets), "launches": run}
        log(f"served {POSE_CFG} {nms_type} NMS: {len(stream)} images in {SERVE_BATCHES} batches of {BATCH} at "
            f"{IMGSZ}: median {median_ms:.2f} ms per batch (min {min(batch_ms):.2f}, max {max(batch_ms):.2f}), "
            f"{served[nms_type]['img_per_s_at_median']:.2f} img/s at the median, "
            f"{served[nms_type]['detections_per_image']:.1f} detections an image, launches {run}, {card}")
    t = time.perf_counter()
    served["cpu_comparison"] = pose_compare_cpu(model, pred, images)
    served["cpu_comparison"]["seconds"] = time.perf_counter() - t
    log(f"pose served CPU comparison: {json.dumps(served['cpu_comparison'])}")
    return served, launches


def pose_server(weights: Path, root: Path, images, counters, card):
    """A pose ``DetectionServer`` on the checkpoint ``weights`` (batch BATCH
    at IMGSZ) answers 4 BMP requests, one at a time: each answer's boxes and
    ``keypoints`` equal to ``serialize_results`` of the facade's ``predict``
    of the same image alone; 1 K1 and 1 K5 a request."""
    import urllib.request

    import torch

    from experiment_yolo_torch import YOLO
    from experiment_yolo_torch.data.image_io import imwrite
    from experiment_yolo_torch.serve import DetectionServer, serialize_results

    yolo = YOLO(str(weights))
    check(type(yolo.model).__name__ == "PoseModel", f"{weights} reloaded as {type(yolo.model).__name__}")
    server = DetectionServer(yolo, batch=BATCH, imgsz=IMGSZ)
    port = server.start(host="127.0.0.1", port=0)
    answers = []
    for fn in counters.values():
        fn.launches = 0
    try:
        for i, img in enumerate(images[:4]):
            imwrite(root / f"pose_req{i}.bmp", img)
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                         data=(root / f"pose_req{i}.bmp").read_bytes())
            answers.append(json.loads(urllib.request.urlopen(req, timeout=120).read()))
    finally:
        server.stop()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode=4, soft_nms=4)
    check(launches == want, f"the pose server launched {launches} for 4 requests, expected {want}")
    kpts = 0
    for img, a in zip(images[:4], answers):
        want_dets = serialize_results(yolo.predict([img], imgsz=IMGSZ, batch=BATCH)[0])["detections"]
        check(a["detections"] == want_dets and len(want_dets) > 0,
              f"the server's {len(a['detections'])} detections differ from the facade's {len(want_dets)}")
        kpts += sum(len(d["keypoints"]) for d in want_dets)
    return {"requests": 4, "keypoints": kpts, "launches": launches, "card": card}, launches


def pose_phase(images, root: Path, counters, card):
    """Phase 31: ``yolov8-pose.yaml`` (n scale, nc 1, kpt 17 x 3, seeded
    weights) served (:func:`pose_served`); the synthetic pose set (nk 5,
    LOOP_TRAIN + LOOP_VAL images at IMGSZ) validated with a seeded 5 x 3
    model (:func:`task_validated`); one f32 step at CMP_IMGSZ against the CPU
    and BF16_CMP_STEPS bf16 steps against the CPU's bf16 distance; one
    ``YOLO(POSE_CFG).train()`` epoch on the pose set, which rebuilds the head
    from 17 x 3 to 5 x 3 and validates with ``PoseValidator``, whose
    ``last.pt`` reloads as a 5 x 3 ``PoseModel``; and a pose server
    (:func:`pose_server`) on a checkpoint of the served model. Returns the
    record and the launches."""
    import torch

    from experiment_yolo_torch import YOLO
    from experiment_yolo_torch.data import make_synthetic_task_dataset
    from experiment_yolo_torch.engine.checkpoint import save_checkpoint
    from experiment_yolo_torch.utils.seeded import seeded_model

    t0 = time.perf_counter()
    record, launches, seconds = {}, dict.fromkeys(counters, 0), {}

    def add(run, part):
        for name in launches:
            launches[name] += run[name]
        seconds[part] = time.perf_counter() - t0 - sum(seconds.values())

    model = seeded_model({**pose_cfg(), "nc": POSE_NC}, SEED)
    record["params"] = sum(p.numel() for p in model.parameters())
    check(model.stride == (8, 16, 32) and type(model).__name__ == "PoseModel" and model.kpt_shape == (17, 3),
          f"{POSE_CFG}: {type(model).__name__}, strides {model.stride}, kpt_shape {model.kpt_shape}")
    log(f"model {POSE_CFG} scale n: {record['params']} params, strides {model.stride}, nc {model.nc}, kpt_shape "
        f"{model.kpt_shape}, seeded weights")
    record["served"], run = pose_served(model, images, counters, card)
    add(run, "served")
    served_ckpt = save_checkpoint(root / "pose_seeded.pt", model)
    del model
    torch.cuda.empty_cache()
    data = make_synthetic_task_dataset(root / "pose", "pose", n_train=LOOP_TRAIN, n_val=LOOP_VAL, imgsz=IMGSZ,
                                       seed=SEED, nk=POSE_DATA_NK)
    add(dict.fromkeys(counters, 0), "dataset")
    model = seeded_model({**pose_cfg((POSE_DATA_NK, 3)), "nc": POSE_NC}, SEED)
    record["validated"], run = task_validated(model, data, counters, card)
    add(run, "validated")
    log(f"pose validated: {record['validated']['images']} images, box mAP50 "
        f"{record['validated']['stats']['box_mAP50']:.4f}, pose mAP50 {record['validated']['stats']['pose_mAP50']:.4f}"
        f", {record['validated']['img_per_s']:.2f} img/s, {card}")
    state = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    cfg = dict(model.yaml)
    del model
    batches = [seeded_pose_batch(CMP_BATCH, CMP_IMGSZ, SEED + 60 + i, POSE_DATA_NK) for i in range(BF16_CMP_STEPS)]
    record["cpu_comparison"] = compare_train_cpu(state, batches[0], cfg=cfg, n_ldconv=0, n_scalseq=0, n_sppf=1)
    log(f"pose training CPU comparison: {json.dumps(record['cpu_comparison'])}")
    record["cpu_comparison_bf16"] = compare_train_cpu_bf16(state, batches, cfg=cfg)
    log(f"pose bf16 training CPU comparison: {json.dumps(record['cpu_comparison_bf16'])}")
    add(dict.fromkeys(counters, 0), "steps against the CPU")
    # the pose branch of the loss takes the detect maps in f32 (JAX engine/trainer.py:466-475): K1 and its
    # backward run their f32 forms in a bf16 step; validation decodes the bf16 model's maps
    loop, run = facade_epoch(POSE_CFG, lambda steps, val: dict(dfl_decode=steps, dfl_decode_bwd=3 * steps,
                                                                dfl_decode_bf16=val, nms_suppress=val),
                             data, root, counters, card, nc=POSE_NC)
    add(run, "facade epoch")
    record["facade_train"] = loop
    check(all(k in loop["last_epoch_metrics"] for k in ("box_mAP50", "pose_mAP50", "fitness")),
          f"the pose epoch's validation: {loop['last_epoch_metrics']}")
    check(set(loop["losses"][0]) == {"box", "cls", "dfl", "kobj", "pose"}, f"the pose epoch's losses {loop['losses']}")
    log(f"{POSE_CFG} facade: YOLO(...).train() 1 epoch, head 17 x 3 -> {POSE_DATA_NK} x 3: "
        f"{loop['loop_img_per_s']:.2f} img/s over the loop ({loop['train_dtype']}), val "
        f"{json.dumps(loop['last_epoch_metrics'])}, {card}")
    reloaded = YOLO(str(Path(loop["weights"]) / "last.pt")).model
    check(type(reloaded).__name__ == "PoseModel" and reloaded.kpt_shape == (POSE_DATA_NK, 3),
          f"last.pt reloaded as {type(reloaded).__name__} {getattr(reloaded, 'kpt_shape', None)}")
    record["facade_train"]["last_pt_reloads_as"] = f"{type(reloaded).__name__} {reloaded.kpt_shape}"
    del reloaded
    record["server"], run = pose_server(served_ckpt, root, images, counters, card)
    add(run, "server")
    record["seconds"], record["part_seconds"] = time.perf_counter() - t0, seconds
    record["card"] = card
    log(f"phase 31 took {record['seconds']:.1f} s ({json.dumps({k: round(v, 1) for k, v in seconds.items()})}), "
        f"{card}")
    return record, launches


@contextlib.contextmanager
def plain_predictor_nms():
    """The predictor's NMS on CPU copies of the card's boxes and scores (the
    plain versions of K5 and K2), its outputs handed back to the card."""
    from experiment_yolo_torch.engine.predictor import DetectionPredictor

    nms = DetectionPredictor._nms

    def plain(self, boxes, scores, return_idx=False):
        return tuple(t.to(boxes.device) for t in nms(self, boxes.cpu(), scores.cpu(), return_idx))

    DetectionPredictor._nms = plain
    try:
        yield
    finally:
        DetectionPredictor._nms = nms


def experiment_phase(root: Path, counters, card):
    """Phase 32: ``python -m experiment_yolo_torch.run_experiment`` with
    EXPERIMENT_ARGS under ``root`` (the grid trained and validated on the
    card, the bootstrap protocol), counters at 0 just before and read just
    after: the report and ``results.json`` written under the root; a second
    call reuses both checkpoints (``YOLO.train`` raises if called) and gives
    the same results; each model's ``per_image_stats`` through K5 (1 K1 and 1
    K5 an image) equal to the same stats through the plain soft-NMS on the
    CPU, and ``compare_scores`` of the card's bootstrap scores equal to that
    of the plain ones. Returns the record and the launches."""
    import numpy as np
    import torch

    from experiment_yolo_torch import YOLO, run_experiment
    from experiment_yolo_torch.compare_models import map50_of_subset, per_image_stats
    from experiment_yolo_torch.data.dataset import YOLODataset
    from experiment_yolo_torch.utils.stats import bootstrap_indices, compare_scores

    t0 = time.perf_counter()
    argv = [*EXPERIMENT_ARGS, f"root={root}"]
    for fn in counters.values():
        fn.launches = 0
    first = run_experiment.main(argv)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    check((root / "EXPERIMENTS.md").is_file() and json.loads((root / "results.json").read_text()) == first,
          f"the experiment wrote no report or results under {root}")
    train = YOLO.train

    def no_training(*args, **kwargs):
        raise AssertionError("the second invocation trained a finished run again")

    t = time.perf_counter()
    YOLO.train = no_training
    try:
        again = run_experiment.main(argv)
    finally:
        YOLO.train = train
    second_s = time.perf_counter() - t
    check(again == first, f"the second invocation's results {again} differ from the first's {first}")

    kv = dict(a.split("=", 1) for a in EXPERIMENT_ARGS)
    imgsz, n_val = int(kv["imgsz"]), int(kv["n_val"])
    ds = YOLODataset(root / "dataset" / "images" / "val", imgsz=imgsz, augment=False, device="cuda")
    idxs = bootstrap_indices(len(ds), n_bootstrap=30, fraction=0.5, seed=42)
    scores, equal = {}, True
    for cfg in (kv["base"], kv["deal"]):
        yolo = YOLO(str(root / "train" / f"{Path(cfg).stem}_s0" / "weights" / "best.pt"))
        for fn in counters.values():
            fn.launches = 0
        card_stats = per_image_stats(yolo, ds, imgsz)
        run = {name: fn.launches for name, fn in counters.items()}
        want = dict.fromkeys(counters, 0)
        want.update(dfl_decode=n_val, soft_nms=n_val, **({"ldconv_gather": 10 * n_val} if "LD" in cfg else {}))
        check(run == want, f"per_image_stats of {cfg} launched {run}, expected {want}")
        for name in launches:
            launches[name] += run[name]
        with plain_predictor_nms():
            plain_stats = per_image_stats(yolo, ds, imgsz)
        same = all(np.array_equal(a, b) for sa, sb in zip(card_stats, plain_stats) for a, b in zip(sa, sb))
        equal = equal and same
        scores[cfg] = [np.asarray([map50_of_subset(st, i) for i in idxs]) for st in (card_stats, plain_stats)]
    check(equal, "per_image_stats through K5 differ from those through the plain soft-NMS")
    card_cmp = compare_scores(scores[kv["deal"]][0], scores[kv["base"]][0])
    plain_cmp = compare_scores(scores[kv["deal"]][1], scores[kv["base"]][1])
    check(card_cmp.summary() == plain_cmp.summary() and all(
        np.array_equal(np.asarray(getattr(card_cmp, f)), np.asarray(getattr(plain_cmp, f)), equal_nan=True)
        for f in card_cmp.__dataclass_fields__), "compare_scores of the card's bootstrap scores differs from the CPU's")
    record = {"args": EXPERIMENT_ARGS, "results": first, "first_call_s": first_s, "second_call_s": second_s,
              "per_image_stats_k5_equal_plain": equal, "comparison": card_cmp.summary(),
              "seconds": time.perf_counter() - t0, "launches": launches, "card": card}
    log(f"phase 32: run_experiment {' '.join(EXPERIMENT_ARGS)}: {first_s:.1f} s, again (reused) {second_s:.1f} s, "
        f"results {json.dumps(first)}, {card_cmp.summary()}, {card}")
    return record, launches

OBB_CFG, OBB_NC, OBB_IMGSZ = "yolov8-obb.yaml", 15, 1024  # DOTA v1.0's 15 classes at DOTA's published image size
OBB_DATA_NC = 1  # the synthetic obb set's one class
OBB_CMP_IMAGES = 2  # the served CPU comparison: images of the first batch
OBB_SERVE_BATCHES = 20  # batches of BATCH served at OBB_IMGSZ
OBB_PX_ATOL, OBB_RAD_ATOL = 1e-3, 1e-5  # the card's raw maps and decoded xywh (px), and its angles, against the CPU's
# K7's pair arithmetic (csrc/nms_suppress.cu:probiou_of), in two classes. Single-issue f32 operations, 32: the
# three sums of the covariance terms, the centre differences (2), the core A*B - C*C (3), + eps, t1 (2 squares, 2
# products, a sum, * 0.25), t2 (a difference, 2 products, * 0.5), the root's product and * 4, t3's two + eps and
# * 0.5, the two sums and two clips of bd, 1 - e, + eps, 1 - hd, the compare. They issue at one per lane and
# clock, 128 lanes an SM: half the 67 TFLOP/s, which counts an FMA as two. Operations that need the special
# function unit, 7: three divisions, two square roots, the log and the exp; each takes at least one of its
# operations, 16 an SM and clock. The two pipes run side by side, so a pair costs the larger of the two.
PROBIOU_F32_OPS, PROBIOU_SFU_OPS = 32, 7
H100_SMS, F32_LANES_PER_SM, SFU_LANES_PER_SM = 132, 128, 16  # H100 SXM


def k7_bound(valid, k: int):
    """(least ms, what bounds it, the three times) for a batch of K = ``k``
    rotated candidates per image, worked out as K2's (:func:`k2_bound`): the
    ProbIoU arithmetic of every pair (i, j > i), each class of operation at
    its own rate (each box's covariance terms once, not counted), 22 bytes a
    candidate (20 of xywhr and a valid flag read, a keep flag written) over
    HBM, and the chain of the image with most valid candidates at one
    dependent register operation each."""
    pairs = valid.shape[0] * k * (k - 1) / 2
    per_pair_clocks = max(PROBIOU_F32_OPS / F32_LANES_PER_SM, PROBIOU_SFU_OPS / SFU_LANES_PER_SM) / H100_SMS
    times = {"pairs_ms": pairs * per_pair_clocks / SM_CLOCK_HZ * 1e3,
             "bytes_ms": valid.numel() * (20 + 1 + 1) / HBM_BYTES_PER_S * 1e3,
             "chain_ms": int(valid.sum(1).max()) * DEPENDENT_OP_CLOCKS / SM_CLOCK_HZ * 1e3}
    worst = max(times, key=times.get)
    return times[worst], "bytes" if worst == "bytes_ms" else "operations", times


def k7_made_up(gen):
    """K7's made-up cases, each (xywhr boxes (B, K, 5) with the class offset
    on the centres, valid (B, K), threshold): clustered turned boxes at a
    ragged K = 1,000 and at the largest K, 8,192; exact duplicates; pairs
    whose ProbIoU is exactly the threshold (every pair the same shape on
    whole-pixel centres: none may suppress); boxes of one shape in 15 classes'
    offsets (ProbIoU at its clip: none suppresses across classes); invalid
    candidates interleaved with valid ones; an image with no valid
    candidate."""
    import math as _math

    import torch

    from experiment_yolo_torch.ops.boxes import probiou

    def clustered(b, k):
        centres = (torch.rand(b, k // 8 + 1, 2, generator=gen) * 1000).repeat_interleave(8, 1)[:, :k]
        centres = centres + torch.randn(b, k, 2, generator=gen) * 8
        wh = torch.rand(b, k, 2, generator=gen) * 60 + 6
        ang = torch.rand(b, k, 1, generator=gen) * _math.pi - _math.pi / 4
        return torch.cat([centres, wh, ang], -1).contiguous()

    def some_valid(b, k):
        return torch.rand(b, k, generator=gen) > 0.2

    dup = clustered(2, 512)
    dup[:, 1::2] = dup[:, 0::2]
    x0 = 100.0 * torch.arange(300, dtype=torch.float32)
    pair = torch.tensor([[0.0, 0.0, 40.0, 20.0, 0.3], [6.0, 2.0, 40.0, 20.0, 0.5]])
    ties = pair.repeat(300, 1)
    ties[:, 0] += x0.repeat_interleave(2)
    ties = torch.stack([ties, ties]).contiguous()
    tie_thr = float(probiou(ties[:1, :1], ties[:1, 1:2])[0, 0])
    classes = clustered(1, 15 * 64)[:, :64].repeat(1, 15, 1)
    classes[..., :2] += (torch.arange(15, dtype=torch.float32).repeat_interleave(64) * 7680.0)[None, :, None]
    interleaved = some_valid(2, 1024)
    interleaved[:, 1::2] = False
    none = some_valid(2, 1024)
    none[1] = False
    return {"ragged K=1000": (clustered(3, 1000), some_valid(3, 1000), 0.45),
            "K=8192": (clustered(1, 8192), some_valid(1, 8192), 0.45),
            "duplicates": (dup, some_valid(2, 512), 0.45),
            "ProbIoU at the threshold": (ties, torch.ones(2, 600, dtype=torch.bool), tie_thr),
            "15 classes, one shape": (classes.contiguous(), torch.ones(1, 960, dtype=torch.bool), 0.1),
            "interleaved invalid": (clustered(2, 1024), interleaved, 0.3),
            "an image with no valid candidate": (clustered(2, 1024), none, 0.3)}


def check_k7(shifted, valid, thr):
    """K7 on the served batch's candidates and on :func:`k7_made_up` against
    its plain version on the card: identical keep masks; timed beside its
    plain version, with its device time (pair pass and chain) and bound."""
    import torch

    from experiment_yolo_torch.ops.kernels.nms_rotated import nms_rotated_suppress, nms_rotated_suppress_plain

    keep, want = nms_rotated_suppress(shifted, valid, thr), nms_rotated_suppress_plain(shifted, valid, thr)
    torch.cuda.synchronize()
    mismatched = int((keep != want).sum())
    check(mismatched == 0, f"K7 nms_rotated_suppress: {mismatched} keep flags differ from its plain version")
    check(bool(want.any()) and bool((valid & ~want).any()), "K7 inputs neither keep nor suppress: no real work")
    made_up = {}
    for label, (boxes, ok, t) in k7_made_up(torch.Generator().manual_seed(SEED + 7)).items():
        boxes, ok = boxes.cuda(), ok.cuda()
        got, ref = nms_rotated_suppress(boxes, ok, t), nms_rotated_suppress_plain(boxes, ok, t)
        torch.cuda.synchronize()
        bad = int((got != ref).sum())
        check(bad == 0, f"K7 nms_rotated_suppress: {bad} keep flags differ from its plain version on the {label} case")
        made_up[label] = {"K": boxes.shape[1], "images": boxes.shape[0], "kept": int(ref.sum()),
                          "valid": int(ok.sum()), "mismatched": bad}
        if label == "15 classes, one shape":  # each class keeps what one class alone keeps
            one = int(nms_rotated_suppress_plain(boxes[:, :64], ok[:, :64], t).sum())
            check(made_up[label]["kept"] == 15 * one, f"K7 kept {made_up[label]['kept']} of 15 classes, one class "
                                                      f"alone {one}: a suppression across classes")
    check(made_up["ProbIoU at the threshold"]["kept"] == 1200, "K7's tie case should keep every pair whole")
    ms = cuda_ms(lambda: nms_rotated_suppress(shifted, valid, thr))
    dev_ms = device_ms(lambda: nms_rotated_suppress(shifted, valid, thr), "nms_rotated_kernel_pairs", 1, span="")
    plain_ms = cuda_ms(lambda: nms_rotated_suppress_plain(shifted, valid, thr), PLAIN_RUNS, 1)
    b_ms, b_by, parts = k7_bound(valid, shifted.shape[1])
    return dict(name="nms_rotated_suppress", route="cuda", source="experiment_yolo_torch/csrc/nms_suppress.cu",
                replaces="experiment_yolo_tpu/ops/nms.py:258", max_abs_err=float(mismatched), ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, kept=int(want.sum()),
                candidates=int(valid.sum()), images=int(valid.shape[0]), K=int(valid.shape[1]), bound_parts=parts,
                bound_assumption=f"largest of: per pair (i, j > i), the larger of {PROBIOU_F32_OPS} single-issue "
                                 f"f32 operations at {F32_LANES_PER_SM} lanes and {PROBIOU_SFU_OPS} special-function "
                                 f"operations (divisions, roots, log, exp) at {SFU_LANES_PER_SM} lanes, an SM and "
                                 f"clock, {H100_SMS} SMs; 22 bytes per candidate over HBM; the image with "
                                 f"most valid candidates deciding them one after another at {DEPENDENT_OP_CLOCKS} "
                                 f"clocks each, {SM_CLOCK_HZ / 1e9} GHz", made_up=made_up)


@contextlib.contextmanager
def plain_k7():
    """``nms_rotated`` with K7's plain version on the card's tensors."""
    import experiment_yolo_torch.ops.nms as nms_module
    from experiment_yolo_torch.ops.kernels.nms_rotated import nms_rotated_suppress_plain

    kernel = nms_module.nms_rotated_suppress
    nms_module.nms_rotated_suppress = nms_rotated_suppress_plain
    try:
        yield
    finally:
        nms_module.nms_rotated_suppress = kernel


def obb_compare_cpu(model, pred, images):
    """The first OBB_CMP_IMAGES images of a served batch through the card and
    through the same weights on the CPU (plain versions): raw detect and
    angle maps and decoded xywh (px, every anchor) within OBB_PX_ATOL, angles
    within OBB_RAD_ATOL; the card's packed detections through K7 equal to
    those through its plain version on the card; the predictor's
    ``Results.obb`` the card's detections taken back through each image's
    gain and pad. Returns the record."""
    import numpy as np
    import torch

    from experiment_yolo_torch.data.augment import letterbox
    from experiment_yolo_torch.nn.tasks import OBBModel
    from experiment_yolo_torch.ops.nms import nms_rotated
    from experiment_yolo_torch.utils.seeded import letterboxed, model_input

    imgs = images[:OBB_CMP_IMAGES]
    x = model_input(letterboxed(imgs, OBB_IMGSZ), "cuda")
    cpu = OBBModel(model.yaml, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    with torch.no_grad():
        det_c, ang_c = cpu(x.cpu())
        det_g, ang_g = model(x)
        rb_c, sc_c = cpu.predict(x.cpu())
        rb_g, sc_g = model.predict(x)
    map_err = max((a.cpu() - b).abs().max().item() for a, b in zip([*det_g, *ang_g], [*det_c, *ang_c]))
    xywh_err = (rb_g[..., :4].cpu() - rb_c[..., :4]).abs().max().item()
    rad_err = (rb_g[..., 4].cpu() - rb_c[..., 4]).abs().max().item()
    score_err = (sc_g.cpu() - sc_c).abs().max().item()
    check(map_err <= OBB_PX_ATOL, f"OBB raw maps differ from the CPU's by {map_err} > {OBB_PX_ATOL}")
    check(xywh_err <= OBB_PX_ATOL, f"decoded xywh differ from the CPU's by {xywh_err} px > {OBB_PX_ATOL}")
    check(rad_err <= OBB_RAD_ATOL, f"decoded angles differ from the CPU's by {rad_err} rad > {OBB_RAD_ATOL}")
    a = pred.args
    kw = dict(conf_thres=float(a.conf), iou_thres=float(a.iou), max_det=int(a.max_det))
    det_k, n_k = nms_rotated(rb_g, sc_g, **kw)
    with plain_k7():
        det_p, n_p = nms_rotated(rb_g, sc_g, **kw)
    check(torch.equal(det_k, det_p) and torch.equal(n_k, n_p), "the packed detections through K7 differ from those "
                                                               "through its plain version on the card")
    results = pred(imgs)
    padded = np.zeros((pred.batch, OBB_IMGSZ, OBB_IMGSZ, 3), np.uint8)
    padded[:len(imgs)] = letterboxed(imgs, OBB_IMGSZ)
    det, counts = pred.infer(torch.from_numpy(padded).cuda())
    for i, (img, r) in enumerate(zip(imgs, results)):
        n = int(counts[i])
        _, gain, (padw, padh) = letterbox(img, OBB_IMGSZ)
        want = det[i, :n].cpu().numpy().copy()
        want[:, 0] = ((want[:, 0] - padw) / gain).clip(0, img.shape[1])
        want[:, 1] = ((want[:, 1] - padh) / gain).clip(0, img.shape[0])
        want[:, 2:4] = want[:, 2:4] / gain
        check(n > 0 and np.array_equal(r.obb.data, want), f"image {i}: the predictor's oriented boxes differ from "
                                                          "the card's detections taken back")
    return {"images": len(imgs), "map_max_abs_err": map_err, "xywh_max_abs_err_px": xywh_err,
            "angle_max_abs_err_rad": rad_err, "score_max_abs_err": score_err, "atol_px": OBB_PX_ATOL,
            "atol_rad": OBB_RAD_ATOL, "packed_detections_k7_equal_plain": True,
            "detections_first_images": n_k[:len(imgs)].tolist()}


def obb_served(model, images, counters, card):
    """OBB_SERVE_BATCHES batches of BATCH seeded images at OBB_IMGSZ through
    ``DetectionPredictor`` on the OBB model (rotated NMS, hard whatever
    ``nms_type`` says), counters at 0 just before and read just after:
    exactly 1 K1 and 1 K7 a batch, finite (n, 7) detections. Then K7 against
    its plain version on the first batch's candidates and made-up cases
    (:func:`check_k7`), and :func:`obb_compare_cpu`. Returns the record, the
    K7 row and the launches."""
    import numpy as np
    import torch

    from experiment_yolo_torch import DetectionPredictor
    from experiment_yolo_torch.ops.nms import rotated_candidates
    from experiment_yolo_torch.utils.seeded import letterboxed, model_input

    stream = [images[i % N_IMAGES] for i in range(OBB_SERVE_BATCHES * BATCH)]
    pred = DetectionPredictor(model, {"imgsz": OBB_IMGSZ, "batch": BATCH})
    pred(images[:BATCH])
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    batch_ms, dets = [], []
    for start in range(0, len(stream), BATCH):
        t = time.perf_counter()
        results = pred(stream[start:start + BATCH])
        batch_ms.append((time.perf_counter() - t) * 1e3)
        for r in results:
            check(r.obb.data.shape == (len(r), 7) and bool(np.isfinite(r.obb.data).all()),
                  f"obb: detections {r.obb.data.shape}")
            dets.append(len(r))
    launches = {name: fn.launches for name, fn in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode=OBB_SERVE_BATCHES, nms_rotated_suppress=OBB_SERVE_BATCHES)
    check(launches == want, f"the OBB main path launched {launches}, expected {want}")
    check(min(dets) > 0, f"obb: an image with {min(dets)} detections")
    median_ms = statistics.median(batch_ms)
    served = {"batches": OBB_SERVE_BATCHES, "batch": BATCH, "imgsz": OBB_IMGSZ, "nms": "rotated, hard",
              "batch_ms_median": median_ms, "batch_ms_min": min(batch_ms), "batch_ms_max": max(batch_ms),
              "batch_ms_p10_p90": statistics.quantiles(batch_ms, n=10)[::8],
              "img_per_s_at_median": BATCH / median_ms * 1e3, "detections_per_image": sum(dets) / len(dets),
              "launches": launches}
    log(f"served {OBB_CFG} (nc {OBB_NC}): {len(stream)} images in {OBB_SERVE_BATCHES} batches of {BATCH} at {OBB_IMGSZ}: "
        f"median {median_ms:.2f} ms per batch (min {min(batch_ms):.2f}, max {max(batch_ms):.2f}), "
        f"{served['img_per_s_at_median']:.2f} img/s at the median, {served['detections_per_image']:.1f} detections "
        f"an image, launches {launches}, {card}")
    x = model_input(letterboxed(images[:BATCH], OBB_IMGSZ), "cuda")
    with torch.no_grad():
        c = rotated_candidates(*model.predict(x), conf_thres=float(pred.args.conf))
    k7 = check_k7(c.shifted, c.valid, float(pred.args.iou))
    served["k7_candidates_per_image"] = k7["candidates"] / BATCH
    log(f"nms_rotated_suppress: {k7['max_abs_err']} keep flags off, kernel {k7['ms']:.4f} ms (device "
        f"{k7['device_ms']} ms) on {BATCH} images of K = {k7['K']} ({k7['candidates']} valid, {k7['kept']} kept), "
        f"plain {k7['plain_ms']:.4f} ms, library none, bound {k7['bound_ms']:.4f} ms ({k7['bound_by']}: "
        f"{k7['bound_parts']}), {card}")
    for label, row in k7["made_up"].items():
        log(f"  K7 {label}: {row}")
    t = time.perf_counter()
    served["cpu_comparison"] = obb_compare_cpu(model, pred, images)
    served["cpu_comparison"]["seconds"] = time.perf_counter() - t
    log(f"obb served CPU comparison: {json.dumps(served['cpu_comparison'])}")
    return served, k7, launches


def obb_validated(model, data: Path, counters, card):
    """``OBBValidator`` on the synthetic obb set's val split at IMGSZ, batch
    BATCH, counters at 0 just before and read just after (1 K1 and 1 K7 a
    batch): mAP, img/s; then again with K7's plain version on the card: the
    same stats. Returns the record and the launches."""
    import torch

    from experiment_yolo_torch.engine.validators_extra import OBBValidator

    validator = OBBValidator({"data": str(data), "imgsz": IMGSZ, "batch": BATCH, "workers": 8, "verbose": False})
    validator(model)  # warm-up; builds the dataset and the loader once
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    stats = validator(model)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in counters.items()}
    n_val = len(validator._dataset)
    nb = math.ceil(n_val / BATCH)
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode=nb, nms_rotated_suppress=nb)
    check(launches == want, f"the obb validator launched {launches}, expected {want}")
    with plain_k7():
        plain = validator(model)
    check(plain == stats, f"the obb validator's stats through K7 {stats} differ from those through its plain "
                          f"version {plain}")
    return {"images": n_val, "batch": BATCH, "imgsz": IMGSZ, "nms": "rotated, hard", "stats": stats,
            "stats_k7_equal_plain": True, "img_per_s": n_val / secs, "seconds": secs, "launches": launches,
            "card": card}, launches


def seeded_obb_batch(batch: int, imgsz: int, seed: int):
    """:func:`~experiment_yolo_torch.utils.seeded.seeded_batch` at nc 1 with
    each box turned: ``bboxes`` (B, M, 5), an angle in [-pi/2, 0) added, as
    ``cv2.minAreaRect`` gives them."""
    import numpy as np

    from experiment_yolo_torch.utils.seeded import seeded_batch

    out = seeded_batch(batch, imgsz, seed, nc=OBB_DATA_NC)
    ang = np.random.default_rng(seed + 1000).uniform(-np.pi / 2, 0, (*out["bboxes"].shape[:2], 1))
    rb = np.concatenate([out["bboxes"], ang], -1).astype(np.float32)
    return {**out, "bboxes": np.where(out["mask"][..., None], rb, 0.0).astype(np.float32)}


def obb_server(weights: Path, root: Path, images, counters, card):
    """An OBB ``DetectionServer`` on the checkpoint ``weights`` (batch BATCH
    at OBB_IMGSZ) answers 4 BMP requests, one at a time: each answer's
    ``xywhr`` and ``points`` equal to ``serialize_results`` of the facade's
    ``predict`` of the same image alone; 1 K1 and 1 K7 a request."""
    import urllib.request

    import torch

    from experiment_yolo_torch import YOLO
    from experiment_yolo_torch.data.image_io import imwrite
    from experiment_yolo_torch.serve import DetectionServer, serialize_results

    yolo = YOLO(str(weights))
    check(type(yolo.model).__name__ == "OBBModel", f"{weights} reloaded as {type(yolo.model).__name__}")
    server = DetectionServer(yolo, batch=BATCH, imgsz=OBB_IMGSZ)
    port = server.start(host="127.0.0.1", port=0)
    answers = []
    for fn in counters.values():
        fn.launches = 0
    try:
        for i, img in enumerate(images[:4]):
            imwrite(root / f"obb_req{i}.bmp", img)
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                         data=(root / f"obb_req{i}.bmp").read_bytes())
            answers.append(json.loads(urllib.request.urlopen(req, timeout=120).read()))
    finally:
        server.stop()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode=4, nms_rotated_suppress=4)
    check(launches == want, f"the OBB server launched {launches} for 4 requests, expected {want}")
    n = 0
    for img, a in zip(images[:4], answers):
        want_dets = serialize_results(yolo.predict([img], imgsz=OBB_IMGSZ, batch=BATCH)[0])["detections"]
        check(a["detections"] == want_dets and len(want_dets) > 0 and {"xywhr", "points"} <= set(want_dets[0]),
              f"the server's {len(a['detections'])} detections differ from the facade's {len(want_dets)}")
        n += len(want_dets)
    return {"requests": 4, "detections": n, "launches": launches, "card": card}, launches


def obb_phase(images, root: Path, counters, card):
    """Phase 33: ``yolov8-obb.yaml`` (n scale, nc 15, seeded weights) served
    at OBB_IMGSZ with K7 held to its plain version (:func:`obb_served`); the
    synthetic obb set (LOOP_TRAIN + LOOP_VAL images at IMGSZ) validated with
    a seeded nc-1 model (:func:`obb_validated`); one f32 step at CMP_IMGSZ
    against the CPU (the CPU takes the card's TAL assignment where the two
    part only at near-ties, :func:`assign_handover`) and BF16_CMP_STEPS bf16 steps against the CPU's bf16 distance;
    one ``YOLO(OBB_CFG, nc=1).train()`` epoch on the obb set with
    ``OBBValidator``, whose ``last.pt`` reloads as an ``OBBModel``; and an
    OBB server (:func:`obb_server`) on a checkpoint of the served model.
    Returns the record, the K7 row and the launches."""
    import torch

    from experiment_yolo_torch import YOLO
    from experiment_yolo_torch.data import make_synthetic_task_dataset
    from experiment_yolo_torch.engine.checkpoint import save_checkpoint
    from experiment_yolo_torch.nn.tasks import yaml_model_load
    from experiment_yolo_torch.utils.seeded import seeded_model

    t0 = time.perf_counter()
    record, launches, seconds = {}, dict.fromkeys(counters, 0), {}

    def add(run, part):
        for name in launches:
            launches[name] += run[name]
        seconds[part] = time.perf_counter() - t0 - sum(seconds.values())

    model = seeded_model({**yaml_model_load(OBB_CFG), "nc": OBB_NC}, SEED)
    record["params"] = sum(p.numel() for p in model.parameters())
    check(model.stride == (8, 16, 32) and type(model).__name__ == "OBBModel" and model.nc == OBB_NC,
          f"{OBB_CFG}: {type(model).__name__}, strides {model.stride}, nc {model.nc}")
    log(f"model {OBB_CFG} scale n: {record['params']} params, strides {model.stride}, nc {model.nc}, seeded weights")
    record["served"], k7, run = obb_served(model, images, counters, card)
    add(run, "served")
    served_ckpt = save_checkpoint(root / "obb_seeded.pt", model)
    del model
    torch.cuda.empty_cache()
    data = make_synthetic_task_dataset(root / "obb", "obb", n_train=LOOP_TRAIN, n_val=LOOP_VAL, imgsz=IMGSZ,
                                       seed=SEED)
    add(dict.fromkeys(counters, 0), "dataset")
    model = seeded_model({**yaml_model_load(OBB_CFG), "nc": OBB_DATA_NC}, SEED)
    record["validated"], run = obb_validated(model, data, counters, card)
    add(run, "validated")
    log(f"obb validated: {record['validated']['images']} images, mAP50 {record['validated']['stats']['mAP50']:.4f}, "
        f"{record['validated']['img_per_s']:.2f} img/s, {card}")
    state = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    cfg = dict(model.yaml)
    del model
    batches = [seeded_obb_batch(CMP_BATCH, CMP_IMGSZ, SEED + 70 + i) for i in range(BF16_CMP_STEPS)]
    record["cpu_comparison"] = compare_train_cpu(state, batches[0], cfg=cfg, n_ldconv=0, n_scalseq=0, n_sppf=1)
    log(f"obb training CPU comparison: {json.dumps(record['cpu_comparison'])}")
    record["cpu_comparison_bf16"] = compare_train_cpu_bf16(state, batches, cfg=cfg)
    log(f"obb bf16 training CPU comparison: {json.dumps(record['cpu_comparison_bf16'])}")
    add(dict.fromkeys(counters, 0), "steps against the CPU")
    # the obb branch of the loss takes the detect maps in f32 (JAX engine/trainer.py:476-482): K1 and its backward
    # run their f32 forms in a bf16 step; validation decodes the bf16 model's maps
    loop, run = facade_epoch(OBB_CFG, lambda steps, val: dict(dfl_decode=steps, dfl_decode_bwd=3 * steps,
                                                               dfl_decode_bf16=val, nms_rotated_suppress=val),
                             data, root, counters, card, nc=OBB_DATA_NC)
    add(run, "facade epoch")
    record["facade_train"] = loop
    check(all(k in loop["last_epoch_metrics"] for k in ("mAP50", "fitness")),
          f"the obb epoch's validation: {loop['last_epoch_metrics']}")
    check(set(loop["losses"][0]) == {"box", "cls", "dfl"}, f"the obb epoch's losses {loop['losses']}")
    log(f"{OBB_CFG} facade: YOLO(...).train() 1 epoch: {loop['loop_img_per_s']:.2f} img/s over the loop "
        f"({loop['train_dtype']}), val {json.dumps(loop['last_epoch_metrics'])}, {card}")
    reloaded = YOLO(str(Path(loop["weights"]) / "last.pt")).model
    check(type(reloaded).__name__ == "OBBModel", f"last.pt reloaded as {type(reloaded).__name__}")
    record["facade_train"]["last_pt_reloads_as"] = type(reloaded).__name__
    del reloaded
    record["server"], run = obb_server(served_ckpt, root, images, counters, card)
    add(run, "server")
    record["seconds"], record["part_seconds"] = time.perf_counter() - t0, seconds
    record["card"] = card
    log(f"phase 33 took {record['seconds']:.1f} s ({json.dumps({k: round(v, 1) for k, v in seconds.items()})}), "
        f"{card}")
    return record, k7, launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    pkg = ROOT / "experiment_yolo_torch" / "__init__.py"
    if not pkg.exists():
        fail(f"{pkg.parent} is missing: run from the root of a checkout")
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:] == ["--k4-device-ms"]:
        return k4_device_ms_main()
    if sys.argv[1:] == ["--k4-bwd-device-ms"]:
        return k4_bwd_device_ms_main()

    import experiment_yolo_torch
    from experiment_yolo_torch.engine.trainer import DetectionTrainer
    from experiment_yolo_torch.ops.kernels import (_build, dfl_decode, ldconv_gather, nms_rotated, nms_suppress,
                                                   selective_scan, soft_nms)
    from experiment_yolo_torch.utils.seeded import (VAL_CONF, letterboxed, model_input, seeded_batch, seeded_images,
                                                    seeded_model)

    check(Path(experiment_yolo_torch.__file__).resolve() == pkg.resolve(), "imported a package other than the checkout's")
    counters = {"dfl_decode": dfl_decode.dfl_decode, "dfl_decode_bwd": dfl_decode.dfl_decode_bwd,
                "nms_suppress": nms_suppress.nms_suppress, "ldconv_gather": ldconv_gather.ldconv_gather,
                "ldconv_gather_bwd": ldconv_gather.ldconv_gather_bwd,
                "selective_scan": selective_scan.selective_scan,
                "selective_scan_bwd": selective_scan.selective_scan_bwd, "soft_nms": soft_nms.soft_nms,
                "dfl_decode_bf16": dfl_decode.dfl_decode_bf16, "dfl_decode_bwd_bf16": dfl_decode.dfl_decode_bwd_bf16,
                "ldconv_gather_bf16": ldconv_gather.ldconv_gather_bf16,
                "ldconv_gather_bwd_bf16": ldconv_gather.ldconv_gather_bwd_bf16,
                "nms_rotated_suppress": nms_rotated.nms_rotated_suppress}

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")

    # 2. full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False")

    # 3. build
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"built {', '.join(_build.KERNELS)} (kernels {', '.join(counters)}) for sm_90a in {secs:.2f} s "
        "(nvcc, one process per source, in parallel)")
    for name, out in _build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    def logged_model(cfg):
        model = seeded_model(cfg, SEED)
        log(f"model {cfg} scale n: {sum(p.numel() for p in model.parameters())} params, strides {model.stride}, "
            f"seeded weights (PyTorch init from seed {SEED}, conv weights redrawn He-normal from seed {SEED + 1}), "
            "Detect class-bias priors set to 0")
        return model

    # 4. model and the main path's kernel inputs
    model = logged_model(CFG)
    images = seeded_images(N_IMAGES, SEED)
    x = model_input(letterboxed(images[:BATCH], IMGSZ), "cuda")
    feats, ld, serve_pool = capture_inputs(model, x)
    check(len(ld) == 10, f"expected 10 LDConv layers on the path, found {len(ld)}")

    # 5. each kernel against its plain version, and timed
    rand_ld = random_offsets(ld)
    kernels = [check_k1(feats), check_k2(serve_pool[0], serve_pool[2]), check_k3(ld, rand_ld)]
    for k in kernels:
        log(f"{k['name']}: max abs err {k['max_abs_err']}, kernel {k['ms']:.4f} ms (device {k['device_ms']} ms), "
            f"plain {k['plain_ms']:.4f} ms, library {k['library_ms']} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']})")
    log(f"  K2 bound: {kernels[1]['bound_assumption']}: {kernels[1]['bound_parts']}; the earlier design's own "
        f"bound {kernels[1]['old_design_bound_ms']:.4f} ms ({kernels[1]['old_design_bound_assumption']})")
    for label, row in kernels[1]["made_up"].items():
        log(f"  K2 {label}: {row}")
    log(f"  K3 library device ms {kernels[2]['library_device_ms']}, random offsets: {kernels[2]['random_offsets']}")
    for row in kernels[2]["layers"]:
        log(f"  K3 layer {row}")

    # 6. the main path: DetectionPredictor, soft then hard NMS, one batch per call
    served, launches = serve_timed(model, images, counters, {"dfl_decode": 1, "ldconv_gather": 10},
                                   card, CFG)
    # 7. the same batch through the same weights on the CPU, plain versions only
    compare = compare_serving_cpu(CFG, model, x)
    log(f"CPU comparison: {json.dumps(compare)}")

    # 8. the val main path: DetectionValidator, soft-NMS in quirk mode then hard; K5 against its plain version
    vbatches = val_batches(model.nc)
    validated, run = validate_timed(model, vbatches, counters, card)
    for name in launches:
        launches[name] += run[name]
    pools, validated["k5_vs_plain_loop"] = val_pools_and_plain_stats(model, vbatches)
    # the serving path's soft-NMS pool (the predictor's defaults: no quirk)
    k5 = check_k5(pools, serve_pool)
    del pools, serve_pool
    log(f"soft_nms: max abs err {k5['max_abs_err']} ({k5['rel_err']} relative on kept scores), kernel "
        f"{k5['ms']:.4f} ms (device {k5['device_ms']} ms) on {k5['timed_on']}, plain {k5['plain_ms']:.4f} ms, "
        f"library none, bound {k5['bound_ms']:.4f} ms ({k5['bound_by']}: {k5['bound_assumption']}: "
        f"{k5['bound_parts']})")
    log(f"  K5 val stats with K5 and with the plain loop: {json.dumps(validated['k5_vs_plain_loop'])}")
    for label, row in (*k5["main_path_pools"].items(), *k5["made_up"].items()):
        log(f"  K5 {label}: {row}")
    log(f"  K5 serving pool: {k5['serving_pool']}")

    # 9. the backward kernels on one training step's inputs
    trainer = DetectionTrainer(model, {"amp": False, "batch": BATCH, "imgsz": IMGSZ})
    batches = [seeded_batch(BATCH, IMGSZ, SEED + 10 + i, nc=model.nc) for i in range(TRAIN_BATCHES)]
    ld_train, levels = capture_train_inputs(trainer, batches[0])
    bwd = [check_k1_bwd(levels), check_k3_bwd(ld_train, rand_ld)]
    for k in bwd:
        log(f"{k['name']}: max abs err {k['max_abs_err']} ({k['rel_err']} of the largest plain value), kernel "
            f"{k['ms']:.4f} ms (device {k['device_ms']} ms), plain {k['plain_ms']:.4f} ms, library {k['library_ms']} "
            f"ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']})")
    log(f"  K3 bwd main path {bwd[1]['main_path']}, random offsets {bwd[1]['random_offsets']}, contention offsets "
        f"{bwd[1]['contention_offsets']}, others {bwd[1]['other_offsets']}; device ms count "
        f"{bwd[1]['device_ms_counts']}")
    log(f"  K3 bwd contention offsets against the plain version summed in float64 (reported; the gate is "
        f"{BWD_RTOL} against float32): {json.dumps(bwd[1]['contention_vs_float64'])}")
    log(f"  K3 forward at imgsz {RAGGED_IMGSZ}: {bwd[1]['forward_at_ragged_imgsz']}")
    for row in bwd[1]["layers"]:
        log(f"  K3 bwd layer {row}")
    kernels = [kernels[0], bwd[0], kernels[1], kernels[2], bwd[1]]

    # 10. the training main path: DetectionTrainer.train_step, one batch per call
    step_ms, run, last, moved, ema_moved = train_timed(trainer, batches, counters)
    want = dict.fromkeys(counters, 0)
    want.update(dfl_decode=TRAIN_STEPS, dfl_decode_bwd=3 * TRAIN_STEPS, ldconv_gather=10 * TRAIN_STEPS,
                ldconv_gather_bwd=10 * TRAIN_STEPS)
    check(run == want, f"the training steps launched {run}, expected {want}")
    for name in launches:
        launches[name] += run[name]
    median_ms = statistics.median(step_ms)
    opt = trainer.state.optimizer
    trained = {"steps": TRAIN_STEPS, "warmup_steps": TRAIN_WARMUP, "batch": BATCH, "imgsz": IMGSZ, "dtype": "float32",
               "step_ms_median": median_ms, "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
               "step_ms_p10_p90": statistics.quantiles(step_ms, n=10)[::8], "img_per_s_at_median": BATCH / median_ms * 1e3,
               "launches": run, "updates_fired": opt.updates, "micro_batches": trainer.state.step,
               "accumulate": trainer.accumulate, "last_losses": last, "params_moved": moved, "ema_moved": ema_moved,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"trained: {TRAIN_STEPS} steps of {BATCH} at {IMGSZ}: median {median_ms:.2f} ms per step (min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}), {trained['img_per_s_at_median']:.2f} img/s at the median, "
        f"launches {run}, {opt.updates} updates over {trainer.state.step} micro-batches, {card}")

    # 11. one training step on the card and on the CPU, same weights and batch, CIoU and the paper's recipe
    cmp_batches = [seeded_batch(CMP_BATCH, CMP_IMGSZ, SEED + 20 + i, nc=model.nc) for i in range(BF16_CMP_STEPS)]
    cmp_batch = cmp_batches[0]
    cmp_state = {k: v.cpu() for k, v in model.state_dict().items()}
    trained["cpu_comparison"] = compare_train_cpu(cmp_state, cmp_batch)
    log(f"training CPU comparison: {json.dumps(trained['cpu_comparison'])}")
    trained["cpu_comparison_recipe"] = compare_train_cpu(cmp_state, cmp_batch, RECIPE)
    log(f"training CPU comparison with the recipe: {json.dumps(trained['cpu_comparison_recipe'])}")
    del trainer, model, ld, ld_train, rand_ld, levels, feats
    torch.cuda.empty_cache()

    # 12. the dataset-driven main path: a synthetic dataset, train() with per-epoch validation, reload, resume
    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=ROOT / "build")  # phase 12's dataset, phase 15's detector: up to 25
    with contextlib.nullcontext(work.name) as tmp:
        loop, run = trained_loop(Path(tmp), counters, card)
        for name in launches:
            launches[name] += run[name]
        log(f"trained loop: {LOOP_EPOCHS} epochs of {LOOP_TRAIN // BATCH} steps, {loop['loop_img_per_s']:.2f} img/s "
            f"over the whole loop, per epoch {[round(e['img_per_s'], 2) for e in loop['epochs_detail']]} img/s, wait "
            f"share {[round(e['wait_share'], 3) for e in loop['epochs_detail']]}, loader alone "
            f"{loop['loader_alone_ms_per_batch']}, resumed to {loop['resumed_epochs_run']} epochs, {card}")
        torch.cuda.empty_cache()

        # 13. the bf16 forms of K1 and K3 against their plain versions, on a bf16 forward's and step's inputs
        model16 = seeded_model(CFG, SEED)
        trainer16 = DetectionTrainer(model16, {"batch": BATCH, "imgsz": IMGSZ})  # amp: the default, bf16
        check(model16.dtype == torch.bfloat16, f"DetectionTrainer's defaults left the model in {model16.dtype}")
        model16.eval()
        feats16, ld16 = capture_bf16_inputs(model16, x)
        model16.train()
        ld_train16, levels16 = capture_train_inputs(trainer16, batches[0])
        bf16_rows = check_bf16_forms(feats16, ld16, ld_train16, levels16)
        del feats16, ld16, ld_train16, levels16
        for k in bf16_rows:
            log(f"{k['name']}: max abs err {k['max_abs_err']}, kernel {k['ms']:.4f} ms (device {k['device_ms']} ms), "
                f"plain {k['plain_ms']:.4f} ms, library {k['library_ms']} ms, bound {k['bound_ms']:.4f} ms "
                f"({k['bound_by']})")
        log(f"  K3 bf16 bit-equal on {bf16_rows[2]['bit_equal_on']}; backward by kind "
            f"{json.dumps(bf16_rows[3]['by_kind'])}")
        for label, row in [("K3 bf16", r) for r in bf16_rows[2]["layers"]] + [("K3 bwd bf16", r)
                                                                            for r in bf16_rows[3]["layers"]]:
            log(f"  {label} layer {row}")

        # 14. the bf16 training main path: train_step with the defaults; the card's bf16 step against the CPU's
        step_ms16, run, last16, moved16, ema_moved16 = train_timed(trainer16, batches, counters)
        want = dict.fromkeys(counters, 0)
        want.update(dfl_decode_bf16=TRAIN_STEPS, dfl_decode_bwd_bf16=3 * TRAIN_STEPS,
                    ldconv_gather_bf16=10 * TRAIN_STEPS, ldconv_gather_bwd_bf16=10 * TRAIN_STEPS)
        check(run == want, f"the bf16 training steps launched {run}, expected {want}")
        for name in launches:
            launches[name] += run[name]
        median16 = statistics.median(step_ms16)
        trained_bf16 = {"steps": TRAIN_STEPS, "warmup_steps": TRAIN_WARMUP, "batch": BATCH, "imgsz": IMGSZ,
                        "dtype": "bfloat16", "step_ms_median": median16, "step_ms_min": min(step_ms16),
                        "step_ms_max": max(step_ms16), "step_ms_p10_p90": statistics.quantiles(step_ms16, n=10)[::8],
                        "img_per_s_at_median": BATCH / median16 * 1e3,
                        "f32_img_per_s_at_median_same_run": trained["img_per_s_at_median"], "launches": run,
                        "last_losses": last16, "params_moved": moved16, "ema_moved": ema_moved16,
                        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del trainer16, model16
        trained_bf16["cpu_comparison"] = compare_train_cpu_bf16(cmp_state, cmp_batches)
        amp_trainer = DetectionTrainer(seeded_model(CFG, SEED), {"batch": BATCH, "imgsz": IMGSZ})
        amp_trainer._check_amp()
        check(amp_trainer.amp_check["passed"] and amp_trainer.dtype == torch.bfloat16,
              f"_check_amp did not pass on {CFG}: {amp_trainer.amp_check}")
        trained_bf16["amp_check"] = amp_trainer.amp_check
        del amp_trainer
        log(f"trained bf16: {TRAIN_STEPS} steps of {BATCH} at {IMGSZ}: median {median16:.2f} ms per step, "
            f"{trained_bf16['img_per_s_at_median']:.2f} img/s at the median (f32 {trained['img_per_s_at_median']:.2f} "
            f"in this run), launches {run}, CPU comparison {json.dumps(trained_bf16['cpu_comparison'])}, AMP check "
            f"{trained_bf16['amp_check']}, {card}")
        torch.cuda.empty_cache()

        # 15. the facade with the defaults: YOLO(...).train(), .val(), .predict(), YOLO(best.pt)
        data = Path(tmp) / "data" / "data.yaml"
        yolo, best, detector, facade, run = facade_phase(data, Path(tmp), counters, card)
        for name in launches:
            launches[name] += run[name]
        log(f"facade: YOLO({CFG!r}, nc={LOOP_NC}).train(): {facade['loop_img_per_s']:.2f} img/s over the loop "
            f"({facade['train_dtype']}, AMP check {facade['amp_check']}), val {facade['val_after_train']}, {card}")
        # 16. the CLI in a fresh process
        cli = cli_phase(best, detector, data)
        log(f"CLI: {json.dumps(cli)}")
        del yolo
        torch.cuda.empty_cache()
        # 17. the HTTP server
        server, run = server_phase(Path(tmp), images, counters, card)
        for name in launches:
            launches[name] += run[name]
        log(f"server: 16 requests from 4 threads in {server['health']['batching']['batches']} batches, median "
            f"latency {server['latency_ms_median']:.2f} ms, {card}")
    torch.cuda.empty_cache()

    # 18. the VSS detector and the scan inputs of one forward
    vss = logged_model(VSS_CFG)
    _, calls = capture_scan_inputs(vss, x)
    check(len(calls) == 10, f"expected 10 VSS blocks on the path, found {len(calls)} scan calls")

    # 19. K4 against its plain version, and timed; its device time again from a fresh process
    k4 = check_k4(calls)
    del calls
    k4["device_ms_in_process"], k4["device_ms"] = k4["device_ms"], k4_device_ms_fresh()
    log(f"selective_scan: max abs err {k4['max_abs_err']} ({k4['rel_err']} of a direction's largest plain value), "
        f"kernel {k4['ms']:.4f} ms (device {k4['device_ms']} ms) for one forward's {k4['launches_per_forward']} "
        f"launches ({k4['scans_per_forward']} scans), plain {k4['plain_ms']:.1f} ms (median of {k4['plain_runs']}), "
        f"library none, bound {k4['bound_ms']:.4f} ms ({k4['bound_by']})")
    for row in k4["levels"]:
        log(f"  K4 level {row}")
    log(f"  K4 ragged {k4['ragged']}")
    kernels += [k4, k5, *bf16_rows]

    # 20. the VSS main path: DetectionPredictor, soft then hard NMS
    served_vss, run = serve_timed(vss, images, counters, {"dfl_decode": 1,
                                                          "selective_scan": k4["launches_per_forward"]}, card, VSS_CFG)
    for name in launches:
        launches[name] += run[name]
    # 21. a smaller batch through the same weights on the CPU, plain versions only
    compare_vss = compare_serving_cpu(VSS_CFG, vss, x[:VSS_CMP_BATCH])
    log(f"VSS CPU comparison: {json.dumps(compare_vss)}")
    vss_state = {k: v.cpu().clone() for k, v in vss.state_dict().items()}
    del vss

    # 22. the plain-Conv configs: one batch each
    plain_conv = {}
    for cfg, strides in PLAIN_CONV_CFGS.items():
        m = logged_model(cfg)
        with torch.no_grad():
            maps = m(x)
        check(m.stride == strides, f"{cfg}: strides {m.stride}, expected {strides}")
        check([tuple(f.shape) for f in maps] == [(BATCH, m.nc + 4 * m.reg_max, IMGSZ // s, IMGSZ // s) for s in strides],
              f"{cfg}: raw map shapes {[tuple(f.shape) for f in maps]}")
        check(all(bool(torch.isfinite(f).all()) for f in maps), f"{cfg}: non-finite raw maps")
        plain_conv[cfg] = {"strides": list(m.stride), "params": sum(p.numel() for p in m.parameters()),
                           "map_abs_max": max(f.abs().max().item() for f in maps)}
    log(f"plain-Conv configs: {json.dumps(plain_conv)}")

    # 23. yolov8-ASF-P2.yaml served: K1 on its four levels, the predictor, the CPU
    asf = logged_model(ASF_CFG)
    check(asf.stride == ASF_STRIDES, f"{ASF_CFG}: strides {asf.stride}, expected {ASF_STRIDES}")
    asf_state = {k: v.cpu().clone() for k, v in asf.state_dict().items()}
    asf_params = sum(p.numel() for p in asf.parameters())
    asf_p2, run = asf_served(asf, images, x, counters, card)
    for name in launches:
        launches[name] += run[name]
    del asf
    torch.cuda.empty_cache()
    # 24. yolov8-ASF-P2.yaml trained: K1's backward on four levels, bf16 steps, an f32 step against the CPU, train()
    part, run = asf_trained(asf_state, batches, cmp_batches[0], Path(work.name) / "data" / "data.yaml",
                            Path(work.name), counters, card)
    asf_p2.update(part, cfg=ASF_CFG, params=asf_params, strides=list(ASF_STRIDES), card=card)
    for name in launches:
        launches[name] += run[name]
    torch.cuda.empty_cache()
    # 25. the paper's two-stage inference on LD-P2: double_predict and sliced_predict, then the CPU
    two_stage, run = two_stage_phase(detector, images, counters, card)
    for name in launches:
        launches[name] += run[name]
    torch.cuda.empty_cache()
    # 26. the VSS family trained: K4 against float64, K4's backward, f32 and bf16 steps, the CPU, YOLO(...).train()
    vss_record, k4_bwd, run = vss_trained(vss_state, batches, Path(work.name) / "data" / "data.yaml",
                                          Path(work.name), counters, card)
    for name in launches:
        launches[name] += run[name]
    kernels.insert(kernels.index(k4) + 1, k4_bwd)
    torch.cuda.empty_cache()
    # 27. the training recipe's switches: R1 and R2 on the card and the CPU, then YOLO(...).train() with auto
    recipes, run = recipes_phase(cmp_state, cmp_batches, Path(work.name) / "data" / "data.yaml", Path(work.name),
                                 counters, card)
    for name in launches:
        launches[name] += run[name]
    log(f"recipes: R1 {json.dumps(recipes['recipes']['R1']['steps'])}, "
        f"R2 {json.dumps(recipes['recipes']['R2']['steps'])}, auto epoch "
        f"{recipes['auto_epoch']['loop_img_per_s']:.2f} img/s ({recipes['auto_epoch']['optimizer']}), "
        f"{recipes['seconds']:.1f} s, {card}")
    torch.cuda.empty_cache()
    # 28. the other configs: yolov8-aux.yaml (DetectAux) and yolov8-lafiyolo.yaml (MBConv), served and trained
    other, run = other_configs_phase(images, x, batches, cmp_batches[0], Path(work.name) / "data" / "data.yaml",
                                     Path(work.name), counters, card)
    for name in launches:
        launches[name] += run[name]
    torch.cuda.empty_cache()
    # 29. the user's own images: the codec held to cv2's arrays, predict on a folder of JPEGs, the server, train()
    images_in, run = image_input_phase(Path(work.name), Path(work.name) / "data" / "data.yaml",
                                       facade["loop_img_per_s"], counters, card)
    for name in launches:
        launches[name] += run[name]
    torch.cuda.empty_cache()
    # 30. C2f_LDConv (K3 and its backward at stride 1), then the segmentation family served, validated and trained
    seg, run = seg_phase(images, Path(work.name), counters, card)
    for name in launches:
        launches[name] += run[name]
    torch.cuda.empty_cache()
    # 31. the pose family served, validated, trained (the head rebuilt to the dataset's 5 x 3) and served over HTTP
    pose, run = pose_phase(images, Path(work.name), counters, card)
    for name in launches:
        launches[name] += run[name]
    torch.cuda.empty_cache()
    # 32. the fork's significance experiment on the card, twice (the second reuses both runs)
    experiment, run = experiment_phase(Path(work.name) / "experiment", counters, card)
    for name in launches:
        launches[name] += run[name]
    torch.cuda.empty_cache()
    # 33. the oriented-box family at DOTA's 1024: served with K7, validated, trained, served over HTTP
    obb, k7, run = obb_phase(images, Path(work.name), counters, card)
    for name in launches:
        launches[name] += run[name]
    kernels.insert(kernels.index(k5) + 1, k7)
    work.cleanup()

    # 34. the result lines
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["kernel_ms"] = k["ms"]
        check(k["launches"] > 0, f"{k['name']} was launched no time on a main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "kernel_ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernel_detail": [{k: v for k, v in kern.items() if k not in keys or k == "name"}
                                      for kern in kernels]}))
    log(json.dumps({"served": served, "cpu_comparison": compare, "imgsz": IMGSZ, "batch": BATCH, "dtype": "float32",
                    "card": card}))
    log(json.dumps({"trained": trained, "card": card}))
    log(json.dumps({"served_vss": served_vss, "cpu_comparison": compare_vss, "plain_conv_configs": plain_conv,
                    "cfg": VSS_CFG, "imgsz": IMGSZ, "batch": BATCH, "dtype": "float32", "card": card}))
    log(json.dumps({"validated": validated, "cfg": CFG, "imgsz": IMGSZ, "batch": BATCH, "conf": VAL_CONF,
                    "dtype": "float32", "card": card}))
    log(json.dumps({"trained_loop": loop}))
    log(json.dumps({"trained_bf16": trained_bf16, "card": card}))
    log(json.dumps({"facade": facade, "cli": cli, "server": server}))
    log(json.dumps({"asf_p2": asf_p2}))
    log(json.dumps({"two_stage": two_stage}))
    log(json.dumps({"vss_trained": vss_record}))
    log(json.dumps({"recipes": recipes}))
    log(json.dumps({"other_configs": other}))
    log(json.dumps({"image_input": images_in}))
    log(json.dumps({"segmentation_and_c2f_ldconv": seg}))
    log(json.dumps({"pose": pose}))
    log(json.dumps({"experiment": experiment}))
    log(json.dumps({"obb": obb}))
    # last of the long lines, so that a reader of the output's tail gets it whole
    log(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    log(f"card: {card}")
    log(f"total seconds after the card check: {time.perf_counter() - t0:.1f}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
