#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``spsnet_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase3 ROOT   # phases 1-3 of another checkout
    python3 chip_smoke.py --jitter-study  # what sets phase 26's baseline
    python3 chip_smoke.py --fault-check   # phases 26, 36, 44, 55, 61, 64
                                          # refuse a scaled card gradient
    python3 chip_smoke.py --fault-check pvrcnnpp  # phase 55 alone (or any
                                          # of pointrcnn,pvrcnn,voxel_rcnn,
                                          # centerpoint_pillar,
                                          # centerpoint_dyn_pillar)
    python3 chip_smoke.py --pvpp-train-repeat N  # phase 54's steps N times
                                          # under each gt at the proposals

Phases, in order; any failure raises and the exit code is not 0:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the CUDA kernels from ``spsnet_torch/csrc`` (seconds printed) and
   print ptxas's registers, shared memory and spills of the FPS,
   ball-query and min-distance kernels;
3. each kernel against its plain PyTorch version on the card, index for
   index (and bit for bit on distances), at the main paths' shapes: FPS at
   (8, 16384) -> 4096, at (1, 16384) -> 4096 and at sizes that are no
   multiple of 1024 (with a mask, up to N = 65536), with its time a step,
   its cluster size and CTA width; the prefix-nesting identity FPS(layer-0
   chain, 1024) == arange(1024); the fused ball query at every SA layer
   with radii, on the centers the path produces, with the centers a warp
   (W) its rule takes; the seeded D-FPS kernels (min distance to the
   seeds, seeded FPS) at the train path's two layers, (4, 16384) ->
   4096 from 3072 grid seeds and (4, 4096) -> 1024 from 768, plus head
   seeds and an N that is no multiple of 128, with the min-distance
   launch's shape (CTAs a cluster, points a thread, CTAs), and that
   kernel alone at the edges of its tiling (one seed, a seed past a
   cluster share, k0 no multiple of 4, one point, a point past a tile,
   seeds that are points); the experimental FPS entries at the four K5
   shapes. Times are CUDA events, median of repeated runs; then the device
   time of one call (``torch.profiler``, median kernel duration) of K1,
   K3, K4 and K2 at the paths' shapes and of the two experimental entries
   at the K5 shapes;
4. the serving path: IA-SSD KITTI (``tools/cfgs/kitti_models/IA-SSD.yaml``)
   at full width with seeded random weights serves five requests of
   8 x 16384 points through forward + class-agnostic NMS, with exact FPS
   (the default); outputs must be finite with counts in [0, 500], and the
   launch counters, zeroed just before, must show one FPS and four
   ball-query launches per forward and no seeded-FPS launch;
5. one scene through the same weights on the CPU, where the plain versions
   run: FPS, sampled points and ball-query indices identical (the CPU
   replays the card's ctr_aware picks once they check out as a top-k order
   of its own scores), predictions within the tolerance stated below, NMS
   outputs identical;
6. a CUDA-kernel breakdown of one request from ``torch.profiler``;
7. the train path: the same model with grid-seeded D-FPS
   (``FpsSeeding(0.75, 'grid')``) takes ten ``adam_onecycle`` steps of
   4 x 16384-point synthetic scenes with gt boxes; loss and gradients must
   be finite, every parameter must move, and the counters must show per
   step two seed_min, two fps_seeded and four ball-query launches and no
   exact FPS;
8. one train step on one scene on the card and on the CPU from the same
   weights: seeded D-FPS picks identical, loss terms within the tolerance
   stated below, gradients and updated parameters within a stated factor
   of what a 1e-6 jitter of the weights does to the CPU's own step and
   within fixed ceilings;
9. a CUDA-kernel breakdown of one train step and the card's busy share;
10. the SPSNet serving path: ``tools/cfgs/kitti_models/SPSNet.yaml`` at
    full width (the frozen stability model, the deletion of 500 points a
    scene, the PAGNet backbone with surface features and sss_aware
    sampling, the MLT head) with seeded random weights serves five
    requests of 8 x 16384 synthetic scenes with gt boxes through
    ``make_stability_preprocess`` + ``make_eval_step``; outputs finite,
    counts in [0, 500], 15884 points kept a scene, and per forward one FPS
    and six ball-query launches (stability SA, surface graph, SA layers 0,
    1, 2 and 5) and no other kernel;
11. one SPSNet scene on the card and on the CPU with the same weights: stds
    within the tolerance stated below, the foreground, FPS, ball-query and
    surface-graph indices identical, the deletion identical or, where
    near-equal stds order differently, replayed (as the sss_aware picks
    are, like phase 5's ctr_aware picks), predictions within tolerance, NMS
    outputs identical;
12. a CUDA-kernel breakdown of one SPSNet request;
13. the experimental FPS entries (the counterparts of the JAX package's
    K5a-c), ``farthest_point_sample_batched`` and
    ``farthest_point_sample_hier_argmax``, called at the four K5 shapes
    with the counters zeroed just before: each call launches the exact FPS
    kernel once and nothing else;
14. the SPSNet train path: SPSNet.yaml at full width with seeded random
    weights (the frozen stability model as in phase 10) and grid-seeded
    D-FPS takes ten ``adam_onecycle`` steps of 4 x 16384-point scenes with
    gt boxes through ``make_train_step(..., preprocess)``; loss and
    gradients finite, every detector parameter moves, the frozen model's
    parameters and buffers bit-unchanged, 15884 points kept a scene, and
    per step two seed_min, two fps_seeded and six ball-query launches (the
    stability SA, the surface graph, SA layers 0, 1, 2 and 5) and no exact
    FPS;
15. one SPSNet train step on one scene on the card and on the CPU, as
    phase 8, with the stds within the tolerance stated below and the
    deletion and the sss_aware picks replayed after their order checks;
16. the stability train path: ``tools/cfgs/stability/sf_unc.yaml`` at
    full width (npoint 16384, MSG 0.2 / 0.8, 16 / 32 neighbours, latent 8)
    takes ten steps of 16 x 16384-point scenes with gt boxes through
    ``make_stability_train_step``; loss and gradients finite, every
    parameter moves, one ball-query launch a step and no other kernel; the
    foreground share of the points;
17. one stability train step on one scene on the card and on the CPU, as
    phase 8, with the same latent noise (drawn on the CPU);
18. a CUDA-kernel breakdown of one SPSNet train step and of one stability
    train step;
19. the PointRCNN serving path: ``tools/cfgs/kitti_models/pointrcnn.yaml``
    at full width with seeded random weights (PointNet2MSG with its FP
    decoder, the point head, the proposal NMS at pre 9000 / post 100, RoI
    pooling of 512 points, the RoI head's SA stack, the final NMS with the
    RoIs' labels) serves one warm-up and five requests of 8 x 16384 points
    through ``build_detector`` -> forward -> ``post_processing``; outputs
    finite, counts in [0, 500], and per request six FPS and six ball-query
    launches (SA layers 0-3 and the RoI head's two D-FPS layers) and no
    other kernel;
20. FPS and the ball query vs their plain versions at the PointRCNN
    shapes, on the inputs a request produces: FPS at (8, 4096) -> 1024,
    (8, 1024) -> 256, (8, 256) -> 64 and over the 800 RoI rows, (800, 512)
    -> 128 and (800, 128) -> 32, with empty (all-zero) and padded rows; the
    ball query at the four MSG layers and the two RoI layers; the four FP
    layers' three-NN calls (K6) bit for bit (``three_nn_call``); and
    chunked FPS, 4 slices of (8, 16384) -> 4096, one launch;
21. one PointRCNN scene on the card and on the CPU, stage by stage from the
    card's inputs: FPS, ball-query and three-NN indices identical, point
    features and predictions within the tolerance stated below, proposal
    and final NMS indices identical or the card's a greedy NMS of the CPU's
    IoUs within NMS_IOU_TOL, pooled points identical, the RoI stage's
    picks identical and its outputs within tolerance;
22. a CUDA-kernel breakdown of one PointRCNN request and of its proposal
    NMS alone (time and launches);
23. a Waymo IA-SSD request path (``waymo_models/IA-SSD.yaml``, 2 x 65536
    points of 5 channels in Waymo's range) and a nuScenes one
    (``nuscenes_models/IA-SSD.yaml``, 2 x 20480 of 4 channels, 10 classes),
    one warm-up and two requests each, one FPS and four ball-query
    launches a forward, their layer-0 FPS ((2, 65536) -> 16384, the FPS
    kernel's largest N, and (2, 20480) -> 8192) and ball queries held to
    the plain versions;
24. the PointRCNN train path: pointrcnn.yaml at full width with the
    weights of phase 19 (seed 0, the point-box output at 1e-2) in train
    mode takes a warm-up and ten ``adam_onecycle`` steps of 2 x 16384-point
    synthetic scenes with gt boxes through ``make_train_step`` (proposal
    NMS at pre 9000 / post 512 / 0.8, 128 sampled RoIs a scene with their
    draws from the step's CPU generator, 512 pooled points a RoI, both
    stages' losses); losses and gradients finite, every parameter moves,
    six FPS and six ball-query launches a step and no other kernel; each
    step's grad norm, proposal-NMS time, fg / hard / easy RoIs and the
    share of RoIs with a pooled point; the share of the point head's
    box-layer gradient that comes through the RoIs, at the seed weights;
25. FPS and the ball query vs their plain versions at the train step's
    shapes: the backbone at (2, 16384) -> 4096 -> 1024 -> 256 -> 64 and
    the RoI layers over 256 rows, (256, 512) -> 128 and (256, 128) -> 32;
    the four FP layers' K6 calls as in phase 20;
26. one PointRCNN train step on one scene on the card and on the CPU with
    the same weights and RoI draws: the backbone's FPS, ball-query and
    three-NN indices identical; the RoI layers' picks identical or, where
    their inputs (the RoIs' frames) differ by rounding, an FPS and a ball
    query of the CPU's points within that rounding, then replayed; the
    proposal NMS as phase 21 holds it; the RoIs' max IoUs, replayed where
    they lie within 1e-5 of a sampling threshold; sampled RoI indices
    identical; loss terms, gradients and parameters as phase 8 holds them,
    each module three names deep within TRAIN_MODULE_CEIL;
27. ``proposal_target_layer`` and ``pointrcnn_head_loss`` card vs CPU on
    RoIs made by jittering gt boxes, so that the regression and corner
    terms are not zero (random-weight proposals seldom reach IoU 0.55),
    and which of the two carried those terms;
28. a CUDA-kernel breakdown of one PointRCNN train step, its proposal
    NMS's time, launches and share of the step;
29. the PV-RCNN serving path: ``tools/cfgs/kitti_models/pv_rcnn.yaml``
    through ``build_detector_from_cfg`` at full width with seeded random
    weights, on batches of synthetic scans of 16384 points voxelized and
    planned by the port's host code (``data.processor.voxel_batch``: 40 000
    voxels of 5 points, the VoxelBackBone8x tables; its ms a frame timed
    apart): a warm-up and ten requests of B = 2 and of B = 8 through
    forward -> ``post_processing`` (MeanVFE, the sparse backbone, the BEV
    map and backbone, the anchor head over 211 200 anchors, 2048 VSA
    keypoints, the point head, the proposal NMS at pre 1024 / post 100 /
    0.7, the RoI-grid head over 100 x 6^3 grid points, the final NMS);
    outputs finite, counts in [0, 500], and per request one FPS and six
    ball-query launches and no other kernel; the kept boxes and the share
    of grid points with a keypoint within each pool radius;
30. FPS and the ball query vs their plain versions at the PV-RCNN shapes,
    on the inputs a request produces: FPS (2, 16384) -> 2048 and (8,
    16384) -> 2048; the ball query of each VSA source (the raw points, N
    16384; the voxel centers of each sparse level, N 40000 with the padded
    ones far away) and of the RoI grid (21 600 centers over 2048
    keypoints);
31. one PV-RCNN request (B = 2) on the card and on the CPU with the same
    weights and host tables, stage by stage from the card's inputs: the
    voxel stack, the BEV map (its scatter bit for bit) and the anchor head
    within the tolerance stated below; the card's 1024 proposal
    candidates a top 1024 of the CPU's scores; the proposal NMS as phase
    21 holds it; the VSA's FPS and ball-query indices identical, its
    features and the point head within tolerance; the RoI-grid picks
    identical or within the rounding slack of their grid points, then
    replayed; the pooled features, the refinement, the decoded boxes and
    the final NMS;
32. SECOND (``second.yaml``) at full width, one warm-up and three
    requests of the same B = 2 voxel batch, no kernel launch;
33. a CUDA-kernel breakdown of one PV-RCNN request: its proposal NMS
    (time, launches, share), the sparse gathers' and the BEV backbone's
    share of the device time; the BEV backbone's time at B = 2 and 8 with
    cuDNN's heuristic and with its timed algorithm choice, each in a child
    process;
34. the PV-RCNN train path: pv_rcnn.yaml at full width with seeded
    random weights (the anchor head's box layer at 1e-2, so that the
    proposals stay near their anchors) in train mode takes a warm-up and
    ten ``adam_onecycle`` steps through ``make_train_step`` of 2 x 16384
    synthetic scenes, each frame turned about z by an angle in [-pi/4,
    pi/4] (the config's ``random_world_rotation``) with its gt boxes of
    classes 1, 2, 3 in turn, voxelized at the train limit (16 000 voxels,
    ``voxel_batch(mode='train')`` with the gt boxes): anchor targets over
    211 200 anchors, 2048 keypoints and their targets, the proposal NMS at
    pre 9000 / post 512 / 0.8, 128 sampled RoIs a frame (their draws and
    the towers' dropout masks from the step's CPU generators), the three
    heads' losses; losses and gradients finite, every parameter moves, one
    FPS and six ball-query launches a step and no other kernel; each
    step's time, grad norm, positive, force-matched and ignored anchors,
    foreground keypoints, fg / hard / easy RoIs and proposal-NMS time; each
    frame's voxels before and after the cap;
35. FPS and the ball query vs their plain versions at the train shapes,
    on the inputs a step produces: FPS (2, 16384) -> 2048, the ball query
    of each VSA source (16 000 voxel rows a level) and of the RoI grid
    (2 x 128 x 6^3 = 55 296 centers over 2048 keypoints);
36. one PV-RCNN train step on one frame on the card and on the CPU with
    the same weights, RoI draws and dropout masks: anchor labels, force
    matches and keypoint labels identical; the two runs' anchor scores
    and direction logits within PV_SCORE_TOL and PV_DIR_LOGIT_TOL, the
    card's 9000 proposal candidates a top 9000 of the CPU's scores within
    PV_SCORE_TOL, direction bins equal where the CPU's two logits lie
    farther apart than PV_DIR_LOGIT_TOL, the proposal NMS as phase 21
    holds it, RoI max IoUs near a sampling threshold replayed, sampled
    RoIs identical, VSA and RoI-grid picks identical or within their
    rounding slack, then replayed; loss terms, gradients, parameters and
    BN running stats as phases 8 and 26 hold them (5x the 1e-6 jitter
    baseline, printed, or the fixed ceilings, the less; each module
    within TRAIN_MODULE_CEIL); the share of ``conv_box``'s gradient that
    comes through the RoIs;
37. the anchor targets and ``anchor_head_loss`` card vs CPU on the train
    gt with random predictions, and ``proposal_target_layer`` and
    ``pointrcnn_head_loss`` at pv_rcnn.yaml's settings on RoIs made by
    jittering gt boxes, so that the regression, corner and direction
    terms are not zero, and which terms phase 34 itself carried;
38. SECOND (second.yaml) at full width in train mode, a warm-up and three
    steps of the phase-34 batches: losses and gradients finite, every
    parameter moves, no kernel launch;
39. a CUDA-kernel breakdown of one PV-RCNN train step: device time,
    launches, busy share, the proposal NMS's host ms, launches and share,
    and the shares of the sparse gathers, the BEV backbone and the
    backward in the device time;
40. the Voxel R-CNN serving path: ``kitti_models/voxel_rcnn_car.yaml``
    through ``build_detector_from_cfg`` at full width with seeded random
    weights on batches of 2 synthetic scans of 16384 points voxelized at
    the test limit (40 000 voxels; each frame's voxels before and after
    the cap printed): a warm-up and ten requests through forward ->
    ``post_processing`` (the anchor head, the proposal NMS at pre 2048 /
    post 100, the voxel RoI-grid pool of 100 x 6^3 grid points over the
    voxel centers of x_conv2-4, the RoI head, the final NMS); outputs
    finite, three ball-query launches a request and no other kernel; ms
    and range, the proposal NMS's share, the grid points' voxel hits, a
    profile (busy share);
41. the ball query vs its plain version at the Voxel R-CNN serving
    shapes: 43 200 grid centers over each 40 000-row level;
42. one Voxel R-CNN request card vs CPU, stage by stage from the card's
    inputs as phase 31 holds PV-RCNN's: the voxel stack, the anchor head
    and the proposal NMS, the RoI-grid picks equal or within the rounding
    slack of their grid points, then replayed, the pooled features, the
    refinement and the final NMS;
43. the Voxel R-CNN train path: voxel_rcnn_car.yaml at full width (the
    anchor box layer at 1e-2) takes a warm-up and ten ``adam_onecycle``
    steps of 2 x 16384 scenes at the train limit (16 000 voxels): anchor
    targets, the proposal NMS at pre 9000 / post 512, 128 sampled RoIs a
    frame (55 296 grid centers), dropout, both heads' losses; three
    ball-query launches a step; a profile; the ball query vs plain at the
    train shapes;
44. one Voxel R-CNN train step card vs CPU as phase 36 holds PV-RCNN's
    (``--fault-check`` also scales a Voxel R-CNN module's gradients);
45. the CenterPoint serving path: ``waymo_models/centerpoint.yaml`` at
    full width (VoxelResBackBone8x, every level padded to 150 000 rows,
    the 188 x 188 BEV map, the CenterHead decode: the top 500 of 106 032
    (pixel, class) pairs, agnostic NMS at 0.7) on 2 Waymo scans of 65 536
    points with 5 channels, a warm-up and five requests; no kernel of the
    port; ms, peak memory, the host plan's ms a frame, each frame's voxels
    before and after the cap, a profile with the sparse and BEV
    backbones' shares;
46. one CenterPoint request (B = 1) card vs CPU stage by stage: the
    sparse levels, the BEV map and backbone, the head's maps within
    tolerance, the card's top-500 candidates a top 500 of the CPU's
    scores within CP_SCORE_TOL and replayed, the NMS as phase 21 holds it,
    the detections;
47. the CenterPoint train path: a warm-up and ten steps over three planned
    batches of 2 Waymo scenes (heatmap targets, focal and L1 losses,
    backward, ``adam_onecycle``); ms and range, peak memory, a profile;
48. one CenterPoint train step card vs CPU on one frame of a cropped range
    (``CP_TRAIN_CUT``): the heatmap targets, centre
    pixels and masks bit for bit, loss terms, gradients, parameters and
    BN statistics as phase 36 holds them;
49. ``waymo_models/voxel_rcnn_with_centerhead_dyn_voxel.yaml``: one
    request of B = 1 after a warm-up, the CenterHead RPN's detections as
    proposals, three ball queries over the 150 000-row levels, each held
    to its plain version;
50. PV-RCNN++ serving: ``waymo_models/pv_rcnn_plusplus.yaml`` at full
    width, a warm-up and five requests of 2 Waymo scans of 65 536 points
    (150 000 rows a level): ms and range, six masked FPS launches (one a
    sector) and six three-NN calls (K6, two launches each: the pre-pass
    and the scan) a request, peak memory, the
    host plan, the valid keypoints and sector quotas a frame, a profile;
51. the kernels at its shapes: each sector's masked FPS against the plain
    one (indices equal; device and plain time, bound; the first sector at
    K = 4096 picks too), each of the VSA's six K6 calls against the plain
    three-NN bit for bit (``three_nn_call``: device time of the pre-pass
    and the scan, the pairs scanned of all pairs from the kernel's
    counter, the rows scanned a batch row, plain time, ``torch.cdist`` +
    ``topk`` over the plain version's blocks, the function's bound, the
    bound over the pairs scanned and over all pairs), their sum, logged
    beside the previous design's recorded 89.335 ms;
52. one PV-RCNN++ request (B = 1) card vs CPU stage by stage: the voxel
    stack, the CenterHead's maps, top-500 and boxes, the proposal NMS, the
    SPC RoI mask and sectors (within their slack, replayed), the keypoints,
    the VSA (its VectorPool sources on the CPU for the first 256
    keypoints), the point head, the RoI head (the cube query within its
    slack, replayed) and the final NMS;
53. ``waymo_models/pv_rcnn_plusplus_resnet.yaml``: one request of B = 1
    after a warm-up, its six K6 calls held to the plain three-NN;
54. the PV-RCNN++ train path: a warm-up and ten steps of 2 Waymo scenes
    over three planned batches (gt at the Waymo sizes plus boxes of those
    sizes at the proposals); ms, the proposal NMS's share, RoI counts, grad norms, peak
    memory, a profile (the sparse backbone, the gathers' backward, K6, K1,
    the VectorPool modules);
55. one PV-RCNN++ train step card vs CPU on one frame of a cropped range
    (``PP_TRAIN_CUT``): heatmap targets and keypoint labels identical,
    every other decision within its slack and replayed, then loss terms,
    gradients, parameters and BN statistics as phase 36 holds them;
56. the kernels line: K6 joins K1-K4's entries; after phases 57-65, one
    JSON line per kernel set (K6 among the kernels, with its launches on
    every path, the pillar paths' none included), then the card's name
    and power limit, then the result line;
57. the PointPillar serving path: ``kitti_models/pointpillar.yaml`` at
    full width on 2 scans of 16384 points (40 000 pillars of 32 slots, the
    496 x 432 map, 321 408 anchors, NMS at pre 4096 / 0.01), the host
    pillars' ms a frame (no sparse plan), a warm-up and ten requests; no
    kernel of the port; ms, peak memory, a profile with the VFE's, the
    scatter's, the BEV backbone's, the head's and the NMS's shares;
58. the PointPillar train path: a warm-up and ten steps over three
    batches of 2 x 16384 at 16 000 pillars (gt as phase 34 makes it:
    anchor targets, ``anchor_head_loss``, backward, ``adam_onecycle``); ms,
    grad norms, peak memory, a profile;
59. CenterPoint over pillars (``waymo_models/centerpoint_pillar_1x.yaml``)
    serving on 2 Waymo scans of 65 536 points (150 000 pillars of 20 slots,
    the 468 x 468 map): five requests, ms, peak memory, a profile;
60. one of its requests (B = 1) card vs CPU stage by stage: PillarVFE's
    features, the scatter of the card's features bit for bit, the BEV
    backbone, the head's maps, top 500 and NMS as phase 46 holds them;
61. its train path (ten steps over three batches of 2 Waymo scenes), then
    one train step card vs CPU on CP_TRAIN_CUT as phase 48 holds it;
62-64. the same for ``centerpoint_dyn_pillar_1x.yaml`` (DynamicPillarVFE
    on the points ``sample_points`` keeps: 65 536): in phase 63 the pillar
    ids, masks and occupied cells identical, the canvas within tolerance
    and the spread of two card calls logged;
65. one request each of ``waymo_models/pointpillar_1x.yaml`` (1 314 144
    anchors at stride 1) and ``nuscenes_models/cbgs_dyn_pp_centerpoint.yaml``
    (B = 1, 65 536 points): finite detections.

The K5 shapes are (8, 16384) -> 4096, (8, 15884) -> 4096 (SPSNet's layer
0), (1, 16384) -> 4096 and (32, 4096) -> 1024. Phase 3 also holds FPS and
the ball query at SPSNet's shapes: FPS at (8, 15884) -> 4096, the ball
query of the stability SA (16384 centers on 16384 points, r 0.2 / 0.8) and
of the surface graph (15884 on 15884, r 0.8, 16 neighbours); and at the
shapes of training: the ball query of the stability train step (16 x
16384 centers), the seeded kernels at SPSNet training's layer 0 ((4,
15884) -> 4096 from 3072 seeds) and S-FPS at (4, 16384) -> 4096 (K1, then
K2 at r 0.05 with 16 neighbours), with the device time of each call.

``--phase3 ROOT`` runs phases 1-3 with the package and the phase functions
of the checkout at ROOT and prints their kernel entries as one JSON line:
run on the parent commit's tree (``git archive`` into an ignored directory)
and on this one in turns within one call, it compares the kernels of two
commits on one card.

Exits non-zero without printing a result when no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM published peaks (dense): fp32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
B, N = 8, 16384
REQUESTS = 5
# card vs CPU on the predictions: both run full fp32 (no TF32); the sums of
# the ~20 Linear layers (K up to 1024) are taken in another order by cuBLAS
# and the CPU BLAS, ~1e-7 relative each, and the box decode's exp() grows
# a relative error of the log-size channels by the size itself
PRED_ATOL, PRED_RTOL = 1e-4, 1e-4
# ctr_aware: the card-vs-CPU difference of one fp32 sigmoid score is a few
# ulps (~2e-7 measured); 1e-5 is far below the spread of a score list
CTR_SCORE_TOL = 1e-5
# the train path: IA-SSD.yaml's batch per card, and its schedule over the
# 3712 KITTI train frames (928 steps an epoch, 80 epochs)
TRAIN_B, TRAIN_STEPS, KITTI_TRAIN_FRAMES = 4, 10, 3712
# card vs CPU after one train step. In training, BatchNorm normalises with
# the batch's own statistics, so its 1/std amplifies the forward's fp32
# differences (the vote centers differ ~20x more than in eval mode), and
# max-pool routes a gradient to another point where two features come
# within that difference. So the gradients are held to what the same CPU
# step gives when every weight is perturbed by WEIGHT_JITTER relative (the
# order of cuBLAS-vs-CPU-BLAS differences over K up to 1024): the card's
# relative L2 difference may be at most TRAIN_GRAD_FACTOR times that, and
# its updated parameters may differ by more than PARAM_ATOL on at most
# TRAIN_GRAD_FACTOR times as many entries. Adam's first update is
# lr * g / (|g| + eps), so an entry whose gradient lies within that
# difference of zero moves by up to 2 lr the other way, never more. Loss
# terms: the forward's differences summed into scalars.
TRAIN_LOSS_RTOL = 1e-3
WEIGHT_JITTER, TRAIN_GRAD_FACTOR, PARAM_ATOL = 1e-6, 5.0, 1e-5
# Each limit also has a fixed ceiling, so that a baseline that rounding
# moves far cannot pass a wrong gradient: the relative L2 of the gradients
# at most TRAIN_GRAD_CEIL, at most TRAIN_BEYOND_CEIL of the parameters
# beyond PARAM_ATOL, the BN running statistics' relative L2 at most
# TRAIN_BN_CEIL. PointRCNN's step (phase 26) is such a case: its RoIs carry
# gradient into the point head's box output layer, whose gradient is 0.97 of
# the step's global norm at the seed weights (336 before the clip to 10;
# 20 with the RoIs detached) and follows the RoI head's max-pool routing,
# and the clip passes each change of that norm to every module. On the CPU
# a jitter of 1e-8 (an ulp of a third of the weights) moves the clipped
# gradients by 0.12 relative, 1e-6 by 0.06-0.25 by seed (0.005 and 0.014
# with the RoIs detached), while the card is 0.016 from the CPU
TRAIN_GRAD_CEIL, TRAIN_BEYOND_CEIL, TRAIN_BN_CEIL = 0.05, 0.02, 1e-5
# the two-stage detectors' gradients also module by module, three names deep
# (a layer of a backbone or a head): each module's relative L2 card vs CPU at
# most TRAIN_MODULE_CEIL, so that a wrong gradient in a module with a small
# share of the global norm shows
TRAIN_MODULE_CEIL = 0.1
# SPSNet: the scenes of a request, and the points a scene keeps after the
# stability hook deletes DELETE_NUMBER (SPSNet.yaml)
SPSNET_REQUESTS, DELETE_NUMBER = 5, 500
KEPT = N - DELETE_NUMBER
# card vs CPU on the stds: a sum of 8 exp(0.5 * logvar) after the stability
# SA's 3-layer MLPs (K up to 64), max-pool, the 64-wide aggregation and a
# Linear, summed in another order by cuBLAS and the CPU BLAS (~1e-7 relative
# each)
STDS_RTOL = 1e-5
# the K5 shapes: IA-SSD's and SPSNet's layer 0, one row, many small rows
K5_SHAPES = ((8, N, 4096), (8, KEPT, 4096), (1, N, 4096), (32, 4096, 1024))
# the stability model's own training (tools/cfgs/stability/sf_unc.yaml):
# 16 scenes a step
STAB_B = 16
# launches a step of each train path: IA-SSD (SA 0, 1, 2, 5), SPSNet (the
# stability SA, the surface graph and SA 0, 1, 2, 5) and the stability model
TRAIN_LAUNCHES = {'fps': 0, 'fps_seeded': 2, 'seed_min': 2, 'ball_query': 4}
SPSNET_TRAIN_LAUNCHES = dict(TRAIN_LAUNCHES, ball_query=6)
STAB_TRAIN_LAUNCHES = {'fps': 0, 'fps_seeded': 0, 'seed_min': 0,
                       'ball_query': 1}
# PointRCNN serving (pointrcnn.yaml) on the IA-SSD requests: per request
# the backbone's four SA layers and the RoI head's two D-FPS layers (its
# third groups all points), and the four FP layers' three-NN (two launches
# each: K6's pre-pass and scan)
PRCNN_LAUNCHES = {'fps': 6, 'ball_query': 6, 'three_nn': 8}
# PointRCNN training (pointrcnn.yaml): BATCH_SIZE_PER_GPU scenes a step, a
# warm-up and the timed steps
PRCNN_TRAIN_B, PRCNN_TRAIN_STEPS = 2, 10
# card vs CPU NMS over the same boxes: IoUs within this of the threshold
# may decide either way (cos and sin of the two devices may differ by an
# ulp, ~1e-7 relative in an IoU)
NMS_IOU_TOL = 1e-5
# Waymo and nuScenes IA-SSD: BATCH_SIZE_PER_GPU 2, each dataset's points
# and channels (Waymo adds elongation; nuScenes.yaml's model reads 4 of its
# 5), one warm-up and two requests; (config, points, channels, data seed)
OTHER_B, OTHER_REQUESTS = 2, 2
WAYMO = ('tools/cfgs/waymo_models/IA-SSD.yaml', 65536, 5, 400)
NUSCENES = ('tools/cfgs/nuscenes_models/IA-SSD.yaml', 20480, 4, 500)
# PV-RCNN serving (pv_rcnn.yaml): BATCH_SIZE_PER_GPU 2 scans a request
# (the requests cycle through PV_BATCHES host batches: the sparse plan
# takes about a second a frame on the host) and one batch of 8, a warm-up
# and PV_REQUESTS timed requests each; per request one FPS launch (the
# VSA's keypoints) and six fused ball queries (the VSA's five sources, the
# RoI grid)
PV_B, PV_B8, PV_REQUESTS, PV_BATCHES = 2, 8, 10, 3
PV_LAUNCHES = {'fps': 1, 'ball_query': 6}
# PV-RCNN training (pv_rcnn.yaml): BATCH_SIZE_PER_GPU 2 scans a step at the
# train voxel limit (16 000), a warm-up and PV_TRAIN_STEPS timed steps, with
# PV_LAUNCHES a step (the VSA's keypoints; its five sources and the RoI grid
# of 128 sampled RoIs a frame); SECOND (second.yaml) on the same batches, a
# warm-up and SECOND_TRAIN_STEPS steps
PV_TRAIN_B, PV_TRAIN_STEPS, SECOND_TRAIN_STEPS = 2, 10, 3
# one PV-RCNN train step card vs CPU: training's batch statistics carry the
# voxel stacks' rounding into the anchor head, whose scores and direction
# logits then lie at most PV_SCORE_TOL and PV_DIR_LOGIT_TOL apart (4.5e-5
# and 3.4e-4 measured on an H100 80GB HBM3 at 700 W); the card's proposal
# candidates must be a top 9000 of the CPU's scores within PV_SCORE_TOL,
# and a direction bin may differ only where the CPU's two logits lie within
# PV_DIR_LOGIT_TOL of each other
PV_SCORE_TOL, PV_DIR_LOGIT_TOL = 2e-4, 1.5e-3
# Voxel R-CNN (voxel_rcnn_car.yaml): serving B = VR_B scans of N points at
# the test voxel limit (40 000), a warm-up and VR_REQUESTS requests cycling
# over VR_BATCHES host batches, three fused ball queries a request (the RoI
# grid of 100 proposals x 6^3 points over the voxel centers of x_conv2-4);
# training at the train limit (16 000), a warm-up and VR_TRAIN_STEPS steps
# of 128 sampled RoIs a frame, the same three launches a step
VR_B, VR_REQUESTS, VR_BATCHES, VR_TRAIN_STEPS = 2, 10, 3, 10
VR_LAUNCHES = {'ball_query': 3}
# CenterPoint (waymo_models/centerpoint.yaml): B = CP_B Waymo scans of
# CP_N points with 5 channels, every sparse level padded to 150 000 rows,
# CP_REQUESTS requests after a warm-up; training a warm-up and
# CP_TRAIN_STEPS steps cycling over CP_TRAIN_BATCHES planned batches (the
# host plan takes seconds a frame at 150 000 rows); no kernel of the port
# runs. The gt of its three classes take the anchor sizes of
# waymo_models/pv_rcnn.yaml (Vehicle, Pedestrian, Cyclist)
CP_B, CP_N, CP_REQUESTS = 2, 65536, 5
CP_TRAIN_STEPS, CP_TRAIN_BATCHES = 10, 3
WAYMO_SIZES = [[4.7, 2.1, 1.7], [0.91, 0.86, 1.73], [1.78, 0.84, 1.78]]
# ``gt_at_proposals``' boxes at the proposals keep the proposal's sizes
# within this factor of their class's size
GT_SIZE_SPAN = 4.0
# card vs CPU, one CenterPoint request: the heatmap scores of the two runs
# (sigmoids after the residual backbone over 150 000 rows, the 5-layer BEV
# backbone and the head's convs) may lie CP_SCORE_TOL apart; the card's
# top 500 candidates must be a top 500 of the CPU's scores within it
CP_SCORE_TOL = 1e-4
# card vs CPU on the voxel stack, the VSA and the RoI head: within 1e-4
# relative plus 1e-4 of each tensor's largest entry (cuBLAS and cuDNN
# against the CPU's sums over K up to 27 x 64 and 9 x 256; the rounding of
# a sum scales with its terms, and an entry near zero may sum large ones)
VOXEL_RTOL, VOXEL_ATOL = 1e-4, 1e-4
# PV-RCNN++ (waymo_models/pv_rcnn_plusplus.yaml): B = PP_B Waymo scans of
# CP_N points, 5 channels, every level padded to 150 000 rows, PP_REQUESTS
# requests after a warm-up; a request (and a train step) launches PP_LAUNCHES:
# one masked FPS a sector (six) and the three-NN of the VSA's VectorPool
# sources (two groups each of the raw points, x_conv3 and x_conv4; two K6
# launches a call); training a warm-up and PP_TRAIN_STEPS steps over
# PP_TRAIN_BATCHES planned batches
PP_B, PP_REQUESTS = 2, 5
PP_TRAIN_STEPS, PP_TRAIN_BATCHES = 10, 3
PP_LAUNCHES = {'fps': 6, 'three_nn': 12}
# K6's device time over the six VSA calls of a PV-RCNN++ request in its
# previous design (one thread a query over every row), as an earlier run
# of this script measured it on an H100 80GB HBM3 at 700.00 W; a recorded
# figure for the log, never put in the JSON lines
K6_BEFORE_MS = 89.335
# card vs CPU, one PV-RCNN++ request: the CPU runs the VSA's VectorPool
# sources on the first PP_CPU_KEYPOINTS of the 4096 keypoints (in eval mode a
# row-wise function of each keypoint, so the subset is exact; all of them
# would be 3.8e10 three-NN pairs on the CPU)
PP_CPU_KEYPOINTS = 128
# card vs CPU, one PV-RCNN++ train step: BatchNorm takes the batch's
# statistics, so no subset of keypoints is exact; one frame on a 51.2 m
# square of Waymo's range, 10 000 voxels a level, 8 192 points and 1 024
# keypoints (at 20 000 voxels, 16 384 points and 4 096 keypoints its two
# CPU steps took 208 s of the phase's 226 s on the H100 host, and the
# card's gradients came within 0.009 of the CPU's; on a 25.6 m square at
# 8 000 voxels within 0.046, against the ceiling of 0.05)
PP_TRAIN_CUT = {'range': (-25.6, -25.6, -2, 25.6, 25.6, 4), 'voxels': 10000,
                'points': 8192, 'keypoints': 1024}
# card vs CPU, one CenterPoint train step (phase 48): one frame on the same
# square at 20 000 voxels and 16 384 points (at the full range, 150 000
# rows a level, its two CPU steps took most of the phase's 64 s on the H100
# host; on this crop the phase takes 15 s)
CP_TRAIN_CUT = {'range': (-25.6, -25.6, -2, 25.6, 25.6, 4), 'voxels': 20000,
                'points': 16384}


# the pillar detectors: kitti_models/pointpillar.yaml on PILLAR_B scans
# of N points at 40 000 pillars of 32 slots (16 000 in training),
# PILLAR_REQUESTS requests and PILLAR_TRAIN_STEPS steps over
# PILLAR_TRAIN_BATCHES batches after a warm-up; Waymo's CenterPoint over
# pillars (150 000 of 20 slots) and over dynamic pillars on the CenterPoint
# scans (CP_B of CP_N points), CPP_REQUESTS requests and CPP_TRAIN_STEPS
# steps over CP_TRAIN_BATCHES batches; their card-vs-CPU train steps on
# CP_TRAIN_CUT. No kernel of the port runs on these paths
PILLAR_B, PILLAR_REQUESTS = 2, 10
PILLAR_TRAIN_STEPS, PILLAR_TRAIN_BATCHES = 10, 3
CPP_REQUESTS, CPP_TRAIN_STEPS = 5, 10


def seeding():
    """The train path's D-FPS: grid-seeded at f = 0.75, the JAX package's
    default on its accelerator."""
    from spsnet_torch.ops import FpsSeeding
    return FpsSeeding(0.75, 'grid')


_T0 = time.perf_counter()


def log(*args):
    """Print a line; a phase header ('== ...') with the seconds since the
    start."""
    if args and str(args[0]).startswith('== '):
        args = (*args, f'[{time.perf_counter() - _T0:.1f} s]')
    print(*args, flush=True)


def cuda_ms(fn, reps=5):
    """Median milliseconds of ``fn()`` on the card (CUDA events), after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes > t_ops else \
        'operations'


def require_equal(a, b, what):
    """Raise unless ``a`` and ``b`` are equal; returns their largest absolute
    difference (0)."""
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape or not torch.equal(a, b):
        diff = (a != b).sum().item() if a.shape == b.shape else 'shape'
        raise AssertionError(f'{what}: kernel != plain ({diff} differ)')
    log(f'  {what}: identical')
    return 0.0


def fps_bound(b, n, npoint, steps=None):
    """Bound of an exact FPS of ``steps`` (npoint - 1) steps over (b, n)
    points: xyz read once, the picks written once; 3 sub, 3 mul, 2 add, a
    min and a compare per point and step."""
    steps = npoint - 1 if steps is None else steps
    return bound_ms(b * n * 12 + b * npoint * 8, steps * b * n * 10)


def fps_call(name, kernel, xyz, npoint, plain_ms=None, plain_reps=3):
    """One FPS kernel vs the plain FPS at one shape: indices identical,
    CUDA-event times (the plain version's over ``plain_reps`` runs after a
    warm-up), bound. Returns the call's record (with 'err')."""
    from spsnet_torch.ops.sampling import farthest_point_sample_plain
    b, n, _ = xyz.shape
    err = require_equal(kernel(xyz, npoint),
                        farthest_point_sample_plain(xyz, npoint),
                        f'{name} ({b}, {n}, 3) -> {npoint}')
    ms = cuda_ms(lambda: kernel(xyz, npoint), reps=10)
    if plain_ms is None:
        plain_ms = cuda_ms(lambda: farthest_point_sample_plain(xyz, npoint),
                           reps=plain_reps)
    bnd, by = fps_bound(b, n, npoint)
    log(f'  {name} ({b}, {n}, 3) -> {npoint}: kernel {ms:.3f} ms, plain '
        f'{plain_ms:.3f} ms, bound {bnd:.4f} ms ({by})')
    return {'B': b, 'N': n, 'npoint': npoint, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bnd, 'bound_by': by, 'err': err}


def fps_phase(xyz, kept_xyz):
    """FPS kernel vs plain, at IA-SSD's layer 0 and SPSNet's (``kept_xyz``,
    the scenes after the stability hook), one row, masks and the prefix
    nesting; returns the JSON entry without launches."""
    from spsnet_torch.ops import gather_points
    from spsnet_torch.ops.sampling import (farthest_point_sample_kernel,
                                           farthest_point_sample_plain)
    npoint = 4096
    main = fps_call('fps', farthest_point_sample_kernel, xyz, npoint)
    spsnet = fps_call('fps', farthest_point_sample_kernel, kept_xyz, npoint)
    for call in (main, spsnet):
        _cluster_note('fps', call, npoint - 1, seeded=False)
    err = max(main.pop('err'), spsnet.pop('err'), require_equal(
        farthest_point_sample_kernel(xyz[:1].contiguous(), npoint),
        farthest_point_sample_plain(xyz[:1], npoint),
        f'fps (1, {N}, 3) -> {npoint}'))
    gen = torch.Generator(device='cuda').manual_seed(0)
    for (b, n, m) in ((2, 5000, 1000), (1, 40000, 512), (1, 65536, 128)):
        pts = torch.randn(b, n, 3, device='cuda', generator=gen) * 20
        mask = torch.rand(b, n, device='cuda', generator=gen) > 0.3
        err = max(err, require_equal(
            farthest_point_sample_kernel(pts, m, mask),
            farthest_point_sample_plain(pts, m, mask),
            f'fps ({b}, {n}, 3) -> {m} masked'))
    chain = gather_points(xyz, farthest_point_sample_kernel(xyz, npoint))
    require_equal(farthest_point_sample_kernel(chain, 1024),
                  torch.arange(1024, device='cuda').expand(B, 1024),
                  'prefix nesting FPS(layer-0 chain, 1024) == arange(1024)')
    return {'name': 'fps', 'route': 'cuda',
            'source': 'spsnet_torch/csrc/fps.cu',
            'replaces': 'spsnet_tpu/ops/pallas/fps.py:167',
            'also_replaces': [f'spsnet_tpu/ops/pallas/fps.py:{line}'
                              for line in (26, 73, 239, 677)],
            'match': True, 'max_abs_err': err,
            **{key: main[key] for key in ('ms', 'plain_ms', 'bound_ms',
                                          'bound_by')},
            'library_ms': None, 'shape': f'({B},{N},3)->{npoint}',
            **{key: main[key] for key in ('us_per_step', 'cluster',
                                          'cta_threads',
                                          'max_active_clusters')},
            'spsnet_layer0': spsnet}


def _cluster_note(name, call, steps, seeded):
    """Add to an FPS call's record (and print) its time a step, its cluster
    size and CTA width, and how many such clusters the card holds at once."""
    from spsnet_torch.ops import _build
    from spsnet_torch.ops.sampling import fps_launch_shape
    c, t = fps_launch_shape(call['B'], call['N'])
    active = _build.library('fps').spsnet_fps_max_active_clusters(
        call['B'], call['N'], int(seeded))
    call.update(us_per_step=call['ms'] * 1e3 / steps, cluster=c,
                cta_threads=t, max_active_clusters=active)
    log(f'  {name} ({call["B"]}, {call["N"]}, 3): {call["us_per_step"]:.3f} '
        f'us a step over {steps} steps; clusters of {c} CTAs x {t} threads, '
        f'{call["B"]} clusters launched, {active} fit at once')


def _scan_pairs(idx_list, nsamples, n):
    """Points each center must test before all its radii are full: the
    index of the nsample-th hit + 1, or all n when a ball has fewer hits
    (slots past the last hit repeat the first, so a full ball is exactly a
    strictly increasing slot row)."""
    need = None
    for idx, s in zip(idx_list, nsamples):
        full = (idx[..., 1:] > idx[..., :-1]).all(-1) if s > 1 else \
            torch.ones(idx.shape[:-1], dtype=torch.bool, device=idx.device)
        length = torch.where(full, idx[..., -1] + 1, n)
        need = length if need is None else torch.maximum(need, length)
    return int(need.sum())


def ball_query_call(radii, ns, xyz, ctr, what):
    """The ball-query kernel vs plain on one input: indices identical,
    CUDA-event times, bound over the pairs the centers scanned. Returns the
    call's record (with 'err')."""
    from spsnet_torch.ops import _build
    from spsnet_torch.ops.grouping import (ball_query_multi_kernel,
                                           ball_query_multi_plain)
    radii, ns = tuple(radii), tuple(ns)
    got = ball_query_multi_kernel(radii, ns, xyz, ctr)
    want = ball_query_multi_plain(radii, ns, xyz, ctr)
    err = 0.0
    for r, g, w in zip(radii, got, want):
        err = max(err, require_equal(
            g, w, f'ball query {what} r={r} '
                  f'{tuple(ctr.shape[:2])}x{xyz.shape[1]}'))
    ms = cuda_ms(lambda: ball_query_multi_kernel(radii, ns, xyz, ctr),
                 reps=10)
    plain = cuda_ms(lambda: ball_query_multi_plain(radii, ns, xyz, ctr),
                    reps=3)
    pairs = _scan_pairs(got, ns, xyz.shape[1])
    n_bytes = (xyz.numel() + ctr.numel()) * 4 + \
        sum(g.numel() for g in got) * 8
    bnd, by = bound_ms(n_bytes, pairs * 10)  # 3 sub 3 mul 2 add 2 cmp
    log(f'  ball query {what} B={xyz.shape[0]} M={ctr.shape[1]} '
        f'N={xyz.shape[1]} r={radii} ns={ns}: kernel {ms:.3f} ms, plain '
        f'{plain:.3f} ms, bound {bnd:.4f} ms ({by}, {pairs} pairs)')
    record = {'layer': what, 'B': xyz.shape[0], 'M': ctr.shape[1],
              'N': xyz.shape[1], 'radii': radii, 'nsamples': ns, 'ms': ms,
              'plain_ms': plain, 'bound_ms': bnd, 'bound_by': by,
              'pairs': pairs, 'err': err}
    record['warp_centers'] = _build.library(
        'ball_query').spsnet_ball_query_warp_centers(*ctr.shape[:2])
    log(f'    W (centers a warp): {record["warp_centers"]}')
    return record


def ball_query_phase(model, points, raw_xyz, kept_xyz):
    """Ball-query kernel vs plain at every grouping layer of IA-SSD, on the
    centers the path produces, and at SPSNet's two new shapes: the stability
    SA (every point of the raw scenes a center) and the surface graph (every
    kept point a center); returns the JSON entry without launches."""
    with torch.no_grad():
        enc = model({'points': points})['encoder_xyz']
    backbone = model.backbone_3d
    calls = []
    for k, module in enumerate(backbone.SA_modules):
        if getattr(module, 'radii', None):
            calls.append(ball_query_call(
                module.radii, module.nsamples,
                enc[backbone.layer_inputs[k]].contiguous(),
                enc[k + 1].contiguous(), f'layer {k}'))
    spsnet = [ball_query_call((0.2, 0.8), (16, 32), raw_xyz, raw_xyz,
                              'stability SA'),
              ball_query_call((0.8,), (16,), kept_xyz, kept_xyz,
                              'surface graph')]
    err = max(c.pop('err') for c in calls + spsnet)
    total = {key: sum(c[key] for c in calls)
             for key in ('ms', 'plain_ms', 'bound_ms', 'pairs')}
    by = 'bytes' if all(c['bound_by'] == 'bytes' for c in calls) else \
        'operations'
    return {'name': 'ball_query', 'route': 'cuda',
            'source': 'spsnet_torch/csrc/ball_query.cu',
            'replaces': 'spsnet_tpu/ops/pallas/d2.py:33',
            'match': True, 'max_abs_err': err, 'ms': total['ms'],
            'plain_ms': total['plain_ms'], 'bound_ms': total['bound_ms'],
            'bound_by': by, 'library_ms': None,
            'shape': 'sum of the IA-SSD per-forward calls', 'calls': calls,
            'spsnet_calls': spsnet}


def k5_entries():
    """The experimental FPS entries, the counterparts of the JAX package's
    K5a-c; on the card both launch the exact FPS kernel."""
    from spsnet_torch.ops import sampling
    return (sampling.farthest_point_sample_batched,
            sampling.farthest_point_sample_hier_argmax)


def fps_variant_phase(clouds):
    """The experimental FPS entries vs the plain FPS at the K5 shapes
    (``clouds``: (xyz, npoint) pairs), indices identical, with CUDA-event
    times; returns ``{'k5_entries': [call records]}`` for the FPS kernel's
    JSON entry."""
    calls = []
    for xyz, npoint in clouds:
        plain_ms = None
        for entry in k5_entries():
            call = fps_call(entry.__name__, entry, xyz, npoint, plain_ms)
            plain_ms = call['plain_ms']
            calls.append({'entry': entry.__name__, **call})
    return {'k5_entries': calls}


def fps_entry_path(clouds):
    """The experimental FPS entries as a user calls them, at the K5 shapes,
    with the counters zeroed just before; returns the launch counts."""
    from spsnet_torch.ops import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    for xyz, npoint in clouds:
        for entry in k5_entries():
            idx = entry(xyz, npoint)
            if idx.shape != (xyz.shape[0], npoint) or \
                    int(idx.min()) < 0 or int(idx.max()) >= xyz.shape[1]:
                raise AssertionError(f'{entry.__name__}: bad picks')
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = {k: 2 * len(clouds) if k == 'fps' else 0 for k in launches}
    if launches != want:
        raise AssertionError(f'launches of the FPS entries: {launches}, '
                             f'want {want}')
    log(f'  launches over {len(clouds)} shapes: {launches}')
    return launches


def _seeded_case(xyz, npoint, k0, seed_idx, what, errs):
    """K3 and K4 kernel vs plain on one input, their largest differences
    (0) kept in ``errs``; returns the seeds, d0 and the seeded picks."""
    from spsnet_torch.ops import gather_points
    from spsnet_torch.ops.sampling import (
        farthest_point_sample_seeded_kernel,
        farthest_point_sample_seeded_plain, seed_min_d2_kernel,
        seed_min_d2_plain)
    seeds = gather_points(xyz, seed_idx).contiguous()
    d0 = seed_min_d2_kernel(xyz, seeds)
    errs['seed_min'] = max(errs['seed_min'], require_equal(
        d0, seed_min_d2_plain(xyz, seeds),
        f'seed_min {tuple(xyz.shape)} k0={k0} ({what}), bit for bit'))
    picks = farthest_point_sample_seeded_kernel(xyz, npoint, d0, seed_idx)
    errs['fps_seeded'] = max(errs['fps_seeded'], require_equal(
        picks, farthest_point_sample_seeded_plain(xyz, npoint, d0, seed_idx),
        f'fps_seeded {tuple(xyz.shape)} k0={k0} -> {npoint} ({what})'))
    return seeds, d0, picks


def _seed_min_note(call):
    """Add to a K3 call's record (and print) its launch shape."""
    from spsnet_torch.ops.sampling import seed_min_launch_shape
    s, p, ctas, t = seed_min_launch_shape(call['B'], call['N'], call['k0'])
    call.update(cluster=s, points_a_thread=p, ctas=ctas, cta_threads=t)
    log(f'  seed_min ({call["B"]}, {call["N"]}, 3) k0={call["k0"]}: '
        f'clusters of {s} CTAs split the seeds, {ctas} CTAs of {t} threads '
        f'x {p} points')


def seed_min_edges(errs):
    """K3 alone vs plain, bit for bit, at the edges of its tiling: one seed,
    one seed past the train path's k0 at both layers (so the last cluster
    share comes up short), k0 no multiple of 4, one point, one point past a
    multiple of a CTA's points, and seeds that are points (d2 = +0
    there)."""
    from spsnet_torch.ops.sampling import (seed_min_d2_kernel,
                                           seed_min_d2_plain,
                                           seed_min_launch_shape)
    gen = torch.Generator(device='cuda').manual_seed(2)
    _, p, _, t = seed_min_launch_shape(TRAIN_B, N, 3072)
    tile = t * p
    for b, n, k0, what in ((2, 5000, 1, 'one seed'),
                           (TRAIN_B, N, 3073, 'a seed past the path\'s k0'),
                           (TRAIN_B, 4096, 769, 'a seed past the path\'s k0'),
                           (3, 2000, 7, 'k0 % 4 != 0'),
                           (3, 1, 5, 'one point'),
                           (2, 4 * tile + 1, 300, 'a point past a tile')):
        xyz = torch.randn(b, n, 3, device='cuda', generator=gen) * 20
        seeds = torch.randn(b, k0, 3, device='cuda', generator=gen) * 20
        errs['seed_min'] = max(errs['seed_min'], require_equal(
            seed_min_d2_kernel(xyz, seeds), seed_min_d2_plain(xyz, seeds),
            f'seed_min ({b}, {n}, 3) k0={k0} ({what}; launch '
            f'{seed_min_launch_shape(b, n, k0)}), bit for bit'))
    xyz = torch.randn(2, 3000, 3, device='cuda', generator=gen) * 20
    seeds = xyz[:, ::7].contiguous()
    d0 = seed_min_d2_kernel(xyz, seeds)
    errs['seed_min'] = max(errs['seed_min'], require_equal(
        d0, seed_min_d2_plain(xyz, seeds),
        f'seed_min (2, 3000, 3) k0={seeds.shape[1]} (seeds that are points)'))
    at = d0[:, ::7]
    if not ((at == 0) & ~torch.signbit(at)).all():
        raise AssertionError('seed_min: d2 at a seed is not +0')


def _seeded_records(xyz, npoint, k0, idx, seeds, d0, layer):
    """K3 and K4 at one layer's shape, from the seeds ``idx`` and their min
    distances ``d0``: event times of kernel and plain, bound and launch
    shape; returns {'seed_min': record, 'fps_seeded': record}."""
    from spsnet_torch.ops.sampling import (
        farthest_point_sample_seeded_kernel,
        farthest_point_sample_seeded_plain, seed_min_d2_kernel,
        seed_min_d2_plain)
    b, n, _ = xyz.shape
    records = {}
    for name, fn, plain, n_bytes, n_ops in (
            ('seed_min', lambda: seed_min_d2_kernel(xyz, seeds),
             lambda: seed_min_d2_plain(xyz, seeds),
             (xyz.numel() + seeds.numel() + b * n) * 4,
             b * n * k0 * 9),           # 3 sub 3 mul 2 add 1 min
            ('fps_seeded',
             lambda: farthest_point_sample_seeded_kernel(xyz, npoint, d0, idx),
             lambda: farthest_point_sample_seeded_plain(xyz, npoint, d0, idx),
             (xyz.numel() + d0.numel()) * 4 + (idx.numel() + b * npoint) * 8,
             (npoint - k0) * b * n * 10)):  # 3 sub 3 mul 2 add min cmp
        ms = cuda_ms(fn, reps=10)
        plain_ms = cuda_ms(plain, reps=3)
        bnd, by = bound_ms(n_bytes, n_ops)
        log(f'  {name} layer {layer} ({b}, {n}, 3) k0={k0} -> {npoint}: '
            f'kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound '
            f'{bnd:.4f} ms ({by})')
        records[name] = {'layer': layer, 'B': b, 'N': n, 'k0': k0,
                         'npoint': npoint, 'ms': ms, 'plain_ms': plain_ms,
                         'bound_ms': bnd, 'bound_by': by}
    _cluster_note('fps_seeded', records['fps_seeded'], npoint - k0,
                  seeded=True)
    _seed_min_note(records['seed_min'])
    return records


def seeded_phase(scenes):
    """The seeded D-FPS kernels vs plain at the train path's two layers on
    grid seeds, then on head seeds, at an N that is no multiple of 128 and
    K3 at the edges of its tiling; returns the JSON entries of seed_min and
    fps_seeded without launches."""
    from spsnet_torch.ops import gather_points
    from spsnet_torch.ops.sampling import grid_seed_indices, seed_k0
    xyz = scenes[..., :3].contiguous()
    calls = {'seed_min': [], 'fps_seeded': []}
    errs = {'seed_min': 0.0, 'fps_seeded': 0.0}
    for layer, npoint in enumerate((4096, 1024)):
        k0 = seed_k0(seeding(), npoint)
        idx = grid_seed_indices(xyz, k0)
        seeds, d0, picks = _seeded_case(xyz, npoint, k0, idx, 'grid seeds',
                                        errs)
        for name, record in _seeded_records(xyz, npoint, k0, idx, seeds, d0,
                                            layer).items():
            calls[name].append(record)
        xyz = gather_points(xyz, picks).contiguous()
    head = torch.arange(3072, device='cuda').expand(TRAIN_B, 3072)
    _seeded_case(scenes[..., :3].contiguous(), 4096, 3072,
                 head.contiguous(), 'head seeds', errs)
    gen = torch.Generator(device='cuda').manual_seed(1)
    odd = torch.randn(2, 5000, 3, device='cuda', generator=gen) * 20
    _seeded_case(odd, 1024, 768, grid_seed_indices(odd, 768),
                 'N % 128 != 0', errs)
    seed_min_edges(errs)
    entries = []
    for name, source, replaces in (
            ('seed_min', 'spsnet_torch/csrc/seed_min.cu',
             'spsnet_tpu/ops/pallas/fps.py:461'),
            ('fps_seeded', 'spsnet_torch/csrc/fps.cu',
             'spsnet_tpu/ops/pallas/fps.py:387')):
        c = calls[name]
        entries.append({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'match': True, 'max_abs_err': errs[name],
            'ms': sum(x['ms'] for x in c),
            'plain_ms': sum(x['plain_ms'] for x in c),
            'bound_ms': sum(x['bound_ms'] for x in c),
            'bound_by': 'operations' if any(x['bound_by'] == 'operations'
                                            for x in c) else 'bytes',
            'library_ms': None,
            'library_note': 'no single PyTorch call computes this function',
            'shape': 'sum of the per-train-step calls', 'calls': c})
    return entries


def train_shapes_phase(inp):
    """Phase 3 at the shapes the two new train paths give the kernels: K2 at
    the stability train step (16 x 16384 centers on 16384 points, r 0.2 /
    0.8), K3 + K4 at SPSNet training's layer 0 ((4, 15884) -> 4096 from
    3072 grid seeds), and S-FPS (K1, then K2 with SPSNet.yaml's layer-0 ball,
    r 0.05 and 16 neighbours) at (4, 16384) -> 4096 on the frozen
    generator's stds, once with min_unique 3500 and once with 0, so that
    the swap runs for certain. Each kernel is held to its plain version
    (S-FPS to the CPU's plain run), with event times, the device time of
    a call and the launch shape; returns {name: [call records]}."""
    from spsnet_torch.models import samplers
    from spsnet_torch.ops import gather_points
    from spsnet_torch.ops import sampling as smp
    from spsnet_torch.ops.grouping import ball_query_multi_kernel
    out = {'ball_query': [], 'seed_min': [], 'fps_seeded': [], 'fps': [],
           'sfps': []}
    errs = {'seed_min': 0.0, 'fps_seeded': 0.0, 'ball_query': 0.0,
            'fps': 0.0}

    def k2(radii, ns, xyz, ctr, what):
        record = ball_query_call(radii, ns, xyz, ctr, what)
        errs['ball_query'] = max(errs['ball_query'], record.pop('err'))
        record['device_ms'] = device_ms(
            lambda: ball_query_multi_kernel(radii, ns, xyz, ctr), reps=5)
        log(f'    device time {record["device_ms"]:.4f} ms a call')
        out['ball_query'].append(record)

    xyz = inp['stab_batches'][0]['points'][..., :3].contiguous()
    k2((0.2, 0.8), (16, 32), xyz, xyz, 'stability train step')

    kept = inp['sps_train_kept']
    k0 = smp.seed_k0(seeding(), 4096)
    idx = smp.grid_seed_indices(kept, k0)
    seeds, d0, _ = _seeded_case(kept, 4096, k0, idx,
                                'grid seeds, SPSNet train layer 0', errs)
    records = _seeded_records(kept, 4096, k0, idx, seeds, d0, 0)
    records['seed_min']['device_ms'] = device_ms(
        lambda: smp.seed_min_d2_kernel(kept, seeds), reps=21)
    records['fps_seeded']['device_ms'] = device_ms(
        lambda: smp.farthest_point_sample_seeded_kernel(kept, 4096, d0, idx),
        reps=5)
    for name, record in records.items():
        log(f'    {name} device time {record["device_ms"]:.4f} ms a call')
        out[name].append(record)

    batch = inp['train_batches'][0]
    with torch.no_grad():
        stds = inp['sps'][1].model(batch)['stds']
    pts = batch['points'][..., :3].contiguous()
    fps = fps_call('fps', smp.farthest_point_sample_kernel, pts, 4096)
    errs['fps'] = fps.pop('err')
    _cluster_note('fps', fps, 4095, seeded=False)
    fps['device_ms'] = device_ms(
        lambda: smp.farthest_point_sample_kernel(pts, 4096), reps=5)
    log(f'    device time {fps["device_ms"]:.4f} ms a call')
    out['fps'].append(fps)
    base = smp.farthest_point_sample_kernel(pts, 4096)
    k2((0.05,), (16,), pts, gather_points(pts, base).contiguous(),
       'S-FPS swap ball')
    for min_unique in (3500, 0):
        what = f'S-FPS (4, {N}) -> 4096 min_unique={min_unique}'
        got = samplers.sample_sfps(pts, stds, 4096, 0.05, 16, min_unique)
        want = samplers.sample_sfps(pts.cpu(), stds.cpu(), 4096, 0.05, 16,
                                    min_unique)
        require_equal(got[0], want[0], f'{what}: card vs CPU plain picks')
        require_equal(got[1], want[1], f'{what}: card vs CPU plain stds')
        fell_back = torch.equal(got[0], base)
        if min_unique == 0 and fell_back:
            raise AssertionError(f'{what}: the swap did not run')
        row0 = torch.sort(got[0][0]).values
        unique = int((row0[1:] != row0[:-1]).sum()) + 1
        ms = cuda_ms(lambda m=min_unique: samplers.sample_sfps(
            pts, stds, 4096, 0.05, 16, m), reps=5)
        branch = 'D-FPS picks (fallback)' if fell_back else 'swapped picks'
        log(f'  {what}: took the {branch}, {unique} unique picks in row 0; '
            f'{ms:.3f} ms a call (events)')
        out['sfps'].append({'B': pts.shape[0], 'N': N, 'npoint': 4096,
                            'ss_radius': 0.05, 'ss_nsample': 16,
                            'min_unique': min_unique, 'branch': branch,
                            'unique_row0': unique, 'ms': ms})
    out['errs'] = errs
    return out


@contextlib.contextmanager
def timed_calls(owner, attr):
    """Time each call of ``owner.attr`` while the context is open: its host
    milliseconds and a pair of CUDA events around it (no launch, no sync).
    Yields a list that ``range_ms`` reads after a ``synchronize``."""
    fn = getattr(owner, attr)
    calls = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        calls.append((start, end, (time.perf_counter() - t0) * 1e3))
        return out
    setattr(owner, attr, timed)
    try:
        yield calls
    finally:
        setattr(owner, attr, fn)


def range_ms(calls):
    """[(host ms, event ms)] of ``timed_calls``' record."""
    return [(host, start.elapsed_time(end)) for start, end, host in calls]


def detect(model, points, post):
    """One request as a server runs it: forward + ``post_processing``
    (class-agnostic NMS; PointRCNN's labels from its RoIs). ``points``: the
    (B, N, C) scans, or a batch dict."""
    from spsnet_torch.models.detectors.detector3d import post_processing
    batch = points if isinstance(points, dict) else {'points': points}
    with torch.no_grad():
        out = model(batch)
        return out, post_processing(out, post)


def main_path(model, requests, post, per_call, what):
    """One warm-up request, then the requests with the launch counters
    zeroed just before; outputs finite and counts in range, ``per_call``
    launches a request and none of another kernel. Returns (ms per
    request, launch counts)."""
    from spsnet_torch.ops import _build
    detect(model, requests[0], post)
    torch.cuda.synchronize()
    _build.reset_launches()
    times = []
    for points in requests:
        t0 = time.perf_counter()
        out, dets = detect(model, points, post)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        for key, t in (('batch_box_preds', out['batch_box_preds']),
                       ('batch_cls_preds', out['batch_cls_preds']),
                       ('boxes', dets['boxes']), ('scores', dets['scores'])):
            if not torch.isfinite(t).all():
                raise AssertionError(f'{what}: non-finite {key}')
        count = dets['count']
        b = (points['points'] if isinstance(points, dict) else
             points).shape[0]
        if count.shape != (b,) or count.min() < 0 or \
                count.max() > int(post.NMS_CONFIG.NMS_POST_MAXSIZE):
            raise AssertionError(f'{what}: detection counts out of range: '
                                 f'{count}')
    launches = dict(_build.LAUNCHES)
    _require_per_call(launches, per_call, len(requests), what)
    return times, launches


@contextlib.contextmanager
def topk_picks(replay=None):
    """Record the top-k sampler picks (ctr_aware, sss_aware) of a run, or
    replay recorded picks.

    Both samplers order hundreds of scores packed within a few fp32 ulps of
    each other (sigmoids of random-weight logits, for sss_aware times a
    stability score), so two devices whose matmuls round differently may
    order near-ties differently, and the order decides the first-k
    neighbours downstream. A replayed pick list must be a descending order
    of this run's own scores within CTR_SCORE_TOL rank by rank; then both
    runs continue from the same picks and stay comparable.
    """
    from spsnet_torch.models import samplers
    own_ctr, own_sss = samplers.sample_ctr_aware, samplers.sample_sss_aware
    picks = []

    def take(own, scores, what):
        if replay is None:
            picks.append(own)
            return own
        want = replay[len(picks)].to(own.device)
        diff = float((scores.gather(1, want) - scores.gather(1, own))
                     .abs().max())
        log(f'  {what} picks {len(picks)}: {int((want != own).sum())} of '
            f'{own.numel()} ranks differ, largest rank-wise score difference '
            f'{diff:.3e} (tolerance {CTR_SCORE_TOL})')
        if diff > CTR_SCORE_TOL:
            raise AssertionError(f'{what} picks are no top-k order of the '
                                 'other run\'s scores')
        picks.append(want)
        return want

    def ctr(cls_features, npoint):
        return take(own_ctr(cls_features, npoint),
                    torch.sigmoid(cls_features.detach().amax(-1)),
                    'ctr_aware')

    def sss(cls_features, stds, npoint):
        idx = take(own_sss(cls_features, stds, npoint)[0],
                   samplers.sss_aware_scores(cls_features.detach(), stds),
                   'sss_aware')
        return idx, stds.gather(1, idx)

    samplers.sample_ctr_aware, samplers.sample_sss_aware = ctr, sss
    try:
        yield picks
    finally:
        samplers.sample_ctr_aware, samplers.sample_sss_aware = own_ctr, own_sss


@contextlib.contextmanager
def deletion_picks(replay=None):
    """Record the stability hook's deletions of a run (kept indices and the
    stds they came from), or replay recorded ones.

    The deletion sorts thousands of foreground stds, and two of them within
    the card-vs-CPU difference of each other order differently on the two
    devices. A replayed deletion must keep an ascending order of this run's
    own keys within STDS_RTOL of the largest stds (``_order_slack``); then
    both runs continue from the same points."""
    from spsnet_torch.ops import gather_points
    from spsnet_torch.stability import hook
    own = hook.stability_delete_points
    record = []

    def delete(points, stds, fake_labels, noise=None, delete_number=500,
               method='stability'):
        kept, keep = own(points, stds, fake_labels, noise,
                         delete_number=delete_number, method=method)
        if replay is not None:
            want = replay[len(record)][0].to(keep.device)
            if not torch.equal(want, keep):
                tol = STDS_RTOL * float(stds.max())
                key = torch.where(fake_labels > 0, stds, 1e9).cpu()
                for b in range(keep.shape[0]):
                    slack, ranks = _order_slack(want[b].cpu(), keep[b].cpu(),
                                                key[b])
                    if slack > tol or ranks > tol:
                        raise AssertionError(
                            f'scene {b}: the replayed deletion is no '
                            f'ascending order of this run\'s keys (deleted '
                            f'above kept by {slack:.3e}, rank-wise '
                            f'{ranks:.3e}; tolerance {tol:.3e})')
                log(f'  deletion {len(record)}: {int((want != keep).sum())} '
                    f'of {keep.numel()} kept ranks differ, within {tol:.3e} '
                    'of this run\'s key order; replayed')
                keep, kept = want, gather_points(points, want)
        record.append((keep, stds))
        return kept, keep

    hook.stability_delete_points = delete
    try:
        yield record
    finally:
        hook.stability_delete_points = own


def cpu_phase(model, cfg, scene):
    """One scene on the card and on the CPU with the same weights; the CPU
    run replays the card's ctr_aware picks (see ``topk_picks``)."""
    from spsnet_torch.models import build_detector
    post = cfg.MODEL.POST_PROCESSING
    cpu = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), device='cpu')
    cpu.load_state_dict(model.state_dict())
    with topk_picks() as picks:
        gpu_out, gpu_dets = detect(model, scene, post)
    with topk_picks(replay=picks):
        cpu_out, cpu_dets = detect(cpu, scene.cpu(), post)
    compare_forwards(model, scene[..., :3].contiguous(), gpu_out, gpu_dets,
                     cpu_out, cpu_dets)


def compare_forwards(model, xyz, gpu_out, gpu_dets, cpu_out, cpu_dets):
    """Card vs CPU on one forward of ``model`` over the cloud ``xyz``: the
    layer-0 FPS, every layer's ball query (the card's kernel and the CPU's
    plain version on the CPU run's points), the D-FPS layers' sampled
    points, the predictions and the NMS outputs."""
    from spsnet_torch.ops import farthest_point_sample
    from spsnet_torch.ops.grouping import ball_query_multi
    backbone = model.backbone_3d
    enc = cpu_out['encoder_xyz']
    npoint = backbone.npoint0[0]
    require_equal(farthest_point_sample(xyz, npoint),
                  farthest_point_sample(xyz.cpu(), npoint),
                  f'card kernel vs CPU plain: layer-0 FPS indices '
                  f'{tuple(xyz.shape)} -> {npoint}')
    for k, module in enumerate(backbone.SA_modules):
        if getattr(module, 'radii', None):
            pts, ctr = enc[backbone.layer_inputs[k]].contiguous(), enc[k + 1]
            ns = tuple(module.nsamples)
            for g, c in zip(ball_query_multi(module.radii, ns, pts.cuda(),
                                             ctr.cuda()),
                            ball_query_multi(module.radii, ns, pts, ctr)):
                require_equal(g, c, f'card kernel vs CPU plain: ball query '
                                    f'layer {k}')
        if backbone.layer_types[k] == 'SA_Layer' and \
                backbone.ctr_idx_list[k] == -1:
            require_equal(gpu_out['encoder_xyz'][k + 1], enc[k + 1],
                          f'card vs CPU: layer {k} sampled points')
    for key in ('batch_cls_preds', 'batch_box_preds'):
        _require_close(gpu_out[key], cpu_out[key], key)
    for key in ('count', 'indices'):
        require_equal(gpu_dets[key], cpu_dets[key], f'card vs CPU NMS {key}')


def build_spsnet(device):
    """SPSNet.yaml at full width on ``device``: its config, the stability
    preprocess (generator weights from ``torch.Generator`` seed 1) and the
    detector (seed 0)."""
    from spsnet_torch.models import build_detector
    from spsnet_torch.runtime.trainer import make_stability_preprocess
    from spsnet_torch.zoo import spsnet_kitti_cfg
    cfg = spsnet_kitti_cfg()
    preprocess = make_stability_preprocess(
        cfg.MODEL.STABILITY_HOOK, device, torch.Generator().manual_seed(1))
    model = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), device=device,
                           generator=torch.Generator().manual_seed(0))
    return cfg, preprocess, model


def spsnet_path(step, kept, requests, post):
    """Serve SPSNet requests through the eval step ``step`` (whose
    preprocess appends each batch's kept point count to ``kept``); returns
    (ms per request, launch counts)."""
    from spsnet_torch.ops import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    times = []
    for batch in requests:
        t0 = time.perf_counter()
        dets, box_preds = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        for key, t in (('batch_box_preds', box_preds),
                       ('boxes', dets['boxes']), ('scores', dets['scores'])):
            if not torch.isfinite(t).all():
                raise AssertionError(f'non-finite {key}')
        count = dets['count']
        if count.shape != (B,) or count.min() < 0 or \
                count.max() > int(post.NMS_CONFIG.NMS_POST_MAXSIZE):
            raise AssertionError(f'detection counts out of range: {count}')
        if kept[-1] != KEPT:
            raise AssertionError(f'{kept[-1]} points kept a scene, want '
                                 f'{KEPT}')
    return times, dict(_build.LAUNCHES)


def _order_slack(keep, own_keep, key):
    """How far ``keep`` (one scene's kept indices, in key order) is from an
    ascending order of ``key``, whose own order keeps ``own_keep``: how far
    what ``keep`` deletes lies above what it keeps (<= 0 when below), and
    the largest rank-wise key difference of its kept points."""
    gone = torch.ones(key.shape[0], dtype=torch.bool)
    gone[keep] = False
    return (float(key[gone].max() - key[~gone].min()),
            float((key[keep] - key[own_keep]).abs().max()))


def spsnet_cpu_phase(cfg, preprocess, model, batch):
    """One SPSNet scene on the card and on the CPU with the same weights:
    the stds, the foreground, the stability SA's and the surface graph's
    ball queries, the deletion (the CPU replays the card's after its order
    check, ``deletion_picks``), then the detector and the NMS as
    ``compare_forwards`` checks them. Its sss_aware picks replay the
    card's (``topk_picks``)."""
    from spsnet_torch.models import build_detector
    from spsnet_torch.ops import ball_query, ball_query_multi
    from spsnet_torch.runtime.trainer import make_stability_preprocess
    from spsnet_torch.stability.hook import fake_labels_from_boxes
    post = cfg.MODEL.POST_PROCESSING
    cpu_pre = make_stability_preprocess(cfg.MODEL.STABILITY_HOOK, 'cpu')
    cpu_pre.model.load_state_dict(preprocess.model.state_dict())
    cpu = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), device='cpu')
    cpu.load_state_dict(model.state_dict())
    card = {k: v[:1].contiguous() for k, v in batch.items()}
    host = {k: v.cpu() for k, v in card.items()}
    with torch.no_grad(), deletion_picks() as dels:
        kept_g = preprocess(card, torch.Generator())
    with torch.no_grad(), deletion_picks(replay=dels) as cpu_dels:
        kept_c = cpu_pre(host, torch.Generator())
    stds_g, stds_c = dels[0][1].cpu(), cpu_dels[0][1]
    rel = float(((stds_g - stds_c).abs() / stds_c.abs()).max())
    if not torch.allclose(stds_g, stds_c, rtol=STDS_RTOL, atol=0.0):
        raise AssertionError(f'card vs CPU stds: {rel:.3e} relative over '
                             f'{STDS_RTOL}')
    log(f'  card vs CPU stds: largest relative difference {rel:.3e} '
        f'(tolerance {STDS_RTOL})')
    xyz = card['points'][..., :3].contiguous()
    for g, c in zip(ball_query_multi((0.2, 0.8), (16, 32), xyz, xyz),
                    ball_query_multi((0.2, 0.8), (16, 32), xyz.cpu(),
                                     xyz.cpu())):
        require_equal(g, c, 'card kernel vs CPU plain: stability SA ball '
                            'query')
    fake_c = fake_labels_from_boxes(host['points'], host['gt_boxes'])
    require_equal(fake_labels_from_boxes(card['points'], card['gt_boxes']),
                  fake_c, 'card vs CPU foreground labels')
    log(f'  card vs CPU deletion: both runs go on from the same {KEPT} '
        f'points ({int((fake_c > 0).sum())} foreground points; any replay '
        'is logged above)')
    kxyz = kept_g['points'][..., :3].contiguous()
    require_equal(ball_query(0.8, 16, kxyz, kxyz),
                  ball_query(0.8, 16, kxyz.cpu(), kxyz.cpu()),
                  'card kernel vs CPU plain: surface graph')
    kept_g = {k: kept_g[k] for k in ('points', 'stds')}
    kept_c = {k: kept_c[k] for k in ('points', 'stds')}
    with topk_picks() as picks:
        gpu_out, gpu_dets = detect(model, kept_g, post)
    with topk_picks(replay=picks):
        cpu_out, cpu_dets = detect(cpu, kept_c, post)
    compare_forwards(model, kxyz, gpu_out, gpu_dets, cpu_out, cpu_dets)


def profile_phase(fn, what, ranges=()):
    """Top CUDA kernels of one call of ``fn`` by device time, and the
    share of the call's wall time in which a kernel ran; for each name in
    ``ranges`` (a ``record_function`` range inside ``fn``), its host time,
    the device time of its kernels and its kernel launches. A first call
    runs as the profiler's warm-up step: a trace started right before the
    call loses its first kernels."""
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) \
            as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.step()
    # kernels only: a user-annotated range (Optimizer.step) also carries
    # the device time of the kernels inside it
    events = [e for e in prof.key_averages()
              if getattr(e, 'device_type', None) is not None
              and str(e.device_type).endswith('CUDA')
              and not getattr(e, 'is_user_annotation', False)
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in events) / 1e3
    log(f'  device time of {what}: {total:.3f} ms over '
        f'{sum(e.count for e in events)} kernel launches in {wall:.3f} ms '
        f'(profiled); busy share {total / wall:.3f}')
    for e in events[:12]:
        log(f'    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} '
            f'{e.key[:90]}')
    # the host side: operators and CUDA runtime calls by their own CPU time
    host = sorted((e for e in prof.key_averages()
                   if e.self_cpu_time_total > 0),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    log(f'  host time of {what}, top entries by own CPU time:')
    for e in host:
        log(f'    {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<5d} '
            f'{e.key[:90]}')
    # the backward's kernels, launched by the autograd engine's thread
    # under its evaluate_function ranges
    timeline = prof.events()
    backward = sum(e.device_time_total for e in timeline
                   if e.name.startswith('autograd::engine::evaluate_function')
                   ) / 1e3
    spans = {}
    if ranges:
        launch_starts = [e.time_range.start for e in timeline
                         if e.name == 'cudaLaunchKernel']
        for name in ranges:
            # every span of the name in the profiled call (the warm-up
            # step's are not in the timeline)
            hits = [e for e in timeline if e.name == name
                    and not str(getattr(e, 'device_type', '')).endswith(
                        'CUDA')]
            spans[name] = {
                'spans': len(hits),
                'host_ms': sum(e.time_range.end - e.time_range.start
                               for e in hits) / 1e3,
                'device_ms': sum(e.device_time_total for e in hits) / 1e3,
                'launches': sum(1 for t in launch_starts for e in hits
                                if e.time_range.start <= t <=
                                e.time_range.end)}
            log(f'  {name} inside {what}: {spans[name]["host_ms"]:.3f} ms on '
                f'the host, {spans[name]["device_ms"]:.3f} ms of kernels, '
                f'{spans[name]["launches"]} kernel launches')
    return {'device_ms': total, 'wall_ms': wall, 'busy_share': total / wall,
            'launches': sum(e.count for e in events), 'ranges': spans,
            'kernel_ms': {e.key[:120]: e.self_device_time_total / 1e3
                          for e in events},
            'backward_device_ms': backward,
            'host_top': [[e.key[:60], e.self_cpu_time_total / 1e3, e.count]
                         for e in host]}


def _scene_batch(seed, b, device):
    from spsnet_torch.runtime.trainer import device_batch
    from spsnet_torch.utils.synthetic import synthetic_scene_batch
    pts, gt = synthetic_scene_batch(seed, b, N)
    return device_batch({'points': pts, 'gt_boxes': gt}, device)


def _kitti_optimizer(opt, params):
    """``opt`` (a config's OPTIMIZATION) over the 3712 KITTI train frames."""
    from spsnet_torch.runtime.optimization import build_optimizer
    return build_optimizer(opt, params,
                           KITTI_TRAIN_FRAMES // int(opt.BATCH_SIZE_PER_GPU),
                           int(opt.NUM_EPOCHS))


def build_trainer(cfg, device, generator_seed, preprocess=None):
    """The detector of ``cfg`` with seeded D-FPS in train mode, its
    adam_onecycle optimizer over the KITTI schedule, and its train step
    (behind ``preprocess``, SPSNet's stability hook, when given)."""
    from spsnet_torch.models import build_detector
    from spsnet_torch.runtime.trainer import make_train_step
    model = build_detector(
        cfg.MODEL, len(cfg.CLASS_NAMES), device=device,
        generator=torch.Generator().manual_seed(generator_seed),
        fps_seeding=seeding()).train()
    optimizer = _kitti_optimizer(cfg.OPTIMIZATION, model.parameters())
    return model, optimizer, make_train_step(model, optimizer, preprocess)


def build_spsnet_trainer(device, kept=None):
    """SPSNet.yaml in train mode (``build_trainer``) behind the frozen
    stability preprocess of phase 10 (generator weights from seed 1); with
    ``kept``, the preprocess appends each batch's kept point count to it.
    Returns (model, optimizer, step, preprocess)."""
    from spsnet_torch.runtime.trainer import make_stability_preprocess
    from spsnet_torch.zoo import spsnet_kitti_cfg
    cfg = spsnet_kitti_cfg()
    pre = make_stability_preprocess(cfg.MODEL.STABILITY_HOOK, device,
                                    torch.Generator().manual_seed(1))

    def recorded(batch, generator):
        out = pre(batch, generator)
        if kept is not None:
            kept.append(out['points'].shape[1])
        return out
    return (*build_trainer(cfg, device, 0, recorded), pre)


def build_stability_trainer(device, seed=0):
    """The stability model of ``tools/cfgs/stability/sf_unc.yaml`` at full
    width (npoint 16384, MSG 0.2 / 0.8, 64-wide aggregation, latent 8) with
    seeded random weights, its OPTIMIZATION over the KITTI schedule and
    ``make_stability_train_step``; returns (model, optimizer, step)."""
    from spsnet_torch.models.blocks import init_weights
    from spsnet_torch.stability import (GenerateCenter,
                                        make_stability_train_step)
    from spsnet_torch.zoo import stability_cfg
    cfg = stability_cfg()
    model = GenerateCenter(cfg.MODEL)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    optimizer = _kitti_optimizer(cfg.OPTIMIZATION, model.parameters())
    return model, optimizer, make_stability_train_step(model, optimizer,
                                                       seed)


def _foreground_share(batches):
    """The share of the stability model's points that its targets call
    foreground (``assign_stability_targets``; its SA layer keeps every
    point in order)."""
    from spsnet_torch.stability import assign_stability_targets
    fg = [assign_stability_targets(b['points'][..., :3], b['gt_boxes'])[0]
          for b in batches]
    return float(torch.cat(fg).float().mean())


def _finite_grads(model):
    return bool(torch.stack([torch.isfinite(p.grad).all()
                             for p in model.parameters()]).all())


def train_path(model, step, batches, want, after_step=None):
    """Train steps over ``batches``, each checked: finite loss terms and
    gradients, ``want`` launches of each kernel a step, and
    ``after_step()`` when given. Returns (ms per step, launch counts of the
    run)."""
    from spsnet_torch.ops import _build
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    torch.cuda.synchronize()
    _build.reset_launches()
    times = []
    for batch in batches:
        seen = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        loss, tb = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        n = {k: _build.LAUNCHES[k] - seen[k] for k in _build.LAUNCHES}
        if n != {k: want.get(k, 0) for k in n} or set(want) - set(n):
            raise AssertionError(f'launches in a train step: {n}, want {want}')
        if not torch.isfinite(loss) or not all(
                torch.isfinite(v).all() for v in tb.values()
                if torch.is_tensor(v)) or not _finite_grads(model):
            raise AssertionError(f'non-finite loss or gradient: {float(loss)}')
        if after_step is not None:
            after_step()
        log(f'  step {len(times)}: {times[-1]:.3f} ms, loss {float(loss):.4f}')
    for name, p in model.named_parameters():
        if torch.equal(p.detach(), before[name]):
            raise AssertionError(f'{name} did not move in {len(times)} steps')
    return times, dict(_build.LAUNCHES)


@contextlib.contextmanager
def dfps_picks():
    """Record the D-FPS picks of the SA layers (seeded where it engages)."""
    from spsnet_torch.models import samplers
    own = samplers.sample_dfps
    picks = []

    def sampler(*args, **kwargs):
        idx, stds = own(*args, **kwargs)
        picks.append(idx)
        return idx, stds

    samplers.sample_dfps = sampler
    try:
        yield picks
    finally:
        samplers.sample_dfps = own


def _step_difference(a, b, lr):
    """Gradients (relative L2 of all of them at once, and their cosine) and
    updated parameters (largest difference, entries beyond PARAM_ATOL) of
    model ``a`` against model ``b`` after one step."""
    ga = torch.cat([p.grad.detach().cpu().double().flatten()
                    for p in a.parameters()])
    gb = torch.cat([p.grad.detach().double().flatten()
                    for p in b.parameters()])
    d = torch.cat([(pa.detach().cpu() - pb.detach()).abs().flatten()
                   for pa, pb in zip(a.parameters(), b.parameters())])
    return {'grad_rel_l2': float((ga - gb).norm() / gb.norm()),
            'grad_cos': float(ga @ gb / ga.norm() / gb.norm()),
            'param_max': float(d.max()),
            'param_beyond': int((d > PARAM_ATOL).sum()), 'params': d.numel(),
            'two_lr': 2 * lr}


def _require_step_within(card, base, lr):
    """The card's step (``_step_difference`` against the CPU's) within
    TRAIN_GRAD_FACTOR times the jitter baseline ``base`` and within the
    fixed ceilings, no entry beyond 2 lr. Returns the two limits."""
    grad_limit = min(TRAIN_GRAD_FACTOR * base['grad_rel_l2'],
                     TRAIN_GRAD_CEIL)
    beyond_limit = min(TRAIN_GRAD_FACTOR * base['param_beyond'],
                       TRAIN_BEYOND_CEIL * card['params'])
    note = (f'gradients\' relative L2 {card["grad_rel_l2"]:.4e} (limit '
            f'{grad_limit:.4e}: {TRAIN_GRAD_FACTOR} x the baseline or '
            f'{TRAIN_GRAD_CEIL}, the less), {card["param_beyond"]} '
            f'parameters beyond {PARAM_ATOL} (limit {beyond_limit:.0f}: '
            f'{TRAIN_GRAD_FACTOR} x the baseline or {TRAIN_BEYOND_CEIL} of '
            f'them, the less), largest update difference '
            f'{card["param_max"]:.4e} (2 lr {2 * lr:.4e})')
    if card['grad_rel_l2'] > grad_limit or \
            card['param_beyond'] > beyond_limit or \
            card['param_max'] > 2 * lr * (1 + 1e-3):
        raise AssertionError(f'card vs CPU train step: {note}')
    log(f'  card vs CPU: {note}')
    return {'grad_limit': grad_limit, 'beyond_limit': beyond_limit}


def _require_modules_within(by_module):
    """Each module's gradient relative L2 card vs CPU (``by_module``: name
    -> [card, baseline]) at most TRAIN_MODULE_CEIL; logs the five largest."""
    top = sorted(by_module, key=lambda k: -by_module[k][0])[:5]
    log(f'  gradient relative L2 of {len(by_module)} modules three names '
        f'deep, the largest five card vs CPU and baseline: ' +
        ', '.join(f'{k} {by_module[k][0]:.4f} / {by_module[k][1]:.4f}'
                  for k in top) + f' (limit {TRAIN_MODULE_CEIL})')
    if by_module[top[0]][0] > TRAIN_MODULE_CEIL:
        raise AssertionError(f'card vs CPU gradients of {top[0]}: relative '
                             f'L2 {by_module[top[0]][0]:.4f} over '
                             f'{TRAIN_MODULE_CEIL}')


def _require_bn_within(stats):
    """The card's BN running statistics' relative L2 against the CPU's
    (``stats[0]``) within TRAIN_GRAD_FACTOR times the jitter baseline's
    (``stats[1]``) and within TRAIN_BN_CEIL. Returns the limit."""
    limit = min(TRAIN_GRAD_FACTOR * stats[1], TRAIN_BN_CEIL)
    note = (f'card vs CPU BN running stats: relative L2 {stats[0]:.3e} '
            f'(limit {limit:.3e}: {TRAIN_GRAD_FACTOR} x the baseline or '
            f'{TRAIN_BN_CEIL}, the less)')
    if stats[0] > limit:
        raise AssertionError(note)
    log(f'  {note}')
    return limit


def train_cpu_phase(build, batch, n_dfps):
    """One train step on one scene (``batch``, on the CPU) on the card and
    on the CPU from the same weights, and on the CPU from weights jittered
    by WEIGHT_JITTER; ``build(device)`` gives (model, optimizer, step),
    whose frozen parts (the stability hook's generator) are the same on
    every device. The CPU runs replay the card's top-k picks
    (``topk_picks``) and stability-hook deletions (``deletion_picks``);
    ``n_dfps`` D-FPS layers run a step."""
    gpu, _, gpu_step = build('cuda')
    cpu, cpu_opt, cpu_step = build('cpu')
    jit, _, jit_step = build('cpu')
    cpu.load_state_dict(gpu.state_dict())
    jit.load_state_dict(gpu.state_dict())
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in jit.parameters():
            p.mul_(1 + WEIGHT_JITTER * torch.randn(p.shape, generator=gen))
    with topk_picks() as picks, dfps_picks() as gpu_dfps, \
            deletion_picks() as dels:
        gpu_loss, gpu_tb = gpu_step({k: v.cuda() for k, v in batch.items()})
    with topk_picks(replay=picks), dfps_picks() as cpu_dfps, \
            deletion_picks(replay=dels) as cpu_dels:
        cpu_loss, cpu_tb = cpu_step(batch)
    with topk_picks(replay=picks), deletion_picks(replay=dels):
        jit_step(batch)
    for (_, g), (_, c) in zip(dels, cpu_dels):
        rel = float(((g.cpu() - c).abs() / c.abs()).max())
        if rel > STDS_RTOL:
            raise AssertionError(f'card vs CPU stds: {rel:.3e} relative over '
                                 f'{STDS_RTOL}')
        log(f'  card vs CPU stds: largest relative difference {rel:.3e} '
            f'(tolerance {STDS_RTOL})')
    if len(gpu_dfps) != n_dfps or len(cpu_dfps) != n_dfps:
        raise AssertionError(f'want {n_dfps} D-FPS layers a step')
    for k, (g, c) in enumerate(zip(gpu_dfps, cpu_dfps)):
        require_equal(g, c, f'card vs CPU train step: seeded D-FPS layer {k} '
                            f'picks {tuple(g.shape)}')
    worst = {}
    for key in ('loss', *sorted(gpu_tb)):
        g = float(gpu_loss if key == 'loss' else gpu_tb[key])
        c = float(cpu_loss if key == 'loss' else cpu_tb[key])
        worst[key] = abs(g - c) / max(abs(c), 1e-12)
        if worst[key] > TRAIN_LOSS_RTOL:
            raise AssertionError(f'card vs CPU {key}: {g} vs {c}')
    log(f'  card vs CPU loss terms: largest relative difference '
        f'{max(worst.values()):.3e} ({max(worst, key=worst.get)}; tolerance '
        f'{TRAIN_LOSS_RTOL})')
    lr = cpu_opt.lr_fn(0)
    card = _step_difference(gpu, cpu, lr)
    base = _step_difference(jit, cpu, lr)
    log(f'  card vs CPU after the step: {card}')
    log(f'  CPU with weights x (1 + {WEIGHT_JITTER} N(0, 1)) vs CPU: {base}')
    _require_step_within(card, base, lr)
    for (name, g), c in zip(gpu.named_buffers(), cpu.buffers()):
        if name.endswith(('running_mean', 'running_var')):
            err = float((g.cpu() - c).abs().max())
            if err > PRED_ATOL + PRED_RTOL * float(c.abs().max()):
                raise AssertionError(f'card vs CPU {name}: {err:.3e}')
    log('  card vs CPU BN running stats: within '
        f'atol {PRED_ATOL} + rtol {PRED_RTOL}')
    return card, base


def build_pointrcnn(device):
    """pointrcnn.yaml at full width on ``device`` (weights from
    ``torch.Generator`` seed 0): its config and the detector. The point
    head's box output layer is scaled by 1e-2: at the seed's scale its
    residuals put each proposal ~1 m off its point (z and width), so that
    ~90% of the RoIs hold no point; scaled, the proposals sit on their
    points at about their class's mean size, as a trained head's do, and
    the RoI stage pools real points."""
    from spsnet_torch.models import build_detector
    from spsnet_torch.zoo import pointrcnn_kitti_cfg
    cfg = pointrcnn_kitti_cfg()
    model = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), device=device,
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.point_head.box_layers[-1].parameters():
            p.mul_(1e-2)
    return cfg, model


def _roi_levels(model, out):
    """The RoI head's SA inputs of a card forward: the pooled canonical
    xyz (B * R, S, 3) and its FPS-picked levels, and how many RoI rows are
    empty or padded (fewer hits than slots)."""
    from spsnet_torch.ops import gather_points
    with torch.no_grad():
        pooled = model.roi_head.roipool(out, out['rois'])
    B, R, S, _ = pooled.shape
    levels = [pooled[..., :3].reshape(B * R, S, 3).contiguous()]
    for idx in out['roi_sa_idx'][:-1]:
        levels.append(gather_points(levels[-1], idx).contiguous())
    rows = levels[0]
    empty = int((rows == 0).all(-1).all(-1).sum())
    padded = int((rows[:, -1] == rows[:, 0]).all(-1).sum()) - empty
    return levels, empty, padded


def pointrcnn_shapes_phase(model, batch, first_layer=1):
    """K1 and K2 vs their plain versions at the shapes a PointRCNN forward
    of ``batch`` (a request's points, or a train batch with its 'rngs' and
    the model in train mode) gives them, on the inputs the card's forward
    produces: FPS at the backbone's layers from ``first_layer`` on
    (serving, 1-3: (8, 4096) -> 1024, (8, 1024) -> 256, (8, 256) -> 64;
    layer 0 is phase 3's call) and at the RoI head's two layers over its
    rows, with empty and padded RoIs ((800, 512) -> 128 and (800, 128) ->
    32 serving); the fused MSG ball query at the four backbone layers and
    the RoI head's two, with event times, device time a call, bounds and
    launch shapes; the four FP layers' K6 calls (``three_nn_call``).
    Returns {'fps': [...], 'ball_query': [...], 'three_nn': [...],
    'errs': {...}}."""
    from spsnet_torch.models import sa_module
    from spsnet_torch.ops import sampling as smp
    from spsnet_torch.ops.grouping import ball_query_multi_kernel
    with calls_of(sa_module, 'three_nn') as nn3, torch.no_grad():
        out = model(batch if isinstance(batch, dict) else {'points': batch})
    res = {'fps': [], 'ball_query': [], 'errs': {'fps': 0.0,
                                                  'ball_query': 0.0}}
    roi, empty, padded = _roi_levels(model, out)
    res['empty_rois'], res['padded_rois'] = empty, padded
    log(f'  RoI rows: {roi[0].shape[0]}, {empty} empty (all zero), {padded} '
        f'more with fewer points than {roi[0].shape[1]} slots')
    bb = model.backbone_3d
    fps_inputs = [(f'backbone layer {k}', out['sa_xyz'][k], m.npoint)
                  for k, m in enumerate(bb.SA_modules) if k >= first_layer]
    fps_inputs += [(f'RoI layer {k}', roi[k], m.npoint)
                   for k, m in enumerate(model.roi_head.SA_modules)
                   if m.npoint is not None]
    for what, xyz, npoint in fps_inputs:
        call = fps_call('fps', smp.farthest_point_sample_kernel,
                        xyz.contiguous(), npoint)
        res['errs']['fps'] = max(res['errs']['fps'], call.pop('err'))
        _cluster_note('fps', call, npoint - 1, seeded=False)
        call['device_ms'] = device_ms(
            lambda x=xyz.contiguous(), m=npoint:
            smp.farthest_point_sample_kernel(x, m), reps=5)
        call['layer'] = what
        log(f'    {what}: device time {call["device_ms"]:.4f} ms a call')
        res['fps'].append(call)
    k2_inputs = [(f'backbone layer {k}', m, out['sa_xyz'][k],
                  out['sa_xyz'][k + 1]) for k, m in enumerate(bb.SA_modules)]
    k2_inputs += [(f'RoI layer {k}', m, roi[k], roi[k + 1])
                  for k, m in enumerate(model.roi_head.SA_modules)
                  if m.npoint is not None]
    for what, module, xyz, ctr in k2_inputs:
        radii, ns = tuple(module.radii), tuple(module.nsamples)
        xyz, ctr = xyz.contiguous(), ctr.contiguous()
        call = ball_query_call(radii, ns, xyz, ctr, what)
        res['errs']['ball_query'] = max(res['errs']['ball_query'],
                                        call.pop('err'))
        call['device_ms'] = device_ms(
            lambda r=radii, n=ns, p=xyz, c=ctr:
            ball_query_multi_kernel(r, n, p, c), reps=5)
        log(f'    device time {call["device_ms"]:.4f} ms a call')
        res['ball_query'].append(call)
    res['three_nn'] = [three_nn_call(args[0].contiguous(),
                                     args[1].contiguous(), f'FP call {i}')
                       for i, (args, _, _) in enumerate(nn3)]
    if len(res['three_nn']) != 4:
        raise AssertionError(f'{len(res["three_nn"])} FP three-NN calls, '
                             'want 4')
    res['k6'] = k6_summary(res['three_nn'], 'the four FP calls')
    return res


def overlap_mask_phase(proposals, stage1):
    """The proposal NMS's overlap mask on the profiled request's sorted
    boxes: how many candidate pairs it tests, the candidate mask against
    the dense one in row blocks (equal, and each one's event time), and the
    greedy loop's event time over it."""
    from spsnet_torch.ops import boxes as tboxes
    seen = []
    real = tboxes.overlap_mask

    def capture(sorted_boxes, thresh):
        seen.append((sorted_boxes, thresh))
        return real(sorted_boxes, thresh)
    tboxes.overlap_mask = capture
    try:
        proposals(stage1)
    finally:
        tboxes.overlap_mask = real
    (sorted_boxes, thresh), = seen
    B_, K, _ = sorted_boxes.shape
    pairs = sum(int(pb.numel())
                for pb, _, _ in tboxes.candidate_pairs(sorted_boxes))
    cand = real(sorted_boxes, thresh)
    dense = tboxes.dense_overlap_mask(sorted_boxes, thresh)
    if not torch.equal(cand, dense):
        raise AssertionError(f'proposal NMS: the candidate mask differs from '
                             f'the dense one at {int((cand != dense).sum())} '
                             f'pairs')
    del dense
    valid = torch.ones((B_, K), dtype=torch.bool, device=cand.device)
    res = {'boxes': [B_, K], 'candidate_pairs': pairs,
           'pairs': B_ * K * (K - 1) // 2,
           'candidate_mask_ms': cuda_ms(lambda: real(sorted_boxes, thresh),
                                        reps=3),
           'dense_mask_ms': cuda_ms(
               lambda: tboxes.dense_overlap_mask(sorted_boxes, thresh),
               reps=1),
           'greedy_loop_ms': cuda_ms(
               lambda: tboxes._greedy_suppress(cand, valid), reps=3)}
    log(f'  proposal NMS overlap mask over ({B_}, {K}) boxes: '
        f'{pairs} candidate pairs of {res["pairs"]}; candidate mask '
        f'{res["candidate_mask_ms"]:.3f} ms, the dense mask in row blocks '
        f'{res["dense_mask_ms"]:.3f} ms (equal masks), greedy loop '
        f'{res["greedy_loop_ms"]:.3f} ms (events)')
    return res


def chunked_fps_phase(xyz):
    """Chunked FPS, 4 slices of (8, 16384) -> 4096: one K1 launch over
    (32, 4096) -> 1024, the CPU's plain picks, its event and device time
    and bound."""
    from spsnet_torch.ops import _build
    from spsnet_torch.ops.sampling import (farthest_point_sample_chunked,
                                           farthest_point_sample_kernel)
    b, n, _ = xyz.shape
    npoint, chunks = n // 4, 4
    what = f'chunked FPS ({b}, {n}) -> {npoint} in {chunks} slices'
    torch.cuda.synchronize()
    _build.reset_launches()
    got = farthest_point_sample_chunked(xyz, npoint, chunks)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    _require_per_call(launches, {'fps': 1}, 1, 'chunked FPS call')
    err = require_equal(got, farthest_point_sample_chunked(
        xyz.cpu(), npoint, chunks), f'{what}: card vs CPU plain')
    ms = cuda_ms(lambda: farthest_point_sample_chunked(xyz, npoint, chunks),
                 reps=10)
    # the call's one K1 launch (its other kernels are the offsets' adds)
    rows = xyz.reshape(chunks * b, n // chunks, 3)
    dev = device_ms(lambda: farthest_point_sample_kernel(
        rows, npoint // chunks), reps=5)
    bnd, by = fps_bound(chunks * b, n // chunks, npoint // chunks)
    log(f'  {what}: {ms:.3f} ms (events), device {dev:.4f} ms, bound '
        f'{bnd:.4f} ms ({by}), {launches["fps"]} FPS launch')
    return {'B': b, 'N': n, 'npoint': npoint, 'chunks': chunks, 'ms': ms,
            'device_ms': dev, 'bound_ms': bnd, 'bound_by': by,
            'launches_per_call': launches['fps'], 'err': err}


def _require_close(a, b, what, atol=PRED_ATOL, rtol=PRED_RTOL):
    a, b = a.cpu(), b.cpu()
    err = float((a - b).abs().max()) if a.numel() else 0.0
    if not torch.allclose(a, b, atol=atol, rtol=rtol):
        raise AssertionError(f'card vs CPU {what}: max abs err {err:.3e} '
                             f'over atol {atol} rtol {rtol}')
    log(f'  card vs CPU {what}: max abs err {err:.3e} (atol {atol}, rtol '
        f'{rtol})')
    return err


def _require_heading_close(theta_g, theta_c, cos_sin):
    """Card vs CPU headings decoded as atan2 of (cos, sin) channels that
    agree within PRED_ATOL + PRED_RTOL (checked before): a change d of the
    (cos, sin) vector turns its angle by at most ~|d| / r, r its length,
    so each heading is held to 2 (PRED_ATOL + PRED_RTOL r) / r, wrapped to
    (-pi, pi]."""
    theta_g, theta_c, cos_sin = theta_g.cpu(), theta_c.cpu(), cos_sin.cpu()
    r = cos_sin.norm(dim=-1).clamp(min=1e-12)
    diff = torch.remainder(theta_g - theta_c + torch.pi, 2 * torch.pi) - \
        torch.pi
    allowed = 2 * (PRED_ATOL + PRED_RTOL * r) / r
    worst = float((diff.abs() / allowed).max())
    if worst > 1.0:
        raise AssertionError(f'card vs CPU point headings: {worst:.3f} of '
                             'the tolerance 2 (atol + rtol r) / r')
    log(f'  card vs CPU point headings: max abs err '
        f'{float(diff.abs().max()):.3e}, at most {worst:.3f} of the '
        f'tolerance 2 (atol + rtol r) / r (r = |(cos, sin)|, smallest '
        f'{float(r.min()):.3e})')


def nms_agrees(card_idx, boxes, scores, valid, thresh, pre, post, what):
    """Card vs CPU NMS over the same (1, K, 7) boxes, (1, K) scores and
    valid mask: the CPU's keep list equals the card's ``card_idx``, or the
    card's is a greedy NMS of the CPU's own IoUs within NMS_IOU_TOL of the
    threshold (the IoUs go through cos and sin, which the two devices may
    round 1 ulp apart). Over the same scores both sort alike, and only the
    boxes up to the last one the card's ``post`` slots report bear on
    them."""
    from spsnet_torch.ops import boxes_iou_bev_fast, nms_bev
    from spsnet_torch.ops.boxes import topk_desc
    keep, _ = nms_bev(boxes, scores, thresh, pre_maxsize=pre,
                      post_maxsize=post, valid=valid)
    card = card_idx.cpu()
    if torch.equal(keep, card):
        log(f'  card vs CPU {what}: identical')
        return
    kept = card[0][card[0] >= 0]
    masked = torch.where(valid[0], scores[0], -torch.inf)
    order = topk_desc(masked, min(pre, masked.shape[0]))[1]
    order = order[torch.isfinite(masked[order])]
    pos = torch.full((masked.shape[0],), -1, dtype=torch.int64)
    pos[order] = torch.arange(order.shape[0])
    last = int(pos[kept].max()) + 1 if kept.numel() == post else \
        order.shape[0]
    iou = boxes_iou_bev_fast(boxes[0, kept], boxes[0, order[:last]])
    before = pos[kept][:, None] < torch.arange(last)[None, :]
    top = torch.where(before, iou, -torch.inf).amax(0)
    is_kept = torch.zeros(last, dtype=torch.bool)
    is_kept[pos[kept]] = True
    slack = max(float(torch.where(is_kept, top - thresh, -1.0).max()),
                float(torch.where(is_kept, -1.0, thresh - top).max()))
    if slack > NMS_IOU_TOL:
        raise AssertionError(f'card vs CPU {what}: the card\'s keep list is '
                             f'no greedy NMS of the CPU\'s IoUs (off by '
                             f'{slack:.3e} > {NMS_IOU_TOL})')
    log(f'  card vs CPU {what}: {int((keep != card).sum())} slots differ; '
        f'the card\'s list is a greedy NMS of the CPU\'s IoUs within '
        f'{slack:.3e} of the threshold; the CPU goes on from the card\'s')


def pointrcnn_cpu_phase(model, cfg, scene):
    """One PointRCNN scene on the card and on the CPU with the same
    weights, stage by stage, each CPU stage from the card's input to it:
    the backbone and point head from the same points (FPS, ball-query and
    three-NN indices identical, features and point predictions within
    tolerance), the proposal NMS over the card's point boxes
    (``nms_agrees``), the pooling over the card's RoIs (pooled points
    identical), the RoI stage over the card's pooled points (FPS and
    ball-query picks identical, rcnn_cls / rcnn_reg within tolerance), the
    decode and the final NMS over the card's refined outputs."""
    from spsnet_torch.models import build_detector
    from spsnet_torch.models.detectors.detector3d import (
        class_agnostic_nms_batch, post_processing)
    from spsnet_torch.ops import gather_points
    from spsnet_torch.ops.grouping import ball_query_multi
    from spsnet_torch.ops.interpolate import three_nn
    cpu = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), device='cpu')
    cpu.load_state_dict(model.state_dict())
    head, cpu_head = model.roi_head, cpu.roi_head
    post = cfg.MODEL.POST_PROCESSING
    with torch.no_grad():
        g = model({'points': scene})
        dets_g = post_processing(g, post)
        c = cpu.point_head(cpu.backbone_3d({'points': scene.cpu()}))
        for k, module in enumerate(cpu.backbone_3d.SA_modules):
            require_equal(g['sa_idx'][k + 1], c['sa_idx'][k + 1],
                          f'card kernel vs CPU plain: backbone layer {k} FPS '
                          'picks')
            ns = tuple(module.nsamples)
            for gi, ci in zip(
                    ball_query_multi(module.radii, ns, g['sa_xyz'][k],
                                     g['sa_xyz'][k + 1]),
                    ball_query_multi(module.radii, ns, c['sa_xyz'][k],
                                     c['sa_xyz'][k + 1])):
                require_equal(gi, ci, f'card kernel vs CPU plain: backbone '
                                      f'layer {k} ball query')
        for i in range(len(c['sa_xyz']) - 1):
            dg, ig = three_nn(g['sa_xyz'][i], g['sa_xyz'][i + 1])
            dc, ic = three_nn(c['sa_xyz'][i], c['sa_xyz'][i + 1])
            require_equal(ig, ic, f'card vs CPU: FP layer {i} three-NN')
            require_equal(dg, dc, f'card vs CPU: FP layer {i} three-NN '
                                  'squared distances, bit for bit')
        for key in ('point_features', 'point_cls_scores'):
            _require_close(g[key], c[key], key)
        ph, ph_c = g['point_head_ret'], c['point_head_ret']
        for key in ('point_cls_preds', 'point_box_preds_raw'):
            _require_close(ph[key], ph_c[key], key)
        _require_close(ph['point_box_preds'][..., :6],
                       ph_c['point_box_preds'][..., :6],
                       'point_box_preds, center and size')
        _require_heading_close(ph['point_box_preds'][..., 6],
                               ph_c['point_box_preds'][..., 6],
                               ph_c['point_box_preds_raw'][..., 6:8])
        nms = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST
        kw = dict(thresh=float(nms.NMS_THRESH), pre=int(nms.NMS_PRE_MAXSIZE),
                  post=int(nms.NMS_POST_MAXSIZE))
        card_idx = class_agnostic_nms_batch(
            ph['point_box_preds'], ph['point_cls_preds'], -1e9,
            kw['thresh'], kw['pre'], kw['post'])['indices']
        scores = torch.sigmoid(ph['point_cls_preds'].cpu()).amax(-1)
        nms_agrees(card_idx, ph['point_box_preds'].cpu(), scores,
                   scores > -1e9, what='proposal NMS indices', **kw)
        rois = g['rois']
        stage1 = {k: g[k].cpu() for k in ('point_coords', 'point_features',
                                           'point_cls_scores')}
        raw_g, empty_g = head.pool(g, rois)
        raw_c, empty_c = cpu_head.pool(stage1, rois.cpu())
        require_equal(empty_g.int(), empty_c.int(), 'card vs CPU: empty RoIs')
        require_equal(raw_g[..., :3], raw_c[..., :3],
                      'card vs CPU: pooled points')
        _require_close(raw_g, raw_c, 'pooled point channels')
        pooled_g = head.roipool(g, rois)
        _require_close(pooled_g, cpu_head.roipool(stage1, rois.cpu()),
                       'pooled points in the canonical frame')
        cls_g, reg_g, picks_g = head.refine(pooled_g)
        cls_c, reg_c, picks_c = cpu_head.refine(pooled_g.cpu())
        xyz = pooled_g[..., :3].reshape(-1, *pooled_g.shape[2:3], 3)
        for k, module in enumerate(cpu_head.SA_modules):
            if module.npoint is None:
                continue
            require_equal(picks_g[k], picks_c[k], f'card kernel vs CPU plain: '
                                                  f'RoI layer {k} FPS picks')
            ctr = gather_points(xyz, picks_g[k]).contiguous()
            ns = tuple(module.nsamples)
            for gi, ci in zip(
                    ball_query_multi(module.radii, ns, xyz.contiguous(), ctr),
                    ball_query_multi(module.radii, ns, xyz.cpu().contiguous(),
                                     ctr.cpu())):
                require_equal(gi, ci, f'card kernel vs CPU plain: RoI layer '
                                      f'{k} ball query')
            xyz = ctr
        _require_close(cls_g, cls_c, 'rcnn_cls')
        _require_close(reg_g, reg_c, 'rcnn_reg')
        _require_close(g['batch_box_preds'],
                       cpu_head.decode(reg_g.cpu(), rois.cpu()),
                       'refined boxes')
        final = {'batch_box_preds': g['batch_box_preds'].cpu(),
                 'batch_cls_preds': g['batch_cls_preds'].cpu(),
                 'batch_roi_labels': g['batch_roi_labels'].cpu(),
                 'has_class_labels': True}
        dets_c = post_processing(final, post)
        scores = torch.sigmoid(final['batch_cls_preds']).amax(-1)
        nms_agrees(dets_g['indices'], final['batch_box_preds'], scores,
                   scores > float(post.SCORE_THRESH),
                   float(post.NMS_CONFIG.NMS_THRESH),
                   int(post.NMS_CONFIG.NMS_PRE_MAXSIZE),
                   int(post.NMS_CONFIG.NMS_POST_MAXSIZE), 'final NMS indices')
        if torch.equal(dets_c['indices'], dets_g['indices'].cpu()):
            for key in ('count', 'labels'):
                require_equal(dets_g[key], dets_c[key],
                              f'card vs CPU final NMS {key}')
    log(f'  {int(dets_g["count"][0])} detections, labels '
        f'{sorted(set(dets_g["labels"][0].tolist()))} from the RoIs; '
        f'{int(empty_g.sum())} of {empty_g.shape[1]} RoIs empty')


def build_pointrcnn_trainer(device):
    """pointrcnn.yaml in train mode as ``build_pointrcnn`` makes it (seed-0
    weights, the point-box output at 1e-2), its adam_onecycle optimizer
    over the KITTI schedule and ``make_train_step``: (model, optimizer,
    step)."""
    from spsnet_torch.runtime.trainer import make_train_step
    cfg, model = build_pointrcnn(device)
    model.train()
    optimizer = _kitti_optimizer(cfg.OPTIMIZATION, model.parameters())
    return model, optimizer, make_train_step(model, optimizer)


@contextlib.contextmanager
def roi_head_outputs(model):
    """The RoI head's output batch of each forward while open (a forward
    hook; no compute)."""
    outs = []
    handle = model.roi_head.register_forward_hook(
        lambda module, args, out: outs.append(out))
    try:
        yield outs
    finally:
        handle.remove()


def roi_counts(targets, cfg):
    """The sampled RoIs of a train forward's RoI targets: how many are
    foreground (IoU >= min(REG_FG_THRESH, CLS_FG_THRESH)), hard (CLS_BG_
    THRESH_LO <= IoU < REG_FG_THRESH) and easy background, and how many
    carry regression targets (IoU > REG_FG_THRESH)."""
    iou = targets.gt_iou_of_rois
    fg_t = min(float(cfg.REG_FG_THRESH), float(cfg.CLS_FG_THRESH))
    lo = float(cfg.CLS_BG_THRESH_LO)
    return {'fg': int((iou >= fg_t).sum()),
            'hard': int(((iou >= lo) & (iou < float(cfg.REG_FG_THRESH)))
                        .sum()),
            'easy': int((iou < lo).sum()),
            'reg_valid': int(targets.reg_valid_mask.sum())}


def roi_stats(model, out, cfg):
    """``roi_counts`` of a PointRCNN train forward's RoI-head output, and
    the share of its RoIs with at least one pooled point."""
    with torch.no_grad():
        empty = model.roi_head.pool(out, out['rois'])[1]
    return dict(roi_counts(out['roi_head_ret']['targets'], cfg),
                pooled_share=float((~empty).float().mean()))


def pointrcnn_train_path(batches, smi):
    """Phase 24: PointRCNN training at full width, a warm-up step and the
    timed steps (``train_path``: finite losses and gradients, six FPS and
    six ball-query launches a step, every parameter moves), each step's
    grad norm before the clip, proposal-NMS time and sampled RoIs. Returns
    its record, the model and its step."""
    from spsnet_torch.ops import _build
    model, opt, step = build_pointrcnn_trainer('cuda')
    tcfg = model.model_cfg.ROI_HEAD.TARGET_CONFIG
    log('  the point head\'s box output layer at 1e-2 of its seed-0 weights '
        '(as phase 19), so that the proposals land on their points')
    step(batches[0])
    torch.cuda.synchronize()
    stats, norms = [], []

    def after_step():
        norms.append(float(opt.grad_norm))
        stats.append(roi_stats(model, outs.pop(), tcfg))
        log(f'    grad norm {norms[-1]:.4f} (clip 10); RoIs {stats[-1]}')
    with roi_head_outputs(model) as outs, \
            timed_calls(model.roi_head, 'proposal_layer') as nms_calls:
        times, launches = train_path(
            model, step, batches[1:],
            {**{k: 0 for k in _build.LAUNCHES}, **PRCNN_LAUNCHES},
            after_step)
    nms = range_ms(nms_calls)
    ms = statistics.median(times)
    log(f'  launches over {len(times)} train steps: {launches}')
    log(f'  ms/train step (B={PRCNN_TRAIN_B}, N={N}, backbone + point head '
        f'+ proposal NMS (pre 9000, post 512) + RoI sampling + pooling + RoI '
        f'head + both losses + backward + adam_onecycle): median {ms:.3f}, '
        f'range {min(times):.3f}-{max(times):.3f}, all '
        f'{[round(t, 3) for t in times]}; steps/s {1e3 / ms:.3f} on {smi}')
    share = [host / total for (host, _), total in zip(nms, times)]
    log(f'  proposal NMS a step: host ms {[round(h, 3) for h, _ in nms]}; '
        f'share of the step {min(share):.3f}-{max(share):.3f}')
    fg = [s['fg'] for s in stats]
    log(f'  RoIs a step of {PRCNN_TRAIN_B * int(tcfg.ROI_PER_IMAGE)}: fg '
        f'{min(fg)}-{max(fg)}, with regression targets '
        f'{max(s["reg_valid"] for s in stats)} at most, pooled share '
        f'{min(s["pooled_share"] for s in stats):.4f}-'
        f'{max(s["pooled_share"] for s in stats):.4f}')
    return {'ms': ms, 'all_ms': times, 'launches': launches,
            'grad_norms': norms, 'roi_stats': stats,
            'nms_host_ms': [h for h, _ in nms], 'nms_share': share}, \
        model, step


def _rounding_slack(d2, e):
    """How far a squared distance d2 between two points may move when
    each coordinate of both moves by at most e: |d| moves by up to
    2 sqrt(3) e = s, d2 by 2 |d| s + s^2."""
    s = 2 * 3 ** 0.5 * e
    return 2 * d2.clamp(min=0).sqrt() * s + s * s


def fps_within(xyz, picks, e):
    """Largest ratio, over the steps of every row, of how far the picks'
    minimum distance falls short of the farthest point's to the rounding
    slack ``_rounding_slack`` of inputs ``e`` apart: at most 1 when
    ``picks`` (R, M) is an FPS of (R, N, 3) ``xyz`` up to that rounding."""
    x = xyz.double()
    if not (picks[:, 0] == 0).all():
        return float('inf')
    mind = torch.full(x.shape[:2], float('inf'), dtype=torch.float64)
    worst = 0.0
    for i in range(1, picks.shape[1]):
        last = x.gather(1, picks[:, i - 1, None, None].expand(-1, 1, 3))
        mind = torch.minimum(mind, ((x - last) ** 2).sum(-1))
        best = mind.amax(-1)
        short = best - mind.gather(1, picks[:, i, None])[:, 0]
        worst = max(worst, float((short / _rounding_slack(best, e)).max()))
    return worst


def ball_within(xyz, ctr, radius, card, own, e):
    """Largest ratio, over the (row, center) lists where the card's
    first-k ball ``card`` differs from ``own``, of how far the first point
    in one list and not the other lies from the sphere to the rounding
    slack of inputs ``e`` apart (0 when none differ)."""
    rows, cols = (card != own).any(-1).nonzero(as_tuple=True)
    worst = 0.0
    for r, c in zip(rows.tolist(), cols.tolist()):
        p = min(set(card[r, c].tolist()) ^ set(own[r, c].tolist()))
        d2 = ((xyz[r, p].double() - ctr[r, c].double()) ** 2).sum()
        worst = max(worst, float((d2 - radius ** 2).abs() /
                                 _rounding_slack(d2, e)))
    return worst


def pool_within(points, rois, ref_rois, extra, card, own):
    """Largest ratio, over the RoIs whose pooled point lists ``card`` and
    ``own`` (B, R, S) differ, of how far the first point in one list and
    not the other lies from the nearest face of its RoI (enlarged by
    ``extra``, in this run's frame) to the slack by which the RoI moved
    against ``ref_rois``: its center by |dc|, its size by |ds| and its
    heading by |dh| move a point r from the center by up to sqrt(3) |dc|
    + |ds| / 2 + r |dh| along an axis (0 when none differ)."""
    from spsnet_torch.utils import box_utils
    ext = box_utils.enlarge_box3d(rois, extra)
    d = (rois - ref_rois).abs()
    worst = 0.0
    for b, r in zip(*(card != own).any(-1).nonzero(as_tuple=True)):
        b, r = int(b), int(r)
        p = min(set(card[b, r].tolist()) ^ set(own[b, r].tolist()))
        box = ext[b, r]
        local = box_utils.points_to_box_local(points[b, p][None, None],
                                              box[None, None])[0, 0, 0]
        face = float((local.abs() - box[3:6] / 2).abs().min())
        dist = float((points[b, p] - box[:3]).norm())
        slack = 3 ** 0.5 * float(d[b, r, :3].max()) + \
            float(d[b, r, 3:6].max()) / 2 + dist * float(d[b, r, 6]) + 1e-5
        worst = max(worst, face / slack)
    return worst


class PrcnnDecisions:
    """The discrete decisions of a PointRCNN train step, in call order: the
    FPS picks and ball-query indices of the six SA layers, the three-NN of
    the four FP layers, the proposal NMS's keep list, each RoI's best IoU
    and gt (the sampling's input), the sampled RoIs and the points each
    sampled RoI pools. ``mode`` 'record'
    (the card) keeps them with their inputs; 'check' (the CPU) holds each
    to ``ref``'s, a recorded run: equal where the inputs are equal, else
    within the rounding of inputs that far apart (FPS, ball query: the
    inputs of the RoI layers come from the RoIs; the pooling: the RoIs
    themselves), a greedy NMS of this
    run's IoUs within NMS_IOU_TOL (``nms_agrees``), IoUs within
    NMS_IOU_TOL where they lie that close to a sampling threshold; then it
    goes on from ``ref``'s. 'replay' (the jittered CPU baseline) takes
    ``ref``'s without a check. ``used`` keeps what the run went on from."""

    def __init__(self, mode, ref=None, thresholds=()):
        self.mode, self.ref, self.thresholds = mode, ref, thresholds
        self.used = {k: [] for k in ('fps', 'ball', 'three_nn', 'nms',
                                     'max_iou', 'sampled', 'pool')}
        self.inputs = {'fps': [], 'ball': [], 'pool': [], 'max_iou': []}
        self.notes = []
        self.differ = {'fps': 0, 'ball': 0, 'pool': 0}

    def _ref(self, kind):
        return self.ref.used[kind][len(self.used[kind])]

    def _inputs_apart(self, kind, *tensors):
        ref = self.ref.inputs[kind][len(self.used[kind])]
        return max(float((a.detach().cpu() - b.detach().cpu()).abs().max())
                   for a, b in zip(ref, tensors))

    def fps(self, real, xyz, npoint, *args, **kwargs):
        own = real(xyz, npoint, *args, **kwargs)
        if self.mode == 'record':
            self.inputs['fps'].append((xyz.detach().cpu(),))
            return self._use('fps', own)
        want = self._ref('fps').to(own.device)
        if self.mode == 'check' and not torch.equal(own, want):
            self.differ['fps'] += 1
            e = self._inputs_apart('fps', xyz)
            ratio = fps_within(xyz.detach().cpu(), want.cpu(), e) if e > 0 \
                else float('inf')
            rows = int((own != want).any(-1).sum())
            self.notes.append(f'FPS call {len(self.used["fps"])} '
                              f'{tuple(own.shape)}: {rows} rows differ; '
                              f'inputs {e:.3e} apart; the card\'s picks an '
                              f'FPS of the CPU\'s points within {ratio:.3f} '
                              'of the rounding slack')
            if ratio > 1:
                raise AssertionError(self.notes[-1])
        return self._use('fps', want)

    def ball(self, real, radii, nsamples, xyz, new_xyz):
        own = real(radii, nsamples, xyz, new_xyz)
        if self.mode == 'record':
            self.inputs['ball'].append((xyz.detach().cpu(),
                                        new_xyz.detach().cpu()))
            return self._use('ball', own)
        want = tuple(w.to(o.device) for w, o in zip(self._ref('ball'), own))
        if self.mode == 'check' and not all(
                torch.equal(o, w) for o, w in zip(own, want)):
            self.differ['ball'] += 1
            e = self._inputs_apart('ball', xyz, new_xyz)
            ratio = max(ball_within(xyz.detach().cpu(), new_xyz.detach().cpu(),
                                    r, w.cpu(), o.cpu(), e)
                        for r, w, o in zip(radii, want, own)) if e > 0 \
                else float('inf')
            self.notes.append(f'ball query call {len(self.used["ball"])}: '
                              f'inputs {e:.3e} apart; each differing list '
                              f'within {ratio:.3f} of the rounding slack')
            if ratio > 1:
                raise AssertionError(self.notes[-1])
        return self._use('ball', want)

    def three_nn(self, real, unknown, known):
        own = real(unknown, known)
        if self.mode == 'record':
            return self._use('three_nn', own)
        want = tuple(w.to(o.device) for w, o in zip(self._ref('three_nn'),
                                                    own))
        if self.mode == 'check':
            for o, w, what in zip(own, want, ('squared distances', 'indices')):
                if not torch.equal(o, w):
                    raise AssertionError(f'card vs CPU three-NN {what} of FP '
                                         f'call {len(self.used["three_nn"])}')
        return self._use('three_nn', want)

    def nms(self, real, boxes, scores, thresh, pre_maxsize=4096,
            post_maxsize=500, valid=None):
        own = real(boxes, scores, thresh, pre_maxsize=pre_maxsize,
                   post_maxsize=post_maxsize, valid=valid)
        if self.mode == 'record':
            return self._use('nms', own)
        want = tuple(w.to(o.device) for w, o in zip(self._ref('nms'), own))
        if self.mode == 'check':
            # nms_agrees takes the package's nms_bev: the real one
            import spsnet_torch.ops as ops_pkg
            hooked, ops_pkg.nms_bev = ops_pkg.nms_bev, real
            try:
                nms_agrees(want[0], boxes.detach(), scores.detach(), valid,
                           thresh, pre_maxsize, post_maxsize,
                           'proposal NMS (train) indices')
            finally:
                ops_pkg.nms_bev = hooked
        return self._use('nms', want)

    def max_iou(self, real, rois, labels, gt):
        own = real(rois, labels, gt)
        if self.mode == 'record':
            self.inputs['max_iou'].append(rois.detach().cpu())
            return self._use('max_iou', own)
        ref_iou, ref_idx = (t.detach().to(own[0].device)
                            for t in self._ref('max_iou'))
        ref_rois = self.ref.inputs['max_iou'][len(self.used['max_iou'])]
        self.inputs['max_iou'].append(rois.detach().cpu())
        apart = (rois.detach().cpu() - ref_rois).abs().flatten(0, -2).amax(0)
        self.notes.append(f'RoIs (the proposals), {self.mode} run against '
                          'its reference, largest difference of x, y, z, '
                          'dx, dy, dz, heading: ' +
                          ', '.join(f'{float(v):.3e}' for v in apart))
        if self.mode == 'replay':
            return self._use('max_iou', (ref_iou, ref_idx))
        iou, idx = own
        diff = (iou.detach() - ref_iou).abs()
        near = torch.zeros_like(diff, dtype=torch.bool)
        for t in self.thresholds:
            near |= (iou.detach() - t).abs() <= NMS_IOU_TOL
        if (diff[near] > NMS_IOU_TOL).any() or not torch.equal(
                idx[iou > 0], ref_idx[iou > 0]):
            raise AssertionError('card vs CPU RoI max IoU: a gt differs, or '
                                 'an IoU near a threshold moved more than '
                                 f'{NMS_IOU_TOL}')
        replaced = near & (diff > 0)
        self.notes.append(
            f'RoI max IoU: largest card vs CPU difference '
            f'{float(diff.max()):.3e}; {int(near.sum())} within '
            f'{NMS_IOU_TOL} of a threshold {self.thresholds}, '
            f'{int(replaced.sum())} of them take the card\'s value')
        mixed = torch.where(near, ref_iou, iou.detach())
        return self._use('max_iou', (iou + (mixed - iou).detach(), idx))

    def pool(self, real, points, rois, num_sampled_points, extra):
        own = real(points, rois, num_sampled_points, extra)
        if self.mode == 'record':
            self.inputs['pool'].append((points.detach().cpu(),
                                        rois.detach().cpu()))
            return self._use('pool', own)
        want = tuple(w.to(o.device) for w, o in zip(self._ref('pool'), own))
        if self.mode == 'check' and not all(
                torch.equal(o, w) for o, w in zip(own, want)):
            self.differ['pool'] += 1
            ref_points, ref_rois = self.ref.inputs['pool'][len(
                self.used['pool'])]
            ratio = pool_within(points.detach().cpu(), rois.detach().cpu(),
                                ref_rois, extra, want[0].cpu(), own[0].cpu())
            self.notes.append(
                f'RoI pooling: {int((own[0] != want[0]).any(-1).sum())} of '
                f'{own[0].shape[0] * own[0].shape[1]} RoIs pool other '
                f'points; each first such point within {ratio:.3f} of the '
                'rounding slack of a face')
            if ratio > 1:
                raise AssertionError(self.notes[-1])
        return self._use('pool', want)

    def sampled(self, real, *args, **kwargs):
        return self._use('sampled', real(*args, **kwargs))

    def _use(self, kind, value):
        self.used[kind].append(value)
        return value


@contextlib.contextmanager
def prcnn_decisions(decisions):
    """Route the decision points of a PointRCNN train step through
    ``decisions`` (``PrcnnDecisions``) while open."""
    import spsnet_torch.ops as ops_pkg
    from spsnet_torch.models import sa_module
    from spsnet_torch.models.dense_heads import anchor_head
    from spsnet_torch.models.roi_heads import roi_utils
    from spsnet_torch.models.dense_heads import center_head, center_head_iou
    from spsnet_torch.models.model_utils import vector_pool
    from spsnet_torch.models.pfe import voxel_set_abstraction as vsa
    hooks = [(ops_pkg, 'farthest_point_sample', decisions.fps),
             (ops_pkg, 'ball_query_multi', decisions.ball),
             (sa_module, 'three_nn', decisions.three_nn),
             (vector_pool, 'three_nn', decisions.three_nn),
             (ops_pkg, 'nms_bev', decisions.nms),
             (roi_utils, 'max_iou_with_same_class', decisions.max_iou),
             (roi_utils, 'roi_point_indices', decisions.pool),
             (roi_utils, 'subsample_rois', decisions.sampled)]
    if hasattr(decisions, 'dir_bins'):
        hooks.append((anchor_head, 'direction_bins', decisions.dir_bins))
    if hasattr(decisions, 'topk'):
        hooks += [(center_head_iou, 'topk_desc', decisions.topk),
                  (center_head, 'topk_desc', decisions.topk)]
    if hasattr(decisions, 'cube'):
        hooks += [(vsa, 'sample_points_with_roi_mask', decisions.roi_mask),
                  (vsa, 'point_sectors', decisions.sectors),
                  (vector_pool, 'cube_query', decisions.cube),
                  (vector_pool, 'bin_neighbours', decisions.bins)]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in hooks]
    for (owner, name, hook), (_, _, real) in zip(hooks, saved):
        setattr(owner, name,
                lambda *a, _h=hook, _r=real, **k: _h(_r, *a, **k))
    try:
        yield decisions
    finally:
        for owner, name, real in saved:
            setattr(owner, name, real)


def _grad_rel_l2(a, b, prefix):
    """Relative L2 of model ``a``'s gradients against model ``b``'s (on
    the CPU) over the parameters under ``prefix``."""
    ga, gb = ([p.grad.detach().cpu().double().flatten()
               for n, p in m.named_parameters() if n.startswith(prefix)]
              for m in (a, b))
    ga, gb = torch.cat(ga), torch.cat(gb)
    if float(gb.norm()) == 0:
        return 0.0 if float(ga.norm()) == 0 else float('inf')
    return float((ga - gb).norm() / gb.norm())


def _grad_by_module(models, cpu):
    """The gradient relative L2 of each of ``models`` against ``cpu`` over
    each module three names deep (``backbone_3d.SA_modules.0``,
    ``roi_head.cls_layers.0``): name -> [one a model]."""
    names = [n for n, _ in cpu.named_parameters()]
    parts = sorted({'.'.join(n.split('.')[:3]) for n in names})
    return {part: [_grad_rel_l2(a, cpu, part if part in names
                                else part + '.') for a in models]
            for part in parts}


def _bn_stats_rel_l2(a, b, prefix=''):
    """Relative L2 of model ``a``'s BatchNorm running means and variances
    (those under ``prefix``) against model ``b``'s (on the CPU)."""
    sa, sb = ([t.detach().cpu().double().flatten()
               for n, t in m.named_buffers()
               if n.startswith(prefix)
               and n.endswith(('running_mean', 'running_var'))]
              for m in (a, b))
    sa, sb = torch.cat(sa), torch.cat(sb)
    return float((sa - sb).norm() / sb.norm())


def pointrcnn_train_cpu_phase(batch):
    """Phase 26: one PointRCNN train step on one scene (``batch``, on the
    CPU) on the card and on the CPU from the same weights and the same RoI
    draws (the step's CPU generator), and on the CPU from weights jittered
    by WEIGHT_JITTER. Every decision the CPU makes is held to the card's
    (``PrcnnDecisions``) and the CPU goes on from the card's; the jittered
    run replays the CPU's. Then the loss terms, the gradients and the
    updated parameters as ``train_cpu_phase`` holds them, and the BN
    running statistics to TRAIN_GRAD_FACTOR times the baseline's relative
    L2 or TRAIN_BN_CEIL, the less (the RoI towers normalise 128 RoIs,
    whose features move with the RoIs' frames). Returns the card's and
    the baseline's differences, the limits and the notes."""
    from spsnet_torch.zoo import pointrcnn_kitti_cfg
    tcfg = pointrcnn_kitti_cfg().MODEL.ROI_HEAD.TARGET_CONFIG
    thresholds = tuple(float(tcfg[k]) for k in (
        'CLS_BG_THRESH_LO', 'CLS_BG_THRESH', 'REG_FG_THRESH',
        'CLS_FG_THRESH'))
    gpu, _, gpu_step = build_pointrcnn_trainer('cuda')
    cpu, cpu_opt, cpu_step = build_pointrcnn_trainer('cpu')
    jit, _, jit_step = build_pointrcnn_trainer('cpu')
    cpu.load_state_dict(gpu.state_dict())
    jit.load_state_dict(gpu.state_dict())
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in jit.parameters():
            p.mul_(1 + WEIGHT_JITTER * torch.randn(p.shape, generator=gen))
    card = PrcnnDecisions('record')
    with prcnn_decisions(card):
        gpu_loss, gpu_tb = gpu_step({k: v.cuda() for k, v in batch.items()})
    own = PrcnnDecisions('check', card, thresholds)
    with prcnn_decisions(own):
        cpu_loss, cpu_tb = cpu_step(batch)
    jittered = PrcnnDecisions('replay', own)
    with prcnn_decisions(jittered):
        jit_step(batch)
    for note in own.notes + jittered.notes:
        log(f'  {note}')
    n_fps, n_ball = len(card.used['fps']), len(card.used['ball'])
    log(f'  card vs CPU: {n_fps - own.differ["fps"]} of {n_fps} FPS and '
        f'{n_ball - own.differ["ball"]} of {n_ball} ball-query calls '
        f'identical (the others as the notes above say), '
        f'{len(card.used["three_nn"])} three-NN calls identical, bit for '
        'bit')
    if n_fps != 6 or n_ball != 6 or len(card.used['three_nn']) != 4:
        raise AssertionError('want 6 FPS, 6 ball-query and 4 three-NN calls '
                             'a PointRCNN train step')
    for k, (g, c) in enumerate(zip(card.used['sampled'],
                                   own.used['sampled'])):
        require_equal(g, c, f'card vs CPU train step: sampled RoI indices '
                            f'{tuple(g.shape)}')
    worst = {}
    for key in ('loss', *sorted(gpu_tb)):
        g = float(gpu_loss if key == 'loss' else gpu_tb[key])
        c = float(cpu_loss if key == 'loss' else cpu_tb[key])
        worst[key] = abs(g - c) / max(abs(c), 1e-12)
        if worst[key] > TRAIN_LOSS_RTOL:
            raise AssertionError(f'card vs CPU {key}: {g} vs {c}')
    log(f'  card vs CPU loss terms {sorted(gpu_tb)}: largest relative '
        f'difference {max(worst.values()):.3e} ({max(worst, key=worst.get)};'
        f' tolerance {TRAIN_LOSS_RTOL}); card {float(gpu_loss):.6f}, CPU '
        f'{float(cpu_loss):.6f}')
    lr = cpu_opt.lr_fn(0)
    diff = _step_difference(gpu, cpu, lr)
    base = _step_difference(jit, cpu, lr)
    log(f'  card vs CPU after the step: {diff}')
    log(f'  CPU with weights x (1 + {WEIGHT_JITTER} N(0, 1)) vs CPU: {base}')
    limits = _require_step_within(diff, base, lr)
    by_module = _grad_by_module((gpu, jit), cpu)
    _require_modules_within(by_module)
    stats = [_bn_stats_rel_l2(a, cpu) for a in (gpu, jit)]
    log(f'  BN running stats, relative L2: card vs CPU {stats[0]:.3e}, '
        f'baseline {stats[1]:.3e}')
    limits['bn_limit'] = _require_bn_within(stats)
    return {'card': diff, 'baseline': base, 'limits': limits,
            'notes': own.notes, 'by_module': by_module, 'bn_stats': stats,
            'differ': own.differ, 'loss_rel': worst}


def jitter_study() -> int:
    """``--jitter-study``: what sets phase 26's weight-jitter baseline, on
    the CPU alone (phase 26's scene and seed-0 weights, the decisions of
    an unjittered run replayed). Prints the step's global gradient norm
    before the clip and its largest parameter's share; the clipped
    gradients' relative L2 after jitters of 1e-6 (three seeds), 1e-7 and
    1e-8; the same with the RoIs detached from the first stage (so no RoI
    loss reaches the point head); and the same jitters with the CPU
    BatchNorm's former form, ``F.batch_norm``'s statistics."""
    import torch.nn.functional as F
    from spsnet_torch.models import blocks
    from spsnet_torch.models.roi_heads import pointrcnn_head
    batch = _scene_batch(610, 1, 'cpu')
    state = build_pointrcnn_trainer('cpu')[0].state_dict()
    port_bn, proposals = blocks._flax_batch_norm, pointrcnn_head.proposal_layer

    def former_bn(bn, x, dims):
        y = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0,
                         bn.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=dims, unbiased=False)
            m = bn.momentum
            bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
            bn.running_var.copy_((1 - m) * bn.running_var + m * var)
            bn.num_batches_tracked += 1
        return y

    def detached(*args, **kwargs):
        rois, *rest = proposals(*args, **kwargs)
        return (rois.detach(), *rest)

    def run(ref, jitter=0.0, seed=5):
        model, opt, step = build_pointrcnn_trainer('cpu')
        model.load_state_dict(state)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + jitter * torch.randn(p.shape, generator=gen))
        dec = PrcnnDecisions('record' if ref is None else 'replay', ref)
        with prcnn_decisions(dec):
            step(batch)
        return model, dec, opt

    for form, bn, roi_fn in (('the port\'s CPU BatchNorm', port_bn, proposals),
                             ('the RoIs detached', port_bn, detached),
                             ('the former CPU BatchNorm', former_bn,
                              proposals)):
        blocks._flax_batch_norm, pointrcnn_head.proposal_layer = bn, roi_fn
        try:
            ref, dec, opt = run(None)
            grads = {n: float(p.grad.norm()) for n, p in
                     ref.named_parameters()}
            top = max(grads, key=grads.get)
            total = sum(g * g for g in grads.values()) ** 0.5
            log(f'{form}: global gradient norm before the clip '
                f'{float(opt.grad_norm):.4f}; largest {top} '
                f'{grads[top] / total:.4f} of the norm')
            for jitter, seed in ((1e-6, 5), (1e-6, 6), (1e-6, 7), (1e-7, 5),
                                 (1e-8, 5)):
                model, _, jopt = run(dec, jitter, seed)
                d = _step_difference(model, ref, opt.lr_fn(0))
                log(f'  jitter {jitter:g} seed {seed}: gradients\' relative '
                    f'L2 {d["grad_rel_l2"]:.4e}, cosine '
                    f'{d["grad_cos"]:.6f}, norm before the clip '
                    f'{float(jopt.grad_norm):.4f}')
        finally:
            blocks._flax_batch_norm = port_bn
            pointrcnn_head.proposal_layer = proposals
    return 0


# ``--fault-check``: card gradients scaled on purpose in one module (a
# module three names deep, or a group of them by prefix), each of which
# phase 26 or 36 must refuse
PRCNN_FAULTS = (('backbone_3d.SA_modules.0', 1.3),
                ('backbone_3d.FP_modules.0', 1.3),
                ('point_head.cls_layers', 2.0),
                ('point_head.box_layers.0', 1.3),
                ('roi_head.SA_modules.1', 1.3), ('roi_head.cls_layers', 1.3))
PV_FAULTS = (('backbone_3d.conv4', 1.3), ('backbone_2d.blocks.0', 1.3),
             ('dense_head.conv_cls', 1.3), ('pfe.SA_layers.x_conv1', 1.3),
             ('roi_head.cls_layers', 1.3), ('roi_head.reg_layers', 1.3))
VR_FAULTS = (('backbone_3d.conv3', 1.3),
             ('roi_head.roi_grid_pool_layers.x_conv2', 1.3),
             ('roi_head.roi_grid_pool_layers.x_conv4', 1.3),
             ('roi_head.shared_fc_layer', 1.3), ('roi_head.cls_layers', 1.3))
PP_FAULTS = (('backbone_3d.conv4', 1.3), ('dense_head.hm', 1.3),
             ('pfe.SA_layers.x_conv3', 1.3),
             ('roi_head.roi_grid_pool_layer', 1.3))
CPP_FAULTS = (('vfe.pfn_layers.0', 1.3), ('backbone_2d.blocks.0', 1.3),
              ('dense_head.heads_list.0.hm', 1.3))
_FAULT_MODELS = ('pointrcnn', 'pvrcnn', 'voxel_rcnn', 'pvrcnnpp',
                 'centerpoint_pillar', 'centerpoint_dyn_pillar')


def fault_check(models=_FAULT_MODELS) -> int:
    """``--fault-check``: phases 26, 36, 44, 55, 61 and 64 (those of
    ``models``) as they run, then again with the card's gradients of one
    module scaled (``PRCNN_FAULTS``, ``PV_FAULTS``, ``VR_FAULTS``,
    ``PP_FAULTS``, ``CPP_FAULTS`` for both pillar CenterPoints): every
    such run must fail. Returns 1 if one passed."""
    phases = sys.modules[__name__]
    unknown = set(models) - set(_FAULT_MODELS)
    if unknown:
        raise ValueError(f'--fault-check: no such model {sorted(unknown)}')
    missed, n = [], 0

    def faulty(build, at, prefix, factor):
        def wrapped(device, *args, **kwargs):
            out = build(device, *args, **kwargs)
            if device == 'cuda':
                for n, p in out[at].named_parameters():
                    if n.startswith(prefix):
                        p.register_hook(lambda g: g * factor)
            return out
        return wrapped

    def each(name, phase, arg, faults, at):
        log(f'== {name} as it runs')
        phase(arg)
        build = getattr(phases, name)
        for prefix, factor in faults:
            setattr(phases, name, faulty(build, at, prefix, factor))
            real_log, phases.log = phases.log, lambda *a: None
            try:
                phase(arg)
                missed.append(f'{prefix} x {factor}')
                real_log(f'NOT REFUSED: card gradients of {prefix} x '
                         f'{factor}')
            except AssertionError as e:
                real_log(f'refused: card gradients of {prefix} x {factor}: '
                         f'{e}')
            finally:
                phases.log = real_log
                setattr(phases, name, build)

    if 'pointrcnn' in models:
        each('build_pointrcnn_trainer', phases.pointrcnn_train_cpu_phase,
             _scene_batch(610, 1, 'cpu'), PRCNN_FAULTS, 0)
        n += len(PRCNN_FAULTS)
    if 'pvrcnn' in models:
        cfg = build_voxel_detector('pv_rcnn', 'cpu')[0]
        batch = pv_train_batches(cfg, [800, 801])[0][1]
        each('build_pvrcnn_trainer', phases.pvrcnn_train_cpu_phase,
             {k: v[:1].cpu() for k, v in batch.items()}, PV_FAULTS, 1)
        n += len(PV_FAULTS)
    if 'voxel_rcnn' in models:
        cfg = build_voxel_detector('voxel_rcnn_car', 'cpu')[0]
        batch = pv_train_batches(cfg, [900, 901])[0][1]
        each('build_pvrcnn_trainer',
             lambda b: phases.pvrcnn_train_cpu_phase(b, 'voxel_rcnn_car'),
             {k: v[:1].cpu() for k, v in batch.items()}, VR_FAULTS, 1)
        n += len(VR_FAULTS)
    if 'pvrcnnpp' in models:
        cfg = build_pvpp_trainer('cpu', cut=True)[0]
        batch = pv_train_batches(cfg, [1900, 1901], sizes=WAYMO_SIZES,
                                 n=PP_TRAIN_CUT['points'], channels=5)[0][0]
        each('build_pvpp_trainer', phases.pvpp_train_cpu_phase,
             {k: v[:1].cpu() for k, v in batch.items()}, PP_FAULTS, 1)
        n += len(PP_FAULTS)
    for kind in ('centerpoint_pillar', 'centerpoint_dyn_pillar'):
        if kind not in models:
            continue
        name = f'waymo_models/{kind}_1x'
        cfg = build_centerpoint_trainer('cpu', cut=True, name=name)[0]
        batch = pv_train_batches(cfg, [2500, 2501], sizes=WAYMO_SIZES,
                                 n=CP_TRAIN_CUT['points'], channels=5)[0][0]
        each('build_centerpoint_trainer',
             lambda b, name=name: phases.centerpoint_train_cpu_phase(
                 b, name), {k: v[:1].cpu() for k, v in batch.items()},
             CPP_FAULTS, 1)
        n += len(CPP_FAULTS)
    log(f'{n - len(missed)} of {n} faults refused')
    return 1 if missed else 0


def roi_target_loss_phase(fg_in_step, cfg, model):
    """Phases 27 and 37: ``proposal_target_layer`` and
    ``pointrcnn_head_loss`` (``cfg.MODEL.ROI_HEAD``'s, the box coder of
    ``model``'s RoI head) on the card and on the CPU, on RoIs made by jittering
    the gt boxes of two scenes (so that the regression and corner terms
    are not zero) with the same draws: sampled indices identical, targets
    within PRED_ATOL / PRED_RTOL, every loss term non-zero and within
    TRAIN_LOSS_RTOL. ``fg_in_step``: the RoIs with regression targets in
    the train path's steps, which says whether those terms were already
    non-zero there."""
    from spsnet_torch.models.roi_heads.pointrcnn_head import (
        decode_in_roi_frame, pointrcnn_head_loss)
    from spsnet_torch.models.roi_heads.roi_utils import (
        draw_roi_sampling, proposal_target_layer)
    from spsnet_torch.utils.synthetic import synthetic_scene_batch
    head, roi_head = cfg.MODEL.ROI_HEAD, model.roi_head
    tcfg = head.TARGET_CONFIG
    _, gt = synthetic_scene_batch(700, PRCNN_TRAIN_B, N)
    rng = np.random.default_rng(701)
    gt = gt[:, :12]
    R, M = 512, int(tcfg.ROI_PER_IMAGE)
    pick = rng.integers(0, gt.shape[1], (PRCNN_TRAIN_B, R))
    base = np.take_along_axis(gt, pick[..., None], 1)
    scale = rng.choice([0.03, 0.1, 0.3], (PRCNN_TRAIN_B, R, 1))
    rois = base[..., :7].copy()
    rois[..., 0:3] += rng.normal(size=(PRCNN_TRAIN_B, R, 3)) * scale * \
        base[..., 3:6]
    rois[..., 3:6] *= np.exp(rng.normal(size=(PRCNN_TRAIN_B, R, 3)) * scale)
    rois[..., 6] += rng.normal(size=(PRCNN_TRAIN_B, R)) * scale[..., 0]
    inputs = {'rois': rois.astype(np.float32),
              'scores': rng.uniform(size=(PRCNN_TRAIN_B, R)).astype(
                  np.float32),
              'labels': base[..., 7].astype(np.int64),
              'valid': np.ones((PRCNN_TRAIN_B, R), bool), 'gt': gt,
              'cls': rng.normal(size=(PRCNN_TRAIN_B, M, 1)).astype(
                  np.float32),
              'reg': rng.normal(0, 0.1, (PRCNN_TRAIN_B, M, 7)).astype(
                  np.float32)}
    res = {}
    for device in ('cuda', 'cpu'):
        t = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
        draws = draw_roi_sampling(torch.Generator().manual_seed(702),
                                  PRCNN_TRAIN_B, R, M, device)
        targets = proposal_target_layer(draws, t['rois'], t['scores'],
                                        t['labels'], t['valid'], t['gt'],
                                        tcfg)
        loss, tb = pointrcnn_head_loss(
            {'targets': targets, 'rcnn_cls': t['cls'], 'rcnn_reg': t['reg'],
             'batch_box_preds': decode_in_roi_frame(
                 roi_head.box_coder, t['reg'], targets.rois)},
            head.LOSS_CONFIG, roi_head.box_coder)
        res[device] = (targets, loss, tb)
    (tg, lg, tbg), (tc, lc, tbc) = res['cuda'], res['cpu']
    require_equal(tg.sampled, tc.sampled, 'card vs CPU sampled RoIs on '
                                          'jittered gt')
    for field in ('gt_iou_of_rois', 'gt_of_rois', 'rcnn_cls_labels'):
        _require_close(getattr(tg, field), getattr(tc, field),
                       f'RoI targets {field} on jittered gt')
    require_equal(tg.reg_valid_mask.int(), tc.reg_valid_mask.int(),
                  'card vs CPU regression mask on jittered gt')
    for key in sorted(tbc):
        g, c = float(tbg[key]), float(tbc[key])
        if not (c > 0 and abs(g - c) <= TRAIN_LOSS_RTOL * c):
            raise AssertionError(f'card vs CPU {key} on jittered gt: {g} vs '
                                 f'{c}')
    log(f'  RoI loss on jittered gt, card vs CPU: '
        f'{ {k: (float(tbg[k]), float(tbc[k])) for k in sorted(tbc)} }; '
        f'{int(tg.reg_valid_mask.sum())} of {tg.reg_valid_mask.numel()} '
        'RoIs with regression targets')
    branch = 'the train step had RoIs with regression targets' \
        if fg_in_step else 'the train step had no RoI with regression ' \
        'targets: its reg and corner terms were 0, so only this phase ' \
        'tests them'
    log(f'  branch: {branch}')
    return {'branch': 'step' if fg_in_step else 'jittered_gt',
            'terms': {k: [float(tbg[k]), float(tbc[k])] for k in tbc},
            'reg_valid': int(tg.reg_valid_mask.sum())}


def roi_gradient_share(model, batch, params, other, what):
    """The share of ``params``' gradient that reaches them through the
    RoIs, |g_rcnn| / (|g_rcnn| + |g_other|), each loss alone (``other``:
    the tb keys of the first stage's loss terms that reach them), in one
    train forward of ``model`` (in train mode) on the card."""
    from spsnet_torch.runtime.trainer import step_rngs
    out = model(dict(batch, rngs=step_rngs(0)))
    _, tb = model.loss(out)
    params = list(params)
    norms = []
    for loss in (tb['rcnn_loss'], sum(tb[k] for k in other)):
        grads = torch.autograd.grad(loss, params, retain_graph=True,
                                    allow_unused=True)
        norms.append(float(torch.sqrt(sum((g.double() ** 2).sum()
                                          for g in grads if g is not None))))
    share = norms[0] / (norms[0] + norms[1])
    log(f'  {what}: |grad| through the RoIs {norms[0]:.4e}, from '
        f'{" + ".join(other)} {norms[1]:.4e}; share through the RoIs '
        f'{share:.4f}')
    return share


def other_iassd_path(path, n, channels, seed):
    """A Waymo or nuScenes IA-SSD request path: the config at full width
    (weights from seed 0), OTHER_B scans of ``n`` points with ``channels``
    channels in the dataset's range, one warm-up and OTHER_REQUESTS
    requests (one FPS and four ball-query launches a forward); its layer-0
    FPS and four ball queries held to their plain versions on the path's
    inputs, with event and device times. Returns its record."""
    from spsnet_torch.models import build_detector
    from spsnet_torch.ops import sampling as smp
    from spsnet_torch.ops.grouping import ball_query_multi_kernel
    from spsnet_torch.utils.synthetic import synthetic_scan_batch
    from spsnet_torch.zoo import load_yaml_cfg
    cfg = load_yaml_cfg(path)
    model = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), device='cuda',
                           generator=torch.Generator().manual_seed(0),
                           input_channels=channels)
    pc_range = tuple(float(v) for v in cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    requests = []
    for s in range(OTHER_REQUESTS):
        pts = synthetic_scan_batch(seed + s, OTHER_B, n, pc_range)
        extra = np.random.default_rng(seed + s).uniform(
            0, 1, (OTHER_B, n, channels - 4)).astype(np.float32)
        requests.append(torch.from_numpy(
            np.concatenate([pts, extra], -1)).cuda())
    post = cfg.MODEL.POST_PROCESSING
    times, launches = main_path(model, requests, post,
                                {'fps': 1, 'ball_query': 4}, path)
    ms = statistics.median(times)
    log(f'  launches over {OTHER_REQUESTS} requests: {launches}')
    log(f'  ms/batch (B={OTHER_B}, N={n}, {channels} channels, '
        f'{len(cfg.CLASS_NAMES)} classes, forward + NMS): median {ms:.3f}, '
        f'all {[round(t, 3) for t in times]}')
    with torch.no_grad():
        enc = model({'points': requests[0]})['encoder_xyz']
    bb = model.backbone_3d
    npoint = bb.npoint0[0]
    # the plain FPS at (2, 65536) -> 16384 takes seconds a run: one timed
    fps = fps_call('fps', smp.farthest_point_sample_kernel,
                   enc[0].contiguous(), npoint, plain_reps=1)
    err = {'fps': fps.pop('err'), 'ball_query': 0.0}
    _cluster_note('fps', fps, npoint - 1, seeded=False)
    fps['device_ms'] = device_ms(
        lambda: smp.farthest_point_sample_kernel(enc[0].contiguous(),
                                                 npoint), reps=3)
    log(f'    device time {fps["device_ms"]:.4f} ms a call')
    calls = []
    for k, module in enumerate(bb.SA_modules):
        if getattr(module, 'radii', None):
            xyz = enc[bb.layer_inputs[k]].contiguous()
            ctr = enc[k + 1].contiguous()
            call = ball_query_call(module.radii, module.nsamples, xyz, ctr,
                                   f'layer {k}')
            err['ball_query'] = max(err['ball_query'], call.pop('err'))
            call['device_ms'] = device_ms(
                lambda r=tuple(module.radii), s=tuple(module.nsamples),
                p=xyz, c=ctr: ball_query_multi_kernel(r, s, p, c), reps=5)
            log(f'    device time {call["device_ms"]:.4f} ms a call')
            calls.append(call)
    return {'config': path, 'B': OTHER_B, 'N': n, 'channels': channels,
            'ms_per_batch': ms, 'all_ms': times, 'launches': launches,
            'fps': fps, 'ball_query': calls, 'errs': err}


def build_voxel_detector(name, device):
    """``tools/cfgs/kitti_models/{name}.yaml`` (``tools/cfgs/{name}.yaml``
    for a name with its folder) through ``build_detector_from_cfg`` on
    ``device`` (weights from ``torch.Generator`` seed 0): its config and
    the detector."""
    from spsnet_torch.models import build_detector_from_cfg
    from spsnet_torch.zoo import load_yaml_cfg
    path = name if '/' in name else f'kitti_models/{name}'
    cfg = load_yaml_cfg(f'tools/cfgs/{path}.yaml')
    return cfg, build_detector_from_cfg(
        cfg, device=device, generator=torch.Generator().manual_seed(0))


def pv_stages(model, batch):
    """A PV-RCNN forward of ``batch`` stage by stage, without gradients:
    {'rpn': the voxel stack's batch up to the anchor head, 'pfe', 'point',
    'out': the RoI head's}."""
    with torch.no_grad():
        rpn = model.stage_one(batch)
        pfe = model.pfe(rpn)
        point = model.point_head(pfe)
        return {'rpn': rpn, 'pfe': pfe, 'point': point,
                'out': model.roi_head(point)}


def grid_hits(model, out):
    """Share of the valid RoIs' grid points with a keypoint within each
    pool radius (the plain ball query on the card: no kernel launch)."""
    from spsnet_torch.models.roi_heads.pvrcnn_head import roi_grid_points
    from spsnet_torch.ops.grouping import (ball_query_multi_plain,
                                           squared_radius)
    head = model.roi_head
    kp = out['point_coords']
    grid = roi_grid_points(out['rois'][..., :7], head.template)
    B, R, G3, _ = grid.shape
    flat = grid.reshape(B, R * G3, 3).contiguous()
    radii = head.roi_grid_pool_layer.radii
    valid = out['roi_valid'][:, :, None].expand(-1, -1, G3).reshape(B, -1)
    shares = []
    for r, idx in zip(radii, ball_query_multi_plain(radii, (1,) * len(radii),
                                                    kp, flat)):
        d2 = ((kp.gather(1, idx[..., 0, None].expand(-1, -1, 3)) - flat)
              ** 2).sum(-1)
        shares.append(float((d2 < squared_radius(r))[valid].float().mean()))
    return shares


def pvrcnn_path(model, cfg, requests, what):
    """A warm-up and the timed requests (forward + ``post_processing``)
    with the launch counters zeroed just before: one FPS and six ball
    queries a request. Returns its record: ms, launches, kept boxes and
    the RoI grid's keypoint hits of the first request."""
    post = cfg.MODEL.POST_PROCESSING
    times, launches = main_path(model, requests, post, PV_LAUNCHES, what)
    out, dets = detect(model, requests[0], post)
    hits = grid_hits(model, out)
    ms = statistics.median(times)
    b = requests[0]['points'].shape[0]
    rec = {'B': b, 'ms_per_batch': ms, 'all_ms': times,
           'range_ms': [min(times), max(times)], 'launches': launches,
           'kept_boxes': dets['count'].tolist(),
           'valid_rois': out['roi_valid'].sum(1).tolist(),
           'grid_points_with_a_keypoint': hits}
    log(f'  launches over {len(requests)} requests: {launches}')
    log(f'  ms/batch (B={b}, N={N}, voxel stack + anchor head + VSA + '
        f'point head + proposal NMS + RoI-grid head + NMS): median '
        f'{ms:.3f}, range {min(times):.3f}-{max(times):.3f}, all '
        f'{[round(t, 3) for t in times]}; scenes/s {b / ms * 1e3:.2f}')
    log(f'  first request: {rec["kept_boxes"]} boxes kept, '
        f'{rec["valid_rois"]} RoIs; share of their grid points with a '
        f'keypoint within r = {model.roi_head.roi_grid_pool_layer.radii}: '
        f'{[round(h, 4) for h in hits]}')
    return rec


def pvrcnn_shapes_phase(model, batch, batch8=None):
    """K1 and K2 vs their plain versions at the PV-RCNN shapes, on the
    inputs a card forward of ``batch`` (B = 2) produces: FPS (2, 16384) ->
    2048 and, on ``batch8`` when given, (8, 16384) -> 2048; the fused query
    of each VSA source around the keypoints (the raw points, N 16384; each
    sparse level's voxel centers, N 40000 in serving and 16 000 in
    training, the padded ones at 1e6) and of the RoI grid (6^3 centers a
    RoI over 2048 keypoints: 100 proposals a frame in serving, 128
    sampled RoIs in training, where ``batch`` carries the step's
    generators), with event times, device time a call, bounds and launch
    shapes."""
    from spsnet_torch.models.roi_heads.pvrcnn_head import roi_grid_points
    from spsnet_torch.ops import sampling as smp
    from spsnet_torch.ops.grouping import ball_query_multi_kernel
    st = pv_stages(model, batch)
    res = {'fps': [], 'ball_query': [], 'errs': {'fps': 0.0,
                                                  'ball_query': 0.0}}
    for b in (batch, batch8) if batch8 is not None else (batch,):
        xyz = b['points'][..., :3].contiguous()
        npoint = model.pfe.num_keypoints
        call = fps_call('fps', smp.farthest_point_sample_kernel, xyz,
                        npoint)
        res['errs']['fps'] = max(res['errs']['fps'], call.pop('err'))
        _cluster_note('fps', call, npoint - 1, seeded=False)
        call['device_ms'] = device_ms(
            lambda x=xyz, m=npoint: smp.farthest_point_sample_kernel(x, m),
            reps=5)
        call['layer'] = 'VSA keypoints'
        log(f'    device time {call["device_ms"]:.4f} ms a call')
        res['fps'].append(call)
    pfe, kp = model.pfe, st['pfe']['point_coords']
    xyz = batch['points'][..., :3].contiguous()
    inputs = [('VSA raw_points', pfe.SA_rawpoints, xyz, kp)]
    inputs += [(f'VSA {name}', group, pfe.voxel_centers(st['rpn'], name), kp)
               for name, group in pfe.SA_layers.items()]
    out, head = st['out'], model.roi_head
    grid = roi_grid_points(out['rois'][..., :7], head.template)
    inputs.append(('RoI grid', head.roi_grid_pool_layer, kp,
                   grid.reshape(grid.shape[0], -1, 3).contiguous()))
    for what, group, support, ctr in inputs:
        radii, ns = group.radii, group.nsamples
        call = ball_query_call(radii, ns, support, ctr, what)
        res['errs']['ball_query'] = max(res['errs']['ball_query'],
                                        call.pop('err'))
        call['device_ms'] = device_ms(
            lambda r=radii, n=ns, p=support, c=ctr:
            ball_query_multi_kernel(r, n, p, c), reps=5)
        log(f'    device time {call["device_ms"]:.4f} ms a call')
        res['ball_query'].append(call)
    return res


def _cpu_tree(x):
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _cpu_tree(v) for k, v in x.items()}
    return x


def _require_scaled(a, b, what):
    """Card ``a`` vs CPU ``b`` within VOXEL_RTOL relative plus VOXEL_ATOL
    times b's largest entry; returns the largest difference over that
    scale."""
    a, b = a.cpu(), b.cpu()
    scale = float(b.abs().max()) if b.numel() else 0.0
    err = float((a - b).abs().max()) if b.numel() else 0.0
    if not torch.allclose(a, b, rtol=VOXEL_RTOL,
                          atol=VOXEL_ATOL * max(scale, 1e-30)):
        raise AssertionError(f'card vs CPU {what}: max abs err {err:.3e} '
                             f'over rtol {VOXEL_RTOL} + {VOXEL_ATOL} x '
                             f'{scale:.3e}')
    log(f'  card vs CPU {what}: max abs err {err:.3e} (largest entry '
        f'{scale:.3e})')
    return err / max(scale, 1e-30)


def _require_scaled_rows(a, b, what):
    """``_require_scaled`` row by row over the last axis: each row within
    VOXEL_RTOL relative plus VOXEL_ATOL times that row's largest entry (a
    few PV-RCNN++ keypoints carry features of ~1e11, ROADMAP Queue 3,
    beside which a tensor-wide scale would hold the others to nothing).
    Returns the largest scaled difference."""
    a, b = a.detach().cpu(), b.detach().cpu()
    scale = b.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    bad = (a - b).abs() > VOXEL_RTOL * b.abs() + VOXEL_ATOL * scale
    worst = float(((a - b).abs() / scale).max())
    if bad.any():
        raise AssertionError(f'card vs CPU {what}: {int(bad.any(-1).sum())} '
                             f'rows beyond rtol {VOXEL_RTOL} + {VOXEL_ATOL} x '
                             f'their largest entry')
    log(f'  card vs CPU {what}: largest difference {worst:.3e} of its row\'s '
        f'largest entry (rows up to {float(scale.max()):.3e})')
    return worst


def _require_anchor_headings(g, c):
    """Card vs CPU headings of the anchor boxes: the direction bin may
    flip where the CPU's two direction logits lie within the tolerance of
    each other (a heading pi apart); elsewhere within tolerance."""
    hg, hc = g['batch_box_preds'][..., 6].cpu(), c['batch_box_preds'][..., 6]
    dirs = c['anchor_head_ret']['dir_preds']
    tied = (dirs[..., 0] - dirs[..., 1]).abs() <= VOXEL_RTOL + VOXEL_ATOL * \
        float(dirs.abs().max())
    full = torch.remainder(hg - hc + torch.pi, 2 * torch.pi) - torch.pi
    half = torch.remainder(hg - hc + torch.pi / 2, torch.pi) - torch.pi / 2
    tol = VOXEL_RTOL * float(hc.abs().max()) + VOXEL_ATOL
    if (half.abs() > tol).any() or (full.abs()[~tied] > tol).any():
        raise AssertionError('card vs CPU anchor headings differ beyond '
                             'the tolerance')
    flipped = int((full.abs() > tol).sum())
    log(f'  card vs CPU anchor headings: within {tol:.3e} mod pi; '
        f'{flipped} direction bins flipped of {int(tied.sum())} near-tied '
        f'ones')


def _require_topk_order(card_scores, cpu_scores, k, what,
                        tol=CTR_SCORE_TOL):
    """The card's top-k (its NMS's candidates) is a top-k of the CPU's
    scores up to ``tol``: no score outside it above one inside by more
    than that."""
    from spsnet_torch.ops.boxes import topk_desc
    sel = topk_desc(card_scores, k)[1].cpu()
    inside = torch.zeros_like(cpu_scores, dtype=torch.bool).scatter_(
        1, sel, True)
    lo = torch.where(inside, cpu_scores, torch.inf).amin(1)
    hi = torch.where(inside, -torch.inf, cpu_scores).amax(1)
    worst = float((hi - lo).max())
    if worst > tol:
        raise AssertionError(f'card vs CPU {what}: the card\'s top {k} is no '
                             f'top {k} of the CPU\'s scores ({worst:.3e})')
    log(f'  card vs CPU {what}: the card\'s top {k} is a top {k} of the '
        f'CPU\'s scores (the largest score outside over the smallest '
        f'inside: {worst:.3e}, tolerance {tol:.3e})')


def _stage_one_vs_cpu(model, cpu, batch, host, nms, rpn=None):
    """The voxel stack and the anchor head of one request on the card
    (``model``) and on the CPU (``cpu``, the same weights), each CPU stage
    from the card's input to it: voxel features, every sparse level, the
    BEV map (the scatter bit for bit), the BEV backbone and the anchor
    head within VOXEL_RTOL / VOXEL_ATOL; the card's proposal candidates a
    top NMS_PRE_MAXSIZE of the CPU's scores; the proposal NMS at ``nms``
    (``nms_agrees``). ``rpn``: the card's stage-one output, when already
    made. Returns (scaled errors, the card's stage-one batch)."""
    from spsnet_torch.models.detectors.detector3d import \
        class_agnostic_nms_batch
    errs = []
    with torch.no_grad():
        if rpn is None:
            rpn = model.stage_one(batch)
        g = model.vfe(batch)
        c = cpu.vfe(host)
        errs.append(_require_scaled(g['voxel_features'], c['voxel_features'],
                                    'voxel features'))
        g = model.backbone_3d(g)
        c = cpu.backbone_3d(dict(host, voxel_features=g[
            'voxel_features'].cpu()))
        for name, t in c['multi_scale_3d_features'].items():
            errs.append(_require_scaled(
                g['multi_scale_3d_features'][name], t, f'sparse level {name}'))
        errs.append(_require_scaled(g['encoded_voxel_features'],
                                    c['encoded_voxel_features'], 'conv_out'))
        g = model.map_to_bev_module(g)
        c = cpu.map_to_bev_module(_cpu_tree(dict(
            host, **{k: g[k] for k in ('encoded_voxel_features',
                                       'encoded_voxel_coords',
                                       'encoded_voxel_valid')})))
        require_equal(g['spatial_features'], c['spatial_features'],
                      'card vs CPU: the BEV scatter (HeightCompression)')
        g = model.backbone_2d(g)
        c = cpu.backbone_2d({'spatial_features': g['spatial_features'].cpu()})
        errs.append(_require_scaled(g['spatial_features_2d'],
                                    c['spatial_features_2d'],
                                    'BEV backbone'))
        g = model.dense_head(g)
        c = cpu.dense_head({'spatial_features_2d':
                            g['spatial_features_2d'].cpu()})
        for key in ('cls_preds', 'box_preds', 'dir_preds'):
            errs.append(_require_scaled(g['anchor_head_ret'][key],
                                        c['anchor_head_ret'][key],
                                        f'anchor head {key}'))
        errs.append(_require_scaled(g['batch_box_preds'][..., :6],
                                    c['batch_box_preds'][..., :6],
                                    'anchor boxes, centers and sizes'))
        _require_anchor_headings(g, c)
        kw = dict(thresh=float(nms.NMS_THRESH), pre=int(nms.NMS_PRE_MAXSIZE),
                  post=int(nms.NMS_POST_MAXSIZE))
        card_scores = torch.sigmoid(rpn['batch_cls_preds']).amax(-1)
        _require_topk_order(card_scores,
                            torch.sigmoid(c['batch_cls_preds']).amax(-1),
                            kw['pre'], 'proposal candidates (anchor scores)')
        card_idx = class_agnostic_nms_batch(
            rpn['batch_box_preds'], rpn['batch_cls_preds'], -1e9,
            kw['thresh'], kw['pre'], kw['post'])['indices']
        for b in range(card_idx.shape[0]):
            scores = card_scores[b:b + 1].cpu()
            nms_agrees(card_idx[b:b + 1], rpn['batch_box_preds'][b:b + 1]
                       .cpu(), scores, scores > -1e9,
                       what=f'proposal NMS indices, frame {b}', **kw)
    return errs, rpn


def _roi_stage_vs_cpu(model, cpu, roi_in, out, post,
                      decisions=PrcnnDecisions):
    """The RoI head of one request from the card's input ``roi_in`` to it
    and the card's RoIs (``out``: the card's RoI-head output): the
    RoI-grid picks (the grid points rotated on each device) equal or
    within the rounding slack of their inputs, then replayed
    (``PrcnnDecisions``); the pooled features, the refinement, the decoded
    boxes and the final NMS (``post``) within VOXEL_RTOL / VOXEL_ATOL.
    ``decisions``: the class that holds the pool's picks. Returns (scaled
    errors, the replay's notes, differing ball lists, the card's
    detections)."""
    from spsnet_torch.models.detectors.detector3d import post_processing
    from spsnet_torch.models.roi_heads.pointrcnn_head import \
        decode_in_roi_frame
    errs = []
    with torch.no_grad():
        rois = out['rois']
        rec = decisions('record')
        with prcnn_decisions(rec):
            pooled_g = model.roi_head.roi_grid_pool(roi_in, rois)
        chk = decisions('check', ref=rec)
        with prcnn_decisions(chk):
            pooled_c = cpu.roi_head.roi_grid_pool(_cpu_tree(roi_in),
                                                  rois.cpu())
        for note in chk.notes or ['RoI-grid ball query: identical']:
            log(f'  card vs CPU {note}')
        errs.append(_require_scaled(pooled_g, pooled_c,
                                    'RoI-grid pooled features'))
        head = cpu.roi_head
        shared = head.shared_fc_layer(pooled_c)
        ret = out['roi_head_ret']
        errs.append(_require_scaled(ret['rcnn_cls'], head.cls_layers(shared),
                                    'rcnn_cls'))
        errs.append(_require_scaled(ret['rcnn_reg'], head.reg_layers(shared),
                                    'rcnn_reg'))
        errs.append(_require_scaled(
            out['batch_box_preds'],
            decode_in_roi_frame(head.box_coder, ret['rcnn_reg'].cpu(),
                                rois.cpu()), 'refined boxes'))
        dets_g = post_processing(out, post)
        final = _cpu_tree({k: out[k] for k in (
            'batch_box_preds', 'batch_cls_preds', 'batch_roi_labels')})
        final['has_class_labels'] = out['has_class_labels']
        dets_c = post_processing(final, post)
        scores = torch.sigmoid(final['batch_cls_preds']).amax(-1)
        for b in range(scores.shape[0]):
            nms_agrees(dets_g['indices'][b:b + 1],
                       final['batch_box_preds'][b:b + 1], scores[b:b + 1],
                       scores[b:b + 1] > float(post.SCORE_THRESH),
                       float(post.NMS_CONFIG.NMS_THRESH),
                       int(post.NMS_CONFIG.NMS_PRE_MAXSIZE),
                       int(post.NMS_CONFIG.NMS_POST_MAXSIZE),
                       f'final NMS indices, frame {b}')
        if torch.equal(dets_c['indices'], dets_g['indices'].cpu()):
            for key in ('count', 'labels'):
                require_equal(dets_g[key], dets_c[key],
                              f'card vs CPU final NMS {key}')
            errs.append(_require_scaled(dets_g['boxes'], dets_c['boxes'],
                                        'final boxes'))
            errs.append(_require_scaled(dets_g['scores'], dets_c['scores'],
                                        'final scores'))
    log(f'  {dets_g["count"].tolist()} detections, labels '
        f'{sorted(set(dets_g["labels"].flatten().tolist()))}')
    return errs, chk.notes, chk.differ['ball'], dets_g


def pvrcnn_cpu_phase(model, cfg, batch):
    """One PV-RCNN request (B = 2) on the card and on the CPU with the same
    weights and host tables, stage by stage, each CPU stage from the
    card's input to it: the voxel stack and the anchor head with the
    proposal NMS (``_stage_one_vs_cpu``); the VSA's FPS keypoints and
    every source's ball-query indices identical, its features and the
    point head within tolerance; the RoI head (``_roi_stage_vs_cpu``)."""
    from spsnet_torch.ops.grouping import ball_query_multi
    _, cpu = build_voxel_detector('pv_rcnn', 'cpu')
    cpu.load_state_dict(model.state_dict())
    host = _cpu_tree(batch)
    st = pv_stages(model, batch)
    errs, rpn = _stage_one_vs_cpu(model, cpu, batch, host,
                                  cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST,
                                  st['rpn'])
    with torch.no_grad():
        # the VSA from the card's stage-one outputs
        pg = st['pfe']
        pc = cpu.pfe(_cpu_tree(rpn))
        require_equal(pg['keypoint_idx'], pc['keypoint_idx'],
                      'card kernel vs CPU plain: VSA keypoints (FPS)')
        xyz = rpn['points'][..., :3].contiguous()
        sources = [('raw_points', model.pfe.SA_rawpoints, xyz, xyz.cpu())]
        for name, group in model.pfe.SA_layers.items():
            centers = model.pfe.voxel_centers(rpn, name)
            own = cpu.pfe.voxel_centers(_cpu_tree(rpn), name)
            require_equal(centers, own, f'card vs CPU: {name} voxel centers')
            sources.append((name, group, centers, own))
        for name, group, sg, sc in sources:
            for r, gi, ci in zip(group.radii,
                                 ball_query_multi(group.radii,
                                                  group.nsamples, sg,
                                                  pg['point_coords']),
                                 ball_query_multi(group.radii,
                                                  group.nsamples, sc,
                                                  pc['point_coords'])):
                require_equal(gi, ci, f'card kernel vs CPU plain: VSA {name} '
                                      f'ball query r={r}')
        for key in ('point_features_before_fusion', 'point_features'):
            errs.append(_require_scaled(pg[key], pc[key], f'VSA {key}'))
        ph = cpu.point_head(_cpu_tree(pg))
        errs.append(_require_scaled(
            st['point']['point_head_simple_ret']['point_cls_preds'],
            ph['point_head_simple_ret']['point_cls_preds'],
            'point head cls preds'))
    roi_errs, notes, differ, _ = _roi_stage_vs_cpu(
        model, cpu, st['point'], st['out'], cfg.MODEL.POST_PROCESSING)
    return {'max_scaled_err': max(errs + roi_errs), 'roi_grid_notes': notes,
            'ball_lists_differ': differ}


def second_phase(batch, pv_cfg):
    """SECOND (second.yaml, full width, weights from seed 0) on the PV-RCNN
    request's voxel batch (its voxelization settings are pv_rcnn.yaml's):
    a warm-up and three timed requests; no kernel of the port runs."""
    cfg, model = build_voxel_detector('second', 'cuda')
    steps = lambda c: [p for p in c.DATA_CONFIG.DATA_PROCESSOR
                       if p.NAME == 'transform_points_to_voxels']
    if steps(cfg) != steps(pv_cfg):
        raise AssertionError('second.yaml voxelizes unlike pv_rcnn.yaml')
    times, launches = main_path(model, [batch] * 3, cfg.MODEL.POST_PROCESSING,
                                {}, 'SECOND requests')
    ms = statistics.median(times)
    log(f'  ms/batch (B={batch["points"].shape[0]}, voxel stack + anchor head '
        f'+ NMS): median {ms:.3f}, all {[round(t, 3) for t in times]}; '
        f'launches {launches}')
    return {'ms_per_batch': ms, 'all_ms': times, 'launches': launches}


_BEV_CHILD = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[2])
from spsnet_torch.models.backbones_2d.base_bev_backbone import BaseBEVBackbone
from spsnet_torch.models.blocks import init_weights
from spsnet_torch.zoo import pv_rcnn_kitti_cfg
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.benchmark = sys.argv[1] == 'on'
bev = BaseBEVBackbone(pv_rcnn_kitti_cfg().MODEL.BACKBONE_2D, 256)
init_weights(bev, torch.Generator().manual_seed(0))
bev = bev.cuda().eval()
out = {}
with torch.no_grad():
    for b in (2, 8):
        x = {'spatial_features': torch.randn(
            b, 256, 200, 176, generator=torch.Generator().manual_seed(b)
        ).cuda()}
        times = []
        for _ in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            bev(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[b] = times
print(json.dumps(out))
'''


def bev_algorithm_phase():
    """Event ms of pv_rcnn.yaml's BEV backbone on (B, 256, 200, 176) maps,
    B = 2 and 8, with cuDNN's heuristic algorithm choice (``cudnn.benchmark``
    off) and with its timed choice (on, the port's setting), each in a
    process of its own (PyTorch caches the algorithm of a shape's first
    call in either mode, so one process cannot hold both): the first call
    (the choice and its run) and three more. Returns {'off': {B: [ms]},
    'on': {...}}."""
    root = str(Path(__file__).resolve().parent)
    res = {}
    for mode in ('off', 'on'):
        run = subprocess.run([sys.executable, '-c', _BEV_CHILD, mode, root],
                             capture_output=True, text=True, check=True)
        res[mode] = json.loads(run.stdout.strip().splitlines()[-1])
        log(f'  BEV backbone, cudnn.benchmark {mode}: event ms a call, the '
            f'first and three more: ' + '; '.join(
                f'B={b} {[round(t, 3) for t in ts]}'
                for b, ts in res[mode].items()))
    return res


def pvrcnn_profile(model, fn, what, nms_label, head_module=None):
    """A CUDA-kernel breakdown of one call of ``fn`` (a PV-RCNN or Voxel
    R-CNN request or train step of ``model``): the proposal NMS
    (``nms_label``: its settings; ``head_module``'s ``proposal_layer``,
    PV-RCNN's RoI head's by default), the sparse gathers and the BEV
    backbone as ranges (time, kernels, launches), with their shares, and
    the backward's share of the device time."""
    from spsnet_torch.models.backbones_3d import spconv_backbone
    from spsnet_torch.models.roi_heads import pvrcnn_head
    head_module = head_module or pvrcnn_head
    saved = (head_module.proposal_layer, spconv_backbone.sparse_gather)

    def ranged(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    head_module.proposal_layer = ranged('proposal NMS', saved[0])
    spconv_backbone.sparse_gather = ranged('sparse gather', saved[1])
    model.backbone_2d.forward = ranged('BEV backbone',
                                       model.backbone_2d.forward)
    try:
        prof = profile_phase(fn, what, ranges=('proposal NMS',
                                               'sparse gather',
                                               'BEV backbone'))
    finally:
        head_module.proposal_layer, spconv_backbone.sparse_gather = saved
        del model.backbone_2d.forward
    spans = prof['ranges']
    prof['nms_share'] = spans['proposal NMS']['host_ms'] / prof['wall_ms']
    for name in ('sparse gather', 'BEV backbone'):
        spans[name]['device_share'] = spans[name]['device_ms'] / \
            prof['device_ms']
    prof['backward_share'] = prof['backward_device_ms'] / prof['device_ms']
    log(f'  proposal NMS ({nms_label}): '
        f'{spans["proposal NMS"]["host_ms"]:.3f} of {prof["wall_ms"]:.3f} ms '
        f'({prof["nms_share"]:.3f}), {spans["proposal NMS"]["launches"]} '
        f'launches; the rest {prof["launches"] - spans["proposal NMS"]["launches"]}'
        f' launches; sparse gathers {spans["sparse gather"]["device_share"]:.3f}'
        f', BEV backbone {spans["BEV backbone"]["device_share"]:.3f} and the '
        f'backward {prof["backward_share"]:.3f} of the device time')
    return prof


def pvrcnn_phases():
    """Phases 29-33; returns the PV-RCNN record, the kernel calls at its
    shapes and SECOND's record."""
    log('== 29. PV-RCNN serving path')
    pv_cfg, pv = build_voxel_detector('pv_rcnn', 'cuda')
    host = pv_host_batches(pv_cfg, range(700, 700 + PV_BATCHES), PV_B)
    host8 = pv_host_batches(pv_cfg, [710], PV_B8)
    pv_batches, pv8_batches = host['batches'], host8['batches']
    host_ms = host['host_ms'] + host8['host_ms']
    pvrcnn = pvrcnn_path(pv, pv_cfg, [pv_batches[k % PV_BATCHES]
                                      for k in range(PV_REQUESTS)],
                         'PV-RCNN requests (B=2)')
    pvrcnn['b8'] = pvrcnn_path(pv, pv_cfg, pv8_batches * PV_REQUESTS,
                               'PV-RCNN requests (B=8)')
    pvrcnn.update(host_ms_a_frame=host_ms,
                  copy_ms=host['copy_ms'] + host8['copy_ms'],
                  voxels_before_cap=host['before'] + host8['before'])

    log('== 30. kernels vs plain at the PV-RCNN shapes')
    pv_shapes = pvrcnn_shapes_phase(pv, pv_batches[0], pv8_batches[0])

    log('== 31. PV-RCNN card vs CPU, one request (B=2)')
    pvrcnn['card_vs_cpu'] = pvrcnn_cpu_phase(pv, pv_cfg, pv_batches[0])

    log('== 32. SECOND, one request (B=2)')
    second = second_phase(pv_batches[0], pv_cfg)

    log('== 33. where the time goes: one PV-RCNN request')
    post = pv_cfg.MODEL.POST_PROCESSING
    pvrcnn['profile'] = pvrcnn_profile(
        pv, lambda: detect(pv, pv_batches[0], post),
        'one PV-RCNN request (B=2)', 'pre 1024, post 100')
    pvrcnn['bev_algorithm_ms'] = bev_algorithm_phase()
    return pvrcnn, pv_shapes, second


def train_scenes(seed, sizes, b=PV_TRAIN_B, n=N, pc_range=None,
                 channels=4):
    """``b`` synthetic scenes of ``n`` points from ``seed`` in ``pc_range``
    (KITTI's by default), their gt boxes given the classes 1, 2, ... in
    turn, each the size of its class in ``sizes`` (the anchor sizes of a
    config; a KITTI car's mean box) standing on the scene's ground (z
    -1.65), then each frame's points and boxes turned about z by an angle
    drawn from pv_rcnn.yaml's ``random_world_rotation`` range [-pi/4,
    pi/4] (heading + angle); point channels past the fourth uniform in
    [0, 1)."""
    from spsnet_torch.utils.synthetic import (KITTI_RANGE,
                                              synthetic_scene_batch)
    pts, gt = synthetic_scene_batch(seed, b, n, pc_range or KITTI_RANGE)
    cls = np.arange(gt.shape[1]) % len(sizes)
    gt[..., 7] = cls + 1
    gt[..., 3:6] = np.float32(sizes)[cls]
    gt[..., 2] = -1.65 + gt[..., 5] / 2
    rng = np.random.default_rng(seed + 1)
    for k, a in enumerate(rng.uniform(-np.pi / 4, np.pi / 4, b)):
        c, s = np.cos(a), np.sin(a)
        for arr in (pts[k], gt[k]):
            x, y = arr[:, 0].copy(), arr[:, 1].copy()
            arr[:, 0], arr[:, 1] = c * x - s * y, s * x + c * y
        gt[k, :, 6] += a
    if channels > 4:
        pts = np.concatenate([pts, rng.uniform(0, 1, pts.shape[:2] + (
            channels - 4,))], axis=-1)
    return pts.astype(np.float32), gt.astype(np.float32)


def voxels_in_range(scan, data_cfg):
    """The voxels (pillars) a scan's points occupy inside the range, before
    the voxelization's cap: the port's ``transform_points_to_voxels`` with
    a cap of one voxel a point (at the placeholder step's size for the
    dynamic pillar configs)."""
    from spsnet_torch.data.processor.voxelize import \
        transform_points_to_voxels
    step = [p for p in data_cfg.DATA_PROCESSOR
            if p['NAME'].startswith('transform_points_to_voxels')][0]
    return int(transform_points_to_voxels(
        scan, data_cfg.POINT_CLOUD_RANGE, step['VOXEL_SIZE'], len(scan),
        1)['voxel_valid'].sum())


def gt_at_proposals(model, batch, sizes=None):
    """``batch`` with three more gt boxes a frame at the proposals that a
    train-mode forward of a copy of ``model`` makes at NMS_CONFIG.TRAIN,
    with their labels, jittered by 2%: with random weights the anchor
    scores favour one class everywhere, whose anchors seldom reach IoU
    0.55 with a gt of that class, and each update reorders the near-tied
    scores, so without these boxes no RoI would have regression targets
    (the CPU tests make their gt alike). The proposals do not depend on
    the gt. With ``sizes`` (a size a class, as WAYMO_SIZES) the boxes'
    sizes are the proposal's held within a factor GT_SIZE_SPAN of their
    class's size: a CenterHead's decoded sizes are an exp of its size
    logits, which one update at random weights can take to ~1e13 m, and a
    gt box of that size takes the loss to ~1e13."""
    import copy
    from spsnet_torch.models.roi_heads.pointrcnn_head import proposal_layer
    probe = copy.deepcopy(model).train()
    with torch.no_grad():
        rois, _, labels, _ = proposal_layer(
            probe.stage_one({k: v for k, v in batch.items()
                             if k != 'gt_boxes'}),
            model.model_cfg.ROI_HEAD.NMS_CONFIG.TRAIN)
    extra = rois[:, :3].cpu().numpy().copy()
    n = extra.shape[:-1]
    if sizes is not None:
        size = np.asarray(sizes, np.float32)[np.clip(
            labels[:, :3].cpu().numpy().astype(np.int64) - 1, 0,
            len(sizes) - 1)]
        extra[..., 3:6] = np.clip(extra[..., 3:6], size / GT_SIZE_SPAN,
                                  size * GT_SIZE_SPAN)
    rng = np.random.default_rng(12)
    extra[..., 0:3] += rng.normal(0, 0.02, n + (3,)) * extra[..., 3:6]
    extra[..., 3:6] *= np.exp(rng.normal(0, 0.02, n + (3,)))
    extra[..., 6] += rng.normal(0, 0.02, n)
    extra = np.concatenate([extra, labels[:, :3, None].cpu().numpy()], -1)
    gt = batch['gt_boxes']
    return dict(batch, gt_boxes=torch.cat([gt, torch.from_numpy(
        extra.astype(np.float32)).to(gt.device)], 1))


def at_proposals(model, batches, sizes=None):
    """The batches, each completed by ``gt_at_proposals`` with ``model``'s
    weights when it is taken (the step before it has run)."""
    for batch in batches:
        yield gt_at_proposals(model, batch, sizes)


def pv_train_batches(cfg, seeds, sizes=None, n=N, channels=4):
    """Train batches of PV_TRAIN_B ``train_scenes`` of ``n`` points in the
    config's range (one seed a batch; the gt sizes those of the config's
    anchors unless ``sizes``), voxelized and planned by the port's host
    code at the config's train settings (``voxel_batch(mode='train')``
    with the gt boxes; a config that samples points draws from
    ``RandomState(seed)``) and copied to the card. Returns (batches, host
    ms a frame of each, voxels a frame before the cap, voxels a frame after
    it; the dynamic pillar configs have no cap)."""
    from spsnet_torch.data.processor import voxel_batch
    from spsnet_torch.runtime.trainer import device_batch
    if sizes is None:
        sizes = [a['anchor_sizes'][0]
                 for a in cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG]
    batches, host_ms, before, after = [], [], [], []
    for seed in seeds:
        pts, gt = train_scenes(seed, sizes, n=n,
                               pc_range=cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
                               channels=channels)
        t0 = time.perf_counter()
        host = voxel_batch(pts, cfg.DATA_CONFIG, mode='train',
                           gt_boxes=list(gt),
                           rng=np.random.RandomState(seed))
        host_ms.append((time.perf_counter() - t0) * 1e3 / PV_TRAIN_B)
        before += [voxels_in_range(s, cfg.DATA_CONFIG) for s in pts]
        after += host['voxel_valid'].sum(1).tolist() \
            if 'voxel_valid' in host else before[-PV_TRAIN_B:]
        batches.append(device_batch(host, 'cuda'))
    torch.cuda.synchronize()
    return batches, host_ms, before, after


def build_pvrcnn_trainer(device, name='pv_rcnn'):
    """``tools/cfgs/kitti_models/{name}.yaml`` in train mode as
    ``build_voxel_detector`` makes it (seed-0 weights), the anchor head's
    box layer at 1e-2 (so that the proposals stay near their anchors, as
    phase 24's point boxes stay near their points), its adam_onecycle
    optimizer over the KITTI schedule and ``make_train_step``: (cfg,
    model, optimizer, step)."""
    from spsnet_torch.runtime.trainer import make_train_step
    cfg, model = build_voxel_detector(name, device)
    with torch.no_grad():
        for p in model.dense_head.conv_box.parameters():
            p.mul_(1e-2)
    model.train()
    optimizer = _kitti_optimizer(cfg.OPTIMIZATION, model.parameters())
    return cfg, model, optimizer, make_train_step(model, optimizer)


def anchor_counts(model, out):
    """Positive, force-matched (a gt's best anchors, positive whatever
    their IoU) and ignored anchors of a train forward's output, and its
    foreground keypoints (PV-RCNN)."""
    labels = out['anchor_head_ret']['box_cls_labels']
    with torch.no_grad():
        force = model.dense_head.assign_targets(out['gt_boxes'])[4]
    counts = {'positive': int((labels > 0).sum()),
              'force_matched': int(force.sum()),
              'ignored': int((labels == -1).sum())}
    if 'point_head_simple_ret' in out:
        counts['fg_keypoints'] = int((out['point_head_simple_ret'][
            'targets'].cls_labels > 0).sum())
    return counts


def pvrcnn_train_path(trainer, batches, smi, launches=PV_LAUNCHES,
                      head_module=None,
                      stages='voxel stack + anchor targets + VSA + point '
                             'head + proposal NMS (pre 9000, post 512) + '
                             'RoI sampling + RoI-grid head + three losses'):
    """Phases 34 and 43: PV-RCNN or Voxel R-CNN training at full width
    (``trainer``: ``build_pvrcnn_trainer``'s), a warm-up step and the
    timed steps (``train_path``: finite losses and gradients,
    ``launches`` a step, every parameter moves), each step's grad norm
    before the clip, anchor (and keypoint) labels, sampled RoIs and
    proposal-NMS time (``head_module``'s ``proposal_layer``, PV-RCNN's
    RoI head's by default). Returns its record."""
    from spsnet_torch.models.roi_heads import pvrcnn_head
    from spsnet_torch.ops import _build
    head_module = head_module or pvrcnn_head
    cfg, model, opt, step = trainer
    tcfg = cfg.MODEL.ROI_HEAD.TARGET_CONFIG
    log('  the anchor head\'s box layer at 1e-2 of its seed-0 weights, so '
        'that the proposals stay near their anchors; each batch\'s gt '
        'completed by gt_at_proposals just before its step')
    step(gt_at_proposals(model, batches[0]))
    torch.cuda.synchronize()
    stats, norms = [], []

    def after_step():
        out = outs.pop()
        norms.append(float(opt.grad_norm))
        stats.append(dict(anchor_counts(model, out),
                          **roi_counts(out['roi_head_ret']['targets'],
                                       tcfg)))
        log(f'    grad norm {norms[-1]:.4f} (clip 10); {stats[-1]}')
    with roi_head_outputs(model) as outs, \
            timed_calls(head_module, 'proposal_layer') as nms_calls:
        times, counts = train_path(
            model, step, at_proposals(model, batches[1:]),
            {**{k: 0 for k in _build.LAUNCHES}, **launches}, after_step)
    nms = range_ms(nms_calls)
    ms = statistics.median(times)
    log(f'  launches over {len(times)} train steps: {counts}')
    log(f'  ms/train step (B={PV_TRAIN_B}, N={N}, {stages} + backward + '
        f'adam_onecycle): median {ms:.3f}, range {min(times):.3f}-'
        f'{max(times):.3f}, all {[round(t, 3) for t in times]}; steps/s '
        f'{1e3 / ms:.3f} on {smi}')
    share = [host / total for (host, _), total in zip(nms, times)]
    log(f'  proposal NMS a step: host ms {[round(h, 3) for h, _ in nms]}; '
        f'share of the step {min(share):.3f}-{max(share):.3f}')
    for key in stats[0]:
        vals = [s[key] for s in stats]
        log(f'  {key} a step: {min(vals)}-{max(vals)}')
    return {'ms': ms, 'all_ms': times, 'launches': counts,
            'grad_norms': norms, 'stats': stats,
            'nms_host_ms': [h for h, _ in nms], 'nms_share': share}


class PvDecisions(PrcnnDecisions):
    """``PrcnnDecisions`` of a PV-RCNN train step (the anchors' direction
    bins, FPS, ball queries, proposal NMS, max IoU, sampling). In 'check'
    mode the two runs' direction logits lie within PV_DIR_LOGIT_TOL, and a
    direction bin may differ only where this run's two logits lie within
    PV_DIR_LOGIT_TOL of each other (a heading pi apart); the two runs'
    anchor scores lie within PV_SCORE_TOL, and the proposal NMS's
    candidates are first held to be a top-k of this run's scores within
    PV_SCORE_TOL."""

    def __init__(self, mode, ref=None, thresholds=()):
        super().__init__(mode, ref, thresholds)
        self.used['dir_bins'] = []
        self.inputs['dir_bins'] = []

    def dir_bins(self, real, dir_preds):
        own = real(dir_preds)
        if self.mode == 'record':
            self.inputs['dir_bins'].append(dir_preds.detach().cpu())
            return self._use('dir_bins', own)
        want = self._ref('dir_bins').to(own.device)
        if self.mode == 'check':
            card = self.ref.inputs['dir_bins'][len(self.used['dir_bins'])]
            logits = dir_preds.detach().cpu()
            apart = float((card - logits).abs().max())
            flipped = (own != want).cpu()
            gap = (logits[..., 0] - logits[..., 1]).abs()[flipped]
            self.notes.append(f'direction bins: {int(flipped.sum())} of '
                              f'{flipped.numel()} differ, their logits at '
                              f'most {float(gap.max()) if gap.numel() else 0:.3e}'
                              f' apart; the runs\' logits {apart:.3e} apart')
            if apart > PV_DIR_LOGIT_TOL or (
                    gap.numel() and float(gap.max()) > PV_DIR_LOGIT_TOL):
                raise AssertionError(f'{self.notes[-1]} (tolerance '
                                     f'{PV_DIR_LOGIT_TOL})')
        return self._use('dir_bins', want)

    def nms(self, real, boxes, scores, thresh, pre_maxsize=4096,
            post_maxsize=500, valid=None):
        if self.mode == 'record':
            self.inputs.setdefault('scores', []).append(
                scores.detach().cpu())
        elif self.mode == 'check':
            card = self.ref.inputs['scores'][len(self.used['nms'])]
            own = scores.detach().cpu()
            diff = float((card - own).abs().max())
            self.notes.append(f'anchor scores: largest card vs CPU '
                              f'difference {diff:.3e} (tolerance '
                              f'{PV_SCORE_TOL})')
            if diff > PV_SCORE_TOL:
                raise AssertionError(self.notes[-1])
            _require_topk_order(card, own, pre_maxsize,
                                'proposal candidates (anchor scores)',
                                tol=PV_SCORE_TOL)
        return super().nms(real, boxes, scores, thresh, pre_maxsize,
                           post_maxsize, valid)


def _targets_of(out):
    """The anchor labels and the keypoint labels (PV-RCNN) of a train
    forward's output."""
    labels = {'anchor labels': out['anchor_head_ret']['box_cls_labels']}
    if 'point_head_simple_ret' in out:
        labels['keypoint labels'] = out['point_head_simple_ret'][
            'targets'].cls_labels
    return labels


def pvrcnn_train_cpu_phase(batch, name='pv_rcnn'):
    """Phases 36 and 44: one PV-RCNN (or, ``name`` 'voxel_rcnn_car',
    Voxel R-CNN) train step on one frame (``batch``, on the CPU) on the
    card and on the CPU from the same weights, RoI draws and dropout masks
    (the step's CPU generators), and on the CPU from weights jittered by
    WEIGHT_JITTER. The anchor labels, force matches and keypoint labels
    identical; every other decision of the CPU held to the card's
    (``PvDecisions``) and the CPU going on from the card's; the jittered
    run replays the CPU's. Then the loss terms, gradients, updated
    parameters and BN running statistics as ``pointrcnn_train_cpu_phase``
    holds them, and the share of ``conv_box``'s gradient that comes
    through the RoIs. Returns the card's and the baseline's differences
    and the notes."""
    import copy
    cfg, gpu, _, gpu_step = build_pvrcnn_trainer('cuda', name)
    _, cpu, cpu_opt, cpu_step = build_pvrcnn_trainer('cpu', name)
    _, jit, _, jit_step = build_pvrcnn_trainer('cpu', name)
    want = PV_LAUNCHES if name == 'pv_rcnn' else VR_LAUNCHES
    tcfg = cfg.MODEL.ROI_HEAD.TARGET_CONFIG
    thresholds = tuple(float(tcfg[k]) for k in (
        'CLS_BG_THRESH_LO', 'CLS_BG_THRESH', 'REG_FG_THRESH',
        'CLS_FG_THRESH'))
    cpu.load_state_dict(gpu.state_dict())
    jit.load_state_dict(gpu.state_dict())
    card_batch = gt_at_proposals(gpu, {k: v.cuda() for k, v in
                                       batch.items()})
    batch = dict(batch, gt_boxes=card_batch['gt_boxes'].cpu())
    probe = copy.deepcopy(gpu)
    share = roi_gradient_share(probe, card_batch,
                               probe.dense_head.conv_box.parameters(),
                               ('rpn_loss',), 'the anchor head\'s conv_box')
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in jit.parameters():
            p.mul_(1 + WEIGHT_JITTER * torch.randn(p.shape, generator=gen))
    card = PvDecisions('record')
    with prcnn_decisions(card), roi_head_outputs(gpu) as gpu_out:
        gpu_loss, gpu_tb = gpu_step(card_batch)
    own = PvDecisions('check', card, thresholds)
    with prcnn_decisions(own), roi_head_outputs(cpu) as cpu_out:
        cpu_loss, cpu_tb = cpu_step(batch)
    jittered = PvDecisions('replay', own)
    with prcnn_decisions(jittered):
        jit_step(batch)
    card_targets, cpu_targets = (_targets_of(o[0]) for o in (gpu_out,
                                                               cpu_out))
    for what, g in card_targets.items():
        require_equal(g, cpu_targets[what], f'card vs CPU train step: '
                                            f'{what} {tuple(g.shape)}')
    with torch.no_grad():
        require_equal(
            gpu.dense_head.assign_targets(card_batch['gt_boxes'])[4].int(),
            cpu.dense_head.assign_targets(batch['gt_boxes'])[4].int(),
            'card vs CPU train step: force-matched anchors')
    for note in own.notes + jittered.notes:
        log(f'  {note}')
    n_fps, n_ball = len(card.used['fps']), len(card.used['ball'])
    log(f'  card vs CPU: {n_fps - own.differ["fps"]} of {n_fps} FPS and '
        f'{n_ball - own.differ["ball"]} of {n_ball} ball-query calls '
        f'identical (the others as the notes above say)')
    if n_fps != want.get('fps', 0) or n_ball != want['ball_query']:
        raise AssertionError(f'want {want} calls a {name} train step')
    for g, c in zip(card.used['sampled'], own.used['sampled']):
        require_equal(g, c, f'card vs CPU train step: sampled RoI indices '
                            f'{tuple(g.shape)}')
    worst = {}
    for key in ('loss', *sorted(gpu_tb)):
        g = float(gpu_loss if key == 'loss' else gpu_tb[key])
        c = float(cpu_loss if key == 'loss' else cpu_tb[key])
        worst[key] = abs(g - c) / max(abs(c), 1e-12)
        if worst[key] > TRAIN_LOSS_RTOL:
            raise AssertionError(f'card vs CPU {key}: {g} vs {c}')
    log(f'  card vs CPU loss terms {sorted(gpu_tb)}: largest relative '
        f'difference {max(worst.values()):.3e} ({max(worst, key=worst.get)};'
        f' tolerance {TRAIN_LOSS_RTOL}); card {float(gpu_loss):.6f}, CPU '
        f'{float(cpu_loss):.6f}')
    lr = cpu_opt.lr_fn(0)
    diff = _step_difference(gpu, cpu, lr)
    base = _step_difference(jit, cpu, lr)
    log(f'  card vs CPU after the step: {diff}')
    log(f'  CPU with weights x (1 + {WEIGHT_JITTER} N(0, 1)) vs CPU (the '
        f'jitter baseline): {base}')
    limits = _require_step_within(diff, base, lr)
    by_module = _grad_by_module((gpu, jit), cpu)
    _require_modules_within(by_module)
    stats = [_bn_stats_rel_l2(a, cpu) for a in (gpu, jit)]
    parts = sorted({'.'.join(n.split('.')[:1 + n.startswith('roi_head')])
                    for n, _ in cpu.named_buffers()
                    if n.endswith('running_mean')})
    bn_by_module = {part: [_bn_stats_rel_l2(a, cpu, part) for a in
                           (gpu, jit)] for part in parts}
    bn_accuracy = batch_norm_accuracy()
    log(f'  BN running stats, relative L2: card vs CPU {stats[0]:.3e}, '
        f'baseline {stats[1]:.3e}; by module: ' + ', '.join(
            f'{k} {v[0]:.3e} / {v[1]:.3e}' for k, v in bn_by_module.items()))
    limits['bn_limit'] = _require_bn_within(stats)
    return {'card': diff, 'baseline': base, 'limits': limits,
            'notes': own.notes, 'by_module': by_module, 'bn_stats': stats,
            'bn_by_module': bn_by_module, 'differ': own.differ,
            'loss_rel': worst, 'conv_box_roi_share': share,
            'batch_norm_accuracy': bn_accuracy}


def batch_norm_accuracy():
    """Relative L2 from a float64 reference of a training-mode BatchNorm of
    (442 368, 64) rows (the RoI-grid pool's, B = 2), the channel means
    drawn up to 9x their spread: the card's ``F.batch_norm``, the CPU's and the port's
    ``BatchNormLast`` on the CPU (normalised with ``torch.var_mean``'s
    statistics, since the CPU's ``F.batch_norm`` sums them in fp32 row
    after row)."""
    import torch.nn.functional as F
    from spsnet_torch.models.blocks import BatchNormLast
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(442368, 64, generator=gen) + \
        9 * torch.rand(1, 64, generator=gen)
    bn = BatchNormLast(64).train()
    x64 = x.double()
    var, mean = torch.var_mean(x64, dim=0, unbiased=False)
    ref = (x64 - mean) / torch.sqrt(var + bn.eps)
    with torch.no_grad():
        runs = {'card F.batch_norm': F.batch_norm(
                    x.cuda(), None, None, training=True, eps=bn.eps).cpu(),
                'CPU F.batch_norm': F.batch_norm(x, None, None,
                                                 training=True, eps=bn.eps),
                'port CPU BatchNormLast': bn(x)}
    rel = {k: float((v.double() - ref).norm() / ref.norm())
           for k, v in runs.items()}
    log('  training-mode BatchNorm of (442368, 64) rows, relative L2 from '
        'float64: ' + ', '.join(f'{k} {v:.3e}' for k, v in rel.items()))
    return rel


def anchor_loss_phase(model, batch):
    """Phase 37, first half: the anchor targets of a train batch's gt and
    ``anchor_head_loss`` of seeded random predictions on the card and on
    the CPU (``model``: a CPU PV-RCNN): labels identical, every term
    non-zero and within TRAIN_LOSS_RTOL."""
    from spsnet_torch.models.dense_heads.anchor_head import anchor_head_loss
    head, cfg = model.dense_head, model.model_cfg.DENSE_HEAD
    gt = batch['gt_boxes'].cpu()
    n = head.anchors.shape[0]
    rng = np.random.default_rng(703)
    preds = {'cls_preds': rng.normal(size=(PV_TRAIN_B, n, head.num_class)),
             'box_preds': rng.normal(0, 0.1, (PV_TRAIN_B, n, 7)),
             'dir_preds': rng.normal(size=(PV_TRAIN_B, n, 2))}
    res = {}
    for device in ('cuda', 'cpu'):
        h = head.to(device)
        labels, reg, reg_w, _, _ = h.assign_targets(gt.to(device))
        ret = {k: torch.from_numpy(v.astype(np.float32)).to(device)
               for k, v in preds.items()}
        ret.update(box_cls_labels=labels, box_reg_targets=reg,
                   reg_weights=reg_w, anchors=h.anchors)
        res[device] = (labels, anchor_head_loss(
            ret, cfg.LOSS_CONFIG, model.num_class, h.num_dir_bins,
            h.dir_offset)[1])
    head.cpu()
    (lg, tbg), (lc, tbc) = res['cuda'], res['cpu']
    require_equal(lg, lc, 'card vs CPU anchor labels of the train gt')
    for key in sorted(tbc):
        g, c = float(tbg[key]), float(tbc[key])
        if not (c > 0 and abs(g - c) <= TRAIN_LOSS_RTOL * c):
            raise AssertionError(f'card vs CPU {key}: {g} vs {c}')
    log(f'  anchor loss on the train gt with random predictions, card vs '
        f'CPU: { {k: (float(tbg[k]), float(tbc[k])) for k in sorted(tbc)} }')
    return {k: [float(tbg[k]), float(tbc[k])] for k in tbc}


def second_train_phase(batches, pv_cfg):
    """Phase 38: SECOND (second.yaml, full width, seed-0 weights, its box
    layer at 1e-2) takes a warm-up and SECOND_TRAIN_STEPS steps of the
    PV-RCNN train batches (second.yaml voxelizes alike; its plan's 16 000
    rows a level are pv_rcnn.yaml's train voxel limit): finite losses and
    gradients, every parameter moves, no kernel launch."""
    from spsnet_torch.ops import _build
    cfg, model, opt, step = build_pvrcnn_trainer('cuda', 'second')
    steps = lambda c: [p for p in c.DATA_CONFIG.DATA_PROCESSOR
                       if p.NAME == 'transform_points_to_voxels']
    if steps(cfg) != steps(pv_cfg):
        raise AssertionError('second.yaml voxelizes unlike pv_rcnn.yaml')
    step(batches[0])
    torch.cuda.synchronize()
    times, launches = train_path(model, step,
                                 batches[1:1 + SECOND_TRAIN_STEPS],
                                 {k: 0 for k in _build.LAUNCHES})
    ms = statistics.median(times)
    log(f'  ms/train step (B={PV_TRAIN_B}, voxel stack + anchor targets + '
        f'anchor loss + backward + adam_onecycle): median {ms:.3f}, all '
        f'{[round(t, 3) for t in times]}; launches {launches}')
    return {'ms': ms, 'all_ms': times, 'launches': launches}


def pvrcnn_train_phases(smi):
    """Phases 34-39; returns the PV-RCNN train record, the kernel calls at
    its shapes and SECOND's train record."""
    from spsnet_torch.runtime.trainer import step_rngs
    log('== 34. PV-RCNN train path')
    trainer = build_pvrcnn_trainer('cuda')
    pv_cfg, model, _, step = trainer
    batches, host_ms, before, after = pv_train_batches(
        pv_cfg, range(800, 801 + PV_TRAIN_STEPS))
    log(f'  host voxelization + sparse plan at the train settings: '
        f'{statistics.median(host_ms):.3f} ms a frame (median of '
        f'{len(host_ms)} batches); voxels a frame in range '
        f'{min(before)}-{max(before)}, after the cap of 16000 '
        f'{min(after)}-{max(after)}; gt boxes a frame '
        f'{batches[0]["gt_boxes"].shape[1]} (classes 1, 2, 3 in turn)')
    rec = pvrcnn_train_path(trainer, batches, smi)
    rec.update(host_ms_a_frame=host_ms, voxels_before_cap=before,
               voxels_after_cap=after)

    log('== 35. kernels vs plain at the PV-RCNN train shapes')
    shapes = pvrcnn_shapes_phase(model, dict(batches[0], rngs=step_rngs(0)))

    log('== 36. PV-RCNN card vs CPU, one train step')
    one = {k: v[:1].cpu() for k, v in batches[1].items()}
    rec['card_vs_cpu'] = pvrcnn_train_cpu_phase(one)

    log('== 37. anchor and RoI losses on the train gt and on jittered gt, '
        'card vs CPU')
    cpu_cfg, cpu_model = build_voxel_detector('pv_rcnn', 'cpu')
    rec['anchor_loss'] = anchor_loss_phase(cpu_model, batches[0])
    reg_steps = sum(s['reg_valid'] > 0 for s in rec['stats'])
    log(f'  phase 34 carried the anchor regression and direction terms in '
        f'every step (positives {min(s["positive"] for s in rec["stats"])} '
        f'at least) and the RoI regression and corner terms in {reg_steps} '
        f'of {len(rec["stats"])} steps')
    rec['reg_corner'] = roi_target_loss_phase(reg_steps > 0, cpu_cfg,
                                              cpu_model)
    del cpu_model

    log('== 38. SECOND train path')
    second = second_train_phase(batches, pv_cfg)

    log('== 39. where the time goes: one PV-RCNN train step')
    profiled = gt_at_proposals(model, batches[1])
    rec['profile'] = pvrcnn_profile(model, lambda: step(profiled),
                                    'one PV-RCNN train step (B=2)',
                                    'pre 9000, post 512')
    return rec, shapes, second


# ------------------------------------------------- Voxel R-CNN, CenterPoint

def pv_host_batches(cfg, seeds, b, n=N, channels=4):
    """Test-mode voxel batches of ``b`` synthetic scans of ``n`` points in
    the config's range (channels past the fourth uniform in [0, 1)), one
    seed a batch, made by the port's host code (``voxel_batch``: the
    voxelization and the sparse plan, or the pillars, or the sampled
    points of a dynamic pillar config, drawn from ``RandomState(seed)``)
    and copied to the card: {'batches', 'host_ms' (a frame), 'copy_ms' (a
    batch), 'before' and 'after' (each frame's voxels before and after the
    cap)}."""
    from spsnet_torch.data.processor import voxel_batch
    from spsnet_torch.runtime.trainer import device_batch
    from spsnet_torch.utils.synthetic import synthetic_scan_batch
    rec = {'batches': [], 'host_ms': [], 'copy_ms': [], 'before': [],
           'after': []}
    for seed in seeds:
        scans = synthetic_scan_batch(
            seed, b, n, pc_range=cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
        if channels > 4:
            scans = np.concatenate([scans, np.random.default_rng(
                seed).uniform(0, 1, scans.shape[:2] + (channels - 4,))
                .astype(np.float32)], axis=-1)
        t0 = time.perf_counter()
        host = voxel_batch(scans, cfg.DATA_CONFIG,
                           rng=np.random.RandomState(seed))
        rec['host_ms'].append((time.perf_counter() - t0) * 1e3 / b)
        rec['before'] += [voxels_in_range(x, cfg.DATA_CONFIG) for x in scans]
        rec['after'] += host['voxel_valid'].sum(1).tolist() \
            if 'voxel_valid' in host else rec['before'][-b:]
        t0 = time.perf_counter()
        rec['batches'].append(device_batch(host, 'cuda'))
        torch.cuda.synchronize()
        rec['copy_ms'].append((time.perf_counter() - t0) * 1e3)
    first = rec['batches'][0]
    rows = f'; rows a level {first["voxel_valid"].shape[1]} ... ' \
        f'{first["down4_valid"].shape[1]}' if 'down4_valid' in first else ''
    log(f'  host steps ({", ".join(p.NAME for p in cfg.DATA_CONFIG.DATA_PROCESSOR)};'
        f' port, numpy): '
        f'{statistics.median(rec["host_ms"]):.3f} ms a frame (median of '
        f'{len(seeds)} batches of {b}, {[round(t, 3) for t in rec["host_ms"]]}'
        f'); copy to the card {[round(t, 3) for t in rec["copy_ms"]]} ms a '
        f'batch; voxels a frame in range {rec["before"]}, after the cap '
        f'{rec["after"]}{rows}')
    return rec


def vr_grid_hits(model, out):
    """Share of the valid RoIs' grid points with a voxel center within
    each source level's pool radius (the plain ball query on the card: no
    kernel launch)."""
    from spsnet_torch.models.roi_heads.pvrcnn_head import roi_grid_points
    from spsnet_torch.ops.grouping import (ball_query_multi_plain,
                                           squared_radius)
    head = model.roi_head
    grid = roi_grid_points(out['rois'][..., :7], head.template)
    B, R, G3, _ = grid.shape
    flat = grid.reshape(B, R * G3, 3).contiguous()
    valid = out['roi_valid'][:, :, None].expand(-1, -1, G3).reshape(B, -1)
    shares = {}
    with torch.no_grad():
        for name, layer in head.roi_grid_pool_layers.items():
            centers = head.level_centers(out, name)
            r = layer.radii[0]
            idx = ball_query_multi_plain((r,), (1,), centers, flat)[0]
            d2 = ((centers.gather(1, idx[..., 0, None].expand(-1, -1, 3)) -
                   flat) ** 2).sum(-1)
            shares[name] = float((d2 < squared_radius(r))[valid].float()
                                 .mean())
    return shares


def voxelrcnn_path(model, cfg, requests, what):
    """A warm-up and the timed requests (forward + ``post_processing``)
    with the launch counters zeroed just before: three ball queries a
    request (the RoI grid over x_conv2-4) and no other kernel. Returns
    its record: ms and range, launches, the proposal NMS's host ms and
    share of each request, the kept boxes and the grid points' voxel hits
    of the first request."""
    from spsnet_torch.models.roi_heads import voxelrcnn_head
    post = cfg.MODEL.POST_PROCESSING
    with timed_calls(voxelrcnn_head, 'proposal_layer') as nms_calls:
        times, launches = main_path(model, requests, post, VR_LAUNCHES, what)
    torch.cuda.synchronize()
    nms = range_ms(nms_calls)[1:]          # the first is main_path's warm-up
    out, dets = detect(model, requests[0], post)
    hits = vr_grid_hits(model, out)
    ms = statistics.median(times)
    share = [host / total for (host, _), total in zip(nms, times)]
    b = requests[0]['points'].shape[0]
    rec = {'B': b, 'ms_per_batch': ms, 'all_ms': times,
           'range_ms': [min(times), max(times)], 'launches': launches,
           'nms_host_ms': [h for h, _ in nms], 'nms_share': share,
           'kept_boxes': dets['count'].tolist(),
           'valid_rois': out['roi_valid'].sum(1).tolist(),
           'grid_points_with_a_voxel': hits}
    log(f'  launches over {len(requests)} requests: {launches}')
    log(f'  ms/batch ({what}: voxel stack + first-stage head + proposal '
        f'NMS + voxel RoI-grid pool + RoI head + NMS): median {ms:.3f}, '
        f'range {min(times):.3f}-{max(times):.3f}, all '
        f'{[round(t, 3) for t in times]}; scenes/s {b / ms * 1e3:.2f}')
    log(f'  proposal NMS a request: host ms {[round(h, 3) for h, _ in nms]}; '
        f'share {min(share):.3f}-{max(share):.3f}')
    log(f'  first request: {rec["kept_boxes"]} boxes kept, '
        f'{rec["valid_rois"]} RoIs; share of their grid points with a voxel '
        f'within the pool radius: {hits}')
    return rec


def voxelrcnn_shapes_phase(model, batch, what):
    """K2 vs its plain version at Voxel R-CNN's shapes, on the inputs a
    forward of ``batch`` makes (in train mode with the step's generators:
    the sampled RoIs): the RoI grid (6^3 points a RoI) over each source
    level's voxel centers, the padded ones at 1e6; index for index, with
    event times, device time a call, bound and launch shape. The plain
    query takes its (B, 1024, N) distances a block of centers at a time."""
    from spsnet_torch.models.roi_heads.pvrcnn_head import roi_grid_points
    from spsnet_torch.ops.grouping import ball_query_multi_kernel
    with torch.no_grad():
        out = model(batch)
    head = model.roi_head
    grid = roi_grid_points(out['rois'][..., :7], head.template)
    grid = grid.reshape(grid.shape[0], -1, 3).contiguous()
    res = {'ball_query': [], 'errs': {'ball_query': 0.0}}
    for name, layer in head.roi_grid_pool_layers.items():
        centers = head.level_centers(out, name)
        radii, ns = layer.radii, layer.nsamples
        call = ball_query_call(radii, ns, centers, grid, f'{what} {name}')
        res['errs']['ball_query'] = max(res['errs']['ball_query'],
                                        call.pop('err'))
        call['device_ms'] = device_ms(
            lambda r=radii, n=ns, p=centers, c=grid:
            ball_query_multi_kernel(r, n, p, c), reps=5)
        log(f'    device time {call["device_ms"]:.4f} ms a call')
        res['ball_query'].append(call)
    return res


def voxelrcnn_cpu_phase(model, cfg, batch):
    """One Voxel R-CNN request on the card and on the CPU with the same
    weights and host tables, stage by stage from the card's inputs: the
    voxel stack, the anchor head and the proposal NMS
    (``_stage_one_vs_cpu``), each source level's voxel centers bit for
    bit, then the RoI head (``_roi_stage_vs_cpu``: the RoI-grid picks
    equal or within the rounding slack of their grid points, then
    replayed; the pooled features, the refinement and the final NMS)."""
    _, cpu = build_voxel_detector('voxel_rcnn_car', 'cpu')
    cpu.load_state_dict(model.state_dict())
    errs, rpn = _stage_one_vs_cpu(model, cpu, batch, _cpu_tree(batch),
                                  cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST)
    with torch.no_grad():
        for name in model.roi_head.sources:
            require_equal(model.roi_head.level_centers(rpn, name),
                          cpu.roi_head.level_centers(_cpu_tree(rpn), name),
                          f'card vs CPU: {name} voxel centers')
        out = model.roi_head(rpn)
    roi_errs, notes, differ, _ = _roi_stage_vs_cpu(
        model, cpu, rpn, out, cfg.MODEL.POST_PROCESSING)
    return {'max_scaled_err': max(errs + roi_errs), 'roi_grid_notes': notes,
            'ball_lists_differ': differ}


def voxelrcnn_phases(smi):
    """Phases 40-44; returns the Voxel R-CNN serving record, its kernel
    calls, its train record and the kernel calls at the train shapes."""
    from spsnet_torch.models.roi_heads import voxelrcnn_head
    from spsnet_torch.runtime.trainer import step_rngs
    log('== 40. Voxel R-CNN serving path')
    cfg, model = build_voxel_detector('voxel_rcnn_car', 'cuda')
    host = pv_host_batches(cfg, range(1100, 1100 + VR_BATCHES), VR_B)
    batches = host['batches']
    rec = voxelrcnn_path(model, cfg, [batches[k % VR_BATCHES]
                                      for k in range(VR_REQUESTS)],
                         'Voxel R-CNN requests (B=2)')
    rec.update(host_ms_a_frame=host['host_ms'],
               voxels_before_cap=host['before'],
               voxels_after_cap=host['after'])
    post = cfg.MODEL.POST_PROCESSING
    rec['profile'] = pvrcnn_profile(
        model, lambda: detect(model, batches[0], post),
        'one Voxel R-CNN request (B=2)', 'pre 2048, post 100',
        voxelrcnn_head)

    log('== 41. kernels vs plain at the Voxel R-CNN serving shapes')
    shapes = voxelrcnn_shapes_phase(model, batches[0], 'serving')

    log('== 42. Voxel R-CNN card vs CPU, one request (B=2)')
    rec['card_vs_cpu'] = voxelrcnn_cpu_phase(model, cfg, batches[0])
    del model

    log('== 43. Voxel R-CNN train path; kernels vs plain at its shapes')
    trainer = build_pvrcnn_trainer('cuda', 'voxel_rcnn_car')
    cfg, model, _, step = trainer
    train_batches, host_ms, before, after = pv_train_batches(
        cfg, range(1200, 1201 + VR_TRAIN_STEPS))
    log(f'  host voxelization + sparse plan at the train settings: '
        f'{statistics.median(host_ms):.3f} ms a frame (median of '
        f'{len(host_ms)} batches); voxels a frame in range {before}, after '
        f'the cap of 16000 {after}; gt boxes a frame '
        f'{train_batches[0]["gt_boxes"].shape[1]} (cars)')
    train = pvrcnn_train_path(
        trainer, train_batches, smi, VR_LAUNCHES, voxelrcnn_head,
        'voxel stack + anchor targets + proposal NMS (pre 9000, post 512) '
        '+ RoI sampling + voxel RoI-grid pool + RoI head + two losses')
    train.update(host_ms_a_frame=host_ms, voxels_before_cap=before,
                 voxels_after_cap=after)
    profiled = gt_at_proposals(model, train_batches[1])
    train['profile'] = pvrcnn_profile(
        model, lambda: step(profiled), 'one Voxel R-CNN train step (B=2)',
        'pre 9000, post 512', voxelrcnn_head)
    train_shapes = voxelrcnn_shapes_phase(
        model, dict(profiled, rngs=step_rngs(0)), 'train')

    log('== 44. Voxel R-CNN card vs CPU, one train step')
    one = {k: v[:1].cpu() for k, v in train_batches[1].items()}
    train['card_vs_cpu'] = pvrcnn_train_cpu_phase(one, 'voxel_rcnn_car')
    return rec, shapes, train, train_shapes


def centerpoint_path(model, requests, what):
    """A warm-up and the timed requests (a forward: the head decodes its
    own detections, no NMS after it) with the launch counters zeroed just
    before: no kernel of the port; detections finite, each frame's count
    within the head's slots. Returns (ms a request, launch counts, the
    last request's detections)."""
    from spsnet_torch.models.detectors.detector3d import head_detections
    from spsnet_torch.ops import _build

    def serve(batch):
        with torch.no_grad():
            return head_detections(model(batch))
    serve(requests[0])
    torch.cuda.synchronize()
    _build.reset_launches()
    times = []
    for batch in requests:
        t0 = time.perf_counter()
        dets = serve(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not (torch.isfinite(dets['boxes']).all() and
                torch.isfinite(dets['scores']).all()):
            raise AssertionError(f'{what}: non-finite detections')
        if dets['count'].min() < 1 or \
                dets['count'].max() > dets['valid'].shape[1]:
            raise AssertionError(f'{what}: counts {dets["count"]}')
    launches = dict(_build.LAUNCHES)
    _require_per_call(launches, {}, len(requests), what)
    return times, launches, dets


def centerpoint_profile(model, fn, what):
    """A CUDA-kernel breakdown of one call of ``fn`` (a CenterPoint
    request or train step of ``model``) with the sparse backbone, the BEV
    backbone and the head's decode as ranges, and their shares of the
    device time."""
    names = {'backbone_3d': 'sparse backbone', 'backbone_2d': 'BEV backbone'}

    def ranged(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    for attr, name in names.items():
        module = getattr(model, attr)
        module.forward = ranged(name, module.forward)
    model.dense_head.decode = ranged('head decode', model.dense_head.decode)
    try:
        prof = profile_phase(fn, what, ranges=(*names.values(),
                                               'head decode'))
    finally:
        for attr in names:
            del getattr(model, attr).forward
        del model.dense_head.decode
    for span in prof['ranges'].values():
        span['device_share'] = span['device_ms'] / prof['device_ms']
    prof['backward_share'] = prof['backward_device_ms'] / prof['device_ms']
    log('  device shares: ' + ', '.join(
        f'{k} {v["device_share"]:.3f}' for k, v in prof['ranges'].items()) +
        f', backward {prof["backward_share"]:.3f}')
    return prof


class CpDecisions(PrcnnDecisions):
    """``PrcnnDecisions`` of the CenterHead's decode: its top-k candidates
    and its NMS. In 'check' mode the two runs' scores lie within
    CP_SCORE_TOL, the card's top k is a top k of this run's scores within
    it, and this run goes on from the card's picks (its own scores at
    them); the NMS as ``PrcnnDecisions.nms`` holds it."""

    def __init__(self, mode, ref=None):
        super().__init__(mode, ref)
        self.used['topk'] = []
        self.inputs['topk'] = []

    def topk(self, real, scores, k):
        own = real(scores, k)
        if self.mode == 'record':
            self.inputs['topk'].append(scores.detach().cpu())
            return self._use('topk', own)
        card = self.ref.inputs['topk'][len(self.used['topk'])]
        diff = float((card - scores.detach().cpu()).abs().max())
        self.notes.append(f'CenterHead top-{k} scores: largest card vs CPU '
                          f'difference {diff:.3e} (tolerance '
                          f'{CP_SCORE_TOL})')
        if diff > CP_SCORE_TOL:
            raise AssertionError(self.notes[-1])
        _require_topk_order(card, scores.detach().cpu(), k,
                            f'CenterHead top-{k} candidates',
                            tol=CP_SCORE_TOL)
        idx = self._ref('topk')[1].to(scores.device)
        return self._use('topk', (scores.gather(-1, idx), idx))


def centerpoint_cpu_phase(model, cfg, batch):
    """One CenterPoint request (B = 1) on the card and on the CPU with the
    same weights and host tables, stage by stage from the card's inputs:
    voxel features, every sparse level, the BEV map (the scatter bit for
    bit), the BEV backbone and the head's maps within VOXEL_RTOL /
    VOXEL_ATOL; the decode's top-500 candidates and NMS held to the
    card's and replayed (``CpDecisions``); the detections' valid masks
    and labels identical, boxes and scores within tolerance."""
    _, cpu = build_voxel_detector('waymo_models/centerpoint', 'cpu')
    cpu.load_state_dict(model.state_dict())
    host = _cpu_tree(batch)
    errs = []
    with torch.no_grad():
        g = model.vfe(batch)
        c = cpu.vfe(host)
        errs.append(_require_scaled(g['voxel_features'], c['voxel_features'],
                                    'voxel features'))
        g = model.backbone_3d(g)
        c = cpu.backbone_3d(dict(host, voxel_features=g[
            'voxel_features'].cpu()))
        for name, t in c['multi_scale_3d_features'].items():
            errs.append(_require_scaled(
                g['multi_scale_3d_features'][name], t, f'sparse level {name}'))
        g = model.map_to_bev_module(g)
        c = cpu.map_to_bev_module(_cpu_tree(dict(
            host, **{k: g[k] for k in ('encoded_voxel_features',
                                       'encoded_voxel_coords',
                                       'encoded_voxel_valid')})))
        require_equal(g['spatial_features'], c['spatial_features'],
                      'card vs CPU: the BEV scatter (HeightCompression)')
        g = model.backbone_2d(g)
        c = cpu.backbone_2d({'spatial_features': g['spatial_features'].cpu()})
        errs.append(_require_scaled(g['spatial_features_2d'],
                                    c['spatial_features_2d'],
                                    'BEV backbone'))
        notes = _center_head_vs_cpu(model, cpu, g, errs)
    return {'max_scaled_err': max(errs), 'notes': notes}


def _center_head_vs_cpu(model, cpu, g, errs):
    """The CenterHeadIoU of ``model`` (the card) and ``cpu`` on the card's
    BEV features ``g['spatial_features_2d']``: the top-K candidates and
    NMS held and replayed (``CpDecisions``), every group's maps and the
    detections' boxes and scores within tolerance (their scaled errors
    appended to ``errs``), valid masks and labels identical. Returns the
    decisions' notes."""
    card = CpDecisions('record')
    with prcnn_decisions(card):
        gh = model.dense_head({'spatial_features_2d':
                               g['spatial_features_2d']})
    own = CpDecisions('check', card)
    with prcnn_decisions(own):
        ch = cpu.dense_head({'spatial_features_2d':
                             g['spatial_features_2d'].cpu()})
    for note in own.notes:
        log(f'  card vs CPU {note}')
    for pg, pc in zip(gh['center_head_iou_ret']['pred_dicts'],
                      ch['center_head_iou_ret']['pred_dicts']):
        for key in pg:
            errs.append(_require_scaled(pg[key], pc[key],
                                        f'head map {key}'))
    for key in ('final_valid', 'final_labels'):
        require_equal(gh[key].long(), ch[key].long(),
                      f'card vs CPU detections {key}')
    for key in ('final_boxes', 'final_scores'):
        errs.append(_require_scaled(gh[key], ch[key],
                                    f'detections {key}'))
    log(f'  {int(gh["final_valid"].sum())} detections, labels '
        f'{sorted(set(gh["final_labels"][gh["final_valid"]].tolist()))}')
    return own.notes


def build_centerpoint_trainer(device, cut=False,
                              name='waymo_models/centerpoint'):
    """``tools/cfgs/{name}.yaml`` (waymo_models/centerpoint.yaml, or a
    pillar CenterPoint) as ``build_voxel_detector`` makes it (seed-0
    weights; with ``cut``, on CP_TRAIN_CUT's range, voxel caps and sampled
    points) in train mode, its adam_onecycle optimizer and
    ``make_train_step``: (cfg, model, optimizer, step)."""
    from spsnet_torch.models import build_detector_from_cfg
    from spsnet_torch.runtime.trainer import make_train_step
    from spsnet_torch.zoo import load_yaml_cfg
    cfg = load_yaml_cfg(f'tools/cfgs/{name}.yaml')
    if cut:
        cut_to(cfg, CP_TRAIN_CUT)
    model = build_detector_from_cfg(
        cfg, device=device, generator=torch.Generator().manual_seed(0))
    model.train()
    optimizer = _kitti_optimizer(cfg.OPTIMIZATION, model.parameters())
    return cfg, model, optimizer, make_train_step(model, optimizer)


def head_targets(model):
    """The CenterHead's output batch of each forward while open (a
    forward hook)."""
    outs = []
    handle = model.dense_head.register_forward_hook(
        lambda module, args, out: outs.append(out['center_head_iou_ret']))
    return outs, handle


def centerpoint_train_cpu_phase(batch, name='waymo_models/centerpoint'):
    """Phases 48, 61 and 64: one train step of ``name``'s CenterPoint on
    one frame (``batch``, on the CPU; CP_TRAIN_CUT) on the card and on the
    CPU from the same weights, and on the CPU from weights jittered by
    WEIGHT_JITTER: every group's heatmap targets, centre pixels and masks
    identical bit for bit; loss terms within TRAIN_LOSS_RTOL; gradients,
    updated parameters and BN running statistics as
    ``pvrcnn_train_cpu_phase`` holds them."""
    _, gpu, _, gpu_step = build_centerpoint_trainer('cuda', True, name)
    _, cpu, cpu_opt, cpu_step = build_centerpoint_trainer('cpu', True, name)
    _, jit, _, jit_step = build_centerpoint_trainer('cpu', True, name)
    cpu.load_state_dict(gpu.state_dict())
    jit.load_state_dict(gpu.state_dict())
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in jit.parameters():
            p.mul_(1 + WEIGHT_JITTER * torch.randn(p.shape, generator=gen))
    rets = []
    for model, step, b in ((gpu, gpu_step, {k: v.cuda() for k, v in
                                            batch.items()}),
                           (cpu, cpu_step, batch)):
        outs, handle = head_targets(model)
        try:
            rets.append((step(b), outs[0]))
        finally:
            handle.remove()
    jit_step(batch)
    ((gpu_loss, gpu_tb), gret), ((cpu_loss, cpu_tb), cret) = rets
    for g, (tg, tc) in enumerate(zip(gret['target_dicts'],
                                     cret['target_dicts'])):
        for key in ('heatmap', 'inds', 'mask', 'gt7'):
            require_equal(tg[key], tc[key], f'card vs CPU train step: group '
                                            f'{g} {key} targets')
        log(f'  group {g}: {int(tc["mask"].sum())} gt centres, heatmap '
            f'peaks {int((tc["heatmap"] == 1).sum())}: targets identical')
    worst = {}
    for key in ('loss', *sorted(gpu_tb)):
        g = float(gpu_loss if key == 'loss' else gpu_tb[key])
        c = float(cpu_loss if key == 'loss' else cpu_tb[key])
        worst[key] = abs(g - c) / max(abs(c), 1e-12)
        if worst[key] > TRAIN_LOSS_RTOL:
            raise AssertionError(f'card vs CPU {key}: {g} vs {c}')
    log(f'  card vs CPU loss terms {sorted(gpu_tb)}: largest relative '
        f'difference {max(worst.values()):.3e} (tolerance '
        f'{TRAIN_LOSS_RTOL}); card {float(gpu_loss):.6f}, CPU '
        f'{float(cpu_loss):.6f}')
    lr = cpu_opt.lr_fn(0)
    diff = _step_difference(gpu, cpu, lr)
    base = _step_difference(jit, cpu, lr)
    log(f'  card vs CPU after the step: {diff}')
    log(f'  CPU with weights x (1 + {WEIGHT_JITTER} N(0, 1)) vs CPU (the '
        f'jitter baseline): {base}')
    limits = _require_step_within(diff, base, lr)
    by_module = _grad_by_module((gpu, jit), cpu)
    _require_modules_within(by_module)
    stats = [_bn_stats_rel_l2(a, cpu) for a in (gpu, jit)]
    limits['bn_limit'] = _require_bn_within(stats)
    return {'card': diff, 'baseline': base, 'limits': limits,
            'by_module': by_module, 'bn_stats': stats, 'loss_rel': worst}


def centerpoint_phases(smi):
    """Phases 45-48; returns the CenterPoint serving and train records."""
    from spsnet_torch.models.detectors.detector3d import head_detections
    log('== 45. CenterPoint serving path (waymo_models/centerpoint.yaml)')
    cfg, model = build_voxel_detector('waymo_models/centerpoint', 'cuda')
    host = pv_host_batches(cfg, range(1300, 1302), CP_B, CP_N, 5)
    torch.cuda.reset_peak_memory_stats()
    times, launches, dets = centerpoint_path(
        model, [host['batches'][k % 2] for k in range(CP_REQUESTS)],
        'CenterPoint requests (B=2)')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(times)
    head = model.dense_head
    log(f'  launches over {CP_REQUESTS} requests: {launches}')
    log(f'  ms/batch (B={CP_B}, N={CP_N}, 5 channels: residual sparse '
        f'backbone over {host["batches"][0]["down4_valid"].shape[1]}-row '
        f'levels + BEV backbone + CenterHead: the top '
        f'{int(head.model_cfg.POST_PROCESSING.MAX_OBJ_PER_SAMPLE)} of '
        f'{head.heads_list[0].hm[-1].out_channels} classes x the map\'s '
        f'pixels, NMS): median {ms:.3f}, range {min(times):.3f}-'
        f'{max(times):.3f}, all {[round(t, 3) for t in times]}; peak '
        f'memory {peak:.3f} GiB; detections a frame '
        f'{dets["count"].tolist()} on {smi}')
    rec = {'ms_per_batch': ms, 'all_ms': times, 'launches': launches,
           'range_ms': [min(times), max(times)], 'peak_gib': peak,
           'host_ms_a_frame': host['host_ms'],
           'voxels_before_cap': host['before'],
           'voxels_after_cap': host['after'],
           'detections': dets['count'].tolist()}
    def request():
        with torch.no_grad():
            return head_detections(model(host['batches'][0]))
    rec['profile'] = centerpoint_profile(model, request,
                                         'one CenterPoint request (B=2)')

    log('== 46. CenterPoint card vs CPU, one request (B=1)')
    one = {k: v[:1] for k, v in host['batches'][0].items()}
    rec['card_vs_cpu'] = centerpoint_cpu_phase(model, cfg, one)
    del model, host

    log('== 47. CenterPoint train path')
    cfg, model, opt, step = build_centerpoint_trainer('cuda')
    batches, host_ms, before, after = pv_train_batches(
        cfg, range(1400, 1400 + CP_TRAIN_BATCHES), sizes=WAYMO_SIZES,
        n=CP_N, channels=5)
    log(f'  host voxelization + sparse plan at the train settings: '
        f'{statistics.median(host_ms):.3f} ms a frame; voxels a frame in '
        f'range {before}, after the cap of 150000 {after}; gt boxes a frame '
        f'{batches[0]["gt_boxes"].shape[1]} (Vehicle, Pedestrian, Cyclist '
        f'in turn)')
    from spsnet_torch.ops import _build
    step(batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    norms = []
    times, launches = train_path(
        model, step, [batches[k % CP_TRAIN_BATCHES]
                      for k in range(1, 1 + CP_TRAIN_STEPS)],
        {k: 0 for k in _build.LAUNCHES},
        lambda: norms.append(float(opt.grad_norm)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(times)
    log(f'  ms/train step (B={PV_TRAIN_B}, N={CP_N}: residual sparse '
        f'backbone + BEV backbone + CenterHead, heatmap targets, focal and '
        f'L1 losses, backward, adam_onecycle): median {ms:.3f}, range '
        f'{min(times):.3f}-{max(times):.3f}, all '
        f'{[round(t, 3) for t in times]}; grad norms '
        f'{[round(n, 4) for n in norms]}; peak memory {peak:.3f} GiB on '
        f'{smi}')
    train = {'ms': ms, 'all_ms': times, 'launches': launches,
             'range_ms': [min(times), max(times)], 'peak_gib': peak,
             'grad_norms': norms, 'host_ms_a_frame': host_ms,
             'voxels_before_cap': before, 'voxels_after_cap': after}
    train['profile'] = centerpoint_profile(
        model, lambda: step(batches[1]), 'one CenterPoint train step (B=2)')
    del model, step

    log(f'== 48. CenterPoint card vs CPU, one train step (cut: '
        f'{CP_TRAIN_CUT})')
    cfg = build_centerpoint_trainer('cpu', cut=True)[0]
    batch = pv_train_batches(cfg, [1450, 1451], sizes=WAYMO_SIZES,
                             n=CP_TRAIN_CUT['points'], channels=5)[0][0]
    train['card_vs_cpu'] = centerpoint_train_cpu_phase(
        {k: v[:1].cpu() for k, v in batch.items()})
    return rec, train


def voxelrcnn_waymo_phase(smi):
    """Phase 49: waymo_models/voxel_rcnn_with_centerhead_dyn_voxel.yaml at
    full width, one request of B = 1 (65 536 points, 5 channels) after a
    warm-up: the CenterHead RPN's detections are the proposals, three ball
    queries over the 150 000-row levels of x_conv2-4, each held to its
    plain version. Returns the request's record and the kernel calls."""
    log('== 49. Waymo Voxel R-CNN with a CenterHead RPN, one request (B=1)')
    cfg, model = build_voxel_detector(
        'waymo_models/voxel_rcnn_with_centerhead_dyn_voxel', 'cuda')
    host = pv_host_batches(cfg, [1500], 1, CP_N, 5)
    rec = voxelrcnn_path(model, cfg, host['batches'],
                         'Waymo Voxel R-CNN request (B=1)')
    rec.update(host_ms_a_frame=host['host_ms'],
               voxels_before_cap=host['before'],
               voxels_after_cap=host['after'])
    shapes = voxelrcnn_shapes_phase(model, host['batches'][0], 'Waymo')
    return rec, shapes


# ------------------------------------------------------------ PV-RCNN++

@contextlib.contextmanager
def calls_of(owner, attr):
    """Record each call of ``owner.attr`` while open: a list of (args,
    kwargs, output)."""
    fn = getattr(owner, attr)
    seen = []

    def recorded(*args, **kwargs):
        out = fn(*args, **kwargs)
        seen.append((args, kwargs, out))
        return out
    setattr(owner, attr, recorded)
    try:
        yield seen
    finally:
        setattr(owner, attr, fn)


def pvpp_keypoints(model, batch):
    """The sectors' quotas (B, S) and the valid keypoints a frame of one
    PV-RCNN++ request of ``batch``."""
    from spsnet_torch.models.pfe import voxel_set_abstraction as vsa
    with calls_of(vsa, 'sector_fps_dense') as seen, torch.no_grad():
        out = model(batch)
    return seen[0][2][2].tolist(), out['point_valid'].sum(1).tolist()


def pvpp_profile(model, fn, what):
    """A CUDA-kernel breakdown of one call of ``fn`` (a PV-RCNN++ request
    or train step of ``model``): the sparse and BEV backbones, the VSA,
    every VectorPool module (its three-NN included) and the RoI head as
    ranges; the device shares of K6 (``three_nn_prepass_kernel`` and
    ``three_nn_scan_kernel``), K1
    (``fps_kernel``) and the sparse gathers' backward (the scatter-add
    ``_scatter_gather_elementwise_kernel``), and of the backward."""
    from spsnet_torch.models.model_utils.vector_pool import \
        VectorPoolAggregationMSG
    names = {'backbone_3d': 'sparse backbone', 'backbone_2d': 'BEV backbone',
             'pfe': 'VSA', 'roi_head': 'RoI head'}
    modules = [(getattr(model, a), n) for a, n in names.items()] + [
        (m, 'VectorPool') for m in model.modules()
        if isinstance(m, VectorPoolAggregationMSG)]

    def ranged(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    for module, name in modules:
        module.forward = ranged(name, module.forward)
    try:
        prof = profile_phase(fn, what, ranges=(*names.values(),
                                               'VectorPool'))
    finally:
        for module, _ in modules:
            del module.forward
    for span in prof['ranges'].values():
        span['device_share'] = span['device_ms'] / prof['device_ms']
    prof['backward_share'] = prof['backward_device_ms'] / prof['device_ms']
    for key, pattern in (('k6', 'three_nn_'), ('k1', 'fps_kernel'),
                         ('gathers_backward', 'scatter_gather')):
        ms = sum(v for k, v in prof['kernel_ms'].items() if pattern in k)
        prof[f'{key}_device_ms'] = ms
        prof[f'{key}_share'] = ms / prof['device_ms']
    log('  device shares: ' + ', '.join(
        f'{k} {v["device_share"]:.3f}' for k, v in prof['ranges'].items()) +
        f', K6 {prof["k6_share"]:.3f} ({prof["k6_device_ms"]:.3f} ms), K1 '
        f'{prof["k1_share"]:.3f} ({prof["k1_device_ms"]:.3f} ms), the '
        f'gathers\' backward {prof["gathers_backward_share"]:.3f}, backward '
        f'{prof["backward_share"]:.3f}')
    return prof


def three_nn_library(unknown, known):
    """The library yardstick of a three-NN call: ``torch.cdist`` and
    ``topk(3, largest=False)`` over the plain version's blocks of unknown
    points (not bit-identical: cdist takes its own form)."""
    from spsnet_torch.ops.interpolate import _BLOCK_ENTRIES
    B, N, _ = unknown.shape
    chunk = max(1, _BLOCK_ENTRIES // max(1, B * known.shape[1]))
    return [torch.cdist(unknown[:, n0:n0 + chunk], known).topk(
        3, largest=False) for n0 in range(0, N, chunk)]


def three_nn_bound(b, n, m, pairs):
    """Bound of a three-NN over (b, n) queries and (b, m) known points that
    evaluates ``pairs`` pairs: both read once, (b, n, 3) distances and
    indices written; 9 operations a pair (3 mul and 2 add for the cross
    product, the norms' sum, the doubling, the subtraction, a compare) at
    the fp32 peak, which counts an FMA as two operations: K6's separately
    rounded operations issue at half that rate. The function's bound takes
    3 pairs a query, the least any method evaluates."""
    return bound_ms(b * (n + m) * 12 + b * n * 3 * 12, pairs * 9)


def events_ms(fn):
    """(output, milliseconds) of one call of ``fn`` between CUDA events
    (a call long enough that the host's issue time does not count)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def three_nn_call(unknown, known, what):
    """K6 against the plain three-NN at one shape, bit for bit; the pairs
    the scan evaluated (the kernel's counter) against all pairs, the rows
    it scans a batch row (three past the padded run's start,
    ``three_nn_run_start``), the device time of a
    call (its pre-pass and scan, ``device_ms_by_kernel``), event times of
    one call of the plain version and of the library yardstick (after
    K6's calls, so warm), and ``three_nn_bound`` three ways: the
    function's (``bound_ms``, 3 pairs a query), over the pairs this call
    scanned (``scanned_pairs_bound_ms``; over the call's time, the pair
    loop's share of its peak, ``pair_loop_share``) and over all pairs
    (``all_pairs_bound_ms``, a scan of every row). Returns the call's
    record."""
    from spsnet_torch.ops.interpolate import (three_nn_kernel,
                                              three_nn_plain,
                                              three_nn_run_start)
    b, n, _ = unknown.shape
    m = known.shape[1]
    counter = torch.zeros(b, dtype=torch.int64, device=unknown.device)
    got = three_nn_kernel(unknown, known, counter)
    torch.cuda.synchronize()
    want, plain_ms = events_ms(lambda: three_nn_plain(unknown, known))
    require_equal(got[0].view(torch.int32), want[0].view(torch.int32),
                  f'K6 vs plain {what}: squared distances (bits)')
    require_equal(got[1], want[1], f'K6 vs plain {what}: indices')
    del want
    start = three_nn_run_start(known).tolist()
    rows = [min(m, r + 3) for r in start]
    scanned = counter.tolist()
    ms, by_kernel = device_ms_by_kernel(
        lambda: three_nn_kernel(unknown, known), reps=3)
    rec = {'B': b, 'N': n, 'M': m, 'pairs': b * n * m,
           'pairs_scanned': sum(scanned), 'pairs_scanned_a_row': scanned,
           'run_start': start, 'rows_scanned': rows, 'ms': ms,
           'ms_by_kernel': by_kernel,
           'plain_ms': plain_ms,
           'library_ms': events_ms(lambda: three_nn_library(unknown,
                                                            known))[1]}
    rec['bound_ms'], rec['bound_by'] = three_nn_bound(b, n, m, b * n * 3)
    rec['scanned_pairs_bound_ms'] = three_nn_bound(
        b, n, m, rec['pairs_scanned'])[0]
    rec['all_pairs_bound_ms'] = three_nn_bound(b, n, m, b * n * m)[0]
    rec['pair_loop_share'] = rec['scanned_pairs_bound_ms'] / ms
    log(f'  K6 {what} ({b}, {n}) over ({b}, {m}): kernel {ms:.4f} ms '
        f'(device: ' + ', '.join(f'{k} {v:.4f}' for k, v in
                                 by_kernel.items()) +
        f'); pairs scanned {rec["pairs_scanned"]:.4e} of {b * n * m:.4e} '
        f'({rec["pairs_scanned"] / (b * n * m):.4f}), padded run from row '
        f'{start}, rows scanned {rows} of {m}; plain {plain_ms:.3f} ms, '
        f'cdist + topk '
        f'{rec["library_ms"]:.3f} ms (events); bound '
        f'{rec["bound_ms"]:.4f} ms ({rec["bound_by"]}), '
        f'{rec["scanned_pairs_bound_ms"]:.4f} ms over the pairs scanned '
        f'(pair loop at {rec["pair_loop_share"]:.3f} of its peak), '
        f'{rec["all_pairs_bound_ms"]:.4f} ms over all pairs')
    return rec


def k6_summary(calls, what):
    """The sums over K6's ``calls`` (``three_nn_call`` records), logged."""
    keys = ('ms', 'plain_ms', 'library_ms', 'bound_ms',
            'scanned_pairs_bound_ms', 'all_pairs_bound_ms', 'pairs',
            'pairs_scanned')
    out = {k: sum(c[k] for c in calls) for k in keys}
    out['pair_loop_share'] = out['scanned_pairs_bound_ms'] / out['ms']
    log(f'  K6 over {what}: {out["ms"]:.3f} ms (device), pairs scanned '
        f'{out["pairs_scanned"]:.4e} of {out["pairs"]:.4e}, plain '
        f'{out["plain_ms"]:.3f} ms, cdist + topk {out["library_ms"]:.3f} ms, '
        f'bound {out["bound_ms"]:.4f} ms ({out["bound_ms"] / out["ms"]:.4f} '
        f'of the time), {out["scanned_pairs_bound_ms"]:.3f} ms over the '
        f'pairs scanned (pair loop at {out["pair_loop_share"]:.3f} of its '
        f'peak), {out["all_pairs_bound_ms"]:.3f} ms over all pairs')
    return out


def pvpp_shapes_phase(model, batch):
    """Phase 51: the kernels of one PV-RCNN++ request at its shapes: each
    sector's masked K1 call (its quota prefix) against the plain FPS,
    indices equal, with device time, plain time and bound, and the first
    sector also at K picks (the prefix's saving); each of the VSA's six K6
    calls against the plain three-NN bit for bit (``three_nn_call``).
    Returns {'fps': [records], 'three_nn': [records], 'fps_at_k': record,
    'errs'}."""
    import spsnet_torch.ops as ops_pkg
    from spsnet_torch.models.model_utils import vector_pool
    from spsnet_torch.ops.sampling import (farthest_point_sample_kernel,
                                           farthest_point_sample_plain)
    with calls_of(ops_pkg, 'farthest_point_sample') as fps, \
            calls_of(vector_pool, 'three_nn') as nn3, torch.no_grad():
        model(batch)
    rec = {'fps': [], 'three_nn': [], 'errs': {'fps': 0.0, 'three_nn': 0.0}}
    k = model.pfe.num_keypoints
    for s, (args, kwargs, out) in enumerate(fps):
        xyz, npoint = args[0], args[1]
        mask = kwargs['valid_mask']
        b, n, _ = xyz.shape
        require_equal(out, farthest_point_sample_plain(xyz, npoint, mask),
                      f'K1 vs plain, sector {s} ({b}, {n}) -> {npoint}, '
                      f'{int(mask.sum())} points in the mask')
        r = {'sector': s, 'B': b, 'N': n, 'npoint': npoint,
             'masked_points': mask.sum(1).tolist(),
             'ms': device_ms(lambda: farthest_point_sample_kernel(
                 xyz, npoint, mask), reps=3),
             'plain_ms': cuda_ms(lambda: farthest_point_sample_plain(
                 xyz, npoint, mask), reps=1)}
        r['bound_ms'], r['bound_by'] = fps_bound(b, n, npoint)
        log(f'  K1 sector {s} -> {npoint}: kernel {r["ms"]:.4f} ms '
            f'(device), plain {r["plain_ms"]:.3f} ms, bound '
            f'{r["bound_ms"]:.4f} ms')
        rec['fps'].append(r)
    s = max(range(len(fps)), key=lambda i: fps[i][0][1])
    (xyz, npoint), mask = fps[s][0][:2], fps[s][1]['valid_mask']
    full = farthest_point_sample_kernel(xyz, k, mask)
    require_equal(full[:, :npoint], fps[s][2],
                  f'K1 at {k} picks, its prefix vs the quota prefix call')
    rec['fps_at_k'] = {'sector': s, 'npoint': k, 'ms': device_ms(
        lambda: farthest_point_sample_kernel(xyz, k, mask), reps=3)}
    rec['fps_at_k']['bound_ms'] = fps_bound(*xyz.shape[:2], k)[0]
    log(f'  K1 sector {s} at K = {k} picks: {rec["fps_at_k"]["ms"]:.4f} ms '
        f'(device) against {rec["fps"][s]["ms"]:.4f} ms at its quota '
        f'prefix of {npoint}')
    for i, (args, _, _) in enumerate(nn3):
        rec['three_nn'].append(three_nn_call(
            args[0].contiguous(), args[1].contiguous(), f'VSA call {i}'))
    return rec


def pvpp_path(model, requests, what):
    """A warm-up and the timed PV-RCNN++ requests (forward +
    ``post_processing``) with the launch counters zeroed just before:
    PP_LAUNCHES a request. Returns its record."""
    post = model.model_cfg.POST_PROCESSING
    detect(model, requests[0], post)   # cuDNN's timed choice, apart
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches = main_path(model, requests, post, PP_LAUNCHES, what)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out, dets = detect(model, requests[0], post)
    quotas, valid = pvpp_keypoints(model, requests[0])
    ms = statistics.median(times)
    rec = {'B': requests[0]['points'].shape[0], 'ms_per_batch': ms,
           'all_ms': times, 'range_ms': [min(times), max(times)],
           'launches': launches, 'peak_gib': peak,
           'kept_boxes': dets['count'].tolist(),
           'valid_rois': out['roi_valid'].sum(1).tolist(),
           'valid_keypoints': valid, 'sector_quotas': quotas}
    log(f'  launches over {len(requests)} requests: {launches}')
    log(f'  ms/batch ({what}: voxel stack + CenterHead + proposal NMS + SPC '
        f'keypoints + VectorPool VSA + point head + VectorPool RoI-grid '
        f'head + NMS): median {ms:.3f}, range {min(times):.3f}-'
        f'{max(times):.3f}, all {[round(t, 3) for t in times]}; peak memory '
        f'{peak:.3f} GiB')
    log(f'  first request: valid keypoints a frame {valid}, sector quotas '
        f'{quotas}; {rec["kept_boxes"]} boxes kept, {rec["valid_rois"]} '
        f'RoIs')
    return rec


def cube_within(xyz, ctr, radius, card, own, e):
    """``ball_within`` for the cube query: the first point in one list and
    not the other lies within the rounding slack of inputs ``e`` apart
    (2 e, the centre's and the point's coordinate) of the cube's face
    (its Chebyshev distance to the centre against the half-extent)."""
    rows, cols = (card != own).any(-1).nonzero(as_tuple=True)
    worst = 0.0
    for r, c in zip(rows.tolist(), cols.tolist()):
        p = min(set(card[r, c].tolist()) ^ set(own[r, c].tolist()))
        d = float((xyz[r, p].double() - ctr[r, c].double()).abs().max())
        worst = max(worst, abs(d - radius) / (2 * e + 1e-6))
    return worst


class PpDecisions(CpDecisions):
    """``CpDecisions`` of PV-RCNN++: the CenterHead's top-k, the proposal
    NMS, and further its SPC keypoints (each point's RoI mask and sector:
    in 'check' mode equal, or where they differ within the rounding slack
    of the RoIs' difference from the reference's, or of atan2 at a sector
    edge) and its RoI pool's cube query (equal, or each differing list's
    first point within the slack of the grid points' difference from the
    face), and its binning of the neighbours into the cells (each
    differing cell or hit within that slack of a cell edge or of the
    face). Then this run goes on from the reference's."""

    def __init__(self, mode, ref=None, thresholds=()):
        super().__init__(mode, ref)
        self.thresholds = thresholds
        for kind in ('roi_mask', 'sectors', 'cube', 'bins'):
            self.used[kind] = []
            self.inputs[kind] = []
        self.differ.update(roi_mask=0, sectors=0, cube=0, bins=0)

    def topk(self, real, scores, k):
        if self.mode != 'replay':
            return super().topk(real, scores, k)
        idx = self._ref('topk')[1].to(scores.device)
        return self._use('topk', (scores.gather(-1, idx), idx))

    def roi_mask(self, real, xyz, rois, radius):
        own = real(xyz, rois, radius)
        if self.mode == 'record':
            self.inputs['roi_mask'].append(rois.detach().cpu())
            return self._use('roi_mask', own)
        want = self._ref('roi_mask').to(own.device)
        if self.mode == 'check' and not torch.equal(own, want):
            from spsnet_torch.models.pfe.voxel_set_abstraction import _norm3
            self.differ['roi_mask'] += int((own != want).sum())
            ref = self.ref.inputs['roi_mask'][len(self.used['roi_mask'])]
            e = float((rois.detach().cpu() - ref).abs().max())
            x, r = xyz.detach().cpu().double(), rois.detach().cpu().double()
            d = _norm3(x[:, :, None] - r[:, None, :, 0:3])
            d = torch.where((r[..., 3] <= 0)[:, None], torch.inf, d)
            m, nearest = d.min(-1)
            edge = _norm3(r[..., 3:6] / 2).gather(1, nearest) + radius
            gap = float((m - edge).abs()[(own != want).cpu()].max())
            self.notes.append(f'SPC RoI mask: {int((own != want).sum())} '
                              f'points differ, each {gap:.3e} m from the '
                              f'threshold; the RoIs {e:.3e} apart')
            if gap > 3 * e + 1e-5:
                raise AssertionError(self.notes[-1])
        return self._use('roi_mask', want)

    def sectors(self, real, xyz, num_sectors):
        own = real(xyz, num_sectors)
        if self.mode == 'record':
            return self._use('sectors', own)
        want = self._ref('sectors').to(own.device)
        if self.mode == 'check' and not torch.equal(own, want):
            diff = (own != want).cpu()
            self.differ['sectors'] += int(diff.sum())
            x = xyz.detach().cpu().double()
            pos = (torch.atan2(x[..., 1], x[..., 0]) + np.pi) / \
                (2 * np.pi / num_sectors)
            gap = float((pos - pos.round()).abs()[diff].max())
            self.notes.append(f'sectors: {int(diff.sum())} points differ, '
                              f'each {gap:.3e} sectors from an edge')
            if gap > 1e-5:
                raise AssertionError(self.notes[-1])
        return self._use('sectors', want)

    def bins(self, real, local, radius, grid_dims, ball):
        own = real(local, radius, grid_dims, ball)
        if self.mode == 'record':
            self.inputs['bins'].append((local.detach().cpu(),))
            return self._use('bins', own)
        want = tuple(w.to(o.device) for w, o in zip(self._ref('bins'), own))
        differ = (own[0] != want[0]) | (own[1] != want[1])
        if self.mode == 'check' and differ.any():
            self.differ['bins'] += int(differ.sum())
            e = self._inputs_apart('bins', local)
            x = local.detach().cpu().double()[differ.cpu()]
            g = grid_dims.cpu().double()
            u = (x + radius) / (2 * radius) * g
            edge = ((u - u.round()).abs() * 2 * radius / g).amin(-1)
            face = (x.norm(dim=-1) if ball else x.abs().amax(-1)) - radius
            gap = float(torch.minimum(edge, face.abs()).max())
            self.notes.append(f'cell binning: {int(differ.sum())} '
                              f'neighbours differ, each {gap:.3e} from a '
                              f'cell edge or the face; inputs {e:.3e} apart')
            if gap > 2 * e + 1e-6:
                raise AssertionError(self.notes[-1])
        return self._use('bins', want)

    def cube(self, real, radius, nsample, xyz, new_xyz):
        own = real(radius, nsample, xyz, new_xyz)
        if self.mode == 'record':
            self.inputs['cube'].append((xyz.detach().cpu(),
                                        new_xyz.detach().cpu()))
            return self._use('cube', own)
        want = self._ref('cube').to(own.device)
        if self.mode == 'check' and not torch.equal(own, want):
            self.differ['cube'] += 1
            e = self._inputs_apart('cube', xyz, new_xyz)
            ratio = cube_within(xyz.detach().cpu(), new_xyz.detach().cpu(),
                                radius, want.cpu(), own.cpu(), e)
            self.notes.append(f'cube query call {len(self.used["cube"])}: '
                              f'{int((own != want).any(-1).sum())} '
                              f'lists differ; inputs {e:.3e} apart; each '
                              f'within {ratio:.3f} of the rounding slack')
            if ratio > 1:
                raise AssertionError(self.notes[-1])
        return self._use('cube', want)


def pvpp_stages(model, batch):
    """A PV-RCNN++ forward of ``batch`` stage by stage, without gradients:
    {'rpn': the voxel stack's batch up to the CenterHead, 'pre': the
    proposals, 'pfe', 'point', 'out': the RoI head's}."""
    with torch.no_grad():
        rpn = model.stage_one(batch)
        pre = model.roi_head.propose_and_assign(rpn)
        pfe = model.pfe(dict(rpn, rois=pre['rois'],
                             roi_labels=pre['roi_labels']))
        point = model.point_head(pfe)
        return {'rpn': rpn, 'pre': pre, 'pfe': pfe, 'point': point,
                'out': model.roi_head(point, pre)}


def _voxel_stack_vs_cpu(model, cpu, batch, host):
    """The voxel stack of one request on the card and on the CPU, each CPU
    stage from the card's input: voxel features, the sparse levels, the
    BEV scatter (bit for bit) and the BEV backbone. Returns (scaled
    errors, the card's BEV backbone output)."""
    errs = []
    with torch.no_grad():
        g = model.vfe(batch)
        c = cpu.vfe(host)
        errs.append(_require_scaled(g['voxel_features'], c['voxel_features'],
                                    'voxel features'))
        g = model.backbone_3d(g)
        c = cpu.backbone_3d(dict(host, voxel_features=g[
            'voxel_features'].cpu()))
        for name, t in c['multi_scale_3d_features'].items():
            errs.append(_require_scaled(
                g['multi_scale_3d_features'][name], t, f'sparse level {name}'))
        g = model.map_to_bev_module(g)
        c = cpu.map_to_bev_module(_cpu_tree(dict(
            host, **{k: g[k] for k in ('encoded_voxel_features',
                                       'encoded_voxel_coords',
                                       'encoded_voxel_valid')})))
        require_equal(g['spatial_features'], c['spatial_features'],
                      'card vs CPU: the BEV scatter (HeightCompression)')
        g = model.backbone_2d(g)
        c = cpu.backbone_2d({'spatial_features': g['spatial_features'].cpu()})
        errs.append(_require_scaled(g['spatial_features_2d'],
                                    c['spatial_features_2d'],
                                    'BEV backbone'))
    return errs, g


def pvpp_cpu_phase(model, cfg_name, batch):
    """Phase 52: one PV-RCNN++ request (B = 1) on the card and on the CPU
    with the same weights and host tables, stage by stage from the card's
    inputs: the voxel stack (``_voxel_stack_vs_cpu``); the CenterHead's
    maps, its top-500 candidates (a top 500 of the CPU's scores within
    CP_SCORE_TOL, then replayed) and boxes; the proposal NMS
    (``nms_agrees``); the SPC RoI mask and sectors (within their slack,
    replayed), the keypoints (K1 vs plain: equal); the VSA's BEV features
    and each VectorPool source on the first PP_CPU_KEYPOINTS keypoints (in
    eval mode a row-wise function of each keypoint, so the subset is
    exact: the CPU's three-NN over all of them is 3.8e10 pairs), its
    fusion and the point head from the card's features; the RoI head
    (``_roi_stage_vs_cpu`` with ``PpDecisions``: the cube query within its
    slack, replayed)."""
    _, cpu = build_voxel_detector(cfg_name, 'cpu')
    cpu.load_state_dict(model.state_dict())
    host = _cpu_tree(batch)
    card = PpDecisions('record')
    with prcnn_decisions(card):
        st = pvpp_stages(model, batch)
    errs, g = _voxel_stack_vs_cpu(model, cpu, batch, host)
    own = PpDecisions('check', card)
    with torch.no_grad(), prcnn_decisions(own):
        ch = cpu.dense_head({'spatial_features_2d':
                             g['spatial_features_2d'].cpu()})
        for key in ('heatmap', 'center', 'center_z', 'dim', 'rot'):
            errs.append(_require_scaled(st['rpn']['center_head_ret'][key],
                                        ch['center_head_ret'][key],
                                        f'CenterHead {key}'))
        errs.append(_require_scaled(st['rpn']['batch_box_preds'],
                                    ch['batch_box_preds'],
                                    'CenterHead top-500 boxes'))
        pre = cpu.roi_head.propose_and_assign(dict(
            ch, cls_preds_normalized=True))
        errs.append(_require_scaled(st['pre']['rois'], pre['rois'], 'RoIs'))
        # the VSA from the card's stage-one outputs and RoIs
        rpn = _cpu_tree(dict(st['rpn'], rois=st['pre']['rois'],
                             roi_labels=st['pre']['roi_labels']))
        xyz = rpn['points'][..., :3].contiguous()
        kp_idx, kp_valid = cpu.pfe.sample_keypoints(rpn, xyz)
    for note in own.notes:
        log(f'  card vs CPU {note}')
    pg = st['pfe']
    require_equal(pg['keypoint_idx'], kp_idx,
                  'card vs CPU: SPC keypoints (masked K1 vs plain FPS)')
    require_equal(pg['point_valid'].int(), kp_valid.int(),
                  'card vs CPU: valid keypoints')
    sub = slice(0, PP_CPU_KEYPOINTS)
    pfe = cpu.pfe
    with torch.no_grad():
        kp, valid = pg['point_coords'].cpu(), kp_valid
        feats = [torch.where(valid[..., None], pfe.bev_interpolate(
            kp, rpn['spatial_features']), 0.0)]
        sources = [(pfe.SA_rawpoints, xyz, rpn['points'][..., 3:])] + [
            (group, pfe.voxel_centers(rpn, name),
             rpn['multi_scale_3d_features'][name])
            for name, group in pfe.SA_layers.items()]
        t0 = time.perf_counter()
        for group, support, sf in sources:
            feats.append(group(support, sf, kp[:, sub].contiguous(),
                               valid[:, sub]))
        cpu_s = time.perf_counter() - t0
        width = [f.shape[-1] for f in feats]
        card_feats = pg['point_features_before_fusion']
        errs.append(_require_scaled(card_feats[..., :width[0]], feats[0],
                                    'VSA BEV features'))
        start = width[0]
        for (group, _, _), f, w in zip(sources, feats[1:], width[1:]):
            errs.append(_require_scaled_rows(
                card_feats[:, sub, start:start + w], f,
                f'VSA VectorPool source at {start}, the first '
                f'{PP_CPU_KEYPOINTS} keypoints'))
            start += w
        fused = pfe.vsa_point_feature_fusion(card_feats.cpu())
        errs.append(_require_scaled_rows(pg['point_features'], fused,
                                         'VSA fusion'))
        ph = cpu.point_head(_cpu_tree(pg))
        errs.append(_require_scaled_rows(
            st['point']['point_head_simple_ret']['point_cls_preds'],
            ph['point_head_simple_ret']['point_cls_preds'],
            'point head cls preds'))
        huge = int((card_feats.abs().amax(-1) > 1e3).sum())
    log(f'  keypoints whose features exceed 1e3 (a clipped negative norm of '
        f'the raw points\' interpolation weights, ROADMAP Queue 3): {huge} '
        f'of {card_feats.shape[1]}')
    log(f'  the CPU\'s VectorPool sources over the first {PP_CPU_KEYPOINTS} '
        f'of {kp.shape[1]} keypoints: {cpu_s:.1f} s')
    roi_errs, notes, _, _ = _roi_stage_vs_cpu(
        model, cpu, st['point'], st['out'], model.model_cfg.POST_PROCESSING,
        PpDecisions)
    return {'max_scaled_err': max(errs + roi_errs), 'notes': own.notes,
            'roi_notes': notes, 'differ': own.differ, 'huge_keypoints': huge,
            'cpu_keypoints': PP_CPU_KEYPOINTS, 'cpu_vector_pool_s': cpu_s}


def cut_to(cfg, cut):
    """``cfg`` with the range, the voxel caps, the sampled points and
    (where ``cut`` names them) the keypoints of ``cut`` (a
    PP_TRAIN_CUT-like dict)."""
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(cut['range'])
    if 'keypoints' in cut:
        cfg.MODEL.PFE.NUM_KEYPOINTS = cut['keypoints']
    for step in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if step.NAME == 'transform_points_to_voxels':
            step.MAX_NUMBER_OF_VOXELS = {'train': cut['voxels'],
                                         'test': cut['voxels']}
        if step.NAME == 'build_sparse_conv_plan':
            step.MAX_VOXELS_PER_LEVEL = cut['voxels']
        if step.NAME == 'sample_points':
            step.NUM_POINTS = {'train': cut['points'], 'test': cut['points']}
    return cfg


def build_pvpp_trainer(device, cut=False):
    """waymo_models/pv_rcnn_plusplus.yaml as ``build_voxel_detector``
    makes it (seed-0 weights; with ``cut``, on PP_TRAIN_CUT's range, voxel
    caps and keypoints) in train mode, its adam_onecycle optimizer and
    ``make_train_step``: (cfg, model, optimizer, step)."""
    from spsnet_torch.models import build_detector_from_cfg
    from spsnet_torch.runtime.trainer import make_train_step
    from spsnet_torch.zoo import pv_rcnn_plusplus_waymo_cfg
    cfg = pv_rcnn_plusplus_waymo_cfg()
    if cut:
        cut_to(cfg, PP_TRAIN_CUT)
    model = build_detector_from_cfg(
        cfg, device=device, generator=torch.Generator().manual_seed(0))
    model.train()
    optimizer = _kitti_optimizer(cfg.OPTIMIZATION, model.parameters())
    return cfg, model, optimizer, make_train_step(model, optimizer)


def pvpp_train_path(smi):
    """Phase 54: PV-RCNN++ training at full width (PP_TRAIN_STEPS steps of
    PV_TRAIN_B Waymo scenes over PP_TRAIN_BATCHES planned batches, a
    warm-up first, gt at the Waymo sizes plus ``gt_at_proposals``' boxes,
    at the Waymo sizes too): ms, the proposal NMS's share, the RoI counts,
    grad norms, peak memory and a profile. Returns its record."""
    from spsnet_torch.models.roi_heads import pvrcnn_head
    from spsnet_torch.ops import _build
    cfg, model, opt, step = build_pvpp_trainer('cuda')
    batches, host_ms, before, after = pv_train_batches(
        cfg, range(1600, 1600 + PP_TRAIN_BATCHES), sizes=WAYMO_SIZES,
        n=CP_N, channels=5)
    log(f'  host voxelization + sparse plan at the train settings: '
        f'{statistics.median(host_ms):.3f} ms a frame; voxels a frame in '
        f'range {before}, after the cap of 150000 {after}')
    tcfg = cfg.MODEL.ROI_HEAD.TARGET_CONFIG
    step(gt_at_proposals(model, batches[0], WAYMO_SIZES))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    norms, stats = [], []
    with roi_head_outputs(model) as outs, \
            timed_calls(pvrcnn_head, 'proposal_layer') as nms_calls:
        def after_step():
            out = outs.pop()
            norms.append(float(opt.grad_norm))
            stats.append(dict(roi_counts(out['roi_head_ret']['targets'],
                                         tcfg),
                              valid_keypoints=out['point_valid'].sum(1)
                              .tolist()))
            log(f'    grad norm {norms[-1]:.4f} (clip 10); {stats[-1]}')
        times, launches = train_path(
            model, step, at_proposals(model, [
                batches[k % PP_TRAIN_BATCHES]
                for k in range(1, 1 + PP_TRAIN_STEPS)], WAYMO_SIZES),
            {**{k: 0 for k in _build.LAUNCHES}, **PP_LAUNCHES}, after_step)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.synchronize()
    nms = [h for h, _ in range_ms(nms_calls)]
    ms = statistics.median(times)
    shares = [n / t for n, t in zip(nms[-len(times):], times)]
    log(f'  ms/train step (B={PV_TRAIN_B}, N={CP_N}: voxel stack + '
        f'CenterHead targets + proposal NMS (pre 9000, post 512) + RoI '
        f'sampling + SPC keypoints + VectorPool VSA + point head + '
        f'VectorPool RoI-grid head + three losses + backward + '
        f'adam_onecycle): median {ms:.3f}, range {min(times):.3f}-'
        f'{max(times):.3f}, all {[round(t, 3) for t in times]}; proposal '
        f'NMS share {min(shares):.3f}-{max(shares):.3f}; grad norms '
        f'{[round(n, 4) for n in norms]}; peak memory {peak:.3f} GiB on '
        f'{smi}')
    rec = {'ms': ms, 'all_ms': times, 'range_ms': [min(times), max(times)],
           'launches': launches, 'peak_gib': peak, 'grad_norms': norms,
           'roi_stats': stats, 'nms_share': [min(shares), max(shares)],
           'host_ms_a_frame': host_ms, 'voxels_before_cap': before,
           'voxels_after_cap': after}
    rec['profile'] = pvpp_profile(
        model, lambda: step(gt_at_proposals(model, batches[1],
                                            WAYMO_SIZES)),
        'one PV-RCNN++ train step (B=2)')
    return rec


def pvpp_train_repeat(runs):
    """``--pvpp-train-repeat N``: phase 54's warm-up and steps (seed-0
    weights built anew, its batches, its checks) N times with
    ``gt_at_proposals``' boxes at the proposals' decoded sizes and N times
    held within GT_SIZE_SPAN of the Waymo sizes (phase 54's), then once
    each with the CenterHead's size bias raised by 29 after the warm-up
    (decoded sizes ~4e12 m, as a non-finite run of phase 54 had them); logs
    each run's failure. Returns 0."""
    from spsnet_torch.ops import _build
    cfg = build_pvpp_trainer('cuda')[0]
    batches = pv_train_batches(
        cfg, range(1600, 1600 + PP_TRAIN_BATCHES), sizes=WAYMO_SIZES,
        n=CP_N, channels=5)[0]
    want = {**{k: 0 for k in _build.LAUNCHES}, **PP_LAUNCHES}
    out = {}
    for what, sizes, jump, n in (
            ('decoded sizes', None, 0.0, runs),
            ('sizes held to the Waymo sizes', WAYMO_SIZES, 0.0, runs),
            ('decoded sizes, size bias + 29', None, 29.0, 1),
            ('sizes held, size bias + 29', WAYMO_SIZES, 29.0, 1)):
        failed = []
        for run in range(n):
            log(f'== gt at the proposals: {what}, run {run + 1} of {n}')
            _, model, _, step = build_pvpp_trainer('cuda')
            bias = [p for k, p in model.dense_head.named_parameters()
                    if k.endswith('dim.bias')]
            if not bias:
                raise ValueError('the CenterHead has no size bias')
            try:
                step(gt_at_proposals(model, batches[0], sizes))
                with torch.no_grad():
                    for p in bias:
                        p += jump
                train_path(model, step, at_proposals(model, [
                    batches[k % PP_TRAIN_BATCHES]
                    for k in range(1, 1 + PP_TRAIN_STEPS)], sizes), want)
            except AssertionError as e:
                failed.append(f'run {run + 1}: {e}')
                log(f'  failed: {e}')
            del model, step
        out[what] = failed
        log(f'gt at the proposals, {what}: {len(failed)} of {n} runs '
            f'failed {failed}')
    log(json.dumps({'pvpp_train_repeat': runs, 'failed': out}))
    return 0


def pvpp_train_cpu_phase(batch):
    """Phase 55: one PV-RCNN++ train step on one frame (``batch``, on the
    CPU; PP_TRAIN_CUT) on the card and on the CPU from the same weights,
    RoI draws and dropout masks, and on the CPU from weights jittered by
    WEIGHT_JITTER. The heatmap targets and keypoint labels identical;
    every other decision of the CPU (the CenterHead's top-k, the proposal
    NMS, the max IoUs, the SPC mask and sectors, FPS, the cube query and
    the cell binning) held
    to the card's (``PpDecisions``), the CPU going on from the card's; the
    jittered run replays the CPU's. Then the loss terms, gradients,
    updated parameters and BN running statistics as
    ``pvrcnn_train_cpu_phase`` holds them."""
    cfg, gpu, _, gpu_step = build_pvpp_trainer('cuda', cut=True)
    _, cpu, cpu_opt, cpu_step = build_pvpp_trainer('cpu', cut=True)
    _, jit, _, jit_step = build_pvpp_trainer('cpu', cut=True)
    tcfg = cfg.MODEL.ROI_HEAD.TARGET_CONFIG
    thresholds = tuple(float(tcfg[k]) for k in (
        'CLS_BG_THRESH_LO', 'CLS_BG_THRESH', 'REG_FG_THRESH',
        'CLS_FG_THRESH'))
    cpu.load_state_dict(gpu.state_dict())
    jit.load_state_dict(gpu.state_dict())
    card_batch = gt_at_proposals(gpu, {k: v.cuda() for k, v in
                                       batch.items()})
    batch = dict(batch, gt_boxes=card_batch['gt_boxes'].cpu())
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in jit.parameters():
            p.mul_(1 + WEIGHT_JITTER * torch.randn(p.shape, generator=gen))
    card = PpDecisions('record')
    with prcnn_decisions(card), roi_head_outputs(gpu) as gpu_out:
        gpu_loss, gpu_tb = gpu_step(card_batch)
    own = PpDecisions('check', card, thresholds)
    t0 = time.perf_counter()
    with prcnn_decisions(own), roi_head_outputs(cpu) as cpu_out:
        cpu_loss, cpu_tb = cpu_step(batch)
    cpu_s = time.perf_counter() - t0
    jittered = PpDecisions('replay', own)
    with prcnn_decisions(jittered):
        jit_step(batch)
    g_out, c_out = gpu_out[0], cpu_out[0]
    for key in ('heatmap_target', 'inds', 'masks'):
        require_equal(g_out['center_head_ret'][key],
                      c_out['center_head_ret'][key],
                      f'card vs CPU train step: CenterHead {key}')
    require_equal(g_out['point_head_simple_ret']['targets'].cls_labels,
                  c_out['point_head_simple_ret']['targets'].cls_labels,
                  'card vs CPU train step: keypoint labels')
    for note in own.notes + jittered.notes:
        log(f'  {note}')
    log(f'  card vs CPU decisions that differed (then replayed): '
        f'{own.differ}; the CPU step took {cpu_s:.1f} s')
    for g, c in zip(card.used['sampled'], own.used['sampled']):
        require_equal(g, c, f'card vs CPU train step: sampled RoI indices '
                            f'{tuple(g.shape)}')
    worst, terms = {}, {}
    for key in ('loss', *sorted(gpu_tb)):
        g = float(gpu_loss if key == 'loss' else gpu_tb[key])
        c = float(cpu_loss if key == 'loss' else cpu_tb[key])
        worst[key] = abs(g - c) / max(abs(c), 1e-12)
        terms[key] = (g, c)
    log('  card vs CPU loss terms: ' + ', '.join(
        f'{k} {g:.6f} / {c:.6f}' for k, (g, c) in terms.items()))
    if max(worst.values()) > TRAIN_LOSS_RTOL:
        raise AssertionError(f'card vs CPU loss terms beyond '
                             f'{TRAIN_LOSS_RTOL}: ' + ', '.join(
                                 k for k, v in worst.items()
                                 if v > TRAIN_LOSS_RTOL))
    log(f'  card vs CPU loss terms {sorted(gpu_tb)}: largest relative '
        f'difference {max(worst.values()):.3e} ({max(worst, key=worst.get)};'
        f' tolerance {TRAIN_LOSS_RTOL}); card {float(gpu_loss):.6f}, CPU '
        f'{float(cpu_loss):.6f}')
    lr = cpu_opt.lr_fn(0)
    diff = _step_difference(gpu, cpu, lr)
    base = _step_difference(jit, cpu, lr)
    log(f'  card vs CPU after the step: {diff}')
    log(f'  CPU with weights x (1 + {WEIGHT_JITTER} N(0, 1)) vs CPU (the '
        f'jitter baseline): {base}')
    limits = _require_step_within(diff, base, lr)
    by_module = _grad_by_module((gpu, jit), cpu)
    _require_modules_within(by_module)
    stats = [_bn_stats_rel_l2(a, cpu) for a in (gpu, jit)]
    limits['bn_limit'] = _require_bn_within(stats)
    return {'card': diff, 'baseline': base, 'limits': limits,
            'notes': own.notes, 'by_module': by_module, 'bn_stats': stats,
            'differ': own.differ, 'loss_rel': worst, 'cut': PP_TRAIN_CUT,
            'cpu_step_s': cpu_s}


def pvpp_resnet_phase():
    """Phase 53: waymo_models/pv_rcnn_plusplus_resnet.yaml, one request of
    B = 1 after a warm-up, and its six K6 calls against the plain
    three-NN bit for bit. Returns the request's record."""
    import spsnet_torch.ops as ops_pkg  # noqa: F401  (the kernels' package)
    from spsnet_torch.models.model_utils import vector_pool
    from spsnet_torch.ops.interpolate import three_nn_plain
    cfg, model = build_voxel_detector('waymo_models/pv_rcnn_plusplus_resnet',
                                      'cuda')
    host = pv_host_batches(cfg, [1700], 1, CP_N, 5)
    rec = pvpp_path(model, host['batches'], 'PV-RCNN++ ResNet (B=1)')
    with calls_of(vector_pool, 'three_nn') as nn3, torch.no_grad():
        model(host['batches'][0])
    for i, (args, _, out) in enumerate(nn3):
        want = three_nn_plain(*args)
        require_equal(out[0].view(torch.int32), want[0].view(torch.int32),
                      f'K6 vs plain, ResNet call {i}: squared distances')
        require_equal(out[1], want[1], f'K6 vs plain, ResNet call {i}: '
                                       'indices')
    rec['host_ms_a_frame'] = host['host_ms']
    return rec


def pvpp_phases(smi):
    """Phases 50-55; returns the PV-RCNN++ records and the K6 entry of the
    JSON line's ``kernels`` (its launches added by ``main``)."""
    log('== 50. PV-RCNN++ serving path (waymo_models/pv_rcnn_plusplus.yaml)')
    cfg, model = build_voxel_detector('waymo_models/pv_rcnn_plusplus',
                                      'cuda')
    host = pv_host_batches(cfg, range(1800, 1802), PP_B, CP_N, 5)
    rec = pvpp_path(model, [host['batches'][k % 2]
                            for k in range(PP_REQUESTS)],
                    f'PV-RCNN++ requests (B={PP_B}, N={CP_N})')
    rec.update(host_ms_a_frame=host['host_ms'],
               voxels_before_cap=host['before'],
               voxels_after_cap=host['after'])
    rec['profile'] = pvpp_profile(
        model, lambda: detect(model, host['batches'][0],
                              cfg.MODEL.POST_PROCESSING),
        'one PV-RCNN++ request (B=2)')

    log('== 51. kernels vs plain at the PV-RCNN++ shapes')
    shapes = pvpp_shapes_phase(model, host['batches'][0])
    calls = shapes['three_nn']
    k6 = {'name': 'three_nn', 'route': 'cuda',
          'source': 'spsnet_torch/csrc/three_nn.cu',
          'replaces': 'spsnet_tpu/ops/interpolate.py:15 three_nn (XLA, not '
                      'a Pallas kernel)',
          'max_abs_err': 0.0, 'bound_by': 'operations' if any(
              c['bound_by'] == 'operations' for c in calls) else 'bytes',
          **k6_summary(calls, 'the request\'s six calls'),
          'note': 'sums over the six calls of one PV-RCNN++ request (B=2); '
                  'bound_ms is the function\'s (3 pairs a query), '
                  'scanned_pairs_bound_ms over the pairs the scan '
                  'evaluated, all_pairs_bound_ms over every pair',
          'pvrcnnpp_calls': calls}
    log(f'  K6 a PV-RCNN++ request: {k6["ms"]:.3f} ms (device, measured '
        f'now); recorded for the previous design, not measured in this run '
        f'(one thread a query over every row; H100 80GB HBM3 at 700.00 W): '
        f'{K6_BEFORE_MS} ms')

    log('== 52. PV-RCNN++ card vs CPU, one request (B=1)')
    one = {k: v[:1] for k, v in host['batches'][0].items()}
    rec['card_vs_cpu'] = pvpp_cpu_phase(model, 'waymo_models/pv_rcnn_plusplus',
                                        one)
    del model, host

    log('== 53. PV-RCNN++ ResNet (waymo_models/pv_rcnn_plusplus_resnet.yaml)')
    resnet = pvpp_resnet_phase()

    log('== 54. PV-RCNN++ train path')
    train = pvpp_train_path(smi)

    log('== 55. PV-RCNN++ card vs CPU, one train step '
        f'(cut: {PP_TRAIN_CUT})')
    cfg = build_pvpp_trainer('cpu', cut=True)[0]
    batch = pv_train_batches(cfg, [1900, 1901], sizes=WAYMO_SIZES,
                             n=PP_TRAIN_CUT['points'], channels=5)[0][0]
    train['card_vs_cpu'] = pvpp_train_cpu_phase(
        {k: v[:1].cpu() for k, v in batch.items()})
    return rec, shapes, resnet, train, k6


# ------------------------------------------------------------- pillars

def pillar_profile(model, fn, what):
    """``centerpoint_profile`` for a pillar detector: the VFE, the scatter,
    the BEV backbone and the head as ranges (and the NMS, where ``fn``
    opens an 'NMS' range; a CenterHead's decode and NMS as 'head
    decode'), with their shares of the device time."""
    names = {'vfe': 'VFE', 'map_to_bev_module': 'scatter',
             'backbone_2d': 'BEV backbone', 'dense_head': 'head'}

    def ranged(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    for attr, name in names.items():
        module = getattr(model, attr)
        module.forward = ranged(name, module.forward)
    decode = hasattr(model.dense_head, 'decode')
    if decode:
        model.dense_head.decode = ranged('head decode',
                                         model.dense_head.decode)
    try:
        prof = profile_phase(fn, what, ranges=(
            *names.values(), 'head decode' if decode else 'NMS'))
    finally:
        for attr in names:
            del getattr(model, attr).forward
        if decode:
            del model.dense_head.decode
    for span in prof['ranges'].values():
        span['device_share'] = span['device_ms'] / prof['device_ms']
    prof['backward_share'] = prof['backward_device_ms'] / prof['device_ms']
    log('  device shares: ' + ', '.join(
        f'{k} {v["device_share"]:.3f}' for k, v in prof['ranges'].items()) +
        f', backward {prof["backward_share"]:.3f}')
    return prof


def anchor_request(model, batch, post):
    """One request of an anchor-head pillar detector with the NMS in an
    'NMS' range: forward + ``post_processing``."""
    from spsnet_torch.models.detectors.detector3d import post_processing
    with torch.no_grad():
        out = model(batch)
        with torch.profiler.record_function('NMS'):
            return post_processing(out, post)


def pillar_train_path(model, step, opt, batches, steps, what, smi):
    """A warm-up step, then ``steps`` steps cycling over ``batches`` with
    the launch counters zeroed just before (no kernel of the port; finite
    losses and gradients, every parameter moves); ms a step, grad norms
    and peak memory."""
    from spsnet_torch.ops import _build
    step(batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    norms = []
    times, launches = train_path(
        model, step, [batches[k % len(batches)]
                      for k in range(1, 1 + steps)],
        {k: 0 for k in _build.LAUNCHES},
        lambda: norms.append(float(opt.grad_norm)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(times)
    log(f'  ms/train step ({what}): median {ms:.3f}, range '
        f'{min(times):.3f}-{max(times):.3f}, all '
        f'{[round(t, 3) for t in times]}; grad norms '
        f'{[round(n, 4) for n in norms]}; peak memory {peak:.3f} GiB on '
        f'{smi}')
    return {'ms': ms, 'all_ms': times, 'launches': launches,
            'range_ms': [min(times), max(times)], 'peak_gib': peak,
            'grad_norms': norms}


def pillar_cpu_phase(model, name, batch):
    """One request of the pillar CenterPoint ``name`` (B = 1) on the card
    and on the CPU with the same weights, stage by stage from the card's
    inputs: PillarVFE's features within VOXEL_RTOL / VOXEL_ATOL and the
    scatter's canvas of the card's features bit for bit, or the dynamic
    VFE's pillar ids, masks and occupied cells identical and its canvas
    within tolerance (its pillar means sum in another order; the spread of
    two card calls is logged); then the BEV backbone and the head as
    ``centerpoint_cpu_phase`` holds them."""
    _, cpu = build_voxel_detector(name, 'cpu')
    cpu.load_state_dict(model.state_dict())
    host = _cpu_tree(batch)
    errs, rec = [], {}
    with torch.no_grad():
        if 'voxels' not in batch:
            ids = model.vfe.pillar_index(batch)
            for what, a, b in zip(('x index', 'y index', 'pillar id',
                                   'mask'), ids,
                                  cpu.vfe.pillar_index(host)):
                require_equal(a, b, f'card vs CPU dynamic pillar {what}')
            cells = [torch.zeros(f.shape[0], model.vfe.ny * model.vfe.nx + 1,
                                 dtype=torch.bool, device=f.device).scatter_(
                1, f, True)[:, :-1] for f in (ids[2], ids[2].cpu())]
            require_equal(cells[0], cells[1],
                          'card vs CPU occupied pillars')
            g = model.vfe(batch)
            again = model.vfe(batch)['spatial_features']
            rec['card_spread'] = float((again - g['spatial_features'])
                                       .abs().max())
            rec['occupied'] = int(cells[1].sum())
            log(f'  {rec["occupied"]} occupied pillars; two card calls on '
                f'this batch: largest canvas difference '
                f'{rec["card_spread"]:.3e} (largest entry '
                f'{float(g["spatial_features"].abs().max()):.3e}; the '
                f'pillar means\' atomics)')
            c = cpu.vfe(host)
            errs.append(_require_scaled(g['spatial_features'],
                                        c['spatial_features'],
                                        'dynamic pillar canvas'))
        else:
            g = model.vfe(batch)
            c = cpu.vfe(host)
            errs.append(_require_scaled(g['pillar_features'],
                                        c['pillar_features'],
                                        'pillar features'))
            g = model.map_to_bev_module(g)
            c = cpu.map_to_bev_module(dict(
                host, pillar_features=g['pillar_features'].cpu()))
            require_equal(g['spatial_features'], c['spatial_features'],
                          'card vs CPU: the pillar scatter')
        g = model.backbone_2d(g)
        c = cpu.backbone_2d({'spatial_features': g['spatial_features'].cpu()})
        errs.append(_require_scaled(g['spatial_features_2d'],
                                    c['spatial_features_2d'],
                                    'BEV backbone'))
        rec['notes'] = _center_head_vs_cpu(model, cpu, g, errs)
    rec['max_scaled_err'] = max(errs)
    return rec


def pointpillar_phases(smi):
    """Phases 57-58: kitti_models/pointpillar.yaml serving and training."""
    log('== 57. PointPillar serving path (kitti_models/pointpillar.yaml)')
    cfg, model = build_voxel_detector('pointpillar', 'cuda')
    post = cfg.MODEL.POST_PROCESSING
    host = pv_host_batches(cfg, range(2000, 2002), PILLAR_B, N)
    # the peak after the first call, whose cuDNN algorithm search takes
    # workspaces of its own
    anchor_request(model, host['batches'][0], post)
    torch.cuda.reset_peak_memory_stats()
    times, launches = main_path(
        model, [host['batches'][k % 2] for k in range(PILLAR_REQUESTS)],
        post, {}, 'PointPillar requests')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(times)
    dets = anchor_request(model, host['batches'][0], post)
    log(f'  launches over {PILLAR_REQUESTS} requests: {launches}')
    log(f'  ms/batch (B={PILLAR_B}, N={N}: PillarVFE over '
        f'{host["batches"][0]["voxel_valid"].shape[1]} pillars of 32 slots, '
        f'scatter, BEV backbone, {model.dense_head.anchors.shape[0]} anchors,'
        f' NMS): median {ms:.3f}, range {min(times):.3f}-{max(times):.3f}, '
        f'all {[round(t, 3) for t in times]}; peak memory {peak:.3f} GiB; '
        f'detections a frame {dets["count"].tolist()} on {smi}')
    rec = {'ms_per_batch': ms, 'all_ms': times, 'launches': launches,
           'range_ms': [min(times), max(times)], 'peak_gib': peak,
           'host_ms_a_frame': host['host_ms'],
           'pillars_before_cap': host['before'],
           'pillars_after_cap': host['after'],
           'detections': dets['count'].tolist()}
    rec['profile'] = pillar_profile(
        model, lambda: anchor_request(model, host['batches'][0], post),
        'one PointPillar request (B=2)')
    del model, host

    log('== 58. PointPillar train path')
    cfg, model, opt, step = build_centerpoint_trainer(
        'cuda', name='kitti_models/pointpillar')
    batches, host_ms, before, after = pv_train_batches(
        cfg, range(2100, 2100 + PILLAR_TRAIN_BATCHES))
    log(f'  host pillars at the train settings: '
        f'{statistics.median(host_ms):.3f} ms a frame; pillars a frame in '
        f'range {before}, after the cap of 16000 {after}; gt boxes a frame '
        f'{batches[0]["gt_boxes"].shape[1]}')
    train = pillar_train_path(
        model, step, opt, batches, PILLAR_TRAIN_STEPS,
        f'B={PV_TRAIN_B}, N={N}: PillarVFE, BEV backbone, anchor targets '
        f'and loss, backward, adam_onecycle', smi)
    train.update(host_ms_a_frame=host_ms, pillars_before_cap=before,
                 pillars_after_cap=after)
    train['profile'] = pillar_profile(
        model, lambda: step(batches[1]), 'one PointPillar train step (B=2)')
    return rec, train


def waymo_pillar_phases(smi, dynamic):
    """Phases 59-61 (PillarVFE, centerpoint_pillar_1x.yaml) or 62-64
    (DynamicPillarVFE, centerpoint_dyn_pillar_1x.yaml): serving, card vs
    CPU one request, training, card vs CPU one train step."""
    name = 'waymo_models/centerpoint_dyn_pillar_1x' if dynamic else \
        'waymo_models/centerpoint_pillar_1x'
    first, kind = (62, 'dynamic pillar') if dynamic else (59, 'pillar')
    seed = 2300 if dynamic else 2200
    log(f'== {first}. CenterPoint over {kind}s, serving ({name}.yaml)')
    cfg, model = build_voxel_detector(name, 'cuda')
    host = pv_host_batches(cfg, range(seed, seed + 2), CP_B, CP_N, 5)
    from spsnet_torch.models.detectors.detector3d import head_detections

    def request():
        with torch.no_grad():
            return head_detections(model(host['batches'][0]))
    request()
    torch.cuda.reset_peak_memory_stats()
    times, launches, dets = centerpoint_path(
        model, [host['batches'][k % 2] for k in range(CPP_REQUESTS)],
        f'CenterPoint {kind} requests (B={CP_B})')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(times)
    log(f'  launches over {CPP_REQUESTS} requests: {launches}')
    log(f'  ms/batch (B={CP_B}, N={CP_N}, 5 channels: '
        f'{type(model.vfe).__name__}, the {model.vfe.num_pillar_features}-'
        f'channel {model.grid_size[1]} x {model.grid_size[0]} map, BEV '
        f'backbone, CenterHead top 500, NMS): median {ms:.3f}, range '
        f'{min(times):.3f}-{max(times):.3f}, all '
        f'{[round(t, 3) for t in times]}; peak memory {peak:.3f} GiB; '
        f'detections a frame {dets["count"].tolist()} on {smi}')
    rec = {'ms_per_batch': ms, 'all_ms': times, 'launches': launches,
           'range_ms': [min(times), max(times)], 'peak_gib': peak,
           'host_ms_a_frame': host['host_ms'],
           'pillars_before_cap': host['before'],
           'pillars_after_cap': host['after'],
           'detections': dets['count'].tolist()}
    rec['profile'] = pillar_profile(model, request,
                                    f'one CenterPoint {kind} request (B=2)')

    log(f'== {first + 1}. CenterPoint over {kind}s card vs CPU, one request '
        f'(B=1)')
    one = {k: v[:1] for k, v in host['batches'][0].items()}
    torch.cuda.reset_peak_memory_stats()
    rec['card_vs_cpu'] = pillar_cpu_phase(model, name, one)
    rec['card_vs_cpu']['peak_gib'] = \
        torch.cuda.max_memory_allocated() / 2 ** 30
    log(f'  peak memory {rec["card_vs_cpu"]["peak_gib"]:.3f} GiB')
    del model, host

    log(f'== {first + 2}. CenterPoint over {kind}s, train path; card vs CPU '
        f'one train step (cut: {CP_TRAIN_CUT})')
    cfg, model, opt, step = build_centerpoint_trainer('cuda', name=name)
    batches, host_ms, before, after = pv_train_batches(
        cfg, range(seed + 50, seed + 50 + CP_TRAIN_BATCHES),
        sizes=WAYMO_SIZES, n=CP_N, channels=5)
    log(f'  host steps at the train settings: '
        f'{statistics.median(host_ms):.3f} ms a frame; pillars a frame '
        f'{before}, after the cap {after}')
    train = pillar_train_path(
        model, step, opt, batches, CPP_TRAIN_STEPS,
        f'B={PV_TRAIN_B}, N={CP_N}: {type(model.vfe).__name__}, BEV '
        f'backbone, CenterHead targets and losses, backward, '
        f'adam_onecycle', smi)
    train.update(host_ms_a_frame=host_ms, pillars_before_cap=before,
                 pillars_after_cap=after)
    train['profile'] = pillar_profile(
        model, lambda: step(batches[1]),
        f'one CenterPoint {kind} train step (B=2)')
    del model, step, batches
    cfg = build_centerpoint_trainer('cpu', cut=True, name=name)[0]
    batch = pv_train_batches(cfg, [seed + 90, seed + 91], sizes=WAYMO_SIZES,
                             n=CP_TRAIN_CUT['points'], channels=5)[0][0]
    torch.cuda.reset_peak_memory_stats()
    train['card_vs_cpu'] = centerpoint_train_cpu_phase(
        {k: v[:1].cpu() for k, v in batch.items()}, name)
    train['card_vs_cpu']['peak_gib'] = \
        torch.cuda.max_memory_allocated() / 2 ** 30
    log(f'  peak memory {train["card_vs_cpu"]["peak_gib"]:.3f} GiB')
    return rec, train


def pillar_request_phase(name, seed, smi):
    """Phase 65: one request (B = 1, 65 536 points of 5 channels) of
    ``name`` after a warm-up, the launch counters zeroed just before: no
    kernel launch, finite detections in the frame."""
    from spsnet_torch.models.detectors.detector3d import head_detections
    from spsnet_torch.ops import _build
    cfg, model = build_voxel_detector(name, 'cuda')
    batch = pv_host_batches(cfg, [seed], 1, CP_N, 5)['batches'][0]
    anchor = cfg.MODEL.DENSE_HEAD.NAME == 'AnchorHeadSingle'

    def request():
        if anchor:
            return anchor_request(model, batch, cfg.MODEL.POST_PROCESSING)
        with torch.no_grad():
            return head_detections(model(batch))
    request()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    dets = request()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.LAUNCHES)
    _require_per_call(launches, {}, 1, f'{name} request')
    if not (torch.isfinite(dets['boxes']).all() and
            torch.isfinite(dets['scores']).all()) or dets['count'].min() < 1:
        raise AssertionError(f'{name}: detections {dets["count"]}, finite '
                             f'{bool(torch.isfinite(dets["boxes"]).all())}')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    extra = f'{model.dense_head.anchors.shape[0]} anchors' if anchor else \
        f'{len(model.dense_head.heads_list)} head groups'
    log(f'  {name}: {ms:.3f} ms a request (B=1, {extra}, a '
        f'{model.grid_size[1]} x {model.grid_size[0]} map), detections '
        f'{dets["count"].tolist()}, launches {launches}, peak memory '
        f'{peak:.3f} GiB on {smi}')
    return {'ms': ms, 'launches': launches, 'peak_gib': peak,
            'detections': dets['count'].tolist()}


def pillar_phases(smi):
    """Phases 57-65; returns the pillar paths' records."""
    pp, pp_train = pointpillar_phases(smi)
    cpp, cpp_train = waymo_pillar_phases(smi, dynamic=False)
    dyn, dyn_train = waymo_pillar_phases(smi, dynamic=True)
    log('== 65. one request each of waymo_models/pointpillar_1x.yaml and '
        'nuscenes_models/cbgs_dyn_pp_centerpoint.yaml')
    waymo = pillar_request_phase('waymo_models/pointpillar_1x', 2400, smi)
    nus = pillar_request_phase('nuscenes_models/cbgs_dyn_pp_centerpoint',
                               2401, smi)
    return {'pointpillar': pp, 'pointpillar_train': pp_train,
            'centerpoint_pillar': cpp, 'centerpoint_pillar_train': cpp_train,
            'centerpoint_dyn_pillar': dyn,
            'centerpoint_dyn_pillar_train': dyn_train,
            'pointpillar_waymo': waymo, 'centerpoint_dyn_pp_nuscenes': nus}


def card_and_build():
    """Phases 1 and 2; returns the card's nvidia-smi line."""
    from spsnet_torch.ops import _build
    log('== 1. card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f'torch {torch.__version__} CUDA {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)}')

    log('== 2. build')
    log(f'  kernels built in {_build.build_all():.2f} s '
        f'({_build.build_dir()})')
    for name in ('fps', 'ball_query', 'seed_min', 'three_nn'):
        if hasattr(_build, 'ptxas_report'):
            for line in _build.ptxas_report(name):
                log(f'  ptxas {name}: {line}')
    return smi


def kernel_inputs():
    """The models and clouds that phase 3 and the paths share."""
    from spsnet_torch.models import build_detector
    from spsnet_torch.utils.synthetic import synthetic_scan_batch
    from spsnet_torch.zoo import iassd_kitti_cfg
    cfg = iassd_kitti_cfg()
    model = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), device='cuda',
                           generator=torch.Generator().manual_seed(0))
    requests = [torch.from_numpy(synthetic_scan_batch(s, B, N)).cuda()
                for s in range(REQUESTS)]
    sps_cfg, sps_pre, sps_model = build_spsnet('cuda')
    sps_requests = [_scene_batch(100 + s, B, 'cuda')
                    for s in range(SPSNET_REQUESTS)]
    with torch.no_grad():
        kept_xyz = sps_pre(sps_requests[0], torch.Generator().manual_seed(0))[
            'points'][..., :3].contiguous()
    raw_xyz = sps_requests[0]['points'][..., :3].contiguous()
    k5_clouds = [(requests[0][..., :3].contiguous(), 4096),
                 (kept_xyz, 4096),
                 (requests[0][:1, :, :3].contiguous(), 4096),
                 (torch.from_numpy(synthetic_scan_batch(7, 32, 4096))[
                     ..., :3].contiguous().cuda(), 1024)]
    if [(*x.shape[:2], m) for x, m in k5_clouds] != list(K5_SHAPES):
        raise AssertionError('K5 shapes')
    train_batches = [_scene_batch(s, TRAIN_B, 'cuda')
                     for s in range(TRAIN_STEPS)]
    with torch.no_grad():
        sps_train_kept = sps_pre(train_batches[0], torch.Generator())[
            'points'][..., :3].contiguous()
    stab_batches = [_scene_batch(200 + s, STAB_B, 'cuda')
                    for s in range(TRAIN_STEPS)]
    return {'cfg': cfg, 'model': model, 'requests': requests,
            'sps': (sps_cfg, sps_pre, sps_model), 'sps_requests': sps_requests,
            'kept_xyz': kept_xyz, 'raw_xyz': raw_xyz, 'k5_clouds': k5_clouds,
            'train_batches': train_batches, 'sps_train_kept': sps_train_kept,
            'stab_batches': stab_batches}


def kernel_phase(phases, inp):
    """Phase 3 through the phase functions of module ``phases`` (this
    script, or the same script of another checkout); returns the kernels'
    JSON entries without launches, and the device time of each kernel call
    at the paths' shapes (``kernel_device_ms``)."""
    log('== 3. kernels vs plain on the card')
    requests = inp['requests']
    entries = [phases.fps_phase(requests[0][..., :3].contiguous(),
                                inp['kept_xyz']),
               phases.ball_query_phase(inp['model'], requests[0],
                                       inp['raw_xyz'], inp['kept_xyz']),
               *phases.seeded_phase(inp['train_batches'][0]['points'])]
    k5 = phases.fps_variant_phase(inp['k5_clouds'])
    if isinstance(k5, dict):
        entries[0].update(k5)
    else:  # a checkout whose K5 entries had kernels of their own
        entries += k5
    return entries, kernel_device_ms(inp)


def traced_ms(fn, reps, enough):
    """The kernel durations (us) of ``fn``'s calls by kernel name (up to
    its argument list), ``torch.profiler``'s CUDA records over windows of
    ``reps`` calls, a warm-up step before each. CUDA events around a call
    also count the host's time to issue it, which is most of a small
    kernel's event time. The trace may drop records of short kernels, and
    once lost every record of a 20 ms kernel in four windows (the Waymo
    layer-0 FPS, phase 23), so windows repeat (at most eight) until
    ``enough(by_name)``, each keeping its events past the end of its cycle
    (``acc_events``)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    by_name = {}
    for _ in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1), acc_events=True) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        for e in prof.events():
            if str(getattr(e, 'device_type', '')).endswith('CUDA') and \
                    not getattr(e, 'is_user_annotation', False) and \
                    e.self_device_time_total > 0:
                name = re.sub(r'\([^()]*\)$', '', e.name).split('::')[-1]
                by_name.setdefault(name.strip(), []).append(
                    e.self_device_time_total)
        if by_name and enough(by_name):
            break
    if not by_name:
        raise AssertionError('no kernel traced')
    return by_name


def device_ms(fn, reps=10):
    """Device time of one call of ``fn``, whose calls launch one kernel
    each: the median kernel duration over ``reps`` traced calls
    (``traced_ms``)."""
    by_name = traced_ms(fn, reps, lambda d: sum(map(len, d.values())) >= reps)
    return statistics.median(sum(by_name.values(), [])) / 1e3


def device_ms_by_kernel(fn, reps=5):
    """Device time of one call of ``fn``, whose calls launch a few kernels
    (and memsets) each: the sum over the kernel names of each name's
    median duration over ``reps`` traced calls (``traced_ms``, until every
    name has ``reps`` records), and those medians by name."""
    by_name = traced_ms(fn, reps,
                        lambda d: min(map(len, d.values())) >= reps)
    med = {k: statistics.median(v) / 1e3 for k, v in by_name.items()}
    return sum(med.values()), med


def kernel_device_ms(inp):
    """Device time a call of K1, K3, K4 and K2 at the paths' shapes and of
    the experimental FPS entries at the K5 shapes, through the kernel
    wrappers and entries that both this commit and its parent have (the
    parent's K5 entries launched kernels of their own); returns {call:
    ms}."""
    from spsnet_torch.ops import gather_points
    from spsnet_torch.ops import sampling as smp
    from spsnet_torch.ops.grouping import ball_query_multi_kernel
    xyz = inp['requests'][0][..., :3].contiguous()
    calls = {}
    for what, cloud in (('IA-SSD', xyz), ('SPSNet', inp['kept_xyz'])):
        shape = f'({B}, {cloud.shape[1]}) -> 4096'
        calls[f'fps {shape}, {what} layer 0'] = \
            lambda c=cloud: smp.farthest_point_sample_kernel(c, 4096)
    for cloud, npoint in inp['k5_clouds']:
        for entry in k5_entries():
            calls[f'fps K5 entry {entry.__name__} ({cloud.shape[0]}, '
                  f'{cloud.shape[1]}) -> {npoint}'] = \
                lambda e=entry, c=cloud, m=npoint: e(c, m)
    cloud = inp['train_batches'][0]['points'][..., :3].contiguous()
    for layer, npoint in enumerate((4096, 1024)):
        k0 = smp.seed_k0(seeding(), npoint)
        idx = smp.grid_seed_indices(cloud, k0)
        seeds = gather_points(cloud, idx).contiguous()
        d0 = smp.seed_min_d2_kernel(cloud, seeds)
        calls[f'seed_min layer {layer} ({TRAIN_B}, {cloud.shape[1]}) '
              f'k0={k0}'] = \
            lambda c=cloud, s=seeds: smp.seed_min_d2_kernel(c, s)
        calls[f'fps_seeded layer {layer} ({TRAIN_B}, {cloud.shape[1]}) '
              f'k0={k0} -> {npoint}'] = \
            lambda c=cloud, m=npoint, d=d0, i=idx: \
            smp.farthest_point_sample_seeded_kernel(c, m, d, i)
        cloud = gather_points(cloud, smp.farthest_point_sample_seeded_kernel(
            cloud, npoint, d0, idx)).contiguous()
    with torch.no_grad():
        enc = inp['model']({'points': inp['requests'][0]})['encoder_xyz']
    backbone = inp['model'].backbone_3d
    for k, module in enumerate(backbone.SA_modules):
        if getattr(module, 'radii', None):
            calls[f'ball_query layer {k}'] = \
                lambda r=tuple(module.radii), n=tuple(module.nsamples), \
                p=enc[backbone.layer_inputs[k]].contiguous(), \
                c=enc[k + 1].contiguous(): ball_query_multi_kernel(r, n, p, c)
    raw, kept = inp['raw_xyz'], inp['kept_xyz']
    calls['ball_query stability SA'] = \
        lambda: ball_query_multi_kernel((0.2, 0.8), (16, 32), raw, raw)
    calls['ball_query surface graph'] = \
        lambda: ball_query_multi_kernel((0.8,), (16,), kept, kept)
    out = {}
    for name, fn in calls.items():
        out[name] = device_ms(fn, reps=5 if 'fps' in name else 21)
        log(f'  device time {name}: {out[name]:.4f} ms a call')
    return out


def phase3_of(root) -> int:
    """``--phase3 ROOT``: phases 1-3 only, with the package and the phase
    functions of the checkout at ROOT (the parent commit's, unpacked with
    ``git archive``, to compare kernels on one card in one call); prints
    the entries as one JSON line."""
    import importlib.util
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location('phases_of_root',
                                                  root / 'chip_smoke.py')
    phases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(phases)
    smi = card_and_build()
    entries, dev = kernel_phase(phases, kernel_inputs())
    log(json.dumps({'phase3_of': str(root), 'kernels': entries,
                    'kernel_device_ms': dev, 'card': smi}))
    return 0


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == '--phase3':
        return phase3_of(argv[1])
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if list(argv) == ['--jitter-study']:
        return jitter_study()
    if list(argv) == ['--fault-check']:
        return fault_check()
    if len(argv) == 2 and argv[0] == '--fault-check':
        return fault_check(argv[1].split(','))
    if len(argv) == 2 and argv[0] == '--pvpp-train-repeat':
        return pvpp_train_repeat(int(argv[1]))
    if argv:
        print('usage: chip_smoke.py [--phase3 ROOT | --jitter-study | '
              '--fault-check [MODELS] | --pvpp-train-repeat N]',
              file=sys.stderr)
        return 2
    from spsnet_torch.runtime.trainer import make_eval_step

    smi = card_and_build()
    inp = kernel_inputs()
    entries, kernel_dev = kernel_phase(sys.modules[__name__], inp)
    log('== 3. kernels vs plain on the card: the shapes of SPSNet training')
    shapes = train_shapes_phase(inp)
    for entry in entries:
        entry['train_shape_calls'] = shapes[entry['name']]
        entry['max_abs_err'] = max(entry['max_abs_err'],
                                   shapes['errs'][entry['name']])
        if entry['name'] == 'fps':
            entry['sfps_calls'] = shapes['sfps']
    cfg, model, requests = inp['cfg'], inp['model'], inp['requests']
    sps_cfg, sps_pre, sps_model = inp['sps']
    sps_requests, train_batches = inp['sps_requests'], inp['train_batches']
    k5_clouds = inp['k5_clouds']

    log('== 4. serving path')
    post = cfg.MODEL.POST_PROCESSING
    times, launches = main_path(model, requests, post,
                                {'fps': 1, 'ball_query': 4}, 'IA-SSD forwards')
    ms = statistics.median(times)
    log(f'  launches over {REQUESTS} requests: {launches}')
    log(f'  ms/batch (B={B}, N={N}, forward + NMS): median {ms:.3f}, all '
        f'{[round(t, 3) for t in times]}; scenes/s {B / ms * 1e3:.2f} '
        f'on {smi}')

    log('== 5. card vs CPU, one scene')
    cpu_phase(model, cfg, requests[0][:1])

    log('== 6. where the time goes: one request')
    serve_profile = profile_phase(lambda: detect(model, requests[0], post),
                                  'one request')

    log('== 7. train path')
    train_model, _, step = build_trainer(cfg, 'cuda', 0)
    step_times, train_launches = train_path(train_model, step, train_batches,
                                            TRAIN_LAUNCHES)
    step_ms = statistics.median(step_times)
    log(f'  launches over {TRAIN_STEPS} train steps: {train_launches}')
    log(f'  ms/train step (B={TRAIN_B}, N={N}, forward + loss + backward + '
        f'adam_onecycle): median {step_ms:.3f}, all '
        f'{[round(t, 3) for t in step_times]}; steps/s '
        f'{1e3 / step_ms:.3f} on {smi}')

    log('== 8. card vs CPU, one train step')
    train_cpu_phase(lambda device: build_trainer(cfg, device, 1),
                    _scene_batch(100, 1, 'cpu'), 2)

    log('== 9. where the time goes: one train step')
    train_profile = profile_phase(lambda: step(train_batches[0]),
                                  'one train step')
    del train_model, step

    log('== 10. SPSNet serving path')
    sps_post = sps_cfg.MODEL.POST_PROCESSING
    kept = []

    def recorded(batch, generator):
        out = sps_pre(batch, generator)
        kept.append(out['points'].shape[1])
        return out
    sps_step = make_eval_step(sps_model, sps_post, recorded)
    sps_times, sps_launches = spsnet_path(sps_step, kept, sps_requests,
                                          sps_post)
    _require_per_call(sps_launches, {'fps': 1, 'ball_query': 6},
                      SPSNET_REQUESTS, 'SPSNet forwards')
    sps_ms = statistics.median(sps_times)
    log(f'  launches over {SPSNET_REQUESTS} requests: {sps_launches}')
    log(f'  ms/batch (B={B}, N={N} -> {KEPT} kept, stability model + '
        f'deletion + forward + NMS): median {sps_ms:.3f}, all '
        f'{[round(t, 3) for t in sps_times]}; scenes/s '
        f'{B / sps_ms * 1e3:.2f} on {smi}')

    log('== 11. SPSNet card vs CPU, one scene')
    spsnet_cpu_phase(sps_cfg, sps_pre, sps_model, sps_requests[0])

    log('== 12. where the time goes: one SPSNet request')
    sps_profile = profile_phase(lambda: sps_step(sps_requests[0]),
                                'one SPSNet request')

    log('== 13. the experimental FPS entries')
    entry_launches = fps_entry_path(k5_clouds)

    log('== 14. SPSNet train path')
    kept = []
    sps_train, _, sps_train_step, frozen = build_spsnet_trainer('cuda', kept)
    frozen_before = {k: v.clone()
                     for k, v in frozen.model.state_dict().items()}

    def kept_all():
        if kept[-1] != KEPT:
            raise AssertionError(f'{kept[-1]} points kept a scene, want '
                                 f'{KEPT}')
    sps_step_times, sps_train_launches = train_path(
        sps_train, sps_train_step, train_batches, SPSNET_TRAIN_LAUNCHES,
        kept_all)
    if frozen.model.training or any(
            p.requires_grad for p in frozen.model.parameters()) or any(
            not torch.equal(v, frozen_before[k])
            for k, v in frozen.model.state_dict().items()):
        raise AssertionError('the frozen stability model changed in training')
    log('  the frozen stability model: eval mode, no gradients, parameters '
        'and buffers bit-unchanged')
    sps_step_ms = statistics.median(sps_step_times)
    log(f'  launches over {TRAIN_STEPS} train steps: {sps_train_launches}')
    log(f'  ms/train step (B={TRAIN_B}, N={N} -> {KEPT} kept, stability '
        f'model + deletion + forward + loss + backward + adam_onecycle): '
        f'median {sps_step_ms:.3f}, all '
        f'{[round(t, 3) for t in sps_step_times]}; steps/s '
        f'{1e3 / sps_step_ms:.3f} on {smi}')

    log('== 15. SPSNet card vs CPU, one train step')
    train_cpu_phase(lambda device: build_spsnet_trainer(device)[:3],
                    _scene_batch(100, 1, 'cpu'), 2)

    log('== 16. stability train path')
    stab_model, _, stab_step = build_stability_trainer('cuda')
    stab_times, stab_launches = train_path(stab_model, stab_step,
                                           inp['stab_batches'],
                                           STAB_TRAIN_LAUNCHES)
    stab_ms = statistics.median(stab_times)
    fg_share = _foreground_share(inp['stab_batches'])
    log(f'  launches over {TRAIN_STEPS} train steps: {stab_launches}')
    log(f'  ms/train step (B={STAB_B}, N={N}, forward + loss + backward + '
        f'adam_onecycle): median {stab_ms:.3f}, all '
        f'{[round(t, 3) for t in stab_times]}; steps/s '
        f'{1e3 / stab_ms:.3f}; foreground share {fg_share:.4f} on {smi}')

    log('== 17. stability card vs CPU, one train step')
    train_cpu_phase(build_stability_trainer, _scene_batch(300, 1, 'cpu'), 0)

    log('== 18. where the time goes: one SPSNet train step, one stability '
        'train step')
    sps_train_profile = profile_phase(
        lambda: sps_train_step(train_batches[0]), 'one SPSNet train step')
    stab_profile = profile_phase(lambda: stab_step(inp['stab_batches'][0]),
                                 'one stability train step')

    del sps_train, sps_train_step, stab_model, stab_step

    log('== 19. PointRCNN serving path')
    prcnn_cfg, prcnn = build_pointrcnn('cuda')
    prcnn_post = prcnn_cfg.MODEL.POST_PROCESSING
    retries = torch.cuda.memory_stats().get('num_alloc_retries', 0)
    with timed_calls(prcnn.roi_head, 'proposal_layer') as nms_calls:
        prcnn_times, prcnn_launches = main_path(
            prcnn, requests, prcnn_post, PRCNN_LAUNCHES, 'PointRCNN requests')
    retries = torch.cuda.memory_stats().get('num_alloc_retries', 0) - retries
    # the first call is main_path's warm-up
    prcnn_nms = range_ms(nms_calls)[1:]
    prcnn_ms = statistics.median(prcnn_times)
    log(f'  launches over {REQUESTS} requests: {prcnn_launches}')
    log(f'  ms/batch (B={B}, N={N}, backbone + point head + proposal NMS + '
        f'RoI pooling + RoI head + NMS): median {prcnn_ms:.3f}, all '
        f'{[round(t, 3) for t in prcnn_times]}; scenes/s '
        f'{B / prcnn_ms * 1e3:.2f} on {smi}')
    for k, (total, (host, events)) in enumerate(zip(prcnn_times, prcnn_nms)):
        log(f'    request {k}: {total:.3f} ms; proposal NMS {host:.3f} ms on '
            f'the host, {events:.3f} ms between its events; the rest '
            f'{total - host:.3f} ms')
    log(f'  caching-allocator retries (frees and a sync) over the warm-up '
        f'and the requests: {retries}')

    log('== 20. kernels vs plain at the PointRCNN shapes; chunked FPS')
    prcnn_shapes = pointrcnn_shapes_phase(prcnn, requests[0])
    chunked = chunked_fps_phase(requests[0][..., :3].contiguous())

    log('== 21. PointRCNN card vs CPU, one scene')
    pointrcnn_cpu_phase(prcnn, prcnn_cfg, requests[0][:1].contiguous())

    log('== 22. where the time goes: one PointRCNN request, its proposal NMS')
    proposals = prcnn.roi_head.proposal_layer

    def annotated(batch):
        with torch.profiler.record_function('proposal NMS'):
            return proposals(batch)
    prcnn.roi_head.proposal_layer = annotated
    prcnn_profile = profile_phase(
        lambda: detect(prcnn, requests[0], prcnn_post), 'one PointRCNN request',
        ranges=('proposal NMS',))
    nms_profile = prcnn_profile['ranges']['proposal NMS']
    with torch.no_grad():
        stage1 = prcnn.point_head(prcnn.backbone_3d({'points': requests[0]}))
        nms_profile['event_ms'] = cuda_ms(lambda: proposals(stage1), reps=3)
        nms_profile.update(overlap_mask_phase(proposals, stage1))
    nms_profile['all_ms'] = prcnn_nms
    nms_profile['empty_rois'] = prcnn_shapes['empty_rois']
    nms_profile['padded_rois'] = prcnn_shapes['padded_rois']
    log(f'  proposal NMS (pre 9000, post 100, B=8) alone: '
        f'{nms_profile["event_ms"]:.3f} ms a request (events)')
    log(f'  the profiled request: {prcnn_profile["wall_ms"]:.3f} ms, '
        f'{nms_profile["candidate_pairs"]} candidate pairs in its proposal '
        f'NMS, {nms_profile["empty_rois"]} empty and '
        f'{nms_profile["padded_rois"]} padded RoIs of {B * 100}')
    del prcnn, stage1, proposals

    log('== 23. Waymo and nuScenes IA-SSD requests')
    waymo = other_iassd_path(*WAYMO)
    nuscenes = other_iassd_path(*NUSCENES)

    log('== 24. PointRCNN train path')
    from spsnet_torch.runtime.trainer import step_rngs
    prcnn_batches = [_scene_batch(600 + s, PRCNN_TRAIN_B, 'cuda')
                     for s in range(PRCNN_TRAIN_STEPS + 1)]
    # at the seed weights: after a few steps of random-weight training a
    # foreground RoI's corner loss may dominate (grad norms up to ~1e4)
    seed_model = build_pointrcnn_trainer('cuda')[0]
    roi_share = roi_gradient_share(
        seed_model, prcnn_batches[0], seed_model.point_head.box_layers.
        parameters(), ('point_loss_cls', 'point_loss_box'),
        'the point head\'s box layers')
    prcnn_train, prcnn_model, prcnn_step = pointrcnn_train_path(
        prcnn_batches, smi)
    prcnn_train['roi_grad_share'] = roi_share

    log('== 25. kernels vs plain at the PointRCNN train shapes')
    train_shapes = pointrcnn_shapes_phase(
        prcnn_model, dict(prcnn_batches[0], rngs=step_rngs(0)),
        first_layer=0)

    log('== 26. PointRCNN card vs CPU, one train step')
    prcnn_train['card_vs_cpu'] = pointrcnn_train_cpu_phase(
        _scene_batch(610, 1, 'cpu'))

    log('== 27. RoI targets and loss on jittered gt, card vs CPU')
    prcnn_train['reg_corner'] = roi_target_loss_phase(
        max(st['reg_valid'] for st in prcnn_train['roi_stats']) > 0,
        *build_pointrcnn('cpu'))

    log('== 28. where the time goes: one PointRCNN train step')
    train_proposals = prcnn_model.roi_head.proposal_layer

    def annotated_train(batch):
        with torch.profiler.record_function('proposal NMS'):
            return train_proposals(batch)
    prcnn_model.roi_head.proposal_layer = annotated_train
    prcnn_train['profile'] = profile_phase(
        lambda: prcnn_step(prcnn_batches[1]), 'one PointRCNN train step',
        ranges=('proposal NMS',))
    prof = prcnn_train['profile']
    span = prof['ranges']['proposal NMS']
    prcnn_train['nms_share_profiled'] = span['host_ms'] / prof['wall_ms']
    log(f'  the proposal NMS (pre 9000, post 512, B={PRCNN_TRAIN_B}): '
        f'{span["host_ms"]:.3f} of {prof["wall_ms"]:.3f} ms of the profiled '
        f'step ({prcnn_train["nms_share_profiled"]:.3f}), '
        f'{span["launches"]} of its kernel launches; the rest '
        f'{prof["launches"] - span["launches"]} launches; busy share '
        f'{prof["busy_share"]:.3f}')
    del prcnn_model, prcnn_step, train_proposals

    pvrcnn, pv_shapes, second = pvrcnn_phases()
    pv_train, pv_train_shapes, second_train = pvrcnn_train_phases(smi)
    vrcnn, vr_shapes, vr_train, vr_train_shapes = voxelrcnn_phases(smi)
    centerpoint, cp_train = centerpoint_phases(smi)
    vr_waymo, vr_waymo_shapes = voxelrcnn_waymo_phase(smi)
    pvpp, pvpp_shapes, pvpp_resnet, pvpp_train, k6 = pvpp_phases(smi)
    log('== 56. the kernels line, K6 with K1-K4')
    entries.append(k6)
    pillars = pillar_phases(smi)

    paths = {'serve': launches, 'train': train_launches,
             'spsnet': sps_launches, 'fps_entries': entry_launches,
             'spsnet_train': sps_train_launches,
             'stability_train': stab_launches, 'pointrcnn': prcnn_launches,
             'waymo': waymo['launches'], 'nuscenes': nuscenes['launches'],
             'pointrcnn_train': prcnn_train['launches'],
             'pvrcnn': pvrcnn['launches'], 'pvrcnn_b8': pvrcnn['b8'][
                 'launches'], 'second': second['launches'],
             'pvrcnn_train': pv_train['launches'],
             'second_train': second_train['launches'],
             'voxelrcnn': vrcnn['launches'],
             'voxelrcnn_train': vr_train['launches'],
             'centerpoint': centerpoint['launches'],
             'centerpoint_train': cp_train['launches'],
             'voxelrcnn_waymo': vr_waymo['launches'],
             'pvrcnnpp': pvpp['launches'],
             'pvrcnnpp_resnet': pvpp_resnet['launches'],
             'pvrcnnpp_train': pvpp_train['launches'],
             **{name: rec['launches'] for name, rec in pillars.items()}}
    for entry in entries:
        entry['launches_by_path'] = {path: counts.get(entry['name'], 0)
                                     for path, counts in paths.items()}
        entry['launches'] = sum(entry['launches_by_path'].values())
        name = entry['name']
        if name == 'three_nn':
            entry['pointrcnn_calls'] = prcnn_shapes['three_nn']
            entry['pointrcnn_train_calls'] = train_shapes['three_nn']
        if name in ('fps', 'ball_query'):
            entry['pointrcnn_calls'] = prcnn_shapes[name]
            entry['waymo_calls'] = waymo[name]
            entry['nuscenes_calls'] = nuscenes[name]
            entry['pointrcnn_train_calls'] = train_shapes[name]
            entry['pvrcnn_calls'] = pv_shapes[name]
            entry['pvrcnn_train_calls'] = pv_train_shapes[name]
            entry['max_abs_err'] = max(entry['max_abs_err'],
                                       prcnn_shapes['errs'][name],
                                       waymo['errs'][name],
                                       nuscenes['errs'][name],
                                       train_shapes['errs'][name],
                                       pv_shapes['errs'][name],
                                       pv_train_shapes['errs'][name])
        if name == 'ball_query':
            for key, calls in (('voxelrcnn_calls', vr_shapes),
                               ('voxelrcnn_train_calls', vr_train_shapes),
                               ('voxelrcnn_waymo_calls', vr_waymo_shapes)):
                entry[key] = calls['ball_query']
                entry['max_abs_err'] = max(entry['max_abs_err'],
                                           calls['errs']['ball_query'])
        if name == 'fps':
            entry['max_abs_err'] = max(entry['max_abs_err'],
                                       chunked.pop('err'))
            entry['chunked_call'] = chunked
            entry['pvrcnnpp_sector_calls'] = pvpp_shapes['fps']
            entry['pvrcnnpp_sector_at_k'] = pvpp_shapes['fps_at_k']
    log(json.dumps({'kernels': entries, 'kernel_device_ms': kernel_dev,
                    'ms_per_batch': ms,
                    'scenes_per_s': B / ms * 1e3,
                    'ms_per_train_step': step_ms,
                    'train_steps_per_s': 1e3 / step_ms,
                    'spsnet_ms_per_batch': sps_ms,
                    'spsnet_scenes_per_s': B / sps_ms * 1e3,
                    'spsnet_ms_per_train_step': sps_step_ms,
                    'spsnet_train_steps_per_s': 1e3 / sps_step_ms,
                    'stability_ms_per_train_step': stab_ms,
                    'stability_train_steps_per_s': 1e3 / stab_ms,
                    'stability_foreground_share': fg_share,
                    'serve_profile': serve_profile,
                    'train_profile': train_profile,
                    'spsnet_profile': sps_profile,
                    'spsnet_train_profile': sps_train_profile,
                    'stability_train_profile': stab_profile,
                    'pointrcnn_ms_per_batch': prcnn_ms,
                    'pointrcnn_scenes_per_s': B / prcnn_ms * 1e3,
                    'pointrcnn_all_ms': prcnn_times,
                    'pointrcnn_profile': prcnn_profile,
                    'proposal_nms': nms_profile,
                    'waymo_ms_per_batch': waymo['ms_per_batch'],
                    'nuscenes_ms_per_batch': nuscenes['ms_per_batch'],
                    'waymo_all_ms': waymo['all_ms'],
                    'nuscenes_all_ms': nuscenes['all_ms'],
                    'pointrcnn_train': prcnn_train,
                    'pvrcnn': pvrcnn, 'second': second,
                    'pvrcnn_train': pv_train, 'second_train': second_train,
                    'voxelrcnn': vrcnn, 'voxelrcnn_train': vr_train,
                    'centerpoint': centerpoint,
                    'centerpoint_train': cp_train,
                    'voxelrcnn_waymo': vr_waymo, 'pvrcnnpp': pvpp,
                    'pvrcnnpp_resnet': pvpp_resnet,
                    'pvrcnnpp_train': pvpp_train, 'pillars': pillars,
                    'card': smi}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def _require_per_call(launches, per_call, calls, what):
    """Raise unless ``launches`` counts ``per_call[name]`` launches of each
    kernel for each of ``calls`` calls, and none of any other kernel."""
    for name, n in launches.items():
        if n != per_call.get(name, 0) * calls:
            raise AssertionError(f'{name}: {n} launches in {calls} {what}, '
                                 f'want {per_call.get(name, 0)} each')


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
