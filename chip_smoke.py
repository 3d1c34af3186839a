#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``spsnet_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the CUDA kernels from ``spsnet_torch/csrc`` (seconds printed);
3. each kernel against its plain PyTorch version on the card, index for
   index, at the main path's shapes: FPS at (8, 16384) -> 4096, at
   (1, 16384) -> 4096 and at sizes that are no multiple of 1024 (with a
   mask, and above the shared-memory limit); the prefix-nesting identity
   FPS(layer-0 chain, 1024) == arange(1024); the fused ball query at every
   SA layer with radii, on the centers the path produces. Times are CUDA
   events, median of repeated runs;
4. the main path: IA-SSD KITTI (``tools/cfgs/kitti_models/IA-SSD.yaml``) at
   full width with seeded random weights serves five requests of
   8 x 16384 points through forward + class-agnostic NMS; outputs must be
   finite with counts in [0, 500], and the launch counters, zeroed just
   before, must show one FPS and four ball-query launches per forward;
5. one scene through the same weights on the CPU, where the plain versions
   run: FPS, sampled points and ball-query indices identical (the CPU
   replays the card's ctr_aware picks once they check out as a top-k order
   of its own scores), predictions within the tolerance stated below, NMS
   outputs identical;
6. a CUDA-kernel breakdown of one request from ``torch.profiler``;
7. one JSON line per kernel set, then the result line.

Exits non-zero without printing a result when no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

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


def log(*args):
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
    return float((a - b).abs().max()) if a.numel() else 0.0


def fps_phase(xyz):
    """FPS kernel vs plain; returns the JSON entry without launches."""
    from spsnet_torch.ops import gather_points
    from spsnet_torch.ops.sampling import (farthest_point_sample_kernel,
                                           farthest_point_sample_plain)
    npoint = 4096
    got = farthest_point_sample_kernel(xyz, npoint)
    err = require_equal(got, farthest_point_sample_plain(xyz, npoint),
                        f'fps {tuple(xyz.shape)} -> {npoint}')
    err = max(err, require_equal(
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
    chain = gather_points(xyz, got)
    require_equal(farthest_point_sample_kernel(chain, 1024),
                  torch.arange(1024, device='cuda').expand(B, 1024),
                  'prefix nesting FPS(layer-0 chain, 1024) == arange(1024)')
    ms = cuda_ms(lambda: farthest_point_sample_kernel(xyz, npoint), reps=10)
    plain = cuda_ms(lambda: farthest_point_sample_plain(xyz, npoint), reps=3)
    bnd, by = bound_ms(xyz.numel() * 4 + B * npoint * 8,
                       (npoint - 1) * B * N * 10)  # 3 sub 3 mul 2 add min cmp
    log(f'  fps ({B}, {N}, 3) -> {npoint}: kernel {ms:.3f} ms, plain '
        f'{plain:.3f} ms, bound {bnd:.4f} ms ({by})')
    return {'name': 'fps', 'route': 'cuda',
            'source': 'spsnet_torch/csrc/fps.cu',
            'replaces': 'spsnet_tpu/ops/pallas/fps.py:167',
            'also_replaces': 'spsnet_tpu/ops/pallas/fps.py:26',
            'match': True, 'max_abs_err': err, 'ms': ms, 'plain_ms': plain,
            'bound_ms': bnd, 'bound_by': by, 'library_ms': None,
            'shape': f'({B},{N},3)->{npoint}'}


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


def ball_query_phase(model, points):
    """Ball-query kernel vs plain at every grouping layer, on the centers
    the path produces; returns the JSON entry without launches."""
    from spsnet_torch.ops.grouping import (ball_query_multi_kernel,
                                           ball_query_multi_plain)
    with torch.no_grad():
        enc = model({'points': points})['encoder_xyz']
    backbone = model.backbone_3d
    calls, err = [], 0.0
    for k, module in enumerate(backbone.SA_modules):
        if not getattr(module, 'radii', None):
            continue
        xyz = enc[backbone.layer_inputs[k]].contiguous()
        ctr = enc[k + 1].contiguous()
        radii, ns = tuple(module.radii), tuple(module.nsamples)
        got = ball_query_multi_kernel(radii, ns, xyz, ctr)
        want = ball_query_multi_plain(radii, ns, xyz, ctr)
        for r, g, w in zip(radii, got, want):
            err = max(err, require_equal(
                g, w, f'ball query layer {k} r={r} '
                      f'{tuple(ctr.shape[:2])}x{xyz.shape[1]}'))
        ms = cuda_ms(lambda: ball_query_multi_kernel(radii, ns, xyz, ctr),
                     reps=10)
        plain = cuda_ms(lambda: ball_query_multi_plain(radii, ns, xyz, ctr),
                        reps=3)
        pairs = _scan_pairs(got, ns, xyz.shape[1])
        n_bytes = (xyz.numel() + ctr.numel()) * 4 + \
            sum(g.numel() for g in got) * 8
        bnd, by = bound_ms(n_bytes, pairs * 10)  # 3 sub 3 mul 2 add 2 cmp
        log(f'  ball query layer {k} B={xyz.shape[0]} M={ctr.shape[1]} '
            f'N={xyz.shape[1]} r={radii} ns={ns}: kernel {ms:.3f} ms, plain '
            f'{plain:.3f} ms, bound {bnd:.4f} ms ({by}, {pairs} pairs)')
        calls.append({'layer': k, 'B': xyz.shape[0], 'M': ctr.shape[1],
                      'N': xyz.shape[1], 'radii': radii, 'nsamples': ns,
                      'ms': ms, 'plain_ms': plain, 'bound_ms': bnd,
                      'bound_by': by, 'pairs': pairs})
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
            'shape': 'sum of the per-forward calls', 'calls': calls}


def detect(model, points, post):
    """One request: forward + class-agnostic NMS, as a server runs it."""
    from spsnet_torch.models.detectors.detector3d import \
        class_agnostic_nms_batch
    with torch.no_grad():
        out = model({'points': points})
        return out, class_agnostic_nms_batch(
            out['batch_box_preds'], out['batch_cls_preds'],
            score_thresh=float(post.SCORE_THRESH),
            nms_thresh=float(post.NMS_CONFIG.NMS_THRESH),
            nms_pre=int(post.NMS_CONFIG.NMS_PRE_MAXSIZE),
            nms_post=int(post.NMS_CONFIG.NMS_POST_MAXSIZE))


def main_path(model, requests, post):
    """Serve the requests; returns (ms per request, launch counts)."""
    from spsnet_torch.ops import _build
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
                raise AssertionError(f'non-finite {key}')
        count = dets['count']
        if count.shape != (points.shape[0],) or count.min() < 0 or \
                count.max() > int(post.NMS_CONFIG.NMS_POST_MAXSIZE):
            raise AssertionError(f'detection counts out of range: {count}')
    return times, dict(_build.LAUNCHES)


@contextlib.contextmanager
def ctr_picks(replay=None):
    """Record the ctr_aware picks of a run, or replay recorded picks.

    ctr_aware sampling orders ~1000 sigmoid scores packed within a few fp32
    ulps of each other, so two devices whose matmuls round differently may
    order near-ties differently, and the order decides the first-k
    neighbours downstream. A replayed pick list must be a descending order
    of this run's own scores within CTR_SCORE_TOL rank by rank; then both
    runs continue from the same picks and stay comparable.
    """
    from spsnet_torch.models import samplers
    own_sampler = samplers.sample_ctr_aware
    picks = []

    def sampler(cls_features, npoint):
        own = own_sampler(cls_features, npoint)
        if replay is None:
            picks.append(own)
            return own
        want = replay[len(picks)].to(own.device)
        s = torch.sigmoid(cls_features.amax(-1))
        diff = float((s.gather(1, want) - s.gather(1, own)).abs().max())
        log(f'  ctr_aware picks {len(picks)}: {int((want != own).sum())} of '
            f'{own.numel()} ranks differ, largest rank-wise score difference '
            f'{diff:.3e} (tolerance {CTR_SCORE_TOL})')
        if diff > CTR_SCORE_TOL:
            raise AssertionError('ctr_aware picks are no top-k order of the '
                                 'other run\'s scores')
        picks.append(want)
        return want

    samplers.sample_ctr_aware = sampler
    try:
        yield picks
    finally:
        samplers.sample_ctr_aware = own_sampler


def cpu_phase(model, cfg, scene):
    """One scene on the card and on the CPU with the same weights; the CPU
    run replays the card's ctr_aware picks (see ``ctr_picks``)."""
    from spsnet_torch.models import build_detector
    from spsnet_torch.ops import farthest_point_sample
    from spsnet_torch.ops.grouping import ball_query_multi
    post = cfg.MODEL.POST_PROCESSING
    cpu = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), device='cpu')
    cpu.load_state_dict(model.state_dict())
    with ctr_picks() as picks:
        gpu_out, gpu_dets = detect(model, scene, post)
    with ctr_picks(replay=picks):
        cpu_out, cpu_dets = detect(cpu, scene.cpu(), post)
    backbone = model.backbone_3d
    enc = cpu_out['encoder_xyz']
    xyz = scene[..., :3].contiguous()
    require_equal(farthest_point_sample(xyz, 4096),
                  farthest_point_sample(xyz.cpu(), 4096),
                  'card kernel vs CPU plain: layer-0 FPS indices')
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
        a, c = gpu_out[key].cpu(), cpu_out[key]
        err = float((a - c).abs().max())
        if not torch.allclose(a, c, atol=PRED_ATOL, rtol=PRED_RTOL):
            raise AssertionError(f'card vs CPU {key}: max abs err {err:.3e} '
                                 f'over atol {PRED_ATOL} rtol {PRED_RTOL}')
        log(f'  card vs CPU {key}: max abs err {err:.3e} (atol '
            f'{PRED_ATOL}, rtol {PRED_RTOL})')
    for key in ('count', 'indices'):
        require_equal(gpu_dets[key], cpu_dets[key], f'card vs CPU NMS {key}')


def profile_phase(model, points, post):
    """Top CUDA kernels of one request by device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        detect(model, points, post)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, 'device_type', None) is not None
              and str(e.device_type).endswith('CUDA')
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in events) / 1e3
    log(f'  device time of one request: {total:.3f} ms over '
        f'{sum(e.count for e in events)} kernel launches')
    for e in events[:12]:
        log(f'    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} '
            f'{e.key[:90]}')
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from spsnet_torch.models import build_detector
    from spsnet_torch.ops import _build
    from spsnet_torch.utils.synthetic import synthetic_scan_batch
    from spsnet_torch.zoo import iassd_kitti_cfg

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

    cfg = iassd_kitti_cfg()
    model = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), device='cuda',
                           generator=torch.Generator().manual_seed(0))
    requests = [torch.from_numpy(synthetic_scan_batch(s, B, N)).cuda()
                for s in range(REQUESTS)]

    log('== 3. kernels vs plain on the card')
    entries = [fps_phase(requests[0][..., :3].contiguous()),
               ball_query_phase(model, requests[0])]

    log('== 4. main path')
    post = cfg.MODEL.POST_PROCESSING
    times, launches = main_path(model, requests, post)
    per_forward = {'fps': 1, 'ball_query': 4}
    for name, n in per_forward.items():
        if launches[name] != n * REQUESTS:
            raise AssertionError(f'{name}: {launches[name]} launches in '
                                 f'{REQUESTS} forwards, want {n} each')
    ms = statistics.median(times)
    log(f'  launches over {REQUESTS} requests: {launches}')
    log(f'  ms/batch (B={B}, N={N}, forward + NMS): median {ms:.3f}, all '
        f'{[round(t, 3) for t in times]}; scenes/s {B / ms * 1e3:.2f} '
        f'on {smi}')

    log('== 5. card vs CPU, one scene')
    cpu_phase(model, cfg, requests[0][:1])

    log('== 6. where the time goes')
    profile_phase(model, requests[0], post)

    for entry in entries:
        entry['launches'] = launches[entry['name']]
    log(json.dumps({'kernels': entries, 'ms_per_batch': ms,
                    'scenes_per_s': B / ms * 1e3, 'card': smi}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
