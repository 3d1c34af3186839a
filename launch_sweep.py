#!/usr/bin/env python3
"""Launch-shape sweeps of the port's kernels on one CUDA card.

    python3 launch_sweep.py

The launch shapes of the kernels are fixed rules in their sources
(``spsnet_torch/csrc``), with no override in the C entries or the Python
wrappers. To see what another shape would do, this script compiles
variants of a source into ``build/launch_sweep/`` (the rule's result
replaced by a value the script sets through an added C entry, or another
constant), checks every variant against the plain PyTorch version on the
card, and times it beside the kept source in one process (device time of
one call, ``chip_smoke.device_ms``):

1. K3, the min distance to the seeds (``csrc/seed_min.cu``), at the train
   path's two layers, (4, 16384) with 3072 grid seeds and (4, 4096) with
   768: tiles of points (CTA threads x points a thread) against the
   cluster size S, the default cluster scheduling against load balancing,
   two ``fminf`` against the DPX three-way min, and the kernel with its
   distance loop taken out (the fixed cost of launch, staging and
   reduction);
2. K1, exact FPS (``csrc/fps.cu``), at batch sizes past 8 and at the K5
   shapes, against the cluster size C;
3. K6, the three-NN (``csrc/three_nn.cu``), at the six calls of a
   PV-RCNN++ request's VSA and the four FP calls of a PointRCNN request:
   4 warps a CTA against the kept 8, groups of 4, 16 or 32 queries in the
   warp-wide test against 8, chunks of 2 or 8 sub-tiles against 4, the
   scan without its culling, without its suffix rule, and (``--parent
   ROOT``) the
   ``three_nn.cu`` of another checkout, e.g. the parent commit's, unpacked
   under ``build/``; device time of a call (pre-pass and scan,
   ``chip_smoke.device_ms_by_kernel``) and the pairs scanned;
4. K7, F-FPS over a distance matrix (``csrc/fps_dist.cu``), at IASSD_FS's
   two calls, (8, 4096) -> 512 and (8, 1024) -> 512, on the matrices of
   the path's own features: every cluster size C against the rule's,
   CTAs of 128 and 512 threads against 256, and (``--parent ROOT``) the
   ``fps_dist.cu`` of another checkout, timed first and last.

    python3 launch_sweep.py [--k6-only | --k7-only] [--parent ROOT]

Prints one line per variant and shape, then one JSON line with every
number and the card's name and power limit. Exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / 'build' / 'launch_sweep'
K1_SHAPES = ((32, 4096, 1024), (16, 16384, 4096), (64, 4096, 1024),
             (16, 4096, 1024), (1, 16384, 4096), (8, 16384, 4096),
             (8, 15884, 4096))
SPLITS = (1, 2, 4, 8, 16)


def _sub(text, old, new):
    if old not in text:
        raise AssertionError(f'variant: {old!r} not in the source')
    return text.replace(old, new, 1)


def seed_min_variant(src, threads=128, points=4, policy=True, fmin=False,
                     compute=True):
    """csrc/seed_min.cu with S settable (``set_split``) and the given CTA
    width, points a thread, scheduling policy, min and distance loop."""
    text = _sub(src, 'const int S = split(B, N, k0);',
                'const int S = g_split > 0 ? g_split : split(B, N, k0);')
    text = _sub(text, 'cudaError_t launch(', 'int g_split = 0;\n'
                'cudaError_t launch(')
    text += '\nextern "C" void set_split(int s) { g_split = s; }\n'
    text = _sub(text, 'constexpr int kThreads = 128;',
                f'constexpr int kThreads = {threads};')
    text = _sub(text, 'constexpr int kPoints = 4;',
                f'constexpr int kPoints = {points};')
    if not policy:
        text = _sub(text, 'cfg.numAttrs = 2;', 'cfg.numAttrs = 1;')
    if fmin:
        text = text.replace('m[k] = __vimin3_s32(', 'm[k] = fmin3(')
        text = _sub(text, '__global__ void __launch_bounds__(kThreads)',
                    '__device__ __forceinline__ int fmin3(int a, int b, '
                    'int c) {\n  return __float_as_int(fminf(fminf('
                    '__int_as_float(a), __int_as_float(b)), '
                    '__int_as_float(c)));\n}\n'
                    '__global__ void __launch_bounds__(kThreads)')
    if not compute:
        text = _sub(text, 'for (int j = 0; j < n4 / 4; ++j) {',
                    'for (int j = 0; j < 0; ++j) {')
    return text


def fps_variant(src):
    """csrc/fps.cu with the cluster size settable (``set_c``)."""
    text = _sub(src, 'const int C = cluster_size(B, N, kThreads);',
                'const int C = g_c > 0 ? g_c : '
                'cluster_size(B, N, kThreads);')
    text = _sub(text, 'template <bool kSeeded>\ncudaError_t dispatch(',
                'int g_c = 0;\ntemplate <bool kSeeded>\ncudaError_t dispatch(')
    return text + '\nextern "C" void set_c(int c) { g_c = c; }\n'


def fps_dist_variant(src, threads=256):
    """csrc/fps_dist.cu with the cluster size settable (``set_c``) and
    another CTA width."""
    text = _sub(src, 'const int C = cluster_size(B, N, kThreads);',
                'const int C = g_c > 0 ? g_c : '
                'cluster_size(B, N, kThreads);')
    text = _sub(text, '// One instantiation per power-of-two share',
                'int g_c = 0;\n// One instantiation per power-of-two share')
    text = _sub(text, 'constexpr int kThreads = 256;',
                f'constexpr int kThreads = {threads};')
    return text + '\nextern "C" void set_c(int c) { g_c = c; }\n'


def three_nn_variant(src, warps=8, lanes=8, chunk=4, cull=True,
                     suffix=True):
    """csrc/three_nn.cu with another CTA width, group of the warp-wide
    test or chunk of sub-tiles where none is culled, or a rule taken out
    (``cull=False``: every batch scanned whole)."""
    text = _sub(src, 'constexpr int kWarps = 8;',
                f'constexpr int kWarps = {warps};')
    text = _sub(text, 'constexpr int kLanes = 8;',
                f'constexpr int kLanes = {lanes};')
    text = _sub(text, 'constexpr int kChunk = 4;',
                f'constexpr int kChunk = {chunk};')
    if not cull:
        text = _sub(text, 'unsigned marked = __ballot_sync(kFull, may);',
                    'unsigned marked = __ballot_sync(kFull, may);\n'
                    '    marked = nb == kTile ? kFull : (1u << nb) - 1;')
    if not suffix:
        text = _sub(text, 'const int limit = min(M, run[b] + 3);',
                    'const int limit = M;')
    return text


def build(variants):
    """Compile {name: source text} in parallel; returns {name: CDLL}."""
    from spsnet_torch.ops import _build
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for name, text in variants.items():
        (OUT / f'{name}.cu').write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, '-I', str(_build.CSRC), '-o',
             str(OUT / f'{name}.so'), str(OUT / f'{name}.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'{name}: nvcc failed\n{log}')
        regs = [ln.split('ptxas info    : ')[-1] for ln in log.splitlines()
                if 'Used' in ln]
        print(f'{name}: {" | ".join(regs)}', flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f'{name}.so'))
    return libs


def seed_min_inputs():
    """The train path's K3 inputs: grid seeds of layer 0's scenes, then of
    layer 1's points (the plain seeded FPS picks)."""
    import chip_smoke as cs
    from spsnet_torch.ops import gather_points
    from spsnet_torch.ops import sampling as smp
    cloud = cs._scene_batch(0, cs.TRAIN_B, 'cuda')['points'][..., :3]
    cloud = cloud.contiguous()
    cases = []
    for layer, npoint in enumerate((4096, 1024)):
        k0 = smp.seed_k0(cs.seeding(), npoint)
        idx = smp.grid_seed_indices(cloud, k0)
        seeds = gather_points(cloud, idx).contiguous()
        d0 = smp.seed_min_d2_plain(cloud, seeds)
        cases.append((f'layer {layer} {tuple(cloud.shape)} k0={k0}', cloud,
                      seeds, d0))
        picks = smp.farthest_point_sample_seeded_plain(cloud, npoint, d0, idx)
        cloud = gather_points(cloud, picks).contiguous()
    return cases


def sweep_seed_min(results):
    import chip_smoke as cs
    src = (ROOT / 'spsnet_torch/csrc/seed_min.cu').read_text()
    swept = {f't{t}p{p}': seed_min_variant(src, t, p)
             for t, p in ((128, 4), (256, 2), (128, 2), (256, 4), (256, 8))}
    swept['t128p4_default_policy'] = seed_min_variant(src, policy=False)
    extra = {'t128p4_fminf': seed_min_variant(src, fmin=True),
             't128p4_no_distance_loop': seed_min_variant(src, compute=False)}
    libs = build({**swept, **extra})
    cases = seed_min_inputs()
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        fn = lib.spsnet_seed_min
        fn.argtypes = [P, P, P, I, I, I, P]
        for split in (0,) + (SPLITS if name in swept else ()):
            lib.set_split(split)
            for label, xyz, seeds, want in cases:
                out = torch.empty(xyz.shape[:2], device='cuda')

                def call(x=xyz, s=seeds, o=out):
                    err = fn(x.data_ptr(), s.data_ptr(), o.data_ptr(),
                             x.shape[0], x.shape[1], s.shape[1], stream)
                    if err:
                        raise RuntimeError(f'{name}: CUDA error {err}')
                call()
                torch.cuda.synchronize()
                same = torch.equal(out, want)
                if not same and 'no_distance' not in name:
                    raise AssertionError(f'{name} S={split} {label}: != plain')
                us = [cs.device_ms(call, reps=31) * 1e3 for _ in range(2)]
                key = f'seed_min {name} S={split or "rule"} {label}'
                results[key] = us
                print(f'{key}: {us[0]:.2f} {us[1]:.2f} us', flush=True)


def sweep_fps(results):
    import chip_smoke as cs
    from spsnet_torch.ops.sampling import farthest_point_sample_plain
    from spsnet_torch.utils.synthetic import synthetic_scan_batch
    src = (ROOT / 'spsnet_torch/csrc/fps.cu').read_text()
    lib = build({'fps_c': fps_variant(src)})['fps_c']
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.spsnet_fps.argtypes = [P, P, P, I, I, I, P]
    stream = torch.cuda.current_stream().cuda_stream
    for b, n, m in K1_SHAPES:
        xyz = torch.from_numpy(synthetic_scan_batch(11, b, n)[..., :3]
                               .copy()).cuda().contiguous()
        want = farthest_point_sample_plain(xyz, m)
        out = torch.empty(b, m, dtype=torch.int64, device='cuda')
        rule = lib.spsnet_fps_cluster_size(b, n)
        for c in (2, 4, 8, 16):
            if n > c * lib.spsnet_fps_threads() * 16:
                continue  # more than 16 points a thread: no instantiation
            lib.set_c(c)

            def call(x=xyz, o=out, b=b, n=n, m=m):
                err = lib.spsnet_fps(x.data_ptr(), None, o.data_ptr(), b, n,
                                     m, stream)
                if err:
                    raise RuntimeError(f'fps C={c}: CUDA error {err}')
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f'fps C={c} ({b}, {n}) -> {m}: != plain')
            ms = [cs.device_ms(call, reps=5) for _ in range(2)]
            key = f'fps ({b}, {n}) -> {m} C={c}' + (' (rule)' if c == rule
                                                     else '')
            results[key] = ms
            print(f'{key}: {ms[0]:.4f} {ms[1]:.4f} ms', flush=True)
        lib.set_c(0)


def three_nn_inputs():
    """The (unknown, known) of K6's calls on the main paths: the six of a
    PV-RCNN++ request (B = 2 Waymo scans) and the four of a PointRCNN one
    (B = 8 x 16384), with chip_smoke's seeds."""
    import chip_smoke as cs
    from spsnet_torch.models import sa_module
    from spsnet_torch.models.model_utils import vector_pool
    from spsnet_torch.utils.synthetic import synthetic_scan_batch
    cfg, model = cs.build_voxel_detector('waymo_models/pv_rcnn_plusplus',
                                         'cuda')
    batch = cs.pv_host_batches(cfg, range(1800, 1802), cs.PP_B, cs.CP_N,
                               5)['batches'][0]
    with cs.calls_of(vector_pool, 'three_nn') as pp, torch.no_grad():
        model(batch)
    del model
    _, prcnn = cs.build_pointrcnn('cuda')
    points = torch.from_numpy(synthetic_scan_batch(0, cs.B, cs.N)).cuda()
    with cs.calls_of(sa_module, 'three_nn') as fp, torch.no_grad():
        prcnn({'points': points})
    return [(f'PV-RCNN++ VSA call {i}', a[0].contiguous(), a[1].contiguous())
            for i, (a, _, _) in enumerate(pp)] + \
        [(f'PointRCNN FP call {i}', a[0].contiguous(), a[1].contiguous())
         for i, (a, _, _) in enumerate(fp)]


def sweep_three_nn(results, parent=None):
    import chip_smoke as cs
    from spsnet_torch.ops.interpolate import three_nn_plain
    src = (ROOT / 'spsnet_torch/csrc/three_nn.cu').read_text()
    variants = {'kept': three_nn_variant(src),
                'warps4': three_nn_variant(src, warps=4),
                'lanes4': three_nn_variant(src, lanes=4),
                'lanes16': three_nn_variant(src, lanes=16),
                'lanes32': three_nn_variant(src, lanes=32),
                'chunk2': three_nn_variant(src, chunk=2),
                'chunk8': three_nn_variant(src, chunk=8),
                'no_cull': three_nn_variant(src, cull=False),
                'no_suffix': three_nn_variant(src, suffix=False)}
    if parent:
        variants['parent'] = (Path(parent) / 'spsnet_torch/csrc/three_nn.cu'
                              ).read_text()
    libs = build(variants)
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    cases = three_nn_inputs()
    wants = [three_nn_plain(u, k) for _, u, k in cases]
    totals = {}
    for name, lib in libs.items():
        old = name == 'parent'
        fn = lib.spsnet_three_nn
        fn.argtypes = [P] * 4 + [I] * 3 + [P] if old else \
            [P] * 6 + [I] * 3 + [P]
        if not old:
            lib.spsnet_three_nn_workspace.argtypes = [I, I]
        for (label, u, k), want in zip(cases, wants):
            b, n, m = u.shape[0], u.shape[1], k.shape[1]
            dist = torch.empty(b, n, 3, device='cuda')
            idx = torch.empty(b, n, 3, dtype=torch.int64, device='cuda')
            pairs = torch.zeros(b, dtype=torch.int64, device='cuda')
            work = None if old else torch.empty(
                lib.spsnet_three_nn_workspace(b, m) * 16, dtype=torch.uint8,
                device='cuda')

            def call(count=None, u=u, k=k, d=dist, i=idx, w=work, b=b, n=n,
                     m=m):
                if old:
                    err = fn(u.data_ptr(), k.data_ptr(), d.data_ptr(),
                             i.data_ptr(), b, n, m, stream)
                else:
                    err = fn(u.data_ptr(), k.data_ptr(), d.data_ptr(),
                             i.data_ptr(), w.data_ptr(),
                             None if count is None else count.data_ptr(), b,
                             n, m, stream)
                if err:
                    raise RuntimeError(f'three_nn {name}: CUDA error {err}')
            call(pairs)
            torch.cuda.synchronize()
            if not (torch.equal(idx, want[1]) and torch.equal(
                    dist.view(torch.int32), want[0].view(torch.int32))):
                raise AssertionError(f'three_nn {name} {label}: != plain')
            ms = [cs.device_ms_by_kernel(call, reps=3)[0] for _ in range(2)]
            scanned = b * n * m if old else int(pairs.sum())
            key = f'three_nn {name} {label} ({b}, {n}) x ({b}, {m})'
            results[key] = {'ms': ms, 'pairs_scanned': scanned,
                            'pairs': b * n * m}
            group = label.split(' call')[0]
            totals.setdefault(f'three_nn {name} {group}', []).append(ms)
            print(f'{key}: {ms[0]:.4f} {ms[1]:.4f} ms, pairs scanned '
                  f'{scanned:.4e} of {b * n * m:.4e}', flush=True)
    for key, ms in totals.items():
        results[key + ' (sum)'] = [sum(t[0] for t in ms),
                                   sum(t[1] for t in ms)]
        print(f'{key} (sum): {results[key + " (sum)"][0]:.3f} '
              f'{results[key + " (sum)"][1]:.3f} ms', flush=True)


def fps_dist_inputs():
    """The matrices of IASSD_FS's two F-FPS calls (FS's at layer 1, layer
    2's) in a forward of chip_smoke's first IASSD_FS request, with their
    npoint."""
    import chip_smoke as cs
    from spsnet_torch.ops import calc_square_dist
    from spsnet_torch.utils.synthetic import synthetic_scan_batch
    _, model = cs.build_family('IASSD_FS', 'cuda')
    scans = torch.from_numpy(synthetic_scan_batch(
        cs.FAMILY_SEEDS['IASSD_FS'], cs.B, cs.N)).cuda()
    inputs, _ = cs.ffps_inputs(model, scans)
    with torch.no_grad():
        return [(calc_square_dist(f, f).contiguous(), m) for f, m in inputs]


def sweep_fps_dist(results, parent=None):
    """K7 at each cluster size and CTA width against the rule's, and the
    parent's, in the order parent, rule, the others, rule, parent; every
    variant held to the plain F-FPS first."""
    import chip_smoke as cs
    from spsnet_torch.ops.sampling import \
        farthest_point_sample_with_dist_plain
    src = (ROOT / 'spsnet_torch/csrc/fps_dist.cu').read_text()
    variants = {'kept': fps_dist_variant(src),
                't128': fps_dist_variant(src, 128),
                't512': fps_dist_variant(src, 512)}
    if parent:
        variants['parent'] = (Path(parent) / 'spsnet_torch/csrc/fps_dist.cu'
                              ).read_text()
    libs = build(variants)
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for lib in libs.values():
        lib.spsnet_fps_dist.argtypes = [P, P, I, I, I, P]
    cases = [(m, npoint, farthest_point_sample_with_dist_plain(m, npoint))
             for m, npoint in fps_dist_inputs()]
    rule = libs['kept'].spsnet_fps_dist_cluster_size
    runs = [('kept', 0)] + [(name, c) for name in ('kept', 't128', 't512')
                            for c in (2, 4, 8, 16)] + [('kept', 0)]
    if parent:
        runs = [('parent', 0)] + runs + [('parent', 0)]
    for name, c in runs:
        lib = libs[name]
        if name != 'parent':
            lib.set_c(c)
        threads = int(name[1:]) if name[0] == 't' else 256
        for mat, npoint, want in cases:
            b, n, _ = mat.shape
            if c and n > c * threads * 16:
                continue  # more than 16 columns a thread: no instantiation
            out = torch.empty(b, npoint, dtype=torch.int64, device='cuda')

            def call(m=mat, o=out, b=b, n=n, k=npoint):
                err = lib.spsnet_fps_dist(m.data_ptr(), o.data_ptr(), b, n, k,
                                          stream)
                if err:
                    raise RuntimeError(f'fps_dist {name} C={c}: CUDA error '
                                       f'{err}')
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f'fps_dist {name} C={c} ({b}, {n}) -> '
                                     f'{npoint}: != plain')
            ms = [cs.device_ms(call, reps=5) for _ in range(2)]
            label = 'one CTA a row' if name == 'parent' else \
                f'C={c or rule(b, n)}' + (' (rule)' if name == 'kept' and (
                    not c or c == rule(b, n)) else '')
            key = f'fps_dist {name} ({b}, {n}) -> {npoint} {label}'
            results.setdefault(key, []).extend(ms)
            print(f'{key}: {ms[0]:.4f} {ms[1]:.4f} ms, '
                  f'{ms[0] * 1e3 / (npoint - 1):.3f} us a step', flush=True)


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print('launch_sweep: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    parent = argv[argv.index('--parent') + 1] if '--parent' in argv else None
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    results = {}
    if '--k7-only' not in argv:
        if '--k6-only' not in argv:
            sweep_seed_min(results)
            sweep_fps(results)
        sweep_three_nn(results, parent)
    if '--k6-only' not in argv:
        sweep_fps_dist(results, parent)
    print(json.dumps({'launch_sweep': results, 'card': card}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
