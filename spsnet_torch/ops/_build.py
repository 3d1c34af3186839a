"""Build and load the port's CUDA kernels.

Each source in ``spsnet_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, and loaded
with ``ctypes``. The build runs at first use (never at import), all sources
in parallel, into ``build/spsnet_torch/<hash>/`` at the repo root, where the
hash covers the sources, the headers they share (``*.cuh``) and the flags,
so an edited source is rebuilt.

Every kernel wrapper adds one to ``LAUNCHES[name]`` where it launches its
kernel and nowhere else, so a run can show which kernels its path went
through. ``fps.cu`` holds two kernels (``fps``, ``fps_seeded``),
``ball_query.cu`` two forms of one (``ball_query``, and
``ball_query_annulus`` for the dilated grouping's annulus); every other
source holds one, named as its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_ROOT = _PKG.parent / 'build' / 'spsnet_torch'
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and
# spills; the report is kept beside the library (``ptxas_report``)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-fmad=false', '-Xptxas', '-v', '-shared', '-Xcompiler',
              '-fPIC')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
# C signatures by library (one per source): every pointer and the stream
# as c_void_p, an int array written by the library as _IP
SIGNATURES = {
    'fps': {'spsnet_fps': [_P, _P, _P, _I, _I, _I, _P],
            'spsnet_fps_seeded': [_P, _P, _P, _P, _I, _I, _I, _I, _P],
            'spsnet_fps_max_n': [],
            'spsnet_fps_cluster_size': [_I, _I],
            'spsnet_fps_threads': [],
            'spsnet_fps_max_active_clusters': [_I, _I, _I]},
    'ball_query': {'spsnet_ball_query': [_P, _P, _P, _P, _I, _I, _I, _F, _I,
                                         _F, _I, _I, _F, _F, _P],
                   'spsnet_ball_query_warp_centers': [_I, _I]},
    'seed_min': {'spsnet_seed_min': [_P, _P, _P, _I, _I, _I, _P],
                 'spsnet_seed_min_shape': [_I, _I, _I, _IP]},
    'three_nn': {'spsnet_three_nn': [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _P],
                 'spsnet_three_nn_workspace': [_I, _I]},
    'fps_dist': {'spsnet_fps_dist': [_P, _P, _I, _I, _I, _P],
                 'spsnet_fps_dist_max_n': [],
                 'spsnet_fps_dist_cluster_size': [_I, _I]},
}
KERNELS = ('fps', 'fps_seeded', 'ball_query', 'ball_query_annulus',
           'seed_min', 'three_nn', 'fps_dist')

LAUNCHES = {name: 0 for name in KERNELS}
_LIBS: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def find_nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    for cand in (shutil.which('nvcc'), os.path.join(cuda_home, 'bin', 'nvcc')):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        'nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built '
        'from spsnet_torch/csrc at first use and need the CUDA toolkit')


def build_dir() -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for name in sorted(SIGNATURES):
        h.update(name.encode())
        h.update((CSRC / f'{name}.cu').read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together. Returns the seconds spent; raises on a failed build."""
    out_dir = build_dir()
    todo = [n for n in SIGNATURES if not (out_dir / f'{n}.so').exists()]
    if not todo:
        return 0.0
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out_dir / f'{name}.{os.getpid()}.tmp.so'
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f'{name}.cu (nvcc exit {proc.returncode}):\n{log}')
        else:
            (out_dir / f'{name}.log').write_text(log)
            os.replace(tmp, out_dir / f'{name}.so')  # atomic publish
    if errors:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(errors))
    return time.perf_counter() - t0


def ptxas_report(name: str) -> list:
    """ptxas's lines on the kernels of library ``name`` (registers, shared
    memory, spill stores and loads), from its build."""
    lines = (build_dir() / f'{name}.log').read_text().splitlines()
    return [ln.split('ptxas info    : ', 1)[-1] for ln in lines
            if 'Used' in ln or 'spill' in ln or 'Compiling entry' in ln]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(build_dir() / f'{name}.so'))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err} at launch')


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
