"""Build, load and count the port's CUDA kernels.

Each ``csrc/*.cu`` source holds one or more kernels with a plain C
interface (``flash_decode.cu`` holds K3 and K4, ``planar_matmul.cu`` K5's
two bodies and K6, ``dequantize.cu`` K7 and K10, ``pair_matmul.cu`` K1's
CUDA-core body and K9, ``pair_splitk.cu`` the split-K tensor-core body
that K1 and K9 launch at 3-128 token rows (from ``PAIR_SPLITK_MIN_TOKENS``
in ``ops/qmatmul.py``), ``pair_prefill.cu`` the tensor-core body that K8
and K1 above 128 rows launch, ``fused_glue.cu`` the decoder layer's glue
K11-K13, each with its own :class:`Kernel` record and launch counter). A
source is compiled by its own ``nvcc`` call for ``sm_90a`` into a shared
library under ``quantizations_tpu_torch/build/`` (named by a hash of the source,
so an edited source rebuilds) and loaded with ``ctypes``. :func:`build`
starts every missing build at once and waits for all of them; a launch
builds its own kernel if nothing built it before. Nothing is built at
import: the CPU tests import every module on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["Kernel", "PAIR_MATMUL", "PAIR_MATMUL_MMA", "PAIR_MATMUL_SPLITK",
           "QUANTIZE_4BIT",
           "FLASH_DECODE", "FLASH_DECODE_I8", "PLANAR_MATMUL",
           "PLANAR_MATMUL_MMA", "GEMV_4BIT",
           "DEQUANTIZE_4BIT", "DEQUANTIZE_4BIT_PAIR", "PAIR_PREFILL",
           "PAIR_MANUAL", "ADD_RMS_NORM", "ROPE_QK", "GLU_ACT", "KERNELS",
           "build", "launch", "nvcc_path", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

# No --use_fast_math: the quantize kernel needs the IEEE 1.0f / absmax.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64


@dataclasses.dataclass
class Kernel:
    """A kernel's identity, its C entry points and its launch counter:
    the wrapper adds one to ``launches`` each time it launches the
    kernel, and nowhere else.

    ``functions`` maps each C entry point to its argument types (every
    pointer and the trailing stream are ``c_void_p``: a plain int would
    cut them to 32 bits); every entry point returns ``cudaGetLastError()``
    as an int. Where the wrapper chooses the grid (K3/K4), it keeps the
    last launch's ``(n_split, chunk, blocks)`` in ``last_grid`` for the
    logs."""

    name: str
    source: str            # the .cu file, relative to the repo root
    replaces: str          # the TPU kernel, file:line
    functions: Dict[str, Sequence]
    launches: int = 0
    last_grid: Optional[Tuple[int, int, int]] = None

    @property
    def path(self) -> Path:
        return _PKG.parent / self.source

    def so_path(self) -> Path:
        digest = hashlib.sha256(self.path.read_bytes()).hexdigest()[:16]
        return BUILD / f"lib{self.path.stem}_{digest}.so"


# (wp2, scales, scale_kind, table, x, y, T, M2, K4, has_factor, factor)
_PAIR_ARGS = [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _F, _P]
PAIR_MATMUL = Kernel(
    "pair_matmul", "quantizations_tpu_torch/csrc/pair_matmul.cu",
    "quantizations_tpu/ops/qmatmul.py:481 _pair_kernel "
    "(matmul_4bit_pair_pallas_stacked :662, matmul_4bit_pair_pallas :588)",
    {"qt_pair_matmul": _PAIR_ARGS})
QUANTIZE_4BIT = Kernel(
    "quantize_4bit", "quantizations_tpu_torch/csrc/quantize.cu",
    "quantizations_tpu/ops/quantize.py:93 _quantize_kernel "
    "(quantize_4bit_pallas :142)",
    {"qt_quantize_4bit": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P]})
# (q, q_f32, k, v, [ks, vs,] table, lengths, out, B, KVH, QG, G, D, page,
#  max_pages, n_pos, has_win, win, scale, has_cap, cap, inv_cap, n_split,
#  chunk, group_rows, part, part_ml, stream)
_DECODE_TAIL = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                _F, _F, _I, _I, _I, _P, _P, _P]
FLASH_DECODE = Kernel(
    "flash_decode", "quantizations_tpu_torch/csrc/flash_decode.cu",
    "quantizations_tpu/ops/attention.py:38 _kernel "
    "(flash_decode_attention :171, flash_decode_attention_stacked :224, "
    "ops/paged_attention.py:47 paged_flash_decode_attention)",
    {"qt_flash_decode_bf16": [_P, _I, _P, _P] + _DECODE_TAIL})
FLASH_DECODE_I8 = Kernel(
    "flash_decode_i8", "quantizations_tpu_torch/csrc/flash_decode.cu",
    "quantizations_tpu/ops/attention.py:108 _kernel_i8 "
    "(flash_decode_attention_stacked_i8 :303, "
    "ops/paged_attention.py:141 paged_flash_decode_attention_i8)",
    {"qt_flash_decode_i8": [_P, _I, _P, _P, _P, _P] + _DECODE_TAIL})
# (wp, scales, scale_kind, table, x, y, T, M, K8, has_factor, factor)
_PLANAR_ARGS = [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _F, _P]
PLANAR_MATMUL = Kernel(
    "planar_matmul", "quantizations_tpu_torch/csrc/planar_matmul.cu",
    "quantizations_tpu/ops/qmatmul.py:43 _kernel "
    "(matmul_4bit_pallas :93, matmul_4bit_pallas_stacked :154)",
    {"qt_planar_matmul": _PLANAR_ARGS})
# K5 from PLANAR_MMA_MIN_TOKENS rows on (ops/qmatmul.py): its tensor-core
# body, counted here and in PLANAR_MATMUL's count of every K5 launch.
PLANAR_MATMUL_MMA = Kernel(
    "planar_matmul_mma", "quantizations_tpu_torch/csrc/planar_matmul.cu",
    PLANAR_MATMUL.replaces, {"qt_planar_mma": _PLANAR_ARGS})
GEMV_4BIT = Kernel(
    "gemv_4bit", "quantizations_tpu_torch/csrc/planar_matmul.cu",
    "quantizations_tpu/ops/gemv.py:150 _gemv_kernel "
    "(gemv_4bit_pallas :296, gemv_4bit_pallas_stacked :353)",
    # (wp, scales, scale_kind, table, x, x_kind, y, B, M, K8, has_factor,
    #  factor)
    {"qt_gemv_4bit": [_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _F, _P]})
DEQUANTIZE_4BIT = Kernel(
    "dequantize_4bit", "quantizations_tpu_torch/csrc/dequantize.cu",
    "quantizations_tpu/ops/quantize.py:128 _dequantize_kernel "
    "(dequantize_4bit_pallas :192)",
    # (wp, scales, scale_kind, table, out, out_kind, M, K8)
    {"qt_dequantize_4bit": [_P, _P, _I, _P, _P, _I, _I, _I, _P]})
# K10: no Pallas site; the reference dequantizes the pair words with XLA
DEQUANTIZE_4BIT_PAIR = Kernel(
    "dequantize_4bit_pair", "quantizations_tpu_torch/csrc/dequantize.cu",
    "quantizations_tpu/nn/linear.py:128 dense_matmul_pair (XLA dequant; "
    "no Pallas site)",
    # (wp2, scales, scale_kind, table, out, out_kind, M2, K4)
    {"qt_dequantize_4bit_pair": [_P, _P, _I, _P, _P, _I, _I, _I, _P]})
# _PAIR_ARGS with the tile (bm, bn) before the stream
_MMA_ARGS = _PAIR_ARGS[:-1] + [_I, _I, _P]
PAIR_PREFILL = Kernel(
    "pair_prefill", "quantizations_tpu_torch/csrc/pair_prefill.cu",
    "quantizations_tpu/ops/qmatmul.py:755 _pair_prefill_kernel "
    "(matmul_4bit_pair_prefill_pallas :837, "
    "matmul_4bit_pair_prefill_pallas_stacked :891)",
    {"qt_pair_mma": _MMA_ARGS})
# K1 above PAIR_MMA_MIN_TOKENS rows (ops/qmatmul.py): K8's tensor-core
# body, counted here and in PAIR_MATMUL's count of every K1 launch.
PAIR_MATMUL_MMA = Kernel(
    "pair_matmul_mma", "quantizations_tpu_torch/csrc/pair_prefill.cu",
    PAIR_MATMUL.replaces, {"qt_pair_mma": _MMA_ARGS})
# K1 and K9 from PAIR_SPLITK_MIN_TOKENS up to 128 rows (ops/qmatmul.py
# pair_body): the split-K tensor-core body, counted here and in
# PAIR_MATMUL's count of every K1 launch (PAIR_MANUAL's of every K9 one).
PAIR_MATMUL_SPLITK = Kernel(
    "pair_matmul_splitk", "quantizations_tpu_torch/csrc/pair_splitk.cu",
    PAIR_MATMUL.replaces, {"qt_pair_splitk": _PAIR_ARGS})
PAIR_MANUAL = Kernel(
    "pair_manual", "quantizations_tpu_torch/csrc/pair_matmul.cu",
    "quantizations_tpu/ops/qmatmul.py:1048 _manual_kernel_body "
    "(matmul_4bit_pair_manual :1103, matmul_4bit_pair_manual_stacked :1163)",
    {"qt_pair_manual": _PAIR_ARGS})
# K11-K13: no Pallas site; the reference leaves the layer's glue to XLA
_GLUE = "quantizations_tpu_torch/csrc/fused_glue.cu"
ADD_RMS_NORM = Kernel(
    "add_rms_norm", _GLUE,
    "quantizations_tpu/models/llama.py:616 rms_norm, :623 _norm and the "
    "residual adds :1039, :1058 (XLA; no Pallas site)",
    # (x, x_kind, ldx, delta, delta_kind, ldd, w, w_kind, plus_one, res, y,
    #  y_kind, N, H, eps, inv_h)
    {"qt_add_rms_norm": [_P, _I, _L, _P, _I, _L, _P, _I, _I, _P, _P, _I, _I,
                         _I, _F, _F, _P]})
ROPE_QK = Kernel(
    "rope_qk", _GLUE,
    "quantizations_tpu/models/llama.py:666 apply_rope (XLA; no Pallas "
    "site)",
    # (q, ldq, k, ldk, cos, sin, q_out, k_out, N, n_q, n_kv, D)
    {"qt_rope_qk": [_P, _L, _P, _L, _P, _P, _P, _P, _L, _I, _I, _I, _P]})
GLU_ACT = Kernel(
    "glu_act", _GLUE,
    "quantizations_tpu/models/llama.py:632 _act and the gated product "
    "(XLA; no Pallas site)",
    # (g, ldg, u, ldu, out, out_kind, N, I, act)
    {"qt_glu_act": [_P, _L, _P, _L, _P, _I, _L, _I, _I, _P]})
KERNELS = (PAIR_MATMUL, PAIR_MATMUL_SPLITK, PAIR_MATMUL_MMA, QUANTIZE_4BIT,
           FLASH_DECODE, FLASH_DECODE_I8, PLANAR_MATMUL, PLANAR_MATMUL_MMA,
           GEMV_4BIT, DEQUANTIZE_4BIT, PAIR_PREFILL, PAIR_MANUAL,
           DEQUANTIZE_4BIT_PAIR, ADD_RMS_NORM, ROPE_QK, GLU_ACT)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build(kernels: Sequence[Kernel] = KERNELS) -> None:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together; raise if any build fails. Then load
    them all."""
    with _lock:
        BUILD.mkdir(parents=True, exist_ok=True)
        jobs, started = [], set()
        for k in kernels:
            so = k.so_path()
            if so.exists() or k.name in _libs or so in started:
                continue
            started.add(so)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(k.path)]
            jobs.append((k, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for k, so, tmp, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, so)
            else:
                os.unlink(tmp)
                failed.append(f"{k.source}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for k in kernels:
            if k.name not in _libs:
                lib = ctypes.CDLL(str(k.so_path()))
                for fn, argtypes in k.functions.items():
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                _libs[k.name] = lib


def launch(kernel: Kernel, fn: str, device: torch.device, *args) -> None:
    """Call C entry point ``fn`` of ``kernel`` on ``device``'s current
    stream (appended as the last argument), raise if the launch was
    refused, and count it. The stream and the current device are read
    through ``torch._C`` directly (a device guard only where ``device`` is
    not the current one): ``torch.cuda.device`` and ``current_stream``
    cost more host time than the launch itself."""
    lib = _libs.get(kernel.name)
    if lib is None:
        build([kernel])
        lib = _libs[kernel.name]
    cur = torch.cuda.current_device()
    idx = cur if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == cur:
        err = getattr(lib, fn)(*args, stream)
    else:
        with torch.cuda.device(idx):
            err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{kernel.name}: CUDA launch failed with error {err}")
    kernel.launches += 1
