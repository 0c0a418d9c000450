"""The decoder layer's elementwise glue: K11 residual add + RMSNorm, K12
rope on q and k, K13 the gated MLP's activation
(``csrc/fused_glue.cu``), each beside its plain version.

The JAX package leaves this glue to XLA, which fuses it
(``quantizations_tpu/models/llama.py:616 rms_norm``, ``:666
apply_rope``, ``:632 _act``). The plain versions are the torch ops the
port ran eagerly, ~35 launches a layer; each kernel is one launch with
the plain version's values on the card: the residual, rope and
activation bit for bit, the norm within 1 ulp of its output type (its
sum of squares runs in another order). CUDA tensors launch the kernel,
CPU tensors run the plain version; every wrapper checks its operands
first, on either device, and raises ``ValueError`` on what the kernel
does not take. Operand types are those of :data:`GLUE_DTYPES`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .cuda import ADD_RMS_NORM, GLU_ACT, ROPE_QK, launch

__all__ = ["GLUE_DTYPES", "rms_norm", "apply_rope",
           "activation", "add_rms_norm", "add_rms_norm_plain", "rope_qk",
           "rope_qk_plain", "glu_act", "glu_act_plain"]

# the types the kernels read and write, by their kind code
GLUE_DTYPES = (torch.float32, torch.bfloat16)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32 (HF Llama numerics); returns fp32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)) * w.float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """``x [B, T, H, D]`` with cos/sin ``[B, T, D]`` (HF ``rotate_half``)."""
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return x * c + rot * s


def activation(g: torch.Tensor, name: str) -> torch.Tensor:
    """The gated MLP's activation: tanh-gelu for ``"gelu_tanh"`` (Gemma's
    GeGLU), silu for any other name (SwiGLU)."""
    if name == "gelu_tanh":
        return torch.nn.functional.gelu(g, approximate="tanh")
    return torch.nn.functional.silu(g)


def _kind(t: torch.dtype, what: str, name: str) -> int:
    if t not in GLUE_DTYPES:
        raise ValueError(f"{name}: {what} must be one of {GLUE_DTYPES}, "
                         f"got {t}")
    return GLUE_DTYPES.index(t)


def _same_device(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")


def _rows(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` as ``[N, width]`` rows of unit column stride (a view where
    its strides allow one)."""
    t2 = t.reshape(-1, width)
    return t2 if t2.stride(1) == 1 or t2.shape[0] == 0 else t2.contiguous()


def add_rms_norm_plain(x: torch.Tensor, delta: Optional[torch.Tensor],
                       w: torch.Tensor, eps: float, plus_one: bool = False,
                       out_dtype: torch.dtype = torch.float32
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`add_rms_norm`."""
    if delta is not None:
        x = x + delta.to(x.dtype)
    wf = w.float()
    if plus_one:
        wf = wf + 1.0
    return x, rms_norm(x, wf, eps).to(out_dtype)


def add_rms_norm(x: torch.Tensor, delta: Optional[torch.Tensor],
                 w: torch.Tensor, eps: float, plus_one: bool = False,
                 out_dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11: ``(res, y)``, the residual ``res = x + delta.to(x.dtype)``
    (``x`` itself without a delta) and its RMSNorm ``y`` with the gain
    ``w [H]`` (``1 + w`` with ``plus_one``) in ``out_dtype``. ``x`` and
    ``delta`` ``[..., H]`` of one shape, each of :data:`GLUE_DTYPES`;
    rows may lie any stride apart."""
    name = "add_rms_norm"
    if x.dim() < 1:
        raise ValueError(f"{name}: x must be [..., H], got a scalar")
    H = x.shape[-1]
    kx = _kind(x.dtype, "x", name)
    kd = 0
    if delta is not None:
        kd = 1 + _kind(delta.dtype, "delta", name)
        if delta.shape != x.shape:
            raise ValueError(f"{name}: delta {tuple(delta.shape)} is not x's "
                             f"{tuple(x.shape)}")
        _same_device(name, x, delta)
    kw = _kind(w.dtype, "w", name)
    ky = _kind(out_dtype, "out_dtype", name)
    if tuple(w.shape) != (H,):
        raise ValueError(f"{name}: w must be [{H}] for x "
                         f"{tuple(x.shape)}, got {tuple(w.shape)}")
    _same_device(name, x, w)
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, delta, w, eps, plus_one, out_dtype)
    x2 = _rows(x, H)
    N = x2.shape[0]
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    res = x if delta is None else torch.empty(x.shape, dtype=x.dtype,
                                              device=x.device)
    if N == 0 or H == 0:
        return res, y
    d2 = None if delta is None else _rows(delta, H)
    launch(ADD_RMS_NORM, "qt_add_rms_norm", x.device, x2.data_ptr(), kx,
           x2.stride(0), None if d2 is None else d2.data_ptr(), kd,
           0 if d2 is None else d2.stride(0), w.contiguous().data_ptr(), kw,
           int(bool(plus_one)), None if delta is None else res.data_ptr(),
           y.data_ptr(), ky, N, H, float(eps), 1.0 / H)
    return res, y


def rope_qk_plain(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`rope_qk`."""
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def rope_qk(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12: :func:`apply_rope` of ``q [B, T, n_q, D]`` and ``k [B, T,
    n_kv, D]`` with the tables ``cos``/``sin [B, T, D]`` in one launch,
    all fp32; returns contiguous ``(q, k)``. ``q`` and ``k`` may be views
    of the fused q|k|v slab (each row's heads ``D`` apart, rows any
    stride apart)."""
    name = "rope_qk"
    for nm, t in (("q", q), ("k", k), ("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {nm} must be fp32, got {t.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q and k must be [B, T, heads, D], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, T, n_q, D = q.shape
    if k.shape[:2] != q.shape[:2] or k.shape[3] != D or D % 2:
        raise ValueError(f"{name}: k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}, or D is odd")
    if tuple(cos.shape) != (B, T, D) or tuple(sin.shape) != (B, T, D):
        raise ValueError(f"{name}: cos and sin must be [{B}, {T}, {D}], "
                         f"got {tuple(cos.shape)} and {tuple(sin.shape)}")
    _same_device(name, q, k, cos, sin)
    if q.device.type == "cpu":
        return rope_qk_plain(q, k, cos, sin)
    n_kv = k.shape[2]
    q_out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    k_out = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    N = B * T
    if N == 0 or D == 0 or n_q + n_kv == 0:
        return q_out, k_out
    q2, k2 = _rows(q, n_q * D), _rows(k, n_kv * D)
    c2, s2 = cos.reshape(N, D).contiguous(), sin.reshape(N, D).contiguous()
    launch(ROPE_QK, "qt_rope_qk", q.device, q2.data_ptr(), q2.stride(0),
           k2.data_ptr(), k2.stride(0), c2.data_ptr(), s2.data_ptr(),
           q_out.data_ptr(), k_out.data_ptr(), N, n_q, n_kv, D)
    return q_out, k_out


def glu_act_plain(g: torch.Tensor, u: torch.Tensor, act: str,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of :func:`glu_act`."""
    return (activation(g, act) * u).to(out_dtype)


def glu_act(g: torch.Tensor, u: torch.Tensor, act: str,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K13: ``(activation(g, act) * u).to(out_dtype)`` for fp32 ``g``,
    ``u [N, I]`` (views of the gate|up slab: rows any stride apart)."""
    name = "glu_act"
    if g.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"{name}: g and u must be fp32, got {g.dtype} and "
                         f"{u.dtype}")
    if g.dim() != 2 or g.shape != u.shape:
        raise ValueError(f"{name}: g and u must be one [N, I], got "
                         f"{tuple(g.shape)} and {tuple(u.shape)}")
    ko = _kind(out_dtype, "out_dtype", name)
    _same_device(name, g, u)
    if g.device.type == "cpu":
        return glu_act_plain(g, u, act, out_dtype)
    N, I = g.shape
    out = torch.empty((N, I), dtype=out_dtype, device=g.device)
    if out.numel() == 0:
        return out
    g2, u2 = _rows(g, I), _rows(u, I)
    launch(GLU_ACT, "qt_glu_act", g.device, g2.data_ptr(), g2.stride(0),
           u2.data_ptr(), u2.stride(0), out.data_ptr(), ko, N, I,
           int(act == "gelu_tanh"))
    return out
