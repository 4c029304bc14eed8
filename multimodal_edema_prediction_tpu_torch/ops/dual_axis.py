"""One DuETT dual-axis encoder block, fused (K3).

``fused_encoder_block`` is the counterpart of
``multimodal_edema_prediction_tpu/ops/pallas_dual_axis.py::
fused_encoder_block``: the ``TransformerEncoder(n_layers=1)`` block that
DuETT runs on each axis,

    z = x + Wo·MHA(ScaleNorm1(x)) + bo
    y = ScaleNorm_f(z + W2·gelu_tanh(W1·ScaleNorm2(z) + b1) + b2),

on x [B, L, D] with the JAX parameter dict (flax ``[in, out]`` layouts):
``g1``, ``g2``, ``gf`` [1]; ``wq``, ``wk``, ``wv`` [D, H·dh]; ``wo``
[H·dh, D]; ``bo`` [D]; ``w1`` [D, F]; ``b1`` [F]; ``w2`` [F, D]; ``b2``
[D]. The arithmetic is the TPU kernel's: weights and biases cast to x's
dtype, then everything upcast to float32 (the gains stay float32); every
sum, the softmax and the GELU (its tanh form, ``jax.nn.gelu``'s default)
in float32; the output cast to x's dtype. At float32 this is the JAX
``encoder_block_reference`` exactly.

On a CUDA tensor the wrapper launches one of three hand-written kernels and
raises if it cannot; ``route`` picks it from the dtype and the shape alone,
before the launch:

- ``"tc"``: bfloat16 with D % 8 == 0, F % 128 == 0 and L <= 64 (every DuETT
  axis) takes ``csrc/dual_axis_block_tc.cu`` (bf16 mma.sync);
- ``"tf32"``: float32 with D % 4 == 0, F % 128 == 0, L <= 64 and its layout
  within one block's shared memory (both DuETT axes) takes
  ``csrc/dual_axis_block_tf32.cu`` (3xTF32 mma.sync m16n8k8);
- ``"simt"``: every other shape, in either dtype, takes the SIMT kernel of
  ``csrc/dual_axis_block.cu`` (one thread block per batch element).

The two tensor-core kernels share one design: a grid of batch elements ×
128-unit slices of the FF, each slice's partial product written to a
float32 workspace and summed in a fixed order by the element's last block
to arrive. No kernel gives way to another or to the plain version. On a
CPU tensor the wrapper runs ``encoder_block_reference``, the plain version,
which is also the kernels' oracle in the tests and in ``chip_smoke.py``.
The bf16 kernel rounds h, h2, the attention output and the FF hidden to
bfloat16 as product operands, within the bf16 tolerance (2e-2 of the
output's max abs); the float32 one splits each product operand into its
TF32 big and small parts and sums three products per product, within the
float32 tolerance (1e-4). The gradient is an autograd Function whose
backward recomputes through ``encoder_block_reference``, as JAX's custom
VJP does (``pallas_dual_axis.py:197-209``): neither package has a backward
kernel.
No model calls this op, in either package: it is an opt-in op.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

# launches of each kernel, by its C entry point; chip_smoke.py resets and
# reads them
LAUNCHES = {"dual_axis_block_tc": 0, "dual_axis_block_tf32": 0,
            "dual_axis_block": 0}
# the entry point each route (``route``) launches
ROUTE_KERNELS = {"tc": "dual_axis_block_tc", "tf32": "dual_axis_block_tf32",
                 "simt": "dual_axis_block"}

GAINS = ("g1", "g2", "gf")
WEIGHTS = ("wq", "wk", "wv", "wo", "bo", "w1", "b1", "w2", "b2")
PARAM_KEYS = GAINS + WEIGHTS

# shared memory one thread block may take on an H100 (227 KB)
SMEM_LIMIT = 232448
_FF_CHUNK = 128            # csrc/dual_axis_block.cu kFFChunk
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/dual_axis_block_tc.cu: FF hidden units per block (kSlice), rows
# (kMaxMT m16 tiles) and the W ring (kStages x kKC x (kNC + 8) bf16)
TC_SLICE = 128
TC_MAX_L = 64
_TC_RING_BYTES = 2 * 2 * 64 * (128 + 8)
# csrc/dual_axis_block_tf32.cu: the columns of a W tile (kNC) and its W
# ring (kStages x kKC x (kNC + 8) float32)
_TF32_NC = 128
_TF32_RING_BYTES = 4 * 3 * 32 * (_TF32_NC + 8)

_P, _I, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# each C entry point: its library and its ctypes signature
ENTRY_POINTS = {
    # dtype, x, wqkv, wo, bo, w1, b1, w2, b2, g, out, B, L, D, H, dh, F,
    # D^-1/2, dh^-1/2, stream
    "dual_axis_block": ("dual_axis_block",
                        [_I] + [_P] * 10 + [_I] * 6 + [_F32] * 2 + [_P]),
    # x, wqkv, its columns, wo, bo, w1, b1, w2, b2, g, out, the workspace,
    # the counters, B, L, D, H, dh, F, D^-1/2, dh^-1/2, stream
    "dual_axis_block_tc": ("dual_axis_block_tc",
                           [_P, _P, _I] + [_P] * 10 + [_I] * 6
                           + [_F32] * 2 + [_P]),
    # the same arguments in float32
    "dual_axis_block_tf32": ("dual_axis_block_tf32",
                             [_P, _P, _I] + [_P] * 10 + [_I] * 6
                             + [_F32] * 2 + [_P]),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _scalenorm(t: torch.Tensor, g: torch.Tensor, d: int) -> torch.Tensor:
    """float32 ``t / max(||t|| · d^-0.5, 1e-5) · g`` over the last axis."""
    n = torch.sqrt((t * t).sum(-1, keepdim=True)) * (d ** -0.5)
    return t / n.clamp_min(1e-5) * g


def encoder_block_reference(x: torch.Tensor, params: Dict[str, torch.Tensor],
                            n_heads: int, d_head: int) -> torch.Tensor:
    """The plain version: [B, L, D] → [B, L, D] in the kernel's arithmetic
    (module docstring), differentiable."""
    dt = x.dtype
    B, L, D = x.shape
    g1, g2, gf = (params[k].reshape(()).float() for k in GAINS)
    w = {k: params[k].to(dt).float() for k in WEIGHTS}
    xf = x.float()
    h = _scalenorm(xf, g1, D)

    def heads(a):
        return a.reshape(B, L, n_heads, d_head)

    q, k, v = heads(h @ w["wq"]), heads(h @ w["wk"]), heads(h @ w["wv"])
    logits = torch.einsum("blhd,bmhd->bhlm", q, k) * (d_head ** -0.5)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhlm,bmhd->blhd", p, v).reshape(B, L, n_heads * d_head)
    z = xf + o @ w["wo"] + w["bo"]
    f = F.gelu(_scalenorm(z, g2, D) @ w["w1"] + w["b1"], approximate="tanh")
    z = z + f @ w["w2"] + w["b2"]
    return _scalenorm(z, gf, D).to(dt)


def params_from_encoder(encoder) -> Dict[str, torch.Tensor]:
    """K3's parameter dict from a one-layer ``models/layers.
    TransformerEncoder`` (a DuETT axis): the gains of ``layer_0.norm_attn``,
    ``layer_0.norm_ff`` and ``final_norm``, and each ``Dense`` weight
    transposed to the flax ``[in, out]`` layout. At bfloat16 the block then
    computes what the encoder does (both take GELU's tanh form there)."""
    if encoder.n_layers != 1:
        raise ValueError(f"K3 fuses one layer, the encoder has "
                         f"{encoder.n_layers}")
    layer = encoder.layer_0
    attn = layer.attn
    return {"g1": layer.norm_attn.g, "g2": layer.norm_ff.g,
            "gf": encoder.final_norm.g,
            "wq": attn.q.weight.t(), "wk": attn.k.weight.t(),
            "wv": attn.v.weight.t(), "wo": attn.out.weight.t(),
            "bo": attn.out.bias, "w1": layer.ff_in.weight.t(),
            "b1": layer.ff_in.bias, "w2": layer.ff_out.weight.t(),
            "b2": layer.ff_out.bias}


def smem_bytes(L: int, D: int, n_heads: int, d_head: int) -> int:
    """Shared memory the SIMT kernel asks for (``smem_floats`` in
    ``csrc/dual_axis_block.cu``)."""
    def r4(n):
        return (n + 3) // 4 * 4
    inner = n_heads * d_head
    attn = L * r4(3 * inner) + L * r4(inner) + n_heads * L * L
    return 4 * (2 * L * r4(D) + max(attn, L * _FF_CHUNK))


def tc_smem_bytes(L: int, D: int, n_heads: int, d_head: int) -> int:
    """Shared memory the tensor-core kernel asks for (``make_layout`` in
    ``csrc/dual_axis_block_tc.cu``): z float32 [L, D]; h bf16 [Mp, a(D)]
    (Mp = L rounded up to 16, a(K) = K rounded up to 16, plus 8); then
    either q|k|v float32 [L, 3I + 1], P [H, L, L] and o bf16 [Mp, a(I)],
    or f bf16 [Mp, a(128)], whichever is larger; the W ring; bo, b2 and a
    slice of b1 in float32."""
    def a16(n):
        return (n + 15) // 16 * 16

    def ld(k):
        return a16(k) + 8
    inner = n_heads * d_head
    mp = a16(L)
    work = a16(4 * L * D) + a16(2 * mp * ld(D))
    attn = a16(4 * L * (3 * inner + 1)) + a16(4 * n_heads * L * L) \
        + a16(2 * mp * ld(inner))
    return work + max(attn, a16(2 * mp * ld(TC_SLICE))) + _TC_RING_BYTES \
        + a16(4 * (2 * D + TC_SLICE))


def tf32_smem_bytes(L: int, D: int, n_heads: int, d_head: int) -> int:
    """Shared memory the float32 tensor-core kernel asks for (``make_layout``
    in ``csrc/dual_axis_block_tf32.cu``): a region holding, in turn, h's two
    TF32 parts float32 [L, a(D)] each (a(K) = K rounded up to 8, plus 4),
    or z over the first with q|k|v float32 [L, 3I + 1], P
    [H, L, L] and o's two parts [L, a(I)] over the second (after both
    when 3I rounded up to 4 is over the ring's 128 columns: the QKV
    product's epilogue would write over its own operand), or f's two parts
    [L, a(128)], whichever is largest; the W ring; bo, b2 and a slice of b1
    in float32."""
    def a16(n):
        return (n + 15) // 16 * 16

    def ld(k):
        return -(-k // 8) * 8 + 4
    inner = n_heads * d_head
    h = a16(4 * L * ld(D))
    q = h if -(-3 * inner // 4) * 4 <= _TF32_NC else 2 * h
    attn = a16(a16(a16(q + 4 * L * (3 * inner + 1)) + 4 * n_heads * L * L)
               + 4 * L * ld(inner)) + a16(4 * L * ld(inner))
    ff = 2 * a16(4 * L * ld(TC_SLICE))
    return max(2 * h, attn, ff) + _TF32_RING_BYTES + a16(4 * (2 * D + TC_SLICE))


def route(dtype: torch.dtype, L: int, D: int, F_: int, n_heads: int,
          d_head: int) -> str:
    """The kernel a CUDA call takes, from the dtype and the shape alone:
    ``"tc"`` (the bf16 tensor-core kernel) for bfloat16 with D % 8 == 0,
    F % 128 == 0, L <= 64 and its shared memory within one block's;
    ``"tf32"`` (the float32 tensor-core kernel) for float32 with D % 4 == 0
    and the rest alike; else ``"simt"``."""
    if F_ % TC_SLICE == 0 and 1 <= L <= TC_MAX_L:
        if dtype == torch.bfloat16 and D % 8 == 0 and \
                tc_smem_bytes(L, D, n_heads, d_head) <= SMEM_LIMIT:
            return "tc"
        if dtype == torch.float32 and D % 4 == 0 and \
                tf32_smem_bytes(L, D, n_heads, d_head) <= SMEM_LIMIT:
            return "tf32"
    return "simt"


def workspace_bytes(B: int, L: int, D: int, F_: int, way: str) -> int:
    """A tensor-core route's float32 scratch: one [B, L, D] partial of the
    FF per 128 hidden units, and on the ``"tf32"`` route one more slot for
    z."""
    return 4 * (F_ // TC_SLICE + (way == "tf32")) * B * L * D


def _check(x: torch.Tensor, params: Dict[str, torch.Tensor], n_heads: int,
           d_head: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be [B, L, D], got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_encoder_block: no kernel for device "
                         f"{x.device}")
    missing = [k for k in PARAM_KEYS if k not in params]
    if missing:
        raise ValueError(f"fused_encoder_block: missing params {missing}")
    _, _, D = x.shape
    inner = n_heads * d_head
    Fh = params["w1"].shape[-1]
    want = {"wq": (D, inner), "wk": (D, inner), "wv": (D, inner),
            "wo": (inner, D), "bo": (D,), "w1": (D, Fh), "b1": (Fh,),
            "w2": (Fh, D), "b2": (D,), "g1": (1,), "g2": (1,), "gf": (1,)}
    bad = {k: tuple(params[k].shape) for k, s in want.items()
           if tuple(params[k].shape) != s}
    if bad:
        raise ValueError(f"fused_encoder_block: params of the wrong shape "
                         f"{bad} for x {tuple(x.shape)}, {n_heads} heads x "
                         f"{d_head}")


_FNS: dict = {}
# per (device, stream): the tensor-core routes' arrival counters, one per
# batch element, zero between launches (each kernel's last block of each
# element resets its own)
_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _call(name: str, *args) -> None:
    fn = _FNS.get(name)
    if fn is None:
        from .build import load
        lib, argtypes = ENTRY_POINTS[name]
        fn = getattr(load(lib), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FNS[name] = fn
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte-aligned base (the tensor-core
    kernels' vector loads and cp.async copies need it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _counters(dev: torch.device, stream: int, B: int) -> torch.Tensor:
    key = (dev.index, stream)
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < B:
        cnt = torch.zeros(max(B, 64), dtype=torch.int32, device=dev)
        _COUNTERS[key] = cnt
    return cnt


def _tc_weights(params: Dict[str, torch.Tensor], D: int, inner: int,
                dev: torch.device, dtype: torch.dtype) -> tuple:
    """A tensor-core kernel's weights, cast to ``dtype`` in one buffer: wq |
    wk | wv as [D, nq] (nq = 3·inner rounded up to a 16-byte granule, zero
    columns after), then wo, bo, w1, b1, w2, b2. With D and F multiples of
    a granule (8 bf16, 4 float32) every part starts on a 16-byte boundary.
    Returns (wqkv, nq, the other six as views)."""
    qkv = [params[k].detach() for k in ("wq", "wk", "wv")]
    granule = 16 // torch.empty((), dtype=dtype).element_size()
    nq = -(-3 * inner // granule) * granule
    if nq != 3 * inner:
        qkv.append(qkv[0].new_zeros(D, nq - 3 * inner))
    parts = [torch.cat(qkv, dim=1)] + [
        params[k].detach() for k in ("wo", "bo", "w1", "b1", "w2", "b2")]
    flat = torch.cat([t.reshape(-1) for t in parts]).to(device=dev,
                                                       dtype=dtype)
    views = flat.split([t.numel() for t in parts])
    return views[0], nq, views[1:]


def block_kernel(x: torch.Tensor, params: Dict[str, torch.Tensor],
                 n_heads: int, d_head: int) -> torch.Tensor:
    """K3 on a CUDA tensor: one launch of the kernel ``route`` picks, no
    gradient."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_encoder_block kernel takes float32 or "
                         f"bfloat16, got {x.dtype}")
    B, L, D = x.shape
    Fh = params["w1"].shape[-1]
    way = route(x.dtype, L, D, Fh, n_heads, d_head)
    if way == "simt" and smem_bytes(L, D, n_heads, d_head) > SMEM_LIMIT:
        raise ValueError(f"fused_encoder_block kernel: [{L}, {D}] needs "
                         f"{smem_bytes(L, D, n_heads, d_head)} bytes of "
                         f"shared memory, over {SMEM_LIMIT}")
    dt, dev = x.dtype, x.device
    g = torch.cat([params[k].detach().reshape(1) for k in GAINS]).to(
        device=dev, dtype=torch.float32)
    # contiguous whatever x's strides: every kernel writes [B, L, D] densely
    out = torch.empty(B, L, D, dtype=dt, device=dev)
    scales = (D ** -0.5, d_head ** -0.5)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if way != "simt":
            x = _aligned(x)
            wqkv, nq, rest = _tc_weights(params, D, n_heads * d_head, dev,
                                         dt)
            ws = torch.empty(workspace_bytes(B, L, D, Fh, way) // 4,
                             dtype=torch.float32, device=dev)
            _call(ROUTE_KERNELS[way], x.data_ptr(), wqkv.data_ptr(), nq,
                  *(t.data_ptr() for t in rest), g.data_ptr(),
                  out.data_ptr(), ws.data_ptr(),
                  _counters(dev, stream, B).data_ptr(), B, L, D, n_heads,
                  d_head, Fh, *scales, stream)
        else:
            x = x.contiguous()
            w = {k: params[k].detach().to(device=dev, dtype=dt).contiguous()
                 for k in WEIGHTS}
            wqkv = torch.cat([w["wq"], w["wk"], w["wv"]], dim=1)
            _call("dual_axis_block", _DTYPES[dt], x.data_ptr(),
                  wqkv.data_ptr(),
                  *(w[k].data_ptr() for k in ("wo", "bo", "w1", "b1", "w2",
                                              "b2")),
                  g.data_ptr(), out.data_ptr(), B, L, D, n_heads, d_head,
                  Fh, *scales, stream)
    LAUNCHES[ROUTE_KERNELS[way]] += 1
    return out


class _FusedBlock(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version) forward; the backward
    recomputes ``encoder_block_reference`` under autograd."""

    @staticmethod
    def forward(ctx, x, n_heads, d_head, *tensors):
        params = dict(zip(PARAM_KEYS, tensors))
        ctx.save_for_backward(x, *tensors)
        ctx.heads = (n_heads, d_head)
        if x.device.type == "cpu":
            return encoder_block_reference(x, params, n_heads, d_head)
        return block_kernel(x, params, n_heads, d_head)

    @staticmethod
    def backward(ctx, gout):
        x, *tensors = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (x, *tensors)]
        with torch.enable_grad():
            y = encoder_block_reference(
                leaves[0], dict(zip(PARAM_KEYS, leaves[1:])), *ctx.heads)
            grads = torch.autograd.grad(y, leaves, gout, allow_unused=True)
        return (grads[0], None, None, *grads[1:])


def fused_encoder_block(x: torch.Tensor, params: Dict[str, torch.Tensor],
                        n_heads: int, d_head: int) -> torch.Tensor:
    """[B, L, D] → [B, L, D]: K3 on a CUDA tensor, the plain version on a
    CPU tensor; differentiable in x and every parameter."""
    _check(x, params, n_heads, d_head)
    tensors = [params[k] for k in PARAM_KEYS]
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, *tensors)):
        return _FusedBlock.apply(x, n_heads, d_head, *tensors)
    if x.device.type == "cpu":
        return encoder_block_reference(x, params, n_heads, d_head)
    return block_kernel(x, params, n_heads, d_head)
