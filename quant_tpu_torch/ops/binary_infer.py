"""Packed binary-conv inference (port of quant_tpu/ops/binary_infer.py,
ls-1 activations x ls-1 weights).

The serving conv is two kernels: the producer `pack_threshold_signs`
turns the raw block input into packed sign words, and `xnor_conv2d`
contracts them against the packed weights with the scale epilogue of the
JAX int8 branch (binary_infer.py:312-323):

    y   = float(dot) * (vx[n] * vw[o])      float32, scale product first
    out = y.to(out_dtype) + bias.to(out_dtype)

For CPU tensors both wrappers run their plain twins, which together are
the JAX int8 branch (unpacked +-1 planes, an exact integer conv). For
CUDA tensors they launch csrc/xnor.cu or raise. Other schemes (ls-2,
ls-T, gf-k) and the bf16 sign-compute route are queued for Slice B.
"""

import ctypes
from typing import Any, Callable, Optional

import torch

from quant_tpu_torch import _build
from quant_tpu_torch.ops.conv import IntOr2, _pair, conv2d
from quant_tpu_torch.ops.packing import packed_width, pack_signs, unpack_signs
from quant_tpu_torch.ops.ste import binary_sign

_SLICE_B = ('only ls-1 activations x ls-1 weights through the int8 '
            'sign-compute route are ported; {} is queued for Slice B.')

_CONV_SIG = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
_PACK_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {'qtt_xnor_conv2d_f32': _CONV_SIG,
               'qtt_xnor_conv2d_bf16': _CONV_SIG,
               'qtt_pack_threshold_signs_f32': _PACK_SIG,
               'qtt_pack_threshold_signs_bf16': _PACK_SIG}
_DTYPE_SUFFIX = {torch.float32: 'f32', torch.bfloat16: 'bf16'}

conv_launches = _build.LaunchCounter('xnor_conv2d')
pack_launches = _build.LaunchCounter('pack_threshold_signs')


def _require_ls1(scheme: str) -> None:
    if scheme != 'ls-1':
        raise NotImplementedError(_SLICE_B.format(f'scheme {scheme!r}'))


def weight_sign_planes(w_oi: torch.Tensor, scheme: str,
                       vs: Optional[torch.Tensor]) -> list[torch.Tensor]:
    """Binary sign planes of a weight tensor with O leading (ls-1: one)."""
    del vs  # ls-1's single plane needs no scale
    _require_ls1(scheme)
    return [binary_sign(w_oi)]


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """Pack an HWIO weight's signs along I: (kh,kw,I,O) -> (kh,kw,Wd,O)."""
    packed = pack_signs(torch.movedim(w, 2, -1))       # (kh, kw, O, Wd)
    return torch.movedim(packed, -1, 2).contiguous()   # (kh, kw, Wd, O)


def unpack_weights_int8(packed: torch.Tensor, in_channels: int,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Unpack packed HWIO sign words to a {-1,+1} HWIO tensor."""
    signs = unpack_signs(torch.movedim(packed, 2, -1), in_channels,
                         dtype=dtype)
    return torch.movedim(signs, -1, 2)


def activation_sign_planes(x: torch.Tensor, scheme: str, vs: torch.Tensor,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> tuple[list, list]:
    """([sign plane NHWC in dtype], [v (N,)]) of an ls-1 activation."""
    _require_ls1(scheme)
    return [binary_sign(x).to(dtype)], [vs[0]]


def _threshold_plane(x: torch.Tensor, thresh: torch.Tensor,
                     flip: torch.Tensor) -> torch.Tensor:
    # t is rounded to x's dtype before the subtraction (binary_infer.py:180):
    # in a bf16 chain the compare is against bf16(t).
    u = x - thresh.to(x.dtype)
    return flip.to(x.dtype) * binary_sign(u)


def threshold_sign_planes(x: torch.Tensor, scheme: str, vs: torch.Tensor,
                          thresh: torch.Tensor, flip: torch.Tensor,
                          va: Optional[torch.Tensor],
                          dtype: torch.dtype = torch.bfloat16
                          ) -> tuple[list, list]:
    """Sign planes of quantize(clamp(BN(x))) from the RAW pre-BN x via
    per-channel thresholds: plane = flip * sign(x - t). `va` is only
    read by multi-plane schemes (Slice B)."""
    del va
    _require_ls1(scheme)
    return [_threshold_plane(x, thresh, flip).to(dtype)], [vs[0]]


def pack_threshold_signs_plain(x: torch.Tensor, thresh: torch.Tensor,
                               flip: torch.Tensor) -> torch.Tensor:
    """Plain twin of the producer: pack_signs(threshold_sign_planes)."""
    return pack_signs(_threshold_plane(x, thresh, flip))


def pack_threshold_signs(x: torch.Tensor, thresh: torch.Tensor,
                         flip: torch.Tensor) -> torch.Tensor:
    """Producer: (N,H,W,C) raw input -> (N,H,W,ceil(C/32)) int32 words,
    bit = (x - t >= 0) XOR (flip < 0). t = 0, flip = +1 packs sign(x)."""
    _build.require(x.ndim == 4, f'expected NHWC, got shape {x.shape}')
    c = x.shape[-1]
    _build.require(thresh.shape == (c,) and flip.shape == (c,),
                   f'thresh and flip must be ({c},)')
    if _build.on_cpu(x, thresh, flip):
        return pack_threshold_signs_plain(x, thresh, flip)
    _build.require(x.dtype in _DTYPE_SUFFIX, f'unsupported dtype {x.dtype}')
    _build.require(x.is_contiguous(), 'x must be contiguous')
    thresh = thresh.to(torch.float32).contiguous()
    flip = flip.to(torch.float32).contiguous()
    wc = packed_width(c)
    out = torch.empty(x.shape[:-1] + (wc,), dtype=torch.int32,
                      device=x.device)
    lib = _build.load('xnor', _SIGNATURES)
    entry = getattr(lib, f'qtt_pack_threshold_signs_{_DTYPE_SUFFIX[x.dtype]}')
    status = entry(_build.ptr(x), _build.ptr(thresh), _build.ptr(flip),
                   _build.ptr(out), x.numel() // c, c, wc, _build.stream(x))
    _build.check(lib, status, 'pack_threshold_signs')
    pack_launches.bump()
    return out


def _epilogue(dot: torch.Tensor, vx: torch.Tensor, vw: torch.Tensor,
              bias: Optional[torch.Tensor], out_dtype: torch.dtype
              ) -> torch.Tensor:
    scale = (vx.to(torch.float32).reshape(-1, 1, 1, 1)
             * vw.to(torch.float32).reshape(1, 1, 1, -1))
    acc = (dot * scale).to(out_dtype)
    if bias is not None:
        acc = acc + bias.to(out_dtype)
    return acc


def xnor_conv2d_plain(x_words: torch.Tensor, w_packed: torch.Tensor,
                      vx: torch.Tensor, vw: torch.Tensor,
                      bias: Optional[torch.Tensor], *, in_channels: int,
                      stride: IntOr2 = 1, padding: IntOr2 = 1,
                      out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """Plain twin of xnor_conv2d: F.conv2d over unpacked +-1 planes in
    float32, zero padding, rounded to the integer dot, then the kernel's
    epilogue. cuDNN may pick a transform algorithm (Winograd) whose
    float32 result lies a little off the integer (seen on an H100 at
    28x28 with C = 128), so the dot is rounded, not truncated."""
    xs = unpack_signs(x_words, in_channels)
    ws = unpack_weights_int8(w_packed, in_channels, dtype=torch.float32)
    dot = conv2d(xs, ws, stride=stride, padding=padding).round().to(
        torch.int32)
    return _epilogue(dot, vx, vw, bias, out_dtype)


def xnor_conv2d(x_words: torch.Tensor, w_packed: torch.Tensor,
                vx: torch.Tensor, vw: torch.Tensor,
                bias: Optional[torch.Tensor], *, in_channels: int,
                stride: IntOr2 = 1, padding: IntOr2 = 1,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Binary conv over packed words, NHWC out.

    Args:
        x_words: (N, H, W, ceil(C/32)) int32 packed activation signs.
        w_packed: (kh, kw, ceil(C/32), O) int32 packed weight signs.
        vx: (N,) per-sample scales; vw: (O,) per-out-channel scales.
        bias: optional (O,) bias, added in out_dtype after rounding.
        in_channels: C. Taps outside the image contribute nothing (the
            +-1 operand is zero-padded).
    """
    _build.require(x_words.ndim == 4 and w_packed.ndim == 4,
                   'x_words must be (N,H,W,Wc) and w_packed (kh,kw,Wc,O)')
    n, h, wd, wc = x_words.shape
    kh, kw, wc2, o = w_packed.shape
    _build.require(wc == wc2 == packed_width(in_channels),
                   f'word axes {wc}, {wc2} do not hold {in_channels} '
                   'channels')
    _build.require(x_words.dtype == torch.int32
                   and w_packed.dtype == torch.int32, 'words must be int32')
    _build.require(vx.shape == (n,) and vw.shape == (o,)
                   and (bias is None or bias.shape == (o,)),
                   'vx must be (N,), vw and bias (O,)')
    _build.require(out_dtype in _DTYPE_SUFFIX,
                   f'unsupported out dtype {out_dtype}')
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    _build.require(sh == sw and ph == pw and sh > 0 and ph >= 0,
                   'stride and padding must be equal in H and W')
    tensors = (x_words, w_packed, vx, vw) + (() if bias is None else (bias,))
    if _build.on_cpu(*tensors):
        return xnor_conv2d_plain(x_words, w_packed, vx, vw, bias,
                                 in_channels=in_channels, stride=stride,
                                 padding=padding, out_dtype=out_dtype)
    _build.require(x_words.is_contiguous() and w_packed.is_contiguous(),
                   'packed operands must be contiguous')
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (wd + 2 * pw - kw) // sw + 1
    vx = vx.to(torch.float32).contiguous()
    vw = vw.to(torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(out_dtype).contiguous()
    out = torch.empty((n, oh, ow, o), dtype=out_dtype, device=x_words.device)
    lib = _build.load('xnor', _SIGNATURES)
    entry = getattr(lib, f'qtt_xnor_conv2d_{_DTYPE_SUFFIX[out_dtype]}')
    status = entry(_build.ptr(x_words), _build.ptr(w_packed),
                   _build.ptr(vx), _build.ptr(vw), _build.ptr(bias),
                   _build.ptr(out), n, h, wd, wc, in_channels, o, oh, ow,
                   kh, kw, sh, ph, _build.stream(x_words))
    _build.check(lib, status, 'xnor_conv2d')
    conv_launches.bump()
    return out


def quant_conv2d_infer(x: torch.Tensor, *,
                       x_scheme: str, x_vs: torch.Tensor,
                       w_packed: torch.Tensor, w_vs: torch.Tensor,
                       in_channels: int,
                       bias: Optional[torch.Tensor] = None,
                       stride: IntOr2 = 1, padding: IntOr2 = 0,
                       clamp_fn: Optional[Callable] = None,
                       out_dtype: torch.dtype = torch.float32,
                       compute_dtype: Any = 'int8',
                       x_thresh: Optional[torch.Tensor] = None,
                       x_flip: Optional[torch.Tensor] = None,
                       x_va: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed-weight quantized conv: producer + XNOR conv.

    Args:
        x: fp NHWC activations (pre-clamp), or the RAW pre-BN tensor when
            x_thresh/x_flip are given (then clamp_fn is ignored).
        x_scheme / x_vs: activation scheme and (1, N) scales.
        w_packed: (kh, kw, Wd, O) packed weight words, or (1, kh, kw,
            Wd, O) as the export stacks them.
        w_vs: (1, O) per-out-channel weight scales.
        compute_dtype: 'int8' (or torch.int8), the JAX int8 branch.
    """
    _require_ls1(x_scheme)
    if compute_dtype not in ('int8', torch.int8):
        raise NotImplementedError(
            _SLICE_B.format(f'compute_dtype {compute_dtype!r}'))
    if w_packed.ndim == 5:
        if w_packed.shape[0] != 1:
            raise NotImplementedError(_SLICE_B.format('k_w > 1 weights'))
        w_packed = w_packed[0]
    if w_vs.shape[0] != 1:
        raise NotImplementedError(_SLICE_B.format('k_w > 1 weight scales'))
    del x_va  # ls-1 has no residual plane
    if x_thresh is None:
        if clamp_fn is not None:
            x = clamp_fn(x)
        c = x.shape[-1]
        x_thresh = torch.zeros(c, dtype=torch.float32, device=x.device)
        x_flip = torch.ones(c, dtype=torch.float32, device=x.device)
    words = pack_threshold_signs(x.contiguous(), x_thresh, x_flip)
    return xnor_conv2d(words, w_packed.contiguous(), x_vs[0], w_vs[0], bias,
                       in_channels=in_channels, stride=stride,
                       padding=padding, out_dtype=out_dtype)
