"""Packed binary-conv inference (port of quant_tpu/ops/binary_infer.py).

A k_a-plane activation against a k_w-plane weight is
    y = sum_{j, i} (vx_i[n] * vw_j[o]) * conv(bx_i, bw_j)
with vx per sample and vw per out-channel. Two routes compute it, as in
JAX (`quant_conv2d_infer`):

* The int8 route (JAX's `compute_dtype=jnp.int8`, bit-exact) runs two
  kernels of csrc/xnor.cu. The producer turns the block input into packed
  sign words, one plane per activation bit; the conv contracts them
  against the packed weight planes. Its epilogue repeats JAX's pass loop
  (binary_infer.py:313-323), weight sets outer, activation planes inner:

      acc = sum_{j, i} (float(dot_ij) * (vx_i[n] * vw_j[o])).to(out_dtype)
      out = acc + bias.to(out_dtype)

  each term and each running sum rounded to out_dtype. Planes that share
  a scale (ls-T activations, whose JAX operand is b1 + b2 in {-2, 0, 2},
  and ls-T weights with `w_planes_share_scale`) are one group: their
  integer dots add before the epilogue, as one term. The producer
  `pack_sign_planes` serves every scheme (ls-1 is its k = 1); ls-1 x
  ls-1 contracts with the single-plane `xnor_conv2d`, every other
  scheme pair with its multi-plane form `xnor_conv2d_planes`.
* The bf16 route (JAX's default compute dtype, chosen by 'auto' where a
  side has two distinct scales) stays PyTorch ops, as JAX left it to XLA:
  the fused bake collapses the passes into one conv over scale-baked
  bf16 operands (`fused=True`), or runs them one by one. JAX's bf16 conv
  accumulates in float32 and keeps a float32 output; PyTorch's bf16
  conv on CUDA rounds its output to bf16, so this route convolves
  float32 copies of the bf16 operands instead. TF32 keeps 10 mantissa
  bits, so it takes those bf16 values (8 bits) exactly: the result is a
  float32 sum whether TF32 is on or off.

For CPU tensors every kernel wrapper runs its plain twin, which repeats
JAX's ops; for CUDA tensors it launches its kernel or raises.

The block's tail (`Tail`): a served residual block hands the pointwise
ops that follow a binary conv (a PReLU, the residual add with the
shortcut's eval BatchNorm, a PReLU) to the conv, which applies them to
each output value before it stores it, every op rounded where the eager
ops round. The plain twins take the same tail and apply it with those
eager ops (`apply_tail`).

Row bands (parallel/spatial.py): a rank of an H-banded model runs a conv
on its band of rows and the halo rows its neighbours sent it. The conv
then pads H by its own `pad_top` and `pad_bottom` (the symmetric pad by
default: the whole image), which are the image's padding where the band
touches the image's edge and 0 where a halo lies. The routes take a
`RowBand`: the int8 route extends the packed words by the halo rows (a
pixel's words depend on that pixel alone), the bf16 and fp-activation
routes extend their input x before the sign step; every conv's operand
is zero-padded, so the padding rows stay exact.
"""

import ctypes
from typing import Any, Callable, NamedTuple, Optional

import torch

from quant_tpu_torch import _build
from quant_tpu_torch.ops.conv import IntOr2, _pair, conv2d
from quant_tpu_torch.ops.packing import packed_width, pack_signs, unpack_signs
from quant_tpu_torch.ops.quantize import scheme_num_scales
from quant_tpu_torch.ops.ste import binary_sign

SIGN_COMPUTE_DTYPE = torch.bfloat16

_CONV_SIG = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
_PLANES_CONV_SIG = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 17
                    + [ctypes.c_void_p])
_PLANES_PACK_SIG = ([ctypes.c_void_p] * 5
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
_SIGNATURES = {'qtt_xnor_conv2d_f32': _CONV_SIG,
               'qtt_xnor_conv2d_bf16': _CONV_SIG,
               'qtt_xnor_conv2d_planes_f32': _PLANES_CONV_SIG,
               'qtt_xnor_conv2d_planes_bf16': _PLANES_CONV_SIG,
               'qtt_xnor_conv2d_occupancy': ([ctypes.c_int] * 6
                                             + [ctypes.c_void_p] * 2),
               'qtt_pack_sign_planes_f32': _PLANES_PACK_SIG,
               'qtt_pack_sign_planes_bf16': _PLANES_PACK_SIG}
_DTYPE_SUFFIX = {torch.float32: 'f32', torch.bfloat16: 'bf16'}

conv_launches = _build.LaunchCounter('xnor_conv2d')
planes_conv_launches = _build.LaunchCounter('xnor_conv2d_planes')
pack_launches = _build.LaunchCounter('pack_sign_planes')
# Launches of either conv that carry a tail: where the served blocks
# hand their tail over.
tail_launches = _build.LaunchCounter('xnor_conv2d_tail')


class RowBand(NamedTuple):
    """A conv's row band (module docstring): `extend(t)` returns t (H on
    dim -3) with the halo rows this rank received above and below it;
    the extended band is padded by pad_top and pad_bottom rows."""

    extend: Callable[[torch.Tensor], torch.Tensor]
    pad_top: int
    pad_bottom: int


def _row_pads(padding: IntOr2, pad_top: Optional[int],
              pad_bottom: Optional[int]) -> tuple[int, int]:
    """(pad_top, pad_bottom), each the symmetric H pad where not given."""
    ph = _pair(padding)[0]
    return (ph if pad_top is None else pad_top,
            ph if pad_bottom is None else pad_bottom)


def sign_planes(scheme: str) -> int:
    """Binary sign planes a scheme decomposes into (ls-T: two, which
    share one scale)."""
    if scheme in ('ls-2', 'ls-T'):
        return 2
    return scheme_num_scales(scheme)


def weight_sign_planes(w_oi: torch.Tensor, scheme: str,
                       vs: Optional[torch.Tensor]) -> list[torch.Tensor]:
    """Binary sign planes of a weight tensor with O leading, such that
    w_q = sum_j vs[j] * plane_j; vs is the (k_w, O) cached scale stack."""
    def per_row(v: torch.Tensor) -> torch.Tensor:
        return v.reshape((w_oi.shape[0],) + (1,) * (w_oi.ndim - 1))

    if scheme == 'ls-1':
        return [binary_sign(w_oi)]
    if scheme in ('ls-2', 'ls-T'):
        b1 = binary_sign(w_oi)
        return [b1, binary_sign(w_oi - per_row(vs[0]) * b1)]
    if scheme.startswith('gf-'):
        planes = []
        result = torch.zeros_like(w_oi)
        for j in range(scheme_num_scales(scheme)):
            b = binary_sign(w_oi - result)
            planes.append(b)
            result = result + per_row(vs[j]) * b
        return planes
    raise ValueError(f'No binary decomposition for scheme {scheme}')


def weight_scales_for_planes(scheme: str,
                             vs: torch.Tensor) -> torch.Tensor:
    """The scale stack matching weight_sign_planes' planes: ls-T repeats
    its one scale for both planes."""
    if scheme == 'ls-T':
        return torch.stack([vs[0], vs[0]])
    return vs


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """Pack an HWIO weight's signs along I: (kh,kw,I,O) -> (kh,kw,Wd,O)."""
    packed = pack_signs(torch.movedim(w, 2, -1))       # (kh, kw, O, Wd)
    return torch.movedim(packed, -1, 2).contiguous()   # (kh, kw, Wd, O)


def unpack_weights_int8(packed: torch.Tensor, in_channels: int,
                        dtype: torch.dtype = SIGN_COMPUTE_DTYPE
                        ) -> torch.Tensor:
    """Unpack packed HWIO sign words to a {-1,+1} HWIO tensor."""
    signs = unpack_signs(torch.movedim(packed, 2, -1), in_channels,
                         dtype=dtype)
    return torch.movedim(signs, -1, 2)


def binary_conv_int8(x_signs: torch.Tensor, w_signs: torch.Tensor, *,
                     stride: IntOr2 = 1, padding: IntOr2 = 0,
                     pad_top: Optional[int] = None,
                     pad_bottom: Optional[int] = None) -> torch.Tensor:
    """Sign-plane conv with exact accumulation: int8 operands give the
    int32 dot, bf16 (or float32) operands the float32 sum of their
    products, computed on float32 copies (see the module docstring). A
    float32 conv may run a transform algorithm (Winograd) that lands a
    little off the integer, so the int8 dot is rounded, not truncated.
    H is padded by pad_top and pad_bottom zero rows (default: padding)."""
    xf = x_signs.to(torch.float32)
    rows = _row_pads(padding, pad_top, pad_bottom)
    if rows != (_pair(padding)[0],) * 2:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0) + rows)
        padding = (0, _pair(padding)[1])
    y = conv2d(xf, w_signs.to(torch.float32), stride=stride,
               padding=padding)
    if x_signs.dtype == torch.int8:
        return y.round().to(torch.int32)
    return y


def _threshold_planes(x: torch.Tensor, thresh: torch.Tensor,
                      flip: torch.Tensor, va: Optional[torch.Tensor],
                      k: int) -> list[torch.Tensor]:
    """The k planes s * p_i of the threshold fold, in x's dtype:
    u = x - bf16(t) when x is bf16, p_1 = sign(u), p_{i+1} = sign(u -
    resid) with resid += va_i * p_i, every op in x's dtype
    (binary_infer.py:180-203)."""
    u = x - thresh.to(x.dtype)
    s = flip.to(x.dtype)
    planes = []
    resid = torch.zeros_like(u)
    for i in range(k):
        p = binary_sign(u - resid)
        planes.append(s * p)
        if i + 1 < k:
            resid = resid + va[i].to(x.dtype) * p
    return planes


def _activation_planes(x: torch.Tensor, vs: torch.Tensor,
                       k: int) -> list[torch.Tensor]:
    """The k planes b_i of the greedy decomposition of x with per-sample
    scales vs (k, N): b_i = sign(x - result), result += vs_i[n] * b_i.
    A float32 scale times a bf16 sign is float32, so after the first
    plane the chain runs in float32 (binary_infer.py:125-145)."""
    per_sample = (x.shape[0],) + (1,) * (x.ndim - 1)
    planes = []
    result = torch.zeros_like(x)
    for i in range(k):
        b = binary_sign(x - result)
        planes.append(b)
        if i + 1 < k:
            result = result + vs[i].reshape(per_sample) * b
    return planes


def activation_sign_planes(x: torch.Tensor, scheme: str, vs: torch.Tensor,
                           dtype: torch.dtype = SIGN_COMPUTE_DTYPE
                           ) -> tuple[list, list]:
    """([plane NHWC in dtype], [v (N,)]) with x_q = sum_i v_i * plane_i;
    vs is the (k, N) per-sample scale stack. ls-T's two planes share one
    scale and merge into one {-2, 0, 2} plane."""
    planes = _activation_planes(x, vs, sign_planes(scheme))
    if scheme == 'ls-T':
        return [(planes[0] + planes[1]).to(dtype)], [vs[0]]
    return [p.to(dtype) for p in planes], [vs[i] for i in range(len(planes))]


def threshold_sign_planes(x: torch.Tensor, scheme: str, vs: torch.Tensor,
                          thresh: torch.Tensor, flip: torch.Tensor,
                          va: Optional[torch.Tensor],
                          dtype: torch.dtype = SIGN_COMPUTE_DTYPE
                          ) -> tuple[list, list]:
    """Sign planes of quantize(clamp(BN(x))) from the RAW pre-BN x via
    per-channel thresholds t, flips s = sign(a) and normalised plane
    scales va (k, C) = v_i / |a| (nn.export.fold_xnor_thresholds);
    returns as activation_sign_planes."""
    k = sign_planes(scheme)
    if scheme == 'ls-T':
        u = x - thresh.to(x.dtype)
        p1 = binary_sign(u)
        p2 = binary_sign(u - va[0].to(x.dtype) * p1)
        return [(flip.to(x.dtype) * (p1 + p2)).to(dtype)], [vs[0]]
    planes = _threshold_planes(x, thresh, flip, va, k)
    return [p.to(dtype) for p in planes], [vs[i] for i in range(k)]


# ---------------------------------------------------------------- producer


def _launch_checks(x: torch.Tensor) -> None:
    _build.require(x.dtype in _DTYPE_SUFFIX, f'unsupported dtype {x.dtype}')
    _build.require(x.is_contiguous(), 'x must be contiguous')


def pack_sign_planes_plain(x: torch.Tensor, k: int,
                           scales: Optional[torch.Tensor] = None,
                           thresh: Optional[torch.Tensor] = None,
                           flip: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain twin of the producer: the k planes of threshold_sign_planes
    (thresh given; scales = va (>= k-1, C)) or of activation_sign_planes
    (scales = vs (>= k-1, N)), each packed."""
    if thresh is not None:
        planes = _threshold_planes(x, thresh, flip, scales, k)
    else:
        planes = _activation_planes(x, scales, k)
    return torch.stack([pack_signs(p) for p in planes])


def pack_sign_planes(x: torch.Tensor, k: int,
                     scales: Optional[torch.Tensor] = None,
                     thresh: Optional[torch.Tensor] = None,
                     flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Producer: (N,H,W,C) -> (k,N,H,W,ceil(C/32)) int32 words in one pass
    over x, plane i's bit = (p_i >= 0) XOR (flip < 0); ls-1 is k = 1.

    Folded (thresh and flip given): x is the raw pre-BN input, scales the
    (>= k-1, C) per-channel va, and the chain rounds every op to x's dtype
    as threshold_sign_planes does. Unfolded: x is clamp(x), scales the
    (>= k-1, N) per-sample vs, and the chain runs in float32 as
    activation_sign_planes does. Only the first k-1 scale rows are read,
    so k = 1 needs no scales.
    """
    _build.require(x.ndim == 4, f'expected NHWC, got shape {x.shape}')
    n, h, w, c = x.shape
    folded = thresh is not None
    _build.require(k >= 1, f'k = {k} planes')
    if scales is None:
        _build.require(k == 1, f'k = {k} planes need {k - 1} scale rows')
        scales = x.new_empty((0, c if folded else n), dtype=torch.float32)
    _build.require(scales.ndim == 2 and scales.shape[0] >= k - 1
                   and scales.shape[1] == (c if folded else n),
                   f'scales must be (>= {k - 1}, {c if folded else n})')
    tensors = (x, scales) + ((thresh, flip) if folded else ())
    if folded:
        _build.require(thresh.shape == (c,) and flip.shape == (c,),
                       f'thresh and flip must be ({c},)')
    if _build.on_cpu(*tensors):
        return pack_sign_planes_plain(x, k, scales, thresh, flip)
    _launch_checks(x)
    scales = scales.to(torch.float32).contiguous()
    if folded:
        thresh = thresh.to(torch.float32).contiguous()
        flip = flip.to(torch.float32).contiguous()
    wc = packed_width(c)
    out = torch.empty((k, n, h, w, wc), dtype=torch.int32, device=x.device)
    lib = _build.load('xnor', _SIGNATURES)
    entry = getattr(lib, f'qtt_pack_sign_planes_{_DTYPE_SUFFIX[x.dtype]}')
    status = entry(_build.ptr(x), _build.ptr(thresh), _build.ptr(flip),
                   _build.ptr(scales), _build.ptr(out), n * h * w, c, wc, k,
                   h * w, _build.stream(x))
    _build.check(lib, status, 'pack_sign_planes')
    pack_launches.bump()
    return out


# -------------------------------------------------------------------- tail


class Tail(NamedTuple):
    """A residual block's tail after a binary conv, applied to each output
    value v (the conv's result with its bias, in out_dtype) in this order:

        a = prelu(v, slope_a)       where slope_a is given
        b = a + r                   where residual is given
        y = prelu(b, slope_b)       where slope_b is given

    r is `residual`, a tensor of the output's shape and dtype, or, with
    `bn` = (mean, mul, bias) (float32, (O,)), the shortcut conv's raw
    output put through its eval BatchNorm: bn_affine(residual, *bn) in
    float32, rounded to out_dtype. The slopes are the PReLUs' float32
    parameters (one value each): the kernels read them on the card, so
    no launch waits on the host."""

    slope_a: Optional[torch.Tensor] = None
    residual: Optional[torch.Tensor] = None
    bn: Optional[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
    slope_b: Optional[torch.Tensor] = None


def prelu(x: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    """PReLU with one shared slope, cast to x's dtype. At x = 0 the
    gradient is 1, as jnp.where's (F.prelu's is the slope)."""
    return torch.where(x >= 0, x, slope.to(x.dtype) * x)


def bn_affine(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
    """(x - mean) * mul + bias in x's dtype promoted to float32, each op
    rounded on its own (nn.layers.BatchNorm's normalization)."""
    y = (x.to(torch.promote_types(x.dtype, torch.float32)) - mean) * mul
    return y if bias is None else y + bias


def apply_tail(y: torch.Tensor, tail: Tail) -> torch.Tensor:
    """The tail (Tail) applied to a conv's output y with eager ops."""
    if tail.slope_a is not None:
        y = prelu(y, tail.slope_a)
    if tail.residual is not None:
        r = tail.residual
        if tail.bn is not None:
            r = bn_affine(r, *tail.bn).to(y.dtype)
        y = y + r
    if tail.slope_b is not None:
        y = prelu(y, tail.slope_b)
    return y


def _tail_tensors(tail: Optional[Tail], shape: tuple,
                  dtype: torch.dtype) -> tuple:
    """The tail's tensors (none without a tail); raises unless the tail
    fits an output of this shape and dtype."""
    if tail is None:
        return ()
    r = tail.residual
    _build.require(r is None or (tuple(r.shape) == tuple(shape)
                                 and r.dtype == dtype),
                   f'the residual must be {tuple(shape)} {dtype}')
    _build.require(r is not None or tail.bn is None,
                   'a tail BatchNorm needs a residual')
    if tail.bn is not None:
        _build.require(len(tail.bn) == 3 and all(
            v.shape == (shape[-1],) and v.dtype == torch.float32
            for v in tail.bn), f'the tail BatchNorm takes three float32 '
            f'({shape[-1]},) vectors')
    _build.require(all(s is None or (s.numel() == 1
                                     and s.dtype == torch.float32)
                       for s in (tail.slope_a, tail.slope_b)),
                   'a PReLU slope is one float32 value')
    return tuple(t for t in (tail.slope_a, r, tail.slope_b,
                             *(tail.bn or ())) if t is not None)


def _tail_ptrs(tail: Optional[Tail]) -> tuple[list, list]:
    """The six tail pointers of a launch (residual, BN mean, mul and
    bias, slope_a, slope_b; null where left out) and the tensors they
    point into, which the caller keeps alive until the launch is
    queued."""
    if tail is None:
        return [_build.ptr(None)] * 6, []
    r = tail.residual
    if r is not None:
        r = r.contiguous()
        if r.data_ptr() % 16:  # the kernels read it in 16-byte chunks
            r = r.clone()
    bn = [v.contiguous() for v in tail.bn] if tail.bn is not None else [
        None] * 3
    held = [r, *bn, tail.slope_a, tail.slope_b]
    return [_build.ptr(t) for t in held], held


# -------------------------------------------------------------------- conv


def _epilogue(dots: list[list[torch.Tensor]], vx: torch.Tensor,
              vw: torch.Tensor, bias: Optional[torch.Tensor],
              out_dtype: torch.dtype) -> torch.Tensor:
    """JAX's int8-branch epilogue over dots[j][i] (weight group j,
    activation group i), each term and running sum in out_dtype."""
    acc = None
    for j, row in enumerate(dots):
        for i, dot in enumerate(row):
            scale = (vx[i].to(torch.float32).reshape(-1, 1, 1, 1)
                     * vw[j].to(torch.float32).reshape(1, 1, 1, -1))
            term = (dot * scale).to(out_dtype)
            acc = term if acc is None else acc + term
    if bias is not None:
        acc = acc + bias.to(out_dtype)
    return acc


def _plane_dot(x_words: torch.Tensor, w_packed: torch.Tensor,
               in_channels: int, stride: IntOr2, padding: IntOr2,
               pad_top: Optional[int] = None,
               pad_bottom: Optional[int] = None) -> torch.Tensor:
    xs = unpack_signs(x_words, in_channels)
    ws = unpack_weights_int8(w_packed, in_channels, dtype=torch.float32)
    return binary_conv_int8(xs.to(torch.int8), ws.to(torch.int8),
                            stride=stride, padding=padding, pad_top=pad_top,
                            pad_bottom=pad_bottom)


def xnor_conv2d_plain(x_words: torch.Tensor, w_packed: torch.Tensor,
                      vx: torch.Tensor, vw: torch.Tensor,
                      bias: Optional[torch.Tensor], *, in_channels: int,
                      stride: IntOr2 = 1, padding: IntOr2 = 1,
                      out_dtype: torch.dtype = torch.float32,
                      pad_top: Optional[int] = None,
                      pad_bottom: Optional[int] = None,
                      tail: Optional[Tail] = None) -> torch.Tensor:
    """Plain twin of xnor_conv2d: the integer conv over unpacked +-1
    planes (zero padding), then the kernel's epilogue and the tail."""
    dot = _plane_dot(x_words, w_packed, in_channels, stride, padding,
                     pad_top, pad_bottom)
    y = _epilogue([[dot]], vx[None], vw[None], bias, out_dtype)
    return y if tail is None else apply_tail(y, tail)


def _conv_checks(x_words: torch.Tensor, w_packed: torch.Tensor,
                 in_channels: int, stride: IntOr2, padding: IntOr2,
                 out_dtype: torch.dtype) -> tuple[int, int]:
    wc, wc2 = x_words.shape[-1], w_packed.shape[-2]
    _build.require(wc == wc2 == packed_width(in_channels),
                   f'word axes {wc}, {wc2} do not hold {in_channels} '
                   'channels')
    _build.require(x_words.dtype == torch.int32
                   and w_packed.dtype == torch.int32, 'words must be int32')
    _build.require(out_dtype in _DTYPE_SUFFIX,
                   f'unsupported out dtype {out_dtype}')
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    _build.require(sh == sw and ph == pw and sh > 0 and ph >= 0,
                   'stride and padding must be equal in H and W')
    return sh, ph


def _out_shape(x_words: torch.Tensor, w_packed: torch.Tensor, s: int,
               p: int, rows: tuple[int, int]) -> tuple[int, int, int, int]:
    n, h, w = x_words.shape[-4:-1]
    kh, kw, _, o = w_packed.shape[-4:]
    return n, (h + sum(rows) - kh) // s + 1, (w + 2 * p - kw) // s + 1, o


def xnor_conv2d(x_words: torch.Tensor, w_packed: torch.Tensor,
                vx: torch.Tensor, vw: torch.Tensor,
                bias: Optional[torch.Tensor], *, in_channels: int,
                stride: IntOr2 = 1, padding: IntOr2 = 1,
                out_dtype: torch.dtype = torch.float32,
                pad_top: Optional[int] = None,
                pad_bottom: Optional[int] = None,
                tail: Optional[Tail] = None) -> torch.Tensor:
    """Binary conv over packed words, NHWC out.

    Args:
        x_words: (N, H, W, ceil(C/32)) int32 packed activation signs.
        w_packed: (kh, kw, ceil(C/32), O) int32 packed weight signs.
        vx: (N,) per-sample scales; vw: (O,) per-out-channel scales.
        bias: optional (O,) bias, added in out_dtype after rounding.
        in_channels: C. Taps outside the image contribute nothing (the
            +-1 operand is zero-padded).
        pad_top / pad_bottom: H padding of a row band (module
            docstring); `padding` pads W, and H where these are None.
        tail: the block's tail (Tail), applied before the store.
    """
    _build.require(x_words.ndim == 4 and w_packed.ndim == 4,
                   'x_words must be (N,H,W,Wc) and w_packed (kh,kw,Wc,O)')
    s, p = _conv_checks(x_words, w_packed, in_channels, stride, padding,
                        out_dtype)
    n, h, wd, wc = x_words.shape
    kh, kw, _, o = w_packed.shape
    _build.require(vx.shape == (n,) and vw.shape == (o,)
                   and (bias is None or bias.shape == (o,)),
                   'vx must be (N,), vw and bias (O,)')
    rows = _row_pads(padding, pad_top, pad_bottom)
    _build.require(min(rows) >= 0, f'row pads {rows}')
    shape = _out_shape(x_words, w_packed, s, p, rows)
    tensors = ((x_words, w_packed, vx, vw) + (() if bias is None else (bias,))
               + _tail_tensors(tail, shape, out_dtype))
    if _build.on_cpu(*tensors):
        out = xnor_conv2d_plain(x_words, w_packed, vx, vw, bias,
                                in_channels=in_channels, stride=stride,
                                padding=padding, out_dtype=out_dtype,
                                pad_top=rows[0], pad_bottom=rows[1],
                                tail=tail)
    else:
        _build.require(x_words.is_contiguous()
                       and w_packed.is_contiguous(),
                       'packed operands must be contiguous')
        out = torch.empty(shape, dtype=out_dtype, device=x_words.device)
        vx = vx.to(torch.float32).contiguous()
        vw = vw.to(torch.float32).contiguous()
        if bias is not None:
            bias = bias.to(out_dtype).contiguous()
        tail_ptrs, _held = _tail_ptrs(tail)
        lib = _build.load('xnor', _SIGNATURES)
        entry = getattr(lib, f'qtt_xnor_conv2d_{_DTYPE_SUFFIX[out_dtype]}')
        status = entry(_build.ptr(x_words), _build.ptr(w_packed),
                       _build.ptr(vx), _build.ptr(vw), _build.ptr(bias),
                       _build.ptr(out), *tail_ptrs, n, h, wd, wc,
                       in_channels, o, shape[1], shape[2], kh, kw, s, p,
                       rows[0], _build.stream(x_words))
        _build.check(lib, status, 'xnor_conv2d')
        conv_launches.bump()
        if tail is not None:
            tail_launches.bump()
    return out


def xnor_conv2d_planes_plain(x_words: torch.Tensor, w_packed: torch.Tensor,
                             vx: torch.Tensor, vw: torch.Tensor,
                             bias: Optional[torch.Tensor], *,
                             in_channels: int, x_group: int = 1,
                             w_group: int = 1, stride: IntOr2 = 1,
                             padding: IntOr2 = 1,
                             out_dtype: torch.dtype = torch.float32,
                             pad_top: Optional[int] = None,
                             pad_bottom: Optional[int] = None,
                             tail: Optional[Tail] = None
                             ) -> torch.Tensor:
    """Plain twin of xnor_conv2d_planes: the integer dot of every plane
    pair, summed within each (weight group, activation group), then the
    pass-loop epilogue and the tail."""
    k_a, k_w = x_words.shape[0], w_packed.shape[0]
    dots = []
    for j in range(k_w // w_group):
        row = []
        for i in range(k_a // x_group):
            row.append(sum(
                _plane_dot(x_words[i * x_group + a],
                           w_packed[j * w_group + b], in_channels, stride,
                           padding, pad_top, pad_bottom)
                for b in range(w_group) for a in range(x_group)))
        dots.append(row)
    y = _epilogue(dots, vx, vw, bias, out_dtype)
    return y if tail is None else apply_tail(y, tail)


def xnor_conv2d_planes(x_words: torch.Tensor, w_packed: torch.Tensor,
                       vx: torch.Tensor, vw: torch.Tensor,
                       bias: Optional[torch.Tensor], *, in_channels: int,
                       x_group: int = 1, w_group: int = 1,
                       stride: IntOr2 = 1, padding: IntOr2 = 1,
                       out_dtype: torch.dtype = torch.float32,
                       pad_top: Optional[int] = None,
                       pad_bottom: Optional[int] = None,
                       tail: Optional[Tail] = None) -> torch.Tensor:
    """Multi-plane binary conv over packed words: JAX's int8 route, bit
    for bit (see the module docstring).

    Args:
        x_words: (k_a, N, H, W, ceil(C/32)) int32 activation planes.
        w_packed: (k_w, kh, kw, ceil(C/32), O) int32 weight planes.
        vx: (k_a / x_group, N) per-sample scales, one per group.
        vw: (k_w / w_group, O) per-out-channel scales, one per group.
        x_group / w_group: planes a scale covers, 1 or 2 (ls-T).
        pad_top / pad_bottom, tail: as xnor_conv2d's.
    """
    _build.require(x_words.ndim == 5 and w_packed.ndim == 5,
                   'x_words must be (k_a,N,H,W,Wc) and w_packed '
                   '(k_w,kh,kw,Wc,O)')
    s, p = _conv_checks(x_words, w_packed, in_channels, stride, padding,
                        out_dtype)
    k_a, n, h, wd, wc = x_words.shape
    k_w, kh, kw, _, o = w_packed.shape
    _build.require(x_group in (1, 2) and w_group in (1, 2)
                   and k_a % x_group == 0 and k_w % w_group == 0,
                   f'{k_a} and {k_w} planes in groups of 1 or 2')
    ga, gw = k_a // x_group, k_w // w_group
    _build.require(vx.shape == (ga, n) and vw.shape == (gw, o)
                   and (bias is None or bias.shape == (o,)),
                   f'vx must be ({ga}, N), vw ({gw}, O) and bias (O,)')
    rows = _row_pads(padding, pad_top, pad_bottom)
    _build.require(min(rows) >= 0, f'row pads {rows}')
    shape = _out_shape(x_words, w_packed, s, p, rows)
    tensors = ((x_words, w_packed, vx, vw) + (() if bias is None else (bias,))
               + _tail_tensors(tail, shape, out_dtype))
    if _build.on_cpu(*tensors):
        out = xnor_conv2d_planes_plain(
            x_words, w_packed, vx, vw, bias, in_channels=in_channels,
            x_group=x_group, w_group=w_group, stride=stride,
            padding=padding, out_dtype=out_dtype, pad_top=rows[0],
            pad_bottom=rows[1], tail=tail)
    else:
        _build.require(x_words.is_contiguous()
                       and w_packed.is_contiguous(),
                       'packed operands must be contiguous')
        out = torch.empty(shape, dtype=out_dtype, device=x_words.device)
        vx = vx.to(torch.float32).contiguous()
        vw = vw.to(torch.float32).contiguous()
        if bias is not None:
            bias = bias.to(out_dtype).contiguous()
        tail_ptrs, _held = _tail_ptrs(tail)
        lib = _build.load('xnor', _SIGNATURES)
        entry = getattr(
            lib, f'qtt_xnor_conv2d_planes_{_DTYPE_SUFFIX[out_dtype]}')
        status = entry(_build.ptr(x_words), _build.ptr(w_packed),
                       _build.ptr(vx), _build.ptr(vw), _build.ptr(bias),
                       _build.ptr(out), *tail_ptrs, n, h, wd, wc,
                       in_channels, o, shape[1], shape[2], kh, kw, s, p,
                       rows[0], ga, x_group, gw, w_group,
                       _build.stream(x_words))
        _build.check(lib, status, 'xnor_conv2d_planes')
        planes_conv_launches.bump()
        if tail is not None:
            tail_launches.bump()
    return out


def conv_occupancy(out_dtype: torch.dtype, ga: int = 1, pa: int = 1,
                   gw: int = 1, pw: int = 1,
                   tail: bool = False) -> tuple[int, int]:
    """(registers a thread, blocks an SM) of the conv kernel that a launch
    with ga activation groups of pa planes and gw weight groups of pw
    planes takes (all 1: xnor_conv2d's), with a tail or without, from the
    built library on the current CUDA device."""
    _build.require(out_dtype in _DTYPE_SUFFIX,
                   f'unsupported out dtype {out_dtype}')
    lib = _build.load('xnor', _SIGNATURES)
    regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
    status = lib.qtt_xnor_conv2d_occupancy(
        int(out_dtype == torch.float32), ga, pa, gw, pw, int(tail),
        ctypes.byref(regs), ctypes.byref(blocks))
    _build.check(lib, status, 'conv_occupancy')
    return regs.value, blocks.value


# ------------------------------------------------------------ the routes


def _int8_route(x: torch.Tensor, x_scheme: str, x_vs: torch.Tensor,
                w_packed: torch.Tensor, w_vs: torch.Tensor, w_group: int,
                folded: bool, conv_kw: dict, x_thresh: Optional[torch.Tensor],
                x_flip: Optional[torch.Tensor], x_va: Optional[torch.Tensor],
                band: Optional[RowBand],
                tail: Optional[Tail] = None) -> torch.Tensor:
    """Producer + conv kernels: the bit-exact pass loop, with the tail in
    the conv's epilogue; a band's halo rows are exchanged as packed
    words."""
    k_a, k_w = sign_planes(x_scheme), w_packed.shape[0]
    x_group = 2 if x_scheme == 'ls-T' else 1
    x = x.contiguous()
    if folded:
        words = pack_sign_planes(x, k_a, x_va, x_thresh, x_flip)
    else:
        words = pack_sign_planes(x, k_a, x_vs)
    if band is not None:
        words = band.extend(words).contiguous()
        conv_kw = dict(conv_kw, pad_top=band.pad_top,
                       pad_bottom=band.pad_bottom)
    vx, vw = x_vs[:k_a // x_group], w_vs[:k_w // w_group]
    w_packed = w_packed.contiguous()
    if k_a == 1 and k_w == 1:
        return xnor_conv2d(words[0], w_packed[0], vx[0], vw[0], tail=tail,
                           **conv_kw)
    return xnor_conv2d_planes(words, w_packed, vx, vw, x_group=x_group,
                              w_group=w_group, tail=tail, **conv_kw)


def _bf16_route(x_planes: list, x_scales: list,
                w_sign_sets: list[tuple[torch.Tensor, torch.Tensor]],
                fused: bool, stride: IntOr2, padding: IntOr2,
                out_dtype: torch.dtype, rows: tuple = (None, None)
                ) -> torch.Tensor:
    """JAX's bf16 sign-plane convs (binary_infer.py:288-321), before the
    bias: the fused bake or the pass loop; H padded by rows (top,
    bottom), the symmetric pad where None."""
    n = x_planes[0].shape[0]
    f32 = torch.float32

    def conv(xs: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
        return binary_conv_int8(xs, ws, stride=stride, padding=padding,
                                pad_top=rows[0], pad_bottom=rows[1])

    if fused:
        if len(x_planes) == 1:
            x_op, vx_epi = x_planes[0], x_scales[0]
        else:
            xa = sum(vx.reshape(n, 1, 1, 1).to(f32) * p.to(f32)
                     for p, vx in zip(x_planes, x_scales))
            x_op, vx_epi = xa.to(SIGN_COMPUTE_DTYPE), None
        if len(w_sign_sets) == 1:
            w_op, vw_epi = w_sign_sets[0]
        else:
            wa = sum(ws.to(f32) * vw.reshape(1, 1, 1, -1).to(f32)
                     for ws, vw in w_sign_sets)
            w_op, vw_epi = wa.to(SIGN_COMPUTE_DTYPE), None
        y = conv(x_op, w_op)
        if vx_epi is not None:
            y = y * vx_epi.reshape(n, 1, 1, 1).to(f32)
        if vw_epi is not None:
            y = y * vw_epi.reshape(1, 1, 1, -1).to(f32)
        return y.to(out_dtype)
    acc = None
    for w_signs, vw in w_sign_sets:
        for bx, vx in zip(x_planes, x_scales):
            scale = (vx.reshape(n, 1, 1, 1).to(f32)
                     * vw.reshape(1, 1, 1, -1).to(f32))
            term = (conv(bx, w_signs) * scale).to(out_dtype)
            acc = term if acc is None else acc + term
    return acc


def _compute_is_int8(compute_dtype: Any) -> bool:
    if compute_dtype in ('int8', torch.int8):
        return True
    if compute_dtype in (None, 'bf16', torch.bfloat16):
        return False
    raise ValueError(f'invalid compute_dtype {compute_dtype!r}')


def quant_conv2d_infer(x: torch.Tensor, *,
                       x_scheme: str, x_vs: torch.Tensor,
                       w_packed: torch.Tensor, w_vs: torch.Tensor,
                       in_channels: int,
                       bias: Optional[torch.Tensor] = None,
                       stride: IntOr2 = 1, padding: IntOr2 = 0,
                       clamp_fn: Optional[Callable] = None,
                       w_planes_share_scale: bool = False,
                       out_dtype: torch.dtype = torch.float32,
                       fused: bool = True,
                       compute_dtype: Any = None,
                       x_thresh: Optional[torch.Tensor] = None,
                       x_flip: Optional[torch.Tensor] = None,
                       x_va: Optional[torch.Tensor] = None,
                       band: Optional[RowBand] = None,
                       tail: Optional[Tail] = None) -> torch.Tensor:
    """Packed-weight quantized conv (JAX's quant_conv2d_infer).

    Args:
        x: fp NHWC activations (pre-clamp), or the RAW pre-BN tensor when
            x_thresh/x_flip/x_va are given (then clamp_fn is ignored).
        x_scheme / x_vs: activation scheme and (k, N) scales.
        w_packed: (kh, kw, Wd, O) packed weight words, or (k_w, kh, kw,
            Wd, O), one plane per weight bit.
        w_vs: (k_w, O) per-out-channel weight scales.
        w_planes_share_scale: ls-T weights, whose two planes share w_vs[0].
        fused: the bf16 route's single baked conv (False: the pass loop).
        compute_dtype: 'int8' (or torch.int8) runs the kernels, exact and
            never fused; None or 'bf16' the bf16 route.
        band: x is a row band (module docstring); x_vs are the whole
            samples' scales.
        tail: the block's tail (Tail), which the int8 route's conv
            applies; the other routes and a band take none.
    """
    if w_packed.ndim == 4:
        w_packed = w_packed[None]
    k_w = w_packed.shape[0]
    w_group = 2 if (w_planes_share_scale and k_w == 2) else 1
    folded = x_thresh is not None
    if not folded and clamp_fn is not None:
        x = clamp_fn(x)
    conv_kw = dict(in_channels=in_channels, stride=stride, padding=padding,
                   out_dtype=out_dtype, bias=bias)
    int8 = _compute_is_int8(compute_dtype)
    _build.require(tail is None or (int8 and band is None),
                   'a tail needs the int8 route and no band')
    if int8:
        return _int8_route(x, x_scheme, x_vs, w_packed, w_vs, w_group,
                           folded, conv_kw, x_thresh, x_flip, x_va, band,
                           tail)
    rows = (None, None)
    if band is not None:
        x, rows = band.extend(x), (band.pad_top, band.pad_bottom)
    cdt = SIGN_COMPUTE_DTYPE
    if folded:
        x_planes, x_scales = threshold_sign_planes(
            x, x_scheme, x_vs, x_thresh, x_flip, x_va, dtype=cdt)
    else:
        x_planes, x_scales = activation_sign_planes(x, x_scheme, x_vs,
                                                    dtype=cdt)
    if w_group == 2:
        merged = (unpack_weights_int8(w_packed[0], in_channels, dtype=cdt)
                  + unpack_weights_int8(w_packed[1], in_channels, dtype=cdt))
        w_sign_sets = [(merged, w_vs[0])]
    else:
        w_sign_sets = [(unpack_weights_int8(w_packed[j], in_channels,
                                            dtype=cdt), w_vs[j])
                       for j in range(k_w)]
    acc = _bf16_route(x_planes, x_scales, w_sign_sets, fused, stride,
                      padding, out_dtype, rows)
    if bias is not None:
        acc = acc + bias.to(out_dtype)
    return acc


def fp_activation_conv_infer(x: torch.Tensor, *,
                             w_packed: torch.Tensor, w_vs: torch.Tensor,
                             in_channels: int,
                             bias: Optional[torch.Tensor] = None,
                             stride: IntOr2 = 1, padding: IntOr2 = 0,
                             clamp_fn: Optional[Callable] = None,
                             out_dtype: torch.dtype = torch.float32,
                             fused: bool = True,
                             band: Optional[RowBand] = None) -> torch.Tensor:
    """fp activations x binary weights: a conv of bf16(x) against the
    unpacked signs (float32 sums, see the module docstring) with the
    per-channel scale epilogue; fused collapses k_w > 1 planes into one
    scale-baked bf16 kernel. With `band`, x is a row band."""
    rows = (None, None)
    if band is not None:
        x, rows = band.extend(x), (band.pad_top, band.pad_bottom)
    if clamp_fn is not None:
        x = clamp_fn(x)
    if w_packed.ndim == 4:
        w_packed = w_packed[None]
    k_w = w_packed.shape[0]
    x16 = x.to(torch.bfloat16)

    def conv(ws: torch.Tensor) -> torch.Tensor:
        return binary_conv_int8(x16, ws, stride=stride, padding=padding,
                                pad_top=rows[0], pad_bottom=rows[1])

    if fused and k_w > 1:
        wa = sum(unpack_weights_int8(w_packed[j], in_channels,
                                     dtype=torch.float32)
                 * w_vs[j].reshape(1, 1, 1, -1).to(torch.float32)
                 for j in range(k_w))
        acc = conv(wa.to(torch.bfloat16)).to(out_dtype)
    else:
        acc = None
        for j in range(k_w):
            w_signs = unpack_weights_int8(w_packed[j], in_channels)
            term = (conv(w_signs) * w_vs[j].reshape(1, 1, 1, -1)).to(
                out_dtype)
            acc = term if acc is None else acc + term
    if bias is not None:
        acc = acc + bias.to(out_dtype)
    return acc
