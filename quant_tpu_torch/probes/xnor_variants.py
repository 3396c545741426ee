"""Variants of csrc/xnor.cu timed on the card: knock-outs and a baseline.

Knock-outs. The card's machine has no profiler that reads a kernel's
stalls, so this probe takes parts of xnor_conv2d out instead. Each
knock-out is a copy of xnor.cu with one part of the conv removed by a
text substitution, timed at the serving path's four layer shapes (batch
128, bf16 out). The time a knock-out saves bounds what its part costs;
only `kernel` (the source as it is) and `min_4_blocks` (registers capped
at 128, so 4 blocks fit an SM) compute the right result. A knock-out
whose text is no longer in the source is recorded as stale and not
built. The probe also records the instruction mix of the conv's unrolled
stage from its SASS.

Baseline (--baseline PATH). Another xnor.cu with the same C interface,
such as an earlier commit's
(`git show REV:quant_tpu_torch/csrc/xnor.cu > build/xnor_base.cu`).
Its xnor_conv2d and pack_threshold_signs are timed against this tree's
on the inputs the 16 binary convs of the seeded serving ResNet-18 see in
one bf16 forward at batch 128, in the order baseline, current, current,
baseline, each on two timers: card time behind a head start
(`common.card_ms`) and back to back, host launch time included. Times
are summed over the 16 launches of a forward; both libraries' results
must equal the plain twins'.

Usage: python -m quant_tpu_torch.probes.xnor_variants [--baseline PATH]
           [--out PATH]
"""

import argparse
import collections
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from quant_tpu_torch import _build
from quant_tpu_torch.nn.layers import QuantConv2d
from quant_tpu_torch.ops import binary_infer as B
from quant_tpu_torch.probes import common, models

_MMA = 'for (int j = 0; j < kConvNT; ++j) mma_s8(acc[i][j], af, bf[j]);'
_A = ('expand_word(A[row * kKS + (kk ^ swz)], t, keep, af[hh],\n'
      '                      af[2 + hh]);')
_B = 'expand_word(B[kk * kConvBN + j * 8], t, ~0u, bf[j][0], bf[j][1]);'
_BOUNDS = '__launch_bounds__(kConvThreads)'
# name: ((text in xnor.cu, its stand-in), ...)
KNOCKOUTS: dict[str, tuple[tuple[str, str], ...]] = {
    'kernel': (),
    'min_4_blocks': ((_BOUNDS, _BOUNDS.replace(')', ', 4)')),),
    'half_mma': ((_MMA, _MMA.replace('++j', 'j += 2')),),
    'no_a_expand': ((_A, 'af[hh] = A[row * kKS + (kk ^ swz)];'
                         ' af[2 + hh] = af[hh] ^ keep;'),),
    'no_a_mask': (('static_cast<int>(vm[i][hh] << (31 - kk)) >> 31);',
                   '-1);'),),
    'no_b_expand': ((_B, 'bf[j][0] = B[kk * kConvBN + j * 8];'
                         ' bf[j][1] = ~bf[j][0];'),),
    'no_store': (('if (m >= s.m || col0 + cc >= s.o) continue;',
                  'continue;'),),
}
# (N, H=W, C, O), 3x3, stride 1, padding 1: the layers' repeated convs.
SHAPES = ((128, 56, 64, 64), (128, 28, 128, 128), (128, 14, 256, 256),
          (128, 7, 512, 512))
OUT_DIR = _build.BUILD_ROOT / 'variants'
ITERS = 20  # timed calls per reading


def variant_source(name: str, src: str) -> Optional[str]:
    """`src` with knock-out `name` applied, or None when one of its texts
    does not occur in `src` exactly once (a stale knock-out)."""
    for old, new in KNOCKOUTS[name]:
        if src.count(old) != 1:
            return None
        src = src.replace(old, new)
    return src


def build_all(baseline: Optional[str]) -> dict[str, ctypes.CDLL]:
    """Compile every live knock-out (and the baseline) at once; returns
    {name: library}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / 'common.cuh', OUT_DIR / 'common.cuh')
    src = (_build.CSRC / 'xnor.cu').read_text()
    sources = {name: variant_source(name, src) for name in KNOCKOUTS}
    for name in [n for n, s in sources.items() if s is None]:
        common.record('conv_knockout', torch.device('cuda'), variant=name,
                      stale=True)
        del sources[name]
    if baseline:
        sources['baseline'] = Path(baseline).read_text()
    procs = {}
    for name, text in sources.items():
        (OUT_DIR / f'{name}.cu').write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, '-o',
               str(OUT_DIR / f'{name}.so'), str(OUT_DIR / f'{name}.cu')]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for variant {name}:\n{log}')
        lib = ctypes.CDLL(str(OUT_DIR / f'{name}.so'))
        for sym, argtypes in B._SIGNATURES.items():
            getattr(lib, sym).argtypes = argtypes
            getattr(lib, sym).restype = ctypes.c_int
        libs[name] = lib
    return libs


def sass_mix(lib: str) -> dict[str, Any]:
    """Opcode counts of the bf16 conv kernel's SASS from its first MMA to
    its last: one unrolled stage of kKS words."""
    nvcc = Path(_build.nvcc_path())
    sass = subprocess.run([str(nvcc.with_name('cuobjdump')), '-sass', lib],
                          capture_output=True, text=True, check=True).stdout
    body = next(f for f in sass.split('Function : ')
                if 'xnor_conv2d_kernel' in f.split('\n')[0]
                and 'bfloat16' in f.split('\n')[0])
    ops = re.findall(r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)',
                     body)
    mma = [i for i, op in enumerate(ops) if op == 'IMMA']
    window = collections.Counter(ops[mma[0]:mma[-1] + 1])
    return dict(instructions=sum(window.values()), imma=window['IMMA'],
                top=dict(window.most_common(8)))


def knockouts(libs: dict[str, ctypes.CDLL], dev: torch.device) -> None:
    for n, hw, c, o in SHAPES:
        x = common.randint(-2 ** 31, 2 ** 31 - 1, (n, hw, hw, c // 32), dev,
                           torch.int32, seed=1)
        w = common.randint(-2 ** 31, 2 ** 31 - 1, (3, 3, c // 32, o), dev,
                           torch.int32, seed=2)
        vx = torch.rand(n, device=dev) + 0.1
        vw = torch.rand(o, device=dev) * 0.05
        bias = torch.randn(o, device=dev).to(torch.bfloat16)
        kw = dict(in_channels=c, stride=1, padding=1, out_dtype=torch.bfloat16)
        want = B.xnor_conv2d_plain(x, w, vx, vw, bias, **kw)
        for name in KNOCKOUTS:
            if name not in libs:
                continue
            got = torch.empty_like(want)
            args = [_build.ptr(v) for v in (x, w, vx, vw, bias, got)] + [
                n, hw, hw, c // 32, c, o, hw, hw, 3, 3, 1, 1,
                _build.stream(x)]
            lib = libs[name]
            ms = common.card_ms(lambda: lib.qtt_xnor_conv2d_bf16(*args),
                                ITERS)
            common.record('conv_knockout', dev, variant=name,
                          shape=[n, hw, hw, c, o], ms=ms,
                          equal=bool(torch.equal(got, want)))


def captured_convs(dev: torch.device, batch: int = 128,
                   seed: int = 0) -> list:
    """(conv, input) of each QuantConv2d in one bf16 forward of the
    seeded serving ResNet-18."""
    model = models.seeded_serving_resnet18(dev, seed)
    model.eval_dtype = torch.bfloat16
    seen: list = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0])))
        for m in model.modules() if isinstance(m, QuantConv2d)]
    x = torch.randn(batch, 224, 224, 3,
                    generator=torch.Generator().manual_seed(seed)).to(dev)
    with torch.inference_mode():
        model(x)
    for h in hooks:
        h.remove()
    return seen


def launcher(entry: Callable[..., int], tensors: tuple, ints: tuple
             ) -> Callable[[], int]:
    """A call of `entry` on the pointers of `tensors`, then `ints`; it
    holds the tensors, so their memory lives as long as the call."""
    def call() -> int:
        return entry(*[_build.ptr(t) for t in tensors], *ints)
    return call


def lib_calls(lib: ctypes.CDLL, seen: list
              ) -> tuple[list[Callable[[], int]], list[Callable[[], int]],
                         Callable[[], list[str]]]:
    """The producer's and the conv's launch of `lib` at each captured
    conv, and a check that names every output unequal to its plain
    twin."""
    packs, convs, checks = [], [], []
    for i, (conv, xin) in enumerate(seen):
        n, h, w, c = xin.shape
        wc = -(-c // 32)
        thresh = conv.x_thresh.float().contiguous()
        flip = conv.x_flip.float().contiguous()
        words = torch.empty(n, h, w, wc, dtype=torch.int32, device=xin.device)
        packs.append(launcher(
            lib.qtt_pack_threshold_signs_bf16, (xin, thresh, flip, words),
            (n * h * w, c, wc, _build.stream(xin))))
        want_words = B.pack_threshold_signs_plain(xin, thresh, flip)
        wp = conv.w_packed[0].contiguous()
        vx = conv.x_quantizer(xin)[0].float().contiguous()
        vw = conv.w_scales[0].float().contiguous()
        bias = (None if conv.bias is None
                else conv.bias.to(torch.bfloat16).contiguous())
        s, o = conv.stride, wp.shape[-1]
        oh, ow = (h - 1) // s + 1, (w - 1) // s + 1
        out = torch.empty(n, oh, ow, o, dtype=torch.bfloat16,
                          device=xin.device)
        convs.append(launcher(
            lib.qtt_xnor_conv2d_bf16, (want_words, wp, vx, vw, bias, out),
            (n, h, w, wc, c, o, oh, ow, 3, 3, s, 1, _build.stream(xin))))
        want_out = B.xnor_conv2d_plain(want_words, wp, vx, vw, bias,
                                       in_channels=c, stride=s, padding=1,
                                       out_dtype=torch.bfloat16)
        checks += [(f'pack_threshold_signs {i}', words, want_words),
                   (f'xnor_conv2d {i}', out, want_out)]

    def unequal() -> list[str]:
        status = [fn() for fn in packs + convs]
        torch.cuda.synchronize()
        if any(status):
            return [f'CUDA status {status}']
        return [what for what, got, want in checks
                if not torch.equal(got, want)]
    return packs, convs, unequal


def baseline_vs_current(libs: dict[str, ctypes.CDLL],
                        dev: torch.device) -> None:
    with torch.inference_mode():
        seen = captured_convs(dev)
        calls = {name: lib_calls(libs[name], seen)
                 for name in ('baseline', 'kernel')}
    for name, (_, _, unequal) in calls.items():
        bad = unequal()
        if bad:
            raise AssertionError(f'{name} xnor.cu differs from the twins: '
                                 f'{bad}')
    for k, kname in enumerate(('pack_threshold_signs', 'xnor_conv2d')):
        for rnd, name in enumerate(('baseline', 'kernel', 'kernel',
                                    'baseline')):
            fns = calls[name][k]
            card = sum(common.card_ms(f, ITERS) for f in fns)
            back = sum(common.card_ms(f, ITERS, head_start_ms=0)
                       for f in fns)
            common.record('xnor_baseline', dev, kernel=kname,
                          variant='current' if name == 'kernel' else name,
                          round=rnd, launches=len(fns), card_ms=card,
                          call_ms=back)


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--baseline', default=None,
                    help='an xnor.cu to time against this tree\'s')
    ap.add_argument('--out', default=None, help='also append the JSON '
                    'lines here')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('xnor_variants: no CUDA device', file=sys.stderr)
        return 2
    common._out_path = args.out
    dev = torch.device('cuda')
    libs = build_all(args.baseline)
    common.record('conv_sass', dev, **sass_mix(str(OUT_DIR / 'kernel.so')))
    knockouts(libs, dev)
    if args.baseline:
        baseline_vs_current(libs, dev)
    return 0


if __name__ == '__main__':
    sys.exit(main())
