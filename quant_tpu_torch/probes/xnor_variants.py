"""Variants of the CUDA sources timed on the card: knock-outs and baselines.

Knock-outs. The card's machine has no profiler that reads a kernel's
stalls, so this probe takes parts of a kernel out instead. Each
knock-out is a copy of csrc/ with one part removed by a text
substitution; the time it saves bounds what its part costs.
`KNOCKOUTS` take parts of xnor_conv2d out of xnor.cu, timed at the
serving path's four layer shapes (batch 128, bf16 out); only `kernel`
(the source as it is) and `min_4_blocks` (registers capped at 128, so 4
blocks fit an SM) compute the right result. `WG_KNOCKOUTS` take parts of
the wgmma GEMM core and its loaders out (wgmma_core.cuh, xnor.cu,
probe.cu), timed on xnor_gemm at the layer4 GEMM (M = 6,272, K = 4,608,
N = 512) and on tiled_matmul at 4096^3. A knock-out whose text is no
longer in the source is recorded as stale and not built. The probe also
records the instruction mix of the conv's unrolled stage and the
tensor-core opcode counts of every GEMM kernel built (`sass_mix`,
`gemm_sass`).

The multi-plane conv. `PLANES_VARIANTS` change one choice of
xnor_conv2d_planes (its register cap: none, or 2, 3 or 4 blocks an SM;
its warp tiles; its ring depth);
each computes the right result, is checked equal to the twin and timed
beside the source on the inputs the 16 convs of a multi-plane ResNet-18
capture at batch 128 (`PLANES_PHASES`: ls-T x ls-1 and ls-2 x ls-1 on the
int8 route). The probe records the SASS mix of the ls-T and ls-2
instances' unrolled stage (`planes_sass`) and the registers and blocks an
SM of the ls-1 conv and those instances in every library built
(`conv_occupancy`, from the card's occupancy query).

The bandwidth kernels. `BW_VARIANTS` change one design choice of the
stem pool (pool.cu: the neighbour's column by shuffle instead of from
L1, 4 or 16 rows a thread, no vertical carry, registers capped for 6
blocks an SM, 4-byte loads) or of the add (probe.cu: 2 or 4 vectors a
thread, 128-thread blocks, streaming hints at no size or at every size,
one or four waves of blocks walking the tiles grid-stride); each
computes the right result and is timed against `kernel` on the card:
the pool at the serving stem map (128, 112, 112, 64) in bf16 and f32,
the add at the probe's (1024, 256) and at (16384, 4096), 805 MB moved.
Beside them, in the same call: `F.max_pool2d` (channels-last),
`torch.add` and the card time of an empty launch
(`torch.cuda._sleep(0)`).

Baselines (--baseline PATH, --baseline-probe PATH, --baseline-pool
PATH). Another xnor.cu, probe.cu or pool.cu with the same C interface,
such as an earlier commit's (`git show
REV:quant_tpu_torch/csrc/xnor.cu > build/xnor_base.cu`). The baseline
xnor.cu's xnor_conv2d and producer (an older source's single-plane
qtt_pack_threshold_signs_bf16 where it has one, else
qtt_pack_sign_planes_bf16 at k = 1) are timed against this tree's on
the inputs the 16 binary convs of the seeded serving
ResNet-18 see in one bf16 forward at batch 128 (times summed over the
16 launches), its xnor_conv2d_planes on the inputs of each
`PLANES_PHASES` forward, and its xnor_gemm at the layer4 GEMM; the baseline
probe.cu's tiled_matmul, bf16 and int8, at 4096^3 and its add at both
add shapes; the baseline pool.cu's pool at the stem map in bf16 and
f32. Each in the order baseline, current, current, baseline (the pool
and the add: baseline, current, library, library, current, baseline),
on two timers: card time behind a head start (`common.card_ms`) and
back to back, host launch time included (bare launches, no Python
wrapper). Both libraries' results must equal the plain twins'. The
conv and pool entry points take a row band's `pad_top` after `pad` (the
pool after C), the convs the six pointers of a block's tail after `out`
(null: no tail) and the occupancy query a tail flag: an older source
without them does not share the interface.

`--parts` picks what runs, of conv (conv knock-outs and SASS), planes
(the multi-plane variants, SASS and occupancy), gemm (wgmma knock-outs
and SASS), pool and add (their variants); a baseline is timed for the
parts that run.

Usage: python -m quant_tpu_torch.probes.xnor_variants [--baseline PATH]
           [--baseline-probe PATH] [--baseline-pool PATH]
           [--parts conv,planes,gemm,pool,add] [--out PATH]
"""

import argparse
import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from quant_tpu_torch import _build
from quant_tpu_torch.nn.layers import QuantConv2d
from quant_tpu_torch.ops import binary_gemm as G
from quant_tpu_torch.ops import binary_infer as B
from quant_tpu_torch.ops import pool as P
from quant_tpu_torch.ops.conv import max_pool2d
from quant_tpu_torch.probes import common, models
from quant_tpu_torch.probes import kernels as PK

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
    'no_a_mask': (('uint32_t keep = keep_bit(vm[i][hh], kk);',
                   'uint32_t keep = ~0u;'),),
    'no_b_expand': ((_B, 'bf[j][0] = B[kk * kConvBN + j * 8];'
                         ' bf[j][1] = ~bf[j][0];'),),
    'no_store': (('if (m >= s.m || col0 + cc >= s.o) continue;',
                  'continue;'),),
}
# Knock-outs of the wgmma GEMM core and its loaders, name: ((text, its
# stand-in), ...), applied to the file WG_TARGETS names, which also says
# which GEMM kernels the variant is timed on.
_S8_STEPS = 'for (int kk = 0; kk < 4; ++kk)\n    mma_s8('
WG_KNOCKOUTS: dict[str, tuple[tuple[str, str], ...]] = {
    # xnor_gemm's loader stores the words as they are, unexpanded.
    'gemm_no_expand': ((
        'if ((live >> j) & 1u) expand32(words[j], lo, hi);',
        'lo = make_uint4(words[j], words[j], live, j); hi = lo;'),),
    # xnor_gemm's loader brings in the first stages' words only.
    'gemm_no_word_loads': ((
        'if (stage(ahead) < k_tiles) fetch(ahead);', ''),),
    # The loaders that write tiles (xnor_gemm, int8) skip the proxy fence.
    'core_no_fence': (('asm volatile("fence.proxy.async.shared::cta;\\n" '
                       '::: "memory");', ''),),
    # The s8 consumers run two of the four wgmma a stage.
    'core_half_mma': ((_S8_STEPS, _S8_STEPS.replace('kk < 4', 'kk < 2')),),
    # The consumers run no wgmma: the loaders alone set the time.
    'core_no_mma': (('      stage_mma(d, ring.a(s), ring.b(s), ci);\n',
                     ''),),
    # tiled_matmul int8 leaves B's landed tiles untransposed.
    'mm_no_transpose': ((
        'transpose_tile(r.scratch + i * wg::kTileBytes, r.b(s), t);',
        ''),),
}
# Variants of the multi-plane conv, name: ((text in xnor.cu, its
# stand-in), ...). Each computes the same result as the source; each is
# checked equal to the twin and timed on the captured inputs of
# PLANES_PHASES.
_PLANES_BOUNDS = '__launch_bounds__(kConvThreads, kPlanesBlocks)'
PLANES_VARIANTS: dict[str, tuple[tuple[str, str], ...]] = {
    # No register cap: ptxas picks the count (the ls-1 conv's choice).
    'planes_no_cap': ((_PLANES_BOUNDS, '__launch_bounds__(kConvThreads)'),),
    # Registers capped for 2 or for 4 blocks an SM (255 or 128).
    'planes_2_blocks': (('constexpr int kPlanesBlocks = 3;',
                         'constexpr int kPlanesBlocks = 2;'),),
    'planes_4_blocks': (('constexpr int kPlanesBlocks = 3;',
                         'constexpr int kPlanesBlocks = 4;'),),
    # Warp tiles of 2 x 2 warps: at one group (ls-T) the ls-1 conv's 64
    # pixels x 32 channels, at two (ls-2) 32 x 32 of each group, so each
    # A fragment is expanded by two warps and each B fragment by two.
    'planes_lsT_2x2_warps': (('static constexpr int kMT = GA == 1 ? 2 : 1;',
                              'static constexpr int kMT = GA == 1 ? 4 : 1;'),
                             ('static constexpr int kNT = GA == 3 ? 4 : 8;',
                              'static constexpr int kNT = GA == 2 ? 8 : 4;')),
    'planes_ls2_2x2_warps': (('static constexpr int kMT = GA == 1 ? 2 : 1;',
                              'static constexpr int kMT = GA == 3 ? 1 : 2;'),
                             ('static constexpr int kNT = GA == 3 ? 4 : 8;',
                              'static constexpr int kNT = GA == 1 ? 8 : 4;')),
    # A ring of 3 stages, not 4 (the ls-1 conv's too, which is not timed).
    'planes_3_stages': (('constexpr int kConvStages = 4;',
                         'constexpr int kConvStages = 3;'),),
}
# The multi-plane model phases whose captured convs time the multi-plane
# conv: (name, x_quant, w_quant, options), as chip_smoke.MODEL_PHASES has
# them (ResNet-18 XNOR, EMA scales, batch 128).
PLANES_PHASES = (
    ('resnet18_xnor_lsT_ls1', 'ls-T', 'ls-1', {}),
    ('resnet18_xnor_ls2_ls1_int8', 'ls-2', 'ls-1', {'sign_compute': 'int8'}),
)
# The multi-plane instances whose SASS and occupancy are recorded, (ga,
# pa, gw, pw) of the launch that takes them: ls-T x ls-1 and ls-2 x ls-1.
PLANES_INSTANCES = ((1, 2, 1, 1), (2, 1, 1, 1))
GEMMS = ('xnor_gemm', 'tiled_matmul_bf16', 'tiled_matmul_int8')
WG_TARGETS: dict[str, tuple[str, tuple[str, ...]]] = {
    'gemm_no_expand': ('xnor.cu', ('xnor_gemm',)),
    'gemm_no_word_loads': ('xnor.cu', ('xnor_gemm',)),
    'core_no_fence': ('wgmma_core.cuh', ('xnor_gemm', 'tiled_matmul_int8')),
    'core_half_mma': ('wgmma_core.cuh', ('xnor_gemm', 'tiled_matmul_int8')),
    'core_no_mma': ('wgmma_core.cuh', GEMMS),
    'mm_no_transpose': ('probe.cu', ('tiled_matmul_int8',)),
}
# Variants of the bandwidth kernels, name: ((text, its stand-in), ...).
# Each computes the same result as the source.
_CARRY = '      const E a = hmax(p), b = hmax(p + row);\n'
_SHFL = """template <typename E>
__device__ __forceinline__ E shfl_up(E v, int d) {
  if constexpr (sizeof(E) < 4) {
    return static_cast<E>(__shfl_up_sync(~0u, unsigned{v}, d));
  } else {
    uint32_t w[sizeof(E) / 4];
    memcpy(w, &v, sizeof(E));
    for (auto& x : w) x = __shfl_up_sync(~0u, x, d);
    memcpy(&v, w, sizeof(E));
    return v;
  }
}

"""
BW_VARIANTS: dict[str, tuple[tuple[str, str], ...]] = {
    # The left column from the neighbouring lane, cv lanes away, not a
    # second read from L1; lanes below cv (every lane when cv >= 32, where
    # the shuffle's offset wraps) load it.
    'pool_shuffle': (
        ('// Grid: x = image * chunks', _SHFL + '// Grid: x = image * chunks'),
        ('    if (ox > 0 && live) left = __ldg(p - cv);\n',
         '    left = shfl_up(right, cv);\n'
         '    if (static_cast<int>(threadIdx.x % 32) < cv)\n'
         '      left = ox > 0 && live ? __ldg(p - cv) : lo;\n')),
    'pool_rows_4': (('constexpr int kPoolRows = 8;',
                     'constexpr int kPoolRows = 4;'),),
    'pool_rows_16': (('constexpr int kPoolRows = 8;',
                      'constexpr int kPoolRows = 16;'),),
    # Row 2oy-1 read again for every output row: three rows, not two.
    'pool_no_carry': ((_CARRY, '      if (oy > oy0) carry = hmax(p - row);\n'
                       + _CARRY),),
    # Registers capped so that 6 blocks of 256 threads fit an SM.
    'pool_6_blocks': (('__launch_bounds__(kPoolMaxThreads)',
                       '__launch_bounds__(kPoolMaxThreads, 6)'),),
    # At most 4 bytes a load and store (bf16 pairs, single floats).
    'pool_4_byte_loads': (('  int v = 16;\n', '  int v = 4;\n'),),
    'add_2_vectors': (('constexpr int kAddVecs = 1;',
                       'constexpr int kAddVecs = 2;'),),
    'add_4_vectors': (('constexpr int kAddVecs = 1;',
                       'constexpr int kAddVecs = 4;'),),
    'add_128_threads': (('constexpr int kAddThreads = 256;',
                         'constexpr int kAddThreads = 128;'),),
    # torch.add's geometry on sm_90: 128 threads, 8 floats a thread.
    'add_2_vectors_128_threads': (
        ('constexpr int kAddVecs = 1;', 'constexpr int kAddVecs = 2;'),
        ('constexpr int kAddThreads = 256;',
         'constexpr int kAddThreads = 128;')),
    # Streaming cache hints at no size, or at every size.
    'add_hints_never': (('constexpr long long kHintBytes = 50LL << 20;',
                         'constexpr long long kHintBytes = 0;'),),
    'add_hints_always': (('constexpr long long kHintBytes = 50LL << 20;',
                          'constexpr long long kHintBytes = 1LL << 62;'),),
    # One or four waves of resident blocks walking the tiles grid-stride.
    'add_one_wave': (('constexpr int kAddWaves = 0;',
                      'constexpr int kAddWaves = 1;'),),
    'add_4_waves': (('constexpr int kAddWaves = 0;',
                     'constexpr int kAddWaves = 4;'),),
}
# The source each part's variants edit: a variant's name starts with its
# part.
BW_FILES = {'pool': 'pool.cu', 'add': 'probe.cu'}
PARTS = ('conv', 'planes', 'gemm', 'pool', 'add')
POOL_SHAPE = (128, 112, 112, 64)    # the serving stem map
ADD_SHAPES = ((1024, 256), (16384, 4096))
# (N, H=W, C, O), 3x3, stride 1, padding 1: the layers' repeated convs.
SHAPES = ((128, 56, 64, 64), (128, 28, 128, 128), (128, 14, 256, 256),
          (128, 7, 512, 512))
GEMM_SHAPE = (6272, 4608, 512)      # xnor_gemm (M, K, N): layer4, batch 128
MATMUL_SHAPE = (4096, 4096, 4096)   # tiled_matmul (M, K, N): the probes'
OUT_DIR = _build.BUILD_ROOT / 'variants'
ITERS = 20  # timed calls per reading
# Sources before the single-plane producer was folded into the k-plane
# one exported it as qtt_pack_threshold_signs_*.
_SINGLE_PACK_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
SIGNATURES = {'xnor': {**B._SIGNATURES, **G._SIGNATURES,
                       'qtt_pack_threshold_signs_bf16': _SINGLE_PACK_SIG},
              'probe': PK._SIGNATURES, 'pool': P._SIGNATURES}


def variant_source(name: str, src: str,
                   table: Optional[dict] = None) -> Optional[str]:
    """`src` with knock-out `name` of `table` (KNOCKOUTS by default)
    applied, or None when one of its texts does not occur in `src`
    exactly once (a stale knock-out)."""
    for old, new in (KNOCKOUTS if table is None else table)[name]:
        if src.count(old) != 1:
            return None
        src = src.replace(old, new)
    return src


def lib_file(variant: str, stem: str) -> Path:
    """Where variant `variant` of csrc/<stem>.cu is built: a directory
    of its own, holding its copy of every source."""
    return OUT_DIR / variant / stem / f'lib{stem}.so'


def build_all(baselines: dict[str, Optional[str]], parts: tuple[str, ...]
              ) -> dict[str, dict[str, ctypes.CDLL]]:
    """Compile every live variant of `parts` at once, each in its own
    copy of csrc/; returns {variant: {'xnor', 'probe' or 'pool':
    library}}. 'kernel' is this tree's sources, 'baseline' the ones
    `baselines` names by stem."""
    csrc = {f.name: f.read_text() for f in sorted(_build.CSRC.glob('*.cu*'))}
    stems = {'conv': ('xnor',), 'planes': ('xnor',), 'gemm': ('xnor', 'probe'),
             'pool': ('pool',), 'add': ('probe',)}
    jobs: dict[tuple[str, str], dict[str, str]] = {
        ('kernel', stem): csrc for part in parts for stem in stems[part]}
    stale = []
    for name in KNOCKOUTS if 'conv' in parts else ():
        text = variant_source(name, csrc['xnor.cu'])
        if text is None:
            stale.append(('conv_knockout', name))
        elif name != 'kernel':
            jobs[(name, 'xnor')] = {**csrc, 'xnor.cu': text}
    for name in PLANES_VARIANTS if 'planes' in parts else ():
        text = variant_source(name, csrc['xnor.cu'], PLANES_VARIANTS)
        if text is None:
            stale.append(('planes_variant', name))
        else:
            jobs[(name, 'xnor')] = {**csrc, 'xnor.cu': text}
    for name, (fname, kernels) in (WG_TARGETS.items() if 'gemm' in parts
                                   else ()):
        text = variant_source(name, csrc[fname], WG_KNOCKOUTS)
        if text is None:
            stale.append(('wg_knockout', name))
            continue
        for stem in {'xnor' if k == 'xnor_gemm' else 'probe'
                     for k in kernels}:
            jobs[(name, stem)] = {**csrc, fname: text}
    for name in BW_VARIANTS:
        part = name.split('_')[0]
        if part not in parts:
            continue
        fname = BW_FILES[part]
        text = variant_source(name, csrc[fname], BW_VARIANTS)
        if text is None:
            stale.append(('bw_variant', name))
        else:
            jobs[(name, fname[:-3])] = {**csrc, fname: text}
    for stem, path in baselines.items():
        if path and ('kernel', stem) in jobs:
            jobs[('baseline', stem)] = {**csrc,
                                        f'{stem}.cu': Path(path).read_text()}
    for probe, name in stale:
        common.record(probe, torch.device('cuda'), variant=name, stale=True)
    procs = {}
    for (name, stem), files in jobs.items():
        d = lib_file(name, stem).parent
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            (d / fname).write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, '-o',
               str(lib_file(name, stem)), str(d / f'{stem}.cu')]
        procs[(name, stem)] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs: dict[str, dict[str, ctypes.CDLL]] = collections.defaultdict(dict)
    for (name, stem), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for variant {name} ({stem}.cu):'
                               f'\n{log}')
        lib = ctypes.CDLL(str(lib_file(name, stem)))
        for sym, argtypes in SIGNATURES[stem].items():
            if hasattr(lib, sym):  # an older source may lack a query
                getattr(lib, sym).argtypes = argtypes
                getattr(lib, sym).restype = ctypes.c_int
        libs[name][stem] = lib
    return dict(libs)


def _listing(lib: str) -> dict[str, list[tuple[str, str]]]:
    """{SASS function name: its lines in order, an instruction as (opcode,
    BRA target or '') and a label as ('', label)} of a built library. An
    instruction's address is a label too (`0x<hex>`), since a branch
    names its target by label or by address."""
    nvcc = Path(_build.nvcc_path())
    sass = subprocess.run([str(nvcc.with_name('cuobjdump')), '-sass', lib],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for f in sass.split('Function : ')[1:]:
        lines = []
        for line in f.split('\n')[1:]:
            label = re.match(r'\s*(\.L_x_\d+):', line)
            op = re.search(r'/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?'
                           r'([A-Z][A-Z0-9]*)(.*)', line)
            if label:
                lines.append(('', label.group(1)))
            elif op:
                lines.append(('', hex(int(op.group(1), 16))))
                target = re.search(r'`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b',
                                   op.group(3).split(';')[0])
                if op.group(2) != 'BRA' or target is None:
                    target = ''
                else:
                    target = target.group(1) or hex(int(target.group(2), 16))
                lines.append((op.group(2), target))
        out[f.split('\n')[0].strip()] = lines
    return out


def _functions(lib: str) -> dict[str, list[str]]:
    """{SASS function name: its opcodes} of a built library."""
    return {name: [op for op, _ in lines if op]
            for name, lines in _listing(lib).items()}


def _stage(lines: list[tuple[str, str]]) -> Optional[list[str]]:
    """The opcodes of the loop around a kernel's MMAs (one stage: its
    barrier, loads, any expansion outside the k-steps, and the k-steps),
    from the label the first backward branch after the last IMMA jumps to
    through that branch; None where there is no such branch."""
    ops = [(op, target) for op, target in lines if op]
    at, labels = 0, {}
    for op, name in lines:
        if op:
            at += 1
        else:
            labels[name] = at
    imma = [i for i, (op, _) in enumerate(ops) if op == 'IMMA']
    for i in range(imma[-1] + 1, len(ops)):
        start = labels.get(ops[i][1]) if ops[i][1] else None
        if start is not None and start <= imma[0]:
            return [op for op, _ in ops[start:i + 1]]
    return None


def sass_mix(lib: str, kernel: str = 'xnor_conv2d_kernel',
             instance: Optional[tuple[int, int, int, int]] = None
             ) -> dict[str, Any]:
    """Opcode counts of a bf16 conv kernel's SASS: from its first MMA to
    its last (the k-steps of one unrolled stage of kKS words) and over
    the whole stage loop (`stage`: with its barriers, loads and any
    expansion outside the k-steps). `instance` (ga, pa, gw, pw) picks
    the multi-plane kernel's template for that layout (the ls-1 conv's
    by default); the *_per_word counts are per warp and word."""
    mark = ''
    if instance is not None:
        ga, pa, _, pw = instance
        mark = f'Li{1 if pa == 2 else min(ga, 3)}ELi{pa}ELi{pw}E'
    lines = next(lines for name, lines in _listing(lib).items()
                 if kernel in name and 'bfloat16' in name and mark in name)
    ops = [op for op, _ in lines if op]
    mma = [i for i, op in enumerate(ops) if op == 'IMMA']
    window = collections.Counter(ops[mma[0]:mma[-1] + 1])
    stage = _stage(lines)
    words = 8  # kKS
    return dict(kernel=kernel, instance=instance,
                instructions=sum(window.values()), imma=window['IMMA'],
                per_word=sum(window.values()) / words,
                imma_per_word=window['IMMA'] / words,
                stage_per_word=None if stage is None else len(stage) / words,
                top=dict(window.most_common(8)),
                stage_top=None if stage is None else dict(
                    collections.Counter(stage).most_common(10)))


def gemm_sass(lib: str) -> list[dict[str, Any]]:
    """Per GEMM kernel of a library (xnor_gemm, tiled_matmul): its
    instruction count and its tensor-core and TMA opcodes (HGMMA, IGMMA:
    wgmma; HMMA, IMMA: mma.sync; UTMALDG: TMA loads)."""
    rows = []
    for name, ops in _functions(lib).items():
        if 'xnor_gemm' not in name and 'tiled_matmul' not in name:
            continue
        count = collections.Counter(ops)
        rows.append(dict(function=name, instructions=len(ops), **{
            op.lower(): count[op]
            for op in ('HGMMA', 'IGMMA', 'HMMA', 'IMMA', 'UTMALDG')}))
    return rows


def knockouts(libs: dict[str, dict[str, ctypes.CDLL]],
              dev: torch.device) -> None:
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
            if 'xnor' not in libs.get(name, {}):
                continue
            got = torch.empty_like(want)
            args = [_build.ptr(v) for v in (x, w, vx, vw, bias, got)] + [
                _build.ptr(None)] * 6 + [
                n, hw, hw, c // 32, c, o, hw, hw, 3, 3, 1, 1, 1,
                _build.stream(x)]
            lib = libs[name]['xnor']
            ms = common.card_ms(lambda: lib.qtt_xnor_conv2d_bf16(*args),
                                ITERS)
            common.record('conv_knockout', dev, variant=name,
                          shape=[n, hw, hw, c, o], ms=ms,
                          equal=bool(torch.equal(got, want)))


def gemm_calls(dev: torch.device
               ) -> dict[str, tuple[Callable, torch.Tensor, torch.Tensor]]:
    """{GEMM kernel: (lib -> its bare launch, its output, the twin's)} at
    GEMM_SHAPE and MATMUL_SHAPE, on inputs made from fixed seeds."""
    m, k, n = GEMM_SHAPE
    w = k // 32
    a = common.randint(-2 ** 31, 2 ** 31 - 1, (m, w), dev, torch.int32, 3)
    bt = common.randint(-2 ** 31, 2 ** 31 - 1, (w, n), dev, torch.int32, 4)
    vx = torch.rand(m, device=dev) + 0.1
    vw = torch.rand(n, device=dev) + 0.1
    out = torch.empty(m, n, device=dev)
    calls = {'xnor_gemm': (
        lambda lib: launcher(lib['xnor'].qtt_xnor_gemm, (a, bt, vx, vw, out),
                             (m, w, n, k, _build.stream(a))),
        out, G.xnor_gemm_plain(a, bt, vx, vw, k))}
    mm, kk, nn = MATMUL_SHAPE
    for dt, entry in ((torch.bfloat16, 'qtt_tiled_matmul_bf16'),
                      (torch.int8, 'qtt_tiled_matmul_s8')):
        if dt == torch.int8:
            x = common.randint(-128, 128, (mm, kk), dev, dt, 5)
            y = common.randint(-128, 128, (kk, nn), dev, dt, 6)
        else:
            x = common.randint(-8, 9, (mm, kk), dev, dt, 5)
            y = common.randint(-8, 9, (kk, nn), dev, dt, 6)
        o = torch.empty(mm, nn, device=dev, dtype=dt)
        name = 'tiled_matmul_' + ('int8' if dt == torch.int8 else 'bf16')
        calls[name] = (
            lambda lib, e=entry, x=x, y=y, o=o: launcher(
                getattr(lib['probe'], e), (x, y, o),
                (mm, nn, kk, _build.stream(x))),
            o, PK.tiled_matmul_plain(x, y))
    return calls


def wg_knockouts(libs: dict[str, dict[str, ctypes.CDLL]],
                 dev: torch.device) -> None:
    calls = gemm_calls(dev)
    for name, kernels in [('kernel', GEMMS)] + [
            (n, t[1]) for n, t in WG_TARGETS.items()]:
        if name not in libs:
            continue
        for kname in kernels:
            make, got, want = calls[kname]
            fn = make(libs[name])
            ms = common.card_ms(fn, ITERS)
            torch.cuda.synchronize()
            common.record('wg_knockout', dev, variant=name, kernel=kname,
                          ms=ms, equal=bool(torch.equal(got, want)))


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


def planes_captured(dev: torch.device, x_quant: str, w_quant: str,
                    options: dict, batch: int = 128, seed: int = 0) -> list:
    """(conv, input) of each QuantConv2d in one bf16 forward of the seeded
    ResNet-18 XNOR of a multi-plane phase (EMA scales, folded)."""
    model = models.seeded_model(models.bench_resnet18, x_quant, w_quant,
                                dev, seed, moving_average_mode='eval_only',
                                **options)
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


def planes_calls(lib: ctypes.CDLL, seen: list
                 ) -> tuple[list[Callable[[], int]], Callable[[], list[str]]]:
    """The multi-plane conv's bare launch of `lib` (bf16 out) at each
    captured conv, on the words of the plain producer, and a check that
    names every output unequal to the plain twin's."""
    convs, checks = [], []
    for i, (conv, xin) in enumerate(seen):
        n, h, w, c = xin.shape
        k = B.sign_planes(conv.x_quant)
        xg = 2 if conv.x_quant == 'ls-T' else 1
        wp = conv.w_packed.contiguous()
        wg = 2 if conv.w_quant == 'ls-T' and wp.shape[0] == 2 else 1
        words = B.pack_sign_planes_plain(xin, k, conv.x_va, conv.x_thresh,
                                         conv.x_flip)
        vx = conv.x_quantizer(xin)[:k // xg].float().contiguous()
        vw = conv.w_scales[:wp.shape[0] // wg].float().contiguous()
        bias = (None if conv.bias is None
                else conv.bias.to(torch.bfloat16).contiguous())
        kk, s, p = wp.shape[1], conv.stride, conv.padding
        oh, ow = (h + 2 * p - kk) // s + 1, (w + 2 * p - kk) // s + 1
        o = wp.shape[-1]
        out = torch.empty(n, oh, ow, o, dtype=torch.bfloat16,
                          device=xin.device)
        convs.append(launcher(
            lib.qtt_xnor_conv2d_planes_bf16,
            (words, wp, vx, vw, bias, out) + NO_TAIL,
            (n, h, w, wp.shape[-2], c, o, oh, ow, kk, kk, s, p, p, k // xg,
             xg, wp.shape[0] // wg, wg, _build.stream(xin))))
        want = B.xnor_conv2d_planes_plain(
            words, wp, vx, vw, bias, in_channels=c, x_group=xg, w_group=wg,
            stride=s, padding=p, out_dtype=torch.bfloat16)
        checks.append((f'xnor_conv2d_planes {i}', out, want))

    def unequal() -> list[str]:
        status = [fn() for fn in convs]
        torch.cuda.synchronize()
        if any(status):
            return [f'CUDA status {status}']
        return [what for what, got, want in checks
                if not torch.equal(got, want)]
    return convs, unequal


def planes_occupancy(libs: dict[str, dict[str, ctypes.CDLL]],
                     dev: torch.device) -> None:
    """Registers a thread and blocks an SM of the ls-1 conv and the
    PLANES_INSTANCES (bf16 out) in every library that reports them."""
    for name, stems in libs.items():
        lib = stems.get('xnor')
        if lib is None or not hasattr(lib, 'qtt_xnor_conv2d_occupancy'):
            continue
        for inst in ((1, 1, 1, 1),) + PLANES_INSTANCES:
            regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
            status = lib.qtt_xnor_conv2d_occupancy(
                0, *inst, 0, ctypes.byref(regs), ctypes.byref(blocks))
            common.record('conv_occupancy', dev, variant=name,
                          instance=list(inst), status=status,
                          registers=regs.value, blocks_per_sm=blocks.value)


def planes_variants(libs: dict[str, dict[str, ctypes.CDLL]],
                    dev: torch.device) -> None:
    """Each PLANES_VARIANTS build and the source as it is, checked equal
    to the twin and timed (card ms, summed over a forward's 16 convs) on
    each phase of PLANES_PHASES, in the order kernel, variants, kernel."""
    names = [n for n in PLANES_VARIANTS if n in libs]
    for phase, xq, wq, options in PLANES_PHASES:
        with torch.inference_mode():
            seen = planes_captured(dev, xq, wq, options)
            calls = {name: planes_calls(libs[name]['xnor'], seen)
                     for name in ['kernel'] + names}
        for name, (_, unequal) in calls.items():
            bad = unequal()
            if bad:
                raise AssertionError(f'{name} differs from the twin: {bad}')
        for rnd, name in enumerate(['kernel'] + names + ['kernel']):
            common.record('planes_variant', dev, variant=name, phase=phase,
                          round=rnd, launches=len(calls[name][0]),
                          card_ms=sum(common.card_ms(f, ITERS)
                                      for f in calls[name][0]))


# A conv launch's tail pointers (residual, BN mean, mul, bias, slopes):
# none.
NO_TAIL = (None,) * 6


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
        single = getattr(lib, 'qtt_pack_threshold_signs_bf16', None)
        if single is not None:
            packs.append(launcher(single, (xin, thresh, flip, words),
                                  (n * h * w, c, wc, _build.stream(xin))))
        else:
            packs.append(launcher(
                lib.qtt_pack_sign_planes_bf16,
                (xin, thresh, flip, None, words),
                (n * h * w, c, wc, 1, h * w, _build.stream(xin))))
        want_words = B.pack_sign_planes_plain(xin, 1, None, thresh, flip)[0]
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
            lib.qtt_xnor_conv2d_bf16,
            (want_words, wp, vx, vw, bias, out) + NO_TAIL,
            (n, h, w, wc, c, o, oh, ow, 3, 3, s, 1, 1, _build.stream(xin))))
        want_out = B.xnor_conv2d_plain(want_words, wp, vx, vw, bias,
                                       in_channels=c, stride=s, padding=1,
                                       out_dtype=torch.bfloat16)
        checks += [(f'producer {i}', words, want_words),
                   (f'xnor_conv2d {i}', out, want_out)]

    def unequal() -> list[str]:
        status = [fn() for fn in packs + convs]
        torch.cuda.synchronize()
        if any(status):
            return [f'CUDA status {status}']
        return [what for what, got, want in checks
                if not torch.equal(got, want)]
    return packs, convs, unequal


def _rounds(fns: dict[str, list[Callable[[], Any]]], dev: torch.device,
            order: tuple[str, ...] = ('baseline', 'current', 'current',
                                      'baseline'),
            **kv: Any) -> None:
    """Times each list of launches of `fns` (summed) in `order`, by
    default baseline, current, current, baseline, on the card timer and
    back to back."""
    for rnd, name in enumerate(order):
        card = sum(common.card_ms(f, ITERS) for f in fns[name])
        back = sum(common.card_ms(f, ITERS, head_start_ms=0)
                   for f in fns[name])
        common.record('xnor_baseline', dev, variant=name, round=rnd,
                      launches=len(fns[name]), card_ms=card, call_ms=back,
                      **kv)


def baseline_vs_current(libs: dict[str, dict[str, ctypes.CDLL]],
                        dev: torch.device, parts: tuple[str, ...]) -> None:
    base = libs['baseline']
    for part in ('pool', 'add'):
        stem = BW_FILES[part][:-3]
        if part not in parts or stem not in base:
            continue
        for case, (make, got, want, library) in bw_calls(part, dev).items():
            fns = {'baseline': [make(base)], 'current': [make(libs['kernel'])]}
            for name, (fn,) in fns.items():
                got.zero_()
                _equal_or_raise(f'{name} {case}', fn, got, want)
            # The library call in the same alternation.
            _rounds({**fns, 'library': [library]}, dev, kernel=case,
                    order=('baseline', 'current', 'library', 'library',
                           'current', 'baseline'))
    if 'xnor' in base and 'conv' in parts:
        with torch.inference_mode():
            seen = captured_convs(dev)
            calls = {name: lib_calls(libs[lib]['xnor'], seen)
                     for name, lib in (('baseline', 'baseline'),
                                       ('current', 'kernel'))}
        for name, (_, _, unequal) in calls.items():
            bad = unequal()
            if bad:
                raise AssertionError(f'{name} xnor.cu differs from the '
                                     f'twins: {bad}')
        for k, kname in enumerate(('producer', 'xnor_conv2d')):
            _rounds({name: c[k] for name, c in calls.items()}, dev,
                    kernel=kname)
    if 'xnor' in base and 'planes' in parts:
        for phase, xq, wq, options in PLANES_PHASES:
            with torch.inference_mode():
                seen = planes_captured(dev, xq, wq, options)
                calls = {name: planes_calls(libs[lib]['xnor'], seen)
                         for name, lib in (('baseline', 'baseline'),
                                           ('current', 'kernel'))}
            for name, (_, unequal) in calls.items():
                bad = unequal()
                if bad:
                    raise AssertionError(f'{name} xnor.cu differs from the '
                                         f'twin in {phase}: {bad}')
            _rounds({name: c[0] for name, c in calls.items()}, dev,
                    kernel='xnor_conv2d_planes', phase=phase)
    if 'gemm' not in parts:
        return
    gemms = gemm_calls(dev)
    for kname, (make, got, want) in gemms.items():
        stem = 'xnor' if kname == 'xnor_gemm' else 'probe'
        if stem not in base:
            continue
        fns = {'baseline': [make(base)], 'current': [make(libs['kernel'])]}
        for name, (fn,) in fns.items():
            status = fn()
            torch.cuda.synchronize()
            if status or not torch.equal(got, want):
                raise AssertionError(f'{name} {kname} differs from its twin '
                                     f'(status {status})')
        _rounds(fns, dev, kernel=kname)


def bw_calls(part: str, dev: torch.device
             ) -> dict[str, tuple[Callable, torch.Tensor, torch.Tensor,
                                  Callable[[], Any]]]:
    """{case: (lib -> its bare launch, its output, the twin's, the
    library call)} of the pool (the stem map, bf16 and f32) or the add
    (ADD_SHAPES), on inputs made from fixed seeds."""
    calls = {}
    if part == 'pool':
        for dt, entry in ((torch.bfloat16, 'qtt_max_pool_3x3_s2_p1_bf16'),
                          (torch.float32, 'qtt_max_pool_3x3_s2_p1_f32')):
            x = common.randn(POOL_SHAPE, dev, dt, seed=7)
            n, h, w, c = POOL_SHAPE
            out = torch.empty(n, h // 2, w // 2, c, device=dev, dtype=dt)
            calls[f'pool {str(dt)[6:]}'] = (
                lambda lib, e=entry, x=x, out=out: launcher(
                    getattr(lib['pool'], e), (x, out),
                    (*POOL_SHAPE, 1, _build.stream(x))),
                out, max_pool2d(x, kernel_size=3, stride=2, padding=1),
                lambda x=x: F.max_pool2d(common.nchw(x), 3, 2, 1))
        return calls
    for i, shape in enumerate(ADD_SHAPES):
        x = common.randn(shape, dev, seed=8 + i)
        y = common.randn(shape, dev, seed=10 + i)
        out = torch.empty_like(x)
        calls[f'add {shape}'] = (
            lambda lib, x=x, y=y, out=out: launcher(
                lib['probe'].qtt_add_f32, (x, y, out),
                (x.numel(), 1, _build.stream(x))),
            out, PK.add_plain(x, y), lambda x=x, y=y: torch.add(x, y))
    return calls


def _equal_or_raise(what: str, fn: Callable[[], int], got: torch.Tensor,
                    want: torch.Tensor) -> None:
    status = fn()
    torch.cuda.synchronize()
    if status or not torch.equal(got, want):
        raise AssertionError(f'{what} differs from its twin (status '
                             f'{status})')


def bw_variants(libs: dict[str, dict[str, ctypes.CDLL]], part: str,
                dev: torch.device) -> None:
    """Each variant of `part` and the source as it is, timed on the card
    and checked equal to the twin, with the library call and (add) an
    empty launch beside them."""
    stem = BW_FILES[part][:-3]
    names = ['kernel'] + [n for n in BW_VARIANTS
                          if n.startswith(part) and n in libs]
    for case, (make, got, want, library) in bw_calls(part, dev).items():
        for name in names:
            fn = make(libs[name])
            got.zero_()
            _equal_or_raise(f'{name} {case}', fn, got, want)
            common.record('bw_variant', dev, variant=name, source=stem,
                          case=case, card_ms=common.card_ms(fn, ITERS))
        common.record('bw_library', dev, case=case,
                      card_ms=common.card_ms(library, ITERS),
                      call_ms=common.card_ms(library, ITERS,
                                             head_start_ms=0))
    if part == 'add':
        def empty() -> None:
            torch.cuda._sleep(0)
        common.record('empty_launch', dev,
                      card_ms=common.card_ms(empty, ITERS),
                      call_ms=common.card_ms(empty, ITERS, head_start_ms=0))


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--baseline', default=None,
                    help='an xnor.cu to time against this tree\'s')
    ap.add_argument('--baseline-probe', default=None,
                    help='a probe.cu to time against this tree\'s')
    ap.add_argument('--baseline-pool', default=None,
                    help='a pool.cu to time against this tree\'s')
    ap.add_argument('--parts', default=','.join(PARTS),
                    help=f'comma-separated, of {PARTS} (default: all)')
    ap.add_argument('--out', default=None, help='also append the JSON '
                    'lines here')
    args = ap.parse_args(argv)
    parts = tuple(p for p in PARTS if p in args.parts.split(','))
    if set(args.parts.split(',')) - set(PARTS):
        ap.error(f'--parts takes {PARTS}, got {args.parts}')
    if not torch.cuda.is_available():
        print('xnor_variants: no CUDA device', file=sys.stderr)
        return 2
    common._out_path = args.out
    dev = torch.device('cuda')
    libs = build_all({'xnor': args.baseline, 'probe': args.baseline_probe,
                      'pool': args.baseline_pool}, parts)
    if 'conv' in parts:
        common.record('conv_sass', dev, **sass_mix(
            str(lib_file('kernel', 'xnor'))))
        knockouts(libs, dev)
    if 'planes' in parts:
        for inst in PLANES_INSTANCES:
            common.record('planes_sass', dev, **sass_mix(
                str(lib_file('kernel', 'xnor')), 'xnor_conv2d_planes_kernel',
                inst))
        planes_occupancy(libs, dev)
        planes_variants(libs, dev)
    if 'gemm' in parts:
        for name in ('kernel', 'baseline'):
            for stem in sorted(set(libs.get(name, {})) & {'xnor', 'probe'}):
                for row in gemm_sass(str(lib_file(name, stem))):
                    common.record('gemm_sass', dev, variant=name, **row)
        wg_knockouts(libs, dev)
    for part in parts:
        if part in BW_FILES:
            bw_variants(libs, part, dev)
    if 'baseline' in libs:
        baseline_vs_current(libs, dev, parts)
    return 0


if __name__ == '__main__':
    sys.exit(main())
