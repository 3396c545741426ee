"""Plain float32 ResNets of the least-squares binary quantization paper:
the serving forward of their XNOR form and the KD train step of their
recipes, over basic blocks (ResNet-18) or bottlenecks (ResNet-50, He et
al., CVPR 2016, Table 1, the stride on the 3x3 conv as torchvision's
resnet50 puts it).

Definitions (Pouransari et al., CVPR-W 2020, and the recipes of
apple/ml-quant's examples/imagenet):

- XNOR block (XNOR-Net ordering, Bi-Real double shortcut): h =
  PReLU(qconv1(BN1(x))) + shortcut(x); out = PReLU(qconv2(BN2(h))) + h,
  the shortcut a 1x1 conv with bias and a BN where width or resolution
  changes, else the identity. Without the double shortcut: h =
  PReLU1(qconv1(BN1(x))); out = PReLU2(qconv2(BN2(h)) + shortcut(x)).
- XNOR bottleneck (block `xnor_bottleneck`, stride s, planes p): h1 =
  PReLU1(qconv1(BN1(x))), a 1x1 conv to p; h2 = PReLU2(qconv2(BN2(h1))),
  a 3x3 conv of stride s; y = qconv3(BN3(h2)), a 1x1 conv to 4p; out =
  PReLU3(y + shortcut(x)), the shortcut as above where s != 1 or the
  width changes.
- Teachers, fp: the regular block is conv -> BN -> ReLU, conv -> BN,
  then ReLU after the sum with the shortcut (a 1x1 conv without bias and
  a BN, or the identity); the regular bottleneck (`regular_bottleneck`)
  is 1x1 conv -> BN -> ReLU, 3x3 conv of stride s -> BN -> ReLU, 1x1
  conv to 4p -> BN, then ReLU after the sum.
- qconv: the activation clamped to [-alpha, alpha], then quantized per
  sample; the weight quantized per out-channel; a conv of the two, zero
  padded by (k - 1) // 2 for a k x k kernel, plus the conv's bias.
- ls-1: x_q = v * sign(x), v = mean |x| (eq. 4). ls-2: x_q = v1 * b1 + v2
  * sign(x - v1 * b1), b1 = sign(x), v1 the 2-bit optimum, v2 = mean
  |x - v1 * b1|. sign(0) = +1. A served model reads its scales from the
  EMA that training tracked; training solves each sample's own.
- The 2-bit optimum by the recipe's `solver_mode: lloyd`: 1-D 2-means on
  the magnitudes of every 3rd element of the sample (in NHWC order, the
  layout the recipes train in), 12 Lloyd steps from the starts 0.5 *
  mean, mean and (mean + max) / 2, an empty cluster keeping the
  threshold, then the start whose 2-bit cost sum (r - v2)^2, r = |a| -
  v1, is least (the first on a tie).
- Gradients pass the sign where |x| <= 1 (the clipped straight-through
  estimator), and no gradient reaches a solved scale.
- Training BN normalizes with the batch's mean and biased variance over
  N, H, W. The KD loss at temperature T is T^2 * KL(softmax(t / T) ||
  softmax(s / T)), summed over classes, averaged over the batch, against
  a frozen fp teacher (the regular blocks above) in train mode. Adam
  (betas 0.9, 0.999, eps 1e-8, bias-corrected), its learning rate the
  recipe's linear_lr: lr0 - step / ((epochs - 1) * steps_per_epoch) *
  (lr0 + min_lr), floored at min_lr.

Departures, each below rounding: the variance is taken in two passes
(the recipes' flax takes E[x^2] - E[x]^2); the clamp passes a gradient
of 1 at exactly +-alpha (jnp.clip's tie gives 0.5).

The chain is held in the configuration's stated dtype (`eval_dtype`,
`train_dtype`, the teacher's dtype; `precision.chain`): a bf16 chain's
values are rounded to bf16 where the chain holds them (`Net`), and
their gradients too; a float32 chain rounds nothing. The controls of the
comparison (portbench/control.py) hand in a lower precision's rounding
instead.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from portbench.reference.precision import Round, chain, identity

State = dict[str, torch.Tensor]

BN_EPS = 1e-5
BUFFER_SUFFIXES = ('running_mean', 'running_var', 'w_vs', 'ema', 'ema_count')
_SKIP = 3
_LLOYD_ITERS = 12


def is_parameter(name: str) -> bool:
    """Whether a state leaf is trained (else it is a buffer)."""
    return not name.endswith(BUFFER_SUFFIXES)


class _SignSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x < 0, -1.0, 1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def sign(x: torch.Tensor) -> torch.Tensor:
    """sign with sign(0) = +1 and the clipped straight-through gradient."""
    return _SignSTE.apply(x)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """Each sample of an NCHW map as one detached float32 row, NHWC order."""
    return x.detach().permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()


def lloyd_v1(a: torch.Tensor) -> torch.Tensor:
    """The 2-bit optimum v1 of each row of magnitudes `a` (N, M) by
    1-D 2-means from three starts (module docstring)."""
    m = a.shape[1]
    a3 = a[:, None, :]
    total = a.sum(1, keepdim=True)
    mean = total / m
    v = torch.cat([0.5 * mean, mean, 0.5 * (mean + a.amax(1, keepdim=True))],
                  1)                                          # (N, 3)
    for _ in range(_LLOYD_ITERS):
        upper = a3 > v[:, :, None]
        n_hi = upper.sum(2).float()
        s_hi = (a3 * upper).sum(2)
        moved = 0.5 * ((total - s_hi) / (m - n_hi).clamp_min(1.0)
                       + s_hi / n_hi.clamp_min(1.0))
        v = torch.where((n_hi > 0) & (n_hi < m), moved, v)
    r = a3 - v[:, :, None]
    cost = (r * r).sum(2) - r.abs().sum(2) ** 2 / m
    return v.gather(1, cost.argmin(1, keepdim=True))[:, 0]


def solve_activation(scheme: str, x: torch.Tensor, solver: str
                     ) -> torch.Tensor:
    """(k, N) scales of each sample of x (NCHW), solved, detached."""
    rows = _rows(x)
    if scheme == 'ls-1':
        return rows.abs().mean(1)[None]
    if scheme == 'ls-2':
        if solver != 'lloyd':
            raise NotImplementedError(
                f'the reference solves ls-2 by lloyd only, not {solver!r}')
        v1 = lloyd_v1(rows[:, ::_SKIP].abs())
        resid = rows - v1[:, None] * torch.where(rows < 0, -1.0, 1.0)
        return torch.stack([v1, resid.abs().mean(1)])
    raise NotImplementedError(f'activation scheme {scheme!r}')


def quantize_activation(scheme: str, x: torch.Tensor, vs: torch.Tensor,
                        rnd: Round = identity) -> torch.Tensor:
    """x_q of x (NCHW) with (k, N) per-sample scales, in the chain's
    precision (`rnd` rounds each scale and each value computed)."""
    v1 = rnd(vs[0][:, None, None, None])
    b1 = sign(x)
    if scheme == 'ls-1':
        return v1 * b1
    if scheme == 'ls-2':
        v2 = rnd(vs[1][:, None, None, None])
        return rnd(v1 * b1 + v2 * sign(rnd(x - v1 * b1)))
    raise NotImplementedError(f'activation scheme {scheme!r}')


def quantize_weight(scheme: str, w: torch.Tensor) -> torch.Tensor:
    """w_q of an OIHW kernel: ls-1, v = mean |w| of each out-channel."""
    if scheme != 'ls-1':
        raise NotImplementedError(f'weight scheme {scheme!r}')
    v = w.detach().abs().mean((1, 2, 3))
    return v[:, None, None, None] * sign(w)


def _oihw(kernel_hwio: torch.Tensor) -> torch.Tensor:
    return kernel_hwio.permute(3, 2, 0, 1)


def _same_pad(kernel_hwio: torch.Tensor) -> int:
    """A binary conv's zero padding: (k - 1) // 2 for a k x k kernel."""
    return (kernel_hwio.shape[0] - 1) // 2


class Net:
    """One forward of a configuration's student or teacher over a state
    dict (the harness's names), in eval or train mode.

    `rnd` rounds to the chain's precision where the configuration's chain
    holds its values (identity for a float32 chain): the input, each
    op's output, the dense layers' weights and biases and the quantized
    operands, as a bf16 chain keeps them; sums run in float32 and round
    once, a conv's output and then its sum with the bias. Served (eval),
    the BN before a binary conv is folded into thresholds (`served`).
    The configuration's `block` names the blocks: a student's one of
    STUDENT_BLOCKS, a teacher's one of TEACHER_BLOCKS; any other raises.
    """

    STUDENT_BLOCKS = {'xnor': 'xnor_block',
                      'xnor_bottleneck': 'xnor_bottleneck'}
    TEACHER_BLOCKS = {'regular': 'regular_block',
                      'regular_bottleneck': 'regular_bottleneck'}

    def __init__(self, config: dict, state: State, train: bool,
                 teacher: bool = False, rnd: Round = identity,
                 solver: str = 'exact'):
        self.c, self.s, self.train = config, state, train
        self.rnd, self.solver = rnd, solver
        self.alpha = float(config['clamp'].get('alpha', float('inf')))
        blocks = self.TEACHER_BLOCKS if teacher else self.STUDENT_BLOCKS
        if config['block'] not in blocks:
            raise ValueError(
                f"the reference has no {'teacher' if teacher else 'student'}"
                f" block {config['block']!r}")
        self.block = getattr(self, blocks[config['block']])

    def bn(self, x: torch.Tensor, p: str) -> torch.Tensor:
        s = self.s
        if self.train:
            mean = x.mean((0, 2, 3), keepdim=True)
            var = ((x - mean) ** 2).mean((0, 2, 3), keepdim=True)
        else:
            mean = s[p + '.running_mean'][None, :, None, None]
            var = s[p + '.running_var'][None, :, None, None]
        y = (x - mean) * torch.rsqrt(var + BN_EPS)
        y = y * s[p + '.weight'][None, :, None, None]
        return self.rnd(y + s[p + '.bias'][None, :, None, None])

    def _bias(self, y: torch.Tensor, p: str) -> torch.Tensor:
        bias = self.s.get(p + '.bias')
        if bias is None:
            return y
        return self.rnd(y + self.rnd(bias)[None, :, None, None])

    def conv(self, x: torch.Tensor, p: str, stride: int, pad: int
             ) -> torch.Tensor:
        w = self.rnd(_oihw(self.s[p + '.kernel']))
        return self._bias(self.rnd(F.conv2d(x, w, None, stride, pad)), p)

    def qconv(self, x: torch.Tensor, p: str, stride: int) -> torch.Tensor:
        """The train form: clamp, quantize both operands, conv, bias."""
        c, kernel = self.c, self.s[p + '.kernel']
        a = torch.clamp(x, -self.alpha, self.alpha)
        w_q = quantize_weight(c['w_quant'], _oihw(kernel))
        vs = solve_activation(c['x_quant'], a, self.solver)
        x_q = quantize_activation(c['x_quant'], a, vs, self.rnd)
        y = F.conv2d(x_q, self.rnd(w_q), None, stride, _same_pad(kernel))
        return self._bias(self.rnd(y), p)

    def served(self, x: torch.Tensor, bn: str, p: str, stride: int
               ) -> torch.Tensor:
        """A served binary conv of the raw block input x, its BN folded
        into thresholds (the configuration's `fold`): for the eval affine
        BN(x) = a * (x - t), t = -(beta - mean * a) / a, the sign planes
        are s * sign(u), u = x - t, and for ls-2 s * sign(u - va * sign(u)),
        va = v1 / |a|, s = sign(a), with t and va held in the chain and u
        computed in it (the clamp's box check makes the clamp a no-op on
        the signs). One conv a pair of sign planes, each term scaled in
        float32 and rounded to the chain, summed in the chain, then the
        bias added in the chain (the int8 route's epilogue)."""
        c, s, rnd = self.c, self.s, self.rnd
        var = s[bn + '.running_var'].double() + BN_EPS
        scale = (s[bn + '.weight'].double() / var.sqrt()).float()
        thresh = -(s[bn + '.bias'] - s[bn + '.running_mean'] * scale) / scale
        flip = torch.where(scale >= 0, 1.0, -1.0)[None, :, None, None]
        ema = s[p + '.x_quantizer.ema']
        u = rnd(x - rnd(thresh)[None, :, None, None])
        p1 = torch.where(u < 0, -1.0, 1.0)
        planes = [(flip * p1, ema[0])]
        if c['x_quant'] == 'ls-2':
            va = rnd(ema[0] / scale.abs())[None, :, None, None]
            p2 = torch.where(rnd(u - va * p1) < 0, -1.0, 1.0)
            planes.append((flip * p2, ema[1]))
        elif c['x_quant'] != 'ls-1':
            raise NotImplementedError(f"activation scheme {c['x_quant']!r}")
        if c['w_quant'] != 'ls-1':
            raise NotImplementedError(f"weight scheme {c['w_quant']!r}")
        w, pad = _oihw(s[p + '.kernel']), _same_pad(s[p + '.kernel'])
        w_sign = torch.where(w < 0, -1.0, 1.0)
        w_scale = w.abs().mean((1, 2, 3))[None, :, None, None]
        y = None
        for plane, v in planes:
            term = rnd(F.conv2d(plane, w_sign, None, stride, pad)
                       * (v * w_scale))
            y = term if y is None else rnd(y + term)
        return self._bias(y, p)

    def prelu(self, x: torch.Tensor, p: str) -> torch.Tensor:
        slope = self.rnd(self.s[p + '.negative_slope'])
        return self.rnd(torch.where(x >= 0, x, slope * x))

    def shortcut(self, x: torch.Tensor, p: str, stride: int) -> torch.Tensor:
        if p + '.shortcut.conv.kernel' not in self.s:
            return x
        y = self.conv(x, p + '.shortcut.conv', stride, 0)
        return self.bn(y, p + '.shortcut.norm')

    def xnor_block(self, x: torch.Tensor, p: str, stride: int
                   ) -> torch.Tensor:
        h = self.prelu(self.bn_qconv(x, p, '1', stride), p + '.nonlin1')
        if not self.c.get('double_shortcut', False):
            h2 = self.bn_qconv(h, p, '2', 1)
            return self.prelu(self.rnd(h2 + self.shortcut(x, p, stride)),
                              p + '.nonlin2')
        h = self.rnd(h + self.shortcut(x, p, stride))
        h2 = self.bn_qconv(h, p, '2', 1)
        return self.rnd(self.prelu(h2, p + '.nonlin2') + h)

    def xnor_bottleneck(self, x: torch.Tensor, p: str, stride: int
                        ) -> torch.Tensor:
        h = self.prelu(self.bn_qconv(x, p, '1', 1), p + '.nonlin1')
        h = self.prelu(self.bn_qconv(h, p, '2', stride), p + '.nonlin2')
        y = self.bn_qconv(h, p, '3', 1)
        return self.prelu(self.rnd(y + self.shortcut(x, p, stride)),
                          p + '.nonlin3')

    def bn_qconv(self, x: torch.Tensor, p: str, n: str, stride: int
                 ) -> torch.Tensor:
        """BN then the binary conv: folded when served, else the train
        form."""
        if not self.train:
            return self.served(x, f'{p}.bn{n}', f'{p}.conv{n}', stride)
        return self.qconv(self.bn(x, f'{p}.bn{n}'), f'{p}.conv{n}', stride)

    def regular_block(self, x: torch.Tensor, p: str, stride: int
                      ) -> torch.Tensor:
        h = torch.relu(self.bn(self.conv(x, p + '.conv1', stride, 1),
                               p + '.bn1'))
        h = self.bn(self.conv(h, p + '.conv2', 1, 1), p + '.bn2')
        return torch.relu(self.rnd(h + self.shortcut(x, p, stride)))

    def regular_bottleneck(self, x: torch.Tensor, p: str, stride: int
                           ) -> torch.Tensor:
        h = torch.relu(self.bn(self.conv(x, p + '.conv1', 1, 0), p + '.bn1'))
        h = torch.relu(self.bn(self.conv(h, p + '.conv2', stride, 1),
                               p + '.bn2'))
        h = self.bn(self.conv(h, p + '.conv3', 1, 0), p + '.bn3')
        return torch.relu(self.rnd(h + self.shortcut(x, p, stride)))

    def __call__(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        c, l0 = self.c, self.c['layer0']
        x = self.rnd(x_nhwc.permute(0, 3, 1, 2).float())
        x = self.conv(x, 'conv1', l0['stride'], l0['padding'])
        x = torch.relu(self.bn(x, 'bn1'))
        mp = l0['maxpool']
        if mp['type'] == 'maxpool2d':
            x = F.max_pool2d(x, mp['kernel_size'], mp['stride'],
                             mp['padding'])
        for s, blocks in enumerate(c['num_blocks']):
            for b in range(blocks):
                x = self.block(x, f'layer{s + 1}_block{b}',
                               2 if (s > 0 and b == 0) else 1)
        x = self.rnd(x.mean((2, 3)))
        logits = self.rnd(x @ self.rnd(self.s['fc.kernel']))
        return self.rnd(logits + self.rnd(self.s['fc.bias'])).float()


def serve_logits(config: dict, state: State, x_nhwc: torch.Tensor,
                 rnd: Optional[Round] = None) -> torch.Tensor:
    """The served model's float32 logits of a batch (EMA scales, running
    statistics), without gradient; the chain held in the configuration's
    eval dtype unless `rnd` says otherwise."""
    rnd = rnd or chain(config['serve']['eval_dtype'])
    with torch.no_grad():
        return Net(config, state, train=False, rnd=rnd)(x_nhwc)


def kd_loss(student: torch.Tensor, teacher: torch.Tensor, t: float,
            rows: Optional[int] = None) -> torch.Tensor:
    """T^2 KL(softmax(teacher / T) || softmax(student / T)), summed over
    classes, averaged over the first `rows` rows (all by default)."""
    log_p = torch.log_softmax(teacher / t, 1)
    kl = (log_p.exp() * (log_p - torch.log_softmax(student / t, 1))).sum(1)
    kl = kl * (t * t)
    return kl[:rows].mean()


def linear_lr(train: dict, step: int) -> float:
    opt = train['optimization']
    lr0 = float(opt['optimizer']['lr'])
    min_lr = float(opt['lr_scheduler']['min_lr'])
    total = max((train['epochs'] - 1) * train['steps_per_epoch'], 1)
    return max(lr0 - step / total * (lr0 + min_lr), min_lr)


def train_steps(config: dict, student: State, teacher: State,
                batches: list[torch.Tensor], rnd: Optional[Round] = None,
                half_batch: bool = False,
                adam: Optional[tuple[State, State]] = None,
                first_step: int = 0) -> dict:
    """The recipe's KD steps, one a batch, from the given states, the
    student's chain in its train dtype and the teacher's in its own,
    unless `rnd` rounds both.

    The steps start from Adam's zero moments at step 0, or part-way
    through training from `adam`'s moments (exp_avg, exp_avg_sq by
    name) after `first_step` steps, which sets the schedule's lr and
    the bias corrections.

    Returns {'losses': [float a step], 'logits', 't_logits': [the
    student's and the teacher's float32 logits a step], 'grads': {name:
    the first step's gradient}, 'params': {name: the parameters after
    the last step}}. `half_batch` takes each loss's mean over the first
    half of the rows alone: a fault for the comparison's tests.
    """
    train = config['train']
    opt = train['optimization']['optimizer']
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    if opt['algorithm'] != 'adam' or float(opt.get('weight_decay', 0)):
        raise NotImplementedError('the reference steps Adam without decay')
    names = [n for n in student if is_parameter(n)]
    params = {n: student[n].detach().clone().requires_grad_(True)
              for n in names}
    state = {**{n: v for n, v in student.items() if not is_parameter(n)},
             **params}
    if adam is None:
        m = {n: torch.zeros_like(p) for n, p in params.items()}
        v = {n: torch.zeros_like(p) for n, p in params.items()}
    else:
        m = {n: adam[0][n].detach().clone() for n in names}
        v = {n: adam[1][n].detach().clone() for n in names}
    kd = train['kd']
    teacher_config = {**config, **train['teacher']}
    s_rnd = rnd or chain(train['train_dtype'])
    t_rnd = rnd or chain(train['teacher']['dtype'])
    out: dict = {'losses': [], 'logits': [], 't_logits': [], 'grads': None}
    for i, x in enumerate(batches):
        step = first_step + i
        logits = Net(config, state, train=True, rnd=s_rnd,
                     solver=train['solver_mode'])(x)
        with torch.no_grad():
            t_logits = Net(teacher_config, teacher, train=True,
                           teacher=True, rnd=t_rnd)(x)
        rows = x.shape[0] // 2 if half_batch else None
        loss = kd_loss(logits, t_logits, float(kd['temperature']), rows)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        out['losses'].append(float(loss.detach()))
        out['logits'].append(logits.detach())
        out['t_logits'].append(t_logits)
        if out['grads'] is None:
            out['grads'] = {n: g.detach().clone()
                            for n, g in zip(names, grads)}
        lr = linear_lr(train, step)
        t = step + 1
        with torch.no_grad():
            for n, g in zip(names, grads):
                m[n].mul_(beta1).add_(g, alpha=1 - beta1)
                v[n].mul_(beta2).addcmul_(g, g, value=1 - beta2)
                denom = (v[n] / (1 - beta2 ** t)).sqrt_().add_(eps)
                params[n].addcdiv_(m[n], denom, value=-lr / (1 - beta1 ** t))
        del logits, t_logits, loss, grads
    out['params'] = {n: p.detach() for n, p in params.items()}
    return out
