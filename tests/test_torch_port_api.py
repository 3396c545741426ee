"""The port's public API held to the JAX package's, name by name.

An AST walk of every `quant_tpu/` module and of its `quant_tpu_torch/`
counterpart (nothing is imported) checks that

- every public top-level name of a JAX module exists in the port's
  module (defined, assigned, imported, or served by a module
  `__getattr__`);
- every parameter of a JAX function, method or constructor is a
  parameter of the port's;
- every field of a flax module (or dataclass) is a parameter of the
  port class's `__init__` (its fields, for a dataclass);
- each package's `__all__` equals JAX's.

What the port deliberately does not take is listed once, in `JAX_ONLY`,
each entry with its reason; an entry that no longer names a gap (the
port has it now, or JAX no longer has it) fails the test. Stand-in
cases hold the walk itself: a copy of the port's sources with one name,
parameter or export taken out must show that gap.
"""

import ast
from pathlib import Path
from typing import Optional

import pytest

import chip_smoke

REPO = Path(__file__).resolve().parent.parent
JAX_ROOT = REPO / 'quant_tpu'
PORT_ROOT = REPO / 'quant_tpu_torch'

_FLAX_STATE = ('flax state: the port keeps variables in the nn.Module '
               'it applies')
_MODEL_DTYPE = ('set on QResNet/QLeNet5 (eval_dtype, train_dtype, '
                'bn_fold) or by the forward\'s out_dtype/bn_folded')
_TRAIN_MODE = 'the module\'s mode: model.train() is JAX\'s train=True'

# (module, name, parameter or field; None for a whole name) -> why the
# port does not take it.
JAX_ONLY: dict[tuple[str, str, Optional[str]], str] = {
    ('ops/binary_gemm.py', 'xnor_gemm', 'interpret'):
        'Pallas interpret mode; a wrapper runs its plain twin on CPU '
        'tensors',
    ('ops/pool.py', 'max_pool_3x3_s2_p1', 'interpret'):
        'Pallas interpret mode; a wrapper runs its plain twin on CPU '
        'tensors',
    ('ops/pool.py', 'max_pool_3x3_s2_p1', 'w_stage'):
        'Pallas: the width of the kernel\'s VMEM stage',
    ('ops/conv.py', 'conv2d', 'preferred_element_type'):
        'XLA accumulation type; the port computes in x\'s dtype',
    ('ops/conv.py', 'stem_conv_s2d', 'preferred_element_type'):
        'XLA accumulation type; the port computes in x\'s dtype',
    ('parallel/spatial.py', 'halo_exchange_conv2d',
     'preferred_element_type'):
        'XLA accumulation type; the port computes in x\'s dtype',
    ('train/engine.py', 'make_train_step', 'donate'):
        'XLA buffer donation',
    ('train/engine.py', 'train_epoch', 'assemble'):
        'jax.Array global assembly of per-host batches',
    ('train/engine.py', 'evaluate', 'assemble'):
        'jax.Array global assembly of per-host batches',
    ('utils/checkpoints.py', 'restore_checkpoint', 'abstract_target'):
        'orbax restore target',
    ('serving/worker.py', 'logger', None):
        'a logging handle, not API: the port\'s worker has no '
        'dense fallback to warn of',
    ('nn/export.py', 'export_packed_variables', 'variables'): _FLAX_STATE,
    ('nn/export.py', 'export_packed_variables', 'sample_input'):
        'flax shape inference: the port packs from the module\'s shapes',
    ('nn/export.py', 'fold_bn_into_packed', 'variables'): _FLAX_STATE,
    ('nn/export.py', 'calibrate_ema_scales', 'variables'): _FLAX_STATE,
    ('nn/export.py', 'fold_xnor_thresholds', 'variables'): _FLAX_STATE,
    ('nn/export.py', 'fold_for_serving', 'packed_model'):
        'flax module and variables are one nn.Module, the port\'s model',
    ('nn/export.py', 'fold_for_serving', 'variables'): _FLAX_STATE,
    ('nn/export.py', 'strip_for_deployment', 'variables'): _FLAX_STATE,
    ('nn/export.py', 'packed_weight_bytes', 'variables'): _FLAX_STATE,
    ('serving/engine.py', 'InferenceEngine.__init__', 'apply_fn'):
        'flax apply function: the port\'s engine calls the nn.Module',
    ('serving/engine.py', 'InferenceEngine.__init__', 'variables'):
        _FLAX_STATE,
    ('train/groups.py', 'quantized_param_labels', 'variables'):
        _FLAX_STATE,
    ('train/task.py', 'init_model_variables', 'model'):
        'flax init of a module: the port\'s model is built initialized',
    ('train/task.py', 'init_model_variables', 'sample_input'):
        'flax shape inference: the port builds from the config',
    ('train/task.py', 'get_teacher_apply', 'sample_input'):
        'flax shape inference: the port builds from the config',
    ('train/state.py', 'TrainState', 'params'):
        'TrainState\'s flax field: the port\'s state holds the model',
    ('train/state.py', 'TrainState', 'batch_stats'):
        'TrainState\'s flax field: the port\'s state holds the model',
    ('train/state.py', 'TrainState', 'quant_state'):
        'TrainState\'s flax field: the port\'s state holds the model',
    ('train/state.py', 'TrainState', 'opt_state'):
        'TrainState\'s flax field: the port\'s state holds the optimizer',
    ('train/state.py', 'TrainState', 'apply_fn'):
        'TrainState\'s flax field: the port\'s state holds the model',
    ('train/state.py', 'TrainState.model_variables', None):
        'flax variable dict of the fields above: the port\'s is the model',
    ('train/state.py', 'TrainState.create', 'apply_fn'):
        'flax apply function: the port\'s state holds the model',
    ('train/state.py', 'TrainState.create', 'variables'): _FLAX_STATE,
    ('nn/layers.py', 'ActivationQuantizer.__call__', 'train'): _TRAIN_MODE,
    ('nn/layers.py', 'ActivationQuantizer.__call__', 'return_scales'):
        'the port\'s forward returns the scales; quantize() returns x_q',
    ('nn/layers.py', 'Conv', 'dtype'): _MODEL_DTYPE,
    ('nn/layers.py', 'Dense', 'dtype'): _MODEL_DTYPE,
    ('nn/layers.py', 'BatchNorm', 'dtype'): _MODEL_DTYPE,
    ('nn/layers.py', 'BatchNorm.__call__', 'train'): _TRAIN_MODE,
    ('nn/layers.py', 'QuantConv2d', 'eval_dtype'): _MODEL_DTYPE,
    ('nn/layers.py', 'QuantConv2d', 'train_dtype'): _MODEL_DTYPE,
    ('nn/layers.py', 'QuantConv2d', 'bn_folded'): _MODEL_DTYPE,
    ('nn/layers.py', 'QuantConv2d.__call__', 'train'): _TRAIN_MODE,
    ('nn/lenet.py', 'QLeNet5.__call__', 'train'): _TRAIN_MODE,
    ('nn/resnet.py', 'QResNet.__call__', 'train'): _TRAIN_MODE,
    **{('nn/resnet.py', block, field): _MODEL_DTYPE
       for block in ('RegularBasicBlock', 'XnorBasicBlock',
                     'RegularBottleneckBlock', 'XnorBottleneckBlock')
       for field in ('eval_dtype', 'train_dtype', 'bn_fold')},
    **{('nn/resnet.py', f'{block}.__call__', 'train'): _TRAIN_MODE
       for block in ('RegularBasicBlock', 'XnorBasicBlock',
                     'RegularBottleneckBlock', 'XnorBottleneckBlock')},
}

# Package exports the port adds to JAX's __all__ (package -> names):
# parts of the port with no JAX counterpart in that package.
PORT_ONLY_EXPORTS: dict[str, dict[str, str]] = {
    'parallel/__init__.py': {
        'data_group': 'a mesh axis\' process group',
        'model_group': 'a mesh axis\' process group',
        'shard_model': 'shards a built nn.Module (JAX places variables)',
        'band_model': 'bands a built nn.Module (JAX places the batch)',
        'local_band': 'this rank\'s rows of a batch',
        'tp_binary_matmul_overlapped': 'the ring GEMM, from tp_overlap',
        'tp_binary_matmul_reference': 'the ring GEMM, from tp_overlap',
        'tp_packed_matmul_overlapped': 'the ring GEMM, from tp_overlap',
    },
    'config/__init__.py': {
        'check_single_card': 'the refusal of a multi-card config outside '
                             'a process group'},
}

Gap = tuple[str, str, Optional[str]]


def sources(root: Path) -> dict[str, str]:
    """{module path below root: source} of every module of a package."""
    return {p.relative_to(root).as_posix(): p.read_text()
            for p in sorted(root.rglob('*.py'))}


def _lazy_names(fn: ast.FunctionDef, tree: ast.Module) -> set[str]:
    """The names a module `__getattr__` serves: its string constants and
    the keys of the module-level dicts it reads."""
    dicts = {t.id: node.value for node in tree.body
             if isinstance(node, ast.Assign)
             and isinstance(node.value, ast.Dict)
             for t in node.targets if isinstance(t, ast.Name)}
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            names.add(node.value)
        elif isinstance(node, ast.Name) and node.id in dicts:
            names |= {k.value for k in dicts[node.id].keys
                      if isinstance(k, ast.Constant)}
    return names


def _top_level(tree: ast.Module, imports: bool) -> dict[str, ast.AST]:
    """Public top-level names -> their node (`if`/`try` bodies
    included); imported names only where `imports`."""
    out: dict[str, ast.AST] = {}

    def visit(body: list) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                out[node.name] = node
                if node.name == '__getattr__':
                    out.update(dict.fromkeys(_lazy_names(node, tree), node))
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                out.update({t.id: node for t in targets
                            if isinstance(t, ast.Name)})
            elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
                out.update({(a.asname or a.name).split('.')[0]: node
                            for a in node.names})
            elif isinstance(node, ast.If):
                visit(node.body + node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body + node.orelse + node.finalbody)
    visit(tree.body)
    return {k: v for k, v in out.items() if not k.startswith('_')}


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
            + [a.vararg, a.kwarg] if p is not None]


def _fields(cls: ast.ClassDef) -> list[str]:
    return [n.target.id for n in cls.body if isinstance(n, ast.AnnAssign)
            and isinstance(n.target, ast.Name)]


def _method(cls: ast.ClassDef, name: str) -> Optional[ast.FunctionDef]:
    return next((n for n in cls.body if isinstance(n, ast.FunctionDef)
                 and n.name == name), None)


def _all(tree: ast.Module) -> Optional[list[str]]:
    for node in tree.body:
        if (isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == '__all__'
                for t in node.targets)):
            return [e.value for e in node.value.elts]
    return None


def _class_gaps(rel: str, jcls: ast.ClassDef, pcls: ast.ClassDef
                ) -> set[Gap]:
    gaps = set()
    init = _method(pcls, '__init__')
    takes = _params(init) if init else _fields(pcls)
    gaps |= {(rel, jcls.name, f) for f in _fields(jcls) if f not in takes}
    for jm in jcls.body:
        if not isinstance(jm, ast.FunctionDef) or (
                jm.name.startswith('_')
                and jm.name not in ('__init__', '__call__')):
            continue
        pm = _method(pcls, jm.name) or (
            _method(pcls, 'forward') if jm.name == '__call__' else None)
        where = f'{jcls.name}.{jm.name}'
        if pm is None:
            gaps.add((rel, where, None))
        else:
            gaps |= {(rel, where, p) for p in _params(jm)
                     if p not in _params(pm)}
    return gaps


def api_gaps(jax: dict[str, str], port: dict[str, str]
             ) -> tuple[set[Gap], set[Gap]]:
    """(what JAX has and the port lacks, exports the port adds): gaps
    are (module, name, parameter) as JAX_ONLY's keys; a package's
    missing export is (package, '__all__', name)."""
    gaps, extra = set(), set()
    for rel, src in jax.items():
        if rel not in port:
            gaps.add((rel, '<module>', None))
            continue
        jt, pt = ast.parse(src), ast.parse(port[rel])
        is_init = rel.endswith('__init__.py')
        jnames = _top_level(jt, imports=is_init)
        pnames = _top_level(pt, imports=True)
        for name, jnode in jnames.items():
            pnode = pnames.get(name)
            if pnode is None:
                gaps.add((rel, name, None))
            elif isinstance(jnode, ast.FunctionDef) and isinstance(
                    pnode, ast.FunctionDef):
                gaps |= {(rel, name, p) for p in _params(jnode)
                         if p not in _params(pnode)}
            elif isinstance(jnode, ast.ClassDef) and isinstance(
                    pnode, ast.ClassDef):
                gaps |= _class_gaps(rel, jnode, pnode)
        jall, pall = _all(jt), _all(pt) or []
        if jall is not None:
            gaps |= {(rel, '__all__', n) for n in jall if n not in pall}
            extra |= {(rel, '__all__', n) for n in pall if n not in jall}
    return gaps, extra


JAX_SOURCES = sources(JAX_ROOT)


def _port_only() -> set[Gap]:
    return {(rel, '__all__', n) for rel, names in PORT_ONLY_EXPORTS.items()
            for n in names}


def test_port_has_every_jax_name_parameter_and_export():
    gaps, extra = api_gaps(JAX_SOURCES, sources(PORT_ROOT))
    assert sorted(gaps - set(JAX_ONLY), key=str) == []
    assert sorted(extra - _port_only(), key=str) == []


def test_jax_only_table_has_reasons_and_no_stale_entry():
    gaps, extra = api_gaps(JAX_SOURCES, sources(PORT_ROOT))
    assert sorted(set(JAX_ONLY) - gaps, key=str) == []
    assert sorted(_port_only() - extra, key=str) == []
    reasons = list(JAX_ONLY.values()) + [
        r for names in PORT_ONLY_EXPORTS.values() for r in names.values()]
    assert all(r.strip() and '\n' not in r for r in reasons)


@pytest.mark.parametrize('package', [
    '__init__.py', 'nn/__init__.py', 'ops/__init__.py',
    'serving/__init__.py', 'utils/__init__.py', 'train/__init__.py',
    'data/__init__.py', 'config/__init__.py', 'parallel/__init__.py'])
def test_package_exports_equal_jax(package):
    """__all__ name for name (less the listed port-only exports), and
    every exported name defined or served by the package."""
    jt = ast.parse(JAX_SOURCES[package])
    pt = ast.parse((PORT_ROOT / package).read_text())
    port_all = _all(pt)
    if _all(jt) is None:  # the top level: its public names
        assert port_all is None
        assert set(_top_level(jt, True)) <= set(_top_level(pt, True))
        return
    assert len(set(port_all)) == len(port_all)
    assert set(port_all) - set(PORT_ONLY_EXPORTS.get(package, ())) == set(
        _all(jt))
    assert set(port_all) <= set(_top_level(pt, imports=True))


def _drop(src: str, path: str, what: str) -> str:
    """src with one thing taken out: the top-level name `what`, or with
    path 'fn' / 'Class.method' the parameter `what`, or with path
    '__all__' one export."""
    tree = ast.parse(src)
    if path == '':
        tree.body = [n for n in tree.body if getattr(n, 'name', None) != what
                     and not (isinstance(n, ast.Assign) and any(
                         getattr(t, 'id', None) == what
                         for t in n.targets))]
    elif path == '__all__':
        for node in tree.body:
            if isinstance(node, ast.Assign) and getattr(
                    node.targets[0], 'id', None) == '__all__':
                node.value.elts = [e for e in node.value.elts
                                   if e.value != what]
    else:
        scope: list = tree.body
        for part in path.split('.'):
            node = next(n for n in scope if getattr(n, 'name', None) == part)
            scope = node.body
        a = node.args
        a.args = [p for p in a.args if p.arg != what]
        kept = [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)
                if p.arg != what]
        a.kwonlyargs, a.kw_defaults = [p for p, _ in kept], [d for _, d in kept]
        a.defaults = a.defaults[-len(a.args):] if a.args else []
    return ast.unparse(tree)


@pytest.mark.parametrize('module,path,what,gap', [
    ('nn/layers.py', '', 'WeightQuantizer',
     ('nn/layers.py', 'WeightQuantizer', None)),
    ('ops/conv.py', 'conv2d', 'groups', ('ops/conv.py', 'conv2d', 'groups')),
    ('nn/layers.py', 'BatchNorm.__init__', 'momentum',
     ('nn/layers.py', 'BatchNorm', 'momentum')),
    ('platform.py', 'LocalComputePlatform.__init__', 'root_experiments_dir',
     ('platform.py', 'LocalComputePlatform.__init__',
      'root_experiments_dir')),
    ('serving/__init__.py', '__all__', 'InferenceEngine',
     ('serving/__init__.py', '__all__', 'InferenceEngine')),
    ('__init__.py', '', 'Hook', ('__init__.py', 'Hook', None)),
])
def test_walk_sees_a_removed_name(module, path, what, gap):
    """Stand-in: a copy of the port's sources with one name, parameter
    or export taken out shows exactly that gap."""
    port = sources(PORT_ROOT)
    assert gap not in api_gaps(JAX_SOURCES, port)[0]
    port[module] = _drop(port[module], path, what)
    gaps = api_gaps(JAX_SOURCES, port)[0]
    assert gaps - set(JAX_ONLY) == {gap}


def test_walk_sees_a_stale_jax_only_entry():
    """Stand-in: a port that takes a listed JAX-only parameter makes its
    table entry stale."""
    port = sources(PORT_ROOT)
    port['ops/conv.py'] = port['ops/conv.py'].replace(
        'groups: int = 1,', 'groups: int = 1, preferred_element_type=None,',
        1)
    gaps = api_gaps(JAX_SOURCES, port)[0]
    assert set(JAX_ONLY) - gaps == {
        ('ops/conv.py', 'conv2d', 'preferred_element_type')}


def test_local_platform_takes_jax_parameters_in_order():
    def init(src: str) -> list[str]:
        cls = next(n for n in ast.parse(src).body
                   if getattr(n, 'name', None) == 'LocalComputePlatform')
        return _params(_method(cls, '__init__'))
    assert init((PORT_ROOT / 'platform.py').read_text()) == init(
        JAX_SOURCES['platform.py']) == [
            'self', 'root_experiments_dir', 'start_tensorboard']


def test_serving_import_builds_nothing():
    """`import quant_tpu_torch.serving` in a fresh interpreter loads no
    kernel library, starts no compiler or other process, opens no
    socket, starts no process group and imports none of its modules;
    a name then imports its module alone."""
    got = chip_smoke.serving_import_probe()
    assert got == dict(libraries=[], processes=[], sockets=0,
                       process_group=False, modules=[],
                       engine='quant_tpu_torch.serving.engine')
