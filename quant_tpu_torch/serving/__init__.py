"""Serving for the port: the batching InferenceEngine, the ServingFrontend
over engines, the socket RPC, engine worker processes and the serving
artifact.

The package exports the JAX package's names (quant_tpu/serving/
__init__.py), name for name. Each is imported from its module at first
use, so importing the package builds no kernel, starts no process group
and opens no socket.
"""

import importlib
from typing import Any

_MODULES = {
    'InferenceEngine': 'engine',
    'ServingFrontend': 'engine',
    'EngineServer': 'rpc',
    'RemoteEngineClient': 'rpc',
    'spawn_engine_workers': 'worker',
    'prepare_serving_artifact': 'prepare',
    'load_serving_artifact': 'prepare',
}

__all__ = ['InferenceEngine', 'ServingFrontend', 'EngineServer',
           'RemoteEngineClient', 'spawn_engine_workers',
           'prepare_serving_artifact', 'load_serving_artifact']


def __getattr__(name: str) -> Any:
    if name not in _MODULES:
        raise AttributeError(
            f'module {__name__!r} has no attribute {name!r}')
    module = importlib.import_module(f'{__name__}.{_MODULES[name]}')
    return getattr(module, name)


def __dir__() -> list[str]:
    return sorted(list(globals()) + __all__)
