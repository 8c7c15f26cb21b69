"""keras_rs_tpu: a recommender-systems framework in JAX.

Built from scratch with the capability surface of keras-rs (see SURVEY.md):
pytree modules, explicit jitted train steps, and sharded embedding tables
over a `jax.sharding.Mesh`.
"""

import importlib

from keras_rs_tpu import core
from keras_rs_tpu import losses
from keras_rs_tpu import metrics
from keras_rs_tpu import ops
from keras_rs_tpu import serving
from keras_rs_tpu.version import __version__, version

# Heavier subpackages (layers, data and training pull the embedding engine
# and the native loaders) resolve lazily so `import keras_rs_tpu`
# stays light, while the reference's access pattern
# (`keras_rs.layers.DistributedEmbedding`,
# keras_rs/api/layers/__init__.py:8) still works verbatim
# as `keras_rs_tpu.layers.DistributedEmbedding`.
_LAZY_SUBPACKAGES = (
    "data",
    "layers",
    "models",
    "parallel",
    "training",
    "utils",
)


def __getattr__(name: str):
    if name in _LAZY_SUBPACKAGES:
        module = importlib.import_module(f"keras_rs_tpu.{name}")
        globals()[name] = module
        return module
    raise AttributeError(f"module 'keras_rs_tpu' has no attribute {name!r}")


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_LAZY_SUBPACKAGES))


__all__ = [
    "core",
    "data",
    "layers",
    "losses",
    "metrics",
    "models",
    "ops",
    "parallel",
    "serving",
    "training",
    "utils",
    "version",
    "__version__",
]
