"""The config schema, shared with the JAX package.

``gbnerf_tpu/config.py`` and ``gbnerf_tpu/__init__.py`` import only
``dataclasses``, ``os`` and ``typing``, so re-exporting them loads no JAX,
and a config file loads identically in both packages. Import nothing else
from ``gbnerf_tpu``: its ``core``, ``ops``, ``utils`` and ``data`` packages
import JAX at the top.
"""
from gbnerf_tpu.config import (Config, load_reference_config,  # noqa: F401
                               save_config)
