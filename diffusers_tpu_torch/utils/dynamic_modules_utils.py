"""Custom pipelines from local code: a ``.py`` file, a folder holding
``pipeline.py``, or a module inside a checkpoint folder.

Port of `diffusers_tpu/utils/dynamic_modules_utils.py`. Code is loaded from
local files only (no hub). Two gates, read at call time:

* every call needs ``trust_remote_code=True``;
* ``DIFFUSERS_TPU_DISABLE_REMOTE_CODE=1`` refuses whatever the caller passes.

A loaded file is copied into a private package, ``diffusers_tpu_torch_modules``,
under the system temp directory, as a module named by the hash of its
content, so an edited file loads anew instead of hitting the import cache.
"""

from __future__ import annotations

import hashlib
import importlib
import os
import shutil
import sys
import tempfile
from typing import Optional, Type

from . import logging

logger = logging.get_logger(__name__)

DYNAMIC_MODULE_NAME = "diffusers_tpu_torch_modules"
_DYNAMIC_ROOT: Optional[str] = None


def _dynamic_package_dir() -> str:
    global _DYNAMIC_ROOT
    if _DYNAMIC_ROOT is None:
        _DYNAMIC_ROOT = tempfile.mkdtemp(prefix=f"{DYNAMIC_MODULE_NAME}_")
        sys.path.insert(0, _DYNAMIC_ROOT)
        pkg = os.path.join(_DYNAMIC_ROOT, DYNAMIC_MODULE_NAME)
        os.makedirs(pkg, exist_ok=True)
        with open(os.path.join(pkg, "__init__.py"), "w"):
            pass
    return os.path.join(_DYNAMIC_ROOT, DYNAMIC_MODULE_NAME)


def _check_trust(trust_remote_code: bool, what: str) -> None:
    if os.getenv("DIFFUSERS_TPU_DISABLE_REMOTE_CODE", "0").upper() in {"1", "ON", "YES", "TRUE"}:
        raise ValueError(f"Loading {what} is disabled on this machine via DIFFUSERS_TPU_DISABLE_REMOTE_CODE.")
    if not trust_remote_code:
        raise ValueError(f"Loading {what} executes code from that location. Review the file, then pass "
                         "`trust_remote_code=True` to allow it.")


def _resolve_module_file(location: str, module_file: str = "pipeline.py") -> str:
    """`location` is a .py file, or a folder holding `module_file`."""
    if os.path.isfile(location) and location.endswith(".py"):
        return location
    candidate = os.path.join(location, module_file)
    if os.path.isfile(candidate):
        return candidate
    raise EnvironmentError(f"No custom module found at {location!r} (looked for {candidate})")


def load_dynamic_module(location: str, module_file: str = "pipeline.py", trust_remote_code: bool = False):
    """Import a .py file as a module of the private package; returns it."""
    _check_trust(trust_remote_code, f"custom code from {location!r}")
    src = _resolve_module_file(location, module_file)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    mod_name = f"m_{digest}"
    dst = os.path.join(_dynamic_package_dir(), f"{mod_name}.py")
    if not os.path.exists(dst):
        shutil.copyfile(src, dst)
    full_name = f"{DYNAMIC_MODULE_NAME}.{mod_name}"
    if full_name in sys.modules:
        return sys.modules[full_name]
    logger.info("importing custom module %s (from %s)", full_name, src)
    return importlib.import_module(full_name)


def get_class_from_dynamic_module(location: str, module_file: str = "pipeline.py", class_name: Optional[str] = None,
                                  trust_remote_code: bool = False, base_class: Optional[Type] = None):
    """A class of a custom module: `class_name`, or else the one class
    defined in the module that subclasses `base_class` (a
    `DiffusionPipeline`, say)."""
    module = load_dynamic_module(location, module_file, trust_remote_code)
    if class_name is not None:
        return getattr(module, class_name)
    if base_class is None:
        raise ValueError("either class_name or base_class is required")
    matches = [obj for obj in vars(module).values()
               if isinstance(obj, type) and issubclass(obj, base_class) and obj is not base_class
               and obj.__module__ == module.__name__]
    if len(matches) != 1:
        raise ValueError(f"expected exactly one {base_class.__name__} subclass in {location!r}, "
                         f"found {[m.__name__ for m in matches]}")
    return matches[0]
