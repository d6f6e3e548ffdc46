"""Config system: JSON round-trip for every model/scheduler/pipeline component.

Port of `diffusers_tpu/configuration_utils.py` (the reference's `ConfigMixin`
and `register_to_config`). Stdlib only; the on-disk format is the same
(`config.json` / `scheduler_config.json` with `_class_name` and
`_diffusers_version`). `from_pretrained` reads a local directory (and its
`subfolder`); the hub is not ported. A config file written by another
library (a transformers `config.json`) loads too: the keys the class does
not take stay in its config and are written back by `save_config`.

For `nn.Module` subclasses, `nn.Module.__getattr__` comes first in the MRO, so
config values are read through ``self.config.<name>``.
"""

from __future__ import annotations

import functools
import inspect
import json
import os
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

from . import __version__
from .utils import logging

logger = logging.get_logger(__name__)


class FrozenDict(OrderedDict):
    """Immutable ordered dict with attribute access."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for key, value in self.items():
            setattr(self, key, value)
        self.__frozen = True

    def __delitem__(self, *args, **kwargs):
        raise Exception(f"You cannot use ``__delitem__`` on a {self.__class__.__name__} instance.")

    def setdefault(self, *args, **kwargs):
        raise Exception(f"You cannot use ``setdefault`` on a {self.__class__.__name__} instance.")

    def pop(self, *args, **kwargs):
        raise Exception(f"You cannot use ``pop`` on a {self.__class__.__name__} instance.")

    def update(self, *args, **kwargs):
        raise Exception(f"You cannot use ``update`` on a {self.__class__.__name__} instance.")

    def __setattr__(self, name, value):
        if hasattr(self, "_FrozenDict__frozen") and self.__frozen:
            raise Exception(f"You cannot use ``__setattr__`` on a {self.__class__.__name__} instance.")
        super().__setattr__(name, value)

    def __setitem__(self, name, value):
        if hasattr(self, "_FrozenDict__frozen") and self.__frozen:
            raise Exception(f"You cannot use ``__setitem__`` on a {self.__class__.__name__} instance.")
        super().__setitem__(name, value)


def register_to_config(init):
    """Decorator that records ``__init__`` kwargs into ``self._internal_dict``.

    Private args (leading underscore) and names in ``ignore_for_config`` are
    excluded; defaults are captured.
    """

    @functools.wraps(init)
    def inner_init(self, *args, **kwargs):
        init_kwargs = {k: v for k, v in kwargs.items() if not k.startswith("_")}
        config_init_kwargs = {k: v for k, v in kwargs.items() if k.startswith("_")}
        if not isinstance(self, ConfigMixin):
            raise RuntimeError(
                f"`@register_to_config` was applied to {self.__class__.__name__} init method, but this class does "
                "not inherit from `ConfigMixin`."
            )

        ignore = getattr(self, "ignore_for_config", [])
        new_kwargs = {}
        signature = inspect.signature(init)
        parameters = {
            name: p.default
            for i, (name, p) in enumerate(signature.parameters.items())
            if i > 0 and name not in ignore
        }
        for arg, name in zip(args, parameters.keys()):
            new_kwargs[name] = arg
        new_kwargs.update(
            {
                k: init_kwargs.get(k, default)
                for k, default in parameters.items()
                if k not in ignore and k not in new_kwargs
            }
        )
        new_kwargs = {**config_init_kwargs, **new_kwargs}
        getattr(self, "register_to_config")(**new_kwargs)
        init(self, *args, **init_kwargs)

    return inner_init


class ConfigMixin:
    """Base class providing config save/load for all framework components:
    ``from_config``, ``load_config``, ``save_config``, ``config``,
    ``register_to_config``."""

    config_name: Optional[str] = None
    ignore_for_config = []
    has_compatibles = False
    _compatibles = []

    def register_to_config(self, **kwargs):
        if self.config_name is None:
            raise NotImplementedError(f"Make sure that {self.__class__} has defined a class name `config_name`")
        kwargs.pop("kwargs", None)
        if not hasattr(self, "_internal_dict"):
            internal_dict = kwargs
        else:
            previous_dict = dict(self._internal_dict)
            internal_dict = {**previous_dict, **kwargs}
        self._internal_dict = FrozenDict(internal_dict)

    def __getattr__(self, name: str) -> Any:
        """Config attribute passthrough: ``self.foo`` falls back to
        ``self.config.foo``."""
        is_in_config = "_internal_dict" in self.__dict__ and hasattr(self.__dict__["_internal_dict"], name)
        if is_in_config:
            return self._internal_dict[name]
        raise AttributeError(f"'{type(self).__name__}' object has no attribute '{name}'")

    @property
    def config(self) -> FrozenDict:
        return self._internal_dict

    def save_config(self, save_directory: Union[str, os.PathLike], **kwargs):
        if os.path.isfile(save_directory):
            raise AssertionError(f"Provided path ({save_directory}) should be a directory, not a file")
        os.makedirs(save_directory, exist_ok=True)
        output_config_file = os.path.join(save_directory, self.config_name)
        with open(output_config_file, "w", encoding="utf-8") as f:
            f.write(self.to_json_string())
        logger.info(f"Configuration saved in {output_config_file}")

    def to_json_string(self) -> str:
        config_dict = dict(self._internal_dict) if hasattr(self, "_internal_dict") else {}
        config_dict["_class_name"] = self.__class__.__name__
        config_dict["_diffusers_version"] = __version__

        def to_serializable(value):
            if hasattr(value, "tolist"):
                return value.tolist()
            if isinstance(value, Path):
                return value.as_posix()
            if isinstance(value, (tuple, list)):
                return [to_serializable(v) for v in value]
            if isinstance(value, dict):
                return {k: to_serializable(v) for k, v in value.items()}
            return value

        config_dict = {k: to_serializable(v) for k, v in config_dict.items()}
        return json.dumps(config_dict, indent=2, sort_keys=True) + "\n"

    @classmethod
    def load_config(
        cls,
        pretrained_model_name_or_path: Union[str, os.PathLike],
        return_unused_kwargs: bool = False,
        subfolder: Optional[str] = None,
        **kwargs,
    ) -> Union[FrozenDict, Tuple[FrozenDict, Dict[str, Any]]]:
        """Load a config dict from a local directory or file."""
        pretrained_model_name_or_path = str(pretrained_model_name_or_path)
        if cls.config_name is None:
            raise ValueError("`config_name` must be defined on the loading class")

        if os.path.isfile(pretrained_model_name_or_path):
            config_file = pretrained_model_name_or_path
        else:
            path = pretrained_model_name_or_path
            if subfolder is not None:
                path = os.path.join(path, subfolder)
            config_file = os.path.join(path, cls.config_name)
            if not os.path.isfile(config_file):
                raise EnvironmentError(f"{path} does not contain a file named {cls.config_name}.")

        with open(config_file, "r", encoding="utf-8") as f:
            config_dict = json.load(f)

        if return_unused_kwargs:
            return FrozenDict(config_dict), kwargs
        return FrozenDict(config_dict)

    @classmethod
    def extract_init_dict(cls, config_dict: Dict[str, Any], **kwargs):
        """Split a loaded config into (init kwargs, unused config keys and
        keyword arguments, hidden config keys: the config file's keys that
        the constructor does not take)."""
        config_dict = dict(config_dict)
        expected_keys = cls._get_init_keys(cls)
        expected_keys.discard("self")
        expected_keys.discard("kwargs")
        for k in cls.ignore_for_config:
            expected_keys.discard(k)

        init_dict = {}
        for key in list(expected_keys):
            if key in kwargs and key in config_dict:
                config_dict[key] = kwargs.pop(key)
            if key in kwargs:
                init_dict[key] = kwargs.pop(key)
            elif key in config_dict:
                init_dict[key] = config_dict.pop(key)

        unused_kwargs = {**config_dict, **kwargs}
        unused_kwargs = {k: v for k, v in unused_kwargs.items() if not k.startswith("_")}

        passed_keys = set(init_dict.keys())
        if len(expected_keys - passed_keys) > 0:
            logger.info(f"{expected_keys - passed_keys} was not found in config. Values will be initialized to default values.")
        # every config-file key the constructor does not take (the underscore
        # keys, and other writers' metadata such as a transformers config's
        # `architectures` or `torch_dtype`) is kept in the config, never passed;
        # a scheduler keeps only the underscore keys, so a swap (`from_config`
        # of another sampler's config) drops the other sampler's options, as
        # JAX's does
        hidden_config_dict = dict(config_dict)
        if getattr(cls, "has_compatibles", False):
            hidden_config_dict = {k: v for k, v in config_dict.items() if k.startswith("_")}
        return init_dict, unused_kwargs, hidden_config_dict

    @staticmethod
    def _get_init_keys(input_class):
        return set(dict(inspect.signature(input_class.__init__).parameters).keys())

    @classmethod
    def from_config(
        cls,
        config: Union[FrozenDict, Dict[str, Any]] = None,
        return_unused_kwargs: bool = False,
        **kwargs,
    ):
        if config is None:
            raise ValueError("Please make sure to provide a config as the first positional argument.")
        if not isinstance(config, dict):
            raise ValueError("`from_config` takes a config dict.")

        init_dict, unused_kwargs, hidden_dict = cls.extract_init_dict(config, **kwargs)
        model = cls(**init_dict)
        if "_class_name" in hidden_dict:
            hidden_dict["_class_name"] = cls.__name__
        model.register_to_config(**hidden_dict)
        unused_kwargs = {**unused_kwargs, **hidden_dict}
        if return_unused_kwargs:
            return model, unused_kwargs
        return model

    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path: Union[str, os.PathLike], subfolder: Optional[str] = None,
                        **kwargs):
        """Config-only components (schedulers): read the config from a local
        directory (and its `subfolder`), then build."""
        return cls.from_config(cls.load_config(pretrained_model_name_or_path, subfolder=subfolder), **kwargs)
