"""String-keyed component registries (copy of clip_fsar_tpu/utils/registry.py:14-68).

Equivalent capability to the reference registry (utils/registry.py:6-66):
configs select components by name (e.g. ``VIDEO.HEAD.NAME:
CNN_OTAM_CLIPFSAR``).  Here a registry maps a name to any callable/class;
``get`` raises with the list of known names to make config typos obvious.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._entries: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    def register(self, obj: Optional[Any] = None, *, name: Optional[str] = None) -> Callable:
        """Use as ``@REG.register()`` or ``@REG.register(name="Alias")`` or
        ``REG.register(obj)``."""

        def _do_register(o: Any) -> Any:
            key = name or getattr(o, "__name__", None)
            if key is None:
                raise ValueError(f"Cannot infer a registry name for {o!r}")
            if key in self._entries and self._entries[key] is not o:
                raise KeyError(f"{key!r} already registered in {self._name}")
            self._entries[key] = o
            return o

        if obj is None:
            return _do_register
        return _do_register(obj)

    def get(self, key: str) -> Any:
        if key not in self._entries:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"{key!r} not found in registry {self._name}. Known: [{known}]")
        return self._entries[key]

    def contains(self, key: str) -> bool:
        return key in self._entries

    __contains__ = contains

    def keys(self):
        return self._entries.keys()


# The framework-wide registries, under the JAX package's names (the
# reference's model, backbone, stem, branch, head and dataset registries
# among them).
MODEL_REGISTRY = Registry("Model")
BACKBONE_REGISTRY = Registry("Backbone")
STEM_REGISTRY = Registry("Stem")
BRANCH_REGISTRY = Registry("Branch")
HEAD_REGISTRY = Registry("Head")
DATASET_REGISTRY = Registry("Dataset")
COLLATE_FN_REGISTRY = Registry("CollateFn")
SSL_GENERATOR_REGISTRY = Registry("SslGenerator")
SSL_LOSSES = Registry("SslLoss")
LOCALIZATION_LOSSES = Registry("LocalizationLoss")
DECODER_REGISTRY = Registry("VideoDecoder")
