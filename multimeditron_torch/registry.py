"""Generic string-keyed registry.

One implementation backs the three plugin registries the framework exposes
(modalities, modality loaders, dataset preprocessors) — the extension
mechanism described in the reference's ``docs/source/guides/add_modality.rst``
and implemented three times over in ``model/modalities/base.py:164-222``,
``dataset/loader/__init__.py:87-155`` and
``dataset/preprocessor/__init__.py:10-44``. A copy of
``multimeditron_tpu/registry.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Generic, Iterable, Optional, Type, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str, base_class: Optional[type] = None):
        self.kind = kind
        self.base_class = base_class
        self._registry: Dict[str, Type[T]] = {}

    def register(self, name: str) -> Callable[[Type[T]], Type[T]]:
        def decorator(cls: Type[T]) -> Type[T]:
            if self.base_class is not None and not issubclass(cls, self.base_class):
                raise ValueError(
                    f"{cls.__name__} must inherit from {self.base_class.__name__} "
                    f"to be registered as a {self.kind}"
                )
            if name in self._registry:
                raise ValueError(f"{self.kind} name {name!r} is already registered")
            self._registry[name] = cls
            setattr(cls, "registered_name", name)
            return cls

        return decorator

    def get(self, name: str) -> Type[T]:
        if name not in self._registry:
            raise KeyError(
                f"Unknown {self.kind} {name!r}. Available: {sorted(self._registry)}"
            )
        return self._registry[name]

    def __contains__(self, name: str) -> bool:
        return name in self._registry

    def names(self) -> Iterable[str]:
        return sorted(self._registry)

    def create(self, name: str, *args: Any, **kwargs: Any) -> T:
        return self.get(name)(*args, **kwargs)
