"""Pluggable-component registries, the part of ``repro.engine.registry``
the port needs (stdlib only).

One ``Registry`` per axis of an experiment — strategies, aggregators,
client modes, tasks, the named presets that pin all four, and the async
runtime's staleness discounts — filled at definition time by the
``register_*`` decorators (presets by
``repro_torch.engine.presets.register_preset``).
Lookups lazily import the provider modules, so
``STRATEGY_REGISTRY["fedlecc"]`` works regardless of import order.

A strategy's capability flags name the selection methods the compiled
backend calls: ``supports_compiled_selection`` with ``select_mask`` and
``supports_traced_selection`` with ``select_mask_traced`` (the
reference's ``select_mask_jax`` and ``select_mask_traced``);
``register_strategy`` rejects a class whose flags and methods disagree.
"""

from __future__ import annotations

import importlib
from collections.abc import Mapping
from typing import Any, Callable, Iterator

__all__ = [
    "Registry",
    "STRATEGY_REGISTRY",
    "AGGREGATOR_REGISTRY",
    "CLIENT_MODE_REGISTRY",
    "TASK_REGISTRY",
    "PRESET_REGISTRY",
    "STALENESS_REGISTRY",
    "register_strategy",
    "register_aggregator",
    "register_client_mode",
    "register_task",
    "register_staleness",
    "list_strategies",
    "list_aggregators",
    "list_client_modes",
    "list_tasks",
    "list_staleness_discounts",
    "mask_selection_strategies",
    "traced_selection_strategies",
]

# Modules whose import populates each registry (decorator side-effects).
_PROVIDERS: dict[str, tuple[str, ...]] = {
    "strategy": ("repro_torch.core.strategies",),
    "aggregator": ("repro_torch.engine.aggregators",),
    "client_mode": ("repro_torch.engine.client_modes",),
    "task": ("repro_torch.engine.tasks",),
    "preset": ("repro_torch.engine.presets",),
    "staleness": ("repro_torch.engine.async_config",),
}


class Registry(Mapping[str, Any]):
    """A named string → component mapping with a ``register`` decorator."""

    def __init__(self, kind: str):
        self.kind = kind
        self._items: dict[str, Any] = {}
        self._populated = False

    def register(self, name: str | None = None) -> Callable[[Any], Any]:
        """Decorator: ``@REG.register("name")`` or ``@REG.register()``
        (falls back to the object's ``name`` attribute, then __name__)."""

        def deco(obj: Any) -> Any:
            key = name or getattr(obj, "name", None) or getattr(obj, "__name__", None)
            if not key or not isinstance(key, str):
                raise ValueError(f"cannot infer a registry name for {obj!r}")
            existing = self._items.get(key)
            if existing is not None and existing is not obj:
                raise ValueError(
                    f"duplicate {self.kind} registration {key!r} ({existing!r} vs {obj!r})"
                )
            self._items[key] = obj
            return obj

        return deco

    def _populate(self) -> None:
        if self._populated:
            return
        for mod in _PROVIDERS.get(self.kind, ()):
            importlib.import_module(mod)
        self._populated = True

    def build(self, name: str, *args: Any, **kwargs: Any) -> Any:
        """Instantiate the registered class ``name`` with the given args."""
        return self[name](*args, **kwargs)

    def names(self) -> list[str]:
        self._populate()
        return sorted(self._items)

    def __getitem__(self, name: str) -> Any:
        self._populate()
        try:
            return self._items[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; available: {sorted(self._items)}"
            ) from None

    def __iter__(self) -> Iterator[str]:
        self._populate()
        return iter(self._items)

    def __len__(self) -> int:
        self._populate()
        return len(self._items)

    def __contains__(self, name: object) -> bool:
        self._populate()
        return name in self._items

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, {sorted(self._items)})"


STRATEGY_REGISTRY = Registry("strategy")
AGGREGATOR_REGISTRY = Registry("aggregator")
CLIENT_MODE_REGISTRY = Registry("client_mode")
TASK_REGISTRY = Registry("task")
PRESET_REGISTRY = Registry("preset")
STALENESS_REGISTRY = Registry("staleness")

# The capability-flag <-> method pairs the compiled backend dispatches on.
_CAPABILITY_PAIRS: tuple[tuple[str, str], ...] = (
    ("supports_compiled_selection", "select_mask"),
    ("supports_traced_selection", "select_mask_traced"),
)


def _validate_strategy_capabilities(obj: Any) -> None:
    """A flag without its method would crash the first compiled or fused
    round; a method defined in a class whose flag is False is dead code.
    An inherited method under an explicit ``flag = False`` is the
    sanctioned opt-out (``FedLECCAdaptive``), so only a class's own body
    can contradict its flags."""
    if not isinstance(obj, type):
        return
    for flag, method in _CAPABILITY_PAIRS:
        enabled = bool(getattr(obj, flag, False))
        defined = callable(getattr(obj, method, None))
        if enabled and not defined:
            raise TypeError(
                f"strategy {obj.__name__!r} sets {flag} = True but defines "
                f"no {method}(); the mask-gated backends would crash on "
                f"their first round — define {method} or set the flag False"
            )
        if not enabled and method in vars(obj):
            raise TypeError(
                f"strategy {obj.__name__!r} defines {method}() in its own "
                f"body but {flag} is False; the backends will never call "
                f"it — set {flag} = True or drop the method"
            )


def register_strategy(name: str | None = None) -> Callable[[Any], Any]:
    """``STRATEGY_REGISTRY.register`` plus the capability check, so a
    strategy with mismatched flags fails when its class is defined."""
    inner = STRATEGY_REGISTRY.register(name)

    def deco(obj: Any) -> Any:
        _validate_strategy_capabilities(obj)
        return inner(obj)

    return deco


def list_strategies() -> list[str]:
    return STRATEGY_REGISTRY.names()


def list_aggregators() -> list[str]:
    return AGGREGATOR_REGISTRY.names()


def list_client_modes() -> list[str]:
    return CLIENT_MODE_REGISTRY.names()


def list_tasks() -> list[str]:
    return TASK_REGISTRY.names()


def mask_selection_strategies() -> list[str]:
    """Strategies with a mask selection (``supports_compiled_selection``):
    the ones ``backend="compiled"`` runs."""
    return [n for n in STRATEGY_REGISTRY.names()
            if getattr(STRATEGY_REGISTRY[n], "supports_compiled_selection", False)]


def traced_selection_strategies() -> list[str]:
    """Strategies whose selection runs inside a fused chunk with no host
    read (``supports_traced_selection``): the requirement for
    ``fuse_rounds > 0``."""
    return [n for n in STRATEGY_REGISTRY.names()
            if getattr(STRATEGY_REGISTRY[n], "supports_traced_selection", False)]


register_aggregator = AGGREGATOR_REGISTRY.register
register_client_mode = CLIENT_MODE_REGISTRY.register
register_task = TASK_REGISTRY.register
register_staleness = STALENESS_REGISTRY.register


def list_staleness_discounts() -> list[str]:
    return STALENESS_REGISTRY.names()
