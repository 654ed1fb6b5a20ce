"""The freeze mixin of the immutable copy-on-write object plane — the part
that :class:`~wva_tpu_torch.api.v1alpha1.CrossVersionObjectReference` needs.

Unfrozen instances behave exactly like plain dataclasses. An instance whose
``__wva_frozen__`` attribute is set raises :class:`FrozenObjectError` on any
attribute write, and deep-copying it yields a mutable (thawed) copy. The
store-side protocol (``freeze``, ``thaw``, frozen containers) ports with
the object stores.
"""

from __future__ import annotations

import copy
from typing import Any

# Instance attributes stamped by freeze(); excluded from thawed copies.
_FROZEN_ATTR = "__wva_frozen__"
_VERSION_ATTR = "__wva_version__"


class FrozenObjectError(TypeError):
    """Mutation attempted on a frozen object (or frozen container).

    The object came out of a zero-copy store read; callers that need to
    mutate must take an explicit copy first.
    """


class Freezable:
    """Mixin for dataclasses participating in the freeze/thaw protocol.

    Unfrozen instances behave exactly like plain dataclasses (the
    dataclass-generated ``__init__`` runs through ``__setattr__`` before
    the frozen flag exists). Once the instance is stamped frozen, any
    attribute write raises :class:`FrozenObjectError`.
    """

    # Class-level default so unfrozen instances pay one dict-miss, not an
    # instance attribute, on every setattr.
    __wva_frozen__ = False

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__wva_frozen__:
            raise FrozenObjectError(
                f"cannot set {name!r} on frozen {type(self).__name__} "
                "(store-shared object; take a mutable copy first)")
        object.__setattr__(self, name, value)

    def __delattr__(self, name: str) -> None:
        if self.__wva_frozen__:
            raise FrozenObjectError(
                f"cannot delete {name!r} on frozen {type(self).__name__}")
        object.__delattr__(self, name)

    def __deepcopy__(self, memo: dict) -> "Freezable":
        # Deep-copying a frozen object asks for a mutable view: the copy
        # drops the frozen stamp. Unfrozen instances deep-copy as normal.
        cls = type(self)
        new = cls.__new__(cls)
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            if k in (_FROZEN_ATTR, _VERSION_ATTR):
                continue
            object.__setattr__(new, k, copy.deepcopy(v, memo))
        return new
