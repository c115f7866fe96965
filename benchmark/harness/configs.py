"""A configuration file (``benchmark/configs/<name>.json``) as the dataclasses
that the program and the reference take.

A family whose file's ``model`` object is ``dataclasses.asdict`` of its
configuration rebuilds it with :func:`dataclass_from_dict` as any dataclass
tree with the same field names (the program's class or the reference's
frozen copy), lists turned back into tuples."""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping


def _tuples(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_tuples(x) for x in v)
    return v


def dataclass_from_dict(cls, d: Mapping[str, Any]):
    """``cls(**d)`` with every nested dataclass field rebuilt from its dict;
    a key that ``cls`` lacks, or a field that ``d`` lacks, raises."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    extra = set(d) - set(fields)
    missing = set(fields) - set(d)
    if extra or missing:
        raise KeyError(f"{cls.__name__}: unknown {sorted(extra)}, missing {sorted(missing)}")
    kw = {}
    for name, f in fields.items():
        if f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
        else:
            default = f.default
        v = d[name]
        if dataclasses.is_dataclass(default) and isinstance(v, Mapping):
            kw[name] = dataclass_from_dict(type(default), v)
        else:
            kw[name] = _tuples(v)
    return cls(**kw)

