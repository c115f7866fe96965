"""A configuration file (``benchmark/configs/<name>.json``) as the dataclasses
that the program and the reference take.

The file's ``model`` object is ``dataclasses.asdict`` of the configuration:
:func:`dataclass_from_dict` rebuilds it as any dataclass tree with the same
field names (the program's ``FSFConfig`` or the reference's frozen copy),
lists turned back into tuples."""
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


def program_config(cfg_file: Mapping[str, Any]):
    """The program's ``FSFConfig`` of a configuration file."""
    from fullysparsefusion_tpu_torch.config import FSFConfig

    return dataclass_from_dict(FSFConfig, cfg_file["model"])


def reference_config(cfg_file: Mapping[str, Any]):
    """The reference's ``FSFConfig`` of a configuration file."""
    from ..reference.config import FSFConfig

    return dataclass_from_dict(FSFConfig, cfg_file["model"])
