"""Struct codec: dataclasses <-> JSON-able dicts, driven by type hints
(port of nomad_tpu/structs/codec.py). ``encode`` walks a value
structurally; ``decode(cls, data)`` rebuilds the typed object graph from
the class's field hints. The HTTP API's node and alloc endpoints carry
structs in this form (register, pull allocs, allocs-update)."""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Union

_HINT_CACHE: Dict[type, Dict[str, Any]] = {}


def encode(obj: Any) -> Any:
    """Structural encode to JSON-able primitives. No type tags: decode is
    driven by the target class's type hints instead."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: encode(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {_encode_key(k): encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [encode(v) for v in obj]
    if isinstance(obj, bytes):
        return obj.decode("latin-1")
    return obj


def _encode_key(k: Any) -> str:
    if isinstance(k, tuple):
        return "\x1f".join(str(p) for p in k)
    return str(k)


def _hints(cls: type) -> Dict[str, Any]:
    hints = _HINT_CACHE.get(cls)
    if hints is None:
        hints = typing.get_type_hints(cls)
        _HINT_CACHE[cls] = hints
    return hints


def decode(hint: Any, data: Any) -> Any:
    """Rebuild a typed value from encode() output, guided by `hint` (a
    dataclass, typing generic, or primitive type)."""
    if data is None:
        return None
    origin = typing.get_origin(hint)
    if origin is Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if len(args) == 1:
            return decode(args[0], data)
        for a in args:                      # first arg that decodes wins
            try:
                return decode(a, data)
            except (TypeError, ValueError, KeyError):
                continue
        return data
    if origin in (list, typing.List):
        (item_t,) = typing.get_args(hint) or (Any,)
        return [decode(item_t, v) for v in data]
    if origin in (tuple, typing.Tuple):
        args = typing.get_args(hint)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(decode(args[0], v) for v in data)
        if args:
            return tuple(decode(t, v) for t, v in zip(args, data))
        return tuple(data)
    if origin in (set, frozenset):
        (item_t,) = typing.get_args(hint) or (Any,)
        out = {decode(item_t, v) for v in data}
        return frozenset(out) if origin is frozenset else out
    if origin in (dict, typing.Dict):
        args = typing.get_args(hint)
        key_t, val_t = args if args else (str, Any)
        return {_decode_key(key_t, k): decode(val_t, v)
                for k, v in data.items()}
    if dataclasses.is_dataclass(hint):
        if not isinstance(data, dict):
            raise TypeError(f"cannot decode {type(data).__name__} "
                            f"as {hint.__name__}")
        hints = _hints(hint)
        kwargs = {}
        for f in dataclasses.fields(hint):
            if f.name not in data:
                continue
            kwargs[f.name] = decode(hints.get(f.name, Any), data[f.name])
        return hint(**kwargs)
    if hint in (int, float, bool, str):
        if isinstance(data, hint):
            return data
        if hint in (int, float) and isinstance(data, (int, float)) \
                and not isinstance(data, bool):
            return data          # annotation drift (int field, float value):
                                 # preserve the original value
        raise TypeError(f"cannot decode {type(data).__name__} as "
                        f"{hint.__name__}")
    if hint is bytes:
        return data.encode("latin-1") if isinstance(data, str) else data
    return data                              # Any / unhinted passthrough


def _decode_key(key_t: Any, k: str) -> Any:
    if typing.get_origin(key_t) in (tuple, typing.Tuple):
        parts = k.split("\x1f")
        args = typing.get_args(key_t)
        if args and args[-1] is not Ellipsis:
            return tuple(decode(t, p) for t, p in zip(args, parts))
        return tuple(parts)
    if key_t is int:
        return int(k)
    if key_t is float:
        return float(k)
    return k
