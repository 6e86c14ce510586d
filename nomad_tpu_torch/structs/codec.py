"""Struct codec: dataclasses <-> JSON-able dicts, driven by type hints
(port of nomad_tpu/structs/codec.py). ``encode`` walks a value
structurally; ``decode(cls, data)`` rebuilds the typed object graph from
the class's field hints. The HTTP API's node and alloc endpoints carry
structs in this form (register, pull allocs, allocs-update, the service
registrations of services-register), and so do state/restore.py's dumps
(a job plan's copy of the state, the operator snapshots), ACL policies,
roles and tokens and the service catalog included.

Both walks are the reference's, made cheap for the tens of thousands
of structs a dump holds: ``encode`` reads each dataclass type's field
names once, and ``decode`` builds one decoder function per type hint,
once, so a struct's fields are decoded without re-reading its hints.
The output is the reference codec's, value for value."""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Callable, Dict, Union

_HINT_CACHE: Dict[type, Dict[str, Any]] = {}
# type -> its dataclass field names, or None for a type that is not one
_FIELDS: Dict[type, Any] = {}
_PLAIN = frozenset((str, int, float, bool, type(None)))
# type hint -> its decoder (None in, None out)
_DECODERS: Dict[Any, Callable[[Any], Any]] = {}


def _field_names(t: type):
    try:
        return _FIELDS[t]
    except KeyError:
        names = (tuple(f.name for f in dataclasses.fields(t))
                 if dataclasses.is_dataclass(t) else None)
        _FIELDS[t] = names
        return names


def encode(obj: Any) -> Any:
    """Structural encode to JSON-able primitives. No type tags: decode is
    driven by the target class's type hints instead."""
    t = type(obj)
    if t in _PLAIN:
        return obj
    names = _field_names(t)
    if names is not None:
        out = {}
        for name in names:
            v = getattr(obj, name)
            out[name] = v if type(v) in _PLAIN else encode(v)
        return out
    hydrate = getattr(t, "__nomad_hydrate__", None)
    if hydrate is not None:
        # a lazy struct (alloc.LazyAllocMetric): encoding is a first
        # access, so the hydrated record is encoded (reference :25)
        return encode(hydrate(obj))
    if isinstance(obj, dict):
        return {_encode_key(k): v if type(v) in _PLAIN else encode(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [v if type(v) in _PLAIN else encode(v) for v in obj]
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
    return _decoder(hint)(data)


def _decoder(hint: Any) -> Callable[[Any], Any]:
    """The decoder of ``hint``, built once. A dataclass's decoder is
    registered before its fields' are built, so a struct that refers to
    its own type decodes too."""
    try:
        return _DECODERS[hint]
    except KeyError:
        pass
    except TypeError:                       # an unhashable hint
        return _build(hint, None)
    if dataclasses.is_dataclass(hint):
        slot: list = []
        _DECODERS[hint] = lambda data: slot[0](data)
        fn = _build(hint, slot)
    else:
        fn = _build(hint, None)
    _DECODERS[hint] = fn
    return fn


def _build(hint: Any, slot) -> Callable[[Any], Any]:
    origin = typing.get_origin(hint)
    if origin is Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if len(args) == 1:
            return _decoder(args[0])
        decs = [_decoder(a) for a in args]

        def union(data):
            if data is None:
                return None
            for dec in decs:                # first arg that decodes wins
                try:
                    return dec(data)
                except (TypeError, ValueError, KeyError):
                    continue
            return data
        return union
    if origin in (list, typing.List):
        (item_t,) = typing.get_args(hint) or (Any,)
        item = _decoder(item_t)
        return lambda data: None if data is None else [item(v) for v in data]
    if origin in (tuple, typing.Tuple):
        args = typing.get_args(hint)
        if len(args) == 2 and args[1] is Ellipsis:
            item = _decoder(args[0])
            return lambda data: (None if data is None else
                                 tuple(item(v) for v in data))
        if args:
            decs = [_decoder(t) for t in args]
            return lambda data: (None if data is None else
                                 tuple(d(v) for d, v in zip(decs, data)))
        return lambda data: None if data is None else tuple(data)
    if origin in (set, frozenset):
        (item_t,) = typing.get_args(hint) or (Any,)
        item = _decoder(item_t)
        if origin is frozenset:
            return lambda data: (None if data is None else
                                 frozenset({item(v) for v in data}))
        return lambda data: None if data is None else {item(v) for v in data}
    if origin in (dict, typing.Dict):
        args = typing.get_args(hint)
        key_t, val_t = args if args else (str, Any)
        val = _decoder(val_t)
        same = _passes(val_t)
        if key_t is str and same is True:
            return lambda data: None if data is None else dict(data)
        if key_t is str:
            return lambda data: (None if data is None else
                                 {k: v if type(v) in same else val(v)
                                  for k, v in data.items()})
        return lambda data: (None if data is None else
                             {_decode_key(key_t, k): val(v)
                              for k, v in data.items()})
    if dataclasses.is_dataclass(hint):
        hints = _hints(hint)
        fields = []
        for f in dataclasses.fields(hint):
            h = hints.get(f.name, Any)
            fields.append((f.name, _decoder(h), _passes(h)))

        def struct(data):
            if data is None:
                return None
            if not isinstance(data, dict):
                raise TypeError(f"cannot decode {type(data).__name__} "
                                f"as {hint.__name__}")
            kwargs = {}
            for name, dec, same in fields:
                if name in data:
                    v = data[name]
                    kwargs[name] = (v if same is True or type(v) in same
                                    else dec(v))
            return hint(**kwargs)
        slot.append(struct)
        return struct
    if hint in (int, float, bool, str):
        number = hint in (int, float)

        def scalar(data):
            if data is None or isinstance(data, hint):
                return data
            if number and isinstance(data, (int, float)) \
                    and not isinstance(data, bool):
                return data      # annotation drift (int field, float
                                 # value): preserve the original value
            raise TypeError(f"cannot decode {type(data).__name__} as "
                            f"{hint.__name__}")
        return scalar
    if hint is bytes:
        return lambda data: (data.encode("latin-1")
                             if isinstance(data, str) else data)
    return lambda data: data                 # Any / unhinted passthrough


_NONE = type(None)
_SAME = {int: frozenset((int, bool, float, _NONE)),
         float: frozenset((float, int, _NONE)),
         bool: frozenset((bool, _NONE)), str: frozenset((str, _NONE)),
         bytes: frozenset((bytes, _NONE))}


def _passes(hint: Any):
    """The value types ``hint``'s decoder returns as they are (True:
    every type), so a caller can skip the call for them."""
    origin = typing.get_origin(hint)
    if origin is Union:
        args = [a for a in typing.get_args(hint) if a is not _NONE]
        return _passes(args[0]) if len(args) == 1 else frozenset((_NONE,))
    if origin is not None or dataclasses.is_dataclass(hint):
        return frozenset((_NONE,))
    try:
        same = _SAME.get(hint)
    except TypeError:                       # an unhashable hint
        return frozenset((_NONE,))
    return True if same is None else same


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
