"""The proto3 codec of ``evaluate.proto``, written by hand.

This module is written against ``evaluate.proto`` (beside it, the wire
contract of the Evaluate sidecar); it is not protoc output, and it imports
neither ``google.protobuf`` nor ``grpc``, so the sidecar and its client run
on a host that has neither.  It keeps the generated module's name and
class names (``pb.SweepRequest`` reads as it would with protoc's module)
and implements what ``rpc/sidecar.py`` and ``drivers/remote.py`` use:

- construction by keyword, attribute access and assignment (checked
  against the field's type, as protobuf checks it);
- ``.add()`` on repeated message fields, ``.append()`` and ``.extend()`` on
  every repeated field, index assignment on repeated string and bytes
  fields, item assignment and ``update`` on the one map field
  (``StatusResponse.fallback``, ``map<string, string>``);
- ``SerializeToString()`` and the ``FromString()`` classmethod.

The encoding is proto3's: fields in number order, scalars at their default
value ("", b"", False, 0) left off the wire, a negative ``int32`` or
``int64`` as a ten-byte varint, strings UTF-8.  A map entry carries its key
and value even where they are empty, as protobuf's encoder writes them.
Parsing skips fields it does not know (or whose wire type does not match
the field's), keeps the last value of a singular field seen twice, and
raises ``DecodeError`` on a truncated or malformed message."""

from __future__ import annotations

from typing import NamedTuple, Optional

# field types and labels, numbered as in descriptor.proto
TYPE_INT64 = 3
TYPE_INT32 = 5
TYPE_BOOL = 8
TYPE_STRING = 9
TYPE_MESSAGE = 11
TYPE_BYTES = 12
LABEL_OPTIONAL = 1
LABEL_REPEATED = 3

_MASK64 = (1 << 64) - 1
_LIMITS = {TYPE_INT32: (-(1 << 31), (1 << 31) - 1),
           TYPE_INT64: (-(1 << 63), (1 << 63) - 1)}
_DEFAULTS = {TYPE_INT64: 0, TYPE_INT32: 0, TYPE_BOOL: False,
             TYPE_STRING: "", TYPE_BYTES: b""}


class DecodeError(Exception):
    """The bytes are not a well-formed message of the type parsed."""


class Field(NamedTuple):
    name: str
    number: int
    type: int
    label: int = LABEL_OPTIONAL
    message: Optional[str] = None  # the message type of a TYPE_MESSAGE
    map: bool = False  # a map field: repeated entries of ``message``


_S, _B = TYPE_STRING, TYPE_BYTES
_R = LABEL_REPEATED

# every message of evaluate.proto (package gatekeeper.tpu.v1), its fields in
# number order
FIELDS: dict = {
    "ReconcileRequest": (
        Field("verb", 1, _S), Field("object_json", 2, _B),
        Field("path", 3, _S, _R), Field("kind", 4, _S)),
    "ReconcileResponse": (
        Field("error", 1, _S), Field("lowered", 2, _S, _R)),
    "Review": (
        Field("admission_request_json", 1, _B),
        Field("namespace_json", 2, _B), Field("source", 3, _S),
        Field("is_admission", 4, TYPE_BOOL)),
    "QueryBatchRequest": (
        Field("reviews", 1, TYPE_MESSAGE, _R, "Review"),
        Field("enforcement_point", 2, _S),
        Field("render_messages", 3, TYPE_BOOL),
        Field("constraint_keys", 4, _S, _R)),
    "Result": (
        Field("constraint_json", 1, _B), Field("msg", 2, _S),
        Field("details_json", 3, _B)),
    "ReviewResults": (
        Field("results", 1, TYPE_MESSAGE, _R, "Result"),),
    "QueryBatchResponse": (
        Field("responses", 1, TYPE_MESSAGE, _R, "ReviewResults"),
        Field("error", 2, _S)),
    "SweepRequest": (
        Field("object_json", 1, _B, _R),
        Field("violations_limit", 2, TYPE_INT32),
        Field("exact_totals", 3, TYPE_BOOL),
        Field("enforcement_point", 4, _S),
        Field("constraint_keys", 5, _S, _R)),
    "KeptViolation": (
        Field("object_index", 1, TYPE_INT32), Field("msg", 2, _S),
        Field("details_json", 3, _B)),
    "ConstraintSweep": (
        Field("kind", 1, _S), Field("name", 2, _S),
        Field("total", 3, TYPE_INT64),
        Field("kept", 4, TYPE_MESSAGE, _R, "KeptViolation")),
    "SweepResponse": (
        Field("constraints", 1, TYPE_MESSAGE, _R, "ConstraintSweep"),
        Field("error", 2, _S)),
    "StatusRequest": (),
    "StatusResponse": (
        Field("lowered", 1, _S, _R),
        Field("fallback", 2, TYPE_MESSAGE, _R,
              "StatusResponse.FallbackEntry", map=True),
        Field("n_devices", 3, TYPE_INT32), Field("platform", 4, _S),
        Field("n_templates", 5, TYPE_INT64),
        Field("n_constraints", 6, TYPE_INT64)),
    "StatusResponse.FallbackEntry": (
        Field("key", 1, _S), Field("value", 2, _S)),
}


# --- wire primitives ---------------------------------------------------------
_ONE_BYTE = [bytes((i,)) for i in range(128)]


def _varint(n: int) -> bytes:
    if n < 0x80:
        return _ONE_BYTE[n] if n >= 0 else _varint(n & _MASK64)
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(data: bytes, pos: int, end: int) -> tuple:
    if pos >= end:
        raise DecodeError("truncated varint")
    b = data[pos]
    if b < 0x80:
        return b, pos + 1
    result = b & 0x7F
    shift = 7
    pos += 1
    while True:
        if pos >= end:
            raise DecodeError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


def _utf8(data: bytes, name: str) -> str:
    try:
        return data.decode("utf-8")
    except UnicodeDecodeError as e:
        raise DecodeError(f"field {name}: invalid UTF-8") from e


def _checked(f: Field, value):
    """``value`` as field ``f`` stores it, or TypeError/ValueError."""
    t = f.type
    if t == TYPE_STRING:
        if isinstance(value, str):
            return value
        if isinstance(value, bytes):
            try:
                return value.decode("utf-8")
            except UnicodeDecodeError:
                raise ValueError(f"field {f.name}: bytes are not UTF-8")
    elif t == TYPE_BYTES:
        if isinstance(value, bytes):
            return value
        if isinstance(value, (bytearray, memoryview)):
            return bytes(value)
    elif t == TYPE_BOOL:
        if isinstance(value, int):
            return bool(value)
    elif t in _LIMITS:
        if isinstance(value, int):
            lo, hi = _LIMITS[t]
            if not lo <= value <= hi:
                raise ValueError(f"field {f.name}: {value} out of range")
            return int(value)
    raise TypeError(f"field {f.name}: {type(value).__name__} value "
                    f"{value!r:.60} has the wrong type")


# --- containers --------------------------------------------------------------
class RepeatedScalar(list):
    """A repeated string or bytes field: a list whose writes are checked."""

    __slots__ = ("_field",)

    def __init__(self, field: Field):
        super().__init__()
        self._field = field

    def append(self, value) -> None:
        super().append(_checked(self._field, value))

    def extend(self, values) -> None:
        super().extend([_checked(self._field, v) for v in values])

    def __setitem__(self, i: int, value) -> None:
        super().__setitem__(i, _checked(self._field, value))


class RepeatedMessage(list):
    """A repeated message field: ``add(**fields)`` appends a new message."""

    __slots__ = ("_cls",)

    def __init__(self, cls):
        super().__init__()
        self._cls = cls

    def _check(self, msg):
        if not isinstance(msg, self._cls):
            raise TypeError(f"expected {self._cls.__name__}, got "
                            f"{type(msg).__name__}")
        return msg

    def add(self, **fields):
        msg = self._cls(**fields)
        super().append(msg)
        return msg

    def append(self, msg) -> None:
        super().append(self._check(msg))

    def extend(self, msgs) -> None:
        super().extend([self._check(m) for m in msgs])


class ScalarMap(dict):
    """The ``map<string, string>`` field: a dict whose writes are checked."""

    __slots__ = ("_key", "_value")

    def __init__(self, entry_fields: tuple):
        super().__init__()
        self._key, self._value = entry_fields

    def __setitem__(self, key, value) -> None:
        super().__setitem__(_checked(self._key, key),
                            _checked(self._value, value))

    def update(self, *args, **kwargs) -> None:
        for k, v in dict(*args, **kwargs).items():
            self[k] = v


# --- messages ----------------------------------------------------------------
_CLASSES: dict = {}


class Message:
    """Base of the message classes below (one per entry of ``FIELDS``)."""

    _name = ""
    _fields: tuple = ()
    _by_name: dict = {}
    _by_number: dict = {}

    def __init__(self, **fields):
        d = self.__dict__
        for f in self._fields:
            if f.map:
                d[f.name] = ScalarMap(FIELDS[f.message])
            elif f.label == LABEL_REPEATED:
                d[f.name] = (RepeatedMessage(_CLASSES[f.message])
                             if f.type == TYPE_MESSAGE else RepeatedScalar(f))
            else:
                d[f.name] = _DEFAULTS[f.type]
        for name, value in fields.items():
            f = self._by_name.get(name)
            if f is None:
                raise ValueError(f'Protocol message {self._name} has no '
                                 f'"{name}" field.')
            if f.map:
                d[name].update(value)
            elif f.label == LABEL_REPEATED:
                d[name].extend(value)
            else:
                d[name] = _checked(f, value)

    def __setattr__(self, name, value) -> None:
        f = self._by_name.get(name)
        if f is None:
            raise AttributeError(f'Protocol message {self._name} has no '
                                 f'"{name}" field.')
        if f.label == LABEL_REPEATED:
            raise AttributeError(f"Assignment not allowed to repeated field "
                                 f'"{name}" in protocol message object.')
        self.__dict__[name] = _checked(f, value)

    def __eq__(self, other) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return self.__dict__ == other.__dict__

    # --- encoding ---------------------------------------------------------
    def SerializeToString(self) -> bytes:
        out = bytearray()
        d = self.__dict__
        for f in self._fields:
            value = d[f.name]
            if not value:
                continue  # proto3: default scalars and empty repeats
            tag = _varint((f.number << 3) | (0 if f.type in _WIRE0 else 2))
            if f.map:
                for k, v in value.items():
                    kb, vb = k.encode("utf-8"), v.encode("utf-8")
                    entry = (b"\x0a" + _varint(len(kb)) + kb + b"\x12"
                             + _varint(len(vb)) + vb)
                    out += tag
                    out += _varint(len(entry))
                    out += entry
            elif f.label == LABEL_REPEATED:
                encode = (Message.SerializeToString
                          if f.type == TYPE_MESSAGE else
                          str.encode if f.type == TYPE_STRING else bytes)
                for item in value:
                    b = encode(item)
                    out += tag
                    out += _varint(len(b))
                    out += b
            elif f.type == TYPE_STRING:
                b = value.encode("utf-8")
                out += tag
                out += _varint(len(b))
                out += b
            elif f.type == TYPE_BYTES:
                out += tag
                out += _varint(len(value))
                out += value
            elif f.type == TYPE_BOOL:
                out += tag
                out += b"\x01"
            else:  # int32 / int64: two's complement in 64 bits
                out += tag
                out += _varint(value & _MASK64)
        return bytes(out)

    # --- decoding ---------------------------------------------------------
    @classmethod
    def FromString(cls, data):
        msg = cls()
        data = bytes(data)
        msg._parse(data, 0, len(data))
        return msg

    def _parse(self, data: bytes, pos: int, end: int) -> None:
        d = self.__dict__
        by_number = self._by_number
        while pos < end:
            tag, pos = _read_varint(data, pos, end)
            number, wire = tag >> 3, tag & 7
            if number == 0:
                raise DecodeError("field number 0")
            f = by_number.get(number)
            if wire == 0:
                value, pos = _read_varint(data, pos, end)
                if f is None or f.type not in _WIRE0 or \
                        f.label == LABEL_REPEATED:
                    continue
                if f.type == TYPE_BOOL:
                    d[f.name] = value != 0
                elif f.type == TYPE_INT32:
                    value &= 0xFFFFFFFF
                    d[f.name] = value - (1 << 32) if value >> 31 else value
                else:
                    value &= _MASK64
                    d[f.name] = value - (1 << 64) if value >> 63 else value
            elif wire == 2:
                n, pos = _read_varint(data, pos, end)
                stop = pos + n
                if stop > end:
                    raise DecodeError("truncated length-delimited field")
                if f is not None and f.type not in _WIRE0:
                    self._parse_delimited(f, data, pos, stop)
                pos = stop
            elif wire == 1:
                pos += 8
            elif wire == 5:
                pos += 4
            else:
                raise DecodeError(f"unsupported wire type {wire}")
        if pos != end:
            raise DecodeError("truncated fixed-width field")

    def _parse_delimited(self, f: Field, data: bytes, pos: int,
                         stop: int) -> None:
        d = self.__dict__
        if f.type == TYPE_MESSAGE:
            sub = _CLASSES[f.message]()
            sub._parse(data, pos, stop)
            if f.map:
                dict.__setitem__(d[f.name], sub.key, sub.value)
            else:
                list.append(d[f.name], sub)
            return
        value = data[pos:stop]
        if f.type == TYPE_STRING:
            value = _utf8(value, f.name)
        if f.label == LABEL_REPEATED:
            list.append(d[f.name], value)
        else:
            d[f.name] = value


_WIRE0 = (TYPE_INT64, TYPE_INT32, TYPE_BOOL)


def _message_class(name: str, fields: tuple) -> type:
    attrs = {"_name": name, "_fields": fields,
             "_by_name": {f.name: f for f in fields},
             "_by_number": {f.number: f for f in fields},
             "__module__": __name__,
             "__qualname__": name}
    return type(name.rsplit(".", 1)[-1], (Message,), attrs)


for _name, _fields in FIELDS.items():
    _CLASSES[_name] = _message_class(_name, _fields)

ReconcileRequest = _CLASSES["ReconcileRequest"]
ReconcileResponse = _CLASSES["ReconcileResponse"]
Review = _CLASSES["Review"]
QueryBatchRequest = _CLASSES["QueryBatchRequest"]
Result = _CLASSES["Result"]
ReviewResults = _CLASSES["ReviewResults"]
QueryBatchResponse = _CLASSES["QueryBatchResponse"]
SweepRequest = _CLASSES["SweepRequest"]
KeptViolation = _CLASSES["KeptViolation"]
ConstraintSweep = _CLASSES["ConstraintSweep"]
SweepResponse = _CLASSES["SweepResponse"]
StatusRequest = _CLASSES["StatusRequest"]
StatusResponse = _CLASSES["StatusResponse"]
StatusResponse.FallbackEntry = _CLASSES["StatusResponse.FallbackEntry"]
