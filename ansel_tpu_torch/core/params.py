"""Versioned, binary-compatible op parameter structs.

The reference serializes each module's C params struct verbatim into the
history blob (introspection system, `ansel/src/common/introspection.h`;
XMP encoding `src/common/exif.cc:2355-2490`: either a hex string or
"gz" + 2-digit compression factor + base64(zlib)).  To consume real Ansel /
Darktable XMP sidecars we mirror each struct's exact byte layout here with a
declarative field table compiled to `struct` format strings.

Python-side, params are plain dataclasses; the codec is attached by the
``@params`` decorator:

    @params(op="exposure", version=6)
    @dataclasses.dataclass
    class ExposureParams:
        mode: int = cfield("i", 0)
        black: float = cfield("f", 0.0)
        ...

C structs use natural alignment; all reference params fields are 1/2/4-byte
scalars or arrays thereof, so standard struct packing with explicit "<"
little-endian layout plus manual padding entries reproduces the layout.
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple, Type

_REGISTRY: Dict[Tuple[str, int], Type] = {}
_LATEST: Dict[str, Type] = {}


def cfield(ctype: str, default: Any, **extra) -> dataclasses.Field:
    """Declare a dataclass field with a C type code.

    ctype: struct codes — "i", "f", "H", "B", ... ; arrays as "4H", "3f";
    fixed C strings as "s:64"; padding as "x:3" (declare via pad()).
    """
    md = {"ctype": ctype}
    md.update(extra)
    if isinstance(default, (list, tuple)):
        return dataclasses.field(default_factory=lambda d=tuple(default): d, metadata=md)
    return dataclasses.field(default=default, metadata=md)


def _parse_ctype(ctype: str) -> Tuple[str, int, bool]:
    """-> (struct code for one element, count, is_string)."""
    if ctype.startswith("raw:"):   # fixed-size opaque bytes (array-of-struct)
        n = int(ctype[4:])
        return f"{n}s", 1, "raw"
    if ctype.startswith("s:"):
        n = int(ctype[2:])
        return f"{n}s", 1, True
    # leading count
    i = 0
    while i < len(ctype) and ctype[i].isdigit():
        i += 1
    count = int(ctype[:i]) if i else 1
    return ctype[i:], count, False


class _Codec:
    def __init__(self, cls: Type):
        self.cls = cls
        fmt = "<"
        self.layout: List[Tuple[str, str, int, bool]] = []
        for f in dataclasses.fields(cls):
            ct = f.metadata.get("ctype")
            if ct is None:
                continue  # python-only field, not serialized
            code, count, is_str = _parse_ctype(ct)
            self.layout.append((f.name, code, count, is_str))
            fmt += code * count if not is_str else code
        self.struct = struct.Struct(fmt)
        self.size = self.struct.size

    def decode(self, raw: bytes):
        if len(raw) < self.size:
            raise ValueError(
                f"{self.cls.__name__}: blob {len(raw)}B < struct {self.size}B"
            )
        vals = self.struct.unpack(raw[: self.size])
        kwargs = {}
        i = 0
        for name, code, count, is_str in self.layout:
            if is_str == "raw":
                kwargs[name] = vals[i]
                i += 1
            elif is_str:
                kwargs[name] = vals[i].split(b"\0", 1)[0].decode("utf-8", "replace")
                i += 1
            elif count == 1:
                kwargs[name] = vals[i]
                i += 1
            else:
                kwargs[name] = tuple(vals[i : i + count])
                i += count
        return self.cls(**kwargs)

    def encode(self, obj) -> bytes:
        vals: List[Any] = []
        for name, code, count, is_str in self.layout:
            v = getattr(obj, name)
            if is_str == "raw":
                vals.append(bytes(v))
            elif is_str:
                vals.append(str(v).encode("utf-8"))
            elif count == 1:
                vals.append(int(v) if code in "bBhHiIlLqQ" else v)
            else:
                seq = list(v)
                if len(seq) != count:
                    raise ValueError(f"{name}: expected {count} elements")
                vals.extend(seq)
        return self.struct.pack(*vals)


def params(op: str, version: int):
    """Class decorator registering a params struct for (op, version)."""

    def wrap(cls: Type) -> Type:
        cls.op_name = op
        cls.op_version = version
        cls.codec = _Codec(cls)
        _REGISTRY[(op, version)] = cls
        cur = _LATEST.get(op)
        if cur is None or cur.op_version < version:
            _LATEST[op] = cls
        return cls

    return wrap


def params_class(op: str, version: Optional[int] = None) -> Type:
    if version is None:
        return _LATEST[op]
    return _REGISTRY[(op, version)]


def known_ops() -> List[str]:
    return sorted(_LATEST)


def decode_blob(op: str, version: int, raw: bytes):
    """raw struct bytes -> params dataclass, applying legacy migration if the
    exact version isn't registered but a newer one provides `from_legacy`."""
    cls = _REGISTRY.get((op, version))
    if cls is not None:
        return cls.codec.decode(raw)
    latest = _LATEST.get(op)
    if latest is not None and hasattr(latest, "from_legacy"):
        migrated = latest.from_legacy(version, raw)
        if migrated is not None:
            return migrated
    raise KeyError(f"no params struct registered for {op} v{version}")


def xmp_decode(text: str) -> bytes:
    """Decode an XMP params payload (reference src/common/exif.cc:2446-2520):
    "gz"+factor+base64(zlib) or plain hex."""
    if text.startswith("gz"):
        compressed = base64.b64decode(text[4:])
        return zlib.decompress(compressed)
    return binascii.unhexlify(text.strip())


def xmp_encode(raw: bytes, compress: bool = None) -> str:
    if compress is None:
        compress = len(raw) > 100  # reference COMPRESS_THRESHOLD, exif.cc:2357
    if compress:
        comp = zlib.compress(raw)
        factor = min(len(raw) // len(comp) + 1, 99)
        return f"gz{factor:02d}" + base64.b64encode(comp).decode("ascii")
    return binascii.hexlify(raw).decode("ascii")
