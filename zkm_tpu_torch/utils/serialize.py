"""bincode-1.x-compatible serialization for guest I/O.

Copy of zkm_tpu/utils/serialize.py.  Reference: `bincode::serialize_into`
in zkMIPS emulator/src/state.rs:448-452 and the Go runtime's
reflection serializer (go-runtime/zkm_runtime/serialize.go).  Legacy bincode
config: little-endian, fixed-width integers, u64 length prefixes.

Python mapping:
  bytes/bytearray       -> Vec<u8>
  str                   -> String
  bool                  -> bool
  int                   -> u32 by default; use U8/U16/U32/U64/I32/I64 wrappers
  list                  -> Vec<T>
  tuple                 -> struct fields in order (no prefix)
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class _Fixed:
    value: int
    width: int
    signed: bool

    def encode(self) -> bytes:
        return int(self.value).to_bytes(self.width, "little",
                                        signed=self.signed)


def U8(v): return _Fixed(v, 1, False)
def U16(v): return _Fixed(v, 2, False)
def U32(v): return _Fixed(v, 4, False)
def U64(v): return _Fixed(v, 8, False)
def I32(v): return _Fixed(v, 4, True)
def I64(v): return _Fixed(v, 8, True)


def bincode_serialize(value) -> bytes:
    out = bytearray()
    _ser(value, out)
    return bytes(out)


def _ser(v, out: bytearray):
    if isinstance(v, _Fixed):
        out.extend(v.encode())
    elif isinstance(v, bool):
        out.append(1 if v else 0)
    elif isinstance(v, int):
        out.extend(v.to_bytes(4, "little"))
    elif isinstance(v, (bytes, bytearray)):
        out.extend(len(v).to_bytes(8, "little"))
        out.extend(v)
    elif isinstance(v, str):
        raw = v.encode()
        out.extend(len(raw).to_bytes(8, "little"))
        out.extend(raw)
    elif isinstance(v, list):
        out.extend(len(v).to_bytes(8, "little"))
        for item in v:
            _ser(item, out)
    elif isinstance(v, tuple):
        for item in v:
            _ser(item, out)
    else:
        raise TypeError(f"cannot bincode-serialize {type(v)}")


def bincode_deserialize_vec_u8(data: bytes, offset: int = 0):
    n = int.from_bytes(data[offset:offset + 8], "little")
    start = offset + 8
    return data[start:start + n], start + n


def bincode_deserialize(data: bytes, spec, offset: int = 0):
    """Schema-driven deserializer for reading committed public values
    typed (reference `State::read_public_values::<T>`,
    emulator/src/state.rs:455-459; Go deserialize.go).

    spec: "u8"/"u16"/"u32"/"u64"/"i32"/"i64"/"bool" for scalars, "bytes"
    or "str" for length-prefixed data, ("vec", inner) for Vec<inner>, and
    a tuple of specs for a struct.  Returns (value, new_offset)."""
    widths = {"u8": (1, False), "u16": (2, False), "u32": (4, False),
              "u64": (8, False), "i32": (4, True), "i64": (8, True)}
    if isinstance(spec, tuple) and spec and spec[0] == "vec":
        n = int.from_bytes(data[offset:offset + 8], "little")
        offset += 8
        out = []
        for _ in range(n):
            v, offset = bincode_deserialize(data, spec[1], offset)
            out.append(v)
        return out, offset
    if isinstance(spec, tuple):           # struct: fields in order
        out = []
        for field in spec:
            v, offset = bincode_deserialize(data, field, offset)
            out.append(v)
        return tuple(out), offset
    if spec in widths:
        w, signed = widths[spec]
        return int.from_bytes(data[offset:offset + w], "little",
                              signed=signed), offset + w
    if spec == "bool":
        return bool(data[offset]), offset + 1
    if spec in ("bytes", "str"):
        raw, offset = bincode_deserialize_vec_u8(data, offset)
        return (raw.decode() if spec == "str" else raw), offset
    raise TypeError(f"unknown bincode spec {spec!r}")
