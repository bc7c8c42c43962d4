# Frozen copy of zkm_tpu_torch/utils/serialize.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
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


# frozen: left out, as only the prover uses them: U8, U16, U32, U64, I32,
# I64, bincode_deserialize_vec_u8, bincode_deserialize.


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

