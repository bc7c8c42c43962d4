"""The benchmark's one traffic generator: a traffic mix's data file in,
the programs of a run out.

A mix (`zkbench/traffic/<mix>.json`) names its guest's builder as
`<module>.<function>` of `zkbench/guests/` (a new guest is a new module
there, found by that name), the builder's fixed arguments, which of them the seed draws, how many bytes
of hint input the seed draws, and what every program of the mix must
come to (its steps and segments, the same for every seed).  Program `i`
of a run is drawn from (seed, i): program 0 is the warm-up of set-up, the
window takes 1, 2, ...  Only a guest's data depends on the seed; its
instructions, steps and table heights do not.
"""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np

from .guests import builders

HERE = os.path.dirname(os.path.abspath(__file__))
TRAFFIC_DIR = os.path.join(HERE, "traffic")


def builder(name: str) -> Callable[..., bytes]:
    """The guest builder a mix names, `<module>.<function>` of
    `zkbench/guests/`."""
    module, function = name.rsplit(".", 1)
    return getattr(importlib.import_module(f"zkbench.guests.{module}"),
                   function)


@dataclass(frozen=True)
class Program:
    index: int
    code: bytes
    inputs: Tuple[bytes, ...]


def load_traffic(name: str, directory: str = TRAFFIC_DIR) -> dict:
    with open(os.path.join(directory, f"{name}.json")) as f:
        return json.load(f)


def rng_of(seed: int, index: int) -> np.random.Generator:
    """The generator of program `index` of a run seeded `seed` (any whole
    number: it is taken mod 2^64)."""
    return np.random.default_rng([seed % (1 << 64), index])


def program(traffic: dict, seed: int, index: int) -> Program:
    rng = rng_of(seed, index)
    args = dict(traffic["args"])
    for name in traffic.get("seeded_args", ()):
        args[name] = int(rng.integers(0, 1 << 32, dtype=np.uint64))
    code = builder(traffic["guest"])(**args)
    n = traffic.get("input_bytes", 0)
    inputs = (builders.hash_guest_input(n, rng),) if n else ()
    return Program(index, code, inputs)


def programs(traffic: dict, seed: int) -> list:
    """The warm-up program and every program the window may take."""
    return [program(traffic, seed, i)
            for i in range(traffic["max_programs"] + 1)]
