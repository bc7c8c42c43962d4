"""STARK -> SNARK wrap: the reference's `wrap_stark_bn254` / `as_groth16`
analog (recursion/src/lib.rs:92-169, snark/snarks.rs:7-18), in-repo.

Copy of zkm_tpu/snark/wrap.py.  Consumes an exported proof document (the
port's `export.export_proof` of the final aggregation/block proof, with
its `program_cap`), packs its claim into BN254 scalar limbs, and produces
a Groth16 proof whose public inputs are the claim limbs plus their
in-circuit MiMC digest — the same public-input-compression role the
reference's plonky2x WrappedCircuit + gnark pipeline plays (public inputs
packed to bit-bounded field elements, recursion/src/lib.rs:119-133, then
hashed inside the wrapper).

DOCUMENTED DEVIATION (docs/cross_verification.md): the reference's gnark
circuit re-verifies the plonky2 block proof inside the SNARK
(gnark-plonky2-verifier); here the STARK chain is verified natively before
wrapping, and the SNARK binds the verified claim + proof commitment to
the on-chain digest.  An in-circuit Goldilocks-STARK verifier over BN254
is out of scope for a pure-Python R1CS (≈10^8 non-native-field
constraints); the R1CS module (r1cs.py) is the extension point if one
is added.

The proving key is cached in `cache_dir` (default: the port's
`recursion.cache.CACHE_DIR`), never in zkm_tpu's cache: a pickle written
by one package is not read by the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
from dataclasses import dataclass
from typing import List, Optional

from . import groth16 as g16
from . import mimc
from .r1cs import R1CS

# claim layout: 10 limbs, each < 2^128 (so well inside Fr)
CLAIM_LIMBS = 10
LIMB_LABELS = [
    "roots_before_lo", "roots_before_hi",
    "roots_after_lo", "roots_after_hi",
    "userdata_lo", "userdata_hi",
    "vk_digest_lo", "vk_digest_hi",
    "proof_digest_lo", "proof_digest_hi",
]


def _pack_u32x8(words: List[int]) -> List[int]:
    """8 u32 words -> 2 x 128-bit limbs (big-endian word order)."""
    acc = 0
    for w in words:
        acc = (acc << 32) | (int(w) & 0xFFFFFFFF)
    return [acc >> 128, acc & ((1 << 128) - 1)][::-1]   # [lo, hi]


def _split_bytes32(b: bytes) -> List[int]:
    v = int.from_bytes(b, "big")
    return [v & ((1 << 128) - 1), v >> 128]


def claim_limbs(doc: dict) -> List[int]:
    """Exported proof document -> the 10 claim limbs."""
    pv = doc["public_values"]
    limbs = []
    limbs += _pack_u32x8([int(v) for v in pv["roots_before"]])
    limbs += _pack_u32x8([int(v) for v in pv["roots_after"]])
    limbs += _split_bytes32(bytes.fromhex(pv["userdata"]))
    vk_blob = json.dumps(doc.get("program_cap"), sort_keys=True).encode()
    limbs += _split_bytes32(hashlib.sha256(vk_blob).digest())
    proof_blob = json.dumps(doc["stark_proofs"], sort_keys=True).encode()
    limbs += _split_bytes32(hashlib.sha256(proof_blob).digest())
    assert len(limbs) == CLAIM_LIMBS
    return limbs


def build_wrap_circuit(limbs: List[int]) -> R1CS:
    """Publics: [digest, limb_0..limb_9]; constraint: digest ==
    MiMC-MP(limbs)."""
    digest = mimc.hash_elements(limbs)
    cs = R1CS()
    d_pub = cs.alloc(digest, public=True)
    limb_wires = [cs.alloc(v, public=True) for v in limbs]
    d_computed = mimc.hash_elements_circuit(cs, limb_wires)
    cs.assert_eq(d_computed, d_pub)
    return cs


@dataclass
class WrappedProof:
    proof: g16.Proof
    public_inputs: List[int]       # [digest] + claim limbs
    vk: g16.VerifyingKey

    def to_json(self) -> str:
        """gnark-compatible layout (snark_proof_with_public_inputs.json,
        reference libsnark/snark_prover.go:296-303)."""
        pf = self.proof
        return json.dumps({
            "proof": {
                "a": [str(pf.a[0].n), str(pf.a[1].n)],
                "b": [[str(v) for v in pf.b[0].coeffs],
                      [str(v) for v in pf.b[1].coeffs]],
                "c": [str(pf.c[0].n), str(pf.c[1].n)],
            },
            "public_inputs": [str(v) for v in self.public_inputs],
        })


_PK_CACHE: dict = {}
_PK_VERSION = 1   # bump when the wrap circuit or MiMC constants change


def _pk_path(cache_dir: Optional[str] = None) -> str:
    from ..recursion.cache import CACHE_DIR
    cache_dir = cache_dir or CACHE_DIR
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"groth16_wrap_pk_v{_PK_VERSION}.pkl")


def groth16_setup(force: bool = False, cache_dir: Optional[str] = None,
                  seed: Optional[bytes] = None) -> g16.ProvingKey:
    """Build (or reuse) the wrap circuit's proving key.  The circuit shape
    is claim-independent, so one setup serves every wrap; the key persists
    in `cache_dir` so later processes skip the ~100 s setup (the reference
    caches its R1CS/pk/vk on disk the same way, snark_prover.go:144-259).
    `seed` pins the setup's randomness (tests only, see `groth16.setup`);
    a seeded key is made afresh, never read from or written to the
    cache."""
    if seed is not None:
        return g16.setup(build_wrap_circuit([0] * CLAIM_LIMBS), seed=seed)
    path = _pk_path(cache_dir)
    if path in _PK_CACHE and not force:
        return _PK_CACHE[path]
    if not force:
        try:
            with open(path, "rb") as f:
                _PK_CACHE[path] = pickle.load(f)
            return _PK_CACHE[path]
        except (OSError, pickle.UnpicklingError, EOFError):
            pass
    pk = g16.setup(build_wrap_circuit([0] * CLAIM_LIMBS))
    _PK_CACHE[path] = pk
    save_proving_key(pk, cache_dir)
    return pk


def save_proving_key(pk: g16.ProvingKey,
                     cache_dir: Optional[str] = None) -> None:
    """Write `pk` where `groth16_setup(cache_dir=cache_dir)` reads it
    (atomically; a failed write leaves no file)."""
    path = _pk_path(cache_dir)
    try:
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(pk, f)
        os.replace(tmp, path)
    except OSError:
        pass


def wrap_stark_bn254(doc: dict, pk: Optional[g16.ProvingKey] = None,
                     blind_seed: Optional[bytes] = None) -> WrappedProof:
    """Exported (already natively verified) proof document -> Groth16
    wrap.  Callers are expected to verify the proof (the port's
    `stark.verifier.verify_proof` or `recursion.shrink.verify_shrink`)
    before exporting.  `blind_seed` pins the prover's blinding (tests
    only, see `groth16.prove`)."""
    limbs = claim_limbs(doc)
    cs = build_wrap_circuit(limbs)
    assert cs.is_satisfied()
    if pk is None:
        pk = groth16_setup()
    proof = g16.prove(pk, cs, blind_seed=blind_seed)
    publics = cs.values[1:cs.num_public + 1]
    assert g16.verify(pk.vk, publics, proof)
    return WrappedProof(proof=proof, public_inputs=publics, vk=pk.vk)
