"""zkm_tpu_torch's SNARK layer (BN254, R1CS, MiMC, Groth16, the wrap and
verifier.sol) against zkm_tpu's, on the same numpy-seeded inputs.  Every
value is an integer, so equality is exact (tolerance zero).

The production-shape wrap (4,572 constraints) takes ~100 s of setup and
~25 s of proving in pure Python, so the default tests hold every layer on
small statements and on the wrap circuit's constraints; the seeded wrap
of the frozen record is the slow test.  The record is made again with

    python tests/test_torch_snark.py --write

which runs zkm_tpu's seeded setup and prove on the wrap circuit of
zkm_tpu's toy aggregation root (recursion_toy_reference.json) and writes
`zkm_tpu_torch/data/wrap_reference.json` (a few minutes on a CPU).
"""

import hashlib
import json
import os
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))

from zkm_tpu.snark import bn254 as rc  # noqa: E402
from zkm_tpu.snark import contract as rcontract  # noqa: E402
from zkm_tpu.snark import groth16 as rg16  # noqa: E402
from zkm_tpu.snark import mimc as rmimc  # noqa: E402
from zkm_tpu.snark import r1cs as rr1cs  # noqa: E402
from zkm_tpu.snark import wrap as rwrap  # noqa: E402
from zkm_tpu_torch import export  # noqa: E402
from zkm_tpu_torch.recursion import cache  # noqa: E402
from zkm_tpu_torch.snark import bn254 as c  # noqa: E402
from zkm_tpu_torch.snark import contract, groth16 as g16, mimc, r1cs, wrap  # noqa: E402,E501
from zkm_tpu_torch.witness.trace_set import DATA  # noqa: E402

WRAP_RECORD = os.path.join(DATA, "wrap_reference.json")
TOY_RECORD = os.path.join(DATA, "recursion_toy_reference.json")
SETUP_SEED = b"zkm wrap reference setup"
BLIND_SEED = b"zkm wrap reference blinding"


def scalars(seed: int, n: int, bits: int = 256):
    """n scalars below 2^bits drawn from numpy's generator `seed`."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (n, (bits + 31) // 32), dtype=np.uint64)
    return [int.from_bytes(w.astype(">u4").tobytes(), "big") >> (
        32 * len(w) - bits) for w in words]


def read_wrapped_json(text: str):
    """The Groth16 proof and public inputs of `WrappedProof.to_json`'s text
    (what `cli wrap` writes), for `groth16.verify`."""
    d = json.loads(text)
    pf = d["proof"]
    a, cc = ((c.FQ(int(x)), c.FQ(int(y))) for x, y in (pf["a"], pf["c"]))
    b = tuple(c.FQ2([int(v) for v in xy]) for xy in pf["b"])
    return g16.Proof(a=a, b=b, c=cc), [int(v) for v in d["public_inputs"]]


def plain(x):
    """A point, field element, key or proof of either package as plain
    ints (for comparing the two packages' objects)."""
    if x is None or isinstance(x, int):
        return x
    if hasattr(x, "n"):
        return x.n
    if hasattr(x, "coeffs"):
        return list(x.coeffs)
    if isinstance(x, (tuple, list)):
        return [plain(v) for v in x]
    return {k: plain(v) for k, v in vars(x).items()}


def into(mod, x):
    """A point (or list of points) of one package rebuilt in `mod`."""
    if x is None:
        return None
    if isinstance(x, list):
        return [into(mod, v) for v in x]
    return tuple(mod.FQ(v.n) if hasattr(v, "n") else mod.FQ2(list(v.coeffs))
                 for v in x)


def vk_into(g16_mod, bn_mod, vk):
    return g16_mod.VerifyingKey(**{k: into(bn_mod, v)
                                   for k, v in vars(vk).items()})


def proof_into(g16_mod, bn_mod, pf):
    return g16_mod.Proof(a=into(bn_mod, pf.a), b=into(bn_mod, pf.b),
                         c=into(bn_mod, pf.c))


# ---------------------------------------------------------------------------
# 1. BN254: fields, group law, MSM, pairing.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", ["G1", "G2"])
def test_group_law_matches_reference(group):
    base, rbase = getattr(c, group), getattr(rc, group)
    s = scalars(1, 6)
    for k in s:
        p, rp = c.multiply(base, k), rc.multiply(rbase, k)
        assert plain(p) == plain(rp)
        q, rq = c.multiply(base, k >> 7), rc.multiply(rbase, k >> 7)
        assert plain(c.add(p, q)) == plain(rc.add(rp, rq))
        assert plain(c.double(p)) == plain(rc.double(rp))
        assert plain(c.neg(p)) == plain(rc.neg(rp))
        assert plain(c.from_jac(c.jadd(c.to_jac(p), c.jdouble(c.to_jac(q))))) \
            == plain(c.add(p, c.double(q)))
    assert c.multiply(base, c.R) is None
    assert plain(c.FixedBase(base).mul(s[0])) == plain(c.multiply(base, s[0]))


@pytest.mark.parametrize("group,n", [("G1", 1), ("G1", 17), ("G2", 9)])
def test_msm_matches_reference(group, n):
    base, rbase = getattr(c, group), getattr(rc, group)
    ks, ss = scalars(2, n), scalars(3, n)
    pts = [c.multiply(base, k) for k in ks]
    rpts = [rc.multiply(rbase, k) for k in ks]
    pts[0], rpts[0] = None, None           # the identity is skipped
    got = c.msm(pts, ss)
    assert plain(got) == plain(rc.msm(rpts, ss))
    naive = None
    for p, s in zip(pts, ss):
        naive = c.add(naive, c.multiply(p, s))
    assert plain(got) == plain(naive)


def test_fq2_fq12_inverse_match_reference():
    s = [v % c.P for v in scalars(4, 14)]
    x, rx = c.FQ2(s[:2]), rc.FQ2(s[:2])
    assert x.inv().coeffs == rx.inv().coeffs
    assert (x * x.inv()).coeffs == [1, 0]
    y, ry = c.FQ12(s[2:]), rc.FQ12(s[2:])
    assert y.inv().coeffs == ry.inv().coeffs
    assert y * y.inv() == c.FQ12.one()
    assert (y / x.coeffs[0]).coeffs == (ry / rx.coeffs[0]).coeffs


def test_pairing_bilinearity_and_reference():
    a, b = 5, 11
    e = c.pairing(c.G2, c.G1)
    assert e.coeffs == rc.pairing(rc.G2, rc.G1).coeffs
    assert c.pairing(c.multiply(c.G2, a), c.multiply(c.G1, b)) == e ** (a * b)
    assert e != c.FQ12.one() and e ** c.R == c.FQ12.one()
    assert c.pairing_check([(c.multiply(c.G1, a), c.G2),
                            (c.neg(c.G1), c.multiply(c.G2, a))])
    assert not c.pairing_check([(c.G1, c.G2), (c.G1, c.G2)])


# ---------------------------------------------------------------------------
# 2. R1CS and MiMC.
# ---------------------------------------------------------------------------

def _gadgets(mod, vals):
    cs = mod.R1CS()
    pub = cs.alloc(vals[0], public=True)
    x, y = cs.alloc(vals[1]), cs.alloc(vals[2])
    z = cs.mul(x, y)
    w = cs.add_lc([(z, 3), (x, c.R - 1)], const=vals[3])
    cs.bits(y, 40)
    cs.assert_eq(cs.pow7(w), cs.add_lc([(cs.pow7(w), 1)]))
    cs.constrain({pub: 1}, {0: 1}, {pub: 1})
    return cs


def test_r1cs_gadgets_match_reference():
    vals = scalars(5, 4, bits=40)
    cs, rcs = _gadgets(r1cs, vals), _gadgets(rr1cs, vals)
    assert (cs.values, cs.constraints, cs.num_public) == \
        (rcs.values, rcs.constraints, rcs.num_public)
    assert cs.is_satisfied()
    cs.values[-1] += 1
    assert not cs.is_satisfied()


def test_mimc_matches_reference():
    assert mimc.CTS == rmimc.CTS
    elems = scalars(6, 10, bits=128)
    assert mimc.hash_elements(elems) == rmimc.hash_elements(elems)
    assert mimc.mimc7(elems[0], elems[1]) == rmimc.mimc7(elems[0], elems[1])
    cs, rcs = r1cs.R1CS(), rr1cs.R1CS()
    out = mimc.hash_elements_circuit(cs, [cs.alloc(e) for e in elems[:3]])
    rout = rmimc.hash_elements_circuit(rcs, [rcs.alloc(e) for e in elems[:3]])
    assert (cs.values, cs.constraints, out) == (rcs.values, rcs.constraints,
                                                rout)
    assert cs.values[out] == mimc.hash_elements(elems[:3])
    assert cs.is_satisfied()


def test_wrap_circuit_matches_reference():
    limbs = scalars(7, wrap.CLAIM_LIMBS, bits=128)
    cs, rcs = wrap.build_wrap_circuit(limbs), rwrap.build_wrap_circuit(limbs)
    assert (cs.values, cs.constraints, cs.num_public) == \
        (rcs.values, rcs.constraints, rcs.num_public)
    assert (len(cs.constraints), cs.num_wires, cs.num_public) == \
        (4572, 4583, 11)
    assert cs.values[1] == mimc.hash_elements(limbs) and cs.is_satisfied()


# ---------------------------------------------------------------------------
# 3. Groth16 on tests/test_snark.py's toy circuit, seeded.
# ---------------------------------------------------------------------------

def _toy_circuit(mod, xval: int):
    """y == x^7 + x + 5 with y public (tests/test_snark.py:_toy_circuit)."""
    cs = mod.R1CS()
    yval = (pow(xval, 7, c.R) + xval + 5) % c.R
    y = cs.alloc(yval, public=True)
    x = cs.alloc(xval)
    x7 = cs.pow7(x)
    out = cs.add_lc([(x7, 1), (x, 1)], const=5)
    cs.assert_eq(out, y)
    return cs, yval


def test_fr_ntt_and_qap_match_reference():
    vals = [v % c.R for v in scalars(8, 16)]
    root = g16._find_two_adic_root(4)
    assert root == rg16._find_two_adic_root(4)
    fwd = g16._ntt(vals, root)
    assert fwd == rg16._ntt(vals, root)
    assert g16._ntt(fwd, root, inverse=True) == vals
    cs, _ = _toy_circuit(r1cs, 99)
    rcs, _ = _toy_circuit(rr1cs, 99)
    assert g16._qap_at_tau(cs, vals[0]) == rg16._qap_at_tau(rcs, vals[0])
    assert g16._h_coeffs(cs, 3) == rg16._h_coeffs(rcs, 3)


@pytest.fixture(scope="module")
def toy_keys():
    """Seeded toy setup and proof in both packages."""
    cs, yval = _toy_circuit(r1cs, 1234567)
    rcs, _ = _toy_circuit(rr1cs, 1234567)
    pk, rpk = g16.setup(cs, seed=SETUP_SEED), rg16.setup(rcs, seed=SETUP_SEED)
    proof = g16.prove(pk, cs, blind_seed=BLIND_SEED)
    rproof = rg16.prove(rpk, rcs, blind_seed=BLIND_SEED)
    return pk, rpk, proof, rproof, yval


def test_groth16_seeded_setup_and_prove_bit_identical(toy_keys):
    pk, rpk, proof, rproof, _ = toy_keys
    assert plain(pk) == plain(rpk)
    assert plain(proof) == plain(rproof)


def test_groth16_cross_verification(toy_keys):
    pk, rpk, proof, rproof, yval = toy_keys
    ours_on_ref = proof_into(rg16, rc, proof)
    ref_on_ours = proof_into(g16, c, rproof)
    assert rg16.verify(rpk.vk, [yval], ours_on_ref)
    assert g16.verify(pk.vk, [yval], ref_on_ours)
    assert g16.verify(vk_into(g16, c, rpk.vk), [yval], proof)
    wrong = [(yval + 1) % c.R]
    assert not rg16.verify(rpk.vk, wrong, ours_on_ref)
    assert not g16.verify(pk.vk, wrong, ref_on_ours)
    bad = g16.Proof(a=c.double(proof.a), b=proof.b, c=proof.c)
    assert not g16.verify(pk.vk, [yval], bad)


def test_verifier_sol_and_proof_json_match_reference(toy_keys):
    pk, rpk, proof, rproof, yval = toy_keys
    sol = contract.emit_verifier_sol(pk.vk)
    assert sol == rcontract.emit_verifier_sol(rpk.vk)
    assert sol.count("ecMulAdd(vkx,") == len(pk.vk.ic) - 1
    assert str(pk.vk.delta_g2[0].coeffs[1]) in sol   # imag-first EVM order
    ours = wrap.WrappedProof(proof=proof, public_inputs=[yval], vk=pk.vk)
    ref = rwrap.WrappedProof(proof=rproof, public_inputs=[yval], vk=rpk.vk)
    assert ours.to_json() == ref.to_json()
    back, publics = read_wrapped_json(ours.to_json())
    assert (plain(back), publics) == (plain(proof), [yval])


# ---------------------------------------------------------------------------
# 4. The wrap's claim and its key cache.
# ---------------------------------------------------------------------------

def toy_root_document() -> dict:
    """zkm_tpu's toy aggregation root, exported with its program cap."""
    with open(TOY_RECORD) as f:
        return json.loads(json.load(f)["root_proof_json"])


def test_claim_limbs_of_port_export_match_reference():
    from zkm_tpu_torch.fri.config import FriConfig
    from zkm_tpu_torch.stark.config import StarkConfig
    doc = toy_root_document()
    proof = export.import_proof(doc)
    cfg = dict(doc["config"])
    config = StarkConfig(num_challenges=cfg.pop("num_challenges"),
                         fri_config=FriConfig(**cfg))
    cap = np.asarray([[int(v) for v in d] for d in doc["program_cap"]],
                     dtype=np.uint64)
    ours = export.export_proof(proof, config, program_cap=cap)
    assert ours == doc
    limbs = wrap.claim_limbs(ours)
    assert limbs == rwrap.claim_limbs(doc)
    assert all(0 <= v < 1 << 128 for v in limbs)
    changed = json.loads(json.dumps(ours))
    changed["public_values"]["roots_after"][0] ^= 1
    assert wrap.claim_limbs(changed)[2:4] != limbs[2:4]


def test_wrap_key_cache_is_the_ports_own(tmp_path, toy_keys, monkeypatch):
    assert os.path.dirname(wrap._pk_path()) == cache.CACHE_DIR
    assert ".zkm_circuits" not in wrap._pk_path()
    pk = toy_keys[0]
    wrap.save_proving_key(pk, str(tmp_path))
    assert os.path.exists(wrap._pk_path(str(tmp_path)))
    monkeypatch.setattr(wrap, "_PK_CACHE", {})
    loaded = wrap.groth16_setup(cache_dir=str(tmp_path))
    assert plain(loaded) == plain(pk)
    assert wrap.groth16_setup(cache_dir=str(tmp_path)) is loaded


# ---------------------------------------------------------------------------
# 5. The production-shape seeded wrap against zkm_tpu's record (slow:
#    one ~100 s setup; on the card `chip_smoke.py` phase 9c runs it).
# ---------------------------------------------------------------------------

def record_of(wrapped, sol: str) -> dict:
    """What the record holds of a wrap: the gnark-layout proof and public
    inputs, and the hash of verifier.sol (every coordinate of the vk)."""
    return {"proof_json": wrapped.to_json(),
            "verifier_sol_sha256": hashlib.sha256(sol.encode()).hexdigest()}


@pytest.mark.slow
def test_seeded_wrap_matches_record():
    with open(WRAP_RECORD) as f:
        record = json.load(f)
    doc = toy_root_document()
    pk = wrap.groth16_setup(seed=bytes.fromhex(record["setup_seed"]))
    wrapped = wrap.wrap_stark_bn254(
        doc, pk, blind_seed=bytes.fromhex(record["blind_seed"]))
    assert [str(v) for v in wrap.claim_limbs(doc)] == record["claim_limbs"]
    assert record_of(wrapped, contract.emit_verifier_sol(pk.vk)) == {
        k: record[k] for k in ("proof_json", "verifier_sol_sha256")}


def write_reference_file() -> None:
    doc = toy_root_document()
    limbs = rwrap.claim_limbs(doc)
    cs = rwrap.build_wrap_circuit(limbs)
    t0 = time.perf_counter()
    pk = rg16.setup(rwrap.build_wrap_circuit([0] * rwrap.CLAIM_LIMBS),
                    seed=SETUP_SEED)
    t1 = time.perf_counter()
    proof = rg16.prove(pk, cs, blind_seed=BLIND_SEED)
    t2 = time.perf_counter()
    publics = cs.values[1:cs.num_public + 1]
    assert rg16.verify(pk.vk, publics, proof)
    t3 = time.perf_counter()
    wrapped = rwrap.WrappedProof(proof=proof, public_inputs=publics,
                                 vk=pk.vk)
    record = {
        "document": "recursion_toy_reference.json's root_proof_json "
                    "(zkm_tpu's toy aggregation root with its program cap)",
        "setup_seed": SETUP_SEED.hex(), "blind_seed": BLIND_SEED.hex(),
        "circuit": {"constraints": len(cs.constraints),
                    "wires": cs.num_wires, "public": cs.num_public,
                    "domain_bits": pk.domain_bits},
        "claim_limbs": [str(v) for v in limbs],
        **record_of(wrapped, rcontract.emit_verifier_sol(pk.vk)),
        "reference_seconds": {"setup": round(t1 - t0, 1),
                              "prove": round(t2 - t1, 1),
                              "verify": round(t3 - t2, 2)},
        "reference_machine": f"{os.cpu_count()}-core CPU, zkm_tpu's "
                             "pure-Python snark/",
    }
    with open(WRAP_RECORD, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record)[:2000], flush=True)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(__doc__)
    write_reference_file()
