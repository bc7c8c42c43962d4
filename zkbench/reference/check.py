"""The plain reference's judgement of a run: what decides `correct`.

The reference is `zkbench/reference/zkm/`, frozen copies of the port's
host emulator and host verifier stack (each file names its source); it
imports nothing of `zkm_tpu_torch`, of `zkm_tpu` or of JAX, and takes
nothing the program made but the outputs it judges.  From the same
program bytes and hint inputs the benchmark gave the program it works
out the segments again (their number, steps, boundaries, pre- and
post-image ids) and each segment's public values, then checks the
program's receipts against them:

  * `segments_mismatched`: segments of a sampled program whose count,
    steps, pc, end pc or image ids differ from the reference's, or whose
    receipt claims other image ids or userdata;
  * `proofs_rejected`: receipts of a sampled program whose proof the
    reference verifier does not accept under the configuration's
    StarkConfig, for exactly the public values the reference derived
    (with the structure checks of `check_structure`, which the copied
    verifier leaves to `zip`);
  * `chain_breaks`: over every program of the window, receipts missing or
    extra against the program's own segments and the mix's count, and
    receipts whose post-image id is not the next one's pre-image id.

Every number is exact and its limit is 0.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

from .zkm.convert import proof_from_plain
from .zkm.emulator.state import State
from .zkm.emulator.utils import split_prog_into_segs
from .zkm.fri.config import FriConfig
from .zkm.stark.all_stark import Table, make_all_stark
from .zkm.stark.config import StarkConfig
from .zkm.stark.proof import MemRoots, PublicValues
from .zkm.stark.verifier import verify_proof

LIMITS = {"segments_mismatched": 0, "proofs_rejected": 0, "chain_breaks": 0}


def stark_config(cfg: dict) -> StarkConfig:
    sc = dict(cfg["stark_config"])
    return StarkConfig(security_bits=sc.pop("security_bits"),
                       num_challenges=sc.pop("num_challenges"),
                       fri_config=FriConfig(**sc))


def emulate(code: bytes, inputs: Sequence[bytes], seg_size: int,
            device="cpu") -> List[dict]:
    """The reference's segments of a program: steps, pc, end pc, image ids
    and public values."""
    st = State(device)
    st.memory.set_memory_range(0, code)
    for raw in inputs:
        st.add_input_stream_bytes(raw)
    _, segs, _ = split_prog_into_segs(st, None, "", seg_size)
    userdata = hashlib.sha256(inputs[0] if inputs else b"").digest()
    return [{"step": s.step, "pc": s.pc, "end_pc": s.end_pc,
             "pre_image_id": s.pre_image_id, "image_id": s.image_id,
             "userdata": userdata} for s in segs]


SEGMENT_KEYS = ("step", "pc", "end_pc", "pre_image_id", "image_id")
CLAIM_KEYS = ("pre_image_id", "image_id", "userdata")


def segments_mismatched(ref: List[dict], segs: List[dict],
                        receipts: List[dict]) -> int:
    bad = abs(len(ref) - len(segs))
    for k, r in enumerate(ref):
        seg = segs[k] if k < len(segs) else None
        rec = receipts[k] if k < len(receipts) else None
        if seg is not None and any(seg[x] != r[x] for x in SEGMENT_KEYS):
            bad += 1
        elif rec is not None and any(rec[x] != r[x] for x in CLAIM_KEYS):
            bad += 1
    return bad


def chain_breaks(segs: List[dict], receipts: List[dict],
                 segments_per_program: Optional[int]) -> int:
    bad = abs(len(receipts) - len(segs))
    if segments_per_program is not None:
        bad += abs(len(segs) - segments_per_program)
    for seg, rec in zip(segs, receipts):
        if (rec["pre_image_id"], rec["image_id"]) != \
                (seg["pre_image_id"], seg["image_id"]):
            bad += 1
    for a, b in zip(receipts, receipts[1:]):
        if a["image_id"] != b["pre_image_id"]:
            bad += 1
    return bad


def check_structure(all_stark, proof, config: StarkConfig) -> None:
    """Raise ValueError unless the proof has the shape the configuration
    states: a proof per table, caps of 2^cap_height digests, every
    column's openings, and as many FRI query rounds, folding layers and
    final-polynomial coefficients as the configuration asks for (the
    copied verifier zips them, so a proof with fewer would pass it)."""
    fc = config.fri_config
    if len(proof.stark_proofs) != len(all_stark.starks):
        raise ValueError("a proof per table is missing")
    for stark, pm in zip(all_stark.starks, proof.stark_proofs):
        pr, op, fp = pm.proof, pm.proof.openings, pm.proof.opening_proof
        caps = [pr.trace_cap, pr.auxiliary_polys_cap, pr.quotient_polys_cap]
        caps += list(fp.commit_phase_merkle_caps)
        if any(tuple(c.shape) != (1 << fc.cap_height, 4) for c in caps):
            raise ValueError("a Merkle cap has the wrong height")
        if len(op.local_values) != stark.num_columns or \
                len(op.next_values) != stark.num_columns:
            raise ValueError("openings of some columns are missing")
        if len(op.quotient_polys) != \
                stark.quotient_degree_factor * config.num_challenges:
            raise ValueError("openings of some quotient chunks are missing")
        arities = fc.reduction_arity_bits(pm.degree_bits)
        if len(fp.commit_phase_merkle_caps) != len(arities):
            raise ValueError("FRI has the wrong number of folding layers")
        if len(fp.query_round_proofs) != fc.num_query_rounds:
            raise ValueError(f"{len(fp.query_round_proofs)} FRI query rounds, "
                             f"{fc.num_query_rounds} asked for")
        if any(len(q.steps) != len(arities) for q in fp.query_round_proofs):
            raise ValueError("a FRI query round has the wrong number of steps")
        if len(fp.final_poly) != 1 << (pm.degree_bits - sum(arities)):
            raise ValueError("the final polynomial has the wrong length")


def verify_receipt(all_stark, config: StarkConfig, proof_plain: dict,
                   ref: dict) -> Optional[str]:
    """None if the reference accepts the proof for the public values it
    derived itself (`ref`), else why not."""
    try:
        proof = proof_from_plain(proof_plain)
        proof.public_values = PublicValues(
            roots_before=MemRoots.from_image_id(ref["pre_image_id"]),
            roots_after=MemRoots.from_image_id(ref["image_id"]),
            userdata=ref["userdata"])
        check_structure(all_stark, proof, config)
        verify_proof(all_stark.starks, proof, all_stark.ctls, config)
    except Exception as e:  # any failure to verify is a rejection
        return f"{type(e).__name__}: {e}"
    return None


class Judge:
    """The reference for one configuration."""

    def __init__(self, cfg: dict, device="cpu"):
        self.cfg = cfg
        self.config = stark_config(cfg)
        self.all_stark = make_all_stark([Table[t] for t in cfg["tables"]])
        self.device = device

    def judge(self, done: List[dict], sample: Sequence[int],
              segments_per_program: Optional[int], log=print) -> dict:
        """`done`: per program of the window, its `code`, `inputs`, the
        program's `segments` and `receipts` (plain dicts; a sampled
        program's receipts carry their `proof` as plain data).  Returns
        the numbers compared, with how many programs were checked."""
        out = {k: 0 for k in LIMITS}
        for d in done:
            out["chain_breaks"] += chain_breaks(
                d["segments"], d["receipts"], segments_per_program)
        for i in sample:
            d = done[i]
            ref = emulate(d["code"], d["inputs"], self.cfg["seg_size"],
                          self.device)
            out["segments_mismatched"] += segments_mismatched(
                ref, d["segments"], d["receipts"])
            for k, rec in enumerate(d["receipts"][:len(ref)]):
                why = verify_receipt(self.all_stark, self.config,
                                     rec["proof"], ref[k])
                if why is not None:
                    out["proofs_rejected"] += 1
                    log(f"program {d['index']} segment {k}: proof rejected "
                        f"({why[:300]})")
        out["programs_checked"] = len(sample)
        return out


def is_correct(numbers: dict) -> bool:
    return numbers.get("programs_checked", 0) > 0 and all(
        numbers[k] <= v for k, v in LIMITS.items())
