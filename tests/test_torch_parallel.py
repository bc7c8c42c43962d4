"""Multi-rank proving (zkm_tpu_torch/parallel/) against zkm_tpu, on the CPU.

Ranks are gloo processes spawned by `parallel.launch.launch` with
device="cpu"; one launch of four ranks runs the sharded steps and proofs
that the tests below check.  Tolerance is zero: everything is an integer
mod p.

  * the three steps of `parallel/sharding.py` at (dp, tp) = (2, 2) and
    (1, 4) on tests/test_multichip.py's input (4 Logic traces of 64 rows,
    rate 2, cap 2, alphas [3, 5], beta 7, arity_bits 2), plus cap 1 (a
    cap smaller than tp) and arity_bits 1 and 4, against zkm_tpu's
    unsharded `commit_step`, `quotient_step` and `fri_fold_step`;
  * tests/test_multichip.py's Logic statement proved at tp = 2 and
    tp = 4: the flattened proof equals zkm_tpu's and zkm_tpu's verifier
    accepts it; at dp = 2 each dp group proves its own statement, equal
    to the one-rank proof;
  * a FRI layer small enough to be gathered and caps of one node (fewer
    than tp) at tp = 4, equal to zkm_tpu's proof under that config;
  * Arithmetic's lookup running sum (a prefix sum) over row blocks,
    equal to zkm_tpu's lookup columns;
  * the mesh and launch refuse what they must, within their limits.

zkm_tpu's outputs are frozen in zkm_tpu_torch/data/parallel_reference.json
(sha256 of each array's u64 bytes): computing them live takes minutes on
the CPU (its jitted steps ~80 s, one Logic proof over a minute).  One of
them, the lookup columns (seconds), is computed live against the record,
so the record cannot drift from zkm_tpu unseen.
`python tests/test_torch_parallel.py --write` makes the file again.
The toy segment through host.prove_segment(mesh=) at tp = 2 is slow
(ZKM_SLOW=1): many minutes of plain torch on the CPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
from zkm_tpu_torch.convert import to_u64, traces_from_rows  # noqa: E402
from zkm_tpu_torch.fri.config import FriConfig  # noqa: E402
from zkm_tpu_torch.parallel import sharding as sh  # noqa: E402
from zkm_tpu_torch.parallel.comm import Comm, split_counts  # noqa: E402
from zkm_tpu_torch.parallel.launch import LaunchError, launch  # noqa: E402
from zkm_tpu_torch.stark.config import StarkConfig  # noqa: E402
from zkm_tpu_torch.stark.cross_table_lookup import (  # noqa: E402
    CrossTableLookup, TableWithColumns)
from zkm_tpu_torch.stark.proof import (MemRoots, PublicValues,  # noqa: E402
                                       flat_sha256, flatten_proof)
from zkm_tpu_torch.stark.prover import prove_with_traces  # noqa: E402
from zkm_tpu_torch.tables import logic  # noqa: E402
from zkm_tpu_torch.witness.trace_set import DATA  # noqa: E402

RECORD = os.path.join(DATA, "parallel_reference.json")
RATE, ALPHAS, BETA, DEGREE_BITS = 2, (3, 5), 7, 6
CAPS = (2, 1)
FOLD_ARITY_BITS = (1, 2, 4)
MESHES = ((2, 2), (1, 4))
LAUNCH_S = 300


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(a, dtype=np.uint64)).tobytes()).hexdigest()


def step_rows(s: int = 4, n: int = 64, seed: int = 3) -> np.ndarray:
    """tests/test_multichip.py's `_traces`: (s, C, n) u64 Logic rows."""
    rng = np.random.default_rng(seed)
    ops = [[(int(rng.integers(0, 4)), int(rng.integers(0, 1 << 32)),
             int(rng.integers(0, 1 << 32))) for _ in range(20)]
           for _ in range(s)]
    return np.stack([logic.generate_rows(o, min_rows=n) for o in ops])


def statement_ops(k: int):
    """Statement 0 is tests/test_multichip.py's production statement;
    statement 1 is 30 random operations."""
    if k == 0:
        return [(logic.OP_AND, 0x12345678, 0x0F0F0F0F),
                (logic.OP_XOR, 0xDEADBEEF, 0xCAFEBABE)]
    rng = np.random.default_rng(40 + k)
    return [(int(rng.integers(0, 4)), int(rng.integers(0, 1 << 32)),
             int(rng.integers(0, 1 << 32))) for _ in range(30)]


def self_ctls():
    cols, filt = tuple(logic.ctl_data()), logic.ctl_filter()
    return [CrossTableLookup((TableWithColumns(0, cols, filt),),
                             TableWithColumns(0, cols, filt))]


PV = PublicValues(MemRoots.from_image_id(bytes(32)),
                  MemRoots.from_image_id(bytes([1] * 32)), bytes(32))


# FRI layers of 128, 32 and 8 values and caps of one node: at tp = 4 the
# last layer is gathered (fewer than tp x arity values) and every cap is
# smaller than tp.
SMALL_LAYERS = StarkConfig(security_bits=1, num_challenges=2,
                           fri_config=FriConfig(
                               rate_bits=1, cap_height=0,
                               proof_of_work_bits=4, num_query_rounds=4,
                               arity_bits=2, final_poly_bits=0))


def prove_statement(k: int, mesh=None, config=None):
    rows = logic.generate_rows(statement_ops(k), min_rows=64)
    return prove_with_traces([logic.LogicStark()],
                             config or StarkConfig.test_config(),
                             traces_from_rows([rows], "cpu"), self_ctls(),
                             PV, device="cpu", mesh=mesh)


# ---------------------------------------------------------------------------
# What the ranks run (module level: spawned ranks import it by name).
# ---------------------------------------------------------------------------

def _steps_on(mesh) -> dict:
    """The three sharded steps on this rank's blocks; u64 arrays out."""
    whole = traces_from_rows([step_rows()], "cpu")[0]
    out = {}
    coeffs = None
    for cap in CAPS:
        c, d, k = sh.make_sharded_commit_step(mesh, RATE, cap)(
            mesh.local(whole, 1))
        out[f"commit_cap{cap}"] = [to_u64(c), to_u64(d), to_u64(k)]
        coeffs = c if coeffs is None else coeffs
    q = sh.make_sharded_quotient_step(
        mesh, logic.LogicStark(), list(ALPHAS), DEGREE_BITS)(coeffs)
    out["quotient"] = to_u64(q)
    for ab in FOLD_ARITY_BITS:
        out[f"fold{ab}"] = to_u64(sh.make_sharded_fri_fold(
            mesh, BETA, ab)(q[:, 0, :]))
    return out


def _lookup_z_on(mesh):
    """Arithmetic's range-check lookup columns over this rank's row block
    plus its halo row (the prefix sum carries across blocks)."""
    from zkm_tpu_torch.stark.lookup import lookup_helper_columns
    from zkm_tpu_torch.tables import arithmetic as arith
    stark = arith.ArithmeticStark()
    rows = _arith_rows()
    n, b = rows.shape[1], rows.shape[1] // mesh.tp
    idx = (np.arange(b + 1) + mesh.tp_index * b) % n
    block = traces_from_rows([rows[:, idx]], "cpu")[0]
    return [to_u64(torch.stack(lookup_helper_columns(
        lk, block, 11, stark.constraint_degree, mesh.tp_comm)))
        for lk in stark.lookups()]


def _arith_rows(arith=None):
    """40 Arithmetic operations' rows (u64), by the port's row builder or
    by `arith`, another package's tables.arithmetic module."""
    if arith is None:
        from zkm_tpu_torch.tables import arithmetic as arith
    rng = np.random.default_rng(5)
    ops = [arith.Op(flag, int(rng.integers(0, 1 << 32)),
                    int(rng.integers(0, 1 << 32)))
           for flag in (arith.IS_ADD, arith.IS_SUBU, arith.IS_SLTU,
                        arith.IS_MUL) for _ in range(10)]
    return arith.generate_rows(ops, min_rows=arith.RANGE_MIN_ROWS)


def reference_lookup_z():
    """zkm_tpu's Arithmetic lookup columns (helpers and Z) on its own rows
    of `_arith_rows`' operations, one (columns, rows) u64 array per
    lookup; its rows' sha256."""
    from zkm_tpu.field import goldilocks as rgl
    from zkm_tpu.stark.lookup import lookup_helper_columns as ref_columns
    from zkm_tpu.tables import arithmetic as rarith
    rows = _arith_rows(rarith)
    stark = rarith.ArithmeticStark()
    trace = rgl.from_u64(rows)
    return [np.stack([np.asarray(rgl.to_u64(c)) for c in ref_columns(
        lk, trace, 11, stark.constraint_degree)])
        for lk in stark.lookups()], sha(rows)


def _four_ranks() -> dict:
    out = {}
    for dp, tp in MESHES:
        mesh = sh.make_mesh(dp, tp, device="cpu")
        t0 = time.perf_counter()
        got = {"coords": (mesh.dp_index, mesh.tp_index),
               "steps": _steps_on(mesh)}
        k = mesh.dp_index if dp > 1 else 0
        proof = prove_statement(k, mesh)
        got["statement"] = k
        got["proof_sha256"] = flat_sha256(flatten_proof(proof))
        if mesh.rank == 0:
            from zkm_tpu_torch.convert import proof_to_plain
            got["proof_plain"] = proof_to_plain(proof)
        if tp == 4:
            got["lookup_z"] = _lookup_z_on(mesh)
            got["small_layers_sha256"] = flat_sha256(flatten_proof(
                prove_statement(0, mesh, SMALL_LAYERS)))
        got["seconds"] = time.perf_counter() - t0
        got["comm"] = mesh.tp_comm.stats()
        out[(dp, tp)] = got
    return out


def _mesh_of(dp, tp):
    sh.make_mesh(dp, tp, device="cpu")


def _statement_over(tp):
    prove_statement(0, sh.make_mesh(1, tp, device="cpu"))


def _hang():
    import torch.distributed as dist
    sh.make_mesh(1, 2, device="cpu")
    if dist.get_rank() == 1:
        time.sleep(3600)
    return "rank 0 returns"


# ---------------------------------------------------------------------------
# The tests.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def record():
    with open(RECORD) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ranks():
    """One launch of four gloo ranks; its results by mesh, rank order."""
    out = launch(_four_ranks, 4, timeout=LAUNCH_S, threads=2)
    return {m: [r[m] for r in out] for m in MESHES}


def _assemble(per_rank, mesh, key, axis):
    """Whole arrays from the ranks' blocks: the tp blocks joined along
    `axis`, then the dp blocks along axis 0."""
    dp, tp = mesh
    rows = []
    for d in range(dp):
        blocks = [r["steps"][key] if not isinstance(key, tuple)
                  else r["steps"][key[0]][key[1]]
                  for r in per_rank if r["coords"][0] == d]
        rows.append(np.concatenate(blocks, axis=axis))
    return np.concatenate(rows, axis=0)


def test_step_input_is_the_references(record):
    assert sha(step_rows()) == record["step_traces_sha256"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}_tp{m[1]}")
def test_sharded_commit_matches_reference(ranks, record, mesh):
    for cap in CAPS:
        key = f"commit_cap{cap}"
        want = record[key]
        assert sha(_assemble(ranks[mesh], mesh, (key, 0), 1)) == \
            want["coeffs"]
        assert sha(_assemble(ranks[mesh], mesh, (key, 1), 1)) == \
            want["digests"]
        for d in range(mesh[0]):
            caps = [r["steps"][key][2] for r in ranks[mesh]
                    if r["coords"][0] == d]
            assert all((c == caps[0]).all() for c in caps)
        caps = np.concatenate([r["steps"][key][2] for r in ranks[mesh]
                               if r["coords"][1] == 0])
        assert sha(caps) == want["caps"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}_tp{m[1]}")
def test_sharded_quotient_and_folds_match_reference(ranks, record, mesh):
    assert sha(_assemble(ranks[mesh], mesh, "quotient", 2)) == \
        record["quotient"]
    for ab in FOLD_ARITY_BITS:
        assert sha(_assemble(ranks[mesh], mesh, f"fold{ab}", 1)) == \
            record[f"fold{ab}"], ab


def test_unsharded_port_steps_match_reference(record):
    traces = traces_from_rows([step_rows()], "cpu")[0]
    for cap in CAPS:
        got = [sha(to_u64(x)) for x in sh.commit_step(traces, RATE, cap)]
        want = record[f"commit_cap{cap}"]
        assert got == [want["coeffs"], want["digests"], want["caps"]]
    coeffs = sh.commit_step(traces, RATE, CAPS[0])[0]
    q = sh.quotient_step(logic.LogicStark(), coeffs, list(ALPHAS),
                         DEGREE_BITS)
    assert sha(to_u64(q)) == record["quotient"]
    for ab in FOLD_ARITY_BITS:
        assert sha(to_u64(sh.fri_fold_step(q[:, 0, :], BETA, ab))) == \
            record[f"fold{ab}"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}_tp{m[1]}")
def test_sharded_proofs_equal_reference_and_one_rank(ranks, record, mesh):
    """At dp = 2 each dp group proved its own statement."""
    for r in ranks[mesh]:
        assert r["proof_sha256"] == \
            record["proofs"][r["statement"]]["sha256_flat"]
    statements = {r["statement"] for r in ranks[mesh]}
    assert statements == set(range(mesh[0]))
    for k in statements:
        assert flat_sha256(flatten_proof(prove_statement(k))) == \
            record["proofs"][k]["sha256_flat"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}_tp{m[1]}")
def test_reference_verifier_accepts_sharded_proof(ranks, mesh):
    sys.path.insert(0, HERE)
    from test_torch_proof import to_reference
    from zkm_tpu.recursion import flatten_proof as ref_flatten_proof
    from zkm_tpu.stark.config import StarkConfig as RefStarkConfig
    from zkm_tpu.stark.cross_table_lookup import (
        CrossTableLookup as RefCtl, TableWithColumns as RefTwc)
    from zkm_tpu.stark.verifier import verify_proof as ref_verify_proof
    from zkm_tpu.tables import logic as rlogic
    cols, filt = tuple(rlogic.ctl_data()), rlogic.ctl_filter()
    ctls = [RefCtl((RefTwc(0, cols, filt),), RefTwc(0, cols, filt))]
    ref = to_reference(ranks[mesh][0]["proof_plain"])
    ref_verify_proof([rlogic.LogicStark()], ref, ctls,
                     RefStarkConfig.test_config())
    assert flat_sha256(ref_flatten_proof(ref)) == \
        ranks[mesh][0]["proof_sha256"]


def test_gathered_fri_layer_and_one_node_caps(ranks, record):
    from zkm_tpu_torch.stark.verifier import verify_proof
    one = prove_statement(0, config=SMALL_LAYERS)
    assert SMALL_LAYERS.fri_config.reduction_arity_bits(DEGREE_BITS) == \
        [2, 2, 2]
    verify_proof([logic.LogicStark()], one, self_ctls(), SMALL_LAYERS)
    want = record["small_layers_proof"]["sha256_flat"]
    assert flat_sha256(flatten_proof(one)) == want
    assert [r["small_layers_sha256"] for r in ranks[(1, 4)]] == [want] * 4


def test_lookup_running_sum_over_row_blocks(ranks, record):
    from zkm_tpu_torch.stark.lookup import lookup_helper_columns
    from zkm_tpu_torch.tables import arithmetic as arith
    stark = arith.ArithmeticStark()
    rows = _arith_rows()
    assert sha(rows) == record["arith_rows_sha256"]
    whole = traces_from_rows([rows], "cpu")[0]
    for i, lk in enumerate(stark.lookups()):
        one = to_u64(torch.stack(lookup_helper_columns(
            lk, whole, 11, stark.constraint_degree)))
        assert sha(one) == record["lookup_z"][i]
        assert one[-1, 0] == 0 and one[-1].any()
        got = np.concatenate([r["lookup_z"][i] for r in ranks[(1, 4)]],
                             axis=1)
        assert sha(got) == record["lookup_z"][i]


def test_lookup_record_is_zkm_tpus_live(record):
    """The record's lookup columns, computed again by zkm_tpu here."""
    got, rows_sha = reference_lookup_z()
    assert rows_sha == record["arith_rows_sha256"]
    assert [sha(z) for z in got] == record["lookup_z"]


def test_nccl_collectives_take_tensors_on_the_groups_card():
    """NCCL takes no host tensor: one made on the host goes to the
    group's device first; gloo keeps host memory."""
    meta = torch.device("meta")
    x = torch.arange(3)
    assert Comm(None, [0, 1], "nccl", 0, meta)._wire(x).device == meta
    assert Comm(None, [0, 1], "gloo", 0, meta)._wire(x).device.type == "cpu"


def test_collectives_moved_bytes(ranks):
    for mesh in MESHES:
        for r in ranks[mesh]:
            calls, nbytes, _ = r["comm"]
            assert calls > 0 and nbytes > 0


def test_mesh_must_cover_the_world():
    t0 = time.perf_counter()
    with pytest.raises(LaunchError, match=r"needs 4 ranks, the world has 2"):
        launch(_mesh_of, 2, args=(2, 2), timeout=60, threads=1)
    assert time.perf_counter() - t0 < 60


def test_heights_must_split_over_tp():
    with pytest.raises(LaunchError, match="does not split over tp=3"):
        launch(_statement_over, 3, args=(3,), timeout=90, threads=1)


def test_a_hung_rank_fails_the_launch_within_its_limit():
    t0 = time.perf_counter()
    with pytest.raises(LaunchError,
                       match=r"ranks \[(0, )?1\] outlived the 12 s limit"):
        launch(_hang, 2, timeout=12, threads=1)
    assert time.perf_counter() - t0 < 30


def test_no_card_and_no_silent_backend(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sh.make_mesh(1, 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL needs one card per rank"):
        sh._card(1, 2, "nccl")
    assert sh._card(1, 2, "gloo") == 0
    with pytest.raises(ValueError, match="cannot run on the host"):
        sh.make_mesh(1, 1, backend="nccl", device="cpu")


def test_split_counts():
    assert split_counts(7, 4) == [2, 2, 2, 1]
    assert split_counts(2, 4) == [1, 1, 0, 0]
    assert sum(split_counts(260, 3)) == 260


def _toy_segment_tp2():
    from zkm_tpu_torch import host
    from zkm_tpu_torch.emulator.state import State
    from zkm_tpu_torch.emulator.utils import split_prog_into_segs
    mesh = sh.make_mesh(1, 2, device="cpu")
    st = State("cpu")
    st.memory.set_memory_range(0, b"".join(w.to_bytes(4, "big")
                                           for w in TOY_PROGRAM))
    _, segs, _ = split_prog_into_segs(st, seg_size=1 << 20)
    receipt = host.prove_segment(segs[0], mesh=mesh)
    return flat_sha256(flatten_proof(receipt.proof))


# bench._toy_segment()'s program (chip_smoke.TOY_PROGRAM)
TOY_PROGRAM = (0x24080005, 0x2409000A, 0x01095020, 0x3508BEEF, 0x01096824,
               0x01097025, 0xAE2A0000, 0x8E2B0000, 0x24021096, 0x24040000,
               0x0000000C)


@pytest.mark.slow
def test_toy_segment_at_tp2_has_the_reference_digest():
    with open(os.path.join(DATA, "toy_segment_reference.json")) as f:
        want = json.load(f)["sha256_flat"]
    got = launch(_toy_segment_tp2, 2, timeout=3600, threads=4)
    assert got == [want, want]


# ---------------------------------------------------------------------------
# The writer of zkm_tpu_torch/data/parallel_reference.json (zkm_tpu).
# ---------------------------------------------------------------------------

def write_reference() -> None:
    sys.path.insert(0, HERE)
    import conftest  # noqa: F401  (JAX on 8 virtual CPU devices, x64)
    import jax
    from zkm_tpu.field import goldilocks as rgl
    from zkm_tpu.fri.config import FriConfig as RefFriConfig
    from zkm_tpu.parallel import sharding as rsh
    from zkm_tpu.recursion import flatten_proof as ref_flatten_proof
    from zkm_tpu.stark.config import StarkConfig as RefStarkConfig
    from zkm_tpu.stark.cross_table_lookup import (
        CrossTableLookup as RefCtl, TableWithColumns as RefTwc)
    from zkm_tpu.stark.proof import MemRoots as RefRoots
    from zkm_tpu.stark.proof import PublicValues as RefPv
    from zkm_tpu.stark.prover import prove_with_traces as ref_prove
    from zkm_tpu.tables import logic as rlogic

    def u64(x):
        return np.asarray(rgl.to_u64(x))

    rng = np.random.default_rng(3)
    ops = [[(int(rng.integers(0, 4)), int(rng.integers(0, 1 << 32)),
             int(rng.integers(0, 1 << 32))) for _ in range(20)]
           for _ in range(4)]
    rows = np.stack([rlogic.generate_rows(o, min_rows=64) for o in ops])
    assert (rows == step_rows()).all()
    traces = rgl.from_u64(rows)
    out = {"step_traces_sha256": sha(rows),
           "steps": "zkm_tpu.parallel.sharding.{commit_step, quotient_step, "
                    "fri_fold_step}, jitted, unsharded"}
    coeffs = None
    for cap in CAPS:
        c, d, k = jax.jit(lambda t, cap=cap: rsh.commit_step(t, RATE, cap))(
            traces)
        out[f"commit_cap{cap}"] = {"coeffs": sha(u64(c)),
                                   "digests": sha(u64(d)),
                                   "caps": sha(u64(k))}
        coeffs = c if coeffs is None else coeffs
    q = jax.jit(lambda c: rsh.quotient_step(
        rlogic.LogicStark(), c, list(ALPHAS), DEGREE_BITS))(coeffs)
    out["quotient"] = sha(u64(q))
    for ab in FOLD_ARITY_BITS:
        f = jax.jit(lambda v, ab=ab: rsh.fri_fold_step(v, BETA, ab))(
            (q[0][:, 0, :], q[1][:, 0, :]))
        out[f"fold{ab}"] = sha(u64(f))
    print(json.dumps(out), flush=True)

    cols, filt = tuple(rlogic.ctl_data()), rlogic.ctl_filter()
    ctls = [RefCtl((RefTwc(0, cols, filt),), RefTwc(0, cols, filt))]
    pv = RefPv(RefRoots.from_image_id(bytes(32)),
               RefRoots.from_image_id(bytes([1] * 32)), bytes(32))
    out["proofs"] = []
    for k in range(2):
        t0 = time.perf_counter()
        proof = ref_prove([rlogic.LogicStark()],
                          RefStarkConfig.test_config(),
                          [rlogic.generate_trace(statement_ops(k),
                                                 min_rows=64)], ctls, pv)
        flat = ref_flatten_proof(proof)
        out["proofs"].append({"sha256_flat": flat_sha256(flat),
                              "num_flat_elements": len(flat),
                              "seconds": round(time.perf_counter() - t0, 1)})
        print(json.dumps(out["proofs"][-1]), flush=True)
    t0 = time.perf_counter()
    small = RefStarkConfig(
        security_bits=1, num_challenges=2,
        fri_config=RefFriConfig(**vars(SMALL_LAYERS.fri_config)))
    flat = ref_flatten_proof(ref_prove(
        [rlogic.LogicStark()], small,
        [rlogic.generate_trace(statement_ops(0), min_rows=64)], ctls, pv))
    out["small_layers_proof"] = {
        "config": vars(SMALL_LAYERS.fri_config), "statement": 0,
        "sha256_flat": flat_sha256(flat), "num_flat_elements": len(flat),
        "seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps(out["small_layers_proof"]), flush=True)
    zs, out["arith_rows_sha256"] = reference_lookup_z()
    assert out["arith_rows_sha256"] == sha(_arith_rows())
    out["lookup_z"] = [sha(z) for z in zs]
    out["machine"] = f"{os.cpu_count()}-core CPU, zkm_tpu on JAX's CPU backend"
    with open(RECORD, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(__doc__)
    write_reference()
