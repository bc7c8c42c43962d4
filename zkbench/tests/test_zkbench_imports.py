"""Nothing the benchmark runs imports JAX or the JAX package `zkm_tpu`
(top-level names compared whole: `zkm_tpu_torch` begins with `zkm_tpu`),
and the reference imports nothing of `zkm_tpu_torch` either.  Checked in
fresh subprocesses."""

import json
import subprocess
import sys

from zkbench import harness

LOADED = ("import json, sys; print(json.dumps(sorted({m.split('.')[0] "
          "for m in sys.modules})))")


def top_level_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, "
                               f"{harness.ROOT!r})\n{code}\n{LOADED}"],
        capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_port_import_no_jax():
    got = top_level_after(
        "import runpy; runpy.run_path('zkbench/run.py', run_name='x')\n"
        "from zkbench import harness, system, trace, control, generator\n"
        "import json\n"
        "cfg = json.load(open('zkbench/configs/full-2p16.json'))\n"
        "system.Prover(cfg, 'cpu')\n"
        "for m in harness.load_spec()['per_layer']: "
        "harness.reader(m['name'])")
    assert "zkm_tpu_torch" in got          # the port was loaded
    assert not got & set(harness.FORBIDDEN)


def test_reference_imports_no_port():
    got = top_level_after(
        "from zkbench.reference import check\n"
        "check.Judge(__import__('json').load(open("
        "'zkbench/configs/full-2p16.json')))")
    assert not got & (set(harness.FORBIDDEN) | {"zkm_tpu_torch"})


def test_forbidden_compares_whole_names():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "zkm_tpu")
    sys.modules["zkm_tpu_torch_lookalike"] = sys
    try:
        assert "zkm_tpu_torch_lookalike" not in harness.forbidden_modules()
    finally:
        del sys.modules["zkm_tpu_torch_lookalike"]
