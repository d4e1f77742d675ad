"""What a run loads: never JAX or the JAX package; the reference never the program.

Top-level names are compared whole: ``dlaf_tpu_torch`` is not ``dlaf_tpu``."""
import json
import os
import subprocess
import sys

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "dlaf_tpu"}


def _loaded(code: str) -> set:
    prog = (f"import sys, json; sys.path.insert(0, {ROOT!r}); {code}; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=env)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    code = ("import portbench.harness, portbench.control, portbench.spec as s; "
            "[s.load_entry(s.load_workload(w)['entry']) for w in s.names('workloads')]; "
            "[s.load_metric(m) for m in s.names('metrics')]; "
            "[s.load_reference(r) for r in ('cholesky', 'eigh')]; "
            "import dlaf_tpu_torch, dlaf_tpu_torch.api.scalapack, "
            "dlaf_tpu_torch.algos.eigensolver.dist_driver")
    top = _loaded(code)
    assert "dlaf_tpu_torch" in top
    assert not top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("import portbench.reference.cholesky, portbench.reference.eigh, "
                  "portbench.traffic, portbench.roofline, portbench.tracing")
    assert "dlaf_tpu_torch" not in top and not top & FORBIDDEN


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(["dlaf_tpu_torch", "dlaf_tpu_torch.ops", "jaxtyping",
                                      "numpy"]) == []
    assert harness.forbidden_modules(["dlaf_tpu.algos", "jax", "jaxlib._jax", "flax.nn",
                                      "torch"]) == ["dlaf_tpu", "flax", "jax", "jaxlib"]
