"""Nothing the benchmark runs imports JAX, the JAX package or benchmarks/,
and the reference imports nothing of the program (top-level module names
compared whole: `lightpycl_tpu_torch` is not `lightpycl_tpu`)."""

import ast
import subprocess
import sys
from pathlib import Path

HOME = Path(__file__).resolve().parents[1]
REPO = HOME.parent

BLOCK = '''
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "lightpycl_tpu",
                                  "benchmarks"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
'''


def _run(code):
    return subprocess.run([sys.executable, "-c", BLOCK % str(REPO) + code],
                          capture_output=True, text=True, timeout=300)


def test_run_and_harness_import_with_jax_blocked():
    p = _run(
        "import runpy, importlib\n"
        "runpy.run_path(%r, run_name='not_main')\n"
        "from perfcells.harness import catalog, driver, profile, taps\n"
        "for kind, name in [('entries', 'trace'), ('entries', 'trace_batched'),"
        " ('metrics', 'device.idle_pct'), ('scenes', 'paraboloid')]:\n"
        "    catalog.load_module(kind, name)\n"
        "import lightpycl_tpu_torch, lightpycl_tpu_torch.parallel.distributed\n"
        "from perfcells.harness.driver import forbidden_modules\n"
        "assert forbidden_modules() == [], forbidden_modules()\n"
        % str(HOME / "run.py"))
    assert p.returncode == 0, p.stderr


def test_reference_imports_nothing_of_the_program():
    p = _run(
        "import perfcells.reference.trace, perfcells.reference.sampling\n"
        "import perfcells.reference.nearest_hit, perfcells.harness.verdict\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'lightpycl_tpu_torch' not in top, 'program loaded'\n")
    assert p.returncode == 0, p.stderr


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_name_no_forbidden_module():
    for path in HOME.rglob("*.py"):
        tops = set(_imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "lightpycl_tpu",
                           "benchmarks"}, path
        if "reference" in path.parts:
            assert "lightpycl_tpu_torch" not in tops, path
