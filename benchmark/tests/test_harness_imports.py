"""Nothing under ``benchmark/`` imports JAX or the JAX package (top-level
names compared whole, so ``dust_tpu_torch`` is not ``dust_tpu``), the
reference imports nothing of the port, and the harness reads neither the
root ``bench.py`` nor the JAX package's result files."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REFUSED = {"jax", "jaxlib", "flax", "dust_tpu"}


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(BENCH.rglob("*.py"))


def test_no_jax_anywhere():
    for path in sources():
        assert not imported(path) & REFUSED, path


def test_scan_compares_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import dust_tpu_torch.render\nimport jax.numpy\n"
                     "from dust_tpu.ops import hdda\n")
    assert imported(probe) == {"dust_tpu_torch", "jax", "dust_tpu"}
    assert imported(probe) & REFUSED == {"jax", "dust_tpu"}


def test_reference_stands_alone():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert not imported(path) & (REFUSED | {"dust_tpu_torch"}), path
        assert imported(path) <= {"__future__", "dataclasses", "io", "math",
                                  "numpy", "pathlib", "struct", "torch",
                                  "typing", "benchmark"}, path


def test_reads_no_jax_results():
    for path in sources():
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for word in ("BENCH_", "MULTICHIP_", "bench.py\""):
            assert word not in text, (path, word)
