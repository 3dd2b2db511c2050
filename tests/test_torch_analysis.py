"""The reference's invariant checker (``repro.analysis``, stdlib only) over
the port: zero findings, with the port's own ``fl/flat.py`` as the one
wire-magic registry."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import ast
from pathlib import Path

from repro.analysis import run_analysis

SRC_TORCH = Path(__file__).resolve().parent.parent / "src_torch"


def test_port_has_zero_findings():
    findings = run_analysis([str(SRC_TORCH)])
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_flat_is_the_only_wire_magic_registry():
    owners = []
    for path in sorted(SRC_TORCH.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target] if isinstance(node, ast.AnnAssign)
                       else [])
            if any(isinstance(t, ast.Name) and t.id == "WIRE_MAGICS"
                   for t in targets):
                owners.append(path.relative_to(SRC_TORCH).as_posix())
    assert owners == ["repro_torch/fl/flat.py"]
