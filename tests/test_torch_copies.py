"""Copy drift: each JAX-free module the port keeps its own copy of must hold
the JAX file's code.  The two files' syntax trees are compared with
docstrings and import statements removed (comments never reach the tree),
so only the code itself counts."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

COPIES = ["models/config.py", "export/ply.py", "data/dataparser.py",
          "data/dataset.py", "utils/writer.py", "evaluation/vis.py",
          "counting/clustering.py", "counting/segmenter.py",
          "counting/graph.py", "counting/merger.py",
          "counting/depth_projection.py", "data/preprocess.py",
          "data/colmap.py", "data/autoseg.py"]
# native/pointcloud_ops.py builds its library into the port's _build
# directory and keeps the build's output, so its loader differs; these
# functions of it hold the JAX file's code
NATIVE_WRAPPERS = ["available", "voxel_downsample", "dbscan",
                   "statistical_outlier_removal", "kmeans"]


class _StripDocsAndImports(ast.NodeTransformer):
    def _body(self, node):
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body = body[1:]
        node.body = body
        return node

    def generic_visit(self, node):
        node = super().generic_visit(node)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            node = self._body(node)
        return node

    def visit_Import(self, node):
        return None

    def visit_ImportFrom(self, node):
        return None


def code_of(path: Path) -> str:
    tree = _StripDocsAndImports().visit(ast.parse(path.read_text()))
    return ast.dump(tree, include_attributes=False)


@pytest.mark.parametrize("module", COPIES)
def test_copy_holds_the_jax_code(module):
    jax_file = REPO / "cropnerf_tpu" / module
    port_file = REPO / "cropnerf_tpu_torch" / module
    assert port_file.exists(), f"the port has no copy of {module}"
    assert code_of(port_file) == code_of(jax_file), (
        f"cropnerf_tpu_torch/{module} has drifted from cropnerf_tpu/{module}")


def _functions(path: Path) -> dict:
    tree = _StripDocsAndImports().visit(ast.parse(path.read_text()))
    return {node.name: ast.dump(node, include_attributes=False)
            for node in tree.body if isinstance(node, ast.FunctionDef)}


def test_native_wrappers_hold_the_jax_code():
    rel = Path("native") / "pointcloud_ops.py"
    jax_fns = _functions(REPO / "cropnerf_tpu" / rel)
    port_fns = _functions(REPO / "cropnerf_tpu_torch" / rel)
    for name in NATIVE_WRAPPERS:
        assert port_fns[name] == jax_fns[name], name
    # and the C++ source is the JAX one below its opening comment
    src = [(REPO / pkg / "native" / "src" / "pointcloud_ops.cc").read_text()
           for pkg in ("cropnerf_tpu", "cropnerf_tpu_torch")]
    assert (src[0][src[0].index("#include"):]
            == src[1][src[1].index("#include"):])


def test_the_comparison_sees_a_changed_line(tmp_path):
    src = (REPO / "cropnerf_tpu" / "utils" / "writer.py").read_text()
    changed = tmp_path / "writer.py"
    changed.write_text(src.replace('"metrics.jsonl"', '"metrics.json"'))
    assert code_of(changed) != code_of(REPO / "cropnerf_tpu" / "utils" /
                                       "writer.py")
    docs_only = tmp_path / "writer_docs.py"
    docs_only.write_text('"""another docstring"""\nimport os\n'
                         + src.split('"""', 2)[2])
    assert code_of(docs_only) == code_of(REPO / "cropnerf_tpu" / "utils" /
                                         "writer.py")
