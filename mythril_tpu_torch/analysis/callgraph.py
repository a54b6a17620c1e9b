"""Interactive CFG html for `--graph` (reference analysis/callgraph.py:248).

Renders the node/edge statespace with vis.js loaded from CDN (same approach
as the reference's jinja template; self-contained data payload)."""

import json

from mythril_tpu_torch.smt import terms as _terms

_PAGE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>mythril_tpu_torch call graph</title>
<script src="https://unpkg.com/vis-network/standalone/umd/vis-network.min.js"></script>
<style>
  body {{ margin: 0; background: #1e1e2e; }}
  #graph {{ width: 100vw; height: 100vh; }}
</style>
</head>
<body>
<div id="graph"></div>
<script>
  const nodes = new vis.DataSet({nodes});
  const edges = new vis.DataSet({edges});
  const container = document.getElementById("graph");
  const options = {{
    nodes: {{ shape: "box", font: {{ face: "monospace", color: "#cdd6f4" }},
             color: {{ background: "#313244", border: "#89b4fa" }} }},
    edges: {{ arrows: "to", color: {{ color: "#9399b2" }} }},
    physics: {{ enabled: {physics} }},
    layout: {{ improvedLayout: true }}
  }};
  new vis.Network(container, {{ nodes, edges }}, options);
</script>
</body>
</html>
"""


def generate_graph(sym, physics: bool = False, phrackify: bool = False) -> str:
    nodes = []
    for node in sym.nodes.values():
        code_lines = []
        for state in node.states[:30]:
            instruction = state.get_current_instruction()
            if instruction is None:
                continue
            if isinstance(instruction.argument, bytes):
                arg = f" 0x{instruction.argument.hex()}"
            elif instruction.argument is not None:
                arg = " <symbolic>"  # deploy-time-patched operand
            else:
                arg = ""
            code_lines.append(f"{instruction.address} {instruction.opcode}{arg}")
        label = f"{node.function_name}\\n" + "\\n".join(code_lines[:16])
        nodes.append({"id": node.uid, "label": label})
    edges = [
        {
            "from": edge.node_from,
            "to": edge.node_to,
            "label": (
                _terms.term_to_str(edge.condition.raw, max_depth=4)
                if edge.condition is not None and hasattr(edge.condition, "raw")
                else ""
            ),
        }
        for edge in sym.edges
    ]
    return _PAGE.format(
        nodes=json.dumps(nodes),
        edges=json.dumps(edges),
        physics="true" if physics else "false",
    )
