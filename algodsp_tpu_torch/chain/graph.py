"""Effect-chain graph parsing and topological ordering.

Capability parity with `dsp/effectchain/graph.go`: JSON nodes
(id/type/bypassed/params) + port-indexed connections, reserved
`_input`/`_output` node IDs, Kahn topological sort with cycle
detection. Counterpart of `algodsp_tpu/chain/graph.py`, identical to it.
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict, deque

INPUT_NODE_ID = "_input"
OUTPUT_NODE_ID = "_output"
NODE_TYPE_SPLIT_FREQ = "split-freq"


class GraphError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class GraphNode:
    id: str
    type: str
    bypassed: bool = False
    params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class GraphEdge:
    src: str
    dst: str
    from_port: int = 0
    to_port: int = 0


@dataclasses.dataclass(frozen=True)
class CompiledGraph:
    nodes: dict[str, GraphNode]
    incoming: dict[str, list[GraphEdge]]
    outgoing: dict[str, list[GraphEdge]]
    order: list[str]


def parse_graph(raw: str) -> CompiledGraph:
    """Parse + topo-sort the JSON graph (`graph.go:58-140`)."""
    if not raw or not raw.strip():
        return CompiledGraph({}, {}, {}, [])
    try:
        state = json.loads(raw)
    except json.JSONDecodeError as e:
        raise GraphError(f"invalid graph JSON: {e}") from e

    nodes: dict[str, GraphNode] = {}
    for n in state.get("nodes", []):
        nid = n.get("id", "")
        if not nid:
            raise GraphError("node with empty id")
        if nid in nodes or nid in (INPUT_NODE_ID, OUTPUT_NODE_ID):
            raise GraphError(f"duplicate or reserved node id: {nid}")
        params = n.get("params") or {}
        if not isinstance(params, dict):
            raise GraphError(f"node {nid}: params must be an object")
        nodes[nid] = GraphNode(id=nid, type=n.get("type", ""),
                               bypassed=bool(n.get("bypassed", False)),
                               params=params)

    incoming: dict[str, list[GraphEdge]] = defaultdict(list)
    outgoing: dict[str, list[GraphEdge]] = defaultdict(list)
    for c in state.get("connections", []):
        src, dst = c.get("from", ""), c.get("to", "")
        for endpoint in (src, dst):
            if endpoint not in nodes and endpoint not in (INPUT_NODE_ID, OUTPUT_NODE_ID):
                raise GraphError(f"connection references unknown node: {endpoint}")
        e = GraphEdge(src=src, dst=dst,
                      from_port=int(c.get("fromPortIndex", 0)),
                      to_port=int(c.get("toPortIndex", 0)))
        incoming[dst].append(e)
        outgoing[src].append(e)

    # Kahn topological sort over effect nodes only
    indeg = {nid: 0 for nid in nodes}
    for nid, edges in incoming.items():
        if nid in indeg:
            indeg[nid] = sum(1 for e in edges if e.src in nodes)
    queue = deque(sorted(nid for nid, d in indeg.items() if d == 0))
    order = []
    while queue:
        nid = queue.popleft()
        order.append(nid)
        for e in outgoing.get(nid, []):
            if e.dst in indeg:
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    queue.append(e.dst)
    if len(order) != len(nodes):
        raise GraphError("graph contains a cycle")
    return CompiledGraph(nodes=nodes, incoming=dict(incoming),
                         outgoing=dict(outgoing), order=order)
