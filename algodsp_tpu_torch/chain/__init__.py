from algodsp_tpu_torch.chain.graph import (
    GraphError, INPUT_NODE_ID, OUTPUT_NODE_ID, parse_graph)
from algodsp_tpu_torch.chain.registry import (
    Context, NodeRuntime, Registry, default_registry)
from algodsp_tpu_torch.chain.chain import Chain

__all__ = ["Chain", "Context", "GraphError", "INPUT_NODE_ID",
           "NodeRuntime", "OUTPUT_NODE_ID", "Registry", "default_registry",
           "parse_graph"]
