"""The RPC layer: the wire protocol, the server, the client and broker
handle, the broker process (``python -m
gol_distributed_final_tpu_torch.rpc.broker``), the worker process (``python
-m gol_distributed_final_tpu_torch.rpc.worker``) and the fault-injection
harness (``faults``). Frames are wire-compatible with the JAX package's in
both directions."""

from .client import RemoteBroker, RpcClient, RpcError
from .protocol import Methods, Request, Response
from .server import RpcServer

__all__ = [
    "Methods", "Request", "Response", "RpcClient", "RpcError", "RpcServer",
    "RemoteBroker",
]
