"""Minimal Ethereum JSON-RPC client
(reference mythril/ethereum/interface/rpc/client.py ~500 LoC; only the
calls the analyzer actually issues: eth_getCode, eth_getStorageAt,
eth_getBalance, plus Infura-per-network convenience).

stdlib urllib only — no external HTTP dependency. Tests mock at the
`_call` boundary, as the reference's tests mock at the JSON-RPC client
level (reference tests/rpc_test.py), or run a pinned chain on 127.0.0.1
(local.py). A loopback endpoint is reached directly, never through a
proxy named in the environment.
"""

import json
import urllib.request
from typing import Optional


class RpcError(Exception):
    pass


LOOPBACK_HOSTS = ("localhost", "127.0.0.1", "::1")

INFURA_NETWORKS = {
    "mainnet": "mainnet.infura.io",
    "goerli": "goerli.infura.io",
    "sepolia": "sepolia.infura.io",
}


class EthJsonRpc:
    def __init__(self, host: str = "localhost", port: Optional[int] = 8545,
                 tls: bool = False):
        self.host = host
        self.port = port
        self.tls = tls
        self._id = 0

    @classmethod
    def from_cli(cls, rpc: Optional[str], rpctls: bool = False,
                 infura_id: Optional[str] = None) -> "EthJsonRpc":
        """Parse `--rpc host:port`, `--rpc infura-<net>`, or default."""
        if rpc in (None, "", "ganache"):
            return cls("localhost", 8545, rpctls)
        if rpc.startswith("infura-"):
            network = rpc[len("infura-"):]
            host = INFURA_NETWORKS.get(network)
            if host is None:
                raise RpcError(f"unknown infura network {network!r}")
            suffix = f"/v3/{infura_id}" if infura_id else ""
            return cls(host + suffix, None, True)
        host, _, port = rpc.partition(":")
        return cls(host, int(port) if port else 8545, rpctls)

    @property
    def url(self) -> str:
        scheme = "https" if self.tls else "http"
        authority = self.host if self.port is None else \
            f"{self.host}:{self.port}"
        return f"{scheme}://{authority}"

    def _call(self, method: str, params: list):
        self._id += 1
        payload = json.dumps({
            "jsonrpc": "2.0", "id": self._id,
            "method": method, "params": params,
        }).encode()
        request = urllib.request.Request(
            self.url, data=payload,
            headers={"Content-Type": "application/json"},
        )
        opener = (urllib.request.build_opener(urllib.request.ProxyHandler({}))
                  if self.host in LOOPBACK_HOSTS
                  else urllib.request.build_opener())
        try:
            with opener.open(request, timeout=10) as response:
                body = json.loads(response.read())
        except OSError as error:
            raise RpcError(f"rpc transport error: {error}")
        if "error" in body:
            raise RpcError(str(body["error"]))
        return body.get("result")

    # -- the three calls the engine needs ---------------------------------

    def eth_getCode(self, address: str, block: str = "latest") -> str:
        return self._call("eth_getCode", [address, block])

    def eth_getStorageAt(self, address: str, position,
                         block: str = "latest") -> str:
        if isinstance(position, int):
            position = hex(position)
        return self._call("eth_getStorageAt", [address, position, block])

    def eth_getBalance(self, address: str, block: str = "latest") -> int:
        result = self._call("eth_getBalance", [address, block])
        return int(result, 16) if result else 0
