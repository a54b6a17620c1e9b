"""A pinned chain behind a JSON-RPC server on 127.0.0.1, for offline runs of
`-a ADDRESS --rpc 127.0.0.1:PORT` and `read-storage`.

It answers the three calls the client issues (eth_getCode,
eth_getStorageAt, eth_getBalance) from a table given at construction,
zero (or empty code) elsewhere, and counts the requests by method. The
server runs in a daemon thread of this process (stdlib http.server); it
never opens a connection of its own.

    with LocalChain({"0x11..": {"code": "0x60..", "storage": {0: 1},
                                "balance": 5}}) as chain:
        rpc = f"127.0.0.1:{chain.port}"
"""

import json
import threading
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict


def _word(value: int) -> str:
    return "0x" + value.to_bytes(32, "big").hex()


class LocalChain:
    def __init__(self, accounts: Dict[str, dict]):
        self.accounts = {address.lower(): dict(account)
                         for address, account in accounts.items()}
        self.requests: Counter = Counter()
        self._lock = threading.Lock()
        self._server = None
        self._thread = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def answer(self, method: str, params: list):
        """The result of one call on the pinned table."""
        account = self.accounts.get(str(params[0]).lower(), {}) \
            if params else {}
        if method == "eth_getCode":
            return account.get("code", "0x")
        if method == "eth_getStorageAt":
            slot = params[1]
            slot = int(slot, 16) if isinstance(slot, str) else int(slot)
            return _word(int(account.get("storage", {}).get(slot, 0)))
        if method == "eth_getBalance":
            return hex(int(account.get("balance", 0)))
        raise KeyError(method)

    def start(self) -> "LocalChain":
        chain = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                request = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))))
                method = request.get("method")
                with chain._lock:
                    chain.requests[method] += 1
                try:
                    body = {"result": chain.answer(method,
                                                   request.get("params", []))}
                except KeyError:
                    body = {"error": {"code": -32601,
                                      "message": f"no method {method}"}}
                body.update(jsonrpc="2.0", id=request.get("id"))
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *_args):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="local-chain", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join()
            self._server = None

    def __enter__(self) -> "LocalChain":
        return self.start()

    def __exit__(self, *_exc) -> None:
        self.stop()
