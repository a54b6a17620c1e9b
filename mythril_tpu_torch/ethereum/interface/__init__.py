"""On-chain access: minimal JSON-RPC client
(reference mythril/ethereum/interface/rpc/)."""
