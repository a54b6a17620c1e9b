"""Solidity frontend: solc standard-json compilation, source mapping
(soliditycontract.py) and the solc-AST feature extraction the tx
prioritiser reads (features.py) (reference mythril/solidity/)."""
