"""Solidity frontend (reference mythril/solidity/): the solc-AST feature
extraction the tx prioritiser reads (features.py). The solc
standard-json compilation and source mapping wait for a later slice."""
