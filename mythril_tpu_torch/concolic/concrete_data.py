"""Typed schema of the concolic input json
(reference mythril/concolic/concrete_data.py).

Shape:
{
  "initialState": {"accounts": {addr: {"code": "0x..", "nonce": int,
                                        "balance": "0x..",
                                        "storage": {slot: value}}}},
  "steps": [{"address": "0x..", "origin": "0x..", "input": "0x..",
             "value": "0x..", "gasLimit": "0x..", "gasPrice": "0x.."}]
}
"""

from typing import Dict, List, TypedDict


class AccountData(TypedDict):
    code: str
    nonce: int
    balance: str
    storage: dict


class InitialState(TypedDict):
    accounts: Dict[str, AccountData]


class TransactionData(TypedDict, total=False):
    address: str
    origin: str
    input: str
    value: str
    gasLimit: str
    gasPrice: str


class ConcreteData(TypedDict):
    initialState: InitialState
    steps: List[TransactionData]
