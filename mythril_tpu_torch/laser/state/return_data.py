"""Return buffer of the last call (reference state/return_data.py:33)."""

from typing import List, Union

from mythril_tpu_torch.smt import BitVec, symbol_factory


class ReturnData:
    def __init__(self, return_data: List[BitVec], return_data_size: Union[BitVec, int]):
        self.return_data = return_data
        if isinstance(return_data_size, int):
            return_data_size = symbol_factory.BitVecVal(return_data_size, 256)
        self.return_data_size = return_data_size

    @property
    def size(self) -> BitVec:
        return self.return_data_size
