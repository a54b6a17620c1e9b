from mythril_tpu_torch.laser.transaction.models import (  # noqa: F401
    BaseTransaction,
    ContractCreationTransaction,
    MessageCallTransaction,
    TransactionEndSignal,
    TransactionStartSignal,
    tx_id_manager,
)
from mythril_tpu_torch.laser.transaction.symbolic import (  # noqa: F401
    ACTORS,
    execute_contract_creation,
    execute_message_call,
)
