from mythril_tpu_torch.interfaces.cli import main

main()
