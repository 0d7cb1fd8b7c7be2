import sys

from wmar_tpu_torch.finetune.cli import main

if __name__ == "__main__":
    main(sys.argv[1:])
