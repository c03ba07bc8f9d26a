import sys

from distkeras_tpu_torch.benchmarks.run_config import main

if __name__ == "__main__":
    sys.exit(main())
