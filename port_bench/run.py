"""One run of one cell of the port's benchmark, from the root of a checkout:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs as many CUDA devices as the cell asks for and exits non-zero
without them. The last line of its standard output is the result."""
import sys
from pathlib import Path

if __name__ == "__main__":
    # the checkout's root, not this directory, so that no module here can
    # shadow a library module of the same name
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    from port_bench.harness import main
    sys.exit(main())
