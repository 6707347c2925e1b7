"""python -m portbench --workload W --seed N --seconds S --trace 0|1"""

import sys

from portbench.run import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
